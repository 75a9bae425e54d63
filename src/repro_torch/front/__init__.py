"""Expression-to-fabric frontend (DESIGN.md §9), the PyTorch port of
``repro.front``.

The paper's toolchain starts from an *algorithm* and synthesizes the
static dataflow graph of operators that computes it; this package is
that synthesis step for ordinary scalar torch programs: ``trace(fn,
*avals)`` captures the program as an aten graph (``make_fx`` on fake
0-d tensors) and lowers every op onto the Veen operator set of
:mod:`repro_torch.core.graph`, so any scalar (token-shaped) expression
becomes a fabric the cycle-accurate engines, the compiled backends, and
the continuous-batching server can run.  Loops are written with
:func:`while_loop` / :func:`fori_loop`, the counterparts of
``lax.while_loop`` / ``lax.fori_loop``.

    import numpy as np, torch
    from repro_torch.core.engine import DataflowEngine
    from repro_torch.front import trace
    prog = trace(lambda x, y: torch.where(x > y, x - y, y - x),
                 np.int32, np.int32)
    eng = DataflowEngine(prog, block_cycles=16)     # the card
    res = eng.run(prog.make_feeds([5, 1], [2, 9]))
    res.outputs[prog.out_arcs[0]]      # -> 8, the last of [3, 8]

Unsupported aten ops raise :class:`LoweringError` naming the op; see
:data:`repro_torch.front.lowering.SUPPORTED` for the table.
"""
from repro_torch.front.lowering import SUPPORTED, LoweringError
from repro_torch.front.tracer import (TracedProgram, fori_loop, trace,
                                      while_loop)

__all__ = ["trace", "TracedProgram", "LoweringError", "SUPPORTED",
           "while_loop", "fori_loop"]
