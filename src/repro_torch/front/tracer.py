"""``trace(fn, *avals) -> TracedProgram``: capture a scalar torch
program as an aten graph and synthesize its static dataflow fabric (the
PyTorch port of ``repro.front.tracer``).

Capture is ``make_fx(fn, tracing_mode="fake")`` on one 0-d tensor per
argument: fake tensors carry dtypes and shapes but no data, so nothing
runs — a loop that would never end traces in a fraction of a second.
:mod:`repro_torch.front.lowering` then lowers the aten graph onto the
Veen operator set.

A :class:`TracedProgram` IS a :class:`~repro_torch.core.graph.Graph` —
it runs on every engine backend, serializes through ``asm.emit`` (so
the serving layer's engine cache treats a traced program as just
another fabric signature), and optimizes through ``core.passes`` — plus
the frontend bookkeeping: which environment arc carries which
positional argument (``arg_arcs``), which arcs drain the program's
results (``out_arcs``), and the feed adapter (:meth:`make_feeds`).

:func:`while_loop` and :func:`fori_loop` are the counterparts of
``lax.while_loop`` and ``lax.fori_loop``: the carry is one tensor or a
tuple, ``cond`` and ``body`` take it whole, and Python numbers are
accepted as initial and next values.  Both build on
``torch._higher_order_ops.while_loop``, whose capture refuses a body
that returns one of its inputs ("Higher order ops do not support
aliasing"); they clone such results, so a pass-through carry needs no
care from the caller.
"""
from __future__ import annotations

import dataclasses
import numbers
import re

import numpy as np

from repro_torch.core.graph import Graph, Op
from repro_torch.front.adapter import pack_arg_streams
from repro_torch.front.lowering import (LoweringError, _Ctx, _np_dtype,
                                        lower_graph)

# x64 is off in the JAX package, so its avals canonicalize to 32 bits
_CANON = {np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


@dataclasses.dataclass
class TracedProgram(Graph):
    """A fabric synthesized from a traced Python program.

    arg_arcs: one entry per *stream* argument (positional arguments
      minus any const-bound via ``trace(const_args=...)``) — the input
      arc fed by that argument's token stream, or None when the
      argument is unused (the adapter then ignores its stream).
    out_arcs: one output arc per program result, in return order.
    dtype:   the fabric's execution dtype (all avals share it).
    has_loops: the program lowered a ``while_loop`` onto the cyclic
      loop schema (DESIGN.md §10).  Loop fabrics initiate ONCE per run —
      the entry NDMERGEs consume exactly one initial token — so
      ``make_feeds`` enforces one token per argument; evaluate a stream
      by running the program per element (the
      :class:`~repro_torch.serve.dataflow_server.DataflowServer` does
      this as one request per evaluation).
    """
    arg_arcs: list = dataclasses.field(default_factory=list)
    out_arcs: list = dataclasses.field(default_factory=list)
    dtype: object = np.dtype(np.int32)
    has_loops: bool = False

    def make_feeds(self, *args) -> dict:
        """Feed adapter: positional [k]-token streams (scalars
        broadcast to the common k) -> arc->stream dict for the
        engines, ``run_batch``, and ``DataflowServer`` requests.
        Loop-bearing programs accept only single-token streams (see
        ``has_loops``)."""
        return pack_arg_streams(self.name, self.arg_arcs, self.dtype,
                                args, single_shot=self.has_loops)

    @property
    def out_arc(self) -> str:
        return self.out_arcs[0]


def _torch_of_np(dt: np.dtype):
    import torch
    return torch.from_numpy(np.zeros((), dt)).dtype


def _canon_aval(a, index: int) -> np.dtype:
    """Normalize one `avals` entry (a numpy or torch dtype, an example
    scalar, or a 0-d tensor) to a canonical scalar dtype."""
    import torch
    if isinstance(a, torch.Tensor):
        if tuple(a.shape) != ():
            raise LoweringError(
                f"aval {index} has shape {tuple(a.shape)}; the fabric "
                "carries scalar (token-shaped) values — stream tensors "
                "element-wise instead")
        dt = _np_dtype(a.dtype)
    elif isinstance(a, torch.dtype):
        dt = _np_dtype(a)
    elif isinstance(a, (str, np.dtype)) or (isinstance(a, type)
                                            and issubclass(a, np.generic)):
        dt = np.dtype(a)
    elif isinstance(a, (bool, int)):
        dt = np.dtype(np.int32)
    elif isinstance(a, float):
        dt = np.dtype(np.float32)
    elif np.ndim(a) == 0:
        dt = np.asarray(a).dtype
    else:
        raise LoweringError(
            f"aval {index} ({a!r}) is neither a scalar dtype spec nor "
            "a scalar example value")
    dt = _CANON.get(np.dtype(dt), np.dtype(dt))
    if dt == np.bool_ or np.issubdtype(dt, np.complexfloating):
        raise LoweringError(
            f"aval {index} has dtype {dt}; fabric tokens are integer "
            "or float words (deciders encode booleans as 0/1)")
    return dt


def _capture(fn, dts):
    """make_fx on fake 0-d tensors, one per argument."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx
    args = [torch.zeros((), dtype=_torch_of_np(dt)) for dt in dts]
    try:
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)
    except Exception as e:
        if type(e).__name__ != "UncapturedHigherOrderOpError":
            raise
        inner = re.search(r"LoweringError\((['\"])(.*?)\1\)", str(e))
        if inner:                   # raised by a loop's cond or body
            raise LoweringError(inner.group(2)) from e
        if "aliasing" in str(e):
            raise LoweringError(
                "a while_loop body returns one of its inputs unchanged "
                "(torch's capture refuses the aliasing); use "
                "repro_torch.front.while_loop / fori_loop, which clone "
                "such results, or return x.clone()") from e
        raise


def trace(fn, *avals, name: str | None = None,
          const_args: dict | None = None) -> TracedProgram:
    """Lower a scalar torch program onto fabric operators.

    avals: one scalar dtype spec (numpy or torch dtype, example value,
    or 0-d tensor) per positional argument of ``fn``; all must share one
    dtype — the fabric's execution dtype.  Raises :class:`LoweringError`
    (naming the offending aten op) when the program uses an op the Veen
    operator set cannot express.

    const_args: {arg index: value} binds those arguments as *sticky
    const buses* (the paper's persistently-presented input buses, e.g.
    FIR coefficients) instead of token streams.  Operators fed only by
    const buses are genuine compile-time work — exactly what the
    constant-folding pass collapses.  Const-bound arguments take no
    stream: ``make_feeds`` expects one stream per *remaining* argument,
    in position order.
    """
    if not avals:
        raise LoweringError(
            "trace() needs at least one aval: a fabric with no input "
            "streams would free-run its constant outputs")
    const_args = dict(const_args or {})
    bad = [i for i in const_args if not 0 <= i < len(avals)]
    if bad:
        raise LoweringError(
            f"const_args indices {sorted(bad)} out of range for "
            f"{len(avals)} traced arguments")
    if len(const_args) == len(avals):
        raise LoweringError(
            "every argument is const-bound: a fabric with no input "
            "streams would free-run its constant outputs")
    dts = [_canon_aval(a, i) for i, a in enumerate(avals)]
    if len(set(dts)) != 1:
        raise LoweringError(
            f"mixed aval dtypes {sorted({str(d) for d in dts})}: every "
            "arc of one fabric carries one dtype")
    dtype = dts[0]
    name = name or getattr(fn, "__name__", None) or "traced"
    if name == "<lambda>":
        name = "traced"
    gm = _capture(fn, dts)
    out = next(n for n in gm.graph.nodes if n.op == "output")
    res = out.args[0]
    for v in (res if isinstance(res, (tuple, list)) else [res]):
        shape = tuple(getattr(v.meta.get("val"), "shape", ())) \
            if hasattr(v, "meta") else ()
        if shape != ():
            raise LoweringError(
                f"program returns shape {shape}; fabric output buses "
                "drain scalar tokens")

    prog = TracedProgram(name=name, dtype=dtype)
    ctx = _Ctx(prog, dtype)
    ctx.const_args = const_args
    results = lower_graph(ctx, gm, None)
    prog.arg_arcs = list(ctx.created_inputs)
    prog.has_loops = ctx.has_loops

    out_arcs = []
    for k, (arc, streamy) in enumerate(results):
        if not streamy:
            raise LoweringError(
                f"program output {k} is a compile-time constant; a "
                "const output bus free-runs (one token per cycle, "
                "forever) — return something derived from an argument")
        if arc in ctx.env_inputs:
            # a bare passthrough would leave the arc both fed and
            # drained by the environment; give it a real operator so
            # the arc classes stay disjoint
            out, dead = ctx.fresh("out"), ctx.fresh("dead")
            prog.add(Op.COPY, [arc], [out, dead])
            prog.add(Op.SINK, [dead], [])
            arc = out
        out_arcs.append(arc)
    prog.out_arcs = out_arcs
    # a const arc no node reads (e.g. an unused const-bound argument)
    # would surface as a free-running environment output bus — prune
    used = {a for n in prog.nodes for a in (*n.inputs, *n.outputs)}
    prog.consts = {a: v for a, v in prog.consts.items() if a in used}
    prog.inits = {a: v for a, v in prog.inits.items() if a in used}
    prog.validate()
    return prog


# ---------------------------------------------------------------------------
# lax.while_loop / lax.fori_loop counterparts
# ---------------------------------------------------------------------------
def _as_tensor(v, like=None):
    """A Python number as a 0-d tensor (``like``'s dtype, else int32 for
    ints and float32 for floats); tensors pass through."""
    import torch
    if isinstance(v, torch.Tensor):
        return v
    if like is not None:
        dt = like.dtype
    elif isinstance(v, bool):
        dt = torch.bool
    elif isinstance(v, numbers.Integral):
        dt = torch.int32
    else:
        dt = torch.float32
    return torch.full((), v, dtype=dt)


def while_loop(cond, body, init):
    """``lax.while_loop(cond, body, init)`` in torch: repeat ``c =
    body(c)`` while ``cond(c)``; ``init`` is one tensor or a tuple of
    them, and ``cond``/``body`` take the carry in the same form.  A body
    result that is one of its inputs is cloned (the capture refuses the
    alias); a Python number is taken at its carry's dtype."""
    import torch
    from torch._higher_order_ops.while_loop import while_loop as _while
    single = not isinstance(init, (tuple, list))
    carries = tuple(_as_tensor(v) for v in ((init,) if single else init))

    def pack(xs):
        return xs[0] if single else tuple(xs)

    def cond_fn(*xs):
        return _as_tensor(cond(pack(xs)))

    def body_fn(*xs):
        res = body(pack(xs))
        res = (res,) if single else tuple(res)
        if len(res) != len(xs):
            raise LoweringError(
                f"while_loop body returns {len(res)} values for "
                f"{len(xs)} carries")
        out = []
        for r, x in zip(res, xs):
            r = _as_tensor(r, like=x)
            if any(r is t for t in (*xs, *out)):
                r = r.clone()
            out.append(r)
        return tuple(out)

    return pack(_while(cond_fn, body_fn, carries))


def fori_loop(lower, upper, body, init):
    """``lax.fori_loop(lower, upper, body, init)`` in torch: ``c =
    body(i, c)`` for ``i`` in ``range(lower, upper)``.  With Python-int
    bounds the index is an int32 carry starting at ``lower`` and the
    loop is counted (it lowers on the carry-only scan schema, as JAX's
    static ``fori_loop`` does); a traced bound rides the carry as in
    JAX's while form, ``(i, upper, c)``."""
    import torch
    single = not isinstance(init, (tuple, list))
    user = (init,) if single else tuple(init)

    def call(i, cs):
        res = body(i, cs[0] if single else tuple(cs))
        return (res,) if single else tuple(res)

    def unpack(cs):
        return cs[0] if single else tuple(cs)

    static = all(isinstance(b, numbers.Integral) and not isinstance(b, bool)
                 for b in (lower, upper))
    if static:
        i0 = torch.full((), int(lower), dtype=torch.int32)
        res = while_loop(lambda c: c[0] < int(upper),
                         lambda c: (c[0] + 1, *call(c[0], c[1:])),
                         (i0, *user))
        return unpack(res[1:])
    like = upper if isinstance(upper, torch.Tensor) else lower
    lo, hi = _as_tensor(lower, like), _as_tensor(upper, like)
    if lo.dtype != hi.dtype:
        raise LoweringError(
            "fori_loop bounds must share a dtype, got "
            f"{lo.dtype} and {hi.dtype}")
    res = while_loop(lambda c: c[0] < c[1],
                     lambda c: (c[0] + 1, c[1], *call(c[0], c[2:])),
                     (lo, hi, *user))
    return unpack(res[2:])
