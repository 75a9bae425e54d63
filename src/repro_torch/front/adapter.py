"""Feed adapter: positional argument streams -> arc->stream dicts.

The engines and the server speak ``{arc: [k]-stream}``
(:func:`repro_torch.core.engine.pack_feeds`); a traced program's callers
speak positional arguments.  This module is the bridge — one stream
per traced argument, scalars broadcast to the common stream length,
unused arguments (``arg_arcs`` entry None) accepted and dropped so the
traced function's call signature keeps working verbatim.
"""
from __future__ import annotations

import numpy as np


def pack_arg_streams(name: str, arg_arcs, dtype, args,
                     single_shot: bool = False) -> dict:
    if len(args) != len(arg_arcs):
        raise ValueError(
            f"{name}: expected {len(arg_arcs)} argument streams "
            f"(one per traced argument), got {len(args)}")
    dtype = np.dtype(dtype)
    streams: list[tuple[str, np.ndarray]] = []
    k = None
    for i, (arc, v) in enumerate(zip(arg_arcs, args)):
        if arc is None:
            continue                      # argument unused by the program
        v = np.asarray(v, dtype)
        if v.ndim > 1:
            raise ValueError(
                f"{name}: argument {i} has shape {v.shape}; pass a "
                "[k] token stream (or a scalar) per argument")
        if v.ndim == 1:
            if k is None:
                k = v.shape[0]
            elif v.shape[0] != k:
                raise ValueError(
                    f"{name}: argument {i} has {v.shape[0]} tokens but "
                    f"earlier streams have {k} — every argument feeds "
                    "one token per program firing")
        streams.append((arc, v))
    k = 1 if k is None else k
    if single_shot and k > 1:
        raise ValueError(
            f"{name}: loop-bearing fabrics initiate once per run (the "
            "entry NDMERGEs consume exactly one initial token), so "
            f"every argument feeds ONE token — got a {k}-token stream. "
            "Run the program once per stream element, e.g. one "
            "DataflowServer request per evaluation.")
    return {arc: (np.full((k,), v, dtype) if v.ndim == 0 else v)
            for arc, v in streams}
