"""Public block-step wrappers over the fire-block kernel.

On CUDA tensors the step launches the hand-written kernel; on CPU
tensors (``device="cpu"``) it computes the plain PyTorch version — the
wrappers in :mod:`repro_torch.kernels.dataflow_fire` decide by the
tensors' device alone.
"""
from __future__ import annotations

from repro_torch.kernels.dataflow_fire import (FireTables,
                                               block_plan_arrays,
                                               device_tables,
                                               fire_block_batched_cuda,
                                               fire_block_cuda)


def make_block_step(graph, n_cycles: int, batched: bool = False,
                    tables=None, device="cuda"):
    """The fused K-cycle fire-block step for a fabric.

    Returns (tables, step).  Single-stream step signature:
      step(feed_vals, feed_len, full, val, ptr, out_last, out_count)
        -> (full', val', ptr', out_last', out_count', fired[1],
            last_prog[1])
    With batched=True every array gains a leading B axis (one CTA per
    stream, one launch for all B) and the step takes a trailing
    ``active`` int32[B] clock gate: slots with active == 0 skip the
    block entirely (state frozen, fired/last_prog 0).  ``tables`` may be
    a prior call's tables (numpy, from :func:`block_plan_arrays`) or
    device tables from :func:`device_tables`, reused as they are."""
    if tables is None:
        tables = block_plan_arrays(graph)
    dt = tables if isinstance(tables, FireTables) \
        else device_tables(tables, device)

    if batched:
        def step(feed_vals, feed_len, full, val, ptr, out_last, out_count,
                 active):
            return fire_block_batched_cuda(
                dt, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles=n_cycles, active=active)
    else:
        def step(feed_vals, feed_len, full, val, ptr, out_last, out_count):
            return fire_block_cuda(
                dt, feed_vals, feed_len, full, val, ptr, out_last,
                out_count, n_cycles=n_cycles)
    return tables, step
