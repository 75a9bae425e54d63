"""Helpers shared by the port's tests and ``chip_smoke.py``: random
mid-run inputs for the fire block, and one checker for engine results.
"""
from __future__ import annotations

import numpy as np

# operands at the edges of int32 arithmetic: overflow, the INT_MIN // -1
# wrap, shift counts beyond the clip, signs
EDGE_VALS = np.asarray([-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 31, 32, -32],
                       np.int64)

STATE_KEYS = ("full", "val", "ptr", "out_last", "out_count")


def random_block_inputs(tables, B: int, L: int, rng) -> dict:
    """Random mid-run inputs for a B-stream fire block over a fabric's
    :func:`~repro_torch.kernels.dataflow_fire.block_plan_arrays` tables,
    as int32 numpy arrays: register bits and values (a third of them
    edge operands), feed streams and pointers, accumulators, and an
    ``active`` gate with about a quarter of the streams parked.  The pad
    slots and const buses hold what a running fabric holds there."""
    p = tables["plan"]
    A2 = p["A"] + 2
    n_in = tables["in_arc_idx"].shape[0]
    n_out = tables["out_arc_idx"].shape[0]

    def i32(*shape):
        return rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)

    full = rng.integers(0, 2, (B, A2)).astype(np.int32)
    full[:, p["FULL_PAD"]] = 1
    full[:, p["EMPTY_PAD"]] = 0
    full[:, np.nonzero(p["const_mask"])[0]] = 1
    val = np.where(rng.random((B, A2)) < 0.3, rng.choice(EDGE_VALS, (B, A2)),
                   i32(B, A2)).astype(np.int32)
    feed_vals = np.where(rng.random((B, n_in, L)) < 0.3,
                         rng.choice(EDGE_VALS, (B, n_in, L)),
                         i32(B, n_in, L)).astype(np.int32)
    feed_len = rng.integers(0, L + 1, (B, n_in)).astype(np.int32)
    feed_len[:, len(p["input_arcs"]):] = 0          # pad rows feed nothing
    ptr = (rng.random((B, n_in)) * (feed_len + 1)).astype(np.int32)
    active = (rng.random(B) < 0.75).astype(np.int32)
    return dict(feed_vals=feed_vals, feed_len=feed_len, full=full, val=val,
                ptr=ptr, out_last=i32(B, n_out),
                out_count=rng.integers(0, 100, (B, n_out)).astype(np.int32),
                active=active)


def assert_same_result(got, want, tag, dispatches: bool = True) -> None:
    """Every EngineResult field of ``got`` equals ``want``'s: cycles,
    fired, counts, the last value of every arc that drained a token, and
    (unless ``dispatches=False``, for oracles that launch nothing) the
    launch count.  Works across the two packages' result types."""
    assert got.cycles == want.cycles, (tag, "cycles", got.cycles, want.cycles)
    assert got.fired == want.fired, (tag, "fired", got.fired, want.fired)
    assert dict(got.counts) == dict(want.counts), (tag, "counts",
                                                   got.counts, want.counts)
    assert set(got.outputs) == set(want.outputs), (tag, "outputs")
    for a, c in want.counts.items():
        if c:
            assert int(np.asarray(got.outputs[a])) == \
                int(np.asarray(want.outputs[a])), (tag, "outputs", a)
    if dispatches:
        assert got.dispatches == want.dispatches, \
            (tag, "dispatches", got.dispatches, want.dispatches)
