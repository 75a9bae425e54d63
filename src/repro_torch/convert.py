"""Carry a fabric, its slot state and an LM's parameters across from the
JAX package.

What crosses between the two packages is the fabric (as assembler text,
which both packages emit and parse alike), the resumable slot state, the
LM's parameter tree and its training state (all as numpy arrays).  No function here
imports the JAX package; the caller hands over plain text and arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import asm
from repro_torch.core.engine import SlotState
from repro_torch.core.graph import Graph

DEVICE_FIELDS = ("fv", "fl", "full", "val", "ptr", "out_last", "out_count")
HOST_FIELDS = ("active", "base", "last", "fired", "quiesced", "dispatches",
               "cap", "stalled")


def graph_from_asm(text: str, name: str = "asm") -> Graph:
    """The port's :class:`Graph` from ``repro.core.asm.emit`` text, so
    both packages run literally the same fabric."""
    return asm.parse(text, name=name)


def slot_state_from_numpy(arrays, device="cuda", engine=None) -> SlotState:
    """The port's :class:`SlotState` from a JAX ``SlotState``'s fields
    given as numpy arrays (``arrays[name]`` for every name in
    :data:`DEVICE_FIELDS` and :data:`HOST_FIELDS`).  Device fields
    become int32 tensors on ``device``; host fields stay numpy with the
    JAX package's dtypes.  A profiled engine's state also carries
    ``arrays["prof"]`` (the five counter arrays) and
    ``arrays["prof_cycles"]``; both cross when present.

    A scheduled engine's state (``schedule=``) crosses with its schedule
    positions: ``arrays["sched_pos"]`` (int [B]) and
    ``arrays["sched_flen"]`` (each slot's feed-length tuple, None for a
    slot that never held a request), and, profiled, ``arrays["sched_prof"]``
    (the five host counter arrays nf/si/so [B, N], ab/ahw [B, A2]).  Each
    slot is bound to ``engine``'s own plan for its feed lengths (the
    port's scheduled engine for the same fabric), so a state captured
    mid-run resumes in the port."""
    missing = [k for k in (*DEVICE_FIELDS, *HOST_FIELDS) if k not in arrays]
    if missing:
        raise ValueError(f"slot state lacks fields {missing}")
    dev = {k: torch.tensor(np.asarray(arrays[k], np.int32), device=device)
           for k in DEVICE_FIELDS}
    host = {k: np.array(arrays[k], dtype=np.int64) for k in HOST_FIELDS}
    host["active"] = host["active"].astype(np.int32)
    host["quiesced"] = host["quiesced"].astype(bool)
    prof = arrays.get("prof")
    if prof is not None:
        prof = tuple(torch.tensor(np.asarray(x, np.int32), device=device)
                     for x in prof)
    prof_cycles = arrays.get("prof_cycles")
    if prof_cycles is not None:
        prof_cycles = np.array(prof_cycles, dtype=np.int64)
    sched = None
    if "sched_pos" in arrays:
        if engine is None or not engine._sched_on:
            raise ValueError("a scheduled slot state needs the port's "
                             "scheduled engine (engine=, schedule=True)")
        sched = _slot_sched(engine, arrays)
    return SlotState(**dev, **host, active_dev=torch.tensor(
        host["active"], device=device), prof=prof, prof_cycles=prof_cycles,
        sched=sched)


def _slot_sched(engine, arrays):
    pos = np.array(arrays["sched_pos"], dtype=np.int64)
    flens = list(arrays["sched_flen"])
    sched = engine._make_slot_sched(pos.shape[0])
    ctx = engine._sched_ctx()
    for b, flen in enumerate(flens):
        if flen is not None:
            sched.reset(b, ctx.plan_for(tuple(int(x) for x in flen)))
    sched.pos[:] = pos
    if engine.profile:
        counters = arrays.get("sched_prof")
        if counters is None:
            raise ValueError("a profiled scheduled state needs "
                             "arrays['sched_prof']")
        for name, x in zip(("nf", "si", "so", "ab", "ahw"), counters):
            getattr(sched, name)[:] = np.asarray(x, np.int64)
    return sched


def lm_params_from_numpy(cfg, tree, device="cuda"):
    """The port's LM parameters from the JAX package's ``init_params``
    tree given as numpy (nested dicts of arrays; the layers' leaves
    stacked ``[n_layers, ...]``, ``wqkv`` fused), as tensors on
    ``device`` with the arrays' dtypes (numpy's, or ml_dtypes'
    bfloat16).  Every key and shape must be the port's
    (:func:`repro_torch.models.transformer.param_shapes`); a missing,
    extra or misshapen leaf raises."""
    from repro_torch.models.transformer import param_shapes

    def carry(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"{path or 'params'}: keys {have}, want "
                                 f"{sorted(want)}")
            return {k: carry(want[k], got[k], f"{path}/{k}") for k in want}
        a = np.array(got)            # a writable, contiguous copy
        if a.shape != tuple(want):
            raise ValueError(f"{path}: shape {a.shape}, want {tuple(want)}")
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return carry(param_shapes(cfg), tree, "")


def train_state_from_numpy(cfg, params_tree, opt_tree, device="cuda"):
    """The port's training state ``(params, OptState)`` from the JAX
    package's ``(params, adamw.OptState)`` given as numpy
    (``jax.tree.map(np.asarray, state)``): the parameters as
    :func:`lm_params_from_numpy` carries them, the step as a 0-d int32
    tensor, the moments (and the master weights, when there are any) in
    the parameters' structure.  ``opt_tree`` may be the NamedTuple or a
    dict with its fields."""
    from repro_torch.optim.adamw import OptState
    opt = opt_tree if isinstance(opt_tree, dict) else opt_tree._asdict()
    carry = lambda tree: None if tree is None else \
        lm_params_from_numpy(cfg, tree, device)
    return carry(params_tree), OptState(
        step=torch.tensor(np.asarray(opt["step"]).astype(np.int32),
                          device=device),
        m=carry(opt["m"]), v=carry(opt["v"]), master=carry(opt.get("master")))
