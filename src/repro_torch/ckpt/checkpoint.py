"""Atomic checkpoints, in the JAX package's on-disk format.

Layout:  <dir>/step_<N>/
            manifest.json        structure, shapes, dtypes
            arr_<k>.npy          one file per leaf (no pickle)
         <dir>/LATEST            text file naming the newest complete step

The port of ``repro/ckpt/checkpoint.py``.  Leaves are numbered in
``jax.tree.flatten``'s order (:mod:`repro_torch.pytree`: dict keys
sorted, NamedTuple fields in order, ``None`` skipped) and bf16 leaves are
stored as their uint16 bits, so a checkpoint written by either package
restores in the other.

Atomicity: a save writes ``step_<N>.tmp`` and renames it into place only
after the manifest lands, then replaces ``LATEST``; a crash mid-save
never hides or corrupts the newest complete checkpoint.  Leaves are
stored whole; :func:`restore` puts each on the device of the tensor it
replaces.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import pytree

# torch dtypes by the names the manifest gives them (numpy's; bfloat16
# as JAX names it)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of one leaf."""
    t = leaf.detach().cpu()
    name = NAMES[t.dtype]
    if t.dtype == torch.bfloat16:             # numpy has no bf16: its bits
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    """The leaf :func:`_to_numpy` stored, on the CPU."""
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(DTYPES[logical])


def save(ckpt_dir: str, step: int, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = pytree.flatten(tree)
    meta = {"step": step, "treedef": pytree.describe(treedef),
            "n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, logical = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # LATEST updated last -> atomic publication
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def restore(ckpt_dir: str, like, step: int | None = None):
    """Restore into the structure of ``like`` (a tree of tensors); returns
    (step, tree) or (None, None) if there is no checkpoint.  Each leaf
    keeps the dtype it was saved with and goes to the device of ``like``'s
    leaf."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    leaves, treedef = pytree.flatten(like)
    assert meta["n_leaves"] == len(leaves), \
        f"checkpoint has {meta['n_leaves']} leaves, model has {len(leaves)}"
    out = []
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        expect = tuple(leaf.shape)
        assert tuple(arr.shape) == expect, \
            f"leaf {i}: ckpt {arr.shape} != model {expect}"
        out.append(_from_numpy(arr, meta["leaves"][i]["dtype"]).to(
            leaf.device))
    return step, pytree.unflatten(treedef, out)


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Retain the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[-1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
