"""RWKV6's bf16 drift with depth, in the JAX package and in the port, on
the CPU.

Not a test (pytest does not collect it): a measurement behind phase 8c's
``RWKV_BF16_RATIO`` in ``chip_smoke.py``.  At rwkv6-1.6b's reduced width
with its full 24 layers (or ``--layers``), the same parameters (the JAX
package's init, carried across as numpy) and the same tokens go through
both packages in bf16 and in f32 compute, as phase 8c's state check runs
them: one ``prefill`` over ``--seq`` tokens, and ``prefill`` over the
first ``--split`` tokens followed by teacher-forced ``decode_step``s over
the rest.  For each package it prints the last logits' max |diff|
between the two bf16 paths, each bf16 path's distance from the f32
one-prefill logits and their ratio (split over prefill), which is what
phase 8c bounds.  Two faults are read on the port's split path for
comparison: the carried state ``S`` rounded to bf16 at the boundary, and
the token shift's carried tokens (``x_tm``, ``x_cm``) lost there.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv_bf16_depth.py \\
        [--layers 24] [--d-model 128] [--batch 4] [--seq 512] [--split 480]
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as tfm


def jax_paths(jcfg, jp, toks, split):
    """(split path, one prefill) last logits of the JAX package."""
    pre = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, {"tokens": t},
                                            max_len=0))
    dec = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    full, _ = pre(jp, jnp.asarray(toks))
    got, cache = pre(jp, jnp.asarray(toks[:, :split]))
    for t in range(split, toks.shape[1]):
        got, cache = dec(jp, jnp.asarray(toks[:, t:t + 1]), cache)
    return np.asarray(got, np.float64), np.asarray(full, np.float64)


def port_paths(cfg, tp, toks, split, fault=None):
    """(split path, one prefill) last logits of the port; ``fault`` is
    applied to the cache at the prefill/decode boundary."""
    tp = tfm.cast_params(cfg, tp)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        full, _ = tfm.prefill(cfg, tp, {"tokens": t}, max_len=0)
        got, cache = tfm.prefill(cfg, tp, {"tokens": t[:, :split]},
                                 max_len=0)
        if fault == "state_bf16":
            cache["S"].copy_(cache["S"].bfloat16().float())
        elif fault == "shift_lost":
            cache["x_tm"].zero_()
            cache["x_cm"].zero_()
        for i in range(split, toks.shape[1]):
            got, cache = tfm.decode_step(cfg, tp, t[:, i:i + 1], cache)
    return got.double().numpy(), full.double().numpy()


def gaps(split_b, full_b, full_f) -> dict:
    def dmax(a, b):
        return float(np.abs(a - b).max())
    out = dict(bf16_split_vs_prefill=dmax(split_b, full_b),
               bf16_prefill_vs_f32=dmax(full_b, full_f),
               bf16_split_vs_f32=dmax(split_b, full_f))
    out["ratio"] = out["bf16_split_vs_f32"] / out["bf16_prefill_vs_f32"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--split", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    kw = dict(n_layers=a.layers, d_model=a.d_model,
              n_heads=a.d_model // 32, n_kv_heads=a.d_model // 32)
    cfgs = {dtn: (dataclasses.replace(jget_arch("rwkv6-1.6b").reduced(),
                                      compute_dtype=dtn, **kw),
                  dataclasses.replace(get_arch("rwkv6-1.6b").reduced(),
                                      compute_dtype=dtn, **kw))
            for dtn in ("bfloat16", "float32")}
    jcfg, cfg = cfgs["float32"]
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.key(a.seed)))
    jp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab, (a.batch, a.seq)).astype(np.int32)
    t0 = time.perf_counter()
    logits = {}
    for dtn, (jc, c) in cfgs.items():
        logits["jax", dtn] = jax_paths(jc, jp, toks, a.split)
        logits["port", dtn] = port_paths(c, lm_params_from_numpy(
            c, tree, "cpu"), toks, a.split)
    out = dict(layers=a.layers, d_model=a.d_model, batch=a.batch,
               seq=a.seq, split=a.split, vocab=cfg.vocab)
    for pkg in ("jax", "port"):
        split_f, full_f = logits[pkg, "float32"]
        out[pkg] = dict(f32_split_vs_prefill=float(
            np.abs(split_f - full_f).max()),
            logit_scale=float(np.abs(full_f).max()),
            **gaps(*logits[pkg, "bfloat16"], full_f))
    out["port_vs_jax"] = {dtn: float(np.abs(logits["port", dtn][1]
                                            - logits["jax", dtn][1]).max())
                          for dtn in cfgs}
    bc = cfgs["bfloat16"][1]
    full_f = logits["port", "float32"][1]
    for fault in ("state_bf16", "shift_lost"):
        split_b, full_b = port_paths(bc, lm_params_from_numpy(
            bc, tree, "cpu"), toks, a.split, fault)
        out[f"port_fault_{fault}"] = gaps(split_b, full_b, full_f)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
