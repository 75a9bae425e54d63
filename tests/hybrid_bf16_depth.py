"""The Mamba2 hybrid's bf16 drift with depth, in the JAX package and in
the port, on the CPU.

Not a test (pytest does not collect it): a measurement behind the bf16
holds of ``tests/test_torch_hybrid.py`` and of phase 8e in
``chip_smoke.py``.  At zamba2-7b's reduced width (d 128, 8 SSM heads of
P 32, state N 16, 4/4 attention heads) with the full model's shared
attention layer after every 6th Mamba layer, at each of ``--layers``
depths (81 is the full model's), the same parameters (the JAX package's
init, carried across as numpy) and the same tokens go through both
packages in bf16 and in f32 compute, as the served path runs them: one
``prefill`` over ``--seq`` tokens, then ``--steps`` teacher-forced
``decode_step``s.  For each package and depth it prints the largest
|diff| over every step's logits between its bf16 and its own f32 run,
the share of positions whose argmax they agree on, and the port's
distance over JAX's (``port_over_jax``: near 1 when the port rounds where
JAX does); and the two packages' distance from each other in each dtype.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/hybrid_bf16_depth.py \\
        [--layers 6,24,81] [--batch 2] [--seq 64] [--steps 8]
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

ARCH = "zamba2-7b"


def jax_steps(jcfg, jp, toks, steps, max_len) -> np.ndarray:
    """The JAX package's logits [n_steps + 1, B, V]: the prefill's, then
    each teacher-forced decode step's."""
    lj, cj = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, {"tokens": t},
                                               max_len=max_len))(
        jp, jnp.asarray(toks))
    dec = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    out = [lj]
    for tok in steps:
        lj, cj = dec(jp, jnp.asarray(tok), cj)
        out.append(lj)
    return np.stack([np.asarray(x, np.float64) for x in out])


def port_steps(cfg, tp, toks, steps, max_len) -> np.ndarray:
    """The port's logits, as :func:`jax_steps`."""
    tp = tfm.cast_params(cfg, tp)
    with torch.inference_mode():
        lt, ct = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                             max_len=max_len)
        out = [lt]
        for tok in steps:
            lt, ct = tfm.decode_step(cfg, tp, torch.from_numpy(tok), ct)
            out.append(lt)
    return np.stack([x.double().numpy() for x in out])


def depth(n_layers, a) -> dict:
    cfgs = {dtn: tuple(dataclasses.replace(
        g(ARCH).reduced(), compute_dtype=dtn, n_layers=n_layers,
        attn_every=g(ARCH).attn_every) for g in (jget_arch, get_arch))
        for dtn in ("bfloat16", "float32")}
    jcfg, cfg = cfgs["float32"]
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.key(a.seed)))
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, (a.batch, a.seq)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (a.batch, 1)).astype(np.int32)
             for _ in range(a.steps)]
    max_len = a.seq + a.steps
    t0 = time.perf_counter()
    logits = {}
    for dtn, (jc, c) in cfgs.items():
        logits["jax", dtn] = jax_steps(jc, jp, toks, steps, max_len)
        logits["port", dtn] = port_steps(c, lm_params_from_numpy(
            c, tree, "cpu"), toks, steps, max_len)
    out = dict(layers=n_layers, sites=n_layers // cfg.attn_every,
               d_model=cfg.d_model, batch=a.batch, seq=a.seq,
               steps=a.steps)
    for pkg in ("jax", "port"):
        b, f = logits[pkg, "bfloat16"], logits[pkg, "float32"]
        out[pkg] = dict(bf16_vs_f32=float(np.abs(b - f).max()),
                        bf16_vs_f32_by_step=[
                            round(float(np.abs(b[i] - f[i]).max()), 4)
                            for i in range(len(b))],
                        same_argmax_share=float(
                            (b.argmax(-1) == f.argmax(-1)).mean()),
                        logit_scale=float(np.abs(f).max()))
    out["port_over_jax"] = out["port"]["bf16_vs_f32"] / \
        out["jax"]["bf16_vs_f32"]
    out["port_vs_jax"] = {dtn: float(np.abs(
        logits["port", dtn] - logits["jax", dtn]).max()) for dtn in cfgs}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default="6,24,81")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    out = []
    for n in (int(x) for x in a.layers.split(",")):
        out.append(depth(n, a))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
