"""Serving launcher:
``python -m repro_torch.launch.serve --arch <id> [--full|--reduced]
[--device cpu]``, ``<id>`` one of the configs the port runs
(internlm2-1.8b, stablelm-1.6b, starcoder2-7b, command-r-plus-104b,
llama4-scout-17b-a16e, kimi-k2-1t-a32b, rwkv6-1.6b, zamba2-7b; the
others raise ``NotImplementedError``).  zamba2-7b (81 Mamba2 layers and
one shared attention layer at 13 sites, 6.75e9 parameters) serves at
full width and depth on one card.

The MoE configs run as the JAX package's do, with its group rule: a wave
of B x S tokens must split into MoE groups of ``min(moe_group_size, B *
S)`` tokens, else ``ValueError`` (the JAX package asserts).  At
``--reduced`` (groups of 64) the default waves of 4 do not (4 x 25 = 100
tokens): serve them with ``--batch-size 2``.  At full width (groups of
512) the default waves pass.  ``--full`` does not fit one card for
llama4-scout-17b-a16e (48 layers, 1.08e11 parameters) or kimi-k2-1t-a32b
(61 layers, 1.03e12), and the launcher has no depth flag, as the JAX
one has none: a run of either on the card builds
:class:`~repro_torch.serve.engine.ServeEngine` itself on
``dataclasses.replace(cfg, n_layers=2)`` (``chip_smoke.py`` phase 8d).

The port of the JAX package's ``repro/launch/serve.py``, with its
defaults: random parameters from seed 0, 8 requests with prompts of 4-32
random tokens (numpy seed 0), 16 new tokens each, waves of 4, a cache of
256 (which RWKV6 ignores; zamba2-7b's shared layer keeps one of that
length a site).  It runs on the card at full width unless
asked otherwise; ``--device cpu`` runs the kernels' plain versions and
defaults to the reduced config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCHS, get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    """Serve the requests; print one summary line and return its numbers
    (requests, tokens, wall seconds, tokens per second), the results, the
    requests served (``reqs``) and the engine (``engine``: its compute
    copy of the parameters, for a caller that checks the run)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=None)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    reduced = args.reduced
    if reduced is None:
        reduced = dev.type == "cpu"
    cfg = get_arch(args.arch)
    if reduced:
        cfg = cfg.reduced()
    params = tfm.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, batch_size=args.batch_size,
                      max_len=args.max_len, device=dev)
    del params                       # the engine holds its compute copy
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(
                        0, cfg.vocab,
                        (int(rng.integers(4, 32)),)).astype(np.int32),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    print(f"arch={args.arch} reduced={reduced} device={dev}: served "
          f"{len(reqs)} requests, {total} tokens in {wall:.3f} s "
          f"({total / wall:.1f} tokens/s)")
    return dict(arch=args.arch, reduced=reduced, device=str(dev),
                requests=len(reqs), tokens=total, wall_s=wall,
                tokens_per_s=total / wall, results=results, reqs=reqs,
                engine=eng)


if __name__ == "__main__":
    main()
