#!/usr/bin/env python3
"""Diagnostic only: how far bf16 rounding of P and dS moves attention's
gradients at phase 8b (b)'s shape of ``chip_smoke.py`` (internlm2-1.8b
training at batch 1 x seq 4096: 16/8 heads, hd 128, causal), on the CPU.
The plain replay of the tensor-core backward kernels
(``attention_backward_tiles(..., bf16_products=True, terms=n)``) is held
against the f32 plain backward (``attention_backward``) on the same bf16
inputs, as ``grad_error_ratio`` shares of the bf16 tolerance (3e-2), for
dq, dk and dv.

    PYTHONPATH=src python3 scripts/attn_bwd_rounding.py [--terms 1,2]

``terms=1`` rounds P and dS once to bf16 before their products;
``terms=2`` carries each as two bf16 terms (hi = bf16(x), lo = bf16(x -
hi)), as the kernels do.  Inputs: ``torch.randn`` on a CPU generator
seeded 25, then 1, in the order q, dO, k, v.  About 40 s a (seed, terms)
pair on 4 CPU threads.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 3e-2
S, H, HKV, HD = 4096, 16, 8, 128
SEEDS = (25, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--terms", default="1,2",
                    help="bf16 terms of P and dS, comma-separated")
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        q, do = (torch.randn((1, S, H, HD), generator=gen).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((1, S, HKV, HD), generator=gen).bfloat16()
                for _ in range(2))
        out, lse = fa.attention(q, k, v, causal=True, with_lse=True)
        want = fa.attention_backward(q, k, v, out, lse, do, causal=True)
        for terms in (int(x) for x in a.terms.split(",")):
            t0 = time.perf_counter()
            got = fa.attention_backward_tiles(q, k, v, out, lse, do,
                                              causal=True,
                                              bf16_products=True,
                                              terms=terms)
            ratios = [fa.grad_error_ratio(g, w, TOL)
                      for g, w in zip(got, want)]
            print(f"seed {seed}, terms {terms}: dq/dk/dv {ratios[0]:.3f} / "
                  f"{ratios[1]:.3f} / {ratios[2]:.3f} of the bf16 tolerance "
                  f"{TOL:g} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
