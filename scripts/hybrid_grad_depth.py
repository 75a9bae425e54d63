#!/usr/bin/env python3
"""Diagnostic only: how far zamba2-7b's gradients through the kernels lie
from the plain path's as the depth grows, on the card.

At full width, batch 1 x seq 4096 and each of ``--depths`` layers (the
shared attention layer after every 6th), in each of ``--dtypes`` compute,
``chip_smoke.phase_train_vs_plain`` takes the loss and every gradient
leaf through the kernels (rows 9-10 and their backward, rows 12-14) and
through the plain path (autograd of the plain versions) on the same
parameters and batch, and reads each leaf's relative Frobenius distance
between the two.  Its checks (phase 8b's 1e-2 on the loss and 3e-2 on
each leaf) are read, not enforced: each reading prints with the checks it
would fail.  This is the measurement behind phase 8e's
``HYBRID_GRAD_LAYERS``.

    python3 scripts/hybrid_grad_depth.py [--depths 6,12,18] \\
        [--dtypes bfloat16,float32]

About 10 s a (depth, dtype) pair on an H100 after the kernels' build.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="6,12,18",
                    help="layer counts, comma-separated")
    ap.add_argument("--dtypes", default="bfloat16,float32",
                    help="compute dtypes, comma-separated")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hybrid_grad_depth: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, phase_train_vs_plain, refusals
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 8e sets it
    _build.load()
    card = card_line()
    out = []
    for dtn in a.dtypes.split(","):
        cfg = dataclasses.replace(get_arch("zamba2-7b"), compute_dtype=dtn)
        for n in (int(x) for x in a.depths.split(",")):
            with refusals() as seen:
                r = phase_train_vs_plain(dev, cfg, tag=f"zamba2 {dtn} {n}",
                                         n_layers=n)
            out.append(dict(card=card, dtype=dtn, n_layers=n,
                            sites=n // cfg.attn_every, seq=r["seq"],
                            loss_rel_err=r["loss_rel_err"],
                            max_grad_rel_err=r["max_grad_rel_err"],
                            min_grad_rel_err=min(r["grad_rel_err"]),
                            would_fail=seen))
            print(json.dumps(out[-1]), flush=True)
    print(json.dumps({"hybrid_grad_depth": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
