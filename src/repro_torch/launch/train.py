"""Training launcher:
``python -m repro_torch.launch.train --arch <id> [--full|--reduced]
[--device cpu]``, ``<id>`` one of the configs the port runs
(internlm2-1.8b, stablelm-1.6b, starcoder2-7b, command-r-plus-104b,
llama4-scout-17b-a16e, kimi-k2-1t-a32b, rwkv6-1.6b, zamba2-7b).  An MoE
model's loss adds ``0.01 x`` its layers' aux loss; no MoE config trains
on one card at full width (kimi-k2's first 2 layers alone hold 1.99e10
parameters, 319 GB of f32 AdamW state), so run them ``--reduced``;
neither does zamba2-7b at full depth (6.75e9 parameters, about 108 GB of
f32 parameters, gradients and moments; ``chip_smoke.py`` trains its
first 12 layers at full width).

The port of the JAX package's ``repro/launch/train.py``, with its
defaults: 100 steps of batch 4 x seq 128 from ``SyntheticLM(seed=0)``,
AdamW at lr 3e-4 (warm-up over the first 20 steps, cosine decay to the
last), a checkpoint every 50 steps.  It runs on the card at full width
unless asked otherwise; ``--device cpu`` runs the kernels' plain versions
and defaults to the reduced config.  A run whose checkpoint directory
holds a checkpoint resumes from it.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ARCHS, get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import adamw
from repro_torch.train import loop as train_loop


def main(argv=None) -> dict:
    """Train; print the JAX launcher's ``done:`` line (with the device)
    and return the loop's summary with the arch, reduced flag and
    device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=None,
                    help="reduced-width config (default on the CPU)")
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
    src = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=0,
                      frontend=cfg.frontend, n_patches=cfg.n_patches,
                      frontend_dim=cfg.frontend_dim, enc_seq=cfg.enc_seq)
    opt = adamw.OptConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                          total_steps=args.steps)
    lp = train_loop.LoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10)
    out = train_loop.run(cfg, lp, opt, src, seed=0, device=dev)
    final = out["losses"][-1] if out["losses"] else float("nan")
    print(f"done: arch={args.arch} reduced={reduced} "
          f"resumed={out['resumed']} final_loss={final:.4f} device={dev}")
    return dict(out, arch=args.arch, reduced=reduced, device=str(dev))


if __name__ == "__main__":
    main()
