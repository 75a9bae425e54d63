"""Fault-tolerant training loop.

The port of the JAX package's ``repro/train/loop.py``, with its semantics:

* checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps and
  at the last one, the newest ``keep_ckpts`` kept; on start the loop
  restores LATEST and the deterministic data pipeline replays from
  exactly that step.  The step's kernels are deterministic (no float
  atomics), so a restart is byte-exact against a run that never failed.
* straggler mitigation: a per-step wall-clock watchdog flags steps slower
  than ``straggler_factor`` x the running median of the steps before
  (from the sixth step on); the events are returned.
* failure injection: ``fail_at_step`` raises before that step runs.

``float(loss)`` is each step's synchronisation with the card, and its
timing.  The step updates the parameters and moments in place (the JAX
step donates them).
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable

import torch

from repro_torch import pytree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: int | None = None   # failure injection (tests/examples)


def make_train_step(cfg, opt_cfg: adamw.OptConfig,
                    donate: bool = True) -> Callable:
    """The (state, batch) -> (state, metrics) step: the loss and every
    parameter's gradient (``torch.autograd.grad``), then the AdamW update,
    in place on the state's tensors when ``donate`` (else on copies).
    Metrics: loss, grad_norm, lr (0-d tensors on the card)."""

    def step_fn(state, batch):
        params, opt_state = state
        flat, treedef = pytree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        new_params, new_opt, om = adamw.update(
            opt_cfg, pytree.unflatten(treedef, list(grads)), opt_state,
            params, inplace=donate)
        return (new_params, new_opt), {"loss": loss.detach(), **om}

    return step_fn


def init_state(cfg, seed: int = 0, device="cuda"):
    """Seeded parameters (:func:`repro_torch.models.transformer.
    init_params`) and a fresh optimizer state, on ``device``."""
    params = tfm.init_params(cfg, seed=seed, device=device)
    return params, adamw.init(params)


def run(cfg, loop: LoopConfig, opt_cfg: adamw.OptConfig,
        source: SyntheticLM, state=None, train_step=None, seed: int = 0,
        device="cuda") -> dict:
    """Run (or resume) training.  Returns the summary dict: the final
    state, the steps' losses, whether it resumed and from which step,
    the straggler events and the steps' seconds."""
    if train_step is None:
        train_step = make_train_step(cfg, opt_cfg)
    if state is None:
        state = init_state(cfg, seed, device)
    start, restored = 0, False
    rstep, rstate = ckpt.restore(loop.ckpt_dir, state)
    if rstate is not None:
        state, start, restored = rstate, rstep, True

    times: list[float] = []
    straggler_events: list[int] = []
    losses: list[float] = []
    for step in range(start, loop.total_steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        batch = source.batch_for_step(step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])          # blocks; also step timing
        dt = time.perf_counter() - t0
        if len(times) >= 5:
            med = statistics.median(times)
            if dt > loop.straggler_factor * med:
                straggler_events.append(step)
        times.append(dt)
        losses.append(loss)
        if (step + 1) % loop.ckpt_every == 0 or \
                step + 1 == loop.total_steps:
            ckpt.save(loop.ckpt_dir, step + 1, state)
            ckpt.cleanup(loop.ckpt_dir, loop.keep_ckpts)
        if (step + 1) % loop.log_every == 0:
            print(f"step {step + 1}: loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt * 1e3:.0f}ms")
    return {"state": state, "losses": losses, "resumed": restored,
            "start_step": start, "straggler_events": straggler_events,
            "step_times": times}
