"""AdamW with a cosine schedule and global-norm clipping, over the
parameter dict.

The port of the JAX package's ``repro/optim/adamw.py`` with its rules:
the gradients clipped to a global norm, the learning rate warmed up
linearly and then decayed on a cosine to ``min_lr_frac``, bias-corrected
moments, ``eps`` added outside the square root, no weight decay on
tensors of fewer than two dimensions (norm weights), and optional f32
master weights.  Moments are f32.  Each step is computed in f32 in the
JAX package's order of operations, leaf by leaf in
:func:`repro_torch.pytree.flatten`'s order.

``update(..., inplace=True)`` writes the new parameters, moments and
master weights into the tensors it is given, where JAX donates the old
buffers to the new ones; ``inplace=False`` (the default) leaves them as
they are and returns new tensors.  ``torch.optim.AdamW`` is not used: its
parameter groups express neither the per-tensor decay rule nor the
schedule as the JAX package computes them.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import pytree


class OptConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d: steps taken
    m: Any
    v: Any
    master: Any = None      # f32 master copy when params are bf16


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, frac)


def init(params, master_weights: bool = False) -> OptState:
    """Zero moments (f32) for every parameter, step 0 on the parameters'
    device, and with ``master_weights`` an f32 copy of each parameter."""
    flat = pytree.leaves(params)
    zeros = pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    master = pytree.tree_map(lambda p: p.detach().float().clone(), params) \
        if master_weights else None
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=flat[0].device),
                    m=zeros, v=pytree.tree_map(torch.clone, zeros),
                    master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), each leaf's sum in f32, the leaves'
    sums added in order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.leaves(tree)))


def _update_leaf(cfg, g, m, v, p, mw, scale, lr, b1c, b2c) -> None:
    """One leaf's step, in place on m, v, p and mw (the JAX package's
    ``upd``, with two scratch tensors of the leaf's size)."""
    g = g.float() * scale
    t = g * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)                       # b1 m + (1 - b1) g
    torch.mul(g, 1 - cfg.b2, out=t)
    t.mul_(g)
    v.mul_(cfg.b2).add_(t)                       # b2 v + (1 - b2) g g
    delta = torch.div(m, b1c, out=g)             # mhat
    torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)
    delta.div_(t)                                # mhat / (sqrt(vhat) + eps)
    p = p.detach()
    src = mw if mw is not None else \
        p if p.dtype == torch.float32 else p.float()
    if p.dim() >= 2:                             # no decay on norms
        delta.add_(torch.mul(src, cfg.weight_decay, out=t))
    src.sub_(delta.mul_(lr))                     # src - lr (delta + wd src)
    if src is not p:
        p.copy_(src)


def update(cfg: OptConfig, grads, state: OptState, params,
           inplace: bool = False):
    """Returns (new_params, new_state, metrics); metrics hold the global
    gradient norm before clipping and the step's learning rate (0-d f32
    tensors)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_p, treedef = pytree.flatten(params)
    flat_g, flat_m, flat_v = (pytree.leaves(t) for t in (grads, state.m,
                                                         state.v))
    flat_mw = pytree.leaves(state.master) if state.master is not None \
        else [None] * len(flat_p)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v) == \
            len(flat_mw):
        raise ValueError("grads, moments and params differ in structure")
    if not inplace:
        copy = lambda xs: [None if x is None else x.detach().clone()
                           for x in xs]
        flat_p, flat_m, flat_v, flat_mw = map(copy, (flat_p, flat_m, flat_v,
                                                     flat_mw))
    with torch.no_grad():
        for g, m, v, p, mw in zip(flat_g, flat_m, flat_v, flat_p, flat_mw):
            _update_leaf(cfg, g, m, v, p, mw, scale, lr, b1c, b2c)
    new_state = OptState(
        step, pytree.unflatten(treedef, flat_m),
        pytree.unflatten(treedef, flat_v),
        pytree.unflatten(treedef, flat_mw) if state.master is not None
        else None)
    return (pytree.unflatten(treedef, flat_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
