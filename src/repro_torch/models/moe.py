"""Mixture-of-Experts layer (GShard-style capacity dispatch).

The port of the JAX package's ``repro/models/moe.py``: top-k routing with
capacity ``C = ceil(k * Sg / E * capacity_factor)`` over groups of ``Sg =
min(moe_group_size, B * S)`` tokens; tokens past an expert's capacity are
dropped (Switch/GShard semantics), and the Switch load-balancing loss is
returned beside the output.

The JAX package dispatches with one-hot einsums over ``[G, Sg, E, C]``.
The port computes the same function by gather and scatter on each
(expert, slot) pair's token and never materialises that tensor: the
routing decisions (:func:`route`) give every kept (token, choice) its
slot ``idx * C + pos``; the experts' inputs are gathered from those slots
(an empty slot holds zeros, as the one-hot product gives), every expert
runs on its ``G * C`` slots as one batched product, and each token takes
back its kept choices' outputs weighted by their gates.  The JAX
package's sharding hints (``moe_partition``, ``_constrain``) mean nothing
on one card and have no counterpart.

Numerics follow the JAX block: the router logits are f32
(``x.float() @ router.float()``, the router in its own dtype), the top-k
gates are renormalised in f32, the experts and the shared expert run in
the compute dtype, the combine weights are cast to it before the product.
The JAX package has no Pallas kernel for this block, so it is plain
PyTorch (a hand kernel would be a later speed item).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_normal, dtype_of, init_mlp,
                                       mlp_block, mlp_shapes)


class Routing(NamedTuple):
    """One group-batched routing decision (``G`` groups of ``Sg`` tokens,
    ``k`` choices each): ``probs`` the router's softmax [G, Sg, E] f32,
    ``gates`` the renormalised top-k probabilities [G, Sg, k] f32, ``idx``
    the chosen experts [G, Sg, k] (descending probability, the lower
    expert first among equal ones), ``pos`` each choice's place in its
    expert's queue [G, Sg, k], ``keep`` whether it is within the
    capacity ``C``."""
    probs: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int


def capacity(cfg, Sg: int) -> int:
    """Slots per expert and group: the JAX block's float expression, in
    its order."""
    return int(math.ceil(cfg.top_k * Sg / cfg.n_experts *
                         cfg.capacity_factor))


def group_size(cfg, T: int) -> int:
    """``Sg = min(moe_group_size, T)`` for ``T`` tokens; a ``T`` that
    groups of ``Sg`` do not divide raises (the JAX block asserts it)."""
    Sg = min(cfg.moe_group_size, T)
    if T % Sg:
        raise ValueError(f"MoE: {T} tokens do not split into groups of {Sg} "
                         f"(moe_group_size {cfg.moe_group_size}); the JAX "
                         "package asserts T % Sg == 0 too")
    return Sg


def init_moe(cfg, gen, lead=(), device=None):
    """The router [*lead, d, E], the experts' ``w1``, ``w3`` [*lead, E, d,
    moe_d_ff] and ``w2`` [*lead, E, moe_d_ff, d] (``w3`` even for GELU,
    as the JAX package makes it) and, with ``shared_expert``, an MLP of
    width ``moe_d_ff`` under ``shared``, drawn from ``gen`` at the JAX
    package's scales."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    pdt = dtype_of(cfg.param_dtype)
    p = {"router": _normal((*lead, d, E), d ** -0.5, pdt, gen, device),
         "w1": _normal((*lead, E, d, ff), d ** -0.5, pdt, gen, device),
         "w3": _normal((*lead, E, d, ff), d ** -0.5, pdt, gen, device),
         "w2": _normal((*lead, E, ff, d), ff ** -0.5, pdt, gen, device)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(cfg, gen, lead, device, d=d, ff=ff)
    return p


def moe_shapes(cfg, lead=()) -> dict:
    """The shapes of :func:`init_moe`'s tree."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": (*lead, d, E), "w1": (*lead, E, d, ff),
         "w3": (*lead, E, d, ff), "w2": (*lead, E, ff, d)}
    if cfg.shared_expert:
        p["shared"] = mlp_shapes(cfg, lead, d=d, ff=ff)
    return p


def queue_positions(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue: the number of
    earlier pairs of its group, in the flattened [Sg * k] (token, choice)
    order, that chose the same expert (the JAX block's cumsum of the
    one-hot choices, counted by a stable sort instead)."""
    G, Sg, k = idx.shape
    flat = idx.reshape(G, Sg * k)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((G, E), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts     # first rank per expert
    rank = torch.arange(Sg * k, device=idx.device).expand(G, -1)
    pos = torch.empty_like(flat)
    pos.scatter_(1, order, rank - starts.gather(1, flat.gather(1, order)))
    return pos.reshape(G, Sg, k)


def route(cfg, p, xg) -> Routing:
    """The routing decisions for ``xg`` [G, Sg, d]: the softmax of the f32
    router logits and its top-k in descending order (a stable sort: among
    equal probabilities the lower expert first, as ``jax.lax.top_k``
    orders them), then :func:`decide`."""
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.top_k]
    return decide(cfg, probs, idx)


def decide(cfg, probs, idx) -> Routing:
    """The rest of a routing decision from the router's softmax ``probs``
    [G, Sg, E] and the chosen experts ``idx`` [G, Sg, k]: their gates
    renormalised in f32, their queue positions and the capacity mask."""
    gates = probs.gather(-1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = capacity(cfg, probs.shape[1])
    pos = queue_positions(idx, cfg.n_experts)
    return Routing(probs, gates, idx, pos, pos < C, C)


def experts(cfg, p, xe):
    """Every expert on its slots: xe [E, N, d] -> [E, N, d] in xe's
    dtype (SwiGLU, or GELU's tanh form on ``w1`` alone)."""
    cdt = xe.dtype
    h = torch.bmm(xe, p["w1"].to(cdt))
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(xe, p["w3"].to(cdt))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w2"].to(cdt))


def moe_block(cfg, p, x):
    """x [B, S, d] -> (y [B, S, d] in x's dtype, aux loss f32 0-d)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    Sg = group_size(cfg, T)
    G = T // Sg
    xg = x.reshape(G, Sg, d)
    r = route(cfg, p, xg)
    C = r.C
    # every kept choice's slot (expert, place) in [0, E * C); a dropped one
    # goes to slot E * C, which reads zeros and is never an expert's input
    slot = torch.where(r.keep, r.idx * C + r.pos, E * C).reshape(G, Sg * k)
    tok = torch.arange(Sg, device=x.device).repeat_interleave(k)
    src = torch.full((G, E * C + 1), Sg, dtype=torch.long, device=x.device)
    src.scatter_(1, slot, tok.expand(G, -1))        # the token in each slot
    xpad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    xe = xpad.gather(1, src[:, :E * C, None].expand(-1, -1, d))  # [G, E*C, d]
    xe = xe.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    ye = experts(cfg, p, xe)
    ye = ye.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    ye = torch.cat([ye, ye.new_zeros(G, 1, d)], dim=1)
    picked = ye.gather(1, slot[..., None].expand(-1, -1, d))
    w = (r.gates * r.keep).to(x.dtype)                       # [G, Sg, k]
    y = (w[:, :, None, :] @ picked.reshape(G, Sg, k, d))[:, :, 0]
    if cfg.shared_expert:
        y = y + mlp_block(cfg, p["shared"], xg)
    # Switch aux loss: E * sum_e (top-1 share of e) * (mean prob of e)
    frac = F.one_hot(r.idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * r.probs.mean(dim=(0, 1)))
    return y.reshape(B, S, d), aux
