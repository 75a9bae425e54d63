"""RWKV6 ("Finch"): the attention-free time-mix and channel-mix.

The port of the RWKV6 part of the JAX package's ``repro/models/ssm.py``
(arXiv:2404.05892): a token-shift lerp into r, k, v, g and a
data-dependent per-channel decay (the low-rank "lora" path), a chunked
linear-attention scan carrying an f32 state ``S`` [B, H, P, P] from chunk
to chunk, a per-head RMS "groupnorm", a silu gate and the output
projection; then the channel-mix (``relu²`` keys, a sigmoid receptance).

The time-mix is a Python loop over ``S // Q`` chunks (``Q = min(32, S)``);
within a chunk the decay between tokens t and s is ``exp(dprev_t -
dcum_s)`` for s < t, from cumulative log-decays, masked with
``torch.where`` (the masked exponents can be large: a product with a 0/1
mask would turn an ``inf`` into a ``NaN``).  A length that is not a
multiple of the chunk raises, as the JAX package asserts.  Decode is the
same code at S = 1 with the carried state.

Plain PyTorch, on the card as on the CPU: the JAX package has no Pallas
kernel for it (a hand kernel is a later speed item).  Casts follow the
JAX code: the decay's ``w0``, ``wA``, ``wB``, the bonus ``u`` and the
groupnorm's ``ln_w`` are read in f32, the lerp coefficients and the
matrices in the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dtype_of

LORA_R = 64
CHUNK = 32
# leaves the JAX code reads with .astype(float32): kept at their own dtype
# when the other weights are cast to the compute dtype
F32_LEAVES = ("w0", "wA", "wB", "u", "ln_w")


def rwkv6_dims(cfg):
    d = cfg.d_model
    P = cfg.ssm_head_dim
    return d, d // P, P


def rwkv6_shapes(cfg, lead=()) -> dict:
    """The shape of every tensor :func:`init_rwkv6` makes, by key."""
    d, H, P = rwkv6_dims(cfg)
    ff = cfg.d_ff
    shapes = {"mu": (5, d), "Wr": (d, d), "Wk": (d, d), "Wv": (d, d),
              "Wg": (d, d), "Wo": (d, d), "w0": (d,), "wA": (d, LORA_R),
              "wB": (LORA_R, d), "u": (H, P), "ln_w": (d,), "mu_cm": (2, d),
              "Wk_cm": (d, ff), "Wv_cm": (ff, d), "Wr_cm": (d, d)}
    return {k: (*lead, *s) for k, s in shapes.items()}


def init_rwkv6(cfg, gen, lead=(), device=None):
    """One time-mix/channel-mix block's weights drawn from ``gen`` at the
    JAX package's scales (``init_rwkv6``); ``lead`` prepends stacking axes
    (layers)."""
    d, H, P = rwkv6_dims(cfg)
    ff = cfg.d_ff
    pdt = dtype_of(cfg.param_dtype)
    std = d ** -0.5

    def uniform(shape):
        return torch.rand((*lead, *shape), generator=gen, device=device,
                          dtype=torch.float32).mul_(0.5).to(pdt)

    def normal(shape, s):
        return _normal((*lead, *shape), s, pdt, gen, device)

    return {"mu": uniform((5, d)),
            "Wr": normal((d, d), std), "Wk": normal((d, d), std),
            "Wv": normal((d, d), std), "Wg": normal((d, d), std),
            "Wo": normal((d, d), std),
            "w0": torch.full((*lead, d), -2.0, dtype=pdt, device=device),
            "wA": normal((d, LORA_R), std),
            "wB": normal((LORA_R, d), LORA_R ** -0.5),
            "u": normal((H, P), 0.1),
            "ln_w": torch.ones((*lead, d), dtype=pdt, device=device),
            "mu_cm": uniform((2, d)),
            "Wk_cm": normal((d, ff), std),
            "Wv_cm": normal((ff, d), ff ** -0.5),
            "Wr_cm": normal((d, d), std)}


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or the carried last token, at t = 0)."""
    B, S, d = x.shape
    first = x.new_zeros((B, 1, d)) if last is None else last.to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1) if S > 1 else first


def _rwkv_proj(cfg, p, x, xs):
    d, H, P = rwkv6_dims(cfg)
    B, S, _ = x.shape
    mu = p["mu"].to(x.dtype)
    mix = [x + mu[i] * (xs - x) for i in range(5)]
    r = (mix[0] @ p["Wr"].to(x.dtype)).reshape(B, S, H, P)
    k = (mix[1] @ p["Wk"].to(x.dtype)).reshape(B, S, H, P)
    v = (mix[2] @ p["Wv"].to(x.dtype)).reshape(B, S, H, P)
    g = F.silu(mix[3] @ p["Wg"].to(x.dtype))
    ww = p["w0"].float() + (torch.tanh(mix[4].float() @ p["wA"].float())
                            @ p["wB"].float())
    logw = -torch.exp(ww).reshape(B, S, H, P)   # <= 0, data-dependent decay
    return r, k, v, g, logw


def chunk_of(S: int, chunk: int = CHUNK) -> int:
    """The time-mix's chunk for a length S: ``min(chunk, S)``, which must
    divide S (the JAX package asserts it; no padding rule is defined)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"rwkv6_timemix: a length of {S} tokens is not a "
                         f"multiple of the chunk {Q}")
    return Q


def rwkv6_timemix(cfg, p, x, state=None, chunk: int = CHUNK):
    """x: [B, S, d] -> (y, new_state); state: {"S": f32 [B, H, P, P],
    "x_tm": [B, 1, d]} or None (zeros).  The new state's ``x_tm`` is x's
    last token."""
    d, H, P = rwkv6_dims(cfg)
    B, S, _ = x.shape
    Q = chunk_of(S, chunk)
    xs = _shift(x, None if state is None else state.get("x_tm"))
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, xs)
    r32, k32, v32 = r.float(), k.float(), v.float()
    u = p["u"].float()
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device),
                      diagonal=-1)[None, :, :, None, None]
    Sst = x.new_zeros((B, H, P, P), dtype=torch.float32) if state is None \
        else state["S"]
    ys = []
    for c0 in range(0, S, Q):
        r_c, k_c, v_c, lw_c = (t[:, c0:c0 + Q] for t in (r32, k32, v32, logw))
        dcum = torch.cumsum(lw_c, dim=1)                  # [B, Q, H, P]
        dprev = dcum - lw_c                               # up to t - 1
        # intra-chunk: score[t, s] = sum_p r_t k_s exp(dprev_t - dcum_s), s<t
        Ld = torch.where(mask, torch.exp(dprev[:, :, None] - dcum[:, None]),
                         0.0)                             # [B, Q, Q, H, P]
        score = (r_c[:, :, None] * k_c[:, None] * Ld).sum(-1)   # [B,Q,Q,H]
        y = torch.einsum("bqsh,bshp->bqhp", score, v_c)
        # the current token's bonus
        y = y + (r_c * u * k_c).sum(-1)[..., None] * v_c
        # the carried state
        y = y + torch.einsum("bqhp,bhpv->bqhv", r_c * torch.exp(dprev), Sst)
        # S' = exp(dlast) S + sum_s exp(dlast - dcum_s) k_s v_s
        dlast = dcum[:, -1]                               # [B, H, P]
        Sst = Sst * torch.exp(dlast)[..., None] + torch.einsum(
            "bshp,bshv->bhpv", k_c * torch.exp(dlast[:, None] - dcum), v_c)
        ys.append(y)
    y = torch.cat(ys, dim=1)                              # [B, S, H, P]
    # per-head "groupnorm" (RMS over the head), then the gate and Wo
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-5)
    y = y.reshape(B, S, d) * p["ln_w"].float()
    y = (y.to(x.dtype) * g) @ p["Wo"].to(x.dtype)
    return y, {"S": Sst, "x_tm": x[:, -1:]}


def rwkv6_channelmix(cfg, p, x, state=None):
    """x: [B, S, d] -> (y, {"x_cm": x's last token}); state's ``x_cm`` is
    the carried token for the shift."""
    mu = p["mu_cm"].to(x.dtype)
    xs = _shift(x, None if state is None else state.get("x_cm"))
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    kk = torch.square(F.relu(xk @ p["Wk_cm"].to(x.dtype)))
    y = torch.sigmoid(xr @ p["Wr_cm"].to(x.dtype)) * \
        (kk @ p["Wv_cm"].to(x.dtype))
    return y, {"x_cm": x[:, -1:]}
