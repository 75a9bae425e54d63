"""Sub-quadratic sequence mixers: Mamba2 (SSD) and RWKV6 ("Finch").

The port of the JAX package's ``repro/models/ssm.py``.

**Mamba2** (zamba2-7b's backbone) in the SSD scalar-decay-per-head form,
one B/C group: an input projection into z, x, B, C and dt, a depthwise
causal conv of ``CONV_K`` = 4 taps over (x, B, C) with its carried ``[B,
3, C]`` tail, silu, a chunked scan carrying an f32 state ``h`` [B, H, P,
N] from chunk to chunk (:func:`mamba2_block`), ``D`` times the input
added, the gated RMSNorm (``layers.rmsnorm``: row 10's kernel on the card)
and the output projection; :func:`mamba2_step` is the single-token
recurrence.  The scan is a Python loop over ``S // Q`` chunks (``Q =
min(cfg.ssm_chunk, S)``); within a chunk the decay from token s to token
t is ``exp(l_t - l_s)`` for s <= t, from cumulative log-decays, masked
with ``torch.where`` on the exponent, which is set to ``-inf`` above the
diagonal (there it is positive and can overflow: a product with a 0/1
mask would turn an ``inf`` into a ``NaN`` in the forward, and masking the
exp instead, as the JAX package does, in the backward: JAX's gradient is
NaN once a chunk's summed decay passes 88, the port's stays finite), and
the intra-chunk product runs per head as a batched matrix
product over [Q, Q] decay-weighted scores, never as a [B, Q, Q, H, P]
tensor.  A length that is not a multiple of the chunk raises, where the
JAX package asserts.  The block also returns the carry a prefill hands to
decode (the final ``h`` and the last ``CONV_K - 1`` rows before the
conv), from the same pass.

**RWKV6** (arXiv:2404.05892): a token-shift lerp into r, k, v, g and a
data-dependent per-channel decay (the low-rank "lora" path), a chunked
linear-attention scan carrying an f32 state ``S`` [B, H, P, P] from chunk
to chunk, a per-head RMS "groupnorm", a silu gate and the output
projection; then the channel-mix (``relu²`` keys, a sigmoid receptance).
The time-mix is a Python loop over ``S // Q`` chunks (``Q = min(32,
S)``); within a chunk the decay between tokens t and s is ``exp(dprev_t -
dcum_s)`` for s < t, masked with ``torch.where`` as above.  A length that
is not a multiple of the chunk raises, as the JAX package asserts.
Decode is the same code at S = 1 with the carried state.

Plain PyTorch, on the card as on the CPU: the JAX package has no Pallas
kernel for either (a hand kernel is a later speed item).  Casts follow
the JAX code: Mamba2 reads ``A_log``, ``D`` and ``dt_bias`` in f32 and
runs dt, the decays and the scan in f32, the rest in the activations'
dtype; RWKV6 reads the decay's ``w0``, ``wA``, ``wB``, the bonus ``u``
and the groupnorm's ``ln_w`` in f32, the lerp coefficients and the
matrices in the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import _normal, dtype_of

# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
CONV_K = 4
# leaves the JAX code reads with .astype(float32), and the gated norm's
# weight (the RMSNorm kernel reads it in f32): kept at their own dtype
# when the other weights are cast to the compute dtype
MAMBA_F32_LEAVES = ("A_log", "D", "dt_bias", "norm_w")


def mamba2_dims(cfg):
    """(d_in, H, N, conv_dim): the inner width 2 d, its heads of
    ``ssm_head_dim``, the state size and the conv's channels (x, B, C)."""
    d_in = 2 * cfg.d_model
    N = cfg.ssm_state
    return d_in, d_in // cfg.ssm_head_dim, N, d_in + 2 * N


def mamba2_shapes(cfg, lead=()) -> dict:
    """The shape of every tensor :func:`init_mamba2` makes, by key."""
    d = cfg.d_model
    d_in, H, N, conv_dim = mamba2_dims(cfg)
    shapes = {"in_proj": (d, 2 * d_in + 2 * N + H),
              "conv_w": (conv_dim, CONV_K), "conv_b": (conv_dim,),
              "A_log": (H,), "D": (H,), "dt_bias": (H,), "norm_w": (d_in,),
              "out_proj": (d_in, d)}
    return {k: (*lead, *s) for k, s in shapes.items()}


def init_mamba2(cfg, gen, lead=(), device=None):
    """One Mamba2 block's weights drawn from ``gen`` at the JAX package's
    scales (``init_mamba2``: A = -exp(A_log) = -1, D = 1, no dt bias);
    ``lead`` prepends stacking axes (layers)."""
    d = cfg.d_model
    d_in, H, N, conv_dim = mamba2_dims(cfg)
    pdt = dtype_of(cfg.param_dtype)

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=pdt, device=device)

    return {"in_proj": _normal((*lead, d, 2 * d_in + 2 * N + H), d ** -0.5,
                               pdt, gen, device),
            "conv_w": _normal((*lead, conv_dim, CONV_K), CONV_K ** -0.5, pdt,
                              gen, device),
            "conv_b": full((conv_dim,), 0.0),
            "A_log": full((H,), 0.0), "D": full((H,), 1.0),
            "dt_bias": full((H,), 0.0), "norm_w": full((d_in,), 1.0),
            "out_proj": _normal((*lead, d_in, d), d_in ** -0.5, pdt, gen,
                                device)}


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv of CONV_K taps. x: [B, S, C]; state: [B,
    CONV_K - 1, C] (the rows before x) or None (zeros).  Returns the
    output and the last CONV_K - 1 rows of (state, x)."""
    B, S, C = x.shape
    pad = x.new_zeros((B, CONV_K - 1, C)) if state is None else \
        state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B, S+K-1, C]
    out = sum(xp[:, i:i + S] * w[:, i].to(x.dtype) for i in range(CONV_K))
    return out + b.to(x.dtype), xp[:, -(CONV_K - 1):]


def _mamba_project(cfg, p, x):
    """z, x, B, C, dt of x's input projection (the JAX function's
    sharding hints are a no-op without a mesh and have no counterpart)."""
    d_in, H, N, _ = mamba2_dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def _gate_out(cfg, p, y, xh, z, dtype):
    """y + D xh in f32, cast to the activations' dtype, the gated RMSNorm
    and the output projection."""
    B, S = z.shape[:2]
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(B, S, -1).to(dtype)
    return layers.rmsnorm(y * F.silu(z), p["norm_w"]) @ \
        p["out_proj"].to(dtype)


def _ssd_scan(xdt, Bm, Cm, loga, Q: int):
    """The SSD chunked scan from a zero state, all in f32: xdt [B, S, H,
    P] (x times dt), Bm and Cm [B, S, N], loga [B, S, H] (<= 0), chunks
    of Q tokens.  Returns y [B, S, H, P] (C h_t, before D) and the final
    state h [B, H, P, N]."""
    B, S, H, P = xdt.shape
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    h = xdt.new_zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for c0 in range(0, S, Q):
        xdt_c = xdt[:, c0:c0 + Q]                                # [B,Q,H,P]
        b_c, c_c = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]            # [B,Q,N]
        lh = torch.cumsum(loga[:, c0:c0 + Q], dim=1).transpose(1, 2)
        # token s reaches token t >= s decayed by exp(l_t - l_s)  [B,H,Q,Q];
        # the exponent is masked, not the exp: exp(-inf) is JAX's 0, and the
        # gradient stays finite where exp(l_t - l_s) for t < s overflows
        Lmat = torch.exp(torch.where(mask, lh[..., :, None] - lh[..., None, :],
                                     -torch.inf))
        cb = torch.bmm(c_c, b_c.transpose(1, 2))                 # [B,Q,Q]
        y = torch.matmul(cb[:, None] * Lmat, xdt_c.transpose(1, 2))
        # the carried state's part, then the state at the chunk's end
        y = y + torch.einsum("bqn,bhpn->bhqp", c_c, h) * \
            torch.exp(lh)[..., None]
        decay_out = torch.exp(lh[..., -1:] - lh)                 # [B,H,Q]
        h = h * torch.exp(lh[..., -1])[..., None, None] + torch.einsum(
            "bshp,bsn->bhpn", xdt_c * decay_out.transpose(1, 2)[..., None],
            b_c)
        ys.append(y.transpose(1, 2))                             # [B,Q,H,P]
    return torch.cat(ys, dim=1), h


def mamba2_block(cfg, p, x, chunk: int | None = None):
    """Training and prefill forward from a zero state. x: [B, S, d] ->
    (y [B, S, d], carry): the carry is what decode continues from,
    ``{"h": f32 [B, H, P, N], "conv": the last CONV_K - 1 rows of the
    conv's input [B, min(S, CONV_K - 1), conv_dim]}`` (fewer rows when S
    is shorter, as the JAX package's prefill keeps them)."""
    chunk = chunk or cfg.ssm_chunk
    B, S, d = x.shape
    d_in, H, N, _ = mamba2_dims(cfg)
    P = cfg.ssm_head_dim
    Q = chunk_of(S, chunk, "mamba2_block")
    z, xc, Bm, Cm, dt = _mamba_project(cfg, p, x)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xc, Bm, Cm = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())           # [B, S, H]
    loga = -torch.exp(p["A_log"].float()) * dt                   # <= 0
    xh = xc.reshape(B, S, H, P).float()
    y, h = _ssd_scan(xh * dt[..., None], Bm.float(), Cm.float(), loga, Q)
    y = _gate_out(cfg, p, y, xh, z, x.dtype)
    return y, {"h": h, "conv": conv_in[:, -(CONV_K - 1):]}


def mamba2_init_state(cfg, batch, dtype=torch.float32, device=None):
    d_in, H, N, conv_dim = mamba2_dims(cfg)
    return {"h": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype,
                                device=device)}


def mamba2_step(cfg, p, x, state):
    """Single-token decode. x: [B, 1, d], state {"h", "conv"} -> (y [B, 1,
    d], the new state).  A conv state of fewer than CONV_K - 1 rows (after
    a prefill of 1 or 2 tokens) raises ``ValueError``, where the JAX
    package fails to reshape."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"mamba2_step takes one token, got {S}")
    if state["conv"].shape[1] != CONV_K - 1:
        raise ValueError(
            f"mamba2_step: a conv state of {state['conv'].shape[1]} rows, "
            f"want {CONV_K - 1} (the prefill was shorter than {CONV_K - 1} "
            "tokens; the JAX package fails here too)")
    d_in, H, N, _ = mamba2_dims(cfg)
    P = cfg.ssm_head_dim
    z, xc, Bm, Cm, dt = _mamba_project(cfg, p, x)
    conv_out, conv_state = _causal_conv(torch.cat([xc, Bm, Cm], dim=-1),
                                        p["conv_w"], p["conv_b"],
                                        state["conv"])
    xc, Bm, Cm = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]       # [B, H]
    a = torch.exp(-torch.exp(p["A_log"].float()) * dt)
    xh = xc.reshape(B, H, P).float()
    h = state["h"] * a[..., None, None] + \
        (xh * dt[..., None])[..., None] * Bm[:, 0].float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    return _gate_out(cfg, p, y[:, None], xh[:, None], z, x.dtype), \
        {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
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


def chunk_of(S: int, chunk: int = CHUNK, what: str = "rwkv6_timemix") -> int:
    """A scan's chunk for a length S: ``min(chunk, S)``, which must divide
    S (the JAX package asserts it; no padding rule is defined)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"{what}: a length of {S} tokens is not a "
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
