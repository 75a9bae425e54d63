"""Transformer building blocks of the dense family: RMSNorm and
LayerNorm, RoPE, GQA attention with a KV cache (optional q/k/v and output
biases), the SwiGLU and GELU MLPs.

The port of the JAX package's ``repro/models/layers.py``.  Attention and
RMSNorm run one hand-written CUDA kernel each on the card
(:func:`~repro_torch.kernels.flash_attention.flash_attention_cuda`,
:func:`~repro_torch.kernels.rmsnorm.rmsnorm_cuda` with the model's
rounding) and their plain PyTorch versions on the CPU; when a gradient is
wanted (training), each goes through its ``torch.autograd.Function``,
whose backward is hand-written kernels too.  LayerNorm and GELU are
plain PyTorch, as the JAX package has no Pallas kernel for them (a hand
kernel is a later speed item).  The matrix products stay
``torch.matmul``, as the JAX package leaves them to XLA.

Numerics follow the JAX layers: every matrix product casts its weight to
the activations' dtype (``x @ w.to(x.dtype)``; a weight already held in
that dtype, see :func:`repro_torch.models.transformer.cast_params`, casts
to itself), RoPE computes cos/sin in f32 and casts them to x's dtype, the
KV cache is kept in the compute dtype.  Layer parameters are dicts of
tensors with the JAX package's keys.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

UNSUPPORTED = "ROADMAP Queue A 11b"   # the rest of the LM stack


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({UNSUPPORTED}); the port serves and "
        "trains the dense family with RMSNorm or LayerNorm and SwiGLU or "
        "GELU (internlm2-1.8b, stablelm-1.6b, starcoder2-7b, "
        "command-r-plus-104b), MoE (llama4-scout-17b-a16e, "
        "kimi-k2-1t-a32b), RWKV6 (rwkv6-1.6b) and the Mamba2 hybrid "
        "(zamba2-7b)")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ('float32', 'bfloat16')."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def rmsnorm(x, w, eps=1e-5):
    """``(x32 * rsqrt(mean(x32²) + eps)).astype(x.dtype) * w.astype(x.dtype)``
    (the model's rounding), through the RMSNorm kernel on the card; when a
    gradient is wanted, through :class:`~repro_torch.kernels.rmsnorm.
    RMSNormFn` (the backward kernels)."""
    x = x.contiguous()
    if _needs_grad(x, w):
        return rn.RMSNormFn.apply(x, w, eps)
    return rn.rmsnorm_cuda(x, w, eps, model=True)


def layernorm(x, w, b, eps=1e-5):
    """``((x32 - mean) * rsqrt(var + eps)).astype(x.dtype) * w.astype(
    x.dtype) + b.astype(x.dtype)`` (the biased variance, in f32), step for
    step as the JAX package rounds it: the affine part in x's dtype, not
    in f32 as ``F.layer_norm`` applies it.  ``b`` None adds no bias."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)
    return y + b.to(x.dtype) if b is not None else y


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p.get("b"))
    raise unsupported(f"norm={cfg.norm!r}")


def init_norm(cfg, d, lead=(), device=None):
    """Norm weights (ones; LayerNorm's bias ``b`` zeros); ``lead``
    prepends stacking axes (layers)."""
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise unsupported(f"norm={cfg.norm!r}")
    pdt = dtype_of(cfg.param_dtype)
    p = {"w": torch.ones((*lead, d), dtype=pdt, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((*lead, d), dtype=pdt, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x, pos, theta: float):
    """x: [B, S, H, hd], pos: [B, S] int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len: int | None = None):
    """Online-softmax GQA attention through the kernel.

    q: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd] with H % Hkv == 0.
    q_offset: absolute position of q[0] (decode: cache length so far).
    kv_len:   number of valid cache entries; None means all Skv.  A
              ``kv_len`` past Skv (a wave decoding past its cache) sees
              all Skv entries.
    Returns [B, Sq, H, hd] in q.dtype; accumulation in f32.  The JAX
    function's ``q_block``/``kv_block`` have no counterpart: the kernel
    chooses its own tiles.  When a gradient is wanted (training: q_offset
    0, every key valid), through :class:`~repro_torch.kernels.
    flash_attention.FlashAttentionFn` (the backward kernels)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        fa._training_case(k, q_offset, kv_len, "attention with a gradient")
        return fa.FlashAttentionFn.apply(q, k, v, causal)
    return fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)


def naive_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Reference (materializes full scores) — oracle for tests."""
    return fa.attention(q, k, v, causal=causal, q_offset=q_offset,
                        kv_len=kv_len)


def init_attn(cfg, gen, lead=(), device=None):
    """Attention weights drawn from ``gen`` (a torch.Generator on
    ``device``) at the JAX package's scales; ``lead`` prepends stacking
    axes (layers)."""
    d = cfg.d_model
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    pdt = dtype_of(cfg.param_dtype)
    if not cfg.fused_qkv:
        raise unsupported("fused_qkv=False")
    n_qkv = (H + 2 * Hkv) * hd
    p = {"wqkv": _normal((*lead, d, n_qkv), d ** -0.5, pdt, gen, device)}
    if cfg.qkv_bias:
        p["bqkv"] = torch.zeros((*lead, n_qkv), dtype=pdt, device=device)
    p["wo"] = _normal((*lead, H * hd, d), (H * hd) ** -0.5, pdt, gen, device)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((*lead, d), dtype=pdt, device=device)
    return p


def _normal(shape, std, dtype, gen, device):
    """Normal(0, std²) draws from ``gen``, made in f32 and cast.  A tensor
    of another dtype than f32 with more than two axes is drawn one
    trailing matrix at a time, so that no f32 copy of the whole tensor
    lives beside it (kimi-k2's bf16 experts: 22.5 GB of f32 a stack)."""
    if dtype == torch.float32 or len(shape) <= 2:
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for m in out.view(-1, *shape[-2:]):
        m.copy_(torch.randn(shape[-2:], generator=gen, device=device,
                            dtype=torch.float32).mul_(std))
    return out


def qkv_proj(cfg, p, x):
    B, S, _ = x.shape
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = x @ p["wqkv"].to(x.dtype)
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].to(x.dtype)
    q, k, v = torch.split(qkv, [H * hd, Hkv * hd, Hkv * hd], dim=-1)
    return (q.reshape(B, S, H, hd), k.reshape(B, S, Hkv, hd),
            v.reshape(B, S, Hkv, hd))


@dataclasses.dataclass
class KVCache:
    """One layer's decode cache: k, v [B, S_max, Hkv, hd] in the compute
    dtype and the number of valid entries (a host int: the cache is
    wave-synchronous).  :func:`attn_block` writes the new entries into
    ``k``/``v`` in place, where the JAX package returns new arrays."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def write_index(length: int, S: int, max_len: int) -> int:
    """Where S new entries go in a cache of max_len: at ``length``, as
    ``lax.dynamic_update_slice`` places them — clamped to [0, max_len -
    S], so a wave decoding past its cache overwrites its last entry."""
    if S > max_len:
        raise ValueError(f"{S} new entries do not fit a cache of {max_len}")
    return min(max(length, 0), max_len - S)


def attn_block(cfg, p, x, pos, *, causal=True, cache: KVCache | None = None):
    """Self-attention with optional decode cache.

    cache: decode mode — write k/v at cache.length (clamped as
    :func:`write_index` says), attend over the whole cache with
    q_offset = cache.length and kv_len = cache.length + S."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(cfg, p, x)
    if cfg.rope:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if cache is not None:
        at = write_index(cache.length, S, cache.k.shape[1])
        cache.k[:, at:at + S] = k.to(cache.k.dtype)
        cache.v[:, at:at + S] = v.to(cache.v.dtype)
        new_len = cache.length + S
        o = flash_attention(q, cache.k, cache.v, causal=causal,
                            q_offset=cache.length, kv_len=new_len)
        new_cache = KVCache(cache.k, cache.v, new_len)
    else:
        o = flash_attention(q, k, v, causal=causal)
        new_cache = None
    o = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    if "bo" in p:
        o = o + p["bo"].to(x.dtype)
    return o, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg, gen, lead=(), device=None, d=None, ff=None):
    """SwiGLU (w1, w3, w2) or GELU (fc1, b1, fc2, b2; biases zero)
    weights drawn from ``gen`` at the JAX package's scales; ``lead``
    prepends stacking axes (layers); ``d`` and ``ff`` default to the
    config's ``d_model`` and ``d_ff`` (the MoE shared expert is
    ``ff=moe_d_ff``)."""
    d, ff = d or cfg.d_model, ff or cfg.d_ff
    pdt = dtype_of(cfg.param_dtype)
    if cfg.act == "swiglu":
        return {"w1": _normal((*lead, d, ff), d ** -0.5, pdt, gen, device),
                "w3": _normal((*lead, d, ff), d ** -0.5, pdt, gen, device),
                "w2": _normal((*lead, ff, d), ff ** -0.5, pdt, gen, device)}
    if cfg.act == "gelu":
        return {"fc1": _normal((*lead, d, ff), d ** -0.5, pdt, gen, device),
                "b1": torch.zeros((*lead, ff), dtype=pdt, device=device),
                "fc2": _normal((*lead, ff, d), ff ** -0.5, pdt, gen, device),
                "b2": torch.zeros((*lead, d), dtype=pdt, device=device)}
    raise unsupported(f"act={cfg.act!r}")


def mlp_shapes(cfg, lead=(), d=None, ff=None) -> dict:
    """The shapes of :func:`init_mlp`'s tree."""
    d, ff = d or cfg.d_model, ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"w1": (*lead, d, ff), "w3": (*lead, d, ff),
                "w2": (*lead, ff, d)}
    return {"fc1": (*lead, d, ff), "b1": (*lead, ff), "fc2": (*lead, ff, d),
            "b2": (*lead, d)}


def mlp_block(cfg, p, x):
    """SwiGLU, or ``gelu(x @ fc1 + b1) @ fc2 + b2`` with GELU's tanh
    form (``jax.nn.gelu``'s default, not torch's erf one)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
        return h @ p["w2"].to(x.dtype)
    if cfg.act == "gelu":
        h = F.gelu(x @ p["fc1"].to(x.dtype) + p["b1"].to(x.dtype),
                   approximate="tanh")
        return h @ p["fc2"].to(x.dtype) + p["b2"].to(x.dtype)
    raise unsupported(f"act={cfg.act!r}")

