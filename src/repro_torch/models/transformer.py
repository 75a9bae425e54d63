"""The LM of the dense, MoE, RWKV6 and Mamba2-hybrid families: its
training loss and its serving steps (prefill and decode).

The port of the dense, MoE, RWKV and hybrid branches of the JAX package's
``repro/models/transformer.py``: an embedding, pre-norm layers, a final
norm and an unembedding.  A dense layer is RMSNorm or LayerNorm, GQA
attention with RoPE (and q/k/v and output biases where the config has
them), a SwiGLU or GELU MLP; an MoE layer has the MoE block
(:mod:`repro_torch.models.moe`) in the MLP's place, and returns its aux
loss; an RWKV6 layer is LayerNorm, the time-mix, LayerNorm, the
channel-mix (:mod:`repro_torch.models.ssm`), and its decode state is the
time-mix's f32 state and the two shifted tokens.  The hybrid (zamba2)
is a stack of Mamba2 layers (RMSNorm, then the block of
:mod:`repro_torch.models.ssm`, residual) with ONE weight-shared dense
layer (``shared``, not stacked) after every ``attn_every``-th: each of
its sites has a KV cache of its own, and its gradient is the sum over
the sites; the decode state is each Mamba layer's f32 ``h`` and conv
tail beside the sites' caches.  Parameters are nested
dicts of tensors with the JAX package's keys; the layers' weights are
stacked along a leading axis, as the JAX package stacks them for
``lax.scan`` (an MoE model: its ``n_dense_layers`` leading dense layers
under ``dense_layers`` [nd], its MoE layers under ``layers`` [L - nd]),
and walked in a Python loop (each layer a view, no copy), the dense stack
first.  The weights are held at the config's ``param_dtype``.

Training (:func:`forward`, :func:`loss_fn`) keeps the parameters at
their own dtype (f32) and casts each weight to the compute dtype at its
product, as the JAX package does; the layers' stacked weights are split
into per-layer views once a forward (``unbind``, whose gradient stacks the
layers' gradients once), and with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).
Serving casts them once (:func:`cast_params`).

The dense family (internlm2-1.8b, stablelm-1.6b, starcoder2-7b,
command-r-plus-104b), MoE (llama4-scout-17b-a16e, kimi-k2-1t-a32b), RWKV6
(rwkv6-1.6b) and the Mamba2 hybrid (zamba2-7b) run here.  A config
outside them (the encoder-decoder, frontends, ``fused_qkv=False``) raises
``NotImplementedError`` naming the ROADMAP item; it never runs through a
different path.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.core.engine import resolve_device
from repro_torch.models import moe, ssm
from repro_torch.models.layers import (KVCache, apply_norm, attn_block,
                                       dtype_of, init_attn, init_mlp,
                                       init_norm, mlp_block, mlp_shapes,
                                       unsupported)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config outside the dense
    family (RMSNorm or LayerNorm, SwiGLU or GELU), MoE, RWKV6 and the
    Mamba2 hybrid."""
    for bad, what in ((cfg.enc_dec, "the encoder-decoder"),
                      (cfg.frontend != "none", f"frontend={cfg.frontend!r}"),
                      (cfg.norm not in ("rmsnorm", "layernorm"),
                       f"norm={cfg.norm!r}"),
                      (not cfg.rwkv and cfg.act not in ("swiglu", "gelu"),
                       f"act={cfg.act!r}"),
                      (not cfg.rwkv and not cfg.fused_qkv,
                       "fused_qkv=False")):
        if bad:
            raise unsupported(f"{cfg.name}: {what}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters at the JAX package's scales (``init_params``),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    This is not JAX's random stream: the same seed gives other numbers
    than ``repro.models.transformer.init_params``.  To hold the port
    against the JAX package, carry the JAX parameters across with
    :func:`repro_torch.convert.lm_params_from_numpy`."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    p = {"embed": torch.randn((V, d), generator=gen, device=dev)
         .mul_(0.02).to(pdt)}
    if not cfg.tie_embeddings:
        p["head"] = torch.randn((d, V), generator=gen, device=dev) \
            .mul_(d ** -0.5).to(pdt)
    p["final_norm"] = init_norm(cfg, d, device=dev)
    if cfg.rwkv:
        p["layers"] = {"ln1": init_norm(cfg, d, (L,), dev),
                       "tm": ssm.init_rwkv6(cfg, gen, (L,), dev),
                       "ln2": init_norm(cfg, d, (L,), dev)}
        return p

    def stack(n, ffn, init_ffn):
        lead = () if n is None else (n,)
        return {"ln1": init_norm(cfg, d, lead, dev),
                "attn": init_attn(cfg, gen, lead, dev),
                "ln2": init_norm(cfg, d, lead, dev),
                ffn: init_ffn(cfg, gen, lead, dev)}
    if cfg.family == "hybrid":
        p["layers"] = {"ln": init_norm(cfg, d, (L,), dev),
                       "mamba": ssm.init_mamba2(cfg, gen, (L,), dev)}
        p["shared"] = stack(None, "mlp", init_mlp)     # ONE shared layer
        return p
    if cfg.n_experts:
        nd = cfg.n_dense_layers
        if nd:
            p["dense_layers"] = stack(nd, "mlp", init_mlp)
        p["layers"] = stack(L - nd, "moe", moe.init_moe)
        return p
    p["layers"] = stack(L, "mlp", init_mlp)
    return p


def param_shapes(cfg) -> dict:
    """The parameter tree's structure: the shape of every tensor that
    :func:`init_params` makes (and the JAX package's ``init_params``
    makes for the same config), by the same keys."""
    check_supported(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def norm(*lead):
        if cfg.norm == "layernorm":
            return {"w": (*lead, d), "b": (*lead, d)}
        return {"w": (*lead, d)}

    p = {"embed": (V, d), "final_norm": norm()}
    if not cfg.tie_embeddings:
        p["head"] = (d, V)
    if cfg.rwkv:
        p["layers"] = {"ln1": norm(L), "tm": ssm.rwkv6_shapes(cfg, (L,)),
                       "ln2": norm(L)}
        return p

    def stack(n, moe_ffn=False):
        lead = () if n is None else (n,)
        attn = {"wqkv": (*lead, d, (H + 2 * Hkv) * hd),
                "wo": (*lead, H * hd, d)}
        if cfg.qkv_bias:
            attn["bqkv"] = (*lead, (H + 2 * Hkv) * hd)
        if cfg.attn_out_bias:
            attn["bo"] = (*lead, d)
        ffn = {"moe": moe.moe_shapes(cfg, lead)} if moe_ffn else \
            {"mlp": mlp_shapes(cfg, lead)}
        return {"ln1": norm(*lead), "attn": attn, "ln2": norm(*lead), **ffn}
    if cfg.family == "hybrid":
        p["layers"] = {"ln": norm(L), "mamba": ssm.mamba2_shapes(cfg, (L,))}
        p["shared"] = stack(None)
        return p
    if cfg.n_experts:
        nd = cfg.n_dense_layers
        if nd:
            p["dense_layers"] = stack(nd)
        p["layers"] = stack(L - nd, moe_ffn=True)
        return p
    p["layers"] = stack(L)
    return p


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def cast_params(cfg, params):
    """The parameters with every matrix in the compute dtype: one cast
    copy per weight (the tensors themselves when they already have it).
    Numerically the same as the JAX package's cast at every matrix
    product (``x @ w.astype(x.dtype)``), paid once at load instead.  The
    norm weights stay as they are: the RMSNorm kernel reads them in f32
    and rounds them to the activations' dtype itself, LayerNorm casts its
    weight and bias at use.  RWKV6's decay (``w0``, ``wA``, ``wB``), bonus
    ``u`` and groupnorm ``ln_w`` stay too: the JAX package reads them in
    f32, so a rounding at load would change the decay and the bonus.  The
    MoE router stays at the parameters' dtype: the JAX package computes
    the router logits in f32 from it, so a rounding at load could change
    which experts are chosen.  Mamba2's ``A_log``, ``D``, ``dt_bias``
    (read in f32) and its gated norm's ``norm_w`` stay too."""
    cdt = dtype_of(cfg.compute_dtype)
    keep = {("final_norm",), ("layers", "ln1"), ("layers", "ln2"),
            ("dense_layers", "ln1"), ("dense_layers", "ln2"),
            ("layers", "moe", "router"), ("layers", "ln"), ("shared", "ln1"),
            ("shared", "ln2")}
    if cfg.rwkv:
        keep |= {("layers", "tm", k) for k in ssm.F32_LEAVES}
    if cfg.family == "hybrid":
        keep |= {("layers", "mamba", k) for k in ssm.MAMBA_F32_LEAVES}

    def cast(t, path):
        if path in keep:
            return t
        if isinstance(t, dict):
            return {k: cast(v, (*path, k)) for k, v in t.items()}
        return t.to(cdt)
    return cast(params, ())


def _stack_len(stack) -> int:
    return pytree.leaves(stack)[0].shape[0]


def layer(params, i: int):
    """Layer ``i``'s parameters (counted over the whole model: an MoE
    model's dense layers first): views into the stacked tensors."""
    if "dense_layers" in params:
        nd = _stack_len(params["dense_layers"])
        if i < nd:
            return pytree.tree_map(lambda t: t[i], params["dense_layers"])
        i -= nd
    return pytree.tree_map(lambda t: t[i], params["layers"])


# ---------------------------------------------------------------------------
# embedding, layer body, unembedding
# ---------------------------------------------------------------------------
def vocab_rows(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The embedding rows that jnp indexing reads for token ids: a
    negative id is folded once (``t + V``), then every id is clamped to
    ``[0, V - 1]`` (so ``-5`` reads row ``V - 5``, ``-V - 1`` row 0 and
    ``V + 3`` row ``V - 1``), where torch indexing would raise."""
    t = tokens.long()
    return torch.where(t < 0, t + vocab, t).clamp_(0, vocab - 1)


def embed_inputs(cfg, params, batch):
    """``embed[tokens].astype(compute_dtype)``; batch["tokens"] [B, S].
    Ids outside ``[0, V)`` read the rows the JAX package's gather reads
    (:func:`vocab_rows`)."""
    if cfg.frontend != "none":
        raise unsupported(f"frontend={cfg.frontend!r}")
    embed = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=embed.device)
    return embed[vocab_rows(tokens, embed.shape[0])].to(
        dtype_of(cfg.compute_dtype))


def _dense_body(cfg, lp, x, pos, cache=None, causal=True):
    a, new_cache = attn_block(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                              pos, causal=causal, cache=cache)
    x = x + a
    x = x + mlp_block(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    return x, new_cache


def _moe_body(cfg, lp, x, pos, cache=None):
    """One MoE layer; returns x, the layer's aux loss and its cache."""
    a, new_cache = attn_block(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                              pos, causal=True, cache=cache)
    x = x + a
    y, aux = moe.moe_block(cfg, lp["moe"], apply_norm(cfg, lp["ln2"], x))
    return x + y, aux, new_cache


def _mamba_body(cfg, lp, x):
    """One Mamba2 layer from a zero state; returns x and the layer's
    carry (``h``, ``conv``) for decode."""
    y, carry = ssm.mamba2_block(cfg, lp["mamba"], apply_norm(cfg, lp["ln"], x))
    return x + y, carry


def _rwkv_body(cfg, lp, x, state=None):
    """One RWKV6 layer; returns x and the layer's new state (``S``,
    ``x_tm``: the last token of the time-mix's normed input, ``x_cm``)."""
    y, st_tm = ssm.rwkv6_timemix(cfg, lp["tm"],
                                 apply_norm(cfg, lp["ln1"], x), state=state)
    x = x + y
    y, st_cm = ssm.rwkv6_channelmix(cfg, lp["tm"],
                                    apply_norm(cfg, lp["ln2"], x),
                                    state=state)
    x = x + y
    return x, {**st_tm, **st_cm}


def unembed(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# forward (training) and the chunked-vocab loss
# ---------------------------------------------------------------------------
def unstacked_layers(params) -> list[dict]:
    """Each layer's parameters (an MoE model's dense layers first) as views
    of the stacked tensors, made by one ``unbind`` per tensor (its
    gradient is one stack of the layers')."""
    out = []
    for key in ("dense_layers", "layers"):
        if key not in params:
            continue
        flat, treedef = pytree.flatten(params[key])
        cols = [t.unbind(0) for t in flat]
        out += [pytree.unflatten(treedef, [c[i] for c in cols])
                for i in range(len(cols[0]))]
    return out


def forward(cfg, params, batch):
    """Full forward -> (final hidden states [B, S, d] after the final norm,
    aux loss): the dense, MoE, RWKV and hybrid branches of the JAX
    package's ``forward``; the aux loss is the sum of the MoE layers' (f32,
    0 without them).  batch["tokens"] [B, S]; positions ``arange(S)``,
    causal, no cache (RWKV, Mamba2: zero state).  The hybrid runs Mamba
    layer i, then the shared layer where ``(i + 1) % attn_every == 0``;
    with ``cfg.remat`` each of them is a unit of its own."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)

    def body(x, lp):
        if cfg.rwkv:
            return _rwkv_body(cfg, lp, x)[0], None
        if "mamba" in lp:
            return _mamba_body(cfg, lp, x)[0], None
        if "moe" in lp:
            x, a, _ = _moe_body(cfg, lp, x, pos)
            return x, a
        return _dense_body(cfg, lp, x, pos)[0], None

    def unit(x, lp):
        if cfg.remat:
            return checkpoint(body, x, lp, use_reentrant=False,
                              preserve_rng_state=False)
        return body(x, lp)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(unstacked_layers(params)):
        x, a = unit(x, lp)
        if a is not None:
            aux = aux + a
        if "shared" in params and (i + 1) % cfg.attn_every == 0:
            x, _ = unit(x, params["shared"])
    return apply_norm(cfg, params["final_norm"], x), aux


def loss_fn(cfg, params, batch):
    """Causal LM loss; batch["labels"] are next-token ids, -1 masked; an
    MoE model adds ``0.01 * aux``.
    Returns (loss, {"nll", "tokens", "aux"}) as the JAX package does: the
    cross-entropy is taken ``cfg.loss_chunk`` positions at a time (f32
    logits of one chunk at a time), its sum and count added chunk by
    chunk.  A label at or past the vocabulary takes a NaN target logit
    (JAX's ``take_along_axis`` fills out-of-range picks with NaN), so the
    loss is NaN; the gather itself never indexes past the row."""
    h, aux = forward(cfg, params, batch)
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    B, S, d = h.shape
    ck = min(cfg.loss_chunk, S)
    if S % ck:
        raise ValueError(f"seq {S} is not a multiple of loss_chunk {ck}")
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    w = w.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, ck):
        ls = labels[:, c0:c0 + ck]
        logits = (h[:, c0:c0 + ck] @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        V = logits.shape[-1]
        tgt = logits.gather(-1, ls.clamp(0, V - 1)[..., None])[..., 0]
        tgt = torch.where(ls >= V, float("nan"), tgt)
        mask = (ls >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
    loss = tot / torch.clamp(cnt, min=1.0)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss, {"nll": tot, "tokens": cnt, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Decode state (preallocated, compute dtype): k, v [n_layers, B,
    max_len, Hkv, hd] and the wave's valid length ``len`` (a host int);
    for RWKV6 the time-mix state ``S`` (f32 [n_layers, B, H, P, P]) and
    the shifted tokens ``x_tm``, ``x_cm`` [n_layers, B, 1, d], whatever
    ``max_len``; for the hybrid each Mamba layer's ``h`` (f32 [n_layers,
    B, H, P, N]) and ``conv`` tail [n_layers, B, CONV_K - 1, conv_dim],
    and ``attn``: k, v [n_sites, B, max_len, Hkv, hd] and ``len`` of the
    shared layer's sites."""
    cdt = dtype_of(cfg.compute_dtype)
    L = cfg.n_layers
    if cfg.family == "hybrid":
        d_in, H, N, conv_dim = ssm.mamba2_dims(cfg)
        kv = (L // cfg.attn_every, batch, max_len, cfg.n_kv_heads,
              cfg.head_dim)
        return {"h": torch.zeros((L, batch, H, cfg.ssm_head_dim, N),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((L, batch, ssm.CONV_K - 1, conv_dim),
                                    dtype=cdt, device=device),
                "attn": {"k": torch.zeros(kv, dtype=cdt, device=device),
                         "v": torch.zeros(kv, dtype=cdt, device=device),
                         "len": 0}}
    if cfg.rwkv:
        d, H, P = ssm.rwkv6_dims(cfg)
        return {"S": torch.zeros((L, batch, H, P, P), dtype=torch.float32,
                                 device=device),
                "x_tm": torch.zeros((L, batch, 1, d), dtype=cdt,
                                    device=device),
                "x_cm": torch.zeros((L, batch, 1, d), dtype=cdt,
                                    device=device)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device), "len": 0}


def _hybrid_layers(cfg, params, x, pos, cache, decode):
    """The hybrid's layers over x: Mamba layer i (its block from a zero
    state in a prefill, its step from the cached state in a decode step),
    then where ``(i + 1) % attn_every == 0`` the shared layer on its site's
    cache; every state written in place.  A prefill of S < CONV_K - 1
    tokens leaves conv tails of S rows, as the JAX package's does."""
    kv, shared = cache["attn"], params["shared"]
    S = x.shape[1]
    if not decode and S < ssm.CONV_K - 1:
        cache["conv"] = cache["conv"][:, :, :S].clone()
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        if decode:
            y, st = ssm.mamba2_step(cfg, lp["mamba"],
                                    apply_norm(cfg, lp["ln"], x),
                                    {"h": cache["h"][i],
                                     "conv": cache["conv"][i]})
            x = x + y
        else:
            x, st = _mamba_body(cfg, lp, x)
        cache["h"][i].copy_(st["h"])
        cache["conv"][i].copy_(st["conv"])
        if (i + 1) % cfg.attn_every == 0:
            site = (i + 1) // cfg.attn_every - 1
            x, _ = _dense_body(cfg, shared, x, pos, cache=KVCache(
                kv["k"][site], kv["v"][site], kv["len"]))
    return x


def _layers(cfg, params, x, pos, cache, decode=False):
    """Every layer over x with its cache entries (written in place; an MoE
    model's dense layers on ``cache[:nd]``, its MoE layers on
    ``cache[nd:]``); returns x.  ``decode``: x is one decode step's token
    (the hybrid's Mamba layers step from their state)."""
    if cfg.family == "hybrid":
        return _hybrid_layers(cfg, params, x, pos, cache, decode)
    if cfg.rwkv:
        for i in range(cfg.n_layers):
            x, st = _rwkv_body(cfg, layer(params, i), x, state={
                k: cache[k][i] for k in ("S", "x_tm", "x_cm")})
            for k in ("S", "x_tm", "x_cm"):
                cache[k][i].copy_(st[k])
        return x
    ln = cache["len"]
    for i in range(cfg.n_layers):
        c = KVCache(cache["k"][i], cache["v"][i], ln)
        lp = layer(params, i)
        if "moe" in lp:
            x, _, _ = _moe_body(cfg, lp, x, pos, cache=c)
        else:
            x, _ = _dense_body(cfg, lp, x, pos, cache=c)
    return x


def _logits(cfg, params, x):
    h = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, h)[:, 0].float()


def prefill(cfg, params, batch, max_len: int):
    """Process the prompt batch["tokens"] [B, S]; return (last-token
    logits [B, V] f32, cache).  Positions are ``arange(S)`` for every
    row; no padding mask (left padding is attended, as in the JAX
    package).  RWKV6 runs from a zero state (S must be a multiple of the
    time-mix's chunk, or below it) and ignores ``max_len``; the hybrid's
    Mamba layers too (S a multiple of ``min(ssm_chunk, S)``, else
    ``ValueError``)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len, x.device)
    pos = None if cfg.rwkv else torch.arange(S, device=x.device).expand(B, S)
    x = _layers(cfg, params, x, pos, cache)
    if not cfg.rwkv:
        _kv(cfg, cache)["len"] = S
    return _logits(cfg, params, x[:, -1:]), cache


def _kv(cfg, cache) -> dict:
    """The part of the cache that holds k, v and ``len``."""
    return cache["attn"] if cfg.family == "hybrid" else cache


def decode_step(cfg, params, tokens, cache):
    """One decode step. tokens: [B, 1] -> (logits [B, V], cache).  The
    cache (the RWKV6 state, the hybrid's Mamba states) is updated in place
    and returned.  A hybrid's cache from a prefill of fewer than
    ``CONV_K - 1`` tokens raises ``ValueError`` (the JAX package fails
    there too)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, {"tokens": tokens})
    if cfg.rwkv:
        return _logits(cfg, params, _layers(cfg, params, x, None, cache)), \
            cache
    B = x.shape[0]
    kv = _kv(cfg, cache)
    pos = torch.full((B, 1), kv["len"], device=x.device)
    x = _layers(cfg, params, x, pos, cache, decode=True)
    kv["len"] += 1
    return _logits(cfg, params, x), cache
