"""GQA flash attention: the hand-written CUDA kernels and their plain
PyTorch versions.

The counterpart of the JAX package's ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``), generalised as the model's jnp
attention (``repro/models/layers.py:72``) is: q [B, Sq, H, hd] at
positions ``q_offset + i`` attends to k/v [B, Skv, Hkv, hd] (G = H / Hkv
query heads per kv head), key j visible iff ``j < min(kv_len, Skv)`` and,
causal, ``j <= q_offset + i``.  Scores ``(q · hd^-½) · k`` and the
softmax are f32; the output has q's dtype; a row that sees no key is 0.
The Pallas kernel is the case ``q_offset = 0``, ``kv_len = Skv``.

:func:`flash_attention_cuda` launches one of three kernels of
``csrc/flash_attention.cu`` on CUDA tensors (built at first use, see
:mod:`repro_torch.kernels._build`), chosen by dtype and shape alone:

* ``G * Sq <= SPLIT_ROWS`` (decode: a few queries per kv head), either
  dtype: ``decode_split`` — the visible keys are cut into the ranges of
  :func:`decode_splits`, one CTA per (range, kv head, batch row) writes
  f32 partials ``(m, l, acc)`` of its ``G * Sq`` rows into a workspace —
  then ``decode_combine`` merges the partials into the output;
* otherwise bf16: ``prefill_mma`` — the tensor cores (``wgmma``);
* otherwise f32: ``tiled_f32`` — the CUDA cores.

The forward kernels take the head dims :data:`FWD_HEAD_DIMS`; at hd 112
(kimi-k2, zamba2-7b) ``prefill_mma`` runs the hd 128 tiles and products
with dims 112-127 zero-filled and stores 112, the others have
instantiations of their own.  The backward kernels take
:data:`BWD_HEAD_DIMS`, hd 112 too: ``dq_mma`` and ``dkdv_mma`` on the
zero-filled hd 128 tiles, ``dq_f32`` and ``dkdv_f32`` with an
instantiation of their own.

Each launch counts one in ``flash_attention_cuda.launches_by[variant]``
and in the total ``flash_attention_cuda.launches``.  CPU tensors take the
plain version :func:`attention` and nothing else.  :func:`attention_partials`
and :func:`combine_partials` are the plain versions of the split and the
combine kernels; nothing on the main path calls them.  The kernels choose
their own tiles and, in bf16, round the probabilities to bf16 before the
P·V product: they agree with the plain version within float tolerance,
not bit for bit.

Training (q_offset 0, every key valid) goes through
:class:`FlashAttentionFn`: its forward asks the prefill kernel for each
row's log-sum-exp (``with_lse``), its backward,
:func:`flash_attention_backward_cuda`, launches two backward kernels
chosen by dtype alone (:func:`bwd_variant_of`): the dQ kernel, which also
writes D = rowsum(dO∘O), then the dK/dV kernel — bf16 ``dq_mma`` +
``dkdv_mma`` on the tensor cores (``wgmma``; P and dS carried as two bf16
terms each), f32 ``dq_f32`` + ``dkdv_f32`` on the CUDA cores — counted in
``flash_attention_backward_cuda.launches_by``.  Their plain version is
:func:`attention_backward`; :func:`attention_backward_tiles` replays
either route's walk over the tiles (``bf16_products`` for the tensor-core
one).  Gradients are held against the plain version by
:func:`grad_error_ratio`.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.rmsnorm import DTYPE_CODES

# head dims the kernels are built for, forward and backward (on the
# tensor cores hd 112 runs the hd 128 layout with the last 16 dims zero;
# the split and CUDA-core kernels have their own instantiation)
FWD_HEAD_DIMS = (16, 32, 64, 112, 128)
BWD_HEAD_DIMS = (16, 32, 64, 112, 128)
MAX_GROUP = 64                    # query heads per kv head they take
PLAIN_Q_CHUNK = 1024              # query rows per step of the plain version
SPLIT_ROWS = 16                   # G * Sq up to which decode splits the keys
SPLIT_ALIGN = 64                  # keys: a split range starts at a multiple
SPLIT_CTAS_PER_SM = 4             # split CTAs in flight the planner aims at
H100_SMS = 132                    # SMs decode_splits plans for by default
VARIANTS = ("prefill_mma", "tiled_f32", "decode_split", "decode_combine")
# the backward's kernels by route, each pair in launch order: bf16 on the
# tensor cores, f32 on the CUDA cores
BWD_VARIANTS = ("dq_mma", "dkdv_mma", "dq_f32", "dkdv_f32")
BWD_ENTRY = {"dq_mma": "flash_attention_bwd_dq_wgmma_launch",
             "dkdv_mma": "flash_attention_bwd_dkdv_wgmma_launch",
             "dq_f32": "flash_attention_bwd_dq_launch",
             "dkdv_f32": "flash_attention_bwd_dkdv_launch"}


def _valid(Skv: int, kv_len) -> int:
    return Skv if kv_len is None else max(0, min(int(kv_len), Skv))


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None, with_lse: bool = False):
    """The plain PyTorch version (same semantics as the kernels).  With
    ``with_lse``, returns (out, lse): lse [B, H, Sq] f32 is each row's
    log-sum-exp of its scaled scores over the keys it sees (-inf for a row
    that sees none)."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    valid = _valid(Skv, kv_len)
    scale = 1.0 / math.sqrt(hd)
    k32 = k.float().permute(0, 2, 3, 1)              # [B, Hkv, hd, Skv]
    v32 = v.float().permute(0, 2, 1, 3)              # [B, Hkv, Skv, hd]
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for s0 in range(0, Sq, PLAIN_Q_CHUNK):
        s1 = min(Sq, s0 + PLAIN_Q_CHUNK)
        qc = q[:, s0:s1].float().reshape(B, s1 - s0, Hkv, G, hd)
        qc = qc.permute(0, 2, 3, 1, 4) * scale        # [B, Hkv, G, n, hd]
        s = torch.matmul(qc, k32[:, :, None])         # [B, Hkv, G, n, Skv]
        mask = (kpos < valid)[None, :]
        if causal:
            qpos = q_offset + torch.arange(s0, s1, device=q.device)
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        if with_lse:
            lse[:, :, s0:s1] = torch.logsumexp(s, dim=-1).reshape(
                B, H, s1 - s0)
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # no visible key: 0
        o = torch.matmul(p, v32[:, :, None])          # [B, Hkv, G, n, hd]
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, s1 - s0, H, hd).to(q.dtype)
    return (out, lse) if with_lse else out


# ---------------------------------------------------------------------------
# the backward (training): its plain versions
# ---------------------------------------------------------------------------
BWD_TILE = 64                     # queries / keys of the backward kernels' tiles
BF16_TERMS = 2                    # bf16 terms of P and dS in the tensor-core route


def _bwd_tile(q, k, v, do, lse, D, b, rows, kvh, ka, ke, causal, scale):
    """One tile of query rows (``rows`` = (positions, heads), two index
    tensors) against one key tile [ka, ke) of kv head kvh: (P, dS) f32
    [rows, keys] with P = exp(S - lse) where the key is visible, else 0."""
    pos, heads = rows
    s = (q[b, pos, heads].float() * scale) @ k[b, ka:ke, kvh].float().T
    dp = do[b, pos, heads].float() @ v[b, ka:ke, kvh].float().T
    L = lse[b, heads, pos]
    ok = torch.isfinite(L)[:, None].expand_as(s)
    if causal:
        ok = ok & (torch.arange(ka, ke)[None, :] <= pos[:, None])
    p = torch.where(ok, torch.exp(s - torch.where(ok, L[:, None], 0.0)), 0.0)
    return p, p * (dp - D[b, heads, pos, None])


def bf16_terms(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """x (f32) as the sum of ``n`` bf16 terms, each the bf16 rounding of
    what the terms before it left over (``n = 1``: x rounded to bf16);
    returned in f32.  Two terms carry x to within 2^-16 relative."""
    out = torch.zeros_like(x)
    for _ in range(n):
        out += (x - out).bfloat16().float()
    return out


def _row_tiles(Sq, heads, per):
    """The query rows of ``heads`` in tiles of ``per`` positions, rows r =
    i * len(heads) + g (position-major, as the kernels pack a kv head's
    G heads): a list of (positions, heads) index pairs."""
    hs = torch.as_tensor(heads)
    return [(torch.arange(qa, min(Sq, qa + per)).repeat_interleave(len(hs)),
             hs.repeat(min(Sq, qa + per) - qa)) for qa in range(0, Sq, per)]


def attention_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """The plain version of the backward kernels: (dq, dk, dv) in q's
    dtype for out = attention(q, k, v, causal=causal) at q_offset 0 over
    every key, from its row log-sum-exp ``lse`` [B, H, Sq] and the output's
    gradient ``do``.  f32 inside: P = exp(S - lse), D = rowsum(do o o),
    dS = P o (dP - D), dQ = hd^-½ dS K, dK = hd^-½ dS^T Q, dV = P^T dO,
    each kv head summing over its G query heads.  A row that sees no key
    (lse = -inf) has P = 0."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    k32 = k.float().permute(0, 2, 1, 3)[:, :, None]   # [B, Hkv, 1, Skv, hd]
    v32 = v.float().permute(0, 2, 1, 3)[:, :, None]
    kpos = torch.arange(Skv, device=q.device)
    D = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # [B, H, Sq]
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, Hkv, Skv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = lambda x, s0, s1: x[:, s0:s1].float().reshape(
        B, s1 - s0, Hkv, G, hd).permute(0, 2, 3, 1, 4)   # [B, Hkv, G, n, hd]
    for s0 in range(0, Sq, PLAIN_Q_CHUNK):
        s1 = min(Sq, s0 + PLAIN_Q_CHUNK)
        qc, doc = rows(q, s0, s1) * scale, rows(do, s0, s1)
        L = lse[:, :, s0:s1].reshape(B, Hkv, G, s1 - s0, 1)
        Dc = D[:, :, s0:s1].reshape(B, Hkv, G, s1 - s0, 1)
        s = torch.matmul(qc, k32.transpose(-1, -2))   # [B, Hkv, G, n, Skv]
        mask = torch.isfinite(L)
        if causal:
            qpos = torch.arange(s0, s1, device=q.device)
            mask = mask & (kpos[None, :] <= qpos[:, None])
        p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(L), L,
                                                        0.0)), 0.0)
        dv += torch.matmul(p.transpose(-1, -2), doc).sum(2)
        ds = p * (torch.matmul(doc, v32.transpose(-1, -2)) - Dc)
        dq[:, s0:s1] = (torch.matmul(ds, k32) * scale).permute(
            0, 3, 1, 2, 4).reshape(B, s1 - s0, H, hd).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc).sum(2)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def attention_backward_tiles(q, k, v, o, lse, do, *, causal: bool = True,
                             tile: int = BWD_TILE,
                             bf16_products: bool = False,
                             terms: int = BF16_TERMS):
    """The backward kernels' walk, replayed tile by tile in plain PyTorch
    (for the tests, on small inputs): the dQ kernel's CTA per query tile
    over the key tiles its queries see, then the dK/dV kernel's CTA per
    (key tile, kv head) over each of its G heads' query tiles that see its
    keys (from the key tile's own under the causal mask), with D from the
    first pass.  f32 sums tile by tile in the kernels' order; returns (dq,
    dk, dv) in q's dtype, as :func:`attention_backward` does.

    ``bf16_products=False`` replays the f32 kernels (``dq_f32``,
    ``dkdv_f32``): a dQ tile is ``tile`` queries of one head, and dK sums
    dS^T (Q hd^-½), as the dK/dV kernel stages Q scaled.
    ``bf16_products=True`` replays the tensor-core kernels (``dq_mma``,
    ``dkdv_mma``): a dQ tile is ``tile`` rows r = i * G + g of one kv head
    (``tile // G`` queries of its G heads), dK sums dS^T Q and is scaled
    at the end, and P and dS enter the products that take them (P^T dO,
    dS K, dS^T Q) as ``terms`` bf16 terms each (:func:`bf16_terms`), as
    the kernels split them into their A operands (``BF16_TERMS``;
    ``terms=1``, which only ``scripts/attn_bwd_rounding.py`` asks for,
    rounds them once).  Both routes scale dQ at the end."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    rnd = functools.partial(bf16_terms, n=terms) if bf16_products \
        else (lambda x: x)
    q_scale, dk_scale = (1.0, scale) if bf16_products else (scale, 1.0)
    if bf16_products:
        dq_tiles = [(kvh, t) for kvh in range(Hkv) for t in reversed(
            _row_tiles(Sq, range(kvh * G, (kvh + 1) * G), tile // G))]
    else:
        dq_tiles = [(h // G, t) for h in range(H)
                    for t in reversed(_row_tiles(Sq, [h], tile))]
    D = torch.zeros((B, H, Sq), dtype=torch.float32)
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32)
    dk = torch.zeros((B, Skv, Hkv, hd), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for b in range(B):
        for kvh, rows in dq_tiles:                     # heaviest first
            pos, heads = rows
            D[b, heads, pos] = (do[b, pos, heads].float()
                                * o[b, pos, heads].float()).sum(-1)
            kend = min(Skv, int(pos[-1]) + 1) if causal else Skv
            acc = torch.zeros((len(pos), hd))
            for kt in range(-(-kend // tile)):
                ka, ke = kt * tile, min(Skv, (kt + 1) * tile)
                _, ds = _bwd_tile(q, k, v, do, lse, D, b, rows, kvh, ka, ke,
                                  causal, scale)
                acc += rnd(ds) @ k[b, ka:ke, kvh].float()
            dq[b, pos, heads] = acc
        for kvh in range(Hkv):
            for kt in range(-(-Skv // tile)):
                ka, ke = kt * tile, min(Skv, (kt + 1) * tile)
                for h in range(kvh * G, (kvh + 1) * G):
                    for rows in _row_tiles(Sq, [h], tile)[
                            kt if causal else 0:]:
                        pos = rows[0]
                        p, ds = _bwd_tile(q, k, v, do, lse, D, b, rows, kvh,
                                          ka, ke, causal, scale)
                        dv[b, ka:ke, kvh] += rnd(p).T @ do[b, pos, h].float()
                        dk[b, ka:ke, kvh] += rnd(ds).T @ (
                            q[b, pos, h].float() * q_scale)
    return (dq.mul_(scale).to(q.dtype), dk.mul_(dk_scale).to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# decode: the split over the keys, its plain versions
# ---------------------------------------------------------------------------
def visible_keys(Sq: int, Skv: int, *, causal: bool, q_offset: int,
                 kv_len) -> int:
    """Keys any of the Sq queries can see: ``min(kv_len, Skv)`` and, causal,
    at most up to the last query's position."""
    kv = _valid(Skv, kv_len)
    return min(kv, q_offset + Sq) if causal else kv


def decode_splits(visible: int, groups: int,
                  sms: int = H100_SMS) -> list[tuple[int, int]]:
    """The key ranges ``[start, end)`` of the split decode kernel: the
    visible keys ``[0, visible)`` cut into equal ranges of whole
    ``SPLIT_ALIGN``-key tiles (the last one shorter), as many as put about
    ``SPLIT_CTAS_PER_SM`` CTAs on each of the card's ``sms`` SMs when each
    range is launched for ``groups`` (batch row, kv head) pairs, and no
    range without a key.  Every visible key lies in exactly one range;
    none lies past ``visible``; ``visible <= 0`` gives no range."""
    visible = int(visible)
    if visible <= 0:
        return []
    tiles = -(-visible // SPLIT_ALIGN)
    want = max(1, -(-sms * SPLIT_CTAS_PER_SM // max(1, int(groups))))
    chunk = -(-tiles // min(tiles, want)) * SPLIT_ALIGN
    return [(s, min(visible, s + chunk)) for s in range(0, visible, chunk)]


def heads_to_rows(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, Sq, H, ...] -> [B, Hkv, Sq * G, ...]: row r = i * G + g holds
    query i of head kvh * G + g (the kernels' row order)."""
    B, Sq, H = x.shape[:3]
    G = H // Hkv
    y = x.reshape(B, Sq, Hkv, G, *x.shape[3:]).transpose(1, 2)
    return y.reshape(B, Hkv, Sq * G, *x.shape[3:])


def rows_to_heads(y: torch.Tensor, Sq: int) -> torch.Tensor:
    """The inverse of :func:`heads_to_rows`: [B, Hkv, Sq * G, hd] ->
    [B, Sq, H, hd]."""
    B, Hkv, R, hd = y.shape
    G = R // Sq
    return y.reshape(B, Hkv, Sq, G, hd).transpose(1, 2).reshape(
        B, Sq, Hkv * G, hd)


def attention_partials(q, k, v, ranges, *, causal: bool = True,
                       q_offset: int = 0, kv_len: int | None = None):
    """The plain version of the split kernel: for each key range ``s`` of
    ``ranges`` and each row r = i * G + g of each (batch row, kv head),
    over the range's keys that the row sees, ``m`` = the largest scaled
    score (``-inf`` if none), ``l = Σ e^(s - m)`` and ``acc = Σ e^(s - m)
    v`` (with ``m`` read as 0 where it is ``-inf``, so a range with no
    visible key gives l = 0, acc = 0).  Returns f32 ``m``, ``l`` [B, Hkv,
    n_split, R] and ``acc`` [B, Hkv, n_split, R, hd]."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    valid = _valid(Skv, kv_len)
    scale = 1.0 / math.sqrt(hd)
    qr = heads_to_rows(q.float(), Hkv) * scale        # [B, Hkv, R, hd]
    qpos = q_offset + torch.arange(Sq * G, device=q.device) // G
    ms, ls, accs = [], [], []
    for a, e in ranges:
        kpos = torch.arange(a, e, device=q.device)
        kr = k[:, a:e].float().permute(0, 2, 3, 1)    # [B, Hkv, hd, n]
        vr = v[:, a:e].float().transpose(1, 2)        # [B, Hkv, n, hd]
        s = torch.matmul(qr, kr)                      # [B, Hkv, R, n]
        mask = (kpos < valid)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1) if e > a else s.new_full(s.shape[:-1],
                                                    float("-inf"))
        p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p, vr))
    R = Sq * G
    if not ranges:
        z = q.new_zeros((B, Hkv, 0, R), dtype=torch.float32)
        return z, z.clone(), q.new_zeros((B, Hkv, 0, R, hd),
                                         dtype=torch.float32)
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def combine_partials(m, l, acc) -> torch.Tensor:
    """The plain version of the combine kernel: ``m* = max_s m_s``, ``l* =
    Σ l_s e^(m_s - m*)``, ``o = Σ acc_s e^(m_s - m*) / l*`` over the split
    axis (2), 0 where ``l* = 0`` (a split with every key masked, m_s =
    -inf, adds exactly 0).  Returns f32 [B, Hkv, R, hd]."""
    if m.shape[2] == 0:
        return acc.new_zeros(acc.shape[:2] + acc.shape[3:])
    mx = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - torch.where(mx == float("-inf"), 0.0, mx))
    lsum = (l * w).sum(dim=2)
    o = (acc * w[..., None]).sum(dim=2)
    return o / torch.where(lsum == 0, 1.0, lsum)[..., None]


def error_ratio(got, want, tol: float) -> float:
    """How far an attention output ``got`` lies from the plain version's
    ``want`` (both [..., hd]), as a share of ``tol``: the largest
    ``|got - want| / (tol * (|want| + min(1, rms)))``, ``rms`` the root
    mean square of want's row (its last axis).  A kernel holds when this
    is at most 1: rtol = tol, and an absolute part that scales with the
    row, since a row over n keys of unit-variance values has an RMS near
    n^-½ (0.016 at 4096 keys, where a fixed atol of 3e-2 would pass a
    kernel that lost a whole split); capped at tol, so the rule is never
    looser than allclose with rtol = atol = tol.  A row of zeros (no
    visible key) must be matched exactly."""
    d = (got.float() - want.float()).abs()
    if d.numel() == 0:
        return 0.0
    w = want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    lim = tol * (w.abs() + rms)
    return float(torch.where(d == 0, 0.0, d / lim).max())


def grad_error_ratio(got, want, tol: float) -> float:
    """How far a gradient ``got`` lies from the plain version's ``want``, as
    a share of ``tol``: the largest ``|got - want| / (tol * (|want| +
    min(1, rms)))`` with ``rms`` the root mean square of the whole of
    ``want``.  :func:`error_ratio`'s absolute part scales with each row,
    which a gradient cannot meet: under the causal mask query 0's dQ is 0
    in exact arithmetic (its one probability is 1, so dS = dP - D = 0) and
    a few ulps in floats.  A kernel holds when this is at most 1."""
    d = (got.float() - want.float()).abs()
    if d.numel() == 0:
        return 0.0
    w = want.float()
    rms = min(1.0, float(w.square().mean().sqrt()))
    if rms == 0:                     # want is all zeros: match exactly
        return 0.0 if float(d.max()) == 0 else float("inf")
    return float((d / (tol * (w.abs() + rms))).max())


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _check(q, k, v, head_dims=FWD_HEAD_DIMS, what="the kernel"):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want [B, Sq, H, hd] and two "
                         "[B, Skv, Hkv, hd]")
    B, Sq, H, hd = q.shape
    Bk, Skv, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if hd not in head_dims or H // Hkv > MAX_GROUP:
        raise ValueError(f"{what} takes head dims {head_dims} and at most "
                         f"{MAX_GROUP} query heads per kv head, got hd={hd}, "
                         f"G={H // Hkv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def variant_of(q, k) -> str:
    """The kernel :func:`flash_attention_cuda` runs for q [B, Sq, H, hd]
    and k [B, Skv, Hkv, hd] (the dispatch rule of the module docstring;
    ``decode_split`` is followed by ``decode_combine``)."""
    G = q.shape[2] // k.shape[2]
    if q.shape[1] * G <= SPLIT_ROWS:
        return "decode_split"
    return "prefill_mma" if q.dtype == torch.bfloat16 else "tiled_f32"


def _launched(lib, err: int, variant: str) -> None:
    """Raise if the launch failed, else count it."""
    if err:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())
    flash_attention_cuda.launches_by[variant] += 1
    flash_attention_cuda.launches += 1


def _split(lib, q, k, v, n, chunk, causal, q_offset, kv, stream):
    """Launch the split kernel over ``n`` ranges of ``chunk`` keys (a
    :func:`decode_splits` plan, not checked here) into one new f32
    workspace: ``m``, ``l`` [B, Hkv, n, R] and ``acc`` [B, Hkv, n, R, hd]
    one after the other.  Returns the workspace and the three pointers.
    No launch for n = 0."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    N = B * Hkv * n * Sq * (H // Hkv)
    ws = torch.empty(N * (2 + hd), dtype=torch.float32, device=q.device)
    p = ws.data_ptr()
    ptrs = (p, p + 4 * N, p + 8 * N)
    if n:
        err = lib.flash_attention_split_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, B, Sq, Skv, H,
            Hkv, hd, DTYPE_CODES[q.dtype], int(bool(causal)), q_offset, kv,
            n, chunk, stream)
        _launched(lib, err, "decode_split")
    return ws, ptrs


def _combine(lib, m, l, acc, n, Hkv, out, stream):
    """Launch the combine pass on the partials at pointers m, l, acc."""
    B, Sq, H, hd = out.shape
    err = lib.flash_attention_combine_launch(
        m, l, acc, out.data_ptr(), B, Sq, H, Hkv, hd, DTYPE_CODES[out.dtype],
        n, stream)
    _launched(lib, err, "decode_combine")
    return out


def decode_partials_cuda(q, k, v, ranges, *, causal: bool = True,
                         q_offset: int = 0, kv_len: int | None = None):
    """The split kernel alone, on CUDA tensors: the partials of
    :func:`attention_partials` for ``ranges``, which must be
    :func:`decode_splits`'s cut of this call's visible keys (equal ranges
    from 0: the kernel derives each CTA's range from the first one's
    length)."""
    from repro_torch.kernels import _build
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if Sq * (H // k.shape[2]) > SPLIT_ROWS:
        raise ValueError(f"the split kernel takes G * Sq <= {SPLIT_ROWS} rows "
                         f"per kv head, got {Sq * (H // k.shape[2])}")
    vis = visible_keys(Sq, Skv, causal=causal, q_offset=q_offset,
                       kv_len=kv_len)
    chunk = ranges[0][1] - ranges[0][0] if ranges else 1
    if chunk < 1 or list(ranges) != [(s, min(vis, s + chunk))
                                     for s in range(0, vis, chunk)]:
        raise ValueError(f"ranges {ranges} are not a split of the {vis} "
                         "visible keys into equal ranges")
    with torch.cuda.device(q.device):
        ws, _ = _split(_build.load(), q, k, v, len(ranges), chunk, causal,
                       int(q_offset), _valid(Skv, kv_len),
                       torch.cuda.current_stream().cuda_stream)
    R, n = Sq * (H // k.shape[2]), len(ranges)
    N = B * k.shape[2] * n * R
    shape = (B, k.shape[2], n, R)
    return (ws[:N].view(shape), ws[N:2 * N].view(shape),
            ws[2 * N:].view(*shape, hd))


def combine_cuda(m, l, acc, out: torch.Tensor) -> torch.Tensor:
    """The combine kernel alone: merges the partials ``m``, ``l`` [B, Hkv,
    n_split, R] and ``acc`` [B, Hkv, n_split, R, hd] (f32, contiguous, on
    out's card) into ``out`` [B, Sq, H, hd] (R = Sq * G), in out's dtype;
    ``n_split = 0`` gives zeros.  Returns ``out``."""
    from repro_torch.kernels import _build
    B, Sq, H, hd = out.shape
    Bm, Hkv, n, R = m.shape
    if Bm != B or H % Hkv or R != Sq * (H // Hkv) or \
            hd > max(FWD_HEAD_DIMS) or \
            l.shape != m.shape or acc.shape != (*m.shape, hd) or \
            not all(x.dtype == torch.float32 and x.is_contiguous() and
                    x.device == out.device for x in (m, l, acc)) or \
            out.dtype not in DTYPE_CODES or not out.is_contiguous():
        raise ValueError(f"partials {tuple(m.shape)}, {tuple(l.shape)}, "
                         f"{tuple(acc.shape)} do not fit out "
                         f"{tuple(out.shape)} {out.dtype}")
    with torch.cuda.device(out.device):
        return _combine(_build.load(), m.data_ptr(), l.data_ptr(),
                        acc.data_ptr(), n, Hkv, out,
                        torch.cuda.current_stream().cuda_stream)


def _training_case(k, q_offset, kv_len, what) -> None:
    if q_offset != 0 or _valid(k.shape[1], kv_len) != k.shape[1]:
        raise ValueError(f"{what} takes the training case only (q_offset 0, "
                         f"every key valid), got q_offset={q_offset}, "
                         f"kv_len={kv_len} of {k.shape[1]} keys")


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         kv_len: int | None = None, with_lse: bool = False):
    """Attention of q [B, Sq, H, hd] over k, v [B, Skv, Hkv, hd] (see the
    module docstring; ``kv_len=None`` means all Skv keys).  CUDA tensors
    launch the kernel(s) that :func:`variant_of` names; CPU tensors take
    :func:`attention`.  Mixed devices or dtypes, shapes or layouts the
    kernels do not take raise, as does a kernel that fails to launch.

    ``with_lse`` (training: q_offset 0 and every key valid, else it
    raises) returns (out, lse) with each row's log-sum-exp [B, H, Sq] f32
    for :func:`flash_attention_backward_cuda`; it always runs a prefill
    kernel (``prefill_mma`` in bf16, ``tiled_f32`` in f32), which writes
    it, whatever the shape."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if with_lse:
        _training_case(k, q_offset, kv_len, "with_lse")
    if {q.device.type, k.device.type, v.device.type} == {"cpu"}:
        return attention(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len, with_lse=with_lse)
    _check(q, k, v)
    from repro_torch.kernels import _build
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv = _valid(Skv, kv_len)
    variant = variant_of(q, k)
    lse = None
    if with_lse:
        variant = "prefill_mma" if q.dtype == torch.bfloat16 else "tiled_f32"
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(q)
        if variant == "decode_split":
            ranges = decode_splits(
                visible_keys(Sq, Skv, causal=causal, q_offset=q_offset,
                             kv_len=kv_len), B * Hkv,
                torch.cuda.get_device_properties(q.device)
                .multi_processor_count)
            chunk = ranges[0][1] if ranges else 1
            ws, ptrs = _split(lib, q, k, v, len(ranges), chunk, causal,
                              q_offset, kv, stream)
            return _combine(lib, *ptrs, len(ranges), Hkv, out, stream)
        launch = lib.flash_attention_wgmma_launch \
            if variant == "prefill_mma" else lib.flash_attention_tiled_launch
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), B, Sq, Skv, H,
                     Hkv, hd, DTYPE_CODES[q.dtype], int(bool(causal)),
                     q_offset, kv, stream)
    _launched(lib, err, variant)
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by = dict.fromkeys(VARIANTS, 0)


def bwd_variant_of(q) -> tuple[str, str]:
    """The backward kernels :func:`flash_attention_backward_cuda` launches
    for q's dtype, in launch order: bf16 ``("dq_mma", "dkdv_mma")``, f32
    ``("dq_f32", "dkdv_f32")``."""
    return ("dq_mma", "dkdv_mma") if q.dtype == torch.bfloat16 \
        else ("dq_f32", "dkdv_f32")


def flash_attention_backward_cuda(q, k, v, o, lse, do, *,
                                  causal: bool = True):
    """(dq, dk, dv) of ``o = attention(q, k, v, causal=causal)`` at q_offset
    0 over every key, from the forward's row log-sum-exp ``lse`` [B, H, Sq]
    f32 (:func:`flash_attention_cuda` ``with_lse``) and the output's
    gradient ``do``.  CUDA tensors launch the dQ kernel (which also writes
    D = rowsum(do o o)) and then the dK/dV kernel of :func:`bwd_variant_of`,
    each counted in ``flash_attention_backward_cuda.launches_by[variant]``
    and ``.launches``; CPU tensors take :func:`attention_backward`.
    Devices, dtypes, shapes or layouts the kernels do not take raise, as
    does a kernel that fails to launch (a bf16 call never falls back to the
    f32 kernels).  The backward kernels take the head dims
    :data:`BWD_HEAD_DIMS`; another width raises a ``ValueError`` on the
    card (no plain fall-back)."""
    if {x.device.type for x in (q, k, v, o, lse, do)} == {"cpu"}:
        return attention_backward(q, k, v, o, lse, do, causal=causal)
    _check(q, k, v, BWD_HEAD_DIMS, "the attention backward")
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: want q's shape {tuple(q.shape)}, dtype "
                             f"and device, contiguous and 16-byte aligned")
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse: want float32 [{B}, {H}, {Sq}] on q's device, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    from repro_torch.kernels import _build
    lib = _build.load()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    shape = (B, Sq, Skv, H, Hkv, hd, DTYPE_CODES[q.dtype], int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for variant, ptrs in zip(bwd_variant_of(q), (
                (q, k, v, o, do, lse, D, dq), (q, k, v, do, lse, D, dk, dv))):
            err = getattr(lib, BWD_ENTRY[variant])(
                *(x.data_ptr() for x in ptrs), *shape, stream)
            if err:
                raise RuntimeError(
                    f"flash_attention backward {variant} kernel launch "
                    "failed: " + lib.fire_block_error_string(err).decode())
            flash_attention_backward_cuda.launches_by[variant] += 1
            flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0
flash_attention_backward_cuda.launches_by = dict.fromkeys(BWD_VARIANTS, 0)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient, for training (q_offset 0, every key
    valid): the forward kernel with its row log-sum-exp, the backward
    kernels on the saved q, k, v, output and lse.  Under
    ``torch.utils.checkpoint`` the lse comes from the recomputed forward
    with the rest.  CPU tensors take the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None
