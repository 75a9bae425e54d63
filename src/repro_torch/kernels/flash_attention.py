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

Each launch counts one in ``flash_attention_cuda.launches_by[variant]``
and in the total ``flash_attention_cuda.launches``.  CPU tensors take the
plain version :func:`attention` and nothing else.  :func:`attention_partials`
and :func:`combine_partials` are the plain versions of the split and the
combine kernels; nothing on the main path calls them.  The kernels choose
their own tiles and, in bf16, round the probabilities to bf16 before the
P·V product: they agree with the plain version within float tolerance,
not bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.rmsnorm import DTYPE_CODES

HEAD_DIMS = (16, 32, 64, 128)     # head dims the kernels are built for
MAX_GROUP = 64                    # query heads per kv head they take
PLAIN_Q_CHUNK = 1024              # query rows per step of the plain version
SPLIT_ROWS = 16                   # G * Sq up to which decode splits the keys
SPLIT_ALIGN = 64                  # keys: a split range starts at a multiple
SPLIT_CTAS_PER_SM = 4             # split CTAs in flight the planner aims at
H100_SMS = 132                    # SMs decode_splits plans for by default
VARIANTS = ("prefill_mma", "tiled_f32", "decode_split", "decode_combine")


def _valid(Skv: int, kv_len) -> int:
    return Skv if kv_len is None else max(0, min(int(kv_len), Skv))


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None) -> torch.Tensor:
    """The plain PyTorch version (same semantics as the kernels)."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    valid = _valid(Skv, kv_len)
    scale = 1.0 / math.sqrt(hd)
    k32 = k.float().permute(0, 2, 3, 1)              # [B, Hkv, hd, Skv]
    v32 = v.float().permute(0, 2, 1, 3)              # [B, Hkv, Skv, hd]
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
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
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # no visible key: 0
        o = torch.matmul(p, v32[:, :, None])          # [B, Hkv, G, n, hd]
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, s1 - s0, H, hd).to(q.dtype)
    return out


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


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _check(q, k, v):
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
    if hd not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and at most "
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
    if Bm != B or H % Hkv or R != Sq * (H // Hkv) or hd > max(HEAD_DIMS) or \
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         kv_len: int | None = None) -> torch.Tensor:
    """Attention of q [B, Sq, H, hd] over k, v [B, Skv, Hkv, hd] (see the
    module docstring; ``kv_len=None`` means all Skv keys).  CUDA tensors
    launch the kernel(s) that :func:`variant_of` names; CPU tensors take
    :func:`attention`.  Mixed devices or dtypes, shapes or layouts the
    kernels do not take raise, as does a kernel that fails to launch."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if {q.device.type, k.device.type, v.device.type} == {"cpu"}:
        return attention(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    _check(q, k, v)
    from repro_torch.kernels import _build
    lib = _build.load()
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv = _valid(Skv, kv_len)
    variant = variant_of(q, k)
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
                     B, Sq, Skv, H, Hkv, hd, DTYPE_CODES[q.dtype],
                     int(bool(causal)), q_offset, kv, stream)
    _launched(lib, err, variant)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by = dict.fromkeys(VARIANTS, 0)
