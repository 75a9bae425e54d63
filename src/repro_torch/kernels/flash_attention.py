"""GQA flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of the JAX package's ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``), generalised as the model's jnp
attention (``repro/models/layers.py:72``) is: q [B, Sq, H, hd] at
positions ``q_offset + i`` attends to k/v [B, Skv, Hkv, hd] (G = H / Hkv
query heads per kv head), key j visible iff ``j < min(kv_len, Skv)`` and,
causal, ``j <= q_offset + i``.  Scores ``(q · hd^-½) · k`` and the
softmax are f32; the output has q's dtype; a row that sees no key is 0.
The Pallas kernel is the case ``q_offset = 0``, ``kv_len = Skv``.

:func:`attention` is the plain version (scores materialised, in query
chunks so that memory stays bounded); :func:`flash_attention_cuda`
launches ``csrc/flash_attention.cu`` on CUDA tensors (built at first use,
see :mod:`repro_torch.kernels._build`) and counts the launch in
``flash_attention_cuda.launches``, and computes the plain version on CPU
tensors.  The kernel chooses its own tiles: it agrees with the plain
version within float tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.rmsnorm import DTYPE_CODES

HEAD_DIMS = (16, 32, 64, 128)     # head dims the kernel is built for
MAX_GROUP = 64                    # query heads per kv head it takes
PLAIN_Q_CHUNK = 1024              # query rows per step of the plain version


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None) -> torch.Tensor:
    """The plain PyTorch version (same semantics as the kernel)."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    valid = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         kv_len: int | None = None) -> torch.Tensor:
    """Attention of q [B, Sq, H, hd] over k, v [B, Skv, Hkv, hd] (see the
    module docstring; ``kv_len=None`` means all Skv keys).  CUDA tensors
    launch the kernel; CPU tensors take :func:`attention`.  Mixed devices
    or dtypes, shapes or layouts the kernel does not take raise."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if {q.device.type, k.device.type, v.device.type} == {"cpu"}:
        return attention(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    from repro_torch.kernels import _build
    lib = _build.load()
    vp = ctypes.c_void_p
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
            vp(out.data_ptr()), B, Sq, Skv, H, Hkv, hd, DTYPE_CODES[q.dtype],
            int(bool(causal)), q_offset, kv,
            vp(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
