"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

The counterpart of the JAX package's ``rmsnorm_pallas``
(``repro/kernels/rmsnorm.py``) and of the model's jnp ``rmsnorm``
(``repro/models/layers.py``), which round differently in bf16:

* ``model=False`` (the Pallas kernel, ``kernels.ops.rmsnorm``):
  ``(x32 * rsqrt(mean(x32²) + eps) * w32).astype(x.dtype)``;
* ``model=True`` (the model's layers):
  ``(x32 * rsqrt(mean(x32²) + eps)).astype(x.dtype) * w.astype(x.dtype)``.

In f32 the two are the same function.  :func:`rmsnorm` is the plain
version; :func:`rmsnorm_cuda` launches ``csrc/rmsnorm.cu`` on CUDA
tensors (one warp per row; built at first use, see
:mod:`repro_torch.kernels._build`) and counts the launch in
``rmsnorm_cuda.launches``, and computes the plain version on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            model: bool = False) -> torch.Tensor:
    """The plain PyTorch version over the last axis of ``x`` [..., d]."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if model:
        return y.to(x.dtype) * w.to(x.dtype)
    return (y * w.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                 model: bool = False) -> torch.Tensor:
    """RMSNorm of ``x`` [..., d] (float32 or bfloat16, contiguous) with
    weight ``w`` [d] (float32 or bfloat16).  CUDA tensors launch the
    kernel; CPU tensors take :func:`rmsnorm`.  Mixed devices, other
    dtypes, a non-contiguous ``x`` or a weight of the wrong length
    raise."""
    devs = {x.device.type, w.device.type}
    if devs == {"cpu"}:
        return rmsnorm(x, w, eps, model)
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got x "
                        f"{x.dtype}, w {w.dtype}")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"w: shape {tuple(w.shape)}, want "
                         f"({x.shape[-1] if x.dim() else '?'},)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    from repro_torch.kernels import _build
    lib = _build.load()
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    with torch.cuda.device(x.device):
        w32 = w.float().contiguous()
        out = torch.empty_like(x)
        err = lib.rmsnorm_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w32.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), rows, d, DTYPE_CODES[x.dtype],
            int(model), float(eps),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
