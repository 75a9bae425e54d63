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
tensors (built at first use, see :mod:`repro_torch.kernels._build`) in
the variant :func:`norm_variant` picks — ``"split"`` (one CTA per row)
for rows of whole 16-byte vectors, ``"generic"`` (one warp per row) for
a ``d`` or an alignment the split variant does not take — and counts the
launch in ``rmsnorm_cuda.launches`` and ``launches_by``; on CPU tensors
it computes the plain version.  :func:`rmsnorm_split_order` replays the
split variant's order of summation on the CPU.

Training goes through :class:`RMSNormFn`, whose backward,
:func:`rmsnorm_backward_cuda`, launches the backward kernel (per-CTA f32
partials of dw; variant by :func:`bwd_variant`, plan by
:func:`card_plan`) and the reduction of the partials; the plain version
is :func:`rmsnorm_backward`, :func:`rmsnorm_backward_partials` replays
the partials and :func:`reduce_partials` their reduction.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("split", "generic")
SPLIT_THREADS = 1024    # threads of a split CTA at most (two vectors each)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            model: bool = False) -> torch.Tensor:
    """The plain PyTorch version over the last axis of ``x`` [..., d]."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return _scaled(x, y, w, model)


def _scaled(x, y, w, model):
    if model:
        return y.to(x.dtype) * w.to(x.dtype)
    return (y * w.float()).to(x.dtype)


def norm_variant(d: int, itemsize: int, aligned: bool = True) -> str:
    """The kernel's variant for rows of ``d`` elements of ``itemsize``
    bytes: ``"split"`` (a row over a CTA, at any row count) for rows of
    whole 16-byte vectors, at most two a thread; ``"generic"`` when the
    row is not whole 16-byte vectors, the pointers are not 16-byte
    ``aligned``, or the row is too long for a split CTA."""
    vec = 16 // itemsize
    if aligned and d % vec == 0 and d // vec <= 2 * SPLIT_THREADS:
        return "split"
    return "generic"


def split_threads(d: int, itemsize: int) -> tuple[int, int]:
    """(threads, vectors per thread) of a split CTA: one 16-byte vector a
    thread up to 256 vectors a row, two above."""
    nv = d // (16 // itemsize)
    per = 1 if nv <= 256 else 2
    return -(-(-(-nv // per)) // 32) * 32, per


def rmsnorm_split_order(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                        model: bool = False) -> torch.Tensor:
    """RMSNorm with the sum of squares taken in the split variant's order
    (plain PyTorch, for the tests): each thread's partial over its 16-byte
    vectors in element order (vector i of thread t: i = t + threads k), an
    xor-shuffle tree over each warp's 32 partials, and the warps' sums
    added in warp order.  A product added to a partial is rounded once, as
    the card's fused multiply-add rounds it.  Same results as
    :func:`rmsnorm` within float tolerance."""
    d = x.shape[-1]
    if d % (16 // x.element_size()):
        raise ValueError(f"no split order at d={d}")
    threads, per = split_threads(d, x.element_size())
    vec = 16 // x.element_size()
    x32 = x.reshape(-1, d).float()
    R = x32.shape[0]
    v = torch.zeros((R, per * threads * vec), dtype=torch.float64)
    v[:, :d] = x32.double()
    v = v.reshape(R, per, threads, vec)
    part = torch.zeros((R, threads), dtype=torch.float32)
    for k in range(per):
        for e in range(vec):
            f = v[:, k, :, e]
            part = (part.double() + f * f).float()
    part = part.reshape(R, threads // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lane ^ o]
    total = torch.zeros((R,), dtype=torch.float32)
    for j in range(threads // 32):
        total = total + part[:, j, 0]
    r = torch.rsqrt(total / d + eps)
    y = x32 * r[:, None]
    return _scaled(x, y, w, model).reshape(x.shape)


def _check(x, w):
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


def _launch(variant, x, w, eps, model):
    """Launch ``variant`` on CUDA tensors (checked); None picks it by
    :func:`norm_variant`.  Returns (out, the variant that ran)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    with torch.cuda.device(x.device):
        w32 = w.float().contiguous()
        out = torch.empty_like(x)
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w32, out))
        if variant is None:
            variant = norm_variant(d, x.element_size(), aligned)
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        err = lib.rmsnorm_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w32.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), rows, d, DTYPE_CODES[x.dtype],
            int(model), VARIANTS.index(variant), float(eps),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed ({variant} "
                           "variant): "
                           + lib.fire_block_error_string(err).decode())
    return out, variant


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                 model: bool = False) -> torch.Tensor:
    """RMSNorm of ``x`` [..., d] (float32 or bfloat16, contiguous) with
    weight ``w`` [d] (float32 or bfloat16).  CUDA tensors launch the
    kernel in the variant :func:`norm_variant` picks; CPU tensors take
    :func:`rmsnorm`.  Mixed devices, other dtypes, a non-contiguous ``x``
    or a weight of the wrong length raise."""
    devs = {x.device.type, w.device.type}
    if devs == {"cpu"}:
        return rmsnorm(x, w, eps, model)
    _check(x, w)
    out, variant = _launch(None, x, w, eps, model)
    rmsnorm_cuda.launches += 1
    rmsnorm_cuda.launches_by[variant] += 1
    return out


def launch_norm_variant(variant: str, x: torch.Tensor, w: torch.Tensor,
                        eps: float = 1e-5,
                        model: bool = False) -> torch.Tensor:
    """One launch of the kernel's ``variant`` on CUDA tensors, counted
    nowhere: the tests and ``chip_smoke.py`` hold each variant against the
    plain version with it.  A variant that cannot take the shape or the
    alignment raises."""
    _check(x, w)
    return _launch(variant, x, w, eps, model)[0]


rmsnorm_cuda.launches = 0
rmsnorm_cuda.launches_by = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------------------
# the backward (training)
# ---------------------------------------------------------------------------
BWD_VARIANTS = ("rows", "generic")  # of the backward kernel; then "reduce"
BWD_CTAS = 256                      # CTAs the generic variant spreads over
BWD_MAX_D = 12272                   # the generic variant's partial of dw
                                    # and its 64 B of sums fit 48 KB
ROWS_WARPS = 8                      # warps of a rows CTA (csrc kRowsWarps)
# (vectors a lane, warps a row) the rows kernel is built for (csrc
# RMS_ROWS_SHAPES): the shapes rows_shape picks
ROWS_SHAPES = ((1, 1), (2, 1), (2, 2), (2, 4), (2, 8), (4, 8))
ROWS_MAX_VECTORS = 32 * 4 * ROWS_WARPS  # 16-byte vectors a row at most
REDUCE_SLICES = 8                   # csrc kReduceSlices
H100_SMS = 132                      # the replay's default grid: one CTA an
                                    # SM of an H100


class BwdPlan(NamedTuple):
    """How the backward kernel runs: its variant, its CTAs (rows:
    ``n_cta``, each with ``ROWS_WARPS // wpr`` groups striding over the
    rows; generic: ``n_cta`` runs of ``per`` rows), and (rows) the 16-byte
    vectors a lane ``vpl`` and the warps a row ``wpr``."""
    variant: str
    n_cta: int
    per: int = 0
    vpl: int = 0
    wpr: int = 0


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5, model: bool = False):
    """The plain version of the backward: (dx in x's dtype, dw f32 [d]) for
    ``y = rmsnorm(x, w, eps, model)`` and its gradient ``dy``.  With r =
    rsqrt(mean(x²) + eps), x̂ = x r and g = dy w (``model``: dy times w in
    x's dtype, rounded, as the model's product's gradient is), dx = r (g -
    x̂ mean(g x̂)) and dw = Σ_rows dy a, a = x̂ (``model``: x̂ rounded to
    x's dtype)."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    xh = x32 * r
    if model:
        g = (dy * w.to(dy.dtype)).float()
        a = xh.to(x.dtype).float()
    else:
        g = dy.float() * w.float()
        a = xh
    dx = r * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    d = x.shape[-1]
    return dx.to(x.dtype), (dy.float() * a).reshape(-1, d).sum(0)


def bwd_variant(d: int, itemsize: int, aligned: bool = True) -> str:
    """The backward kernel's variant, from the row's shape and the
    pointers' alignment: ``"rows"`` (a row held in one group's registers)
    for rows of whole 16-byte vectors, at most :data:`ROWS_MAX_VECTORS` of
    them, on 16-byte ``aligned`` x, dy and dx; else ``"generic"``, which
    takes d up to :data:`BWD_MAX_D`.  A wider unaligned or odd row
    raises."""
    vec = 16 // itemsize
    if aligned and d % vec == 0 and d // vec <= ROWS_MAX_VECTORS:
        return "rows"
    if d > BWD_MAX_D:
        raise ValueError(f"the backward kernel takes d <= {BWD_MAX_D} unless "
                         "its rows are whole, aligned 16-byte vectors, at "
                         f"most {ROWS_MAX_VECTORS} of them; got d={d}")
    return "generic"


def rows_shape(d: int, itemsize: int) -> tuple[int, int]:
    """(vectors a lane, warps a row) of the rows variant: the fewest warps
    (1, 2, 4, 8) whose lanes hold the row in at most 2 vectors each (4
    where 8 warps do not: a wider row), then the fewest vectors a lane.
    Fewer vectors a lane leave registers for more warps an SM and for the
    next row's loads, which ran faster on the H100 (``PERF.md`` §6)."""
    nv = d // (16 // itemsize)
    wpr = next((k for k in (1, 2, 4, 8) if nv <= 32 * 2 * k), 8)
    vpl = next(k for k in (1, 2, 4) if nv <= 32 * k * wpr)
    return vpl, wpr


def bwd_plan(rows: int, d: int, itemsize: int, variant: str = "rows",
             max_ctas: int = H100_SMS) -> BwdPlan:
    """The backward kernel's plan for ``rows`` rows of ``d``.  Rows: at
    most ``max_ctas`` CTAs (the wrapper: the card's SMs times the CTAs an
    SM holds), and no more than give each group a row; generic: the rows
    cut into at most :data:`BWD_CTAS` runs of equal length (the last
    shorter)."""
    if variant == "rows":
        vpl, wpr = rows_shape(d, itemsize)
        groups = ROWS_WARPS // wpr
        return BwdPlan("rows", max(1, min(max_ctas, -(-rows // groups))),
                       vpl=vpl, wpr=wpr)
    per = max(1, -(-rows // BWD_CTAS))
    return BwdPlan("generic", max(1, -(-rows // per)), per=per)


def rmsnorm_backward_partials(x, w, dy, eps: float = 1e-5,
                              plan: BwdPlan | None = None) -> torch.Tensor:
    """The backward kernel's partials of dw, replayed in plain PyTorch (for
    the tests): f32 [CTAs, d] in the model's rounding, in the kernel's
    order of summation under ``plan`` (default :func:`bwd_plan` of the
    rows' shape and alignment).  Rows: each group of CTA c strides over
    the rows ``c G + g + k n_cta G`` (G groups a CTA) and sums its rows'
    products dy a in that order, a product rounded to f32 and then added;
    the CTA's partial is its groups' sums added in group order.  Generic:
    CTA c sums its run of rows in row order.  The terms a need the row
    factor r, whose rsqrt the card approximates: a bf16 rounding of x r
    may flip where r is one f32 step off, so the replay equals the card's
    partials within the dw tolerance, not bit for bit."""
    d = x.shape[-1]
    a = x.float() * torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + eps)
    a = a.to(x.dtype).float()
    t = (dy.float() * a).reshape(-1, d)
    R = t.shape[0]
    if plan is None:
        plan = bwd_plan(R, d, x.element_size(),
                        bwd_variant(d, x.element_size()))
    if plan.variant == "generic":
        part = torch.zeros((plan.n_cta, d), dtype=torch.float32)
        for c in range(plan.n_cta):
            for row in range(c * plan.per, min(R, (c + 1) * plan.per)):
                part[c] += t[row]
        return part
    G = ROWS_WARPS // plan.wpr
    n = plan.n_cta * G                       # groups of the grid
    acc = torch.zeros((n, d), dtype=torch.float32)
    for k in range(-(-R // n)):
        rows = torch.arange(k * n, min(R, (k + 1) * n))
        acc[rows - k * n] += t[rows]
    acc = acc.reshape(plan.n_cta, G, d)
    part = acc[:, 0].clone()
    for g in range(1, G):
        part += acc[:, g]
    return part


def reduce_partials(part: torch.Tensor) -> torch.Tensor:
    """dw from the partials [n_cta, d] in the reduction kernel's order
    (plain PyTorch; bit for bit the kernel's, as both only add f32): slice
    s sums the partials s, s + 8, ... in order, then ((s0 + s1) + (s2 +
    s3)) + ((s4 + s5) + (s6 + s7))."""
    n, d = part.shape
    s = torch.zeros((REDUCE_SLICES, d), dtype=torch.float32,
                    device=part.device)
    for j in range(n):
        s[j % REDUCE_SLICES] += part[j]
    h = 1
    while h < REDUCE_SLICES:
        s[0::2 * h] = s[0::2 * h] + s[h::2 * h]
        h *= 2
    return s[0]


@functools.cache
def _rows_ctas_per_sm(device_index: int, dtype_code: int, d: int, vpl: int,
                      wpr: int) -> int:
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(device_index):
        n = lib.rmsnorm_bwd_rows_occupancy(dtype_code, d, vpl, wpr)
    if n <= 0:
        raise RuntimeError("the rows backward kernel fits no SM at "
                           f"d={d} (vpl {vpl}, wpr {wpr}): "
                           + lib.fire_block_error_string(-n).decode())
    return n


def card_plan(x: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
              vpl: int | None = None, wpr: int | None = None) -> BwdPlan:
    """The plan a launch on the card takes: :func:`bwd_variant` from the
    shape and the pointers, and for the rows variant a grid of the card's
    SMs times the CTAs one holds (``vpl``/``wpr`` force another shape of
    :data:`ROWS_SHAPES` that holds the row: the tests and probes)."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    es = x.element_size()
    variant = bwd_variant(d, es, all(t.data_ptr() % 16 == 0
                                     for t in (x, dy, dx)))
    if variant == "generic":
        return bwd_plan(rows, d, es, "generic")
    dv, dw_ = rows_shape(d, es)
    vpl, wpr = vpl or dv, wpr or dw_
    if (vpl, wpr) not in ROWS_SHAPES or d // (16 // es) > 32 * vpl * wpr:
        raise ValueError(f"no rows kernel of {vpl} vectors a lane and {wpr} "
                         f"warps a row takes d={d}")
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    per_sm = _rows_ctas_per_sm(index, DTYPE_CODES[x.dtype], d, vpl, wpr)
    G = ROWS_WARPS // wpr
    return BwdPlan("rows", max(1, min(sms * per_sm, -(-rows // G))),
                   vpl=vpl, wpr=wpr)


def launch_backward(plan: BwdPlan, x, w32, dy, dx, part, dw, eps: float):
    """Launch the backward kernel of ``plan`` into ``dx`` and ``part``,
    then (``dw`` not None) the reduction into ``dw``, on CUDA tensors the
    caller checked, counted nowhere; a launch that fails raises."""
    from repro_torch.kernels import _build
    lib = _build.load()
    d = x.shape[-1]
    rows = x.numel() // d
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    code = lib.rmsnorm_bwd_launch(
        x.data_ptr(), w32.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        part.data_ptr(), rows, d, DTYPE_CODES[x.dtype],
        BWD_VARIANTS.index(plan.variant), plan.n_cta, plan.per, plan.vpl,
        plan.wpr, float(eps), stream)
    if code == 0 and dw is not None:
        code = lib.rmsnorm_bwd_reduce_launch(part.data_ptr(), dw.data_ptr(),
                                             plan.n_cta, d, stream)
    if code:
        raise RuntimeError(f"rmsnorm backward ({plan.variant}) kernel launch "
                           "failed: " + lib.fire_block_error_string(code)
                           .decode())


def rmsnorm_backward_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                          eps: float = 1e-5):
    """(dx, dw f32) of :func:`rmsnorm_backward` in the model's rounding (the
    only one anything trains through).  CUDA tensors launch the
    backward kernel in the variant :func:`bwd_variant` picks (``rows``:
    a row in a warp's registers, the grid sized to the card; ``generic``)
    and then the reduction of its partials, counted in
    ``rmsnorm_backward_cuda.launches`` (the backward kernel) and
    ``.launches_by`` (``rows``, ``generic``, ``reduce``);
    ``.last_plan`` is the last launch's :class:`BwdPlan`.  CPU tensors
    take :func:`rmsnorm_backward`.  Mixed devices, other dtypes, a ``dy``
    unlike ``x``, or a row no variant takes raise, as does a kernel that
    fails to launch."""
    if {x.device.type, w.device.type, dy.device.type} == {"cpu"}:
        return rmsnorm_backward(x, w, dy, eps, model=True)
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy: want x's shape {tuple(x.shape)}, dtype and "
                         "device, contiguous")
    d = x.shape[-1]
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        if x.numel() == 0:
            return dx, torch.zeros((d,), dtype=torch.float32,
                                   device=x.device)
        w32 = w.float().contiguous()
        plan = card_plan(x, dx, dy)
        part = torch.empty((plan.n_cta, d), dtype=torch.float32,
                           device=x.device)
        dw = torch.empty((d,), dtype=torch.float32, device=x.device)
        launch_backward(plan, x, w32, dy, dx, part, dw, eps)
    rmsnorm_backward_cuda.launches_by[plan.variant] += 1
    rmsnorm_backward_cuda.launches_by["reduce"] += 1
    rmsnorm_backward_cuda.launches += 1
    rmsnorm_backward_cuda.last_plan = plan
    return dx, dw


rmsnorm_backward_cuda.launches = 0
rmsnorm_backward_cuda.launches_by = dict.fromkeys((*BWD_VARIANTS, "reduce"), 0)
rmsnorm_backward_cuda.last_plan = None


class RMSNormFn(torch.autograd.Function):
    """The model's RMSNorm (``model=True`` rounding) with its gradient, for
    training: the forward kernel, then the backward kernels on the saved x
    and w.  dw is f32 (the kernel reads w in f32 and rounds it itself).
    CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps, model=True)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward_cuda(x, w, dy.contiguous(), ctx.eps)
        return dx, dw, None
