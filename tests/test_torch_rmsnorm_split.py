"""The CUDA RMSNorm kernel's order of summation, replayed on the CPU.

``rmsnorm.rmsnorm_split_order`` computes RMSNorm with the sum of squares
taken as ``csrc/rmsnorm.cu``'s split variant takes it (a row over a CTA
of one or two 16-byte vectors a thread: each thread's partial over its
vectors, an xor-shuffle tree in each warp, the warps' sums added in
order).  Here it is
held against the JAX package's ``rmsnorm_pallas`` (interpret mode; the
Pallas rounding) and the model's ``layers.rmsnorm`` (the model's
rounding) in f32 and bf16, at the shapes the LM path launches cut to
size and at rows whose vectors do not fill every lane; and the variant
rule is checked on its own.  Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (rows, d): a decode step's rows, one row, warps left part empty (d = 96
# and 160 are 12 and 20 bf16 vectors), a split CTA of two vectors a thread
SHAPES = ((4, 2048), (1, 32), (7, 96), (3, 160), (5, 4096))


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((rows, d))).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal((d,))).astype(np.float32)
    return x, w


def _jax(x, w, dtn, model):
    xj = jnp.asarray(x).astype(DTYPES[dtn][1])
    if model:
        out = jlayers.rmsnorm(xj, jnp.asarray(w))
    else:
        out = rmsnorm_pallas(xj, jnp.asarray(w), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("dtn", sorted(DTYPES))
@pytest.mark.parametrize("rows,d", SHAPES)
def test_split_order_matches_jax(rows, d, dtn, model):
    """The split order == the JAX kernel (or the model's norm) within
    the kernel's tolerance, and == the plain version."""
    x, w = _inputs(rows, d, rows * d)
    want = _jax(x, w, dtn, model)
    xt = torch.tensor(x).to(DTYPES[dtn][0])
    wt = torch.tensor(w)
    plain = rn.rmsnorm(xt, wt, model=model)
    tol = TOL[dtn]
    got = rn.rmsnorm_split_order(xt, wt, model=model)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol,
                               atol=tol)


def _scalar_sum_sq(row, vec, threads, per):
    """The kernel's sum of squares of one row, element by element: thread
    t's partial over vectors t + threads k (each product added with one
    rounding, as an FMA), the xor tree in each warp, the warps in order."""
    part = np.zeros(threads, np.float32)
    for t in range(threads):
        for k in range(per):
            i = t + threads * k
            for e in range(vec):
                if i * vec + e < row.size:
                    f = float(row[i * vec + e])
                    part[t] = np.float32(float(part[t]) + f * f)
    for o in (16, 8, 4, 2, 1):
        part = np.array([part[t] + part[t ^ o] for t in range(threads)],
                        np.float32)
    total = np.float32(0)
    for j in range(threads // 32):
        total = np.float32(total + part[32 * j])
    return total


@pytest.mark.parametrize("dtn,d", [("bfloat16", 160), ("float32", 2048),
                                   ("bfloat16", 4096)])
def test_split_order_sums_in_the_kernels_order(dtn, d):
    """The replay's sum of squares is, bit for bit, the one an
    element-by-element walk of the kernel's threads gives."""
    x, w = _inputs(2, d, d)
    dt = DTYPES[dtn][0]
    xt = torch.tensor(x).to(dt)
    vec = 16 // xt.element_size()
    threads, per = rn.split_threads(d, xt.element_size())
    rows = xt.float().numpy()
    totals = [_scalar_sum_sq(r, vec, threads, per) for r in rows]
    got = rn.rmsnorm_split_order(xt, torch.ones(d))
    r = torch.rsqrt(torch.tensor(totals) / d + 1e-5)
    want = (xt.float() * r[:, None]).to(dt)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no split order"):
        rn.rmsnorm_split_order(torch.ones(2, 130, dtype=torch.bfloat16),
                               torch.ones(130))


@pytest.mark.parametrize("d,itemsize,aligned,want", [
    (2048, 2, True, "split"),     # the LM's rows, bf16: 256 vectors
    (1024, 2, True, "split"),
    (1000, 2, True, "split"),     # 125 vectors
    (256, 4, True, "split"),
    (2048, 4, True, "split"),     # 512 vectors: 256 threads of two
    (4096, 4, True, "split"),     # 1024 vectors: 512 threads
    (16384, 2, True, "split"),    # 2048 vectors: 1024 threads
    (16384, 4, True, "generic"),  # 4096 vectors: too many for a CTA
    (130, 2, True, "generic"),    # not whole 16-byte vectors
    (2048, 2, False, "generic"),  # a pointer off 16 bytes
    (32, 4, True, "split"),
    (8192, 4, True, "split"),     # 2048 vectors: the most a CTA takes
    (8196, 4, True, "generic"),   # 2049 vectors
    (96, 2, True, "split"),       # 12 vectors: one warp, part empty
    (130, 4, True, "generic"),    # f32 rows end mid-vector
])
def test_variant_rule(d, itemsize, aligned, want):
    assert rn.norm_variant(d, itemsize, aligned) == want


def test_split_threads():
    assert rn.split_threads(2048, 2) == (256, 1)
    assert rn.split_threads(2048, 4) == (256, 2)
    assert rn.split_threads(4096, 4) == (512, 2)
    assert rn.split_threads(32, 2) == (32, 1)


def test_cpu_tensors_take_the_plain_version_uncounted():
    x, w = _inputs(4, 64, 0)
    xt, wt = torch.tensor(x), torch.tensor(w)
    n0, by0 = rn.rmsnorm_cuda.launches, dict(rn.rmsnorm_cuda.launches_by)
    torch.testing.assert_close(rn.rmsnorm_cuda(xt, wt), rn.rmsnorm(xt, wt))
    assert rn.rmsnorm_cuda.launches == n0
    assert rn.rmsnorm_cuda.launches_by == by0
