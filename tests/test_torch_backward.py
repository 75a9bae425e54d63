"""The backward of attention and RMSNorm, on the CPU: the plain versions of
the backward kernels against ``jax.grad`` of the JAX package's jnp
``flash_attention`` and ``rmsnorm`` (``repro/models/layers.py``), the
kernels' walk over the tiles (``attention_backward_tiles``) and the
RMSNorm kernel's partials against autograd of the plain forward, and the
two ``torch.autograd.Function``s.  Inputs come from numpy seeds.

Tolerances: attention gradients by ``flash_attention.grad_error_ratio``
(rtol = tol, atol = tol x min(1, the tensor's RMS)); f32 at 1e-4 (both
sides sum in f32 in another order), bf16 at 3e-2 (the port's D =
rowsum(dO o O) reads the output rounded to bf16, JAX's autodiff the f32
one before its cast; one bf16 step is 2^-8 relative).  RMSNorm in f32 as
allclose at 1e-5; in bf16 dx at 2e-2 (one bf16 step of the inputs moves
it by 2^-8 relative) and dw as a relative Frobenius error of 1e-2 (JAX
forms dy a in bf16 before it sums, the port in f32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# (B, Sq, Skv, H, Hkv, hd, causal): GQA and not, odd lengths, Sq != Skv,
# every head dim the backward kernels take (hd 112: kimi-k2, zamba2-7b)
ATTN_CASES = [(2, 150, 150, 4, 2, 16, True), (1, 333, 333, 4, 1, 32, True),
              (1, 70, 130, 2, 2, 64, False), (2, 65, 65, 4, 2, 128, False),
              (1, 5, 5, 2, 1, 16, True), (1, 97, 97, 4, 2, 112, True)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtn):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(JDT[dtn]) for a in arrs]
    tx = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtn])
          for j in jx]
    return jx, tx


def _t2n(t):
    return t.float().numpy()


def _hold_against_jax_grad(case, dtn, backward, jax_dtype=None):
    """``backward(q, k, v, out, lse, do, causal=)`` on the plain forward's
    output and lse against ``jax.grad`` of the JAX package's jnp
    attention (on the same values, taken in ``jax_dtype``, by default
    ``dtn``), by ``grad_error_ratio`` at ``dtn``'s tolerance."""
    B, Sq, Skv, H, Hkv, hd, causal = case
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(
        sum(case), [(B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd),
                    (B, Sq, H, hd)], dtn)

    def f(q, k, v):
        o = jlayers.flash_attention(q, k, v, causal=causal, q_block=64,
                                    kv_block=64)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(x.astype(JDT[jax_dtype or dtn]) for x in (jq, jk, jv)))
    out, lse = fa.attention(q, k, v, causal=causal, with_lse=True)
    got = backward(q, k, v, out, lse, do, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == TDT[dtn] and g.shape == tuple(w.shape)
        r = fa.grad_error_ratio(torch.from_numpy(_t2n(g)),
                                torch.from_numpy(np.array(
                                    w.astype(jnp.float32))), ATTN_TOL[dtn])
        assert r <= 1, (name, r)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_jax_grad(case, dtn):
    _hold_against_jax_grad(case, dtn, fa.attention_backward)


@pytest.mark.parametrize("case", ATTN_CASES + [
    (1, 1024, 1024, 4, 2, 128, True),     # rounding adds up over many keys
    (1, 100, 100, 6, 2, 32, True),        # G = 3: 21 queries, 63 rows a tile
    (1, 130, 130, 4, 4, 112, False)])     # zamba2's G = 1 at hd 112
def test_bf16_tile_walk_matches_jax_grad(case):
    """The tensor-core kernels' walk (dQ tiles of 64 rows packed over a kv
    head's G heads) with P and dS as the kernels carry them into their
    products (two bf16 terms each), on bf16 inputs, against jax.grad at
    the bf16 tolerance.  jax.grad is taken in f32 on the same bf16
    values, the exact gradient of what the kernels see: JAX's own bf16
    autodiff rounds its intermediates to bf16 and, at 1024 keys, lies
    1.39 of the tolerance from that gradient (dk), as far as the f32
    plain backward does."""
    _hold_against_jax_grad(case, "bfloat16", functools.partial(
        fa.attention_backward_tiles, bf16_products=True),
        jax_dtype="float32")


def test_bf16_terms_carry_p_and_ds_to_f32():
    """The two bf16 terms the tensor-core kernels split P and dS into
    (hi = bf16(x), lo = bf16(x - hi)) carry x to 2^-16 relative; one term
    is x rounded to bf16."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal(10000) * np.exp(
        rng.uniform(-20, 5, 10000))).astype(np.float32))
    assert torch.equal(fa.bf16_terms(x, 1), x.bfloat16().float())
    one, two = fa.bf16_terms(x, 1), fa.bf16_terms(x, fa.BF16_TERMS)
    assert float(((one - x).abs() / x.abs()).max()) > 2.0 ** -10
    assert float(((two - x).abs() / x.abs()).max()) <= 2.0 ** -16


@pytest.mark.parametrize("case", ATTN_CASES + [(1, 100, 60, 2, 1, 16, True),
                                               (1, 1, 3, 1, 1, 16, False)])
def test_backward_tile_walk_matches_autograd(case):
    """The kernels' walk (dQ CTAs over the key tiles their queries see, then
    dK/dV CTAs over each head's query tiles that see their keys, with D
    from the first pass), replayed, equals autograd of the plain forward;
    so does the plain backward."""
    B, Sq, Skv, H, Hkv, hd, causal = case
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, Sq, H, hd), (B, Skv, Hkv, hd),
                             (B, Skv, Hkv, hd), (B, Sq, H, hd)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention(*leaves, causal=causal), leaves,
                               do)
    out, lse = fa.attention(q, k, v, causal=causal, with_lse=True)
    for fn in (fa.attention_backward, fa.attention_backward_tiles):
        got = fn(q, k, v, out, lse, do, causal=causal)
        for g, w in zip(got, want):
            assert fa.grad_error_ratio(g, w, 1e-4) <= 1


def test_backward_tile_walk_skips_what_the_mask_hides():
    """Causal with more keys than queries: the keys past the last query are
    seen by no query tile and get dK = dV = 0; a query tile never reads a
    key tile past its own last query."""
    rng = np.random.default_rng(2)
    q, do = (torch.from_numpy(rng.standard_normal((1, 70, 2, 16))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 200, 1, 16))
                             .astype(np.float32)) for _ in range(2))
    out, lse = fa.attention(q, k, v, causal=True, with_lse=True)
    dq, dk, dv = fa.attention_backward_tiles(q, k, v, out, lse, do,
                                             causal=True)
    assert not dk[:, 70:].any() and not dv[:, 70:].any()
    assert dk[:, :70].abs().sum() > 0 and dq.abs().sum() > 0


def test_lse_is_the_rows_log_sum_exp():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 9, 1, 16))
                             .astype(np.float32)) for _ in range(2))
    out, lse = fa.attention(q, k, v, causal=True, with_lse=True)
    torch.testing.assert_close(out, fa.attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / 4.0
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), -np.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="training case"):
        fa.flash_attention_cuda(q, k, v, q_offset=1, with_lse=True)
    with pytest.raises(ValueError, match="training case"):
        fa.flash_attention_cuda(q, k, v, kv_len=5, with_lse=True)


def test_row_that_sees_no_key_has_zero_gradient():
    """lse = -inf (no visible key: here no key at all) gives 0, not NaN."""
    q = torch.ones((1, 3, 2, 16))
    k = v = torch.ones((1, 0, 1, 16))
    out, lse = fa.attention(q, k, v, causal=False, with_lse=True)
    assert torch.isinf(lse).all() and not out.any()
    for fn in (fa.attention_backward, fa.attention_backward_tiles):
        dq, dk, dv = fn(q, k, v, out, lse, torch.ones_like(q), causal=False)
        assert torch.isfinite(dq).all() and not dq.any()
        assert dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 128), (3, 130), (64, 2048)])
def test_rmsnorm_backward_matches_jax_grad(shape, dtn):
    rng = np.random.default_rng(shape[-1])
    xn = (3 * rng.standard_normal(shape)).astype(np.float32)
    wn = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    dyn = rng.standard_normal(shape).astype(np.float32)
    jx, jdy = (jnp.asarray(a).astype(JDT[dtn]) for a in (xn, dyn))
    jw = jnp.asarray(wn)                 # the f32 parameter
    x, dy = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtn])
             for a in (jx, jdy))
    w = torch.from_numpy(wn)

    def f(x, w):
        y = jlayers.rmsnorm(x, w)
        return jnp.sum(y.astype(jnp.float32) * jdy.astype(jnp.float32))
    wdx, wdw = jax.grad(f, argnums=(0, 1))(jx, jw)
    dx, dw = rn.rmsnorm_backward(x, w, dy, model=True)
    assert dx.dtype == TDT[dtn] and dw.dtype == torch.float32
    wdx, wdw = np.asarray(wdx.astype(jnp.float32)), np.asarray(wdw)
    if dtn == "float32":
        np.testing.assert_allclose(_t2n(dx), wdx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), wdw, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_t2n(dx), wdx, rtol=2e-2, atol=2e-2)
        assert np.linalg.norm(dw.numpy() - wdw) <= 1e-2 * np.linalg.norm(wdw)


@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_and_partials_match_autograd(dtype, model):
    """The plain backward against autograd of the plain forward (dw: in
    f32 against autograd's own products, as allclose at 1e-5 for f32; bf16
    autograd forms the products in bf16), and the kernel's per-CTA
    partials (the model's rounding, the only one the kernel has), added in
    CTA order, equal the plain dw of that rounding.  dx in bf16 may round
    one step (2^-8 relative) otherwise than autograd's."""
    rng = np.random.default_rng(4)
    for rows in (1, 37, 300, 1000):
        x = torch.from_numpy(3 * rng.standard_normal((rows, 48)).astype(
            np.float32)).to(dtype)
        w = torch.from_numpy(1 + 0.3 * rng.standard_normal(48).astype(
            np.float32))
        dy = torch.from_numpy(rng.standard_normal((rows, 48)).astype(
            np.float32)).to(dtype)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(rn.rmsnorm(xl, wl, model=model),
                                     (xl, wl), dy)
        dx, dw = rn.rmsnorm_backward(x, w, dy, model=model)
        tol = 1e-5 if dtype == torch.float32 else 1e-2   # a bf16 step: 2^-8
        torch.testing.assert_close(dx, gx, rtol=tol, atol=tol)
        if dtype == torch.float32:
            torch.testing.assert_close(dw, gw, rtol=1e-5, atol=1e-5)
        dw = rn.rmsnorm_backward(x, w, dy, model=True)[1]
        part = rn.rmsnorm_backward_partials(x, w, dy)
        plan = rn.bwd_plan(rows, 48, x.element_size())
        assert plan.variant == "rows" and part.shape == (plan.n_cta, 48)
        assert plan.n_cta <= rn.H100_SMS
        total = torch.zeros(48)
        for c in range(plan.n_cta):
            total += part[c]
        torch.testing.assert_close(total, dw, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rn.reduce_partials(part), dw, rtol=1e-5,
                                   atol=1e-5)


ROW_CASES = [(rows, d, dt) for rows, d in (
    (1, 2048), (9, 130), (64, 4608), (257, 2048), (300, 96), (1000, 133),
    (300, 8192)) for dt in ("float32", "bfloat16")] + [(33, 7168,
                                                        "bfloat16")]


@pytest.mark.parametrize("max_ctas", [16, 132])
@pytest.mark.parametrize("rows,d,dtn", ROW_CASES)
def test_rmsnorm_backward_replay_matches_plain_dw(rows, d, dtn, max_ctas):
    """The kernels' walk replayed (the backward's plan and partials, the
    reduction's slices and tree) against the plain dw within 1e-5, at row
    counts that leave groups idle or stride several rows, odd d (the
    generic variant) and the widths of the configs (4608, 7168 and 8192:
    a row over 8 warps; 8192 in f32 the generic variant)."""
    dtype = getattr(torch, dtn)
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(3 * rng.standard_normal((rows, d)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(1 + 0.3 * rng.standard_normal(d).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).to(dtype)
    es = x.element_size()
    variant = rn.bwd_variant(d, es)
    assert variant == ("rows" if d % (16 // es) == 0
                       and d // (16 // es) <= rn.ROWS_MAX_VECTORS
                       else "generic")
    plan = rn.bwd_plan(rows, d, es, variant, max_ctas=max_ctas)
    part = rn.rmsnorm_backward_partials(x, w, dy, plan=plan)
    assert part.shape == (plan.n_cta, d)
    if variant == "rows":
        groups = rn.ROWS_WARPS // plan.wpr
        assert plan.n_cta == min(max_ctas, -(-rows // groups))
        assert d // (16 // es) <= 32 * plan.vpl * plan.wpr
    dw = rn.rmsnorm_backward(x, w, dy, model=True)[1]
    torch.testing.assert_close(rn.reduce_partials(part), dw, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d,itemsize,aligned,want", [
    (2048, 2, True, ("rows", 2, 4)), (2048, 4, True, ("rows", 2, 8)),
    (128, 2, True, ("rows", 1, 1)), (512, 2, True, ("rows", 2, 1)),
    (1024, 2, True, ("rows", 2, 2)), (4608, 2, True, ("rows", 4, 8)),
    (8192, 2, True, ("rows", 4, 8)), (8192, 4, True, ("generic", 0, 0)),
    (2048, 2, False, ("generic", 0, 0)),
    (130, 2, True, ("generic", 0, 0))])
def test_rmsnorm_backward_variant_rule(d, itemsize, aligned, want):
    """The rule picks the variant from d, the element size and the
    pointers' alignment before any launch; the rows shape is the fewest
    warps a row that hold it in 2 vectors a lane (4 for the widest rows),
    then the fewest vectors a lane, always a shape the kernel is built
    for."""
    got = rn.bwd_variant(d, itemsize, aligned)
    shape = rn.rows_shape(d, itemsize) if got == "rows" else (0, 0)
    assert (got, *shape) == want
    assert got == "generic" or shape in rn.ROWS_SHAPES


def test_rmsnorm_backward_rejects_rows_no_variant_takes():
    with pytest.raises(ValueError, match=f"d <= {rn.BWD_MAX_D}"):
        rn.bwd_variant(rn.BWD_MAX_D + 4, 2, aligned=False)
    with pytest.raises(ValueError, match="16-byte vectors"):
        rn.bwd_variant(rn.BWD_MAX_D + 4, 4)
    with pytest.raises(ValueError, match="16-byte vectors"):
        rn.bwd_variant(12288, 2)            # command-r-plus: no variant


def test_autograd_functions_on_cpu_use_the_plain_versions(monkeypatch):
    """FlashAttentionFn and RMSNormFn on CPU tensors: the gradients of the
    plain forward, no build, no launch counted."""
    def no_build():
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(_build, "load", no_build)
    counts = (fa.flash_attention_backward_cuda.launches,
              dict(fa.flash_attention_backward_cuda.launches_by),
              rn.rmsnorm_backward_cuda.launches,
              dict(rn.rmsnorm_backward_cuda.launches_by))
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.FlashAttentionFn.apply(*a, True).square().sum().backward()
    fa.attention(*b, causal=True).square().sum().backward()
    for x, y in zip(a, b):
        assert fa.grad_error_ratio(x.grad, y.grad, 1e-4) <= 1
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    a = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    b = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    rn.RMSNormFn.apply(*a, 1e-5).sin().sum().backward()
    rn.rmsnorm(*b, model=True).sin().sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)
    assert counts == (fa.flash_attention_backward_cuda.launches,
                      dict(fa.flash_attention_backward_cuda.launches_by),
                      rn.rmsnorm_backward_cuda.launches,
                      dict(rn.rmsnorm_backward_cuda.launches_by))


def test_grad_error_ratio_rule():
    want = torch.tensor([[0.0, 0.0], [1.0, -2.0]])
    assert fa.grad_error_ratio(want, want, 1e-4) == 0
    # a few ulps on an exact zero pass: atol scales with the tensor's RMS
    assert fa.grad_error_ratio(want + torch.tensor([[1e-7, 0], [0, 0]]),
                               want, 1e-4) < 1
    assert fa.grad_error_ratio(want * 1.01, want, 1e-4) > 1
    assert fa.grad_error_ratio(torch.ones(3), torch.zeros(3), 1) == np.inf
