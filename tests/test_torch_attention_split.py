"""The split decode's host planner and plain versions, on the CPU.

``decode_splits`` cuts the visible keys into the ranges the split kernel
runs one CTA each for; ``attention_partials`` and ``combine_partials`` are
the plain versions of the split kernel and of its combine pass.  Merged,
they equal the plain ``attention`` (within f32 1e-5) and the JAX package's
attention (``repro.models.layers.flash_attention`` with its naive oracle,
within the JAX kernel tests' f32 3e-5), including splits whose keys are
all masked and rows that see no key.  Sizes are small: at most 256 keys,
head dim at most 32.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32_TOL = 1e-5        # merged partials against the plain attention
JAX_TOL = 3e-5        # against the JAX package (its kernel tests' f32)


def _qkv(seed, B, Sq, Skv, Hkv, G, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, Hkv * G, hd), (B, Skv, Hkv, hd),
                      (B, Skv, Hkv, hd))]


def _merged(q, k, v, ranges, **kw):
    m, l, acc = fa.attention_partials(q, k, v, ranges, **kw)
    return fa.rows_to_heads(fa.combine_partials(m, l, acc), q.shape[1])


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("visible,groups", [
    (0, 32), (-3, 32), (1, 32), (40, 32), (64, 32), (65, 32), (68, 32),
    (256, 1), (256, 4), (3719, 32), (4160, 32), (4160, 1), (100, 10 ** 6)])
def test_decode_splits_cover_each_visible_key_once(visible, groups):
    ranges = fa.decode_splits(visible, groups)
    if visible <= 0:
        assert ranges == []
        return
    covered = np.zeros(visible, int)
    for a, e in ranges:
        assert 0 <= a < e <= visible
        covered[a:e] += 1
    assert (covered == 1).all()
    assert ranges[0][0] == 0 and ranges[-1][1] == visible
    chunk = ranges[0][1] - ranges[0][0]
    assert chunk % fa.SPLIT_ALIGN == 0 or len(ranges) == 1
    assert all(a == i * chunk for i, (a, _) in enumerate(ranges))
    # at most about SPLIT_CTAS_PER_SM CTAs per SM, at most one range per
    # aligned tile of keys
    want = -(-fa.H100_SMS * fa.SPLIT_CTAS_PER_SM // groups)
    assert len(ranges) <= min(-(-visible // fa.SPLIT_ALIGN), want)


def test_decode_splits_at_the_long_wave_launch_more_ctas_than_sms():
    """One query per row at position 3718 over 8 kv heads, 4 rows: more
    than 132 CTAs, every one with keys."""
    vis = fa.visible_keys(1, 4160, causal=True, q_offset=3718, kv_len=3719)
    ranges = fa.decode_splits(vis, 4 * 8)
    assert vis == 3719 and len(ranges) * 32 > 132


@pytest.mark.parametrize("Sq,Skv,causal,q_offset,kv_len,want", [
    (1, 64, True, 0, 0, 0),          # kv_len 0: nothing visible
    (1, 64, True, 0, 1, 1),          # kv_len 1
    (1, 64, True, 70, 71, 64),       # kv_len past the cache: Skv
    (1, 64, True, 40, 41, 41),       # decode mid-cache
    (8, 200, True, 60, 150, 68),     # the causal bound cuts the keys
    (8, 200, False, 60, 150, 150),   # not causal: kv_len alone
    (3, 50, True, 5, None, 8),       # kv_len None: Skv, then causal
])
def test_visible_keys(Sq, Skv, causal, q_offset, kv_len, want):
    assert fa.visible_keys(Sq, Skv, causal=causal, q_offset=q_offset,
                           kv_len=kv_len) == want


@pytest.mark.parametrize("Sq,G,dtype,want", [
    (1, 2, torch.bfloat16, "decode_split"),
    (1, 2, torch.float32, "decode_split"),
    (8, 2, torch.bfloat16, "decode_split"),      # 16 rows: still a tile
    (1, 16, torch.float32, "decode_split"),
    (9, 2, torch.bfloat16, "prefill_mma"),       # 18 rows
    (17, 1, torch.bfloat16, "prefill_mma"),
    (17, 1, torch.float32, "tiled_f32"),
    (1, 32, torch.float32, "tiled_f32"),
])
def test_dispatch_rule(Sq, G, dtype, want):
    q = torch.zeros((2, Sq, 2 * G, 16), dtype=dtype)
    k = torch.zeros((2, 5, 2, 16), dtype=dtype)
    assert fa.variant_of(q, k) == want


def test_heads_rows_round_trip():
    x = torch.arange(2 * 3 * 6 * 4, dtype=torch.float32).reshape(2, 3, 6, 4)
    r = fa.heads_to_rows(x, 2)                 # G = 3: rows i * 3 + g
    assert r.shape == (2, 2, 9, 4)
    assert torch.equal(r[1, 1, 3 * 2 + 1], x[1, 2, 1 * 3 + 1])
    assert torch.equal(fa.rows_to_heads(r, 3), x)


# ---------------------------------------------------------------------------
# the partials and their combination
# ---------------------------------------------------------------------------
SPLIT_CASES = [
    # B, Sq, Skv, Hkv, G, hd, causal, q_offset, kv_len
    (2, 1, 200, 2, 2, 32, True, 150, 151),     # decode mid-cache
    (2, 1, 64, 2, 2, 16, True, 70, 71),        # decode past the cache
    (1, 1, 64, 1, 4, 16, True, 0, 1),          # one visible key
    (2, 1, 64, 2, 2, 16, True, 39, 40),        # below one split
    (1, 8, 100, 1, 2, 16, True, 60, 68),       # a range masked for a row
    (1, 3, 100, 2, 3, 16, True, 40, 200),      # kv_len > Skv, causal cut
    (2, 2, 256, 2, 4, 32, False, 0, 250),      # not causal
]


@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,hd,causal,q_offset,kv_len",
                         SPLIT_CASES)
def test_merged_partials_equal_attention(B, Sq, Skv, Hkv, G, hd, causal,
                                         q_offset, kv_len):
    q, k, v = _qkv(Skv + Sq, B, Sq, Skv, Hkv, G, hd)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    vis = fa.visible_keys(Sq, Skv, **kw)
    want = fa.attention(q, k, v, **kw)
    for groups in (1, B * Hkv, 10 ** 4):       # few and many ranges
        ranges = fa.decode_splits(vis, groups)
        torch.testing.assert_close(_merged(q, k, v, ranges, **kw), want,
                                   rtol=F32_TOL, atol=F32_TOL)
    # one range per 16 keys, then one more past every visible key: the
    # ranges a row cannot see add exactly nothing
    ranges = [(a, min(vis, a + 16)) for a in range(0, vis, 16)]
    ranges.append((vis, Skv))
    m, l, acc = fa.attention_partials(q, k, v, ranges, **kw)
    assert torch.isinf(m[:, :, -1]).all()
    assert not l[:, :, -1].any() and not acc[:, :, -1].any()
    torch.testing.assert_close(
        fa.rows_to_heads(fa.combine_partials(m, l, acc), Sq), want,
        rtol=F32_TOL, atol=F32_TOL)


def test_row_whose_keys_are_all_masked_in_a_range():
    """8 queries at 60..67 over the 68 visible keys in ranges [0, 64) and
    [64, 68): the first query's rows see nothing of the second range (m =
    -inf, l = 0), the last query's rows see all of it."""
    q, k, v = _qkv(3, 1, 8, 100, 1, 2, 16)
    kw = dict(causal=True, q_offset=60, kv_len=68)
    ranges = fa.decode_splits(fa.visible_keys(8, 100, **kw), 32)
    assert ranges == [(0, 64), (64, 68)]
    m, l, _ = fa.attention_partials(q, k, v, ranges, **kw)
    assert torch.isinf(m[0, 0, 1, :8]).all() and (l[0, 0, 1, :8] == 0).all()
    assert torch.isfinite(m[0, 0, 1, 8:]).all()


def test_rows_with_no_key_are_zero():
    """kv_len 0: no range; the combination of no partials is 0, as the
    plain attention gives."""
    q, k, v = _qkv(4, 2, 1, 32, 2, 2, 16)
    kw = dict(causal=True, q_offset=5, kv_len=0)
    ranges = fa.decode_splits(fa.visible_keys(1, 32, **kw), 4)
    assert ranges == []
    m, l, acc = fa.attention_partials(q, k, v, ranges, **kw)
    assert m.shape == (2, 2, 0, 2) and acc.shape == (2, 2, 0, 2, 16)
    got = fa.rows_to_heads(fa.combine_partials(m, l, acc), 1)
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(fa.attention(q, k, v, **kw), got)


@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,hd,causal,q_offset,kv_len",
                         SPLIT_CASES[:5])
def test_merged_partials_match_jax(B, Sq, Skv, Hkv, G, hd, causal, q_offset,
                                   kv_len):
    """The split decode's arithmetic against the JAX model's attention and
    its naive oracle on the same inputs."""
    q, k, v = _qkv(Skv * 3 + Sq, B, Sq, Skv, Hkv, G, hd)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = _merged(q, k, v, fa.decode_splits(fa.visible_keys(Sq, Skv, **kw),
                                            B * Hkv), **kw).numpy()
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    for want in (jlayers.flash_attention(qj, kj, vj, q_block=16, kv_block=16,
                                         **kw),
                 jlayers.naive_attention(qj, kj, vj, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_TOL,
                                   atol=JAX_TOL)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = _qkv(5, 2, 1, 64, 2, 2, 16)
    before = (fa.flash_attention_cuda.launches,
              dict(fa.flash_attention_cuda.launches_by))
    got = fa.flash_attention_cuda(q, k, v, causal=True, q_offset=40,
                                  kv_len=41)
    assert torch.equal(got, fa.attention(q, k, v, causal=True, q_offset=40,
                                         kv_len=41))
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.launches_by) == before
    assert set(before[1]) == set(fa.VARIANTS)


# ---------------------------------------------------------------------------
# the rule the kernels are held to on the card (``error_ratio``)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_error_ratio_refuses_a_merge_that_drops_one_range(dtype, tol):
    """A decode over 256 keys in 16 ranges: the merge of every range,
    rounded to the dtype, is held well inside the tolerance; the merge
    that drops the last range (1/16 of the keys) is refused."""
    q, k, v = (x.to(dtype) for x in _qkv(7, 2, 1, 256, 2, 2, 32))
    kw = dict(causal=True, q_offset=255, kv_len=256)
    ranges = [(a, a + 16) for a in range(0, 256, 16)]
    want = fa.attention(q, k, v, **kw)
    m, l, acc = fa.attention_partials(q, k, v, ranges, **kw)
    whole = fa.rows_to_heads(fa.combine_partials(m, l, acc), 1).to(dtype)
    assert fa.error_ratio(whole, want, tol) < 0.2
    cut = fa.rows_to_heads(fa.combine_partials(
        m[:, :, :-1], l[:, :, :-1], acc[:, :, :-1]), 1).to(dtype)
    assert fa.error_ratio(cut, want, tol) > 1


def test_error_ratio_holds_rows_of_zeros_exactly():
    z = torch.zeros(2, 3, 16)
    assert fa.error_ratio(z, z, 3e-2) == 0
    assert fa.error_ratio(z + 1e-6, z, 3e-2) == float("inf")
    assert fa.error_ratio(z[:, :0], z[:, :0], 3e-2) == 0


def test_error_ratio_is_never_looser_than_allclose():
    """Rows of large values (RMS above 1): the absolute part stays at tol,
    so the share is at least that of allclose with rtol = atol = tol."""
    rng = np.random.default_rng(3)
    want = torch.from_numpy(3 * rng.standard_normal((4, 8, 32)).astype(
        np.float32))
    got = want + torch.from_numpy(0.05 * rng.standard_normal(
        (4, 8, 32)).astype(np.float32))
    flat = float(((got - want).abs() / (3e-2 * (1 + want.abs()))).max())
    assert fa.error_ratio(got, want, 3e-2) >= flat > 0
