"""The port's LM kernel entry points against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` / ``rmsnorm`` against the
Pallas kernels behind ``repro.kernels.ops`` (interpret mode on the CPU),
the model's attention with a query offset and a valid length against
``repro.models.layers.flash_attention``, and both RMSNorm roundings
against ``repro.models.layers.rmsnorm`` and ``repro.kernels.ref``.  On
the CPU the port's wrappers run their kernels' plain PyTorch versions;
the same inputs, made from a seed with numpy, go through both packages.
Tolerances are the JAX package's own kernel tests'
(``tests/test_kernels.py``): attention 3e-5 in f32 and 3e-2 in bf16,
RMSNorm 1e-5 and 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (rounded once, in numpy's float32 -> bf16 cast of either side)."""
    t = torch.from_numpy(a.astype(np.float32)).to(TORCH_DT[dtype])
    j = jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
    return j, t


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(rng, B, Sq, Skv, Hkv, G, hd, dtype):
    H = Hkv * G
    return (_pair(rng.standard_normal((B, Sq, H, hd)), dtype),
            _pair(rng.standard_normal((B, Skv, Hkv, hd)), dtype),
            _pair(rng.standard_normal((B, Skv, Hkv, hd)), dtype))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 64])
def test_flash_attention_matches_pallas(dtype, causal, G, hd):
    """Odd lengths: 33 queries over 33 keys (causal self-attention, as the
    JAX sweep pairs them) or over 130 keys."""
    Sq, Skv = (33, 33) if causal else (33, 130)
    rng = np.random.default_rng([len(dtype), causal, G, hd])
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, Sq, Skv, 2, G, hd, dtype)
    want = jops.flash_attention(qj, kj, vj, causal=causal, bq=32, bk=32)
    got = ops.flash_attention(qt, kt, vt, causal=causal, bq=32, bk=32)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, ATTN_TOL[dtype])
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal),
           ATTN_TOL[dtype])


@pytest.mark.parametrize("q_offset,kv_len,Sq", [
    (0, 21, 21),        # prefill into a longer cache
    (40, 41, 1),        # decode, mid-cache
    (63, 64, 1),        # decode, last cache entry
    (70, 71, 1),        # decode past the cache: kv_len > Skv
    (0, None, 64),      # the Pallas case: every key valid
    (5, 18, 13),        # a chunk of queries at an offset
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_attention_offsets_match_jax(q_offset, kv_len, Sq, dtype):
    """The model's attention with a query offset and a valid length
    against the JAX layers' (and their naive oracle), G = 2, hd = 32 as
    in the reduced internlm2 config, over a 64-entry cache."""
    rng = np.random.default_rng(q_offset * 7 + Sq)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, Sq, 64, 2, 2, 32, dtype)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    got = layers.flash_attention(qt, kt, vt, **kw)
    want = jlayers.flash_attention(qj, kj, vj, q_block=16, kv_block=16, **kw)
    _close(got, want, ATTN_TOL[dtype])
    _close(got, jlayers.naive_attention(qj, kj, vj, **kw), ATTN_TOL[dtype])
    _close(layers.naive_attention(qt, kt, vt, **kw), want, ATTN_TOL[dtype])


def test_attention_row_with_no_key_is_zero():
    """kv_len = 0 hides every key: every row is 0, as the Pallas kernel's
    ``l == 0 -> 1`` gives (and the JAX naive oracle's NaN -> 0)."""
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 3, 8, 1, 2, 16, "float32")
    got = fa.attention(qt, kt, vt, causal=False, kv_len=0)
    assert torch.equal(got, torch.zeros_like(got))
    _close(got, jlayers.naive_attention(qj, kj, vj, causal=False, kv_len=0),
           0)


def test_plain_attention_chunks_queries(monkeypatch):
    """The plain version's query chunks leave the result unchanged."""
    rng = np.random.default_rng(2)
    qt, kt, vt = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 37, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    whole = fa.attention(qt, kt, vt, causal=True, q_offset=3, kv_len=39)
    monkeypatch.setattr(fa, "PLAIN_Q_CHUNK", 5)
    torch.testing.assert_close(
        fa.attention(qt, kt, vt, causal=True, q_offset=3, kv_len=39), whole,
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 300])
@pytest.mark.parametrize("d", [32, 512])
def test_rmsnorm_matches_pallas(dtype, rows, d):
    rng = np.random.default_rng(rows * 7 + d)
    xj, xt = _pair(rng.standard_normal((rows, d)) * 3, dtype)
    wj, wt = _pair(rng.standard_normal((d,)), dtype)
    got = ops.rmsnorm(xt, wt, rows_blk=8)
    assert got.dtype == xt.dtype
    _close(got, jops.rmsnorm(xj, wj, rows_blk=8), NORM_TOL[dtype])
    _close(got, jref.rmsnorm_ref(xj, wj), NORM_TOL[dtype])


def test_rmsnorm_3d_batch():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 17, 64)), "float32")
    w = np.ones((64,), np.float32)
    _close(ops.rmsnorm(xt, torch.from_numpy(w)),
           jref.rmsnorm_ref(xj, jnp.asarray(w)), 1e-5)


def test_rmsnorm_roundings_bf16():
    """In bf16 the model's rounding (y to bf16, times w cast to bf16)
    matches ``repro.models.layers.rmsnorm`` and the Pallas rounding (one
    rounding of y * w) matches ``ref.rmsnorm_ref``; on these inputs the
    two roundings differ, so the model must not take the Pallas one.  In
    f32 the two are the same function."""
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((64, 256)) * 3, "bfloat16")
    w32 = (1 + 0.3 * rng.standard_normal(256)).astype(np.float32)
    wt = torch.from_numpy(w32)                        # param dtype f32
    model = layers.rmsnorm(xt, wt)
    pallas = rn.rmsnorm_cuda(xt, wt)
    _close(model, jlayers.rmsnorm(xj, jnp.asarray(w32)), 2e-2)
    _close(pallas, jref.rmsnorm_ref(xj, jnp.asarray(w32)), 2e-2)
    exact_model = np.asarray(jlayers.rmsnorm(xj, jnp.asarray(w32)),
                             np.float32)
    assert (model.float().numpy() == exact_model).mean() > 0.99
    assert not torch.equal(model, pallas)
    x32 = xt.float()
    torch.testing.assert_close(rn.rmsnorm(x32, wt, model=True),
                               rn.rmsnorm(x32, wt, model=False),
                               rtol=0, atol=0)
