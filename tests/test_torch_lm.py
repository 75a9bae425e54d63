"""The port's LM serving path against the JAX package's, on the CPU.

internlm2-1.8b at its reduced size (``get_arch(...).reduced()``: 2
layers, d 128, 4 query heads over 2 kv heads, vocab 512): the JAX
package's random parameters cross as numpy
(``repro_torch.convert.lm_params_from_numpy``), then ``prefill`` and a
teacher-forced ``decode_step`` give the same logits as the JAX model's,
and ``ServeEngine`` the same greedy tokens as the JAX engine's.  The
port's wrappers run their kernels' plain PyTorch versions here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCHS as JARCHS  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs.base import ARCHS, get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "internlm2-1.8b"
# bf16 logits are bf16 numbers of magnitude up to ~4 (a bf16 step there is
# 1/32); two runs that round differently at a few of ~30 bf16 operations
# per layer differ by a few steps: 0.047 was the largest seen at seed 3
F32_TOL = 2e-4
BF16_TOL = 0.125


def _configs(compute_dtype="float32"):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype=compute_dtype)
    return jcfg, cfg


def _params(jcfg, cfg, seed):
    jp = jtfm.init_params(jcfg, jax.random.key(seed))
    return jp, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def test_configs_are_the_jax_packages():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jget_arch(name))
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(jget_arch(name).reduced())
        assert get_arch(name).param_count() == jget_arch(name).param_count()


def test_lm_params_round_trip():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, cfg, 0)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 10
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tfm.count_params(tp) == sum(x.size for x in jax.tree.leaves(jp))
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["attn"]["wqkv"] = tree["layers"]["attn"]["wqkv"][:1]
    with pytest.raises(ValueError, match="wqkv"):
        lm_params_from_numpy(cfg, tree, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    del tree["head"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, tree, "cpu")


def test_init_params_shapes_and_scales():
    cfg = get_arch(ARCH).reduced()
    p = tfm.init_params(cfg, seed=1, device="cpu")
    shapes = tfm.param_shapes(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), p,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) == \
        shapes
    d, ff = cfg.d_model, cfg.d_ff
    for w, std in ((p["embed"], 0.02), (p["head"], d ** -0.5),
                   (p["layers"]["attn"]["wqkv"], d ** -0.5),
                   (p["layers"]["mlp"]["w2"], ff ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.05
    assert torch.equal(p["final_norm"]["w"], torch.ones(d))
    again = tfm.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(again["layers"]["mlp"]["w1"],
                       p["layers"]["mlp"]["w1"])


@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_jax(compute_dtype, tol):
    """Prefill of 13 tokens into a 20-entry cache, then 10 teacher-forced
    decode steps, the last three past the cache (its last entry is
    overwritten, as ``dynamic_update_slice`` clamps the write)."""
    jcfg, cfg = _configs(compute_dtype)
    jp, tp = _params(jcfg, cfg, 3)
    tp = tfm.cast_params(cfg, tp)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    lj, cj = jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=20)
    lt, ct = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                         max_len=20)
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol, atol=tol)
    for step in range(10):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = jtfm.decode_step(jcfg, jp, jnp.asarray(tok), cj)
        lt, ct = tfm.decode_step(cfg, tp, torch.from_numpy(tok), ct)
        assert ct["len"] == int(cj["len"]) == 14 + step
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol,
                                   atol=tol, err_msg=f"step {step}")
    np.testing.assert_allclose(ct["k"].float().numpy(),
                               np.asarray(cj["k"], np.float32), rtol=tol,
                               atol=tol)


def _waves(vocab):
    rng = np.random.default_rng(0)
    return [dict(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                 max_new_tokens=5)
            for i, n in enumerate([3, 9, 5, 12, 7])]


@pytest.mark.parametrize("batch_size,max_len,extra", [
    (4, 64, ()),                      # the JAX package's own wave test
    (2, 16, ((5, 11, 9, None),)),     # a wave decoding past its cache
    (3, 32, ((5, 6, 7, "eos"),)),     # an EOS ending one member early
])
def test_serve_engine_greedy_tokens_equal_jax(batch_size, max_len, extra):
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, cfg, 0)
    reqs = _waves(cfg.vocab)
    rng = np.random.default_rng(1)
    for uid, n, budget, eos in extra:
        reqs.append(dict(uid=uid, prompt=rng.integers(
            0, cfg.vocab, (n,)).astype(np.int32), max_new_tokens=budget))
    jeng = JServeEngine(jcfg, jp, batch_size=batch_size, max_len=max_len)
    want = jeng.run([JRequest(**r) for r in reqs])
    if any(e[3] == "eos" for e in extra):
        # the third token of the last request becomes its EOS
        eos_tok = int(want[-1].tokens[2])
        reqs[-1]["eos_id"] = eos_tok
        want = jeng.run([JRequest(**r) for r in reqs])
        assert len(want[-1].tokens) <= 3
    eng = ServeEngine(cfg, tp, batch_size=batch_size, max_len=max_len,
                      device="cpu")
    got = eng.run([Request(**r) for r in reqs])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.prompt_len == w.prompt_len
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def _out_of_vocab_ids(vocab, rng, n):
    """n ids from each of: >= V, [-V, 0), < -V, and in range."""
    return np.concatenate([rng.integers(vocab, 3 * vocab, n),
                           rng.integers(-vocab, 0, n),
                           rng.integers(-4 * vocab, -vocab, n),
                           rng.integers(0, vocab, n),
                           [vocab, vocab - 1, -1, -vocab, -vocab - 1]]
                          ).astype(np.int32)


def test_embed_inputs_out_of_vocab_rows_match_jax():
    """Ids outside [0, V) read the rows JAX's gather reads (a negative id
    folded once, then clamped), row for row."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, cfg, 0)
    ids = _out_of_vocab_ids(cfg.vocab, np.random.default_rng(4), 6)
    toks = ids.reshape(1, -1)
    want = np.asarray(jtfm.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(
        toks)}))
    got = tfm.embed_inputs(cfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)
    rows = tfm.vocab_rows(torch.from_numpy(ids), cfg.vocab).numpy()
    V = cfg.vocab
    np.testing.assert_array_equal(rows, np.clip(np.where(ids < 0, ids + V,
                                                         ids), 0, V - 1))


def test_serve_engine_out_of_vocab_prompts_equal_jax():
    """Prompts holding ids >= V, in [-V, 0) and < -V are served as the
    JAX engine serves them: the same greedy tokens."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, cfg, 0)
    rng = np.random.default_rng(6)
    ids = _out_of_vocab_ids(cfg.vocab, rng, 3)
    reqs = [dict(uid=i, prompt=rng.permutation(ids)[:n],
                 max_new_tokens=4) for i, n in enumerate([3, 9, 17])]
    reqs.append(dict(uid=3, prompt=np.array([1, 2, cfg.vocab + 3], np.int32),
                     max_new_tokens=4))
    want = JServeEngine(jcfg, jp, batch_size=2, max_len=32).run(
        [JRequest(**r) for r in reqs])
    got = ServeEngine(cfg, tp, batch_size=2, max_len=32, device="cpu").run(
        [Request(**r) for r in reqs])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_serve_engine_sampling_is_seeded():
    cfg = get_arch(ARCH).reduced()
    p = tfm.init_params(cfg, seed=0, device="cpu")
    req = [Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                   max_new_tokens=6)]
    runs = [ServeEngine(cfg, p, max_len=32, greedy=False, seed=s,
                        device="cpu").run(req)[0].tokens for s in (4, 4, 5)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert len(runs[2]) == 6


def test_launcher_serves_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    assert out["reduced"] and out["device"] == "cpu"
    assert out["requests"] == 8 and out["tokens"] == 8 * 16
    assert [len(r.tokens) for r in out["results"]] == [16] * 8
    assert "served 8 requests, 128 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-76b"])
def test_configs_outside_the_slice_raise(name):
    cfg = get_arch(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11b"):
        tfm.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11b"):
        ServeEngine(cfg, {}, device="cpu")
