"""The LM families beyond internlm2 against the JAX package, on the CPU.

stablelm-1.6b (LayerNorm, SwiGLU, 32 heads over 32), starcoder2-7b
(LayerNorm, GELU, q/k/v and output biases, 36 heads over 4),
rwkv6-1.6b (LayerNorm, the RWKV6 time-mix and channel-mix) and
command-r-plus-104b (LayerNorm, SwiGLU, tied embeddings) at their reduced
sizes (``get_arch(...).reduced()``), with the JAX package's random
parameters carried across as numpy (``convert.lm_params_from_numpy``) and
inputs from numpy seeds.  Where the JAX init leaves a leaf constant (the
norms' weights and biases, the projection biases), it is redrawn at random
on both sides, so that every leaf is held to something.  The port's
wrappers run their kernels' plain versions here.

Tolerances: logits 2e-4 in f32 and 0.125 in bf16 (as
``test_torch_lm.py``), loss and gradients 1e-4 relative in f32 and
1e-2 / 3e-2 in bf16, and eight AdamW steps at ``test_torch_train.py``'s
f32 tolerances; LayerNorm and the GELU MLP alone at 2e-4 in f32 and
0.125 in bf16.  Greedy tokens are equal in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

FAMILIES = ["stablelm-1.6b", "starcoder2-7b", "rwkv6-1.6b",
            "command-r-plus-104b"]
LOGIT_TOL = {"float32": 2e-4, "bfloat16": 0.125}
GRAD_TOL = {"float32": dict(grad=1e-4, loss=1e-4),
            "bfloat16": dict(grad=3e-2, loss=1e-2)}
# RWKV6 in bf16: the port's gradient against JAX's bf16 one, per leaf (the
# two read 2.5-3.1 % apart at reduced(), the mu leaf the most)
RWKV_BF16_PAIR_TOL = 4e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# leaves the JAX init makes constant (ones, zeros): redrawn at random
CONSTANT_LEAVES = ("w", "b", "bqkv", "bo", "b1", "b2")


def _configs(name, compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jget_arch(name).reduced(),
                               compute_dtype=compute_dtype, **kw)
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


def _redraw(tree, rng):
    """The numpy tree with its constant leaves (norm weights and biases,
    projection biases) redrawn: weights 1 + 0.2 N(0, 1), biases 0.1 N(0,
    1)."""
    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if key in CONSTANT_LEAVES:
            base = 1.0 if key == "w" else 0.0
            scale = 0.2 if key == "w" else 0.1
            return (base + scale * rng.standard_normal(t.shape)).astype(
                t.dtype)
        return t
    return walk(tree, None)


def _params(jcfg, cfg, seed, redraw=True):
    """The JAX package's parameters (constant leaves redrawn) and the
    port's copy of them on the CPU."""
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                     jax.random.key(seed)))
    if redraw:
        tree = _redraw(tree, np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, lm_params_from_numpy(cfg, tree, "cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close(got, want, tol, what=""):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_param_shapes_are_the_jax_tree(name):
    jcfg, cfg = _configs(name)
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    shapes = tfm.param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == shapes
    p = tfm.init_params(cfg, seed=1, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) == \
        shapes
    assert [t.dtype for t in pytree.leaves(p)] == [
        torch.float32] * len(jax.tree.leaves(jp))
    assert tfm.count_params(p) == sum(x.size for x in jax.tree.leaves(jp))
    _, tp = _params(jcfg, cfg, 0, redraw=False)
    for a, b in zip(pytree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["ln1"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, tree, "cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_scales_and_seed(name):
    _, cfg = _configs(name)
    p = tfm.init_params(cfg, seed=1, device="cpu")
    d, ff = cfg.d_model, cfg.d_ff
    lp = p["layers"]
    want = [(p["embed"], 0.02)]
    if cfg.rwkv:
        want += [(lp["tm"]["Wr"], d ** -0.5), (lp["tm"]["Wv_cm"], ff ** -0.5),
                 (lp["tm"]["wB"], ssm.LORA_R ** -0.5), (lp["tm"]["u"], 0.1)]
        assert torch.equal(lp["tm"]["w0"], torch.full_like(lp["tm"]["w0"],
                                                           -2.0))
        mu = lp["tm"]["mu"]
        assert float(mu.min()) >= 0 and float(mu.max()) <= 0.5
    else:
        w2 = lp["mlp"]["fc2" if cfg.act == "gelu" else "w2"]
        want += [(lp["attn"]["wqkv"], d ** -0.5), (w2, ff ** -0.5)]
    for w, std in want:
        assert abs(float(w.std()) / std - 1) < 0.1, (w.shape, std)
    assert torch.equal(lp["ln1"]["w"], torch.ones_like(lp["ln1"]["w"]))
    assert torch.equal(lp["ln1"]["b"], torch.zeros_like(lp["ln1"]["b"]))
    again = tfm.init_params(cfg, seed=1, device="cpu")
    for a, b in zip(pytree.leaves(p), pytree.leaves(again)):
        assert torch.equal(a, b)


def test_cast_params_keeps_the_f32_leaves():
    """In bf16 compute, LayerNorm's w and b and RWKV6's w0, wA, wB, u and
    ln_w stay f32 (the JAX package reads them so); every other leaf is
    cast once."""
    for name in ("rwkv6-1.6b", "starcoder2-7b"):
        _, cfg = _configs(name, "bfloat16")
        p = tfm.init_params(cfg, device="cpu")
        c = tfm.cast_params(cfg, p)
        for path in (("final_norm", "w"), ("final_norm", "b"),
                     ("layers", "ln1", "b"), ("layers", "ln2", "w")):
            a, b = p, c
            for k in path:
                a, b = a[k], b[k]
            assert b is a
        if cfg.rwkv:
            for k, t in c["layers"]["tm"].items():
                want = torch.float32 if k in ssm.F32_LEAVES else \
                    torch.bfloat16
                assert t.dtype == want, k
        else:
            assert c["layers"]["attn"]["bqkv"].dtype == torch.bfloat16
            assert c["layers"]["mlp"]["fc1"].dtype == torch.bfloat16
        assert c["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# LayerNorm and the GELU MLP alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_matches_jax(dtn, bias):
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal((3, 7, 96))).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(96)).astype(np.float32)
    b = (0.2 * rng.standard_normal(96)).astype(np.float32) if bias else None
    jx = jnp.asarray(x).astype(JDT[dtn])
    want = jlayers.layernorm(jx, jnp.asarray(w),
                             None if b is None else jnp.asarray(b))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtn])
    got = layers.layernorm(tx, torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b))
    assert got.dtype == TDT[dtn] and got.shape == tx.shape
    _close(got, want.astype(jnp.float32), LOGIT_TOL[dtn])
    if dtn == "bfloat16":
        # the affine part in bf16 as JAX applies it: equal to a step or
        # two of bf16, where F.layer_norm's f32 affine part rounds once
        diff = (got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert np.abs(diff).max() <= 2 ** -5


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax_tanh_form(dtn):
    """``gelu(x @ fc1 + b1) @ fc2 + b2`` with jax.nn.gelu's default tanh
    form; the erf form differs by more than the f32 tolerance here."""
    jcfg, cfg = _configs("starcoder2-7b", dtn)
    jp, tp = _params(jcfg, cfg, 2)
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    tm = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    x = 1.5 * np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(JDT[dtn])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtn])
    want = np.array(jlayers.mlp_block(jcfg, jm, jx).astype(jnp.float32))
    got = layers.mlp_block(cfg, tm, tx)
    assert got.dtype == TDT[dtn]
    _close(got, want, LOGIT_TOL[dtn])
    if dtn == "float32":
        h = tx @ tm["fc1"] + tm["b1"]
        erf = torch.nn.functional.gelu(h) @ tm["fc2"] + tm["b2"]
        assert float((erf - torch.from_numpy(want)).abs().max()) > \
            LOGIT_TOL[dtn]


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_layernorm_and_gelu_mlp_grads_match_jax(dtn):
    """Gradients of sum(mlp(layernorm(x)) * c)², a sum without
    cancellation, by x, w, b and every MLP weight, against jax.grad."""
    jcfg, cfg = _configs("starcoder2-7b", dtn)
    jp, tp = _params(jcfg, cfg, 4)
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    jn = jax.tree.map(lambda a: a[0], jp["layers"]["ln1"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)

    def jf(args):
        xx, n, m = args
        y = jlayers.mlp_block(jcfg, m, jlayers.layernorm(
            xx.astype(JDT[dtn]), n["w"], n["b"]))
        return jnp.sum(jnp.square(y.astype(jnp.float32) * c))
    jv, (jgx, jgn, jgm) = jax.value_and_grad(jf)((jnp.asarray(x), jn, jm))
    tx = torch.from_numpy(x).requires_grad_(True)
    tn = {k: v[0].clone().requires_grad_(True)
          for k, v in tp["layers"]["ln1"].items()}
    tmm = {k: v[0].clone().requires_grad_(True)
           for k, v in tp["layers"]["mlp"].items()}
    y = layers.mlp_block(cfg, tmm, layers.layernorm(tx.to(TDT[dtn]), tn["w"],
                                                    tn["b"]))
    loss = torch.square(y.float() * torch.from_numpy(c)).sum()
    loss.backward()
    tol = GRAD_TOL[dtn]
    assert abs(float(loss.detach()) - float(jv)) <= tol["loss"] * float(jv)
    assert _rel(tx.grad.numpy(), jgx) <= tol["grad"]
    for k in tn:
        assert _rel(tn[k].grad.numpy(), jgn[k]) <= tol["grad"], k
    for k in tmm:
        assert _rel(tmm[k].grad.numpy(), jgm[k]) <= tol["grad"], k


# ---------------------------------------------------------------------------
# serving: prefill and decode, the engine
# ---------------------------------------------------------------------------
def _hold_state(ct, cj, tol):
    if "S" in cj:
        for k in ("S", "x_tm", "x_cm"):
            assert tuple(ct[k].shape) == cj[k].shape, k
            assert ct[k].dtype == TDT[str(cj[k].dtype)], k
            _close(ct[k], cj[k], tol, k)
        assert "len" not in ct
    else:
        assert ct["len"] == int(cj["len"])
        for k in ("k", "v"):
            _close(ct[k], cj[k], tol, k)


def _prefill_and_decode(jcfg, cfg, jp, tp, S, max_len, steps, tol, seed=0):
    tp = tfm.cast_params(cfg, tp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    lj, cj = jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                          max_len=max_len)
    lt, ct = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                         max_len=max_len)
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab)
    _close(lt, lj, tol, "prefill")
    _hold_state(ct, cj, tol)
    jdecode = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = jdecode(jp, jnp.asarray(tok), cj)
        lt, ct = tfm.decode_step(cfg, tp, torch.from_numpy(tok), ct)
        _close(lt, lj, tol, f"step {step}")
    _hold_state(ct, cj, tol)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_jax(name, dtn):
    """Prefill (dense: 13 tokens into a 20-entry cache, the last 3 of 10
    teacher-forced decode steps past it; rwkv6: 64 tokens, two chunks
    with the state carried), then 10 decode steps; the logits, the KV
    caches and the RWKV6 states against the JAX package's."""
    jcfg, cfg = _configs(name, dtn)
    jp, tp = _params(jcfg, cfg, 3)
    S = 64 if cfg.rwkv else 13
    _prefill_and_decode(jcfg, cfg, jp, tp, S, 20, 10, LOGIT_TOL[dtn])


def test_gqa_group_of_nine_matches_jax():
    """starcoder2's 9 query heads per kv head at narrow width: 18 heads
    over 2, hd 16."""
    kw = dict(n_heads=18, n_kv_heads=2, d_model=288)
    jcfg, cfg = _configs("starcoder2-7b", **kw)
    assert cfg.n_heads // cfg.n_kv_heads == 9 and cfg.head_dim == 16
    jp, tp = _params(jcfg, cfg, 5)
    _prefill_and_decode(jcfg, cfg, jp, tp, 21, 32, 6, LOGIT_TOL["float32"])


def _reqs(vocab, lens, budget=5, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                 max_new_tokens=budget) for i, n in enumerate(lens)]


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_engine_greedy_tokens_equal_jax(name):
    """Waves of 3 (prompts padded to 8 and to 12), greedy, f32."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg, 0)
    reqs = _reqs(cfg.vocab, [3, 9, 5, 12, 7])
    want = JServeEngine(jcfg, jp, batch_size=3, max_len=32).run(
        [JRequest(**r) for r in reqs])
    got = ServeEngine(cfg, tp, batch_size=3, max_len=32, device="cpu").run(
        [Request(**r) for r in reqs])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.prompt_len == w.prompt_len and len(g.tokens) == 5
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


# ---------------------------------------------------------------------------
# RWKV6: chunks, lengths, the carried state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 7, 32, 64, 96])
def test_rwkv6_prefill_lengths_match_jax(S):
    """One chunk below 32 (Q = S), exactly one, and two and three chunks
    with the state carried across."""
    jcfg, cfg = _configs("rwkv6-1.6b")
    jp, tp = _params(jcfg, cfg, S)
    _prefill_and_decode(jcfg, cfg, jp, tp, S, 0, 1, LOGIT_TOL["float32"],
                        seed=S)


def test_rwkv6_length_off_the_chunk_raises_in_both():
    jcfg, cfg = _configs("rwkv6-1.6b")
    jp, tp = _params(jcfg, cfg, 0)
    toks = np.zeros((1, 33), np.int32)
    with pytest.raises(AssertionError):
        jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=0)
    with pytest.raises(ValueError, match="33 tokens is not a multiple of the "
                       "chunk 32"):
        tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, max_len=0)
    assert ssm.chunk_of(31) == 31 and ssm.chunk_of(96) == 32
    x = torch.zeros((1, 40, cfg.d_model))
    lp = tfm.layer(tp, 0)["tm"]
    with pytest.raises(ValueError, match="chunk 32"):
        ssm.rwkv6_timemix(cfg, lp, x)
    with pytest.raises(ValueError, match="chunk 16"):
        ssm.rwkv6_timemix(cfg, lp, x[:, :24], chunk=16)


@pytest.mark.parametrize("dtn,tol", [("float32", 2e-5), ("bfloat16", 0.125)])
def test_rwkv6_decode_after_prefill_equals_a_longer_prefill(dtn, tol):
    """Prefill of 64 tokens then 32 teacher-forced decode steps gives the
    last logits and the state of one prefill over all 96: the state
    crosses the chunk boundary and the prefill/decode boundary alike."""
    _, cfg = _configs("rwkv6-1.6b", dtn)
    tp = tfm.cast_params(cfg, tfm.init_params(cfg, seed=2, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 96)).astype(np.int32))
    want, cw = tfm.prefill(cfg, tp, {"tokens": toks}, max_len=0)
    got, c = tfm.prefill(cfg, tp, {"tokens": toks[:, :64]}, max_len=0)
    for t in range(64, 96):
        S0 = c["S"]
        got, c2 = tfm.decode_step(cfg, tp, toks[:, t:t + 1], c)
        assert c2 is c and c["S"] is S0            # in place
    _close(got, want, tol)
    for k in ("S", "x_tm", "x_cm"):
        _close(c[k], cw[k], tol, k)


def test_rwkv6_masked_exponents_stay_out_of_the_output():
    """A decay steep enough that the masked entries' exponents overflow
    (exp -> inf) leaves the output finite: the mask is applied with
    ``where``, not a product with 0/1."""
    _, cfg = _configs("rwkv6-1.6b")
    p = tfm.layer(tfm.init_params(cfg, seed=0, device="cpu"), 0)["tm"]
    p = dict(p, w0=torch.full_like(p["w0"], 4.0))   # -exp(4 + ...) per token
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32))
    y, st = ssm.rwkv6_timemix(cfg, p, x)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(
        st["S"]).all())


# ---------------------------------------------------------------------------
# training: loss, gradients, AdamW steps
# ---------------------------------------------------------------------------
def _batch(cfg, S=128, B=2, step=0):
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 seed=0).batch_for_step(step)
    batch["labels"][0, :5] = -1
    return batch


def _jax_loss_and_grads(jcfg, jp, batch):
    return jax.value_and_grad(lambda p: jtfm.loss_fn(jcfg, p, batch),
                              has_aux=True)(jp)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name, dtn):
    """Every gradient leaf within the tolerance of JAX's, relative
    Frobenius.  RWKV6 in bf16 is held to JAX's f32 gradient instead: both
    packages' bf16 gradients lie 4-6 % from it (the time-mix rounds each
    of r, k, v, g, the five lerps and the gate to bf16), and two such
    errors differ by ~3 %, the tolerance itself; the port's may be no
    farther from the f32 gradient than 1.1 x JAX's bf16 one is, and no
    farther from JAX's bf16 gradient than :data:`RWKV_BF16_PAIR_TOL`."""
    jcfg, cfg = _configs(name, dtn)
    tol = GRAD_TOL[dtn]
    jp, tp = _params(jcfg, cfg, 1)
    batch = _batch(cfg)
    (jl, jaux), jg = _jax_loss_and_grads(jcfg, jp, batch)
    truth = None
    if cfg.rwkv and dtn == "bfloat16":
        jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
        truth = jax.tree.leaves(_jax_loss_and_grads(jcfg32, jp, batch)[1])
    flat, treedef = pytree.flatten(tp)
    leaves = [x.requires_grad_(True) for x in flat]
    loss, aux = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= tol["loss"] * abs(float(jl))
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 2 * 128 - 5
    assert float(aux["aux"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for i, (g, w, n) in enumerate(zip(grads, jleaves, names)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all()), n
        if truth is None:
            assert _rel(g.numpy(), w) <= tol["grad"], (n, _rel(g.numpy(), w))
        else:
            err, jerr = _rel(g.numpy(), truth[i]), _rel(w, truth[i])
            assert err <= 1.1 * jerr, (n, err, jerr)
            pair = _rel(g.numpy(), w)
            assert pair <= RWKV_BF16_PAIR_TOL, (n, pair)


@pytest.mark.parametrize("name", FAMILIES)
def test_eight_train_steps_match_jax(name):
    jcfg, cfg = _configs(name)
    jp = jtfm.init_params(jcfg, jax.random.key(2))
    js = jadamw.init(jp)
    tp, ts = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, js), "cpu")
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    src = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                               seed=0)
    jstep = jloop.make_train_step(jcfg, jadamw.OptConfig(**ocfg._asdict()),
                                  donate=False)
    step = train_loop.make_train_step(cfg, ocfg)
    jstate, state = (jp, js), (tp, ts)
    tol = GRAD_TOL["float32"]
    for i in range(8):
        batch = src.batch_for_step(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            tol["loss"] * abs(float(jm["loss"]))
        assert _rel(m["grad_norm"].numpy(), jm["grad_norm"]) <= tol["grad"]
    assert int(state[1].step) == int(jstate[1].step) == 8
    for a, b in zip(pytree.leaves(state[0]), jax.tree.leaves(jstate[0])):
        assert _rel(a.numpy(), b) <= 1e-4


def test_rwkv6_jax_ssm_and_port_agree_on_one_block():
    """The time-mix and channel-mix of one layer alone, f32, with a
    carried state, against the JAX functions."""
    jcfg, cfg = _configs("rwkv6-1.6b")
    jp, tp = _params(jcfg, cfg, 6)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["tm"])
    tl = tfm.layer(tp, 1)["tm"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    d, H, P = ssm.rwkv6_dims(cfg)
    st = dict(S=rng.standard_normal((2, H, P, P)).astype(np.float32),
              x_tm=rng.standard_normal((2, 1, d)).astype(np.float32),
              x_cm=rng.standard_normal((2, 1, d)).astype(np.float32))
    jy, jst = jssm.rwkv6_timemix(jcfg, jl, jnp.asarray(x), state={
        k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = ssm.rwkv6_timemix(cfg, tl, torch.from_numpy(x), state={
        k: torch.from_numpy(v) for k, v in st.items()})
    _close(ty, jy, 2e-4)
    _close(tst["S"], jst["S"], 2e-4)
    jy, _ = jssm.rwkv6_channelmix(jcfg, jl, jnp.asarray(x), state={
        "x_cm": jnp.asarray(st["x_cm"])})
    ty, tst = ssm.rwkv6_channelmix(cfg, tl, torch.from_numpy(x), state={
        "x_cm": torch.from_numpy(st["x_cm"])})
    _close(ty, jy, 2e-4)
    np.testing.assert_array_equal(tst["x_cm"].numpy(), x[:, -1:])


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_launchers_on_the_cpu(name, tmp_path, capsys):
    out = launch_serve.main(["--arch", name, "--device", "cpu", "--requests",
                             "4", "--max-new-tokens", "4"])
    assert out["reduced"] and out["device"] == "cpu"
    assert out["tokens"] == 16 and [len(r.tokens) for r in
                                    out["results"]] == [4] * 4
    assert f"arch={name} reduced=True" in capsys.readouterr().out
    out = launch_train.main(["--arch", name, "--device", "cpu", "--steps",
                             "3", "--seq", "32", "--batch", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert out["reduced"] and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"done: arch={name} reduced=True resumed=False")
