"""The MoE models against the JAX package, on the CPU.

llama4-scout-17b-a16e (16 experts top-1, a shared expert) and
kimi-k2-1t-a32b (384 experts top-8, a shared expert, one leading dense
layer) at their reduced sizes (``get_arch(...).reduced()``: 4 experts,
top-1 and top-2, groups of 64 tokens), with the JAX package's random
parameters carried across as numpy (``convert.lm_params_from_numpy``) and
inputs from numpy seeds.  The norms' weights, which the JAX init leaves
at 1, are redrawn at random on both sides, as in
``test_torch_lm_families.py``.  The port's wrappers run their kernels'
plain versions here.

Tolerances: the MoE block alone 2e-4 in f32 and 0.125 in bf16, its aux
loss 1e-6; logits 2e-4 in f32; loss, aux and gradients 1e-4 relative in
f32; eight AdamW steps at ``test_torch_train.py``'s f32 tolerances;
attention at hd 112 at ``test_torch_lm_kernels.py``'s 3e-5 / 3e-2.  The
routing decisions (experts, their order, the capacity mask) and the
greedy tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
LOGIT_TOL = {"float32": 2e-4, "bfloat16": 0.125}
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs(name, compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jget_arch(name).reduced(),
                               compute_dtype=compute_dtype, **kw)
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


def _redraw(tree, rng):
    """The numpy tree with the norms' weights redrawn (1 + 0.2 N(0, 1))."""
    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if key == "w":
            return (1.0 + 0.2 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree, None)


def _params(jcfg, cfg, seed, redraw=True):
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                     jax.random.key(seed)))
    if redraw:
        tree = _redraw(tree, np.random.default_rng(seed + 100))
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(cfg, tree,
                                                                 "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def f32_model(request):
    """(jcfg, cfg, JAX params, port params) of one arch, f32, seed 0."""
    jcfg, cfg = _configs(request.param)
    return (jcfg, cfg, *_params(jcfg, cfg, 0))


def _port_params(cfg, seed):
    """The port's seeded parameters and the same values as a JAX tree (a
    cheaper init than JAX's, whose every random draw compiles)."""
    tp = tfm.init_params(cfg, seed=seed, device="cpu")
    return jax.tree.map(jnp.asarray, pytree.tree_map(
        lambda t: t.numpy(), tp)), tp


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
def test_check_supported_takes_moe_and_refuses_the_rest():
    for name in ARCHS:
        tfm.check_supported(get_arch(name))
        tfm.check_supported(get_arch(name).reduced())
    for name, what in (("whisper-medium", "encoder-decoder"),
                       ("internvl2-76b", "frontend")):
        with pytest.raises(NotImplementedError, match=what):
            tfm.check_supported(get_arch(name))
    for name in ARCHS:
        cfg, jcfg = get_arch(name), jget_arch(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(jcfg.reduced())
    assert get_arch("kimi-k2-1t-a32b").head_dim == 112


def test_param_shapes_are_the_jax_tree(f32_model):
    jcfg, cfg, jp, _ = f32_model
    shapes = tfm.param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == shapes
    assert ("dense_layers" in shapes) == bool(cfg.n_dense_layers)
    p = tfm.init_params(cfg, seed=1, device="cpu")
    assert pytree.tree_map(lambda t: tuple(t.shape), p) == shapes
    assert tfm.count_params(p) == sum(x.size for x in jax.tree.leaves(jp))
    _, tp = _params(jcfg, cfg, 0, redraw=False)
    for a, b in zip(pytree.leaves(tp), jax.tree.leaves(
            jtfm.init_params(jcfg, jax.random.key(0)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["moe"]["router"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, tree, "cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_scales_and_seed(name):
    _, cfg = _configs(name)
    p = tfm.init_params(cfg, seed=1, device="cpu")
    d, ff = cfg.d_model, cfg.moe_d_ff
    m = p["layers"]["moe"]
    for w, std in ((m["router"], d ** -0.5), (m["w1"], d ** -0.5),
                   (m["w3"], d ** -0.5), (m["w2"], ff ** -0.5),
                   (m["shared"]["w2"], ff ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.1, (w.shape, std)
    again = tfm.init_params(cfg, seed=1, device="cpu")
    for a, b in zip(pytree.leaves(p), pytree.leaves(again)):
        assert torch.equal(a, b)
    # bf16 parameters: the expert stacks drawn a matrix at a time
    pb = tfm.init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                         seed=1, device="cpu")
    w1 = pb["layers"]["moe"]["w1"]
    assert w1.dtype == torch.bfloat16
    assert abs(float(w1.float().std()) / d ** -0.5 - 1) < 0.1


def test_cast_params_keeps_the_router():
    """In bf16 compute the router stays at the parameters' dtype (the
    tensor itself: f32 under the standard configs, bf16 when they are);
    the experts, the shared expert and the dense layers' matrices are
    cast once, their norms kept."""
    for pdt in ("float32", "bfloat16"):
        _, cfg = _configs("kimi-k2-1t-a32b", "bfloat16", param_dtype=pdt)
        p = tfm.init_params(cfg, device="cpu")
        c = tfm.cast_params(cfg, p)
        assert c["layers"]["moe"]["router"] is p["layers"]["moe"]["router"]
        assert c["layers"]["moe"]["router"].dtype == TDT[pdt]
        for path in (("layers", "ln2", "w"), ("dense_layers", "ln1", "w")):
            assert c[path[0]][path[1]]["w"] is p[path[0]][path[1]]["w"]
        for t in (c["layers"]["moe"]["w1"], c["layers"]["moe"]["shared"]["w3"],
                  c["dense_layers"]["mlp"]["w1"], c["embed"]):
            assert t.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the MoE block alone
# ---------------------------------------------------------------------------
def _jax_route(jcfg, jm, xg):
    """The JAX block's routing (moe.py's lines, on its f32 logits): top-k
    experts and the capacity mask of each (token, choice)."""
    E, k = jcfg.n_experts, jcfg.top_k
    Sg = xg.shape[1]
    probs = jax.nn.softmax(xg.astype(jnp.float32) @
                           jm["router"].astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    C = int(np.ceil(k * Sg / E * jcfg.capacity_factor))
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(xg.shape[0], Sg * k, E), axis=1) \
        .reshape(*idx.shape, E) - onehot
    keep = ((pos < C) & (onehot > 0)).any(-1)
    return np.asarray(idx), np.asarray(keep)


def _layer_moe(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]["moe"]),
            pytree.tree_map(lambda t: t[i], tp["layers"]["moe"]))


# (B, S, capacity_factor): two groups of 64; capacity 0.5 (drops); decode
# (T = B = 4 tokens: one group of 4)
BLOCK_CASES = {"groups": (4, 32, 1.25), "drops": (4, 32, 0.5),
               "decode": (4, 1, 1.25)}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_moe_block_matches_jax(f32_model, dtn, case):
    jcfg, cfg, jp, tp = f32_model
    B, S, cf = BLOCK_CASES[case]
    jc = dataclasses.replace(jcfg, capacity_factor=cf, compute_dtype=dtn)
    c = dataclasses.replace(cfg, capacity_factor=cf, compute_dtype=dtn)
    jm, tm = _layer_moe(jp, tp, 1 if cfg.n_dense_layers == 0 else 0)
    x = np.random.default_rng([B, S, len(dtn)]).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(JDT[dtn])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtn])
    yj, aj = jmoe.moe_block(jc, jm, jx)
    yt, at = moe.moe_block(c, tm, tx)
    assert yt.dtype == TDT[dtn] and yt.shape == tx.shape
    _close(yt, yj.astype(jnp.float32), LOGIT_TOL[dtn])
    assert at.dtype == torch.float32
    assert abs(float(at) - float(aj)) <= AUX_TOL
    Sg = moe.group_size(c, B * S)
    r = moe.route(c, tm, tx.reshape(-1, Sg, cfg.d_model))
    idx, keep = _jax_route(jc, jm, jx.reshape(-1, Sg, cfg.d_model))
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.C == moe.capacity(c, Sg)
    if case == "drops":
        assert not keep.all() and not r.keep.numpy().all()
    if case == "decode":
        assert Sg == B


@pytest.mark.parametrize("name", ARCHS)
def test_topk_tie_takes_the_lower_expert_first(name):
    """A router whose columns 1 and 2 are equal (and large): every token
    sees the two experts tie, at the top for about half of them; the
    port orders them as ``jax.lax.top_k`` does (expert 1 first), so the
    choices, the outputs and the aux loss (its top-1 share) agree."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg, 5)
    jm, tm = _layer_moe(jp, tp, 0)
    router = np.array(tm["router"])
    router[:, 1] = router[:, 2] = 4 * router[:, 1]
    jm = dict(jm, router=jnp.asarray(router))
    tm = dict(tm, router=torch.from_numpy(router))
    x = np.random.default_rng(7).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    yj, aj = jmoe.moe_block(jcfg, jm, jnp.asarray(x))
    yt, at = moe.moe_block(cfg, tm, torch.from_numpy(x))
    r = moe.route(cfg, tm, torch.from_numpy(x).reshape(1, 64, -1))
    idx, _ = _jax_route(jcfg, jm, jnp.asarray(x).reshape(1, 64, -1))
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    tied = r.probs[..., 1] == r.probs[..., 2]
    assert bool(tied.all())
    top = (r.idx[..., 0] == 1)
    assert 10 < int(top.sum()) and not bool((r.idx[..., 0] == 2).any())
    _close(yt, yj, LOGIT_TOL["float32"])
    assert abs(float(at) - float(aj)) <= AUX_TOL


def test_queue_order_and_drops():
    """Queue places count the earlier (token, choice) pairs in the
    flattened order: token 0's second choice (expert 0) queues ahead of
    token 1's first; the capacity is the JAX block's ceiling."""
    idx = torch.tensor([[[2, 0], [0, 2], [2, 1]]])          # [1, 3, 2]
    np.testing.assert_array_equal(moe.queue_positions(idx, 3).numpy(),
                                  [[[0, 0], [1, 1], [2, 0]]])
    _, cfg = _configs("kimi-k2-1t-a32b", capacity_factor=0.5)
    assert moe.capacity(cfg, 3) == 1                        # ceil(0.75)


@pytest.mark.parametrize("name", ARCHS)
def test_decide_is_the_tail_of_route(name):
    """``decide`` on ``route``'s own probabilities and experts gives
    ``route``'s decision field for field; on other experts (the choices
    rolled by one place, a reordering) its gates are those experts'
    probabilities renormalised, its queue places and mask recounted."""
    _, cfg = _configs(name, capacity_factor=0.5)
    tp = tfm.init_params(cfg, seed=3, device="cpu")
    tm = pytree.tree_map(lambda t: t[0], tp["layers"]["moe"])
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    r = moe.route(cfg, tm, x)
    d = moe.decide(cfg, r.probs, r.idx)
    for a, b in zip(r[:-1], d[:-1]):
        assert torch.equal(a, b)
    assert r.C == d.C
    idx = r.idx.roll(1, dims=-1) if cfg.top_k > 1 else \
        (r.idx + 1) % cfg.n_experts
    f = moe.decide(cfg, r.probs, idx)
    g = r.probs.gather(-1, idx)
    torch.testing.assert_close(f.gates, g / g.sum(-1, keepdim=True))
    assert torch.equal(f.pos, moe.queue_positions(idx, cfg.n_experts))
    assert torch.equal(f.keep, f.pos < r.C) and not bool(f.keep.all())


@pytest.mark.parametrize("name", ARCHS)
def test_group_size_error_where_jax_asserts(name):
    """B = 4, S = 27: 108 tokens do not split into groups of 64: JAX's
    prefill asserts, the port's raises ``ValueError`` naming both."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg, 0, redraw=False)
    toks = np.zeros((4, 27), np.int32)
    with pytest.raises(AssertionError):
        jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=32)
    with pytest.raises(ValueError, match="108 tokens do not split into "
                       "groups of 64"):
        tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, max_len=32)


# ---------------------------------------------------------------------------
# serving: prefill and decode, the engine
# ---------------------------------------------------------------------------
def _prefill_and_decode(jcfg, cfg, jp, tp, B, S, max_len, steps, tol):
    tp = tfm.cast_params(cfg, tp)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lj, cj = jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                          max_len=max_len)
    lt, ct = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                         max_len=max_len)
    assert lt.dtype == torch.float32 and lt.shape == (B, cfg.vocab)
    _close(lt, lj, tol, "prefill")
    jdecode = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        lj, cj = jdecode(jp, jnp.asarray(tok), cj)
        lt, ct = tfm.decode_step(cfg, tp, torch.from_numpy(tok), ct)
        _close(lt, lj, tol, f"step {step}")
    assert ct["len"] == int(cj["len"]) == S + steps
    for k in ("k", "v"):
        assert ct[k].shape[0] == cfg.n_layers
        _close(ct[k], cj[k], tol, k)


def test_prefill_and_decode_match_jax(f32_model):
    """B = 2, S = 32 (one group of 64), then 4 teacher-forced decode
    steps (groups of 2); logits and both caches (the dense layer's and
    the MoE layers')."""
    _prefill_and_decode(*f32_model, 2, 32, 40, 4, LOGIT_TOL["float32"])


def test_head_dim_112_matches_jax():
    """kimi-k2's head dim 112 and G = 8 at a narrow width (8 heads over 1,
    d 896): a prefill (2 x 16) against the JAX package, and the plain
    attention at hd 112 against the JAX layers' attention."""
    jcfg, cfg = _configs("kimi-k2-1t-a32b", d_model=896, n_heads=8,
                         n_kv_heads=1)
    assert cfg.head_dim == 112 and cfg.n_heads // cfg.n_kv_heads == 8
    jp, tp = _port_params(cfg, 9)
    _prefill_and_decode(jcfg, cfg, jp, tp, 2, 16, 20, 0, LOGIT_TOL["float32"])
    rng = np.random.default_rng(11)
    for dtn, tol in (("float32", 3e-5), ("bfloat16", 3e-2)):
        q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
            (2, 27, 8, 112), (2, 40, 1, 112), (2, 40, 1, 112)))
        jq, jk, jv = (jnp.asarray(a).astype(JDT[dtn]) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(TDT[dtn]) for a in (jq, jk, jv))
        want = jlayers.flash_attention(jq, jk, jv, causal=True, q_offset=13,
                                       kv_len=40, q_block=64, kv_block=64)
        got = fa.flash_attention_cuda(tq, tk, tv, causal=True, q_offset=13,
                                      kv_len=40)
        _close(got, want.astype(jnp.float32), tol)


def _reqs(vocab, lens, budget=5, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                 max_new_tokens=budget) for i, n in enumerate(lens)]


def test_serve_engine_greedy_tokens_equal_jax(f32_model):
    """Waves of 2 (prompts padded to 8 and 32: at most 64 tokens, one MoE
    group), greedy, f32."""
    jcfg, cfg, jp, tp = f32_model
    reqs = _reqs(cfg.vocab, [3, 32, 5, 30])
    want = JServeEngine(jcfg, jp, batch_size=2, max_len=40).run(
        [JRequest(**r) for r in reqs])
    got = ServeEngine(cfg, tp, batch_size=2, max_len=40, device="cpu").run(
        [Request(**r) for r in reqs])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.prompt_len == w.prompt_len and len(g.tokens) == 5
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


# ---------------------------------------------------------------------------
# training: loss, aux, gradients, AdamW steps, checkpoints
# ---------------------------------------------------------------------------
def test_loss_aux_and_grads_match_jax(f32_model):
    """batch 2 x seq 64 (two groups of 64), f32: the loss (with 0.01 x
    aux), the summed aux and every gradient leaf within 1e-4 relative."""
    jcfg, cfg, jp, tp = f32_model
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                                 seed=0).batch_for_step(0)
    batch["labels"][0, :5] = -1
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    flat, treedef = pytree.flatten(tp)
    leaves = [x.requires_grad_(True) for x in flat]
    loss, aux = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jl)) <= GRAD_TOL * abs(float(jl))
    assert float(aux["aux"].detach()) > 0
    assert abs(float(aux["aux"].detach()) - float(jaux["aux"])) <= AUX_TOL
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 2 * 64 - 5
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w, n in zip(grads, jleaves, names):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), n
        assert _rel(g.numpy(), w) <= GRAD_TOL, (n, _rel(g.numpy(), w))
    i = names.index("['layers']['moe']['router']")
    assert float(grads[i].abs().max()) > 0       # aux reaches the router


def test_eight_train_steps_match_jax():
    """kimi-k2 (its dense and MoE stacks, top-2), f32, batch 2 x seq 64."""
    jcfg, cfg = _configs("kimi-k2-1t-a32b")
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
    for i in range(8):
        batch = src.batch_for_step(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            GRAD_TOL * abs(float(jm["loss"]))
        assert _rel(m["grad_norm"].numpy(), jm["grad_norm"]) <= GRAD_TOL
    assert int(state[1].step) == int(jstate[1].step) == 8
    for a, b in zip(pytree.leaves(state[0]), jax.tree.leaves(jstate[0])):
        assert _rel(a.numpy(), b) <= 1e-4


def test_moe_training_state_crosses_checkpoints(tmp_path):
    """kimi-k2's reduced state (its dense and MoE stacks): JAX's (params,
    OptState) after an update restores in the port leaf for leaf, and the
    port's restores in JAX."""
    jcfg, cfg = _configs("kimi-k2-1t-a32b")
    jp, _ = _port_params(cfg, 0)
    js = jadamw.init(jp)
    like = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, js), "cpu")
    assert "dense_layers" in like[0] and "dense_layers" in like[1].m
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jp)
    ocfg = jadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = jax.jit(lambda g, s, p: jadamw.update(ocfg, g, s, p))(
        g, js, jp)[:2]                  # one compile, not one an operation
    jckpt.save(str(tmp_path / "j"), 1, state)
    step, back = ckpt.restore(str(tmp_path / "j"), like)
    assert step == 1
    for a, b in zip(pytree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p, s, _ = adamw.update(adamw.OptConfig(**ocfg._asdict()),
                           pytree.tree_map(lambda x: torch.from_numpy(
                               np.array(x)), g), like[1], like[0])
    ckpt.save(str(tmp_path / "t"), 1, (p, s))
    step, jback = jckpt.restore(str(tmp_path / "t"), (jp, js))
    assert step == 1
    for a, b in zip(pytree.leaves((p, s)), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the launchers and the attention wrapper's head dims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_launchers_on_the_cpu(name, tmp_path, capsys):
    """``launch.serve`` with waves of 2; its default waves of 4 (4 x 25
    tokens) raise the group error, as JAX's launcher asserts;
    ``launch.train --reduced`` takes 3 finite steps."""
    with pytest.raises(ValueError, match="100 tokens do not split"):
        launch_serve.main(["--arch", name, "--device", "cpu"])
    out = launch_serve.main(["--arch", name, "--device", "cpu",
                             "--batch-size", "2", "--requests", "4",
                             "--max-new-tokens", "4"])
    assert out["reduced"] and out["device"] == "cpu"
    assert [len(r.tokens) for r in out["results"]] == [4] * 4
    assert f"arch={name} reduced=True" in capsys.readouterr().out
    out = launch_train.main(["--arch", name, "--device", "cpu", "--reduced",
                             "--steps", "3", "--seq", "32", "--batch", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert out["reduced"] and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"done: arch={name} reduced=True resumed=False")


def test_attention_head_dims_the_kernels_take(monkeypatch):
    """On tensors off the CPU (here: meta, which no kernel runs) the
    wrapper checks before it builds or launches: hd 96 has no
    instantiation and raises, forward and backward (no fall-back to the
    plain version); hd 112 is a width of both, so the backward passes its
    check and goes on to build the kernels."""
    assert 112 in fa.FWD_HEAD_DIMS and 112 in fa.BWD_HEAD_DIMS
    assert set(fa.BWD_HEAD_DIMS) == set(fa.FWD_HEAD_DIMS)

    def qkv(hd, dt=torch.bfloat16):
        return (torch.empty((1, 27, 8, hd), device="meta", dtype=dt),
                torch.empty((1, 27, 1, hd), device="meta", dtype=dt))
    q, k = qkv(96)
    with pytest.raises(ValueError, match=r"head dims \(16, 32, 64, 112, "
                       r"128\).*hd=96"):
        fa.flash_attention_cuda(q, k, k)
    lse = torch.empty((1, 8, 27), device="meta")
    with pytest.raises(ValueError, match=r"attention backward takes head "
                       r"dims \(16, 32, 64, 112, 128\).*hd=96"):
        fa.flash_attention_backward_cuda(q, k, k, q, lse, q)

    class Built(Exception):
        pass

    def build():
        raise Built
    monkeypatch.setattr(_build, "load", build)
    q, k = qkv(112)
    with pytest.raises(Built):
        fa.flash_attention_backward_cuda(q, k, k, q, lse, q)
