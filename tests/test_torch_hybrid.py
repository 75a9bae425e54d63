"""The Mamba2 hybrid (zamba2-7b) against the JAX package, on the CPU.

zamba2-7b at its reduced size (``get_arch("zamba2-7b").reduced()``: 4
Mamba2 layers, the shared attention layer after every 2nd (2 sites), d
128, state N 16, head dim P 32, 8 SSM heads, chunks of 256), with the JAX
package's random parameters carried across as numpy
(``convert.lm_params_from_numpy``) and inputs from numpy seeds.  The
leaves the JAX init leaves constant (the norms' weights, ``A_log``,
``D``, ``dt_bias``, ``conv_b``, ``norm_w``) are redrawn at random on both
sides, so that each reaches the numbers.  The port's wrappers run their
kernels' plain versions here.

Tolerances: the Mamba2 block alone 3e-5 in f32 (both sides sum the scan
in f32 in another order) and 0.125 in bf16; logits 1e-4 in f32; loss and
gradients 1e-4 relative in f32; eight AdamW steps at
``test_torch_train.py``'s f32 tolerances.  In bf16 the logits are held
to the f32 ones: JAX's own bf16 logits lie 0.09-0.28 from its f32 logits
over a prefill and 8 decode steps (4 layers), beyond the families' 0.125,
so each step the port's bf16 logits must lie no farther from JAX's f32
logits than ``BF16_RATIO`` times JAX's bf16 ones do (read 0.65-1.22), and
within twice the families' 0.125 of JAX's bf16 logits (read 0.06-0.17).
Greedy tokens and checkpoints are equal.  Where the JAX
package asserts or fails (a length off the chunk, a decode after a
prefill shorter than the conv's tail) the port raises ``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
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
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

ARCH = "zamba2-7b"
BLOCK_TOL = {"float32": 3e-5, "bfloat16": 0.125}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
GRAD_TOL = 1e-4
BF16_RATIO = 1.5       # chip_smoke.py's RWKV_BF16_RATIO
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the leaves the JAX init sets to constants, redrawn: (mean, spread)
REDRAW = {"w": (1.0, 0.2), "norm_w": (1.0, 0.2), "A_log": (-1.0, 0.3),
          "D": (1.0, 0.2), "dt_bias": (0.0, 0.3), "conv_b": (0.0, 0.1)}


def _configs(compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype=compute_dtype, **kw)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


def _redraw(tree, rng):
    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if key in REDRAW:
            mean, spread = REDRAW[key]
            return (mean + spread * rng.standard_normal(t.shape)).astype(
                t.dtype)
        return t
    return walk(tree, None)


def _params(jcfg, cfg, seed):
    tree = _redraw(jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.key(seed))), np.random.default_rng(seed + 100))
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(cfg, tree,
                                                                 "cpu")


@pytest.fixture(scope="module")
def f32_model():
    """(jcfg, cfg, JAX params, port params), f32, seed 0."""
    jcfg, cfg = _configs()
    return (jcfg, cfg, *_params(jcfg, cfg, 0))


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
def test_check_supported_takes_the_hybrid_and_refuses_the_rest():
    for cfg in (get_arch(ARCH), get_arch(ARCH).reduced()):
        tfm.check_supported(cfg)
    for name in ("whisper-medium", "internvl2-76b"):
        for cfg in (get_arch(name), get_arch(name).reduced()):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue A 11b"):
                tfm.check_supported(cfg)
    assert dataclasses.asdict(get_arch(ARCH)) == \
        dataclasses.asdict(jget_arch(ARCH))
    assert get_arch(ARCH).head_dim == 112


def test_param_tree_counts_and_cast(f32_model):
    """The tree is JAX's (``layers`` {ln, mamba} stacked, ``shared`` one
    dense layer); at full size it holds 6,751,130,832 parameters (JAX's
    init, not ``param_count()``'s 1.3e10, which gives every Mamba layer
    an MLP); ``cast_params`` keeps the f32 leaves."""
    jcfg, cfg, jp, tp = f32_model
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == tfm.param_shapes(cfg)
    assert tfm.count_params(tp) == jtfm.count_params(jp)
    assert "shared" in tp and tp["shared"]["attn"]["wqkv"].dim() == 2
    full = tfm.param_shapes(get_arch(ARCH))
    assert sum(int(np.prod(s)) for s in _shape_leaves(full)) == \
        6_751_130_832
    c = tfm.cast_params(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                        tp)
    m = c["layers"]["mamba"]
    for k in ssm.MAMBA_F32_LEAVES:
        assert m[k].dtype == torch.float32, k
    for k in ("in_proj", "out_proj", "conv_w", "conv_b"):
        assert m[k].dtype == torch.bfloat16, k
    assert c["layers"]["ln"]["w"].dtype == torch.float32
    assert c["shared"]["ln1"]["w"].dtype == torch.float32
    assert c["shared"]["attn"]["wqkv"].dtype == torch.bfloat16


def _shape_leaves(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _shape_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the Mamba2 block and its step
# ---------------------------------------------------------------------------
def _layer_mamba(jp, tp, i=0):
    return (jax.tree.map(lambda t: t[i], jp["layers"]["mamba"]),
            {k: v[i] for k, v in tp["layers"]["mamba"].items()})


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_mamba2_block_matches_jax(f32_model, chunk, dtn):
    """B = 2, S = 128 (8 or 2 chunks, the state carried between them)."""
    jcfg, cfg, jp, tp = f32_model
    jl, tl = _layer_mamba(jp, tp, 1)
    x = np.random.default_rng(chunk).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(JDT[dtn])
    want = jax.jit(lambda p, x: jssm.mamba2_block(jcfg, p, x, chunk=chunk))(
        jl, jx)
    got, carry = ssm.mamba2_block(cfg, tl, torch.from_numpy(np.array(
        jx.astype(jnp.float32))).to(TDT[dtn]), chunk=chunk)
    assert got.dtype == TDT[dtn] and got.shape == (2, 128, cfg.d_model)
    _close(got, want.astype(jnp.float32), BLOCK_TOL[dtn])
    d_in, H, N, conv_dim = ssm.mamba2_dims(cfg)
    assert carry["h"].shape == (2, H, cfg.ssm_head_dim, N)
    assert carry["conv"].shape == (2, ssm.CONV_K - 1, conv_dim)


def test_mamba2_step_walks_the_block(f32_model):
    """``mamba2_step`` token by token from the zero state gives the block's
    outputs, and ends in the block's carry (``h`` and the conv tail)."""
    jcfg, cfg, jp, tp = f32_model
    _, tl = _layer_mamba(jp, tp, 2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    want, carry = ssm.mamba2_block(cfg, tl, x, chunk=16)
    st = ssm.mamba2_init_state(cfg, 2)
    ys = []
    for t in range(48):
        y, st = ssm.mamba2_step(cfg, tl, x[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, dim=1), want.numpy(), BLOCK_TOL["float32"])
    _close(st["h"], carry["h"].numpy(), 1e-4)
    _close(st["conv"], carry["conv"].numpy(), 1e-5)   # one product a row
    with pytest.raises(ValueError, match="one token"):
        ssm.mamba2_step(cfg, tl, x[:, :2], st)


# ---------------------------------------------------------------------------
# serving: prefill and decode, the state split, the engine
# ---------------------------------------------------------------------------
def _jax_steps(jcfg, jp, toks, steps, max_len):
    """JAX's prefill logits and each teacher-forced decode step's, and its
    last cache."""
    lj, cj = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, {"tokens": t},
                                               max_len=max_len))(
        jp, jnp.asarray(toks))
    jdecode = jax.jit(lambda p, t, c: jtfm.decode_step(jcfg, p, t, c))
    out = [lj]
    for tok in steps:
        lj, cj = jdecode(jp, jnp.asarray(tok), cj)
        out.append(lj)
    return [np.asarray(x, np.float32) for x in out], cj


def _port_steps(cfg, tp, toks, steps, max_len):
    tp = tfm.cast_params(cfg, tp)
    lt, ct = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                         max_len=max_len)
    out = [lt]
    for tok in steps:
        lt, ct = tfm.decode_step(cfg, tp, torch.from_numpy(tok), ct)
        out.append(lt)
    assert all(x.dtype == torch.float32 and x.shape == (toks.shape[0],
                                                         cfg.vocab)
               for x in out)
    return out, ct


def _inputs(vocab, B, S, n_steps):
    rng = np.random.default_rng(S)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            [rng.integers(0, vocab, (B, 1)).astype(np.int32)
             for _ in range(n_steps)])


def _prefill_and_decode(jcfg, cfg, jp, tp, B, S, max_len, n_steps, tol):
    toks, steps = _inputs(cfg.vocab, B, S, n_steps)
    want, cj = _jax_steps(jcfg, jp, toks, steps, max_len)
    got, ct = _port_steps(cfg, tp, toks, steps, max_len)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, tol, f"step {i}")
    assert ct["attn"]["len"] == int(cj["attn"]["len"]) == S + n_steps
    n_sites = cfg.n_layers // cfg.attn_every
    for k in ("k", "v"):
        assert ct["attn"][k].shape[0] == n_sites
        _close(ct["attn"][k], cj["attn"][k].astype(jnp.float32), tol, k)
    assert ct["h"].dtype == torch.float32
    _close(ct["h"], cj["h"], tol, "h")
    _close(ct["conv"], cj["conv"].astype(jnp.float32), tol, "conv")


def test_prefill_and_decode_match_jax(f32_model):
    """B = 2, S = 24 into a cache of 40, then 8 teacher-forced decode
    steps, f32; logits, both sites' caches and the Mamba states."""
    _prefill_and_decode(*f32_model, 2, 24, 40, 8, LOGIT_TOL["float32"])


def test_prefill_and_decode_in_bf16(f32_model):
    """The same in bf16 compute: every step's logits held to JAX's f32
    ones as JAX's bf16 logits are (``BF16_RATIO``), and to JAX's bf16
    ones within twice the families' tolerance."""
    jcfg32, _, jp, tp = f32_model
    jcfg, cfg = _configs("bfloat16")
    toks, steps = _inputs(cfg.vocab, 2, 24, 8)
    f32, _ = _jax_steps(jcfg32, jp, toks, steps, 40)
    jb16, _ = _jax_steps(jcfg, jp, toks, steps, 40)
    got, ct = _port_steps(cfg, tp, toks, steps, 40)
    assert ct["conv"].dtype == torch.bfloat16 and \
        ct["h"].dtype == torch.float32
    for i, (g, w32, wb) in enumerate(zip(got, f32, jb16)):
        g = g.numpy()
        assert np.abs(g - w32).max() <= BF16_RATIO * np.abs(wb - w32).max(), i
        assert np.abs(g - wb).max() <= 2 * LOGIT_TOL["bfloat16"], i


def test_state_split_at_a_chunk_boundary(f32_model):
    """Chunks of 16: a prefill over 32 tokens (2 chunks) and 16
    teacher-forced decode steps end in the last logits of one prefill
    over the 48 (3 chunks), which equal JAX's."""
    jcfg, cfg, jp, tp = f32_model
    jcfg, cfg = (dataclasses.replace(c, ssm_chunk=16) for c in (jcfg, cfg))
    tp = tfm.cast_params(cfg, tp)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 48)).astype(
        np.int32)
    full, _ = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 48)
    lj, _ = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, {"tokens": t},
                                              max_len=48))(
        jp, jnp.asarray(toks))
    _close(full, lj, LOGIT_TOL["float32"], "one prefill")
    got, cache = tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(
        toks[:, :32])}, 48)
    for t in range(32, 48):
        got, cache = tfm.decode_step(cfg, tp, torch.from_numpy(
            toks[:, t:t + 1]), cache)
    _close(got, full.numpy(), LOGIT_TOL["float32"], "split")


def _reqs(vocab, lens, budget=5, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                 max_new_tokens=budget) for i, n in enumerate(lens)]


def test_serve_engine_greedy_tokens_equal_jax(f32_model):
    """Waves of 2 (prompts padded to 8 and 30), greedy, f32."""
    jcfg, cfg, jp, tp = f32_model
    reqs = _reqs(cfg.vocab, [3, 30, 5, 21])
    want = JServeEngine(jcfg, jp, batch_size=2, max_len=40).run(
        [JRequest(**r) for r in reqs])
    got = ServeEngine(cfg, tp, batch_size=2, max_len=40, device="cpu").run(
        [Request(**r) for r in reqs])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.prompt_len == w.prompt_len and len(g.tokens) == 5
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_shapes_the_reference_refuses_raise(f32_model):
    """A prefill of 300 tokens (chunks of min(256, 300): JAX asserts) and
    a decode step after a prefill of 1 or 2 tokens (JAX's conv tail is
    then shorter than CONV_K - 1 and its reshape fails) raise
    ``ValueError`` in the port; JAX fails on the same shapes."""
    jcfg, cfg, jp, tp = f32_model
    toks = np.zeros((1, 300), np.int32)
    with pytest.raises(AssertionError):
        jtfm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=310)
    with pytest.raises(ValueError, match="300 tokens is not a multiple of "
                       "the chunk 256"):
        tfm.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 310)
    for S in (1, 2):
        _, cj = jtfm.prefill(jcfg, jp, {"tokens": jnp.zeros((1, S),
                                                           jnp.int32)}, 8)
        assert cj["conv"].shape[2] == S
        with pytest.raises(TypeError, match="reshape"):
            jtfm.decode_step(jcfg, jp, jnp.zeros((1, 1), jnp.int32), cj)
        short = torch.zeros((1, S), dtype=torch.int32)
        _, ct = tfm.prefill(cfg, tp, {"tokens": short}, 8)
        assert ct["conv"].shape[2] == S
        with pytest.raises(ValueError, match=f"conv state of {S} rows"):
            tfm.decode_step(cfg, tp, torch.zeros((1, 1), dtype=torch.int32),
                            ct)


# ---------------------------------------------------------------------------
# training: loss, gradients, AdamW steps, checkpoints
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_jax(f32_model):
    """batch 2 x seq 64, f32, remat on: the loss and every gradient leaf
    within 1e-4 relative, the shared layer's the sum over its 2 sites."""
    jcfg, cfg, jp, tp = f32_model
    assert cfg.remat
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                                 seed=0).batch_for_step(0)
    batch["labels"][0, :5] = -1
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    flat, treedef = pytree.flatten(tp)
    leaves = [x.detach().requires_grad_(True) for x in flat]
    loss, aux = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jl)) <= GRAD_TOL * abs(float(jl))
    assert float(aux["tokens"]) == 2 * 64 - 5
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w, n in zip(grads, jleaves, names):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), n
        assert _rel(g.numpy(), w) <= GRAD_TOL, (n, _rel(g.numpy(), w))
    i = names.index("['shared']['attn']['wqkv']")
    # the shared layer's gradient is the sum of its sites' gradients
    one = _site_grad(cfg, tp, batch, i, flat, treedef)
    assert float(one.norm()) < 0.9 * float(grads[i].norm())


def test_decay_overflow_keeps_the_gradient_finite():
    """JAX's init (A = -1) at seq 256 in one chunk: above the diagonal the
    decay exponent passes 88 and JAX's masked ``exp`` gives a NaN gradient
    (its forward is finite); the port masks the exponent, so its gradient
    is finite and equals JAX's at chunks of 32 (the same function, no
    overflow) within 1e-4 relative."""
    jcfg, cfg = _configs(n_layers=2)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg,
                                                     jax.random.key(4)))
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(
        cfg, tree, "cpu")
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=256,
                                 global_batch=1, seed=1).batch_for_step(0)

    def jgrads(chunk):
        c = dataclasses.replace(jcfg, ssm_chunk=chunk)
        return jax.jit(jax.grad(lambda p: jtfm.loss_fn(c, p, batch)[0]))(jp)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(jgrads(256)))
    flat, treedef = pytree.flatten(tp)
    leaves = [x.detach().requires_grad_(True) for x in flat]
    loss, _ = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(jgrads(32))):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w) <= GRAD_TOL


def _site_grad(cfg, tp, batch, i, flat, treedef):
    """The shared wqkv's gradient with its second site's use cut off
    (``detach`` at that site): the first site's part alone."""
    calls = {"n": 0}
    real = tfm._dense_body

    def body(cfg_, lp, x, pos, cache=None, causal=True):
        calls["n"] += 1
        if calls["n"] == 2:
            lp = pytree.tree_map(lambda t: t.detach(), lp)
        return real(cfg_, lp, x, pos, cache, causal)
    leaves = [x.detach().requires_grad_(True) for x in flat]
    tfm._dense_body = body
    try:
        loss, _ = tfm.loss_fn(dataclasses.replace(cfg, remat=False),
                              pytree.unflatten(treedef, leaves), batch)
    finally:
        tfm._dense_body = real
    assert calls["n"] == cfg.n_layers // cfg.attn_every
    return torch.autograd.grad(loss, leaves[i])[0]


def test_eight_train_steps_match_jax():
    """f32, batch 2 x seq 64, from JAX's init: each of 8 AdamW steps
    starts from JAX's (params, OptState) carried across, and its loss,
    gradient norm, learning rate, parameters and moments are JAX's step's.
    Run free, the two trajectories part: the f32 differences of step 0
    (8e-6) reach 2.5e-4 in the embedding after step 1 (an element whose
    gradient sits at the rounding level takes Adam's full step either
    way), which the dense models' runs never showed."""
    jcfg, cfg = _configs()
    jp = jtfm.init_params(jcfg, jax.random.key(2))
    jstate = (jp, jadamw.init(jp))
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    src = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                               seed=0)
    jstep = jloop.make_train_step(jcfg, jadamw.OptConfig(**ocfg._asdict()),
                                  donate=False)
    step = train_loop.make_train_step(cfg, ocfg)
    for i in range(8):
        batch = src.batch_for_step(i)
        state = train_state_from_numpy(cfg, *(jax.tree.map(np.asarray, t)
                                              for t in jstate), "cpu")
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            GRAD_TOL * abs(float(jm["loss"]))
        assert _rel(m["grad_norm"].numpy(), jm["grad_norm"]) <= GRAD_TOL
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(state[1].step) == int(jstate[1].step) == i + 1
        for a, b in zip(pytree.leaves(state), jax.tree.leaves(jstate)):
            assert _rel(a.numpy(), b) <= GRAD_TOL


def test_hybrid_training_state_crosses_checkpoints(tmp_path, f32_model):
    """JAX's (params, OptState) after an update, with its ``shared``
    subtree, restores in the port leaf for leaf, and the port's restores
    in JAX."""
    jcfg, cfg, jp, _ = f32_model
    js = jadamw.init(jp)
    like = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, js), "cpu")
    assert "shared" in like[0] and "shared" in like[1].m
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jp)
    ocfg = jadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = jax.jit(lambda g, s, p: jadamw.update(ocfg, g, s, p))(
        g, js, jp)[:2]
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
# the launchers
# ---------------------------------------------------------------------------
def test_launchers_on_the_cpu(tmp_path, capsys):
    """``launch.serve`` with its defaults (waves of 4, prompts padded to
    at most 31 tokens) and ``launch.train --reduced`` for 3 finite
    steps."""
    out = launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    assert out["reduced"] and out["device"] == "cpu"
    assert [len(r.tokens) for r in out["results"]] == [16] * 8
    assert f"arch={ARCH} reduced=True" in capsys.readouterr().out
    out = launch_train.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                             "--steps", "3", "--seq", "32", "--batch", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert out["reduced"] and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"done: arch={ARCH} reduced=True resumed=False")
