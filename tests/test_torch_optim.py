"""The port's AdamW against the JAX package's ``repro/optim/adamw.py``, on
the CPU: the schedule, several update steps from one state on the same
gradients (clipping active on some, decay and no-decay leaves, with and
without f32 master weights), and the JAX package's own optimizer tests.

Tolerance: both sides compute each step in f32 in the same order of
operations; they differ where XLA and PyTorch round a power, a square
root or a fused multiply-add otherwise, a few f32 ulps a step.  After six
steps parameters, moments and master weights agree as allclose with rtol
= 1e-5 and atol = 1e-7 (an update moves a parameter by at most ~lr =
1e-2; the moments' smallest entries are ~1e-9); bf16 parameters, rounded
from the agreeing masters, within one bf16 step (rtol = 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SHAPES = {"w": (8, 5), "b": (5,), "blk": {"k": (2, 3, 4), "g": (3,)}}


def _tree(rng, scale=1.0):
    def make(s):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": make(SHAPES["w"]), "b": make(SHAPES["b"]),
            "blk": {"k": make(SHAPES["blk"]["k"]),
                    "g": make(SHAPES["blk"]["g"])}}


def _close(t, j, what, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("master", [False, True])
def test_update_matches_jax(master):
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                          weight_decay=0.1, clip_norm=3.0)
    jcfg = jadamw.OptConfig(**cfg._asdict())
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    pdt = (jnp.bfloat16, torch.bfloat16) if master else \
        (jnp.float32, torch.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(pdt[0]), p0)
    tp = pytree.tree_map(lambda a: torch.from_numpy(
        np.array(jnp.asarray(a).astype(jnp.float32))).to(pdt[1]), p0)
    js, ts = jadamw.init(jp, master_weights=master), \
        adamw.init(tp, master_weights=master)
    assert (ts.master is None) == (not master)
    clipped = 0
    for step in range(6):
        g = _tree(rng, scale=3.0 if step % 2 else 0.1)   # clip every other
        jp, js, jm = jadamw.update(jcfg, g, js, jp)
        tp, ts, tm = adamw.update(cfg, pytree.tree_map(torch.from_numpy, g),
                                  ts, tp)
        clipped += float(jm["grad_norm"]) > cfg.clip_norm
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        _close(tm["lr"], jm["lr"], "lr", atol=0)
        for name, t, j in (("m", ts.m, js.m), ("v", ts.v, js.v),
                           ("params", tp, jp)) + ((
                               ("master", ts.master, js.master),)
                               if master else ()):
            for a, b in zip(pytree.leaves(t), jax.tree.leaves(j)):
                if name == "params" and master:
                    assert a.dtype == torch.bfloat16
                    _close(a, b, f"step {step} {name}", rtol=2 ** -8, atol=0)
                else:
                    _close(a, b, f"step {step} {name}")
    assert clipped == 3


def test_decay_only_on_matrices():
    """One step with zero gradients: only the weight decay moves a
    parameter, and only the leaves of two or more dimensions."""
    cfg = adamw.OptConfig(lr=0.5, warmup_steps=0, total_steps=10,
                          weight_decay=0.1)
    p = pytree.tree_map(torch.from_numpy, _tree(np.random.default_rng(1)))
    zeros = pytree.tree_map(torch.zeros_like, p)
    new, _, _ = adamw.update(cfg, zeros, adamw.init(p), p)
    for a, b in zip(pytree.leaves(new), pytree.leaves(p)):
        if b.dim() >= 2:
            assert not torch.equal(a, b)
        else:
            assert torch.equal(a, b)


def test_inplace_update_writes_the_given_tensors():
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(2)
    p = pytree.tree_map(torch.from_numpy, _tree(rng))
    g = pytree.tree_map(torch.from_numpy, _tree(rng))
    s = adamw.init(p)
    keep = [x.clone() for x in pytree.leaves(p)]
    new, ns, _ = adamw.update(cfg, g, s, p)               # functional
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(p), keep))
    assert all(not x.any() for x in pytree.leaves(s.m))
    new2, ns2, _ = adamw.update(cfg, g, s, p, inplace=True)
    for a, b in zip(pytree.leaves(new2), pytree.leaves(p)):
        assert a is b
    for x, y in zip(pytree.leaves((new, ns)), pytree.leaves((new2, ns2))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_schedule_matches_jax(step):
    cfg = adamw.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jadamw.schedule(jadamw.OptConfig(**cfg._asdict()),
                           jnp.int32(step))
    assert got.dtype == torch.float32
    _close(got, want, f"step {step}", rtol=1e-6, atol=0)


def test_schedule_warmup_and_decay():
    cfg = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0, abs=1e-3)
    assert float(adamw.schedule(cfg, 55)) == pytest.approx(0.55, abs=1e-3)
    assert float(adamw.schedule(cfg, 100)) == pytest.approx(0.1, abs=1e-3)


def test_adamw_reduces_quadratic():
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clips_gradients():
    cfg = adamw.OptConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.ones(4)}
    _, _, m = adamw.update(cfg, {"w": torch.full((4,), 1e6)},
                           adamw.init(params), params)
    assert float(m["grad_norm"]) > 1e5      # reported before clipping
