"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) on the CPU:
the JAX package's own checkpoint tests, and the on-disk format shared
with ``repro/ckpt/checkpoint.py`` — a checkpoint the JAX package writes
restores in the port, and one the port writes restores in the JAX
package, leaf for leaf and bit for bit (bf16 leaves too), for a mixed
tree and for an LM training state (parameters, step, moments)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "internlm2-1.8b"


def _mixed(seed):
    """The same mixed tree in both packages: int, f32 scalar, bf16, a
    NamedTuple with a None field, a tuple."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    c = np.float32(rng.standard_normal())
    d = jnp.asarray(rng.standard_normal(4).astype(np.float32)).astype(
        jnp.bfloat16)
    e = rng.standard_normal((3, 2)).astype(np.float32)
    jt = {"z": jnp.asarray(a), "b": {"c": jnp.float32(c), "d": d},
          "s": jadamw.OptState(jnp.int32(7), {"x": jnp.asarray(e)},
                               (jnp.asarray(e[0]),), None)}
    tt = {"z": torch.from_numpy(a), "b": {"c": torch.tensor(c),
                                          "d": torch.from_numpy(np.array(
                                              d.astype(jnp.float32)))
                                          .bfloat16()},
          "s": adamw.OptState(torch.tensor(7, dtype=torch.int32),
                              {"x": torch.from_numpy(e)},
                              (torch.from_numpy(e[0].copy()),), None)}
    return jt, tt


def _same(t_leaves, j_leaves):
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        if j.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_leaves_in_jax_order():
    jt, tt = _mixed(0)
    _same(pytree.leaves(tt), jax.tree.leaves(jt))
    leaves, treedef = pytree.flatten(tt)
    back = pytree.unflatten(treedef, leaves)
    assert back["s"].master is None and isinstance(back["s"], adamw.OptState)
    assert pytree.describe(treedef).count("*") == len(leaves) == 6


def test_checkpoint_roundtrip(tmp_path):
    _, tree = _mixed(1)
    ckpt.save(str(tmp_path), 5, tree)
    step, back = ckpt.restore(str(tmp_path), tree)
    assert step == 5
    for x, y in zip(pytree.leaves(tree), pytree.leaves(back)):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_checkpoint_latest_and_cleanup(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.cleanup(str(tmp_path), keep=2)
    names = sorted(os.listdir(tmp_path))
    assert "step_00000003" in names and "step_00000004" in names
    assert "step_00000001" not in names


def test_checkpoint_partial_write_is_invisible(tmp_path):
    tree = {"a": torch.zeros(2)}
    ckpt.save(str(tmp_path), 1, tree)
    # a crash mid-save: the tmp dir exists but LATEST was not updated
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    step, _ = ckpt.restore(str(tmp_path), tree)
    assert step == 1
    assert ckpt.restore(str(tmp_path / "none"), tree) == (None, None)


def test_mixed_tree_crosses_both_ways(tmp_path):
    jt, tt = _mixed(2)
    jckpt.save(str(tmp_path / "j"), 3, jt)
    ckpt.save(str(tmp_path / "t"), 3, tt)
    for d in ("j", "t"):
        with open(tmp_path / d / "step_00000003" / "manifest.json") as f:
            meta = json.load(f)
        assert meta["n_leaves"] == 6 and meta["step"] == 3
        assert [x["dtype"] for x in meta["leaves"]] == [
            "float32", "bfloat16", "int32", "float32", "float32", "int32"]
    zeros_t = pytree.tree_map(torch.zeros_like, tt)
    step, back = ckpt.restore(str(tmp_path / "j"), zeros_t)
    assert step == 3
    _same(pytree.leaves(back), jax.tree.leaves(jt))
    zeros_j = jax.tree.map(jnp.zeros_like, jt)
    step, jback = jckpt.restore(str(tmp_path / "t"), zeros_j)
    assert step == 3
    _same(pytree.leaves(tt), jax.tree.leaves(jback))


def test_training_state_crosses_both_ways(tmp_path):
    """JAX's (params, OptState) after two updates restores in the port
    leaf for leaf; the port's state after two updates of its own restores
    in JAX leaf for leaf."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jp = jtfm.init_params(jcfg, jax.random.key(0))
    js = jadamw.init(jp)
    ocfg = jadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jp) for _ in range(2)]
    like = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, js), "cpu")
    state = (jp, js)
    for g in grads:
        p, s, _ = jadamw.update(ocfg, g, state[1], state[0])
        state = (p, s)
    jckpt.save(str(tmp_path / "j"), 2, state)
    step, back = ckpt.restore(str(tmp_path / "j"), like)
    assert step == 2 and back[1].master is None
    assert isinstance(back[1], adamw.OptState)
    _same(pytree.leaves(back), jax.tree.leaves(state))

    tstate = like
    for g in grads:
        p, s, _ = adamw.update(adamw.OptConfig(**ocfg._asdict()),
                               pytree.tree_map(lambda x: torch.from_numpy(
                                   np.array(x)), g), tstate[1], tstate[0])
        tstate = (p, s)
    ckpt.save(str(tmp_path / "t"), 2, tstate)
    step, jback = jckpt.restore(str(tmp_path / "t"), (jp, js))
    assert step == 2
    _same(pytree.leaves(tstate), jax.tree.leaves(jback))
