"""The port's LM training path against the JAX package's, on the CPU.

internlm2-1.8b at its reduced size (2 layers, d 128, 4 query heads over
2 kv heads, vocab 512), the JAX package's random parameters carried
across (``repro_torch.convert.train_state_from_numpy``).  The data
pipeline gives the same batches bit for bit; ``loss_fn``'s value and
every gradient leaf equal ``jax.value_and_grad`` of the JAX
``loss_fn``; eight ``make_train_step`` steps from one state give the same
losses and parameters; the fault-tolerant loop restarts byte-exactly,
flags stragglers, and its loss falls; the launcher runs on the CPU.  The
wrappers run their kernels' plain versions here.

Tolerances (relative Frobenius error of each leaf, relative error of the
loss): f32 compute 1e-4 (sums in another order: the port's attention is
the plain one, JAX's the online-softmax jnp one); bf16 compute 3e-2 for
gradients and 1e-2 for the loss (both sides round every product to bf16,
at places that differ, ~30 bf16 roundings a layer at 2^-8 each).  After
eight steps, f32: losses within 1e-4 relative, parameters within 1e-4
relative Frobenius (AdamW divides by sqrt(v): a gradient entry near 0
turns its tiny difference into an update difference of up to lr).
"""
import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402

ARCH = "internlm2-1.8b"
F32 = dict(grad=1e-4, loss=1e-4)
BF16 = dict(grad=3e-2, loss=1e-2)


def _configs(compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype=compute_dtype, **kw)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


def _state(jcfg, cfg, seed=0):
    jp = jtfm.init_params(jcfg, jax.random.key(seed))
    js = jadamw.init(jp)
    return (jp, js), train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js),
        "cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(100, 16, 4, 3), (512, 128, 2, 0),
                                   (92544, 64, 1, 5)])
def test_batches_equal_jax_bit_for_bit(shape):
    V, S, B, seed = shape
    src = pipeline.SyntheticLM(vocab=V, seq_len=S, global_batch=B, seed=seed)
    jsrc = jpipeline.SyntheticLM(vocab=V, seq_len=S, global_batch=B,
                                 seed=seed)
    for step in (0, 1, 7, 1000):
        got, want = src.batch_for_step(step), jsrc.batch_for_step(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it, jit_ = pipeline.prefetch(src, 3), jpipeline.prefetch(jsrc, 3)
    for _ in range(3):
        got, want = next(it), next(jit_)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    it.close()
    jit_.close()


def test_make_source_matches_jax():
    jcfg, cfg = _configs()
    shape = type("Shape", (), dict(seq_len=32, global_batch=2))
    got = pipeline.make_source(cfg, shape, seed=4).batch_for_step(2)
    want = jpipeline.make_source(jcfg, shape, seed=4).batch_for_step(2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_per_step():
    src = pipeline.SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=3)
    b1, b2 = src.batch_for_step(7), src.batch_for_step(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], src.batch_for_step(8)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# ---------------------------------------------------------------------------
# the train step and the loop
# ---------------------------------------------------------------------------
def test_train_step_donates_or_copies():
    _, cfg = _configs()
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=32,
                                 global_batch=2).batch_for_step(0)
    state = train_loop.init_state(cfg, seed=0, device="cpu")
    keep = [x.clone() for x in pytree.leaves(state)]
    new, _ = train_loop.make_train_step(cfg, ocfg, donate=False)(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(state), keep))
    new2, _ = train_loop.make_train_step(cfg, ocfg)(state, batch)
    for x, y, z in ((new2[0], state[0], new[0]),
                    (new2[1].m, state[1].m, new[1].m),
                    (new2[1].v, state[1].v, new[1].v)):
        for a, b, c in zip(pytree.leaves(x), pytree.leaves(y),
                           pytree.leaves(z)):
            assert a is b and torch.equal(a, c)
    assert int(new2[1].step) == int(new[1].step) == 1


def _tiny_setup(tmp_path, total=8, fail_at=None):
    _, cfg = _configs()
    src = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2,
                               seed=0)
    lp = train_loop.LoopConfig(
        total_steps=total, ckpt_every=3, ckpt_dir=str(tmp_path),
        log_every=100, fail_at_step=fail_at)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=total)
    return cfg, src, lp, opt


def test_loop_failure_injection_and_exact_restart(tmp_path):
    cfg, src, lp, opt = _tiny_setup(tmp_path, total=8, fail_at=5)
    with pytest.raises(train_loop.SimulatedFailure):
        train_loop.run(cfg, lp, opt, src, seed=0, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST",
                                                          "step_00000003"]
    # restart: resumes from the step-3 checkpoint and completes
    lp2 = train_loop.LoopConfig(
        total_steps=8, ckpt_every=3, ckpt_dir=str(tmp_path), log_every=100)
    out = train_loop.run(cfg, lp2, opt, src, seed=0, device="cpu")
    assert out["resumed"] and out["start_step"] == 3
    assert len(out["losses"]) == 5
    # byte-exact: a run that never failed ends with the same parameters
    cfg2, src2, lp3, opt2 = _tiny_setup(tmp_path / "clean", total=8)
    ref = train_loop.run(cfg2, lp3, opt2, src2, seed=0, device="cpu")
    assert not ref["resumed"]
    assert out["losses"] == ref["losses"][3:]
    for a, b in zip(pytree.leaves(out["state"]), pytree.leaves(ref["state"])):
        assert torch.equal(a, b)


def test_loop_loss_decreases(tmp_path):
    cfg, src, lp, _ = _tiny_setup(tmp_path, total=30)
    lp.ckpt_every = 1000
    opt = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    out = train_loop.run(cfg, lp, opt, src, seed=1, device="cpu")
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)


def test_straggler_watchdog_flags_slow_steps(tmp_path, monkeypatch):
    """A step slower than straggler_factor x the running median of the
    steps before it (from the sixth step on) is flagged, as the JAX loop
    flags it: the same step times (a fake clock) give the same events."""
    dts = [0.1, 0.1, 0.5, 0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.35, 0.29, 0.1]
    want = []
    for i, dt in enumerate(dts):     # the rule, spelled out
        if i >= 5 and dt > 3.0 * statistics.median(dts[:i]):
            want.append(i)
    assert want == [7, 9]
    _, cfg = _configs()
    jcfg, _ = _configs()
    src = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=1)
    events = []
    for mod, kw, step in (
            (train_loop, dict(device="cpu"),
             lambda s, b: (s, {"loss": torch.tensor(1.0)})),
            (jloop, dict(key=jax.random.key(0)),
             lambda s, b: (s, {"loss": jnp.float32(1.0)}))):
        clock = iter([t for dt in dts for t in (0.0, dt)])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        lp = mod.LoopConfig(total_steps=len(dts), ckpt_every=1000,
                            ckpt_dir=str(tmp_path / mod.__name__),
                            log_every=100)
        out = mod.run(cfg if mod is train_loop else jcfg, lp,
                      mod.adamw.OptConfig(), src, train_step=step, **kw)
        events.append(out["straggler_events"])
        assert out["step_times"] == dts
        monkeypatch.undo()
    assert events == [want, want]


def test_launcher_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                             "4", "--seq", "32", "--batch", "2",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2"])
    assert out["reduced"] and out["device"] == "cpu"
    assert not out["resumed"] and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"done: arch={ARCH} reduced=True resumed=False "
                           "final_loss=") and line.endswith("device=cpu")
    again = launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                               "6", "--seq", "32", "--batch", "2",
                               "--ckpt-dir", str(tmp_path)])
    assert again["resumed"] and again["start_step"] == 4
    assert len(again["losses"]) == 2


# ---------------------------------------------------------------------------
# against the JAX package's loss, gradients and steps (after the tests that
# run the port alone: XLA's CPU threads slow PyTorch's once they have run)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute,remat", [("float32", True),
                                           ("float32", False),
                                           ("bfloat16", True)])
def test_loss_and_grads_match_jax(compute, remat):
    jcfg, cfg = _configs(compute, remat=remat)
    tol = F32 if compute == "float32" else BF16
    (jp, _), (tp, _) = _state(jcfg, cfg, seed=1)
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=128,
                                 global_batch=2, seed=0).batch_for_step(0)
    batch["labels"][0, :5] = -1               # masked positions
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, batch), has_aux=True)(jp)
    flat, treedef = pytree.flatten(tp)
    leaves = [x.requires_grad_(True) for x in flat]
    loss, aux = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    assert abs(float(loss) - float(jl)) <= tol["loss"] * abs(float(jl))
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 2 * 128 - 5
    assert float(aux["aux"]) == 0.0
    assert abs(float(aux["nll"]) - float(jaux["nll"])) <= \
        tol["loss"] * abs(float(jaux["nll"]))
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads) == 10
    for g, w in zip(grads, jleaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= tol["grad"], (g.shape, _rel(g.numpy(), w))


def test_remat_changes_nothing():
    """Checkpointed layers recompute the same forward: the same loss and
    gradients, bit for bit."""
    out = []
    for remat in (True, False):
        _, cfg = _configs(remat=remat)
        params = tfm.init_params(cfg, seed=3, device="cpu")
        batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64,
                                     global_batch=2).batch_for_step(1)
        flat, treedef = pytree.flatten(params)
        leaves = [x.requires_grad_(True) for x in flat]
        loss, _ = tfm.loss_fn(cfg, pytree.unflatten(treedef, leaves), batch)
        out.append([loss.detach(), *torch.autograd.grad(loss, leaves)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_loss_chunk_must_divide_the_sequence():
    _, cfg = _configs()
    params = tfm.init_params(cfg, device="cpu")
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=96,
                                 global_batch=1).batch_for_step(0)
    with pytest.raises(ValueError, match="loss_chunk"):
        tfm.loss_fn(cfg, params, batch)


def test_other_families_still_refused():
    for name in ("whisper-medium", "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11b"):
            tfm.forward(get_arch(name).reduced(), {}, {})


def test_eight_train_steps_match_jax():
    jcfg, cfg = _configs()
    (jstate, (tp, ts)) = _state(jcfg, cfg, seed=2)
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    src = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                               seed=0)
    jstep = jloop.make_train_step(jcfg, jadamw.OptConfig(**ocfg._asdict()),
                                  donate=False)
    step = train_loop.make_train_step(cfg, ocfg)
    state = (tp, ts)
    for i in range(8):
        batch = src.batch_for_step(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            F32["loss"] * abs(float(jm["loss"]))
        assert _rel(m["grad_norm"].numpy(), jm["grad_norm"]) <= F32["grad"]
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state[1].step) == int(jstate[1].step) == 8
    for a, b in zip(pytree.leaves(state[0]), jax.tree.leaves(jstate[0])):
        assert _rel(a.numpy(), b) <= 1e-4
