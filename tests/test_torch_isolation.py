"""The port stands alone: it imports neither jax nor the JAX package, and
it never moves to the CPU behind the caller's back."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compile as tcompile  # noqa: E402
from repro_torch.core import library  # noqa: E402
from repro_torch.core.engine import DataflowEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dataflow_fire as df  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import dataflow_server  # noqa: E402
from repro_torch.testing import (STATE_KEYS,  # noqa: E402
                                 random_block_inputs, random_prof)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORTS_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
assert sys.modules["jax"] is None and not bad, bad
print(" ".join(names))
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _IMPORTS_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 18   # every module was imported
    names = out.stdout.split()[:-1]
    for m in ("models.moe", "configs.llama4_scout_17b_a16e",
              "configs.kimi_k2_1t_a32b", "models.ssm", "configs.zamba2_7b"):
        assert f"repro_torch.{m}" in names, m


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                        r"|from\s+repro\b(?!_))", re.M)


def test_no_jax_or_repro_import_in_source():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dataflow_server.clear_engine_cache()
    graph = library.fibonacci_graph().graph
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataflowEngine(graph)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dataflow_server.DataflowServer(graph)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dataflow_server.DataflowServer(graph, optimize=True, profile=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ops.run_fabric(graph, library.fibonacci_graph().make_feeds(3))
    for backend in tcompile.EXECUTORS:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tcompile.compile(graph, backend=backend)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataflowEngine(graph, backend="torch", dtype="float32")


def test_wrappers_on_cpu_tensors_build_and_launch_nothing(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build the kernel")
    real_load = _build.load
    monkeypatch.setattr(_build, "load", no_build)
    wrappers = (df.fire_block_cuda, df.fire_block_batched_cuda)
    counts = lambda: [getattr(w, k) for w in wrappers for k in (
        "launches", "prof_launches", "spec_launches")] + [
        df.fire_step_cuda.launches]
    launches = counts()
    for opt in (False, True):
        tables = df.block_plan_arrays(library.dot_product_graph(4).graph,
                                      optimize=opt)
        x = {k: torch.tensor(v) for k, v in random_block_inputs(
            tables, 3, 5, np.random.default_rng(0)).items()}
        prof = tuple(torch.tensor(p) for p in random_prof(
            tables, 3, np.random.default_rng(1)))
        args = [x["feed_vals"], x["feed_len"], *(x[k] for k in STATE_KEYS)]
        for dt in (tables, df.device_tables(tables, "cpu")):
            for pr in (None, prof):
                out = df.fire_block_batched_cuda(dt, *args, n_cycles=4,
                                                 active=x["active"], prof=pr)
                assert all(o.device.type == "cpu" for o in out)
                out = df.fire_block_cuda(
                    dt, *(a[0] for a in args), n_cycles=4,
                    prof=None if pr is None else tuple(p[0] for p in pr))
                assert all(o.device.type == "cpu" for o in out)
            out = df.fire_step_cuda(dt, x["full"][0], x["val"][0])
            assert all(o.device.type == "cpu" for o in out)
    assert counts() == launches
    if not torch.cuda.is_available():
        assert not any(launches) and real_load.cache_info().currsize == 0


def test_lm_entry_points_without_cuda_raise(monkeypatch):
    """The LM serving path runs on the card unless asked for the CPU: the
    engine, the launcher, the model's init and cache name device="cpu"
    when there is no card."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("internlm2-1.8b").reduced()
    params = tfm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfm.init_params(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch_serve.main(["--arch", "internlm2-1.8b"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch_serve.main(["--arch", "internlm2-1.8b", "--reduced"])
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_lm_wrappers_on_cpu_tensors_build_and_launch_nothing(monkeypatch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    def no_build():
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(_build, "load", no_build)
    launches = (fa.flash_attention_cuda.launches, rn.rmsnorm_cuda.launches)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    for dtype in (torch.float32, torch.bfloat16):
        out = fa.flash_attention_cuda(q.to(dtype), k.to(dtype), v.to(dtype),
                                      q_offset=4, kv_len=9)
        assert out.device.type == "cpu" and out.dtype == dtype
        for model in (False, True):
            out = rn.rmsnorm_cuda(q.to(dtype), torch.ones(16), model=model)
            assert out.device.type == "cpu" and out.dtype == dtype
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape
    assert ops.rmsnorm(q, torch.ones(16)).shape == q.shape
    assert (fa.flash_attention_cuda.launches,
            rn.rmsnorm_cuda.launches) == launches


_TRACES_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None            # any import of jax now fails
from repro_torch import front
from repro_torch.front import adapter, lowering, tracer
from repro_torch.core import library
from repro_torch.testing import TRACED_ASM_SHA256, asm_sha256
for name in ("gcd", "horner_loop", "relu_chain"):
    bench = library.BENCHES[name]()
    assert asm_sha256(bench.graph) == TRACED_ASM_SHA256[name], name
bad = [m for m in sys.modules
       if m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
assert sys.modules["jax"] is None and not bad, bad
print("ok")
"""


def test_front_traces_loops_without_jax():
    """The four front modules import, and capture a loop (torch's
    while_loop goes through dynamo), with jax unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _TRACES_WITHOUT_JAX],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


def test_front_entry_points_without_cuda_raise(monkeypatch):
    """compile_fn and for_fn run on the card unless asked for the CPU."""
    from repro_torch.core.compile import compile_fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dataflow_server.clear_engine_cache()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compile_fn(lambda x, y: x + y, np.int32, np.int32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dataflow_server.DataflowServer.for_fn(lambda x: x * 3, np.int32)
    run = compile_fn(lambda x, y: x + y, np.int32, np.int32, device="cpu")
    assert int(run(run.make_feeds([1], [2])).outputs[run.out_arcs[0]]) == 3


_TRAINS_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch.data.pipeline, repro_torch.optim.adamw
import repro_torch.ckpt.checkpoint, repro_torch.train.loop
import repro_torch.launch.train, repro_torch.pytree
out = repro_torch.launch.train.main(["--arch", "internlm2-1.8b", "--device",
                                     "cpu", "--steps", "2", "--seq", "16",
                                     "--batch", "1", "--ckpt-dir", sys.argv[1]])
bad = [m for m in sys.modules
       if m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
assert sys.modules["jax"] is None and not bad, bad
print(len(out["losses"]))
"""


def test_training_modules_run_without_jax(tmp_path):
    """data, optim, ckpt, train and launch.train import, and the launcher
    trains two steps on the CPU, with jax unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _TRAINS_WITHOUT_JAX,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "2"


def test_training_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    """Training runs on the card unless asked for the CPU: the launcher (at
    either width), the loop and its initial state name device="cpu" when
    there is no card."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train import loop as train_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("internlm2-1.8b").reduced()
    for argv in ([], ["--reduced"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            launch_train.main(["--arch", "internlm2-1.8b", "--ckpt-dir",
                               str(tmp_path), *argv])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_loop.init_state(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_loop.run(cfg, train_loop.LoopConfig(ckpt_dir=str(tmp_path)),
                       adamw.OptConfig(), SyntheticLM(cfg.vocab, 16, 1))
    assert not any(tmp_path.iterdir())
