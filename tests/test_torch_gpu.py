"""The fire-block CUDA kernel on the card: kernel against its plain
PyTorch version, and the engine against the numpy oracle.

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture decides, never the module at import).  Run them on the card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import library  # noqa: E402
from repro_torch.core.engine import (DataflowEngine, pack_feeds,  # noqa: E402
                                     run_reference)
from repro_torch.kernels import dataflow_fire as df  # noqa: E402
from repro_torch.serve.dataflow_server import DataflowServer  # noqa: E402
from repro_torch.testing import (STATE_KEYS,  # noqa: E402
                                 assert_same_result,
                                 random_block_inputs)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bench(name):
    return library.BENCHES[name]()


@pytest.mark.parametrize("name", sorted(library.BENCHES))
def test_kernel_matches_plain(cuda, name):
    tables = df.block_plan_arrays(_bench(name).graph)
    dt = df.device_tables(tables, cuda)
    rng = np.random.default_rng(7)
    x = {k: torch.tensor(v, device=cuda)
         for k, v in random_block_inputs(tables, 16, 24, rng).items()}
    state = [x[k] for k in STATE_KEYS]
    for K in (1, 16, 64):
        n0 = df.fire_block_batched_cuda.launches
        got = df.fire_block_batched_cuda(
            dt, x["feed_vals"], x["feed_len"], *state, n_cycles=K,
            active=x["active"])
        assert df.fire_block_batched_cuda.launches == n0 + 1
        want = df.fire_block_batched(
            dt, x["feed_vals"], x["feed_len"], *state, n_cycles=K,
            active=x["active"])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        n1 = df.fire_block_cuda.launches
        got1 = df.fire_block_cuda(dt, x["feed_vals"][0], x["feed_len"][0],
                                  *(s[0] for s in state), n_cycles=K)
        assert df.fire_block_cuda.launches == n1 + 1
        want1 = df.fire_block(dt, x["feed_vals"][0], x["feed_len"][0],
                              *(s[0] for s in state), n_cycles=K)
        for g, w in zip(got1, want1):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_rejects_bad_arguments(cuda):
    tables = df.block_plan_arrays(_bench("dot_prod").graph)
    dt = df.device_tables(tables, cuda)
    x = random_block_inputs(tables, 2, 4, np.random.default_rng(0))
    t = {k: torch.tensor(v, device=cuda) for k, v in x.items()}
    args = [t[k] for k in ("feed_vals", "feed_len", "full", "val", "ptr",
                           "out_last", "out_count")]
    with pytest.raises(TypeError):      # int64 state
        df.fire_block_batched_cuda(dt, *args[:2], args[2].long(),
                                   *args[3:], n_cycles=4)
    with pytest.raises(ValueError):     # wrong arc count
        df.fire_block_batched_cuda(dt, *args[:2], args[2][:, :-1].clone(),
                                   *args[3:], n_cycles=4)
    with pytest.raises(ValueError):     # mixed devices
        df.fire_block_batched_cuda(dt, *args[:2], args[2].cpu(), *args[3:],
                                   n_cycles=4)


@pytest.mark.parametrize("name", sorted(library.BENCHES))
def test_engine_matches_reference(cuda, name):
    bench = _bench(name)
    feeds = [library.random_feeds(name, bench, 1 + b % 5,
                                  np.random.default_rng(b)) for b in range(6)]
    wants = [run_reference(bench.graph, f) for f in feeds]
    for K in (1, 4, 16):
        eng = DataflowEngine(bench.graph, block_cycles=K, device=cuda)
        got = [eng.run(feeds[0])] + eng.run_batch(feeds)
        for g, w in zip(got, [wants[0]] + wants):
            assert_same_result(g, w, (name, K), dispatches=False)


def test_server_matches_solo_runs(cuda):
    bench = _bench("fibonacci")
    feeds = [bench.make_feeds(1 + (3 * i) % 11) for i in range(10)]
    wants = [run_reference(bench.graph, f) for f in feeds]
    srv = DataflowServer(bench.graph, slots=4, block_cycles=4, device=cuda)
    for f in feeds[:4]:
        srv.submit(f)
    got = srv.step() + srv.step()
    for f in feeds[4:]:
        srv.submit(f)
    got = sorted(got + srv.drain(), key=lambda r: r.uid)
    assert [r.uid for r in got] == list(range(1, 11))
    for r, w in zip(got, wants):
        assert_same_result(r.engine, w, r.uid, dispatches=False)


def test_pack_feeds_layout_feeds_the_kernel(cuda):
    """A packed single stream runs through the kernel exactly as the
    plain version runs it."""
    bench = _bench("pop_count")
    tables = df.block_plan_arrays(bench.graph)
    dt = df.device_tables(tables, cuda)
    fv, fl = pack_feeds(tables["plan"]["input_arcs"],
                        bench.make_feeds([3, 255, 7]), pad_rows=1)
    eng = DataflowEngine(bench.graph, block_cycles=8, device=cuda)
    state = eng._state0()
    args = (torch.tensor(fv, device=cuda), torch.tensor(fl, device=cuda),
            *state)
    for g, w in zip(df.fire_block_cuda(dt, *args, n_cycles=8),
                    df.fire_block(dt, *args, n_cycles=8)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
