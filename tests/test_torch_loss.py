"""The port's ``loss_fn`` against the JAX package's at the edges of the
labels, on the CPU: internlm2-1.8b at its reduced size in f32, the JAX
package's random parameters carried across
(``repro_torch.convert.lm_params_from_numpy``).

A label at or past the vocabulary makes both losses NaN (JAX's
``take_along_axis`` fills an out-of-range pick with NaN; the port gathers
at a clamped index and puts NaN there); a negative label is masked in
both; labels in range give the same loss within 1e-5 relative (f32 sums
in another order).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "internlm2-1.8b"
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              compute_dtype="float32")
    jp = jtfm.init_params(jcfg, jax.random.key(2))
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _losses(models, labels_at):
    jcfg, cfg, jp, tp = models
    batch = pipeline.SyntheticLM(vocab=cfg.vocab, seq_len=64,
                                 global_batch=2, seed=4).batch_for_step(0)
    for (b, s), lab in labels_at.items():
        batch["labels"][b, s] = lab
    jl, jaux = jtfm.loss_fn(jcfg, jp, batch)
    with torch.no_grad():
        tl, taux = tfm.loss_fn(cfg, tp, batch)
    return (float(jl), float(jaux["tokens"])), (float(tl),
                                                float(taux["tokens"]))


@pytest.mark.parametrize("past", [0, 1, 1000])
def test_label_past_the_vocabulary_gives_nan(models, past):
    V = models[1].vocab
    (jl, jt), (tl, tt) = _losses(models, {(1, 7): V + past})
    assert np.isnan(jl) and np.isnan(tl)
    assert jt == tt == 2 * 64


@pytest.mark.parametrize("labels_at", [
    {},                                            # every label in range
    {(0, 0): 0, (1, 63): "V-1"},                   # the first and last ids
    {(0, 3): -1, (1, 10): -1, (1, 11): -7},        # masked
], ids=["in_range", "edge_ids", "negative_masked"])
def test_labels_in_range_agree_with_jax(models, labels_at):
    V = models[1].vocab
    labels_at = {k: V - 1 if v == "V-1" else v for k, v in labels_at.items()}
    (jl, jt), (tl, tt) = _losses(models, labels_at)
    assert np.isfinite(jl) and np.isfinite(tl)
    assert abs(tl - jl) <= TOL * abs(jl)
    n_masked = sum(v < 0 for v in labels_at.values())
    assert jt == tt == 2 * 64 - n_masked
