"""Deterministic synthetic data pipeline.

The port's copy of the JAX package's ``repro/data/pipeline.py`` (numpy
only): the same seed and step give the same batch bit for bit in both
packages.

``batch_for_step(step)`` is a pure function of (seed, step, shape): token
streams are generated with a counter-based RNG keyed on the step, so a
restarted job reproduces the exact batch sequence with NO pipeline state
in the checkpoint — this is what makes checkpoint/restart byte-exact and
lets an *elastic* resume re-shard the same global batch over a different
mesh.  A host-sharded loader would slice ``[host_offset : host_offset +
per_host]`` of the same global batch; on this single-process runtime we
materialize the global batch.

A background prefetch thread overlaps batch synthesis with the train step
(the CPU-side analogue of overlapping host->device transfer).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic token stream with learnable structure
    (next token correlates with current), so loss visibly decreases."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend: str = "none",
                 n_patches: int = 0, frontend_dim: int = 0,
                 enc_seq: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.frontend = frontend
        self.n_patches = n_patches
        self.frontend_dim = frontend_dim
        self.enc_seq = enc_seq

    def batch_for_step(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # structured stream: x_{t+1} = (a*x_t + b + noise) % V
        a = 31
        x0 = rng.integers(0, V, (B, 1))
        noise = (rng.random((B, S)) < 0.1) * rng.integers(0, V, (B, S))
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, 0:1] = x0
        for t in range(S):
            toks[:, t + 1] = (a * toks[:, t] + 7 + noise[:, t]) % V
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.frontend == "patches":
            batch["patches"] = rng.normal(
                0, 1, (B, self.n_patches, self.frontend_dim)
            ).astype(np.float32)
            batch["labels"][:, :self.n_patches] = -1   # mask image slots
        if self.frontend == "frames":
            batch["frames"] = rng.normal(
                0, 1, (B, self.enc_seq, self.frontend_dim)
            ).astype(np.float32)
        return batch


def prefetch(source: SyntheticLM, start_step: int, depth: int = 2
             ) -> Iterator[dict]:
    """Background-thread prefetch of successive steps."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(source.batch_for_step(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def make_source(cfg, shape, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(
        vocab=cfg.vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        frontend=cfg.frontend, n_patches=cfg.n_patches,
        frontend_dim=cfg.frontend_dim, enc_seq=cfg.enc_seq)
