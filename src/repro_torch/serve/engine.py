"""Batched LM serving: prefill + KV-cache decode in request waves.

The port of the JAX package's ``repro/serve/engine.py``.  Requests are
sorted by prompt length and grouped into waves of ``batch_size``; a wave
is left-padded with token 0 to a common length of at least 8, prefilled
once and decoded step by step until every member has hit its EOS or its
token budget.  The KV cache is wave-synchronous (one length for the
wave); an RWKV6 model carries its recurrent state instead (no length, no
``max_len``), the Mamba2 hybrid its layers' states beside its shared
layer's caches.  A wave of at least 8 tokens meets the hybrid's chunk
rule up to 256 tokens; a longer one must be a multiple of 256.  Every layer's attention and RMSNorm run the hand-written
CUDA kernels on the card.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve.types import Request, Result

__all__ = ["Request", "Result", "ServeEngine", "pad_wave"]

MIN_PROMPT = 8          # a wave's prompts are padded to at least this


def pad_wave(wave: Sequence[Request]) -> np.ndarray:
    """The wave's prompts left-padded with token 0 to one length,
    ``max(longest prompt, 8)``: int32 [len(wave), S]."""
    S = max(MIN_PROMPT, max(len(r.prompt) for r in wave))
    toks = np.zeros((len(wave), S), np.int32)
    for j, r in enumerate(wave):
        toks[j, S - len(r.prompt):] = r.prompt
    return toks


class ServeEngine:
    """Serve LM requests in waves on ``device`` (the card by default; a
    missing card raises, naming ``device="cpu"``, which runs the
    kernels' plain versions).  ``params`` are the model's parameters
    (:func:`repro_torch.models.transformer.init_params`, or carried from
    the JAX package by :func:`repro_torch.convert.lm_params_from_numpy`)
    on that device; the engine keeps one copy of them in the compute
    dtype.  ``greedy=False`` samples from the softmax with a
    ``torch.Generator`` seeded with ``seed``: not JAX's random stream."""

    def __init__(self, cfg, params, batch_size: int = 8,
                 max_len: int = 512, greedy: bool = True, seed: int = 0,
                 device="cuda"):
        tfm.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = tfm.cast_params(cfg, params)
        self.batch_size = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits):
        if self.greedy:
            return torch.argmax(logits, dim=-1)     # the first maximum
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def run(self, requests: Sequence[Request]) -> list[Result]:
        out: list[Result] = []
        reqs = sorted(requests, key=lambda r: len(r.prompt))
        for i in range(0, len(reqs), self.batch_size):
            out.extend(self._run_wave(reqs[i:i + self.batch_size]))
        return sorted(out, key=lambda r: r.uid)

    @torch.inference_mode()
    def _run_wave(self, wave: Sequence[Request]) -> list[Result]:
        cfg, p = self.cfg, self.params
        toks = torch.from_numpy(pad_wave(wave)).to(self.device)
        logits, cache = tfm.prefill(cfg, p, {"tokens": toks},
                                    max_len=self.max_len)
        budget = max(r.max_new_tokens for r in wave)
        done = np.zeros((len(wave),), bool)
        gen: list[list[int]] = [[] for _ in wave]
        tok = self._sample(logits)[:, None]
        for _ in range(budget):
            t_np = tok[:, 0].cpu().numpy()
            for j, r in enumerate(wave):
                if not done[j]:
                    gen[j].append(int(t_np[j]))
                    if ((r.eos_id is not None and t_np[j] == r.eos_id)
                            or len(gen[j]) >= r.max_new_tokens):
                        done[j] = True
            if done.all():
                break
            logits, cache = tfm.decode_step(cfg, p, tok, cache)
            tok = self._sample(logits)[:, None]
        return [Result(r.uid, np.array(g, np.int32), len(r.prompt))
                for r, g in zip(wave, gen)]
