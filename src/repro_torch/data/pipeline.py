"""Deterministic synthetic token pipeline for LM training and serving
(port of ``repro/data/pipeline.py``).

A *learnable* stream: a fixed-order Markov chain over the vocabulary (so a
model can lower its loss materially within a few hundred steps) mixed with
uniform noise. Batch ``i`` depends only on (seed, i), so the pipeline is
restartable from a step counter, which checkpoint resume relies on. The
tokens are made on the host with numpy, draw for draw as the reference
makes them, so every (seed, index) gives the reference's tokens to the bit;
``make_lm_batch`` carries them to the device.

``shard_batch`` places a batch on a ``DeviceMesh`` under a spec of
``sharding.specs`` (``batch_spec``), as DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_states: int = 64      # order-1 chain over vocab % markov_states
    noise_prob: float = 0.1

    def _chain(self) -> np.ndarray:
        """Row-stochastic transition matrix, deterministic in seed."""
        rng = np.random.default_rng(self.seed)
        m = rng.dirichlet(np.ones(self.markov_states) * 0.3, size=self.markov_states)
        return m.astype(np.float32)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        """Batch ``index`` -> {'tokens': (B, S+1) int32}, host-side numpy."""
        rng = np.random.default_rng((self.seed * 1_000_003 + index) & 0x7FFFFFFF)
        chain = self._chain()
        B, S = self.global_batch, self.seq_len + 1
        states = np.empty((B, S), dtype=np.int64)
        states[:, 0] = rng.integers(0, self.markov_states, size=B)
        for t in range(1, S):
            p = chain[states[:, t - 1]]
            cum = np.cumsum(p, axis=-1)
            u = rng.random(B)[:, None]
            states[:, t] = (u > cum).sum(axis=-1)
        # lift the Markov state to the vocabulary by a fixed affine map (so
        # the stream stays learnable down to the chain's entropy), plus noise
        stride = max(1, self.vocab_size // self.markov_states)
        salt = np.random.default_rng(self.seed).integers(0, stride, size=self.markov_states)
        tokens = states * stride + salt[states]
        noise = rng.random((B, S)) < self.noise_prob
        tokens = np.where(noise, rng.integers(0, self.vocab_size, size=(B, S)), tokens)
        tokens = np.clip(tokens, 0, self.vocab_size - 1).astype(np.int32)
        return {"tokens": tokens}


def make_lm_batch(pipeline: TokenPipeline, index: int, device=None) -> dict[str, torch.Tensor]:
    """Split a (B, S+1) token block into inputs and labels, int64 tensors
    on ``device`` (``None`` is ``cuda:0``)."""
    dev = resolve_device(device)
    raw = pipeline.batch(index)["tokens"]
    return {"tokens": torch.from_numpy(raw[:, :-1].astype(np.int64)).to(dev),
            "labels": torch.from_numpy(raw[:, 1:].astype(np.int64)).to(dev)}


def shard_batch(batch: dict, mesh, spec: tuple) -> dict:
    """Place a batch (host arrays or tensors) onto ``mesh`` under ``spec``:
    a DTensor per leaf (``distribute_tensor``), each rank holding its shard
    on the mesh's device."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.specs import placements

    where = placements(spec, mesh)
    return {k: distribute_tensor(torch.as_tensor(v), mesh, where) for k, v in batch.items()}
