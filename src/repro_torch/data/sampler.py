"""Global uniform batch sampler — a copy of ``repro.data.sampler``'s
``SamplerState`` and ``GlobalUniformSampler`` (the paper's access pattern:
a per-epoch global shuffle sliced into global batches; same seed, same
batches). Its cursor is what a checkpoint's manifest carries."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SamplerState:
    """Checkpointable cursor: (epoch, step-within-epoch) + base seed."""
    seed: int
    epoch: int = 0
    step: int = 0


class GlobalUniformSampler:
    """Per-epoch global shuffle, sliced into global batches (paper §3.1)."""

    def __init__(self, num_samples: int, global_batch: int, *, seed: int = 0):
        if global_batch > num_samples:
            raise ValueError("global batch exceeds dataset size")
        self.num_samples = num_samples
        self.global_batch = global_batch
        self.state = SamplerState(seed=seed)

    @property
    def steps_per_epoch(self) -> int:
        return self.num_samples // self.global_batch

    def _advance(self) -> None:
        self.state.step += 1
        if self.state.step >= self.steps_per_epoch:
            self.state.step = 0
            self.state.epoch += 1

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.state.seed, epoch))
        return rng.permutation(self.num_samples)

    def next_batch(self) -> np.ndarray:
        perm = self._perm(self.state.epoch)
        lo = self.state.step * self.global_batch
        batch = perm[lo: lo + self.global_batch].astype(np.int32)
        self._advance()
        return batch
