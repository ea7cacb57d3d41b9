"""LM token sequences for the training path — a copy of
``repro.data.synthetic.token_dataset`` (same seed, same tokens)."""
from __future__ import annotations

import numpy as np


def token_dataset(num_samples: int, seq_len: int, vocab: int, *, seed: int = 0
                  ) -> np.ndarray:
    """LM training corpus: (num_samples, seq_len) int32 token ids.

    Generated from a tiny order-1 Markov chain so a model can actually learn
    structure (loss decreases) in the end-to-end example.
    """
    rng = np.random.default_rng(seed)
    k = min(vocab, 64)
    trans = rng.dirichlet(np.ones(k) * 0.2, size=k)
    out = np.empty((num_samples, seq_len), dtype=np.int32)
    state = rng.integers(0, k, num_samples)
    for t in range(seq_len):
        out[:, t] = state
        u = rng.random(num_samples)
        cdf = np.cumsum(trans[state], axis=1)
        state = (u[:, None] < cdf).argmax(axis=1)
    return out % vocab
