"""Deterministic synthetic data pipeline.

Port of src/repro/train/data.py. Every batch is a pure function of
(seed, step). Tokens follow an order-1 Markov chain whose transition
table comes from `np.random.default_rng(seed)`, bit-equal to the
reference's. The reference draws each batch's first tokens and branch
choices with `jax.random`, which torch cannot replay; the port draws them
with numpy from `np.random.default_rng([seed, step])`, so its batches
have the same law but not the same tokens (ROADMAP §C). Frontend stub
embeddings and per-shard slices come with training (ROADMAP A14).
"""
from __future__ import annotations

import numpy as np
import torch


def _markov_logits(vocab: int, seed: int, branch: int = 32) -> np.ndarray:
    """Sparse-ish row-stochastic transition matrix (vocab, branch)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch))


class SyntheticLM:
    """tokens[t+1] = transition[tokens[t], choice] — learnable structure.
    Batches are CPU tensors; the caller moves them to its device."""

    def __init__(self, cfg, seed: int = 0, branch: int = 32):
        self.cfg = cfg
        self.vocab = cfg.vocab_size
        self.branch = branch
        self.nexts = _markov_logits(self.vocab, seed, branch)
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        first = rng.integers(0, self.vocab, batch_size)
        choices = rng.integers(0, self.branch, (batch_size, seq_len - 1))
        tokens = np.empty((batch_size, seq_len), dtype=np.int64)
        tokens[:, 0] = first
        for t in range(1, seq_len):
            tokens[:, t] = self.nexts[tokens[:, t - 1], choices[:, t - 1]]
        tokens = torch.from_numpy(tokens.astype(np.int32))
        return {"tokens": tokens, "labels": tokens.clone()}
