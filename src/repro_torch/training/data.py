"""Synthetic token pipeline (PyTorch port of ``repro.training.data``; no
external corpora).

Deterministic pseudo-language token streams with enough structure for a
small model to show decreasing loss over a few hundred steps: a mixture
of a first-order Markov chain over the vocabulary with a sparse
transition structure and repeated n-gram "phrases".  The numpy streams
are the reference's, draw for draw, so the same seed gives the same
tokens; they arrive as torch tensors on the device asked for.  Also the
modality-stub tensors of the vlm and encdec batches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 16          # out-degree of the Markov transition graph
    phrase_len: int = 8
    phrase_prob: float = 0.25

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        # sparse deterministic-ish transition table: V x branching
        self.table = rng.integers(0, V, size=(V, self.branching))
        self.table_p = rng.dirichlet(
            np.ones(self.branching) * 0.3, size=V).astype(np.float32)
        self.phrases = rng.integers(
            0, V, size=(64, self.phrase_len))

    def _sample_seq(self, rng) -> np.ndarray:
        V, S = self.vocab_size, self.seq_len + 1
        out = np.empty(S, np.int64)
        tok = rng.integers(0, V)
        i = 0
        while i < S:
            if rng.random() < self.phrase_prob:
                ph = self.phrases[rng.integers(0, len(self.phrases))]
                n = min(len(ph), S - i)
                out[i:i + n] = ph[:n]
                i += n
                tok = out[i - 1]
            else:
                j = rng.choice(self.branching, p=self.table_p[tok])
                tok = self.table[tok, j]
                out[i] = tok
                i += 1
        return out

    def batches(self, num_steps: Optional[int] = None,
                device=None) -> Iterator[dict]:
        """``{"tokens", "labels"}`` (batch_size, seq_len) int32 on
        ``device`` (None: the card), labels the tokens shifted by one."""
        device = resolve_device(device)
        rng = np.random.default_rng(self.seed + 1)
        step = 0
        while num_steps is None or step < num_steps:
            seqs = np.stack([self._sample_seq(rng)
                             for _ in range(self.batch_size)])
            seqs = torch.from_numpy(seqs.astype(np.int32)).to(device)
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
            step += 1


def add_modality_stub(batch: dict, cfg, seed: int = 0) -> dict:
    """Attach stub patch (vision frontend) or frame (encdec) embeddings,
    bf16 standard normal draws from ``seed`` (the reference's), on the
    tokens' device."""
    rng = np.random.default_rng(seed)
    B = batch["tokens"].shape[0]
    dev = batch["tokens"].device

    def stub(n):
        a = rng.standard_normal((B, n, cfg.d_model))
        return torch.from_numpy(a).to(torch.bfloat16).to(dev)

    if cfg.frontend == "vision":
        batch = dict(batch, patches=stub(cfg.num_patch_tokens))
    elif cfg.family == "encdec":
        batch = dict(batch, frames=stub(cfg.encoder_seq_len))
    return batch
