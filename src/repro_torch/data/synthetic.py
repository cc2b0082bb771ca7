"""Deterministic synthetic token pipeline.

Seeded, stateless-resumable (the iterator state is just the step index,
checkpointed alongside the model), and host-shardable: every host
computes only its slice of the global batch from the same seed, so any
host is replaceable after a failure (straggler/elastic story, DESIGN §8).

The token stream is a mixture of Zipfian unigrams and short repeated
motifs so models have actual structure to learn in the examples.

The reference's numpy generator, unchanged: the same seed and step give
the same batches in both packages. The dry run's stand-ins for a batch
are shapes and dtypes (:func:`input_shape_structs`), which the dry run
makes into fake tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** -cfg.zipf_a
    return p / p.sum()


class SyntheticDataset:
    """Batch generator; ``batch_at(step)`` is a pure function of
    (seed, step) => resumable and host-replaceable."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self._probs = _zipf_probs(cfg)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_index]))
        b, s = self.local_batch, cfg.seq_len + 1
        toks = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        # plant motifs: token t determined by token t-1 half the time
        shift = (toks[:, :-1] * 31 + 7) % cfg.vocab_size
        use = rng.random((b, s - 1)) < cfg.motif_prob
        toks[:, 1:] = np.where(use, shift, toks[:, 1:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype, the stand-in for
    ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_shape_structs(vocab_size: int, seq_len: int, global_batch: int,
                        prefix_len: int = 0, d_model: int = 0,
                        dtype=torch.bfloat16) -> Dict[str, ShapeDtype]:
    """Shapes and dtypes of a training batch (the dry run's stand-ins)."""
    st = seq_len - prefix_len
    out = {
        "tokens": ShapeDtype((global_batch, st), torch.int32),
        "labels": ShapeDtype((global_batch, st), torch.int32),
    }
    if prefix_len:
        out["prefix_emb"] = ShapeDtype((global_batch, prefix_len, d_model),
                                       dtype)
    return out
