"""Deterministic synthetic LM data pipeline.

The port's own copy of the JAX package's `repro/data/pipeline.py`: batch
contents are a pure function of (seed, step, shard), drawn with numpy in the
same order, so both packages see the same token stream bit for bit.  Batches
are numpy int32 arrays; the caller moves them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    global_batch: int = 8
    seq_len: int = 128
    # markov-ish structure so losses are learnable, not pure noise
    structure: float = 0.7


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dcfg.seed, step, shard]))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Batch for one data shard; shards partition the global batch."""
        d = self.dcfg
        if d.global_batch % num_shards:
            raise ValueError(f"global batch {d.global_batch} does not split "
                             f"into {num_shards} shards")
        b = d.global_batch // num_shards
        rng = self._rng(step, shard)
        V = self.cfg.vocab
        # structured stream: blocks of repeated n-grams + noise
        base = rng.integers(0, V, size=(b, d.seq_len + 1), dtype=np.int32)
        if d.structure > 0:
            period = 8
            pattern = rng.integers(0, V, size=(b, period), dtype=np.int32)
            reps = -(-(d.seq_len + 1) // period)
            tiled = np.tile(pattern, (1, reps))[:, :d.seq_len + 1]
            mask = rng.random((b, d.seq_len + 1)) < d.structure
            base = np.where(mask, tiled, base)
        out = {"tokens": base[:, :-1], "labels": base[:, 1:]}
        if self.cfg.enc_dec:
            out["enc_feats"] = rng.standard_normal(
                (b, self.cfg.enc_frames, self.cfg.d_model)).astype(np.float32)
        return out

    def global_batch(self, step: int) -> dict:
        return self.batch(step, 0, 1)
