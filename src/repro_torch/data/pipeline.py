"""Deterministic synthetic LM data.

Counterpart of ``repro/data/pipeline.py``.  ``SyntheticLM`` is a NumPy
copy of the JAX package's class and draws the same batches bit for bit:
a batch is a pure function of (seed, step, host), a mixture of
Zipf-distributed tokens and repeated 16-grams so the loss can fall.
``make_batch`` puts one on a device (the card unless told otherwise),
with an encoder-decoder config's stub frames drawn as the JAX package
draws them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.relation import resolve_device
from ..models.params import torch_dtype


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, *, host_index: int = 0,
              host_count: int = 1) -> dict:
        """Host-sharded batch for ``step`` (NumPy int32 tokens and labels,
        the labels the tokens shifted left by one)."""
        per_host = self.global_batch // host_count
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + host_index)
        zipf = rng.zipf(1.3, size=(per_host, self.seq_len))
        tokens = np.minimum(zipf, self.vocab_size - 1).astype(np.int32)
        # inject learnable structure: periodic ngrams
        period = 16
        base = rng.integers(0, self.vocab_size, size=(per_host, period))
        idx = np.arange(self.seq_len) % period
        structured = base[:, idx]
        mix = rng.random((per_host, self.seq_len)) < 0.7
        tokens = np.where(mix, structured, tokens).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": tokens, "labels": labels}


def enc_frames(cfg, batch: int, step: int, device, dtype="bfloat16"):
    """Stub encoder frames (batch, F, d_model), N(0, 0.02^2) from
    ``default_rng(step)``, in ``dtype``."""
    rng = np.random.default_rng(step)
    f = rng.standard_normal((batch, cfg.encoder.num_frames,
                             cfg.d_model)) * 0.02
    return torch.from_numpy(f).to(device, torch_dtype(dtype))


def make_batch(cfg, shape, step: int = 0, *, device=None) -> dict:
    """Step ``step``'s batch of ``shape`` on ``device`` (the card unless
    told otherwise): int32 tokens and labels, plus bf16 ``enc_frames``
    for an encoder-decoder config."""
    device = resolve_device(device)
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    out = {k: torch.from_numpy(v).to(device)
           for k, v in ds.batch(step).items()}
    if cfg.encoder:
        out["enc_frames"] = enc_frames(cfg, shape.global_batch, step, device)
    return out
