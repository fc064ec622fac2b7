"""Deterministic synthetic token pipeline (port of ``repro.train.data``).

Batches are a mixture of Zipfian unigrams and short-range Markov
structure (so the loss actually decreases), and their contents are a pure
function of (seed, step): exactly reproducible across restarts. They are
drawn from the port's threefry stream (``core.prng``), which is
``jax.random``'s, so the tokens and labels are bitwise the reference's for
the same (seed, step). The draws run on the batch's device: at qwen2's
vocabulary, batch 4 and sequence 1024 the categorical's Gumbel noise
alone is 4 × 1025 × 151936 floats, drawn a block of rows at a time.

The ``audio`` family's batches also carry ``frames``, the reference's
``normal(fold_in(PRNGKey(seed ^ 7), step), (B, n_frames, d_model))`` in
the activation type (``prng.normal``: bitwise in bfloat16, within a few
ULP in float32); the ``vlm`` family's carry ``patch_embeds``, drawn the
same way from ``PRNGKey(seed ^ 9)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.lm import act_dtype


def zipf_logits(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** alpha
    return np.log(p / p.sum()).astype(np.float32)


def _gen(seed: int, step: int, *, batch: int, seq: int, vocab: int,
         device: torch.device):
    """-> (tokens, labels), each (batch, seq) int32 on ``device``."""
    key = prng.fold_in(prng.PRNGKey(seed, device), step)
    logits = torch.from_numpy(zipf_logits(vocab)).to(device)
    base = prng.categorical(key, logits, shape=(batch, seq + 1))
    # short-range structure: token_{t+1} correlates with token_t
    k2 = prng.fold_in(key, 1)
    copy_mask = prng.uniform(k2, (batch, seq + 1)) < 0.3   # bernoulli(0.3)
    shifted = torch.roll(base, 1, dims=1)
    toks = torch.where(copy_mask, (shifted + 1) % vocab, base)
    return (toks[:, :-1].to(torch.int32).contiguous(),
            toks[:, 1:].to(torch.int32).contiguous())


def make_batch_fn(cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
                  batch_override: int | None = None,
                  device: str | torch.device = "cuda"):
    """``batch_fn(step) -> {"tokens", "labels"}`` on ``device``, and
    ``"frames"`` (B, n_frames, d_model) for the ``audio`` family,
    ``"patch_embeds"`` (B, n_frames, d_model) for the ``vlm`` family."""
    dev = resolve_device(device)
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def batch_fn(step: int) -> dict:
        toks, labels = _gen(seed, step, batch=B, seq=S,
                            vocab=cfg.vocab_size, device=dev)
        batch = {"tokens": toks, "labels": labels}
        extra = {"audio": ("frames", 7), "vlm": ("patch_embeds", 9)}
        if cfg.family in extra:
            name, salt = extra[cfg.family]
            key = prng.fold_in(prng.PRNGKey(seed ^ salt, dev), step)
            batch[name] = prng.normal(
                key, (B, cfg.encoder.n_frames, cfg.d_model),
                dtype=act_dtype(cfg))
        return batch

    return batch_fn
