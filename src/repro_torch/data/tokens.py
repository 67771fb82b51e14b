"""Deterministic, seekable synthetic data pipeline (the port's own copy of
`repro.data.tokens`, numpy only; batches stay numpy, and the train loop
moves them to the device).

Every batch is a pure function of (seed, step, shard) — a Philox counter
stream — so the checkpoint stores only the step cursor and a restart
replays identically (bit for bit the JAX package's batches). The
synthetic corpus is Zipf-distributed token ids arranged into "documents"
with EOS boundaries and packed into fixed-length rows (mask marks real
tokens; labels are next-token shifted).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

EOS = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 384
    zipf_a: float = 1.3
    # encdec / vlm stubs
    frames: Optional[tuple[int, int]] = None       # (enc_seq, d_model)
    patch_embeds: Optional[tuple[int, int]] = None  # (n_patches, d_model)


def _rng(cfg: DataConfig, step: int, shard: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[step, shard, 0, 0]))


def batch_at(cfg: DataConfig, step: int, *, shard: int = 0,
             n_shards: int = 1) -> dict:
    """The batch (or this shard's slice of it) at a given step cursor."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rng = _rng(cfg, step, shard)
    S = cfg.seq_len
    # Zipf body in [2, vocab); 0 is EOS, 1 is BOS.
    body = rng.zipf(cfg.zipf_a, size=(b, S)).astype(np.int64)
    tokens = 2 + (body % max(cfg.vocab - 2, 1))
    # Document boundaries: geometric lengths, EOS at ends.
    boundary = rng.random((b, S)) < (1.0 / cfg.mean_doc_len)
    tokens = np.where(boundary, EOS, tokens).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), EOS, np.int32)], 1)
    mask = np.ones((b, S), np.float32)
    out = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.frames is not None:
        senc, d = cfg.frames
        out["frames"] = rng.standard_normal((b, senc, d)).astype(np.float32)
    if cfg.patch_embeds is not None:
        p, d = cfg.patch_embeds
        out["patch_embeds"] = rng.standard_normal((b, p, d)).astype(np.float32)
    return out


@dataclasses.dataclass
class DataState:
    """The checkpointable cursor."""
    step: int = 0


def iterate(cfg: DataConfig, state: DataState, *, shard: int = 0,
            n_shards: int = 1) -> Iterator[dict]:
    while True:
        # Bump the cursor BEFORE yielding: if a checkpoint snapshots the
        # state while the consumer holds this batch, resume starts at the
        # first unconsumed step.
        batch = batch_at(cfg, state.step, shard=shard, n_shards=n_shards)
        state.step += 1
        yield batch


def data_config_for_model(model_cfg, seq_len: int, global_batch: int,
                          seed: int = 1234) -> DataConfig:
    frames = None
    patches = None
    if model_cfg.family == "encdec":
        frames = (model_cfg.enc_seq, model_cfg.d_model)
    if model_cfg.mrope_sections is not None:
        patches = (min(256, seq_len // 2), model_cfg.d_model)
    return DataConfig(vocab=model_cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      frames=frames, patch_embeds=patches)
