"""Engine configuration (the port of `repro.serving.config`).

`EngineConfig` keeps the JAX package's field names and defaults, so a
config reads the same in both packages. The port serves FIFO over the
dense per-slot arena (`paged=False`, the default) and over paged fp, int8
and int4 pools, with or without KV-split decode, prefix sharing
(`prefix_sharing`, on by default as in the JAX package; it means nothing
to the dense arena) and speculative decoding (`speculative=SpecConfig(...)`
from `serving/speculative.py`). Every feature it lacks raises
`NotImplementedError` in `validate` instead of being ignored, and the JAX
package's rules for chunked prefill, the pool dtype, the scale dtype,
`kv_splits` and speculation raise its `ValueError`s word for word.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Per-request generation settings."""
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = 0
    stop_on_eos: bool = True


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything `ServingEngine` needs beyond (params, model, engine)."""
    slots: int
    max_len: int
    gen: GenConfig = GenConfig()
    paged: bool = False
    page_size: int = 16
    num_pages: Optional[int] = None
    prefix_sharing: bool = True
    prefill_chunk_tokens: Optional[int] = None
    kv_cache_dtype: Optional[str] = None
    kv_scale_dtype: str = "float32"
    speculative: Optional[Any] = None
    scheduler: Optional[Any] = None
    telemetry: Optional[Any] = None
    seed: int = 0
    mesh: Optional[Any] = None
    kv_splits: Optional[int] = None
    hardware: Optional[str] = None

    def resolved_kv_dtype(self, model_cfg) -> str:
        return (self.kv_cache_dtype if self.kv_cache_dtype is not None
                else model_cfg.kv_dtype)

    def validate(self, model_cfg) -> None:
        """Raise on what the port does not serve, then on bad values."""
        missing = []
        if self.scheduler is not None and getattr(self.scheduler, "name", None) != "fifo":
            missing.append("schedulers other than FIFO")
        if self.telemetry is not None:
            missing.append("telemetry")
        if self.mesh is not None:
            missing.append("mesh sharding")
        if self.hardware is not None:
            missing.append("the roofline cost model (hardware=)")
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing))
        if self.slots < 1 or self.max_len < 1:
            raise ValueError("slots and max_len must be >= 1")
        if self.paged and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk_tokens is not None:
            if self.prefill_chunk_tokens < 1:
                raise ValueError("prefill_chunk_tokens must be >= 1, got "
                                 f"{self.prefill_chunk_tokens}")
            if not self.paged:
                raise ValueError(
                    "prefill_chunk_tokens requires paged=True: the dense "
                    "backend prefills whole prompts into per-slot arenas "
                    "and would silently ignore the chunk budget")
        resolved_kv = self.resolved_kv_dtype(model_cfg)
        if resolved_kv not in ("model", "int8", "int4"):
            raise ValueError(f"unknown kv_cache_dtype {resolved_kv!r}")
        if self.kv_cache_dtype is not None and not self.paged \
                and self.kv_cache_dtype != model_cfg.kv_dtype:
            raise ValueError(
                "kv_cache_dtype selects the paged pool storage; the dense "
                "backend's arena dtype comes from cfg.kv_dtype")
        if self.kv_scale_dtype != "float32" \
                and resolved_kv not in ("int8", "int4"):
            raise ValueError(
                "kv_scale_dtype selects the int8/int4 pools' scale-row "
                "storage; fp pools have no scale rows")
        if resolved_kv == "int4":
            if model_cfg.head_dim % 2:
                raise ValueError(
                    "kv_cache_dtype='int4' packs two values per byte and "
                    f"needs an even head_dim, got {model_cfg.head_dim}")
            if self.kv_scale_dtype != "bfloat16":
                raise ValueError(
                    "kv_cache_dtype='int4' requires "
                    "kv_scale_dtype='bfloat16': f32 scale rows would "
                    "spend the bytes the nibble packing just saved")
        if self.kv_splits is not None:
            if self.kv_splits < 1:
                raise ValueError(
                    f"kv_splits must be >= 1, got {self.kv_splits}")
            if self.kv_splits > 1 and not self.paged:
                raise ValueError(
                    "kv_splits requires paged=True: the KV-split path "
                    "partitions the block-table page walk; the dense "
                    "backend has no pages to split")
        if self.speculative is not None:
            self.speculative.validate()
            if not self.paged:
                raise ValueError(
                    "speculative decoding requires paged=True: rollback "
                    "is in-pool (rewind lengths + unmap tail pages)")
            if self.gen.temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only: acceptance "
                    "compares drafts against argmax, which is exact "
                    "only at temperature 0")
