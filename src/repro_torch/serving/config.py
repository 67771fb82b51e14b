"""Engine configuration (the port of `repro.serving.config`).

`EngineConfig` keeps the JAX package's field names and defaults, so a
config reads the same in both packages. The port serves the dense
per-slot arena (`paged=False`, the default) and paged fp, int8 and int4
pools, with or without KV-split decode, prefix sharing (`prefix_sharing`,
on by default as in the JAX package; it means nothing to the dense arena),
speculative decoding (`speculative=SpecConfig(...)` from
`serving/speculative.py`) and either scheduler of `serving/scheduler.py`
(`FifoScheduler`, the default, or the preemptive `SloScheduler`, paged
only), with or without telemetry (`telemetry=Telemetry(...)` from
`serving/telemetry.py`), its roofline priced against `hardware` (a key of
`serving/costmodel.HARDWARE_SPECS`; None: the engine's device decides),
and with `mesh` (a `DeviceMesh` whose dimension behind the logical "model"
axis shards the paged pools' KV heads: tensor-parallel serving, one
process a rank). The JAX package's rules for preemption, chunked prefill,
the pool dtype, the scale dtype, the hardware name, `kv_splits`,
speculation and the mesh raise its `ValueError`s word for word.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.distributed import api as dist_api

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

    def tensor_parallel(self) -> int:
        """Extent of the mesh dimension behind the logical "model" axis (1
        with no mesh or no such dimension): the pool shard count."""
        return dist_api.axis_size(self.mesh, "model")

    def validate(self, model_cfg) -> None:
        """Raise the reference's ValueError on a bad value or combination."""
        if self.scheduler is not None and self.scheduler.preemptive \
                and not self.paged:
            raise ValueError(
                "preemptive scheduling requires paged=True: preemption "
                "swaps pool pages to the host tier, which the dense "
                "backend does not have")
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
        if self.hardware is not None:
            from repro_torch.serving.costmodel import HARDWARE_SPECS
            if self.hardware not in HARDWARE_SPECS:
                raise ValueError(
                    f"unknown hardware {self.hardware!r}; known roofline "
                    f"specs: {sorted(HARDWARE_SPECS)}")
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
        if self.mesh is not None:
            if not self.paged:
                raise ValueError(
                    "mesh sharding requires paged=True: only the paged "
                    "KV pools are PartitionSpec-sharded; the dense "
                    "backend's per-slot arenas are single-device")
            tp = self.tensor_parallel()
            if tp > 1 and model_cfg.n_kv_heads % tp:
                raise ValueError(
                    f"mesh 'model' axis size {tp} must divide "
                    f"n_kv_heads ({model_cfg.n_kv_heads}) to shard the "
                    "KV-head axis of the page pools")
