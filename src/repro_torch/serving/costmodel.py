"""Analytical per-step, per-phase bytes/FLOPs cost model (the roofline),
the port of `repro.serving.costmodel`.

SAL-PIM's argument — and PIM-GPT's / HPIM's before placing work — is
that generation-stage decode is *memory-bound*: every emitted token
streams the whole model plus the resident KV history with almost no
reuse, so arithmetic intensity sits far below any machine's ridge
point. The telemetry layer measures where a step's milliseconds go;
this module prices what those milliseconds *moved*: an analytical
bytes/FLOPs model per engine phase, derived from `ModelConfig` +
`EngineConfig` + the live pool state the engine observes each step.

    model = CostModel.from_configs(model_cfg, engine_cfg)
    costs = model.step_costs(shape)        # {phase: PhaseCost}
    model.per_device(costs)                # mesh: per-device traffic

Combined with the measured phase wall-times (`Telemetry.record_step`)
the model yields achieved GB/s, achieved GFLOP/s, and a memory-bound /
compute-bound classification per phase — `snapshot()["roofline"]`,
Chrome-trace counter tracks, and `engine.stats()["roofline"]`.

What each phase streams (one model call each):

  decode        — the streamed weights once (shared by the whole decode
                  batch), each live slot's resident KV page-rounded
                  (the kernel DMAs whole pages through the block
                  table), one appended KV token per slot, and the
                  logits row per slot.
  chunk_prefill — weights once, KV read back through position
                  start+n (earlier chunks re-read via the block
                  table), n tokens of KV written, one logits row.
  verify        — weights once; per surviving slot the resident KV
                  plus the k+1 candidate positions (page-rounded),
                  k+1 KV writes, and (k+1) logits rows.
  draft         — draft-model mode: the draft model's weights streamed
                  once per draft forward (its dense per-slot KV cache
                  is negligible against the weight stream and is not
                  modeled). The n-gram drafter is host-side: 0 bytes.
  admit         — dense backend only: a whole-prompt prefill
                  (paged admission is host-side bookkeeping: 0 bytes).

KV bytes are dtype-aware through the kernels' own byte contract
(`kernels/paged_attention.kv_vector_bytes`): fp Dh*itemsize, int8
(Dh + scale), int4 (Dh/2 + scale) bytes per (token, head) vector —
the same math `kvcache.page_kv_bytes` sizes pools with, so modeled
traffic and measured `peak_pages * page_bytes` cannot drift.

Weights are priced at `cfg.pdtype`'s item size, as in the reference,
also when they were quantized to int8 beforehand (`QTensor`).

Under a mesh `per_device()` divides the KV-head-sharded pool traffic by
the tensor-parallel width, keeps the replicated weight stream whole, and
adds `gather_heads` receive traffic — per attended token each device
all-gathers the other shards' head outputs ((tp-1)/tp of H*Dh*itemsize
per token per layer). The engine's `tensor_parallel` is its mesh's
"model" extent (`EngineConfig.tensor_parallel`); at 1 `per_device()` is
the identity.

KV-split (`kv_splits`) deliberately does NOT appear here: splitting
the page walk changes wall-time (parallelism), not bytes moved — the
same pages are read either way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_attention import kv_vector_bytes

__all__ = ["CostModel", "HardwareSpec", "PhaseCost", "StepShape",
           "HARDWARE_SPECS", "detect_hardware"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One roofline: peak compute vs peak memory bandwidth.

    `ridge` (FLOP/byte) is the arithmetic intensity where the two roofs
    cross; phases below it are memory-bound, above it compute-bound.
    The specs below are public datasheet numbers, coarse on purpose —
    the classification only needs the right order of magnitude (decode
    intensity is ~1 FLOP/byte, ridges are 10-300).
    """

    name: str
    peak_flops: float            # FLOP/s
    peak_bytes_per_sec: float    # B/s

    @property
    def ridge(self) -> float:
        return self.peak_flops / self.peak_bytes_per_sec

    def classify(self, intensity: float) -> str:
        return "memory" if intensity < self.ridge else "compute"

    def to_dict(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "peak_bytes_per_sec": self.peak_bytes_per_sec,
                "ridge_flops_per_byte": self.ridge}


HARDWARE_SPECS: dict[str, HardwareSpec] = {
    # An HBM2 stack as the SAL-PIM paper baselines against: 307.2 GB/s
    # per stack, paired with a ~100 TFLOP/s-class accelerator.
    "hbm2": HardwareSpec("hbm2", 100e12, 307.2e9),
    # SAL-PIM's subarray-level PIM: the paper's 8x internal-bandwidth
    # multiplier over the HBM2 interface, compute sized to the in-DRAM
    # ALUs (the point is the ridge moves *left*).
    "salpim-hbm2": HardwareSpec("salpim-hbm2", 4.9e12, 2457.6e9),
    # NVIDIA H100 80GB HBM3, 700 W (SXM data sheet): 989 TFLOP/s bf16
    # dense on the tensor cores, 3.35 TB/s HBM3. chip_smoke.py's kernel
    # bounds read these two numbers from here.
    "h100": HardwareSpec("h100", 989e12, 3.35e12),
    # A generous host CPU (AVX-class vector units, ~100 GB/s DDR) for
    # the CPU runs of the tests.
    "cpu": HardwareSpec("cpu", 1e12, 100e9),
}

# NVLink 4 between the cards of an H100 SXM host (data sheet): 900 GB/s a
# card, 450 GB/s each way; the dry run's collective term (launch/roofline.py).
H100_LINK_BYTES_PER_SEC = 450e9


def detect_hardware(device) -> HardwareSpec:
    """The roofline of the engine's `device`: `cpu` for the CPU, `h100`
    for a CUDA device whose name says H100. Any other card raises, asking
    for `EngineConfig(hardware=...)`: a GPU run is never priced against
    the CPU's roofline."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return HARDWARE_SPECS["cpu"]
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        if "H100" in name:
            return HARDWARE_SPECS["h100"]
    else:
        name = str(dev)
    raise ValueError(
        f"no roofline spec for {name!r}; pass EngineConfig(hardware=...) "
        f"with one of {sorted(HARDWARE_SPECS)}")


@dataclasses.dataclass
class PhaseCost:
    """Traffic and work one phase's program launch costs, by component
    (components stay separate so `per_device` can shard KV traffic
    without touching the replicated weight stream)."""

    weight_bytes: float = 0.0    # streamed parameters
    kv_bytes: float = 0.0        # page-pool reads + writes
    act_bytes: float = 0.0       # logits / collective activations
    linear_flops: float = 0.0    # matmul work (2 * params * tokens)
    attn_flops: float = 0.0      # attention score + value work

    @property
    def bytes(self) -> float:
        return self.weight_bytes + self.kv_bytes + self.act_bytes

    @property
    def flops(self) -> float:
        return self.linear_flops + self.attn_flops

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes else 0.0

    def add(self, other: "PhaseCost") -> "PhaseCost":
        return PhaseCost(
            self.weight_bytes + other.weight_bytes,
            self.kv_bytes + other.kv_bytes,
            self.act_bytes + other.act_bytes,
            self.linear_flops + other.linear_flops,
            self.attn_flops + other.attn_flops)

    def to_dict(self) -> dict:
        return {"bytes": self.bytes, "flops": self.flops,
                "weight_bytes": self.weight_bytes,
                "kv_bytes": self.kv_bytes, "act_bytes": self.act_bytes,
                "linear_flops": self.linear_flops,
                "attn_flops": self.attn_flops,
                "arithmetic_intensity": self.intensity}


@dataclasses.dataclass
class StepShape:
    """What one engine step actually ran — the live-state inputs the
    engine collects at step boundaries and hands to `step_costs`."""

    # Per live decoding slot: resident KV length the decode attention
    # reads (including the token appended this step). Empty = the
    # decode program did not run (or ran over dead rows only).
    decode_lens: list = dataclasses.field(default_factory=list)
    # Whether the decode program launched at all (weights stream even
    # when every batch row died this step).
    decode_ran: bool = False
    # (start_offset, n_tokens) of this step's prompt chunk, or None.
    chunk: Optional[tuple] = None
    # Per surviving speculative slot: (resident_len_before,
    # n_candidate_positions) scored by the verify forward.
    verify: list = dataclasses.field(default_factory=list)
    # Draft-model forwards this step (0 for the host-side n-gram
    # drafter, ~proposed tokens for draft-model mode).
    draft_forwards: int = 0
    # Dense admission: whole-prompt prefill token count (paged
    # admission is host-side only and costs 0 bytes).
    admit_prompt_tokens: int = 0


class CostModel:
    """Bytes/FLOPs calculator for one engine's configuration.

    Pure host arithmetic over ints — safe to call every step (the
    engine accumulates modeled traffic whether or not telemetry is
    attached; a step costs a handful of multiplies per live slot).
    """

    def __init__(self, model_cfg, *, page_size: int = 1,
                 kv_dtype: str = "model", kv_scale_dtype: str = "float32",
                 tensor_parallel: int = 1,
                 draft_cfg=None, hardware: Optional[HardwareSpec] = None,
                 device="cuda"):
        cfg = model_cfg
        self.cfg = cfg
        self.page_size = max(int(page_size), 1)
        self.kv_dtype = kv_dtype
        self.kv_scale_dtype = kv_scale_dtype
        self.tp = max(int(tensor_parallel), 1)
        self.hardware = hardware if hardware is not None else \
            detect_hardware(device)
        # -- KV byte anchors (kernel DMA contract) -----------------------
        self.vec_bytes = kv_vector_bytes(cfg.head_dim, kv_dtype,
                                         kv_scale_dtype,
                                         payload_dtype=cfg.cdtype)
        # K + V, all layers, one token.
        self.kv_token_bytes = 2 * cfg.n_layers * cfg.n_kv_heads \
            * self.vec_bytes
        self.page_bytes = self.kv_token_bytes * self.page_size
        # -- weight stream ----------------------------------------------
        # Parameters one forward launch streams: active params (MoE:
        # top_k experts) minus the input embedding table — decode
        # gathers one row of it, it is never streamed whole. The LM
        # head (vocab x d) IS streamed: the logits matmul reads it all.
        pbytes = cfg.pdtype.itemsize
        streamed = cfg.active_param_count() - cfg.vocab * cfg.d_model
        self.weight_stream_bytes = streamed * pbytes
        self.params_streamed = streamed
        self.logits_row_bytes = cfg.vocab * 4          # f32 logits out
        if draft_cfg is not None:
            dbytes = draft_cfg.pdtype.itemsize
            dstreamed = draft_cfg.active_param_count() \
                - draft_cfg.vocab * draft_cfg.d_model
            self.draft_stream_bytes = dstreamed * dbytes
            self.draft_params_streamed = dstreamed
        else:
            self.draft_stream_bytes = 0
            self.draft_params_streamed = 0
        # gather_heads: per attended token per layer each device
        # receives the other tp-1 shards' (H/tp, Dh) head outputs in
        # the compute dtype (distributed/collectives.gather_heads).
        cbytes = cfg.cdtype.itemsize
        self.gather_bytes_per_token = (
            cfg.n_layers * (self.tp - 1) * (cfg.n_heads // self.tp)
            * cfg.head_dim * cbytes) if self.tp > 1 else 0

    @classmethod
    def from_configs(cls, model_cfg, engine_cfg,
                     hardware: Optional[HardwareSpec] = None,
                     device="cuda") -> "CostModel":
        """Derive the model from an `EngineConfig` (resolved KV dtype,
        page size, mesh width, draft model) — the engine's constructor
        path. The roofline is `hardware`, else the config's `hardware`
        name, else the one `detect_hardware(device)` finds."""
        spec = engine_cfg.speculative
        draft_cfg = spec.draft_cfg if spec is not None else None
        hw = hardware
        if hw is None:
            name = getattr(engine_cfg, "hardware", None)
            hw = HARDWARE_SPECS[name] if name else None
        return cls(
            model_cfg,
            page_size=engine_cfg.page_size if engine_cfg.paged else 1,
            kv_dtype=engine_cfg.resolved_kv_dtype(model_cfg),
            kv_scale_dtype=engine_cfg.kv_scale_dtype,
            tensor_parallel=engine_cfg.tensor_parallel(),
            draft_cfg=draft_cfg, hardware=hw, device=device)

    # -- per-phase pieces ----------------------------------------------------
    def kv_read_bytes(self, length: int) -> float:
        """Resident-KV read traffic for one slot at `length` tokens,
        page-rounded: the kernels DMA whole pages through the block
        table, so a 17-token sequence at page_size 16 reads 32 tokens'
        worth of pool."""
        if length <= 0:
            return 0.0
        pages = -(-length // self.page_size)
        return pages * self.page_size * self.kv_token_bytes

    def _attn_flops(self, attended: float) -> float:
        """Attention work over `attended` total (query, key) pairs:
        QK^T and PV are each 2 * H * Dh MACs per pair."""
        return 4.0 * self.cfg.n_heads * self.cfg.head_dim \
            * self.cfg.n_layers * attended

    def _forward(self, n_tokens: int, attended: float,
                 kv_read: float) -> PhaseCost:
        """One target-model launch scoring n_tokens total (any batch
        layout): weights stream once, KV reads as given, n_tokens KV
        vectors written, attention over `attended` (query, key) pairs."""
        return PhaseCost(
            weight_bytes=float(self.weight_stream_bytes),
            kv_bytes=kv_read + n_tokens * self.kv_token_bytes,
            act_bytes=float(n_tokens * self.logits_row_bytes),
            linear_flops=2.0 * self.params_streamed * n_tokens,
            attn_flops=self._attn_flops(attended))

    def decode(self, lens) -> PhaseCost:
        """One decode launch over live slots with post-append resident
        lengths `lens` (each slot's single query attends to its whole
        resident history)."""
        lens = [int(x) for x in lens]
        kv_read = sum(self.kv_read_bytes(x) for x in lens)
        return self._forward(len(lens), float(sum(lens)), kv_read)

    def chunk_prefill(self, start: int, n_tokens: int) -> PhaseCost:
        """One prompt chunk of n tokens starting at offset `start`:
        causal attention inside the chunk plus reads back the resident
        prefix; query t attends start + t + 1 positions."""
        attended = n_tokens * start + n_tokens * (n_tokens + 1) / 2.0
        kv_read = self.kv_read_bytes(start + n_tokens)
        return self._forward(n_tokens, attended, kv_read)

    def verify(self, entries) -> PhaseCost:
        """One verify launch scoring each survivor's k+1 candidates —
        exactly a batch of chunk-prefill rows (same kernel dispatch)."""
        cost = PhaseCost(weight_bytes=float(self.weight_stream_bytes))
        for length, n_pos in entries:
            row = self.chunk_prefill(int(length), int(n_pos))
            cost.kv_bytes += row.kv_bytes
            cost.act_bytes += row.act_bytes
            cost.linear_flops += row.linear_flops
            cost.attn_flops += row.attn_flops
        return cost

    def draft(self, forwards: int) -> PhaseCost:
        """Draft-model streams: `forwards` launches of the draft model
        (0 for the host-side n-gram drafter). The draft's dense KV
        cache traffic is negligible against its weight stream."""
        if forwards <= 0 or self.draft_stream_bytes == 0:
            return PhaseCost()
        return PhaseCost(
            weight_bytes=float(forwards * self.draft_stream_bytes),
            linear_flops=2.0 * self.draft_params_streamed * forwards)

    def step_costs(self, shape: StepShape) -> dict:
        """The full per-step picture: {phase: PhaseCost} for the phases
        that ran (keys are a subset of telemetry's `_PHASES`)."""
        costs: dict[str, PhaseCost] = {}
        if shape.admit_prompt_tokens > 0:
            n = shape.admit_prompt_tokens
            costs["admit"] = self._forward(
                n, n * (n + 1) / 2.0, 0.0)
        if shape.chunk is not None:
            costs["chunk_prefill"] = self.chunk_prefill(*shape.chunk)
        if shape.draft_forwards > 0:
            costs["draft"] = self.draft(shape.draft_forwards)
        if shape.verify:
            costs["verify"] = self.verify(shape.verify)
        if shape.decode_ran or shape.decode_lens:
            costs["decode"] = self.decode(shape.decode_lens)
        return costs

    # -- mesh ---------------------------------------------------------------
    def per_device(self, costs: dict) -> dict:
        """Per-device traffic under the tensor-parallel mesh: the pool
        shards over KV heads (KV bytes / tp), weights replicate (every
        device streams them whole), and the head merge adds
        gather_heads receive bytes per attended query token. Attention
        work divides by tp (each device runs its head slice); the
        replicated linear layers do not."""
        if self.tp <= 1:
            return {phase: c for phase, c in costs.items()}
        out: dict[str, PhaseCost] = {}
        for phase, c in costs.items():
            # Query tokens this launch scored, recovered from the
            # logits traffic (one f32 row per scored token).
            n_tokens = c.act_bytes / self.logits_row_bytes \
                if self.logits_row_bytes else 0.0
            gather = (self.gather_bytes_per_token * n_tokens
                      if phase != "draft" else 0.0)
            out[phase] = PhaseCost(
                weight_bytes=c.weight_bytes,
                kv_bytes=c.kv_bytes / self.tp,
                act_bytes=c.act_bytes + gather,
                linear_flops=c.linear_flops,
                attn_flops=c.attn_flops / self.tp)
        return out

    # -- static description (snapshot / docs / bench) -----------------------
    def describe(self) -> dict:
        """JSON-ready static facts: the bytes/vector table, the weight
        stream, the mesh division — everything the roofline section
        reports that does not depend on a live step."""
        cfg = self.cfg
        return {
            "hardware": self.hardware.to_dict(),
            "kv_dtype": self.kv_dtype,
            "kv_scale_dtype": self.kv_scale_dtype,
            "kv_bytes_per_vector": self.vec_bytes,
            "kv_bytes_per_token": self.kv_token_bytes,
            "page_size": self.page_size,
            "page_bytes": self.page_bytes,
            "weight_stream_bytes": self.weight_stream_bytes,
            "draft_stream_bytes": self.draft_stream_bytes,
            "tensor_parallel": self.tp,
            "gather_bytes_per_token": self.gather_bytes_per_token,
            "model": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.head_dim, "d_model": cfg.d_model,
                      "vocab": cfg.vocab,
                      "params": cfg.param_count(),
                      "active_params": cfg.active_param_count()},
        }
