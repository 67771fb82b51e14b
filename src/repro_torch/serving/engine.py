"""Serving engine (the port of `repro.serving.engine`): `generate` and
`ServingEngine`.

`generate(params, prompts, cfg, engine, gen)` runs one prefill over a
batch of prompts into a dense arena of S + max_new_tokens + 1 positions,
then max_new_tokens decode steps in a Python loop (the JAX package's
`lax.scan`), sequences that hit EOS padding with EOS. `extra_inputs` joins
the prefill's batch: the encoder-decoder family (whisper) serves through
`generate(..., extra_inputs={"frames": frames})` alone, and
`ServingEngine` refuses it (`ENCDEC_REFUSAL`), since the reference's
dense admission prefills without frames and its paged cache refuses the
family.

`ServingEngine` batches requests continuously over a fixed decode batch
width of `slots`, in one of two modes.

Dense (`paged=False`, the default): one arena of `max_len` positions a
slot (the SSM family: a state and a conv window a layer; the hybrid: those
and its shared block's arenas). Admission prefills the whole prompt as a
batch of one and writes it into the slot's rows of the cache and its
`last_logits` in place; a released slot parks at length 0. The SSM and
hybrid families serve in this mode only: `paged=True` raises the
reference's `ValueError`.

Paged (`paged=True`): slots share one KV page pool. A request is admitted
only when its worst-case page count can be reserved, its prompt is
prefilled chunk by chunk straight into its pool pages
(`prefill_chunk_tokens` per engine step, None = the whole prompt in one
chunk), and it joins the shared decode batch when the prompt cursor
reaches the end. A mid-prefill slot keeps device length 0 and an
all-trash block-table row, so the decode step cannot touch its pages.
`kv_cache_dtype="int8"` stores the pools as int8 with per-(token, head)
scale rows (`kv_scale_dtype` f32 or bf16), `"int4"` packs two values a
byte with bf16 scale rows; both quantize at write time and the kernels
dequantize as they read. With `num_pages=None` the pool keeps the fp
pool's byte budget, so quantized pools hold proportionally more pages.
`kv_splits=K` runs decode attention as K page runs merged by the
combine, once the block table spans KV_SPLIT_MIN_CONTEXT tokens.

With `prefix_sharing` (the default) admission maps the longest run of
cached full prompt pages another request registered (`BlockAllocator.
admit_tokens`) and the prompt cursor starts past them; a chunk or a decode
write that would land in a still-shared page first forks it (COW:
`fork_page` + `kvcache.copy_page`, payload and scale rows). With
`speculative=SpecConfig(...)` each step after the chunk is a draft-verify
round (`_spec_round`): t0 from `last_logits`, the drafter's proposals, one
`verify_tokens` pass over (slots, k+1), greedy acceptance, and the
rejected tail rewound in the pool (`BlockAllocator.rewind` +
`kvcache.rewind_slot`).

`scheduler=` (serving/scheduler.py) makes the admission, prefill-order
and preemption decisions. `FifoScheduler` (the default, both modes) admits
in strict FIFO order under the watermark and never preempts.
`SloScheduler` (paged only) admits by priority class
(`submit(priority=...)`, lower = more urgent) under optimistic admission
and preempts when the pool runs dry (`_preempt`): a decoding victim's
pages go to the host swap tier (`kvcache.swap_out_slot` into
`swap_tier`) with its `last_logits` row, and `_swap_in` restores them into
fresh pages, so the request resumes bit for bit; a mid-prefill victim is
aborted and prefilled again on re-admission. Parked requests wait in
`swapped` and count as outstanding work in `step()` and `stats()`.

Every step is priced by the roofline cost model (`serving/costmodel.py`):
the step's shape (decode lengths from the host's `_host_len`, the chunk,
the verify rows, draft forwards, a dense admission's prompt) becomes
modeled bytes and FLOPs per phase, always accumulated (host arithmetic),
and `stats()["roofline"]` sets them against the phase times and the
hardware's ridge (`EngineConfig.hardware`, else the engine's device).
`telemetry=Telemetry(enabled=True)` (serving/telemetry.py) records, at
step boundaries and from host state only, per-step phase records with
their modeled costs, pool and queue gauges, request lifecycles, and the
allocator's, scheduler's and drafter's counters; with `annotate=True`
each step and each model call runs in a `torch.profiler.record_function`
scope. The default records nothing, and the kernels launched and the
outputs are the same with telemetry on or off.

`mesh=` (a `DeviceMesh`; paged only) serves tensor-parallel, the
reference's mesh-sharded pools with one process a rank: every rank builds
the same engine on the same requests, on its own device (`cuda:{rank %
device_count}`, or the CPU when asked). Parameters and sampling state are
replicated; the pools hold the rank's Hkv/tp KV heads, each attention
layer attends them and merges the ranks' heads by exact concatenation
(`models/attention.py`), so every rank's logits are one device's bits.
The scheduler, the allocator, prefix sharing, speculation, swapping and
telemetry run on every rank and stay in lockstep because their inputs
(tokens, logits, host counts) are the same bits everywhere; the engine
adds no cross-rank check of its own.

The decode step is shared by both modes. Construction:
`ServingEngine(params, cfg, engine, EngineConfig(slots=4, max_len=256),
device="cuda")`, with `paged=True` for the paged mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache as kv
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.costmodel import CostModel, StepShape
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import FifoScheduler, SwappedRequest
from repro_torch.serving.speculative import greedy_accept, make_drafter
from repro_torch.serving.telemetry import NULL_TELEMETRY, Telemetry

__all__ = ["EngineConfig", "GenConfig", "Request", "ServingEngine", "generate"]


ENCDEC_REFUSAL = ("ServingEngine does not serve the encoder-decoder family (its prefill "
                  "needs the frames): use generate(params, prompts, cfg, engine, gen, "
                  "extra_inputs={\"frames\": frames})")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: dict, prompts: torch.Tensor, model_cfg: ModelConfig,
             engine: SalPimEngine, gen: GenConfig, *,
             extra_inputs: Optional[dict] = None,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> tuple[torch.Tensor, dict]:
    """prompts (B, S) -> (generated tokens (B, max_new_tokens) int32, stats).

    One prefill over the batch, then one decode step a token over the
    dense arena; a sequence that emitted EOS (with `stop_on_eos`) keeps
    emitting EOS. `extra_inputs` (the encoder-decoder's {"frames": (B,
    enc_seq, D)}, a tensor or an array) joins the prefill's batch.
    Sampling draws from `generator` (a seeded one when None),
    so only greedy decoding matches the JAX package token for token.
    stats: prefill_sec, decode_sec, sec_per_token (decode time a sequence
    per real token), tokens (up to and including each first EOS),
    tokens_budget."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    T = gen.max_new_tokens
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    _sync(dev)
    t0 = time.perf_counter()
    batch = {"tokens": prompts, **(extra_inputs or {})}
    logits, cache = model_api.prefill(params, batch, model_cfg, engine, max_len=S + T + 1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    toks = []
    for _ in range(T):
        tok = sample(logits, generator, temperature=gen.temperature, top_k=gen.top_k)
        tok = torch.where(done, gen.eos_id, tok)
        logits, cache = model_api.decode_step(params, tok, cache, model_cfg, engine)
        if gen.stop_on_eos:
            done = done | (tok == gen.eos_id)
        toks.append(tok)
    out = (torch.stack(toks, dim=1) if toks
           else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    host = out.cpu().numpy()
    t_decode = time.perf_counter() - t0

    # A sequence that hits EOS at step k emitted k + 1 real tokens; the
    # EOS padding after it is not generated work.
    if gen.stop_on_eos:
        is_eos = host == gen.eos_id
        n_per_seq = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 1, host.shape[1])
    else:
        n_per_seq = np.full((B,), T)
    n_tokens = int(n_per_seq.sum())
    stats = {
        "prefill_sec": t_prefill,
        "decode_sec": t_decode,
        "sec_per_token": t_decode * B / max(n_tokens, 1),
        "tokens": n_tokens,
        "tokens_budget": int(B * T),
    }
    return out, stats


class _Counters:
    """Lifetime counts of the scheduler's actions (preemptions, swap-outs,
    swap-ins), each incremented in one place together with its telemetry
    `sched.*` counter, so that stats() and the snapshot cannot drift."""

    def __init__(self, telemetry: Telemetry):
        self._tel = telemetry
        self.preemptions = 0
        self.swap_outs = 0
        self.swap_ins = 0

    def preempt(self) -> None:
        self.preemptions += 1
        self._tel.count("sched.preempt")

    def swap_out(self, pages: int) -> None:
        self.swap_outs += 1
        self._tel.count("sched.swap_out")
        self._tel.count("sched.swap_out_pages", pages)

    def swap_in(self, pages: int) -> None:
        self.swap_ins += 1
        self._tel.count("sched.swap_in")
        self._tel.count("sched.swap_in_pages", pages)

    def readmit(self) -> None:
        # An aborted mid-prefill entry is admitted again without a blob: no
        # pages move, so only the telemetry event fires.
        self._tel.count("sched.readmit")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Prompt tokens whose KV is already resident in the slot's pages.
    prefill_cursor: int = 0
    # Tokens covered by prefix-cache pages mapped at admission: pages this
    # request borrowed (COW-forked before any write), as opposed to the
    # fresh pages it registered itself.
    shared_prompt_tokens: int = 0
    # Drafts proposed for this request and accepted by the verify pass.
    proposed: int = 0
    accepted: int = 0
    # Scheduling class (lower = more urgent; FIFO ignores it) and the times
    # this request was preempted off its slot.
    priority: int = 0
    preemptions: int = 0

    @property
    def prefilling(self) -> bool:
        return self.prefill_cursor < len(self.prompt)


class ServingEngine:
    """Continuous batching over a dense arena or a paged pool."""

    def __init__(self, params: dict, model_cfg: ModelConfig,
                 engine: SalPimEngine, config: EngineConfig, *,
                 device="cuda"):
        if model_cfg.family == "encdec":
            raise ValueError(ENCDEC_REFUSAL)
        config.validate(model_cfg)
        self.mesh = config.mesh
        self.device = (dist_api.rank_device(device) if self.mesh is not None
                       else resolve_device(device))
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.config = config
        self.params = params
        self.cfg = model_cfg
        # The KV-split knob rides the SAL-PIM config, so it reaches
        # paged_decode_attention without changing any model signature.
        if config.kv_splits is not None and config.kv_splits > 1:
            engine = dataclasses.replace(engine, config=dataclasses.replace(
                engine.config, kv_splits=config.kv_splits))
        self.engine = engine
        self.slots = config.slots
        self.max_len = config.max_len
        self.gen = config.gen
        self.telemetry = (config.telemetry if config.telemetry is not None
                          else NULL_TELEMETRY)
        self.scheduler = (config.scheduler if config.scheduler is not None
                          else FifoScheduler())
        self.prefill_chunk_tokens = config.prefill_chunk_tokens
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * self.slots
        self.finished: list[Request] = []
        # Preempted requests parked off the device, and the host tier that
        # holds their KV.
        self.swapped: list[SwappedRequest] = []
        self.swap_tier = kv.HostSwapTier()
        self._counters = _Counters(self.telemetry)
        self.last_logits = torch.zeros((self.slots, model_cfg.vocab),
                                       dtype=torch.float32, device=self.device)
        self._uid = 0
        self._generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._host_len = np.zeros((self.slots,), np.int64)
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0
        self.peak_pages = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        # Speculative counters: drafts proposed and accepted; verify_passes
        # counts verify launches (one a round, shared by every slot),
        # spec_rounds slot-level rounds (one model stream each).
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.verify_passes = 0
        self.spec_rounds = 0
        self._step_sec = 0.0
        self._admit_sec = 0.0
        self._chunk_sec = 0.0
        self._draft_sec = 0.0
        self._verify_sec = 0.0
        self._decode_sec = 0.0
        self._step_idx = 0
        # The roofline: modeled bytes and FLOPs per phase, accumulated every
        # step from what ran (host arithmetic, telemetry on or off);
        # stats()["roofline"] sets them against the phase times, and
        # telemetry also gets each step's.
        self.cost_model = CostModel.from_configs(model_cfg, config,
                                                 device=self.device)
        self._phase_bytes = {p: 0.0 for p in ("admit", "chunk_prefill", "draft",
                                              "verify", "decode")}
        self._phase_flops = dict(self._phase_bytes)
        self._shape: Optional[StepShape] = None
        if self.telemetry.enabled:
            self.telemetry.attach_roofline(self.cost_model.describe())
        self.spec = config.speculative
        self.drafter = (make_drafter(config.speculative, self.engine,
                                     self.max_len, telemetry=self.telemetry)
                        if config.speculative is not None else None)

        self.paged = config.paged
        if self.paged:
            self._init_pool(model_cfg, config)
        else:
            self.allocator = None
            self.page_bytes = None
            self.cache = model_api.init_cache(model_cfg, self.slots, self.max_len,
                                              device=self.device)

    def _init_pool(self, model_cfg: ModelConfig, config: EngineConfig):
        """The page pool, its allocator and block tables (paged mode)."""
        page_size, num_pages = config.page_size, config.num_pages
        self.max_pages = -(-self.max_len // page_size)
        kv_dtype = config.resolved_kv_dtype(model_cfg)
        self.page_bytes = kv.page_kv_bytes(model_cfg, page_size, kv_dtype,
                                           config.kv_scale_dtype)
        if num_pages is None:
            # The fp dense cache's byte budget, plus the trash page: int8
            # and int4 pages cost fewer bytes, so the budget holds more.
            budget = self.slots * self.max_pages * kv.page_kv_bytes(
                model_cfg, page_size, "model")
            num_pages = budget // self.page_bytes + 1
        self.allocator = kv.BlockAllocator(
            num_pages, page_size, prefix_sharing=config.prefix_sharing,
            telemetry=self.telemetry,
            pin_budget_pages=self.scheduler.pin_budget_pages)
        self.cache = model_api.init_paged_cache(
            model_cfg, self.slots, num_pages, page_size, self.max_pages,
            kv_dtype=kv_dtype, kv_scale_dtype=config.kv_scale_dtype,
            device=self.device, mesh=self.mesh)
        # A verify pass pads every row to k+1 positions, up to max_len + k
        # - 1: trash columns past the table take the writes that fall off
        # it (the JAX engine drops them).
        self._verify_pad = (-(-(self.max_len + self.spec.k) // page_size)
                            - self.max_pages if self.spec is not None else 0)

    @property
    def preemptions(self) -> int:
        return self._counters.preemptions

    @property
    def swap_outs(self) -> int:
        return self._counters.swap_outs

    @property
    def swap_ins(self) -> int:
        return self._counters.swap_ins

    def submit(self, prompt, max_new_tokens: int = 32, priority: int = 0) -> int:
        prompt = np.asarray(prompt)
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        worst = kv.BlockAllocator.worst_case_tokens(len(prompt), max_new_tokens)
        if worst > self.max_len:
            self.telemetry.count("admission.rejected.over_max_len")
            raise ValueError(
                f"request can occupy {worst} cache positions "
                f"(prompt {len(prompt)}, max_new {max_new_tokens}) "
                f"but max_len is {self.max_len}")
        if self.paged:
            need = self.allocator.pages_for(worst)
            usable = self.allocator.num_pages - 1
            if need > usable:
                self.telemetry.count("admission.rejected.over_pool_capacity")
                raise ValueError(
                    f"request needs {need} pages worst case but the pool "
                    f"has {usable}; no reservation was made")
        self._uid += 1
        self.queue.append(Request(self._uid, prompt, max_new_tokens,
                                  priority=priority))
        self.telemetry.request_submitted(self._uid, len(prompt), max_new_tokens,
                                         priority=priority)
        return self._uid

    def _place_paged(self, slot: int, req: Request, shared_tokens: int):
        """Install an admitted request; its prompt KV is produced chunk by
        chunk by _prefill_tick. A shared prefix advances the cursor (a
        fully covered prompt recomputes its last token for its logits; that
        chunk COW-forks the shared page it writes into)."""
        req.shared_prompt_tokens = shared_tokens
        req.prefill_cursor = min(shared_tokens, len(req.prompt) - 1)
        self.prefill_tokens_saved += req.prefill_cursor
        self._host_len[slot] = 0
        self.telemetry.request_admitted(req.uid, slot, shared_tokens)
        self.active[slot] = req

    def _place_dense(self, slot: int, req: Request):
        """Install a request into a dense slot: a batch-of-1 prefill of the
        whole prompt, written in place into the slot's rows of the cache
        (every position up to max_len) and of last_logits."""
        tel = self.telemetry
        tel.request_admitted(req.uid, slot, 0)
        t0c = tel.now() if tel.enabled else 0.0
        toks = torch.as_tensor(req.prompt[None], dtype=torch.int64, device=self.device)
        with tel.annotation("dense_admit_prefill"):
            logits1, cache1 = model_api.prefill(self.params, {"tokens": toks}, self.cfg,
                                                self.engine, max_len=self.max_len)
        if tel.enabled:
            # The whole prompt in one prefill: one chunk span.
            tel.chunk(req.uid, t0c, tel.now(), len(req.prompt))
        c = self.cache
        # Every tensor of the slot (KV, scales, SSM state, conv window, the
        # shared block's KV), so that a reused slot keeps nothing of its
        # last request.
        for f in dataclasses.fields(c):
            dst = getattr(c, f.name)
            if f.name != "lengths" and dst is not None:
                dst[:, slot] = getattr(cache1, f.name)[:, 0]
        c.lengths[slot] = len(req.prompt)
        self.last_logits[slot] = logits1[0].float()
        self.prefill_tokens += len(req.prompt)
        req.prefill_cursor = len(req.prompt)
        self._host_len[slot] = len(req.prompt)
        self.active[slot] = req
        if self._shape is not None:
            self._shape.admit_prompt_tokens += len(req.prompt)

    # -- preemption mechanisms (the policy is in scheduler.py) --------------
    def _admit_queued(self, req: Request, slot: int, reserve: bool = True) -> bool:
        """Admit a queued request (not necessarily the head) into `slot`;
        False when the pool refuses."""
        res = self.allocator.admit_tokens(req.uid, req.prompt, req.max_new_tokens,
                                          reserve=reserve)
        if res is None:
            return False
        self.queue.remove(req)
        self._place_paged(slot, req, res[1])
        return True

    def _preemptable(self, slot: int) -> bool:
        """A decoding slot can always be preempted: its pages are written
        through its length, so its blob is exact. A mid-prefill slot can
        only be aborted, and only while no sharer holds a page it
        registered (refcount > 1 past its borrowed prefix: content another
        request mapped and waits for this donor to write)."""
        req = self.active[slot]
        if req is None:
            return False
        if not req.prefilling:
            return True
        a = self.allocator
        borrowed = req.shared_prompt_tokens // a.page_size
        return all(a.refcount(p) <= 1 for p in a.pages_of(req.uid)[borrowed:])

    def _prefix_ready(self, slot: int) -> bool:
        """True when every prefix page this slot borrowed has been written
        by its registrant: no other mid-prefill request still owes content
        to a page this slot mapped. A scheduler that reorders prefill (SLO)
        must not run a sharer's chunk before; FIFO's uid order implies it."""
        req = self.active[slot]
        if req is None or req.shared_prompt_tokens == 0:
            return True
        a = self.allocator
        ps = a.page_size
        borrowed = set(a.pages_of(req.uid)[:req.shared_prompt_tokens // ps])
        for r in self.active:
            if r is None or r is req or not r.prefilling:
                continue
            pages = a.pages_of(r.uid)
            for j in range(r.shared_prompt_tokens // ps, len(pages)):
                if pages[j] in borrowed and r.prefill_cursor < (j + 1) * ps:
                    return False
        return True

    def _preempt(self, slot: int):
        """Take a slot's request off the device into `swapped`. A decoding
        victim's pages (payload and scale rows) go to the host tier and its
        `last_logits` row is saved; a mid-prefill victim is aborted (its
        pages are not all written): the pages it registered are
        unregistered, its saved-prefill credit taken back, its cursor
        reset. Either way its pages are released, the slot is cleared to
        the trash page, and the drafter drops the slot."""
        req = self.active[slot]
        a = self.allocator
        if req.prefilling:
            a.unregister(req.uid, from_logical=req.shared_prompt_tokens // a.page_size)
            self.prefill_tokens_saved -= min(req.shared_prompt_tokens,
                                             len(req.prompt) - 1)
            req.prefill_cursor = 0
            req.shared_prompt_tokens = 0
            entry = SwappedRequest(req, 0)
            kv.clear_slot(self.cache, slot)
        else:
            n_kv = int(self._host_len[slot])
            ids = a.pages_of(req.uid)
            _, blob = kv.swap_out_slot(self.cache, slot, ids, n_kv)
            self.swap_tier.put(req.uid, blob)
            entry = SwappedRequest(req, n_kv, has_blob=True,
                                   logits=self.last_logits[slot].to("cpu", copy=True))
            req.shared_prompt_tokens = 0
            self._counters.swap_out(pages=len(ids))
        a.release(req.uid)
        self.active[slot] = None
        self._host_len[slot] = 0
        if self.drafter is not None:
            # The slot id is about to be reused; a draft model prefills its
            # cache again from the request's context on re-contact.
            self.drafter.release(slot)
        req.preemptions += 1
        self._counters.preempt()
        self.swapped.append(entry)

    def _swap_in(self, entry: SwappedRequest, slot: int, reserve: bool = True) -> bool:
        """Re-admit a preempted request into `slot`; False when the pool
        refuses. An aborted entry is admitted afresh (prefill runs again
        and may re-hit the prefix cache); a swapped one gets fresh private
        pages, its blob and its logits row back, and resumes bit for bit."""
        req = entry.req
        a = self.allocator
        if not entry.has_blob:
            res = a.admit_tokens(req.uid, req.prompt, req.max_new_tokens,
                                 reserve=reserve)
            if res is None:
                return False
            self.swapped.remove(entry)
            self._place_paged(slot, req, res[1])
            self._counters.readmit()
            return True
        n_map = a.pages_for(entry.n_kv)
        worst = a.pages_for(a.worst_case_tokens(len(req.prompt), req.max_new_tokens))
        pages = a.admit_restored(req.uid, n_map, worst, reserve=reserve)
        if pages is None:
            return False
        kv.swap_in_slot(self.cache, slot, pages, self.swap_tier.pop(req.uid))
        self.last_logits[slot] = entry.logits.to(self.device)
        self._host_len[slot] = entry.n_kv
        self.active[slot] = req
        self.swapped.remove(entry)
        self._counters.swap_in(pages=n_map)
        return True

    def _ensure_decode_capacity(self):
        """Optimistic admission reserves nothing, so before sampling the
        free list must cover every page the coming decode (or verify)
        round may map: one extend a slot that crosses a page boundary
        (over k+1 positions with speculation) and one fork where the write
        lands in a still-shared page. Pins are reclaimed first, then
        victims preempted; before sampling, so a victim's state is a clean
        point to resume from."""
        a = self.allocator
        ps = a.page_size
        span = 1 + (self.spec.k if self.spec is not None else 0)
        while True:
            need = 0
            for i, r in enumerate(self.active):
                if r is None or r.prefilling:
                    continue
                L = int(self._host_len[i])
                pages = a.pages_of(r.uid)
                need += max(a.pages_for(L + span) - len(pages), 0)
                logical = L // ps
                if logical < len(pages) and a.refcount(pages[logical]) > 1:
                    need += 1
            if a.free_pages >= need:
                return
            a.reclaim_pinned(need - a.free_pages)
            if a.free_pages >= need:
                return
            victim = self.scheduler.pick_victim(self, None)
            if victim is None:
                return
            self._preempt(victim)

    def _prefill_tick(self):
        """Run at most one prompt chunk for one mid-prefill slot, the one
        the scheduler selects (FIFO: the oldest uid). The slot joins the
        decode batch only when the cursor reaches the end of the prompt.

        Under FIFO slots prefill in admission (uid) order, so a request
        that maps a donor's registered pages runs no chunk before the donor
        has written them all; a reordering scheduler keeps the same rule
        through `_prefix_ready`."""
        cand = [(r.uid, i) for i, r in enumerate(self.active)
                if r is not None and r.prefilling]
        if not cand:
            return
        slot = self.scheduler.select_prefill_slot(self, cand)
        req = self.active[slot]
        start = req.prefill_cursor
        budget = self.prefill_chunk_tokens or len(req.prompt)
        end = min(len(req.prompt), start + budget)
        # COW: fork any still-shared *borrowed* page this chunk writes into
        # (only the recomputed last token of a fully covered prompt can).
        # Pages past the borrowed prefix are this request's own: writing
        # them is the registered content later sharers mapped.
        a = self.allocator
        ps = a.page_size
        borrowed = req.shared_prompt_tokens // ps
        fork_range = range(start // ps, min((end - 1) // ps + 1, borrowed))
        if self.scheduler.preemptive:
            # Optimistic admission reserved nothing: the free list must
            # cover this chunk's forks, preempting victims (never this
            # slot) when it is dry.
            forks = sum(1 for logical in fork_range
                        if a.refcount(a.pages_of(req.uid)[logical]) > 1)
            if forks > a.free_pages:
                a.reclaim_pinned(forks - a.free_pages)
            while forks > a.free_pages:
                victim = self.scheduler.pick_victim(self, None,
                                                    protect=frozenset((slot,)))
                if victim is None:
                    return   # retry next step
                self._preempt(victim)
        for logical in fork_range:
            if a.refcount(a.pages_of(req.uid)[logical]) > 1:
                old, new = a.fork_page(req.uid, logical)
                kv.copy_page(self.cache, old, new)
        pages = a.pages_of(req.uid)
        row = torch.full((1, self.max_pages), kv.TRASH_PAGE, dtype=torch.int32)
        row[0, :len(pages)] = torch.as_tensor(pages, dtype=torch.int32)
        row = row.to(self.device)
        toks = torch.as_tensor(req.prompt[start:end], dtype=torch.int64,
                               device=self.device)[None]
        start_t = torch.tensor([start], dtype=torch.int32, device=self.device)
        tel = self.telemetry
        t0c = tel.now() if tel.enabled else 0.0
        with tel.annotation("prefill_chunk"):
            res = model_api.prefill_chunk(
                self.params, toks, row, start_t, self.cache.k_pages,
                self.cache.v_pages, self.cfg, self.engine, self.cache.k_scale,
                self.cache.v_scale, mesh=self.mesh)
        if self.cache.quantized:
            logits1, _, _, _, _ = res
        else:
            logits1, _, _ = res
        req.prefill_cursor = end
        self.prefill_tokens += end - start
        self.prefill_chunks += 1
        if not req.prefilling:
            # Activate: only now does the slot become visible to the shared
            # decode program (row + device length + first logits).
            self.cache.lengths[slot] = end
            self.cache.block_tables[slot] = row[0]
            self.last_logits[slot] = logits1[0].float()
            self._host_len[slot] = end
        self.peak_pages = max(self.peak_pages, self.allocator.used_pages)
        if self._shape is not None:
            self._shape.chunk = (start, end - start)
        if tel.enabled:
            tel.chunk(req.uid, t0c, tel.now(), end - start)

    def _release(self, slot: int, req: Request):
        req.done = True
        self.finished.append(req)
        self.active[slot] = None
        if self.paged:
            self.allocator.release(req.uid)
            self.cache = kv.clear_slot(self.cache, slot)
        else:
            # Park the slot at length 0: decode_step does not advance it.
            self.cache.lengths[slot] = 0
        if self.drafter is not None:
            self.drafter.release(slot)
        self._host_len[slot] = 0
        self.telemetry.request_finished(req.uid)

    def _map_write_range(self, slot: int, req: Request, first: int,
                         n_writes: int):
        """Map/fork pages so KV writes at positions first..first+n-1 land
        in private pages: extend where a position falls off the mapped
        pages (reservations make this infallible), COW-fork a still-shared
        page a write would touch."""
        ps = self.allocator.page_size
        for pos in range(first, first + n_writes):
            if self.allocator.needs_extend(req.uid, pos):
                page = self.allocator.extend(req.uid)
                self._repoint(slot, len(self.allocator.pages_of(req.uid)) - 1, page)
            else:
                logical = pos // ps
                page = self.allocator.pages_of(req.uid)[logical]
                if self.allocator.refcount(page) > 1:
                    old, new = self.allocator.fork_page(req.uid, logical)
                    kv.copy_page(self.cache, old, new)
                    self._repoint(slot, logical, new)

    def _repoint(self, slot: int, logical: int, page: int):
        self.cache.block_tables[slot, logical] = page

    def step(self) -> int:
        """One engine step: admit, run at most one prompt chunk, then one
        decode step (with `speculative`, one draft-verify round) across all
        fully prefilled slots. Returns the amount of outstanding work (live
        decodes + mid-prefill slots + queued and swapped requests).

        Phase times (admit / chunk prefill / draft / verify / decode) and
        the step's modeled costs accumulate into stats(); with telemetry
        enabled the step also records its phase split, modeled costs and
        the pool and queue gauges at the step boundary."""
        tel = self.telemetry
        t_start = time.perf_counter()
        self._step_idx += 1
        before = ((self._admit_sec, self._chunk_sec, self._draft_sec,
                   self._verify_sec, self._decode_sec) if tel.enabled else None)
        self._shape = StepShape()
        try:
            with tel.step_annotation(self._step_idx):
                return self._step_inner()
        finally:
            dur = time.perf_counter() - t_start
            self._step_sec += dur
            costs = self.cost_model.step_costs(self._shape)
            self._shape = None
            for phase, c in costs.items():
                self._phase_bytes[phase] += c.bytes
                self._phase_flops[phase] += c.flops
            if tel.enabled:
                a = self.allocator
                tel.record_step(
                    t_start, dur,
                    self._admit_sec - before[0],
                    self._chunk_sec - before[1],
                    self._draft_sec - before[2],
                    self._verify_sec - before[3],
                    self._decode_sec - before[4],
                    a.used_pages if a is not None else 0,
                    a.free_pages if a is not None else 0,
                    a.available_pages if a is not None else 0,
                    len(self.queue),
                    sum(1 for r in self.active if r is not None and r.prefilling),
                    costs={p: (c.bytes, c.flops) for p, c in costs.items()})

    def _step_inner(self) -> int:
        tel = self.telemetry
        t = time.perf_counter()
        self.scheduler.schedule_admissions(self)
        self._admit_sec += time.perf_counter() - t
        if self.paged:
            t = time.perf_counter()
            self._prefill_tick()
            self._chunk_sec += time.perf_counter() - t
            if self.scheduler.preemptive:
                # The pool must cover this round's extends and forks before
                # sampling (may preempt).
                self._ensure_decode_capacity()
        n_prefilling = sum(1 for r in self.active
                           if r is not None and r.prefilling)
        ready = [i for i, r in enumerate(self.active)
                 if r is not None and not r.prefilling]
        parked = len(self.queue) + len(self.swapped)
        if not ready:
            return n_prefilling + parked
        if self.spec is not None:
            return self._spec_round(ready) + n_prefilling + parked
        t_dec = time.perf_counter()
        toks = sample(self.last_logits, self._generator,
                      temperature=self.gen.temperature, top_k=self.gen.top_k)
        host_toks = toks.cpu().numpy()
        mask = np.zeros((self.slots,), bool)
        t_emit = tel.now() if tel.enabled else 0.0
        for i in ready:
            req = self.active[i]
            req.generated.append(int(host_toks[i]))
            tel.tokens(req.uid, t_emit)
            if (len(req.generated) >= req.max_new_tokens
                    or (self.gen.stop_on_eos
                        and host_toks[i] == self.gen.eos_id)):
                self._release(i, req)
            else:
                mask[i] = True
        if self.paged:
            # Decode-step boundary: map a fresh page wherever the next write
            # position falls off a slot's mapped pages. Mid-prefill slots are
            # skipped: their device length is 0, so their append lands in the
            # trash page.
            for i in range(self.slots):
                req = self.active[i]
                if req is None or req.prefilling:
                    continue
                self._map_write_range(i, req, int(self._host_len[i]), 1)
            self.peak_pages = max(self.peak_pages, self.allocator.used_pages)
        with tel.annotation("decode_step"):
            logits, self.cache = model_api.decode_step(
                self.params, toks, self.cache, self.cfg, self.engine, mesh=self.mesh)
        self.last_logits = logits.float()
        self._host_len += mask
        self.decode_steps += 1
        if self._shape is not None:
            # Post-append resident lengths of the live slots: what the
            # decode attention just read through the block table.
            self._shape.decode_ran = True
            self._shape.decode_lens = [int(x) for x, m in zip(self._host_len, mask) if m]
        self._decode_sec += time.perf_counter() - t_dec
        return int(mask.sum()) + n_prefilling + parked

    def _spec_round(self, ready: list[int]) -> int:
        """One draft-verify round over the fully prefilled slots; returns
        the slots still live after it.

        t0 is the argmax of last_logits (no model call). Each continuing
        slot gets up to spec.k drafts (no more than its reservation has
        room for), one verify pass writes every candidate's K/V and scores
        all k+1 positions, and greedy acceptance commits the longest
        matching prefix. The rejected tail rolls back in the pool: lengths
        rewind and now-empty tail pages return to the free list and the
        slot's reservation. Slots outside the round keep all-trash rows,
        so their padded rows write the trash page."""
        k = self.spec.k
        tel = self.telemetry
        t_draft0 = time.perf_counter()
        t_round0 = tel.now() if tel.enabled else 0.0
        host_logits = self.last_logits.cpu().numpy()
        survivors: list[tuple[int, Request, int, np.ndarray]] = []
        for i in ready:
            req = self.active[i]
            t0 = int(np.argmax(host_logits[i]))
            req.generated.append(t0)
            if (len(req.generated) >= req.max_new_tokens
                    or (self.gen.stop_on_eos and t0 == self.gen.eos_id)):
                tel.tokens(req.uid, t_round0)
                self._release(i, req)
                continue
            # With G tokens generated the reservation holds at most
            # max_new - G - 1 draft writes after t0's; a slot out of room
            # verifies t0 alone (a decode step through the verify pass).
            k_i = min(k, req.max_new_tokens - len(req.generated) - 1)
            context = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int64)])
            drafts = (np.asarray(self.drafter.propose(i, context, k_i))[:k_i]
                      if k_i > 0 else np.zeros((0,), np.int64))
            req.proposed += len(drafts)
            self.spec_proposed += len(drafts)
            survivors.append((i, req, t0, drafts))
        self._draft_sec += time.perf_counter() - t_draft0
        if not survivors:
            return 0
        t_ver0 = time.perf_counter()
        tokens = np.zeros((self.slots, k + 1), np.int64)
        starts = np.zeros((self.slots,), np.int32)
        for i, req, t0, drafts in survivors:
            L = int(self._host_len[i])
            tokens[i, 0] = t0
            tokens[i, 1:1 + len(drafts)] = drafts
            starts[i] = L
            if self._shape is not None:
                self._shape.verify.append((L, 1 + len(drafts)))
                if self.spec.mode == "draft-model":
                    # One draft forward a proposed token (as the reference
                    # prices it: the weight stream dominates).
                    self._shape.draft_forwards += len(drafts)
            # Pages for t0 and the drafts; padded positions past them land
            # in the tail of a mapped page (dead data past the rewind
            # length) or in the trash page, through the trash columns
            # past max_len.
            self._map_write_range(i, req, L, 1 + len(drafts))
        self.peak_pages = max(self.peak_pages, self.allocator.used_pages)
        c = self.cache
        tables = (torch.nn.functional.pad(c.block_tables, (0, self._verify_pad),
                                          value=kv.TRASH_PAGE)
                  if self._verify_pad else c.block_tables)
        with tel.annotation("verify_tokens"):
            vlogits = model_api.verify_tokens(
                self.params, torch.as_tensor(tokens, device=self.device),
                tables, torch.as_tensor(starts, device=self.device),
                c.k_pages, c.v_pages, self.cfg, self.engine, c.k_scale,
                c.v_scale, mesh=self.mesh)[0]
        self.verify_passes += 1
        self.spec_rounds += len(survivors)
        # Acceptance needs only the argmaxes.
        greedy = torch.argmax(vlogits, dim=-1).cpu().numpy()
        t_acc = tel.now() if tel.enabled else 0.0
        rows, cols = [], []
        for i, req, t0, drafts in survivors:
            a, hit_eos = greedy_accept(drafts, greedy[i], eos_id=self.gen.eos_id,
                                       stop_on_eos=self.gen.stop_on_eos)
            req.generated.extend(int(t) for t in drafts[:a])
            req.accepted += a
            self.spec_accepted += a
            if tel.enabled:
                # 1 + a tokens commit together: a burst, so the deltas inside
                # the round are recorded as zeros.
                tel.tokens(req.uid, t_acc, 1 + a)
                tel.spec_round(req.uid, t_round0, t_acc, len(drafts), a)
            if hit_eos:
                self._release(i, req)
                continue
            new_len = int(starts[i]) + 1 + a
            self.allocator.rewind(req.uid, new_len)
            kv.rewind_slot(self.cache, i, new_len,
                           len(self.allocator.pages_of(req.uid)))
            self._host_len[i] = new_len
            rows.append(i)
            cols.append(a)
        if rows:
            # One scatter: each live slot's next-round logits are the verify
            # logits after its last accepted token.
            r = torch.as_tensor(rows, device=self.device)
            self.last_logits[r] = vlogits[
                r, torch.as_tensor(cols, device=self.device)].float()
        self._verify_sec += time.perf_counter() - t_ver0
        return len(rows)

    def run(self, max_steps: int = 10000) -> list[Request]:
        """Drive steps until drained; returns requests finished during this
        call."""
        start = len(self.finished)
        for _ in range(max_steps):
            n = self.step()
            if (n == 0 and not self.queue and not self.swapped
                    and all(a is None for a in self.active)):
                break
        return self.finished[start:]

    def stats(self) -> dict:
        """Token counts, page high-water mark and host-clock phase times
        (the device runs asynchronously; the decode and verify phases wait
        for it when they read tokens). Speculative fields: proposed /
        accepted drafts, acceptance_rate, verify_passes (launches),
        spec_rounds (slot-level rounds), verify_per_token (rounds per
        emitted token) and tokens_per_pass (its inverse); all 0 with
        speculation off. model_sec_per_token charges only the decode and
        verify phases. Scheduler fields: the policy's name, lifetime
        preemptions / swap_outs / swap_ins, requests swapped out now, the
        host tier's byte high-water mark and the pinned prefix pages now.
        Tokens count finished, active and swapped requests. A ratio with a
        zero denominator reads 0.0. `roofline`: `_roofline_stats`."""
        def ratio(num, den):
            return num / den if den else 0.0

        reqs = (self.finished + [r for r in self.active if r is not None]
                + [e.req for e in self.swapped])
        tokens = sum(len(r.generated) for r in reqs)
        spec_tokens = tokens if self.spec is not None else 0
        return {
            "tokens": tokens,
            "tokens_budget": sum(r.max_new_tokens for r in reqs),
            "sec_per_token": ratio(self._step_sec, tokens),
            "step_sec": self._step_sec,
            "admit_sec": self._admit_sec,
            "chunk_prefill_sec": self._chunk_sec,
            "draft_sec": self._draft_sec,
            "verify_sec": self._verify_sec,
            "decode_sec": self._decode_sec,
            "model_sec_per_token": ratio(self._decode_sec + self._verify_sec, tokens),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "peak_pages": self.peak_pages,
            "used_pages": self.allocator.used_pages if self.paged else 0,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": ratio(self.spec_accepted, self.spec_proposed),
            "verify_passes": self.verify_passes,
            "spec_rounds": self.spec_rounds,
            "verify_per_token": ratio(self.spec_rounds, spec_tokens),
            "tokens_per_pass": ratio(spec_tokens, self.spec_rounds),
            "scheduler": self.scheduler.name,
            "preemptions": self.preemptions,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swapped": len(self.swapped),
            "swap_bytes_peak": self.swap_tier.bytes_peak,
            "pinned_pages": self.allocator.pinned_pages if self.paged else 0,
            "roofline": self._roofline_stats(),
        }

    def _roofline_stats(self) -> dict:
        """Per-phase roofline over everything this engine has run, from the
        modeled-cost accumulators and the phase times (host clock): modeled
        bytes and FLOPs, achieved GB/s, arithmetic intensity, and the
        memory/compute-bound class against the cost model's hardware.
        Phases that never ran are left out. The telemetry snapshot carries
        the windowed, per-step version of the same numbers."""
        sec = {"admit": self._admit_sec,
               "chunk_prefill": self._chunk_sec,
               "draft": self._draft_sec,
               "verify": self._verify_sec,
               "decode": self._decode_sec}
        hw = self.cost_model.hardware
        out = {}
        for phase, nbytes in self._phase_bytes.items():
            if nbytes <= 0.0:
                continue
            nflops = self._phase_flops[phase]
            s = sec[phase]
            intensity = nflops / nbytes
            out[phase] = {
                "modeled_bytes": nbytes,
                "modeled_flops": nflops,
                "sec": s,
                "achieved_gbps": nbytes / s / 1e9 if s else 0.0,
                "arithmetic_intensity": intensity,
                "bound": hw.classify(intensity),
            }
        return out
