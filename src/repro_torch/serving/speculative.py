"""Speculative decoding: draft-verify serving over the paged KV cache (the
port of `repro.serving.speculative`).

A drafter proposes k continuations; the target model scores [t0, d1..dk]
in one paged-prefill-shaped forward (`models/api.verify_tokens`) with the
LM head at every position, and greedy acceptance commits the longest
prefix of drafts equal to the target's argmax; the rejected tail is
rolled back in the pool (`BlockAllocator.rewind` + `kvcache.rewind_slot`).
On the CPU, where every kernel is its plain version, the outputs are those
of non-speculative greedy decoding. On the card they are not guaranteed
to be: the verify pass's prefill attention and the decode step's
attention are different kernels, and where two bf16 logits (nearly) tie
they can pick different argmaxes (GPT-2 medium on an H100: 195 of 256
greedy tokens equal to spec off on fp pools, 227 of 256 on int8 pools,
self-draft acceptance 0.839; ROADMAP.md, queue 3's watch).

Per engine round (`ServingEngine` with `EngineConfig(speculative=...)`):

  1. t0 = argmax(last_logits), no model call (greedy only);
  2. the drafter proposes d1..dk continuing after t0;
  3. one verify pass over (slots, k+1) writes every candidate's K/V into
     the slot's pages and returns logits at all k+1 positions;
  4. `greedy_accept` commits t0 plus the longest matching draft prefix;
     lengths rewind and now-empty tail pages return to the free list and
     the slot's reservation;
  5. last_logits := the verify logits after the last accepted token.

Two drafters behind the `Drafter` protocol:

  * `NgramDrafter` — model-free prompt lookup: the continuation of the
    latest earlier occurrence of the history's longest suffix n-gram;
  * `DraftModelDrafter` — a second model (its own ModelConfig + params) on
    its own dense KV `Cache` per slot, greedy-decoding k tokens ahead
    through `api.prefill` and `api.decode_step`, eagerly. Its rollback is a
    length rewind. The target's own cfg and params ("self-draft") give a
    drafter whose every proposal is accepted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol

import numpy as np
import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models import api as model_api
from repro_torch.serving.telemetry import NULL_TELEMETRY


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative serving knobs.

    mode:       "ngram" (prompt lookup, model-free) | "draft-model"
    k:          drafted tokens per verify pass (the pass scores k+1)
    ngram_max:  longest history suffix the ngram drafter tries to match
    ngram_min:  shortest match it will draft from
    draft_cfg / draft_params: the small model for "draft-model" mode
                (the target's own cfg/params for self-draft)
    """

    mode: str = "ngram"
    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1
    draft_cfg: Optional[Any] = None
    draft_params: Optional[dict] = None

    def validate(self) -> None:
        if self.mode not in ("ngram", "draft-model"):
            raise ValueError(f"unknown speculative mode {self.mode!r}")
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"{self.ngram_min}..{self.ngram_max}")
        if self.mode == "draft-model" and (
                self.draft_cfg is None or self.draft_params is None):
            raise ValueError("draft-model mode needs draft_cfg and "
                             "draft_params")


class Drafter(Protocol):
    """One drafter instance serves every slot of one ServingEngine."""

    def propose(self, slot: int, context: np.ndarray, k: int) -> np.ndarray:
        """Up to k draft tokens continuing `context` (the request's whole
        committed history: prompt + generated, t0 included)."""
        ...

    def release(self, slot: int) -> None:
        """The request in `slot` finished; drop any per-slot state."""
        ...


class NgramDrafter:
    """Prompt-lookup drafting: for n from ngram_max down to ngram_min, the
    (up to k) tokens that followed the latest earlier occurrence of the
    context's last n tokens."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"{ngram_min}..{ngram_max}")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, slot: int, context: np.ndarray, k: int) -> np.ndarray:
        del slot
        ctx = np.asarray(context)
        n_ctx = len(ctx)
        for n in range(min(self.ngram_max, n_ctx - 1), self.ngram_min - 1, -1):
            pattern = ctx[n_ctx - n:]
            # Latest i with ctx[i:i+n] == pattern and a continuation
            # strictly before the suffix itself (i + n < n_ctx).
            for i in range(n_ctx - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], pattern):
                    return ctx[i + n:i + n + k].copy()
        return np.zeros((0,), ctx.dtype)

    def release(self, slot: int) -> None:
        del slot


class DraftModelDrafter:
    """Draft-model drafting on a dense KV `Cache` per slot.

    Each slot keeps (fed tokens, Cache, logits after them). `propose`
    first catches the cache up to the committed history (a prefill on
    first contact or when the context is not an extension of what was fed,
    else one decode step per new token), then greedy-decodes k tokens
    ahead. Rollback rewinds the cache's length to the committed context:
    the drafted tokens' K/V stays past it as dead data until the next
    catch-up overwrites it.
    """

    def __init__(self, params: dict, cfg, engine: SalPimEngine,
                 max_len: int, headroom: int, telemetry=None):
        if cfg.family == "encdec":
            raise ValueError("draft-model drafting unsupported for encdec")
        self.params = params
        # Draft-model forwards are work the target's verify pass amortizes:
        # counted, so that telemetry can price a round.
        self._tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.cfg = cfg
        self.engine = engine
        self.device = params["embed"].device
        # Drafting runs k tokens past the longest committed context.
        self.max_len = max_len + headroom
        self._state: dict[int, list] = {}   # slot -> [fed, Cache, logits]

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks), dtype=torch.int32,
                               device=self.device)

    def _catch_up(self, slot: int, context: np.ndarray) -> list:
        st = self._state.get(slot)
        fed = None if st is None else st[0]
        if (fed is None or len(fed) > len(context)
                or not np.array_equal(fed, context[:len(fed)])):
            logits, cache = model_api.prefill(
                self.params, {"tokens": self._tokens(context[None])},
                self.cfg, self.engine, max_len=self.max_len)
            self._tel.count("spec.draft_prefills")
        else:
            _, cache, logits = st
            for t in context[len(fed):]:
                logits, cache = model_api.decode_step(
                    self.params, self._tokens([t]), cache, self.cfg,
                    self.engine)
            self._tel.count("spec.draft_decode_steps", len(context) - len(fed))
        st = [context.copy(), cache, logits]
        self._state[slot] = st
        return st

    def propose(self, slot: int, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context)
        st = self._catch_up(slot, context)
        fed, cache, logits = st
        drafts = np.zeros((k,), np.int64)
        for j in range(k):
            drafts[j] = int(torch.argmax(logits[0]))
            if j == k - 1:
                break          # the k-th draft needs no follow-up forward
            logits, cache = model_api.decode_step(
                self.params, self._tokens([drafts[j]]), cache, self.cfg,
                self.engine)
        self._tel.count("spec.draft_decode_steps", max(k - 1, 0))
        # Draft-side rollback: rewind to the committed context; st[2]
        # keeps the logits after it.
        cache.lengths = torch.full_like(cache.lengths, len(fed))
        st[1] = cache
        return drafts

    def release(self, slot: int) -> None:
        self._state.pop(slot, None)


def make_drafter(spec: SpecConfig, engine: SalPimEngine,
                 max_len: int, telemetry=None) -> Drafter:
    """Build the drafter a ServingEngine's SpecConfig asks for."""
    spec.validate()
    if spec.mode == "ngram":
        return NgramDrafter(ngram_max=spec.ngram_max,
                            ngram_min=spec.ngram_min)
    return DraftModelDrafter(spec.draft_params, spec.draft_cfg, engine,
                             max_len=max_len, headroom=spec.k + 1,
                             telemetry=telemetry)


def greedy_accept(drafts: np.ndarray, greedy_tokens: np.ndarray,
                  *, eos_id: int, stop_on_eos: bool) -> tuple[int, bool]:
    """Greedy acceptance: (accepted count, hit_eos). Draft j+1 is accepted
    iff it equals greedy_tokens[j], the target's argmax after verify token
    j; acceptance stops after an accepted EOS when `stop_on_eos`."""
    a = 0
    hit_eos = False
    while a < len(drafts) and int(drafts[a]) == int(greedy_tokens[a]):
        a += 1
        if stop_on_eos and int(drafts[a - 1]) == eos_id:
            hit_eos = True
            break
    return a, hit_eos
