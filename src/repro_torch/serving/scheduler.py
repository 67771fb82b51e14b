"""Scheduler (the port of `repro.serving.scheduler`): admission, prefill
order and preemption policy.

The engine (`serving/engine.py`) owns the mechanisms: placing a request
into a slot, running chunks and decode steps, preempting a slot to the
host swap tier and restoring it. A `Scheduler` makes every decision:

  * which queued (or swapped-out) request enters which free slot, under
    which allocator admission mode (watermark or optimistic);
  * which mid-prefill slot runs the step's one prompt chunk;
  * which victim to preempt when the pool runs dry.

Two policies:

  * `FifoScheduler` (the default): strict FIFO admission (paged: under
    the page watermark net of shared prefix pages, no skip past a blocked
    head; dense: into any free slot), prompt chunks in admission (uid)
    order, never preempts. Its schedules are preemption-free by
    construction.

  * `SloScheduler`: priority classes (lower number = more urgent;
    `submit(priority=...)`), optimistic admission (only the pages written
    now must be free, nothing reserved ahead), no head-of-line blocking (a
    blocked candidate is skipped, not waited on), and preempt-and-swap when
    the pool runs dry: the lowest-priority, youngest victim's pages go to
    the host swap tier (`kvcache.swap_out_slot`) and the request is
    re-admitted later, resuming bit-identically. Admission preempts only
    victims of strictly lower priority, so a class never thrashes itself;
    capacity preemption (a decode needs a page and the free list is dry)
    may take anyone: the choice of victim cannot make pages, only choose
    who waits.

Safety rules the policies keep (the engine's helpers enforce them):

  * A mid-prefill victim is aborted (requeued, cursor reset, the
    registered pages it had not finished writing unregistered), never
    swapped: a partial prompt's pages are not all written, so a blob could
    hold garbage. Prefill runs again on re-admission (and may re-hit the
    prefix cache).
  * A mid-prefill slot whose registered pages have sharers (refcount > 1
    past its borrowed prefix) is not preempted at all: the sharers mapped
    those pages at admission and wait for this donor to write them
    (`ServingEngine._preemptable`).
  * Under prefix sharing a sharer's first chunk must not run before its
    donor has written the shared pages. `FifoScheduler` gets this from
    strict uid (= admission) order; `SloScheduler` admits out of uid
    order, so it checks who actually writes each page
    (`ServingEngine._prefix_ready`). The earliest-admitted prefilling slot
    is always ready, so prefill never livelocks.
  * A candidate that cannot fit even after every eligible victim is
    evicted evicts no one: futile evictions would preempt the same victims
    every step (livelock). `SloScheduler` guards every eviction with
    `BlockAllocator.admission_probe`.

Each step a candidate waits at the pool (FIFO: the head refused at the
watermark; SLO: a candidate that does not fit) counts one
`admission.blocked_steps` in the engine's telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import torch


@dataclasses.dataclass
class SwappedRequest:
    """A preempted request parked off the device until it is re-admitted.

    An aborted mid-prefill victim has no blob (`has_blob` False): it is
    admitted afresh and prefilled again. A decoding victim's exact KV waits
    in the engine's `HostSwapTier` under its uid, and `logits` holds the
    row sampling resumes from (a CPU float32 tensor)."""

    req: object                            # engine.Request
    n_kv: int                              # resident tokens at swap-out
    logits: Optional[torch.Tensor] = None  # (vocab,) or None
    has_blob: bool = False


@runtime_checkable
class Scheduler(Protocol):
    """The policy the engine calls at step boundaries.

    name              short policy id (stats)
    preemptive        True turns on the engine's capacity checks (and
                      needs paged mode)
    reserve           the allocator's admission mode for this policy's
                      admissions (True = watermark, False = optimistic)
    pin_budget_pages  prefix-cache pages allowed to outlive refcount 0
    """

    name: str
    preemptive: bool
    reserve: bool
    pin_budget_pages: int

    def schedule_admissions(self, eng) -> None:
        """Fill free slots from eng.queue and eng.swapped."""
        ...

    def select_prefill_slot(self, eng, cand: list[tuple[int, int]]) -> int:
        """The slot for this step's prompt chunk, of the non-empty `cand` =
        [(uid, slot), ...] of mid-prefill slots."""
        ...

    def pick_victim(self, eng, below_priority: Optional[int],
                    protect: frozenset = frozenset()) -> Optional[int]:
        """A slot to preempt, or None. With `below_priority` only slots of
        strictly lower priority (a larger number) qualify; capacity
        preemption passes None."""
        ...


class FifoScheduler:
    name = "fifo"
    preemptive = False
    reserve = True
    pin_budget_pages = 0

    def schedule_admissions(self, eng) -> None:
        for slot in range(eng.slots):
            if eng.active[slot] is None and eng.queue:
                req = eng.queue[0]
                if not eng.paged:
                    eng.queue.pop(0)
                    eng._place_dense(slot, req)
                    continue
                # admit_tokens changes no state on refusal, so a waiting
                # head reserves nothing.
                res = eng.allocator.admit_tokens(req.uid, req.prompt,
                                                 req.max_new_tokens)
                if res is None:
                    # One blocked step each engine step the head waits at
                    # the watermark (head-of-line blocking).
                    eng.telemetry.count("admission.blocked_steps")
                    if not any(r is not None for r in eng.active):
                        # Nothing holds pages, yet the head does not fit:
                        # it never will (submit() bounds the gross worst
                        # case, so this is a safety net).
                        worst = eng.allocator.pages_for(
                            eng.allocator.worst_case_tokens(
                                len(req.prompt), req.max_new_tokens))
                        raise ValueError(
                            f"request {req.uid} needs {worst} pages; "
                            f"pool has {eng.allocator.num_pages - 1}")
                    break
                eng.queue.pop(0)
                eng._place_paged(slot, req, res[1])
        if eng.paged:
            eng.peak_pages = max(eng.peak_pages, eng.allocator.used_pages)

    def select_prefill_slot(self, eng, cand: list[tuple[int, int]]) -> int:
        # Strict admission (uid) order: a sharer cannot run a chunk before
        # its donor has written every page the sharer mapped.
        return min(cand)[1]

    def pick_victim(self, eng, below_priority, protect=frozenset()):
        return None


class SloScheduler:
    """Priority classes, optimistic admission, preempt-and-swap.

    Candidates are admitted in (priority, uid) order: urgent classes
    first, FIFO within a class, swapped-out requests in the same order as
    queued ones (a preempted request is restored as soon as its class is
    up). A blocked candidate is skipped. When a candidate does not fit,
    the allocator first reclaims pinned prefix pages, then the policy
    preempts victims of strictly lower priority until it fits or no victim
    is left.

    `pin_budget_pages` > 0 keeps that many cached prefix pages alive at
    refcount 0, so a recurring system prompt outlives the gap between the
    requests that use it.
    """

    name = "slo"
    preemptive = True
    reserve = False

    def __init__(self, pin_budget_pages: int = 0):
        self.pin_budget_pages = pin_budget_pages

    # -- admission ----------------------------------------------------------
    def schedule_admissions(self, eng) -> None:
        if not eng.queue and not eng.swapped:
            return
        cands = sorted(
            [(e.req.priority, e.req.uid, e) for e in eng.swapped]
            + [(r.priority, r.uid, r) for r in eng.queue],
            key=lambda c: (c[0], c[1]))
        for prio, _uid, item in cands:
            slot = next((i for i, r in enumerate(eng.active) if r is None),
                        None)
            if slot is None:
                # Every slot is busy: a strictly lower-priority victim may
                # give up its slot (and pages), but only for a candidate
                # that fits afterwards.
                if not self._feasible(eng, item, prio):
                    eng.telemetry.count("admission.blocked_steps")
                    continue
                victim = self.pick_victim(eng, below_priority=prio)
                if victim is None:
                    break   # later candidates have priority >= this one
                eng._preempt(victim)
                slot = victim
            if not self._admit_with_evictions(eng, item, slot, prio):
                eng.telemetry.count("admission.blocked_steps")
                if not any(r is not None for r in eng.active):
                    # Nothing holds pages, yet the candidate does not fit:
                    # it never will (submit() bounds the gross worst case,
                    # so this is a safety net).
                    r = item.req if isinstance(item, SwappedRequest) else item
                    raise ValueError(
                        f"request {r.uid} cannot fit: pool has "
                        f"{eng.allocator.num_pages - 1} pages")
                continue
        eng.peak_pages = max(eng.peak_pages, eng.allocator.used_pages)

    def _admit_with_evictions(self, eng, item, slot, prio) -> bool:
        """Place `item` (a Request or a SwappedRequest) into `slot`,
        preempting strictly lower-priority victims while it does not fit.
        The allocator's admissions reclaim pins; eviction frees mapped
        pages only. The feasibility guard runs before every eviction."""
        protect = frozenset((slot,))
        while True:
            if isinstance(item, SwappedRequest):
                ok = eng._swap_in(item, slot, reserve=self.reserve)
            else:
                ok = eng._admit_queued(item, slot, reserve=self.reserve)
            if ok:
                return True
            if not self._feasible(eng, item, prio, protect=protect):
                return False
            victim = self.pick_victim(eng, below_priority=prio,
                                      protect=protect)
            if victim is None:
                return False
            eng._preempt(victim)

    def _feasible(self, eng, item, prio, protect=frozenset()) -> bool:
        """Can `item` be admitted at all, counting the free list, the pins
        it could reclaim and every page that evicting each eligible victim
        (strictly lower priority, preemptable, unprotected) would free?"""
        a = eng.allocator
        if isinstance(item, SwappedRequest) and item.has_blob:
            need = a.pages_for(item.n_kv)
            reclaimable = a.pinned_pages
        else:
            r = item.req if isinstance(item, SwappedRequest) else item
            need, reclaimable = a.admission_probe(
                r.prompt, r.max_new_tokens, reserve=self.reserve)
        attainable = a.free_pages + reclaimable
        if attainable >= need:
            return True
        for i, r in enumerate(eng.active):
            if (r is None or i in protect or r.priority <= prio
                    or not eng._preemptable(i)):
                continue
            # Eviction frees (or pins, reclaimable either way) the pages
            # at refcount 1; shared pages outlive it.
            attainable += sum(1 for p in a.pages_of(r.uid)
                              if a.refcount(p) == 1)
            if attainable >= need:
                return True
        return False

    # -- chunk order --------------------------------------------------------
    def select_prefill_slot(self, eng, cand: list[tuple[int, int]]) -> int:
        """Most urgent class first, FIFO within a class, among the slots
        whose borrowed prefix pages are written (`_prefix_ready`). Page
        ownership is acyclic in admission time, so the earliest-admitted
        prefilling slot is always ready; the unfiltered fallback is a
        safety net."""
        eligible = [(eng.active[slot].priority, uid, slot)
                    for uid, slot in cand if eng._prefix_ready(slot)]
        if not eligible:
            eligible = [(eng.active[slot].priority, uid, slot)
                        for uid, slot in cand]
        return min(eligible)[2]

    # -- preemption ---------------------------------------------------------
    def pick_victim(self, eng, below_priority,
                    protect=frozenset()) -> Optional[int]:
        """The lowest-priority, then youngest (largest uid) preemptable
        slot; None when none qualifies."""
        best, best_key = None, None
        for i, r in enumerate(eng.active):
            if r is None or i in protect:
                continue
            if below_priority is not None and r.priority <= below_priority:
                continue
            if not eng._preemptable(i):
                continue
            key = (r.priority, r.uid)
            if best is None or key > best_key:
                best, best_key = i, key
        return best
