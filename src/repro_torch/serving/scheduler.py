"""Scheduler (the port of `repro.serving.scheduler`, FIFO only): strict
FIFO admission (paged: under the page watermark net of shared prefix
pages, no skip past a blocked head; dense: into any free slot), prompt
chunks in admission (uid) order, no preemption, no pinned prefix pages."""
from __future__ import annotations


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
