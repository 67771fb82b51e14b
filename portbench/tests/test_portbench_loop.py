"""The loop's records follow the engine's events, not its slots: after
every step of a whole run (the program's plain path on the CPU, at a
tiny size) its live rows, their keys and its set of decoding requests
equal what a walk over the engine's slots finds, and each finished
request's record holds its tokens and times."""
import pathlib

import pytest

from portbench import harness

DATA = pathlib.Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
def test_loop_records_match_the_slots(cell, monkeypatch):
    real = harness.Loop.step
    seen = []

    def step(self):
        st = real(self)
        live = [r for r in self.eng.active if r is not None and not r.prefilling]
        assert st.rows == len(live)
        assert st.keys == sum(len(r.prompt) + len(r.generated) for r in live)
        assert self.live == {r.uid for r in live}
        assert set(self.queued) == {r.uid for r in self.eng.queue}
        for r in self.eng.finished:
            rec = self.reqs[r.uid]
            assert rec.n == len(r.generated) and rec.first <= rec.last == rec.done_at
        seen.append(st)
        return st

    monkeypatch.setattr(harness.Loop, "step", step)
    res, _, found = harness.run_cell(cell, 2**31 + 91, 1.5, False, data_dir=DATA,
                                     benchmark=DATA / "BENCHMARK.json", device="cpu")
    assert not found and res["correct"]
    assert any(s.chunk for s in seen) and sum(s.tokens for s in seen) > 0
