"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness's whole run on the CPU (the program's plain
path) at a tiny size, past the look for a card, with one fault planted
in the program the window drives:

  state     the decode step returns the KV pools as they were (its writes
            undone), so later tokens attend to missing keys;
  half      half of the batch left out: the decode step's logits for the
            upper half of the slots are copies of the lower half's;
  token     tokens altered where they are produced: every third call of
            the sampler hands back the next id of each row's;

and a run with none comes out correct. (One card: no exchange between
chips to leave out.)"""
import pathlib

import pytest

from portbench import harness

DATA = pathlib.Path(__file__).resolve().parent / "data"
SEED = 2**31 + 77


def run(cell, **kw):
    res, lines, found = harness.run_cell(cell, SEED, 1.5, False, data_dir=DATA,
                                         benchmark=DATA / "BENCHMARK.json", device="cpu", **kw)
    assert not found
    return res


def state_unchanged(monkeypatch):
    from repro_torch.serving import engine as eng_mod
    real = eng_mod.model_api.decode_step

    def step(params, token, cache, cfg, engine, **kw):
        k, v = cache.k_pages.clone(), cache.v_pages.clone()
        logits, new = real(params, token, cache, cfg, engine, **kw)
        new.k_pages.copy_(k)
        new.v_pages.copy_(v)
        return logits, new
    monkeypatch.setattr(eng_mod.model_api, "decode_step", step)


def half_batch(monkeypatch):
    from repro_torch.serving import engine as eng_mod
    real = eng_mod.model_api.decode_step

    def step(params, token, cache, cfg, engine, **kw):
        logits, new = real(params, token, cache, cfg, engine, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, new
    monkeypatch.setattr(eng_mod.model_api, "decode_step", step)


def token_altered(monkeypatch):
    from repro_torch.serving import engine as eng_mod
    real = eng_mod.sample
    calls = [0]

    def sample(logits, *a, **kw):
        tok = real(logits, *a, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(eng_mod, "sample", sample)


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["checked"]["tokens"]["value"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered],
                         ids=["state", "half", "token"])
@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert not res["correct"], res["checked"]
