"""The plain reference against the program's plain path on the CPU, at the
smoke sizes in float32: a paged prompt chunk, then paged decode steps.

Exact mode agrees to float32 rounding. In LUT mode the program's CPU path
takes one softmax over all keys (max, then the exp table), where the
reference takes the paged cache's page-ordered online softmax (the walk
the card's kernels make), which multiplies two of the table's values
where the one-pass form reads one. With a page that holds every key the
two are one function and agree to float32 rounding; at the cache's page
they differ by the table's interpolation error (under 0.5% of a
probability), within 5e-3 of the logits' scale."""
import dataclasses

import pytest
import torch

from portbench import weights
from portbench.reference.model import Reference, gaps
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.models import api as model_api

PAGE = 4
TOL = 2e-4
TOL_ONLINE = 5e-3


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("registry", ["gpt2-medium", "nemotron-4-340b"])
def test_reference_matches_the_paged_path(registry, mode):
    cfg = get_config(registry, smoke=True)
    params = weights.draw(model_api.init_params(cfg, device="meta"), 11, "cpu")
    eng = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
    T, P = 37, 29
    tokens = torch.randint(0, cfg.vocab, (T,), generator=torch.Generator().manual_seed(3))
    n_pages = -(-T // PAGE)
    cache = model_api.init_paged_cache(cfg, 1, n_pages + 1, PAGE, n_pages, device="cpu")
    cache.block_tables[0] = torch.arange(1, n_pages + 1, dtype=torch.int32)
    chunk = model_api.verify_tokens(params, tokens[None, :P], cache.block_tables,
                                    torch.zeros(1, dtype=torch.int32), cache.k_pages,
                                    cache.v_pages, cfg, eng)[0][0]
    cache.lengths[0] = P
    dec = []
    for j in range(P, T):
        logits, cache = model_api.decode_step(params, tokens[j:j + 1], cache, cfg, eng)
        dec.append(logits[0])
    port = torch.cat([chunk, torch.stack(dec)]).float()
    model = dataclasses.asdict(cfg)
    one = Reference(params, model, nonlinear_mode=mode, lut_sections=64,
                    page_size=T).logits(tokens)
    scale = one.abs().max()
    assert (port - one).abs().max() <= TOL * scale
    paged = Reference(params, model, nonlinear_mode=mode, lut_sections=64,
                      page_size=PAGE).logits(tokens)
    assert (port - paged).abs().max() <= (TOL if mode == "exact" else TOL_ONLINE) * scale
    # The program's greedy tokens lie no further below the reference's best
    # than the logits differ.
    assert gaps(one, port.argmax(-1)).max() <= 2 * TOL * scale


def test_gaps():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.1, 0.4]])
    assert gaps(logits, torch.tensor([1, 2])).tolist() == pytest.approx([0.0, 0.1])
