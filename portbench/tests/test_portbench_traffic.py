"""The load generator: seeded, deterministic, in range; the Poisson
schedule and the residual-length first cohort."""
import json
import pathlib

import numpy as np
import pytest

from portbench import traffic

MIXES = pathlib.Path(__file__).resolve().parents[1] / "traffic"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(p.stem for p in MIXES.glob("*.json")))
def test_seeded_deterministic_in_range(name):
    m = mix(name)
    a = traffic.Traffic(m, 50257, 2**31 + 5, 48.0)
    b = traffic.Traffic(m, 50257, 2**31 + 5, 48.0)
    c = traffic.Traffic(m, 50257, 2**31 + 6, 48.0)
    take = (lambda t: [t.next_open() for _ in range(300)]) if m["loop"] == "open" else \
        (lambda t: t.first_cohort() + [t.next_closed() for _ in range(300)])
    ra, rb, rc = take(a), take(b), take(c)
    for x, y in zip(ra, rb):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new and x.due == y.due
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(ra, rc))
    if "order_seed" in m:
        assert [(len(x.prompt), x.max_new, x.due) for x in ra] == \
            [(len(y.prompt), y.max_new, y.due) for y in rc]
    for r in ra:
        assert m["prompt"]["lo"] <= len(r.prompt) <= m["prompt"]["hi"]
        assert 1 <= r.max_new <= m["output"]["hi"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 50257


@pytest.mark.parametrize("name", sorted(p.stem for p in MIXES.glob("*.json")))
def test_seeds_share_the_sizes(name):
    """Two seeds deal the same deck of sizes in another order."""
    m = mix(name)
    m.pop("order_seed", None)
    a, b = traffic.Traffic(m, 1000, 1, 48.0), traffic.Traffic(m, 1000, 2, 48.0)
    if m["loop"] == "open":
        n = traffic.per_run(m["arrivals"]["rate_per_s"], 48.0)
        ra = [a.next_open() for _ in range(n)]
        rb = [b.next_open() for _ in range(n)]
        assert sorted(len(r.prompt) for r in ra) == sorted(len(r.prompt) for r in rb)
        assert ra[-1].due == pytest.approx(rb[-1].due, rel=1e-9)
    else:
        n = traffic.DECK
        ra = [a.next_closed() for _ in range(n)]
        rb = [b.next_closed() for _ in range(n)]
        assert sorted(r.max_new for r in ra) == sorted(r.max_new for r in rb)
        assert sorted(r.max_new for r in a.first_cohort()) == \
            sorted(r.max_new for r in b.first_cohort())


def test_poisson_schedule():
    m = {"loop": "open", "arrivals": {"process": "poisson", "rate_per_s": 4.0},
         "prompt": {"dist": "uniform", "lo": 8, "hi": 8},
         "output": {"dist": "uniform", "lo": 4, "hi": 4}}
    t = traffic.Traffic(m, 100, 3, 128.0)
    dues = np.array([t.next_open().due for _ in range(512)])
    gaps = np.diff(np.concatenate([[0.0], dues]))
    assert np.all(gaps > 0)
    # A whole deck holds the exponential's quantiles: mean 1/rate, and the
    # share of gaps under the median ln 2 / rate is a half.
    assert gaps.mean() == pytest.approx(0.25, rel=0.01)
    assert (gaps < np.log(2) / 4.0).mean() == pytest.approx(0.5, abs=0.01)


def test_lognormal_quantiles():
    spec = {"dist": "lognormal", "median": 768, "sigma": 0.5, "lo": 256, "hi": 2048}
    d = traffic.deck(spec)
    assert np.median(d) == pytest.approx(768, abs=2)
    assert d.min() >= 256 and d.max() <= 2048


def test_residual_first_cohort():
    """Uniform lengths on [a, b]: the residual life has mean E[L^2] / 2E[L]
    and never exceeds b; a short budget is likelier than a long one."""
    spec = {"dist": "uniform", "lo": 384, "hi": 496}
    r = traffic.residual_deck(spec, 4096)
    L = traffic.deck(spec).astype(np.float64)
    assert r.min() >= 1 and r.max() <= 496
    assert r.mean() == pytest.approx((L ** 2).mean() / (2 * L.mean()), rel=0.02)
    assert (r < 100).sum() > (r > 400).sum()
