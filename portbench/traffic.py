"""The load generator's arithmetic: request sizes and arrival times from a
traffic mix file (`traffic/<mix>.json`) and a seed.

Every seed gets the same set of sizes and gaps, in another order: a deck
of n values at the quantiles (k + 0.5) / n of the mix's distribution,
shuffled by the seed and dealt again when it runs out. So a seed changes
which request is long, not how much work a run holds. An open loop's
decks hold the arrivals of one run (`per_run`: its rate times its
warm-up and window), so every run is offered the same prompts, outputs
and total time between arrivals; a closed loop's hold `DECK`. A mix with
an `order_seed` deals its decks in that seed's order whatever the run's
seed, which then draws only the token ids (and the weights): a tail of
a queue at a fixed rate swings with the order of long prompts and short
gaps far more than with anything the program does.

Distributions ("dist"):
  uniform    integers lo..hi inclusive
  lognormal  exp(ln(median) + sigma * z), rounded, clipped to lo..hi

A closed loop's first cohort (one request a client) takes its output
budgets from the residual-length distribution, P(R = r) proportional to
P(L >= r): the tokens an in-flight request of a steady state still owes,
so completions are spread from the first steps on. An open loop's
arrivals are Poisson at `rate_per_s`: exponential gaps from the deck.
"""
from __future__ import annotations

import dataclasses
import statistics

import numpy as np

DECK = 512


def quantile(spec: dict, q: float) -> int:
    """The q-quantile of a length distribution, an integer in lo..hi."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return min(hi, lo + int(q * (hi - lo + 1)))
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        return int(min(hi, max(lo, round(float(np.exp(np.log(spec["median"])
                                                        + spec["sigma"] * z))))))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def deck(spec: dict, n: int = DECK) -> np.ndarray:
    return np.array([quantile(spec, (k + 0.5) / n) for k in range(n)], np.int64)


def residual_deck(spec: dict, n: int) -> np.ndarray:
    """n budgets at the quantiles of the residual-length distribution of
    `spec`: P(R = r) = P(L >= r) / E[L], r >= 1."""
    lengths = deck(spec)
    hi = int(lengths.max())
    survival = np.array([(lengths >= r).mean() for r in range(1, hi + 1)])
    cdf = np.cumsum(survival) / survival.sum()
    qs = (np.arange(n) + 0.5) / n
    return np.searchsorted(cdf, qs, side="left").astype(np.int64) + 1


class Dealer:
    """Deals a deck's values in seeded order, reshuffling each pass."""

    def __init__(self, values: np.ndarray, rng: np.random.Generator):
        self.values, self.rng, self.order, self.i = values, rng, [], 0

    def next(self):
        if self.i >= len(self.order):
            self.order, self.i = self.rng.permutation(len(self.values)), 0
        v = self.values[self.order[self.i]].item()
        self.i += 1
        return v


@dataclasses.dataclass
class RequestSpec:
    prompt: np.ndarray       # token ids
    max_new: int
    due: float = 0.0         # seconds after the loop's start (open loop)


class Traffic:
    """Requests of one mix for one seed, in order of their index."""

    def __init__(self, mix: dict, vocab: int, seed: int, seconds: float = 0.0):
        """`seconds`: how long an open loop offers load in one run (its
        decks hold that many seconds of arrivals)."""
        self.mix = mix
        self.vocab = vocab
        s_tok, s_prompt, s_out, s_gap, s_first = np.random.SeedSequence(seed).spawn(5)
        if "order_seed" in mix:
            s_prompt, s_out, s_gap = np.random.SeedSequence(mix["order_seed"]).spawn(3)
        n = DECK
        if mix["loop"] == "open":
            if mix["arrivals"]["process"] != "poisson":
                raise ValueError(f"unknown arrival process {mix['arrivals']['process']!r}")
            rate = float(mix["arrivals"]["rate_per_s"])
            n = per_run(rate, seconds)
            qs = (np.arange(n) + 0.5) / n
            self.gaps = Dealer(-np.log1p(-qs) / rate, np.random.default_rng(s_gap))
            self.t = 0.0
        elif mix["loop"] == "closed":
            first = residual_deck(mix["output"], int(mix["clients"]))
            self.first = list(np.random.default_rng(s_first).permutation(first))
        else:
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.tok_rng = np.random.default_rng(s_tok)
        self.prompts = Dealer(deck(mix["prompt"], n), np.random.default_rng(s_prompt))
        self.outputs = Dealer(deck(mix["output"], n), np.random.default_rng(s_out))

    def _prompt(self) -> np.ndarray:
        n = self.prompts.next()
        return self.tok_rng.integers(0, self.vocab, size=n, dtype=np.int64)

    def first_cohort(self) -> list[RequestSpec]:
        """A closed loop's opening requests, one a client."""
        return [RequestSpec(self._prompt(), int(b)) for b in self.first]

    def next_closed(self) -> RequestSpec:
        return RequestSpec(self._prompt(), self.outputs.next())

    def next_open(self) -> RequestSpec:
        """The next arrival; `due` in seconds after the loop's start."""
        self.t += self.gaps.next()
        return RequestSpec(self._prompt(), self.outputs.next(), due=self.t)


def per_run(rate: float, seconds: float) -> int:
    """The arrivals an open loop at `rate` offers in `seconds` (at least
    one), the size of its decks."""
    return max(1, int(np.ceil(rate * seconds)))


def max_tokens(mix: dict) -> int:
    """The most cache positions a request of the mix can occupy."""
    return int(mix["prompt"]["hi"]) + int(mix["output"]["hi"]) - 1
