"""Search-space optimization strategies (paper §3, §4.3, Fig 3).

The paper's default is Bayesian optimization (15-minute budget); random
search is the unbiased baseline used for the Fig 2 histograms. We implement
both, plus simulated annealing and capped exhaustive enumeration. The GP is
pure numpy (RBF kernel, expected-improvement acquisition).

All strategies accept a warm-start ``history`` (evaluations recorded by an
earlier, interrupted session): the session *replays* those scores instead
of re-measuring, so a resumed run makes exactly the same proposals — rng
draws and model fits see identical state — and continues where the dead
session stopped. ``evaluation_to_json`` / ``evaluation_from_json`` are the
serialized form (the fleet worker checkpoints them through the sync
transport).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.param import Config, ConfigSpace

from .runner import EvalResult

Evaluate = Callable[[Config], EvalResult]


@dataclass
class Evaluation:
    """One evaluated config inside a tuning session.

    The session-level record (config, score, feasibility, cumulative
    wall time when measured) — what trajectories are computed from,
    what fleet workers checkpoint, and what warm-start ``history``
    lists are made of.

    Example::

        e = Evaluation(config={"x": 3}, score_us=12.5, feasible=True,
                       wall_s=0.0)
    """

    config: Config
    score_us: float
    feasible: bool
    wall_s: float          # cumulative session wall time when evaluated
    error: str = ""


def evaluation_to_json(e: Evaluation) -> dict:
    """Serialize an :class:`Evaluation` for transport/checkpointing.

    The wire form fleet workers publish on the ``state`` channel and
    datasets/warm-starts round-trip through; inverse of
    :func:`evaluation_from_json`.

    Example::

        doc = evaluation_to_json(e)
        assert evaluation_from_json(doc) == e
    """
    return {"config": dict(e.config), "score_us": e.score_us,
            "feasible": bool(e.feasible), "wall_s": e.wall_s,
            "error": e.error}


def evaluation_from_json(d: dict) -> Evaluation:
    """Rebuild an :class:`Evaluation` from its JSON wire form.

    Tolerates missing optional fields (``wall_s``, ``error``) so
    checkpoints written by older workers still load.

    Example::

        history = [evaluation_from_json(d) for d in state["evaluations"]]
        tune_bayes(space, evaluate, history=history, ...)
    """
    return Evaluation(config=dict(d["config"]),
                      score_us=float(d["score_us"]),
                      feasible=bool(d["feasible"]),
                      wall_s=float(d.get("wall_s", 0.0)),
                      error=str(d.get("error", "")))


@dataclass
class TuningResult:
    """What one tuning session found: the winner plus the full log.

    ``best_config`` is None when nothing feasible was seen (then
    ``best_score_us`` is ``inf``). ``evaluations`` is the complete
    session log in evaluation order — the raw material for convergence
    trajectories, dataset recording, and warm starts.

    Example::

        res = tune_bayes(space, evaluate, max_evals=100)
        print(res.best_score_us, len(res.evaluations))
        for wall_s, best in res.trajectory():
            ...
    """

    strategy: str
    best_config: Config | None
    best_score_us: float
    evaluations: list[Evaluation] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def feasible_evaluations(self) -> list[Evaluation]:
        return [e for e in self.evaluations if e.feasible]

    def trajectory(self) -> list[tuple[float, float]]:
        """(wall_s, best-so-far score) pairs — the Fig 3 dashed line."""
        out, best = [], float("inf")
        for e in self.evaluations:
            if e.feasible and e.score_us < best:
                best = e.score_us
            if math.isfinite(best):
                out.append((e.wall_s, best))
        return out


class _Session:
    """Shared bookkeeping: dedup, budget, best-so-far."""

    MAX_CONSECUTIVE_DUPS = 300   # space likely exhausted beyond this

    def __init__(self, space: ConfigSpace, evaluate: Evaluate,
                 max_evals: int, time_budget_s: float | None,
                 history: Sequence[Evaluation] | None = None):
        self.space = space
        self.evaluate = evaluate
        self.max_evals = max_evals
        self.time_budget_s = time_budget_s
        self.t0 = time.perf_counter()
        self.seen: dict[tuple, Evaluation] = {}
        self.evals: list[Evaluation] = []
        self.best: Evaluation | None = None
        self._dups = 0
        # Warm start: recorded evaluations from an interrupted session,
        # consumed (instead of re-measured) when the strategy re-proposes
        # the same config. The strategy itself replays its decision
        # sequence from a fresh rng, so a same-seed resume walks the same
        # prefix for free and continues live past it.
        self._replay: dict[tuple, Evaluation] = {
            space.freeze(e.config): e for e in (history or [])}

    def exhausted(self) -> bool:
        if len(self.evals) >= self.max_evals:
            return True
        if self._dups >= self.MAX_CONSECUTIVE_DUPS:
            return True   # the whole valid space has (likely) been seen
        if (self.time_budget_s is not None
                and time.perf_counter() - self.t0 >= self.time_budget_s):
            return True
        return False

    def run(self, config: Config) -> Evaluation:
        key = self.space.freeze(config)
        if key in self.seen:
            self._dups += 1
            return self.seen[key]
        self._dups = 0
        recorded = self._replay.pop(key, None)
        if recorded is not None:
            ev = recorded
        else:
            r = self.evaluate(config)
            ev = Evaluation(config=dict(config), score_us=r.score_us,
                            feasible=r.feasible,
                            wall_s=time.perf_counter() - self.t0,
                            error=r.error)
        self.seen[key] = ev
        self.evals.append(ev)
        if ev.feasible and (self.best is None
                            or ev.score_us < self.best.score_us):
            self.best = ev
        return ev

    def feasible(self) -> list[Evaluation]:
        return [e for e in self.evals if e.feasible]

    def result(self, strategy: str) -> TuningResult:
        return TuningResult(
            strategy=strategy,
            best_config=dict(self.best.config) if self.best else None,
            best_score_us=self.best.score_us if self.best else float("inf"),
            evaluations=self.evals,
            wall_s=time.perf_counter() - self.t0)


def tune_random(space: ConfigSpace, evaluate: Evaluate, max_evals: int = 200,
                rng: np.random.Generator | None = None,
                time_budget_s: float | None = None,
                history: Sequence[Evaluation] | None = None) -> TuningResult:
    """Random search — the unbiased baseline (paper Fig 2's histograms).

    Rejection-samples valid configs uniformly; when the budget covers
    the whole space it switches to shuffled exhaustive enumeration so
    small spaces are covered without duplicate proposals.

    Example::

        res = tune_random(builder.space, evaluator, max_evals=200,
                          rng=np.random.default_rng(0))
    """
    rng = rng or np.random.default_rng(0)
    if space.cardinality() <= max_evals:
        # budget covers the whole space: shuffled exhaustive enumeration
        s = _Session(space, evaluate, max_evals, time_budget_s, history)
        cfgs = list(space.enumerate())
        rng.shuffle(cfgs)
        for cfg in cfgs:
            if s.exhausted():
                break
            s.run(cfg)
        return s.result("random")
    s = _Session(space, evaluate, max_evals, time_budget_s, history)
    while not s.exhausted():
        cfg = space.sample(rng, 1)[0]
        s.run(cfg)
    return s.result("random")


def tune_exhaustive(space: ConfigSpace, evaluate: Evaluate,
                    limit: int = 100_000,
                    history: Sequence[Evaluation] | None = None
                    ) -> TuningResult:
    """Enumerate the valid space in lexicographic order (capped).

    The only strategy guaranteed to find the true optimum — when the
    space fits the ``limit``. Used for small spaces, fleet shards, and
    recording complete tuning-space datasets.

    Example::

        res = tune_exhaustive(builder.space, evaluator, limit=1000)
        assert res.best_config is not None
    """
    s = _Session(space, evaluate, limit, None, history)
    for cfg in space.enumerate(limit=limit):
        if s.exhausted():
            break
        s.run(cfg)
    return s.result("exhaustive")


def tune_anneal(space: ConfigSpace, evaluate: Evaluate, max_evals: int = 200,
                rng: np.random.Generator | None = None,
                time_budget_s: float | None = None,
                t0: float = 0.3, t1: float = 0.01,
                history: Sequence[Evaluation] | None = None) -> TuningResult:
    """Simulated annealing over single-parameter mutations.

    A local search that accepts worse neighbors with probability
    ``exp(-relative_regression / temperature)``; the temperature decays
    geometrically from ``t0`` to ``t1`` over the eval budget, and the
    walk periodically restarts from the incumbent best. Strong on
    rugged landscapes where most of the space is bad but optima cluster.

    Example::

        res = tune_anneal(builder.space, evaluator, max_evals=200,
                          rng=np.random.default_rng(0))
    """
    rng = rng or np.random.default_rng(0)
    s = _Session(space, evaluate, max_evals, time_budget_s, history)
    cur = s.run(space.default_config())
    tries = 0
    while not s.exhausted():
        frac = len(s.evals) / max(s.max_evals, 1)
        temp = t0 * (t1 / t0) ** frac
        cand = space.neighbor(cur.config, rng)
        ev = s.run(cand)
        tries += 1
        if not cur.feasible:
            cur = ev
            continue
        if ev.feasible:
            # relative-improvement acceptance
            delta = (ev.score_us - cur.score_us) / max(cur.score_us, 1e-9)
            if delta <= 0 or rng.random() < math.exp(-delta / temp):
                cur = ev
        if tries % 50 == 0 and s.best is not None:
            cur = s.best  # periodic restart from incumbent
    return s.result("anneal")


# ----------------------------- Bayesian (GP-EI) -----------------------------

def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls**2)


def _gp_posterior(x: np.ndarray, y: np.ndarray, xq: np.ndarray,
                  ls: float = 0.25, noise: float = 1e-3
                  ) -> tuple[np.ndarray, np.ndarray]:
    k = _rbf(x, x, ls) + noise * np.eye(len(x))
    kq = _rbf(xq, x, ls)
    try:
        chol = np.linalg.cholesky(k)
    except np.linalg.LinAlgError:
        chol = np.linalg.cholesky(k + 1e-6 * np.eye(len(x)))
    alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, y))
    mean = kq @ alpha
    v = np.linalg.solve(chol, kq.T)
    var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
    return mean, var


def _expected_improvement(mean: np.ndarray, var: np.ndarray,
                          best: float) -> np.ndarray:
    std = np.sqrt(var)
    z = (best - mean) / std
    cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    pdf = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    return (best - mean) * cdf + std * pdf


def tune_bayes(space: ConfigSpace, evaluate: Evaluate, max_evals: int = 200,
               rng: np.random.Generator | None = None,
               time_budget_s: float | None = None,
               n_init: int = 12, pool: int = 256,
               history: Sequence[Evaluation] | None = None) -> TuningResult:
    """Bayesian optimization: GP + expected improvement over the
    unit-encoded config space (the paper's default strategy, per
    Willemsen et al. [28]).

    After ``n_init`` seeding evaluations, each step fits a pure-numpy
    RBF Gaussian process to the (log-scored, normalized) feasible
    history and evaluates the candidate — drawn from a random pool plus
    neighbors of the incumbent — with the highest expected improvement.
    The strategy of choice when evaluations are expensive.

    Example::

        res = tune_bayes(builder.space, evaluator, max_evals=200,
                         rng=np.random.default_rng(0))
    """
    rng = rng or np.random.default_rng(0)
    s = _Session(space, evaluate, max_evals, time_budget_s, history)
    # Latin-ish init: default + random
    s.run(space.default_config())
    for cfg in space.sample(rng, max(n_init - 1, 1)):
        if s.exhausted():
            break
        s.run(cfg)
    while not s.exhausted():
        feas = [e for e in s.evals if e.feasible]
        if len(feas) < 3:
            s.run(space.sample(rng, 1)[0])
            continue
        # Fit GP on (up to) the most recent 160 feasible evals, log-scores
        feas = feas[-160:]
        x = np.stack([space.to_unit(e.config) for e in feas])
        y = np.log(np.array([e.score_us for e in feas]))
        mu, sd = y.mean(), y.std() + 1e-9
        yn = (y - mu) / sd
        # candidate pool: random + neighbors of the incumbent
        cands = space.sample(rng, pool // 2)
        if s.best is not None:
            cands += [space.neighbor(s.best.config, rng)
                      for _ in range(pool // 2)]
        seen_keys = set(s.seen)
        cands = [c for c in cands if space.freeze(c) not in seen_keys]
        if not cands:
            s.run(space.sample(rng, 1)[0])
            continue
        xq = np.stack([space.to_unit(c) for c in cands])
        mean, var = _gp_posterior(x, yn, xq)
        ei = _expected_improvement(mean, var, yn.min())
        s.run(cands[int(np.argmax(ei))])
    return s.result("bayes")


#: Strategy registry: name -> callable, the lookup every CLI flag, job
#: spec, and harness strategy list goes through. All entries share the
#: signature ``(space, evaluate, ..., history=None) -> TuningResult``
#: (``tune_exhaustive`` takes ``limit`` instead of ``max_evals``/``rng``).
#: E.g. ``STRATEGIES["bayes"](space, evaluate, max_evals=100)``.
STRATEGIES: dict[str, Callable[..., TuningResult]] = {
    "random": tune_random,
    "bayes": tune_bayes,
    "anneal": tune_anneal,
    "exhaustive": tune_exhaustive,
}
