"""Profile-guided tuning: turn recorded roofline counters into search signal.

Port of ``repro.prof.guided``: the same reports on the same datasets.

The plain ridge surrogate
(:func:`repro_torch.tuner.costmodel.fit_from_dataset`)
sees only unit-encoded config coordinates — it must *rediscover* hardware
structure from scores. The profiler already computed that structure per
config (roofline compute/memory time terms, arithmetic intensity, VMEM
pressure — all derived from the workload hook, available *before* a
config is ever measured), so the profile-guided surrogate regresses on
it directly. :func:`surrogate_rerank` quantifies the payoff the way
``benchmarks/strategy_bench.py`` gates it: train both surrogates on a
small subsample of recorded scores, rank the whole space by prediction,
replay in rank order, and compare fraction-of-optimum at fixed
evaluation budgets — the performance-counter-guided-search result
(profiles prune tuning spaces) reproduced on our recorded spaces.
"""

from __future__ import annotations

import numpy as np

from .profile import profile_feature_vector

#: Evaluation budgets the re-rank comparison reports (and the benchmark
#: gates): how good is the best config found after replaying the top-K
#: surrogate-ranked candidates. The floor is 8, not smaller: the
#: recorded spaces end in a plateau of near-optimal configs whose
#: *ordering* is decided by the cost model's ±5% measurement noise — a
#: surrogate can learn which configs form the plateau (structure) but
#: not which plateau member the noise blessed (luck), so budgets below
#: the plateau width gate on luck.
DEFAULT_BUDGETS = (8, 16, 32, 64)

#: Every ``train_every``-th feasible entry (in key order) trains the
#: surrogates; the rest of the space is what ranking must generalize
#: to. 8 keeps the training sample small (12.5% of the space) — the
#: regime profile features are for: with scores scarce, hardware
#: structure has to come from somewhere other than the scores.
DEFAULT_TRAIN_EVERY = 8


class _Subset:
    """Adapter giving ``fit_from_dataset`` a reduced training view of a
    dataset (same space, fewer feasible entries)."""

    def __init__(self, dataset, entries):
        self._dataset = dataset
        self._entries = list(entries)

    def space(self):
        return self._dataset.space()

    def feasible(self):
        return list(self._entries)


def surrogate_rerank(dataset, budgets=DEFAULT_BUDGETS,
                     train_every: int = DEFAULT_TRAIN_EVERY) -> dict:
    """Compare plain vs profile-guided surrogate re-ranking on one
    recorded space.

    Both surrogates are fitted on the same deterministic training
    subsample (every ``train_every``-th feasible entry in key order),
    then rank *every* feasible config by predicted score; the recorded
    space is replayed in that order and the best score after each budget
    is reported as a fraction of the space's optimum (1.0 = found it).
    The profile surrogate's ranking may use any config's roofline
    counters — they come from the workload hook, not from measurements,
    so a real tuning session has them for free before evaluating
    anything.

    Returns a deterministic report dict (``surrogates`` rows carry
    ``fraction_at`` per budget and the fit quality).

    Example::

        r = surrogate_rerank(SpaceDataset.load("matmul....space.json"))
        r["surrogates"][1]["fraction_at"]["8"]   # profile surrogate @ 8
    """
    from repro_torch.tuner.costmodel import fit_from_dataset

    feas = dataset.feasible()
    if len(feas) < 8:
        raise ValueError(f"recorded space too small to re-rank "
                         f"({len(feas)} feasible entries)")
    train = feas[::max(1, int(train_every))]
    best = dataset.best()
    optimum = best.score_us
    space = dataset.space()
    full_lookup = {
        space.freeze(e.config):
            np.array(profile_feature_vector(
                getattr(e, "profile", None) or {}))
        for e in feas}
    budgets = [int(b) for b in budgets]
    rows = []
    for name, use_profile in (("ridge", False), ("profile", True)):
        model = fit_from_dataset(_Subset(dataset, train),
                                 profile_features=use_profile)
        if use_profile:
            # Rank with every config's (pre-measurement) counters, not
            # just the training subsample's.
            model.profile_lookup = full_lookup
        ranked = sorted(
            feas, key=lambda e: (model.predict(e.config),
                                 dataset.key_for(e.config)))
        fraction_at = {}
        for b in budgets:
            found = min(e.score_us for e in ranked[:b])
            fraction_at[str(b)] = round(optimum / found, 6)
        rows.append({"surrogate": name,
                     "fraction_at": fraction_at,
                     "fit_quality": round(model.fit_quality(), 6)})
    return {
        "dataset": dataset.name(),
        "feasible": len(feas),
        "train_size": len(train),
        "train_every": int(train_every),
        "budgets": budgets,
        "optimum_us": round(optimum, 6),
        "surrogates": rows,
    }


def rerank_gate(report: dict) -> list[str]:
    """Regression gate over a :func:`surrogate_rerank` report: the
    profile-guided surrogate must meet or beat the plain ridge
    surrogate's fraction-of-optimum at every budget. Returns the list of
    violations (empty = pass) so benchmarks can assert on it.

    Example::

        problems = rerank_gate(surrogate_rerank(ds))
        assert not problems, problems
    """
    by_name = {r["surrogate"]: r for r in report["surrogates"]}
    plain, prof = by_name["ridge"], by_name["profile"]
    out = []
    for b in report["budgets"]:
        fp = prof["fraction_at"][str(b)]
        fr = plain["fraction_at"][str(b)]
        if fp + 1e-9 < fr:
            out.append(f"{report['dataset']}: profile surrogate "
                       f"{fp:.4f} < ridge {fr:.4f} at budget {b}")
    return out
