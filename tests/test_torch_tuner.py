"""The port's tuner strategies held to the reference's, and the cost-model
properties its own tests state, on the same landscapes.

Each landscape is built once per package: the same space, the same score
function, each package's own ``EvalResult``. Every strategy must make the
same evaluations in the same order (configs and scores) for a seed; a
session killed mid-way and resumed from its serialized log must continue
exactly as the uninterrupted run, also when one package wrote the log and
the other resumes from it. The cost-model cases are the reference's
``tests/test_tuner.py`` properties that ``tests/test_torch_costmodel.py``
does not state, on kinds both packages define and on ``gpu-h100``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import repro.core as rc
import repro.tuner as rt
from repro.tuner import costmodel as ref_costmodel
from repro.tuner import evaluation_from_json as ref_from_json
from repro.tuner import evaluation_to_json as ref_to_json
from repro.tuner.runner import EvalResult as RefEvalResult

import repro_torch.core as pc
import repro_torch.tuner as pt
from repro_torch.tuner import evaluation_from_json, evaluation_to_json

PKGS = {"port": (pc, pt, pt.EvalResult, evaluation_to_json,
                 evaluation_from_json),
        "ref": (rc, rt, RefEvalResult, ref_to_json, ref_from_json)}
STRATEGIES = ["tune_random", "tune_anneal", "tune_bayes"]


def quadratic(pkg: str):
    """score = (x-5)^2 + (y-3)^2 + 1 on a 10 x 10 grid, minimum at (5, 3)."""
    core, _, result, *_ = PKGS[pkg]
    s = core.ConfigSpace()
    s.tune("x", tuple(range(10)))
    s.tune("y", tuple(range(10)))

    def evaluate(cfg):
        return result(score_us=float((cfg["x"] - 5) ** 2
                                     + (cfg["y"] - 3) ** 2 + 1.0),
                      feasible=True)
    return s, evaluate


def restricted(pkg: str):
    """A restricted space (a string rule and a callable one) with one
    infeasible corner, minimum at block_x 64, block_y 2, unroll 1."""
    core, _, result, *_ = PKGS[pkg]
    s = core.ConfigSpace()
    s.tune("block_x", (16, 32, 64, 128), default=32)
    s.tune("block_y", (1, 2, 4, 8))
    s.tune("unroll", (1, 2, 4))
    s.tune("flag", (True, False))
    s.restrict("block_x * block_y <= 512")
    s.restrict(lambda c: c["block_x"] % c["unroll"] == 0)

    def evaluate(cfg):
        if cfg["block_x"] == 16 and cfg["block_y"] == 8:
            return result(score_us=math.inf, feasible=False, error="corner")
        v = ((math.log2(cfg["block_x"]) - 6) ** 2
             + (cfg["block_y"] - 2) ** 2 + cfg["unroll"]
             + (0.0 if cfg["flag"] else 0.5))
        return result(score_us=float(v), feasible=True)
    return s, evaluate


LANDSCAPES = {"quadratic": quadratic, "restricted": restricted}


def run(pkg: str, landscape: str, strategy: str, seed: int, **kw):
    s, ev = LANDSCAPES[landscape](pkg)
    fn = getattr(PKGS[pkg][1], strategy)
    if strategy == "tune_exhaustive":
        return s, fn(s, ev, limit=1000, **kw)
    return s, fn(s, ev, max_evals=kw.pop("max_evals", 40),
                 rng=np.random.default_rng(seed), **kw)


def trace(space, result) -> list:
    return [(space.freeze(e.config), e.score_us, e.feasible, e.error)
            for e in result.evaluations]


#: (strategy, landscape, seed); exhaustive takes no seed.
SESSIONS = [(s, land, seed) for s in STRATEGIES for land in sorted(LANDSCAPES)
            for seed in (0, 7)] + [("tune_exhaustive", land, 0)
                                   for land in sorted(LANDSCAPES)]


@pytest.mark.parametrize("strategy,landscape,seed", SESSIONS)
def test_every_strategy_makes_the_references_evaluations(strategy,
                                                         landscape, seed):
    s_p, got = run("port", landscape, strategy, seed)
    s_r, want = run("ref", landscape, strategy, seed)
    assert trace(s_p, got) == trace(s_r, want)
    assert got.best_config == want.best_config
    assert got.best_score_us == want.best_score_us
    assert got.strategy == want.strategy
    # the trajectory's times are wall clock; its best-so-far scores agree
    assert [b for _, b in got.trajectory()] == \
        [b for _, b in want.trajectory()]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_find_the_optimum_region(strategy):
    _, res = run("port", "quadratic", strategy, 0, max_evals=60)
    assert res.best_score_us <= 3.0


def test_exhaustive_finds_the_exact_optimum_of_each_landscape():
    _, res = run("port", "quadratic", "tune_exhaustive", 0)
    assert res.best_score_us == 1.0 and res.best_config == {"x": 5, "y": 3}
    s, res = run("port", "restricted", "tune_exhaustive", 0)
    assert len(res.evaluations) == s.valid_cardinality()
    assert res.best_config == {"block_x": 64, "block_y": 2, "unroll": 1,
                               "flag": True}
    # block_x 16 x block_y 8: 3 unrolls x 2 flags
    assert sum(not e.feasible for e in res.evaluations) == 6


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_trajectory_is_monotone(strategy):
    _, res = run("port", "restricted", strategy, 1, max_evals=50)
    scores = [b for _, b in res.trajectory()]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_no_config_is_evaluated_twice(strategy):
    s, _ = quadratic("port")
    calls = []

    def ev(cfg):
        calls.append(s.freeze(cfg))
        return pt.EvalResult(1.0, True)

    getattr(pt, strategy)(s, ev, max_evals=30, rng=np.random.default_rng(0))
    assert len(calls) == len(set(calls)) == 30


# ------------------------------------------------------ crash and resume

class _Interrupted(Exception):
    pass


def _crashed_log(pkg: str, strategy: str, crash_after: int, seed: int):
    """The first ``crash_after`` evaluations of a session killed there,
    written with ``pkg``'s ``evaluation_to_json`` (the last one measured
    but never seen by the session, as a fleet worker's crash leaves it)."""
    _, tuner, _, to_json, _ = PKGS[pkg]
    s, ev = quadratic(pkg)
    log = []

    def ev_crash(cfg):
        r = ev(cfg)
        log.append(tuner.Evaluation(config=dict(cfg), score_us=r.score_us,
                                    feasible=r.feasible, wall_s=0.0,
                                    error=r.error))
        if len(log) >= crash_after:
            raise _Interrupted
        return r

    with pytest.raises(_Interrupted):
        getattr(tuner, strategy)(s, ev_crash, max_evals=40,
                                 rng=np.random.default_rng(seed))
    return [to_json(e) for e in log]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("ref", "port"),
                                           ("port", "ref")])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_resume_continues_as_the_uninterrupted_run(strategy, writer, reader):
    seed, crash_after = 7, 13
    s, full = run(reader, "quadratic", strategy, seed)
    docs = _crashed_log(writer, strategy, crash_after, seed)
    history = [PKGS[reader][4](d) for d in docs]
    s_r, ev = quadratic(reader)
    calls = []

    def ev_resumed(cfg):
        calls.append(s_r.freeze(cfg))
        return ev(cfg)

    resumed = getattr(PKGS[reader][1], strategy)(
        s_r, ev_resumed, max_evals=40, rng=np.random.default_rng(seed),
        history=history)
    whole = [s.freeze(e.config) for e in full.evaluations]
    assert [s.freeze(d["config"]) for d in docs] == whole[:crash_after]
    assert calls == whole[crash_after:]
    assert [s.freeze(e.config) for e in resumed.evaluations] == whole
    assert resumed.best_config == full.best_config
    assert resumed.best_score_us == full.best_score_us


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_exhaustive_resume_skips_the_measured_prefix(writer):
    s_w, ev_w = quadratic(writer)
    _, tuner_w, _, to_json, _ = PKGS[writer]
    head = [c for _, c in zip(range(30), s_w.enumerate())]
    docs = [to_json(tuner_w.Evaluation(config=dict(c),
                                       score_us=ev_w(c).score_us,
                                       feasible=True, wall_s=0.0))
            for c in head]
    s, ev = quadratic("port")
    calls = []

    def ev_live(cfg):
        calls.append(s.freeze(cfg))
        return ev(cfg)

    res = pt.tune_exhaustive(s, ev_live, limit=1000,
                             history=[evaluation_from_json(d) for d in docs])
    assert len(calls) == 100 - 30
    assert calls == [s.freeze(c) for c in list(s.enumerate())[30:]]
    assert len(res.evaluations) == 100
    assert res.best_config == {"x": 5, "y": 3}


def test_evaluation_json_is_the_references():
    for e in (pt.Evaluation(config={"x": 1, "y": 2}, score_us=3.5,
                            feasible=True, wall_s=0.25),
              pt.Evaluation(config={"x": 0}, score_us=math.inf,
                            feasible=False, wall_s=0.0, error="vmem")):
        doc = evaluation_to_json(e)
        ref = rt.Evaluation(config=dict(e.config), score_us=e.score_us,
                            feasible=e.feasible, wall_s=e.wall_s,
                            error=e.error)
        assert doc == ref_to_json(ref)
        back = evaluation_from_json(ref_to_json(ref))
        assert evaluation_to_json(back) == doc


# ------------------------------------------------------------ cost model

#: Kinds both packages define, and the H100, which only the port has.
KINDS = ["tpu-v5e", "gpu-a100", "gpu-h100"]


def models(kind: str, **kw):
    """The port's model for ``kind`` and the reference's where it has the
    kind (else None)."""
    port = pt.CostModel(pc.get_device(kind), **kw)
    ref = (ref_costmodel.CostModel(rc.get_device(kind), **kw)
           if kind != "gpu-h100" else None)
    return port, ref


def times(kind: str, fields: list[dict], dtype: str, **kw) -> list[float]:
    """Each workload's seconds in the port, held equal to the reference's
    where it has the kind."""
    port, ref = models(kind, noise_sigma=0)
    got = [port.time(pc.Workload(**f), dtype, **kw) for f in fields]
    if ref is not None:
        want = [ref.time(rc.Workload(**f), dtype, **kw) for f in fields]
        assert got == pytest.approx(want, rel=1e-12)
    return got


@pytest.mark.parametrize("kind", KINDS)
def test_cost_model_spill_degrades_then_is_infeasible(kind):
    vmem = pc.get_device(kind).vmem_bytes
    if kind == "gpu-h100":
        assert vmem == 232_448     # a block's shared memory on the H100
    base = dict(flops=1e9, hbm_bytes=1e6, grid=1)
    t_fit, t_spill, t_edge, t_blown = times(kind, [
        base | {"vmem_bytes": 1024}, base | {"vmem_bytes": int(vmem * 1.5)},
        base | {"vmem_bytes": vmem * 4}, base | {"vmem_bytes": vmem * 4 + 1}],
        "float32")
    assert np.isfinite(t_fit) and np.isfinite(t_spill)
    assert t_spill > t_fit and np.isfinite(t_edge) and t_edge > t_spill
    assert not np.isfinite(t_blown)


@pytest.mark.parametrize("kind", KINDS)
def test_cost_model_is_monotone_in_flops_and_bytes(kind):
    base = dict(vmem_bytes=1024, grid=16)
    t1, t2, t3, t4 = times(kind, [
        base | {"flops": 1e12, "hbm_bytes": 1e9},
        base | {"flops": 4e12, "hbm_bytes": 1e9},
        base | {"flops": 1e9, "hbm_bytes": 1e9},
        base | {"flops": 1e9, "hbm_bytes": 8e9}], "bfloat16")
    assert t2 > t1 and t4 > t3


@pytest.mark.parametrize("kind", KINDS)
def test_cost_model_f32_is_slower_than_bf16_when_compute_bound(kind):
    w = dict(flops=1e13, hbm_bytes=1e6, vmem_bytes=1024, grid=1,
             mxu_tile=(256, 256, 256))
    (f32,), (bf16,) = (times(kind, [w], d) for d in ("float32", "bfloat16"))
    assert f32 > bf16


@pytest.mark.parametrize("kind", KINDS)
def test_cost_model_penalises_a_ragged_tile(kind):
    base = dict(flops=1e13, hbm_bytes=1e6, vmem_bytes=1024, grid=1)
    aligned, ragged = times(kind, [base | {"mxu_tile": (256, 256, 256)},
                                   base | {"mxu_tile": (130, 257, 256)}],
                            "bfloat16")
    assert ragged > aligned


@pytest.mark.parametrize("kind", KINDS)
def test_cost_model_noise_is_deterministic_per_key(kind):
    port, ref = models(kind)
    w = dict(flops=1e12, hbm_bytes=1e9, vmem_bytes=1024, grid=4)
    a, b, c = (port.time(pc.Workload(**w), "float32", noise_key=k)
               for k in ("k1", "k1", "k2"))
    assert a == b and a != c
    if ref is not None:
        assert a == pytest.approx(ref.time(rc.Workload(**w), "float32",
                                           noise_key="k1"), rel=1e-12)
