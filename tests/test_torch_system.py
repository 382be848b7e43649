"""The paper's end-to-end claims on the port's Hopper ``advec_u`` space,
scored by the port's cost model (no launch), and the selection they rest on
held to the reference's.

C1  the default config is far from the optimum;
C2  a config tuned for one scenario transfers poorly to the others;
C3  runtime selection reaches each scenario's optimum (PPM 1.0) while no
    fixed config does (matches it in every scenario); the reference
    selects the same records from the port's wisdom file;
C5  the first launch builds, the second is a cache hit, a new problem
    size builds again (on the CPU; the nvcc half is the card test
    ``test_wisdom_kernel_launch_stats_on_card`` in
    ``tests/test_torch_gpu.py``).

Each search is seeded by ``zlib.crc32`` of its scenario's key, so the
results do not depend on ``PYTHONHASHSEED``; the budget is a number of
evaluations, never a time.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import repro.core as rc

import repro_torch.core as pc
from repro_torch.configs.microhh import Scenario
from repro_torch.tuner import CostModelEvaluator, tune_kernel, tune_random

torch.set_num_threads(1)

SCENARIOS = [
    Scenario("advec_u", (32, 32, 128), "float32", "gpu-h100"),
    Scenario("advec_u", (64, 64, 128), "float32", "gpu-h100"),
    Scenario("advec_u", (32, 32, 128), "bfloat16", "gpu-a100"),
    Scenario("advec_u", (64, 64, 128), "float32", "gpu-a100"),
]
EVALS = 80


def seed(sc: Scenario) -> int:
    return zlib.crc32(sc.key.encode())


def score(sc: Scenario, cfg: dict) -> float:
    return CostModelEvaluator(pc.get_kernel(sc.kernel), sc.grid, sc.dtype,
                              sc.device, verify="none")(cfg).score_us


@pytest.fixture(scope="module")
def tuned() -> dict:
    """Each scenario's best config and score (random search, 80 draws)."""
    best = {}
    for sc in SCENARIOS:
        b = pc.get_kernel(sc.kernel)
        ev = CostModelEvaluator(b, sc.grid, sc.dtype, sc.device,
                                verify="none")
        res = tune_random(b.space, ev, max_evals=EVALS,
                          rng=np.random.default_rng(seed(sc)))
        assert len(res.evaluations) == EVALS
        best[sc.key] = (res.best_config, res.best_score_us)
    return best


def test_c1_the_default_is_far_from_the_optimum(tuned):
    default = pc.get_kernel("advec_u").default_config()
    fracs = []
    for sc in SCENARIOS:
        default_us = score(sc, default)
        assert tuned[sc.key][1] < default_us, sc.key
        fracs.append(tuned[sc.key][1] / default_us)
    assert np.mean(fracs) < 0.9        # tuning buys > 10 % on average


def test_c2_one_scenarios_config_is_worse_elsewhere(tuned):
    donor = tuned[SCENARIOS[0].key][0]
    worse = [sc.key for sc in SCENARIOS[1:]
             if score(sc, donor) > tuned[sc.key][1] * 1.02]
    assert len(worse) >= 2, worse


def test_c3_runtime_selection_reaches_each_optimum(tmp_path, tuned):
    for sc in SCENARIOS:
        res = tune_kernel(pc.get_kernel(sc.kernel), sc.grid, sc.dtype,
                          sc.device, strategy="random", max_evals=EVALS,
                          time_budget_s=None, objective="costmodel",
                          wisdom_dir=tmp_path, seed=seed(sc), device="cpu")
        # the same seeded search as the fixture's, through the entry point
        assert (res.best_config, res.best_score_us) == tuned[sc.key]
    ref_wisdom = rc.Wisdom.load("advec_u", tmp_path)
    assert len(ref_wisdom.records) == len(SCENARIOS)
    ppm_selected = []
    for sc in SCENARIOS:
        k = pc.WisdomKernel(pc.get_kernel(sc.kernel), wisdom_dir=tmp_path,
                            device_kind=sc.device)
        cfg, tier = k.select_config(sc.grid, sc.dtype)
        assert tier == "exact", sc.key
        assert cfg == tuned[sc.key][0]
        rec, ref_tier = ref_wisdom.select_record(sc.device, sc.grid,
                                                 sc.dtype)
        assert (rec.config, ref_tier) == (cfg, "exact")
        ppm_selected.append(tuned[sc.key][1] / score(sc, cfg))
    assert ppm_selected == [1.0] * len(SCENARIOS)
    # No fixed config (each scenario's best, used everywhere) matches the
    # selection in every scenario. Each scenario's share is capped at 1:
    # 80 random draws leave scenario 0 under-tuned (1.145 modelled us,
    # where the other scenarios' configs take 0.87-0.99 us), so an uncapped
    # mean of best / fixed can pass 1 without the fixed config being as
    # good everywhere.
    for donor in SCENARIOS:
        cfg = tuned[donor.key][0]
        ppm = np.mean([min(1.0, tuned[sc.key][1] / score(sc, cfg))
                       for sc in SCENARIOS])
        assert ppm < 1.0, donor.key


def test_c5_the_second_launch_is_a_cache_hit(tmp_path, small_fields):
    u, v, w, _, scal = (torch.from_numpy(a.copy()) for a in small_fields)
    k = pc.WisdomKernel(pc.get_kernel("advec_u"), wisdom_dir=tmp_path,
                        device_kind="gpu-h100")
    k(u, v, w, scal)
    k(u, v, w, scal)
    first, second = k.stats
    assert not first.cached and second.cached
    assert second.compile_s == 0.0 and second.load_s == 0.0
    # a new problem size is a new scenario: it builds again (paper §4.5)
    k(u[:8], v[:8], w[:8], scal)
    assert not k.stats[-1].cached
    assert k.tier_counts == {"default": 3}
