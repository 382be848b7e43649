"""The port's analytical cost model (``repro_torch.tuner.costmodel``), its
evaluator and the Hopper inputs the kernels' workload hooks give it,
against the JAX package's ``repro.tuner.costmodel``.

``CostModel.time`` is the reference's, term for term: the same workload
field values on a device kind both packages define give the same seconds,
the hashed noise included (rtol 1e-12). The H100 spec, which only the port
has, goes through the reference's formula too. The stencil hooks' inputs
(``reuse`` from the launch plan) order configs as the card's times did,
without moving the profiler's bounds (``tests/test_torch_prof.py``). The
surrogate fitted from a recorded space (``fit_from_dataset``) is the
reference's to rtol 1e-12 on every shipped space and on one the port
recorded.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import device as repro_device
from repro.core.device import DeviceSpec as RefDeviceSpec
from repro.core.workload import Workload as RefWorkload
from repro.tuner import costmodel as repro_costmodel
from repro.tuner.runner import CostModelEvaluator as RefCostModelEvaluator

import repro_torch.core as pc
from repro_torch.core import GPU_H100, Workload, get_kernel
from repro_torch.core import device as port_device
from repro_torch.kernels import _stencil_common, advec_u, diff_uvw
from repro_torch.prof import profile_from_workload
from repro_torch.sandbox import make_faulty_kernel
from repro_torch.tuner import (INFEASIBLE, CostModel, CostModelEvaluator,
                               FittedCostModel, fit_from_dataset,
                               kernel_time, tune_kernel)
from repro_torch.tuner.costmodel import _hash_noise

torch.set_num_threads(1)

#: Device kinds both packages define.
SHARED_KINDS = sorted(set(repro_device.DEVICES) & set(port_device.DEVICES))


def _ref_spec(spec) -> RefDeviceSpec:
    """The reference's DeviceSpec holding ``spec``'s numbers."""
    names = [f.name for f in dataclasses.fields(RefDeviceSpec)]
    return RefDeviceSpec(**{n: getattr(spec, n) for n in names})


def _random_workloads(seed: int, n: int) -> list[tuple[dict, str, str]]:
    """``n`` (workload fields, dtype, noise key) drawn with numpy: every
    branch of the model (matmul tile or vector, one buffer or two, spill
    overflow, invalid) is taken."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fields = {
            "flops": float(10 ** rng.uniform(3, 13)),
            "hbm_bytes": float(10 ** rng.uniform(3, 11)),
            "vmem_bytes": int(10 ** rng.uniform(2, 8.5)),
            "grid": int(rng.integers(1, 100_000)),
            "mxu_tile": (tuple(int(x) for x in rng.choice(
                [1, 8, 16, 24, 64, 100, 128, 256], 3))
                if rng.random() < 0.5 else None),
            "lane_extent": int(rng.choice([1, 8, 64, 100, 128, 256, 1024])),
            "sublane_extent": int(rng.choice([1, 4, 8, 16])),
            "unroll_ways": int(rng.integers(1, 9)),
            "reuse": float(rng.uniform(0.0, 12.0)),
            "buffers": int(rng.integers(1, 4)),
            "valid": bool(rng.random() < 0.95),
        }
        dtype = str(rng.choice(["float32", "bfloat16", "float16"]))
        key = "" if i % 7 == 0 else f"cfg{int(rng.integers(1 << 30))}|{i}"
        out.append((fields, dtype, key))
    return out


# ----------------------------------------------------------- the formula

def test_shared_device_kinds_hold_the_references_numbers():
    assert len(SHARED_KINDS) == 7 and "gpu-h100" not in SHARED_KINDS
    for kind in SHARED_KINDS:
        port = dataclasses.asdict(port_device.DEVICES[kind])
        ref = dataclasses.asdict(repro_device.DEVICES[kind])
        assert {k: port[k] for k in ref} == ref


@pytest.mark.parametrize("kind", SHARED_KINDS + ["gpu-h100"])
def test_cost_model_time_is_the_references(kind):
    """Same workload field values, same kind, same noise key: the same
    seconds within rtol 1e-12, INFEASIBLE alike. For gpu-h100, which the
    reference does not define, its formula runs on the port's spec."""
    spec = port_device.get_device(kind)
    ref_spec = (repro_device.DEVICES[kind] if kind in SHARED_KINDS
                else _ref_spec(spec))
    port_model, ref_model = CostModel(spec), repro_costmodel.CostModel(
        ref_spec)
    finite = 0
    for fields, dtype, key in _random_workloads(seed=len(kind), n=400):
        got = port_model.time(Workload(**fields), dtype, noise_key=key)
        want = ref_model.time(RefWorkload(**fields), dtype, noise_key=key)
        if want == repro_costmodel.INFEASIBLE:
            assert got == INFEASIBLE
            continue
        finite += 1
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)
        assert kernel_time(Workload(**fields), spec, dtype, key) == \
            pytest.approx(repro_costmodel.kernel_time(
                RefWorkload(**fields), ref_spec, dtype, key), rel=1e-12)
    assert finite > 150


def test_hash_noise_is_the_references():
    for i in range(50):
        key = f"gpu-h100|block={i}|{(512,) * 3}|float32"
        assert _hash_noise(key, 0.05) == repro_costmodel._hash_noise(key,
                                                                     0.05)


# ------------------------------------------------------------ evaluator

def test_cost_model_evaluator_matches_the_references_on_one_space():
    """The faulty kernel has the same space and workload hook in both
    packages: the two evaluators give the same score for every config on
    a kind both define."""
    from repro.sandbox.faults import make_faulty_kernel as ref_faulty
    port_b, ref_b = make_faulty_kernel(), ref_faulty()
    port_ev = CostModelEvaluator(port_b, (64, 32), "float32", "gpu-a100",
                                 verify="none")
    ref_ev = RefCostModelEvaluator(ref_b, (64, 32), "float32",
                                   repro_device.get_device("gpu-a100"),
                                   verify="none")
    for cfg in port_b.space.enumerate():
        got, want = port_ev(cfg), ref_ev(cfg)
        assert got.feasible == want.feasible
        assert got.score_us == pytest.approx(want.score_us, rel=1e-12)
        assert got.info["profile"] == want.info["profile"]


def test_cost_model_objective_tunes_and_records(tmp_path):
    b = get_kernel("matmul")
    res = tune_kernel(b, (256, 256, 256), "float32", "gpu-h100",
                      strategy="random", max_evals=30, objective="costmodel",
                      wisdom_dir=tmp_path, seed=0, device="cpu")
    scores = [e.score_us for e in res.evaluations if e.feasible]
    assert len(res.evaluations) == 30 and res.best_score_us == min(scores)
    rec = pc.Wisdom.load("matmul", tmp_path).records[0]
    assert rec.provenance["objective"] == "costmodel"
    assert rec.device_kind == "gpu-h100" and rec.config == res.best_config
    ev = CostModelEvaluator(b, (256, 256, 256), "float32", "gpu-h100",
                            verify="none")
    assert ev(res.best_config).score_us == res.best_score_us


def test_cost_model_evaluator_verifies_on_the_given_tensors():
    b = get_kernel("advec_u")
    args = b.make_probe_args((8, 8, 16), "float32")
    ev = CostModelEvaluator(b, (8, 8, 16), "float32", "gpu-h100",
                            verify_args=args)
    r = ev(b.default_config())
    assert r.feasible and r.verified is True
    assert r.info["workload"].reuse > 1.0
    assert r.info["profile"]["hbm_bytes"] == r.info["workload"].hbm_bytes
    bad = dict(b.default_config(), block_size_x=7)
    assert ev(bad).error == "restricted"


def test_cost_model_evaluator_marks_wrong_output_infeasible():
    b = make_faulty_kernel()
    args = b.make_probe_args((8, 8), "float32")
    ev = CostModelEvaluator(b, (8, 8), "float32", "gpu-h100",
                            verify_args=args)
    assert ev({"scale": 1, "fault": "none"}).verified is True
    r = ev({"scale": 1, "fault": "wrong"})
    assert not r.feasible and r.verified is False
    assert "allclose failed" in r.error


# ------------------------------------------------- the H100's inputs

#: K2a's f32 tile times at 512^3 on the H100 follow the halo share of a
#: staged plane: 64 x 8 < 128 x 4 < 64 x 4 < 32 x 4 (PERF.md §6).
K2A_BLOCKS = [(64, 8), (128, 4), (64, 4), (32, 4)]


def _k2a_tile(bx: int, by: int) -> dict:
    return get_kernel("diff_uvw").default_config() | {
        "body": "tile", "block_size_x": bx, "block_size_y": by,
        "strip_z": 128, "min_blocks_per_sm": 1, "fuse_outputs": True}


def test_stencil_reuse_is_the_plans_staged_to_computed_ratio():
    b = get_kernel("diff_uvw")
    reuse = []
    for bx, by in K2A_BLOCKS:
        cfg = _k2a_tile(bx, by)
        assert b.space.is_valid(cfg)
        w = b.make_workload(cfg, (512,) * 3, "float32")
        p = diff_uvw.plan(cfg, (512,) * 3, "float32")
        # four fields, each staging (by + 2) rows of bx + 2 chunks, over
        # the strip and its two halo planes
        staged = 4 * (by + 2) * (bx + 8) * (128 + 2)
        assert w.reuse == pytest.approx(staged / (4 * bx * by * 128))
        assert p.staged_planes == 130
        reuse.append(w.reuse)
    assert reuse == sorted(reuse)
    # the ldg body: the box its threads' reads cover, per point written
    cfg = get_kernel("advec_u").default_config() | {
        "body": "ldg", "strip_z": 64, "block_size_x": 32,
        "block_size_y": 4, "block_size_z": 1, "tile_factor_z": 2}
    w = get_kernel("advec_u").make_workload(cfg, (64,) * 3, "float32")
    boxes = (32 + 6) * (4 + 6) + 32 * (4 + 2) + 32 * 4
    assert w.reuse == pytest.approx(boxes * (2 + 6) / (3 * 32 * 4 * 2))
    assert w.unroll_ways == 2


def test_model_orders_k2a_tiles_like_the_card():
    model = CostModel(GPU_H100, noise_sigma=0)
    times = [model.time(get_kernel("diff_uvw").make_workload(
        _k2a_tile(bx, by), (512,) * 3, "float32"), "float32")
        for bx, by in K2A_BLOCKS]
    assert times == sorted(times) and len(set(times)) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_no_longer_ranks_every_stencil_config_alike(dtype):
    """Without noise, advec_u's configs at 512^3 get many distinct times,
    memory-bound ones, and the tile body beats the ldg body at the same
    block."""
    b = get_kernel("advec_u")
    model = CostModel(GPU_H100, noise_sigma=0)
    rng = np.random.default_rng(0)
    times = {model.time(b.make_workload(c, (512,) * 3, dtype), dtype)
             for c in b.space.sample(rng, 200)}
    assert len(times) > 50
    w = b.make_workload(b.default_config(), (512,) * 3, dtype)
    p = profile_from_workload(w, GPU_H100, dtype, 1.0)
    t = model.time(w, dtype)
    assert t >= p.memory_us * 1e-6 * w.reuse
    ldg = b.default_config() | {"body": "ldg", "strip_z": 64,
                                "min_blocks_per_sm": 1}
    tile = b.default_config() | {"min_blocks_per_sm": 1}
    assert model.time(b.make_workload(tile, (512,) * 3, dtype), dtype) < \
        model.time(b.make_workload(ldg, (512,) * 3, dtype), dtype)


def test_compulsory_fields_stay_what_the_profiler_reads():
    """The cost-model inputs leave flops, hbm_bytes, vmem_bytes and grid
    as the profiler's bounds read them."""
    for name, mod in (("advec_u", advec_u), ("diff_uvw", diff_uvw)):
        b = get_kernel(name)
        cfg = b.default_config()
        w = b.make_workload(cfg, (64, 32, 16), "float32")
        p = mod.plan(cfg, (64, 32, 16), "float32")
        assert w.vmem_bytes == p.smem_bytes
        assert w.grid == p.grid[0] * p.grid[1] * p.grid[2]
    m = get_kernel("matmul")
    w = m.make_workload(m.default_config(), (512, 512, 1024), "bfloat16")
    assert w.mxu_tile[2] == 64 and w.reuse == 1.0
    assert w.unroll_ways == m.default_config()["stages"]
    f = get_kernel("flash_attention_causal")
    w = f.make_workload(f.default_config(), (8, 8, 256, 128), "bfloat16")
    assert w.mxu_tile == (64, 64, 128) and w.unroll_ways == 2
    assert _stencil_common.TILE_AHEAD + 1 == get_kernel(
        "advec_u").make_workload(get_kernel("advec_u").default_config(),
                                 (64,) * 3, "float32").unroll_ways


# ------------------------------------------------ the fitted surrogate

SHIPPED_SPACES = sorted((Path(__file__).resolve().parent.parent / "benchmarks"
                         / "datasets").glob("*.space.json"))


def _assert_same_fit(port_model, ref_model, configs):
    assert port_model.n_samples == ref_model.n_samples
    for attr in ("fit_quality",):
        assert getattr(port_model, attr)() == pytest.approx(
            getattr(ref_model, attr)(), rel=1e-12, abs=1e-15)
    for attr in ("rmse_log", "baseline_rmse_log", "mean_log"):
        assert getattr(port_model, attr) == pytest.approx(
            getattr(ref_model, attr), rel=1e-12)
    np.testing.assert_allclose(port_model.weights, ref_model.weights,
                               rtol=1e-12, atol=1e-12)
    for cfg in configs:
        assert port_model.predict(cfg) == pytest.approx(
            ref_model.predict(cfg), rel=1e-12)


@pytest.mark.parametrize("profile_features", [False, True])
@pytest.mark.parametrize("path", SHIPPED_SPACES,
                         ids=lambda p: p.name.split(".")[0])
def test_fit_from_dataset_is_the_references(path, profile_features):
    """The same recorded space gives the same ridge weights, fit quality
    and predictions (rtol 1e-12), with and without profile features, on
    recorded and unrecorded configs alike."""
    from repro.tunebench import SpaceDataset as RefSpaceDataset
    from repro.tuner.costmodel import fit_from_dataset as ref_fit
    from repro_torch.tunebench import SpaceDataset

    ds = SpaceDataset.load(path)
    port_model = fit_from_dataset(ds, profile_features=profile_features)
    ref_model = ref_fit(RefSpaceDataset.load(path),
                        profile_features=profile_features)
    configs = [e.config for e in ds.evaluations.values()]
    configs += ds.space().sample(np.random.default_rng(0), 8)
    _assert_same_fit(port_model, ref_model, configs)
    assert isinstance(port_model, FittedCostModel)


def test_fit_on_a_space_the_port_recorded_is_the_references(tmp_path):
    """A Hopper-native space recorded by the port's cost model, saved and
    loaded by the reference: both fits agree on every config."""
    from repro.tunebench import SpaceDataset as RefSpaceDataset
    from repro.tuner.costmodel import fit_from_dataset as ref_fit
    from repro_torch.tunebench import record_space

    ds = record_space(get_kernel("matmul"), (512, 512, 1024), "float32",
                      "gpu-h100")
    path = ds.save(tmp_path / "mm.space.json")
    for profile_features in (False, True):
        _assert_same_fit(
            fit_from_dataset(ds, profile_features=profile_features),
            ref_fit(RefSpaceDataset.load(path),
                    profile_features=profile_features),
            [e.config for e in ds.feasible()])


def test_fit_needs_enough_samples():
    from repro_torch.core import ConfigSpace
    from repro_torch.tunebench import SpaceDataset
    s = ConfigSpace()
    s.tune("x", (0, 1, 2, 3), default=0)
    ds = SpaceDataset("k", s, (8, 8), "float32", "gpu-h100")
    ds.add({"x": 0}, 1.0, "ok")
    with pytest.raises(ValueError, match="at least 3"):
        fit_from_dataset(ds)


def test_pretune_writes_h100_wisdom_by_the_cost_model(tmp_path, capsys):
    """pretune prices every built-in kernel's scenarios on gpu-h100 with
    the cost model (no launch) and writes a record for each."""
    from repro_torch.core import Wisdom
    from repro_torch.tuner.pretune import DTYPES, PROBLEMS, main
    assert main(["--out", str(tmp_path), "--evals", "3"]) == 0
    for name, problems in PROBLEMS.items():
        w = Wisdom.load(name, tmp_path)
        assert {(r.device_kind, r.problem_size, r.dtype) for r in w.records} \
            == {("gpu-h100", p, d) for p in problems for d in DTYPES}
        assert all(r.provenance["objective"] == "costmodel"
                   for r in w.records)
    assert "gpu-h100" in capsys.readouterr().out
