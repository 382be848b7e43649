"""Recorded tuning spaces and simulated strategy benchmarking in the port
(``repro_torch.tunebench``), against the JAX package's ``repro.tunebench``.

The dataset format is the reference's byte for byte: every shipped
``benchmarks/datasets/*.space.json`` (recorded on the reference's TPU
spaces) loads and re-saves unchanged in both packages, and a space the
port records by the cost model for a kernel both packages define the same
way is the reference's recording. ``compare`` reports over the shipped
spaces are the reference's bytes. The port's own, Hopper-native spaces are
recorded here by the cost model, and by wall clock on CPU tensors (the
plain versions) where the card is not present; the card's recordings are
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 9.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.tunebench as rtb
from repro.core.builder import KernelBuilder as RefKernelBuilder
from repro.core.param import ConfigSpace as RefConfigSpace
from repro.core.workload import Workload as RefWorkload

from repro_torch.core import ConfigSpace, KernelBuilder, Workload, get_kernel
from repro_torch.tunebench import (DATASET_VERSION, DatasetMiss, DatasetStore,
                                   DatasetVersionError, SimulatedRunner,
                                   SpaceDataset, compare, dump_report,
                                   fraction_curve, history_from_dataset,
                                   migrate_dataset_doc, record_space,
                                   report_to_text, run_on_dataset)
from repro_torch.tuner import CostModelEvaluator, tune_kernel, tune_random

torch.set_num_threads(1)

DATASET_DIR = (Path(__file__).resolve().parent.parent / "benchmarks"
               / "datasets")
SHIPPED = sorted(DATASET_DIR.glob("*.space.json"))


def _ids(p: Path) -> str:
    return p.name.split(".")[0]


def small_space(cls=ConfigSpace):
    s = cls()
    s.tune("x", (0, 1, 2, 3), default=0)
    s.tune("y", (0, 1, 2), default=0)
    return s


def quadratic_dataset(cls=SpaceDataset, space_cls=ConfigSpace):
    """Known landscape: score = (x-2)^2 + (y-1)^2 + 1, optimum at (2,1)."""
    s = small_space(space_cls)
    ds = cls("quad", s, (8, 8), "float32", "gpu-h100")
    for cfg in s.enumerate():
        ds.add(cfg, (cfg["x"] - 2) ** 2 + (cfg["y"] - 1) ** 2 + 1.0, "ok")
    return ds


def _twin_kernel(builder_cls, workload_cls, name="twin"):
    """One kernel, declared the same way in either package: a space, a
    restriction and a workload hook the cost model prices."""
    b = builder_cls(name, source="tests/test_torch_tunebench.py")
    b.tune("tile", (64, 128, 256, 512, 1024), default=128)
    b.tune("unroll", (1, 2, 4), default=1)
    b.restriction("tile * unroll <= 2048")

    @b.workload
    def _wl(config, problem, dtype):
        n = int(np.prod(problem))
        tile = config["tile"]
        return workload_cls(flops=2.0 * n * config["unroll"],
                            hbm_bytes=4.0 * n * (1 + 128 / tile),
                            vmem_bytes=tile * tile * 16,
                            grid=max(n // tile, 1),
                            lane_extent=min(tile, 256),
                            unroll_ways=config["unroll"])

    return b


# ------------------------------------------------ the reference's format

@pytest.mark.parametrize("path", SHIPPED, ids=_ids)
def test_shipped_dataset_resaves_byte_identically_in_both(path, tmp_path):
    """Each shipped space loads and re-saves to the same bytes in the port
    and the reference, and the two loads agree on the optimum."""
    mine = SpaceDataset.load(path)
    theirs = rtb.SpaceDataset.load(path)
    a = mine.save(tmp_path / "port.space.json")
    b = theirs.save(tmp_path / "ref.space.json")
    assert a.read_bytes() == b.read_bytes() == path.read_bytes()
    assert mine.best().config == theirs.best().config
    assert mine.name() == theirs.name()
    assert mine.scenario_key() == theirs.scenario_key()
    assert list(mine.evaluations) == list(theirs.evaluations)


@pytest.mark.parametrize("path", SHIPPED, ids=_ids)
def test_compare_report_is_the_references(path):
    """Every strategy replayed over a shipped space: the same report
    bytes as the reference's, and the same text."""
    mine = compare([SpaceDataset.load(path)])
    theirs = rtb.compare([rtb.SpaceDataset.load(path)])
    assert dump_report(mine) == rtb.dump_report(theirs)
    assert report_to_text(mine) == rtb.report_to_text(theirs)


def test_cost_model_recording_is_the_references():
    """The same kernel, recorded by the cost model on a device kind both
    packages define: the same dataset, byte for byte."""
    mine = record_space(_twin_kernel(KernelBuilder, Workload), (256, 256),
                        "float32", "gpu-a100")
    theirs = rtb.record_space(_twin_kernel(RefKernelBuilder, RefWorkload),
                              (256, 256), "float32", "gpu-a100")
    assert json.dumps(mine.to_doc(), indent=2, sort_keys=True) == \
        json.dumps(theirs.to_doc(), indent=2, sort_keys=True)
    assert len(mine) == 14 and mine.restriction_srcs == [
        "tile * unroll <= 2048"]


@pytest.mark.parametrize("strategy", ["random", "bayes", "anneal",
                                      "exhaustive"])
def test_simulated_session_is_the_references(strategy):
    """A seeded session over the same recorded space proposes the same
    configs in the same order in both packages."""
    a = run_on_dataset(quadratic_dataset(), strategy, budget=10, seed=3)
    b = rtb.run_on_dataset(quadratic_dataset(rtb.SpaceDataset,
                                             RefConfigSpace),
                           strategy, budget=10, seed=3)
    assert [e.config for e in a.evaluations] == \
        [e.config for e in b.evaluations]
    assert [e.score_us for e in a.evaluations] == \
        [e.score_us for e in b.evaluations]


# ----------------------------------------------------------------- dataset

def test_add_keeps_best_outcome():
    ds = SpaceDataset("k", small_space(), (8, 8), "float32", "gpu-h100")
    cfg = {"x": 1, "y": 1}
    ds.add(cfg, 10.0, "ok")
    ds.add(cfg, float("inf"), "infeasible", error="later failure")
    assert ds.lookup(cfg).score_us == 10.0          # ok beats infeasible
    ds.add(cfg, 5.0, "ok")
    assert ds.lookup(cfg).score_us == 5.0           # lower ok wins
    ds.add(cfg, 7.0, "ok")
    assert ds.lookup(cfg).score_us == 5.0
    assert len(ds) == 1


def test_best_and_feasible():
    ds = quadratic_dataset()
    assert len(ds) == 12 and len(ds.feasible()) == 12
    assert ds.best().score_us == 1.0
    assert ds.best().config == {"x": 2, "y": 1}


def test_roundtrip_is_byte_stable(tmp_path):
    ds = quadratic_dataset()
    p1 = ds.save(tmp_path / "a.space.json")
    ds2 = SpaceDataset.load(p1)
    p2 = ds2.save(tmp_path / "b.space.json")
    assert p1.read_bytes() == p2.read_bytes()
    assert ds2.space().names == ds.space().names


def test_key_mismatch_refused(tmp_path):
    path = quadratic_dataset().save(tmp_path / "d.space.json")
    doc = json.loads(path.read_text())
    key = next(iter(doc["evaluations"]))
    doc["evaluations"][key]["config"] = {"x": 3, "y": 2}   # tampered
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="does not match"):
        SpaceDataset.load(path)


def test_future_version_refused_loudly():
    doc = quadratic_dataset().to_doc()
    doc["version"] = DATASET_VERSION + 1
    with pytest.raises(DatasetVersionError, match="NOT read"):
        SpaceDataset.from_doc(doc)
    with pytest.raises(DatasetVersionError):
        migrate_dataset_doc(doc)


def test_migrate_normalizes_versionless_doc():
    doc = quadratic_dataset().to_doc()
    del doc["version"]
    out = migrate_dataset_doc(doc)
    assert out["version"] == DATASET_VERSION
    assert "version" not in doc                     # input not mutated
    assert len(SpaceDataset.from_doc(out).evaluations) == 12


def test_wrong_format_refused():
    with pytest.raises(ValueError, match="tuning-space"):
        SpaceDataset.from_doc({"format": "wisdom", "kernel": "k"})


def test_dataset_store_roundtrip_and_scenarios(tmp_path):
    store = DatasetStore(tmp_path / "ds")
    path = store.save(quadratic_dataset())
    assert path.name == "quad--gpu-h100--8x8--float32.space.json"
    again = store.load_for("quad", "gpu-h100", (8, 8), "float32")
    assert again is not None and len(again) == 12
    assert store.load_for("quad", "gpu-a100", (8, 8), "float32") is None
    assert store.datasets() == [path]
    assert store.scenarios(kernel="quad") == [
        ("quad", "gpu-h100", (8, 8), "float32", path)]
    assert rtb.DatasetStore(tmp_path / "ds").scenarios() == \
        store.scenarios()


# --------------------------------------------------------------- recording

def test_evaluator_records_every_evaluation_including_infeasible():
    """The port's advec_u space at 64x64x128 on gpu-a4000 (its L2 is the
    cost model's on-chip capacity): feasible and overflowing configs are
    both recorded, with the session's scores."""
    b = get_kernel("advec_u")
    ds = SpaceDataset(b.name, b.space, (64, 64, 128), "float32",
                      "gpu-a4000")
    ev = CostModelEvaluator(b, (64, 64, 128), "float32", "gpu-a4000",
                            verify="none", record_to=ds)
    res = tune_random(b.space, ev, max_evals=50,
                      rng=np.random.default_rng(0))
    assert len(ds) == len(res.evaluations)
    assert {e.status for e in ds.evaluations.values()} == {"ok"}
    for e in res.evaluations:
        assert ds.lookup(e.config).score_us == e.score_us
        assert ds.lookup(e.config).profile["bottleneck"] == "memory"
    restricted = {**b.default_config(), "body": "ldg", "strip_z": 32}
    ev(restricted)
    assert ds.lookup(restricted).status == "infeasible"
    assert ds.lookup(restricted).error == "restricted"


def test_record_space_is_deterministic_and_whole():
    b = get_kernel("matmul")
    d1 = record_space(b, (128, 128, 128), "float32", "gpu-h100")
    d2 = record_space(b, (128, 128, 128), "float32", "gpu-h100")
    assert d1.to_doc() == d2.to_doc()
    assert len(d1) == b.space.valid_cardinality() == 216
    assert d1.provenance == {"recorder": "record_space",
                             "objective": "costmodel",
                             "space_cardinality": 216,
                             "limit": 1_000_000}


def test_record_space_by_wall_clock_on_host_tensors():
    """objective="wallclock" with device="cpu" times the plain version on
    the kernel's probe tensors: every config verified and recorded in
    space order, a limit records that prefix."""
    b = get_kernel("matmul")
    ds = record_space(b, (32, 32, 64), "float32", "cpu",
                      objective="wallclock", limit=12, device="cpu")
    assert [e.config for e in ds.evaluations.values()] == list(
        b.space.enumerate(limit=12))
    assert len(ds.feasible()) == 12
    assert ds.provenance["device"] == "cpu" and ds.provenance["limit"] == 12


def test_record_space_wallclock_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        record_space(get_kernel("matmul"), (32, 32, 64), "float32",
                     "gpu-h100", objective="wallclock", limit=1)


def test_tune_kernel_record_dataset_merges(tmp_path):
    b = get_kernel("matmul")
    res = tune_kernel(b, (128, 128, 128), "float32", "gpu-h100",
                      strategy="random", max_evals=20, time_budget_s=None,
                      write_wisdom=False, seed=0, objective="costmodel",
                      record_dataset=tmp_path / "ds")
    store = DatasetStore(tmp_path / "ds")
    ds = store.load_for("matmul", "gpu-h100", (128, 128, 128), "float32")
    assert ds is not None and len(ds) == len(res.evaluations)
    assert ds.provenance == {"recorder": "tune_kernel"}
    tune_kernel(b, (128, 128, 128), "float32", "gpu-h100",
                strategy="random", max_evals=20, time_budget_s=None,
                write_wisdom=False, seed=1, objective="costmodel",
                record_dataset=tmp_path / "ds")
    merged = store.load_for("matmul", "gpu-h100", (128, 128, 128),
                            "float32")
    assert len(merged) >= len(ds)


def test_tune_kernel_writes_through_the_wisdom_store(tmp_path):
    from repro_torch.distrib import WisdomStore
    store = WisdomStore(tmp_path / "w")
    res = tune_kernel(get_kernel("matmul"), (128, 128, 128), "float32",
                      "gpu-h100", strategy="random", max_evals=10,
                      time_budget_s=None, objective="costmodel",
                      store=store)
    rec = WisdomStore(tmp_path / "w").load("matmul").records[0]
    assert rec.config == res.best_config and rec.device_kind == "gpu-h100"


def test_record_dataset_refuses_cross_scenario_merge(tmp_path):
    path = tmp_path / "one.space.json"
    b = get_kernel("matmul")
    tune_kernel(b, (128, 128, 128), "float32", "gpu-h100",
                strategy="random", max_evals=5, time_budget_s=None,
                write_wisdom=False, objective="costmodel",
                record_dataset=path)
    with pytest.raises(ValueError, match="cannot merge"):
        tune_kernel(b, (256, 256, 256), "float32", "gpu-h100",
                    strategy="random", max_evals=5, time_budget_s=None,
                    write_wisdom=False, objective="costmodel",
                    record_dataset=path)


# --------------------------------------------------------------- simulation

def test_simulated_runner_replays_and_counts():
    sim = SimulatedRunner(quadratic_dataset())
    assert sim({"x": 2, "y": 1}).score_us == 1.0
    missing = sim({"x": 99, "y": 99})
    assert not missing.feasible and "not in dataset" in missing.error
    assert (sim.calls, sim.hits, sim.misses) == (2, 1, 1)


def test_simulated_runner_on_miss_error():
    with pytest.raises(DatasetMiss):
        SimulatedRunner(quadratic_dataset(), on_miss="error")(
            {"x": 99, "y": 99})
    with pytest.raises(ValueError):
        SimulatedRunner(quadratic_dataset(), on_miss="what")


# ----------------------------------------------------------------- harness

def test_fraction_curve_monotone_and_padded():
    ds = quadratic_dataset()
    curve = fraction_curve(ds, run_on_dataset(ds, "random", budget=20,
                                              seed=0), 20)
    assert len(curve) == 20 and curve == sorted(curve) and curve[-1] == 1.0


def test_compare_report_deterministic_and_gated():
    ds = quadratic_dataset()
    r1 = compare([ds], budget=12, seeds=(0, 1))
    assert dump_report(r1) == dump_report(compare([ds], budget=12,
                                                  seeds=(0, 1)))
    assert r1["pass"]
    r3 = compare([ds], budget=12, seeds=(0, 1), thresholds={"random": 1.1})
    assert not r3["pass"]
    by_name = {s["strategy"]: s for s in r3["datasets"][0]["strategies"]}
    assert not by_name["random"]["pass"] and by_name["exhaustive"]["pass"]
    text = dump_report(compare([ds], budget=6, seeds=(0,)))
    assert "date" not in text and "wall" not in text


def test_compare_runs_exhaustive_once_per_dataset():
    report = compare([quadratic_dataset()], budget=6, seeds=(0, 1, 2))
    by_name = {s["strategy"]: s for s in report["datasets"][0]["strategies"]}
    assert len(by_name["exhaustive"]["per_seed_final"]) == 1
    assert len(by_name["random"]["per_seed_final"]) == 3


def test_history_from_dataset_filters_to_shard():
    ds = quadratic_dataset()
    assert len(history_from_dataset(ds)) == 12
    total = 0
    for i in range(3):
        shard = ds.space().shard(i, 3)
        hist = history_from_dataset(ds, shard)
        assert all(shard.is_valid(e.config) for e in hist)
        total += len(hist)
    assert total == 12


# -------------------------------------------------- sandbox-verdict replay

def faulted_dataset() -> SpaceDataset:
    """quadratic_dataset with every x == 0 config recorded as a sandbox
    crash (the way a SandboxedEvaluator's ``record_to`` persists one)."""
    s = small_space()
    ds = SpaceDataset("quadfault", s, (8, 8), "float32", "gpu-h100")
    for cfg in s.enumerate():
        if cfg["x"] == 0:
            ds.add(cfg, float("inf"), "infeasible",
                   error="sandbox:crash: injected evaluator fault",
                   verdict="crash")
        else:
            ds.add(cfg, (cfg["x"] - 2) ** 2 + (cfg["y"] - 1) ** 2 + 1.0,
                   "ok")
    return ds


def test_dataset_verdict_field_roundtrips_and_stays_compact():
    doc = json.loads(json.dumps(faulted_dataset().to_doc()))
    assert doc["version"] == DATASET_VERSION
    again = SpaceDataset.from_doc(doc)
    assert again.lookup({"x": 0, "y": 1}).verdict == "crash"
    ok_entry = again.lookup({"x": 2, "y": 1})
    assert ok_entry.verdict == "" and "verdict" not in ok_entry.to_json()


def test_simulated_runner_replays_sandbox_verdicts_and_counts_waste():
    sim = SimulatedRunner(faulted_dataset())
    first = sim({"x": 0, "y": 0})
    assert not first.feasible and first.error.startswith("sandbox:crash")
    assert first.info["sandbox"] == "crash"
    sim({"x": 0, "y": 1})
    assert sim.wasted_evals == 0
    sim({"x": 0, "y": 0})
    assert sim.wasted_evals == 1 and sim.verdicts == {"crash": 3}


def test_compare_report_v2_carries_verdict_counters():
    ds = faulted_dataset()
    report = compare([ds], strategies=["exhaustive"], budget=12, seeds=(0,))
    out = report["datasets"][0]["strategies"][0]
    assert report["version"] == 2
    assert out["verdicts"] == {"crash": 3} and out["wasted_evals"] == 0


# --------------------------------------------------------------------- CLI

def test_cli_record_run_compare_report(tmp_path, capsys):
    from repro_torch.tunebench.cli import main
    out_dir = tmp_path / "datasets"
    assert main(["record", "--kernel", "matmul", "--problem", "128,128,128",
                 "--dtype", "float32", "--out", str(out_dir)]) == 0
    files = list(out_dir.glob("*.space.json"))
    assert [f.name for f in files] == [
        "matmul--gpu-h100--128x128x128--float32.space.json"]
    capsys.readouterr()
    assert main(["run", "--dataset", str(files[0]), "--strategy", "bayes",
                 "--budget", "16", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["evals"] == 16 and payload["best_score_us"] is not None
    report_path = tmp_path / "report.json"
    assert main(["compare", "--datasets", str(out_dir / "*.space.json"),
                 "--budget", "16", "--seeds", "0,1",
                 "--out", str(report_path), "--check"]) == 0
    assert json.loads(report_path.read_text())["budget"] == 16
    assert main(["report", str(report_path), "--check"]) == 0
    again = tmp_path / "report2.json"
    assert main(["compare", "--datasets", str(out_dir / "*.space.json"),
                 "--budget", "16", "--seeds", "0,1", "--out", str(again)]) == 0
    assert report_path.read_bytes() == again.read_bytes()


def test_cli_record_wallclock_on_the_requested_device(tmp_path, capsys):
    from repro_torch.tunebench.cli import main
    out = tmp_path / "mm.space.json"
    assert main(["record", "--kernel", "matmul", "--problem", "32,32,64",
                 "--objective", "wallclock", "--device", "cpu",
                 "--limit", "4", "--out", str(out)]) == 0
    ds = SpaceDataset.load(out)
    assert (ds.device_kind, ds.objective, len(ds)) == ("cpu", "wallclock", 4)
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["record", "--kernel", "matmul", "--problem", "32,32,64",
                  "--objective", "wallclock", "--out", str(out)])


def test_cli_compare_check_fails_below_threshold(tmp_path):
    from repro_torch.tunebench.cli import main
    empty = SpaceDataset("empty", small_space(), (8, 8), "float32",
                         "gpu-h100")
    for cfg in small_space().enumerate():
        empty.add(cfg, float("inf"), "infeasible", error="nope")
    p1 = quadratic_dataset().save(tmp_path / "quad.space.json")
    p2 = empty.save(tmp_path / "empty.space.json")
    assert main(["compare", "--datasets", str(p1), "--budget", "12",
                 "--seeds", "0", "--check"]) == 0
    assert main(["compare", "--datasets", str(p2), "--budget", "12",
                 "--seeds", "0", "--check"]) == 1


def test_tune_cli_records_a_dataset_from_a_capture(tmp_path, capsys):
    """``python -m repro_torch.tuner.tune --record-dataset``: a captured
    launch tuned on the host's plain versions, every evaluation in the
    scenario's dataset file beside the winner's wisdom record."""
    from repro_torch.core import write_capture
    from repro_torch.tuner.tune import main
    b = get_kernel("matmul")
    write_capture("matmul", (32, 32, 64), "float32",
                  b.make_probe_args((32, 32, 64), "float32"),
                  out_dir=tmp_path / "caps")
    assert main(["--captures", str(tmp_path / "caps" / "*.capture.json"),
                 "--device", "cpu", "--strategy", "random",
                 "--budget-evals", "5", "--wisdom-dir", str(tmp_path / "w"),
                 "--record-dataset", str(tmp_path / "ds")]) == 0
    ds = DatasetStore(tmp_path / "ds").load_for("matmul", "cpu",
                                                (32, 32, 64), "float32")
    assert len(ds) == 5 and ds.objective == "wallclock"
    assert all(e.feasible for e in ds.evaluations.values())
    assert "1 scenario(s) from 1 capture(s)" in capsys.readouterr().out
