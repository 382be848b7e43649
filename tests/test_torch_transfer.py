"""Cross-device transfer (``repro_torch.transfer``) and the wisdom store and
merge it writes through (``repro_torch.distrib``), against the JAX
package's ``repro.transfer`` and ``repro.distrib``.

The device model is the reference's on every pair of kinds the reference
knows (rtol 1e-12). Onto and from ``gpu-h100``, whose
``program_overhead`` is 0 (not measured), the reference's formula takes
``log2(0)``; the port leaves such an axis out and says so in the result's
components. The held-out report on the capability path (a kernel neither
registry knows) and the store's files and merges are the reference's
bytes. A dataset recorded on the reference's TPU space does not fit the
port's Hopper-native builder of the same name, and transfer refuses it.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import pytest
import torch

import repro.core.device as ref_device
import repro.core.wisdom as ref_wisdom
import repro.distrib as ref_distrib
import repro.transfer as ref_transfer
import repro.tunebench as rtb
from repro.core.builder import KernelBuilder as RefKernelBuilder
from repro.core.workload import Workload as RefWorkload

from repro_torch.core import KernelBuilder, Workload, get_kernel
from repro_torch.core.registry import register, unregister
from repro_torch.core.scenario import MISS_TIERS
from repro_torch.core.wisdom import (TRANSFER_MIN_CONFIDENCE, WISDOM_VERSION,
                                     Wisdom, WisdomRecord, WisdomVersionError,
                                     make_transfer_provenance)
from repro_torch.distrib import (WisdomStore, better_record, merge_stores,
                                 merge_wisdom)
from repro_torch.transfer import (DeviceModel, holdout_report,
                                  transfer_scenario, transfer_store)
from repro_torch.transfer.cli import main as transfer_cli
from repro_torch.tunebench import DatasetStore, SpaceDataset, record_space

torch.set_num_threads(1)

KERNEL = "transfertestk"
PROBLEM = (512, 512)
DEFAULT = {"tile": 256, "unroll": 1}
DATASET_DIR = (Path(__file__).resolve().parent.parent / "benchmarks"
               / "datasets")
#: Every device kind the reference knows; the port holds the same specs.
REF_KINDS = sorted(ref_device.DEVICES)


def _test_kernel(builder_cls, workload_cls, name=KERNEL):
    """The reference test's kernel, declared in either package."""
    b = builder_cls(name, source="tests/test_torch_transfer.py")
    b.tune("tile", (256, 512, 1024, 2048, 4608), default=256)
    b.tune("unroll", (1, 2, 4), default=1)

    @b.workload
    def _wl(config, problem, dtype):
        n = 1
        for d in problem:
            n *= int(d)
        tile = config["tile"]
        # tile=4608 -> 85MB working set: beyond the 4x spill grace on
        # tpu-v5e (16MB VMEM), inside it on tpu-v4 (32MB)
        return workload_cls(flops=2.0 * n * config["unroll"],
                            hbm_bytes=4.0 * n * (1 + 256 / tile),
                            vmem_bytes=tile * tile * 4,
                            grid=max(n // tile, 1),
                            lane_extent=min(tile, 256),
                            unroll_ways=config["unroll"])

    return b


BUILDER = _test_kernel(KernelBuilder, Workload)
REF_BUILDER = _test_kernel(RefKernelBuilder, RefWorkload)


@pytest.fixture()
def registered():
    register(BUILDER)
    yield BUILDER
    unregister(KERNEL)


def _source(device="tpu-v5e"):
    return record_space(BUILDER, PROBLEM, "float32", device)


def measured(device="tpu-v4", family="tpu-v4", problem=PROBLEM,
             dtype="float32", score=100.0, config=None, cls=WisdomRecord):
    return cls(device_kind=device, device_family=family,
               problem_size=tuple(problem), dtype=dtype,
               config=config or {"tile": 256, "unroll": 1}, score_us=score,
               provenance={"strategy": "bayes", "evaluations": 20,
                           "objective": "costmodel",
                           "date": "2026-01-01T00:00:00+00:00"})


def transferred(device="tpu-v4", family="tpu-v4", problem=PROBLEM,
                dtype="float32", score=50.0, config=None, confidence=0.9):
    return WisdomRecord(device_kind=device, device_family=family,
                        problem_size=tuple(problem), dtype=dtype,
                        config=config or {"tile": 1024, "unroll": 2},
                        score_us=score,
                        provenance=make_transfer_provenance(
                            "tpu-v5e", 15, confidence, score))


# ------------------------------------------------------ capability model

def test_device_model_ratios_and_similarity():
    m = DeviceModel.between("tpu-v5e", "tpu-v4")
    assert m.vmem_ratio() == pytest.approx(2.0)
    assert m.compute_ratio("bfloat16") == pytest.approx(275e12 / 197e12)
    assert m.bandwidth_ratio() == pytest.approx(1228 / 819)
    assert DeviceModel.between("tpu-v5e", "tpu-v5e").similarity() == \
        pytest.approx(1.0)
    assert 0.3 < m.similarity() < 0.8
    assert DeviceModel.between("tpu-v5e", "cpu").similarity() < 0.01


def test_device_model_is_the_references_on_every_pair():
    """Ratios, blend ratio and similarity on every ordered pair of kinds
    the reference knows, within rtol 1e-12; no axis is left out there."""
    for src, tgt in itertools.product(REF_KINDS, repeat=2):
        mine = DeviceModel.between(src, tgt)
        theirs = ref_transfer.DeviceModel.between(src, tgt)
        assert mine.unmeasured_axes() == ()
        got, want = mine.ratios(), theirs.ratios()
        assert list(got) == list(want)
        for axis in want:
            assert got[axis] == pytest.approx(want[axis], rel=1e-12)
        assert mine.similarity() == pytest.approx(theirs.similarity(),
                                                  rel=1e-12)
        for dtype in ("float32", "bfloat16"):
            assert mine.blend_ratio(dtype) == pytest.approx(
                theirs.blend_ratio(dtype), rel=1e-12)


@pytest.mark.parametrize("src,tgt", [("gpu-a100", "gpu-h100"),
                                     ("gpu-h100", "gpu-a100"),
                                     ("gpu-a4000", "gpu-h100"),
                                     ("gpu-h100", "gpu-a4000")])
def test_similarity_with_the_h100_is_finite(src, tgt):
    """The repair: program_overhead is 0 on gpu-h100, so it leaves the
    RMS; what stays is finite, in (0, 1], the same both ways, and far
    below a sibling pair's (the vmem axis is L2 on Ampere and a block's
    shared memory on Hopper)."""
    m = DeviceModel.between(src, tgt)
    sim = m.similarity()
    assert math.isfinite(sim) and 0.0 < sim <= 1.0
    assert m.unmeasured_axes() == ("program_overhead",)
    assert "program_overhead" not in m.ratios() and len(m.ratios()) == 4
    assert sim == pytest.approx(DeviceModel.between(tgt, src).similarity(),
                                rel=1e-12)
    assert sim < 0.05


def test_similarity_of_every_kind_with_the_h100_is_finite():
    for kind in REF_KINDS:
        for pair in ((kind, "gpu-h100"), ("gpu-h100", kind)):
            sim = DeviceModel.between(*pair).similarity()
            assert math.isfinite(sim) and 0.0 < sim <= 1.0, pair


def test_unmeasured_axis_is_named_only_when_left_out(registered):
    """The components carry ``unmeasured_axes`` onto the H100 and nowhere
    else, so every reference pair's JSON is unchanged."""
    onto = transfer_scenario(_source("gpu-a100"), "gpu-h100")
    assert onto.components["unmeasured_axes"] == "program_overhead"
    assert onto.components["similarity"] == pytest.approx(
        DeviceModel.between("gpu-a100", "gpu-h100").similarity(), abs=1e-6)
    sibling = transfer_scenario(_source("tpu-v5e"), "tpu-v4")
    assert "unmeasured_axes" not in sibling.components


# ------------------------------------------------------------- predictor

def test_transfer_is_deterministic_and_vmem_aware(registered):
    ds = _source()
    r1, r2 = transfer_scenario(ds, "tpu-v4"), transfer_scenario(ds, "tpu-v4")
    assert json.dumps(r1.record().to_json(), sort_keys=True) == \
        json.dumps(r2.record().to_json(), sort_keys=True)
    assert r1.components["calibration"] == "workload"
    assert r1.components["transferable"] == len(ds.feasible())


def test_transfer_reverse_direction_drops_target_infeasible_configs(
        registered):
    ds = _source("tpu-v4")
    result = transfer_scenario(ds, "tpu-v5e")
    assert result.components["transferable"] < len(ds.feasible())
    assert all(p.config["tile"] < 4608 for p in result.predictions)


def test_transfer_refuses_same_device_and_tiny_datasets(registered):
    with pytest.raises(ValueError, match="already recorded"):
        transfer_scenario(_source(), "tpu-v5e")
    tiny = record_space(BUILDER, PROBLEM, "float32", "tpu-v5e", limit=2)
    with pytest.raises(ValueError, match="at least 3"):
        transfer_scenario(tiny, "tpu-v4")


def test_confidence_gates_by_device_similarity(registered):
    ds = _source()
    sibling, alien = transfer_scenario(ds, "tpu-v4"), transfer_scenario(
        ds, "cpu")
    assert sibling.eligible() and not alien.eligible()
    assert alien.confidence < TRANSFER_MIN_CONFIDENCE <= sibling.confidence
    rec = sibling.record()
    assert rec.is_transferred() and rec.device_kind == "tpu-v4"
    assert rec.transfer_confidence() == sibling.confidence
    assert rec.provenance["source_device"] == "tpu-v5e"
    assert rec.provenance["predicted_us"] == rec.score_us
    assert rec.provenance["torch_version"] == torch.__version__


def test_capability_only_transfer_gated_when_target_vmem_shrinks():
    """No registry knows the kernel: the capability path, penalised, and
    gated where the target's on-chip memory shrinks."""
    grow = transfer_scenario(_source("tpu-v5e"), "tpu-v4")
    shrink = transfer_scenario(_source("tpu-v4"), "tpu-v5e")
    assert grow.components["calibration"] == "capability"
    assert grow.eligible()
    assert shrink.components["calibration"] == "capability"
    assert not shrink.eligible()


def test_transfer_store_discovers_and_skips_target(tmp_path, registered):
    store = DatasetStore(tmp_path)
    store.save(_source("tpu-v5e"))
    store.save(_source("tpu-v4"))
    results = transfer_store(store, "tpu-v4")
    assert [r.source_device for r in results] == ["tpu-v5e"]


def test_tpu_space_dataset_does_not_fit_the_hopper_builder():
    """The shipped gpu-a100 matmul space was recorded on the reference's
    TPU parameter table; the port's matmul builder tunes another, so the
    transfer refuses it, naming both, and transfer_store skips it."""
    path = DATASET_DIR / "matmul--gpu-a100--256x256x256--float32.space.json"
    ds = SpaceDataset.load(path)
    with pytest.raises(ValueError) as err:
        transfer_scenario(ds, "gpu-h100")
    msg = str(err.value)
    assert "'matmul'" in msg and "block_m" in msg and "stages" in msg
    assert "dim_semantics" in msg or "block_k" in msg
    store = DatasetStore(DATASET_DIR)
    assert transfer_store(store, "gpu-h100", kernel="matmul") == []


def test_transfer_onto_the_h100_on_the_ports_matmul_space():
    """The port's own space recorded by the cost model on the A100, onto
    the H100: every config calibrated by the workload hook, the similarity
    near 0.02, confidence under the serving gate."""
    ds = record_space(get_kernel("matmul"), (512, 512, 1024), "float32",
                      "gpu-a100")
    r = transfer_scenario(ds, "gpu-h100")
    assert r.components["calibration"] == "workload"
    assert r.components["transferable"] == len(ds.feasible()) == 216
    assert 0.015 < r.components["similarity"] < 0.025
    assert not r.eligible() and r.confidence < TRANSFER_MIN_CONFIDENCE


# --------------------------------------------------- selection and merge

def test_transferred_never_shadows_exact_measurement():
    w = Wisdom(KERNEL)
    w.add(measured(score=100.0, config={"tile": 512, "unroll": 1}))
    w.add(transferred(score=1.0, confidence=0.99,
                      config={"tile": 1024, "unroll": 4}))
    cfg, tier = w.select("tpu-v4", PROBLEM, "float32", DEFAULT)
    assert (tier, cfg["tile"]) == ("exact", 512)


def test_transfer_tier_sits_between_exact_and_fallback():
    w = Wisdom(KERNEL)
    w.add(measured(problem=(128, 128), config={"tile": 256, "unroll": 2}))
    w.add(measured(device="tpu-v5e", family="tpu-v5",
                   config={"tile": 256, "unroll": 4}))
    w.add(transferred(config={"tile": 1024, "unroll": 2}))
    assert w.select("tpu-v4", PROBLEM, "float32", DEFAULT)[1] == "transfer"
    cold = Wisdom(KERNEL, [r for r in w.records if not r.is_transferred()])
    assert cold.select("tpu-v4", PROBLEM, "float32", DEFAULT)[1] == \
        "device+dtype"


def test_low_confidence_transfer_is_ignored_and_tier_is_a_miss():
    w = Wisdom(KERNEL)
    w.add(measured(problem=(128, 128), config={"tile": 512, "unroll": 1}))
    w.add(transferred(confidence=TRANSFER_MIN_CONFIDENCE - 0.01))
    assert w.select("tpu-v4", PROBLEM, "float32", DEFAULT)[1] == \
        "device+dtype"
    assert w.select("tpu-v4", PROBLEM, "float32", DEFAULT,
                    min_transfer_confidence=0.1)[1] == "transfer"
    only = Wisdom(KERNEL, [transferred(confidence=0.05)])
    assert only.select("tpu-v4", PROBLEM, "float32", DEFAULT) == (
        DEFAULT, "default")
    assert "transfer" in MISS_TIERS


def test_measured_beats_transferred_in_merge_and_add():
    t, m = transferred(score=1.0, confidence=0.99), measured(score=500.0)
    assert better_record(t, m) is m and better_record(m, t) is m
    w = Wisdom(KERNEL, [m])
    w.add(t)
    assert len(w) == 1 and not w.records[0].is_transferred()
    assert any(e.get("source") == "transfer" for e in w.records[0].lineage)
    merged = merge_wisdom(Wisdom(KERNEL, [transferred(score=10.0)]),
                          Wisdom(KERNEL, [measured(score=80.0)]))
    assert len(merged) == 1 and not merged.records[0].is_transferred()


# ------------------------------------------- the store and merge: parity

def _records(cls):
    """Same-scenario conflicts, a tie on score, another device, a second
    problem: deterministic provenance, so both packages build equal
    records."""
    out = []
    for i, (score, evals, dev, problem) in enumerate([
            (100.0, 10, "tpu-v5e", (256, 256)),
            (40.0, 5, "tpu-v5e", (256, 256)),
            (40.0, 50, "tpu-v5e", (256, 256)),
            (7.0, 3, "tpu-v4", (256, 256)),
            (9.0, 8, "tpu-v5e", (64, 64))]):
        out.append(cls(device_kind=dev, device_family=dev[:6],
                       problem_size=problem, dtype="float32",
                       config={"block": i}, score_us=score,
                       provenance={"strategy": "bayes", "evaluations": evals,
                                   "objective": "costmodel",
                                   "host": f"h{i}",
                                   "date": f"2026-01-0{i + 1}T00:00:00"}))
    return out


def test_store_files_and_merges_are_the_references(tmp_path):
    """Each record in its own store, merged into a destination in both
    packages: the same winners, lineage, report and file bytes."""
    mine, theirs = _records(WisdomRecord), _records(ref_wisdom.WisdomRecord)
    results = {}
    for tag, recs, wis, store_cls, merge in (
            ("port", mine, Wisdom, WisdomStore, merge_stores),
            ("ref", theirs, ref_wisdom.Wisdom, ref_distrib.WisdomStore,
             ref_distrib.merge_stores)):
        sources = []
        for i, r in enumerate(recs):
            s = store_cls(tmp_path / tag / f"s{i}")
            s.save(wis("k", [r]))
            sources.append(s)
        dest = store_cls(tmp_path / tag / "dest")
        report = merge(dest, *sources)
        results[tag] = (dest.path_for("k").read_bytes(), report.summary(),
                        report.conflicts, report.replaced)
    assert results["port"] == results["ref"]
    assert json.loads(results["port"][0])["version"] == WISDOM_VERSION


def test_merge_wisdom_is_the_references_in_any_order():
    mine, theirs = _records(WisdomRecord), _records(ref_wisdom.WisdomRecord)
    for order in ([0, 1, 2, 3, 4], [4, 3, 2, 1, 0], [2, 0, 4, 1, 3]):
        got = merge_wisdom(*[Wisdom("k", [mine[i]]) for i in order])
        want = ref_distrib.merge_wisdom(
            *[ref_wisdom.Wisdom("k", [theirs[i]]) for i in order])
        assert json.dumps(got.to_doc(), sort_keys=True) == \
            json.dumps(want.to_doc(), sort_keys=True)
    # equal scores: more evaluations win
    contested = [r for r in got.records if r.device_kind == "tpu-v5e"
                 and r.problem_size == (256, 256)]
    assert [r.config for r in contested] == [{"block": 2}]
    with pytest.raises(ValueError, match="different kernels"):
        merge_wisdom(Wisdom("k1", [mine[0]]), Wisdom("k2", [mine[1]]))


def test_store_upkeep_is_the_references(tmp_path):
    """prune and validate give the reference's reports and files."""
    out = {}
    for tag, recs, wis, store_cls in (
            ("port", _records(WisdomRecord), Wisdom, WisdomStore),
            ("ref", _records(ref_wisdom.WisdomRecord), ref_wisdom.Wisdom,
             ref_distrib.WisdomStore)):
        store = store_cls(tmp_path / tag)
        w = wis("k")
        for r in recs:
            w.add(r, keep_best=False)
        store.save(w)
        store.path_for("broken").write_text("{not json")
        issues = [(i.kernel, i.problem) for i in store.validate()]
        report = store.prune(kernel="k", device_kind="tpu-v5e")
        out[tag] = (issues, report.dropped, store.path_for("k").read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][1] == {"k": 3}


def test_store_refuses_a_future_version(tmp_path):
    store = WisdomStore(tmp_path)
    store.path_for("k").parent.mkdir(parents=True, exist_ok=True)
    store.path_for("k").write_text(json.dumps(
        {"kernel": "k", "version": WISDOM_VERSION + 1, "records": []}))
    with pytest.raises(WisdomVersionError):
        store.load("k")
    assert "version" in store.validate()[0].problem


# ------------------------------------------------------- held-out reports

def test_holdout_report_on_the_capability_path_is_the_references():
    """A kernel neither registry knows: both packages take the capability
    path, and the report is the same bytes (tiers, fractions, components)."""
    src, truth = _source("tpu-v4"), _source("tpu-v5e")
    ref_src = rtb.record_space(REF_BUILDER, PROBLEM, "float32", "tpu-v4")
    ref_truth = rtb.record_space(REF_BUILDER, PROBLEM, "float32", "tpu-v5e")
    mine = holdout_report(src, truth)
    theirs = ref_transfer.holdout_report(ref_src, ref_truth)
    assert mine["components"]["calibration"] == "capability"
    assert ref_transfer.dump_holdout_report(theirs) == \
        ref_transfer.dump_holdout_report(mine)


def test_holdout_report_deterministic_and_gated(registered):
    src, truth = _source("tpu-v4"), _source("tpu-v5e")
    r1, r2 = holdout_report(src, truth), holdout_report(src, truth)
    assert json.dumps(r1, sort_keys=True) == json.dumps(r2, sort_keys=True)
    assert r1["transfer"]["tier"] == "transfer"
    assert r1["fallback"]["tier"] in ("device+dtype", "device",
                                      "family+dtype", "family",
                                      "any+dtype", "any")
    assert r1["transfer"]["fraction"] >= 0.8


def test_a4000_to_a100_holdout_on_the_ports_matmul_space():
    """Both ends recorded by the cost model on the port's Hopper-native
    matmul space, on the host: the paper's pair, scored end to end."""
    b = get_kernel("matmul")
    src = record_space(b, (512, 512, 1024), "float32", "gpu-a4000")
    truth = record_space(b, (512, 512, 1024), "float32", "gpu-a100")
    r = holdout_report(src, truth)
    assert r["components"]["calibration"] == "workload"
    assert r["components"]["entries"] == 216
    assert 0.0 < r["transfer"]["fraction"] <= 1.0
    assert 0.0 < r["fallback"]["fraction"] <= 1.0
    assert r["transfer"]["tier"] == ("transfer" if r["confidence"] >=
                                     TRANSFER_MIN_CONFIDENCE else
                                     r["fallback"]["tier"])
    assert holdout_report(src, truth) == r


# ------------------------------------------------------------------- CLI

def test_cli_predict_score_export(tmp_path, capsys, registered):
    store = DatasetStore(tmp_path / "ds")
    store.save(_source("tpu-v5e"))
    store.save(_source("tpu-v4"))
    assert transfer_cli(["predict", "--dataset-dir", str(tmp_path / "ds"),
                         "--target", "tpu-v4", "--device", "cpu",
                         "--wisdom-dir", str(tmp_path / "w")]) == 0
    out = capsys.readouterr().out
    assert "tpu-v5e -> tpu-v4" in out and "merged 1 transferred" in out
    wisdom = WisdomStore(tmp_path / "w").load(KERNEL)
    assert len(wisdom) == 1 and wisdom.records[0].is_transferred()
    assert wisdom.records[0].oracle_verified() is None   # no plain version
    src = store.path_for(KERNEL, "tpu-v5e", PROBLEM, "float32")
    truth = store.path_for(KERNEL, "tpu-v4", PROBLEM, "float32")
    assert transfer_cli(["score", "--source", str(src), "--truth",
                         str(truth), "--json", "--check"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["transfer"]["tier"] == "transfer"
    out_path = tmp_path / "export.json"
    assert transfer_cli(["export", "--dataset-dir", str(tmp_path / "ds"),
                         "--target", "tpu-v4", "--no-verify",
                         "--out", str(out_path)]) == 0
    doc = json.loads(out_path.read_text())
    assert doc["kernel"] == KERNEL
    assert [r["provenance"]["source"] for r in doc["records"]] == ["transfer"]


def test_cli_predict_rejects_dissimilar_target(tmp_path, capsys, registered):
    store = DatasetStore(tmp_path / "ds")
    store.save(_source("tpu-v5e"))
    assert transfer_cli(["predict", "--dataset-dir", str(tmp_path / "ds"),
                         "--target", "cpu"]) == 2
    assert "SKIP" in capsys.readouterr().out


def test_cli_predict_onto_the_h100_checks_on_the_requested_device(tmp_path,
                                                                  capsys):
    """Predicting the port's matmul onto gpu-h100 with the gate lowered:
    the record's config passes the oracle on the host's plain version and
    merges beside a measured record; Wisdom.select serves it only below
    the default gate."""
    src = record_space(get_kernel("matmul"), (64, 64, 128), "float32",
                       "gpu-a100")
    path = src.save(tmp_path / "src.space.json")
    wdir = tmp_path / "w"
    assert transfer_cli(["predict", "--datasets", str(path), "--target",
                         "gpu-h100", "--wisdom-dir", str(wdir)]) == 2
    assert not WisdomStore(wdir).kernels()
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="--device cpu"):
            transfer_cli(["predict", "--datasets", str(path), "--target",
                          "gpu-h100", "--wisdom-dir", str(wdir),
                          "--min-confidence", "0"])
    assert transfer_cli(["predict", "--datasets", str(path), "--target",
                         "gpu-h100", "--wisdom-dir", str(wdir),
                         "--min-confidence", "0", "--device", "cpu"]) == 0
    rec = WisdomStore(wdir).load("matmul").records[0]
    assert rec.is_transferred() and rec.oracle_verified() is not None
    w = WisdomStore(wdir).load("matmul")
    default = get_kernel("matmul").default_config()
    assert w.select("gpu-h100", (64, 64, 128), "float32", default)[1] == \
        "default"
    assert w.select("gpu-h100", (64, 64, 128), "float32", default,
                    min_transfer_confidence=0.0)[1] == "transfer"
