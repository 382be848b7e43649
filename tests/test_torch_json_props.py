"""The port's on-disk JSON documents held to the reference's, byte for byte.

Hypothesis draws the fields of wisdom records, tuning-space datasets and
kernel profiles; each document is then built once per package from the
same fields. Both packages must write the same document
(``json.dumps(..., sort_keys=True)``), each must load the other's and write
it back unchanged, and the migrations of an old document (a v1 wisdom
file, a versionless dataset) must give the same result in both.
"""

from __future__ import annotations

import json

from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro.prof as rprof
import repro.tunebench as rtb
from repro.core import wisdom as rwisdom

import repro_torch.core as pc
import repro_torch.prof as pprof
import repro_torch.tunebench as ptb
from repro_torch.core import wisdom as pwisdom

DEVICES = [("tpu-v5e", "tpu-v5"), ("tpu-v4", "tpu-v4"), ("gpu-x", "gpu-x"),
           ("gpu-h100", "gpu-hopper"), ("cpu", "cpu")]
DTYPES = ["float32", "bfloat16", "float16"]
KEYS = ["block_m", "block_n", "unroll", "order", "semantics"]
#: Device specs both packages define (profiles compute their floors on
#: the spec, so the H100, which only the port has, is left out).
SHARED_SPECS = sorted(set(rc.DEVICES) & set(pc.DEVICES))


def canon(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True)


# ------------------------------------------------------------ wisdom

def record_fields(data) -> dict:
    device, family = data.draw(st.sampled_from(DEVICES))
    n_cfg = data.draw(st.integers(1, 4))
    prov_keys = data.draw(st.lists(st.sampled_from(
        ["strategy", "host", "user", "note", "objective"]),
        min_size=0, max_size=3, unique=True))
    provenance = {k: f"v-{data.draw(st.integers(0, 99))}" for k in prov_keys}
    provenance["evaluations"] = data.draw(st.integers(0, 10_000))
    return dict(
        device_kind=device, device_family=family,
        problem_size=tuple(data.draw(
            st.lists(st.integers(1, 8192), min_size=1, max_size=4))),
        dtype=data.draw(st.sampled_from(DTYPES)),
        config={KEYS[i]: data.draw(st.integers(1, 512))
                for i in range(n_cfg)},
        score_us=data.draw(st.floats(1e-3, 1e9)),
        provenance=provenance,
        lineage=[{"host": f"h{data.draw(st.integers(0, 9))}",
                  "date": f"2026-0{data.draw(st.integers(1, 7))}-01"}
                 for _ in range(data.draw(st.integers(0, 3)))])


def wisdom(pkg: str, fields: list[dict]):
    core = pc if pkg == "port" else rc
    w = core.Wisdom("propk")
    for f in fields:
        rec = core.WisdomRecord(**f | {
            "config": dict(f["config"]), "provenance": dict(f["provenance"]),
            "lineage": [dict(x) for x in f["lineage"]]})
        # a bulk load keeps every record, so documents hold collisions too
        w.add(rec, keep_best=False)
    return w


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_wisdom_documents_are_the_references_both_ways(data):
    fields = [record_fields(data) for _ in range(data.draw(st.integers(0,
                                                                       5)))]
    port, ref = wisdom("port", fields), wisdom("ref", fields)
    doc_p, doc_r = port.to_doc(), ref.to_doc()
    assert canon(doc_p) == canon(doc_r)
    assert doc_p["version"] == pc.WISDOM_VERSION == rc.WISDOM_VERSION
    assert canon(pwisdom.migrate_doc(doc_p)) == canon(doc_p)
    # each package reads the other's wire document and writes it back
    wire_r, wire_p = json.loads(json.dumps(doc_r)), json.loads(
        json.dumps(doc_p))
    back_p = pc.Wisdom("propk", [pc.WisdomRecord.from_json(r)
                                 for r in wire_r["records"]])
    back_r = rc.Wisdom("propk", [rc.WisdomRecord.from_json(r)
                                 for r in wire_p["records"]])
    assert canon(back_p.to_doc()) == canon(doc_r)
    assert canon(back_r.to_doc()) == canon(doc_p)
    assert [r.record_id() for r in back_p.records] == \
        [r.record_id() for r in ref.records]


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_v1_wisdom_migrates_as_the_reference_migrates_it(data):
    fields = [record_fields(data) for _ in range(data.draw(st.integers(0,
                                                                       4)))]
    records = []
    for f in fields:
        d = wisdom("port", [f]).records[0].to_json()
        del d["lineage"]
        records.append(d)
    v1 = {"kernel": "propk", "records": records}
    before = canon(v1)
    got, want = pwisdom.migrate_doc(v1), rwisdom.migrate_doc(v1)
    assert canon(got) == canon(want)
    assert got["version"] == pc.WISDOM_VERSION
    assert all(rec["lineage"] == [] for rec in got["records"])
    assert canon(pwisdom.migrate_doc(got)) == canon(got)
    assert canon(v1) == before          # the input was not mutated


# ----------------------------------------------------------- datasets

def dataset_fields(data) -> dict:
    params = []
    for i in range(data.draw(st.integers(1, 3))):
        values = sorted(data.draw(st.lists(st.integers(1, 64), min_size=1,
                                           max_size=4, unique=True)))
        params.append((KEYS[i], values))
    entries = []
    for _ in range(data.draw(st.integers(0, 6))):
        config = {name: data.draw(st.sampled_from(values))
                  for name, values in params}
        if data.draw(st.booleans()):
            entries.append((config, data.draw(st.floats(1e-3, 1e9)), "ok",
                            ""))
        else:
            entries.append((config, float("inf"), "infeasible", "vmem"))
    return dict(params=params, entries=entries,
                device=data.draw(st.sampled_from(DEVICES))[0],
                problem=tuple(data.draw(st.lists(st.integers(1, 1024),
                                                 min_size=1, max_size=3))),
                dtype=data.draw(st.sampled_from(DTYPES)),
                objective=data.draw(st.sampled_from(["costmodel",
                                                     "wallclock"])))


def dataset(pkg: str, f: dict):
    core, tb = (pc, ptb) if pkg == "port" else (rc, rtb)
    space = core.ConfigSpace()
    for name, values in f["params"]:
        space.tune(name, values, values[0])
    ds = tb.SpaceDataset("propk", space, f["problem"], f["dtype"],
                         f["device"], objective=f["objective"])
    for config, score, status, error in f["entries"]:
        ds.add(dict(config), score, status, error=error)
    return ds


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_dataset_documents_are_the_references_both_ways(data):
    f = dataset_fields(data)
    port, ref = dataset("port", f), dataset("ref", f)
    doc_p, doc_r = port.to_doc(), ref.to_doc()
    assert canon(doc_p) == canon(doc_r)
    assert canon(ptb.migrate_dataset_doc(doc_p)) == canon(doc_p)
    back_p = ptb.SpaceDataset.from_doc(json.loads(json.dumps(doc_r)))
    back_r = rtb.SpaceDataset.from_doc(json.loads(json.dumps(doc_p)))
    assert canon(back_p.to_doc()) == canon(doc_r)
    assert canon(back_r.to_doc()) == canon(doc_p)
    assert sorted(back_p.evaluations) == sorted(ref.evaluations)
    b1, b2 = back_p.best(), ref.best()
    assert (b1 is None) == (b2 is None)
    if b1 is not None:
        assert (b1.config, b1.score_us) == (b2.config, b2.score_us)


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_versionless_dataset_migrates_as_the_reference_migrates_it(data):
    doc = dataset("port", dataset_fields(data)).to_doc()
    del doc["version"]
    before = canon(doc)
    got, want = ptb.migrate_dataset_doc(doc), rtb.migrate_dataset_doc(doc)
    assert canon(got) == canon(want)
    assert got["version"] == 1
    assert canon(ptb.migrate_dataset_doc(got)) == canon(got)
    assert canon(doc) == before


# ----------------------------------------------------------- profiles

def profile_fields(data) -> dict:
    n_cfg = data.draw(st.integers(0, 3))
    return dict(
        device=data.draw(st.sampled_from(SHARED_SPECS)),
        workload=dict(flops=data.draw(st.floats(1.0, 1e15)),
                      hbm_bytes=data.draw(st.floats(1.0, 1e12)),
                      vmem_bytes=data.draw(st.integers(0, 64 * 2**20)),
                      grid=data.draw(st.integers(1, 1 << 20))),
        dtype=data.draw(st.sampled_from(DTYPES)),
        latency_us=data.draw(st.floats(1e-3, 1e7)),
        kernel=data.draw(st.sampled_from(["matmul", "advec_u", "k"])),
        problem_size=tuple(data.draw(st.lists(st.integers(1, 8192),
                                              min_size=0, max_size=4))),
        config={KEYS[i]: data.draw(st.integers(1, 512))
                for i in range(n_cfg)},
        tier=data.draw(st.sampled_from(["", "exact", "trial", "serve"])),
        collective_bytes=data.draw(st.floats(0.0, 1e12)),
        baseline_us=(data.draw(st.floats(1e-3, 1e6))
                     if data.draw(st.booleans()) else None))


def profile(pkg: str, f: dict):
    core, prof = (pc, pprof) if pkg == "port" else (rc, rprof)
    return prof.profile_from_workload(
        core.Workload(**f["workload"]), core.DEVICES[f["device"]], f["dtype"],
        f["latency_us"], kernel=f["kernel"], problem_size=f["problem_size"],
        config=dict(f["config"]), tier=f["tier"],
        collective_bytes=f["collective_bytes"], baseline_us=f["baseline_us"])


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_profile_documents_are_the_references_both_ways(data):
    f = profile_fields(data)
    port, ref = profile("port", f), profile("ref", f)
    assert pprof.PROFILE_VERSION == rprof.PROFILE_VERSION
    assert port.bottleneck == ref.bottleneck
    assert port.bottleneck in pprof.BOTTLENECKS
    doc_p, doc_r = port.to_json(), ref.to_json()
    assert canon(doc_p) == canon(doc_r)
    back_p = pprof.KernelProfile.from_json(json.loads(json.dumps(doc_r)))
    back_r = rprof.KernelProfile.from_json(json.loads(json.dumps(doc_p)))
    assert canon(back_p.to_json()) == canon(doc_r)
    assert canon(back_r.to_json()) == canon(doc_p)
    assert back_p.has_drift() == ref.has_drift()
    future = dict(doc_p, version=pprof.PROFILE_VERSION + 1)
    refused = []
    for cls, err in ((pprof.KernelProfile, pprof.ProfileVersionError),
                     (rprof.KernelProfile, rprof.ProfileVersionError)):
        try:
            cls.from_json(future)
        except err:
            refused.append(True)
    assert refused == [True, True]
