"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``: the same metric and span sequences give byte-identical
snapshot and trace JSON and the same health report in both packages, and
the port's launch path and serving engine report the reference's series.

Counterparts of ``tests/test_obs.py``, but for the tests that need the
fleet or sync layers, which are not ported (``--bus`` raises instead).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as ro
from repro.core import Wisdom as RefWisdom
from repro.core import scenario as ref_scenario

import repro_torch.obs as po
from repro_torch.core import (Wisdom, WisdomKernel, WisdomRecord,
                              get_kernel, make_provenance)
from repro_torch.core import scenario
from repro_torch.obs.metrics import UNIT_BUCKETS
from repro_torch.obs import (COUNT_BUCKETS, DEFAULT_BUCKETS_US,
                             MetricsRegistry, Tracer, load_snapshot,
                             load_trace, merge_snapshots, parse_series,
                             render_report, runtime, save_snapshot,
                             scenario_health, series_key, snapshot_bytes,
                             snapshot_from_trace, validate_trace)

SRC = str(Path(__file__).resolve().parents[1] / "src")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with observability disabled in both
    packages."""
    runtime.disable()
    ro.runtime.disable()
    yield
    runtime.disable()
    ro.runtime.disable()


# ------------------------------ metrics --------------------------------------

def test_series_key_roundtrip():
    key = series_key("select.tier", {"kernel": "matmul", "tier": "exact"})
    assert key == "select.tier{kernel=matmul,tier=exact}"
    assert key == ro.series_key("select.tier",
                                {"kernel": "matmul", "tier": "exact"})
    assert parse_series(key) == ("select.tier",
                                 {"kernel": "matmul", "tier": "exact"})
    assert parse_series("launch.count") == ("launch.count", {})
    with pytest.raises(ValueError):
        series_key("bad{name", {})
    with pytest.raises(ValueError):
        series_key("n", {"k": "a,b"})


def _populate(reg) -> None:
    reg.counter("launch.count", kernel="matmul").inc(7)
    reg.gauge("serve.queue_depth").set(3)
    h = reg.histogram("launch.latency_us", kernel="matmul")
    for v in (0.5, 3.0, 999.0, 2_000_000.0):
        h.observe(v)
    reg.histogram("serve.cohort_size", COUNT_BUCKETS).observe(3)
    reg.counter("select.tier", kernel="advec_u",
                scenario="gpu-h100|512x512x512|float32",
                tier="device+dtype").inc(0.25)


def _populated_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    _populate(reg)
    return reg


def test_snapshot_save_load_roundtrip(tmp_path):
    reg = _populated_registry()
    snap = reg.snapshot()
    p = save_snapshot(snap, tmp_path / "s.json")
    loaded = load_snapshot(p)
    assert loaded == snap
    assert snapshot_bytes(loaded) == p.read_bytes()
    h = snap["histograms"]["launch.latency_us{kernel=matmul}"]
    assert h["bounds"] == list(DEFAULT_BUCKETS_US)
    assert sum(h["counts"]) == h["count"] == 4
    assert h["counts"][-1] == 1                 # +Inf bucket got 2e6


def test_snapshot_bytes_match_the_reference(tmp_path):
    """The same metric sequence gives the same snapshot bytes in both
    packages, and each package loads the other's file."""
    ref = ro.MetricsRegistry()
    _populate(ref)
    port = _populated_registry()
    assert snapshot_bytes(port.snapshot()) == ro.snapshot_bytes(
        ref.snapshot())
    p = save_snapshot(port.snapshot(), tmp_path / "port.json")
    assert ro.load_snapshot(p) == ref.snapshot()
    merged = merge_snapshots([port.snapshot(), port.snapshot()])
    assert snapshot_bytes(merged) == ro.snapshot_bytes(
        ro.merge_snapshots([ref.snapshot(), ref.snapshot()]))


def test_load_snapshot_rejects_future_version(tmp_path):
    p = tmp_path / "v.json"
    p.write_text(json.dumps({"version": 99, "counters": {}}))
    with pytest.raises(ValueError, match="version 99"):
        load_snapshot(p)
    (tmp_path / "junk.json").write_text("[1,2]")
    with pytest.raises(ValueError):
        load_snapshot(tmp_path / "junk.json")


def test_histogram_bucketing_deterministic_across_processes():
    """Same observations in another interpreter, and in the reference's
    registry -> byte-identical snapshot (fixed declared bounds, no
    data-dependent bucketing)."""
    values = [0.9, 1.0, 1.1, 47.0, 999.999, 1e7, 0.0]
    reg = MetricsRegistry()
    ref = ro.MetricsRegistry()
    for v in values:
        reg.histogram("launch.latency_us", kernel="k").observe(v)
        ref.histogram("launch.latency_us", kernel="k").observe(v)
    here = snapshot_bytes(reg.snapshot())
    assert here == ro.snapshot_bytes(ref.snapshot())

    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from repro_torch.obs import MetricsRegistry, snapshot_bytes\n"
        "reg = MetricsRegistry()\n"
        f"for v in {values!r}:\n"
        "    reg.histogram('launch.latency_us', kernel='k').observe(v)\n"
        "sys.stdout.buffer.write(snapshot_bytes(reg.snapshot()))\n")
    out = subprocess.run([sys.executable, "-c", script, SRC],
                         capture_output=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout == here


def test_histogram_redeclare_with_other_bounds_raises():
    reg = MetricsRegistry()
    reg.histogram("h", COUNT_BUCKETS, kernel="k")
    with pytest.raises(ValueError, match="different bounds"):
        reg.histogram("h", DEFAULT_BUCKETS_US, kernel="k")
    with pytest.raises(ValueError):
        reg.histogram("h2", bounds=(3.0, 1.0))   # not ascending


def test_merge_snapshots_semantics():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("launch.count").inc(2)
    b.counter("launch.count").inc(5)
    a.gauge("serve.queue_depth").set(3)
    b.gauge("serve.queue_depth").set(9)
    a.histogram("h", COUNT_BUCKETS).observe(1)
    b.histogram("h", COUNT_BUCKETS).observe(300)
    merged = merge_snapshots([a.snapshot(), b.snapshot()])
    assert merged["counters"]["launch.count"] == 7       # sum
    assert merged["gauges"]["serve.queue_depth"] == 9    # max
    h = merged["histograms"]["h"]
    assert h["count"] == 2 and h["counts"][0] == 1 and h["counts"][-1] == 1

    c = MetricsRegistry()
    c.histogram("h", DEFAULT_BUCKETS_US).observe(1)
    with pytest.raises(ValueError, match="bounds differ"):
        merge_snapshots([a.snapshot(), c.snapshot()])


# ------------------------------- tracing -------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _scripted_trace(tracer_cls=Tracer):
    tr = tracer_cls(clock=_FakeClock())
    with tr.span("launch", cat="kernel", kernel="matmul", tier="exact",
                 scenario="gpu-h100|8x8|float32"):
        tr.instant("online.promoted", cat="online", kernel="matmul")
    with tr.span("serve.cohort", cat="serve", size=2):
        pass
    tr.counter("prof.matmul", cat="prof", roofline_fraction=0.5)
    return tr


def test_trace_chrome_schema_valid_and_deterministic(tmp_path):
    t1, t2 = _scripted_trace(), _scripted_trace()
    assert validate_trace(t1.to_chrome()) == []
    p = t1.save(tmp_path / "t.json")
    doc = load_trace(p)
    assert doc == t1.to_chrome()
    assert len(t1) == 4
    # injectable clock => byte-determinism across tracer instances
    assert json.dumps(t1.to_chrome(), sort_keys=True) == \
        json.dumps(t2.to_chrome(), sort_keys=True)
    ph = [ev["ph"] for ev in doc["traceEvents"]]
    assert ph == ["i", "X", "X", "C"]        # instant inside the first span


def test_trace_bytes_match_the_reference(tmp_path):
    """The same span sequence under the same injected clock saves the
    same trace file in both packages; each validates the other's."""
    port = _scripted_trace().save(tmp_path / "port.json")
    ref = _scripted_trace(ro.Tracer).save(tmp_path / "ref.json")
    assert port.read_bytes() == ref.read_bytes()
    assert ro.load_trace(port) == load_trace(ref)


def test_validate_trace_rejects_bad(tmp_path):
    assert validate_trace([]) != []
    assert validate_trace({"traceEvents": [{"name": "x"}]}) != []
    bad = {"traceEvents": [{"name": "x", "cat": "c", "ph": "X", "ts": 0,
                            "pid": 1, "tid": 0, "dur": -5}]}
    assert any("negative" in e for e in validate_trace(bad))
    assert validate_trace(bad) == ro.validate_trace(bad)
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="not a valid Chrome trace"):
        load_trace(p)


# --------------------------- runtime switch ----------------------------------

def test_disabled_mode_is_noop_and_enable_is_idempotent():
    assert runtime.metrics() is None and runtime.tracer() is None
    assert not runtime.enabled()
    reg, tr = runtime.enable()
    reg2, tr2 = runtime.enable()
    assert reg is reg2 and tr is tr2         # counters survive re-enable
    assert runtime.metrics() is reg
    runtime.disable()
    assert runtime.metrics() is None


def test_launch_instrumentation_and_always_on_tier_tally(wisdom_dir):
    """Disabled: a launch leaves no registry but still tallies tiers on
    the kernel. Enabled: the same launch produces the reference's
    select.tier / launch.count / compile.cache series and one launch span
    with the reference's args keys, which both packages accept and reduce
    to the same snapshot."""
    a = torch.ones((64, 64))
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    k(a, a)
    assert k.tier_counts == {"default": 1} and k.last_tier == "default"
    assert runtime.metrics() is None         # stayed disabled

    reg, tr = runtime.enable()
    k(a, a)
    assert k.tier_counts["default"] == 2
    snap = reg.snapshot()
    tier_keys = [s for s in snap["counters"] if s.startswith("select.tier")]
    assert tier_keys == ["select.tier{kernel=matmul,"
                         "scenario=gpu-h100|64x64x64|float32,tier=default}"]
    assert snap["counters"]["launch.count{kernel=matmul}"] == 1
    assert snap["counters"]["compile.cache{kernel=matmul,outcome=hit}"] == 1
    assert snap["histograms"]["launch.latency_us{kernel=matmul}"][
        "count"] == 1
    launches = [ev for ev in tr.events if ev["name"] == "launch"]
    assert len(launches) == 1
    args = launches[0]["args"]
    assert args["tier"] == "default"
    assert {"kernel", "tier", "scenario", "cached", "compile_us",
            "launch_us"} <= set(args)
    doc = tr.to_chrome()
    assert validate_trace(doc) == [] and ro.validate_trace(doc) == []
    assert snapshot_bytes(snapshot_from_trace(doc)) == ro.snapshot_bytes(
        ro.snapshot_from_trace(doc))


def test_compile_miss_span_covers_build_and_load(wisdom_dir):
    """A cache miss counts compile.cache{outcome=miss} and observes
    compile.latency_us; the span's dur covers selection, build, load and
    launch."""
    reg, tr = runtime.enable()
    k = WisdomKernel(get_kernel("advec_u"), wisdom_dir=wisdom_dir,
                     device_kind="gpu-h100")
    args = get_kernel("advec_u").make_probe_args((8, 8, 8), "float32")
    k(*args)
    snap = reg.snapshot()
    assert snap["counters"]["compile.cache{kernel=advec_u,outcome=miss}"] == 1
    assert snap["histograms"]["compile.latency_us{kernel=advec_u}"][
        "count"] == 1
    (ev,) = [e for e in tr.events if e["name"] == "launch"]
    st = k.stats[-1]
    total = (st.select_s + st.compile_s + st.load_s + st.launch_s) * 1e6
    assert ev["dur"] == pytest.approx(total, abs=1e-2)
    assert ev["args"]["cached"] is False


def test_wisdom_select_matches_reference_and_counts_index_hits(tmp_path):
    """``Wisdom.select`` returns the reference's (config, tier) on the same
    file, and select.index_hit counts hit / fallback / default as the
    reference does."""
    w = Wisdom("matmul")
    cfg = get_kernel("matmul").default_config() | {"split_k": 2}
    w.add(WisdomRecord(device_kind="gpu-h100", device_family="gpu-hopper",
                       problem_size=(512, 512, 1024), dtype="float32",
                       config=cfg, score_us=80.0,
                       provenance=make_provenance(strategy="bayes")))
    w.save(tmp_path)
    port, ref = Wisdom.load("matmul", tmp_path), RefWisdom.load("matmul",
                                                                tmp_path)
    reg, _ = runtime.enable()
    ref_reg, _ = ro.runtime.enable()
    default = {"block_m": 64}
    for problem, dtype in (((512, 512, 1024), "float32"),
                           ((256, 256, 256), "float32"),
                           ((256, 256, 256), "bfloat16")):
        got = port.select("gpu-h100", problem, dtype, default)
        assert got == ref.select("gpu-h100", problem, dtype, default)
    Wisdom("matmul").select("gpu-h100", (8, 8, 8), "float32", default)
    RefWisdom("matmul").select("gpu-h100", (8, 8, 8), "float32", default)
    hits = {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("select.index_hit")}
    assert hits == {k: v for k, v in ref_reg.snapshot()["counters"].items()
                    if k.startswith("select.index_hit")}
    assert hits == {"select.index_hit{kernel=matmul,outcome=hit}": 1,
                    "select.index_hit{kernel=matmul,outcome=fallback}": 2,
                    "select.index_hit{kernel=matmul,outcome=default}": 1}


def test_transfer_confidence_observed_on_selection(tmp_path):
    """A served transferred record observes its confidence."""
    w = Wisdom("matmul")
    w.add(WisdomRecord(device_kind="gpu-h100", device_family="gpu-hopper",
                       problem_size=(128, 128, 128), dtype="float32",
                       config=get_kernel("matmul").default_config(),
                       score_us=96.0,
                       provenance={"source": "transfer",
                                   "confidence": 0.72}))
    w.save(tmp_path)
    reg, _ = runtime.enable()
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=tmp_path,
                     device_kind="gpu-h100")
    k(torch.ones(32, 32), torch.ones(32, 32))
    assert k.last_tier == "transfer"
    h = reg.snapshot()["histograms"][
        "select.transfer_confidence{kernel=matmul}"]
    assert h["count"] == 1 and h["sum"] == 0.72


def test_single_source_of_tier_names():
    """core/scenario.py is the one definition: the health report reads the
    very same objects, and they equal the reference's."""
    from repro_torch.obs import report
    assert report.HIT_TIERS is scenario.HIT_TIERS
    assert report.MISS_TIERS is scenario.MISS_TIERS
    assert report.SELECT_TIERS is scenario.SELECT_TIERS
    assert scenario.SELECT_TIERS == ref_scenario.SELECT_TIERS
    assert scenario.MISS_TIERS == ref_scenario.MISS_TIERS
    assert scenario.HIT_TIERS == ref_scenario.HIT_TIERS
    assert scenario.SELECT_TIERS[0] == "exact"
    assert scenario.SELECT_TIERS[-1] == "default"
    assert scenario.MISS_TIERS == set(scenario.SELECT_TIERS) - {"exact"}
    key = ("gpu-h100", (256, 256), "float32")
    assert scenario.parse_key(scenario.format_key(key)) == key


# ------------------------------- report --------------------------------------

def _health(reg):
    sc = "gpu-h100|256x256x256|float32"
    for tier, n in (("exact", 8), ("device+dtype", 2)):
        reg.counter("select.tier", kernel="matmul", scenario=sc,
                    tier=tier).inc(n)
    reg.counter("select.tier", kernel="attn",
                scenario="gpu-h100|64x64|bfloat16", tier="default").inc(5)
    reg.counter("launch.count", kernel="matmul").inc(10)
    reg.counter("prof.launches", kernel="matmul", bottleneck="memory").inc(5)
    reg.histogram("prof.roofline_fraction", UNIT_BUCKETS,
                  kernel="matmul").observe(0.6)
    reg.histogram("select.transfer_confidence", UNIT_BUCKETS,
                  kernel="matmul").observe(0.72)
    return reg


def test_report_is_pure_and_names_scenarios():
    snap = _health(MetricsRegistry()).snapshot()
    r1, r2 = render_report(snap), render_report(snap)
    assert r1 == r2                           # same snapshot, same bytes
    assert "matmul gpu-h100|256x256x256|float32: hit-rate=0.80" in r1
    assert "attn gpu-h100|64x64|bfloat16: hit-rate=0.00" in r1
    assert "dominant-tier=default" in r1
    health = scenario_health(snap)
    assert [h.kernel for h in health] == ["attn", "matmul"]
    assert health[1].misses == 2 and health[1].launches == 10


def test_report_matches_the_reference():
    """One snapshot, one report: both packages render the same bytes."""
    snap = _health(MetricsRegistry()).snapshot()
    assert render_report(snap) == ro.render_report(snap)
    assert po.fleet_report([snap, snap]) == ro.fleet_report([snap, snap])


def test_snapshot_from_trace_matches_counters():
    tr = _scripted_trace()
    snap = snapshot_from_trace(tr.to_chrome())
    key = ("select.tier{kernel=matmul,scenario=gpu-h100|8x8|float32,"
           "tier=exact}")
    assert snap["counters"][key] == 1
    assert snap["histograms"]["launch.latency_us{kernel=matmul}"][
        "count"] == 1
    assert "hit-rate=1.00" in render_report(snap)


# ----------------------------- serve stats -----------------------------------

class _ToyModel:
    """Minimal decode-only model: next token = (tok + 1) mod vocab."""

    vocab = 13
    device = torch.device("cpu")

    def init_cache(self, n_slots, max_seq):
        return {"pos": torch.zeros((), dtype=torch.int64)}

    def decode_step(self, params, cache, tok):
        nxt = (tok[:, 0].long() + 1) % self.vocab
        logits = torch.nn.functional.one_hot(nxt, self.vocab).float()
        return logits[:, None], {"pos": cache["pos"] + 1}


class _ToyArenaModel(_ToyModel):
    decode_supports_start = True


def test_serve_run_returns_report_with_stats():
    from repro_torch.serve import Request, ServeEngine, ServeReport
    eng = ServeEngine(_ToyModel(), params={}, n_slots=2, max_seq=16)
    for rid in range(4):                      # 4 requests, 2 slots
        eng.submit(Request(rid, np.array([1, 2], np.int32),
                           max_new_tokens=3))
    reg, tr = runtime.enable()
    out = eng.run()
    assert isinstance(out, ServeReport)
    assert set(out) == {0, 1, 2, 3} and len(out) == 4
    assert out[0][0] == 3 and 2 in out
    assert out.cohorts == 2
    assert out.requests_completed == 4
    assert out.steps == eng.steps_run > 0
    assert out.to_json()["cohorts"] == 2
    snap = reg.snapshot()
    assert snap["counters"]["serve.decode_steps"] == out.steps
    assert snap["counters"]["serve.requests_completed"] == 4
    assert snap["histograms"]["serve.cohort_size"]["count"] == 2
    assert snap["histograms"]["batch.occupancy"]["count"] == out.steps
    assert [e["name"] for e in tr.events] == ["serve.cohort"] * 2


def test_serve_token_mode_traces_one_arena_span_per_generation():
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(_ToyArenaModel(), params={}, n_slots=2, max_seq=8)
    for rid in range(5):
        eng.submit(Request(rid, np.array([1, 2], np.int32),
                           max_new_tokens=3))
    reg, tr = runtime.enable()
    out = eng.run()
    assert out.mode == "token" and out.requests_completed == 5
    arenas = [e for e in tr.events if e["name"] == "serve.arena"]
    assert len(arenas) == out.cohorts > 1
    assert [e["args"]["generation"] for e in arenas] == list(
        range(out.cohorts))
    snap = reg.snapshot()
    assert snap["counters"]["serve.requests_completed"] == 5
    assert snap["counters"]["serve.decode_steps"] == out.steps
    assert "serve.queue_depth" in snap["gauges"]


# --------------------------------- CLI ---------------------------------------

def test_cli_report_snapshot_trace(tmp_path, capsys):
    from repro_torch.obs.cli import main
    snap_path = save_snapshot(_health(MetricsRegistry()).snapshot(),
                              tmp_path / "s.json")
    assert main(["report", str(snap_path)]) == 0
    first = capsys.readouterr().out
    assert main(["report", str(snap_path)]) == 0
    assert capsys.readouterr().out == first   # byte-deterministic
    assert "Tier breakdown (per kernel)" in first

    trace_path = _scripted_trace().save(tmp_path / "t.json")
    assert main(["trace", str(trace_path)]) == 0
    assert "valid Chrome trace: 4 event(s)" in capsys.readouterr().out

    merged = tmp_path / "merged.json"
    assert main(["snapshot", str(snap_path), str(snap_path),
                 "--out", str(merged)]) == 0
    doc = load_snapshot(merged)
    assert doc["counters"]["launch.count{kernel=matmul}"] == 20  # summed

    bad = tmp_path / "bad-trace.json"
    bad.write_text("{}")
    assert main(["trace", str(bad)]) == 1


def test_cli_bus_and_demo_fleet_raise_until_the_fleet_is_ported(tmp_path):
    from repro_torch.obs.cli import main
    with pytest.raises(NotImplementedError, match="item 13"):
        main(["report", "--bus", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 13"):
        main(["demo", "--fleet", "--device", "cpu",
              "--out", str(tmp_path / "d")])


def test_demo_on_cpu_covers_every_tier(tmp_path, capsys):
    from repro_torch.obs.cli import main
    assert main(["demo", "--device", "cpu", "--out",
                 str(tmp_path / "d")]) == 0
    out = capsys.readouterr().out
    for tier in ("exact=3", "transfer=4", "device=2", "default=3"):
        assert tier in out
    assert "mean=0.720" in out
    doc = load_trace(tmp_path / "d" / "trace.json")
    assert sum(e["name"] == "launch" for e in doc["traceEvents"]) == 12
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["demo", "--out", str(tmp_path / "e")])


@pytest.mark.parametrize("module", ["repro_torch.obs", "repro_torch.prof",
                                    "repro_torch.core.export"])
def test_importing_pulls_in_neither_jax_nor_repro(module):
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", script, SRC],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""
