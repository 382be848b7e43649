"""The port's wisdom sync (``repro_torch.distrib.sync``), its place in the
serving engine and the promotion pipeline, and the ``wisdom`` operator CLI
(``repro_torch.distrib.cli``), against the JAX package's ``repro.distrib``.

Counterparts of the sync and CLI cases of ``tests/test_distrib.py``. Each
case runs both packages on the same records (provenance made fixed, so the
documents can be compared byte for byte) and holds the port's stores,
transports, counters and CLI output to the reference's. CLI output differs
only in the program name and, where a record carries one, the version key
(``torch_version`` for ``jax_version``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.wisdom as ref_wisdom
import repro.distrib as ref_distrib
import repro.obs as ref_obs
from repro.distrib.cli import main as ref_cli

import repro_torch.core.wisdom as port_wisdom
import repro_torch.distrib as port_distrib
import repro_torch.obs as port_obs
from repro_torch.distrib.cli import main as port_cli

torch.set_num_threads(1)

#: One package's side of every case: its wisdom, distrib and CLI modules.
PACKAGES = {
    "ref": (ref_wisdom, ref_distrib, ref_cli),
    "port": (port_wisdom, port_distrib, port_cli),
}


@pytest.fixture(autouse=True)
def _obs_off():
    port_obs.runtime.disable()
    ref_obs.runtime.disable()
    yield
    port_obs.runtime.disable()
    ref_obs.runtime.disable()


def rec(wis, device="tpu-v5e", family="tpu-v5", problem=(256, 256),
        dtype="float32", score=100.0, config=None, host="hostA",
        strategy="bayes", evals=10, date="2026-01-01T00:00:00+00:00"):
    """A record of package ``wis`` with fixed provenance (no clock, no
    framework version), so both packages write the same bytes."""
    prov = {"date": date, "host": host, "user": "u", "platform": "p",
            "strategy": strategy, "evaluations": evals,
            "objective": "costmodel"}
    return wis.WisdomRecord(device_kind=device, device_family=family,
                            problem_size=tuple(problem), dtype=dtype,
                            config=config or {"block": 1},
                            score_us=score, provenance=prov)


def store_with(dist, wis, path, *records, kernel="k"):
    store = dist.WisdomStore(path)
    w = wis.Wisdom(kernel)
    for r in records:
        w.add(r, keep_best=False)
    store.save(w)
    return store


def tree_bytes(root: Path) -> dict[str, bytes]:
    """Every file under ``root`` (control documents included), by name."""
    if not root.is_dir():
        return {}
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if p.is_file()}


def both(tmp_path, case):
    """Run ``case(tmp_dir, wis, dist, cli)`` for each package and return
    {tag: result}."""
    return {tag: case(tmp_path / tag, *mods)
            for tag, mods in PACKAGES.items()}


# ----------------------------------- sync ------------------------------------

def test_push_broadcast_pull_round_trip(tmp_path):
    def case(d, wis, dist, _cli):
        local = store_with(dist, wis, d / "local",
                           rec(wis, score=10.0, config={"block": 1}))
        transport = dist.MemoryTransport()
        dist.PushSync(local, transport).push()
        assert transport.list_kernels() == ["k"]
        # a second host broadcasts a faster promotion for the scenario
        promoted = rec(wis, score=3.0, config={"block": 16}, host="hostB",
                       strategy="online", date="2026-01-02T00:00:00+00:00")
        dist.PushSync(dist.WisdomStore(d / "b"), transport).broadcast(
            "k", promoted)
        puller = store_with(dist, wis, d / "c",
                            rec(wis, score=8.0, config={"block": 2},
                                host="hostC"))
        report = dist.PullSync(puller, transport, interval=1).pull()
        got = puller.load("k").records[0]
        assert got.config == {"block": 16}
        assert {e.get("host") for e in got.lineage} >= {"hostB", "hostC"}
        return (tree_bytes(d / "c"), report.summary(),
                transport.publishes, transport.fetches)

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def test_pull_persists_lineage_only_changes(tmp_path):
    """Same winner on both sides, but the fleet copy carries lineage from
    other hosts: the pooled history is saved locally, not dropped."""
    def case(d, wis, dist, _cli):
        base = rec(wis, score=5.0, config={"block": 1}, host="h1")
        local = store_with(dist, wis, d / "l", base)
        transport = dist.MemoryTransport()
        remote = dataclasses.replace(
            base, lineage=[{"host": "h2",
                            "date": "2026-01-01T00:00:00+00:00"}])
        transport.publish("k", wis.Wisdom("k", [remote]).to_doc())
        dist.PullSync(local, transport, interval=1).pull()
        got = local.load("k").records[0]
        assert got.record_id() == base.record_id()
        assert any(e.get("host") == "h2" for e in got.lineage)
        return tree_bytes(d / "l")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def test_push_never_clobbers_better_remote(tmp_path):
    def case(d, wis, dist, _cli):
        transport = dist.MemoryTransport()
        fast = rec(wis, score=2.0, config={"block": 7}, host="fasthost")
        dist.PushSync(store_with(dist, wis, d / "fast", fast),
                      transport).push()
        slow = rec(wis, score=90.0, config={"block": 1}, host="slowhost")
        dist.PushSync(store_with(dist, wis, d / "slow", slow),
                      transport).push()
        remote = transport.fetch("k")
        assert len(remote["records"]) == 1
        assert remote["records"][0]["config"] == {"block": 7}
        return remote

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def test_directory_transport_equivalent_to_memory(tmp_path):
    def case(d, wis, dist, _cli):
        src = store_with(dist, wis, d / "src",
                         rec(wis, score=5.0, config={"block": 3}))
        shared = dist.DirectoryTransport(d / "shared")
        dist.PushSync(src, shared).push()
        dst = dist.WisdomStore(d / "dst")
        dist.PullSync(dst, shared, interval=1).pull()
        assert (json.dumps(dst.load("k").to_doc(), sort_keys=True)
                == json.dumps(src.load("k").to_doc(), sort_keys=True))
        memory = dist.MemoryTransport()
        dist.PushSync(src, memory).push()
        assert memory.fetch("k") == shared.fetch("k")
        # no temp file is left behind by the atomic publish
        assert [p.name for p in (d / "shared").iterdir()] == \
            ["k.wisdom.json"]
        return tree_bytes(d / "shared"), tree_bytes(d / "dst")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


class FakeKernel:
    def __init__(self, name):
        self.builder = type("B", (), {"name": name})()
        self.refreshes = 0

    def refresh_wisdom(self):
        self.refreshes += 1


def test_pull_tick_interval_and_kernel_refresh(tmp_path):
    def case(d, wis, dist, _cli):
        transport = dist.MemoryTransport()
        dist.PushSync(store_with(dist, wis, d / "src",
                                 rec(wis, config={"block": 5})),
                      transport).push()
        local = dist.WisdomStore(d / "local")
        kern, other = FakeKernel("k"), FakeKernel("other")
        sync = dist.PullSync(local, transport, kernels=[kern], interval=4)
        sync.attach(other)
        ticks = [sync.tick() is not None for _ in range(8)]
        assert sync.pulls == 2                      # ticks 0 and 4
        assert kern.refreshes == 1                  # only the changing pull
        assert other.refreshes == 0                 # its wisdom never moved
        assert len(local.load("k")) == 1
        with pytest.raises(ValueError, match="interval"):
            dist.PullSync(local, transport, interval=0)
        return ticks, tree_bytes(d / "local")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]
    assert out["port"][0] == [True, False, False, False] * 2


def _flaky(dist, fail_on: str):
    class FlakyTransport(dist.MemoryTransport):
        """Raises on fetches of one kernel until ``heal()`` — the
        shared-mount-hiccup simulator."""

        def __init__(self):
            super().__init__()
            self.failing = True

        def heal(self):
            self.failing = False

        def fetch(self, kernel_name):
            if self.failing and kernel_name == fail_on:
                raise OSError(
                    f"transport lost mid-pull fetching {kernel_name}")
            return super().fetch(kernel_name)

    return FlakyTransport()


def test_pull_is_transactional_on_transport_failure(tmp_path):
    """A transport dying mid-pull leaves the local store untouched: no
    kernel from earlier in the same pull is persisted."""
    def case(d, wis, dist, _cli):
        transport = _flaky(dist, "bbb")
        transport.publish("aaa", wis.Wisdom(
            "aaa", [rec(wis, config={"block": 2})]).to_doc())
        transport.publish("bbb", wis.Wisdom(
            "bbb", [rec(wis, config={"block": 3})]).to_doc())
        local = dist.WisdomStore(d / "local")
        sync = dist.PullSync(local, transport, interval=1)
        with pytest.raises(OSError):
            sync.pull()
        assert local.kernels() == []   # "aaa" fetched fine, still unsaved
        transport.heal()
        sync.pull()
        assert local.kernels() == ["aaa", "bbb"]
        return tree_bytes(d / "local")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def test_tick_swallows_transport_failure_and_recovers(tmp_path):
    """The serving-loop hook never lets a sync hiccup escape: failures are
    counted (``sync.failures``), the served wisdom stays, and the next due
    tick retries."""
    def case(d, wis, dist, _cli):
        obs = port_obs if dist is port_distrib else ref_obs
        reg, _ = obs.runtime.enable()
        transport = _flaky(dist, "k")
        local = dist.WisdomStore(d / "local")
        local.save(wis.Wisdom("k", [rec(wis, score=5.0,
                                        config={"block": 9})]))
        transport.publish("k", wis.Wisdom(
            "k", [rec(wis, score=1.0, config={"block": 4})]).to_doc())
        sync = dist.PullSync(local, transport, interval=2)
        assert sync.tick() is None               # due, but transport raised
        assert sync.failures == 1 and isinstance(sync.last_error, OSError)
        assert local.load("k").records[0].config == {"block": 9}
        assert sync.tick() is None               # off-interval: no attempt
        assert sync.failures == 1
        transport.heal()
        assert sync.tick() is not None           # due again: pull succeeds
        assert local.load("k").records[0].config == {"block": 4}
        counters = reg.snapshot()["counters"]
        obs.runtime.disable()
        return counters, tree_bytes(d / "local")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]
    counters = out["port"][0]
    assert counters["sync.failures{direction=pull}"] == 1
    assert counters["sync.ops{direction=pull}"] == 1
    assert counters["sync.kernels_changed"] == 1


# ------------------------------ serving engine -------------------------------

class _TinyLM:
    """Decode-only stand-in: zero logits, the cache passed through."""

    device = torch.device("cpu")

    def init_cache(self, n_slots, max_seq):
        return {"pos": torch.zeros((), dtype=torch.int64)}

    def decode_step(self, params, cache, tok):
        return torch.zeros((tok.shape[0], 1, 8)), cache


class _RefTinyLM:
    def init_cache(self, n_slots, max_seq):
        import jax.numpy as jnp
        return {"pos": jnp.zeros((), jnp.int32)}

    def decode_step(self, params, cache, tok):
        import jax.numpy as jnp
        return jnp.zeros((tok.shape[0], 1, 8), jnp.float32), cache


def _serve(dist, sync, n_requests=1):
    if dist is port_distrib:
        from repro_torch.serve.engine import Request, ServeEngine
        model = _TinyLM()
    else:
        from repro.serve.engine import Request, ServeEngine
        model = _RefTinyLM()
    eng = ServeEngine(model, params={}, n_slots=1, max_seq=16, sync=sync)
    for rid in range(n_requests):
        assert eng.submit(Request(rid, np.array([1, 2], np.int32),
                                  max_new_tokens=3))
    return eng, eng.run()


def test_serve_engine_survives_sync_failure_mid_pull(tmp_path):
    """The transport raising mid-pull does not kill the cohort, and the
    engine keeps serving from the wisdom it already had."""
    def case(d, wis, dist, _cli):
        transport = _flaky(dist, "bbb")
        transport.publish("aaa", wis.Wisdom(
            "aaa", [rec(wis, config={"block": 2})]).to_doc())
        transport.publish("bbb", wis.Wisdom(
            "bbb", [rec(wis, config={"block": 3})]).to_doc())
        local = dist.WisdomStore(d / "local")
        local.save(wis.Wisdom("aaa", [rec(wis, score=1.0,
                                          config={"block": 8})]))
        before = tree_bytes(d / "local")
        sync = dist.PullSync(local, transport, interval=2)
        eng, out = _serve(dist, sync)
        assert out[0] and eng.steps_run > 0       # serving completed
        assert sync.failures > 0
        assert out.sync_failures == sync.failures and out.sync_pulls == 0
        assert local.kernels() == ["aaa"]        # no partial state
        assert tree_bytes(d / "local") == before
        return out.to_json(), out[0]

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def test_serve_engine_ticks_sync(tmp_path):
    def case(d, wis, dist, _cli):
        obs = port_obs if dist is port_distrib else ref_obs
        transport = dist.MemoryTransport()
        dist.PushSync(store_with(dist, wis, d / "fleet",
                                 rec(wis, config={"block": 6})),
                      transport).push()
        local = dist.WisdomStore(d / "local")
        sync = dist.PullSync(local, transport, interval=2)
        reg, _ = obs.runtime.enable()
        eng, out = _serve(dist, sync, n_requests=2)
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith(("serve.sync_tick", "sync."))}
        obs.runtime.disable()
        assert eng.steps_run > 0
        assert sync.pulls == (eng.steps_run + 1) // 2 == out.sync_pulls
        assert local.load("k").records[0].config == {"block": 6}
        return out.to_json(), counters, tree_bytes(d / "local")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]
    report, counters, _ = out["port"]
    assert counters["serve.sync_tick{outcome=pulled}"] == \
        report["sync_pulls"] >= 1
    assert counters["serve.sync_tick{outcome=skipped}"] == \
        report["steps"] - report["sync_pulls"]
    assert report["sync_failures"] == 0


def test_serve_report_without_sync_reports_no_pulls():
    eng, out = _serve(port_distrib, None)
    assert out.sync_pulls == 0 and out.sync_failures == 0
    assert out.to_json()["sync_pulls"] == 0


# ------------------------------ promotion hook -------------------------------

HOST_FIELDS = ("date", "host", "user", "platform", "torch_version",
               "cuda_version", "jax_version")


def test_promotion_broadcast_hook(tmp_path):
    """A promotion publishes its record through ``PushSync.broadcast``:
    the transport then holds the same record in both packages (host and
    framework fields aside; the ports' configs are their own spaces')."""
    from repro.core import WisdomKernel as RefWisdomKernel
    from repro.core import get_kernel as ref_get_kernel
    from repro.online.promotion import PromotionPipeline as RefPipeline

    from repro_torch.core import WisdomKernel, get_kernel
    from repro_torch.online.promotion import PromotionPipeline

    def case(d, wis, dist, _cli):
        if dist is port_distrib:
            kernel = WisdomKernel(get_kernel("matmul"), wisdom_dir=d,
                                  device_kind="tpu-v5e")
            pipeline_cls = PromotionPipeline
        else:
            kernel = RefWisdomKernel(ref_get_kernel("matmul"), wisdom_dir=d,
                                     device_kind="tpu-v5e",
                                     backend="reference")
            pipeline_cls = RefPipeline
        transport = dist.MemoryTransport()
        push = dist.PushSync(dist.WisdomStore(d), transport)
        pipe = pipeline_cls(kernel, wisdom_dir=d, broadcast=push)
        promo = pipe.promote(
            device_kind="tpu-v5e", problem=(64, 64, 64), dtype="float32",
            config=dict(kernel.builder.default_config()), score_us=10.0,
            incumbent_score_us=100.0, n_measurements=3, evals=12,
            objective="costmodel")
        assert promo is not None and pipe.broadcasts == 1
        assert transport.publishes == 1
        remote, = transport.fetch("matmul")["records"]
        assert remote["config"] == promo.record.config
        for key in HOST_FIELDS + ("verified",):
            remote["provenance"].pop(key, None)
        remote.pop("config")
        return remote

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]
    assert out["port"]["score_us"] == 10.0


def test_tune_kernel_writes_through_store(tmp_path):
    from repro_torch.core import get_kernel
    from repro_torch.tuner.tune import tune_kernel

    store = port_distrib.WisdomStore(tmp_path / "w")
    res = tune_kernel(get_kernel("matmul"), (64, 64, 64), "float32",
                      "tpu-v5e", strategy="random", max_evals=4,
                      time_budget_s=None, objective="costmodel",
                      device="cpu", store=store)
    assert res.best_config is not None
    assert len(store.load("matmul")) == 1
    assert store.version_of("matmul") == port_wisdom.WISDOM_VERSION
    assert not (tmp_path / "wisdom-torch").exists()


# ------------------------------------ CLI ------------------------------------

def _cli_out(capsys, cli, argv) -> tuple[int, str]:
    rc = cli(argv)
    return rc, capsys.readouterr().out


def test_cli_merge_matches_library(tmp_path, capsys):
    """``wisdom merge`` writes what the library merge writes, and both
    packages write the same bytes and print the same line."""
    def case(d, wis, dist, cli):
        slow = rec(wis, score=100.0, config={"block": 1}, host="hostA")
        fast = rec(wis, score=40.0, config={"block": 8}, host="hostB")
        lib_a = store_with(dist, wis, d / "lib_a", slow)
        lib_b = store_with(dist, wis, d / "lib_b", fast)
        cli_a = store_with(dist, wis, d / "cli_a", slow)
        cli_b = store_with(dist, wis, d / "cli_b", fast)
        dist.merge_stores(lib_a, lib_b)
        rc, out = _cli_out(capsys, cli, ["merge", "--into", str(cli_a.root),
                                         str(cli_b.root)])
        assert rc == 0
        assert lib_a.path_for("k").read_text() == \
            cli_a.path_for("k").read_text()
        winner = cli_a.load("k").records[0]
        assert winner.config == {"block": 8}
        assert {e.get("host") for e in winner.lineage} == {"hostA", "hostB"}
        return cli_a.path_for("k").read_bytes(), out.replace(str(d), "D")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]


def _write_doc(path: Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2, sort_keys=True))


def _cli_store(dist, wis, d):
    """A store with a measured, a transferred and a v1 record."""
    store = store_with(dist, wis, d / "s",
                       rec(wis, score=7.0, config={"block": 2}),
                       rec(wis, device="tpu-v4", family="tpu-v4",
                           score=9.5, config={"block": 3}, host="hostB"))
    t = wis.Wisdom("t", [wis.WisdomRecord(
        device_kind="tpu-v4", device_family="tpu-v4", problem_size=(64,),
        dtype="float32", config={"tile": 8}, score_us=12.25,
        provenance={"source": "transfer", "source_device": "tpu-v5e",
                    "source_entries": 15, "confidence": 0.8125,
                    "predicted_us": 12.25, "predictor": "ridge+capability",
                    "round": 0})])
    store.save(t)
    v1 = rec(wis, problem=(32, 32), score=3.0).to_json()
    del v1["lineage"]
    _write_doc(store.path_for("old"),
               {"kernel": "old", "version": 1, "records": [v1]})
    return store


#: Each subcommand's argv (D = the case's directory), run in order on one
#: store per package; every step's exit code and stdout must agree.
CLI_STEPS = {
    "inspect": [["inspect", "--dir", "D/s"],
                ["inspect", "--dir", "D/s", "-v"],
                ["inspect", "--dir", "D/s", "t"],
                ["inspect", "--dir", "D/empty"]],
    "validate": [["validate", "--dir", "D/s"],
                 ["validate", "--dir", "D/future"]],
    "migrate": [["migrate", "--dir", "D/s"], ["migrate", "--dir", "D/s"],
                ["inspect", "--dir", "D/s", "old"]],
    "prune": [["prune", "--dir", "D/s", "--device", "tpu-v5e"],
              ["prune", "--dir", "D/s", "--kernel", "t",
               "--max-age-days", "1"]],
    "diff": [["diff", "D/s", "D/s"], ["diff", "D/s", "D/o"],
             ["diff", "D/s", "D/future"],
             ["merge", "--into", "D/m", "D/future"]],
}


@pytest.mark.parametrize("command", sorted(CLI_STEPS))
def test_cli_subcommand_output_is_the_references(command, tmp_path, capsys):
    def case(d, wis, dist, cli):
        _cli_store(dist, wis, d)
        store_with(dist, wis, d / "o",
                   rec(wis, score=3.0, config={"block": 4}),
                   rec(wis, problem=(8, 8), score=1.0))
        _write_doc(d / "future" / "future.wisdom.json",
                   {"kernel": "future",
                    "version": wis.WISDOM_VERSION + 9, "records": []})
        steps = []
        for argv in CLI_STEPS[command]:
            argv = [a.replace("D/", f"{d}/") for a in argv]
            rc, out = _cli_out(capsys, cli, argv)
            steps.append((rc, out.replace(str(d), "D")))
        return steps, tree_bytes(d / "s")

    out = both(tmp_path, case)
    assert out["port"] == out["ref"]
    rcs = [rc for rc, _ in out["port"][0]]
    assert rcs == {"inspect": [0, 0, 0, 0], "validate": [0, 1],
                   "migrate": [0, 0, 0], "prune": [0, 0],
                   "diff": [0, 1, 2, 2]}[command]


def test_cli_inspect_names_the_version_key_of_fleet_records(tmp_path,
                                                            capsys):
    """Records the packages write themselves differ only in the version
    key: the inspect output is the same once it is mapped."""
    outs = {}
    for tag, (wis, dist, cli) in PACKAGES.items():
        prov = wis.make_fleet_provenance("exhaustive", 216, "costmodel",
                                         "j-0123456789-r0", 4)
        store = dist.WisdomStore(tmp_path / tag)
        store.save(wis.Wisdom("matmul", [wis.WisdomRecord(
            device_kind="gpu-h100", device_family="gpu-hopper",
            problem_size=(512, 512, 1024), dtype="float32",
            config={"block_m": 128}, score_us=41.5, provenance=prov)]))
        doc = json.loads(store.path_for("matmul").read_text())
        outs[tag] = (_cli_out(capsys, cli, ["inspect", "--dir",
                                            str(store.root), "-v"])[1]
                     .replace(str(store.root), "D"), doc)
    (port_out, port_doc), (ref_out, ref_doc) = outs["port"], outs["ref"]
    assert port_out == ref_out
    port_prov = port_doc["records"][0]["provenance"]
    ref_prov = ref_doc["records"][0]["provenance"]
    assert port_prov.pop("torch_version") == torch.__version__
    ref_prov.pop("jax_version")
    assert port_doc == ref_doc


def test_cli_dir_defaults_to_the_ports_own_store(tmp_path, capsys,
                                                 monkeypatch):
    """Without ``--dir`` the port reads ``$KERNEL_LAUNCHER_WISDOM_DIR``, or
    ``./wisdom-torch`` — never the reference's ``./wisdom``."""
    monkeypatch.delenv("KERNEL_LAUNCHER_WISDOM_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    store_with(ref_distrib, ref_wisdom, tmp_path / "wisdom",
               rec(ref_wisdom))
    assert port_cli(["inspect"]) == 0
    assert capsys.readouterr().out == \
        f"{tmp_path / 'wisdom-torch'}: empty store\n"
    store_with(port_distrib, port_wisdom, tmp_path / "env", rec(port_wisdom))
    monkeypatch.setenv("KERNEL_LAUNCHER_WISDOM_DIR", str(tmp_path / "env"))
    assert port_cli(["validate"]) == 0
    assert capsys.readouterr().out.endswith(
        "env: 1 kernel file(s), 0 issue(s)\n")
    from repro_torch.wisdom import build_parser
    assert build_parser().prog == "python -m repro_torch.wisdom"
