"""Wisdom-health report: what the telemetry says about serving quality.

The paper's promise is that every launch lands on a tuned configuration;
the health report measures how true that is right now. From a metrics
snapshot (or a saved Chrome trace — spans are converted to the same
counters first) it renders, deterministically:

* per-scenario **hit rates** — the share of launches served at tier
  "exact" (or forced/trial) vs the fuzzy/transfer/default miss tiers;
* the **tier breakdown** per kernel — where selection actually lands;
* the **transfer-confidence distribution** — how confident the served
  cross-device predictions were;
* the **top missing scenarios** — the launch-weighted list of scenarios
  the fleet should tune next (the same signal the demand ranker uses);
* **sandbox & oracle** outcomes — crash-isolated evaluation verdicts
  and correctness-check pass/fail mix (with max-error stats) when those
  series are present;
* **profiler bottlenecks** — per-kernel roofline classification of
  sampled launches (``prof.*`` series from :mod:`repro_torch.prof`), with
  mean achieved roofline fraction and drift-event counts;
* one-line summaries of serve / online / fleet / sync activity when
  those series are present.

Rendering is a pure function of the snapshot dict: same snapshot, same
bytes. A copy of ``repro.obs.report`` over this package's tier vocabulary
(``repro_torch.core.scenario``), so one snapshot renders the same report in
both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.scenario import HIT_TIERS, MISS_TIERS, SELECT_TIERS

from .metrics import merge_snapshots, parse_series

#: Metric the per-scenario sections read. One counter per
#: (kernel, scenario, tier), incremented at every launch/selection.
TIER_SERIES = "select.tier"


@dataclass
class ScenarioHealth:
    """Aggregated selection outcomes for one (kernel, scenario)."""

    kernel: str
    scenario: str
    tiers: dict[str, float] = field(default_factory=dict)

    @property
    def launches(self) -> float:
        return sum(self.tiers.values())

    @property
    def hits(self) -> float:
        return sum(v for t, v in self.tiers.items() if t in HIT_TIERS)

    @property
    def misses(self) -> float:
        return sum(v for t, v in self.tiers.items() if t in MISS_TIERS)

    @property
    def hit_rate(self) -> float:
        n = self.launches
        return self.hits / n if n else 0.0


def scenario_health(snapshot: dict) -> list[ScenarioHealth]:
    """Group the snapshot's ``select.tier`` counters by (kernel, scenario),
    deterministically ordered."""
    table: dict[tuple[str, str], ScenarioHealth] = {}
    for key, value in snapshot.get("counters", {}).items():
        name, labels = parse_series(key)
        if name != TIER_SERIES:
            continue
        kernel = labels.get("kernel", "?")
        scenario = labels.get("scenario", "?")
        tier = labels.get("tier", "?")
        sh = table.setdefault((kernel, scenario),
                              ScenarioHealth(kernel, scenario))
        sh.tiers[tier] = sh.tiers.get(tier, 0.0) + value
    return [table[k] for k in sorted(table)]


def snapshot_from_trace(trace: dict) -> dict:
    """Reduce a saved Chrome trace to the snapshot shape the report reads.

    ``launch`` spans carry kernel/scenario/tier in their args; each one
    becomes a ``select.tier`` increment, and span durations rebuild the
    per-kernel launch-latency histograms. A trace is therefore an
    alternative — replayable — source for the same health report.
    """
    from .metrics import MetricsRegistry
    reg = MetricsRegistry()
    for ev in trace.get("traceEvents", []):
        if ev.get("name") != "launch":
            continue
        args = ev.get("args", {})
        kernel = str(args.get("kernel", "?"))
        tier = str(args.get("tier", "?"))
        scenario = str(args.get("scenario", "?"))
        reg.counter(TIER_SERIES, kernel=kernel, scenario=scenario,
                    tier=tier).inc()
        if isinstance(ev.get("dur"), (int, float)):
            reg.histogram("launch.latency_us",
                          kernel=kernel).observe(ev["dur"])
    return reg.snapshot()


def _fmt_n(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:.2f}"


def _section(lines: list[str], title: str) -> None:
    if lines and lines[-1] != "":
        lines.append("")
    lines.append(title)
    lines.append("-" * len(title))


def _counter_total(snapshot: dict, name: str,
                   **match: str) -> float:
    total = 0.0
    for key, value in snapshot.get("counters", {}).items():
        n, labels = parse_series(key)
        if n != name:
            continue
        if all(labels.get(k) == v for k, v in match.items()):
            total += value
    return total


def _counter_rows(snapshot: dict, name: str) -> list[tuple[dict, float]]:
    rows = []
    for key, value in sorted(snapshot.get("counters", {}).items()):
        n, labels = parse_series(key)
        if n == name:
            rows.append((labels, value))
    return rows


def _histogram_rows(snapshot: dict, name: str) -> list[tuple[dict, dict]]:
    rows = []
    for key in sorted(snapshot.get("histograms", {})):
        n, labels = parse_series(key)
        if n == name:
            rows.append((labels, snapshot["histograms"][key]))
    return rows


def render_report(snapshot: dict, top: int = 10) -> str:
    """The wisdom-health report as text. Pure: same snapshot, same bytes.

    Example::

        print(render_report(load_snapshot("obs-snapshot.json")))
    """
    lines: list[str] = []
    health = scenario_health(snapshot)

    _section(lines, "Wisdom health (per scenario)")
    if not health:
        lines.append("no select.tier series in snapshot — nothing "
                     "launched with observability enabled")
    for sh in health:
        breakdown = " ".join(
            f"{t}={_fmt_n(sh.tiers[t])}"
            for t in (*SELECT_TIERS, "forced", "trial") if t in sh.tiers)
        lines.append(f"{sh.kernel} {sh.scenario}: "
                     f"hit-rate={sh.hit_rate:.2f} "
                     f"launches={_fmt_n(sh.launches)} [{breakdown}]")

    by_kernel: dict[str, dict[str, float]] = {}
    for sh in health:
        agg = by_kernel.setdefault(sh.kernel, {})
        for t, v in sh.tiers.items():
            agg[t] = agg.get(t, 0.0) + v
    _section(lines, "Tier breakdown (per kernel)")
    if not by_kernel:
        lines.append("(none)")
    for kernel in sorted(by_kernel):
        agg = by_kernel[kernel]
        total = sum(agg.values())
        parts = " ".join(
            f"{t}={_fmt_n(agg[t])} ({agg[t] / total:.0%})"
            for t in (*SELECT_TIERS, "forced", "trial") if t in agg)
        lines.append(f"{kernel}: {parts}")

    conf = {k: h for k, h in snapshot.get("histograms", {}).items()
            if parse_series(k)[0] == "select.transfer_confidence"}
    _section(lines, "Transfer-confidence distribution")
    if not conf:
        lines.append("no transferred records served")
    for key in sorted(conf):
        h = conf[key]
        _, labels = parse_series(key)
        buckets = []
        lo = 0.0
        for b, c in zip(h["bounds"], h["counts"]):
            if c:
                buckets.append(f"({lo:.1f},{b:.1f}]={c}")
            lo = b
        if h["counts"][len(h["bounds"])]:
            buckets.append(f"(>{h['bounds'][-1]:.1f})="
                           f"{h['counts'][len(h['bounds'])]}")
        mean = h["sum"] / h["count"] if h["count"] else 0.0
        lines.append(f"{labels.get('kernel', '?')}: n={h['count']} "
                     f"mean={mean:.3f} {' '.join(buckets)}")

    missing = sorted((sh for sh in health if sh.misses > 0),
                     key=lambda sh: (-sh.misses, sh.kernel, sh.scenario))
    _section(lines, f"Top missing scenarios (tune these next, top {top})")
    if not missing:
        lines.append("every observed scenario is served from exact wisdom")
    for sh in missing[:top]:
        worst = max((t for t in sh.tiers if t in MISS_TIERS),
                    key=lambda t: (sh.tiers[t], t))
        lines.append(f"{sh.kernel} {sh.scenario}: "
                     f"misses={_fmt_n(sh.misses)} "
                     f"dominant-tier={worst}")

    # Sandbox / oracle: crash-isolated evaluation outcomes and
    # correctness-oracle verdicts, when those series are present.
    sandbox = _counter_rows(snapshot, "sandbox.verdict")
    oracle = _counter_rows(snapshot, "oracle.checks")
    if sandbox or oracle:
        _section(lines, "Sandbox & oracle")
        if sandbox:
            total = sum(v for _, v in sandbox)
            parts = " ".join(f"{labels.get('status', '?')}={_fmt_n(v)}"
                             for labels, v in sandbox)
            lines.append(f"sandbox verdicts: n={_fmt_n(total)} [{parts}]")
        by_k: dict[str, dict[str, float]] = {}
        for labels, v in oracle:
            agg = by_k.setdefault(labels.get("kernel", "?"), {})
            status = labels.get("status", "?")
            agg[status] = agg.get(status, 0.0) + v
        errs = {labels.get("kernel", "?"): h
                for labels, h in _histogram_rows(snapshot, "oracle.max_err")}
        for kernel in sorted(by_k):
            agg = by_k[kernel]
            parts = " ".join(f"{s}={_fmt_n(agg[s])}" for s in sorted(agg))
            h = errs.get(kernel)
            tail = ""
            if h and h["count"]:
                tail = (f" max-err mean={h['sum'] / h['count']:.2e} "
                        f"n={h['count']}")
            lines.append(f"oracle {kernel}: [{parts}]{tail}")

    # Profiler (repro_torch.prof): sampled-launch roofline classification.
    prof = _counter_rows(snapshot, "prof.launches")
    if prof:
        _section(lines, "Profiler (roofline bottlenecks)")
        by_pk: dict[str, dict[str, float]] = {}
        for labels, v in prof:
            agg = by_pk.setdefault(labels.get("kernel", "?"), {})
            b = labels.get("bottleneck", "?")
            agg[b] = agg.get(b, 0.0) + v
        fracs = {labels.get("kernel", "?"): h for labels, h in
                 _histogram_rows(snapshot, "prof.roofline_fraction")}
        for kernel in sorted(by_pk):
            agg = by_pk[kernel]
            total = sum(agg.values())
            dominant = max(sorted(agg), key=lambda b: agg[b])
            parts = " ".join(f"{b}={_fmt_n(agg[b])}" for b in sorted(agg))
            h = fracs.get(kernel)
            frac = (f" mean-roofline-frac="
                    f"{h['sum'] / h['count']:.3f}"
                    if h and h["count"] else "")
            drift = _counter_total(snapshot, "prof.drift", kernel=kernel)
            lines.append(f"{kernel}: profiled={_fmt_n(total)} "
                         f"{dominant}-bound [{parts}]{frac} "
                         f"drift-events={_fmt_n(drift)}")

    activity: list[str] = []
    launches = _counter_total(snapshot, "launch.count")
    if launches:
        activity.append(f"launches={_fmt_n(launches)}")
    steps = _counter_total(snapshot, "serve.decode_steps")
    if steps:
        activity.append(f"decode-steps={_fmt_n(steps)}")
    done = _counter_total(snapshot, "serve.requests_completed")
    if done:
        activity.append(f"requests-completed={_fmt_n(done)}")
    sync_fail = (_counter_total(snapshot, "serve.sync_tick", outcome="failed")
                 + _counter_total(snapshot, "sync.failures"))
    activity.append(f"sync-failures={_fmt_n(sync_fail)}")
    trials = _counter_total(snapshot, "online.trials")
    promos = _counter_total(snapshot, "online.promotions",
                            outcome="promoted")
    if trials or promos:
        activity.append(f"online-trials={_fmt_n(trials)}")
        activity.append(f"online-promotions={_fmt_n(promos)}")
    leases = _counter_total(snapshot, "fleet.lease", event="acquire")
    if leases:
        activity.append(f"fleet-leases={_fmt_n(leases)}")
        activity.append(
            f"fleet-reclaims="
            f"{_fmt_n(_counter_total(snapshot, 'fleet.lease', event='reclaim'))}")
        activity.append(
            f"fleet-evals={_fmt_n(_counter_total(snapshot, 'fleet.shard_evals'))}")
    _section(lines, "Activity")
    lines.append(" ".join(activity))
    return "\n".join(lines) + "\n"


def fleet_report(snapshots: list[dict], top: int = 10) -> str:
    """Render one health report over many workers' snapshots (merged with
    :func:`~repro_torch.obs.metrics.merge_snapshots` — counters sum, gauges
    keep the max). What the coordinator prints for fleet-wide health."""
    return render_report(merge_snapshots(snapshots), top=top)
