"""Serving engine: batched decode over a slot arena — token-level
continuous batching by default, lock-step cohorts as the fallback (port of
``repro.serve.engine``).

Two scheduling modes over the same static (n_slots, max_seq) KV arena:

* **token** (default whenever the model's ``decode_supports_start`` says
  per-slot attention windows work): the arena keeps one physical write
  cursor (``cache["pos"]``) but each slot owns a logical window
  ``[start[b], pos]`` carried in ``cache["start"]``. A request that
  finishes frees its slot mid-stream; the next queued request is admitted
  at the current cursor and fed its prompt per slot while other slots keep
  generating. When the arena runs out, the engine opens a fresh arena
  generation (new cache) and continues. Stale K/V from a slot's previous
  occupant sits below ``start`` and is masked out of attention.

* **cohort**: admit a cohort into free slots and run lock-step until
  every member finishes.

Greedy (argmax) or temperature sampling, on the host with numpy, as in
the reference. ``jax.jit(model.decode_step)`` becomes an eager call of
``model.decode_step``. With ``repro_torch.obs`` enabled the engine reports
decode steps, batch occupancy, cohort sizes, queue depth and completed
requests, and traces one ``serve.cohort`` or ``serve.arena`` span per
cohort or arena generation; a decode-step profiler
(``repro_torch.prof.StepProfiler``, or the ambient one under
``KERNEL_LAUNCHER_PROF``) times sampled steps up to the copy of their
logits to the host, which every step makes anyway. Online autotuners
(``repro_torch.online.OnlineTuner``, passed as ``online``) and fleet wisdom
sync (``repro_torch.distrib.PullSync``, passed as ``sync``) are ticked once
per decode step, as in the reference. A pull runs on the decode loop's
host thread, between two steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.obs import runtime as obs
from repro_torch.obs.metrics import COUNT_BUCKETS, UNIT_BUCKETS

from .batching import ContinuousBatcher


@dataclass
class Request:
    """One generation request: prompt tokens in, sampled tokens out.

    ``scenario`` is an optional tuned-scenario key: the batcher buckets
    admission by it so slots running concurrently share a wisdom-exact
    configuration. Empty string = unbucketed."""
    request_id: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    scenario: str = ""
    tokens: list = field(default_factory=list)   # generated


@dataclass
class ServeReport:
    """What one :meth:`ServeEngine.run` call did.

    Mapping-compatible with ``{request_id: tokens}`` (``report[rid]``,
    iteration, ``len``, ``in`` delegate to :attr:`outputs`). ``cohorts``
    counts lock-step cohorts in cohort mode and arena generations in token
    mode; ``occupancy`` is the fraction of slot-steps that advanced a live
    request; ``inflight_admissions`` counts requests admitted while other
    slots were mid-generation — always 0 in cohort mode.
    """

    outputs: dict[int, list[int]]
    cohorts: int = 0
    requests_completed: int = 0
    steps: int = 0
    mode: str = "cohort"
    occupancy: float = 0.0
    inflight_admissions: int = 0
    scenario_switches: int = 0
    sync_pulls: int = 0
    sync_failures: int = 0

    def __getitem__(self, request_id: int) -> list[int]:
        return self.outputs[request_id]

    def __iter__(self):
        return iter(self.outputs)

    def __len__(self) -> int:
        return len(self.outputs)

    def __contains__(self, request_id: int) -> bool:
        return request_id in self.outputs

    def keys(self):
        return self.outputs.keys()

    def values(self):
        return self.outputs.values()

    def items(self):
        return self.outputs.items()

    def to_json(self) -> dict:
        return {"cohorts": self.cohorts,
                "requests_completed": self.requests_completed,
                "steps": self.steps, "sync_pulls": self.sync_pulls,
                "sync_failures": self.sync_failures, "mode": self.mode,
                "occupancy": self.occupancy,
                "inflight_admissions": self.inflight_admissions,
                "scenario_switches": self.scenario_switches}


class ServeEngine:
    """Continuous-batching LM server over a static KV arena.

    Submit :class:`Request` objects, then :meth:`run` to completion; the
    returned :class:`ServeReport` maps request ids to generated tokens
    plus run statistics. ``mode`` is ``"auto"`` (token-level when the
    model supports per-slot attention windows, else cohort), ``"token"``
    or ``"cohort"``. The model's ``device`` holds the cache and runs the
    decode steps. ``profiler`` is an optional
    :class:`repro_torch.prof.StepProfiler`; ``online`` an optional
    :class:`repro_torch.online.OnlineTuner` (or a list of them) and
    ``sync`` an optional :class:`repro_torch.distrib.PullSync`, both ticked
    once per decode step.

    Example::

        eng = ServeEngine(model, params, n_slots=4, max_seq=256)
        eng.submit(Request(0, np.array([1, 2, 3]), max_new_tokens=8))
        report = eng.run()
        report[0]          # -> 8 generated token ids
    """

    def __init__(self, model, params, n_slots: int = 4,
                 max_seq: int = 512, temperature: float = 0.0,
                 rng_seed: int = 0, profiler=None, mode: str = "auto",
                 online=None, sync=None):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.temperature = temperature
        if mode not in ("auto", "token", "cohort"):
            raise ValueError(f"unknown serve mode {mode!r} "
                             f"(want auto|token|cohort)")
        if mode == "auto":
            mode = ("token"
                    if getattr(model, "decode_supports_start", False)
                    else "cohort")
        self.mode = mode
        self.device = model.device
        self.batcher = ContinuousBatcher(n_slots, max_seq)
        self._decode = model.decode_step
        self._requests: dict[int, Request] = {}
        self._rng = np.random.default_rng(rng_seed)
        self.steps_run = 0
        self._useful_slot_steps = 0
        self._inflight_admissions = 0
        # Optional online autotuner(s) (repro_torch.online.OnlineTuner):
        # each decode step sponsors one launch-budget slice of background
        # tuning through tick(); the kernels' own launches drive their
        # trials and promotions.
        if online is None:
            online = []
        elif not isinstance(online, (list, tuple)):
            online = [online]
        self.online = list(online)
        # Optional fleet wisdom pull (repro_torch.distrib.PullSync): tick()
        # is called once per decode step and pulls every sync.interval
        # ticks, merging fleet wisdom into the local store and refreshing
        # attached kernels, so this host serves the fleet's tuning results.
        self.sync = sync
        # Optional decode-step profiler: every Nth step is timed and
        # recorded as a "serve.decode" roofline profile (params streamed
        # from device memory per step, so small-batch decode is
        # memory-bound; the profile says by how much). Unsampled steps
        # pay one None check.
        self.profiler = profiler
        if profiler is None:
            from repro_torch.prof.profiler import (StepProfiler,
                                                   process_profiler)
            ambient = process_profiler()
            if ambient is not None:
                self.profiler = StepProfiler(ambient)
        if self.profiler is not None:
            self.profiler.bind(params, n_slots, max_seq)

    def submit(self, req: Request) -> bool:
        ok = self.batcher.submit(req.request_id, len(req.prompt),
                                 req.max_new_tokens,
                                 scenario=req.scenario)
        if ok:
            self._requests[req.request_id] = req
        return ok

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.temperature <= 0:
            return logits.argmax(-1).astype(np.int32)
        z = logits / self.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([self._rng.choice(p.shape[-1], p=pi)
                         for pi in p], np.int32)

    def _decode_once(self, cache, next_tok: np.ndarray):
        """One eager decode step; returns host logits (n_slots, V) and the
        cache. A profiler-sampled step is timed on the host clock up to
        its logits' copy to the host, which waits for the step's work."""
        prof = self.profiler
        sampled = prof is not None and prof.due(self.steps_run)
        t0 = time.perf_counter()
        tokens = torch.from_numpy(next_tok).to(self.device)
        logits, cache = self._decode(self.params, cache, tokens)
        host = logits[:, 0].to(torch.float32).cpu().numpy()
        if sampled:
            prof.on_step((time.perf_counter() - t0) * 1e6)
        self.steps_run += 1
        return host, cache

    def _tick_services(self, m) -> None:
        """Per-decode-step collaborator ticks (both modes)."""
        if m is not None:
            m.counter("serve.decode_steps").inc()
        for svc in self.online:
            svc.tick()
        if self.sync is not None:
            fails_before = self.sync.failures
            pulled = self.sync.tick()
            if m is not None:
                if pulled is not None:
                    outcome = "pulled"
                elif self.sync.failures > fails_before:
                    outcome = "failed"
                else:
                    outcome = "skipped"
                m.counter("serve.sync_tick", outcome=outcome).inc()

    # -- cohort mode ---------------------------------------------------------

    def _run_cohort(self, members: list[tuple[int, int, int]]) -> None:
        """members: [(slot, request_id, prompt_len)]. Fresh cache; decode
        in lock-step until every member has its tokens."""
        cache = self.model.init_cache(self.n_slots, self.max_seq)
        reqs = {slot: self._requests[rid] for slot, rid, _ in members}
        done = {slot: False for slot in reqs}
        next_tok = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in reqs.items():
            next_tok[slot, 0] = req.prompt[0]
        t = 0
        while not all(done.values()) and t < self.max_seq - 1:
            m = obs.metrics()
            live = sum(1 for v in done.values() if not v)
            self._useful_slot_steps += live
            if m is not None:
                m.histogram("batch.occupancy",
                            UNIT_BUCKETS).observe(live / self.n_slots)
            logits, cache = self._decode_once(cache, next_tok)
            self._tick_services(m)
            sampled = self._sample(logits)
            for slot, req in reqs.items():
                if done[slot]:
                    continue
                if t + 1 < len(req.prompt):
                    next_tok[slot, 0] = req.prompt[t + 1]   # still feeding
                else:
                    req.tokens.append(int(sampled[slot]))
                    next_tok[slot, 0] = sampled[slot]
                    if len(req.tokens) >= req.max_new_tokens:
                        done[slot] = True
            t += 1
        # release slots
        for slot, rid, _ in members:
            s = self.batcher.slots[slot]
            self.batcher.finished.append(rid)
            s.active = False
            s.request_id = None
        m = obs.metrics()
        if m is not None:
            m.counter("serve.requests_completed").inc(len(members))

    def _run_cohort_mode(self, max_cohorts: int) -> int:
        cohorts = 0
        for _ in range(max_cohorts):
            if self.batcher.done():
                break
            members = self.batcher.admit()
            if not members:
                continue
            m = obs.metrics()
            if m is not None:
                m.histogram("serve.cohort_size",
                            COUNT_BUCKETS).observe(len(members))
                m.gauge("serve.queue_depth").set(self.batcher.queue_depth)
            tr = obs.tracer()
            if tr is not None:
                with tr.span("serve.cohort", cat="serve",
                             cohort=cohorts, size=len(members)):
                    self._run_cohort(members)
            else:
                self._run_cohort(members)
            cohorts += 1
        return cohorts

    # -- token mode ----------------------------------------------------------

    def _run_arena(self) -> None:
        """One arena generation: fresh cache, write cursor at 0, then
        token-level decode — freed slots admit queued requests mid-stream
        at the current cursor — until the queue and slots drain or the
        remaining arena cannot hold the next (head-of-line) request."""
        b = self.batcher
        cache = self.model.init_cache(self.n_slots, self.max_seq)
        starts = np.zeros(self.n_slots, np.int64)
        fed = [0] * self.n_slots           # prompt tokens fed per slot
        next_tok = np.zeros((self.n_slots, 1), np.int32)
        arena_pos = 0
        while arena_pos < self.max_seq:
            m = obs.metrics()
            active_before = b.active_slots
            admitted = b.admit(arena_pos=arena_pos)
            for slot, rid, _plen in admitted:
                req = self._requests[rid]
                next_tok[slot, 0] = req.prompt[0]
                starts[slot] = arena_pos
                fed[slot] = 1
            if admitted and active_before > 0:
                self._inflight_admissions += len(admitted)
            if admitted and m is not None:
                m.gauge("serve.queue_depth").set(b.queue_depth)
            active = [i for i, s in enumerate(b.slots) if s.active]
            if not active:
                break       # drained, or head request needs a fresh arena
            self._useful_slot_steps += len(active)
            if m is not None:
                m.histogram("batch.occupancy",
                            UNIT_BUCKETS).observe(len(active)
                                                  / self.n_slots)
            cache["start"] = torch.from_numpy(starts).to(self.device)
            logits, cache = self._decode_once(cache, next_tok)
            arena_pos += 1
            self._tick_services(m)
            sampled = self._sample(logits)
            completed = 0
            for i in active:
                req = self._requests[b.slots[i].request_id]
                if fed[i] < len(req.prompt):
                    next_tok[i, 0] = req.prompt[fed[i]]     # still feeding
                    fed[i] += 1
                    continue
                req.tokens.append(int(sampled[i]))
                next_tok[i, 0] = sampled[i]
                if b.advance(i) is not None:
                    completed += 1          # slot freed; refilled next step
            if completed and m is not None:
                m.counter("serve.requests_completed").inc(completed)

    def _run_token_mode(self, max_generations: int) -> int:
        generations = 0
        while generations < max_generations and not self.batcher.done():
            tr = obs.tracer()
            if tr is not None:
                with tr.span("serve.arena", cat="serve",
                             generation=generations):
                    self._run_arena()
            else:
                self._run_arena()
            generations += 1
        return generations

    # -- run loop ------------------------------------------------------------

    def run(self, max_cohorts: int = 1000) -> ServeReport:
        """Serve every submitted request to completion. ``max_cohorts``
        bounds lock-step cohorts (cohort mode) or arena generations
        (token mode) as a runaway backstop."""
        steps0 = self.steps_run
        done0 = len(self.batcher.finished)
        useful0 = self._useful_slot_steps
        inflight0 = self._inflight_admissions
        switches0 = self.batcher.scenario_switches
        pulls0 = self.sync.pulls if self.sync is not None else 0
        fails0 = self.sync.failures if self.sync is not None else 0
        if self.mode == "token":
            cohorts = self._run_token_mode(max_cohorts)
        else:
            cohorts = self._run_cohort_mode(max_cohorts)
        steps = self.steps_run - steps0
        useful = self._useful_slot_steps - useful0
        return ServeReport(
            outputs={rid: r.tokens for rid, r in self._requests.items()},
            cohorts=cohorts,
            requests_completed=len(self.batcher.finished) - done0,
            steps=steps,
            sync_pulls=(self.sync.pulls - pulls0
                        if self.sync is not None else 0),
            sync_failures=(self.sync.failures - fails0
                           if self.sync is not None else 0),
            mode=self.mode,
            occupancy=(round(useful / (steps * self.n_slots), 4)
                       if steps else 0.0),
            inflight_admissions=self._inflight_admissions - inflight0,
            scenario_switches=(self.batcher.scenario_switches
                               - switches0))
