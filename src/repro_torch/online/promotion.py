"""Promotion pipeline: bracket winner -> wisdom record -> hot swap.

Port of ``repro.online.promotion``. Beyond-paper (writes standard §4.4
wisdom records, so offline tooling treats promotions like any tuning
session). Once a scenario's successive-halving bracket has a winner, the
pipeline decides whether it is confidently better than the incumbent
(relative margin over the incumbent's score, plus a minimum number of live
measurements), and if so:

1. runs the mandatory correctness gate
   (:class:`repro_torch.sandbox.gate.OracleGate`): the winning config is
   launched on probe arguments on the device the kernel serves (the card,
   for a kernel bound to it) and held to the plain version; a
   ``numerics-mismatch``/``crash`` verdict vetoes the promotion (recorded
   on :attr:`PromotionPipeline.rejections`), so a fast-but-wrong
   candidate can win a bracket but never becomes serving wisdom;
2. *prewarms* the winning variant in the kernel's compile cache (the nvcc
   build and the load), so the hot swap never stalls a live launch on
   compilation; a failure raises here, before any wisdom is written;
3. writes a fresh :class:`~repro_torch.core.wisdom.WisdomRecord` with
   ``online`` provenance (``strategy="online"``, ``online: true``) and the
   gate's ``verified`` stamp;
4. refreshes the kernel's wisdom + selection caches (keeping compiled
   variants), so the very next launch of the scenario selects the promoted
   record at tier "exact".

The ``broadcast`` hook (any ``broadcast(kernel_name, record)`` object or a
bare callable) publishes each promoted record beyond this host.
:class:`repro_torch.distrib.PushSync` is its fleet implementation: it
merges the record into the transport's copy, so the fleet's wisdom only
ever improves.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from repro_torch.core.builder import ArgsMeta
from repro_torch.core.device import get_device
from repro_torch.core.wisdom import Wisdom, WisdomRecord, make_provenance
from repro_torch.sandbox.gate import OracleGate
from repro_torch.sandbox.verdict import SandboxVerdict

DEFAULT_MARGIN = 0.02
DEFAULT_MIN_MEASUREMENTS = 1


@dataclass
class Promotion:
    """Outcome of a successful promotion, for logs/benchmarks."""
    record: WisdomRecord
    incumbent_score_us: float
    improvement: float           # fractional, e.g. 0.31 = 31% faster


@dataclass
class Rejection:
    """A bracket winner the correctness oracle vetoed."""
    key: tuple                   # (device_kind, problem, dtype)
    config: dict
    verdict: SandboxVerdict


class PromotionPipeline:
    def __init__(self, kernel, wisdom_dir: Path | str | None = None,
                 margin: float = DEFAULT_MARGIN,
                 min_measurements: int = DEFAULT_MIN_MEASUREMENTS,
                 broadcast=None, oracle="auto"):
        self.kernel = kernel                       # WisdomKernel
        self.wisdom_dir = (wisdom_dir if wisdom_dir is not None
                           else kernel.wisdom_dir)
        self.margin = margin
        self.min_measurements = min_measurements
        #: Fleet hook: any object with ``broadcast(kernel_name, record)``
        #: (``repro_torch.distrib.PushSync``), or a bare callable taking
        #: the same two arguments. None = local-only (the paper's model).
        self.broadcast = broadcast
        self.broadcasts = 0
        #: The correctness gate every winner must clear before the wisdom
        #: write. ``"auto"`` = a default :class:`OracleGate` (verify when
        #: the kernel has probe/reference hooks, allow when it does not);
        #: None disables gating (tests only — promotions then skip
        #: verification entirely).
        self.oracle = OracleGate() if oracle == "auto" else oracle
        self.promotions: list[Promotion] = []
        #: Winners vetoed by the oracle, in veto order.
        self.rejections: list[Rejection] = []

    def _broadcast(self, record: WisdomRecord) -> None:
        if self.broadcast is None:
            return
        fn = getattr(self.broadcast, "broadcast", self.broadcast)
        try:
            fn(self.kernel.builder.name, record)
            self.broadcasts += 1
        except Exception:  # pragma: no cover — never break serving
            pass

    def confident(self, winner_score_us: float, incumbent_score_us: float,
                  n_measurements: int) -> bool:
        if n_measurements < self.min_measurements:
            return False
        return winner_score_us < incumbent_score_us * (1.0 - self.margin)

    def promote(self, device_kind: str, problem: tuple[int, ...], dtype: str,
                config: dict, score_us: float, incumbent_score_us: float,
                n_measurements: int, evals: int, objective: str,
                meta: ArgsMeta | None = None) -> Promotion | None:
        """Write + hot-swap if confident; returns the Promotion or None.

        ``meta`` is the launch's argument view: the gate checks the config
        on its tensors' device (the card's kernel, for CUDA tensors) and
        the winner is prewarmed for it. Without ``meta`` the gate checks
        on the probe's own device, the CPU."""
        if not self.confident(score_us, incumbent_score_us, n_measurements):
            return None
        verdict = None
        if self.oracle is not None:
            verdict = self.oracle.check(
                self.kernel.builder, config, problem, dtype,
                device=None if meta is None else meta[0].device)
            if not self.oracle.allows(verdict):
                self.rejections.append(Rejection(
                    key=(device_kind, tuple(int(x) for x in problem),
                         dtype),
                    config=dict(config), verdict=verdict))
                return None
        # Hot swap: compile the winner first, then write it and flip
        # selection to it.
        if meta is not None:
            self.kernel.prewarm(meta, config)
        dev = get_device(device_kind)
        provenance = make_provenance(strategy="online", evals=evals,
                                     objective=objective)
        provenance["online"] = True
        provenance["live_measurements"] = n_measurements
        if verdict is not None:
            provenance = self.oracle.stamp(
                provenance, self.kernel.builder.name, verdict)
        record = WisdomRecord(
            device_kind=dev.kind, device_family=dev.family,
            problem_size=tuple(int(x) for x in problem), dtype=dtype,
            config=dict(config), score_us=float(score_us),
            provenance=provenance)
        wisdom = Wisdom.load(self.kernel.builder.name, self.wisdom_dir)
        wisdom.add(record)
        wisdom.save(self.wisdom_dir)
        self._broadcast(record)
        self.kernel.refresh_wisdom()

        promo = Promotion(
            record=record, incumbent_score_us=incumbent_score_us,
            improvement=1.0 - score_us / max(incumbent_score_us, 1e-12))
        self.promotions.append(promo)
        return promo
