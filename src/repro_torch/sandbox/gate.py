"""OracleGate — the mandatory correctness gate on wisdom promotion.

Port of ``repro.sandbox.gate``. A path that turns a tuning winner into a
served :class:`~repro_torch.core.wisdom.WisdomRecord` — in the port, the
online hot swap (:mod:`repro_torch.online.promotion`), the fleet
coordinator's assembly (:mod:`repro_torch.fleet.coordinator`) and a
transfer's record (:mod:`repro_torch.transfer`) — asks one question
first: *does this config compute the right answer?* The gate answers it
by synthesizing deterministic probe arguments for the scenario (the
kernel's ``probe`` hook), moving them to the device the kernel serves, and
running the config through a
:class:`~repro_torch.sandbox.oracle.CorrectnessOracle`. The device
matters: probe arguments are CPU tensors, and a CPU tensor runs the plain
version, so a gate that checked where the probe was made would hold the
plain version to itself. For a kernel bound to the card the gate checks
on the card, where the hand-written kernel runs. Configs that pass get a
``verified: {rtol, atol, ref}`` stamp in their record provenance; configs
that fail (``numerics-mismatch``, ``crash``, ``timeout``, ``oom``) never
become wisdom.

Kernels without probe/build/reference hooks yield ``unverifiable``; the
``on_unverifiable`` policy decides whether that blocks promotion (default
``"allow"``).

Verdicts are cached process-wide, keyed by (kernel, problem, dtype,
config, device): every gate instance shares one cache, and repeated
promotions of the same winner on the same device cost one check.
"""

from __future__ import annotations

import torch

from repro_torch.core.builder import KernelBuilder
from repro_torch.core.param import Config
from repro_torch.core.registry import get_kernel

from .evaluator import SandboxSettings
from .oracle import CorrectnessOracle
from .verdict import STATUS_OK, STATUS_UNVERIFIABLE, SandboxVerdict

#: Process-wide verdict cache: (kernel, problem, dtype, frozen config,
#: device) -> SandboxVerdict. Shared across OracleGate instances.
_VERDICT_CACHE: dict[tuple, SandboxVerdict] = {}


def clear_verdict_cache() -> None:
    """Drop the process-wide oracle verdict cache (tests that mutate a
    kernel's hooks between checks need this; production never does).

    Example::

        register(make_faulty_kernel())
        clear_verdict_cache()       # stale verdicts from a prior fixture
    """
    _VERDICT_CACHE.clear()


class OracleGate:
    """The shared correctness gate of the promotion paths.

    ``check`` verifies one (config, problem, dtype) for a kernel on a
    device and returns the :class:`SandboxVerdict`; ``allows`` maps a
    verdict to a promote/reject decision under the ``on_unverifiable``
    policy; ``stamp`` adds the ``verified`` provenance block to a passing
    record's provenance. ``device`` is where checks run unless a call
    names its own (None: the probe's device, the CPU). ``settings=None``
    verifies in-process; pass spawn
    :class:`~repro_torch.sandbox.evaluator.SandboxSettings` to also
    contain kernels that kill the process during the check.

    Example::

        gate = OracleGate(device="cuda")
        verdict = gate.check("advec_u", config, (64, 64, 64), "float32")
        if gate.allows(verdict):
            provenance = gate.stamp(provenance, "advec_u", verdict)
    """

    def __init__(self, settings: SandboxSettings | None = None,
                 on_unverifiable: str = "allow",
                 device: str | torch.device | None = None) -> None:
        if on_unverifiable not in ("allow", "reject"):
            raise ValueError(f"unknown on_unverifiable policy "
                             f"{on_unverifiable!r}; use 'allow' or "
                             f"'reject'")
        self.settings = settings
        self.on_unverifiable = on_unverifiable
        self.device = device
        #: Every check this gate made: (kernel, scenario-ish key,
        #: SandboxVerdict) in call order — for reports and tests.
        self.checks: list[tuple[str, tuple, SandboxVerdict]] = []
        self._oracles: dict[tuple, CorrectnessOracle] = {}

    # -- verdict production ----------------------------------------------------

    def _resolve(self, kernel) -> tuple[KernelBuilder | None, str]:
        if isinstance(kernel, KernelBuilder):
            return kernel, kernel.name
        try:
            return get_kernel(str(kernel)), str(kernel)
        except KeyError:
            return None, str(kernel)

    def _unverifiable(self, why: str) -> SandboxVerdict:
        return SandboxVerdict(STATUS_UNVERIFIABLE, detail=why)

    def _oracle(self, builder: KernelBuilder, problem: tuple[int, ...],
                dtype: str, device: torch.device
                ) -> CorrectnessOracle | SandboxVerdict:
        key = (builder.name, tuple(problem), dtype, str(device))
        oracle = self._oracles.get(key)
        if oracle is not None:
            return oracle
        try:
            args = [a.to(device)
                    for a in builder.make_probe_args(problem, dtype)]
        except Exception as e:  # noqa: BLE001 — probe itself misbehaved
            return self._unverifiable(
                f"probe failed for problem {tuple(problem)}: "
                f"{type(e).__name__}: {e}")
        oracle = CorrectnessOracle(builder, args, settings=self.settings)
        self._oracles[key] = oracle
        return oracle

    def check(self, kernel, config: Config, problem: tuple[int, ...],
              dtype: str, device: str | torch.device | None = None
              ) -> SandboxVerdict:
        """Verdict for promoting ``config`` for this scenario on
        ``device`` (default: the gate's own, else the CPU).

        ``kernel`` is a :class:`KernelBuilder` or a registry name; an
        unregistered name or a kernel lacking probe/build/reference
        hooks yields ``unverifiable`` rather than an error.
        """
        problem = tuple(int(x) for x in problem)
        dev = torch.device(device if device is not None
                           else self.device if self.device is not None
                           else "cpu")
        builder, name = self._resolve(kernel)
        if builder is None:
            verdict = self._unverifiable(
                f"kernel {name!r} is not registered on this host")
        elif not (builder.has_probe() and builder._build is not None
                  and builder._reference is not None):
            verdict = self._unverifiable(
                f"kernel {name!r} has no probe/build/reference hooks")
        else:
            cache_key = (name, problem, dtype,
                         builder.space.freeze(config), str(dev))
            verdict = _VERDICT_CACHE.get(cache_key)
            if verdict is None:
                oracle = self._oracle(builder, problem, dtype, dev)
                if isinstance(oracle, SandboxVerdict):
                    verdict = oracle
                else:
                    verdict = oracle.check(config)
                _VERDICT_CACHE[cache_key] = verdict
        self.checks.append((name, (problem, dtype), verdict))
        return verdict

    def check_record(self, kernel, record) -> SandboxVerdict:
        """:meth:`check` for a :class:`~repro_torch.core.wisdom.WisdomRecord`
        (scenario taken from the record itself), on the gate's device."""
        return self.check(kernel, record.config, record.problem_size,
                          record.dtype)

    # -- decisions -------------------------------------------------------------

    def allows(self, verdict: SandboxVerdict) -> bool:
        """Whether a verdict lets the config become wisdom."""
        if verdict.status == STATUS_OK:
            return True
        if verdict.status == STATUS_UNVERIFIABLE:
            return self.on_unverifiable == "allow"
        return False

    def stamp(self, provenance: dict, kernel_name: str,
              verdict: SandboxVerdict) -> dict:
        """Provenance with the oracle's ``verified`` block added.

        Only ``ok`` verdicts stamp (anything else returns the input
        unchanged); the block is deterministic — tolerances and the
        reference identity, no floats measured at check time — so records
        stay byte-identical across hosts.
        """
        if verdict.status != STATUS_OK:
            return dict(provenance)
        out = dict(provenance)
        out["verified"] = {"rtol": verdict.rtol, "atol": verdict.atol,
                           "ref": f"{kernel_name}.reference"}
        return out
