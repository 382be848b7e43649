"""Crash-isolated evaluation + the correctness oracle gating promotion.

Port of ``repro.sandbox``. Auto-tuning executes machine-generated kernel
variants, and some of them are *bad*: they hang, segfault, exhaust memory,
lose their CUDA context, or — worst — finish fast with the wrong answer.
This package holds the two defenses the port's promotion path runs behind:

* the **sandbox** (:mod:`~repro_torch.sandbox.evaluator`): run an
  evaluator in a killed-on-timeout, memory-capped *spawned* child process
  (a CUDA context does not survive ``fork``) and classify what happened as
  a structured :class:`~repro_torch.sandbox.verdict.SandboxVerdict`
  (``ok`` / ``timeout`` / ``crash`` / ``oom`` / ``numerics-mismatch``),
  with the child's stderr captured for the post-mortem;
* the **oracle** (:mod:`~repro_torch.sandbox.oracle`,
  :mod:`~repro_torch.sandbox.gate`): launch a winning config on
  deterministic probe inputs on the device the kernel serves and veto any
  promotion whose output does not match the plain version within
  dtype-aware tolerances. Passing records carry a ``verified`` stamp.

:mod:`~repro_torch.sandbox.faults` provides the fault-injection fixtures
the tests, ``python -m repro_torch.sandbox check --demo`` and the card's
smoke run use to prove it. The gate guards the online promotion, the
fleet coordinator's assembly (``repro_torch.fleet``) and transferred
records (``repro_torch.transfer``).
"""

from .evaluator import (DEFAULT_TIMEOUT_S, KernelTrial, SandboxedEvaluator,
                        SandboxSettings, memory_ceiling, sandboxed_call)
from .faults import (FAULT_MODES, FAULT_PARAM, FaultyEvaluator,
                     device_assert, make_faulty_kernel)
from .gate import OracleGate, clear_verdict_cache
from .oracle import CorrectnessOracle
from .verdict import (STATUS_CRASH, STATUS_NUMERICS, STATUS_OK, STATUS_OOM,
                      STATUS_TIMEOUT, STATUS_UNVERIFIABLE, VERDICT_STATUSES,
                      SandboxVerdict)

__all__ = [
    "DEFAULT_TIMEOUT_S", "KernelTrial", "SandboxedEvaluator",
    "SandboxSettings", "memory_ceiling", "sandboxed_call",
    "FAULT_MODES", "FAULT_PARAM", "FaultyEvaluator", "device_assert",
    "make_faulty_kernel",
    "OracleGate", "clear_verdict_cache",
    "CorrectnessOracle",
    "STATUS_CRASH", "STATUS_NUMERICS", "STATUS_OK", "STATUS_OOM",
    "STATUS_TIMEOUT", "STATUS_UNVERIFIABLE", "VERDICT_STATUSES",
    "SandboxVerdict",
]
