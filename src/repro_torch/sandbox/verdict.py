"""SandboxVerdict — the structured outcome of one isolated evaluation.

A copy of ``repro.sandbox.verdict``: the same taxonomy and the same JSON.
Every candidate config that goes through the sandbox (or the
correctness oracle) gets exactly one verdict from a closed taxonomy, so
callers branch on a status string instead of parsing tracebacks:

  ``ok``                 ran to completion (oracle: and matched the
                         reference within tolerance)
  ``timeout``            exceeded the wall-clock ceiling; the child was
                         killed, the parent kept running
  ``crash``              raised, aborted, or died on a signal
                         (``exit_cause`` says which; segfaults land here)
  ``oom``                exceeded the memory ceiling (``MemoryError``
                         under ``RLIMIT_AS``, a CUDA out-of-memory error
                         under the device-memory fraction, or killed by
                         the OS)
  ``numerics-mismatch``  executed fine but the output disagrees with the
                         reference oracle beyond dtype-aware rtol/atol
  ``unverifiable``       the kernel has no probe/build/reference hooks,
                         so correctness cannot be checked (policy
                         decides whether that blocks promotion)
"""

from __future__ import annotations

from dataclasses import dataclass

STATUS_OK = "ok"
STATUS_TIMEOUT = "timeout"
STATUS_CRASH = "crash"
STATUS_OOM = "oom"
STATUS_NUMERICS = "numerics-mismatch"
STATUS_UNVERIFIABLE = "unverifiable"

#: The closed verdict taxonomy, in severity-neutral declaration order.
VERDICT_STATUSES = (STATUS_OK, STATUS_TIMEOUT, STATUS_CRASH, STATUS_OOM,
                    STATUS_NUMERICS, STATUS_UNVERIFIABLE)


@dataclass
class SandboxVerdict:
    """What happened to one config inside the sandbox/oracle.

    ``detail`` is the human-readable cause (exception text, allclose
    message), ``exit_cause`` the mechanical one (``"exit:N"``,
    ``"signal:N"``, ``"exception:Type"``, ``"inline"``), ``stderr`` the
    captured (truncated) child stderr. The oracle additionally fills
    ``max_err``/``rtol``/``atol`` so provenance and reports can say how
    close the comparison was.

    Example::

        verdict = oracle.check(config)
        if verdict.status == STATUS_NUMERICS:
            print(f"wrong output: {verdict.detail}")
    """

    status: str
    detail: str = ""
    exit_cause: str = ""
    stderr: str = ""
    wall_s: float = 0.0
    max_err: float | None = None
    rtol: float | None = None
    atol: float | None = None

    def __post_init__(self) -> None:
        if self.status not in VERDICT_STATUSES:
            raise ValueError(f"unknown verdict status {self.status!r}; "
                             f"have {VERDICT_STATUSES}")

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    def to_json(self) -> dict:
        out = {"status": self.status, "detail": self.detail,
               "exit_cause": self.exit_cause, "stderr": self.stderr,
               "wall_s": round(self.wall_s, 6)}
        if self.max_err is not None:
            out["max_err"] = self.max_err
        if self.rtol is not None:
            out["rtol"] = self.rtol
        if self.atol is not None:
            out["atol"] = self.atol
        return out

    @staticmethod
    def from_json(d: dict) -> "SandboxVerdict":
        return SandboxVerdict(
            status=str(d["status"]), detail=str(d.get("detail", "")),
            exit_cause=str(d.get("exit_cause", "")),
            stderr=str(d.get("stderr", "")),
            wall_s=float(d.get("wall_s", 0.0)),
            max_err=d.get("max_err"), rtol=d.get("rtol"),
            atol=d.get("atol"))
