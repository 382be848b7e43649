"""MicroHH steps: each one ``ops.advec_u`` and one ``ops.diff_uvw`` call on
the same seeded fields, back to back.

The window's outputs are checked one by one against the plain stencils:
those of a step drawn from the seed among the first ``keep_window`` steps,
and those of the last step. The number compared for each kernel is the
largest absolute difference over all its outputs, over the largest
absolute reference value.
"""

from __future__ import annotations

import torch

from klbench.harness import Check, annotation
from klbench.reference import stencils as R
from klbench.seeds import generator, rng

F32 = torch.float32


def fields(run) -> torch.Tensor:
    """(4, nz, ny, nx) u, v, w and a non-negative eddy viscosity, drawn on
    the device in one call, in the configuration's dtype."""
    g = generator(run.seed, "fields", run.device)
    f = torch.randn((4, *run.traffic["grid"]), generator=g, dtype=F32,
                    device=run.device)
    f[3].abs_().add_(0.1)
    return f.to(getattr(torch, run.config["dtype"]))


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.to(F32) - ref).abs().max() / ref.abs().max())


class Loop:
    def __init__(self, run):
        self.run = run
        s = run.config["scalars"]
        self.scal = (s["dxi"], s["dyi"], s["dzi"])
        self.kept: dict = {}

    def setup(self) -> None:
        from repro_torch.kernels import ops
        self.ops = ops
        self.run.mark("program imported")
        self.f = fields(self.run)
        self.u, self.v, self.w, self.evisc = self.f.unbind(0)
        self.keep_at = int(rng(self.run.seed, "sample").integers(
            0, self.run.traffic["keep_window"]))
        self.run.mark("fields made")
        self._call()                       # builds or loads both kernels

    def _call(self, annotate: bool = False):
        with annotation(annotate, "klbench.advec_u"):
            ut = self.ops.advec_u(self.u, self.v, self.w, *self.scal)
        with annotation(annotate, "klbench.diff_uvw"):
            tend = self.ops.diff_uvw(self.u, self.v, self.w, self.evisc,
                                     *self.scal)
        return ut, tend

    def step(self, i: int, annotate: bool) -> int:
        out = self._call(annotate)
        if i == self.keep_at:
            self.kept[i] = out
        self.last = (i, out)
        return 1

    def metrics(self, win) -> dict:
        """The window's time a step, under the traffic's metric name."""
        return {self.run.traffic["metric"]: (win.elapsed_s * 1e3 / win.steps,
                                             "ms")}

    def context(self, win) -> dict:
        return {"grid": tuple(self.run.traffic["grid"]),
                "dtype": self.run.config["dtype"], "steps": win.steps}

    def finish(self, win) -> tuple[int, int]:
        self.kept[self.last[0]] = self.last[1]
        return win.steps, 0

    def release(self) -> None:
        """The program keeps no state between calls but its compiled
        kernels; the kept outputs are what is checked."""

    def outputs(self) -> list:
        """The kept steps' (ut, (ut, vt, wt)) outputs."""
        return list(self.kept.values())

    def check(self, outputs: list | None = None) -> list[Check]:
        outputs = self.outputs() if outputs is None else outputs
        args = (self.u, self.v, self.w)
        ref = R.advec_u(*args, *self.scal)
        adv = max(rel_err(ut, ref) for ut, _ in outputs)
        del ref
        refs = R.diff_uvw(*args, self.evisc, *self.scal)
        dif = max(rel_err(t, r) for _, tend in outputs
                  for t, r in zip(tend, refs))
        lim = self.run.limits
        return [Check("advec_u_err", adv, lim["advec_u_err"]),
                Check("diff_uvw_err", dif, lim["diff_uvw_err"])]

    def control_outputs(self) -> list:
        """The reference in bfloat16 put in the program's place."""
        args = (self.u, self.v, self.w)
        return [(R.advec_u(*args, *self.scal, dtype=torch.bfloat16),
                 R.diff_uvw(*args, self.evisc, *self.scal,
                            dtype=torch.bfloat16))]
