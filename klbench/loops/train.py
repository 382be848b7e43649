"""Training steps through ``train.step.make_train_step``, back to back.

Set-up builds one train state from the seeded weights and drives it
through the traffic's ``checked_steps`` first steps with the same call and
feed as the window, which goes on with the same state. Every step's batch
is its own rows of seeded token ids (labels the next ids).

What is compared with the plain reference, which follows those first
steps from the same weights and batches:

* ``loss_gap``: each step's loss (the last microbatch's, as the program
  reports it), the worst relative gap;
* ``grad_norm_gap``: each leaf's gradient as the optimizer took it in at
  step 1, read back from its first moment (m = (1 - b1) g);
* ``change_norm_gap``: each leaf's change after the checked steps.

Both norm gaps are the worst leaf's |program - reference| over the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's (a key
bias under softmax) move by round-off alone and are left out of the
change. Every loss of the window must be finite.
"""

from __future__ import annotations

import statistics
import sys

import torch

from klbench.harness import Check, annotation
from klbench.reference import decoder as R
from klbench.seeds import generator
from klbench.weights import decoder_params, flatten

from ._lm import arch_config

DEAD_LEAF = 1e-3


def norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    leaves = list(ref) if leaves is None else leaves
    med = statistics.median(ref[p] for p in leaves)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in leaves)


def leaf_norms(tree, scale: float = 1.0) -> dict:
    return {path: float(torch.linalg.vector_norm(t.to(torch.float32)))
            * scale for path, t in flatten(tree)}


class Loop:
    def __init__(self, run):
        self.run = run
        self.c = run.config
        self.t = run.traffic
        self.opt_cfg = {"lr": self.t["lr"], **self.t["adamw"]}
        self.losses: list = []

    def batch(self, i: int) -> dict:
        j = i % len(self.tokens)
        return {"tokens": self.tokens[j], "labels": self.labels[j]}

    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.optim import AdamW
        from repro_torch.train import step as S
        run, t = self.run, self.t
        model = build_model(arch_config(self.c), device=run.device,
                            remat=t["remat"])
        opt = AdamW(**self.opt_cfg)
        self.step_fn = S.make_train_step(model, opt,
                                         microbatches=t["microbatches"])
        run.mark("program imported")
        ids = torch.randint(
            self.c["vocab_size"], (t["pool"], t["batch"], t["seq"] + 1),
            dtype=torch.int64,
            generator=generator(run.seed, "tokens", run.device),
            device=run.device)
        self.tokens = ids[..., :-1].contiguous()
        self.labels = ids[..., 1:].contiguous()
        del ids
        params = decoder_params(self.c, run.seed, run.device)
        self.state = {"params": params, "opt": opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=run.device)}
        del params
        run.mark("weights, batches and optimizer state made")
        self.prog = {"losses": []}
        for i in range(t["checked_steps"]):
            self.state, m = self.step_fn(self.state, self.batch(i))
            self.prog["losses"].append(float(m["loss"]))
            if i == 0:
                self.prog["grad_norms"] = leaf_norms(
                    self.state["opt"]["m"], 1.0 / (1.0 - self.opt_cfg["b1"]))
        run.mark(f"{t['checked_steps']} checked steps run")
        p0 = dict(flatten(decoder_params(self.c, run.seed, run.device)))
        self.prog["change"] = {
            path: float(torch.linalg.vector_norm(
                t.to(torch.float32) - p0[path].to(torch.float32)))
            for path, t in flatten(self.state["params"])}
        del p0
        self.first = t["checked_steps"]

    def step(self, i: int, annotate: bool) -> int:
        b = self.batch(self.first + i)
        with annotation(annotate, "klbench.train_step"):
            self.state, m = self.step_fn(self.state, b)
        self.losses.append(m["loss"])
        return b["tokens"].numel()

    def metrics(self, win) -> dict:
        return {"train_tokens_per_s": (win.work / win.elapsed_s,
                                       "tokens/s")}

    def context(self, win) -> dict:
        return {"config": self.c, "batch": self.t["batch"],
                "seq": self.t["seq"], "steps": win.steps}

    def finish(self, win) -> tuple[int, int]:
        self.nonfinite = int((~torch.isfinite(torch.stack(
            self.losses))).sum()) if self.losses else 0
        return win.steps, self.nonfinite

    def release(self) -> None:
        del self.state, self.step_fn

    def reference(self, fp8: bool = False, rows=None) -> dict:
        return R.train(self.c, decoder_params(self.c, self.run.seed,
                                              self.run.device),
                       [self.batch(i) for i in range(self.first)],
                       self.opt_cfg, self.t["microbatches"], self.first,
                       fp8=fp8, rows=rows)

    def check(self, prog: dict | None = None) -> list[Check]:
        """The program's readings (or ``prog``'s: a control's) against the
        reference's."""
        prog = self.prog if prog is None else prog
        ref = self.reference()
        return readings_checks(prog, ref, self.run.limits,
                               getattr(self, "nonfinite", 0))


def readings_checks(prog: dict, ref: dict, lim: dict,
                    nonfinite: int = 0) -> list[Check]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    live = [p for p in g if g[p] >= DEAD_LEAF * med]
    print(f"klbench: {len(g) - len(live)} of {len(g)} leaves left out of "
          f"the change", file=sys.stderr)
    return [Check("loss_gap", loss, lim["loss_gap"]),
            Check("grad_norm_gap", norm_gap(prog["grad_norms"], g),
                  lim["grad_norm_gap"]),
            Check("change_norm_gap",
                  norm_gap(prog["change"], ref["change"], live),
                  lim["change_norm_gap"]),
            Check("nonfinite_losses", nonfinite, 0)]
