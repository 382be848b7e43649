"""Train-step factory (port of ``repro.train.step``): microbatched
gradient accumulation, the model's (optionally remat'd) loss, AdamW.

The step is a function (state, batch) -> (state, metrics) that leaves its
inputs as they were. The reference jits it and scans the microbatches;
the port runs eagerly, a Python loop over the microbatches summing each
one's gradient into an ``accum_dtype`` accumulator, then dividing by
their count, the reference's arithmetic. Eager is what the reference does
in its warmup steps, so the online tick runs on every step below
``online_warmup_steps``.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable

import torch

from repro_torch.core.trip_count import loop
from repro_torch.obs import runtime as obs
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, unflatten

TrainState = dict  # {"params": ..., "opt": ..., "step": 0-d int32 tensor}


def init_train_state(model, optimizer: AdamW,
                     generator: torch.Generator | int | None = 0
                     ) -> TrainState:
    """Fresh parameters from ``generator`` (see ``DecoderLM.init``), zero
    optimiser state and step 0, on the model's device."""
    params = model.init(generator)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def import_dynamo_off_stack() -> None:
    """Import ``torch._dynamo`` once, on a thread of its own.

    torch imports it lazily, on the first call of a function it wraps in
    ``torch._disable_dynamo`` (``torch.utils.checkpoint.checkpoint``, which
    the loss and remat call). That import leaves one of its frames in a
    reference cycle (``torch.fx.wrap`` keeps ``inspect.currentframe()``
    in a local), and the frame's ``f_back`` chain pins every frame of the
    calling stack: in a train step, the train state itself stays alive
    after the caller drops it, until the cycle collector runs. On a
    thread of its own the import pins that thread's frames alone."""
    if "torch._dynamo" not in sys.modules:
        t = threading.Thread(target=__import__, args=("torch._dynamo",))
        t.start()
        t.join()


def move_batch(batch: dict, device: torch.device) -> dict:
    """Every leaf of ``batch`` (numpy arrays from the data pipeline, or
    tensors) as a tensor on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model, optimizer: AdamW,
                    microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    online=None, online_warmup_steps: int = 20) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_dtype``: gradient-accumulator dtype (with ``microbatches`` >
    1; one microbatch keeps the parameters' dtype, as the reference).
    ``online``: an ``repro_torch.online.OnlineTuner`` (or a list of them)
    ticked once before each step below ``online_warmup_steps``. The batch
    moves to the model's device; its leading axis splits into
    ``microbatches`` consecutive slices, and the metrics are the last
    one's, as the reference's scan leaves them. The microbatch loop is
    ``core.trip_count.loop``: a dry-run's counter on ``meta`` tensors may
    run one microbatch and count it ``microbatches`` times."""
    import_dynamo_off_stack()
    if online is None:
        online = []
    elif not isinstance(online, (list, tuple)):
        online = [online]

    def grad_fn(params, mb):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = model.loss(unflatten(params, flat), mb)
        # a leaf the loss never reads (whisper's cross-attention gates)
        # gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        if microbatches == 1:
            grads, metrics = grad_fn(params, batch)
            return unflatten(params, grads), metrics
        n = next(iter(batch.values())).shape[0] // microbatches
        with obs.span("accumulate", "model", model.device):
            acc = [torch.zeros_like(p, dtype=accum_dtype)
                   for p in leaves(params)]
        for i in loop(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            grads, metrics = grad_fn(params, mb)
            with obs.span("accumulate", "model", model.device):
                for a, g in zip(acc, grads):
                    a.add_(g.to(accum_dtype))
            del grads
        with obs.span("accumulate", "model", model.device):
            for a in acc:
                a.div_(microbatches)
        return unflatten(params, acc), metrics

    def train_step(state: TrainState, batch: dict):
        if online and int(state["step"]) < online_warmup_steps:
            for svc in online:
                svc.tick()
        batch = move_batch(batch, model.device)
        grads, metrics = accumulate(state["params"], batch)
        params, opt, opt_metrics = optimizer.update(grads, state["opt"],
                                                    state["params"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                metrics)

    return train_step
