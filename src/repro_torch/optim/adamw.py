"""AdamW with f32 moments and global-norm clipping (port of
``repro.optim.adamw``). Parameters, gradients and moments are trees of
tensors (``repro_torch.tree``); the update is functional, as the
reference's: it returns new parameters and a new state and leaves its
inputs as they were. The arithmetic is the reference's step for step:
bias correction from the step count, decoupled weight decay on the f32
parameter, the result cast to the parameter's dtype."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.obs import runtime as obs
from repro_torch.tree import leaves, tree_map, unflatten


def clip_by_global_norm(grads, max_norm: float):
    flat = leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                           for g in flat))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params) -> dict:
        """Zero f32 moments beside each parameter and a 0-d int32 step
        count, on the parameters' device."""
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                    device=p.device)
        device = leaves(params)[0].device
        return {"m": tree_map(f32, params), "v": tree_map(f32, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, count):
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> tuple:
        """Returns (new_params, new_state, metrics), under the span
        ``optimizer`` (clipping and the moment and parameter passes)
        unless the state is shapes only."""
        with obs.span("optimizer", "model", state["count"].device):
            return self._update(grads, state, params)

    def _update(self, grads, state: dict, params) -> tuple:
        gnorm = torch.zeros((), dtype=torch.float32,
                            device=state["count"].device)
        if self.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        count = state["count"] + 1
        lr = self._lr(count)
        c1 = 1.0 - self.b1 ** count.to(torch.float32)
        c2 = 1.0 - self.b2 ** count.to(torch.float32)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m = self.b1 * m + (1 - self.b1) * g32
            v = self.b2 * v + (1 - self.b2) * g32 * g32
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            step = step + self.weight_decay * p.to(torch.float32)
            return m, v, (p.to(torch.float32) - lr * step).to(p.dtype)

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            leaves(grads), leaves(state["m"]), leaves(state["v"]),
            leaves(params))]
        new_state = {"m": unflatten(params, [o[0] for o in out]),
                     "v": unflatten(params, [o[1] for o in out]),
                     "count": count}
        return (unflatten(params, [o[2] for o in out]), new_state,
                {"grad_norm": gnorm, "lr": lr})
