"""Cross-pod synchronization with int8 compression + error feedback (port
of ``repro.runtime.crosspod``).

Local-SGD style (DiLoCo-flavoured): each pod runs H inner steps
independently, then pods exchange the parameter *delta* since the last
sync, int8-quantized with an error-feedback residual so the compression
is unbiased over time. Bandwidth per sync drops 4x (f32) / 2x (bf16) plus
the 1/H amortization. Pods are simulated as independent replicas
(separate parameter trees) on one device; the same arithmetic drives a
real deployment where the exchange is an all-reduce across pods.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass
class CrossPodSync:
    n_pods: int
    inner_steps: int = 8           # H: steps between syncs
    outer_lr: float = 1.0          # SGD on the averaged delta

    residuals: list = field(default_factory=list)  # error feedback per pod

    def init(self, params) -> list:
        """Per-pod replica states + residuals."""
        self.residuals = [
            tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
            for _ in range(self.n_pods)]
        return [params for _ in range(self.n_pods)]

    def should_sync(self, step: int) -> bool:
        return step > 0 and step % self.inner_steps == 0

    def sync(self, anchor, pod_params: list) -> tuple:
        """anchor: params at the last sync; pod_params: per-pod current.
        Returns (new_anchor, new per-pod params, stats)."""
        n = self.n_pods
        flat_anchor = leaves(anchor)
        deltas_q = []
        bytes_raw = bytes_sent = 0
        for pi in range(n):
            qs, new_r = [], []
            for a, p, r in zip(flat_anchor, leaves(pod_params[pi]),
                               leaves(self.residuals[pi])):
                delta = p.to(torch.float32) - a.to(torch.float32)
                q, scale, err = compress_int8(delta, r)
                qs.append((q, scale))
                new_r.append(err)
                bytes_raw += delta.numel() * 4
                bytes_sent += q.numel() * 1 + 4
            self.residuals[pi] = unflatten(anchor, new_r)
            deltas_q.append(qs)
        # all-reduce (mean) of the decompressed deltas across pods
        mean_delta = []
        for li, a in enumerate(flat_anchor):
            acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            for pi in range(n):
                q, scale = deltas_q[pi][li]
                acc = acc + decompress_int8(q, scale)
            mean_delta.append(acc / n)
        new_anchor = unflatten(anchor, [
            (a.to(torch.float32) + self.outer_lr * d).to(a.dtype)
            for a, d in zip(flat_anchor, mean_delta)])
        new_pods = [new_anchor for _ in range(n)]
        stats = {"bytes_raw": bytes_raw, "bytes_sent": bytes_sent,
                 "compression": bytes_raw / max(bytes_sent, 1)}
        return new_anchor, new_pods, stats
