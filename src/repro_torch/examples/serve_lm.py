"""Serve a small LM with batched requests through the continuous batcher:
submit more requests than slots, watch them drain, print throughput.

Port of ``examples/serve_lm.py``, with the same reduced config and
defaults. Runs on the card (the default) or, with the plain PyTorch
versions, on the host:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_head=32,
        d_ff=1024, vocab=4096)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = ServeEngine(model, params, n_slots=args.slots, max_seq=128,
                      temperature=args.temperature)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12)),
                              dtype=np.int32)
        ok = eng.submit(Request(rid, prompt, max_new_tokens=args.max_new))
        print(f"submit #{rid} prompt_len={len(prompt)} "
              f"{'ok' if ok else 'REJECTED'}")

    t0 = time.perf_counter()
    out = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    for rid, toks in sorted(out.items()):
        print(f"request {rid}: {toks}")
    print(f"{total} tokens in {dt:.2f}s on {model.device.type} "
          f"({total / dt:.1f} tok/s across {args.slots} slots, "
          f"{eng.steps_run} decode steps, mode {out.mode})")
    return {"report": out, "tokens": total, "seconds": dt}


if __name__ == "__main__":
    main()
