"""End-to-end driver: train a small LM for a few hundred steps on the
deterministic synthetic pipeline, with checkpoints, watchdog, and restart;
kill it mid-run and re-invoke to see it resume.

Port of ``examples/train_lm.py``, with the same reduced config, flags and
defaults, plus ``--device``. Runs on the card (the default) or, with the
plain PyTorch versions, on the host:

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
        [--arch ID] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import StepWatchdog, TrainDriver
from repro_torch.train import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # a small variant of the chosen architecture (the reference's)
    cfg = get_arch(args.arch).reduced(
        n_layers=4, d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=8192, max_seq=4096)
    model = build_model(cfg, device=args.device, remat=True)
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M "
          f"device={model.device.type}")

    optimizer = AdamW(lr=cosine_schedule(3e-4, warmup=20,
                                         total=args.steps))
    dataset = SyntheticTokenDataset(vocab=cfg.vocab, seq=args.seq,
                                    global_batch=args.batch, seed=17)
    driver = TrainDriver(
        model=model, optimizer=optimizer,
        train_step=make_train_step(model, optimizer, microbatches=2),
        dataset=dataset,
        ckpt=CheckpointManager(args.ckpt_dir, keep=3, save_every=25),
        total_steps=args.steps,
        watchdog=StepWatchdog(),
        log_every=10,
    )
    out = driver.run(torch.Generator(device=model.device).manual_seed(0))
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f}; mean "
              f"of the first 5 {np.mean(losses[:5]):.4f}, of the last 5 "
              f"{np.mean(losses[-5:]):.4f}")
    print(f"final checkpoint: {out['final_checkpoint']}")
    if out["stragglers"]:
        print(f"stragglers observed: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
