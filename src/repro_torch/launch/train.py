"""LM training launcher: synthetic data, the train step, checkpoints.

The counterpart of ``repro/launch/train.py``, with ``--device`` (default
``cuda``; raises without a GPU). The step is ``make_train_step`` with the
reference's AdamW and cosine schedule. A checkpoint holds ``{"p":
params, "o": opt_state}`` in the reference's npz layout (the layers
stacked, ``interop.to_reference_tree``), so a run of either package
resumes from the other's checkpoints. Both draw their weights from
``--seed``, each with its own generator, so the two start from different
weights.

Usage:
  python -m repro_torch.launch.train --arch smollm-135m --steps 200   # card
  python -m repro_torch.launch.train --device cpu --arch smollm-135m --smoke
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import restore, save_pytree
from repro_torch.configs import get_config
from repro_torch.data.synthetic_lm import SyntheticLM
from repro_torch.interop import (load_reference_tree, reference_leaves,
                                 to_reference_tree)
from repro_torch.models import init_model, make_train_step
from repro_torch.optim import AdamW, cosine_schedule


def checkpoint_tree(leaves: dict, opt_state: dict) -> dict:
    """``{"p": params, "o": {"m", "v", "step"}}`` as the reference's
    train launcher saves it, numpy arrays in its nested layout."""
    return {"p": to_reference_tree(leaves),
            "o": {"m": to_reference_tree(opt_state["m"]),
                  "v": to_reference_tree(opt_state["v"]),
                  "step": opt_state["step"].numpy()}}


def restore_into(path: str, leaves: dict, opt_state: dict, what: str
                 ) -> int | None:
    """Load the newest checkpoint under ``path`` into the parameters and
    the optimizer state in place; returns its step, or None if there is
    none."""
    template = checkpoint_tree(leaves, opt_state)

    def as_torch(t):
        return {k: as_torch(v) for k, v in t.items()} \
            if isinstance(t, dict) else torch.from_numpy(np.asarray(t))

    restored = restore(path, as_torch(template))
    if restored is None:
        return None
    blob, step = restored
    load_reference_tree(leaves, blob["p"], what)
    load_reference_tree(opt_state["m"], blob["o"]["m"], what)
    load_reference_tree(opt_state["v"], blob["o"]["v"], what)
    opt_state["step"] = blob["o"]["step"]
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/lm")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = _device.resolve(args.device)
    model = init_model(args.seed, cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10, args.steps))
    leaves = reference_leaves(model, cfg)
    opt_state = opt.init(leaves)
    step_fn = make_train_step(cfg, opt)

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)

    start = restore_into(args.ckpt_dir, leaves, opt_state, cfg.name) or 0
    if start:
        print(f"resumed from step {start}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in data.batch(step).items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            tok_s = (step + 1 - start) * args.batch * args.seq / dt
            print(
                f"step {step+1:5d} loss={losses[-1]:.4f} "
                f"({tok_s:,.0f} tok/s)", flush=True,
            )
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            save_pytree(args.ckpt_dir, checkpoint_tree(leaves, opt_state),
                        step + 1)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
