"""Batched serving launcher: teacher-forced prefill through the decode
step, then greedy decode, with KV caches.

The counterpart of ``repro/launch/serve.py``, with ``--device`` (default
``cuda``; raises without a GPU). Usage:
  python -m repro_torch.launch.serve --arch smollm-135m          # the card
  python -m repro_torch.launch.serve --device cpu --arch smollm-135m --smoke
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.models import init_caches, init_model, make_decode_step
from repro_torch.models.lm import cast_params


@torch.inference_mode()
def generate(cfg, *, batch: int = 4, prompt_len: int = 32, new: int = 16,
             seed: int = 0, device=None, model=None) -> dict:
    """The serving loop of ``main`` on ``cfg``: weights from ``seed`` (or
    ``model``), a prompt drawn from seed 1, prompt_len teacher-forced
    decode steps, then ``new`` greedy tokens. Returns the sequence and the
    loop's wall seconds, ended by a device synchronise on the card."""
    dev = _device.resolve(device)
    if model is None:
        model = init_model(seed, cfg, device=dev)
    model = cast_params(model, cfg)
    B, S = batch, prompt_len
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev,
                           dtype=torch.int64)

    # prefill: run the prompt through the decode path to warm the cache
    # (single-step decode per position keeps one code path)
    caches = init_caches(cfg, B, S + new, dev)
    decode = make_decode_step(cfg)
    extras = {}
    if cfg.family == "encdec":
        extras["enc_out"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                        dtype=torch.float32, device=dev)
    t0 = time.time()
    tok = prompt[:, :1]
    out = [tok]
    for i in range(S + new - 1):
        nxt, caches = decode(model, {"tokens": tok, **extras}, caches)
        tok = prompt[:, i + 1:i + 2] if i + 1 < S else nxt[:, None]
        out.append(tok)
    seq = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(seq=seq, seconds=time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    B, S = args.batch, args.prompt_len
    r = generate(cfg, batch=B, prompt_len=S, new=args.new, seed=args.seed,
                 device=args.device)
    seq, dt = r["seq"], r["seconds"]
    print(f"generated {B}x{args.new} tokens in {dt:.2f}s "
          f"({B * (S + args.new) / dt:.1f} tok/s inc. prefill)")
    print("sample:", seq[0, -args.new:].tolist())
    return seq


if __name__ == "__main__":
    main()
