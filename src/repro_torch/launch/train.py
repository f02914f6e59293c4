"""End-to-end training command line; counterpart of
``repro/launch/train.py``, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 200 --ckpt-dir build/ckpt [--device cpu]

``--smoke`` uses the arch's reduced config (CPU-runnable ~100M-and-below);
without it the exact assigned config is used.  The loop is fault-tolerant:
kill it at any step and rerun the same command — it resumes from the latest
complete checkpoint with an identical trajectory.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.train.adamw import tree_leaves
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import TrainConfig, init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--vocab", type=int, default=0, help="override vocab")
    ap.add_argument("--heads", type=int, default=0, help="override heads")
    ap.add_argument("--d-ff", type=int, default=0, help="override ffn width")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.d_model:
        cfg = cfg.with_(d_model=args.d_model)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.vocab:
        cfg = cfg.with_(vocab=args.vocab)
    if args.heads:
        cfg = cfg.with_(n_heads=args.heads, n_kv=min(cfg.n_kv, args.heads))
    if args.d_ff:
        cfg = cfg.with_(d_ff=args.d_ff)
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    tcfg = TrainConfig(peak_lr=args.lr, warmup=max(args.steps // 20, 5),
                       total_steps=args.steps, schedule=schedule,
                       ce_chunk=min(128, args.seq), attn_impl="dense",
                       compress_grads=args.compress_grads)

    pipe = TokenPipeline(PipelineConfig(args.batch, args.seq, cfg.vocab,
                                        seed=args.seed), cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_state(cfg, tcfg, gen, device)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] arch={cfg.name} params={n_params:,} schedule={schedule} "
          f"device={device}")

    loop = TrainLoop(make_train_step(cfg, tcfg), pipe,
                     LoopConfig(max_steps=args.steps, ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt_dir, log_every=10))
    t0 = time.time()
    loop.run(state)
    losses = loop.losses()
    if losses:
        print(f"[train] done in {time.time() - t0:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"stragglers={loop.straggler_events}")
    return loop


if __name__ == "__main__":
    main()
