"""Serving command line: batched greedy decoding with a reduced config;
counterpart of ``repro/launch/serve.py``, on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --batch 4 --prompt-len 8 --gen 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_params
from repro_torch.serve.engine import BatchedServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, device)
    rng = np.random.default_rng(args.seed)
    context = None                       # raw vision embeddings or frames
    if cfg.family in ("vlm", "audio"):
        n = cfg.vision_tokens if cfg.family == "vlm" else cfg.encoder_frames
        context = 0.02 * rng.standard_normal(
            (args.batch, n, cfg.d_model)).astype(np.float32)
    server = BatchedServer(cfg, params, max_len=args.prompt_len + args.gen,
                           batch=args.batch, device=device, context=context)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = server.generate(prompts, args.gen)
    dt = time.time() - t0
    tps = args.batch * args.gen / dt
    print(f"[serve] arch={cfg.name} device={device} generated {out.shape} in "
          f"{dt:.2f}s ({tps:.1f} tok/s batched greedy)")
    print("[serve] sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
