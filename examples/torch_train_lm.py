"""End-to-end LM training on the port (~100M params, a few hundred steps);
counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py                 # ~100M, 200 steps, the card
    PYTHONPATH=src python examples/torch_train_lm.py --quick --device cpu   # tiny, 60 steps

Exercises the full training substrate: deterministic pipeline, AdamW + cosine
schedule, chunked CE, fault-tolerant loop with checkpoints (kill it mid-run
and rerun — it resumes bit-identically).  Checkpoints go under the
repository's ``build/`` unless ``--ckpt-dir`` says otherwise; a run resumes
from whatever is there.
"""

import argparse
import os

from repro_torch.launch import train as train_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--ckpt-dir", default=os.path.join(REPO, "build",
                                                       "torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.quick:
        argv = ["--arch", args.arch, "--smoke", "--steps", "60",
                "--batch", "8", "--seq", "64", "--lr", "3e-3",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "20"]
    else:
        # ~100M params: d=768, 12L, ff=2048, vocab=32000 (tied embeddings)
        # a few hundred steps; resumable mid-run
        argv = ["--arch", args.arch, "--smoke", "--steps", "200",
                "--batch", "8", "--seq", "128", "--lr", "1e-3",
                "--d-model", "768", "--layers", "12", "--heads", "12",
                "--d-ff", "2048", "--vocab", "32000",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50"]
    argv += ["--device", args.device]
    loop = train_launch.main(argv)
    losses = loop.losses()
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"[example] OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return loop


if __name__ == "__main__":
    main()
