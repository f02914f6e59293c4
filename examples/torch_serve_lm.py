"""Batched serving on the port: greedy decode with KV caches; counterpart
of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch llama3-8b [--device cpu]
"""

import argparse

from repro_torch.launch import serve as serve_launch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_launch.main(["--arch", args.arch, "--batch", "4",
                              "--prompt-len", "8", "--gen", "24",
                              "--device", args.device])


if __name__ == "__main__":
    main()
