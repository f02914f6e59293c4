"""The chip's published peaks, the least time a job could take on it, and
the columns a job over a join reads.

``bound`` is a frozen copy of the one-shot check's (``chip_smoke.py``).
The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
700 W limit); ``power_limit`` reads the card's own limit, which the result
line records beside every share of a peak.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional, Set

#: H100 SXM: HBM3 bytes a second, float32 operations a second off the
#: tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def bound(nbytes: int, n_ops: int, bw: float, flops: float):
    t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
    return dict(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def power_limit() -> Optional[str]:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them, or
    None where it cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def columns_read(tables, used: Set[str]) -> Dict[str, List[str]]:
    """The columns of each relation that a job over the join reads: the
    attributes in ``used`` where they first appear from the fact outward,
    and the join attributes of every edge on the way to them."""
    parent, order, frontier = {}, [tables.fact], [tables.fact]
    while frontier:
        p = frontier.pop(0)
        for a, b in tables.edges:
            for par, ch in ((a, b), (b, a)):
                if par == p and ch not in order:
                    parent[ch] = p
                    order.append(ch)
                    frontier.append(ch)
    home = {}
    for r in order:
        for a in tables.rel_attrs(r):
            home.setdefault(a, r)
    cols: Dict[str, Set[str]] = {}
    for a in used:
        r = home[a]
        cols.setdefault(r, set()).add(a)
        while r in parent:
            p = parent[r]
            keys = set(tables.rel_attrs(r)) & set(tables.rel_attrs(p))
            cols.setdefault(r, set()).update(keys)
            cols.setdefault(p, set()).update(keys)
            r = p
    return {r: sorted(c) for r, c in cols.items()}


def bytes_read(tables, used: Set[str]) -> int:
    """Four bytes a value (int32 codes, float32 values) of every column
    read, once."""
    return sum(4 * tables.n_rows(r) * len(c)
               for r, c in columns_read(tables, used).items())
