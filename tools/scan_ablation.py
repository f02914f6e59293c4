"""Old against new, and each design choice taken back, for the port's scan
kernels (``csrc/seg_reduce.cuh``: ``seg_aggregate``, ``fused_scan_block``,
``tree_hist_batched``) and ``covar_xtx`` on an H100: builds each variant
into its own shared library, checks it against the plain version and times
it, in turns, in one process.

    PYTHONPATH=src python3 tools/scan_ablation.py [--reps 20] [--old DIR] [--no-xtx]
    PYTHONPATH=src python3 tools/scan_ablation.py --sites 1400
    PYTHONPATH=src python3 tools/scan_ablation.py --host-profile [--tree-scale 1400]
    PYTHONPATH=src python3 tools/scan_ablation.py --ranges [--reps 3]

``--old DIR`` holds the kernel sources of an earlier commit (every file of
its ``csrc``, e.g. from ``git archive <commit> src/repro_torch/kernels/csrc``
unpacked into a directory that ``.gitignore`` lists), whose scan kernels ran
``fused_scan_block`` and the tree histograms on a column-tile kernel and
``seg_aggregate`` on a one-reduction ``seg_reduce.cuh``; they are driven
through the earlier wrappers' host geometry, which :func:`old_launch_plan`
(the column tiles) and :func:`old_seg` reproduce.

Cases, at 1,000,003 rows, codes about 4% out of range on each side:
``seg_aggregate`` at 4,960 x 99 (segment ranges), 4,800 x 1 and 480 x 20
(one block); ``fused_scan_block`` at ``chip_smoke.py``'s three plan steps,
packed as the reference packs them (covar fact: 4,960 x 99 in ranges beside
40 x 4 and 480 x 20; covar Items: 4,800 x 1, 3,840 x 1, 12,000 x 1 and a
480-bucket histogram; tree fact: 4,960 x 48 beside two 16-node histograms),
and the covar fact step as the lowering passes it (``fact_parts``: one part
per aggregate column, 45 columns of their own and five row-major pulled
blocks), beside the ``torch.stack`` and ``torch.cat`` that would pack it,
and the tree fact step so (``tree_fact_parts``: 48 columns of their own,
two 16-node histograms over a transposed mask, y formed on the card);
``tree_hist_batched`` at 480 buckets x 16 nodes, random and frontier masks.

Variants of the scan kernels, each a patch of the committed
``seg_reduce.cuh``:

- ``kernel``: the sources as committed;
- ``one_stage``: one-block SEG with a ring of one stage of rows;
- ``batch1``: range mode with one listed row a warp in flight, not 8;
- ``rows_batch4``: one-block SEG with four rows a thread in flight, not 1;
- ``hist_batch1``, ``hist_batch2``: one-block HIST with one or two rows a
  thread in flight, not 4;
- ``hist_ranges``: a histogram that fits one block summed in segment
  ranges instead (its rows counting-sorted by bucket, runs summed in
  registers); ``stages_32k``, ``stages_8k``: one-block SEG ring stages of
  32 or 8 KB, not 16: the committed kernels under other host geometries;
- ``column_tiles``: a reduction of several parts too wide for one block
  (the lowering's fact buckets) cut into column tiles of the one-block
  kernel, every row's few columns staged coalesced (:func:`tile_layout`),
  not segment ranges, which read a listed row's values part by part;
- ``transposed_lanes``: one-block HIST over a transposed mask with lanes
  on neighbouring rows of one cond (its loads coalesced), not on the conds
  of a row;
- ``one_copy``: the one-block modes add into one copy of the accumulator,
  not one for every few warps (a patch of the adds only: the copies are
  still zeroed and folded);
- ``hist_cas``: one-block HIST adds a cond's three values as three
  compare-and-swaps issued together, not one ``atomicAdd`` after another;
- ``cas_batched``: one-block SEG adds with compare-and-swaps issued
  together (range mode's), not one ``atomicAdd`` after another;
- ``no_fast_path``: range mode addresses a one-part reduction's loads as
  any other's, column by column;
- ``combine_one_group``: a combine block's threads each sum all chunks of
  one word, not eight groups of them where an item has 64 chunks or more;
- ``old``: the earlier kernels (``--old``).

Variants of ``covar_xtx`` (F = 70 and 142, one group of pieces; 173,
TPC-DS's width, in two groups of pieces):

- ``kernel``; ``one_stage`` (a ring of one raw stage); ``rows32`` (steps
  of 32 rows where the kernel takes 48); ``no_two_level`` (the wgmma
  accumulators take the whole chunk, never promoted); ``promote2`` and
  ``promote4`` (promoted after every 2 or 4 steps of rows, not every one);
  ``one_tf32`` (hi.hi only, reported for its error); ``old`` (``--old``).

Each variant's error is reported against the plain version on random
inputs (max |Δ| ÷ Σ|terms|) and, for ``covar_xtx``, against float64 on
gathered-like features whose few values repeat in every row.  Each case is
timed in turns (every variant, then every variant in reverse order) with
CUDA events, beside the PyTorch calls that compute the same function
(``index_add_``: one per reduction, on payloads formed beforehand;
``torch.mm``).  One JSON line a variant and case, then the card's name and
power limit.  Needs a CUDA card and ``nvcc``.

``--ranges`` instead times range mode's two paths on one reduction as the
covar fact bucket's plan passes it, ``RANGE_WIDTH`` one-column parts over
``RANGE_ROWS`` rows (codes about 2% outside the domain on each side), at
each of ``RANGE_COUNTS`` segment ranges (2 to the covar fact bucket's
13,170): the scan path (each range's blocks read every code of their
chunk) and the sorted path (rows counting-sorted by range once), each
forced through ``SORTED_MIN_RANGES`` in a plan cache of its own, checked
against the plain version and timed in turns, with the device time by
kernel.  Then the same for HIST at a tree level's histograms: the
``HIST_BUCKETS`` buckets of Favorita's (date, store_nbr) at each of
``HIST_NODES`` frontier nodes (0/1 masks, y formed on the card).  A line
for each kind names the fewest ranges from which the sorted path is the
faster at every count: where ``SORTED_MIN_RANGES`` belongs.

``--sites SCALE`` instead profiles one warm fused covar pass over Retailer
at that scale and attributes the device time of every ``torch.cat`` and
``torch.stack`` of the port's lowering to its call site.  ``--host-profile``
times the host side of the scan wrappers (cProfile, and each call's host
time); with ``--tree-scale SCALE`` it also fits ``chip_smoke.py``'s tree
unfused and fused over Retailer at that scale (a warm-up fit, two timed,
two under cProfile) and splits each profiled fit's host time by layer.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ROWS = 1_000_003
#: ``--ranges``: rows and one-column parts of the reduction, and its counts
#: of segment ranges
RANGE_ROWS, RANGE_WIDTH = 1 << 20, 489
RANGE_COUNTS = (2, 4, 8, 16, 32, 64, 96, 128, 160, 192, 256, 384, 512, 784, 2048, 13_170)
#: ``--ranges``, HIST: the buckets of Favorita's (date, store_nbr) and the
#: frontier nodes of a tree level's histograms over them (49 to 392 ranges)
HIST_BUCKETS = 90_936
HIST_NODES = (8, 16, 24, 32, 40, 48, 64)
#: variant -> [(text in seg_reduce.cuh, its replacement), ...]
SCAN_PATCHES = {
    "one_stage": [("constexpr int kStagesA = 4;", "constexpr int kStagesA = 1;")],
    "batch1": [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    "rows_batch4": [("constexpr int kBatchA = 1;", "constexpr int kBatchA = 4;")],
    "hist_batch1": [("constexpr int kBatchH = 4;", "constexpr int kBatchH = 1;")],
    "hist_batch2": [("constexpr int kBatchH = 4;", "constexpr int kBatchH = 2;")],
    "one_copy": [("float* acc = smem + (threadIdx.x / 32 % m.copies) * stride;",
                  "float* acc = smem;")],
    # the one-block modes' adds as range mode's: compare-and-swaps issued
    # together, retrying only those another add got to first
    "cas_batched": [("""    if (dst[i]) atomicAdd(dst[i], v[i]);
}""", """    if (dst[i]) seen[i] = __float_as_uint(*dst[i]);
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (dst[i])
      got[i] = atomicCAS(reinterpret_cast<unsigned*>(dst[i]), seen[i],
                         __float_as_uint(__uint_as_float(seen[i]) + v[i]));
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (dst[i])
      while (got[i] != seen[i]) {
        seen[i] = got[i];
        got[i] = atomicCAS(reinterpret_cast<unsigned*>(dst[i]), seen[i],
                           __float_as_uint(__uint_as_float(seen[i]) + v[i]));
      }
}"""), ("""void add_each(float* (&dst)[M], const float (&v)[M]) {
#pragma unroll""", """void add_each(float* (&dst)[M], const float (&v)[M]) {
  unsigned seen[M], got[M];
#pragma unroll""")],
    "no_fast_path": [("fast = U == 1 && m.nsrc == 1 && only.cs == 1;", "fast = false;")],
    "hist_cas": [("      for (int q = 0; q < 3; ++q) atomicAdd(d + q, cnd * yk[q]);",
                  """      unsigned seen[3], got[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) seen[q] = __float_as_uint(d[q]);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        got[q] = atomicCAS(reinterpret_cast<unsigned*>(d + q), seen[q],
                           __float_as_uint(__uint_as_float(seen[q]) + cnd * yk[q]));
#pragma unroll
      for (int q = 0; q < 3; ++q)
        while (got[q] != seen[q]) {
          seen[q] = got[q];
          got[q] = atomicCAS(reinterpret_cast<unsigned*>(d + q), seen[q],
                             __float_as_uint(__uint_as_float(seen[q]) + cnd * yk[q]));
        }""")],
    # column tiles (with the geometry of :func:`tile_layout`): rows_kernel
    # stages, of each part, the columns that the item's tile holds
    "column_tiles": [("""      for (int i = m.src0; i < m.src0 + m.nsrc; ++i) {
        const Src s = src_of(p.srcs, i);
        const float* base = s.ptr + a * s.rs;
        if (s.rs == 1 && s.width > 1) {  // rows lie together: a warp a column
          for (int c = (warp - s.col0 % kWarps + kWarps) % kWarps; c < s.width; c += kWarps)
            for (int r = lane; r < rows; r += 32)
              cp_async4(vals + r * W + s.col0 + c, base + r + c * s.cs);
        } else {  // threads laid out (row, column): a single column, every thread
          const int sl = threadIdx.x / s.width, c = threadIdx.x % s.width;
          const int sls = kThreads / s.width;
          if (sl < sls)
            for (int r = sl; r < rows; r += sls)
              cp_async4(vals + r * W + s.col0 + c, base + r * s.rs + c * s.cs);
        }
      }""",
                      """      // the item's parts, each the columns [lo, hi) of it that the tile holds
      for (int i = m.src0; i < m.src0 + m.nsrc; ++i) {
        const Src s = src_of(p.srcs, i);
        const int lo = m.col0 > s.col0 ? (int)m.col0 - s.col0 : 0;
        const int hi = min(s.width, (int)m.col0 + W - s.col0), w = hi - lo;
        if (w <= 0) continue;
        const float* base = s.ptr + a * s.rs + lo * s.cs;
        float* dst = vals + (s.col0 + lo - (int)m.col0);
        if (s.rs == 1 && w > 1) {  // rows lie together: a warp a column
          for (int c = (warp - (s.col0 + lo) % kWarps + kWarps) % kWarps; c < w; c += kWarps)
            for (int r = lane; r < rows; r += 32)
              cp_async4(dst + r * W + c, base + r + c * s.cs);
        } else {  // threads laid out (row, column): a single column, every thread
          const int sl = threadIdx.x / w, c = threadIdx.x % w, sls = kThreads / w;
          if (sl < sls)
            for (int r = sl; r < rows; r += sls)
              cp_async4(dst + r * W + c, base + r * s.rs + c * s.cs);
        }
      }""")],
    # a transposed mask's histogram with lanes on neighbouring rows of one
    # cond (coalesced loads; adds into one column of random segments)
    "transposed_lanes": [("  const int j = threadIdx.x % N, slot = threadIdx.x / N, slots = kThreads / N;\n  if (slot < slots)\n",
                          "  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n"
                          + """  if (cs.rs == 1 && N > 1) {
    // transposed: unit u = (cond u % N, rows 32 (u / N) + lane of the chunk)
    const int64_t units = N * ((r1 - r0 + 31) / 32);
    for (int64_t u0 = warp; u0 < units; u0 += (int64_t)kWarps * kBatchH) {
      int c[kBatchH], jj[kBatchH];
      float cnd[kBatchH], yk[kBatchH][3];
#pragma unroll
      for (int b = 0; b < kBatchH; ++b) {
        const int64_t u = u0 + (int64_t)b * kWarps;
        const int64_t r = r0 + (u / N) * 32 + lane;
        const bool in = u < units && r < r1;
        jj[b] = (int)(u % N);
        c[b] = in ? __ldg(code + r * m.code.rs) : -1;
        cnd[b] = in ? __ldg(cs.ptr + r + jj[b] * cs.cs) : 0.f;
        load_yk(in ? r : r0, yk[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatchH; ++b) add3(c[b], cnd[b], yk[b], jj[b]);
    }
"""
                          + "  } else {\n"
                          "  const int j = threadIdx.x % N, slot = threadIdx.x / N, slots = kThreads / N;\n  if (slot < slots)\n"),
                         ("      for (int b = 0; b < kBatchH; ++b) add3(c[b], cnd[b], yk[b], j);\n    }\n  write_partial(",
                          "      for (int b = 0; b < kBatchH; ++b) add3(c[b], cnd[b], yk[b], j);\n    }\n  }\n  write_partial(")],
    "combine_one_group": [("constexpr int kCombineGroups = 8;", "constexpr int kCombineGroups = 1;")],
}
#: variants of the host geometry, run on the committed kernels
GEOMETRY_VARIANTS = ("hist_ranges", "stages_32k", "stages_8k")
#: variants that patch the kernels and the host geometry both
PATCHED_GEOMETRY = ("column_tiles",)
#: the scan entry points, built together into one library a variant
SCAN_SOURCES = ("seg_aggregate.cu", "fused_scan.cu", "tree_hist.cu", "tree_hist_batched.cu")
#: the covar entry point's launch, where a patch may take back the
#: wrapper's choice of ring stages or step rows
XTX_LAUNCH = "  const int err = dispatch(stages, rows, Launch{"
XTX_PATCHES = {
    "no_two_level": [("constexpr int kPromote = 1;",
                      "constexpr int kPromote = 1 << 30;")],
    "promote2": [("constexpr int kPromote = 1;", "constexpr int kPromote = 2;")],
    "promote4": [("constexpr int kPromote = 1;", "constexpr int kPromote = 4;")],
    "one_stage": [("  XTX_CASE(2, 48)",
                   "  XTX_CASE(1, 48) XTX_CASE(1, 32) XTX_CASE(1, 16) XTX_CASE(2, 48)"),
                  (XTX_LAUNCH, "  stages = 1;\n  smem = smem_bytes(f, stages, rows);\n"
                   + XTX_LAUNCH)],
    "rows32": [(XTX_LAUNCH, "  if (rows == 48) rows = 32;\n"
                "  smem = smem_bytes(f, stages, rows);\n" + XTX_LAUNCH)],
    "one_tf32": [("wgmma_n48(part[p], desc(ah, kSBO), desc(bh + lo_b, kSBO), kk > 0 || !fresh);\n"
                  "          wgmma_n48(part[p], desc(ah + lo_a, kSBO), desc(bh, kSBO), 1);\n"
                  "          wgmma_n48(part[p], desc(ah, kSBO), desc(bh, kSBO), 1);\n",
                  "wgmma_n48(part[p], desc(ah, kSBO), desc(bh, kSBO), kk > 0 || !fresh);\n")],
}
SEG_CASES = ((4960, 99, ROWS), (4800, 1, 1 << 20), (480, 20, 1 << 20), (40, 4, 1 << 20))
#: chip_smoke.py's fused plan steps: (kind, segments, width, n_cond) a reduction
FUSED_CASES = {
    "fact": [("seg", 4960, 99, 0), ("seg", 40, 4, 0), ("seg", 480, 20, 0)],
    "items": [("seg", 4800, 1, 0), ("seg", 3840, 1, 0), ("seg", 12000, 1, 0),
              ("hist", 480, 3, 1)],
    "tree_fact": [("seg", 4960, 48, 0), ("hist", 40, 48, 16), ("hist", 480, 48, 16)],
}
#: the covar fact bucket's views as the lowering passes them: 45 aggregate
#: columns of one view, then five one-aggregate views of pulled widths
FACT_PART_WIDTHS = (1,) * 45 + (5, 6, 10, 25, 8)
TREE_NODES, TREE_BUCKETS = 16, 480
XTX_WIDTHS = (70, 142, 173)


def patched(text: str, patches) -> str:
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"scan_ablation: {old!r} is not in the source; "
                             "update the patches")
        text = text.replace(old, new)
    return text


def build(sources: dict, out: Path) -> dict:
    """Compile each (variant -> .cu path) into its own library, all at once."""
    from repro_torch.kernels import _build

    procs = {}
    for name, path in sources.items():
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"scan_ablation: nvcc failed on {name}:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, kind: str, old: bool):
    from repro_torch.kernels import _build

    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    if kind == "xtx":
        if not old:
            _build.bind_covar_xtx(lib)
        else:
            lib.covar_xtx.argtypes = [P, P, I64, I, I64, I, P, P, P]
            lib.covar_xtx_blocks_per_sm.argtypes = []
            lib.covar_xtx.restype = lib.covar_xtx_blocks_per_sm.restype = I
    elif not old:
        _build.bind_seg_reduce(lib)
    else:
        tail = [P, I, I, I64, I, P, P, P]   # items .. stream
        lib.fused_scan_block.argtypes = [P, I64, I64, P, I64] + tail
        lib.tree_hist.argtypes = [P, P, P, I64] + tail
        lib.tree_hist_batched.argtypes = [P, P, P, I64, I64] + tail
        # seg, n, payload, width, items, mode, n_items, n_chunks, chunk_rows,
        # part_stride, stage_rows, max_size, smem, scratch, out, stream
        lib.seg_aggregate.argtypes = [P, I64, P, I64, P, I, I, I, I64, I, I,
                                      I64, I, P, P, P]
        lib.seg_aggregate_blocks_per_sm.argtypes = [I, I]
        for fn in (lib.fused_scan_block, lib.tree_hist, lib.tree_hist_batched,
                   lib.seg_aggregate, lib.seg_aggregate_blocks_per_sm):
            fn.restype = I
    return lib


def old_covar_chunking(n: int, f: int, wave: int):
    """The earlier wrapper's chunks: a wave of 32 x 32 tile-pair blocks."""
    nt = -(-f // 32)
    pairs = nt * (nt + 1) // 2
    chunks = max(1, min(max(1, wave // pairs), -(-n // 32)))
    chunk_rows = -(-max(n, 1) // chunks)
    chunk_rows = min(1 << 16, -(-chunk_rows // 32) * 32)
    return chunk_rows, max(1, -(-n // chunk_rows)), pairs


# -- the earlier scan kernels' host geometry: the column-tile kernel's work items
# (reduction, segment range, column tile) of 1024 threads, chunks of
# about 4,096 rows while the partial tiles stay under 8 MB, at least two
# blocks an SM, none under 32 rows
OLD_THREADS, OLD_CHUNK_ROWS, OLD_SCRATCH_FLOATS, OLD_MIN_CHUNK_ROWS = 1024, 4096, 1 << 21, 32
OLD_KINDS = {"seg": 0, "hist": 1, "vec_hist": 2, "mat_hist": 3}


def old_launch_plan(specs, kinds, n: int, device):
    """(items, n_items, n_chunks, max_size, smem, scratch floats, outputs)
    of one launch of the earlier column-tile kernel: ``specs`` are (code_col, segments,
    width, pay_off, yk_off) a reduction."""
    import torch

    smem_floats = 232448 // 4
    rows, outputs, off = [], [], 0
    for (col, S, w, pay_off, yk_off), kind in zip(specs, kinds):
        k = max(1, -(-S // smem_floats))
        per = -(-S // k)
        for s0 in range(0, S, per):
            ns = min(per, S - s0)
            tile = min(w, smem_floats // ns, OLD_THREADS)
            for c0 in range(0, w, tile):
                rows.append([OLD_KINDS[kind], col, ns, w, pay_off, yk_off, c0,
                             min(tile, w - c0), off, 0, 0, 0, s0])
        outputs.append((off, S, w))
        off += S * w
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    base = -(-2 * sms // len(rows))
    scratch = 0
    for r in rows:
        size = r[2] * r[7]
        want = max(base, min(-(-n // OLD_CHUNK_ROWS), OLD_SCRATCH_FLOATS // size))
        chunks = max(1, min(-(-n // OLD_MIN_CHUNK_ROWS), want))
        chunk_rows = -(-n // chunks)
        r[9], r[10], r[11] = scratch, -(-n // chunk_rows), chunk_rows
        scratch += r[10] * size
    max_size = max(r[2] * r[7] for r in rows)
    items = torch.tensor(rows, dtype=torch.int64, device=device)
    return items, len(rows), max(r[10] for r in rows), max_size, 4 * max_size, scratch, outputs


def old_run(entry, args, plan, device):
    import torch

    items, n_items, n_chunks, max_size, smem, scratch_n, outputs = plan
    off, s, w = outputs[-1]
    out = torch.empty(off + s * w, device=device)
    scratch = torch.empty(scratch_n, device=device)
    err = entry(*args, items.data_ptr(), n_items, n_chunks, max_size, smem,
                scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"scan_ablation: the earlier {entry.__name__} failed ({err})")
    return tuple(out[o:o + S * W].view(S, W) for o, S, W in outputs)


def old_fused(lib, codes, fpay, specs):
    plan = _old_plan(("fused",) + tuple(specs), lambda: old_launch_plan(
        [(sp.code_col, sp.n_segments, sp.width, sp.pay_off, sp.yk_off) for sp in specs],
        [sp.kind for sp in specs], codes.shape[0], codes.device))
    return old_run(lib.fused_scan_block, [codes.data_ptr(), codes.shape[0], codes.shape[1],
                                          fpay.data_ptr(), fpay.shape[1]], plan, codes.device)


def old_tree_hist_batched(lib, codes, y, cond, n_buckets):
    n, n_cond = cond.shape
    plan = _old_plan(("thb", n, n_cond, n_buckets), lambda: old_launch_plan(
        [(0, n_buckets, 3 * n_cond, 0, 0)], ["mat_hist"], n, codes.device))
    (out,) = old_run(lib.tree_hist_batched, [codes.data_ptr(), y.data_ptr(), cond.data_ptr(),
                                             n, n_cond], plan, codes.device)
    return out.view(n_buckets, n_cond, 3).permute(1, 0, 2).contiguous()


_OLD_PLANS = {}


def _old_plan(key, make):
    if key not in _OLD_PLANS:
        _OLD_PLANS[key] = make()
    return _OLD_PLANS[key]


def old_seg(lib, seg, pay, n_segments):
    """The earlier seg_aggregate (one reduction of seg_reduce.cuh) through
    its own geometry: the layout and chunks are today's, its items five
    fields each."""
    import torch

    from repro_torch.kernels import seg_aggregate as kseg

    n, width = pay.shape
    lay = kseg.seg_layout(n_segments, width)

    def make():
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        wave = lib.seg_aggregate_blocks_per_sm(lay.mode, lay.smem_bytes) * sms
        chunk_rows, n_chunks = kseg.seg_chunks(n, len(lay.items), wave)
        span = n_chunks * lay.part_stride
        items = [list(it[:4]) + [i * span] for i, it in enumerate(lay.items)]
        return (torch.tensor(items, dtype=torch.int64, device=seg.device), chunk_rows,
                n_chunks, len(lay.items) * span)

    items, chunk_rows, n_chunks, scratch_n = _old_plan(("seg", n, n_segments, width), make)
    out = torch.empty((n_segments, width), device=seg.device)
    scratch = torch.empty(scratch_n, device=seg.device)
    err = lib.seg_aggregate(seg.data_ptr(), n, pay.data_ptr(), width, items.data_ptr(),
                            lay.mode, len(lay.items), n_chunks, chunk_rows, lay.part_stride,
                            lay.stage_rows, lay.max_size, lay.smem_bytes, scratch.data_ptr(),
                            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"scan_ablation: the earlier seg_aggregate failed ({err})")
    return out


def old_covar(lib, x, w):
    import torch

    n, f = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk_rows, n_chunks, pairs = old_covar_chunking(
        n, f, lib.covar_xtx_blocks_per_sm() * sms)
    out = torch.empty((f, f), device=x.device)
    scratch = torch.empty(n_chunks * pairs * 1024, device=x.device)
    err = lib.covar_xtx(x.data_ptr(), w.data_ptr(), n, f, chunk_rows, n_chunks,
                        scratch.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"scan_ablation: the earlier covar_xtx failed ({err})")
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def scaled_err(got, want, scale) -> float:
    return float(((got.double() - want.double()).abs() / (scale.double() + 1e-30)).max())


def site_attribution(scale: float, block_size: int, seed: int) -> None:
    """Device time of every ``torch.cat`` and ``torch.stack`` call in the
    port's lowering during one warm, fused covar pass over Retailer at
    ``scale``, by call site (file:line of the caller): each call runs inside
    a ``record_function`` range named for its site, and the profiler sums
    the device time of the kernels launched inside each range.  One JSON
    line a site, then the pass's totals."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.api import ExecutionConfig, connect
    from repro_torch.data import datasets as TD
    from repro_torch.ml.covar import compute_covar

    ds = TD.make("retailer", scale=scale, seed=seed)
    db = connect(ds, config=ExecutionConfig(block_size=block_size), device="cuda")
    _, _, _, batch = compute_covar(ds, database=db)
    batch(db.data)
    torch.cuda.synchronize()

    originals = {"cat": torch.cat, "stack": torch.stack}

    def traced(name):
        fn = originals[name]

        def call(*a, **k):
            frame = sys._getframe(1)
            path = frame.f_code.co_filename
            if "repro_torch" not in path:
                return fn(*a, **k)
            rel = path[path.index("repro_torch"):]
            with record_function(f"site {name} {rel}:{frame.f_lineno} "
                                 f"{frame.f_code.co_name}"):
                return fn(*a, **k)
        return call

    torch.cat, torch.stack = traced("cat"), traced("stack")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batch(db.data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.cat, torch.stack = originals["cat"], originals["stack"]
    sites, kernels, busy = {}, {}, 0.0
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = ev.cuda_time_total
        if ev.key.startswith("site "):
            sites[ev.key] = (dev / 1e3, ev.count)
    from torch.autograd import DeviceType
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            busy += ms
            if "Cat" in e.name or "cat" in e.name:
                kernels[e.name[:80]] = kernels.get(e.name[:80], 0.0) + ms
    for key, (ms, count) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"site": key[5:], "device_ms": ms, "calls": count}), flush=True)
    print(json.dumps({"sites_total_device_ms": sum(v[0] for v in sites.values()),
                      "cat_kernels_ms": kernels, "device_busy_ms": busy,
                      "profiled_wall_s": wall, "scale": scale,
                      "fact_rows": db.sizes()[ds.fact], "block_size": block_size}),
          flush=True)


@contextlib.contextmanager
def hist_in_ranges():
    """Every histogram in segment ranges, for the launches planned inside."""
    from repro_torch.kernels import seg_aggregate as kseg

    keep = kseg.hist_layout
    kseg.hist_layout = lambda S, n_cond: kseg.range_layout(S, 3 * n_cond, 3)
    try:
        yield
    finally:
        kseg.hist_layout = keep


@contextlib.contextmanager
def patched_geometry(name: str):
    """The host geometry of variant ``name``, for the launches planned
    inside: every histogram in segment ranges, or ring stages of another
    size."""
    from repro_torch.kernels import seg_aggregate as kseg

    if name == "hist_ranges":
        with hist_in_ranges():
            yield
        return
    if name == "column_tiles":
        keep = kseg.shape_layout

        def tiled(sh):
            if (sh.kind == "seg" and len(sh.parts) > 1
                    and not kseg.fits_one_block(sh.n_segments, sh.acc_width)):
                return tile_layout(sh.n_segments, sh.acc_width) or keep(sh)
            return keep(sh)
        kseg.shape_layout = tiled
        try:
            yield
        finally:
            kseg.shape_layout = keep
        return
    keep = kseg.STAGE_BYTES_A
    kseg.STAGE_BYTES_A = int(name[7:-1]) * 1024
    try:
        yield
    finally:
        kseg.STAGE_BYTES_A = keep


def tile_layout(n_segments: int, width: int):
    """The ``column_tiles`` variant's items of a reduction of several parts
    whose accumulator does not fit one block: one-block mode cut into tiles
    of at most t columns with all segments, each block reading those
    columns of every row (a part of one column coalesced, where range mode
    reads a sector a value); t the widest whose accumulator and ring fit one
    block an SM.  None where no column fits."""
    from repro_torch.kernels import seg_aggregate as kseg

    t = 0
    while t < min(width, kseg.THREADS) and kseg.smem_a(n_segments, t + 1) <= kseg.SMEM_BYTES:
        t += 1
    if t == 0:
        return None
    tiles = kseg._even(width, -(-width // t))
    t = max(k for _, k in tiles)
    size = n_segments * t
    return kseg.SegLayout(mode=0, items=tuple((0, n_segments, c0, k, 0) for c0, k in tiles),
                          smem_bytes=kseg.smem_a(n_segments, t),
                          stage_rows=kseg.stage_rows_a(t),
                          part_stride=-(-size // 4) * 4, max_size=size)


def geometry_variant(name: str, fn):
    """``fn`` run under the host geometry of variant ``name``."""
    def call():
        with patched_geometry(name):
            return fn()
    return call if name in GEOMETRY_VARIANTS + PATCHED_GEOMETRY else fn


def spilled_codes(S: int, n: int, gen):
    import torch

    spill = max(1, S // 25)
    return torch.randint(-spill, S + spill, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)


def fused_inputs(rows, n: int, gen):
    """codes (n, C) about 4% outside each domain on each side, and a payload
    packed as the covar plan packs it: seg slices, the hist views' 0/1
    conds, then one [1, y, y²] triple they share."""
    import torch

    from repro_torch.kernels import ops

    specs, off = [], 0
    yk_off = sum(w for k, _, w, _ in rows if k == "seg") + sum(
        nc for k, _, _, nc in rows if k == "hist")
    codes = torch.stack([spilled_codes(S, n, gen) for _, S, _, _ in rows], 1).contiguous()
    for i, (kind, S, w, nc) in enumerate(rows):
        if kind == "seg":
            specs.append(ops.ReduceSpec("seg", i, S, w, off))
            off += w
        else:
            specs.append(ops.ReduceSpec("hist", i, S, w, off, n_cond=nc, yk_off=yk_off))
            off += nc
    has_hist = any(k == "hist" for k, *_ in rows)
    fpay = torch.randn((n, yk_off + 3 * has_hist), generator=gen, device="cuda")
    if has_hist:
        fpay[:, sum(w for k, _, w, _ in rows if k == "seg"):yk_off] = (
            fpay[:, sum(w for k, _, w, _ in rows if k == "seg"):yk_off] > 0).float()
        y = fpay[:, yk_off + 1]
        fpay[:, yk_off] = 1.0
        fpay[:, yk_off + 2] = y * y
    return codes, fpay, tuple(specs)


def library_time(codes_of, pays, n_segments, reps: int) -> float:
    """One index_add_ per reduction, on payloads formed beforehand (codes out
    of range masked to segment 0 with a zero payload)."""
    import torch

    args = []
    for code, pay, S in zip(codes_of, pays, n_segments):
        ok = (code >= 0) & (code < S)
        args.append((torch.zeros((S, pay.shape[1]), device="cuda"),
                     torch.where(ok, code, torch.zeros_like(code)).long(),
                     (pay * ok[:, None].float()).contiguous()))

    def run():
        for out, sid, p in args:
            out.index_add_(0, sid, p)
    return cuda_ms(run, reps)


def timed(kernel: str, case: str, runners: dict, check, reps: int, **extra) -> None:
    """Check every variant, time them in turns (forward, then backward),
    and print a line each."""
    runners = {k: geometry_variant(k, fn) for k, fn in runners.items()}
    errs = {k: check(fn()) for k, fn in runners.items()}
    names = list(runners)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(cuda_ms(runners[k], reps))
    for k in names:
        split = {"device_ms_by_kernel": device_split(runners[k], reps),
                 "host_ms": host_ms(runners[k], reps)} if k == "kernel" else {}
        print(json.dumps({"kernel": kernel, "variant": k, "case": case, "n": ROWS,
                          "ms": times[k], "max_rel_err": errs[k], **extra, **split}),
              flush=True)


def host_profile(reps: int) -> None:
    """cProfile of the host side of the scan wrappers (seg_aggregate,
    tree_hist_batched, the packed fused_scan_block) over ``reps`` calls
    each: where a call's host time goes."""
    import cProfile
    import io
    import pstats

    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    seg = spilled_codes(480, ROWS, gen)
    pay = torch.randn((ROWS, 20), generator=gen, device="cuda")
    y = torch.randn((ROWS,), generator=gen, device="cuda")
    cond = (torch.rand((ROWS, 16), generator=gen, device="cuda") < 0.5).float()
    codes, fpay, specs = fused_inputs(FUSED_CASES["items"], ROWS, gen)
    calls = {"seg_aggregate": lambda: ops.seg_aggregate(seg, pay, 480),
             "tree_hist_batched": lambda: ops.tree_hist_batched(seg, y, cond, 480),
             "fused_scan_block": lambda: ops.fused_scan_block(codes, fpay, specs)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(reps):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(14)
        print(json.dumps({"host_profile": name, "host_ms": host_ms(fn, reps)}), flush=True)
        print(out.getvalue(), flush=True)


def tree_host_profile(scale: float, top: int = 25) -> None:
    """The depth-4 tree fit of ``chip_smoke.py`` (Retailer at ``scale``,
    unfused then fused, level by level through the stepping API): a warm-up
    fit, two timed fits, then two under cProfile; for each profiled fit its
    host time by layer (the scan wrappers, the lowering, the tree's
    stepping, PyTorch's calls) and its costliest functions."""
    import cProfile
    import io
    import pstats

    import torch

    from repro_torch.api import ExecutionConfig, connect
    from repro_torch.data import datasets as TD
    from repro_torch.kernels import ops
    from repro_torch.ml.trees import DecisionTree, split_stats, stack_mask_params

    ds = TD.make("retailer", scale=scale, seed=1)
    db = connect(ds, config=ExecutionConfig(block_size=1 << 20), device="cuda")
    layers = (("scan wrappers", "repro_torch/kernels/"),
              ("lowering", "repro_torch/core/"), ("tree stepping", "repro_torch/ml/"))
    for label, fuse in (("unfused", False), ("fused", True)):
        sess = connect(ds.schema, data=db.data, edges=ds.edges,
                       config=db.config.replace(fuse_kernels=fuse))
        dt = DecisionTree(ds, database=sess)

        def fit():
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            dt.init_fit()
            while dt.growing:
                masks = dt.frontier_masks()
                dt.advance(split_stats(dt.view.run_batched(
                    stack_mask_params(dt.features, masks)), dt.features))
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        walls = [fit() for _ in range(3)]
        for k in range(2):
            prof = cProfile.Profile()
            prof.enable()
            wall = fit()
            prof.disable()
            st = pstats.Stats(prof)
            by_layer = {name: 0.0 for name, _ in layers}
            by_layer["PyTorch and other"] = 0.0
            for (path, _, _), (_, _, tt, _, _) in st.stats.items():
                name = next((n for n, frag in layers if frag in path), "PyTorch and other")
                by_layer[name] += tt
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
            print(json.dumps({"tree_host_profile": label, "scale": scale, "run": k,
                              "walls_s": walls, "profiled_wall_s": wall,
                              "host_s_by_layer": by_layer,
                              "launches": dict(ops.LAUNCHES)}), flush=True)
            print(out.getvalue(), flush=True)
        del dt, sess


def host_ms(fn, reps: int) -> float:
    """Host time of one call: the calls enqueued back to back, before the
    card is waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def device_split(fn, reps: int) -> dict:
    """Device time of one call by kernel (and copy) name, from the profiler
    over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.split("(")[0][-48:]
            out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def range_paths(reps: int) -> None:
    """``--ranges``: both range-mode paths at each of ``RANGE_COUNTS``
    (SEG), then at each of ``HIST_NODES`` (HIST); the crossover of each."""
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_scan as kfused
    from repro_torch.kernels import seg_aggregate as kseg

    so = _build.library()._name
    # path -> (a library of its own, so a plan cache of its own; the
    # crossover that forces the path)
    libs = {path: (bind(ctypes.CDLL(so), "scan", False), crossover)
            for path, crossover in (("scan", 1 << 30), ("sorted", 1))}
    keep = kseg.SORTED_MIN_RANGES

    def run(path, reds):
        lib, crossover = libs[path]
        kseg.SORTED_MIN_RANGES = crossover
        try:
            return kfused.fused_scan_parts_cuda(reds, lib=lib)
        finally:
            kseg.SORTED_MIN_RANGES = keep

    def both(case, ranges, n, shape, reds, abs_reds) -> bool:
        """Checks both paths against the plain version, times them in
        turns, prints a line; whether the sorted path is the faster."""
        want = ref.fused_scan_parts_ref(reds)[0]
        scale = ref.fused_scan_parts_ref(abs_reds)[0]
        errs = {}
        for path in libs:
            got = run(path, reds)[0]
            errs[path] = float(((got - want).abs() / (scale + 1e-30)).max())
            del got
        del want, scale
        times = {path: [] for path in libs}
        for path in list(libs) + list(libs)[::-1]:
            times[path].append(cuda_ms(lambda: run(path, reds), reps))
        lay = {path: kseg.launch_plan(n, (shape,), reds[0].codes.device, libs[path][0]).launch
               for path in libs}
        print(json.dumps({
            "case": case, "ranges": ranges, "segments": shape.n_segments, "n": n,
            "width": shape.width, "ms": times, "max_rel_err": errs,
            "grids": {path: [[g.kernel, g.n_items, *g.blocks, g.chunk_rows] for g in l.grids]
                      for path, l in lay.items()},
            "scratch_bytes": {path: 4 * l.scratch_numel for path, l in lay.items()},
            "device_ms_by_kernel": {path: device_split(lambda: run(path, reds), reps)
                                    for path in libs}}), flush=True)
        return min(times["sorted"]) < min(times["scan"])

    def crossover(case, faster):
        counts = sorted(faster)
        at = next((r for i, r in enumerate(counts) if all(faster[q] for q in counts[i:])), None)
        print(json.dumps({"case": case, "sorted_faster": faster, "crossover": at,
                          "SORTED_MIN_RANGES": keep}), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n, width = RANGE_ROWS, RANGE_WIDTH
    vals = torch.randn((width, n), generator=gen, device="cuda")
    faster = {}
    for ranges in RANGE_COUNTS:
        S = kseg.range_segments(width) * ranges
        assert kseg.range_count(S, width) == ranges
        spill = max(1, S // 50)
        codes = torch.randint(-spill, S + spill, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
        parts = lambda f: [kfused.Parts(  # noqa: E731
            "seg", codes, tuple(kfused.Part(f(vals[j]), j) for j in range(width)), S, width)]
        faster[ranges] = both("range_paths", ranges, n,
                              kseg.Shape("seg", S, (1,) * width, width),
                              parts(lambda v: v), parts(torch.abs))
        del codes
    crossover("range_paths", faster)
    del vals

    # HIST at a tree level's (date, store_nbr) histograms: 0/1 node masks
    # read transposed from (N, n), y formed on the card
    S = HIST_BUCKETS
    y = torch.randn((n,), generator=gen, device="cuda")
    spill = max(1, S // 50)
    codes = torch.randint(-spill, S + spill, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    faster = {}
    for nodes in HIST_NODES:
        ranges = kseg.range_count(S, max(t for _, t in kseg.column_tiles(3 * nodes, 3)))
        mask = (torch.rand((nodes, n), generator=gen, device="cuda") < 0.5).float()
        faster[ranges] = both("hist_range_paths", ranges, n,
                              kseg.Shape("hist", S, (nodes, 1), 3 * nodes),
                              [kfused.Parts("hist", codes, (mask.t(), y), S)],
                              [kfused.Parts("hist", codes, (mask.t(), y.abs()), S)])
        del mask
    crossover("hist_range_paths", faster)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    ap.add_argument("--sites", type=float, default=None, metavar="SCALE",
                    help="only attribute the fused covar pass's cat/stack "
                         "device time by call site, at this Retailer scale "
                         "(1400: 84M fact rows)")
    ap.add_argument("--old", type=Path, default=None,
                    help="directory of the earlier scan sources and covar_xtx.cu")
    ap.add_argument("--no-xtx", action="store_true", help="skip covar_xtx")
    ap.add_argument("--host-profile", action="store_true",
                    help="only profile the host side of the scan wrappers "
                         "(and, with --tree-scale, of chip_smoke.py's tree fit)")
    ap.add_argument("--ranges", action="store_true",
                    help="only time range mode's scan and sorted paths over "
                         "2 to 13,170 segment ranges (SEG) and a tree level's "
                         "histograms (HIST)")
    ap.add_argument("--tree-scale", type=float, default=None, metavar="SCALE",
                    help="with --host-profile: Retailer's scale for the tree "
                         "fits (1400: 84M fact rows)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sites is not None:
        site_attribution(args.sites, 1 << 20, 1)
        return card_line()
    if args.ranges:
        range_paths(args.reps)
        return card_line()
    if args.host_profile:
        host_profile(args.reps)
        if args.tree_scale is not None:
            tree_host_profile(args.tree_scale)
        return card_line()
    from repro_torch.kernels import _build, covar_xtx as kxtx, ref
    from repro_torch.kernels import fused_scan as kfused
    from repro_torch.kernels import seg_aggregate as kseg
    from repro_torch.kernels import tree_hist as kth

    csrc = _build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def scan_unit(d: Path, header: str) -> Path:
            """One translation unit of the four scan entry points over
            ``header`` (written into ``d``)."""
            d.mkdir()
            for f in SCAN_SOURCES:
                shutil.copy(csrc / f, d)
            (d / "seg_reduce.cuh").write_text(header)
            (d / "all.cu").write_text("".join(f'#include "{f}"\n' for f in SCAN_SOURCES))
            return d / "all.cu"

        header = (csrc / "seg_reduce.cuh").read_text()
        scan_src = {"kernel": scan_unit(tmp / "scan_kernel", header)}
        for name, patches in SCAN_PATCHES.items():
            scan_src[name] = scan_unit(tmp / f"scan_{name}", patched(header, patches))
        xtx_src = {} if args.no_xtx else {"kernel": csrc / "covar_xtx.cu"}
        if not args.no_xtx:
            for name, patches in XTX_PATCHES.items():
                xtx_src[name] = tmp / f"xtx_{name}.cu"
                xtx_src[name].write_text(patched((csrc / "covar_xtx.cu").read_text(), patches))
        if args.old is not None:
            d = tmp / "scan_old"
            d.mkdir()
            for f in list(args.old.glob("*.cu")) + list(args.old.glob("*.cuh")):
                shutil.copy(f, d)
            (d / "all.cu").write_text("".join(f'#include "{f}"\n' for f in SCAN_SOURCES))
            scan_src["old"] = d / "all.cu"
            if not args.no_xtx:
                xtx_src["old"] = args.old / "covar_xtx.cu"
        libs = build({**{f"scan_{k}": v for k, v in scan_src.items()},
                      **{f"xtx_{k}": v for k, v in xtx_src.items()}}, tmp)
        scan_libs = {k: bind(libs[f"scan_{k}"], "scan", k == "old") for k in scan_src}
        for k in GEOMETRY_VARIANTS:   # the committed kernels, a plan cache of their own
            scan_libs[k] = bind(ctypes.CDLL(libs["scan_kernel"]._name), "scan", False)
        xtx_libs = {k: bind(libs[f"xtx_{k}"], "xtx", k == "old") for k in xtx_src}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        dev = torch.device("cuda")

        # -- seg_aggregate
        for S, A, n in SEG_CASES:
            seg = spilled_codes(S, n, gen)
            pay = torch.randn((n, A), generator=gen, device="cuda")
            want = ref.seg_aggregate_ref(seg, pay, S)
            scale = ref.seg_aggregate_ref(seg, pay.abs(), S)
            runners = {k: (lambda lib=lib: old_seg(lib, seg, pay, S)) if k == "old" else
                       (lambda lib=lib: kseg.seg_aggregate_cuda(seg, pay, S, lib=lib))
                       for k, lib in scan_libs.items()}
            geo = kseg.seg_plan(n, S, A, dev, scan_libs["kernel"])
            timed("seg_aggregate", f"{S}x{A}", runners,
                  lambda got: scaled_err(got, want, scale), args.reps,
                  library_ms=library_time([seg], [pay], [S], args.reps),
                  blocks=len(geo.launch.layouts[0].items),
                  chunks=geo.launch.grids[0].n_chunks)
            del seg, pay, want, scale

        # -- fused_scan_block: the plan steps packed, and the covar fact step
        # in parts as the lowering passes it
        for label, rows in FUSED_CASES.items():
            codes, fpay, specs = fused_inputs(rows, ROWS, gen)
            want = ref.fused_scan_block_ref(codes, fpay, specs)
            scale = ref.fused_scan_block_ref(codes, fpay.abs(), specs)
            runners = {k: (lambda lib=lib: old_fused(lib, codes, fpay, specs)) if k == "old" else
                       (lambda lib=lib: kfused.fused_scan_block_cuda(codes, fpay, specs, lib=lib))
                       for k, lib in scan_libs.items()}
            pays = []
            for sp in specs:
                if sp.kind == "seg":
                    pays.append(fpay[:, sp.pay_off:sp.pay_off + sp.width])
                else:
                    cond = fpay[:, sp.pay_off:sp.pay_off + sp.n_cond]
                    yk = fpay[:, sp.yk_off:sp.yk_off + 3]
                    pays.append((cond[:, :, None] * yk[:, None, :]).reshape(ROWS, sp.width))
            shapes = tuple(kseg.Shape("seg", sp.n_segments, (sp.width,), sp.width)
                           if sp.kind == "seg" else
                           kseg.Shape("hist", sp.n_segments, (sp.n_cond, 3), sp.width)
                           for sp in specs)
            lay = kseg.launch_plan(ROWS, shapes, dev, scan_libs["kernel"]).launch
            timed("fused_scan_block", label, runners,
                  lambda got: max(scaled_err(g, w, a) for g, w, a in zip(got, want, scale)),
                  args.reps,
                  library_ms=library_time([codes[:, sp.code_col] for sp in specs], pays,
                                          [sp.n_segments for sp in specs], args.reps),
                  grids=[[g.kernel, g.n_items, g.n_chunks, g.smem_bytes, g.wave_blocks]
                         for g in lay.grids])
            del codes, fpay, want, scale, pays
        codes, fpay, specs = fused_inputs(FUSED_CASES["fact"], ROWS, gen)
        cols, c0 = [], 0
        for w in FACT_PART_WIDTHS:
            cols.append(fpay[:, c0:c0 + w].clone().squeeze(1) if w == 1 else
                        fpay[:, c0:c0 + w].contiguous())
            c0 += w
        code_cols = [codes[:, i].contiguous() for i in range(3)]

        offsets = [0] + list(itertools.accumulate(FACT_PART_WIDTHS))[:-1]

        def fact_parts():
            parts = tuple(kfused.Part(c, o) for c, o in zip(cols, offsets))
            return [kfused.Parts("seg", code_cols[0], parts, 4960, 99),
                    kfused.Parts("seg", code_cols[1], (kfused.Part(fpay[:, 99:103], 0),), 40),
                    kfused.Parts("seg", code_cols[2], (kfused.Part(fpay[:, 103:123], 0),), 480)]
        want = ref.fused_scan_block_ref(codes, fpay, specs)
        scale = ref.fused_scan_block_ref(codes, fpay.abs(), specs)
        runners = {k: (lambda lib=lib: kfused.fused_scan_parts_cuda(fact_parts(), lib=lib))
                   for k, lib in scan_libs.items() if k != "old"}
        runners["stack_then_packed"] = lambda: kfused.fused_scan_block_cuda(
            torch.stack(code_cols, 1), torch.cat([torch.stack(cols[:45], 1)] + cols[45:]
                                                 + [fpay[:, 99:123]], 1), specs,
            lib=scan_libs["kernel"])
        timed("fused_scan_block", "fact_parts", runners,
              lambda got: max(scaled_err(g, w, a) for g, w, a in zip(got, want, scale)),
              args.reps, pack_ms=cuda_ms(lambda: torch.cat(
                  [torch.stack(cols[:45], 1)] + cols[45:] + [fpay[:, 99:123]], 1), args.reps))
        del codes, fpay, cols, code_cols, want, scale

        # the tree fact step as the lowering passes it: 48 aggregate columns
        # of their own, two 16-node histograms over a transposed mask
        tcols = [torch.randn((ROWS,), generator=gen, device="cuda") for _ in range(48)]
        tmask = (torch.rand((TREE_NODES, ROWS), generator=gen, device="cuda") < 0.5).float()
        ty = torch.randn((ROWS,), generator=gen, device="cuda")
        tcodes = [spilled_codes(S, ROWS, gen) for S in (4960, 40, 480)]

        def tree_parts(cols=tcols, y=ty):
            return [kfused.Parts("seg", tcodes[0], tuple(kfused.Part(c, j) for j, c in
                                                         enumerate(cols)), 4960),
                    kfused.Parts("hist", tcodes[1], (tmask.t(), y), 40),
                    kfused.Parts("hist", tcodes[2], (tmask.t(), y), 480)]
        want = ref.fused_scan_parts_ref(tree_parts())
        scale = ref.fused_scan_parts_ref(tree_parts([c.abs() for c in tcols], ty.abs()))
        runners = {k: (lambda lib=lib: kfused.fused_scan_parts_cuda(tree_parts(), lib=lib))
                   for k, lib in scan_libs.items() if k != "old"}
        timed("fused_scan_block", "tree_fact_parts", runners,
              lambda got: max(scaled_err(g, w, a) for g, w, a in zip(got, want, scale)),
              args.reps)
        del tcols, tmask, ty, tcodes, want, scale

        # -- tree_hist_batched at the tree plan's sku histogram: random 0/1
        # masks, and a frontier's (each row in at most one node)
        codes = spilled_codes(TREE_BUCKETS, ROWS, gen)
        y = torch.randn((ROWS,), generator=gen, device="cuda")
        node = torch.randint(-1, TREE_NODES, (ROWS,), generator=gen, device="cuda")
        masks = {"random": (torch.rand((ROWS, TREE_NODES), generator=gen, device="cuda") < 0.5).float(),
                 "frontier": (node[:, None] == torch.arange(TREE_NODES, device="cuda")).float()}
        for label, cond in masks.items():
            want = ref.tree_hist_batched_ref(codes, y, cond, TREE_BUCKETS)
            scale = ref.tree_hist_batched_ref(codes, y.abs(), cond, TREE_BUCKETS)

            def new(lib, cond=cond):
                return kth._hist(lib.tree_hist_batched, codes, y, cond, TREE_BUCKETS, lib)
            runners = {k: (lambda lib=lib, cond=cond: old_tree_hist_batched(lib, codes, y, cond, TREE_BUCKETS))
                       if k == "old" else (lambda lib=lib: new(lib)) for k, lib in scan_libs.items()}
            yk = torch.stack([torch.ones_like(y), y, y * y], 1)
            pay = (cond[:, :, None] * yk[:, None, :]).reshape(ROWS, 3 * TREE_NODES)
            timed("tree_hist_batched", f"{TREE_BUCKETS}x{TREE_NODES} {label}", runners,
                  lambda got: scaled_err(got, want, scale), args.reps,
                  library_ms=library_time([codes], [pay], [TREE_BUCKETS], args.reps))
        del codes, y, masks, want, scale

        # -- covar_xtx
        def xtx_runner(name):
            if name == "old":
                return lambda x, w: old_covar(xtx_libs["old"], x, w)
            return lambda x, w: kxtx.covar_xtx_cuda(x, w, lib=xtx_libs[name])

        xtx_names = list(xtx_libs)
        for f in XTX_WIDTHS if xtx_names else ():
            x = torch.randn((ROWS, f), generator=gen, device="cuda")
            w = (torch.rand((ROWS,), generator=gen, device="cuda") < 0.9).float()
            # gathered-like: eight positive values, each 0.45 of a TF32 unit
            # off the TF32 grid, repeated in every row
            vals = 1.0 + (torch.randint(0, 512, (8,), generator=gen, device="cuda") + 0.45) * 2.0 ** -10
            g = vals[torch.randint(0, 8, (ROWS, f), generator=gen, device="cuda")]
            want, scale = ref.covar_xtx_ref(x, w), ref.covar_xtx_ref(x.abs(), w)
            g64 = g.double()
            want_g = g64.t() @ (g64 * w.double()[:, None])
            runners = {k: xtx_runner(k) for k in xtx_names}
            errs = {k: (scaled_err(runners[k](x, w), want, scale),
                        scaled_err(runners[k](g, w), want_g, want_g)) for k in xtx_names}
            times = {k: [] for k in xtx_names}
            for k in xtx_names + xtx_names[::-1]:
                times[k].append(cuda_ms(lambda: runners[k](x, w), args.reps))
            mm_ms = cuda_ms(lambda: torch.mm(x.t(), x * w[:, None]), args.reps)
            for k in xtx_names:
                print(json.dumps({"kernel": "covar_xtx", "variant": k, "case": f"F{f}",
                                  "n": ROWS, "ms": times[k], "max_rel_err": errs[k][0],
                                  "repeated_values_rel_err_f64": errs[k][1],
                                  "mm_ms": mm_ms}), flush=True)
            del x, w, g, g64, want, scale, want_g
            torch.cuda.empty_cache()
    return card_line()


def card_line() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
