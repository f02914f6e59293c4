#!/usr/bin/env python3
"""The engine's domain parallelism on several cards: one rank a card over
NCCL, or ranks on the CPU over gloo.

    python3 tools/torch_shard_cards.py [--ranks 4] [--scale 200] [--device cuda]

Spawns ``--ranks`` processes (rank r on card r), each generating Retailer
at ``--scale`` from ``--seed`` and opening the session under a
``("data", "model")`` mesh of ``launch/mesh.py``.  Every rank runs, sharded
and unsharded: the covar batch (cold, then a warm wall each way), one
frontier-batched tree level of 16 random masks, and a maintained covar
rooted at the fact with three 1% fact ticks (the last two under
sync-debug "error" on the card); then a checkpoint of the sharded batch
(rank 0 writes, every rank restores into a fresh batch) and the fact
gathered back.  Each rank prints one JSON line; the last line holds the
checks: the sharded covar and ticks within 1e-4 of each entry's
Cauchy–Schwarz bound of the unsharded ones (N exact), the tree level
within 1e-4 of the largest statistic, one runner built, the restore
bitwise, the gathered fact equal to the unsharded copy's, the ranks'
covars bitwise alike.  Exits 1 if a check fails, and when a rank fails.

    python3 tools/torch_shard_cards.py --lm [--arch A] [--layers L] [--seq S]
        [--dtype D] [--ranks 4] [--n-model 2] [--smoke]

runs the LM's sharding instead (``distributed/sharding.py``): each rank
builds ``--arch``'s train state from ``--seed`` (internlm2-1.8b unless
given; whole, in the config's dtype, bf16, unless ``--layers`` cuts its
depth or ``--dtype`` sets one; the smoke config with ``--smoke``) on a
``(ranks / n_model, n_model)`` mesh, keeps its shard (``state_pspecs``),
and takes ``--steps`` sharded train steps of B 8 × ``--seq`` (4,096) in
two microbatches (chunked attention, remat; the VLM's and whisper's
batches carry their context), then a sharded prefill of B 4 × ``--seq``
with ``"flash"`` (the kernel on each rank's local heads) and 8 sharded
decode steps on the trained shards, a VLM's or whisper's context encoded
once on the mesh; rank 0 then does the same unsharded from the same
state, drawn again from the seed.  The last line holds the checks: each step's loss within 1e-3 and
grad norm within 1e-2 (relative) of the unsharded step's, the params
after the steps within 5e-3, the prefill's last-position and the decode
logits within 5e-2 of their max (bf16: the products' partial sums cross
ranks; rank 0 also reports, as a yardstick, how far its unsharded bf16
prefill and decode are from float32 on the same weights), every rank's ``flash_attention`` launches a prefill equal to the
unsharded prefill's (on the card, one an attention layer; none for the
SSM), every rank's state a shard (its bytes at most half the whole's).
A MoE arch's routing can flip a near-tie when partial sums cross ranks:
run it with ``--dtype float32``, where none is expected.
"""

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
#: the checks' limit: float32 sums in another order (the covar's own rule)
TOL = 1e-4


def scaled(C, D) -> float:
    d = np.sqrt(np.maximum(np.outer(np.diag(D), np.diag(D)), 1e-300))
    return float((np.abs(C - D) / d).max())


def walled(fn, on_card: bool):
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def rank_main(rank, world, init_file, args, out):
    on_card = args.device == "cuda"
    torch.set_num_threads(2)
    if on_card:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        import repro_torch
        from repro_torch.data import datasets as TD
        from repro_torch.data.relations import DeltaBatchUpdate
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.ml.covar import assemble_covar, compute_covar, covar_queries
        from repro_torch.ml.trees import DecisionTree, split_stats, stack_mask_params

        dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
        ds = TD.make("retailer", scale=args.scale, seed=args.seed)
        mesh = make_host_mesh(n_data=world, device_type=args.device)
        db = repro_torch.connect(ds, device=dev, config=repro_torch.ExecutionConfig(
            block_size=args.block_size))
        sdb = db.with_config(mesh=mesh)
        res = {"rank": rank, "device": str(dev),
               "card": torch.cuda.get_device_name(rank) if on_card else "cpu"}
        ops.reset_launches()
        C_s, N_s, layout, _ = compute_covar(ds, database=sdb)
        res["launches"] = ops.LAUNCHES["fused_scan_block"]
        _, res["covar_warm_s"] = walled(lambda: compute_covar(ds, database=sdb), on_card)
        C_l, N_l, _, _ = compute_covar(ds, database=db)
        _, res["covar_local_warm_s"] = walled(lambda: compute_covar(ds, database=db),
                                              on_card)
        res["covar_vs_local"] = scaled(C_s, C_l)
        res["N"] = [N_s, N_l]

        rng = np.random.default_rng(args.seed)
        dt_s = DecisionTree(ds, database=sdb)
        dt_l = DecisionTree(ds, database=db)
        masks = [{f.attr: (rng.random(f.domain) < 0.7).astype(np.float32)
                  for f in dt_s.features} for _ in range(16)]
        p = stack_mask_params(dt_s.features, masks)
        st_s = split_stats(dt_s.view.run_batched(p), dt_s.features)
        st_l = split_stats(dt_l.view.run_batched(p), dt_l.features)
        res["tree_vs_local"] = max(float(np.abs(st_s[k] - st_l[k]).max()
                                         / (np.abs(st_l[k]).max() + 1e-30)) for k in st_s)

        qs, _ = covar_queries(ds)
        roots = {q.name: ds.fact for q in qs}
        hs = sdb.views(qs, maintain=True, roots=roots)
        hl = db.views(qs, maintain=True, roots=roots)
        hs.run()
        hl.run()
        fact = ds.tables[ds.fact]
        n = len(next(iter(fact.values())))
        urng = np.random.default_rng(args.seed + 1)
        res["tick_vs_local"], res["tick_walls_s"] = [], []
        for i in range(3):
            pick = urng.integers(0, n, n // 100)
            upd = (DeltaBatchUpdate()
                   .insert(ds.fact, {a: np.asarray(c)[pick] for a, c in fact.items()})
                   .delete(ds.fact, urng.choice(n, n // 100, replace=False)))

            def tick():
                if i and on_card:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out = hs.apply(upd)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(0)
                return assemble_covar({k: v.cpu().numpy() for k, v in out.items()}, layout)

            (Ca, _), wall = walled(tick, on_card)
            Cb, _ = assemble_covar({k: v.cpu().numpy() for k, v in hl.apply(upd).items()},
                                   layout)
            res["tick_walls_s"].append(wall)
            res["tick_vs_local"].append(scaled(Ca, Cb))
        res["builds"] = hs.maintained.n_fold_traces
        res["topology"] = hs.maintained.shard_topology()

        ckpt = os.path.join(out, "ckpt")
        hs.snapshot(ckpt)
        res["ckpt_steps"] = sorted(os.listdir(ckpt))
        restored = sdb.views(qs, maintain=True, roots=roots)
        res["restored_step"] = restored.restore(ckpt)
        r1, r2 = hs.results(), restored.results()
        res["restored_bitwise"] = all(torch.equal(r1[k], r2[k]) for k in r1)
        g = hs.maintained.db.relation(ds.fact).columns
        loc = hl.maintained.db.relation(ds.fact).columns
        res["gathered_equal"] = all(torch.equal(g[a], loc[a]) for a in loc)
        np.save(os.path.join(out, f"C{rank}.npy"), C_s)
        print(json.dumps(res, default=str), flush=True)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f, default=str)
    finally:
        dist.destroy_process_group()


#: the LM mode's limits: tests/test_distributed.py:86-90 (loss, params);
#: the grad norm relative (a bf16 gradient's partial sums cross ranks)
LM_LOSS_TOL, LM_GNORM_TOL, LM_PARAM_TOL = 1e-3, 1e-2, 5e-3
#: bf16 logits, relative to their max (chip_smoke.py's BF16_PREFILL_TOL)
LM_LOGITS_TOL = 5e-2


def lm_serve(cfg, params, batch, mesh):
    """The last-position logits of a ``"flash"`` prefill of ``batch``
    (tokens, and a VLM's or whisper's context) and the logits of 8 decode
    steps over its first columns (a fresh cache, the context encoded
    once), on ``mesh`` (None: unsharded), whole on every rank; and the
    prefill's ``flash_attention`` launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (init_sharded_cache, make_encode_step,
                                          make_serve_step)
    from repro_torch.train.step import TrainConfig, make_prefill_step

    def whole(t):
        return t.full_tensor() if mesh is not None else t

    tokens = batch["tokens"]
    ops.reset_launches()
    pre = whole(make_prefill_step(cfg, TrainConfig(attn_impl="flash"), mesh)(
        params, batch))
    launches = ops.LAUNCHES["flash_attention"]
    b = tokens.shape[0]
    cache = (init_sharded_cache(cfg, b, 16, mesh) if mesh is not None
             else M.init_cache(cfg, b, 16, tokens.device))
    raw = next((a for k, a in batch.items() if k != "tokens"), None)
    context = make_encode_step(cfg, mesh)(params, raw)
    step = make_serve_step(cfg, mesh)
    dec = []
    for pos in range(8):
        lg, cache = step(params, cache, tokens[:, pos:pos + 1], pos, context)
        dec.append(whole(lg).float())
    return pre.float(), torch.stack(dec), launches


def rel_max(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def lm_rank_main(rank, world, init_file, args, out):
    on_card = args.device == "cuda"
    torch.set_num_threads(2)
    if on_card:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=600))
    try:
        from repro_torch import configs
        from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
        from repro_torch.distributed.sharding import full_tree, shard_tree
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.adamw import tree_leaves, tree_map
        from repro_torch.train.step import (TrainConfig, init_state, make_train_step,
                                            state_pspecs)

        dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
        cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
        cfg = cfg.with_(n_layers=args.layers or cfg.n_layers,
                        dtype=args.dtype or cfg.dtype)
        seq = 64 if args.smoke else args.seq
        tcfg = TrainConfig(attn_impl="chunked", ce_chunk=min(512, seq), grad_accum=2,
                           peak_lr=3e-4, warmup=0, total_steps=8)
        mesh = make_host_mesh(n_data=world // args.n_model, n_model=args.n_model,
                              device_type=args.device)
        def fresh_state():
            # the same values on every rank and at every call: a replicated
            # leaf's shard shares its storage with the whole leaf, which the
            # sharded steps update in place, so the unsharded run (rank 0)
            # draws its own copy after the sharded one is freed
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed)
            return init_state(cfg, tcfg, gen, dev)

        state = fresh_state()
        whole = sum(t.numel() * t.element_size() for t in tree_leaves(state))
        sstate = shard_tree(state, state_pspecs(cfg, tcfg, mesh), mesh)
        del state
        local = sum(t.to_local().numel() * t.element_size() for t in tree_leaves(sstate))
        pipe = TokenPipeline(PipelineConfig(8, seq, cfg.vocab, seed=args.seed), cfg,
                             device=dev)
        step = make_train_step(cfg, tcfg, mesh)
        res = {"rank": rank, "device": str(dev), "mesh": list(mesh.shape),
               "card": torch.cuda.get_device_name(rank) if on_card else "cpu",
               "state_bytes": whole, "local_state_bytes": local,
               "walls_s": [], "losses": [], "grad_norms": []}
        if on_card:
            torch.cuda.reset_peak_memory_stats(rank)
        for i in range(args.steps):
            (sstate, met), wall = walled(lambda: step(sstate, pipe.batch_at(i)), on_card)
            res["losses"].append(float(met["loss"]))
            res["grad_norms"].append(float(met["grad_norm"]))
            res["walls_s"].append(wall)
        res["tokens_per_s"] = 8 * seq / min(res["walls_s"][1:] or res["walls_s"])
        if on_card:
            res["peak_mem_gib"] = torch.cuda.max_memory_allocated(rank) / 2**30
        rng = np.random.default_rng(args.seed + 1)
        batch = {k: a[:4] for k, a in pipe.batch_at(args.steps).items()}
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (4, seq))).to(dev)
        pre, dec, res["prefill_launches"] = lm_serve(cfg, sstate["params"], batch, mesh)
        res.update(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
                   dtype=cfg.dtype, seq=seq)
        params = full_tree(sstate["params"])
        del sstate
        if rank == 0:
            state = fresh_state()
            ustep = make_train_step(cfg, tcfg)
            res["unsharded_losses"], res["unsharded_grad_norms"] = [], []
            for i in range(args.steps):
                state, met = ustep(state, pipe.batch_at(i))
                res["unsharded_losses"].append(float(met["loss"]))
                res["unsharded_grad_norms"].append(float(met["grad_norm"]))
            res["param_err"] = max(float((a.float() - b.float()).abs().max()) for a, b in
                                   zip(tree_leaves(params), tree_leaves(state["params"])))
            del state
            upre, udec, res["unsharded_prefill_launches"] = lm_serve(cfg, params, batch, None)
            res["prefill_rel"], res["decode_rel"] = rel_max(pre, upre), rel_max(dec, udec)
            if cfg.torch_dtype != torch.float32:
                # bf16's own distance: the unsharded run against float32
                # on the same weights (a yardstick, not a check)
                f32 = {k: a.float() if a.is_floating_point() else a
                       for k, a in batch.items()}
                wide = cfg.with_(dtype="float32")
                p32 = tree_map(lambda t: t.float(), params)
                del params
                fpre, fdec, _ = lm_serve(wide, p32, f32, None)
                res["unsharded_vs_f32_prefill_rel"] = rel_max(upre, fpre)
                res["unsharded_vs_f32_decode_rel"] = rel_max(udec, fdec)
        print(json.dumps(res, default=str), flush=True)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f, default=str)
    finally:
        dist.destroy_process_group()


def flash_launches_a_forward(cfg) -> int:
    """``flash_attention`` launches of one forward on the card: one an
    attention layer (whisper's encoder layers and its decoder's self and
    cross attention; the hybrid's shared block once a group), none for the
    SSM."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "audio": cfg.encoder_layers + 2 * cfg.n_layers}[cfg.family]


def lm_checks(ranks, cfg) -> dict:
    r0 = ranks[0]
    want = r0["unsharded_prefill_launches"]
    return {
        "losses": all(abs(a - b) <= LM_LOSS_TOL for a, b in
                      zip(r0["losses"], r0["unsharded_losses"])),
        "grad_norms": all(abs(a - b) <= LM_GNORM_TOL * b for a, b in
                          zip(r0["grad_norms"], r0["unsharded_grad_norms"])),
        "params": r0["param_err"] <= LM_PARAM_TOL,
        "prefill_decode": max(r0["prefill_rel"], r0["decode_rel"]) <= LM_LOGITS_TOL,
        # the kernel on the card; its plain version (no launch) on the CPU
        "prefill_launches": want == (flash_launches_a_forward(cfg) if
                                     r0["device"].startswith("cuda") else 0)
        and all(r["prefill_launches"] == want for r in ranks),
        "ranks_alike": all(r["losses"] == r0["losses"] for r in ranks),
        "sharded": all(2 * r["local_state_bytes"] <= r["state_bytes"] for r in ranks),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--scale", type=float, default=200.0,
                    help="Retailer scale: 60,000 fact rows per unit")
    ap.add_argument("--block-size", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--lm", action="store_true",
                    help="the LM's sharded train steps instead of the engine")
    ap.add_argument("--n-model", type=int, default=2, help="--lm: the model axis")
    ap.add_argument("--steps", type=int, default=2, help="--lm: train steps")
    ap.add_argument("--smoke", action="store_true", help="--lm: the smoke config")
    ap.add_argument("--arch", default="internlm2-1.8b", help="--lm: the config")
    ap.add_argument("--layers", type=int, default=None,
                    help="--lm: cut the depth to this many layers")
    ap.add_argument("--seq", type=int, default=4096, help="--lm: sequence length")
    ap.add_argument("--dtype", default=None, help="--lm: the model dtype")
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"torch_shard_cards: {args.ranks} ranks need as many cards "
              f"({torch.cuda.device_count()} found)", file=sys.stderr)
        return 2
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        mp.start_processes(lm_rank_main if args.lm else rank_main,
                           args=(args.ranks, os.path.join(out, "pg"), args, out),
                           nprocs=args.ranks, start_method="spawn")
    except Exception as e:
        print(f"torch_shard_cards: a rank failed: {e}", file=sys.stderr)
        return 1
    ranks = []
    for r in range(args.ranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if args.lm:
        from repro_torch import configs

        cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
        cfg = cfg.with_(n_layers=args.layers or cfg.n_layers)
        checks = lm_checks(ranks, cfg)
        print(json.dumps({"ranks": args.ranks, "device": args.device, "lm": True,
                          "arch": args.arch, "layers": cfg.n_layers,
                          "dtype": ranks[0]["dtype"], "seq": ranks[0]["seq"],
                          "n_model": args.n_model, "smoke": args.smoke,
                          "checks": checks, "ok": all(checks.values())}), flush=True)
        return 0 if all(checks.values()) else 1
    Cs = [np.load(os.path.join(out, f"C{r}.npy")) for r in range(args.ranks)]
    checks = {
        "covar": all(r["covar_vs_local"] <= TOL and r["N"][0] == r["N"][1] for r in ranks),
        "tree": all(r["tree_vs_local"] <= TOL for r in ranks),
        "ticks": all(max(r["tick_vs_local"]) <= TOL and r["builds"] == 1 for r in ranks),
        "checkpoint": all(r["restored_bitwise"] and r["restored_step"] == 3
                          and len(r["ckpt_steps"]) == 1 for r in ranks),
        "gathered": all(r["gathered_equal"] for r in ranks),
        "ranks_bitwise": all(np.array_equal(Cs[0], c) for c in Cs[1:]),
    }
    print(json.dumps({"ranks": args.ranks, "device": args.device, "scale": args.scale,
                      "checks": checks, "ok": all(checks.values())}), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
