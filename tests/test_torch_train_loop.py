"""The port's fault-tolerant training loop, pipeline, checkpoints and
launcher on the CPU: the reference's ``tests/test_fault_tolerance.py``
cases for the port, train-state checkpoints across the packages in both
directions, and the command line.

The cross-package continuation feeds both loops the reference pipeline's
batches (the port's draws come from numpy, the reference's from
``jax.random``).  Its losses are held to rtol 1e-4: the two packages'
float32 gradients differ in their last digits, and Adam's update
(ĝ/(|ĝ| + eps)) turns that into a different move for an element whose
gradient is within noise of 0, which the following steps' losses see.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.train import step as JS
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as train_launch
from repro_torch.models.weights import state_from_numpy, state_to_numpy
from repro_torch.train.adamw import tree_leaves, tree_map
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import TrainConfig, init_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent
CONTINUATION_RTOL = 1e-4


def tiny_setup(compress=False, seed=0):
    """The reference test's ``tiny_setup`` on the port, on the CPU."""
    cfg = configs.get_smoke("internlm2-1.8b")
    tcfg = TrainConfig(peak_lr=1e-2, warmup=2, total_steps=30, ce_chunk=8,
                       attn_impl="dense", compress_grads=compress)
    pipe = TokenPipeline(PipelineConfig(4, 16, cfg.vocab, seed=0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    state = init_state(cfg, tcfg, gen, "cpu")
    return cfg, tcfg, pipe, state, make_train_step(cfg, tcfg)


def _clone(state):
    return tree_map(torch.clone, state)


def _quiet(cfg: LoopConfig) -> LoopConfig:
    cfg.log_every = 0
    return cfg


def test_checkpoint_roundtrip(tmp_path):
    _, _, _, state, _ = tiny_setup()
    path = store.save(str(tmp_path), 7, state_to_numpy(state))
    assert os.path.exists(os.path.join(path, "manifest.json"))
    tree, step = store.restore(str(tmp_path), state)
    assert step == 7
    restored = state_from_numpy(tree, like=state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_detected(tmp_path):
    _, _, _, state, _ = tiny_setup()
    store.save(str(tmp_path), 1, state_to_numpy(state))
    d = os.path.join(str(tmp_path), "step_00000001")
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(d, victim))
    np.save(os.path.join(d, victim), arr + 1.0)
    with pytest.raises(IOError):
        store.restore(str(tmp_path), state)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    _, _, _, state, _ = tiny_setup()
    host = state_to_numpy(state)
    for s in range(5):
        store.save(str(tmp_path), s, host, keep=2)
    steps = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("step_"))
    assert len(steps) == 2
    assert store.latest_step(str(tmp_path)) == 4


def test_resume_identical_trajectory(tmp_path):
    """Interrupted-at-step-10 + resume == uninterrupted 20 steps, bitwise
    on the CPU (the reference's test allows rtol 1e-5)."""
    cfg, tcfg, pipe, state0, step = tiny_setup()
    straight = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=20, ckpt_every=100)))
    s_state = straight.run(_clone(state0))

    ck = str(tmp_path / "ck")
    first = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=10, ckpt_every=10,
                                                    ckpt_dir=ck)))
    first.run(_clone(state0))                          # "crash" after step 10
    second = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=20, ckpt_every=10,
                                                     ckpt_dir=ck)))
    r_state = second.run(_clone(state0))

    assert [r.step for r in second.records] == list(range(10, 20))
    assert second.losses() == straight.losses()[10:]
    for a, b in zip(tree_leaves(s_state), tree_leaves(r_state)):
        assert torch.equal(a, b)


def test_pipeline_determinism_and_sharding():
    cfg = configs.get_smoke("llama3-8b")
    pipe = TokenPipeline(PipelineConfig(8, 16, cfg.vocab, seed=5), cfg, device="cpu")
    b1, b2 = pipe.batch_at(3), pipe.batch_at(3)
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(pipe.batch_at(4)["tokens"], b1["tokens"])
    parts = [pipe.host_shard(b1, i, 4)["tokens"] for i in range(4)]
    assert torch.equal(torch.cat(parts), b1["tokens"])
    # another seed, another stream
    other = TokenPipeline(PipelineConfig(8, 16, cfg.vocab, seed=6), cfg, device="cpu")
    assert not torch.equal(other.batch_at(3)["tokens"], b1["tokens"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama-3.2-vision-90b",
                                  "whisper-small"])
def test_pipeline_affine_progression_and_contexts(arch):
    cfg = configs.get_smoke(arch)
    pipe = TokenPipeline(PipelineConfig(6, 12, cfg.vocab, seed=1), cfg, device="cpu")
    b = pipe.batch_at(0)
    t = b["tokens"].long()
    stride = (t[:, 1] - t[:, 0]) % cfg.vocab
    assert set(stride.tolist()) <= {1, 2}
    steps = torch.arange(12)[None, :]
    assert torch.equal(t, (t[:, :1] + steps * stride[:, None]) % cfg.vocab)
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
    key = {"vlm": "vision", "audio": "frames"}.get(cfg.family)
    if key is None:
        assert set(b) == {"tokens"}
    else:
        n = cfg.vision_tokens if key == "vision" else cfg.encoder_frames
        ctx = b[key]
        assert ctx.dtype == torch.float32 and tuple(ctx.shape) == (6, n, cfg.d_model)
        assert 0.015 < float(ctx.std()) < 0.025         # 0.02·N(0, 1)


def test_loss_decreases_end_to_end():
    cfg, tcfg, pipe, state, step = tiny_setup()
    loop = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=30, ckpt_every=1000)))
    loop.run(state)
    losses = loop.losses()
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]


def test_grad_compression_still_learns():
    cfg, tcfg, pipe, state, step = tiny_setup(compress=True)
    loop = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=30, ckpt_every=1000)))
    out = loop.run(state)
    losses = loop.losses()
    assert losses[-1] < losses[0] - 0.3   # int8+EF does not break convergence
    assert any(bool(e.any()) for e in tree_leaves(out["ef"]))


def test_straggler_detection():
    """A straggler injected at step 12: a sleep of at least 1 s and at
    least four times the slowest earlier step (CPU steps slow down when
    other test processes load the machine)."""
    cfg, tcfg, pipe, state, step = tiny_setup()
    walls = []

    def slow_step(s, b):
        if len(walls) == 11:
            time.sleep(max(1.0, 4 * max(walls[1:])))     # inject a straggler
        t0 = time.perf_counter()
        out = step(s, b)
        walls.append(time.perf_counter() - t0)
        return out

    loop = TrainLoop(slow_step, pipe, _quiet(LoopConfig(max_steps=15, ckpt_every=1000,
                                                        straggler_factor=3.0)))
    loop.run(state)
    assert loop.straggler_events >= 1
    assert any(r.straggler for r in loop.records)


# ------------------------------------------------- checkpoints across packages


class _RefBatches:
    """The reference pipeline's batches for the port's loop."""

    def __init__(self, jpipe):
        self.jpipe = jpipe

    def batch_at(self, step):
        return {k: torch.from_numpy(np.array(v)) for k, v in
                self.jpipe.batch_at(step).items()}


def _ref_setup():
    jcfg = jconfigs.get_smoke("internlm2-1.8b")
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=30, ce_chunk=8, attn_impl="dense")
    jpipe = JTokenPipeline(JPipelineConfig(4, 16, jcfg.vocab, seed=0), jcfg)
    jstate = JS.init_state(jcfg, JS.TrainConfig(**kw), jax.random.PRNGKey(0))
    return jcfg, kw, jpipe, jstate, jax.jit(JS.make_train_step(jcfg, JS.TrainConfig(**kw)))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 5 steps and checkpoints; the port's loop
    resumes from that checkpoint, and its next 5 losses match the
    reference's own continuation on the same batches."""
    jcfg, kw, jpipe, jstate, jstep = _ref_setup()
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    JTrainLoop(jstep, jpipe, JLoopConfig(max_steps=5, ckpt_every=5, ckpt_dir=ck,
                                         log_every=0)).run(jstate)
    shutil.copytree(ck, jck)
    jcont = JTrainLoop(jstep, jpipe, JLoopConfig(max_steps=10, ckpt_every=100,
                                                 ckpt_dir=jck, log_every=0))
    jcont.run(jstate)

    cfg = configs.get_smoke("internlm2-1.8b")
    like = init_state(cfg, TrainConfig(**kw), torch.Generator().manual_seed(1), "cpu")
    loop = TrainLoop(make_train_step(cfg, TrainConfig(**kw)), _RefBatches(jpipe),
                     _quiet(LoopConfig(max_steps=10, ckpt_every=100, ckpt_dir=ck)))
    loop.run(like)
    assert [r.step for r in loop.records] == list(range(5, 10))
    np.testing.assert_allclose(loop.losses(), jcont.losses(), rtol=CONTINUATION_RTOL)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, tcfg, pipe, state, step = tiny_setup()
    ck = str(tmp_path / "ck")
    out = TrainLoop(step, pipe, _quiet(LoopConfig(max_steps=3, ckpt_every=3,
                                                  ckpt_dir=ck))).run(state)
    jcfg = jconfigs.get_smoke("internlm2-1.8b")
    jlike = JS.init_state(jcfg, JS.TrainConfig(), jax.random.PRNGKey(0))
    tree, s = jstore.restore(ck, jlike)
    assert s == 3
    assert int(tree["step"]) == 3
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(out)):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    # the reference trains on from it
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainConfig(
        peak_lr=1e-2, warmup=2, total_steps=30, ce_chunk=8, attn_impl="dense")))
    new, met = jstep(jax.tree.map(jnp.asarray, tree),
                     {"tokens": jnp.asarray(pipe.batch_at(3)["tokens"].numpy())})
    assert np.isfinite(float(met["loss"])) and int(new["step"]) == 4


# ----------------------------------------------------------- the launcher


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    loop = train_launch.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "12",
                              "--batch", "4", "--seq", "16",
                              "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "6",
                              "--device", "cpu"])
    assert [r.step for r in loop.records] == list(range(12))
    assert loop.losses()[-1] < loop.losses()[0]
    assert store.latest_step(str(tmp_path / "ck")) == 12
    assert "device=cpu" in capsys.readouterr().out
    again = train_launch.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "12",
                               "--batch", "4", "--seq", "16",
                               "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert again.records == []                          # resumed at the end


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would succeed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--smoke", "--steps", "1"])


def test_train_step_loads_neither_jax_nor_the_reference(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        import torch
        from repro_torch import configs
        from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
        from repro_torch.train.loop import LoopConfig, TrainLoop
        from repro_torch.train.step import TrainConfig, init_state, make_train_step
        cfg = configs.get_smoke("zamba2-1.2b")
        tcfg = TrainConfig(ce_chunk=8, grad_accum=2, compress_grads=True,
                           warmup=1, total_steps=4)
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        pipe = TokenPipeline(PipelineConfig(4, 16, cfg.vocab), cfg, device="cpu")
        loop = TrainLoop(make_train_step(cfg, tcfg), pipe,
                         LoopConfig(max_steps=2, ckpt_every=2, ckpt_dir={str(tmp_path)!r},
                                    log_every=0))
        loop.run(state)
        assert len(loop.losses()) == 2
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
