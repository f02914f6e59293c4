"""The port's training loss and gradients for every LM family against the
reference's, on the CPU: ``jax.value_and_grad(repro.train.step._loss_fn)``
against autograd through ``repro_torch.train.step._loss_fn`` on the same
numpy parameters and batch, under ``"dense"`` and ``"chunked"`` attention
(a 6-row chunk at S = 16), with remat off and on.  Cases and tolerances
are ``torch_train_cases``'s."""

import pytest
import torch

from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models.weights import params_from_numpy
from torch_train_cases import (ATTN_CHUNK, GRAD_REL, LOSS_TOL, S, cfgs,
                               np_batch, port_grads, reference, rel)

FAMILIES = ["internlm2-1.8b", "h2o-danube-3-4b", "qwen3-moe-235b-a22b",
            "mamba2-2.7b", "zamba2-1.2b", "deepseek-v2-lite-16b",
            "llama-3.2-vision-90b", "whisper-small"]


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch, impl):
    """Remat off and on give the same gradients, bitwise: the recompute
    runs the same ops on the same values."""
    params_np, batch, jloss, jgrads = reference(arch, impl)
    _, cfg = cfgs(arch)
    params = params_from_numpy(params_np, "cpu")
    loss, grads = port_grads(params, batch, cfg.with_(remat=False), impl)
    loss_r, grads_r = port_grads(params, batch, cfg.with_(remat=True), impl)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    assert loss_r == loss
    assert len(grads) == len(jgrads)
    for i, (g, gr, w) in enumerate(zip(grads, grads_r, jgrads)):
        assert torch.equal(g, gr), f"leaf {i}: remat changed the gradient"
        assert rel(g.numpy(), w) <= GRAD_REL, (i, rel(g.numpy(), w))


def test_remat_wraps_layers_only_under_grad(monkeypatch):
    """``cfg.remat`` checkpoints each layer when autograd records and
    nothing when it does not (serving), and chunked attention checkpoints
    each query chunk under grad."""
    calls = []
    real = M.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(M, "checkpoint", counting)
    monkeypatch.setattr(TL, "checkpoint", counting)
    _, cfg = cfgs("internlm2-1.8b")
    cfg = cfg.with_(remat=True)
    params = params_from_numpy(reference("internlm2-1.8b", "chunked")[0], "cpu")
    batch = {"tokens": torch.from_numpy(np_batch(cfg, 1)["tokens"])}
    with torch.no_grad():
        M.forward_hidden(params, batch, cfg, impl="chunked")
    assert calls == []
    M.forward_hidden(params, batch, cfg, impl="chunked")
    assert calls.count("dense_block") == cfg.n_layers
    assert calls.count("body") == cfg.n_layers * -(-S // ATTN_CHUNK)


@pytest.mark.parametrize("dt_value", [0.05, 1.0])
def test_ssd_gradient_finite_where_the_mask_overflows(dt_value):
    """``ssd_chunked`` against the reference's on the same inputs: its
    output, and the gradient of ``Σ y·w`` for a fixed random ``w``.  At
    dt = 1 over a 128-row chunk the unmasked (j > i) decay exponents reach
    127, past float32's exp range: the reference's ``where(causal, exp(·),
    0)`` then gives a non-finite gradient, the port's masked exponent a
    finite one equal to its float64 gradient.  Outputs to 1e-5 of their
    largest; gradients as ``GRAD_REL`` says."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import mamba2 as J2
    from repro_torch.models import mamba2 as T2

    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 128, 2, 4, 3
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), dt_value, np.float32)
    A = -np.ones(h, np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, n)).astype(np.float32)
    w = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jout(x, dt):
        return J2.ssd_chunked(x, dt, jnp.asarray(A), jnp.asarray(B_), jnp.asarray(C_), 128)

    jy = np.asarray(jout(jnp.asarray(x), jnp.asarray(dt)))
    jgx, jgdt = jax.grad(lambda x, dt: (jout(x, dt) * w).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(dt))

    def run(dtype):
        tx = torch.tensor(x, dtype=dtype, requires_grad=True)
        tdt = torch.tensor(dt, dtype=dtype, requires_grad=True)
        y = T2.ssd_chunked(tx, tdt, torch.tensor(A, dtype=dtype),
                           torch.tensor(B_, dtype=dtype), torch.tensor(C_, dtype=dtype), 128)
        return (y.detach(),) + torch.autograd.grad((y * torch.tensor(w, dtype=dtype)).sum(),
                                                   (tx, tdt))

    y, gx, gdt = run(torch.float32)
    _, gx64, gdt64 = run(torch.float64)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())
    assert bool(torch.isfinite(gx).all() and torch.isfinite(gdt).all())
    assert rel(gx.numpy(), gx64.numpy()) <= GRAD_REL
    assert rel(gdt.numpy(), gdt64.numpy()) <= GRAD_REL
    finite = bool(np.isfinite(np.asarray(jgdt)).all())
    if dt_value < 1:
        assert finite and rel(gdt.numpy(), np.asarray(jgdt)) <= GRAD_REL
        assert rel(gx.numpy(), np.asarray(jgx)) <= GRAD_REL
    else:
        assert not finite                 # the reference's 0·inf
