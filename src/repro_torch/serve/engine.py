"""Serving: the single-token decode step and a batched greedy decoder;
counterpart of ``repro/serve/engine.py``.

``make_serve_step`` gives the one-token step; ``BatchedServer`` drives it
for a batch of requests with greedy sampling, teacher-forcing each prompt
one token at a time through the cache as the reference does, for every
family (KV caches for dense, MoE, VLM and audio, the MLA latent for
deepseek, SSM states for Mamba2, both for the hybrid).  A VLM or audio
server takes the raw context (vision embeddings or frames) and encodes it
once.  There is no ``jit``: the step runs eagerly, and the decode cache is
updated in place.

``make_serve_step(cfg, mesh)`` runs the step on a mesh's ranks: parameters
placed by ``param_pspecs(M.model_specs(cfg))`` and the cache by
``param_pspecs(M.cache_specs(...))`` (``init_sharded_cache``), its length
over ``model`` (context-parallel decode: each rank attends over its part
of the length, and the new entry is written by the rank that holds its
position).  ``make_encode_step(cfg, mesh)`` encodes a VLM or audio
request's raw context once, placed like a batch on the mesh, for the serve
step to read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (mesh_context, param_pspecs,
                                              rules_for, shard_tree)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, mesh=None):
    """serve_step(params, cache, tokens(B,1), pos, context?) ->
    (logits(B,1,V), cache); with ``mesh`` on its ranks (logits a DTensor,
    batch over the batch axes, vocab over ``model``)."""

    def serve_step(params, cache, tokens, pos, context=None):
        with mesh_context(mesh):
            return M.decode_step(params, cache, tokens, pos, cfg, context=context)

    return serve_step


def make_encode_step(cfg: ModelConfig, mesh=None):
    """encode(params, raw) -> the context ``decode_step`` reads: ``raw``
    (B, vision tokens or frames, d_model), an array or a tensor, moved to
    the parameters' device and encoded once (``encode_context``: whisper's
    encoder, or the vision embeddings cast); with ``mesh`` on its ranks,
    the raw and the encoded context placed like a batch (batch over the
    batch axes).  None for the families without a context."""
    key = "frames" if cfg.family == "audio" else "vision"

    @torch.no_grad()
    def encode(params, raw):
        if raw is None:
            return None
        with mesh_context(mesh):
            raw = torch.as_tensor(raw, device=params["embedding"].device)
            return M.encode_context(params, {key: raw}, cfg)

    return encode


def init_sharded_cache(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """A zero decode cache placed on ``mesh`` by the reference's cache
    specs (``cache_seq`` over ``model``, ``cache_batch`` over the batch
    axes), on the mesh's device type."""
    specs = param_pspecs(M.cache_specs(cfg, batch, max_len), rules_for(mesh), mesh)
    return shard_tree(M.init_cache(cfg, batch, max_len, mesh.device_type),
                      specs, mesh)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The arg max of the last position's logits, (B, 1) int32; ties go to
    the first index, as ``jnp.argmax``."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def _zero_states(cache) -> None:
    """Zero the SSM states (``h``, ``conv``) of a decode cache in place."""
    for k, v in cache.items():
        if k in ("h", "conv"):
            v.zero_()
        elif isinstance(v, dict):
            _zero_states(v)


@dataclasses.dataclass
class BatchedServer:
    """Greedy batched decoding over a fixed slot count, on ``device`` (the
    card unless the caller asks for the CPU).  The cache is zeros on the
    device (``model.init_cache``: SSM states in float32).

    ``context`` is the *raw* modality input, (B, frames or vision tokens,
    d_model), an array or a tensor: the audio encoder runs once here
    (``encode_context``, its ``flash_attention`` launches included), and
    decode steps read the encoded context."""

    cfg: ModelConfig
    params: Any
    max_len: int
    batch: int
    device: Any = "cuda"
    context: Optional[Any] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cache = M.init_cache(self.cfg, self.batch, self.max_len,
                                  self.device)
        if self.context is not None:
            self.context = make_encode_step(self.cfg)(self.params, self.context)
        self._step = make_serve_step(self.cfg)

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """prompts: (B, P) int32. Greedy-decodes n_tokens continuations.
        KV caches are reused from call to call without clearing (every
        entry a step reads was written earlier in the same call); SSM
        states, which every step reads, start each call from zeros."""
        b, plen = prompts.shape
        if b != self.batch:
            raise ValueError(f"{b} prompts for {self.batch} slots")
        kv = self.cache.get("kv", self.cache.get("shared_kv"))
        if kv is not None:
            t = kv["k" if "k" in kv else "c"].shape[2]       # "c": MLA's latent
            ring = bool(self.cfg.window) and t == self.cfg.window
            if not ring and plen + n_tokens - 1 > t:
                raise ValueError(f"{plen} prompt and {n_tokens} new tokens need "
                                 f"{plen + n_tokens - 1} cache entries, the "
                                 f"cache holds {t}")
        _zero_states(self.cache)
        prompt_t = torch.as_tensor(np.asarray(prompts, np.int32),
                                   device=self.device)
        toks = prompt_t[:, :1]
        out = [toks]
        for pos in range(plen + n_tokens - 1):
            logits, self.cache = self._step(self.params, self.cache, toks, pos,
                                            self.context)
            if pos + 1 < plen:
                toks = prompt_t[:, pos + 1:pos + 2]      # teacher force
            else:
                toks = greedy(logits)
            out.append(toks)
        return torch.cat(out, dim=1).cpu().numpy()
