"""The LM stack's models; counterpart of ``repro/models``.

``config.py`` (``ModelConfig``), ``layers.py`` (parameter specs, norms,
rope, attention with the ``flash_attention`` kernel, MLP, embeddings),
``model.py`` (every family's ``forward``, ``encode_context`` and
``decode_step``: dense, MoE, SSM, hybrid, MLA, VLM and audio), ``moe.py``
(routing and expert dispatch), ``mamba2.py`` (the SSD and its recurrent
decode), ``mla.py`` (latent attention and its absorbed decode) and
``weights.py`` (parameter trees carried over from numpy).
"""
