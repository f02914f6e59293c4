"""The LM stack's models; counterpart of ``repro/models``.

``config.py`` (``ModelConfig``), ``layers.py`` (parameter specs, norms,
rope, attention with the ``flash_attention`` kernel, MLP, embeddings),
``model.py`` (the dense family's ``forward`` and ``decode_step``) and
``weights.py`` (parameter trees carried over from numpy).  MoE, MLA, SSM,
hybrid, VLM and audio are not ported yet (ROADMAP Queue 1 item 1).
"""
