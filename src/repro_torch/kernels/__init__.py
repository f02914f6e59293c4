"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers
and their plain PyTorch versions; counterpart of ``repro/kernels``.

fused_scan         every reduction of a scan step in one launch (main path)
seg_aggregate      multi-aggregate segment reduction (unfused path)
tree_hist          decision-tree node histogram (unfused path)
tree_hist_batched  the same for every frontier node at once (unfused trees)
covar_xtx          Xᵀ·diag(w)·X over a gathered feature matrix (ml/covar_fused)
flash_attention    blockwise attention with GQA, causal and window masks
                   (the LM prefill in models/layers.py)

``ops.py`` holds the public wrappers and launch counters, ``ref.py`` the
plain versions, ``_build.py`` the nvcc build.
"""
