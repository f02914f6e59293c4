"""llama-3.2-vision-90b [vlm]: cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
cross-attends to precomputed patch embeddings (frontend stub per brief)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_ff=28672, vocab=128256,
    cross_every=5, vision_tokens=1024, rope_theta=500_000.0,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                        vocab=128, cross_every=2, vision_tokens=16,
                        dtype="float32", remat=False)
