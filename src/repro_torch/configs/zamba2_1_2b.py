"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, expand=2, attn_every=6,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                        vocab=128, ssm_state=8, ssm_head_dim=16, attn_every=2,
                        ssm_chunk=8, dtype="float32", remat=False)
