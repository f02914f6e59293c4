"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, expand=2,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, vocab=128, ssm_state=8,
                        ssm_head_dim=16, ssm_chunk=8, dtype="float32",
                        remat=False)
