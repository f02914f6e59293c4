"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv=8, d_ff=10240, vocab=32000,
    window=4096,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                        vocab=128, window=16, dtype="float32", remat=False)
