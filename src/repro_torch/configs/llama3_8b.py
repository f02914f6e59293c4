"""llama3-8b [dense]: GQA, 128k vocab. 32L d_model=4096 32H (kv=8)
d_ff=14336 vocab=128256 [arXiv:2407.21783; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
    rope_theta=500_000.0,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                        vocab=128, dtype="float32", remat=False)
