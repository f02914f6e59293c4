"""internlm2-1.8b [dense]: GQA. 24L d_model=2048 16H (kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92544,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                        vocab=128, dtype="float32", remat=False)
