"""minicpm-2b [dense]: llama-like; trained with the WSD schedule (the
warmup-stable-decay schedule is implemented in repro.train.schedules and
selected by this config) [arXiv:2404.06395; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760, vocab=122753,
)
SCHEDULE = "wsd"

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=72, n_heads=6, n_kv=6, d_ff=144,
                        vocab=128, dtype="float32", remat=False)
