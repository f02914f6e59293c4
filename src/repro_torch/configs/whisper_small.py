"""whisper-small [audio]: encoder-decoder; conv frontend is a stub —
input_specs() provides precomputed frame embeddings (B, 1500, d_model).

12L (decoder) d_model=768 12H d_ff=3072 vocab=51865, 12 encoder layers
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    encoder_layers=12, encoder_frames=1500,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                        vocab=128, encoder_layers=2, encoder_frames=24,
                        dtype="float32", remat=False)
