"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512), 2 shared + routed top-6.

27L d_model=2048 16H expert d_ff=1408 vocab=102400, 64 routed experts
[arXiv:2405.04434; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=0, vocab=102400,
    kv_lora=512, rope_dim=64, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv=4, vocab=128,
                        kv_lora=32, rope_dim=16, head_dim=16,
                        n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
                        dtype="float32", remat=False)
