"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8 routing.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=0, vocab=151936,
    n_experts=128, top_k=8, moe_d_ff=1536, head_dim=128,
    rope_theta=1_000_000.0,
)

def smoke_config() -> ModelConfig:
    return CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv=2, vocab=128,
                        n_experts=8, top_k=2, moe_d_ff=32, head_dim=16,
                        dtype="float32", remat=False)
