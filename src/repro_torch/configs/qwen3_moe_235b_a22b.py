"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B; hf]: 94L, d4096, 64H GQA kv=4,
MoE 128 experts top-8, d_ff_expert=1536, vocab 151936."""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151_936,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=1536),
)
