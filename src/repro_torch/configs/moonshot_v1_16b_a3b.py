"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf]: 48L, d2048,
16H GQA kv=16, MoE 64 experts top-6, d_ff_expert=1408, vocab 163840."""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163_840,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=50_000.0,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408),
)
