"""zamba2-1.2b [arXiv:2411.15242; hf]: 38L Mamba2 backbone, d2048,
ssm_state=64, shared attention block (32H kv=32) every 6 layers, d_ff 8192.
Shared attention uses a sliding window at long context (long_500k cell)."""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8_192, vocab_size=32_000,
    mlp="swiglu", norm="rmsnorm", pos="rope",
    ssm=SSMCfg(state_dim=64, head_dim=64, expand=2),
    attn_every=6, sliding_window=4_096,
)
