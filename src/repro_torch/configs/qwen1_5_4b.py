"""qwen1.5-4b [hf:Qwen/Qwen1.5-0.5B; hf]: 40L, d2560, 20H MHA, d_ff 6912,
vocab 151936, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6_912, vocab_size=151_936,
    mlp="swiglu", norm="rmsnorm", pos="rope", qkv_bias=True,
)
