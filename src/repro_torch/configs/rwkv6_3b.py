"""rwkv6-3b 'Finch' [arXiv:2404.05892; hf]: 32L, d2560, attention-free,
data-dependent decay, d_ff 8960, vocab 65536, head_dim 64 (40 heads)."""
from repro_torch.configs.base import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8_960, vocab_size=65_536,
    norm="layernorm", pos="none",
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, chunk=128),
)
