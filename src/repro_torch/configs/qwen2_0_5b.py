"""qwen2-0.5b [arXiv:2407.10671; hf]: 24L, d896, 14H GQA kv=2, d_ff 4864,
vocab 151936, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4_864, vocab_size=151_936,
    mlp="swiglu", norm="rmsnorm", pos="rope", qkv_bias=True,
    tie_embeddings=True,
)
