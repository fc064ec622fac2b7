"""gemma-2b [arXiv:2403.08295; hf]: 18L, d2048, 8H MQA (kv=1), head_dim=256,
GeGLU d_ff 16384, vocab 256000, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16_384, vocab_size=256_000,
    mlp="geglu", norm="rmsnorm", pos="rope",
    tie_embeddings=True,
)
