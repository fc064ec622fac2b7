"""deepseek-7b [arXiv:2401.02954; hf]: llama-arch 30L, d4096, 32H MHA,
d_ff 11008, vocab 102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11_008, vocab_size=102_400,
    mlp="swiglu", norm="rmsnorm", pos="rope",
)
