"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified]: pixtral-ViT
frontend STUB (patch embeddings) + mistral-nemo decoder: 40L, d5120,
32H GQA kv=8, head_dim 128, d_ff 14336, vocab 131072."""
from repro_torch.configs.base import EncoderCfg, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=131_072,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    encoder=EncoderCfg(n_layers=0, n_frames=1024),  # ViT STUB: 1024 patches
)
