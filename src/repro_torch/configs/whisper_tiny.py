"""whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, 4L each, d384, 6H,
d_ff 1536, vocab 51865, LayerNorm+GELU, learned positions, conv frontend
STUB (input_specs provides frame embeddings)."""
from repro_torch.configs.base import EncoderCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51_865,
    mlp="gelu", norm="layernorm", pos="learned",
    tie_embeddings=True,
    encoder=EncoderCfg(n_layers=4, n_frames=1500),
)
