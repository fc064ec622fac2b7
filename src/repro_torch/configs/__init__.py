"""Architecture registry: --arch <id> resolves here.

The port's own copy of ``repro.configs`` (dataclasses only; the port
imports nothing of ``repro``). ``tests/test_torch_serve.py`` holds the two
registries equal, field by field.
"""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, SHAPES_BY_NAME, EncoderCfg, ModelConfig, MoECfg, RWKVCfg,
    ShapeSpec, SSMCfg,
)

from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen15
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral

ARCHS = {
    c.name: c for c in (
        _qwen3_moe, _moonshot, _whisper, _deepseek, _gemma,
        _qwen2, _qwen15, _rwkv6, _zamba2, _pixtral,
    )
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """Every (arch × shape) dry-run cell, with skips per DESIGN.md §4."""
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES:
            if shape.name == "long_500k" and not cfg.subquadratic:
                out.append((cfg, shape, "SKIP: full attention is quadratic; "
                            "500k dense KV decode infeasible (DESIGN.md §4)"))
            else:
                out.append((cfg, shape, None))
    return out
