"""The port's model zoo: the decoder-only transformer of the ``dense``,
``moe`` and ``vlm`` families (``transformer``), its layers and its MoE
layer, RWKV-6 of the ``ssm`` family (``rwkv6``), Zamba2 of the ``hybrid``
family (``zamba2``) and the Whisper-style encoder–decoder of the
``audio`` family (``encdec``)."""


def lm_module(cfg):
    """The model module of ``cfg``'s family, with its ``param_specs``,
    ``flat_specs`` and ``init_lm`` (the family dispatch of the reference's
    ``train/step.py:init_params``)."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return zamba2
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec
    raise ValueError(cfg.family)
