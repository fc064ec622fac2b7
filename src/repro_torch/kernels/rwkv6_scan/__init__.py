from repro_torch.kernels.rwkv6_scan import ops, ref  # noqa: F401
