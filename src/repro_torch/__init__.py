"""repro_torch — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro``'s subpackage layout and function names; each
module holds plain functions on batch-major tensors (``jax.vmap`` becomes
an explicit leading ``B`` axis). It imports ``torch`` and numpy only, never
``jax`` and never a module of ``repro``: numpy-only modules it needs are
kept as its own copies.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise unless the caller asks for ``device="cpu"``.
"""

from repro_torch.device import DEFAULT_DEVICE, resolve_device  # noqa: F401
