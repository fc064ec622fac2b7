"""The port's kernels of the model zoo: each subpackage holds the plain
PyTorch version (``ref.py``) and the wrapper that launches the
hand-written CUDA kernel on CUDA tensors (``ops.py``)."""
