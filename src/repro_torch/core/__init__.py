"""repro_torch.core — Algorithm 1 and its PRNG, on torch tensors."""
