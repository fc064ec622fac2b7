"""repro_torch.runtime — own copy of the capacity-fault schedule model."""
