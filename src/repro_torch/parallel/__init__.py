"""repro_torch.parallel — the fleet's batch helpers (port of
``repro.parallel``). The sharded paths (``shard_spec``/``replicated_spec``
and the splits over several CUDA devices) wait for ROADMAP Queue 1 item
8(b)."""
