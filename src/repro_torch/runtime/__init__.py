"""repro_torch.runtime — own copies of the capacity-fault schedule model
(``runtime.fault``) and the resource pool (``runtime.pool``), the
resize schedule (``runtime.elastic``), and the checkpoint codec
(``runtime.checkpoint``, the reference's on-disk format)."""
