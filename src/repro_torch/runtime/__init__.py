"""repro_torch.runtime — own copies of the capacity-fault schedule model
(``runtime.fault``) and the resource pool (``runtime.pool``), the
reshard plan and the resize schedule (``runtime.elastic``), the ASA
campaign scheduler (``runtime.campaign``), and the checkpoint codec
(``runtime.checkpoint``, the reference's on-disk format)."""
