"""repro_torch.serve — serving layers (port of ``repro.serve``).

* ``serve.asa`` / ``serve.loop`` — ASA-as-a-service: a batched
  submit-lead-time decision step over a fixed-slot tenant table of
  Algorithm-1 posteriors on the device, wrapped in a stdlib event loop
  (request queue → padded batches → one step), with its supervisor,
  checkpoints and chaos hooks (``serve.chaos``).
* ``serve.step`` — KV/SSM state model-serving steps (prefill/decode) for
  the model zoo under ``repro_torch.models``.
"""
