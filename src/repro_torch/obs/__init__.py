"""Observability for the port's fleet simulator (port of ``repro.obs``).

* ``obs.trace`` — device-resident per-scenario event rings, appended
  inside the event loop (``trace=None`` skips every append).
* ``obs.metrics`` — counters and histograms over finished sweeps, reduced
  over the batch on the state's device; the host-side replay of the ASA
  chain's waits from a ring.
* ``obs.export`` — host-side decoding to Chrome trace-event JSON and
  JSONL, schema validation, ``torch.profiler`` wiring.
* ``obs.telemetry`` — the port's copy of the stdlib-only telemetry
  schema.

Deliberately NOT importing submodules here: ``obs.telemetry`` itself
imports nothing beyond the standard library.
"""
