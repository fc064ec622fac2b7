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
* ``obs.registry`` / ``obs.serve_obs`` — the port's copies of the
  stdlib-only live-metrics registry and the serving loop's
  request-lifecycle spans (``serve.loop.ASAServer``'s metrics, scrape
  endpoint and the serve rows of the merged Chrome trace).

Deliberately NOT importing submodules here: ``obs.telemetry``,
``obs.registry`` and ``obs.serve_obs`` import nothing beyond the standard
library.
"""
