"""repro_torch.parallel — the fleet's batch helpers and scenario-axis
specs (``fleet``, port of ``repro.parallel.fleet``) and the spec side of
the sharding rules (``sharding``). The sharded paths split the scenario
axis over a ``launch.mesh.ScenariosMesh``."""
