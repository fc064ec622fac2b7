"""repro_torch.parallel — the fleet's batch helpers and scenario-axis
specs (``fleet``, port of ``repro.parallel.fleet``), the spec side of
the sharding rules (``sharding``) and the sums that join the ``model``
positions' shares of a split training step (``model_split``). The
sharded paths split the scenario axis over a
``launch.mesh.ScenariosMesh``."""
