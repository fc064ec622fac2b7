"""The port's command-line entry points (``launch.serve``) and the
scenarios mesh of the sharded paths (``launch.mesh``)."""
