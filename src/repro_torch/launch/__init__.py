"""The port's command-line entry points (``launch.serve``)."""
