"""The port's serving steps of the model zoo (``serve.step``)."""
