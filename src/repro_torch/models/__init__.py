"""The port's model zoo: the decoder-only transformer of the ``dense`` and
``moe`` families (``transformer``), its layers and its MoE layer."""
