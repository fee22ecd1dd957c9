"""The four user-facing examples, as modules of the port (the twins of the
repository's ``examples/``): run each as ``python -m
repro_torch.examples.<name>`` (on the card; ``--device cpu`` for the
CPU). Each keeps its work in a function that returns what it computed,
and ``main(argv)`` prints it."""
