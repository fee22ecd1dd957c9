"""Model configurations: the schema, the architecture registry and the
dry-run cells (``cells.py``)."""
