"""Model configurations: the schema and the architecture registry."""
