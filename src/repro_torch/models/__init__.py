"""The transformer stack of the LM serving path (dense attention blocks)."""
