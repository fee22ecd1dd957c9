"""Core of the port: masks, packing, scheduling, uncertainty, the PackedPlan
compiler and its executors."""
