"""Serving: voxel-uncertainty streaming over compiled plans."""
