"""Launch helpers of the port: process groups and device meshes
(``mesh.py``)."""

from repro_torch.launch import mesh  # noqa: F401
