"""Launch layer of the port: process groups and device meshes
(``mesh.py``), the one-process dry-run of every cell on the production
mesh (``dryrun.py``) and its sweep (``sweep.py``). The dry-run and the
sweep are run as modules (``python -m``), not imported here."""

from repro_torch.launch import mesh  # noqa: F401
