"""Stdlib-only static checks of the port's own invariants (the port's
twin of ``repro.analysis``, written for ``repro_torch``).

The port keeps rules that no test sees until it is too late: it imports
nothing of JAX or of the reference package, it builds no kernel and
touches no card at import, each kernel package ships its plain version,
its wrapper and the CUDA source the wrapper launches, the serving path
reads the injectable clock, library code raises instead of asserting, and
the fused decode step's kinds agree across its plain version, its kernels'
lowerings and its pricing. These are AST checks, aliased imports included.

Layout:

* :mod:`repro_torch.analysis.rules`   — the catalog, :class:`Finding`,
  suppressions (``# repro: ignore[rule-id]`` on the flagged line).
* :mod:`repro_torch.analysis.checker` — the per-file visitor and
  :func:`~repro_torch.analysis.checker.analyze`.
* :mod:`repro_torch.analysis.project` — the cross-file checks (kernel
  trio, fused-kind exhaustiveness).
* :mod:`repro_torch.analysis.cli`     — ``python -m
  repro_torch.analysis.cli src/repro_torch`` (text or ``--json``; exit 1
  on any unsuppressed finding).

Imports nothing beyond the standard library, so it runs before anything
is installed and cannot touch a device.
"""

from __future__ import annotations

#: Checker version, printed by the CLI. Bump on any rule change.
__version__ = "1.0.0"

__all__ = ["__version__"]
