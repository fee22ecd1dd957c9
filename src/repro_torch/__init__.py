"""PyTorch/CUDA port of the mask-based Bayesian NN serving stack.

A second package beside the JAX/Pallas reference ``repro``: the same module
layout (``core/``, ``kernels/<name>/{ref,ops}.py``, ``ivim/``, ``serving/``),
written in PyTorch's idiom, with every Pallas kernel on the ported path
rewritten as a hand-written CUDA C++ kernel for Hopper (``sm_90a``) under
``kernels/csrc/``.

Dispatch is by tensor device: a kernel wrapper given a CPU tensor runs the
plain PyTorch version beside it (``ref.py``); given a CUDA tensor it launches
the CUDA kernel or raises. Entry points take ``device=None``, which resolves
to CUDA and raises when no card is present (:mod:`repro_torch.device`).

This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``.
"""
