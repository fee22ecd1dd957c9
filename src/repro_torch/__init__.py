"""PyTorch/CUDA port of the mask-based Bayesian NN serving stack.

A second package beside the JAX/Pallas reference ``repro``: the same module
layout (``configs/``, ``core/``, ``models/``, ``kernels/<name>/{ref,ops}.py``,
``ivim/``, ``serving/``), written in PyTorch's idiom, with every Pallas
kernel on the ported paths rewritten as a hand-written CUDA C++ kernel for
Hopper (``sm_90a``) under ``kernels/csrc/``.

Ported so far:

* uIVIM-NET voxel uncertainty: ``ivim.model.pack_for_serving`` ->
  ``serving.engine.predict_volume``, through the ``fused_plan`` kernel
  (moments mode; samples mode for ``packed_apply``) with ``masked_ffn`` as
  the per-op tier.
* Bayesian LM serving for every architecture of the registry: ``configs``,
  ``models`` (layers, transformer, model; rglru, moe and xlstm blocks,
  M-RoPE, and ``forward`` for the encoder-only stack),
  ``serving.engine.generate`` and ``serve_uncertain`` over
  ``serving.server.step_fns``, whose decode step on dense attention
  stacks is the ``fused_decode`` kernel (one cooperative launch per step)
  with the per-op ``models.transformer.decode_step`` for the rest; the
  continuous-batching server and the multi-host router over it.
* LM training: ``data`` (seeded stateless batches), ``models.model.Model
  .loss`` over ``transformer.forward_train`` (the reference's training
  graph, remat by ``torch.utils.checkpoint``; the RG-LRU scan forward and
  backward through its kernel and ``RGLRUScan``), ``optim`` (AdamW,
  Adafactor), ``train`` (``make_train_step``, ``Trainer``) and
  ``distributed.checkpoint`` / ``compression`` (checkpoints the reference
  reads, int8 error feedback).

Dispatch is by tensor device: a kernel wrapper given a CPU tensor runs the
plain PyTorch version beside it (``ref.py``); given a CUDA tensor it launches
the CUDA kernel or raises. On either device a wrapper refuses an operand
that requires grad while autograd records (its output would be detached). Entry points take ``device=None``, which resolves
to CUDA and raises when no card is present (:mod:`repro_torch.device`).

This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``.
"""
