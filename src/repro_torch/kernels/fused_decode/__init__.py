"""The fused serving-decode step: ``ref.py`` (plain version), ``ops.py``
(wrapper of ``csrc/fused_decode.cu``)."""
