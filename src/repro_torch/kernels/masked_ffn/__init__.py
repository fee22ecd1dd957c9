"""masked_ffn: packed N-sample masked FFN (``csrc/masked_ffn.cu``)."""
