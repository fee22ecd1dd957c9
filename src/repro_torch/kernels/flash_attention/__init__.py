"""flash_attention: causal or full GQA prefill attention with an online
softmax (``csrc/flash_attention.cu``)."""
