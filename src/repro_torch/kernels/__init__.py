"""Hand-written CUDA kernels of the port: ``csrc/*.cu`` sources, one package
per kernel with its plain PyTorch version (``ref.py``) and its wrapper
(``ops.py``), and the nvcc/ctypes builder (``_build.py``)."""
