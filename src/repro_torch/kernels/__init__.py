"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and the public entry
points (``ops``)."""
