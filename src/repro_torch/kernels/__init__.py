"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions (``ref``) and the dispatching entry point
(``ops``)."""
