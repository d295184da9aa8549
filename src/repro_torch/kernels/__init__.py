"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the device-dispatched entry points (``ops``)."""
