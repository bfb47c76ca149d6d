"""Box geometry and NMS (plain PyTorch), and the CUDA kernels under
``ops.kernels``."""
