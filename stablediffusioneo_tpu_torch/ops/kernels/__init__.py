"""Hand-written CUDA kernels (sources in stablediffusioneo_tpu_torch/csrc/),
their ctypes wrappers and their plain PyTorch versions."""
