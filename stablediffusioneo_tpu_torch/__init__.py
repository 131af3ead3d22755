"""PyTorch + CUDA port of stablediffusioneo_tpu for NVIDIA Hopper (H100).

The JAX package (stablediffusioneo_tpu) stays the reference; this package
mirrors its layout (ops/, models/, pipeline/, runtime/, checkpoint/) module
for module. Plain tensor code is PyTorch; the JAX package's Pallas kernels
on the ported path are hand-written CUDA under csrc/, built with nvcc at
first use. The package imports no JAX; from the JAX package it reuses only
the JAX-free `config` and, inside the functions that need cv2,
`annotators.canny` / `annotators.util`.

Main path: pipeline.canny2image.Canny2ImagePipeline.process.
"""

__version__ = "0.1.0"
