"""The plain float32 PyTorch reference that decides a run's `correct`.

It imports nothing of the measured program (`stablediffusioneo_tpu_torch`)
or of the JAX package, and takes nothing the program made: the benchmark
draws the weights and the inputs and hands the same to both sides.
"""
