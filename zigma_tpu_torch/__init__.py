"""zigma_tpu_torch: the PyTorch + CUDA port of zigma_tpu for NVIDIA Hopper.

The JAX package ``zigma_tpu`` stays beside it as the reference; this package
imports torch and never jax, and nothing of ``zigma_tpu``.  This slice runs
the serving path: the ZigMa denoiser sampled by fixed-step ODE through a
hand-written selective-scan forward kernel (``ops/scan_cuda.py``).
"""
