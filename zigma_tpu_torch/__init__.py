"""zigma_tpu_torch: the PyTorch + CUDA port of zigma_tpu for NVIDIA Hopper.

The JAX package ``zigma_tpu`` stays beside it as the reference; this package
imports torch and never jax, and nothing of ``zigma_tpu``.  It runs the
serving path (the ZigMa denoiser sampled by fixed-step ODE, ``cli/sample.py``)
and the training path (flow matching with AdamW and EMA, ``cli/train.py``)
through hand-written selective-scan kernels, forward and backward
(``ops/scan_cuda.py``).
"""
