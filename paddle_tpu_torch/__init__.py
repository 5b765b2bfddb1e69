"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The port runs the LLaMA serving path of ``paddle_tpu`` (HTTP front,
continuous-batching engine, packed prefill, paged decode) in PyTorch, with
hand-written CUDA kernels for sm_90a where the JAX package has Pallas TPU
kernels.  It imports neither ``jax`` nor ``paddle_tpu``.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``, where every
kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
