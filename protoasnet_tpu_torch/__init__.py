"""PyTorch/CUDA port of ProtoASNet for NVIDIA Hopper (H100).

The JAX package ``protoasnet_tpu`` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``; the prototype head runs a hand-written CUDA kernel on the
card (``csrc/roi_cosine.cu``) and its plain PyTorch version on the CPU.
"""

__version__ = "0.1.0"
