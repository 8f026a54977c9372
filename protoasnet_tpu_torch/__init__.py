"""PyTorch/CUDA port of ProtoASNet for NVIDIA Hopper (H100).

The JAX package ``protoasnet_tpu`` is the reference; this package imports
neither it nor JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``. Every kernel the JAX package wrote in Pallas has a
hand-written CUDA counterpart under ``csrc/`` (the prototype heads, and the
R(2+1)D block kernels run by ``experiments/``); on the card the wrappers in
``ops/`` launch them, on the CPU they run the plain PyTorch versions.
"""

__version__ = "0.1.0"
