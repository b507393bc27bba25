"""framewright_tpu_torch: the PyTorch/CUDA port of framewright_tpu.

The JAX package (``framewright_tpu``) stays the reference; this package
imports neither ``jax`` nor anything of ``framewright_tpu`` and keeps its
own copy of what it needs. Its module names follow the JAX package's so
that each counterpart is easy to find.

Slice 1 covers the default restore: Y4M in, RealESRGAN_x2plus (RRDBNet,
23 blocks, bf16) through three hand-written Hopper kernels (``ops/csrc``),
Y4M out. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
