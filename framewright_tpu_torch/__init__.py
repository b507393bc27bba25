"""framewright_tpu_torch: the PyTorch/CUDA port of framewright_tpu.

The JAX package (``framewright_tpu``) stays the reference; this package
imports neither ``jax`` nor anything of ``framewright_tpu`` and keeps its
own copy of what it needs. Its module names follow the JAX package's so
that each counterpart is easy to find.

The restore is ported: Y4M in, an RRDB model (RealESRGAN_x2plus, 23
blocks, by default) or an SRVGG model (realesr-animevideov3, ...), in
bf16 or static int8, through hand-written Hopper kernels (``ops/csrc``),
Y4M out. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
