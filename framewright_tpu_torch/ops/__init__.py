"""The port's kernels and their plain PyTorch versions.

Each kernel module (fused_rrdb, fused_tail3, fused_tail, fused_srvgg)
keeps, beside its wrapper, the plain version of the same function, a
launch counter (``<wrapper>.launches``) and the weight layout the kernel
reads. The CUDA sources are in ``csrc/``; ``_build`` compiles them at
first use, one nvcc per source, all at once, then one link.
``metrics`` (PSNR, SSIM) is plain PyTorch, as the JAX package has it in
XLA; so is ``jax_random`` (JAX's threefry normal draw, the diffusion SR's
noise).
"""
