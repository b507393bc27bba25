"""framewright_tpu_torch: the PyTorch/CUDA port of framewright_tpu.

The JAX package (``framewright_tpu``) stays the reference; this package
imports neither ``jax`` nor anything of ``framewright_tpu`` and keeps its
own copy of what it needs. Its module names follow the JAX package's so
that each counterpart is easy to find.

The restore is ported: Y4M, a PNG frame directory or (with ffmpeg) any
container in, an RRDB model (RealESRGAN_x2plus, 23
blocks, by default) or an SRVGG model (realesr-animevideov3, ...), in
bf16, float32 or int8, through hand-written Hopper kernels
(``ops/csrc``), the same formats out, with the JAX default's checkpoint and resume
(``engine.checkpoint``), quality gate (``ops.metrics``,
``quality.validators``, ``reports``), continue-on-error, deinterlacing
and long-form drift correction, the ``quality`` preset's temporal
denoiser and cross-frame attention before SR, deduplication, film repair
and grain, and the ``archive`` preset's face restoration (GFPGAN,
RetinaFace) and frame interpolation (IFNet) after it; HAT_SRx4, the
video SR models BasicVSR and TVSR_x4, the SR ensemble, ``outscale``, the
enhancement cap and guided enhancement, and the denoiser's Restormer and
RAFT, in plain PyTorch (no kernel of their own, as they are XLA in
JAX). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU
every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
