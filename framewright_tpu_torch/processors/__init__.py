"""Frame processors of the port: super-resolution and video SR, the
pre-SR stream's stages (deinterlacer, VHS repair, film repair,
stabilizer, inpainting, QP removal, temporal denoiser with its noise
profile and scene scores, cross-frame attention, the latent temporal
model, the scene-adaptive filter), the post-SR stages (faces, guided
enhancement, grain, HDR), interpolation and content analysis."""
