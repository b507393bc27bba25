"""Frame processors of the port: super-resolution, and the pre-SR
stream's deinterlacer, temporal denoiser (with its noise profile and scene
scores) and cross-frame attention."""
