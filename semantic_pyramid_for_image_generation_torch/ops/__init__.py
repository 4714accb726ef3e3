"""Core numerical ops: spectral norm, pooling, resampling, and the CUDA
kernel wrappers (`ops.cuda`)."""
