"""photon_tpu_torch: the PyTorch and CUDA port of photon_tpu.

GLMix serving on an NVIDIA GPU (Hopper, sm_90a): checkpoints, device
coefficient tables, the micro-batch queue and a hand-written CUDA kernel
for the fused serve score. It imports torch, numpy and the standard
library only; the JAX package ``photon_tpu`` stays the reference.
"""
