"""snerf_tpu_torch: the PyTorch / CUDA port of snerf_tpu for one NVIDIA H100.

It mirrors snerf_tpu's module paths and is held against that package in
tests/test_torch_*.py. It imports torch and never jax; from snerf_tpu it
imports only the flag dataclass in snerf_tpu.config.

  ops/       math, rays, coord, mip, sampling, render; fused_mlp (kernel)
  csrc/      CUDA C++ kernels for sm_90a, built at first use
  models/    NerfMLP / ProposalMLP and the mip model (eval mode)
  data/      pinhole ray generation, Scene, the synthetic scene
  train/     chunked image rendering
  utils/     flax -> torch weight bridge, seeded init
  config.py  model config from snerf_tpu.config.Config
"""
