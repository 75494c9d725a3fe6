"""snerf_tpu_torch: the PyTorch / CUDA port of snerf_tpu for one NVIDIA H100.

It mirrors snerf_tpu's module paths and is held against that package in
tests/test_torch_*.py. It imports torch and never jax; from snerf_tpu it
imports only the flag dataclass in snerf_tpu.config.

  ops/       math (lr schedule, grad clipping), rays, coord, mip, sampling,
             stepfun, render, lie; fused_mlp (K1, forward and backward),
             hash_ops (K2)
  csrc/      CUDA C++ kernels for sm_90a, built at first use
  models/    NerfMLP / ProposalMLP, the mip model (eval and randomized
             training forward), LearnPose; HashEncoding and the zip
             model (eval, hash arm)
  data/      pinhole ray generation, Scene, the synthetic scene, the
             training-batch sampler
  train/     chunked image rendering; the mip loss set and train step
  utils/     flax -> torch weight bridges, seeded inits
  config.py  model and train configs from snerf_tpu.config.Config
"""
