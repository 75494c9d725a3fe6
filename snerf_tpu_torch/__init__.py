"""snerf_tpu_torch: the PyTorch / CUDA port of snerf_tpu for one NVIDIA H100.

It mirrors snerf_tpu's module paths and is held against that package in
tests/test_torch_*.py. It imports torch and never jax, and nothing of
snerf_tpu: what it needs of a JAX-free module there (the flag dataclass,
the scene) it keeps as its own copy.

  ops/       math (lr schedule, grad clipping), rays, coord, mip, sampling,
             stepfun, render, lie; fused_mlp (K1, forward and backward),
             hash_encode (K2 redesigned: the fused multi-level hash
             encode, forward and backward), hash_ops (K2's row gather and
             scatter-add, on no path)
  csrc/      CUDA C++ kernels for sm_90a, built at first use
  models/    NerfMLP / ProposalMLP, the mip model (eval and randomized
             training forward), LearnPose; HashEncoding and the zip
             model (hash arm, eval and randomized training forward)
  data/      pinhole ray generation, Scene, the nuScenes loader, camera
             paths, the synthetic scene, the training-batch sampler; png
             (PNG read/write and cv2's bilinear resize, no imageio/cv2)
  train/     chunked image rendering; the mip and zip loss sets and train
             steps; checkpoints
  cli/       the entry points: python -m snerf_tpu_torch.cli.train|eval|
             render (train.py's, eval.py's and render.py's flags, plus
             --device)
  probes/    the gather probes (P1, P2) and the primitive survey
  utils/     flax -> torch weight bridges, seeded inits; metrics; the
             experiment logger; the profile window
  flags.py   the flag dataclass, its config-file / CLI parser, the
             experiment snapshot
  config.py  model and train configs from flags.Config
  bench.py, bench_quality.py
             the throughput line and the held-out quality cells (card
             only)
"""
