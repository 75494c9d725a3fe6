"""Training-throughput benchmark of the port (counterpart of bench.py):

  python -m snerf_tpu_torch.bench

Prints one JSON line with bench.py's keys, {"metric":
"train_rays_per_sec", "value", "unit", "vs_baseline"}, plus "precision"
and "device" (the card's name and power limit from nvidia-smi).
vs_baseline is null: bench.py's anchor is an estimate for an A100, not a
measurement of this card.

The workload is bench.py's: the S-NeRF shipped nuScenes model (4,096
rays a step, 128 + 128 samples, width 1024 with 3 rgb layers, cone rays,
the fn2 warp with the log s->t map), proposal + rgb + depth losses and
Adam, on the 96 x 128 synthetic scene, with the MLPs in bf16
(compute_dtype bfloat16: the trunks' square runs on K1's bf16 kernels;
their first layers, the skip-cat layer, the bottleneck and the condition
layers on cuBLAS bf16; float32 heads), as bench.py trains it. Where
bench.py runs 15 steps inside a lax.scan, the port runs eager steps. Two
warm-up steps, then TIMED_STEPS steps on the host clock, ended by a
synchronize. Runs on a CUDA card only.
"""

from __future__ import annotations

import json
import time

import torch

TIMED_STEPS = 30
N_RGB = 4096


def main():
  from snerf_tpu_torch.bench_quality import card_info
  from snerf_tpu_torch.cli.common import resolve_device
  from snerf_tpu_torch.data.sampler import scene_to_device
  from snerf_tpu_torch.data.synthetic import make_synthetic_scene
  from snerf_tpu_torch.models.mipnerf import MipNerfConfig
  from snerf_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                             make_train_step)

  device = resolve_device("cuda")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_info()
  scene = make_synthetic_scene(num_images=6, H=96, W=128)
  mcfg = MipNerfConfig(
      num_samples=128, num_fine=128, hidden_layer=1024, rgb_layer=3,
      proposal_hidden_layer=256, ray_shape="cone", no_warp_sample=False,
      warp_fn=1, t_transform="log", density_noise=0.0,
      compute_dtype=torch.bfloat16)
  tcfg = TrainConfig(n_rgb=N_RGB, depth_loss=True, proposal_loss=True)
  model, pose_model, state = create_train_state(0, mcfg, tcfg,
                                                scene.num_images,
                                                device=device)
  step = make_train_step(model, pose_model, tcfg,
                         scene_to_device(scene, device), scene.i_train,
                         scene.near, scene.far)
  gen = torch.Generator(device=device).manual_seed(1)
  for _ in range(2):
    step(state, gen)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(TIMED_STEPS):
    metrics = step(state, gen)
  last = float(metrics["loss"])
  dt = time.perf_counter() - t0
  if last != last:
    raise FloatingPointError("bench: the loss is NaN")
  print(json.dumps({
      "metric": "train_rays_per_sec",
      "value": round(N_RGB * TIMED_STEPS / dt, 1),
      "unit": "rays/s/chip",
      "vs_baseline": None,
      "precision": "bf16",
      "device": card,
  }))


if __name__ == "__main__":
  main()
