"""Training entry point of the port (counterpart of train.py):

  python -m snerf_tpu_torch.cli.train --config <file> [--key value ...]
      [--device cuda|cpu]

Same flags as train.py, read by the port's own parser, plus `--device`
(default cuda; without a card it raises, pass `--device cpu` to run on
the CPU). It loads the scene, builds the model state (mip or zip by
`--model`), resumes from the newest checkpoint (`--resume`, default on),
with `--depth_conf` on a scene with depth precomputes the confidence
maps on the device (`--tau`, `--conf_num`, the vgg mode with
`--vgg_loss`; always, as train.py does, whatever `--precompute_conf`
says), and runs the eager training loop: a step's draws come from a
torch.Generator seeded `start_step + 1`, as train.py seeds its key, so a
resumed run continues but does not repeat an uninterrupted one. Every
`i_print` steps it prints and logs the loss, PSNR and rays/s, and the
histograms of the pose rotations and the confidence lambdas; every
`i_testset` it renders the first held-out view; every `i_weights` (and at
the end) it saves a checkpoint, and the mip path also the pose stream.
Products are float32 (TF32 off), but the zip MLPs train in
`--zip_compute_dtype`, bfloat16 by default as in train.py (the test-view
render runs them in float32, as eval and render do).

Raises where the port has no counterpart yet: `--unroll_steps > 1` (the
scanned multi-step loop; a CUDA-graph loop is later work, ROADMAP Queue
1, item 1) and `--tp > 1` (F, Queue 1, item 9).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from snerf_tpu_torch.cli import common
from snerf_tpu_torch.data.png import resize_bilinear
from snerf_tpu_torch.data.sampler import scene_to_device
from snerf_tpu_torch.flags import load_config, snapshot_config
from snerf_tpu_torch.train import checkpoints as ckpt_lib
from snerf_tpu_torch.train.renderer import render_image
from snerf_tpu_torch.train.zip_trainer import eval_weights
from snerf_tpu_torch.utils.logging import ExperimentLogger
from snerf_tpu_torch.utils.profiling import ProfileWindow


def _check_supported(cfg):
  if int(cfg.unroll_steps) > 1:
    raise NotImplementedError(
        f"--unroll_steps {cfg.unroll_steps}: the multi-step loop is not "
        "ported (a CUDA-graph loop is later work, ROADMAP Queue 1, item 1); "
        "the port steps eagerly, pass --unroll_steps 1")
  if int(cfg.tp or 1) > 1:
    raise NotImplementedError(
        f"--tp {cfg.tp}: tensor parallelism is not ported (F, ROADMAP "
        "Queue 1, item 9)")


def render_test_view(render_fn, scene, cfg, device):
  """Render the first held-out view (train.py `_render_one_test_view`):
  downscaled above 128 x 128 pixels (render_factor, else 4x). Returns
  (psnr, rgb [H, W, 3] numpy in [0, 1])."""
  ti = int(scene.i_test[0])
  H, W = scene.hw
  rf = 0
  if H * W > 128 * 128:
    rf = cfg.render_factor if cfg.render_factor > 1 else 4
  rays = common.image_rays(scene, scene.poses[ti], scene.intrinsics[ti],
                           device, H, W, render_factor=rf)
  rgb = render_image(render_fn, rays, chunk=cfg.chunk)["rgb"].cpu().numpy()
  gt = scene.images[ti].astype(np.float32) / 255.0
  if rgb.shape[:2] != gt.shape[:2]:
    gt = resize_bilinear(gt, rgb.shape[0], rgb.shape[1])
  mse = float(np.mean((rgb - gt) ** 2))
  return -10.0 * np.log10(max(mse, 1e-10)), np.clip(rgb, 0, 1)


def _log_step(logger, i, metrics, rays_done, t0):
  m = {k: float(v) for k, v in metrics.items()}
  rps = rays_done / (time.perf_counter() - t0)
  print(f"[{i}] loss={m['loss']:.5f} psnr={m.get('psnr', 0):.2f} "
        f"rays/sec={rps:.0f}")
  logger.scalars(i, {"rays_per_sec": rps, **m})


def precompute_conf(tcfg, scene, dev_scene, device):
  """The confidence maps of the train views (train.py:123-134), on the
  device: [n_train, n_modes, H, W] uint8."""
  from snerf_tpu_torch.models.confidence import precompute_conf_maps
  from snerf_tpu_torch.models.features import make_feature_fn
  feature_fn = (make_feature_fn(device=device)
                if "vgg" in tcfg.conf_modes else None)
  print(f"precomputing confidence maps ({tcfg.conf_modes}) ...")
  conf_maps = precompute_conf_maps(tcfg.conf_modes, scene, dev_scene,
                                   conf_num=tcfg.conf_num,
                                   tau=tcfg.conf_tau, feature_fn=feature_fn)
  print(f"conf maps: {tuple(conf_maps.shape)} {conf_maps.dtype}")
  return conf_maps


def main(argv=None):
  argv, extra = common.split_flags(argv, {"device": "cuda"})
  device = common.resolve_device(extra["device"])
  common.float32_numerics()
  cfg = load_config(argv)
  _check_supported(cfg)
  snapshot_config(cfg)
  exp_dir = cfg.exp_dir()
  ckpt_dir = os.path.join(exp_dir, "checkpoints")

  scene = common.load_scene(cfg)
  # half_train keeps every other train view, fulltrain trains on all
  # (train.py:102-105)
  if cfg.half_train and scene.i_train is not None:
    scene.i_train = scene.i_train[::2]
  if cfg.fulltrain:
    scene.i_train = np.arange(scene.num_images)
  dev_scene = scene_to_device(scene, device)
  if cfg.model == "zipnerf":
    return train_zipnerf(cfg, scene, dev_scene, exp_dir, ckpt_dir, device)

  from snerf_tpu_torch.config import train_config
  from snerf_tpu_torch.train.trainer import make_train_step
  tcfg = train_config(cfg)
  model, state = common.build_model_state(cfg, scene.num_images, device)

  start_step = 0
  if cfg.resume:
    state, restored = ckpt_lib.restore_checkpoint(ckpt_dir, state)
    if restored is not None:
      start_step = restored
      print(f"resumed from step {start_step}")

  conf_maps = None
  if cfg.depth_conf and scene.depths is not None:
    conf_maps = precompute_conf(tcfg, scene, dev_scene, device)

  logger = ExperimentLogger(exp_dir)
  step_fn = make_train_step(model, state.pose_model, tcfg, dev_scene,
                            scene.i_train, scene.near, scene.far,
                            conf_maps=conf_maps)
  gen = torch.Generator(device=device).manual_seed(start_step + 1)
  render_fn = common.render_fn_for(cfg, model)
  prof = ProfileWindow(cfg, exp_dir, device)
  t0, rays_done = time.perf_counter(), 0
  for i in range(start_step + 1, cfg.N_iters + 1):
    prof.tick(i)
    metrics = step_fn(state, gen)
    rays_done += cfg.N_rgb
    if i % cfg.i_print == 0:
      _log_step(logger, i, metrics, rays_done, t0)
      # the reference's histograms (train.py:225-241)
      if state.conf_model is not None:
        logger.histogram(i, "confidence_lambdas",
                         state.conf_model.lambdas.detach().cpu().numpy())
      if state.pose_model is not None:
        logger.histogram(i, "pose_rotations",
                         state.pose_model.r.detach().cpu().numpy())
      t0, rays_done = time.perf_counter(), 0
    if cfg.i_testset > 0 and i % cfg.i_testset == 0 and len(scene.i_test):
      with eval_weights(state):
        psnr, img = render_test_view(render_fn, scene, cfg, device)
      print(f"[{i}] test view PSNR = {psnr:.2f}")
      logger.scalars(i, {"test_psnr": psnr})
      logger.image(i, "test_render", img)
    if i % cfg.i_weights == 0 or i == cfg.N_iters:
      ckpt_lib.save_checkpoint(ckpt_dir, state, i, keep=cfg.ckpt_keep)
      if state.pose_model is not None:
        # the separate pose stream (reference train.py:275-280)
        ckpt_lib.save_pose_checkpoint(exp_dir, state.pose_model.state_dict(),
                                      i, keep=cfg.ckpt_keep)
      print(f"saved checkpoint at step {i}")
  prof.close()
  logger.close()
  return state


def train_zipnerf(cfg, scene, dev_scene, exp_dir, ckpt_dir, device):
  """The zip-nerf (S-NeRF++ background) loop (train.py `train_zipnerf`)."""
  from snerf_tpu_torch.config import zip_train_config
  from snerf_tpu_torch.train.zip_trainer import make_zip_train_step
  tcfg = zip_train_config(cfg)
  model, state = common.build_model_state(cfg, scene.num_images, device)
  logger = ExperimentLogger(exp_dir)

  start_step = 0
  if cfg.resume:
    state, restored = ckpt_lib.restore_checkpoint(ckpt_dir, state)
    if restored is not None:
      start_step = restored
      print(f"resumed from step {start_step}")

  step_fn = make_zip_train_step(model, tcfg, dev_scene, scene.i_train,
                                scene.near, scene.far)
  gen = torch.Generator(device=device).manual_seed(start_step + 1)
  render_fn = common.render_fn_for(cfg, model)
  prof = ProfileWindow(cfg, exp_dir, device)
  t0, rays_done = time.perf_counter(), 0
  for i in range(start_step + 1, tcfg.max_steps + 1):
    prof.tick(i)
    metrics = step_fn(state, gen)
    rays_done += tcfg.batch_size
    if i % cfg.i_print == 0:
      _log_step(logger, i, metrics, rays_done, t0)
      t0, rays_done = time.perf_counter(), 0
    if cfg.i_testset > 0 and i % cfg.i_testset == 0 and len(scene.i_test):
      with eval_weights(state):
        psnr, _ = render_test_view(render_fn, scene, cfg, device)
      print(f"[{i}] test view PSNR = {psnr:.2f}")
      logger.scalars(i, {"test_psnr": psnr})
      t0, rays_done = time.perf_counter(), 0
    if i % cfg.i_weights == 0 or i == tcfg.max_steps:
      ckpt_lib.save_checkpoint(ckpt_dir, state, i, keep=cfg.ckpt_keep)
      print(f"saved checkpoint at step {i}")
  prof.close()
  logger.close()
  return state


if __name__ == "__main__":
  main(sys.argv[1:])
