"""Batch render entry point of the port (counterpart of render.py):

  python -m snerf_tpu_torch.cli.render --config <file> [--key value ...]
      [--render_mode test|path|random] [--render_n N] [--render_seed S]
      [--out_dir DIR] [--device cuda|cpu]

Restores the newest checkpoint (or `--ckpt N`) of the experiment and
renders `--render_n` views: the test split (`test`), an elliptical path
around the training cameras (`path`, which also saves render_poses.npy
and intrinsic.npy) or random novel poses around the training trajectory
(`random`, the S-NeRF++ simulation pipeline's backgrounds: Waymo's
random poses, or whole 6-camera rigs on a nuScenes scene, drawn from
`--render_seed`; it also saves raw_target_poses.npy, render_poses.npy
and intrinsic.npy). Writes rgb/<i:05d>.png, depth/<i:05d>.png (uint16:
distance / scene scale x 256) and semantic/<i:05d>.npy (semantic models)
under <exp_dir>/render or `--out_dir`: the file set of
random_render_waymo_seq.py.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from snerf_tpu_torch.cli import common
from snerf_tpu_torch.data import camera_utils
from snerf_tpu_torch.data.png import write_png
from snerf_tpu_torch.flags import load_config_with_snapshot
from snerf_tpu_torch.train import checkpoints as ckpt_lib
from snerf_tpu_torch.train.renderer import render_image
from snerf_tpu_torch.train.zip_trainer import eval_weights

_EXTRA = {"render_n": 70, "render_mode": "test", "render_seed": 0,
          "out_dir": None, "device": "cuda"}


def main(argv=None):
  argv, extra = common.split_flags(argv, _EXTRA)
  device = common.resolve_device(extra["device"])
  mode = extra["render_mode"]
  if mode not in ("test", "path", "random"):
    raise ValueError(f"unknown --render_mode {mode!r}")
  cfg = load_config_with_snapshot(argv)
  common.reject_scan_render(argv, cfg)
  exp_dir = cfg.exp_dir()
  ckpt_dir = os.path.join(exp_dir, "checkpoints")
  out_dir = extra["out_dir"] or os.path.join(exp_dir, "render")
  for sub in ("rgb", "depth", "semantic"):
    os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

  scene = common.load_scene(cfg)
  model, state = common.build_model_state(cfg, scene.num_images, device)
  state, restored = ckpt_lib.restore_checkpoint(
      ckpt_dir, state, step=None if cfg.ckpt < 0 else cfg.ckpt)
  if restored is None:
    raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
  print(f"rendering from checkpoint step {restored}")

  n_render = int(extra["render_n"])
  H, W = scene.hw
  hws = None
  if mode == "random":
    poses, Ks, hws = random_poses(cfg, scene, n_render,
                                  int(extra["render_seed"]), out_dir)
  elif mode == "path":
    poses = camera_utils.generate_ellipse_path(scene.poses, n_frames=n_render)
    Ks = np.tile(scene.intrinsics[:1], (len(poses), 1, 1))
    np.save(os.path.join(out_dir, "render_poses.npy"), poses)
    np.save(os.path.join(out_dir, "intrinsic.npy"), Ks)
  else:
    idxs = np.asarray(scene.i_test)[:n_render]
    poses, Ks = scene.poses[idxs], scene.intrinsics[idxs]

  with eval_weights(state):
    render_fn = common.render_fn_for(cfg, model)
    for i in range(len(poses)):
      hi, wi = (H, W) if hws is None else (int(hws[i][0]), int(hws[i][1]))
      rays = common.image_rays(scene, poses[i], Ks[i], device, hi, wi,
                               render_factor=cfg.render_factor)
      out = common.to_numpy(render_image(render_fn, rays, chunk=cfg.chunk))
      write_png(os.path.join(out_dir, "rgb", f"{i:05d}.png"),
                (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
      # depth as a uint16 png: metric depth / scale * 256
      # (random_render_waymo_seq.py:196-204 contract)
      d = out["distance"][..., 0] / max(scene.scale, 1e-12) * 256.0
      write_png(os.path.join(out_dir, "depth", f"{i:05d}.png"),
                np.clip(d, 0, 65535).astype(np.uint16))
      if "semantic" in out:
        np.save(os.path.join(out_dir, "semantic", f"{i:05d}.npy"),
                np.argmax(out["semantic"], axis=-1).astype(np.int32))
      print(f"rendered {i + 1}/{len(poses)}")
  print(f"outputs under {out_dir}")
  return out_dir


def random_poses(cfg, scene, n_render: int, seed: int, out_dir: str):
  """render.py's random mode: novel poses around the training trajectory
  (Waymo's forward and side cameras from the first and last views'
  intrinsics, or whole `cam_num` rigs on a nuScenes scene), saved with
  their raw-frame poses (render2raw through the scene's PCA transform)
  and intrinsics. Returns (poses [N, 3, 4], Ks [N, 3, 3], hws [N, 2])."""
  from snerf_tpu_torch.data import waymo
  hw = np.array(scene.hw)
  if cfg.dataset_type == "nuscenes":
    cam_num = max(cfg.cam_num, 1)
    pose_set = waymo.generate_nuscenes_render_poses(
        scene.poses, scene.intrinsics, hw, scene.scale,
        n_render=max(n_render // cam_num, 1), cam_num=cam_num, seed=seed)
  else:
    pose_set = waymo.generate_random_render_poses(
        scene.poses, scene.intrinsics[0], scene.intrinsics[-1], hw, hw,
        scene.scale, n_render=n_render, seed=seed)
  transform = getattr(scene, "pca_transform", np.eye(4))
  raw = waymo.render2raw(pose_set.poses, transform, scene.scale, np.eye(4))
  np.save(os.path.join(out_dir, "raw_target_poses.npy"), raw)
  np.save(os.path.join(out_dir, "render_poses.npy"), pose_set.poses)
  np.save(os.path.join(out_dir, "intrinsic.npy"), pose_set.intrinsics)
  return pose_set.poses[:, :3, :], pose_set.intrinsics, pose_set.hws


if __name__ == "__main__":
  main(sys.argv[1:])
