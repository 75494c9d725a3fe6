"""The mip cells' inputs, made from the seed: a nuScenes-layout sequence on
the device as S-NeRF's loader (`load_nuscenes_scene`) returns one that
`nuscenes_preprocess.py` and the depth completion left, split as
`cli.train` splits it.

The scene's sizes come from the configuration file's "scene" block. A car
drives a seeded gentle curve down a street; each frame, six cameras on
its roof (the nuScenes yaws) see it. The poses are camera-to-world in
the loader's [right, up, back] convention, in metres (the shipped config
sets bds_factor 0, so the loader scales nothing), recentred on their
average as the loader recentres them (a copy of its `_recenter_poses`).
The depth maps are dense, as S-NeRF's completed depth is: each pixel's
depth along the camera axis to the street's ground plane or its two
building fronts, clipped to the configured range, so neighbouring views
agree where they overlap and the depth confidence's reprojection means
something. The pixel content is smooth random fields: the cells measure
throughput and agreement with the reference, neither of which needs a
real street.

Views are camera-major (view = camera * frames + frame), as the loader
assigns `cam_index`; every `datahold`-th view is held out, and
`half_train` keeps every other remaining one, as `cli.train` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from bench_port.scene import _smooth, generator, sub_seed


@dataclasses.dataclass
class Layout:
  """Every view of the sequence: poses [N, 3, 4] (recentred, [r, u, -t]),
  intrinsics [N, 3, 3], cam_index [N], the train views `i_train` (after
  the hold-out and half_train), the image size, and the poses in the
  street's frame before recentring (`world_poses`, which the depth
  maps are cast in)."""
  poses: np.ndarray
  intrinsics: np.ndarray
  cam_index: np.ndarray
  i_train: np.ndarray
  hw: tuple
  world_poses: np.ndarray


def _normalize(x):
  return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
  vec2 = _normalize(z)
  vec0 = _normalize(np.cross(up, vec2))
  vec1 = _normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, pos], 1)


def recenter_poses(poses):
  """Poses [N, 3, 4] recentred around their average (a copy of the
  nuScenes loader's `_recenter_poses`)."""
  bottom = np.array([[0, 0, 0, 1.0]])
  center = poses[:, :3, 3].mean(0)
  c2w = _viewmatrix(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0), center)
  c2w = np.concatenate([c2w, bottom], 0)
  poses_h = np.concatenate(
      [poses[:, :3, :4], np.tile(bottom[None], (len(poses), 1, 1))], 1)
  return (np.linalg.inv(c2w) @ poses_h)[:, :3, :4]


def layout(spec: Dict, seed: int) -> Layout:
  """The six-camera rig along a seeded gentle curve; the train views the
  loader and `cli.train` keep."""
  rng = np.random.RandomState(sub_seed(seed, "nuscenes_layout", 32))
  cams, frames = spec["cameras"], spec["frames"]
  step = spec["metres_per_frame"]
  curve = rng.uniform(-spec["max_turn_rad"], spec["max_turn_rad"])
  poses = []
  for cam in range(cams):
    yaw_c = np.deg2rad(spec["camera_yaw_deg"][cam])
    mount = np.asarray(spec["camera_mount_m"][cam], np.float64)
    for f in range(frames):
      heading = curve * f
      pos = np.array([sum(step * np.cos(curve * k) for k in range(f)),
                      sum(step * np.sin(curve * k) for k in range(f)), 0.0])
      c, s = np.cos(heading), np.sin(heading)
      pos = pos + np.array([c * mount[0] - s * mount[1],
                            s * mount[0] + c * mount[1], mount[2]])
      yaw = heading + yaw_c
      fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
      up = np.array([0.0, 0.0, 1.0])
      right = np.cross(fwd, up)
      poses.append(np.stack([right, up, -fwd, pos], axis=1))
  world = np.asarray(poses, np.float64)
  n = len(world)
  i_test = np.arange(n)[::spec["datahold"]]
  i_train = np.setdiff1d(np.arange(n), i_test)
  if spec["half_train"]:
    i_train = i_train[::2]
  H, W = spec["height"], spec["width"]
  K = np.array([[spec["focal"], 0, W / 2], [0, spec["focal"], H / 2],
                [0, 0, 1]], np.float32)
  return Layout(poses=recenter_poses(world).astype(np.float32),
                intrinsics=np.tile(K, (n, 1, 1)),
                cam_index=np.repeat(np.arange(cams), frames).astype(np.int32),
                i_train=i_train, hw=(H, W), world_poses=world)


def depth_map(spec: Dict, world_pose: np.ndarray, K: np.ndarray, hw,
              device) -> torch.Tensor:
  """[H, W] float32 depth along the camera axis (the unprojection the
  depth confidence makes: pixel (x, y) at depth d is the camera point
  d ((x - cx) / f, -(y - cy) / f, -1)) to the nearest of the ground plane
  z = 0 and the building fronts y = +-street_half_width_m, clipped to
  depth_range_m (a ray that meets neither, the sky, at the far end)."""
  H, W = hw
  f = float(K[0, 0] + K[1, 1]) / 2
  ys = torch.arange(H, dtype=torch.float64, device=device)[:, None]
  xs = torch.arange(W, dtype=torch.float64, device=device)[None, :]
  cam = torch.stack(torch.broadcast_tensors(
      (xs - float(K[0, 2])) / f, -(ys - float(K[1, 2])) / f,
      torch.full((1, 1), -1.0, dtype=torch.float64, device=device)), -1)
  R = torch.as_tensor(world_pose[:3, :3], device=device)
  o = world_pose[:3, 3]
  d = cam @ R.T
  inf = torch.full((H, W), float("inf"), dtype=torch.float64, device=device)
  hits = [torch.where(d[..., 2] < 0, -o[2] / d[..., 2], inf)]
  for wall in (spec["street_half_width_m"], -spec["street_half_width_m"]):
    s = (wall - o[1]) / d[..., 1]
    hits.append(torch.where(s > 0, s, inf))
  near_m, far_m = spec["depth_range_m"]
  return torch.stack(hits).amin(0).clamp(near_m, far_m).float()


def device_scene(spec: Dict, lay: Layout, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
  """Every view as `scene_to_device` holds a loaded nuScenes scene: images
  uint8 [N, H, W, 3], poses, intrinsics, cam_index and depths [N, H, W]
  float32 (metres, no pixel without depth)."""
  gen = generator(device, seed, "nuscenes_scene")
  n = len(lay.poses)
  H, W = lay.hw
  low = tuple(spec["detail_hw"])
  images = torch.empty(n, H, W, 3, dtype=torch.uint8, device=device)
  depths = torch.empty(n, H, W, dtype=torch.float32, device=device)
  for i in range(n):       # one view at a time: [3, H, W] float32 each
    img = _smooth(gen, (1, 3), low, (H, W), device)[0]
    images[i] = (img.permute(1, 2, 0) * 255).to(torch.uint8)
    depths[i] = depth_map(spec, lay.world_poses[i], lay.intrinsics[i],
                          (H, W), device)
  return {
      "images": images,
      "poses": torch.as_tensor(lay.poses, device=device),
      "intrinsics": torch.as_tensor(lay.intrinsics, device=device),
      "cam_index": torch.as_tensor(lay.cam_index, device=device),
      "depths": depths,
  }


def near_far(depths: torch.Tensor):
  """(near, far) as the loader sets them from the depth maps with
  bds_factor 0: 0.9 x the least depth over the views (at least 2 m), 1.1
  x the greatest under 200 m."""
  valid = depths > 0.5
  near = max(float(depths[valid].min()), 2.0) * 0.9
  far = float(depths[depths < 200.0].max()) * 1.1
  return near, far
