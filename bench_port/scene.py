"""The benchmark's inputs, made from the seed: a Waymo-layout street scene
on the device (images, sparse depth, 19-class labels and the object and
padding mask, as `load_waymo_scene` returns a preprocessed sequence), the
render poses of the S-NeRF++ simulation pipeline, and the seeds of every
draw.

The scene's sizes come from the configuration file's "scene" block. The
poses are built in metres for a five-camera rig (front, front-left,
front-right, side-left, side-right) on a car driving a gentle curve, then
normalised as the Waymo loader normalises them (a copy of
`transform_poses_pca`, its 1/10 scale cap included), so near, far and the
depth units are the loader's. The pixel content is smooth random fields:
the cells measure throughput and agreement with the reference, neither of
which needs a real street.

`render_poses` is a copy of the WAYMO_RENDER generator
(s-nerfpp/zipnerf/internal/datasets.py:1024-1096, random_v2), numpy, with
its pose interpolation and noise.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F


def sub_seed(seed: int, purpose: str, bits: int = 63) -> int:
  """A seed of `bits` bits for one purpose, from the run's seed (any whole
  number)."""
  digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
  return int.from_bytes(digest[:8], "little") >> (64 - bits)


def generator(device, seed: int, purpose: str) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


# ---- pose normalisation (copy of the Waymo loader's transform_poses_pca)


def _pad_poses(p):
  bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
  return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def transform_poses_pca(poses):
  """Align principal components to XYZ, recenter, scale into [-1,1]^3
  (capped at 1/10). Returns (poses, transform [4,4], scale_factor)."""
  t = poses[:, :3, 3]
  t_mean = t.mean(axis=0)
  t = t - t_mean
  eigval, eigvec = np.linalg.eig(t.T @ t)
  inds = np.argsort(eigval)[::-1]
  eigvec = eigvec[:, inds].real
  rot = eigvec.T
  if np.linalg.det(rot) < 0:
    rot = np.diag(np.array([1, 1, -1])) @ rot
  transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
  poses_recentered = (transform @ _pad_poses(poses))[..., :3, :4]
  transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
  if poses_recentered.mean(axis=0)[2, 1] < 0:
    poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
    transform = np.diag(np.array([1, -1, -1, 1])) @ transform
  scale_factor = 1.0 / (np.max(np.abs(poses_recentered[:, :3, 3])) + 1e-5)
  scale_factor = min(1 / 10, scale_factor)
  poses_recentered[:, :3, 3] *= scale_factor
  return poses_recentered.astype(np.float32), scale_factor


# ---- the layout


@dataclasses.dataclass
class Layout:
  """The train views' cameras: poses [N, 3, 4] (normalised, [r, u, -t]),
  intrinsics [N, 3, 3], the index of each kept view in the whole
  sequence (camera-major: camera * frames + frame), near, far, the scale
  factor and the image size."""
  poses: np.ndarray
  intrinsics: np.ndarray
  view_index: np.ndarray
  n_sequence: int
  near: float
  far: float
  scale: float
  hw: tuple


def layout(spec: Dict, seed: int) -> Layout:
  """The camera rig along a seeded gentle curve; the views the loader
  keeps for training (every `llffhold`-th view of the sequence held out)."""
  rng = np.random.RandomState(sub_seed(seed, "layout", 32))
  cams, frames = spec["cameras"], spec["frames"]
  step = spec["metres_per_frame"]
  curve = rng.uniform(-0.02, 0.02)           # heading change a frame, rad
  poses = []
  for cam in range(cams):
    yaw_c = np.deg2rad(spec["camera_yaw_deg"][cam])
    mount = np.asarray(spec["camera_mount_m"][cam], np.float64)
    for f in range(frames):
      heading = curve * f
      pos = np.array([sum(step * np.cos(curve * k) for k in range(f)),
                      sum(step * np.sin(curve * k) for k in range(f)), 0.0])
      yaw = heading + yaw_c
      c, s = np.cos(heading), np.sin(heading)
      pos = pos + np.array([c * mount[0] - s * mount[1],
                            s * mount[0] + c * mount[1], mount[2]])
      fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
      up = np.array([0.0, 0.0, 1.0])
      right = np.cross(fwd, up)
      poses.append(np.stack([right, up, -fwd, pos], axis=1))
  poses = np.asarray(poses, np.float64)
  poses, sf = transform_poses_pca(poses)
  n = len(poses)
  keep = np.arange(n)[np.arange(n) % spec["llffhold"] != 0]
  H, W = spec["height"], spec["width"]
  K = np.array([[spec["focal"], 0, W / 2], [0, spec["focal"], H / 2],
                [0, 0, 1]], np.float32)
  return Layout(poses=poses[keep], intrinsics=np.tile(K, (len(keep), 1, 1)),
                view_index=keep, n_sequence=n, near=2 * sf,
                far=10000 * sf, scale=sf, hw=(H, W))


def _smooth(gen, shape, low_hw, out_hw, device):
  """Uniform [0, 1) noise at low_hw, bilinearly upsampled to out_hw:
  [N, C, H, W] float32."""
  noise = torch.rand(*shape, *low_hw, generator=gen, device=device)
  return F.interpolate(noise, size=out_hw, mode="bilinear",
                       align_corners=False)


def device_scene(spec: Dict, lay: Layout, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
  """The train views as the port's sampler reads them: images uint8
  [N, H, W, 3], poses, intrinsics, cam_index, depths (metres x scale,
  0 where no lidar return, `depth_density` of the pixels), semantics
  int32 in [0, classes), skymask bool (the side cameras' padding below
  `side_valid_rows` and one object box a view)."""
  gen = generator(device, seed, "scene")
  n = len(lay.poses)
  H, W = lay.hw
  low = tuple(spec["detail_hw"])
  images = torch.empty(n, H, W, 3, dtype=torch.uint8, device=device)
  for i in range(n):       # one view at a time: [3, H, W] float32 each
    img = _smooth(gen, (1, 3), low, (H, W), device)[0]
    images[i] = (img.permute(1, 2, 0) * 255).to(torch.uint8)
  metres = 4.0 + 76.0 * _smooth(gen, (n, 1), low, (H, W), device)[:, 0]
  lidar = torch.rand(n, H, W, generator=gen, device=device) < \
      spec["depth_density"]
  depths = torch.where(lidar, metres * lay.scale, 0.0)
  del metres, lidar
  cell = spec["label_cell_px"]
  labels = torch.randint(0, spec["classes"], (n, -(-H // cell), -(-W // cell)),
                         generator=gen, device=device, dtype=torch.int32)
  semantics = labels.repeat_interleave(cell, 1).repeat_interleave(
      cell, 2)[:, :H, :W].contiguous()
  cam = torch.as_tensor(lay.view_index * spec["cameras"] // lay.n_sequence,
                        device=device, dtype=torch.int32)
  rows = torch.arange(H, device=device)
  skymask = ((cam[:, None, None] >= 3)
             & (rows[None, :, None] >= spec["side_valid_rows"])
             ).expand(n, H, W).clone()
  boxes = torch.rand(n, 2, generator=gen, device=device)
  y0 = (boxes[:, 0] * (H // 2)).long()
  x0 = (boxes[:, 1] * (W - W // 8)).long()
  cols = torch.arange(W, device=device)
  box = ((rows[None, :, None] >= y0[:, None, None])
         & (rows[None, :, None] < y0[:, None, None] + H // 8)
         & (cols[None, None, :] >= x0[:, None, None])
         & (cols[None, None, :] < x0[:, None, None] + W // 8))
  skymask |= box
  return {
      "images": images,
      "poses": torch.as_tensor(lay.poses, device=device),
      "intrinsics": torch.as_tensor(lay.intrinsics, device=device),
      "cam_index": cam,
      "depths": depths,
      "skymask": skymask,
      "semantics": semantics,
  }


# ---- WAYMO_RENDER (copy): random novel poses between neighbouring frames


def _pad44(p):
  if p.shape == (4, 4):
    return p
  return np.concatenate([p, np.array([[0, 0, 0, 1.0]])], axis=0)


def _mat_to_quat(m):
  t = np.trace(m)
  if t > 0:
    s = np.sqrt(t + 1.0) * 2
    w, x = 0.25 * s, (m[2, 1] - m[1, 2]) / s
    y, z = (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s
  else:
    i = np.argmax([m[0, 0], m[1, 1], m[2, 2]])
    if i == 0:
      s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
      w, x = (m[2, 1] - m[1, 2]) / s, 0.25 * s
      y, z = (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
    elif i == 1:
      s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
      w, x = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s
      y, z = 0.25 * s, (m[1, 2] + m[2, 1]) / s
    else:
      s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
      w, x = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s
      y, z = (m[1, 2] + m[2, 1]) / s, 0.25 * s
  q = np.array([w, x, y, z])
  return q / np.linalg.norm(q)


def _quat_to_mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
  ])


def _slerp(R0, R1, ratio):
  q0, q1 = _mat_to_quat(R0), _mat_to_quat(R1)
  dot = np.dot(q0, q1)
  if dot < 0:
    q1, dot = -q1, -dot
  dot = np.clip(dot, -1, 1)
  if dot > 0.9995:
    q = q0 + ratio * (q1 - q0)
  else:
    theta = np.arccos(dot)
    q = (np.sin((1 - ratio) * theta) * q0 +
         np.sin(ratio * theta) * q1) / np.sin(theta)
  return _quat_to_mat(q / np.linalg.norm(q))


def _interpolate_two_pose(pose_0, pose_1, ratio=0.5, fix_trans=False):
  p0 = np.linalg.inv(_pad44(pose_0))
  p1 = np.linalg.inv(_pad44(pose_1))
  pose = np.eye(4, dtype=np.float32)
  pose[:3, :3] = _slerp(p0[:3, :3], p1[:3, :3], ratio)
  pose[:3, 3] = p0[:3, 3] if fix_trans else \
      ((1.0 - ratio) * p0 + ratio * p1)[:3, 3]
  return np.linalg.inv(pose).astype(np.float32)


def _add_noise_to_pose(pose, dx, dy, dz, dx_theta, dy_theta, rng):
  pose = _pad44(pose).copy()
  pose[0, 3] += rng.uniform(-dx, dx)
  pose[1, 3] += rng.uniform(-dy, dy)
  pose[2, 3] += rng.uniform(-dz, dz)
  xt = np.deg2rad(rng.uniform(-dx_theta, dx_theta))
  yt = np.deg2rad(rng.uniform(-dy_theta, dy_theta))
  cx, sx = np.cos(xt), np.sin(xt)
  cy, sy = np.cos(yt), np.sin(yt)
  x_rot = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
  y_rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
  pose[:3, :3] = pose[:3, :3] @ y_rot @ x_rot
  return pose.astype(np.float32)


def render_poses(lay: Layout, n_render: int, seed: int, num_cams: int = 5):
  """(poses [n, 3, 4], intrinsics [n, 3, 3]): random novel poses around
  the training trajectory, as cli.render --render_mode random draws them
  from the train views' poses (Waymo's random_v2)."""
  rng = np.random.RandomState(sub_seed(seed, "render_poses", 32))
  poses = lay.poses
  total = len(poses)
  frame_num = max(total // num_cams, 1)
  frame_offset = min(5, max(frame_num // 4, 0))
  dx, dy, dz = np.array([0.5, 0.5, 0.25]) * lay.scale
  dxt, dyt = 2.5, 5.0
  out = []
  for _ in range(n_render):
    part = rng.randint(0, num_cams)
    frame_id = rng.randint(frame_offset, max(frame_num - frame_offset,
                                             frame_offset + 1))
    idx = int(np.clip(part * frame_num + frame_id, 0, total - 1))
    if idx > total * 3 // num_cams - 1:  # side cameras
      ano = int(np.clip(idx + rng.choice([0, 1, -1]), 0, total - 1))
      pose = _interpolate_two_pose(poses[idx].copy(), poses[ano].copy(),
                                   ratio=rng.random(), fix_trans=True)
    else:
      part_ano = rng.randint(1, 3) if part == 0 else 0
      cands = [idx + 1, idx, idx - 1,
               part_ano * frame_num + frame_id,
               part_ano * frame_num + frame_id - 1,
               part_ano * frame_num + frame_id + 1]
      ano = int(np.clip(cands[rng.randint(0, 6)], 0, total - 1))
      p0 = _add_noise_to_pose(poses[idx].copy(), dx, dy, dz, dxt, dyt, rng)
      p1 = _add_noise_to_pose(poses[ano].copy(), dx, dy, dz, dxt, dyt, rng)
      pose = _interpolate_two_pose(p0, p1, ratio=rng.random())
    out.append(pose[:3, :4])
  return (np.stack(out).astype(np.float32),
          np.tile(lay.intrinsics[:1], (n_render, 1, 1)))
