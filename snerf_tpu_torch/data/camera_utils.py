"""Camera and pose utilities: PCA normalization and render paths (a copy
of the numpy functions of snerf_tpu/data/camera_utils.py that the loader
and the render entry point need; that module's package imports jax).

Reference: s-nerfpp/zipnerf/internal/camera_utils.py:162-203
(transform_poses_pca with 1/10 scale cap), :24-133 (pad/unpad, focus
point, ellipse path), s-nerf/dataloader/load_nuscenes.py:10-81 +
utils/generate_renderpath.py:34-51 (spiral render path),
zipnerf/internal/datasets.py:61-102 (pose interpolation and noise for
the random render poses of data/waymo.py).
"""

from __future__ import annotations

import numpy as np


def pad_poses(p):
  """[..., 3, 4] -> [..., 4, 4] with a bottom [0, 0, 0, 1] row."""
  bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
  return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
  return p[..., :3, :4]


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
  poses_recentered = unpad_poses(transform @ pad_poses(poses))
  transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

  if poses_recentered.mean(axis=0)[2, 1] < 0:
    poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
    transform = np.diag(np.array([1, -1, -1, 1])) @ transform

  scale_factor = 1.0 / (np.max(np.abs(poses_recentered[:, :3, 3])) + 1e-5)
  scale_factor = min(1 / 10, scale_factor)
  poses_recentered[:, :3, 3] *= scale_factor
  transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform
  return poses_recentered.astype(np.float32), transform, scale_factor


def focus_point_fn(poses):
  """3D point closest to all camera optical axes (camera_utils.py:34-44)."""
  directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
  m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
  mt_m = np.transpose(m, [0, 2, 1]) @ m
  focus_pt = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]
  return focus_pt


def _normalize(x):
  return x / (np.linalg.norm(x) + 1e-10)


def viewmatrix(lookdir, up, position):
  """c2w with columns [right, up, back] looking along -lookdir... the
  convention here matches the loaders: z column = back."""
  vec2 = _normalize(lookdir)
  vec0 = _normalize(np.cross(up, vec2))
  vec1 = _normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, position], axis=1).astype(np.float32)


def generate_ellipse_path(poses, n_frames=120, z_variation=0.0,
                          z_phase=0.0):
  """Inward-facing elliptical render path (camera_utils.py:63-133)."""
  center = focus_point_fn(poses)
  offset = np.array([center[0], center[1], 0])
  sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
  low = -sc + offset
  high = sc + offset
  z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
  z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

  def get_positions(theta):
    return np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2] *
                       (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)

  theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
  positions = get_positions(theta)
  avg_up = _normalize(poses[:, :3, 1].mean(0))
  return np.stack(
      [viewmatrix(p - center, avg_up, p) for p in positions[:-1]])


def generate_spiral_path(poses, bds, n_frames=120, n_rots=2, zrate=0.5):
  """LLFF-style spiral around the average pose (load_nuscenes.py:43-81)."""
  c2w = average_pose(poses)
  up = _normalize(poses[:, :3, 1].sum(0))
  close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
  dt = 0.75
  focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)
  rads = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, 0) * 1.2
  render_poses = []
  for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
    c = (c2w[:3, :3] @ (np.array([np.cos(theta), -np.sin(theta),
                                  -np.sin(theta * zrate)]) * rads)
         + c2w[:3, 3])
    z = _normalize(c - (c2w[:3, :3] @ np.array([0, 0, -focal])
                        + c2w[:3, 3]))
    render_poses.append(viewmatrix(z, up, c))
  return np.stack(render_poses)


def average_pose(poses):
  center = poses[:, :3, 3].mean(0)
  vec2 = _normalize(poses[:, :3, 2].sum(0))
  up = poses[:, :3, 1].sum(0)
  return viewmatrix(vec2, up, center)


# -------------------- pose interpolation (datasets.py:61-102) -------------


def _mat_to_quat(m):
  """Rotation matrix -> unit quaternion (w, x, y, z)."""
  t = np.trace(m)
  if t > 0:
    s = np.sqrt(t + 1.0) * 2
    w = 0.25 * s
    x = (m[2, 1] - m[1, 2]) / s
    y = (m[0, 2] - m[2, 0]) / s
    z = (m[1, 0] - m[0, 1]) / s
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


def slerp(R0, R1, ratio):
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


def interpolate_two_pose(pose_0, pose_1, ratio=0.5, fix_trans=False):
  """Slerp rotations (in w2c space, as the reference does) + lerp
  translation (datasets.py:61-87)."""
  p0 = np.linalg.inv(_pad44(pose_0))
  p1 = np.linalg.inv(_pad44(pose_1))
  rot = slerp(p0[:3, :3], p1[:3, :3], ratio)
  pose = np.eye(4, dtype=np.float32)
  pose[:3, :3] = rot
  pose[:3, 3] = p0[:3, 3] if fix_trans else \
      ((1.0 - ratio) * p0 + ratio * p1)[:3, 3]
  return np.linalg.inv(pose).astype(np.float32)


def _pad44(p):
  if p.shape == (4, 4):
    return p
  return np.concatenate([p, np.array([[0, 0, 0, 1.0]])], axis=0)


def add_noise_to_pose(pose, dx, dy, dz, dx_theta, dy_theta,
                      rng: np.random.RandomState):
  """Bounded uniform translation + small euler rotations
  (datasets.py:88-102)."""
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
