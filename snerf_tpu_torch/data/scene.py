"""Scene container and the nuScenes loader (a copy of
snerf_tpu/data/scene.py).

The data modules of the JAX package are numpy, but importing any of them
runs snerf_tpu/data/__init__.py, which imports jax; the port copies what
it needs instead. Images and depth maps are read by the port's own PNG
reader (`data/png.py`) where the JAX loader uses imageio and cv2: the
port reads PNG scenes only, and a JPEG raises.

Reference file contracts (as in the JAX module): reference
s-nerf/dataloader/load_nuscenes.py:89-200 (poses_bounds.npy n x 19
layout: 15 pose+hwf cols, 2 bounds, 2 raw H/W; depth png / 256 with sky
threshold > 200m and clip [2, 100]; axis flip to [r, u, -t]; recenter),
s-nerf/dataloader/dataloader.py:61-120 (train/test split via datahold,
cam_index assignment, semantic/flow side-channels).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from snerf_tpu_torch.data import camera_utils
from snerf_tpu_torch.data.png import read_pngs, resize_bilinear


@dataclasses.dataclass
class Scene:
  """Host-side scene bundle; arrays are numpy, ready to ship to device."""
  images: np.ndarray                 # [N, H, W, 3] uint8
  poses: np.ndarray                  # [N, 3, 4] float32 c2w ([r, u, -t] conv.)
  intrinsics: np.ndarray             # [N, 3, 3] float32
  near: float
  far: float
  depths: Optional[np.ndarray] = None      # [N, H, W] float32 (0 = no depth)
  skymask: Optional[np.ndarray] = None     # [N, H, W] bool
  semantics: Optional[np.ndarray] = None   # [N, H, W] int32 labels
  cam_index: Optional[np.ndarray] = None   # [N] int32 camera id per image
  flow: Optional[np.ndarray] = None        # [2, N, H, W, 2] next/prev flow
  i_train: Optional[np.ndarray] = None
  i_test: Optional[np.ndarray] = None
  scale: float = 1.0                 # world-units scale factor applied
  render_poses: Optional[np.ndarray] = None
  # foreground (moving-vehicle) branch: per-image 2D bbox [x0, y0, x1, y1]
  # restricting ray sampling (reference --block_bg, dataloader.py:17-19)
  bboxes: Optional[np.ndarray] = None

  @property
  def hw(self):
    return self.images.shape[1], self.images.shape[2]

  @property
  def num_images(self):
    return self.images.shape[0]


def _recenter_poses(poses):
  """Recenter poses around their average (reference load_nuscenes.py:10-40)."""
  poses = poses.copy()
  bottom = np.array([0, 0, 0, 1.0], dtype=np.float32).reshape(1, 4)
  c2w = _poses_avg(poses)
  c2w = np.concatenate([c2w[:3, :4], bottom], -2)
  poses_h = np.concatenate(
      [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], -2)
  poses_h = np.linalg.inv(c2w) @ poses_h
  poses[:, :3, :4] = poses_h[:, :3, :4]
  return poses, c2w


def _poses_avg(poses):
  center = poses[:, :3, 3].mean(0)
  vec2 = _normalize(poses[:, :3, 2].sum(0))
  up = poses[:, :3, 1].sum(0)
  return _viewmatrix(vec2, up, center)


def _normalize(x):
  return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
  vec2 = _normalize(z)
  vec0 = _normalize(np.cross(up, vec2))
  vec1 = _normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, pos], 1).astype(np.float32)


def parse_poses_bounds(poses_arr, colmap: bool = False):
  """Split a poses_bounds.npy array into (poses[N,3,5], bounds[N,2], hw[N,2]).

  nuScenes layout is n x 19 (reference load_nuscenes.py:110-117): first 15 are
  the 3x5 [R|t|hwf-ish column], next 2 are bounds, last 2 are raw H, W.
  COLMAP/LLFF layout is n x 17 (3x5 + 2 bounds; hw inside column 4).
  """
  poses_arr = np.asarray(poses_arr, dtype=np.float32)
  if colmap:
    poses = poses_arr[:, :-2].reshape([-1, 3, 5])
    bds = poses_arr[:, -2:]
    raw_hw = poses[:, :2, 4]
  else:
    poses = poses_arr[:, :-4].reshape([-1, 3, 5])
    bds = poses_arr[:, -4:-2]
    raw_hw = poses_arr[:, -2:]
  return poses, bds, raw_hw


def _sorted_files(dirname, exts):
  """The files of `dirname` in the order of the integer before their
  first dot, those with an extension in `exts` kept."""
  files = sorted(os.listdir(dirname), key=lambda x: int(x.split(".")[0]))
  return [os.path.join(dirname, f) for f in files
          if f.lower().endswith(exts)]


def _load_images(imgdir):
  imgs = [img[..., :3] for img in
          read_pngs(_sorted_files(imgdir, (".jpg", ".png", ".jpeg")))]
  return np.stack(imgs, 0)


def load_depth_maps(path, H, W, bd_factor=0.75, sky_mask=False):
  """Depth pngs / 256 resized to (H, W); sky > 200m; clip [2, 100].

  Parity: reference load_nuscenes.py:176-200. The 16-bit samples / 256.0
  are float64, resized in float64 and stored float32, the dtype chain of
  the JAX loader's cv2 calls. Returns (depth, bds, bds_raw, skymask).
  """
  files = _sorted_files(os.path.join(path, "depths"), (".jpg", ".png"))
  imgs = [resize_bilinear(d / 256.0, H, W) for d in read_pngs(files)]
  depth = np.stack(imgs, 0).astype(np.float32)

  min_thresh, max_thresh = 0.5, 200.0
  skymask = (depth > max_thresh) if sky_mask else None
  valid = depth > min_thresh
  if valid.any():
    depth[valid] = np.clip(depth[valid], max(depth[valid].min(), 2.0), 100.0)
  bds_raw = np.array(
      [[max(d[d > min_thresh].min(), 2.0) if (d > min_thresh).any() else 2.0,
        d[d < max_thresh].max() if (d < max_thresh).any() else 100.0]
       for d in depth], dtype=np.float32)
  sc = 1.0 if bd_factor == 0.0 else 1.0 / (bds_raw.min() * bd_factor)
  depth = depth * sc
  bds = (float(depth[valid].min()) if valid.any() else 2.0 * sc,
         float(depth[depth < max_thresh].max()))
  return depth, bds, bds_raw, skymask


def load_flow(datadir: str) -> Optional[np.ndarray]:
  """Load the optical-flow side channel: flow/ holds alternating
  <frame>_next.npy / <frame>_prev.npy files in sorted order (reference
  load_nuscenes.py:153-167). Returns [2, N, H, W, 2] (next, prev) or None
  when the directory is absent."""
  path = os.path.join(datadir, "flow")
  if not os.path.isdir(path):
    return None
  names = sorted(os.listdir(path))
  if not names:
    return None
  next_flows = [np.load(os.path.join(path, n)) for n in names[::2]]
  prev_flows = [np.load(os.path.join(path, n)) for n in names[1::2]]
  if not next_flows or len(next_flows) != len(prev_flows):
    return None
  return np.stack([np.stack(next_flows),
                   np.stack(prev_flows)]).astype(np.float32)


def load_nuscenes_scene(datadir: str,
                        bd_factor: float = 0.75,
                        cam_num: int = 0,
                        datahold: int = 10,
                        sky_mask: bool = False,
                        load_depth: bool = True,
                        load_semantic: bool = False,
                        no_align: bool = False,
                        colmap: bool = False) -> Scene:
  """Load an S-NeRF-preprocessed nuScenes scene directory.

  Mirrors reference load_nuscenes_data (load_nuscenes.py:89-151) +
  load_nuscenes dispatch (dataloader.py:61-120).
  """
  images = _load_images(os.path.join(datadir, "images"))
  N, H, W = images.shape[:3]

  depths = skymask = None
  if load_depth:
    depths, _, bds_raw, skymask = load_depth_maps(
        datadir, H, W, bd_factor=bd_factor, sky_mask=sky_mask)
  else:
    bds_raw = np.array([[2.0, 100.0]] * N, dtype=np.float32)

  poses_arr = np.load(os.path.join(datadir, "poses_bounds.npy"))
  poses, _, raw_hw = parse_poses_bounds(poses_arr, colmap=colmap)
  sc = 1.0 if bd_factor == 0.0 else 1.0 / (bds_raw.min() * bd_factor)

  raw_cam_k = poses[:, :, 4].astype(np.float32)  # [N, 3]
  factor = raw_hw[0, 0] / H
  if colmap:
    cx = raw_cam_k[:, 1] / factor * 0.5
    cy = raw_cam_k[:, 0] / factor * 0.5
    focal = raw_cam_k[:, 2] / factor
  else:
    cx = raw_cam_k[:, 0] / factor
    cy = raw_cam_k[:, 1] / factor
    focal = raw_cam_k[:, 2] / factor
  K = np.zeros((N, 3, 3), dtype=np.float32)
  K[:, 0, 0] = focal
  K[:, 1, 1] = focal
  K[:, 0, 2] = cx
  K[:, 1, 2] = cy
  K[:, 2, 2] = 1.0

  # [down, right, back] -> [right, up, back] (reference load_nuscenes.py:119)
  poses = np.concatenate(
      [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4],
       poses[:, :, 3:4]], axis=2)[:, :, :4]
  poses[:, :3, 3] *= sc
  poses, _ = _recenter_poses(poses)
  if not no_align:
    poses[:, :3, 3] -= poses[0:1, :3, 3]

  bds = bds_raw * sc
  near = float(bds.min()) * 0.9
  far = float(bds.max()) * 1.1

  semantics = None
  if load_semantic:
    # semantic_labels.npy stores a SUBSET of labeled images with their
    # image index in channel 0 (reference load_nuscenes.py:169-174:
    # labels = sem[..., 1:], index = sem[:, 0, 0, 0, 0]). Unlabeled
    # images get -1 (losses mask them out).
    sem_path = os.path.join(datadir, "semantic_labels.npy")
    sem = np.load(sem_path)
    sem_index = sem.reshape(sem.shape[0], -1)[:, 0].astype(np.int32)
    sem_labels = sem[..., 1:] if sem.ndim >= 4 else sem[..., None, 1:]
    sem_labels = np.squeeze(sem_labels, axis=-1) \
        if sem_labels.shape[-1] == 1 else sem_labels[..., 0]
    semantics = np.full((N, H, W), -1, np.int32)
    for pos, img_i in enumerate(sem_index):
      if 0 <= img_i < N:
        semantics[img_i] = sem_labels[pos]

  flow = load_flow(datadir)

  if cam_num:
    cam_index = np.repeat(np.arange(cam_num), N // cam_num).astype(np.int32)
  else:
    cam_index = np.zeros(N, np.int32)

  i_test = np.arange(N)[::datahold]
  i_train = np.array([i for i in range(N) if i not in set(i_test.tolist())])

  # spiral render path around the average pose
  # (reference load_nuscenes.py:10-81 generate_render_path); the JAX
  # loader leaves it None when the path cannot be formed
  try:
    render_poses = camera_utils.generate_spiral_path(
        poses[:, :3, :4], bds, n_frames=60)
  except Exception:  # noqa: BLE001 - the reference's own fallback to None
    render_poses = None

  return Scene(images=images.astype(np.uint8), poses=poses[:, :3, :4],
               intrinsics=K, near=near, far=far, depths=depths,
               skymask=skymask, semantics=semantics, cam_index=cam_index,
               flow=flow, i_train=i_train, i_test=i_test, scale=sc,
               render_poses=render_poses)
