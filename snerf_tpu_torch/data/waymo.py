"""Waymo (S-NeRF++ background) scene loader and the random render-pose
generators (counterpart of snerf_tpu/data/waymo.py, numpy, copied).

The JAX loader reads with imageio and resizes with cv2; the port reads
with its own PNG reader (`data/png.py`) and repeats cv2's resizes bit
for bit: INTER_LINEAR on uint8 images in cv2's fixed point
(`resize_bilinear_u8`), INTER_NEAREST on depth, labels and masks
(`resize_nearest`). PNG scenes only: a JPEG raises, as in the nuScenes
loader.

Layout on disk (produced by the preprocessing toolchain): images/,
depth/ (uint16 PNGs, metres x 256), labels/, mask/, poses_bounds.npy.

Reference: s-nerfpp/zipnerf/internal/datasets.py:785-957 (WAYMO:
poses_bounds n x 19 meta, PCA normalization, near = 2 sf, far = 10000
sf, depth png / 256 * sf, side-camera masks valid to row 886, llffhold
split), :1024-1122 (WAYMO_RENDER: random novel poses between neighbour
frames with bounded noise; render2raw), :1470-1553 (NUSCENES_RENDER).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from snerf_tpu_torch.data import camera_utils
from snerf_tpu_torch.data.png import (read_pngs, resize_bilinear_u8,
                                      resize_nearest)
from snerf_tpu_torch.data.scene import Scene, parse_poses_bounds

WAYMO_NUM_CAMS = 5
WAYMO_SIDE_VALID_ROWS = 886  # side cams padded to 1280x1920; valid rows


def load_waymo_meta(datadir: str):
  """poses_bounds.npy -> (poses [N, 3, 4], K [N, 3, 3], hw, bounds): the
  n x 19 layout shared with nuScenes, poses turned to [r, u, -t]."""
  poses_arr = np.load(os.path.join(datadir, "poses_bounds.npy"))
  poses, bds, raw_hw = parse_poses_bounds(poses_arr, colmap=False)
  raw_cam_k = poses[:, :, 4].astype(np.float32)
  K = np.zeros((len(poses), 3, 3), np.float32)
  K[:, 0, 0] = raw_cam_k[:, 2]
  K[:, 1, 1] = raw_cam_k[:, 2]
  K[:, 0, 2] = raw_cam_k[:, 0]
  K[:, 1, 2] = raw_cam_k[:, 1]
  K[:, 2, 2] = 1.0
  poses = np.concatenate(
      [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]],
      axis=2).astype(np.float32)
  return poses[:, :3, :4], K, raw_hw, bds


def _side_cam_mask(idx: int, num_images: int, H: int, W: int):
  """Waymo side cameras (parts 3, 4) are padded below row 886
  (datasets.py:881-895 load_mask default)."""
  num = num_images // WAYMO_NUM_CAMS
  mask = np.zeros((H, W), np.uint8)
  if idx >= 3 * num:
    mask[WAYMO_SIDE_VALID_ROWS:] = 1
  return mask


def load_waymo_scene(datadir: str,
                     llffhold: int = 8,
                     factor: int = 1,
                     load_depth: bool = True,
                     load_semantic: bool = True,
                     split: str = "train") -> Scene:
  """Load a preprocessed Waymo scene, PCA-normalized to the unit cube.
  The scene keeps the normalization as `pca_transform` for render2raw."""
  poses, K, _, _ = load_waymo_meta(datadir)
  poses, transform, scale_factor = camera_utils.transform_poses_pca(poses)
  near = 2 * scale_factor
  far = 10000 * scale_factor

  img_dir = os.path.join(datadir, "images")
  names = sorted(os.listdir(img_dir))
  n = len(names)
  all_idx = np.arange(n)
  test_idx = all_idx[all_idx % llffhold == 0]
  train_idx = all_idx[all_idx % llffhold != 0]
  indices = train_idx if split == "train" else test_idx

  def existing(sub, enabled=True):
    """{i: path} of the split's files that exist under `sub`."""
    paths = {i: os.path.join(datadir, sub, names[i]) for i in indices}
    return {i: p for i, p in paths.items() if enabled and os.path.exists(p)}

  def read(paths):
    return dict(zip(paths, read_pngs(list(paths.values()))))

  raw_images = read({i: os.path.join(img_dir, names[i]) for i in indices})
  raw_depths = read(existing("depth", load_depth))
  raw_labels = read(existing("labels", load_semantic))
  raw_masks = read(existing("mask"))

  images, depths, semantics, masks = [], [], [], []
  for i in indices:
    img = raw_images[i]
    H, W = img.shape[:2]
    hw = (H // factor, W // factor)
    if factor > 1:
      img = resize_bilinear_u8(img, *hw)
    images.append(img[..., :3])
    if i in raw_depths:
      d = raw_depths[i] / 256.0 * scale_factor
      if factor > 1:
        d = resize_nearest(d, *hw)
      depths.append(d.astype(np.float32))
    if i in raw_labels:
      s = raw_labels[i].astype(np.int32)
      if s.ndim == 3:
        s = s[..., 0]
      if factor > 1:
        s = resize_nearest(s, *hw)
      semantics.append(s)
    if i in raw_masks:
      m = (raw_masks[i] > 0).astype(np.uint8)
    else:
      m = _side_cam_mask(int(i), n, H, W)
    if factor > 1:
      m = resize_nearest(m, *hw)
    masks.append(m.astype(bool))

  K = K[indices].copy()
  if factor > 1:
    K[:, :2] /= factor
  cam_index = (indices * WAYMO_NUM_CAMS // n).astype(np.int32)

  scene = Scene(
      images=np.stack(images).astype(np.uint8),
      poses=poses[indices].astype(np.float32),
      intrinsics=K, near=near, far=far,
      depths=np.stack(depths) if depths else None,
      semantics=np.stack(semantics) if semantics else None,
      skymask=np.stack(masks) if masks else None,  # object/pad mask stream
      cam_index=cam_index,
      i_train=np.arange(len(indices)), i_test=np.array([], np.int32),
      scale=scale_factor)
  scene.render_poses = None
  scene.pca_transform = transform  # type: ignore[attr-defined]
  return scene


@dataclasses.dataclass
class RenderPoseSet:
  """Random novel poses for simulation (WAYMO_RENDER parity)."""
  poses: np.ndarray          # [N, 4, 4] normalized-space c2w
  intrinsics: np.ndarray     # [N, 3, 3]
  hws: np.ndarray            # [N, 2]
  raw_poses: Optional[np.ndarray] = None  # [N, 4, 4] raw-frame c2w
  poses_sd: Optional[np.ndarray] = None   # metric-translation poses


def generate_random_render_poses(poses, K_forward, K_side, hw_forward,
                                 hw_side, scale_factor: float,
                                 n_render: int,
                                 only_side_cam: bool = False,
                                 only_front_cam: bool = False,
                                 seed: int = 0,
                                 num_cams: int = WAYMO_NUM_CAMS
                                 ) -> RenderPoseSet:
  """Random novel poses (datasets.py:1024-1096 random_v2): pick a
  camera and frame away from the sequence ends, interpolate towards a
  neighbour (same camera +-1 frame, or the same frame of another front
  camera), with bounded noise (0.5, 0.5, 0.25) sf metres and (2.5, 5)
  degrees for front cameras; side cameras slerp the rotation only. The
  draws come from `RandomState(seed)`, in the JAX module's order."""
  rng = np.random.RandomState(seed)
  total = len(poses)
  frame_num = max(total // num_cams, 1)
  # 5 frames away from the sequence ends when the sequence allows it
  # (datasets.py frame_offset = 5); fewer for short scenes
  frame_offset = min(5, max(frame_num // 4, 0))
  dx, dy, dz = np.array([0.5, 0.5, 0.25]) * scale_factor
  dxt, dyt = 2.5, 5.0

  out_poses, Ks, hws = [], [], []
  for _ in range(n_render):
    if only_side_cam:
      part = rng.randint(3, 5)
    elif only_front_cam:
      part = rng.randint(0, 3)
    else:
      part = rng.randint(0, num_cams)
    frame_id = rng.randint(frame_offset, max(frame_num - frame_offset,
                                             frame_offset + 1))
    idx = int(np.clip(part * frame_num + frame_id, 0, total - 1))

    if idx > total * 3 // num_cams - 1:  # side cameras
      ano = idx + rng.choice([0, 1, -1])
      ano = int(np.clip(ano, 0, total - 1))
      pose = camera_utils.interpolate_two_pose(
          poses[idx].copy(), poses[ano].copy(), ratio=rng.random(),
          fix_trans=True)
      Ks.append(K_side)
      hws.append(hw_side)
    else:
      part_ano = rng.randint(1, 3) if part == 0 else 0
      cands = [idx + 1, idx, idx - 1,
               part_ano * frame_num + frame_id,
               part_ano * frame_num + frame_id - 1,
               part_ano * frame_num + frame_id + 1]
      ano = int(np.clip(cands[rng.randint(0, 6)], 0, total - 1))
      p0 = camera_utils.add_noise_to_pose(
          poses[idx].copy(), dx, dy, dz, dxt, dyt, rng)
      p1 = camera_utils.add_noise_to_pose(
          poses[ano].copy(), dx, dy, dz, dxt, dyt, rng)
      pose = camera_utils.interpolate_two_pose(p0, p1, ratio=rng.random())
      Ks.append(K_forward)
      hws.append(hw_forward)
    out_poses.append(pose)

  render_poses = np.stack(out_poses)
  poses_sd = render_poses.copy()
  poses_sd[:, :3, 3] /= scale_factor
  return RenderPoseSet(poses=render_poses.astype(np.float32),
                       intrinsics=np.stack(Ks).astype(np.float32),
                       hws=np.stack(hws).astype(np.int32),
                       poses_sd=poses_sd.astype(np.float32))


def render2raw(render_poses, transform, scale_factor: float,
               start_raw_c2w):
  """Map normalized render poses back to raw Waymo coordinates
  (datasets.py:1103-1115)."""
  transform_uni = np.diag([1 / scale_factor] * 3 + [1]) @ transform
  raw = render_poses.copy()
  raw[:, :3, 3] /= scale_factor
  raw = np.linalg.inv(transform_uni)[None] @ raw
  raw = np.concatenate(
      [raw[:, :, 0:1], -raw[:, :, 1:2], -raw[:, :, 2:3], raw[:, :, 3:4]],
      axis=-1)
  return (start_raw_c2w[None] @ raw).astype(np.float32)


def generate_nuscenes_render_poses(poses, intrinsics, hw,
                                   scale_factor: float, n_render: int,
                                   cam_num: int = 6, front_cam: int = 0,
                                   seed: int = 0) -> RenderPoseSet:
  """The nuScenes random render rig (NUSCENES_RENDER): each sample is the
  whole cam_num-camera rig, one noisy front-camera pose plus the other
  cameras placed by their frame's transforms to the front camera.
  `poses` are camera-major blocks ([cam, frame]), as the nuScenes
  loader's cam_index lays them out; n_render counts rigs (n_render *
  cam_num poses)."""
  rng = np.random.RandomState(seed)
  total = len(poses)
  frame_num = max(total // cam_num, 1)
  frame_offset = min(5, max(frame_num // 4, 0))
  dx, dy, dz = np.array([0.5, 0.5, 0.25]) * scale_factor
  dxt, dyt = 2.5, 5.0

  def pad44(p):
    out = np.eye(4, dtype=np.float64)
    out[:3, :4] = p[:3, :4]
    return out

  out_poses, Ks, hws = [], [], []
  for _ in range(n_render):
    frame_id = rng.randint(frame_offset,
                           max(frame_num - frame_offset, frame_offset + 1))
    f_idx = front_cam * frame_num + frame_id
    front = pad44(poses[f_idx])
    noisy_front = pad44(camera_utils.add_noise_to_pose(
        poses[f_idx].copy(), dx, dy, dz, dxt, dyt, rng))
    out_poses.append(noisy_front)
    Ks.append(intrinsics[f_idx])
    hws.append(hw)
    for cam in range(cam_num):
      if cam == front_cam:
        continue
      c_idx = int(np.clip(cam * frame_num + frame_id, 0, total - 1))
      sensor2front = np.linalg.inv(front) @ pad44(poses[c_idx])
      out_poses.append(noisy_front @ sensor2front)
      Ks.append(intrinsics[c_idx])
      hws.append(hw)

  render_poses = np.stack(out_poses)
  poses_sd = render_poses.copy()
  poses_sd[:, :3, 3] /= scale_factor
  return RenderPoseSet(poses=render_poses.astype(np.float32),
                       intrinsics=np.stack(Ks).astype(np.float32),
                       hws=np.tile(np.asarray(hw, np.int32)[None],
                                   (len(out_poses), 1)),
                       poses_sd=poses_sd.astype(np.float32))
