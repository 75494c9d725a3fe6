"""The port's Waymo loader and render-pose generators
(snerf_tpu_torch/data/waymo.py, the pose helpers of data/camera_utils.py
and data/png.py's cv2 resizes) against snerf_tpu.data.waymo, on the CPU.

A tiny Waymo layout is written under tmp_path: 10 views (5 cameras x 2
frames) of PNG images (written by cv2, so with its row filters), uint16
depth, 8-bit labels, one mask, poses_bounds.npy. Both loaders read it at
factor 1 and 2, at an odd size (cv2's fixed-point bilinear path) and an
even one (its 2x2 area path), and every field must be bit-equal. The
random and nuScenes render-pose sets and render2raw must be equal for
two seeds, and the uint8 and nearest resizes equal to cv2's on a grid of
sizes, channel counts and factors.
"""

import os

import cv2
import numpy as np
import pytest

from snerf_tpu.data import camera_utils as jcu
from snerf_tpu.data import waymo as jw
from snerf_tpu_torch.data import camera_utils as tcu
from snerf_tpu_torch.data import waymo as tw
from snerf_tpu_torch.data.png import resize_bilinear_u8, resize_nearest

N_VIEWS = 10


def _pose(rng, t):
  q, _ = np.linalg.qr(rng.randn(3, 3))
  if np.linalg.det(q) < 0:
    q[:, 0] *= -1
  return np.concatenate([q, t[:, None]], axis=1)


def write_layout(root, H, W, seed=0):
  """A Waymo-layout scene of N_VIEWS views under `root`."""
  rng = np.random.RandomState(seed)
  for sub in ("images", "depth", "labels", "mask"):
    os.makedirs(os.path.join(root, sub), exist_ok=True)
  rows = []
  for i in range(N_VIEWS):
    name = f"{i:03d}.png"
    # smooth content plus noise: every PNG row filter gets used
    yy, xx = np.mgrid[:H, :W]
    img = (127 + 100 * np.sin(xx[..., None] * 0.3 + yy[..., None] * 0.2
                              + np.arange(3) + i)
           + rng.randint(-20, 20, (H, W, 3))).clip(0, 255).astype(np.uint8)
    cv2.imwrite(os.path.join(root, "images", name), img[..., ::-1])
    depth = rng.randint(0, 60000, (H, W)).astype(np.uint16)
    depth[rng.rand(H, W) < 0.3] = 0
    cv2.imwrite(os.path.join(root, "depth", name), depth)
    cv2.imwrite(os.path.join(root, "labels", name),
                rng.randint(0, 19, (H, W)).astype(np.uint8))
    if i == 4:
      mask = np.zeros((H, W), np.uint8)
      mask[2:7, 3:9] = 255
      cv2.imwrite(os.path.join(root, "mask", name), mask)
    cam, frame = divmod(i, N_VIEWS // 5)
    c2w = _pose(rng, np.array([frame * 2.0, cam * 0.5, 0.1 * i]))
    hwf = np.array([[W / 2.0], [H / 2.0], [W * 0.9]])
    rows.append(np.concatenate([np.concatenate([c2w, hwf], 1).reshape(-1),
                                [1.0, 80.0, H, W]]))
  np.save(os.path.join(root, "poses_bounds.npy"),
          np.asarray(rows, np.float32))
  return root


def _assert_same_scene(got, want):
  for k in ("images", "poses", "intrinsics", "depths", "semantics",
            "skymask", "cam_index", "i_train", "i_test", "pca_transform"):
    g, w = getattr(got, k), getattr(want, k)
    if w is None:
      assert g is None, k
      continue
    assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype,
                                                       g.shape, w.shape)
    assert np.array_equal(g, w), k
  for k in ("near", "far", "scale"):
    assert getattr(got, k) == getattr(want, k), k
  assert got.render_poses is None and want.render_poses is None


@pytest.mark.parametrize("hw", [(19, 27), (18, 26)])
@pytest.mark.parametrize("factor", [1, 2])
def test_loader_bit_equal(tmp_path, hw, factor):
  root = write_layout(str(tmp_path / "scene"), *hw)
  for kw in ({}, {"llffhold": 3, "load_semantic": False}):
    want = jw.load_waymo_scene(root, factor=factor, **kw)
    got = tw.load_waymo_scene(root, factor=factor, **kw)
    _assert_same_scene(got, want)
  assert got.images.shape[1:3] == (hw[0] // factor, hw[1] // factor)
  assert got.skymask.any() and got.depths.dtype == np.float32


def test_meta_and_side_mask(tmp_path):
  root = write_layout(str(tmp_path / "scene"), 9, 11, seed=3)
  for g, w in zip(tw.load_waymo_meta(root), jw.load_waymo_meta(root)):
    assert g.dtype == w.dtype and np.array_equal(g, w)
  for idx in (0, 5, 6, 9):
    assert np.array_equal(tw._side_cam_mask(idx, 10, 900, 8),
                          jw._side_cam_mask(idx, 10, 900, 8))


def _poses(seed, n=20):
  rng = np.random.RandomState(seed)
  p = np.stack([_pose(rng, rng.randn(3) * 0.05) for _ in range(n)])
  return p.astype(np.float32)


def _assert_pose_sets_equal(got, want):
  for k in ("poses", "intrinsics", "hws", "raw_poses", "poses_sd"):
    g, w = getattr(got, k), getattr(want, k)
    if w is None:
      assert g is None, k
      continue
    assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("seed", [0, 7])
def test_render_pose_sets_equal(seed):
  poses = _poses(seed + 1)
  K = np.array([[500.0, 0, 960], [0, 500, 640], [0, 0, 1]], np.float32)
  K2 = K * np.array([[0.9], [0.9], [1.0]], np.float32)
  args = (poses, K, K2, np.array([1280, 1920]), np.array([886, 1920]), 0.05)
  for kw in ({}, {"only_side_cam": True}, {"only_front_cam": True}):
    _assert_pose_sets_equal(
        tw.generate_random_render_poses(*args, n_render=7, seed=seed, **kw),
        jw.generate_random_render_poses(*args, n_render=7, seed=seed, **kw))
  Ks = np.tile(K[None], (18, 1, 1))
  nus = (poses[:18], Ks, np.array([900, 1600]), 0.05)
  got = tw.generate_nuscenes_render_poses(*nus, n_render=3, seed=seed)
  want = jw.generate_nuscenes_render_poses(*nus, n_render=3, seed=seed)
  _assert_pose_sets_equal(got, want)
  assert got.poses.shape == (18, 4, 4)
  transform = np.eye(4)
  transform[:3] = _poses(seed + 2, 1)[0]
  start = np.eye(4)
  start[:3] = _poses(seed + 3, 1)[0]
  g = tw.render2raw(got.poses, transform, 0.05, start)
  w = jw.render2raw(want.poses, transform, 0.05, start)
  assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 7])
def test_pose_helpers_equal(seed):
  rng = np.random.RandomState(seed)
  p0, p1 = _poses(seed, 2)
  for ratio in (0.0, 0.3, 1.0):
    for fix in (False, True):
      assert np.array_equal(
          tcu.interpolate_two_pose(p0, p1, ratio=ratio, fix_trans=fix),
          jcu.interpolate_two_pose(p0, p1, ratio=ratio, fix_trans=fix))
  assert np.array_equal(tcu.slerp(p0[:, :3], p1[:, :3], 0.4),
                        jcu.slerp(p0[:, :3], p1[:, :3], 0.4))
  state = rng.get_state()
  got = tcu.add_noise_to_pose(p0, 0.1, 0.1, 0.05, 2.5, 5.0, rng)
  rng.set_state(state)
  want = jcu.add_noise_to_pose(p0, 0.1, 0.1, 0.05, 2.5, 5.0, rng)
  assert np.array_equal(got, want)


def test_resizes_match_cv2():
  rng = np.random.RandomState(4)
  for h in (3, 9, 17, 30):
    for w in (5, 11, 22, 65):
      for c in (1, 3, 4):
        for f in (2, 3, 4):
          if h // f < 1 or w // f < 1:
            continue
          img = rng.randint(0, 256, (h, w, c)[:3 if c > 1 else 2]).astype(
              np.uint8)
          size = (h // f, w // f)
          assert np.array_equal(resize_bilinear_u8(img, *size),
                                cv2.resize(img, size[::-1])), (h, w, c, f)
          for arr in (img, img.astype(np.float64) / 7, img.astype(np.int32)):
            assert np.array_equal(
                resize_nearest(arr, *size),
                cv2.resize(arr, size[::-1],
                           interpolation=cv2.INTER_NEAREST)), (h, w, c, f)
