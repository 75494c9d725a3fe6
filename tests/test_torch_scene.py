"""The port's nuScenes loader and camera utilities (snerf_tpu_torch/data/
scene.py, camera_utils.py) against snerf_tpu's, on both fixtures.

The port reads the PNGs itself (data/png.py) where JAX reads them with
imageio and cv2. Images, semantics, sky masks, camera indices and the
splits are equal; depths, poses, intrinsics, near/far, the scale and the
spiral render poses within 1e-6 (both run the same numpy on the same
numbers, so they agree exactly today). The render poses are compared
after checking that both are arrays, so the loader's try/except cannot
hide a failed path as None on both sides.
"""

import os

import numpy as np
import pytest

from snerf_tpu.data import camera_utils as jcam
from snerf_tpu.data import scene as jscene
from snerf_tpu_torch.data import camera_utils as tcam
from snerf_tpu_torch.data import scene as tscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TOL = 1e-6

CASES = [
    # bench_quality.py's load_fixture
    ("nuscenes_realfocal", dict(bd_factor=0.0, cam_num=0, datahold=8,
                                no_align=True)),
    # configs/nuScenes_depth_6cams' loader flags, with the sky mask
    ("nuscenes_realfocal", dict(bd_factor=0.0, cam_num=6, datahold=4,
                                no_align=True, sky_mask=True)),
    ("nuscenes_tiny", dict(load_semantic=True)),
    ("nuscenes_tiny", dict(bd_factor=0.75, no_align=False, load_depth=False)),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_load_nuscenes_scene_matches_jax(name, kw):
  path = os.path.join(FIXTURES, name)
  want = jscene.load_nuscenes_scene(path, **kw)
  got = tscene.load_nuscenes_scene(path, **kw)
  for k in ("images", "semantics", "skymask", "cam_index", "i_train",
            "i_test", "flow", "bboxes"):
    a, b = getattr(got, k), getattr(want, k)
    assert (a is None) == (b is None), k
    if a is not None:
      assert a.dtype == b.dtype and a.shape == b.shape, k
      np.testing.assert_array_equal(a, b, err_msg=k)
  for k in ("depths", "poses", "intrinsics", "render_poses"):
    a, b = getattr(got, k), getattr(want, k)
    assert (a is None) == (b is None), k
    if k != "depths" or kw.get("load_depth", True):
      assert a is not None, k
    if a is not None:
      assert a.dtype == b.dtype and a.shape == b.shape, k
      np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=k)
  for k in ("near", "far", "scale"):
    assert abs(getattr(got, k) - getattr(want, k)) <= TOL, k
  if kw.get("load_semantic"):
    assert (got.semantics >= 0).any()


def test_load_flow_matches_jax(tmp_path):
  rng = np.random.default_rng(0)
  flow_dir = tmp_path / "flow"
  flow_dir.mkdir()
  for i in range(3):
    for kind in ("next", "prev"):
      np.save(flow_dir / f"{i:04d}_{kind}.npy",
              rng.standard_normal((4, 5, 2)).astype(np.float32))
  got, want = tscene.load_flow(str(tmp_path)), jscene.load_flow(str(tmp_path))
  assert got.shape == want.shape == (2, 3, 4, 5, 2)
  np.testing.assert_array_equal(got, want)
  assert tscene.load_flow(str(tmp_path / "missing")) is None


def test_parse_poses_bounds_matches_jax():
  arr = np.random.default_rng(1).standard_normal((5, 19)).astype(np.float32)
  for colmap in (False, True):
    a = arr[:, :17] if colmap else arr
    for x, y in zip(tscene.parse_poses_bounds(a, colmap),
                    jscene.parse_poses_bounds(a, colmap)):
      np.testing.assert_array_equal(x, y)


def test_camera_utils_match_jax():
  scene = jscene.load_nuscenes_scene(
      os.path.join(FIXTURES, "nuscenes_realfocal"), bd_factor=0.0,
      datahold=8, no_align=True)
  poses = scene.poses
  for fn, args in ((tcam.generate_ellipse_path, dict(n_frames=7)),
                   (tcam.generate_ellipse_path, dict(n_frames=5,
                                                     z_variation=0.5,
                                                     z_phase=0.25))):
    np.testing.assert_allclose(fn(poses, **args),
                               getattr(jcam, fn.__name__)(poses, **args),
                               rtol=0, atol=TOL)
  bds = np.array([[2.0, 60.0], [3.0, 80.0]], np.float32)
  np.testing.assert_allclose(tcam.generate_spiral_path(poses, bds, 9),
                             jcam.generate_spiral_path(poses, bds, 9),
                             rtol=0, atol=TOL)
  got, want = tcam.transform_poses_pca(poses), jcam.transform_poses_pca(poses)
  for a, b in zip(got[:2], want[:2]):
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
  assert abs(got[2] - want[2]) <= TOL
  np.testing.assert_array_equal(tcam.focus_point_fn(poses),
                                jcam.focus_point_fn(poses))
  np.testing.assert_array_equal(tcam.average_pose(poses),
                                jcam.average_pose(poses))
  np.testing.assert_array_equal(tcam.unpad_poses(tcam.pad_poses(poses)),
                                poses)
