"""The port's depth confidence (snerf_tpu_torch/models/confidence.py)
against snerf_tpu.models.confidence on the same numpy inputs, on the CPU.

The scene is the port's synthetic scene (a copy of the JAX one), passed
to both packages; one of its sizes is odd (17 x 23). Tolerances, float32
on both sides: every warp output, error map and confidence map within
1e-5 of max|JAX| (gathers, a few products and the VGG convolutions in
another summation order), but the SSIM mode's within SSIM_TOL; the
neighbour table equal; the uint8 precompute equal except by 1 where
JAX's float map lies within its mode's tolerance of a rounding edge (map
* 255 + 0.5 within 255 tol of an integer).

SSIM_TOL: the SSIM map divides by the blurred variances plus c2 = 9e-4,
which multiplies the f32 rounding of the blurred second moments (~1e-8
absolute) by up to ~2 / c2. On these warped views each f32 map is ~2e-4
off a float64 one, JAX's and the port's alike (1.98e-4 and 1.96e-4 read
at views 5 and 6), so no float32 SSIM can agree with another to 1e-5
everywhere (JAX's SSIM filter is float32, so the mode cannot be compared
in float64). Port against JAX, the SSIM mode reads 8.8e-6 in the error
map of views 3 and 4, 2.8e-5 in the confidence map of view 3 and 6.5e-5
in the float precompute maps (whose uint8 maps are equal); SSIM_TOL is
twice the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models import confidence as jc
from snerf_tpu.models.features import make_feature_fn as jax_feature_fn
from snerf_tpu_torch.data.sampler import scene_to_device
from snerf_tpu_torch.data.synthetic import make_synthetic_scene
from snerf_tpu_torch.models import confidence as tc
from snerf_tpu_torch.models.features import make_feature_fn

TOL = 1e-5
SSIM_TOL = 1.3e-4
ALL_MODES = ("rgb", "ssim", "depth", "vgg", "flow")


def _close(got, want, what, tol=TOL):
  got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    assert np.array_equal(got, want), what
    return
  scale = max(float(np.abs(want).max()), 1e-30)
  err = float(np.abs(got.astype(np.float64) - want).max())
  assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def scene():
  s = make_synthetic_scene(num_images=8, H=17, W=23, datahold=8)
  rng = np.random.RandomState(0)
  s.flow = rng.uniform(-2, 2, (2, 8, 17, 23, 2)).astype(np.float32)
  return s


def _view(scene, i):
  """One view's (img, depth, pose, intr) as numpy and as CPU tensors."""
  arrs = (scene.images[i].astype(np.float32) / 255.0, scene.depths[i],
          scene.poses[i], scene.intrinsics[i])
  return ([jnp.asarray(a) for a in arrs],
          [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs])


def test_bilinear_sample_off_grid_and_outside():
  rng = np.random.RandomState(1)
  img = rng.rand(7, 9, 3).astype(np.float32)
  # negative coordinates floor away from 0; far outside clamps
  x = rng.uniform(-3, 12, (5, 11)).astype(np.float32)
  y = rng.uniform(-3, 10, (5, 11)).astype(np.float32)
  x[0, :3] = [-0.5, -1e6, 1e6]
  want = jc.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
  got = tc.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                           torch.from_numpy(y))
  _close(got, want, "bilinear_sample")


@pytest.mark.parametrize("pair", [(3, 4), (4, 3), (6, 5)])
def test_project_and_warp(scene, pair):
  i, j = pair
  (jb, tb), (jt, tt) = _view(scene, i), _view(scene, j)
  want = jc.project_to_view(jb[1], jb[2], jb[3], jt[2], jt[3])
  got = tc.project_to_view(tb[1], tb[2], tb[3], tt[2], tt[3])
  for name, g, w in zip(("tgt_x", "tgt_y", "proj_depth", "in_front"), got,
                        want):
    _close(g, w, name)
  want = jc.warp_image(jb[1], jb[2], jb[3], *jt)
  got = tc.warp_image(tb[1], tb[2], tb[3], *tt)
  for name, g, w in zip(("fake_img", "tgt_depth_at", "proj_depth", "valid"),
                        got, want):
    _close(g, w, name)
  assert np.asarray(want[3]).mean() > 0.3


def test_err_maps_every_mode(scene):
  i, j = 3, 4
  (jb, tb), (jt, tt) = _view(scene, i), _view(scene, j)
  flow = scene.flow[0, i]
  want, wvalid = jc.reproj_err_maps(
      ALL_MODES, jb[0], jb[1], jb[2], jb[3], *jt,
      feature_fn=jax_feature_fn(), base_flow=jnp.asarray(flow))
  got, gvalid = tc.reproj_err_maps(
      ALL_MODES, tb[0], tb[1], tb[2], tb[3], *tt,
      feature_fn=make_feature_fn(device="cpu"),
      base_flow=torch.from_numpy(flow))
  _close(gvalid, wvalid, "valid")
  assert set(got) == set(want) == set(ALL_MODES)
  for m in ALL_MODES:
    _close(got[m], want[m], m, SSIM_TOL if m == "ssim" else TOL)
  # the SSIM error is edge-padded from its VALID-size map
  assert got["ssim"].shape == (17, 23)


def _neighbors(scene, ids, weights, flows):
  jn, tn = [], []
  for c, (k, w) in enumerate(zip(ids, weights)):
    (ja, ta) = _view(scene, k)
    jd = dict(zip(("img", "depth", "pose", "intr"), ja), weight=w)
    td = dict(zip(("img", "depth", "pose", "intr"), ta), weight=w)
    if c < len(flows):
      jd["flow"], td["flow"] = jnp.asarray(flows[c]), torch.from_numpy(
          flows[c])
    jn.append(jd)
    tn.append(td)
  return jn, tn


@pytest.mark.parametrize("modes", [("rgb", "ssim", "depth"), ALL_MODES])
def test_conf_maps_with_a_padded_slot(scene, modes):
  """Neighbours 2 and 4 of view 3, and a padded slot (itself, weight 0);
  the flow field on the first neighbour only, so "flow" is skipped for
  the others."""
  i = 3
  jb, tb = _view(scene, i)
  jn, tn = _neighbors(scene, (4, 2, 3), (1.0, 1.0, 0.0),
                      [scene.flow[0, i]])
  want = jc.reproj_conf_maps(modes, *jb, jn, tau=0.3,
                             feature_fn=jax_feature_fn())
  got = tc.reproj_conf_maps(modes, *tb, tn, tau=0.3,
                            feature_fn=make_feature_fn(device="cpu"))
  for m in modes:
    _close(got[m], want[m], m, SSIM_TOL if m == "ssim" else TOL)
    assert float(got[m].min()) >= 0 and float(got[m].max()) <= 1
  # the outlier rule zeroed some pixels of every mode
  assert bool((got["depth"] == 0).any())


@pytest.mark.parametrize("conf_num", [1, 2])
def test_neighbor_table_equal(conf_num):
  i_train = np.array([0, 1, 2, 4, 5, 6, 7, 9, 10, 11])
  cam = np.repeat(np.arange(3), 4)
  want = jc.build_neighbor_table(i_train, cam, conf_num)
  got = tc.build_neighbor_table(i_train, cam, conf_num)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and np.array_equal(g, w)


def test_combine_matches_jax():
  rng = np.random.RandomState(2)
  lambdas = rng.randn(3, 6).astype(np.float32)
  stack = rng.rand(3, 50).astype(np.float32)
  idx = rng.randint(0, 6, 50)
  jm = jc.ConfidenceModel(("rgb", "ssim", "depth"), 6)
  want = jm.combine({"lambdas": jnp.asarray(lambdas)}, jnp.asarray(stack),
                    jnp.asarray(idx))
  tm = tc.ConfidenceModel(("rgb", "ssim", "depth"), 6, device="cpu")
  assert tm.lambdas.shape == (3, 6)
  assert float(tm.lambdas.detach().abs().max()) == 0
  with torch.no_grad():
    tm.lambdas.copy_(torch.from_numpy(lambdas))
  _close(tm.combine(torch.from_numpy(stack), torch.from_numpy(idx)), want,
         "combine")
  with pytest.raises(ValueError, match="unknown confidence modes"):
    tc.ConfidenceModel(("rgb", "lidar"), 6, device="cpu")


def _assert_quantized_close(got, want_u8, want_f32, modes):
  got = got.cpu().numpy()
  assert got.dtype == np.uint8 and got.shape == want_u8.shape
  for c, m in enumerate(modes):
    diff = got[:, c].astype(np.int32) - want_u8[:, c].astype(np.int32)
    off = diff != 0
    assert np.abs(diff).max(initial=0) <= 1, m
    scaled = want_f32[:, c][off].astype(np.float64) * 255.0 + 0.5
    edge = np.abs(scaled - np.round(scaled))
    tol = SSIM_TOL if m == "ssim" else TOL
    assert (edge <= 255 * tol).all(), (m, edge.max(initial=0))


@pytest.mark.parametrize("modes,conf_num", [(("rgb", "ssim", "depth"), 2),
                                            (ALL_MODES, 1)])
def test_precompute_uint8(scene, modes, conf_num):
  fn = jax_feature_fn() if "vgg" in modes else None
  tfn = make_feature_fn(device="cpu") if "vgg" in modes else None
  want_u8 = jc.precompute_conf_maps(modes, scene, conf_num=conf_num, tau=0.3,
                                    feature_fn=fn)
  want_f32 = jc.precompute_conf_maps(modes, scene, conf_num=conf_num,
                                     tau=0.3, feature_fn=fn,
                                     dtype=np.float32)
  got = tc.precompute_conf_maps(modes, scene, scene_to_device(scene, "cpu"),
                                conf_num=conf_num, tau=0.3, feature_fn=tfn)
  assert got.shape == (len(scene.i_train), len(modes), 17, 23)
  _assert_quantized_close(got, want_u8, want_f32, modes)
  # every mode carries information
  assert all(float(got[:, m].float().std()) > 0 for m in range(len(modes)))


def test_quantize_rounding_edges():
  maps = torch.tensor([0.0, 1.0, 0.5 / 255, 1.5 / 255 - 1e-7, 2.0, -1.0])
  want = np.clip(maps.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
  assert np.array_equal(tc.quantize(maps).numpy(), want)
