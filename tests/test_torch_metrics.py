"""The port's quality metrics (snerf_tpu_torch/utils/metrics.py) against
snerf_tpu.utils.metrics on the same seeded images.

psnr, ssim and ms_ssim within 1e-5 absolute, float32 on both sides: the
blur's sums run in another order (conv2d against XLA's conv), ~1e-7.
The SSIM map agrees within 1e-5 per pixel on textured images. The
near-constant image is the clamp case: E[x^2] - mu^2 cancels there (mu^2
~0.5, float32 spacing ~6e-8, against c2 = 9e-4), so a pixel of the map
carries ~1e-4 of summation-order noise in either package; the mean SSIM
averages it out to within 1e-5 (5e-6 read), and the clamp plus the
Cauchy-Schwarz cap keep the map in [-1, 1] in both. kitti_depth_metrics
and MiouEvaluator are the same numpy and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.utils import metrics as jm
from snerf_tpu_torch.utils import metrics as tm

TOL = 1e-5


def _pair(seed, noise=0.1, shape=(48, 40, 3)):
  rng = np.random.default_rng(seed)
  a = rng.random(shape).astype(np.float32)
  b = np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
  return a, b


def _near_constant(seed, shape=(32, 36, 3)):
  """A flat image with ~1e-4 ripples: float32 cancellation territory."""
  rng = np.random.default_rng(seed)
  a = (0.73 + 1e-4 * rng.standard_normal(shape)).astype(np.float32)
  b = (0.73 + 1e-4 * rng.standard_normal(shape)).astype(np.float32)
  return a, b


@pytest.mark.parametrize("kind", ["noise 0.1", "noise 0.3", "near-constant"])
def test_psnr_ssim_match_jax(kind):
  a, b = {"noise 0.1": lambda: _pair(0), "noise 0.3": lambda: _pair(1, 0.3),
          "near-constant": lambda: _near_constant(2)}[kind]()
  ta, tb = torch.from_numpy(a), torch.from_numpy(b)
  ja, jb = jnp.asarray(a), jnp.asarray(b)
  # PSNR: -10 log10 of a float32 mean; 1e-5 of it relative
  want_psnr = float(jm.psnr(ja, jb))
  assert abs(float(tm.psnr(ta, tb)) - want_psnr) <= TOL * abs(want_psnr)
  assert abs(float(tm.ssim(ta, tb)) - float(jm.ssim(ja, jb))) <= TOL
  got = tm.ssim(ta, tb, return_map=True).numpy()
  want = np.asarray(jm.ssim(ja, jb, return_map=True))
  assert got.shape == want.shape
  # in [-1, 1] up to the rounding of the last division
  assert got.max() <= 1 + 1e-6 and got.min() >= -1 - 1e-6
  assert want.max() <= 1 + 1e-6 and want.min() >= -1 - 1e-6
  if kind != "near-constant":
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_ssim_clamp_case_stays_in_range():
  """Identical near-constant images: the unclamped variance goes negative
  and the plain formula reads above 1; the clamped one reads 1 in both."""
  a, _ = _near_constant(3)
  t = torch.from_numpy(a)
  s = tm.ssim(t, t, return_map=True)
  assert float(s.max()) <= 1.0 + 1e-6
  assert abs(float(tm.ssim(t, t)) - float(jm.ssim(jnp.asarray(a),
                                                   jnp.asarray(a)))) <= TOL


def test_ms_ssim_matches_jax():
  a, b = _pair(4, 0.05, shape=(192, 200, 3))
  got = float(tm.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
  want = float(jm.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
  assert abs(got - want) <= TOL


def test_metric_harness():
  """PSNR and SSIM, then with lpips=True the mean VGG feature distance of
  the seeded pyramid (an odd 37 x 53 pair), within TOL relative."""
  a, b = _pair(5)
  got = tm.MetricHarness()(torch.from_numpy(a), torch.from_numpy(b))
  want = jm.MetricHarness()(jnp.asarray(a), jnp.asarray(b))
  assert set(got) == set(want) == {"psnr", "ssim"}
  assert abs(got["psnr"] - want["psnr"]) <= TOL * abs(want["psnr"])
  assert abs(got["ssim"] - want["ssim"]) <= TOL
  a, b = _pair(8, shape=(37, 53, 3))
  got = tm.MetricHarness(lpips=True, device="cpu")(torch.from_numpy(a),
                                                   torch.from_numpy(b))
  want = jm.MetricHarness(lpips=True)(jnp.asarray(a), jnp.asarray(b))
  assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
  assert want["lpips"] > 0
  assert abs(got["lpips"] - want["lpips"]) <= TOL * want["lpips"]


def test_kitti_depth_metrics_equal():
  rng = np.random.default_rng(6)
  gt = rng.uniform(0, 90, (30, 40))
  gt[rng.random(gt.shape) < 0.3] = 0
  pred = gt + rng.standard_normal(gt.shape)
  assert tm.kitti_depth_metrics(pred, gt) == jm.kitti_depth_metrics(pred, gt)


def test_miou_evaluator_equal():
  rng = np.random.default_rng(7)
  t, j = tm.MiouEvaluator(5), jm.MiouEvaluator(5)
  for _ in range(3):
    gt = rng.integers(-1, 5, (20, 30))
    pred = rng.integers(0, 5, (20, 30))
    t.add_batch(gt, pred)
    j.add_batch(gt, pred)
  np.testing.assert_array_equal(t.confusion, j.confusion)
  assert t.miou() == j.miou()
  assert tm.MiouEvaluator(3).miou() == jm.MiouEvaluator(3).miou() == 0.0
