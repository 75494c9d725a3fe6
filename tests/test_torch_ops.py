"""snerf_tpu_torch.ops against snerf_tpu.ops on the same numpy inputs.

Tolerances: both sides run float32 on the CPU. Elementwise formulas
agree to a few ulps (atol 1e-6 on O(1) values, rtol 1e-5 where values
grow). Transcendentals of the two libraries differ by ~1 ulp of their
argument, so trig after range reduction (arguments up to 100 pi) gets
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.ops import coord as jcoord
from snerf_tpu.ops import math as jmath
from snerf_tpu.ops import mip as jmip
from snerf_tpu.ops import rays as jrays
from snerf_tpu.ops import render as jrender
from snerf_tpu.ops import sampling as jsampling
from snerf_tpu_torch.ops import coord, mip, rays, render, sampling
from snerf_tpu_torch.ops import math as smath


def T(x):
  return torch.from_numpy(np.array(x))


def close(torch_out, jax_out, atol=1e-6, rtol=1e-5):
  np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                             atol=atol, rtol=rtol)


def gaussians(rng, shape=(5, 7)):
  means = rng.uniform(-4, 4, shape + (3,)).astype(np.float32)
  covs = rng.uniform(1e-4, 0.05, shape + (3,)).astype(np.float32)
  return means, covs


# --- math -------------------------------------------------------------------


def test_safe_trig_floor_mod_matches_jax():
  rng = np.random.RandomState(0)
  x = np.concatenate([rng.uniform(-3e4, 3e4, 2000),
                      [-1000.5, -315.0, 314.2, 1e5 + 0.3, -1e5]]
                     ).astype(np.float32)
  close(smath.safe_sin(T(x)), jmath.safe_sin(x), atol=1e-5)
  close(smath.safe_cos(T(x)), jmath.safe_cos(x), atol=1e-5)
  # fmod would differ here: the reduction must be a floor-mod
  assert float(smath.safe_sin(T(np.float32([-1000.5])))) == pytest.approx(
      float(np.sin(np.float32(-1000.5) % np.float32(100 * np.pi))), abs=1e-5)


def test_safe_sqrt_and_psnr():
  x = np.float32([-1.0, 0.0, 1e-14, 0.25, 9.0])
  close(smath.safe_sqrt(T(x)), jmath.safe_sqrt(x))
  mse = np.float32([1e-4, 1e-2, 0.5])
  close(smath.mse_to_psnr(T(mse)), jmath.mse_to_psnr(mse), rtol=1e-6)


def _cdf_from_weights(w):
  pdf = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
  cdf = np.minimum(1, np.cumsum(pdf[..., :-1], -1))
  z = np.zeros(w.shape[:-1] + (1,), np.float32)
  return np.concatenate([z, cdf, z + 1], -1).astype(np.float32)


@pytest.mark.parametrize("flat", [False, True])
def test_bracket_searchsorted_equals_dense_mask(flat):
  """The searchsorted + gather bracket equals the JAX dense-mask bracket,
  also on CDFs with plateaus from zero-weight bins."""
  rng = np.random.RandomState(1)
  w = rng.uniform(0, 1, (6, 12)).astype(np.float32)
  if flat:
    w[:, 3:7] = 0.0      # interior plateau
    w[0, :] = 0.0
    w[0, 5] = 1.0        # one bin carries everything
    w[1, 8:] = 0.0       # trailing plateau
  cdf = _cdf_from_weights(w)
  bins = np.sort(rng.uniform(0, 1, (6, 13)), -1).astype(np.float32)
  # u on plateau values exactly, plus a dense sweep, all < cdf[-1] = 1
  eps = np.finfo(np.float32).eps
  u = np.linspace(0, 1 - eps, 50, dtype=np.float32)
  u = np.sort(np.concatenate(
      [np.broadcast_to(u, (6, 50)), np.minimum(cdf[:, :-1], 1 - eps)], -1),
      -1).astype(np.float32)
  got = smath.bracket(T(cdf), T(u), (T(bins), T(cdf)))
  want = jmath.bracket(cdf, u, (bins, cdf))
  for (g_lo, g_hi), (w_lo, w_hi) in zip(got, want):
    np.testing.assert_array_equal(g_lo.numpy(), np.asarray(w_lo))
    np.testing.assert_array_equal(g_hi.numpy(), np.asarray(w_hi))


# --- rays -------------------------------------------------------------------


def test_pad_rays_matches_jax():
  rng = np.random.RandomState(2)
  fields = {k: rng.normal(size=(5, 3 if k in ("origins", "directions",
                                               "viewdirs") else 1)
                          ).astype(np.float32)
            for k in ("origins", "directions", "viewdirs", "radii",
                      "lossmult", "near", "far")}
  got = rays.pad_rays(rays.Rays(**{k: T(v) for k, v in fields.items()}), 8)
  want = jrays.pad_rays(jrays.Rays(**{k: jnp.asarray(v)
                                      for k, v in fields.items()}), 8)
  for k in fields:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)))
  assert got.app is None and got.batch_shape == (8,)


# --- coord ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["log", "disparity", "linear"])
def test_s_to_t(kind):
  rng = np.random.RandomState(3)
  s = np.sort(rng.uniform(0, 1, (4, 9)), -1).astype(np.float32)
  near = rng.uniform(0.1, 1, (4, 1)).astype(np.float32)
  far = rng.uniform(5, 80, (4, 1)).astype(np.float32)
  close(coord.s_to_t(T(s), T(near), T(far), kind),
        jcoord.s_to_t(s, near, far, kind), rtol=2e-6)


def test_warp_fn2_and_gaussian_diag():
  means, covs = gaussians(np.random.RandomState(4))
  close(coord.warp_fn2(T(means)), jcoord.warp_fn2(means))
  got = coord.warp_fn2_gaussian_diag(T(means), T(covs), radius=3.0)
  want = jcoord.warp_fn2_gaussian_diag(means, covs, radius=3.0)
  for g, w in zip(got, want):
    close(g, w, atol=1e-7)


# --- mip --------------------------------------------------------------------


def test_pos_enc():
  x = np.random.RandomState(5).normal(size=(6, 3)).astype(np.float32)
  for ident in (True, False):
    close(mip.pos_enc(T(x), 0, 4, ident), jmip.pos_enc(x, 0, 4, ident))


def test_expected_sin():
  rng = np.random.RandomState(6)
  x = rng.uniform(-50, 50, (40,)).astype(np.float32)
  v = rng.uniform(0, 3, (40,)).astype(np.float32)
  for g, w in zip(mip.expected_sin(T(x), T(v)), jmip.expected_sin(x, v)):
    close(g, w, atol=1e-6)


def _frustum_inputs(seed=7):
  rng = np.random.RandomState(seed)
  d = rng.normal(size=(4, 3)).astype(np.float32)
  t = np.sort(rng.uniform(0.5, 20, (4, 9)), -1).astype(np.float32)
  radii = rng.uniform(1e-3, 1e-2, (4, 1)).astype(np.float32)
  origins = rng.normal(size=(4, 3)).astype(np.float32)
  return d, t, radii, origins


def test_conical_frustum_and_lift_gaussian():
  d, t, radii, _ = _frustum_inputs()
  got = mip.conical_frustum_to_gaussian(T(d), T(t[:, :-1]), T(t[:, 1:]),
                                        T(radii))
  want = jmip.conical_frustum_to_gaussian(d, t[:, :-1], t[:, 1:], radii,
                                          diag=True)
  for g, w in zip(got, want):
    close(g, w)


def test_cylinder_to_gaussian():
  d, t, radii, _ = _frustum_inputs(8)
  got = mip.cylinder_to_gaussian(T(d), T(t[:, :-1]), T(t[:, 1:]), T(radii))
  want = jmip.cylinder_to_gaussian(d, t[:, :-1], t[:, 1:], radii, diag=True)
  for g, w in zip(got, want):
    close(g, w)


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays(ray_shape):
  d, t, radii, origins = _frustum_inputs(9)
  got = mip.cast_rays(T(t), T(origins), T(d), T(radii), ray_shape)
  want = jmip.cast_rays(t, origins, d, radii, ray_shape, diag=True)
  for g, w in zip(got, want):
    close(g, w)


@pytest.mark.parametrize("method", ["exact", "double_angle"])
def test_integrated_pos_enc_per_degree(method):
  """Identical (mean, var) inputs: each degree's features agree to 1e-5.
  Scaling by 2^deg is exact, so the only difference is the libraries'
  sin/cos after the same range reduction."""
  means, covs = gaussians(np.random.RandomState(10))
  covs = covs * 1e-3
  got = mip.integrated_pos_enc(T(means), T(covs), 0, 16, method).numpy()
  want = np.asarray(jmip.integrated_pos_enc(means, covs, 0, 16, diag=True,
                                            method=method))
  assert got.shape == want.shape == (5, 7, 96)
  # layout [sin | cos] x [deg0 xyz, deg1 xyz, ...]
  g = got.reshape(5, 7, 2, 16, 3)
  w = want.reshape(5, 7, 2, 16, 3)
  # double-angle error grows ~2^deg eps in both implementations
  for deg in range(16):
    atol = 1e-5 if method == "exact" else 1e-6 * 2.0 ** deg
    np.testing.assert_allclose(g[..., deg, :], w[..., deg, :], atol=atol,
                               err_msg=f"degree {deg}")


def test_ipe_through_the_warp_chain_per_degree():
  """cast -> fn2 warp -> IPE computed separately by each package: the
  means differ by ulps, which degree j multiplies by 2^j. Bound each
  degree by 2^j * 4e-7 * |mean| (a few ulps) plus 1e-5."""
  d, t, radii, origins = _frustum_inputs(11)
  tm, tc = mip.cast_rays(T(t), T(origins), T(d), T(radii), "cone")
  tm, tc = coord.warp_fn2_gaussian_diag(tm, tc)
  jm, jc = jmip.cast_rays(t, origins, d, radii, "cone", diag=True)
  jm, jc = jcoord.warp_fn2_gaussian_diag(jm, jc)
  got = mip.integrated_pos_enc(tm, tc, 0, 16).numpy().reshape(4, 8, 2, 16, 3)
  want = np.asarray(jmip.integrated_pos_enc(jm, jc, 0, 16)).reshape(
      4, 8, 2, 16, 3)
  mag = np.abs(np.asarray(jm))[:, :, None, :]
  for deg in range(16):
    bound = 1e-5 + 2.0 ** deg * 4e-7 * mag
    err = np.abs(got[..., deg, :] - want[..., deg, :])
    assert np.all(err <= bound), (deg, float(err.max()))


# --- sampling ---------------------------------------------------------------


def test_stratified_sample_deterministic_and_injected():
  got = sampling.stratified_sample((3,), 16, "cpu")
  close(got, jsampling.stratified_sample(None, (3,), 16), atol=0)
  key = jax.random.PRNGKey(0)
  draws = np.asarray(jax.random.uniform(key, (3, 17)))
  got = sampling.stratified_sample((3,), 16, "cpu", rand=T(draws))
  close(got, jsampling.stratified_sample(key, (3,), 16), atol=1e-7)


def _pdf_inputs(seed, zero=False):
  rng = np.random.RandomState(seed)
  bins = np.sort(rng.uniform(0, 1, (5, 17)), -1).astype(np.float32)
  w = rng.uniform(0, 1, (5, 16)).astype(np.float32)
  if zero:
    w[0] = 0.0
    w[1, 4:12] = 0.0
  return bins, w


@pytest.mark.parametrize("zero", [False, True])
def test_sorted_piecewise_constant_pdf(zero):
  bins, w = _pdf_inputs(12, zero)
  close(sampling.sorted_piecewise_constant_pdf(T(bins), T(w), 24),
        jsampling.sorted_piecewise_constant_pdf(None, bins, w, 24),
        atol=1e-6)
  key = jax.random.PRNGKey(1)
  draws = np.asarray(jax.random.uniform(key, (5, 24)))
  close(sampling.sorted_piecewise_constant_pdf(T(bins), T(w), 24,
                                               rand=T(draws)),
        jsampling.sorted_piecewise_constant_pdf(key, bins, w, 24),
        atol=1e-6)


def test_blur_and_resample_from_weights():
  bins, w = _pdf_inputs(13)
  close(sampling.blur_weights(T(w), 0.01), jsampling.blur_weights(w, 0.01))
  got = sampling.resample_from_weights(T(bins), T(w), 20)
  close(got, jsampling.resample_from_weights(None, bins, w, 20), atol=1e-6)
  assert got.shape == (5, 21) and not got.requires_grad
  assert torch.all(got[:, 1:] >= got[:, :-1])


# --- render -----------------------------------------------------------------


def _render_inputs(seed=14):
  rng = np.random.RandomState(seed)
  density = rng.uniform(0, 5, (4, 12)).astype(np.float32)
  s = np.sort(rng.uniform(0, 1, (4, 13)), -1).astype(np.float32)
  dirs = rng.normal(size=(4, 3)).astype(np.float32)
  rgb = rng.uniform(0, 1, (4, 12, 3)).astype(np.float32)
  sem = rng.normal(size=(4, 12, 5)).astype(np.float32)
  return density, s, dirs, rgb, sem


def test_compute_alpha_weights():
  density, s, dirs, _, _ = _render_inputs()
  got = render.compute_alpha_weights(T(density), T(s * 10), T(dirs))
  want = jrender.compute_alpha_weights(density, s * 10, dirs)
  for g, w in zip(got, want):
    close(g, w)


@pytest.mark.parametrize("kind,white", [("log", False), ("disparity", True),
                                        ("linear", False)])
def test_volumetric_rendering(kind, white):
  density, s, dirs, rgb, sem = _render_inputs(15)
  near = np.full((4, 1), 0.5, np.float32)
  far = np.full((4, 1), 40.0, np.float32)
  got = render.volumetric_rendering(T(rgb), T(density), T(s), T(dirs),
                                    T(near), T(far), semantic=T(sem),
                                    white_bkgd=white, t_transform=kind)
  want = jrender.volumetric_rendering(rgb, density, s, dirs, near, far,
                                      semantic=sem, white_bkgd=white,
                                      t_transform=kind)
  for k in ("rgb", "distance", "acc", "weights", "semantic", "t_vals"):
    close(got[k], want[k], atol=1e-5, rtol=1e-5)
