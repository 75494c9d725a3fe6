"""The zip slice's ops in snerf_tpu_torch against snerf_tpu on the same
numpy inputs, and kernel K2's CPU path against the JAX gathers.

Tolerances: both sides run float32 on the CPU. Elementwise formulas and
the interpolations agree to a few ulps (atol 1e-6 on O(1) values). The
cumulative sums differ in order (XLA's CPU cumsum is an associative
scan, torch's a running sum), ~1e-7 on these sizes. Where a sample grid
enters, torch.linspace and jnp.linspace (which XLA rewrites into
reciprocal multiplies) can differ in the last ulp of a point; the
sampled values get atol 1e-5, which covers such an ulp moved through an
inverse-CDF interpolation with slopes up to ~100. A gather copies bits,
so the gathers must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from snerf_tpu.ops import coord as jcoord
from snerf_tpu.ops import hash_ops as jhash_ops
from snerf_tpu.ops import math as jmath
from snerf_tpu.ops import render as jrender
from snerf_tpu.ops import stepfun as jstepfun
from snerf_tpu.ops.pallas.hash_gather_dense import gather_rows_dense
from snerf_tpu_torch.ops import coord, hash_ops, render, stepfun
from snerf_tpu_torch.ops import math as smath


def T(x):
  return torch.from_numpy(np.array(x))


def close(torch_out, jax_out, atol=1e-6, rtol=0):
  np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                             atol=atol, rtol=rtol)


def step_function(rng, batch=(6, 5), n=24, plateaus=True):
  """Sorted knots t [..., n+1] in [0, 1] and weights w [..., n] summing to
  1, with zero-width intervals and zero weights mixed in."""
  t = np.sort(rng.uniform(0, 1, batch + (n + 1,)), axis=-1)
  t[..., 0], t[..., -1] = 0.0, 1.0
  w = rng.uniform(0, 1, batch + (n,))
  if plateaus:
    t[..., 5] = t[..., 4]
    w[..., 7:10] = 0.0
  w /= w.sum(-1, keepdims=True)
  return t.astype(np.float32), w.astype(np.float32)


# --- math -------------------------------------------------------------------


def test_searchsorted_and_interp_match_jax():
  rng = np.random.RandomState(0)
  xp, _ = step_function(rng)
  fp = np.cumsum(rng.uniform(0, 1, xp.shape), -1).astype(np.float32)
  # inside, on the knots, and outside [xp[0], xp[-1]]
  x = np.concatenate([rng.uniform(-0.2, 1.2, xp.shape[:-1] + (40,)),
                      xp[..., 3:9]], -1).astype(np.float32)
  lo, hi = smath.searchsorted(T(xp), T(x))
  jlo, jhi = jmath.searchsorted(xp, x)
  np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
  np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
  close(smath.interp(T(x), T(xp), T(fp)), jmath.interp(x, xp, fp))
  # xp shared across the batch broadcasts as in jnp
  close(smath.sorted_interp(T(x), T(xp[0, 0]), T(fp[0, 0])),
        jmath.sorted_interp(x, xp[0, 0], fp[0, 0]))


# --- stepfun ----------------------------------------------------------------


def test_pdf_and_integrate_weights_match_jax():
  t, w = step_function(np.random.RandomState(1))
  close(stepfun.weight_to_pdf(T(t), T(w)), jstepfun.weight_to_pdf(t, w),
        rtol=1e-6)
  p = np.asarray(jstepfun.weight_to_pdf(t, w))
  close(stepfun.pdf_to_weight(T(t), T(p)), jstepfun.pdf_to_weight(t, p),
        rtol=1e-6)
  close(stepfun.integrate_weights(T(w)), jstepfun.integrate_weights(w))


@pytest.mark.parametrize("renormalize", [False, True])
def test_max_dilate_weights_matches_jax(renormalize):
  t, w = step_function(np.random.RandomState(2))
  got_t, got_w = stepfun.max_dilate_weights(T(t), T(w), 0.03,
                                            domain=(0.0, 1.0),
                                            renormalize=renormalize)
  want_t, want_w = jstepfun.max_dilate_weights(t, w, 0.03, domain=(0.0, 1.0),
                                               renormalize=renormalize)
  close(got_t, want_t)
  close(got_w, want_w, rtol=1e-6)
  got_t, got_p = stepfun.max_dilate(T(t), T(w), 0.01)
  want_t, want_p = jstepfun.max_dilate(t, w, 0.01)
  close(got_t, want_t)
  close(got_p, want_p)


def test_invert_cdf_matches_jax():
  rng = np.random.RandomState(3)
  t, w = step_function(rng)
  logits = np.where(w > 0, np.log(w + 1e-30), -np.inf).astype(np.float32)
  u = np.sort(rng.uniform(0, 1, t.shape[:-1] + (17,)), -1).astype(np.float32)
  close(stepfun.invert_cdf(T(u), T(t), T(logits)),
        jstepfun.invert_cdf(u, t, logits), atol=1e-5)


@pytest.mark.parametrize("deterministic_center", [False, True])
def test_sample_deterministic_matches_jax(deterministic_center):
  t, w = step_function(np.random.RandomState(4))
  logits = np.log(w + 1e-30).astype(np.float32)
  got = stepfun.sample(T(t), T(logits), 9,
                       deterministic_center=deterministic_center)
  want = jstepfun.sample(None, t, logits, 9,
                         deterministic_center=deterministic_center)
  close(got, want, atol=1e-5)


@pytest.mark.parametrize("single_jitter", [False, True])
def test_sample_jittered_with_injected_draws_matches_jax(single_jitter):
  """The JAX sampler draws uniform(key, [..., d]); the port gets the same
  draws as `rand`."""
  t, w = step_function(np.random.RandomState(5))
  logits = np.log(w + 1e-30).astype(np.float32)
  key = jax.random.PRNGKey(7)
  d = 1 if single_jitter else 9
  rand = np.asarray(jax.random.uniform(key, t.shape[:-1] + (d,)))
  got = stepfun.sample(T(t), T(logits), 9, single_jitter=single_jitter,
                       rand=T(rand))
  want = jstepfun.sample(key, t, logits, 9, single_jitter=single_jitter)
  close(got, want, atol=1e-5)
  with pytest.raises(ValueError):
    stepfun.sample(T(t), T(logits), 9, single_jitter=single_jitter,
                   rand=T(rand[..., :0]))


def test_sample_intervals_matches_jax():
  t, w = step_function(np.random.RandomState(6))
  logits = np.where(t[..., 1:] > t[..., :-1], np.log(w + 1e-30),
                    -np.inf).astype(np.float32)
  got = stepfun.sample_intervals(T(t), T(logits), 16, single_jitter=True,
                                 domain=(0.0, 1.0))
  want = jstepfun.sample_intervals(None, t, logits, 16, single_jitter=True,
                                   domain=(0.0, 1.0))
  assert got.shape == (6, 5, 17)
  close(got, want, atol=1e-5)
  with pytest.raises(ValueError):
    stepfun.sample_intervals(T(t), T(logits), 1)


# --- coord ------------------------------------------------------------------


def test_contract_and_contract_mean_std_match_jax():
  rng = np.random.RandomState(7)
  # inside and outside the unit ball, and the origin
  x = (rng.normal(size=(40, 7, 3)) * rng.choice([0.3, 3.0, 40.0],
                                                (40, 1, 1))).astype(np.float32)
  x[0, 0] = 0.0
  std = rng.uniform(1e-4, 0.1, (40, 7)).astype(np.float32)
  close(coord.contract(T(x)), jcoord.contract(x), rtol=1e-6)
  z, s = coord.contract_mean_std(T(x), T(std))
  jz, js = jcoord.contract_mean_std(x, std)
  close(z, jz, rtol=1e-6)
  close(s, js, rtol=1e-5)


@pytest.mark.parametrize("fn", [None, "piecewise", "power_transformation",
                                "reciprocal", "log", "exp", "sqrt",
                                "square"])
def test_construct_ray_warps_match_jax(fn):
  rng = np.random.RandomState(8)
  near = rng.uniform(0.1, 0.5, (11, 1)).astype(np.float32)
  far = rng.uniform(2.0, 3.0, (11, 1)).astype(np.float32)
  s = np.sort(rng.uniform(0, 1, (11, 9)), -1).astype(np.float32)
  t_to_s, s_to_t = coord.construct_ray_warps(fn, T(near), T(far), lam=-1.5)
  jt_to_s, js_to_t = jcoord.construct_ray_warps(fn, near, far, lam=-1.5)
  t = np.asarray(js_to_t(s))
  close(s_to_t(T(s)), t, rtol=1e-5)
  close(t_to_s(T(t)), jt_to_s(t), atol=1e-5)
  if fn == "power_transformation":
    close(coord.power_transformation(T(t), -1.5),
          jcoord.power_transformation(t, -1.5), rtol=1e-6)
    close(coord.inv_power_transformation(T(s), -1.5),
          jcoord.inv_power_transformation(s, -1.5), rtol=1e-6)


def test_construct_ray_warps_rejects_unknown():
  with pytest.raises(ValueError):
    coord.construct_ray_warps("cubic", T([[1.0]]), T([[2.0]]))


# --- render -----------------------------------------------------------------


@pytest.mark.parametrize("opaque", [False, True])
def test_compute_alpha_weights_opaque_background(opaque):
  rng = np.random.RandomState(9)
  density = rng.uniform(0, 3, (8, 12)).astype(np.float32)
  t = np.sort(rng.uniform(0.5, 6, (8, 13)), -1).astype(np.float32)
  dirs = rng.normal(size=(8, 3)).astype(np.float32)
  got = render.compute_alpha_weights(T(density), T(t), T(dirs),
                                     opaque_background=opaque)
  want = jrender.compute_alpha_weights(density, t, dirs,
                                       opaque_background=opaque)
  for g, w in zip(got, want):
    assert bool(torch.isfinite(g).all())
    close(g, w)
  if opaque:
    close(got[0].sum(-1), np.ones(8), atol=1e-6)


def test_volumetric_rendering_zip_matches_jax():
  rng = np.random.RandomState(10)
  w = rng.uniform(0, 0.1, (8, 12)).astype(np.float32)
  w[0] = 0.0                                    # empty ray: depth clips
  t = np.sort(rng.uniform(0.5, 6, (8, 13)), -1).astype(np.float32)
  rgb = rng.uniform(0, 1, (8, 12, 3)).astype(np.float32)
  sem = rng.uniform(0, 1, (8, 12, 5)).astype(np.float32)
  far = np.full((8, 1), 6.0, np.float32)
  got = render.volumetric_rendering_zip(T(rgb), T(w), T(t), 1.0, T(far),
                                        semantic=T(sem))
  want = jrender.volumetric_rendering_zip(rgb, w, t, 1.0, far,
                                          semantic=sem)
  assert set(got) == {"rgb", "depth", "acc", "semantic"}
  for k in got:
    close(got[k], want[k], rtol=1e-6, atol=1e-6)
  with pytest.raises(NotImplementedError):
    render.volumetric_rendering_zip(T(rgb), T(w), T(t), 1.0, T(far),
                                    compute_extras=True)


@pytest.mark.parametrize("rotate", [False, True])
def test_cast_rays_multisample_matches_jax(rotate):
  from snerf_tpu.models.zipnerf import _ray_basis as jray_basis
  from snerf_tpu_torch.models.zipnerf import _ray_basis
  rng = np.random.RandomState(11)
  n = 10
  t = np.sort(rng.uniform(0.5, 6, (n, 9)), -1).astype(np.float32)
  origins = rng.normal(size=(n, 3)).astype(np.float32)
  dirs = rng.normal(size=(n, 3)).astype(np.float32)
  dirs[0] = [0.0, 0.0, 2.0]                     # the alternate basis branch
  radii = rng.uniform(1e-3, 1e-2, (n,)).astype(np.float32)
  bx, by = _ray_basis(T(dirs))
  jbx, jby = jray_basis(dirs)
  close(bx, jbx)
  close(by, jby)
  key = jax.random.PRNGKey(3) if rotate else None
  rand = (T(np.asarray(jax.random.uniform(key, (n, 8, 7)))) if rotate
          else None)
  means, stds = render.cast_rays_multisample(
      T(t), T(origins), T(dirs), T(radii), bx, by, n=7, m=3, rand=rand)
  jmeans, jstds = jrender.cast_rays_multisample(
      key, t, origins, dirs, radii, jbx, jby, n=7, m=3)
  assert means.shape == (n, 8, 7, 3) and stds.shape == (n, 8, 7)
  close(means, jmeans, atol=1e-5)
  close(stds, jstds, rtol=1e-6)


# --- K2 on the CPU ----------------------------------------------------------


@pytest.mark.parametrize("c", [1, 4, 8])
def test_gather_rows_matches_jax_gathers(c):
  """The CPU path (the kernel's plain version) equals the Pallas kernel in
  interpret mode and the XLA row gather, bit for bit; edge rows included."""
  rng = np.random.RandomState(c)
  table = rng.normal(size=(300, c)).astype(np.float32)
  idx = rng.randint(0, 300, 3000).astype(np.int32)
  idx[:2] = [0, 299]
  got = hash_ops.gather_rows(T(table), T(idx))
  assert hash_ops.gather_rows.launches == 0
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(gather_rows_dense(table, idx, interpret=True)))
  idx2 = idx.reshape(375, 8)
  np.testing.assert_array_equal(
      hash_ops.gather_rows(T(table), T(idx2)).numpy(),
      np.asarray(jhash_ops.gather_rows(table, idx2)))


def test_gather_rows_checks():
  table = torch.zeros(10, 4)
  with pytest.raises(ValueError):
    hash_ops.gather_rows(table, torch.zeros(3, dtype=torch.int64))
  with pytest.raises(ValueError):
    hash_ops.gather_rows(torch.zeros(10, 9), torch.zeros(3, dtype=torch.int32))
  # neither CPU nor CUDA: raises, never runs the plain version
  with pytest.raises(ValueError):
    hash_ops.gather_rows(table.to("meta"),
                         torch.zeros(3, dtype=torch.int32, device="meta"))
