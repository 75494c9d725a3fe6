"""Mip-NeRF primitives: positional encodings and conical-frustum
Gaussians (counterpart of snerf_tpu/ops/mip.py, diagonal covariances).
"""

from __future__ import annotations

import math

import torch

from snerf_tpu_torch.ops import math as smath


def _scales(min_deg: int, max_deg: int, like: torch.Tensor) -> torch.Tensor:
  return 2.0 ** torch.arange(min_deg, max_deg, dtype=like.dtype,
                             device=like.device)


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int,
            append_identity: bool = True) -> torch.Tensor:
  """Axis-aligned sinusoidal encoding: [..., d] -> [..., (d +) 2d(max-min)]."""
  scales = _scales(min_deg, max_deg, x)
  xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
  four_feat = smath.safe_sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
  if append_identity:
    return torch.cat([x, four_feat], dim=-1)
  return four_feat


def expected_sin(x: torch.Tensor, x_var: torch.Tensor):
  """E[sin(z)] and Var[sin(z)] for z ~ N(x, x_var)."""
  y = torch.exp(-0.5 * x_var) * smath.safe_sin(x)
  y_var = torch.clamp(
      0.5 * (1 - torch.exp(-2 * x_var) * smath.safe_cos(2 * x)) - y ** 2,
      min=0.0)
  return y, y_var


def lift_gaussian(d, t_mean, t_var, r_var):
  """Lift a 1D Gaussian along ray d (+ isotropic radial var) into 3D,
  diagonal covariance only."""
  mean = d[..., None, :] * t_mean[..., None]
  d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
  d_outer_diag = d ** 2
  null_outer_diag = 1 - d_outer_diag / d_mag_sq
  t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
  xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
  return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
  """Gaussian moments of a conical frustum between t0..t1 (mip-NeRF eq. 7,
  the numerically stable form)."""
  mu = (t0 + t1) / 2
  hw = (t1 - t0) / 2
  denom = 3 * mu ** 2 + hw ** 2
  t_mean = mu + (2 * mu * hw ** 2) / denom
  t_var = hw ** 2 / 3 - (4 / 15) * (hw ** 4 * (12 * mu ** 2 - hw ** 2)) / denom ** 2
  r_var = base_radius ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2 -
                              (4 / 15) * hw ** 4 / denom)
  return lift_gaussian(d, t_mean, t_var, r_var)


def cylinder_to_gaussian(d, t0, t1, radius):
  """Gaussian moments of a cylinder segment between t0..t1."""
  t_mean = (t0 + t1) / 2
  r_var = radius ** 2 / 4
  t_var = (t1 - t0) ** 2 / 12
  return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(t_vals, origins, directions, radii, ray_shape: str = "cone"):
  """Cast rays through metric t intervals -> per-interval Gaussians.

  t_vals: [..., S+1]; returns means [..., S, 3], diagonal covs [..., S, 3].
  """
  t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
  if ray_shape == "cone":
    gaussian_fn = conical_frustum_to_gaussian
  elif ray_shape == "cylinder":
    gaussian_fn = cylinder_to_gaussian
  else:
    raise ValueError(f"unknown ray_shape {ray_shape!r}")
  means, covs = gaussian_fn(directions, t0, t1, radii)
  return means + origins[..., None, :], covs


def integrated_pos_enc_fast(mean, cov_diag, min_deg: int, max_deg: int):
  """Double-angle IPE: the features of integrated_pos_enc with 6
  transcendentals per sample, through sin(2y) = 2 sin y cos y and
  cos(2y) = 1 - 2 sin^2 y. The error grows ~2^j eps at degree j.
  """
  y = mean * (2.0 ** min_deg)
  v = cov_diag * (4.0 ** min_deg)
  s = smath.safe_sin(y)
  c = smath.safe_cos(y)
  num_deg = max_deg - min_deg
  sins, coss, variances = [], [], []
  for j in range(num_deg):
    sins.append(s)
    coss.append(c)
    variances.append(v)
    if j < num_deg - 1:
      s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
      v = 4.0 * v
  sin_stack = torch.stack(sins, dim=-2).reshape(*mean.shape[:-1], -1)
  cos_stack = torch.stack(coss, dim=-2).reshape(*mean.shape[:-1], -1)
  var_stack = torch.stack(variances, dim=-2).reshape(*mean.shape[:-1], -1)
  w = torch.exp(-0.5 * var_stack)
  return torch.cat([w * sin_stack, w * cos_stack], dim=-1)


def integrated_pos_enc(mean, cov_diag, min_deg: int, max_deg: int,
                       method: str = "exact"):
  """Integrated positional encoding of diagonal Gaussians.

  Returns [..., 2*3*(max_deg-min_deg)] expected-sin features, laid out
  [sin deg0 xyz, sin deg1 xyz, ..., cos deg0 xyz, ...].
  """
  if method == "double_angle":
    return integrated_pos_enc_fast(mean, cov_diag, min_deg, max_deg)
  scales = _scales(min_deg, max_deg, mean)
  y = (mean[..., None, :] * scales[:, None]).reshape(*mean.shape[:-1], -1)
  y_var = (cov_diag[..., None, :] * scales[:, None] ** 2).reshape(
      *cov_diag.shape[:-1], -1)
  return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                      torch.cat([y_var, y_var], dim=-1))[0]
