"""s -> t maps, the fn2 scene warp, the zip-nerf contraction and ray
warps (counterpart of snerf_tpu/ops/coord.py). `warp_fn1` and
`track_gaussian` (the fn = 0 branch) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def s_to_t_disparity(s, near, far):
  """Disparity spacing: t = 1 / ((1-s)/near + s/far)."""
  return 1.0 / ((1 - s) / near + s / far)


def s_to_t_log(s, near, far):
  """Log spacing: t = near * exp(s * log(far/near))."""
  return near * torch.exp(s * torch.log(far / near))


def s_to_t_linear(s, near, far):
  return near * (1 - s) + far * s


S_TO_T = {
    "log": s_to_t_log,
    "disparity": s_to_t_disparity,
    "linear": s_to_t_linear,
}


def s_to_t(s, near, far, kind: str = "log"):
  return S_TO_T[kind](s, near, far)


def warp_fn2(x: torch.Tensor, radius: float = 3.0) -> torch.Tensor:
  """mip-360-style contraction with an inner ball of `radius`:
  x / radius inside, (2 - radius/|x|) x/|x| outside."""
  l = torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8
  outer = (2.0 - radius / l) * x / l
  inner = x / radius
  return torch.where(l > radius, outer, inner)


def warp_fn2_gaussian_diag(means: torch.Tensor, covs_diag: torch.Tensor,
                           radius: float = 3.0):
  """Warp Gaussians (mean, diagonal cov) through warp_fn2 and return the
  diagonal of J diag(d) J^T, which is all the axis-aligned IPE reads:
  diag_k = g^2 d_k + 2 g c x_k^2 d_k + c^2 x_k^2 (x.(d*x)).
  Returns (f_means [..., 3], f_var_diag [..., 3]).
  """
  r2 = torch.sum(means ** 2, dim=-1, keepdim=True)
  r = torch.sqrt(torch.clamp(r2, min=1e-16)) + 1e-8
  inside = r <= radius
  g = torch.where(inside, 1.0 / radius, 2.0 / r - radius / (r * r))
  c = torch.where(inside, 0.0,
                  (-2.0 / (r * r) + 2.0 * radius / (r ** 3)) / r)
  f_means = g * means
  x2 = means ** 2
  xtdx = torch.sum(covs_diag * x2, dim=-1, keepdim=True)
  diag = (g ** 2) * covs_diag + 2.0 * g * c * x2 * covs_diag \
      + (c ** 2) * x2 * xtdx
  return f_means, diag


def contract(x: torch.Tensor) -> torch.Tensor:
  """mip-360 Eq.10 contraction towards the origin (unit inner ball)."""
  x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True),
                         min=_F32_EPS)
  scale = (2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq
  return torch.where(x_mag_sq <= 1, x, scale * x)


def contract_mean_std(x: torch.Tensor, std: torch.Tensor):
  """Contract isotropic Gaussians: scale std by det(J)^(1/3).

  x: [..., 3]; std: [...]. Returns (z [..., 3], new_std [...]).
  """
  x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True),
                         min=_F32_EPS)
  x_mag = torch.sqrt(x_mag_sq)
  mask = x_mag_sq <= 1
  z = torch.where(mask, x, ((2 * x_mag - 1) / x_mag_sq) * x)
  det = ((1 / x_mag_sq) * (2 / x_mag - 1 / x_mag_sq) ** 2)[..., 0]
  new_std = torch.where(mask[..., 0], std, det ** (1 / x.shape[-1]) * std)
  return z, new_std


def power_transformation(x, lam: float):
  """zip-nerf Eq.4 power transformation."""
  lam_1 = abs(lam - 1)
  return lam_1 / lam * ((x / lam_1 + 1) ** lam - 1)


def inv_power_transformation(x, lam: float):
  lam_1 = abs(lam - 1)
  return ((x * lam / lam_1 + 1 + _F32_EPS) ** (1 / lam) - 1) * lam_1


def construct_ray_warps(fn, t_near, t_far, lam: float | None = None):
  """(t_to_s, s_to_t) bijections between metric and [0, 1] distances.

  fn in {None, 'piecewise', 'power_transformation', 'reciprocal', 'log',
  'exp', 'sqrt', 'square'}.
  """
  if fn is None:
    fn_fwd, fn_inv = (lambda x: x), (lambda x: x)
  elif fn == "piecewise":
    fn_fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
    fn_inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
  elif fn == "power_transformation":
    fn_fwd = lambda x: power_transformation(x * 2, lam=lam)
    fn_inv = lambda y: inv_power_transformation(y, lam=lam) / 2
  elif fn == "reciprocal":
    fn_fwd, fn_inv = torch.reciprocal, torch.reciprocal
  elif fn == "log":
    fn_fwd, fn_inv = torch.log, torch.exp
  elif fn == "exp":
    fn_fwd, fn_inv = torch.exp, torch.log
  elif fn == "sqrt":
    fn_fwd, fn_inv = torch.sqrt, torch.square
  elif fn == "square":
    fn_fwd, fn_inv = torch.square, torch.sqrt
  else:
    raise ValueError(f"unknown ray warp {fn!r}")

  s_near, s_far = fn_fwd(t_near), fn_fwd(t_far)
  t_to_s = lambda t: (fn_fwd(t) - s_near) / (s_far - s_near)
  s_to_t_ = lambda s: fn_inv(s * s_far + (1 - s) * s_near)
  return t_to_s, s_to_t_
