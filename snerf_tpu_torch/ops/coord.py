"""s -> t maps and the fn2 scene warp (counterpart of
snerf_tpu/ops/coord.py). `warp_fn1` and `track_gaussian` (the fn = 0
branch) are not ported yet.
"""

from __future__ import annotations

import torch


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
