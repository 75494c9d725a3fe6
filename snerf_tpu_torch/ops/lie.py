"""SO(3) / SE(3) helpers for pose refinement (counterpart of
snerf_tpu/ops/lie.py). Batched over leading dims."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
  """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
  zeros = torch.zeros_like(v[..., 0])
  return torch.stack([
      torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
      torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
      torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
  ], dim=-2)


def exp_so3(r: torch.Tensor) -> torch.Tensor:
  """Rodrigues exp map, Taylor-safe near theta = 0. r: [..., 3] ->
  [..., 3, 3].

  Grad-safe at r = 0 by the double `where`: the sqrt only sees a value
  bounded away from 0 and the small branch is polynomial in theta^2. A
  bare sin(theta) / theta gives NaN grads there, and LearnPose's tables
  start at 0 and are differentiated through here every step.
  """
  theta_sq = torch.sum(r ** 2, dim=-1, keepdim=True)[..., None]  # [...,1,1]
  K = skew(r)
  K2 = K @ K
  small = theta_sq < 1e-12
  safe_theta_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
  theta = torch.sqrt(safe_theta_sq)
  a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
  b = torch.where(small, 0.5 - theta_sq / 24.0,
                  (1.0 - torch.cos(theta)) / safe_theta_sq)
  eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
  return eye + a * K + b * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
  """Inverse Rodrigues: [..., 3, 3] -> [..., 3] axis-angle."""
  trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
  cos_theta = torch.clamp((trace - 1) / 2, -1.0, 1.0)
  theta = torch.arccos(cos_theta)
  w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], dim=-1)
  sin_theta = torch.sin(theta)
  tiny = torch.abs(sin_theta) < 1e-6
  scale = torch.where(
      tiny, torch.full_like(theta, 0.5),
      theta / (2.0 * torch.where(tiny, torch.ones_like(sin_theta),
                                 sin_theta)))
  return scale[..., None] * w


def make_c2w(r: torch.Tensor, t: torch.Tensor, c2w_init=None):
  """Refined camera-to-world: the delta pose [Exp(r) | t] composed on the
  left of the initial pose: R = Exp(r) R_init, trans = Exp(r) t_init + t.

  r, t: [..., 3]; c2w_init: [..., >=3, 4] or None. Returns [..., 3, 4].
  """
  R_delta = exp_so3(r)
  if c2w_init is None:
    return torch.cat([R_delta, t[..., None]], dim=-1)
  R = R_delta @ c2w_init[..., :3, :3]
  trans = (R_delta @ c2w_init[..., :3, 3:4])[..., 0] + t
  return torch.cat([R, trans[..., None]], dim=-1)
