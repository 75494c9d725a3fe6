"""Alpha compositing (counterpart of snerf_tpu/ops/render.py, S-NeRF
part; the zip model's opaque background and renderer come with its
slice)."""

from __future__ import annotations

import torch

from snerf_tpu_torch.ops import coord


def compute_alpha_weights(density, t_vals, dirs):
  """Compositing weights from density along metric t intervals.

  density: [..., S]; t_vals: [..., S+1]; dirs: [..., 3].
  Returns (weights, alpha, trans), each [..., S].
  """
  t_delta = t_vals[..., 1:] - t_vals[..., :-1]
  delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
  density_delta = density * delta
  alpha = 1 - torch.exp(-density_delta)
  trans = torch.exp(-torch.cat([
      torch.zeros_like(density_delta[..., :1]),
      torch.cumsum(density_delta[..., :-1], dim=-1)
  ], dim=-1))
  weights = alpha * trans
  return weights, alpha, trans


def volumetric_rendering(rgb, density, s_vals, dirs, near, far,
                         semantic=None, white_bkgd: bool = False,
                         t_transform: str = "log"):
  """S-NeRF-style rendering: s in [0,1] -> metric t, composite rgb/sem/depth.

  rgb: [..., S, 3] or None; density: [..., S]; s_vals: [..., S+1].
  Returns dict(rgb, distance, acc, weights, semantic, t_vals).
  """
  t_vals = coord.s_to_t(s_vals, near, far, t_transform)
  weights, _, _ = compute_alpha_weights(density, t_vals, dirs)

  t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
  acc = weights.sum(dim=-1)
  distance = (weights * t_mids).sum(dim=-1)
  distance = torch.clamp(torch.nan_to_num(distance, posinf=float("inf")),
                         t_vals[..., 0], t_vals[..., -1])

  comp_rgb = None
  if rgb is not None:
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    if white_bkgd:
      comp_rgb = comp_rgb + (1.0 - acc[..., None])
  comp_sem = None
  if semantic is not None:
    comp_sem = (weights[..., None] * semantic).sum(dim=-2)
  return dict(rgb=comp_rgb, distance=distance, acc=acc, weights=weights,
              semantic=comp_sem, t_vals=t_vals)
