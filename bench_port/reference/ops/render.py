"""Alpha compositing, zip-nerf rendering and multisample ray casting
(counterpart of snerf_tpu/ops/render.py)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bench_port.reference.ops import coord

_F32_EPS = float(np.finfo(np.float32).eps)


def compute_alpha_weights(density, t_vals, dirs,
                          opaque_background: bool = False):
  """Compositing weights from density along metric t intervals.

  density: [..., S]; t_vals: [..., S+1]; dirs: [..., 3]. With
  opaque_background the last interval is infinitely dense, so the weights
  sum to 1. Returns (weights, alpha, trans), each [..., S].
  """
  t_delta = t_vals[..., 1:] - t_vals[..., :-1]
  delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
  density_delta = density * delta
  if opaque_background:
    density_delta = torch.cat([
        density_delta[..., :-1],
        torch.full_like(density_delta[..., -1:], float("inf"))
    ], dim=-1)
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


def volumetric_rendering_zip(rgbs, weights, t_vals, bg_rgbs, t_far,
                             compute_extras: bool = False, semantic=None):
  """zip-nerf rendering with a log-space depth expectation.

  rgbs: [..., S, 3]; weights: [..., S]; t_vals: [..., S+1]; bg_rgbs: a
  float or [..., 3]; semantic: [..., S, K] or None. Returns dict(rgb,
  depth, acc[, semantic]). The distance percentiles of compute_extras are
  not ported yet.
  """
  if compute_extras:
    raise NotImplementedError("compute_extras is not ported yet")
  acc = weights.sum(dim=-1)
  bg_w = torch.clamp(1 - acc[..., None], min=0.0)
  rendering = {
      "rgb": (weights[..., None] * rgbs).sum(dim=-2) + bg_w * bg_rgbs}
  t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
  expectation = ((weights * torch.log(t_mids)).sum(dim=-1)
                 / torch.clamp(acc, min=_F32_EPS))
  rendering["depth"] = torch.clamp(
      torch.nan_to_num(torch.exp(expectation), posinf=float("inf")),
      t_vals[..., 0], t_vals[..., -1])
  rendering["acc"] = acc
  if semantic is not None:
    # detached weights: the semantic head must not shape density
    rendering["semantic"] = (weights.detach()[..., None]
                             * semantic).sum(dim=-2)
  return rendering


def cast_rays_multisample(t_vals, origins, directions, radii, base_x,
                          base_y, n: int = 7, m: int = 3,
                          std_scale: float = 0.35,
                          rand: Optional[torch.Tensor] = None):
  """zip-nerf hexagonal multisampling: n points per frustum section.

  t_vals: [..., S+1]; origins, directions, base_x, base_y: [..., 3];
  radii: [...]. rand: None (the deterministic eval pattern) or uniform
  [0, 1) draws [..., S, n] that rotate each point's angle by 2 pi rand.
  Returns (means [..., S, n, 3], stds [..., S, n]).
  """
  t0 = t_vals[..., :-1, None]
  t1 = t_vals[..., 1:, None]
  j = torch.arange(n, dtype=t_vals.dtype, device=t_vals.device)
  t = t0 + (t1 - t0) * (j + 0.5) / n
  deg = (2 * math.pi * m * j / n).expand(t.shape)
  if rand is not None:
    deg = deg + rand * math.pi * 2
  r = radii[..., None, None]
  means = torch.stack([
      r * t * torch.cos(deg) / 2,
      r * t * torch.sin(deg) / 2,
      t,
  ], dim=-1)
  stds = std_scale * r * t
  # basis columns [base_x | base_y | dir]: world = basis @ local per point
  basis = torch.stack([base_x, base_y, directions], dim=-1)
  means = torch.einsum("...snj,...ij->...sni", means, basis)
  return means + origins[..., None, None, :], stds
