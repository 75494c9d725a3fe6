"""The S-NeRF mip and zip loss sets (counterpart of
snerf_tpu/train/losses.py).

Masked means instead of boolean selects, as the JAX module: every loss
keeps static shapes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from bench_port.reference.ops import math as smath
from bench_port.reference.ops import stepfun

_F32_EPS = float(torch.finfo(torch.float32).eps)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None):
  """Mean over elements where mask is true (mask broadcast against x)."""
  if mask is None:
    return torch.mean(x)
  mask = mask.to(x.dtype).expand(x.shape)
  return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def rgb_loss(pred, target, mask=None):
  """MSE."""
  return masked_mean((pred - target) ** 2, mask)


def semantic_loss(logits, labels, mask=None, weight: float = 1.0):
  """Cross-entropy x weight; labels < 0 mark unlabeled pixels and are
  masked out."""
  labeled = labels >= 0
  mask = labeled if mask is None else (mask & labeled)
  safe_labels = torch.clamp(labels, min=0).long()
  ll = F.log_softmax(logits, dim=-1)
  nll = -torch.gather(ll, -1, safe_labels[..., None])[..., 0]
  return weight * masked_mean(nll, mask)


def depth_loss(pred, pred_coarse, target, mask=None,
               disparity: bool = False, coarse_mult: float = 0.1,
               conf_weight=None):
  """|d - d*| plus coarse_mult times the coarse level's, optionally in
  disparity space and weighted per ray; rays with target 0 (no depth)
  are masked out."""
  if disparity:
    def err(x):
      return torch.abs(1.0 / torch.clamp(x, min=1e-5)
                       - 1.0 / torch.clamp(target, min=1e-5))
  else:
    def err(x):
      return torch.abs(x - target)
  per_ray = err(pred) + coarse_mult * err(pred_coarse)
  if conf_weight is not None:
    per_ray = per_ray * conf_weight
  valid = target > 0
  mask = valid if mask is None else (mask & valid)
  return masked_mean(per_ray, mask)


def edge_aware_smooth_loss(rgb_patches, distance_patches, skymask=None,
                           weight: float = 1.0):
  """Edge-aware disparity smoothness over [P, ps, ps, C] patches:
  disparity 1 / clamp(distance), normalised by the patch mean, its
  gradients down-weighted by the image's; sky pixels count double."""
  disp = 1.0 / torch.clamp(distance_patches, min=1e-5)
  if disp.dim() == 3:
    disp = disp[..., None]
  mean_disp = disp.mean(dim=(1, 2), keepdim=True)
  disp = disp / (mean_disp + 1e-7)

  grad_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
  grad_y = torch.abs(disp[:, :-1] - disp[:, 1:])
  rgb_gx = torch.mean(torch.abs(rgb_patches[:, :, :-1] - rgb_patches[:, :, 1:]),
                      dim=3, keepdim=True)
  rgb_gy = torch.mean(torch.abs(rgb_patches[:, :-1] - rgb_patches[:, 1:]),
                      dim=3, keepdim=True)
  grad_x = grad_x * torch.exp(-rgb_gx)
  grad_y = grad_y * torch.exp(-rgb_gy)
  if skymask is not None:
    sky = skymask.to(grad_x.dtype)
    if sky.dim() == 3:
      sky = sky[..., None]
    grad_x = grad_x + sky[:, :, :-1] * grad_x
    grad_y = grad_y + sky[:, :-1] * grad_y
  return weight * (grad_x.mean() + grad_y.mean())


def proposal_loss(s_vals_f, weights_f, s_vals_c, weights_c,
                  weight: float = 1.0):
  """mip-360 interlevel bound: the fine weights must fit under the coarse
  envelope. The gradient flows to the coarse level only."""
  losses = stepfun.lossfun_outer(s_vals_f.detach(), weights_f.detach(),
                                 s_vals_c, weights_c)
  return weight * torch.mean(torch.sum(losses, dim=-1))


def distortion_loss(s_vals, weights, weight: float = 1.0):
  """mip-360 distortion, averaged over rays."""
  return weight * torch.mean(stepfun.lossfun_distortion(s_vals, weights))


def charbonnier_loss(pred, target, mask=None, padding: float = 0.001):
  """Charbonnier data loss sqrt(err^2 + padding^2), masked mean."""
  err = torch.sqrt((pred - target) ** 2 + padding ** 2)
  return masked_mean(err, mask)


def interlevel_loss_anti(s_prop, w_prop, s_nerf, w_nerf, blur_r: float,
                         weight: float = 1.0):
  """zip-nerf anti-aliased interlevel loss: blur the (detached) nerf
  histogram by r, integrate it over the proposal intervals, and penalise
  proposal under-coverage."""
  s_nerf, w_nerf = s_nerf.detach(), w_nerf.detach()
  w_norm = w_nerf / torch.clamp(s_nerf[..., 1:] - s_nerf[..., :-1],
                                min=_F32_EPS)
  xr, yr = stepfun.blur_stepfun(s_nerf, w_norm, blur_r)
  w_bound = _integrate_pwl(xr, yr, s_prop)
  losses = torch.clamp(w_bound - w_prop, min=0) ** 2 / (w_prop + _F32_EPS)
  return weight * torch.mean(torch.sum(losses, dim=-1))


def _integrate_pwl(x, y, t):
  """Integral of the piecewise-linear density (x, y) over each interval of
  t, from the exact quadratic antiderivative."""
  seg = 0.5 * (y[..., :-1] + y[..., 1:]) * (x[..., 1:] - x[..., :-1])
  acc = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)],
                  dim=-1)
  idx_lo, idx_hi = smath.searchsorted(x, t)
  lead = idx_lo.shape[:-1]

  def take(a, idx):
    return torch.gather(a.expand(*lead, a.shape[-1]), -1, idx)

  x0, x1 = take(x, idx_lo), take(x, idx_hi)
  y0, y1 = take(y, idx_lo), take(y, idx_hi)
  acc0 = take(acc, idx_lo)
  dx = torch.minimum(torch.clamp(t - x0, min=0.0),
                     torch.clamp(x1 - x0, min=0.0))
  slope = torch.where(x1 > x0, (y1 - y0) / torch.clamp(x1 - x0, min=1e-20),
                      torch.zeros_like(y0))
  acc_at_t = acc0 + y0 * dx + 0.5 * slope * dx ** 2
  return acc_at_t[..., 1:] - acc_at_t[..., :-1]


def _edge_aware_masked(rgb_patches, grad_x, grad_y, valid_mask=None):
  """Shared core of the zip patch smoothness losses: |grad| maps weighted
  by exp(-|grad rgb|), masked-meaned over the pairs whose both endpoints
  are valid."""
  rgb_gx = torch.mean(torch.abs(rgb_patches[:, :, :-1] - rgb_patches[:, :, 1:]),
                      dim=3, keepdim=True)
  rgb_gy = torch.mean(torch.abs(rgb_patches[:, :-1] - rgb_patches[:, 1:]),
                      dim=3, keepdim=True)
  sx = grad_x * torch.exp(-rgb_gx)
  sy = grad_y * torch.exp(-rgb_gy)
  if valid_mask is None:
    return sx.mean() + sy.mean()
  m = valid_mask.to(sx.dtype)
  mx = (m[:, :, :-1] * m[:, :, 1:])[..., None]
  my = (m[:, :-1] * m[:, 1:])[..., None]
  return masked_mean(sx, mx > 0) + masked_mean(sy, my > 0)


def zip_smooth_loss(rgb_patches, depth_patches, valid_mask=None,
                    weight: float = 1.0):
  """zip-nerf edge-aware inverse-depth patch smoothness: disparity
  1 / (depth + 1e-5) normalised by the patch mean, over [P, ps, ps]
  patches; masked pixels leave both gradient endpoints out."""
  disp = 1.0 / (depth_patches + 1e-5)
  if disp.dim() == 3:
    disp = disp[..., None]
  disp = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
  grad_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
  grad_y = torch.abs(disp[:, :-1] - disp[:, 1:])
  return weight * _edge_aware_masked(rgb_patches, grad_x, grad_y, valid_mask)


def zip_semantic_smooth_loss(rgb_patches, semantic_patches, valid_mask=None,
                             weight: float = 1.0):
  """zip-nerf edge-aware semantic patch smoothness: probabilities
  normalised by the patch mean, channel gradients summed to one map."""
  sem = semantic_patches / (semantic_patches.mean(dim=(1, 2), keepdim=True)
                            + 1e-5)
  grad_x = torch.sum(torch.abs(sem[:, :, :-1] - sem[:, :, 1:]), dim=-1,
                     keepdim=True)
  grad_y = torch.sum(torch.abs(sem[:, :-1] - sem[:, 1:]), dim=-1,
                     keepdim=True)
  return weight * _edge_aware_masked(rgb_patches, grad_x, grad_y, valid_mask)
