"""The S-NeRF mip loss set (counterpart of snerf_tpu/train/losses.py).

Masked means instead of boolean selects, as the JAX module: every loss
keeps static shapes. The zip losses (distortion, anti-aliased interlevel,
Charbonnier, the zip smoothness terms) wait for the zip trainer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from snerf_tpu_torch.ops import stepfun


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
