"""Step functions (counterpart of snerf_tpu/ops/stepfun.py): the
resampling the zip eval render runs and the outer measure the mip
proposal loss needs.

The JAX samplers take a PRNG key. Here the random draw is injected:
`rand=None` is the deterministic branch (the JAX `key=None`); otherwise
`rand` holds the uniform [0, 1) draws of the documented shape. The sample
grids come from torch.linspace, which can differ from jnp.linspace in the
last ulp of a point. Of the losses only `lossfun_outer` is ported (the
mip trainer's proposal loss); the zip losses wait for the zip trainer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from snerf_tpu_torch.ops import math as smath

_F32_EPS = np.finfo(np.float32).eps


def _gather_last(x, idx):
  """x[..., idx] along the last axis, x broadcast to idx's batch dims
  (the JAX version's one-hot einsum `_gather_last`)."""
  return torch.gather(x.expand(*idx.shape[:-1], x.shape[-1]), -1, idx)


def query(tq, t, y, outside_value: float = 0.0):
  """Look up the step function (t, y) at locations tq."""
  idx_lo, idx_hi = smath.searchsorted(t, tq)
  yq = _gather_last(y, torch.clamp(idx_lo, max=y.shape[-1] - 1))
  return torch.where(idx_lo == idx_hi, torch.full_like(yq, outside_value),
                     yq)


def inner_outer(t0, t1, y1):
  """Inner and outer measures of the step function (t1, y1) on the
  intervals t0."""
  cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)],
                  dim=-1)
  idx_lo, idx_hi = smath.searchsorted(t1, t0)
  cy1_lo = _gather_last(cy1, idx_lo)
  cy1_hi = _gather_last(cy1, idx_hi)
  y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
  y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                         cy1_lo[..., 1:] - cy1_hi[..., :-1],
                         torch.zeros_like(y0_outer))
  return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env):
  """Proposal loss: penalize nerf weight exceeding the proposal envelope."""
  eps = torch.finfo(t.dtype).eps
  _, w_outer = inner_outer(t, t_env, w_env)
  return torch.clamp(w - w_outer, min=0) ** 2 / (w + eps)


def weight_to_pdf(t, w):
  return w / torch.clamp(t[..., 1:] - t[..., :-1], min=float(_F32_EPS))


def pdf_to_weight(t, p):
  return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation: float, domain=(-np.inf, np.inf)):
  """Dilate (max-pool) a non-negative step function by +-dilation.

  Builds the dense [..., 3S+1, S] interval mask of the JAX version.
  """
  t0 = t[..., :-1] - dilation
  t1 = t[..., 1:] + dilation
  t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
  t_dilate = torch.clamp(t_dilate, *domain)
  inside = ((t0[..., None, :] <= t_dilate[..., None])
            & (t1[..., None, :] > t_dilate[..., None]))
  w_dilate = torch.where(inside, w[..., None, :], 0).amax(dim=-1)[..., :-1]
  return t_dilate, w_dilate


def max_dilate_weights(t, w, dilation: float, domain=(-np.inf, np.inf),
                       renormalize: bool = False):
  p = weight_to_pdf(t, w)
  t_dilate, p_dilate = max_dilate(t, p, dilation, domain=domain)
  w_dilate = pdf_to_weight(t_dilate, p_dilate)
  if renormalize:
    w_dilate = w_dilate / torch.clamp(w_dilate.sum(dim=-1, keepdim=True),
                                      min=float(_F32_EPS))
  return t_dilate, w_dilate


def integrate_weights(w):
  """CDF endpoints of a weight vector summing to 1: starts 0, ends 1."""
  cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
  lead = cw.shape[:-1]
  return torch.cat([cw.new_zeros(*lead, 1), cw, cw.new_ones(*lead, 1)],
                   dim=-1)


def invert_cdf(u, t, w_logits):
  """Invert the CDF defined by (t, softmax(w_logits)) at points u in [0,1)."""
  cw = integrate_weights(torch.softmax(w_logits, dim=-1))
  return smath.sorted_interp(u, cw, t)


def sample(t, w_logits, num_samples: int, single_jitter: bool = False,
           deterministic_center: bool = False,
           rand: Optional[torch.Tensor] = None):
  """Piecewise-constant PDF point sampling.

  rand: None for the deterministic branch, else uniform [0, 1) draws
  [..., 1] (single_jitter) or [..., num_samples].
  """
  lead = t.shape[:-1]
  if rand is None:
    if deterministic_center:
      pad = 1 / (2 * num_samples)
      u = torch.linspace(pad, 1.0 - pad - _F32_EPS, num_samples,
                         device=t.device)
    else:
      u = torch.linspace(0, 1.0 - _F32_EPS, num_samples, device=t.device)
    u = u.expand(*lead, num_samples)
  else:
    want = (*lead, 1 if single_jitter else num_samples)
    if tuple(rand.shape) != want:
      raise ValueError(f"rand must be {want}, got {tuple(rand.shape)}")
    u_max = _F32_EPS + (1 - _F32_EPS) / num_samples
    max_jitter = (1 - u_max) / (num_samples - 1) - _F32_EPS
    u = (torch.linspace(0, 1 - u_max, num_samples, device=t.device)
         + rand * max_jitter)
  return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples: int,
                     single_jitter: bool = False, domain=(-np.inf, np.inf),
                     rand: Optional[torch.Tensor] = None):
  """Sample interval endpoints spanning midpoints of sampled centers."""
  if num_samples <= 1:
    raise ValueError(f"num_samples must be > 1, is {num_samples}.")
  centers = sample(t, w_logits, num_samples, single_jitter,
                   deterministic_center=True, rand=rand)
  mid = (centers[..., 1:] + centers[..., :-1]) / 2
  minval, maxval = domain
  first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
  last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
  return torch.cat([first, mid, last], dim=-1)
