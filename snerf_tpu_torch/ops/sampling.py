"""Ray sampling: stratified and hierarchical inverse-CDF (counterpart of
snerf_tpu/ops/sampling.py).

The JAX samplers take a PRNG key. Here the random draws are injected:
`rand=None` gives the deterministic eval branch (the JAX `key=None`);
otherwise `rand` holds uniform [0, 1) draws of the documented shape, so
a trainer and its tests can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from snerf_tpu_torch.ops import math as smath

_F32_EPS = float(np.finfo(np.float32).eps)


def stratified_sample(batch_shape, num_samples: int, device,
                      rand: Optional[torch.Tensor] = None):
  """Stratified samples of [0, 1]: [*batch, num_samples+1] sorted s values.

  rand: None, or uniform draws [*batch, num_samples+1].
  """
  s_vals = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
  if rand is None:
    return s_vals.expand(*batch_shape, num_samples + 1)
  mids = 0.5 * (s_vals[1:] + s_vals[:-1])
  upper = torch.cat([mids, s_vals[-1:]])
  lower = torch.cat([s_vals[:1], mids])
  return lower + (upper - lower) * rand


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int,
                                  rand: Optional[torch.Tensor] = None):
  """Inverse-CDF sampling from a piecewise-constant PDF over sorted bins.

  bins: [..., n_bins+1]; weights: [..., n_bins]; returns [..., num_samples].
  rand: None, or uniform [0, 1) draws [..., num_samples] (scaled into
  each stratum as the JAX `jax.random.uniform(maxval=1/n - eps)`).
  """
  eps = 1e-5
  weight_sum = torch.sum(weights, dim=-1, keepdim=True)
  padding = torch.clamp(eps - weight_sum, min=0)
  weights = weights + padding / weights.shape[-1]
  weight_sum = weight_sum + padding

  pdf = weights / weight_sum
  cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1)
  lead = cdf.shape[:-1]
  cdf = torch.cat([cdf.new_zeros(*lead, 1), cdf, cdf.new_ones(*lead, 1)],
                  dim=-1)

  if rand is not None:
    s = 1 / num_samples
    u = torch.arange(num_samples, device=cdf.device, dtype=cdf.dtype) * s
    u = u + rand * (s - _F32_EPS)
    u = torch.clamp(u, max=1.0 - _F32_EPS)
  else:
    u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, device=cdf.device)
    u = u.expand(*lead, num_samples)

  (bins_g0, bins_g1), (cdf_g0, cdf_g1) = smath.bracket(cdf, u, (bins, cdf))

  t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0),
                  0, 1)
  return bins_g0 + t * (bins_g1 - bins_g0)


def blur_weights(weights, resample_padding: float):
  """Max-blur + pad weights before hierarchical resampling (mip-NeRF)."""
  weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                          dim=-1)
  weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
  weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
  return weights_blur + resample_padding


def resample_from_weights(s_vals, weights, num_samples: int,
                          resample_padding: float = 0.01,
                          rand: Optional[torch.Tensor] = None,
                          stop_grad: bool = True):
  """Hierarchical resampling: blur coarse weights, draw fine s values.

  s_vals: [..., n+1] sorted; weights: [..., n]; returns [..., num_samples+1]
  sorted. rand: None, or uniform draws [..., num_samples+1]. stop_grad
  detaches the result (the JAX default).
  """
  w = blur_weights(weights, resample_padding)
  new_s = sorted_piecewise_constant_pdf(s_vals, w, num_samples + 1,
                                        rand=rand)
  return new_s.detach() if stop_grad else new_s
