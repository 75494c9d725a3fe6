"""Numerically-safe math helpers (counterpart of snerf_tpu/ops/math.py).

Only what the eval render path needs: safe trig, safe sqrt, mse -> psnr
and the inverse-CDF `bracket`.
"""

from __future__ import annotations

import math

import torch

_TRIG_RANGE = 100 * math.pi


def safe_trig_helper(x: torch.Tensor, fn, t: float = _TRIG_RANGE):
  """Range-reduce |x| >= t before the trig call.

  The reduction is a floor-mod, as JAX's `x % t`: `torch.remainder`, not
  `torch.fmod`, which differs for negative x.
  """
  return fn(torch.where(x.abs() < t, x, torch.remainder(x, t)))


def safe_sin(x: torch.Tensor) -> torch.Tensor:
  return safe_trig_helper(x, torch.sin)


def safe_cos(x: torch.Tensor) -> torch.Tensor:
  return safe_trig_helper(x, torch.cos)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  return torch.sqrt(torch.clamp(x, min=eps))


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
  return -10.0 / math.log(10.0) * torch.log(mse)


def bracket(cdf: torch.Tensor, u: torch.Tensor, arrays):
  """For each u, the bracketing (lo, hi) values of MONOTONE arrays
  aligned with the sorted cdf.

  cdf: [..., n] sorted; u: [..., m]; arrays: sequence of [..., n]
  non-decreasing arrays (broadcastable to cdf). Returns
  [(lo [..., m], hi [..., m]), ...]. Requires cdf[..., 0] <= u <
  cdf[..., -1].

  The JAX version takes a dense [n, m] mask reduction (no gathers, fast
  on a TPU). Here a binary search plus gathers, which the GPU has
  natively. Under the precondition both give lo = arr[idx - 1] and
  hi = arr[idx] with idx = the number of cdf entries <= u, plateaus of
  a flat cdf included: the max of a non-decreasing array over a prefix
  is its last element, the min over the suffix its first.
  """
  cdf = cdf.contiguous()
  u = u.expand(*cdf.shape[:-1], u.shape[-1]).contiguous()
  idx = torch.searchsorted(cdf, u, right=True)
  n = cdf.shape[-1]
  idx_hi = idx.clamp(0, n - 1)
  idx_lo = (idx - 1).clamp(0, n - 1)
  outs = []
  for arr in arrays:
    arr = arr.expand(*u.shape[:-1], arr.shape[-1])
    outs.append((torch.gather(arr, -1, idx_lo), torch.gather(arr, -1, idx_hi)))
  return outs
