"""Numerically-safe math helpers (counterpart of snerf_tpu/ops/math.py).

What the eval render paths and the mip trainer need: safe trig, safe
sqrt, mse -> psnr, `searchsorted`, `interp`, the inverse-CDF `bracket`,
the learning-rate schedule and gradient clipping.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def log_lerp(t, v0: float, v1: float) -> torch.Tensor:
  """Interpolate log-linearly from v0 (t=0) to v1 (t=1), t clamped to
  [0, 1]; float32, as the JAX version computes it."""
  if v0 <= 0 or v1 <= 0:
    raise ValueError(f"Interpolants {v0} and {v1} must be positive.")
  lv0, lv1 = math.log(v0), math.log(v1)
  t = torch.as_tensor(t, dtype=torch.float32)
  return torch.exp(torch.clamp(t, 0.0, 1.0) * (lv1 - lv0) + lv0)


def learning_rate_decay(step, lr_init: float, lr_final: float,
                        max_steps: int, lr_delay_steps: int = 0,
                        lr_delay_mult: float = 1.0) -> torch.Tensor:
  """Log-lerp decay with an optional warmup window (the reference
  schedule); a float32 scalar tensor."""
  step = torch.as_tensor(step, dtype=torch.float32)
  if lr_delay_steps > 0:
    delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
        0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
  else:
    delay_rate = 1.0
  return delay_rate * log_lerp(step / max_steps, lr_init, lr_final)


@torch.no_grad()
def clip_gradients(grads: Sequence[torch.Tensor],
                   max_val: Optional[float] = None,
                   max_norm: Optional[float] = None) -> None:
  """Value-clip and global-norm-clip a list of grads IN PLACE, after
  zeroing NaN and +-Inf (the JAX version returns new arrays; the trainer
  calls it only when clipping is on, as the JAX trainer does)."""
  for g in grads:
    torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
  if max_val is not None and max_val > 0:
    for g in grads:
      g.clamp_(-max_val, max_val)
  if max_norm is not None and max_norm > 0:
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    for g in grads:
      g.mul_(scale)


def searchsorted(a: torch.Tensor, v: torch.Tensor):
  """Indices (idx_lo, idx_hi) bracketing each v in sorted a, per batch row.

  a: [..., n] sorted; v: [..., m] (leading dims broadcast). idx = the
  number of a-entries <= v (a right searchsorted, as the JAX dense mask
  sum counts it), then idx_hi = clip(idx, 0, n-1) and idx_lo =
  clip(idx-1, 0, n-1). The JAX version counts with a dense [n, m] mask
  (no gathers, fast on a TPU); here a binary search, which the GPU has
  natively.
  """
  lead = torch.broadcast_shapes(a.shape[:-1], v.shape[:-1])
  a = a.expand(*lead, a.shape[-1]).contiguous()
  v = v.expand(*lead, v.shape[-1]).contiguous()
  idx = torch.searchsorted(a, v, right=True)
  n = a.shape[-1]
  return (idx - 1).clamp(0, n - 1), idx.clamp(0, n - 1)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
  """Batched linear interpolation over the last axis (jnp.interp per row).

  x: [..., m]; xp: [..., n] sorted; fp: [..., n]. Outside [xp[0], xp[-1]]
  the result clamps to the end values; a zero-width bracket takes fp_lo
  (the JAX nan_to_num(nan=0) of 0/0).
  """
  idx_lo, idx_hi = searchsorted(xp, x)
  lead = idx_lo.shape[:-1]
  xp = xp.expand(*lead, xp.shape[-1])
  fp = fp.expand(*lead, fp.shape[-1])
  xp_lo, xp_hi = torch.gather(xp, -1, idx_lo), torch.gather(xp, -1, idx_hi)
  fp_lo, fp_hi = torch.gather(fp, -1, idx_lo), torch.gather(fp, -1, idx_hi)
  t = torch.clamp(torch.nan_to_num((x - xp_lo) / (xp_hi - xp_lo), nan=0.0),
                  0, 1)
  return fp_lo + t * (fp_hi - fp_lo)


def sorted_interp(x, xp, fp):
  return interp(x, xp, fp)


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
  idx_lo, idx_hi = searchsorted(cdf, u)
  outs = []
  for arr in arrays:
    arr = arr.expand(*idx_lo.shape[:-1], arr.shape[-1])
    outs.append((torch.gather(arr, -1, idx_lo), torch.gather(arr, -1, idx_hi)))
  return outs
