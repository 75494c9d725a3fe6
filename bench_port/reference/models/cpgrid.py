"""Integrated multiresolution CP-factor grid encoder (counterpart of
snerf_tpu/models/cpgrid.py).

Per level l and axis a, a factor table V_a^l [R_l, F]; a sample Gaussian
N(u, s^2) (grid units, per axis) reads the expected Gaussian-RBF
interpolation weights w_a = exp(-(u - i)^2 / (2 (sigma_b^2 + s_a^2)))
normalised over the nodes i, and the level's feature is the rank-F CP
product prod_a (w_a @ V_a^l). Both directions are [rows, R] x [R, F]
matmuls over the dense profile (cuBLAS; the JAX module runs them in XLA
outside any Pallas kernel), no gather and no scatter. In a bf16 compute
dtype the profile is built in float32 and cast, and both matmuls, the
products, the level window and the features are bf16, as the JAX
module's `compute_dtype` makes them.

The profile is [rows, R]: at a proposal MLP's 2,097,152 rows and R =
1,024 it is 8.6 GB an axis, so each level is encoded in chunks of rows
(`CHUNK_ELEMS` bounds rows x R) and is a checkpoint, as the JAX module's
`jax.checkpoint` per level: autograd keeps only the level's inputs, and
the backward recomputes each chunk's profiles under autograd and takes
that chunk's gradients before the next. Rows are independent, so the
chunks change no number beyond the matmuls' last bits.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

# rows x R of one chunk's profile: 128 MiB an axis in float32; the
# backward's recompute holds ~15 such tensors
CHUNK_ELEMS = 2 ** 25


def level_resolutions(num_levels: int, base_resolution: int,
                      max_resolution: int) -> List[int]:
  """Geometric resolution ladder from base to max resolution."""
  if num_levels <= 1:
    return [int(max_resolution)]
  g = (max_resolution / base_resolution) ** (1.0 / (num_levels - 1))
  return [int(round(base_resolution * g ** l)) for l in range(num_levels)]


def cosine_window(alpha: torch.Tensor, num: int) -> torch.Tensor:
  """BARF-style coarse-to-fine window over `num` bands: alpha (a float32
  scalar tensor) in [0, num]; band j gets 0.5 (1 - cos(pi clamp(alpha -
  j, 0, 1)))."""
  j = torch.arange(num, dtype=torch.float32, device=alpha.device)
  x = torch.clamp(alpha - j, 0.0, 1.0)
  return 0.5 * (1.0 - torch.cos(math.pi * x))


def anneal_alpha(train_frac: float, frac: float, num: int,
                 device=None) -> torch.Tensor:
  """clip(train_frac / frac, 0, 1) * num in float32, as the JAX model
  forms a window's alpha from its float32 train_frac."""
  t = torch.tensor(train_frac, dtype=torch.float32, device=device)
  return torch.clamp(t / frac, 0.0, 1.0) * num


def _bounded(v: torch.Tensor, bound: float) -> torch.Tensor:
  """The bounded factor table 1 + b tanh(v / b), or v when b <= 0."""
  if bound <= 0:
    return v
  return 1.0 + bound * torch.tanh(v / bound)


def level_encode_rows(u, var, v, p, r: int, bound: float,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """One level's integrated-CP features of rows u, var [M, n, 3] (grid
  coordinates and per-axis variances in grid^2 units): the mean over the
  n mixture components of prod_a (w_a @ V_a), with the pair products
  (w_a @ P_a) * (w_b @ P_b) appended when p [3, R, F2] is given. The JAX
  module's `_level_encode`, op for op: the profile w in float32, then
  w and the (bounded) tables cast to dtype for the matmuls, and the
  products in dtype."""
  iota = torch.arange(r, dtype=torch.float32, device=u.device)
  vb = [_bounded(v[a], bound).to(dtype) for a in range(3)]
  pb = (None if p is None
        else [_bounded(p[a], bound).to(dtype) for a in range(3)])
  acc = 0.0
  n = u.shape[-2]
  for k in range(n):
    f = 1.0
    pf = []
    for a in range(3):
      d = u[:, k, a, None] - iota                          # [M, R]
      w = torch.exp(-0.5 * d * d / var[:, k, a, None])
      w = (w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)).to(dtype)
      f = f * (w @ vb[a])                                  # [M, F]
      if pb is not None:
        pf.append(w @ pb[a])
    if pb is not None:
      f = torch.cat([f, pf[0] * pf[1], pf[1] * pf[2], pf[0] * pf[2]], dim=-1)
    acc = acc + f
  return acc / n


def _chunk_rows(r: int) -> int:
  return max(1, CHUNK_ELEMS // r)


class _LevelEncode(torch.autograd.Function):
  """`level_encode_rows` over chunks of rows, checkpointed: the forward
  keeps only its inputs; the backward recomputes one chunk at a time
  under autograd and takes its gradients."""

  @staticmethod
  def forward(ctx, u, var, v, p, r, bound, dtype):
    ctx.r, ctx.bound, ctx.dtype = r, bound, dtype
    ctx.save_for_backward(u, var, v, p)
    return _encode_chunked(u, var, v, p, r, bound, dtype)

  @staticmethod
  def backward(ctx, g):
    u, var, v, p = ctx.saved_tensors
    need = ctx.needs_input_grad[:4]
    du = torch.zeros_like(u) if need[0] else None
    dvar = torch.zeros_like(var) if need[1] else None
    dv = torch.zeros_like(v) if need[2] else None
    dp = torch.zeros_like(p) if p is not None and need[3] else None
    step = _chunk_rows(ctx.r)
    v_ = v.detach().requires_grad_(need[2])
    p_ = None if p is None else p.detach().requires_grad_(need[3])
    for s in range(0, u.shape[0], step):
      u_c = u[s:s + step].detach().requires_grad_(need[0])
      var_c = var[s:s + step].detach().requires_grad_(need[1])
      wrt = [t for t, want in ((u_c, need[0]), (var_c, need[1]), (v_, need[2]),
                               (p_, p is not None and need[3])) if want]
      with torch.enable_grad():
        f = level_encode_rows(u_c, var_c, v_, p_, ctx.r, ctx.bound,
                              ctx.dtype)
        grads = list(torch.autograd.grad(f, wrt, g[s:s + step]))
      if need[0]:
        du[s:s + step] = grads.pop(0)
      if need[1]:
        dvar[s:s + step] = grads.pop(0)
      if need[2]:
        dv += grads.pop(0)
      if dp is not None:
        dp += grads.pop(0)
    return du, dvar, dv, dp, None, None, None


def _encode_chunked(u, var, v, p, r, bound, dtype):
  step = _chunk_rows(r)
  with torch.no_grad():
    return torch.cat([level_encode_rows(u[s:s + step], var[s:s + step], v, p,
                                        r, bound, dtype)
                      for s in range(0, u.shape[0], step)], dim=0)


def level_encode(u, var, v, p, r: int, bound: float,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """`level_encode_rows` of u, var [M, n, 3] in dtype, chunked by rows
  and checkpointed when autograd needs it."""
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in (u, var, v, p)):
    return _LevelEncode.apply(u, var, v, p, r, bound, dtype)
  return _encode_chunked(u, var, v, p, r, bound, dtype)


class CPEncoding(nn.Module):
  """Multiresolution integrated CP encoding; owns the level tables
  `v{l}` [3, R_l, F] and, with pair_dim > 0, `p{l}` [3, R_l, pair_dim].

  x01 [..., n, 3] in [0, 1]^3 with stds std01 [..., n] (isotropic) or
  [..., n, 3] (per axis) -> features [..., L * (F + 3 pair_dim)].
  factor_bound > 0 reads each table as 1 + b tanh(v / b);
  feature_center subtracts 1 from each level's features and
  feature_scale multiplies them. The tables are drawn by
  `reset_parameters`, as the JAX module initialises them.
  """

  def __init__(self, num_levels: int = 4, level_dim: int = 16,
               base_resolution: int = 128, max_resolution: int = 1024,
               bump_width: float = 0.75, init_scale: float = 0.1,
               init_smooth: float = 0.0, pair_dim: int = 0,
               factor_bound: float = 0.0, feature_center: bool = False,
               feature_scale: float = 1.0, device="cuda"):
    super().__init__()
    self.resolutions = level_resolutions(num_levels, base_resolution,
                                         max_resolution)
    self.level_dim, self.pair_dim = level_dim, pair_dim
    self.bump_width, self.init_scale = bump_width, init_scale
    self.init_smooth, self.factor_bound = init_smooth, factor_bound
    self.feature_center, self.feature_scale = feature_center, feature_scale
    for l, r in enumerate(self.resolutions):
      setattr(self, f"v{l}", nn.Parameter(
          torch.empty(3, r, level_dim, device=device)))
      if pair_dim > 0:
        setattr(self, f"p{l}", nn.Parameter(
            torch.empty(3, r, pair_dim, device=device)))
    self.reset_parameters()

  @property
  def num_levels(self) -> int:
    return len(self.resolutions)

  @property
  def out_width(self) -> int:
    return self.num_levels * (self.level_dim + 3 * self.pair_dim)

  def tables(self, prefix: str) -> List[nn.Parameter]:
    """The level tables whose names start with prefix ("v" or "p")."""
    return [getattr(self, f"{prefix}{l}") for l in range(self.num_levels)
            if hasattr(self, f"{prefix}{l}")]

  @torch.no_grad()
  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every table as the JAX module does, on the CPU generator:
    init_scale N(0, 1) noise, blurred along R by a Gaussian of
    init_smooth cells (renormalised to unit std) when init_smooth > 0,
    plus 1 unless factor_bound > 0 (then the raw table is the noise)."""
    for t in self.tables("v") + self.tables("p"):
      noise = torch.randn(t.shape, dtype=torch.float32, generator=generator)
      if self.init_smooth > 0:
        noise = _blur_rows(noise, self.init_smooth)
      table = self.init_scale * noise
      if self.factor_bound <= 0:
        table = 1.0 + table
      t.copy_(table)

  def forward(self, x01: torch.Tensor, std01: torch.Tensor,
              level_window: Optional[torch.Tensor] = None,
              collapse: bool = False,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """collapse=True moment-matches the n multisamples into one per-axis
    Gaussian (mean of means; variance = mean within-sample variance +
    spread of the means) before encoding. dtype: the compute dtype of the
    matmuls and of the features returned."""
    if std01.dim() == x01.dim() - 1:
      std01 = std01[..., None].expand(x01.shape)
    if collapse and x01.shape[-2] > 1:
      m1 = x01.mean(dim=-2, keepdim=True)
      spread = ((x01 - m1) ** 2).mean(dim=-2, keepdim=True)
      var = (std01 ** 2).mean(dim=-2, keepdim=True) + spread
      x01 = m1
      std01 = torch.sqrt(var)
    lead, n = x01.shape[:-2], x01.shape[-2]
    outs = []
    for l, r in enumerate(self.resolutions):
      u = x01 * (r - 1.0)
      sig = std01 * (r - 1.0)
      var = sig * sig + self.bump_width ** 2
      p = getattr(self, f"p{l}") if self.pair_dim > 0 else None
      feat = level_encode(u.reshape(-1, n, 3), var.reshape(-1, n, 3),
                          getattr(self, f"v{l}"), p, r, self.factor_bound,
                          dtype)
      feat = feat.reshape(*lead, -1)
      if self.feature_center:
        feat = feat - 1.0
      if self.feature_scale != 1.0:
        feat = feat * self.feature_scale
      if level_window is not None:
        feat = feat * level_window[l].to(dtype)
      outs.append(feat)
    return torch.cat(outs, dim=-1)


def _blur_rows(noise: torch.Tensor, sigma: float) -> torch.Tensor:
  """Depthwise Gaussian blur of [3, R, F] along R (`jnp.convolve(...,
  mode="same")` of each column), renormalised to unit std."""
  rad = max(1, int(round(3 * sigma)))
  t = torch.arange(-rad, rad + 1, dtype=torch.float32)
  k = torch.exp(-0.5 * (t / sigma) ** 2)
  k = k / k.sum()
  three, r, feat = noise.shape
  cols = noise.permute(0, 2, 1).reshape(three * feat, 1, r)
  sm = F.conv1d(cols, k.flip(0)[None, None], padding=rad)
  sm = sm.reshape(three, feat, r).permute(0, 2, 1)
  return sm / (torch.std(sm, unbiased=False) + 1e-12)

