"""S-NeRF mip model (counterpart of snerf_tpu/models/mipnerf.py
`MipNerfModel.__call__`): the deterministic eval forward and the
randomized training forward.

The JAX model draws its stratified jitter, resample positions and density
noise from a PRNG key; JAX and torch streams cannot agree, so here the
draws enter as a `MipDraws` (made by `make_draws` from a torch.Generator,
or injected, as the tests inject JAX's own). Not ported yet: the fn1 warp
(warp_fn=0), the appearance embedding and a bf16 compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from snerf_tpu_torch.models.mlp import NerfMLP, ProposalMLP, StackFn
from snerf_tpu_torch.ops import coord, mip, render, sampling
from snerf_tpu_torch.ops.fused_mlp import fused_mlp
from snerf_tpu_torch.ops.rays import Rays


@dataclasses.dataclass(frozen=True)
class MipNerfConfig:
  """Static model hyperparameters; the fields and defaults of the JAX
  MipNerfConfig that the eval and training forwards read."""
  num_samples: int = 128          # N_samples (coarse)
  num_fine: int = 128             # N_fine
  num_levels: int = 2
  resample_padding: float = 0.01
  stop_level_grad: bool = True
  use_viewdirs: bool = True
  lindisp: bool = False
  ray_shape: str = "cylinder"
  min_deg_point: int = 0
  max_deg_point: int = 16
  deg_view: int = 4
  density_noise: float = 1.0
  density_bias: float = -1.0
  rgb_padding: float = 0.001
  disable_integration: bool = False
  no_warp_sample: bool = True
  warp_fn: Optional[int] = 1      # 0 = fn1 (not ported), else fn2
  warp_radius: float = 3.0
  t_transform: str = "log"
  hidden_layer: int = 256
  rgb_layer: int = 1
  proposal_hidden_layer: int = 256
  semantic: bool = False
  semantic_class_num: int = 0
  ipe_method: str = "exact"

  def __post_init__(self):
    if not self.no_warp_sample and self.warp_fn == 0:
      raise NotImplementedError("warp_fn=0 (fn1) is not ported yet")

  @property
  def num_fine_intervals(self) -> int:
    """Intervals of every level after the first, as the JAX model counts
    them: the no-warp branch redraws num_samples + 1 points, the warp
    branch num_fine points, i.e. num_fine - 1 intervals."""
    return self.num_fine - 1 if not self.no_warp_sample else self.num_samples


@dataclasses.dataclass
class MipDraws:
  """The random draws of one randomized forward over a batch of rays.

  stratified: uniform [0, 1) [*batch, num_samples + 1], the first level's
    jitter (the JAX keys[0]);
  resample: uniform [0, 1) [*batch, num_fine_intervals + 1], the inverse-CDF
    positions of every later level (keys[1]; JAX scales its draw into
    each stratum, the port scales this one the same way);
  noise: per level, standard normals [*batch, intervals of the level]
    (keys[2] folded with the level), or None when density_noise is 0.
  """
  stratified: torch.Tensor
  resample: torch.Tensor
  noise: Optional[List[torch.Tensor]] = None


def make_draws(config: MipNerfConfig, batch_shape,
               generator: torch.Generator) -> MipDraws:
  """Draw a MipDraws from `generator`, on the generator's device (the
  model's)."""
  batch_shape = tuple(batch_shape)
  n_fine = config.num_fine_intervals
  kw = dict(generator=generator, device=generator.device)
  noise = None
  if config.density_noise > 0:
    noise = [torch.randn(*batch_shape, config.num_samples if i == 0
                         else n_fine, **kw)
             for i in range(config.num_levels)]
  return MipDraws(
      stratified=torch.rand(*batch_shape, config.num_samples + 1, **kw),
      resample=torch.rand(*batch_shape, n_fine + 1, **kw), noise=noise)


class MipNerfModel(nn.Module):
  """Two-level mip-NeRF with a density-only proposal level.

  stack_fn runs the uniform-width trunk layers of both MLPs; the default
  is the fused-MLP kernel. Passing `fused_mlp_plain` builds the same
  model with the plain PyTorch stack, which only a kernel check needs.
  """

  def __init__(self, config: MipNerfConfig, stack_fn: StackFn = fused_mlp,
               device="cuda"):
    super().__init__()
    c = self.config = config
    enc_features = 2 * 3 * (c.max_deg_point - c.min_deg_point)
    cond_features = 3 + 2 * 3 * c.deg_view if c.use_viewdirs else 0
    self.mlp = NerfMLP(
        enc_features, cond_features, net_width=c.hidden_layer,
        condition_depth=c.rgb_layer,
        num_semantic_channels=c.semantic_class_num if c.semantic else 0,
        stack_fn=stack_fn, device=device)
    self.proposal = ProposalMLP(
        enc_features, net_width=c.proposal_hidden_layer, stack_fn=stack_fn,
        device=device)

  def _encode_samples(self, s_or_t_vals, rays: Rays):
    """Cast rays to Gaussians (optionally warped) and IPE-encode them."""
    c = self.config
    t_vals = (s_or_t_vals if c.no_warp_sample else
              coord.s_to_t(s_or_t_vals, rays.near, rays.far, c.t_transform))
    means, covs = mip.cast_rays(t_vals, rays.origins, rays.directions,
                                rays.radii, c.ray_shape)
    if c.disable_integration:
      covs = torch.zeros_like(covs)
    if not c.no_warp_sample:
      means, covs = coord.warp_fn2_gaussian_diag(means, covs,
                                                 radius=c.warp_radius)
    return mip.integrated_pos_enc(means, covs, c.min_deg_point,
                                  c.max_deg_point, method=c.ipe_method)

  def forward(self, rays: Rays, white_bkgd: bool = False,
              draws: Optional[MipDraws] = None):
    """Render a ray batch. draws=None is the deterministic eval forward
    (the JAX rng=None); a MipDraws makes it the randomized training one.

    Returns a list of per-level dicts with keys
    rgb/distance/acc/semantic/s_vals/weights (coarse level: rgb=None).
    """
    c = self.config
    batch_shape = rays.origins.shape[:-1]
    randomized = draws is not None
    ret = []
    level_vals = weights = None
    for i_level in range(c.num_levels):
      if i_level == 0:
        s_vals = sampling.stratified_sample(
            batch_shape, c.num_samples, rays.device,
            rand=draws.stratified if randomized else None)
        if not c.no_warp_sample:
          level_vals = s_vals
        elif c.lindisp:
          level_vals = coord.s_to_t_disparity(s_vals, rays.near, rays.far)
        else:
          level_vals = coord.s_to_t_linear(s_vals, rays.near, rays.far)
      else:
        level_vals = sampling.resample_from_weights(
            level_vals, weights, c.num_fine_intervals,
            resample_padding=c.resample_padding,
            rand=draws.resample if randomized else None,
            stop_grad=c.stop_level_grad)

      samples_enc = self._encode_samples(level_vals, rays)

      raw_rgb = raw_semantic = None
      if i_level == 0:
        raw_density = self.proposal(samples_enc)
      else:
        condition = None
        if c.use_viewdirs:
          condition = mip.pos_enc(rays.viewdirs, min_deg=0,
                                  max_deg=c.deg_view, append_identity=True)
        raw_rgb, raw_density, raw_semantic = self.mlp(samples_enc, condition)

      raw_density = raw_density[..., 0]
      if randomized and c.density_noise > 0:
        raw_density = raw_density + c.density_noise * draws.noise[i_level]
      rgb = None
      if raw_rgb is not None:
        rgb = torch.sigmoid(raw_rgb) * (1 + 2 * c.rgb_padding) - c.rgb_padding
      density = F.softplus(raw_density + c.density_bias)

      if c.no_warp_sample:
        # level_vals are already metric t: composite directly.
        t_vals = level_vals
        w, _, _ = render.compute_alpha_weights(density, t_vals,
                                               rays.directions)
        t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
        acc = w.sum(dim=-1)
        distance = torch.clamp(
            torch.nan_to_num((w * t_mids).sum(dim=-1), posinf=float("inf")),
            t_vals[..., 0], t_vals[..., -1])
        comp_rgb = None
        if rgb is not None:
          comp_rgb = (w[..., None] * rgb).sum(dim=-2)
          if white_bkgd:
            comp_rgb = comp_rgb + (1.0 - acc[..., None])
        comp_sem = (None if raw_semantic is None
                    else (w[..., None] * raw_semantic).sum(dim=-2))
        out = dict(rgb=comp_rgb, distance=distance, acc=acc, weights=w,
                   semantic=comp_sem)
      else:
        out = render.volumetric_rendering(
            rgb, density, level_vals, rays.directions, rays.near, rays.far,
            semantic=raw_semantic, white_bkgd=white_bkgd,
            t_transform=c.t_transform)
      weights = out["weights"]
      out["s_vals"] = level_vals
      ret.append(out)
    return ret
