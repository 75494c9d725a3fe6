"""zip-nerf model, the S-NeRF++ background (counterpart of
snerf_tpu/models/zipnerf.py `ZipNerfModel.__call__`): the deterministic
eval forward (JAX rng=None) and the randomized training forward.

The hash-grid encoder arm (`encoder_type = "hash"`, the reference's) is
ported; its MLPs run float32. Parameter names follow the reference torch
model (`{prop_mlp_i,nerf_mlp}.encoder.embeddings`, `.density_layer.0/.2`,
`.lin_second_stage_{i}`, `.rgb_layer`), the layout
snerf_tpu/utils/ref_import.py `map_zip_state_dict` decodes.

The training forward takes `train_frac` (the Schlick anneal of the
resampling logits) and its random draws as a `ZipDraws`, one entry per
level: the single-jitter interval sampling, the multisample rotations,
the density noise and the random background. JAX draws them from a PRNG
key, which torch cannot reproduce, so they come from a torch.Generator
(`make_zip_draws`) or are injected, as the tests inject JAX's own.
`stop_level_grad` detaches each level's intervals. The forward returns
the `ray_history` (sdist, tdist, weights, density) the losses read.

Not ported yet: the other encoder arms (ipe, cp, cp_hash, cp_tri,
mipcast), the GLO embedding, density and predicted normals, IDE and
reflections, roughness, and a bf16 compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from snerf_tpu_torch.models.hashgrid import EncodeFn, HashEncoding, hash_encode
from snerf_tpu_torch.ops import coord, mip, render, stepfun
from snerf_tpu_torch.ops.rays import Rays


@dataclasses.dataclass(frozen=True)
class ZipNerfConfig:
  """Static hyperparameters of the hash arm; the fields and defaults of the
  JAX ZipNerfConfig that its eval and training forwards read."""
  num_prop_samples: Tuple[int, ...] = (64, 64)
  num_nerf_samples: int = 32
  num_levels: int = 3
  bg_intensity_range: Tuple[float, float] = (1.0, 1.0)
  anneal_slope: float = 10.0
  stop_level_grad: bool = True
  single_jitter: bool = True
  use_viewdirs: bool = True
  raydist_fn: str = "power_transformation"
  power_lambda: float = -1.5
  dilation_multiplier: float = 0.5
  dilation_bias: float = 0.0025
  resample_padding: float = 0.0
  opaque_background: bool = True
  std_scale: float = 0.35
  sample_n: int = 7
  sample_m: int = 3
  bottleneck_width: int = 256
  net_depth_viewdirs: int = 2
  net_width_viewdirs: int = 256
  deg_view: int = 1
  density_bias: float = -1.0
  density_noise: float = 0.0
  rgb_padding: float = 0.001
  prop_grid_resolutions: Tuple[int, ...] = (512, 2048)
  prop_grid_level_dim: int = 1
  nerf_grid_resolution: int = 8192
  nerf_grid_level_dim: int = 4
  grid_base_resolution: int = 16
  grid_num_levels: int = 10
  grid_log2_hashmap_size: int = 21
  scene_scale: float = 1.0
  density_hidden_width: int = 64
  density_zero_init: bool = False
  use_semantic: bool = False
  class_num: int = 19
  # JAX fields whose other values select parts not ported yet; a config
  # that sets one raises instead of rendering without it.
  encoder_type: str = "hash"
  num_glo_features: int = 0
  disable_density_normals: bool = True
  enable_pred_normals: bool = False
  use_directional_enc: bool = False
  use_reflections: bool = False
  enable_pred_roughness: bool = False

  def __post_init__(self):
    if self.encoder_type != "hash":
      raise NotImplementedError(
          f"encoder_type {self.encoder_type!r} is not ported yet (hash is)")
    unported = [name for name, on in (
        ("num_glo_features > 0", self.num_glo_features > 0),
        ("density normals", not self.disable_density_normals),
        ("enable_pred_normals", self.enable_pred_normals),
        ("use_directional_enc", self.use_directional_enc),
        ("use_reflections", self.use_reflections),
        ("enable_pred_roughness", self.enable_pred_roughness)) if on]
    if unported:
      raise NotImplementedError(f"not ported yet: {', '.join(unported)}")

  def level_samples(self, i_level: int) -> int:
    """Intervals drawn at level i_level."""
    return (self.num_prop_samples[i_level] if i_level < self.num_levels - 1
            else self.num_nerf_samples)


@dataclasses.dataclass
class ZipDraws:
  """The random draws of one randomized forward, one tensor per level:

  jitter: uniform [0, 1) [*batch, 1] (single_jitter) or [*batch, S], the
    interval sampling's jitter (JAX keys[2 i]);
  rotation: uniform [0, 1) [*batch, S, sample_n], the multisample
    rotations, 2 pi each (keys[2 i + 1]);
  noise: standard normals [*batch, S] added to the raw density times
    density_noise (keys[2 i + 1]), or None when density_noise is 0;
  bg: uniform [0, 1) [*batch, 3], the background colour as a fraction of
    bg_intensity_range (keys[2 i]), or None when the range is one value.
  S is the level's interval count, `ZipNerfConfig.level_samples(i)`.
  """
  jitter: List[torch.Tensor]
  rotation: List[torch.Tensor]
  noise: Optional[List[torch.Tensor]] = None
  bg: Optional[List[torch.Tensor]] = None


def make_zip_draws(config: ZipNerfConfig, batch_shape,
                   generator: torch.Generator) -> ZipDraws:
  """Draw a ZipDraws from `generator`, on the generator's device (the
  model's)."""
  batch = tuple(batch_shape)
  kw = dict(generator=generator, device=generator.device)
  levels = [config.level_samples(i) for i in range(config.num_levels)]
  lo, hi = config.bg_intensity_range
  return ZipDraws(
      jitter=[torch.rand(*batch, 1 if config.single_jitter else s, **kw)
              for s in levels],
      rotation=[torch.rand(*batch, s, config.sample_n, **kw)
                for s in levels],
      noise=([torch.randn(*batch, s, **kw) for s in levels]
             if config.density_noise > 0 else None),
      bg=None if lo == hi else [torch.rand(*batch, 3, **kw) for _ in levels])


class ZipMLP(nn.Module):
  """Hash-grid density/rgb MLP with erf multisample downweighting."""

  def __init__(self, config: ZipNerfConfig, grid_resolution: int,
               grid_level_dim: int, disable_rgb: bool = False,
               encode_fn: EncodeFn = hash_encode, device="cuda"):
    super().__init__()
    c = self.config = config
    self.disable_rgb = disable_rgb
    self.encoder = HashEncoding(
        num_levels=c.grid_num_levels, level_dim=grid_level_dim,
        base_resolution=c.grid_base_resolution,
        desired_resolution=grid_resolution,
        log2_hashmap_size=c.grid_log2_hashmap_size, encode_fn=encode_fn,
        device=device)
    out_width = 1 if disable_rgb else c.bottleneck_width
    enc_width = c.grid_num_levels * grid_level_dim
    self.density_layer = nn.Sequential(
        nn.Linear(enc_width, c.density_hidden_width, device=device),
        nn.ReLU(),
        nn.Linear(c.density_hidden_width, out_width, device=device))
    if not disable_rgb:
      dir_width = 3 + 2 * 3 * c.deg_view if c.use_viewdirs else 0
      view_in = c.bottleneck_width + dir_width
      width = view_in
      for i in range(c.net_depth_viewdirs):
        setattr(self, f"lin_second_stage_{i}",
                nn.Linear(width, c.net_width_viewdirs, device=device))
        # skip-cat of the view-branch input after layer 0
        width = c.net_width_viewdirs + (view_in if i == 0 else 0)
      self.rgb_layer = nn.Linear(width, 3, device=device)

  def view_layers(self) -> List[nn.Linear]:
    return [getattr(self, f"lin_second_stage_{i}")
            for i in range(self.config.net_depth_viewdirs)]

  def predict_density(self, means, stds, noise=None):
    """means [..., n, 3], stds [..., n] -> (raw_density [...], x [..., W]).

    Contract -> [0,1]^3 -> hash features [..., n, L, C], erf-downweighted
    mean over the n multisamples. noise: standard normals [...] added to
    the raw density times density_noise, or None.
    """
    c = self.config
    z, new_std = coord.contract_mean_std(means * c.scene_scale,
                                         stds * c.scene_scale)
    # contract maps into [-2, 2]; normalize to [0, 1] for the grid
    x01 = (z / 2.0 + 1.0) / 2.0
    feats = self.encoder(x01)                                # [..., n, L, C]
    g = self.encoder.grid_sizes
    w = torch.erf(1.0 / torch.sqrt(
        8.0 * (new_std[..., None] * g / 2.0) ** 2 + 1e-20))
    feats = (feats * w[..., None]).mean(dim=-3)              # mean over n
    x = self.density_layer(feats.reshape(*feats.shape[:-2], -1))
    raw_density = x[..., 0]
    if noise is not None and c.density_noise > 0:
      raw_density = raw_density + c.density_noise * noise
    return raw_density, x

  def forward(self, means, stds, viewdirs: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None):
    """Returns dict(density [...], rgb [..., 3], semantic [..., K] or
    None) for multisampled Gaussians means [..., n, 3], stds [..., n];
    noise as in `predict_density`."""
    c = self.config
    raw_density, x = self.predict_density(means, stds, noise)
    density = F.softplus(raw_density + c.density_bias)
    if self.disable_rgb:
      return dict(density=density, rgb=density.new_zeros(*density.shape, 3),
                  semantic=None)
    semantic = None
    if c.use_semantic:
      semantic = torch.softmax(x[..., 1:1 + c.class_num], dim=-1)
    h = x
    if viewdirs is not None:
      dir_enc = mip.pos_enc(viewdirs, 0, c.deg_view, append_identity=True)
      dir_enc = dir_enc[..., None, :].expand(*x.shape[:-1],
                                             dir_enc.shape[-1])
      h = torch.cat([x, dir_enc], dim=-1)
    inputs = h
    for i, layer in enumerate(self.view_layers()):
      h = F.relu(layer(h))
      if i == 0:
        h = torch.cat([h, inputs], dim=-1)
    rgb = torch.sigmoid(self.rgb_layer(h))
    rgb = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding
    return dict(density=density, rgb=rgb, semantic=semantic)


class ZipNerfModel(nn.Module):
  """The 3-level proposal hierarchy: 2 proposal MLPs and the nerf MLP.

  encode_fn hash-encodes the positions of every MLP; the default is the
  fused encode (`hashgrid.hash_encode`). Passing `hashgrid.hash_encode_plain`
  builds the same model with the per-level plain encode, which only a
  kernel check needs.
  """

  def __init__(self, config: ZipNerfConfig, encode_fn: EncodeFn = hash_encode,
               device="cuda"):
    super().__init__()
    c = self.config = config
    for i in range(c.num_levels - 1):
      res = c.prop_grid_resolutions[min(i, len(c.prop_grid_resolutions) - 1)]
      setattr(self, f"prop_mlp_{i}", ZipMLP(
          c, res, c.prop_grid_level_dim, disable_rgb=True,
          encode_fn=encode_fn, device=device))
    self.nerf_mlp = ZipMLP(c, c.nerf_grid_resolution, c.nerf_grid_level_dim,
                           encode_fn=encode_fn, device=device)

  def mlps(self) -> List[ZipMLP]:
    return [getattr(self, f"prop_mlp_{i}")
            for i in range(self.config.num_levels - 1)] + [self.nerf_mlp]

  def forward(self, rays: Rays, draws: Optional[ZipDraws] = None,
              train_frac: float = 1.0):
    """Render a ray batch: deterministically (the JAX rng=None mode) when
    `draws` is None, else the randomized training forward with those
    draws. train_frac in [0, 1] sets the anneal of the resampling logits
    (1 at eval).

    rays: [..., 1] near/far. Returns (renderings, ray_history), one dict
    per level: renderings hold rgb/depth/acc (+ semantic on the last
    level), ray_history sdist/tdist/weights/density.
    """
    c = self.config
    if c.anneal_slope > 0:
      # Schlick bias; exactly 1 at train_frac = 1
      anneal = (c.anneal_slope * train_frac) / (
          (c.anneal_slope - 1) * train_frac + 1)
    else:
      anneal = 1.0
    _, s_to_t = coord.construct_ray_warps(c.raydist_fn, rays.near, rays.far,
                                          lam=c.power_lambda)
    init_s_near, init_s_far = 0.0, 1.0
    sdist = torch.cat([torch.full_like(rays.near, init_s_near),
                       torch.full_like(rays.far, init_s_far)], dim=-1)
    weights = torch.ones_like(rays.near)
    base_x, base_y = _ray_basis(rays.directions)
    prod_num_samples = 1
    renderings, ray_history = [], []
    for i_level, mlp in enumerate(self.mlps()):
      is_prop = i_level < c.num_levels - 1
      num_samples = c.level_samples(i_level)
      dilation = (c.dilation_bias + c.dilation_multiplier *
                  (init_s_far - init_s_near) / prod_num_samples)
      prod_num_samples *= num_samples
      if i_level > 0 and (c.dilation_bias > 0 or c.dilation_multiplier > 0):
        sdist, weights = stepfun.max_dilate_weights(
            sdist, weights, dilation, domain=(init_s_near, init_s_far),
            renormalize=True)
        sdist = sdist[..., 1:-1]
        weights = weights[..., 1:-1]
      logits_resample = torch.where(
          sdist[..., 1:] > sdist[..., :-1],
          anneal * torch.log(weights + c.resample_padding + 1e-30),
          -float("inf"))
      sdist = stepfun.sample_intervals(
          sdist, logits_resample, num_samples,
          single_jitter=c.single_jitter, domain=(init_s_near, init_s_far),
          rand=None if draws is None else draws.jitter[i_level])
      if c.stop_level_grad:
        sdist = sdist.detach()
      tdist = s_to_t(sdist)
      means, stds = render.cast_rays_multisample(
          tdist, rays.origins, rays.directions, rays.radii[..., 0], base_x,
          base_y, n=c.sample_n, m=c.sample_m, std_scale=c.std_scale,
          rand=None if draws is None else draws.rotation[i_level])
      ray_results = mlp(
          means, stds,
          viewdirs=rays.viewdirs if (c.use_viewdirs and not is_prop)
          else None,
          noise=None if draws is None or draws.noise is None
          else draws.noise[i_level])
      weights = render.compute_alpha_weights(
          ray_results["density"], tdist, rays.directions,
          opaque_background=c.opaque_background)[0]
      lo, hi = c.bg_intensity_range
      if lo == hi:
        bg_rgbs = lo
      elif draws is None:
        bg_rgbs = (lo + hi) / 2
      else:
        bg_rgbs = lo + draws.bg[i_level] * (hi - lo)
      renderings.append(render.volumetric_rendering_zip(
          ray_results["rgb"], weights, tdist, bg_rgbs, rays.far,
          semantic=ray_results["semantic"]))
      ray_history.append(dict(sdist=sdist, tdist=tdist, weights=weights,
                              density=ray_results["density"]))
    return renderings, ray_history


def _ray_basis(directions: torch.Tensor):
  """Orthonormal (base_x, base_y) frame perpendicular to each ray, the
  JAX module's Gram-Schmidt frame."""
  d = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
  up = torch.zeros_like(d)
  up[..., 2] = 1.0
  alt = torch.zeros_like(d)
  alt[..., 0] = 1.0
  ref = torch.where(torch.abs(d[..., 2:3]) < 0.99, up, alt)
  bx = torch.linalg.cross(ref, d, dim=-1)
  bx = bx / torch.clamp(torch.linalg.norm(bx, dim=-1, keepdim=True),
                        min=1e-8)
  by = torch.linalg.cross(d, bx, dim=-1)
  return bx, by
