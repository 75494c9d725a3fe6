"""zip-nerf model, the S-NeRF++ background (counterpart of
snerf_tpu/models/zipnerf.py `ZipNerfModel.__call__`): the deterministic
eval forward (JAX rng=None) and the randomized training forward.

Encoder arms (`encoder_type`):
  hash     the reference's hash grid (`encoder.embeddings`) into a
           64-wide density layer. Parameter names follow the reference
           torch model (`{prop_mlp_i,nerf_mlp}.encoder.embeddings`,
           `.density_layer.0/.2`, `.lin_second_stage_{i}`, `.rgb_layer`),
           the layout snerf_tpu/utils/ref_import.py
           `map_zip_state_dict` decodes;
  ipe      the integrated positional encoding of the contracted
           Gaussians (n multisamples averaged, or with ipe_anisotropic one
           per-interval cylinder cast through the contraction's diagonal
           Jacobian) into the trunk `ipe_layers` + `density_hidden`;
  cp, cp_ipe, cp_hash
           the integrated CP grid (`cp_grid`, models/cpgrid.py), with the
           IPE appended (cp_ipe, cp_hash) and, on the nerf MLP of
           cp_hash, one fine hash level (`hash_fine`, the fused encode)
           queried once per interval (collapsed), per multisample, per
           group of multisamples (split) or at one random multisample
           (dither), erf-downweighted.
The trunk's runs of square layers go through K1 (`mlp._run_trunk`), and
under autograd the trunk with its density output layer is a checkpoint:
it keeps its input and recomputes its layers (one more K1 forward a run)
in the backward, where K1 would keep every layer's output (4.3 GB a
layer at a proposal MLP's 2,097,152 rows of the shipped cp_hash config).

The training forward takes `train_frac` (the Schlick anneal of the
resampling logits, and the coarse-to-fine windows of the ipe and cp
arms) and its random draws as a `ZipDraws`, one entry per level: the
single-jitter interval sampling, the multisample rotations, the density
noise and the random background, and the fine level's dither. JAX draws
them from a PRNG key, which torch cannot reproduce, so they come from a
torch.Generator (`make_zip_draws`) or are injected, as the tests inject
JAX's own. `stop_level_grad` detaches each level's intervals. The forward
returns the `ray_history` (sdist, tdist, weights, density) the losses
read.

Compute dtype (`ZipNerfConfig.compute_dtype`; the training path trains
bfloat16 as the JAX zip model does, eval and render run float32 through
`float32_forward`). Parameters stay float32; the layers listed run in
the compute dtype, each casting its input, weight and bias per call as
flax's `nn.Dense(dtype=...)` does. The casts sit where
`jax.make_jaxpr` of the JAX bf16 ZipMLP's `apply` (hash, ipe-aniso and
cp_hash-aniso-center arms) lists its `convert_element_type`s:
  * bf16: the hash arm's 64-wide `density_layer` input (the f32 encode),
    its hidden output and `x` (its output layer; JAX's `density_out`);
    the ipe and CP arms' trunk input (the f32 concat), every `ipe_layers`
    layer, `density_hidden` and `density_out`, so `x` and the raw
    density are bf16 and the density's softplus runs on bf16;
  * f32 at each skip-cat (the bf16 layer output joins the f32 trunk
    input, as jnp.concatenate promotes), bf16 again at the next layer;
  * the CP encode: each axis' float32 profile and its table cast to
    bf16, the matmuls, products, level window and features bf16
    (models/cpgrid.py); cp_hash's fine-level features (the f32 encode)
    cast to bf16, then the CP, IPE and fine parts concatenated in f32;
  * the view branch: `x` (bf16) joins the f32 direction encoding in f32,
    each view layer casts to bf16, its output rejoins the f32 branch
    input in f32; `rgb_layer` (JAX's `rgb_out`) is float32 on the f32
    cast of the last view layer's output;
  * the semantic softmax of bf16 logits (JAX sums its exponentials in
    f32); the noise (f32 normals) promotes the raw density to f32.
The encodes (the hash grid, the IPE, the CP profiles) stay float32.

Not ported yet: the cp_tri and mipcast arms, the GLO embedding, density
and predicted normals, IDE and reflections, roughness.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint

from snerf_tpu_torch.models.cpgrid import (CPEncoding, anneal_alpha,
                                           cosine_window)
from snerf_tpu_torch.models.hashgrid import EncodeFn, HashEncoding, hash_encode
from snerf_tpu_torch.models.mlp import DenseBlock, StackFn, _run_trunk, linear
from snerf_tpu_torch.ops import coord, mip, render, stepfun
from snerf_tpu_torch.ops.fused_mlp import fused_mlp
from snerf_tpu_torch.ops.rays import Rays

CP_ENCODERS = ("cp", "cp_ipe", "cp_hash")
ENCODERS = ("hash", "ipe") + CP_ENCODERS
CP_FEATURE_NORMS = ("none", "center", "layernorm")


@dataclasses.dataclass(frozen=True)
class ZipNerfConfig:
  """Static hyperparameters: the fields and defaults of the JAX
  ZipNerfConfig that the ported arms read (see that class for what each
  encoder knob does)."""
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
  # encoder arm: hash, ipe, cp, cp_ipe or cp_hash (cp_tri and mipcast
  # raise)
  encoder_type: str = "hash"
  scene_scale: float = 1.0
  ipe_max_deg: int = 12
  ipe_density_depth: int = 4
  ipe_density_width: int = 256
  ipe_anisotropic: bool = False
  cp_anisotropic: bool = False
  ipe_skip_layer: int = 0
  density_hidden_width: int = 64
  density_zero_init: bool = False
  ipe_anneal_frac: float = 0.0
  cp_anneal_frac: float = 0.0
  cp_num_levels: int = 4
  cp_level_dim: int = 16
  cp_base_resolution: int = 128
  cp_max_resolution: int = 1024
  cp_bump_width: float = 0.75
  cp_collapse_multisamples: bool = True
  cp_prop_num_levels: int = 3
  cp_prop_level_dim: int = 8
  cp_init_scale: float = 0.1
  cp_init_smooth: float = 0.0
  cp_factor_bound: float = 0.0
  cp_feature_center: bool = False
  cp_feature_scale: float = 1.0
  cp_pair_dim: int = 0
  cp_feature_norm: str = "none"    # none | center | layernorm
  cp_hash_resolution: int = 2048
  cp_hash_level_dim: int = 4
  cp_hash_log2: int = 19
  cp_hash_num_levels: int = 1
  cp_hash_base_resolution: int = 512   # only used when num_levels > 1
  cp_hash_per_sample: bool = False
  cp_hash_use_spread: bool = True
  cp_hash_dither: bool = False
  cp_hash_split: int = 0
  cp_tri_resolution: int = 2048
  cp_tri_level_dim: int = 4
  use_semantic: bool = False
  class_num: int = 19
  # the MLPs' activations (float32 or bfloat16); parameters stay float32
  compute_dtype: torch.dtype = torch.float32
  # JAX fields whose other values select parts not ported yet; a config
  # that sets one raises instead of rendering without it.
  num_glo_features: int = 0
  disable_density_normals: bool = True
  enable_pred_normals: bool = False
  use_directional_enc: bool = False
  use_reflections: bool = False
  enable_pred_roughness: bool = False

  def __post_init__(self):
    if self.encoder_type not in ENCODERS:
      raise NotImplementedError(
          f"encoder_type {self.encoder_type!r} is not ported yet (ported: "
          f"{', '.join(ENCODERS)})")
    if self.cp_feature_norm not in CP_FEATURE_NORMS:
      raise ValueError(f"cp_feature_norm {self.cp_feature_norm!r} not in "
                       f"{CP_FEATURE_NORMS}")
    if self.cp_feature_center and self.cp_feature_norm == "center":
      # both subtract the products' DC: the features would sit at -1
      raise ValueError("cp_feature_center and cp_feature_norm 'center' "
                       "together center the CP features twice")
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

  @property
  def aniso_cast(self) -> bool:
    """Whether each interval is one cylinder cast (mip.cast_rays) instead
    of sample_n multisamples."""
    return ((self.ipe_anisotropic and self.encoder_type == "ipe")
            or (self.cp_anisotropic and self.encoder_type in CP_ENCODERS))

  @property
  def fine_samples(self) -> int:
    """Gaussians per interval the MLPs see (1 under the cylinder cast)."""
    return 1 if self.aniso_cast else self.sample_n


@dataclasses.dataclass
class ZipDraws:
  """The random draws of one randomized forward, one tensor per level:

  jitter: uniform [0, 1) [*batch, 1] (single_jitter) or [*batch, S], the
    interval sampling's jitter (JAX keys[2 i]);
  rotation: uniform [0, 1) [*batch, S, sample_n], the multisample
    rotations, 2 pi each (keys[2 i + 1]), or None under the cylinder cast
    (`ZipNerfConfig.aniso_cast`), which has no multisamples;
  noise: standard normals [*batch, S] added to the raw density times
    density_noise (keys[2 i + 1]), or None when density_noise is 0;
  bg: uniform [0, 1) [*batch, 3], the background colour as a fraction of
    bg_intensity_range (keys[2 i]), or None when the range is one value;
  dither: the nerf level's alone, int64 in [0, fine_samples) [*batch, S],
    the multisample the fine hash level queries (fold_in(keys[2 i + 1],
    7)), or None unless cp_hash_dither selects it.
  S is the level's interval count, `ZipNerfConfig.level_samples(i)`.
  """
  jitter: List[torch.Tensor]
  rotation: Optional[List[torch.Tensor]] = None
  noise: Optional[List[torch.Tensor]] = None
  bg: Optional[List[torch.Tensor]] = None
  dither: Optional[torch.Tensor] = None


def _dithers(config: ZipNerfConfig) -> bool:
  """Whether the nerf MLP's fine level queries a random multisample."""
  return (config.encoder_type == "cp_hash" and config.cp_hash_dither
          and not config.cp_hash_per_sample and config.cp_hash_split <= 1)


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
      rotation=(None if config.aniso_cast else
                [torch.rand(*batch, s, config.sample_n, **kw)
                 for s in levels]),
      noise=([torch.randn(*batch, s, **kw) for s in levels]
             if config.density_noise > 0 else None),
      bg=None if lo == hi else [torch.rand(*batch, 3, **kw) for _ in levels],
      dither=(torch.randint(0, config.fine_samples, (*batch, levels[-1]),
                            **kw) if _dithers(config) else None))


def _fine_level_weights(var, g):
  """erf(1 / sqrt(8 var g^2)) of the fine hash level: var [...] in
  [0, 1]^3 units, g [L] the level's grid sizes -> [..., L]."""
  return torch.erf(1.0 / torch.sqrt(8.0 * var[..., None] * (g ** 2) + 1e-20))


class ZipMLP(nn.Module):
  """Density/rgb MLP of one level: an encoder arm, the density layers and,
  on the nerf MLP, the view-dependent rgb branch and the semantic head."""

  def __init__(self, config: ZipNerfConfig, grid_resolution: int,
               grid_level_dim: int, disable_rgb: bool = False,
               encode_fn: EncodeFn = hash_encode,
               stack_fn: StackFn = fused_mlp, device="cuda"):
    super().__init__()
    c = self.config = config
    self.disable_rgb = disable_rgb
    self.stack_fn = stack_fn
    # read at every forward: `float32_forward` sets it for eval
    self.compute_dtype = c.compute_dtype
    out_width = 1 if disable_rgb else c.bottleneck_width
    if c.encoder_type == "hash":
      self.encoder = HashEncoding(
          num_levels=c.grid_num_levels, level_dim=grid_level_dim,
          base_resolution=c.grid_base_resolution,
          desired_resolution=grid_resolution,
          log2_hashmap_size=c.grid_log2_hashmap_size, encode_fn=encode_fn,
          device=device)
      enc_width = c.grid_num_levels * grid_level_dim
      self.density_layer = nn.Sequential(
          nn.Linear(enc_width, c.density_hidden_width, device=device),
          nn.ReLU(),
          nn.Linear(c.density_hidden_width, out_width, device=device))
    else:
      enc_width = 6 * c.ipe_max_deg if c.encoder_type != "cp" else 0
      if c.encoder_type in CP_ENCODERS:
        self.cp_grid = CPEncoding(
            num_levels=c.cp_prop_num_levels if disable_rgb
            else c.cp_num_levels,
            level_dim=c.cp_prop_level_dim if disable_rgb else c.cp_level_dim,
            base_resolution=min(c.cp_base_resolution, grid_resolution),
            max_resolution=min(c.cp_max_resolution, grid_resolution),
            bump_width=c.cp_bump_width, init_scale=c.cp_init_scale,
            init_smooth=c.cp_init_smooth,
            pair_dim=0 if disable_rgb else c.cp_pair_dim,
            factor_bound=c.cp_factor_bound,
            feature_center=c.cp_feature_center,
            feature_scale=c.cp_feature_scale, device=device)
        enc_width += self.cp_grid.out_width
      if c.encoder_type == "cp_hash" and not disable_rgb:
        self.hash_fine = HashEncoding(
            num_levels=c.cp_hash_num_levels, level_dim=c.cp_hash_level_dim,
            base_resolution=(c.cp_hash_base_resolution
                             if c.cp_hash_num_levels > 1
                             else c.cp_hash_resolution),
            desired_resolution=c.cp_hash_resolution,
            log2_hashmap_size=c.cp_hash_log2, encode_fn=encode_fn,
            device=device)
        enc_width += c.cp_hash_num_levels * c.cp_hash_level_dim
      # the trunk input is concatenated after layer i for i > 0 and
      # i % ipe_skip_layer == 0
      skip = c.ipe_skip_layer
      self.skip_after = tuple(i for i in range(c.ipe_density_depth)
                              if skip > 0 and i > 0 and i % skip == 0)
      layers, width = [], enc_width
      for i in range(c.ipe_density_depth):
        layers.append(DenseBlock(width, c.ipe_density_width, device))
        width = c.ipe_density_width + (enc_width if i in self.skip_after
                                       else 0)
      self.ipe_layers = nn.ModuleList(layers)
      self.density_hidden = DenseBlock(width, c.density_hidden_width, device)
      self.density_out = nn.Linear(c.density_hidden_width, out_width,
                                   device=device)
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

  def _trunk(self, h):
    """ipe_layers (+ skip-cats), density_hidden and density_out in the
    compute dtype, each maximal run of square layers one K1 call."""
    dt = self.compute_dtype
    h = _run_trunk([*self.ipe_layers, self.density_hidden], h, self.stack_fn,
                   self.skip_after, dt)
    return linear(self.density_out, h, dt)

  def _ipe(self, z, var, train_frac):
    """Annealable IPE of Gaussians z, var [..., 3] (diagonal variances)."""
    c = self.config
    enc = mip.integrated_pos_enc(z, var, 0, c.ipe_max_deg)
    if c.ipe_anneal_frac > 0:
      # enc is laid out [deg0 xyz, deg1 xyz, ... | the same for cos]
      win = cosine_window(anneal_alpha(train_frac, c.ipe_anneal_frac,
                                       c.ipe_max_deg, z.device),
                          c.ipe_max_deg)
      enc = enc * torch.repeat_interleave(win, 3).repeat(2)
    return enc

  def _fine_features(self, x01, std01_s, dither):
    """The fine hash level(s) of cp_hash: [..., L C]."""
    c = self.config
    g = self.hash_fine.grid_sizes
    if c.cp_hash_per_sample:
      hfeat = self.hash_fine(x01)                            # [..., n, L, C]
      w = torch.erf(1.0 / torch.sqrt(
          8.0 * (std01_s[..., None] * g) ** 2 + 1e-20))
      hfeat = (hfeat * w[..., None]).mean(dim=-3)
    elif c.cp_hash_split > 1:
      n = x01.shape[-2]
      k = min(c.cp_hash_split, n)
      gid = (torch.arange(n, device=x01.device) * k) // n
      grp = gid[None, :] == torch.arange(k, device=x01.device)[:, None]
      wts = grp.to(x01.dtype) / grp.sum(-1, keepdim=True)   # [k, n]
      gm = torch.einsum("kn,...nd->...kd", wts, x01)
      gv = torch.einsum("kn,...n->...k", wts, std01_s ** 2)
      if c.cp_hash_use_spread:
        back = torch.einsum("nk,...kd->...nd", grp.t().to(x01.dtype), gm)
        gv = gv + torch.einsum("kn,...n->...k", wts,
                               ((x01 - back) ** 2).mean(dim=-1))
      hfeat = self.hash_fine(gm)                             # [..., k, L, C]
      hfeat = (hfeat * _fine_level_weights(gv, g)[..., None]).mean(dim=-3)
    else:
      m1 = x01.mean(dim=-2, keepdim=True)                    # [..., 1, 3]
      var1 = (std01_s ** 2).mean(dim=-1)
      if c.cp_hash_use_spread:
        var1 = var1 + ((x01 - m1) ** 2).mean(dim=(-2, -1))
      if dither is not None:
        idx = dither[..., None, None].expand(*x01.shape[:-2], 1, 3)
        m1 = torch.take_along_dim(x01, idx, dim=-2)
      hfeat = self.hash_fine(m1)[..., 0, :, :]               # [..., L, C]
      hfeat = hfeat * _fine_level_weights(var1, g)[..., None]
    return hfeat.reshape(*hfeat.shape[:-2], -1)

  def _encode(self, means, stds, train_frac, dither):
    """The trunk input of the ipe and cp arms."""
    c = self.config
    s = c.scene_scale
    if c.aniso_cast:
      # stds carries the per-interval diagonal covariance [..., S, 3] of
      # the cylinder cast, propagated through the contraction
      z3, var3 = coord.warp_fn2_gaussian_diag(means * s, stds * (s * s),
                                              radius=1.0)
      if c.encoder_type == "ipe":
        return self._ipe(z3, var3, train_frac)
      z, var3 = z3[..., None, :], var3[..., None, :]       # n = 1
      new_std = torch.sqrt(var3.mean(dim=-1))               # isotropic equiv.
    else:
      var3 = None
      z, new_std = coord.contract_mean_std(means * s, stds * s)
    if c.encoder_type == "ipe":
      var = (new_std ** 2)[..., None].expand(z.shape)
      return self._ipe(z, var, train_frac).mean(dim=-2)
    x01 = (z / 2.0 + 1.0) / 2.0
    # per-axis stds for the CP profiles under the cylinder cast; the fine
    # level's erf uses the isotropic equivalent
    std01 = torch.sqrt(var3) / 4.0 if var3 is not None else new_std / 4.0
    std01_s = new_std / 4.0
    window = None
    if c.cp_anneal_frac > 0:
      nl = self.cp_grid.num_levels
      window = cosine_window(anneal_alpha(train_frac, c.cp_anneal_frac, nl,
                                          z.device), nl)
    feats = self.cp_grid(x01, std01, level_window=window,
                         collapse=c.cp_collapse_multisamples,
                         dtype=self.compute_dtype)
    if c.cp_feature_norm == "center":
      feats = feats - 1.0
    elif c.cp_feature_norm == "layernorm":
      mu = feats.mean(dim=-1, keepdim=True)
      var = ((feats - mu) ** 2).mean(dim=-1, keepdim=True)
      feats = (feats - mu) * torch.rsqrt(var + 1e-6)
    parts = [feats]
    if c.encoder_type != "cp":
      var = (var3 if var3 is not None
             else (new_std ** 2)[..., None].expand(z.shape))
      parts.append(self._ipe(z, var, train_frac).mean(dim=-2))
    if hasattr(self, "hash_fine"):
      parts.append(self._fine_features(x01, std01_s, dither).to(feats.dtype))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

  def predict_density(self, means, stds, noise=None, train_frac: float = 1.0,
                      dither=None):
    """means [..., n, 3], stds [..., n] (multisamples) or, under the
    cylinder cast, means [..., 3] and diagonal covariances stds [..., 3]
    -> (raw_density [...], x [..., W]).

    noise: standard normals [...] added to the raw density times
    density_noise, or None. train_frac opens the coarse-to-fine windows;
    dither: the multisample each interval's fine level queries, or None.
    """
    c = self.config
    if c.encoder_type == "hash":
      z, new_std = coord.contract_mean_std(means * c.scene_scale,
                                           stds * c.scene_scale)
      # contract maps into [-2, 2]; normalize to [0, 1] for the grid
      x01 = (z / 2.0 + 1.0) / 2.0
      feats = self.encoder(x01)                              # [..., n, L, C]
      g = self.encoder.grid_sizes
      w = torch.erf(1.0 / torch.sqrt(
          8.0 * (new_std[..., None] * g / 2.0) ** 2 + 1e-20))
      feats = (feats * w[..., None]).mean(dim=-3)            # mean over n
      dt = self.compute_dtype
      hidden, _, out = self.density_layer
      h = F.relu(linear(hidden, feats.reshape(*feats.shape[:-2], -1), dt))
      x = linear(out, h, dt)
    else:
      h = self._encode(means, stds, train_frac, dither)
      if torch.is_grad_enabled():
        x = checkpoint.checkpoint(self._trunk, h, use_reentrant=False,
                                  preserve_rng_state=False)
      else:
        x = self._trunk(h)
    raw_density = x[..., 0]
    if noise is not None and c.density_noise > 0:
      raw_density = raw_density + c.density_noise * noise
    return raw_density, x

  def forward(self, means, stds, viewdirs: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, train_frac: float = 1.0,
              dither: Optional[torch.Tensor] = None):
    """Returns dict(density [...], rgb [..., 3], semantic [..., K] or
    None) for the Gaussians means, stds; the rest as in
    `predict_density`."""
    c = self.config
    raw_density, x = self.predict_density(means, stds, noise, train_frac,
                                          dither)
    density = F.softplus(raw_density + c.density_bias)
    if self.disable_rgb:
      return dict(density=density,
                  rgb=torch.zeros(*density.shape, 3, device=density.device),
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
      h = F.relu(linear(layer, h, self.compute_dtype))
      if i == 0:
        h = torch.cat([h, inputs], dim=-1)
    rgb = torch.sigmoid(self.rgb_layer(h.float()))
    rgb = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding
    return dict(density=density, rgb=rgb, semantic=semantic)


class ZipNerfModel(nn.Module):
  """The 3-level proposal hierarchy: 2 proposal MLPs and the nerf MLP.

  encode_fn hash-encodes the positions of every hash table (the hash
  arm's encoders, cp_hash's fine level); the default is the fused encode
  (`hashgrid.hash_encode`). Passing `hashgrid.hash_encode_plain` builds
  the same model with the per-level plain encode, which only a kernel
  check needs; stack_fn runs the trunks' square runs (K1 by default,
  `fused_mlp_plain` for such a check), as in MipNerfModel.
  """

  def __init__(self, config: ZipNerfConfig, encode_fn: EncodeFn = hash_encode,
               stack_fn: StackFn = fused_mlp, device="cuda"):
    super().__init__()
    c = self.config = config
    for i in range(c.num_levels - 1):
      res = c.prop_grid_resolutions[min(i, len(c.prop_grid_resolutions) - 1)]
      setattr(self, f"prop_mlp_{i}", ZipMLP(
          c, res, c.prop_grid_level_dim, disable_rgb=True,
          encode_fn=encode_fn, stack_fn=stack_fn, device=device))
    self.nerf_mlp = ZipMLP(c, c.nerf_grid_resolution, c.nerf_grid_level_dim,
                           encode_fn=encode_fn, stack_fn=stack_fn,
                           device=device)

  def mlps(self) -> List[ZipMLP]:
    return [getattr(self, f"prop_mlp_{i}")
            for i in range(self.config.num_levels - 1)] + [self.nerf_mlp]

  def forward(self, rays: Rays, draws: Optional[ZipDraws] = None,
              train_frac: float = 1.0):
    """Render a ray batch: deterministically (the JAX rng=None mode) when
    `draws` is None, else the randomized training forward with those
    draws. train_frac in [0, 1] sets the anneal of the resampling logits
    and the coarse-to-fine windows (1 at eval).

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
      if c.aniso_cast:
        means, stds = mip.cast_rays(tdist, rays.origins, rays.directions,
                                    rays.radii, "cylinder")
      else:
        means, stds = render.cast_rays_multisample(
            tdist, rays.origins, rays.directions, rays.radii[..., 0], base_x,
            base_y, n=c.sample_n, m=c.sample_m, std_scale=c.std_scale,
            rand=None if draws is None else draws.rotation[i_level])
      ray_results = mlp(
          means, stds,
          viewdirs=rays.viewdirs if (c.use_viewdirs and not is_prop)
          else None,
          noise=None if draws is None or draws.noise is None
          else draws.noise[i_level],
          train_frac=train_frac,
          dither=None if draws is None or is_prop else draws.dither)
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


@contextlib.contextmanager
def float32_forward(model: ZipNerfModel):
  """Run the model's MLPs in float32 inside the block, whatever their
  compute dtype, on the same parameters: the eval and render paths' twin
  of a bf16 training model (JAX builds it with `dataclasses.replace(
  config, compute_dtype=float32)`: train.py's test-view render, eval.py,
  render.py)."""
  mlps = model.mlps()
  dtypes = [m.compute_dtype for m in mlps]
  for m in mlps:
    m.compute_dtype = torch.float32
  try:
    yield model
  finally:
    for m, dt in zip(mlps, dtypes):
      m.compute_dtype = dt


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
