"""Config adapters: the port's model and train configs from the flag
dataclass (`snerf_tpu_torch/flags.py`, the port's copy of
snerf_tpu/config.py's `Config` and parser), counterparts of the JAX
`Config.model_config()`, `train_config()`, `zip_model_config()` and
`zip_train_config()`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from snerf_tpu_torch.flags import Config, load_config  # noqa: F401 (re-export)
from snerf_tpu_torch.models.mipnerf import MipNerfConfig
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig

if TYPE_CHECKING:
  from snerf_tpu_torch.train.trainer import TrainConfig
  from snerf_tpu_torch.train.zip_trainer import ZipTrainConfig

_T_TRANSFORM = {0: "log", 1: "disparity", 2: "linear"}
# the values of --zip_compute_dtype that make the JAX adapter pick bf16
_BF16_NAMES = ("bfloat16", "bf16")


def model_config(cfg: Config) -> MipNerfConfig:
  """MipNerfConfig as `Config.model_config()` builds it (float32
  activations: no flag sets the mip model's compute dtype). Flags the
  port does not support yet raise."""
  if cfg.encode_appearance:
    raise NotImplementedError("encode_appearance is not ported yet")
  return MipNerfConfig(
      num_samples=cfg.N_samples, num_fine=cfg.N_fine,
      resample_padding=0.01, use_viewdirs=cfg.use_viewdirs,
      lindisp=cfg.lindisp, ray_shape=cfg.ray_shape,
      max_deg_point=cfg.max_degree, deg_view=cfg.multires_views,
      density_noise=cfg.density_noise,
      disable_integration=cfg.disable_integration,
      no_warp_sample=cfg.no_warp_sample, warp_fn=cfg.fn,
      warp_radius=cfg.radius, t_transform=_T_TRANSFORM[cfg.transform_idx],
      hidden_layer=cfg.hidden_layer, rgb_layer=cfg.rgb_layer,
      proposal_hidden_layer=cfg.proposal_hidden_layer,
      semantic=cfg.semantic, semantic_class_num=cfg.semantic_class_num)


def conf_modes(cfg: Config) -> tuple:
  """The confidence modes of the flags (`Config.conf_modes()`): rgb, ssim
  and depth, vgg with --vgg_loss (the seeded pyramid of
  models/features.py when no weights are given), flow with --flow."""
  modes = ["rgb", "ssim", "depth"]
  if cfg.vgg_loss:
    modes.append("vgg")
  if cfg.flow:
    modes.append("flow")
  return tuple(modes)


def train_config(cfg: Config) -> TrainConfig:
  """TrainConfig as `Config.train_config()` builds it, the depth
  confidence's fields included (its tau is --tau)."""
  # imported here, as Config.train_config does: the trainer sits above
  # this layer
  from snerf_tpu_torch.train.trainer import TrainConfig
  return TrainConfig(
      n_rgb=cfg.N_rgb, n_iters=cfg.N_iters, lrate=cfg.lrate,
      lrate_final=cfg.lrate_final, lrate_delay_steps=cfg.lrate_delay,
      single_image=cfg.single_image, white_bkgd=cfg.white_bkgd,
      randomized=cfg.randomized, depth_loss=cfg.depth_loss,
      depth_lambda=cfg.depth_lambda, disparity_depth=cfg.disparity_depth,
      coarse_depth_mult=cfg.coarse_loss_mult, smooth_loss=cfg.smooth_loss,
      smooth_lambda=cfg.smooth_lambda, n_patch=cfg.N_patch,
      patch_sz=cfg.patch_sz, proposal_loss=cfg.proposal_loss,
      proposal_lambda=cfg.proposal_lambda, semantic=cfg.semantic,
      semantic_lambda=cfg.semantic_lambda, pose_refine=cfg.pose_refine,
      grad_max_norm=cfg.grad_max_norm, depth_conf=cfg.depth_conf,
      conf_num=cfg.conf_num, conf_tau=cfg.tau, conf_modes=conf_modes(cfg),
      use_skymask_conf=cfg.skymask, ema_decay=cfg.ema_decay)


def zip_model_config(cfg: Config) -> ZipNerfConfig:
  """ZipNerfConfig as `Config.zip_model_config()` builds it (every
  zip_ipe_* and zip_cp_* flag), its compute dtype picked from
  `zip_compute_dtype` as JAX picks it: bfloat16 for "bfloat16" or "bf16"
  (the default), float32 for anything else. The eval and render paths
  run the MLPs in float32 whatever it says, as render.py and eval.py do
  (`zipnerf.float32_forward`, applied by `make_zip_eval_render_fn`).
  The cp_tri and mipcast encoders and a GLO embedding raise."""
  bf16 = cfg.zip_compute_dtype in _BF16_NAMES
  return ZipNerfConfig(
      compute_dtype=torch.bfloat16 if bf16 else torch.float32,
      num_prop_samples=tuple(cfg.zip_num_prop_samples),
      num_nerf_samples=cfg.zip_num_nerf_samples,
      num_levels=len(tuple(cfg.zip_num_prop_samples)) + 1,
      num_glo_features=cfg.zip_glo_features,
      encoder_type=cfg.zip_encoder,
      ipe_density_width=cfg.zip_ipe_density_width,
      ipe_density_depth=cfg.zip_ipe_density_depth,
      ipe_max_deg=cfg.zip_ipe_max_deg,
      ipe_anneal_frac=cfg.zip_ipe_anneal_frac,
      ipe_anisotropic=cfg.zip_ipe_anisotropic,
      cp_anisotropic=cfg.zip_cp_anisotropic,
      ipe_skip_layer=cfg.zip_ipe_skip_layer,
      density_hidden_width=cfg.zip_density_hidden_width,
      # None = the encoder-aware auto rule of Config.zip_model_config
      density_zero_init=(cfg.zip_encoder.startswith("cp")
                         if cfg.zip_density_zero_init is None
                         else bool(cfg.zip_density_zero_init)),
      scene_scale=cfg.zip_scene_scale,
      density_bias=cfg.zip_density_bias,
      cp_num_levels=cfg.zip_cp_num_levels,
      cp_level_dim=cfg.zip_cp_level_dim,
      cp_base_resolution=cfg.zip_cp_base_resolution,
      cp_max_resolution=cfg.zip_cp_max_resolution,
      cp_anneal_frac=cfg.zip_cp_anneal_frac,
      cp_collapse_multisamples=cfg.zip_cp_collapse,
      cp_pair_dim=cfg.zip_cp_pair_dim,
      cp_init_smooth=cfg.zip_cp_init_smooth,
      cp_factor_bound=cfg.zip_cp_factor_bound,
      cp_feature_center=cfg.zip_cp_feature_center,
      cp_feature_scale=cfg.zip_cp_feature_scale,
      cp_hash_resolution=cfg.zip_cp_hash_resolution,
      cp_hash_log2=cfg.zip_cp_hash_log2,
      cp_hash_num_levels=cfg.zip_cp_hash_num_levels,
      cp_hash_base_resolution=cfg.zip_cp_hash_base_resolution,
      cp_hash_per_sample=cfg.zip_cp_hash_per_sample,
      cp_hash_use_spread=cfg.zip_cp_hash_use_spread,
      cp_hash_dither=cfg.zip_cp_hash_dither,
      cp_hash_split=cfg.zip_cp_hash_split,
      cp_tri_resolution=cfg.zip_cp_tri_resolution,
      cp_tri_level_dim=cfg.zip_cp_tri_level_dim,
      sample_n=cfg.zip_sample_n,
      grid_num_levels=cfg.zip_grid_num_levels,
      grid_log2_hashmap_size=cfg.zip_log2_hashmap_size,
      bottleneck_width=cfg.zip_bottleneck_width,
      net_width_viewdirs=min(cfg.zip_bottleneck_width, 256),
      prop_grid_resolutions=tuple(cfg.zip_prop_grid_resolutions),
      nerf_grid_resolution=cfg.zip_nerf_grid_resolution,
      use_semantic=cfg.semantic, class_num=cfg.semantic_class_num)


def zip_train_config(cfg: Config) -> ZipTrainConfig:
  """ZipTrainConfig as `Config.zip_train_config()` builds it, with its
  encoder-aware lr rule: 0.01 is the hash-table schedule; for an encoder
  other than hash, flags left at their defaults become lr 0.002 -> 0.0002
  and encoder_lr_mult 4. The dtype the MLPs train in is the model
  config's (`zip_model_config`), as in JAX."""
  from snerf_tpu_torch.train.zip_trainer import ZipTrainConfig
  lr_init, lr_final = cfg.zip_lr_init, cfg.zip_lr_final
  enc_mult = cfg.zip_encoder_lr_mult
  if cfg.zip_encoder != "hash":
    if lr_init == Config.zip_lr_init:
      lr_init = 0.002
    if lr_final == Config.zip_lr_final:
      lr_final = 0.0002
    if enc_mult == Config.zip_encoder_lr_mult:
      enc_mult = 4.0
  return ZipTrainConfig(
      batch_size=cfg.zip_batch_size, max_steps=cfg.zip_max_steps,
      lr_init=lr_init, lr_final=lr_final, lr_delay_steps=cfg.zip_lr_delay,
      anti_interlevel_loss_mult=cfg.anti_interlevel_loss_mult,
      distortion_loss_mult=cfg.distortion_loss_mult,
      hash_decay_mult=cfg.hash_decay_mult,
      depth_loss_mult=cfg.zip_depth_loss_mult,
      depth_complete=(cfg.dataset_type == "waymo"),
      semantic_loss_mult=(cfg.zip_semantic_loss_mult if cfg.semantic
                          else 0.0),
      patch_size=cfg.zip_patch_size,
      smoothness_loss_mult=cfg.zip_smoothness_loss_mult,
      semantic_smoothness_loss_mult=cfg.zip_semantic_smoothness_loss_mult,
      encoder_lr_mult=enc_mult,
      encoder_level_lr_gamma=cfg.zip_encoder_level_lr_gamma,
      encoder_grad_max_norm=cfg.zip_encoder_grad_max_norm,
      ema_decay=cfg.zip_ema_decay, randomized=cfg.randomized)
