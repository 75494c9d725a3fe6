"""The zip config adapters (the flag dataclass -> ZipNerfConfig and
ZipTrainConfig), as the port builds them from the same flags."""

from __future__ import annotations

import torch

from bench_port.reference.flags import Config
from bench_port.reference.models.zipnerf import ZipNerfConfig
from bench_port.reference.train.zip_trainer import ZipTrainConfig

_BF16_NAMES = ("bfloat16", "bf16")


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
