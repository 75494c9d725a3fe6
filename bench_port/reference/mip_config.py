"""The mip config adapters (the flag dataclass -> MipNerfConfig and the
mip TrainConfig, with the confidence modes), as the port builds them
from the same flags: a frozen copy of the port's config.py
`model_config`, `conf_modes` and `train_config`.
"""

from __future__ import annotations

from bench_port.reference.flags import Config
from bench_port.reference.models.mipnerf import MipNerfConfig
from bench_port.reference.train.trainer import TrainConfig

_T_TRANSFORM = {0: "log", 1: "disparity", 2: "linear"}


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
