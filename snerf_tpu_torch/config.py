"""Config adapters: the port's model configs from the shared flag
dataclass.

`snerf_tpu.config.Config` is plain Python and imports no JAX, so the port
reuses it. Its own `Config.model_config()`, `Config.train_config()` and
`Config.zip_model_config()` import jax, hence these counterparts.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from snerf_tpu.config import Config, load_config  # noqa: F401 (re-export)
from snerf_tpu_torch.models.mipnerf import MipNerfConfig
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig

if TYPE_CHECKING:
  from snerf_tpu_torch.train.trainer import TrainConfig

_T_TRANSFORM = {0: "log", 1: "disparity", 2: "linear"}


def model_config(cfg: Config) -> MipNerfConfig:
  """MipNerfConfig as `Config.model_config()` builds it (float32
  activations). Flags the port does not support yet raise."""
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


def train_config(cfg: Config) -> TrainConfig:
  """TrainConfig as `Config.train_config()` builds it. The depth
  confidence (--depth_conf: the confidence model and its VGG precompute)
  is not ported yet and raises."""
  if cfg.depth_conf:
    raise NotImplementedError("depth_conf (the depth confidence model) is "
                              "not ported yet; pass --depth_conf False")
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
      grad_max_norm=cfg.grad_max_norm, ema_decay=cfg.ema_decay)


def zip_model_config(cfg: Config) -> ZipNerfConfig:
  """ZipNerfConfig for the eval path, as `Config.zip_model_config()`
  builds it, with float32 activations (render.py forces them for eval).
  An encoder other than hash or a GLO embedding raises."""
  return ZipNerfConfig(
      num_prop_samples=tuple(cfg.zip_num_prop_samples),
      num_nerf_samples=cfg.zip_num_nerf_samples,
      num_levels=len(tuple(cfg.zip_num_prop_samples)) + 1,
      num_glo_features=cfg.zip_glo_features,
      encoder_type=cfg.zip_encoder,
      density_hidden_width=cfg.zip_density_hidden_width,
      # None = the encoder-aware auto rule of Config.zip_model_config
      density_zero_init=(cfg.zip_encoder.startswith("cp")
                         if cfg.zip_density_zero_init is None
                         else bool(cfg.zip_density_zero_init)),
      scene_scale=cfg.zip_scene_scale,
      density_bias=cfg.zip_density_bias,
      sample_n=cfg.zip_sample_n,
      grid_num_levels=cfg.zip_grid_num_levels,
      grid_log2_hashmap_size=cfg.zip_log2_hashmap_size,
      bottleneck_width=cfg.zip_bottleneck_width,
      net_width_viewdirs=min(cfg.zip_bottleneck_width, 256),
      prop_grid_resolutions=tuple(cfg.zip_prop_grid_resolutions),
      nerf_grid_resolution=cfg.zip_nerf_grid_resolution,
      use_semantic=cfg.semantic, class_num=cfg.semantic_class_num)
