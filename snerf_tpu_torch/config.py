"""Config adapter: the port's model config from the shared flag dataclass.

`snerf_tpu.config.Config` is plain Python and imports no JAX, so the port
reuses it. Its own `Config.model_config()` imports jax, hence this
counterpart.
"""

from __future__ import annotations

from snerf_tpu.config import Config, load_config  # noqa: F401 (re-export)
from snerf_tpu_torch.models.mipnerf import MipNerfConfig

_T_TRANSFORM = {0: "log", 1: "disparity", 2: "linear"}


def model_config(cfg: Config) -> MipNerfConfig:
  """MipNerfConfig for the eval path, as `Config.model_config()` builds
  it (float32 activations). Flags the port does not support yet raise."""
  if cfg.encode_appearance:
    raise NotImplementedError("encode_appearance is not ported yet")
  return MipNerfConfig(
      num_samples=cfg.N_samples, num_fine=cfg.N_fine,
      resample_padding=0.01, use_viewdirs=cfg.use_viewdirs,
      lindisp=cfg.lindisp, ray_shape=cfg.ray_shape,
      max_deg_point=cfg.max_degree, deg_view=cfg.multires_views,
      disable_integration=cfg.disable_integration,
      no_warp_sample=cfg.no_warp_sample, warp_fn=cfg.fn,
      warp_radius=cfg.radius, t_transform=_T_TRANSFORM[cfg.transform_idx],
      hidden_layer=cfg.hidden_layer, rgb_layer=cfg.rgb_layer,
      proposal_hidden_layer=cfg.proposal_hidden_layer,
      semantic=cfg.semantic, semantic_class_num=cfg.semantic_class_num)
