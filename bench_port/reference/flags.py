"""The flag dataclass and its config-file / CLI parser: the port's own
copy of what it needs from snerf_tpu/config.py.

`Config` has every field and default of the JAX package's; `load_config`
reads a `--config <file>` (reference-style `key = value` text, YAML or a
zipnerf .gin) and then `--key value` overrides, with the same aliases and
ignored legacy flags. `snapshot_config` writes the resolved flags into
the experiment directory at train time and `load_config_with_snapshot`
rebuilds them from there for eval and render. The JAX module's adapter
methods (`model_config`,
`train_config`, `zip_model_config`, `zip_train_config`) import JAX and
are left out: `snerf_tpu_torch/config.py` has the port's counterparts.
`tests/test_torch_flags.py` holds the two parsers equal on every file in
configs/.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, List, Optional


@dataclasses.dataclass
class Config:
  # --- experiment / paths ---
  expname: str = "exp"
  basedir: str = "./exp"
  datadir: str = "./data"
  dataset_type: str = "nuscenes"    # nuscenes | waymo | llff | synthetic
  model: str = "mipnerf"            # mipnerf (S-NeRF) | zipnerf (S-NeRF++)
  config: Optional[str] = None      # config file path (filled by loader)

  # --- dataset ---
  H: int = 900
  W: int = 1600
  cam_num: int = 6
  datahold: int = 4
  bds_factor: float = 0.0
  no_align: bool = True
  colmap: bool = False
  half_train: bool = False
  fulltrain: bool = False
  skymask: bool = False
  near_far: bool = True
  factor: int = 1
  block_bg: bool = False
  car_sample_n: int = 9

  # --- model ---
  N_samples: int = 128
  N_fine: int = 128
  N_importance: int = 64
  hidden_layer: int = 1024
  rgb_layer: int = 3
  proposal_hidden_layer: int = 256
  max_degree: int = 16
  multires_views: int = 4
  use_viewdirs: bool = True
  ray_shape: str = "cone"
  no_warp_sample: bool = False
  fn: Optional[int] = 1
  radius: float = 3.0
  transform_idx: int = 0           # 0=log 1=disparity 2=linear
  real: bool = True
  lindisp: bool = False
  disable_integration: bool = False
  density_noise: float = 0.0
  white_bkgd: bool = False
  encode_appearance: bool = False
  semantic: bool = False
  semantic_class_num: int = 19
  randomized: bool = True

  # --- training ---
  N_rgb: int = 4096
  N_iters: int = 200_000
  lrate: float = 5e-4
  lrate_final: float = 5e-6
  lrate_delay: int = 2500
  depth_loss: bool = False
  depth_lambda: float = 0.2
  disparity_depth: bool = False
  coarse_loss_mult: float = 0.1
  smooth_loss: bool = False
  smooth_lambda: float = 0.02
  N_patch: int = 8
  patch_sz: int = 8
  proposal_loss: bool = True
  proposal_lambda: float = 1.0
  semantic_lambda: float = 0.04
  pose_refine: bool = False
  depth_conf: bool = False
  conf_num: int = 1
  vgg_loss: bool = False
  flow: bool = False
  precompute_conf: bool = True
  tau: float = 0.3
  backcam: bool = False
  waymo: bool = False
  seg_mask: bool = False
  grad_max_norm: float = 0.0
  single_image: bool = True
  ema_decay: float = 0.0

  # --- logging / checkpoints ---
  unroll_steps: int = 1
  i_print: int = 100
  i_weights: int = 5000
  i_testset: int = 200_000
  profile_steps: int = 0
  profile_start: int = 20
  ckpt_keep: int = 3
  resume: bool = True

  # --- zipnerf (S-NeRF++ background) ---
  zip_batch_size: int = 32768
  zip_max_steps: int = 50000
  zip_lr_init: float = 0.01
  zip_lr_final: float = 0.001
  zip_lr_delay: int = 5000
  zip_num_prop_samples: Any = (64, 64)
  zip_num_nerf_samples: int = 32
  zip_glo_features: int = 0
  zip_encoder: str = "hash"
  zip_ipe_density_width: int = 256
  zip_ipe_density_depth: int = 4
  zip_ipe_max_deg: int = 12
  zip_ipe_anneal_frac: float = 0.0
  zip_ipe_anisotropic: bool = False
  zip_cp_anisotropic: bool = False
  zip_ipe_skip_layer: int = 0
  zip_density_hidden_width: int = 64
  # tri-state: None = auto (True for the cp-family encoders, False for
  # hash/ipe); True/False override
  zip_density_zero_init: Any = None
  zip_scene_scale: float = 1.0
  zip_density_bias: float = -1.0
  zip_cp_num_levels: int = 4
  zip_cp_level_dim: int = 16
  zip_cp_base_resolution: int = 128
  zip_cp_max_resolution: int = 1024
  zip_cp_anneal_frac: float = 0.0
  zip_cp_collapse: bool = True
  zip_cp_pair_dim: int = 0
  zip_cp_init_smooth: float = 0.0
  zip_cp_factor_bound: float = 0.0
  zip_cp_feature_center: bool = False
  zip_cp_feature_scale: float = 1.0
  zip_cp_hash_resolution: int = 2048
  zip_cp_hash_log2: int = 19
  zip_cp_hash_num_levels: int = 1
  zip_cp_hash_base_resolution: int = 512
  zip_cp_hash_per_sample: bool = False
  zip_cp_hash_use_spread: bool = True
  zip_cp_hash_dither: bool = False
  zip_cp_hash_split: int = 0
  zip_cp_tri_resolution: int = 2048
  zip_cp_tri_level_dim: int = 4
  zip_encoder_lr_mult: float = 1.0
  zip_encoder_level_lr_gamma: float = 0.0
  zip_encoder_grad_max_norm: float = 0.0
  zip_ema_decay: float = 0.0
  zip_sample_n: int = 7
  zip_grid_num_levels: int = 10
  zip_log2_hashmap_size: int = 21
  zip_bottleneck_width: int = 256
  zip_prop_grid_resolutions: Any = (512, 2048)
  zip_nerf_grid_resolution: int = 8192
  zip_patch_size: int = 1
  zip_smoothness_loss_mult: float = 0.001
  zip_semantic_smoothness_loss_mult: float = 0.001
  zip_compute_dtype: str = "bfloat16"
  anti_interlevel_loss_mult: float = 0.01
  distortion_loss_mult: float = 0.005
  hash_decay_mult: float = 0.1
  zip_depth_loss_mult: float = 0.0
  zip_semantic_loss_mult: float = 0.04
  llffhold: int = 8
  dtu_light_cond: int = 2
  dtuhold: int = 8

  # --- eval ---
  lpips: bool = False
  chunk: int = 4096
  scan_render: bool = True
  tp: int = 1
  render_factor: int = 0
  eval_test: bool = True
  eval_train: bool = False
  ckpt: int = -1                   # -1 = latest
  test_refine_iter: int = 0

  def exp_dir(self) -> str:
    return os.path.join(self.basedir, self.expname)


def _coerce(value: str) -> Any:
  """Parse a config-file / CLI value string into a python value."""
  s = value.strip()
  if s.lower() in ("true", "false"):
    return s.lower() == "true"
  if s.lower() in ("none", "null"):
    return None
  try:
    return ast.literal_eval(s)
  except (ValueError, SyntaxError):
    return s


# gin bindings (zipnerf configs/*.gin) -> Config fields; unmapped gin keys
# are ignored
_GIN_MAP = {
    "Config.exp_name": "expname",
    "Config.data_dir": "datadir",
    "Config.dataset_loader": "dataset_type",
    "Config.near": None,
    "Config.far": None,
    "Config.factor": "factor",
    "Config.batch_size": "zip_batch_size",
    "Config.max_steps": "zip_max_steps",
    "Config.lr_init": "zip_lr_init",
    "Config.lr_final": "zip_lr_final",
    "Config.lr_delay_steps": "zip_lr_delay",
    "Config.render_chunk_size": "chunk",
    "Config.anti_interlevel_loss_mult": "anti_interlevel_loss_mult",
    "Config.distortion_loss_mult": "distortion_loss_mult",
    "Config.hash_decay_mults": "hash_decay_mult",
    "Config.use_semantic": "semantic",
    "Config.llffhold": "llffhold",
    "Model.num_nerf_samples": "zip_num_nerf_samples",
    "Model.num_prop_samples": "zip_num_prop_samples",
    "Model.num_glo_features": "zip_glo_features",
    "NerfMLP.class_num": "semantic_class_num",
}


def _parse_lines(lines, mapping=None) -> dict:
  """`key = value` lines, `#` comments dropped; with `mapping`, only its
  keys, renamed (None drops a key)."""
  out = {}
  for line in lines:
    line = line.split("#")[0].strip()
    if not line or "=" not in line:
      continue
    k, v = line.split("=", 1)
    k = k.strip()
    if mapping is None:
      out[k] = _coerce(v)
    elif mapping.get(k) is not None:
      out[mapping[k]] = _coerce(v)
  return out


def parse_config_file(path: str) -> dict:
  """Parse YAML, gin, or reference-style `key = value` text configs."""
  with open(path) as f:
    text = f.read()
  if path.endswith(".gin"):
    return {"model": "zipnerf", **_parse_lines(text.splitlines(), _GIN_MAP)}
  if path.endswith((".yaml", ".yml")):
    import yaml
    return yaml.safe_load(text) or {}
  return _parse_lines(text.splitlines())


_FIELD_ALIASES = {
    # reference flag -> Config field
    "i_weight": "i_weights",
    "raw_noise_std": "density_noise",
    "patch_size": "patch_sz",
    "coarse_depth_mult": "coarse_loss_mult",
    "no_batching": "single_image",
}

_IGNORED_FLAGS = {
    # accepted and ignored legacy flags
    "random_sample", "N_depth", "netdepth", "netwidth", "netdepth_fine",
    "netwidth_fine", "netchunk", "lrate_decay", "no_reload", "ft_path",
    "perturb", "i_embed", "multires", "render_only", "render_test",
    "render_test_ray", "render_train", "render_mypath", "precrop_iters",
    "precrop_frac", "testskip", "shape", "half_res", "no_ndc", "spherify",
    "i_img", "i_video", "debug", "alpha_model_path",
    "no_coarse", "train_scene", "test_scene", "colmap_depth",
    "weighted_loss", "relative_loss",
    "reg_loss", "reg_lambda", "weight_decay_mult", "distributed", "log",
    "translation", "conf_max", "load_poses",
    "far_bound", "no_reproj", "no_geometry", "render_sky", "half_test",
    "semantic_loss_type",
}


def load_config(argv: Optional[List[str]] = None,
                defaults: Optional[dict] = None) -> Config:
  """--config <file> first, then CLI --key value overrides (--key=value;
  a --key without a value is True)."""
  import argparse
  parser = argparse.ArgumentParser(add_help=False)
  parser.add_argument("--config", type=str, default=None)
  known, rest = parser.parse_known_args(argv)

  values = dict(defaults or {})
  if known.config:
    values.update(parse_config_file(known.config))

  i = 0
  while i < len(rest):
    tok = rest[i]
    if not tok.startswith("--"):
      raise ValueError(f"unexpected argument {tok!r}")
    tok = tok[2:]
    if "=" in tok:
      k, v = tok.split("=", 1)
      values[k] = _coerce(v)
      i += 1
    elif i + 1 < len(rest) and not rest[i + 1].startswith("--"):
      values[tok] = _coerce(rest[i + 1])
      i += 2
    else:
      values[tok] = True
      i += 1

  field_names = {f.name for f in dataclasses.fields(Config)}
  kwargs = {}
  for k, v in values.items():
    k = _FIELD_ALIASES.get(k, k)
    if k in field_names:
      kwargs[k] = v
    elif k in _IGNORED_FLAGS or k in _FIELD_ALIASES.values():
      continue
    else:
      raise ValueError(f"unknown config key {k!r}")
  cfg = Config(**kwargs)
  cfg.config = known.config
  return cfg


def load_config_with_snapshot(argv=None) -> Config:
  """load_config, but based on the experiment's args.txt snapshot
  (written by snapshot_config at train time) when one exists.

  Eval/render must rebuild the exact train-time state structure (e.g.
  --hidden_layer changes every weight shape); the snapshot is the fully
  resolved train-time config, so it outranks the --config file (which
  the first pass only uses to locate basedir/expname). Priority: fresh
  CLI flags > snapshot > --config file > defaults.
  """
  cfg = load_config(argv)
  snap = os.path.join(cfg.exp_dir(), "args.txt")
  if os.path.exists(snap):
    # re-parse with the snapshot as the base and without the --config
    # file (its contents are already inside the snapshot)
    rest = []
    args = list(argv) if argv is not None else []
    i = 0
    while i < len(args):
      if args[i] == "--config":
        i += 2
        continue
      if args[i].startswith("--config="):
        i += 1
        continue
      rest.append(args[i])
      i += 1
    cfg = load_config(rest, defaults=parse_config_file(snap))
  return cfg


def snapshot_config(cfg: Config):
  """Dump the resolved config and the original file into the experiment
  dir (reference model_utils.py:72-81: args.txt + config.txt)."""
  exp = cfg.exp_dir()
  os.makedirs(exp, exist_ok=True)
  with open(os.path.join(exp, "args.txt"), "w") as f:
    for field in sorted(dataclasses.fields(Config), key=lambda x: x.name):
      f.write(f"{field.name} = {getattr(cfg, field.name)}\n")
  if cfg.config and os.path.exists(cfg.config):
    with open(cfg.config) as src, \
         open(os.path.join(exp, "config.txt"), "w") as dst:
      dst.write(src.read())
