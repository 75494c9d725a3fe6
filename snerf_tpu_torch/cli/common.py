"""What the train, eval and render entry points share: the port-only
flags, the device rule, the scene loaders and the model state by family
(counterparts of train.py's `load_scene` and `build_model_state`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snerf_tpu_torch.data.scene import Scene

# loaders the port has not ported yet -> their ROADMAP item
_UNPORTED_LOADERS = {
    "llff": "data/llff.py, ROADMAP Queue 1, item 7",
    "dtu": "data/dtu.py, ROADMAP Queue 1, item 8",
    "tnt": "data/tnt.py, ROADMAP Queue 1, item 8",
}


def split_flags(argv: Optional[List[str]], extra: Dict[str, object]
                ) -> Tuple[List[str], Dict[str, object]]:
  """Strip the entry point's own `--key value` flags (`extra`: name ->
  default) from argv before the shared parse, as render.py strips its
  render-only flags. Returns (the rest of argv, the values)."""
  argv = list(argv or [])
  values = dict(extra)
  for k in extra:
    if f"--{k}" in argv:
      i = argv.index(f"--{k}")
      values[k] = argv[i + 1]
      del argv[i:i + 2]
  return argv, values


def resolve_device(name: str) -> torch.device:
  """The device an entry point runs on: `--device` (default cuda). A CUDA
  device without a card raises; nothing falls back to the CPU."""
  device = torch.device(name)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"--device {name}: no CUDA card is available; pass --device cpu to "
        "run on the CPU")
  return device


def reject_scan_render(argv: List[str], cfg):
  """Raise when `--scan_render` is given on the command line and true:
  it asks for the single-dispatch `lax.scan` render, which the port does
  not have (it renders chunk by chunk, with the same outputs). The
  flag's default is True in the shared flag set, so only an explicit
  request raises."""
  given = any(t == "--scan_render" or t.startswith("--scan_render=")
              for t in argv)
  if given and cfg.scan_render:
    raise NotImplementedError(
        "--scan_render: the single-dispatch scan render is not ported "
        "(ROADMAP Queue 1, item 7); the port renders chunk by chunk")


def float32_numerics():
  """float32 products on the card, as the JAX package computes them on
  the CPU: TF32 off for matmuls and for cuDNN's convolutions (the SSIM
  blur, the VGG pyramid of the confidence and of --lpips)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def load_scene(cfg) -> Scene:
  """The scene of `cfg.dataset_type` (train.py's `load_scene`): the
  synthetic scene, a nuScenes or a Waymo directory. The other loaders
  raise, naming their ROADMAP item."""
  if cfg.dataset_type == "synthetic":
    from snerf_tpu_torch.data.synthetic import make_synthetic_scene
    return make_synthetic_scene(num_images=max(6, cfg.cam_num), H=cfg.H,
                                W=cfg.W, datahold=cfg.datahold)
  if cfg.dataset_type == "nuscenes":
    from snerf_tpu_torch.data.scene import load_nuscenes_scene
    return load_nuscenes_scene(
        cfg.datadir, bd_factor=cfg.bds_factor, cam_num=cfg.cam_num,
        datahold=cfg.datahold, sky_mask=cfg.skymask,
        load_depth=cfg.depth_loss or cfg.near_far,
        load_semantic=cfg.semantic, no_align=cfg.no_align,
        colmap=cfg.colmap)
  if cfg.dataset_type == "waymo":
    from snerf_tpu_torch.data.waymo import load_waymo_scene
    return load_waymo_scene(cfg.datadir, llffhold=cfg.llffhold,
                            factor=cfg.factor, load_semantic=cfg.semantic)
  if cfg.dataset_type in _UNPORTED_LOADERS:
    raise NotImplementedError(
        f"dataset_type {cfg.dataset_type!r} is not ported yet "
        f"({_UNPORTED_LOADERS[cfg.dataset_type]})")
  raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")


def build_model_state(cfg, num_images: int, device):
  """(model, state) of the flags' model family, seeded 0 as train.py
  seeds it; the mip state's pose model is `state.pose_model`. The
  classic model is not ported."""
  from snerf_tpu_torch.config import (model_config, train_config,
                                      zip_model_config, zip_train_config)
  if cfg.model == "zipnerf":
    from snerf_tpu_torch.train.zip_trainer import create_zip_train_state
    state = create_zip_train_state(0, zip_model_config(cfg),
                                   zip_train_config(cfg), device=device)
    return state.model, state
  if cfg.model == "classic":
    raise NotImplementedError("--model classic is not ported yet "
                              "(models/classic.py, ROADMAP Queue 1, item 7)")
  from snerf_tpu_torch.train.trainer import create_train_state
  model, _, state = create_train_state(0, model_config(cfg),
                                       train_config(cfg), num_images,
                                       device=device)
  return model, state


def render_fn_for(cfg, model):
  """The deterministic per-chunk render of the flags' model family."""
  from snerf_tpu_torch.train.renderer import (make_eval_render_fn,
                                              make_zip_eval_render_fn)
  if cfg.model == "zipnerf":
    return make_zip_eval_render_fn(model)
  return make_eval_render_fn(model, white_bkgd=cfg.white_bkgd)


def image_rays(scene: Scene, pose, K, device, H: int, W: int,
               render_factor: int = 0):
  """The ray grid of one view on `device`."""
  from snerf_tpu_torch.data.raygen import rays_for_image
  return rays_for_image(
      torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=device),
      torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device),
      H, W, scene.near, scene.far, render_factor=render_factor)


def to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
  return {k: v.detach().cpu().numpy() for k, v in out.items()}
