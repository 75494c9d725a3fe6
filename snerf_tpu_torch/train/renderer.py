"""Chunked full-image rendering for the mip and zip models (counterpart
of snerf_tpu/train/renderer.py, single device).

The JAX module's single-dispatch `lax.scan` variant and its mesh
sharding have no counterpart yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from snerf_tpu_torch.ops.rays import Rays

RenderFn = Callable[[Rays], Dict[str, torch.Tensor]]


def render_rays_chunked(render_fn: RenderFn, rays: Rays,
                        chunk: int = 4096) -> Dict[str, torch.Tensor]:
  """Apply a per-chunk render fn over a flat [N] ray bundle, `chunk` rays
  at a time. Returns a dict of [N, ...] tensors on the rays' device."""
  n = rays.origins.shape[0]
  outs = []
  for start in range(0, n, chunk):
    outs.append(render_fn(rays.map(lambda x: x[start:start + chunk])))
  return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def render_image(render_fn: RenderFn, rays: Rays,
                 chunk: int = 4096) -> Dict[str, torch.Tensor]:
  """Render a full [H, W] ray grid; returns a dict of [H, W, ...] tensors."""
  H, W = rays.origins.shape[:2]
  out = render_rays_chunked(render_fn, rays.reshape(-1), chunk=chunk)
  return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}


def make_eval_render_fn(model, white_bkgd: bool = False) -> RenderFn:
  """Deterministic render of the fine level under inference mode.

  Returns Rays -> dict(rgb [N, 3], distance [N, 1], acc [N, 1], and
  semantic [N, C] when the model has a semantic head).
  """

  def render_fn(rays: Rays) -> Dict[str, torch.Tensor]:
    with torch.inference_mode():
      fine = model(rays, white_bkgd=white_bkgd)[-1]
    out = {"rgb": fine["rgb"], "distance": fine["distance"][..., None],
           "acc": fine["acc"][..., None]}
    if fine.get("semantic") is not None:
      out["semantic"] = fine["semantic"]
    return out

  return render_fn


def make_zip_eval_render_fn(model) -> RenderFn:
  """Deterministic zip-nerf render of the finest level under inference
  mode (counterpart of `make_zip_param_render_fn`).

  Returns Rays -> dict(rgb [N, 3], distance [N, 1] (the finest level's
  depth), acc [N, 1], and semantic [N, C] when the model has a semantic
  head).
  """

  def render_fn(rays: Rays) -> Dict[str, torch.Tensor]:
    with torch.inference_mode():
      fine = model(rays)[0][-1]
    out = {"rgb": fine["rgb"], "distance": fine["depth"][..., None],
           "acc": fine["acc"][..., None]}
    if fine.get("semantic") is not None:
      out["semantic"] = fine["semantic"]
    return out

  return render_fn


def pred2real(pred_distance, near, far):
  """Disparity-space prediction -> metric depth:
  d = 1 / (s/far + (1-s)/near)."""
  return 1.0 / (pred_distance / far + (1.0 - pred_distance) / near)
