"""The deterministic zip-nerf render of one chunk of rays (the finest
level, the MLPs in float32 whatever their training dtype)."""

from __future__ import annotations

from typing import Dict

import torch

from bench_port.reference.models.zipnerf import float32_forward
from bench_port.reference.ops.rays import Rays


def make_zip_eval_render_fn(model):
  """Rays -> dict(rgb [N, 3], distance [N, 1], acc [N, 1], and semantic
  [N, C] when the model has a semantic head)."""

  def render_fn(rays: Rays) -> Dict[str, torch.Tensor]:
    with torch.inference_mode(), float32_forward(model):
      fine = model(rays)[0][-1]
    out = {"rgb": fine["rgb"], "distance": fine["depth"][..., None],
           "acc": fine["acc"][..., None]}
    if fine.get("semantic") is not None:
      out["semantic"] = fine["semantic"]
    return out

  return render_fn
