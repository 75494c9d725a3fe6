"""Ray bundle (counterpart of snerf_tpu/ops/rays.py)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Rays:
  """A bundle of rays. All leading dims are batch dims; trailing dims:

    origins    [..., 3]  ray origins (world)
    directions [..., 3]  un-normalized ray directions (pixel-spacing scaled)
    viewdirs   [..., 3]  normalized view directions
    radii      [..., 1]  base radii of the pixel cone/cylinder
    lossmult   [..., 1]  per-ray loss multiplier
    near       [..., 1]  near plane
    far        [..., 1]  far plane
    app        [..., 1]  appearance-embedding id (int32, optional)
  """
  origins: torch.Tensor
  directions: torch.Tensor
  viewdirs: torch.Tensor
  radii: torch.Tensor
  lossmult: torch.Tensor
  near: torch.Tensor
  far: torch.Tensor
  app: Optional[torch.Tensor] = None

  @property
  def batch_shape(self):
    return self.origins.shape[:-1]

  @property
  def device(self) -> torch.device:
    return self.origins.device

  def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rays":
    """Apply fn to every present field."""
    return Rays(**{f.name: (None if getattr(self, f.name) is None
                            else fn(getattr(self, f.name)))
                   for f in dataclasses.fields(self)})

  def reshape(self, *shape) -> "Rays":
    return self.map(lambda x: x.reshape(*shape, x.shape[-1]))


def pad_rays(rays: Rays, n: int) -> Rays:
  """Edge-pad the leading axis to length n."""

  def _pad(x):
    pad = n - x.shape[0]
    if pad <= 0:
      return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)

  return rays.map(_pad)
