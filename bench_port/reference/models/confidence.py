"""The depth confidence's learnable mixture, plain PyTorch: a frozen copy
of the port's `ConfidenceModel` (models/confidence.py). The confidence
maps it mixes are the scene's data (the uint8 maps the port precomputes
by reprojection), read as they are: no reprojection is copied.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

MODES = ("rgb", "ssim", "depth", "vgg", "flow")


class ConfidenceModel(nn.Module):
  """Learnable weights lambdas [n_modes, num_images], zero at init; the
  confidence of a ray is the sigmoid(lambda)-weighted mean of its modes'
  confidences."""

  def __init__(self, modes: Sequence[str], num_images: int, device="cuda"):
    super().__init__()
    unknown = [m for m in modes if m not in MODES]
    if unknown:
      raise ValueError(f"unknown confidence modes {unknown} (known: "
                       f"{MODES})")
    self.modes = tuple(modes)
    self.lambdas = nn.Parameter(torch.zeros((len(self.modes), num_images),
                                            device=device))

  def combine(self, conf_stack: torch.Tensor, img_idx: torch.Tensor
              ) -> torch.Tensor:
    """conf_stack [n_modes, ...], the modes' confidences of rays of the
    images img_idx [...] -> their mixture [...]."""
    weights = torch.sigmoid(self.lambdas[:, img_idx])
    num = torch.sum(weights * conf_stack, dim=0)
    return num / torch.clamp(torch.sum(weights, dim=0), min=1e-10)
