"""Learnable pose refinement (counterpart of snerf_tpu/models/posenet.py).

Per-camera axis-angle `r` and translation `t` tables, zero at init,
composed onto the initial camera-to-world poses (reference
model/poses.py). The state_dict keys `r` and `t` are the flax param
names. The JAX module's learn_rotation / learn_translation / t_ratio
fields are not ported: no caller sets them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bench_port.reference.ops import lie


class LearnPose(nn.Module):
  """Per-camera learnable SE(3) delta composed onto initial c2w poses."""

  def __init__(self, num_cams: int, device="cuda"):
    super().__init__()
    self.num_cams = num_cams
    self.r = nn.Parameter(torch.zeros(num_cams, 3, device=device))
    self.t = nn.Parameter(torch.zeros(num_cams, 3, device=device))

  def forward(self, cam_ids: torch.Tensor,
              c2w_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cam_ids: [...] int; c2w_init: [..., 3, 4] or None. Returns the
    refined c2w [..., 3, 4]."""
    return lie.make_c2w(self.r[cam_ids], self.t[cam_ids], c2w_init)
