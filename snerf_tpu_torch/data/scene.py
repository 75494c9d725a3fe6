"""Scene container (a copy of the `Scene` dataclass of
snerf_tpu/data/scene.py).

The data modules of the JAX package are numpy, but importing any of them
runs snerf_tpu/data/__init__.py, which imports jax; the port copies what
it needs instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Scene:
  """Host-side scene bundle; arrays are numpy, ready to ship to device."""
  images: np.ndarray                 # [N, H, W, 3] uint8
  poses: np.ndarray                  # [N, 3, 4] float32 c2w ([r, u, -t] conv.)
  intrinsics: np.ndarray             # [N, 3, 3] float32
  near: float
  far: float
  depths: Optional[np.ndarray] = None      # [N, H, W] float32 (0 = no depth)
  skymask: Optional[np.ndarray] = None     # [N, H, W] bool
  semantics: Optional[np.ndarray] = None   # [N, H, W] int32 labels
  cam_index: Optional[np.ndarray] = None   # [N] int32 camera id per image
  flow: Optional[np.ndarray] = None        # [2, N, H, W, 2] next/prev flow
  i_train: Optional[np.ndarray] = None
  i_test: Optional[np.ndarray] = None
  scale: float = 1.0                 # world-units scale factor applied
  render_poses: Optional[np.ndarray] = None
  # foreground (moving-vehicle) branch: per-image 2D bbox [x0, y0, x1, y1]
  # restricting ray sampling (reference --block_bg, dataloader.py:17-19)
  bboxes: Optional[np.ndarray] = None

  @property
  def hw(self):
    return self.images.shape[1], self.images.shape[2]

  @property
  def num_images(self):
    return self.images.shape[0]
