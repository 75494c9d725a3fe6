"""VGG-style perceptual feature distance for the confidence "vgg" mode and
`--lpips` (counterpart of snerf_tpu/models/features.py).

The torchvision VGG19 `features` slice up to relu4_1, tapped after
relu1_1, relu2_1, relu3_1 and relu4_1 (the reference's slice1..4), each
tap's per-pixel L1 distance averaged over channels, upsampled to (H, W)
and summed with the weights 1/16, 1/8, 1/4 and 1.

Weights: a torchvision VGG19 state_dict from `weights_path` (.pth or
.npz, keys `features.{idx}.weight` [cout, cin, 3, 3] and
`features.{idx}.bias`), or, without one, the seeded He-initialised
pyramid of the JAX module: the same numpy draws in the same order, so
both packages hold the same numbers.

The convolutions are `F.conv2d` (cuDNN on the card; run them with TF32
off for float32 products), the pools 2x2 with floor, the upsampling
`F.interpolate(mode="bilinear", align_corners=False)`, which is
`jax.image.resize(method="bilinear")` when upsampling.

Reference: s-nerf/model/confidence.py:8-63 (VGGLoss).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG19 `features` up to relu4_1: ("conv", tv_index, out_ch) |
# ("pool",) | ("tap",), a tap after relu1_1, relu2_1, relu3_1, relu4_1
_OPS = [
    ("conv", 0, 64), ("tap",),
    ("conv", 2, 64), ("pool",), ("conv", 5, 128), ("tap",),
    ("conv", 7, 128), ("pool",), ("conv", 10, 256), ("tap",),
    ("conv", 12, 256), ("conv", 14, 256), ("conv", 16, 256), ("pool",),
    ("conv", 19, 512), ("tap",),
]
_SLICE_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_params(weights_path: Optional[str] = None, seed: int = 0
               ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
  """{tv_index: (kernel [cout, cin, 3, 3] float32 OIHW, bias [cout])} for
  every conv of `_OPS`: from `weights_path`, or seeded as the JAX module
  draws them (`RandomState(seed).randn(3, 3, cin, cout) * sqrt(2 / (9
  cin))` in HWIO, conv by conv in `_OPS` order, zero biases)."""
  if weights_path is not None:
    if weights_path.endswith(".npz"):
      sd = dict(np.load(weights_path))
    else:
      sd = {k: v.numpy() for k, v in torch.load(
          weights_path, map_location="cpu", weights_only=True).items()}

    def make(idx, cin, cout):
      return (np.asarray(sd[f"features.{idx}.weight"], np.float32),
              np.asarray(sd[f"features.{idx}.bias"], np.float32))
  else:
    rng = np.random.RandomState(seed)

    def make(idx, cin, cout):
      std = np.sqrt(2.0 / (3 * 3 * cin))
      w = rng.randn(3, 3, cin, cout).astype(np.float32) * std
      return (np.ascontiguousarray(np.asarray(w, np.float32)
                                   .transpose(3, 2, 0, 1)),
              np.zeros(cout, np.float32))

  params = {}
  cin = 3
  for op in _OPS:
    if op[0] == "conv":
      _, idx, cout = op
      params[idx] = make(idx, cin, cout)
      cin = cout
  return params


def make_feature_fn(weights_path: Optional[str] = None, seed: int = 0,
                    device="cuda") -> Callable:
  """feature_fn(img0, img1) -> [H, W] perceptual error map of two [H, W, 3]
  images on `device` (the weights live there)."""
  params = {idx: (torch.as_tensor(w, device=device),
                  torch.as_tensor(b, device=device))
            for idx, (w, b) in vgg_params(weights_path, seed).items()}

  def feature_fn(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    H, W = img0.shape[:2]
    # both images as one batch of 2, NCHW
    x = torch.stack([img0, img1]).permute(0, 3, 1, 2).float()
    err = torch.zeros((H, W), dtype=x.dtype, device=x.device)
    tap = 0
    for op in _OPS:
      if op[0] == "conv":
        w, b = params[op[1]]
        x = F.relu(F.conv2d(x, w, b, padding=1))
      elif op[0] == "pool":
        x = F.max_pool2d(x, 2)
      else:
        e = torch.abs(x[0] - x[1]).mean(0)
        if tap > 0:
          e = F.interpolate(e[None, None], size=(H, W), mode="bilinear",
                            align_corners=False)[0, 0]
        err = err + _SLICE_WEIGHTS[tap] * e
        tap += 1
    return err

  return feature_fn
