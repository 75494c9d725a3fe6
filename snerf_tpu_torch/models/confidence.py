"""The depth confidence: reprojection warping, per-mode confidence maps
and learnable per-image mode weights (counterpart of
snerf_tpu/models/confidence.py).

Each base pixel is unprojected by its LiDAR depth and reprojected into a
neighbouring view of the same camera; the neighbour is warped into the
base frame by bilinear sampling at the projected coordinates (a gather,
as in the JAX module), and each mode's error against the base image
becomes a confidence in [0, 1], averaged over the neighbours, zero where
the depth disagrees by more than tau. `precompute_conf_maps` stores them
quantised to uint8 for the train step, which mixes the modes with
sigmoid(lambda[mode, image]) (`ConfidenceModel`) and weights the depth
loss by the mixture.

Everything runs on the device of the tensors it is given; the products
are float32 (run them with TF32 off on the card).

Reference: s-nerf/model/loss.py:138-179 (warping), :218-268 (reproj_err),
:271-327 (get_reproj_conf), s-nerf/model/confidence.py:65-112, 115-169,
187-225 (Confidence, select_conf_depends, the weighted depth loss).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from snerf_tpu_torch.utils import metrics

MODES = ("rgb", "ssim", "depth", "vgg", "flow")


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
  """Sample [H, W, C] at float coordinates (x = column, y = row), taps
  clamped to the border; the weights come from the unclamped floor."""
  H, W = img.shape[:2]
  x0 = torch.floor(x)
  y0 = torch.floor(y)
  dx = x - x0
  dy = y - y0
  x0 = x0.long().clamp(0, W - 1)
  y0 = y0.long().clamp(0, H - 1)
  x1 = (x0 + 1).clamp(0, W - 1)
  y1 = (y0 + 1).clamp(0, H - 1)
  w00 = (1 - dx) * (1 - dy)
  w01 = dx * (1 - dy)
  w10 = (1 - dx) * dy
  w11 = dx * dy
  return (img[y0, x0] * w00[..., None] + img[y0, x1] * w01[..., None] +
          img[y1, x0] * w10[..., None] + img[y1, x1] * w11[..., None])


def _pixel_grid(H: int, W: int, device):
  ys = torch.arange(H, dtype=torch.float32, device=device)
  xs = torch.arange(W, dtype=torch.float32, device=device)
  return torch.meshgrid(ys, xs, indexing="ij")


def project_to_view(base_depth, base_pose, base_intr, tgt_pose, tgt_intr):
  """Unproject every base pixel by its depth and reproject it into the
  target view (pinhole, f the mean of fx and fy, the -y/-z camera
  convention). Returns (tgt_x, tgt_y, proj_depth = |z|, in_front = z < 0),
  each [H, W]."""
  H, W = base_depth.shape
  f = (base_intr[0, 0] + base_intr[1, 1]) / 2
  tgt_f = (tgt_intr[0, 0] + tgt_intr[1, 1]) / 2
  ys, xs = _pixel_grid(H, W, base_depth.device)
  i = (xs - base_intr[0, 2]) / f
  j = -(ys - base_intr[1, 2]) / f
  dirs = torch.stack([i, j, -torch.ones_like(i)], -1) * base_depth[..., None]

  R_b, t_b = base_pose[:3, :3], base_pose[:3, 3]
  pts = dirs @ R_b.T + t_b
  R_t, t_t = tgt_pose[:3, :3], tgt_pose[:3, 3]
  cam = (pts - t_t) @ R_t  # R^T (p - t): world -> target camera

  proj_depth = torch.abs(cam[..., 2])
  safe_z = torch.clamp(proj_depth, min=1e-8)
  tgt_x = cam[..., 0] / safe_z * tgt_f + tgt_intr[0, 2]
  tgt_y = -cam[..., 1] / safe_z * tgt_f + tgt_intr[1, 2]
  in_front = cam[..., 2] < 0  # -z is forward
  return tgt_x, tgt_y, proj_depth, in_front


def warp_image(base_depth, base_pose, base_intr, tgt_img, tgt_depth,
               tgt_pose, tgt_intr):
  """Warp the target view into the base frame through the base depth.
  Returns (fake_img [H, W, 3], tgt_depth_at [H, W], proj_depth [H, W],
  valid [H, W]), zero where not valid."""
  H, W = base_depth.shape
  tgt_x, tgt_y, proj_depth, in_front = project_to_view(
      base_depth, base_pose, base_intr, tgt_pose, tgt_intr)
  inside = ((tgt_x >= 0) & (tgt_x <= W - 1) &
            (tgt_y >= 0) & (tgt_y <= H - 1))
  valid = inside & in_front & (base_depth > 0)
  fake_img = bilinear_sample(tgt_img, tgt_x, tgt_y)
  tgt_depth_at = bilinear_sample(tgt_depth[..., None], tgt_x, tgt_y)[..., 0]
  zero = torch.zeros((), dtype=fake_img.dtype, device=fake_img.device)
  return (torch.where(valid[..., None], fake_img, zero),
          torch.where(valid, tgt_depth_at, zero),
          torch.where(valid, proj_depth, zero),
          valid)


def _ssim_err(base, fake):
  """1 - SSIM per pixel: the VALID-size map, edge-padded back to H x W."""
  err = 1.0 - metrics.ssim(base, fake, return_map=True).mean(-1)
  H, W = base.shape[:2]
  ph = (H - err.shape[0]) // 2
  pw = (W - err.shape[1]) // 2
  return F.pad(err[None, None],
               (pw, W - err.shape[1] - pw, ph, H - err.shape[0] - ph),
               mode="replicate")[0, 0]


def reproj_err_maps(modes: Sequence[str], base_img, base_depth, base_pose,
                    base_intr, tgt_img, tgt_depth, tgt_pose, tgt_intr,
                    feature_fn: Optional[Callable] = None,
                    base_flow: Optional[torch.Tensor] = None):
  """Per-mode [H, W] error maps against one neighbour, and the validity
  mask. "vgg" needs `feature_fn`; "flow" needs `base_flow` [H, W, 2], the
  optical flow (dx, dy in pixels) from the base image to this neighbour,
  and measures ||reprojection(p) - (p + flow(p))||_2 in pixels."""
  fake_img, tgt_depth_at, proj_depth, valid = warp_image(
      base_depth, base_pose, base_intr, tgt_img, tgt_depth, tgt_pose,
      tgt_intr)
  base_masked = torch.where(valid[..., None], base_img,
                            torch.zeros((), dtype=base_img.dtype,
                                        device=base_img.device))
  errs = {}
  if "rgb" in modes:
    errs["rgb"] = torch.abs(base_masked - fake_img).mean(-1)
  if "ssim" in modes:
    errs["ssim"] = _ssim_err(base_masked, fake_img)
  if "depth" in modes:
    errs["depth"] = (torch.abs(proj_depth - tgt_depth_at)
                     / torch.clamp(tgt_depth_at, min=1e-10))
  if "vgg" in modes and feature_fn is not None:
    errs["vgg"] = feature_fn(base_masked, fake_img)
  if "flow" in modes and base_flow is not None:
    H, W = base_depth.shape
    tgt_x, tgt_y, _, _ = project_to_view(base_depth, base_pose, base_intr,
                                         tgt_pose, tgt_intr)
    ys, xs = _pixel_grid(H, W, base_depth.device)
    flow_x = xs + base_flow[..., 0]
    flow_y = ys + base_flow[..., 1]
    errs["flow"] = torch.sqrt((tgt_x - flow_x) ** 2 + (tgt_y - flow_y) ** 2)
  return errs, valid


def reproj_conf_maps(modes: Sequence[str], base_img, base_depth, base_pose,
                     base_intr, neighbors: List[dict], tau: float = 0.2,
                     feature_fn: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
  """Each mode's [H, W] confidence, aggregated over the neighbours.

  neighbors: dicts with img, depth, pose, intr, an optional `weight` (0
  for a padded slot) and an optional `flow`. Per neighbour the confidence
  is (max err - err) / its max, the max taken over the whole image with
  the invalid pixels at 0; it is averaged over the valid weighted
  neighbours; a relative depth error above tau at a valid pixel of a
  weighted neighbour zeroes every mode there, and the depth error is
  clipped to tau. A mode a neighbour lacks (flow without a flow field)
  is skipped for it.
  """
  H, W = base_depth.shape
  dev = base_depth.device
  conf_acc = {m: torch.zeros((H, W), device=dev) for m in modes}
  count = {m: torch.zeros((H, W), device=dev) for m in modes}
  outlier = torch.zeros((H, W), dtype=torch.bool, device=dev)

  for nb in neighbors:
    w = torch.as_tensor(nb.get("weight", 1.0), dtype=torch.float32,
                        device=dev)
    errs, valid = reproj_err_maps(
        modes, base_img, base_depth, base_pose, base_intr, nb["img"],
        nb["depth"], nb["pose"], nb["intr"], feature_fn=feature_fn,
        base_flow=nb.get("flow"))
    vw = valid.float() * w
    if "depth" in errs:
      outlier = outlier | (valid & (errs["depth"] > tau) & (w > 0))
      errs["depth"] = torch.clamp(errs["depth"], max=tau)
    for m in modes:
      if m not in errs:
        continue
      err = torch.where(valid, errs[m], torch.zeros((), device=dev))
      conf = torch.max(err) - err
      conf = conf / torch.clamp(torch.max(conf), min=1e-10)
      conf_acc[m] = conf_acc[m] + conf * vw
      count[m] = count[m] + vw

  return {m: torch.where(outlier, torch.zeros((), device=dev),
                         conf_acc[m] / torch.clamp(count[m], min=1.0))
          for m in modes}


def build_neighbor_table(i_train: np.ndarray, cam_index: np.ndarray,
                         conf_num: int = 1):
  """Static neighbour ids of every train image (+-k positions in i_train,
  same camera), with weights: ids [n_train, 2 conf_num] int32, weights
  [n_train, 2 conf_num] float32; a padded slot points at the image itself
  with weight 0."""
  n = len(i_train)
  ids = np.zeros((n, 2 * conf_num), np.int32)
  ws = np.zeros((n, 2 * conf_num), np.float32)
  for pos, img_i in enumerate(i_train):
    col = 0
    for k in range(1, conf_num + 1):
      for cand_pos in (pos + k, pos - k):
        if 0 <= cand_pos < n and \
            cam_index[i_train[cand_pos]] == cam_index[img_i]:
          ids[pos, col] = i_train[cand_pos]
          ws[pos, col] = 1.0
        else:
          ids[pos, col] = img_i
          ws[pos, col] = 0.0
        col += 1
  return ids, ws


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


def quantize(maps: torch.Tensor) -> torch.Tensor:
  """Confidences in [0, 1] -> uint8, clip(maps * 255 + 0.5, 0, 255) in
  float32, truncated."""
  return torch.clamp(maps * 255.0 + 0.5, 0, 255).to(torch.uint8)


def precompute_conf_maps(modes: Sequence[str], scene, device_scene,
                         conf_num: int = 1, tau: float = 0.2,
                         feature_fn: Optional[Callable] = None
                         ) -> torch.Tensor:
  """The confidence maps of every train image, quantised:
  [n_train, n_modes, H, W] uint8 on the device of `device_scene` (the
  `scene_to_device` dict of `scene`), computed there one train image at
  a time. `scene` gives i_train, cam_index and the optional flow
  [2, N, H, W, 2] (next, prev), which feeds the "flow" mode of the
  neighbour columns 0 and 1."""
  i_train = np.asarray(scene.i_train)
  cam_index = np.asarray(scene.cam_index)
  ids, ws = build_neighbor_table(i_train, cam_index, conf_num)
  images = device_scene["images"]
  depths = device_scene["depths"]
  poses = device_scene["poses"]
  intrs = device_scene["intrinsics"]
  dev = images.device
  flows = None
  if "flow" in modes and getattr(scene, "flow", None) is not None:
    flows = scene.flow

  def img(i):
    return images[i].float() / 255.0

  H, W = images.shape[1:3]
  out = torch.zeros((len(i_train), len(modes), H, W), dtype=torch.uint8,
                    device=dev)
  with torch.no_grad():
    for pos, img_i in enumerate(i_train):
      neighbors = [{"img": img(nb), "depth": depths[nb], "pose": poses[nb],
                    "intr": intrs[nb], "weight": float(w)}
                   for nb, w in zip(ids[pos], ws[pos])]
      if flows is not None:
        for c in range(min(2, len(neighbors))):
          neighbors[c]["flow"] = torch.as_tensor(
              np.asarray(flows[c, img_i], np.float32), device=dev)
      confs = reproj_conf_maps(modes, img(img_i), depths[img_i],
                               poses[img_i], intrs[img_i], neighbors,
                               tau=tau, feature_fn=feature_fn)
      out[pos] = quantize(torch.stack([confs[m] for m in modes]))
  return out
