"""Quality metrics: PSNR, SSIM (+map mode), MS-SSIM, mIoU and the KITTI
depth metrics (counterpart of snerf_tpu/utils/metrics.py).

Images are [H, W, C] float tensors in [0, 1], on any device. The SSIM
blur is a depthwise `F.conv2d` (VALID), the JAX module's
`conv_general_dilated`. `kitti_depth_metrics` and `MiouEvaluator` are
numpy, copied.

Reference: s-nerf/utils/pytorch_msssim/__init__.py:19-142 (gaussian-window
SSIM with full=True per-pixel map, MS-SSIM),
s-nerfpp/zipnerf/internal/image.py:110-125 (MetricHarness PSNR/SSIM),
s-nerfpp/zipnerf/random_render_waymo_seq.py:34-90 (mIoU Evaluator).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from snerf_tpu_torch.ops.math import mse_to_psnr


def psnr(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
  return mse_to_psnr(torch.mean((img0 - img1) ** 2))


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
  x = np.arange(size, dtype=np.float32) - size // 2
  g = np.exp(-(x ** 2) / (2 * sigma ** 2))
  return g / g.sum()


def _blur2d(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
  """Separable gaussian blur of [H, W, C] by a depthwise conv (VALID)."""
  c = img.shape[-1]
  x = img.permute(2, 0, 1)[None]  # NCHW
  win = torch.as_tensor(window, dtype=img.dtype, device=img.device)
  size = win.shape[0]
  x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1),
               groups=c)
  x = F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size),
               groups=c)
  return x[0].permute(1, 2, 0)


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, return_map: bool = False):
  """SSIM of two [H, W, C] images; return_map=True gives the VALID-size map
  (the `full=True` mode, pytorch_msssim/__init__.py:19-64)."""
  window = _gaussian_window(window_size, sigma)
  mu0 = _blur2d(img0, window)
  mu1 = _blur2d(img1, window)
  mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
  # E[x^2]-mu^2 in f32 can go slightly negative on near-constant windows
  # (catastrophic cancellation), which pushes the SSIM map above 1. The
  # variances are clamped at 0; the covariance is magnitude-capped by
  # Cauchy-Schwarz so the map stays in [-1, 1].
  s00 = torch.clamp(_blur2d(img0 * img0, window) - mu00, min=0.0)
  s11 = torch.clamp(_blur2d(img1 * img1, window) - mu11, min=0.0)
  s01 = _blur2d(img0 * img1, window) - mu01
  cap = torch.sqrt(s00 * s11)
  s01 = torch.minimum(torch.maximum(s01, -cap), cap)
  c1 = (0.01 * max_val) ** 2
  c2 = (0.03 * max_val) ** 2
  ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2) /
              ((mu00 + mu11 + c1) * (s00 + s11 + c2)))
  if return_map:
    return ssim_map
  return torch.mean(ssim_map)


def ms_ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
            window_size: int = 11, sigma: float = 1.5,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
  """Multi-scale SSIM (pytorch_msssim/__init__.py:67-142)."""
  levels = len(weights)
  window = _gaussian_window(window_size, sigma)
  vals = []
  i0, i1 = img0, img1
  for lvl in range(levels):
    mu0 = _blur2d(i0, window)
    mu1 = _blur2d(i1, window)
    s00 = _blur2d(i0 * i0, window) - mu0 * mu0
    s11 = _blur2d(i1 * i1, window) - mu1 * mu1
    s01 = _blur2d(i0 * i1, window) - mu0 * mu1
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    cs = torch.mean((2 * s01 + c2) / (s00 + s11 + c2))
    ssim_l = torch.mean(((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) /
                        ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2)))
    vals.append(ssim_l if lvl == levels - 1 else cs)
    # 2x average-pool downsample
    h, w = i0.shape[0] // 2 * 2, i0.shape[1] // 2 * 2
    pool = lambda im: 0.25 * (im[0:h:2, 0:w:2] + im[1:h:2, 0:w:2] +
                              im[0:h:2, 1:w:2] + im[1:h:2, 1:w:2])
    i0, i1 = pool(i0), pool(i1)
  vals = torch.stack(vals)
  w = torch.as_tensor(weights, dtype=vals.dtype, device=vals.device)
  return torch.prod(torch.clamp(vals, min=1e-6) ** w)


class MetricHarness:
  """PSNR + SSIM pair (zipnerf image.py:110-125 parity), and with
  lpips=True the mean of the VGG feature distance of models/features.py
  (the seeded pyramid: a relative perceptual distance, not calibrated
  LPIPS), its weights on `device`, where the images must lie."""

  def __init__(self, lpips: bool = False, device="cuda"):
    self._lpips_fn = None
    if lpips:
      from snerf_tpu_torch.models.features import make_feature_fn
      self._lpips_fn = make_feature_fn(device=device)

  def __call__(self, rgb_pred: torch.Tensor, rgb_gt: torch.Tensor):
    out = {"psnr": float(psnr(rgb_pred, rgb_gt)),
           "ssim": float(ssim(rgb_pred, rgb_gt))}
    if self._lpips_fn is not None:
      out["lpips"] = float(torch.mean(self._lpips_fn(rgb_pred, rgb_gt)))
    return out


def kitti_depth_metrics(pred, gt, min_depth: float = 1e-3,
                        max_depth: float = 80.0):
  """KITTI depth-completion metrics (the reference's prebuilt
  evaluate_depth binary): mae/rmse in mm, imae/irmse in 1/km, over valid
  gt pixels."""
  pred = np.asarray(pred, np.float64)
  gt = np.asarray(gt, np.float64)
  valid = (gt > min_depth) & (gt < max_depth)
  p = np.clip(pred[valid], min_depth, max_depth)
  g = gt[valid]
  err = p - g
  ierr = 1.0 / p - 1.0 / g
  return {
      "mae": float(np.mean(np.abs(err)) * 1000.0),
      "rmse": float(np.sqrt(np.mean(err ** 2)) * 1000.0),
      "imae": float(np.mean(np.abs(ierr)) * 1000.0),
      "irmse": float(np.sqrt(np.mean(ierr ** 2)) * 1000.0),
      "n_valid": int(valid.sum()),
  }


class MiouEvaluator:
  """Streaming confusion-matrix mIoU over semantic label maps.

  Parity: random_render_waymo_seq.py:34-90 Evaluator.
  """

  def __init__(self, num_classes: int):
    self.num_classes = num_classes
    self.confusion = np.zeros((num_classes, num_classes), np.int64)

  def add_batch(self, gt, pred):
    gt = np.asarray(gt).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    mask = (gt >= 0) & (gt < self.num_classes)
    idx = self.num_classes * gt[mask].astype(np.int64) + pred[mask]
    self.confusion += np.bincount(
        idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

  def miou(self):
    inter = np.diag(self.confusion)
    union = (self.confusion.sum(1) + self.confusion.sum(0) - inter)
    iou = inter / np.maximum(union, 1)
    return float(np.mean(iou[union > 0])) if (union > 0).any() else 0.0
