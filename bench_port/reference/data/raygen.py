"""Ray generation for undistorted pinhole cameras (counterpart of
snerf_tpu/data/raygen.py). OPENCV and fisheye distortion are not ported
yet.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.ops.rays import Rays


def camera_dirs_from_pixels(px, py, intrinsic):
  """Pixel coords -> camera-space dirs with the (i - cx + 0.5)/f,
  -(j - cy + 0.5)/f, -1 convention. px/py: [...], intrinsic: [..., 3, 3]."""
  cx = intrinsic[..., 0, 2]
  cy = intrinsic[..., 1, 2]
  f = (intrinsic[..., 0, 0] + intrinsic[..., 1, 1]) / 2
  return torch.stack([(px - cx + 0.5) / f, -(py - cy + 0.5) / f,
                      -torch.ones_like(px)], dim=-1)


def pixels_to_rays(px, py, c2w, intrinsic, near, far, app=None,
                   lossmult=None) -> Rays:
  """Build a Rays bundle from pixel coords + per-ray camera params.

  px, py: [...] float (x = column, y = row); c2w: [..., 3, 4];
  intrinsic: [..., 3, 3]; near/far: scalars or [...]. The mip base
  radius is the closed form 2 / (f sqrt(12)): for a pinhole camera the
  neighbour-direction spacing is exactly 1/f.
  """
  cam_dirs = camera_dirs_from_pixels(px, py, intrinsic)
  directions = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], cam_dirs)
  origins = c2w[..., :3, 3].expand(directions.shape)
  viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)

  f = (intrinsic[..., 0, 0] + intrinsic[..., 1, 1]) / 2
  radii = (1.0 / f * 2.0 / math.sqrt(12.0))[..., None]
  radii = radii.expand(*directions.shape[:-1], 1)

  ones = torch.ones(*directions.shape[:-1], 1, dtype=directions.dtype,
                    device=directions.device)
  as_ray = lambda v: torch.as_tensor(
      v, dtype=directions.dtype, device=directions.device).expand(ones.shape)
  if app is None:
    app = torch.zeros(ones.shape, dtype=torch.int32, device=ones.device)
  else:
    app = torch.as_tensor(app, device=ones.device)[..., None].expand(
        ones.shape).to(torch.int32)
  return Rays(origins=origins, directions=directions, viewdirs=viewdirs,
              radii=radii, lossmult=ones if lossmult is None else lossmult,
              near=as_ray(near), far=as_ray(far), app=app)


def rays_for_image(c2w, intrinsic, H: int, W: int, near, far, app=None,
                   render_factor: int = 0) -> Rays:
  """Full-image ray grid [H, W] on c2w's device.

  render_factor > 0 downsamples by that integer factor (render preview).
  """
  device = c2w.device
  if render_factor:
    H2, W2 = H // render_factor, W // render_factor
    ys = (torch.arange(H2, device=device) + 0.5) * (H / H2) - 0.5
    xs = (torch.arange(W2, device=device) + 0.5) * (W / W2) - 0.5
  else:
    ys = torch.arange(H, dtype=torch.float32, device=device)
    xs = torch.arange(W, dtype=torch.float32, device=device)
  py, px = torch.meshgrid(ys, xs, indexing="ij")
  rays = pixels_to_rays(px, py, c2w, intrinsic, near, far, app=app)
  if render_factor:
    # Each downscaled pixel covers factor^2 original pixels: widen the
    # mip base radius to the pixel area actually integrated.
    scale = ((H / H2) + (W / W2)) / 2.0
    rays.radii = rays.radii * scale
  return rays
