"""Training-batch sampling from a device-resident scene (counterpart of
snerf_tpu/data/sampler.py).

The scene's tensors live on the device; each step gathers `batch_size`
pixels there. The image and pixel indices come from a torch.Generator,
or are injected (`img_idx`, `py`, `px`) so that a test can feed both
packages the same draws. Not ported: the bbox-restricted foreground
branch (`--block_bg`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_port.reference.data import raygen


def sample_patch_coords(H: int, W: int, n_patches: int, patch_size: int,
                        generator: torch.Generator):
  """Top-left-anchored square patches: (py, px), each [n * ps * ps], on
  the generator's device."""
  kw = dict(generator=generator, device=generator.device)
  y0 = torch.randint(0, H - patch_size, (n_patches,), **kw)
  x0 = torch.randint(0, W - patch_size, (n_patches,), **kw)
  ar = torch.arange(patch_size, device=y0.device)
  dy, dx = torch.meshgrid(ar, ar, indexing="ij")
  py = (y0[:, None, None] + dy[None]).reshape(-1)
  px = (x0[:, None, None] + dx[None]).reshape(-1)
  return py, px


def draw_pixels(images: torch.Tensor, i_train, batch_size: int,
                single_image: bool, n_patches: int, patch_size: int,
                generator: torch.Generator):
  """The (img_idx, py, px) of one batch, each [batch_size + n_patches *
  patch_size**2], drawn from `generator` on the images' device: one
  random train image for the whole batch (single_image) or one per ray,
  uniform pixels, then the patches."""
  dev = images.device
  N, H, W = images.shape[:3]
  i_train = torch.as_tensor(i_train, dtype=torch.long, device=dev)
  kw = dict(generator=generator, device=dev)
  if single_image:
    sel = i_train[torch.randint(0, i_train.shape[0], (1,), **kw)]
    img_idx = sel.expand(batch_size)
  else:
    img_idx = i_train[torch.randint(0, i_train.shape[0], (batch_size,),
                                    **kw)]
  pix_flat = torch.randint(0, H * W, (batch_size,), **kw)
  py, px = pix_flat // W, pix_flat % W
  if n_patches > 0:
    ppy, ppx = sample_patch_coords(H, W, n_patches, patch_size, generator)
    if single_image:
      pidx = img_idx[:1].expand(ppy.shape[0])
    else:
      pidx = torch.repeat_interleave(img_idx[:n_patches],
                                     patch_size * patch_size)
    py, px = torch.cat([py, ppy]), torch.cat([px, ppx])
    img_idx = torch.cat([img_idx, pidx])
  return img_idx, py, px


def sample_batch(device_scene: Dict[str, torch.Tensor], i_train,
                 batch_size: int, near: float, far: float,
                 single_image: bool = True, n_patches: int = 0,
                 patch_size: int = 8,
                 use_pose_table: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 img_idx: Optional[torch.Tensor] = None,
                 py: Optional[torch.Tensor] = None,
                 px: Optional[torch.Tensor] = None):
  """Draw one training batch on the scene's device.

  The indices come from `generator` (on the scene's device), or are
  given: img_idx, py, px, each [batch_size + n_patches * patch_size**2]
  (random pixels first, then the patches). use_pose_table: [N, 3, 4]
  poses to use instead of the scene's, e.g. a refined table that carries
  grad (it is not detached). Returns (rays, targets): targets has rgb
  [B, 3] in [0, 1], img_idx, py, px, cam_index and, where the scene has
  them, depth, skymask, semantic.
  """
  imgs = device_scene["images"]
  dev = imgs.device
  if "bboxes" in device_scene:
    raise NotImplementedError("the bbox-restricted foreground sampling "
                              "(--block_bg) is not ported yet")
  if img_idx is None:
    if generator is None:
      raise ValueError("sample_batch needs a generator or injected indices")
    img_idx, py, px = draw_pixels(imgs, i_train, batch_size, single_image,
                                  n_patches, patch_size, generator)
  elif py is None or px is None:
    raise ValueError("inject img_idx, py and px together")
  img_idx, py, px = (torch.as_tensor(v, device=dev).long()
                     for v in (img_idx, py, px))

  poses = use_pose_table if use_pose_table is not None \
      else device_scene["poses"]
  c2w = poses[img_idx]
  K = device_scene["intrinsics"][img_idx]
  rays = raygen.pixels_to_rays(px.float(), py.float(), c2w, K, near, far,
                               app=img_idx)
  targets = {
      "rgb": imgs[img_idx, py, px].float() / 255.0,
      "img_idx": img_idx,
      "py": py,
      "px": px,
  }
  if "depths" in device_scene:
    targets["depth"] = device_scene["depths"][img_idx, py, px]
  if "skymask" in device_scene:
    targets["skymask"] = device_scene["skymask"][img_idx, py, px]
  if "semantics" in device_scene:
    targets["semantic"] = device_scene["semantics"][img_idx, py, px]
  targets["cam_index"] = device_scene["cam_index"][img_idx]
  return rays, targets
