"""Evaluation entry point of the port (counterpart of eval.py):

  python -m snerf_tpu_torch.cli.eval --config <file> [--key value ...]
      [--device cuda|cpu]

Rebuilds the train-time flags from the experiment's args.txt, restores
the newest checkpoint (or `--ckpt N`), renders the test split (or the
train split with `--eval_test False`) chunk by chunk, optionally after
test-time pose refinement (`--test_refine_iter`), and writes under
<exp_dir>/testset_<step:06d>: `<ti:03d>.png`, `<ti:03d>_depth.npy`,
`<ti:03d>_semantic.npy` (semantic models) and `metrics.json` (per-image
PSNR/SSIM, with `--lpips` the VGG feature distance too; the PSNR and
SSIM means, mIoU when semantic, eval rays/s), the keys of eval.py's.
Products are float32 (TF32 off). `--scan_render` raises
(`cli.common.reject_scan_render`).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from snerf_tpu_torch.cli import common
from snerf_tpu_torch.data.png import resize_bilinear, write_png
from snerf_tpu_torch.flags import load_config_with_snapshot
from snerf_tpu_torch.train import checkpoints as ckpt_lib
from snerf_tpu_torch.train.renderer import render_image
from snerf_tpu_torch.train.zip_trainer import eval_weights
from snerf_tpu_torch.utils.metrics import MetricHarness, MiouEvaluator


def refine_test_poses(model, scene, idxs, device, n_iters: int = 100,
                      n_rays: int = 1024, white_bkgd: bool = False):
  """Photometric test-time pose refinement (eval.py `refine_test_poses`,
  reference eval.py:82-114): freeze the NeRF, learn one SE(3) delta per
  test image with Adam (lr 1e-3) on the rgb loss of n_rays random pixels
  of one random test image a step, drawn from a torch.Generator seeded 1
  (JAX: PRNGKey(1)). Returns the refined [n, 3, 4] poses (numpy)."""
  from snerf_tpu_torch.data.raygen import pixels_to_rays
  from snerf_tpu_torch.models.posenet import LearnPose
  from snerf_tpu_torch.train.trainer import adam

  n = len(idxs)
  H, W = scene.hw
  as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
  init_poses = as_t(scene.poses[idxs])
  images = torch.as_tensor(scene.images[idxs], device=device)
  Ks = as_t(scene.intrinsics[idxs])
  cams = torch.arange(n, device=device)
  pose_model = LearnPose(n, device=device)
  opt = adam(pose_model.parameters(), 1e-3)
  gen = torch.Generator(device=device).manual_seed(1)
  frozen = [p for p in model.parameters() if p.requires_grad]
  for p in frozen:
    p.requires_grad_(False)
  try:
    for _ in range(n_iters):
      img_i = int(torch.randint(0, n, (), generator=gen, device=device))
      pix = torch.randint(0, H * W, (n_rays,), generator=gen, device=device)
      py, px = pix // W, pix % W
      opt.zero_grad(set_to_none=True)
      table = pose_model(cams, init_poses)
      rays = pixels_to_rays(px.float(), py.float(), table[img_i], Ks[img_i],
                            scene.near, scene.far)
      rgb = model(rays, white_bkgd=white_bkgd)[-1]["rgb"]
      tgt = images[img_i, py, px].float() / 255.0
      torch.mean((rgb - tgt) ** 2).backward()
      opt.step()
  finally:
    for p in frozen:
      p.requires_grad_(True)
  with torch.no_grad():
    return pose_model(cams, init_poses).cpu().numpy()


def main(argv=None):
  argv, extra = common.split_flags(argv, {"device": "cuda"})
  device = common.resolve_device(extra["device"])
  common.float32_numerics()
  cfg = load_config_with_snapshot(argv)
  common.reject_scan_render(argv, cfg)
  exp_dir = cfg.exp_dir()
  ckpt_dir = os.path.join(exp_dir, "checkpoints")
  harness = MetricHarness(lpips=cfg.lpips, device=device)

  scene = common.load_scene(cfg)
  model, state = common.build_model_state(cfg, scene.num_images, device)
  state, restored = ckpt_lib.restore_checkpoint(
      ckpt_dir, state, step=None if cfg.ckpt < 0 else cfg.ckpt)
  if restored is None:
    raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
  print(f"evaluating checkpoint step {restored}")
  out_dir = os.path.join(exp_dir, f"testset_{restored:06d}")
  os.makedirs(out_dir, exist_ok=True)
  idxs = np.asarray(scene.i_test if cfg.eval_test else scene.i_train)

  with eval_weights(state):
    refined = None
    if cfg.test_refine_iter > 0 and cfg.model != "zipnerf":
      refined = refine_test_poses(
          model, scene, idxs, device, n_iters=cfg.test_refine_iter,
          n_rays=min(cfg.N_rgb, 1024), white_bkgd=cfg.white_bkgd)
      print(f"refined {len(idxs)} test poses ({cfg.test_refine_iter} "
            "iters)")
    summary = _eval_views(cfg, scene, model, idxs, refined, harness,
                          out_dir, device)
  summary = {"step": int(restored), **summary}
  with open(os.path.join(out_dir, "metrics.json"), "w") as f:
    json.dump(summary, f, indent=2)
  print(f"mean: psnr={summary['mean_psnr']:.2f} "
        f"ssim={summary['mean_ssim']:.4f}")
  return summary


def _eval_views(cfg, scene, model, idxs, refined, harness, out_dir, device):
  render_fn = common.render_fn_for(cfg, model)
  H, W = scene.hw
  miou_eval = None
  if cfg.semantic and scene.semantics is not None:
    miou_eval = MiouEvaluator(cfg.semantic_class_num)
  results = []
  t_eval0 = time.perf_counter()
  t_steady0 = None
  rays_done = steady_rays = 0
  for pos, ti in enumerate(idxs):
    if pos == 1:
      t_steady0 = time.perf_counter()
    pose = refined[pos] if refined is not None else scene.poses[ti]
    rays = common.image_rays(scene, pose, scene.intrinsics[ti], device, H, W,
                             render_factor=cfg.render_factor)
    out = render_image(render_fn, rays, chunk=cfg.chunk)
    gt = scene.images[ti].astype(np.float32) / 255.0
    if cfg.render_factor:
      gt = resize_bilinear(gt, out["rgb"].shape[0], out["rgb"].shape[1])
    m = harness(out["rgb"], torch.as_tensor(gt, device=out["rgb"].device))
    out = common.to_numpy(out)
    results.append({"img": int(ti), **m})
    n_rays = out["rgb"].shape[0] * out["rgb"].shape[1]
    rays_done += n_rays
    if pos >= 1:
      steady_rays += n_rays
    print(f"img {ti}: psnr={m['psnr']:.2f} ssim={m['ssim']:.4f}")
    if miou_eval is not None and "semantic" in out:
      pred_lab = np.argmax(out["semantic"], axis=-1)
      gt_lab = scene.semantics[ti]
      if gt_lab.shape == pred_lab.shape and (gt_lab >= 0).any():
        miou_eval.add_batch(gt_lab[gt_lab >= 0], pred_lab[gt_lab >= 0])
    write_png(os.path.join(out_dir, f"{ti:03d}.png"),
              (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
    np.save(os.path.join(out_dir, f"{ti:03d}_depth.npy"),
            out["distance"][..., 0])
    if "semantic" in out:
      np.save(os.path.join(out_dir, f"{ti:03d}_semantic.npy"),
              np.argmax(out["semantic"], axis=-1).astype(np.int32))

  now = time.perf_counter()
  summary = {"mean_psnr": float(np.mean([r["psnr"] for r in results])),
             "mean_ssim": float(np.mean([r["ssim"] for r in results])),
             "eval_rays_per_sec": round(
                 rays_done / max(now - t_eval0, 1e-9), 1),
             "per_image": results}
  if t_steady0 is not None and steady_rays:
    # the first image carries the first-call costs; warm throughput too
    summary["eval_rays_per_sec_warm"] = round(
        steady_rays / max(now - t_steady0, 1e-9), 1)
  if miou_eval is not None:
    summary["miou"] = miou_eval.miou()
    print(f"mIoU = {summary['miou']:.4f}")
  msg = f"eval rays/sec = {summary['eval_rays_per_sec']:.0f}"
  if "eval_rays_per_sec_warm" in summary:
    msg += f" (warm: {summary['eval_rays_per_sec_warm']:.0f})"
  print(msg)
  return summary


if __name__ == "__main__":
  main(sys.argv[1:])
