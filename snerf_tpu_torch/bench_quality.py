"""Held-out quality cells of the port (counterpart of bench_quality.py):

  python -m snerf_tpu_torch.bench_quality [--families mip zip_hash ...]
      [--steps 2000] [--batch 2048] [--seeds 0 1 2] [--out FILE]

Trains each family for a fixed step budget on the committed
realistic-focal fixture (tests/fixtures/nuscenes_realfocal, loaded as
bench_quality.py loads it: bd_factor 0, datahold 8, no_align) and prints
one JSON line per (family, seed) with bench_quality.py's keys (family,
steps, batch, seed, wall_s, rays_per_sec, psnr on the first two held-out
views, train_psnr, curve) and `device`, the card's name and power limit
as nvidia-smi gives them. Runs on a CUDA card only.

Families (bench_quality.py's, at its widths and kwargs):
  mip       64 + 64 samples, width 512 (proposal 256), max_deg 16, depth
            loss on, lr 2e-3 -> 2e-4 without warm-up;
  zip_*     (32, 32) + 16 samples, sample_n 4, power transformation,
            float32 MLPs, as JAX's cells train them (its
            zip_compute_dtype float32; the shipped configs train
            bf16), no EMA:
    zip_hash             10 hash levels of 2^19 rows, lr 8e-3 -> 8e-4;
    the rest at lr 2e-3 -> 2e-4 with the encoder tables at 4x:
    zip_ipe              the IPE to degree 12 into a 4 x 256 trunk;
    zip_aniso            the IPE of one cylinder cast an interval through
                         the contraction (ipe_anisotropic), to degree 16,
                         into an 8 x 512 trunk with a skip after layer 4
                         and a 512-wide density layer, scene_scale 0.2725;
    zip_cp, zip_cp_hash  the CP grid (4 levels of 16 features, 128 to
                         1,024) with the IPE (cp_ipe), and with one fine
                         hash level of 2^19 rows at 2,048, collapsed, no
                         spread (cp_hash);
    zip_cp_aniso         cp_hash with zip_aniso's cast and trunk and
                         density_zero_init;
    zip_cp_aniso_center  that with the CP features centered (the shipped
                         configs/waymo_zipnerf_tpu arm at F 16).
Seeds: the init from `seed`, the training draws from `seed + 1`, as the
JAX script splits PRNGKey(seed) and PRNGKey(seed + 1) (so adjacent seeds
share streams there too: ROADMAP Queue 3, item 8). As there, one step
runs before the clock starts (JAX's compile step), so a cell takes
steps + 1 updates. The clock pauses at each milestone's render.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "nuscenes_realfocal")
# the aniso arms' cast and trunk (bench_quality.py's overrides)
_ANISO_TRUNK = dict(ipe_skip_layer=4, density_hidden_width=512,
                    ipe_density_width=512, ipe_density_depth=8, ipe_max_deg=16,
                    scene_scale=0.2725)
ZIP_FAMILIES = {
    "zip_hash": dict(encoder_type="hash"),
    "zip_ipe": dict(encoder_type="ipe"),
    "zip_aniso": dict(encoder_type="ipe", ipe_anisotropic=True,
                      **_ANISO_TRUNK),
    "zip_cp": dict(encoder_type="cp_ipe"),
    "zip_cp_hash": dict(encoder_type="cp_hash"),
    "zip_cp_aniso": dict(encoder_type="cp_hash", cp_anisotropic=True,
                         density_zero_init=True, **_ANISO_TRUNK),
    "zip_cp_aniso_center": dict(encoder_type="cp_hash", cp_anisotropic=True,
                                density_zero_init=True, cp_feature_center=True,
                                **_ANISO_TRUNK),
}
FAMILIES = ("mip",) + tuple(ZIP_FAMILIES)
EVAL_VIEWS = 2
CHUNK = 4096
MILESTONES = (0.25, 0.5, 1.0)


def load_fixture(datahold: int = 8):
  from snerf_tpu_torch.data.scene import load_nuscenes_scene
  return load_nuscenes_scene(FIXTURE, bd_factor=0.0, cam_num=0,
                             datahold=datahold, no_align=True)


def render_psnr(render_fn, scene, idxs, device) -> float:
  """Mean PSNR of the rgb of `render_fn` over the views `idxs`, rendered
  in chunks of CHUNK rays."""
  from snerf_tpu_torch.cli.common import image_rays
  from snerf_tpu_torch.train.renderer import render_image
  H, W = scene.hw
  psnrs = []
  for ti in idxs:
    rays = image_rays(scene, scene.poses[ti], scene.intrinsics[ti], device,
                      H, W)
    pred = render_image(render_fn, rays, chunk=CHUNK)["rgb"].cpu().numpy()
    gt = scene.images[ti].astype(np.float32) / 255.0
    psnrs.append(-10 * np.log10(float(np.mean((pred - gt) ** 2))))
  return float(np.mean(psnrs))


def milestone_steps(steps, milestones):
  # the final step is always a milestone (it closes the train clock)
  return sorted({max(1, int(round(steps * f)))
                 for f in milestones} | {steps})


def mip_setup(scene, steps, batch, device, seed=0, overrides=None):
  """(model, state, step) of the mip family."""
  from snerf_tpu_torch.data.sampler import scene_to_device
  from snerf_tpu_torch.models.mipnerf import MipNerfConfig
  from snerf_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                             make_train_step)
  mkw = dict(num_samples=64, num_fine=64, hidden_layer=512,
             proposal_hidden_layer=256, density_noise=0.0, max_deg_point=16)
  mkw.update(overrides or {})
  tcfg = TrainConfig(n_rgb=batch, depth_loss=True, lrate=2e-3,
                     lrate_final=2e-4, lrate_delay_steps=0, n_iters=steps)
  model, pose_model, state = create_train_state(
      seed, MipNerfConfig(**mkw), tcfg, scene.num_images, device=device)
  step = make_train_step(model, pose_model, tcfg,
                         scene_to_device(scene, device), scene.i_train,
                         scene.near, scene.far)
  return model, state, step


def zip_setup(scene, steps, batch, device, seed=0, overrides=None,
              family="zip_hash"):
  """(model, state, step) of a zip family, with bench_quality.py's
  encoder kwargs and learning rates."""
  from snerf_tpu_torch.data.sampler import scene_to_device
  from snerf_tpu_torch.models.zipnerf import ZipNerfConfig
  from snerf_tpu_torch.train.zip_trainer import (ZipTrainConfig,
                                                 create_zip_train_state,
                                                 make_zip_train_step)
  fam = ZIP_FAMILIES[family]
  encoder = fam["encoder_type"]
  kw = dict(num_prop_samples=(32, 32), num_nerf_samples=16, sample_n=4,
            raydist_fn="power_transformation")
  lr, mult = 2e-3, 4.0
  if encoder == "hash":
    kw.update(grid_num_levels=10, grid_log2_hashmap_size=19)
    lr, mult = 8e-3, 1.0
  elif encoder.startswith("cp"):
    kw.update(cp_num_levels=4, cp_level_dim=16, cp_base_resolution=128,
              cp_max_resolution=1024, ipe_max_deg=12)
    if encoder == "cp_hash":
      kw.update(cp_hash_resolution=2048, cp_hash_log2=19,
                cp_hash_use_spread=False)
  kw.update(fam)
  kw.update(overrides or {})
  tcfg = ZipTrainConfig(batch_size=batch, max_steps=steps, lr_init=lr,
                        lr_final=lr / 10, lr_delay_steps=0, lr_delay_mult=1.0,
                        encoder_lr_mult=mult, ema_decay=0.0,
                        depth_loss_mult=0.0)
  state = create_zip_train_state(seed, ZipNerfConfig(**kw), tcfg,
                                 device=device)
  step = make_zip_train_step(state.model, tcfg,
                             scene_to_device(scene, device), scene.i_train,
                             scene.near, scene.far)
  return state.model, state, step


def run_family(family, scene, steps, batch, device, seed=0, overrides=None):
  """Train one cell and render it at its milestones. `overrides` replace
  fields of the model config (a cell cut down to run on a CPU). Returns
  dict(wall_s, rays_per_sec, psnr, train_psnr, curve)."""
  from snerf_tpu_torch.train.renderer import (make_eval_render_fn,
                                              make_zip_eval_render_fn)
  if family == "mip":
    model, state, step = mip_setup(scene, steps, batch, device, seed,
                                   overrides)
  else:
    model, state, step = zip_setup(scene, steps, batch, device, seed,
                                   overrides, family)
  render_fn = (make_eval_render_fn(model) if family == "mip"
               else make_zip_eval_render_fn(model))
  gen = torch.Generator(device=device).manual_seed(seed + 1)
  sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
      else (lambda: None)
  float(step(state, gen)["loss"])      # JAX's compile step
  marks = milestone_steps(steps, MILESTONES)
  curve, train_psnr, wall = [], 0.0, 0.0
  sync()
  t0 = time.perf_counter()
  for i in range(1, steps + 1):
    m = step(state, gen)
    if i % 100 == 0:
      train_psnr = float(m["psnr"])
      if not np.isfinite(float(m["loss"])):
        raise FloatingPointError(f"{family}: loss {float(m['loss'])} at "
                                 f"step {i}")
    if i in marks:
      sync()
      wall += time.perf_counter() - t0   # pause the train clock
      p = render_psnr(render_fn, scene,
                      np.asarray(scene.i_test)[:EVAL_VIEWS], device)
      curve.append({"step": i, "wall_s": round(wall, 1),
                    "psnr": round(p, 2)})
      sync()
      t0 = time.perf_counter()
  return dict(wall_s=wall, rays_per_sec=batch * steps / wall,
              psnr=curve[-1]["psnr"], train_psnr=train_psnr, curve=curve)


def card_info():
  """{"name", "power_limit"} of the card from nvidia-smi."""
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
  name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
  return {"name": name.strip(), "power_limit": limit.strip()}


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--families", nargs="+", default=["mip", "zip_hash"],
                  choices=FAMILIES)
  ap.add_argument("--steps", type=int, default=2000)
  ap.add_argument("--batch", type=int, default=2048)
  ap.add_argument("--seeds", type=int, nargs="+", default=[0])
  ap.add_argument("--out", type=str, default="")
  args = ap.parse_args(argv)
  from snerf_tpu_torch.cli.common import resolve_device
  device = resolve_device("cuda")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_info()
  scene = load_fixture()
  lines = []
  for fam in args.families:
    for seed in args.seeds:
      r = run_family(fam, scene, args.steps, args.batch, device, seed=seed)
      rec = {"family": fam, "steps": args.steps, "batch": args.batch,
             "seed": seed, "wall_s": round(r["wall_s"], 1),
             "rays_per_sec": round(r["rays_per_sec"]),
             "psnr": round(r["psnr"], 2),
             "train_psnr": round(r["train_psnr"], 2),
             "curve": r["curve"], "device": card}
      line = json.dumps(rec)
      print(line, flush=True)
      lines.append(line)
      if args.out:
        with open(args.out, "w") as f:
          f.write("\n".join(lines) + "\n")
      torch.cuda.empty_cache()


if __name__ == "__main__":
  main()
