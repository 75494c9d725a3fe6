#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snerf_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. float32 numerics: TF32 off for matmuls and cuDNN;
  3. build: every kernel of the render path, from csrc/, with nvcc;
  4. kernel against plain: the fused-MLP kernel against fused_mlp_plain on
     the card at the render path's shapes, a ragged N, bf16, both
     last_relu settings; max error beside its tolerance, CUDA-event times;
  5. slice: the shipped nuScenes_depth_6cams model at full width with a
     seeded init renders 2 held-out views of the synthetic scene through
     make_eval_render_fn / render_image (chunk 4096); the outputs must be
     finite with acc in [0, 1], the kernel must have been launched, and one
     chunk must agree with a model sharing the weights whose MLP stacks
     run the plain PyTorch version.
The last line is {"ok": true, "device": {...}}; without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 4096 * 128          # one chunk of rays x 128 samples
# (atol, rtol). f32: the kernel's 3xTF32 products are ~2^-21 relative, but
# the tensor cores' f32 accumulation truncates; over 384 MMA steps a row
# (D = 1024) that drifts ~3e-5 on O(1) outputs.
F32_TOL = (1e-4, 1e-4)
BF16_TOL = (2e-2, 2e-2)    # a bf16 rounding flip after any layer (2^-8 rel.)
RENDER_TOL = 1e-3          # rgb/acc absolute, distance relative


class SmokeFailure(RuntimeError):
  pass


def check(cond, msg):
  if not cond:
    raise SmokeFailure(msg)


def log(*args):
  print(*args, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
  check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
  return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters):
  """Mean ms per call over `iters` calls, by CUDA events."""
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def kernel_case(torch, fused_mlp, fused_mlp_plain, name, n, d, n_layers,
                dtype, last_relu, iters):
  gen = torch.Generator(device="cuda").manual_seed(n * 7 + d + n_layers)
  dev = "cuda"
  x = (torch.randn(n, d, generator=gen, device=dev) * 0.5).to(dtype)
  limit = (6.0 / (2 * d)) ** 0.5
  w = ((torch.rand(n_layers, d, d, generator=gen, device=dev) * 2 - 1)
       * limit).to(dtype)
  b = ((torch.rand(n_layers, 1, d, generator=gen, device=dev) * 2 - 1)
       * 0.1).to(dtype)
  got = fused_mlp(x, w, b, last_relu)
  want = fused_mlp_plain(x, w, b, last_relu)
  torch.cuda.synchronize()
  atol, rtol = F32_TOL if dtype == torch.float32 else BF16_TOL
  diff = (got.float() - want.float()).abs()
  err = float(diff.max())
  scale = float(want.float().abs().max())
  ok = bool((diff <= atol + rtol * want.float().abs()).all())
  finite = bool(torch.isfinite(got.float()).all())
  # in turns: plain, kernel, kernel, plain
  p1 = time_ms(torch, lambda: fused_mlp_plain(x, w, b, last_relu), iters)
  k1 = time_ms(torch, lambda: fused_mlp(x, w, b, last_relu), iters)
  k2 = time_ms(torch, lambda: fused_mlp(x, w, b, last_relu), iters)
  p2 = time_ms(torch, lambda: fused_mlp_plain(x, w, b, last_relu), iters)
  k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
  flop = 2.0 * n * d * d * n_layers
  log(f"  {name}: N={n} D={d} L={n_layers} {str(dtype)[6:]} "
      f"last_relu={last_relu}: max_abs_err={err:.3e} (max|plain| "
      f"{scale:.3e}) "
      f"(tol atol={atol} rtol={rtol}) kernel {k_ms:.3f} ms "
      f"({flop / k_ms / 1e9:.1f} TFLOP/s) plain {p_ms:.3f} ms "
      f"({flop / p_ms / 1e9:.1f} TFLOP/s) [{k1:.3f}/{k2:.3f} vs "
      f"{p1:.3f}/{p2:.3f}]")
  check(finite, f"{name}: kernel output not finite")
  check(ok, f"{name}: kernel disagrees with plain (max abs err {err})")
  del x, w, b, got, want, diff
  torch.cuda.empty_cache()
  return dict(err=err, ms=k_ms, plain_ms=p_ms)


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
          "needs a CUDA card", file=sys.stderr)
    return 1

  from snerf_tpu_torch.config import load_config, model_config
  from snerf_tpu_torch.data.raygen import rays_for_image
  from snerf_tpu_torch.data.synthetic import make_synthetic_scene
  from snerf_tpu_torch.models.mipnerf import MipNerfModel
  from snerf_tpu_torch.ops import fused_mlp as fm
  from snerf_tpu_torch.train.renderer import make_eval_render_fn, render_image
  from snerf_tpu_torch.utils.weights import glorot_init_

  # 1. device
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
      f" | {torch.cuda.device_count()} device(s)")

  # 2. numerics
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # 3. build
  t0 = time.perf_counter()
  so, build_log = fm.build()
  log(f"[build] {os.path.relpath(so, ROOT)} in "
      f"{time.perf_counter() - t0:.1f} s")
  for line in build_log.splitlines():
    if "registers" in line or "spill" in line or "error" in line:
      log(f"  {line.strip()}")

  # 4. kernel against plain
  log("[kernel] fused_mlp (CUDA) against fused_mlp_plain")
  f32, bf16 = torch.float32, torch.bfloat16
  cases = [
      ("fine trunk_1..4", ROWS, 1024, 4, f32, True, 3),
      ("fine trunk_6..7", ROWS, 1024, 2, f32, True, 3),
      ("proposal trunk_1..3", ROWS, 256, 3, f32, True, 5),
      ("ragged", 4096 * 127 + 5, 1024, 2, f32, False, 2),
      ("ragged small", 777, 256, 3, f32, False, 5),
      ("bf16", ROWS, 1024, 4, bf16, True, 3),
      ("bf16 ragged", 777, 256, 3, bf16, False, 5),
  ]
  results = {c[0]: kernel_case(torch, fm.fused_mlp, fm.fused_mlp_plain, *c)
             for c in cases}

  # 5. slice
  cfg = load_config(["--config",
                     os.path.join(ROOT, "configs", "nuScenes_depth_6cams")])
  mcfg = model_config(cfg)
  log(f"[slice] nuScenes_depth_6cams: hidden {mcfg.hidden_layer} rgb_layer "
      f"{mcfg.rgb_layer} proposal {mcfg.proposal_hidden_layer} samples "
      f"{mcfg.num_samples}/{mcfg.num_fine} {mcfg.ray_shape} warp_fn "
      f"{mcfg.warp_fn} {mcfg.t_transform} deg {mcfg.max_deg_point} chunk "
      f"{cfg.chunk}")
  model = glorot_init_(MipNerfModel(mcfg, device="cuda"), seed=0).eval()
  plain_model = MipNerfModel(mcfg, stack_fn=fm.fused_mlp_plain,
                             device="cuda").eval()
  plain_model.load_state_dict(model.state_dict())
  H, W = 96, 128
  scene = make_synthetic_scene(num_images=6, H=H, W=W)
  views = list(scene.i_test)[:2]
  check(len(views) == 2, f"expected 2 held-out views, got {views}")
  render_fn = make_eval_render_fn(model, white_bkgd=cfg.white_bkgd)

  def view_rays(i):
    return rays_for_image(torch.from_numpy(scene.poses[i]).cuda(),
                          torch.from_numpy(scene.intrinsics[i]).cuda(),
                          H, W, scene.near, scene.far)

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  fm.fused_mlp.launches = 0
  outs, secs = [], []
  for i in views:
    rays = view_rays(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs.append(render_image(render_fn, rays, chunk=cfg.chunk))
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
  launches = fm.fused_mlp.launches
  peak = torch.cuda.max_memory_allocated()
  n_chunks = len(views) * -(-H * W // cfg.chunk)
  for i, out, s in zip(views, outs, secs):
    rgb, acc, dist = out["rgb"], out["acc"], out["distance"]
    log(f"  view {i}: {H}x{W} in {s:.3f} s = {H * W / s:.1f} rays/s; "
        f"rgb mean {float(rgb.mean()):.4f} acc mean {float(acc.mean()):.4f} "
        f"distance mean {float(dist.mean()):.4f}")
    check(tuple(rgb.shape) == (H, W, 3), f"rgb shape {tuple(rgb.shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          f"view {i}: non-finite output")
    check(float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-5,
          f"view {i}: acc outside [0, 1]: {float(acc.min())} "
          f"{float(acc.max())}")
  log(f"  fused_mlp launches on the render path: {launches} "
      f"(3 per chunk x {n_chunks} chunks expected)")
  check(launches > 0, "the render path did not launch the fused_mlp kernel")
  log(f"  render rate (2nd view, steady): {H * W / secs[-1]:.1f} rays/s; "
      f"peak device memory {peak / 2**30:.3f} GiB "
      f"(torch.cuda.max_memory_allocated) | {card}")

  chunk_rays = view_rays(views[0]).reshape(-1).map(
      lambda t: t[:cfg.chunk])
  got = render_fn(chunk_rays)
  want = make_eval_render_fn(plain_model, white_bkgd=cfg.white_bkgd)(
      chunk_rays)
  errs = {k: float((got[k] - want[k]).abs().max()) for k in ("rgb", "acc")}
  errs["distance_rel"] = float(((got["distance"] - want["distance"]).abs()
                                / want["distance"].abs()).max())
  log(f"  one chunk, kernel model vs plain-stack model: {errs} "
      f"(tol {RENDER_TOL})")
  check(all(v <= RENDER_TOL for v in errs.values()),
        f"kernel render disagrees with the plain stack: {errs}")

  main_case = results["fine trunk_1..4"]
  f32_err = max(results[c[0]]["err"] for c in cases if c[4] == f32)
  log(json.dumps({"kernels": [{
      "name": "fused_mlp", "route": "cuda",
      "source": "snerf_tpu_torch/csrc/fused_mlp.cu",
      "replaces": "snerf_tpu/ops/pallas/fused_mlp.py:66",
      "launches": launches, "max_abs_err": f32_err,
      "ms": main_case["ms"], "plain_ms": main_case["plain_ms"]}]}))
  log(card)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
