#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snerf_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. float32 numerics: TF32 off for matmuls and cuDNN;
  3. build: every kernel in csrc/, one nvcc process each, all at once;
     the ptxas lines (registers, spills); the SASS of K1's f32 forward
     and dgrad kernels (cuobjdump -sass) must hold wgmma (HGMMA) and TMA
     loads (UTMALDG);
  4. kernel K1 against plain: tf32_split bit-equal to tf32_split_plain at
     the fine and proposal trunks' weight shapes and on special values
     (signed zeros, inf, NaN, subnormals, ties); the fused-MLP kernel
     against fused_mlp_plain on the card at the mip render path's shapes,
     a ragged N, bf16, both last_relu settings; max error beside its
     tolerance, CUDA-event times, TFLOP/s and the share of the bound;
  4b. kernel K2 against plain: the hash-grid row gather against
     table[idx] at the zip paths' shapes (a hashed level's own 2^21 rows
     of the nerf and prop_mlp_1 tables at the render chunk of 8192 rays
     and the train batch of 32768), a stress case over the whole nerf
     table, a ragged N, C in {2, 8}, the TPU kernel's shape, the edge rows
     0 and T-1; exact equality, CUDA-event times, GB/s and the bound;
  4c. K2's scatter-add backward against scatter_add_rows_plain
     (index_add_) and an f64 index_add_ control, at the zip train step's
     shapes (a dense and a hashed level of prop_mlp_0, C = 1, and of the
     nerf MLP, C = 4, each into its level's own gradient), a ragged Q, C =
     3 into a sub-range of the rows and the TPU kernel's 4,992-row table;
     error / max|control| within SCATTER_TOL, no update outside the drawn
     rows, CUDA-event times, GB/s and per-level ms;
  4d. the gather probes: P1 (take_along_axis along either axis) against
     torch.take_along_dim and P2 (the shared-memory gather-select) against
     Tensor.gather, bit-equal, then the probe module's survey of the
     gather primitives (snerf_tpu_torch/probes/gather.py);
  5. mip slice: the shipped nuScenes_depth_6cams model at full width with
     a seeded init renders 2 held-out views of the synthetic scene through
     make_eval_render_fn / render_image (chunk 4096); the outputs must be
     finite with acc in [0, 1], K1 must have been launched, and one chunk
     must agree with a model sharing the weights whose MLP stacks run the
     plain PyTorch version; one chunk is timed against that model and
     broken down under torch.profiler;
  6. zip slice: the shipped waymo_zipnerf model (hash encoder) at full
     width with a seeded init renders the same 2 views through
     make_zip_eval_render_fn / render_image (chunk 8192); the outputs must
     be finite with acc in [0, 1] and semantic rows summing to acc, K2
     must have been launched 30 times a chunk, one chunk must agree with a
     model whose gathers run gather_rows_plain and differ from a render
     with the tables zeroed; one chunk is broken down under
     torch.profiler;
  7a. K1's backward against plain: the dgrad, wgrad and reduce kernels
     against fused_mlp_bwd_plain on the same saved layers at the train
     step's shapes (fine trunk_1..4 and trunk_6..7 at 520,192 rows,
     proposal trunk_1..3 at 524,288), a ragged N and no last ReLU; dx, dW,
     db within a tolerance of max|plain|, two runs bit-identical, the
     forward that keeps its layers bit-equal to the eval forward, CUDA-
     event times and TFLOP/s in turns, each kernel alone (at a fine and
     a proposal layer) against its plain counterpart and one PyTorch
     call (dz @ w.T for dgrad, act.T @ dz for wgrad, TF32 off), and an
     autograd round trip through fused_mlp;
  7b. train slice: the shipped nuScenes_depth_6cams training step at
     full width (depth_conf off, lrate_delay 0) on the same synthetic
     scene, N_rgb 4096, seeded: 2 warm-up and 24 timed steps (s/step,
     rays/s, peak memory, K1 launches per step against the expected
     counts, tf32_split one a forward), finite and falling loss, a
     torch.profiler breakdown of one step, and one step against the
     same weights and draws with the
     stacks' backward plain (every grad within STEP_BWD_TOL) and with
     plain stacks (loss, metrics, every grad), and a non-zero pose grad;
  8. zip train slice: the shipped waymo_zipnerf training step at full
     width (zip_lr_delay 0) on the same scene with semantic labels from
     depth quantiles and an object mask on one corner, batch 32768: 2
     warm-up and 12 timed steps (s/step, rays/s, peak memory, 30 K2
     gathers and 30 scatter-adds a step), a finite and falling loss, a
     torch.profiler breakdown of one step with each scatter-add launch,
     and one step against the same weights whose gathers run the plain
     pair (table[idx] forward, its accumulating scatter-add backward):
     every grad, each hash level's apart, within ZIP_STEP_GRAD_TOL, which
     must sit below the weakest fault reading of the run.
Each phase prints its seconds. The kernels line lists every kernel with
its path's launch counts (the mip train step for fused_mlp, tf32_split
and the three backward kernels, the zip train step for hash_gather and
hash_scatter_add, the survey for the probes), its time at the path's
shapes beside its plain version's, its bound (the larger of its bytes
over HBM_RATE and its operations over their peak rate) and the time of
one PyTorch call computing the same function, where there is one.
The last line is {"ok": true, "device": {...}}; without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 4096 * 128          # one chunk of rays x 128 samples
# (atol, rtol). f32: the kernel's 3xTF32 products are ~2^-21 relative, but
# the tensor cores' f32 accumulation truncates; over 384 MMA steps a row
# (D = 1024) that drifts ~3e-5 on O(1) outputs. On an H100 the wgmma
# kernel reads at most 3.0e-5 (fine trunk_6..7), a control build whose
# forward drops the two small-term products (1xTF32) 6.5e-4 to 9.0e-4
# on every f32 case: the limit sits between.
F32_TOL = (1e-4, 1e-4)
BF16_TOL = (2e-2, 2e-2)    # a bf16 rounding flip after any layer (2^-8 rel.)
# K1's backward against fused_mlp_bwd_plain, as a fraction of max|plain|
# per tensor. The tensor cores' f32 accumulator truncates, so the error
# grows with the MMAs an entry runs: dgrad 384 (D = 1024), wgrad 768 a
# 2,048-row split of N, whose partials are then summed in IEEE f32. On an
# H100 the sound kernels read at most 2.8e-5 (dx, fine trunk_1..4), a
# control build that drops the small-term MMAs of 3xTF32 (plain 1xTF32)
# 1.7e-4 to 6.2e-4 on every tensor (3.9e-4 on dx at L = 2): the limit
# sits between. The same holds with the wgmma dgrad: its 1xTF32 control
# (wgrad left 3xTF32) reads 3.8e-4 to 6.2e-4 on dx and at least 1.7e-4
# on every dW and db downstream of it.
BWD_TOL = 1e-4
# The train slice: warm-up and timed steps, and K1's launches per step:
# forward, one for each uniform run (fine trunk_1..4 and trunk_6..7,
# proposal trunk_1..3), each with one tf32_split of its weights; dgrad,
# wgrad and reduce, one per layer of those runs, 4 + 2 + 3 (every run's
# input carries grad, so layer 0 gets dgrad).
TRAIN_WARMUP, TRAIN_STEPS = 2, 24
K1_FWD_PER_STEP, K1_BWD_PER_STEP = 3, 9
# One step of the kernel model against the same model whose stacks run
# the kernel forward and fused_mlp_bwd_plain on its saved layers: the
# same forward, so the grads differ only by the backward kernels.
# Relative L2 error per tensor, model and poses: on an H100 the sound
# kernels read 4.0e-5, the 1xTF32 control build 2.9e-4.
STEP_BWD_TOL = 1e-4
# One step against the plain-stack model on the same weights and draws.
# Loss and metrics: relative, the kernels' ~3e-5 forward drift averages
# out over 4,096 rays. Grads: relative L2 error per tensor. The plain
# forward makes its own ReLU decisions, and one that flips (a
# pre-activation within ~3e-5 of 0) moves a row of the grads below it
# by O(its size), as phase 7a's unchecked comparison shows; flips are
# sparse, so the L2 error of a model grad stays small (4.1e-4 and 1.1e-3
# read). A pose grad is one image's 3 + 3 sums over its 4,096 rays,
# which cancel: the plain forward alone (kernel backward or not) moved
# them by 2.7e-4 to 1.6e-2 across three states read. This check catches
# wiring (a wrong layer, mask or transpose is O(1)); the one above,
# precision.
# The loss components sum fewer and smaller terms: loss_proposal sums
# max(0, w - w_outer)^2 / w over 127 fine weights of ~1e-3 each, so a
# ~1e-6 change of a weight is ~1e-4 of it; they get 1e-3.
STEP_LOSS_TOL = 1e-5
STEP_METRIC_TOL = 1e-3
STEP_GRAD_TOL = 1e-2
STEP_POSE_TOL = 1e-1
RENDER_TOL = 1e-3          # rgb/acc absolute, distance relative
# The zip render with kernel K2 against plain gathers: a gather copies
# bits, so the two agree exactly unless an op downstream is
# nondeterministic; expected 0.
ZIP_RENDER_TOL = 1e-6
# Hash tables drawn in +-1 instead of the +-1e-4 init: the features then
# sit at O(1), as a trained table's do, so density and colour depend on
# every gathered row and a wrong gather would move the render (at +-1e-4
# it would not; the zeroed-table check below shows the difference).
ZIP_TABLE_SCALE = 1.0
TABLES_MATTER = 1e-3       # min rgb change when the tables are zeroed
# The card's peak rates (H100 SXM data sheet, dense, at 700 W) for the
# bound of each kernel: HBM bytes/s; float32 work outside the tensor cores;
# float32-faithful matrix products as 3xTF32 on the tensor cores (three
# TF32 products per f32 product, 495 TFLOP/s of TF32).
HBM_RATE = 3.35e12
L2_BYTES = 50 * 2**20
F32_RATE = 67e12
F32_MMA_RATE = 495e12 / 3
BF16_MMA_RATE = 989e12
# The scatter-add kernel against an f64 index_add_ control, as a fraction
# of max|control|. Atomics add in a new order on every run, and the plain
# f32 index_add_ (atomic on CUDA too) is off the control by the same kind
# of rounding, printed beside. A row of the dense level 0 sums ~24k N(0, 1)
# updates (|sum| ~ 150), so a missing or doubled update moves it by ~1/150
# of max|control| and a wrong row by O(1): 1e-4 catches either, while f32
# sums of 24k terms in any order stay ~1e-6 off.
SCATTER_TOL = 1e-4
# The zip train slice: warm-up and timed steps; K2 gathers and scatter-
# adds a step, one per hash level of each MLP (10 levels x 3 MLPs).
ZIP_TRAIN_WARMUP, ZIP_TRAIN_STEPS = 2, 12
K2_PER_STEP = 30
# One zip step against the same weights whose gathers run the plain pair
# (table[idx] and PyTorch's backward of it, index_put_ with accumulate) on
# the same draws: the forward is bit-identical (a gather copies bits), so
# the loss should agree exactly. The table grads differ by the order of
# the f32 additions into each row, most on the dense levels, where a row
# sums ~2.4e4 updates of a step. Relative L2 per tensor and, for a table,
# per level, after the same clipping. On an H100 the sound kernels read at
# most 3.3e-5 per table and 4.1e-5 per level (a proposal MLP's level 0).
# The fault the limit must catch, read in the same run from the plain
# grads: one row's updates doubled, which moves its level by the row's
# share of the level's L2 norm; that of each level's largest row read at
# least 2.5e-3 (a proposal MLP's hashed level 9), and the run checks that
# it stays above the limit. The limit sits between the two readings.
ZIP_STEP_LOSS_TOL = 1e-5
ZIP_STEP_GRAD_TOL = 2e-4


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
  # x, W, b read and the output written once; f32 products as 3xTF32
  size = 4 if dtype == torch.float32 else 2
  b_ms, b_by = bound_ms((2 * n * d + n_layers * d * d + n_layers * d) * size,
                        flop, F32_MMA_RATE if size == 4 else BF16_MMA_RATE)
  log(f"  {name}: N={n} D={d} L={n_layers} {str(dtype)[6:]} "
      f"last_relu={last_relu}: max_abs_err={err:.3e} (max|plain| "
      f"{scale:.3e}) "
      f"(tol atol={atol} rtol={rtol}) kernel {k_ms:.3f} ms "
      f"({flop / k_ms / 1e9:.1f} TFLOP/s, bound {b_ms:.3f} ms ({b_by}), "
      f"{100 * b_ms / k_ms:.1f}% of it) plain {p_ms:.3f} ms "
      f"({flop / p_ms / 1e9:.1f} TFLOP/s) [{k1:.3f}/{k2:.3f} vs "
      f"{p1:.3f}/{p2:.3f}]")
  check(finite, f"{name}: kernel output not finite")
  check(ok, f"{name}: kernel disagrees with plain (max abs err {err})")
  del x, w, b, got, want, diff
  torch.cuda.empty_cache()
  return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def _bits(torch, patterns):
  """float32 tensor of the given 32-bit patterns."""
  return torch.tensor([p - 2**32 if p >= 2**31 else p for p in patterns],
                      dtype=torch.int64).to(torch.int32).view(torch.float32)


def split_phase(torch, fm, iters=20):
  """tf32_split against tf32_split_plain on the card, bit for bit: random
  weights at the fine trunk_1..4 ([4, 1024, 1024]) and proposal
  trunk_1..3 ([3, 256, 256]) shapes, and a [1, 128, 128] tile of special
  values (signed zeros, inf, NaN payloads, subnormals, rounding ties, the
  largest tie that carries into inf). CUDA-event times in turns at the
  fine shape, both layouts, and the bytes bound (w read, four outputs
  written once)."""
  gen = torch.Generator(device="cuda").manual_seed(3)
  special = _bits(torch, [
      0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
      0x7F800001, 0xFFC00000, 0x7FFFFFFF, 0x00000001, 0x00001000,
      0x00003000, 0x807FF000, 0x00012345, 0x3F801000, 0xBF801000,
      0x3F803000, 0x3F800FFF, 0x7F7FF000, 0xFF7FF000, 0x3F7FFFFF])
  special = special.repeat(-(-128 * 128 // special.numel()))[:128 * 128]
  cases = [("fine trunk_1..4 weights", 4, 1024), ("proposal trunk_1..3 "
           "weights", 3, 256), ("special values", 1, 128)]

  def both_layouts(pair):
    big, small = pair
    return (big, small, big.transpose(1, 2).contiguous(),
            small.transpose(1, 2).contiguous())

  res = {}
  for name, n_layers, d in cases:
    w = (special.reshape(1, 128, 128).cuda() if name == "special values"
         else (torch.rand(n_layers, d, d, generator=gen, device="cuda")
               * 2 - 1) * (6.0 / (2 * d)) ** 0.5)
    got = fm.tf32_split(w)
    want = both_layouts(fm.tf32_split_plain(w))
    torch.cuda.synchronize()
    equal = all(torch.equal(g.view(torch.int32), p.view(torch.int32))
                for g, p in zip(got, want))
    line = f"  tf32_split, {name} [{n_layers}, {d}, {d}]: bit-equal {equal}"
    if name.startswith("fine"):
      def plain():
        return both_layouts(fm.tf32_split_plain(w))
      p1 = time_ms(torch, plain, iters)
      k1 = time_ms(torch, lambda: fm.tf32_split(w), iters)
      k2 = time_ms(torch, lambda: fm.tf32_split(w), iters)
      p2 = time_ms(torch, plain, iters)
      k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
      b_ms, b_by = bound_ms(5 * w.numel() * 4)
      line += (f"; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound "
               f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / k_ms:.1f}% of it) "
               f"[{k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}]")
      res = dict(err=0.0 if equal else float("nan"), ms=k_ms, plain_ms=p_ms,
                 bound_ms=b_ms, bound_by=b_by)
    log(line)
    check(equal, f"tf32_split differs from tf32_split_plain on {name}")
    del w, got, want
  torch.cuda.empty_cache()
  return res


def _rel_errs(got, want):
  """{name: (max abs err, max |plain|)} of matching tensors."""
  return {k: (float((g.double() - w.double()).abs().max()),
              float(w.double().abs().max()))
          for k, g, w in zip(("dx", "dW", "db"), got, want)}


def bwd_case(torch, fm, name, n, d, n_layers, last_relu, iters):
  """K1's backward kernels against fused_mlp_bwd_plain on the same saved
  activations and output gradient: dx, dW, db within BWD_TOL of
  max|plain|, CUDA-event times in turns and TFLOP/s; the training
  forward (layers kept) bit-equal to the eval call; then one autograd
  round trip through fused_mlp against autograd through fused_mlp_plain.
  """
  gen = torch.Generator(device="cuda").manual_seed(n * 5 + d + n_layers)
  dev = "cuda"
  x = torch.randn(n, d, generator=gen, device=dev) * 0.5
  limit = (6.0 / (2 * d)) ** 0.5
  w = (torch.rand(n_layers, d, d, generator=gen, device=dev) * 2 - 1) * limit
  b = (torch.rand(n_layers, 1, d, generator=gen, device=dev) * 2 - 1) * 0.1
  g = torch.randn(n, d, generator=gen, device=dev)
  with torch.no_grad():
    out, kept = fm._launch_fwd(x, w, b, last_relu, keep=True)
    bit_equal = torch.equal(out, fm.fused_mlp(x, w, b, last_relu))
  saved = ([] if kept is None else list(kept.unbind(0))) + [out]
  split = fm.tf32_split(w)[:2]  # made once, as the training forward does
  got = fm.fused_mlp_bwd(x, w, b, saved, g, split, last_relu)
  want = fm.fused_mlp_bwd_plain(x, w, b, saved, g, last_relu)
  again = fm.fused_mlp_bwd(x, w, b, saved, g, split, last_relu)
  torch.cuda.synchronize()
  deterministic = all(torch.equal(p, q) for p, q in zip(got, again))
  errs = _rel_errs(got, want)
  ok = all(e <= BWD_TOL * s + 1e-30 for e, s in errs.values())
  finite = all(bool(torch.isfinite(t).all()) for t in got)
  del got, want, again
  p1 = time_ms(torch, lambda: fm.fused_mlp_bwd_plain(x, w, b, saved, g,
                                                     last_relu), iters)
  k1 = time_ms(torch, lambda: fm.fused_mlp_bwd(x, w, b, saved, g, split,
                                               last_relu), iters)
  k2 = time_ms(torch, lambda: fm.fused_mlp_bwd(x, w, b, saved, g, split,
                                               last_relu), iters)
  p2 = time_ms(torch, lambda: fm.fused_mlp_bwd_plain(x, w, b, saved, g,
                                                     last_relu), iters)
  k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
  flop = 4.0 * n * d * d * n_layers      # dgrad + wgrad, every layer
  # The autograd round trip: autograd through fused_mlp against plain
  # autograd (cuBLAS matmuls) that takes the kernel forward's ReLU
  # decisions. Autograd through fused_mlp_plain makes its own decisions;
  # its forward is ~3e-5 off the kernel's, so a pre-activation that close
  # to 0 flips, and one flipped entry of the top layer moves a whole row
  # of dx by O(its size): that comparison is printed, not checked.
  masks = [a > 0 for a in saved]
  del saved, kept, out, split
  leaves = [t.clone().requires_grad_() for t in (x, w, b)]
  (fm.fused_mlp(*leaves, last_relu) * g).sum().backward()
  got = [t.grad for t in leaves]

  def plain_grads(relu):
    px, pw, pb = (t.clone().requires_grad_() for t in (x, w, b))
    h = px
    for i in range(n_layers):
      h = relu(i, h @ pw[i] + pb[i])
    (h * g).sum().backward()
    return [px.grad, pw.grad, pb.grad], h.detach()

  def kernel_relu(i, z):
    return z * masks[i] if i < n_layers - 1 or last_relu else z

  def own_relu(i, z):
    return torch.relu(z) if i < n_layers - 1 or last_relu else z

  want, _ = plain_grads(kernel_relu)
  trip = _rel_errs(got, want)
  trip_ok = all(e <= BWD_TOL * s + 1e-30 for e, s in trip.values())
  own, own_out = plain_grads(own_relu)
  flips = int((masks[-1] != (own_out > 0)).sum()) if last_relu else 0
  own_errs = _rel_errs(got, own)
  del want, own, own_out, masks
  fmt = lambda es: ", ".join(f"{k} {e:.2e} (max|plain| {s:.2e})"
                             for k, (e, s) in es.items())
  log(f"  {name}: N={n} D={d} L={n_layers} last_relu={last_relu}: "
      f"{fmt(errs)} (tol {BWD_TOL} x max|plain|); kernels {k_ms:.3f} ms "
      f"({flop / k_ms / 1e9:.1f} TFLOP/s) plain {p_ms:.3f} ms "
      f"({flop / p_ms / 1e9:.1f} TFLOP/s) [{k1:.3f}/{k2:.3f} vs "
      f"{p1:.3f}/{p2:.3f}]; forward keeping layers bit-equal to eval: "
      f"{bit_equal}; two backward runs bit-equal: {deterministic}")
  log(f"    autograd round trip vs plain autograd on the kernel's ReLU "
      f"decisions: {fmt(trip)} (tol {BWD_TOL} x max|plain|); vs autograd "
      f"through fused_mlp_plain (its own decisions, {flips} of the top "
      f"layer's differ): {fmt(own_errs)} (not checked)")
  check(finite, f"{name}: backward kernels gave non-finite grads")
  check(bit_equal, f"{name}: the forward keeping its layers differs from "
        "the eval forward")
  check(deterministic, f"{name}: two identical backward runs differ")
  check(ok, f"{name}: backward kernels disagree with plain: {errs}")
  check(trip_ok, f"{name}: autograd through fused_mlp disagrees with "
        f"plain autograd on the same ReLU decisions: {trip}")
  del x, w, b, g, leaves, got
  torch.cuda.empty_cache()
  return dict(err=max(e / max(s, 1e-30) for e, s in errs.values()),
              abs_err=max(e for e, _ in errs.values()), ms=k_ms,
              plain_ms=p_ms)


def bwd_kernel_times(torch, fm, n, d, iters):
  """Each backward kernel alone at one fine-trunk layer against its plain
  PyTorch counterpart: dgrad (on the weight's split, made once) vs (dz @
  w.T) * (mask > 0); wgrad plus its reduce vs act.T @ dz and dz.sum(0);
  the reduce alone vs a sum over the split axis. Max abs error and
  CUDA-event times in turns, and the time of one PyTorch call for the
  product (TF32 off): torch.matmul(dz, w.t()), the unmasked dgrad of
  layer 0, for dgrad; act.t() @ dz for wgrad."""
  gen = torch.Generator(device="cuda").manual_seed(11)
  dz = torch.randn(n, d, generator=gen, device="cuda")
  act = torch.relu(torch.randn(n, d, generator=gen, device="cuda"))
  w = (torch.rand(d, d, generator=gen, device="cuda") * 2 - 1) * 0.05
  sm = torch.cuda.get_device_properties(0).multi_processor_count
  rows, splits = fm.wgrad_splits(n, d, sm)
  part_w = dz.new_empty(splits, d, d)
  part_b = dz.new_empty(splits, d)
  out = torch.empty_like(dz)
  dw, db = dz.new_empty(d, d), dz.new_empty(d)
  w_big, w_small = fm.tf32_split(w[None])[:2]

  def dgrad():
    return fm.fused_mlp_bwd_dgrad(dz, w_big[0], w_small[0], act, out)

  def dgrad_plain():
    return (dz @ w.t()) * (act > 0)

  def wgrad():
    fm.fused_mlp_bwd_wgrad(act, dz, part_w, part_b, rows)
    fm.fused_mlp_bwd_reduce(part_w, part_b, dw, db)
    return dw, db

  def wgrad_plain():
    return act.t() @ dz, dz.sum(0)

  def reduce():
    fm.fused_mlp_bwd_reduce(part_w, part_b, dw, db)

  def reduce_plain():
    return part_w.sum(0), part_b.sum(0)

  library = {"fused_mlp_bwd_dgrad": lambda: torch.matmul(dz, w.t()),
             "fused_mlp_bwd_wgrad": lambda: act.t() @ dz}
  res = {}
  for name, kern, plain, flop in (
      ("fused_mlp_bwd_dgrad", dgrad, dgrad_plain, 2.0 * n * d * d),
      ("fused_mlp_bwd_wgrad", wgrad, wgrad_plain, 2.0 * n * d * d),
      ("fused_mlp_bwd_reduce", reduce, reduce_plain, 0.0)):
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if name == "fused_mlp_bwd_reduce":
      got, want = (dw, db), want
    pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
    err = max(float((g - p).abs().max()) for g, p in pairs)
    scale = max(float(p.abs().max()) for _, p in pairs)
    p1 = time_ms(torch, plain, iters)
    k1 = time_ms(torch, kern, iters)
    k2 = time_ms(torch, kern, iters)
    p2 = time_ms(torch, plain, iters)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    lib = time_ms(torch, library[name], iters) if name in library else None
    rate = (f" ({flop / k_ms / 1e9:.1f} vs {flop / p_ms / 1e9:.1f} TFLOP/s)"
            if flop else "")
    lib_txt = (f", one PyTorch call {lib:.3f} ms ({flop / lib / 1e9:.1f} "
               "TFLOP/s)" if lib else "")
    log(f"  {name} alone, N={n} D={d} (splits {splits} x {rows} rows): "
        f"max_abs_err {err:.2e} (max|plain| {scale:.2e}); kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms{rate}{lib_txt} "
        f"[{k1:.3f}/{k2:.3f} vs {p1:.3f}/{p2:.3f}]")
    check(err <= BWD_TOL * scale, f"{name} disagrees with plain: {err}")
    res[name] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib)
  del dz, act, w, part_w, part_b, out, dw, db, w_big, w_small
  torch.cuda.empty_cache()
  return res


def profile_step(torch, step_fn, what="step"):
  """Device time of one train step (or render chunk) under
  torch.profiler, by kernel: K1 forward, its weight split, dgrad, wgrad
  (+ its reduce), cuBLAS GEMMs, the optimizer (kernels under
  Optimizer.step) and the rest (elementwise, sort, reductions, copies);
  with the idle share against the host clock."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

  def kind(name):
    for key, label in (("k1_wgmma_kernel<false>", "K1 forward"),
                       ("tf32_split", "K1 tf32_split"),
                       ("k1_wgmma_kernel<true>", "K1 dgrad"),
                       ("fused_mlp_bwd_wgrad", "K1 wgrad + reduce"),
                       ("fused_mlp_bwd_reduce", "K1 wgrad + reduce")):
      if key in name:
        return label
    if "gemm" in name.lower() or "gemv" in name.lower():
      return "matmul (cuBLAS)"
    return None

  def in_optimizer(e):
    while e is not None:
      if e.name.startswith("Optimizer.step"):
        return True
      e = e.cpu_parent
    return False

  events = prof.events()
  out = {k: 0.0 for k in ("K1 forward", "K1 tf32_split", "K1 dgrad",
                          "K1 wgrad + reduce", "matmul (cuBLAS)",
                          "optimizer (Adam)")}
  by_name, busy = {}, 0.0
  for e in events:
    if e.device_type != DeviceType.CUDA or getattr(
        e, "is_user_annotation", False):
      continue
    ms = e.time_range.elapsed_us() / 1e3
    busy += ms
    by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if kind(e.name):
      out[kind(e.name)] += ms
  for e in events:
    if e.device_type == DeviceType.CPU and e.kernels and in_optimizer(e):
      out["optimizer (Adam)"] += sum(k.duration / 1e3 for k in e.kernels
                                     if not kind(k.name))
  if busy == 0:
    log(f"  profile of one {what}: wall {wall_ms:.1f} ms; torch.profiler "
        "recorded no device time, breakdown not measured")
    return None
  out["other (elementwise, sort, reductions, copies)"] = (
      busy - sum(out.values()))
  out.update(device_total=busy, wall=wall_ms, idle_share=1 - busy / wall_ms)
  log(f"  profile of one {what}: wall {wall_ms:.1f} ms, device busy "
      f"{busy:.1f} ms, idle share {100 * out['idle_share']:.1f}%")
  for k in list(out)[:7]:
    log(f"    {k}: {out[k]:.2f} ms ({100 * out[k] / busy:.1f}%)")
  for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
    log(f"    kernel {name[:90]}: {ms:.2f} ms")
  return out


def _grad_errs(torch, a, b):
  """{param: (relative L2 error, max abs err, max|plain|)} of two models'
  grads, a against b (the plain one)."""
  out = {}
  pb = dict(b.named_parameters())
  for name, p in a.named_parameters():
    g, w = p.grad.double(), pb[name].grad.double()
    out[name] = (float((g - w).norm() / w.norm().clamp_min(1e-30)),
                 float((g - w).abs().max()), float(w.abs().max()))
  return out


def _table_level_errs(torch, a, b):
  """{(table, level): (relative L2 error, fault reading)} of two zip
  models' hash-table grads, a against b (the plain one), each level's
  rows apart. The fault reading is the error that doubling the updates
  of the level's largest row of b's grad would read: that row's norm over
  the level's."""
  from snerf_tpu_torch.models.hashgrid import HashEncoding
  out = {}
  pb = dict(b.named_modules())
  for name, m in a.named_modules():
    if not isinstance(m, HashEncoding):
      continue
    sizes = list(m.spec.sizes)
    levels = zip(torch.split(m.embeddings.grad.double(), sizes),
                 torch.split(pb[name].embeddings.grad.double(), sizes))
    for lvl, (g, w) in enumerate(levels):
      wn = w.norm().clamp_min(1e-30)
      out[(name, lvl)] = (float((g - w).norm() / wn),
                          float(w.norm(dim=1).max() / wn))
  return out


def train_slice(torch, scene, card):
  """Phase 7b: the nuScenes_depth_6cams training step at full width.
  Returns the K1 launch counts of the timed steps."""
  from snerf_tpu_torch.config import load_config, model_config, train_config
  from snerf_tpu_torch.data.sampler import scene_to_device
  from snerf_tpu_torch.models.mipnerf import MipNerfModel
  from snerf_tpu_torch.models.posenet import LearnPose
  from snerf_tpu_torch.ops import fused_mlp as fm
  from snerf_tpu_torch.train import trainer

  # depth_conf off: the confidence model and its VGG precompute are not
  # ported. lrate_delay 0: the shipped 2,500-step warm-up starts at
  # lr 5e-6, under which 26 steps would not move the loss measurably.
  cfg = load_config(["--config",
                     os.path.join(ROOT, "configs", "nuScenes_depth_6cams"),
                     "--depth_conf", "False", "--lrate_delay", "0"])
  mcfg, tcfg = model_config(cfg), train_config(cfg)
  log(f"[train slice] nuScenes_depth_6cams with depth_conf OFF (not ported) "
      f"and lrate_delay 0 (shipped 2500): N_rgb {tcfg.n_rgb}, hidden "
      f"{mcfg.hidden_layer} rgb_layer {mcfg.rgb_layer} proposal "
      f"{mcfg.proposal_hidden_layer}, samples {mcfg.num_samples} + "
      f"{mcfg.num_fine_intervals}, {mcfg.ray_shape}, fn2, "
      f"{mcfg.t_transform}, randomized {tcfg.randomized}, density_noise "
      f"{mcfg.density_noise}, pose_refine {tcfg.pose_refine}, depth_loss "
      f"{tcfg.depth_loss} (disparity {tcfg.disparity_depth}), "
      f"proposal_loss {tcfg.proposal_loss}, lr {tcfg.lrate}; scene "
      f"{scene.images.shape[1]}x{scene.images.shape[2]}, "
      f"{len(scene.i_train)} train views")
  dev_scene = scene_to_device(scene, "cuda")
  model, pose, state = trainer.create_train_state(
      0, mcfg, tcfg, scene.num_images, device="cuda")
  step = trainer.make_train_step(model, pose, tcfg, dev_scene,
                                 scene.i_train, scene.near, scene.far)
  gen = torch.Generator(device="cuda").manual_seed(0)
  kernels = (fm.fused_mlp, fm.tf32_split, fm.fused_mlp_bwd_dgrad,
             fm.fused_mlp_bwd_wgrad, fm.fused_mlp_bwd_reduce)

  for _ in range(TRAIN_WARMUP):
    step(state, gen)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for k in kernels:
    k.launches = 0
  losses = []
  t0 = time.perf_counter()
  for _ in range(TRAIN_STEPS):
    losses.append(step(state, gen)["loss"])
  torch.cuda.synchronize()
  secs = (time.perf_counter() - t0) / TRAIN_STEPS
  counts = {k.__name__: k.launches for k in kernels}
  peak = torch.cuda.max_memory_allocated()
  losses = [float(v) for v in losses]
  first, last = (sum(losses[:10]) / 10, sum(losses[-10:]) / 10)
  log(f"  {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: {secs:.4f} "
      f"s/step = {tcfg.n_rgb / secs:.1f} rays/s; peak device memory "
      f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated) | {card}")
  log(f"  loss: first 10 mean {first:.5f}, last 10 mean {last:.5f}; "
      f"{' '.join(f'{v:.4f}' for v in losses)}")
  per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
  log(f"  K1 launches per step: {per_step} (expected forward and "
      f"tf32_split {K1_FWD_PER_STEP} each, dgrad / wgrad / reduce "
      f"{K1_BWD_PER_STEP} each)")
  check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
  check(last < first, f"the loss did not fall: first 10 {first}, last 10 "
        f"{last}")
  for name in ("fused_mlp", "tf32_split"):
    check(counts[name] == K1_FWD_PER_STEP * TRAIN_STEPS,
          f"{name} launches {counts[name]}, expected "
          f"{K1_FWD_PER_STEP * TRAIN_STEPS}")
  for name in ("fused_mlp_bwd_dgrad", "fused_mlp_bwd_wgrad",
               "fused_mlp_bwd_reduce"):
    check(counts[name] == K1_BWD_PER_STEP * TRAIN_STEPS,
          f"{name} launches {counts[name]}, expected "
          f"{K1_BWD_PER_STEP * TRAIN_STEPS}")

  prof = profile_step(torch, lambda: step(state, gen))

  class KernelFwdPlainBwd(torch.autograd.Function):
    """K1's forward kernel keeping its layers, fused_mlp_bwd_plain on
    them backward."""

    @staticmethod
    def forward(ctx, x, w, b, last_relu):
      out, kept = fm._launch_fwd(x, w, b, last_relu, keep=True)
      ctx.last_relu = bool(last_relu)
      ctx.save_for_backward(x, w, b, out,
                            *([] if kept is None else kept.unbind(0)))
      return out

    @staticmethod
    def backward(ctx, g):
      x, w, b, out, *layers = ctx.saved_tensors
      return (*fm.fused_mlp_bwd_plain(x, w, b, [*layers, out],
                                      g.contiguous(), ctx.last_relu), None)

  def plain_bwd_stack(x, w, b, last_relu=True):
    return KernelFwdPlainBwd.apply(x, w, b, last_relu)

  # One step of this model against the same weights with the stacks'
  # backward plain (same forward) and with plain stacks, on the same
  # draws; fresh optimizers on every side.
  models = {"kernel": (model, pose)}
  for name, stack_fn in (("plain backward", plain_bwd_stack),
                         ("plain stacks", fm.fused_mlp_plain)):
    m = MipNerfModel(mcfg, stack_fn=stack_fn, device="cuda")
    m.load_state_dict(model.state_dict())
    p = LearnPose(scene.num_images, device="cuda")
    p.load_state_dict(pose.state_dict())
    models[name] = (m, p)
  steps, metrics = {}, {}
  draws = trainer.draw_step(mcfg, tcfg, dev_scene["images"], scene.i_train,
                            gen)
  for name, (m, p) in models.items():
    st = trainer.TrainState(
        step=state.step, model=m, optimizer=trainer.adam(m.parameters(), 0),
        pose_model=p, pose_optimizer=trainer.adam(p.parameters(), 0))
    steps[name] = (trainer.make_train_step(m, p, tcfg, dev_scene,
                                           scene.i_train, scene.near,
                                           scene.far), st)
    metrics[name] = steps[name][0](st, draws=draws)
  img = int(draws.img_idx[0])
  pose_grad = float(pose.r.grad[img].abs().max() + pose.t.grad[img].abs()
                    .max())
  for name, model_tol, pose_tol in (
      ("plain backward", STEP_BWD_TOL, STEP_BWD_TOL),
      ("plain stacks", STEP_GRAD_TOL, STEP_POSE_TOL)):
    got, want = metrics["kernel"], metrics[name]
    rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in want}
    errs = _grad_errs(torch, model, models[name][0])
    pose_errs = _grad_errs(torch, pose, models[name][1])
    worst = max(errs.items(), key=lambda kv: kv[1][0])
    worst_pose = max(v[0] for v in pose_errs.values())
    log(f"  one step, kernel model vs {name}: loss rel err "
        f"{rel['loss']:.2e} (tol {STEP_LOSS_TOL}), every metric's {rel} "
        f"(tol {STEP_METRIC_TOL}); grads: worst relative L2 "
        f"{worst[1][0]:.2e} at {worst[0]} (max abs {worst[1][1]:.2e}, "
        f"max|plain| {worst[1][2]:.2e}; tol {model_tol}), pose "
        f"{worst_pose:.2e} (tol {pose_tol})")
    check(rel["loss"] <= STEP_LOSS_TOL,
          f"kernel step's loss disagrees with {name}: {rel}")
    check(all(v <= STEP_METRIC_TOL for v in rel.values()),
          f"kernel step's metrics disagree with {name}: {rel}")
    check(worst[1][0] <= model_tol,
          f"kernel step's grads disagree with {name}: {worst}")
    check(worst_pose <= pose_tol,
          f"kernel step's pose grads disagree with {name}: {pose_errs}")
  log(f"  pose grad of the sampled image {img}: {pose_grad:.3e}")
  check(pose_grad > 0, "the sampled image's pose got no gradient")

  # end to end in turns: plain-stack step, kernel step, kernel, plain
  times = {}
  for name, key in (("plain", "plain stacks"), ("kernel", "kernel"),
                    ("kernel2", "kernel"), ("plain2", "plain stacks")):
    fn, st = steps[key]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(st, draws=draws)
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
  log(f"  one step end to end: kernel model {times['kernel']:.4f} / "
      f"{times['kernel2']:.4f} s, plain-stack model {times['plain']:.4f} / "
      f"{times['plain2']:.4f} s")
  del model, pose, state, models, steps, m, p, st
  torch.cuda.empty_cache()
  return counts, prof


def gather_case(torch, hash_ops, name, rows, c, n_idx, iters):
  """K2 against table[idx] on the card: exact equality (a gather copies
  bits), the edge rows 0 and rows-1, and CUDA-event times in turns.
  Indices uniform over a [rows, C] table: one level's rows, as the
  encoder gathers from each level's own slice, or a larger stress case.
  The bound: a table that fits the L2 is read from HBM once (the rows
  this run touches); a larger one costs a 32-byte sector an index."""
  gen = torch.Generator(device="cuda").manual_seed(rows * 9 + c)
  table = torch.randn(rows, c, generator=gen, device="cuda")
  idx = torch.randint(0, rows, (n_idx,), generator=gen, device="cuda",
                      dtype=torch.int32)
  idx[0], idx[-1] = 0, rows - 1
  if n_idx % 8 == 0:
    idx = idx.reshape(-1, 8)   # [points, 8 corners], as the encoder calls it
  got = hash_ops.gather_rows(table, idx)
  want = hash_ops.gather_rows_plain(table, idx)
  torch.cuda.synchronize()
  flat = got.reshape(-1, c)
  equal = torch.equal(got, want)
  edges = torch.equal(flat[0], table[0]) and torch.equal(flat[-1], table[-1])
  err = float((got - want).abs().max())
  p1 = time_ms(torch, lambda: hash_ops.gather_rows_plain(table, idx), iters)
  k1 = time_ms(torch, lambda: hash_ops.gather_rows(table, idx), iters)
  k2 = time_ms(torch, lambda: hash_ops.gather_rows(table, idx), iters)
  p2 = time_ms(torch, lambda: hash_ops.gather_rows_plain(table, idx), iters)
  idx_l = idx.long()
  lib = time_ms(torch, lambda: table[idx_l], iters)
  del idx_l
  k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
  useful = n_idx * (4 + 2 * 4 * c)   # index read, row read, row write
  # the least bytes: the index and the output row, and the table's rows
  if rows * c * 4 <= L2_BYTES:
    touched = int(torch.unique(idx).numel())
    b_ms, b_by = bound_ms(n_idx * (4 + 4 * c) + touched * c * 4)
  else:
    b_ms, b_by = bound_ms(n_idx * (4 + 32 + 4 * c))
  log(f"  {name}: T={rows} C={c} N={n_idx}: equal={equal} edges={edges} "
      f"max_abs_err={err:.1e} kernel {k_ms:.3f} ms ({useful / k_ms / 1e6:.0f}"
      f" GB/s) plain {p_ms:.3f} ms ({useful / p_ms / 1e6:.0f} GB/s) "
      f"table[idx] {lib:.3f} ms bound {b_ms:.3f} ms ({b_by}) "
      f"[{k1:.3f}/{k2:.3f} vs {p1:.3f}/{p2:.3f}]")
  check(equal, f"{name}: K2 disagrees with table[idx] (max abs err {err})")
  check(edges, f"{name}: K2 got the edge rows 0 / T-1 wrong")
  del table, idx, got, want, flat
  torch.cuda.empty_cache()
  return dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib, bound_ms=b_ms,
              bound_by=b_by)


def profile_chunk(torch, render_fn, rays):
  """Device time of one render chunk under torch.profiler, by kernel
  name (K2, cuBLAS GEMMs) and by the labelled calls hash_encode (the
  index and weight math around K2) and max_dilate, with the device idle
  share against the host clock. Returns the breakdown in ms."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function
  from snerf_tpu_torch.models import hashgrid
  from snerf_tpu_torch.ops import stepfun

  def labelled(fn, label):
    def wrapped(*args, **kwargs):
      with record_function(label):
        return fn(*args, **kwargs)
    return wrapped

  orig = hashgrid.hash_encode, stepfun.max_dilate
  hashgrid.hash_encode = labelled(orig[0], "hash_encode")
  stepfun.max_dilate = labelled(orig[1], "max_dilate")
  try:
    render_fn(rays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      render_fn(rays)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  finally:
    hashgrid.hash_encode, stepfun.max_dilate = orig

  def under(e, label):
    while e is not None:
      if e.name == label:
        return True
      e = e.cpu_parent
    return False

  def kind(name):
    if "gather_rows_kernel" in name:
      return "K2 gather"
    if "gemm" in name.lower():
      return "matmul (cuBLAS)"
    return None

  events = prof.events()
  device = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
  out = {"K2 gather": 0.0, "matmul (cuBLAS)": 0.0,
         "hash index/weight math": 0.0, "max_dilate": 0.0}
  by_name = {}
  for e in device:
    ms = e.time_range.elapsed_us() / 1e3
    by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if kind(e.name):
      out[kind(e.name)] += ms
  for e in events:
    if e.device_type != DeviceType.CPU or not e.kernels:
      continue
    for k in e.kernels:
      if kind(k.name):
        continue
      if under(e, "max_dilate"):
        out["max_dilate"] += k.duration / 1e3
      elif under(e, "hash_encode"):
        out["hash index/weight math"] += k.duration / 1e3
  busy = sum(by_name.values())
  if busy == 0:
    log(f"  profile of one chunk: wall {wall_ms:.2f} ms; torch.profiler "
        "recorded no device time, breakdown not measured")
    return None
  out["other (elementwise, sort, reductions)"] = busy - sum(out.values())
  out.update(device_total=busy, wall=wall_ms,
             idle_share=1.0 - busy / wall_ms)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  log(f"  profile of one chunk: wall {wall_ms:.2f} ms, device busy "
      f"{busy:.2f} ms, idle share {100 * out['idle_share']:.1f}%")
  for k in list(out)[:5]:
    log(f"    {k}: {out[k]:.3f} ms ({100 * out[k] / busy:.1f}%)")
  for name, ms in top:
    log(f"    kernel {name[:90]}: {ms:.3f} ms")
  return out


def zip_slice(torch, scene, views, view_rays, card):
  """Phase 6: the waymo_zipnerf hash arm at full width."""
  from snerf_tpu_torch.config import load_config, zip_model_config
  from snerf_tpu_torch.models.zipnerf import ZipNerfModel
  from snerf_tpu_torch.ops import hash_ops
  from snerf_tpu_torch.ops.fused_mlp import fused_mlp
  from snerf_tpu_torch.train.renderer import (make_zip_eval_render_fn,
                                              render_image)
  from snerf_tpu_torch.utils.weights import zip_init_

  cfg = load_config(["--config",
                     os.path.join(ROOT, "configs", "waymo_zipnerf")])
  zcfg = zip_model_config(cfg)
  t0 = time.perf_counter()
  model = zip_init_(ZipNerfModel(zcfg, device="cuda"), seed=0,
                    table_scale=ZIP_TABLE_SCALE).eval()
  plain_model = ZipNerfModel(zcfg, gather_fn=hash_ops.gather_rows_plain,
                             device="cuda").eval()
  plain_model.load_state_dict(model.state_dict())
  rows = [m.encoder.spec.total_rows for m in model.mlps()]
  log(f"[zip slice] waymo_zipnerf: encoder {zcfg.encoder_type}, samples "
      f"{zcfg.num_prop_samples}/{zcfg.num_nerf_samples} x {zcfg.sample_n}, "
      f"{zcfg.grid_num_levels} levels, log2 {zcfg.grid_log2_hashmap_size}, "
      f"tables {rows} rows, grids {zcfg.prop_grid_resolutions}/"
      f"{zcfg.nerf_grid_resolution}, semantic {zcfg.class_num}, chunk "
      f"{cfg.chunk}; init {time.perf_counter() - t0:.1f} s")
  H, W = scene.images.shape[1:3]
  render_fn = make_zip_eval_render_fn(model)

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  hash_ops.gather_rows.launches = 0
  fused_mlp.launches = 0
  outs, secs = [], []
  for i in views:
    rays = view_rays(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs.append(render_image(render_fn, rays, chunk=cfg.chunk))
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
  launches = hash_ops.gather_rows.launches
  k1_launches = fused_mlp.launches
  peak = torch.cuda.max_memory_allocated()
  n_chunks = len(views) * -(-H * W // cfg.chunk)
  for i, out, s in zip(views, outs, secs):
    rgb, acc, sem = out["rgb"], out["acc"], out["semantic"]
    log(f"  view {i}: {H}x{W} in {s:.3f} s = {H * W / s:.1f} rays/s; "
        f"rgb mean {float(rgb.mean()):.4f} std {float(rgb.std()):.4f} acc "
        f"[{float(acc.min()):.6f}, {float(acc.max()):.6f}] distance mean "
        f"{float(out['distance'].mean()):.4f}")
    check(tuple(rgb.shape) == (H, W, 3), f"rgb shape {tuple(rgb.shape)}")
    check(tuple(sem.shape) == (H, W, zcfg.class_num),
          f"semantic shape {tuple(sem.shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          f"view {i}: non-finite output")
    check(float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-5,
          f"view {i}: acc outside [0, 1]: {float(acc.min())} "
          f"{float(acc.max())}")
    # softmax rows composited with weights that sum to acc
    sem_err = float((sem.sum(-1) - acc[..., 0]).abs().max())
    check(sem_err <= 1e-4, f"view {i}: semantic rows do not sum to acc "
          f"({sem_err})")
  log(f"  K2 launches on the zip path: {launches} (30 per chunk x "
      f"{n_chunks} chunks expected); K1 launches {k1_launches}")
  check(launches == 30 * n_chunks,
        f"the zip path launched K2 {launches} times, expected "
        f"{30 * n_chunks}")
  log(f"  zip render rate (2nd view, steady): {H * W / secs[-1]:.1f} "
      f"rays/s; peak device memory {peak / 2**30:.3f} GiB "
      f"(torch.cuda.max_memory_allocated, both models' tables included) "
      f"| {card}")

  chunk_rays = view_rays(views[0]).reshape(-1).map(lambda t: t[:cfg.chunk])
  got = render_fn(chunk_rays)
  want = make_zip_eval_render_fn(plain_model)(chunk_rays)
  errs = {k: float((got[k] - want[k]).abs().max())
          for k in ("rgb", "acc", "semantic")}
  errs["distance_rel"] = float(((got["distance"] - want["distance"]).abs()
                                / want["distance"].abs()).max())
  log(f"  one chunk, K2 model vs plain-gather model: {errs} "
      f"(tol {ZIP_RENDER_TOL})")
  check(all(v <= ZIP_RENDER_TOL for v in errs.values()),
        f"K2 render disagrees with the plain-gather model: {errs}")
  plain_fn = make_zip_eval_render_fn(plain_model)
  p1 = time_ms(torch, lambda: plain_fn(chunk_rays), 3)
  k1 = time_ms(torch, lambda: render_fn(chunk_rays), 3)
  k2 = time_ms(torch, lambda: render_fn(chunk_rays), 3)
  p2 = time_ms(torch, lambda: plain_fn(chunk_rays), 3)
  log(f"  one chunk end to end: K2 model {(k1 + k2) / 2:.2f} ms, "
      f"plain-gather model {(p1 + p2) / 2:.2f} ms [{k1:.2f}/{k2:.2f} vs "
      f"{p1:.2f}/{p2:.2f}]")
  with torch.no_grad():
    for mlp in plain_model.mlps():
      mlp.encoder.embeddings.zero_()
  flat = plain_fn(chunk_rays)
  moved = float((got["rgb"] - flat["rgb"]).abs().max())
  log(f"  the same chunk with the tables zeroed: rgb moves by {moved:.4f} "
      f"(must exceed {TABLES_MATTER})")
  check(moved > TABLES_MATTER, "zeroing the hash tables does not change "
        f"the render (max rgb change {moved})")
  del plain_model, flat, want
  torch.cuda.empty_cache()
  profile_chunk(torch, render_fn, chunk_rays)


def sass_check(so, nvcc):
  """The SASS of K1's f32 forward and dgrad kernels in the built library
  (cuobjdump -sass, beside nvcc): each must hold wgmma (HGMMA) and TMA
  loads (UTMALDG)."""
  tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
  out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                       text=True, timeout=120)
  check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-500:]}")
  found = {}
  for body in re.split(r"\n\s*Function : ", out.stdout)[1:]:
    name = body.split("\n", 1)[0].strip()
    for label, key in (("f32 forward", "k1_wgmma_kernelILb0E"),
                       ("dgrad", "k1_wgmma_kernelILb1E")):
      if key in name:
        found[label] = (body.count("HGMMA"), body.count("UTMALDG"))
  log(f"  SASS of K1's wgmma kernels (HGMMA, UTMALDG): {found}")
  for label in ("f32 forward", "dgrad"):
    hgmma, utmaldg = found.get(label, (0, 0))
    check(hgmma > 0 and utmaldg > 0, f"K1 {label}: the SASS lacks wgmma "
          f"or TMA loads (HGMMA {hgmma}, UTMALDG {utmaldg})")


def bound_ms(bytes_, flops=0.0, flop_rate=None):
  """(ms, "bytes" or "operations"): the least time the card could take,
  the larger of the bytes over HBM_RATE and the operations over their
  peak rate."""
  t_bytes = bytes_ / HBM_RATE * 1e3
  t_ops = flops / flop_rate * 1e3 if flop_rate else 0.0
  return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def scatter_case(torch, hash_ops, name, rows, c, q, lo, hi, iters):
  """The scatter-add kernel against scatter_add_rows_plain (index_add_,
  atomic on CUDA too) and an f64 index_add_ control on the same inputs,
  with table[idx]'s backward (index_put_ accumulate) read beside:
  indices uniform in the level's rows [lo, hi) of a [rows, C] table,
  N(0, 1) gradients. Error / max|control| for both, CUDA-event times in
  turns, the bytes bound and GB/s."""
  gen = torch.Generator(device="cuda").manual_seed(q * 3 + c + lo)
  idx = torch.randint(lo, hi, (q,), generator=gen, device="cuda",
                      dtype=torch.int32)
  idx[0], idx[-1] = lo, hi - 1
  g = torch.randn(q, c, generator=gen, device="cuda")
  got = hash_ops.scatter_add_rows(idx, g, rows)
  plain = hash_ops.scatter_add_rows_plain(idx, g, rows)
  # table[idx]'s own backward, the plain pair's in phase 8
  put = torch.zeros(rows, c, device="cuda").index_put_(
      (idx.long(),), g, accumulate=True)
  control = torch.zeros(rows, c, dtype=torch.float64, device="cuda")
  control.index_add_(0, idx, g.double())
  torch.cuda.synchronize()
  scale = float(control.abs().max())
  abs_err = float((got.double() - control).abs().max())
  err = abs_err / scale
  plain_err = float((plain.double() - control).abs().max()) / scale
  put_err = float((put.double() - control).abs().max()) / scale
  untouched = float(got[:lo].abs().sum() + got[hi:].abs().sum())
  del plain, put, control
  p1 = time_ms(torch, lambda: hash_ops.scatter_add_rows_plain(idx, g, rows),
               iters)
  k1 = time_ms(torch, lambda: hash_ops.scatter_add_rows(idx, g, rows), iters)
  k2 = time_ms(torch, lambda: hash_ops.scatter_add_rows(idx, g, rows), iters)
  p2 = time_ms(torch, lambda: hash_ops.scatter_add_rows_plain(idx, g, rows),
               iters)
  lib = time_ms(torch, lambda: torch.zeros(rows, c, device="cuda").index_add_(
      0, idx, g), iters)
  k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
  nbytes = q * (4 + 4 * c) + rows * c * 4   # idx, g read; dT written
  b_ms, b_by = bound_ms(nbytes, q * c, F32_RATE)
  log(f"  {name}: T={rows} C={c} Q={q} rows [{lo}, {hi}): err/max|f64| "
      f"{err:.2e} (plain f32 index_add_ {plain_err:.2e}, index_put_ "
      f"accumulate {put_err:.2e}; tol {SCATTER_TOL})"
      f" kernel {k_ms:.3f} ms ({nbytes / k_ms / 1e6:.0f} GB/s, "
      f"{q / k_ms / 1e6:.1f} G upd/s) plain {p_ms:.3f} ms index_add_ "
      f"{lib:.3f} ms bound {b_ms:.3f} ms ({b_by}) [{k1:.3f}/{k2:.3f} vs "
      f"{p1:.3f}/{p2:.3f}]")
  check(bool(torch.isfinite(got).all()), f"{name}: non-finite scatter-add")
  check(untouched == 0.0, f"{name}: rows outside [{lo}, {hi}) got updates")
  check(err <= SCATTER_TOL, f"{name}: scatter-add off the f64 control by "
        f"{err:.2e} of its max")
  del idx, g, got
  torch.cuda.empty_cache()
  return dict(err=err, abs_err=abs_err, ms=k_ms, plain_ms=p_ms,
              library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def probe_phase(torch, iters=20):
  """Phase 4d: P1 and P2 against their plain versions (bit-equal), then
  the survey of the gather primitives. Returns (results of the P1 and P2
  cases, the survey, the launch counts of the survey run)."""
  from snerf_tpu_torch.probes import gather as probes

  res = {}
  gen = torch.Generator(device="cuda").manual_seed(5)
  for axis, s, l in ((1, 8, 4096), (1, 64, 131072), (1, 3, 1000),
                     (0, 1024, 128), (0, 64, 131072), (0, 7, 333)):
    x = torch.randn(s, l, generator=gen, device="cuda")
    idx = torch.randint(0, x.shape[axis], (s, l), generator=gen,
                        device="cuda", dtype=torch.int32)
    idx_l = idx.long()
    got = probes.take_along_axis(x, idx, axis)
    want = probes.take_along_axis_plain(x, idx, axis)
    equal = torch.equal(got, want)
    k_ms = time_ms(torch, lambda: probes.take_along_axis(x, idx, axis), iters)
    p_ms = time_ms(torch, lambda: probes.take_along_axis_plain(x, idx, axis),
                   iters)
    lib = time_ms(torch, lambda: torch.take_along_dim(x, idx_l, dim=axis),
                  iters)
    b_ms, b_by = bound_ms(s * l * 12)     # idx, x read; out written
    log(f"  P1 take_along_axis axis {axis} [{s}x{l}]: equal={equal} kernel "
        f"{k_ms:.4f} ms plain {p_ms:.4f} ms take_along_dim {lib:.4f} ms "
        f"bound {b_ms:.4f} ms ({b_by})")
    check(equal, f"P1 axis {axis} {s}x{l} differs from take_along_dim")
    res[f"P1 axis {axis} {s}x{l}"] = dict(err=float((got - want).abs().max()),
                                         ms=k_ms, plain_ms=p_ms,
                                         library_ms=lib, bound_ms=b_ms,
                                         bound_by=b_by)
  for c, t, q in ((8, 4992, 1 << 17), (1, 4913, 1 << 20), (4, 4913, 777)):
    tab = torch.randn(c, t, generator=gen, device="cuda")
    idx = torch.randint(0, t, (c, q), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[:, 0], idx[:, -1] = 0, t - 1
    idx_l = idx.long()
    got = probes.gather_select(tab, idx)
    want = probes.gather_select_plain(tab, idx)
    equal = torch.equal(got, want)
    k_ms = time_ms(torch, lambda: probes.gather_select(tab, idx), iters)
    p_ms = time_ms(torch, lambda: probes.gather_select_plain(tab, idx), iters)
    lib = time_ms(torch, lambda: tab.gather(1, idx_l), iters)
    b_ms, b_by = bound_ms(c * q * 8 + c * t * 4)
    log(f"  P2 gather_select [{c}x{t} table, {c}x{q} idx]: equal={equal} "
        f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms gather {lib:.4f} ms "
        f"bound {b_ms:.4f} ms ({b_by})")
    check(equal, f"P2 {c}x{t} x {q} differs from tab.gather")
    res[f"P2 {c}x{t} {q}"] = dict(err=float((got - want).abs().max()),
                                  ms=k_ms, plain_ms=p_ms, library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by)
  del x, idx, idx_l, got, want, tab
  torch.cuda.empty_cache()
  # the probe entry point, with its launches counted
  probes.take_along_axis.launches = probes.gather_select.launches = 0
  survey = probes.survey(log=lambda s: log("  " + s), iters=iters)
  counts = {"probe_take_along_axis": probes.take_along_axis.launches,
            "probe_gather_select": probes.gather_select.launches}
  log(f"  probe launches in the survey: {counts}")
  check(all(v > 0 for v in counts.values()), f"a probe kernel was not "
        f"launched by the survey: {counts}")
  torch.cuda.empty_cache()
  return res, survey, counts


def profile_zip_step(torch, step_fn):
  """Device time of one zip train step under torch.profiler: K2 gathers,
  scatter-adds (each launch in order), cuBLAS, the forward hash index and
  weight math (under hash_encode), the forward losses, the backward's
  other kernels, Adam and the rest; with the idle share against the host
  clock."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile, record_function
  from snerf_tpu_torch.models import hashgrid
  from snerf_tpu_torch.train import losses, zip_trainer

  def labelled(fn, label):
    def wrapped(*args, **kwargs):
      with record_function(label):
        return fn(*args, **kwargs)
    return wrapped

  patched = [(hashgrid, "hash_encode", "hash_encode"),
             (zip_trainer, "hash_decay_loss", "losses")] + [
                 (losses, n, "losses") for n in (
                     "charbonnier_loss", "interlevel_loss_anti",
                     "distortion_loss", "zip_smooth_loss",
                     "zip_semantic_smooth_loss", "masked_mean")]
  orig = [getattr(m, n) for m, n, _ in patched]
  for m, n, label in patched:
    setattr(m, n, labelled(getattr(m, n), label))
  try:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      step_fn()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  finally:
    for (m, n, _), f in zip(patched, orig):
      setattr(m, n, f)

  def kind(name):
    if "gather_rows_kernel" in name:
      return "K2 gather"
    if "scatter_add_rows_kernel" in name:
      return "scatter-add"
    if "gemm" in name.lower() or "gemv" in name.lower():
      return "matmul (cuBLAS)"
    return None

  def context(e):
    while e is not None:
      if e.name.startswith("Optimizer.step"):
        return "Adam"
      if e.name == "hash_encode":
        return "hash index/weight math (forward)"
      if e.name == "losses":
        return "losses (forward)"
      if e.name.startswith("autograd::engine::evaluate_function"):
        return "backward (elementwise, reductions, copies)"
      e = e.cpu_parent
    return "other forward (sampling, compositing, activations)"

  events = prof.events()
  out = {k: 0.0 for k in ("K2 gather", "scatter-add", "matmul (cuBLAS)",
                          "hash index/weight math (forward)",
                          "losses (forward)",
                          "backward (elementwise, reductions, copies)",
                          "Adam",
                          "other forward (sampling, compositing, "
                          "activations)")}
  busy, scatters, by_name = 0.0, [], {}
  for e in events:
    if e.device_type != DeviceType.CUDA or getattr(
        e, "is_user_annotation", False):
      continue
    ms = e.time_range.elapsed_us() / 1e3
    busy += ms
    by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if kind(e.name):
      out[kind(e.name)] += ms
    if kind(e.name) == "scatter-add":
      scatters.append((e.time_range.start, ms))
  for e in events:
    if e.device_type == DeviceType.CPU and e.kernels:
      for k in e.kernels:
        if not kind(k.name):
          out[context(e)] += k.duration / 1e3
  if busy == 0:
    log(f"  profile of one step: wall {wall_ms:.1f} ms; torch.profiler "
        "recorded no device time, breakdown not measured")
    return None
  out.update(device_total=busy, wall=wall_ms, idle_share=1 - busy / wall_ms)
  log(f"  profile of one step: wall {wall_ms:.1f} ms, device busy "
      f"{busy:.1f} ms, idle share {100 * out['idle_share']:.1f}%")
  for k in list(out)[:8]:
    log(f"    {k}: {out[k]:.2f} ms ({100 * out[k] / busy:.1f}%)")
  per_launch = [ms for _, ms in sorted(scatters)]
  log(f"    scatter-add launches in order ({len(per_launch)}; the backward "
      f"runs nerf_mlp, prop_mlp_1, prop_mlp_0, each level 9..0): "
      + " ".join(f"{v:.3f}" for v in per_launch))
  for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
    log(f"    kernel {name[:90]}: {ms:.2f} ms")
  out["scatter_per_launch"] = per_launch
  return out


def zip_train_slice(torch, scene, card):
  """Phase 8: the waymo_zipnerf training step at full width. Returns the
  K2 gather and scatter-add launch counts of the timed steps."""
  import dataclasses

  import numpy as np
  from snerf_tpu_torch.config import (load_config, zip_model_config,
                                      zip_train_config)
  from snerf_tpu_torch.data.sampler import scene_to_device
  from snerf_tpu_torch.models.zipnerf import ZipNerfModel
  from snerf_tpu_torch.ops import hash_ops
  from snerf_tpu_torch.train import zip_trainer as zt

  # lr_delay 0: the shipped 5,000-step warm-up starts at lr 1e-10
  cfg = load_config(["--config",
                     os.path.join(ROOT, "configs", "waymo_zipnerf"),
                     "--zip_lr_delay", "0"])
  zcfg, tcfg = zip_model_config(cfg), zip_train_config(cfg)
  # semantic labels from depth quantiles, an object mask on one corner
  depth = scene.depths
  edges = np.quantile(depth, np.linspace(0, 1, zcfg.class_num + 1)[1:-1])
  mask = np.zeros(depth.shape, bool)
  mask[:, :16, :16] = True
  zscene = dataclasses.replace(
      scene, semantics=np.digitize(depth, edges).astype(np.int32),
      skymask=mask)
  n_pix, n_patches = zt._patch_split(tcfg)
  log(f"[zip train slice] waymo_zipnerf with zip_lr_delay 0 (shipped "
      f"{load_config(['--config', os.path.join(ROOT, 'configs', 'waymo_zipnerf')]).zip_lr_delay}"
      f"): batch {tcfg.batch_size} ({n_pix} pixels + {n_patches} patches of "
      f"{tcfg.patch_size}^2), samples {zcfg.num_prop_samples}/"
      f"{zcfg.num_nerf_samples} x {zcfg.sample_n}, {zcfg.grid_num_levels} "
      f"levels at 2^{zcfg.grid_log2_hashmap_size}, grids "
      f"{zcfg.prop_grid_resolutions}/{zcfg.nerf_grid_resolution}, "
      f"{zcfg.class_num} classes, lr {tcfg.lr_init} -> {tcfg.lr_final}, "
      f"grad clip {tcfg.grad_max_norm}, depth {tcfg.depth_loss_mult} "
      f"(completion {tcfg.depth_complete}), semantic "
      f"{tcfg.semantic_loss_mult}, float32; scene "
      f"{scene.images.shape[1]}x{scene.images.shape[2]}, "
      f"{len(scene.i_train)} train views")
  dev_scene = scene_to_device(zscene, "cuda")
  state = zt.create_zip_train_state(0, zcfg, tcfg, zscene.num_images,
                                    device="cuda")
  model = state.model
  step = zt.make_zip_train_step(model, tcfg, dev_scene, zscene.i_train,
                                zscene.near, zscene.far)
  gen = torch.Generator(device="cuda").manual_seed(0)
  kernels = (hash_ops.gather_rows, hash_ops.scatter_add_rows)

  for _ in range(ZIP_TRAIN_WARMUP):
    step(state, gen)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for k in kernels:
    k.launches = 0
  losses = []
  t0 = time.perf_counter()
  for _ in range(ZIP_TRAIN_STEPS):
    losses.append(step(state, gen)["loss"])
  torch.cuda.synchronize()
  secs = (time.perf_counter() - t0) / ZIP_TRAIN_STEPS
  counts = {"hash_gather": hash_ops.gather_rows.launches,
            "hash_scatter_add": hash_ops.scatter_add_rows.launches}
  peak = torch.cuda.max_memory_allocated()
  losses = [float(v) for v in losses]
  k = ZIP_TRAIN_STEPS // 3
  first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
  log(f"  {ZIP_TRAIN_STEPS} steps after {ZIP_TRAIN_WARMUP} warm-up: "
      f"{secs:.4f} s/step = {tcfg.batch_size / secs:.1f} rays/s; peak device "
      f"memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated) | "
      f"{card}")
  log(f"  loss: first {k} mean {first:.5f}, last {k} mean {last:.5f}; "
      f"{' '.join(f'{v:.4f}' for v in losses)}")
  per_step = {n: v / ZIP_TRAIN_STEPS for n, v in counts.items()}
  log(f"  launches per step: {per_step} (expected {K2_PER_STEP} each)")
  check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
  check(last < first, f"the loss did not fall: first {k} {first}, last {k} "
        f"{last}")
  for n, v in counts.items():
    check(v == K2_PER_STEP * ZIP_TRAIN_STEPS,
          f"{n} launches {v}, expected {K2_PER_STEP * ZIP_TRAIN_STEPS}")

  prof = profile_zip_step(torch, lambda: step(state, gen))

  # one step of this model against the same weights whose gathers run the
  # plain pair (table[idx] forward, its scatter-add backward), on the same
  # draws
  plain = ZipNerfModel(zcfg, gather_fn=hash_ops.gather_rows_plain,
                       device="cuda")
  plain.load_state_dict(model.state_dict())
  pstate = zt.ZipTrainState(step=state.step, model=plain,
                            optimizer=zt.make_zip_optimizer(plain, tcfg))
  pstep = zt.make_zip_train_step(plain, tcfg, dev_scene, zscene.i_train,
                                 zscene.near, zscene.far)
  draws = zt.draw_zip_step(zcfg, tcfg, dev_scene["images"], zscene.i_train,
                           gen)
  got, want = step(state, draws), pstep(pstate, draws)
  rel = {n: abs(float(got[n]) - float(want[n])) / max(abs(float(want[n])),
                                                       1e-30)
         for n in want}
  errs = _grad_errs(torch, model, plain)
  worst = max(errs.items(), key=lambda kv: kv[1][0])
  tables = {n: v[0] for n, v in errs.items() if n.endswith("embeddings")}
  lerrs = _table_level_errs(torch, model, plain)
  lworst = max(lerrs.items(), key=lambda kv: kv[1][0])
  fault = min(lerrs.items(), key=lambda kv: kv[1][1])
  log(f"  one step, kernel model vs plain-pair model: loss rel err "
      f"{rel['loss']:.2e} (tol {ZIP_STEP_LOSS_TOL}), metrics {rel}; grads: "
      f"worst relative L2 {worst[1][0]:.2e} at {worst[0]} (tol "
      f"{ZIP_STEP_GRAD_TOL}); tables {tables}")
  log(f"  table grads by level: worst relative L2 {lworst[1][0]:.2e} at "
      f"{lworst[0]} (tol {ZIP_STEP_GRAD_TOL}); fault reading (a level's "
      f"largest row doubled) at least {fault[1][1]:.2e} at {fault[0]}; "
      + " ".join(f"{n.split('.')[0]}/{lvl} {e:.2e}/{f:.2e}"
                 for (n, lvl), (e, f) in lerrs.items()))
  check(rel["loss"] <= ZIP_STEP_LOSS_TOL,
        f"kernel step's loss disagrees with the plain pair: {rel}")
  check(worst[1][0] <= ZIP_STEP_GRAD_TOL,
        f"kernel step's grads disagree with the plain pair: {worst}")
  check(lworst[1][0] <= ZIP_STEP_GRAD_TOL,
        f"kernel step's table grads disagree with the plain pair: {lworst}")
  check(fault[1][1] > ZIP_STEP_GRAD_TOL,
        f"ZIP_STEP_GRAD_TOL {ZIP_STEP_GRAD_TOL} would not see a doubled row "
        f"at {fault}")
  check(all(float(p.grad.abs().max()) > 0 for n, p in
            model.named_parameters() if n.endswith("embeddings")),
        "a hash table got no gradient")
  times = {}
  for name, (fn, st) in (("plain", (pstep, pstate)), ("kernel", (step, state)),
                         ("kernel2", (step, state)),
                         ("plain2", (pstep, pstate))):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(st, draws)
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
  log(f"  one step end to end: kernel model {times['kernel']:.4f} / "
      f"{times['kernel2']:.4f} s, plain-pair model {times['plain']:.4f} / "
      f"{times['plain2']:.4f} s")
  del model, plain, state, pstate, step, pstep
  torch.cuda.empty_cache()
  return counts, prof


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
          "needs a CUDA card", file=sys.stderr)
    return 1

  from snerf_tpu_torch.config import load_config, model_config
  from snerf_tpu_torch.data.raygen import rays_for_image
  from snerf_tpu_torch.data.synthetic import make_synthetic_scene
  from snerf_tpu_torch.models.hashgrid import make_grid_spec
  from snerf_tpu_torch.models.mipnerf import MipNerfModel
  from snerf_tpu_torch.ops import _cuda, hash_ops
  from snerf_tpu_torch.ops import fused_mlp as fm
  from snerf_tpu_torch.train.renderer import make_eval_render_fn, render_image
  from snerf_tpu_torch.utils.weights import glorot_init_

  phase_secs = {}
  t_phase = [time.perf_counter()]

  def phase_done(name):
    now = time.perf_counter()
    phase_secs[name] = now - t_phase[0]
    log(f"[phase {name}] {phase_secs[name]:.1f} s")
    t_phase[0] = now

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
  built = _cuda.build_all()
  libs = ", ".join(os.path.relpath(so, ROOT) for so, _ in built.values())
  log(f"[build] {libs} in {time.perf_counter() - t0:.1f} s (parallel)")
  check(set(built) >= {"fused_mlp", "hash_gather", "gather_probe"},
        f"kernel sources missing: {sorted(built)}")
  for so, build_log in built.values():
    for line in build_log.splitlines():
      if ("registers" in line or "spill" in line or "error" in line
          or "Compiling entry" in line):
        log(f"  {line.strip()}")
  sass_check(built["fused_mlp"][0], _cuda._nvcc())
  phase_done("1-3 device, build")

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
  split_res = split_phase(torch, fm)
  phase_done("4 K1")

  # 4b. kernel K2 against plain, at the zip paths' shapes: one hashed
  # level (2^21 rows, the level's own slice, as the encoder gathers it) of
  # the render chunk (8192 rays) and of the train batch (32768 rays), and
  # a stress case over the whole nerf table (indices the path never draws)
  log("[kernel] hash_gather (CUDA) against table[idx]")
  nerf_spec = make_grid_spec(10, 4, 16, 8192, 21)
  prop0_spec = make_grid_spec(10, 1, 16, 512, 21)
  prop1_spec = make_grid_spec(10, 1, 16, 2048, 21)
  nerf_rows = nerf_spec.total_rows
  nerf9, prop1_9 = nerf_spec.sizes[9], prop1_spec.sizes[9]
  gcases = [
      ("nerf level 9", nerf9, 4, 8192 * 32 * 7 * 8, 10),
      ("prop_mlp_1 level 9", prop1_9, 1, 8192 * 64 * 7 * 8, 10),
      ("nerf level 9, train batch", nerf9, 4, 32768 * 32 * 7 * 8, 5),
      ("prop_mlp_1 level 9, train batch", prop1_9, 1, 32768 * 64 * 7 * 8,
       5),
      ("whole nerf table, train batch (stress)", nerf_rows, 4,
       32768 * 32 * 7 * 8, 5),
      ("ragged", nerf_rows, 4, 777 * 8, 20),
      ("C=2", 1 << 21, 2, 1 << 22, 20),
      ("C=8", 1 << 21, 8, 1 << 22, 20),
      ("TPU kernel shape", 4992, 8, 1 << 17, 50),
  ]
  gresults = {c[0]: gather_case(torch, hash_ops, *c) for c in gcases}
  phase_done("4b K2")

  # 4c. the scatter-add kernel at the zip train step's shapes: one level
  # of each kind per MLP into that level's own gradient (dense level 0:
  # 17^3 rows; hashed level 9: 2^21 rows), a ragged Q, one into a sub-range
  # of its rows, and the TPU kernel's table
  log("[kernel] hash_scatter_add (CUDA) against index_add_ and an f64 "
      "control")
  q_prop, q_nerf = 32768 * 64 * 7 * 8, 32768 * 32 * 7 * 8
  scases = [
      ("prop_mlp_0 level 0 (dense)", prop0_spec.sizes[0], 1, q_prop, 0,
       prop0_spec.sizes[0], 3),
      ("prop_mlp_0 level 9 (hashed)", prop0_spec.sizes[9], 1, q_prop, 0,
       prop0_spec.sizes[9], 3),
      ("nerf level 0 (dense)", nerf_spec.sizes[0], 4, q_nerf, 0,
       nerf_spec.sizes[0], 3),
      ("nerf level 9 (hashed)", nerf9, 4, q_nerf, 0, nerf9, 3),
      ("ragged", nerf_rows, 4, 777 * 8 + 3, 0, nerf_rows, 20),
      ("ragged C=3, rows [1000, 2^20) of 2^21", 1 << 21, 3, 777 * 8 + 3,
       1000, 1 << 20, 20),
      ("TPU kernel shape", 4992, 8, 1 << 17, 0, 4992, 50),
  ]
  sresults = {c[0]: scatter_case(torch, hash_ops, *c) for c in scases}
  log("  per level at the train step's shapes, ms: " + ", ".join(
      f"{n} {sresults[n]['ms']:.3f}" for n, *_ in scases[:4]))
  phase_done("4c scatter-add")

  # 4d. the gather probes P1 and P2, and the primitive survey
  log("[kernel] probes P1 take_along_axis and P2 gather_select (CUDA) "
      "against take_along_dim and gather")
  presults, _, probe_counts = probe_phase(torch)
  phase_done("4d probes")

  # 7a. K1's backward against plain, at the train path's shapes
  log("[kernel] fused_mlp backward (CUDA dgrad, wgrad, reduce) against "
      "fused_mlp_bwd_plain")
  fine_rows = 4096 * 127   # the train step's fine level: 127 intervals
  bcases = [
      ("fine trunk_1..4", fine_rows, 1024, 4, True, 2),
      ("fine trunk_6..7", fine_rows, 1024, 2, True, 2),
      ("proposal trunk_1..3", ROWS, 256, 3, True, 3),
      ("ragged", fine_rows + 5, 1024, 2, False, 2),
      ("ragged small", 777, 256, 3, False, 5),
  ]
  bresults = {c[0]: bwd_case(torch, fm, *c) for c in bcases}
  kresults = bwd_kernel_times(torch, fm, fine_rows, 1024, 5)
  bwd_kernel_times(torch, fm, ROWS, 256, 10)   # a proposal layer
  phase_done("7a K1 backward")

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
  fm.fused_mlp.launches = fm.tf32_split.launches = 0
  outs, secs = [], []
  for i in views:
    rays = view_rays(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs.append(render_image(render_fn, rays, chunk=cfg.chunk))
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
  launches = fm.fused_mlp.launches
  split_launches = fm.tf32_split.launches
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
  log(f"  fused_mlp launches on the render path: {launches}, tf32_split "
      f"{split_launches} (3 each per chunk x {n_chunks} chunks expected)")
  check(launches > 0, "the render path did not launch the fused_mlp kernel")
  check(split_launches == launches, "the render path's tf32_split launches "
        f"{split_launches} differ from its forward launches {launches}")
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
  plain_fn = make_eval_render_fn(plain_model, white_bkgd=cfg.white_bkgd)
  p1 = time_ms(torch, lambda: plain_fn(chunk_rays), 3)
  k1 = time_ms(torch, lambda: render_fn(chunk_rays), 3)
  k2 = time_ms(torch, lambda: render_fn(chunk_rays), 3)
  p2 = time_ms(torch, lambda: plain_fn(chunk_rays), 3)
  log(f"  one chunk end to end: kernel model {(k1 + k2) / 2:.2f} ms, "
      f"plain-stack model {(p1 + p2) / 2:.2f} ms [{k1:.2f}/{k2:.2f} vs "
      f"{p1:.2f}/{p2:.2f}] | {card}")
  profile_step(torch, lambda: render_fn(chunk_rays), "chunk")

  del model, plain_model, plain_fn, outs, got, want, chunk_rays
  torch.cuda.empty_cache()
  phase_done("5 mip render")

  # 6. zip slice
  zip_slice(torch, scene, views, view_rays, card)
  phase_done("6 zip render")

  # 7b. train slice
  train_counts, _ = train_slice(torch, scene, card)
  log(f"  K1 launches: mip render {launches}, train {train_counts}")
  phase_done("7b mip train")

  # 8. zip train slice
  zip_counts, _ = zip_train_slice(torch, scene, card)
  phase_done("8 zip train")
  log(f"[phases] {' '.join(f'{k}: {v:.1f} s' for k, v in phase_secs.items())}"
      f"; total {sum(phase_secs.values()):.1f} s")

  # Each kernel with the launches of its path (the mip train step for K1,
  # the zip train step for K2 and its scatter-add, the survey for the
  # probes), its error, times and bound at the path's shapes.
  def entry(name, source, replaces, launches, err, r, library=True):
    return {"name": name, "route": "cuda",
            "source": f"snerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] if library else None}

  # K1 forward at fine trunk_1..4 (its bound from kernel_case); its
  # weight split at the same run's [4, 1024, 1024] weights (split_phase)
  d = 1024
  # K1's backward kernels alone at one fine-trunk layer (N = fine_rows);
  # the reduce sums the wgrad partials (wgrad_splits of D x D + D)
  n = fine_rows
  splits = fm.wgrad_splits(
      n, d, torch.cuda.get_device_properties(0).multi_processor_count)[1]
  kb = {k: dict(v) for k, v in kresults.items()}
  for name, nbytes, flops, rate in (
      ("fused_mlp_bwd_dgrad", (3 * n * d + d * d) * 4, 2.0 * n * d * d,
       F32_MMA_RATE),
      ("fused_mlp_bwd_wgrad", (2 * n * d + d * d + d) * 4, 2.0 * n * d * d,
       F32_MMA_RATE),
      ("fused_mlp_bwd_reduce", (splits + 1) * (d * d + d) * 4,
       splits * (d * d + d), F32_RATE)):
    kb[name]["bound_ms"], kb[name]["bound_by"] = bound_ms(nbytes, flops,
                                                          rate)
  # the backward kernels stand for K1's custom VJP, _fused_bwd: XLA
  # einsums there, with no pallas_call of its own
  kernels = [entry("fused_mlp", "fused_mlp.cu",
                   "snerf_tpu/ops/pallas/fused_mlp.py:66",
                   train_counts["fused_mlp"],
                   max(results[c[0]]["err"] for c in cases if c[4] == f32),
                   results["fine trunk_1..4"], library=False),
             entry("tf32_split", "fused_mlp.cu",
                   "snerf_tpu/ops/pallas/fused_mlp.py:66",
                   train_counts["tf32_split"], split_res["err"], split_res,
                   library=False)]
  kernels += [entry(name, "fused_mlp.cu",
                    "snerf_tpu/ops/pallas/fused_mlp.py:104",
                    train_counts[name], kresults[name]["err"], kb[name])
              for name in ("fused_mlp_bwd_dgrad", "fused_mlp_bwd_wgrad",
                           "fused_mlp_bwd_reduce")]
  kernels.append(entry(
      "hash_gather", "hash_gather.cu",
      "snerf_tpu/ops/pallas/hash_gather_dense.py:63",
      zip_counts["hash_gather"], max(r["err"] for r in gresults.values()),
      gresults["nerf level 9, train batch"]))
  kernels.append(entry(
      "hash_scatter_add", "hash_gather.cu",
      "snerf_tpu/ops/pallas/hash_gather_dense.py:91",
      zip_counts["hash_scatter_add"],
      max(r["abs_err"] for r in sresults.values()),
      sresults["nerf level 9 (hashed)"]))
  kernels.append(entry(
      "probe_take_along_axis", "gather_probe.cu",
      "scripts/probe_gather.py:23", probe_counts["probe_take_along_axis"],
      max(r["err"] for k, r in presults.items() if k.startswith("P1")),
      presults["P1 axis 1 64x131072"]))
  kernels.append(entry(
      "probe_gather_select", "gather_probe.cu",
      "scripts/probe_hash_ops.py:92", probe_counts["probe_gather_select"],
      max(r["err"] for k, r in presults.items() if k.startswith("P2")),
      presults[f"P2 8x4992 {1 << 17}"]))
  log(json.dumps({"kernels": kernels}))
  log(card)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0

if __name__ == "__main__":
  sys.exit(main())
