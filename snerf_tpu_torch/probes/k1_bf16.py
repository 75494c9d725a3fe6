"""K1's bf16 backward kernels on the card against the bf16 PyTorch calls of
the same functions, at the bf16 training paths' layer shapes.

Times, by CUDA events in turns (A, B, ..., B, A):

- dgrad with its ReLU mask and without it (the dx launch), beside the
  bare GEMM torch.matmul(dz, w.t()), the same GEMM times the mask (the
  same function in PyTorch), and the GEMM's time plus the mask's bytes at
  3.35 TB/s (what the mask may add to the GEMM);
- wgrad + its fixed-order reduce, wgrad alone and the reduce alone,
  beside act.t() @ dz, with the split (`wgrad_splits`) and the bytes of
  its f32 partials;
- beside each, the bound (bytes over 3.35 TB/s, products over 989
  TFLOP/s).

Each kernel is held to its plain version (f32 sums of the same bf16
inputs) at TOL of max|plain|. Prints the card's name and power limit and
one JSON line a shape; exits 1 if a check fails.

  python -m snerf_tpu_torch.probes.k1_bf16
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from snerf_tpu_torch.ops import fused_mlp as fm

HBM_RATE = 3.35e12
BF16_MMA_RATE = 989e12
# (name, rows, D): the cp_hash proposal and nerf trunks' layers and the
# bench line's fine and proposal trunks' layers
SHAPES = (("cp_hash proposal layer", 2_097_152, 512),
          ("cp_hash nerf layer", 1_048_576, 512),
          ("bench fine layer", 520_192, 1024),
          ("bench proposal layer", 524_288, 256))
ITERS = 5
# against the plain version, as a fraction of max|plain|: dgrad's output
# is rounded to bf16 once (one ulp is 2^-8 of it), wgrad's f32 sums of
# bf16 products differ only in order
TOL = {"dgrad": 2e-2, "dx": 2e-2, "wgrad": 1e-4}


def _card() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def _ms(fn, iters=ITERS):
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def _ab(fns):
  """{name: mean ms} of each fn, timed in turns: every fn, then every fn
  in reverse order."""
  for fn in fns.values():
    fn()
  torch.cuda.synchronize()
  times = {k: [] for k in fns}
  for order in (list(fns), list(fns)[::-1]):
    for k in order:
      times[k].append(_ms(fns[k]))
  return {k: sum(v) / len(v) for k, v in times.items()}


def _bound(nbytes, flop):
  return max(nbytes / HBM_RATE, flop / BF16_MMA_RATE) * 1e3


def _rel(got, want):
  return float((got.double() - want.double()).abs().max()
               / want.double().abs().max())


def probe_shape(name, n, d, sm):
  gen = torch.Generator(device="cuda").manual_seed(n + d)
  bf16, f32 = torch.bfloat16, torch.float32
  dz = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
  act = torch.relu(torch.randn(n, d, generator=gen, device="cuda")).to(bf16)
  w = ((torch.rand(d, d, generator=gen, device="cuda") * 2 - 1)
       * 0.05).to(bf16)
  out = torch.empty_like(dz)
  rows, splits = fm.wgrad_splits(n, d, sm, bf16)
  pw = torch.empty(splits, d, d, dtype=f32, device="cuda")
  pb = torch.empty(splits, d, dtype=f32, device="cuda")
  dw = torch.empty(d, d, dtype=f32, device="cuda")
  db = torch.empty(d, dtype=f32, device="cuda")

  def wgrad(reduce=True):
    fm.fused_mlp_bwd_wgrad_bf16(act, dz, pw, pb, rows)
    if reduce:
      fm.fused_mlp_bwd_reduce(pw, pb, dw, db)

  # the checks against the plain versions
  prod = dz.float() @ w.float().t()
  errs = {"dgrad": _rel(fm.fused_mlp_bwd_dgrad_bf16(dz, w, act, out),
                        (prod * (act > 0)).to(bf16)),
          "dx": _rel(fm.fused_mlp_bwd_dgrad_bf16(dz, w, None, out),
                     prod.to(bf16))}
  del prod
  wgrad()
  errs["wgrad"] = max(_rel(dw, act.float().t() @ dz.float()),
                      _rel(db, dz.float().sum(0)))
  torch.cuda.synchronize()

  dgrad_ms = _ab({
      "dgrad": lambda: fm.fused_mlp_bwd_dgrad_bf16(dz, w, act, out),
      "dgrad, no mask": lambda: fm.fused_mlp_bwd_dgrad_bf16(dz, w, None, out),
      "library GEMM": lambda: torch.matmul(dz, w.t()),
      "library GEMM * mask": lambda: torch.matmul(dz, w.t()) * (act > 0)})
  wgrad_ms = _ab({
      "wgrad + reduce": wgrad,
      "wgrad alone": lambda: wgrad(False),
      "reduce alone": lambda: fm.fused_mlp_bwd_reduce(pw, pb, dw, db),
      "library": lambda: act.t() @ dz})
  flop = 2.0 * n * d * d
  mask_ms = n * d * 2 / HBM_RATE * 1e3
  res = dict(
      shape=name, n=n, d=d, errs=errs, dgrad_ms=dgrad_ms,
      dgrad_yardstick_ms=dgrad_ms["library GEMM"] + mask_ms,
      dgrad_bound_ms=_bound((3 * n * d + d * d) * 2, flop),
      dx_bound_ms=_bound((2 * n * d + d * d) * 2, flop),
      wgrad_ms=wgrad_ms, splits=splits, rows_per_split=rows,
      partial_bytes=(pw.numel() + pb.numel()) * 4,
      reduce_share=wgrad_ms["reduce alone"] / wgrad_ms["wgrad + reduce"],
      wgrad_bound_ms=_bound(2 * n * d * 2 + (d * d + d) * 4, flop))
  del dz, act, w, out, pw, pb, dw, db
  torch.cuda.empty_cache()
  return res


def main() -> int:
  if not torch.cuda.is_available():
    print("k1_bf16 probe: no CUDA device", file=sys.stderr)
    return 1
  card = _card()
  print(card, flush=True)
  sm = torch.cuda.get_device_properties(0).multi_processor_count
  ok = True
  for name, n, d in SHAPES:
    r = probe_shape(name, n, d, sm)
    r["card"] = card
    print(json.dumps(r), flush=True)
    ok &= all(r["errs"][k] <= TOL[k] for k in TOL)
  print(json.dumps({"ok": ok}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
