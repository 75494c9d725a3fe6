"""A/B of K1's bf16 backward kernels on the card: which schedule costs
what, at the bf16 training paths' layer shapes.

K1's bf16 dgrad and wgrad (`csrc/fused_mlp.cu`) run slower than one bf16
`torch.matmul` of the same product. This probe times, by CUDA events in
turns (A, B, B, A), variants that each move one suspect:

- dgrad against dgrad without the ReLU mask (the mask read in the
  epilogue), and the bf16 forward at one layer (the same product with the
  weights MN-major, a bias and no mask);
- wgrad at the shipped split of N (`wgrad_splits`: about 64 waves of
  blocks, each split at least 2,048 rows) against 4, 16 and 32 waves,
  and wgrad without its reduce;
- beside each, the bf16 PyTorch call and the bound (bytes over 3.35 TB/s,
  products over 989 TFLOP/s).

A change of split reorders wgrad's f32 sums: each variant is held to
WGRAD_SPLIT_TOL of max|dW| and max|db| against the shipped split. Prints
the card's name and power limit and one JSON line a shape; exits 1 if a
check fails.

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
# wgrad's partials are summed in another order when the split changes:
# as a fraction of max|dW|
WGRAD_SPLIT_TOL = 1e-5


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


def probe_shape(name, n, d, sm):
  gen = torch.Generator(device="cuda").manual_seed(n + d)
  bf16, f32 = torch.bfloat16, torch.float32
  dz = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
  act = torch.relu(torch.randn(n, d, generator=gen, device="cuda")).to(bf16)
  w = ((torch.rand(d, d, generator=gen, device="cuda") * 2 - 1)
       * 0.05).to(bf16)
  b = ((torch.rand(1, 1, d, generator=gen, device="cuda") * 2 - 1)
       * 0.05).to(bf16)
  out = torch.empty_like(dz)
  wl = w[None]
  dgrad_ms = _ab({
      "dgrad": lambda: fm.fused_mlp_bwd_dgrad_bf16(dz, w, act, out),
      "dgrad, no mask": lambda: fm.fused_mlp_bwd_dgrad_bf16(dz, w, None, out),
      "forward, one layer": lambda: fm.fused_mlp_fwd_bf16(
          act, wl, b, out, None, None, True),
      "library": lambda: torch.matmul(dz, w.t())})

  def wgrad_fn(waves):
    rows, splits = fm.wgrad_splits(n, d, sm, bf16, waves)
    pw = torch.empty(splits, d, d, dtype=f32, device="cuda")
    pb = torch.empty(splits, d, dtype=f32, device="cuda")
    dw = torch.empty(d, d, dtype=f32, device="cuda")
    db = torch.empty(d, dtype=f32, device="cuda")

    def run(reduce=True):
      fm.fused_mlp_bwd_wgrad_bf16(act, dz, pw, pb, rows)
      if reduce:
        fm.fused_mlp_bwd_reduce(pw, pb, dw, db)
      return dw, db
    return run, splits

  runs = {"shipped": wgrad_fn(0)}
  runs.update({f"{v} waves": wgrad_fn(v) for v in (4, 16, 32)})
  ref = [t.clone() for t in runs["shipped"][0]()]
  wgrad_err = {}
  for k, (run, _) in runs.items():
    got = run()
    wgrad_err[k] = max(float((g - r).abs().max()) / float(r.abs().max())
                       for g, r in zip(got, ref))
  wgrad = {f"{k} ({s} splits)": run for k, (run, s) in runs.items()}
  wgrad["shipped, no reduce"] = lambda: runs["shipped"][0](False)
  wgrad["library"] = lambda: act.t() @ dz
  wgrad_ms = _ab(wgrad)

  flop = 2.0 * n * d * d
  res = dict(
      shape=name, n=n, d=d,
      dgrad_ms=dgrad_ms, dgrad_bound_ms=_bound((3 * n * d + d * d) * 2, flop),
      fwd_bound_ms=_bound((2 * n * d + d * d + d) * 2, flop),
      wgrad_ms=wgrad_ms,
      wgrad_bound_ms=_bound(2 * n * d * 2 + (d * d + d) * 4, flop),
      wgrad_err_vs_shipped=wgrad_err)
  del dz, act, w, out, runs
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
    ok &= max(r["wgrad_err_vs_shipped"].values()) <= WGRAD_SPLIT_TOL
  print(json.dumps({"ok": ok}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
