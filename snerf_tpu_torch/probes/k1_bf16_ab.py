"""A/B of K1's bf16 dgrad and wgrad designs on the card: the shipped
kernels against variants built from text patches of
`snerf_tpu_torch/csrc/fused_mlp.cu`, by CUDA events in turns (every
variant, then every variant in reverse order), beside the bf16
`torch.matmul` of the same product, at the bf16 training paths' layer
shapes.

dgrad (masked and without the mask):
- `no_stores`: warp 9 skips the TMA stores (wrong output; what the
  epilogue's stores cost);
- `band_major`: a block takes a band's column tiles one after another
  (tiles b ctiles .. b ctiles + ctiles - 1, then b + gridDim.x ..) rather
  than the tiles b, b + gridDim.x, ..;
- `skew`: warpgroup 1 starts its first stage after warpgroup 0 retired its
  own, so that their epilogues need not meet.

wgrad (+ the reduce), at the shipped split (about 64 waves of 2,048-row
runs, 1 GiB of partials at 2,097,152 x 512) and at one wave of long
splits (`one_wave`: d / 128 x d / 256 tiles times 132 // tiles splits):
- the shipped kernel at both splits (the long split adds its accumulator
  into its partial in device memory every 2,048 rows);
- `no_db`: no block sums db;
- `no_promote`: each 2,048-row run's end stores the partial, never
  reads it back and adds (wrong sums past 2,048 rows);
- `no_promote_no_db`: both;
- `mainloop`: both, and the partial stored once, after the last run
  (wrong sums; the loads and wgmmas alone).

Each kept kernel is held to its plain version (TOL of max|plain|); the
variants that change the result are timed only. Prints the card's name
and power limit, the variants' ptxas lines, one JSON line a shape.

  python -m snerf_tpu_torch.probes.k1_bf16_ab
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from snerf_tpu_torch.ops import _cuda
from snerf_tpu_torch.ops import fused_mlp as fm
from snerf_tpu_torch.probes.k1_bf16 import SHAPES, _ab, _card, _rel

# (variant, [(text in the shipped source, its replacement)])
PATCHES = {
    "no_stores": [(
        "              tma_store(&tm_out, ring.e(h) + q * kDBoxElems, "
        "prev_c0 + 64 * q,",
        "              if (n < 0) tma_store(&tm_out, ring.e(h) + q * "
        "kDBoxElems, prev_c0 + 64 * q,")],
    "band_major": [
        ("  const int tiles = (n + kHBM - 1) / kHBM * ctiles;\n",
         "  const int tiles = (n + kHBM - 1) / kHBM * ctiles;\n"
         "  const auto next = [=](int tile) {\n"
         "    return tile % ctiles == ctiles - 1\n"
         "               ? tile + (gridDim.x - 1) * ctiles + 1 : tile + 1;\n"
         "  };\n"),
        ("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {",
         "for (int tile = blockIdx.x * ctiles; tile < tiles; "
         "tile = next(tile)) {"),
        ("for (int tile = blockIdx.x;; tile += gridDim.x, ++tc) {",
         "for (int tile = blockIdx.x * ctiles;; tile = next(tile), ++tc) {"),
        ("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, "
         "++tc) {",
         "for (int tile = blockIdx.x * ctiles; tile < tiles; "
         "tile = next(tile), ++tc) {"),
        ("  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);",
         "  const long long bands = (n + kHBM - 1) / kHBM;\n"
         "  const unsigned grid = (unsigned)(bands < sms ? bands : sms);")],
    "skew": [
        ("  bf16* e = ring.e(wg);\n  float acc[kQBN / 2];\n"
         "  int it = 0, tc = 0;\n",
         "  bf16* e = ring.e(wg);\n  float acc[kQBN / 2];\n"
         "  int it = 0, tc = 0;\n"
         "  if (wg == 1 && (int)blockIdx.x < tiles)\n"
         "    named_barrier_sync(4, 256);\n"),
        ("                    smem_desc(ring.b(s)), lane);\n    }\n",
         "                    smem_desc(ring.b(s)), lane);\n"
         "      if (wg == 0 && it == 0)\n"
         "        asm volatile(\"bar.arrive 4, 256;\\n\" ::: \"memory\");\n"
         "    }\n")],
    "no_db": [("    const bool db_block = blockIdx.y == 0;",
               "    const bool db_block = false;")],
    "no_promote": [("          if (c0 > 0) {", "          if (c0 < 0) {")],
}
PATCHES["no_promote_no_db"] = PATCHES["no_promote"] + PATCHES["no_db"]
PATCHES["mainloop"] = PATCHES["no_promote_no_db"] + [(
    "          *p = v;\n        }\n      }\n    }\n    if (db_block)",
    "          if (c0 + kQPromoteStages >= stages) *p = v;\n        }\n"
    "      }\n    }\n    if (db_block)")]
DGRAD = ("no_stores", "band_major", "skew")
WGRAD = ("no_db", "no_promote", "no_promote_no_db", "mainloop")
TOL = 2e-2


def _build(name, patches, out_dir):
  src = (_cuda.CSRC / "fused_mlp.cu").read_text()
  for old, new in patches:
    if src.count(old) != 1:
      raise RuntimeError(f"{name}: patch target found {src.count(old)} "
                         f"times: {old[:60]!r}")
    src = src.replace(old, new)
  path = out_dir / f"fused_mlp_{name}.cu"
  path.write_text(src)
  so = out_dir / f"fused_mlp_{name}.so"
  proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                         str(path)], capture_output=True, text=True)
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}")
  lib = ctypes.CDLL(str(so))
  lib.snerf_cuda_error_string.argtypes = [ctypes.c_int]
  lib.snerf_cuda_error_string.restype = ctypes.c_char_p
  fm._bind(lib)
  regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
          if "spill" in line]
  return lib, regs


def _one_wave(n, d, sm):
  """(rows_per_split, splits): one wave of blocks, long splits."""
  splits = max(1, min(sm // ((d // 128) * (d // 256)), -(-n // 2048)))
  rows = -(-(-(-n // splits)) // 64) * 64
  return rows, -(-n // rows)


def ab_shape(name, n, d, libs, sm):
  gen = torch.Generator(device="cuda").manual_seed(n + d)
  bf16, f32 = torch.bfloat16, torch.float32
  dz = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
  act = torch.relu(torch.randn(n, d, generator=gen, device="cuda")).to(bf16)
  w = ((torch.rand(d, d, generator=gen, device="cuda") * 2 - 1)
       * 0.05).to(bf16)
  out = torch.empty_like(dz)
  stream = torch.cuda.current_stream().cuda_stream

  def dgrad(lib, mask):
    def run():
      err = lib.snerf_fused_mlp_bwd_dgrad_bf16(
          dz.data_ptr(), w.data_ptr(), None if mask is None else
          mask.data_ptr(), out.data_ptr(), n, d, 0, stream)
      _cuda.check_launch(lib, err, "dgrad variant")
    return run

  prod = dz.float() @ w.float().t()
  want = {"mask": (prod * (act > 0)).to(bf16), "no mask": prod.to(bf16)}
  del prod
  errs = {}
  for v in ("shipped", "band_major", "skew"):
    for m, mask in (("mask", act), ("no mask", None)):
      dgrad(libs[v], mask)()
      errs[f"dgrad {v}, {m}"] = _rel(out, want[m])
  del want
  fns = {"library GEMM": lambda: torch.matmul(dz, w.t())}
  for v in ("shipped", *DGRAD):
    fns[f"{v}, mask"] = dgrad(libs[v], act)
    fns[f"{v}, no mask"] = dgrad(libs[v], None)
  dgrad_ms = _ab(fns)

  splits = {"shipped": fm.wgrad_splits(n, d, sm, bf16),
            "one_wave": _one_wave(n, d, sm)}
  bufs = {k: (torch.empty(s, d, d, dtype=f32, device="cuda"),
              torch.empty(s, d, dtype=f32, device="cuda"))
          for k, (_, s) in splits.items()}
  dw = torch.empty(d, d, dtype=f32, device="cuda")
  db = torch.empty(d, dtype=f32, device="cuda")

  def wgrad(lib, split):
    rows, s = splits[split]
    pw, pb = bufs[split]

    def run():
      err = lib.snerf_fused_mlp_bwd_wgrad_bf16(
          act.data_ptr(), dz.data_ptr(), pw.data_ptr(), pb.data_ptr(), n, d,
          rows, s, 0, stream)
      _cuda.check_launch(lib, err, "wgrad variant")
      err = lib.snerf_fused_mlp_bwd_reduce(
          pw.data_ptr(), pb.data_ptr(), dw.data_ptr(), db.data_ptr(), d, d, s,
          0, stream)
      _cuda.check_launch(lib, err, "reduce")
    return run

  want_w, want_b = act.float().t() @ dz.float(), dz.float().sum(0)
  for split in splits:
    wgrad(libs["shipped"], split)()
    errs[f"wgrad shipped, {split}"] = max(_rel(dw, want_w), _rel(db, want_b))
  del want_w, want_b
  fns = {"library": lambda: act.t() @ dz}
  for split in splits:
    for v in ("shipped", *WGRAD):
      fns[f"{v}, {split} ({splits[split][1]} splits)"] = wgrad(libs[v], split)
  wgrad_ms = _ab(fns)
  del dz, act, w, out, bufs, dw, db
  torch.cuda.empty_cache()
  return dict(shape=name, n=n, d=d, errs=errs, dgrad_ms=dgrad_ms,
              wgrad_ms=wgrad_ms)


def main() -> int:
  if not torch.cuda.is_available():
    print("k1_bf16_ab: no CUDA device", file=sys.stderr)
    return 1
  card = _card()
  print(card, flush=True)
  out_dir = _cuda.BUILD_DIR / "k1_bf16_ab"
  out_dir.mkdir(parents=True, exist_ok=True)
  t0 = time.time()
  names = ("shipped", *DGRAD, *WGRAD)
  with ThreadPoolExecutor(len(names)) as pool:
    built = dict(zip(names, pool.map(
        lambda v: _build(v, PATCHES.get(v, []), out_dir), names)))
  print(json.dumps({"built_s": time.time() - t0,
                    "spills": {k: v[1] for k, v in built.items()}}),
        flush=True)
  libs = {k: v[0] for k, v in built.items()}
  sm = torch.cuda.get_device_properties(0).multi_processor_count
  ok = True
  for name, n, d in SHAPES:
    r = ab_shape(name, n, d, libs, sm)
    r["card"] = card
    print(json.dumps(r), flush=True)
    ok &= all(e <= TOL for e in r["errs"].values())
  print(json.dumps({"ok": ok}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
