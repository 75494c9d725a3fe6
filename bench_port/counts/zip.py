"""FLOPs and bytes of the zip-nerf step and render chunk, from the
configuration's shapes (a ZipNerfConfig's fields) and the batch, never
from the program: the work the step needs, whatever implements it.

Products (the `*_mfu` numerators): every Linear layer of the three MLPs
and every CP profile matmul, in the dtype it runs in (the compute dtype
in training, float32 in eval and render). Training counts each Linear
three times (forward, dgrad, wgrad; every trunk input needs its gradient,
since the encoders' tables train) and each CP matmul twice (forward and
the table's gradient; the profiles' inputs need none). A checkpoint's
recompute is not counted, nor is a split of a float32 product into three
TF32 ones: a product is counted once, at its dtype's peak (bf16 989
TFLOP/s; float32 495, the TF32 ceiling no float32 product can pass).

K1 (the trunks' runs of square layers, as `mlp._run_trunk` forms them)
and the hash encode: each op's bound is max(FLOPs / peak, bytes / HBM
rate), each input byte read once and each output byte written once.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterable, List, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

Product = Tuple[str, float, str]      # (name, FLOPs, "bf16" | "f32")


def peak(dtype: str) -> float:
  return PEAKS["bf16_flop_s"] if dtype == "bf16" else PEAKS["tf32_flop_s"]


def bound_s(flops: float, nbytes: float, rate: float) -> float:
  return max(flops / rate, nbytes / PEAKS["hbm_byte_s"])


def _cp_resolutions(num_levels: int, base: int, top: int) -> List[int]:
  if num_levels <= 1:
    return [int(top)]
  g = (top / base) ** (1.0 / (num_levels - 1))
  return [int(round(base * g ** l)) for l in range(num_levels)]


def _level_samples(c, i: int) -> int:
  return (c.num_prop_samples[i] if i < c.num_levels - 1
          else c.num_nerf_samples)


def _aniso(c) -> bool:
  return ((c.ipe_anisotropic and c.encoder_type == "ipe")
          or (c.cp_anisotropic and c.encoder_type.startswith("cp")))


def mlp_shapes(c, level: int):
  """(linear layers [(name, in, out, runs_in_compute_dtype)], K1 runs
  [(D, layers)], CP matmuls per row [(R, F)]) of one MLP."""
  prop = level < c.num_levels - 1
  out_width = 1 if prop else c.bottleneck_width
  res = (c.prop_grid_resolutions[min(level, len(c.prop_grid_resolutions) - 1)]
         if prop else c.nerf_grid_resolution)
  linears, runs, cp = [], [], []
  if c.encoder_type == "hash":
    level_dim = c.prop_grid_level_dim if prop else c.nerf_grid_level_dim
    enc = c.grid_num_levels * level_dim
    linears += [("density_layer.0", enc, c.density_hidden_width, True),
                ("density_layer.2", c.density_hidden_width, out_width, True)]
  else:
    enc = 6 * c.ipe_max_deg if c.encoder_type != "cp" else 0
    if c.encoder_type.startswith("cp"):
      nl = c.cp_prop_num_levels if prop else c.cp_num_levels
      f = c.cp_prop_level_dim if prop else c.cp_level_dim
      pair = 0 if prop else c.cp_pair_dim
      for r in _cp_resolutions(nl, min(c.cp_base_resolution, res),
                               min(c.cp_max_resolution, res)):
        cp += [(r, f)] * 3 + [(r, pair)] * (3 if pair else 0)
      enc += nl * (f + 3 * pair)
    if c.encoder_type == "cp_hash" and not prop:
      enc += c.cp_hash_num_levels * c.cp_hash_level_dim
    skip = c.ipe_skip_layer
    skip_after = {i for i in range(c.ipe_density_depth)
                  if skip > 0 and i > 0 and i % skip == 0}
    blocks = [(f"ipe_layers.{i}", c.ipe_density_width)
              for i in range(c.ipe_density_depth)]
    blocks.append(("density_hidden", c.density_hidden_width))
    width, run = enc, []
    for i, (name, out) in enumerate(blocks):
      if width == out:
        run.append(name)
      else:
        if run:
          runs.append((width, len(run)))
          run = []
        linears.append((name, width, out, True))
      width = out
      if i in skip_after:
        if run:
          runs.append((width, len(run)))
          run = []
        width = out + enc
    if run:
      runs.append((width, len(run)))
    linears.append(("density_out", c.density_hidden_width, out_width, True))
  if not prop:
    dir_w = 3 + 2 * 3 * c.deg_view if c.use_viewdirs else 0
    view_in = c.bottleneck_width + dir_w
    width = view_in
    for i in range(c.net_depth_viewdirs):
      linears.append((f"lin_second_stage_{i}", width, c.net_width_viewdirs,
                      True))
      width = c.net_width_viewdirs + (view_in if i == 0 else 0)
    linears.append(("rgb_layer", width, 3, False))
  return linears, runs, cp


def _dtype(c, compute: bool, train: bool) -> str:
  bf16 = "bfloat16" in str(c.compute_dtype)
  return "bf16" if (train and compute and bf16) else "f32"


def products(c, rays: int, train: bool) -> List[Product]:
  """The matrix products of one step (train) or one render chunk of
  `rays` rays."""
  out = []
  for level in range(c.num_levels):
    rows = rays * _level_samples(c, level)
    linears, runs, cp = mlp_shapes(c, level)
    k = 3 if train else 1
    for name, i, o, compute in linears:
      out.append((f"mlp{level}.{name}", k * 2.0 * rows * i * o,
                  _dtype(c, compute, train)))
    for d, n in runs:
      out.append((f"mlp{level}.trunk_run_{d}x{n}", k * 2.0 * rows * d * d * n,
                  _dtype(c, True, train)))
    m = rows if (c.cp_collapse_multisamples or _aniso(c)) \
        else rows * c.sample_n
    for r, f in cp:
      out.append((f"mlp{level}.cp_{r}x{f}", (2 if train else 1) * 2.0 * m * r
                  * f, _dtype(c, True, train)))
  return out


def products_bound_s(c, rays: int, train: bool) -> float:
  """The least time the chip could take for the products."""
  return sum(fl / peak(dt) for _, fl, dt in products(c, rays, train))


def k1_bound_s(c, rays: int, train: bool) -> float:
  """The sum of the bounds of K1's ops: per run a forward (keeping every
  layer's output in training), and per layer a dgrad and a wgrad."""
  total = 0.0
  for level in range(c.num_levels):
    n = rays * _level_samples(c, level)
    dt = _dtype(c, True, train)
    s = 2 if dt == "bf16" else 4
    rate = peak(dt)
    for d, layers in mlp_shapes(c, level)[1]:
      kept = layers * n * d if train else n * d
      total += bound_s(2.0 * n * d * d * layers,
                       s * (n * d + layers * (d * d + d) + kept), rate)
      if train:
        total += layers * bound_s(2.0 * n * d * d, s * (3 * n * d + d * d),
                                  rate)
        total += layers * bound_s(2.0 * n * d * d, s * (2 * n * d + d * d + d),
                                  rate)
  return total


def hash_encode_bound_s(calls: Iterable[Tuple[int, int, int, int, int]],
                        train: bool) -> float:
  """The sum of the bounds of the encode's calls, each (points N, levels
  L, channels C, table rows T, rows touched): the forward reads the
  positions and the rows touched and writes the features; the backward
  reads the positions and the features' gradient and writes the whole
  table gradient. FLOPs: the 8-corner blend, 2 C a corner, at the float32
  rate outside the tensor cores."""
  total = 0.0
  for n, lv, ch, rows, touched in calls:
    flops = 2.0 * 8 * ch * n * lv
    total += bound_s(flops, 4.0 * (3 * n + n * lv * ch + touched * ch),
                     PEAKS["f32_simt_flop_s"])
    if train:
      total += bound_s(flops, 4.0 * (3 * n + n * lv * ch + rows * ch),
                       PEAKS["f32_simt_flop_s"])
  return total


def touched_rows(x, spec) -> int:
  """Distinct table rows the positions x [..., 3] in [0, 1] touch, over
  every level of the hash layout `spec` (its scales, resolutions, sizes)."""
  import torch
  from bench_port.reference.ops.hash_encode import level_indices
  xf = x.reshape(-1, 3)
  inside = ~torch.any((xf < 0) | (xf > 1), dim=-1)
  xf = xf[inside]
  total = 0
  for lvl in range(len(spec.scales)):
    c0 = torch.floor(xf * spec.scales[lvl] + 0.5).long()
    idx = level_indices(c0, spec.resolutions[lvl], spec.sizes[lvl])
    total += int(torch.unique(idx.reshape(-1)).numel())
  return total


def hash_calls(recorded) -> List[Tuple[int, int, int, int, int]]:
  """(N, L, C, T, rows touched) of each recorded encode (x, spec, T)."""
  return [(math.prod(x.shape[:-1]), len(spec.scales), spec.level_dim, rows,
           touched_rows(x, spec)) for x, spec, rows in recorded]
