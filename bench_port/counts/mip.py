"""FLOPs and bytes of the S-NeRF mip train step, from the configuration's
shapes (a MipNerfConfig's fields) and the batch, never from the program:
the work the step needs, whatever implements it.

Products (the `*_mfu` numerators): every Linear layer of the proposal MLP
(on `num_samples` rows a ray) and of the fine NerfMLP (on
`num_fine_intervals` rows a ray): the trunk with its skip-cat, the
density, semantic and bottleneck layers, the view branch and the rgb
head. Training counts each three times (forward, dgrad, wgrad): every
MLP input needs its gradient, since the rays, and with them the IPE
features and the view directions, carry the refined pose table's. Each
product is counted once at its dtype's peak (counts/zip.py `peak`: the
mip model runs float32, at 495 TFLOP/s, the TF32 ceiling no float32
product can pass), never as the three TF32 products K1 splits it into.

K1 (the trunks' runs of square layers, as `mlp._run_trunk` forms them:
the proposal's layers 1-3 and the fine trunk's 1-4 and 6-7): each op's
bound by `counts/zip.py`'s rule, max(FLOPs / peak, bytes / HBM rate),
each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import List, Tuple

from bench_port.counts.zip import Product, bound_s, peak

DTYPE = "f32"


def _trunk(in_features: int, width: int, depth: int, skip_after):
  """([(name, in, out)] of the trunk's non-square layers, [(D, layers)]
  of its runs of square ones), as `_run_trunk` splits them."""
  linears, runs, run = [], [], 0
  w = in_features
  for i in range(depth):
    if w == width:
      run += 1
    else:
      if run:
        runs.append((width, run))
        run = 0
      linears.append((f"layers.{i}", w, width))
    w = width
    if i in skip_after:
      if run:
        runs.append((width, run))
        run = 0
      w = width + in_features
  if run:
    runs.append((width, run))
  return linears, runs, w


def mlp_shapes(c):
  """{level: (rows a ray, [(name, in, out)], [(D, layers)])} of the
  proposal MLP (level 0) and the fine NerfMLP (level 1)."""
  enc = 2 * 3 * (c.max_deg_point - c.min_deg_point)
  cond = 3 + 2 * 3 * c.deg_view if c.use_viewdirs else 0
  prop_lin, prop_runs, w = _trunk(enc, c.proposal_hidden_layer, 4, ())
  prop_lin.append(("density_layer", w, 1))
  skip = tuple(i for i in range(8) if i > 0 and i % 4 == 0)
  fine_lin, fine_runs, w = _trunk(enc, c.hidden_layer, 8, skip)
  fine_lin.append(("density_layer", w, 1))
  if c.semantic:
    fine_lin += [("semantic_hidden", w, c.hidden_layer // 2),
                 ("semantic_out", c.hidden_layer // 2, c.semantic_class_num)]
  head_in = w
  if cond:
    fine_lin.append(("bottleneck_layer", w, c.hidden_layer))
    head_in = c.hidden_layer + cond
    for i in range(c.rgb_layer):
      fine_lin.append((f"cond_layers.{i}", head_in, 128))
      head_in = 128
  fine_lin.append(("rgb_layer", head_in, 3))
  return {0: (c.num_samples, prop_lin, prop_runs),
          1: (c.num_fine_intervals, fine_lin, fine_runs)}


def products(c, rays: int) -> List[Product]:
  """The matrix products of one train step of `rays` rays."""
  out = []
  for level, (per_ray, linears, runs) in mlp_shapes(c).items():
    rows = rays * per_ray
    for name, i, o in linears:
      out.append((f"mlp{level}.{name}", 3 * 2.0 * rows * i * o, DTYPE))
    for d, n in runs:
      out.append((f"mlp{level}.trunk_run_{d}x{n}", 3 * 2.0 * rows * d * d * n,
                  DTYPE))
  return out


def products_bound_s(c, rays: int) -> float:
  """The least time the chip could take for the step's products."""
  return sum(fl / peak(dt) for _, fl, dt in products(c, rays))


def k1_ops(c, rays: int) -> List[Tuple[str, float, float]]:
  """(op, FLOPs, bytes) of K1's ops in a train step: per run a forward
  that keeps every layer's output, per layer a dgrad and a wgrad."""
  ops, s = [], 4
  for level, (per_ray, _, runs) in mlp_shapes(c).items():
    n = rays * per_ray
    for d, layers in runs:
      ops.append((f"mlp{level}.fwd_{d}x{layers}", 2.0 * n * d * d * layers,
                  s * (n * d + layers * (d * d + d) + layers * n * d)))
      ops += [(f"mlp{level}.dgrad_{d}", 2.0 * n * d * d,
               s * (3 * n * d + d * d))] * layers
      ops += [(f"mlp{level}.wgrad_{d}", 2.0 * n * d * d,
               s * (2 * n * d + d * d + d))] * layers
  return ops


def k1_bound_s(c, rays: int) -> float:
  """The sum of the bounds of K1's ops in a train step."""
  return sum(bound_s(fl, nb, peak(DTYPE)) for _, fl, nb in k1_ops(c, rays))
