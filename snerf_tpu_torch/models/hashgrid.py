"""Multiresolution hash-grid encoder, instant-NGP style (counterpart of
snerf_tpu/models/hashgrid.py), and its hash-decay regulariser.

The level layout, the xor-prime hash and the dense stride indexing are
the JAX module's, bit for bit. The table is split once into its levels
(one `torch.split`), and each level's rows are fetched from its own slice
with level-local indices by one row gather (`ops/hash_ops.gather_rows`,
kernel K2 on the GPU), the same kernel for dense and hashed levels. When
the table requires grad, the gather's backward is one scatter-add per
level (the scatter-add kernel on the GPU) into a gradient of that level's
rows only, and the split's backward writes the table's gradient once.

What the backward keeps: the JAX encoder recomputes each level's indices
and weights under `jax.checkpoint`; here autograd keeps them, the [N, 8]
int32 indices (in the gather) and the [N, 8] trilinear weights (in the
blend), 64 bytes a point and level, and never the gathered rows. That
fits the card at the shipped batch (PERF.md), so nothing is recomputed.
When the positions carry grad (pose refinement), the blend also keeps the
rows and the grad reaches the positions through the weights.
`total_variation_loss` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch import nn

from snerf_tpu_torch.ops.hash_ops import gather_rows

GatherFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridSpec:
  """Static per-level layout."""
  scales: tuple          # float: x*scale+0.5 grid coords per level
  resolutions: tuple     # int: stride base (res+1 per dim, align=False)
  sizes: tuple           # int: table entries per level
  offsets: tuple         # int: start row of each level (+ total at end)
  level_dim: int

  @property
  def num_levels(self):
    return len(self.scales)

  @property
  def total_rows(self):
    return self.offsets[-1]


def make_grid_spec(num_levels: int = 10,
                   level_dim: int = 4,
                   base_resolution: int = 16,
                   desired_resolution: int = 8192,
                   log2_hashmap_size: int = 21,
                   input_dim: int = 3) -> GridSpec:
  if desired_resolution is not None and num_levels > 1:
    per_level_scale = np.exp2(
        np.log2(desired_resolution / base_resolution) / (num_levels - 1))
  else:
    per_level_scale = 2.0
  max_params = 2 ** log2_hashmap_size
  scales, resolutions, sizes, offsets = [], [], [], [0]
  for lvl in range(num_levels):
    scale = base_resolution * per_level_scale ** lvl - 1.0
    res = int(np.ceil(scale)) + 1
    size = min(max_params, (res + 1) ** input_dim)
    size = int(np.ceil(size / 8) * 8)
    scales.append(float(scale))
    resolutions.append(res)
    sizes.append(size)
    offsets.append(offsets[-1] + size)
  return GridSpec(tuple(scales), tuple(resolutions), tuple(sizes),
                  tuple(offsets), level_dim)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
  """An int64 constant on `device`, made once: a fresh host-to-device copy
  in every level would stall the host on the device."""
  return torch.tensor(values, device=device)


def _corner_product(a: torch.Tensor, op) -> torch.Tensor:
  """Per-axis values a [N, 2, 3] -> [N, 8] combined over the 8 cell
  corners (i, j, k), corner index i*4 + j*2 + k, as `op(op(x_i, y_j),
  z_k)`: the JAX module's corner order."""
  x = a[:, :, None, None, 0]
  y = a[:, None, :, None, 1]
  z = a[:, None, None, :, 2]
  return op(op(x, y), z).reshape(a.shape[0], 8)


def _level_indices(c0: torch.Tensor, resolution: int, size: int):
  """Level-local row indices [N, 8] of the 8 corners of the cells whose
  low corner is c0 [N, 3] (int64).

  Dense stride indexing when the (res+1)^3 grid fits the table, else the
  xor-prime hash in uint32 arithmetic: each product is reduced mod 2^32
  (exact in int64 for |corner| < 2^33), then xor, then mod size. The
  per-axis terms are computed once and combined over the corners.
  """
  corners = c0[:, None, :] + _const(((0,), (1,)), c0.device)  # [N, 2, 3]
  r = resolution + 1
  if r ** 3 <= size:
    stride = _const((1, r, r * r), c0.device)
    return _corner_product(corners * stride, torch.add) % size
  h = _corner_product((corners * _const(_PRIMES, c0.device)) & _U32,
                      torch.bitwise_xor)
  return h % size


def _level_rows_weights(xf: torch.Tensor, spec: GridSpec, lvl: int):
  """(level-local row indices [N, 8] int32, trilinear weights [N, 8]) for
  one level; the JAX module's table rows are these plus offsets[lvl]."""
  pos = xf * spec.scales[lvl] + 0.5
  c0 = torch.floor(pos)
  frac = pos - c0
  idx = _level_indices(c0.long(), spec.resolutions[lvl], spec.sizes[lvl])
  w = _corner_product(torch.stack([1.0 - frac, frac], dim=1), torch.mul)
  return idx.int(), w


def hash_encode_level(xf: torch.Tensor, level_table: torch.Tensor,
                      spec: GridSpec, lvl: int,
                      gather_fn: GatherFn = gather_rows):
  """Trilinear features of ONE level for flat x [N, 3] in [0, 1]^3, from
  that level's rows level_table [sizes[lvl], C]."""
  idx, w = _level_rows_weights(xf, spec, lvl)
  rows = gather_fn(level_table, idx)                         # [N, 8, C]
  return (w[..., None] * rows).sum(dim=1)


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                gather_fn: GatherFn = gather_rows):
  """Encode x in [0, 1]^3 -> per-level features.

  x: [..., 3]; table: [total_rows, level_dim]. Returns [..., num_levels,
  level_dim]; inputs outside [0, 1] give zeros.
  """
  batch_shape = x.shape[:-1]
  xf = x.reshape(-1, 3)
  oob = torch.any((xf < 0) | (xf > 1), dim=-1)
  levels = torch.split(table, list(spec.sizes))
  out = torch.stack([hash_encode_level(xf, levels[lvl], spec, lvl, gather_fn)
                     for lvl in range(spec.num_levels)], dim=-2)
  out = torch.where(oob[:, None, None], 0.0, out)
  return out.reshape(*batch_shape, spec.num_levels, spec.level_dim)


class HashEncoding(nn.Module):
  """Owns the table `embeddings` [total_rows, level_dim] (the reference
  GridEncoder's parameter name)."""

  def __init__(self, num_levels: int = 10, level_dim: int = 4,
               base_resolution: int = 16, desired_resolution: int = 8192,
               log2_hashmap_size: int = 21, init_std: float = 1e-4,
               gather_fn: GatherFn = gather_rows, device="cuda"):
    super().__init__()
    self.spec = make_grid_spec(num_levels, level_dim, base_resolution,
                               desired_resolution, log2_hashmap_size)
    self.gather_fn = gather_fn
    self.embeddings = nn.Parameter(torch.empty(
        self.spec.total_rows, level_dim, device=device).uniform_(
            -init_std, init_std))
    # Per-level grid scale for the zip-nerf erf downweighting: the
    # reference's ceil(base * scale^l) + 1, one more than the stride base.
    self.register_buffer(
        "grid_sizes",
        torch.tensor(self.spec.resolutions, dtype=torch.float32,
                     device=device) + 1.0, persistent=False)

  def forward(self, x):
    return hash_encode(x, self.embeddings, self.spec, self.gather_fn)


def hash_decay_loss(table: torch.Tensor, spec: GridSpec,
                    weight: float = 0.1) -> torch.Tensor:
  """Mean squared table row per level, summed over levels, times weight.

  The levels are taken with one `torch.split`, whose backward writes the
  table's gradient once (a slice per level would allocate a table-sized
  zero gradient per level)."""
  total = table.new_zeros(())
  for rows in torch.split(table, list(spec.sizes)):
    total = total + torch.mean(torch.sum(rows ** 2, dim=-1))
  return weight * total
