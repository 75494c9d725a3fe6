"""Multiresolution hash-grid encoder, instant-NGP style, and its
hash-decay regulariser: the level layout, the xor-prime hash and the
dense stride indexing, with the encode by the per-level plain version
(`table[idx]` and the trilinear blend under PyTorch's autograd)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from bench_port.reference.ops.hash_encode import hash_encode_fwd_plain

EncodeFn = Callable[..., torch.Tensor]


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


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: GridSpec):
  """Encode x [..., 3] in [0, 1]^3 -> [..., num_levels, level_dim] by the
  per-level plain version under PyTorch's autograd."""
  batch_shape = x.shape[:-1]
  out = hash_encode_fwd_plain(x.reshape(-1, 3), table, spec)
  return out.reshape(*batch_shape, spec.num_levels, spec.level_dim)


class HashEncoding(nn.Module):
  """Owns the table `embeddings` [total_rows, level_dim] (the reference
  GridEncoder's parameter name) and encodes with `encode_fn`
  (`hash_encode`)."""

  def __init__(self, num_levels: int = 10, level_dim: int = 4,
               base_resolution: int = 16, desired_resolution: int = 8192,
               log2_hashmap_size: int = 21, init_std: float = 1e-4,
               encode_fn: EncodeFn = hash_encode, device="cuda"):
    super().__init__()
    self.spec = make_grid_spec(num_levels, level_dim, base_resolution,
                               desired_resolution, log2_hashmap_size)
    self.encode_fn = encode_fn
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
    return self.encode_fn(x, self.embeddings, self.spec)


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
