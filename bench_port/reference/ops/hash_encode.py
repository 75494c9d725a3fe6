"""The multi-level hash encode in plain PyTorch: per level the corner
rows by `table[idx]` and the trilinear blend, differentiable by
PyTorch's autograd (the backward is its accumulating scatter-add)."""

from __future__ import annotations

import functools

import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
  """An int64 constant on `device`, made once."""
  return torch.tensor(values, device=device)


def _corner_product(a: torch.Tensor, op) -> torch.Tensor:
  """Per-axis values a [N, 2, 3] -> [N, 8] combined over the 8 cell
  corners (i, j, k), corner index i*4 + j*2 + k, as `op(op(x_i, y_j),
  z_k)`."""
  x = a[:, :, None, None, 0]
  y = a[:, None, :, None, 1]
  z = a[:, None, None, :, 2]
  return op(op(x, y), z).reshape(a.shape[0], 8)


def level_indices(c0: torch.Tensor, resolution: int, size: int):
  """Level-local row indices [N, 8] of the 8 corners of the cells whose
  low corner is c0 [N, 3] (int64): dense stride indexing when the
  (res+1)^3 grid fits the table, else the xor-prime hash in uint32
  arithmetic, then mod size."""
  corners = c0[:, None, :] + _const(((0,), (1,)), c0.device)  # [N, 2, 3]
  r = resolution + 1
  if r ** 3 <= size:
    stride = _const((1, r, r * r), c0.device)
    return _corner_product(corners * stride, torch.add) % size
  h = _corner_product((corners * _const(_PRIMES, c0.device)) & _U32,
                      torch.bitwise_xor)
  return h % size


def _level_cell(xf: torch.Tensor, spec, lvl: int):
  """(level-local row indices [N, 8] int32, the per-axis factors [N, 2, 3]:
  1 - frac and frac) of every point's cell at one level."""
  pos = xf * spec.scales[lvl] + 0.5
  c0 = torch.floor(pos)
  frac = pos - c0
  idx = level_indices(c0.long(), spec.resolutions[lvl], spec.sizes[lvl])
  return idx.int(), torch.stack([1.0 - frac, frac], dim=1)


def level_rows_weights(xf: torch.Tensor, spec, lvl: int):
  """(level-local row indices [N, 8] int32, trilinear weights [N, 8])."""
  idx, a = _level_cell(xf, spec, lvl)
  return idx, _corner_product(a, torch.mul)


def _out_of_range(xf: torch.Tensor) -> torch.Tensor:
  return torch.any((xf < 0) | (xf > 1), dim=-1)


def hash_encode_fwd_plain(xf: torch.Tensor, table: torch.Tensor, spec):
  """Features [N, L, C] of flat x [N, 3] from table [total_rows, C]: per
  level the rows by `table[idx]` and the blend w_0 r_0 + w_1 r_1 + ...
  added in corner order; zeros for a point outside [0, 1]^3."""
  if xf.dim() != 2 or xf.shape[1] != 3:
    raise ValueError(f"hash_encode: x must be [N, 3], got {tuple(xf.shape)}")
  levels = torch.split(table, list(spec.sizes))
  feats = []
  for lvl in range(spec.num_levels):
    idx, w = level_rows_weights(xf, spec, lvl)
    rows = levels[lvl][idx.long()]                           # [N, 8, C]
    acc = w[:, 0, None] * rows[:, 0]
    for k in range(1, 8):
      acc = acc + w[:, k, None] * rows[:, k]
    feats.append(acc)
  out = torch.stack(feats, dim=-2)
  return torch.where(_out_of_range(xf)[:, None, None], 0.0, out)
