"""Hash-grid table row gather, kernel K2, and its scatter-add backward
(counterpart of snerf_tpu/ops/hash_ops.py `gather_rows`,
`scatter_add_rows` and `hash_gather`, and of the Pallas kernel
snerf_tpu/ops/pallas/hash_gather_dense.py with its custom VJP).

`gather_rows` launches the hand-written Hopper kernel in
`snerf_tpu_torch/csrc/hash_gather.cu` for CUDA tensors and runs
`gather_rows_plain` for CPU tensors. On the GPU one kernel serves every
level, dense or hashed: the TPU kernel's table-size limit does not exist
there. Under autograd (a table that requires grad) the gather goes
through `HashGatherFunction`, whose backward is the scatter-add
`scatter_add_rows`: the kernel in the same source for CUDA tensors, in
the variant `scatter_variant` picks from the level's size (a shared-memory
copy for the coarse one-channel levels, warp aggregation for the rest),
`scatter_add_rows_plain` (`index_add_`) for CPU tensors. Only the int32
indices are saved for the backward, never the gathered rows. The kernels
are built and loaded by `ops/_cuda.py`.

No model path runs them: the hash encoder runs the fused multi-level
encode (`ops/hash_encode.py`), which does the gather and the scatter-add
of every level inside one kernel each way and takes `scatter_variant`
for its backward. They stay as the literal counterparts of the Pallas
kernel and its VJP, held against their plain versions on the card.
"""

from __future__ import annotations

import ctypes

import torch

from snerf_tpu_torch.ops import _cuda

MAX_CHANNELS = 8


# The scatter-add's variants, as `variant` of snerf_scatter_add_rows.
_SCATTER_VARIANT_CODES = {"warp": 0, "shared": 1}
# The rule, from the zip train step's own indices and gradients on an
# H100 (PERF.md, §6): a shared copy pays only at C = 1 up to 128 KB (the
# coarse proposal levels, 4,920 to 24,392 rows); at C = 4 its per-channel
# shared atomics lose to warp aggregation.
SCATTER_SHARED_BYTES = 128 * 1024


def _bind(lib):
  lib.snerf_gather_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
  lib.snerf_gather_rows.restype = ctypes.c_int
  lib.snerf_scatter_add_rows.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
      + [ctypes.c_void_p])
  lib.snerf_scatter_add_rows.restype = ctypes.c_int


def _check_shapes(table, idx):
  if table.dim() != 2 or not 1 <= table.shape[1] <= MAX_CHANNELS:
    raise ValueError(f"table must be [T, C] with 1 <= C <= {MAX_CHANNELS}, "
                     f"got {tuple(table.shape)}")
  if idx.dtype != torch.int32:
    raise ValueError(f"idx must be int32, got {idx.dtype}")


def _wants_grad(table):
  return torch.is_grad_enabled() and table.requires_grad


def gather_rows_plain(table, idx):
  """table [T, C], idx int32 [...] -> [..., C]: `table[idx]`. Under
  autograd PyTorch's own backward of the indexing, an accumulating
  scatter-add, makes it the plain pair."""
  _check_shapes(table, idx)
  return table[idx.long()]


def gather_rows(table, idx):
  """Row gather: table [T, C] float32, idx int32 [...] -> [..., C].

  Precondition: every index lies in [0, T); the hash encoder builds them
  so (level offset + stride or hash modulo the level size), and neither
  version checks it. CPU tensors run `gather_rows_plain`. CUDA tensors
  launch the kernel (table and idx contiguous on one device, C <= 8) or
  raise; `gather_rows.launches` counts the launches. A table that
  requires grad goes through `HashGatherFunction` (backward:
  `scatter_add_rows`).
  """
  _check_shapes(table, idx)
  if _wants_grad(table):
    return HashGatherFunction.apply(table, idx)
  if not _cuda.on_cuda("gather_rows", table, idx):
    return table[idx.long()]
  if table.dtype != torch.float32:
    raise ValueError(f"gather_rows: table dtype {table.dtype} not supported")
  c = table.shape[1]
  out = torch.empty(*idx.shape, c, dtype=table.dtype, device=table.device)
  n = idx.numel()
  if n == 0:
    return out
  lib = _cuda.load("hash_gather", _bind)
  err = lib.snerf_gather_rows(
      table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, c,
      table.device.index, torch.cuda.current_stream(table.device).cuda_stream)
  _cuda.check_launch(lib, err, f"gather_rows at T={table.shape[0]} C={c} "
                     f"N={n}")
  gather_rows.launches += 1
  return out


gather_rows.launches = 0


def _check_scatter(idx, g):
  if idx.dtype != torch.int32 or idx.dim() != 1:
    raise ValueError(f"idx must be int32 [Q], got {idx.dtype} "
                     f"{tuple(idx.shape)}")
  if g.dim() != 2 or g.shape[0] != idx.shape[0] or not (
      1 <= g.shape[1] <= MAX_CHANNELS):
    raise ValueError(f"g must be [Q, C<={MAX_CHANNELS}] with Q = "
                     f"{idx.shape[0]}, got {tuple(g.shape)}")


def scatter_add_rows_plain(idx, g, num_rows: int):
  """dT [num_rows, C] with dT[idx[q]] += g[q]; idx int32 [Q], g [Q, C]:
  `zeros.index_add_(0, idx, g)`."""
  _check_scatter(idx, g)
  return g.new_zeros(num_rows, g.shape[1]).index_add_(0, idx, g)


def scatter_variant(num_rows: int, c: int) -> str:
  """The scatter-add kernel's variant for a level gradient [num_rows, c]
  float32: "shared" (a zeroed copy per block takes the updates with
  shared-memory atomics and adds its nonzero rows once) at c = 1 up to
  SCATTER_SHARED_BYTES, else "warp" (the lanes that hold one row sum it
  before one global atomic)."""
  return ("shared" if c == 1 and num_rows * 4 <= SCATTER_SHARED_BYTES
          else "warp")


def scatter_add_rows(idx, g, num_rows: int):
  """dT [num_rows, C] float32 with dT[idx[q]] += g[q]; idx int32 [Q] with
  every value in [0, num_rows), g float32 [Q, C].

  CPU tensors run `scatter_add_rows_plain`. CUDA tensors launch the
  scatter-add kernel into a zeroed dT (contiguous, C <= 8) or raise, in
  the variant `scatter_variant(num_rows, C)` picks;
  `scatter_add_rows.launches` counts the launches. Both variants add with
  atomics, so the order of the additions, and with it the last bits of
  dT, changes from run to run.
  """
  _check_scatter(idx, g)
  if not _cuda.on_cuda("scatter_add_rows", idx, g):
    return scatter_add_rows_plain(idx, g, num_rows)
  if g.dtype != torch.float32:
    raise ValueError(f"scatter_add_rows: g dtype {g.dtype} not supported")
  c = g.shape[1]
  out = torch.zeros(num_rows, c, dtype=g.dtype, device=g.device)
  n = idx.numel()
  if n == 0:
    return out
  variant = scatter_variant(num_rows, c)
  lib = _cuda.load("hash_gather", _bind)
  err = lib.snerf_scatter_add_rows(
      idx.data_ptr(), g.data_ptr(), out.data_ptr(), n, c, num_rows,
      _SCATTER_VARIANT_CODES[variant], g.device.index,
      torch.cuda.current_stream(g.device).cuda_stream)
  _cuda.check_launch(lib, err, f"scatter_add_rows ({variant}) at "
                     f"T={num_rows} C={c} N={n}")
  scatter_add_rows.launches += 1
  return out


scatter_add_rows.launches = 0


class HashGatherFunction(torch.autograd.Function):
  """`table[idx]` differentiable in the table: forward `gather_rows` (K2),
  backward `scatter_add_rows` into a zeroed [T, C] gradient. Saves only
  idx. Counterpart of JAX `hash_ops.hash_gather` and of
  `hash_gather_dense`'s custom VJP."""

  @staticmethod
  def forward(ctx, table, idx):
    ctx.save_for_backward(idx)
    ctx.num_rows = table.shape[0]
    return gather_rows(table, idx)

  @staticmethod
  def backward(ctx, g):
    idx, = ctx.saved_tensors
    dtable = scatter_add_rows(idx.reshape(-1),
                              g.reshape(-1, g.shape[-1]).contiguous(),
                              ctx.num_rows)
    return dtable, None
