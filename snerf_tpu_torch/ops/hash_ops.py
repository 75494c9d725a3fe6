"""Hash-grid table row gather, kernel K2 (counterpart of
snerf_tpu/ops/hash_ops.py `gather_rows` and the Pallas kernel
snerf_tpu/ops/pallas/hash_gather_dense.py), forward only.

`gather_rows` launches the hand-written Hopper kernel in
`snerf_tpu_torch/csrc/hash_gather.cu` for CUDA tensors and runs
`gather_rows_plain` for CPU tensors. On the GPU one kernel serves every
level, dense or hashed: the TPU kernel's table-size limit does not exist
there. The kernel is built and loaded by `ops/_cuda.py`. The table's
scatter-add backward belongs to the training path and is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from snerf_tpu_torch.ops import _cuda

MAX_CHANNELS = 8


def _bind(lib):
  lib.snerf_gather_rows.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
      + [ctypes.c_void_p])
  lib.snerf_gather_rows.restype = ctypes.c_int


def _check_shapes(table, idx):
  if table.dim() != 2 or not 1 <= table.shape[1] <= MAX_CHANNELS:
    raise ValueError(f"table must be [T, C] with 1 <= C <= {MAX_CHANNELS}, "
                     f"got {tuple(table.shape)}")
  if idx.dtype != torch.int32:
    raise ValueError(f"idx must be int32, got {idx.dtype}")


def gather_rows_plain(table, idx):
  """table [T, C], idx int32 [...] -> [..., C]: `table[idx]`."""
  _check_shapes(table, idx)
  return table[idx.long()]


def gather_rows(table, idx):
  """Row gather: table [T, C] float32, idx int32 [...] -> [..., C].

  Precondition: every index lies in [0, T); the hash encoder builds them
  so (level offset + stride or hash modulo the level size), and neither
  version checks it. CPU tensors run `gather_rows_plain`. CUDA tensors
  launch the kernel (table and idx contiguous on one device, C <= 8, no
  autograd through the table) or raise; `gather_rows.launches` counts the
  launches.
  """
  _check_shapes(table, idx)
  if table.device.type == "cpu" and idx.device.type == "cpu":
    return gather_rows_plain(table, idx)
  if table.device.type != "cuda" or idx.device != table.device:
    raise ValueError(f"gather_rows: table on {table.device}, idx on "
                     f"{idx.device}; both must be on one CUDA device")
  if table.dtype != torch.float32:
    raise ValueError(f"gather_rows: table dtype {table.dtype} not supported")
  if not (table.is_contiguous() and idx.is_contiguous()):
    raise ValueError("gather_rows: table and idx must be contiguous")
  if torch.is_grad_enabled() and table.requires_grad:
    raise RuntimeError("gather_rows: the CUDA kernel is forward-only; run it "
                       "under torch.no_grad() or torch.inference_mode()")
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
