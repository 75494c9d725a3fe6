"""The fused multi-level hash encode, kernel K2 redesigned for Hopper
(counterpart of snerf_tpu/models/hashgrid.py `hash_encode` with the
Pallas kernel snerf_tpu/ops/pallas/hash_gather_dense.py and its custom
VJP).

`hash_encode_fwd` encodes flat positions x [N, 3] in [0, 1] into
[N, L, C] features of every level of a table [T, C] in one launch of the
hand-written kernel in `snerf_tpu_torch/csrc/hash_encode.cu` for CUDA
tensors: each thread hashes one point at one level, computes the 8
corners' rows and trilinear weights in registers, gathers and blends.
`hash_encode_bwd` recomputes the cells from x and adds w * g into one
zeroed gradient of the whole table (and, when the positions need it,
gives dx through the weights), in one launch. `HashEncodeFunction` ties
them together for autograd and saves only x (and the table, which the
model holds anyway), never an [N, 8] tensor.

For CPU tensors the wrappers run the plain versions, `hash_encode_fwd_plain`
(the per-level code: indices and weights by PyTorch ops, `table[idx]`, a
blend that adds the 8 corners in the kernel's order, so the two agree
bit for bit) and `hash_encode_bwd_plain` (the table gradient by
`index_add_`, dx written out). For a CUDA tensor the wrappers launch the
kernel or raise.

Determinism: the backward adds with atomics (in the design that
`hash_ops.scatter_variant` picks for each level from its rows and C: a
shared-memory copy for the coarse one-channel levels, warp aggregation
elsewhere), so the table gradient and dx change in their last bits from
run to run. The reference gridencoder's backward uses atomicAdd too. The
port keeps this on purpose and offers no deterministic mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from snerf_tpu_torch.ops import _cuda
from snerf_tpu_torch.ops.hash_ops import MAX_CHANNELS, scatter_variant

MAX_LEVELS = 16
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class _Spec(ctypes.Structure):
  """The level layout as the kernel receives it (`HashSpec` in
  csrc/hash_encode.cu, field for field)."""
  _fields_ = [("num_levels", ctypes.c_int),
              ("channels", ctypes.c_int),
              ("scale", ctypes.c_float * MAX_LEVELS),
              ("res1", ctypes.c_uint32 * MAX_LEVELS),
              ("size", ctypes.c_uint32 * MAX_LEVELS),
              ("dense", ctypes.c_int32 * MAX_LEVELS),
              ("shared", ctypes.c_int32 * MAX_LEVELS),
              ("offset", ctypes.c_longlong * (MAX_LEVELS + 1))]


def _dense(spec, lvl: int) -> bool:
  """Stride indexing when the (res+1)^3 grid fits the level's table."""
  return (spec.resolutions[lvl] + 1) ** 3 <= spec.sizes[lvl]


@functools.lru_cache(maxsize=None)
def pack_spec(spec) -> _Spec:
  """The kernel's copy of a GridSpec: per level the scale (float32), the
  dense stride base res + 1, the rows, whether the level is dense, and
  whether the backward takes its updates in a shared-memory copy
  (`scatter_variant(rows, C) == "shared"`); the levels' start rows with
  the total at the end."""
  n = spec.num_levels
  c = spec.level_dim
  if not 1 <= n <= MAX_LEVELS or not 1 <= c <= MAX_CHANNELS:
    raise ValueError(f"hash_encode: {n} levels of {c} channels; the kernel "
                     f"takes 1..{MAX_LEVELS} levels of 1..{MAX_CHANNELS}")
  s = _Spec()
  s.num_levels, s.channels = n, c
  for lvl in range(n):
    s.scale[lvl] = spec.scales[lvl]
    s.res1[lvl] = spec.resolutions[lvl] + 1
    s.size[lvl] = spec.sizes[lvl]
    s.dense[lvl] = int(_dense(spec, lvl))
    s.shared[lvl] = int(scatter_variant(spec.sizes[lvl], c) == "shared")
  for lvl in range(n + 1):
    s.offset[lvl] = spec.offsets[lvl]
  return s


# ---- the plain versions: per level, PyTorch ops

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


def level_indices(c0: torch.Tensor, resolution: int, size: int):
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


def _level_cell(xf: torch.Tensor, spec, lvl: int):
  """(level-local row indices [N, 8] int32, the per-axis factors [N, 2, 3]:
  1 - frac and frac) of every point's cell at one level."""
  pos = xf * spec.scales[lvl] + 0.5
  c0 = torch.floor(pos)
  frac = pos - c0
  idx = level_indices(c0.long(), spec.resolutions[lvl], spec.sizes[lvl])
  return idx.int(), torch.stack([1.0 - frac, frac], dim=1)


def level_rows_weights(xf: torch.Tensor, spec, lvl: int):
  """(level-local row indices [N, 8] int32, trilinear weights [N, 8]) for
  one level; the JAX module's table rows are these plus offsets[lvl]."""
  idx, a = _level_cell(xf, spec, lvl)
  return idx, _corner_product(a, torch.mul)


def _out_of_range(xf: torch.Tensor) -> torch.Tensor:
  return torch.any((xf < 0) | (xf > 1), dim=-1)


def _check(xf, table, spec, what):
  if xf.dim() != 2 or xf.shape[1] != 3:
    raise ValueError(f"{what}: x must be [N, 3], got {tuple(xf.shape)}")
  if tuple(table.shape) != (spec.total_rows, spec.level_dim):
    raise ValueError(f"{what}: table {tuple(table.shape)} does not match "
                     f"the spec's [{spec.total_rows}, {spec.level_dim}]")
  pack_spec(spec)    # the level and channel limits


def hash_encode_fwd_plain(xf: torch.Tensor, table: torch.Tensor, spec):
  """Features [N, L, C] of flat x [N, 3] from table [total_rows, C]: per
  level the rows by `table[idx]` and the blend w_0 r_0 + w_1 r_1 + ...
  added in corner order, as the kernel adds them; zeros for a point
  outside [0, 1]^3. Differentiable by autograd (`table[idx]`'s backward
  is PyTorch's accumulating scatter-add)."""
  _check(xf, table, spec, "hash_encode")
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


# d w_k / d frac_axis: the corner product with the axis's factors (1 -
# frac, frac) replaced by their derivatives (-1, +1)
_DFRAC = (-1.0, 1.0)


def hash_encode_bwd_plain(xf: torch.Tensor, table: torch.Tensor,
                          g: torch.Tensor, spec, need_dx: bool):
  """(dtable [total_rows, C], dx [N, 3] or None) of the encode for the
  output gradient g [N, L, C]: every level's w_k * g added into one zeroed
  table gradient by `index_add_`, and, when need_dx, dx = sum over levels
  of scale * sum_k (d w_k / d frac) <row_k, g>; points outside [0, 1]^3
  add nothing."""
  _check(xf, table, spec, "hash_encode_bwd")
  g = torch.where(_out_of_range(xf)[:, None, None], 0.0, g)
  c = spec.level_dim
  dtable = torch.zeros_like(table)
  dx = torch.zeros_like(xf) if need_dx else None
  levels = torch.split(table, list(spec.sizes))
  dfrac = torch.tensor(_DFRAC, dtype=xf.dtype, device=xf.device)
  for lvl in range(spec.num_levels):
    idx, a = _level_cell(xf, spec, lvl)
    w = _corner_product(a, torch.mul)
    gl = g[:, lvl]                                           # [N, C]
    dtable.index_add_(0, (idx.long() + spec.offsets[lvl]).reshape(-1),
                      (w[..., None] * gl[:, None, :]).reshape(-1, c))
    if need_dx:
      dots = (levels[lvl][idx.long()] * gl[:, None, :]).sum(-1)   # [N, 8]
      for axis in range(3):
        da = a.clone()
        da[:, :, axis] = dfrac
        dx[:, axis] += spec.scales[lvl] * (
            _corner_product(da, torch.mul) * dots).sum(-1)
  return dtable, dx


# ---- the kernels

def _bind(lib):
  lib.snerf_hash_encode_fwd.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.POINTER(_Spec)]
      + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
  lib.snerf_hash_encode_fwd.restype = ctypes.c_int
  lib.snerf_hash_encode_bwd.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.POINTER(_Spec)]
      + [ctypes.c_int, ctypes.c_void_p])
  lib.snerf_hash_encode_bwd.restype = ctypes.c_int


def _on_cuda(what, *tensors):
  """`_cuda.on_cuda`, and the kernels read float32 only."""
  if not _cuda.on_cuda(what, *tensors):
    return False
  if any(t.dtype != torch.float32 for t in tensors):
    raise ValueError(f"{what}: dtypes {[t.dtype for t in tensors]} not "
                     "supported (float32 only)")
  return True


def hash_encode_fwd(xf: torch.Tensor, table: torch.Tensor, spec):
  """The encode's features [N, L, C] of x [N, 3] float32 from table
  [total_rows, C] float32 (C <= 8, L <= 16). CPU tensors run
  `hash_encode_fwd_plain`; CUDA tensors launch the forward kernel
  (contiguous, on one device) or raise; `hash_encode_fwd.launches`
  counts the launches."""
  _check(xf, table, spec, "hash_encode_fwd")
  if not _on_cuda("hash_encode_fwd", xf, table):
    return hash_encode_fwd_plain(xf, table, spec)
  n, lv, c = xf.shape[0], spec.num_levels, spec.level_dim
  out = xf.new_empty(n, lv, c)
  if n == 0:
    return out
  lib = _cuda.load("hash_encode", _bind)
  # the point and level strides of out [N, L, C], in floats
  err = lib.snerf_hash_encode_fwd(
      xf.data_ptr(), table.data_ptr(), out.data_ptr(), n,
      ctypes.byref(pack_spec(spec)), lv * c, c, xf.device.index,
      torch.cuda.current_stream(xf.device).cuda_stream)
  _cuda.check_launch(lib, err, f"hash_encode_fwd at N={n} L={lv} C={c}")
  hash_encode_fwd.launches += 1
  return out


hash_encode_fwd.launches = 0


def hash_encode_bwd(xf: torch.Tensor, table: torch.Tensor, g: torch.Tensor,
                    spec, need_dx: bool):
  """(dtable [total_rows, C], dx [N, 3] or None) for the output gradient g
  [N, L, C]. CPU tensors run `hash_encode_bwd_plain`; CUDA tensors launch
  the backward kernel into zeroed gradients (float32, contiguous, on one
  device) or raise; `hash_encode_bwd.launches` counts the launches. The
  atomics add in a new order on every run."""
  _check(xf, table, spec, "hash_encode_bwd")
  want = (xf.shape[0], spec.num_levels, spec.level_dim)
  if tuple(g.shape) != want:
    raise ValueError(f"hash_encode_bwd: g {tuple(g.shape)}, expected {want}")
  if not _on_cuda("hash_encode_bwd", xf, table, g):
    return hash_encode_bwd_plain(xf, table, g, spec, need_dx)
  dtable = torch.zeros_like(table)
  dx = torch.zeros_like(xf) if need_dx else None
  n = xf.shape[0]
  if n == 0:
    return dtable, dx
  lib = _cuda.load("hash_encode", _bind)
  err = lib.snerf_hash_encode_bwd(
      xf.data_ptr(), table.data_ptr(), g.data_ptr(), dtable.data_ptr(),
      None if dx is None else dx.data_ptr(), n,
      ctypes.byref(pack_spec(spec)), xf.device.index,
      torch.cuda.current_stream(xf.device).cuda_stream)
  _cuda.check_launch(lib, err, f"hash_encode_bwd at N={n} "
                     f"L={spec.num_levels} C={spec.level_dim} dx={need_dx}")
  hash_encode_bwd.launches += 1
  return dtable, dx


hash_encode_bwd.launches = 0


class HashEncodeFunction(torch.autograd.Function):
  """The encode of flat x [N, 3] differentiable in the table and in x:
  forward `hash_encode_fwd`, backward `hash_encode_bwd` (dx only when x
  requires grad). Saves x and the table, nothing per level."""

  @staticmethod
  def forward(ctx, xf, table, spec):
    ctx.spec = spec
    ctx.save_for_backward(xf, table)
    return hash_encode_fwd(xf, table, spec)

  @staticmethod
  def backward(ctx, g):
    xf, table = ctx.saved_tensors
    dtable, dx = hash_encode_bwd(xf, table, g.contiguous(), ctx.spec,
                                 ctx.needs_input_grad[0])
    return dx, dtable if ctx.needs_input_grad[1] else None, None
