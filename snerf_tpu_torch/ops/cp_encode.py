"""The CP level encode: one level of models/cpgrid.py's integrated CP
grid, forward and table gradient (counterpart of snerf_tpu/models/cpgrid.py
`_level_encode`, which JAX runs in XLA: no Pallas kernel).

`encode_rows_plain` is the plain version: per component and axis the dense
[rows, R] float32 Gaussian profile, normalised, cast to the compute dtype,
then `w @ T` and the products in the dtype. It is the CPU path and the
reference the kernel is held to.

`encode_fwd` and `encode_bwd` launch the hand-written kernel in
`snerf_tpu_torch/csrc/cp_encode.cu` for CUDA tensors: the profile is made
in registers as the A operand of `mma.sync` (bf16, or 3xTF32 in float32)
and never reaches device memory; terms whose float32 exp is exactly 0
(an exponent below -108, `WINDOW`) are skipped. The table gradient is a
recompute launch that writes the chained output gradient per row tile,
then a launch that regenerates the profile as B, one warp per 32 nodes of
an axis and split of the rows, and float32 partials the wrapper sums over
the splits. The positions get no gradient from the kernel: `covers` sends
a call whose u or var needs one to the plain path.

The table reaches the kernel as T = [V | P] [3, R, F + F2] (bounded and
cast by the caller), rearranged by `table_fragments` into the order in
which the lanes of a warp hold the mma's B operand.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from snerf_tpu_torch.ops import _cuda
from snerf_tpu_torch.ops.fused_mlp import _tf32_rna

# the kernel skips node i of a row when (u - i)^2 > WINDOW var, where the
# plain version's float32 exp(-0.5 (u - i)^2 / var) is exactly 0
WINDOW = 216.0
# the widths the kernel is built for: F, and the pair width F2
WIDTHS = (8, 16, 32, 64)
PAIR_WIDTHS = (0, 8)
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 32        # nodes a warp owns in the table gradient
# warps the table gradient's launch aims at: 64 an SM, a few waves of those
# that fit beside each other
_TARGET_WARPS = 132 * 64


def rule(device_type: str, width: int, pair_width: int, dtype,
         position_dtype, needs_position_grad: bool) -> bool:
  """Whether a level encode takes the kernel: on a CUDA device, F and F2
  among the built widths, a float32 or bf16 compute dtype, float32 u and
  var (the kernel reads them as float), and no gradient wanted for
  them."""
  return (device_type == "cuda" and width in WIDTHS
          and pair_width in PAIR_WIDTHS and dtype in DTYPES
          and position_dtype == torch.float32 and not needs_position_grad)


def covers(u, var, v, p, dtype) -> bool:
  """`rule` for one level's rows u, var [M, n, 3] and tables v [3, R, F],
  p [3, R, F2] or None."""
  needs = torch.is_grad_enabled() and (u.requires_grad or var.requires_grad)
  pos = u.dtype if var.dtype == u.dtype else None
  return rule(u.device.type, v.shape[-1], 0 if p is None else p.shape[-1],
              dtype, pos, needs)


def encode_rows_plain(u, var, vb, pb, dtype: torch.dtype = torch.float32):
  """Features [M, F (+ 3 F2)] of rows u, var [M, n, 3] from the bounded
  tables vb (and pb) in the compute dtype, indexed by axis: the mean over
  the n components of prod_a (w_a @ vb[a]), with the pair products (w_a @
  pb[a]) * (w_b @ pb[b]) appended. The JAX module's `_level_encode`, op
  for op: the profile w in float32, cast to dtype for the matmuls, the
  products in dtype."""
  r = vb[0].shape[0]
  iota = torch.arange(r, dtype=torch.float32, device=u.device)
  acc = 0.0
  n = u.shape[-2]
  for k in range(n):
    f = 1.0
    pf = []
    for a in range(3):
      d = u[:, k, a, None] - iota                          # [M, R]
      w = torch.exp(-0.5 * d * d / var[:, k, a, None])
      w = (w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)).to(dtype)
      f = f * (w @ vb[a])                                  # [M, F]
      if pb is not None:
        pf.append(w @ pb[a])
    if pb is not None:
      f = torch.cat([f, pf[0] * pf[1], pf[1] * pf[2], pf[0] * pf[2]], dim=-1)
    acc = acc + f
  return acc / n


def _kcol(bf16: bool):
  """[4 t, 4 j]: the K offset within a step of 16 of lane t % 4's j-th
  value (m16n8k16: 2t, 2t+1, 2t+8, 2t+9; two m16n8k8: t, t+4, t+8, t+12)."""
  t = torch.arange(4)[:, None]
  j = torch.arange(4)[None, :]
  return 2 * t + (j & 1) + 8 * (j >> 1) if bf16 else t + 4 * j


def table_fragments(table: torch.Tensor) -> torch.Tensor:
  """T [3, R, FT] (bf16 or float32) in the order the kernel's lanes read
  the mma's B operand: [3, ceil(R / 16), FT / 8, 32 lanes, 4] with entry
  (a, s, c, lane, j) = T[a, 16 s + kcol(lane % 4, j), 8 c + lane // 4],
  zero past R; float32 as [..., 8]: the TF32 big halves, then the small
  ones (K1's `cvt.rna.tf32` rounding). A reshape and one permuted copy:
  the 16 nodes of a step are (j >> 1, t, j & 1) in bf16 (node 8 (j >> 1) +
  2t + (j & 1)) and (j, t) in float32 (node 4j + t); lane = 4 (column %
  8) + t."""
  r, ft = table.shape[1:]
  ks, nt = (r + 15) // 16, ft // 8
  padded = F.pad(table, (0, 0, 0, 16 * ks - r))
  if table.dtype == torch.bfloat16:
    frag = padded.reshape(3, ks, 2, 4, 2, nt, 8).permute(0, 1, 5, 6, 3, 2, 4)
    return frag.reshape(3, ks, nt, 32, 4).contiguous()
  frag = padded.reshape(3, ks, 4, 4, nt, 8).permute(0, 1, 4, 5, 3, 2)
  frag = frag.reshape(3, ks, nt, 32, 4)
  big = _tf32_rna(frag)
  return torch.cat([big, _tf32_rna(frag - big)], dim=-1).contiguous()


def _bind(lib):
  lib.snerf_cp_encode_fwd.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
      + [ctypes.c_void_p])
  lib.snerf_cp_encode_fwd.restype = ctypes.c_int
  lib.snerf_cp_encode_bwd.argtypes = (
      [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
      + [ctypes.c_void_p])
  lib.snerf_cp_encode_bwd.restype = ctypes.c_int


def _check(u, var, table, nf, dtype, what):
  if u.dim() != 3 or u.shape[-1] != 3 or var.shape != u.shape:
    raise ValueError(f"{what}: u, var must be [M, n, 3], got "
                     f"{tuple(u.shape)}, {tuple(var.shape)}")
  if u.dtype != torch.float32 or var.dtype != torch.float32:
    raise ValueError(f"{what}: u, var must be float32, got {u.dtype}, "
                     f"{var.dtype}")
  if table.dim() != 3 or table.shape[0] != 3 or table.dtype != dtype:
    raise ValueError(f"{what}: table must be [3, R, FT] in {dtype}, got "
                     f"{tuple(table.shape)} {table.dtype}")
  if not 0 < nf <= table.shape[-1]:
    raise ValueError(f"{what}: F {nf} of a table {table.shape[-1]} wide")


def _split(table, nf):
  """(vb, pb) of T = [V | P]: the plain version's tables."""
  return table[..., :nf], (table[..., nf:] if table.shape[-1] > nf else None)


def _widths(table, nf, dtype, what):
  np_ = table.shape[-1] - nf
  if not rule("cuda", nf, np_, dtype, torch.float32, False):
    raise ValueError(f"{what}: F {nf}, F2 {np_} in {dtype} is not built "
                     f"(F in {WIDTHS}, F2 in {PAIR_WIDTHS}, {DTYPES})")
  return nf // 8, np_ // 8


def encode_fwd(u, var, table, nf: int, dtype: torch.dtype):
  """Features [M, F + 3 F2] in dtype of rows u, var [M, n, 3] float32 from
  T = [V | P] [3, R, F + F2] in dtype (F = nf). CPU tensors run
  `encode_rows_plain`; CUDA tensors launch the forward kernel (contiguous,
  on one device) or raise; `encode_fwd.launches` counts the launches."""
  _check(u, var, table, nf, dtype, "cp_encode_fwd")
  if not _cuda.on_cuda("cp_encode_fwd", u, var, table):
    return encode_rows_plain(u, var, *_split(table, nf), dtype)
  nfc, npc = _widths(table, nf, dtype, "cp_encode_fwd")
  m, n = u.shape[:2]
  out = torch.empty(m, 8 * (nfc + 3 * npc), dtype=dtype, device=u.device)
  if m == 0:
    return out
  frags = table_fragments(table)
  lib = _cuda.load("cp_encode", _bind)
  err = lib.snerf_cp_encode_fwd(
      u.data_ptr(), var.data_ptr(), frags.data_ptr(), out.data_ptr(), m, n,
      table.shape[1], nfc, npc, int(dtype == torch.bfloat16), u.device.index,
      torch.cuda.current_stream(u.device).cuda_stream)
  _cuda.check_launch(lib, err, f"cp_encode_fwd at M={m} n={n} "
                     f"R={table.shape[1]} FT={table.shape[-1]} {dtype}")
  encode_fwd.launches += 1
  return out


encode_fwd.launches = 0


def splits(tiles: int, r: int) -> int:
  """Row splits of the table gradient's launch: ~_TARGET_WARPS warps of 32
  nodes of one axis each, at most one split a row tile."""
  units = 3 * ((r + CHUNK - 1) // CHUNK)
  return max(1, min(tiles, -(-_TARGET_WARPS // units)))


def encode_bwd(u, var, table, nf: int, g, dtype: torch.dtype):
  """The gradient [3, R, F + F2] float32 of T = [V | P] for the output
  gradient g [M, F + 3 F2] (in dtype). CPU tensors take autograd through
  `encode_rows_plain`; CUDA tensors launch the two backward kernels and
  sum their float32 partials over the row splits, or raise;
  `encode_bwd.launches` counts the calls."""
  _check(u, var, table, nf, dtype, "cp_encode_bwd")
  m, n = u.shape[:2]
  ft = table.shape[-1]
  if tuple(g.shape) != (m, 3 * ft - 2 * nf):
    raise ValueError(f"cp_encode_bwd: g {tuple(g.shape)}, expected "
                     f"{(m, 3 * ft - 2 * nf)}")
  g = g.to(dtype).contiguous()
  if not _cuda.on_cuda("cp_encode_bwd", u, var, table, g):
    t = table.detach().requires_grad_(True)
    with torch.enable_grad():
      f = encode_rows_plain(u, var, *_split(t, nf), dtype)
      (dt,) = torch.autograd.grad(f, t, g)
    return dt.float()
  nfc, npc = _widths(table, nf, dtype, "cp_encode_bwd")
  r = table.shape[1]
  if m == 0:
    return torch.zeros(3, r, ft, device=u.device)
  tiles = (m + 15) // 16
  fq = (nfc + npc + 1) // 2
  nsplit = splits(tiles, r)
  chunks = (r + CHUNK - 1) // CHUNK
  dev = u.device
  gp = torch.empty(tiles * n * 3 * fq * 256, dtype=dtype, device=dev)
  rows = torch.empty(tiles * 16 * n * 3 * 4, dtype=torch.float32, device=dev)
  win = torch.empty(tiles * n * 3 * 2, dtype=torch.int32, device=dev)
  partial = torch.empty(nsplit, 3, chunks * CHUNK, ft, dtype=torch.float32,
                        device=dev)
  frags = table_fragments(table)
  lib = _cuda.load("cp_encode", _bind)
  err = lib.snerf_cp_encode_bwd(
      u.data_ptr(), var.data_ptr(), frags.data_ptr(), g.data_ptr(),
      gp.data_ptr(), rows.data_ptr(), win.data_ptr(), partial.data_ptr(), m,
      n, r, nfc, npc, int(dtype == torch.bfloat16), nsplit, dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  _cuda.check_launch(lib, err, f"cp_encode_bwd at M={m} n={n} R={r} "
                     f"FT={ft} {dtype} splits={nsplit}")
  encode_bwd.launches += 1
  return partial.sum(dim=0)[:, :r]


encode_bwd.launches = 0
