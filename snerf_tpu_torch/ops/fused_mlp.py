"""Fused uniform-width ReLU MLP, forward and backward (counterpart of
snerf_tpu/ops/pallas/fused_mlp.py and its custom VJP).

`fused_mlp` launches the hand-written Hopper kernels in
`snerf_tpu_torch/csrc/fused_mlp.cu` for CUDA tensors and runs the plain
PyTorch versions (`fused_mlp_plain`, `fused_mlp_bwd_plain`,
`tf32_split_plain`) for CPU tensors. float32 runs 3xTF32 on wgmma: the
weights are split once a call into TF32 big and small parts
(`tf32_split`) and the forward reads them transposed. bfloat16 (the
trunks of the bf16 training path) runs one bf16 wgmma a product on the
weights as they lie, no split. Under autograd it goes through
`FusedMLPFunction`: the forward keeps every layer's output (and, in
float32, the split), and the backward runs, per layer, the dgrad kernel
(dz W^T with the ReLU mask of the layer below) and the wgrad kernel
(act^T dz and the bias sums on wgmma, N split across blocks) with its
fixed-order reduce; in bfloat16 dz is bf16 between layers and dW, db are
rounded to bf16 once after the reduce, as `fused_mlp_bwd_plain` says.
The kernels are built and loaded by `ops/_cuda.py`.
"""

from __future__ import annotations

import ctypes

import torch

from snerf_tpu_torch.ops import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ROWS = 2 ** 31 - 64  # the kernels index rows with int
_BK = 32                  # f32 wgrad's k-depth: a split is a multiple of it
_BK_BF16 = 64             # the bf16 wgrad's
_BF16_TILE_COLS = 256     # the bf16 kernels' output tile: D a multiple
# The tensor cores' f32 accumulator truncates, so a run's error grows with
# its rows: on an H100 a 15,776-row run put dW 1.2e-4 of max|dW| off f64,
# a 2,048-row run 1.7e-5 (the 1xTF32 kernel: 3.5e-4). The wgrad kernel
# adds its accumulator into the block's f32 partial every 2,048 rows
# (kPromoteStages in csrc/fused_mlp.cu), so a split may be longer.
_MIN_SPLIT_ROWS = 2048
_WAVES = 16               # wgrad blocks to aim for, in waves of 1 per SM
# The bf16 wgrad's: the shorter its splits, the faster, down to the
# 2,048-row floor; at 2,097,152 x 512 on an H100 it took 4.61, 3.82, 3.41
# and 2.80 ms at 4, 16, 32 and 64 waves (python -m
# snerf_tpu_torch.probes.k1_bf16). Its f32 partials then take 1 GiB there.
_WAVES_BF16 = 64


def _bind(lib):
  lib.snerf_fused_mlp_fwd_f32.argtypes = (
      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_fwd_f32.restype = ctypes.c_int
  lib.snerf_fused_mlp_fwd_bf16.argtypes = (
      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_fwd_bf16.restype = ctypes.c_int
  lib.snerf_tf32_split.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
  lib.snerf_tf32_split.restype = ctypes.c_int
  lib.snerf_fused_mlp_bwd_dgrad.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_bwd_dgrad.restype = ctypes.c_int
  lib.snerf_fused_mlp_bwd_wgrad.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_bwd_wgrad.restype = ctypes.c_int
  lib.snerf_fused_mlp_bwd_dgrad_bf16.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_bwd_dgrad_bf16.restype = ctypes.c_int
  lib.snerf_fused_mlp_bwd_wgrad_bf16.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_bwd_wgrad_bf16.restype = ctypes.c_int
  lib.snerf_fused_mlp_bwd_reduce.argtypes = (
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_bwd_reduce.restype = ctypes.c_int


def _lib():
  return _cuda.load("fused_mlp", _bind)


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _check_shapes(x, w_stack, b_stack):
  if x.dim() != 2:
    raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
  n, d = x.shape
  if w_stack.dim() != 3 or tuple(w_stack.shape[1:]) != (d, d):
    raise ValueError(f"w_stack must be [L, {d}, {d}], got "
                     f"{tuple(w_stack.shape)}")
  n_layers = w_stack.shape[0]
  if tuple(b_stack.shape) != (n_layers, 1, d):
    raise ValueError(f"b_stack must be [{n_layers}, 1, {d}], got "
                     f"{tuple(b_stack.shape)}")
  return n, d, n_layers


def _check_cuda(what, x, *others):
  """The kernels' preconditions on CUDA tensors; raise on any miss."""
  for t in others:
    if t.device != x.device:
      raise ValueError(f"{what}: tensors on {t.device} and {x.device}")
    if t.dtype != x.dtype:
      raise ValueError(f"{what}: dtypes {t.dtype} and {x.dtype}")
  if x.dtype not in _DTYPES:
    raise ValueError(f"{what}: dtype {x.dtype} not supported")
  if not all(t.is_contiguous() for t in (x, *others)):
    raise ValueError(f"{what}: inputs must be contiguous")
  d = x.shape[-1]
  if d % 128 != 0:
    raise ValueError(f"{what}: D={d} must be a multiple of 128")
  if x.dtype == torch.bfloat16 and d % _BF16_TILE_COLS != 0:
    raise ValueError(f"{what}: D={d} must be a multiple of "
                     f"{_BF16_TILE_COLS} in bfloat16")
  if any(t.data_ptr() % 16 for t in (x, *others)):
    raise ValueError(f"{what}: inputs must be 16-byte aligned")
  if x.numel() // d > _MAX_ROWS:
    raise ValueError(f"{what}: N={x.numel() // d} rows exceeds {_MAX_ROWS}")


def _acc_dtype(dtype):
  """float32 accumulation, float64 for float64 inputs (gradcheck)."""
  return torch.promote_types(dtype, torch.float32)


def _plain_layers(x, w_stack, b_stack, last_relu):
  """Every layer's output, as the kernel computes it: accumulation in
  float32 (float64 for float64 inputs), cast to x.dtype after each."""
  acc = _acc_dtype(x.dtype)
  n_layers = w_stack.shape[0]
  outs, h = [], x
  for i in range(n_layers):
    z = torch.matmul(h.to(acc), w_stack[i].to(acc)) + b_stack[i].to(acc)
    if i < n_layers - 1 or last_relu:
      z = torch.relu(z)
    h = z.to(x.dtype)
    outs.append(h)
  return outs


def fused_mlp_plain(x, w_stack, b_stack, last_relu: bool = True):
  """The kernel's computation as a plain PyTorch loop: f32 accumulation,
  cast to x.dtype after every layer."""
  _check_shapes(x, w_stack, b_stack)
  return _plain_layers(x, w_stack, b_stack, last_relu)[-1]


def fused_mlp_bwd_plain(x, w_stack, b_stack, saved, g,
                        last_relu: bool = True):
  """The backward as a plain PyTorch loop, accumulating in float32
  (float64 for float64 inputs).

  float32 (and float64): `_fused_bwd` of snerf_tpu/ops/pallas/
  fused_mlp.py line for line. bfloat16: what JAX differentiates in its
  bf16 models, where the trunk is flax's `nn.Dense(dtype=bfloat16)` chain
  on float32 parameters (snerf_tpu/models/mlp.py `NerfMLP`, zipnerf.py
  `ZipMLP._trunk`) under `jax.grad`, not the Pallas VJP, which widens dh
  to float32 between layers (`_fused_bwd`):
    * dz is rounded to bf16 after each layer's dgrad (the transpose of
      the bf16 `dot_general`: bf16 operands, f32 accumulation, a bf16
      result);
    * the ReLU mask is read from the bf16 layer outputs (relu's JVP on
      the bf16 pre-activation: z > 0 where relu(z) > 0);
    * dW = bf16(act^T dz) and db = bf16(sum of dz) (the transposes of the
      bf16 dot and bias add), which reach the float32 master weights
      through the cast's backward (`convert_element_type`'s transpose,
      here `Tensor.to`'s).

  saved: the L layer outputs of the forward (a sequence), or None to
  recompute them as the JAX backward does. g: the output's gradient.
  Returns (dx, dw_stack, db_stack) in the dtypes of x, w_stack, b_stack.
  """
  n_layers = w_stack.shape[0]
  acc = _acc_dtype(x.dtype)
  if saved is None:
    saved = _plain_layers(x, w_stack, b_stack, last_relu)
  acts = [x, *saved]
  dh = g.to(acc)
  dws, dbs = [], []
  for i in range(n_layers - 1, -1, -1):
    relu = i < n_layers - 1 or last_relu
    if relu:
      dh = dh * (acts[i + 1] > 0)
    a = acts[i].to(acc)
    dws.append((a.t() @ dh).to(w_stack.dtype))
    dbs.append(dh.sum(dim=0, keepdim=True).to(b_stack.dtype))
    # rounded to x's dtype between layers: a no-op in f32 and f64
    dh = (dh @ w_stack[i].t().to(acc)).to(x.dtype).to(acc)
  return dh.to(x.dtype), torch.stack(dws[::-1]), torch.stack(dbs[::-1])


def _tf32_rna(v):
  """`cvt.rna.tf32.f32` on float32 bit patterns, as an H100 gives it: the
  magnitude rounded to TF32's 10 mantissa bits, ties away from zero, then
  its low 13 bits cleared; the sign is kept, so signed zeros pass.
  Subnormals round the same way (a carry may make them normal, as one
  into the exponent makes the largest values inf); inf passes; a NaN is
  truncated (low 13 bits cleared, so a NaN whose payload lies only there
  becomes inf)."""
  u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  sign, mag = u & 0x80000000, u & 0x7FFFFFFF
  bits = torch.where(mag <= 0x7F800000,
                     sign | ((mag + 0x1000) & 0x7FFFE000), u & 0xFFFFE000)
  bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
  return bits.to(torch.int32).view(torch.float32)


_CANONICAL_NAN = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(
    torch.float32)


def tf32_split_plain(w):
  """(big, small) of float32 w: big = tf32(w), small = tf32(w - big), each
  by `_tf32_rna`, so big + small is w to ~2^-22 relative. A NaN of the
  subtraction (w inf or NaN) is the card's canonical NaN 0x7fffffff."""
  if w.dtype != torch.float32:
    raise ValueError(f"tf32_split: float32 only, got {w.dtype}")
  big = _tf32_rna(w)
  diff = w - big
  diff = torch.where(torch.isnan(diff), _CANONICAL_NAN.to(w.device), diff)
  return big, _tf32_rna(diff)


def tf32_split(w_stack, keep: bool = True):
  """The 3xTF32 split of w_stack [L, D, D] float32 for the kernels:
  (big, small, big_t, small_t). (big_t, small_t) are transposed per
  layer, [L, out, in] (the forward's B operand); (big, small) keep
  w_stack's layout (dgrad's B operand) when `keep`, else are None. CUDA
  tensors launch `tf32_split_kernel` (one launch, counted in
  `tf32_split.launches`); CPU tensors run `tf32_split_plain`."""
  if w_stack.dim() != 3 or w_stack.shape[1] != w_stack.shape[2]:
    raise ValueError(f"tf32_split: w_stack must be [L, D, D], got "
                     f"{tuple(w_stack.shape)}")
  if w_stack.device.type == "cpu":
    big, small = tf32_split_plain(w_stack)
    return (*((big, small) if keep else (None, None)),
            big.transpose(1, 2).contiguous(),
            small.transpose(1, 2).contiguous())
  _check_cuda("tf32_split", w_stack)
  if w_stack.dtype != torch.float32:
    raise ValueError(f"tf32_split: float32 only, got {w_stack.dtype}")
  outs = [torch.empty_like(w_stack) if want else None
          for want in (keep, keep, True, True)]
  n_layers, d = w_stack.shape[:2]
  lib = _lib()
  err = lib.snerf_tf32_split(
      w_stack.data_ptr(), *(None if t is None else t.data_ptr() for t in outs),
      n_layers, d, w_stack.device.index, _stream(w_stack))
  _cuda.check_launch(lib, err, f"tf32_split at L={n_layers} D={d}")
  tf32_split.launches += 1
  return tuple(outs)


def _launch_fwd(x, w_stack, b_stack, last_relu, keep: bool, split_t=None):
  """One forward launch. keep=True also returns the layers before the
  last as a [L-1, N, D] tensor (None for L = 1). float32 runs on the
  transposed split (big_t, small_t) of `tf32_split`, made here when
  `split_t` is None; bfloat16 on `fused_mlp_fwd_bf16`."""
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  f32 = x.dtype == torch.float32
  out = torch.empty_like(x)
  saved = tmp = None
  if n_layers > 1:
    if keep:
      saved = x.new_empty(n_layers - 1, n, d)
    else:
      tmp = torch.empty_like(x)  # layers before the last alternate here
  if n == 0:
    return out, saved
  if not f32:
    fused_mlp_fwd_bf16(x, w_stack, b_stack, out, tmp, saved, last_relu)
    return out, saved
  if split_t is None:
    split_t = tf32_split(w_stack, keep=False)[2:]
  lib = _lib()
  err = lib.snerf_fused_mlp_fwd_f32(
      x.data_ptr(), split_t[0].data_ptr(), split_t[1].data_ptr(),
      b_stack.data_ptr(), out.data_ptr(), _ptr(tmp), _ptr(saved), n, d,
      n_layers, int(bool(last_relu)), x.device.index, _stream(x))
  _cuda.check_launch(lib, err, f"fused_mlp at N={n} D={d} L={n_layers}")
  fused_mlp.launches += 1
  return out, saved


def _ptr(t):
  return None if t is None else t.data_ptr()


def fused_mlp_fwd_bf16(x, w_stack, b_stack, out, tmp, saved, last_relu):
  """The bf16 forward kernel: out [N, D] and, for L > 1, either the
  scratch tmp [N, D] or saved [L-1, N, D] (every layer but the last) of
  x [N, D], w_stack [L, D, D] ([in, out]), b_stack [L, 1, D], all
  bfloat16 on the card. One launch, counted in
  `fused_mlp_fwd_bf16.launches`."""
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  _check_cuda("fused_mlp_fwd_bf16", x, w_stack, b_stack, out,
              *(t for t in (tmp, saved) if t is not None))
  if x.dtype != torch.bfloat16:
    raise ValueError(f"fused_mlp_fwd_bf16: bfloat16 only, got {x.dtype}")
  lib = _lib()
  err = lib.snerf_fused_mlp_fwd_bf16(
      x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
      _ptr(tmp), _ptr(saved), n, d, n_layers, int(bool(last_relu)),
      x.device.index, _stream(x))
  _cuda.check_launch(lib, err,
                     f"fused_mlp_fwd_bf16 at N={n} D={d} L={n_layers}")
  fused_mlp_fwd_bf16.launches += 1


def fused_mlp_bwd_dgrad(dz, w_big, w_small, mask, out):
  """out = (dz @ w.T) * (mask > 0) on the card (no mask when mask is
  None): dz, mask, out [N, D] float32; w [D, D] ([in, out]) given as its
  split (w_big, w_small) from `tf32_split` (not transposed)."""
  _check_cuda("fused_mlp_bwd_dgrad", dz, w_big, w_small, out,
              *(() if mask is None else (mask,)))
  n, d = dz.shape
  lib = _lib()
  err = lib.snerf_fused_mlp_bwd_dgrad(
      dz.data_ptr(), w_big.data_ptr(), w_small.data_ptr(),
      None if mask is None else mask.data_ptr(), out.data_ptr(), n, d,
      dz.device.index, _stream(dz))
  _cuda.check_launch(lib, err, f"fused_mlp_bwd_dgrad at N={n} D={d}")
  fused_mlp_bwd_dgrad.launches += 1
  return out


def wgrad_splits(n: int, d: int, sm_count: int, dtype=torch.float32,
                 waves: int = 0):
  """(rows_per_split, splits) of the wgrad kernel of `dtype`'s split of N:
  enough blocks for `waves` (0: _WAVES, bf16 _WAVES_BF16) waves of one
  block per SM over its output tiles, 128 x 128 (bf16: 128 x 256; 16 x
  132 = 2,112 blocks is 33 splits of the 64 f32 tiles at D = 1024, no
  partial wave), each split at least _MIN_SPLIT_ROWS rows unless N is
  shorter, a multiple of the kernel's k-depth (_BK, bf16 _BK_BF16), and
  at most 65,535 splits."""
  bf16 = dtype == torch.bfloat16
  bk, default_waves = (_BK_BF16, _WAVES_BF16) if bf16 else (_BK, _WAVES)
  waves = waves or default_waves
  tiles = (d // 128) * (d // (_BF16_TILE_COLS if bf16 else 128))
  splits = -(-waves * sm_count // tiles)
  splits = max(1, min(splits, -(-n // _MIN_SPLIT_ROWS), 65535))
  rows = -(-n // splits)
  rows = -(-rows // bk) * bk
  return rows, -(-n // rows)


def fused_mlp_bwd_wgrad(act, dz, part_w, part_b, rows_per_split):
  """The partials of act.T @ dz and dz.sum(0) over splits of N rows:
  act, dz [N, D] float32; part_w [S, D, D]; part_b [S, D]. One launch of
  the TMA-fed wgmma kernel, a block per 128 x 128 tile and split."""
  _check_cuda("fused_mlp_bwd_wgrad", act, dz, part_w, part_b)
  n, d = act.shape
  lib = _lib()
  err = lib.snerf_fused_mlp_bwd_wgrad(
      act.data_ptr(), dz.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
      n, d, rows_per_split, part_w.shape[0], act.device.index, _stream(act))
  _cuda.check_launch(lib, err, f"fused_mlp_bwd_wgrad at N={n} D={d}")
  fused_mlp_bwd_wgrad.launches += 1


def fused_mlp_bwd_dgrad_bf16(dz, w, mask, out):
  """out = bf16((dz @ w.T) * (mask > 0)) on the card (no mask when mask is
  None): dz, mask, out [N, D] and w [D, D] ([in, out], as it lies)
  bfloat16; f32 accumulation."""
  _check_cuda("fused_mlp_bwd_dgrad_bf16", dz, w, out,
              *(() if mask is None else (mask,)))
  n, d = dz.shape
  lib = _lib()
  err = lib.snerf_fused_mlp_bwd_dgrad_bf16(
      dz.data_ptr(), w.data_ptr(), _ptr(mask), out.data_ptr(), n, d,
      dz.device.index, _stream(dz))
  _cuda.check_launch(lib, err, f"fused_mlp_bwd_dgrad_bf16 at N={n} D={d}")
  fused_mlp_bwd_dgrad_bf16.launches += 1
  return out


def fused_mlp_bwd_wgrad_bf16(act, dz, part_w, part_b, rows_per_split):
  """The float32 partials of act.T @ dz and dz.sum(0) over splits of N
  rows (a multiple of _BK_BF16): act, dz [N, D] bfloat16; part_w [S, D,
  D], part_b [S, D] float32. One launch of the TMA-fed wgmma kernel, a
  block per 128 x 256 tile and split."""
  _check_cuda("fused_mlp_bwd_wgrad_bf16", act, dz)
  _check_cuda("fused_mlp_bwd_wgrad_bf16 partials", part_w, part_b)
  n, d = act.shape
  lib = _lib()
  err = lib.snerf_fused_mlp_bwd_wgrad_bf16(
      act.data_ptr(), dz.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
      n, d, rows_per_split, part_w.shape[0], act.device.index, _stream(act))
  _cuda.check_launch(lib, err, f"fused_mlp_bwd_wgrad_bf16 at N={n} D={d}")
  fused_mlp_bwd_wgrad_bf16.launches += 1


def fused_mlp_bwd_reduce(part_w, part_b, dw, db):
  """dw [D, D] = part_w.sum(0) and db [D] = part_b.sum(0), summed in
  split order."""
  _check_cuda("fused_mlp_bwd_reduce", part_w, part_b, dw, db)
  splits, d = part_b.shape
  lib = _lib()
  err = lib.snerf_fused_mlp_bwd_reduce(
      part_w.data_ptr(), part_b.data_ptr(), dw.data_ptr(), db.data_ptr(), d,
      splits, part_w.device.index, _stream(part_w))
  _cuda.check_launch(lib, err, f"fused_mlp_bwd_reduce at D={d}")
  fused_mlp_bwd_reduce.launches += 1


def fused_mlp_bwd(x, w_stack, b_stack, saved, g, split,
                  last_relu: bool = True, need_dx: bool = True):
  """The backward on the card: the kernels' counterpart of
  `fused_mlp_bwd_plain`, float32 or bfloat16. saved: the L layer outputs
  of the forward; split: in float32 w_stack's (big, small) from
  `tf32_split`, in bfloat16 None (the kernels read w_stack). dW and db
  are summed in float32 and, in bfloat16, rounded once at the end.
  Returns (dx or None, dw_stack, db_stack) in the dtypes of x, w_stack,
  b_stack."""
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  _check_cuda("fused_mlp_bwd", x, w_stack, b_stack, g, *saved)
  bf16 = x.dtype == torch.bfloat16
  if bf16 != (split is None):
    raise ValueError("fused_mlp_bwd: float32 takes the weights' split, "
                     "bfloat16 none")
  dw = torch.empty(w_stack.shape, dtype=torch.float32, device=x.device)
  db = torch.empty(b_stack.shape, dtype=torch.float32, device=x.device)
  dx = torch.empty_like(x) if need_dx else None
  if n == 0:
    dw.zero_()
    db.zero_()
    return (dx, dw.to(w_stack.dtype), db.to(b_stack.dtype))
  sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
  rows, splits = wgrad_splits(n, d, sm_count, x.dtype)
  part_w = dw.new_empty(splits, d, d)
  part_b = dw.new_empty(splits, d)
  bufs = [torch.empty_like(x), torch.empty_like(x)]
  wgrad = fused_mlp_bwd_wgrad_bf16 if bf16 else fused_mlp_bwd_wgrad
  if bf16:
    dgrad = lambda dz, i, mask, out: fused_mlp_bwd_dgrad_bf16(
        dz, w_stack[i], mask, out)
  else:
    dgrad = lambda dz, i, mask, out: fused_mlp_bwd_dgrad(
        dz, split[0][i], split[1][i], mask, out)
  dz = torch.mul(g, saved[-1] > 0, out=bufs[0]) if last_relu else g
  for i in range(n_layers - 1, -1, -1):
    act = x if i == 0 else saved[i - 1]
    wgrad(act, dz, part_w, part_b, rows)
    fused_mlp_bwd_reduce(part_w, part_b, dw[i], db[i, 0])
    if i > 0:
      nxt = bufs[1] if dz is bufs[0] else bufs[0]
      dz = dgrad(dz, i, act, nxt)
    elif need_dx:
      dgrad(dz, 0, None, dx)
  return dx, dw.to(w_stack.dtype), db.to(b_stack.dtype)


class FusedMLPFunction(torch.autograd.Function):
  """`fused_mlp` under autograd. CUDA: the kernel forward keeps every
  layer's output and the backward runs the dgrad and wgrad kernels; in
  float32 the weights are split once (`tf32_split`, both layouts) and
  dgrad reads the kept split, in bfloat16 every kernel reads the weights
  as they lie. CPU: `fused_mlp_plain`'s layers forward and
  `fused_mlp_bwd_plain` backward."""

  @staticmethod
  def forward(ctx, x, w_stack, b_stack, last_relu):
    split = (None, None)
    if x.device.type == "cuda":
      split_t = None
      if x.dtype == torch.float32:
        *split, big_t, small_t = tf32_split(w_stack)
        split_t = (big_t, small_t)
      out, kept = _launch_fwd(x, w_stack, b_stack, last_relu, keep=True,
                              split_t=split_t)
      layers = [] if kept is None else list(kept.unbind(0))
    else:
      *layers, out = _plain_layers(x, w_stack, b_stack, last_relu)
    ctx.last_relu = bool(last_relu)
    ctx.save_for_backward(x, w_stack, b_stack, *split, out, *layers)
    return out

  @staticmethod
  def backward(ctx, g):
    x, w_stack, b_stack, w_big, w_small, out, *layers = ctx.saved_tensors
    saved = [*layers, out]
    g = g.contiguous()
    if x.device.type == "cuda":
      dx, dw, db = fused_mlp_bwd(x, w_stack, b_stack, saved, g,
                                 None if w_big is None else (w_big, w_small),
                                 ctx.last_relu,
                                 need_dx=ctx.needs_input_grad[0])
    else:
      dx, dw, db = fused_mlp_bwd_plain(x, w_stack, b_stack, saved, g,
                                       ctx.last_relu)
    return dx, dw, db, None


def fused_mlp(x, w_stack, b_stack, last_relu: bool = True):
  """Uniform-width ReLU MLP: x [N, D] -> [N, D].

  w_stack [L, D, D] (layout [in, out]), b_stack [L, 1, D]; last_relu
  controls the final activation. CPU tensors run the plain versions.
  CUDA tensors launch the kernels (float32 or bfloat16, one dtype for
  all three; contiguous, D a multiple of 128, of 256 in bfloat16,
  16-byte aligned) or raise.
  With grad enabled and any input requiring grad the call is
  differentiable (`FusedMLPFunction`). `fused_mlp.launches` counts the
  float32 forward's launches, `fused_mlp_fwd_bf16.launches` the bfloat16
  one's; `tf32_split` and the backward's wrappers count their own.
  """
  _check_shapes(x, w_stack, b_stack)
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"fused_mlp: unsupported device {x.device}")
  if x.device.type == "cuda":
    _check_cuda("fused_mlp", x, w_stack, b_stack)
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, w_stack, b_stack)):
    return FusedMLPFunction.apply(x, w_stack, b_stack, last_relu)
  if x.device.type == "cpu":
    return fused_mlp_plain(x, w_stack, b_stack, last_relu)
  return _launch_fwd(x, w_stack, b_stack, last_relu, keep=False)[0]


for _fn in (fused_mlp, tf32_split, fused_mlp_bwd_dgrad, fused_mlp_bwd_wgrad,
            fused_mlp_bwd_reduce, fused_mlp_fwd_bf16, fused_mlp_bwd_dgrad_bf16,
            fused_mlp_bwd_wgrad_bf16):
  _fn.launches = 0
