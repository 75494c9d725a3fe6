"""Fused uniform-width ReLU MLP, forward and backward (counterpart of
snerf_tpu/ops/pallas/fused_mlp.py and its custom VJP).

`fused_mlp` launches the hand-written Hopper kernels in
`snerf_tpu_torch/csrc/fused_mlp.cu` for CUDA tensors and runs the plain
PyTorch versions (`fused_mlp_plain`, `fused_mlp_bwd_plain`,
`tf32_split_plain`) for CPU tensors. float32 runs 3xTF32 on wgmma: the
weights are split once a call into TF32 big and small parts
(`tf32_split`) and the forward reads them transposed. Under autograd it
goes through `FusedMLPFunction`: the forward keeps every layer's output
and the split, and the backward runs, per layer, the dgrad kernel (dz
W^T with the ReLU mask of the layer below, on the kept split) and the
wgrad kernel (act^T dz and the bias sums on wgmma, dz transposed in
shared memory, N split across blocks) with its fixed-order reduce. The
kernels are built and loaded by `ops/_cuda.py`.
"""

from __future__ import annotations

import ctypes

import torch

from snerf_tpu_torch.ops import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ROWS = 2 ** 31 - 64  # the kernels index rows with int
_BK = 32                  # wgrad's k-depth: a split is a multiple of it
# The tensor cores' f32 accumulator truncates, so a run's error grows with
# its rows: on an H100 a 15,776-row run put dW 1.2e-4 of max|dW| off f64,
# a 2,048-row run 1.7e-5 (the 1xTF32 kernel: 3.5e-4). The wgrad kernel
# adds its accumulator into the block's f32 partial every 2,048 rows
# (kPromoteStages in csrc/fused_mlp.cu), so a split may be longer.
_MIN_SPLIT_ROWS = 2048
_WAVES = 16               # wgrad blocks to aim for, in waves of 1 per SM


def _bind(lib):
  lib.snerf_fused_mlp_fwd_f32.argtypes = (
      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_fwd_f32.restype = ctypes.c_int
  lib.snerf_fused_mlp_fwd_bf16.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
  """The backward as a plain PyTorch loop, `_fused_bwd` line for line.

  saved: the L layer outputs of the forward (a sequence), or None to
  recompute them as the JAX backward does. g: the output's gradient.
  Returns (dx, dw_stack, db_stack).
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
    dh = dh @ w_stack[i].t().to(acc)
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
  last as a [L-1, N, D] tensor (None for L = 1), float32 only. float32
  runs on the transposed split (big_t, small_t) of `tf32_split`, made
  here when `split_t` is None."""
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  f32 = x.dtype == torch.float32
  if keep and not f32:
    raise NotImplementedError("fused_mlp keeping its layers: float32 only")
  out = torch.empty_like(x)
  saved = tmp = None
  if n_layers > 1:
    if keep:
      saved = x.new_empty(n_layers - 1, n, d)
    else:
      tmp = torch.empty_like(x)  # layers before the last alternate here
  if n == 0:
    return out, saved
  lib = _lib()
  ptr = lambda t: None if t is None else t.data_ptr()
  if f32:
    if split_t is None:
      split_t = tf32_split(w_stack, keep=False)[2:]
    err = lib.snerf_fused_mlp_fwd_f32(
        x.data_ptr(), split_t[0].data_ptr(), split_t[1].data_ptr(),
        b_stack.data_ptr(), out.data_ptr(), ptr(tmp), ptr(saved), n, d,
        n_layers, int(bool(last_relu)), x.device.index, _stream(x))
  else:
    err = lib.snerf_fused_mlp_fwd_bf16(
        x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
        ptr(tmp), n, d, n_layers, int(bool(last_relu)), x.device.index,
        _stream(x))
  _cuda.check_launch(lib, err,
                     f"fused_mlp at N={n} D={d} L={n_layers} {x.dtype}")
  fused_mlp.launches += 1
  return out, saved


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


def wgrad_splits(n: int, d: int, sm_count: int):
  """(rows_per_split, splits) of wgrad's split of N: enough blocks for
  _WAVES waves of one block per SM over the (D/128)^2 output tiles (16 x
  132 = 2,112 blocks is 33 splits of the 64 tiles at D = 1024, no partial
  wave), each split at least _MIN_SPLIT_ROWS rows unless N is shorter, a
  multiple of _BK, and at most 65,535 splits."""
  tiles = (d // 128) ** 2
  splits = -(-_WAVES * sm_count // tiles)
  splits = max(1, min(splits, -(-n // _MIN_SPLIT_ROWS), 65535))
  rows = -(-n // splits)
  rows = -(-rows // _BK) * _BK
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
  `fused_mlp_bwd_plain` (float32). saved: the L layer outputs of the
  forward; split: w_stack's (big, small) from `tf32_split`. Returns
  (dx or None, dw_stack, db_stack)."""
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  if x.dtype != torch.float32:
    raise NotImplementedError(f"fused_mlp backward: {x.dtype} is not "
                              "supported on the card, only float32")
  _check_cuda("fused_mlp_bwd", x, w_stack, b_stack, g, *saved)
  dw = torch.empty_like(w_stack)
  db = torch.empty_like(b_stack)
  dx = torch.empty_like(x) if need_dx else None
  if n == 0:
    dw.zero_()
    db.zero_()
    return (dx, dw, db)
  w_big, w_small = split
  sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
  rows, splits = wgrad_splits(n, d, sm_count)
  part_w = x.new_empty(splits, d, d)
  part_b = x.new_empty(splits, d)
  bufs = [torch.empty_like(x), torch.empty_like(x)]
  dz = torch.mul(g, saved[-1] > 0, out=bufs[0]) if last_relu else g
  for i in range(n_layers - 1, -1, -1):
    act = x if i == 0 else saved[i - 1]
    fused_mlp_bwd_wgrad(act, dz, part_w, part_b, rows)
    fused_mlp_bwd_reduce(part_w, part_b, dw[i], db[i, 0])
    if i > 0:
      nxt = bufs[1] if dz is bufs[0] else bufs[0]
      dz = fused_mlp_bwd_dgrad(dz, w_big[i], w_small[i], act, nxt)
    elif need_dx:
      fused_mlp_bwd_dgrad(dz, w_big[0], w_small[0], None, dx)
  return dx, dw, db


class FusedMLPFunction(torch.autograd.Function):
  """`fused_mlp` under autograd. CUDA: the weights are split once
  (`tf32_split`, both layouts), the kernel forward keeps every layer's
  output and the backward runs the dgrad kernel on the kept split and the
  wgrad kernel. CPU:
  `fused_mlp_plain`'s layers forward and `fused_mlp_bwd_plain` backward.
  bf16 raises NotImplementedError (the trainer's mip path is float32)."""

  @staticmethod
  def forward(ctx, x, w_stack, b_stack, last_relu):
    if torch.bfloat16 in (x.dtype, w_stack.dtype, b_stack.dtype):
      raise NotImplementedError("fused_mlp under autograd: bfloat16 is not "
                                "supported yet, only float32")
    split = (None, None)
    if x.device.type == "cuda":
      *split, big_t, small_t = tf32_split(w_stack)
      out, kept = _launch_fwd(x, w_stack, b_stack, last_relu, keep=True,
                              split_t=(big_t, small_t))
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
                                 (w_big, w_small), ctx.last_relu,
                                 need_dx=ctx.needs_input_grad[0])
    else:
      dx, dw, db = fused_mlp_bwd_plain(x, w_stack, b_stack, saved, g,
                                       ctx.last_relu)
    return dx, dw, db, None


def fused_mlp(x, w_stack, b_stack, last_relu: bool = True):
  """Uniform-width ReLU MLP: x [N, D] -> [N, D].

  w_stack [L, D, D] (layout [in, out]), b_stack [L, 1, D]; last_relu
  controls the final activation. CPU tensors run the plain versions.
  CUDA tensors launch the kernels (float32, or bfloat16 without autograd;
  contiguous, D a multiple of 128, 16-byte aligned) or raise. With grad
  enabled and any input requiring grad the call is differentiable
  (`FusedMLPFunction`). `fused_mlp.launches` counts forward launches;
  `tf32_split` and the backward's wrappers count their own.
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
            fused_mlp_bwd_reduce):
  _fn.launches = 0
