"""Fused uniform-width ReLU MLP (counterpart of
snerf_tpu/ops/pallas/fused_mlp.py), forward only.

`fused_mlp` launches the hand-written Hopper kernel in
`snerf_tpu_torch/csrc/fused_mlp.cu` for CUDA tensors and runs
`fused_mlp_plain`, the same computation as a plain PyTorch loop, for CPU
tensors. The kernel is built and loaded by `ops/_cuda.py`.
"""

from __future__ import annotations

import ctypes

import torch

from snerf_tpu_torch.ops import _cuda

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2 ** 31 - 64  # the kernel indexes rows with int


def _bind(lib):
  lib.snerf_fused_mlp_fwd.argtypes = (
      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
  lib.snerf_fused_mlp_fwd.restype = ctypes.c_int


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


def fused_mlp_plain(x, w_stack, b_stack, last_relu: bool = True):
  """The kernel's computation as a plain PyTorch loop: f32 accumulation,
  cast to x.dtype after every layer."""
  _check_shapes(x, w_stack, b_stack)
  n_layers = w_stack.shape[0]
  h = x
  for i in range(n_layers):
    z = torch.matmul(h.float(), w_stack[i].float()) + b_stack[i].float()
    if i < n_layers - 1 or last_relu:
      z = torch.relu(z)
    h = z.to(x.dtype)
  return h


def fused_mlp(x, w_stack, b_stack, last_relu: bool = True):
  """Uniform-width ReLU MLP: x [N, D] -> [N, D].

  w_stack [L, D, D] (layout [in, out]), b_stack [L, 1, D]; last_relu
  controls the final activation. CPU tensors run `fused_mlp_plain`. CUDA
  tensors launch the kernel (float32 or bfloat16, contiguous, D a
  multiple of 128, 16-byte aligned x and weights, no autograd) or raise;
  `fused_mlp.launches` counts the launches.
  """
  n, d, n_layers = _check_shapes(x, w_stack, b_stack)
  if x.device.type == "cpu":
    return fused_mlp_plain(x, w_stack, b_stack, last_relu)
  if x.device.type != "cuda":
    raise ValueError(f"fused_mlp: unsupported device {x.device}")
  for name, t in (("w_stack", w_stack), ("b_stack", b_stack)):
    if t.device != x.device:
      raise ValueError(f"fused_mlp: {name} on {t.device}, x on {x.device}")
    if t.dtype != x.dtype:
      raise ValueError(f"fused_mlp: {name} is {t.dtype}, x is {x.dtype}")
  if x.dtype not in _DTYPE_CODE:
    raise ValueError(f"fused_mlp: dtype {x.dtype} not supported")
  if not (x.is_contiguous() and w_stack.is_contiguous()
          and b_stack.is_contiguous()):
    raise ValueError("fused_mlp: inputs must be contiguous")
  if d % 128 != 0:
    raise ValueError(f"fused_mlp: D={d} must be a multiple of 128")
  if x.data_ptr() % 16 or w_stack.data_ptr() % 16:
    raise ValueError("fused_mlp: x and w_stack must be 16-byte aligned")
  if n > _MAX_ROWS:
    raise ValueError(f"fused_mlp: N={n} rows exceeds {_MAX_ROWS}")
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, w_stack, b_stack)):
    raise RuntimeError("fused_mlp: the CUDA kernel is forward-only; run it "
                       "under torch.no_grad() or torch.inference_mode()")
  out = torch.empty_like(x)
  if n == 0:
    return out
  # the kernel writes the layers before the last through this scratch
  tmp = torch.empty_like(x) if n_layers > 1 else None
  lib = _cuda.load("fused_mlp", _bind)
  err = lib.snerf_fused_mlp_fwd(
      x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(), out.data_ptr(),
      None if tmp is None else tmp.data_ptr(), n, d, n_layers,
      int(bool(last_relu)), _DTYPE_CODE[x.dtype],
      x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
  _cuda.check_launch(lib, err,
                     f"fused_mlp at N={n} D={d} L={n_layers} {x.dtype}")
  fused_mlp.launches += 1
  return out


fused_mlp.launches = 0
