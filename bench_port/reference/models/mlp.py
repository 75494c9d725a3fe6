"""The zip-nerf MLP layers' building blocks, plain PyTorch.

Parameters are float32; `compute_dtype` (float32, or bfloat16) is the
dtype the trunk and the layers listed in models/zipnerf.py run in: each
casts its input, weight and bias to it per call, so the gradients reach
the float32 parameters through the casts. Runs of uniform width x width
layers go through one `stack_fn` call (a plain matmul loop).

`lower_precision` is the precision control of the benchmark's check: it
rounds the operands of every product that runs in a lower compute dtype
than float32 through float8 (e4m3, the step below bfloat16) on their way
in, passing the gradient straight through.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

StackFn = Callable[..., torch.Tensor]


class DenseBlock(nn.Module):
  """Linear + ReLU, named as the reference's DenseBlock (`layers.0`)."""

  def __init__(self, in_features: int, out_features: int, device="cuda"):
    super().__init__()
    self.layers = nn.Sequential(
        nn.Linear(in_features, out_features, device=device), nn.ReLU())

  @property
  def linear(self) -> nn.Linear:
    return self.layers[0]

  def forward(self, x):
    return self.layers(x)


_FP8_MAX = 448.0
_ROUNDING = {"fp8": False}


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
  """t rounded through float8 e4m3 (saturated at its largest value), the
  gradient passed straight through."""
  q = torch.clamp(t, -_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).to(t.dtype)
  return t + (q - t).detach()


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """t cast to dtype for a product, rounded through float8 under
  `lower_precision` when dtype is below float32."""
  t = t.to(dtype)
  if _ROUNDING["fp8"] and dtype != torch.float32:
    t = _fp8_round(t)
  return t


@contextlib.contextmanager
def lower_precision():
  """Inside the block, every product in a compute dtype below float32
  reads its operands rounded through float8 (the precision control)."""
  _ROUNDING["fp8"] = True
  try:
    yield
  finally:
    _ROUNDING["fp8"] = False


def linear(layer: nn.Linear, h: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """`layer` applied in `dtype`: its input, weight and bias cast to dtype
  for the call (no-ops in float32)."""
  return F.linear(_operand(h, dtype), _operand(layer.weight, dtype),
                  layer.bias.to(dtype))


def _stacked(blocks, dtype=torch.float32):
  """[L, D, D] ([in, out]) weights and [L, 1, D] biases of uniform blocks,
  cast to dtype. Differentiable: under autograd the stack's grads flow
  back through the cast, torch.stack and .t() to each block's weight and
  bias."""
  w = torch.stack([b.linear.weight.t() for b in blocks]).to(dtype)
  bias = torch.stack([b.linear.bias[None] for b in blocks]).to(dtype)
  return w.contiguous(), bias.contiguous()


def _run_trunk(blocks, x, stack_fn: StackFn, skip_after=(),
               dtype: torch.dtype = torch.float32):
  """Apply DenseBlocks in `dtype` in order, sending each maximal run of
  square blocks through one stack_fn call and concatenating the trunk
  input x (in its own dtype, promoted as jnp.concatenate promotes) after
  every layer index in skip_after."""
  inputs = x
  h = x
  run = []

  def flush(h):
    if run:
      w, b = _stacked(run, dtype)
      lead = h.shape[:-1]
      h = stack_fn(_operand(h.reshape(-1, h.shape[-1]), dtype).contiguous(),
                   _operand(w, dtype), b, last_relu=True).reshape(*lead, -1)
      run.clear()
    return h

  for i, block in enumerate(blocks):
    lin = block.linear
    square = lin.in_features == lin.out_features == h.shape[-1]
    if square:
      run.append(block)
    else:
      h = F.relu(linear(lin, flush(h), dtype))
    if i in skip_after:
      h = torch.cat([flush(h), inputs], dim=-1)
  return flush(h)
