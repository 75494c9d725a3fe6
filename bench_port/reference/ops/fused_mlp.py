"""A run of uniform ReLU layers as a plain loop of dense layers, each in
the input's dtype: the product accumulated in float32 with the bias
added, rounded once to the dtype (`torch.addmm`), as a chain of dense
layers computes it; differentiable by PyTorch's autograd (in bfloat16
the gradient is rounded to bfloat16 between layers and each weight's
gradient once)."""

from __future__ import annotations

import torch


def fused_mlp(x, w_stack, b_stack, last_relu: bool = True):
  """x [N, D] -> [N, D] through w_stack [L, D, D] ([in, out]) and b_stack
  [L, 1, D]."""
  n_layers = w_stack.shape[0]
  h = x
  for i in range(n_layers):
    h = torch.addmm(b_stack[i].reshape(-1), h, w_stack[i])
    if i < n_layers - 1 or last_relu:
      h = torch.relu(h)
  return h
