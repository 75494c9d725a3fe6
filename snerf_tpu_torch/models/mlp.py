"""S-NeRF generation MLPs (counterpart of snerf_tpu/models/mlp.py).

Parameter names follow the reference S-NeRF torch model
(`mlp.layers.{i}.layers.0.weight`, `mlp.density_layer`, ...), the layout
snerf_tpu/utils/ref_import.py decodes, so a reference checkpoint loads
natively. Activations are float32.

Runs of uniform width x width layers in the trunk go through one
`stack_fn` call each (the fused-MLP kernel by default); the other layers
are plain matmuls.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from snerf_tpu_torch.ops.fused_mlp import fused_mlp

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


def _stacked(blocks):
  """[L, D, D] ([in, out]) weights and [L, 1, D] biases of uniform blocks.
  Differentiable: under autograd the stack's grads flow back through
  torch.stack and .t() to each block's weight and bias."""
  w = torch.stack([b.linear.weight.t() for b in blocks]).contiguous()
  bias = torch.stack([b.linear.bias[None] for b in blocks]).contiguous()
  return w, bias


def _run_trunk(blocks, x, stack_fn: StackFn, skip_after=()):
  """Apply DenseBlocks in order, sending each maximal run of square
  blocks through one stack_fn call and concatenating the trunk input
  after every layer index in skip_after."""
  inputs = x
  h = x
  run = []

  def flush(h):
    if run:
      w, b = _stacked(run)
      lead = h.shape[:-1]
      h = stack_fn(h.reshape(-1, h.shape[-1]).contiguous(), w, b,
                   last_relu=True).reshape(*lead, -1)
      run.clear()
    return h

  for i, block in enumerate(blocks):
    lin = block.linear
    square = lin.in_features == lin.out_features == h.shape[-1]
    if square:
      run.append(block)
    else:
      h = block(flush(h))
    if i in skip_after:
      h = torch.cat([flush(h), inputs], dim=-1)
  return flush(h)


class NerfMLP(nn.Module):
  """Trunk + density + semantic + view-conditioned rgb branch."""

  def __init__(self, in_features: int, condition_features: int = 0,
               net_depth: int = 8, net_width: int = 256,
               skip_layer: int = 4, condition_depth: int = 1,
               condition_width: int = 128, num_rgb_channels: int = 3,
               num_density_channels: int = 1,
               num_semantic_channels: int = 0,
               stack_fn: StackFn = fused_mlp, device="cuda"):
    super().__init__()
    self.stack_fn = stack_fn
    # The trunk input is concatenated AFTER layer i for i > 0 and
    # i % skip_layer == 0 (reference models.py:268-272).
    self.skip_after = tuple(i for i in range(net_depth)
                            if i > 0 and i % skip_layer == 0)
    layers, width_in = [], in_features
    for i in range(net_depth):
      layers.append(DenseBlock(width_in, net_width, device))
      width_in = net_width + (in_features if i in self.skip_after else 0)
    self.layers = nn.ModuleList(layers)
    self.density_layer = nn.Linear(width_in, num_density_channels,
                                   device=device)
    self.semantic_layer = None
    if num_semantic_channels > 0:
      self.semantic_layer = nn.Sequential(
          DenseBlock(width_in, net_width // 2, device),
          nn.Linear(net_width // 2, num_semantic_channels, device=device))
    self.bottleneck_layer = None
    cond_in = width_in
    if condition_features:
      self.bottleneck_layer = DenseBlock(width_in, net_width, device)
      cond_in = net_width + condition_features
    conds = []
    for _ in range(condition_depth if condition_features else 0):
      conds.append(DenseBlock(cond_in, condition_width, device))
      cond_in = condition_width
    self.cond_layers = nn.ModuleList(conds)
    self.rgb_layer = nn.Linear(cond_in, num_rgb_channels, device=device)

  def forward(self, x, condition: Optional[torch.Tensor] = None):
    """x: [..., S, F] features; condition: [..., C] per ray (broadcast
    over the sample axis) or [..., S, C]. Returns (raw_rgb, raw_density,
    raw_semantic or None)."""
    h = _run_trunk(self.layers, x, self.stack_fn, self.skip_after)
    raw_density = self.density_layer(h)
    raw_semantic = None
    if self.semantic_layer is not None:
      raw_semantic = self.semantic_layer(h)
    if condition is not None:
      bottleneck = self.bottleneck_layer(h)
      if condition.dim() == bottleneck.dim() - 1:
        condition = condition[..., None, :].expand(
            *bottleneck.shape[:-1], condition.shape[-1])
      h = torch.cat([bottleneck, condition], dim=-1)
      for block in self.cond_layers:
        h = block(h)
    raw_rgb = self.rgb_layer(h)
    return raw_rgb, raw_density, raw_semantic


class ProposalMLP(nn.Module):
  """Density-only proposal net (reference models.py:299-325)."""

  def __init__(self, in_features: int, net_depth: int = 4,
               net_width: int = 256, num_density_channels: int = 1,
               stack_fn: StackFn = fused_mlp, device="cuda"):
    super().__init__()
    self.stack_fn = stack_fn
    self.layers = nn.ModuleList(
        DenseBlock(in_features if i == 0 else net_width, net_width, device)
        for i in range(net_depth))
    self.density_layer = nn.Linear(net_width, num_density_channels,
                                   device=device)

  def forward(self, x):
    h = _run_trunk(self.layers, x, self.stack_fn)
    return self.density_layer(h)
