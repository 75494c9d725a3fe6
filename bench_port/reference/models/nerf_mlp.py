"""The S-NeRF generation MLPs (`NerfMLP`, `ProposalMLP`), plain PyTorch:
a frozen copy of the port's, built on the blocks of models/mlp.py (the
dense block, the cast layer, the trunk whose runs of square layers go
through one `stack_fn` call, here the plain matmul loop).

Parameters are float32 and named as the port's; `compute_dtype` is the
dtype the trunk, the semantic hidden layer and the bottleneck and
condition layers run in; the density, semantic and rgb heads run in
float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from bench_port.reference.models.mlp import (DenseBlock, StackFn, _run_trunk,
                                             linear)
from bench_port.reference.ops.fused_mlp import fused_mlp


class NerfMLP(nn.Module):
  """Trunk + density + semantic + view-conditioned rgb branch."""

  def __init__(self, in_features: int, condition_features: int = 0,
               net_depth: int = 8, net_width: int = 256,
               skip_layer: int = 4, condition_depth: int = 1,
               condition_width: int = 128, num_rgb_channels: int = 3,
               num_density_channels: int = 1,
               num_semantic_channels: int = 0,
               stack_fn: StackFn = fused_mlp,
               compute_dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    self.stack_fn = stack_fn
    self.compute_dtype = compute_dtype
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
    dt = self.compute_dtype
    h = _run_trunk(self.layers, x.to(dt), self.stack_fn, self.skip_after, dt)
    raw_density = self.density_layer(h.float())
    raw_semantic = None
    if self.semantic_layer is not None:
      hidden, head = self.semantic_layer
      raw_semantic = head(F.relu(linear(hidden.linear, h, dt)).float())
    if condition is not None:
      bottleneck = F.relu(linear(self.bottleneck_layer.linear, h, dt))
      condition = condition.to(dt)
      if condition.dim() == bottleneck.dim() - 1:
        condition = condition[..., None, :].expand(
            *bottleneck.shape[:-1], condition.shape[-1])
      h = torch.cat([bottleneck, condition], dim=-1)
      for block in self.cond_layers:
        h = F.relu(linear(block.linear, h, dt))
    raw_rgb = self.rgb_layer(h.float())
    return raw_rgb, raw_density, raw_semantic


class ProposalMLP(nn.Module):
  """Density-only proposal net (reference models.py:299-325)."""

  def __init__(self, in_features: int, net_depth: int = 4,
               net_width: int = 256, num_density_channels: int = 1,
               stack_fn: StackFn = fused_mlp,
               compute_dtype: torch.dtype = torch.float32, device="cuda"):
    super().__init__()
    self.stack_fn = stack_fn
    self.compute_dtype = compute_dtype
    self.layers = nn.ModuleList(
        DenseBlock(in_features if i == 0 else net_width, net_width, device)
        for i in range(net_depth))
    self.density_layer = nn.Linear(net_width, num_density_channels,
                                   device=device)

  def forward(self, x):
    dt = self.compute_dtype
    h = _run_trunk(self.layers, x.to(dt), self.stack_fn, dtype=dt)
    return self.density_layer(h.float())
