"""Weights for the port's models (counterpart of
snerf_tpu/utils/ref_import.py).

`state_dict_from_flax` maps the JAX package's mip parameter tree (as
numpy arrays) onto the port's state_dict: the inverse of
`snerf_tpu.utils.ref_import.map_mip_state_dict`. `glorot_init_` is the
port's own seeded init, for machines without JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _dense(sd, prefix, leaf):
  sd[prefix + ".weight"] = torch.from_numpy(
      np.array(np.asarray(leaf["kernel"], np.float32).T, order="C"))
  sd[prefix + ".bias"] = torch.from_numpy(
      np.array(leaf["bias"], np.float32))


def state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """Flax params {"mlp": {trunk_i, density, ...}, "proposal": {...}} ->
  the port's MipNerfModel state_dict (CPU float32 tensors)."""
  sd: Dict[str, torch.Tensor] = {}
  mlp = params["mlp"]
  i = 0
  while f"trunk_{i}" in mlp:
    _dense(sd, f"mlp.layers.{i}.layers.0", mlp[f"trunk_{i}"])
    i += 1
  _dense(sd, "mlp.density_layer", mlp["density"])
  if "bottleneck" in mlp:
    _dense(sd, "mlp.bottleneck_layer.layers.0", mlp["bottleneck"])
  j = 0
  while f"cond_{j}" in mlp:
    _dense(sd, f"mlp.cond_layers.{j}.layers.0", mlp[f"cond_{j}"])
    j += 1
  _dense(sd, "mlp.rgb_layer", mlp["rgb"])
  if "semantic" in mlp:
    _dense(sd, "mlp.semantic_layer.0.layers.0", mlp["semantic_hidden"])
    _dense(sd, "mlp.semantic_layer.1", mlp["semantic"])
  prop = params["proposal"]
  i = 0
  while f"trunk_{i}" in prop:
    _dense(sd, f"proposal.layers.{i}.layers.0", prop[f"trunk_{i}"])
    i += 1
  _dense(sd, "proposal.density_layer", prop["density"])
  return sd


@torch.no_grad()
def glorot_init_(module: nn.Module, seed: int) -> nn.Module:
  """Seeded init in place: glorot-uniform weights and zero biases for
  every Linear (the flax Dense defaults the JAX model uses). The draws
  come from a CPU torch.Generator, so a seed gives the same weights on
  every device."""
  gen = torch.Generator(device="cpu").manual_seed(seed)
  for m in module.modules():
    if isinstance(m, nn.Linear):
      fan_out, fan_in = m.weight.shape
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      w = torch.empty(m.weight.shape, dtype=torch.float32)
      w.uniform_(-limit, limit, generator=gen)
      m.weight.copy_(w)
      m.bias.zero_()
  return module
