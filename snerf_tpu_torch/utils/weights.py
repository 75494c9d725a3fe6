"""Weights for the port's models (counterpart of
snerf_tpu/utils/ref_import.py).

`state_dict_from_flax` and `zip_state_dict_from_flax` map the JAX
package's mip and zip parameter trees (as numpy arrays) onto the port's
state_dicts: the inverses of `snerf_tpu.utils.ref_import`'s
`map_mip_state_dict` and `map_zip_state_dict`. `pose_params_from_flax`
and `train_state_from_flax` carry a JAX train state's model and pose
params across. `glorot_init_` and `zip_init_` are the port's own seeded
inits, for machines without JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from snerf_tpu_torch.models.hashgrid import HashEncoding


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


def pose_params_from_flax(pose_params: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
  """Flax LearnPose params {"r", "t"} -> the port's LearnPose
  state_dict."""
  return {k: torch.from_numpy(np.array(pose_params[k], np.float32))
          for k in ("r", "t")}


def train_state_from_flax(params: Dict[str, Any], pose_params=None):
  """A JAX train state's `params` (and `pose_params`, or None) -> the
  state_dicts (model, pose model or None) to load into the port's
  `create_train_state` models, so that both start from the same
  numbers."""
  return (state_dict_from_flax(params),
          None if pose_params is None else pose_params_from_flax(pose_params))


@torch.no_grad()
def glorot_init_(module: nn.Module, seed: int) -> nn.Module:
  """Seeded init in place: glorot-uniform weights and zero biases for
  every Linear, the init the JAX mip MLP sets explicitly on its Dense
  layers (flax's own default is lecun_normal, see `zip_init_`). The
  draws come from a CPU torch.Generator, so a seed gives the same
  weights on every device."""
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


# flax ZipMLP submodule -> the port's (reference torch) module name
_ZIP_DENSE = {"density_hidden": "density_layer.0",
              "density_out": "density_layer.2", "rgb_out": "rgb_layer"}


def zip_state_dict_from_flax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
  """Flax ZipNerfModel params {prop_mlp_i, nerf_mlp: {grid, density_hidden,
  density_out, view_i, rgb_out}} -> the port's ZipNerfModel state_dict
  (CPU float32 tensors). Submodules of unported arms raise."""
  sd: Dict[str, torch.Tensor] = {}
  for mlp_name, mlp in params.items():
    for name, leaf in mlp.items():
      if name == "grid":
        sd[f"{mlp_name}.encoder.embeddings"] = torch.from_numpy(
            np.array(leaf["table"], np.float32))
      elif name in _ZIP_DENSE:
        _dense(sd, f"{mlp_name}.{_ZIP_DENSE[name]}", leaf)
      elif name.startswith("view_"):
        _dense(sd, f"{mlp_name}.lin_second_stage_{name[5:]}", leaf)
      else:
        raise ValueError(f"{mlp_name}.{name}: not a parameter of the ported "
                         "hash arm")
  return sd


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
  """flax's default Dense kernel init: a normal truncated to +-2 std with
  variance 1 / fan_in after truncation."""
  fan_in = w.shape[1]
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  draw = torch.empty(w.shape, dtype=torch.float32)
  torch.nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
  return w.copy_(draw)


@torch.no_grad()
def zip_init_(model: nn.Module, seed: int,
              table_scale: float = 1e-4) -> nn.Module:
  """Seeded init of a ZipNerfModel in place, the JAX model's scheme:
  lecun_normal kernels and zero biases for every Linear, the density
  column of each `density_layer.2` zeroed when the config asks for
  density_zero_init, and hash tables uniform in +-table_scale (the JAX
  HashEncoding init_std, 1e-4, by default). The draws come from a CPU
  torch.Generator, so a seed gives the same weights on every device."""
  gen = torch.Generator(device="cpu").manual_seed(seed)
  zero_density = model.config.density_zero_init
  for name, m in model.named_modules():
    if isinstance(m, nn.Linear):
      _lecun_normal_(m.weight, gen)
      m.bias.zero_()
      if zero_density and name.endswith("density_layer.2"):
        m.weight[0].zero_()
    elif isinstance(m, HashEncoding):
      draw = torch.empty(m.embeddings.shape, dtype=torch.float32)
      draw.uniform_(-table_scale, table_scale, generator=gen)
      m.embeddings.copy_(draw)
  return model
