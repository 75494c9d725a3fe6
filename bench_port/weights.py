"""The model weights of a cell, drawn on the device from the seed: one
normal draw for all the leaves, cut in order of name and scaled leaf by
leaf to the scale of a trained model, so that every layer the check
covers moves the outputs (a table at the +-1e-4 init would not).

  hash tables (`...embeddings`): N(0, 0.5^2), a trained table's features;
  CP factor tables (`...cp_grid.v{l}`, `p{l}`): 1 + N(0, 0.25^2);
  Linear weights [out, in]: N(0, 2 / in) (He);
  everything else (biases): N(0, 0.05^2).

The program's model and the reference model get the same draw by name.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

import torch

from bench_port.scene import generator

_CP_TABLE = re.compile(r"\.cp_grid\.[vp]\d+$")


def _scale(name: str, shape) -> Tuple[float, float]:
  """(offset, std) of a leaf."""
  if name.endswith("embeddings"):
    return 0.0, 0.5
  if _CP_TABLE.search(name):
    return 1.0, 0.25
  if name.endswith("weight") and len(shape) == 2:
    return 0.0, math.sqrt(2.0 / shape[1])
  return 0.0, 0.05


def draw(shapes: Iterable[Tuple[str, tuple]], seed: int, device,
         stream: str = "weights") -> Dict[str, torch.Tensor]:
  """{name: float32 tensor} for (name, shape) pairs, from one draw."""
  shapes = sorted((n, tuple(s)) for n, s in shapes)
  total = sum(math.prod(s) for _, s in shapes)
  flat = torch.randn(total, generator=generator(device, seed, stream),
                     device=device)
  out, at = {}, 0
  for name, shape in shapes:
    n = math.prod(shape)
    offset, std = _scale(name, shape)
    out[name] = flat[at:at + n].view(shape).mul_(std).add_(offset)
    at += n
  return out


@torch.no_grad()
def load(module: torch.nn.Module, seed: int, stream: str = "weights"
         ) -> Dict[str, torch.Tensor]:
  """Draw the module's parameters and copy them in; returns the draw."""
  params = dict(module.named_parameters())
  drawn = draw(((n, p.shape) for n, p in params.items()), seed,
               next(iter(params.values())).device, stream)
  for name, p in params.items():
    p.copy_(drawn[name])
  return drawn
