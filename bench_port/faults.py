"""Faults planted under the timed path, for the tests that see `correct`
come out false and for reading each fault's numbers on the card. Each
takes what the traffic loop built and returns the broken callable; a
traffic kind's module lists the ones its cells can have in its FAULTS;
none is reachable from a benchmark run."""

from __future__ import annotations


def unchanged_state(state, step):
  """A step that leaves its state as it was: the optimizer never
  updates."""
  state.optimizer.step = lambda *args, **kwargs: None
  return step


def half_batch(state, step):
  """Half of the batch left out of the data, depth and semantic terms,
  the masked means taken over the rest."""
  import torch
  from snerf_tpu_torch.train import losses
  orig = losses.masked_mean

  def half_mean(x, mask=None):
    keep = torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2
    if mask is None:
      mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep = keep.reshape(-1, *([1] * (mask.dim() - 1)))
    return orig(x, mask & keep)

  def broken(st, gen):
    losses.masked_mean = half_mean
    try:
      return step(st, gen)
    finally:
      losses.masked_mean = orig
  return broken


def altered_answer(render_fn, delta: float = 0.05):
  """Every chunk's first ray comes back with its colour moved by delta."""

  def broken(rays):
    out = render_fn(rays)
    out["rgb"] = out["rgb"].clone()
    out["rgb"][0] += delta
    return out
  return broken
