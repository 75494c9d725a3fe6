"""The comparison that decides `correct`: the numbers compared, each
against its limit from bench_port/limits/<workload>.json (set from the
readings of sound runs and of the precision control; PERF.md gives
them).

Train cells, over the check steps:
  loss_gap    the largest |loss - reference loss| / |reference loss|;
  grad_gap    over the leaves, the largest gap between the norm of the
              program's first gradient and the reference's, over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
  change_gap  the same of each leaf's change after the steps (the EMA
              copy's too), leaving out the leaves whose reference
              gradient is under a thousandth of the median leaf's (they
              move under Adam by round-off alone).
Render cells, over the sampled chunks, a ray's gap being its largest
absolute difference over its colour channels (rgb) or class scores
(semantic), or |distance - reference| / max(reference, near) (depth):
  rgb_gap, semantic_gap, depth_gap   the largest gap over the rays: an
              answer altered shows here;
  rgb_mean_gap, semantic_mean_gap, depth_mean_gap   the mean gap over
              the rays: a precision lost on every ray shows here, where
              the largest gap swings with the few worst-conditioned rays
              a seed draws.
The accumulated opacity is not compared: with the configurations' opaque
background it is 1 to rounding in the program, the reference and the
precision control alike, so it can tell none of them apart.

A cell compares the numbers its limits file lists, and no others.
"""

from __future__ import annotations

import json
import statistics
from typing import Dict, List, Tuple

from bench_port.cell import limits_file

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves) -> float:
  leaves = list(leaves)
  if not leaves:
    return 0.0
  floor = statistics.median(ref[k] for k in leaves)
  return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
             for k in leaves)


def moved_leaves(ref: Dict) -> List[str]:
  """The leaves whose change is compared: those whose reference gradient
  is at least NEGLIGIBLE_GRAD of the median leaf's (an EMA leaf goes with
  its parameter)."""
  med = statistics.median(ref["grad"].values())
  return [k for k in ref["change"]
          if ref["grad"][k.removeprefix("ema.")] >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
  loss = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(prog["loss"], ref["loss"]))
  moved = moved_leaves(ref)
  return {"loss_gap": loss,
          "grad_gap": _leaf_gap(prog["grad"], ref["grad"], ref["grad"]),
          "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def render_numbers(prog: List[Dict], ref: List[Dict], near: float
                   ) -> Dict[str, float]:
  """prog, ref: per sampled chunk, {rgb, distance[, semantic], ...}."""
  import torch
  gaps: Dict[str, List] = {}
  for p, r in zip(prog, ref):
    gaps.setdefault("rgb", []).append((p["rgb"] - r["rgb"]).abs().amax(-1))
    rel = (p["distance"] - r["distance"]).abs() / r["distance"].abs().clamp(
        min=near)
    gaps.setdefault("depth", []).append(rel.reshape(-1))
    if "semantic" in r:
      gaps.setdefault("semantic", []).append(
          (p["semantic"] - r["semantic"]).abs().amax(-1))
  out = {}
  for name, per_chunk in gaps.items():
    rays = torch.cat([g.reshape(-1).double() for g in per_chunk])
    out[f"{name}_gap"] = float(rays.max())
    out[f"{name}_mean_gap"] = float(rays.mean())
  return out


def load_limits(workload: str) -> Dict[str, Dict]:
  return json.loads(limits_file(workload).read_text())["limits"]


def verdict(numbers: Dict[str, float], limits: Dict[str, Dict]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
  """(correct, {number: {"value", "limit"}}) over the numbers that
  `limits` lists: each at or under its limit; one that is not finite, or
  that the run did not produce, fails."""
  compared, ok = {}, True
  for name, spec in limits.items():
    value = numbers.get(name, float("nan"))
    limit = spec.get("limit")
    good = (limit is not None and value == value and value <= limit)
    ok = ok and good
    compared[name] = {"value": value, "limit": limit}
  return ok, compared
