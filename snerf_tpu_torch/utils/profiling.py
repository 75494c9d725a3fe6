"""The port's tracing: named spans on the profiler's clock, the counts read
from a finished trace, and the training loop's profile window
(counterpart of `_ProfileWindow` in train.py).

`span(name)` is a profiler span while a profiler runs
(`torch.autograd._profiler_enabled()`) and one shared no-op otherwise:
off, a span costs that one C call. On, it is the record function behind
`torch.profiler.record_function` entered from C++ (`_RecordFunctionFast`,
as torch.compile's annotations use it), without the two dispatched ops
by which `record_function` enters and leaves it, so a traced span costs
the host a fraction of the time. There is no flag: tracing is on
exactly while a profiler runs (cli.train's `--profile_steps`
window, or any `torch.profiler.profile` around the port's calls). The
spans are profiler events, so they share the device trace's clock, and
each kernel and each idle gap of the trace falls under the phase that
launched it or kept the device waiting.

`counts(events)` reads a finished profile (`prof.events()`): the units
(the spans in UNITS: train steps and render chunks), the host syncs
inside them, the CUDA runtime calls that hold the host until the device
has drained (SYNC_CALLS), by site, and the spans in PER_UNIT a unit (which
path each CP level encode took). The counting adds no host work inside
the traced window.

The spans (names fixed):
  snerf.train.step      one zip train step (unit; train/zip_trainer.py)
  snerf.train.draw      the step's pixel and model draws, the pose table,
                        the ray batch and its targets
  snerf.level.sample    per level: dilation, resampling, the intervals,
                        s_to_t and the cast (and the rays' warp and basis
                        before the first level)
  snerf.level.mlp       per level: the MLP's call
  snerf.level.composite per level: the alpha weights and the compositing
  snerf.encode.hash     a hash encoder's encode (models/hashgrid.py)
  snerf.encode.cp       a CP grid's forward (models/cpgrid.py)
  snerf.encode.cp.fused one CP level by the kernel (ops/cp_encode.py)
  snerf.encode.cp.plain one CP level by the plain PyTorch path
  snerf.k1              a trunk's run of square layers (models/mlp.py)
  snerf.train.losses    the model's output to the total loss
  snerf.train.backward  `total.backward()` (its kernels run on autograd's
                        thread, outside this span)
  snerf.train.clip      zero-filled grads, the clips, the learning rate
  Optimizer.step#Adam.step  (torch.optim's own span)
  snerf.train.ema       the EMA update
  snerf.render.chunk    one render chunk (unit; train/renderer.py)

`--profile_steps N` traces about N training steps from the first step at
or after `--profile_start`, CPU and (on the card) CUDA activity, and
writes a Chrome trace and the window's counts (`counters_step<N>.json`:
units, host syncs and their sites, and the allocator's `num_alloc_retries`
over the window) into <exp_dir>/profile.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os

import torch

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
UNITS = ("snerf.train.step", "snerf.render.chunk")
# CUDA runtime calls that return only once the device (or a stream, or an
# event) has drained: `.item()`, a pageable copy to or from the device,
# `nonzero` and the like end in cudaStreamSynchronize; cudaFree waits for
# the whole device
SYNC_CALLS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaFree"})
NODE_PREFIX = "autograd::engine::evaluate_function: "
# spans counted a unit by `counts`
PER_UNIT = ("snerf.encode.cp.fused", "snerf.encode.cp.plain")


def span(name: str):
  """A profiler span named `name` while a profiler runs, else the shared
  no-op context."""
  if _enabled():
    return torch._C._profiler._RecordFunctionFast(name)
  return _OFF


def _site(e) -> str:
  """The innermost program span or autograd node above a runtime call,
  and the outermost op below it that made the call."""
  op, p = None, e.cpu_parent
  while p is not None:
    if p.name.startswith("snerf.") or p.name.startswith(NODE_PREFIX):
      break
    if not p.name.startswith("cuda"):
      op = p.name
    p = p.cpu_parent
  where = "no span" if p is None else p.name
  return where if op is None else f"{where} > {op}"


def counts(events) -> dict:
  """The units of a finished profile, the host syncs that start inside
  one, on any thread (a sync of the backward runs on autograd's), by
  site, and each PER_UNIT span started inside one, a unit: {"units",
  "host_syncs", "host_syncs_by_site", "spans_per_unit"}."""
  spans = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.name in UNITS)
  starts = [s for s, _ in spans]

  def inside(e) -> bool:
    i = bisect.bisect_right(starts, e.time_range.start) - 1
    return i >= 0 and e.time_range.start <= spans[i][1]

  sites: collections.Counter = collections.Counter()
  per_unit = dict.fromkeys(PER_UNIT, 0)
  for e in events:
    if e.name in SYNC_CALLS and inside(e):
      sites[_site(e)] += 1
    elif e.name in per_unit and inside(e):
      per_unit[e.name] += 1
  units = len(spans)
  return {"units": units, "host_syncs": sum(sites.values()),
          "host_syncs_by_site": dict(sorted(sites.items())),
          "spans_per_unit": {k: v / units if units else 0.0
                             for k, v in per_unit.items()}}


class ProfileWindow:
  """torch.profiler over ~profile_steps steps; tick(i) before each step,
  close() after the loop."""

  def __init__(self, cfg, exp_dir: str, device: torch.device):
    self.n = int(getattr(cfg, "profile_steps", 0) or 0)
    self.start = int(getattr(cfg, "profile_start", 20) or 0)
    self.dir = os.path.join(exp_dir, "profile")
    self.device = torch.device(device)
    self.prof = None
    self.done = False
    self.started_at = 0
    self.retries0 = None

  def _retries(self):
    if self.device.type != "cuda":
      return None
    return torch.cuda.memory_stats(self.device).get("num_alloc_retries", 0)

  def tick(self, i: int):
    if not self.n or self.done:
      return
    if self.prof is None and i >= self.start:
      acts = [torch.profiler.ProfilerActivity.CPU]
      if self.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
      self.retries0 = self._retries()
      self.prof = torch.profiler.profile(activities=acts)
      self.prof.__enter__()
      self.started_at = i
      print(f"[profile] tracing ~{self.n} steps from step {i} -> {self.dir}")
    elif self.prof is not None and i >= self.started_at + self.n:
      self.close()

  def close(self):
    if self.prof is None:
      return
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)
    self.prof.__exit__(None, None, None)
    retries = self._retries()
    window = dict(counts(self.prof.events()),
                  num_alloc_retries=(None if retries is None
                                     else retries - self.retries0))
    os.makedirs(self.dir, exist_ok=True)
    self.prof.export_chrome_trace(os.path.join(
        self.dir, f"trace_step{self.started_at:06d}.json"))
    with open(os.path.join(
        self.dir, f"counters_step{self.started_at:06d}.json"), "w") as f:
      json.dump(window, f, indent=1)
    self.prof = None
    self.done = True
