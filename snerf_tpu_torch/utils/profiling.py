"""The training loop's profile window (counterpart of `_ProfileWindow` in
train.py) on `torch.profiler`.

`--profile_steps N` traces about N training steps from the first step at
or after `--profile_start`, CPU and (on the card) CUDA activity, and
writes a Chrome trace into <exp_dir>/profile.
"""

from __future__ import annotations

import os

import torch


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

  def tick(self, i: int):
    if not self.n or self.done:
      return
    if self.prof is None and i >= self.start:
      acts = [torch.profiler.ProfilerActivity.CPU]
      if self.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
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
    os.makedirs(self.dir, exist_ok=True)
    self.prof.export_chrome_trace(os.path.join(
        self.dir, f"trace_step{self.started_at:06d}.json"))
    self.prof = None
    self.done = True
