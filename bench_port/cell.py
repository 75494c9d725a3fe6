"""What a run of one cell knows: the workload's entry in BENCHMARK.json,
its configuration, traffic and limits files (found by name), the seed,
the window and the device; and the pieces every traffic kind shares."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


def load_benchmark(root: Path = ROOT) -> Dict:
  return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
  for w in bench["workloads"]:
    if w["name"] == name:
      return w
  raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_file(bench: Dict, name: str) -> Path:
  for c in bench["configs"]:
    if c["name"] == name:
      return ROOT / c["file"]
  raise SystemExit(f"unknown configuration {name!r}")


def traffic_file(name: str) -> Path:
  return BENCH / "traffic" / f"{name}.json"


def limits_file(workload_name: str) -> Path:
  return BENCH / "limits" / f"{workload_name}.json"


def metric_file(name: str) -> Path:
  return BENCH / "metrics" / f"{name}.py"


def flag_argv(flags: Dict[str, str]) -> List[str]:
  """The configuration's flags as the port's command line takes them."""
  return [t for k, v in flags.items() for t in (f"--{k}", str(v))]


@dataclasses.dataclass
class Cell:
  """One run's settings. `overrides` replaces flags and scene sizes (the
  CPU tests' small sizes; a benchmark run has none)."""
  name: str
  config: Dict
  traffic: Dict
  seed: int
  seconds: float
  trace: bool
  device: object
  t_start: float = dataclasses.field(default_factory=time.perf_counter)
  overrides: Optional[Dict] = None

  @property
  def flags(self) -> Dict[str, str]:
    flags = dict(self.config["flags"])
    flags.update((self.overrides or {}).get("flags", {}))
    return flags

  @property
  def scene_spec(self) -> Dict:
    spec = dict(self.config["scene"])
    spec.update((self.overrides or {}).get("scene", {}))
    return spec


def sync(torch, device) -> None:
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize()


class Pacer:
  """Keeps the host at most `ahead` units in front of the device: each
  unit records an event, and the host waits for the event `ahead` units
  back before it launches the next (the queue stays full, and a window's
  closing synchronize waits for at most that much work)."""

  def __init__(self, torch, device, ahead: int = 2):
    self.torch, self.ahead = torch, ahead
    self.cuda = torch.device(device).type == "cuda"
    self.events: List = []

  def __call__(self) -> None:
    if not self.cuda:
      return
    ev = self.torch.cuda.Event()
    ev.record()
    self.events.append(ev)
    if len(self.events) > self.ahead:
      self.events.pop(0).synchronize()
