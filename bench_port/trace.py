"""The traced run: spans that the benchmark wraps from outside around the
calls into the port's layers, the profiler window, and its reduction to
device seconds by layer, the busy time and the idle gaps.

Spans (`torch.profiler.record_function`, as chip_smoke.py's
`_label_encoders` wraps them): "bench.hash_encode" around every hash
encoder's `encode_fn`, "bench.cp_encode" around every CP grid's forward,
"bench.k1" around every MLP's `stack_fn` (the trunk's square runs), and
"bench.unit" around each train step or render chunk. A backward kernel
belongs to the autograd node that launched it
("autograd::engine::evaluate_function: <Node>"). Which spans, nodes and
kernel names make a layer is data: the union of bench_port/layers/*.json.
A kernel whose name a layer lists (by substring) belongs to that layer
wherever it was launched: the port launches its own kernels through
ctypes, and outside an autograd Function (in inference mode) the
profiler links such a launch to whichever op ran last. Any other kernel
belongs to the layers of the innermost span or node among its ancestors
that any layer names; so a checkpoint's recompute, run under whichever
node first unpacks, is not charged to that node's layer unless it runs
inside one of the layer's own spans.

Each device event is charged once. The profiler lists a kernel under
every host event that carries its launch's correlation id, and under
some that do not launch it: a "Command Buffer Full" wait inside the
launch's runtime call (where the host waited for room in the launch
queue), the profiler's own buffer events nested in the op, and a runtime
call such as `cudaStreamIsCapturing` whose id collides with the op's.
Runtime calls and what runs inside one own no kernel; of the other
listings of one id, the outermost (the earliest to start) does.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

EVAL_PREFIX = "autograd::engine::evaluate_function: "
UNIT_SPAN = "bench.unit"
LAYERS_DIR = Path(__file__).resolve().parent / "layers"


RULES = ("spans", "backward", "kernels")


def load_layers(directory: Path = LAYERS_DIR) -> Dict[str, Dict[str, list]]:
  """{layer: {"spans": [...], "backward": [...], "kernels": [...]}}: the
  union of every *.json file under `directory`, lists merged."""
  out: Dict[str, Dict[str, list]] = {}
  for path in sorted(directory.glob("*.json")):
    for layer, rule in json.loads(path.read_text())["layers"].items():
      cur = out.setdefault(layer, {k: [] for k in RULES})
      for key in RULES:
        cur[key] += [v for v in rule.get(key, []) if v not in cur[key]]
  return out


def _markers(layers) -> Dict[str, frozenset]:
  """{event name: the layers it marks}."""
  marks: Dict[str, set] = {}
  for layer, rule in layers.items():
    for span in rule["spans"]:
      marks.setdefault(span, set()).add(layer)
    for node in rule["backward"]:
      marks.setdefault(EVAL_PREFIX + node, set()).add(layer)
  return {k: frozenset(v) for k, v in marks.items()}


def _labelled(fn: Callable, label: str, record=None) -> Callable:
  from torch.profiler import record_function

  def wrapped(*args, **kwargs):
    with record_function(label):
      if record is not None:
        record(*args)
      return fn(*args, **kwargs)
  return wrapped


def instrument(model, hash_calls: Optional[list] = None) -> Callable[[], None]:
  """Wrap the model's hash encoders, CP grids and trunk runs in their
  spans; with `hash_calls`, each hash encode appends (x, spec, table
  rows) to it. Returns the function that removes the wrappers."""
  undo = []
  record = None
  if hash_calls is not None:
    def record(x, table, spec):
      hash_calls.append((x.detach(), spec, table.shape[0]))
  for m in model.modules():
    if hasattr(m, "encode_fn") and hasattr(m, "embeddings"):
      undo.append((m, "encode_fn", m.encode_fn))
      m.encode_fn = _labelled(m.encode_fn, "bench.hash_encode", record)
    if type(m).__name__ == "CPEncoding":
      undo.append((m, "forward", None))
      m.forward = _labelled(m.forward, "bench.cp_encode")
    if hasattr(m, "stack_fn"):
      undo.append((m, "stack_fn", m.stack_fn))
      m.stack_fn = _labelled(m.stack_fn, "bench.k1")

  def restore():
    for m, attr, orig in undo:
      if orig is None:
        delattr(m, attr)
      else:
        setattr(m, attr, orig)
  return restore


def unit(fn: Callable) -> Callable:
  """fn wrapped in the span of one unit (a train step, a render chunk)."""
  return _labelled(fn, UNIT_SPAN)


@dataclasses.dataclass
class TraceReading:
  """What the readers read: device kernels (name, start s, end s), device
  seconds by layer, the traced window's host seconds, the units (steps or
  chunks) in it, and the idle time by what the host was doing."""
  kernels: List[Tuple[str, float, float]]
  layer_s: Dict[str, float]
  window_s: float
  units: int
  idle_by_host: List[Tuple[str, float]]

  def busy_s(self) -> float:
    """The union of the kernels' intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
      if e <= end:
        continue
      busy += e - max(s, end)
      end = e
    return busy

  def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
    by: Dict[str, float] = {}
    for name, s, e in self.kernels:
      by[name] = by.get(name, 0.0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def _is_device(e) -> bool:
  from torch.autograd import DeviceType
  return (e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False))


def _is_host(e) -> bool:
  from torch.autograd import DeviceType
  return e.device_type == DeviceType.CPU


def reduce_events(events, window_s: float, units: int, layers,
                  is_device=_is_device, is_host=_is_host) -> TraceReading:
  """The profiler's events -> TraceReading. Device kernels come from the
  device events. A kernel whose name a layer lists goes to that layer;
  each CPU event's other launched kernels go to the layers of the
  innermost marking span or node above it, each kernel name capped at the
  device time that name took. The kernels of one launch are counted once,
  under the host event that owns them (`_owners`)."""
  marks = _markers(layers)
  kernels, budget = [], {}
  cpu = []
  for e in events:
    if is_device(e):
      s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
      kernels.append((e.name, s, t))
      budget[e.name] = budget.get(e.name, 0.0) + (t - s)
    elif is_host(e):
      cpu.append(e)
  layer_s = {layer: 0.0 for layer in layers}
  for name in list(budget):
    named = [layer for layer, rule in layers.items()
             if any(k in name for k in rule.get("kernels", ()))]
    for layer in named:
      layer_s[layer] += budget[name]
    if named:
      budget[name] = 0.0
  for e in _owners(cpu):
    owner, p = None, e
    while p is not None and owner is None:
      owner = marks.get(p.name)
      p = p.cpu_parent
    if not owner:
      continue
    for k in e.kernels:
      sec = min(k.duration / 1e6, budget.get(k.name, 0.0))
      if sec > 0:
        budget[k.name] -= sec
        for layer in owner:
          layer_s[layer] += sec
  return TraceReading(kernels=kernels, layer_s=layer_s, window_s=window_s,
                      units=units, idle_by_host=_idle_by_host(kernels, cpu))


_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def _lists_only(e) -> bool:
  """Whether a host event lists kernels without launching them: a CUDA
  runtime call, a "Command Buffer Full" wait, or an event inside either."""
  return e is not None and (e.name == "Command Buffer Full"
                            or bool(_RUNTIME.match(e.name))
                            or _lists_only(e.cpu_parent))


def _owners(cpu):
  """The host events that own the kernels they list, in their order: of
  the events of one correlation id (where there is none, of one name and
  interval) that list kernels and are not `_lists_only`, the outermost,
  the earliest to start (the longest of those)."""
  best = {}
  for e in cpu:
    if not e.kernels or _lists_only(e):
      continue
    corr = getattr(e, "id", 0)
    key = corr if corr > 0 else (e.name, e.time_range.start, e.time_range.end)
    held = best.get(key)
    if held is None or ((e.time_range.start, -e.time_range.end)
                        < (held.time_range.start, -held.time_range.end)):
      best[key] = e
  chosen = {id(e) for e in best.values()}
  return [e for e in cpu if id(e) in chosen]


def _idle_by_host(kernels, cpu, top: int = 10):
  """The `top` longest gaps between busy device intervals, each named by
  the innermost host op running at its middle (the latest-starting op
  that spans it)."""
  spans = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                 for e in cpu)
  starts = [s for s, _, _ in spans]
  gaps, end = [], None
  for _, s, t in sorted(kernels, key=lambda k: k[1]):
    if end is not None and s > end:
      gaps.append((s - end, end, s))
    end = t if end is None else max(end, t)
  out = []
  for length, a, b in sorted(gaps, reverse=True)[:top]:
    mid, label = (a + b) / 2, "no host op"
    i = bisect.bisect_right(starts, mid) - 1
    while i >= 0:
      if spans[i][1] >= mid:
        label = spans[i][2]
        break
      i -= 1
    out.append((label, length))
  return out


def profile(torch, run: Callable[[], int], layers) -> TraceReading:
  """Run `run` (which returns the units it did) under torch.profiler,
  CPU and CUDA, the host clock around it ending in a synchronize."""
  from torch.profiler import ProfilerActivity, profile as tprofile
  cuda = torch.cuda.is_available()
  activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  sync()
  with tprofile(activities=activities) as prof:
    t0 = time.perf_counter()
    units = run()
    sync()
    window_s = time.perf_counter() - t0
  return reduce_events(prof.events(), window_s, units, layers)
