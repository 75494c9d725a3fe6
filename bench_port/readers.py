"""What the per-layer metrics' readers share. Each reader (metrics/
<name>.py) takes the traced run's TraceReading and its work counts
(seconds the chip would need at its peaks, from bench_port/counts/) and
returns a number, or None when its run has nothing to read (the metric is
then left out of the line). A share is never returned as 0 for want of a
reading. Beside `read`, each reader keeps its canned case, `CANNED`: a
TraceReading's fields, the work counts and the value `read` must give
from them, which the tests read."""

from __future__ import annotations

from typing import Dict, Optional


def share_of_window(work: Dict[str, float], key: str, reading
                    ) -> Optional[float]:
  """100 x the work's least time over the traced window's wall time."""
  if not work.get(key) or reading.window_s <= 0:
    return None
  return 100.0 * work[key] / reading.window_s


def roofline(work: Dict[str, float], key: str, reading, layer: str
             ) -> Optional[float]:
  """100 x the op's bound over the device time of its layer."""
  spent = reading.layer_s.get(layer, 0.0)
  if not work.get(key) or spent <= 0:
    return None
  return 100.0 * work[key] / spent


def ms_per_unit(reading, layer: str) -> Optional[float]:
  """Device ms of a layer a step or chunk."""
  spent = reading.layer_s.get(layer, 0.0)
  if spent <= 0 or reading.units <= 0:
    return None
  return 1e3 * spent / reading.units


def idle_share(reading) -> Optional[float]:
  """100 x (1 - device busy time / the window's wall time)."""
  busy = reading.busy_s()
  if busy <= 0 or reading.window_s <= 0:
    return None
  return 100.0 * (1.0 - busy / reading.window_s)
