"""The device's idle share of the traced train steps: 1 - the union of busy
kernel intervals over the window's wall time, %."""

from bench_port import readers


def read(reading, work):
  return readers.idle_share(reading)


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)],
                "layer_s": {}, "window_s": 5.0, "units": 2,
                "idle_by_host": [("aten::item", 1.0)]},
    "work": {},
    "value": 40.0}
