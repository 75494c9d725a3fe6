"""The train step's share of the chip's peak: the least time of its matrix
products (counts/zip.py) over the traced steps' wall time, %."""

from bench_port import readers


def read(reading, work):
  return readers.share_of_window(work, "products_s", reading)


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("k", 0.0, 1.0)], "layer_s": {}, "window_s": 5.0,
                "units": 2, "idle_by_host": []},
    "work": {"products_s": 0.05},
    "value": 1.0}
