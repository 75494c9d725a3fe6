"""K1's share of its roofline in training: the bound of its forward, dgrad and
wgrad (counts/zip.py) over the device time of its kernels (layers/*.json), %."""

from bench_port import readers


def read(reading, work):
  return readers.roofline(work, "k1_s", reading, "k1")


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("k", 0.0, 1.0)], "layer_s": {"k1": 0.2},
                "window_s": 5.0, "units": 2, "idle_by_host": []},
    "work": {"k1_s": 0.1},
    "value": 50.0}
