"""The fused hash encode's share of its roofline in training: the bound of its
forward and backward at the rows a step's positions touch (counts/zip.py;
counted on one more step after the traced window) over the device time of
its kernels, %."""

from bench_port import readers


def read(reading, work):
  return readers.roofline(work, "hash_encode_s", reading, "hash_encode")


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("k", 0.0, 1.0)], "layer_s": {"hash_encode": 0.25},
                "window_s": 5.0, "units": 2, "idle_by_host": []},
    "work": {"hash_encode_s": 0.01},
    "value": 4.0}
