"""Device ms a train step under the encoders' spans and their backward nodes
(layers/*.json: encoders)."""

from bench_port import readers


def read(reading, work):
  return readers.ms_per_unit(reading, "encoders")


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("k", 0.0, 1.0)], "layer_s": {"encoders": 0.5},
                "window_s": 5.0, "units": 2, "idle_by_host": []},
    "work": {},
    "value": 250.0}
