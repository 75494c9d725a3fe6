"""Device ms a train step under the mip model's `snerf.encode.ipe` span
(layers/mip.json: ipe): the forward of the cast, the warp of the Gaussians
and the IPE. It reads the forward only: their backward is autograd's
generic elementwise nodes, which no name sets apart from the rest of the
step's."""

from bench_port import readers


def read(reading, work):
  return readers.ms_per_unit(reading, "ipe")


# a TraceReading's fields, the work counts, and what `read` must give
CANNED = {
    "reading": {"kernels": [("k", 0.0, 1.0)], "layer_s": {"ipe": 0.03},
                "window_s": 5.0, "units": 2, "idle_by_host": []},
    "work": {},
    "value": 15.0}
