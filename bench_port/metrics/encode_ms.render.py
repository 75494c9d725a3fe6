"""Device ms a render chunk under the encoders' spans (layers/*.json:
encoders)."""

from bench_port import readers


def read(reading, work):
  return readers.ms_per_unit(reading, "encoders")
