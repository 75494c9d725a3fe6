"""Device ms a train step under the encoders' spans and their backward nodes
(layers/*.json: encoders)."""

from bench_port import readers


def read(reading, work):
  return readers.ms_per_unit(reading, "encoders")
