"""The device's idle share of the traced render chunks: 1 - the union of busy
kernel intervals over the window's wall time, %."""

from bench_port import readers


def read(reading, work):
  return readers.idle_share(reading)
