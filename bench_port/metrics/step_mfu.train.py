"""The train step's share of the chip's peak: the least time of its matrix
products (counts/zip.py) over the traced steps' wall time, %."""

from bench_port import readers


def read(reading, work):
  return readers.share_of_window(work, "products_s", reading)
