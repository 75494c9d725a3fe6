"""K1's share of its roofline in training: the bound of its forward, dgrad and
wgrad (counts/zip.py) over the device time of its kernels (layers/*.json), %."""

from bench_port import readers


def read(reading, work):
  return readers.roofline(work, "k1_s", reading, "k1")
