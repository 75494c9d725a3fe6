"""The fused hash encode's share of its roofline in training: the bound of its
forward and backward at the rows a step's positions touch (counts/zip.py;
counted on one more step after the traced window) over the device time of
its kernels, %."""

from bench_port import readers


def read(reading, work):
  return readers.roofline(work, "hash_encode_s", reading, "hash_encode")
