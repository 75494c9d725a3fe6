"""The mip step's FLOP and byte counts (counts/mip.py) at a small size,
against counts by hand."""

import types

import pytest

from bench_port.counts import mip as M

# IPE of degree 2 (12 features), view directions of degree 1 (9), a 4 x 8
# proposal and an 8 x 16 fine MLP, 2 view layers of 128
TINY = types.SimpleNamespace(
    min_deg_point=0, max_deg_point=2, deg_view=1, use_viewdirs=True,
    proposal_hidden_layer=8, hidden_layer=16, rgb_layer=2, semantic=False,
    semantic_class_num=0, num_samples=4, num_fine_intervals=3)


def test_layers_as_the_trunk_splits_them():
  shapes = M.mlp_shapes(TINY)
  # the proposal: 12 -> 8, then a run of 3 square layers, the density head
  assert shapes[0] == (4, [("layers.0", 12, 8), ("density_layer", 8, 1)],
                       [(8, 3)])
  # the fine trunk: 12 -> 16, run 1-4, the skip-cat 28 -> 16, run 6-7; the
  # density head, the bottleneck, 25 -> 128 -> 128 and the rgb head
  rows, linears, runs = shapes[1]
  assert rows == 3 and runs == [(16, 4), (16, 2)]
  assert linears == [("layers.0", 12, 16), ("layers.5", 28, 16),
                     ("density_layer", 16, 1), ("bottleneck_layer", 16, 16),
                     ("cond_layers.0", 25, 128), ("cond_layers.1", 128, 128),
                     ("rgb_layer", 128, 3)]


def test_products_by_hand():
  # a ray: 4 proposal rows of 12*8 + 3*64 + 8 multiply-adds, 3 fine rows
  # of 12*16 + 6*256 + 28*16 + 16 + 256 + 25*128 + 128*128 + 128*3; each
  # counted forward, dgrad and wgrad at 2 FLOPs a multiply-add
  prop = 4 * (96 + 192 + 8)
  fine = 3 * (192 + 1536 + 448 + 16 + 256 + 3200 + 16384 + 384)
  flops = sum(f for _, f, _ in M.products(TINY, rays=1))
  assert flops == 3 * 2 * (prop + fine)
  assert M.products_bound_s(TINY, 1) == pytest.approx(flops / 495e12)


def test_k1_bound_by_hand():
  # float32 at 495 TFLOP/s and 3.35 TB/s, 4-byte elements: a run of L
  # layers of width d on n rows reads x, W and b and writes every layer's
  # output; a dgrad reads dz, the layer below's output and W and writes
  # dx; a wgrad reads the activations and dz and writes dW and db
  def bound(flops, nbytes):
    return max(flops / 495e12, 4.0 * nbytes / 3.35e12)

  want = 0.0
  for n, d, layers in ((4, 8, 3), (3, 16, 4), (3, 16, 2)):
    want += bound(2.0 * n * d * d * layers,
                  n * d + layers * (d * d + d) + layers * n * d)
    want += layers * bound(2.0 * n * d * d, 3 * n * d + d * d)
    want += layers * bound(2.0 * n * d * d, 2 * n * d + d * d + d)
  assert M.k1_bound_s(TINY, 1) == pytest.approx(want)
