"""The FLOP and byte counts at a small size, against counts by hand."""

import types

import pytest
import torch

from bench_port.counts import zip as Z

HASH = dict(num_levels=3, num_prop_samples=(2, 2), num_nerf_samples=1,
            encoder_type="hash", grid_num_levels=2, prop_grid_level_dim=1,
            nerf_grid_level_dim=4, density_hidden_width=4,
            bottleneck_width=8, use_viewdirs=True, deg_view=1,
            net_depth_viewdirs=2, net_width_viewdirs=8,
            prop_grid_resolutions=(16, 32), nerf_grid_resolution=64,
            compute_dtype=torch.bfloat16, cp_collapse_multisamples=True,
            ipe_anisotropic=False, cp_anisotropic=False, sample_n=7)


def test_hash_arm_products_by_hand():
  c = types.SimpleNamespace(**HASH)
  # a proposal MLP, 2 rows: 2*2*(2*4) + 2*2*(4*1) = 48; the nerf MLP, 1
  # row: density 2*8*4 + 2*4*8, view 2*17*8 + 2*25*8 (the skip-cat of the
  # 17-wide view input), rgb 2*8*3 = 848
  flops = sum(f for _, f, _ in Z.products(c, rays=1, train=False))
  assert flops == 2 * 48 + 848
  train = Z.products(c, rays=1, train=True)
  assert sum(f for _, f, _ in train) == 3 * (2 * 48 + 848)
  assert {dt for name, _, dt in train if "rgb" not in name} == {"bf16"}
  assert [dt for name, _, dt in train if "rgb" in name] == ["f32"]
  assert Z.products_bound_s(c, 1, False) == pytest.approx(944 / 495e12)


def test_trunk_runs_as_the_trunk_forms_them():
  # enc = 6 (ipe, max deg 1) + 1 CP level x 2 = 8 = the trunk width, so
  # layer 0 is square: run [0, 1, 2], the skip-cat after 2 widens layer 3
  # (16 -> 8, cuBLAS), then density_hidden alone (8 -> 8)
  c = types.SimpleNamespace(**{
      **HASH, "encoder_type": "cp", "ipe_max_deg": 1, "cp_prop_num_levels": 1,
      "cp_prop_level_dim": 2, "cp_num_levels": 1, "cp_level_dim": 2,
      "cp_base_resolution": 4, "cp_max_resolution": 4,
      "ipe_skip_layer": 2, "ipe_density_depth": 4, "ipe_density_width": 8,
      "density_hidden_width": 8, "cp_pair_dim": 0})
  c.encoder_type = "cp_ipe"
  linears, runs, cp = Z.mlp_shapes(c, 0)
  assert runs == [(8, 3), (8, 1)]
  assert [(n, i, o) for n, i, o, _ in linears] == [
      ("ipe_layers.3", 16, 8), ("density_out", 8, 1)]
  assert cp == [(4, 2)] * 3
  # the nerf MLP's trunk is the same (1 CP level of 2); K1 in eval, float32
  # at 495 TFLOP/s and 3.35 TB/s: a run of n layers on `rows` rows reads x
  # (rows*8), W and b (n*(64+8)) and writes its last layer (rows*8); the
  # proposal MLPs have 2 rows a ray, the nerf MLP 1
  d = 8

  def run(rows, n):
    return max(2.0 * rows * d * d * n / 495e12,
               4.0 * (rows * d + n * (d * d + d) + rows * d) / 3.35e12)
  want = sum(run(rows, n) for rows in (2, 2, 1) for n in (3, 1))
  assert Z.k1_bound_s(c, 1, train=False) == pytest.approx(want)


def test_hash_encode_bytes_by_hand():
  # N 10, L 2, C 4, T 100 rows, 30 touched: forward 4*(30 + 80 + 120) B,
  # backward 4*(30 + 80 + 400) B, both over the blend's 1,280 FLOPs
  got = Z.hash_encode_bound_s([(10, 2, 4, 100, 30)], train=True)
  assert got == pytest.approx((920 + 2040) / 3.35e12)
  assert Z.hash_encode_bound_s([(10, 2, 4, 100, 30)], train=False) == \
      pytest.approx(920 / 3.35e12)


def test_touched_rows_by_hand():
  # one dense level of resolution 1 (2^3 corners in a table of 27 rows):
  # two points in neighbouring cells share a face, 4 of their 16 corners
  spec = types.SimpleNamespace(scales=(1.0,), resolutions=(2,), sizes=(27,))
  x = torch.tensor([[0.25, 0.25, 0.25], [0.75, 0.25, 0.25]])
  assert Z.touched_rows(x, spec) == 12
  assert Z.touched_rows(x[:1], spec) == 8
