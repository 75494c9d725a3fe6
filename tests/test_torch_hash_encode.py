"""The fused multi-level hash encode (ops/hash_encode.py, kernel K2
redesigned) against snerf_tpu/models/hashgrid.py on the same numpy inputs.

On the CPU `HashEncodeFunction` runs the kernels' plain versions:
`hash_encode_fwd_plain` (per level, the blend added in the kernel's
corner order) and `hash_encode_bwd_plain` (the table gradient by
`index_add_`, dx written out). Tolerances: the features agree with JAX's
to 1e-6 absolute (float32 trilinear sums of O(1) rows in another order);
the table gradient and dx agree with `jax.grad` within 1e-5 of max|JAX|
(float32 sums of up to a few hundred updates a row, in another order);
the written-out backward agrees with autograd of the plain forward in
float64 to 1e-12; `gradcheck` runs in float64 at its default
tolerances, on points kept away from the cell walls of every level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models import hashgrid as jhashgrid
from snerf_tpu_torch.models import hashgrid
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig, ZipNerfModel
from snerf_tpu_torch.ops import hash_encode as he
from snerf_tpu_torch.ops import hash_ops
from snerf_tpu_torch.utils.weights import zip_init_

# 4 levels; log2 13 keeps level 0 (17^3 rows) dense, the rest hashed
SPEC = dict(num_levels=4, base_resolution=16, desired_resolution=256,
            log2_hashmap_size=13)


def _spec(c, module=hashgrid):
  return module.make_grid_spec(level_dim=c, **SPEC)


def _inputs(seed, c, shape=(6, 40), lo=-0.05, hi=1.05):
  rng = np.random.RandomState(seed)
  spec = _spec(c)
  table = rng.uniform(-1, 1, (spec.total_rows, c)).astype(np.float32)
  x = rng.uniform(lo, hi, (*shape, 3)).astype(np.float32)
  cot = rng.normal(size=(*shape, spec.num_levels, c)).astype(np.float32)
  return spec, table, x, cot


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_fused_encode_cpu_matches_jax(c):
  """HashEncodeFunction's CPU path against JAX hash_encode: dense and
  hashed levels, points inside and outside [0, 1]^3 (zero features)."""
  spec, table, x, _ = _inputs(c, c)
  assert he._dense(spec, 0) and not he._dense(spec, 1)
  want = jhashgrid.hash_encode(jnp.asarray(x), jnp.asarray(table),
                               _spec(c, jhashgrid))
  before = he.hash_encode_fwd.launches
  got = hashgrid.hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                             spec)
  assert he.hash_encode_fwd.launches == before
  assert got.shape == (6, 40, spec.num_levels, c)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
  oob = ((x < 0) | (x > 1)).any(-1)
  assert oob.any() and (~oob).any() and not got.numpy()[oob].any()
  # the plain encode is the same function, bit for bit
  plain = hashgrid.hash_encode_plain(torch.from_numpy(x),
                                     torch.from_numpy(table), spec)
  assert torch.equal(got, plain)


@pytest.mark.parametrize("c", [1, 4])
def test_fused_encode_grads_match_jax(c):
  """The table gradient and dx of the fused encode (CPU: the written-out
  backward) against jax.grad of JAX hash_encode, with points outside
  [0, 1]^3 among them (no gradient)."""
  spec, table, x, cot = _inputs(10 + c, c, shape=(5, 7))
  x[0, 0] = [1.2, 0.5, 0.5]
  tt = torch.tensor(table, requires_grad=True)
  tx = torch.tensor(x, requires_grad=True)
  before = he.hash_encode_bwd.launches
  (hashgrid.hash_encode(tx, tt, spec) * torch.from_numpy(cot)).sum().backward()
  assert he.hash_encode_bwd.launches == before
  gt, gx = jax.grad(
      lambda t, p: jnp.sum(jhashgrid.hash_encode(p, t, _spec(c, jhashgrid))
                           * cot), argnums=(0, 1))(table, x)
  gt, gx = np.asarray(gt), np.asarray(gx)
  np.testing.assert_allclose(tt.grad.numpy(), gt,
                             atol=1e-5 * np.abs(gt).max(), rtol=0)
  np.testing.assert_allclose(tx.grad.numpy(), gx,
                             atol=1e-5 * np.abs(gx).max(), rtol=0)
  assert np.abs(gx).max() > 0 and not tx.grad[0, 0].any()


@pytest.mark.parametrize("need_dx", [False, True])
def test_bwd_plain_matches_autograd_of_fwd_plain(need_dx):
  """The written-out backward against PyTorch's autograd of the plain
  forward, in float64: the same function, summed in another order."""
  spec, table, x, cot = _inputs(20, 2, shape=(60,))
  xt = torch.tensor(x, dtype=torch.float64, requires_grad=need_dx)
  tt = torch.tensor(table, dtype=torch.float64, requires_grad=True)
  g = torch.tensor(cot, dtype=torch.float64)
  (he.hash_encode_fwd_plain(xt, tt, spec) * g).sum().backward()
  dtable, dx = he.hash_encode_bwd_plain(xt.detach(), tt.detach(), g, spec,
                                        need_dx)
  np.testing.assert_allclose(dtable.numpy(), tt.grad.numpy(), atol=1e-12)
  if need_dx:
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), atol=1e-12)
  else:
    assert dx is None


def _inside_cells(spec, n, seed):
  """n points whose cells' walls lie more than 5e-3 of a cell away at
  every level, so finite differences do not cross one."""
  rng = np.random.RandomState(seed)
  x = rng.uniform(0.05, 0.95, (20 * n, 3))
  keep = np.ones(len(x), bool)
  for s in spec.scales:
    frac = (x * s + 0.5) % 1.0
    keep &= ((frac > 5e-3) & (frac < 1 - 5e-3)).all(-1)
  return x[keep][:n]


def test_fused_encode_gradcheck_f64():
  spec = hashgrid.make_grid_spec(3, 2, 4, 32, 8)
  rng = np.random.RandomState(3)
  table = torch.tensor(rng.normal(size=(spec.total_rows, 2)),
                       dtype=torch.float64, requires_grad=True)
  x = torch.tensor(_inside_cells(spec, 6, 4), requires_grad=True)
  assert x.shape == (6, 3)
  assert torch.autograd.gradcheck(
      lambda t, p: he.HashEncodeFunction.apply(p, t, spec), (table, x))


@pytest.mark.parametrize("mlp", ["prop_mlp_0", "prop_mlp_1", "nerf_mlp"])
def test_pack_spec_matches_make_grid_spec(mlp):
  """The spec the kernel receives at the zip MLPs' full widths, field by
  field, against JAX's make_grid_spec: float32 scales, the stride base,
  rows, dense or hashed, the backward's design per level, offsets."""
  c, res = {"prop_mlp_0": (1, 512), "prop_mlp_1": (1, 2048),
            "nerf_mlp": (4, 8192)}[mlp]
  spec = hashgrid.make_grid_spec(10, c, 16, res, 21)
  jspec = jhashgrid.make_grid_spec(10, c, 16, res, 21)
  assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
  s = he.pack_spec(spec)
  n = jspec.num_levels
  assert (s.num_levels, s.channels) == (n, c)
  np.testing.assert_array_equal(np.array(s.scale[:n], np.float32),
                                np.array(jspec.scales, np.float32))
  assert list(s.res1[:n]) == [r + 1 for r in jspec.resolutions]
  assert list(s.size[:n]) == list(jspec.sizes)
  assert list(s.offset[:n + 1]) == list(jspec.offsets)
  assert [bool(d) for d in s.dense[:n]] == [
      (r + 1) ** 3 <= z for r, z in zip(jspec.resolutions, jspec.sizes)]
  assert [bool(v) for v in s.shared[:n]] == [
      hash_ops.scatter_variant(z, c) == "shared" for z in jspec.sizes]


def test_pack_spec_and_wrappers_check_their_inputs():
  with pytest.raises(ValueError):
    he.pack_spec(hashgrid.make_grid_spec(17, 1, 16, 512, 12))
  with pytest.raises(ValueError):
    he.pack_spec(hashgrid.make_grid_spec(2, 9, 16, 64, 12))
  spec = _spec(2)
  table = torch.zeros(spec.total_rows, 2)
  x = torch.rand(5, 3)
  with pytest.raises(ValueError):
    he.hash_encode_fwd(x, table[1:], spec)
  with pytest.raises(ValueError):
    he.hash_encode_fwd(x[:, :2], table, spec)
  with pytest.raises(ValueError):
    he.hash_encode_bwd(x, table, torch.zeros(5, spec.num_levels, 3), spec,
                       False)
  # neither CPU nor CUDA: no plain fallback, the wrappers raise
  with pytest.raises(ValueError):
    he.hash_encode_fwd(x.to("meta"), table.to("meta"), spec)


def test_table_only_backward_gives_no_dx():
  spec, table, x, cot = _inputs(30, 1, shape=(50,), lo=0.0, hi=1.0)
  tt = torch.tensor(table, requires_grad=True)
  tx = torch.from_numpy(x)
  (hashgrid.hash_encode(tx, tt, spec) * torch.from_numpy(cot)).sum().backward()
  want, dx = he.hash_encode_bwd_plain(tx, tt.detach(), torch.from_numpy(cot),
                                      spec, False)
  assert dx is None and tx.grad is None
  assert torch.equal(tt.grad, want)


def test_zip_model_default_encode_equals_plain_on_cpu():
  """ZipNerfModel's default encode_fn (the fused encode) against the model
  built with the plain encode: the same density MLP outputs of every MLP
  bit for bit, the table
  gradients within 1e-6 of their max (index_add_ against PyTorch's
  indexing backward)."""
  config = ZipNerfConfig(num_prop_samples=(4, 4), num_nerf_samples=4,
                         prop_grid_resolutions=(32, 64),
                         nerf_grid_resolution=128, grid_num_levels=3,
                         grid_log2_hashmap_size=13, bottleneck_width=16,
                         net_width_viewdirs=8, sample_n=3)
  fused = zip_init_(ZipNerfModel(config, device="cpu"), seed=0,
                    table_scale=1e4)
  plain = ZipNerfModel(config, encode_fn=hashgrid.hash_encode_plain,
                       device="cpu")
  plain.load_state_dict(fused.state_dict())
  assert fused.nerf_mlp.encoder.encode_fn is hashgrid.hash_encode
  rng = np.random.RandomState(5)
  means = torch.tensor(rng.uniform(-1.5, 1.5, (16, 3, 3)), dtype=torch.float32)
  stds = torch.tensor(rng.uniform(0.01, 0.1, (16, 3)), dtype=torch.float32)
  outs = {}
  for name, model in (("fused", fused), ("plain", plain)):
    outs[name] = [mlp.predict_density(means, stds) for mlp in model.mlps()]
    sum(d.sum() + x.sum() for d, x in outs[name]).backward()
  for (df, xf), (dp, xp) in zip(outs["fused"], outs["plain"]):
    assert torch.equal(df, dp) and torch.equal(xf, xp)
  for mf, mp in zip(fused.mlps(), plain.mlps()):
    gf, gp = mf.encoder.embeddings.grad, mp.encoder.embeddings.grad
    assert gp.abs().max() > 0
    np.testing.assert_allclose(gf.numpy(), gp.numpy(),
                               atol=1e-6 * float(gp.abs().max()), rtol=0)
