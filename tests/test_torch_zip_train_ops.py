"""The zip trainer's ops in snerf_tpu_torch against snerf_tpu on the same
numpy inputs: the distortion loss and the box blur of ops/stepfun.py, the
zip loss set of train/losses.py, `hash_decay_loss`, the scatter-add and
the gradient of the hash gather (kernel K2's CPU path), and the hash
encoder's gradients.

Tolerances: both sides run float32 on the CPU. Elementwise formulas and
sums over a few dozen terms agree to 1e-6 relative, with atol 1e-6 on
O(1) values; the cumulative sums of the blur and the integrals differ in
order (XLA's associative scan, torch's running sum), 1e-5 there. A
scatter-add over the same float32 rows in another order: 1e-6 of the
largest row; a blend's gradient 1e-5. The gradcheck runs in float64 at
its default tolerances. The stable argsort of the blur is checked
equal on tied knots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models import hashgrid as jhashgrid
from snerf_tpu.ops import hash_ops as jhash_ops
from snerf_tpu.ops import stepfun as jstepfun
from snerf_tpu.ops.pallas.hash_gather_dense import hash_gather_dense
from snerf_tpu.train import losses as jlosses
from snerf_tpu_torch.models import hashgrid
from snerf_tpu_torch.ops import hash_ops, stepfun
from snerf_tpu_torch.train import losses


def T(x, grad=False):
  return torch.tensor(np.array(x), requires_grad=grad)


def close(got, want, atol=1e-6, rtol=1e-6):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=atol, rtol=rtol)


def step_function(rng, batch=(6, 5), n=24, plateaus=True):
  """Sorted knots t [..., n+1] in [0, 1] and weights w [..., n] summing to
  1, with a zero-width interval and zero weights mixed in (plateaus)."""
  t = np.sort(rng.uniform(0, 1, batch + (n + 1,)), axis=-1)
  t[..., 0], t[..., -1] = 0.0, 1.0
  w = rng.uniform(0, 1, batch + (n,))
  if plateaus:
    t[..., 5] = t[..., 4]
    w[..., 7:10] = 0.0
  w /= w.sum(-1, keepdims=True)
  return t.astype(np.float32), w.astype(np.float32)


# --- stepfun ----------------------------------------------------------------


def test_lossfun_distortion_matches_jax():
  t, w = step_function(np.random.RandomState(0))
  close(stepfun.lossfun_distortion(T(t), T(w)),
        jstepfun.lossfun_distortion(t, w))


@pytest.mark.parametrize("ties", [False, True])
def test_blur_stepfun_matches_jax(ties):
  """With ties: knots 2r apart, so x_i + r == x_(i+1) - r, which only a
  stable argsort orders as JAX does."""
  rng = np.random.RandomState(1)
  r = 0.03
  if ties:
    x = np.broadcast_to(np.arange(12, dtype=np.float32) * 2 * r,
                        (4, 12)).copy()
  else:
    x, _ = step_function(rng, batch=(4,), n=11)
  y = rng.uniform(0, 3, x.shape[:-1] + (x.shape[-1] - 1,)).astype(np.float32)
  got_x, got_y = stepfun.blur_stepfun(T(x), T(y), r)
  want_x, want_y = jstepfun.blur_stepfun(x, y, r)
  close(got_x, want_x, atol=0, rtol=0)
  close(got_y, want_y, atol=1e-5, rtol=1e-5)
  if ties:
    knots = np.concatenate([x - r, x + r], -1)
    assert len(np.unique(knots[0])) < knots.shape[-1]


# --- losses -----------------------------------------------------------------


def test_integrate_pwl_matches_jax():
  rng = np.random.RandomState(2)
  x = np.sort(rng.uniform(-0.1, 1.1, (6, 20)), -1).astype(np.float32)
  y = rng.uniform(0, 2, (6, 20)).astype(np.float32)
  t, _ = step_function(rng, batch=(6,), n=9)
  close(losses._integrate_pwl(T(x), T(y), T(t)),
        jlosses._integrate_pwl(x, y, t), atol=1e-5, rtol=1e-5)


def test_charbonnier_and_distortion_match_jax():
  rng = np.random.RandomState(3)
  pred, tgt = (rng.uniform(0, 1, (40, 3)).astype(np.float32) for _ in "ab")
  mask = rng.uniform(size=(40, 1)) > 0.3
  close(losses.charbonnier_loss(T(pred), T(tgt), T(mask), 0.001),
        jlosses.charbonnier_loss(pred, tgt, mask, 0.001))
  t, w = step_function(rng)
  close(losses.distortion_loss(T(t), T(w), 0.005),
        jlosses.distortion_loss(t, w, 0.005))


def test_interlevel_loss_anti_matches_jax_with_grad():
  """On histograms as the model makes them: increasing knots and positive
  weights (a zero proposal weight under a positive bound divides by
  float32 eps and amplifies any rounding 1e7-fold)."""
  rng = np.random.RandomState(4)
  s_nerf, w_nerf = step_function(rng, batch=(8,), n=16, plateaus=False)
  s_prop, w_prop = step_function(rng, batch=(8,), n=24, plateaus=False)
  wp = T(w_prop, grad=True)
  got = losses.interlevel_loss_anti(T(s_prop), wp, T(s_nerf), T(w_nerf),
                                    blur_r=0.03, weight=0.01)
  got.backward()
  f = lambda w: jlosses.interlevel_loss_anti(s_prop, w, s_nerf, w_nerf,
                                             blur_r=0.03, weight=0.01)
  want, want_grad = jax.value_and_grad(f)(w_prop)
  close(got, want, atol=1e-7, rtol=1e-5)
  close(wp.grad, want_grad, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_zip_smoothness_losses_match_jax(masked):
  rng = np.random.RandomState(5)
  rgb = rng.uniform(0, 1, (3, 4, 4, 3)).astype(np.float32)
  depth = rng.uniform(1, 5, (3, 4, 4)).astype(np.float32)
  sem = rng.uniform(0, 1, (3, 4, 4, 5)).astype(np.float32)
  sem /= sem.sum(-1, keepdims=True)
  valid = (rng.uniform(size=(3, 4, 4)) > 0.3) if masked else None
  tv = None if valid is None else T(valid)
  close(losses.zip_smooth_loss(T(rgb), T(depth), tv, weight=0.001),
        jlosses.zip_smooth_loss(rgb, depth, valid, weight=0.001))
  close(losses.zip_semantic_smooth_loss(T(rgb), T(sem), tv, weight=0.001),
        jlosses.zip_semantic_smooth_loss(rgb, sem, valid, weight=0.001))
  gx = np.abs(rng.normal(size=(3, 4, 3, 1))).astype(np.float32)
  gy = np.abs(rng.normal(size=(3, 3, 4, 1))).astype(np.float32)
  close(losses._edge_aware_masked(T(rgb), T(gx), T(gy), tv),
        jlosses._edge_aware_masked(rgb, gx, gy, valid))


# --- hash tables ------------------------------------------------------------

SPEC = dict(num_levels=4, level_dim=2, base_resolution=4,
            desired_resolution=64, log2_hashmap_size=10)


def test_hash_decay_loss_matches_jax_with_grad():
  spec = hashgrid.make_grid_spec(**SPEC)
  jspec = jhashgrid.make_grid_spec(**SPEC)
  table = np.random.RandomState(6).uniform(
      -1, 1, (spec.total_rows, 2)).astype(np.float32)
  tt = T(table, grad=True)
  got = hashgrid.hash_decay_loss(tt, spec, weight=0.1)
  got.backward()
  want, want_grad = jax.value_and_grad(
      lambda t: jhashgrid.hash_decay_loss(t, jspec, weight=0.1))(table)
  close(got, want)
  close(tt.grad, want_grad, atol=1e-9, rtol=1e-6)


def test_scatter_add_rows_plain_matches_jax():
  rng = np.random.RandomState(7)
  idx = rng.randint(0, 50, 3000).astype(np.int32)
  idx[:40] = 3                      # a hot row, as a dense level has
  g = rng.normal(size=(3000, 4)).astype(np.float32)
  got = hash_ops.scatter_add_rows_plain(T(idx), T(g), 50)
  want = np.asarray(jhash_ops.scatter_add_rows(idx, g, 50))
  close(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
  # the wrapper takes the plain pair for CPU tensors
  close(hash_ops.scatter_add_rows(T(idx), T(g), 50), got.numpy(), 0, 0)


def test_scatter_add_rows_checks():
  g = torch.zeros(5, 4)
  with pytest.raises(ValueError):
    hash_ops.scatter_add_rows(torch.zeros(5, dtype=torch.int64), g, 9)
  with pytest.raises(ValueError):
    hash_ops.scatter_add_rows(torch.zeros(4, dtype=torch.int32), g, 9)
  with pytest.raises(ValueError):
    hash_ops.scatter_add_rows(torch.zeros(5, dtype=torch.int32),
                              torch.zeros(5, 9), 9)
  # neither CPU nor CUDA: raises, never runs the plain version
  with pytest.raises(ValueError):
    hash_ops.scatter_add_rows(torch.zeros(5, dtype=torch.int32,
                                          device="meta"), g.to("meta"), 9)


# The zip step's 30 hash levels (make_grid_spec(10, C, 16, max_res, 21)
# of prop_mlp_0, prop_mlp_1 and the nerf MLP) and the scatter variant the
# host rule gives each: a shared-memory copy for the one-channel levels of
# at most 128 KB, warp aggregation for the rest.
_SCATTER_LEVELS = {
    "prop_mlp_0": (1, 512, ["shared"] * 2 + ["warp"] * 8),
    "prop_mlp_1": (1, 2048, ["shared"] * 2 + ["warp"] * 8),
    "nerf_mlp": (4, 8192, ["warp"] * 10),
}


@pytest.mark.parametrize("mlp,lvl", [(m, l) for m in _SCATTER_LEVELS
                                     for l in range(10)])
def test_scatter_variant_on_the_zip_steps_levels(mlp, lvl):
  from snerf_tpu_torch.models.hashgrid import make_grid_spec
  c, res, want = _SCATTER_LEVELS[mlp]
  rows = make_grid_spec(10, c, 16, res, 21).sizes[lvl]
  assert hash_ops.scatter_variant(rows, c) == want[lvl]


@pytest.mark.parametrize("rows,c,want", [
    (32768, 1, "shared"), (32769, 1, "warp"),        # 128 KB at C = 1
    (4920, 4, "warp"), (1, 2, "warp"),               # C > 1: never shared
    (8192, 2, "warp"), (2 ** 21, 1, "warp"),
    (1, 1, "shared"), (4920, 1, "shared"),
])
def test_scatter_variant_budget_edges(rows, c, want):
  assert hash_ops.scatter_variant(rows, c) == want


@pytest.mark.parametrize("rows,c", [(4920, 1), (35944, 4)])
def test_scatter_add_rows_cpu_at_each_variants_size(rows, c):
  """At a level size of each variant, CPU tensors run index_add_ and
  count no launch."""
  rng = np.random.RandomState(rows + c)
  idx = torch.from_numpy(rng.randint(0, rows, 4000).astype(np.int32))
  idx[:100] = 7                                   # a row many updates hit
  g = torch.from_numpy(rng.randn(4000, c).astype(np.float32))
  before = hash_ops.scatter_add_rows.launches
  got = hash_ops.scatter_add_rows(idx, g, rows)
  want = torch.zeros(rows, c).index_add_(0, idx.long(), g)
  assert torch.equal(got, want)
  assert hash_ops.scatter_add_rows.launches == before


@pytest.mark.parametrize("c", [1, 4])
def test_hash_gather_grad_matches_pallas_vjp(c):
  """The table gradient of HashGatherFunction (CPU: its kernels' plain
  versions) and of gather_rows_plain (PyTorch's indexing backward)
  against jax.grad through hash_gather_dense, the Pallas forward in
  interpret mode with its custom VJP; and gather_rows under autograd goes
  through it."""
  rng = np.random.RandomState(8 + c)
  rows = 300
  table = rng.normal(size=(rows, c)).astype(np.float32)
  idx = rng.randint(0, rows, 2048).astype(np.int32)
  idx[:64] = 0
  cot = rng.normal(size=(2048, c)).astype(np.float32)
  want = jax.grad(lambda t: jnp.sum(
      hash_gather_dense(t, jnp.asarray(idx), True) * cot))(table)
  for fn in (lambda t, i: hash_ops.HashGatherFunction.apply(t, i),
             hash_ops.gather_rows, hash_ops.gather_rows_plain):
    tt = T(table, grad=True)
    out = fn(tt, T(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (out * T(cot)).sum().backward()
    close(tt.grad, want, atol=1e-6 * float(np.abs(want).max()), rtol=0)
  with torch.no_grad():    # no autograd: the plain gather, no Function
    assert hash_ops.gather_rows(T(table, grad=True), T(idx)).grad_fn is None


def test_hash_gather_gradcheck_f64():
  rng = np.random.RandomState(9)
  table = torch.tensor(rng.normal(size=(12, 3)), dtype=torch.float64,
                       requires_grad=True)
  idx = torch.tensor(rng.randint(0, 12, (7, 8)), dtype=torch.int32)
  assert torch.autograd.gradcheck(
      lambda t: hash_ops.HashGatherFunction.apply(t, idx), (table,))
  assert torch.autograd.gradcheck(
      lambda t: hash_ops.gather_rows_plain(t, idx), (table,))


def test_hash_encode_grads_match_jax():
  """The encoder's gradients in the table and, as under pose refinement,
  in the positions (through the trilinear weights)."""
  spec = hashgrid.make_grid_spec(**SPEC)
  jspec = jhashgrid.make_grid_spec(**SPEC)
  rng = np.random.RandomState(10)
  table = rng.uniform(-1, 1, (spec.total_rows, 2)).astype(np.float32)
  x = rng.uniform(0.02, 0.98, (5, 7, 3)).astype(np.float32)
  cot = rng.normal(size=(5, 7, 4, 2)).astype(np.float32)
  tt, tx = T(table, grad=True), T(x, grad=True)
  got = hashgrid.hash_encode(tx, tt, spec)
  (got * T(cot)).sum().backward()
  (want, (gt, gx)) = jax.value_and_grad(
      lambda t, p: jnp.sum(jhashgrid.hash_encode(p, t, jspec) * cot),
      argnums=(0, 1))(table, x)
  close(got.detach(), jhashgrid.hash_encode(x, table, jspec), atol=1e-6)
  close(tt.grad, gt, atol=1e-5 * float(np.abs(gt).max()), rtol=0)
  close(tx.grad, gx, atol=1e-5 * float(np.abs(gx).max()), rtol=0)
