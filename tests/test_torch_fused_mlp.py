"""snerf_tpu_torch.ops.fused_mlp on the CPU against the JAX Pallas kernel.

The CUDA kernels themselves run only on the card; `python3 chip_smoke.py`
holds them against `fused_mlp_plain` and `fused_mlp_bwd_plain` there.
Here the plain versions, which the CPU wrapper and the CPU autograd path
run, are held against the Pallas kernel in interpret mode and its custom
VJP under jax.grad (as tests/test_zipnerf.py runs it). Tolerance atol
1e-4 / rtol 1e-4: both are float32 matmuls with other summation orders,
at D = 256 (the backward's sums over N = 300 rows included). The bf16
forms are held against JAX in tests/test_torch_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from snerf_tpu_torch.ops.fused_mlp import (FusedMLPFunction, fused_mlp,
                                           fused_mlp_bwd_plain,
                                           fused_mlp_plain, tf32_split,
                                           tf32_split_plain, wgrad_splits)

N, D = 300, 256  # N is ragged against the Pallas tile of 128


def _inputs(n_layers, seed=0):
  rng = np.random.RandomState(seed)
  x = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
  limit = np.sqrt(6.0 / (2 * D))
  w = rng.uniform(-limit, limit, (n_layers, D, D)).astype(np.float32)
  b = rng.uniform(-0.1, 0.1, (n_layers, 1, D)).astype(np.float32)
  return x, w, b


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("last_relu", [True, False])
def test_plain_matches_pallas_interpret(n_layers, last_relu):
  x, w, b = _inputs(n_layers)
  want = np.asarray(jax_fused_mlp(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 128, last_relu, True))
  got = fused_mlp_plain(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), last_relu).numpy()
  np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
  if not last_relu:
    assert (got < 0).any()


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
  x, w, b = (torch.from_numpy(a) for a in _inputs(3, seed=1))
  out = fused_mlp(x, w, b, last_relu=True)
  assert fused_mlp.launches == 0
  torch.testing.assert_close(out, fused_mlp_plain(x, w, b, True),
                             atol=0, rtol=0)


def test_plain_casts_after_every_layer():
  """bf16 storage: each layer's f32 result is rounded to bf16 before the
  next layer reads it, as the TPU kernel does."""
  x, w, b = (torch.from_numpy(a) for a in _inputs(2, seed=2))
  xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
  h = torch.relu(xb.float() @ wb[0].float() + bb[0].float()).bfloat16()
  h = torch.relu(h.float() @ wb[1].float() + bb[1].float()).bfloat16()
  out = fused_mlp_plain(xb, wb, bb, True)
  assert out.dtype == torch.bfloat16
  torch.testing.assert_close(out, h, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["x_rank", "w_shape", "b_shape"])
def test_shape_checks(bad):
  x, w, b = (torch.from_numpy(a) for a in _inputs(2, seed=3))
  if bad == "x_rank":
    x = x[None]
  elif bad == "w_shape":
    w = w[:, :128]
  else:
    b = b[:, 0]
  with pytest.raises(ValueError):
    fused_mlp(x, w, b)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("last_relu", [True, False])
def test_backward_matches_jax_grad_of_pallas_interpret(n_layers, last_relu):
  """fused_mlp_bwd_plain (recomputing, and on saved layers) and autograd
  through the CPU path against jax.grad of the Pallas kernel's VJP."""
  x, w, b = _inputs(n_layers, seed=4)
  g = np.random.RandomState(5).normal(size=(N, D)).astype(np.float32)
  want = jax.grad(lambda x, w, b: jnp.sum(
      jax_fused_mlp(x, w, b, 128, last_relu, True) * g), argnums=(0, 1, 2))(
          jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
  tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
  layers = [fused_mlp_plain(tx, tw[:i + 1], tb[:i + 1],
                            last_relu or i < n_layers - 1)
            for i in range(n_layers)]
  for saved in (None, layers):
    got = fused_mlp_bwd_plain(tx, tw, tb, saved, torch.from_numpy(g),
                              last_relu)
    for gt, wt in zip(got, want):
      np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-4,
                                 rtol=1e-4)
  leaves = [t.clone().requires_grad_() for t in (tx, tw, tb)]
  (fused_mlp(*leaves, last_relu) * torch.from_numpy(g)).sum().backward()
  assert fused_mlp.launches == 0
  for leaf, wt in zip(leaves, want):
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wt), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("last_relu", [True, False])
def test_fused_mlp_function_gradcheck_float64(last_relu):
  gen = torch.Generator().manual_seed(6)
  x = torch.randn(12, 8, generator=gen, dtype=torch.float64)
  w = torch.randn(3, 8, 8, generator=gen, dtype=torch.float64) * 0.4
  b = torch.randn(3, 1, 8, generator=gen, dtype=torch.float64) * 0.1
  assert torch.autograd.gradcheck(
      lambda x, w, b: FusedMLPFunction.apply(x, w, b, last_relu),
      [t.requires_grad_() for t in (x, w, b)])


def test_bf16_under_autograd_raises():
  """bf16 under autograd, which raised before the bf16 trunks were
  ported, runs on the CPU plain path: the forward equals the eval
  forward, and the grads (bf16, in the leaves' dtypes) are
  fused_mlp_bwd_plain's on the layers the forward kept, bit for bit; no
  kernel launches. tests/test_torch_bf16.py holds them against JAX."""
  x, w, b = (torch.from_numpy(a).bfloat16() for a in _inputs(2, seed=7))
  g = torch.from_numpy(np.random.RandomState(8).normal(
      size=(N, D)).astype(np.float32)).bfloat16()
  leaves = [t.clone().requires_grad_() for t in (x, w, b)]
  out = fused_mlp(*leaves, True)
  out.backward(g)
  with torch.no_grad():   # the forward-only call
    assert torch.equal(out, fused_mlp(x, w, b, True))
  layers = [fused_mlp_plain(x, w[:1], b[:1], True), out.detach()]
  want = fused_mlp_bwd_plain(x, w, b, layers, g, True)
  for leaf, wt in zip(leaves, want):
    assert leaf.grad.dtype == torch.bfloat16
    assert torch.equal(leaf.grad, wt)
  assert fused_mlp.launches == 0


@pytest.mark.parametrize("n,d,want", [
    (4096 * 127, 1024, (15776, 33)),      # fine trunk: 33 x 64 = 16 waves
    (4096 * 127 + 5, 1024, (15776, 33)),  # ragged: the last split short
    (4096 * 128, 256, (2048, 256)),       # proposal: splits of >= 2,048
    (777, 256, (800, 1)),                 # small: one split
    (2 ** 30, 1024, (32537632, 33)),      # long N: longer splits
])
def test_wgrad_splits(n, d, want):
  """wgrad's split of N on a 132-SM card: splits cover N, each a multiple
  of 32 rows and at least 2,048 unless N is shorter, about 16 waves of
  one block per SM."""
  rows, splits = wgrad_splits(n, d, 132)
  assert (rows, splits) == want
  assert rows % 32 == 0 and splits * rows >= n > (splits - 1) * rows


@pytest.mark.parametrize("n,d,want", [
    (2 ** 21, 512, (2048, 1024)),    # cp_hash proposal: 8 tiles of 128 x 256
    (2 ** 20, 512, (2048, 512)),     # cp_hash nerf: splits of >= 2,048
    (4064 * 128, 1024, (2048, 254)),  # bench fine: 8 x 4 tiles
    (4096 * 128, 256, (2048, 256)),  # bench proposal: one 256-wide column
    (777, 256, (832, 1)),            # small: one split
    (65573, 512, (2048, 33)),        # ragged: the last split 37 rows
])
def test_wgrad_splits_bf16(n, d, want):
  """The bf16 wgrad's split: 64-row k-stages and 128 x 256 tiles, about 64
  waves of one block per SM, each split at least 2,048 rows unless N is
  shorter; the splits cover every row once, in order."""
  rows, splits = wgrad_splits(n, d, 132, torch.bfloat16)
  assert (rows, splits) == want
  assert rows % 64 == 0 and splits * rows >= n > (splits - 1) * rows
  covered = torch.zeros(n, dtype=torch.int32)
  for s in range(splits):
    covered[s * rows:min(n, (s + 1) * rows)] += 1
  assert bool((covered == 1).all())


def _bits(*patterns):
  """float32 tensor of the given 32-bit patterns."""
  return torch.tensor([p - 2 ** 32 if p >= 2 ** 31 else p for p in patterns],
                      dtype=torch.int64).to(torch.int32).view(torch.float32)


def _hex(t):
  return [p & 0xFFFFFFFF for p in t.view(torch.int32).tolist()]


def _spread(seed=8):
  """float32 values over 2^-30 .. 2^30 in magnitude, both signs."""
  rng = np.random.RandomState(seed)
  v = rng.normal(size=4096) * np.exp2(rng.uniform(-30, 30, 4096))
  return torch.from_numpy(v.astype(np.float32))


def test_tf32_split_big_has_low_13_bits_clear():
  big, small = tf32_split_plain(_spread())
  assert all(p & 0x1FFF == 0 for p in _hex(big))
  assert all(p & 0x1FFF == 0 for p in _hex(small))


def test_tf32_split_sum_within_2_to_minus_22():
  w = _spread(9)
  big, small = tf32_split_plain(w)
  rel = ((big.double() + small.double() - w.double()).abs()
         / w.double().abs()).max()
  assert float(rel) <= 2.0 ** -22, float(rel)


@pytest.mark.parametrize("w,want", [
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # the same below zero
    (0x3F803000, 0x3F804000),   # 1 + 3 * 2^-11: a tie, away (not to even)
    (0x3F800FFF, 0x3F800000),   # below the tie: down
    (0x3F801001, 0x3F802000),   # above the tie: up
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x7F7FF000, 0x7F800000),   # the largest tie carries into inf
])
def test_tf32_split_rounds_ties_away_from_zero(w, want):
  big, _ = tf32_split_plain(_bits(w))
  assert _hex(big) == [want]


def test_tf32_split_signed_zeros_and_inf_pass():
  w = _bits(0x00000000, 0x80000000, 0x7F800000, 0xFF800000)
  big, small = tf32_split_plain(w)
  assert _hex(big) == _hex(w)
  assert _hex(small)[:2] == [0x00000000, 0x00000000]


def test_tf32_split_plain_repeats_the_cards_specials():
  """Subnormals and NaN as `cvt.rna.tf32.f32` gave them on an H100 80GB
  HBM3 (chip_smoke.py's bit-equal phase holds them there): a NaN is
  truncated, not rounded, and a NaN of the subtraction is 0x7fffffff."""
  w = _bits(0x7FC00000, 0x7F800001, 0xFFC00000, 0x7FFFFFFF, 0x00003000,
            0x807FF000, 0x00000001, 0x7F800000)
  big, small = tf32_split_plain(w)
  assert _hex(big) == [0x7FC00000, 0x7F800000, 0xFFC00000, 0x7FFFE000,
                       0x00004000, 0x80800000, 0x00000000, 0x7F800000]
  assert _hex(small) == [0x7FFFE000] * 4 + [0x80002000, 0x00002000,
                                             0x00000000, 0x7FFFE000]


def test_tf32_split_cpu_layouts_and_no_launch():
  w = torch.from_numpy(_inputs(3, seed=10)[1])
  big, small, big_t, small_t = tf32_split(w)
  assert tf32_split.launches == 0
  want = tf32_split_plain(w)
  assert torch.equal(big, want[0]) and torch.equal(small, want[1])
  assert torch.equal(big_t, want[0].transpose(1, 2))
  assert torch.equal(small_t, want[1].transpose(1, 2))
  unkept = tf32_split(w, keep=False)
  assert unkept[:2] == (None, None)
  assert torch.equal(unkept[2], big_t) and torch.equal(unkept[3], small_t)


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("last_relu", [True, False])
def test_3xtf32_emulation_matches_pallas_interpret(n_layers, last_relu):
  """The kernels' arithmetic with IEEE f32 sums: every layer's activation
  and weight split by tf32_split_plain, a_big w_big + a_big w_small +
  a_small w_big in f32, against the Pallas kernel within the f32
  tolerance: the dropped small x small term does not show."""
  x, w, b = _inputs(n_layers, seed=11)
  want = np.asarray(jax_fused_mlp(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 128, last_relu, True))
  h = torch.from_numpy(x)
  wb, ws = tf32_split_plain(torch.from_numpy(w))
  for i in range(n_layers):
    hb, hs = tf32_split_plain(h)
    z = hb @ ws[i] + hs @ wb[i] + hb @ wb[i] + torch.from_numpy(b[i])
    h = torch.relu(z) if i < n_layers - 1 or last_relu else z
  np.testing.assert_allclose(h.numpy(), want, atol=1e-4, rtol=1e-4)
