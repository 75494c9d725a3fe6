"""The port's integrated CP encoder (snerf_tpu_torch/models/cpgrid.py)
against snerf_tpu/models/cpgrid.py on the same numpy-seeded tables and
inputs: the features, and the gradients of a seeded projection of them
into every table and into the positions and stds, with collapse on and
off, with pair factors, with the bounded tables, with a level window and
with per-axis stds.

Tolerances, float32 on the CPU on both sides: features within 1e-5 of
their max (the exp of the profile and the [rows, R] x [R, F] matmuls
round differently in XLA and ATen); gradients within 1e-5 of their
tensor's max. The row-chunked, checkpointed encode against the same
encode in one chunk: features and gradients within 1e-6 of their max
(rows are independent; only the table gradient's sum over chunks is
ordered differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models import cpgrid as jcp
from snerf_tpu_torch.models import cpgrid

TOL = 1e-5
LEVELS = dict(num_levels=3, level_dim=4, base_resolution=8,
              max_resolution=32)
CASES = {
    "multisample": dict(collapse=False),
    "collapse": dict(collapse=True),
    "pairs": dict(collapse=True, pair_dim=2),
    "bounded": dict(collapse=False, factor_bound=0.3),
    "window": dict(collapse=True, window=True, feature_center=True,
                   feature_scale=0.5),
    "per-axis stds": dict(collapse=False, per_axis=True),
    "per-axis collapse": dict(collapse=True, per_axis=True, pair_dim=3),
}


def _inputs(case, seed=0, rows=(5, 7), n=3):
  rng = np.random.RandomState(seed)
  module = {k: case[k] for k in ("pair_dim", "factor_bound",
                                 "feature_center", "feature_scale")
            if k in case}
  res = cpgrid.level_resolutions(LEVELS["num_levels"],
                                 LEVELS["base_resolution"],
                                 LEVELS["max_resolution"])
  params = {}
  # tables drawn as the JAX init draws them, at twice its spread: around
  # 1, or the raw tables around 0 under factor_bound
  base = 0.0 if case.get("factor_bound") else 1.0
  for l, r in enumerate(res):
    params[f"v{l}"] = (base + 0.2 * rng.normal(
        size=(3, r, LEVELS["level_dim"]))).astype(np.float32)
    if case.get("pair_dim"):
      params[f"p{l}"] = (1 + 0.2 * rng.normal(
          size=(3, r, case["pair_dim"]))).astype(np.float32)
  x01 = rng.uniform(0.05, 0.95, size=(*rows, n, 3)).astype(np.float32)
  std_shape = (*rows, n, 3) if case.get("per_axis") else (*rows, n)
  std01 = rng.uniform(0.002, 0.05, size=std_shape).astype(np.float32)
  window = (np.asarray([1.0, 0.6, 0.1], np.float32) if case.get("window")
            else None)
  return module, params, x01, std01, window


def _jax(module, params, x01, std01, window, collapse, g):
  enc = jcp.CPEncoding(**LEVELS, **module)

  def f(p, x, s):
    out = enc.apply({"params": p}, x, s,
                    level_window=None if window is None
                    else jnp.asarray(window), collapse=collapse)
    return jnp.sum(out * g), out

  (_, out), grads = jax.jit(jax.value_and_grad(
      f, argnums=(0, 1, 2), has_aux=True))(params, x01, std01)
  return jax.tree_util.tree_map(np.asarray, (out, grads))


def _torch(module, params, x01, std01, window, collapse, g):
  enc = cpgrid.CPEncoding(**LEVELS, **module, device="cpu")
  enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
  x = torch.from_numpy(x01).requires_grad_()
  s = torch.from_numpy(std01).requires_grad_()
  out = enc(x, s, level_window=None if window is None
            else torch.from_numpy(window), collapse=collapse)
  torch.sum(out * torch.from_numpy(g)).backward()
  grads = {k: p.grad.numpy() for k, p in enc.named_parameters()}
  return out.detach().numpy(), (grads, x.grad.numpy(), s.grad.numpy())


def _close(got, want, what, tol):
  err = float(np.abs(got - want).max())
  assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("name", CASES)
def test_cp_encoding_matches_jax(name):
  case = CASES[name]
  module, params, x01, std01, window = _inputs(case)
  width = LEVELS["num_levels"] * (LEVELS["level_dim"]
                                  + 3 * case.get("pair_dim", 0))
  g = np.random.RandomState(1).normal(size=(*x01.shape[:-2], width)).astype(
      np.float32)
  jout, (jp, jx, js) = _jax(module, params, x01, std01, window,
                            case["collapse"], g)
  out, (tp, tx, ts) = _torch(module, params, x01, std01, window,
                             case["collapse"], g)
  assert out.shape == jout.shape == (*x01.shape[:-2], width)
  _close(out, jout, "features", TOL)
  assert set(tp) == set(jp)
  for k in jp:
    _close(tp[k], jp[k], f"grad {k}", TOL)
  _close(tx, jx, "grad x01", TOL)
  _close(ts, js, "grad std01", TOL)


@pytest.mark.parametrize("name", ["multisample", "pairs"])
def test_chunked_level_encode_equals_one_chunk(name, monkeypatch):
  """CHUNK_ELEMS small enough for 3 rows a chunk at R = 32 (and more at
  the coarser levels) against one chunk for all 35 rows."""
  case = CASES[name]
  module, params, x01, std01, window = _inputs(case, seed=2)
  width = LEVELS["num_levels"] * (LEVELS["level_dim"]
                                  + 3 * case.get("pair_dim", 0))
  g = np.random.RandomState(3).normal(size=(*x01.shape[:-2], width)).astype(
      np.float32)
  whole = _torch(module, params, x01, std01, window, case["collapse"], g)
  monkeypatch.setattr(cpgrid, "CHUNK_ELEMS", 3 * 32)
  chunked = _torch(module, params, x01, std01, window, case["collapse"], g)
  _close(chunked[0], whole[0], "features", 1e-6)
  for k in whole[1][0]:
    _close(chunked[1][0][k], whole[1][0][k], f"grad {k}", 1e-6)
  _close(chunked[1][1], whole[1][1], "grad x01", 1e-6)
  _close(chunked[1][2], whole[1][2], "grad std01", 1e-6)


def test_checkpoint_keeps_only_the_level_inputs():
  """Under autograd a level saves its inputs and no [rows, R] profile:
  the tensors the graph keeps are those of the level's inputs' sizes."""
  module, params, x01, std01, _ = _inputs(CASES["collapse"], seed=4,
                                          rows=(64,))
  enc = cpgrid.CPEncoding(**LEVELS, device="cpu")
  enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
  sizes = []

  def pack(t):
    sizes.append(t.numel())
    return t

  with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
    enc(torch.from_numpy(x01), torch.from_numpy(std01), collapse=True)
  r_max = enc.resolutions[-1]
  assert sizes and max(sizes) < 64 * r_max


def test_resolutions_and_window_match_jax():
  for args in ((4, 128, 1024), (3, 128, 1024), (1, 64, 2048), (5, 16, 512)):
    assert cpgrid.level_resolutions(*args) == list(jcp.level_resolutions(
        *args))
  for alpha in (0.0, 0.3, 1.7, 4.0):
    np.testing.assert_allclose(
        cpgrid.cosine_window(torch.tensor(alpha), 4).numpy(),
        np.asarray(jcp.cosine_window(jnp.float32(alpha), 4)), rtol=0,
        atol=1e-7)


def test_init_blur_matches_jax():
  """The init_smooth blur of a table's noise: the JAX init's depthwise
  jnp.convolve(mode="same") and renormalisation, on the same noise."""
  noise = np.random.RandomState(5).normal(size=(3, 40, 6)).astype(np.float32)
  sigma = 1.5
  rad = max(1, int(round(3 * sigma)))
  t = jnp.arange(-rad, rad + 1, dtype=jnp.float32)
  k = jnp.exp(-0.5 * (t / sigma) ** 2)
  k = k / k.sum()
  sm = jax.vmap(lambda m: jax.vmap(lambda col: jnp.convolve(col, k,
                                                            mode="same"),
                                   in_axes=1, out_axes=1)(m))(noise)
  want = np.asarray(sm / (jnp.std(sm) + 1e-12))
  got = cpgrid._blur_rows(torch.from_numpy(noise), sigma).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_reset_parameters_draws_as_jax():
  """Tables around 1 with init_scale spread, or the raw noise under
  factor_bound, from the seeded CPU generator."""
  enc = cpgrid.CPEncoding(**LEVELS, pair_dim=2, device="cpu")
  enc.reset_parameters(torch.Generator().manual_seed(0))
  v = torch.cat([t.detach().reshape(-1)
                 for t in enc.tables("v") + enc.tables("p")])
  assert abs(float(v.mean()) - 1.0) < 0.01
  assert abs(float(v.std()) - 0.1) < 0.01
  bounded = cpgrid.CPEncoding(**LEVELS, factor_bound=0.5, init_smooth=1.0,
                              device="cpu")
  bounded.reset_parameters(torch.Generator().manual_seed(0))
  for t in bounded.tables("v"):
    t = t.detach()
    assert abs(float(t.mean())) < 0.05
    assert abs(float(t.std()) - 0.1) < 0.02
