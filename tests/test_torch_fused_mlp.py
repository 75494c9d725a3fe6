"""snerf_tpu_torch.ops.fused_mlp on the CPU against the JAX Pallas kernel.

The CUDA kernel itself runs only on the card; `python3 chip_smoke.py`
holds it against `fused_mlp_plain` there. Here the plain version, which
the CPU wrapper runs, is held against the Pallas kernel in interpret
mode (as tests/test_zipnerf.py runs it). Tolerance atol 1e-4 / rtol 1e-4:
both are float32 matmuls with other summation orders, at D = 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from snerf_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

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
