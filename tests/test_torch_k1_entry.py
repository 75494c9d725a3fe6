"""K1 runs that open with an entry layer (snerf_tpu_torch/ops/fused_mlp.py,
models/mlp.py `_run_trunk`) on the CPU: the plain forward and backward
with a [K, D] first layer against a chain of F.linear + ReLU at the
shipped trunks' widths, autograd through the CPU path, and which runs the
trunk runner forms for the mip and cp_hash MLPs in float32 and bfloat16.
The CUDA kernels run only on the card: `chip_smoke.py` phase 7d holds
them against float64 there. Torch only (no JAX).
"""

import os

import pytest
import torch
from torch.nn import functional as F

from snerf_tpu_torch.config import load_config, model_config, zip_model_config
from snerf_tpu_torch.models import mlp
from snerf_tpu_torch.models.mlp import DenseBlock, NerfMLP, ProposalMLP
from snerf_tpu_torch.models.zipnerf import ZipNerfModel
from snerf_tpu_torch.ops.fused_mlp import (FusedMLPFunction, fused_mlp,
                                           fused_mlp_bwd_plain,
                                           fused_mlp_plain)
from snerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 37  # rows, ragged against any tile
# (K, D) of every entry layer the shipped f32 paths run on K1: the mip
# fine trunk's layers.0 and skip-cat layers.5, its proposal's layers.0;
# the cp_hash nerf trunk's ipe_0 and ipe_5, its proposals' ipe_0 and ipe_5
CELL_ENTRIES = [(96, 1024), (1120, 1024), (96, 256), (356, 512), (868, 512),
                (120, 512), (632, 512)]


def _run(k, d, n_sq, seed, dtype=torch.float32):
  gen = torch.Generator().manual_seed(seed)
  x = torch.randn(N, k, generator=gen, dtype=dtype) * 0.5
  w_in = (torch.rand(k, d, generator=gen, dtype=dtype) * 2 - 1) * (
      6.0 / (k + d)) ** 0.5
  w = (torch.rand(n_sq, d, d, generator=gen, dtype=dtype) * 2 - 1) * (
      6.0 / (2 * d)) ** 0.5
  b = (torch.rand(n_sq + 1, 1, d, generator=gen, dtype=dtype) * 2 - 1) * 0.1
  return x, w_in, w, b


def _chain(x, w_in, w, b):
  """F.linear + ReLU, layer by layer, as the library layers ran."""
  h = F.relu(F.linear(x, w_in.t(), b[0, 0]))
  for i in range(w.shape[0]):
    h = F.relu(F.linear(h, w[i].t(), b[i + 1, 0]))
  return h


@pytest.mark.parametrize("k,d", CELL_ENTRIES)
def test_entry_layer_plain_against_linear_chain(k, d):
  """fused_mlp_plain and fused_mlp_bwd_plain with a [K, D] first layer and
  two square layers after it against autograd through the F.linear +
  ReLU chain: the forward, dx, dW_in, the square layers' dW and every db
  (float32 matmuls in other summation orders: 1e-4 of each tensor's
  largest value); and autograd through the CPU path of fused_mlp gives
  the same grads as fused_mlp_bwd_plain."""
  x, w_in, w, b = _run(k, d, 2, seed=k + d)
  g = torch.randn(N, d, generator=torch.Generator().manual_seed(k))
  out = fused_mlp_plain(x, w, b, True, w_in)
  leaves = [t.clone().requires_grad_() for t in (x, w_in, w, b)]
  want = _chain(*leaves)
  (want * g).sum().backward()
  close = lambda a, e: torch.testing.assert_close(
      a, e, atol=1e-4 * float(e.abs().max()), rtol=0)
  close(out, want.detach())
  dx, dw, db, dw_in = fused_mlp_bwd_plain(x, w, b, None, g, True, w_in)
  assert dx.shape == (N, k) and dw_in.shape == (k, d)
  for got, leaf in zip((dx, dw_in, dw, db), leaves):
    close(got, leaf.grad)
  tracked = [t.clone().requires_grad_() for t in (x, w, b, w_in)]
  (fused_mlp(*tracked[:3], True, w_in=tracked[3]) * g).sum().backward()
  assert fused_mlp.launches == 0
  for got, want_grad in zip((t.grad for t in tracked), (dx, dw, db, dw_in)):
    torch.testing.assert_close(got, want_grad, atol=0, rtol=0)


@pytest.mark.parametrize("n_sq", [0, 2])
@pytest.mark.parametrize("last_relu", [True, False])
def test_entry_layer_gradcheck_float64(n_sq, last_relu):
  """FusedMLPFunction's CPU path with an entry layer, alone or before
  square layers, under gradcheck: dx, dW_in, dW and db."""
  x, w_in, w, b = _run(12, 8, n_sq, seed=3, dtype=torch.float64)
  x = x[:9]
  assert torch.autograd.gradcheck(
      lambda x, w, b, w_in: FusedMLPFunction.apply(x, w, b, last_relu, w_in),
      [t.requires_grad_() for t in (x, w, b, w_in)])


def test_entry_layer_shape_checks():
  x, w_in, w, b = _run(20, 16, 1, seed=4)
  for bad in ((x[:, :8], w, b, w_in), (x, w, b[:1], w_in),
              (x, w[:, :8], b, w_in)):
    with pytest.raises(ValueError):
      fused_mlp(bad[0], bad[1], bad[2], True, w_in=bad[3])


class Recorder:
  """A stack_fn that records each run it is given, (K, entry layer's
  shape or None, square layers, dtype), and runs it plainly."""

  def __init__(self):
    self.runs = []

  def __call__(self, x, w, b, last_relu=True, w_in=None):
    self.runs.append((x.shape[-1], None if w_in is None else tuple(w_in.shape),
                      w.shape[0], x.dtype))
    return fused_mlp_plain(x, w, b, last_relu, w_in)


def _mip_mlps(dtype, stack_fn):
  c = model_config(load_config(["--config", os.path.join(
      REPO, "configs", "nuScenes_depth_6cams")]))
  enc = 2 * 3 * (c.max_deg_point - c.min_deg_point)
  cond = 3 + 2 * 3 * c.deg_view
  torch.manual_seed(0)
  nerf = NerfMLP(enc, cond, net_width=c.hidden_layer,
                 condition_depth=c.rgb_layer, stack_fn=stack_fn,
                 compute_dtype=dtype, device="cpu")
  prop = ProposalMLP(enc, net_width=c.proposal_hidden_layer,
                     stack_fn=stack_fn, compute_dtype=dtype, device="cpu")
  return nerf, prop, enc, cond


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_run_trunk_forms_the_mip_runs(dtype):
  """configs/nuScenes_depth_6cams' MLPs: in float32 the fine trunk runs as
  layers.0..4 (entry 96 -> 1024) and layers.5..7 (entry 1120 -> 1024),
  the proposal as layers.0..3 (entry 96 -> 256) and the bottleneck alone;
  in bfloat16 the entry layers and the bottleneck stay on the library and
  the runs are the square ones (layers.1..4, 6..7; the proposal's 1..3)."""
  rec = Recorder()
  nerf, prop, enc, cond = _mip_mlps(dtype, rec)
  x = torch.randn(2, 3, enc)
  with torch.no_grad():
    nerf(x, torch.randn(2, cond))
    prop(x)
  if dtype == torch.float32:
    want = [(96, (96, 1024), 4, dtype), (1120, (1120, 1024), 2, dtype),
            (1024, None, 1, dtype), (96, (96, 256), 3, dtype)]
  else:
    want = [(1024, None, 4, dtype), (1024, None, 2, dtype),
            (256, None, 3, dtype)]
  assert rec.runs == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_run_trunk_forms_the_cp_hash_runs(dtype):
  """configs/waymo_zipnerf_tpu's trunks (ipe_0..7 with a skip-cat after
  ipe_4, then density_hidden): in float32 (the render path) each runs as
  ipe_0..4 and ipe_5..7 + density_hidden, both opened by their entry
  layer (nerf 356 and 868 -> 512, proposals 120 and 632 -> 512); in
  bfloat16 (training as shipped) ipe_0 and ipe_5 stay on the library."""
  c = zip_model_config(load_config(["--config", os.path.join(
      REPO, "configs", "waymo_zipnerf_tpu")]))
  rec = Recorder()
  torch.manual_seed(0)
  model = ZipNerfModel(c, stack_fn=rec, device="cpu")
  entries = []
  for m in model.mlps():
    m.compute_dtype = dtype
    k = m.ipe_layers[0].linear.in_features
    entries.append(k)
    with torch.no_grad():
      m._trunk(torch.randn(5, k, dtype=dtype))
  assert entries == [120, 120, 356]
  want = []
  for k in entries:
    if dtype == torch.float32:
      want += [(k, (k, 512), 4, dtype), (512 + k, (512 + k, 512), 3, dtype)]
    else:
      want += [(512, None, 4, dtype), (512, None, 3, dtype)]
  assert rec.runs == want


@pytest.mark.parametrize("k,d", [(1051, 128), (98, 256), (96, 200)],
                         ids=["cond K 1051", "K 98", "D 200"])
def test_unaligned_layers_stay_on_the_library(k, d):
  """A layer of another width opens a run only where the kernel takes it:
  K a multiple of 4 (TMA's row stride; the mip cond layer's 1,051 is not)
  and D of 128. Otherwise it stays on F.linear and the run starts after
  it."""
  torch.manual_seed(1)
  blocks = [DenseBlock(k, d, device="cpu"), DenseBlock(d, d, device="cpu")]
  rec = Recorder()
  x = torch.randn(4, k)
  with torch.no_grad():
    got = mlp._run_trunk(blocks, x, rec)
    want = F.relu(blocks[1].linear(F.relu(blocks[0].linear(x))))
  assert rec.runs == [(d, None, 1, torch.float32)]
  torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_entry_runs_and_library_layers_are_counted():
  """The spans mark each K1 run that opens with an entry layer
  (snerf.k1.entry inside snerf.k1) and each hidden layer left to the
  library (snerf.mlp.dense): one mip fine MLP call at the shipped widths
  in float32 is 3 runs (2 with an entry layer) and 3 cond layers."""
  nerf, _, enc, cond = _mip_mlps(torch.float32, fused_mlp)
  x = torch.randn(1, 2, enc)
  with torch.no_grad(), torch.profiler.profile() as prof:
    with profiling.span("snerf.render.chunk"):
      nerf(x, torch.randn(1, cond))
  assert profiling.counts(prof.events())["spans_per_unit"] == {
      "snerf.encode.cp.fused": 0.0, "snerf.encode.cp.plain": 0.0,
      "snerf.k1": 3.0, "snerf.k1.entry": 2.0, "snerf.mlp.dense": 3.0}
