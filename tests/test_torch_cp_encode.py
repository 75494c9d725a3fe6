"""The CP level encode's kernel (ops/cp_encode.py, csrc/cp_encode.cu) and
its dispatch from models/cpgrid.py.

On the CPU: the dispatch rule, the spans that count which path each level
took, the table's fragment order, the window's exactness (the terms it
skips are exact float32 zeros of the plain version) and the fused path's
autograd glue, run with the wrappers' plain versions. Torch only (no JAX),
so the file runs on the card too, where the `card` cases hold the kernel
against the plain path on the same device, beside a fault reading (the
profile one node off) that each comparison must catch:

  python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cp_encode.py -q
"""

import math
import types

import numpy as np
import pytest
import torch

from snerf_tpu_torch.models import cpgrid
from snerf_tpu_torch.ops import cp_encode
from snerf_tpu_torch.utils import profiling

BF16 = torch.bfloat16
F32 = torch.float32


def _rows(m, n, r, seed, device="cpu"):
  """u, var [m, n, 3] as CPEncoding makes them: x01 in [0, 1], stds of
  1e-4 to 3e-2 (log-uniform) in [0, 1] units, the bump 0.75 grid cells."""
  rs = np.random.RandomState(seed)
  x01 = rs.uniform(0, 1, size=(m, n, 3))
  std01 = np.exp(rs.uniform(math.log(1e-4), math.log(3e-2), size=(m, n, 3)))
  u = x01 * (r - 1.0)
  sig = std01 * (r - 1.0)
  var = sig * sig + 0.75 ** 2
  return (torch.tensor(u, dtype=F32, device=device),
          torch.tensor(var, dtype=F32, device=device))


def _tables(r, f, f2, seed, device="cpu"):
  rs = np.random.RandomState(seed)
  v = torch.tensor(1 + 0.5 * rs.normal(size=(3, r, f)), dtype=F32,
                   device=device)
  p = (None if f2 == 0 else torch.tensor(
      1 + 0.5 * rs.normal(size=(3, r, f2)), dtype=F32, device=device))
  return v, p


# ---- the dispatch rule

@pytest.mark.parametrize("device, f, f2, dtype, pos, needs, want", [
    ("cuda", 64, 0, BF16, F32, False, True),
    ("cuda", 8, 0, F32, F32, False, True),
    ("cuda", 16, 8, BF16, F32, False, True),
    ("cpu", 64, 0, BF16, F32, False, False),
    ("cuda", 64, 0, BF16, F32, True, False),
    ("cuda", 12, 0, F32, F32, False, False),
    ("cuda", 24, 0, F32, F32, False, False),
    ("cuda", 64, 16, BF16, F32, False, False),
    ("cuda", 64, 0, torch.float16, F32, False, False),
    # the kernel reads u and var as float32
    ("cuda", 64, 0, BF16, BF16, False, False),
    ("cuda", 8, 0, F32, torch.float64, False, False),
    ("cuda", 8, 0, F32, None, False, False),
])
def test_dispatch_rule(device, f, f2, dtype, pos, needs, want):
  assert cp_encode.rule(device, f, f2, dtype, pos, needs) is want


def test_covers_asks_for_the_positions_gradient(monkeypatch):
  seen = []
  monkeypatch.setattr(cp_encode, "rule",
                      lambda *args: seen.append(args) or False)
  u, var = _rows(4, 1, 32, 0)
  v, _ = _tables(32, 8, 0, 1)
  cp_encode.covers(u, var, v, None, F32)
  cp_encode.covers(u.requires_grad_(True), var, v, None, F32)
  with torch.no_grad():
    cp_encode.covers(u, var, v, None, F32)
  assert seen == [("cpu", 8, 0, F32, F32, False),
                  ("cpu", 8, 0, F32, F32, True),
                  ("cpu", 8, 0, F32, F32, False)]


@pytest.mark.parametrize("u_dtype, var_dtype, want", [
    (F32, F32, F32), (BF16, BF16, BF16), (F32, torch.float64, None),
    (torch.float64, F32, None)])
def test_covers_passes_on_the_positions_dtype(monkeypatch, u_dtype,
                                              var_dtype, want):
  seen = []
  monkeypatch.setattr(cp_encode, "rule", lambda *args: seen.append(args[4]))
  u, var = _rows(4, 1, 32, 0)
  v, _ = _tables(32, 8, 0, 1)
  cp_encode.covers(u.to(u_dtype), var.to(var_dtype), v, None, F32)
  assert seen == [want]


@pytest.mark.parametrize("which", ["u", "var"])
def test_entry_points_refuse_positions_not_in_float32(which):
  u, var = _rows(20, 1, 32, 0)
  if which == "u":
    u = u.to(BF16)
  else:
    var = var.to(BF16)
  v, _ = _tables(32, 8, 0, 1)
  g = torch.randn(20, 8)
  with pytest.raises(ValueError, match="float32"):
    cp_encode.encode_fwd(u, var, v, 8, F32)
  with pytest.raises(ValueError, match="float32"):
    cp_encode.encode_bwd(u, var, v, 8, g, F32)


def test_cpu_levels_take_the_plain_path():
  enc = cpgrid.CPEncoding(num_levels=3, level_dim=8, base_resolution=16,
                          max_resolution=64, device="cpu")
  x = torch.rand(5, 1, 3)
  std = torch.full((5, 1), 0.01)
  with torch.profiler.profile() as prof:
    enc(x, std).sum().backward()
  names = [e.name for e in prof.events()]
  assert names.count("snerf.encode.cp.plain") == 3
  assert names.count("snerf.encode.cp.fused") == 0


# ---- the counter

def _ev(name, start, end):
  return types.SimpleNamespace(
      name=name, cpu_parent=None,
      time_range=types.SimpleNamespace(start=start, end=end))


def test_counts_tally_the_cp_level_paths():
  events = [_ev("snerf.train.step", 0, 100), _ev("snerf.train.step", 200, 300)]
  events += [_ev("snerf.encode.cp.fused", s, s + 5) for s in range(10, 60, 5)]
  events += [_ev("snerf.encode.cp.fused", s, s + 5)
             for s in range(210, 260, 5)]
  events += [_ev("snerf.encode.cp.plain", 270, 280),
             # outside any unit: not counted
             _ev("snerf.encode.cp.plain", 150, 160),
             _ev("snerf.encode.cp.fused", 400, 410)]
  got = profiling.counts(events)
  assert got["units"] == 2
  assert got["spans_per_unit"] == {"snerf.encode.cp.fused": 10.0,
                                   "snerf.encode.cp.plain": 0.5,
                                   "snerf.k1": 0.0, "snerf.k1.entry": 0.0,
                                   "snerf.mlp.dense": 0.0}
  assert profiling.counts([])["spans_per_unit"] == {
      "snerf.encode.cp.fused": 0.0, "snerf.encode.cp.plain": 0.0,
      "snerf.k1": 0.0, "snerf.k1.entry": 0.0, "snerf.mlp.dense": 0.0}


# ---- the table's fragment order and the window

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_table_fragments_in_lane_order(dtype):
  r, ft = 37, 24
  table = torch.randn(3, r, ft).to(dtype)
  frag = cp_encode.table_fragments(table)
  ks = (r + 15) // 16
  width = 4 if dtype == BF16 else 8
  assert frag.shape == (3, ks, ft // 8, 32, width)
  kcol = cp_encode._kcol(dtype == BF16)
  for a in range(3):
    for s in range(ks):
      for c in range(ft // 8):
        for lane in range(32):
          for j in range(4):
            node = 16 * s + int(kcol[lane % 4, j])
            want = (table[a, node, 8 * c + lane // 4].float() if node < r
                    else torch.tensor(0.0))
            got = frag[a, s, c, lane, j].float()
            if dtype == F32:
              # big + small: float32 to ~2^-22
              got = got + frag[a, s, c, lane, 4 + j]
              assert abs(float(got - want)) <= 2 ** -21 * abs(float(want))
            else:
              assert float(got) == float(want)


def test_window_skips_only_exact_zeros():
  """Every node outside [ceil(u - h), floor(u + h)], h = sqrt(WINDOW var),
  the kernel's window, has a float32 exp(-0.5 d d / var) of exactly 0 as
  the plain version computes it; the plain exp is still nonzero at an
  exponent of -100, well inside the window."""
  u, var = _rows(2000, 1, 1024, 5)
  u, var = u.reshape(-1), var.reshape(-1)
  h = torch.sqrt(cp_encode.WINDOW * var)
  for step in range(3):
    for node in (torch.ceil(u - h) - 1 - step, torch.floor(u + h) + 1 + step):
      d = u - node
      assert torch.all(torch.exp(-0.5 * d * d / var) == 0)
  d = torch.sqrt(2 * 100.0 * var)
  assert torch.all(torch.exp(-0.5 * d * d / var) > 0)
  assert torch.all(d < h)


# ---- the fused path's autograd glue, on the wrappers' plain versions

@pytest.mark.parametrize("dtype, f2, n, bound", [
    (F32, 0, 1, 0.0), (F32, 8, 7, 0.5), (BF16, 0, 1, 0.5), (BF16, 8, 3, 0.0)])
def test_fused_glue_matches_the_chunked_path(monkeypatch, dtype, f2, n,
                                             bound):
  """`_LevelEncode` fused (the CPU wrappers run the plain version) against
  the chunked plain path: features, and the tables' gradients through the
  bound."""
  r, f, m = 48, 16, 40
  u, var = _rows(m, n, r, 7)
  v, p = _tables(r, f, f2, 8)
  g = torch.randn(m, f + 3 * f2).to(dtype)

  def run(fused):
    monkeypatch.setattr(cp_encode, "covers", lambda *a: fused)
    vv = v.clone().requires_grad_(True)
    pp = None if p is None else p.clone().requires_grad_(True)
    out = cpgrid.level_encode(u, var, vv, pp, r, bound, dtype)
    out.backward(g)
    return out, vv.grad, None if pp is None else pp.grad

  fused, plain = run(True), run(False)
  tol = 1e-6 if dtype == F32 else 2 ** -7
  assert fused[0].dtype == plain[0].dtype == dtype
  assert torch.equal(fused[0], plain[0])
  for a, b in zip(fused[1:], plain[1:]):
    if b is not None:
      assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_checkpoint_saves_the_level_inputs_on_the_fused_path(monkeypatch):
  monkeypatch.setattr(cp_encode, "covers", lambda *a: True)
  enc = cpgrid.CPEncoding(num_levels=2, level_dim=8, base_resolution=32,
                          max_resolution=64, device="cpu")
  sizes = []

  def pack(t):
    sizes.append(t.numel())
    return t

  with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
    enc(torch.rand(64, 1, 3), torch.full((64, 1), 0.01))
  assert sizes and max(sizes) < 64 * 64


# ---- the kernel on the card

def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel is CUDA only")
  return torch.device("cuda")


# (dtype, F, F2, n, R, M, factor_bound)
CARD_CASES = [
    (F32, 64, 0, 1, 1024, 1000, 0.0),
    (BF16, 64, 0, 1, 1024, 1000, 0.0),
    (BF16, 64, 0, 1, 128, 3001, 0.5),
    (F32, 8, 0, 1, 362, 777, 0.0),
    (BF16, 8, 0, 1, 512, 2049, 0.0),
    (F32, 16, 8, 7, 32, 100, 0.5),
    (BF16, 16, 8, 7, 256, 61, 0.0),
    (BF16, 64, 8, 1, 512, 513, 0.0),
    (F32, 32, 0, 2, 64, 37, 0.0),
]
# max |kernel - plain| over max |plain|: float32 (3xTF32 against cuBLAS's
# float32, ex2.approx against expf); bf16 (a profile entry or a product
# rounding to the other bf16 neighbour: a few bf16 ulps of 2^-8)
TOL = {F32: 2e-5, BF16: 2e-2}


def _gap(a, b):
  return float((a.float() - b.float()).abs().max()) / float(
      b.float().abs().max())


def _case(spec, device):
  dtype, f, f2, n, r, m, bound = spec
  u, var = _rows(m, n, r, 11, device)
  v, p = _tables(r, f, f2, 12, device)
  table = cpgrid._table(v, p, bound, dtype)
  g = torch.randn(m, f + 3 * f2, device=device).to(dtype)
  return dtype, f, u, var, table, g


@pytest.mark.card
@pytest.mark.parametrize("spec", CARD_CASES, ids=str)
def test_kernel_forward_matches_plain(spec):
  dev = _card()
  dtype, f, u, var, table, _ = _case(spec, dev)
  launches = cp_encode.encode_fwd.launches
  got = cp_encode.encode_fwd(u, var, table, f, dtype)
  torch.cuda.synchronize()
  assert cp_encode.encode_fwd.launches == launches + 1
  want = cp_encode.encode_rows_plain(u, var, table[..., :f],
                                     table[..., f:] if table.shape[-1] > f
                                     else None, dtype)
  fault = cp_encode.encode_rows_plain(u + 1, var, table[..., :f],
                                      table[..., f:] if table.shape[-1] > f
                                      else None, dtype)
  assert got.dtype == dtype and got.shape == want.shape
  assert _gap(got, want) <= TOL[dtype], _gap(got, want)
  assert _gap(got, fault) > TOL[dtype], _gap(got, fault)


@pytest.mark.card
@pytest.mark.parametrize("spec", CARD_CASES, ids=str)
def test_kernel_table_grad_matches_plain(spec):
  dev = _card()
  dtype, f, u, var, table, g = _case(spec, dev)
  launches = cp_encode.encode_bwd.launches
  got = cp_encode.encode_bwd(u, var, table, f, g, dtype)
  torch.cuda.synchronize()
  assert cp_encode.encode_bwd.launches == launches + 1

  def plain(uu):
    t = table.detach().requires_grad_(True)
    out = cp_encode.encode_rows_plain(
        uu, var, t[..., :f], t[..., f:] if t.shape[-1] > f else None, dtype)
    (dt,) = torch.autograd.grad(out, t, g)
    return dt.float()

  want, fault = plain(u), plain(u + 1)
  assert got.dtype == F32 and got.shape == want.shape
  assert _gap(got, want) <= TOL[dtype], _gap(got, want)
  assert _gap(got, fault) > TOL[dtype], _gap(got, fault)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_kernel_long_sums_match_plain(dtype):
  """Wide windows (stds of 10-30 cells: ~37 steps of 16 nodes a row) and
  28 row tiles a split of the table gradient, where the sums run long."""
  dev = _card()
  m, r, f = 40_000, 1024, 64
  rs = np.random.RandomState(21)
  u = torch.tensor(rs.uniform(0, r - 1, size=(m, 1, 3)), dtype=F32,
                   device=dev)
  sig = torch.tensor(rs.uniform(10, 30, size=(m, 1, 3)), dtype=F32,
                     device=dev)
  var = sig * sig + 0.75 ** 2
  v, _ = _tables(r, f, 0, 22, dev)
  table = v.to(dtype)
  g = torch.randn(m, f, device=dev).to(dtype)
  assert cp_encode.splits((m + 15) // 16, r) < (m + 15) // 16 // 16

  def plain(uu):
    t = table.detach().requires_grad_(True)
    out = cp_encode.encode_rows_plain(uu, var, t, None, dtype)
    (dt,) = torch.autograd.grad(out, t, g)
    return out.detach(), dt.float()

  got = (cp_encode.encode_fwd(u, var, table, f, dtype),
         cp_encode.encode_bwd(u, var, table, f, g, dtype))
  want, fault = plain(u), plain(u + 1)
  for a, b, c in zip(got, want, fault):
    assert _gap(a, b) <= TOL[dtype], _gap(a, b)
    assert _gap(a, c) > TOL[dtype], _gap(a, c)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cp_encoding_fused_against_plain(monkeypatch, dtype):
  """A whole CPEncoding (bound, centre, scale, window, anisotropic stds)
  on the card: fused levels against the plain path, forward and the
  tables' gradients; every level through the kernel."""
  dev = _card()
  torch.manual_seed(3)
  enc = cpgrid.CPEncoding(num_levels=3, level_dim=16, base_resolution=64,
                          max_resolution=256, pair_dim=8, factor_bound=0.5,
                          feature_center=True, feature_scale=0.5, device=dev)
  x = torch.rand(999, 1, 3, device=dev)
  std = torch.exp(torch.empty(999, 1, 3, device=dev).uniform_(-9, -4))
  window = torch.tensor([1.0, 0.7, 0.2], device=dev)

  def run():
    enc.zero_grad()
    out = enc(x, std, level_window=window, dtype=dtype)
    out.float().square().sum().backward()
    return out, [t.grad.clone() for t in enc.tables("v") + enc.tables("p")]

  fwd, bwd = cp_encode.encode_fwd.launches, cp_encode.encode_bwd.launches
  fused = run()
  assert cp_encode.encode_fwd.launches == fwd + 3
  assert cp_encode.encode_bwd.launches == bwd + 3
  monkeypatch.setattr(cp_encode, "covers", lambda *a: False)
  plain = run()
  assert _gap(fused[0], plain[0]) <= TOL[dtype]
  for a, b in zip(fused[1], plain[1]):
    assert _gap(a, b) <= TOL[dtype], _gap(a, b)
