"""Each per-layer metric's reader on its own canned case, and the
reduction of profiler events to device seconds by layer."""

import types

import pytest

from bench_port import cell as C
from bench_port import run as R
from bench_port import trace

PER_LAYER = [m["name"] for m in C.load_benchmark()["per_layer"]]
READING = trace.TraceReading(
    kernels=[("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)],
    layer_s={}, window_s=5.0, units=2, idle_by_host=[("aten::item", 1.0)])


def test_every_per_layer_metric_has_a_canned_reading():
  for name in PER_LAYER:
    mod = R.metric_module(name)
    assert callable(mod.read), name
    assert set(mod.CANNED) == {"reading", "work", "value"}, name
    assert mod.CANNED["value"] > 0, name


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_on_canned_trace(name):
  mod = R.metric_module(name)
  reading = trace.TraceReading(**mod.CANNED["reading"])
  assert mod.read(reading, mod.CANNED["work"]) == pytest.approx(
      mod.CANNED["value"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_finds_nothing_and_returns_none(name):
  empty = trace.TraceReading(kernels=[], layer_s={}, window_s=5.0, units=2,
                             idle_by_host=[])
  assert R.read_metric(name, empty, {}) is None


def test_busy_is_the_union_of_intervals():
  assert READING.busy_s() == pytest.approx(3.0)
  assert READING.device_ops()[0] == ("b", 1.5)


class Ev(types.SimpleNamespace):
  pass


def _cpu(name, start, end, parent=None, kernels=(), corr=0):
  return Ev(name=name, id=corr, device=False, cpu_parent=parent,
            kernels=[types.SimpleNamespace(name=k, duration=d)
                     for k, d in kernels],
            time_range=types.SimpleNamespace(start=start, end=end))


def _dev(name, start, end):
  return Ev(name=name, device=True, cpu_parent=None, kernels=[],
            time_range=types.SimpleNamespace(start=start, end=end))


def test_reduce_attributes_kernels_to_the_innermost_marker():
  ev = trace.EVAL_PREFIX
  enc = _cpu("bench.hash_encode", 0, 10)
  enc_op = _cpu("aten::add", 1, 2, enc, [("k_enc", 3.0)])
  bwd = _cpu(ev + "HashEncodeFunctionBackward", 20, 30)
  bwd_op = _cpu("aten::zeros", 21, 22, bwd, [("k_bwd", 4.0)])
  # a checkpoint's recompute under another node: its K1 call runs inside
  # the bench.k1 span, its cuBLAS layer outside any layer's marker
  node = _cpu(ev + "AddmmBackward0", 32, 60)
  k1 = _cpu("bench.k1", 41, 50, node)
  k1_op = _cpu("fused", 42, 43, k1, [("k1_fwd", 5.0)])
  gemm_op = _cpu("aten::mm", 51, 52, node, [("gemm", 6.0)])
  # a kernel launched through ctypes in inference mode, linked by the
  # profiler to the op that ran before it (an encoder's): its name puts
  # it in K1
  cp = _cpu("bench.cp_encode", 70, 80)
  cp_op = _cpu("aten::exp", 71, 72, cp, [("k1_wgmma_kernel<false>", 2.0)])
  events = [enc, enc_op, bwd, bwd_op, node, k1, k1_op, gemm_op, cp, cp_op,
            _dev("k_enc", 2, 5), _dev("k_bwd", 22, 26), _dev("k1_fwd", 43, 48),
            _dev("gemm", 52, 58), _dev("k1_wgmma_kernel<false>", 72, 74)]
  r = trace.reduce_events(events, window_s=1e-4, units=1,
                          layers=trace.load_layers(),
                          is_device=lambda e: e.device,
                          is_host=lambda e: not e.device)
  assert r.layer_s["encoders"] == pytest.approx(7e-6)
  assert r.layer_s["hash_encode"] == pytest.approx(7e-6)
  assert r.layer_s["k1"] == pytest.approx(7e-6)
  assert r.busy_s() == pytest.approx(20e-6)
  # the longest gap, 26 -> 43 us, falls in the recompute's node
  assert r.idle_by_host[0] == (ev + "AddmmBackward0", pytest.approx(17e-6))


def test_a_kernel_listed_twice_under_one_correlation_id_counts_once():
  # the launch queue was full: the profiler lists the encode's kernel under
  # its op and again under the "Command Buffer Full" event inside the
  # launch, both with the launch's correlation id; the kernel's other
  # launch, under K1's span, keeps its own seconds
  enc = _cpu("bench.hash_encode", 0, 10)
  op = _cpu("aten::mul", 1, 4, enc, [("k_mul", 3.0)], corr=7)
  launch = _cpu("cudaLaunchKernel", 2, 4, op)
  full = _cpu("Command Buffer Full", 2, 3, launch, [("k_mul", 3.0)], corr=7)
  k1 = _cpu("bench.k1", 20, 30)
  op2 = _cpu("aten::mul", 21, 22, k1, [("k_mul", 3.0)], corr=9)
  device = [_dev("k_mul", 5, 8), _dev("k_mul", 23, 26)]

  def reduce(events):
    return trace.reduce_events(events, window_s=1e-4, units=1,
                               layers=trace.load_layers(),
                               is_device=lambda e: e.device,
                               is_host=lambda e: not e.device)
  once = reduce([enc, op, launch, k1, op2] + device)
  twice = reduce([enc, op, launch, full, k1, op2] + device)
  assert twice.layer_s["encoders"] == pytest.approx(3e-6)
  assert twice.layer_s["k1"] == pytest.approx(3e-6)
  assert twice.layer_s == once.layer_s
  assert twice.busy_s() == once.busy_s() == pytest.approx(6e-6)


def test_only_the_launching_op_owns_a_kernel_its_id_lists():
  # listed before the op and starting earlier, inside K1's span: a runtime
  # call whose id collides with the op's; nested in the op, the profiler's
  # own buffer event with the op's id; inside the launch, a "Command
  # Buffer Full" wait with an id of its own. The op's layer is charged the
  # kernel once, and K1 nothing.
  k1 = _cpu("bench.k1", 0, 10)
  rt = _cpu("cudaStreamIsCapturing", 1, 2, k1, [("k_mul", 3.0)], corr=7)
  enc = _cpu("bench.hash_encode", 20, 30)
  op = _cpu("aten::mul", 21, 26, enc, [("k_mul", 3.0)], corr=7)
  buf = _cpu("Activity Buffer Request", 22, 25, op, [("k_mul", 3.0)], corr=7)
  launch = _cpu("cudaLaunchKernel", 23, 25, op)
  full = _cpu("Command Buffer Full", 23, 24, launch, [("k_mul", 3.0)],
              corr=8)
  device = [_dev("k_mul", 27, 30)]
  r = trace.reduce_events([k1, rt, enc, op, buf, launch, full] + device,
                          window_s=1e-4, units=1, layers=trace.load_layers(),
                          is_device=lambda e: e.device,
                          is_host=lambda e: not e.device)
  assert r.layer_s["encoders"] == pytest.approx(3e-6)
  assert r.layer_s["k1"] == 0.0
  assert r.busy_s() == pytest.approx(3e-6)


def test_layers_are_the_union_of_the_files():
  layers = trace.load_layers()
  assert {"encoders", "hash_encode", "k1"} <= set(layers)
  assert "bench.cp_encode" in layers["encoders"]["spans"]
