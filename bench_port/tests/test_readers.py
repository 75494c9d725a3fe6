"""Each per-layer metric's reader on a canned trace, and the reduction of
profiler events to device seconds by layer."""

import importlib.util
import types

import pytest

from bench_port import cell as C
from bench_port import trace

READING = trace.TraceReading(
    kernels=[("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)],
    layer_s={"encoders": 0.5, "hash_encode": 0.25, "k1": 0.2},
    window_s=5.0, units=2, idle_by_host=[("aten::item", 1.0)])
WORK = {"products_s": 0.05, "k1_s": 0.1, "hash_encode_s": 0.01}
WANT = {"step_mfu.train": 1.0, "chunk_mfu.render": 1.0,
        "encode_ms.train": 250.0, "encode_ms.render": 250.0,
        "k1_roofline.train": 50.0, "k1_roofline.render": 50.0,
        "hash_encode_roofline.train": 4.0,
        "hash_encode_roofline.render": 4.0,
        "idle_share.train": 40.0, "idle_share.render": 40.0}


def _reader(name):
  spec = importlib.util.spec_from_file_location(
      "m_" + name.replace(".", "_"), C.metric_file(name))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read


def test_every_per_layer_metric_has_a_canned_reading():
  assert sorted(WANT) == sorted(m["name"] for m in
                                C.load_benchmark()["per_layer"])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_canned_trace(name):
  assert _reader(name)(READING, WORK) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_and_returns_none(name):
  empty = trace.TraceReading(kernels=[], layer_s={}, window_s=5.0, units=2,
                             idle_by_host=[])
  assert _reader(name)(empty, {}) is None


def test_busy_is_the_union_of_intervals():
  assert READING.busy_s() == pytest.approx(3.0)
  assert READING.device_ops()[0] == ("b", 1.5)


class Ev(types.SimpleNamespace):
  pass


def _cpu(name, start, end, parent=None, kernels=()):
  return Ev(name=name, device=False, cpu_parent=parent,
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


def test_layers_are_the_union_of_the_files():
  layers = trace.load_layers()
  assert {"encoders", "hash_encode", "k1"} <= set(layers)
  assert "bench.cp_encode" in layers["encoders"]["spans"]
