"""The gather probes P1 and P2 on the card, and the primitive survey
behind kernel K2 and its scatter-add.

P1 (`take_along_axis`, counterpart of scripts/probe_gather.py `run` with
`kernel_lane` / `kernel_sub`) gathers along the last or the first axis of
a 2-D array; P2 (`gather_select`, counterpart of scripts/probe_hash_ops.py
`f7` with `kern`) gathers from a small dense [C, T] table, each channel
row with its own indices, a block staging only its channel's row in
shared memory. Both launch the
hand-written kernels in `snerf_tpu_torch/csrc/gather_probe.cu` for CUDA
tensors and run their plain PyTorch versions (`torch.take_along_dim`,
`Tensor.gather`) for CPU tensors; each wrapper counts its launches.

`survey` times, on the card, the access patterns of the hash encoder at
probe_hash_ops.py's shapes (4 M queries into a 2^21 x 4 table): K2's row
gather against `table[idx]` and the flat-scalar gather; the scatter-add
kernel against `index_add_` on random and on sorted indices; `torch.sort`
and `torch.argsort` of 4 M int32; P1 by axis and width; P2 on the
[8, 4,992] table with 2^20 queries; and the dense-table crossover, the
table size at which P2's shared-memory gather stops beating K2's row
gather. `p2_times` times P2 against `Tensor.gather` at that shape by CUDA
events and by the profiler's device time. Run them on a card:

  python -m snerf_tpu_torch.probes.gather          # the survey
  python -m snerf_tpu_torch.probes.gather --p2     # P2 alone
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List

import torch

from snerf_tpu_torch.ops import _cuda, hash_ops


def _bind(lib):
  lib.snerf_take_along_axis.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
      + [ctypes.c_void_p])
  lib.snerf_take_along_axis.restype = ctypes.c_int
  lib.snerf_gather_select.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
      + [ctypes.c_int] + [ctypes.c_void_p])
  lib.snerf_gather_select.restype = ctypes.c_int
  lib.snerf_gather_select_max_floats.argtypes = [ctypes.c_int]
  lib.snerf_gather_select_max_floats.restype = ctypes.c_int


def _lib():
  return _cuda.load("gather_probe", _bind)


def _check(x, idx, what):
  if x.dim() != 2 or idx.dim() != 2:
    raise ValueError(f"{what}: x and idx must be 2-D, got {tuple(x.shape)} "
                     f"and {tuple(idx.shape)}")
  if idx.dtype != torch.int32:
    raise ValueError(f"{what}: idx must be int32, got {idx.dtype}")


def _on_cuda(what, x, idx):
  """`_cuda.on_cuda`, and the kernels read float32 only."""
  if not _cuda.on_cuda(what, x, idx):
    return False
  if x.dtype != torch.float32:
    raise ValueError(f"{what}: x dtype {x.dtype} not supported")
  return True


def take_along_axis_plain(x, idx, axis: int):
  """P1's plain version: torch.take_along_dim(x, idx, axis)."""
  _check(x, idx, "take_along_axis")
  return torch.take_along_dim(x, idx.long(), dim=axis)


def take_along_axis(x, idx, axis: int):
  """P1: out[s, l] = x[s, idx[s, l]] (axis 1) or x[idx[s, l], l] (axis 0)
  for x float32 [S, L] and idx int32 [S, L] with every value inside the
  axis (not checked). CPU tensors run `take_along_axis_plain`, CUDA
  tensors the kernel; `take_along_axis.launches` counts its launches."""
  _check(x, idx, "take_along_axis")
  if axis not in (0, 1) or idx.shape != x.shape:
    raise ValueError(f"take_along_axis: axis {axis}, x {tuple(x.shape)}, idx "
                     f"{tuple(idx.shape)}: axis 0 or 1 and equal shapes")
  if not _on_cuda("take_along_axis", x, idx):
    return take_along_axis_plain(x, idx, axis)
  out = torch.empty_like(x)
  lib = _lib()
  err = lib.snerf_take_along_axis(
      x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
      axis, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
  _cuda.check_launch(lib, err, f"take_along_axis {tuple(x.shape)} axis "
                     f"{axis}")
  take_along_axis.launches += 1
  return out


take_along_axis.launches = 0


def gather_select_plain(tab, idx):
  """P2's plain version: tab.gather(1, idx)."""
  _check(tab, idx, "gather_select")
  return tab.gather(1, idx.long())


_max_floats: Dict[int, int] = {}


def gather_select_max_floats(device=None) -> int:
  """The most table entries of one channel (T) the P2 kernel can hold in a
  block's shared memory on `device` (read once per device)."""
  dev = torch.device("cuda" if device is None else device)
  index = dev.index if dev.index is not None else torch.cuda.current_device()
  if index not in _max_floats:
    _max_floats[index] = _lib().snerf_gather_select_max_floats(index)
  return _max_floats[index]


def gather_select(tab, idx):
  """P2: out[c, q] = tab[c, idx[c, q]] for tab float32 [C, T] (T within
  `gather_select_max_floats`) and idx int32 [C, Q] with every value
  in [0, T) (not checked). CPU tensors run `gather_select_plain`, CUDA
  tensors the kernel; `gather_select.launches` counts its launches."""
  _check(tab, idx, "gather_select")
  if idx.shape[0] != tab.shape[0]:
    raise ValueError(f"gather_select: tab {tuple(tab.shape)} and idx "
                     f"{tuple(idx.shape)} need the same channel count")
  if not _on_cuda("gather_select", tab, idx):
    return gather_select_plain(tab, idx)
  if tab.shape[1] > gather_select_max_floats(tab.device):
    raise ValueError(f"gather_select: a row of a {tuple(tab.shape)} table "
                     "does not fit a block's shared memory")
  out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
  lib = _lib()
  err = lib.snerf_gather_select(
      tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
      tab.shape[1], idx.shape[1], tab.device.index,
      torch.cuda.current_stream(tab.device).cuda_stream)
  _cuda.check_launch(lib, err, f"gather_select {tuple(tab.shape)} x "
                     f"{idx.shape[1]}")
  gather_select.launches += 1
  return out


gather_select.launches = 0


def time_ms(fn, iters: int) -> float:
  """Mean ms per call of fn over `iters` calls after one warm-up, by CUDA
  events."""
  fn()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int):
  """Mean device time of one call of fn in ms: the kernels torch.profiler
  records over `iters` calls after one warm-up; None when it records no
  device time."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  us = sum(e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False))
  return us / 1e3 / iters if us > 0 else None


def graph_ms(fn, iters: int) -> float:
  """Mean ms per call of fn by CUDA events around one replay of a CUDA
  graph that holds `iters` calls: the launches follow each other with no
  host time between them, as in a steady stream of work."""
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  graph.replay()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def p2_times(log=print, iters: int = 50, device="cuda") -> dict:
  """P2 against `Tensor.gather` at probe_hash_ops.py's shape, a [8, 4,992]
  table and [8, 2^17] indices: bit-equal; CUDA-event times of back-to-back
  calls in turns (gather, P2, P2, gather), where each call's host time
  shows; CUDA-event times over a CUDA-graph replay of the calls (no host
  time between launches), in turns; and each one's device time under
  torch.profiler. Returns {"ms", "gather_ms" (back to back), "graph_ms",
  "gather_graph_ms", "device_ms", "gather_device_ms", "equal"}."""
  gen = torch.Generator(device=device).manual_seed(7)
  tab = torch.randn(8, 4992, generator=gen, device=device)
  idx = torch.randint(0, 4992, (8, 1 << 17), generator=gen, device=device,
                      dtype=torch.int32)
  idx_l = idx.long()
  equal = torch.equal(gather_select(tab, idx), tab.gather(1, idx_l))

  def p2():
    return gather_select(tab, idx)

  def gather():
    return tab.gather(1, idx_l)

  g1, k1, k2, g2 = (time_ms(f, iters) for f in (gather, p2, p2, gather))
  gg1, gk1, gk2, gg2 = (graph_ms(f, iters) for f in (gather, p2, p2, gather))
  res = dict(ms=(k1 + k2) / 2, gather_ms=(g1 + g2) / 2,
             graph_ms=(gk1 + gk2) / 2, gather_graph_ms=(gg1 + gg2) / 2,
             device_ms=device_ms(p2, iters),
             gather_device_ms=device_ms(gather, iters), equal=equal)
  fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
  log(f"P2 gather_select [8x4992 table, 8x{1 << 17} idx]: bit-equal "
      f"{equal}; CUDA events, back to back {res['ms']:.4f} ms against "
      f"Tensor.gather {res['gather_ms']:.4f} ms [{k1:.4f}/{k2:.4f} vs "
      f"{g1:.4f}/{g2:.4f}], over a graph replay {res['graph_ms']:.4f} ms "
      f"against {res['gather_graph_ms']:.4f} ms [{gk1:.4f}/{gk2:.4f} vs "
      f"{gg1:.4f}/{gg2:.4f}]; profiler device time "
      f"{fmt(res['device_ms'])} against {fmt(res['gather_device_ms'])}")
  return res


def _line(name, shape, ms, n, bytes_, plain=None):
  s = (f"probe {name} [{shape}]: {ms:.4f} ms, {n / ms / 1e6:.2f} G/s, "
       f"{bytes_ / ms / 1e6:.0f} GB/s of useful bytes")
  if plain is not None:
    s += f" | plain {plain:.4f} ms"
  return s


def survey(log=print, iters: int = 20, device="cuda") -> Dict[str, dict]:
  """Time the primitives of the hash encoder on the card and print one
  line each; returns {name: {"ms", "n", "bytes"[, "plain_ms"]}}. Needs a
  CUDA device."""
  if not torch.cuda.is_available():
    raise RuntimeError("the gather survey needs a CUDA device")
  gen = torch.Generator(device=device).manual_seed(0)
  res: Dict[str, dict] = {}

  def rec(name, shape, ms, n, bytes_, plain=None):
    res[name] = dict(ms=ms, n=n, bytes=bytes_, plain_ms=plain)
    log(_line(name, shape, ms, n, bytes_, plain))

  # 1. row gathers: 4 M queries into a 2^21 x 4 table
  nq, rows, c = 4_000_000, 1 << 21, 4
  table = torch.rand(rows, c, generator=gen, device=device)
  idx = torch.randint(0, rows, (nq,), generator=gen, device=device,
                      dtype=torch.int32)
  idx_l = idx.long()
  gather_bytes = nq * (4 + 2 * 4 * c)
  rec("K2 row gather", "4M from 2^21x4",
      time_ms(lambda: hash_ops.gather_rows(table, idx), iters), nq,
      gather_bytes)
  rec("table[idx]", "4M from 2^21x4", time_ms(lambda: table[idx_l], iters),
      nq, gather_bytes)
  flat = table.view(-1)
  fi = (idx_l[:, None] * c + torch.arange(c, device=device)).view(-1)
  rec("flat scalar gather", "16M scalars from 2^23",
      time_ms(lambda: flat[fi], iters), nq, gather_bytes)

  # 2. scatter-adds: the backward of 1
  g = torch.rand(nq, c, generator=gen, device=device)
  scatter_bytes = nq * (4 + 4 * c) + rows * c * 4
  rec("scatter-add kernel", "4M into 2^21x4",
      time_ms(lambda: hash_ops.scatter_add_rows(idx, g, rows), iters), nq,
      scatter_bytes)
  rec("index_add_", "4M into 2^21x4",
      time_ms(lambda: torch.zeros_like(table).index_add_(0, idx, g), iters),
      nq, scatter_bytes)
  sidx = torch.sort(idx).values
  rec("index_add_ sorted", "4M into 2^21x4",
      time_ms(lambda: torch.zeros_like(table).index_add_(0, sidx, g), iters),
      nq, scatter_bytes)
  rec("scatter-add kernel sorted", "4M into 2^21x4",
      time_ms(lambda: hash_ops.scatter_add_rows(sidx, g, rows), iters), nq,
      scatter_bytes)

  # 3. sorts of 4 M int32
  rec("torch.sort", "4M int32", time_ms(lambda: torch.sort(idx), iters), nq,
      nq * 4 * 3)
  rec("torch.argsort", "4M int32", time_ms(lambda: torch.argsort(idx), iters),
      nq, nq * 4 * 3)
  del table, idx, idx_l, flat, fi, g, sidx

  # 4. P1 by axis and width (probe_gather.py's shapes)
  for axis, s, l in ((1, 8, 4096), (1, 64, 4096), (1, 8, 131072),
                     (1, 64, 131072), (0, 1024, 128), (0, 1024, 4096),
                     (0, 64, 131072)):
    x = torch.rand(s, l, generator=gen, device=device)
    ix = torch.randint(0, x.shape[axis], (s, l), generator=gen,
                       device=device, dtype=torch.int32)
    ixl = ix.long()
    rec(f"P1 take_along_axis axis {axis}", f"{s}x{l}",
        time_ms(lambda: take_along_axis(x, ix, axis), iters), s * l,
        s * l * 12,
        plain=time_ms(lambda: torch.take_along_dim(x, ixl, dim=axis), iters))

  # 5. P2 on the [8, 4992] table, 2^20 queries
  tab = torch.rand(8, 4992, generator=gen, device=device)
  qi = torch.randint(0, 4992, (8, 1 << 17), generator=gen, device=device,
                     dtype=torch.int32)
  qil = qi.long()
  rec("P2 gather_select", "8x4992 table, 8x2^17 idx",
      time_ms(lambda: gather_select(tab, qi), iters), qi.numel(),
      qi.numel() * 8 + tab.numel() * 4,
      plain=time_ms(lambda: tab.gather(1, qil), iters))

  # 6. the dense-table crossover: per-channel queries into a [C, T] table
  # (P2, a channel's row in shared memory) against K2's row gather from
  # [T, C] with one index a query; 4 M queries, C = 1 (proposal) and 4
  # (nerf)
  nq = 1 << 22
  t_max = gather_select_max_floats()
  for c in (1, 4):
    cross = None
    sizes = [t for t in (1024, 4913, 8192, 16384, 32768) if t < t_max] + [
        t_max]
    for t in sizes:
      tt = torch.rand(t, c, generator=gen, device=device)
      ti = torch.randint(0, t, (nq,), generator=gen, device=device,
                         dtype=torch.int32)
      tab_ct = tt.t().contiguous()
      ti_ct = ti.expand(c, nq).contiguous()
      k2 = time_ms(lambda: hash_ops.gather_rows(tt, ti), iters)
      sm = time_ms(lambda: gather_select(tab_ct, ti_ct), iters)
      log(f"probe crossover C={c} T={t}: P2 shared-memory {sm:.4f} ms vs K2 "
          f"row gather {k2:.4f} ms ({nq} queries)")
      if cross is None and sm >= k2:
        cross = t
    res[f"crossover C={c}"] = dict(t_max=t_max, crossover=cross)
    if cross is None:
      verdict = f"P2 beats K2 up to the shared-memory limit T={t_max}"
    elif cross == sizes[0]:
      verdict = f"K2 is as fast or faster at every T measured (from {cross})"
    else:
      verdict = f"P2 stops beating K2 at T={cross}"
    log(f"probe crossover C={c}: {verdict}")
  return res


def card_line() -> str:
  """The card's name and power limit, as nvidia-smi reports them."""
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
      f"nvidia-smi failed: {out.stderr.strip()}")


def main(argv: List[str]) -> int:
  if not torch.cuda.is_available():
    print("the gather probes need a CUDA card", file=sys.stderr)
    return 1
  print(card_line(), flush=True)
  if "--p2" in argv:
    p2_times(log=lambda s: print(s, flush=True))
  else:
    survey(log=lambda s: print(s, flush=True))
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
