"""What the command may touch: importing the harness loads no JAX (nor
the JAX package), the reference imports nothing of the port, and without
a CUDA card the command exits non-zero and prints no result."""

import os
import subprocess
import sys

from bench_port import cell as C

NO_JAX = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "snerf_tpu"):
  sys.modules[blocked] = None
import bench_port
for m in pkgutil.walk_packages(bench_port.__path__, "bench_port."):
  if ".tests" not in m.name:
    importlib.import_module(m.name)
from bench_port.drivers import render, train
import snerf_tpu_torch.train.zip_trainer, snerf_tpu_torch.train.renderer
assert not any(k == "jax" or k.startswith(("jax.", "snerf_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
print("ok")
"""

REFERENCE_ALONE = r"""
import importlib, pkgutil, sys
sys.modules["snerf_tpu_torch"] = None
import bench_port.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "bench_port.reference."):
  importlib.import_module(m.name)
print("ok")
"""


def _python(code, env=None):
  return subprocess.run([sys.executable, "-c", code], cwd=C.ROOT,
                        capture_output=True, text=True, timeout=300,
                        env=env)


def test_harness_loads_no_jax():
  proc = _python(NO_JAX)
  assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_reference_imports_nothing_of_the_port():
  proc = _python(REFERENCE_ALONE)
  assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_without_a_card_the_command_fails_and_prints_no_result():
  bench = C.load_benchmark()
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  cmd = bench["command"] + ["--workload", bench["workloads"][0]["name"],
                            "--seed", "3000000001", "--seconds", "1",
                            "--trace", "0"]
  proc = subprocess.run(cmd, cwd=C.ROOT, capture_output=True, text=True,
                        timeout=300, env=env)
  assert proc.returncode != 0
  assert "{" not in proc.stdout
