"""Build and load the port's CUDA kernels (`snerf_tpu_torch/csrc/*.cu`).

Each source is compiled with `nvcc` for sm_90a into a shared library with
a plain C interface, at first use, into `build/kernels/` under the
repository root, named by a hash of the source and the flags; it is
loaded with ctypes. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                     "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> tuple[Path, str]:
  """Compile `csrc/<name>.cu` if this source has not been built yet.

  Returns (path of the shared library, the compiler's output: ptxas
  registers, shared memory and spills; empty when it was built before).
  """
  src_path = CSRC / f"{name}.cu"
  src = src_path.read_bytes()
  digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
  so = BUILD_DIR / f"{name}_{digest[:16]}.so"
  if so.exists():
    return so, ""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
  proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src_path)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed building {src_path}:\n{proc.stderr}")
  os.replace(tmp, so)
  return so, proc.stdout + proc.stderr


def sources() -> list[str]:
  """Names of every kernel source in csrc/."""
  return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, tuple[Path, str]]:
  """Build every kernel source at once, one nvcc process each."""
  names = sources()
  with ThreadPoolExecutor(max_workers=len(names)) as pool:
    return dict(zip(names, pool.map(build, names)))


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
  """The loaded library of `csrc/<name>.cu`, built on first use.

  `bind` declares the argtypes and restype of the library's entry points;
  every library also exports `snerf_cuda_error_string`.
  """
  lib = _libs.get(name)
  if lib is None:
    so, _ = build(name)
    lib = ctypes.CDLL(str(so))
    lib.snerf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.snerf_cuda_error_string.restype = ctypes.c_char_p
    bind(lib)
    _libs[name] = lib
  return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
  """Raise if a kernel's C entry point returned a CUDA error."""
  if err != 0:
    msg = lib.snerf_cuda_error_string(err).decode()
    raise RuntimeError(f"{what}: kernel launch failed (CUDA error {err}: "
                       f"{msg})")
