"""Build the port's CUDA kernels at first use and load them with ctypes.

No JAX counterpart (Pallas kernels compile inside `jax.jit`). Each
`csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface under `bigdl_tpu_torch/ops/build/` (git-ignored),
named by a hash of the source and the flags, so a library is rebuilt
only when its source changes. A plain C interface keeps PyTorch's
headers out of the build: seconds, against minutes for
`torch.utils.cpp_extension.load`. `build()` starts one `nvcc` per
source, all at once, and waits for them together. A failed build
raises; nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name → loaded library, and name → nvcc/ptxas report of its build
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """`nvcc` from PATH, else from `$CUDA_HOME/bin`, else the toolkit's
    usual home. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "bigdl_tpu_torch build with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (where out of date) and load the libraries of `names`,
    one `nvcc` process per source, all started together."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        for name in todo:
            so = _target(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{log}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n"
                               + "\n".join(failed))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build([name])[name]
