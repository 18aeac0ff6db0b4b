"""Build the port's CUDA kernels at first use and load them with ctypes.

No JAX counterpart (Pallas kernels compile inside `jax.jit`). Each
`csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface under `bigdl_tpu_torch/ops/build/` (git-ignored),
named by a hash of the source, the headers of `csrc/` it includes and
the flags, so a library is rebuilt only when what it compiles changes.
A plain C interface keeps PyTorch's headers out of the build: seconds,
against minutes for `torch.utils.cpp_extension.load`. `build()` starts
one `nvcc` per source, all at once, and waits for them together. A
failed build raises; nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# name → loaded library, and name → nvcc/ptxas report of its build (kept
# beside the library as lib<name>-<hash>.log, so a cached build has it)
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


def _sources(src: Path) -> List[Path]:
    """`src` and, in the order first met, the `csrc/` headers it
    includes with `#include "..."`, directly or through one another."""
    seen = [src]
    for path in seen:
        for m in _LOCAL_INCLUDE.finditer(path.read_text()):
            header = CSRC / m.group(1)
            if header not in seen:
                seen.append(header)
    return seen


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is (or will be) built."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (where out of date) and load the libraries of `names`,
    one `nvcc` process per source, all started together."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        for name in todo:
            so = library_path(name)
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
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{log}")
                continue
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n"
                               + "\n".join(failed))
        for name in todo:
            so = library_path(name)
            log = so.with_suffix(".log")
            BUILD_LOG[name] = log.read_text() if log.exists() else ""
            _LIBS[name] = ctypes.CDLL(str(so))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build([name])[name]
