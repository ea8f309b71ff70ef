"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library with a
plain C interface, ``build/ray_tpu_torch/lib<name>-<hash>.so`` beside the
package.  The hash covers the source and the flags, so an edited source
builds anew and an unchanged one is loaded as it is.  Nothing is built at
import: the first call that needs a kernel builds it.  `build_all` starts one
``nvcc`` per source at once, so a cold start costs the slowest build, not
their sum.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_fwd", "flash_bwd")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    """One compiled source: the library, how long nvcc took (0.0 when the
    library was already on disk) and nvcc's report (`-Xptxas -v`: registers,
    shared memory and spills of each kernel)."""
    name: str
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the ray_tpu_torch kernels")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> List[Built]:
    """Compile every named source that is not built yet, all at once."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    built = []
    for name in names:
        if name not in started:
            built.append(Built(name, _target(name), 0.0, ""))
            continue
        proc, tmp, out = started[name]
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        built.append(Built(name, out, time.perf_counter() - t0, log))
    return built


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (built,) = build_all([name])
            lib = ctypes.CDLL(str(built.path))
            _loaded[name] = lib
        return lib
