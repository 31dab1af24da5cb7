"""Builds the port's CUDA kernels with ``nvcc`` at first use.

Each kernel is one ``.cu`` file under ``csrc/`` with a plain C
interface, compiled for Hopper (``sm_90a``) into a shared library that
the wrapper loads with ``ctypes``; no PyTorch headers are involved, so
a build takes seconds.  Libraries go to ``build/`` at the repository
root (listed in ``.gitignore``), named by a hash of their sources and
flags, so a changed source is rebuilt and an unchanged one is reused.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` and
``PATH``; without it, building raises.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
REPO_ROOT = _PKG.parents[2]
BUILD_DIR = REPO_ROOT / "build"

#: kernel name -> its sources, relative to this directory
SOURCES: Dict[str, tuple] = {
    "paged_attention": ("csrc/paged_attention.cu",),
    "selective_scan": ("csrc/selective_scan.cu",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: Optional[float]    # None: reused an existing library
    log: str                    # nvcc's output (ptxas register report)


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in SOURCES[name]:
        digest.update((_PKG / rel).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None
              ) -> Dict[str, BuildResult]:
    """Build every named kernel (default: all) that has no library yet,
    one ``nvcc`` per kernel, all started together.  Raises with the
    compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    missing = []
    for name in names:
        path = library_path(name)
        log_path = path.with_suffix(".log")
        if path.is_file():
            log = log_path.read_text() if log_path.is_file() else ""
            results[name] = BuildResult(name, path, None, log)
        else:
            missing.append((name, path, log_path))
    nvcc = find_nvcc() if missing else None     # before starting any
    running = {}
    for name, path, log_path in missing:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(_PKG / rel) for rel in SOURCES[name]]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, log_path, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, log_path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, path)       # atomic: concurrent builds agree
        results[name] = BuildResult(name, path, seconds, log)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use and loaded once
    per process."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name].path
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


__all__ = ["BUILD_DIR", "SOURCES", "BuildResult", "build_all",
           "find_nvcc", "library_path", "load"]
