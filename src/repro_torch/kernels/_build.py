"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/repro_torch/`` at the root of the
checkout, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The file name carries a hash of the sources and flags, so a library is
rebuilt only when its source changes.  A source elsewhere (``src_dir``, as
the block sweep in ``tools/csrc/`` that includes a kernel's source to
instantiate more configurations) builds the same way, with ``csrc/`` on its
include path.  Nothing here runs at import: the
CPU tests import every module of the port and never build.  A failed
build raises; there is no fallback.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

#: name -> loaded library (one per process; a library never changes once
#: loaded because its file name carries the source hash)
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when cached), "ptxas": the
#: ``-Xptxas -v`` register / shared-memory lines of the last build}
BUILD_INFO: Dict[str, Dict] = {}


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    deps = sorted(CSRC.glob("*.cuh"))
    if src.parent != CSRC:          # it may include any kernel's source
        deps += sorted(CSRC.glob("*.cu"))
    for p in deps + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, src_dir: Path = CSRC) -> Path:
    """Compile ``<src_dir>/<name>.cu`` unless a library of the same source
    hash exists; returns the library path.  Raises ``RuntimeError`` with the
    compiler's output if ``nvcc`` fails."""
    src = Path(src_dir) / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    lib = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if lib.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": []})
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)            # atomic: a reader never sees half a file
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "Function properties" in ln or "registers" in ln
             or "spill" in ln]
    BUILD_INFO[name] = {"seconds": secs, "ptxas": _demangle(ptxas)}
    return lib


def _demangle(lines: List[str]) -> List[str]:
    """``lines`` with each mangled kernel name replaced by the toolkit's
    ``cu++filt -p`` reading of it (``name<template values>``)."""
    names = sorted({w for ln in lines for w in ln.split()
                    if w.startswith("_Z")})
    if not names:
        return lines
    filt = Path(_nvcc()).parent / "cu++filt"
    out = subprocess.run([str(filt), "-p", *names], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    plain = dict(zip(names, out))
    return [" ".join(plain.get(w, w) for w in ln.split()) for ln in lines]


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Build every kernel source at once, one ``nvcc`` process each."""
    names = names or sources()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as ex:
        futs = {n: ex.submit(build, n) for n in names}
        return {n: f.result() for n, f in futs.items()}


def load(name: str, src_dir: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``<src_dir>/<name>.cu``, built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, src_dir)))
        _LIBS[name] = lib
    return lib
