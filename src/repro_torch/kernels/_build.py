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

The wrappers bind their C entry points through :func:`entry` (each keeps
its argtypes beside its C signature), raise :func:`launch_error` for a
launch's nonzero return code, refuse autograd with :func:`forward_only`,
and the decode kernels that merge key splits count arrivals in
:func:`arrival_counts`.
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

#: name -> loaded library (one per process; a library never changes once
#: loaded because its file name carries the source hash)
_LIBS: Dict[str, ctypes.CDLL] = {}
#: (library, symbol) -> its bound C function (:func:`entry`)
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}
#: name -> {"seconds": build wall time (0.0 when cached), "ptxas": the
#: ``-Xptxas -v`` register / shared-memory lines of the last build}
BUILD_INFO: Dict[str, Dict] = {}
#: device index -> the int32 arrival counts of the split kernels
#: (:func:`arrival_counts`)
_COUNTS: Dict[int, torch.Tensor] = {}


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


def entry(lib: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C function ``symbol`` of library ``lib`` (:func:`load`), its
    ``argtypes`` set and returning ``c_int``; bound once per (library,
    symbol)."""
    fn = _ENTRIES.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[lib, symbol] = fn
    return fn


def launch_error(rc: int, what: str, at: str) -> RuntimeError:
    """The error a wrapper raises for a launch's nonzero return code
    ``rc``: ``"<what> launch failed: cudaError <rc> at <at>"``."""
    return RuntimeError(f"{what} launch failed: cudaError {rc} at {at}")


def arrival_counts(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, one buffer a device for
    every kernel that merges its key splits in the same launch: each
    counts a group's arriving blocks in it and leaves it zeroed, so
    launches that share it run on one stream, one after another."""
    buf = _COUNTS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTS[device.index] = buf
    return buf


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``tensors``: the
    kernel path has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel path is forward-only, as the reference's "
            f"Pallas path is; train on backend='torch', or call it under "
            f"torch.no_grad()")
