"""The system under test, ``repro_torch``, as the benchmark drives it.

This is the only module of the benchmark that imports the port.  It
builds the port's configuration from a configuration file, the
``Server`` that the window drives, and, in a traced run, the wrappers
that record spans around ``models.model.prefill`` and ``.decode_step``
and the shape of every K1 and K4 launch; for the check's own tests it
plants a fault (``faults.py``) under ``Server.step``.  No file of the
port is edited: the wrappers replace module attributes for the run and
put them back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import typing
from typing import Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.kernels import _build, ops
from repro_torch.models import model as lm
from repro_torch.serve.loop import Request, Server

from portbench import check

#: keys of a configuration file that are not the port's to take
NOT_ARCH = ("name", "source", "policy")


class WallClock:
    """``time.perf_counter`` behind the ``Server``'s clock interface:
    advancing is a no-op, so every stamp the server takes is wall time."""

    @property
    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> float:
        return time.perf_counter()

    def advance_to(self, t: float) -> float:
        return time.perf_counter()


def arch(cfg: Dict):
    """The port's ``ArchConfig`` for a configuration file: the registry's
    entry with every field that the file states (a nested group, such as
    ``ssm``, over the registry's group), and its dtypes.  Refused where
    the configuration's reference (``reference/<name>.py``) does not
    model a field's value: its ``PLAIN`` lists the values it models."""
    base = configs.get(cfg["registry"])
    hints = typing.get_type_hints(type(base))
    kw = {}
    for f in dataclasses.fields(base):
        if f.name not in cfg or f.name in NOT_ARCH:
            continue
        val = cfg[f.name]
        if isinstance(val, dict):
            cls = next(t for t in typing.get_args(hints[f.name]) + (
                hints[f.name],) if dataclasses.is_dataclass(t))
            val = dataclasses.replace(getattr(base, f.name) or cls(), **val)
        kw[f.name] = val
    a = base.replace(**kw).with_policy(param_dtype=cfg["param_dtype"],
                                       compute_dtype=cfg["compute_dtype"])
    plain = check.reference(cfg).PLAIN
    off = {k: getattr(a, k) for k, v in plain.items() if getattr(a, k) != v}
    if off:
        raise ValueError(f"{cfg['name']}: the reference does not model {off}")
    return a


def meta_params(a) -> Dict:
    """The parameter tree's shapes and dtypes, on the meta device."""
    return lm.init(a, device="meta")


def build_kernels(a) -> Dict[str, float]:
    """Build (or find built) the kernels the serve path launches; returns
    nvcc's seconds for each (0.0 when the library was already built)."""
    names = ["ame_gemm"] + (["ssd_scan"] if a.ssm is not None else [])
    _build.build_all(names)
    return {n: _build.BUILD_INFO[n]["seconds"] for n in names}


def server(a, weights: Dict, mix: Dict, device) -> Server:
    return Server(a, weights, slots=mix["slots"], cache_len=mix["cache_len"],
                  backend="kernel", clock=WallClock(), device=device)


def request(uid: int, prompt, max_new: int) -> Request:
    return Request(uid=uid, prompt=prompt, max_new=max_new)


@contextlib.contextmanager
def planted(fault):
    """``models.model.decode_step`` wrapped by ``fault`` (one of
    ``faults.FAULTS``) while the block runs."""
    saved = lm.decode_step
    lm.decode_step = fault(saved)
    try:
        yield
    finally:
        lm.decode_step = saved


class Tracer:
    """Spans of every prefill and decode step, each synchronised on both
    sides, and the shape of every K1 and K4 launch with the span it ran
    under.  ``profiling`` marks what ran while the profiler recorded."""

    def __init__(self, srv: Server):
        self.srv = srv
        self.sync = torch.cuda.synchronize if srv.device.type == "cuda" \
            else (lambda: None)
        self.spans: List[Dict] = []
        self.k1: List[Dict] = []
        self.k4: List[Dict] = []
        self.phase: Optional[str] = None
        self.profiling = False
        self._saved: Dict = {}

    def _span(self, phase: str, fn, work: Dict):
        def run(*args, **kw):
            self.sync()
            t = time.perf_counter()
            self.phase = phase
            try:
                out = fn(*args, **kw)
                self.sync()
            finally:
                self.phase = None
            self.spans.append(dict(phase=phase, start=t,
                                   end=time.perf_counter(),
                                   profiled=self.profiling, **work(args)))
            return out
        return run

    def install(self) -> None:
        srv = self.srv
        self._saved = {(lm, "prefill"): lm.prefill,
                       (lm, "decode_step"): lm.decode_step,
                       (ops, "ame_gemm"): ops.ame_gemm,
                       (ops, "ssd_scan"): ops.ssd_scan}
        lm.prefill = self._span(
            "prefill", self._saved[(lm, "prefill")],
            lambda args: {"tokens": int(args[1]["tokens"].shape[1])})
        lm.decode_step = self._span(
            "decode", self._saved[(lm, "decode_step")],
            lambda args: {"positions": [int(srv.pos[i])
                                        for i in range(srv.slots)
                                        if srv.active[i] is not None]})
        k1, k4 = self._saved[(ops, "ame_gemm")], self._saved[(ops, "ssd_scan")]

        def ame_gemm(a, b, *, out_dtype=None, **blocks):
            out = k1(a, b, out_dtype=out_dtype, **blocks)
            self.k1.append(dict(m=a.shape[0], k=a.shape[1], n=b.shape[1],
                                in_bytes=a.element_size(),
                                out_bytes=out.element_size(),
                                phase=self.phase, profiled=self.profiling))
            return out

        def ssd_scan(x, log_a, b, c, *, chunk=128, **kw):
            out = k4(x, log_a, b, c, chunk=chunk, **kw)
            heads = x.shape[-3] if x.dim() == 4 else 1
            rows = x.numel() // (x.shape[-1] * x.shape[-2])
            bc_rows = rows // heads if b.dim() == 4 and b.stride(1) == 0 \
                else rows
            self.k4.append(dict(bh=rows, t=x.shape[-2], p=x.shape[-1],
                                n=b.shape[-1], chunk=chunk,
                                x_bytes=x.element_size(),
                                bc_bytes=b.element_size(), bc_rows=bc_rows,
                                phase=self.phase, profiled=self.profiling))
            return out
        ops.ame_gemm, ops.ssd_scan = ame_gemm, ssd_scan

    def remove(self) -> None:
        for (mod, name), fn in self._saved.items():
            setattr(mod, name, fn)
        self._saved = {}
