"""The traced run's device trace, reduced to what the metrics read.

``torch.profiler`` (device activity only, so the host's dispatch is not
slowed by the recording of every operator) runs over a short steady
slice of the window.  Its kineto events carry their own clock; the first
device event of the slice is a marker launched right after a
``perf_counter`` stamp on an idle device, which ties the two clocks
together to within a launch's latency.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

#: the label of idle time outside every span the benchmark records
OUTSIDE = "Server.step outside prefill and decode_step, and the harness"


class Profile:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_mark = self.t_stop = 0.0

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        marker = torch.empty(1, device=self.device)
        self.t_mark = time.perf_counter()
        marker.fill_(1.0)

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def device_events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device activity, in seconds of
        ``perf_counter``, ordered by start."""
        raw = sorted((e.start_ns(), e.end_ns(), e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
        if not raw:
            return []
        base = raw[0][0]
        return [(name, self.t_mark + (s - base) / 1e9,
                 self.t_mark + (e - base) / 1e9) for s, e, name in raw]


def merge(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def reduce(events: List[Tuple[str, float, float]], lo: float, hi: float,
           host: List[Tuple[str, float, float]]) -> Dict:
    """Busy and window seconds, the device time of each kernel name, the
    idle seconds by what the host was doing (``host``: labelled
    intervals; the rest is :data:`OUTSIDE`), and the device times of the
    K1 and K4 launches in launch order."""
    busy = merge([(s, e) for _, s, e in events], lo, hi)
    busy_s = sum(e - s for s, e in busy)
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = e
    if t < hi:
        idle.append((t, hi))
    by_label: Dict[str, float] = {}
    for gap in idle:
        left = gap[1] - gap[0]
        for label, s, e in host:
            o = _overlap(gap, (s, e))
            if o:
                by_label[label] = by_label.get(label, 0.0) + o
                left -= o
        if left > 0:
            by_label[OUTSIDE] = by_label.get(OUTSIDE, 0.0) + left
    by_name: Dict[str, float] = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s, "window_s": hi - lo,
        "device_ops": [[n[:160], v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in
                      sorted(by_label.items(), key=lambda kv: -kv[1])[:10]],
        "k1_s": [e - s for n, s, e in events if "ame_gemm" in n],
        "k4_s": [e - s for n, s, e in events if "ssd_scan" in n],
    }
