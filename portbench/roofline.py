"""Shares of a roofline, read from launch records that carry their device
time (``device_s``, paired from the profiled slice).  A reader that finds
no launch returns None, never 0."""
from typing import Callable, Dict, List, Optional

from portbench import work


def k1(ln: Dict) -> float:
    return work.k1_bound_s(ln["m"], ln["k"], ln["n"], ln["in_bytes"],
                           ln["out_bytes"])


def k4(ln: Dict) -> float:
    return work.k4_bound_s(ln["bh"], ln["t"], ln["p"], ln["n"], ln["chunk"],
                           ln["x_bytes"], ln["bc_bytes"], ln["bc_rows"])


def share(launches: List[Dict], phase: str,
          bound: Callable[[Dict], float]) -> Optional[float]:
    mine = [ln for ln in launches
            if ln["phase"] == phase and ln.get("device_s")]
    if not mine:
        return None
    return 100.0 * sum(bound(ln) for ln in mine) \
        / sum(ln["device_s"] for ln in mine)


def idle(run) -> Optional[float]:
    p = run.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
