"""Seeded open-loop arrival schedules, made from a traffic file.

One general generator reads every traffic file.  The file names its
arrival process (``{"process": <name>, ...parameters}``, a module of
``processes/``) and its length distribution (``lengths``, a module of
``lengths/``); a new mix of a known process and distribution is a data
file alone.  The method is a frozen copy of
``repro_torch.serve.traffic.poisson_trace`` (numpy ``default_rng`` with
domain-separated seeds).  A run of ``seconds`` at ``rate_rps`` (the
cell's, from ``cells/<cell>.json``) offers ``n = round(rate_rps *
seconds)`` requests, all due inside the window.

Every seed gets the same work in the same order.  The traffic file's
``base_seed`` fixes the arrival times and each request's prompt and
output lengths; the run's seed draws the prompts' token ids (and, in
``weights.py``, the weights).  The order is fixed along with the amount
because what a window measures depends on it: the tokens delivered
before the window closes, and the tail, depend on which requests are
still in flight then.  With the order drawn from the seed, one chat seed
read 141-144 output tokens/s in two runs on one H100, and another
166-168.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

PKG = Path(__file__).resolve().parent
#: keys every traffic file holds
KEYS = ("arrival", "prompt_len", "output_len", "lengths", "slots",
        "cache_len", "base_seed")


@dataclasses.dataclass(frozen=True)
class Arrival:
    uid: int
    due_s: float                # offset from the start of the window
    prompt: np.ndarray          # (T,) int32 token ids
    max_new: int


def module(kind: str, name: str):
    """``processes/<name>.py`` or ``lengths/<name>.py``."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}." + name.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path: Path) -> Dict:
    """A traffic file, checked: its process and length distribution
    exist, and lengths fit the cache with room to decode."""
    mix = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    if "process" not in mix["arrival"]:
        raise ValueError(f"{path}: arrival names no process")
    module("processes", mix["arrival"]["process"])
    module("lengths", mix["lengths"])
    for key in ("prompt_len", "output_len"):
        lo, hi = mix[key]
        if not 1 <= lo <= hi:
            raise ValueError(f"{path}: {key} {mix[key]} is not 1 <= lo <= hi")
    if mix["prompt_len"][1] + mix["output_len"][1] >= mix["cache_len"]:
        raise ValueError(f"{path}: the longest prompt and answer do not fit "
                         f"cache_len {mix['cache_len']}")
    return mix


def schedule(mix: Dict, rate_rps: float, seconds: float, seed: int,
             vocab: int) -> List[Arrival]:
    """The window's arrivals in due order."""
    if rate_rps <= 0:
        raise ValueError(f"the rate must be > 0, got {rate_rps}")
    n = max(1, int(round(rate_rps * seconds)))
    params = dict(mix["arrival"])
    process = module("processes", params.pop("process"))
    lengths = module("lengths", mix["lengths"])
    base = np.random.default_rng((7919, int(mix["base_seed"]), n))
    due = process.due(base, n, seconds, **params)
    prompts = lengths.draw(base, *mix["prompt_len"], n)
    outputs = lengths.draw(base, *mix["output_len"], n)
    run = np.random.default_rng((104729, int(seed)))
    return [Arrival(uid=i, due_s=float(due[i]),
                    prompt=run.integers(0, vocab, int(prompts[i]),
                                        dtype=np.int64).astype(np.int32),
                    max_new=int(outputs[i]))
            for i in range(n)]


def warm_prompts(mix: Dict, seed: int, vocab: int) -> List[np.ndarray]:
    """Prompts at the shortest, a middle and the longest length of the
    mix: the shapes the window's prefills reach, the longest last so
    that the allocator holds its blocks."""
    lo, hi = mix["prompt_len"]
    rng = np.random.default_rng((15485863, int(seed)))
    mid = int(round(np.sqrt(lo * hi)))
    return [rng.integers(0, vocab, t, dtype=np.int64).astype(np.int32)
            for t in sorted({lo, mid, hi})]
