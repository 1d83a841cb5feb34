"""Profiling by trace: attribute a cell's per-device link bytes or memory
traffic to the ops that make them (port of ``repro.launch.attribute``).

The reference ranks the instructions of the compiled HLO; here the rows
are the local ops of one fake-world run of the cell's step
(``launch/dryrun.trace_cell``), grouped by op and operand shapes.

  PYTHONPATH=src python -m repro_torch.launch.attribute --arch \\
      command-r-35b --shape train_4k [--what coll|mem] [--top 15] \\
      [--set tp_mode=allgather]
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.configs import SHAPES, get
from repro_torch.launch.traceanalysis import TraceReport


def apply_overrides(cfg, sets):
    for kv in sets or []:
        k, v = kv.split("=", 1)
        if v in ("True", "true", "False", "false"):
            v = v.lower() == "true"
        elif v.isdigit():
            v = int(v)
        cfg = cfg.with_policy(**{k: v})
    return cfg


def trace_cell(arch, shape, sets=None, mesh_kind="single") -> TraceReport:
    from repro_torch.launch import dryrun
    cfg = apply_overrides(get(arch), sets)
    return dryrun.trace_cell(cfg, SHAPES[shape], mesh_kind)[1]


def attribute(rep: TraceReport, what: str = "coll", top: int = 15
              ) -> List[str]:
    """The ``top`` rows by total bytes: collectives by ring-model link
    bytes (``coll``), or the other ops by operand + result bytes
    (``mem``)."""
    rows = []
    for (op, shapes), (m, each) in rep.rows.items():
        coll = op.startswith("coll:")
        if coll != (what == "coll") or not each:
            continue
        rows.append((m * each, m, each, op.removeprefix("coll:"), shapes))
    rows.sort(key=lambda r: -r[0])
    return [f"{tot/1e9:10.2f}GB  m={m:7.0f} each={each/1e6:9.2f}MB "
            f"{kind:16s} {shapes[-100:]}"
            for tot, m, each, kind, shapes in rows[:top]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--what", default="coll", choices=["coll", "mem"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)
    rep = trace_cell(args.arch, args.shape, args.set)
    print(f"flops={rep.flops:.4g} hbm={rep.hbm_bytes:.4g} "
          f"link={rep.collective_link_bytes:.4g}")
    for line in attribute(rep, args.what, args.top):
        print(line)


if __name__ == "__main__":
    main()
