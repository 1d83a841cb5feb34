"""Fake-world dry-run: trace every (arch x shape x mesh) cell's sharded step
at full size in one process (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for 256 or 512 host
devices and reads XLA's partitioned HLO.  There is no XLA compile here,
and this run does not prove one.  What stands in for it: a fake process
group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``) of 256 or 512 ranks, the production mesh over it, and one
run of the step on DTensors of fake tensors (``FakeTensorMode``), so
nothing is allocated and no collective moves data.  The run proves that
the shardings propagate through every op of the step (DTensor raises
where they do not), that every collective is legal on its mesh, and it
measures, per device, what ``launch/traceanalysis`` reads off the local
ops: FLOPs, memory traffic, collectives with ring-model link bytes, the
traced peak of live bytes, and the bytes of the resident local shards.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``build/repro_torch/dryrun/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, all_names, applicable, get
from repro_torch.launch import memmodel, traceanalysis
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.sharding import rules

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "dryrun"


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake process group of ``size`` ranks
    (replacing any fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a "
                               f"{dist.get_backend()} group is initialised")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _inputs(cfg, shape, kind, shapes, specs, mesh):
    """Fake inputs of the step, placed by its specs: each rank's shards
    are cut from a whole fake tensor (no storage exists)."""
    def place(tree, spec):
        return rules.distribute(tree, spec, mesh)

    def zeros(meta):
        dt = torch.long if meta.dtype == torch.int32 else meta.dtype
        return torch.zeros(meta.shape, dtype=dt)

    params = place(lm.init(cfg, None, device="cpu"), specs[0])
    if kind == "train_step":
        opt = adamw.init(lm.init(cfg, None, device="cpu"),
                         adamw.from_policy(cfg.policy))
        batch = {k: zeros(v) for k, v in shapes[2].items()}
        return params, place(opt, specs[1]), place(batch, specs[2])
    if kind == "prefill_step":
        batch = {k: zeros(v) for k, v in shapes[1].items()}
        return params, place(batch, specs[1])
    caches = adamw.tree_map(
        lambda m: torch.zeros(m.shape, dtype=m.dtype), shapes[3])
    return (params, place(zeros(shapes[1]), specs[1]),
            place(zeros(shapes[2]), specs[2]), place(caches, specs[3]))


def trace_cell(cfg, shape, mesh_kind: str):
    """Trace ``cfg``'s step for ``shape`` on the fake world of
    ``mesh_kind``; returns ``(step kind, TraceReport, memory dict, trace
    seconds, mesh axes)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    kind, fn, shapes, specs = steps_mod.make_step_for(cfg, mesh, shape)
    with FakeTensorMode():
        args = _inputs(cfg, shape, kind, shapes, specs, mesh)
        t0 = time.time()
        _, rep = traceanalysis.trace(fn, *args)
        secs = time.time() - t0
        names = {"train_step": ("params", "opt", "batch"),
                 "prefill_step": ("params", "batch"),
                 "decode_step": ("params", "tokens", "positions",
                                 "caches")}[kind]
        memory = {f"{n}_bytes": traceanalysis.local_bytes(a)
                  for n, a in zip(names, args)}
    memory["peak_bytes_per_device"] = rep.peak_bytes
    return kind, rep, memory, secs, axes


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             tp_mode: str | None = None, n_layers: int | None = None
             ) -> dict:
    """One cell on the fake world; ``n_layers`` cuts the depth (the
    record names the depth it ran)."""
    cfg = get(arch)
    if tp_mode:
        cfg = cfg.with_policy(tp_mode=tp_mode)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": why}
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "tp_mode": cfg.policy.tp_mode, "n_layers": cfg.n_layers}
    try:
        kind, rep, memory, secs, axes = trace_cell(cfg, shape, mesh_kind)
        rec["step"] = kind
        rec["trace_s"] = round(secs, 2)
        rec["memory"] = memory
        rec["memmodel"] = memmodel.estimate(cfg, shape, axes)
        rec["flops"] = rep.flops
        rec["dot_flops"] = rep.dot_flops
        rec["hbm_bytes"] = rep.hbm_bytes
        rec["collectives"] = dict(
            rep.collectives,
            total_link_bytes=rep.collective_link_bytes,
            total_link_bytes_bf16=rep.collective_link_bytes_bf16)
        rec["unknown_trip_loops"] = rep.unknown_trip_loops
        rec["ops"] = rep.n_instructions
        rec["ok"] = True
        gc.collect()
    except Exception as e:  # a failure here is a bug in the system
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def cell_path(arch, shape, mesh_kind, tp_mode=None) -> Path:
    tag = f".{tp_mode}" if tp_mode else ""
    return RESULTS_DIR / f"{arch}.{shape}.{mesh_kind}{tag}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tp-mode", default=None,
                    choices=[None, "allreduce", "allgather", "ame_pim"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in all_names() for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            out = cell_path(arch, shape, mk, args.tp_mode)
            if out.exists() and not args.force:
                rec = json.loads(out.read_text())
                status = ("SKIP " + rec.get("skipped", "")) \
                    if "skipped" in rec \
                    else ("ok" if rec.get("ok") else "FAIL(cached)")
                print(f"[cached] {arch} {shape} {mk}: {status}")
                failures += int(not rec.get("ok", True)
                                and "skipped" not in rec)
                continue
            rec = run_cell(arch, shape, mk, args.tp_mode)
            out.write_text(json.dumps(rec, indent=1))
            if "skipped" in rec:
                print(f"{arch} {shape} {mk}: SKIP ({rec['skipped']})")
            elif rec["ok"]:
                mem = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
                print(f"{arch} {shape} {mk}: ok  {rec['step']} "
                      f"flops={rec['flops']:.3g} peak/dev={mem:.2f}GiB "
                      f"link={rec['collectives']['total_link_bytes']:.3g}B "
                      f"(trace {rec['trace_s']}s)", flush=True)
            else:
                failures += 1
                print(f"{arch} {shape} {mk}: FAILED  {rec['error']}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
