"""Distributed-semantics example (port of ``examples/distributed_train.py``):
the sharded train step of ``launch/steps`` run for real on a small debug
mesh, with sharded params / optimizer / batch, microbatching and both
tensor-parallel dataflows.

  PYTHONPATH=src python -m repro_torch.launch.distributed_train
  PYTHONPATH=src python -m repro_torch.launch.distributed_train --device cpu

Each rank is a process: ``--device cuda`` (the default) runs one rank per
card under ``nccl`` and raises when the machine has fewer cards than the
mesh has ranks; ``--device cpu`` runs D x M ``gloo`` ranks on the host.
Ends with ``distributed_train OK``.
"""
from __future__ import annotations

import argparse
import os
import socket
from typing import List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.loop import batch_to

SHAPE = ShapeSpec("tiny", seq_len=64, global_batch=8, kind="train")
STEPS = 20


def config(tp_mode: str):
    """The example's reduced qwen3, 2 microbatches."""
    return get("qwen3-1.7b").reduced().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512).with_policy(microbatches=2, tp_mode=tp_mode)


def train(mesh, device, tp_mode: str) -> List[float]:
    """``STEPS`` sharded train steps from seeded parameters; every rank
    builds the same parameters and batches and keeps its own shards."""
    cfg = config(tp_mode)
    oc = adamw.AdamWConfig(peak_lr=5e-3, warmup_steps=5, total_steps=50)
    fn, _, (pspec, ospec, bspec) = steps_mod.make_train_step(
        cfg, mesh, SHAPE, opt_cfg=oc)
    params = lm.init(cfg, torch.Generator(device).manual_seed(0), device)
    opt = adamw.init(params, oc)
    params = rules.distribute(params, pspec, mesh)
    opt = rules.distribute(opt, ospec, mesh)
    pipe = SyntheticLM(cfg, SHAPE, seed=0)
    losses = []
    for step in range(STEPS):
        batch = rules.distribute(batch_to(pipe.batch(step), device), bspec,
                                 mesh)
        params, opt, mets = fn(params, opt, batch)
        losses.append(float(mets["loss_out"]))
    return losses


def _worker(rank: int, world: int, shape, device: str, port: int):
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(shape, ("data", "model"), device=device)
        dev = torch.device(device, rank) if device == "cuda" \
            else torch.device("cpu")
        for tp_mode in ("allreduce", "allgather"):
            losses = train(mesh, dev, tp_mode)
            if rank == 0:
                print(f"tp_mode={tp_mode}: loss {losses[0]:.3f} -> "
                      f"{losses[-1]:.3f} on mesh "
                      f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}",
                      flush=True)
            assert losses[-1] < losses[0], losses
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="2x2",
                    help="data x model ranks, e.g. 2x2")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    world = shape[0] * shape[1]
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(
                f"mesh {args.mesh} needs {world} cards (one rank per card "
                f"under nccl); this machine has {cards} — pass --device cpu "
                f"for {world} gloo ranks on the host")
    mp.spawn(_worker, args=(world, shape, args.device, free_port()),
             nprocs=world)
    print("distributed_train OK")


if __name__ == "__main__":
    main()
