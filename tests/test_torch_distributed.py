"""The port's mesh half against the reference's, with real collectives.

Two worlds run side by side, each in processes of its own (a process
group is global to a process; no pytest worker keeps one):

* the reference: a JAX subprocess with 4 host devices and a 2x2
  ``("data", "model")`` mesh of ``AxisType.Auto`` axes, running
  ``repro.launch.steps.make_train_step`` and ``psum_compressed`` under
  ``jax.shard_map``.  (``launch/mesh.make_debug_mesh`` makes Explicit
  axes under jax 0.9, on which the reference's own step fails: ROADMAP
  §3.)
* the port: 4 ``gloo`` ranks on the CPU (``torch.multiprocessing``) and a
  2x2 ``DeviceMesh``, running ``repro_torch.launch.steps``.

Both start from the reference's initialised parameters and read the same
``SyntheticLM`` batches.  Each case's losses and gradient norms must
agree within 1e-5 relative, and each parameter leaf within 1e-4 of its
largest entry (the rules of the training cross-checks), but for at
most 1 in 10^3 entries, which stay within twice the largest distance the
reference itself shows between its 2x2 mesh and one device
(``_params_close``).  The port world also holds its
sharded serve steps against the unsharded ones, counts the MLP's
collectives per tensor-parallel dataflow, reduces with
``psum_compressed`` and restores checkpoints onto the mesh.

This file runs as a script too: ``python tests/test_torch_distributed.py
jax|port DIR`` is one side's worker.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
#: each side's worker process, the whole of it
TIMEOUT = 900
#: (name, arch, tp_mode, microbatches): the example's reduced qwen3 in
#: both dataflows at 1 and 2 microbatches, one MoE and one SSM config
CASES = [("qwen3-ar-1", "qwen3-1.7b", "allreduce", 1),
         ("qwen3-ar-2", "qwen3-1.7b", "allreduce", 2),
         ("qwen3-ag-1", "qwen3-1.7b", "allgather", 1),
         ("qwen3-ag-2", "qwen3-1.7b", "allgather", 2),
         ("mixtral-ar-2", "mixtral-8x22b", "allreduce", 2),
         ("mamba2-ag-2", "mamba2-370m", "allgather", 2)]
STEPS = 3
LOSS_REL = 1e-5
PARAM_REL = 1e-4
#: the share of a leaf's entries that may exceed PARAM_REL against the
#: reference's sharded step (see ``_params_close``; measured at most
#: 6.1e-5 for the port and 9.2e-5 for the reference against itself)
OUTLIERS = 1e-3
#: psum_compressed's mean: the reference's CPU psum of bf16 payloads is an
#: f32 sum rounded once to bf16; gloo adds the 4 payloads in bf16, one
#: rounding per addition.  Each rounding is at most half a bf16 ulp
#: (2^-9 relative) of a partial sum no larger than sum_r |q_r|, so the
#: two sums stand at most 4 * 2^-9 * sum_r |q_r| apart; the means, that
#: over the group size.
PSUM_REL = 4 * 2.0 ** -9
PSUM_SHAPES = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 6)}}


def config(pkg, arch, tp_mode, mb):
    """The case's reduced config in ``pkg`` (``repro`` or
    ``repro_torch``)."""
    import importlib
    cfg = importlib.import_module(pkg + ".configs").get(arch).reduced()
    if arch == "qwen3-1.7b":       # examples/distributed_train.py's
        cfg = cfg.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512)
    else:
        cfg = cfg.replace(n_layers=2)
    return cfg.with_policy(microbatches=mb, tp_mode=tp_mode)


def shape(pkg):
    import importlib
    return importlib.import_module(pkg + ".configs.base").ShapeSpec(
        "tiny", 64, 8, "train")


def opt_config(pkg):
    import importlib
    return importlib.import_module(pkg + ".optim.adamw").AdamWConfig(
        peak_lr=5e-3, warmup_steps=5, total_steps=50)


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], p))
        else:
            out[p] = tree[k]
    return out


def unflat(d):
    tree = {}
    for path, v in d.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def psum_inputs(rank):
    """Rank ``rank``'s gradients (f32) and error-feedback residuals
    (bf16 values, as f32 arrays), seeded."""
    rng = np.random.default_rng(100 + rank)

    def make(shapes, scale):
        return {k: make(v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in shapes.items()}
    return make(PSUM_SHAPES, 0.3), make(PSUM_SHAPES, 1e-3)


# ---------------------------------------------------------------------------
# the reference's side (a JAX subprocess with 4 host devices)
# ---------------------------------------------------------------------------


def jax_worker(work: Path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as JP
    from repro.data.pipeline import SyntheticLM
    from repro.launch import steps
    from repro.optim import adamw, compression
    from repro.sharding import rules

    assert len(jax.devices()) >= 4
    out = {}
    for name, arch, tp, mb in CASES:
        cfg = config("repro", arch, tp, mb)
        oc = opt_config("repro")
        # the 2x2 mesh, and one device: the reference's own distance
        # between two partitionings of the same step
        for tag, grid in (("jax", (2, 2)), ("jax1", (1, 1))):
            mesh = jax.make_mesh(grid, ("data", "model"),
                                 devices=jax.devices()[:grid[0] * grid[1]],
                                 axis_types=(AxisType.Auto,) * 2)
            fn, _, (pspec, ospec, bspec) = steps.make_train_step(
                cfg, mesh, shape("repro"), opt_cfg=oc)
            init = dict(np.load(work / f"{name}.init.npz"))
            params = jax.tree.map(jnp.asarray, unflat(init))
            params = jax.device_put(params, rules.to_named(pspec, mesh))
            opt = jax.device_put(adamw.init(params, oc),
                                 rules.to_named(ospec, mesh))
            pipe = SyntheticLM(cfg, shape("repro"), seed=0)
            losses, norms = [], []
            for step in range(STEPS):
                batch = jax.device_put(
                    {k: jnp.asarray(v) for k, v in pipe.batch(step).items()},
                    rules.to_named(bspec, mesh))
                params, opt, mets = fn(params, opt, batch)
                losses.append(float(mets["loss_out"]))
                norms.append(float(mets["grad_norm"]))
            np.savez(work / f"{name}.{tag}.npz",
                     **{k: np.asarray(v) for k, v in flat(params).items()})
            if tag == "jax":
                out[name] = {"losses": losses, "grad_norms": norms}
    # psum_compressed over a 4-device 'pod' axis
    pod = jax.make_mesh((4,), ("pod",), devices=jax.devices()[:4],
                        axis_types=(AxisType.Auto,))
    ins = [psum_inputs(r) for r in range(4)]
    g = jax.tree.map(lambda *x: jnp.stack(x), *[i[0] for i in ins])
    ef = jax.tree.map(lambda *x: jnp.stack(x).astype(jnp.bfloat16),
                      *[i[1] for i in ins])

    def body(g, ef):
        g = jax.tree.map(lambda x: x[0], g)
        ef = jax.tree.map(lambda x: x[0], ef)
        mean, ef2 = compression.psum_compressed(g, ef, axis="pod")
        return mean, jax.tree.map(lambda x: x[None], ef2)
    mean, ef2 = jax.jit(jax.shard_map(
        body, mesh=pod, in_specs=(JP("pod"), JP("pod")),
        out_specs=(JP(), JP("pod"))))(g, ef)
    np.savez(work / "psum.jax.npz",
             **{"mean/" + k: np.asarray(v) for k, v in flat(mean).items()},
             **{"ef/" + k: np.asarray(v.astype(jnp.float32))
                for k, v in flat(ef2).items()})
    (work / "jax.json").write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# the port's side (4 gloo ranks)
# ---------------------------------------------------------------------------


class Allocations:
    """A dispatch mode that sums the bytes of every plain tensor's storage
    an op creates (a view or an in-place op creates none)."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                seen = {a.untyped_storage().data_ptr()
                        for a in torch.utils._pytree.tree_leaves(
                            (args, kwargs))
                        if type(a) is torch.Tensor}
                for o in torch.utils._pytree.tree_leaves(out):
                    if type(o) is torch.Tensor and \
                            o.untyped_storage().data_ptr() not in seen:
                        counter.bytes += o.untyped_storage().nbytes()
                return out

        self.bytes, self._mode = 0, Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _port_rank(rank, world, port, work):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.base import Policy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import convert, layers
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw, compression
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.loop import batch_to, make_step, trainable

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
    res = {"train": {}, "serve": {}, "dataflow": {}, "restore": {}}

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    for name, arch, tp, mb in CASES:
        cfg = config("repro_torch", arch, tp, mb)
        oc = opt_config("repro_torch")
        init = dict(np.load(work / f"{name}.init.npz"))
        fn, _, (pspec, ospec, bspec) = steps.make_train_step(
            cfg, mesh, shape("repro_torch"), opt_cfg=oc)
        params = convert.params_from_jax(unflat(init), cfg, device="cpu")
        p = rules.distribute(params, pspec, mesh)
        o = rules.distribute(adamw.init(params, oc), ospec, mesh)
        pipe = SyntheticLM(cfg, shape("repro_torch"), seed=0)
        losses, norms, t0 = [], [], time.time()
        for step in range(STEPS):
            b = rules.distribute(batch_to(pipe.batch(step), "cpu"), bspec,
                                 mesh)
            p, o, mets = fn(p, o, b)
            losses.append(float(mets["loss_out"]))
            norms.append(float(mets["grad_norm"]))
        secs = time.time() - t0
        final = {k: full(v).numpy() for k, v in flat(p).items()}
        # the port's unsharded step from the same start
        up = trainable(convert.params_from_jax(unflat(init), cfg, "cpu"))
        uo = adamw.init(up, oc)
        ustep = make_step(cfg, oc, "cpu")
        ulosses = []
        for step in range(STEPS):
            up, uo, umets = ustep(up, uo, pipe.batch(step))
            ulosses.append(float(umets["loss"]))
        if rank == 0:
            np.savez(work / f"{name}.port.npz", **final)
            np.savez(work / f"{name}.unsharded.npz",
                     **{k: v.detach().numpy() for k, v in flat(up).items()})
            res["train"][name] = {"losses": losses, "grad_norms": norms,
                                  "unsharded": ulosses, "seconds": secs}

    # the sharded serve steps against the unsharded ones; "routed" is the
    # kernel backend with the decode attention kernel's route taken, a
    # stand-in for the kernel (chunked_attention on what it is handed)
    # recording the shards it gets
    import contextlib
    from unittest import mock
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import attention
    handed = []

    def stand_in(q, k, v, kpos, qpos):
        handed.append({"dtensor": any(isinstance(t, DTensor)
                                      for t in (q, k, v, kpos, qpos)),
                       "q": list(q.shape), "k": list(k.shape),
                       "kpos": list(kpos.shape), "qpos": list(qpos.shape)})
        return attention.chunked_attention(q, k, v, causal=True,
                                           q_offset=qpos, kv_positions=kpos)

    def serve_steps(cfg, params, tok, backend):
        pf, _, psp = steps.make_prefill_step(
            cfg, mesh, ShapeSpec("p", 16, 4, "prefill"), backend=backend)
        df, _, dsp = steps.make_decode_step(
            cfg, mesh, ShapeSpec("d", 16, 4, "decode"), backend=backend)
        dp = rules.distribute(params, psp[0], mesh)
        with torch.no_grad():
            ref, rc = lm.prefill(params, {"tokens": tok}, cfg,
                                 cache_len=16, backend=backend)
        got, cc = pf(dp, rules.distribute({"tokens": tok}, psp[1], mesh))
        got = full(got)
        errs, same = [float((got - ref).abs().max())], True
        for i in range(4):
            nt, ntd = ref.argmax(-1), got.argmax(-1)
            same &= bool(torch.equal(nt, ntd))
            pos = torch.full((4,), 12 + i, dtype=torch.long)
            with torch.no_grad():
                ref, rc = lm.decode_step(params, nt[:, None], pos, rc,
                                         cfg, backend=backend)
            got, cc = df(dp, rules.distribute(ntd[:, None], dsp[1], mesh),
                         rules.distribute(pos, dsp[2], mesh),
                         cc)
            got = full(got)
            errs.append(float((got - ref).abs().max()))
        same &= bool(torch.equal(ref.argmax(-1), got.argmax(-1)))
        return {"errs": errs, "tokens": same}

    for tp in ("allreduce", "allgather"):
        cfg = config("repro_torch", "qwen3-1.7b", tp, 1)
        params = convert.params_from_jax(
            unflat(dict(np.load(work / "qwen3-ar-1.init.npz"))), cfg, "cpu")
        tok = torch.randint(0, cfg.vocab_size, (4, 12),
                            generator=torch.Generator().manual_seed(3))
        for route in ("torch", "kernel", "routed"):
            backend = "torch" if route == "torch" else "kernel"
            del handed[:]
            with contextlib.ExitStack() as patches:
                if route == "routed":
                    patches.enter_context(mock.patch.object(
                        attention, "takes_decode_kernel", lambda *t: True))
                    patches.enter_context(mock.patch.object(
                        attention, "decode_attention", stand_in))
                res["serve"][f"{tp}-{route}"] = {
                    **serve_steps(cfg, params, tok, backend),
                    "handed": list(handed)}

    # the MLP's collectives per dataflow (one forward, no gradient)
    for tp in ("allreduce", "allgather"):
        cfg = config("repro_torch", "qwen3-1.7b", tp, 1)
        gen = torch.Generator().manual_seed(5)
        mp = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                             torch.float32, "cpu")
        spec = rules.param_pspecs(cfg, {"mlp": mp}, mesh)
        dmp = rules.distribute({"mlp": mp}, spec, mesh)["mlp"]
        x = torch.randn(8, 16, cfg.d_model, generator=gen)
        dx = rules.distribute(x, rules.P("data", None, None), mesh)
        for backend in ("torch", "kernel"):
            comm = CommDebugMode()
            with torch.no_grad(), use_mesh(mesh), comm:
                y = layers.mlp(dmp, dx, cfg.act, layers.Backend(backend),
                               policy=Policy(tp_mode=tp))
            counts = {str(k).split(".")[-1].rstrip("'>"): v
                      for k, v in comm.get_comm_counts().items()}
            want = layers.mlp(mp, x, cfg.act, layers.Backend(backend))
            res["dataflow"][f"{tp}-{backend}"] = {
                "counts": counts, "placements": [str(q) for q in y.placements],
                "err": float((full(y) - want).abs().max())}

    # psum_compressed over the world
    g, ef = psum_inputs(rank)
    tg = adamw.tree_map(torch.from_numpy, g)
    tef = adamw.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), ef)
    mean, ef2 = compression.psum_compressed(tg, tef)
    np.savez(work / f"psum.port.{rank}.npz",
             **{"mean/" + k: v.numpy() for k, v in flat(mean).items()},
             **{"ef/" + k: v.float().numpy() for k, v in flat(ef2).items()})

    # restore_sharded: a port checkpoint and a reference f32 checkpoint;
    # the bytes each rank allocates while placing the restored host leaves
    cfg = config("repro_torch", "qwen3-1.7b", "allreduce", 1)
    template = lm.init(cfg, None, device="meta")
    pl = rules.to_placements(rules.param_pspecs(cfg, template, mesh), mesh)
    for kind in ("port", "jax"):
        mgr = CheckpointManager(work / f"ckpt_{kind}")
        host = mgr.restore(template)
        mgr.restore = lambda template, step=None: host
        with Allocations() as alloc:
            placed, meta = mgr.restore_sharded(template, pl, mesh)
        saved = dict(np.load(work / f"ckpt_{kind}" / f"step_{meta['step']:08d}"
                             / "arrays.npz"))
        ok = all(np.array_equal(full(v).numpy(), saved[k])
                 for k, v in flat(placed).items())
        shards = sorted({str(v.placements) for v in flat(placed).values()})
        local = sum(v.to_local().numel() * v.element_size()
                    for v in flat(placed).values())
        whole = sum(v.nbytes for v in saved.values())
        moved = [None] * world
        dist.all_gather_object(moved, (alloc.bytes, local))
        res["restore"][kind] = {"equal": ok, "placements": shards,
                                "bytes": moved, "whole": whole}
    if rank == 0:
        (work / "port.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def port_worker(work: Path):
    import torch.multiprocessing as mp
    from repro_torch.launch.distributed_train import free_port
    mp.spawn(_port_rank, args=(4, free_port(), work), nprocs=4)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _write_inputs(work: Path):
    """The reference's initial parameters of every case, and one
    checkpoint of each package."""
    import jax
    import torch
    from repro.checkpoint.ckpt import CheckpointManager as JCkpt
    from repro.models import model as jlm
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.models import model as lm

    for name, arch, tp, mb in CASES:
        p = jlm.init(config("repro", arch, tp, mb), jax.random.PRNGKey(0))
        np.savez(work / f"{name}.init.npz",
                 **{k: np.asarray(v) for k, v in flat(p).items()})
    cfg = config("repro_torch", "qwen3-1.7b", "allreduce", 1)
    mgr = CheckpointManager(work / "ckpt_port")
    mgr.save(3, lm.init(cfg, torch.Generator().manual_seed(7), "cpu"))
    mgr.wait()
    jcfg = config("repro", "qwen3-1.7b", "allreduce", 1)
    jm = JCkpt(str(work / "ckpt_jax"))
    jm.save(5, jlm.init(jcfg, jax.random.PRNGKey(9)))
    jm.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = tmp_path_factory.mktemp("worlds")
    _write_inputs(work)
    me = str(Path(__file__).resolve())
    jenv = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen(
        [sys.executable, me, side, str(work)], cwd=ROOT,
        env=jenv if side == "jax" else ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for side in ("jax", "port")}
    logs = {}
    for side, proc in procs.items():
        try:
            logs[side] = proc.communicate(timeout=TIMEOUT)[0]
        finally:
            proc.kill()
        assert proc.returncode == 0, f"{side} world:\n" + logs[side][-4000:]
    return (work, json.loads((work / "jax.json").read_text()),
            json.loads((work / "port.json").read_text()))


def _params_close(want: dict, got: dict, own: dict | None = None):
    """Each leaf within ``PARAM_REL`` of its largest entry (the training
    cross-checks' rule).

    Given ``own``, the reference's own run on one device, isolated
    entries may stray further: AdamW divides each gradient entry by its
    running RMS plus eps = 1e-8, so an entry whose gradient is near eps,
    or is a sum that cancels, moves by a sizeable part of the learning
    rate on a change of summation order alone.  The reference itself
    moves up to 3e-3 of a leaf's scale between its 2x2 mesh and one
    device, on 1 entry in 10^4 or fewer.  So then at most
    ``OUTLIERS`` of a leaf's entries may exceed ``PARAM_REL``, and none
    may exceed twice the reference's own largest distance relative to
    its leaf's scale."""
    assert sorted(want) == sorted(got)
    bound = PARAM_REL
    if own is not None:
        bound = max(bound, 2 * max(
            float(np.abs(own[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want))
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = np.abs(got[k] - want[k])
        frac = float((err > PARAM_REL * scale).mean())
        assert frac <= (OUTLIERS if own is not None else 0), (k, frac)
        assert float(err.max()) <= bound * scale, (k, err.max(), scale)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_train_step_matches_the_references(worlds, name):
    """3 steps on the 2x2 mesh against the reference's own sharded step:
    losses and gradient norms within 1e-5 relative, parameters as
    :func:`_params_close` says."""
    work, jres, pres = worlds
    np.testing.assert_allclose(pres["train"][name]["losses"],
                               jres[name]["losses"], rtol=LOSS_REL)
    np.testing.assert_allclose(pres["train"][name]["grad_norms"],
                               jres[name]["grad_norms"], rtol=LOSS_REL)
    _params_close(dict(np.load(work / f"{name}.jax.npz")),
                  dict(np.load(work / f"{name}.port.npz")),
                  dict(np.load(work / f"{name}.jax1.npz")))


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[3] == 1])
def test_sharded_train_step_matches_the_unsharded_step(worlds, name):
    """At one microbatch the sharded step computes what the port's
    single-device ``make_step`` does."""
    work, _, pres = worlds
    r = pres["train"][name]
    np.testing.assert_allclose(r["losses"], r["unsharded"], rtol=LOSS_REL)
    _params_close(dict(np.load(work / f"{name}.unsharded.npz")),
                  dict(np.load(work / f"{name}.port.npz")))


@pytest.mark.parametrize("case", ["allreduce-torch", "allreduce-kernel",
                                  "allgather-torch", "allgather-kernel",
                                  "allreduce-routed", "allgather-routed"])
def test_sharded_serve_steps_match_the_unsharded_ones(worlds, case):
    """Prefill and 4 decode steps on the mesh (the kernel backend runs
    K1's plain version on each rank's local shards; the routed cases take
    the decode attention kernel's route, a stand-in attending): logits
    within 1e-5 and the same tokens."""
    r = worlds[2]["serve"][case]
    assert max(r["errs"]) <= 1e-5, r["errs"]
    assert r["tokens"]


@pytest.mark.parametrize("tp", ["allreduce", "allgather"])
def test_sharded_decode_hands_the_kernel_local_shards(worlds, tp):
    """Where the KV heads divide the model axis, the sharded decode hands
    the decode attention kernel each rank's local shards as plain
    tensors: half the 4 slots (batch on 'data') and half the 2 KV heads
    with their whole groups of query heads (heads on 'model'), once a
    layer a step, as the unsharded decode hands it the whole; the plain
    routes never reach it."""
    cfg = config("repro_torch", "qwen3-1.7b", tp, 1)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    serve = worlds[2]["serve"]
    assert serve[f"{tp}-torch"]["handed"] == []
    assert serve[f"{tp}-kernel"]["handed"] == []
    handed = serve[f"{tp}-routed"]["handed"]
    assert not any(c["dtensor"] for c in handed)
    whole = {"q": [4, 1, h, d], "k": [4, 16, hkv, d], "kpos": [4, 16],
             "qpos": [4]}
    local = {"q": [2, 1, h // 2, d], "k": [2, 16, hkv // 2, d],
             "kpos": [2, 16], "qpos": [2]}
    shapes = [{key: c[key] for key in whole} for c in handed]
    assert shapes.count(whole) == shapes.count(local) == 4 * cfg.n_layers
    assert len(shapes) == 8 * cfg.n_layers


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_mlp_dataflow_collectives(worlds, backend):
    """Under ``allgather`` the MLP forward issues no all-reduce (its
    hidden is all-gathered, its output stays sharded on 'model'); under
    ``allreduce`` the down-projection's partial sums are all-reduced
    once."""
    res = worlds[2]["dataflow"]
    ag, ar = res[f"allgather-{backend}"], res[f"allreduce-{backend}"]
    assert ag["counts"].get("all_reduce", 0) == 0, ag
    assert ag["counts"].get("all_gather_into_tensor", 0) == 1, ag
    assert ag["placements"] == [str(Shard(0)), str(Shard(2))], ag
    assert ar["counts"].get("all_reduce", 0) == 1, ar
    assert ar["placements"] == [str(Shard(0)), str(Replicate())], ar
    assert ag["err"] <= 1e-5 and ar["err"] <= 1e-5, (ag, ar)


def test_psum_compressed_matches_the_reference(worlds):
    """Residuals ``==``; the mean within ``PSUM_REL`` of the magnitudes'
    sum over the group size."""
    work = worlds[0]
    want = dict(np.load(work / "psum.jax.npz"))
    ins = [psum_inputs(r) for r in range(4)]
    for r in range(4):
        got = dict(np.load(work / f"psum.port.{r}.npz"))
        for k in flat(PSUM_SHAPES):
            np.testing.assert_array_equal(got["ef/" + k],
                                          want["ef/" + k][r])
            mag = sum(np.abs(flat(i[0])[k] + flat(i[1])[k]) for i in ins)
            err = np.abs(got["mean/" + k] - want["mean/" + k])
            assert np.all(err <= PSUM_REL * mag / 4), (k, err.max())


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_restore_sharded_places_every_leaf(worlds, kind):
    """A port checkpoint and a reference f32 checkpoint restore onto the
    2x2 mesh; every leaf's ``full_tensor()`` ``==`` the saved array."""
    r = worlds[2]["restore"][kind]
    assert r["equal"]
    assert any("Shard" in p for p in r["placements"])


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_restore_sharded_moves_only_local_shards(worlds, kind):
    """Each rank allocates exactly the bytes of its own shards while it
    places the restored leaves (each chunk is cut on the host, then
    copied), less than the checkpoint's whole."""
    r = worlds[2]["restore"][kind]
    for allocated, local in r["bytes"]:
        assert allocated == local
        assert local < r["whole"]


def test_distributed_train_cli_on_four_gloo_ranks():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed_train",
         "--device", "cpu"], cwd=ROOT, env=ENV, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "tp_mode=allreduce" in r.stdout and "tp_mode=allgather" in r.stdout
    assert "distributed_train OK" in r.stdout


def test_distributed_train_refuses_more_ranks_than_cards():
    """``--device cuda`` needs one card per rank; it never falls back to
    the CPU."""
    import torch
    from repro_torch.launch import distributed_train
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"needs {cards + 1} cards"):
        distributed_train.main(["--device", "cuda", "--mesh",
                                f"{cards + 1}x1"])


if __name__ == "__main__":
    side, work = sys.argv[1], Path(sys.argv[2])
    jax_worker(work) if side == "jax" else port_worker(work)
