"""The fake-world dry-run and the trace analysis that stands in for the
reference's HLO analysis.

* The ring model: ``traceanalysis.ring_link_bytes`` ``==`` the
  reference's ``hloanalysis._collective_link_bytes`` for every collective
  kind at group sizes 1, 2, 4 and 16, the reference fed from HLO lines
  this test writes.
* The tracer on a fake world of 4 ranks (a subprocess: a process group
  is global to its process): the per-device FLOPs and the link bytes of
  one sharded product, by hand.
* ``python -m repro_torch.launch.dryrun`` on the cell the reference's
  ``test_dryrun_cell_multi_pod`` runs: full-width qwen3-1.7b
  ``decode_32k`` on the 512-rank multi-pod mesh.  The other families'
  full-width cells take 15-110 s each on an 8-core CPU host, so
  ``chip_smoke.py`` runs them (cut in depth) on the card machine's host.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.launch import hloanalysis as ha
from repro_torch.launch import attribute, hw, traceanalysis
from repro_torch.launch.traceanalysis import TraceReport

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

#: kind -> (output shape, input shape) of the written instruction
SHAPES = {"all-reduce": ("8,16", "8,16"), "all-gather": ("8,{n16}", "8,16"),
          "reduce-scatter": ("8,{d16}", "8,16"),
          "all-to-all": ("8,16", "8,16"),
          "collective-permute": ("8,16", "8,16")}


def _instruction(kind: str, n: int):
    out, inp = (s.format(n16=16 * n, d16=16 // n) for s in SHAPES[kind])
    text = textwrap.dedent(f"""\
        HloModule m

        ENTRY %main (p0: f32[{inp}]) -> f32[{out}] {{
          %p0 = f32[{inp}]{{1,0}} parameter(0)
          ROOT %c = f32[{out}]{{1,0}} {kind}(f32[{inp}]{{1,0}} %p0), replica_groups=[{64 // n},{n}]<=[64], dimensions={{1}}
        }}
        """)
    ins = ha.parse_hlo(text)["__entry__"].instrs[-1]
    assert ins.op == kind
    return ins, out, inp


def _nbytes(dims: str) -> int:
    n = 4
    for d in dims.split(","):
        n *= int(d)
    return n


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_ring_model_matches_the_reference(kind, n):
    ins, out, inp = _instruction(kind, n)
    want_kind, want = ha._collective_link_bytes(ins)
    assert want_kind == kind
    got = traceanalysis.ring_link_bytes(kind, _nbytes(out), _nbytes(inp), n)
    assert got == want


TRACE_SCRIPT = """
import json, sys, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import traceanalysis
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.layers import Backend
from repro_torch.sharding import rules
from repro_torch.sharding.context import P, constrain, use_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_debug_mesh((2, 2), device="cpu")
out = {}
with FakeTensorMode():
    x = rules.distribute(torch.zeros(8, 16, 64), P("data", None, None),
                         mesh)
    for name, spec in (("out_dim", P(None, "model")),
                       ("in_dim", P("model", None))):
        w = rules.distribute(torch.zeros(64, 128), spec, mesh)

        def step(x, w):
            with use_mesh(mesh):
                return constrain(Backend("torch").matmul(x, w),
                                 "batch", None, None)
        _, rep = traceanalysis.trace(step, x, w)
        out[name] = rep.to_dict()
print(json.dumps(out))
"""


def test_tracer_counts_a_sharded_product_per_device():
    """x (8,16,64) on 'data' times w (64,128) on 'model' on a 2x2 fake
    world.  Output-dim sharding: each rank multiplies its (4*16, 64) rows
    by its (64, 64) columns, then gathers y's columns (the constraint to
    replicated).  Input-dim sharding: (4*16, 32) by (32, 128), then an
    all-reduce of the partial (4*16, 128) sums, ring link bytes
    2 * 32 KiB * 1/2."""
    r = subprocess.run([sys.executable, "-c", TRACE_SCRIPT], cwd=ROOT,
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    out, inn = rep["out_dim"], rep["in_dim"]
    assert out["dot_flops"] == 2 * 64 * 64 * 64
    assert out["collectives"]["all-gather"]["count"] == 1
    assert out["collectives"]["all-reduce"]["count"] == 0
    assert out["collective_link_bytes"] == 64 * 128 * 4 / 2
    assert inn["dot_flops"] == 2 * 64 * 32 * 128
    assert inn["collectives"]["all-reduce"]["count"] == 1
    assert inn["collective_link_bytes"] == 2 * 64 * 128 * 4 / 2
    for rep_ in (out, inn):
        assert rep_["unknown_trip_loops"] == 0
        assert rep_["hbm_bytes"] > 0 and rep_["peak_bytes"] > 0
        assert rep_["collective_link_bytes_bf16"] \
            == rep_["collective_link_bytes"]


def test_dryrun_cell_multi_pod():
    """The full-width qwen3-1.7b decode_32k cell on the 512-rank fake
    world: ok, FLOPs counted, the traced per-device peak within the
    card's capacity, and the resident parameter shards exactly the
    memory model's parameter bytes (both divide each leaf by its spec's
    shard count)."""
    out = ROOT / "build" / "repro_torch" / "dryrun" \
        / "qwen3-1.7b.decode_32k.multi.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "multi",
         "--force"], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["flops"] > 0 and rec["step"] == "decode_step"
    assert rec["dot_flops"] > 0 and rec["unknown_trip_loops"] == 0
    assert rec["memory"]["peak_bytes_per_device"] < hw.HBM_BYTES
    assert rec["memory"]["params_bytes"] == rec["memmodel"]["params"]
    assert rec["collectives"]["total_link_bytes"] > 0


def test_apply_overrides_parses_like_the_reference():
    from repro_torch.configs import get
    cfg = attribute.apply_overrides(
        get("qwen3-1.7b"), ["tp_mode=allgather", "fsdp=true", "microbatches=8",
                            "sp=False"])
    p = cfg.policy
    assert (p.tp_mode, p.fsdp, p.microbatches, p.sp) \
        == ("allgather", True, 8, False)


def test_attribute_ranks_rows_by_total_bytes():
    rep = TraceReport(rows={("coll:all-reduce", "[(4, 8)]"): [3, 1e6],
                            ("coll:all-gather", "[(2, 8)]"): [1, 5e6],
                            ("mm", "[(4, 8), (8, 8)]"): [10, 2e6],
                            ("add", "[(4, 8)]"): [1, 1e6]})
    coll = attribute.attribute(rep, "coll")
    assert [line.split()[5] for line in coll] == ["all-gather", "all-reduce"]
    assert coll[0].split()[0] == "0.01GB"
    mem = attribute.attribute(rep, "mem", top=1)
    assert len(mem) == 1 and mem[0].split()[5] == "mm"
