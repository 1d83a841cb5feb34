"""The port's SSM family and K4 (ssd_scan) plain path against the JAX
reference on the CPU.

K4: the port's ``ref.ssd_scan`` / ``ref.ssd_chunked[4]`` and
``ops.ssd[4](use_kernel=True)`` on CPU tensors are held against JAX's
``ref.ssd_scan``, ``ssd_chunked_jnp[4]`` and the Pallas ``ssd_scan`` in
interpret mode, over the shapes and tolerances of tests/test_kernels.py.
Model: reduced mamba2-370m, parameters from the reference's ``lm.init``
carried over as numpy arrays; prefill logits and states and three decode
steps, ``backend="torch"`` against XLA and ``"kernel"`` against PALLAS.
The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunked_jnp, ssd_chunked_jnp4
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.launch import hw as jhw
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro.serve.loop import Request as JRequest
from repro.serve.loop import Server as JServer
from repro_torch.configs import get
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd_scan as k4
from repro_torch.launch import hw
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.serve.loop import Request, Server
from repro_torch.serve.traffic import HostCostModel

RNG = np.random.default_rng(42)

#: the reference's tolerances (tests/test_kernels.py:104-105): f32 sums in
#: another order and a chunked vs sequential recurrence; bf16 outputs round
#: to 8 bits of mantissa
SSD_TOL = {"float32": dict(atol=1e-4, rtol=1e-3),
           "bfloat16": dict(atol=0.08, rtol=0.08)}
#: f32 compute, model level: as tests/test_torch_model.py
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: bf16 compute rounds at other places in the two frameworks (silu, for
#: one, lands one bf16 ulp apart), and each rounding is carried through the
#: layers and, in the f32 SSM state, summed over the prompt: the port's bf16
#: run is held to JAX's within the distance of JAX's own bf16 run from its
#: f32 run, per tensor (measured: 0.066 vs 0.108 on prefill logits, 0.25
#: vs 0.37 on a state whose largest value is 17)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the reduced config's chunk is 32: a 40-token prompt crosses it
PROMPT_T, CACHE_LEN, DECODE_STEPS = 40, 48, 3
SSD_SHAPES = [(2, 64, 16, 8, 16), (1, 100, 32, 16, 32), (3, 33, 8, 4, 16),
              (1, 16, 8, 8, 16)]


def pair(shape, dtype, scale=0.5, f=None):
    """The same seeded values as a JAX array and a torch CPU tensor."""
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    if f is not None:
        x = f(x)
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def ssd_inputs(bh, t, p, n, dtype):
    """x, log_a = -|0.2 N(0,1)| (f32), b, c as the reference tests draw
    them; each a (jax, torch) pair."""
    return (pair((bh, t, p), dtype), pair((bh, t), "float32", 0.2, np.abs),
            pair((bh, t, n), dtype), pair((bh, t, n), dtype))


def _neg(pair_):
    j, t = pair_
    return -j, -t


def close(got: torch.Tensor, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


# ---------------------------------------------------------------------------
# K4 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,p,n,chunk", SSD_SHAPES)
def test_ssd_matches_jax(bh, t, p, n, chunk, dtype):
    (jx, tx), jla_tla, (jb, tb), (jc, tc) = ssd_inputs(bh, t, p, n, dtype)
    jla, tla = _neg(jla_tla)
    want = {"recurrence": jax.vmap(jref.ssd_scan)(jx, jla, jb, jc),
            "chunked": ssd_chunked_jnp(jx, jla, jb, jc, chunk=chunk),
            "pallas": jssd_scan(jx, jla, jb, jc, chunk=chunk,
                                interpret=True)}
    got = {"ref.ssd_scan": ref.ssd_scan(tx, tla, tb, tc),
           "ref.ssd_chunked": ref.ssd_chunked(tx, tla, tb, tc, chunk=chunk),
           "ops.ssd kernel": ops.ssd(tx, tla, tb, tc, use_kernel=True,
                                     chunk=chunk),
           "ops.ssd plain": ops.ssd(tx, tla, tb, tc, use_kernel=False,
                                    chunk=chunk)}
    for gname, g in got.items():
        assert g.dtype == TDT[dtype] and g.shape == (bh, t, p), gname
        for wname, w in want.items():
            close(g, w, SSD_TOL[dtype], f"{gname} vs JAX {wname}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd4_matches_jax(dtype):
    bsz, h, t, p, n, chunk = 2, 3, 37, 8, 4, 16
    (jx, tx), jla_tla, (jb, tb), (jc, tc) = ssd_inputs(bsz * h, t, p, n,
                                                       dtype)
    jla, tla = _neg(jla_tla)
    four = (lambda a: a.reshape(bsz, h, *a.shape[1:]))
    want = ssd_chunked_jnp4(four(jx), four(jla), four(jb), four(jc),
                            chunk=chunk)
    want_pallas = four(jssd_scan(jx, jla, jb, jc, chunk=chunk,
                                 interpret=True))
    args = (four(tx), four(tla), four(tb), four(tc))
    for got in (ref.ssd_chunked4(*args, chunk=chunk),
                ops.ssd4(*args, use_kernel=True, chunk=chunk),
                ops.ssd4(*args, use_kernel=False, chunk=chunk)):
        assert got.shape == (bsz, h, t, p) and got.dtype == TDT[dtype]
        close(got, want, SSD_TOL[dtype])
        close(got, want_pallas, SSD_TOL[dtype])


def test_ssd_state_carries_across_chunks():
    """A long-decay sequence: late outputs must see early inputs."""
    bh, t, p, n = 1, 64, 4, 4
    x = np.zeros((bh, t, p), np.float32)
    x[0, 0] = 1.0                                     # impulse at t=0
    log_a = np.full((bh, t), -0.01, np.float32)       # slow decay
    ones = np.ones((bh, t, n), np.float32)
    want = np.asarray(jssd_scan(x, log_a, ones, ones, chunk=16,
                                interpret=True))
    args = [torch.from_numpy(a) for a in (x, log_a, ones, ones)]
    for got in (ops.ssd(*args, use_kernel=True, chunk=16),
                ref.ssd_chunked(*args, chunk=16), ref.ssd_scan(*args)):
        assert float(got[0, -1].abs().max()) > 0.1    # impulse visible
        close(got, want, SSD_TOL["float32"])


def test_cpu_tensor_never_touches_the_ssd_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name!r}")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x, b = torch.randn(2, 9, 4), torch.randn(2, 9, 3)
    la = -torch.rand(2, 9)
    before = k4.launches
    out = ops.ssd(x, la, b, b, use_kernel=True, chunk=4)
    torch.testing.assert_close(out, ref.ssd_chunked(x, la, b, b, chunk=4))
    out4 = ops.ssd4(x[None], la[None], b[None], b[None], use_kernel=True,
                    chunk=4)
    torch.testing.assert_close(out4[0], out)
    assert k4.launches == before


def test_ssd_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("loaded"))
    x = torch.randn(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        k4.ssd_scan(x, torch.zeros(1, 4), x, x)


def test_ssd_smem_claim_fits_a_block():
    # all four operands and the score block of one chunk in f32 at full
    # width (L = N = 128, P = 64) would not fit one block ...
    l, n, p = 128, 128, 64
    whole = 4 * (n * p + l * p + 2 * l * n + l * l)
    assert whole > hw.SMEM_PER_BLOCK
    # ... so the grid splits P; each variant's claim at full width fits
    assert k4.smem_bytes(l, n, variant="fma") == 215_552
    assert k4.smem_bytes() == k4.smem_bytes(l, n, variant="mma") == 198_144
    assert k4.smem_bytes(l, n, x_dtype=torch.bfloat16) == 189_952
    # the fma variant keeps the whole chunk; mma walks 128-row chunks
    assert k4.smem_bytes(256, 128, variant="fma") > hw.SMEM_PER_BLOCK
    assert k4.smem_bytes(256, 128) == k4.smem_bytes(128, 128)
    assert k4.smem_bytes(37, 128) < k4.smem_bytes(128, 128)
    with pytest.raises(ValueError, match="variant"):
        k4.smem_bytes(l, n, variant="wgmma")
    assert "ssd_scan" in _build.sources()


def _serve_scan_operands(t, monkeypatch, batch=1):
    """The operands the full-width mamba2-370m block hands the scan for a
    prompt of ``t`` tokens in bf16 compute (the serve's dtype), caught at
    ``ops.ssd4``."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import TORCH
    cfg = get("mamba2-370m").with_policy(compute_dtype="bfloat16")
    params = ssm.mamba_init(torch.Generator().manual_seed(0), cfg,
                            torch.bfloat16, "cpu")
    seen = []

    def catch(x, log_a, b, c, **kw):
        seen.append((x, log_a, b, c))
        return torch.zeros_like(x)
    monkeypatch.setattr(ops, "ssd4", catch)
    u = torch.randn(batch, t, cfg.d_model).bfloat16()
    ssm.mamba_apply(params, u, cfg, backend=TORCH)
    (x, log_a, b, c), = seen
    return cfg, x, log_a, b, c


@pytest.mark.parametrize("t", [1, 2, 16, 37, 64, 128, 129, 300, 512])
def test_variant_takes_mma_at_every_serve_shape(t, monkeypatch):
    cfg, x, log_a, b, c = _serve_scan_operands(t, monkeypatch)
    s = cfg.ssm
    assert x.shape == (1, 32, t, s.head_dim) and b.shape == (1, 32, t,
                                                              s.d_state)
    assert x.dtype == torch.float32 and b.dtype == c.dtype == torch.bfloat16
    assert k4.variant(x, b, c) == "mma"
    # no copies: x is the (B,T,H,P) product seen transposed, b and c are
    # the conv output's columns expanded over heads (head stride 0)
    assert x.stride() == (t * 32 * s.head_dim, s.head_dim, 32 * s.head_dim, 1)
    assert b.stride(1) == c.stride(1) == 0 and log_a.is_contiguous()
    assert k4.smem_bytes(min(s.chunk, t), s.d_state) <= hw.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,p,n,chunk", SSD_SHAPES)
def test_variant_takes_fma_at_the_reference_shapes(bh, t, p, n, chunk,
                                                   dtype):
    x = torch.zeros(bh, t, p, dtype=TDT[dtype])
    b = torch.zeros(bh, t, n, dtype=TDT[dtype])
    # mma needs bf16 b/c and N a multiple of 16: the reference's N = 16
    # shape in bf16 takes it, its N = 4 / 8 shapes and f32 b/c never do
    mma = dtype == "bfloat16" and n % 16 == 0 and p % 16 == 0
    assert k4.variant(x, b) == ("mma" if mma else "fma")
    assert k4.variant(x, b.float()) == "fma"
    assert k4.variant(x[..., 1:], b) == "fma"        # rows off 16 bytes
    assert k4.smem_bytes(min(chunk, t), n, variant="fma") \
        <= hw.SMEM_PER_BLOCK


@pytest.mark.parametrize("t", [2, 300])
def test_c_args_pass_the_serve_views_strides(t, monkeypatch):
    """The C call sees the model's own strides: x and y (B,H,T,P) read
    out of (B,T,H,P), b and c with head stride 0 and the conv output's
    time stride, log_a contiguous (B,H,T); T is the chunk length cap."""
    cfg, x, log_a, b, c = _serve_scan_operands(t, monkeypatch)
    s = cfg.ssm
    h, conv_dim = 32, s.expand * cfg.d_model + 2 * s.d_state
    out = torch.empty_like(x)
    args = k4.c_args(x, log_a, b, c, out, s.chunk)
    assert len(args) == len(k4.C_ARGTYPES)
    assert args[5:13] == (1, h, t, s.head_dim, s.d_state, min(s.chunk, t),
                          0, 1)
    xs = (t * h * s.head_dim, s.head_dim, h * s.head_dim)
    bs = (t * conv_dim, 0, conv_dim)
    assert tuple(args[13]) == xs + xs + (h * t, t, 1) + bs + bs


def _load_tool(name):
    """tools/<name>.py, loaded by path (tools/ is not a package)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("source,macro,shipped", [
    ("ssd_scan", "SSD_SWEEP_CONFIGS", ("kMmaBlockP", "kMmaStages")),
    ("ame_elementwise", "EW_SWEEP_CONFIGS", ("kThreads", "kVecs"))])
def test_block_sweep_builds_what_it_names(source, macro, shipped):
    """tools/k4_block_sweep.py's lists are the instantiations of its sweep
    sources, and they hold the configuration each wrapper ships (the
    constants of the kernel's own source), which the wrapper names."""
    import re
    tool = _load_tool("k4_block_sweep")
    sweep = (tool.SWEEP_CSRC / f"{source}_sweep.cu").read_text()
    assert f'#include "{source}.cu"' in sweep
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", sweep, re.S).group(1)
    built = tuple((int(a), int(b))
                  for a, b in re.findall(r"X\((\d+), (\d+)\)", body))
    kernel = (_build.CSRC / f"{source}.cu").read_text()
    ship = tuple(int(re.search(rf"constexpr int {c} = (\d+);", kernel)
                     .group(1)) for c in shipped)
    if source == "ssd_scan":
        assert built == tool.K4_CONFIGS
        assert ship == (k4.MMA_BLOCK_P, k4.MMA_STAGES)
    else:
        from repro_torch.kernels import elementwise as k2
        assert built == tool.K2_CONFIGS
        assert ship == k2.PASS
    assert ship in built


def _k4_precision():
    return _load_tool("k4_precision")


@pytest.mark.parametrize("case", range(8))
def test_split_bf16_products_stay_within_the_tolerance(case):
    """The mma kernel's arithmetic (three bf16 planes per f32 operand),
    emulated on the CPU, against the f64 sequential recurrence at the
    reference's shapes and the main path's (2, 300 / 2048, 64, 128), and
    at a slow decay; two planes miss the limit at the slow decay."""
    tool = _k4_precision()
    assert len(tool.CASES) == 8
    errs = tool.errors(tool.CASES[case], torch.Generator().manual_seed(case))
    assert errs["three planes"][1] <= 1.0, errs
    assert errs["plain f32"][1] <= 1.0, errs
    (bh, t, p, n, chunk), xdt, _, decay = tool.CASES[case]
    if decay < 0.1:
        assert errs["two planes"][1] > 1.0, errs


@pytest.mark.parametrize("t,chunk", [(37, 16), (300, 128), (9, 4)])
def test_ssd4_takes_strided_and_expanded_views_bit_for_bit(t, chunk):
    """ops.ssd4 on the model's views (x and log_a transposed out of
    (B,T,H,.), b and c expanded over heads) equals the call on contiguous
    copies bit for bit, on both dtypes of b / c."""
    bsz, h, p, n = 2, 4, 16, 16
    g = torch.Generator().manual_seed(t)
    x = torch.randn(bsz, t, h, p, generator=g)
    la = -torch.rand(bsz, t, h, generator=g)
    for bdt in (torch.float32, torch.bfloat16):
        conv = torch.randn(bsz, t, 3 * n, generator=g).to(bdt)
        b = conv[..., n:2 * n].reshape(bsz, t, 1, n).expand(bsz, t, h, n)
        c = conv[..., 2 * n:].reshape(bsz, t, 1, n).expand(bsz, t, h, n)
        views = (x.transpose(1, 2), la.transpose(1, 2), b.transpose(1, 2),
                 c.transpose(1, 2))
        assert views[2].stride(1) == 0 and not views[0].is_contiguous()
        copies = [v.contiguous() for v in views]
        for use_kernel in (True, False):
            got = ops.ssd4(*views, use_kernel=use_kernel, chunk=chunk)
            want = ops.ssd4(*copies, use_kernel=use_kernel, chunk=chunk)
            assert got.shape == (bsz, h, t, p)
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# reduced mamba2-370m against the reference
# ---------------------------------------------------------------------------


def _setup(compute_dtype="float32"):
    jcfg = jget("mamba2-370m").reduced().with_policy(
        compute_dtype=compute_dtype)
    cfg = get("mamba2-370m").reduced().with_policy(
        compute_dtype=compute_dtype)
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    return jcfg, jp, cfg, params


@pytest.fixture(scope="module")
def f32_models():
    return _setup("float32")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run_both(jcfg, jp, cfg, params, jbackend, backend, steps,
              prompt_t=PROMPT_T):
    """Prefill then ``steps`` decode steps on both sides, both fed JAX's
    greedy tokens; yields (what, jax_out, port_out) pairs."""
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, prompt_t)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         cache_len=CACHE_LEN, backend=jbackend)
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg, cache_len=CACHE_LEN, backend=backend)
    yield "prefill logits", _np(jl), tl
    for name in ("conv", "ssm"):
        yield f"state {name}", _np(jc["ssm_stack"][name]), \
            tc["ssm_stack"][name]
    pos = np.full((2,), prompt_t, np.int32)
    for s in range(steps):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 jcfg, backend=jbackend)
        tl, tc = lm.decode_step(params, torch.from_numpy(nxt).long(),
                                torch.from_numpy(pos).long(), tc, cfg,
                                backend=backend)
        yield f"decode {s} logits", _np(jl), tl
        pos = pos + 1
    for name in ("conv", "ssm"):
        yield f"final state {name}", _np(jc["ssm_stack"][name]), \
            tc["ssm_stack"][name]


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_prefill_and_decode_match_jax(f32_models, backend, jbackend):
    jcfg, jp, cfg, params = f32_models
    assert PROMPT_T > cfg.ssm.chunk
    for what, want, got in _run_both(jcfg, jp, cfg, params, jbackend,
                                     backend, DECODE_STEPS):
        close(got, want, F32_TOL, what)


def test_one_token_prompt_takes_the_recurrence(f32_models, monkeypatch):
    jcfg, jp, cfg, params = f32_models

    def no_scan(*a, **k):
        raise AssertionError("a one-token prefill must not run the scan")
    monkeypatch.setattr(ops, "ssd4", no_scan)
    for what, want, got in _run_both(jcfg, jp, cfg, params, XLA, "kernel",
                                     steps=1, prompt_t=1):
        close(got, want, F32_TOL, what)


def test_bf16_compute_matches_jax():
    jcfg, jp, cfg, params = _setup("bfloat16")
    params = lm.compute_params(params, cfg)
    jcfg32 = jcfg.with_policy(compute_dtype="float32")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT_T)).astype(np.int32)
    pos = np.full((2,), PROMPT_T, np.int32)
    jax_runs = {}
    for name, c in (("bf16", jcfg), ("f32", jcfg32)):
        jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, c,
                             cache_len=CACHE_LEN, backend=XLA)
        jax_runs[name] = [_np(jl), _np(jc["ssm_stack"]["conv"]),
                          _np(jc["ssm_stack"]["ssm"])]
        if name == "bf16":
            nxt = np.argmax(_np(jl), -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 c, backend=XLA)
        jax_runs[name] += [_np(jl), _np(jc["ssm_stack"]["ssm"])]
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg, cache_len=CACHE_LEN, backend="kernel")
    port = [tl.float().numpy(), tc["ssm_stack"]["conv"].float().numpy(),
            tc["ssm_stack"]["ssm"].numpy().copy()]     # updated in place
    tl, tc = lm.decode_step(params, torch.from_numpy(nxt).long(),
                            torch.from_numpy(pos).long(), tc, cfg,
                            backend="kernel")
    port += [tl.float().numpy(), tc["ssm_stack"]["ssm"].numpy()]
    whats = ("prefill logits", "state conv", "state ssm", "decode logits",
             "final state ssm")
    for what, got, want, f32 in zip(whats, port, jax_runs["bf16"],
                                    jax_runs["f32"]):
        rounding = float(np.abs(want - f32).max())
        assert 0 < rounding < 0.05 * float(np.abs(f32).max()), what
        assert float(np.abs(got - want).max()) <= rounding, what


def test_compute_params_casts_only_the_projections(f32_models):
    _, _, cfg, params = f32_models
    cfg = cfg.with_policy(compute_dtype="bfloat16")
    cast = lm.compute_params(params, cfg)
    mamba = cast["stack"]["ssm_stack"]["mamba"]
    for leaf in (mamba["in_proj"]["w"], mamba["out_proj"]["w"],
                 cast["embed"]["table"]):
        assert leaf.dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias"):
        assert mamba[name].dtype == torch.float32, name
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 9)))}
    a, sa = lm.prefill(params, toks, cfg, cache_len=16, backend="kernel")
    b, sb = lm.prefill(cast, toks, cfg, cache_len=16, backend="kernel")
    assert torch.equal(a, b)
    assert torch.equal(sa["ssm_stack"]["ssm"], sb["ssm_stack"]["ssm"])


def test_full_width_shapes_match_reference_without_allocating():
    jshapes = jax.eval_shape(
        lambda: jlm.init(jget("mamba2-370m"), jax.random.PRNGKey(0)))
    meta = lm.init(get("mamba2-370m"), device="meta")
    want = dict(convert.leaves(jshapes))
    got = dict(convert.leaves(meta))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert lm.param_count(meta) == n_ref == 368_494_080


def test_full_width_states_match_reference():
    jcfg, cfg = jget("mamba2-370m"), get("mamba2-370m")
    jst = jax.eval_shape(lambda: jlm.make_caches(jcfg, 4, 512))
    st = lm.make_caches(cfg, 4, 512, device="meta")
    for name in ("conv", "ssm"):
        j, t = jst["ssm_stack"][name], st["ssm_stack"][name]
        assert tuple(t.shape) == tuple(j.shape), name
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), name
    assert tuple(st["ssm_stack"]["ssm"].shape) == (48, 4, 32, 128, 64)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equal_field_by_field(reduced):
    jcfg, cfg = jget("mamba2-370m"), get("mamba2-370m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.vocab_padded == jcfg.vocab_padded == (50432 if not reduced
                                                     else 512)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_server_gives_the_same_tokens_as_jax(f32_models):
    jcfg, jp, cfg, params = f32_models
    cost = HostCostModel(cfg, peak_flops=jhw.PEAK_FLOPS, hbm_bw=jhw.HBM_BW)
    jsrv = JServer(jcfg, jp, slots=2, cache_len=CACHE_LEN)
    srv = Server(cfg, params, slots=2, cache_len=CACHE_LEN, cost=cost,
                 backend="kernel", device="cpu")
    rng = np.random.default_rng(0)
    # one 1-token prompt (recurrence prefill), one across the chunk of 32
    work = [(rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
             int(rng.integers(3, 6))) for plen in (1, 9, 40, 9)]
    for s, cls in ((jsrv, JRequest), (srv, Request)):
        for uid, (prompt, max_new) in enumerate(work):
            s.submit(cls(uid=uid, prompt=prompt, max_new=max_new))
        s.run_until_drained()
    want = {r.uid: r.out_tokens for r in jsrv.completed}
    got = {r.uid: r.out_tokens for r in srv.completed}
    assert len(got) == len(work) and got == want
    assert srv.latency_summary() == jsrv.latency_summary()
