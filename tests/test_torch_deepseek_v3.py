"""DeepSeek-V3's published routing, its share of the experts and YaRN in
the port, against transcriptions of the published equations and against
the benchmark's plain reference (``portbench/reference/mla_moe.py``).

The configuration is the benchmark's (``portbench/configs/deepseek-v3.json``)
at small widths and the port's f32 policy: 3 dense and 4 MoE layers, 16
experts in 4 groups (top-2 groups, top-4 experts, 2.5 x the normalised
weights), 4 of them held here, YaRN factor 40 over 32 original positions
so that the ramp falls inside the 8 rope frequencies.
"""
import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import port, weights  # noqa: E402
from portbench.reference import mla_moe  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.base import MLAConfig, MoEConfig  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402
from repro_torch.serve.loop import Request, Server  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "deepseek-v3.json"


def small_cfg(**moe_kw) -> dict:
    """The benchmark's configuration at small widths, f32."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
               vocab_size=512, param_dtype="float32",
               compute_dtype="float32")
    cfg["moe"] = dict(cfg["moe"], num_experts=16, top_k=4, d_ff_expert=32,
                      n_group=4, topk_group=2, held=4, held_from=4,
                      **moe_kw)
    cfg["mla"] = dict(cfg["mla"], q_lora_rank=32, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16,
                      yarn_original_len=32)
    return cfg


def loop_route(s, c, n_group, topk_group, top_k, scale):
    """The routing equations one token at a time, on the sigmoid scores
    ``s`` and the biased scores ``c`` (lists of rows)."""
    idx, wts = [], []
    for srow, crow in zip(s, c):
        size = len(crow) // n_group
        group = [sum(sorted(crow[g * size:(g + 1) * size],
                            reverse=True)[:2]) for g in range(n_group)]
        keep = sorted(range(n_group), key=lambda g: (-group[g], g))
        keep = set(keep[:topk_group])
        cand = [i for i in range(len(crow)) if i // size in keep]
        chosen = sorted(cand, key=lambda i: (-crow[i], i))[:top_k]
        tot = sum(srow[i] for i in chosen)
        idx.append(chosen)
        wts.append([srow[i] / tot * scale for i in chosen])
    return idx, wts


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
def test_routing_matches_a_per_token_loop(ties):
    """Group masking, the top-k and the weights; with ``ties`` the logits
    and the bias take a few values only, so groups and experts tie and
    the lower index must come first."""
    cfg = port.arch(small_cfg())
    g = torch.Generator().manual_seed(7)
    n, e = 64, cfg.moe.num_experts
    if ties:
        vals = torch.tensor([-1.0, 0.0, 0.5, 1.0])
        logits = vals[torch.randint(0, 4, (n, e), generator=g)]
        bias = torch.tensor([0.0, 0.25])[torch.randint(0, 2, (e,),
                                                       generator=g)]
    else:
        logits = torch.randn(n, e, generator=g)
        bias = 0.1 * torch.randn(e, generator=g)
    w, idx = moe.route_sigmoid(logits, bias, cfg)
    s = torch.sigmoid(logits)
    want_idx, want_w = loop_route(s.tolist(), (s + bias).tolist(),
                                  cfg.moe.n_group, cfg.moe.topk_group,
                                  cfg.moe.top_k, cfg.moe.routed_scale)
    assert idx.tolist() == want_idx
    # f32 against the loop's float64 sums: a few ulps
    assert np.allclose(w.numpy(), np.array(want_w), rtol=1e-6, atol=0)
    # the chosen experts lie in topk_group groups
    groups = (idx // (e // cfg.moe.n_group)).tolist()
    assert all(len(set(r)) <= cfg.moe.topk_group for r in groups)
    if ties:            # the rows do hold equal scores
        assert all(len(set(r)) < len(r) for r in (s + bias).tolist())


@pytest.mark.parametrize("t", [1, 9], ids=["decode", "prefill"])
def test_expert_shares_add_up_to_the_uncut_layer(t):
    """4 shares of 4 experts each: the layer's outputs less the shared
    expert's, summed over the shares, plus the shared expert once, are
    the uncut layer's (``held`` 0: all 16), in both forms (a decode step
    of 6 rows runs every held expert over every row; a prefill of 9
    tokens gathers each expert's rows)."""
    base = port.arch(small_cfg())
    full = base.replace(moe=MoEConfig(**{**vars(base.moe), "held": 0,
                                         "held_from": 0}))
    p = lm.init(full, torch.Generator().manual_seed(3), device="cpu")
    lp = layer(p["stack"]["moe_stack"]["moe"], 3)
    lp["router"]["bias"] = 0.1 * torch.randn(16, generator=torch.Generator()
                                             .manual_seed(4))
    x = torch.randn(6 if t == 1 else 1, t, full.d_model,
                    generator=torch.Generator().manual_seed(5))
    want = moe.moe_sigmoid(lp, x, full)
    shared = moe.mlp(lp["shared"], x, full.act)
    total = shared.clone()
    for k in range(4):
        cfg = full.replace(moe=MoEConfig(**{**vars(full.moe), "held": 4,
                                            "held_from": 4 * k}))
        share = dict(lp, experts={n: w[4 * k:4 * k + 4]
                                  for n, w in lp["experts"].items()})
        total += moe.moe_sigmoid(share, x, cfg) - shared
    assert torch.allclose(total, want, atol=1e-5, rtol=1e-5)
    # the share held here is a part: without the other shares it differs
    assert not torch.allclose(moe.moe_sigmoid(
        dict(lp, experts={n: w[4:8] for n, w in lp["experts"].items()}),
        x, base), want, atol=1e-3)


def test_a_share_needs_the_sigmoid_routing():
    cfg = get("deepseek-v3-671b").reduced()
    with pytest.raises(ValueError, match="sigmoid"):
        lm.init(cfg.replace(moe=MoEConfig(**{**vars(cfg.moe), "held": 2})),
                device="meta")


def _hf_yarn(dim, base, factor, orig, beta_fast, beta_slow):
    """Hugging Face's ``DeepseekV3YarnRotaryEmbedding`` frequencies,
    transcribed: yarn_find_correction_range, yarn_linear_ramp_mask."""
    def find_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))
    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)
    hi = high + 0.001 if low == high else high
    ramp = [min(max((i - low) / (hi - low), 0.0), 1.0)
            for i in range(dim // 2)]
    extra = [1.0 / base ** (2 * i / dim) for i in range(dim // 2)]
    mask = [1.0 - r for r in ramp]
    return [e / factor * (1 - m) + e * m for e, m in zip(extra, mask)]


def test_yarn_frequencies_and_mscale_match_the_published_rule():
    m = port.arch(json.loads(CONFIG.read_text())).mla
    assert (m.yarn_factor, m.yarn_original_len, m.yarn_beta_fast,
            m.yarn_beta_slow, m.yarn_mscale_all_dim) \
        == (40.0, 4096, 32.0, 1.0, 1.0)
    got = attention.yarn_freq(m, 10000.0, torch.device("cpu"))
    want = _hf_yarn(64, 10000.0, 40.0, 4096, 32, 1)
    # f32 against float64: rounding of a frequency
    assert np.allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # dims 0-9 kept, 23-31 interpolated (divided by 40), a ramp between
    assert got[0] == 1.0 and np.isclose(float(got[31]), want[31])
    assert np.isclose(want[31], 10000.0 ** (-62 / 64) / 40)
    assert math.isclose(attention.yarn_mscale(40.0, 1.0),
                        0.1 * math.log(40) + 1)
    assert round(attention.yarn_mscale(40.0, 1.0), 5) == 1.36889
    ref_freq, ref_m = mla_moe.yarn(dataclass_dict(m), 10000.0, 64)
    assert np.allclose(ref_freq.numpy(), want, rtol=1e-12)
    assert ref_m == attention.yarn_mscale(40.0, 1.0)
    # without YaRN the port's plain RoPE is untouched
    assert attention.yarn_freq(MLAConfig(), 1e4, torch.device("cpu")) is None
    assert attention.yarn_mscale(1.0, 1.0) == 1.0


def dataclass_dict(m):
    return {k: getattr(m, k) for k in vars(m)}


def _served_logits(cfg_dict, w, prompts, max_new, slots):
    """Serve ``prompts`` through ``Server(backend="kernel")`` on the CPU;
    returns each request and its logits: the prefill's, then one row a
    decode step, read from the model's calls."""
    a = port.arch(cfg_dict)
    logits = {}
    box = {"prefills": []}
    prefill, decode = lm.prefill, lm.decode_step

    def keep_prefill(*args, **kw):
        out = prefill(*args, **kw)
        box["prefills"].append(out[0][0])
        return out

    def keep_decode(params, tokens, positions, caches, cfg, backend=None):
        srv = box["srv"]
        live = [(i, srv.active[i].uid) for i in range(srv.slots)
                if srv.active[i] is not None]
        out = decode(params, tokens, positions, caches, cfg, backend=backend)
        for i, uid in live:
            logits[uid].append(out[0][i])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "prefill", keep_prefill)
        mp.setattr(lm, "decode_step", keep_decode)
        srv = box["srv"] = Server(a, w, slots=slots, cache_len=64,
                                  backend="kernel", device="cpu")
        reqs = [Request(uid=u, prompt=p, max_new=max_new)
                for u, p in enumerate(prompts)]
        orig_admit = srv._admit

        def admit():        # slots fill in order, one prefill each
            before = {r.uid for r in srv.active if r is not None}
            orig_admit()
            for r in srv.active:
                if r is not None and r.uid not in before:
                    logits[r.uid] = [box["prefills"].pop(0)]
        srv._admit = admit
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
    return reqs, {u: torch.stack(v) for u, v in logits.items()}


@pytest.fixture(scope="module")
def served_small():
    cfg = small_cfg()
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), 11, "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 23, 12, 31, 8)]
    reqs, logits = _served_logits(cfg, w, prompts, max_new=9, slots=3)
    return cfg, w, reqs, logits


def _reference(cfg, w, req, prec):
    seq = torch.as_tensor(np.concatenate([req.prompt, req.out_tokens[:-1]]),
                          dtype=torch.long)
    return mla_moe.forward(w, cfg, seq, slice(len(req.prompt) - 1, None),
                           prec)


#: f32 logits of the port (absorbed MLA over the latent cache, experts in
#: their decode or prefill form) against the reference's full forward
#: (expanded MLA, gathered experts): the same arithmetic summed in
#: another order, so a few f32 ulps of the largest logit (1.3-1.9e-6
#: relative over these five requests); the float8 control reads 0.24-0.42
REL_TOL = 2e-5


def test_served_model_matches_the_reference(served_small):
    """A small DeepSeek-V3-shaped model (3 dense and 4 MoE layers, the
    published routing over a held share, YaRN) through ``Server``: every
    prefill and decode logit of every request against the reference's
    full forward over the prompt and the served tokens."""
    cfg, w, reqs, logits = served_small
    assert len(reqs) == 5 and all(len(r.out_tokens) == 9 for r in reqs)
    worst = 0.0
    for r in reqs:
        got = logits[r.uid][:, :cfg["vocab_size"]]
        want = _reference(cfg, w, r, "f32")
        assert got.shape == want.shape == (9, cfg["vocab_size"])
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
        # greedy: each served token is the port's argmax
        assert got.argmax(-1).tolist() == r.out_tokens
    assert worst < REL_TOL
    # the control computes a step below f32 and fails the tolerance
    r = reqs[1]
    low = _reference(cfg, w, r, "fp8")
    want = _reference(cfg, w, r, "f32")
    assert float((low - want).abs().max() / want.abs().max()) > 100 * REL_TOL


def test_config_file_is_the_published_model_cut_in_depth_and_experts():
    """The benchmark's configuration: published widths, 3 dense + 8 MoE
    layers, 8 of 256 experts held, its parameters as its file states."""
    cfg = json.loads(CONFIG.read_text())
    a = port.arch(cfg)
    assert (a.d_model, a.n_heads, a.d_ff, a.vocab_size, a.n_layers) \
        == (7168, 128, 18432, 129280, 11)
    assert (a.moe.num_experts, a.moe.top_k, a.moe.d_ff_expert,
            a.moe.n_shared, a.moe.first_dense_layers, a.moe.scoring,
            a.moe.n_group, a.moe.topk_group, a.moe.routed_scale,
            a.moe.held, a.moe.held_from) \
        == (256, 8, 2048, 1, 3, "sigmoid", 8, 4, 2.5, 8, 0)
    assert (a.mla.q_lora_rank, a.mla.kv_lora_rank, a.mla.qk_nope_dim,
            a.mla.qk_rope_dim, a.mla.v_head_dim) == (1536, 512, 128, 64, 128)
    assert not a.mtp and a.policy.compute_dtype == "bfloat16"
    meta = port.meta_params(a)
    norms = 11 * (2 * 7168 + 1536 + 512) + 7168
    bias = 8 * 256
    assert lm.param_count(meta) == cfg["sizes"]["parameters"] + norms + bias
    assert meta["stack"]["moe_stack"]["moe"]["experts"]["wi"].shape \
        == (8, 8, 7168, 2048)
    assert meta["stack"]["moe_stack"]["moe"]["router"]["w"].shape \
        == (8, 7168, 256)
    from portbench.families import mla_moe as fam
    assert fam.sizes(cfg)["weight_bytes"] + fam.sizes(cfg)["embed_bytes"] \
        == 2 * lm.param_count(meta)
    assert 64 * 1312 * 11 * fam.latent_bytes(cfg) == 1_064_042_496
    assert fam.attn_flops_per_key(cfg) == 2 * 128 * (576 + 512)
    # 8 held of 256, top-8: a quarter of an expert a token
    assert np.isclose(fam.per_token(cfg) - 3 * 583_467_008
                      - 8 * (187_105_280 + 44_040_192 + 1_835_008),
                      8 * 0.25 * 44_040_192)
    assert np.isclose(fam.held_reached(cfg, 64), 8 * (1 - (31 / 32) ** 64))


def test_the_reference_imports_no_jax_and_no_port_kernel():
    path = ROOT / "portbench" / "reference" / "mla_moe.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "math", "typing", "torch",
                     "portbench.reference"}
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from portbench.reference import mla_moe\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'repro_torch')))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
