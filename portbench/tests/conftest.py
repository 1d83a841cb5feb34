"""Shared pieces of the benchmark's CPU tests: a tiny cell of the dense
configuration (the same family and code paths, small widths) and a
rehearsal of a run on the CPU, where every kernel takes its plain
version."""
import copy
import json
import sys
import time
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1]
if str(PKG.parent / "src") not in sys.path:      # the port, as run.py has it
    sys.path.insert(0, str(PKG.parent / "src"))

from portbench import bench  # noqa: E402
TINY = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab_size=512,
            n_layers=2, n_kv_heads=2)
#: the mean-gap limit at the tiny size, between the program's largest
#: reading and the float8 control's smallest on seeds 1-3 (CPU,
#: test_control.py: 0.00012 and 0.0086)
TINY_LIMIT = 0.0012


def tiny_cfg() -> dict:
    cfg = json.loads((PKG / "configs" / "qwen3-1.7b.json").read_text())
    cfg.update(TINY)
    return cfg


def tiny_cell(traced: bool = False, rate: float = 4.0,
              sample_tokens: int = 64, wait_share: float = 0.5,
              metrics=None) -> dict:
    """The chat cell's code paths at a tiny size, reporting the chat
    cell's metrics or, by name, ``metrics``."""
    cfg = tiny_cfg()
    mix = dict(arrival=dict(process="poisson"), prompt_len=[8, 40],
               output_len=[4, 12], lengths="log-uniform", slots=4,
               cache_len=64, base_seed=0)
    return dict(name="tiny", chips=1, cfg=cfg, mix=mix, rate=rate,
                wait_share=wait_share,
                limits=dict(at_most={"mean_logit_gap": TINY_LIMIT},
                            min_tokens_compared=10,
                            sample_tokens=sample_tokens, first_requests=16),
                metrics=[dict(name=n, unit="") for n in metrics]
                if metrics is not None else bench.metric_entries(
                    bench.load_spec(), "qwen3-1.7b.chat", traced))


def rehearse(cell: dict, seed: int, traced: bool = False,
             seconds: float = 2.0) -> dict:
    return bench.run_cell(copy.deepcopy(cell), seed, seconds, traced,
                          torch.device("cpu"), time.perf_counter(),
                          log=lambda m: None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    return torch.device("cuda", 0)


def serve_tiny(seed: int, seconds: float = 2.0):
    """The weights and the finished requests of the tiny cell's schedule,
    all submitted at once and served to the end, so that the tokens do
    not depend on the host's speed."""
    from portbench import arrivals, port, weights
    cell = tiny_cell()
    cfg = cell["cfg"]
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), seed, "cpu")
    srv = port.server(a, w, cell["mix"], torch.device("cpu"))
    for x in arrivals.schedule(cell["mix"], cell["rate"], seconds, seed,
                               cfg["vocab_size"]):
        srv.submit(port.request(x.uid, x.prompt, x.max_new))
    return w, srv.run_until_drained()
