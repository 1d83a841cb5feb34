"""Whether what the timed path served is correct.

Once the window has closed and the server's state is freed, a sample of
the requests it finished, drawn from the seed with the longest among
them, goes through the configuration's plain reference: one causal
forward over each prompt followed by its served tokens, in float32.  A
served token is judged by how far its reference logit lies below the
reference's best at that position (0 where it is the argmax).  Two
numbers are read: the mean gap over every served token of the leading
requests (``mean_logit_gap``: prefill and decode through the cache), and
the mean gap of the first token alone (the prefill's argmax) over more
requests (``first_token_mean_logit_gap``).  A cell's file
(``cells/<cell>.json``) names the ones it compares.  That is valid
because every served token is greedy.  Beside them, not compared, the
share of answer positions at which the reference's best next token is
the token just served (``reference_repeat_share``): near 1 the answers
would not depend on their context, and a decode step that dropped the
cache could pass.

The control (``prec="fp8"``) reads the same gaps for the tokens that the
reference in float8 puts first at the same positions.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def pick(finished: List, seed: int, tokens: int, first: int
         ) -> Tuple[List, List]:
    """The requests to judge, in one order: the longest finished request
    (prompt and answer), then the others in an order drawn from ``seed``.
    Returns the leading requests that hold ``tokens`` served tokens,
    judged on every token, and those after them up to ``first``
    requests in all, judged on their first token alone."""
    if not finished:
        return [], []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.out_tokens),
                                           -r.uid))
    rng = np.random.default_rng((49979687, int(seed)))
    order = [longest] + [finished[i] for i in rng.permutation(len(finished))
                         if finished[i] is not longest]
    k, n = 0, 0
    while k < len(order) and n < tokens:
        n += len(order[k].out_tokens)
        k += 1
    return order[:k], order[k:max(k, first)]


def reference(cfg: Dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]


def gaps(weights: Dict, cfg: Dict, whole: List, first_only: List, device,
         control: bool = False) -> Dict:
    """The gaps of the served tokens of ``whole`` and of the first token
    of every request in ``whole`` and ``first_only``; with ``control``
    the same of the float8 reference's first choices at those
    positions."""
    ref = reference(cfg)
    kinds = ["", "control_"] if control else [""]
    every = {k: [] for k in kinds}
    first = {k: [] for k in kinds}
    repeats = []
    for r, in_whole in [(r, True) for r in whole] \
            + [(r, False) for r in first_only]:
        served = torch.as_tensor(r.out_tokens if in_whole
                                 else r.out_tokens[:1], dtype=torch.long,
                                 device=device)
        if bool((served >= cfg["vocab_size"]).any()) \
                or bool((served < 0).any()):
            g = {k: torch.full((len(served),), math.inf) for k in kinds}
        else:
            seq = torch.cat([torch.as_tensor(r.prompt, dtype=torch.long,
                                             device=device), served[:-1]])
            rows = slice(len(r.prompt) - 1, None)
            logits = ref.forward(weights, cfg, seq, rows, "f32")
            g = {"": _gaps(logits, served).cpu()}
            if in_whole:
                repeats.append((logits[1:].argmax(-1) == served[:-1]).cpu())
            if control:
                low = ref.forward(weights, cfg, seq, rows, "fp8").argmax(-1)
                g["control_"] = _gaps(logits, low).cpu()
            del logits
        for k in kinds:
            first[k].append(g[k][:1])
            if in_whole:
                every[k].append(g[k])
    out = {}
    for k in kinds:
        out.update(_summary(every[k], k))
        out.update(_summary(first[k], k + "first_token_"))
    out["requests_compared"] = len(whole) + len(first_only)
    rep = torch.cat(repeats) if repeats else torch.zeros(0)
    out["reference_repeat_share"] = float(rep.float().mean()) \
        if rep.numel() else math.nan
    return out


def _summary(per_request: List[torch.Tensor], prefix: str) -> Dict:
    g = torch.cat(per_request) if per_request else torch.zeros(0)
    n = int(g.numel())
    return {f"{prefix}mean_logit_gap": float(g.sum()) / n if n else math.inf,
            f"{prefix}widest_logit_gap": float(g.max()) if n else math.inf,
            f"{prefix}off_argmax": int((g > 0).sum()),
            f"{prefix}compared": n}


def judge(readings: Dict, limits: Dict) -> Dict:
    """Each number compared beside its limit (``limits["at_most"]``), the
    count of tokens judged beside the least a verdict needs, and the
    verdict."""
    checks = {k: {"value": readings[k], "limit": v, "rule": "at most"}
              for k, v in limits["at_most"].items()}
    checks["compared"] = {"value": readings["compared"],
                          "limit": limits["min_tokens_compared"],
                          "rule": "at least"}
    ok = all((c["value"] <= c["limit"]) if c["rule"] == "at most"
             else (c["value"] >= c["limit"]) for c in checks.values())
    return {"correct": ok, "checks": checks}
