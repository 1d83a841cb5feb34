"""End-to-end training example: a ~53M-parameter qwen3-family model for a
few hundred steps on the synthetic bigram corpus, with AdamW,
checkpoint/restart, preemption handling, the straggler watchdog and
metrics JSONL.  The CE must drop by >= 0.5 nats.

Port of the reference's training example, with its flags, plus
``--device`` (the card by default; ``--device cpu`` runs on the CPU).
The weights come from a seeded generator on the device; the loss and its
gradients run on ``backend="torch"``, as the reference trains on XLA.

  PYTHONPATH=src python -m repro_torch.train [--steps 300] [--out DIR]
  PYTHONPATH=src python -m repro_torch.train --device cpu --steps 4
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import SHAPES, get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, TrainLoop, make_step, trainable

#: the drop in CE (nats) from the first logged step to the last that a run
#: must show
MIN_CE_DROP = 0.5


def build_cfg(layers=8, d_model=768):
    """~53M parameters at the defaults (the reference's ``build_cfg``)."""
    return get("qwen3-1.7b").reduced().replace(
        n_layers=layers, d_model=d_model, n_heads=d_model // 64,
        n_kv_heads=max(d_model // 192, 1), d_ff=int(d_model * 8 // 3),
        vocab_size=4096, head_dim=None)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--out", default="runs/train_lm")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg()
    gen = torch.Generator(device=device).manual_seed(0)
    params = trainable(lm.init(cfg, gen, device=device))
    n = lm.param_count(params)
    print(f"arch={cfg.name}(reduced) params={n / 1e6:.1f}M "
          f"device={device}")

    oc = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=20,
                           total_steps=args.steps, weight_decay=0.01)
    opt = adamw.init(params, oc)
    # a 512-state bigram chain: enough structure to show clear learning
    # inside a few hundred small-batch steps
    pipe = SyntheticLM(cfg, SHAPES["train_4k"], seed=0,
                       batch_override=args.batch, seq_override=args.seq,
                       active_vocab=512)
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_every=100, log_every=10,
                   out_dir=args.out),
        make_step(cfg, oc, device), params, opt, pipe)
    out = loop.run()
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}))

    lines = [json.loads(line) for line in
             (Path(args.out) / "metrics.jsonl").read_text().splitlines()]
    first, last = lines[0]["ce"], lines[-1]["ce"]
    print(f"ce: {first:.3f} -> {last:.3f} "
          f"(uniform baseline {np.log(pipe.active_vocab):.3f})")
    if not last < first - MIN_CE_DROP:
        raise SystemExit("train_lm: loss did not improve")
    print("train_lm OK")


if __name__ == "__main__":
    main()
