#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Times: "events" is the CUDA-event mean of eager calls, which includes the
host's issue path whenever a call is shorter than its launch; "device" is
the same calls captured in a CUDA graph and replayed (:func:`device_ms`),
the card's time alone; "host" is the wall time of issuing one call.

Phases (any failure exits non-zero and prints no result line):

1. device  — require CUDA; print the card's name and power limit; TF32 off.
2. build   — build every kernel under src/repro_torch/kernels/csrc with
             nvcc (one process per source, all at once); print the build
             seconds and each instantiation's registers and spills.
3. kernels — hold K1 (ame_gemm) against its plain version at the main
             paths' shapes (qwen3-1.7b, mamba2-370m and zamba2-2.7b
             projections at m = 1, 4, 64 and, for the SSM and hybrid
             models, 300; mixtral-8x22b's attention and deepseek-v3-671b's
             MLA, dense MLP and shared-expert projections at m = 4 and 64;
             the train path's qwen3-1.7b and hubert-xlarge layers at m =
             2048 and internvl2-76b's at m = 1, 4 and 512; the quickstart's
             256x192x96 in f32, on the fma variant)
             and the ragged test shapes;
             every other main-path shape must take the tensor-core
             variant, and
             each line names the variant it took; time the kernel and
             torch.matmul (the library yardstick, which the port never
             calls) on the device and with events, the plain version with
             events, and the host time of a call, beside the bound.
4. ssd     — hold K4 (ssd_scan) against its plain version at the reference
             test shapes (f32, bf16), the impulse test and the main paths'
             shapes (mamba2-370m: BH 32, P 64, N 128; zamba2-2.7b: BH 80,
             P 64, N 64; chunk 128, f32 x, bf16 b/c) at T = 37, 64, 300
             (two chunk boundaries, padded third chunk) and 2048, and on
             the serve's own strided views; each line names the variant
             (and mma configuration) it took, and every main-path shape
             must take mma; time kernel and plain version beside the
             bound.
5. elementwise — hold K2 (ame_elementwise) bit for bit against its plain
             version: the reference's shapes x 3 kinds x 3 dtypes, with and
             without ReLU, NaN / inf / -0 / denormal inputs, a misaligned
             view; time it at the AME max tile (128, 4096) f16 and at
             (8192, 8192) bf16 beside torch.add/sub/mul and the bytes bound,
             on the device, with events and by host µs per call.
6. attention — hold K3 (flash_attention) against its plain version: its
             six test shapes in f32 and bf16 within the reference's
             tolerances; a block sweep over both kernels' blocks (bf16 at
             head dims 32 and 256), a window across tiles in f32 and bf16,
             and four model shapes in bf16 (qwen3 prefill, chunked decode,
             a Mixtral sliding window, gemma-2b's head dim 256), f32 at the
             reference's 2e-5 and bf16 on peaked inputs at one bf16 ulp;
             time the model shapes, on the device and with events, beside
             scaled_dot_product_attention and the bound.
6b. decode attention — the port's decode attention kernel
             (kernels/decode_attention.py) against chunked_attention's
             decode call at the chat cell's step (32 slots of 1,312
             positions, qwen3-1.7b's 8 KV heads of 128, groups of 2, the
             live positions of a mid-window step drawn from the chat
             traffic's lengths) and at zamba2's (head dim 80, g 1),
             gemma-2b's (256, g 8) and phi4-mini's (g 3) shapes, within one
             bf16 ulp of the output's scale; the chat step timed on the
             device and with events, by host µs a call, beside
             chunked_attention, scaled_dot_product_attention over the whole
             cache (the library yardstick, never called by the port) and
             the bound: the live K and V bytes at 3.35 TB/s.
6c. MLA decode — the port's MLA decode kernel (kernels/mla_decode.py)
             against its plain version (cat + chunked_attention, as MLA's
             decode branch computes it on CPU tensors) at the cell
             deepseek-v3.chat-64's step (64 slots of 1,312 positions, 128
             heads, widths 512 + 64, live positions drawn from the chat
             traffic's lengths), a short cache and the reduced widths
             (32 + 16), within one bf16 ulp of the output's scale; the
             cell's step timed on the device and with events, by host µs
             a call, beside the plain version, chunked_attention alone on
             a concatenated cache, scaled_dot_product_attention with the
             heads as the queries of one KV head (the library yardstick)
             and the bound: the live latents, qq and o at 3.35 TB/s, or
             the score and value FLOPs at 989 TFLOP/s, the larger.
7. engine  — quickstart part 1 through repro_torch.core on the card: mfadd,
             mfsub, mfmax refused, mfmacc, the modeled Aquabolt-XL headline
             (59.4 FLOP/cycle, 14.9 GFLOP/s, 256 launches); the batched
             executors bit-exact with the numpy strict interpreter, and
             ew_on_engine_batched bit-exact with K2 on f16 add/sub/mul.
8. runtime — quickstart part 2 through repro_torch.runtime on the card:
             pim_gemm 256x192x96 at 1 and 2 pseudo-channels bit-exact with
             the same calls on the CPU, their command traces byte-identical,
             and the cluster values of results/BENCH_runtime.json (makespan
             parity 294016 cycles, 4-stack efficiencies 0.994646 GEMM and
             0.986539 GEMV) exactly; modeled cycles, not H100 numbers.
9. quickstart — python -m repro_torch.quickstart, the port of
             examples/quickstart.py (its three parts with its inputs):
             main() on the card, K1's counts set to 0 just before and read
             just after (one launch, on the fma variant: f32 operands),
             every printed line but the kernel line == main("cpu")'s, K1
             within the f32 TOL of ref.gemm; then the CLI with no flags in
             a process of its own (its default is the card), ending
             ``quickstart OK``.  Phase 3 times K1 at this shape.
10. ops    — the ops entry point: ops.elementwise and
             ops.attention at the model shapes, every kernel count set to
             0 just before and read just after; outputs held against the
             plain versions.
11. serve  — full-width qwen3-1.7b (28 layers), then full-width
             mamba2-370m (48 layers), then full-width zamba2-2.7b (54
             mamba layers, 9 applications of 2 shared attention blocks,
             ``lora_b`` filled with seeded values), f32 parameters and bf16
             compute from a seeded generator, each serves seeded requests
             through ``Server(backend="kernel")`` with every kernel count
             set to 0 just before and read just after: 196 K1 launches per
             qwen3 forward; 96 K1 per mamba forward and 48 K4 per mamba
             prefill of more than one token; 162 K1 per zamba2 forward
             (54 x 2 mamba projections + 9 x 6 shared-block projections)
             and 54 K4 per zamba2 prefill of more than one token; every K4
             launch on its mma variant.  Then mixtral-8x22b (cut to 8 of
             56 layers) and deepseek-v3-671b (cut to 4 of 61 layers: its 3
             dense layers and 1 MoE layer) at full width, bf16 weights:
             32 K1 launches per forward each (mixtral 8 x 4 attention
             projections; deepseek 3 x 8 dense-layer and 1 x 8 MoE-layer
             projections), every K1 launch of every serve on its mma
             variant; deepseek's decode steps launch the MLA decode kernel
             once a layer.  One prompt's prefill logits are held against
             ``backend="torch"`` (for the MoE models with the share of
             (token, layer) expert choices the two backends agree on); a
             warm decode step (and, for mamba and zamba2, a 300-token
             prefill) is timed and profiled, with zamba2's per-application
             LoRA merge and one MoE layer's router, dispatch, expert and
             combine products timed on their own; a reduced model on the
             card is held against the same model on the CPU.
12. offload — the serve path's PIM decode offload, with obs and faults:
             full-width qwen3-1.7b served through ``Server(backend=
             "kernel", pim_offload=DecodeOffload(16 channels x 4 stacks,
             async, KV offload, metrics, OFFLOAD_PLAN), faults=
             OFFLOAD_PLAN)``, every kernel count set to 0 just before and
             read just after (196 K1 launches per forward); every
             completed request's tokens equal the clean serve's; the fault
             counters (retries, failed requests, channel failures, link
             retries) printed and non-zero where the plan says; the
             sidecar's roofline under the H100 descriptor, its host ms per
             decode step, and the offload serve step's busy and idle
             shares.  Then serve_lm's reduced qwen3 with a numeric,
             KV-offloading, async sidecar under NUMERIC_PLAN on the card
             and on the CPU: every record within NUMERIC_ATOL and equal
             (error maxima within OFFLOAD_ERR_TOL), logits bit for bit,
             command and Chrome traces byte for byte; its critical-path
             summary.  Last, results/BENCH_runtime.json's decode, kv, obs,
             faults and moe (replication 4) values and
             results/dryrun/qwen3-1.7b.decode.pim_offload.json, exactly,
             from the port alone with the reference's setups
             (benchmarks/paper_figures.py).  Modeled Aquabolt-XL cycles;
             the wall times are the card host's.
13. traffic — results/BENCH_runtime.json's serve section (the
             qwen3-1.7b and mixtral-8x22b SLO frontiers, disaggregated vs
             colocated, their knees and the bursty point) through the
             port's TrafficServer with the reference's host constants,
             exactly; then the same frontiers with the H100 descriptor
             (repro_torch/launch/hw.py), a modeled result.  Host only, in
             a separate process while phases 3-12 and 14 run on the card.
14. train  — with the serve models freed: full-width qwen3-1.7b (28
             layers, batch 4 x 512) and hubert-xlarge (48 layers, masked
             frames, 2 x 1024), f32 parameters, bf16 compute and remat as
             their policies say, each train TRAIN_STEPS AdamW steps on
             ``backend="torch"`` (the reference trains on XLA) on one fixed
             SyntheticLM batch: losses finite and falling, the step's time,
             busy and idle shares and peak memory; before step 1 the
             kernel backend's loss under ``no_grad`` (K1's main path here,
             counts set to 0 just before and read just after: 196 and 288
             launches, all mma) within the bf16 rule of the torch
             backend's, and within TRAIN_F32_TOL in f32 compute.  Then
             internvl2-76b at full width cut to TRAIN_DEPTH layers (bf16
             weights): 128 patch embeddings + 384 text tokens prefilled and
             16 tokens decoded through the kernel backend (56 K1 launches
             a forward, all mma), the prefill logits and the kernel
             backend's loss against the torch backend's.  Then ``python -m
             repro_torch.train`` with its defaults (300 steps, CE down >=
             0.5 nats, ``train_lm OK``) and the resume check at its size;
             last, a reduced qwen3 trained on the card and on the CPU.
15. mesh   — the mesh half (repro_torch.launch.steps on DTensor) on a
             1-rank nccl world and a 1x1 mesh: full-width qwen3-1.7b's
             sharded prefill (MESH_SERVE, backend="kernel", K1 counts set
             to 0 just before and read just after: 196 launches, all mma)
             with logits torch.equal to the unsharded prefill's, and
             MESH_DECODE sharded decode steps with the unsharded tokens; a
             warm decode step timed and profiled sharded and unsharded
             (DTensor's host cost); MESH_TRAIN_STEPS sharded train steps
             at MESH_MICROBATCHES microbatches, the step-1 loss against
             make_step's by the train phase's bf16 rule, the loss falling,
             event / busy ms and peak beside make_step's.  Then, on the
             host, each in a process of its own: ``python -m
             repro_torch.launch.distributed_train --device cpu`` (4 gloo
             ranks, both dataflows), the fake-world dry-run of qwen3-1.7b
             decode_32k on the 512-rank multi-pod mesh (its traced
             per-device peak beside memmodel.estimate) and DRYRUN_FAMILIES.
16. report — fail if any device time reads below its bound; one JSON
             line of every ported kernel, then the last line
             ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import json
import math
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: K1's tolerance against its plain version, per output dtype: the same
#: values as tests/test_kernels.py (f32 runs FP32 FMA, never TF32, so only
#: the order of the sums differs; bf16 outputs may round one ulp apart)
K1_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (0.06, 0.06)}
#: K4's tolerance against its plain version, per x dtype (atol, rtol): the
#: reference's values (tests/test_kernels.py:104-105)
K4_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (0.08, 0.08)}
#: K3's tolerance against its plain version, per dtype: the reference's
#: values (tests/test_kernels.py:20-22); f32 sums run in another order, bf16
#: outputs may round one ulp apart
K3_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (0.06, 0.06)}
#: K3 at the model shapes in bf16, (atol, rtol): one bf16 ulp.  The kernel
#: and the plain version both compute in f32 and round once to bf16, so
#: they differ only where f32 sum-order noise crosses a rounding edge, by
#: at most ulp(x) <= 2^-7 |x|.
K3_MODEL_TOL = (2e-3, 8e-3)
#: q and k at the model shapes are unit normals times this, so the scores
#: have std 3 and the softmax is peaked; v is unit normal.  Outputs are then
#: O(1), and a dropped, mis-skipped or mis-masked KV tile moves them far
#: past K3_MODEL_TOL (at the reference's 0.5 scale they average thousands
#: of keys and stay under its bf16 limit of 0.06 whatever the kernel does).
K3_MODEL_QK_SCALE = 3 ** 0.5
#: K3 at the model shapes (bf16): name, (BH, Tq, Tk, D), causal, window
K3_MODEL_CASES = [
    ("qwen3-1.7b prefill", (16, 2048, 2048, 128), True, 0),
    ("chunked decode", (64, 16, 1024, 128), True, 0),
    ("mixtral-8x22b window", (48, 8192, 8192, 128), True, 4096),
    ("gemma-2b prefill", (8, 2048, 2048, 256), True, 0),
]
#: the decode attention kernel: (name, b, clen, hkv, g, d), the chat
#: cell's step first (timed), then the head dims and groups of the other
#: window-free decodes on the card
DECODE_ATTN_CASES = [("chat", 32, 1312, 8, 2, 128),
                     ("zamba2-2.7b", 4, 512, 32, 1, 80),
                     ("gemma-2b", 8, 1024, 1, 8, 256),
                     ("phi4-mini-3.8b", 8, 1024, 8, 3, 128)]
#: distinct caches the timed decode attention cycles through, as the 28
#: layers of a step do: 4 x 172 MB, past the 50 MB L2
DECODE_ATTN_LAYERS = 4
#: MLA's decode kernel: (name, b, clen, h, r, rd), the cell
#: deepseek-v3.chat-64's step first (timed), then a short cache and the
#: reduced configurations' widths
MLA_DECODE_CASES = [("deepseek-v3.chat-64", 64, 1312, 128, 512, 64),
                    ("short cache", 8, 64, 128, 512, 64),
                    ("reduced", 3, 90, 4, 32, 16)]
#: distinct latent caches the timed MLA kernel cycles through, as the 11
#: layers of the cell's step do: 3 x 97 MB, past the 50 MB L2
MLA_DECODE_LAYERS = 3
#: K2 at the model shapes: the AME max tile in FP16 (cost.max_tile_mfmacc)
#: and a bf16 pair of 128 MiB operands, past the 50 MB L2
K2_MODEL_CASES = [((128, 4096), "float16"), ((8192, 8192), "bfloat16")]
#: serve: the longest prompt's prefill logits under backend="kernel" vs
#: "torch" on the card, (atol, rtol).  With f32 compute only the order of
#: the sums differs, so a wrong kernel cannot hide there (logits of the
#: seeded models are O(1)).
SERVE_F32_LOGITS_TOL = (1e-3, 1e-3)
#: the same with bf16 compute, as served: sums in another order round a
#: bf16 activation one ulp (2^-8 relative) apart now and then, and the
#: layers carry that on, 48 layers of the seeded mamba2-370m further than
#: 28 of qwen3-1.7b; bf16 compute itself moves their logits 0.08 and 0.83
#: from f32 compute.  For these two the bf16-vs-f32 distance is printed,
#: not a limit.
SERVE_LOGITS_ATOL = {"qwen3-1.7b": 0.25, "mamba2-370m": 0.5}
#: zamba2-2.7b's bf16 limit is derived on the card, as
#: tests/test_torch_ssm.py::test_bf16_compute_matches_jax derives its own:
#: from the plain (torch) path's bf16-vs-f32 distance on the same prompt.
#: Both bf16 runs round the same f32 function, so if the kernel's run is
#: no further from the f32 result than the plain run is, the two bf16 runs
#: are at most twice that distance apart (triangle inequality).
SERVE_LOGITS_NOISE_FACTOR = {"zamba2-2.7b": 2.0}
#: mixtral-8x22b and deepseek-v3-671b take the same rule, fixed before
#: their first card run: their seeded expert routing is a discrete choice
#: on bf16-rounded router inputs, so a bf16 run may send a token to
#: another expert than the f32 run does, and the plain path's own
#: bf16-vs-f32 distance measures that noise on the same prompt as well
SERVE_LOGITS_NOISE_FACTOR.update({"mixtral-8x22b": 2.0,
                                  "deepseek-v3-671b": 2.0})
#: depth of the full-width MoE serves: the most layers whose bf16 weights
#: (mixtral 8 layers: 20,435,146,752 parameters, 38.06 GiB; deepseek 4:
#: its 3 dense layers and one MoE layer, 15,162,488,832, 28.24 GiB) leave
#: room on one 80 GB card for the f32 logits check's transient casts of a
#: whole expert bank (deepseek's 256 x 7168 x 2048 wi alone is 15 GB in
#: f32); the full models hold 56 and 61 layers
SERVE_DEPTH = {"mixtral-8x22b": 8, "deepseek-v3-671b": 4}
#: zamba2's seeded lora_b, N(0, LORA_B_STD^2): the merged LoRA term
#: lora_a @ lora_b then has 8 x 0.02 = 0.16 of in_proj's std
LORA_B_STD = 0.02
#: small reduced model (f32) on the card vs the CPU: f32 sum-order only
SMALL_TOL = 1e-4
SLOTS, MAX_NEW, N_REQUESTS = 4, 16, 6
#: mamba2-370m and zamba2-2.7b serves: one of the six prompts is this
#: long, so the scan crosses two chunk boundaries of 128 and pads the
#: third chunk on the card
LONG_PROMPT = 300
#: cache positions per slot: qwen3's and zamba2's KV caches; mamba's
#: prompts must fit under it too (its recurrent state does not grow)
CACHE_LEN = {"qwen3-1.7b": 128, "mamba2-370m": 512, "zamba2-2.7b": 512,
             "mixtral-8x22b": 128, "deepseek-v3-671b": 128}
#: quickstart part 2's GEMM
RUNTIME_GEMM = (256, 192, 96)
#: K1 at quickstart part 2's (m, k, n) in f32, as repro_torch.quickstart
#: calls it: the one main path whose K1 launch takes the fma variant
QUICKSTART_GEMM = RUNTIME_GEMM
#: seconds for ``python -m repro_torch.quickstart`` in a process of its own
QUICKSTART_TIMEOUT = 300
#: the modeled cluster values the runtime must reproduce (``cluster``)
BENCH_RUNTIME = ROOT / "results" / "BENCH_runtime.json"
#: the committed decode-offload roofline artifact the port's dump must equal
OFFLOAD_DUMP = ROOT / "results" / "dryrun" / \
    "qwen3-1.7b.decode.pim_offload.json"
#: the offload serve's fault plan: channel 5 (stack 0) fail-stops after
#: about three sidecar steps (a full-width step is ~1.7e7 modeled cycles),
#: the host link then re-carries the lost residency and retransmits each
#: charge with p = 0.5, and the request in serve slot 1 is knocked out at
#: serving iteration 4 and restarts from its prompt
OFFLOAD_PLAN = "kill channel 5 @ 5e7; flaky link p=0.5; fail slot 1 @ iter 4"
#: the sidecar's layout at full width: 16 pseudo-channels x 4 stacks
OFFLOAD_CHANNELS, OFFLOAD_STACKS = 16, 4
#: the numeric sidecar's model: serve_lm's reduced qwen3-1.7b
#: (examples/serve_lm.py:73-74), its requests and its fault plan
NUMERIC_CFG = dict(n_layers=4, d_model=256, d_ff=512, vocab_size=1024)
NUMERIC_REQUESTS, NUMERIC_SLOTS, NUMERIC_MAX_NEW = 6, 2, 8
NUMERIC_PLAN = "kill channel 1 @ 30000"
#: error maxima of a numeric StepRecord, card vs CPU: the same FP16 PIM
#: outputs against FP32 references summed in another order (TF32 off),
#: and the runtime's FP32 softmax may round a probability one FP16 ulp
#: apart (tests/test_torch_gpu.py holds the same limit)
OFFLOAD_ERR_TOL = 1e-5
#: the reference's host constants (TPU v5e: repro/launch/hw.py), which the
#: committed dump was priced with
REF_PEAK_FLOPS, REF_HBM_BW = 197e12, 819e9
#: requests of each load point of the serve frontier (serve_sweep's N_REQ)
TRAFFIC_REQUESTS = 250
#: the train phase's full-width models: (sequences, tokens) of the one
#: fixed batch their AdamW steps train on, and the step count
TRAIN_BATCH = {"qwen3-1.7b": (4, 512), "hubert-xlarge": (2, 1024)}
TRAIN_STEPS = 5
#: the VLM at full width cut to this many of internvl2-76b's 80 layers
#: (8,946,589,696 bf16 parameters, 16.7 GiB: room on one card for the f32
#: check's per-layer casts); its prompt (128 patch embeddings ahead of 384
#: text tokens) and greedy decode steps
TRAIN_DEPTH = {"internvl2-76b": 8}
VLM_SEQ, VLM_DECODE = 512, 16
#: K1 rows of the train and VLM paths, timed in the kernels phase beside
#: the serving shapes: the training batch's B x T, the VLM's prefill, its
#: one-sequence decode and a 4-row decode
TRAIN_M = {"qwen3-1.7b": (2048,), "hubert-xlarge": (2048,),
           "internvl2-76b": (1, SLOTS, VLM_SEQ)}
#: kernel-backend vs torch-backend losses and VLM prefill logits, fixed
#: before the first card run of the train phase: in f32 compute within
#: TRAIN_F32_TOL (only the order of the sums differs); in bf16 within
#: max(TRAIN_BF16_FLOOR, SERVE's noise factor x the torch path's own
#: bf16-vs-f32 distance on the same inputs), the serve checks' rule
TRAIN_F32_TOL = 1e-3
TRAIN_BF16_FLOOR = 5e-3
TRAIN_NOISE_FACTOR = 2.0
#: python -m repro_torch.train's resume check: this many steps straight
#: against half of them, a new loop, and the other half; final losses
#: within the reference's bound (tests/test_substrate.py:208-223)
RESUME_STEPS, RESUME_REL = 20, 1e-4
#: a reduced qwen3-1.7b (f32) trained on the card and on the CPU from the
#: same parameters: per-step losses within SMALL_TRAIN_LOSS_REL, and the
#: parameters after the last step within SMALL_TRAIN_PARAM_ATOL (f32 sums
#: in another order) at every entry whose CPU gradient stays at least
#: ADAM_WELL_CONDITIONED x eps from zero in every step.  Adam divides each
#: gradient entry by its own magnitude plus eps, so where a gradient comes
#: within a few eps of zero, sum-order noise of ~1e-9 becomes a sizeable
#: share of lr (1.24e-4 on an H100 at 651 of this model's 656,768
#: entries); those entries are held to 2 x lr a step, the most the steps
#: can move them
SMALL_TRAIN_STEPS, SMALL_TRAIN_LOSS_REL, SMALL_TRAIN_PARAM_ATOL = 3, 1e-5, \
    1e-5
ADAM_WELL_CONDITIONED = 100
#: the mesh phase (repro_torch.launch.steps on a 1-rank nccl world, 1x1
#: mesh): full-width qwen3-1.7b served through the sharded prefill
#: (MESH_SERVE sequences x tokens, backend="kernel") and MESH_DECODE
#: sharded decode steps; trained MESH_TRAIN_STEPS sharded steps at 2
#: microbatches on TRAIN_BATCH.  The step-1 loss is held to the train
#: phase's bf16 rule against make_step's on the same parameters and batch:
#: max(TRAIN_BF16_FLOOR, TRAIN_NOISE_FACTOR x the plain path's own
#: bf16-vs-f32 loss distance), fixed before the first card run
MESH_SERVE, MESH_DECODE, MESH_TRAIN_STEPS = (4, 512), 16, 3
MESH_MICROBATCHES = 2
#: the host paths of the mesh half, each a process of its own, with its
#: time limit in seconds: the 4-rank gloo example and the fake-world
#: dry-runs (the reference's failing multi-pod cell at full depth, then
#: one cell per family at full width cut in depth: the MoE/MLA model to
#: its 3 dense layers and 1 MoE layer, the hybrid to one group of 6 mamba
#: layers and its shared block, the others to 2 layers)
MESH_HOST_TIMEOUT = 600
DRYRUN_FAMILIES = [("deepseek-v3-671b", "decode_32k", 4),
                   ("mamba2-370m", "prefill_32k", 2),
                   ("zamba2-2.7b", "decode_32k", 6),
                   ("hubert-xlarge", "train_4k", 2),
                   ("internvl2-76b", "decode_32k", 2)]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, args_list, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls (after warm-up),
    cycling through ``args_list`` so the weights come from device memory
    and not from L2, as on the main path."""
    import torch
    for args in args_list[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args_list, iters: int, replays: int = 3) -> float:
    """Mean device ms per call: ``iters`` calls, cycling through
    ``args_list`` as :func:`timed_ms` does, captured in one CUDA graph and
    replayed between two CUDA events.  A replay launches the captured
    kernels back to back, so the host's issue path (Python, ctypes, the
    wrapper's checks) is not in the time, as it is in :func:`timed_ms`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm up off the capture
        for args in args_list[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def host_us(fn, args_list, iters: int) -> float:
    """Host µs per call: the wall time of ``iters`` calls issued back to
    back, without waiting for the card (the launch queue never fills at
    these counts)."""
    import torch
    for args in args_list[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script measures the card and has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {name} (count {torch.cuda.device_count()})")
    log("[device] nvidia-smi name, power.limit:")
    log(smi)
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for name in libs:
        info = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {info['seconds']:.1f}s")
        for line in info["ptxas"]:
            log(f"[build]   {line}")


def k1_layer(cfg):
    """(name, k, n) of the K1 calls of one layer of ``cfg``; for the
    hybrid, one mamba layer's (``mamba:``) and one shared block's
    (``shared:``); for an MoE model with leading dense layers (deepseek),
    one dense layer's (``dense:``) and one MoE layer's (``moe:``).  An MoE
    layer's K1 calls are its attention's and its shared experts' MLP: the
    router and the expert banks are plain products, as in the reference."""
    d = cfg.d_model
    if cfg.ssm is not None:
        from repro_torch.models import ssm
        d_inner, _, _, d_proj = ssm.dims(cfg)
        mamba = [("in_proj", d, d_proj), ("out_proj", d_inner, d)]
        if cfg.family == "ssm":
            return mamba
    if cfg.mla is not None:
        m, h = cfg.mla, cfg.n_heads
        attn = [("wdq", d, m.q_lora_rank),
                ("wuq", m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim)),
                ("wdkv", d, m.kv_lora_rank), ("wkr", d, m.qk_rope_dim),
                ("wo", h * m.v_head_dim, d)]
    else:
        hd = cfg.head_dim_
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        attn = [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]

    def mlp(f, prefix=""):
        gate = [(f"{prefix}wg", d, f)] if cfg.act in ("swiglu", "geglu") \
            else []
        return [(f"{prefix}wi", d, f)] + gate + [(f"{prefix or 'mlp.'}wo",
                                                  f, d)]
    block = attn + mlp(cfg.d_ff)
    if cfg.family == "hybrid":
        return [(f"mamba:{nm}", k, n) for nm, k, n in mamba] \
            + [(f"shared:{nm}", k, n) for nm, k, n in block]
    if cfg.moe is None:
        return block
    moe_layer = attn + (mlp(cfg.moe.d_ff_expert * cfg.moe.n_shared,
                            "shared.") if cfg.moe.n_shared else [])
    if not cfg.moe.first_dense_layers:
        return moe_layer
    return [(f"dense:{nm}", k, n) for nm, k, n in block] \
        + [(f"moe:{nm}", k, n) for nm, k, n in moe_layer]


def k1_per_forward(cfg):
    """K1 launches of one forward: every layer's calls; for the hybrid,
    every mamba layer's two and each shared-block application's; for an
    MoE model with leading dense layers, each dense and each MoE layer's."""
    calls = k1_layer(cfg)
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid.shared_every
        mamba = sum(nm.startswith("mamba:") for nm, _, _ in calls)
        return mamba * cfg.n_layers + (len(calls) - mamba) * groups
    dense = sum(nm.startswith("dense:") for nm, _, _ in calls)
    if dense:
        fd = min(cfg.moe.first_dense_layers, cfg.n_layers)
        return dense * fd + (len(calls) - dense) * (cfg.n_layers - fd)
    return len(calls) * cfg.n_layers


def k1_shapes(cfg):
    """(name, m, k, n) of one layer's K1 calls, per M: one token (m = 1),
    a decode step of SLOTS slots, a prompt of 64 tokens, and for the SSM
    and hybrid models the LONG_PROMPT-token prefill.  The MoE models take
    their serve's own: the decode step and the longest prompt.  The train
    and VLM paths add TRAIN_M's rows (qwen3-1.7b's on top of its serve's;
    hubert-xlarge and internvl2-76b take only theirs)."""
    m_values = (1, SLOTS, 64) + ((LONG_PROMPT,) if cfg.ssm is not None
                                 else ())
    if cfg.moe is not None:
        m_values = (SLOTS, 64)
    if cfg.name in TRAIN_M:             # the train and VLM paths' rows
        m_values = TRAIN_M[cfg.name] if cfg.name != "qwen3-1.7b" \
            else m_values + TRAIN_M[cfg.name]
    return [(nm, m, k, n) for m in m_values for nm, k, n in k1_layer(cfg)]


def phase_kernels(cfgs):
    """K1 against its plain version; returns per-shape records.  Each main-
    path shape must take the tensor-core variant."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import ref
    from repro_torch.launch import hw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    l2_bytes = 50 * 2 ** 20
    cases = [(cfg.name, nm, m, k, n, torch.bfloat16) for cfg in cfgs
             for nm, m, k, n in k1_shapes(cfg)]
    cases += [("test", "ragged", m, k, n, dt)
              for m, k, n in ((100, 130, 70), (257, 33, 129))
              for dt in (torch.float32, torch.bfloat16)]
    cases.append(("quickstart", "part 2", *QUICKSTART_GEMM, torch.float32))
    records = []
    for model, nm, m, k, n, dt in cases:
        esz = torch.finfo(dt).bits // 8
        copies = max(1, min(16, -(-4 * l2_bytes // ((m * k + k * n) * esz))))
        args = [((torch.randn(m, k, generator=gen, device=dev) * 0.3).to(dt),
                 (torch.randn(k, n, generator=gen, device=dev) * 0.3).to(dt))
                for _ in range(copies)]
        a, b = args[0]
        got = k1.ame_gemm(a, b)
        torch.cuda.synchronize()
        want = ref.gemm(a, b)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K1 {nm} {(m, k, n)}: {got.shape} "
                                 f"{got.dtype} vs {want.shape} {want.dtype}")
        atol, rtol = K1_TOL[str(dt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        var = k1.variant(a, b)
        if model != "test" and var != ("fma" if model == "quickstart"
                                       else "mma"):
            ok = False          # each main-path shape takes its variant
        iters = 20
        ms = timed_ms(k1.ame_gemm, args, iters)
        plain_ms = timed_ms(ref.gemm, args, iters)
        lib_ms = timed_ms(torch.matmul, args, iters)
        nbytes = (m * k + k * n) * esz + m * n * esz
        peak = hw.PEAK_FLOPS if dt == torch.bfloat16 else hw.PEAK_FLOPS_F32
        t_bytes, t_ops = nbytes / hw.HBM_BW, 2 * m * n * k / peak
        rec = dict(model=model, name=nm, m=m, k=k, n=n,
                   dtype=str(dt).removeprefix("torch."), variant=var,
                   max_abs_err=err, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   device_ms=device_ms(k1.ame_gemm, args, iters),
                   library_device_ms=device_ms(torch.matmul, args, iters),
                   host_us=host_us(k1.ame_gemm, args, 200),
                   library_host_us=host_us(torch.matmul, args, 200),
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        records.append(rec)
        log(f"[kernels] ame_gemm {model} {nm:15s} (m,k,n)=({m},{k},{n}) "
            f"{rec['dtype']} {var}: max_abs_err={err:.3g} (atol {atol}, "
            f"rtol {rtol}) {'ok' if ok else 'FAIL'} | device: kernel "
            f"{rec['device_ms']:.4f} ms, torch.matmul "
            f"{rec['library_device_ms']:.4f} ms | events: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms | "
            f"host: kernel {rec['host_us']:.1f} us, torch.matmul "
            f"{rec['library_host_us']:.1f} us | bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    for cfg in cfgs:
        for m, part in sorted({(r["m"], r["name"].partition(":")[0]
                                if ":" in r["name"] else "layer")
                               for r in records if r["model"] == cfg.name}):
            layer = [r for r in records
                     if r["model"] == cfg.name and r["m"] == m
                     and r["name"].startswith(part + ":" if part != "layer"
                                              else "")]
            tot = {key: sum(r[key] for r in layer)
                   for key in ("device_ms", "library_device_ms", "ms",
                               "plain_ms", "library_ms", "bound_ms",
                               "host_us", "library_host_us")}
            log(f"[kernels] ame_gemm {cfg.name} {part} ({len(layer)} calls) "
                f"m={m}: device kernel {tot['device_ms']:.4f} ms, "
                f"torch.matmul {tot['library_device_ms']:.4f} ms | events "
                f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms,"
                f" torch.matmul {tot['library_ms']:.4f} ms | host kernel "
                f"{tot['host_us']:.1f} us, torch.matmul "
                f"{tot['library_host_us']:.1f} us | bound "
                f"{tot['bound_ms']:.4f} ms")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version or a "
                             f"main-path shape missed its variant: {bad}")
    return records


def k4_bound(bh, t, p, n, chunk, x_bytes, bc_bytes, bc_rows=None):
    """(bound ms, "bytes" | "operations") of one ssd_scan call.  Bytes: x,
    log_a, b, c read once and y written once (b and c hold ``bc_rows``
    distinct rows, default ``bh``; fewer where they are expanded over
    heads).  Operations: per row and
    chunk of l steps, the cheaper of two exact forms of the scan: the
    sequential recurrence, 5 N P f32 FLOPs a step on the CUDA cores (decay
    the state, add the outer product b x, read out c S); or the chunked
    form on the causal half of its score block on the tensor cores, each
    f32-accurate product at three bf16 passes: l(l+1) N for C B^T (one
    pass for bf16 b / c, which are exact), l(l+1) P + 4 l N P for G X, C S
    and B^T X."""
    from repro_torch.launch import hw
    lc = min(chunk, t)
    nbytes = bh * t * (2 * p * x_bytes + 4) \
        + (bc_rows or bh) * t * 2 * n * bc_bytes
    cb_passes = 1 if bc_bytes == 2 else 3
    t_ops = 0.0
    for t0 in range(0, t, lc):
        l = min(lc, t - t0)
        recurrence = 5 * l * n * p / hw.PEAK_FLOPS_F32
        chunked = (cb_passes * l * (l + 1) * n
                   + 3 * (l * (l + 1) * p + 4 * l * n * p)) / hw.PEAK_FLOPS
        t_ops += bh * min(recurrence, chunked)
    t_bytes = nbytes / hw.HBM_BW
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _model_layout(bsz, t, cfg, gen, dev):
    """The scan's operands as ``models.ssm.mamba_apply`` hands them over in
    bf16 compute: x*dt an f32 (B,T,H,P) product seen as (B,H,T,P); b and c
    columns of one bf16 (B,T,conv_dim) conv output (time stride conv_dim)
    expanded over heads (head stride 0); log_a (B,H,T) contiguous."""
    import torch
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h, n = d_inner // s.head_dim, s.d_state
    conv = (torch.randn(bsz, t, d_inner + 2 * n, generator=gen, device=dev)
            * 0.5).bfloat16()
    xs, bs, cs = torch.split(conv, [d_inner, n, n], -1)
    dt = torch.rand(bsz, t, h, generator=gen, device=dev) * 0.5 + 0.05
    xdt = xs.reshape(bsz, t, h, s.head_dim) * dt[..., None]
    la = -(dt * 0.4).transpose(1, 2).contiguous()
    b, c = [v.reshape(bsz, t, 1, n).expand(bsz, t, h, n).transpose(1, 2)
            for v in (bs, cs)]
    return xdt.transpose(1, 2), la, b, c


def phase_ssd(cfgs):
    """K4 against its plain version; returns per-shape records.  "main"
    cases are contiguous (BH,T,.) operands at each model's serve widths,
    "layout" cases the serve's own strided views (:func:`_model_layout`),
    held against ``ref.ssd_chunked4`` on contiguous copies."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("test", None, shape, dt, dt) for dt in (f32, bf16)
             for shape in ((2, 64, 16, 8, 16), (1, 100, 32, 16, 32),
                           (3, 33, 8, 4, 16), (1, 16, 8, 8, 16))]
    cases += [("impulse", None, (1, 64, 4, 4, 16), f32, f32)]
    for cfg in cfgs:
        s = cfg.ssm
        bh = s.expand * cfg.d_model // s.head_dim     # one sequence's heads
        cases += [("main", cfg, (bh, t, s.head_dim, s.d_state, s.chunk),
                   f32, bf16) for t in (37, 64, LONG_PROMPT, 2048)]
        cases += [("layout", cfg, (bsz * bh, t, s.head_dim, s.d_state,
                                   s.chunk), f32, bf16)
                  for bsz, t in ((1, LONG_PROMPT), (2, 64))]
    records = []
    for kind, cfg, (rows, t, p, n, chunk), xdt, bdt in cases:
        plain = ref.ssd_chunked
        bc_rows = None
        if kind == "layout":
            s = cfg.ssm
            bh = s.expand * cfg.d_model // s.head_dim
            x, la, b, c = _model_layout(rows // bh, t, cfg, gen, dev)
            bc_rows = rows // bh
            plain = lambda *a, chunk: ref.ssd_chunked4(  # noqa: E731
                *[v.contiguous() for v in a], chunk=chunk)
        elif kind == "impulse":
            x = torch.zeros(rows, t, p, device=dev)
            x[0, 0] = 1.0
            la = torch.full((rows, t), -0.01, device=dev)
            b = c = torch.ones(rows, t, n, device=dev)
        else:
            x = (torch.randn(rows, t, p, generator=gen, device=dev)
                 * 0.5).to(xdt)
            la = -(torch.randn(rows, t, generator=gen, device=dev)
                   * 0.2).abs()
            b = (torch.randn(rows, t, n, generator=gen, device=dev)
                 * 0.5).to(bdt)
            c = (torch.randn(rows, t, n, generator=gen, device=dev)
                 * 0.5).to(bdt)
        var = k4.variant(x, b, c)
        got = k4.ssd_scan(x, la, b, c, chunk=chunk)
        torch.cuda.synchronize()
        want = plain(x, la, b, c, chunk=chunk)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K4 {kind} {(rows, t, p, n)}: shape/dtype "
                                 f"{got.shape} {got.dtype} vs {want.shape} "
                                 f"{want.dtype}")
        atol, rtol = K4_TOL[str(xdt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        if kind == "impulse":
            ok = ok and float(got[0, -1].abs().max()) > 0.1
        if kind in ("main", "layout") and var != "mma":
            ok = False                  # a main-path shape must take mma
        iters = 10 if t >= 1024 else 20
        ms = timed_ms(lambda *a: k4.ssd_scan(*a, chunk=chunk),
                      [(x, la, b, c)], iters)
        dev_ms = device_ms(lambda *a: k4.ssd_scan(*a, chunk=chunk),
                           [(x, la, b, c)], iters) \
            if kind in ("main", "layout") else None
        plain_ms = timed_ms(lambda *a: plain(*a, chunk=chunk),
                            [(x, la, b, c)], iters)
        bound_ms, bound_by = k4_bound(rows, t, p, n, chunk,
                                      x.element_size(), b.element_size(),
                                      bc_rows)
        rec = dict(kind=kind, model=cfg.name if cfg else "test", bh=rows,
                   t=t, p=p, n=n, chunk=chunk, variant=var,
                   x_dtype=str(xdt).removeprefix("torch."),
                   bc_dtype=str(bdt).removeprefix("torch."),
                   max_abs_err=err, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        records.append(rec)
        log(f"[ssd] ssd_scan {kind:7s} {rec['model']} "
            f"(bh,t,p,n,chunk)={(rows, t, p, n, chunk)} "
            f"x {rec['x_dtype']} b/c {rec['bc_dtype']} {var}"
            f": max_abs_err={err:.3g} "
            f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'} | kernel "
            f"{ms:.4f} ms" + (f" (device {dev_ms:.4f} ms)" if dev_ms else "")
            + f", plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"K4 disagrees with its plain version or a "
                             f"main-path shape missed the mma variant: {bad}")
    return records


def _bits_equal(got, want):
    """(bit-exact, max |got - want| over non-NaN entries): equal shape,
    dtype and bits, NaN where the other is NaN (a NaN's payload is the
    hardware's, not the function's)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got[~nan].view(ints), want[~nan].view(ints)))
    keep = ~(nan | torch.isnan(got))
    err = float((got[keep].float() - want[keep].float()).abs().max()) \
        if bool(keep.any()) else 0.0
    return same, err


def _rotation(nbytes):
    """How many copies of a call's operands to cycle through so that the
    copies together exceed the 50 MB L2 four times (at most 64)."""
    return max(1, min(64, -(-4 * 50 * 2 ** 20 // nbytes)))


def phase_elementwise(dev):
    """K2 bit for bit against its plain version; returns records."""
    import torch
    from repro_torch.kernels import elementwise as k2
    from repro_torch.kernels import ref
    from repro_torch.launch import hw

    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    lib = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            1e-40, -1e-40, 6e-8, -3e-39], device=dev)

    def pair(m, c, dt):
        return [torch.randn(m, c, generator=gen, device=dev).to(dt)
                for _ in range(2)]

    cases = [("test", (m, c), dt, kind, relu)
             for m, c in ((128, 2048), (57, 129), (1, 8))
             for dt in dtypes for kind in lib for relu in (False, True)]
    cases += [("specials", (4, 37), dt, kind, relu) for dt in dtypes
              for kind in lib for relu in (False, True)]
    cases += [("misaligned", (33, 64), dt, kind, True) for dt in dtypes
              for kind in lib]
    cases += [("model", shape, dt, kind, False)
              for shape, dt in K2_MODEL_CASES for kind in lib]
    records, bad = [], []
    for what, (m, c), dt_name, kind, relu in cases:
        dt = dtypes[dt_name]
        a, b = pair(m, c, dt)
        if what == "specials":
            a[0, :8] = special.to(dt)
            a[3, -8:] = special.to(dt)
            b[1, :8] = special.to(dt)
        elif what == "misaligned":
            base = torch.randn(m * c + 1, generator=gen, device=dev).to(dt)
            a = base[1:].view(m, c)          # contiguous, not 16-B aligned
        got = k2.ame_elementwise(a, b, kind=kind, relu=relu)
        torch.cuda.synchronize()
        same, err = _bits_equal(got, ref.elementwise(kind, a, b, relu=relu))
        if what == "specials" and relu and not bool(torch.isnan(got[0, 0])):
            same = False                     # ReLU must pass a NaN through
        rec = dict(kind=what, shape=(m, c), dtype=dt_name, op=kind,
                   relu=relu, bit_exact=same, max_abs_err=err)
        if what == "model":
            nbytes = 3 * m * c * a.element_size()
            args = [(a, b)] + [tuple(pair(m, c, dt))
                               for _ in range(_rotation(nbytes) - 1)]
            rec.update(
                ms=timed_ms(lambda x, y: k2.ame_elementwise(x, y, kind=kind),
                            args, 20),
                plain_ms=timed_ms(lambda x, y: ref.elementwise(kind, x, y),
                                  args, 20),
                library_ms=timed_ms(lib[kind], args, 20),
                device_ms=device_ms(
                    lambda x, y: k2.ame_elementwise(x, y, kind=kind), args, 20),
                library_device_ms=device_ms(lib[kind], args, 20),
                host_us=host_us(
                    lambda x, y: k2.ame_elementwise(x, y, kind=kind), args, 200),
                library_host_us=host_us(lib[kind], args, 200),
                bound_ms=1e3 * nbytes / hw.HBM_BW, bound_by="bytes")
            log(f"[elementwise] ame_elementwise {kind} {(m, c)} {dt_name}: "
                f"bit-exact {same} | device: kernel {rec['device_ms']:.4f} "
                f"ms, torch.{kind} {rec['library_device_ms']:.4f} ms | "
                f"events: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.4f} ms, torch.{kind} "
                f"{rec['library_ms']:.4f} ms | host: kernel "
                f"{rec['host_us']:.1f} us, torch.{kind} "
                f"{rec['library_host_us']:.1f} us | bound "
                f"{rec['bound_ms']:.4f} ms (bytes)")
        records.append(rec)
        if not same:
            bad.append(rec)
    log(f"[elementwise] {len(records)} cases, "
        f"{sum(r['bit_exact'] for r in records)} bit-exact with the plain "
        f"version")
    if bad:
        raise AssertionError(f"K2 differs from its plain version: {bad}")
    return records


def visible_pairs(tq, tk, causal, window):
    """(query, key) pairs the masks keep, queries end-aligned."""
    total = 0
    for i in range(tq):
        qpos = i + tk - tq
        hi = min(tk - 1, qpos) if causal else tk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def k3_bound(bh, tq, tk, d, causal, window, itemsize):
    """(bound ms, "bytes" | "operations") of one flash_attention call:
    q, k, v read once and o written once; 4 D FLOPs per visible pair (q k^T
    and p v) at the bf16 tensor-core peak."""
    from repro_torch.launch import hw
    t_bytes = bh * (2 * tq + 2 * tk) * d * itemsize / hw.HBM_BW
    t_ops = 4 * d * bh * visible_pairs(tq, tk, causal, window) \
        / hw.PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _sdpa(causal, window, tq, tk, dev):
    """torch's scaled_dot_product_attention on (BH, T, D) operands with the
    reference's end-aligned masks.  Its ``is_causal`` is top-left aligned,
    so it is used only where that is the same (Tq == Tk, no window); else
    an explicit boolean mask built for end alignment."""
    import torch
    import torch.nn.functional as F
    mask = None
    if window > 0 or (causal and tq != tk):
        qpos = torch.arange(tq, device=dev)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=dev)[None, :]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
    is_causal = causal and mask is None

    def call(q, k, v):
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask,
            is_causal=is_causal)[0]
    return call


def _model_qkv(bh, tq, tk, d, gen, dev):
    """bf16 q, k, v of a model case: peaked scores, O(1) outputs."""
    import torch
    return [(torch.randn(bh, t, d, generator=gen, device=dev) * s).bfloat16()
            for t, s in ((tq, K3_MODEL_QK_SCALE), (tk, K3_MODEL_QK_SCALE),
                         (tk, 1.0))]


def phase_attention(dev):
    """K3 against its plain version; returns records.  The reference's
    shapes and every f32 case are held to the reference's tolerances; every
    other bf16 case (each bf16 block, the window case, the model shapes)
    runs on the peaked inputs of :func:`_model_qkv` at one bf16 ulp."""
    import torch
    from repro_torch.kernels import attention as k3
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    tests = [(2, 64, 64, 32, True, 0), (1, 128, 128, 64, True, 0),
             (1, 100, 100, 32, True, 0), (2, 64, 64, 32, False, 0),
             (1, 128, 128, 32, True, 48), (1, 16, 128, 32, True, 0)]
    cases = [("test", shape[:4], shape[4], shape[5], dt, None)
             for shape in tests for dt in (f32, bf16)]
    cases += [("sweep", (1, 96, 96, 32), True, 0, f32, blocks)
              for blocks in k3.BLOCKS]
    cases += [("sweep", (1, 96, 96, d), True, 0, bf16, blocks)
              for d in (32, 256) for blocks in k3.MMA_BLOCKS]
    # a window wider than block_k over T > 2 block_k: the kernel
    # starts later query blocks' KV walk past tile 0 (kbeg > 0)
    cases += [("window", (2, 512, 512, 128), True, 200, dt, None)
              for dt in (f32, bf16)]
    cases += [(name, shape, causal, window, bf16, None)
              for name, shape, causal, window in K3_MODEL_CASES]
    records, bad = [], []
    for what, (bh, tq, tk, d), causal, window, dt, blocks in cases:
        model = what not in ("test", "sweep", "window")
        peaked = dt == bf16 and what != "test"
        if peaked:
            q, k, v = _model_qkv(bh, tq, tk, d, gen, dev)
        else:
            q, k, v = [(torch.randn(bh, t, d, generator=gen, device=dev)
                        * 0.5).to(dt) for t in (tq, tk, tk)]
        kw = dict(causal=causal, window=window)
        if blocks:
            kw.update(block_q=blocks[0], block_k=blocks[1])
        got = k3.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window)
        dt_name = str(dt).removeprefix("torch.")
        atol, rtol = K3_MODEL_TOL if peaked else K3_TOL[dt_name]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = got.shape == want.shape and got.dtype == want.dtype and bool(
            (diff <= atol + rtol * want.float().abs()).all())
        rec = dict(kind=what, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   window=window, dtype=dt_name,
                   blocks=blocks or "default", max_abs_err=err,
                   atol=atol, rtol=rtol, ok=ok)
        line = (f"[attention] flash_attention {what:20s} (bh,tq,tk,d)="
                f"{(bh, tq, tk, d)} causal={causal} window={window} "
                f"{dt_name} blocks={rec['blocks']}: max_abs_err={err:.3g} "
                f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}")
        if peaked:
            # the limit must be able to fail a wrong kernel: the plain
            # outputs have to stand well clear of it
            rec["plain_mean_abs"] = float(want.float().abs().mean())
            line += f"; mean |plain| {rec['plain_mean_abs']:.3g}"
            if rec["plain_mean_abs"] < 10 * (atol + rtol):
                ok = rec["ok"] = False
                line += " (too close to the limit to test the kernel)"
        if model:
            lib = _sdpa(causal, window, tq, tk, dev)
            lib_diff = (lib(q, k, v).float() - want.float()).abs()
            lib_err = float(lib_diff.max())
            lib_atol, lib_rtol = K3_TOL["bfloat16"]
            iters = 3 if tq * tk > 2 ** 24 else 10
            rec.update(
                ms=timed_ms(lambda *a: k3.flash_attention(*a, **kw),
                            [(q, k, v)], iters),
                plain_ms=timed_ms(lambda *a: ref.attention(*a, **kw),
                                  [(q, k, v)], iters),
                library_ms=timed_ms(lib, [(q, k, v)], iters),
                device_ms=device_ms(lambda *a: k3.flash_attention(*a, **kw),
                                    [(q, k, v)], iters),
                library_device_ms=device_ms(lib, [(q, k, v)], iters),
                library_max_abs_err=lib_err)
            rec["bound_ms"], rec["bound_by"] = k3_bound(
                bh, tq, tk, d, causal, window, q.element_size())
            # SDPA rounds p to bf16 before p @ v, so it is held to the
            # reference's bf16 limit: with O(1) outputs a wrong mask
            # still lands far past it
            if not bool((lib_diff <= lib_atol
                         + lib_rtol * want.float().abs()).all()):
                ok = rec["ok"] = False
                line += f"; SDPA's mask disagrees ({lib_err:.3g})"
            line += (f" | device: kernel {rec['device_ms']:.4f} ms, sdpa "
                     f"{rec['library_device_ms']:.4f} ms | events: kernel "
                     f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                     f"sdpa {rec['library_ms']:.4f} ms (max_abs_err "
                     f"{lib_err:.3g} vs plain) | bound {rec['bound_ms']:.4f} "
                     f"ms ({rec['bound_by']})")
        log(line)
        records.append(rec)
        if not ok:
            bad.append(rec)
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version: {bad}")
    return records


def chat_positions(b, seed=0):
    """Live positions of a mid-window step of the chat cell: each slot's
    prompt log-uniform on [32, 1024] plus a uniform share of an answer
    log-uniform on [16, 256] (portbench/traffic/chat.json's lengths)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prompt = np.exp(rng.uniform(np.log(32), np.log(1024), b))
    answer = np.exp(rng.uniform(np.log(16), np.log(256), b))
    return (prompt + rng.uniform(0, 1, b) * answer).astype(int).tolist()


def decode_attn_inputs(b, clen, hkv, g, d, positions, gen, dev):
    """q and a bf16 slot cache as the decode branch hands them over: slot
    j holds position j up to the slot's own position; past it, stale
    entries of an earlier, longer request (position j) or -1."""
    import torch
    q = torch.randn(b, 1, hkv * g, d, generator=gen, device=dev)
    k = torch.randn(b, clen, hkv, d, generator=gen, device=dev)
    v = torch.randn(b, clen, hkv, d, generator=gen, device=dev)
    pos = torch.as_tensor(positions, dtype=torch.long, device=dev)
    kpos = torch.arange(clen, device=dev).expand(b, clen).clone()
    kpos[torch.rand(b, clen, generator=gen, device=dev) < 0.05] = -1
    kpos[torch.arange(b, device=dev), pos] = pos
    return (q.bfloat16(), k.bfloat16(), v.bfloat16(), kpos.to(torch.int32),
            pos)


def phase_decode_attention(dev):
    """The decode attention kernel against chunked_attention's decode
    call (one bf16 ulp of the output's scale); the chat step timed.
    Returns records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.launch import hw
    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator(device=dev).manual_seed(7)

    def plain(q, k, v, kpos, pos):
        return chunked_attention(q, k, v, causal=True, q_offset=pos,
                                 kv_positions=kpos)

    def sdpa(q, k, v, keep):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=keep, enable_gqa=True)

    records, bad = [], []
    for name, b, clen, hkv, g, d in DECODE_ATTN_CASES:
        positions = [min(p, clen - 1) for p in chat_positions(b, b + d)]
        args = [decode_attn_inputs(b, clen, hkv, g, d, positions, gen, dev)
                for _ in range(DECODE_ATTN_LAYERS if name == "chat" else 1)]
        got = kd.decode_attention(*args[0])
        torch.cuda.synchronize()
        want = plain(*args[0]).float()
        err = float((got.float() - want).abs().max())
        ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
        ok = err <= ulp and got.shape == want.shape
        live = sum(min(p + 1, clen) for p in positions)
        rec = dict(kind=name, b=b, clen=clen, hkv=hkv, g=g, d=d,
                   live_keys=live, max_abs_err=err, ulp=ulp, ok=ok)
        line = (f"[decode_attn] {name:15s} (b,clen,hkv,g,d)="
                f"{(b, clen, hkv, g, d)} bf16, {live} live keys of "
                f"{b * clen}: max_abs_err={err:.3g} (one bf16 ulp "
                f"{ulp:.3g}) {'ok' if ok else 'FAIL'}")
        if name == "chat":
            # SDPA attends over the whole cache under a boolean mask of
            # the keys each slot sees, built once outside the timing
            lib_args = [(q, k, v, ((kpos >= 0) & (kpos <= pos[:, None]))[
                :, None, None, :]) for q, k, v, kpos, pos in args]
            lib = sdpa(*lib_args[0]).float()
            lib_err = float((lib - want).abs().max())
            rec.update(
                ms=timed_ms(kd.decode_attention, args, 40),
                plain_ms=timed_ms(plain, args, 8),
                library_ms=timed_ms(sdpa, lib_args, 20),
                device_ms=device_ms(kd.decode_attention, args, 40),
                library_device_ms=device_ms(sdpa, lib_args, 20),
                host_us=host_us(kd.decode_attention, args, 40),
                plain_host_us=host_us(plain, args, 8),
                library_max_abs_err=lib_err,
                bound_ms=1e3 * live * hkv * d * 2 * 2 / hw.HBM_BW,
                bound_by="bytes")
            line += (f" | device: kernel {rec['device_ms']:.4f} ms, sdpa "
                     f"{rec['library_device_ms']:.4f} ms | events: kernel "
                     f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                     f"sdpa {rec['library_ms']:.4f} ms (max_abs_err "
                     f"{lib_err:.3g} vs plain) | host: kernel "
                     f"{rec['host_us']:.1f} us, plain "
                     f"{rec['plain_host_us']:.1f} us a call | bound "
                     f"{rec['bound_ms']:.4f} ms (bytes: the live K and V) "
                     f"| {kd.splits(b, hkv, clen)[1]} splits of "
                     f"{kd.splits(b, hkv, clen)[0]} keys")
        log(line)
        records.append(rec)
        if not ok:
            bad.append(rec)
    if bad:
        raise AssertionError(f"the decode attention kernel disagrees with "
                             f"chunked_attention: {bad}")
    return records


def mla_decode_bound_ms(b, h, r, rd, live):
    """The least time of MLA's decode attention over ``live`` keys in all:
    each live latent (r + rd bf16) read once, qq read and o written once,
    against 2 h (2 r + rd) FLOPs a key; the larger of the two at the
    card's peaks.  Returns (ms, what bounds it)."""
    from repro_torch.launch import hw
    nbytes = 2 * (live * (r + rd) + b * h * (r + rd) + b * h * r)
    flops = 2 * h * (2 * r + rd) * live
    by_bytes, by_flops = nbytes / hw.HBM_BW, flops / hw.PEAK_FLOPS
    return 1e3 * max(by_bytes, by_flops), \
        "bytes" if by_bytes >= by_flops else "operations"


def phase_mla_decode(dev):
    """MLA's decode kernel against its plain version (one bf16 ulp of the
    output's scale); the cell's step timed.  Returns records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mla_decode as km
    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator(device=dev).manual_seed(11)

    def inputs(b, clen, h, r, rd, positions):
        qq = torch.randn(b, 1, h, r + rd, generator=gen, device=dev)
        ckv = torch.randn(b, clen, r, generator=gen, device=dev)
        kr = torch.randn(b, clen, rd, generator=gen, device=dev)
        return (qq.bfloat16(), ckv.bfloat16(), kr.bfloat16(),
                torch.as_tensor(positions, dtype=torch.long, device=dev))

    def chunked(qq, kk, ckv, pos):
        return chunked_attention(qq, kk, ckv[:, :, None, :], causal=True,
                                 q_offset=pos)

    def sdpa(qq, kk, ckv, keep):
        # the heads as the queries of one KV head, the live keys by a mask
        return F.scaled_dot_product_attention(
            qq, kk.transpose(1, 2), ckv[:, None], attn_mask=keep)

    records, bad = [], []
    for name, b, clen, h, r, rd in MLA_DECODE_CASES:
        positions = [min(p, clen - 1) for p in chat_positions(b, b + r)]
        args = [inputs(b, clen, h, r, rd, positions) for _ in range(
            MLA_DECODE_LAYERS if name == "deepseek-v3.chat-64" else 1)]
        got = km.mla_decode(*args[0])
        torch.cuda.synchronize()
        want = km.plain(*args[0]).float()
        err = float((got.float() - want).abs().max())
        ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
        ok = err <= ulp and got.shape == want.shape
        live = sum(min(p + 1, clen) for p in positions)
        blocks = -(-h // km.ROWS)
        rec = dict(kind=name, b=b, clen=clen, h=h, r=r, rd=rd,
                   live_keys=live, max_abs_err=err, ulp=ulp, ok=ok)
        line = (f"[mla_decode] {name:19s} (b,clen,h,r,rd)="
                f"{(b, clen, h, r, rd)} bf16, {live} live keys of "
                f"{b * clen}: max_abs_err={err:.3g} (one bf16 ulp "
                f"{ulp:.3g}) {'ok' if ok else 'FAIL'}")
        if name == "deepseek-v3.chat-64":
            cat_args = [(qq, torch.cat([ckv, kr], -1)[:, :, None, :], ckv,
                         pos) for qq, ckv, kr, pos in args]
            lib_args = [(qq, kk, ckv, (torch.arange(clen, device=dev)[None]
                                       <= pos[:, None])[:, None, None, :])
                        for qq, kk, ckv, pos in cat_args]
            lib = sdpa(*lib_args[0]).float()
            lib_err = float((lib - want).abs().max())
            bound, by = mla_decode_bound_ms(b, h, r, rd, live)
            rec.update(
                ms=timed_ms(km.mla_decode, args, 30),
                plain_ms=timed_ms(km.plain, args, 6),
                chunked_ms=timed_ms(chunked, cat_args, 6),
                library_ms=timed_ms(sdpa, lib_args, 10),
                device_ms=device_ms(km.mla_decode, args, 30),
                plain_device_ms=device_ms(km.plain, args, 6),
                library_device_ms=device_ms(sdpa, lib_args, 10),
                host_us=host_us(km.mla_decode, args, 30),
                plain_host_us=host_us(km.plain, args, 6),
                library_max_abs_err=lib_err, bound_ms=bound, bound_by=by)
            split_len, nsplit = km.splits(b, blocks, clen)
            line += (f" | device: kernel {rec['device_ms']:.4f} ms, plain "
                     f"{rec['plain_device_ms']:.4f} ms, sdpa "
                     f"{rec['library_device_ms']:.4f} ms | events: kernel "
                     f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                     f"chunked_attention alone {rec['chunked_ms']:.4f} ms, "
                     f"sdpa {rec['library_ms']:.4f} ms (max_abs_err "
                     f"{lib_err:.3g} vs plain) | host: kernel "
                     f"{rec['host_us']:.1f} us, plain "
                     f"{rec['plain_host_us']:.1f} us a call | bound "
                     f"{bound:.4f} ms ({by}), kernel at "
                     f"{100 * bound / rec['device_ms']:.1f} % | {nsplit} "
                     f"splits of {split_len} keys")
        log(line)
        records.append(rec)
        if not ok:
            bad.append(rec)
    if bad:
        raise AssertionError(f"the MLA decode kernel disagrees with its "
                             f"plain version: {bad}")
    return records


def _strict_ew(kind, a, b):
    """The numpy strict interpreter's mf<kind> of two FP16 tiles."""
    from repro_torch.core import pep
    ch, mm = pep.init_channel(nblocks=4096, b_region_blocks=64, tile_cols=64)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[0], a)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[1], b)
    pep.run_ew_strict(ch, mm, kind, mm.tiles[0], mm.tiles[1], mm.accs[0],
                      a.shape[1])
    return pep.banks_to_tile(ch.state.odd_banks, mm.accs[0], *a.shape)


def _strict_mac(a, b):
    """The numpy strict interpreter's mfmacc of FP16 A (m,k) @ B (k,n)."""
    import numpy as np
    from repro_torch.core import pep
    (m, k), n = a.shape, b.shape[1]
    ch, mm = pep.init_channel(nblocks=4096, b_region_blocks=64, tile_cols=64)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[0], a)
    pep.scalars_to_bank0(ch.state.even_banks, mm.b_scalars, b.T)
    pep.tile_to_banks(ch.state.odd_banks, mm.accs[0],
                      np.zeros((m, n), np.float16))
    pep.run_mac_strict(ch, mm, mm.tiles[0], mm.accs[0], k, n)
    return pep.banks_to_tile(ch.state.odd_banks, mm.accs[0], m, n)


def phase_engine(dev):
    """Quickstart part 1 through repro_torch.core on the card, the modeled
    headline, and the engine's numerics bit for bit against the strict
    interpreter and K2."""
    import numpy as np
    import torch
    from repro_torch.core import (AMEEngine, UnsupportedOnPIM,
                                  ew_on_engine_batched,
                                  gemm_on_engine_batched, max_tile_mfmacc,
                                  saturated_flop_per_cycle)
    from repro_torch.core.isa import PIM_FREQ_HZ
    from repro_torch.kernels import elementwise as k2

    rng = np.random.default_rng(0)
    eng = AMEEngine(device=dev)
    a = torch.as_tensor(rng.standard_normal((128, 64)) * 0.3,
                        dtype=torch.float16, device=dev)
    b = torch.as_tensor(rng.standard_normal((128, 64)) * 0.3,
                        dtype=torch.float16, device=dev)
    eng.msettilem(128), eng.msettilek(64)
    eng.mld(0, a)
    eng.mld(1, b)
    rep = eng.mfadd(0, 0, 1)
    log(f"[engine] mfadd.h.mm 128x64: {rep.cycles:.0f} cycles "
        f"({rep.flop_per_cycle:.1f} FLOP/cycle)")
    rep = eng.mfsub(0, 0, 1)
    log(f"[engine] mfsub.h.mm 128x64: {rep.cycles:.0f} cycles (emulated, "
        f"{rep.flop_per_cycle:.1f} FLOP/cycle)")
    try:
        eng.mfmax(0, 0, 1)
        raise AssertionError("mfmax.h.mm ran; Table 1 has no PIM mapping")
    except UnsupportedOnPIM as e:
        log(f"[engine] mfmax.h.mm: refused -> {e}")
    eng2 = AMEEngine(device=dev)
    w = torch.as_tensor(rng.standard_normal((64, 32)) * 0.3,
                        dtype=torch.float16, device=dev)
    eng2.msettilem(128), eng2.msettilek(64), eng2.msettilen(32)
    eng2.mld(0, a)
    eng2.mld(1, w)
    rep = eng2.mfmacc(0, 0, 1)
    out = eng2.mst(0)
    if out.device != a.device:
        raise AssertionError(f"engine output on {out.device}, not the card")
    err = float((out.float() - a.float() @ w.float()).abs().max())
    log(f"[engine] mfmacc.h 128x64x32: {rep.cycles:.0f} cycles, max err vs "
        f"fp32 {err:.3f}")
    if not err < 0.05:
        raise AssertionError(f"mfmacc differs from fp32 by {err}")

    head = max_tile_mfmacc()
    sat = saturated_flop_per_cycle("mac")
    log(f"[engine] modeled Aquabolt-XL cycles (independent of the machine): "
        f"mfmacc at 128x4096 tiles {head.flop_per_cycle:.1f} FLOP/cycle "
        f"with setup, {sat:.2f} saturated, {sat * PIM_FREQ_HZ / 1e9:.2f} "
        f"GFLOP/s at 250 MHz, {head.launches} MAC-PEP launches  "
        f"[paper: 59.4 / 14.9 / 256]")
    if abs(sat - 59.4) >= 0.1 or abs(sat * PIM_FREQ_HZ / 1e9 - 14.9) >= 0.1 \
            or head.launches != 256:
        raise AssertionError("the modeled headline is not 59.4 / 14.9 / 256")

    checks = {}
    a16 = (rng.standard_normal((128, 40)) * 0.5).astype(np.float16)
    b16 = (rng.standard_normal((40, 8)) * 0.5).astype(np.float16)
    got = gemm_on_engine_batched(AMEEngine(device=dev),
                                 torch.from_numpy(a16).to(dev),
                                 torch.from_numpy(b16).to(dev))
    checks["gemm_on_engine_batched (128,40,8) vs strict"] = np.array_equal(
        got.cpu().numpy().view(np.int16), _strict_mac(a16, b16).view(np.int16))
    x16 = rng.standard_normal((77, 19)).astype(np.float16)
    y16 = rng.standard_normal((77, 19)).astype(np.float16)
    for kind in ("add", "sub", "mul"):
        got = ew_on_engine_batched(AMEEngine(device=dev), kind,
                                   torch.from_numpy(x16).to(dev),
                                   torch.from_numpy(y16).to(dev))
        checks[f"ew_on_engine_batched {kind} (77,19) vs strict"] = \
            np.array_equal(got.cpu().numpy().view(np.int16),
                           _strict_ew(kind, x16, y16).view(np.int16))
    gen = torch.Generator(device=dev).manual_seed(5)
    ta, tb = [torch.randn(128, 4096, generator=gen, device=dev).half()
              for _ in range(2)]
    for kind in ("add", "sub", "mul"):
        got = ew_on_engine_batched(AMEEngine(device=dev), kind, ta, tb)
        checks[f"ew_on_engine_batched {kind} (128,4096) vs K2"] = \
            _bits_equal(k2.ame_elementwise(ta, tb, kind=kind), got)[0]
    torch.cuda.synchronize()
    for name, same in checks.items():
        log(f"[engine] {name}: {'bit-exact' if same else 'DIFFERS'}")
    if not all(checks.values()):
        raise AssertionError("the engine's numerics differ on the card")


def phase_runtime(dev, card_name):
    """Quickstart part 2 through repro_torch.runtime: pim_gemm numeric on
    the card (tensor operands there) against the same calls on the CPU
    (numpy operands), bit for bit, with byte-identical command traces; the
    BENCH_runtime.json cluster values, exactly.  Cycles are modeled
    Aquabolt-XL cycles, independent of the machine."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.runtime import PIMRuntime, emit_trace, pim_gemm

    rng = np.random.default_rng(0)
    m, k, n = RUNTIME_GEMM
    a = (rng.standard_normal((m, k)) * 0.2).astype(np.float16)
    b = (rng.standard_normal((k, n)) * 0.2).astype(np.float16)
    on_card = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    outs = {}
    for ch in (1, 2):
        runs = {}
        for where, device, ops in (("cpu", "cpu", (a, b)),
                                   ("card", dev, on_card)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt = PIMRuntime(channels=ch, device=device)
            out, rep = rt.gemm(*ops)
            torch.cuda.synchronize()
            runs[where] = dict(out=out, rep=rep, wall=time.perf_counter()
                               - t0, trace=emit_trace(rt.stack))
        cpu, card = runs["cpu"], runs["card"]
        same = card["out"].device == on_card[0].device \
            and card["out"].dtype == torch.float16 \
            and torch.equal(card["out"].cpu().view(torch.int16),
                            cpu["out"].view(torch.int16))
        same_rep = dataclasses.asdict(card["rep"]) \
            == dataclasses.asdict(cpu["rep"])
        same_trace = card["trace"] == cpu["trace"]
        outs[ch] = cpu["out"]
        log(f"[runtime] pim_gemm {m}x{k}x{n}, {ch} pseudo-channel(s): "
            f"{card['rep'].makespan_cycles:.0f} modeled cycles, "
            f"{card['rep'].flop_per_cycle:.1f} FLOP/cycle; card vs CPU: "
            f"outputs {'bit-exact' if same else 'DIFFER'}, reports "
            f"{'equal' if same_rep else 'DIFFER'}, trace "
            f"{'byte-identical' if same_trace else 'DIFFERS'} "
            f"({len(card['trace'])} bytes); wall {1e3 * card['wall']:.1f} "
            f"ms on {card_name} (numeric run), {1e3 * cpu['wall']:.1f} ms on "
            f"the CPU")
        if not (same and same_rep and same_trace):
            raise AssertionError("the runtime on the card differs from the "
                                 "CPU")
    if not torch.equal(outs[1].view(torch.int16), outs[2].view(torch.int16)):
        raise AssertionError("2 pseudo-channels differ from 1")
    z = lambda *shape: np.broadcast_to(np.float16(0), shape)   # noqa: E731
    got = {"parity_makespan": {
        f"{st}x{c}": pim_gemm(z(512, 512), z(512, 512), channels=c,
                              placement="2d-block", execute=False,
                              stacks=st, device=dev)[1].makespan_cycles
        for st, c in ((1, 16), (2, 8), (4, 4))}}
    for key, (pm, pk, pn), placement in (
            ("gemm_eff_4stack", (2048, 4096, 2048), "2d-block"),
            ("gemv_eff_4stack", (151936, 8192, 1), "balanced")):
        mk = [pim_gemm(z(pm, pk), z(pk, pn), channels=16,
                       placement=placement, execute=False, stacks=st,
                       device=dev)[1].cluster_makespan_cycles
              for st in (1, 4)]
        got[key] = round(mk[0] / mk[1] / 4, 6)
    want = json.loads(BENCH_RUNTIME.read_text())["cluster"]
    log(f"[runtime] cluster: {got} [results/BENCH_runtime.json: "
        f"parity_makespan {want['parity_makespan']}, gemm_eff_4stack "
        f"{want['gemm_eff_4stack']}, gemv_eff_4stack "
        f"{want['gemv_eff_4stack']}]")
    if set(got["parity_makespan"].values()) != {want["parity_makespan"]} \
            or any(got[key] != want[key]
                   for key in ("gemm_eff_4stack", "gemv_eff_4stack")):
        raise AssertionError("the runtime's cluster values differ from "
                             "results/BENCH_runtime.json")


def phase_quickstart(dev):
    """``repro_torch.quickstart``, the port of examples/quickstart.py: its
    ``main()`` on the card in this process (K1's counts set to 0 just
    before and read just after: one launch, on fma) against
    ``main("cpu")``, every line ``==`` but the kernel line; then ``python
    -m repro_torch.quickstart`` with no flags (its default is the card).
    Returns the launches."""
    import contextlib
    import io
    import os

    from repro_torch import quickstart

    def lines(device):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = quickstart.main(device)
        if rc != 0:
            raise AssertionError(f"quickstart.main({device!r}) returned {rc}")
        return buf.getvalue().splitlines(), time.perf_counter() - t0

    (card, card_s), launches, variants = _count_k1(lambda: lines(None))
    cpu, cpu_s = lines("cpu")
    for line in card:
        log(f"[quickstart] {line}")
    kernel = [i for i, line in enumerate(card)
              if line.startswith("ame_gemm (")]
    if len(kernel) != 1:
        raise AssertionError(f"quickstart printed {len(kernel)} kernel lines")
    k_card, k_cpu = card.pop(kernel[0]), cpu.pop(kernel[0])
    same = card == cpu
    log(f"[quickstart] main() on {dev} vs main('cpu'): every other line "
        f"{'==' if same else 'DIFFERS'}; CPU's kernel line: {k_cpu}; "
        f"ame_gemm launches {launches}, by variant {variants}; wall "
        f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    if not same:
        raise AssertionError("quickstart's lines differ between the card "
                             "and the CPU")
    if not (k_card.startswith("ame_gemm (hand-written CUDA kernel K1, fma ")
            and k_cpu.startswith("ame_gemm (plain version, CPU)")):
        raise AssertionError(f"the kernel lines do not name K1's fma variant "
                             f"and the plain version: {k_card!r}, {k_cpu!r}")
    if launches != 1 or variants != {"mma": 0, "fma": 1}:
        raise AssertionError("quickstart did not launch K1 once, on fma")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=QUICKSTART_TIMEOUT)
    out = r.stdout.splitlines()
    log(f"[quickstart] python -m repro_torch.quickstart (no flags): exit "
        f"{r.returncode}, {time.perf_counter() - t0:.1f}s wall, kernel "
        f"line: {next((x for x in out if x.startswith('ame_gemm (')), '')}"
        f"; last line {out[-1] if out else ''!r}")
    if r.returncode != 0 or not out or out[-1] != "quickstart OK" \
            or "hand-written CUDA kernel K1" not in r.stdout:
        raise AssertionError(f"python -m repro_torch.quickstart failed: "
                             f"{r.stderr[-2000:]}")
    return {"launches": {"ame_gemm": launches, "ssd_scan": 0},
            "variants": variants}


def phase_ops(dev):
    """This slice's path, through the ops entry point: ops.elementwise and
    ops.attention at the model shapes, the kernel counts set to 0 just
    before and read just after; returns the launches."""
    import torch
    from repro_torch.kernels import attention as k3
    from repro_torch.kernels import elementwise as k2
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    dtypes = {"float16": torch.float16, "bfloat16": torch.bfloat16}
    ew_in = [(kind, [torch.randn(*shape, generator=gen, device=dev)
                     .to(dtypes[dt]) for _ in range(2)])
             for shape, dt in K2_MODEL_CASES for kind in ("add", "sub", "mul")]
    attn_in = [(causal, window, _model_qkv(bh, tq, tk, d, gen, dev))
               for _, (bh, tq, tk, d), causal, window in K3_MODEL_CASES]
    torch.cuda.synchronize()
    k2.launches = k3.launches = 0                     # the ops path starts
    ew_out = [ops.elementwise(kind, a, b, use_kernel=True)
              for kind, (a, b) in ew_in]
    attn_out = [ops.attention(q, k, v, causal=causal, window=window,
                              use_kernel=True)
                for causal, window, (q, k, v) in attn_in]
    torch.cuda.synchronize()
    launches = {"ame_elementwise": k2.launches,      # the ops path ends
                "flash_attention": k3.launches}
    log(f"[ops] ops.elementwise x {len(ew_in)}, ops.attention x "
        f"{len(attn_in)}: launches {launches}")
    if launches != {"ame_elementwise": len(ew_in),
                    "flash_attention": len(attn_in)}:
        raise AssertionError("the ops path did not launch each kernel once "
                             "per call")
    for (kind, (a, b)), got in zip(ew_in, ew_out):
        if not _bits_equal(got, ref.elementwise(kind, a, b))[0]:
            raise AssertionError(f"ops.elementwise {kind} {tuple(a.shape)} "
                                 f"differs from its plain version")
    atol, rtol = K3_MODEL_TOL
    for (causal, window, (q, k, v)), got in zip(attn_in, attn_out):
        want = ref.attention(q, k, v, causal=causal, window=window).float()
        if not (got.shape == q.shape and torch.isfinite(got).all()
                and ((got.float() - want).abs()
                     <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"ops.attention {tuple(q.shape)} differs "
                                 f"from its plain version")
    return launches


def _prompts(cfg):
    """Six seeded prompts of 8-64 tokens; for the models with a scan
    (mamba2-370m, zamba2-2.7b) the last is LONG_PROMPT tokens, so the
    server runs the multi-chunk scan."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = []
    for u in range(N_REQUESTS):
        n = int(rng.integers(8, 65))
        if cfg.ssm is not None and u == N_REQUESTS - 1:
            n = LONG_PROMPT
        prompts.append(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
    return prompts


def fill_lora(params, gen):
    """zamba2's ``lora_b`` starts at zero, as in the reference; seeded
    values make the per-application LoRA merge matter."""
    if "lora_b" in params["stack"]:
        params["stack"]["lora_b"].normal_(0.0, LORA_B_STD, generator=gen)


def decode_attention_layers(cfg):
    """The decode attention kernel's launches a decode step: one per
    window-free GQA attention layer (qwen3's 28, zamba2's 9 shared-block
    applications); a sliding window (mixtral) keeps chunked_attention, MLA
    (deepseek) takes its own kernel (:func:`mla_decode_layers`), and a
    Mamba2 layer has no attention."""
    if cfg.sliding_window or cfg.mla is not None:
        return 0
    if cfg.hybrid is not None:
        return cfg.n_layers // cfg.hybrid.shared_every
    return 0 if cfg.ssm is not None else cfg.n_layers


def mla_decode_layers(cfg):
    """MLA's decode kernel's launches a decode step: one per layer of a
    bf16 MLA model (deepseek); none for any other."""
    bf16 = cfg.policy.compute_dtype == "bfloat16"
    return cfg.n_layers if cfg.mla is not None and bf16 else 0


def phase_serve(cfg, dev):
    """Serve seeded requests at full width through the kernels; returns
    the serve summary with each kernel's launches on this path."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import mla_decode as km
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import model as lm
    from repro_torch.serve.loop import Request, Server

    scan = cfg.ssm is not None
    cache_len = CACHE_LEN[cfg.name]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    fill_lora(params, gen)
    srv = Server(cfg, params, slots=SLOTS, cache_len=cache_len,
                 backend="kernel", device=dev)
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    full_layers = get(cfg.name).n_layers
    cut = (f", cut to {cfg.n_layers} of {full_layers} layers at full "
           f"width" if cfg.n_layers < full_layers else "")
    log(f"[serve] {cfg.name}: {n_params:,} parameters ({cfg.n_layers} "
        f"layers{cut}, d_model {cfg.d_model}, params "
        f"{cfg.policy.param_dtype}, compute {cfg.policy.compute_dtype}) "
        f"ready in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    prompts = _prompts(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=MAX_NEW)
            for u, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    k1.launches = k4.launches = kd.launches = km.launches = 0  # starts
    k1.launches_by_variant.update(mma=0, fma=0)
    k4.launches_by_variant.update(mma=0, fma=0)
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ame_gemm": k1.launches,              # main path ends
                "ssd_scan": k4.launches,
                "decode_attention": kd.launches,
                "mla_decode": km.launches}
    k1_variants = dict(k1.launches_by_variant)
    k4_variants = dict(k4.launches_by_variant)
    tokens = sum(len(r.out_tokens) for r in done)
    forwards = srv.prefills + srv.decode_steps
    want = {"ame_gemm": k1_per_forward(cfg) * forwards,
            "ssd_scan": cfg.n_layers * sum(len(p) > 1 for p in prompts)
            if scan else 0,
            "decode_attention": decode_attention_layers(cfg)
            * srv.decode_steps,
            "mla_decode": mla_decode_layers(cfg) * srv.decode_steps}
    log(f"[serve] {len(done)} requests, {tokens} tokens, {srv.prefills} "
        f"prefills (prompts {sorted(len(p) for p in prompts)}) + "
        f"{srv.decode_steps} decode steps in {wall:.3f}s wall "
        f"(synchronised), {tokens / wall:.1f} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    variants = {"ame_gemm": k1_variants, "ssd_scan": k4_variants}
    for name, n in launches.items():
        log(f"[serve] {name} launches: {n} (expected {want[name]})"
            + (f", by variant {variants[name]}" if name in variants else ""))
    if len(done) != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests served")
    if launches != want or launches["ame_gemm"] == 0 \
            or (scan and launches["ssd_scan"] == 0):
        raise AssertionError("the main path did not go through the kernels "
                             "once per projection / per layer's scan")
    if k4_variants["fma"] or k1_variants["fma"]:
        raise AssertionError(f"a K1 or K4 launch of the serve took the fma "
                             f"variant: K1 {k1_variants}, K4 {k4_variants}")
    for r in done:
        if not (1 <= len(r.out_tokens) <= MAX_NEW
                and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
            raise AssertionError(f"request {r.uid}: bad tokens {r.out_tokens}")

    # the longest prompt's prefill logits, kernel vs the plain torch
    # backend, in f32 compute (the tight check) and in bf16 as served
    prompt = max(prompts, key=len)
    toks = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                      device=dev)}
    cfg32 = cfg.with_policy(compute_dtype="float32")
    logits, routes = {}, {}
    for compute, c, p in (("bf16", cfg, srv.params), ("f32", cfg32, params)):
        for be in ("kernel", "torch"):
            with recorded_routes() as routes[compute, be]:
                lg, _ = lm.prefill(p, toks, c, cache_len, backend=be)
            logits[compute, be] = lg[:, :cfg.vocab_size].float()
    if any(lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all()
           for lg in logits.values()):
        raise AssertionError("prefill logits are not finite (1, vocab)")
    atol, rtol = SERVE_F32_LOGITS_TOL
    lk, lt = logits["f32", "kernel"], logits["f32", "torch"]
    err32 = float((lk - lt).abs().max())
    ok32 = bool(((lk - lt).abs() <= atol + rtol * lt.abs()).all())
    lk, lt = logits["bf16", "kernel"], logits["bf16", "torch"]
    err = float((lk - lt).abs().max())
    noise = float((lt - logits["f32", "torch"]).abs().max())
    if cfg.name in SERVE_LOGITS_NOISE_FACTOR:
        tol = SERVE_LOGITS_NOISE_FACTOR[cfg.name] * noise
        rule = (f"limit {SERVE_LOGITS_NOISE_FACTOR[cfg.name]} x the torch "
                f"bf16-vs-f32 distance")
    else:
        tol, rule = SERVE_LOGITS_ATOL[cfg.name], "fixed limit"
    kernel_noise = float((lk - logits["f32", "torch"]).abs().max())
    log(f"[serve] {len(prompt)}-token prefill logits kernel vs torch: f32 "
        f"compute max_abs_err={err32:.4g} (atol {atol}, rtol {rtol}) "
        f"{'ok' if ok32 else 'FAIL'}; bf16 compute max_abs_err={err:.4g} "
        f"(atol {tol:.4g}, {rule}) {'ok' if err <= tol else 'FAIL'}; "
        f"logits max |x| {float(lt.abs().max()):.3g}; argmax "
        f"{int(lk.argmax())} vs {int(lt.argmax())}; torch bf16 vs f32 "
        f"compute {noise:.4g}, kernel bf16 vs torch f32 {kernel_noise:.4g}")
    if cfg.moe is not None:
        shares = [route_agreement(routes[a], routes[b]) for a, b in (
            (("f32", "kernel"), ("f32", "torch")),
            (("bf16", "kernel"), ("bf16", "torch")),
            (("bf16", "torch"), ("f32", "torch")))]
        log(f"[serve] {len(prompt)}-token prefill expert choices: share of "
            f"(token, layer) pairs whose top-{cfg.moe.top_k} expert set "
            f"agrees, over {len(routes['f32', 'kernel'])} MoE layers: kernel "
            f"vs torch {shares[0]:.4f} in f32 compute, {shares[1]:.4f} in "
            f"bf16; torch bf16 vs torch f32 {shares[2]:.4f}")
    if not ok32 or not err <= tol:
        raise AssertionError("kernel and torch backends disagree")
    phase_breakdown(cfg, srv.params, dev)
    if scan:
        phase_prefill_breakdown(cfg, srv.params, dev, prompt)
    if cfg.family == "hybrid":
        phase_lora_merge(cfg, srv.params)
    if cfg.moe is not None:
        phase_moe_split(cfg, srv.params, dev)
    del params, srv
    torch.cuda.empty_cache()
    return dict(requests=len(done), tokens=tokens, wall_s=wall,
                params=n_params, launches=launches, bf16_err=err,
                bf16_limit=tol,
                out_tokens={r.uid: list(r.out_tokens) for r in done})


class recorded_routes:
    """Within the block, every MoE layer's top-k expert indices, one
    (tokens, k) tensor per layer call, in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._top_k = moe, moe.top_k
        self.calls = []

        def top_k(probs, k):
            vals, idx = self._top_k(probs, k)
            self.calls.append(idx.reshape(-1, k).sort(-1).values.cpu())
            return vals, idx
        moe.top_k = top_k
        return self.calls

    def __exit__(self, *exc):
        self._moe.top_k = self._top_k
        return False


def route_agreement(a, b):
    """Share of (token, layer) pairs whose sets of chosen experts agree
    (1.0 for a model without MoE layers)."""
    if not a:
        return 1.0
    same = sum(int((x == y).all(-1).sum()) for x, y in zip(a, b))
    return same / sum(x.shape[0] for x in a)


def _profile(fn):
    """Device ms by kernel name and the launch count of one call of
    ``fn`` under torch.profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, n_launch = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
            n_launch += e.count
    return kernels, n_launch


def _event_ms(fn, steps):
    """(CUDA-event ms, host wall ms) per call, mean of ``steps``."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, \
        1e3 * (time.perf_counter() - t0) / steps


def _log_profile(tag, what, step_ms, host_ms, steps, kernels, n_launch):
    busy = sum(kernels.values())
    log(f"[{tag}] {what}: {step_ms:.2f} ms (CUDA events, mean of {steps}), "
        f"{host_ms:.2f} ms host wall")
    if busy <= 0:
        log(f"[{tag}] the profiler saw no device time: kernel shares not "
            f"measured")
        return
    shares = []
    for name, keys in (("ame_gemm", ("ame_gemm",)),
                       ("ssd_scan", ("ssd_scan_",)),
                       ("cumsum", ("tensor_kernel_scan",)),
                       ("copies", ("direct_copy_kernel",)),
                       ("fp32 gemm", ("sgemm", "gemm_f32f32_f32f32"))):
        hits = [(k, v) for k, v in kernels.items()
                if any(key in k for key in keys)]
        if hits:
            ms = sum(v for _, v in hits)
            shares.append(f"{name} {ms:.2f} ms ({100 * ms / busy:.1f}% of "
                          f"busy, {len(hits)} name(s))")
    log(f"[{tag}] profiled: device busy {busy:.2f} ms in {n_launch} kernel "
        f"launches ({host_ms * 1e3 / n_launch:.1f} us of host time each) of "
        f"{len(kernels)} names; {'; '.join(shares)}; idle share of the "
        f"event-timed call {100 * max(0.0, 1 - busy / step_ms):.1f}%")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[{tag}]   {v:8.3f} ms  {k[:100]}")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        if "tensor_kernel_scan" in k or "direct_copy_kernel" in k:
            log(f"[{tag}]   scan/copy {v:8.3f} ms  {k[:100]}")


def phase_breakdown(cfg, params, dev, steps=5):
    """Where a warm decode step's time goes (M = SLOTS; KV length 64 for
    attention): CUDA-event time per step, then one profiled step's device
    time by kernel (the kernels' share, the device's idle share)."""
    import torch
    from repro_torch.models import model as lm

    caches = lm.make_caches(cfg, SLOTS, CACHE_LEN[cfg.name], dev)
    toks = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SLOTS,), 64, dtype=torch.long, device=dev)

    def step():
        lm.decode_step(params, toks, pos, caches, cfg, backend="kernel")
    step_ms, host_ms = _event_ms(step, steps)
    kernels, n_launch = _profile(step)
    _log_profile("breakdown", f"{cfg.name} warm decode step, M={SLOTS}",
                 step_ms, host_ms, steps, kernels, n_launch)


def phase_prefill_breakdown(cfg, params, dev, prompt, steps=3):
    """One prefill of ``prompt`` timed and profiled (K4's share)."""
    import torch
    from repro_torch.models import model as lm

    toks = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                      device=dev)}

    def prefill():
        lm.prefill(params, toks, cfg, CACHE_LEN[cfg.name], backend="kernel")
    step_ms, host_ms = _event_ms(prefill, steps)
    kernels, n_launch = _profile(prefill)
    _log_profile("breakdown", f"{cfg.name} {len(prompt)}-token prefill",
                 step_ms, host_ms, steps, kernels, n_launch)


def phase_lora_merge(cfg, params, steps=5):
    """zamba2's per-application LoRA merge on its own: the (2d, d) merged
    input projection of every group, as one forward builds them (a plain
    product, as in the reference, not K1): device time by CUDA-graph
    replay, events, and the profiler's kernels."""
    from repro_torch.launch import hw
    from repro_torch.models.transformer import lora_merged_in_proj

    cd = cfg.compute_dtype_()
    groups = cfg.n_layers // cfg.hybrid.shared_every

    def merge():
        for g in range(groups):
            lora_merged_in_proj(params["stack"], g, cfg, cd)
    step_ms, _ = _event_ms(merge, steps)
    dev_ms = device_ms(merge, [()], 1)
    kernels, n_launch = _profile(merge)
    d = cfg.d_model
    # each merge writes the (2d, d) product, reads it and w, writes the sum
    nbytes = groups * 4 * (2 * d * d) * 2
    log(f"[breakdown] {cfg.name} LoRA merge, {groups} groups of (2d, d) = "
        f"({2 * d}, {d}) {str(cd).removeprefix('torch.')}: device "
        f"{dev_ms:.3f} ms (CUDA-graph replay), events {step_ms:.3f} ms, "
        f"{n_launch} launches, profiled busy {sum(kernels.values()):.3f} "
        f"ms; the four (2d, d) passes, {nbytes / 1e9:.3f} GB, take "
        f"{1e3 * nbytes / hw.HBM_BW:.3f} ms at the card's "
        f"{hw.HBM_BW / 1e12:.2f} TB/s")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        log(f"[breakdown]   LoRA merge kernel {v:8.3f} ms  {k[:100]}")


def phase_moe_split(cfg, params, dev, iters=20):
    """Where one MoE layer's non-K1 time goes at the decode step's shapes
    (M = SLOTS tokens, one group): the router product, the dispatch
    einsum, the expert-bank einsums (wi, wg, silu-gate, wo) and the
    combine einsum, each captured alone in a CUDA graph and replayed on
    the first MoE layer's weights, beside the bytes of its expert bank."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch import hw
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer

    m = cfg.moe
    cd = cfg.compute_dtype_()
    lp = layer(params["stack"]["moe_stack"]["moe"], 0)
    w = lp["experts"]
    gen = torch.Generator(device=dev).manual_seed(3)
    xg = torch.randn((1, SLOTS, cfg.d_model), generator=gen,
                     device=dev).to(cd)
    cap = max(int(m.capacity_factor * SLOTS * m.top_k / m.num_experts), 1)
    logits = torch.matmul(xg, lp["router"]["w"]).float()
    combine, _ = moe.route(logits, cfg, cap, cd)
    dispatch = (combine > 0).to(cd)
    buf = torch.einsum("gsec,gsd->egcd", dispatch, xg)

    def experts():
        h = torch.einsum("egcd,edf->egcf", buf, w["wi"])
        hg = torch.einsum("egcd,edf->egcf", buf, w["wg"])
        return torch.einsum("egcf,efd->egcd", F.silu(hg) * h, w["wo"])
    out = experts()
    parts = {
        "router": lambda: torch.matmul(xg, lp["router"]["w"]),
        "dispatch einsum": lambda: torch.einsum("gsec,gsd->egcd", dispatch,
                                                xg),
        "expert einsums": experts,
        "combine einsum": lambda: torch.einsum("gsec,egcd->gsd", combine,
                                               out),
    }
    n_moe = cfg.n_layers - min(m.first_dense_layers, cfg.n_layers)
    bank = sum(t.numel() * t.element_size() for t in w.values())
    times = {name: device_ms(fn, [()], iters) for name, fn in parts.items()}
    log(f"[breakdown] {cfg.name} one MoE layer at decode (M={SLOTS}, "
        f"{m.num_experts} experts x capacity {cap}), device ms by CUDA-graph "
        f"replay: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; x {n_moe} MoE layer(s) a step: "
        f"{n_moe * sum(times.values()):.3f} ms; the expert bank "
        f"({bank / 1e9:.3f} GB) reads in {1e3 * bank / hw.HBM_BW:.3f} ms "
        f"at {hw.HBM_BW / 1e12:.2f} TB/s")


def phase_small_reference(cfg_full, dev, prompt_t):
    """Reduced model (f32) on the card, kernel backend, against the same
    parameters on the CPU with the plain backend: prefill + 3 decodes."""
    import numpy as np
    import torch
    from repro_torch.models import model as lm

    cfg = cfg_full.reduced()
    gen = torch.Generator().manual_seed(0)
    cpu = lm.init(cfg, gen, device="cpu")
    fill_lora(cpu, gen)
    card = _to(cpu, dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, prompt_t))
    outs = {}
    for name, p, where, be in (("cpu", cpu, "cpu", "torch"),
                               ("card", card, dev, "kernel")):
        t = torch.as_tensor(toks, dtype=torch.long, device=where)
        lg, c = lm.prefill(p, {"tokens": t}, cfg, prompt_t + 8, backend=be)
        seq = [lg.cpu()]
        pos = torch.full((2,), prompt_t, dtype=torch.long, device=where)
        for _ in range(3):
            nxt = seq[-1].argmax(-1).to(where)[:, None]
            lg, c = lm.decode_step(p, nxt, pos, c, cfg, backend=be)
            seq.append(lg.cpu())
            pos = pos + 1
        outs[name] = torch.stack(seq)
    err = float((outs["card"] - outs["cpu"]).abs().max())
    log(f"[small] reduced {cfg.name} f32, {prompt_t}-token prompts: card "
        f"(kernel) vs CPU (plain) max_abs_err={err:.3g} (tol {SMALL_TOL})")
    if not torch.isfinite(outs["card"]).all() or err > SMALL_TOL:
        raise AssertionError("reduced model on the card disagrees with CPU")


def _timed_calls(obj, name, wall_s):
    """Wrap ``obj.name`` so each call's host wall seconds land in
    ``wall_s`` (the sidecar's own cost inside a serving step)."""
    inner = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            wall_s.append(time.perf_counter() - t0)
    setattr(obj, name, timed)


def phase_offload_serve(cfg, dev, clean_tokens):
    """Full-width qwen3-1.7b through Server with the analytic sidecar and
    the fault plan attached: K1 launches, restarted requests' tokens
    against the clean serve, fault counters, roofline, sidecar host cost
    and the served step's busy/idle shares.  Returns the K1 and decode
    attention launches."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import model as lm
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve.loop import Request, Server
    from repro_torch.serve.offload import DecodeOffload

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, device=dev)            # the serve phase's
    reg = MetricsRegistry()
    off = DecodeOffload(cfg, channels=OFFLOAD_CHANNELS, stacks=OFFLOAD_STACKS,
                        async_mode=True, kv_offload=True, metrics=reg,
                        faults=OFFLOAD_PLAN, device=dev)
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN[cfg.name],
                 metrics=reg, pim_offload=off, faults=OFFLOAD_PLAN,
                 backend="kernel", device=dev)
    side_s = []
    _timed_calls(off, "step", side_s)
    torch.cuda.synchronize()
    log(f"[offload] {cfg.name} with DecodeOffload({OFFLOAD_CHANNELS} "
        f"channels x {OFFLOAD_STACKS} stacks, async, kv_offload, "
        f"{off.weight_bytes:,} weight bytes placed) and faults "
        f"{OFFLOAD_PLAN!r} ready in {time.perf_counter() - t0:.1f}s")
    prompts = _prompts(cfg)
    for u, p in enumerate(prompts):
        srv.submit(Request(uid=u, prompt=p, max_new=MAX_NEW))
    torch.cuda.synchronize()
    k1.launches = k4.launches = kd.launches = 0       # main path starts
    k1.launches_by_variant.update(mma=0, fma=0)
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ame_gemm": k1.launches,              # main path ends
                "ssd_scan": k4.launches,
                "decode_attention": kd.launches}
    k1_variants = dict(k1.launches_by_variant)
    forwards = srv.prefills + srv.decode_steps
    want = {"ame_gemm": k1_per_forward(cfg) * forwards, "ssd_scan": 0,
            "decode_attention": decode_attention_layers(cfg)
            * srv.decode_steps}
    inj = off.rt.faults
    summ = srv.latency_summary()
    log(f"[offload] {len(done)} completed, {len(srv.failed_requests)} "
        f"failed, {srv.prefills} prefills + {srv.decode_steps} decode steps "
        f"in {wall:.3f}s wall (synchronised); launches {launches} "
        f"(expected {want}), K1 by variant {k1_variants}")
    log(f"[offload] faults: retries_total={srv.retries_total} "
        f"failed_requests={len(srv.failed_requests)} shed={srv.shed} "
        f"channel_failures={inj.counters.get('channel_failures', 0):.0f} "
        f"link_retries={inj.counters.get('link_retries', 0):.0f} "
        f"reupload_bytes={inj.counters.get('reupload_bytes', 0):.0f} "
        f"failed={sorted(inj.failed)} surviving_fraction="
        f"{off.surviving_fraction:.4f}; latency_summary retries="
        f"{summ['retries']} failed={summ['failed']}")
    if launches != want or launches["ame_gemm"] == 0 or k1_variants["fma"]:
        raise AssertionError("the offload serve did not go through K1 once "
                             "per projection on mma and the decode "
                             "attention once per layer")
    if len(done) + len(srv.failed_requests) != N_REQUESTS:
        raise AssertionError("the offload serve lost requests")
    mismatched = [r.uid for r in done if r.out_tokens != clean_tokens[r.uid]]
    restarted = [r.uid for r in done if r.retries]
    log(f"[offload] tokens vs the clean serve: {len(done) - len(mismatched)}"
        f" of {len(done)} requests equal (restarted from their prompts: "
        f"{restarted})")
    if mismatched or not restarted:
        raise AssertionError(f"offload serve tokens differ from the clean "
                             f"serve's for {mismatched}, or no request "
                             f"restarted")
    if not (srv.retries_total >= 1
            and inj.counters.get("channel_failures") == 1
            and inj.counters.get("link_retries", 0) > 0):
        raise AssertionError("the fault plan did not fire as written")
    roof = off.roofline()
    side_ms = [1e3 * s for s in side_s]
    log(f"[offload] roofline (host priced as the H100 SXM descriptor, "
        f"{off.peak_flops:.3g} FLOP/s, {off.hbm_bw:.3g} B/s): steady_pim_s="
        f"{roof['steady_pim_s']:.6g} steady_host_s="
        f"{roof['steady_host_s']:.6g} ({roof['steady_host_bound']}-bound) "
        f"pim_vs_host={roof['steady_pim_vs_host']:.6g}; steady h2d "
        f"{roof['steady_h2d_bytes']} B/step, kv {roof['kv']['append_bytes']}"
        f" B appended; modeled Aquabolt-XL cycles")
    log(f"[offload] sidecar host time per decode step: mean "
        f"{sum(side_ms) / len(side_ms):.1f} ms, min {min(side_ms):.1f}, max "
        f"{max(side_ms):.1f} over {len(side_ms)} steps (card host CPU); "
        f"{sum(side_s):.2f}s of the serve's {wall:.2f}s wall")
    snap = reg.snapshot()
    log(f"[offload] metrics: offload.steps={snap['offload.steps']['value']}"
        f" serve.retries={snap['serve.retries']['value']} "
        f"faults.link_retries={snap['faults.link_retries']['value']}")

    # the served step's time: decode-only steps of 4 fresh long requests
    for u, p in enumerate(prompts[:SLOTS]):
        srv.submit(Request(uid=100 + u, prompt=p, max_new=4 * MAX_NEW))
    srv.step()                                        # admits all four
    steps = 3
    side_s.clear()
    step_ms, host_ms = _event_ms(srv.step, steps)
    kernels, n_launch = _profile(srv.step)
    _log_profile("offload", f"{cfg.name} Server.step with the sidecar, "
                 f"M={SLOTS}", step_ms, host_ms, steps, kernels, n_launch)
    log(f"[offload] of which the sidecar's host time: "
        f"{1e3 * sum(side_s) / len(side_s):.1f} ms a step")
    del params, srv, off
    torch.cuda.empty_cache()
    return launches


def _uids_by_appearance(text):
    """``text`` with every ``uid=N`` renumbered by first appearance: tensor
    uids count per process, so two runs in one process label the same
    tensors with other numbers."""
    import re
    seen = {}
    return re.sub(r"uid=(\d+)", lambda m: "uid=%d" % seen.setdefault(
        m.group(1), len(seen)), text)


def phase_offload_numeric(dev):
    """serve_lm's reduced qwen3-1.7b served with a numeric, KV-offloading,
    async sidecar under NUMERIC_PLAN, on the card and on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.models import model as lm
    from repro_torch.obs import export_chrome_trace, profile_report
    from repro_torch.runtime import emit_trace
    from repro_torch.serve.loop import Request, Server
    from repro_torch.serve.offload import NUMERIC_ATOL, DecodeOffload

    cfg = get("qwen3-1.7b").reduced().replace(**NUMERIC_CFG)
    cpu_params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    runs = {}
    for where, device, backend in (("cpu", "cpu", "torch"),
                                   ("card", dev, "kernel")):
        t0 = time.perf_counter()
        off = DecodeOffload(cfg, channels=4, stacks=2, numeric=True,
                            kv_offload=True, async_mode=True,
                            faults=NUMERIC_PLAN, device=device)
        srv = Server(cfg, _to(cpu_params, device), slots=NUMERIC_SLOTS,
                     cache_len=160, pim_offload=off, backend=backend,
                     device=device)
        rng = np.random.default_rng(0)
        for uid in range(NUMERIC_REQUESTS):
            plen = int(rng.integers(4, 32))
            srv.submit(Request(uid=uid, prompt=rng.integers(
                0, 1023, plen).astype(np.int32), max_new=NUMERIC_MAX_NEW))
        srv.run_until_drained()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[where] = dict(
            off=off, wall=wall, logits=off.last_logits,
            steps=[dataclasses.asdict(s) for s in off.steps],
            xfer=[dataclasses.asdict(d.xfer) for d in off.rt.stack],
            trace=emit_trace(off.rt.stack),
            chrome=_uids_by_appearance(json.dumps(
                export_chrome_trace(off.rt))),
            faults=dict(off.rt.faults.counters), kv=off.kv.summary())
    cpu, card = runs["cpu"], runs["card"]
    if card["logits"].device != dev or card["logits"].dtype != torch.float16:
        raise AssertionError("the numeric sidecar's logits are not float16 "
                             "on the card")
    errs = {f: max(s[f] for s in card["steps"])
            for f in ("numeric_max_err", "logits_max_err", "attn_max_err")}
    diff = 0.0
    same_rest = len(cpu["steps"]) == len(card["steps"])
    for a, b in zip(cpu["steps"], card["steps"]):
        a, b = dict(a), dict(b)
        for f in errs:
            diff = max(diff, abs(a.pop(f) - b.pop(f)))
        same_rest &= a == b
    same_logits = torch.equal(card["logits"].cpu().view(torch.int16),
                              cpu["logits"].view(torch.int16))
    same = {key: cpu[key] == card[key]
            for key in ("xfer", "trace", "chrome", "faults", "kv")}
    log(f"[offload] numeric reduced {cfg.name} ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}), {len(card['steps'])} sidecar steps: max "
        f"errors {errs} (NUMERIC_ATOL {NUMERIC_ATOL}); card vs CPU: records "
        f"{'equal' if same_rest else 'DIFFER'} (error maxima within "
        f"{diff:.3g}, limit {OFFLOAD_ERR_TOL}), logits "
        f"{'bit-exact' if same_logits else 'DIFFER'}, {same}; faults "
        f"{card['faults']}; wall {card['wall']:.2f}s on the card, "
        f"{cpu['wall']:.2f}s on the CPU")
    log("[offload] profile_report(off.rt).summary(top_k=5) on the card:")
    for line in profile_report(card["off"].rt).summary(top_k=5).splitlines():
        log(f"[offload]   {line}")
    if not (all(v < NUMERIC_ATOL for v in errs.values()) and same_rest
            and diff <= OFFLOAD_ERR_TOL and same_logits and all(same.values())
            and card["faults"].get("channel_failures") == 1):
        raise AssertionError("the numeric sidecar on the card differs from "
                             "the CPU or from its FP32 references")


def phase_offload_values(dev, tmp_dir):
    """results/BENCH_runtime.json's decode, kv, obs, faults and moe values
    and the committed dump, reproduced with the reference's setups
    (benchmarks/paper_figures.py) from repro_torch alone."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.obs import export_chrome_trace, profile_report
    from repro_torch.runtime import KVCacheManager, PIMRuntime
    from repro_torch.serve.offload import DecodeOffload
    from repro_torch.serve.traffic import zipf_routing

    t_all = time.perf_counter()
    bench = json.loads(BENCH_RUNTIME.read_text())
    cfg = get("qwen3-1.7b").reduced()
    z = lambda *shape: np.broadcast_to(np.float16(0), shape)   # noqa: E731
    got = {}
    # decode_async_sweep
    sync = DecodeOffload(cfg, channels=16, stacks=4, placement="balanced",
                         device=dev)
    asy = DecodeOffload(cfg, channels=16, stacks=4, placement="balanced",
                        async_mode=True, device=dev)
    sync.step(1), asy.step(1)
    rec_s, rec_a = sync.step(1), asy.step(1)
    cfg8 = cfg.replace(n_layers=8)
    p1, p4 = (DecodeOffload(cfg8, channels=16, stacks=4, placement="balanced",
                            async_mode=True, device=dev).pipeline(r, 8)
              for r in (1, 4))
    got["decode"] = {
        "serial_step_cycles": rec_s.pim_cycles,
        "async_step_cycles": rec_a.pim_cycles,
        "pipeline_eff_4stack": round(p1["makespan_cycles"]
                                     / p4["makespan_cycles"], 6)}
    # kv_sweep
    rt = PIMRuntime(channels=16, device=dev)
    kv = KVCacheManager(rt, n_layers=1, n_kv_heads=1, head_dim=64,
                        channels_for_layer=lambda ell: range(16))
    kv.request("r")
    kv.append_tokens("r", 0, 8192)
    q = np.zeros((64, 4), np.float16)
    K, VT = kv.tensors("r", 0, 0)
    scores, r1 = rt.gemm(K, q, placement="paged", keep_output=True,
                         execute=False)
    _, r2 = rt.softmax(scores, placement="paged", execute=False)
    _, r3 = rt.gemm(VT, scores, placement="paged", execute=False)
    rt_str = PIMRuntime(channels=16, device=dev)
    got["kv"] = {
        "paged_step_cycles": r1.makespan_cycles + r2.makespan_cycles
        + r3.makespan_cycles,
        "streamed_step_cycles": sum(
            rt_str.gemm(a, b, placement="row-striped",
                        execute=False)[1].makespan_cycles
            for a, b in ((z(8192, 64), q), (z(64, 8192), z(8192, 4))))}
    # obs_sweep
    off = DecodeOffload(cfg, channels=16, stacks=2, placement="balanced",
                        async_mode=True, device=dev)
    off.step(1)
    off.step(1)
    trace = export_chrome_trace(off.rt, str(tmp_dir / "obs_profile.json"))
    events = trace["traceEvents"]
    rep = profile_report(off.rt)
    got["obs"] = {
        "obs_makespan_cycles": rep.makespan_cycles,
        "obs_trace_events": float(len(events)),
        "obs_tracks": float(len({(e["pid"], e["tid"]) for e in events
                                 if e.get("ph") == "X"
                                 and e.get("cat") == "op"})),
        "obs_flow_pairs": float(sum(e.get("ph") == "s" for e in events))}
    # faults_sweep
    _, ideal = PIMRuntime(channels=16, device=dev).gemm(
        z(30720, 256), z(256, 256), placement="row-striped", execute=False)
    _, deg = PIMRuntime(channels=16, faults="kill channel 0 @ 0",
                        device=dev).gemm(z(30720, 256), z(256, 256),
                                         placement="row-striped",
                                         execute=False)
    got["faults"] = {"degradation_ratio": round(
        deg.cluster_makespan_cycles / ideal.cluster_makespan_cycles, 6)}
    # moe_sweep at replication 4, and its migration run
    t0 = time.perf_counter()
    mcfg = get("mixtral-8x22b")
    n_moe = mcfg.n_layers - mcfg.moe.first_dense_layers
    prof = zipf_routing(n_moe, mcfg.moe.num_experts, 4096, alpha=1.0, seed=3)
    rr = DecodeOffload(mcfg, stacks=4, routing=prof, replicate_experts=0,
                       expert_placement="roundrobin", device=dev)
    rr_cycles = rr.step(32).pim_cycles
    rep4 = DecodeOffload(mcfg, stacks=4, routing=prof, replicate_experts=4,
                         device=dev)
    rec4 = rep4.step(32)
    ms = rep4.moe_summary()
    rcfg = mcfg.reduced()
    rn = rcfg.n_layers - rcfg.moe.first_dense_layers
    mig = DecodeOffload(rcfg, channels=4, stacks=2,
                        routing=zipf_routing(rn, rcfg.moe.num_experts, 512,
                                             alpha=1.0, seed=3),
                        replicate_experts=1, migrate_threshold=0.05,
                        migrate_min_tokens=16, link_topology="switched",
                        device=dev)
    mig.step(4)
    mig.set_routing(zipf_routing(rn, rcfg.moe.num_experts, 512, alpha=1.0,
                                 seed=43))
    for _ in range(4):
        mig.step(4)
    got["moe"] = {
        "speedup_vs_roundrobin": round(rr_cycles / rec4.pim_cycles, 4),
        "balance_max_over_mean": round(ms["observed_max_over_mean"], 4),
        "replica_hit_rate": round(ms["replica_hit_rate"], 4),
        "migrations": float(mig.moe_counters["migrations"])}
    moe_s = time.perf_counter() - t0
    # residency_sweep's dump, with the reference's host constants
    dump = DecodeOffload(cfg, channels=16, placement="balanced", device=dev,
                         peak_flops=REF_PEAK_FLOPS, hbm_bw=REF_HBM_BW)
    for _ in range(3):
        dump.step(4)
    out = tmp_dir / OFFLOAD_DUMP.name
    dump.dump(str(out))
    same_dump = out.read_bytes() == OFFLOAD_DUMP.read_bytes()
    wrong = {sec: {k: (v, bench[sec][k]) for k, v in vals.items()
                   if v != bench[sec][k]} for sec, vals in got.items()}
    wrong = {sec: w for sec, w in wrong.items() if w}
    for sec, vals in got.items():
        log(f"[offload] BENCH_runtime.json {sec}: {vals}")
    log(f"[offload] dump vs {OFFLOAD_DUMP.relative_to(ROOT)}: "
        f"{'byte-identical' if same_dump else 'DIFFERS'}; values "
        f"{'all equal' if not wrong else f'DIFFER {wrong}'}; "
        f"{time.perf_counter() - t_all:.1f}s of card host time "
        f"({moe_s:.1f}s the moe sweep)")
    if wrong or not same_dump:
        raise AssertionError("the port does not reproduce the reference's "
                             "offload values")


def serve_frontier(name, off, hw_kw, step_costs):
    """One model's SLO frontier as benchmarks/paper_figures.py:serve_sweep
    builds it: six Poisson loads (0.25..1.0 x the analytic capacity) of
    TRAFFIC_REQUESTS requests, prompts balanced so one request's prefill
    work matches its decode work, both phase layouts, and each layout's
    knee.  ``hw_kw`` prices the host (empty: the H100 descriptor);
    ``off`` and ``step_costs`` price the PIM decode steps, which do not
    depend on it.  Returns the frontier and the 0.55x Poisson and bursty
    summaries, disaggregated."""
    from repro_torch.serve.loop import TrafficServer
    from repro_torch.serve.traffic import (SLO, HostCostModel, bursty_trace,
                                           poisson_trace)
    slots, max_new, chunk, seed = 8, 16, 2048, 7
    cost = HostCostModel(off.cfg, **hw_kw)
    if slots not in step_costs:
        probe = off.step(slots)
        step_costs[slots] = (probe.pim_s, probe.h2d_bytes)
    step_s = step_costs[slots][0]
    d_req = max_new * step_s / slots
    per_tok = cost.flops_per_token / cost.peak_flops
    prompt = max(512, int(round(d_req / per_tok / 256)) * 256)
    p_req = cost.prefill_s(prompt)
    cap = 1.0 / max(p_req, d_req)
    slo = SLO(ttft_s=4 * p_req, tpot_s=1.3 * step_s)

    def run(trace, dis):
        srv = TrafficServer(off, slots=slots, disaggregate=dis,
                            chunk_tokens=chunk, slo=slo, cost=cost,
                            step_costs=step_costs)
        srv.run(trace)
        return srv.latency_summary()
    points = []
    for mult in (0.25, 0.4, 0.55, 0.7, 0.85, 1.0):
        tr = poisson_trace(mult * cap, TRAFFIC_REQUESTS, seed=seed,
                           prompt_len=prompt, max_new=max_new)
        pt = {"load": mult, "rate_rps": round(mult * cap, 4)}
        for label, dis in (("disagg", True), ("colocated", False)):
            s = run(tr, dis)
            pt[label] = {
                "goodput_rps": round(s["goodput_rps"], 4),
                "throughput_rps": round(s["throughput_rps"], 4),
                "slo_attainment": round(s["slo_attainment"], 4),
                **{f"{m}_{p}_s": round(s[f"{m}_s"][p], 4)
                   for m in ("ttft", "tpot") for p in ("p50", "p99")}}
        points.append(pt)

    def knee(label):
        ok = [p for p in points if p[label]["slo_attainment"] >= 0.9]
        return max(ok or points, key=lambda p: p[label]["goodput_rps"])
    kd, kc = knee("disagg"), knee("colocated")
    gp_d, gp_c = kd["disagg"]["goodput_rps"], kc["colocated"]["goodput_rps"]
    frontier = {
        "prompt_len": prompt, "max_new": max_new, "slots": slots,
        "capacity_rps": round(cap, 4),
        "slo": {"ttft_s": round(slo.ttft_s, 4),
                "tpot_s": round(slo.tpot_s, 4)},
        "points": points,
        "knee": {"disagg_load": kd["load"], "colocated_load": kc["load"],
                 "disagg_goodput_rps": gp_d, "colocated_goodput_rps": gp_c,
                 "goodput_ratio": round(gp_d / max(gp_c, 1e-12), 4)}}
    at55 = {kind: run(mk(0.55 * cap, TRAFFIC_REQUESTS, seed=seed,
                         prompt_len=prompt, max_new=max_new), True)
            for kind, mk in (("poisson", poisson_trace),
                             ("bursty", lambda *a, **kw: bursty_trace(
                                 *a, cv=2.0, **kw)))}
    return frontier, at55


def phase_traffic():
    """results/BENCH_runtime.json's serve section from the port alone, with
    the reference's host constants, then the same frontiers with the H100
    descriptor (modeled).  Host only: runs in its own process while the
    card works, and returns its log lines."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.serve.offload import DecodeOffload

    t0 = time.perf_counter()
    want = json.loads(BENCH_RUNTIME.read_text())["serve"]
    offs = {name: (DecodeOffload(get(name), channels=16, device="cpu"), {})
            for name in ("qwen3-1.7b", "mixtral-8x22b")}
    lines = []
    for label, hw_kw in (("reference constants (TPU v5e host: 197 TFLOP/s, "
                          "819 GB/s)", {"peak_flops": REF_PEAK_FLOPS,
                                        "hbm_bw": REF_HBM_BW}),
                         ("MODELED with the H100 descriptor "
                          "(repro_torch/launch/hw.py: 989 TFLOP/s, "
                          "3.35 TB/s)", {})):
        frontier, at55 = {}, {}
        for name, (off, costs) in offs.items():
            frontier[name], at55[name] = serve_frontier(name, off, hw_kw,
                                                        costs)
            f = frontier[name]
            lines.append(
                f"[traffic] {label}: {name} prompt {f['prompt_len']}, "
                f"capacity {f['capacity_rps']} rps, SLO ttft "
                f"{f['slo']['ttft_s']} s tpot {f['slo']['tpot_s']} s; "
                f"knee disagg {f['knee']['disagg_goodput_rps']} rps "
                f"@x{f['knee']['disagg_load']} vs colocated "
                f"{f['knee']['colocated_goodput_rps']} rps "
                f"@x{f['knee']['colocated_load']}: ratio "
                f"{f['knee']['goodput_ratio']}")
            lines.append(f"[traffic]   {name} goodput rps disagg / colocated "
                         f"(attainment) by load: " + "; ".join(
                             f"x{p['load']} {p['disagg']['goodput_rps']} "
                             f"({p['disagg']['slo_attainment']}) / "
                             f"{p['colocated']['goodput_rps']} "
                             f"({p['colocated']['slo_attainment']})"
                             for p in f["points"]))
        ratio = min(f["knee"]["goodput_ratio"] for f in frontier.values())
        q = at55["qwen3-1.7b"]
        bursty = {"load": 0.55, "cv": 2.0,
                  "goodput_rps": round(q["bursty"]["goodput_rps"], 4),
                  "poisson_goodput_rps": round(q["poisson"]["goodput_rps"],
                                               4),
                  "slo_attainment": round(q["bursty"]["slo_attainment"], 4),
                  "ttft_p99_s": round(q["bursty"]["ttft_s"]["p99"], 4)}
        lines.append(f"[traffic] {label}: disagg_vs_colo_goodput {ratio}; "
                     f"qwen3-1.7b bursty cv=2 @0.55x {bursty}")
        if hw_kw:
            same = (frontier == want["frontier"], bursty == want["bursty"],
                    ratio == want["disagg_vs_colo_goodput"])
            lines.append(f"[traffic] BENCH_runtime.json serve section "
                         f"reproduced (frontiers, bursty, ratio): {same}")
            if not all(same):
                raise AssertionError(f"the port's serve frontier differs "
                                     f"from BENCH_runtime.json: {same}")
    lines.append(f"[traffic] {time.perf_counter() - t0:.1f}s of host time "
                 f"in its own process")
    return lines


def _noise_tol(torch_bf16, torch_f32):
    """The bf16 limit of a kernel-vs-torch comparison: TRAIN_NOISE_FACTOR x
    the torch path's own bf16-vs-f32 distance, at least TRAIN_BF16_FLOOR."""
    noise = float((torch_bf16 - torch_f32).abs().max())
    return max(TRAIN_BF16_FLOOR, TRAIN_NOISE_FACTOR * noise), noise


def _count_k1(fn):
    """``fn()`` with K1's counts set to 0 just before and read just after
    (the call is synchronised): returns (result, launches, by variant)."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    torch.cuda.synchronize()
    k1.launches = 0                                   # the path starts
    k1.launches_by_variant.update(mma=0, fma=0)
    out = fn()
    torch.cuda.synchronize()
    return out, k1.launches, dict(k1.launches_by_variant)   # it ends


def phase_train(cfg, dev):
    """Full-width training on ``backend="torch"``: TRAIN_STEPS AdamW steps
    on one fixed SyntheticLM batch, the policy's dtypes and remat; before
    step 1, the kernel backend's loss on the same parameters under
    ``no_grad`` (K1's main path here: one launch per projection per layer,
    all mma) against the torch backend's.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, grad_tree, make_step, \
        trainable

    b, t = TRAIN_BATCH[cfg.name]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = trainable(lm.init(cfg, gen, device=dev))
    oc = dataclasses.replace(adamw.from_policy(cfg.policy, total_steps=100),
                             warmup_steps=0)
    opt = adamw.init(params, oc)
    batch = SyntheticLM(cfg, SHAPES["train_4k"], seed=0, batch_override=b,
                        seq_override=t).batch(0)
    tb = batch_to(batch, dev)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {lm.param_count(params):,} parameters "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, params "
        f"{cfg.policy.param_dtype}, compute {cfg.policy.compute_dtype}, "
        f"remat {cfg.policy.remat}), AdamW moments {oc.moment_dtype}, "
        f"batch {b} x {t}; ready in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    with torch.no_grad():
        (lk, _), launches, variants = _count_k1(
            lambda: lm.loss_fn(params, tb, cfg, backend="kernel"))
        lt, _ = lm.loss_fn(params, tb, cfg, backend="torch")
        cfg32 = cfg.with_policy(compute_dtype="float32")
        lt32, _ = lm.loss_fn(params, tb, cfg32, backend="torch")
        lk32, _ = lm.loss_fn(params, tb, cfg32, backend="kernel")
    want = k1_per_forward(cfg)
    log(f"[train] {cfg.name} kernel-backend loss (no_grad): ame_gemm "
        f"launches {launches} (expected {want}), by variant {variants}")

    step = make_step(cfg, oc, dev)
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], state["mets"] = step(
            state["params"], state["opt"], batch)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:        # the last step under the profiler
            kernels, n_launch = _profile(one_step)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            one_step()
            end.record()
            torch.cuda.synchronize()
            step_ms.append((start.elapsed_time(end),
                            1e3 * (time.perf_counter() - h0)))
        losses.append(float(state["mets"]["loss"]))
        gnorms.append(float(state["mets"]["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = step_ms[1:]
    ev = sum(e for e, _ in warm) / len(warm)
    host = sum(h for _, h in warm) / len(warm)

    def loss_and_grads():               # a step without its AdamW update
        loss, _ = lm.loss_fn(state["params"], tb, cfg)
        grad_tree(loss, state["params"])
    fb_ms, _ = _event_ms(loss_and_grads, 1)
    log(f"[train] {cfg.name} {TRAIN_STEPS} steps: loss "
        f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
        f"{', '.join(f'{x:.4g}' for x in gnorms)}; step 1 "
        f"{step_ms[0][0]:.1f} ms; loss and backward alone {fb_ms:.1f} ms "
        f"(AdamW and the batch copy the rest of a step); peak memory "
        f"{peak:.2f} GiB")
    _log_profile("train", f"{cfg.name} training step (loss, backward, "
                 f"AdamW), batch {b} x {t}", ev, host, len(warm), kernels,
                 n_launch)

    tol, noise = _noise_tol(lt, lt32)
    err = abs(float(lk) - losses[0])
    err32 = abs(float(lk32) - float(lt32))
    log(f"[train] {cfg.name} loss kernel (no_grad) vs step 1 (torch, with "
        f"grad): {float(lk):.6f} vs {losses[0]:.6f}, |diff| {err:.4g} "
        f"(limit {tol:.4g}: {TRAIN_NOISE_FACTOR} x the torch bf16-vs-f32 "
        f"distance {noise:.4g}, at least {TRAIN_BF16_FLOOR}) "
        f"{'ok' if err <= tol else 'FAIL'}; torch no_grad "
        f"{float(lt):.6f}; f32 compute kernel vs torch |diff| {err32:.4g} "
        f"(limit {TRAIN_F32_TOL}) {'ok' if err32 <= TRAIN_F32_TOL else 'FAIL'}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{cfg.name}: a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall in "
                             f"{TRAIN_STEPS} steps: {losses}")
    if launches != want or variants["fma"]:
        raise AssertionError(f"{cfg.name}: the kernel-backend loss did not "
                             f"launch K1 once per projection on mma")
    if not (err <= tol and err32 <= TRAIN_F32_TOL):
        raise AssertionError(f"{cfg.name}: kernel and torch losses disagree")
    del params, opt, state, step
    torch.cuda.empty_cache()
    busy = sum(kernels.values())
    return {"launches": {"ame_gemm": launches, "ssd_scan": 0},
            "step_ms": ev, "busy_ms": busy, "step_launches": n_launch,
            "idle": max(0.0, 1 - busy / ev), "peak_gib": peak,
            "fb_ms": fb_ms}


def phase_vlm(cfg, dev):
    """internvl2-76b at full width (TRAIN_DEPTH layers, bf16 weights): the
    prompt's VLM_SEQ positions (patch embeddings ahead of the text) are
    prefilled and VLM_DECODE tokens decoded greedily through the kernel
    backend, K1's counts set to 0 just before and read just after; the
    prefill logits and the kernel backend's loss against the torch
    backend's.  Returns the launches."""
    import torch
    from repro_torch.configs import SHAPES, get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.train.loop import batch_to

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    batch = batch_to(SyntheticLM(cfg, SHAPES["train_4k"], seed=0,
                                 batch_override=1, seq_override=VLM_SEQ)
                     .batch(0), dev)
    prompt = {k: batch[k] for k in ("tokens", "vision_embeds")}
    n_vis, n_txt = batch["vision_embeds"].shape[1], batch["tokens"].shape[1]
    cache_len = n_vis + n_txt + VLM_DECODE
    torch.cuda.synchronize()
    log(f"[vlm] {cfg.name}: {lm.param_count(params):,} parameters "
        f"({cfg.n_layers} of {get(cfg.name).n_layers} layers at full width, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, params "
        f"{cfg.policy.param_dtype}, compute {cfg.policy.compute_dtype}) "
        f"ready in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    def serve():
        lg, caches = lm.prefill(params, prompt, cfg, cache_len,
                                backend="kernel")
        first, out = lg, []
        pos = torch.full((1,), n_vis + n_txt, dtype=torch.long, device=dev)
        for _ in range(VLM_DECODE):
            nxt = lg.argmax(-1)[:, None]
            out.append(nxt)
            lg, caches = lm.decode_step(params, nxt, pos, caches, cfg,
                                        backend="kernel")
            pos = pos + 1
        return first, torch.cat(out, 1), lg
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    (first, toks, last), launches, variants = _count_k1(serve)
    wall = time.perf_counter() - h0
    want = k1_per_forward(cfg) * (1 + VLM_DECODE)
    log(f"[vlm] prefill of {n_vis} patches + {n_txt} tokens and "
        f"{VLM_DECODE} decode steps in {wall:.3f}s wall (synchronised), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; ame_gemm launches {launches} (expected {want} = "
        f"{k1_per_forward(cfg)} x {1 + VLM_DECODE} forwards), by variant "
        f"{variants}; tokens {toks[0].tolist()}")
    if launches != want or variants["fma"]:
        raise AssertionError("the VLM path did not launch K1 once per "
                             "projection per forward on mma")
    if not (torch.isfinite(first).all() and torch.isfinite(last).all()
            and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("VLM logits are not finite or a token is out "
                             "of the vocab")

    cfg32 = cfg.with_policy(compute_dtype="float32")
    with torch.no_grad():
        lg = {}
        for c, tag in ((cfg, "bf16"), (cfg32, "f32")):
            for be in ("kernel", "torch"):
                lg[tag, be] = lm.prefill(params, prompt, c, cache_len,
                                         backend=be)[0][:, :cfg.vocab_size]
        (lk, _), loss_launches, loss_variants = _count_k1(
            lambda: lm.loss_fn(params, batch, cfg, backend="kernel"))
        lt = lm.loss_fn(params, batch, cfg, backend="torch")[0]
        lt32 = lm.loss_fn(params, batch, cfg32, backend="torch")[0]
    same = bool(torch.equal(first[:, :cfg.vocab_size], lg["bf16", "kernel"]))
    tol, noise = _noise_tol(lg["bf16", "torch"], lg["f32", "torch"])
    err = float((lg["bf16", "kernel"] - lg["bf16", "torch"]).abs().max())
    err32 = float((lg["f32", "kernel"] - lg["f32", "torch"]).abs().max())
    ltol, lnoise = _noise_tol(lt, lt32)
    lerr = abs(float(lk) - float(lt))
    log(f"[vlm] prefill logits kernel vs torch: bf16 max_abs_err "
        f"{err:.4g} (limit {tol:.4g}: {TRAIN_NOISE_FACTOR} x the torch "
        f"bf16-vs-f32 distance {noise:.4g}) {'ok' if err <= tol else 'FAIL'};"
        f" f32 compute {err32:.4g} (limit {TRAIN_F32_TOL}) "
        f"{'ok' if err32 <= TRAIN_F32_TOL else 'FAIL'}; argmax "
        f"{int(lg['bf16', 'kernel'].argmax())} vs "
        f"{int(lg['bf16', 'torch'].argmax())}; the served prefill's logits "
        f"repeat bit for bit: {same}")
    log(f"[vlm] kernel-backend loss (no_grad, {n_txt} text targets): "
        f"{float(lk):.6f} vs torch {float(lt):.6f}, |diff| {lerr:.4g} "
        f"(limit {ltol:.4g}, torch bf16-vs-f32 {lnoise:.4g}) "
        f"{'ok' if lerr <= ltol else 'FAIL'}; ame_gemm launches "
        f"{loss_launches} by variant {loss_variants}")
    if not (err <= tol and err32 <= TRAIN_F32_TOL and lerr <= ltol
            and math.isfinite(float(lk))):
        raise AssertionError("VLM kernel and torch backends disagree")
    if loss_launches != k1_per_forward(cfg) or loss_variants["fma"]:
        raise AssertionError("the VLM loss did not launch K1 once per "
                             "projection on mma")
    del params, lg
    torch.cuda.empty_cache()
    return {"launches": {"ame_gemm": launches, "ssd_scan": 0},
            "loss_launches": {"ame_gemm": loss_launches, "ssd_scan": 0}}


def phase_train_cli(dev, out_dir):
    """``python -m repro_torch.train`` with its defaults (on the card), in
    this process: it must print ``train_lm OK``.  Then the resume check at
    its size: RESUME_STEPS steps straight against half, a new loop on
    fresh parameters, and the other half."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.train import __main__ as train_main
    from repro_torch.train.loop import LoopConfig, TrainLoop, make_step, \
        trainable

    shutil.rmtree(out_dir, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            train_main.main(["--out", str(out_dir / "train_lm"), "--device",
                             str(dev)])
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[train_lm] {line}")
    wall = time.perf_counter() - t0
    log(f"[train_lm] {wall:.1f}s wall (300 steps, checkpoints included)")
    if "train_lm OK" not in buf.getvalue().splitlines():
        raise AssertionError("python -m repro_torch.train did not finish OK")

    cfg = train_main.build_cfg()
    oc = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=20,
                           total_steps=RESUME_STEPS, weight_decay=0.01)
    pipe = SyntheticLM(cfg, SHAPES["train_4k"], seed=0, batch_override=16,
                       seq_override=128, active_vocab=512)

    def run(name, total, seed=0):
        params = trainable(lm.init(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
        loop = TrainLoop(LoopConfig(total_steps=total,
                                    ckpt_every=RESUME_STEPS // 2,
                                    log_every=1, out_dir=str(out_dir / name)),
                         make_step(cfg, oc, dev), params,
                         adamw.init(params, oc), pipe)
        return loop.run()
    straight = run("straight", RESUME_STEPS)
    run("split", RESUME_STEPS // 2)
    # a new loop on other parameters: the checkpoint overwrites them
    resumed = run("split", RESUME_STEPS, seed=1)
    rel = abs(resumed["loss"] - straight["loss"]) / abs(straight["loss"])
    log(f"[train_lm] resume: {RESUME_STEPS} steps straight loss "
        f"{straight['loss']:.6f}, {RESUME_STEPS // 2} + "
        f"{RESUME_STEPS // 2} resumed {resumed['loss']:.6f}, rel diff "
        f"{rel:.3g} (limit {RESUME_REL}) "
        f"{'ok' if rel <= RESUME_REL else 'FAIL'}")
    if not (resumed["step"] == straight["step"] == RESUME_STEPS
            and rel <= RESUME_REL):
        raise AssertionError("a resumed run does not match a straight one")


def phase_small_train(dev):
    """A reduced qwen3-1.7b (f32) trained SMALL_TRAIN_STEPS steps on the
    card and on the CPU from the same parameters and batches."""
    import torch
    from repro_torch.configs import SHAPES, get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, grad_tree, make_step, \
        trainable

    cfg = get("qwen3-1.7b").reduced()
    oc = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=100)
    pipe = SyntheticLM(cfg, SHAPES["train_4k"], seed=1, batch_override=2,
                       seq_override=32)
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    runs, least = {}, {}
    for where in ("cpu", dev):
        params = trainable(adamw.tree_map(lambda p: p.to(where, copy=True),
                                          cpu))
        opt, step = adamw.init(params, oc), make_step(cfg, oc, where)
        losses = []
        for i in range(SMALL_TRAIN_STEPS):
            if where == "cpu":       # each entry's least |gradient| so far
                loss, _ = lm.loss_fn(params, batch_to(pipe.batch(i), "cpu"),
                                     cfg)
                for k, g in adamw.tree_leaves(grad_tree(loss, params)):
                    least[k] = torch.minimum(least.get(k, g.abs()), g.abs())
            params, opt, mets = step(params, opt, pipe.batch(i))
            losses.append(float(mets["loss"]))
        runs[str(where)] = losses, {k: v.detach().cpu() for k, v in
                                    adamw.tree_leaves(params)}
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    near = {k: least[k] < ADAM_WELL_CONDITIONED * oc.eps for k in pc}
    diff = {k: (pg[k] - pc[k]).abs() for k in pc}
    perr = max(float(d[~near[k]].max()) for k, d in diff.items())
    n_near = sum(int(m.sum()) for m in near.values())
    near_err = max([float(d[near[k]].max()) for k, d in diff.items()
                    if near[k].any()] or [0.0])
    near_limit = 2 * oc.peak_lr * SMALL_TRAIN_STEPS
    log(f"[small_train] reduced {cfg.name} f32, {SMALL_TRAIN_STEPS} AdamW "
        f"steps card vs CPU: losses {lg} vs {lc}, max rel {loss_rel:.3g} "
        f"(limit {SMALL_TRAIN_LOSS_REL}); parameters max_abs_err {perr:.3g} "
        f"(limit {SMALL_TRAIN_PARAM_ATOL}) over the entries whose gradient "
        f"stays >= {ADAM_WELL_CONDITIONED} x eps from zero; the other "
        f"{n_near} of {sum(d.numel() for d in diff.values())} entries "
        f"{near_err:.3g} (limit {near_limit:.3g}, 2 x lr a step)")
    if not (loss_rel <= SMALL_TRAIN_LOSS_REL
            and perr <= SMALL_TRAIN_PARAM_ATOL and near_err <= near_limit):
        raise AssertionError("training on the card disagrees with the CPU")


def _mesh_host_runs():
    """Start the mesh half's host paths, each in a process of its own:
    ``python -m repro_torch.launch.distributed_train --device cpu`` (4
    gloo ranks), the dry-run of the reference's failing multi-pod cell,
    and the DRYRUN_FAMILIES cells.  Returns the Popen objects by name."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    fams = ("import json, sys; from repro_torch.launch import dryrun\n"
            f"for a, s, n in {DRYRUN_FAMILIES!r}:\n"
            "    r = dryrun.run_cell(a, s, 'single', n_layers=n)\n"
            "    r.pop('traceback', None)\n"
            "    print(json.dumps(r), flush=True)\n")
    cmds = {"distributed_train": ["-m", "repro_torch.launch.distributed_train",
                                  "--device", "cpu"],
            "dryrun": ["-m", "repro_torch.launch.dryrun", "--arch",
                       "qwen3-1.7b", "--shape", "decode_32k", "--mesh",
                       "multi", "--force"],
            "dryrun_families": ["-c", fams]}
    return {k: (subprocess.Popen([sys.executable] + v, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                time.perf_counter()) for k, v in cmds.items()}


def _mesh_host_results(procs):
    """Wait for the host paths, print their output and check it."""
    from repro_torch.launch import memmodel
    from repro_torch.configs import SHAPES, get
    out = {}
    for name, (proc, t0) in procs.items():
        try:
            text = proc.communicate(timeout=MESH_HOST_TIMEOUT)[0]
        finally:
            proc.kill()
        out[name] = text
        for line in text.splitlines():       # the cells' records below
            if not line.startswith(("[W", "[rank", "{")):
                log(f"[mesh:{name}] {line[:400]}")
        log(f"[mesh:{name}] exit {proc.returncode}, "
            f"{time.perf_counter() - t0:.1f}s wall")
        if proc.returncode != 0:
            raise AssertionError(f"{name} failed")
    text = out["distributed_train"]
    if not ("tp_mode=allreduce" in text and "tp_mode=allgather" in text
            and "distributed_train OK" in text.splitlines()):
        raise AssertionError("distributed_train did not finish OK")
    rec = json.loads((ROOT / "build" / "repro_torch" / "dryrun" /
                      "qwen3-1.7b.decode_32k.multi.json").read_text())
    est = memmodel.estimate(get("qwen3-1.7b"), SHAPES["decode_32k"],
                            {"pod": 2, "data": 16, "model": 16})
    mem = rec.get("memory", {})
    log(f"[mesh] dry-run qwen3-1.7b decode_32k multi (512 fake ranks): ok "
        f"{rec.get('ok')}, {rec.get('step')}, per device: flops "
        f"{rec.get('flops', 0):.4g} (dot {rec.get('dot_flops', 0):.4g}), "
        f"traced peak {mem.get('peak_bytes_per_device', 0) / 2 ** 30:.3f} "
        f"GiB (resident params {mem.get('params_bytes', 0) / 2 ** 30:.3f}, "
        f"caches {mem.get('caches_bytes', 0) / 2 ** 30:.3f}) beside "
        f"memmodel.estimate {est['total'] / 2 ** 30:.3f} GiB (params "
        f"{est['params'] / 2 ** 30:.3f}, caches {est['caches'] / 2 ** 30:.3f}"
        f"), link bytes {rec.get('collectives', {}).get('total_link_bytes', 0):.4g}"
        f", trace {rec.get('trace_s')} s")
    if not (rec.get("ok") and rec.get("flops", 0) > 0):
        raise AssertionError("the multi-pod dry-run cell failed")
    fams = [json.loads(line) for line in out["dryrun_families"].splitlines()
            if line.startswith("{")]
    for r in fams:
        mem = r.get("memory", {})
        log(f"[mesh] dry-run {r['arch']} {r['shape']} single, "
            f"{r.get('n_layers')} layers: ok {r.get('ok')} {r.get('step')} "
            f"flops/dev {r.get('flops', 0):.4g}, peak/dev "
            f"{mem.get('peak_bytes_per_device', 0) / 2 ** 30:.3f} GiB beside "
            f"memmodel.estimate "
            f"{r.get('memmodel', {}).get('total', 0) / 2 ** 30:.3f} GiB, "
            f"trace {r.get('trace_s')} s {r.get('error', '')[:300]}")
    if len(fams) != len(DRYRUN_FAMILIES) or not all(r.get("ok") for r in fams):
        raise AssertionError("a family's dry-run cell failed")


def phase_mesh(cfg, dev):
    """The mesh half on one card: a 1-rank nccl world and a 1x1 mesh.
    Full-width qwen3-1.7b's sharded prefill and MESH_DECODE decode steps
    (backend="kernel", K1 counted) against the unsharded ones on the same
    parameters; MESH_TRAIN_STEPS sharded train steps (backend="torch",
    MESH_MICROBATCHES microbatches) against make_step's step 1.  Then the
    host paths (distributed_train on 4 gloo ranks, the dry-runs).  The
    warm decode step is timed and profiled sharded and unsharded (the
    serve's ``lm.decode_step``) at the same shape: DTensor's dispatch
    costs host time.  Both decode steps attend with the decode kernel,
    the sharded one on its DTensor caches' local shards, so the two sides
    run the same computations.  Returns the launches."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train.loop import batch_to, make_step, trainable

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"), device="cuda")
        b, t = MESH_SERVE
        cache_len = t + MESH_DECODE
        pshape = ShapeSpec("mesh_prefill", cache_len, b, "prefill")
        dshape = ShapeSpec("mesh_decode", cache_len, b, "decode")
        pf, _, (pspec, bspec, _) = steps.make_prefill_step(
            cfg, mesh, pshape, backend="kernel")
        df, _, (_, tspec, posspec, _) = steps.make_decode_step(
            cfg, mesh, dshape, backend="kernel")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.compute_params(lm.init(cfg, gen, device=dev), cfg)
        dparams = rules.distribute(params, pspec, mesh)
        tokens = torch.randint(0, cfg.vocab_size, (b, t), device=dev,
                               generator=gen)
        with torch.no_grad():
            want, caches = lm.prefill(params, {"tokens": tokens}, cfg,
                                      cache_len=cache_len, backend="kernel")
        (got, dcaches), launches, variants = _count_k1(lambda: pf(
            dparams, rules.distribute({"tokens": tokens}, bspec, mesh)))
        got = full(got)
        per = k1_per_forward(cfg)
        equal = torch.equal(got, want)
        dist_ = float((got - want).abs().max())
        log(f"[mesh] {cfg.name} sharded prefill (1x1 mesh, nccl, "
            f"backend=kernel) {b} x {t}: ame_gemm launches {launches} "
            f"(expected {per}), by variant {variants}; logits torch.equal "
            f"to the unsharded prefill: {equal} (max |diff| {dist_:.3g})")
        if launches != per or variants["fma"]:
            raise AssertionError("the sharded prefill did not launch K1 once "
                                 "per projection on mma")
        if not equal:
            log(f"[mesh] cause: the 1x1 mesh runs the same kernels at the "
                f"same shapes, so a difference is a reduction in another "
                f"order; held to the f32 rule {SERVE_F32_LOGITS_TOL}")
            if not torch.allclose(got, want, atol=SERVE_F32_LOGITS_TOL[0],
                                  rtol=SERVE_F32_LOGITS_TOL[1]):
                raise AssertionError("sharded and unsharded prefill logits "
                                     "disagree")
        nt, ntd = want.argmax(-1), got.argmax(-1)
        toks, dtoks, dlaunch, dfma = [nt], [ntd], 0, 0
        step_wall, ref_wall = [], []
        attn0 = kd.launches
        for i in range(MESH_DECODE):
            pos = torch.full((b,), t + i, dtype=torch.long, device=dev)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            with torch.no_grad():
                want, caches = lm.decode_step(params, nt[:, None], pos,
                                              caches, cfg, backend="kernel")
            torch.cuda.synchronize()
            ref_wall.append(time.perf_counter() - h0)
            (got, dcaches), n, var = _count_k1(lambda: df(
                dparams,
                rules.distribute(ntd[:, None], tspec, mesh),
                rules.distribute(pos, posspec, mesh), dcaches))
            step_wall.append(time.perf_counter() - h0 - ref_wall[-1])
            dlaunch += n
            dfma += var["fma"]
            nt, ntd = want.argmax(-1), full(got).argmax(-1)
            toks.append(nt)
            dtoks.append(ntd)
        same = all(torch.equal(a, c) for a, c in zip(toks, dtoks))
        attn = kd.launches - attn0
        warm = slice(2, None)
        sh = 1e3 * sum(step_wall[warm]) / len(step_wall[warm])
        un = 1e3 * sum(ref_wall[warm]) / len(ref_wall[warm])
        log(f"[mesh] {cfg.name} {MESH_DECODE} sharded decode steps: tokens "
            f"equal to the unsharded decode_step's: {same}; ame_gemm "
            f"launches {dlaunch} ({dlaunch // MESH_DECODE} a step, "
            f"{dfma} on fma); decode_attention launches {attn} (expected "
            f"{2 * cfg.n_layers * MESH_DECODE}: a layer's, sharded and "
            f"unsharded); wall "
            f"{sh:.2f} ms a step sharded vs {un:.2f} ms unsharded "
            f"(steps 3-{MESH_DECODE}, host wall, synchronised)")
        if not same or dlaunch != per * MESH_DECODE:
            raise AssertionError("the sharded decode steps disagree")
        if attn != 2 * cfg.n_layers * MESH_DECODE:
            raise AssertionError("a decode step did not launch the decode "
                                 "attention kernel once a layer")
        if dfma:
            raise AssertionError("a sharded decode step launched K1 on fma")
        dfn = lambda: df(dparams, rules.distribute(  # noqa: E731
            ntd[:, None], tspec, mesh), rules.distribute(
            pos, posspec, mesh), dcaches)
        ufn = lambda: lm.decode_step(  # noqa: E731
            params, nt[:, None], pos, caches, cfg, backend="kernel")
        with torch.no_grad():
            for tag, fn in (("sharded", dfn), ("unsharded", ufn)):
                step_ms, host_ms = _event_ms(fn, 5)
                kernels, n_launch = _profile(fn)
                _log_profile("mesh", f"{cfg.name} warm decode step, M={b}, "
                             f"{tag}", step_ms, host_ms, 5, kernels,
                             n_launch)
        serve_launches = launches + dlaunch
        del params, dparams, caches, dcaches
        torch.cuda.empty_cache()

        # sharded training against make_step's step 1
        tcfg = cfg.with_policy(microbatches=MESH_MICROBATCHES)
        tb, tt = TRAIN_BATCH[cfg.name]
        oc = dataclasses.replace(adamw.from_policy(cfg.policy,
                                                   total_steps=100),
                                 warmup_steps=0)
        batch = SyntheticLM(cfg, SHAPES["train_4k"], seed=0,
                            batch_override=tb, seq_override=tt).batch(0)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = trainable(lm.init(cfg, gen, device=dev))
        opt = adamw.init(params, oc)
        with torch.no_grad():
            cfg32 = cfg.with_policy(compute_dtype="float32")
            l16 = lm.loss_fn(params, batch_to(batch, dev), cfg)[0]
            l32 = lm.loss_fn(params, batch_to(batch, dev), cfg32)[0]
        tol, noise = _noise_tol(l16, l32)
        step = make_step(cfg, oc, dev)
        torch.cuda.reset_peak_memory_stats()
        state = {}

        def plain():
            state["p"], state["o"], state["m"] = step(params, opt, batch)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        plain()                          # step 1: its loss is the yardstick
        plain_loss = float(state["m"]["loss"])
        start.record()
        plain()                          # step 2, warm, by events
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels, n_launch = _profile(plain)
        plain_busy = sum(kernels.values())
        del params, opt, state, step
        torch.cuda.empty_cache()

        fn, _, (pspec, ospec, bspec) = steps.make_train_step(
            tcfg, mesh, ShapeSpec("mesh_train", tt, tb, "train"),
            opt_cfg=oc, backend="torch")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.init(cfg, gen, device=dev)
        dparams = rules.distribute(params, pspec, mesh)
        dopt = rules.distribute(adamw.init(params, oc), ospec, mesh)
        dbatch = rules.distribute(batch_to(batch, dev), bspec, mesh)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(MESH_TRAIN_STEPS):
            holder = {}

            def one():
                holder["r"] = fn(dparams, dopt, dbatch)
            if i == MESH_TRAIN_STEPS - 1:
                kernels, n_launch_s = _profile(one)
            else:
                start.record()
                one()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            dparams, dopt, mets = holder["r"]
            losses.append(float(mets["loss_out"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = sum(kernels.values())
        err = abs(losses[0] - plain_loss)
        log(f"[mesh] {cfg.name} sharded train step (1x1 mesh, "
            f"{MESH_MICROBATCHES} microbatches, backend=torch), batch {tb} x "
            f"{tt}: losses {', '.join(f'{x:.5f}' for x in losses)}; step 1 "
            f"vs make_step's {plain_loss:.5f}: |diff| {err:.4g} (limit "
            f"{tol:.4g}: {TRAIN_NOISE_FACTOR} x the plain path's bf16-vs-f32 "
            f"distance {noise:.4g}, at least {TRAIN_BF16_FLOOR}) "
            f"{'ok' if err <= tol else 'FAIL'}")
        log(f"[mesh] {cfg.name} train step sharded: {times[-1]:.1f} ms by "
            f"events (step {len(times)}), busy {busy:.1f} ms in {n_launch_s} "
            f"launches, peak {peak:.2f} GiB; make_step: {plain_ms:.1f} ms "
            f"(step 2), busy {plain_busy:.1f} ms in {n_launch} launches, "
            f"peak {plain_peak:.2f} GiB")
        if not all(map(math.isfinite, losses)) or err > tol \
                or not losses[-1] < losses[0]:
            raise AssertionError("the sharded train step failed its checks")
        del dparams, dopt, dbatch, params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    _mesh_host_results(_mesh_host_runs())
    return {"launches": {"ame_gemm": serve_launches, "ssd_scan": 0,
                         "decode_attention": attn}}


def train_summary(smi, k1_records, serves):
    """One line per number the train phase reports, beside the card's
    name and power limit: each training step's time, busy time, idle
    share and peak memory; K1's launches on every path; K1's device ms at
    the train and VLM shapes, summed over a layer, beside torch.matmul's
    and the bound."""
    for key, r in serves.items():
        if key.startswith("train:"):
            log(f"[summary] {smi} | {key[6:]} training step: "
                f"{r['step_ms']:.2f} ms by events, busy {r['busy_ms']:.2f} "
                f"ms in {r['step_launches']} launches, idle "
                f"{100 * r['idle']:.1f}%, loss and backward alone "
                f"{r['fb_ms']:.2f} ms, peak {r['peak_gib']:.2f} GiB")
    log(f"[summary] {smi} | ame_gemm launches by path: " + ", ".join(
        f"{k} {v['launches']['ame_gemm']}" for k, v in serves.items()))
    for model, ms in TRAIN_M.items():
        for m in ms:
            layer = [r for r in k1_records
                     if r["model"] == model and r["m"] == m]
            tot = {k: sum(r[k] for r in layer)
                   for k in ("device_ms", "library_device_ms", "bound_ms")}
            log(f"[summary] {smi} | ame_gemm {model} layer ({len(layer)} "
                f"calls) m={m}: device {tot['device_ms']:.4f} ms, "
                f"torch.matmul {tot['library_device_ms']:.4f} ms "
                f"({tot['device_ms'] / tot['library_device_ms']:.2f}x), "
                f"bound {tot['bound_ms']:.4f} ms")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def check_bounds(records):
    """Fail the run if any kernel's device time reads below its bound: the
    bound is the least time the card could take, so such a reading means
    a wrong count or a wrong clock."""
    timed = [r for r in records if r.get("device_ms") is not None]
    below = [r for r in timed if r["device_ms"] < r["bound_ms"]]
    log(f"[bounds] {len(timed)} device times against their bounds: "
        f"{len(below)} below")
    if below:
        raise AssertionError(f"device time below the bound: {below}")


def kernels_line(k1_records, k4_records, k2_records, k3_records,
                 da_records, mla_records, serves, ops_launches):
    """K1's entry: one qwen3 decode layer's seven calls at M = SLOTS,
    summed; its ``fma`` entry, the quickstart's one f32 call, the only
    main-path launch of that variant.  K4's entry: one layer's scan of the LONG_PROMPT-token prefill
    of the mamba serve, with the variant it took.  K2's: an (8192, 8192)
    bf16 add.  K3's: one qwen3-1.7b layer's causal prefill attention.
    The decode attention's: one layer of the chat cell's decode step.
    MLA's decode kernel's: one layer of deepseek-v3.chat-64's decode
    step.
    ``launches``: each kernel's count on the paths that run it (the
    serves, the train phase's kernel-backend losses, the VLM's prefill and
    decode, the ops path).  ``ms`` and ``library_ms`` are CUDA-event times of eager calls (host
    issue included); ``device_ms`` and ``library_device_ms`` the same
    calls replayed from a CUDA graph (:func:`device_ms`)."""
    layer = [r for r in k1_records
             if r["model"] == "qwen3-1.7b" and r["m"] == SLOTS]
    total = {key: sum(r[key] for r in layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "device_ms", "library_device_ms")}
    qs = [r for r in k1_records if r["model"] == "quickstart"][0]
    main = [r for r in k4_records if r["kind"] == "main"
            and r["model"] == "mamba2-370m" and r["t"] == LONG_PROMPT][0]
    by_path = {name: {model: s["launches"][name]
                      for model, s in serves.items()}
               for name in ("ame_gemm", "ssd_scan")}
    # every path but the quickstart fails on a K1 launch that is not mma
    k1_fma = sum(s.get("variants", {}).get("fma", 0) for s in serves.values())
    k1_total = sum(by_path["ame_gemm"].values())
    ew = [r for r in k2_records if r["kind"] == "model"
          and r["shape"] == (8192, 8192) and r["op"] == "add"][0]
    at = [r for r in k3_records if r["kind"] == "qwen3-1.7b prefill"][0]
    da = [r for r in da_records if r["kind"] == "chat"][0]
    da_path = {model: s["launches"]["decode_attention"]
               for model, s in serves.items()
               if "decode_attention" in s.get("launches", {})}
    mla = [r for r in mla_records if r["kind"] == "deepseek-v3.chat-64"][0]
    mla_path = {model: s["launches"]["mla_decode"]
                for model, s in serves.items()
                if s.get("launches", {}).get("mla_decode")}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "device_ms", "library_device_ms")
    return {"kernels": [{
        "name": "ame_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ame_gemm.cu",
        "replaces": "src/repro/kernels/ame_gemm.py:78",
        "launches": k1_total,
        "launches_by_path": by_path["ame_gemm"],
        "launches_by_variant": {"mma": k1_total - k1_fma, "fma": k1_fma},
        "max_abs_err": max(r["max_abs_err"] for r in k1_records),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer)
        else "operations",
        "library_ms": total["library_ms"],
        "device_ms": total["device_ms"],
        "library_device_ms": total["library_device_ms"],
        "work": f"one qwen3-1.7b decoder layer's 7 K1 calls at decode, "
                f"M={SLOTS}, bf16",
        "fma": {**{key: qs[key] for key in timed + (
                    "max_abs_err", "host_us", "library_host_us")},
                "launches": k1_fma,
                "work": "the quickstart's one K1 call, (m,k,n)=(%d,%d,%d), "
                        "f32; library torch.matmul, TF32 off"
                        % QUICKSTART_GEMM},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:170",
        "launches": sum(by_path["ssd_scan"].values()),
        "launches_by_path": by_path["ssd_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in k4_records),
        "variant": main["variant"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "device_ms": main["device_ms"],
        "library_device_ms": None,
        "work": f"one mamba2-370m layer's scan of a {LONG_PROMPT}-token "
                f"prefill: (BH,T,P,N)=({main['bh']},{main['t']},"
                f"{main['p']},{main['n']}), chunk {main['chunk']}, f32 x, "
                f"bf16 b/c; no single PyTorch call computes it",
    }, {
        "name": "ame_elementwise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ame_elementwise.cu",
        "replaces": "src/repro/kernels/elementwise.py:50",
        "launches": ops_launches["ame_elementwise"],
        "launches_by_path": {"ops": ops_launches["ame_elementwise"]},
        "max_abs_err": max(r["max_abs_err"] for r in k2_records),
        **{key: ew[key] for key in timed + ("host_us", "library_host_us")},
        "work": "mfadd of an (8192, 8192) bf16 pair (128 MiB per operand); "
                "library torch.add",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention.py:87",
        "launches": ops_launches["flash_attention"],
        "launches_by_path": {"ops": ops_launches["flash_attention"]},
        "max_abs_err": max(r["max_abs_err"] for r in k3_records),
        **{key: at[key] for key in timed},
        "work": f"one qwen3-1.7b layer's causal prefill attention, "
                f"(BH,T,D)=({at['bh']},{at['tq']},{at['d']}), bf16; library "
                f"scaled_dot_product_attention",
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "no Pallas kernel: the decode call of "
                    "models/attention.py:chunked_attention (plain jnp in "
                    "the reference, src/repro/models/attention.py:97-99)",
        "launches": sum(da_path.values()),
        "launches_by_path": da_path,
        "max_abs_err": max(r["max_abs_err"] for r in da_records),
        **{key: da[key] for key in timed + ("host_us", "plain_host_us")},
        "work": f"one layer of the chat cell's decode step: "
                f"(b,clen,hkv,g,d)=({da['b']},{da['clen']},{da['hkv']},"
                f"{da['g']},{da['d']}), {da['live_keys']} live keys, bf16; "
                f"library scaled_dot_product_attention over the whole "
                f"cache",
    }, {
        "name": "mla_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "replaces": "no Pallas kernel: MLA's decode branch of "
                    "models/attention.py:mla_apply, cat + chunked_attention "
                    "(plain jnp in the reference)",
        "launches": sum(mla_path.values()),
        "launches_by_path": mla_path,
        "max_abs_err": max(r["max_abs_err"] for r in mla_records),
        **{key: mla[key] for key in timed + (
            "host_us", "plain_host_us", "plain_device_ms", "chunked_ms")},
        "work": f"one layer of deepseek-v3.chat-64's decode step: "
                f"(b,clen,h,r,rd)=({mla['b']},{mla['clen']},{mla['h']},"
                f"{mla['r']},{mla['rd']}), {mla['live_keys']} live keys, "
                f"bf16; library scaled_dot_product_attention with the heads "
                f"as the queries of one KV head",
    }]}


def main() -> int:
    name, smi = phase_device()
    # the traffic phase is host work only: it runs in its own process
    # while the card phases run, and its lines print after them
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        traffic = pool.submit(phase_traffic)
        records = phases_on_card(name, smi)
        for line in traffic.result():
            log(line)
    import torch
    print(json.dumps(kernels_line(*records)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases_on_card(name, smi):
    """Phases 2-12, 14 and 15 and the bounds check; returns kernels_line's
    inputs.  ``smi`` is the card's name and power limit (nvidia-smi)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import get
    qwen, mamba = get("qwen3-1.7b"), get("mamba2-370m")
    zamba, hubert = get("zamba2-2.7b"), get("hubert-xlarge")
    mixtral, deepseek = (get(n).replace(n_layers=SERVE_DEPTH[n])
                         for n in ("mixtral-8x22b", "deepseek-v3-671b"))
    vlm = get("internvl2-76b").replace(
        n_layers=TRAIN_DEPTH["internvl2-76b"])
    phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    k1_records = phase_kernels([qwen, mamba, zamba, mixtral, deepseek,
                                hubert, vlm])
    k4_records = phase_ssd([mamba, zamba])
    k2_records = phase_elementwise(dev)
    k3_records = phase_attention(dev)
    da_records = phase_decode_attention(dev)
    mla_records = phase_mla_decode(dev)
    phase_engine(dev)
    phase_runtime(dev, name)
    serves = {"quickstart": phase_quickstart(dev)}
    ops_launches = phase_ops(dev)
    torch.cuda.empty_cache()
    for cfg, small_prompt in ((qwen, 16), (mamba, 40), (zamba, 40),
                              (mixtral, 16), (deepseek, 16)):
        serves[cfg.name] = phase_serve(cfg, dev)
        phase_small_reference(cfg, dev, small_prompt)
    serves["qwen3-1.7b+offload"] = {"launches": phase_offload_serve(
        qwen, dev, serves["qwen3-1.7b"]["out_tokens"])}
    phase_offload_numeric(dev)
    out_dir = ROOT / "build" / "repro_torch" / "offload"
    out_dir.mkdir(parents=True, exist_ok=True)
    phase_offload_values(dev, out_dir)
    torch.cuda.empty_cache()
    for cfg in (qwen, hubert):
        serves[f"train:{cfg.name}"] = phase_train(cfg, dev)
    v = phase_vlm(vlm, dev)
    serves[f"vlm:{vlm.name}"] = v
    serves[f"vlm-loss:{vlm.name}"] = {"launches": v["loss_launches"]}
    phase_train_cli(dev, ROOT / "build" / "repro_torch" / "train")
    phase_small_train(dev)
    serves[f"mesh:{qwen.name}"] = phase_mesh(qwen, dev)
    train_summary(smi, k1_records, serves)
    check_bounds(k1_records + k4_records + k2_records + k3_records
                 + da_records + mla_records)
    return k1_records, k4_records, k2_records, k3_records, da_records, \
        mla_records, serves, ops_launches


if __name__ == "__main__":
    sys.exit(main())
