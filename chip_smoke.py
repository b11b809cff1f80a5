"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero before the
last line.  The simulator's path:
  1. the card's name and power limit (nvidia-smi) and the build of the
     port's six CUDA sources (sm_issue, sm_quantum, wkv6, flash_attention
     and the two backward sources wkv6_bwd and flash_attention_bwd, one
     nvcc each, started together) from the sources in this checkout, with
     sm_quantum's ptxas registers, shared memory and spills;
  2. sm_issue against its plain PyTorch version on the card, exact
     equality on seeded cases at the TINY and RTX 3080 Ti shapes, and the
     time per launch of both;
  q. sm_quantum (one launch per quantum for all lanes: one block per
     lane and SM, the state in shared memory) against the eager SM phase
     (its plain version, a cycle loop around sm_issue) on seeded one-lane
     states at the TINY, four-sub-core and RTX 3080 Ti widths, GTO and
     LRR, with and without an instr_base offset, and on four-lane states
     (each lane its own state, trace, instr_base, dynamic config and t0),
     where one launch must also equal four one-lane launches; bit-exact
     on every leaf, the inputs left as they were; the time of one quantum
     at full width for 1, 8 and 32 lanes, the eager one's for one lane,
     and the bounds;
  3. on TINY against tests/golden/determinism_tiny.json: myocyte@1.0 and
     the trace workload trace:gather_chain@1.0 in vmap and seq modes, and
     hotspot@0.02, whose cycle cap cuts 2 of its 4 kernels (timeouts 2,
     as the JAX package reads); one sm_quantum launch per quantum (per
     SM and quantum in seq), none of sm_issue;
  4. the main path at full width: nn@0.5 and syrk@0.16 on the RTX 3080 Ti
     config (80 SMs x 48 warps, vmap) against
     tests/golden/torch_port_rtx3080ti.json, with 0 timeouts, wall time,
     quanta/s, simulated cycles/s and one sm_quantum launch per quantum;
     then nn@0.5 once more through the eager per-cycle SM phase (sm_issue
     once per cycle) as a witness, against the same stats, and its wall;
  5. a profile of the first 16 quanta of syrk@0.16: device busy and
     idle share, kernel launches and device-to-host reads per quantum;
  s. this slice's main path, the lane-batched sweeps: launch/dse.py's
     default grid of 8 configs on the RTX 3080 Ti swept over nn@0.5 and
     syrk@0.16 (8 lanes, one sm_quantum launch per quantum for all), the
     plain-config lane against tests/golden/torch_port_rtx3080ti.json,
     both walls, and nn@0.5's lanes against their solo runs on the card
     (syrk@0.16's lanes meet their solo runs in phase t);
     launch/zoo.py's grid of the three bundled traces x 4 TINY configs,
     every lane against its solo run (--check);
  l. syrk@0.16 swept over the default grid of 1, 8 and 32 configs: wall,
     quanta, lane-quanta/s, and a profile of the first 16 quanta of the
     quantum loop: launches and device-to-host reads per quantum, idle
     share;
  t. counter timelines (64 rows every 16 quanta) at full width: nn@0.5
     and syrk@0.16 solo, every row, lockstep_waste and telemetry_samples
     against tests/golden/torch_port_telemetry.json (the JAX package's),
     comparable() against the pinned stats, the last row against
     finalize; dse's default grid of 8 configs over syrk@0.16, every
     lane's timeline against its solo card run; the traces' zoo grid x 4
     TINY configs and syrk@0.16 at 32 lanes, their last rows against
     finalize and their lockstep waste; profiles of 16 quanta of the loop
     with telemetry off and on at 1 and 8 lanes, in a fresh process (off
     within one launch per quantum of the loop's count before telemetry
     existed), and the loop's wall over 64 quanta timed in turns off, on,
     on, off;
  r. the seeded analytic-prune search (nn@0.5 on the RTX 3080 Ti, seed 0,
     3 rounds of 256 candidates, top 8) with its verify sweeps on the
     card; the same case cut to one round on the card equal in full to it
     on the CPU (in a child process started after the builds, beside the
     card phases); the card's round 0 verified set equal to
     tests/golden/torch_port_search.json
     (the JAX package's) and equal cycles on every vector both measured;
     then launch/dse.py --base 3080ti --workload nn --scale 0.5 --search
     --search-rounds 1 --check;
  v. the simulation server (core/service.py, launch/serve.py) on the card
     at full width, RTX 3080 Ti base, bucket_by='shape': one synchronous
     batch of nn@0.5 and syrk@0.16, nn@0.5 with a config override, the
     bundled vecadd and mm_tile traces uploaded as text and a sample grid
     of 4 lanes over nn@0.5; the plain nn@0.5 and syrk@0.16 lanes against
     tests/golden/torch_port_rtx3080ti.json, every lane against its solo
     card run, the same jobs reversed and split over two batches giving
     the same lanes, one sm_quantum launch per quantum of every bucket
     run; a threaded soak (4 client threads x 2 seeded draws from those
     jobs, batch_lanes 8, max_wait 50 ms): everything served and drained,
     every lane exact, jobs/s, p50 and p99 of queue_s and total_s,
     batches and lanes per batch; the kernel launches per quantum of a
     served bucket of syrk@0.16 at 1 and 8 lanes (two profiled runs cut at
     16 and 48 quanta, differenced) against the bare quantum loop's; then
     the frontends in child processes: a scripted --stdin session (its
     cold start to first completion beside the warm in-process batch of
     the same jobs), a --port 0 socket session, every completion equal
     to the in-process lanes, and --selftest, run from the phase's start
     beside the in-process server;
  m. SM-axis sharding and the ('cfg','sm') mesh on this one card, every
     mesh position repeating it (the counterpart of the JAX package's
     forced host devices): nn@0.5 and syrk@0.16 at full width through
     run_workload with run_kernel_sharded over 4 shards, static and
     dynamic assignment, window exchange, against
     tests/golden/torch_port_rtx3080ti.json with 0 timeouts and one
     sm_quantum launch per shard per quantum; the per-cycle exchange
     (sm_issue every cycle) on TINY myocyte@1.0 and trace:gather_chain@1.0
     at 4 shards against tests/golden/determinism_tiny.json; dse's default
     grid of 8 configs over nn@0.5 at meshes 1x1, 2x1, 1x2, 2x2 and 4x1,
     every lane (timeouts included) against the no-mesh sweep, with each
     shape's wall, sm_quantum launches per group quantum, and a profile
     of 16 quanta (kernel launches per quantum, idle share) printed
     before any check: on one card they measure what distribution costs
     the host, not a speed-up; telemetry on at 2x2 equal to the no-mesh
     timelines; dse --mesh 2 2 --check and zoo --trace tests/data/traces
     --grid 3 4 --mesh 1 2 --check through main() on the card;
The RWKV-6 serving path (f32 products in full f32: TF32 is off):
  a. the wkv6 build: ptxas registers and spills, and the dynamic shared
     memory of one block per head size;
  b. wkv6 (chunks of 32 tokens, 3xTF32 mma.sync on the tensor cores)
     against its plain PyTorch version (wkv6_plain) on seeded cases, hs
     in {16, 32, 64} x S in {1, 64, 512}, zero and random initial state;
     ragged S 37 and 100; a log decay of about -20 (plain in chunks of 1:
     ROADMAP §3, F5) and of about -1e-6 on every token; and the
     full-width shape (8, 512, 32, 64) that the main path launches it at,
     rtol = atol = 1e-4, every output finite, and every case against the
     recurrence in f64 within the same; at full width, the time per
     launch of both (profiler and events) and the bound;
  c. the reduced rwkv6-1.6b with seeded weights against
     tests/golden/torch_port_rwkv6_reduced.json (the JAX package's
     prefill and decode logits, 1e-4, and greedy tokens);
  d. rwkv6-1.6b at full width (24 layers, d_model 2048): generate for
     batch 8, prompt 512, 16 new tokens, wkv6 launched once per layer of
     the prefill; cache consistency (prefill against a shorter prefill
     plus decode steps): 448 + 64 and 63 + 1 steps within 1e-3 of the
     largest logit, 64 + 64 within 2e-3 (MODEL_F32_TOL), and witnesses
     of that case, held to the same: the same with every prefill through
     wkv6_plain, the kernel against wkv6_plain in the model, and the
     drift of the same steps from a state moved by one f32 rounding;
     medians and ranges over two windows of prefill, decode and
     generate wall, tokens/s, peak device memory, and profiles of a
     prefill and of four decode steps, with wkv6's share of their device
     time.
The dense GQA serving path (f32, TF32 off):
  e. the flash_attention build (in parallel with the two others): seconds,
     and ptxas registers and spills per dtype and hd;
  f. flash_attention (3xTF32 mma.sync on the tensor cores, cp.async ring)
     against its plain PyTorch version (attention_plain)
     on seeded cases: hd in {16, 32, 64, 128} x Sq = Sk in {1, 63, 64,
     512} and Sq < Sk (100 over 300), causal and not, KV groups of 1 and
     4 query heads, f32 within 2e-5 and bf16 within 2e-2
     (tests/test_kernels.py's tolerances); then at the prefill's
     full-width shape (8, 512, 32 query / 8 KV heads, 128), causal, f32:
     both against the same attention in f64 (the kernel within 5e-6), the
     time per launch of the kernel (profiler, and CUDA events in turns
     with torch's scaled_dot_product_attention on the repeated KV heads,
     the library yardstick the port never calls), of attention_plain, and
     both operation bounds: the CUDA cores' f32 rate and three TF32 passes
     on the tensor cores; and at arctic-480b's shape (8, 512, 56 query / 8
     KV heads, 128), a GQA group of 7, against attention_plain and f64,
     timed beside the plain version and SDPA; at whisper-base's shapes,
     non-causal: the encoder's (8, 1500, 8 / 8 heads, 64) over its own
     1,500 frames and the cross attention's 448 queries over them, each
     against attention_plain and f64, timed beside the plain version and
     SDPA; and (2, 300, 8 / 8, 64) over 100 keys (non-causal Sq > Sk)
     against both, with causal Sq > Sk refused (ROADMAP §3, F4);
  g. the reduced minitron-8b and qwen2-72b with seeded weights against
     tests/golden/torch_port_dense_reduced.json (the JAX package's
     prefill and decode logits within 1e-4, greedy tokens, the weights'
     fingerprint), flash_attention launched once per layer of the
     prefill;
  h. minitron-8b at full width (32 layers, d_model 4096, 32 query and 8
     KV heads of 128, d_ff 16384, vocab 256,000; 7.7 B f32 parameters
     drawn on the card), after the RWKV model is freed: generate for batch
     8, prompt 512, 16 new tokens with flash_attention launched once per
     layer of the prefill; cache consistency 448 + 64 and 63 + 1 steps
     within 1e-3 of the largest logit; the kernel against attention_plain
     inside the model on a 128-token prefill; medians and ranges over
     two windows of prefill, decode and generate wall, tokens/s, peak
     device memory, and profiles of a prefill and of four decode steps.
     Every reading is printed before any is checked.
The MoE family (arctic-480b's std:moe; deepseek-v3-671b's mla:dense and
mla:moe), f32, this slice's main path:
  i. the reduced arctic-480b and deepseek-v3-671b with seeded weights
     against tests/golden/torch_port_moe_reduced.json (the JAX package's
     prefill and decode logits within 1e-4, greedy tokens, the weights'
     fingerprint), flash_attention launched once per GQA layer of the
     prefill (none for MLA);
  o. arctic-480b (1 layer: d_model 7168, 56 query / 8 KV heads of 128,
     128 experts top-2 of width 4864 beside the dense residual FFN of
     4864, vocab 32,000; 14.07 B f32 parameters) and deepseek-v3-671b (its
     3 dense-prefix layers of d_ff 18432 and 1 MoE layer: MLA with q_lora
     1536 and kv_lora 512, 256 experts top-8 of width 2048 and 1 shared,
     vocab 129,280; 15.11 B), each drawn on the card and freed after:
     generate for batch 8, prompt 512, 32 new tokens (flash_attention
     once per generate for arctic, never for deepseek's MLA), three timed
     windows that must give the same tokens, cache consistency 32 + 32
     and 63 + 1 steps of a 64-token prompt within 1e-3 of the largest
     logit at the capacity factor E / top_k (no token can drop), the
     kernel against attention_plain inside arctic on a 128-token prefill,
     peak device memory, and profiles of a prefill and of four decode
     steps;
The hybrid and encoder-decoder families (jamba's period kind; Whisper),
f32:
  j. the reduced jamba-v0.1-52b (one period) and whisper-base with seeded
     weights (and Whisper's frames from a numpy seed) against
     tests/golden/torch_port_hybrid_reduced.json (the JAX package's
     prefill and first decode logits within 1e-4, greedy tokens, the
     weights' fingerprint), flash_attention launched once per period of
     a jamba prefill and n_enc + 2 n_dec times per Whisper prefill;
  p. jamba-v0.1-52b at full width cut to 1 of its 4 periods (8 layers:
     7 Mamba mixers of d_inner 8192, one attention of 32 query / 8 KV
     heads of 128 without positions, 4 dense SwiGLU FFNs of 14336 and 4
     MoE layers of 16 experts top-2; 13.30 B f32 parameters), drawn on
     the card and freed after, as phase o serves the MoE models: generate
     for batch 8, prompt 512, 32 new tokens (flash_attention once per
     generate), three windows that give the same tokens, cache
     consistency 32 + 32 and 63 + 1 steps of a 64-token prompt at the
     capacity factor E / top_k, the kernel against attention_plain
     inside the model on a 128-token prefill, peak memory, profiles;
  w. whisper-base at full size (6 + 6 layers, d_model 512, 8 heads of
     64, vocab 51,865): factory.prefill of batch 8 over 1,500 seeded
     frames with a 32-token prompt, then 127 greedy factory.decode steps;
     flash_attention 18 times per prefill (6 encoder, 6 self, 6 cross
     attention), three windows that give the same tokens, cache
     consistency of a 64-token prefill against 32 + 32 steps, the kernel
     against attention_plain inside the model, decode ms per step, peak
     memory, profiles of a prefill and of four decode steps;
Training (f32, TF32 off, deterministic kernels; and bf16):
  k. the backward kernels (builds; ptxas registers and spills of each
     instance, none may spill): wkv6_bwd against autograd of wkv6_plain
     in f64 (hs 16/32/64 x S 64 and 100, a final-state adjoint, a log
     decay of about -20 at chunk 1, of about -1e-6, and (8, 512, 32,
     64)), and flash_attention_bwd against attention_backward_plain in
     f64 (GQA and MHA, hd 16/32/64/128, causal and full, Sq < Sk, a ragged
     key block on the causal diagonal, and (8, 512, 32 query / 8 KV
     heads, 128)), each gradient within 1e-4 of its largest magnitude;
     two calls of each on the same inputs give the same bits; at the full
     shapes the time per call of each (profiler; attention's two kernels
     each), of its plain version, of autograd's backward of SDPA
     (enable_gqa, the library yardstick, for attention), and the bounds;
     flash_attention_bwd also at Whisper's encoder shape (8, 1500, 8 / 8,
     64) and at (2, 300, 8 / 8, 64) over 100 keys, non-causal, within
     1e-4 of f64, the encoder's bits equal from call to call, its time;
     then flash_attention_bwd's bf16 form (mma.sync m16n8k16, one pass)
     at every one of those shapes: each gradient bf16, finite, within
     2e-2 of its largest magnitude from attention_backward_plain in f64
     on the same bf16 inputs and within twice the distance of
     autograd's backward of SDPA (enable_gqa) in bf16, two calls the
     same bits; timed (profiler) at the full shape, Whisper's encoder
     and arctic's and jamba's (2, 2) shapes beside the f32 form, SDPA's
     bf16 backward and the bound at the bf16 rate;
  x. training through make_train_step at full width: rwkv6-1.6b (24
     layers, 1.60 B parameters, batch 8 x 512) and minitron-8b's widths at
     2 layers (2.45 B parameters, batch 4 x 512) and whisper-base whole
     (batch 8 x 448 decoder tokens over 1,500 frames: flash_attention
     forward and backward non-causal in a real step), AdamW: the whole
     model's gradients on the kernels against the same model on their
     plain versions in f64 (128 tokens), within 1e-3 of the norm or twice
     the plain versions' in f32, a witness of the model's own sensitivity
     to the mixer's rounding; per step the forward kernel twice per call
     of a forward (forward and the checkpoint's recompute: one call per
     layer, 18 for Whisper) and the backward once per call, loss and
     grad_norm finite; 6 steps (the
     restart is held by the launcher below at full width, and by phase y
     on the MoE models; minitron-8b's 29.4 GB checkpoint round trip is
     left out for time); step time, tokens/s, peak memory, a profiled
     step's idle share, deterministic kernels on and off in turns; then,
     in this process, python -m repro_torch.launch.train --arch
     rwkv6-1.6b --full --batch 8 --seq 512 for 6 steps straight, for 4
     with a checkpoint at step 4 (--ckpt-every 4 --ckpt DIR), and the
     same to 6, which resumes and must end in the straight run's state
     bit for bit; then qwen2-vl-2b whole in bf16 (1.78 B bf16
     parameters, f32 moments), unsharded, 8 x 512: on the first batch
     the loss and every gradient leaf with the kernels held within
     twice the distance from the same weights in f32 of the same with
     attention_plain in bf16 (the witness rule); 3 steps, each with 56
     K3' launches and 28 backward calls, every one bf16; step time and
     tokens/s beside the f32 reading;
  y. the reduced arctic-480b, deepseek-v3-671b, jamba-v0.1-52b and
     whisper-base trained through make_train_step under deterministic
     kernels (the Mamba scan's backward through autograd): the loss of the
     golden's batch within 1e-5 relative of the port's on the CPU and of
     the JAX package's; 3 steps, a checkpoint, 3 steps, then the
     checkpoint restored and 3 steps again, bit-identical to the straight
     run; the straight 6 steps against the same 6 by the port on the CPU
     (the card's backward and AdamW held by an independent run): loss,
     ce and aux within MOE_TRAIN_METRIC_TOL relative, grad_norm within
     MOE_TRAIN_GRAD_TOL relative (RWKV_Y_GRAD_TOL for rwkv6-1.6b), the
     parameters after them within MOE_TRAIN_PARAM_TOL of each leaf's
     largest magnitude;
     flash_attention's launches per step (2 per attention call of the
     forward, 1 backward); then arctic-480b, deepseek-v3-671b and
     jamba-v0.1-52b the same way by the sharded step
     (make_train_step(cfg, opt_cfg, ctx)) on a (2, 1) ('data', 'model')
     mesh whose positions are this card, against the same sharded step
     on a mesh of the CPU; and qwen2-vl-2b, phi3-medium-14b, rwkv6-1.6b
     and whisper-base so on a (1, 8) mesh (the head_dim split, RWKV's
     cut heads), each kernel's launches per step as ``kernel_calls``
     counts them; then the reduced arctic-480b (2, 2), deepseek-v3-671b
     (1, 4: MLA's latent cache by sequence), jamba-v0.1-52b (3, 2),
     rwkv6-1.6b (1, 8: cut heads) and whisper-base (2, 2) served on a
     mesh of this card (factory.prefill/decode with a ctx: a prefill and
     8 greedy decode steps) and evaluated (make_eval_step(cfg, ctx))
     against the same calls unsharded at equal MoE token groups: prefill
     logits within 1e-4, tokens equal, eval within 1e-5;
  z. qwen2-vl-2b at its published widths (28 layers, 1.78 B f32
     parameters; cut to SHARD_TP_LAYERS and SHARD_SEQPAR's depth),
     trained by the sharded step on meshes repeating this
     card: (2, 2) at 8 x 512, (1, 8) at 4 x 1024 (seqpar_attention in
     every layer), and (4, 1) at its widths cut to SHARD_DP's depth;
     whisper-base whole on (2, 2) at 8 x 448; rwkv6-1.6b's widths at 2
     layers on (1, 2).  Per mesh 3 steps, the same 3 again
     (bit-identical), and 3 unsharded steps from the same seed, held
     within phase y's limits, and each leaf's change over the 3 steps
     within SHARD_UPDATE_TOL of the unsharded change (a step that moved
     nothing reads 1); step time, tokens/s, peak memory, a profiled
     sharded and unsharded step's idle share (device activity only),
     the kernels' launches per step (phases f and k hold K3' and its
     backward at each run's per-position shapes); then one bf16 step of
     qwen2-vl-2b at 4 layers on (1, 8) at 4 x 1024 (seqpar_attention,
     the bf16 backward on every slab) and unsharded, from the same
     weights: the mesh's gradient leaves within twice the unsharded bf16
     step's distance from the f32 step (the witness rule), every launch
     bf16;
  n. serving on meshes of this card (models/sharded.py): qwen2-vl-2b
     whole, 8 x 1024 prompts and 8 greedy tokens, on (2, 2), (1, 4) and
     (1, 8), one mesh per KV-cache layout (by KV heads, by sequence, by
     head_dim with seqpar_attention in every layer of the prefill), and
     rwkv6-1.6b whole and at 2 layers on (1, 2), 8 x 512: each against
     its unsharded serving (prefill logits within 1e-4 of their largest
     magnitude, the cache after the prefill gathered from its blocks
     within 1e-5, every greedy token equal; the 24-layer rwkv6-1.6b,
     whose depth amplifies f32 rounding, tokens equal and its distances
     within twice a one-ulp witness), with prefill seconds, decode ms
     a step, tokens/s, peak memory, a decode step's idle share and the
     kernel's launches per prefill (phase f times K3' at each mesh's
     per-position prefill shape).
  u. the dry run's cost pass (launch/hlo_costs.py): qwen2-vl-2b at phase
     z's widths and rwkv6-1.6b, each at 2 layers, 8 x 512 tokens, a train
     step and a prefill: on fake tensors on the host
     (launch/dryrun.py) and live on the card under the same pass, FLOPs,
     HBM bytes and the kernels' calls, FLOPs and bytes equal, the calls
     equal to the wrappers' launch counts, the predicted peak against
     torch.cuda.max_memory_allocated, the step time beside the pass's
     step_bound_s; on a (2, 2) mesh the fake pass over four devices
     against the card repeated, FLOPs and kernel calls equal; and
     qwen2-vl-2b's train step in bf16 (the dry run's default), unsharded,
     fake against live the same way.
Then:
  6. a JSON line of per-kernel numbers;
  7. the last line, {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Needs one CUDA card.
Exit status: 0 when every phase passed; 1 when a check failed (its
RuntimeError's traceback names it), there is no card, or the script
stands outside a checkout (no src/repro_torch beside it).
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# training runs with deterministic kernels (repro_torch.train.train_step),
# which need this before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
N_CASES = 1200
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor-core rate used for the kernel's integer operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# integer operations per warp slot: the candidate mask, the key, the
# argmin (counted generously)
OPS_PER_SLOT = 24
# (name, config overrides of TINY or the RTX 3080 Ti) of phase q's states
QUANTUM_CASES = (("tiny", {}), ("four_subcores", dict(
    n_sm=4, warps_per_sm=16, n_subcores=4, mshr_per_sm=6)),
    ("rtx3080ti", None))
# lane counts of the sweep's timings (phases q and l)
LANE_COUNTS = (1, 8, 32)
# phase s: launch/dse.py's default grid of this many configs, over these
# workloads at the RTX 3080 Ti's full width
SWEEP_LANES = 8
SWEEP_CASES = (("nn", 0.5), ("syrk", 0.16))
# whose lanes phase s holds against solo runs (syrk@0.16's 8 solo runs
# took ~59 s: phase t holds its lanes against solo runs, telemetry on)
SWEEP_SOLO = (("nn", 0.5),)
# phase l: the workload swept at every lane count of LANE_COUNTS
LANES_CASE = ("syrk", 0.16)
# phase t: the workload of dse's grids with telemetry (every lane of the
# default grid against its solo run, and 32 lanes): nn@0.5, whose 8 solo
# runs take ~18 s where syrk@0.16's took ~56, for the smoke's time
TELEMETRY_LANES_CASE = ("nn", 0.5)
# phase t: the JAX package's full-width timelines (tests/
# test_torch_telemetry.py --regen), and the quantum loop's kernel launches
# per quantum with telemetry off by lane count, as phase l reads them
# (PERF.md §5): telemetry off must stay within one launch of them
TELEMETRY_GOLDEN = "torch_port_telemetry.json"
LOOP_LAUNCHES_PER_Q = {1: 325.8, 8: 371.9}
# the loop's wall with telemetry off and on: quanta per run, and rounds of
# the turns off, on, on, off
TURN_QUANTA, TURNS = 64, 2
# phase r: the JAX package's search (tests/test_torch_search.py --regen)
SEARCH_GOLDEN = "torch_port_search.json"
# rounds of the card-against-CPU search and of dse --search --check
# (the CPU's verify sweeps and the solo reruns are the phase's slow part)
SEARCH_CPU_ROUNDS = 1
CPU_SEARCH_THREADS = 4           # of the card machine's 8 cores
# phase v: the simulation server on the RTX 3080 Ti: the workloads of its
# batch, the bundled traces uploaded as text, the lanes of its sample
# grid; the soak's client threads, draws per client and seed; the
# submissions the child servers get (by id); the quanta of the two
# profiled runs of a served bucket, whose difference is per quantum
SERVE_CASES = (("nn", 0.5), ("syrk", 0.16))
SERVE_TRACES = ("vecadd", "mm_tile")
SERVE_SAMPLE_LANES = 4
SOAK_CLIENTS, SOAK_DRAWS, SOAK_SEED = 4, 2, 20261017
CHILD_IDS = ("nn@0.5", "cfg", "vecadd", "mm_tile")
SERVE_PROFILE_QUANTA = (16, 48)
SERVE_CASES_TEXT = tuple(f"{b}@{s}" for b, s in SERVE_CASES)
# phase m: SM-axis sharding and the ('cfg','sm') mesh on the one card,
# every mesh position repeating it: the 1-D shards of SWEEP_CASES at full
# width, the per-cycle exchange on TINY cases, and dse's default grid of
# SWEEP_LANES configs over MESH_CASE at every shape of MESH_SHAPES
SHARD_DEVICES = 4
SHARD_CYCLE_CASES = (("myocyte", 1.0), ("trace:gather_chain", 1.0))
MESH_CASE = ("nn", 0.5)
MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1))
MESH_TELEMETRY_SHAPE = (2, 2)
MESH_PROFILE_QUANTA = 16
# phase 3: (workload, scale, mode, timeouts) against determinism_tiny.json.
# hotspot@0.02 is cut by the golden's cycle cap in 2 of its 4 kernels: the
# JAX package reads timeouts 2 on the same run (ROADMAP.md §3), the card
# must read the same
TINY_CASES = (("myocyte", 1.0, "vmap", 0), ("myocyte", 1.0, "seq", 0),
              ("trace:gather_chain", 1.0, "vmap", 0),
              ("trace:gather_chain", 1.0, "seq", 0),
              ("hotspot", 0.02, "vmap", 2))
TF32_OPS_PER_S = 495e12          # tensor cores, dense TF32
TF32_PASSES = 3                  # the f32 split: three TF32 products
BF16_OPS_PER_S = 989e12          # tensor cores, dense bf16: one pass
FLASH_F64_TOL = 5e-6             # the kernel against f64 at full width
# wkv: per token and state element, the k (x) v product (1), the decay-and-
# add (2) and the read-out (2)
WKV_OPS_PER_ELEMENT = 5
WKV_TOL = 1e-4                   # tests/test_kernels.py's wkv6 tolerance
WKV_FULL_SHAPE = (8, 512, 32, 64)        # (B, S, H, hs) of phase d's prefill
WKV_TP_SHAPE = (4, 512, 16, 64)          # a model position's in phase z
WKV_SERVE_SHAPE = (8, 512, 16, 64)       # a model position's in phase n
RWKV_ARCH = "rwkv6-1.6b"
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW = 8, 512, 16      # 32 before phase n
CONSISTENCY_TOL = 1e-3           # of the largest logit
# of the largest logit, for two f32 runs of the full-width model that
# round differently and that CONSISTENCY_TOL cannot hold: 128 tokens
# against 64 plus 64 decode steps, and the kernel against wkv6_plain in
# the prefill.  Set from their readings, 6.2e-4 to 1.1e-3 (PERF.md, PR 12)
MODEL_F32_TOL = 2e-3
RWKV_REPEATS = 2                 # timing windows of phase d
# flash attention: tests/test_kernels.py's tolerances by dtype
FLASH_TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, S, H, KV, hd) of phase h's prefill, where the main path launches it
FLASH_FULL_SHAPE = (8, 512, 32, 8, 128)
DENSE_ARCH = "minitron-8b"
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 8, 512, 16   # 32 before phase n
DENSE_REPEATS = 2                # timing windows of phase h
# phase f: arctic-480b's attention shape (B, S, H, KV, hd), a GQA group of
# 7 query heads, which the MoE path (phase o) launches the kernel at
FLASH_ARCTIC_SHAPE = (8, 512, 56, 8, 128)
# phases f, k and z: qwen2-vl-2b's attention on one position's rows of the
# sharded step (B, S, H, KV, hd), a GQA group of 6: on the (4, 1) mesh,
# and on the (2, 2) mesh's model positions (half the heads each)
FLASH_QWEN_VL_SHAPE = (2, 512, 12, 2, 128)
FLASH_QWEN_VL_TP_SHAPE = (4, 512, 6, 1, 128)
# phases f and k: K3' on a (2, 2) mesh's model position at 4 rows of 512
# tokens a data position (scripts/shard_probes.py's four-card runs):
# arctic-480b's 56 q / 8 KV heads halved, a GQA group of 7, and
# jamba-v0.1-52b's attention sublayer's 32 / 8 halved, a group of 4
FLASH_EP_TP_SHAPES = {"arctic-480b": (4, 512, 28, 4, 128),
                      "jamba-v0.1-52b": (4, 512, 16, 4, 128)}
# phases f, k and z: the slabs of qwen2-vl-2b's sequence-parallel attention
# on a (1, 8) mesh, 4 rows of 1,024 tokens: each model position's 128
# queries (B, Sq, H, KV, hd), causal over the keys up to its slab's end
# (Sk 128 for the first slab ... 1,024 for the last; phase f times these)
FLASH_SEQPAR_SHAPE = (4, 128, 12, 2, 128)
FLASH_SEQPAR_SK = (128, 512, 1024)
# phases f and n: qwen2-vl-2b's prefill of 8 rows of 1,024 tokens at one
# position of each serving mesh ((B, Sq, H, KV, hd), Sk): (2, 2) 4 rows
# and half the heads, (1, 4) a quarter of the heads, (1, 8) seqpar's
# first and last slabs of 128 queries, causal over the keys up to their
# end (jamba-v0.1-52b's (2, 2) shape is FLASH_EP_TP_SHAPES')
FLASH_SERVE_CASES = {"qwen2-vl-2b (2, 2)": ((4, 1024, 6, 1, 128), 1024),
                     "qwen2-vl-2b (1, 4)": ((8, 1024, 3, 1, 128), 1024),
                     "qwen2-vl-2b (1, 8) first slab": ((8, 128, 12, 2, 128),
                                                       128),
                     "qwen2-vl-2b (1, 8) last slab": ((8, 128, 12, 2, 128),
                                                      1024)}
# phases f and k: whisper-base's shapes on a (2, 2) mesh's model position
# (4 of its 8 heads, 4 rows): name -> ((B, Sq, H, KV, hd), Sk, causal)
WHISPER_TP_CASES = {"encoder": ((4, 1500, 4, 4, 64), 1500, False),
                    "cross": ((4, 448, 4, 4, 64), 1500, False),
                    "self": ((4, 448, 4, 4, 64), 448, True)}
# phase f: Whisper's shapes ((B, Sq, H, KV, hd), Sk), non-causal, where
# whisper-base launches the kernel (phases w and x): the encoder's
# self-attention over its 1,500 frames (a ragged last tile: 1500 = 23 x 64
# + 28) and the decoder's cross attention of 448 queries over them; and a
# reduced case with more queries than keys (B, Sq, H, KV, hd, Sk), which
# only non-causal attention takes (ROADMAP §3, F4)
WHISPER_FLASH_CASES = {"encoder": ((8, 1500, 8, 8, 64), 1500),
                       "cross": ((8, 448, 8, 8, 64), 1500)}
FLASH_WIDE_CASE = (2, 300, 8, 8, 64, 100)
# phases i, o and y: the MoE family at its published widths, cut in depth
# only: arctic-480b at 1 layer (14.07 B f32 parameters, 56.3 GB; two
# would not fit the card), deepseek-v3-671b at its 3 dense-prefix layers
# and 1 MoE layer (15.11 B, 60.4 GB)
MOE_CASES = (("arctic-480b", 1), ("deepseek-v3-671b", 4))
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 512, 32
MOE_REPEATS = 3                  # generate windows, the same tokens each
# cache consistency at the capacity factor E / top_k, where C >= N and no
# token can drop (64 for arctic, 32 for deepseek), on a prompt of 64
# tokens: at 8 x 64 tokens the (E, C, d) buffer is 1.9 GB (arctic) and
# 3.8 GB (deepseek) beside the weights; 512 would not fit
MOE_CONS_CASES = ((64, 32), (64, 1))
MOE_GOLDEN = "torch_port_moe_reduced.json"
# phases j, p, w and y: jamba-v0.1-52b (arXiv:2403.19887) at its published
# widths cut to 1 of its 4 periods of 8 layers (13.30 B f32 parameters with
# the embedding and head, 53.2 GB), served as the MoE models are; and
# whisper-base (arXiv:2212.04356, 72.8 M parameters) whole: batch 8 over
# the encoder's 1,500 frames, a prompt of 32 decoder tokens, 128 new by a
# greedy prefill + decode loop, repeated windows that must give the same
# tokens, cache consistency of a 64-token prefill against 32 + 32 steps
HYBRID_GOLDEN = "torch_port_hybrid_reduced.json"
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 8, 32, 128
WHISPER_REPEATS = 3
WHISPER_CONS = (64, 32)
# phase k: the backward kernels, each gradient within BWD_TOL of its
# largest magnitude from the plain backward in f64 (the CPU tests' bound
# for the model's gradients); operations per state element and token of
# wkv6's backward: the state recomputed (2), the adjoint (2), and the sums
# of dr, dk, dv and dw (2 each)
BWD_TOL = 1e-4
WKV_BWD_OPS_PER_ELEMENT = 12
# phase x: training at full width, (arch, layers or None for all, batch,
# sequence).  The restarts: rwkv6-1.6b's at full width through the
# launcher (a 19.2 GB checkpoint takes ~30 s each way on that disk), the
# reduced MoE models' in phase y; minitron-8b's 29.4 GB round trip, ~100
# s, is left out to keep the smoke within its time.  The whole model's gradients, on TRAIN_CMP_SEQ tokens
# at full width and TRAIN_CMP_LAYERS layers, with the kernels against the
# same model with the plain versions in f64: the norm of their difference
# within TRAIN_GRAD_TOL of the gradient's norm.  At 24 layers a seeded
# RWKV-6 cannot be held so: its gradient grows ~3,300-fold (d_model 512
# on the CPU) to ~38,500-fold (full width) from the top layer to the
# embedding and moves by percents to tens of percents of its norm when
# only the wkv's rounding moves, in the stepwise form as in the chunked
# one (scripts/rwkv_grad_sensitivity.py).  There every wkv6
# call's gradients, as the autograd function gave them, are held within
# BWD_TOL of autograd of the f64 plain form on that call's inputs and
# output gradients, and the whole model's distances are readings.
TRAIN_CASES = (("rwkv6-1.6b", None, 8, 512),
               ("minitron-8b", 2, 4, 512),
               ("whisper-base", None, 8, 448))
# phase x: the launcher's restart, whisper-base whole (a 0.87 GB
# checkpoint, where rwkv6-1.6b's 19.2 GB took ~45 s each way: the smoke's
# time)
LAUNCHER_CASE = TRAIN_CASES[2]
TRAIN_CMP_SEQ = 128
TRAIN_CMP_LAYERS = 2
TRAIN_GRAD_TOL = 1e-3
TRAIN_OPT = dict(peak_lr=1e-4, warmup_steps=2, total_steps=20)
TRAIN_STEPS = 3
TRAIN_DATA_SEED = 1234
# bf16 training (phases k, x, z, u).  The witness rule of the CPU tests
# (tests/test_torch_bf16_train.py): a bf16 result no farther from its f32
# truth than BF16_WITNESS times a witness's bf16 result is: for the
# backward kernels autograd's backward of SDPA in bf16 (the library's
# rounding), for a train step the same step with attention_plain (phase
# x) or unsharded (phase z), in bf16.  Phase x trains BF16_TRAIN_ARCH
# whole (28 layers; 1.78 B bf16 parameters, 3.6 GB, and f32 moments, 14
# GB) at phase z's SHARD_BATCH x SHARD_SEQ, unsharded; its f32 reading,
# the same model unsharded at 8 x 512: BF16_TRAIN_F32_STEP_S a step on
# the H100 (PERF.md §5)
BF16_WITNESS = 2
BF16_TRAIN_ARCH = "qwen2-vl-2b"
BF16_TRAIN_F32_STEP_S = 1.291
# phase y: the reduced MoE models' 6 steps on the card against the same
# steps on the CPU.  Perturbing the weights by 1e-6 relative moved these
# by at most 8e-7 (loss, ce, aux), 2.1e-6 (grad_norm) and 1.4e-5 (a
# leaf after 6 steps) on the CPU (both models; the two sides' rounding
# alone moved the golden batch's loss by ~7e-8 on the card).
# phase y also runs the reduced MoE models and jamba by the sharded step on
# a mesh of this shape, every position on the card (and on the CPU for the
# comparison)
SHARD_Y_MESH = (2, 1)
SHARD_Y_ARCHS = ("arctic-480b", "deepseek-v3-671b", "jamba-v0.1-52b")
# and on a model axis of 8 (every position on the card, and on the CPU for
# the comparison): qwen2-vl-2b and phi3-medium-14b head_dim split into 2
# columns (their attention once per data position on whole heads at 32
# tokens), rwkv6-1.6b's heads of 16 cut into 8 columns, Whisper's heads
# split by head_dim too
SHARD_Y_TP_MESH = (1, 8)
# phase y: the model axis of the MoE, MLA and jamba families, one mesh per
# expert placement of ctx.ep_axes (golden, arch, mesh, rows a step, None
# for the golden's 2): '2d' arctic-480b on (2, 2) (experts over data, their
# d_ff over model), 'full' deepseek-v3-671b on (1, 4) (one expert a
# position; MLA's 4 heads split), 'tp' jamba-v0.1-52b on (3, 2) (experts
# over model; d_inner split) at 6 rows, 2 a data position
SHARD_Y_EP = ((MOE_GOLDEN, "arctic-480b", (2, 2), None),
              (MOE_GOLDEN, "deepseek-v3-671b", (1, 4), None),
              (HYBRID_GOLDEN, "jamba-v0.1-52b", (3, 2), 6))
SHARD_Y_TP_ARCHS = ("qwen2-vl-2b", "phi3-medium-14b", "rwkv6-1.6b",
                    "whisper-base")
# phase y: the reduced rwkv6-1.6b's gradient norm, card against CPU.  Its
# 4th step's gradient (norm ~109 against ~40 on the others) turns rounding
# into 1.4e-4 of its norm: weights moved by 1e-7 relative (an f32
# rounding) move it by 1.4e-4 on the CPU, by 1e-6 relative 9.9e-4, where
# the other models of SHARD_Y_TP_ARCHS move by at most 2.7e-7 and 1.9e-6
# (scripts/reduced_sensitivity.py).  MOE_TRAIN_GRAD_TOL sits below that
# reading; RWKV's is ten roundings' worth
RWKV_Y_GRAD_TOL = 1e-3
# phase z: qwen2-vl-2b (arXiv:2409.12191) at its published widths (28
# layers, 1.78 B f32 parameters, a ~28 GB train state; scripts/
# shard_probes.py qwen trains it whole), trained by the sharded step on
# ('data', 'model') meshes repeating this card: (2, 2), 4 rows of 512
# tokens per data position, each model position on half the heads, so K3'
# runs at FLASH_QWEN_VL_TP_SHAPE, cut to SHARD_TP_LAYERS layers to keep the
# smoke within its time (14 before phase n, which serves it whole)
SHARD_ARCH = "qwen2-vl-2b"
SHARD_MESHES = ((2, 2),)
SHARD_TP_LAYERS = 7
SHARD_BATCH, SHARD_SEQ = 8, 512
# phase z: the (4, 1) mesh's run (PR 25's, the data axes only, which the
# (2, 2) run covers too; 2 rows per position, K3' at FLASH_QWEN_VL_SHAPE)
# at qwen2-vl-2b's widths cut to this depth, beside its own unsharded run,
# to keep the smoke within its time: (mesh, layers)
SHARD_DP = ((4, 1), 4)
# phase z: qwen2-vl-2b on a (1, 8) mesh, 4 rows of 1,024 tokens: 12 heads
# do not divide 8, head_dim 128 does, and 1,024 / 8 = 128 queries a
# position meets the reference's test for sequence-parallel attention, so
# every layer runs seqpar_attention, K3' on each position's slab (mesh,
# batch, sequence, layers: its widths cut in depth for the smoke's time;
# 8 layers before phase n)
SHARD_SEQPAR = ((1, 8), 4, 1024, 4)
# phase z: whisper-base whole on a (2, 2) mesh, 8 x 448 decoder tokens
# over 1,500 frames: its 8 heads split, 4 a model position (arch, mesh,
# batch, sequence)
SHARD_WHISPER = ("whisper-base", (2, 2), 8, 448)
# phase z: rwkv6-1.6b at its published widths and 2 layers (phase x's
# depth for a gradient held to a limit), 4 x 512 tokens, on a (1, 2) mesh:
# the embedding split over d_model and K2 on half the heads, at
# WKV_TP_SHAPE; (arch, layers, batch, meshes)
SHARD_RWKV = ("rwkv6-1.6b", 2, 4, ((1, 2),))
# phase z: deepseek-v3-671b at its published widths cut to its 3 dense-
# prefix layers (MLA and a dense FFN: 3.60 B f32 parameters, a 57.6 GB
# train state of parameters, gradients and two moments; the run's
# snapshots kept on the host), 4 x 512 tokens on a (2, 2) mesh: MLA's 128
# heads split, 64 a model position (arch, layers, batch, meshes)
SHARD_MLA = ("deepseek-v3-671b", 3, 4, ((2, 2),))
MOE_TRAIN_METRIC_TOL = 1e-5
MOE_TRAIN_GRAD_TOL = 1e-4
MOE_TRAIN_PARAM_TOL = 1e-3
# phase z: each leaf's change over the steps, sharded against unsharded,
# in L2 over the unsharded change's L2.  A sharded step that moved no
# parameter reads 1.  On the CPU (scripts/shard_update_cpu.py: reduced
# qwen2-vl-2b, 8 x 64 and 8 x 256, mesh (4, 1)) the worst leaf read
# 6.9e-4 and 7.2e-4, a key bias: under M-RoPE its gradient is a sum that
# mostly cancels, and AdamW's normalised first steps turn its rounding
# into a share of the update.
SHARD_UPDATE_TOL = 5e-2
# phase n: serving on meshes of the card (models/sharded.py).  qwen2-vl-2b
# whole (arXiv:2409.12191: 28 layers, d_model 1536, 12 q / 2 KV heads of
# 128, vocab 151,936), token prompts SERVE_BATCH x SERVE_PROMPT and
# SERVE_NEW greedy tokens, on one mesh per cache layout that the rules
# give it: (2, 2) by KV heads, (1, 4) by sequence (3 query heads a
# position, the cache's max_len in 4 slabs), (1, 8) by head_dim (the
# prefill through seqpar_attention in every layer); then rwkv6-1.6b whole
# (arXiv:2404.05892: 24 layers, d_model 2048, heads of 64) on (1, 2), S
# by heads: (arch, layers (None: all), meshes, batch, prompt, new, held);
# 8 new tokens, not 16, for the smoke's time.
# A seeded 24-layer RWKV-6 turns f32 rounding into ~1e-4 of its logits
# and ~1e-3 of its last state (on the CPU, the reduced model at 24 layers:
# one ulp of the embedding moves its logits by 1.5e-4): the whole model
# is held to equal tokens, its distances printed beside that of the
# unsharded model with its embedding moved by one ulp; rwkv6-1.6b at its
# published widths and 2 layers is held at the limits below, as phase x
# holds its gradients
MESH_SERVE_CASES = (
    ("qwen2-vl-2b", None, ((2, 2), (1, 4), (1, 8)), 8, 1024, 8, True),
    ("rwkv6-1.6b", None, ((1, 2),), 8, 512, 8, False),
    ("rwkv6-1.6b", 2, ((1, 2),), 8, 512, 8, True))
SERVE_SEED = 2029
SERVE_LOGIT_TOL = 1e-4           # of the largest prefill logit
SERVE_CACHE_TOL = 1e-5           # of each cache leaf's largest magnitude
# a model not held to those: its distances within this many times the
# witness's, the distances that one ulp of its embedding makes
SERVE_WITNESS_FACTOR = 2
# phase y: the reduced configs served and evaluated on a mesh of the card
# against the same calls unsharded at equal token groups: (arch, mesh,
# rows); prompts of SERVE_Y_PROMPT tokens, SERVE_Y_NEW greedy tokens (a
# prefill and SERVE_Y_NEW - 1 decode steps), the caches sized
# SERVE_Y_MAX_LEN so that every mesh splits their sequence where the rules
# say (deepseek's latent over 4 slabs)
SERVE_Y = (("arctic-480b", (2, 2), 4), ("deepseek-v3-671b", (1, 4), 4),
           ("jamba-v0.1-52b", (3, 2), 3), ("rwkv6-1.6b", (1, 8), 4),
           ("whisper-base", (2, 2), 2))
# phase u: the dry run's cost pass (launch/hlo_costs.py) on fake tensors
# against the same step live on the card: qwen2-vl-2b at phase z's widths
# (K3' and its backward) and rwkv6-1.6b (K2 and wkv6_bwd), each cut to
# COST_LAYERS layers, COST_BATCH x COST_SEQ tokens, a train step and a
# prefill unsharded, and on COST_MESH of fake distinct devices against
# the card repeated.  The predicted peak (the fake pass's, over the
# step's arguments) against the allocator's (torch.cuda.
# max_memory_allocated over what was held before the step): within
# COST_PEAK_REL of it plus COST_PEAK_ABS bytes.  Measured on one H100:
# the allocator 1.0000-1.0043x the prediction, at most 33.6 MB over
# it (qwen2-vl-2b's step: cuBLAS's 32 MiB workspace of :4096:8 and the
# allocator's 512-byte rounding)
COST_ARCHS = ("qwen2-vl-2b", "rwkv6-1.6b")
# and qwen2-vl-2b's train step in bf16 (the dry run's default dtype),
# unsharded: (arch, kind)
COST_BF16 = ("qwen2-vl-2b", "train")
COST_LAYERS = 2
COST_BATCH, COST_SEQ = 8, 512
COST_MESH = (2, 2)
COST_PEAK_REL, COST_PEAK_ABS = 0.01, 40 << 20
SERVE_Y_PROMPT, SERVE_Y_NEW, SERVE_Y_MAX_LEN = 64, 9, 80
SERVE_Y_EVAL_RTOL = 1e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_spills(log, pattern):
    """[(instance, registers, spill store bytes, spill load bytes)] of the
    kernels whose mangled names match ``pattern`` (its groups, joined by
    '/', name the instance) in an ``nvcc -Xptxas -v`` log."""
    out, inst, spills = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(pattern, ln)
        if m:
            inst = "/".join(g for g in m.groups() if g)
        elif inst and "spill" in ln:
            spills = tuple(int(re.search(rf"(\d+) bytes spill {w}",
                                         ln).group(1))
                           for w in ("stores", "loads"))
        elif inst and "registers" in ln:
            out.append((inst, int(re.search(r"(\d+) registers",
                                            ln).group(1)), *spills))
            inst, spills = None, (0, 0)
    return out


def ptxas_lines(log):
    """The register, shared-memory and spill lines of ``-Xptxas -v``."""
    return " | ".join(ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "Used" in ln
                      or "spill" in ln)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def random_case(rng, torch, ns, w, sc, kind):
    """Seeded inputs of the sm_issue kernel, on the card.

    kind: 'neutral' (the TPU kernel's contract: no barrier wait, GTO,
    instr_base 0, n_instr = len(ops)), 'full' (barriers, LRR, instr_base,
    padded ops, n_instr down to 0) or 'ties' (identical warps: the lowest
    slot or the last-issued warp must win)."""
    dev = "cuda"
    L = int(rng.integers(1, 40))
    if kind == "ties":
        pc = np.full((ns, w), int(rng.integers(0, L)), np.int32)
        active = np.ones((ns, w), bool)
        ready_at = np.zeros((ns, w), np.int32)
        pending = np.zeros((ns, w), np.int32)
        wait_mem = np.zeros((ns, w), bool)
        wait_bar = rng.random((ns, w)) < 0.05
        unit_free = np.zeros((ns, sc, 5), np.int32)
        t = 0
    else:
        pc = rng.integers(0, L + 2, (ns, w)).astype(np.int32)
        active = rng.random((ns, w)) < 0.7
        ready_at = rng.integers(0, 20, (ns, w)).astype(np.int32)
        pending = rng.integers(0, 2, (ns, w)).astype(np.int32)
        wait_mem = rng.random((ns, w)) < 0.3
        wait_bar = (rng.random((ns, w)) < 0.2 if kind == "full"
                    else np.zeros((ns, w), bool))
        unit_free = rng.integers(0, 15, (ns, sc, 5)).astype(np.int32)
        t = int(rng.integers(0, 15))
    last = rng.integers(-1, w, (ns, sc)).astype(np.int32)
    if kind == "neutral":
        base, n_instr, sched, n_ops = 0, L, 0, L
    else:
        base = int(rng.integers(0, 8))
        n_instr = int(rng.integers(0, L + 1))
        sched = int(rng.integers(0, 2))
        n_ops = base + L + int(rng.integers(0, 8))
    ops = rng.integers(0, 7, (n_ops,)).astype(np.int32)

    def T(x):
        return torch.as_tensor(x, device=dev)

    return ((T(pc), T(active), T(ready_at), T(pending), T(wait_mem),
             T(wait_bar), T(last), T(unit_free), T(ops))
            + tuple(T(np.int32(v)) for v in (n_instr, base, sched, t)), sc)


def time_per_call(torch, fn, n):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n          # ms


def device_events(prof):
    """(name, microseconds) of every device activity a profile caught:
    kernels, copies and fills."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def profiled(torch, fn, host=True):
    """(device events, wall s) of ``fn`` under the profiler; with ``host``
    False it records the device's activity only, which costs the host's
    issue loop less and leaves fewer events to read back (phase z's
    steps: ~85,000 device activities, several times as many host
    events)."""
    from torch.profiler import ProfilerActivity, profile
    sync_cards(torch)
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync_cards(torch)
        wall = time.perf_counter() - t0
    return device_events(prof), wall


def kernel_us(torch, fn, name):
    """Device time in microseconds of each launch of kernels whose name
    holds ``name`` while ``fn`` runs; a profiler window now and then
    reports no device activity, so up to three windows are tried."""
    for _ in range(3):
        events, _ = profiled(torch, fn)
        kern = [us for ev, us in events if name in ev]
        if kern:
            break
    return kern


def phase_kernel(torch, K):
    """Kernel vs plain version, exact, on seeded cases."""
    rng = np.random.default_rng(20261016)
    shapes = ((8, 8, 2), (80, 48, 4), (4, 8, 2), (3, 96, 3))
    kinds = ("neutral", "full", "ties")
    n_bad, max_err = 0, 0
    counts = {k: 0 for k in kinds}
    for i in range(N_CASES):
        ns, w, sc = shapes[i % len(shapes)]
        kind = kinds[(i // len(shapes)) % len(kinds)]
        args, sc = random_case(rng, torch, ns, w, sc, kind)
        got = K.issue_select(*args, n_subcores=sc)
        ref = K.issue_select_plain(*args, n_subcores=sc)
        for g, r in zip(got, ref):
            max_err = max(max_err, int((g - r).abs().max()))
            n_bad += int(not torch.equal(g, r))
        counts[kind] += 1
    torch.cuda.synchronize()
    check(n_bad == 0, f"sm_issue kernel disagrees with its plain version "
          f"in {n_bad} outputs (max abs err {max_err})")
    # time both at the main path's full width
    args, sc = random_case(rng, torch, 80, 48, 4, "full")
    wrapper_ms = time_per_call(
        torch, lambda: K.issue_select(*args, n_subcores=sc), 2000)
    plain_ms = time_per_call(
        torch, lambda: K.issue_select_plain(*args, n_subcores=sc), 200)

    def launches():
        for _ in range(500):
            K.issue_select(*args, n_subcores=sc)
    kern = kernel_us(torch, launches, "sm_issue_kernel")
    # device time per launch from the profiler; the CUDA-event time of
    # back-to-back wrapper calls where the profiler saw no device activity
    ms = sum(kern) / len(kern) / 1e3 if kern else wrapper_ms
    n_bytes = sum(x.numel() * x.element_size() for x in args) \
        + 2 * 80 * 4 * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 80 * 48 * OPS_PER_SLOT / ALU_OPS_PER_S * 1e3
    return {"cases": sum(counts.values()), "by_kind": counts,
            "max_abs_err": max_err, "ms": ms, "wrapper_ms": wrapper_ms,
            "device_timed": bool(kern), "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes}


def wkv_case(rng, torch, b, s, h, hs, zero_state, decay="random"):
    """Seeded wkv6 inputs on the card, tests/test_kernels.py's
    distributions: r, k, v ~ 0.5 N, log decay -exp(N - 1), u ~ 0.3 N;
    or a log decay about -20 ("strong") or -1e-6 ("weak") on every token;
    the initial state ~ 0.5 N, or zero (the TPU kernel's contract)."""
    f = np.float32
    shp = (b, s, h, hs)
    host = [(0.5 * rng.standard_normal(shp)).astype(f) for _ in range(3)]
    z = rng.standard_normal(shp)
    host.append({"random": -np.exp(z - 1), "strong": -20 * np.exp(0.05 * z),
                 "weak": -1e-6 * np.exp(0.3 * z)}[decay].astype(f))
    host.append((0.3 * rng.standard_normal((h, hs))).astype(f))
    host.append(np.zeros((b, h, hs, hs), f) if zero_state else
                (0.5 * rng.standard_normal((b, h, hs, hs))).astype(f))
    return [torch.as_tensor(x, device="cuda") for x in host]


def wkv_bound(b, s, h, hs):
    """(bound_ms, bound_by, bytes, operations) of one wkv over (b, s, h,
    hs): r, k, v, w, u and the initial state read once, o and the final
    state written once, against WKV_OPS_PER_ELEMENT f32 operations per
    token and state element at the card's f32 rate."""
    n_bytes = 4 * (5 * b * s * h * hs + h * hs + 2 * b * h * hs * hs)
    n_ops = WKV_OPS_PER_ELEMENT * b * s * h * hs * hs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def phase_wkv6(torch, W):
    """wkv6 against wkv6_plain on seeded cases, then timed at the
    full-width shape."""
    from repro_torch.kernels.wkv6.ref import wkv_ref_stepwise
    rng = np.random.default_rng(20261017)
    n_cases, max_err, worst, worst_f64 = 0, 0.0, 0.0, 0.0
    by_kind = {}
    cases = [((2, s, 4, hs), zero_state, "random") for hs in (16, 32, 64)
             for s in (1, 64, 512) for zero_state in (True, False)]
    # ragged lengths, within a chunk and over several
    cases += [((2, s, 4, hs), False, "random") for hs in (16, 64)
              for s in (37, 100)]
    # a log decay of about -20 and of about -1e-6 on every token
    cases += [((2, s, 4, hs), s == 37, decay) for decay in ("strong", "weak")
              for hs in (16, 32, 64) for s in (37, 512)]
    # a model position's in phases z and n; last, the shape the main path
    # launches it at, which is also timed
    cases.append((WKV_TP_SHAPE, True, "random"))
    cases.append((WKV_SERVE_SHAPE, True, "random"))
    cases.append((WKV_FULL_SHAPE, True, "random"))
    for shape, zero_state, decay in cases:
        args = wkv_case(rng, torch, *shape, zero_state, decay)
        s = shape[1]
        # wkv6_plain's chunk divides S; under strong decay its chunked
        # form's own f32 rounding is above the tolerance (ROADMAP §3, F5),
        # and it runs token by token
        chunk = 1 if decay == "strong" else (64 if s % 64 == 0 else s)
        got = W.wkv6(*args, chunk=chunk)       # the kernel reads no chunk
        want = W.wkv6_plain(*args, chunk=chunk)
        truth = wkv_ref_stepwise(*(a.double() for a in args))
        torch.cuda.synchronize()
        for g, r, t in zip(got, want, truth):
            check(bool(torch.isfinite(g).all()), f"wkv6 returned a value "
                  f"that is not finite at {shape}, {decay} decay")
            err = (g - r).abs()
            max_err = max(max_err, float(err.max()))
            # allclose's measure: |g - r| <= atol + rtol |r|
            worst = max(worst, float(
                (err / (WKV_TOL + WKV_TOL * r.abs())).max()))
            worst_f64 = max(worst_f64, float(
                ((g.double() - t).abs() / (WKV_TOL + WKV_TOL * t.abs()))
                .max()))
        n_cases += 1
        kind = decay if decay != "random" else (
            "ragged" if s not in (1, 64, 512) else "seeded")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    check(worst <= 1.0, f"wkv6 disagrees with wkv6_plain beyond "
          f"rtol = atol = {WKV_TOL} (max abs err {max_err}, worst "
          f"err/tol {worst})")
    check(worst_f64 <= 1.0, f"wkv6 disagrees with the recurrence in f64 "
          f"beyond rtol = atol = {WKV_TOL} (worst err/tol {worst_f64})")
    # at the full-width shape, both f32 forms against the recurrence in f64
    vs_f64 = {name: max(float((o.double() - t).abs().max())
                        for o, t in zip(out, truth))
              for name, out in (("wkv6", got), ("wkv6_plain", want))}
    check(all(torch.allclose(o.double(), t, rtol=WKV_TOL, atol=WKV_TOL)
              for o, t in zip(got, truth)),
          f"wkv6 disagrees with the f64 recurrence beyond rtol = atol = "
          f"{WKV_TOL} (max abs err {vs_f64['wkv6']})")
    wrapper_ms = time_per_call(torch, lambda: W.wkv6(*args), 20)
    plain_ms = time_per_call(torch, lambda: W.wkv6_plain(*args), 5)

    def launches():
        for _ in range(10):
            W.wkv6(*args)
    kern = kernel_us(torch, launches, "wkv6_kernel")
    ms = sum(kern) / len(kern) / 1e3 if kern else wrapper_ms
    bound_ms, bound_by, n_bytes, n_ops = wkv_bound(*WKV_FULL_SHAPE)
    return {"cases": n_cases, "by_kind": by_kind, "max_abs_err": max_err,
            "worst": worst, "worst_f64": worst_f64,
            "vs_f64": vs_f64, "ms": ms, "wrapper_ms": wrapper_ms, "device_timed": bool(kern),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops}


def phase_rwkv_reduced(torch, W):
    """The reduced rwkv6-1.6b on the card against the JAX package's
    golden result for the same seeded weights and prompt."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import (lm_params_to_torch, params_fingerprint,
                                     seeded_lm_params)
    from repro_torch.models import factory
    from repro_torch.models.lm import LM

    with open(os.path.join(GOLDEN, "torch_port_rwkv6_reduced.json")) as f:
        golden = json.load(f)
    cfg = get_reduced(golden["arch"])
    tree = seeded_lm_params(cfg, golden["weight_seed"])
    fp = params_fingerprint(tree)
    check(abs(fp - golden["weights_sum"]) <= 1e-9 * golden["weights_sum"],
          f"seeded weights differ from the golden's (sum |w| {fp} vs "
          f"{golden['weights_sum']}): numpy's random stream changed")
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cuda"))
    prompts = torch.tensor(golden["prompt"], dtype=torch.int32,
                           device="cuda")
    W.wkv6.launches = 0
    logits, cache = _prefill(model, prompts, cfg)
    launches = W.wkv6.launches
    check(launches == cfg.n_layers, f"reduced prefill launched wkv6 "
          f"{launches} times for {cfg.n_layers} layers")
    tok = torch.tensor(golden["tokens"], dtype=torch.int32,
                       device="cuda")[:, :1]
    dec, _ = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)
    errs = {}
    for key, got in (("prefill_logits", logits), ("decode_logits", dec)):
        want = torch.tensor(golden[key], device="cuda")
        err = (got - want).abs()
        errs[key] = float(err.max())
        check(bool((err <= WKV_TOL + WKV_TOL * want.abs()).all()),
              f"reduced {key} differ from the golden by up to "
              f"{errs[key]} (rtol = atol = {WKV_TOL})")
    toks = factory.generate(model, cfg, prompts, max_new=golden["max_new"])
    check(toks.cpu().tolist() == golden["tokens"],
          f"reduced greedy tokens {toks.cpu().tolist()} differ from the "
          f"golden {golden['tokens']}")
    return {"errs": errs, "launches": launches, "cfg": cfg,
            "shape": tuple(prompts.shape), "new": golden["max_new"]}


def _prefill(model, tokens, cfg, max_len=0, frames=None):
    """factory.prefill of token prompts (and Whisper's frames)."""
    from repro_torch.models import factory
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    return factory.prefill(model, batch, cfg=cfg, max_len=max_len)


def _decode_after(torch, model, cfg, prompts, s, steps, noise=None,
                  frames=None):
    """Logits for prompts[:, :s] as a prefill of s - steps tokens (a KV
    cache sized for s) followed by `steps` decode steps.  noise: a
    generator that scales every wkv state of the prefill's cache by
    (1 + 2^-23 N(0, 1)), one f32 rounding of the state, before the
    steps."""
    from repro_torch.models import factory
    dec, cache = _prefill(model, prompts[:, :s - steps], cfg, s, frames)
    if noise is not None:
        for g in cache["groups"]:
            g["S"] = g["S"] * (1 + 2.0 ** -23 * torch.randn(
                g["S"].shape, generator=noise, device=g["S"].device))
    for i in range(s - steps, s):
        dec, cache = factory.decode(
            model, cache, {"tokens": prompts[:, i:i + 1]}, cfg=cfg)
    return dec


def _windows(torch, model, cfg, prompts, toks, max_len, frames=None):
    """Device time by kernel over a prefill (its KV cache sized for
    max_len), then over four decode steps."""
    from repro_torch.models import factory
    windows, state = {}, {}

    def prefill_window():
        state["cache"] = _prefill(model, prompts, cfg, max_len, frames)[1]

    def decode_window():
        cache, tok = state["cache"], toks[:, :1]
        for _ in range(4):
            _, cache = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)

    for name, fn in (("prefill", prefill_window), ("4 decode steps",
                                                    decode_window)):
        events, wall = profiled(torch, fn)
        by_name = {}
        for ev, us in events:
            by_name[ev] = by_name.get(ev, 0.0) + us
        windows[name] = {
            "wall": wall, "busy": sum(by_name.values()) / 1e6,
            "n": len(events),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
            "wkv6": sum(us for ev, us in by_name.items()
                        if "wkv6_kernel" in ev) / 1e6,
            # the functional cache: index_put's clone and the layer stack
            "copies": sum(us for ev, us in by_name.items()
                          if "Memcpy DtoD" in ev
                          or "CatArrayBatchedCopy" in ev) / 1e6}
    return windows


def rwkv_config():
    from repro_torch.configs import get_config
    return get_config(RWKV_ARCH)


def _spread(xs):
    """(median, min, max) of a list of readings."""
    return float(np.median(xs)), min(xs), max(xs)


def phase_rwkv_full(torch, W, K):
    """The RWKV-6 serving path at full width through factory.generate."""
    from repro_torch.models import factory
    from repro_torch.models.layers import rwkv6 as rwkv_layers

    cfg = rwkv_config()
    t0 = time.perf_counter()
    model = factory.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT),
                            generator=gen, dtype=torch.int32, device="cuda")
    # warm-up: cuBLAS handles, the caching allocator
    factory.generate(model, cfg, prompts, max_new=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read just after
    W.wkv6.launches = 0
    K.issue_select.launches = 0
    toks = factory.generate(model, cfg, prompts, max_new=RWKV_NEW)
    torch.cuda.synchronize()
    launches = W.wkv6.launches
    check(K.issue_select.launches == 0, "generate launched sm_issue")
    check(launches == cfg.n_layers, f"generate launched wkv6 {launches} "
          f"times; the prefill has {cfg.n_layers} layers")
    check(tuple(toks.shape) == (RWKV_BATCH, RWKV_NEW),
          f"generate returned {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generate returned tokens outside the vocabulary")

    # times: RWKV_REPEATS windows, each of a prefill, the decode steps that
    # generate takes after it (timed alone), and a whole generate
    times = {"prefill": [], "decode": [], "generate": []}
    for _ in range(RWKV_REPEATS):
        t0 = time.perf_counter()
        logits, cache = _prefill(model, prompts, cfg)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(RWKV_NEW - 1):
            step_logits, cache = factory.decode(model, cache,
                                                {"tokens": tok}, cfg=cfg)
            tok = torch.argmax(step_logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        times["decode"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        again = factory.generate(model, cfg, prompts, max_new=RWKV_NEW)
        torch.cuda.synchronize()
        times["generate"].append(time.perf_counter() - t0)
        check(torch.equal(again, toks), "generate is not deterministic")
        check(torch.equal(toks[:, -1:], tok), "generate's last token "
              "differs from the separately timed decode steps'")
    # decode inside generate: its wall less the prefill of the same window
    times["generate - prefill"] = [g - p for g, p in zip(
        times["generate"], times["prefill"])]
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(torch.equal(toks[:, 0], torch.argmax(logits, -1).int()),
          "generate's first token is not the prefill's argmax")

    # cache consistency: the kernel's prefill state against the plain
    # decode steps, within CONSISTENCY_TOL of the largest logit.  512 - 1
    # tokens do not split into chunks of 64, so the full prompt is checked
    # against 448 tokens plus 64 steps, and a one-chunk prompt of 64
    # against 63 tokens plus one step.  A prompt of 128 against 64 plus 64
    # steps is held to MODEL_F32_TOL, with its witnesses below.
    cons = []
    fulls = {}
    for s, steps, tol in ((RWKV_PROMPT, 64, CONSISTENCY_TOL),
                          (64, 1, CONSISTENCY_TOL),
                          (128, 64, MODEL_F32_TOL)):
        full = logits if s == RWKV_PROMPT else \
            _prefill(model, prompts[:, :s], cfg)[0]
        dec = _decode_after(torch, model, cfg, prompts, s, steps)
        fulls[s] = (full, dec)
        diff = float((full - dec).abs().max())
        scale = float(full.abs().max())
        cons.append((s, steps, diff, scale, tol))
        check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    # witnesses of the 64 + 64 case: the same run with every prefill's
    # recurrence routed through wkv6_plain in place of the kernel, and the
    # kernel's run with its 64-token state moved by one f32 rounding
    full_k, dec_k = fulls[128]
    scale = float(full_k.abs().max())
    rwkv_layers.wkv6 = W.wkv6_plain
    try:
        full_p = _prefill(model, prompts[:, :128], cfg)[0]
        dec_p = _decode_after(torch, model, cfg, prompts, 128, 64)
    finally:
        rwkv_layers.wkv6 = W.wkv6
    dec_n = _decode_after(torch, model, cfg, prompts, 128, 64,
                          noise=torch.Generator(device="cuda").manual_seed(2))

    def ratio(a, b):
        return float((a - b).abs().max()) / scale

    witness = {"plain prefill vs plain 64 + 64": ratio(full_p, dec_p),
               "kernel vs plain prefill of 128": ratio(full_k, full_p),
               "kernel vs plain 64-token prefill, then 64 steps":
                   ratio(dec_k, dec_p),
               "64 + 64 vs the same with its state moved by 2^-23":
                   ratio(dec_k, dec_n)}

    # where the time goes: a prefill, then four decode steps
    windows = _windows(torch, model, cfg, prompts, toks, 0)
    return {"cfg": cfg, "n_params": n_params, "init_s": init_s,
            "times": {k: _spread(v) for k, v in times.items()},
            "launches": launches, "peak": peak, "cons": cons,
            "witness": witness, "windows": windows,
            "sample": toks[0, :8].tolist()}


def flash_ptxas(log):
    """'dtype/hd: N registers, S bytes spill stores, L bytes spill loads'
    for each instance of the flash kernel in an ``nvcc -Xptxas -v`` log."""
    dtypes = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out = []
    for inst, regs, st, ld in ptxas_spills(
            log, r"flash_kernelI(f|13__nv_bfloat16)Li(\d+)E"):
        dtype, hd = inst.split("/")
        out.append(f"{dtypes[dtype]}/{hd}: {regs} registers, {st} bytes "
                   f"spill stores, {ld} bytes spill loads")
    return " | ".join(out)


def flash_bound(b, sq, sk, h, kv, hd, causal, elem=4):
    """(bound_ms, bound_by, bytes, operations, cuda_core_ms) of one
    attention: q, k, v read once and o written once, against the 4 hd
    operations (two multiply-adds) of each (query, key) pair it must
    score, those on or below the right-aligned diagonal when causal.  The
    kernel runs them on the tensor cores as three TF32 passes, so its
    operation bound is 3 x those at the TF32 rate; the same operations at
    the CUDA cores' f32 rate, the first form's bound, come last."""
    n_bytes = elem * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
    if causal:    # query i sees keys 0 .. Sk - Sq + i
        pairs = sq * (sk - sq + 1) + sq * (sq - 1) // 2
    else:
        pairs = sq * sk
    n_ops = 4 * hd * b * h * pairs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops,
            n_ops / ALU_OPS_PER_S * 1e3)


def flash_case(torch, gen, b, sq, sk, h, kv, hd, dtype):
    """Seeded N(0, 1) q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) on the
    card, rounded to dtype."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return draw(b, sq, h, hd), draw(b, sk, kv, hd), draw(b, sk, kv, hd)


def _err_over_tol(torch, got, want, tol):
    """(max abs err, worst |g - r| / (tol + tol |r|)), allclose's measure."""
    err = (got.double() - want.double()).abs()
    return (float(err.max()),
            float((err / (tol + tol * want.double().abs())).max()))


def phase_flash(torch, FA):
    """flash_attention against attention_plain on seeded cases, then timed
    at the full-width shape beside the plain version and SDPA."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    n_cases, max_err, worst = 0, 0.0, 0.0
    sizes = [(s, s) for s in (1, 63, 64, 512)] + [(100, 300)]
    for dname, tol in FLASH_TOLS.items():
        for hd in (16, 32, 64, 128):
            for sq, sk in sizes:
                for kv in (4, 1):          # groups of 1 and of 4 query heads
                    q, k, v = flash_case(torch, gen, 2, sq, sk, 4, kv, hd,
                                         getattr(torch, dname))
                    for causal in (True, False):
                        got = FA.flash_attention(q, k, v, causal=causal)
                        want = attention_plain(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        e, w = _err_over_tol(torch, got, want, tol)
                        max_err, worst = max(max_err, e), max(worst, w)
                        n_cases += 1
    # the shape the main path launches it at, and arctic-480b's (a GQA
    # group of 7 query heads): each against the plain version and f64,
    # timed beside the plain version and SDPA
    arctic = _flash_timed_case(torch, FA, gen, FLASH_ARCTIC_SHAPE)
    qwen_vl = _flash_timed_case(torch, FA, gen, FLASH_QWEN_VL_SHAPE)
    qwen_vl_tp = _flash_timed_case(torch, FA, gen, FLASH_QWEN_VL_TP_SHAPE)
    full = _flash_timed_case(torch, FA, gen, FLASH_FULL_SHAPE)
    # Whisper's (phases w and x): the encoder's self-attention over its
    # 1,500 frames and the decoder's cross attention, both non-causal;
    # then a reduced non-causal case with more queries than keys
    whisper = {name: _flash_timed_case(torch, FA, gen, shape, causal=False,
                                       sk=sk)
               for name, (shape, sk) in WHISPER_FLASH_CASES.items()}
    # the model-axis runs' shapes (phase z): qwen2-vl-2b's seqpar slabs,
    # causal over Sk keys, and whisper-base's on a model position
    seqpar = [_flash_timed_case(torch, FA, gen, FLASH_SEQPAR_SHAPE, sk=sk)
              for sk in FLASH_SEQPAR_SK]
    whisper_tp = {name: _flash_timed_case(torch, FA, gen, shape,
                                          causal=causal, sk=sk)
                  for name, (shape, sk, causal) in WHISPER_TP_CASES.items()}
    ep_tp = {arch: _flash_timed_case(torch, FA, gen, shape)
             for arch, shape in FLASH_EP_TP_SHAPES.items()}
    serve = {name: _flash_timed_case(torch, FA, gen, shape, sk=sk)
             for name, (shape, sk) in FLASH_SERVE_CASES.items()}
    b, sq, h, kv, hd, sk = FLASH_WIDE_CASE
    q, k, v = flash_case(torch, gen, b, sq, sk, h, kv, hd, torch.float32)
    wide = {"shape": list(FLASH_WIDE_CASE)}
    got = FA.flash_attention(q, k, v, causal=False)
    wide["max_abs_err"], wide["worst"] = _err_over_tol(
        torch, got, attention_plain(q, k, v, causal=False),
        FLASH_TOLS["float32"])
    wide["vs_f64"] = _err_over_tol(torch, got, attention_plain(
        q.double(), k.double(), v.double(), causal=False),
        FLASH_TOLS["float32"])
    try:
        FA.flash_attention(q, k, v, causal=True)
        wide["causal_refused"] = False
    except ValueError:
        wide["causal_refused"] = True
    for r in (arctic, qwen_vl, qwen_vl_tp, full, *whisper.values(), wide,
              *seqpar, *whisper_tp.values(), *ep_tp.values(),
              *serve.values()):
        max_err = max(max_err, r["max_abs_err"])
        worst = max(worst, r["worst"])
        n_cases += 1
    return {**full, "cases": n_cases, "max_abs_err": max_err,
            "worst": worst, "arctic": arctic, "qwen_vl": qwen_vl,
            "qwen_vl_tp": qwen_vl_tp,
            "whisper": whisper, "wide": wide, "seqpar": seqpar,
            "whisper_tp": whisper_tp, "ep_tp": ep_tp, "serve": serve}


def _flash_timed_case(torch, FA, gen, shape, causal=True, sk=None):
    """flash_attention at one f32 shape (B, Sq, H, KV, hd), over sk keys
    (Sq if None), against attention_plain and the same attention in f64;
    the kernel's time per launch (profiler), the plain version's, and the
    wrapper's in turns with SDPA on the repeated KV heads (events: kernel,
    SDPA, SDPA, kernel); the bound."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    b, s, h, kv, hd = shape
    sk = s if sk is None else sk
    q, k, v = flash_case(torch, gen, b, s, sk, h, kv, hd, torch.float32)
    got = FA.flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    truth = attention_plain(q.double(), k.double(), v.double(),
                            causal=causal)
    torch.cuda.synchronize()
    e, w = _err_over_tol(torch, got, want, FLASH_TOLS["float32"])
    vs_f64 = {name: _err_over_tol(torch, out, truth, FLASH_TOLS["float32"])
              for name, out in (("flash_attention", got),
                                ("attention_plain", want))}
    del truth
    plain_ms = time_per_call(
        torch, lambda: attention_plain(q, k, v, causal=causal), 5)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(h // kv, 2).transpose(1, 2).contiguous()
              for x in (k, v))
    # SDPA's is_causal aligns the mask top-left; K3''s (and the slabs' of
    # seqpar_attention) is right-aligned, so Sq < Sk takes it as a mask
    mask = (None if not causal or s == sk else
            torch.arange(s, device=q.device)[:, None] + (sk - s)
            >= torch.arange(sk, device=q.device)[None, :])

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask,
            is_causal=causal and mask is None)

    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        fn = ((lambda: FA.flash_attention(q, k, v, causal=causal))
              if who == "kernel" else sdpa)
        turns[who].append(time_per_call(torch, fn, 20))
    wrapper_ms = sum(turns["kernel"]) / 2
    library_err = float((sdpa().transpose(1, 2) - want).abs().max())

    def launches():
        for _ in range(10):
            FA.flash_attention(q, k, v, causal=causal)
    kern = kernel_us(torch, launches, "flash_kernel")
    bound_ms, bound_by, n_bytes, n_ops, cuda_core_ms = flash_bound(
        b, s, sk, h, kv, hd, causal)
    return {"shape": list(shape), "sk": sk, "causal": causal,
            "max_abs_err": e, "worst": w,
            "vs_f64": vs_f64, "device_timed": bool(kern),
            "ms": sum(kern) / len(kern) / 1e3 if kern else wrapper_ms,
            "wrapper_ms": wrapper_ms, "turns": turns, "plain_ms": plain_ms,
            "library_ms": sum(turns["sdpa"]) / 2, "library_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
            "ops": n_ops, "cuda_core_ms": cuda_core_ms}


def grad_err(torch, got, want):
    """(max abs err, worst max |g - w| / max |w|) over pairs of
    gradients."""
    err = worst = 0.0
    for g, w in zip(got, want):
        d = float((g.double() - w.double()).abs().max())
        err = max(err, d)
        worst = max(worst, d / max(float(w.double().abs().max()), 1e-30))
    return err, worst


def wkv_bwd_bound(b, s, h, hs):
    """(bound_ms, bound_by, bytes, operations, cuda_core_ms) of one wkv
    backward: r, k, v, w, do, u and the initial state read once, dr, dk,
    dv, dw and du written once, against WKV_BWD_OPS_PER_ELEMENT operations
    per token and state element, at the rate of three TF32 passes on the
    tensor cores (the least time f32-exact products could take, as
    flash_bound counts); the CUDA cores' f32 time last."""
    n_bytes = 4 * (9 * b * s * h * hs + 2 * h * hs + b * h * hs * hs)
    n_ops = WKV_BWD_OPS_PER_ELEMENT * b * s * h * hs * hs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops,
            n_ops / ALU_OPS_PER_S * 1e3)


def flash_bwd_bound(b, sq, sk, h, kv, hd, causal, elem=4):
    """(bound_ms, bound_by, bytes, operations, cuda_core_ms) of one
    attention backward: q, k, v, o, do read once and dq, dk, dv written
    once at ``elem`` bytes an element, the rows' log-sum-exp (f32) read
    once, against the 10 hd operations (five multiply-adds of hd: the
    scores, dP, dV, dK, dQ) of each (query, key) pair, counted as
    flash_bound counts the forward's: in three TF32 passes for f32, one
    pass at the bf16 rate for bf16."""
    n_bytes = elem * (4 * b * sq * h * hd + 4 * b * sk * kv * hd) \
        + 4 * b * h * sq
    _, _, _, fwd_ops, _ = flash_bound(b, sq, sk, h, kv, hd, causal)
    n_ops = fwd_ops // 4 * 10
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (TF32_PASSES * n_ops / TF32_OPS_PER_S if elem == 4
              else n_ops / BF16_OPS_PER_S) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops,
            n_ops / ALU_OPS_PER_S * 1e3)


def flash_bwd_cases():
    """(B, Sq, Sk, H, KV, hd) where phase k holds flash_attention_bwd, in
    f32 and in bf16: GQA 32/8-like groups and MHA, hd 16 to 128, ragged
    tiles (Sq = Sk = 100: the ragged key block 64-99 sits on the causal
    diagonal), the full shape, the model-axis runs' (qwen2-vl-2b's seqpar
    slabs, Sq 128 under Sk 128 ... 1,024, causal right-aligned; the (2, 2)
    model positions' of whisper-base, arctic-480b and jamba-v0.1-52b),
    Whisper's encoder shape (non-causal, 1,500 frames) and a non-causal
    case with more queries than keys (causal refuses it, F4)."""
    b_, s_, h_, kv_, hd_ = FLASH_FULL_SHAPE
    (eb, es, eh, ekv, ehd), _ = WHISPER_FLASH_CASES["encoder"]
    wb, wsq, wh, wkv, whd, wsk = FLASH_WIDE_CASE
    qb, qs, qh, qkv, qhd = FLASH_QWEN_VL_SHAPE
    tb, ts, th, tkv, thd = FLASH_QWEN_VL_TP_SHAPE
    sb, ss, sh_, skv_, shd_ = FLASH_SEQPAR_SHAPE
    cases = [(sb, ss, sk, sh_, skv_, shd_) for sk in (128, 640, 1024)]
    cases += [(shape[0], shape[1], sk, *shape[2:])
              for shape, sk, _ in WHISPER_TP_CASES.values()]
    cases += [(b, s, s, h, kv, hd) for b, s, h, kv, hd in
              FLASH_EP_TP_SHAPES.values()]
    cases += [(qb, qs, qs, qh, qkv, qhd), (tb, ts, ts, th, tkv, thd),
              (2, 128, 128, 8, 2, 64), (2, 128, 128, 8, 8, 128),
              (2, 100, 100, 4, 1, 64), (1, 70, 130, 4, 4, 128),
              (1, 100, 100, 4, 2, 128), (1, 33, 72, 2, 1, 16),
              (2, 47, 47, 4, 4, 32), (b_, s_, s_, h_, kv_, hd_),
              (eb, es, es, eh, ekv, ehd), (wb, wsq, wsk, wh, wkv, whd)]
    return cases


def phase_backward(torch, W, FA):
    """The backward kernels against their plain versions on seeded cases:
    wkv6_bwd against autograd of wkv6_plain in f64 (chunks of 1 under
    strong decay, ROADMAP F5), flash_attention_bwd against
    attention_backward_plain in f64; then each timed at the main path's
    full-width shape beside its plain version (and, for attention,
    autograd's backward of SDPA with enable_gqa, the library yardstick)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_plain)
    rng = np.random.default_rng(20261020)
    gen = torch.Generator(device="cuda").manual_seed(20261020)
    out = {"wkv_cases": 0, "wkv_err": 0.0, "wkv_worst": 0.0,
           "flash_cases": 0, "flash_err": 0.0, "flash_worst": 0.0}
    # wkv6_bwd: hs 16/32/64 x S 64 (a multiple of 32) and 100 (not), with
    # and without a final-state adjoint; strong decay; the full shape
    wkv_cases = [(2, s, 4, hs, "random", s == 100)
                 for hs in (16, 32, 64) for s in (64, 100)]
    wkv_cases += [(2, 100, 4, 64, "strong", True),
                  (2, 37, 4, 32, "strong", False),
                  (2, 64, 4, 16, "weak", True),
                  (*WKV_TP_SHAPE, "random", False),
                  (*WKV_FULL_SHAPE, "random", False)]
    for b, s, h, hs, decay, with_ds in wkv_cases:
        args = wkv_case(rng, torch, b, s, h, hs, True, decay)
        do = torch.randn((b, s, h, hs), generator=gen, device="cuda")
        ds = (torch.randn((b, h, hs, hs), generator=gen, device="cuda")
              if with_ds else None)
        got = W.wkv6_bwd(*args, do, ds)
        ins = [a.double().requires_grad_() for a in args[:5]]
        chunk = 1 if decay == "strong" else min(s, 64) if s % 64 == 0 else s
        o, st = W.wkv6_plain(*ins, args[5].double(), chunk=chunk)
        want = torch.autograd.grad(
            (o, st) if with_ds else (o,), ins,
            (do.double(), ds.double()) if with_ds else (do.double(),))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"wkv6_bwd at {(b, s, h, hs)}: gradients not finite")
        e, w = grad_err(torch, got, want)
        out["wkv_err"], out["wkv_worst"] = (max(out["wkv_err"], e),
                                            max(out["wkv_worst"], w))
        out["wkv_cases"] += 1
        del ins, o, st, want
    check(out["wkv_worst"] <= BWD_TOL, f"wkv6_bwd disagrees with autograd "
          f"of wkv6_plain in f64: worst {out['wkv_worst']} of the largest "
          f"magnitude (max abs err {out['wkv_err']})")
    # timed at the full shape: device time by the profiler, beside the
    # plain backward in f32 (the stepwise formulas, plain); two calls on the
    # same inputs give the same bits
    b, s, h, hs = WKV_FULL_SHAPE
    args = wkv_case(rng, torch, b, s, h, hs, True)
    do = torch.randn((b, s, h, hs), generator=gen, device="cuda")
    ds = torch.randn((b, h, hs, hs), generator=gen, device="cuda")
    first, again = (W.wkv6_bwd(*args, do, ds) for _ in range(2))
    out["wkv_same_bits"] = all(torch.equal(x, y) for x, y in zip(first, again))
    del first, again, ds

    def wkv_launches():
        for _ in range(10):
            W.wkv6_bwd(*args, do)
    kern = kernel_us(torch, wkv_launches, "wkv6_bwd_kernel")
    wrapper_ms = time_per_call(torch, lambda: W.wkv6_bwd(*args, do), 10)
    out["wkv_ms"] = sum(kern) / len(kern) / 1e3 if kern else wrapper_ms
    out["wkv_timed"] = bool(kern)
    out["wkv_wrapper_ms"] = wrapper_ms
    t0 = time.perf_counter()
    W.wkv6_backward_plain(*args, do)
    torch.cuda.synchronize()
    out["wkv_plain_ms"] = (time.perf_counter() - t0) * 1e3
    (out["wkv_bound_ms"], out["wkv_bound_by"], out["wkv_bytes"],
     out["wkv_ops"], out["wkv_cuda_core_ms"]) = wkv_bwd_bound(b, s, h, hs)
    del args, do

    # flash_attention_bwd on flash_bwd_cases()
    b_, s_, h_, kv_, hd_ = FLASH_FULL_SHAPE
    (eb, es, eh, ekv, ehd), _ = WHISPER_FLASH_CASES["encoder"]
    for b, sq, sk, h, kv, hd in flash_bwd_cases():
        q, k, v = flash_case(torch, gen, b, sq, sk, h, kv, hd, torch.float32)
        do = torch.randn((b, sq, h, hd), generator=gen, device="cuda")
        for causal in (False,) if sq > sk else (True, False):
            o, lse = FA._flash_kernel(q, k, v, causal, with_lse=True)
            got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            want = attention_backward_plain(q.double(), k.double(),
                                            v.double(), do.double(),
                                            causal=causal)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"flash_attention_bwd at {(b, sq, sk, h, kv, hd)}: "
                  "gradients not finite")
            e, w = grad_err(torch, got, want)
            out["flash_err"] = max(out["flash_err"], e)
            out["flash_worst"] = max(out["flash_worst"], w)
            out["flash_cases"] += 1
            del want
    check(out["flash_worst"] <= BWD_TOL, f"flash_attention_bwd disagrees "
          f"with attention_backward_plain in f64: worst "
          f"{out['flash_worst']} of the largest magnitude (max abs err "
          f"{out['flash_err']})")
    # timed at the full shape, causal: the two kernels of a call by the
    # profiler, each on its own; the plain backward; autograd's backward of
    # SDPA (GQA); two calls on the same inputs give the same bits
    q, k, v = flash_case(torch, gen, b_, s_, s_, h_, kv_, hd_, torch.float32)
    do = torch.randn((b_, s_, h_, hd_), generator=gen, device="cuda")
    o, lse = FA._flash_kernel(q, k, v, True, with_lse=True)
    first, again = (FA.flash_attention_bwd(q, k, v, o, lse, do)
                    for _ in range(2))
    out["flash_same_bits"] = all(torch.equal(x, y)
                                 for x, y in zip(first, again))
    del first, again

    def flash_launches():
        for _ in range(10):
            FA.flash_attention_bwd(q, k, v, o, lse, do)
    kern = {}
    for _ in range(3):
        events, _ = profiled(torch, flash_launches)
        for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
            kern[name] = [us for ev, us in events if name in ev]
        if all(kern.values()):
            break
    wrapper_ms = time_per_call(
        torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do), 10)
    timed = all(kern.values())
    out["flash_parts_ms"] = {n: sum(us) / len(us) / 1e3 if us else None
                             for n, us in kern.items()}
    out["flash_ms"] = (sum(out["flash_parts_ms"].values()) if timed
                       else wrapper_ms)
    out["flash_timed"] = timed
    out["flash_wrapper_ms"] = wrapper_ms
    out["flash_plain_ms"] = time_per_call(
        torch, lambda: attention_backward_plain(q, k, v, do), 3)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    out["library_ms"] = time_per_call(
        torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                           retain_graph=True), 10)
    lib = torch.autograd.grad(sdpa, (qt, kt, vt), dot)
    mine = FA.flash_attention_bwd(q, k, v, o, lse, do)
    out["library_err"] = grad_err(
        torch, [x.transpose(1, 2) for x in lib], mine)[0]
    (out["flash_bound_ms"], out["flash_bound_by"], out["flash_bytes"],
     out["flash_ops"], out["flash_cuda_core_ms"]) = flash_bwd_bound(
        b_, s_, s_, h_, kv_, hd_, True)
    # Whisper's encoder shape, non-causal: the same bits twice, the time
    # of a call (profiler), its bound
    del q, k, v, do, o, lse, sdpa, lib, mine, qt, kt, vt, dot
    q, k, v = flash_case(torch, gen, eb, es, es, eh, ekv, ehd, torch.float32)
    do = torch.randn((eb, es, eh, ehd), generator=gen, device="cuda")
    o, lse = FA._flash_kernel(q, k, v, False, with_lse=True)
    first, again = (FA.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=False) for _ in range(2))
    enc = {"same_bits": all(torch.equal(x, y) for x, y in zip(first,
                                                              again))}
    del first, again

    def enc_launches():
        for _ in range(10):
            FA.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    parts = kernel_us(torch, enc_launches, "flash_bwd")
    enc["ms"] = (sum(parts) / 10 / 1e3 if parts else time_per_call(
        torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=False), 10))
    enc["timed"] = bool(parts)
    enc["bound_ms"], enc["bound_by"], *_ = flash_bwd_bound(
        eb, es, es, eh, ekv, ehd, False)
    out["flash_encoder"] = enc
    del q, k, v, do, o, lse
    out["ep_tp"] = {arch: _flash_bwd_timed(torch, FA, gen, shape)
                    for arch, shape in FLASH_EP_TP_SHAPES.items()}
    return out


def _flash_bwd_timed(torch, FA, gen, shape):
    """flash_attention_bwd at one causal f32 shape (B, S, H, KV, hd): its
    two kernels' time per call (profiler), autograd's backward of SDPA
    (enable_gqa) on the same inputs, the bound, and whether two calls give
    the same bits."""
    b, s, h, kv, hd = shape
    q, k, v = flash_case(torch, gen, b, s, s, h, kv, hd, torch.float32)
    do = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    o, lse = FA._flash_kernel(q, k, v, True, with_lse=True)
    first, again = (FA.flash_attention_bwd(q, k, v, o, lse, do)
                    for _ in range(2))
    r = {"shape": list(shape),
         "same_bits": all(torch.equal(x, y) for x, y in zip(first, again))}
    del first, again

    def launches():
        for _ in range(10):
            FA.flash_attention_bwd(q, k, v, o, lse, do)
    parts = kernel_us(torch, launches, "flash_bwd")
    r["timed"] = bool(parts)
    r["ms"] = (sum(parts) / 10 / 1e3 if parts else time_per_call(
        torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do), 10))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    r["library_ms"] = time_per_call(
        torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                           retain_graph=True), 10)
    r["bound_ms"], r["bound_by"], *_ = flash_bwd_bound(b, s, s, h, kv, hd,
                                                       True)
    return r


def sdpa_grads(torch, q, k, v, do, causal):
    """Autograd's backward of torch's scaled_dot_product_attention
    (enable_gqa; the causal mask right-aligned as the kernels', by a
    boolean mask where Sq < Sk) on the port's layout, in the inputs'
    dtype: ((dq, dk, dv), a function that runs the backward again)."""
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None
    if causal and sq != sk:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    dot = do.transpose(1, 2)

    def again():
        return torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
    return [g.transpose(1, 2) for g in again()], again


def device_ms(torch, fn, name=None, n=10):
    """Device time per call in ms of ``fn`` run ``n`` times under the
    profiler: the kernels whose name holds ``name``, or every device
    activity; None where no window caught any (up to three tried)."""
    def calls():
        for _ in range(n):
            fn()
    for _ in range(3):
        events, _ = profiled(torch, calls)
        us = [t for ev, t in events if name is None or name in ev]
        if us:
            return sum(us) / n / 1e3
    return None


def phase_backward_bf16(torch, FA):
    """flash_attention_bwd's bf16 form at every shape of
    flash_bwd_cases(), causal and not (non-causal only where Sq > Sk):
    each gradient bf16, finite, within FLASH_TOLS["bfloat16"] of its
    largest magnitude from attention_backward_plain in f64 on the same
    bf16 inputs, and no farther from it than BF16_WITNESS times
    autograd's backward of SDPA (enable_gqa) in bf16 on those inputs; a
    second call the same bits.  Then timed (profiler) at phase k's timed
    shapes beside SDPA's bf16 backward (its device time) and the plain
    version: the full shape (its two kernels each), Whisper's encoder,
    arctic-480b's and jamba-v0.1-52b's (2, 2) model-position shapes.
    SDPA is timed by CUDA events, as phase k times it in f32, and its
    device time by the profiler beside: inside the smoke's long process
    the profiler's sum of its device activities has read below the
    shape's bound (PERF.md §6)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_plain)
    gen = torch.Generator(device="cuda").manual_seed(20261031)
    out = {"cases": 0, "err": 0.0, "worst": 0.0, "lib_worst": 0.0,
           "ratio": 0.0, "bad": []}
    tol = FLASH_TOLS["bfloat16"]
    for b, sq, sk, h, kv, hd in flash_bwd_cases():
        q, k, v = flash_case(torch, gen, b, sq, sk, h, kv, hd,
                             torch.bfloat16)
        do = torch.randn((b, sq, h, hd), generator=gen,
                         device="cuda").bfloat16()
        for causal in (False,) if sq > sk else (True, False):
            o, lse = FA._flash_kernel(q, k, v, causal, with_lse=True)
            got, again = (FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal)
                          for _ in range(2))
            want = attention_backward_plain(q.double(), k.double(),
                                            v.double(), do.double(),
                                            causal=causal)
            lib, _ = sdpa_grads(torch, q, k, v, do, causal)
            torch.cuda.synchronize()
            fine = all(g.dtype == torch.bfloat16
                       and bool(torch.isfinite(g).all()) for g in got)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            e, w = grad_err(torch, got, want)
            lw = grad_err(torch, lib, want)[1]
            out["err"], out["worst"] = max(out["err"], e), max(out["worst"],
                                                               w)
            out["lib_worst"] = max(out["lib_worst"], lw)
            out["ratio"] = max(out["ratio"], w / max(lw, 1e-30))
            out["cases"] += 1
            if not (fine and same and w <= tol and w <= BF16_WITNESS * lw):
                out["bad"].append({"shape": (b, sq, sk, h, kv, hd),
                                   "causal": causal, "finite_bf16": fine,
                                   "same_bits": same, "worst": w,
                                   "sdpa_worst": lw})
            del got, again, want, lib, o, lse
        del q, k, v, do
    timed = {"full": (FLASH_FULL_SHAPE, FLASH_FULL_SHAPE[1], True),
             "whisper encoder": (WHISPER_FLASH_CASES["encoder"][0],
                                 WHISPER_FLASH_CASES["encoder"][1], False)}
    timed.update({f"{arch} (2, 2)": (shape, shape[1], True)
                  for arch, shape in FLASH_EP_TP_SHAPES.items()})
    out["timed"] = {}
    for name, (shape, sk, causal) in timed.items():
        b, sq, h, kv, hd = shape
        q, k, v = flash_case(torch, gen, b, sq, sk, h, kv, hd,
                             torch.bfloat16)
        do = torch.randn((b, sq, h, hd), generator=gen,
                         device="cuda").bfloat16()
        o, lse = FA._flash_kernel(q, k, v, causal, with_lse=True)

        def call():
            FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        lib = sdpa_grads(torch, q, k, v, do, causal)[1]
        r = {"shape": list(shape), "sk": sk, "causal": causal,
             "ms": device_ms(torch, call, "flash_bwd"),
             "wrapper_ms": time_per_call(torch, call, 10),
             "library_ms": time_per_call(torch, lib, 10),
             "library_profiler_ms": device_ms(torch, lib),
             "plain_ms": time_per_call(torch, lambda: attention_backward_plain(
                 q, k, v, do, causal=causal), 3)}
        # where no profiler window caught a launch: CUDA events per call
        r["timed"] = r["ms"] is not None
        if r["ms"] is None:
            r["ms"] = r["wrapper_ms"]
        if name == "full":
            r["parts_ms"] = {part: device_ms(torch, call, part)
                             for part in ("flash_bwd_dq", "flash_bwd_dkdv")}
        (r["bound_ms"], r["bound_by"], r["bytes"], r["ops"],
         _) = flash_bwd_bound(b, sq, sk, h, kv, hd, causal, elem=2)
        out["timed"][name] = r
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def launch_dtypes(FA, tally):
    """Tally every K3' and flash_attention_bwd launch while the block runs
    by the dtype it hands the kernel (tally[kind, dtype], kind "fwd" or
    "bwd", dtype "f32" or "bf16"), by wrapping the launchers' C
    functions."""
    real = {"fwd": FA._launcher, "bwd": FA._bwd_launcher}
    at = {"fwd": 12, "bwd": 17}          # the dtype argument's position

    def spy(kind):
        fn, info = real[kind]()

        def launch(*args):
            tally[kind, "bf16" if args[at[kind]] else "f32"] += 1
            return fn(*args)
        return launch, info
    FA._launcher = lambda: spy("fwd")
    FA._bwd_launcher = lambda: spy("bwd")
    try:
        yield tally
    finally:
        FA._launcher, FA._bwd_launcher = real["fwd"], real["bwd"]


def cast_batch(batch, dtype):
    """A batch with its float leaves (embeds, frames) in ``dtype``; as it
    is for None."""
    if dtype is None:
        return batch
    return {k: x.to(dtype) if x.is_floating_point() else x
            for k, x in batch.items()}


def step_grads(torch, FA, state, batch, cfg, ctx=None, attention=None):
    """(loss, grad_norm, {name: whole gradient on the mesh's first device
    or the model's}) of a train state on ``batch`` under deterministic
    kernels: what a train step reads before its update (on a mesh its
    gradient blocks put together); the attention layers' flash_attention
    rebound to ``attention`` if given, as phase h swaps it."""
    from repro_torch.models.layers import attention as attn_layers
    from repro_torch.parallelism import sharding
    from repro_torch.parallelism.ctx import NULL_CTX
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import global_norm
    if attention is not None:
        attn_layers.flash_attention = attention
    try:
        with TS.deterministic(batch["labels"].device):
            metrics, grads = TS._step_grads(state, batch, cfg,
                                            ctx or NULL_CTX)
    finally:
        attn_layers.flash_attention = FA.flash_attention
    if ctx is not None:
        home = ctx.mesh.devices.flat[0]
        whole = {}
        for name, blocks in grads.items():
            g0 = next(iter(blocks.values()))
            w = torch.empty(state["placed"][name].shape, dtype=g0.dtype,
                            device=home)
            for blk, g in blocks.items():
                w[sharding.index_of(blk)] = g.to(home)
            whole[name] = w
        grads = whole
    return (metrics["loss"].detach().item(), global_norm(grads).item(), grads)


def leaf_distances(got, want):
    """(worst, median) over leaves of max |g - w| / max |w|, as the CPU
    tests read a gradient (tests/test_torch_bf16_train.py)."""
    d = [float((got[n].float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30))
         for n, w in want.items()]
    return max(d), float(np.median(d))


def witnessed(got, ref, truth):
    """The witness rule: |got - truth| within BF16_WITNESS times |ref -
    truth|."""
    return abs(got - truth) <= BF16_WITNESS * abs(ref - truth)


def phase_train_bf16(torch, FA):
    """BF16_TRAIN_ARCH whole in bf16 (parameters and batch; f32 moments)
    through make_train_step, unsharded, at SHARD_BATCH x SHARD_SEQ.  On
    the first batch, before any step: the loss, grad_norm and gradients
    with the same weights in f32 and the kernels in f32 (the truth), in
    bf16 with attention_plain (the witness) and in bf16 with the kernels,
    each leaf's distance from the truth (``leaf_distances``).  Then
    TRAIN_STEPS steps with their walls, metrics, the kernels' launches
    per step and every launch's dtype."""
    import collections

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(BF16_TRAIN_ARCH)
    dev = torch.device("cuda")
    opt_cfg = OptConfig(**TRAIN_OPT)
    shape = ShapeSpec("x", SHARD_SEQ, SHARD_BATCH, "train")
    t0 = time.perf_counter()
    state = TS.init_train_state(0, cfg, opt_cfg, torch.bfloat16, device=dev)
    model = state["params"]
    torch.cuda.synchronize()
    out = {"cfg": cfg, "init_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in model.parameters()),
           "dtypes": sorted({str(p.dtype).replace("torch.", "")
                             for p in model.parameters()}),
           "moments": sorted({str(m.dtype).replace("torch.", "")
                              for m in state["opt"]["m"].values()})}
    batch = cast_batch(to_device(make_batch_np(cfg, shape, TRAIN_DATA_SEED,
                                               0), dev), torch.bfloat16)
    f32 = {"params": factory.from_state_dict(cfg, {
        n: t.detach().float() for n, t in model.state_dict().items()
    }).requires_grad_(True)}
    *out["f32"], truth = step_grads(torch, FA, f32, cast_batch(
        batch, torch.float32), cfg)
    del f32
    for key, attention in (("plain", attention_plain), ("kernels", None)):
        *out[key], g = step_grads(torch, FA, state, batch, cfg,
                                  attention=attention)
        out[key].append(leaf_distances(g, truth))
        del g
    del truth, batch
    torch.cuda.empty_cache()
    step_fn = TS.make_train_step(cfg, opt_cfg)
    tally = collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    with launch_dtypes(FA, tally):
        out["rows"] = train_steps(torch, step_fn, state, cfg, shape, dev,
                                  FA.flash_attention, FA.flash_attention_bwd,
                                  0, TRAIN_STEPS, dtype=torch.bfloat16)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["tally"] = dict(tally)
    del state, model, step_fn
    torch.cuda.empty_cache()
    return out


def phase_shard_bf16(torch, FA):
    """SHARD_ARCH at SHARD_SEQPAR's mesh, batch, sequence and depth, from
    the same weights (drawn in bf16, constants jittered) and the first
    batch: the loss, grad_norm and gradients of the step in f32
    unsharded (the truth), in bf16 unsharded (the witness) and in bf16 on
    the mesh (seqpar_attention in every layer: K3' and its backward on
    each slab), each leaf's distance from the truth; then one step of
    each bf16 run with its metrics, the kernels' launches and every
    launch's dtype."""
    import collections
    import dataclasses
    import gc

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    mesh, batch, seq, layers = SHARD_SEQPAR
    cfg = dataclasses.replace(get_config(SHARD_ARCH), n_layers=layers)
    dev = torch.device("cuda:0")
    opt_cfg = OptConfig(**TRAIN_OPT)
    shape = ShapeSpec("z", seq, batch, "train")
    model = factory.init_params(0, cfg, torch.bfloat16, device=dev)
    jitter_constants(torch, model, 1)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    del model
    first = to_device(make_batch_np(cfg, shape, TRAIN_DATA_SEED, 0), dev)
    ctx = make_ctx(make_train_mesh(mesh, devices=[dev] * int(np.prod(mesh))))
    out = {"cfg": cfg, "mesh": mesh, "batch": batch, "seq": seq,
           "calls": kernel_calls(cfg, mesh, seq),
           "calls_unsharded": kernel_calls(cfg, None, seq), "runs": {}}
    truth = None
    for name, dtype, c in (("f32", torch.float32, None),
                           ("unsharded", torch.bfloat16, None),
                           ("sharded", torch.bfloat16, ctx)):
        kw = {} if c is None else {"ctx": c}
        m = factory.from_state_dict(cfg, {n: t.to(dtype, copy=True)
                                          for n, t in init.items()})
        state = TS.init_train_state(m, cfg, opt_cfg, **kw)
        loss, norm, g = step_grads(torch, FA, state,
                                   cast_batch(first, dtype), cfg, c)
        run = {"first": (loss, norm)}
        if truth is None:
            truth = g
        else:
            run["leaves"] = leaf_distances(g, truth)
        del g
        if dtype == torch.bfloat16:
            step_fn = TS.make_train_step(cfg, opt_cfg, **kw)
            tally = collections.Counter()
            with launch_dtypes(FA, tally):
                row, = train_steps(torch, step_fn, state, cfg, shape, dev,
                                   FA.flash_attention,
                                   FA.flash_attention_bwd, 0, 1, dtype=dtype)
            run.update(row, tally=dict(tally))
            del step_fn
        out["runs"][name] = run
        del m, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def digest(torch, t, chunk=1 << 26):
    """An exact-match digest of a tensor's bits, computed on its device:
    the sums mod 2^64 of its 32-bit words as int64, plain and weighted by
    a hash of their position, chunk by chunk."""
    flat = t.detach().reshape(-1).view(torch.int32)
    s1 = s2 = 0
    for i in range(0, flat.numel(), chunk):
        part = flat[i:i + chunk].to(torch.int64)
        pos = torch.arange(i, i + part.numel(), device=part.device,
                           dtype=torch.int64)
        s1 += int(part.sum())
        s2 += int((part * (pos * 2654435761 % 4294967311 + 1)).sum())
    return s1 % 2**64, s2 % 2**64


def _state_tensors(state):
    """((kind, name), tensor) of a (plain) train state, kind "p" for a
    parameter, "m" or "v" for a moment, without copies."""
    for n, t in state["params"].state_dict().items():
        yield ("p", n), t.detach()
    for k in ("m", "v"):
        for n, t in state["opt"][k].items():
            yield (k, n), t


def _snapshot(state):
    """A host copy of a train state's tensors, keyed by kind and name."""
    return {key: t.cpu() for key, t in _state_tensors(state)}


def _same_as(torch, state, snap) -> list:
    """The keys of a snapshot whose tensors differ from the state's."""
    return [f"{k}:{n}" for (k, n), t in _state_tensors(state)
            if not torch.equal(t.cpu(), snap[k, n])]


def _grad_distance(got, want):
    """(norm of the difference over the gradient's norm, worst leaf's max
    |g - w| / max |w|, that leaf) of two {name: gradient} trees."""
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        d = got[name].double() - w.double()
        num += float((d * d).sum())
        den += float((w.double() ** 2).sum())
        r = float(d.abs().max()) / max(float(w.abs().max()), 1e-30)
        if r > worst:
            worst, worst_name = r, name
    return (num / max(den, 1e-300)) ** 0.5, worst, worst_name


def wkv_call_errors(torch, W, calls):
    """Each wkv6 call's gradients, as WKV6Function handed them to
    autograd, against autograd of wkv6_plain in f64 on that call's inputs
    and output gradients: the worst max |g - w| / max |w| of a call."""
    errs = []
    for c in calls:
        x = [t.double().requires_grad_(i < 5) for i, t in enumerate(c["x"])]
        o, s = W.wkv6_plain(*x, chunk=64)
        outs, gouts = [o], [c["go"][0].double()]
        if c["go"][1] is not None:
            outs.append(s)
            gouts.append(c["go"][1].double())
        want = torch.autograd.grad(outs, x[:5], gouts)
        errs.append(grad_err(torch, c["gi"][:5], want)[1])
    return errs


def model_grads(torch, W, FA, model, cfg, batch, per_call=False):
    """The whole model's gradients on ``batch`` with the kernels, and with
    the mixer's plain versions in f32, against the same model with the
    plain versions in f64 (``_grad_distance`` each), the mixer swapped by
    rebinding the layer module's name as phase h does; for RWKV also the
    plain form in f32 at chunk 1, the stepwise recurrence, which has no
    rounding of the chunked form's (ROADMAP F5).  With ``per_call``,
    every wkv6 call of the kernels' run is held by ``wkv_call_errors``."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.models.layers import attention as attn_layers
    from repro_torch.models.layers import rwkv6 as rwkv_layers
    from repro_torch.train import train_step as TS

    rwkv = cfg.family == "ssm"
    dev = batch["labels"].device
    calls = []

    def wkv_f64(*a, chunk=64):
        return tuple(x.float() for x in W.wkv6_plain(
            *(t.double() for t in a), chunk=chunk))

    def wkv_stepwise(*a, chunk=64):
        return W.wkv6_plain(*a, chunk=1)

    def attention_f64(q, k, v, *, causal=True):
        return attention_plain(q.double(), k.double(), v.double(),
                               causal=causal).float()

    def wkv_spy(r, k, v, wlog, u, state, *, chunk=64):
        """The kernel, with the call's inputs kept and a hook on its
        autograd node that keeps the gradients it was given and gave.
        The recompute's calls keep their inputs too; only the first
        forward's node is ever run by the backward."""
        o, s = W.wkv6(r, k, v, wlog, u, state, chunk=chunk)
        if o.grad_fn is not None:
            c = {"x": [t.detach().clone() for t in (r, k, v, wlog, u,
                                                      state)]}
            calls.append(c)

            def keep(gi, go):
                c["gi"] = [None if g is None else g.detach().clone()
                           for g in gi]
                c["go"] = [None if g is None else g.detach().clone()
                           for g in go]
            o.grad_fn.register_hook(keep)
        return o, s

    def grads_with(mixer):
        if rwkv:
            rwkv_layers.wkv6 = mixer
        else:
            attn_layers.flash_attention = mixer
        try:
            with TS.deterministic(dev):
                return TS._grads(model, batch, cfg)
        finally:
            rwkv_layers.wkv6 = W.wkv6
            attn_layers.flash_attention = FA.flash_attention

    out = {}
    loss_w, _, g_w = grads_with(wkv_f64 if rwkv else attention_f64)
    witnesses = [("plain", W.wkv6_plain if rwkv else attention_plain)]
    if rwkv:
        witnesses.append(("stepwise", wkv_stepwise))
    for key, mixer in witnesses:
        _, _, g = grads_with(mixer)
        out[key] = _grad_distance(g, g_w)
        del g
    loss_k, _, g = grads_with(wkv_spy if per_call else
                              W.wkv6 if rwkv else FA.flash_attention)
    out["kernel"] = _grad_distance(g, g_w)
    out["loss"] = (loss_k.item(), loss_w.item())
    by_layer = {}
    for name, x in g_w.items():
        parts = name.split(".")
        # a layer of the groups (or of Whisper's decoder) by its index
        key = (parts[2] if parts[0] == "groups" else
               parts[1] if parts[0] == "dec_blocks" else parts[0])
        by_layer[key] = by_layer.get(key, 0.0) + float((x.double() ** 2)
                                                       .sum())
    out["grad_norm"] = sum(by_layer.values()) ** 0.5
    # the norm of the gradient of the top layer, of layer 0 and of the
    # embedding: where the gradient grows
    out["layer_norms"] = tuple(by_layer.get(k, 0.0) ** 0.5 for k in (
        str(cfg.n_layers - 1), "0", "embed"))
    del g, g_w
    if per_call:
        ran = [c for c in calls if "gi" in c]
        out["calls"] = len(calls)
        out["call_errs"] = wkv_call_errors(torch, W, ran)
        del calls[:], ran
    return out


def sync_cards(torch):
    """Wait for every CUDA card of this machine."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def train_steps(torch, step_fn, state, cfg, shape, dev, fwd, bwd, start,
                n, dtype=None):
    """Steps start .. start + n - 1 of ``step_fn`` on the seeded batches of
    ``shape`` on ``dev`` (their float leaves cast to ``dtype`` if given):
    per step its wall, the launches of the kernel wrappers ``fwd`` and
    ``bwd`` (each count set to 0 just before the step) and its
    metrics."""
    from repro_torch.data.pipeline import make_batch_np, to_device
    rows = []
    for step in range(start, start + n):
        b = cast_batch(to_device(make_batch_np(cfg, shape, TRAIN_DATA_SEED,
                                               step), dev), dtype)
        sync_cards(torch)
        fwd.launches = bwd.launches = 0              # counts: just before
        t = time.perf_counter()
        _, m = step_fn(state, b)
        sync_cards(torch)
        rows.append({"step": step, "wall": time.perf_counter() - t,
                     "fwd": fwd.launches, "bwd": bwd.launches,
                     **{k: float(x) for k, x in m.items()}})
    return rows


def phase_train(torch, W, FA, arch, n_layers, batch, seq):
    """Training at full width through make_train_step: the gradients of
    the model on its kernels against the same model on their plain
    versions (``model_grads``: at TRAIN_CMP_LAYERS layers, a model of its
    own where ``n_layers`` is deeper, and then the deep model call by
    call); 2 x TRAIN_STEPS steps, per step the kernels' forward and
    backward counts, wall, tokens/s; peak memory; a profiled step's idle
    share; the step with deterministic kernels off and on, in turns.  The
    restarts are held by the launcher (rwkv6-1.6b at full width) and by
    phase y (the reduced MoE models)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rwkv = cfg.family == "ssm"
    fwd, bwd = (W.wkv6, W.wkv6_bwd) if rwkv else (FA.flash_attention,
                                                  FA.flash_attention_bwd)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = factory.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    out = {"cfg": cfg, "batch": batch, "seq": seq,
           "init_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in model.parameters())}
    opt_cfg = OptConfig(**TRAIN_OPT)
    state = TS.init_train_state(model, cfg, opt_cfg)

    # the gradients: the whole model at full width and TRAIN_CMP_LAYERS
    # layers within TRAIN_GRAD_TOL; for a deeper RWKV model, every wkv6
    # call of the whole depth, and the whole model's readings
    cmp = to_device(make_batch_np(cfg, ShapeSpec("x", TRAIN_CMP_SEQ, batch,
                                                 "train"),
                                  TRAIN_DATA_SEED, 10_000), dev)
    if cfg.n_layers == TRAIN_CMP_LAYERS:
        out["grad"] = model_grads(torch, W, FA, model, cfg, cmp)
    else:
        cfg_cut = dataclasses.replace(cfg, n_layers=TRAIN_CMP_LAYERS)
        cut = factory.init_params(0, cfg_cut, device=dev).requires_grad_(True)
        out["grad"] = model_grads(torch, W, FA, cut, cfg_cut, cmp)
        del cut
        torch.cuda.empty_cache()
        out["grad_deep"] = model_grads(torch, W, FA, model, cfg, cmp,
                                       per_call=rwkv)
    torch.cuda.empty_cache()

    step_fn = TS.make_train_step(cfg, opt_cfg)
    shape = ShapeSpec("x", seq, batch, "train")
    torch.cuda.reset_peak_memory_stats()
    out["rows"] = train_steps(torch, step_fn, state, cfg, shape, dev, fwd,
                              bwd, 0, 2 * TRAIN_STEPS)
    out["peak"] = torch.cuda.max_memory_allocated()
    # where the time goes: one step under the profiler
    step = 2 * TRAIN_STEPS
    b = to_device(make_batch_np(cfg, shape, TRAIN_DATA_SEED, step), dev)
    events, wall = profiled(torch, lambda: step_fn(state, b))
    busy = sum(us for _, us in events) / 1e6
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    out["profile"] = {"wall": wall, "busy": busy, "n": len(events),
                      "top": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:4],
                      "fwd_us": sum(us for n, us in events
                                    if ("wkv6_kernel" if rwkv else
                                        "flash_kernel") in n),
                      "bwd_us": sum(us for n, us in events
                                    if ("wkv6_bwd" if rwkv else
                                        "flash_bwd") in n)}
    # what deterministic kernels cost: steps with them on and off, in turns
    turns = {True: [], False: []}
    real = TS.deterministic
    for i, on in enumerate((True, False, False, True)):
        if not on:
            TS.deterministic = lambda device: contextlib.nullcontext()
        try:
            turns[on] += [r["wall"] for r in train_steps(
                torch, step_fn, state, cfg, shape, dev, fwd, bwd,
                step + 1 + i, 1)]
        finally:
            TS.deterministic = real
    out["det_turns"] = turns
    return out


def _train_launcher(torch, ckpt, arch, batch, seq):
    """launch/train.py at full width for ``arch`` in this process, batch
    x seq tokens a step: 6 steps straight; 4 steps with a checkpoint at
    step 4; the same command to 6 steps, which resumes from it and must
    end in the straight run's state bit for bit.  The launcher's schedule
    takes its total steps from --steps, and all four steps before the save
    fall in its 5-step warmup, which does not read them: so this check
    covers warmup steps only.  The restart witness after warmup is
    phase y's 3 + restore + 3 under the fixed TRAIN_OPT."""
    import io

    from repro_torch.launch import train as train_launcher
    argv = ["--arch", arch, "--full", "--batch", str(batch), "--seq",
            str(seq)]
    runs, snap = [], None
    for n, with_ckpt in ((6, False), (4, True), (6, True)):
        args = argv + ["--steps", str(n)] + (
            ["--ckpt", ckpt, "--ckpt-every", "4"] if with_ckpt else [])
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_launcher.main(args)
        torch.cuda.synchronize()
        run = {"argv": " ".join(args[len(argv):]).replace(ckpt, "DIR"),
               "wall": time.perf_counter() - t,
               "lines": buf.getvalue().strip().splitlines()}
        if n == 6 and not with_ckpt:
            snap = _snapshot(state)
        elif n == 6:
            run["differ"] = _same_as(torch, state, snap)
        runs.append(run)
        del state
        torch.cuda.empty_cache()
    return runs


def golden_frames(torch, golden, cfg, batch):
    """Whisper's frames of a golden file: (batch, ENC_LEN, d_model) f32
    from its numpy seed (tests/_hybrid.py draws them so), on the card."""
    from repro_torch.models.whisper import ENC_LEN
    return torch.from_numpy(np.random.default_rng(
        golden["frames_seed"]).standard_normal(
        (batch, ENC_LEN, cfg.d_model), dtype=np.float32)).to("cuda")


def _greedy(torch, model, cfg, batch, max_len, new):
    """Greedy tokens (B, new) by factory.prefill and decode steps: what
    generate does, for a batch with Whisper's frames too."""
    from repro_torch.models import factory
    logits, cache = factory.prefill(model, batch, cfg=cfg, max_len=max_len)
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    for _ in range(new - 1):
        logits, cache = factory.decode(model, cache, {"tokens": toks[-1]},
                                       cfg=cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(toks, 1)


def phase_reduced_golden(torch, FA, name):
    """The reduced models of a golden file (the dense, the MoE or the
    hybrid family's) on the card against the JAX package's results for
    the same seeded weights and prompts (and Whisper's seeded frames);
    flash_attention launched flash_calls(cfg) times in the prefill."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import (jitter_constant_leaves,
                                     lm_params_to_torch, params_fingerprint,
                                     seeded_lm_params)
    from repro_torch.models import factory

    with open(os.path.join(GOLDEN, name)) as f:
        golden = json.load(f)
    out = {}
    for arch, g in golden["archs"].items():
        cfg = get_reduced(arch)
        tree = jitter_constant_leaves(
            seeded_lm_params(cfg, golden["weight_seed"],
                             max_seq=golden.get("max_seq", 4096)),
            golden["jitter_seed"])
        fp = params_fingerprint(tree)
        check(abs(fp - g["weights_sum"]) <= 1e-9 * g["weights_sum"],
              f"{arch}: seeded weights differ from the golden's (sum |w| "
              f"{fp} vs {g['weights_sum']}): numpy's random stream changed")
        model = factory.from_state_dict(cfg, lm_params_to_torch(tree, cfg,
                                                                "cuda"))
        prompts = torch.tensor(golden["prompt"][arch], dtype=torch.int32,
                               device="cuda")
        batch = {"tokens": prompts}
        if cfg.enc_dec:
            batch["frames"] = golden_frames(torch, golden, cfg,
                                            prompts.shape[0])
        FA.flash_attention.launches = 0
        logits, cache = factory.prefill(model, batch, cfg=cfg,
                                        max_len=golden["max_len"])
        launches = FA.flash_attention.launches
        check(launches == flash_calls(cfg), f"{arch} reduced prefill "
              f"launched flash_attention {launches} times, not "
              f"{flash_calls(cfg)}")
        tok = torch.tensor(g["tokens"], dtype=torch.int32,
                           device="cuda")[:, :1]
        dec, _ = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)
        errs = {}
        for key, got in (("prefill_logits", logits), ("decode_logits", dec)):
            want = torch.tensor(g[key], device="cuda")
            err = (got - want).abs()
            errs[key] = float(err.max())
            check(bool((err <= WKV_TOL + WKV_TOL * want.abs()).all()),
                  f"{arch} reduced {key} differ from the golden by up to "
                  f"{errs[key]} (rtol = atol = {WKV_TOL})")
        toks = (_greedy(torch, model, cfg, batch, golden["max_len"],
                        golden["max_new"]) if cfg.enc_dec else
                factory.generate(model, cfg, prompts,
                                 max_new=golden["max_new"]))
        check(toks.cpu().tolist() == g["tokens"],
              f"{arch} reduced greedy tokens {toks.cpu().tolist()} differ "
              f"from the golden {g['tokens']}")
        out[arch] = {"errs": errs, "launches": launches, "cfg": cfg,
                     "shape": tuple(prompts.shape), "weights_sum": fp}
    return out, golden["max_new"]


def flash_calls(cfg):
    """flash_attention launches of one prefill (and of one training
    forward): one per GQA layer (none for MLA), one per attention
    sublayer of a jamba period, and for Whisper one per encoder layer
    and two per decoder layer (self and cross attention)."""
    from repro_torch.models.lm import group_plan
    if cfg.enc_dec:
        return cfg.n_enc_layers + 2 * cfg.n_layers
    n = 0
    for kind, count in group_plan(cfg):
        if kind.startswith("std"):
            n += count
        elif kind == "period":
            n += count * cfg.block_pattern.count("attn")
    return n


def kernel_calls(cfg, mesh=None, seq=None):
    """Launches of the attention kernel (K3', or K2 for RWKV) in one
    training forward of a batch of ``seq``-token rows, unsharded or on a
    ('data', 'model') ``mesh`` whose data positions each take rows: per
    attention call and data position, one on each model position where
    the model axis splits the heads, or splits head_dim on a sequence
    long enough for seqpar_attention (its slabs), else one (the attention
    on whole heads, or RWKV's wkv on all heads where the axis cuts them,
    once per data position)."""
    from repro_torch.models.whisper import ENC_LEN
    dp, tp = (1, 1) if mesh is None else (int(np.prod(mesh[:-1])), mesh[-1])
    if cfg.family == "ssm":
        whole = cfg.d_model % tp == 0 and \
            (cfg.d_model // tp) % cfg.rwkv.head_size == 0
        return cfg.n_layers * dp * (tp if whole else 1)
    h, hd = cfg.n_heads, cfg.resolved_head_dim

    def per(s, self_attn=True):
        if h % tp == 0 or (hd % tp == 0 and self_attn and s % tp == 0
                           and s // tp >= 128):
            return dp * tp
        return dp

    if cfg.enc_dec:
        return (cfg.n_enc_layers * per(ENC_LEN)
                + cfg.n_layers * (per(seq) + per(seq, False)))
    return flash_calls(cfg) * per(seq)


def dense_config():
    from repro_torch.configs import get_config
    return get_config(DENSE_ARCH)


def phase_generate_full(torch, FA, W, K, Q, cfg, batch, prompt_len, new,
                        repeats, cons_cases, cons_cfg=None):
    """A model at full width through factory.generate (batch x prompt_len,
    new tokens): the main path's launches; `repeats` timed windows of
    prefill, decode steps and generate, whose tokens must agree; cache
    consistency, a prefill of s tokens against s - steps tokens and
    `steps` decode steps for each (s, steps) of cons_cases, run with
    cons_cfg (the MoE models' no-drop capacity factor) or cfg; the kernel
    against attention_plain inside the model on a 128-token prefill
    (models with GQA layers); peak memory and profiles."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.models import factory
    from repro_torch.models.layers import attention as attn_layers

    t0 = time.perf_counter()
    model = factory.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int32, device="cuda")
    max_len = prompt_len + new

    # warm-up: cuBLAS handles, the caching allocator
    factory.generate(model, cfg, prompts, max_new=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read just after
    FA.flash_attention.launches = 0
    W.wkv6.launches = 0
    K.issue_select.launches = 0
    Q.sm_quantum.launches = 0
    toks = factory.generate(model, cfg, prompts, max_new=new)
    torch.cuda.synchronize()
    launches = FA.flash_attention.launches
    others = (W.wkv6.launches, K.issue_select.launches,
              Q.sm_quantum.launches)
    peak = torch.cuda.max_memory_allocated()

    times = {"prefill": [], "decode": [], "generate": []}
    agree = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        logits, cache = _prefill(model, prompts, cfg, max_len)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(new - 1):
            step_logits, cache = factory.decode(model, cache,
                                                {"tokens": tok}, cfg=cfg)
            tok = torch.argmax(step_logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        times["decode"].append(time.perf_counter() - t0)
        del cache
        t0 = time.perf_counter()
        again = factory.generate(model, cfg, prompts, max_new=new)
        torch.cuda.synchronize()
        times["generate"].append(time.perf_counter() - t0)
        agree.append(torch.equal(again, toks) and torch.equal(toks[:, -1:],
                                                              tok))
    times["generate - prefill"] = [g - p for g, p in zip(
        times["generate"], times["prefill"])]

    # cache consistency, within CONSISTENCY_TOL of the largest logit
    cons_cfg = cons_cfg or cfg
    cons = []
    for s, steps in cons_cases:
        full = _prefill(model, prompts[:, :s], cons_cfg)[0]
        dec = _decode_after(torch, model, cons_cfg, prompts, s, steps)
        cons.append((s, steps, float((full - dec).abs().max()),
                     float(full.abs().max()), bool(torch.isfinite(dec).all())))
        del full, dec
    torch.cuda.empty_cache()
    # the kernel against attention_plain inside the model, 128 tokens
    in_model = None
    if flash_calls(cfg):
        full_k = _prefill(model, prompts[:, :128], cfg)[0]
        attn_layers.flash_attention = attention_plain
        try:
            full_p = _prefill(model, prompts[:, :128], cfg)[0]
        finally:
            attn_layers.flash_attention = FA.flash_attention
        in_model = float((full_k - full_p).abs().max()) / float(
            full_p.abs().max())

    windows = _windows(torch, model, cfg, prompts, toks, max_len)
    return {"cfg": cfg, "n_params": n_params, "init_s": init_s,
            "times": {k: _spread(v) for k, v in times.items()},
            "launches": launches, "others": others, "peak": peak,
            "cons": cons, "in_model": in_model, "windows": windows,
            "agree": agree, "toks": toks, "logits": logits,
            "sample": toks[0, :8].tolist()}


def phase_whisper_full(torch, FA, W, K, Q):
    """whisper-base at full size through factory.prefill and a greedy
    factory.decode loop (batch WHISPER_BATCH over ENC_LEN seeded frames,
    a prompt of WHISPER_PROMPT tokens, WHISPER_NEW new): the main path's
    launches; WHISPER_REPEATS timed windows of prefill and decode steps,
    whose tokens must agree; cache consistency; the kernel against
    attention_plain inside the model; peak memory and profiles."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.models import factory
    from repro_torch.models.layers import attention as attn_layers
    from repro_torch.models.whisper import ENC_LEN

    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = factory.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((WHISPER_BATCH, ENC_LEN, cfg.d_model),
                         generator=gen, device="cuda")
    cons_len = WHISPER_CONS[0]
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH, cons_len),
                           generator=gen, dtype=torch.int32, device="cuda")
    prompts = tokens[:, :WHISPER_PROMPT]
    max_len = WHISPER_PROMPT + WHISPER_NEW

    def greedy(new, times=None):
        t = time.perf_counter()
        logits, cache = _prefill(model, prompts, cfg, max_len, frames)
        first = logits
        if times is not None:
            torch.cuda.synchronize()
            times["prefill"].append(time.perf_counter() - t)
            t = time.perf_counter()
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        for _ in range(new - 1):
            logits, cache = factory.decode(model, cache,
                                           {"tokens": toks[-1]}, cfg=cfg)
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
        if times is not None:
            torch.cuda.synchronize()
            times["decode"].append(time.perf_counter() - t)
        return torch.cat(toks, 1), first

    greedy(2)                        # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read just after
    FA.flash_attention.launches = 0
    W.wkv6.launches = 0
    K.issue_select.launches = 0
    Q.sm_quantum.launches = 0
    toks, logits = greedy(WHISPER_NEW)
    torch.cuda.synchronize()
    launches = FA.flash_attention.launches
    others = (W.wkv6.launches, K.issue_select.launches,
              Q.sm_quantum.launches)
    peak = torch.cuda.max_memory_allocated()
    times = {"prefill": [], "decode": []}
    agree = [torch.equal(greedy(WHISPER_NEW, times)[0], toks)
             for _ in range(WHISPER_REPEATS)]
    # cache consistency: a prefill of 64 tokens against 32 + 32 steps
    s, steps = WHISPER_CONS
    full = _prefill(model, tokens, cfg, 0, frames)[0]
    dec = _decode_after(torch, model, cfg, tokens, s, steps, frames=frames)
    cons = (s, steps, float((full - dec).abs().max()),
            float(full.abs().max()), bool(torch.isfinite(dec).all()))
    # the kernel against attention_plain inside the model
    attn_layers.flash_attention = attention_plain
    try:
        plain = _prefill(model, prompts, cfg, max_len, frames)[0]
    finally:
        attn_layers.flash_attention = FA.flash_attention
    in_model = float((logits - plain).abs().max()) / float(
        plain.abs().max())
    windows = _windows(torch, model, cfg, prompts, toks, max_len, frames)
    return {"cfg": cfg, "n_params": n_params, "init_s": init_s,
            "times": {k: _spread(v) for k, v in times.items()},
            "launches": launches, "others": others, "peak": peak,
            "cons": cons, "in_model": in_model, "windows": windows,
            "agree": agree, "toks": toks, "logits": logits,
            "sample": toks[0, :8].tolist()}


def moe_config(arch, n_layers):
    """The published config of an MoE model cut to n_layers (deepseek's
    dense prefix kept)."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def no_drop(cfg):
    """cfg at the capacity factor E / top_k, where no token can drop."""
    import dataclasses
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def y_grad_tol(cfg):
    """Phase y's limit on the gradient norm, card against CPU."""
    return RWKV_Y_GRAD_TOL if cfg.family == "ssm" else MOE_TRAIN_GRAD_TOL


def _golden_archs(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return list(json.load(f)["archs"])


def phase_reduced_train(torch, FA, name, mesh_shape=None, archs=None,
                        W=None, rows=None):
    """The reduced models of a golden file (the MoE family's, or jamba's
    and Whisper's; ``archs`` where given, from that file's seeds, and
    without the JAX package's loss where it has none) trained on the card
    through
    make_train_step under deterministic kernels: the loss of the golden's
    batch against the JAX package's and the port's on the CPU;
    TRAIN_STEPS steps, a checkpoint, TRAIN_STEPS more, then the checkpoint
    restored and TRAIN_STEPS again, which must end in the straight run's
    state bit for bit; the straight 2 x TRAIN_STEPS steps against the same
    steps by the port on the CPU (metrics per step, parameters after
    them); flash_attention's forward (forward and recompute) and backward
    launches per step (wkv6's with ``W`` for RWKV).  With ``mesh_shape``
    both sides run the sharded step on a mesh of that shape
    (train/train_step.py), every position on the card or on the CPU;
    ``rows`` where given is the steps' batch rows (the golden's batch
    still gives the losses)."""
    import shutil
    import tempfile

    from repro_torch.checkpointing.checkpoint import restore, save
    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.convert import (jitter_constant_leaves,
                                     lm_params_to_torch, seeded_lm_params)
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    with open(os.path.join(GOLDEN, name)) as f:
        golden = json.load(f)
    b, s = golden["train_shape"]
    shape = ShapeSpec("y", s, rows or b, "train")
    opt_cfg = OptConfig(**TRAIN_OPT)
    sides = (("card", "cuda:0"), ("cpu", "cpu"))
    kws = {side: {} if mesh_shape is None else {"ctx": make_ctx(
        make_train_mesh(mesh_shape, device=dev))} for side, dev in sides}
    out = {}
    for arch in archs or golden["archs"]:
        g = golden["archs"].get(arch, {})
        cfg = get_reduced(arch)
        fwd, bwd = ((W.wkv6, W.wkv6_bwd) if cfg.family == "ssm"
                    else (FA.flash_attention, FA.flash_attention_bwd))
        tree = jitter_constant_leaves(
            seeded_lm_params(cfg, golden["weight_seed"],
                             max_seq=golden.get("max_seq", 4096)),
            golden["jitter_seed"])
        batch = make_batch_np(cfg, ShapeSpec("y", s, b, "train"),
                              golden["data_seed"], 0)
        losses, states, step_fns = {}, {}, {}
        for side, dev in sides:
            model = factory.from_state_dict(
                cfg, lm_params_to_torch(tree, cfg, dev))
            with torch.no_grad():
                losses[side] = float(factory.train_loss(
                    model, to_device(batch, dev), cfg=cfg)[0])
            states[side] = TS.init_train_state(model, cfg, opt_cfg,
                                               **kws[side])
            step_fns[side] = TS.make_train_step(cfg, opt_cfg, **kws[side])
        state = states["card"]

        def steps(st, side, start, n):
            return train_steps(torch, step_fns[side], st, cfg, shape,
                               dict(sides)[side], fwd, bwd, start, n)

        ckpt = tempfile.mkdtemp(prefix="reduced-ckpt-")
        try:
            rows = steps(state, "card", 0, TRAIN_STEPS)
            save(ckpt, TRAIN_STEPS, state, cfg)
            rows += steps(state, "card", TRAIN_STEPS, TRAIN_STEPS)
            snap = _snapshot(TS.plain_state(state))
            restore(ckpt, TRAIN_STEPS, state, cfg)
            again = steps(state, "card", TRAIN_STEPS, TRAIN_STEPS)
            differ = _same_as(torch, TS.plain_state(state), snap)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        # the same straight steps by the port on the CPU
        cpu_rows = steps(states["cpu"], "cpu", 0, 2 * TRAIN_STEPS)
        vs_cpu = {k: max(abs(r[k] - c[k]) / (abs(c[k]) or 1.0)
                         for r, c in zip(rows, cpu_rows))
                  for k in ("loss", "ce", "aux", "grad_norm")}
        cpu_params = states["cpu"]["params"].state_dict()
        vs_cpu["params"] = max(
            float((snap[("p", k)] - v).abs().max()
                  / v.abs().max().clamp(min=1e-30))
            for k, v in cpu_params.items())
        out[arch] = {"cfg": cfg, "losses": losses,
                     "jax": g.get("train_loss"),
                     "rows": rows, "again": again, "differ": differ,
                     "cpu_rows": cpu_rows, "vs_cpu": vs_cpu,
                     "kernel": fwd.__name__,
                     "calls": kernel_calls(cfg, mesh_shape, s),
                     "metrics_equal": all(
                         {k: r[k] for k in ("loss", "ce", "aux",
                                            "grad_norm")}
                         == {k: a[k] for k in ("loss", "ce", "aux",
                                               "grad_norm")}
                         for r, a in zip(rows[TRAIN_STEPS:], again))}
    return out, shape


def jitter_constants(torch, model, seed, std=0.1):
    """Seeded N(0, std) noise added, on the model's device, to every
    parameter that the init sets to a constant (norm scales and biases,
    QKV biases; repro_torch.convert.CONSTANT_LEAVES), as the CPU tests
    jitter their seeded weights (``convert.jitter_constant_leaves``), so
    that no leaf starts at zero and a leaf's largest magnitude is a scale
    of its own, not its first update."""
    from repro_torch.convert import CONSTANT_LEAVES
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in CONSTANT_LEAVES:
                p.add_(std * torch.randn(p.shape, generator=gen,
                                         device=p.device, dtype=p.dtype))


def phase_shard_train(torch, FA, devices=None, *, W=None, arch=SHARD_ARCH,
                      n_layers=None, batch=SHARD_BATCH, meshes=SHARD_MESHES,
                      seq=SHARD_SEQ, keep=None):
    """``arch`` (cut to ``n_layers`` if given) trained by the sharded step
    (train/train_step.py) on each ('data', 'model') mesh of ``meshes``,
    its positions on ``devices`` (by default every position on cuda:0),
    batch x seq tokens a step: per mesh TRAIN_STEPS sharded steps,
    the same steps sharded again (bit for bit), one more profiled; then
    TRAIN_STEPS unsharded steps on cuda:0 from the same seed, one more
    profiled, which every mesh's steps are held against.  Each run from
    weights drawn on cuda:0 from seed 0 (its constant leaves jittered,
    ``jitter_constants``), one state at a time, each mesh's final state
    and the initial parameters kept on the card for the comparisons.  Per
    run: step walls, the forward launches and backward calls of the
    attention kernels (wkv6 with ``W`` for RWKV) per step, and its peak
    memory on each card over what was held there before it began.  With
    ``keep`` ("cpu") the kept parameters live there instead, each leaf
    brought back to the card for the comparisons, and the two sharded
    runs' states are held equal by their tensors' digests (``digest``),
    so that a model whose state fills the card can be compared."""
    import dataclasses
    import gc

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rwkv = cfg.family == "ssm"
    dev = torch.device("cuda:0")
    cards = sorted({torch.device(d).index or 0 for d in devices or []}
                   | {0})
    opt_cfg = OptConfig(**TRAIN_OPT)
    shape = ShapeSpec("z", seq, batch, "train")
    fwd, bwd = ((W.wkv6, W.wkv6_bwd) if rwkv
                else (FA.flash_attention, FA.flash_attention_bwd))
    kernel_names = (("wkv6_kernel", "wkv6_bwd") if rwkv
                    else ("flash_kernel", "flash_bwd"))
    out = {"cfg": cfg, "batch": batch, "seq": seq, "cards": cards,
           "meshes": {}, "kernels": "wkv6" if rwkv else "flash_attention",
           "runs": {}}
    plan = []
    for mesh in meshes:
        n = int(np.prod(mesh))
        ctx = make_ctx(make_train_mesh(
            mesh, devices=list(devices)[:n] if devices else [dev] * n))
        out["meshes"][mesh] = {"calls": kernel_calls(cfg, mesh, seq),
                               "rows": batch // ctx.dp_size}
        plan += [((mesh, "sharded"), {"ctx": ctx}),
                 ((mesh, "again"), {"ctx": ctx})]
    plan.append(((None, "unsharded"), {}))
    snaps, init = {}, None
    for (mesh, name), kw in plan:
        gc.collect()
        held = {}
        for i in cards:
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(i)
            held[i] = torch.cuda.memory_allocated(i)
        t0 = time.perf_counter()
        model = factory.init_params(0, cfg, device=dev)
        jitter_constants(torch, model, 1)
        if init is None:
            init = {n: t.detach().to(keep or t.device, copy=True)
                    for n, t in model.state_dict().items()}
        n_params = sum(p.numel() for p in model.parameters())
        state = TS.init_train_state(model, cfg, opt_cfg, **kw)
        del model
        sync_cards(torch)
        run = {"init_s": time.perf_counter() - t0, "n_params": n_params}
        step_fn = TS.make_train_step(cfg, opt_cfg, **kw)
        run["rows"] = train_steps(torch, step_fn, state, cfg, shape, dev,
                                  fwd, bwd, 0, TRAIN_STEPS)
        run["peak"] = [torch.cuda.max_memory_allocated(i) - held[i]
                       for i in cards]
        plain = TS.plain_state(state)
        if name == "sharded":
            tensors = dict(_state_tensors(plain))
            if keep:
                snaps[mesh] = {key: t.to(keep, copy=True)
                               for key, t in tensors.items() if key[0] == "p"}
                snaps[mesh]["digests"] = {key: digest(torch, t)
                                          for key, t in tensors.items()}
            else:
                snaps[mesh] = {key: t.clone() for key, t in tensors.items()}
            del tensors
        elif name == "again":
            want = snaps[mesh].get("digests")
            run["differ"] = [f"{k}:{n}" for (k, n), t in
                             _state_tensors(plain)
                             if (digest(torch, t) != want[k, n] if keep
                                 else not torch.equal(t, snaps[mesh][k, n]))]
            # the unsharded run needs the parameters only
            snaps[mesh] = {key: t for key, t in snaps[mesh].items()
                           if key[0] == "p" and key != "digests"}
        else:
            params = plain["params"].state_dict()
            run["still"] = sorted(n for n, t in params.items()
                                  if torch.equal(t.detach(),
                                                 init[n].to(t.device)))
            for m, snap in snaps.items():
                r = out["meshes"][m]
                r["params"], update = 0.0, {}
                for n, t in params.items():
                    t, want = t.detach(), snap["p", n].to(t.device)
                    r["params"] = max(r["params"], float(
                        (t - want).abs().max()
                        / want.abs().max().clamp(min=1e-30)))
                    # each leaf's change: sharded against unsharded, in L2
                    # over the unsharded change (0 where neither moved, inf
                    # where only the sharded one did)
                    moved = float((t - init[n].to(t.device)).norm())
                    apart = float((t - want).norm())
                    update[n] = (apart / moved if moved else
                                 0.0 if not apart else float("inf"))
                    del want
                r["update"] = update
        if name != "sharded":
            # where the time goes: one more step under the profiler
            b = to_device(make_batch_np(cfg, shape, TRAIN_DATA_SEED,
                                        TRAIN_STEPS), dev)
            t_p = time.perf_counter()
            events, wall = profiled(torch, lambda: step_fn(state, b),
                                    host=False)
            check(events, f"{arch} {mesh} {name}: the profile caught no "
                  "device activity")
            by_name = {}
            for ev, us in events:
                by_name[ev] = by_name.get(ev, 0.0) + us
            run["profile"] = {
                "wall": wall, "busy": sum(us for _, us in events) / 1e6,
                "read_s": time.perf_counter() - t_p - wall,
                "n": len(events),
                "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
                "fwd_us": sum(us for ev, us in events
                              if kernel_names[0] in ev),
                "bwd_us": sum(us for ev, us in events
                              if kernel_names[1] in ev)}
        run["run_s"] = time.perf_counter() - t0
        out["runs"][mesh, name] = run
        del state, step_fn, plain
    del snaps, init
    gc.collect()
    torch.cuda.empty_cache()
    flat = out["runs"][None, "unsharded"]["rows"]
    keys = ("loss", "ce", "aux", "grad_norm")
    for mesh, r in out["meshes"].items():
        rows = out["runs"][mesh, "sharded"]["rows"]
        again = out["runs"][mesh, "again"]["rows"]
        r["vs_unsharded"] = {k: max(abs(a[k] - c[k]) / (abs(c[k]) or 1.0)
                                    for a, c in zip(rows, flat))
                             for k in keys}
        r["metrics_equal"] = all({k: a[k] for k in keys} ==
                                 {k: c[k] for k in keys}
                                 for a, c in zip(rows, again))
    return out


def report_shard_train(zr, card, where):
    """Print the lines of ``zr`` (``phase_shard_train``) on meshes of
    ``where``, and hold it: finite metrics, the kernels' launches per step
    (a forward and its recompute on every position), each mesh's two
    sharded runs bit-identical, and each mesh's sharded run against the
    unsharded one within MOE_TRAIN_METRIC_TOL / MOE_TRAIN_GRAD_TOL /
    MOE_TRAIN_PARAM_TOL and every leaf's change within SHARD_UPDATE_TOL,
    no leaf left where it started."""
    c, batch, seq = zr["cfg"], zr["batch"], zr["seq"]
    calls = kernel_calls(c, None, seq)
    tag = f"[z shard train] {c.name}"
    what = ("" if c.family == "ssm" else
            f", MLA {c.n_heads} heads (q / kv latents {c.mla.q_lora_rank} / "
            f"{c.mla.kv_lora_rank})" if c.mla is not None else
            f", {c.n_heads} q / {c.n_kv_heads} KV heads of "
            f"{c.resolved_head_dim}")
    for (mesh, name), run in zr["runs"].items():
        walls = [r["wall"] for r in run["rows"]]
        step_s = float(np.median(walls[1:]))
        peaks = {i: round(x / 2**30, 3)
                 for i, x in zip(zr["cards"], run["peak"])}
        on = ("cuda:0, no mesh" if mesh is None else
              f"{mesh} ('data', 'model') mesh of {where}, "
              f"{zr['meshes'][mesh]['rows']} rows per data position")
        enc = (f" over {c.n_enc_layers} encoder layers of 1500 frames"
               if c.enc_dec else "")
        print(f"{tag} ({c.n_layers} layers{enc}, d_model {c.d_model}{what}, "
              f"d_ff {c.d_ff}, vocab {c.vocab_size}; {run['n_params']} f32 "
              f"parameters, init {run['init_s']:.2f} s), {name} run "
              f"({run['run_s']:.1f} s in all), {on}, "
              f"batch {batch} x {seq}, AdamW {TRAIN_OPT}, "
              f"deterministic kernels, on {card}: step {step_s:.3f} s "
              f"(median of steps 1-{TRAIN_STEPS - 1}: "
              f"{', '.join(f'{x:.3f}' for x in walls[1:])}; step 0 "
              f"{walls[0]:.3f} s) = {batch * seq / step_s:.1f} "
              f"tokens/s; peak device memory GiB by card {peaks} over "
              f"what the run found held; per step {zr['kernels']} forward "
              f"launches {[r['fwd'] for r in run['rows']]}, backward calls "
              f"{[r['bwd'] for r in run['rows']]}; loss "
              f"{[round(r['loss'], 6) for r in run['rows']]}, grad_norm "
              f"{[round(r['grad_norm'], 6) for r in run['rows']]}",
              flush=True)
        if "profile" not in run:
            continue
        p = run["profile"]
        print(f"{tag}: profile of one {name} step ({on}; device activity "
              f"only, read back in {p['read_s']:.1f} s): wall "
              f"{p['wall']:.3f} s, device busy {p['busy']:.4f} s (idle share "
              f"{1 - p['busy'] / p['wall']:.4f}), {p['n']} device "
              f"activities, {zr['kernels']} forward {p['fwd_us'] / 1e3:.3f} "
              f"ms, backward {p['bwd_us'] / 1e3:.3f} ms (together "
              f"{(p['fwd_us'] + p['bwd_us']) / 1e6 / p['wall']:.2%} of the "
              f"step's wall); top: " + "; ".join(
                  f"{n[:50]} {us / 1e3:.2f} ms" for n, us in p["top"]),
              flush=True)
    un = zr["runs"][None, "unsharded"]
    for mesh, r in zr["meshes"].items():
        v, again = r["vs_unsharded"], zr["runs"][mesh, "again"]
        upd = sorted(r["update"].items(), key=lambda kv: -kv[1])
        print(f"{tag} on {mesh}: the sharded run again: state bit-identical: "
              f"{not again['differ']} ({len(again['differ'])} tensors "
              f"differ), metrics equal: {r['metrics_equal']}; sharded "
              f"against unsharded: worst relative difference loss "
              f"{v['loss']:.2e}, ce {v['ce']:.2e}, aux {v['aux']:.2e} (limit "
              f"{MOE_TRAIN_METRIC_TOL}), grad_norm {v['grad_norm']:.2e} "
              f"(limit {MOE_TRAIN_GRAD_TOL}); parameters after {TRAIN_STEPS} "
              f"steps {r['params']:.2e} of a leaf's largest magnitude (limit "
              f"{MOE_TRAIN_PARAM_TOL}); each leaf's change in L2 over the "
              f"unsharded change: worst {upd[0][1]:.2e} ({upd[0][0]}), "
              f"median {upd[len(upd) // 2][1]:.2e}, next "
              + ", ".join(f"{n} {x:.2e}" for n, x in upd[1:4])
              + f" (limit {SHARD_UPDATE_TOL}); leaves the unsharded steps "
              f"left where they started: {un['still']}", flush=True)
        for name in ("sharded", "again"):
            n = r["calls"]
            for x in zr["runs"][mesh, name]["rows"]:
                check(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]),
                      f"{c.name} {mesh} {name} step {x['step']}: not finite")
                check(x["fwd"] == 2 * n and x["bwd"] == n,
                      f"{c.name} {mesh} {name} step {x['step']}: "
                      f"{x['fwd']} forward launches and {x['bwd']} backward "
                      f"calls; {n} a forward")
        check(not again["differ"] and r["metrics_equal"],
              f"{c.name} on {mesh}: two sharded runs differ in "
              f"{again['differ'][:5]}")
        check(max(v["loss"], v["ce"], v["aux"]) <= MOE_TRAIN_METRIC_TOL
              and v["grad_norm"] <= MOE_TRAIN_GRAD_TOL
              and r["params"] <= MOE_TRAIN_PARAM_TOL,
              f"{c.name} on {mesh}: the sharded step departs from the "
              f"unsharded one ({v}, parameters {r['params']})")
        check(upd[0][1] <= SHARD_UPDATE_TOL and not un["still"],
              f"{c.name} on {mesh}: the sharded steps changed the parameters "
              f"otherwise than the unsharded ones ({upd[:3]}), or these left "
              f"{un['still'][:5]} unchanged")
    for x in un["rows"]:
        check(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
              and x["fwd"] == 2 * calls and x["bwd"] == calls,
              f"{c.name} unsharded step {x['step']}: not finite, or "
              f"{x['fwd']} forward launches and {x['bwd']} backward calls; "
              f"{calls} a forward")


def serve_loop(torch, fn_prefill, fn_decode, greedy, gather, new):
    """A prefill and ``new`` - 1 greedy decode steps, timed: (the prefill's
    logits and cache as ``gather`` returns them, the tokens (B, new), the
    prefill's seconds, the decode steps' seconds, the last cache)."""
    sync_cards(torch)
    t0 = time.perf_counter()
    logits, cache = fn_prefill()
    sync_cards(torch)
    prefill_s = time.perf_counter() - t0
    first = gather(logits, cache)
    toks = [greedy(logits)]
    t0 = time.perf_counter()
    for _ in range(new - 1):
        logits, cache = fn_decode(cache, toks[-1])
        toks.append(greedy(logits))
    sync_cards(torch)
    return (first, torch.cat(toks, dim=1), prefill_s,
            time.perf_counter() - t0, cache)


def phase_serve_mesh(torch, FA, W, arch, meshes, batch, prompt, new, *,
                     n_layers=None, held=True):
    """``arch`` at its published widths (whole, or cut to ``n_layers``),
    weights drawn on cuda:0
    from seed 0, served by ``factory.prefill``/``decode`` unsharded and
    then on each ('data', 'model') mesh of ``meshes`` repeating cuda:0
    (``place_model``: one copy of the model and one cache on the card):
    seeded token prompts (batch, prompt), ``new`` greedy tokens.  Per run:
    the prefill's seconds and its launches of the attention kernel (K3',
    or K2 for RWKV), counted from 0 just before it; the decode steps' ms a
    step and tokens/s; the peak device memory; the idle share of one more
    decode step, profiled (device activity only).  Each mesh is held
    against the unsharded run: its prefill logits, gathered, against the
    unsharded ones over their largest magnitude; its cache after the
    prefill, gathered from its blocks, leaf by leaf; its tokens.  Where
    not ``held`` (a model whose rounding its depth amplifies), the same
    distances of the unsharded model with its embedding moved by one ulp
    (a random sign per element) are read as a witness."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory, sharded
    from repro_torch.parallelism import sharding
    from repro_torch.parallelism.ctx import NULL_CTX

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rwkv = cfg.family == "ssm"
    kern = W.wkv6 if rwkv else FA.flash_attention
    dev = torch.device("cuda:0")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = factory.init_params(0, cfg, device=dev)
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, dtype=torch.int32, device=dev)
    out = {"cfg": cfg, "init_s": init_s, "batch": batch, "prompt": prompt,
           "new": new, "kernel": "wkv6" if rwkv else "flash_attention",
           "n_params": sum(p.numel() for p in model.parameters()),
           "runs": {}, "held": held}
    want = None

    def distances(logits, cache0):
        """(the prefill logits' distance from the unsharded ones over their
        largest magnitude; each cache leaf's, likewise)."""
        errs = {"/".join(map(str, path)): float(
            (a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp(min=1e-30))
            for (path, a), (_, b) in zip(sharded._leaves(cache0),
                                         sharded._leaves(want[1]))
            if path != ("len",)}
        return (float((logits - want[0]).abs().max()
                      / want[0].abs().max()), errs)
    for mesh in (None,) + tuple(meshes):
        ctx = NULL_CTX if mesh is None else make_ctx(
            make_train_mesh(mesh, device="cuda:0"))
        served = model if mesh is None else factory.place_model(model, cfg,
                                                                ctx)
        if mesh is None:
            def greedy(lg):
                return torch.argmax(lg, -1).to(torch.int32)[:, None]

            def gather(lg, cache):
                return lg, cache
        else:
            greedy = sharded.greedy

            def gather(lg, cache):
                return (sharding.gather(lg, dev),
                        sharded.gather_cache(cache, dev))

        def pre():
            kern.launches = 0
            return factory.prefill(served, {"tokens": prompts}, cfg=cfg,
                                   max_len=prompt + new, ctx=ctx)

        def dec(cache, tok):
            return factory.decode(served, cache, {"tokens": tok}, cfg=cfg,
                                  ctx=ctx)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (logits, cache0), toks, prefill_s, decode_s, cache = serve_loop(
            torch, pre, dec, greedy, gather, new)
        launches = kern.launches
        peak = torch.cuda.max_memory_allocated()
        events, wall = profiled(torch, lambda: dec(cache, toks[:, -1:]),
                                host=False)
        run = {"prefill_s": prefill_s,
               "step_ms": decode_s * 1e3 / (new - 1),
               "tokens_s": batch * (new - 1) / decode_s,
               "peak": peak, "launches": launches,
               "expected": kernel_calls(cfg, mesh, prompt),
               "idle": 1 - sum(us for _, us in events) / 1e6 / wall,
               "n_events": len(events), "tokens": toks}
        if mesh is None:
            want = (logits, cache0, toks)
            if not held:          # the witness: one ulp of the embedding
                emb = model.embed.emb
                keep = emb.detach().clone()
                sign = torch.sign(torch.randn(emb.shape, generator=gen,
                                              device=dev))
                with torch.no_grad():
                    emb.mul_(1 + 2.0 ** -23 * sign)
                lw, cw = factory.prefill(model, {"tokens": prompts},
                                         cfg=cfg, max_len=prompt + new)
                with torch.no_grad():
                    emb.copy_(keep)
                err, errs = distances(lw, cw)
                out["witness"] = {"logit_err": err,
                                  "cache_err": max(errs.values()),
                                  "cache_leaf": max(errs, key=errs.get)}
                del keep, sign, lw, cw
        else:
            run["logit_err"], errs = distances(logits, cache0)
            run["cache_err"] = max(errs.values())
            run["cache_leaf"] = max(errs, key=errs.get)
            run["tokens_equal"] = bool(torch.equal(toks, want[2]))
            run["specs"] = sorted({str(sh.spec) for p, sh in
                                   sharded._leaves(cache) if p != ("len",)})
        out["runs"][mesh] = run
        del logits, cache0, cache, served
    del model, want
    gc.collect()
    torch.cuda.empty_cache()
    if rwkv and n_layers is None:     # K2 at a position's prefill shape
        b_, h_, hs = batch, cfg.d_model // cfg.rwkv.head_size, \
            cfg.rwkv.head_size
        tp = meshes[0][1]
        shape = (b_, prompt, h_ // tp, hs)
        args = wkv_case(np.random.default_rng(SERVE_SEED), torch, *shape,
                        True)
        got, want = W.wkv6(*args), W.wkv6_plain(*args, chunk=64)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, want))
        # allclose's measure: |g - r| <= atol + rtol |r|
        worst = max(float(((g - r).abs() / (WKV_TOL + WKV_TOL * r.abs()))
                          .max()) for g, r in zip(got, want))
        del got, want
        kus = kernel_us(torch, lambda: [W.wkv6(*args) for _ in range(5)],
                        "wkv6_kernel")
        wrapper_ms = time_per_call(torch, lambda: W.wkv6(*args), 10)
        bound_ms, bound_by, _, _ = wkv_bound(*shape)
        out["k2"] = {"shape": list(shape), "bound_ms": bound_ms,
                     "bound_by": bound_by, "device_timed": bool(kus),
                     "max_abs_err": err, "worst": worst,
                     "ms": sum(kus) / len(kus) / 1e3 if kus else wrapper_ms,
                     "wrapper_ms": wrapper_ms}
    return out


def get_config_layers(name):
    """The published config's number of layers."""
    from repro_torch.configs import get_config
    return get_config(name).n_layers


def report_serve_mesh(r, card):
    """Print phase n's lines for one model and hold its checks."""
    c = r["cfg"]
    desc = (f"{c.n_layers} layers, d_model {c.d_model}, "
            + (f"heads of {c.rwkv.head_size}" if c.family == "ssm" else
               f"{c.n_heads} q / {c.n_kv_heads} KV heads of "
               f"{c.resolved_head_dim}") + f", vocab {c.vocab_size}")
    kname = "K2" if r["kernel"] == "wkv6" else "K3'"
    whole = "whole" if c.n_layers == get_config_layers(c.name) else \
        f"at {c.n_layers} layers"
    if r["held"]:
        lim = SERVE_LOGIT_TOL, SERVE_CACHE_TOL
    else:
        lim = (SERVE_WITNESS_FACTOR * r["witness"]["logit_err"],
               SERVE_WITNESS_FACTOR * r["witness"]["cache_err"])
    for mesh, run in r["runs"].items():
        where = ("unsharded on cuda:0" if mesh is None else
                 f"on a {mesh} ('data', 'model') mesh of cuda:0, cache "
                 f"specs {run['specs']}")
        line = (f"[n serve mesh] {c.name} {whole} ({desc}; {r['n_params']} "
                f"f32 parameters, drawn in {r['init_s']:.2f} s), prompts "
                f"{r['batch']} x {r['prompt']}, {r['new']} greedy tokens, "
                f"{where}, on {card}: prefill {run['prefill_s']:.4f} s, "
                f"decode {run['step_ms']:.3f} ms a step = "
                f"{run['tokens_s']:.1f} tokens/s, peak device memory "
                f"{run['peak'] / 2**30:.3f} GiB, one more decode step "
                f"profiled: idle share {run['idle']:.4f} "
                f"({run['n_events']} device activities); {kname} launches "
                f"per prefill {run['launches']} (expected "
                f"{run['expected']})")
        if mesh is not None:
            line += (f"; against the unsharded run: prefill logits within "
                     f"{run['logit_err']:.3e} of their largest magnitude "
                     f"(limit {lim[0]:.3e}), cache after the prefill "
                     f"gathered from its blocks within {run['cache_err']:.3e}"
                     f" ({run['cache_leaf']}; limit {lim[1]:.3e}), "
                     f"tokens equal {run['tokens_equal']}")
        print(line + f"; tokens of row 0 {run['tokens'][0].tolist()}",
              flush=True)
    if "witness" in r:
        w = r["witness"]
        print(f"[n serve mesh] {c.name} {whole}: not held to the limits "
              f"above (its depth amplifies f32 rounding): the unsharded "
              f"model with its embedding moved by one ulp departs from "
              f"itself by {w['logit_err']:.3e} in the prefill logits and "
              f"{w['cache_err']:.3e} in the cache ({w['cache_leaf']}); "
              f"its tokens are held equal, its distances within "
              f"{SERVE_WITNESS_FACTOR} times these", flush=True)
    if "k2" in r:
        k = r["k2"]
        print(f"[n serve mesh] K2 at a model position's prefill shape "
              f"{tuple(k['shape'])}: {k['ms'] * 1e3:.2f} us a launch ("
              + ("profiler" if k["device_timed"] else "not profiled: events")
              + f"), wrapper {k['wrapper_ms'] * 1e3:.2f} us/call, bound "
              f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}); against "
              f"wkv6_plain on the same inputs: max abs err "
              f"{k['max_abs_err']:.3e}, worst err / (atol + rtol |plain|) "
              f"{k['worst']:.4f} (rtol = atol = {WKV_TOL})", flush=True)
        check(k["worst"] <= 1.0, f"wkv6 at {tuple(k['shape'])} disagrees "
              f"with wkv6_plain beyond rtol = atol = {WKV_TOL} (max abs err "
              f"{k['max_abs_err']})")
    for mesh, run in r["runs"].items():
        check(run["launches"] == run["expected"],
              f"{c.name} {mesh}: {run['launches']} {kname} launches per "
              f"prefill, {run['expected']} expected")
        if mesh is None:
            continue
        check(run["tokens_equal"] and run["logit_err"] <= lim[0]
              and run["cache_err"] <= lim[1],
              f"{c.name} on {mesh}: departs from the unsharded serving: "
              f"logits {run['logit_err']}, cache {run['cache_err']} "
              f"({run['cache_leaf']}; limits {lim}), tokens equal "
              f"{run['tokens_equal']}")


def phase_serve_reduced(torch, FA, W, cases=SERVE_Y):
    """The reduced configs served and evaluated on a mesh of the card
    (phase y): per (arch, mesh, rows), weights drawn on cuda:0 from seed
    0, seeded prompts (rows, SERVE_Y_PROMPT) (Whisper's with seeded
    frames), a prefill and SERVE_Y_NEW - 1 greedy decode steps unsharded
    (the MoE layers in the mesh's token groups) and on the mesh
    (``place_model``), and one ``eval_step`` of a batch on the mesh
    (``make_eval_step(cfg, ctx)`` over ``init_train_state(..., ctx)``)
    against ``combine_parts`` of the unsharded ``loss_parts`` in the same
    groups.  Returns {arch: readings}."""
    import gc

    from repro_torch.configs import ShapeSpec, get_reduced
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory, sharded
    from repro_torch.models.layers.moe import moe_groups
    from repro_torch.parallelism import sharding
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    dev = torch.device("cuda:0")
    out = {}
    for arch, mesh, rows in cases:
        cfg = get_reduced(arch)
        ctx = make_ctx(make_train_mesh(mesh, device="cuda:0"))
        dp = ctx.dp_size

        def groups(n):
            return 1 if cfg.moe is None else moe_groups(dp, n,
                                                        cfg.moe.top_k)

        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (rows, SERVE_Y_PROMPT), generator=gen,
            dtype=torch.int32, device=dev)}
        if cfg.enc_dec:
            batch["frames"] = torch.randn((rows, 1500, cfg.d_model),
                                          generator=gen, device=dev)
        model = factory.init_params(0, cfg, device=dev)
        kern = W.wkv6 if cfg.family == "ssm" else FA.flash_attention
        got = {}
        for name, served, kw, greedy, gather in (
                ("unsharded", model, {}, lambda lg: torch.argmax(
                    lg, -1).to(torch.int32)[:, None], lambda lg: lg),
                ("sharded", factory.place_model(model, cfg, ctx),
                 {"ctx": ctx}, sharded.greedy,
                 lambda lg: sharding.gather(lg, dev))):
            def pre():
                kern.launches = 0
                extra = {} if kw else {"moe_groups": groups(
                    rows * SERVE_Y_PROMPT)}
                return factory.prefill(served, batch, cfg=cfg,
                                       max_len=SERVE_Y_MAX_LEN, **kw,
                                       **extra)

            def dec(cache, tok):
                extra = {} if kw else {"moe_groups": groups(rows)}
                return factory.decode(served, cache, {"tokens": tok},
                                      cfg=cfg, **kw, **extra)

            first, toks, prefill_s, decode_s, _ = serve_loop(
                torch, pre, dec, greedy, lambda lg, c: gather(lg),
                SERVE_Y_NEW)
            got[name] = {"logits": first, "tokens": toks,
                         "launches": kern.launches, "prefill_s": prefill_s,
                         "step_ms": decode_s * 1e3 / (SERVE_Y_NEW - 1)}
        data = to_device(make_batch_np(cfg, ShapeSpec(
            "y", SERVE_Y_PROMPT, rows, "train"), SERVE_SEED, 0), dev)
        with torch.no_grad():
            _, plain = factory.combine_parts([factory.loss_parts(
                model, data, cfg=cfg,
                moe_groups=groups(rows * SERVE_Y_PROMPT))], cfg=cfg)
        state = TS.init_train_state(model, cfg, OptConfig(**TRAIN_OPT),
                                    ctx=ctx)
        ev = TS.make_eval_step(cfg, ctx)(state, data)
        want, have = got["unsharded"], got["sharded"]
        out[arch] = {
            "cfg": cfg, "mesh": mesh, "rows": rows, "runs": got,
            "groups": groups(rows * SERVE_Y_PROMPT),
            "logit_err": float((have["logits"] - want["logits"]).abs().max()
                               / want["logits"].abs().max()),
            "tokens_equal": bool(torch.equal(have["tokens"],
                                             want["tokens"])),
            "expected": kernel_calls(cfg, mesh, SERVE_Y_PROMPT),
            "eval": {k: float(ev[k]) for k in ("loss", "ce", "aux")},
            "plain": {k: float(plain[k]) for k in ("loss", "ce", "aux")}}
        del model, state, got
        gc.collect()
    return out


def report_serve_reduced(yr, card):
    """Print phase y's serving lines and hold their checks."""
    for arch, r in yr.items():
        c, u, s_ = r["cfg"], r["runs"]["unsharded"], r["runs"]["sharded"]
        rel = {k: abs(r["eval"][k] - r["plain"][k])
               / max(abs(r["plain"][k]), 1e-30) for k in r["eval"]}
        print(f"[y serve reduced] {arch} reduced on a {r['mesh']} mesh of "
              f"cuda:0, {r['rows']} rows, prompt {SERVE_Y_PROMPT}, "
              f"{SERVE_Y_NEW} greedy tokens, max_len {SERVE_Y_MAX_LEN}, "
              f"MoE token groups {r['groups']}, on {card}: prefill "
              f"{s_['prefill_s']:.4f} s (unsharded {u['prefill_s']:.4f}), "
              f"decode {s_['step_ms']:.3f} ms a step (unsharded "
              f"{u['step_ms']:.3f}); kernel launches per prefill "
              f"{s_['launches']} (expected {r['expected']}; unsharded "
              f"{u['launches']}); prefill logits within "
              f"{r['logit_err']:.3e} of their largest magnitude (limit "
              f"{SERVE_LOGIT_TOL}), tokens equal {r['tokens_equal']}; "
              f"eval_step on the mesh {r['eval']} against the unsharded "
              f"forward {r['plain']} (relative {rel}, limit "
              f"{SERVE_Y_EVAL_RTOL})", flush=True)
        check(s_["launches"] == r["expected"]
              and r["logit_err"] <= SERVE_LOGIT_TOL and r["tokens_equal"]
              and max(rel.values()) <= SERVE_Y_EVAL_RTOL,
              f"{arch} reduced on {r['mesh']}: the sharded serving or eval "
              f"departs from the unsharded: {r['logit_err']}, tokens "
              f"{r['tokens_equal']}, eval {rel}, launches "
              f"{s_['launches']} of {r['expected']}")


def _state_bytes(args):
    """Bytes of the four state dicts among a quantum's arguments."""
    return sum(x.numel() * x.element_size() for a in args[:4]
               for x in a.values())


def quantum_bound(scfg, args, n_lanes):
    """The least time of one quantum of ``n_lanes`` lanes: each input
    read once, each output written once (the state twice, the trace and
    the scalars once), against the integer operations of every warp slot
    and cycle.  Returns (bound ms, 'bytes' or 'operations', bytes,
    operations)."""
    n_bytes = 2 * _state_bytes(args) + sum(
        x[0].numel() * x.element_size() * n_lanes
        for x in args[4].values()) + 4 * n_lanes * (2 * 7 + 4)
    n_ops = (scfg.quantum * n_lanes * scfg.n_sm * scfg.warps_per_sm
             * OPS_PER_SLOT)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops)


def phase_quantum(torch, Q):
    """sm_quantum against the eager SM phase (its plain version, on the
    card): one lane on seeded states, every leaf exact; four lanes at
    once, each with its own state, trace, instr_base, dynamic config and
    clock, against the eager SM phase over the same lanes and against four
    one-lane launches; then one quantum timed at the RTX 3080 Ti width for
    every lane count of LANE_COUNTS."""
    import dataclasses

    from repro_torch.convert import (QUANTUM_T0, random_lane_inputs,
                                     random_quantum_inputs, stack_lanes,
                                     to_torch)
    from repro_torch.sim.config import (RTX3080TI, SCHEDULERS, TINY,
                                        DynConfig, split_config,
                                        static_part)
    from repro_torch.sim.smcore import sm_quantum_eager

    rng = np.random.default_rng(20261017)
    t0 = torch.tensor([QUANTUM_T0], dtype=torch.int32, device="cuda")
    n_cases, n_lane_cases, n_leaves, bad, max_err = 0, 0, 0, [], 0

    def compare(tag, got, want):
        nonlocal n_leaves, max_err
        for g, w in zip(got, want):
            for k in w:
                n_leaves += 1
                err = int((g[k].long() - w[k].long()).abs().max())
                max_err = max(max_err, err)
                if g[k].dtype != w[k].dtype or err:
                    bad.append(f"{tag}/{k}")

    for name, over in QUANTUM_CASES:
        cfg = RTX3080TI if over is None else dataclasses.replace(TINY, **over)
        scfg = static_part(cfg)
        for sched in ("gto", "lrr"):
            _, dyn = split_config(cfg, {"sched": SCHEDULERS[sched]},
                                  device="cuda")
            dyn = dyn.map(lambda x: x[None])
            for ragged in (False, True, False, True):
                host = random_quantum_inputs(rng, scfg, ragged=ragged)
                args = [to_torch(stack_lanes([x]), "cuda") for x in host]
                got = Q.sm_quantum(*args, t0, scfg, dyn)
                want = sm_quantum_eager(*args, t0, scfg, dyn)
                compare(f"{name}/{sched}", got, want)
                for x, a in zip(host, args):
                    for k in x:
                        if not np.array_equal(np.asarray(x[k]),
                                              a[k][0].cpu().numpy()):
                            bad.append(f"{name}/{sched}/input {k} changed")
                n_cases += 1
        for ragged in (False, True):
            host, t0s, over_l = random_lane_inputs(rng, scfg, 4,
                                                   ragged=ragged)
            dyn = DynConfig.stack([split_config(cfg, o, device="cuda")[1]
                                   for o in over_l])
            args = [to_torch(x, "cuda") for x in host]
            tl = torch.as_tensor(t0s, device="cuda")
            before = Q.sm_quantum.launches
            got = Q.sm_quantum(*args, tl, scfg, dyn)
            if Q.sm_quantum.launches != before + 1:
                bad.append(f"{name}/lanes: not one launch")
            compare(f"{name}/lanes", got, sm_quantum_eager(*args, tl, scfg,
                                                           dyn))
            ones = [Q.sm_quantum(*({k: v[i:i + 1] for k, v in a.items()}
                                   for a in args), tl[i:i + 1], scfg,
                                 dyn.map(lambda x: x[i:i + 1]))
                    for i in range(4)]
            compare(f"{name}/lanes vs one-lane launches", got,
                    [{k: torch.cat([o[j][k] for o in ones]) for k in got[j]}
                     for j in range(4)])
            n_lane_cases += 1
    torch.cuda.synchronize()
    check(not bad, f"sm_quantum disagrees with the eager SM phase or with "
          f"one-lane launches: {bad[:8]} (max abs err {max_err})")
    # one quantum at the main path's width, for 1, 8 and 32 lanes
    scfg = static_part(RTX3080TI)
    host, t0s, over_l = random_lane_inputs(rng, scfg, max(LANE_COUNTS))
    dyn_all = DynConfig.stack([split_config(RTX3080TI, o, device="cuda")[1]
                               for o in over_l])
    by_lanes = []
    for n in LANE_COUNTS:
        args = [to_torch({k: v[:n] for k, v in x.items()}, "cuda")
                for x in host]
        tl = torch.as_tensor(t0s[:n], device="cuda")
        dyn = dyn_all.map(lambda x: x[:n])
        wrapper_ms = time_per_call(
            torch, lambda: Q.sm_quantum(*args, tl, scfg, dyn), 200)

        def launches():
            for _ in range(50):
                Q.sm_quantum(*args, tl, scfg, dyn)
        kern = kernel_us(torch, launches, "sm_quantum_kernel")
        bound, by, n_bytes, n_ops = quantum_bound(scfg, args, n)
        row = {"lanes": n,
               "ms": sum(kern) / len(kern) / 1e3 if kern else wrapper_ms,
               "device_timed": bool(kern), "wrapper_ms": wrapper_ms,
               "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
               "ops": n_ops}
        if n == 1:
            row["plain_ms"] = time_per_call(
                torch, lambda: sm_quantum_eager(*args, tl, scfg, dyn), 20)
        by_lanes.append(row)
    one = by_lanes[0]
    return {"cases": n_cases, "lane_cases": n_lane_cases,
            "leaves": n_leaves, "max_abs_err": max_err,
            "ms": one["ms"], "wrapper_ms": one["wrapper_ms"],
            "device_timed": one["device_timed"],
            "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
            "bound_by": one["bound_by"], "bytes": one["bytes"],
            "ops": one["ops"], "by_lanes": by_lanes}


class QuantumSteps:
    """Counts the engine's quantum steps (one per lockstep quantum of all
    lanes) while it is entered."""

    def __enter__(self):
        from repro_torch.core import engine
        self.engine, self.step, self.n = engine, engine.quantum_step, 0

        def counted(*args, **kw):
            self.n += 1
            return self.step(*args, **kw)
        engine.quantum_step = counted
        return self

    def __exit__(self, *exc):
        self.engine.quantum_step = self.step


def run_case(torch, K, Q, bench, scale, cfg, mode, max_cycles,
             eager=False):
    """One simulation on the card; ``eager`` runs the SM phase through
    the eager per-cycle loop (sm_issue once per cycle) in place of the
    fused kernel.  Returns (comparable stats, timeouts, wall s,
    sm_quantum launches, sm_issue launches, quantum steps)."""
    from repro_torch.core import stats as S
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.sim.config import static_part
    from repro_torch.sim.smcore import sm_quantum_eager
    from repro_torch.sim.workloads import resolve_workload

    w = resolve_workload(bench, scale)
    runner = make_sm_runner(cfg, mode)
    if eager:
        scfg = static_part(cfg)

        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            return sm_quantum_eager(warp, sm, req, stats_sm, trace, t0,
                                    scfg, dyn)
    st, wall, fused, issue, steps = _counted_run(
        torch, K, Q, lambda: simulate(w, cfg, runner, max_cycles=max_cycles,
                                      device="cuda"))
    out = S.finalize(st)
    return S.comparable(out), out["timeouts"], wall, fused, issue, steps


def _counted_run(torch, K, Q, fn):
    """``fn()`` with every launch count set to 0 just before and read
    just after; returns (result, wall s, sm_quantum launches, sm_issue
    launches, quantum steps)."""
    torch.cuda.synchronize()
    K.issue_select.launches = 0
    Q.sm_quantum.launches = 0
    with QuantumSteps() as steps:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, Q.sm_quantum.launches, K.issue_select.launches, \
        steps.n


def phase_sweep(torch, K, Q, full_golden):
    """The slice's main path at full width: launch/dse.py's default grid
    of SWEEP_LANES configs on the RTX 3080 Ti, swept over nn@0.5 and
    syrk@0.16 through ``sweep``, every lane against its solo run on the
    card (timeouts included) and the plain-config lanes against the
    pinned stats; then launch/zoo.py's grid of the three bundled traces x
    4 TINY configs, checked lane by lane against solo runs (``--check``).
    Each run counts its own launches and quantum steps."""
    from repro_torch.core import stats as S
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.core.plan import RunPlan
    from repro_torch.core.sweep import grid_sweep, sweep
    from repro_torch.launch.dse import default_grid, lane_signature
    from repro_torch.launch.zoo import check_grid_vs_solo
    from repro_torch.sim.config import RTX3080TI, TINY
    from repro_torch.sim.workloads import register_traces, zoo_workload
    from repro_torch.workloads import make_workload

    out = {"dse": {}, "launches": 0, "issue": 0}
    plan = RunPlan(max_cycles=1 << 17)
    cfgs = default_grid(RTX3080TI, SWEEP_LANES)
    plain = [i for i, c in enumerate(cfgs) if c == RTX3080TI]
    check(plain, "the default grid holds no plain RTX 3080 Ti lane")
    for bench, scale in SWEEP_CASES:
        w = make_workload(bench, scale=scale)
        r, wall, fused, issue, steps = _counted_run(
            torch, K, Q, lambda: sweep(w, cfgs, plan=plan, device="cuda"))
        check(fused == steps > 0 and issue == 0,
              f"{bench}@{scale} sweep: {fused} sm_quantum and {issue} "
              f"sm_issue launches for {steps} quanta")
        out["launches"] += fused
        out["issue"] += issue
        solo_wall, bad = 0.0, []
        for i, cfg in enumerate(cfgs if (bench, scale) in SWEEP_SOLO
                                else ()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                                       plan=plan, device="cuda"))
            solo_wall += time.perf_counter() - t0
            if lane_signature(solo) != lane_signature(r.stats[i]):
                bad.append(i)
        check(not bad, f"{bench}@{scale} sweep lanes {bad} differ from "
              "their solo runs on the card")
        key = f"{bench}@{scale}"
        for i in plain:
            check(S.comparable(r.stats[i]) == full_golden[key],
                  f"{key} sweep lane {i} (plain RTX 3080 Ti) differs from "
                  "the pinned stats")
        out["dse"][key] = {"wall": wall, "solo_wall": solo_wall,
                           "steps": steps, "cycles": r.cycles,
                           "timeouts": [s["timeouts"] for s in r.stats],
                           "plain": plain, "launches": fused}
    # the zoo grid of the bundled traces, --check
    names = register_traces(os.path.join(ROOT, "tests", "data", "traces"))
    ws = [zoo_workload(n) for n in names]
    tcfgs = default_grid(TINY, 4)
    grid, wall, fused, issue, steps = _counted_run(
        torch, K, Q, lambda: grid_sweep(ws, tcfgs, plan=RunPlan(
            max_cycles=1 << 15), device="cuda"))
    check(fused == steps > 0 and issue == 0,
          f"trace grid: {fused} sm_quantum and {issue} sm_issue launches "
          f"for {steps} quanta")
    out["launches"] += fused
    out["issue"] += issue
    n_checked = check_grid_vs_solo(grid, ws, tcfgs, 1 << 15, "cuda")
    out["grid"] = {"names": names, "lanes": n_checked, "wall": wall,
                   "steps": steps, "cycles": [[s["cycles"] for s in row]
                                              for row in grid.stats]}
    return out


def quantum_loop(w, cfgs, n_q):
    """A call of the quantum loop alone over the first ``n_q`` quanta of
    workload ``w``, one lane per config of ``cfgs``, from a fresh state."""
    from repro_torch.core.batch import stack_kernels
    from repro_torch.core.sweep import make_sweep_runner, stack_dyn
    from repro_torch.sim.state import init_state

    scfg, dyn = stack_dyn(cfgs, "cuda")
    stacked = stack_kernels([k.pack("cuda") for k in w.kernels])
    runner = make_sweep_runner(scfg, "vmap", n_q * scfg.quantum)
    state0 = init_state(scfg, "cuda", len(cfgs))
    return lambda: runner(state0, stacked, dyn)


def loop_profile(torch, w, cfgs, n_q=16, loop=None):
    """A profile of the quantum loop alone over the first ``n_q`` quanta
    of workload ``w`` with one lane per config of ``cfgs`` (or of ``loop``,
    a call that runs those quanta): kernel launches (and sm_quantum's)
    and device-to-host reads per quantum, device busy and idle share,
    wall."""
    events, pwall = profiled(torch, loop or quantum_loop(w, cfgs, n_q))
    kernels = [(name, us) for name, us in events
               if not name.startswith(("Memcpy", "Memset"))]
    busy = sum(us for _, us in events) / 1e6
    return {"profiled": bool(events),
            "launches_per_q": len(kernels) / n_q,
            "sm_quantum_per_q": sum("sm_quantum" in name
                                    for name, _ in kernels) / n_q,
            "dtoh_per_q": sum("DtoH" in name for name, _ in events) / n_q,
            "idle": 1 - busy / pwall, "busy": busy, "pwall": pwall}


def profile_text(row):
    if not row["profiled"]:
        return ("the profiler saw no device activity: launches, reads and "
                "idle share per quantum not measured")
    return (f"{row['launches_per_q']:.1f} kernel launches/quantum "
            f"({row['sm_quantum_per_q']:.1f} of sm_quantum), "
            f"{row['dtoh_per_q']:.2f} device-to-host reads/quantum, device "
            f"busy {row['busy']:.4f} s of {row['pwall']:.4f} s (idle share "
            f"{row['idle']:.4f})")


def phase_lanes(torch, K, Q):
    """LANES_CASE (syrk@0.16) swept over the default grid of L configs for
    every L of LANE_COUNTS: the sweep's wall, quanta and lane-quanta (each
    lane's cycles over Δ, summed); then a profile of the quantum loop
    alone over its first 16 quanta (``loop_profile``)."""
    from repro_torch.core.plan import RunPlan
    from repro_torch.core.sweep import sweep
    from repro_torch.launch.dse import default_grid
    from repro_torch.sim.config import RTX3080TI
    from repro_torch.workloads import make_workload

    w = make_workload(LANES_CASE[0], scale=LANES_CASE[1])
    rows = []
    for n in LANE_COUNTS:
        cfgs = default_grid(RTX3080TI, n)
        r, wall, fused, issue, steps = _counted_run(
            torch, K, Q, lambda: sweep(w, cfgs, plan=RunPlan(
                max_cycles=1 << 17), device="cuda"))
        check(fused == steps > 0 and issue == 0,
              f"sweep of {n} lanes: {fused} sm_quantum and {issue} "
              f"sm_issue launches for {steps} quanta")
        check(all(s["timeouts"] == 0 for s in r.stats),
              f"sweep of {n} lanes timed out")
        lane_quanta = sum(c // RTX3080TI.quantum for c in r.cycles)
        rows.append(dict(loop_profile(torch, w, cfgs), lanes=n, wall=wall,
                         steps=steps, lane_quanta=lane_quanta,
                         launches=fused))
    return rows


def phase_telemetry(torch, K, Q, full_golden):
    """Counter timelines on the card at full width, TELEMETRY_GOLDEN's
    knobs (64 rows every 16 quanta): nn@0.5 and syrk@0.16 solo, every row,
    ``lockstep_waste`` and ``telemetry_samples`` against the JAX
    package's golden, ``comparable()`` against the pinned stats, the last
    row against ``finalize``; dse's default grid of SWEEP_LANES configs
    over syrk@0.16, every lane's timeline against its solo card run; the
    traces' zoo grid x 4 TINY configs and syrk@0.16 at 32 lanes, each
    lane's last row against ``finalize``, with their lockstep waste; and
    profiles of 16 quanta of the loop with telemetry off and on at 1 and
    SWEEP_LANES lanes, and its wall timed in turns.  Each run counts its
    own launches."""
    from repro_torch.core import stats as S
    from repro_torch.core import telemetry as T
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.core.plan import RunPlan
    from repro_torch.core.stats import take_lane
    from repro_torch.core.sweep import grid_sweep, sweep
    from repro_torch.launch.dse import default_grid, lane_signature
    from repro_torch.sim.config import RTX3080TI, TINY
    from repro_torch.sim.workloads import register_traces, zoo_workload
    from repro_torch.workloads import make_workload

    with open(os.path.join(GOLDEN, TELEMETRY_GOLDEN)) as f:
        golden = json.load(f)
    plan = RunPlan(max_cycles=golden["max_cycles"],
                   telemetry_samples=golden["samples"],
                   telemetry_every=golden["every"])
    out = {"solo": {}, "launches": 0, "knobs": (golden["samples"],
                                                golden["every"])}

    def counted(fn, what):
        res, wall, fused, issue, steps = _counted_run(torch, K, Q, fn)
        check(fused == steps > 0 and issue == 0,
              f"{what}: {fused} sm_quantum and {issue} sm_issue launches "
              f"for {steps} quanta")
        out["launches"] += fused
        return res, wall, steps

    def solo(w, cfg):
        [cfg] = plan.apply_telemetry([cfg])
        st = simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                      plan=RunPlan(max_cycles=plan.max_cycles),
                      device="cuda")
        return st, S.finalize(st)

    def record(tl, stats):
        return {"timeline": np.asarray(tl).tolist(),
                "lockstep_waste": stats["lockstep_waste"],
                "telemetry_samples": stats["telemetry_samples"]}

    for bench, scale in SWEEP_CASES:
        key = f"{bench}@{scale}"
        w = make_workload(bench, scale=scale)
        (st, fin), wall, steps = counted(lambda: solo(w, RTX3080TI),
                                         f"{key} with telemetry")
        got = record(T.timeline(st), fin)
        check(got == golden["cases"][key], f"{key}: the timeline, waste or "
              f"sample count differs from {TELEMETRY_GOLDEN}")
        check(S.comparable(fin) == full_golden[key] and fin["timeouts"] == 0,
              f"{key} with telemetry differs from the pinned stats")
        bad = T.check_final_sample(st, fin)
        check(not bad, f"{key}: last row != finalize on {bad}")
        out["solo"][key] = {"wall": wall, "steps": steps,
                            "waste": fin["lockstep_waste"],
                            "samples": fin["telemetry_samples"]}

    # dse's default grid: every lane against its solo run
    bench, scale = TELEMETRY_LANES_CASE
    w = make_workload(bench, scale=scale)
    cfgs = default_grid(RTX3080TI, SWEEP_LANES)
    r, wall, steps = counted(lambda: sweep(w, cfgs, plan=plan,
                                           device="cuda"),
                             f"{bench}@{scale} sweep with telemetry")
    tls, bad = r.timelines(), []
    for i, cfg in enumerate(cfgs):
        st, fin = solo(w, cfg)
        if (record(T.timeline(st), fin) != record(tls[str(i)], r.stats[i])
                or lane_signature(fin) != lane_signature(r.stats[i])
                or T.check_final_sample(take_lane(r.state, i), r.stats[i])):
            bad.append(i)
    check(not bad, f"{bench}@{scale} sweep lanes {bad}: timeline or stats "
          "differ from their solo runs on the card")
    out["dse"] = {"wall": wall, "steps": steps,
                  "waste": [s["lockstep_waste"] for s in r.stats],
                  "quanta": [c // RTX3080TI.quantum for c in r.cycles]}

    # lockstep waste of unlike workloads: the traces' zoo grid
    names = register_traces(os.path.join(ROOT, "tests", "data", "traces"))
    ws = [zoo_workload(n) for n in names]
    tcfgs = default_grid(TINY, 4)
    grid, wall, steps = counted(lambda: grid_sweep(
        ws, tcfgs, plan=RunPlan(max_cycles=1 << 15,
                                telemetry_samples=plan.telemetry_samples,
                                telemetry_every=plan.telemetry_every),
        device="cuda"), "trace grid with telemetry")
    bad = [(n, c) for i, n in enumerate(names) for c in range(len(tcfgs))
           if T.check_final_sample(grid.lane_state(i, c), grid.stats[i][c])]
    check(not bad, f"trace grid lanes {bad}: last row != finalize")
    out["grid"] = {"names": names, "wall": wall, "steps": steps,
                   "waste": [[s["lockstep_waste"] for s in row]
                             for row in grid.stats],
                   "quanta": [[s["cycles"] // TINY.quantum for s in row]
                              for row in grid.stats]}

    # and over 32 lanes
    n = max(LANE_COUNTS)
    cfgs32 = default_grid(RTX3080TI, n)
    r, wall, steps = counted(lambda: sweep(w, cfgs32, plan=plan,
                                           device="cuda"),
                             f"{bench}@{scale} x {n} lanes with telemetry")
    bad = [i for i in range(n)
           if T.check_final_sample(take_lane(r.state, i), r.stats[i])]
    check(not bad, f"{n}-lane sweep lanes {bad}: last row != finalize")
    out["lanes32"] = {"lanes": n, "wall": wall, "steps": steps,
                      "waste": [s["lockstep_waste"] for s in r.stats],
                      "quanta": [c // RTX3080TI.quantum for c in r.cycles]}

    # what telemetry costs the loop: 16 quanta off and on under the
    # profiler in a fresh process, then TURN_QUANTA quanta timed here in
    # turns off, on, on, off
    out["profiles"], out["turns"] = fresh_telemetry_profiles(), {}
    for n in (1, SWEEP_LANES):
        cfgs = default_grid(RTX3080TI, n)
        walls = {False: [], True: []}
        for on in (False, True, True, False) * TURNS:
            fn = quantum_loop(w, plan.apply_telemetry(cfgs) if on else cfgs,
                              TURN_QUANTA)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[on].append(time.perf_counter() - t0)
        out["turns"][n] = walls
        off = out["profiles"][n, False]
        if off["profiled"]:
            check(abs(off["launches_per_q"] - LOOP_LAUNCHES_PER_Q[n]) <= 1.0,
                  f"telemetry off, {n} lane(s): {off['launches_per_q']} "
                  f"launches per quantum, not {LOOP_LAUNCHES_PER_Q[n]}")
    return out


def telemetry_profiles():
    """``loop_profile`` of LANES_CASE over the dse default grid of 1 and
    SWEEP_LANES configs, telemetry off and on (TELEMETRY_GOLDEN's knobs),
    as {"<lanes>,<0|1>": row}."""
    import torch

    from repro_torch.core.plan import RunPlan
    from repro_torch.launch.dse import default_grid
    from repro_torch.sim.config import RTX3080TI
    from repro_torch.workloads import make_workload

    with open(os.path.join(GOLDEN, TELEMETRY_GOLDEN)) as f:
        golden = json.load(f)
    plan = RunPlan(telemetry_samples=golden["samples"],
                   telemetry_every=golden["every"])
    w = make_workload(LANES_CASE[0], scale=LANES_CASE[1])
    rows = {}
    for n in (1, SWEEP_LANES):
        cfgs = default_grid(RTX3080TI, n)
        for on in (False, True):
            rows[f"{n},{int(on)}"] = loop_profile(
                torch, w, plan.apply_telemetry(cfgs) if on else cfgs)
    return rows


def fresh_telemetry_profiles():
    """``telemetry_profiles`` in a fresh process: there every window of
    the same loop reads the same kernel count, while late in this long
    process a window reads up to ~1.4 kernels per quantum fewer.
    Returns {(lanes, on): row}."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.telemetry_profiles()))")
    proc = subprocess.run(
        [sys.executable, "-c", code, ROOT, os.path.join(ROOT, "src")],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "the telemetry profiles' process failed: "
          f"{proc.stderr[-2000:]}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(int(k.split(",")[0]), k.endswith(",1")): v
            for k, v in rows.items()}


def search_record(result):
    """Everything of a SearchResult but its timings, as plain JSON (the
    form of SEARCH_GOLDEN's result)."""
    timing = ("analytic_s", "analytic_cands_per_s", "verify_s",
              "verify_lanes_per_s")
    return json.loads(json.dumps({
        "seed": result.seed, "space": [list(result.space.lo),
                                       list(result.space.hi)],
        "features": result.features.tolist(),
        "best": {k: list(v) if isinstance(v, tuple) else v
                 for k, v in result.best.items()},
        "best_cycles": result.best_cycles,
        "theta": result.model.theta.tolist(), "calib": result.model.calib,
        "rounds": [{k: v for k, v in r.items() if k not in timing}
                   for r in result.rounds],
        "verified": [[np.asarray(v).tolist(), int(c)]
                     for v, c, _ in result.verified],
    }))


def search_case(rounds=None):
    """(SEARCH_GOLDEN's contents, its workload, ``search``'s keywords for
    its case, cut to ``rounds`` rounds where given)."""
    from repro_torch.core.plan import RunPlan
    from repro_torch.launch.cli import base_config
    from repro_torch.workloads import make_workload

    with open(os.path.join(GOLDEN, SEARCH_GOLDEN)) as f:
        golden = json.load(f)
    case = golden["case"]
    w = make_workload(case["workload"], scale=case["scale"])
    kw = dict(plan=RunPlan(max_cycles=case["max_cycles"],
                           search_rounds=rounds or case["rounds"],
                           search_topk=case["topk"]),
              seed=case["seed"], base=base_config(case["base"]),
              n_candidates=case["n_candidates"], calibrate_from=None)
    return golden, w, kw


def cpu_search():
    """{"record": ``search_record`` of SEARCH_GOLDEN's case cut to
    SEARCH_CPU_ROUNDS rounds, searched on the CPU, "wall": its seconds}:
    the body of ``start_cpu_search``'s child."""
    import torch
    torch.set_num_threads(CPU_SEARCH_THREADS)
    from repro_torch.core.search import search
    _, w, kw = search_case(SEARCH_CPU_ROUNDS)
    t0 = time.perf_counter()
    res = search(w, device="cpu", **kw)
    return {"record": search_record(res), "wall": time.perf_counter() - t0}


def start_cpu_search():
    """``cpu_search`` in a child process, started beside the card phases
    (it needs no card; its verify sweeps on the CPU are the smoke's
    longest host-only work), which phase r joins."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import chip_smoke; print(json.dumps(chip_smoke.cpu_search()))")
    return start_child(
        [sys.executable, "-c", code, ROOT, os.path.join(ROOT, "src")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_search(torch, K, Q, cpu_proc):
    """The seeded analytic-prune search of SEARCH_GOLDEN's case (nn@0.5 on
    the RTX 3080 Ti, seed 0, 3 rounds of 256 candidates, top 8) with its
    verify sweeps on the card: (a) the case cut to SEARCH_CPU_ROUNDS
    rounds on the card equal, in full, to the same on the CPU
    (``cpu_proc``, ``start_cpu_search``'s child); (b) round 0's verified
    set equal to the JAX package's golden, and equal cycles on every
    vector both measured; then ``python -m repro_torch.launch.dse --base
    3080ti --workload nn --scale 0.5 --search --search-rounds 1
    --check``, in this process."""
    import io

    from repro_torch.core.search import search
    from repro_torch.launch import dse

    golden, w, kw = search_case()
    case = golden["case"]
    card, wall, fused, issue, steps = _counted_run(
        torch, K, Q, lambda: search(w, device="cuda", **kw))
    check(fused == steps > 0 and issue == 0,
          f"search: {fused} sm_quantum and {issue} sm_issue launches for "
          f"{steps} quanta")
    # the card against the CPU in full, at SEARCH_CPU_ROUNDS rounds (the
    # CPU's verify sweeps are the smoke's slowest part)
    _, _, kw1 = search_case(SEARCH_CPU_ROUNDS)
    card1, _, fused1, _, _ = _counted_run(
        torch, K, Q, lambda: search(w, device="cuda", **kw1))
    t0 = time.perf_counter()
    text, err = cpu_proc.communicate(timeout=900)
    wait_s = time.perf_counter() - t0
    check(cpu_proc.returncode == 0, f"the CPU search's process exited "
          f"{cpu_proc.returncode}: {err[-2000:]}")
    cpu = json.loads(text.strip().splitlines()[-1])
    got, want = search_record(card), golden["result"]
    check(search_record(card1) == cpu["record"], "the search on the "
          "card differs from the same search on the CPU")
    topk = case["topk"]

    def as_set(rows):
        return sorted((tuple(v), c) for v, c in rows)
    check(as_set(got["verified"][:topk]) == as_set(want["verified"][:topk]),
          f"round 0's verified set differs from {SEARCH_GOLDEN}")
    theirs = {tuple(v): c for v, c in want["verified"]}
    shared = [(tuple(v), c) for v, c in got["verified"]
              if tuple(v) in theirs]
    bad = [v for v, c in shared if theirs[v] != c]
    check(not bad, f"{len(bad)} vectors measured by both the card and "
          f"{SEARCH_GOLDEN} differ in cycles")
    out = {"wall": wall, "cpu_wall": cpu["wall"], "cpu_wait": wait_s,
           "steps": steps,
           "launches": fused + fused1, "shared": len(shared),
           "n_verified": len(got["verified"]), "equal_golden": got == want,
           "best": card.best_cycles, "golden_best": want["best_cycles"],
           "rounds": [{k: r[k] for k in ("round", "n_scored", "verify_s",
                                         "analytic_s", "rank_corr",
                                         "best_measured")}
                      for r in card.rounds]}
    argv = ["--base", "3080ti", "--workload", case["workload"], "--scale",
            str(case["scale"]), "--search", "--search-rounds",
            str(SEARCH_CPU_ROUNDS), "--check"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, dse_wall, fused, issue, steps = _counted_run(
            torch, K, Q, lambda: dse.main(argv))
    lines = buf.getvalue().strip().splitlines()
    check(lines and lines[-1].startswith("[dse] check OK") and issue == 0
          and fused == steps > 0, f"dse {' '.join(argv)}: "
          f"{lines[-3:]} ({fused} sm_quantum, {issue} sm_issue launches for "
          f"{steps} quanta)")
    out.update(launches=out["launches"] + fused, dse_wall=dse_wall,
               dse_argv=" ".join(argv), dse_lines=lines[-3:])
    return out


def serve_subs():
    """Phase v's submissions: SERVE_CASES as they are, the first with a
    config override, the bundled SERVE_TRACES uploaded as text, and a
    sample grid of SERVE_SAMPLE_LANES lanes over the first."""
    (nn, nn_s), (other, other_s) = SERVE_CASES
    subs = [{"id": f"{nn}@{nn_s}", "workload": nn, "scale": nn_s},
            {"id": f"{other}@{other_s}", "workload": other,
             "scale": other_s},
            {"id": "cfg", "workload": nn, "scale": nn_s,
             "config": {"l2_lat": 64, "scheduler": "lrr"}}]
    for name in SERVE_TRACES:
        with open(os.path.join(ROOT, "tests", "data", "traces",
                               f"{name}.trace")) as f:
            subs.append({"id": name, "trace_text": f.read()})
    subs.append({"id": "grid", "workload": nn, "scale": nn_s,
                 "sample": {"n": SERVE_SAMPLE_LANES,
                            "lat": [["fp32", 2, 8]]}})
    return subs


def serve_plan(max_cycles=1 << 20):
    from repro_torch.core.plan import RunPlan
    return RunPlan(max_cycles=max_cycles, bucket_by="shape")


def serve_sync(torch, K, Q, batches):
    """A fresh synchronous server on the card (RTX 3080 Ti base) serving
    each list of submissions of ``batches`` as one batch, its launch
    counts set to 0 just before and read just after.  Returns ({id: the
    job}, [batch walls], sm_quantum launches, quanta)."""
    from repro_torch.core.service import SimService
    from repro_torch.sim.config import RTX3080TI

    svc = SimService(base=RTX3080TI, plan=serve_plan(), start=False)
    check(svc.device.type == "cuda", f"the server chose {svc.device}")
    jobs, walls, launches, quanta = {}, [], 0, 0
    for group in batches:
        mine = [svc.submit(s) for s in group]
        n, wall, fused, issue, steps = _counted_run(torch, K, Q,
                                                    svc.run_pending)
        check(n == len(mine) and all(j.done and j.error is None
                                     for j in mine),
              f"a served batch failed: {[j.response() for j in mine]}")
        check(fused == steps > 0 and issue == 0,
              f"served batch: {fused} sm_quantum and {issue} sm_issue "
              f"launches for {steps} quanta of its bucket runs")
        jobs.update((j.id, j) for j in mine)
        walls.append(wall)
        launches += fused
        quanta += steps
    return jobs, walls, launches, quanta


def served_launches(torch, sub, n_q):
    """A profile of one synchronous served batch of ``sub`` cut at
    ``n_q`` quanta: (kernels, sm_quantum kernels, quanta, profiled)."""
    from repro_torch.core.service import SimService
    from repro_torch.sim.config import RTX3080TI

    svc = SimService(base=RTX3080TI, plan=serve_plan(
        n_q * RTX3080TI.quantum), start=False)
    svc.submit(sub)
    with QuantumSteps() as steps:
        events, _ = profiled(torch, svc.run_pending)
    kernels = [n for n, _ in events if not n.startswith(("Memcpy",
                                                         "Memset"))]
    return (len(kernels), sum("sm_quantum" in n for n in kernels), steps.n,
            bool(events))


_CHILDREN = []                   # every child process the smoke starts


def start_child(args, **kw):
    """``subprocess.Popen(args, **kw)``, registered for ``stop_children``."""
    proc = subprocess.Popen(args, **kw)
    _CHILDREN.append(proc)
    return proc


def stop_children():
    """Kill every child process that is still running."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def _child_env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path
                                              if path else ""))


def _serve_child(args, **kw):
    return start_child(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=_child_env(), text=True, **kw)


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)


def _session_lines(subs):
    """A client's session: the submissions, a malformed one, flush, stats
    and shutdown, one JSON object a line."""
    return ([json.dumps(dict(s, op="submit")) for s in subs]
            + [json.dumps({"op": "submit", "workload": 7}),
               json.dumps({"op": "flush"}), json.dumps({"op": "stats"}),
               json.dumps({"op": "shutdown"})])


def _check_session(replies, subs, want, where):
    """Every reply of a session: the acks, one rejection naming
    'workload', flushed, stats, draining, and one completion per
    submission whose stats equal ``want`` (comparable() by id)."""
    done = {r["id"]: r for r in replies if r.get("status") == "done"}
    acks = [r["id"] for r in replies if r.get("status") == "queued"]
    bad = [r for r in replies if r.get("ok") is False]
    check(sorted(acks) == sorted(s["id"] for s in subs),
          f"{where}: acks {acks}")
    check(len(bad) == 1 and bad[0].get("field") == "workload",
          f"{where}: rejections {bad}")
    check(any(r.get("status") == "flushed" for r in replies)
          and any(r.get("status") == "draining" for r in replies)
          and any("submitted" in r for r in replies),
          f"{where}: no flushed, draining or stats reply")
    check(sorted(done) == sorted(s["id"] for s in subs),
          f"{where}: completions for {sorted(done)}")
    for s in subs:
        check(done[s["id"]]["stats"] == want[s["id"]],
              f"{where}: {s['id']}'s lanes differ from the in-process "
              "server's")


def start_selftest():
    """``serve --selftest`` in a child process on the card, started at
    phase v's beginning beside the in-process server; a thread reads its
    output and notes when it ends."""
    import threading
    proc = _serve_child(["--selftest"], stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT)
    run = {"proc": proc, "t0": time.perf_counter()}

    def read():
        run["text"] = proc.communicate()[0]
        run["end"] = time.perf_counter()
    run["thread"] = threading.Thread(target=read, daemon=True)
    run["thread"].start()
    return run


def serve_children(want, selftest):
    """The frontends in child processes on the card: a scripted stdin
    session (``--stdin --base 3080ti``), timed from the start to its
    first completion; then a socket session on ``--port 0``; and the
    end of ``selftest`` (``start_selftest``'s).  ``want``: {id:
    comparable() per lane} of the in-process server."""
    subs = [s for s in serve_subs() if s["id"] in CHILD_IDS]
    out = {}
    # stdin, alone: the cold child's time to its first completion
    t0 = time.perf_counter()
    proc = _serve_child(["--stdin", "--base", "3080ti"],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                        stderr=subprocess.DEVNULL)
    try:
        proc.stdin.write("\n".join(_session_lines(subs)) + "\n")
        proc.stdin.close()
        replies, first = [], None
        for line in proc.stdout:
            replies.append(json.loads(line))
            if first is None and replies[-1].get("status") == "done":
                first = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
    finally:
        _stop(proc)
    check(rc == 0, f"the stdin server exited {rc}")
    _check_session(replies, subs, want, "stdin server")
    out.update(stdin_first_s=first, stdin_s=time.perf_counter() - t0,
               stdin_lines=len(replies))
    # the socket session
    sock = _serve_child(["--port", "0", "--base", "3080ti"],
                        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        out.update(socket_session(sock, subs, want))
        rc = sock.wait(timeout=600)
        check(rc == 0, f"the socket server exited {rc}")
        selftest["thread"].join(timeout=900)
    finally:
        _stop(sock)
        _stop(selftest["proc"])
    proc = selftest["proc"]
    check(not selftest["thread"].is_alive(), "serve --selftest did not end")
    lines = selftest["text"].strip().splitlines()
    check(proc.returncode == 0 and lines
          and lines[-1].startswith("[selftest] PASS"),
          f"serve --selftest exited {proc.returncode}: {lines[-5:]}")
    out.update(selftest_s=selftest["end"] - selftest["t0"],
               selftest_lines=[ln for ln in lines
                               if ln.startswith("[selftest]")][:3])
    return out


def socket_session(proc, subs, want):
    """One client of a socket server started with ``--port 0``: the port
    from its ``listening on`` line, the session, and every completion on
    this connection."""
    import re
    import socket
    import threading

    port = None
    for line in proc.stderr:
        m = re.search(r"listening on [0-9.]+:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    check(port, "the socket server never said where it listens")
    drain = threading.Thread(target=lambda: proc.stderr.read(), daemon=True)
    drain.start()
    with socket.create_connection(("127.0.0.1", port), timeout=600) as conn:
        f = conn.makefile("rw")
        lines = _session_lines(subs)
        for line in lines[:-1]:                 # all but the shutdown
            f.write(line + "\n")
        f.flush()
        replies = []
        while sum(r.get("status") == "done" for r in replies) < len(subs):
            line = f.readline()
            check(line, "the socket server closed the connection early")
            replies.append(json.loads(line))
        f.write(lines[-1] + "\n")
        f.flush()
        replies.append(json.loads(f.readline()))
    _check_session(replies, subs, want, "socket server")
    return {"socket_lines": len(replies), "port": port}


class GroupSteps:
    """Counts the quantum steps of 'sm' groups (one per quantum of each
    group of a mesh) while it is entered."""

    def __enter__(self):
        from repro_torch.core import parallel
        self.mod, self.make, self.n = parallel, parallel.make_shard_body, 0

        def make(*args, **kw):
            body = self.make(*args, **kw)

            def counted(*a):
                self.n += 1
                return body(*a)
            return counted
        parallel.make_shard_body = make
        return self

    def __exit__(self, *exc):
        self.mod.make_shard_body = self.make


def _mesh_counted(torch, K, Q, fn):
    """``fn()`` with every launch count set to 0 just before and read
    just after; returns (result, wall s, sm_quantum launches, sm_issue
    launches, group quantum steps)."""
    torch.cuda.synchronize()
    K.issue_select.launches = 0
    Q.sm_quantum.launches = 0
    with GroupSteps() as steps:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, Q.sm_quantum.launches, K.issue_select.launches, \
        steps.n


def one_card(torch, n):
    """``n`` mesh positions on the current card."""
    return [torch.device("cuda", torch.cuda.current_device())] * n


def shard_run(torch, K, Q, bench, scale, cfg, policy, exchange, max_cycles,
              devices=None):
    """One workload through ``run_workload`` with ``run_kernel_sharded``
    over a 1-D mesh of SHARD_DEVICES positions, ``devices`` or the card
    repeated.  Returns (comparable stats, timeouts, wall s, sm_quantum
    launches, sm_issue launches, quanta)."""
    from repro_torch.core import stats as S
    from repro_torch.core.engine import run_workload
    from repro_torch.core.parallel import (permute_state, run_kernel_sharded,
                                           sm_permutation)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sim.config import split_config
    from repro_torch.sim.state import init_state
    from repro_torch.sim.workloads import resolve_workload

    w = resolve_workload(bench, scale)
    scfg, dyn = split_config(cfg, device="cuda")
    mesh = make_host_mesh(SHARD_DEVICES, devices=devices or one_card(
        torch, SHARD_DEVICES))

    def run():
        state = permute_state(init_state(scfg, "cuda", 1),
                              sm_permutation(cfg, SHARD_DEVICES, policy))
        return run_workload(
            state, [k.pack("cuda") for k in w.kernels], scfg, dyn,
            kernel_runner=lambda st, k, d: run_kernel_sharded(
                st, k, cfg, mesh, max_cycles=max_cycles, exchange=exchange,
                dyn=d))
    st, wall, fused, issue, steps = _mesh_counted(torch, K, Q, run)
    out = S.finalize(S.take_lane(st, 0))
    return S.comparable(out), out["timeouts"], wall, fused, issue, steps


def mesh_loop(w, cfgs, mesh, n_q):
    """A call of the mesh sweep runner alone over the first ``n_q`` quanta
    of every 'cfg' group, one lane per config of ``cfgs``, from a state
    placed once."""
    from repro_torch.core import distribute as D
    from repro_torch.core.batch import stack_kernels
    from repro_torch.core.sweep import stack_dyn
    from repro_torch.sim.state import init_state

    scfg, dyn = stack_dyn(cfgs, "cuda")
    stacked = stack_kernels([k.pack("cuda") for k in w.kernels])
    runner = D.make_dist_sweep_runner(scfg, mesh, n_q * scfg.quantum)
    args = (D.place_state(init_state(scfg, "cuda", len(cfgs)), mesh,
                          D.CFG_AXIS),
            D.place_lanes(stacked, mesh, ()), D.place_lanes(dyn, mesh))
    return lambda: runner(*args)


def _launcher_run(main, argv):
    """A launcher's ``main(argv)`` with its stdout captured: (lines, error
    text or None)."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
        err = None
    except (AssertionError, RuntimeError, ValueError) as e:
        err = f"{type(e).__name__}: {e}"
    return buf.getvalue().strip().splitlines(), err


def phase_mesh(torch, K, Q, tiny_golden, full_golden):
    """SM-axis sharding and the 2-D ('cfg','sm') mesh on one card, every
    mesh position repeating it (the counterpart of the reference's forced
    host devices): measures, records what disagrees, checks nothing —
    main prints every reading first.

      · SWEEP_CASES at full width through ``run_workload`` with
        ``run_kernel_sharded`` over SHARD_DEVICES positions, static and
        dynamic assignment, window exchange: stats, timeouts, launches;
      · SHARD_CYCLE_CASES on TINY at SHARD_DEVICES, per-cycle exchange
        (sm_issue every cycle, no sm_quantum);
      · dse's default grid of SWEEP_LANES configs over MESH_CASE at every
        shape of MESH_SHAPES against the card's no-mesh sweep, lane by
        lane with timeouts, each with a profile of MESH_PROFILE_QUANTA
        quanta of the mesh runner; telemetry at MESH_TELEMETRY_SHAPE
        against the no-mesh timelines;
      · ``dse --mesh 2 2 --check`` and ``zoo --trace ... --grid 3 4
        --mesh 1 2 --check`` through ``main()``, on ``--device`` the
        card (every position)."""
    from repro_torch.core import stats as S
    from repro_torch.core import telemetry as T
    from repro_torch.core.distribute import make_mesh
    from repro_torch.core.plan import RunPlan
    from repro_torch.core.sweep import sweep
    from repro_torch.launch import dse, zoo
    from repro_torch.launch.dse import default_grid, lane_signature
    from repro_torch.sim.config import RTX3080TI, TINY
    from repro_torch.workloads import make_workload

    out = {"bad": [], "shard": [], "cycle": [], "mesh": [], "launches": 0,
           "issue": 0}
    for bench, scale in SWEEP_CASES:
        key = f"{bench}@{scale}"
        for policy in ("static", "dynamic"):
            got, to, wall, fused, issue, steps = shard_run(
                torch, K, Q, bench, scale, RTX3080TI, policy, "window",
                1 << 17)
            quanta = steps
            out["shard"].append(dict(key=key, policy=policy, wall=wall,
                                     launches=fused, issue=issue,
                                     quanta=quanta, timeouts=to))
            out["launches"] += fused
            if got != full_golden[key] or to != 0:
                out["bad"].append(f"{key} {policy}/window at "
                                  f"{SHARD_DEVICES} shards: stats or "
                                  f"timeouts {to} differ from the pinned")
            if not (fused == SHARD_DEVICES * quanta > 0 and issue == 0):
                out["bad"].append(f"{key} {policy}/window: {fused} "
                                  f"sm_quantum and {issue} sm_issue "
                                  f"launches for {quanta} quanta")
    for bench, scale in SHARD_CYCLE_CASES:
        key = f"{bench}@{scale}"
        got, to, wall, fused, issue, steps = shard_run(
            torch, K, Q, bench, scale, TINY, "dynamic", "cycle", 1 << 15)
        out["cycle"].append(dict(key=key, wall=wall, launches=fused,
                                 issue=issue, quanta=steps, timeouts=to))
        out["issue"] += issue
        if got != tiny_golden[key] or to != 0:
            out["bad"].append(f"{key} dynamic/cycle: stats or timeouts {to}"
                              " differ from determinism_tiny.json")
        if not (fused == 0 and issue > 0):
            out["bad"].append(f"{key} dynamic/cycle: {fused} sm_quantum and "
                              f"{issue} sm_issue launches")
    # the 2-D mesh: dse's default grid over MESH_CASE
    cfgs = default_grid(RTX3080TI, SWEEP_LANES)
    w = make_workload(MESH_CASE[0], scale=MESH_CASE[1])
    plan = dict(max_cycles=1 << 17)
    ref, ref_wall, _, _, _ = _counted_run(
        torch, K, Q, lambda: sweep(w, cfgs, plan=RunPlan(**plan),
                                   device="cuda"))
    want = [lane_signature(st) for st in ref.stats]
    out["nomesh"] = dict(loop_profile(torch, w, cfgs, MESH_PROFILE_QUANTA),
                         wall=ref_wall)
    for a, b in MESH_SHAPES:
        mesh = make_mesh(a, b, devices=one_card(torch, a * b))
        r, wall, fused, issue, steps = _mesh_counted(
            torch, K, Q, lambda: sweep(w, cfgs, plan=RunPlan(
                mesh=mesh, **plan), device="cuda"))
        out["launches"] += fused
        prof = loop_profile(torch, w, cfgs, MESH_PROFILE_QUANTA,
                            mesh_loop(w, cfgs, mesh, MESH_PROFILE_QUANTA))
        out["mesh"].append(dict(prof, shape=(a, b), wall=wall,
                                launches=fused, issue=issue,
                                group_steps=steps))
        got = [lane_signature(st) for st in r.stats]
        if got != want:
            out["bad"].append(f"{a}x{b} mesh: lanes "
                              f"{[i for i, (g, x) in enumerate(zip(got, want)) if g != x]}"
                              " differ from the no-mesh sweep")
        if not (fused == b * steps > 0 and issue == 0):
            out["bad"].append(f"{a}x{b} mesh: {fused} sm_quantum and "
                              f"{issue} sm_issue launches for {steps} group "
                              "quanta")
    # counter timelines on the mesh against the no-mesh timelines
    a, b = MESH_TELEMETRY_SHAPE
    tplan = dict(plan, telemetry_samples=64, telemetry_every=16)
    t_ref = sweep(w, cfgs, plan=RunPlan(**tplan), device="cuda")
    t_mesh, t_wall, fused, _, _ = _mesh_counted(
        torch, K, Q, lambda: sweep(w, cfgs, plan=RunPlan(
            mesh=make_mesh(a, b, devices=one_card(torch, a * b)), **tplan),
            device="cuda"))
    out["launches"] += fused
    tls, ref_tls = t_mesh.timelines(), t_ref.timelines()
    rows = sum(len(v) for v in tls.values())
    same = (tls.keys() == ref_tls.keys()
            and all(np.array_equal(tls[k], ref_tls[k]) for k in tls)
            and [s["lockstep_waste"] for s in t_mesh.stats]
            == [s["lockstep_waste"] for s in t_ref.stats])
    finals = [T.check_final_sample(S.take_lane(t_mesh.state, i), st)
              for i, st in enumerate(t_mesh.stats)]
    out["telemetry"] = dict(wall=t_wall, rows=rows, same=same,
                            waste=[s["lockstep_waste"] for s in t_mesh.stats])
    if not same or any(finals):
        out["bad"].append(f"{a}x{b} mesh with telemetry: timelines or "
                          f"lockstep waste differ from the no-mesh run, or "
                          f"last rows {finals} differ from finalize")
    # the launchers through main(), on the card at every position
    card = str(one_card(torch, 1)[0])
    traces = os.path.join(ROOT, "tests", "data", "traces")
    out["launchers"] = {}
    for name, main, argv, ok_line in (
            ("dse", dse.main,
             ["--base", "3080ti", "--workload", MESH_CASE[0], "--scale",
              str(MESH_CASE[1]), "--n", str(SWEEP_LANES), "--mesh", "2",
              "2", "--device", card, "--check", "--no-manifest"],
             f"[dse] check OK: all {SWEEP_LANES} lanes bit-exact vs solo"),
            ("zoo", zoo.main,
             ["--trace", traces, "--grid", "3", "4", "--mesh", "1", "2",
              "--device", card, "--check", "--no-manifest"],
             "[zoo] check OK: all 12 lanes bit-exact vs solo runs")):
        (lines, err), wall, fused, issue, steps = _mesh_counted(
            torch, K, Q, lambda: _launcher_run(main, argv))
        out["launches"] += fused
        where = [x for x in lines if "('cfg','sm') mesh" in x]
        out["launchers"][name] = dict(wall=wall, launches=fused,
                                      group_steps=steps, err=err,
                                      device=card,
                                      where=where[0] if where else None)
        if err or not lines or lines[-1] != ok_line or not where \
                or fused == 0:
            out["bad"].append(f"{' '.join(argv)}: {err or lines[-1:]}, "
                              f"{fused} sm_quantum launches")
    return out


def phase_serve(torch, K, Q, full_golden):
    """The simulation server on the card at full width (RTX 3080 Ti base,
    bucket_by='shape'): one synchronous batch of ``serve_subs()``, its
    plain SERVE_CASES lanes against the pinned stats and every lane
    against its solo card run; the same jobs reversed and split over two
    batches; a threaded soak (SOAK_CLIENTS clients x SOAK_DRAWS seeded
    draws, batch_lanes 8, max_wait_s 0.05); the kernel launches per
    quantum of a served bucket at 1 and 8 lanes against the bare quantum
    loop's; and the stdin, socket and selftest frontends in child
    processes (the selftest from the phase's start, beside the
    in-process server)."""
    import threading

    from repro_torch.core import stats as S
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.core.service import SimService
    from repro_torch.launch.dse import lane_signature
    from repro_torch.sim.config import RTX3080TI

    selftest = start_selftest()
    subs = serve_subs()
    solo = {}

    def solo_sigs(job):
        sigs = []
        for w, cfg in job.pairs:
            key = (w.name, cfg)
            if key not in solo:
                solo[key] = lane_signature(S.finalize(simulate(
                    w, cfg, make_sm_runner(cfg, "vmap"), plan=serve_plan(),
                    device="cuda")))
            sigs.append(solo[key])
        return sigs

    def lanes(jobs):
        return {i: [lane_signature(s) for s in j.stats]
                for i, j in jobs.items()}

    out = {}
    jobs, walls, launches, quanta = serve_sync(torch, K, Q, [subs])
    main = lanes(jobs)
    for bench, scale in SERVE_CASES:
        key = f"{bench}@{scale}"
        check(S.comparable(jobs[key].stats[0]) == full_golden[key],
              f"served {key} differs from the pinned stats")
    for i, job in jobs.items():
        check(main[i] == solo_sigs(job), f"served {i}'s lanes differ from "
              "their solo card runs")
        check(all(s["timeouts"] == 0 for s in main[i]), f"{i} timed out")
        json.dumps(job.response())
    batch = jobs[subs[0]["id"]].batch
    out.update(wall=walls[0], launches=launches, quanta=quanta,
               n_lanes=batch["n_lanes"], n_buckets=batch["n_buckets"],
               cycles={i: [s["cycles"] for s in v] for i, v in main.items()},
               n_solo=len(solo))
    rev, rwalls, rl, _ = serve_sync(torch, K, Q, [subs[::-1]])
    split, swalls, sl, _ = serve_sync(torch, K, Q, [subs[:3], subs[3:]])
    check(lanes(rev) == main, "the reversed batch's lanes differ")
    check(lanes(split) == main, "the split batches' lanes differ")
    out.update(rev_wall=rwalls[0], split_walls=swalls,
               launches_all=launches + rl + sl)
    # the warm in-process batch of the child servers' jobs
    child_subs = [s for s in subs if s["id"] in CHILD_IDS]
    warm, wwalls, wl, _ = serve_sync(torch, K, Q, [child_subs])
    check(lanes(warm) == {i: main[i] for i in CHILD_IDS},
          "the child servers' jobs, served in-process, differ")
    out.update(warm_wall=wwalls[0], launches_all=out["launches_all"] + wl)

    # the threaded soak
    svc = SimService(base=RTX3080TI, plan=serve_plan(), batch_lanes=8,
                     max_wait_s=0.05)
    soak, soak_lock = [], threading.Lock()

    def client(ci):
        rng = np.random.default_rng(SOAK_SEED + ci)
        for j, pick in enumerate(rng.integers(0, len(subs), SOAK_DRAWS)):
            job = svc.submit(dict(subs[pick], id=f"c{ci}-{j}"))
            with soak_lock:
                soak.append((subs[pick]["id"], job))

    torch.cuda.synchronize()
    K.issue_select.launches = 0
    Q.sm_quantum.launches = 0
    with QuantumSteps() as steps:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(SOAK_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        drained = svc.drain(timeout=600.0)
        soak_wall = time.perf_counter() - t0
    fused, issue = Q.sm_quantum.launches, K.issue_select.launches
    counters = svc.stats()
    svc.shutdown(drain=False)
    n = SOAK_CLIENTS * SOAK_DRAWS
    check(drained and not any(t.is_alive() for t in threads),
          f"the soak did not drain: {counters}")
    check(len(soak) == n and counters["served"] == counters["submitted"]
          == n and counters["errors"] == 0 and counters["pending"] == 0,
          f"soak counters {counters}")
    for key, job in soak:
        check(job.done and job.error is None, f"{job.id} starved or "
              f"failed: {job.response()}")
        check([lane_signature(s) for s in job.stats] == main[key],
              f"soak job {job.id} ({key}) differs from its solo runs")
    check(fused == steps.n > 0 and issue == 0,
          f"soak: {fused} sm_quantum and {issue} sm_issue launches for "
          f"{steps.n} quanta")
    queue_s = [j.latency()["queue_s"] for _, j in soak]
    total_s = [j.latency()["total_s"] for _, j in soak]
    batches = {id(j.batch): j.batch for _, j in soak}
    out["soak"] = {
        "jobs": n, "wall": soak_wall, "jobs_per_s": n / soak_wall,
        "queue_p50": float(np.percentile(queue_s, 50)),
        "queue_p99": float(np.percentile(queue_s, 99)),
        "total_p50": float(np.percentile(total_s, 50)),
        "total_p99": float(np.percentile(total_s, 99)),
        "batches": counters["batches"],
        "lanes_per_batch": counters["lanes"] / counters["batches"],
        "batch_lanes": sorted(b["n_lanes"] for b in batches.values()),
        "launches": fused, "quanta": steps.n}
    out["launches_all"] += fused

    # kernel launches per quantum of a served bucket, against the loop's
    bench, scale = SERVE_CASES[1]
    from repro_torch.launch.dse import sample_table_grid
    from repro_torch.workloads import make_workload
    w = make_workload(bench, scale=scale)
    lat = [["fp32", 2, 8]]
    rows = []
    for n_lanes in (1, SWEEP_LANES):
        sub = {"workload": bench, "scale": scale}
        if n_lanes > 1:
            sub["sample"] = {"n": n_lanes, "lat": lat}
        (k1, q1, s1, p1), (k2, q2, s2, p2) = (
            served_launches(torch, sub, n_q) for n_q in SERVE_PROFILE_QUANTA)
        loop = loop_profile(torch, w, sample_table_grid(
            RTX3080TI, n_lanes, lat) if n_lanes > 1 else [RTX3080TI])
        row = {"lanes": n_lanes, "profiled": p1 and p2 and loop["profiled"],
               "loop": loop["launches_per_q"], "quanta": (s1, s2)}
        if row["profiled"]:
            row["per_q"] = (k2 - k1) / (s2 - s1)
            row["sm_quantum_per_q"] = (q2 - q1) / (s2 - s1)
            check(row["sm_quantum_per_q"] == 1.0,
                  f"{n_lanes} lane(s): {row['sm_quantum_per_q']} sm_quantum "
                  "launches per served quantum")
            check(row["per_q"] <= row["loop"] + 1.0,
                  f"{n_lanes} lane(s): the server adds launches per "
                  f"quantum: {row['per_q']:.2f} against the loop's "
                  f"{row['loop']:.2f}")
        rows.append(row)
    out["per_q"] = rows

    out["children"] = serve_children({i: [S.comparable(s) for s in
                                          jobs[i].stats] for i in jobs},
                                     selftest)
    return out


def _cost_counts(cp, dev):
    """A cost pass's counts on ``dev``: FLOPs, HBM bytes by kind, and its
    kernels' calls, FLOPs and bytes."""
    c, m = cp.costs[dev], cp.memory[dev]
    return {"flops": c.flops, "bytes": c.bytes,
            "bytes_by_op": dict(sorted(c.bytes_by_op.items())),
            "kernels": {k: dict(v) for k, v in sorted(cp.kernels.items())},
            "step_peak": m.peak - m.arg}


def phase_cost(torch, FA, W):
    """The dry run's cost pass against live runs (see COST_ARCHS): per
    arch, a train step and a prefill, unsharded, on fake tensors on the
    host (``dryrun.build_lowerable(..., mesh_shape=())``) and live on
    cuda:0 under the same pass, the kernels launching: FLOPs, bytes, the
    kernels' calls, FLOPs and bytes, and the step's tracked peak equal;
    the calls equal to the wrappers' launch counts (set to 0 just before
    the live pass); the predicted peak against the allocator's; the step
    time (a second step, no pass, the median of three) beside the
    bound.  Then the same on COST_MESH: the fake pass over distinct
    devices against the card repeated, total FLOPs and the kernels' calls
    and FLOPs equal."""
    import dataclasses
    import gc
    from functools import partial

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, hlo_analysis, hlo_costs
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS

    wrappers = {"flash_attention": FA.flash_attention,
                "flash_attention_bwd": FA.flash_attention_bwd,
                "wkv6": W.wkv6, "wkv6_bwd": W.wkv6_bwd}
    dev, host = torch.device("cuda:0"), torch.device("cpu", 0)
    out = []
    cases = [(arch, kind, torch.float32, ((), COST_MESH))
             for arch in COST_ARCHS for kind in ("train", "prefill")]
    cases.append((*COST_BF16, torch.bfloat16, ((),)))
    for arch, kind, dtype, meshes in cases:
        cfg = dataclasses.replace(get_config(arch), n_layers=COST_LAYERS)
        opt_cfg = dryrun._opt_config(cfg)
        shape = ShapeSpec("u", COST_SEQ, COST_BATCH, kind)
        row = {"arch": arch, "kind": kind, "layers": COST_LAYERS,
               "dtype": str(dtype).replace("torch.", "")}
        for mesh in meshes:
            t = time.perf_counter()
            fn, args, _ = dryrun.build_lowerable(
                arch, "u", multi_pod=False, cfg=cfg, shape=shape,
                mesh_shape=mesh, dtype=dtype)
            _, fake = hlo_costs.analyze(fn, *args)
            fake_s = time.perf_counter() - t
            del fn, args
            ctx = (make_ctx(make_train_mesh(mesh, device=dev)) if mesh
                   else None)
            kw = {} if ctx is None else {"ctx": ctx}
            batch = dryrun._batch(cfg, COST_BATCH, COST_SEQ, dtype, dev)
            if kind == "train":
                state = TS.init_train_state(0, cfg, opt_cfg, dtype,
                                            device=dev, **kw)
                fn = TS.make_train_step(cfg, opt_cfg, **kw)
                args = (state, batch)
            else:
                model = (factory.init_placed(0, cfg, ctx) if mesh else
                         factory.init_params(0, cfg, dtype, device=dev))
                fn = partial(factory.prefill, cfg=cfg, max_len=COST_SEQ,
                             **kw)
                args = (model, batch)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            for w in wrappers.values():
                w.launches = 0                     # counts: just before
            _, live = hlo_costs.analyze(fn, *args)
            torch.cuda.synchronize()
            alloc_peak = torch.cuda.max_memory_allocated(dev) - base
            launches = {n: w.launches for n, w in wrappers.items()
                        if w.launches}
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            del fn, args
            gc.collect()
            torch.cuda.empty_cache()
            calls = {k: v["calls"] for k, v in live.kernels.items()}
            check(calls == launches and launches,
                  f"phase u {arch} {kind} {mesh or 'unsharded'}: the "
                  f"pass counted {calls}, the wrappers launched "
                  f"{launches}")
            if not mesh:
                got, want = _cost_counts(live, dev), _cost_counts(
                    fake, host)
                check(got == want, f"phase u {arch} {kind}: live "
                      f"{got} against fake {want}")
                terms = hlo_analysis.roofline_terms(
                    got["flops"], got["bytes"], 0.0, 1,
                    cfg.model_flops(shape), dtype=dtype)
                row.update(
                    fake_s=fake_s, flops=got["flops"],
                    bytes=got["bytes"], kernels=got["kernels"],
                    launches=launches, predicted_peak=want["step_peak"],
                    alloc_peak=alloc_peak,
                    step_s=float(np.median(walls)),
                    step_bound_s=terms["step_bound_s"],
                    dominant=terms["dominant"])
                check(abs(alloc_peak - want["step_peak"])
                      <= COST_PEAK_REL * want["step_peak"]
                      + COST_PEAK_ABS,
                      f"phase u {arch} {kind}: predicted peak "
                      f"{want['step_peak']} B, the allocator's "
                      f"{alloc_peak} B")
            else:
                total = {k: sum(c.flops for d, c in p.costs.items()
                                if d.index is not None)
                         for k, p in (("live", live), ("fake", fake))}
                kern = {k: {n: (v["calls"], v["flops"])
                            for n, v in p.kernels.items()}
                        for k, p in (("live", live), ("fake", fake))}
                check(total["live"] == total["fake"]
                      and kern["live"] == kern["fake"],
                      f"phase u {arch} {kind} {mesh}: live {total['live']}"
                      f" {kern['live']} against fake {total['fake']} "
                      f"{kern['fake']}")
                row.update(mesh_flops=total["live"],
                           mesh_launches=launches, mesh_fake_s=fake_s,
                           mesh_devices=len([d for d in fake.costs
                                             if d.index is not None]))
        out.append(row)
    return out


def report_cost(rows, card):
    for r in rows:
        mesh = ("" if "mesh_flops" not in r else
                f"; {COST_MESH} fake over {r['mesh_devices']} devices == "
                f"the card repeated: {r['mesh_flops']:.6e} FLOPs, launches "
                f"{r['mesh_launches']} (fake pass {r['mesh_fake_s']:.2f} s)")
        print(f"[u cost pass] {r['arch']} at {r['layers']} layers, "
              f"{r['kind']} {COST_BATCH} x {COST_SEQ} in {r['dtype']} "
              f"({card}): fake == live"
              f" on the card, {r['flops']:.6e} FLOPs, {r['bytes']:.6e} B, "
              f"kernels {r['kernels']} (launches {r['launches']}); peak "
              f"over the arguments predicted {r['predicted_peak']} B, "
              f"allocator {r['alloc_peak']} B "
              f"({r['alloc_peak'] / max(r['predicted_peak'], 1):.4f}x); "
              f"step {r['step_s'] * 1e3:.3f} ms against step_bound_s "
              f"{r['step_bound_s'] * 1e3:.3f} ms ({r['dominant']}; share "
              f"{r['step_bound_s'] / r['step_s']:.4f}); fake pass "
              f"{r['fake_s']:.2f} s on the host{mesh}", flush=True)


def main():
    start = time.perf_counter()
    marks = []                     # (phase, its start) for the time line
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.sm_issue import kernel as K
    from repro_torch.kernels.sm_quantum import kernel as Q
    from repro_torch.kernels.wkv6 import kernel as W
    from repro_torch.sim.config import RTX3080TI, TINY

    with open(os.path.join(GOLDEN, "determinism_tiny.json")) as f:
        tiny_golden = json.load(f)
    with open(os.path.join(GOLDEN, "torch_port_rtx3080ti.json")) as f:
        full_golden = json.load(f)

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False

    marks.append(("1", time.perf_counter()))
    # 1. card and build: one nvcc per kernel source, started together
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("sm_issue", K.build), ("sm_quantum", Q.build),
                   ("wkv6", W.build), ("flash_attention", FA.build),
                   ("wkv6_bwd", W.build_bwd),
                   ("flash_attention_bwd", FA.build_bwd))}
        info = builds["sm_issue"].result()
        build_s = time.perf_counter() - t0
        q_info = builds["sm_quantum"].result()
        q_build_s = time.perf_counter() - t0
        wkv_info = builds["wkv6"].result()
        wkv_build_s = time.perf_counter() - t0
        fa_info = builds["flash_attention"].result()
        fa_build_s = time.perf_counter() - t0
        bwd_info = {n: builds[n].result()
                    for n in ("wkv6_bwd", "flash_attention_bwd")}
        bwd_build_s = time.perf_counter() - t0
    # phase r's search on the CPU, in a child process from here on
    cpu_search_proc = start_cpu_search()
    print(f"[1 build] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; sm_issue built in {info['seconds']:.2f} s "
          f"(load {build_s:.2f} s); ptxas: {ptxas_lines(info['log'])}",
          flush=True)
    print(f"[1 build] sm_quantum built in {q_info['seconds']:.2f} s beside "
          f"the others (loaded {q_build_s:.2f} s after the start); ptxas: "
          f"{ptxas_lines(q_info['log'])}", flush=True)

    marks.append(("2", time.perf_counter()))
    # 2. kernel vs plain version
    kr = phase_kernel(torch, K)
    print(f"[2 kernel] sm_issue == plain on {kr['cases']} cases "
          f"{kr['by_kind']} (max abs err {kr['max_abs_err']}); at 80x48 SC=4: "
          f"kernel {kr['ms'] * 1e3:.3f} us/launch on the device "
          f"({'profiler' if kr['device_timed'] else 'not profiled: events'}),"
          f" wrapper {kr['wrapper_ms'] * 1e3:.2f} us/call, plain "
          f"{kr['plain_ms'] * 1e3:.2f} us/call, bound "
          f"{kr['bound_ms'] * 1e3:.4f} us ({kr['bound_by']}, "
          f"{kr['bytes']} B)", flush=True)

    marks.append(("q", time.perf_counter()))
    # q. the fused quantum against the eager SM phase, and its time
    qr = phase_quantum(torch, Q)
    widths = ", ".join(n for n, _ in QUANTUM_CASES)
    print(f"[q sm_quantum] sm_quantum == the eager SM phase on "
          f"{qr['cases']} seeded one-lane states ({widths} x GTO/LRR x "
          f"instr_base or not) and on {qr['lane_cases']} four-lane states "
          f"(each lane its own state, trace, instr_base, dynamic config and "
          f"t0; one launch == the eager lanes == four one-lane launches); "
          f"{qr['leaves']} leaves equal, max abs err {qr['max_abs_err']}, "
          f"inputs unchanged; one quantum at 80x48 SC=4, one lane: kernel "
          f"{qr['ms'] * 1e3:.2f} us/launch on the device "
          f"({'profiler' if qr['device_timed'] else 'not profiled: events'}),"
          f" wrapper {qr['wrapper_ms'] * 1e3:.2f} us/call, eager "
          f"{qr['plain_ms'] * 1e3:.2f} us/call, bound "
          f"{qr['bound_ms'] * 1e3:.4f} us ({qr['bound_by']}: {qr['bytes']} "
          f"B, {qr['ops']} integer ops)", flush=True)
    for row in qr["by_lanes"]:
        print(f"[q sm_quantum] {row['lanes']} lane(s) at 80x48 SC=4: kernel "
              f"{row['ms'] * 1e3:.2f} us/launch on the device "
              f"({'profiler' if row['device_timed'] else 'events'}), "
              f"wrapper {row['wrapper_ms'] * 1e3:.2f} us/call, bound "
              f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: "
              f"{row['bytes']} B, {row['ops']} integer ops)", flush=True)

    marks.append(("3", time.perf_counter()))
    # 3. the TINY goldens: both modes, a trace, a run cut by its cap
    for bench, scale, mode, want_timeouts in TINY_CASES:
        key = f"{bench}@{scale}"
        got, timeouts, wall, fused, issue, quanta = run_case(
            torch, K, Q, bench, scale, TINY, mode, 1 << 15)
        check(got == tiny_golden[key],
              f"{key} {mode} differs from the golden: {got}")
        check(timeouts == want_timeouts,
              f"{key} {mode}: {timeouts} timeouts, the JAX package reads "
              f"{want_timeouts}")
        per_q = TINY.n_sm if mode == "seq" else 1    # seq: one SM a launch
        check(fused == per_q * quanta > 0 and issue == 0,
              f"{key} {mode}: {fused} sm_quantum and {issue} sm_issue"
              f" launches for {quanta} quanta")
        print(f"[3 tiny] {key} {mode}: golden OK, timeouts {timeouts} (as "
              f"the JAX package), {got['cycles']} cycles, {quanta} quanta, "
              f"{fused} sm_quantum launches, {issue} sm_issue, wall "
              f"{wall:.2f} s", flush=True)

    marks.append(("4", time.perf_counter()))
    # 4. the main path at full width, then the eager SM phase as a witness
    main_launches = main_issue = 0
    walls = {}
    for bench, scale, eager in (("nn", 0.5, False), ("syrk", 0.16, False),
                                ("nn", 0.5, True)):
        got, timeouts, wall, fused, issue, quanta = run_case(
            torch, K, Q, bench, scale, RTX3080TI, "vmap", 1 << 17, eager)
        key = f"{bench}@{scale}"
        path = "eager witness" if eager else "fused"
        check(got == full_golden[key], f"{key} ({path}) differs from the "
              f"pinned stats: {got}")
        check(timeouts == 0, f"{key} ({path}): {timeouts} timeouts")
        if eager:   # sm_issue once per cycle
            ok = fused == 0 and issue == RTX3080TI.quantum * quanta
            witness_launches = issue
        else:
            ok = fused == quanta and issue == 0
            main_launches += fused
            main_issue += issue
        check(ok, f"{key} ({path}): {fused} sm_quantum and {issue} sm_issue"
              f" launches for {quanta} quanta")
        walls[key, eager] = wall
        print(f"[4 full] {key} RTX3080TI vmap, {path} SM phase: pinned "
              f"stats OK, timeouts 0, {got['cycles']} cycles, {quanta} "
              f"quanta, wall {wall:.3f} s, {quanta / wall:.1f} quanta/s, "
              f"{got['cycles'] / wall:.1f} simulated cycles/s, {fused} "
              f"sm_quantum launches, {issue} sm_issue", flush=True)
    print(f"[4 full] nn@0.5: the eager SM phase took "
          f"{walls['nn@0.5', True] / walls['nn@0.5', False]:.2f}x the fused "
          f"one's wall", flush=True)
    check(main_launches > 0, "the main path never launched sm_quantum")

    marks.append(("5", time.perf_counter()))
    # 5. where the time goes: a profile of the first quanta of syrk@0.16
    n_q = 16
    events, wall = profiled(torch, lambda: run_case(
        torch, K, Q, "syrk", 0.16, RTX3080TI, "vmap",
        n_q * RTX3080TI.quantum))
    busy = sum(us for _, us in events) / 1e6
    kernels = [(n, us) for n, us in events
               if not n.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    if events:
        print(f"[5 profile] syrk@0.16 first {n_q} quanta under the "
              f"profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle share {1 - busy / wall:.4f}), "
              f"{len(kernels) / n_q:.1f} kernel launches/quantum "
              f"({sum('sm_quantum' in n for n, _ in kernels) / n_q:.1f} of "
              f"sm_quantum), "
              f"{sum('DtoH' in n for n, _ in events) / n_q:.1f} device-to-"
              f"host reads/quantum, {len(by_name)} distinct kernels; top: "
              + "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top),
              flush=True)
    else:
        print(f"[5 profile] the profiler saw no device activity: device "
              f"busy share not measured (wall {wall:.3f} s)", flush=True)

    marks.append(("s", time.perf_counter()))
    # s. this slice's main path: lane-batched sweeps at full width
    sr = phase_sweep(torch, K, Q, full_golden)
    for key, d in sr["dse"].items():
        solo = (f"every lane == its solo run on the card (timeouts "
                f"{d['timeouts']}); the {SWEEP_LANES} solo walls sum to "
                f"{d['solo_wall']:.3f} s ({d['solo_wall'] / d['wall']:.2f}x)"
                if d["solo_wall"] else f"timeouts {d['timeouts']}, lanes "
                "against solo runs in phase t")
        print(f"[s sweep] {key} RTX3080TI, dse default grid of "
              f"{SWEEP_LANES} configs as {SWEEP_LANES} lanes: lanes "
              f"{d['plain']} (plain RTX 3080 Ti) == pinned stats; cycles "
              f"{d['cycles']}; sweep wall {d['wall']:.3f} s for {d['steps']} "
              f"quanta ({d['launches']} sm_quantum launches, one per "
              f"quantum); {solo}", flush=True)
    g = sr["grid"]
    print(f"[s sweep] zoo grid {len(g['names'])} traces x 4 TINY configs "
          f"({', '.join(g['names'])}): --check OK, all {g['lanes']} lanes == "
          f"solo runs on the card; cycles {g['cycles']}; wall "
          f"{g['wall']:.3f} s for {g['steps']} quanta", flush=True)
    check(sr["launches"] > 0 and sr["issue"] == 0,
          "the sweep path never launched sm_quantum, or launched sm_issue")

    marks.append(("l", time.perf_counter()))
    # l. lanes against wall time: one workload swept at 1, 8 and 32 lanes
    lr = phase_lanes(torch, K, Q)
    for row in lr:
        print(f"[l lanes] {LANES_CASE[0]}@{LANES_CASE[1]} RTX3080TI, dse "
              f"default grid of "
              f"{row['lanes']} config(s): wall {row['wall']:.3f} s, "
              f"{row['steps']} quanta, {row['lane_quanta']} lane-quanta, "
              f"{row['lane_quanta'] / row['wall']:.1f} lane-quanta/s, "
              f"{row['launches']} sm_quantum launches; first 16 quanta of "
              f"the quantum loop under the profiler: {profile_text(row)}",
              flush=True)

    marks.append(("t", time.perf_counter()))
    # t. counter timelines at full width, and what they cost
    tr = phase_telemetry(torch, K, Q, full_golden)
    samples, every = tr["knobs"]
    for key, d in tr["solo"].items():
        print(f"[t telemetry] {key} RTX3080TI vmap, {samples} rows every "
              f"{every} quanta: every row, lockstep_waste {d['waste']} and "
              f"telemetry_samples {d['samples']} == {TELEMETRY_GOLDEN}; "
              f"comparable() == pinned stats; last row == finalize; wall "
              f"{d['wall']:.3f} s for {d['steps']} quanta", flush=True)
    d = tr["dse"]
    t_bench, t_scale = TELEMETRY_LANES_CASE
    print(f"[t telemetry] {t_bench}@{t_scale}, dse default grid "
          f"of {SWEEP_LANES} configs with telemetry: every lane's timeline "
          f"== its solo card run's; wall {d['wall']:.3f} s for {d['steps']} "
          f"quanta; lane quanta {d['quanta']}; lockstep_waste {d['waste']}",
          flush=True)
    d = tr["lanes32"]
    print(f"[t telemetry] {t_bench}@{t_scale}, dse default grid "
          f"of {d['lanes']} configs: last rows == finalize; wall "
          f"{d['wall']:.3f} s for {d['steps']} quanta; frozen lane-quanta "
          f"{d['lanes'] * d['steps'] - sum(d['quanta'])} of "
          f"{d['lanes'] * d['steps']}; lane quanta {d['quanta']}; "
          f"lockstep_waste {d['waste']} (sum {sum(d['waste'])})", flush=True)
    g = tr["grid"]
    n_lanes = sum(len(row) for row in g["quanta"])
    print(f"[t telemetry] zoo grid {len(g['names'])} traces x 4 TINY configs "
          f"({', '.join(g['names'])}) with telemetry: last rows == finalize; "
          f"wall {g['wall']:.3f} s for {g['steps']} quanta; frozen "
          f"lane-quanta {n_lanes * g['steps'] - sum(map(sum, g['quanta']))} "
          f"of {n_lanes * g['steps']}; lane quanta {g['quanta']}; "
          f"lockstep_waste {g['waste']}", flush=True)
    for (n, on), row in tr["profiles"].items():
        print(f"[t telemetry] {LANES_CASE[0]}@{LANES_CASE[1]}, {n} lane(s), "
              f"telemetry {'on' if on else 'off'}: first 16 quanta of the "
              f"quantum loop under the profiler: {profile_text(row)}",
              flush=True)
    for n, walls in tr["turns"].items():
        off, on = (float(np.median(walls[k])) for k in (False, True))
        print(f"[t telemetry] {LANES_CASE[0]}@{LANES_CASE[1]}, {n} lane(s), "
              f"{TURN_QUANTA} quanta of the loop in turns off/on/on/off x "
              f"{TURNS}: off {', '.join(f'{x:.4f}' for x in walls[False])} s,"
              f" on {', '.join(f'{x:.4f}' for x in walls[True])} s; medians "
              f"{off:.4f} and {on:.4f} s ({on / off - 1:+.2%} with "
              f"telemetry)", flush=True)

    marks.append(("r", time.perf_counter()))
    # r. the seeded analytic-prune search, verify sweeps on the card
    rr_ = phase_search(torch, K, Q, cpu_search_proc)
    print(f"[r search] {SEARCH_GOLDEN}'s case on the card (wall "
          f"{rr_['wall']:.3f} s); at {SEARCH_CPU_ROUNDS} round(s) == the "
          f"same search on the CPU in full (CPU {rr_['cpu_wall']:.3f} s in "
          f"a child process beside the card phases, {rr_['cpu_wait']:.3f} "
          f"s waited for here); "
          f"round 0's verified set == the golden's,"
          f" equal cycles on all {rr_['shared']} of {rr_['n_verified']} "
          f"vectors both measured (whole search == golden: "
          f"{rr_['equal_golden']}); best {rr_['best']} cycles (golden "
          f"{rr_['golden_best']}); {rr_['steps']} quanta; rounds "
          f"{rr_['rounds']}", flush=True)
    print(f"[r search] dse {rr_['dse_argv']} on the card: "
          f"{rr_['dse_lines'][-1]} (wall {rr_['dse_wall']:.3f} s)",
          flush=True)

    marks.append(("v", time.perf_counter()))
    # v. the simulation server at full width
    t_v = time.perf_counter()
    vr = phase_serve(torch, K, Q, full_golden)
    v_s = time.perf_counter() - t_v
    print(f"[v serve] RTX3080TI server, bucket_by=shape, one batch of "
          f"{len(serve_subs())} jobs ({vr['n_lanes']} lanes, "
          f"{vr['n_buckets']} buckets): {', '.join(SERVE_CASES_TEXT)} == "
          f"pinned stats; every lane == its solo card run "
          f"({vr['n_solo']} solo runs), timeouts 0; cycles {vr['cycles']}; "
          f"batch wall {vr['wall']:.3f} s for {vr['quanta']} quanta of its "
          f"bucket runs ({vr['launches']} sm_quantum launches, one per "
          f"quantum); reversed {vr['rev_wall']:.3f} s and split in two "
          f"{', '.join(f'{x:.3f}' for x in vr['split_walls'])} s: the same "
          f"lanes", flush=True)
    d = vr["soak"]
    print(f"[v serve] threaded soak, {SOAK_CLIENTS} clients x {SOAK_DRAWS} "
          f"seeded draws, batch_lanes 8, max_wait 50 ms: all {d['jobs']} "
          f"served, no error, drained, every lane == its solo card run; "
          f"{d['jobs_per_s']:.3f} jobs/s ({d['wall']:.3f} s); queue_s p50 "
          f"{d['queue_p50']:.4f} p99 {d['queue_p99']:.4f}; total_s p50 "
          f"{d['total_p50']:.4f} p99 {d['total_p99']:.4f}; {d['batches']} "
          f"batches, {d['lanes_per_batch']:.2f} lanes per batch "
          f"{d['batch_lanes']}; {d['launches']} sm_quantum launches for "
          f"{d['quanta']} quanta", flush=True)
    for row in vr["per_q"]:
        if row["profiled"]:
            text = (f"{row['per_q']:.2f} kernel launches per quantum "
                    f"({row['sm_quantum_per_q']:.2f} of sm_quantum; quanta "
                    f"{row['quanta'][0]} and {row['quanta'][1]} differenced)"
                    f", the bare quantum loop {row['loop']:.2f} (first 16 "
                    f"quanta, with its setup)")
        else:
            text = "the profiler saw no device activity: not measured"
        print(f"[v serve] served bucket of {SERVE_CASES[1][0]}@"
              f"{SERVE_CASES[1][1]}, {row['lanes']} lane(s): {text}",
              flush=True)
    c = vr["children"]
    print(f"[v serve] child servers on the card: --stdin session "
          f"({c['stdin_lines']} lines, completions == in-process lanes): "
          f"cold start to first completion {c['stdin_first_s']:.3f} s, "
          f"whole session {c['stdin_s']:.3f} s, against the warm in-process "
          f"batch of the same {len(CHILD_IDS)} jobs {vr['warm_wall']:.3f} s;"
          f" --port 0 (port {c['port']}, {c['socket_lines']} lines, "
          f"completions == in-process lanes); --selftest from the phase's "
          f"start, beside the in-process server (exit 0, "
          f"{c['selftest_s']:.3f} s: {' | '.join(c['selftest_lines'])}); "
          f"phase v {v_s:.1f} s", flush=True)

    marks.append(("m", time.perf_counter()))
    # m. SM-axis sharding and the ('cfg','sm') mesh, every position on
    # this card: the readings first, then the checks
    t_m = time.perf_counter()
    mr = phase_mesh(torch, K, Q, tiny_golden, full_golden)
    m_s = time.perf_counter() - t_m
    for row in mr["shard"]:
        print(f"[m shard] {row['key']} RTX3080TI over {SHARD_DEVICES} "
              f"shards of this card, {row['policy']}/window: wall "
              f"{row['wall']:.3f} s, {row['quanta']} quanta, "
              f"{row['launches']} sm_quantum launches "
              f"({row['launches'] / max(row['quanta'], 1):.2f} per quantum),"
              f" {row['issue']} sm_issue, timeouts {row['timeouts']}",
              flush=True)
    for row in mr["cycle"]:
        print(f"[m shard] {row['key']} TINY over {SHARD_DEVICES} shards, "
              f"dynamic/cycle: wall {row['wall']:.3f} s, {row['quanta']} "
              f"quanta, {row['issue']} sm_issue launches, "
              f"{row['launches']} sm_quantum, timeouts {row['timeouts']}",
              flush=True)
    print(f"[m mesh] {MESH_CASE[0]}@{MESH_CASE[1]} x dse's default grid of "
          f"{SWEEP_LANES} configs, one card repeated at every mesh position: "
          "these readings measure what distribution costs the host, not a "
          "speed-up", flush=True)
    print(f"[m mesh] no mesh: wall {mr['nomesh']['wall']:.3f} s; first "
          f"{MESH_PROFILE_QUANTA} quanta: {profile_text(mr['nomesh'])}",
          flush=True)
    for row in mr["mesh"]:
        a, b = row["shape"]
        print(f"[m mesh] {a}x{b} ('cfg','sm') mesh: wall {row['wall']:.3f} "
              f"s, {row['group_steps']} group quanta, {row['launches']} "
              f"sm_quantum launches ({row['launches'] / max(row['group_steps'], 1):.2f}"
              f" per group quantum, {b} shard device(s) per group); first "
              f"{MESH_PROFILE_QUANTA} quanta of every group: "
              f"{profile_text(row)}", flush=True)
    d = mr["telemetry"]
    print(f"[m mesh] {MESH_TELEMETRY_SHAPE[0]}x{MESH_TELEMETRY_SHAPE[1]} with "
          f"telemetry (64 rows every 16 quanta): {d['rows']} rows, equal to "
          f"the no-mesh timelines: {d['same']}, lockstep waste "
          f"{d['waste']}, wall {d['wall']:.3f} s", flush=True)
    for name, row in mr["launchers"].items():
        print(f"[m mesh] {name} main() --mesh --check on {row['device']}: wall "
              f"{row['wall']:.3f} s, {row['launches']} sm_quantum launches "
              f"for {row['group_steps']} group quanta; "
              f"{row['err'] or row['where']}", flush=True)
    print(f"[m mesh] phase m {m_s:.1f} s", flush=True)
    check(not mr["bad"], "phase m: " + "; ".join(mr["bad"]))

    marks.append(("a", time.perf_counter()))
    # a. the wkv6 build
    print(f"[a build] wkv6 built in {wkv_info['seconds']:.2f} s beside "
          f"the others (loaded {wkv_build_s:.2f} s after the start); "
          f"dynamic shared memory per block by hs "
          f"{wkv_info['smem_bytes']} B; "
          f"ptxas: {ptxas_lines(wkv_info['log'])}", flush=True)

    marks.append(("b", time.perf_counter()))
    # b. wkv6 against its plain version, and its time
    wr = phase_wkv6(torch, W)
    print(f"[b wkv6] wkv6 == wkv6_plain on {wr['cases']} cases "
          f"{wr['by_kind']} (hs 16/32/64 x S 1/64/512 x zero/random state; "
          f"ragged S 37 and 100; log decay ~-20 and ~-1e-6 at S 37 and "
          f"512; a model position's {WKV_TP_SHAPE}, {WKV_SERVE_SHAPE} and "
          f"{WKV_FULL_SHAPE}), "
          f"every output finite; max abs err "
          f"{wr['max_abs_err']:.3e}, worst err/tol {wr['worst']:.4f} at "
          f"rtol = atol = {WKV_TOL}; against the recurrence in f64 on "
          f"every case, worst err/tol {wr['worst_f64']:.4f}); at "
          f"{WKV_FULL_SHAPE} against the "
          f"recurrence in f64: wkv6 max abs err {wr['vs_f64']['wkv6']:.3e}, "
          f"wkv6_plain {wr['vs_f64']['wkv6_plain']:.3e}; there: kernel "
          f"{wr['ms'] * 1e3:.2f} us/launch on the device "
          f"({'profiler' if wr['device_timed'] else 'not profiled: events'})"
          f", wrapper {wr['wrapper_ms'] * 1e3:.2f} us/call, plain "
          f"{wr['plain_ms'] * 1e3:.2f} us/call, bound "
          f"{wr['bound_ms'] * 1e3:.2f} us ({wr['bound_by']}: "
          f"{wr['bytes']} B, {wr['ops']} f32 ops)", flush=True)

    marks.append(("c", time.perf_counter()))
    # c. the reduced model against the JAX package's golden result
    rr = phase_rwkv_reduced(torch, W)
    print(f"[c rwkv reduced] {RWKV_ARCH} reduced ({rr['cfg'].n_layers} "
          f"layers, d_model {rr['cfg'].d_model}, hs "
          f"{rr['cfg'].rwkv.head_size}), prompt {rr['shape']}: golden OK "
          f"(prefill logits max abs err {rr['errs']['prefill_logits']:.3e},"
          f" decode {rr['errs']['decode_logits']:.3e}; {rr['new']} greedy "
          f"tokens equal), {rr['launches']} wkv6 launches in the prefill",
          flush=True)

    marks.append(("d", time.perf_counter()))
    # d. the serving path at full width
    fr = phase_rwkv_full(torch, W, K)
    cfg = fr["cfg"]
    t = fr["times"]
    n_pre, n_dec = RWKV_BATCH * RWKV_PROMPT, RWKV_BATCH * (RWKV_NEW - 1)

    def spread(key, per=1.0, unit="s", f=".3f"):
        med, lo, hi = (x * per for x in t[key])
        return f"{med:{f}} {unit} (range {lo:{f}}-{hi:{f}})"

    print(f"[d rwkv full] {RWKV_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.rwkv.head_size}, "
          f"vocab {cfg.vocab_size}; {fr['n_params']} parameters f32, init "
          f"{fr['init_s']:.2f} s) generate batch {RWKV_BATCH}, prompt "
          f"{RWKV_PROMPT}, {RWKV_NEW} new, medians of {RWKV_REPEATS} "
          f"windows: generate wall {spread('generate')}; prefill "
          f"{spread('prefill')} = {n_pre / t['prefill'][0]:.1f} tok/s; "
          f"decode inside generate (generate - prefill) "
          f"{spread('generate - prefill')} = "
          f"{n_dec / t['generate - prefill'][0]:.1f} tok/s, "
          f"{spread('generate - prefill', 1e3 / (RWKV_NEW - 1), 'ms', '.2f')}"
          f" per step; the {RWKV_NEW - 1} decode steps timed alone "
          f"{spread('decode', 1e3 / (RWKV_NEW - 1), 'ms', '.2f')} per step; "
          f"peak device memory {fr['peak'] / 2**30:.3f} GiB; "
          f"{fr['launches']} wkv6 launches; sample {fr['sample']}",
          flush=True)
    for s_, steps, diff, scale, tol in fr["cons"]:
        print(f"[d rwkv full] cache consistency: prefill of {s_} tokens vs "
              f"{s_ - steps} + {steps} decode steps: max |diff| {diff:.3e},"
              f" max |logit| {scale:.3f} (ratio {diff / scale:.3e}, limit "
              f"{tol})", flush=True)
    for name, r in fr["witness"].items():
        print(f"[d rwkv full] witness of 128 = 64 + 64: {name}: max |diff| "
              f"/ max |logit| {r:.3e}", flush=True)
    for name, w in fr["windows"].items():
        print(f"[d rwkv full] profile of {name}: wall {w['wall']:.3f} s, "
              f"device busy {w['busy']:.4f} s (idle share "
              f"{1 - w['busy'] / w['wall']:.4f}), {w['n']} device "
              f"activities; wkv6 {w['wkv6'] * 1e3:.3f} ms "
              f"({w['wkv6'] / max(w['busy'], 1e-12):.2%} of busy); top: "
              + "; ".join(
                  f"{n[:60]} {us / 1e3:.2f} ms" for n, us in w["top"]),
              flush=True)
    for s_, steps, diff, scale, tol in fr["cons"]:
        check(diff <= tol * scale, f"cache consistency at {s_} tokens "
              f"({s_ - steps} + {steps} steps): max |diff| {diff} > {tol} "
              f"x max |logit| {scale}")
    for name, r in fr["witness"].items():
        check(r <= MODEL_F32_TOL, f"witness {name}: {r} > {MODEL_F32_TOL} "
              "of the largest logit")

    # the RWKV model is gone with phase d's frame: give its memory back
    torch.cuda.empty_cache()

    marks.append(("e", time.perf_counter()))
    # e. the flash_attention build
    print(f"[e build] flash_attention built in {fa_info['seconds']:.2f} s "
          f"beside the others (loaded {fa_build_s:.2f} s after the "
          f"start); ptxas: {flash_ptxas(fa_info['log'])}", flush=True)

    marks.append(("f", time.perf_counter()))
    # f. flash_attention against its plain version, and its time
    ar = phase_flash(torch, FA)
    b_, s_, h_, kv_, hd_ = FLASH_FULL_SHAPE
    print(f"[f flash] flash_attention == attention_plain on {ar['cases']} "
          f"cases (hd 16/32/64/128 x Sq=Sk 1/63/64/512 and 100 over 300 x "
          f"KV groups 1/4 x causal or not x f32 at "
          f"{FLASH_TOLS['float32']} / bf16 at {FLASH_TOLS['bfloat16']}, "
          f"and {FLASH_ARCTIC_SHAPE} and {FLASH_FULL_SHAPE} f32 causal; "
          f"max abs err "
          f"{ar['max_abs_err']:.3e}, worst err/tol {ar['worst']:.4f}); at "
          f"(B {b_}, S {s_}, H {h_}, KV {kv_}, hd {hd_}) against the same "
          f"attention in f64: flash_attention max abs err "
          f"{ar['vs_f64']['flash_attention'][0]:.3e} (err/tol "
          f"{ar['vs_f64']['flash_attention'][1]:.4f}), attention_plain "
          f"{ar['vs_f64']['attention_plain'][0]:.3e}; there: kernel "
          f"{ar['ms'] * 1e3:.2f} us/launch on the device "
          f"({'profiler' if ar['device_timed'] else 'not profiled: events'})"
          f"; in turns with SDPA on the repeated KV heads (kernel, SDPA, "
          f"SDPA, kernel): wrapper "
          f"{', '.join(f'{x * 1e3:.2f}' for x in ar['turns']['kernel'])} "
          f"us/call, SDPA "
          f"{', '.join(f'{x * 1e3:.2f}' for x in ar['turns']['sdpa'])} "
          f"us/call (max abs err {ar['library_err']:.3e} from plain); plain "
          f"{ar['plain_ms'] * 1e3:.2f} us/call; bound "
          f"{ar['bound_ms'] * 1e3:.2f} us ({ar['bound_by']}: {ar['ops']} "
          f"ops in {TF32_PASSES} TF32 passes at {TF32_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s; {ar['bytes']} B is "
          f"{ar['bytes'] / HBM_BYTES_PER_S * 1e6:.2f} us; on the CUDA "
          f"cores at {ALU_OPS_PER_S / 1e12:.0f} TFLOP/s "
          f"{ar['cuda_core_ms'] * 1e3:.2f} us)", flush=True)
    for model, a_ in (("arctic-480b", ar["arctic"]),
                      ("qwen2-vl-2b", ar["qwen_vl"]),
                      ("qwen2-vl-2b on a model position", ar["qwen_vl_tp"])):
        sh = a_["shape"]
        print(f"[f flash] at {model}'s shape {tuple(sh)} (GQA group of "
              f"{sh[2] // sh[3]}), causal, f32: flash_attention vs "
              f"attention_plain max "
              f"abs err {a_['max_abs_err']:.3e} (err/tol {a_['worst']:.4f} at "
              f"{FLASH_TOLS['float32']}), vs f64 "
              f"{a_['vs_f64']['flash_attention'][0]:.3e} (attention_plain "
              f"{a_['vs_f64']['attention_plain'][0]:.3e}); kernel "
              f"{a_['ms'] * 1e3:.2f} us/launch on the device "
              f"({'profiler' if a_['device_timed'] else 'not profiled: events'})"
              f"; in turns with SDPA on the repeated KV heads: wrapper "
              f"{', '.join(f'{x * 1e3:.2f}' for x in a_['turns']['kernel'])} "
              f"us/call, SDPA "
              f"{', '.join(f'{x * 1e3:.2f}' for x in a_['turns']['sdpa'])} "
              f"us/call (max abs err {a_['library_err']:.3e} from plain); plain "
              f"{a_['plain_ms'] * 1e3:.2f} us/call; bound "
              f"{a_['bound_ms'] * 1e3:.2f} us ({a_['bound_by']})", flush=True)
    for name, w_ in ar["whisper"].items():
        print(f"[f flash] at whisper-base's {name} shape {w_['shape']} over "
              f"{w_['sk']} keys, non-causal, f32: flash_attention vs "
              f"attention_plain max abs err {w_['max_abs_err']:.3e} (err/tol "
              f"{w_['worst']:.4f} at {FLASH_TOLS['float32']}), vs f64 "
              f"{w_['vs_f64']['flash_attention'][0]:.3e} (attention_plain "
              f"{w_['vs_f64']['attention_plain'][0]:.3e}); kernel "
              f"{w_['ms'] * 1e3:.2f} us/launch on the device ("
              + ("profiler" if w_["device_timed"] else "not profiled: events")
              + f"); in turns with SDPA: wrapper "
              f"{', '.join(f'{x * 1e3:.2f}' for x in w_['turns']['kernel'])} "
              f"us/call, SDPA "
              f"{', '.join(f'{x * 1e3:.2f}' for x in w_['turns']['sdpa'])} "
              f"us/call (max abs err {w_['library_err']:.3e} from plain); "
              f"plain {w_['plain_ms'] * 1e3:.2f} us/call; bound "
              f"{w_['bound_ms'] * 1e3:.2f} us ({w_['bound_by']}: {w_['ops']} "
              f"ops in {TF32_PASSES} TF32 passes; {w_['bytes']} B)",
              flush=True)
    named = [(f"qwen2-vl-2b's seqpar slab on a (1, 8) mesh, causal over "
              f"{c['sk']} keys", c) for c in ar["seqpar"]]
    named += [(f"whisper-base's {name} on a (2, 2) mesh's model position, "
               f"{'causal' if c['causal'] else 'non-causal'} over {c['sk']} "
               f"keys", c) for name, c in ar["whisper_tp"].items()]
    named += [(f"{arch}'s attention on a (2, 2) mesh's model position (GQA "
               f"group of {c['shape'][2] // c['shape'][3]}), causal", c)
              for arch, c in ar["ep_tp"].items()]
    named += [(f"{name}'s serving prefill at one position (phase n), "
               f"causal over {c['sk']} keys", c)
              for name, c in ar["serve"].items()]
    for what, c in named:
        print(f"[f flash] {what}: {tuple(c['shape'])}, f32: "
              f"flash_attention vs attention_plain max abs err "
              f"{c['max_abs_err']:.3e} (err/tol {c['worst']:.4f}), vs f64 "
              f"{c['vs_f64']['flash_attention'][0]:.3e} (attention_plain "
              f"{c['vs_f64']['attention_plain'][0]:.3e}); kernel "
              f"{c['ms'] * 1e3:.2f} us/launch on the device ("
              + ("profiler" if c["device_timed"] else "not profiled: events")
              + "); in turns with SDPA"
              + (" (a right-aligned causal mask: Sq < Sk)"
                 if c["causal"] and c["shape"][1] < c["sk"] else "")
              + f": wrapper "
              f"{', '.join(f'{x * 1e3:.2f}' for x in c['turns']['kernel'])} "
              f"us/call, SDPA "
              f"{', '.join(f'{x * 1e3:.2f}' for x in c['turns']['sdpa'])} "
              f"us/call (max abs err {c['library_err']:.3e} from plain); "
              f"plain {c['plain_ms'] * 1e3:.2f} us/call; bound "
              f"{c['bound_ms'] * 1e3:.2f} us ({c['bound_by']})", flush=True)
        check(c["vs_f64"]["flash_attention"][0] <= FLASH_F64_TOL,
              f"flash_attention at {what} disagrees with attention in f64 "
              f"beyond {FLASH_F64_TOL}")
    wd = ar["wide"]
    print(f"[f flash] non-causal, more queries than keys {FLASH_WIDE_CASE} "
          f"(B, Sq, H, KV, hd, Sk): vs attention_plain max abs err "
          f"{wd['max_abs_err']:.3e} (err/tol {wd['worst']:.4f}), vs f64 "
          f"{wd['vs_f64'][0]:.3e}; causal refused (F4): "
          f"{wd['causal_refused']}", flush=True)
    check(wd["causal_refused"], "flash_attention took causal Sq > Sk")
    check(all(w_["vs_f64"]["flash_attention"][0] <= FLASH_F64_TOL
              for w_ in ar["whisper"].values())
          and wd["vs_f64"][0] <= FLASH_F64_TOL,
          f"flash_attention at Whisper's shapes disagrees with attention in "
          f"f64 beyond {FLASH_F64_TOL}")
    check(ar["worst"] <= 1.0, f"flash_attention disagrees with "
          f"attention_plain (max abs err {ar['max_abs_err']}, worst err/tol "
          f"{ar['worst']})")
    for a_ in (ar["arctic"], ar["qwen_vl"], ar["qwen_vl_tp"]):
        check(a_["vs_f64"]["flash_attention"][0] <= FLASH_F64_TOL,
              f"flash_attention at {tuple(a_['shape'])} disagrees with "
              f"attention in f64 beyond {FLASH_F64_TOL} (max abs err "
              f"{a_['vs_f64']['flash_attention'][0]})")
    check(ar["vs_f64"]["flash_attention"][0] <= FLASH_F64_TOL,
          f"flash_attention disagrees with attention in f64 beyond "
          f"{FLASH_F64_TOL} (max abs err "
          f"{ar['vs_f64']['flash_attention'][0]})")

    marks.append(("g", time.perf_counter()))
    # g. the reduced dense models against the JAX package's golden results
    dr, dr_new = phase_reduced_golden(torch, FA,
                                      "torch_port_dense_reduced.json")
    for arch, r in dr.items():
        c = r["cfg"]
        print(f"[g dense reduced] {arch} reduced ({c.n_layers} layers, "
              f"d_model {c.d_model}, {c.n_heads} query / {c.n_kv_heads} KV "
              f"heads of {c.resolved_head_dim}, {c.norm}, {c.act}"
              f"{', QKV bias' if c.qkv_bias else ''}), prompt {r['shape']}: "
              f"golden OK (prefill logits max abs err "
              f"{r['errs']['prefill_logits']:.3e}, decode "
              f"{r['errs']['decode_logits']:.3e}; {dr_new} greedy tokens "
              f"equal), {r['launches']} flash_attention launches in the "
              f"prefill", flush=True)

    marks.append(("h", time.perf_counter()))
    # h. the dense serving path at full width
    hr = phase_generate_full(torch, FA, W, K, Q, dense_config(), DENSE_BATCH,
                             DENSE_PROMPT, DENSE_NEW, DENSE_REPEATS,
                             ((DENSE_PROMPT, 64), (64, 1)))
    cfg = hr["cfg"]
    t = hr["times"]
    n_pre, n_dec = DENSE_BATCH * DENSE_PROMPT, DENSE_BATCH * (DENSE_NEW - 1)
    print(f"[h dense full] {DENSE_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV heads "
          f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {hr['n_params']} parameters f32, init "
          f"{hr['init_s']:.2f} s) generate batch {DENSE_BATCH}, prompt "
          f"{DENSE_PROMPT}, {DENSE_NEW} new, medians of {DENSE_REPEATS} "
          f"windows: generate wall {spread('generate')}; prefill "
          f"{spread('prefill')} = {n_pre / t['prefill'][0]:.1f} tok/s; "
          f"decode inside generate (generate - prefill) "
          f"{spread('generate - prefill')} = "
          f"{n_dec / t['generate - prefill'][0]:.1f} tok/s, "
          f"{spread('generate - prefill', 1e3 / (DENSE_NEW - 1), 'ms', '.2f')}"
          f" per step; the {DENSE_NEW - 1} decode steps timed alone "
          f"{spread('decode', 1e3 / (DENSE_NEW - 1), 'ms', '.2f')} per step;"
          f" peak device memory {hr['peak'] / 2**30:.3f} GiB; "
          f"{hr['launches']} flash_attention launches (wkv6, sm_issue, "
          f"sm_quantum: "
          f"{hr['others']}); windows agree with generate: {hr['agree']}; "
          f"sample {hr['sample']}", flush=True)
    for s_, steps, diff, scale, finite in hr["cons"]:
        print(f"[h dense full] cache consistency: prefill of {s_} tokens vs "
              f"{s_ - steps} + {steps} decode steps: max |diff| {diff:.3e}, "
              f"max |logit| {scale:.3f} (ratio {diff / scale:.3e}, limit "
              f"{CONSISTENCY_TOL}), finite {finite}", flush=True)
    print(f"[h dense full] flash_attention vs attention_plain inside the "
          f"model, prefill of 128 tokens: max |diff| / max |logit| "
          f"{hr['in_model']:.3e} (limit {CONSISTENCY_TOL})", flush=True)
    for name, w in hr["windows"].items():
        print(f"[h dense full] profile of {name}: wall {w['wall']:.3f} s, "
              f"device busy {w['busy']:.4f} s (idle share "
              f"{1 - w['busy'] / w['wall']:.4f}), {w['n']} device "
              f"activities, of which device-to-device copies and stacks "
              f"(the functional KV cache) {w['copies'] * 1e3:.2f} ms; "
              "top: " + "; ".join(
                  f"{n[:60]} {us / 1e3:.2f} ms" for n, us in w["top"]),
              flush=True)
    toks = hr["toks"]
    check(hr["launches"] == cfg.n_layers, f"generate launched "
          f"flash_attention {hr['launches']} times; the prefill has "
          f"{cfg.n_layers} layers")
    check(hr["others"] == (0, 0, 0), f"generate launched wkv6, sm_issue or "
          f"sm_quantum: "
          f"{hr['others']}")
    check(tuple(toks.shape) == (DENSE_BATCH, DENSE_NEW),
          f"generate returned {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generate returned tokens outside the vocabulary")
    check(bool(torch.isfinite(hr["logits"]).all()), "prefill logits not "
          "finite")
    check(torch.equal(toks[:, 0], torch.argmax(hr["logits"], -1).int()),
          "generate's first token is not the prefill's argmax")
    check(all(hr["agree"]), "generate is not deterministic, or its last "
          "token differs from the separately timed decode steps'")
    for s_, steps, diff, scale, finite in hr["cons"]:
        check(finite, f"decode logits after {s_ - steps} + {steps} steps "
              "not finite")
        check(diff <= CONSISTENCY_TOL * scale, f"cache consistency at {s_} "
              f"tokens ({s_ - steps} + {steps} steps): max |diff| {diff} > "
              f"{CONSISTENCY_TOL} x max |logit| {scale}")
    check(hr["in_model"] <= CONSISTENCY_TOL, "flash_attention vs "
          f"attention_plain inside the model: {hr['in_model']} > "
          f"{CONSISTENCY_TOL} of the largest logit")

    # the RWKV and dense models are gone with their phases' frames
    torch.cuda.empty_cache()

    marks.append(("i", time.perf_counter()))
    # i. the reduced MoE models against the JAX package's golden results
    ir, ir_new = phase_reduced_golden(torch, FA, MOE_GOLDEN)
    for arch, r in ir.items():
        c = r["cfg"]
        print(f"[i moe reduced] {arch} reduced ({c.n_layers} layers, d_model "
              f"{c.d_model}, {c.moe.n_experts} experts top-{c.moe.top_k}"
              f"{', MLA' if c.mla else ''}), prompt {r['shape']}: golden OK "
              f"(prefill logits max abs err "
              f"{r['errs']['prefill_logits']:.3e}, decode "
              f"{r['errs']['decode_logits']:.3e}; {ir_new} greedy tokens "
              f"equal), {r['launches']} flash_attention launches in the "
              f"prefill", flush=True)

    marks.append(("o", time.perf_counter()))
    # o. the MoE family at full width, one model at a time
    moe = {}
    for arch, n_layers in MOE_CASES:
        cfg = moe_config(arch, n_layers)
        moe[arch] = orr = phase_generate_full(
            torch, FA, W, K, Q, cfg, MOE_BATCH, MOE_PROMPT, MOE_NEW,
            MOE_REPEATS, MOE_CONS_CASES, no_drop(cfg))
        torch.cuda.empty_cache()
        cfg, t, m = orr["cfg"], orr["times"], orr["cfg"].moe
        n_pre, n_dec = MOE_BATCH * MOE_PROMPT, MOE_BATCH * (MOE_NEW - 1)
        mixer = ("MLA q_lora {} kv_lora {}".format(cfg.mla.q_lora_rank,
                                                   cfg.mla.kv_lora_rank)
                 if cfg.mla else f"{cfg.n_heads} query / {cfg.n_kv_heads} "
                 f"KV heads of {cfg.resolved_head_dim}")
        print(f"[o moe full] {arch} cut to {cfg.n_layers} layers "
              f"({cfg.n_dense_prefix} dense-prefix), d_model {cfg.d_model}, "
              f"{mixer}, {m.n_experts} experts top-{m.top_k} of width "
              f"{m.d_ff_expert} (shared {m.n_shared_experts}, dense residual "
              f"{m.dense_residual}), capacity factor {m.capacity_factor}, "
              f"vocab {cfg.vocab_size}; {orr['n_params']} parameters f32, "
              f"init {orr['init_s']:.2f} s; on {card}: generate batch "
              f"{MOE_BATCH}, prompt {MOE_PROMPT}, {MOE_NEW} new, medians of "
              f"{MOE_REPEATS} windows: generate wall "
              f"{orr['times']['generate'][0]:.3f} s (range "
              f"{t['generate'][1]:.3f}-{t['generate'][2]:.3f}); prefill "
              f"{t['prefill'][0]:.3f} s = {n_pre / t['prefill'][0]:.1f} "
              f"tok/s; decode inside generate "
              f"{t['generate - prefill'][0]:.3f} s = "
              f"{n_dec / t['generate - prefill'][0]:.1f} tok/s, "
              f"{t['generate - prefill'][0] * 1e3 / (MOE_NEW - 1):.2f} ms "
              f"per step; the {MOE_NEW - 1} decode steps timed alone "
              f"{t['decode'][0] * 1e3 / (MOE_NEW - 1):.2f} ms per step "
              f"(range {t['decode'][1] * 1e3 / (MOE_NEW - 1):.2f}-"
              f"{t['decode'][2] * 1e3 / (MOE_NEW - 1):.2f}); peak device "
              f"memory {orr['peak'] / 2**30:.3f} GiB; {orr['launches']} "
              f"flash_attention launches per generate (wkv6, sm_issue, "
              f"sm_quantum: {orr['others']}); {MOE_REPEATS} repeats give "
              f"the same tokens: {orr['agree']}; sample {orr['sample']}",
              flush=True)
        for s_, steps, diff, scale, finite in orr["cons"]:
            print(f"[o moe full] {arch} cache consistency at capacity "
                  f"factor {no_drop(cfg).moe.capacity_factor} (no drops): "
                  f"prefill of {s_} "
                  f"tokens vs {s_ - steps} + {steps} decode steps: max "
                  f"|diff| {diff:.3e}, max |logit| {scale:.3f} (ratio "
                  f"{diff / scale:.3e}, limit {CONSISTENCY_TOL}), finite "
                  f"{finite}", flush=True)
        if orr["in_model"] is not None:
            print(f"[o moe full] {arch} flash_attention vs attention_plain "
                  f"inside the model, prefill of 128 tokens: max |diff| / "
                  f"max |logit| {orr['in_model']:.3e} (limit "
                  f"{CONSISTENCY_TOL})", flush=True)
        for name, w in orr["windows"].items():
            print(f"[o moe full] {arch} profile of {name}: wall "
                  f"{w['wall']:.3f} s, device busy {w['busy']:.4f} s (idle "
                  f"share {1 - w['busy'] / w['wall']:.4f}), {w['n']} device "
                  f"activities; top: " + "; ".join(
                      f"{n[:60]} {us / 1e3:.2f} ms" for n, us in w["top"]),
                  flush=True)
    for arch, orr in moe.items():
        cfg, toks = orr["cfg"], orr["toks"]
        check(orr["launches"] == flash_calls(cfg), f"{arch}: generate "
              f"launched flash_attention {orr['launches']} times; the "
              f"prefill has {flash_calls(cfg)} attention layers")
        check(orr["others"] == (0, 0, 0), f"{arch}: generate launched wkv6,"
              f" sm_issue or sm_quantum: {orr['others']}")
        check(tuple(toks.shape) == (MOE_BATCH, MOE_NEW),
              f"{arch}: generate returned {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{arch}: generate returned tokens outside the vocabulary")
        check(bool(torch.isfinite(orr["logits"]).all()),
              f"{arch}: prefill logits not finite")
        check(torch.equal(toks[:, 0],
                          torch.argmax(orr["logits"], -1).int()),
              f"{arch}: generate's first token is not the prefill's argmax")
        check(all(orr["agree"]), f"{arch}: generate's tokens differ across "
              "repeats, or from the separately timed decode steps'")
        for s_, steps, diff, scale, finite in orr["cons"]:
            check(finite and diff <= CONSISTENCY_TOL * scale,
                  f"{arch} cache consistency at {s_} tokens ({s_ - steps} "
                  f"+ {steps} steps): max |diff| {diff} > {CONSISTENCY_TOL}"
                  f" x max |logit| {scale}, or not finite")
        if orr["in_model"] is not None:
            check(orr["in_model"] <= CONSISTENCY_TOL, f"{arch}: "
                  f"flash_attention vs attention_plain inside the model: "
                  f"{orr['in_model']} > {CONSISTENCY_TOL}")
    check(moe["arctic-480b"]["launches"] > 0,
          "the MoE path never launched flash_attention")
    torch.cuda.empty_cache()

    marks.append(("j", time.perf_counter()))
    # j. the reduced jamba and whisper-base against the JAX package's golden
    jr, jr_new = phase_reduced_golden(torch, FA, HYBRID_GOLDEN)
    for arch, r in jr.items():
        c = r["cfg"]
        kind = (f"{c.n_enc_layers} encoder / {c.n_layers} decoder layers"
                if c.enc_dec else f"{c.n_layers // len(c.block_pattern)} "
                f"period of {c.block_pattern}, {c.moe.n_experts} experts "
                f"top-{c.moe.top_k}")
        print(f"[j hybrid reduced] {arch} reduced ({kind}, d_model "
              f"{c.d_model}), prompt {r['shape']}: golden OK (weights sum "
              f"|w| {r['weights_sum']:.6f}; prefill logits max abs err "
              f"{r['errs']['prefill_logits']:.3e}, decode "
              f"{r['errs']['decode_logits']:.3e}; {jr_new} greedy tokens "
              f"equal), {r['launches']} flash_attention launches in the "
              f"prefill", flush=True)

    marks.append(("p", time.perf_counter()))
    # p. jamba-v0.1-52b at full width, one period of its four
    cfg = moe_config(JAMBA_ARCH, JAMBA_LAYERS)
    pr = phase_generate_full(torch, FA, W, K, Q, cfg, MOE_BATCH, MOE_PROMPT,
                             MOE_NEW, MOE_REPEATS, MOE_CONS_CASES,
                             no_drop(cfg))
    torch.cuda.empty_cache()
    t, m = pr["times"], cfg.moe
    n_pre, n_dec = MOE_BATCH * MOE_PROMPT, MOE_BATCH * (MOE_NEW - 1)
    print(f"[p jamba full] {JAMBA_ARCH} cut to {cfg.n_layers} layers (1 of "
          f"4 periods {cfg.block_pattern}), d_model {cfg.d_model}, Mamba "
          f"d_inner {cfg.ssm.expand * cfg.d_model} d_state "
          f"{cfg.ssm.d_state} dt_rank {cfg.ssm.dt_rank} conv "
          f"{cfg.ssm.d_conv}, attention {cfg.n_heads} query / "
          f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, "
          f"{m.n_experts} experts top-{m.top_k} of width {m.d_ff_expert} on "
          f"odd sublayers, d_ff {cfg.d_ff}, capacity factor "
          f"{m.capacity_factor}, vocab {cfg.vocab_size}; {pr['n_params']} "
          f"parameters f32, init {pr['init_s']:.2f} s; on {card}: generate "
          f"batch {MOE_BATCH}, prompt {MOE_PROMPT}, {MOE_NEW} new, medians "
          f"of {MOE_REPEATS} windows: generate wall {t['generate'][0]:.3f} s "
          f"(range {t['generate'][1]:.3f}-{t['generate'][2]:.3f}); prefill "
          f"{t['prefill'][0]:.3f} s = {n_pre / t['prefill'][0]:.1f} tok/s; "
          f"decode inside generate {t['generate - prefill'][0]:.3f} s = "
          f"{n_dec / t['generate - prefill'][0]:.1f} tok/s, "
          f"{t['generate - prefill'][0] * 1e3 / (MOE_NEW - 1):.2f} ms per "
          f"step; the {MOE_NEW - 1} decode steps timed alone "
          f"{t['decode'][0] * 1e3 / (MOE_NEW - 1):.2f} ms per step (range "
          f"{t['decode'][1] * 1e3 / (MOE_NEW - 1):.2f}-"
          f"{t['decode'][2] * 1e3 / (MOE_NEW - 1):.2f}); peak device memory "
          f"{pr['peak'] / 2**30:.3f} GiB; {pr['launches']} flash_attention "
          f"launches per generate (wkv6, sm_issue, sm_quantum: "
          f"{pr['others']}); {MOE_REPEATS} repeats give the same tokens: "
          f"{pr['agree']}; sample {pr['sample']}", flush=True)
    for s_, steps, diff, scale, finite in pr["cons"]:
        print(f"[p jamba full] cache consistency at capacity factor "
              f"{no_drop(cfg).moe.capacity_factor} (no drops): prefill of "
              f"{s_} tokens vs {s_ - steps} + {steps} decode steps: max "
              f"|diff| {diff:.3e}, max |logit| {scale:.3f} (ratio "
              f"{diff / scale:.3e}, limit {CONSISTENCY_TOL}), finite "
              f"{finite}", flush=True)
    print(f"[p jamba full] flash_attention vs attention_plain inside the "
          f"model, prefill of 128 tokens: max |diff| / max |logit| "
          f"{pr['in_model']:.3e} (limit {CONSISTENCY_TOL})", flush=True)
    for name, w in pr["windows"].items():
        print(f"[p jamba full] profile of {name}: wall {w['wall']:.3f} s, "
              f"device busy {w['busy']:.4f} s (idle share "
              f"{1 - w['busy'] / w['wall']:.4f}), {w['n']} device "
              f"activities; top: " + "; ".join(
                  f"{n[:60]} {us / 1e3:.2f} ms" for n, us in w["top"]),
              flush=True)

    marks.append(("w", time.perf_counter()))
    # w. whisper-base at full size: prefill and a greedy decode loop
    wr_ = phase_whisper_full(torch, FA, W, K, Q)
    torch.cuda.empty_cache()
    c, t = wr_["cfg"], wr_["times"]
    n_dec = WHISPER_BATCH * (WHISPER_NEW - 1)
    print(f"[w whisper full] {WHISPER_ARCH} ({c.n_enc_layers} encoder and "
          f"{c.n_layers} decoder layers, d_model {c.d_model}, {c.n_heads} "
          f"heads of {c.resolved_head_dim}, d_ff {c.d_ff}, vocab "
          f"{c.vocab_size}; {wr_['n_params']} parameters f32, init "
          f"{wr_['init_s']:.2f} s; on {card}): batch {WHISPER_BATCH} x "
          f"1500 frames, prompt {WHISPER_PROMPT}, {WHISPER_NEW} new, medians "
          f"of {WHISPER_REPEATS} windows: prefill {t['prefill'][0]:.4f} s "
          f"(range {t['prefill'][1]:.4f}-{t['prefill'][2]:.4f}), "
          f"{WHISPER_NEW - 1} decode steps {t['decode'][0]:.3f} s = "
          f"{n_dec / t['decode'][0]:.1f} tok/s, "
          f"{t['decode'][0] * 1e3 / (WHISPER_NEW - 1):.3f} ms per step "
          f"(range {t['decode'][1] * 1e3 / (WHISPER_NEW - 1):.3f}-"
          f"{t['decode'][2] * 1e3 / (WHISPER_NEW - 1):.3f}); peak device "
          f"memory {wr_['peak'] / 2**30:.3f} GiB; {wr_['launches']} "
          f"flash_attention launches per prefill + decode loop (wkv6, "
          f"sm_issue, sm_quantum: {wr_['others']}); windows give the same "
          f"tokens: {wr_['agree']}; sample {wr_['sample']}", flush=True)
    s_, steps, diff, scale, finite = wr_["cons"]
    print(f"[w whisper full] cache consistency: prefill of {s_} tokens vs "
          f"{s_ - steps} + {steps} decode steps: max |diff| {diff:.3e}, max "
          f"|logit| {scale:.3f} (ratio {diff / scale:.3e}, limit "
          f"{CONSISTENCY_TOL}), finite {finite}; flash_attention vs "
          f"attention_plain inside the model (prefill of {WHISPER_PROMPT}): "
          f"max |diff| / max |logit| {wr_['in_model']:.3e}", flush=True)
    for name, w in wr_["windows"].items():
        print(f"[w whisper full] profile of {name}: wall {w['wall']:.4f} s, "
              f"device busy {w['busy']:.4f} s (idle share "
              f"{1 - w['busy'] / w['wall']:.4f}), {w['n']} device "
              f"activities; top: " + "; ".join(
                  f"{n[:60]} {us / 1e3:.2f} ms" for n, us in w["top"]),
              flush=True)
    for arch, r in jr.items():
        check(r["launches"] == flash_calls(r["cfg"]), f"{arch} reduced: "
              f"{r['launches']} flash_attention launches in the prefill")
    toks = pr["toks"]
    check(pr["launches"] == flash_calls(cfg) == 1, f"{JAMBA_ARCH}: "
          f"generate launched flash_attention {pr['launches']} times; the "
          f"period has one attention sublayer")
    check(pr["others"] == (0, 0, 0) and wr_["others"] == (0, 0, 0),
          f"jamba or whisper launched wkv6, sm_issue or sm_quantum: "
          f"{pr['others']}, {wr_['others']}")
    check(tuple(toks.shape) == (MOE_BATCH, MOE_NEW)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{JAMBA_ARCH}: generate returned {tuple(toks.shape)} or tokens "
          "outside the vocabulary")
    check(bool(torch.isfinite(pr["logits"]).all()) and torch.equal(
        toks[:, 0], torch.argmax(pr["logits"], -1).int()),
        f"{JAMBA_ARCH}: prefill logits not finite, or generate's first "
        "token is not their argmax")
    check(all(pr["agree"]), f"{JAMBA_ARCH}: generate's tokens differ "
          "across repeats, or from the separately timed decode steps'")
    for s_, steps, diff, scale, finite in pr["cons"]:
        check(finite and diff <= CONSISTENCY_TOL * scale,
              f"{JAMBA_ARCH} cache consistency at {s_} tokens ({s_ - steps}"
              f" + {steps} steps): max |diff| {diff} > {CONSISTENCY_TOL} x "
              f"max |logit| {scale}, or not finite")
    check(pr["in_model"] <= CONSISTENCY_TOL, f"{JAMBA_ARCH}: "
          f"flash_attention vs attention_plain inside the model: "
          f"{pr['in_model']} > {CONSISTENCY_TOL}")
    c, toks = wr_["cfg"], wr_["toks"]
    check(wr_["launches"] == flash_calls(c), f"{WHISPER_ARCH}: "
          f"{wr_['launches']} flash_attention launches per prefill, not "
          f"{flash_calls(c)}")
    check(tuple(toks.shape) == (WHISPER_BATCH, WHISPER_NEW)
          and bool(((toks >= 0) & (toks < c.vocab_size)).all())
          and bool(torch.isfinite(wr_["logits"]).all()),
          f"{WHISPER_ARCH}: greedy tokens {tuple(toks.shape)} outside the "
          "vocabulary, or logits not finite")
    check(all(wr_["agree"]), f"{WHISPER_ARCH}: the windows' tokens differ")
    s_, steps, diff, scale, finite = wr_["cons"]
    check(finite and diff <= CONSISTENCY_TOL * scale, f"{WHISPER_ARCH} "
          f"cache consistency at {s_} tokens ({s_ - steps} + {steps} "
          f"steps): max |diff| {diff} > {CONSISTENCY_TOL} x max |logit| "
          f"{scale}, or not finite")
    check(wr_["in_model"] <= CONSISTENCY_TOL, f"{WHISPER_ARCH}: "
          f"flash_attention vs attention_plain inside the model: "
          f"{wr_['in_model']} > {CONSISTENCY_TOL}")

    marks.append(("k", time.perf_counter()))
    # k. the backward kernels against their plain versions, and their time
    t_k = time.perf_counter()
    bwd_regs = {}
    for name, inf in bwd_info.items():
        bwd_regs[name] = regs = ptxas_spills(
            inf["log"], r"(wkv6_bwd_kernel|flash_bwd_dq|flash_bwd_dkdv)"
                        r"I(f|13__nv_bfloat16)?Li(\d+)E")
        print(f"[k build] {name} built in {inf['seconds']:.2f} s beside the "
              f"others (loaded {bwd_build_s:.2f} s after the start); ptxas "
              "(kernel/head size: registers, spill stores/loads in bytes): "
              + " | ".join(f"{i}: {n} registers, spills {a}/{b}"
                           for i, n, a, b in regs), flush=True)
    check(all(regs and not any(a or b for _, _, a, b in regs)
              for regs in bwd_regs.values()),
          f"ptxas spilled registers in a backward kernel: {bwd_regs}")
    kr_ = phase_backward(torch, W, FA)
    b_, s_, h_, hs_ = WKV_FULL_SHAPE
    print(f"[k backward] wkv6_bwd == autograd of wkv6_plain in f64 on "
          f"{kr_['wkv_cases']} cases (hs 16/32/64 x S 64 and 100, a final-"
          f"state adjoint at S 100, log decay ~-20 at chunk 1 (S 100 and "
          f"37), ~-1e-6, a model position's {WKV_TP_SHAPE} and "
          f"{WKV_FULL_SHAPE}): max abs err "
          f"{kr_['wkv_err']:.3e}, worst "
          f"{kr_['wkv_worst']:.3e} of each gradient's largest magnitude "
          f"(limit {BWD_TOL}); at {WKV_FULL_SHAPE}: kernel "
          f"{kr_['wkv_ms'] * 1e3:.2f} us/launch on the device "
          f"({'profiler' if kr_['wkv_timed'] else 'not profiled: events'}), "
          f"wrapper {kr_['wkv_wrapper_ms'] * 1e3:.2f} us/call, plain (f32) "
          f"{kr_['wkv_plain_ms'] * 1e3:.2f} us/call, bound "
          f"{kr_['wkv_bound_ms'] * 1e3:.2f} us ({kr_['wkv_bound_by']}: "
          f"{kr_['wkv_bytes']} B, {kr_['wkv_ops']} ops in {TF32_PASSES} "
          f"TF32 passes; on the CUDA cores "
          f"{kr_['wkv_cuda_core_ms'] * 1e3:.2f} us); two calls with a "
          f"final-state adjoint give the same bits: {kr_['wkv_same_bits']}",
          flush=True)
    print(f"[k backward] flash_attention_bwd == attention_backward_plain in "
          f"f64 on {kr_['flash_cases']} cases (GQA 8/2, MHA 8/8, 4/1, "
          f"Sq < Sk 70/130 and 33/72, hd 16/32/64/128, the ragged key "
          f"block 64-99 on the causal diagonal, causal and full, "
          f"{FLASH_FULL_SHAPE}, qwen2-vl-2b's {FLASH_QWEN_VL_SHAPE} (GQA "
          f"12/2) and {FLASH_QWEN_VL_TP_SHAPE} (a model position's, 6/1), "
          f"its seqpar slabs {FLASH_SEQPAR_SHAPE} over 128, 640 and 1024 "
          f"keys (causal right-aligned, Sq < Sk), whisper-base's (2, 2) "
          f"model-position shapes "
          f"{[(v[0], v[1]) for v in WHISPER_TP_CASES.values()]}, "
          f"Whisper's encoder "
          f"{WHISPER_FLASH_CASES['encoder'][0]} and, non-causal only, "
          f"{FLASH_WIDE_CASE[1]} queries over {FLASH_WIDE_CASE[5]} keys): "
          f"max abs err {kr_['flash_err']:.3e}, worst "
          f"{kr_['flash_worst']:.3e} of each gradient's largest magnitude "
          f"(limit {BWD_TOL}); at (B {b_}, S {FLASH_FULL_SHAPE[1]}, H "
          f"{FLASH_FULL_SHAPE[2]}, KV {FLASH_FULL_SHAPE[3]}, hd "
          f"{FLASH_FULL_SHAPE[4]}), causal: kernels "
          f"{kr_['flash_ms'] * 1e3:.2f} us/call on the device (two "
          f"launches: " + ", ".join(
              f"{n} {'-' if t is None else f'{t * 1e3:.2f}'} us"
              for n, t in kr_["flash_parts_ms"].items()) + "; "
          f"{'profiler' if kr_['flash_timed'] else 'not profiled: events'}),"
          f" wrapper {kr_['flash_wrapper_ms'] * 1e3:.2f} us/call, plain "
          f"{kr_['flash_plain_ms'] * 1e3:.2f} us/call, autograd's backward "
          f"of SDPA (enable_gqa) {kr_['library_ms'] * 1e3:.2f} us/call (max "
          f"abs err {kr_['library_err']:.3e} from the kernels), bound "
          f"{kr_['flash_bound_ms'] * 1e3:.2f} us ({kr_['flash_bound_by']}: "
          f"{kr_['flash_ops']} ops in {TF32_PASSES} TF32 passes, "
          f"{kr_['flash_bytes']} B; on the CUDA cores "
          f"{kr_['flash_cuda_core_ms'] * 1e3:.2f} us); two calls give the "
          f"same bits: {kr_['flash_same_bits']}; phase k "
          f"{time.perf_counter() - t_k:.1f} s", flush=True)
    fe = kr_["flash_encoder"]
    how = "profiler" if fe["timed"] else "not profiled: events"
    print(f"[k backward] flash_attention_bwd at whisper-base's encoder "
          f"shape {WHISPER_FLASH_CASES['encoder'][0]} over 1500 keys, "
          f"non-causal (held above with the others, and at the non-causal "
          f"Sq > Sk case {FLASH_WIDE_CASE}): kernels {fe['ms'] * 1e3:.2f} "
          f"us/call on the device ({how}), bound "
          f"{fe['bound_ms'] * 1e3:.2f} us "
          f"({fe['bound_by']}); two calls give the same bits: "
          f"{fe['same_bits']}", flush=True)
    for arch, c in kr_["ep_tp"].items():
        print(f"[k backward] flash_attention_bwd at {arch}'s attention on a "
              f"(2, 2) mesh's model position {tuple(c['shape'])} (held "
              f"above with the others), causal: kernels "
              f"{c['ms'] * 1e3:.2f} us/call on the device ("
              + ("profiler" if c["timed"] else "not profiled: events")
              + f"), autograd's backward of SDPA (enable_gqa) "
              f"{c['library_ms'] * 1e3:.2f} us/call, bound "
              f"{c['bound_ms'] * 1e3:.2f} us ({c['bound_by']}); two calls "
              f"give the same bits: {c['same_bits']}", flush=True)
    check(kr_["wkv_same_bits"] and kr_["flash_same_bits"]
          and fe["same_bits"]
          and all(c["same_bits"] for c in kr_["ep_tp"].values()),
          "a backward kernel gave other bits on a second call")
    t_kb = time.perf_counter()
    kb = phase_backward_bf16(torch, FA)
    print(f"[k backward bf16] flash_attention_bwd in bf16 (mma.sync "
          f"m16n8k16 on bf16 operands, one pass) against "
          f"attention_backward_plain in f64 on the same bf16 inputs, on the "
          f"f32 form's {kb['cases']} cases: max abs err {kb['err']:.3e}, "
          f"worst {kb['worst']:.3e} of each gradient's largest magnitude "
          f"(limit {FLASH_TOLS['bfloat16']}); autograd's backward of SDPA "
          f"(enable_gqa) in bf16 on the same inputs: worst "
          f"{kb['lib_worst']:.3e}; the kernels' distance over SDPA's, "
          f"worst case {kb['ratio']:.3f} (limit {BF16_WITNESS}); every "
          f"gradient bf16 and finite, two calls the same bits: "
          f"{not kb['bad']}; {time.perf_counter() - t_kb:.1f} s",
          flush=True)
    f32_ms = {"full": kr_["flash_ms"], "whisper encoder": fe["ms"],
              **{f"{a} (2, 2)": c["ms"] for a, c in kr_["ep_tp"].items()}}
    for name, r in kb["timed"].items():
        parts = ("" if "parts_ms" not in r else " (" + ", ".join(
            f"{n} {'-' if t is None else f'{t * 1e3:.2f}'} us"
            for n, t in r["parts_ms"].items()) + ")")
        print(f"[k backward bf16] at {name} {tuple(r['shape'])} over "
              f"{r['sk']} keys, {'causal' if r['causal'] else 'non-causal'}"
              f" ({card}): bf16 kernels "
              + f"{r['ms'] * 1e3:.2f} us/call on the device "
              + ("(profiler" if r["timed"] else "(not profiled: events")
              + f"){parts}, wrapper "
              f"{r['wrapper_ms'] * 1e3:.2f} us/call; f32 kernels "
              f"{f32_ms[name] * 1e3:.2f} us; autograd's backward of SDPA "
              f"(enable_gqa) in bf16 {r['library_ms'] * 1e3:.2f} us/call "
              f"(events; device time by the profiler "
              + ("-" if r["library_profiler_ms"] is None
                 else f"{r['library_profiler_ms'] * 1e3:.2f}")
              + " us); plain (f32 arithmetic)"
              f" {r['plain_ms'] * 1e3:.2f} us/call; bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: {r['ops']} "
              f"ops at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, {r['bytes']} B)",
              flush=True)
    check(not kb["bad"], f"flash_attention_bwd in bf16 failed at "
          f"{kb['bad'][:4]}")

    marks.append(("x", time.perf_counter()))
    # x. training at full width through make_train_step, then the launcher
    t_x = time.perf_counter()
    train = {}
    for arch, n_layers, batch, seq in TRAIN_CASES:
        train[arch] = xr = phase_train(torch, W, FA, arch, n_layers, batch,
                                       seq)
        torch.cuda.empty_cache()
        c = xr["cfg"]
        name = "wkv6" if c.family == "ssm" else "flash_attention"
        walls = [r["wall"] for r in xr["rows"][1:]]
        step_s = float(np.median(walls))
        p = xr["profile"]
        print(f"[x train] {arch} ({c.n_layers} layers, d_model {c.d_model}, "
              f"vocab {c.vocab_size}; {xr['n_params']} f32 parameters, init "
              f"{xr['init_s']:.2f} s), batch {batch} x seq {seq}, AdamW "
              f"{TRAIN_OPT}, deterministic kernels: on {card}: step "
              f"{step_s:.3f} s (median of steps 1-{2 * TRAIN_STEPS - 1}: "
              f"{', '.join(f'{x:.3f}' for x in walls)}; step 0 "
              f"{xr['rows'][0]['wall']:.3f} s) = "
              f"{batch * seq / step_s:.1f} tokens/s; peak device memory "
              f"{xr['peak'] / 2**30:.3f} GiB; per step {name} forward "
              f"launches {[r['fwd'] for r in xr['rows']]}, backward calls "
              f"{[r['bwd'] for r in xr['rows']]}; loss "
              f"{[round(r['loss'], 4) for r in xr['rows']]}, grad_norm "
              f"{[round(r['grad_norm'], 4) for r in xr['rows']]}", flush=True)
        for key, depth in (("grad", TRAIN_CMP_LAYERS),
                           ("grad_deep", c.n_layers)):
            if key not in xr:
                continue
            g = xr[key]
            held = (f"limit {TRAIN_GRAD_TOL}" if key == "grad" else
                    "readings: no limit at this depth")
            step_w = ("" if "stepwise" not in g else
                      f"; the plain version in f32 at chunk 1 (stepwise) by "
                      f"{g['stepwise'][0]:.3e} (worst leaf "
                      f"{g['stepwise'][1]:.3e}, {g['stepwise'][2]})")
            ln = g["layer_norms"]
            print(f"[x train] {arch} at full width, {depth} layers: "
                  f"gradients of the whole model (norm {g['grad_norm']:.4e}"
                  f"; layer {depth - 1} {ln[0]:.4e}, layer 0 {ln[1]:.4e}, "
                  f"embedding {ln[2]:.4e}), batch {batch} x {TRAIN_CMP_SEQ}, against the same "
                  f"model with the plain versions in f64: the kernels' "
                  f"differ by {g['kernel'][0]:.3e} of the gradient's norm "
                  f"(worst leaf {g['kernel'][1]:.3e} of its largest "
                  f"magnitude, {g['kernel'][2]}); the plain versions' in "
                  f"f32 by {g['plain'][0]:.3e} (worst leaf "
                  f"{g['plain'][1]:.3e}, {g['plain'][2]}){step_w}; {held}; "
                  f"loss kernels {g['loss'][0]:.6f}, f64 {g['loss'][1]:.6f}",
                  flush=True)
            if "call_errs" in g:
                e = g["call_errs"]
                print(f"[x train] {arch} at full width, {depth} layers: "
                      f"{len(e)} wkv6 calls' gradients as WKV6Function gave "
                      f"them ({g['calls']} forward calls kept, the "
                      f"recomputes included) against autograd of "
                      f"wkv6_plain in f64 on each call's inputs and output "
                      f"gradients: worst "
                      f"{max(e, default=float('nan')):.3e} of each "
                      f"gradient's largest magnitude (by call: "
                      f"{', '.join(f'{x:.1e}' for x in e)}); limit "
                      f"{BWD_TOL}", flush=True)
        print(f"[x train] {arch}: profile of one step: wall "
              f"{p['wall']:.3f} s, device busy {p['busy']:.4f} s (idle share "
              f"{1 - p['busy'] / p['wall']:.4f}), {p['n']} device "
              f"activities, {name} forward {p['fwd_us'] / 1e3:.3f} ms, "
              f"backward {p['bwd_us'] / 1e3:.3f} ms (together "
              f"{(p['fwd_us'] + p['bwd_us']) / 1e6 / p['wall']:.2%} of the "
              f"step's wall); top: " + "; ".join(
                  f"{n[:50]} {us / 1e3:.2f} ms" for n, us in p["top"]),
              flush=True)
        on, off = (float(np.median(xr["det_turns"][k])) for k in (True,
                                                                 False))
        print(f"[x train] {arch}: step with deterministic kernels on "
              f"{', '.join(f'{x:.3f}' for x in xr['det_turns'][True])} s, "
              f"off {', '.join(f'{x:.3f}' for x in xr['det_turns'][False])}"
              f" s (on/off/off/on; medians {on:.3f} / {off:.3f}, "
              f"{on / off - 1:+.2%})", flush=True)
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="train-launcher-")
    l_arch, _, l_batch, l_seq = LAUNCHER_CASE
    try:
        lr_ = _train_launcher(torch, ckpt, l_arch, l_batch, l_seq)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for run in lr_:
        same = ("" if "differ" not in run else
                f"; state bit-identical to the straight 6 steps: "
                f"{not run['differ']} ({len(run['differ'])} tensors differ)")
        print(f"[x train] launch/train.py --arch {l_arch} --full --batch "
              f"{l_batch} --seq {l_seq} {run['argv']}: wall "
              f"{run['wall']:.2f} s; {' | '.join(run['lines'])}{same}",
              flush=True)
    print(f"[x train] phase x {time.perf_counter() - t_x:.1f} s", flush=True)
    check(kr_["wkv_worst"] <= BWD_TOL and kr_["flash_worst"] <= BWD_TOL,
          "a backward kernel disagrees with its plain version")
    for arch, xr in train.items():
        c = xr["cfg"]
        calls = c.n_layers if c.family == "ssm" else flash_calls(c)
        for r in xr["rows"]:
            check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
                  f"{arch} step {r['step']}: loss or grad_norm not finite")
            check(r["fwd"] == 2 * calls and r["bwd"] == calls,
                  f"{arch} step {r['step']}: {r['fwd']} forward launches "
                  f"and {r['bwd']} backward calls; {calls} a forward")
        g = xr["grad"]
        check(g["kernel"][0] <= TRAIN_GRAD_TOL,
              f"{arch} at {TRAIN_CMP_LAYERS} layers: the kernels' gradients "
              f"differ from the f64 plain versions' by {g['kernel'][0]} of "
              f"the gradient's norm")
        if "call_errs" in xr.get("grad_deep", {}):
            e = xr["grad_deep"]["call_errs"]
            check(len(e) == c.n_layers and max(e) <= BWD_TOL,
                  f"{arch}: {len(e)} wkv6 calls ran backward on "
                  f"{c.n_layers} layers, worst {max(e, default=0.0)} from "
                  f"the f64 plain form")
    _, first, second = lr_
    check(any("[train] done: 4 steps" in ln for ln in first["lines"]) and
          "[train] resumed from step 4" in second["lines"] and
          any("[train] done: 2 steps, final loss" in ln
              for ln in second["lines"]),
          f"launch/train.py did not resume: {second['lines']}")
    check(not second["differ"], f"{RWKV_ARCH}: launch/train.py's 4 + "
          f"resume + 2 differs from its 6 straight in "
          f"{second['differ'][:5]}")
    # bf16: qwen2-vl-2b whole, unsharded
    t_xb = time.perf_counter()
    xb = phase_train_bf16(torch, FA)
    c = xb["cfg"]
    x_walls = [r["wall"] for r in xb["rows"]]
    x_step_s = float(np.median(x_walls[1:]))
    (lk, nk, gk), (lp, np_, gp), (lt, nt) = (xb["kernels"], xb["plain"],
                                             xb["f32"])
    print(f"[x train bf16] {c.name} whole ({c.n_layers} layers, d_model "
          f"{c.d_model}; {xb['n_params']} parameters in {xb['dtypes']}, "
          f"moments {xb['moments']}, init {xb['init_s']:.2f} s), batch "
          f"{SHARD_BATCH} x seq {SHARD_SEQ}, unsharded, AdamW {TRAIN_OPT}, "
          f"deterministic kernels, on {card}: step {x_step_s:.3f} s (median "
          f"of steps 1-{TRAIN_STEPS - 1}: "
          f"{', '.join(f'{x:.3f}' for x in x_walls[1:])}; step 0 "
          f"{x_walls[0]:.3f} s) = {SHARD_BATCH * SHARD_SEQ / x_step_s:.1f} "
          f"tokens/s, beside the same model in f32 unsharded at 8 x 512, "
          f"{BF16_TRAIN_F32_STEP_S} s a step (PERF.md §5); peak device "
          f"memory {xb['peak'] / 2**30:.3f} GiB; per step flash_attention "
          f"launches {[r['fwd'] for r in xb['rows']]}, backward calls "
          f"{[r['bwd'] for r in xb['rows']]}, launches by dtype "
          f"{xb['tally']}; loss {[round(r['loss'], 5) for r in xb['rows']]}"
          f", ce {[round(r['ce'], 5) for r in xb['rows']]}, grad_norm "
          f"{[round(r['grad_norm'], 5) for r in xb['rows']]}; the first "
          f"batch before any step, loss / grad_norm: kernels {lk:.6f} / "
          f"{nk:.6f}, attention_plain in bf16 (the witness) {lp:.6f} / "
          f"{np_:.6f}, the same weights in f32 (the truth) {lt:.6f} / "
          f"{nt:.6f}: distances {abs(lk - lt):.3e} / {abs(nk - nt):.3e}, "
          f"the witness's {abs(lp - lt):.3e} / {abs(np_ - nt):.3e}; "
          f"gradients' worst / median leaf from the truth: kernels "
          f"{gk[0]:.4e} / {gk[1]:.4e}, the witness {gp[0]:.4e} / "
          f"{gp[1]:.4e} (loss and leaves limit {BF16_WITNESS}x the "
          f"witness's); {time.perf_counter() - t_xb:.1f} s", flush=True)
    x_calls = flash_calls(c)
    for r in xb["rows"]:
        check(all(np.isfinite(r[k]) for k in ("loss", "ce", "grad_norm")),
              f"{c.name} bf16 step {r['step']}: a metric not finite")
        check(r["fwd"] == 2 * x_calls and r["bwd"] == x_calls,
              f"{c.name} bf16 step {r['step']}: {r['fwd']} forward "
              f"launches and {r['bwd']} backward calls; {x_calls} a forward")
    x_n = len(xb["rows"])
    check(xb["dtypes"] == ["bfloat16"] and xb["tally"] == {
        ("fwd", "bf16"): 2 * x_calls * x_n, ("bwd", "bf16"): x_calls * x_n},
        f"{c.name} bf16: launches by dtype {xb['tally']}")
    check(witnessed(lk, lp, lt) and gk[0] <= BF16_WITNESS * gp[0]
          and gk[1] <= BF16_WITNESS * gp[1],
          f"{c.name} bf16: the kernels' first loss {lk} and worst / median "
          f"leaf {gk} against the f32 truth ({lt}), beyond {BF16_WITNESS}x "
          f"the witness's {lp} / {gp}")

    marks.append(("y", time.perf_counter()))
    # y. the reduced MoE models, jamba and whisper-base trained on the
    # card, restarted bit for bit; then the MoE models and jamba by the
    # sharded step on a SHARD_Y_MESH mesh of the card, against the same on
    # the CPU
    yr, y_shapes = {}, {}
    mesh_text = "x".join(map(str, SHARD_Y_MESH))
    for name in (MOE_GOLDEN, HYBRID_GOLDEN):
        got, y_shape = phase_reduced_train(torch, FA, name)
        yr.update(got)
        y_shapes.update({arch: y_shape for arch in got})
    for name in (MOE_GOLDEN, HYBRID_GOLDEN):
        got, y_shape = phase_reduced_train(
            torch, FA, name, SHARD_Y_MESH,
            [a for a in SHARD_Y_ARCHS if a in _golden_archs(name)])
        yr.update({f"{arch} on a {mesh_text} mesh": r
                   for arch, r in got.items()})
        y_shapes.update({f"{arch} on a {mesh_text} mesh": y_shape
                         for arch in got})
    # the MoE, MLA and jamba families on a model axis: each placement of
    # the experts by ctx.ep_axes, MLA's heads and Mamba's d_inner split
    for name, arch, mesh, rows in SHARD_Y_EP:
        got, y_shape = phase_reduced_train(torch, FA, name, mesh, [arch],
                                           rows=rows)
        text = "x".join(map(str, mesh))
        yr.update({f"{arch} on a {text} mesh": r for arch, r in got.items()})
        y_shapes.update({f"{arch} on a {text} mesh": y_shape for arch in got})
    # the model axis: the head_dim split, RWKV's cut heads, Whisper (the
    # hybrid golden's seeds, and its JAX loss for Whisper)
    tp_text = "x".join(map(str, SHARD_Y_TP_MESH))
    got, y_shape = phase_reduced_train(torch, FA, HYBRID_GOLDEN,
                                       SHARD_Y_TP_MESH, SHARD_Y_TP_ARCHS, W=W)
    yr.update({f"{arch} on a {tp_text} mesh": r for arch, r in got.items()})
    y_shapes.update({f"{arch} on a {tp_text} mesh": y_shape for arch in got})
    for arch, r in yr.items():
        c, y_shape = r["cfg"], y_shapes[arch]
        card_loss, cpu_loss = r["losses"]["card"], r["losses"]["cpu"]
        desc = ", ".join(x for x in (
            f"{c.n_layers} layers",
            c.moe and f"{c.moe.n_experts} experts top-{c.moe.top_k}",
            c.block_pattern and "Mamba and attention periods",
            c.enc_dec and f"{c.n_enc_layers} encoder layers") if x)
        jax_text = ("no JAX golden loss for this arch" if r["jax"] is None
                    else f"the JAX package {r['jax']:.7f} (rel "
                    f"{abs(card_loss / r['jax'] - 1):.2e})")
        print(f"[y train reduced] {arch} reduced ({desc}), batch "
              f"{y_shape.global_batch} x {y_shape.seq_len}, deterministic "
              f"kernels: loss of the golden's batch on the card "
              f"{card_loss:.7f}, the port on the CPU {cpu_loss:.7f} "
              f"(rel {abs(card_loss / cpu_loss - 1):.2e}), {jax_text}; "
              f"{TRAIN_STEPS} steps, save, {TRAIN_STEPS} steps, restore, "
              f"{TRAIN_STEPS} steps: state bit-identical to the straight "
              f"run: {not r['differ']} ({len(r['differ'])} tensors differ), "
              f"metrics equal: {r['metrics_equal']}; per step "
              f"{r['kernel']} forward launches "
              f"{[x['fwd'] for x in r['rows']]}, backward calls "
              f"{[x['bwd'] for x in r['rows']]}; loss "
              f"{[round(x['loss'], 4) for x in r['rows']]}, aux "
              f"{[round(x['aux'], 4) for x in r['rows']]}", flush=True)
        v = r["vs_cpu"]
        print(f"[y train reduced] {arch} reduced: the straight "
              f"{2 * TRAIN_STEPS} steps on the card against the same steps "
              f"by the port on the CPU: worst relative difference loss "
              f"{v['loss']:.2e}, ce {v['ce']:.2e}, aux {v['aux']:.2e} "
              f"(limit {MOE_TRAIN_METRIC_TOL}), grad_norm "
              f"{v['grad_norm']:.2e} (limit {y_grad_tol(c)}); the "
              f"parameters after them {v['params']:.2e} of a leaf's "
              f"largest magnitude (limit {MOE_TRAIN_PARAM_TOL}); CPU "
              f"grad_norm {[round(x['grad_norm'], 4) for x in r['cpu_rows']]}"
              f", card {[round(x['grad_norm'], 4) for x in r['rows']]}",
              flush=True)
    for arch, r in yr.items():
        card_loss = r["losses"]["card"]
        check(abs(card_loss / r["losses"]["cpu"] - 1) <= 1e-5
              and (r["jax"] is None or abs(card_loss / r["jax"] - 1) <= 1e-5),
              f"{arch} reduced: the card's loss {card_loss} is not within "
              f"1e-5 of the CPU port's {r['losses']['cpu']} and the JAX "
              f"package's {r['jax']}")
        for x in r["rows"] + r["again"]:
            check(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]),
                  f"{arch} reduced step {x['step']}: not finite")
            n = r["calls"]
            check(x["fwd"] == 2 * n and x["bwd"] == n,
                  f"{arch} reduced step {x['step']}: {x['fwd']} forward "
                  f"launches and {x['bwd']} backward calls of {r['kernel']} "
                  f"for {n} launches a forward")
        check(not r["differ"] and r["metrics_equal"], f"{arch} reduced: 3 + "
              f"restore + 3 differs from the straight run in "
              f"{r['differ'][:5]}")
        v = r["vs_cpu"]
        check(max(v["loss"], v["ce"], v["aux"]) <= MOE_TRAIN_METRIC_TOL
              and v["grad_norm"] <= y_grad_tol(r["cfg"])
              and v["params"] <= MOE_TRAIN_PARAM_TOL,
              f"{arch} reduced: the card's training departs from the CPU "
              f"port's ({v})")

    # the reduced configs served and evaluated on a mesh of the card
    # (models/sharded.py), each against the same calls unsharded
    ys = phase_serve_reduced(torch, FA, W)
    report_serve_reduced(ys, card)

    marks.append(("z", time.perf_counter()))
    # z. qwen2-vl-2b whole, trained by the sharded step on a (2, 2) and a
    # (1, 8) mesh repeating this card (the latter through seqpar_attention
    # in every layer), and at its widths cut in depth on a (4, 1) mesh;
    # whisper-base whole on a (2, 2) mesh; rwkv6-1.6b at full width on a
    # (1, 2) mesh; each against the unsharded step
    t_z = time.perf_counter()
    zr = phase_shard_train(torch, FA, n_layers=SHARD_TP_LAYERS)
    report_shard_train(zr, card, "cuda:0")
    zs_mesh, zs_batch, zs_seq, zs_layers = SHARD_SEQPAR
    zs = phase_shard_train(torch, FA, batch=zs_batch, seq=zs_seq,
                           meshes=(zs_mesh,), n_layers=zs_layers)
    report_shard_train(zs, card, "cuda:0")
    z_arch, z_mesh, z_batch, z_seq = SHARD_WHISPER
    zh = phase_shard_train(torch, FA, arch=z_arch, batch=z_batch,
                           seq=z_seq, meshes=(z_mesh,))
    report_shard_train(zh, card, "cuda:0")
    zd_mesh, zd_layers = SHARD_DP
    zd = phase_shard_train(torch, FA, n_layers=zd_layers, meshes=(zd_mesh,))
    report_shard_train(zd, card, "cuda:0")
    r_arch, r_layers, r_batch, r_meshes = SHARD_RWKV
    zw = phase_shard_train(torch, FA, W=W, arch=r_arch, n_layers=r_layers,
                           batch=r_batch, meshes=r_meshes)
    report_shard_train(zw, card, "cuda:0")
    m_arch, m_layers, m_batch, m_meshes = SHARD_MLA
    zm = phase_shard_train(torch, FA, arch=m_arch, n_layers=m_layers,
                           batch=m_batch, meshes=m_meshes, keep="cpu")
    report_shard_train(zm, card, "cuda:0")
    # bf16: one sharded step on SHARD_SEQPAR's mesh through seqpar_attention
    zb = phase_shard_bf16(torch, FA)
    c, z_runs = zb["cfg"], zb["runs"]
    z_sh, z_un, z_tr = z_runs["sharded"], z_runs["unsharded"], z_runs["f32"]
    print(f"[z shard train bf16] {c.name} at {c.n_layers} layers, "
          f"{zb['batch']} x {zb['seq']} tokens, from the same weights and "
          f"batch ({card}): the f32 step unsharded (the truth) loss / "
          f"grad_norm {z_tr['first'][0]:.6f} / {z_tr['first'][1]:.6f}; "
          + "; ".join(
              f"bf16 {name} {r['first'][0]:.6f} / {r['first'][1]:.6f}, "
              f"gradients' worst / median leaf from the truth "
              f"{r['leaves'][0]:.4e} / {r['leaves'][1]:.4e}; its step: "
              f"wall {r['wall']:.3f} s, loss {r['loss']:.6f}, grad_norm "
              f"{r['grad_norm']:.6f}, flash_attention launches {r['fwd']}, "
              f"backward calls {r['bwd']}, by dtype {r['tally']}"
              for name, r in (("on " + str(zb["mesh"]) + " (seqpar_attention"
                               " in every layer)", z_sh), ("unsharded", z_un)))
          + f"; the mesh's leaves limit {BF16_WITNESS}x the unsharded's",
          flush=True)
    for name, r, want in (("sharded", z_sh, zb["calls"]),
                          ("unsharded", z_un, zb["calls_unsharded"])):
        check(all(np.isfinite(r[k]) for k in ("loss", "ce", "grad_norm")),
              f"{c.name} bf16 {name} step: a metric not finite")
        check(r["fwd"] == 2 * want and r["bwd"] == want and r["tally"] == {
            ("fwd", "bf16"): 2 * want, ("bwd", "bf16"): want},
            f"{c.name} bf16 {name} step: launches {r['fwd']} / {r['bwd']} "
            f"by dtype {r['tally']}; {want} a forward")
    check(z_sh["leaves"][0] <= BF16_WITNESS * z_un["leaves"][0]
          and z_sh["leaves"][1] <= BF16_WITNESS * z_un["leaves"][1],
          f"{c.name} bf16 on {zb['mesh']}: gradients' worst / median leaf "
          f"{z_sh['leaves']} from the f32 truth, beyond {BF16_WITNESS}x the "
          f"unsharded bf16 step's {z_un['leaves']}")
    print(f"[z shard train] phase z {time.perf_counter() - t_z:.1f} s",
          flush=True)

    marks.append(("n", time.perf_counter()))
    # n. serving on meshes of the card: qwen2-vl-2b whole on (2, 2), (1, 4)
    # and (1, 8), one per KV-cache layout, and rwkv6-1.6b whole on (1, 2),
    # each against its unsharded serving
    nr = {}
    for arch, layers, meshes, n_batch, n_prompt, n_new, held in \
            MESH_SERVE_CASES:
        r = phase_serve_mesh(torch, FA, W, arch, meshes, n_batch, n_prompt,
                             n_new, n_layers=layers, held=held)
        nr[arch if layers is None else f"{arch} at {layers} layers"] = r
        report_serve_mesh(r, card)

    marks.append(("u", time.perf_counter()))
    # u. the dry run's cost pass against live steps on the card
    ur = phase_cost(torch, FA, W)
    report_cost(ur, card)

    marks.append(("end", time.perf_counter()))
    print("[time] seconds by phase: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])),
        flush=True)
    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} "
          "s, the builds included", flush=True)

    def cost_launches(name):
        """A kernel's launches in phase u's live passes: [unsharded, on
        COST_MESH] by arch and step."""
        return {f"{r['arch']} {r['kind']} {r['dtype']}": [
            r["launches"][name], r.get("mesh_launches", {}).get(name)]
            for r in ur if name in r["launches"]}

    def shard_launches(key, *runs):
        """A kernel's launches (``key`` "fwd") or backward calls ("bwd")
        over the steps of each phase z run's first sharded run."""
        return {f"{r['cfg'].name} {m}": sum(
            x[key] for x in r["runs"][m, "sharded"]["rows"])
            for r in runs for m in r["meshes"]}

    # 6. per-kernel numbers
    print(json.dumps({"kernels": [{
        "name": "sm_issue", "route": "cuda",
        "source": "src/repro_torch/kernels/sm_issue/csrc/sm_issue.cu",
        "replaces": "src/repro/kernels/sm_issue/kernel.py:45",
        # the main path's launches (phase 4's fused runs: none, sm_quantum
        # took them over), beside the eager witness's and phase 2's
        "launches": main_issue, "witness_launches": witness_launches,
        # the per-cycle exchange of SM-axis sharding (phase m)
        "mesh_cycle_launches": mr["issue"],
        "compare_launches": kr["cases"],
        "max_abs_err": kr["max_abs_err"],
        "ms": kr["ms"], "plain_ms": kr["plain_ms"],
        "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
        "library_ms": None, "wrapper_ms": kr["wrapper_ms"],
        "us_per_launch": kr["ms"] * 1e3,
        "plain_us": kr["plain_ms"] * 1e3, "bound_us": kr["bound_ms"] * 1e3,
    }, {
        "name": "sm_quantum", "route": "cuda",
        "source": "src/repro_torch/kernels/sm_quantum/csrc/sm_quantum.cu",
        "replaces": "src/repro/kernels/sm_issue/kernel.py:45",
        # the sweeps' launches (phase s), beside the solo path's (phase 4),
        # the telemetry path's (phase t), the search path's (phase r) and
        # the server's (phase v)
        "launches": sr["launches"], "simulate_launches": main_launches,
        "telemetry_launches": tr["launches"],
        "search_launches": rr_["launches"],
        "serve_launches": vr["launches_all"],
        # the mesh path's (phase m: 1-D shards, 2-D meshes, launchers)
        "mesh_launches": mr["launches"],
        "max_abs_err": qr["max_abs_err"],
        "ms": qr["ms"], "plain_ms": qr["plain_ms"],
        "bound_ms": qr["bound_ms"], "bound_by": qr["bound_by"],
        "library_ms": None, "wrapper_ms": qr["wrapper_ms"],
        "by_lanes": [{k: row[k] for k in ("lanes", "ms", "wrapper_ms",
                                          "bound_ms", "bound_by")}
                     for row in qr["by_lanes"]],
    }, {
        "name": "wkv6", "route": "cuda",
        "cost_pass_launches": cost_launches("wkv6"),
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:65",
        "launches": fr["launches"], "max_abs_err": wr["max_abs_err"],
        "ms": wr["ms"], "plain_ms": wr["plain_ms"],
        "bound_ms": wr["bound_ms"], "bound_by": wr["bound_by"],
        "library_ms": None, "wrapper_ms": wr["wrapper_ms"],
        "shape": list(WKV_FULL_SHAPE),
        # the training path's (phase x, rwkv6-1.6b): the forward and the
        # recompute of every step
        "train_launches": sum(r["fwd"] for r in train[RWKV_ARCH]["rows"]),
        # the sharded training path's (phase z: rwkv6-1.6b's widths at 2
        # layers on a (1, 2) mesh), each model position on half the heads
        "shard_train_launches": {str(m): sum(
            r["fwd"] for r in zw["runs"][m, "sharded"]["rows"])
            for m in zw["meshes"]},
        "tp_shape": list(WKV_TP_SHAPE),
        # the sharded serving path's (phase n: rwkv6-1.6b whole on a (1, 2)
        # mesh, each model position on half the heads): launches per
        # prefill, and the kernel at that position's shape
        "serve_launches": {f"{arch} {m}": run["launches"]
                           for arch, r in nr.items() if r["kernel"] == "wkv6"
                           for m, run in r["runs"].items()},
        "serve_shape": nr[RWKV_ARCH]["k2"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "cost_pass_launches": cost_launches("flash_attention"),
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:65",
        "launches": hr["launches"], "max_abs_err": ar["max_abs_err"],
        "ms": ar["ms"], "plain_ms": ar["plain_ms"],
        "bound_ms": ar["bound_ms"], "bound_by": ar["bound_by"],
        "library_ms": ar["library_ms"], "wrapper_ms": ar["wrapper_ms"],
        "cuda_core_bound_ms": ar["cuda_core_ms"],
        "shape": list(FLASH_FULL_SHAPE),
        # the training path's (phase x, minitron-8b's widths at 2 layers):
        # the forward and the recompute of every step
        "train_launches": sum(r["fwd"] for r in train[DENSE_ARCH]["rows"]),
        # in bf16: phase x's bf16 steps of qwen2-vl-2b whole, phase z's
        # bf16 sharded step (every launch bf16)
        "bf16_train_launches": {
            f"{BF16_TRAIN_ARCH} unsharded, {len(xb['rows'])} steps": sum(
                r["fwd"] for r in xb["rows"]),
            f"{zb['cfg'].name} {zb['mesh']}, 1 step":
                zb["runs"]["sharded"]["fwd"]},
        # the MoE path's (phase o): one generate of each model
        "moe_launches": {arch: r["launches"] for arch, r in moe.items()},
        # at arctic-480b's shape (phase f)
        "arctic_shape": {k: ar["arctic"][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
        # the sharded training path's (phase z: qwen2-vl-2b on a (2, 2),
        # a (1, 8) (seqpar's slabs) and, cut in depth, a (4, 1) mesh of
        # the card, whisper-base on (2, 2)): the forward and the
        # recompute of every position's rows, every step of the first
        # sharded run; at each mesh's per-position shape
        "shard_train_launches": shard_launches("fwd", zr, zs, zh, zd),
        "qwen_vl_shape": {k: ar["qwen_vl"][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
        "qwen_vl_tp_shape": {k: ar["qwen_vl_tp"][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")},
        # qwen2-vl-2b's seqpar slabs on a (1, 8) mesh (Sq 128, causal over
        # Sk keys) and whisper-base's shapes on a (2, 2) mesh's model
        # position (phase f)
        "seqpar_slabs": [{k: c[k] for k in (
            "shape", "sk", "causal", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")} for c in ar["seqpar"]],
        "whisper_tp_shapes": {name: {k: c[k] for k in (
            "shape", "sk", "causal", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for name, c in ar["whisper_tp"].items()},
        # arctic-480b's and jamba-v0.1-52b's on a (2, 2) mesh's model
        # position (phase f; scripts/shard_probes.py trains them there)
        "ep_tp_shapes": {arch: {k: c[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")} for arch, c in ar["ep_tp"].items()},
        # the sharded serving path's (phase n: qwen2-vl-2b whole on three
        # meshes of the card): launches per prefill; phase y's reduced
        # configs on their meshes; and at each serving mesh's per-position
        # prefill shape (phase f)
        "serve_launches": {f"{arch} {m}": run["launches"]
                           for arch, r in nr.items()
                           if r["kernel"] == "flash_attention"
                           for m, run in r["runs"].items()},
        "serve_reduced_launches": {
            f"{arch} {r['mesh']}": r["runs"]["sharded"]["launches"]
            for arch, r in ys.items()},
        "serve_shapes": {name: {k: c[k] for k in (
            "shape", "sk", "causal", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for name, c in ar["serve"].items()},
        # the hybrid path's (phase p: one generate of jamba's period) and
        # Whisper's (phase w: one prefill and decode loop; phase x: the
        # forward and the recompute of every step)
        "jamba_launches": pr["launches"],
        "whisper_launches": wr_["launches"],
        "whisper_train_launches": sum(
            r["fwd"] for r in train[WHISPER_ARCH]["rows"]),
        # at Whisper's shapes, non-causal (phase f)
        "whisper_shapes": {name: {k: w_[k] for k in (
            "shape", "sk", "causal", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for name, w_ in ar["whisper"].items()},
    }, {
        "name": "wkv6_bwd", "route": "cuda",
        "cost_pass_launches": cost_launches("wkv6_bwd"),
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
        # a backward of the port's own: the TPU kernel it differentiates
        "replaces": "src/repro/kernels/wkv6/kernel.py:65",
        "launches": sum(r["bwd"] for r in train[RWKV_ARCH]["rows"]),
        "shard_train_launches": {str(m): sum(
            r["bwd"] for r in zw["runs"][m, "sharded"]["rows"])
            for m in zw["meshes"]},
        "launches_per_call": 1,
        "max_abs_err": kr_["wkv_err"], "ms": kr_["wkv_ms"],
        "plain_ms": kr_["wkv_plain_ms"], "bound_ms": kr_["wkv_bound_ms"],
        "bound_by": kr_["wkv_bound_by"], "library_ms": None,
        "wrapper_ms": kr_["wkv_wrapper_ms"],
        "cuda_core_bound_ms": kr_["wkv_cuda_core_ms"],
        "shape": list(WKV_FULL_SHAPE),
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "cost_pass_launches": cost_launches("flash_attention_bwd"),
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:65",
        "launches": sum(r["bwd"] for r in train[DENSE_ARCH]["rows"]),
        # the bf16 form's: phase x's bf16 steps (every launch bf16) and
        # phase z's bf16 sharded step
        "bf16_launches": {
            f"{BF16_TRAIN_ARCH} unsharded, {len(xb['rows'])} steps": sum(
                r["bwd"] for r in xb["rows"]),
            f"{zb['cfg'].name} {zb['mesh']}, 1 step":
                zb["runs"]["sharded"]["bwd"]},
        "whisper_train_launches": sum(
            r["bwd"] for r in train[WHISPER_ARCH]["rows"]),
        # the sharded training path's (phase z)
        "shard_train_launches": shard_launches("bwd", zr, zs, zh, zd),
        # at Whisper's encoder shape, non-causal (phase k)
        "whisper_encoder": {"shape": list(WHISPER_FLASH_CASES["encoder"][0]),
                            **{k: fe[k] for k in ("ms", "bound_ms",
                                                  "bound_by")}},
        # at arctic-480b's and jamba-v0.1-52b's (2, 2) model-position
        # shapes, causal (phase k)
        "ep_tp_shapes": {arch: {k: c[k] for k in (
            "shape", "ms", "library_ms", "bound_ms", "bound_by")}
            for arch, c in kr_["ep_tp"].items()},
        "launches_per_call": 2, "parts_ms": kr_["flash_parts_ms"],
        "max_abs_err": kr_["flash_err"], "ms": kr_["flash_ms"],
        "plain_ms": kr_["flash_plain_ms"], "bound_ms": kr_["flash_bound_ms"],
        "bound_by": kr_["flash_bound_by"], "library_ms": kr_["library_ms"],
        "wrapper_ms": kr_["flash_wrapper_ms"],
        "cuda_core_bound_ms": kr_["flash_cuda_core_ms"],
        "shape": list(FLASH_FULL_SHAPE),
        # the bf16 form (phase k): against f64 and SDPA's bf16 backward on
        # its cases, and timed at the full shape and phase k's timed shapes
        "bf16": {"max_abs_err": kb["err"], "worst": kb["worst"],
                 "sdpa_worst": kb["lib_worst"], "ratio": kb["ratio"],
                 "cases": kb["cases"],
                 **{k: kb["timed"]["full"][k] for k in (
                     "ms", "parts_ms", "wrapper_ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")},
                 "timed": {n: {k: r[k] for k in (
                     "shape", "sk", "ms", "library_ms", "bound_ms",
                     "bound_by")} for n, r in kb["timed"].items()}},
    }]}))
    # 7. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
