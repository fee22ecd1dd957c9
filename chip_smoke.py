#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and hold every
kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card

Two main paths, each driven with the launch counts set to 0 just before it
and read just after:

* uIVIM-NET voxel uncertainty at the dense 104-b-value protocol with 8
  masks (4 sub-networks x 8 masks = 32 rows on the kernels' sample axis):
  ``ivim.model.pack_for_serving`` compiles the plan and
  ``serving.engine.predict_volume`` serves a synthetic 128x128x24 slab
  (393,216 voxels x 104 b-values) in 4,096-voxel chunks.
* Bayesian LM serving: ``qwen2-1.5b`` at its published widths and full
  depth (28 layers, bf16, random weights) with 4 Masksembles masks;
  ``serving.engine.serve_uncertain`` serves 8 requests x 128-token prompts
  and generates 32 tokens (a 32-row mask-major pool), fused and per-op,
  then the same in fp32.
* int8 serving: the same IVIM slab at ``Precision("int8")`` (int8 weights,
  bf16 scales, dequantized in the kernels), fused and per-op; and the same
  LM traffic with an int8 KV cache (``kv_dtype="int8"``), which has no
  fused lowering and runs the per-op decode step.
* The paper's design flow: ``ivim.train.train`` trains uIVIM-NET at the
  same width (800 steps, batch 128, lr 3e-3), ``ivim.evaluate`` sweeps the
  five SNR levels (2,000 voxels each) against the Phase-2 requirements, and
  the Phase-3 plans follow: the trained model packed and served per-op and
  fused, and ``core.transform.plan_hardware`` on a dropout MLP with its
  H100-modeled latency.
* Hybrid LM serving: ``recurrentgemma-2b`` at its published widths and full
  depth (26 layers = (rec, rec, local_attn) x 8 + (rec, rec), bf16, random
  weights) with 4 masks; ``serve_uncertain`` serves the same traffic (8
  requests x 128-token prompts, 32 new tokens). It has no fused decode
  lowering: exact prefill (every rec block through ``rglru_scan``, every
  local-attention block through ``flash_attention``), per-op decode.
* The continuous-batching server: ``serving.server.BayesianLMServer`` on
  the same qwen2-1.5b (bf16, 4 masks) with an 8-slot pool (32 rows,
  max_seq 160, ``fused=True``): 24 requests (prompts of 16-128 tokens,
  8-32 new tokens) in three waves of 8 interleaved with ``step()``, and
  the IVIM slab as one ``submit_scan`` after the first wave (a 4-mask
  dense uIVIM-NET: a scan's sample axis is the pool's mask axis).
* Multi-host serving: ``serving.router.ServingRouter`` over three such
  servers (three 8-slot pools beside one copy of the weights) on a
  ``ManualClock`` advanced 1 s a router step: the same traffic unfaulted,
  then under ``FaultPlan.seeded(0)`` plus a kill of the scan's home host
  while the scan is resident; in fp32, a host killed mid-decode against
  one server.
* The paper's schedules (§V-C/D, Fig. 5, Table II) at the dense IVIM
  widths, and the H100 latency model beside what the card measured.
* The remaining backbones at their published widths (bf16, random
  weights, 4 masks; depth cut where the weights or the time need it:
  ``BB_PHASES``): phi3.5-moe (4 of 32 layers) and arctic-480b (1 of 35,
  its dense residual on) at their published capacities, xlstm-350m (all
  24), qwen2-vl-72b (2 of 80) each serving the LM traffic through
  ``serve_uncertain`` (per-op decode, exact prefill), qwen2-vl also over
  embeddings with an 8x8 image grid's M-RoPE positions; hubert-xlarge (all
  48) through ``forward`` over 4 clips x 4 masks of 500 frames, with a
  posterior per frame.
* LM training: ``qwen2-1.5b`` at its published widths and full depth
  (bf16, 4 masks, remat "full") through ``train.make_train_step`` on
  ``data.lm_batch`` batches of 4 x 2,048 tokens (AdamW, grad_accum 2 with
  int8 error feedback, Adafactor), a ``Trainer`` cut and resumed from its
  checkpoints, and ``recurrentgemma-2b`` at 3 layers, whose RG-LRU scan
  trains through the ``rglru_scan`` kernels (forward and backward).
* The mesh layer, in a world of 1 (NCCL refuses two ranks on one card):
  the same qwen2-1.5b training step on DTensors over a (1, 1)
  ``("data", "model")`` ``DeviceMesh`` (``distributed.sharding``), the
  hybrid's with the scan on each rank's local shard, an elastic restart
  through a resharding checkpoint, the int8 all-reduce and a pipeline
  stage on NCCL, and ``serve_uncertain(mesh=)``.

Phases, each on its own line; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the kernels' build (nvcc, from csrc/) with its time;
     then ``[host_path]``: the wrappers' host time a call, part by part,
     before and after the trimmed launch path, on the one-element
     ``moments`` call and the recurrentgemma-2b prefill flash call;
  2. the int8 quantizer on the card bit-equal to the CPU (the dense plan's
     int8 weights and bf16 scales); then kernels vs plain: each kernel, fp32
     and int8 body, against its ref.py version on the card at the main
     shapes and at ragged shapes: max abs error, kernel ms (the IVIM
     kernels' also as profiler device time: events around a small launch
     time the host), plain ms, the
     bound from bytes and FLOPs (the IVIM kernels' at the 3xTF32 rate their
     products run at), and the parameter bytes the kernel reads;
     ``masked_ffn`` in both grid orders (``order``: batch_level, the
     paper's schedule, and sampling_level), asserted bit-equal; the IVIM
     kernels at the main shape held to fp32-accurate products
     (``rel_err``, a bar plain TF32 fails); then the
     moments kernel against its plain version and
     ``torch.std_mean`` (``library_ms``) at the per-op IVIM chunk, the two
     LM posteriors, N = 64, N = 16, 24, 33 and 65 (every register bucket
     and the reread past 64), a ragged shape and in bf16, with profiler
     device times beside the event times; ``predictive_moments`` on fp16
     and empty inputs against the CPU's;
  3. IVIM main path: the volume served through the default entry (the
     fused kernel, ``engine.fallback_counts`` asserted unmoved), per-op,
     and through the plain fused_moments_ref, each held to the unpacked
     model at 2e-4, with the launch counts of each leg asserted (fused: one
     fused_moments launch a chunk; per-op: one masked_ffn and one
     moments launch a chunk) and voxels/s printed; then at int8: fused (one
     int8 moments launch a chunk) and per-op (one int8 masked_ffn and one
     moments launch a chunk) within 2e-4 of each other and 2e-2 of the
     fp32 model, the int8 parameter bytes at most 0.35x the fp32 ones;
     then the design flow: one train step on the card against the CPU's
     plain tier from identical parameters, 800 steps with a falling loss
     (no kernel launched), the SNR sweep with one moments launch a level
     and SNR 5 worse than SNR 50 in RMSE and uncertainty, the trained plan
     per-op and fused within 2e-4 of the unpacked model, and
     ``plan_hardware``'s plan executed on the card beside its modeled
     latency;
  4. LM kernel vs plain at full width (masked and packed FFN, bf16, and
     the fp32 copy) and at a ragged smoke shape, mean_logp also held to
     TOL_DECODE_REL of its magnitude (fp32-accurate products), with the
     per-op step's time, the kernel's per-stage times and each stage's
     byte bound beside it, its FLOPs priced at the rate its products run
     (three bf16 products; 3xTF32 for fp32 weights);
  5. LM main path: ``serve_uncertain`` fused and per-op in bf16 and fp32,
     launch counts asserted (one fused_decode launch per emitted token on
     the fused legs, none on the per-op legs), fp32 legs held together;
     then bf16 with the int8 KV cache: ``quantize_kv`` bit-equal to the
     CPU, every cached vector within half an int8 step of its value, no
     fused_decode launch, tokens compared with the bf16-KV per-op leg
     (reported, not gated). Each qwen2-1.5b prefill runs
     ``flash_attention`` once a layer (28 launches, asserted); each leg's
     moments launches (one a posterior) are printed;
  6. the hybrid kernels vs plain on the card: ``rglru_scan`` at the served,
     the hybrid training, a long and a ragged shape (each with its share of
     the byte bound; two launches at the long shape bit-equal), its
     backward at the training shape on two gate draws
     (``[scan_bwd_gates]``, again after the training legs),
     ``flash_attention`` at the recurrentgemma-2b
     and qwen2-1.5b prefill shapes (bf16 on the tensor cores; fp32 on the
     CUDA cores; full attention; a ragged shape), with
     ``scaled_dot_product_attention`` timed beside it, in events and in
     profiler device time;
  7. the hybrid main path: ``serve_uncertain`` on recurrentgemma-2b with the
     launches of the call asserted (18 rglru_scan, 8 flash_attention, no
     fused_decode), ms a decode step, prefill ms, state and cache bytes;
     then, in fp32 at full width and 5 layers, the log-probs of
     ``prefill(prompt[:s+1])`` (both kernels) against ``prefill(prompt[:s])``
     and one ``decode_step`` of token s (neither kernel);
  8. the server: every prefill bucket the traffic uses, the decode step
     and the scan executor warmed, then the timed run with its launches
     asserted (one fused_decode a step with an LM slot, one fused_moments
     a scan chunk, one moments and 28 flash_attention an admission), zero
     step builds and zero fused fallbacks, the pooled scan bitwise the
     direct ``predict_volume``; its serving numbers (ms a step, decode
     tokens/s, TTFT p50/p99, queue wait, scan voxels/s in the pool beside
     direct, peak queue depth, occupancy, pool MB); the same traffic again
     with each part of a step timed here (``[server_breakdown]``: where an
     admission's time goes); fused_decode against its plain version at the
     server's shapes (1, 3 and 8 of 8 slots active, the rest at pos -1);
     4 fp32 requests whose tokens must equal the one-shot
     ``serve_uncertain``'s (rel-unc within 1e-3); one traced run that must
     pass ``benchmarks/verify_obs.verify_trace_events``; and a
     recurrentgemma-2b pool (bf16, 26 layers, per-op, 2 slots, 4 requests
     of 8 new tokens, the later ones arriving mid-decode) with its
     ``rglru_scan``/``flash_attention`` launches and every released slot's
     rows (h, conv zero; kpos -1) asserted;
  9. the router (``[router]``): the unfaulted and the faulted run, each
     with every request complete, none lost or shed, zero step builds, the
     routed scan ``torch.equal`` to the direct ``predict_volume`` and its
     first chunk carried over by identity (resumed, not recomputed), one
     moments launch and 28 flash_attention an admission, one fused_moments
     a chunk; the faulted run with one death a killed host, a retry, a
     remesh and the scan failed over; router steps, ms a router step,
     decode tokens/s, TTFT in router steps, recovery steps, the share of
     bf16 tokens equal to the unfaulted run and launches by kernel; the
     faulted run's trace through ``verify_obs`` (``[router_trace]``); and
     ``[router_agreement]``: fp32, 4 requests, host 1 killed mid-decode,
     tokens equal to one ``BayesianLMServer``'s, rel-unc within rtol 1e-4
     / atol 1e-5;
 10. the schedules (``[schedule]``): one masked FFN (104 -> 104 -> 104, 8
     masks) over 4,096 voxels mask by mask (mask-as-multiply, the
     baseline), packed, ``scheduler.run`` batch- and sampling-level, and
     ``masked_ffn`` in both grid orders, each within TOL_3XTF32_REL of the
     baseline (the kernel's orders bit-equal); weight loads, traffic and
     ms of each, and the ``grid_sweep`` rows beside the kernel's tile;
 11. pricing (``[pricing]``): ``decode_modeled_latency`` for the server's
     pool beside the measured kernel and step, the IVIM plan's fused
     ``modeled_latency`` beside its chunk, and the ``model_fidelity``
     blocks (unit token: the server run; unit voxel: the fused slab);
 12. the remaining backbones: ``flash_attention`` against its plain
     version and SDPA at hubert's non-causal [16, 16, 500, 80] and at the
     causal prefills of phi3.5 [32, 32, 128, 128], arctic [32, 56, 128,
     128] and qwen2-vl [32, 64, 128, 128] (8 KV heads each), ``moments``
     at every new posterior (vocabularies 32,064, 32,000, 50,304, 152,064;
     [4, 2000, 504] and [4, 4000, 504] frames) (``[bb_kernel]``); then
     ``[backbone_moe]``, ``[backbone_arctic]``, ``[backbone_xlstm]``,
     ``[backbone_vlm]`` (and its embeddings prefill, with one decode step
     from the cache it leaves) and ``[backbone_encoder]``,
     each with prefill (forward) ms, ms a decode step, decode tokens/s and
     peak memory, its launches asserted (flash once an attention layer a
     prefill or forward, ``moments`` once a posterior, no
     ``fused_decode``), no step build or fused fallback in the timed run,
     finite outputs; and ``[backbone_agreement]``: fp32 at full width and
     cut depth, prefill(s+1) against prefill(s) + one decode step within
     TOL_HY_PATH (phi3.5 at the dropless capacity, xlstm, qwen2-vl);
 13-17. training (``train_phases``): ``[train]`` the three qwen2-1.5b
     legs with ms a step, tokens/s, peak memory, first and last loss and
     the model-FLOPs share, no kernel launched and the AdamW loss falling
     (``[train_profile]``: one step's forward + backward and optimizer
     ms, and its profile); ``[train_resume]`` 2 layers cut at step 6 and
     resumed to 9 against an uninterrupted run; ``[train_agreement]`` one
     fp32 step on the card against the CPU; ``[train_hybrid]``
     recurrentgemma-2b with 6 ``rglru_scan`` launches a step asserted (2
     forward, 2 remat recompute, 2 backward); ``[train_kernel]`` the
     scan's backward kernel against autograd through the plain version,
     with its share of the byte bound (two launches at the long shape
     bit-equal);
 18-22. the mesh layer (``mesh_phases``), each phase in a one-rank NCCL
     group of its own: ``[train_sharded]`` qwen2-1.5b at [train]'s size,
     state laid out by ``param_shardings`` and batches by
     ``batch_shardings``, TRAIN_WARM + 3 steps against the unsharded step
     from the same state (every loss within 1e-5; ms a step of both, peak
     memory, the largest parameter gap; no kernel launched), then one more
     step of each under the profiler (``[train_sharded_profile]``: wall
     and device ms, the device's busy share, kernels a step);
     ``[train_sharded_hybrid]`` recurrentgemma-2b at 3 layers with 6
     ``rglru_scan`` launches a step asserted (2 backward); ``[elastic]``
     save from the mesh, ``plan_remesh``, ``mesh_from_plan``, restore with
     ``shardings=``, one step against the same step without the round
     trip; ``[collectives]`` ``compressed_allreduce`` bit-equal to the
     plain quantize-dequantize, a 1-stage ``pipeline_forward`` against
     ``stage_fn``; ``[serve_mesh]`` ``serve_uncertain(mesh=)`` bit-equal to
     ``mesh=None`` with the same launches;
 23. one JSON line with every kernel's numbers (the server's and the
     router's launches as ``server_launches``, ``router_launches`` and
     ``router_faulted_launches``, the backbone phases' as
     ``backbone_launches`` by architecture, the training runs' as
     ``train_launches``, the mesh phases' as ``mesh_launches``; the scan's
     backward as ``backward_*``), then the device line.

Weights are random from ``torch.Generator`` seeds (IVIM: seed 0 with
non-trivial BN running statistics from seed 1; LM: seed 0); the data is
made on the card. TF32 is off throughout: the reference's fp32 products
are true fp32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16 on
#: the tensor cores, HBM3 rate; fp32 products in 3xTF32 (three dense tf32
#: products at 495 TFLOP/s each), as the IVIM kernels run them.
FP32_PEAK = 67e12
BF16_PEAK = 989e12
TF32_3X_PEAK = 495e12 / 3
HBM_BW = 3.35e12
CHUNK = 4096
VOLUME = (128, 128, 24)
TOL_MOMENTS = 2e-4      # the reference's fused-vs-per-op tolerance
TOL_SAMPLES = 1e-4      # fp32 sums in another order than the batched GEMM
# The IVIM kernels' products run 3xTF32 on the tensor cores, allowed only
# at fp32 accuracy: at the dense IVIM chunk their max error over the plain
# output's largest magnitude must stay below this. 3xTF32 reads <= 2.2e-6
# there and plain TF32 (one product of rounded operands) 3.4e-4 to 9.2e-4,
# fp32 and int8 (tools/probe_ivim_kernels.py on an H100); plain TF32 would
# pass the moments bar of 2e-4 above, not this one.
TOL_3XTF32_REL = 2e-5
# int8 bodies vs plain, and int8 fused vs per-op: the reference's int8 bar
# (tests/test_quantized.py); the dequantized weights are exact in fp32, so
# only the order of the sums differs
TOL_INT8 = 2e-4
# int8 vs the fp32 model: the reference's FP32_TOL["ivim"]
TOL_INT8_VS_FP32 = 2e-2
# int8 parameter bytes over fp32 ones: the reference's weight-bytes gate
INT8_BYTES_GATE = 0.35
LM_ARCH, LM_MASKS, LM_BATCH, LM_PROMPT, LM_NEW = "qwen2-1.5b", 4, 8, 128, 32
# fused_decode vs its plain version: fp32 sums in another order (split
# reductions meet in atomics) over 28 layers of 1,536- to 8,960-long
# products; measured at most 3.8e-6 on mean_logp, 2.6e-7 on rel_unc.
TOL_DECODE = 1e-4
# fused_decode's products run on the tensor cores as three bf16 products of
# an exact split of each fp32 activation (3xTF32 for fp32 weights), allowed
# only at fp32 accuracy: the max error of mean_logp over the plain
# version's largest |mean_logp| must stay below this. At the main shape
# plain bf16 activations (one part) read 4.2e-4 to 4.7e-4 and three parts
# 1.4e-6 to 2.1e-6 (tools/probe_fused_decode.py and chip_smoke.py on an
# H100, PERF.md); two parts read as three there (the fp32 sums' own noise
# over 28 layers hides them), so this bar stops the one-part product and
# TOL_DECODE_SPLIT the two-part one.
TOL_DECODE_REL = 1e-5
# The same error at the "split" case: bf16 at the smoke widths (64- and
# 128-long products, 2 layers) with the tied embeddings times
# SPLIT_EMBED_SCALE, so the logits' error, not mean_logp's own fp32
# rounding, leads it. Set between what three and two parts read there
# (tools/probe_fused_decode.py on an H100, weight seeds 0-7: three parts
# 1.6e-7 to 2.5e-7, two 1.3e-6 to 2.3e-6, one 9.7e-4 to 1.7e-3; PERF.md).
TOL_DECODE_SPLIT = 6e-7
SPLIT_EMBED_SCALE = 16.0
# k/v outputs are rounded to bf16 from fp32 values that differ by that
# noise: within one bf16 ulp of the plain value, plus the fp32 noise at the
# tensor's scale (the fp32 k/v differ by at most 1.4e-6 x max |k|), which
# decides the rounding of elements near zero.
TOL_KV_SCALE = 1e-5
# fp32 serve_uncertain, fused vs per-op, after 32 greedy steps: the
# reference's posterior bar (rtol 1e-4 at smoke size) widened for depth.
TOL_LM_UNC = 1e-3
LM_FLASH_LAUNCHES = 28          # one a layer of qwen2-1.5b's prefill
HOST_CALLS = 1000               # calls a host-path part is timed over
HY_ARCH, HY_PATH_LAYERS = "recurrentgemma-2b", 5
# the server phase: qwen2-1.5b's 8-slot pool (32 rows, max_seq 160, the
# pool serve_uncertain serves), 24 requests in 3 waves of 8 with 12 steps
# between waves, prompts of 16-128 tokens and 8-32 new tokens drawn from
# numpy seed 0, plus one scan of the IVIM slab; fused_decode held to its
# plain version at 1, 3 and 8 active slots; 4 fp32 requests against the
# one-shot serve_uncertain; a traced run of 4 requests and a 3-chunk scan;
# the hybrid pool: 2 slots, 4 requests of 8 new tokens
SRV_SLOTS, SRV_REQUESTS, SRV_WAVE, SRV_WAVE_STEPS = 8, 24, 8, 12
SRV_MIN_PROMPT, SRV_MIN_NEW = 16, 8
SRV_ACTIVE = (1, 3, 8)
SRV_FP32_REQUESTS, SRV_FP32_PROMPT = 4, 64
SRV_TRACE_REQUESTS, SRV_TRACE_CHUNKS = 4, 3
SRV_HY_SLOTS, SRV_HY_REQUESTS, SRV_HY_NEW = 2, 4, 8
# the router phase: the server phase's ServerConfig on each of three hosts
# behind a ServingRouter (bench_serving's chaos settings), a ManualClock
# advanced 1 s a router step; the server phase's traffic unfaulted, then
# under FaultPlan.seeded(ROUTER_SEED) over the unfaulted run's steps plus a
# kill of the scan's home host at ROUTER_SCAN_KILL_STEP (the scan resident);
# in fp32, 4 requests with host 1 killed mid-decode against one server
ROUTER_HOSTS, ROUTER_TIMEOUT_S, ROUTER_RETRIES = 3, 2.5, 4
ROUTER_SEED, ROUTER_SCAN_KILL_STEP = 0, 20
ROUTER_FP32_REQUESTS, ROUTER_FP32_KILL_HOST, ROUTER_FP32_KILL_STEP = 4, 1, 3
TOL_ROUTER_UNC = dict(rtol=1e-4, atol=1e-5)   # the posterior bar
# the schedule phase: one masked FFN at the dense IVIM widths (104 -> 104
# masked hidden units -> 104, 8 masks at scale 2) over one 4,096-voxel
# chunk; the sampling-level loop's voxel chunk is the FPGA's 64; masked_ffn
# runs a fixed voxel tile of 64 (kT in csrc/masked_ffn.cu)
SCHED_WIDTH, SCHED_MASKS, SCHED_CHUNK, MFFN_TILE = 104, 8, 64, 64
# moments vs its plain version: the reference's own kernel-vs-ref bar
# (tests/test_kernels.py); bf16 within one bf16 ulp of the plain value
TOL_MO_MEAN = dict(rtol=1e-5, atol=1e-6)
TOL_MO_STD = dict(rtol=1e-4, atol=1e-5)
# the design flow: uIVIM-NET at the serving width, examples/train_ivim.py's
# settings
FLOW_STEPS, FLOW_BATCH, FLOW_LR = 800, 128, 3e-3
FLOW_SNR_VOXELS = 2000
# one Adam step from identical parameters, card vs CPU: fp32 products in
# another order. The directions batch-statistics BN hides from the loss
# (the biases ahead of BN; fc1's row for the b=0 input, 1.0 in every voxel)
# get float-noise gradients that Adam turns into steps of about lr: those
# are held to 2 lr and reported apart.
TOL_TRAIN_STEP = 1e-5
TRAIN_NULL = {"fc1.b": (...,), "fc2.b": (...,), "fc1.w": (slice(None), 0)}
MLP_WIDTHS, MLP_DROPOUT, MLP_BATCH = (11, 32, 32, 1), (1, 2), 512
# rglru_scan vs its plain version: fp32, a sequential fmaf carry against the
# reference's odd/even tree of products and sums; with |a| < 1 the rounding
# does not grow with S
TOL_SCAN = 1e-5
# flash_attention vs its plain version in fp32: sums over dh and the keys
# in another order, the online softmax's rescaling
TOL_FLASH_F32 = 1e-5
# ... in bf16: one bf16 ulp of the plain value (both round the fp32 result
# once) plus 2^-8 max|v|: each p is rounded to bf16 (2^-9 relative) before
# the normalisation in the kernel and after it in the plain version, so the
# two fp32 sums differ by at most 2^-8 sum_j p_j |v_j| <= 2^-8 max|v|
FLASH_BF16_V_SHARE = 2.0 ** -8
# fp32 hybrid at full width, 5 layers: prefill(prompt[:s+1]) against
# prefill(prompt[:s]) + decode_step(token s), last-position log-probs. Sums
# of 2,560- to 7,680-long products in another order (cuBLAS picks kernels
# by shape), a sequential scan against one recurrence step, online against
# full softmax: expected ~1e-5; a state off by one step moves them by O(0.1)
TOL_HY_PATH = 1e-3


# the backbone phases: each remaining family at its published widths, bf16,
# random weights, 4 masks, depth cut to fit the card and the time (tag, arch,
# layers kept): the LM traffic above through serve_uncertain; qwen2-vl also
# over embeddings with an 8x8 image grid's M-RoPE positions; hubert-xlarge's
# forward at full depth over 4 clips x 4 masks of 500 frames
BB_PHASES = (("backbone_moe", "phi3.5-moe-42b-a6.6b", 4),
             ("backbone_arctic", "arctic-480b", 1),
             ("backbone_xlstm", "xlstm-350m", 24),
             ("backbone_vlm", "qwen2-vl-72b", 2))
BB_VL_GRID = 8
ENC_ARCH, ENC_CLIPS, ENC_FRAMES = "hubert-xlarge", 4, 500
# fp32 prefill-vs-step agreement at full width and cut depth (arch, layers:
# xlstm's 4 hold 3 mLSTM and 1 sLSTM), held to TOL_HY_PATH; phi3.5 at the
# dropless capacity E/top_k (its smoke config's), so the prompt's routing
# groups cannot drop a token that the step keeps
BB_AGREE = (("phi3.5-moe-42b-a6.6b", 2), ("xlstm-350m", 4),
            ("qwen2-vl-72b", 2))


# LM training (phases 13-17): qwen2-1.5b at published widths and full
# depth, bf16, 4 masks, remat "full", B 4 x S 2048 (two query chunks of the
# chunked attention); AdamW 20 steps at lr 3e-4 (warmup 5, decay 20), a
# grad_accum 2 + int8 error-feedback leg and an Adafactor leg of 5 steps.
# The AdamW leg's loss must fall. A second AdamW leg runs at lr 1e-3 and
# is reported, not checked: there the loss rises again once the warmup
# ends. At 1e-3 the reference does not fall either over 20 steps of a cut
# qwen2, and the port matches it step by step
# (tests/test_torch_train.py::test_twenty_steps_at_lr_1e3_match_jax).
# The step's ms is the median after step 2.
TRAIN_ARCH, TRAIN_B, TRAIN_S = "qwen2-1.5b", 4, 2048
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, decay_steps=20)
TRAIN_LEGS = (("adamw", "adamw", 20, 1, False, 3e-4),  # leg, optimizer,
              ("adamw_lr1e-3", "adamw", 20, 1, False, 1e-3),   # steps,
              ("accum_ef", "adamw", 5, 2, True, 3e-4),  # grad_accum,
              ("adafactor", "adafactor", 5, 1, False, 3e-4))  # compress, lr
TRAIN_WARM = 2
# resume: 2 of qwen2-1.5b's 28 layers at published widths — a checkpoint of
# the whole train state is 10 bytes a parameter (bf16 weights, fp32 AdamW
# moments), 15.4 GB at 28 layers against 3.3 GB at 2, and the run writes
# five of them. Losses of the resumed run against an uninterrupted one:
# cuBLAS products are repeatable, but the embedding's backward accumulates
# with atomics, so bf16 weights may round apart by a step after a few
# updates; 1e-3 relative, and whether they are bitwise is printed
TRAIN_RESUME_LAYERS, TRAIN_RESUME_STEPS, TRAIN_RESUME_EVERY = 2, (6, 9), 3
TOL_RESUME = 1e-3
# one fp32 train step on the card against the CPU, 2 layers at published
# widths, B 4 x S 64, TF32 off: loss 1e-5 and gnorm 1e-4 relative (sums in
# another order); the gradients (read as AdamW's first moment, 0.1 x the
# clipped gradient) within 1e-4 of each leaf's largest; the updated
# parameters within what that implies: AdamW's first step moves a
# parameter by lr g/(|g| + eps), and gradients d apart move it at most
# 2 d/(max |g| + eps) lr apart (2 lr where |g| is near d: the key bias's
# gradient is zero in exact arithmetic, as a query's softmax does not see
# a common shift, so its step is rounding noise), plus two fp32 ulps of
# the value (the card may fuse the update's product and sum); the share of
# that bound used is printed
TRAIN_AGREE_LAYERS, TRAIN_AGREE_B, TRAIN_AGREE_S = 2, 4, 64
TOL_TRAIN_AGREE = {"loss": 1e-5, "gnorm": 1e-4, "grad": 1e-4}
# the hybrid: recurrentgemma-2b, 3 layers (rec, rec, local_attn: one repeat
# of its pattern), bf16, B 8 x S 1024, 10 AdamW steps; rglru_scan launches a
# step: 2 recurrent layers x (forward + remat recompute) + 2 backward
TRAIN_HY_LAYERS, TRAIN_HY_B, TRAIN_HY_S, TRAIN_HY_STEPS = 3, 8, 1024, 10
TRAIN_HY_SCAN_LAUNCHES, TRAIN_HY_SCAN_BACKWARD = 6, 2
# the scan's backward kernel against autograd through the plain version:
# max abs error over the plain gradient's magnitude (a sequential fmaf
# carry against the odd/even tree; 5e-7 in a CPU emulation of the kernel)
TRAIN_KERNEL_SHAPES = (("train", (8, 1024, 2560)), ("served", (32, 128, 2560)),
                       ("long", (4, 4096, 2560)))
TOL_SCAN_BWD_REL = 1e-5
# the mesh layer (phases 18-22). NCCL refuses two ranks on one device, so
# the card runs a world of 1: a (1, 1) ("data", "model") mesh over an NCCL
# group (file:// rendezvous, 60 s timeout), each phase in a group of its
# own; the math across ranks is held on the CPU (tests/test_torch_
# distributed*.py, test_torch_elastic.py on gloo ranks). The sharded step
# runs TRAIN_WARM + 3 steps of [train]'s AdamW leg against the unsharded
# step from the same state and batches: every step's loss within 1e-5
# relative (TF32 off, the same products on the same local tensors).
MESH_SHAPE, MESH_DIMS = (1, 1), ("data", "model")
MESH_STEPS = TRAIN_WARM + 3
TOL_MESH_LOSS = 1e-5
# [elastic]: qwen2-1.5b cut to 4 layers at full width, B 4 x S 2048: save
# from the mesh, plan_remesh, mesh_from_plan, restore with shardings=, one
# step, against the same step without the round trip: the loss bit-equal
# (the forward's products are repeatable), gnorm 1e-5, each parameter
# within one bf16 step of its value (the embedding's backward accumulates
# with atomics, so a bf16 weight may round the other way)
MESH_ELASTIC_LAYERS = 4
# [collectives]: compressed_allreduce on a [4096, 1536] fp32 leaf;
# a 1-stage pipeline_forward of tanh(h @ w) over 4 microbatches of 2 rows
# at width 1536 against stage_fn on the whole batch (cuBLAS may pick
# another kernel for 2 rows than for 8: 1e-5)
MESH_ALLREDUCE_SHAPE, MESH_PIPE_WIDTH, MESH_PIPE_B = (4096, 1536), 1536, 8
TOL_MESH_PIPE = 1e-5
# [serve_mesh]: serve_uncertain on qwen2-1.5b at 2 layers (published
# widths, bf16), the LM traffic, per-op decode (the fused step sums across
# blocks with float atomics: two runs need not agree bit for bit)
MESH_SERVE_LAYERS = 2


def _phase(phase: str, /, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def device_ms(fn, reps: int = 10):
    """The card's own time a call (its kernels' profiler events), apart from
    the host's: a back-to-back event timing of a small call measures
    whichever of the two is longer. "not measured" where the trace holds
    fewer device events than calls (the profiler dropped some)."""
    import torch
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as tr:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in tr.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(spans) < reps or not sum(spans):
        return "not measured"
    return sum(spans) / reps / 1e3


def call_profile(fn, reps: int = 3) -> dict:
    """The wall ms of a call of ``fn`` (ending in a synchronize) under the
    profiler, the card's busy ms in it (its kernels' device events) and
    that share of the wall time, the kernels a call and the ten longest by
    name (µs a call, count a call); "not measured" where the trace holds
    no device event."""
    import torch
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as trace:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / reps
    per_kernel: dict[str, list] = {}
    for e in trace.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_kernel.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / reps
            acc[1] += 1
    dev_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": f"{wall_ms:.3f}",
            "device_ms": f"{dev_ms:.3f}" if dev_ms else "not measured",
            "device_busy_share": f"{dev_ms / wall_ms:.3f}" if dev_ms
            else "not measured",
            "kernels": sum(n for _, n in per_kernel.values()) // reps,
            "top_kernels_us": [(name[:50], round(us, 1), n // reps)
                               for name, (us, n) in top]}


def _within_bf16_ulp(got, want) -> float:
    """Max abs error of bf16 ``got`` against ``want``; raises beyond one
    bf16 ulp of ``want`` plus TOL_KV_SCALE x max |want|."""
    got, want = got.float(), want.float()
    ulp = (want.abs().clamp_min(1e-30).log2().floor() - 7).exp2()
    err = (got - want).abs()
    if not bool((err <= ulp + TOL_KV_SCALE * want.abs().max()).all()):
        raise AssertionError(f"k/v beyond one bf16 ulp: {float(err.max())}")
    return float(err.max())


def stage_bytes(spec, flat, rows, kv_bytes, x, got) -> dict:
    """Bytes each stage of ``fused_decode`` (named as in ``stage_ms``) must
    move at least: its weights (and a norm's scale, bias or mask that it
    reads), the valid k/v cache rows for attention, the logits the
    epilogue reads and what it writes; all layers summed."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_plan import ref as fp_ref
    to_stage = {"wq": "qkv", "bq": "qkv", "wk": "qkv", "bk": "qkv",
                "wv": "qkv", "bv": "qkv", "wo": "wo", "wg": "gate_up",
                "wu": "gate_up", "bu": "gate_up", "wgp": "gate_up",
                "wup": "gate_up", "wd": "down", "bd": "down", "wdp": "down",
                "mask": "down", "w": "lm_head"}
    names = fd_ops.stage_names(spec)
    out = dict.fromkeys(names, 0)
    # the chain's norms in order: norm1, norm2 a layer, then the final one
    norm_at = [i for i, st in enumerate(spec.steps) if st.kind == "norm"]
    norm_stage = {i: ("final_norm" if k == len(norm_at) - 1 else
                      ("norm1", "norm2")[k % 2]) for k, i in enumerate(norm_at)}
    for (i, name), t in zip(fp_ref.decode_param_slots(spec), flat):
        n = t.numel() * t.element_size()
        out[norm_stage[i] if i in norm_stage else to_stage[name]] += n
    logits = rows * spec.vocab * 4
    out["attention"] += kv_bytes
    out["log_sum_exp"] += logits
    out["welford"] += logits + sum(g.numel() * g.element_size()
                                   for g in got[:2])
    out["argmax"] += got[0].numel() * got[0].element_size()
    out["norm1"] += 2 * x.numel() * x.element_size()   # x in, the residual out
    return out


def lm_phases(dev, time_ms, bound, nbytes, counters) -> dict:
    """Phases 4 and 5: the LM decode kernel against its plain version at
    full width, then ``serve_uncertain`` fused and per-op (``counters``:
    masked_ffn, samples, fused moments, the moments kernel, fused_decode,
    flash_attention, rglru_scan; the moments kernel's launches — one a
    posterior — are printed, not asserted). Returns the fused_decode record
    of the kernels line."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.models import layers, model as lm_model, transformer
    from repro_torch.serving import engine, server

    cfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS)
    model = lm_model.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    _phase("lm_model", arch=LM_ARCH, params=cfg.param_count(),
           layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
           vocab=cfg.vocab_size, masks=LM_MASKS, dtype=cfg.dtype,
           init_s=f"{time.perf_counter() - t0:.1f}")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    max_seq = LM_PROMPT + LM_NEW

    def pool(c, p, n, toks, cap=max_seq):
        """Prefill a mask-major pool; returns (caches, next tokens)."""
        mean, _, caches = server.step_fns(c, fused=False, device=dev) \
            .prefill(p, toks.repeat(n, 1), max_seq=cap)
        return caches, mean.argmax(-1).to(torch.int32).repeat(n)[:, None]

    def operands(c, p, caches, tok, plen):
        rows = tok.shape[0]
        spec = plan_lib.lower_fused_decode(c)
        flat = plan_lib._decode_flat_params(spec, c, p, rows, True)
        fc = plan_lib._decode_flat_caches(c, caches)
        pos = torch.full((rows,), plen, dtype=torch.int32, device=dev)
        rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
        x = layers.embed_tokens(p["embed"], tok[:, 0])
        cos, sin = layers.rope_cos_sin(pos, rot, c.rope_theta)
        return spec, (x, flat, fc, pos, cos, sin)

    recs = {}

    def kernel_case(name, c, p, caches, tok, plen, step_legs=False,
                    rel_bar=TOL_DECODE_REL):
        spec, args = operands(c, p, caches, tok, plen)
        got = fd_ops.fused_decode(spec, *args)
        want = fd_ops.fused_decode_ref(spec, *args)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=TOL_DECODE,
                                       atol=TOL_DECODE)
        err = max(float((g - w).abs().max())
                  for g, w in zip(got[:2], want[:2]))
        kv_err = max(_within_bf16_ulp(g, w) if g.dtype == torch.bfloat16
                     else float((g - w).abs().max())
                     for g, w in zip(got[2:], want[2:]))
        # k/v error at the tensor's scale, and the kernel against itself
        # (its split sums meet in atomics, in another order each launch)
        kv_scale_err = max(float((g.float() - w.float()).abs().max()
                                 / w.float().abs().max())
                           for g, w in zip(got[2:], want[2:]))
        again = fd_ops.fused_decode(spec, *args)
        kv_self = sum(int(((g.float() - a.float()).abs() > (
            g.float().abs().clamp_min(1e-30).log2().floor() - 7).exp2())
            .sum()) for g, a in zip(got[2:], again[2:])) \
            if got[2].dtype == torch.bfloat16 else 0
        x, flat, fc, pos, cos, sin = args
        rows, smax = x.shape[0], fc[0].shape[2]
        # what this step's data needs: attention reads and scores only the
        # cache slots that are valid for the row (kpos in [0, pos], not the
        # slot being overwritten), plus the fresh key
        attn = [s for s in spec.steps if s.kind == "attn"]
        p64 = pos.long()
        seen = 0
        for st, k, kpos in zip(attn, fc[0::3], fc[2::3]):
            slot = ((p64 % st.window) if st.window else p64) % smax
            seen += int(((kpos >= 0) & (kpos <= p64[:, None])
                         & (torch.arange(smax, device=dev)[None, :]
                            != slot[:, None])).sum())
        at = attn[0]
        per_key = 4 * at.n_heads * at.head_dim // at.n_kv_heads
        flops = plan_lib.decode_traffic(spec, rows, smax).flops \
            - len(attn) * rows * at.n_kv_heads * per_key * (smax + 1) \
            + at.n_kv_heads * per_key * (seen + len(attn) * rows)
        kv_bytes = 2 * seen * at.n_kv_heads * at.head_dim \
            * fc[0].element_size() + nbytes(*fc[2::3])
        moved = nbytes(x, pos, cos, sin, *got, *flat) + kv_bytes
        # fp32 accuracy: mean_logp's error over its largest magnitude
        rel = float((got[0] - want[0]).abs().max() / want[0].abs().max())
        if not rel <= rel_bar:
            raise AssertionError(f"fused_decode {name}: error {rel:.3g} of "
                                 f"|mean_logp| (> {rel_bar}): the "
                                 f"products are not fp32-accurate")
        rec = {"shape": name, "max_abs_err": err, "rel_err": rel,
               "kv_max_abs_err": kv_err,
               "kv_err_over_max": kv_scale_err,
               "kv_beyond_1ulp_of_itself": kv_self,
               "ms": time_ms(lambda: fd_ops.fused_decode(spec, *args), 10),
               "plain_ms": time_ms(lambda: fd_ops.fused_decode_ref(
                   spec, *args), 3),
               "blocks": fd_ops.last_grid["blocks"], "rows": rows,
               "gflop": flops / 1e9, "mbytes": moved / 1e6}
        # the last timed launch, per stage (block 0's barrier timestamps),
        # beside the bytes each stage must move at the HBM rate
        rec["stage_ms"] = {k: round(v, 4) for k, v in
                           fd_ops.stage_ms(spec, rows, dev).items()}
        rec["stage_bound_ms"] = {
            k: round(1e3 * v / HBM_BW, 4) for k, v in
            stage_bytes(spec, flat, rows, kv_bytes, x, got).items()}
        # the products run as three bf16 tensor-core products (3xTF32 for
        # fp32 weights); the CUDA cores' fp32 rate beside it
        peak = BF16_PEAK / 3 if x.dtype == torch.bfloat16 else TF32_3X_PEAK
        rec["bound_ms"], rec["bound_by"] = bound(flops, moved, peak)
        rec["bound_ms_cuda_cores"] = bound(flops, moved)[0]
        if step_legs:                   # whole serving steps, same operands
            # and the fused step's parts outside the kernel
            rot = next(st.rot_dim for st in spec.steps if st.kind == "attn")
            rec["embed_rope_ms"] = time_ms(lambda: (
                layers.embed_tokens(p["embed"], tok[:, 0]),
                layers.rope_cos_sin(pos, rot, c.rope_theta)), 10)
            rec["cache_commit_ms"] = time_ms(
                lambda: plan_lib._decode_commit_caches(c, caches, got[2],
                                                       got[3], pos), 3)
            mk = lm_model.build_model(c)
            for leg, fused in (("fused_step_ms", None),
                               ("per_op_step_ms", False)):
                fns = server.step_fns(mk, fused=fused, device=dev)
                rec[leg] = time_ms(lambda: fns.decode(p, caches, tok, plen),
                                   3)
        _phase("lm_kernel", name="fused_decode", **rec)
        recs[name] = rec

    caches, tok = pool(cfg, params, LM_MASKS, prompts)
    kernel_case("main", cfg, params, caches, tok, LM_PROMPT, step_legs=True)
    pcfg = dataclasses.replace(cfg, packed_ffn_serving=True)
    pparams = transformer.pack_ffn_params(cfg, params)
    kernel_case("packed", pcfg, pparams, caches, tok, LM_PROMPT)
    del pparams
    scfg = registry.smoke_config(LM_ARCH, n_layers=2, d_model=40,
                                 head_dim=10, d_ff=72, vocab_size=100)
    sparams = transformer.init(scfg, torch.Generator(dev).manual_seed(2),
                               device=dev)
    stoks = torch.randint(0, 100, (3, 6), device=dev, dtype=torch.int32,
                          generator=torch.Generator(dev).manual_seed(3))
    scaches, stok = pool(scfg, sparams, 4, stoks, cap=7)
    kernel_case("ragged", scfg, sparams, scaches, stok, 6)
    # the products' accuracy where a dropped split part shows: bf16 at the
    # smoke widths, the (tied) embeddings times SPLIT_EMBED_SCALE so that
    # the logits' error, not mean_logp's own rounding, leads
    qcfg = registry.smoke_config(LM_ARCH, dtype=torch.bfloat16)
    qparams = transformer.init(qcfg, torch.Generator(dev).manual_seed(4),
                               device=dev)
    qparams["embed"]["embed"] *= SPLIT_EMBED_SCALE
    qtoks = torch.randint(0, qcfg.vocab_size, (3, 6), device=dev,
                          dtype=torch.int32,
                          generator=torch.Generator(dev).manual_seed(5))
    qcaches, qtok = pool(qcfg, qparams, qcfg.mask_samples, qtoks, cap=9)
    kernel_case("split", qcfg, qparams, qcaches, qtok, 6,
                rel_bar=TOL_DECODE_SPLIT)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _tree(lambda t: t.float(), params)
    caches32, tok32 = pool(cfg32, params32, LM_MASKS, prompts)
    kernel_case("fp32", cfg32, params32, caches32, tok32, LM_PROMPT)
    del caches32

    # ---- phase 5: the LM main path ----------------------------------------
    def leg(c, p, fused, fused_steps=LM_NEW):
        """One serve_uncertain leg; ``fused_steps`` fused_decode launches
        expected when ``fused`` is None (auto)."""
        mk = lm_model.build_model(c)
        fns = server.step_fns(mk, fused=fused, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fns.prefill(p, prompts.repeat(LM_MASKS, 1), max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        for ctr in counters:
            ctr.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.serve_uncertain(
            mk, p, prompts, engine.ServeConfig(max_new_tokens=LM_NEW,
                                               fused=fused), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = tuple(ctr.launches for ctr in counters)
        counts, mo_launches = counts[:3] + counts[4:], counts[3]
        expect = (0, 0, 0, fused_steps if fused is None else 0,
                  LM_FLASH_LAUNCHES, 0)
        if counts != expect:
            raise AssertionError(f"LM {c.dtype} fused={fused} launches "
                                 f"(masked_ffn, samples, fused moments, "
                                 f"decode, flash, scan) = {counts}, "
                                 f"expected {expect}")
        if fused is None and fused_steps and not fns.fused_live():
            raise AssertionError("fused leg fell back to the per-op path")
        gen, unc, _ = out
        if gen.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
                not bool(torch.isfinite(unc).all()):
            raise AssertionError(f"LM output {tuple(gen.shape)}, finite "
                                 f"{bool(torch.isfinite(unc).all())}")
        step_ms = 1e3 * (secs - prefill_s) / LM_NEW
        _phase("lm_main_path", dtype=c.dtype, kv_dtype=c.kv_dtype or "model",
               leg="fused" if fused is None and fused_steps else "per_op",
               seconds=f"{secs:.4f}", prefill_s=f"{prefill_s:.4f}",
               decode_ms_per_step=f"{step_ms:.3f}",
               tokens_per_s=f"{LM_BATCH * LM_NEW / secs:.1f}",
               decode_tokens_per_s=f"{1e3 * LM_BATCH / step_ms:.1f}",
               launches=counts, moments_launches=mo_launches)
        moments_launches[(c.dtype, c.kv_dtype, fused)] = mo_launches
        return out, counts

    legs, moments_launches = {}, {}
    for fused in (None, False):
        legs[("bf16", fused)] = leg(cfg, params, fused)
    same = float((legs[("bf16", None)][0][0] == legs[("bf16", False)][0][0])
                 .float().mean())
    _phase("lm_agreement", dtype="bf16", tokens_equal_share=same,
           note="bf16 fused vs per-op is reported, not gated")

    # ---- phase 5 with the int8 KV cache -----------------------------------
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    caches_bf, _ = pool(cfg, params, LM_MASKS, prompts)
    caches_q, _ = pool(cfg8, params, LM_MASKS, prompts)
    x = caches_bf[0]["b0"]["k"][0]                    # one layer's k, bf16
    for got, want in zip(layers.quantize_kv(x), layers.quantize_kv(x.cpu())):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("quantize_kv on the card differs from the "
                                 "CPU's")
    worst = 0.0
    for seg_bf, seg_q in zip(caches_bf, caches_q):
        for b, c_bf in seg_bf.items():
            for name in ("k", "v"):
                val = c_bf[name].float()
                sc = seg_q[b][name + "scale"][..., None]
                err = (seg_q[b][name].float() * sc - val).abs()
                # half a step, plus the fp32 rounding of x / s and q * s
                slack = 0.5 * sc + 1e-6 * val.abs()
                if not bool((err <= slack).all()):
                    raise AssertionError(f"int8 {name} cache beyond half a "
                                         f"step: {float(err.max())}")
                worst = max(worst, float((err / sc.clamp_min(1e-30))
                                         .max()))
    _phase("lm_int8_kv", quantize_kv_bit_equal_to_cpu=True,
           max_err_in_steps=f"{worst:.4f}", cache_mbytes=sum(
               nbytes(*c.values()) for seg in caches_q
               for c in seg.values()) / 1e6)
    del caches_bf, caches_q
    try:
        plan_lib.lower_fused_decode(cfg8)
    except plan_lib.FusedPlanUnsupported:
        pass
    else:
        raise AssertionError("int8 KV lowered to the fused decode step")
    legs[("int8kv", None)] = leg(cfg8, params, None, fused_steps=0)
    same8 = float((legs[("int8kv", None)][0][0]
                   == legs[("bf16", False)][0][0]).float().mean())
    _phase("lm_agreement", kv_dtype="int8", tokens_equal_share_vs_bf16_kv=same8,
           note="int8 KV vs bf16 KV (both per-op) is reported, not gated")
    del params
    for fused in (None, False):
        legs[("fp32", fused)] = leg(cfg32, params32, fused)
    (fg, fu, _), _ = legs[("fp32", None)]
    (pg, pu, _), _ = legs[("fp32", False)]
    if not torch.equal(fg, pg):
        raise AssertionError("fp32 fused and per-op legs generated "
                             "different tokens")
    torch.testing.assert_close(fu, pu, rtol=TOL_LM_UNC, atol=1e-5)
    _phase("lm_agreement", dtype="fp32", tokens_equal=True,
           rel_unc_max_abs_err=float((fu - pu).abs().max()),
           rel_unc_mean=float(fu.mean()))
    main = recs["main"]
    return {
        "name": "fused_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_plan/kernel.py:260"
                    " (pallas_call :324)",
        "launches": legs[("bf16", None)][1][3],
        "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
        "ms": main["ms"], "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "bound_ms_cuda_cores": main["bound_ms_cuda_cores"],
        "rel_err": max(r["rel_err"] for r in recs.values()),
        "stage_ms": main["stage_ms"],
        "stage_bound_ms": main["stage_bound_ms"],
        "packed_ms": recs["packed"]["ms"],
        "packed_bound_ms": recs["packed"]["bound_ms"],
        "ragged_ms": recs["ragged"]["ms"], "fp32_ms": recs["fp32"]["ms"],
        "per_op_step_ms": main["per_op_step_ms"],
        "fused_step_ms": main["fused_step_ms"],
        "moments_per_op_launches": moments_launches[(cfg.dtype, "", False)]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def flash_case(gen, dev, time_ms, bound, nbytes, name, dims, dt,
               causal) -> dict:
    """``flash_attention`` against its plain version at q [b, h, s, dh] and
    k/v [b, hkv, s, dh] in ``dt``, with SDPA (``library_ms``) and the
    profiler's device times beside it; raises beyond the bar (fp32:
    TOL_FLASH_F32 relative; bf16: one ulp plus FLASH_BF16_V_SHARE max|v|).
    Returns the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, h, hkv, s, dh = dims
    q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev)
               .to(dt) for n in (h, hkv, hkv))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs()
    extra = {}
    if dt == torch.bfloat16:
        ulp = (want.float().abs().clamp_min(1e-30).log2().floor()
               - 7).exp2()
        limit = ulp + FLASH_BF16_V_SHARE * v.float().abs().max()
        extra["beyond_1ulp"] = int((err > ulp).sum())
        # both against the same attention in fp32 (p never rounded)
        exact = fa_ref.flash_attention_ref(q.float(), k.float(),
                                           v.float(), causal=causal)
        extra["kernel_err_vs_fp32"] = float((got.float() - exact)
                                            .abs().max())
        extra["plain_err_vs_fp32"] = float((want.float() - exact)
                                           .abs().max())
        del exact
    else:
        limit = TOL_FLASH_F32 * (1 + want.abs())
    if got.dtype != dt or not bool((err <= limit).all()):
        raise AssertionError(f"flash_attention {name}: max abs error "
                             f"{float(err.max())} beyond its limit")

    def lib(q=q, k=k, v=v, causal=causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    pairs = s * (s + 1) // 2 if causal else s * s
    rec = {"shape": name, "dims": [b, h, hkv, s, dh], "dtype": dt,
           "causal": causal, "max_abs_err": float(err.max()), **extra,
           "library_max_abs_err": float((lib().float() - want.float())
                                        .abs().max()),
           "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                        causal=causal)),
           "plain_ms": time_ms(lambda: fa_ref.flash_attention_ref(
               q, k, v, causal=causal), 5),
           "library_ms": time_ms(lib),
           "device_ms": device_ms(lambda: fa_ops.flash_attention(
               q, k, v, causal=causal)),
           "library_device_ms": device_ms(lib)}
    rec["bound_ms"], rec["bound_by"] = bound(
        4 * b * h * pairs * dh, nbytes(q, k, v, got),
        BF16_PEAK if dt == torch.bfloat16 else FP32_PEAK)
    return rec


def scan_bwd_gates_phase(dev, time_ms, when: str) -> dict:
    """``[scan_bwd_gates]``: the scan's backward at the hybrid training
    shape, timed on both gate draws of this script (``[hy_kernel]``'s a in
    [0.85, 0.999); ``[train_kernel]``'s a = lam ** (8 u), lam in [0.9,
    0.999) a channel), the same data every call. Run in phase 6 and again
    after the training legs: a gap between the phases' readings of one
    shape is told apart into inputs and the card's state."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as sc_ops

    gen = torch.Generator(dev).manual_seed(6)
    shape = (TRAIN_HY_B, TRAIN_HY_S, 2560)
    rec = {}
    for draw in ("hy", "train"):
        if draw == "hy":
            a = 0.85 + 0.149 * torch.rand(shape, generator=gen, device=dev)
        else:
            lam = 0.9 + 0.099 * torch.rand(shape[-1], generator=gen,
                                           device=dev)
            a = lam ** (8 * torch.rand(shape, generator=gen, device=dev))
        b = torch.randn(shape, generator=gen, device=dev) \
            * torch.sqrt(1 - a * a)
        g = torch.randn(shape, generator=gen, device=dev)
        h = sc_ops.rglru_scan(a, b)
        rec[f"{draw}_gates_ms"] = time_ms(
            lambda: sc_ops.rglru_scan_backward(a, h, g))
        del a, b, g, h
    _phase("scan_bwd_gates", when=when, dims=list(shape), **rec)
    return rec


def hybrid_phases(dev, time_ms, bound, nbytes, counters) -> list:
    """Phases 6 and 7: ``rglru_scan`` and ``flash_attention`` against their
    plain versions, then recurrentgemma-2b served at full width and depth,
    and the fp32 prefill-vs-step agreement. ``counters`` as for
    :func:`lm_phases`. Returns the two kernels' records of the kernels
    line."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.kernels.rglru_scan import ref as sc_ref
    from repro_torch.models import model as lm_model, transformer
    from repro_torch.serving import engine, server

    gen = torch.Generator(dev).manual_seed(4)

    def reset():
        for ctr in counters:
            ctr.launches = 0

    def launches():
        """Launch counts without the moments kernel's (index 3): its one
        launch a posterior is printed, not asserted."""
        counts = tuple(ctr.launches for ctr in counters)
        return counts[:3] + counts[4:]

    # ---- phase 6: the two kernels against their plain versions ------------
    scan = {}
    for name, shape in (("served", (32, LM_PROMPT, 2560)),
                        ("train", (TRAIN_HY_B, TRAIN_HY_S, 2560)),
                        ("long", (4, 4096, 2560)), ("ragged", (3, 37, 11))):
        a = 0.85 + 0.149 * torch.rand(shape, generator=gen, device=dev)
        b = torch.randn(shape, generator=gen, device=dev) \
            * torch.sqrt(1 - a * a)
        got, want = sc_ops.rglru_scan(a, b), sc_ref.rglru_scan_ref(a, b)
        torch.testing.assert_close(got, want, rtol=TOL_SCAN, atol=TOL_SCAN)
        if name == "long" and not torch.equal(got, sc_ops.rglru_scan(a, b)):
            raise AssertionError("[hy_kernel] rglru_scan: two launches at "
                                 "the long shape differ")
        rec = {"shape": name, "dims": list(shape),
               "max_abs_err": float((got - want).abs().max()),
               "ms": time_ms(lambda: sc_ops.rglru_scan(a, b)),
               "plain_ms": time_ms(lambda: sc_ref.rglru_scan_ref(a, b), 5)}
        # one FMA and 12 bytes (a and b read, h written) an element
        rec["bound_ms"], rec["bound_by"] = bound(2 * a.numel(),
                                                 3 * 4 * a.numel())
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        _phase("hy_kernel", name="rglru_scan", **rec)
        scan[name] = rec
        del a, b, got, want
    scan_bwd_gates_phase(dev, time_ms, "phase 6")

    flash = {}
    for name, b, h, hkv, s, dh, dt, causal in (
            ("rg_prefill", 32, 10, 1, LM_PROMPT, 256, torch.bfloat16, True),
            ("rg_long", 4, 10, 1, 2048, 256, torch.bfloat16, True),
            ("qwen_prefill", 32, 12, 2, LM_PROMPT, 128, torch.bfloat16, True),
            ("qwen_fp32", 32, 12, 2, LM_PROMPT, 128, torch.float32, True),
            ("qwen_full", 32, 12, 2, LM_PROMPT, 128, torch.bfloat16, False),
            ("ragged", 3, 4, 2, 129, 80, torch.bfloat16, True)):
        rec = flash_case(gen, dev, time_ms, bound, nbytes, name,
                         (b, h, hkv, s, dh), dt, causal)
        _phase("hy_kernel", name="flash_attention", **rec)
        flash[name] = rec
    torch.cuda.empty_cache()

    # ---- phase 7: the hybrid main path -------------------------------------
    cfg = registry.get_config(HY_ARCH, mask_samples=LM_MASKS)
    kinds = [k for seg in cfg.segments() for _ in range(seg.reps)
             for k in seg.pattern]
    n_rec, n_local = kinds.count("rec"), kinds.count("local_attn")
    if (len(kinds), n_rec, n_local) != (26, 18, 8):
        raise AssertionError(f"{HY_ARCH} layers {kinds}")
    model = lm_model.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    _phase("hy_model", arch=HY_ARCH,
           params=sum(t.numel() for t in _leaves(params)),
           param_gbytes=nbytes(*_leaves(params)) / 1e9, layers=len(kinds),
           rec=n_rec, local_attn=n_local, d_model=cfg.d_model,
           heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
           head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
           lru_width=cfg.lru_width, window=cfg.local_window,
           vocab=cfg.vocab_size, tied=cfg.tie_embeddings, masks=LM_MASKS,
           dtype=cfg.dtype, init_s=f"{time.perf_counter() - t0:.1f}")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    max_seq = LM_PROMPT + LM_NEW
    fns = server.step_fns(model, device=dev)
    if fns.fused_spec is not None or fns.prefill_spec is not None:
        raise AssertionError(f"{HY_ARCH} took a fused lowering")
    pool = prompts.repeat(LM_MASKS, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mean, _, caches = fns.prefill(params, pool, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    state_bytes = nbytes(*(t for seg in caches for c in seg.values()
                           if "h" in c for t in c.values()))
    kv_bytes = nbytes(*(t for seg in caches for c in seg.values()
                        if "kpos" in c for t in c.values()))
    tok = mean.argmax(-1).to(torch.int32).repeat(LM_MASKS)[:, None]
    step_ms = time_ms(lambda: fns.decode(params, caches, tok, LM_PROMPT), 5)
    prof = call_profile(lambda: fns.decode(params, caches, tok, LM_PROMPT))
    _phase("hy_decode_profile", wall_ms_per_step=prof["wall_ms"],
           device_ms_per_step=prof["device_ms"],
           device_busy_share=prof["device_busy_share"],
           kernels_per_step=prof["kernels"],
           top_kernels_us_per_step=prof["top_kernels_us"])
    del caches, mean, tok
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    gen_toks, unc, _ = engine.serve_uncertain(
        model, params, prompts, engine.ServeConfig(max_new_tokens=LM_NEW),
        device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = launches()
    expect = (0, 0, 0, 0, n_local, n_rec)
    if counts != expect:
        raise AssertionError(f"{HY_ARCH} launches (masked_ffn, samples, "
                             f"fused moments, decode, flash, scan) = "
                             f"{counts}, expected {expect}")
    if gen_toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) \
            or not bool(torch.isfinite(unc).all()) \
            or not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{HY_ARCH} output {tuple(gen_toks.shape)}, "
                             f"finite {bool(torch.isfinite(unc).all())}")
    loop_ms = 1e3 * (secs - prefill_s) / LM_NEW
    _phase("hy_main_path", arch=HY_ARCH, dtype=cfg.dtype, leg="per_op",
           seconds=f"{secs:.4f}", prefill_ms=f"{1e3 * prefill_s:.3f}",
           decode_ms_per_step=f"{loop_ms:.3f}",
           decode_step_ms_events=f"{step_ms:.3f}",
           tokens_per_s=f"{LM_BATCH * LM_NEW / secs:.1f}",
           decode_tokens_per_s=f"{1e3 * LM_BATCH / loop_ms:.1f}",
           rec_state_mbytes=state_bytes / 1e6, kv_cache_mbytes=kv_bytes / 1e6,
           rel_unc_mean=float(unc.mean()), launches=counts,
           moments_launches=counters[3].launches)
    del params, gen_toks, unc
    torch.cuda.empty_cache()

    # ---- phase 7: the fp32 prefill-vs-step invariant at full width --------
    cfg5 = dataclasses.replace(cfg, n_layers=HY_PATH_LAYERS,
                               dtype=torch.float32)
    p5 = transformer.init(cfg5, torch.Generator(dev).manual_seed(0),
                          device=dev)
    toks = torch.randint(0, cfg.vocab_size, (LM_MASKS, LM_PROMPT + 1),
                         generator=torch.Generator(dev).manual_seed(5),
                         device=dev, dtype=torch.int32)
    reset()
    full, _ = transformer.prefill(cfg5, p5, {"tokens": toks},
                                  max_seq=LM_PROMPT + 1)
    torch.cuda.synchronize()
    full_counts = launches()
    _, caches = transformer.prefill(cfg5, p5, {"tokens": toks[:, :-1]},
                                    max_seq=LM_PROMPT + 1)
    reset()
    step, _ = transformer.decode_step(cfg5, p5, caches, toks[:, -1:],
                                      LM_PROMPT)
    torch.cuda.synchronize()
    step_counts = launches()
    if full_counts != (0, 0, 0, 0, 1, 4) or step_counts != (0,) * 6:
        raise AssertionError(f"path agreement launches: prefill "
                             f"{full_counts}, step {step_counts}")
    la = torch.log_softmax(full.float(), -1)
    lb = torch.log_softmax(step.float(), -1)
    path_err = float((la - lb).abs().max())
    if not path_err <= TOL_HY_PATH:
        raise AssertionError(f"prefill vs prefill+step log-probs differ by "
                             f"{path_err} > {TOL_HY_PATH}")
    _phase("hy_path_agreement", layers=HY_PATH_LAYERS, dtype=cfg5.dtype,
           rows=LM_MASKS, s=LM_PROMPT, max_abs_err_logp=path_err,
           tol=TOL_HY_PATH, argmax_equal=bool(torch.equal(
               la.argmax(-1), lb.argmax(-1))),
           prefill_launches=full_counts, step_launches=step_counts)
    del p5, caches, full, step
    torch.cuda.empty_cache()

    main_s, main_f = scan["served"], flash["rg_prefill"]
    return [
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:53"
                     " (pallas_call :66)",
         "launches": counts[5],
         "max_abs_err": max(r["max_abs_err"] for r in scan.values()),
         "ms": main_s["ms"], "kernel_ms": main_s["ms"],
         "plain_ms": main_s["plain_ms"], "bound_ms": main_s["bound_ms"],
         "bound_by": main_s["bound_by"], "library_ms": None,
         "bound_share": main_s["bound_share"],
         **{f"{n}_{k}": scan[n][k] for n in ("train", "long")
            for k in ("ms", "bound_ms", "bound_share")},
         "ragged_ms": scan["ragged"]["ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:88"
                     " (pallas_call :107)",
         "launches": counts[4],
         "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
         "ms": main_f["ms"], "kernel_ms": main_f["ms"],
         "plain_ms": main_f["plain_ms"], "bound_ms": main_f["bound_ms"],
         "bound_by": main_f["bound_by"], "library_ms": main_f["library_ms"],
         "device_ms": main_f["device_ms"],
         "library_device_ms": main_f["library_device_ms"],
         **{f"{n}_{k}": r[k] for n, r in flash.items() if n != "rg_prefill"
            for k in ("ms", "library_ms", "bound_ms", "device_ms",
                      "library_device_ms")}}]


#: The seven kernels, in the order of the counters the LM, server and
#: router phases are given.
KERNEL_NAMES = ("masked_ffn", "fused_plan_samples", "fused_plan_moments",
                "moments", "fused_decode", "flash_attention", "rglru_scan")


def _reset_counts(counters) -> None:
    for ctr in counters:
        ctr.launches = 0


def _launch_counts(counters) -> dict:
    return {n: ctr.launches for n, ctr in zip(KERNEL_NAMES, counters)}


def _step_builds() -> float:
    from repro_torch.obs import registry as obs_registry
    return obs_registry.REGISTRY.value("step_builds_total")


def _load_verify_obs():
    """The repository's trace verifier (benchmarks/verify_obs.py), loaded by
    path: its trace checks import nothing but the standard library."""
    import importlib.util
    path = Path(__file__).resolve().parent / "benchmarks" / "verify_obs.py"
    spec = importlib.util.spec_from_file_location("verify_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def server_traffic(vocab: int):
    """The server and router phases' traffic: ``SRV_REQUESTS`` prompts of
    ``SRV_MIN_PROMPT``-``LM_PROMPT`` tokens with ``SRV_MIN_NEW``-``LM_NEW``
    new tokens each, drawn from numpy seed 0. Returns the generator (later
    draws continue from it) and the ``(prompt, max_new_tokens)`` list."""
    import numpy as np
    rng = np.random.default_rng(0)
    traffic = [(rng.integers(0, vocab, int(n)), int(m)) for n, m in
               zip(rng.integers(SRV_MIN_PROMPT, LM_PROMPT + 1, SRV_REQUESTS),
                   rng.integers(SRV_MIN_NEW, LM_NEW + 1, SRV_REQUESTS))]
    return rng, traffic


def server_phases(dev, time_ms, bound, nbytes, counters, scan_plan,
                  volume) -> dict:
    """Phase 8: the continuous-batching server (``serving.server.
    BayesianLMServer``) on qwen2-1.5b at full width and depth, with LM
    requests arriving in waves and one IVIM scan sharing the pool; then
    the admission breakdown, fused_decode at the server's shapes, the fp32
    pool against the one-shot ``serve_uncertain``, a traced run through the
    repository's verifier, and the hybrid pool. ``counters`` as for
    :func:`lm_phases`. Returns the launch counts by kernel."""
    import collections
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import uncertainty as unc_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.models import layers, model as lm_model, transformer
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import registry as obs_registry
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine, server

    def fallbacks():
        return (dict(server.fallback_counts), dict(engine.fallback_counts),
                obs_registry.REGISTRY.value("fused_fallback_total"))

    def pct(vals, q):
        return float(np.percentile(np.asarray(vals), q)) if vals \
            else float("nan")

    cfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    scfg = server.ServerConfig(max_slots=SRV_SLOTS, max_prompt_len=LM_PROMPT,
                               max_new_tokens=LM_NEW, fused=True)
    rng, traffic = server_traffic(cfg.vocab_size)
    buckets = sorted({plan_lib.prefill_bucket(len(t), scfg.max_seq)
                      for t, _ in traffic})
    x = volume.reshape(-1, volume.shape[-1])
    n_vox, n_chunks = x.shape[0], -(-x.shape[0] // CHUNK)

    # ---- warm every step the traffic uses: the scan executor (and the
    # direct result the pooled scan is held to), each prefill bucket, the
    # decode step; the timed run must build nothing
    direct = engine.predict_volume(scan_plan, volume, chunk=CHUNK,
                                   fused=True, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.predict_volume(scan_plan, volume, chunk=CHUNK, fused=True,
                          device=dev)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t
    warm = server.BayesianLMServer(model, params, scfg, device=dev)
    for b in buckets:
        warm.submit(traffic[0][0][:1].repeat(b), max_new_tokens=2)
    warm.submit_scan(scan_plan, x[:CHUNK], chunk=CHUNK, fused=True)
    warm.run()
    del warm

    # ---- the timed run: three waves of LM requests interleaved with
    # step(), the scan submitted after the first wave
    srv = server.BayesianLMServer(model, params, scfg, device=dev)
    before = (_step_builds(), fallbacks(), dict(srv.steps.counts))
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, rs = [], None
    for w in range(0, SRV_REQUESTS, SRV_WAVE):
        for toks, mnt in traffic[w:w + SRV_WAVE]:
            rids.append(srv.submit(toks, max_new_tokens=mnt))
        if rs is None:
            rs = srv.submit_scan(scan_plan, x, chunk=CHUNK, fused=True)
        for _ in range(SRV_WAVE_STEPS):
            srv.step()
    summary = srv.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _launch_counts(counters)
    built = _step_builds() - before[0]
    occ, vocc = (srv.metrics.occupancy_samples,
                 srv.metrics.voxel_occupancy_samples)
    lm_steps = sum(o > v for o, v in zip(occ, vocc))
    admissions = len(traffic)
    prefills = srv.steps.counts["prefill_bucketed"] \
        - before[2].get("prefill_bucketed", 0)
    expect = {"masked_ffn": 0, "fused_plan_samples": 0,
              "fused_plan_moments": n_chunks, "moments": admissions,
              "fused_decode": lm_steps,
              "flash_attention": LM_FLASH_LAUNCHES * admissions,
              "rglru_scan": 0}
    if got != expect:
        raise AssertionError(f"server launches {got}, expected {expect}")
    if built != 0 or fallbacks() != before[1] or not srv.steps.fused_live():
        raise AssertionError(f"server timed run: {built} step builds, "
                             f"fallbacks {fallbacks()} (before "
                             f"{before[1]})")
    if prefills != admissions:
        raise AssertionError(f"{prefills} bucketed prefills for "
                             f"{admissions} admissions")
    scan = srv.result(rs)
    pooled = scan.scan_moments()
    want = tuple(t.reshape(n_vox, -1) for t in direct)
    if scan.status != "done" or not all(torch.equal(g, w) for g, w in
                                         zip(pooled, want)):
        raise AssertionError("the pooled scan differs from the direct "
                             "predict_volume")
    for r, (toks, mnt) in zip(rids, traffic):
        st = srv.result(r)
        if st.status != "done" or len(st.generated) != mnt or not all(
                math.isfinite(u) for u in st.uncertainty) or not all(
                0 <= tok < cfg.vocab_size for tok in st.generated):
            raise AssertionError(f"request {r}: {st.status}, "
                                 f"{len(st.generated)} of {mnt} tokens")
    if summary.completed != admissions + 1 or srv.occupied_slots:
        raise AssertionError(f"server: {summary.completed} completed")
    tls = [srv.metrics.timelines[r] for r in rids]
    scan_tl = srv.metrics.timelines[rs]
    scan_s = scan_tl.finish_t - scan_tl.admit_t
    pool_bytes = nbytes(*(t for seg in srv._caches for c in seg.values()
                          for t in c.values()))
    main = {"arch": LM_ARCH, "dtype": cfg.dtype, "slots": SRV_SLOTS,
            "rows": srv.schedule.rows, "max_seq": scfg.max_seq,
            "requests": admissions, "scans": 1, "buckets": buckets,
            "steps": summary.decode_steps, "lm_steps": lm_steps,
            "seconds": secs, "ms_per_step": 1e3 * secs / summary.decode_steps,
            "lm_tokens": summary.total_tokens,
            "decode_tokens_per_s": summary.total_tokens / secs,
            "summary_tokens_per_s": summary.tokens_per_s,
            "ttft_p50_ms": 1e3 * pct([t.ttft for t in tls], 50),
            "ttft_p99_ms": 1e3 * pct([t.ttft for t in tls], 99),
            "latency_p50_ms": 1e3 * summary.latency_p50_s,
            "latency_p99_ms": 1e3 * summary.latency_p99_s,
            "queue_wait_p50_ms": 1e3 * summary.queue_wait_p50_s,
            "scan_voxels_per_s_in_pool": n_vox / scan_s,
            "scan_voxels_per_s_direct": n_vox / direct_s,
            "scan_steps_in_pool": len(scan.chunk_results),
            "peak_queue_depth": summary.peak_queue_depth,
            "mean_slot_occupancy": summary.mean_slot_occupancy,
            "mean_voxel_occupancy": summary.mean_voxel_occupancy,
            "pool_mbytes": pool_bytes / 1e6, "builds_in_run": built,
            "launches": got, "pooled_scan_equals_direct": True}
    _phase("server", **main)

    # ---- where a step's time goes: the same traffic again on a fresh
    # server, each part timed with a synchronize on either side (the
    # server itself holds no timer: the parts are wrapped here)
    parts: dict[str, list] = collections.defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name].append(1e3 * (time.perf_counter() - t))
            return out
        # one attribute dict: a kernel wrapper counts its launches on the
        # module-level name, which is this wrapper while it is patched in
        wrapper.__dict__ = fn.__dict__
        return wrapper

    srv2 = server.BayesianLMServer(model, params, scfg, device=dev)
    patched = [(transformer, "prefill"), (transformer, "cache_trim_positions"),
               (transformer, "cache_scatter_rows"),
               (transformer, "cache_reset_rows"),
               (unc_lib, "token_posterior"), (fd_ops, "fused_decode"),
               (plan_lib, "_decode_commit_caches")]
    saved = [getattr(mod, n) for mod, n in patched]
    for mod, n in patched:
        setattr(mod, n, timed(n, getattr(mod, n)))
    for n in ("step", "_advance_scan"):
        setattr(srv2, n, timed(n, getattr(srv2, n)))
    admit = srv2._admit

    def admit_by_kind(rid, slot):        # LM admissions apart from scans'
        kind = srv2.states[rid].kind
        return timed("_admit" if kind == "lm" else "_admit_scan", admit)(
            rid, slot)

    srv2._admit = admit_by_kind
    try:
        rs2 = None
        for w in range(0, SRV_REQUESTS, SRV_WAVE):
            for toks, mnt in traffic[w:w + SRV_WAVE]:
                srv2.submit(toks, max_new_tokens=mnt)
            if rs2 is None:
                rs2 = srv2.submit_scan(scan_plan, x, chunk=CHUNK, fused=True)
            for _ in range(SRV_WAVE_STEPS):
                srv2.step()
        srv2.run()
    finally:
        for (mod, n), fn in zip(patched, saved):
            setattr(mod, n, fn)
    tot = {k: sum(v) for k, v in parts.items()}
    n_admit, n_decode = len(parts["_admit"]), len(parts["fused_decode"])
    admit_rest = tot["_admit"] - sum(
        tot[k] for k in ("prefill", "cache_trim_positions",
                         "token_posterior", "cache_scatter_rows"))
    breakdown = {
        "replay_ms": tot["step"], "admissions": n_admit,
        "admit_ms_each": tot["_admit"] / n_admit,
        "admit_prefill_forward_ms_each": tot["prefill"] / n_admit,
        "admit_trim_ms_each": tot["cache_trim_positions"] / n_admit,
        "admit_first_posterior_ms_each": tot["token_posterior"] / n_admit,
        "admit_scatter_ms_each": tot["cache_scatter_rows"] / n_admit,
        "admit_rest_ms_each": admit_rest / n_admit,
        "admit_share_of_steps": tot["_admit"] / tot["step"],
        "scan_chunk_ms_each": tot["_advance_scan"]
        / len(parts["_advance_scan"]),
        "slot_reset_ms_each": tot["cache_reset_rows"]
        / len(parts["cache_reset_rows"]),
        "lm_steps": n_decode,
        "decode_kernel_ms_each": tot["fused_decode"] / n_decode,
        "decode_commit_ms_each": tot["_decode_commit_caches"] / n_decode,
        # a step with LM slots, less its admissions and scan chunk: the
        # kernel, the commit, embedding and RoPE, the host bookkeeping
        "decode_step_ms_each": (tot["step"] - tot["_admit"]
                                - tot.get("_admit_scan", 0.0)
                                - tot["_advance_scan"]
                                - tot["cache_reset_rows"]) / n_decode}
    _phase("server_breakdown", **{k: round(v, 4) if isinstance(v, float)
                                  else v for k, v in breakdown.items()})
    del srv2

    # ---- one admission's prefill (the longest bucket) under the profiler:
    # the card's busy time beside the wall time
    toks = torch.from_numpy(traffic[0][0][:1].repeat(buckets[-1])).to(dev)
    toks = toks.to(torch.int32)[None].repeat(LM_MASKS, 1)
    fns = server.step_fns(model, fused=True, device=dev)
    fns.prefill(params, toks, max_seq=scfg.max_seq)
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as trace:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fns.prefill(params, toks, max_seq=scfg.max_seq)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    per_kernel: dict[str, list] = {}
    for e in trace.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_kernel.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    busy = sum(us for us, _ in per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    _phase("server_prefill_profile", bucket=buckets[-1], rows=LM_MASKS,
           wall_ms=f"{wall_ms:.3f}",
           device_ms=f"{busy:.3f}" if busy else "not measured",
           device_busy_share=f"{busy / wall_ms:.3f}" if busy
           else "not measured",
           kernels=sum(n for _, n in per_kernel.values()),
           top_kernels_us=[(name[:40], round(us, 1), n)
                           for name, (us, n) in top])
    del trace, per_kernel

    # ---- fused_decode at the server's shapes: 1, 3 and 8 of 8 slots
    # active (the rest at pos -1), against its plain version
    spec = plan_lib.lower_fused_decode(cfg)
    rot = next(st.rot_dim for st in spec.steps if st.kind == "attn")
    shape_recs = {}
    for active in SRV_ACTIVE:
        probe = server.BayesianLMServer(model, params, scfg, device=dev)
        for toks, _ in traffic[:active]:
            probe.submit(toks)
        probe.step()
        tok = np.zeros(SRV_SLOTS, np.int32)
        pos = np.full(SRV_SLOTS, -1, np.int32)
        for slot, rid in enumerate(probe._slots):
            if rid is not None:
                tok[slot] = probe.states[rid].pending
                pos[slot] = probe.states[rid].next_pos
        rows_tok = probe.schedule.row_values(torch.from_numpy(tok)).to(dev)
        rows_pos = probe.schedule.row_values(torch.from_numpy(pos)).to(dev)
        rows = rows_tok.shape[0]
        flat = plan_lib._decode_flat_params(spec, cfg, params, rows, True)
        fc = plan_lib._decode_flat_caches(cfg, probe._caches)
        xe = layers.embed_tokens(params["embed"], rows_tok)
        cos, sin = layers.rope_cos_sin(rows_pos, rot, cfg.rope_theta)
        args = (xe, flat, fc, rows_pos, cos, sin)
        got_k = fd_ops.fused_decode(spec, *args)
        want_k = fd_ops.fused_decode_ref(spec, *args)
        for g, w in zip(got_k[:2], want_k[:2]):
            torch.testing.assert_close(g, w, rtol=TOL_DECODE, atol=TOL_DECODE)
        rel = float((got_k[0] - want_k[0]).abs().max()
                    / want_k[0].abs().max())
        if not rel <= TOL_DECODE_REL:
            raise AssertionError(f"fused_decode at {active} active slots: "
                                 f"error {rel:.3g} of |mean_logp|")
        kv_err = max(_within_bf16_ulp(g, w) for g, w in
                     zip(got_k[2:], want_k[2:]))
        # the bytes this step must move: weights, the valid cache rows of
        # the active slots, operands and outputs
        # what this step's data needs, as in lm_phases' kernel_case: the
        # valid cache slots of each row (kpos in [0, pos], not the slot
        # being overwritten) plus the fresh key; rows at pos -1 read none
        attn = [st for st in spec.steps if st.kind == "attn"]
        p64, smax = rows_pos.long(), fc[0].shape[2]
        seen = 0
        for st, kp in zip(attn, fc[2::3]):
            slot = ((p64 % st.window) if st.window else p64) % smax
            seen += int(((kp >= 0) & (kp <= p64[:, None])
                         & (torch.arange(smax, device=dev)[None, :]
                            != slot[:, None])).sum())
        at = attn[0]
        per_key = 4 * at.n_heads * at.head_dim // at.n_kv_heads
        flops = plan_lib.decode_traffic(spec, rows, smax).flops \
            - len(attn) * rows * at.n_kv_heads * per_key * (smax + 1) \
            + at.n_kv_heads * per_key * (seen + len(attn) * rows)
        moved = nbytes(xe, rows_pos, cos, sin, *got_k, *flat, *fc[2::3]) \
            + 2 * seen * at.n_kv_heads * at.head_dim * fc[0].element_size()
        rec = {"active_slots": active, "rows": rows,
               "active_rows": active * LM_MASKS,
               "max_abs_err": max(float((g - w).abs().max())
                                  for g, w in zip(got_k[:2], want_k[:2])),
               "rel_err": rel, "kv_max_abs_err": kv_err,
               "ms": time_ms(lambda: fd_ops.fused_decode(spec, *args), 10),
               "plain_ms": time_ms(lambda: fd_ops.fused_decode_ref(
                   spec, *args), 2)}
        rec["bound_ms"], rec["bound_by"] = bound(flops, moved,
                                                 BF16_PEAK / 3)
        _phase("server_kernel", name="fused_decode", **rec)
        shape_recs[active] = rec
        del probe, args, got_k, want_k, flat, fc

    # ---- the fp32 pool against the one-shot serve_uncertain (batch
    # independence; in bf16 the fused kernel's atomics can split near-ties)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = lm_model.build_model(cfg32)
    params32 = _tree(lambda t: t.float(), params)
    p32 = rng.integers(0, cfg.vocab_size, (SRV_FP32_REQUESTS, SRV_FP32_PROMPT))
    srv32 = server.BayesianLMServer(model32, params32, scfg, device=dev)
    rids32 = [srv32.submit(p) for p in p32]
    _reset_counts(counters)
    srv32.run()
    steps32 = _launch_counts(counters)["fused_decode"]
    gen, unc, _ = engine.serve_uncertain(
        model32, params32, torch.from_numpy(p32).to(dev),
        engine.ServeConfig(max_new_tokens=LM_NEW, fused=True), device=dev)
    same = all(srv32.result(r).generated == gen[i, SRV_FP32_PROMPT:].tolist()
               for i, r in enumerate(rids32))
    pool_unc = torch.tensor([srv32.result(r).uncertainty for r in rids32])
    if not same or steps32 != LM_NEW:
        raise AssertionError(f"fp32 pool vs serve_uncertain: tokens equal "
                             f"{same}, {steps32} fused_decode launches")
    torch.testing.assert_close(pool_unc, unc.cpu(), rtol=TOL_LM_UNC,
                               atol=TOL_LM_UNC)
    _phase("server_agreement", dtype=cfg32.dtype,
           requests=SRV_FP32_REQUESTS, prompt=SRV_FP32_PROMPT,
           new_tokens=LM_NEW, tokens_equal=True,
           rel_unc_max_abs_err=float((pool_unc - unc.cpu()).abs().max()),
           tol=TOL_LM_UNC, fused_decode_launches=steps32)
    del srv32, params32, model32, gen, unc

    # ---- one traced run through the repository's verifier
    obs_trace.TRACER.configure(capacity=1 << 16)
    tsrv = server.BayesianLMServer(
        model, params, dataclasses.replace(scfg, trace=True), device=dev)
    for toks, mnt in traffic[:SRV_TRACE_REQUESTS]:
        tsrv.submit(toks, max_new_tokens=mnt)
    tsrv.submit_scan(scan_plan, x[:SRV_TRACE_CHUNKS * CHUNK], chunk=CHUNK,
                     fused=True)
    tsrv.run()
    obs_trace.TRACER.disable()
    events = obs_trace.TRACER.events()
    errors = _load_verify_obs().verify_trace_events(events)
    kinds = collections.Counter(e["name"] for e in events)
    exposition = obs_export.parse_exposition(obs_export.prometheus_text())
    if errors or not {"enqueue", "admit", "prefill", "step", "decode",
                      "token", "chunk", "finish"} <= set(kinds) or not any(
            n == "serving_requests_total" for n, _ in exposition):
        raise AssertionError(f"trace check: {errors[:5]}, events {kinds}")
    _phase("server_trace", records=len(events), verifier_errors=0,
           events=dict(kinds), exposition_samples=len(exposition))
    obs_trace.TRACER.clear()
    del tsrv, params, model
    torch.cuda.empty_cache()

    # ---- the hybrid pool: recurrentgemma-2b, per-op, 2 slots; the second
    # request arrives while the first decodes, so its admission scatters
    # h and conv into a pool that is stepping
    hcfg = registry.get_config(HY_ARCH, mask_samples=LM_MASKS)
    hmodel = lm_model.build_model(hcfg)
    hparams = hmodel.init(torch.Generator(dev).manual_seed(0), device=dev)
    hscfg = server.ServerConfig(max_slots=SRV_HY_SLOTS,
                                max_prompt_len=LM_PROMPT,
                                max_new_tokens=SRV_HY_NEW, fused=False)
    hsrv = server.BayesianLMServer(hmodel, hparams, hscfg, device=dev)
    kinds = [k for seg in hcfg.segments() for _ in range(seg.reps)
             for k in seg.pattern]
    hy_traffic = [rng.integers(0, hcfg.vocab_size, int(n)) for n in
                  rng.integers(SRV_MIN_PROMPT, LM_PROMPT + 1,
                               SRV_HY_REQUESTS)]
    _reset_counts(counters)
    hrids = [hsrv.submit(hy_traffic[0])]
    resets = steps = 0
    pending = list(hy_traffic[1:])
    while True:
        if steps == 2:                        # the rest arrive mid-decode
            hrids += [hsrv.submit(p) for p in pending]
        held = list(hsrv._slots)
        if not hsrv.step():
            break
        steps += 1
        for slot, rid in enumerate(held):     # released this step: reset
            if rid is None or hsrv._slots[slot] is not None:
                continue
            rows = hsrv.schedule.rows_for_slot(slot, device=dev)
            for seg in hsrv._caches:
                for c in seg.values():
                    for name, leaf in c.items():
                        want_v = -1 if name == "kpos" else 0
                        if not bool((leaf[:, rows] == want_v).all()):
                            raise AssertionError(f"hybrid slot {slot}: "
                                                 f"{name} not reset")
            resets += 1
    hgot = _launch_counts(counters)
    n_rec, n_local = kinds.count("rec"), kinds.count("local_attn")
    if (hgot["rglru_scan"], hgot["flash_attention"], hgot["fused_decode"]) \
            != (n_rec * SRV_HY_REQUESTS, n_local * SRV_HY_REQUESTS, 0) \
            or resets != SRV_HY_REQUESTS:
        raise AssertionError(f"hybrid server launches {hgot}, "
                             f"{resets} slot resets")
    for r in hrids:
        st = hsrv.result(r)
        if st.status != "done" or len(st.generated) != SRV_HY_NEW or not \
                all(math.isfinite(u) for u in st.uncertainty):
            raise AssertionError(f"hybrid request {r}: {st.status}")
    _phase("server_hybrid", arch=HY_ARCH, layers=len(kinds),
           dtype=hcfg.dtype, slots=SRV_HY_SLOTS, requests=SRV_HY_REQUESTS,
           new_tokens=SRV_HY_NEW, steps=steps, slot_resets_checked=resets,
           launches=hgot)
    del hsrv, hparams, hmodel
    torch.cuda.empty_cache()
    return {"main": got, "hybrid": hgot, "shapes": shape_recs,
            "seconds": secs, "lm_tokens": summary.total_tokens,
            "ms_per_step": main["ms_per_step"]}


def router_phases(dev, counters, scan_plan, volume) -> dict:
    """Phase 9: the fault-tolerant router (``serving.router.ServingRouter``)
    over three ``BayesianLMServer`` hosts on the card, each with the server
    phase's pool (qwen2-1.5b, bf16, 28 layers), serving the server phase's
    traffic and the IVIM slab on a ManualClock: unfaulted, then under a
    seeded fault plan with the scan's home killed while the scan is
    resident, traced; then the fp32 failover against one server, and the
    trace through the repository's verifier. Runs after the server phase,
    whose warm-up built every step the traffic uses. Returns the launches
    by kernel of both runs."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as lm_model
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine, router as router_lib, server
    from repro_torch.serving.faults import FaultEvent, FaultPlan

    cfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    scfg = server.ServerConfig(max_slots=SRV_SLOTS, max_prompt_len=LM_PROMPT,
                               max_new_tokens=LM_NEW, fused=True)
    rcfg = router_lib.RouterConfig(n_hosts=ROUTER_HOSTS,
                                   heartbeat_timeout_s=ROUTER_TIMEOUT_S,
                                   max_retries=ROUTER_RETRIES)
    rng, traffic = server_traffic(cfg.vocab_size)
    x = volume.reshape(-1, volume.shape[-1])
    n_vox, n_chunks = x.shape[0], -(-x.shape[0] // CHUNK)
    direct = engine.predict_volume(scan_plan, volume, chunk=CHUNK,
                                   fused=True, device=dev)
    want = tuple(t.reshape(n_vox, -1) for t in direct)

    def drive(faults, rc):
        """The server phase's arrivals through a fresh router: three waves
        of 8 interleaved with 12 router steps, the scan after the first
        wave, then steps until every record is terminal."""
        clock = obs_trace.ManualClock()
        router = router_lib.ServingRouter(model, params, scfg, rc,
                                          device=dev, faults=faults,
                                          clock=clock)
        b0 = _step_builds()
        _reset_counts(counters)
        rids, rs, first = [], None, None

        def step():
            nonlocal first
            router.step()
            clock.advance(1.0)
            scan_rec = router.result(rs)
            if first is None and scan_rec.chunk_results:
                first = scan_rec.chunk_results[0]
            if router.step_i > 10_000:
                raise AssertionError("the router did not converge")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(0, SRV_REQUESTS, SRV_WAVE):
            for toks, mnt in traffic[w:w + SRV_WAVE]:
                rids.append(router.submit(toks, max_new_tokens=mnt))
            if rs is None:
                rs = router.submit_scan(scan_plan, x, chunk=CHUNK,
                                        fused=True)
            for _ in range(SRV_WAVE_STEPS):
                step()
        while any(not r.done for r in router.records.values()):
            step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got, built = _launch_counts(counters), _step_builds() - b0
        summary = router.summary()
        scan = router.result(rs)
        pooled = scan.scan_moments()
        if summary.completed != SRV_REQUESTS + 1 or summary.lost \
                or summary.shed or built:
            raise AssertionError(f"router: {summary.format()}; {built} "
                                 f"step builds")
        if not all(torch.equal(g, w) for g, w in zip(pooled, want)) or \
                scan.final.chunk_results[0] is not first:
            raise AssertionError("the routed scan differs from the direct "
                                 "predict_volume, or was recomputed")
        # one moments launch and 28 flash an admission (re-admissions after
        # a failover included); one fused_plan_moments a scan chunk — in the
        # unfaulted run exactly one a chunk, under faults more only where a
        # dropped step's chunks died with their host unharvested
        # and one fused_decode a host step with an LM slot, as the server
        # phase reads it (dropped steps ran on their host and count too)
        admissions = got["moments"]
        chunk_ok = got["fused_plan_moments"] == n_chunks if not \
            faults.events else got["fused_plan_moments"] >= n_chunks
        lm_steps = sum(o > v for h in router.hosts for o, v in zip(
            h.server.metrics.occupancy_samples,
            h.server.metrics.voxel_occupancy_samples))
        if (got["masked_ffn"], got["fused_plan_samples"],
                got["rglru_scan"]) != (0, 0, 0) or not chunk_ok or \
                admissions < SRV_REQUESTS or \
                got["flash_attention"] != LM_FLASH_LAUNCHES * admissions \
                or got["fused_decode"] != lm_steps:
            raise AssertionError(f"router launches {got}, {lm_steps} host "
                                 f"steps with an LM slot")
        for r, (_, mnt) in zip(rids, traffic):
            rec = router.result(r)
            if len(rec.generated) != mnt or not all(
                    math.isfinite(u) for u in rec.uncertainty) or not all(
                    0 <= tok < cfg.vocab_size for tok in rec.generated):
                raise AssertionError(f"routed request {r}: {rec.status}, "
                                     f"{len(rec.generated)} of {mnt}")
        ttft = [tl.ttft for h in router.hosts
                for tl in h.server.metrics.timelines.values()
                if tl.finish_t is not None and tl.ttft is not None]
        rec = {"hosts": ROUTER_HOSTS, "steps": summary.steps,
               "seconds": secs, "ms_per_router_step":
                   1e3 * secs / summary.steps,
               "host_steps": [h.steps for h in router.hosts],
               "lm_tokens": summary.total_tokens,
               "decode_tokens_per_s": summary.total_tokens / secs,
               # the hosts' metrics read the router's ManualClock: their
               # TTFT is in router steps (1 virtual second each)
               "ttft_p50_router_steps": float(np.percentile(ttft, 50)),
               "ttft_p99_router_steps": float(np.percentile(ttft, 99)),
               "host_ttft_p50_router_steps": [
                   s.ttft_p50_s for s in router.host_summaries()],
               "host_deaths": summary.host_deaths,
               "retries": summary.retries, "spills": summary.spills,
               "remeshes": summary.remeshes,
               "recovery_steps": list(summary.recovery_steps),
               "hosts_alive": summary.hosts_alive,
               "scan_retries": scan.retries, "builds_in_run": built,
               "launches": got, "scan_equals_direct": True}
        return router, rids, rs, rec

    # ---- unfaulted, then the seeded plan plus the scan home's kill, traced
    clean, rids, rs, rec = drive(FaultPlan(), rcfg)
    if rec["host_deaths"] or rec["retries"]:
        raise AssertionError(f"unfaulted router: {rec}")
    _phase("router", run="unfaulted", **rec)
    scan_home = clean.result(rs).home
    seeded = FaultPlan.seeded(ROUTER_SEED, n_hosts=ROUTER_HOSTS,
                              horizon=clean.step_i)
    faults = FaultPlan(events=seeded.events + (FaultEvent(
        step=ROUTER_SCAN_KILL_STEP, host=scan_home, action="kill"),),
        seed=ROUTER_SEED)
    killed = {e.host for e in faults.events if e.action == "kill"}
    obs_trace.TRACER.clear()
    obs_trace.TRACER.configure(capacity=1 << 17)
    chaos, _, _, frec = drive(faults, dataclasses.replace(rcfg, trace=True))
    obs_trace.TRACER.disable()
    events = obs_trace.TRACER.events()
    if frec["host_deaths"] != len(killed) or frec["retries"] < 1 or \
            frec["remeshes"] < 1 or frec["scan_retries"] < 1:
        raise AssertionError(f"faulted router: {frec}, killed {killed}")
    pairs = [(clean.result(r).generated, chaos.result(r).generated)
             for r in rids]
    same = sum(a == b for x_, y_ in pairs for a, b in zip(x_, y_)) \
        / sum(len(x_) for x_, _ in pairs)
    _phase("router", run="faulted", seed=ROUTER_SEED,
           events=[dataclasses.astuple(e) for e in faults.events],
           scan_home=scan_home, killed_hosts=sorted(killed),
           tokens_equal_share_vs_unfaulted=f"{same:.4f}", **frec)

    # ---- the trace of the faulted run through the repository's verifier
    errors = _load_verify_obs().verify_trace_events(events)
    kinds = {}
    for e in events:
        kinds[e["name"]] = kinds.get(e["name"], 0) + 1
    if errors or not {"route", "host_death", "retry", "remesh", "enqueue",
                      "finish", "fault_kill", "host_step"} <= set(kinds) \
            or len(events) >= 1 << 17:
        raise AssertionError(f"router trace: {errors[:5]}, events {kinds}")
    _phase("router_trace", records=len(events), verifier_errors=0,
           events=kinds)
    obs_trace.TRACER.clear()
    del clean, chaos, events

    # ---- fp32: a host killed mid-decode against one server
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = lm_model.build_model(cfg32)
    params32 = _tree(lambda t: t.float(), params)
    del params
    p32 = rng.integers(0, cfg.vocab_size,
                       (ROUTER_FP32_REQUESTS, SRV_FP32_PROMPT))
    single = server.BayesianLMServer(model32, params32, scfg, device=dev)
    srids = [single.submit(p) for p in p32]
    single.run()
    clock = obs_trace.ManualClock()
    router = router_lib.ServingRouter(
        model32, params32, scfg, rcfg, device=dev, clock=clock,
        faults=FaultPlan(events=(FaultEvent(
            step=ROUTER_FP32_KILL_STEP, host=ROUTER_FP32_KILL_HOST,
            action="kill"),)))
    rids32 = [router.submit(p) for p in p32]
    s32 = router.run(max_steps=10_000, tick=lambda: clock.advance(1.0))
    same = all(router.result(r).generated == single.result(q).generated
               for r, q in zip(rids32, srids))
    got_u = torch.tensor([router.result(r).uncertainty for r in rids32])
    want_u = torch.tensor([single.result(q).uncertainty for q in srids])
    if not same or s32.host_deaths != 1 or s32.retries < 1 or \
            s32.completed != ROUTER_FP32_REQUESTS:
        raise AssertionError(f"fp32 router vs one server: tokens equal "
                             f"{same}; {s32.format()}")
    torch.testing.assert_close(got_u, want_u, **TOL_ROUTER_UNC)
    _phase("router_agreement", dtype=cfg32.dtype, layers=cfg32.n_layers,
           requests=ROUTER_FP32_REQUESTS, prompt=SRV_FP32_PROMPT,
           killed_host=ROUTER_FP32_KILL_HOST,
           kill_step=ROUTER_FP32_KILL_STEP, host_deaths=s32.host_deaths,
           retries=s32.retries, tokens_equal=True,
           rel_unc_max_abs_err=float((got_u - want_u).abs().max()),
           tol=TOL_ROUTER_UNC)
    del router, single, params32, model32
    torch.cuda.empty_cache()
    return {"unfaulted": rec["launches"], "faulted": frec["launches"],
            "unfaulted_rec": rec}


def schedule_phase(dev, time_ms, counters) -> dict:
    """Phase 10: the paper's schedule surface (§V-C/D, Fig. 5, Table II) on
    the card at the dense IVIM widths: the Masksembles layer applied mask by
    mask (mask-as-multiply, no skipping: the baseline), the packed form
    (``packing.packed_ffn_apply``), ``scheduler.run`` in the batch- and
    sampling-level orders (one product a sample and a batch or a chunk),
    and ``masked_ffn`` in both grid orders; all held to the baseline within
    TOL_3XTF32_REL of its magnitude, the kernel's orders bit-equal. Prints
    each order's weight loads and traffic, each leg's ms (no bar on speed)
    and the ``grid_sweep`` rows beside the kernel's fixed tile. Returns the
    masked_ffn launches of the legs' run."""
    import torch
    from repro_torch.core import latency_model, masks as masks_lib
    from repro_torch.core import masksembles, packing, scheduler
    from repro_torch.kernels.masked_ffn import ops as mffn_ops

    w, n, b = SCHED_WIDTH, SCHED_MASKS, CHUNK
    spec = masks_lib.MaskSpec(width=w, n_masks=n, scale=2.0, seed=0)
    gen = torch.Generator(dev).manual_seed(0)
    p = masksembles.masked_ffn_init(gen, w, w, w, spec)
    for layer in ("fc1", "fc2"):
        p[layer]["b"] = 0.1 * torch.randn(w, generator=gen, device=dev)
    x = torch.rand((b, w), generator=gen, device=dev)
    pk = packing.pack_masked_ffn(p["fc1"]["w"], p["fc1"]["b"], p["fc2"]["w"],
                                 p["fc2"]["b"], p["fc1"]["masks"])
    keep = pk["w1p"].shape[-1]

    def per_sample(params, xb, i):
        return packing.packed_ffn_apply(params, xb, sample=i)

    legs = {
        "masked_per_mask": lambda: torch.stack([
            masksembles.masked_ffn_apply(
                p, x, torch.full((b,), i, device=dev)) for i in range(n)]),
        "packed": lambda: packing.packed_ffn_apply(pk, x),
        "batch_level": lambda: scheduler.run(
            scheduler.Schedule("batch"), per_sample, pk, x, n),
        "sampling_level": lambda: scheduler.run(
            scheduler.Schedule("sampling", chunk=SCHED_CHUNK), per_sample,
            pk, x, n),
        "kernel_batch_level": lambda: mffn_ops.masked_ffn(
            x, pk["w1p"], pk["b1p"], pk["w2p"], pk["b2"], sample_major=True),
        "kernel_sampling_level": lambda: mffn_ops.masked_ffn(
            x, pk["w1p"], pk["b1p"], pk["w2p"], pk["b2"],
            sample_major=False)}
    for ctr in counters:
        ctr.launches = 0
    outs = {name: fn() for name, fn in legs.items()}
    torch.cuda.synchronize()
    kernel_launches = mffn_ops.masked_ffn.launches
    if kernel_launches != 2 or any(c.launches for c in counters
                                   if c is not mffn_ops.masked_ffn):
        raise AssertionError(f"schedule legs: {kernel_launches} masked_ffn "
                             f"launches, expected 2 and no other kernel")
    base = outs["masked_per_mask"]
    if base.shape != (n, b, w) or not bool(torch.isfinite(base).all()):
        raise AssertionError(f"baseline {tuple(base.shape)}")
    rel = {}
    for name, out in outs.items():
        rel[name] = float((out - base).abs().max() / base.abs().max())
        if out.shape != base.shape or not rel[name] <= TOL_3XTF32_REL:
            raise AssertionError(f"schedule leg {name}: error {rel[name]:.3g}"
                                 f" of the baseline's magnitude")
    if not torch.equal(outs["kernel_batch_level"],
                       outs["kernel_sampling_level"]):
        raise AssertionError("masked_ffn's two grid orders differ")
    ms = {name: time_ms(fn, 5) for name, fn in legs.items()}
    orders = {}
    for kind in ("batch", "sampling"):
        sch = scheduler.Schedule(kind, chunk=SCHED_CHUNK)
        tm = scheduler.traffic_model(sch, b, n, w, keep, w, 4)
        orders[kind] = {"weight_loads": scheduler.weight_load_counts(sch, b,
                                                                     n),
                        "weight_bytes": tm.weight_bytes,
                        "arithmetic_intensity": tm.arithmetic_intensity}
    _phase("schedule", width=w, keep=keep, masks=n, voxels=b,
           weight_load_counts={k: v["weight_loads"]
                               for k, v in orders.items()},
           orders=orders, ms=ms, rel_err=rel, kernel_orders_bit_equal=True,
           masked_ffn_launches=kernel_launches)
    sweep = latency_model.grid_sweep(b, w, keep, w, n)
    for row in sweep:
        _phase("schedule_grid_sweep", device=latency_model.H100.name,
               kernel_tile=MFFN_TILE, **row)
    return {"masked_ffn": kernel_launches, "ms": ms}


def backbone_phases(dev, time_ms, bound, nbytes, counters) -> dict:
    """Phase 12: the remaining backbones. ``flash_attention`` and
    ``moments`` against their plain versions at the shapes these families
    give them; then each of phi3.5-moe, arctic, xlstm and qwen2-vl served
    at its published widths (``BB_PHASES``: depth cut, bf16, random
    weights, 4 masks) through ``serve_uncertain`` on the LM traffic, and
    hubert-xlarge's ``forward`` with a posterior per frame, each with its
    launches asserted (``counters`` as for :func:`lm_phases`) and no step
    build or fused fallback in the timed run; then the fp32 prefill-vs-step
    agreement (``BB_AGREE``). Returns the launches by family and the kernel
    records."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core import uncertainty as unc
    from repro_torch.models import model as lm_model, transformer
    from repro_torch.serving import engine, server

    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(7)
    out = {"flash_attention": {}, "moments": {}, "flash_cases": {},
           "moments_cases": {}}

    def memory_mark() -> float:
        """Peak memory counts from here; returns what is held already (the
        earlier phases' tensors), reported beside each phase's peak."""
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 1e9

    def fallbacks() -> int:
        return (sum(server.fallback_counts.values())
                + sum(engine.fallback_counts.values()))

    def expect(tag, got, flash, moments):
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update(flash_attention=flash, moments=moments)
        if got != want:
            raise AssertionError(f"{tag} launches {got}, expected {want}")

    # ---- the kernels at the new shapes -------------------------------------
    for name, dims, causal in (
            ("hubert_full", (LM_MASKS * ENC_CLIPS, 16, 16, ENC_FRAMES, 80),
             False),
            ("phi_prefill", (LM_MASKS * LM_BATCH, 32, 8, LM_PROMPT, 128),
             True),
            ("arctic_prefill", (LM_MASKS * LM_BATCH, 56, 8, LM_PROMPT, 128),
             True),
            ("vl_prefill", (LM_MASKS * LM_BATCH, 64, 8, LM_PROMPT, 128),
             True)):
        rec = flash_case(gen, dev, time_ms, bound, nbytes, name, dims,
                         torch.bfloat16, causal)
        _phase("bb_kernel", name="flash_attention", **rec)
        out["flash_cases"][name] = rec
    for name, shape in (
            ("phi_posterior", (LM_MASKS, LM_BATCH, 32064)),
            ("arctic_posterior", (LM_MASKS, LM_BATCH, 32000)),
            ("xlstm_posterior", (LM_MASKS, LM_BATCH, 50304)),
            ("vl_posterior", (LM_MASKS, LM_BATCH, 152064)),
            ("hubert_posterior", (LM_MASKS, ENC_CLIPS * ENC_FRAMES, 504)),
            ("hubert_posterior_8", (LM_MASKS, 8 * ENC_FRAMES, 504))):
        rec = moments_case(gen, dev, time_ms, bound, nbytes, name, shape,
                           torch.float32)
        _phase("bb_kernel", name="moments", **rec)
        out["moments_cases"][name] = rec
    torch.cuda.empty_cache()

    # ---- the decoder families on the LM traffic ----------------------------
    max_seq = LM_PROMPT + LM_NEW
    for tag, arch, layers in BB_PHASES:
        full = registry.get_config(arch, mask_samples=LM_MASKS)
        cfg = dataclasses.replace(full, n_layers=layers)
        kinds = [k for seg in cfg.segments() for _ in range(seg.reps)
                 for k in seg.pattern]
        n_attn = sum(k in ("attn", "moe") for k in kinds)
        held = memory_mark()
        model = lm_model.build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if cfg.moe_dense_residual and \
                "dense" not in params["segments"][0]["b0"]["moe"]:
            raise AssertionError(f"{arch}: no dense residual FFN")
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=torch.Generator(dev).manual_seed(1),
                                device=dev, dtype=torch.int32)
        fns = server.step_fns(model, device=dev)    # built before the run
        if fns.fused_spec is not None or fns.prefill_spec is not None:
            raise AssertionError(f"{arch} took a fused lowering")
        pool = prompts.repeat(LM_MASKS, 1)
        fns.prefill(params, pool, max_seq=max_seq)          # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        mean, _, caches = fns.prefill(params, pool, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        cache_bytes = nbytes(*_leaves(caches))
        tok = mean.argmax(-1).to(torch.int32).repeat(LM_MASKS)[:, None]
        step_ms = time_ms(lambda: fns.decode(params, caches, tok,
                                             LM_PROMPT), 5)
        for call, fn in (("prefill", lambda: fns.prefill(
                params, pool, max_seq=max_seq)), ("decode_step", lambda:
                fns.decode(params, caches, tok, LM_PROMPT))):
            _phase("backbone_profile", arch=arch, call=call,
                   **call_profile(fn, 1 if call == "prefill" else 3))
        del mean, caches, tok
        builds, fell = _step_builds(), fallbacks()
        _reset_counts(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen_toks, rel, _ = engine.serve_uncertain(
            model, params, prompts, engine.ServeConfig(max_new_tokens=LM_NEW),
            device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = _launch_counts(counters)
        expect(tag, counts, n_attn, 1 + LM_NEW)
        if (_step_builds(), fallbacks()) != (builds, fell):
            raise AssertionError(f"{arch}: a step build or a fused "
                                 f"fallback in the timed run")
        if gen_toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) \
                or not bool(torch.isfinite(rel).all()) \
                or not bool(((gen_toks >= 0)
                             & (gen_toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch} output {tuple(gen_toks.shape)}, "
                                 f"finite {bool(torch.isfinite(rel).all())}")
        loop_ms = 1e3 * (secs - prefill_s) / LM_NEW
        out["flash_attention"][arch] = counts["flash_attention"]
        out["moments"][arch] = counts["moments"]
        _phase(tag, arch=arch, layers=f"{layers}/{full.n_layers}",
               kinds=sorted(set(kinds)), dtype=cfg.dtype,
               params=sum(t.numel() for t in _leaves(params)),
               param_gbytes=nbytes(*_leaves(params)) / 1e9,
               d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
               experts=cfg.n_experts, top_k=cfg.top_k,
               capacity_factor=cfg.capacity_factor, vocab=cfg.vocab_size,
               masks=LM_MASKS, init_s=f"{init_s:.2f}",
               seconds=f"{secs:.4f}", prefill_ms=f"{1e3 * prefill_s:.3f}",
               decode_ms_per_step=f"{loop_ms:.3f}",
               decode_step_ms_events=f"{step_ms:.3f}",
               tokens_per_s=f"{LM_BATCH * LM_NEW / secs:.1f}",
               decode_tokens_per_s=f"{1e3 * LM_BATCH / loop_ms:.1f}",
               cache_mbytes=cache_bytes / 1e6, held_gbytes=held,
               peak_gbytes=torch.cuda.max_memory_allocated() / 1e9,
               rel_unc_mean=float(rel.mean()), launches=counts)
        del gen_toks, rel
        if cfg.m_rope_sections:
            vl_embeds_leg(cfg, params, dev, counters, expect, n_attn)
        del model, params, fns, prompts, pool
        torch.cuda.empty_cache()

    # ---- the encoder: forward over embeddings, a posterior per frame ------
    cfg = registry.get_config(ENC_ARCH, mask_samples=LM_MASKS)
    held = memory_mark()
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    clips = torch.randn((ENC_CLIPS, ENC_FRAMES, cfg.d_model), generator=gen,
                        device=dev).to(cfg.dtype)
    pool = clips.repeat(LM_MASKS, 1, 1)                     # mask-major
    ids = torch.arange(LM_MASKS, device=dev).repeat_interleave(ENC_CLIPS)

    def encode():
        logits, _ = model.forward(params, {"embeds": pool}, mask_ids=ids,
                                  device=dev)
        logp = torch.log_softmax(logits.float(), -1)
        return unc.predictive_moments(
            logp.reshape(LM_MASKS, ENC_CLIPS * ENC_FRAMES, -1))

    encode()                                                # warm
    builds = _step_builds()
    _reset_counts(counters)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mean, std = encode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = _launch_counts(counters)
    expect("backbone_encoder", counts, cfg.n_layers, 1)
    if _step_builds() != builds:
        raise AssertionError("encoder: a step build in the timed run")
    frames = ENC_CLIPS * ENC_FRAMES
    if mean.shape != (frames, cfg.vocab_size) or std.shape != mean.shape \
            or not bool(torch.isfinite(mean).all()) \
            or not bool((std >= 0).all()):
        raise AssertionError(f"encoder posterior {tuple(mean.shape)}")
    fwd_ms = time_ms(encode, 3)
    _phase("backbone_profile", arch=ENC_ARCH, call="forward",
           **call_profile(encode, 2))
    out["flash_attention"][ENC_ARCH] = counts["flash_attention"]
    out["moments"][ENC_ARCH] = counts["moments"]
    _phase("backbone_encoder", arch=ENC_ARCH,
           layers=f"{cfg.n_layers}/{cfg.n_layers}", dtype=cfg.dtype,
           params=sum(t.numel() for t in _leaves(params)),
           param_gbytes=nbytes(*_leaves(params)) / 1e9, d_model=cfg.d_model,
           heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
           d_ff=cfg.d_ff, vocab=cfg.vocab_size, masks=LM_MASKS,
           clips=ENC_CLIPS, frames=ENC_FRAMES, seconds=f"{secs:.4f}",
           forward_ms=f"{fwd_ms:.3f}", decode="none (encoder-only)",
           frames_per_s=f"{1e3 * frames / fwd_ms:.1f}", held_gbytes=held,
           peak_gbytes=torch.cuda.max_memory_allocated() / 1e9,
           rel_std_mean=float(std.mean()), launches=counts)
    del model, params, clips, pool, mean, std
    torch.cuda.empty_cache()

    # ---- fp32 at full width: prefill(s+1) against prefill(s) + a step -----
    for arch, layers in BB_AGREE:
        base = registry.get_config(arch, mask_samples=LM_MASKS)
        over = dict(n_layers=layers, dtype=torch.float32)
        if base.n_experts:          # dropless: no token dropped either way
            over["capacity_factor"] = base.n_experts / base.top_k
        cfg = dataclasses.replace(base, **over)
        n_attn = sum(seg.reps * sum(k in ("attn", "moe") for k in
                                    seg.pattern) for seg in cfg.segments())
        p = transformer.init(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        toks = torch.randint(0, cfg.vocab_size, (LM_MASKS, LM_PROMPT + 1),
                             generator=torch.Generator(dev).manual_seed(5),
                             device=dev, dtype=torch.int32)
        _reset_counts(counters)
        full, _ = transformer.prefill(cfg, p, {"tokens": toks},
                                      max_seq=LM_PROMPT + 1)
        torch.cuda.synchronize()
        full_counts = _launch_counts(counters)
        _, caches = transformer.prefill(cfg, p, {"tokens": toks[:, :-1]},
                                        max_seq=LM_PROMPT + 1)
        _reset_counts(counters)
        step, _ = transformer.decode_step(cfg, p, caches, toks[:, -1:],
                                          LM_PROMPT)
        torch.cuda.synchronize()
        step_counts = _launch_counts(counters)
        expect(f"{arch} agreement prefill", full_counts, n_attn, 0)
        expect(f"{arch} agreement step", step_counts, 0, 0)
        la = torch.log_softmax(full.float(), -1)
        lb = torch.log_softmax(step.float(), -1)
        err = float((la - lb).abs().max())
        if not err <= TOL_HY_PATH:
            raise AssertionError(f"{arch}: prefill vs prefill+step "
                                 f"log-probs differ by {err} > "
                                 f"{TOL_HY_PATH}")
        _phase("backbone_agreement", arch=arch, layers=layers,
               dtype=cfg.dtype, capacity_factor=cfg.capacity_factor,
               rows=LM_MASKS, s=LM_PROMPT, max_abs_err_logp=err,
               tol=TOL_HY_PATH, argmax_equal=bool(torch.equal(
                   la.argmax(-1), lb.argmax(-1))),
               prefill_flash=full_counts["flash_attention"])
        del p, caches, full, step, la, lb
        torch.cuda.empty_cache()
    _phase("backbone_summary", seconds=f"{time.perf_counter() - t_phase:.1f}",
           flash_launches=out["flash_attention"],
           moments_launches=out["moments"])
    return out


def vl_positions(seq: int, grid: int, device):
    """Qwen2-VL's M-RoPE positions [3, seq] for a ``grid x grid`` image
    followed by text: the image's tokens share temporal position 0 and
    walk the grid's rows and columns; the text continues every stream
    from one past the image's largest position."""
    import torch
    n = grid * grid
    i = torch.arange(n, device=device)
    image = torch.stack([torch.zeros_like(i), i // grid, i % grid])
    text = torch.arange(seq - n, device=device) + grid
    return torch.cat([image, text.expand(3, -1)], 1)


def vl_embeds_leg(cfg, params, dev, counters, expect, n_attn) -> None:
    """qwen2-vl's vision-language form: a prefill over embeddings [rows,
    S, D] with M-RoPE positions [3, rows, S] (an image grid, then text)
    and its posterior, then one decode step by tokens at the rows'
    sequence index (the cache slot, as in the reference) to show that the
    cache it leaves decodes. The decode loop itself is the tokens leg's."""
    import torch
    from repro_torch.core import uncertainty as unc
    from repro_torch.models import transformer
    rows = LM_MASKS * LM_BATCH
    emb = torch.randn((rows, LM_PROMPT, cfg.d_model),
                      generator=torch.Generator(dev).manual_seed(2),
                      device=dev).to(cfg.dtype)
    pos = vl_positions(LM_PROMPT, BB_VL_GRID, dev)[:, None].expand(
        3, rows, LM_PROMPT)
    ids = torch.arange(LM_MASKS, device=dev).repeat_interleave(LM_BATCH)
    batch = {"embeds": emb, "positions": pos}

    def prefill():
        logits, caches = transformer.prefill(
            cfg, params, batch, max_seq=LM_PROMPT + 1, mask_ids=ids)
        return unc.token_posterior(logits, LM_MASKS), caches

    prefill()                                               # warm
    _reset_counts(counters)
    torch.cuda.synchronize()
    t = time.perf_counter()
    (mean, rel), caches = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    counts = _launch_counts(counters)
    expect("backbone_vlm embeds", counts, n_attn, 1)
    tok = mean.argmax(-1).to(torch.int32).repeat(LM_MASKS)[:, None]
    step, _ = transformer.decode_step(cfg, params, caches, tok, LM_PROMPT,
                                      mask_ids=ids)
    if not bool(torch.isfinite(rel).all()) \
            or not bool(torch.isfinite(step).all()):
        raise AssertionError("qwen2-vl embeds leg: non-finite output")
    _phase("backbone_vlm", leg="embeds", rows=rows, grid=BB_VL_GRID,
           positions=list(pos.shape), prefill_ms=f"{1e3 * prefill_s:.3f}",
           peak_gbytes=torch.cuda.max_memory_allocated() / 1e9,
           rel_unc_mean=float(rel.mean()), launches=counts)


def pricing_phase(srv: dict, decode_rec: dict, ivim: dict) -> None:
    """Phase 11: the H100 latency model beside what the card measured —
    ``decode_modeled_latency`` for the server's pool (fused and per-op)
    beside the fused_decode kernel and the fused step, ``PackedPlan.
    modeled_latency(fused=True)`` beside the fused IVIM chunk, and the
    ``model_fidelity`` blocks of the server run (unit token) and the fused
    IVIM slab (unit voxel), one JSON object a line after its tag. The ratio
    is reported, not gated: the model prices the card, not the host."""
    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.obs import crosscheck

    cfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS)
    spec = plan_lib.lower_fused_decode(cfg)
    rows, max_seq = SRV_SLOTS * LM_MASKS, LM_PROMPT + LM_NEW
    _phase("pricing", path="decode_step", rows=rows, max_seq=max_seq,
           modeled_fused_ms=1e3 * plan_lib.decode_modeled_latency(
               spec, rows, max_seq),
           modeled_per_op_ms=1e3 * plan_lib.decode_modeled_latency(
               spec, rows, max_seq, fused=False),
           kernel_ms=decode_rec["ms"],
           fused_step_ms=decode_rec["fused_step_ms"],
           server_kernel_ms=srv["shapes"][SRV_SLOTS]["ms"],
           server_ms_per_step=srv["ms_per_step"])
    plan = ivim["plan"]
    _phase("pricing", path="ivim_chunk", voxels=CHUNK,
           modeled_fused_ms=1e3 * plan.modeled_latency(CHUNK, fused=True,
                                                       bytes_per_el=4),
           kernel_ms=ivim["kernel_ms"],
           leg_ms_per_chunk=1e3 * ivim["seconds"] / ivim["chunks"])
    blocks = {
        "token": crosscheck.model_fidelity(
            measured_wall_s=srv["seconds"], n_units=srv["lm_tokens"],
            step_traffic=plan_lib.decode_traffic(spec, rows, max_seq),
            units_per_step=SRV_SLOTS, unit="token",
            stages=plan_lib.decode_stage_traffic(spec, rows, max_seq)),
        "voxel": crosscheck.model_fidelity(
            measured_wall_s=ivim["seconds"], n_units=ivim["voxels"],
            step_traffic=plan.traffic(CHUNK, 4, fused=True, moments=True),
            units_per_step=CHUNK, unit="voxel")}
    for unit, block in blocks.items():
        print(f"[pricing] model_fidelity_{unit}= {json.dumps(block)}",
              flush=True)


def moments_case(gen, dev, time_ms, bound, nbytes, name, shape,
                 dt) -> dict:
    """The moments kernel against its plain version and ``torch.std_mean``
    (the one PyTorch call that computes the same function:
    ``library_ms``) on random samples of ``shape`` in ``dt``, with the
    profiler's device times; raises beyond the reference's bar (bf16: one
    bf16 ulp). Returns the record."""
    import torch
    from repro_torch.kernels.moments import ops as mo_ops
    from repro_torch.kernels.moments import ref as mo_ref
    x = torch.randn(shape, generator=gen, device=dev).to(dt)
    got, want = mo_ops.moments(x), mo_ref.moments_ref(x)
    torch.cuda.synchronize()
    if dt == torch.bfloat16:            # one bf16 ulp of the plain value
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            ulp = (w.abs().clamp_min(1e-30).log2().floor() - 7).exp2()
            if not bool(((g - w).abs() <= ulp).all()):
                raise AssertionError(f"moments {name}: beyond one bf16 "
                                     f"ulp, {float((g - w).abs().max())}")
    else:
        torch.testing.assert_close(got[0], want[0], **TOL_MO_MEAN)
        torch.testing.assert_close(got[1], want[1], **TOL_MO_STD)
    lib_std, lib_mean = torch.std_mean(x, dim=0, correction=0)

    def lib(x=x):
        return torch.std_mean(x, dim=0, correction=0)

    rec = {"shape": name, "dims": list(shape), "dtype": dt,
           "register_bucket": mo_ops.register_bucket(shape[0]),
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           "library_max_abs_err": max(
               float((g.float() - w.float()).abs().max())
               for g, w in zip((lib_mean, lib_std), want)),
           "ms": time_ms(lambda: mo_ops.moments(x)),
           "plain_ms": time_ms(lambda: mo_ref.moments_ref(x)),
           "library_ms": time_ms(lib),
           "device_ms": device_ms(lambda: mo_ops.moments(x)),
           "library_device_ms": device_ms(lib)}
    # about 4 flops a sample (sum, center, square-add); inputs read
    # once, the two outputs written once
    rec["bound_ms"], rec["bound_by"] = bound(4 * x.numel(),
                                             nbytes(x, *got))
    return rec


def moments_phase(dev, time_ms, bound, nbytes) -> dict:
    """Phase 2b: the moments kernel against its plain version and against
    ``torch.std_mean`` (the one PyTorch call that computes the same
    function: ``library_ms``) at the shapes its callers give it. Returns
    the records by shape."""
    import torch
    from repro_torch.kernels.moments import ops as mo_ops

    gen = torch.Generator(dev).manual_seed(6)
    recs = {}
    for name, shape, dt in (
            ("main", (8, CHUNK, 4), torch.float32),     # per-op IVIM chunk
            ("qwen2_posterior", (4, LM_BATCH, 151936), torch.float32),
            ("rg_posterior", (4, LM_BATCH, 256000), torch.float32),
            ("long", (64, 65536, 4), torch.float32),    # the reference's N cap
            ("n16", (16, 65536, 4), torch.float32),     # register bucket 16
            ("n24", (24, 65536, 4), torch.float32),     # bucket 32, 8 idle
            ("n33", (33, 65536, 4), torch.float32),     # bucket 64, 31 idle
            ("n65", (65, 65536, 4), torch.float32),     # past 64: the reread
            ("ragged", (3, 4097, 5), torch.float32),
            ("bf16", (8, CHUNK, 4), torch.bfloat16)):
        rec = moments_case(gen, dev, time_ms, bound, nbytes, name, shape,
                           dt)
        _phase("moments_kernel", **rec)
        recs[name] = rec
    for value in (1.0, -0.375):             # a constant: std exactly 0
        mean, std = mo_ops.moments(torch.full((8, CHUNK, 4), value,
                                              device=dev))
        if not (bool((std == 0).all()) and bool((mean == value).all())):
            raise AssertionError(f"moments of the constant {value}: std "
                                 f"{float(std.abs().max())}")
    # predictive_moments: fp16 widened to the fp32 kernel and cast back,
    # empty inputs answered without a launch, as on the CPU
    from repro_torch.core import uncertainty as unc
    x16 = torch.randn((8, 33, 4), generator=gen, device=dev).half()
    for shape, x in (("fp16", x16), ("empty_samples", x16[:0]),
                     ("empty_rest", x16[:, :, :0])):
        before = mo_ops.moments.launches
        got = unc.predictive_moments(x)
        launched = mo_ops.moments.launches - before
        want = unc.predictive_moments(x.cpu())
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.allclose(
                    g.cpu().float(), w.float(), rtol=2.0 ** -10, atol=0,
                    equal_nan=True):
                raise AssertionError(f"predictive_moments {shape} on the "
                                     f"card: {g.dtype} {tuple(g.shape)}")
        if launched != (0 if x.numel() == 0 else 1):
            raise AssertionError(f"predictive_moments {shape}: {launched} "
                                 f"launches")
        _phase("moments_kernel", shape=f"predictive_{shape}",
               dims=list(x.shape), out_dims=list(got[0].shape),
               dtype=got[0].dtype, launches=launched, matches_cpu=True)
    tiny = torch.ones((1, 1, 1), device=dev)     # one element: the fill
    _phase("moments_kernel", shape="constant", std_exactly_zero=True,
           one_element_ms=time_ms(lambda: mo_ops.moments(tiny), 200),
           one_element_device_ms=device_ms(lambda: mo_ops.moments(tiny),
                                           50))
    torch.cuda.empty_cache()
    return recs


def host_path_phase(dev) -> dict:
    """Phase 1b: the wrappers' host path, part by part, on the one-element
    ``moments`` call and the ``rg_prefill`` flash call: each part (and the
    whole wrapper) timed with ``time.perf_counter`` over HOST_CALLS calls,
    in batches of 100 with a synchronize between batches (outside the
    clock, so the launch queue never fills). "before" is the wrapper as it
    was (C signature set every call, device context entered every call,
    two output allocations for ``moments``), rebuilt here on its own handle
    of the library; "after" is the wrapper the port ships. Returns the
    microseconds by call and part."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moments import ops as mo_ops

    def host_us(fn, batch: int = 100) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(HOST_CALLS // batch):
            t = time.perf_counter()
            for _ in range(batch):
                fn()
            total += time.perf_counter() - t
            torch.cuda.synchronize()
        return 1e6 * total / HOST_CALLS

    def enter(ctx):
        with ctx:
            pass

    stream = _build.stream_of(dev)
    out = {}
    x = torch.ones((1, 1, 1), device=dev)
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for shape in ((32, 10, LM_PROMPT, 256),
                                                  (32, 1, LM_PROMPT, 256),
                                                  (32, 1, LM_PROMPT, 256)))
    o = torch.empty_like(q)
    sqrt_dh = math.sqrt(256)
    cases = {
        "moments": ("moments", "moments_f32_launch", mo_ops._ARGTYPES,
                    {"samples": x}, lambda: x.new_empty((2, 1, 1)).unbind(),
                    lambda: (torch.empty((1, 1), device=dev),
                             torch.empty((1, 1), device=dev)),
                    (x.data_ptr(), o.data_ptr(), o.data_ptr() + 4, 1, 1, 8),
                    lambda: mo_ops.moments(x)),
        "flash_rg_prefill": (
            "flash_attention", "flash_attention_bf16_launch",
            fa_ops._ARGTYPES, {"q": q, "k": k, "v": v},
            lambda: torch.empty_like(q), lambda: torch.empty_like(q),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 32, 10,
             1, LM_PROMPT, LM_PROMPT, 256, sqrt_dh, 1),
            lambda: fa_ops.flash_attention(q, k, v, causal=True))}
    for name, (lib_name, entry, argtypes, operands, alloc_after,
               alloc_before, args, wrapper) in cases.items():
        bound = _build.bind(lib_name, entry, argtypes)
        lib = _build.load(lib_name)
        old_fn = getattr(type(lib)(lib._name), entry)   # its own handle
        dtypes = {n: t.dtype for n, t in operands.items()}

        def set_argtypes(fn=old_fn, argtypes=argtypes):
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def before(fn=old_fn, argtypes=argtypes, operands=operands,
                   dtypes=dtypes, alloc=alloc_before, args=args):
            d = _build.check_operands(lib_name, dtypes, **operands)
            alloc()
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            with torch.cuda.device(d):
                err = fn(*args, ctypes.c_void_p(
                    torch.cuda.current_stream(d).cuda_stream))
            _build.check_launch(lib_name, err)

        parts = {
            "check_operands": lambda: _build.check_operands(
                lib_name, dtypes, **operands),
            "alloc_before": alloc_before, "alloc_after": alloc_after,
            "stream_before": lambda: ctypes.c_void_p(
                torch.cuda.current_stream(dev).cuda_stream),
            "stream_of": lambda: _build.stream_of(dev),
            "device_context": lambda: enter(torch.cuda.device(dev)),
            "device_guard": lambda: enter(_build.on_device(dev)),
            "set_argtypes": set_argtypes,
            "bind": lambda: _build.bind(lib_name, entry, argtypes),
            "ctypes_call": lambda: bound(*args, stream),
            "wrapper_before": before, "wrapper_after": wrapper}
        rec = {f"{part}_us": host_us(fn) for part, fn in parts.items()}
        _phase("host_path", call=name, calls=HOST_CALLS, **{
            k: round(v, 3) for k, v in rec.items()})
        out[name] = rec
    del q, k, v, o
    torch.cuda.empty_cache()
    return out


def flow_phases(dev, time_ms, counters) -> dict:
    """Phases 3b-3d, the paper's design flow on the card: train uIVIM-NET
    at the serving width, evaluate it over the SNR sweep against the
    Phase-2 requirements, then the Phase-3 plans — the trained model packed
    and served per-op and fused, and ``transform.plan_hardware`` on the
    reference test's MLP with its H100-modeled latency beside the measured
    one. ``counters``: masked_ffn, samples, moments (fused_plan), moments
    (the moments kernel). Returns what the kernels line reports."""
    import torch
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import transform
    from repro_torch.ivim import data as ivim_data
    from repro_torch.ivim import evaluate as ivim_eval
    from repro_torch.ivim import model as ivim_model
    from repro_torch.ivim import physics
    from repro_torch.ivim import train as ivim_train
    from repro_torch.serving import engine

    def reset():
        for ctr in counters:
            ctr.launches = 0

    def launches():
        return tuple(ctr.launches for ctr in counters)

    cfg = ivim_model.IvimConfig(b_values=physics.DENSE_B_VALUES, n_masks=8,
                                scale=2.0)
    tcfg = ivim_train.TrainConfig(steps=FLOW_STEPS, batch_size=FLOW_BATCH,
                                  lr=FLOW_LR, seed=0)

    # ---- one step from identical parameters, card vs the CPU's plain tier
    ds = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        b_values=cfg.b_values, seed=0), device=dev)
    x = ivim_data.Batcher(ds, FLOW_BATCH, seed=0).batch(0)
    models, losses = {}, {}
    for d in ("cpu", dev):
        m = ivim_model.init(cfg, torch.Generator().manual_seed(0), device=d)
        step, init_opt = ivim_train.make_train_step(cfg, tcfg)
        losses[str(d)] = step(m, init_opt(m), x.to(d)).item()
        models[str(d)] = m
    diff = null_diff = 0.0
    for (name, p), q in zip(models["cpu"].named_parameters(),
                            models[str(dev)].parameters()):
        err = (q.detach().cpu() - p.detach()).abs()
        if name in TRAIN_NULL:
            null_diff = max(null_diff, float(err[TRAIN_NULL[name]].max()))
            err[TRAIN_NULL[name]] = 0.0
        diff = max(diff, float(err.max()))
    loss_rel = abs(losses[str(dev)] - losses["cpu"]) / losses["cpu"]
    if diff > TOL_TRAIN_STEP or null_diff > 2 * FLOW_LR \
            or loss_rel > TOL_TRAIN_STEP:
        raise AssertionError(f"one train step, card vs CPU: parameters "
                             f"{diff}, BN-null directions {null_diff}, loss "
                             f"{loss_rel}")
    _phase("flow_train_step", width=cfg.width, masks=cfg.n_masks,
           max_abs_param_diff=diff, tol=TOL_TRAIN_STEP,
           bn_null_max_abs_diff=null_diff, null_tol=2 * FLOW_LR,
           loss_rel_diff=loss_rel)
    del models, ds, x

    # ---- phase 3b: train --------------------------------------------------
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, hist = ivim_train.train(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    first, last = sum(hist[:10]) / 10, sum(hist[-10:]) / 10
    if len(hist) != FLOW_STEPS or not all(map(math.isfinite, hist)) \
            or not last < 0.8 * first:      # the reference's training bar
        raise AssertionError(f"training: {len(hist)} steps, first 10 "
                             f"{first}, last 10 {last}")
    if launches() != (0, 0, 0, 0):
        raise AssertionError(f"training launched kernels {launches()}")
    _phase("flow_train", width=cfg.width, masks=cfg.n_masks,
           scale=cfg.scale, steps=FLOW_STEPS, batch=FLOW_BATCH, lr=FLOW_LR,
           seconds=f"{train_s:.3f}",
           ms_per_step=f"{1e3 * train_s / FLOW_STEPS:.3f}",
           loss_first=hist[0], loss_last=hist[-1], mean_first_10=first,
           mean_last_10=last)

    # ---- phase 3c: the SNR sweep ------------------------------------------
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = ivim_eval.evaluate_snr_sweep(model, n_voxels=FLOW_SNR_VOXELS,
                                           device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    sweep_launches = launches()
    n_snr = len(ivim_data.SNR_LEVELS)
    if sweep_launches != (0, 0, 0, n_snr):
        raise AssertionError(f"SNR sweep launches (masked_ffn, samples, "
                             f"fused moments, moments) = {sweep_launches}, "
                             f"expected {(0, 0, 0, n_snr)}")
    for snr, r in sorted(results.items()):
        unc = sum(r["rel_unc"].values()) / len(r["rel_unc"])
        _phase("flow_eval", snr=snr, voxels=FLOW_SNR_VOXELS,
               rmse_recon=r["rmse_recon"], mean_rel_unc=unc,
               rmse_params=r["rmse_params"], rel_unc=r["rel_unc"])
    report = ivim_eval.requirement_report(results)
    lo, hi = min(results), max(results)
    unc_lo, unc_hi = (sum(results[s]["rel_unc"].values()) for s in (lo, hi))
    if not (results[lo]["rmse_recon"] > results[hi]["rmse_recon"]
            and unc_lo > unc_hi):           # tests/test_system.py's trend
        raise AssertionError(f"SNR {lo} not worse than SNR {hi}: "
                             f"{report.rmse_by_snr}, "
                             f"{report.uncertainty_by_snr}")
    _phase("flow_eval", seconds=f"{sweep_s:.4f}", launches=sweep_launches,
           requirements_satisfied=report.satisfied,
           failures=list(report.failures))

    # ---- phase 3d: the Phase-3 plans --------------------------------------
    plan = ivim_model.pack_for_serving(model)
    xs = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        n_voxels=CHUNK, snr=20.0, b_values=cfg.b_values, seed=99),
        device=dev)["signals"]
    want = ivim_model.predict(model, xs)
    for fused, expect in ((False, (1, 0, 0, 1)), (True, (0, 0, 1, 0))):
        reset()
        got = engine.predict_packed(plan, xs, fused=fused, device=dev)
        torch.cuda.synchronize()
        if launches() != expect:
            raise AssertionError(f"trained plan fused={fused} launches "
                                 f"{launches()}, expected {expect}")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=TOL_MOMENTS,
                                       atol=TOL_MOMENTS)
        _phase("flow_plan", model="trained uIVIM-NET",
               leg="fused" if fused else "per_op", voxels=CHUNK,
               max_abs_err=max(float((g - w).abs().max())
                               for g, w in zip(got, want)),
               launches=launches())

    mlp = transform.convert(transform.MlpSpec(MLP_WIDTHS, MLP_DROPOUT), 4,
                            2.0, torch.Generator(dev).manual_seed(0),
                            device=dev)
    hp = transform.plan_hardware(mlp, batch=MLP_BATCH)
    xm = torch.randn((MLP_BATCH, MLP_WIDTHS[0]),
                     generator=torch.Generator(dev).manual_seed(1),
                     device=dev)
    reset()
    got = plan_lib.execute(hp.plan, xm, device=dev)
    torch.cuda.synchronize()
    mlp_launches = launches()
    want = mlp.apply_all_samples(mlp.params, xm)
    torch.testing.assert_close(got, want, rtol=TOL_SAMPLES, atol=TOL_SAMPLES)
    fused = plan_lib.fused_executor(hp.plan, moments=True, device=dev)
    _phase("flow_plan", model="MlpSpec", widths=list(MLP_WIDTHS),
           dropout_after=list(MLP_DROPOUT), masks=4, batch=MLP_BATCH,
           ops=[type(op).__name__ for op in hp.plan.ops],
           max_abs_err=float((got - want).abs().max()),
           launches=mlp_launches, schedule=hp.schedule.kind,
           weight_loads=hp.traffic.weight_loads,
           modeled_ms=1e3 * hp.modeled_latency_s,
           modeled_baseline_ms=1e3 * hp.modeled_baseline_s,
           modeled_speedup=hp.modeled_speedup,
           measured_per_op_ms=time_ms(
               lambda: plan_lib.execute(hp.plan, xm, device=dev)),
           modeled_fused_moments_ms=1e3 * hp.plan.modeled_latency(
               MLP_BATCH, fused=True),
           measured_fused_moments_ms=time_ms(lambda: fused(xm)))
    if not (hp.modeled_speedup > 1 and hp.schedule.kind == "batch"
            and hp.traffic.weight_loads == 4):
        raise AssertionError(f"plan_hardware: speedup {hp.modeled_speedup}, "
                             f"schedule {hp.schedule.kind}, loads "
                             f"{hp.traffic.weight_loads}")
    del model, plan
    torch.cuda.empty_cache()
    return {"eval_launches": sweep_launches[3], "train_s": train_s,
            "sweep_s": sweep_s}

def _train_flops(cfg, params, b: int, s: int) -> dict:
    """Model FLOPs of one step: 6 x parameters x tokens plus attention
    (the reference's masked full products, 4 B H S^2 dh a layer forward,
    three times that with the backward), and apart the remat recompute:
    each repeat's forward again, the chunked attention's chunks a third
    time. Masks are not parameters here, and neither is the input
    embedding table where an ``unembed`` head exists (a gather, no
    product): the head counts once, as ``unembed`` or as the tied
    table."""
    from repro_torch.core import tree as tree_lib
    untied = "unembed" in params["embed"]
    n_all = sum(t.numel() for p, t in tree_lib.flatten_with_path(params)
                if "masks" not in p
                and not (untied and p == ("embed", "embed")))
    n_seg = sum(t.numel() for p, t in tree_lib.flatten_with_path(
        params["segments"]) if "masks" not in p)
    kinds = [k for seg in cfg.segments() for _ in range(seg.reps)
             for k in seg.pattern]
    n_attn = sum(k in ("attn", "local_attn", "moe") for k in kinds)
    attn_fwd = 4 * b * cfg.n_heads * s * s * cfg.resolved_head_dim * n_attn
    chunked = s > cfg.attn_chunk and s % cfg.attn_chunk == 0
    tokens = b * s
    return {"params": n_all, "model": 6 * n_all * tokens + 3 * attn_fwd,
            "recompute": ((2 * n_seg * tokens + attn_fwd)
                          if cfg.remat != "none" else 0)
            + (attn_fwd if chunked else 0)}


def train_phases(dev, time_ms, bound, counters) -> dict:
    """Phases 13-17: LM training on the card. ``[train]``: qwen2-1.5b at
    published widths and full depth through ``make_train_step`` (AdamW, a
    grad_accum 2 + int8 EF leg, Adafactor), with ms a step, tokens/s, peak
    memory, first and last loss and the model-FLOPs share; no flash,
    moments or fused_decode launch. ``[train_resume]``: a ``Trainer`` cut
    at step 6 and resumed to 9 against an uninterrupted run.
    ``[train_agreement]``: one fp32 step on the card against the CPU.
    ``[train_hybrid]``: recurrentgemma-2b with the scan's launches a step
    asserted. ``[train_kernel]``: the scan's backward kernel against
    autograd through the plain version. ``counters`` in ``KERNEL_NAMES``
    order. Returns the launches of the training runs by kernel and the
    backward kernel's records."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import registry
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.kernels.rglru_scan import ref as sc_ref
    from repro_torch.models import model as lm_model
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.train import (TrainConfig, Trainer, make_train_step,
                                   train_state_init)

    t_phases = time.perf_counter()
    totals = dict.fromkeys(KERNEL_NAMES, 0)
    backward_total = 0

    def add_counts():
        nonlocal backward_total
        for name, n in _launch_counts(counters).items():
            totals[name] += n
        backward_total += sc_ops.rglru_scan.backward_launches

    def reset():
        _reset_counts(counters)
        sc_ops.rglru_scan.backward_launches = 0

    def leg(cfg, name, steps, accum, compress, b, s, lr=TRAIN_OPT["lr"],
            check=None, profile=False):
        """``steps`` train steps from a fresh seed-0 state: losses, step
        times, peak memory, launches (``check(step, counts)`` after each
        step); with ``profile``, then one step's parts (forward + backward,
        the optimizer's update, on CUDA events) and one step under the
        profiler."""
        model = lm_model.build_model(cfg)
        opt = build_optimizer(OptimizerConfig(name=name,
                                              **{**TRAIN_OPT, "lr": lr}))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train_state_init(model, opt,
                                 torch.Generator(dev).manual_seed(0),
                                 compress, device=dev)
        step_fn = make_train_step(model, opt, TrainConfig(
            grad_accum=accum, compress_grads=compress))
        data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                            global_batch=b)
        flops = _train_flops(cfg, state["params"], b, s)
        losses, secs, gnorms = [], [], []
        for step in range(steps):
            batch = lm_batch(data, step, dev)
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            add_counts()
            if check:
                check(step, _launch_counts(counters))
            losses.append(loss)
            gnorms.append(float(metrics["gnorm"]))
            if not math.isfinite(loss):
                raise AssertionError(f"{cfg.arch_id} {name} step {step}: "
                                     f"loss {loss}")
        step_s = statistics.median(secs[TRAIN_WARM:] or secs)
        rec = {"steps": steps, "grad_accum": accum, "compress": compress,
               "ms_per_step": 1e3 * step_s,
               "tokens_per_s": b * s / step_s,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss_first": losses[0], "loss_last": losses[-1],
               "gnorm_first": gnorms[0], "gnorm_last": gnorms[-1],
               "params": flops["params"],
               "model_tflop_per_step": flops["model"] / 1e12,
               "recompute_tflop_per_step": flops["recompute"] / 1e12,
               "model_flops_share": flops["model"] / (step_s * BF16_PEAK),
               "flops_share_with_recompute": (
                   (flops["model"] + flops["recompute"])
                   / (step_s * BF16_PEAK)),
               "first_step_s": secs[0]}
        if profile:
            batch = lm_batch(data, steps, dev)
            params = state["params"]
            leaves = tree_lib.leaves(params)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            ev[1].record()
            opt.update(tree_lib.unflatten(params, list(grads)), state["opt"],
                       params)
            ev[2].record()
            ev[2].synchronize()
            del loss, grads
            rec["forward_backward_ms"] = ev[0].elapsed_time(ev[1])
            rec["optimizer_ms"] = ev[1].elapsed_time(ev[2])
            rec["profile"] = call_profile(
                lambda: step_fn(state, batch), reps=1)
        del state
        torch.cuda.empty_cache()
        return rec, losses

    # ---- [train]: qwen2-1.5b, all 28 layers -------------------------------
    cfg = registry.get_config(TRAIN_ARCH, mask_samples=LM_MASKS,
                              remat="full")
    if cfg.n_layers != 28 or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"{TRAIN_ARCH}: {cfg.n_layers} layers, "
                             f"{cfg.dtype}")
    train = {}
    for tag, name, steps, accum, compress, lr in TRAIN_LEGS:
        before = dict(totals)
        rec, losses = leg(cfg, name, steps, accum, compress, TRAIN_B,
                          TRAIN_S, lr=lr, profile=tag == "adamw")
        prof = rec.pop("profile", None)
        if prof:
            _phase("train_profile", arch=TRAIN_ARCH, leg=tag, **{
                k: rec[k] for k in ("forward_backward_ms", "optimizer_ms")},
                **prof)
        counts = {k: totals[k] - before[k] for k in KERNEL_NAMES}
        _phase("train", arch=TRAIN_ARCH, leg=tag, optimizer=name, lr=lr,
               layers=cfg.n_layers, dtype=cfg.dtype, batch=TRAIN_B,
               seq=TRAIN_S, remat=cfg.remat, launches=counts,
               losses=[round(x, 4) for x in losses], **rec)
        if any(counts.values()):
            raise AssertionError(f"[train] {tag}: kernel launches {counts}; "
                                 f"training takes none of them")
        if tag == "adamw" and not statistics.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"[train] {tag}: the loss did not fall "
                                 f"({losses})")
        train[tag] = rec

    # ---- [train_resume]: a Trainer cut and resumed -------------------------
    rcfg = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    model = lm_model.build_model(rcfg)
    opt = build_optimizer(OptimizerConfig(name="adamw", **TRAIN_OPT))
    data = LMDataConfig(vocab_size=rcfg.vocab_size, seq_len=TRAIN_S,
                        global_batch=TRAIN_B)
    cut, total = TRAIN_RESUME_STEPS
    reset()
    _, whole = Trainer(model, opt, TrainConfig(steps=total), data,
                       device=dev).run()
    with tempfile.TemporaryDirectory() as d:
        kw = dict(checkpoint_dir=d, checkpoint_every=TRAIN_RESUME_EVERY)
        _, first = Trainer(model, opt, TrainConfig(steps=cut, **kw), data,
                           device=dev).run()
        t0 = time.perf_counter()
        again = Trainer(model, opt, TrainConfig(steps=total, **kw), data,
                        device=dev)
        start, state = again.init_or_restore()
        restore_s = time.perf_counter() - t0
        if start != cut:
            raise AssertionError(f"[train_resume] restored step {start}, "
                                 f"expected {cut}")
        del state
        state, rest = again.run()
        t0 = time.perf_counter()
        path = ckpt_lib.save_checkpoint(d, 10 ** 6, state)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                         if f.is_file())
    add_counts()
    got = [h["loss"] for h in first + rest]
    want = [h["loss"] for h in whole]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if len(got) != total or not rel <= TOL_RESUME:
        raise AssertionError(f"[train_resume] resumed losses {got} against "
                             f"{want} (rel {rel:.3g} > {TOL_RESUME})")
    _phase("train_resume", arch=TRAIN_ARCH, layers=rcfg.n_layers,
           steps=f"{cut}+{total - cut}", every=TRAIN_RESUME_EVERY,
           losses_resumed=[round(x, 5) for x in got],
           losses_whole=[round(x, 5) for x in want], max_rel=rel,
           bitwise=got == want, checkpoint_gb=ckpt_bytes / 1e9,
           checkpoint_write_s=f"{write_s:.2f}",
           restore_s=f"{restore_s:.2f}")
    del state
    torch.cuda.empty_cache()

    # ---- [train_agreement]: one fp32 step, card against CPU ---------------
    acfg = dataclasses.replace(cfg, n_layers=TRAIN_AGREE_LAYERS,
                               dtype=torch.float32)
    model = lm_model.build_model(acfg)
    opt = build_optimizer(OptimizerConfig(name="adamw", **TRAIN_OPT))
    step_fn = make_train_step(model, opt, TrainConfig())
    cpu_state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    card_state = tree_lib.tree_map(lambda t: t.to(dev, copy=True), cpu_state)
    data = LMDataConfig(vocab_size=acfg.vocab_size, seq_len=TRAIN_AGREE_S,
                        global_batch=TRAIN_AGREE_B)
    reset()
    card_state, card_m = step_fn(card_state, lm_batch(data, 0, dev))
    add_counts()
    cpu_state, cpu_m = step_fn(cpu_state, lm_batch(data, 0, "cpu"))
    errs = {k: abs(float(card_m[k]) - float(cpu_m[k])) / abs(float(cpu_m[k]))
            for k in ("loss", "gnorm")}
    lr1 = float(opt.cfg.lr * min(1, 1 / max(opt.cfg.warmup_steps, 1)))
    grad_rel, grad_at, worst, use = 0.0, None, 0.0, 0.0
    for (path, p_card), p_cpu, mu_card, mu_cpu in zip(
            tree_lib.flatten_with_path(card_state["params"]),
            tree_lib.leaves(cpu_state["params"]),
            tree_lib.leaves(card_state["opt"]["mu"]),
            tree_lib.leaves(cpu_state["opt"]["mu"])):
        # mu after one step is 0.1 x the clipped gradient
        g_card, g_cpu = mu_card.cpu() / 0.1, mu_cpu / 0.1
        scale = float(g_cpu.abs().max())
        if scale > 0:
            r = float((g_card - g_cpu).abs().max()) / scale
            if r > grad_rel:
                grad_rel, grad_at = r, path
        p_card, p_cpu = p_card.detach().cpu(), p_cpu.detach()
        diff = (p_card - p_cpu).abs()
        room = (lr1 * torch.clamp(
            2 * TOL_TRAIN_AGREE["grad"] * scale
            / (torch.maximum(g_card.abs(), g_cpu.abs()) + opt.cfg.eps),
            max=2.0)
            + 2.0 ** -22 * torch.maximum(p_card.abs(), p_cpu.abs()))
        worst = max(worst, float(diff.max()))
        use = max(use, float((diff / room).max()))
    if (errs["loss"] > TOL_TRAIN_AGREE["loss"]
            or errs["gnorm"] > TOL_TRAIN_AGREE["gnorm"]
            or grad_rel > TOL_TRAIN_AGREE["grad"] or use > 1):
        raise AssertionError(f"[train_agreement] card vs CPU: {errs}, "
                             f"gradient {grad_rel:.3g} at {grad_at}, "
                             f"params {worst:.3g} at {use:.3g} of their "
                             f"bound (lr {lr1})")
    _phase("train_agreement", arch=TRAIN_ARCH, layers=acfg.n_layers,
           dtype=acfg.dtype, batch=TRAIN_AGREE_B, seq=TRAIN_AGREE_S,
           loss_card=float(card_m["loss"]), loss_cpu=float(cpu_m["loss"]),
           loss_rel=errs["loss"], gnorm_card=float(card_m["gnorm"]),
           gnorm_cpu=float(cpu_m["gnorm"]), gnorm_rel=errs["gnorm"],
           grad_rel=grad_rel, grad_worst_leaf=grad_at,
           params_max_abs=worst, params_lr_share=worst / lr1,
           params_bound_use=use)
    del card_state, cpu_state
    torch.cuda.empty_cache()

    # ---- [train_hybrid]: recurrentgemma-2b, the scan's backward ------------
    hcfg = registry.get_config(HY_ARCH, mask_samples=LM_MASKS,
                               n_layers=TRAIN_HY_LAYERS, remat="full")
    kinds = [k for seg in hcfg.segments() for _ in range(seg.reps)
             for k in seg.pattern]
    if kinds != ["rec", "rec", "local_attn"]:
        raise AssertionError(f"{HY_ARCH} at {TRAIN_HY_LAYERS} layers: "
                             f"{kinds}")

    def scan_launches(step, counts):
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["rglru_scan"] = TRAIN_HY_SCAN_LAUNCHES
        back = sc_ops.rglru_scan.backward_launches
        if counts != want or back != TRAIN_HY_SCAN_BACKWARD:
            raise AssertionError(f"[train_hybrid] step {step}: launches "
                                 f"{counts}, backward {back}; expected "
                                 f"{want}, backward "
                                 f"{TRAIN_HY_SCAN_BACKWARD}")

    hy, losses = leg(hcfg, "adamw", TRAIN_HY_STEPS, 1, False, TRAIN_HY_B,
                     TRAIN_HY_S, check=scan_launches)
    _phase("train_hybrid", arch=HY_ARCH, layers=kinds, dtype=hcfg.dtype,
           batch=TRAIN_HY_B, seq=TRAIN_HY_S, remat=hcfg.remat,
           scan_launches_per_step=TRAIN_HY_SCAN_LAUNCHES,
           scan_backward_per_step=TRAIN_HY_SCAN_BACKWARD,
           losses=[round(x, 4) for x in losses], **hy)

    scan_bwd_gates_phase(dev, time_ms, "after training")

    # ---- [train_kernel]: the backward kernel against plain autograd -------
    gen = torch.Generator(dev).manual_seed(5)
    kernel = {}
    for name, shape in TRAIN_KERNEL_SHAPES:
        lam = 0.9 + 0.099 * torch.rand(shape[-1], generator=gen, device=dev)
        a = lam ** (8 * torch.rand(shape, generator=gen, device=dev))
        b = torch.randn(shape, generator=gen, device=dev) \
            * torch.sqrt(1 - a * a)
        g = torch.randn(shape, generator=gen, device=dev)
        ka, kb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        pa, pb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        reset()
        k_da, k_db = torch.autograd.grad(sc_ops.RGLRUScan.apply(ka, kb),
                                         (ka, kb), g)
        if sc_ops.rglru_scan.backward_launches != 1:
            raise AssertionError("[train_kernel] the Function's backward did "
                                 "not launch the kernel")
        p_da, p_db = torch.autograd.grad(sc_ref.rglru_scan_ref(pa, pb),
                                         (pa, pb), g)
        err = max(float((k - p).abs().max() / p.abs().max())
                  for k, p in ((k_da, p_da), (k_db, p_db)))
        if not err <= TOL_SCAN_BWD_REL:
            raise AssertionError(f"[train_kernel] {name}: backward error "
                                 f"{err:.3g} of the magnitude")
        h = sc_ops.rglru_scan(a, b)
        if name == "long" and not all(
                torch.equal(x, y) for x, y in zip(
                    sc_ops.rglru_scan_backward(a, h, g),
                    sc_ops.rglru_scan_backward(a, h, g))):
            raise AssertionError("[train_kernel] rglru_scan_backward: two "
                                 "launches at the long shape differ")
        rec = {"shape": name, "dims": list(shape), "rel_err": err,
               "max_abs_err": max(float((k - p).abs().max())
                                  for k, p in ((k_da, p_da), (k_db, p_db))),
               "ms": time_ms(lambda: sc_ops.rglru_scan_backward(a, h, g)),
               "plain_ms": time_ms(
                   lambda: sc_ref.rglru_scan_bwd_ref(a, h, g), 5),
               "autograd_plain_ms": time_ms(lambda: torch.autograd.grad(
                   sc_ref.rglru_scan_ref(pa, pb), (pa, pb), g), 3)}
        # one FMA and a product an element; a, h, g read, da, db written
        rec["bound_ms"], rec["bound_by"] = bound(3 * a.numel(),
                                                 5 * 4 * a.numel())
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        _phase("train_kernel", name="rglru_scan_backward", **rec)
        kernel[name] = rec
        del a, b, g, h, ka, kb, pa, pb, k_da, k_db, p_da, p_db
    torch.cuda.empty_cache()
    _phase("train_summary", seconds=f"{time.perf_counter() - t_phases:.1f}",
           launches=totals, scan_backward_launches=backward_total)
    return {"launches": totals, "backward_launches": backward_total,
            "kernel": kernel, "train": train, "hybrid": hy}


def mesh_phases(dev, time_ms, counters) -> dict:
    """Phases 18-22: the mesh layer on the card, a world of 1 (NCCL; gloo
    when rehearsed on the CPU). ``[train_sharded]``: qwen2-1.5b at
    [train]'s size on DTensors laid out by ``param_shardings`` /
    ``batch_shardings`` against the unsharded step; ``[train_sharded_
    hybrid]``: recurrentgemma-2b at 3 layers with the scan's launches a
    step asserted; ``[elastic]``: save from the mesh, remesh, restore with
    ``shardings=``, step; ``[collectives]``: ``compressed_allreduce`` and a
    1-stage ``pipeline_forward``; ``[serve_mesh]``: ``serve_uncertain``
    under the mesh against ``mesh=None``. Returns the launches of the runs
    on a mesh by kernel (``KERNEL_NAMES``) and the scan's backward
    launches among them."""
    import contextlib
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.distributed import (compression, elastic, pipeline,
                                         sharding)
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as lm_model
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.serving import engine
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_init, train_state_specs)

    t_phases = time.perf_counter()
    totals = dict.fromkeys(KERNEL_NAMES, 0)
    backward_total = 0

    def reset():
        _reset_counts(counters)
        sc_ops.rglru_scan.backward_launches = 0

    def add_counts(meshed: bool = True) -> dict:
        """The launches since ``reset``; tallied when the run was on a
        mesh (the unsharded runs beside them are not the mesh's path)."""
        nonlocal backward_total
        counts = _launch_counts(counters)
        if meshed:
            for name, n in counts.items():
                totals[name] += n
            backward_total += sc_ops.rglru_scan.backward_launches
        return counts

    @contextlib.contextmanager
    def world():
        """A one-rank process group on the card, destroyed on exit."""
        with tempfile.TemporaryDirectory() as d:
            mesh_lib.init_world(f"file://{d}/rendezvous", 0, 1,
                                device_type=dev.type)
            try:
                yield
            finally:
                dist.destroy_process_group()

    def mesh_2d():
        return mesh_lib.make_mesh(MESH_SHAPE, MESH_DIMS,
                                  device_type=dev.type)

    def on_mesh(step_fn, mesh):
        """``step_fn`` on DTensors: the batch laid out by batch_shardings,
        under the mesh and implicit replication."""
        def run(state, batch):
            batch = sharding.distribute_tree(
                batch, sharding.batch_shardings(mesh, batch))
            with mesh_lib.use_mesh(mesh), implicit_replication():
                return step_fn(state, batch)
        return run

    def value(t) -> float:
        return float(t.full_tensor() if isinstance(t, DTensor) else t)

    def run_steps(step_fn, state, batches, check=None, meshed=True):
        """Steps over ``batches``: (state, losses, gnorms, step seconds);
        ``check(step, counts)`` after each step."""
        losses, gnorms, secs = [], [], []
        for i, batch in enumerate(batches):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = value(metrics["loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = add_counts(meshed)
            if check:
                check(i, counts)
            losses.append(loss)
            gnorms.append(value(metrics["gnorm"]))
        return state, losses, gnorms, secs

    def no_launches(step, counts):
        if any(counts.values()):
            raise AssertionError(f"step {step}: kernel launches {counts}; "
                                 f"this step takes none")

    def ms(secs) -> float:
        return 1e3 * statistics.median(secs[TRAIN_WARM:] or secs)

    def params_gap(a, b) -> float:
        return max(float((x.detach().float() - y.detach().float())
                         .abs().max())
                   for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)))

    # ---- [train_sharded]: qwen2-1.5b, all 28 layers ------------------------
    cfg = registry.get_config(TRAIN_ARCH, mask_samples=LM_MASKS,
                              remat="full")
    model = lm_model.build_model(cfg)
    opt = build_optimizer(OptimizerConfig(name="adamw", **TRAIN_OPT))
    step_fn = make_train_step(model, opt, TrainConfig())
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                        global_batch=TRAIN_B)
    batches = [lm_batch(data, i, dev) for i in range(MESH_STEPS + 1)]
    profiled = batches.pop()            # one more step, under the profiler
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = train_state_init(model, opt, torch.Generator(dev).manual_seed(0),
                             device=dev)
    plain, p_losses, p_gnorms, p_secs = run_steps(
        step_fn, plain, batches, no_launches, meshed=False)
    p_peak = torch.cuda.max_memory_allocated() / 1e9
    p_prof = call_profile(lambda: step_fn(plain, profiled), reps=1)
    # on the host, so the sharded run's peak holds its own state alone
    p_params = tree_lib.tree_map(lambda t: t.detach().cpu(), plain["params"])
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with world():
        mesh = mesh_2d()
        state = train_state_init(model, opt,
                                 torch.Generator(dev).manual_seed(0),
                                 device=dev)
        state = sharding.distribute_tree(
            state, sharding.param_shardings(mesh, state))
        state, s_losses, s_gnorms, s_secs = run_steps(
            on_mesh(step_fn, mesh), state, batches, no_launches)
        s_peak = torch.cuda.max_memory_allocated() / 1e9
        s_prof = call_profile(
            lambda: on_mesh(step_fn, mesh)(state, profiled), reps=1)
        gap = params_gap(tree_lib.tree_map(
            lambda t: t.cpu(), sharding.gather_tree(state["params"])),
            p_params)
        placements = sorted({str(t.placements)
                             for t in tree_lib.leaves(state["params"])})
        del state
    del p_params
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(s_losses, p_losses))
    _phase("train_sharded", arch=TRAIN_ARCH, layers=cfg.n_layers,
           dtype=cfg.dtype, batch=TRAIN_B, seq=TRAIN_S, mesh=MESH_SHAPE,
           steps=MESH_STEPS, ms_per_step=ms(s_secs),
           unsharded_ms_per_step=ms(p_secs),
           ratio=ms(s_secs) / ms(p_secs), first_step_s=s_secs[0],
           unsharded_first_step_s=p_secs[0], peak_gb=s_peak,
           unsharded_peak_gb=p_peak, losses=s_losses,
           unsharded_losses=p_losses, loss_max_rel=rel,
           gnorm_max_rel=max(abs(a - b) / abs(b)
                             for a, b in zip(s_gnorms, p_gnorms)),
           params_max_abs_gap=gap, placements=placements,
           launches=dict.fromkeys(KERNEL_NAMES, 0))
    _phase("train_sharded_profile", arch=TRAIN_ARCH,
           **{f"{k}": s_prof[k] for k in ("wall_ms", "device_ms",
                                          "device_busy_share", "kernels")},
           **{f"unsharded_{k}": p_prof[k]
              for k in ("wall_ms", "device_ms", "device_busy_share",
                        "kernels")},
           top_kernels_us=s_prof["top_kernels_us"])
    if not rel <= TOL_MESH_LOSS:
        raise AssertionError(f"[train_sharded] losses {s_losses} against "
                             f"the unsharded {p_losses} (rel {rel:.3g})")

    # ---- [train_sharded_hybrid]: recurrentgemma-2b, the scan on shards ----
    hcfg = registry.get_config(HY_ARCH, mask_samples=LM_MASKS,
                               n_layers=TRAIN_HY_LAYERS, remat="full")
    hmodel = lm_model.build_model(hcfg)
    hstep = make_train_step(hmodel, opt, TrainConfig())
    hdata = LMDataConfig(vocab_size=hcfg.vocab_size, seq_len=TRAIN_HY_S,
                         global_batch=TRAIN_HY_B)
    hbatches = [lm_batch(hdata, i, dev) for i in range(MESH_STEPS)]

    def scan_launches(step, counts):
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["rglru_scan"] = TRAIN_HY_SCAN_LAUNCHES
        back = sc_ops.rglru_scan.backward_launches
        if counts != want or back != TRAIN_HY_SCAN_BACKWARD:
            raise AssertionError(f"[train_sharded_hybrid] step {step}: "
                                 f"launches {counts}, backward {back}; "
                                 f"expected {want}, backward "
                                 f"{TRAIN_HY_SCAN_BACKWARD}")

    plain = train_state_init(hmodel, opt,
                             torch.Generator(dev).manual_seed(0), device=dev)
    plain, hp_losses, _, hp_secs = run_steps(hstep, plain, hbatches,
                                             scan_launches, meshed=False)
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(totals)
    with world():
        mesh = mesh_2d()
        state = train_state_init(hmodel, opt,
                                 torch.Generator(dev).manual_seed(0),
                                 device=dev)
        state = sharding.distribute_tree(
            state, sharding.param_shardings(mesh, state))
        state, h_losses, _, h_secs = run_steps(
            on_mesh(hstep, mesh), state, hbatches, scan_launches)
        del state
    torch.cuda.empty_cache()
    _phase("train_sharded_hybrid", arch=HY_ARCH, layers=TRAIN_HY_LAYERS,
           dtype=hcfg.dtype, batch=TRAIN_HY_B, seq=TRAIN_HY_S,
           mesh=MESH_SHAPE, steps=MESH_STEPS, ms_per_step=ms(h_secs),
           unsharded_ms_per_step=ms(hp_secs),
           ratio=ms(h_secs) / ms(hp_secs), first_step_s=h_secs[0],
           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
           losses=h_losses, unsharded_losses=hp_losses,
           loss_max_rel=max(abs(a - b) / abs(b)
                            for a, b in zip(h_losses, hp_losses)),
           scan_launches_per_step=TRAIN_HY_SCAN_LAUNCHES,
           scan_backward_per_step=TRAIN_HY_SCAN_BACKWARD,
           launches={k: totals[k] - before[k] for k in KERNEL_NAMES})

    # ---- [elastic]: save on the mesh, remesh, restore, step ---------------
    ecfg = dataclasses.replace(cfg, n_layers=MESH_ELASTIC_LAYERS)
    emodel = lm_model.build_model(ecfg)
    estep = make_train_step(emodel, opt, TrainConfig())
    batch = lm_batch(LMDataConfig(vocab_size=ecfg.vocab_size,
                                  seq_len=TRAIN_S, global_batch=TRAIN_B),
                     0, dev)
    with tempfile.TemporaryDirectory() as ckdir:
        with world():
            mesh = mesh_2d()
            state = train_state_init(emodel, opt,
                                     torch.Generator(dev).manual_seed(0),
                                     device=dev)
            state = sharding.distribute_tree(
                state, sharding.param_shardings(mesh, state))
            t0 = time.perf_counter()
            path = ckpt_lib.save_checkpoint(ckdir, 0, state)
            write_s = time.perf_counter() - t0
            reset()
            state, m = on_mesh(estep, mesh)(state, batch)
            no_launches(0, add_counts())
            want_loss, want_gnorm = value(m["loss"]), value(m["gnorm"])
            want = sharding.gather_tree(state["params"])
            del state
        ckpt_gb = sum(f.stat().st_size for f in Path(path).rglob("*")
                      if f.is_file()) / 1e9
        plan = elastic.plan_remesh(dict(zip(MESH_DIMS, MESH_SHAPE)), 1)
        with world():
            mesh = elastic.mesh_from_plan(plan, device_type=dev.type)
            target = train_state_specs(emodel, opt)
            t0 = time.perf_counter()
            state, _ = ckpt_lib.restore_checkpoint(
                ckdir, 0, target,
                shardings=sharding.param_shardings(mesh, target))
            restore_s = time.perf_counter() - t0
            reset()
            state, m = on_mesh(estep, mesh)(state, batch)
            no_launches(0, add_counts())
            loss, gnorm = value(m["loss"]), value(m["gnorm"])
            got = sharding.gather_tree(state["params"])
            del state
    # one bf16 step of each value (2^-8 of it), or of the smallest normal
    room = [torch.clamp(w.detach().float().abs() * 2.0 ** -8,
                        min=2.0 ** -126) for w in tree_lib.leaves(want)]
    use = max(float(((g.detach().float() - w.detach().float()).abs() / r)
                    .max())
              for g, w, r in zip(tree_lib.leaves(got), tree_lib.leaves(want),
                                 room))
    bitwise = all(torch.equal(g, w) for g, w in zip(tree_lib.leaves(got),
                                                    tree_lib.leaves(want)))
    _phase("elastic", arch=TRAIN_ARCH, layers=MESH_ELASTIC_LAYERS,
           old_shape=plan.old_shape, new_shape=plan.new_shape,
           mesh_dims=list(mesh.mesh_dim_names), checkpoint_gb=ckpt_gb,
           write_s=f"{write_s:.2f}", restore_s=f"{restore_s:.2f}",
           loss=loss, loss_without_round_trip=want_loss,
           gnorm_rel=abs(gnorm - want_gnorm) / abs(want_gnorm),
           params_max_abs_gap=params_gap(got, want),
           params_bf16_step_use=use, params_bitwise=bitwise)
    del got, want
    torch.cuda.empty_cache()
    if loss != want_loss or abs(gnorm - want_gnorm) > 1e-5 * abs(
            want_gnorm) or use > 1:
        raise AssertionError(f"[elastic] after the round trip: loss {loss} "
                             f"against {want_loss}, gnorm {gnorm} against "
                             f"{want_gnorm}, parameters at {use:.3g} of a "
                             f"bf16 step")

    # ---- [collectives]: the int8 all-reduce, one pipeline stage -----------
    gen = torch.Generator(dev).manual_seed(7)
    with world():
        x = torch.randn(MESH_ALLREDUCE_SHAPE, generator=gen, device=dev)
        got = compression.compressed_allreduce(x)
        xf = x.float()
        scale = compression.int8_scale(xf.abs().amax(-1, keepdim=True))
        want = (torch.clamp(torch.round(xf / scale), -127, 127)
                .to(torch.int32).float() * scale)
        if not torch.equal(got, want):
            raise AssertionError("[collectives] compressed_allreduce on one "
                                 "rank differs from quantize-dequantize")
        ar_ms = time_ms(lambda: compression.compressed_allreduce(x))
        pmesh = mesh_lib.make_mesh((1,), ("stage",), device_type=dev.type)
        w = torch.randn((1, MESH_PIPE_WIDTH, MESH_PIPE_WIDTH), generator=gen,
                        device=dev) / math.sqrt(MESH_PIPE_WIDTH)
        h = torch.randn((MESH_PIPE_B, MESH_PIPE_WIDTH), generator=gen,
                        device=dev)

        def stage_fn(wi, hi):
            return torch.tanh(hi @ wi)

        piped = pipeline.pipeline_forward(pmesh, stage_fn, w, h, n_micro=4)
        pipe_err = float((piped - stage_fn(w[0], h)).abs().max())
        if not pipe_err <= TOL_MESH_PIPE:
            raise AssertionError(f"[collectives] pipeline_forward: error "
                                 f"{pipe_err:.3g}")
    _phase("collectives", allreduce_shape=list(MESH_ALLREDUCE_SHAPE),
           allreduce_bit_equal=True, allreduce_ms=ar_ms,
           pipeline_stages=1, pipeline_micro=4,
           pipeline_bubble=pipeline.bubble_fraction(1, 4),
           pipeline_max_abs_err=pipe_err)

    # ---- [serve_mesh]: serve_uncertain under the mesh ----------------------
    scfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS,
                               n_layers=MESH_SERVE_LAYERS)
    smodel = lm_model.build_model(scfg)
    sparams = smodel.init(torch.Generator(dev).manual_seed(0), device=dev)
    prompts = torch.randint(0, scfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    serve_cfg = engine.ServeConfig(max_new_tokens=LM_NEW, fused=False)

    def serve(mesh):
        reset()
        out = engine.serve_uncertain(smodel, sparams, prompts, serve_cfg,
                                     mesh=mesh, device=dev)
        torch.cuda.synchronize()
        return out, add_counts(mesh is not None)

    want, want_counts = serve(None)
    with world():
        got, got_counts = serve(mesh_2d())
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    _phase("serve_mesh", arch=LM_ARCH, layers=MESH_SERVE_LAYERS,
           batch=LM_BATCH, prompt=LM_PROMPT, new=LM_NEW, fused=False,
           tokens_equal=torch.equal(got[0], want[0]),
           rel_unc_equal=torch.equal(got[1], want[1]), launches=got_counts,
           launches_without_mesh=want_counts)
    if not equal or got_counts != want_counts or not (
            got_counts["flash_attention"] and got_counts["moments"]):
        raise AssertionError(f"[serve_mesh] under the mesh: outputs equal "
                             f"{equal}, launches {got_counts} against "
                             f"{want_counts}")
    del sparams
    torch.cuda.empty_cache()
    _phase("mesh_summary", seconds=f"{time.perf_counter() - t_phases:.1f}",
           launches=totals, scan_backward_launches=backward_total)
    return {"launches": totals, "backward_launches": backward_total}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import plan as plan_lib
    from repro_torch.ivim import data as ivim_data
    from repro_torch.ivim import model as ivim_model
    from repro_torch.ivim import physics
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_plan import ops as fp_ops
    from repro_torch.kernels.fused_plan import ref as fp_ref
    from repro_torch.kernels.masked_ffn import ops as mffn_ops
    from repro_torch.kernels.masked_ffn import ref as mffn_ref
    from repro_torch.kernels.moments import ops as mo_ops
    from repro_torch.serving import engine

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    _phase("device", name=repr(torch.cuda.get_device_name(0)),
           torch=torch.__version__, cuda=torch.version.cuda,
           build_s=f"{build_s:.1f}", built=sorted(logs))
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                _phase("ptxas", source=stem, info=line.strip())
    # first, while the process is fresh: after the later phases (profiler
    # runs, gigabytes of allocations) the same calls take longer on the host
    host = host_path_phase(dev)

    def time_ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def nbytes(*tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(flops: int, moved: int, peak: float = FP32_PEAK
              ) -> tuple[float, str]:
        t_ops, t_bytes = flops / peak, moved / HBM_BW
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def max_err(got, want, tol: float) -> float:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def fp32_products(name: str, got, want) -> float:
        """Max abs error over the plain output's largest magnitude, held
        to TOL_3XTF32_REL: the tensor cores' products are fp32-accurate."""
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        if not rel <= TOL_3XTF32_REL:
            raise AssertionError(f"{name}: error {rel:.3g} of the plain "
                                 f"output's magnitude (> {TOL_3XTF32_REL}): "
                                 f"the products are not fp32-accurate")
        return rel

    # ---- the dense model and its plan (shared by phases 2 and 3) ----------
    def dense_model(n_masks: int):
        """uIVIM-NET at the dense protocol: weights from seed 0, BN running
        statistics and affine parameters from seed 1."""
        cfg = ivim_model.IvimConfig(b_values=physics.DENSE_B_VALUES,
                                    n_masks=n_masks, scale=2.0)
        model = ivim_model.init(cfg, torch.Generator().manual_seed(0),
                                device=dev)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for i in (1, 2):
                shape = getattr(model, f"bn{i}_mean").shape
                getattr(model, f"bn{i}_mean").copy_(
                    0.2 * torch.randn(shape, generator=gen))
                getattr(model, f"bn{i}_var").copy_(
                    0.5 + torch.rand(shape, generator=gen))
                getattr(model, f"bn{i}")["gamma"].copy_(
                    0.5 + torch.rand(shape, generator=gen))
                getattr(model, f"bn{i}")["beta"].copy_(
                    0.1 * torch.randn(shape, generator=gen))
        model.eval()
        return cfg, model

    cfg, model = dense_model(8)
    plan = ivim_model.pack_for_serving(model)
    n_vox = VOLUME[0] * VOLUME[1] * VOLUME[2]
    volume = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        n_voxels=n_vox, snr=20.0, b_values=physics.DENSE_B_VALUES, seed=0),
        device=dev)["signals"].reshape(*VOLUME, cfg.width)
    voxels = volume.reshape(n_vox, cfg.width)

    small_cfg = ivim_model.IvimConfig(n_masks=1, scale=2.0)
    small_plan = ivim_model.pack_for_serving(ivim_model.init(
        small_cfg, torch.Generator().manual_seed(2), device=dev))
    x_ragged = torch.rand((4097, small_cfg.width),
                          generator=torch.Generator(dev).manual_seed(3),
                          device=dev)

    # ---- phase 2: the int8 quantizer, then every kernel against its plain
    # version ----------------------------------------------------------------
    int8 = plan_lib.Precision("int8")
    _, on_card = plan_lib.lower_fused(plan.with_precision(int8))
    _, on_cpu = plan_lib.lower_fused(plan.to("cpu").with_precision(int8))
    for got, want in zip(on_card, on_cpu):
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(f"int8 lowering on the card differs from "
                                 f"the CPU's ({got.dtype}, {want.dtype})")
    _phase("quantizer", plan="dense", tensors=len(on_card),
           int8_values=sum(t.numel() for t in on_card
                           if t.dtype == torch.int8),
           bit_equal_to_cpu=True)
    kernels = {}

    def pair_case(p, x, quant):
        body = p.params["body"]
        d2 = body["w2p"].shape[-1]
        if not quant:
            return (x, body["w1p"], body["b1p"], body["w2p"],
                    torch.zeros(d2, device=dev))
        q1, s1 = plan_lib._quantize_weight(body["w1p"])
        q2, s2 = plan_lib._quantize_weight(body["w2p"])
        return (x, q1, plan_lib._low_bias(body["b1p"]), q2,
                torch.zeros(d2, dtype=torch.bfloat16, device=dev), s1, s2)

    for quant, shape_name, p, x in (
            (q, name, p, x) for q in (False, True)
            for name, p, x in (("main", plan, voxels[:CHUNK]),
                               ("ragged", small_plan, x_ragged))):
        sfx = "_int8" if quant else ""
        args = pair_case(p, x, quant)
        n, d, k = args[1].shape
        d2 = args[3].shape[-1]
        flops = 2 * n * x.shape[0] * (d * k + k * d2)
        w_bytes = nbytes(*args[1:])
        moved = nbytes(x) + w_bytes + 4 * n * x.shape[0] * d2
        plain_ms = time_ms(lambda: mffn_ref.masked_ffn_ref(*args))
        y_plain = mffn_ref.masked_ffn_ref(*args)
        # the paper's batch-level grid order and the sampling-level one:
        # one block body, so the two must agree bit for bit
        ys = {}
        for order, major in (("batch_level", True), ("sampling_level", False)):
            ys[order] = mffn_ops.masked_ffn(*args, sample_major=major)
            rec = {"name": "masked_ffn" + sfx, "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/masked_ffn.cu",
                   "replaces": "src/repro/kernels/masked_ffn/kernel.py:60"
                               " (_ffn_kernel_q, pallas_call :140)" if quant
                               else "src/repro/kernels/masked_ffn/kernel.py:79",
                   "shape": shape_name, "order": order,
                   "max_abs_err": max_err(
                       [ys[order]], [y_plain],
                       TOL_INT8 if quant else TOL_SAMPLES),
                   "ms": time_ms(lambda m=major: mffn_ops.masked_ffn(
                       *args, sample_major=m)),
                   "device_ms": device_ms(lambda m=major: mffn_ops.masked_ffn(
                       *args, sample_major=m)),
                   "plain_ms": plain_ms, "weight_bytes": w_bytes}
            if shape_name == "main":
                rec["rel_err"] = fp32_products(rec["name"], [ys[order]],
                                               [y_plain])
            rec["bound_ms"], rec["bound_by"] = bound(flops, moved,
                                                     TF32_3X_PEAK)
            kernels.setdefault(rec["name"], []).append(rec)
        if not torch.equal(ys["batch_level"], ys["sampling_level"]):
            raise AssertionError(f"masked_ffn{sfx} {shape_name}: the two grid "
                                 f"orders differ")

        pp = p.with_precision(int8) if quant else p
        spec, params = plan_lib.lower_fused(pp)
        fp = fp_ops.pack(spec, params)
        b = x.shape[0]
        flops = p.traffic(b, 4, fused=True, moments=True).flops
        at = ("src/repro/kernels/fused_plan/kernel.py:52 (_dense ws "
              "dequant; " if quant else
              "src/repro/kernels/fused_plan/kernel.py:106 (")
        cases = (
            ("fused_plan_samples", at + "pallas_call :165, moments=False)",
             lambda: (fp_ops.fused_samples(fp, x),),
             lambda: (fp_ref.fused_plan_ref(spec, x, params),),
             TOL_INT8 if quant else TOL_SAMPLES,
             4 * spec.n_rows * b * spec.d_out),
            ("fused_plan_moments", at + "pallas_call :222, moments=True)",
             lambda: fp_ops.fused_moments(fp, x),
             lambda: fp_ref.fused_moments_ref(spec, x, params),
             TOL_INT8 if quant else TOL_MOMENTS,
             2 * 4 * b * spec.groups * spec.d_out))
        for name, replaces, run, plain, tol, out_bytes in cases:
            got, want = run(), plain()
            rec = {"name": name + sfx, "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/fused_plan.cu",
                   "replaces": replaces, "shape": shape_name,
                   "max_abs_err": max_err(got, want, tol),
                   "ms": time_ms(run), "device_ms": device_ms(run),
                   "plain_ms": time_ms(plain), "weight_bytes": fp.nbytes}
            if shape_name == "main":
                rec["rel_err"] = fp32_products(rec["name"], got, want)
            rec["bound_ms"], rec["bound_by"] = bound(
                flops, nbytes(x) + fp.nbytes + out_bytes, TF32_3X_PEAK)
            kernels.setdefault(rec["name"], []).append(rec)
    for recs in kernels.values():
        for rec in recs:
            _phase("kernel", **{k: rec[k] for k in (
                "name", "shape", "order", "max_abs_err", "rel_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "weight_bytes") if k in rec})
    mo_recs = moments_phase(dev, time_ms, bound, nbytes)

    # ---- phase 3: the main path --------------------------------------------
    ref_mean, ref_std = [], []
    for lo in range(0, n_vox, 8 * CHUNK):        # unpacked model, in slices
        m, s = ivim_model.predict(model, voxels[lo:lo + 8 * CHUNK])
        ref_mean.append(m)
        ref_std.append(s)
    want = (torch.cat(ref_mean).reshape(*VOLUME, 4),
            torch.cat(ref_std).reshape(*VOLUME, 4))
    counters = (mffn_ops.masked_ffn, fp_ops.fused_samples,
                fp_ops.fused_moments, mo_ops.moments)

    def run_leg(fn):
        for c in counters:
            c.launches = 0
            if hasattr(c, "int8_launches"):
                c.int8_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return out, secs, tuple(c.launches for c in counters)

    def int8_counts():      # the three wrappers with an int8 body
        return tuple(c.int8_launches for c in counters[:3])

    def plain_volume(plan=plan):
        spec, params = plan_lib.lower_fused(plan)
        lo_r = torch.tensor([r[0] for r in plan.out_ranges], device=dev)
        hi_r = torch.tensor([r[1] for r in plan.out_ranges], device=dev)
        means, stds = [], []
        for lo in range(0, n_vox, CHUNK):
            m, s = fp_ref.fused_moments_ref(spec, voxels[lo:lo + CHUNK],
                                            params)
            means.append(lo_r + m * (hi_r - lo_r))
            stds.append(s * (hi_r - lo_r).abs())
        return (torch.cat(means).reshape(*VOLUME, 4),
                torch.cat(stds).reshape(*VOLUME, 4))

    n_chunks = -(-n_vox // CHUNK)
    fallbacks = dict(engine.fallback_counts)
    legs = {      # fused: the default entry, which falls back on refusal
        "fused": (lambda: engine.predict_volume(
            plan, volume, chunk=CHUNK, device=dev),
            (0, 0, n_chunks, 0)),
        "per_op": (lambda: engine.predict_volume(
            plan, volume, chunk=CHUNK, fused=False, device=dev),
            (n_chunks, 0, 0, n_chunks)),
        "plain": (plain_volume, (0, 0, 0, 0)),
    }
    launches, leg_secs = {}, {}
    for leg, (fn, expect) in legs.items():
        (mean, std), secs, counts = run_leg(fn)
        leg_secs[leg] = secs
        if counts != expect:
            raise AssertionError(f"{leg} leg launches (masked_ffn, samples, "
                                 f"fused moments, moments) = {counts}, "
                                 f"expected {expect}")
        if not (torch.isfinite(mean).all() and torch.isfinite(std).all()):
            raise AssertionError(f"{leg} leg: non-finite moments")
        err = max_err((mean, std), want, TOL_MOMENTS)
        _phase("main_path", leg=leg, voxels=n_vox, chunks=n_chunks,
               seconds=f"{secs:.4f}", voxels_per_s=f"{n_vox / secs:.0f}",
               max_abs_err=err, launches=counts)
        launches[leg] = counts

    chunk0 = voxels[:CHUNK]
    samples, _, counts = run_leg(lambda: ivim_model.packed_apply(
        plan, chunk0, fused=True, device=dev))
    if counts != (0, 1, 0, 0):
        raise AssertionError(f"packed_apply(fused=True) launches {counts}")
    samples_launches = counts[1]
    err = max_err([samples], [ivim_model.apply_all_samples(model, chunk0)],
                  TOL_MOMENTS)
    _phase("main_path", leg="packed_apply_fused", voxels=CHUNK,
           max_abs_err=err, launches=counts)

    # ---- phase 3 at int8: the same slab at Precision("int8") --------------
    qplan = plan.with_precision(int8)
    q_legs = {
        "fused": (lambda: engine.predict_volume(
            qplan, volume, chunk=CHUNK, device=dev),
            (0, 0, n_chunks, 0)),
        "per_op": (lambda: engine.predict_volume(
            qplan, volume, chunk=CHUNK, fused=False, device=dev),
            (n_chunks, 0, 0, n_chunks)),
        "plain": (lambda: plain_volume(qplan), (0, 0, 0, 0)),
    }
    q_out, q_launches = {}, {}
    for leg, (fn, expect) in q_legs.items():
        (mean, std), secs, counts = run_leg(fn)
        if counts != expect or int8_counts() != expect[:3]:
            raise AssertionError(
                f"int8 {leg} leg launches (masked_ffn, samples, fused "
                f"moments, moments) = {counts}, of them int8 "
                f"{int8_counts()}; expected {expect}")
        if not (torch.isfinite(mean).all() and torch.isfinite(std).all()):
            raise AssertionError(f"int8 {leg} leg: non-finite moments")
        err = max_err((mean, std), want, TOL_INT8_VS_FP32)
        _phase("main_path_int8", leg=leg, voxels=n_vox, chunks=n_chunks,
               seconds=f"{secs:.4f}", voxels_per_s=f"{n_vox / secs:.0f}",
               max_abs_err_vs_fp32=err, launches=counts,
               int8_launches=int8_counts())
        q_out[leg], q_launches[leg] = (mean, std), counts
    if dict(engine.fallback_counts) != fallbacks:
        raise AssertionError(f"the IVIM plans fell back to the per-op path: "
                             f"{dict(engine.fallback_counts)}")
    fused_vs_per_op = max_err(q_out["fused"], q_out["per_op"], TOL_INT8)
    fused_vs_plain = max_err(q_out["fused"], q_out["plain"], TOL_INT8)
    fp32_bytes = fp_ops.pack(*plan_lib.lower_fused(plan)).flat.numel() * 4
    int8_bytes = fp_ops.pack(*plan_lib.lower_fused(qplan)).nbytes
    if int8_bytes > INT8_BYTES_GATE * fp32_bytes:
        raise AssertionError(f"int8 parameters {int8_bytes} bytes > "
                             f"{INT8_BYTES_GATE} x fp32 {fp32_bytes}")
    _phase("int8_agreement", fused_vs_per_op=fused_vs_per_op,
           fused_vs_plain=fused_vs_plain, param_bytes_int8=int8_bytes,
           param_bytes_fp32=fp32_bytes,
           ratio=f"{int8_bytes / fp32_bytes:.4f}")
    q_samples, _, counts = run_leg(lambda: ivim_model.packed_apply(
        qplan, chunk0, fused=True, device=dev))
    if counts != (0, 1, 0, 0) or int8_counts() != (0, 1, 0):
        raise AssertionError(f"int8 packed_apply(fused=True) launches "
                             f"{counts}, int8 {int8_counts()}")
    err = max_err([q_samples], [ivim_model.apply_all_samples(model, chunk0)],
                  TOL_INT8_VS_FP32)
    _phase("main_path_int8", leg="packed_apply_fused", voxels=CHUNK,
           max_abs_err_vs_fp32=err, launches=counts)
    q_launches["packed_apply"] = counts

    # ---- phases 3b-3d: the design flow -------------------------------------
    del voxels, want
    torch.cuda.empty_cache()
    flow = flow_phases(dev, time_ms, counters)

    # ---- phases 4 and 5: the LM kernel and the LM main path ---------------
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.rglru_scan import ops as sc_ops
    lm_counters = counters + (fd_ops.fused_decode, fa_ops.flash_attention,
                              sc_ops.rglru_scan)
    decode_rec = lm_phases(dev, time_ms, bound, nbytes, lm_counters)
    torch.cuda.empty_cache()

    # ---- phases 6 and 7: the hybrid kernels and the hybrid main path ------
    hybrid_recs = hybrid_phases(dev, time_ms, bound, nbytes, lm_counters)

    # ---- phase 8: the continuous-batching server --------------------------
    # the slab served through the pool by the same dense uIVIM-NET at the
    # pool's 4 masks (a scan's sample axis is the pool's mask axis)
    scan_plan = ivim_model.pack_for_serving(dense_model(LM_MASKS)[1])
    srv = server_phases(dev, time_ms, bound, nbytes, lm_counters, scan_plan,
                        volume)

    # ---- phase 9: the router over three hosts -----------------------------
    routed = router_phases(dev, lm_counters, scan_plan, volume)
    del volume, scan_plan

    # ---- phases 10 and 11: the paper's schedules, the latency model -------
    sched = schedule_phase(dev, time_ms, lm_counters)
    main_moments = next(r for r in kernels["fused_plan_moments"]
                        if r["shape"] == "main")
    pricing_phase(srv, decode_rec, {
        "plan": plan, "kernel_ms": main_moments["ms"],
        "seconds": leg_secs["fused"], "chunks": n_chunks, "voxels": n_vox})

    # ---- phase 12: the remaining backbones ---------------------------------
    bb = backbone_phases(dev, time_ms, bound, nbytes, lm_counters)

    # ---- phases 13-17: LM training -----------------------------------------
    trained = train_phases(dev, time_ms, bound, lm_counters)

    # ---- phases 18-22: the mesh layer --------------------------------------
    meshed = mesh_phases(dev, time_ms, lm_counters)

    # ---- phase 23: the kernels line, then the device line -----------------
    main_launches = {"masked_ffn": launches["per_op"][0],
                     "moments": launches["per_op"][3],
                     "fused_plan_samples": samples_launches,
                     "fused_plan_moments": launches["fused"][2],
                     "masked_ffn_int8": q_launches["per_op"][0],
                     "fused_plan_samples_int8": q_launches["packed_apply"][1],
                     "fused_plan_moments_int8": q_launches["fused"][2]}
    line = []
    for name, recs in kernels.items():
        main = next(r for r in recs if r["shape"] == "main"
                    and r.get("order", "batch_level") == "batch_level")
        orders = {f"{r['order']}_{k}": r[k] for r in recs
                  if r.get("order") and r["shape"] == "main"
                  for k in ("ms", "max_abs_err")}
        line.append({
            "name": name, "route": "cuda", "source": main["source"],
            "replaces": main["replaces"], "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "kernel_ms": main["ms"],
            "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "weight_bytes": main["weight_bytes"],
            **{f"ragged_{k}": next(r[k] for r in recs
                                   if r["shape"] == "ragged")
               for k in ("ms", "device_ms")}, **orders})
    mo = mo_recs["main"]
    line.append({
        "name": "moments", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moments.cu",
        "replaces": "src/repro/kernels/moments/kernel.py:39"
                    " (pallas_call :46)",
        "launches": main_launches["moments"],
        "max_abs_err": max(r["max_abs_err"] for r in mo_recs.values()),
        "ms": mo["ms"], "kernel_ms": mo["ms"], "plain_ms": mo["plain_ms"],
        "bound_ms": mo["bound_ms"], "bound_by": mo["bound_by"],
        "library_ms": mo["library_ms"], "device_ms": mo["device_ms"],
        "library_device_ms": mo["library_device_ms"],
        "int8_per_op_launches": q_launches["per_op"][3],
        "eval_launches": flow["eval_launches"],
        "lm_per_op_launches": decode_rec["moments_per_op_launches"],
        "host_us_before": host["moments"]["wrapper_before_us"],
        "host_us_after": host["moments"]["wrapper_after_us"],
        **{f"{n}_{k}": r[k] for n, r in mo_recs.items() if n != "main"
           for k in ("ms", "library_ms", "bound_ms", "device_ms",
                     "library_device_ms")}})
    line.append(decode_rec)
    line.extend(hybrid_recs)
    for rec in line:       # the server and router runs' launches beside each
        if rec["name"] in srv["main"]:                           # kernel
            rec["server_launches"] = srv["main"][rec["name"]]
            rec["server_hybrid_launches"] = srv["hybrid"][rec["name"]]
            rec["router_launches"] = routed["unfaulted"][rec["name"]]
            rec["router_faulted_launches"] = routed["faulted"][rec["name"]]
        if rec["name"] == "masked_ffn":
            rec["schedule_launches"] = sched["masked_ffn"]
        if rec["name"] in bb:               # the backbone phases' launches
            rec["backbone_launches"] = bb[rec["name"]]
            cases = bb["flash_cases" if rec["name"] == "flash_attention"
                       else "moments_cases"]
            rec.update({f"{n}_{k}": r[k] for n, r in cases.items()
                        for k in ("ms", "library_ms", "bound_ms",
                                  "device_ms", "library_device_ms",
                                  "max_abs_err")})
    for rec in line:    # the training and mesh runs' launches beside each
        rec["train_launches"] = trained["launches"].get(rec["name"], 0)
        rec["mesh_launches"] = meshed["launches"].get(rec["name"], 0)
        if rec["name"] == "rglru_scan":
            bwd = trained["kernel"]
            main_bwd = bwd["train"]
            rec.update({
                "train_backward_launches": trained["backward_launches"],
                "mesh_backward_launches": meshed["backward_launches"],
                "backward_ms": main_bwd["ms"],
                "backward_plain_ms": main_bwd["plain_ms"],
                "backward_bound_ms": main_bwd["bound_ms"],
                "backward_bound_by": main_bwd["bound_by"],
                "backward_max_abs_err": max(r["max_abs_err"]
                                            for r in bwd.values()),
                "backward_rel_err": max(r["rel_err"] for r in bwd.values()),
                "backward_bound_share": main_bwd["bound_share"],
                "backward_shapes": {n: {k: r[k] for k in (
                    "dims", "ms", "plain_ms", "autograd_plain_ms",
                    "bound_ms", "bound_share", "rel_err")}
                    for n, r in bwd.items()}})
    decode_rec["server_shapes"] = {
        f"active_{a}": {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "rel_err")}
        for a, r in srv["shapes"].items()}
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
