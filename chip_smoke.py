#!/usr/bin/env python3
"""Smoke test of forde_tpu_torch on one NVIDIA GPU (H100).

Drives the port's main paths through the entry points a user calls, and
holds every CUDA kernel of them against its plain PyTorch version:

  * the embedding path (``forde_tpu_torch.embed.main``) at the full width
    of the production ViT-B preset (``vit_b16_hd128``, bf16, seeded random
    weights);
  * the dual encoder's training path (``forde_tpu_torch.train.clip_loop.
    main``) at the full width of ``vit_b16`` in bf16, batch 128: 16
    contrastive steps with sensing every 8th, two GMM brain updates, and a
    checkpoint that ``embed.main`` then serves;
  * the decoder LM's serving path (``forde_tpu_torch.serve.main``) at the
    full width of the reference-default decoder (d 512, 12 layers, 8 heads
    x 64, NSA window 512, MoE top-2 of 8, 4 mHC streams, bf16), from a
    checkpoint of seeded random weights: a ragged batch of 8 prompts of
    640-1,920 tokens, greedy, and one sampled prompt of 1,536 tokens;
  * the decoder LM's training path (``forde_tpu_torch.train.loop.main``)
    at the same width on batches of 8 x 2,048 seeded Markov tokens: 6
    steps, the MoE slow loop every 3rd, a checkpoint that ``serve.main``
    then decodes from; and one step at 2 layers, batch 1, 8,192 tokens
    (the JAX package's streaming side, 960 NSA pools);
  * the compiled steps: serving's decode steps replayed from a CUDA graph
    (the default of generate_cached / generate_ragged, and so of serve.main
    above) against eager decode, serving at --seq_len 8192 (2 layers, one
    prompt of 6,000 tokens), the NSA prefill's top-k replay on the device
    (csrc/topk_replay.cu), and the dual encoder's fused k steps
    (make_fused_step: one CUDA graph of 8 steps; the training CLI with
    --fuse_steps 4).
  * the generation extras at the serving width: prefix caching (the
    dense variant, --no_nsa), beam search and full-recompute generation
    (NSA), speculative decoding (dense target, drafts from checkpoints),
    int8 weights (the NSA serving batch), and serve's --prefix_ids,
    --beam_size, --draft_checkpoint_dir and --quantize on the card.
  * continuous batching (``models/decode_pool.DecodePool``, an 8-row pool
    at the serving width, requests arriving staggered) and the HTTP daemon
    (``serve_http``, in-process on 127.0.0.1, batch and continuous mode).
  * the training extras: the decoder LM's EMA, gradient accumulation,
    resume, preemption, LoRA, distillation and ``eval_lm`` at the
    reference-default width and depth, and the dual encoder's fused steps
    with EMA, aligned data rendered on the card and the clip loop's
    retrieval eval at vit_b16.
  * the training extras' second part: rematerialisation (the decoder LM
    at full depth, its long-context configuration through the training
    CLI with --remat --scan_layers; the dual encoder's "block" and "mlp"
    policies at vit_b16), both training CLIs profiled, the scanned
    checkpoint layout through --resume and serving, and the NSA branch
    modules at full width.
  * the multi-device paths on thread ranks of this process (data, context,
    expert, model and pipe axes; FSDP), and the port's benchmark drivers
    (``forde_tpu_torch.bench`` and ``forde_tpu_torch.benchmarks``), each
    ending in its one JSON line.
  * a train state written on the CPU resumed on the card (``clip_loop
    --resume``, the move of a converted JAX run): the Forde-lite tiny
    preset at its full width in fp32, through a Forde-lite update.

Phases:
  1. device: name, and name + power limit from nvidia-smi;
  2. build every kernel under forde_tpu_torch/csrc (topk_replay included), one nvcc per source,
     all started together; ptxas's registers and spills per kernel, 0
     spill bytes in every tensor-core kernel, and the HMMA (tensor-core)
     count of the libraries with a bf16 tensor-core route (flash_mha_fwd,
     flash_mha_bwd, flash_fwd, flash_bwd, small_kv_fwd, small_kv_bwd),
     which must not be 0; the fp32 route of flash_mha_fwd, flash_mha_bwd,
     small_kv_bwd and flash_bwd on the tensor cores too (three TF32
     passes a product: their TF32 kernels among the tensor-core kernels,
     TF32 HMMA in their SASS);
  3. each kernel against its plain version on the card, fp32 and bf16, at
     the shapes of the paths (the training CLIs' shapes, vit_tiny's 3 heads
     of 64 among them; the serving
     prefill and decode shapes, the streaming S = 8192, an odd S and a
     padded D) and the mask options (kv_lens with 0, kv_bound, causal +
     window; kv_len; INVALID_KEY_POS keys, keys all in the future, K not a
     multiple of 64, padding keys that fill whole key chunks, up to 8,192
     keys; an lse cotangent; a window that is not a multiple of
     the tile), each backward kernel's bf16 error against its plain
     version's, flash_mha_fwd and flash_mha_bwd in fp32 (every case),
     flash_fwd, small_kv_fwd, flash_bwd_dq, flash_bwd_dkv,
     small_kv_bwd and moment_sums bit-identical across two calls, a misaligned tensor
     refused by the 4-D wrappers (bf16; the backward's fp32 too) and by
     moment_sums, an F of
     moment_sums that is not a multiple of its 8-column vector, and the
     output and gradients of ``flash_mha``,
     ``flash_attention`` and ``small_kv_attention`` on CUDA tensors
     against the kernels or the plain attention path;
  4. the embedding path: finite (N, 512) embeddings, 24 launches of
     flash_mha_fwd (12 + 12 layers), and the cosine of each embedding
     against the same weights on the all-plain attention path;
  5. the dual encoder's training path: finite loss, the launches of each
     kernel (per sensed step 24 flash_mha_fwd, 24 flash_mha_bwd, 48
     moment_sums; per unsensed step 24 + 24 + 0), two brain updates that
     were not skipped, gradient statistics non-zero before each update and
     zero after, the checkpoint served by ``embed.main``, and the CLI's
     prefetch route delivering batches intact;
  6. step parity at ``vit_b16_hd128``: one sensed step on the kernel path
     against one on the all-plain path from the same weights, fp32 and
     bf16 (with the bf16-vs-fp32 plain control printed beside it);
  7. timing at ``vit_b16_hd128``, bf16, batch 128: encode time, sensed and
     unsensed step times, pairs/s at sensing every 8th step, the neuron
     slow loop, one encode and one sensed step under torch.profiler, and
     per kernel its time (and its device time alone), its plain
     version's, PyTorch's one-call equivalent where there is one (timed as
     a yardstick only, the port never calls it) and the least time the
     card could take; the attention kernels also at ``vit_b16``'s D = 64
     shapes; each kernel also in fp32 (the route of every run without
     --bf16; the fused-qkv kernels' bound at both fp32 peaks: the CUDA
     cores' and three TF32 passes'), and the fp32 sensed and unsensed step
     (kernel path and all-plain path) with one fp32 sensed step under
     torch.profiler;
  8. the serving path: ``serve.main`` from the checkpoint, ids in the
     vocabulary, the prompts kept, and exact launches (per prefill 12
     flash_fwd, 24 small_kv_fwd and 1 topk_replay, per decode step 0, 24
     and 0; the decode steps replayed from a CUDA graph);
  9. serving parity: the greedy batch on the kernel path and on the
     all-plain path from the same weights, identical tokens in fp32, and
     in bf16 the relative L2 of the prefill's last logits beside the
     plain-bf16-vs-plain-fp32 control;
 10. serving time: time to first token and ms per output token of the
     8-prompt batch (kernel path vs all-plain path in turns), output
     tokens/s, one prefill and one decode step under torch.profiler, and
     per kernel its time, its plain version's, SDPA's with the same mask,
     and the bound (flash_fwd in fp32 too, at the prefill and S = 8192);
 11. the LM training path: finite loss, exact launches (per step 12
     flash_fwd, 12 flash_bwd_dq, 12 flash_bwd_dkv, 24 small_kv_fwd, 24
     small_kv_bwd), two MoE slow loops that moved all 12 router biases,
     peak memory, the trained checkpoint served; the 8,192-token step;
 12. LM step parity (batch 2 x 2,048): the kernel path against the
     all-plain path (every kernel's plain version) and the plain attention
     path, fp32 and bf16, with the bf16-vs-fp32 control;
 13. LM training time (bf16, 8 x 2,048): step time, tokens/s, the MoE slow
     loop, one step under torch.profiler, and per backward kernel its
     time, its plain version's, SDPA's backward with the same mask, and the
     bound, in bf16 and in fp32 (fp32 rows: the bound at both fp32 peaks
     and five calls of each TF32 kernel under torch.profiler);
 14. topk_replay against its plain version, exactly (scores and positions,
     slot order included): the serving prefill's 96 rows x 2,048 positions
     with the prompts' -inf pads, P = 1, every score tied, and 6,000
     positions; its time beside the plain version's and its bound (bytes,
     and the chain of accepted insertions);
 15. the training CLI with --fuse_steps 4 (vit_b16, bf16, batch 128):
     exact launches, two brain updates between fused calls;
 16. fused steps at vit_b16_hd128 (bf16, batch 128, k = 8, sensing every
     8th): a replayed call against the same 8 steps run eagerly from the
     same state (bit-identical, or within phase 6's bars), exact step
     counts and launches, pairs/s fused and unfused, its idle share;
 17. the decode graph against eager decode (cuda_graph=False), fp32 and
     bf16, the greedy serving batch: identical tokens, bit-identical last
     logits, exact launches with replays counted, for the call that
     captures and for one that only replays; serving time (phase 10) is
     taken graphed and eager, and a replayed decode step profiled;
 18. serving at --seq_len 8192 (2 layers, a 6,000-token prompt): graphed
     tokens identical to eager, exact launches.
 19. prefix caching (dense variant, a 1,024-token prefix, 8 suffixes of
     64-512, 32 new, greedy): fp32 tokens identical to the concatenated
     prompt's, bf16 last logits within PREFIX_BF16_OF_CONTROL x control,
     the prefix cache unchanged, no csrc kernel launched; TTFT with and
     without the prefix;
 20. beam search (NSA, prompts of 1,100 and 1,500, beam 4, 32 new, length
     penalty 0.6, an EOS): fp32 kernel path = plain path, the 4-beam score
     >= the greedy one, beam 1 = generate_cached, exact launches; bf16 ms
     per step;
 21. full-recompute generate (NSA, fp32, 2 x 256, 16 new): tokens =
     generate_cached's, 16 x 12 launches of flash_fwd and of each
     small_kv_fwd branch, MoE stat buffers kept; bf16 agreement;
 22. speculative decoding (dense target, 512-token prompt, 32 new, gamma
     4): fp32 tokens = generate_cached's with the target as its own draft
     (every proposal accepted) and with a 2-layer draft, both loaded from
     checkpoints; bf16 tokens/forward and ms per output token beside
     generate_cached graphed and eager;
 23. int8 weights (quantize_params of the bf16 serving model): last logits
     within INT8_OF_CONTROL x phase 9's control, exact launches, TTFT, ms per output token,
     tokens/s, weight bytes against bf16;
 24. one `python -m forde_tpu_torch.serve` process each for --prefix_ids,
     --beam_size 4, --draft_checkpoint_dir and --quantize int8 (2 layers),
     all four together.
 25. continuous batching (NSA, 8 rows; 8 requests before the first tick,
     then one every 2 pooled steps): fp32 greedy tokens of 12 requests of
     640-1,920 tokens (8-16 new) identical to each one's generate_cached
     on the plain model, which launches no kernel (the top-2 logit margin
     printed at a mismatch); the graphed pool
     identical to the eager pool in fp32 and bf16; decode_fuse 4 identical
     to decode_fuse 1 on the 24-request trace (8-48 new); exact launches
     (per admission 12 flash_fwd, 24 small_kv_fwd, 1 topk_replay; per
     pooled step 24 small_kv_fwd; replays counted); the dense variant's
     chunked prefill (256) and 1,024-token registered prefix identical to
     the one-shot prefill and to generate_cached, no csrc kernel launched.
     Readings, bf16: the trace's output tokens/s, TTFT p50/p90 and ms per
     output token at decode_fuse 1 and 4, a pooled step graphed and eager
     (and its idle share in the scheduler), a one-row admission, and the
     same 24 requests as closed batches of 8 through generate_ragged (an
     illustrative trace: arrivals paced in pooled steps, and the closed
     batches see every request at the start);
 26. serve_http in-process (fp32): 16 concurrent greedy clients of 8 new
     tokens in batch mode and in --continuous --decode_fuse 4 mode (4 over
     SSE, one of which disconnects after its first token): every output
     identical to the plain model's generate_cached, no error field, /stats counting the
     tokens served, the dropped request's slot freed, exact launches;
     requests/s and output tokens/s.
 27. the decoder LM's training extras (the reference-default decoder, full
     depth): EMA (one fp32 step leaves ema = 0.999 ema0 + 0.001 params bit
     for bit, over the parameters only; the update's time); gradient
     accumulation (fp32, aux 0: 4 x 2 rows against one step of 8,
     gradients within phase 12's fp32 bar, 4x one step's launches, both
     runs' peak memory); resume (fp32, bf16 moments, EMA: the state after
     2 steps saved and restored into a fresh state bit for bit, the third
     step bit-identical to the uninterrupted state's or within phase 12's
     bars; save and load seconds, bytes on disk); preemption (``python -m
     forde_tpu_torch.train.loop`` at 2 layers in a subprocess: SIGTERM
     after its first logged step -> exit 0 and a checkpoint, --resume
     goes on from its step); LoRA (rank 8, default targets: merged = base
     at init in fp32, 2 steps of ``--init_from --lora_rank`` with the
     base bit-identical and every lora_b moved, launches = 2 full steps',
     the checkpoint through serve's loader within 1e-5 of the in-memory
     merge, the LoRA step's time beside a full step's); distillation (the
     12-layer model teaching a 2-layer student, 4 x 2,048, 4 steps: KL
     and loss finite, the loss falling, launches = the teacher's forward
     + the student's step, the peak); ``eval_lm`` on the held-out corpus
     (8 x 2,048, 4 batches): fp32 lm_loss within 1e-4 of the plain model
     (no launch), --use_ema = the EMA weights' loss, bf16, tokens/s;
 28. the dual encoder's training extras (vit_b16, bf16, batch 128): fused
     steps with EMA against the same steps eager with EMA (bit for bit, or
     within phase 6's bars), the EMA's storage kept across replays; the
     aligned data rendered on the card against the numpy dataset (noise 0:
     ids and masks exact, images within 1e-6) and renders/s; ``clip_loop``
     with --use_aligned_data --eval_interval 4 --eval_batches 2 --ema_decay
     --fuse_steps 2 for 8 steps: seen_/unseen_/ema_seen_/ema_unseen_
     metrics in [0, 1], exact launches, the card's retrieval ranks equal
     to the CPU's on the same embeddings (moving only within a tie band of
     1e-5), the checkpoint restoring the step, the EMA and Adam bit for
     bit; pairs/s with and without the eval, eval ms per batch.
 29. rematerialisation: the reference-default decoder at full depth, one
     fp32 step (2 x 2,048) with remat against one without from the same
     weights (loss, gradients and stat buffers bit for bit, else phase
     12's fp32 bars; launches with the forward kernels doubled: 24
     flash_fwd, 48 small_kv_fwd); 2 fp32 LoRA steps (rank 8) with remat
     against 2 without from the same base and adapters (losses and
     adapters bit for bit, else phase 12's fp32 bars; exact launches);
     bf16 steps of 8 x 2,048 with and without remat (ms, peak); the
     long-context configuration of
     benchmarks/decoder.py (``train.loop --seq_len 8192 --remat
     --scan_layers --bf16``, the batch cut to 4, 2 steps: finite, exact
     launches of the streaming kernels and K = 960 pools, a scanned
     checkpoint with a leading axis of 12 that serve's loader reads; step
     ms, tokens/s, peak); the dual encoder (vit_b16, bf16, batch 128): one
     sensed step under "none", "block" and "mlp" from the same state
     (loss, gradients, act_stats and gradient statistics bit for bit, else
     phase 6's bars; flash_mha_fwd 24 or 48 under "block", flash_mha_bwd
     24, moment_sums 48 under every policy; ms and memory), and fused
     "mlp" steps (k = 2, a replayed call) against the same steps eager,
     bit for bit;
 30. observability: ``train.loop --profile_dir`` (2 layers of the full
     width, 2 steps) and ``clip_loop --preset vit_b16 --bf16 --fuse_steps
     2 --profile_dir`` (4 steps): each trace loads and holds device events
     of every kernel of its path (the LM's five; flash_mha_fwd,
     flash_mha_bwd, moment_sums), the step or fused call's ms with and
     without the profiler, the traces' sizes; ``--scan_layers --ema_decay``
     (2 layers, full width) for 2 steps then ``--resume`` for 1: the state
     restored bit for bit, and serving the scanned checkpoint gives the
     logits of an unrolled save of the same weights bit for bit; the NSA
     branch modules (B 2, S 2,048, d 512, 8 x 64 heads, ratio 8, top-k 64,
     fp32): card within 1e-5 relative L2 of the CPU, top-k indices equal
     on a tie-free score; ``clip_loop --plots_dir``: the files where
     matplotlib imports, else a refusal before the first step that names
     matplotlib.

 31. multi-device training on 4 thread ranks of this process on the one
     card (parallel/collectives.run_threads; one card's times, not a
     multi-GPU's), fp32 and bf16: ring attention (the ring, the zigzag and
     the non-causal ring) over (context 4) at 1 x 8 x 8,192 x 64 against
     one flash_attention call (fp32; bf16 against the same ring on the
     kernels' plain versions, the one-call reading printed), o, dq, dk, dv
     to phase 13's bars, launches per rank exact (the ring 4 flash_fwd, the
     zigzag 9, a dq and a dk/dv backward each); window_attention_cp at
     window 512, 2 flash_fwd per rank; small_kv_attention_cp at 960 pools
     and 64 top-k keys against one unsharded call (forward and backward);
     gather_pool_means_cp and topk_select_cp bit-identical to the
     unsharded functions; expert_parallel_ffn a2a and psum (E 8, D 512,
     H 2,048, top-2, factor 8, over data 2 x expert 2) equal to one rank's
     capacity dispatch; the sharded contrastive loss at vit_b16's batch of
     128 over data 4 against clip_contrastive_loss; one full-width fp32
     train_step of the reference-default decoder (cut to 8 layers, 8
     experts, NSA, mHC, carried weights) over (context 4) at 1 x 8,192 and over
     (data 2, expert 2) with ep dispatch at 4 x 2,048, against one rank's
     step to phase 12's fp32 bars, its kernels counted; then train.loop (2
     x 2,048, 2 steps) and clip_loop (vit_b16, --fuse_steps 2) in fp32
     under a one-rank NCCL group (torchrun's variables), their final losses
     bit-identical to the same CLIs alone, run beside it.
 32. tensor parallelism, FSDP and the GPipe pipeline on thread ranks of
     this process on the one card (fp32, the reference-default decoder cut
     to 8 layers, at capacity factor 8, carried weights): one LM train_step
     over (model 4)
     at 2 x 2,048, (data 2, model 2) with fsdp at 4 x 2,048, GPipe over
     (pipe 4) with 4 microbatches and (data 2, pipe 2) with 2 at 4 x 1,024,
     each against one rank's step to phase 31's LM bars, with per-rank
     parameter + moment bytes against replicated and every training kernel
     launched on every rank; for model 4 each parameter's share of the
     gradient difference, by group and by layer, and the ranks' forward
     against one rank's layer by layer (router and NSA top-k choices,
     block outputs); vit_b16's sensed step over
     (data 2, model 2) with fsdp at batch 128 to phase 12's fp32 bars, the
     specialist units whose binary step flips against one rank counted per
     layer and the act_stats of the layers no flip reaches held at 1e-5;
     greedy generate_cached over (model 2), eager, 8 new tokens on the
     first 2 serving prompts: fp32 (NSA) and int8 dense-causal tokens
     exactly one rank's, int8 NSA the share that match, each row's first
     differing position,
     each rank's int8 arrays its slices of one rank's, and the
     teacher-forced argmax agreement at 0.95 (NSA int8: 0.9 of a control,
     one rank with fp32 noise in its weights) at every position of one
     rank's graphed decode (32 new on each of the 8 prompts; dense-causal
     16).
 33. the benchmark drivers (forde_tpu_torch/bench.py and
     forde_tpu_torch/benchmarks/*.py), each main called in-process at
     reduced counts after tiny_hd128's step is held against its plain
     version (phase 6's check; bf16 against the plain fp32 step):
     bench.main (4 steps a preset, the
     fused sense 8 x 8 run once), decoder.main (2 timed steps a
     dispatch), serving_bench.main at the reference-default decoder's
     widths with 4 requests and Poisson arrivals (NSA at window 512, then
     dense-causal with its prefix mode), quant_decode.main (16 new tokens)
     and decode_scaling.main (16 new tokens at 2,048 and 16,384 positions);
     each last line one JSON object of bench.py's keys with a finite
     positive value and launches of every kernel on its path; what
     int8_matmul's padding to 17 rows costs a batch-1 decode step; and
     small_kv_fwd's fp32 route timed at decode_scaling's decode pools
     (512 and 4,096 keys) and at the default serve's decode and prefill
     shapes (LONG_KEYS_TIMING).
 34. resume on the card (vit_tiny: ViT-Ti/16 at 224 px, vision 12 x (3 x
     64), text 2 x (3 x 64), Forde-lite; fp32, batch 16, dummy data,
     sensing every step): ``clip_loop --device cpu`` for 2 steps and a
     checkpoint, restored onto the card bit for bit; ``clip_loop --resume``
     on the card for 4 steps with a Forde-lite update at step 4, exact
     launches (per step 14 flash_mha_fwd, 14 flash_mha_bwd, 28 moment_sums);
     the same 4 steps on the CPU, and a control (the CPU run with fp32
     noise in its parameters): steps 3-4's losses within phase 6's fp32
     bar; steps 5-6's losses, the final parameters and Adam's moments
     within that bar or 1.5x the control's reading; the units assigned
     otherwise after the update at most 4x the control's count (or 4);
     the card's sensed step ms, its busy time and idle share, its
     launches per step.

Prints the kernels' JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: exit code != 0.
Run with no arguments on a machine with one GPU (about 12 minutes; host
code sets much of it, so a slower host takes longer; each ``[phase]``
line gives the phase's seconds and the run's so far, and stderr names
each phase as it starts):

  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Dense bf16 tensor cores; fp32 on the CUDA cores; fp32 as three TF32
# passes on the tensor cores (a third of TF32's 495 TFLOP/s), the fused-qkv
# attention kernels' fp32 route.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}

# Phase 3 tolerances on o, per element: |o - plain| <= atol + rtol *
# (|plain| + mag), where the plain version runs in fp32 on the same input
# values (a bf16 input is widened exactly) and mag = sum_c (p_c / l) |v_c|
# (fwd_magnitudes). The kernel sums exact products in fp32 too, so fp32
# differs by summation order (atol). In bf16 the kernel rounds the weights
# p to bf16 before the product with v, as the TPU kernel does
# (forde_tpu/ops/flash_attention.py:1024): a relative 2^-9 of each term,
# at most 2^-9 * mag; and it rounds o: 2^-9 of the value. rtol 2^-8 bounds
# the sum of the two. lse is fp32 in both types.
TOL_O = {"float32": (1e-4, 0.0), "bfloat16": (1e-4, 2.0 ** -8)}  # (atol, rtol)
TOL_LSE = 1e-4
# Phase 4: least cosine of each embedding against the same weights on the
# all-plain attention path in the same dtype. fp32 differs by summation
# order only. In bf16 both paths round activations at every layer, and a
# third of the neurons are binary steps that flip when a pre-activation
# rounds across 0; the plain path in bf16 against the plain path in fp32
# is printed beside it as the control.
MIN_COSINE_FP32 = 0.99999
MIN_COSINE_BF16 = 0.997
# flash_mha_bwd against its plain version run in fp32 on the same values,
# per element |Δ| <= atol + rtol * (|plain| + mag), mag the sum of the
# absolute terms the element adds up (bwd_magnitudes). fp32 differs by
# summation order (atol, and rtol for long sums). In bf16 the kernel rounds
# p (for dv) and ds (for dq, dk) to bf16, as the TPU kernel does, each a
# relative 2^-9 of a term, and rounds its output, 2^-9 of the value:
# rtol 2^-8 bounds the sum of the two.
TOL_BWD = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 2.0 ** -8)}
# Gradients of flash_mha through the kernels against the plain path's
# autograd, fp32: summation order only.
TOL_GRAD = 1e-4
# moment_sums: fp32 sums in another order. Each thread of the kernel adds
# every 8th row of its chunk in sequence (at most 148 rows at the shapes
# below), then the 8 warps' sums are added in order, then the 22-32 chunk
# sums: each addition a rounding of at most 2^-24 of m, (148 + 8 + 32) *
# 2^-24 ~ 1.1e-5 of m.
TOL_MOMENT_REL = 1e-4
# Phase 6: one sensed step of vit_b16_hd128 at this batch, kernel path vs
# all-plain path from the same weights; per quantity the relative L2
# difference: loss, grad_norm, act_stats, grad_stats, the gradients (as
# Adam's first moment), the update (each parameter leaf's change, median
# leaf) and the parameters after it. Beyond summation order, the
# multiplex's kinks at z = 0 (relu's derivative, the binary step) turn
# fp32 noise in a pre-activation near 0 into a whole unit of change, and
# Adam's first step, ~lr * sign(g), flips with the sign of a gradient at
# noise level, so the update differs by far more than the gradients. The
# parameters dilute that by |update| / |params| ~ 2.5e-3: an optimizer
# that leaves the weights unchanged reads ~2.5e-3 on params and 1.0 on the
# update. Readings (the same in every run): fp32 loss 8.0e-5, grad_norm
# 6.2e-5, act_stats 4.2e-5, grad_stats 2.3e-4, grads 7.1e-3, update
# 7.5e-2, params 1.9e-4; bf16 2.5e-3, 7.4e-3, 2.1e-3, 7.1e-3, 0.180,
# 0.490, 1.24e-3; control, plain bf16 vs plain fp32: 3.0e-4, 1.02e-2,
# 4.1e-3, 7.3e-3, 0.201, 0.517, 1.32e-3. fp32 bars at 4-10x the reading,
# those of update and params below a no-op optimizer's. bf16 bars between the reading
# and the control where the two differ by 10% or more (grad_norm,
# act_stats, grads: these separate lower precision); elsewhere (loss is
# above the control; grad_stats, update and params lie within 2-6% of it)
# at 2-4x the reading, or below a no-op optimizer's reading (update,
# params).
PARITY_BATCH = 16
PARITY_TOL = {
    "fp32": {"loss": 1e-3, "grad_norm": 1e-3, "act_stats": 5e-4, "grad_stats": 2e-3,
             "grads": 3e-2, "update": 0.3, "params": 1e-3},
    "bf16": {"loss": 1e-2, "grad_norm": 9e-3, "act_stats": 3e-3, "grad_stats": 1.5e-2,
             "grads": 0.19, "update": 0.75, "params": 2e-3},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    that cycle through ``fns`` (one closure per input copy, so that the
    inputs of consecutive calls do not sit in L2)."""
    import torch

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(b, s, h, d, dtype_name, lens=None, backward=False) -> tuple:
    """(ms by bytes, ms by operations) of one fused-qkv attention forward
    or backward at the card's peaks. Bytes, forward: qkv read once, o and
    lse written once; backward: qkv, do and lse read, dqkv written; lens
    read. Operations: 2 * D per (query, visible key, head) for each
    product, two forward (q k^T, p v) and five backward (q k^T, do v^T,
    p^T do, ds^T q, ds k), counting the keys these inputs leave visible."""
    elem = 2 if dtype_name == "bfloat16" else 4
    qkv_bytes, o_bytes = b * s * 3 * h * d * elem, b * s * h * d * elem
    moved = (2 if backward else 1) * qkv_bytes + o_bytes + b * h * s * 4
    keys = b * s if lens is None else int(lens.clamp(max=s).sum())
    if lens is not None:
        moved += 4 * b
    ops = (10.0 if backward else 4.0) * h * d * s * keys
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def bound(bytes_ms: float, ops_ms: float) -> tuple:
    """(bound_ms, bound_by): the larger of the two times."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# Every kernel of the main paths: csrc/<name>.cu.
KERNEL_SOURCES = ("flash_mha_fwd", "flash_mha_bwd", "moment_sums", "flash_fwd", "small_kv_fwd",
                  "flash_bwd", "small_kv_bwd", "topk_replay")
# Libraries whose bf16 route runs on the tensor cores: their SASS must hold
# HMMA instructions, and their tensor-core kernels (*_tc_kernel) must not
# spill. flash_bwd has two: the dq kernel and the dk/dv kernel.
TENSOR_CORE_SOURCES = ("flash_mha_fwd", "flash_mha_bwd", "flash_fwd", "flash_bwd",
                       "small_kv_fwd", "small_kv_bwd")


# Libraries whose fp32 route runs on the tensor cores in three TF32 passes,
# and its kernels: each must be listed among the tensor-core kernels at
# D = 64 and D = 128, and the library's SASS must hold TF32 HMMA
# instructions.
TF32_KERNELS = {
    "flash_mha_fwd": ("flash_mha_fwd_tf32_tc_kernel",),
    "flash_mha_bwd": ("mha_bwd_dq_tf32_tc_kernel", "mha_bwd_dkdv_tf32_tc_kernel"),
    "small_kv_bwd": ("skv_bwd_dq_tf32_tc_kernel", "skv_bwd_dkdv_tf32_tc_kernel"),
    "flash_bwd": ("flash_bwd_dq_tf32_tc_kernel", "flash_bwd_dkv_tf32_tc_kernel"),
    "flash_fwd": ("flash_fwd_tf32_tc_kernel",),
}


@functools.lru_cache(maxsize=None)
def sass(name: str) -> str:
    """The SASS of lib<name>, by the cuobjdump beside nvcc (once a run: the
    libraries are built once)."""
    from forde_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "--dump-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def hmma_count(name: str, tf32: bool = False) -> int:
    """HMMA instructions in the SASS of lib<name> (with ``tf32``, those
    that take TF32 operands)."""
    return sum("HMMA" in line and (not tf32 or ".TF32" in line)
               for line in sass(name).splitlines())


def sass_mix(name: str, kernel: str) -> dict:
    """{function: Counter of opcodes} of each function of lib<name> whose
    mangled name holds ``kernel``: the static instruction mix, e.g. how
    many instructions the fp32 route issues beside its TF32 HMMA."""
    mix, func = {}, None
    for line in sass(name).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m[1] if kernel in m[1] else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and func:
            mix.setdefault(func, Counter())[m[1]] += 1
    return mix


def tc_kernel_resources(ptxas_log: str) -> list:
    """(kernel, registers, spill bytes) of each tensor-core kernel
    (``*_tc_kernel``, the fp32 routes' ``*_tf32_tc_kernel`` among them) in
    an ``nvcc -Xptxas -v`` log."""
    out, current = [], None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for \S*?([a-z][a-z_]*?(?:_tf32)?_tc_kernel)(?:ILi(\d+)E)?",
                      line)
        if m:
            current = [m[1] + (f"<{m[2]}>" if m[2] else ""), None, 0]
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current[2] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current[1] = int(m[1])
            out.append(tuple(current))
            current = None
    return out


def phase_build():
    """One nvcc per source, all started together; ptxas's registers and
    spills per kernel, 0 spill bytes in the tensor-core kernels, and the
    HMMA count of the tensor-core libraries."""
    from concurrent.futures import ThreadPoolExecutor

    from forde_tpu_torch.kernels import build

    # A tensor-core library built before this run left no ptxas log to
    # read: build it anew.
    for name in TENSOR_CORE_SOURCES:
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.load, KERNEL_SOURCES))
    log(f"[build] {len(KERNEL_SOURCES)} kernel(s) ready in {time.perf_counter() - t0:.2f} s "
        f"under {build.BUILD_DIR}")
    for name, (secs, text) in build.build_log.items():
        log(f"[build] nvcc {name}: {secs:.2f} s")
        for line in text.splitlines():
            if ("Function properties for" in line or "registers" in line or "spill" in line
                    or "error" in line):
                log(f"[build]   {line.strip()}")
    with ThreadPoolExecutor(len(TENSOR_CORE_SOURCES)) as pool:
        list(pool.map(sass, TENSOR_CORE_SOURCES))
    for name in TENSOR_CORE_SOURCES:
        count = hmma_count(name)
        log(f"[build] lib{name}: {count} HMMA instructions in its SASS")
        if count == 0:
            raise AssertionError(f"lib{name} has no tensor-core (HMMA) instruction")
        if name not in build.build_log:
            raise AssertionError(f"lib{name} was not built in this run: no ptxas log to read")
        resources = tc_kernel_resources(build.build_log[name][1])
        for kernel, regs, spilled in resources:
            log(f"[build] {name} {kernel}: {regs} registers, {spilled} spill bytes")
            if spilled:
                raise AssertionError(f"{kernel} of lib{name} spills {spilled} bytes")
        if name in TF32_KERNELS:
            tf32 = hmma_count(name, tf32=True)
            log(f"[build] lib{name}: {tf32} TF32 HMMA instructions in its SASS")
            if tf32 == 0:
                raise AssertionError(f"lib{name} has no TF32 HMMA instruction: its fp32 route "
                                     "is not on the tensor cores")
            found = {kernel for kernel, _, _ in resources}
            for kernel in TF32_KERNELS[name]:
                for d in (64, 128):
                    if f"{kernel}<{d}>" not in found:
                        raise AssertionError(f"lib{name}: no ptxas record of {kernel}<{d}>")
                for func, mix in sass_mix(name, kernel).items():
                    d = re.search(r"ILi(\d+)E", func)
                    log(f"[build] {kernel}<{d[1] if d else '?'}> SASS: {sum(mix.values())} "
                        f"instructions, {mix['HMMA.1688.F32.TF32']} TF32 HMMA; "
                        + ", ".join(f"{op} {n}" for op, n in mix.most_common(8)))


# (name, B, S, H, D, kv_lens, causal, window): the vision and text shapes
# of vit_b16_hd128 and of vit_b16 (the training CLI's preset), the S=197
# shape that needs kv_bound, the causal + window option, both presets'
# shapes at the batch of 128 (vit_b16_hd128's vision S = 197 padded to 200
# with kv_bound 197, as the path runs it), the shortest S and the longest
# (MAX_FUSED_SEQ) at D = 128.
CHECK_CASES = [
    ("vision_s200_h6_d128", 4, 200, 6, 128, None, False, None),
    ("text_s64_h4_d128_lens", 4, 64, 4, 128, [0, 1, 17, 64], False, None),
    ("text_s64_h8_d64_lens", 4, 64, 8, 64, [0, 1, 17, 64], False, None),
    ("s197_h12_d64_kv_bound", 2, 197, 12, 64, None, False, None),
    ("s128_h2_d64_causal_window32", 2, 128, 2, 64, None, True, 32),
    ("s200_h2_d128_causal_window32_lens", 3, 200, 2, 128, [200, 0, 5], True, 32),
    ("vision_b128_s200_h12_d64", 128, 200, 12, 64, None, False, None),
    ("text_b128_s64_h8_d64_lens", 128, 64, 8, 64, [0, 1, 17, 64] * 32, False, None),
    ("vision_b128_s200_h6_d128", 128, 197, 6, 128, None, False, None),
    ("text_b128_s64_h4_d128_lens", 128, 64, 4, 128, [0, 1, 17, 64] * 32, False, None),
    ("s8_h2_d128_lens", 3, 8, 2, 128, [8, 0, 3], False, None),
    ("s512_h2_d128_lens", 2, 512, 2, 128, [512, 300], False, None),
    # vit_tiny (phase 34): 3 heads of 64 at batch 16
    ("tiny_vision_b16_s197_h3_d64", 16, 197, 3, 64, None, False, None),
    ("tiny_text_b16_s64_h3_d64_lens", 16, 64, 3, 64, [0, 1, 17, 64] * 4, False, None),
]
# flash_mha on CUDA tensors against the plain attention path: (name, B, S,
# H, D, kv_lens); S=197 goes through the entry point's padding to 200.
GRAD_CASES = [
    ("vision_s200_h6_d128", 2, 200, 6, 128, None),
    ("text_s64_h4_d128_lens", 4, 64, 4, 128, [0, 1, 17, 64]),
    ("text_s64_h8_d64_lens", 4, 64, 8, 64, [0, 1, 17, 64]),
    ("s197_h12_d64", 2, 197, 12, 64, None),
    ("tiny_s197_h3_d64", 2, 197, 3, 64, None),
]


def fwd_magnitudes(qkv, lens, h, d, scale, window, causal, kv_bound):
    """(B, S, H*D) fp32: per element of o the sum of the absolute terms
    it adds up, sum_c (p_c / l) |v_c|, with the plain version's fp32
    weights. A rounding of p by a relative eps moves o by at most eps
    times this."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) * scale
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        scores = scores.masked_fill(~mask, fa.MASK_VALUE)
    w = torch.softmax(scores, dim=-1)
    return (w @ v.abs()).transpose(1, 2).reshape(b, s, h * d)


def bwd_magnitudes(qkv, lens, lse, do, h, d, scale, window, causal, kv_bound):
    """(B, S, 3*H*D) fp32: per element of dq, dk, dv the sum of the
    absolute terms it adds up (|ds|·|k|, |ds|ᵀ·|q|, |p|ᵀ·|do|), with the
    plain version's fp32 p and ds. A rounding of p or ds by a relative
    eps moves each element by at most eps times this."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    do4 = do.reshape(b, s, h, d).transpose(1, 2)
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    dp = do4 @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).abs()
    mag = torch.stack([ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(),
                       p.transpose(-1, -2) @ do4.abs()], dim=2)
    return mag.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * h * d)


def held_against(got, want, atol, rtol_term) -> tuple:
    """(max |got - want|, worst |got - want| / (atol + rtol_term))."""
    diff = (got.float() - want).abs()
    return diff.max().item(), (diff / (atol + rtol_term)).max().item()


def phase_check_attention(device) -> tuple:
    """flash_mha_fwd and flash_mha_bwd against their plain versions run in
    fp32 on the same (exactly widened) inputs, the backward from the kernel
    forward's lse, at CHECK_CASES in fp32 and bf16; then flash_mha on CUDA
    tensors against the plain attention path, output and gradients (the
    regression check for an output with no grad_fn). Returns the worst
    max |error| of the forward and of the backward."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    worst_fwd = worst_bwd = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name, b, s, h, d, lens, causal, window in CHECK_CASES:
        x = torch.randn(b, s, 3 * h * d, device=device, generator=gen) * 0.5
        g = torch.randn(b, s, h * d, device=device, generator=gen)
        lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
        s_pad = -(-s // 8) * 8
        kv_bound = s if (s_pad != s and not causal and lens is None) else None
        if s_pad != s:
            x = F.pad(x, (0, 0, 0, s_pad - s))
            g = F.pad(g, (0, 0, 0, s_pad - s))
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qkv, do = x.to(dt).contiguous(), g.to(dt).contiguous()
            args = (h, d, d ** -0.5, window, causal, kv_bound)
            o, lse = fa.flash_mha_fwd(qkv, lens_t, *args)
            dqkv = fa.flash_mha_bwd(qkv, lens_t, lse, do, *args)
            o_ref, lse_ref = fa.flash_mha_fwd_reference(qkv.float(), lens_t, *args)
            fwd_mag = fwd_magnitudes(qkv.float(), lens_t, *args)
            dqkv_ref = fa.flash_mha_bwd_reference(qkv.float(), lens_t, lse, do.float(), *args)
            mag = bwd_magnitudes(qkv.float(), lens_t, lse, do.float(), *args)
            torch.cuda.synchronize()

            atol, rtol = TOL_O[dtype_name]
            err, ratio = held_against(o, o_ref, atol, rtol * (o_ref.abs() + fwd_mag))
            lse_err = (lse - lse_ref).abs().max().item()
            ok = ratio <= 1.0 and lse_err <= TOL_LSE
            log(f"[check] fwd {name} {dtype_name}: max|o - plain| {err:.3e}, worst "
                f"|o - plain| / ({atol:g} + {rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), "
                f"max|lse - plain| {lse_err:.3e} (tol {TOL_LSE:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_mha_fwd disagrees with its plain version: {name} {dtype_name}")
            worst_fwd = max(worst_fwd, err)

            atol, rtol = TOL_BWD[dtype_name]
            err, ratio = held_against(dqkv, dqkv_ref, atol, rtol * (dqkv_ref.abs() + mag))
            finite = bool(torch.isfinite(dqkv).all())
            ok = ratio <= 1.0 and finite
            log(f"[check] bwd {name} {dtype_name}: max|dqkv - plain| {err:.3e}, worst "
                f"|Δ| / ({atol:g} + {rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), "
                f"finite {finite} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_mha_bwd disagrees with its plain version: {name} {dtype_name}")
            worst_bwd = max(worst_bwd, err)

            if dtype_name == "float32":
                # Each output summed in a fixed order, no atomics: a second
                # call gives the same bits.
                o2, lse2 = fa.flash_mha_fwd(qkv, lens_t, *args)
                dqkv2 = fa.flash_mha_bwd(qkv, lens_t, lse, do, *args)
                same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                        and torch.equal(dqkv, dqkv2))
                log(f"[check] {name} float32: two calls bit-identical {same} "
                    f"{'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError(f"{name}: two fp32 calls of flash_mha_fwd/bwd differ")

            if lens is not None and 0 in lens:
                empty = lens_t == 0
                if o[empty].abs().max().item() != 0.0 or dqkv[empty].abs().max().item() != 0.0:
                    raise AssertionError(f"{name}: a kv_lens == 0 sample has a non-zero o or gradient")

    # flash_mha on CUDA tensors: autograd through the kernels against the
    # plain attention path (impl="reference"), fp32, same upstream weights.
    for name, b, s, h, d, lens in GRAD_CASES:
        x = torch.randn(b, s, 3 * h * d, device=device, generator=gen) * 0.5
        w = torch.randn(b, s, h * d, device=device, generator=gen)
        lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
        outs, grads = [], []
        for impl in ("auto", "reference"):
            qkv = x.clone().requires_grad_(True)
            o = fa.flash_mha(qkv, h, d, kv_lens=lens_t, impl=impl)
            if o.grad_fn is None:
                raise AssertionError(f"flash_mha(impl={impl!r}) output has no grad_fn")
            (o * w).sum().backward()
            if qkv.grad is None:
                raise AssertionError(f"flash_mha(impl={impl!r}): qkv.grad is missing")
            outs.append(o.detach())
            grads.append(qkv.grad)
        o_err = (outs[0] - outs[1]).abs().max().item()
        err = (grads[0] - grads[1]).abs().max().item()
        ok = o_err <= TOL_O["float32"][0] and err <= TOL_GRAD
        log(f"[check] flash_mha on CUDA {name}: grad_fn present, max|o - plain path| "
            f"{o_err:.3e} (tol {TOL_O['float32'][0]:g}), max|dqkv - plain path| {err:.3e} "
            f"(tol {TOL_GRAD:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_mha disagrees with the plain path: {name}")
    return worst_fwd, worst_bwd


# (name, N, F, dtype): the vision and text z of vit_b16_hd128 at batch 128,
# fp32, an N that is not a multiple of the row chunk, and F not a multiple
# of the kernel's vector (8 bf16 or 4 fp32 columns: the scalar loads).
MOMENT_CASES = [
    ("vision_z", 25600, 3072, "bfloat16"),
    ("text_z", 8192, 2048, "bfloat16"),
    ("text_z_fp32", 8192, 2048, "float32"),
    ("odd_n", 12345, 3072, "bfloat16"),
    ("odd_f", 8192, 2051, "bfloat16"),
    ("odd_f_fp32", 1000, 1001, "float32"),
    ("tiny_vision_z_fp32", 3152, 768, "float32"),  # vit_tiny at batch 16 (phase 34)
]


def phase_check_moments(device) -> float:
    """moment_sums against its plain version (fp32 sums of the same
    values). Per element |Δ| <= TOL_MOMENT_REL * m, m the sum of the
    absolute terms (Σ|x| for Σ|x| and Σx, Σx² for Σx²); two calls
    bit-identical; a misaligned x refused."""
    import torch

    from forde_tpu_torch.ops import stat_sums

    worst = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    for name, n, f, dtype_name in MOMENT_CASES:
        x = (torch.randn(n, f, device=device, generator=gen) + 0.25).to(getattr(torch, dtype_name))
        got = stat_sums.moment_sums(x)
        same = torch.equal(stat_sums.moment_sums(x), got)
        log(f"[check] moment_sums {name} {dtype_name}: two calls bit-identical {same} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"moment_sums is not deterministic: {name}")
        want = stat_sums.moment_sums_reference(x)
        torch.cuda.synchronize()
        mag = want[[0, 1, 0]]
        diff = (got - want).abs()
        err = diff.max().item()
        ratio = (diff / (TOL_MOMENT_REL * mag)).max().item()
        ok = ratio <= 1.0
        log(f"[check] moment_sums {name} ({n}, {f}) {dtype_name}: max|Δ| {err:.3e}, worst "
            f"|Δ| / ({TOL_MOMENT_REL:g}·m) {ratio:.3f} (tol 1) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"moment_sums disagrees with its plain version: {name}")
        worst = max(worst, err)
    check_misaligned_refused("moment_sums", lambda x, lse: stat_sums.moment_sums(x), device)
    return worst


def main_path_config():
    from forde_tpu_torch.core.config import DTypePolicy, vit_b16_hd128_config

    return vit_b16_hd128_config().replace(dtypes=DTypePolicy.bf16())


def build_model(cfg, device):
    """Seeded random weights, and a seeded mix of neuron types (every
    multiplex branch runs)."""
    import torch

    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    gen = torch.Generator(device=device).manual_seed(SEED)
    model = FORDEDualEncoder(cfg.replace(sense=False), device=device, generator=gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("neuron_assignments"):
                buf.copy_(torch.randint(0, 3, buf.shape, device=device, generator=gen))
    return model.eval()


def phase_main_path(device, workdir) -> dict:
    import torch

    from forde_tpu_torch import embed, interop, kernels
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
    from forde_tpu_torch.train.checkpoint import save_params

    cfg = main_path_config()
    model = build_model(cfg, device)
    ckpt = os.path.join(workdir, "ckpt")
    npz = interop.flatten(interop.state_dict_to_flax(model.state_dict()))
    save_params(ckpt, cfg, npz, {"step": 0})

    rng = np.random.RandomState(SEED)
    images = [rng.rand(224, 224, 3).astype(np.float32) for _ in range(3)]
    images.append((rng.rand(256, 192, 3) * 255).astype(np.uint8))  # resized
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(workdir, f"img{i}.npy"))
        np.save(paths[-1], img)
    texts = ";".join(
        ",".join(str(t) for t in rng.randint(1, cfg.vocab_size, n))
        for n in (5, 17, 64, 80)  # the last one is truncated to 64
    )
    prefix = os.path.join(workdir, "emb")
    argv = ["--checkpoint_dir", ckpt, "--image_npy", ",".join(paths),
            "--text_ids", texts, "--out", prefix]

    kernels.reset_launches()
    t0 = time.perf_counter()
    embed.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"[main] embed.main (vit_b16_hd128 bf16, 4 images + 4 texts) took "
        f"{secs:.2f} s including the checkpoint load; launches {launches}")

    img = np.load(prefix + "_image.npy")
    txt = np.load(prefix + "_text.npy")
    if img.shape != (4, 512) or txt.shape != (4, 512):
        raise AssertionError(f"embedding shapes {img.shape} {txt.shape}")
    if not (np.isfinite(img).all() and np.isfinite(txt).all()):
        raise AssertionError("non-finite embeddings")
    per_pass = cfg.vision.num_layers + cfg.text.num_layers
    if launches.get("flash_mha_fwd", 0) != per_pass:
        raise AssertionError(
            f"flash_mha_fwd launched {launches.get('flash_mha_fwd', 0)} times, "
            f"expected {per_pass} (one per layer of both towers)"
        )

    # The same weights and inputs through the other paths: kernel or
    # all-plain attention, in bf16 and in fp32.
    from forde_tpu_torch.core.config import DTypePolicy

    x = torch.from_numpy(embed._load_images(",".join(paths), cfg.image_size)).to(device)
    ids, mask = (torch.from_numpy(a).to(device) for a in embed._load_texts(texts, cfg.max_text_len))

    def run(dtypes, impl):
        m = FORDEDualEncoder(
            cfg.replace(sense=False, dtypes=dtypes, attention_kernel_impl=impl),
            device=device,
        )
        m.load_state_dict(model.state_dict())
        with torch.inference_mode():
            out = m.eval().encode_image(x), m.encode_text(ids, mask)
        return np.concatenate([o.cpu().numpy() for o in out])

    def cosine(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))

    got = np.concatenate([img, txt])
    plain32 = run(DTypePolicy.fp32(), "reference")
    plain16 = run(DTypePolicy.bf16(), "reference")
    cos32 = cosine(run(DTypePolicy.fp32(), "auto"), plain32).min()
    cos_bf16 = cosine(got, plain16).min()
    cos_plain_bf16 = cosine(plain16, plain32).min()
    log(f"[main] min cosine, kernel path vs plain path: fp32 {cos32:.7f} "
        f"(tol >= {MIN_COSINE_FP32}), bf16 {cos_bf16:.6f} (tol >= {MIN_COSINE_BF16}); "
        f"control, plain bf16 vs plain fp32: {cos_plain_bf16:.6f}, "
        f"kernel bf16 vs plain fp32: {cosine(got, plain32).min():.6f}")
    if not (cos32 >= MIN_COSINE_FP32 and cos_bf16 >= MIN_COSINE_BF16):
        raise AssertionError(f"kernel path vs plain path: cosine {cos32}, {cos_bf16}")
    return {"launches": launches, "model": model, "cfg": cfg,
            "min_cosine_fp32": float(cos32), "min_cosine_bf16": float(cos_bf16),
            "min_cosine_plain_bf16_vs_fp32": float(cos_plain_bf16)}


def phase_encode_timing(device, model, cfg) -> dict:
    """Encode time of 128 images + 128 texts, kernel path vs all-plain
    attention path in turns, and one encode under the profiler."""
    import torch

    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    batch = 128
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    images = torch.rand(batch, cfg.image_size, cfg.image_size, 3, device=device, generator=gen)
    lens = torch.randint(8, cfg.max_text_len + 1, (batch,), device=device, generator=gen)
    pos = torch.arange(cfg.max_text_len, device=device)
    mask = (pos[None, :] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, cfg.vocab_size, (batch, cfg.max_text_len), device=device,
                        generator=gen) * mask

    def encode(m):
        with torch.inference_mode():
            m.encode_image(images)
            m.encode_text(ids, mask)

    def encode_ms(m, reps=5):
        for _ in range(2):
            encode(m)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            encode(m)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    plain = FORDEDualEncoder(
        cfg.replace(sense=False, attention_kernel_impl="reference"), device=device
    )
    plain.load_state_dict(model.state_dict())
    plain.eval()
    # plain, kernel, kernel, plain: the two paths share the card in turns.
    p1, k1, k2, p2 = (encode_ms(m) for m in (plain, model, model, plain))
    kernel_ms = min(k1, k2)
    plain_ms = min(p1, p2)
    log(f"[time] encode 128 images + 128 texts: kernel path {k1:.3f} / {k2:.3f} ms, "
        f"plain path {p1:.3f} / {p2:.3f} ms (median of 5 each)")
    log(f"[time] pairs/s: kernel path {batch / kernel_ms * 1e3:.1f}, "
        f"plain path {batch / plain_ms * 1e3:.1f}")
    profile_device(lambda: encode(model), "one encode (128 images + 128 texts)")
    return {"encode_ms": kernel_ms, "plain_encode_ms": plain_ms,
            "pairs_per_s": batch / kernel_ms * 1e3}


def device_ms(fns, reps: int = 20, spin_cycles: int = 200_000_000) -> float:
    """Mean device time of one call: ``reps`` calls cycling through ``fns``
    are queued behind a spin kernel (``torch.cuda._sleep``, ~0.1 s), so the
    card runs them back to back and CUDA events around them time the card
    alone. cuda_ms reads the host instead when a call is shorter than its
    launch path."""
    import torch

    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(run, label: str, top: int = 12) -> dict:
    """Device time by kernel over one call of ``run`` (after one warm-up
    call) under torch.profiler, and the device's idle share of the wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ms = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        kernels_ms.append((total / 1e3, evt.count, evt.key))
    kernels_ms.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels_ms)
    idle = 1 - busy_ms / wall_ms
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}")
    for ms, count, name in kernels_ms[:top]:
        log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.3f}  x{count:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle}


# The training path's command line (phase 5): full width of vit_b16 (the
# CLI's preset: vision 12 x 64, text 8 x 64 heads), bf16, batch 128, the
# GMM slow loop.
TRAIN_ARGV = [
    "--preset", "vit_b16", "--bf16", "--use_dummy_data", "--dummy_pool", "2",
    "--batch_size", "128", "--num_steps", "16", "--sense_interval", "8",
    "--slow_loop_interval", "8", "--moment_dtype", "bfloat16", "--warmup_steps", "4",
    "--log_interval", "8",
]


def launches_per_step(cfg, sensed: bool) -> dict:
    """Kernel launches of one training step: attention forward and
    backward once per layer of both towers; two moment sums per
    StatefulLayer (activations, gradient tap) on a sensed step. vit_b16
    (12 + 8 layers): 20, 20 and 40 sensed; vit_tiny (12 + 2, phase 34): 14,
    14 and 28 sensed."""
    layers = cfg.vision.num_layers + cfg.text.num_layers
    return {"flash_mha_fwd": layers, "flash_mha_bwd": layers,
            "moment_sums": 2 * layers if sensed else 0}


def phase_train_path(workdir) -> dict:
    import torch

    from forde_tpu_torch import embed, kernels
    from forde_tpu_torch.train import clip_loop

    ckpt = os.path.join(workdir, "train_ckpt")
    argv = TRAIN_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    args = clip_loop.build_parser().parse_args(argv)
    cfg = clip_loop.config_from_args(args)
    cwd = os.getcwd()
    os.chdir(workdir)  # the loop's metrics land in ./runs
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = clip_loop.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.chdir(cwd)
    loss = out["final_metrics"]["loss/contrastive"]
    log(f"[train] clip_loop.main ({' '.join(TRAIN_ARGV)}) took {secs:.2f} s; "
        f"final loss {loss:.4f}, launches {launches}")
    if not np.isfinite(loss) or out["step"] != args.num_steps:
        raise AssertionError(f"training path: loss {loss}, steps {out['step']}")

    n_sensed = len(range(0, args.num_steps, args.sense_interval))
    n_unsensed = args.num_steps - n_sensed
    sensed, unsensed = launches_per_step(cfg, True), launches_per_step(cfg, False)
    want = {k: n_sensed * sensed[k] + n_unsensed * unsensed[k] for k in sensed}
    if launches != want:
        raise AssertionError(
            f"training path launches {launches}, expected {want} "
            f"({n_sensed} sensed steps x {sensed} + {n_unsensed} unsensed x {unsensed})"
        )

    layers = cfg.vision.num_layers + cfg.text.num_layers
    updates = out["brain_updates"]
    for u in updates:
        log(f"[train] brain update @ {u['step']}: {u['latency_ms']:.2f} ms, skipped "
            f"{u['skipped']}, |grad_stats| {u['grad_stats_abs_sum_before']:.4g} -> "
            f"{u['grad_stats_abs_sum_after']:.4g}, sensed layer-steps "
            f"{u['sensed_steps_before']} -> {u['sensed_steps_after']}")
    if [u["step"] for u in updates] != [8, 16] or any(
        u["skipped"] or not u["grad_stats_abs_sum_before"] > 0
        or u["grad_stats_abs_sum_after"] != 0
        or u["sensed_steps_before"] != layers or u["sensed_steps_after"] != 0
        for u in updates
    ):
        raise AssertionError(f"brain updates of the training path: {updates}")

    # The trained checkpoint through the serving entry point.
    rng = np.random.RandomState(SEED + 4)
    img_path = os.path.join(workdir, "train_img.npy")
    np.save(img_path, rng.rand(cfg.image_size, cfg.image_size, 3).astype(np.float32))
    prefix = os.path.join(workdir, "train_emb")
    embed.main(["--checkpoint_dir", ckpt, "--image_npy", img_path,
                "--text_ids", "12,99,407;7,5", "--out", prefix])
    img, txt = np.load(prefix + "_image.npy"), np.load(prefix + "_text.npy")
    if img.shape != (1, cfg.embed_dim) or txt.shape != (2, cfg.embed_dim) or not (
        np.isfinite(img).all() and np.isfinite(txt).all()
    ):
        raise AssertionError(f"serving the trained checkpoint: {img.shape} {txt.shape}")
    log(f"[train] embed.main served the trained checkpoint: image {img.shape}, "
        f"text {txt.shape}, finite")
    return {"launches": launches, "seconds": secs, "final_loss": loss,
            "brain_update_ms": [u["latency_ms"] for u in updates]}


def check_prefetch(device) -> None:
    """The training CLI's data route without --dummy_pool: batches
    assembled in pinned host memory and copied ahead on a side stream
    arrive on the card intact."""
    import torch

    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.data.vl import SyntheticVLDataset

    cfg = main_path_config()
    dataset = SyntheticVLDataset(
        16, 4, image_size=cfg.image_size, text_len=cfg.max_text_len,
        vocab_size=cfg.vocab_size, seed=SEED,
    )
    n = 0
    for host, dev in zip(dataset, prefetch_to_device(iter(dataset), device)):
        torch.cuda.synchronize()
        for k, v in host.items():
            if dev[k].device != device or not np.array_equal(dev[k].cpu().numpy(), v):
                raise AssertionError(f"prefetch_to_device: batch {n} {k} differs")
        n += 1
    log(f"[train] prefetch_to_device delivered {n} batches intact")


class plain_moment_sums:
    """Context: the StatefulLayers' moment sums take the plain version on
    CUDA tensors too (the all-plain path of phases 6 and 7)."""

    def __enter__(self):
        from forde_tpu_torch.ops import stat_sums

        self.saved = stat_sums.moment_sums
        stat_sums.moment_sums = stat_sums.moment_sums_reference
        return self

    def __exit__(self, *exc):
        from forde_tpu_torch.ops import stat_sums

        stat_sums.moment_sums = self.saved


def training_batch(cfg, batch: int, device, seed: int) -> dict:
    import torch

    from forde_tpu_torch.data.vl import SyntheticVLDataset

    host = next(iter(SyntheticVLDataset(
        batch, 1, image_size=cfg.image_size, text_len=cfg.max_text_len,
        vocab_size=cfg.vocab_size, seed=seed,
    )))
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def train_state(cfg, reference_state, device, impl="auto", moment_dtype="bfloat16"):
    """A fresh train state at ``cfg`` (sense on, attention ``impl``) whose
    model holds ``reference_state`` (a serving model's: the stat buffers
    start at 0)."""
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
    from forde_tpu_torch.train.clip_step import create_clip_train_state

    cfg = cfg.replace(sense=True, attention_kernel_impl=impl)
    model = FORDEDualEncoder(cfg, device=device)
    missing, unexpected = model.load_state_dict(reference_state, strict=False)
    if unexpected or not all(k.endswith(("act_stats", "step_count")) for k in missing):
        raise KeyError(f"train state: unexpected {unexpected}, missing {missing}")
    return create_clip_train_state(
        cfg, None, 1e-4, 0.01, warmup_steps=0, moment_dtype=moment_dtype, model=model
    )


def phase_step_parity(device, cfg=None, label="parity", bf16_as_precise=False) -> dict:
    """One sensed step of vit_b16_hd128 (or of ``cfg``) on the kernel path
    against one on the all-plain path (plain attention, plain moment sums)
    from the same weights and batch; fp32 and bf16. Then the launches of
    one sensed and one unsensed step on the kernel path.

    The bf16 bars are vit_b16_hd128's (PARITY_TOL). ``bf16_as_precise``
    holds another configuration's bf16 step against the plain fp32 step
    instead: each quantity of the kernel path in bf16 within its bf16 bar,
    or within BF16_AS_PRECISE of the plain bf16 path's own distance from
    fp32 (the control; the rule the backward kernels are held to)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.train.clip_step import clip_train_step, make_nosense_step

    cfg = (main_path_config() if cfg is None else cfg).replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, PARITY_BATCH, device, SEED + 5)

    def one_step(dtypes, impl):
        state = train_state(cfg.replace(dtypes=dtypes), weights, device, impl, moment_dtype=None)
        before = [p.detach().float().clone() for p in state.optimizer.params]
        if impl == "reference":
            with plain_moment_sums():
                state, m = clip_train_step(state, batch)
        else:
            state, m = clip_train_step(state, batch)
        layers = stateful_layers(state.model).values()
        return {
            "loss": m["loss/contrastive"].reshape(1),
            "grad_norm": m["training/grad_norm"].reshape(1),
            "act_stats": torch.cat([layer.act_stats.flatten() for layer in layers]),
            "grad_stats": torch.cat([g.flatten() for g in state.grad_stats.values()]),
            # Adam's first moment after one step: (1 - b1) * the clipped gradient
            "grads": torch.cat([m.flatten() for m in state.optimizer.mu]),
            # the change of each parameter leaf, and the parameters after it
            "update": [p.detach().float() - b for p, b in zip(state.optimizer.params, before)],
            "params": torch.cat([p.detach().flatten() for p in state.optimizer.params]),
        }

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def rel(a, b):
        """Relative L2 per quantity; for the update, the median leaf's. Not
        held to a bar: the update's worst leaf and whole vector, and the
        share of gradient elements whose sign differs (Adam's first step
        moves each weight by about lr * sign(g), so a share f of flipped
        signs gives the whole update a relative L2 near 2 * sqrt(f))."""
        out = {k: rel_l2(a[k], b[k]) for k in a if k != "update"}
        leaves = [rel_l2(x, y) for x, y in zip(a["update"], b["update"])]
        out["update"] = float(np.median(leaves))
        out["update_worst_leaf"] = max(leaves)
        out["update_whole"] = rel_l2(torch.cat([x.flatten() for x in a["update"]]),
                                     torch.cat([y.flatten() for y in b["update"]]))
        out["grad_sign_flips"] = float((a["grads"].sign() != b["grads"].sign()).float().mean())
        return out

    k32 = one_step(DTypePolicy.fp32(), "auto")
    p32 = one_step(DTypePolicy.fp32(), "reference")
    k16 = one_step(DTypePolicy.bf16(), "auto")
    p16 = one_step(DTypePolicy.bf16(), "reference")
    readings = {"fp32": rel(k32, p32), "bf16": rel(k16, p16), "control": rel(p16, p32),
                "kernel_bf16_vs_plain_fp32": rel(k16, p32)}
    for name, r in readings.items():
        what = {"fp32": "kernel vs plain, fp32", "bf16": "kernel vs plain, bf16",
                "control": "control: plain bf16 vs plain fp32",
                "kernel_bf16_vs_plain_fp32": "kernel bf16 vs plain fp32"}[name]
        log(f"[{label}] {what}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    for name in ("fp32",) if bf16_as_precise else ("fp32", "bf16"):
        for k, tol in PARITY_TOL[name].items():
            v = readings[name][k]
            if not v <= tol:
                raise AssertionError(f"step parity {name} {k}: {v:.3e} > {tol:g}")
    if bf16_as_precise:
        for k, tol in PARITY_TOL["bf16"].items():
            v, control = readings["kernel_bf16_vs_plain_fp32"][k], readings["control"][k]
            if not v <= max(tol, BF16_AS_PRECISE * control):
                raise AssertionError(
                    f"step parity bf16 {k}: kernel vs plain fp32 {v:.3e} > {tol:g} and > "
                    f"{BF16_AS_PRECISE:g} x the plain bf16 path's {control:.3e}")

    # Launches of one sensed and one unsensed step on the kernel path (bf16).
    state = train_state(cfg.replace(dtypes=DTypePolicy.bf16()), weights, device)
    per_step = {}
    for sensed, step in ((True, clip_train_step), (False, make_nosense_step(cfg))):
        kernels.reset_launches()
        step(state, batch)
        torch.cuda.synchronize()
        per_step["sensed" if sensed else "unsensed"] = got = dict(kernels.launches)
        want = {k: v for k, v in launches_per_step(cfg, sensed).items() if v}
        if got != want:
            raise AssertionError(f"launches of one {'sensed' if sensed else 'unsensed'} step: {got} != {want}")
    log(f"[{label}] launches per step on the kernel path: {per_step}")
    return {"readings": readings, "launches_per_step": per_step}


def median_step_ms(state, step, batch, plain=False, reps=5) -> float:
    """Median host ms of ``step(state, batch)`` over ``reps`` synchronised
    calls after two warm-up calls; ``plain`` runs it with the plain moment
    sums (the all-plain path)."""
    import torch

    def run():
        if plain:
            with plain_moment_sums():
                step(state, batch)
        else:
            step(state, batch)
    for _ in range(2):
        run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_train_timing(device) -> dict:
    """Step times at vit_b16_hd128, bf16, batch 128 (kernel path vs
    all-plain path in turns), pairs/s with sensing every 8th step, the
    neuron slow loop over the 24 layers, and one sensed step under the
    profiler."""
    import torch

    from forde_tpu_torch.brain.neuron_slow_loop import neuron_slow_loop_step
    from forde_tpu_torch.train.clip_step import clip_train_step, make_nosense_step

    cfg = main_path_config().replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, 128, device, SEED + 6)
    batch["image"] = batch["image"].to(cfg.dtypes.compute)
    nosense = make_nosense_step(cfg)
    kernel_state = train_state(cfg, weights, device)
    plain_state = train_state(cfg, weights, device, impl="reference")

    p1 = median_step_ms(plain_state, clip_train_step, batch, plain=True)
    k1 = median_step_ms(kernel_state, clip_train_step, batch)
    k2 = median_step_ms(kernel_state, clip_train_step, batch)
    p2 = median_step_ms(plain_state, clip_train_step, batch, plain=True)
    sensed_ms, plain_sensed_ms = min(k1, k2), min(p1, p2)
    unsensed_ms = median_step_ms(kernel_state, nosense, batch)
    plain_unsensed_ms = median_step_ms(plain_state, nosense, batch, plain=True)
    pairs = 128 * 8 / (sensed_ms + 7 * unsensed_ms) * 1e3
    plain_pairs = 128 * 8 / (plain_sensed_ms + 7 * plain_unsensed_ms) * 1e3
    log(f"[time] train step, batch 128: sensed {k1:.2f} / {k2:.2f} ms (plain path "
        f"{p1:.2f} / {p2:.2f} ms), unsensed {unsensed_ms:.2f} ms (plain path "
        f"{plain_unsensed_ms:.2f} ms); median of 5 each")
    log(f"[time] pairs/s with sensing every 8th step: kernel path {pairs:.1f}, "
        f"plain path {plain_pairs:.1f}")

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    slow = []
    for _ in range(3):
        clip_train_step(kernel_state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = neuron_slow_loop_step(
            kernel_state.model, kernel_state.grad_stats, kernel_state.grad_step_count, gen
        )
        skipped = bool(diag["skipped"])
        torch.cuda.synchronize()
        slow.append((time.perf_counter() - t0) * 1e3)
        if skipped:
            raise AssertionError("the timed slow loop skipped its update")
    log(f"[time] neuron slow loop (GMM, {cfg.vision.num_layers} + {cfg.text.num_layers} layers): "
        f"{' / '.join(f'{t:.2f}' for t in slow)} ms")
    profile_device(lambda: neuron_slow_loop_step(
        kernel_state.model, kernel_state.grad_stats, kernel_state.grad_step_count, gen
    ), "one neuron slow loop (GMM)")

    prof = profile_device(lambda: clip_train_step(kernel_state, batch),
                          "one sensed train step (batch 128)")
    return {"sensed_step_ms": sensed_ms, "unsensed_step_ms": unsensed_ms,
            "plain_sensed_step_ms": plain_sensed_ms, "plain_unsensed_step_ms": plain_unsensed_ms,
            "pairs_per_s_sense8": pairs, "plain_pairs_per_s_sense8": plain_pairs,
            "slow_loop_ms": float(np.median(slow)), "sensed_step_idle_share": prof["idle_share"]}


def fp32_step_timing(device) -> dict:
    """Step times at vit_b16_hd128 in fp32 (the training CLI without
    --bf16: fp32 compute, fp32 moments), batch 128: sensed and unsensed,
    kernel path against the all-plain path in turns, and one sensed step
    under torch.profiler (its top list of kernels)."""
    import torch

    from forde_tpu_torch.core.config import vit_b16_hd128_config
    from forde_tpu_torch.train.clip_step import clip_train_step, make_nosense_step

    cfg = vit_b16_hd128_config().replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, 128, device, SEED + 6)
    nosense = make_nosense_step(cfg)
    kernel_state = train_state(cfg, weights, device, moment_dtype=None)
    plain_state = train_state(cfg, weights, device, impl="reference", moment_dtype=None)

    p1 = median_step_ms(plain_state, clip_train_step, batch, plain=True)
    k1 = median_step_ms(kernel_state, clip_train_step, batch)
    k2 = median_step_ms(kernel_state, clip_train_step, batch)
    p2 = median_step_ms(plain_state, clip_train_step, batch, plain=True)
    unsensed_ms = median_step_ms(kernel_state, nosense, batch)
    plain_unsensed_ms = median_step_ms(plain_state, nosense, batch, plain=True)
    log(f"[time] fp32 train step, batch 128: sensed {k1:.2f} / {k2:.2f} ms (plain path "
        f"{p1:.2f} / {p2:.2f} ms), unsensed {unsensed_ms:.2f} ms (plain path "
        f"{plain_unsensed_ms:.2f} ms); median of 5 each")
    prof = profile_device(lambda: clip_train_step(kernel_state, batch),
                          "one fp32 sensed train step (batch 128)", top=16)
    return {"sensed_step_ms": min(k1, k2), "unsensed_step_ms": unsensed_ms,
            "plain_sensed_step_ms": min(p1, p2), "plain_unsensed_step_ms": plain_unsensed_ms,
            "sensed_step_idle_share": prof["idle_share"], "sensed_step_busy_ms": prof["busy_ms"]}


def moment_bound(n, f, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one moment_sums: x read once and
    (3, F) fp32 written; 4 fp32 operations per element (abs-add, fused
    multiply-add, add) on the CUDA cores."""
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = n * f * elem + 3 * f * 4
    return moved / HBM_BYTES_PER_S * 1e3, 4.0 * n * f / PEAK_OPS_PER_S["float32"] * 1e3


def time_kernel(label, kernel_fns, plain_fns, library_fns, bytes_ms, ops_ms,
                dtype="bfloat16", **shape) -> dict:
    """CUDA-event ms of a kernel, its plain version and PyTorch's one-call
    equivalent (None: there is none), each cycling through its closures,
    beside the bound; and the kernel's device time alone (device_ms).
    ``dtype`` names the inputs' type in the row."""
    k_ms, p_ms = cuda_ms(kernel_fns), cuda_ms(plain_fns)
    l_ms = None if library_fns is None else cuda_ms(library_fns)
    k_dev = device_ms(kernel_fns)
    b_ms, b_by = bound(bytes_ms, ops_ms)
    log(f"[time] {label}: kernel {k_ms:.4f} ms (device {k_dev:.4f}), plain {p_ms:.4f} ms, "
        f"library {'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by})")
    return {**shape, "dtype": dtype, "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms}


def add_tf32x3_bound(label, row) -> None:
    """An fp32 row of time_kernel whose kernel runs three TF32 passes a
    product: its bound by operations at that rate (``operations_tf32x3_ms``)
    beside the CUDA cores', logged."""
    row["operations_tf32x3_ms"] = (row["operations_ms"] * PEAK_OPS_PER_S["float32"]
                                   / PEAK_OPS_PER_S["tf32x3"])
    tc_ms, tc_by = bound(row["bytes_ms"], row["operations_tf32x3_ms"])
    log(f"[time] {label}: bound at three TF32 passes (165 TFLOP/s) {tc_ms:.4f} ms ({tc_by}); "
        f"at the CUDA cores (67 TFLOP/s) {row['bound_ms']:.4f} ms ({row['bound_by']})")


MHA_TIMING_BATCH = 128  # the training CLI's batch


def mha_timing(device, cfg, dtype_name) -> dict:
    """flash_mha_fwd and flash_mha_bwd per call in ``dtype_name`` at the
    dual encoder's four training shapes at batch 128 (vit_b16_hd128's
    vision and text, ``cfg``; vit_b16's D = 64 ones, keys "vision_d64" and
    "text_d64"; text lengths 4-64): kernel, plain version, the library
    yardstick (scaled_dot_product_attention's forward, and its backward on
    the same q/k/v, in the same dtype) and the bound. fp32 rows carry the
    bound by operations at both fp32 peaks: the CUDA cores'
    (``operations_ms``) and three TF32 passes' (``operations_tf32x3_ms``).
    Inputs cycle through copies that together exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.core.config import vit_b16_config
    from forde_tpu_torch.ops import flash_attention as fa

    batch = MHA_TIMING_BATCH
    dt = getattr(torch, dtype_name)
    elem = 2 if dt == torch.bfloat16 else 4
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    lens = torch.randint(4, cfg.max_text_len + 1, (batch,), device=device,
                         generator=gen).to(torch.int32)
    pos = torch.arange(cfg.max_text_len, device=device)
    s_vision = (cfg.image_size // cfg.patch_size) ** 2 + 1
    s_vision = -(-s_vision // 8) * 8  # CLS + patches + registers
    d64 = vit_b16_config()
    out = {"flash_mha_fwd": {}, "flash_mha_bwd": {}}
    for name, tw, s, shape_lens in (
        ("vision", cfg.vision, s_vision, None),
        ("text", cfg.text, cfg.max_text_len, lens),
        ("vision_d64", d64.vision, s_vision, None),
        ("text_d64", d64.text, cfg.max_text_len, lens),
    ):
        h, d = tw.num_heads, tw.head_dim
        scale = d ** -0.5
        copies = max(2, -(-200_000_000 // (batch * s * 3 * h * d * elem)))
        args = (h, d, scale, None, False, None)
        attn_mask = None if shape_lens is None else (
            pos[None, None, None, :s] < shape_lens[:, None, None, None]
        )
        inputs = []
        for _ in range(copies):
            qkv = (torch.randn(batch, s, 3 * h * d, device=device, generator=gen) * 0.5).to(dt)
            do = torch.randn(batch, s, h * d, device=device, generator=gen).to(dt)
            _, lse = fa.flash_mha_fwd(qkv, shape_lens, *args)
            q, k, v = (t.transpose(1, 2).detach().requires_grad_(True)
                       for t in qkv.view(batch, s, 3, h, d).unbind(2))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)
            inputs.append((qkv, do, lse, (q, k, v), o, do.view(batch, s, h, d).transpose(1, 2)))

        def sdpa(q, k, v):
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)

        shape = {"B": batch, "S": s, "H": h, "D": d}
        label = f"{name} (B={batch}, S={s}, H={h}, D={d}, {tag})"
        for kernel, backward, kernel_fns, plain_fns, library_fns in (
            ("flash_mha_fwd", False,
             [lambda i=i: fa.flash_mha_fwd(i[0], shape_lens, *args) for i in inputs],
             [lambda i=i: fa.flash_mha_fwd_reference(i[0], shape_lens, *args) for i in inputs],
             [lambda i=i: sdpa(*i[3]) for i in inputs]),
            ("flash_mha_bwd", True,
             [lambda i=i: fa.flash_mha_bwd(i[0], shape_lens, i[2], i[1], *args) for i in inputs],
             [lambda i=i: fa.flash_mha_bwd_reference(i[0], shape_lens, i[2], i[1], *args)
              for i in inputs],
             [lambda i=i: i[4].backward(i[5], retain_graph=True) for i in inputs]),
        ):
            bytes_ms, ops_ms = attention_bound(batch, s, h, d, dtype_name, shape_lens, backward)
            row = time_kernel(f"{kernel} {label}", kernel_fns, plain_fns, library_fns,
                              bytes_ms, ops_ms, dtype=dtype_name, **shape)
            if dt == torch.float32:
                add_tf32x3_bound(f"{kernel} {label}", row)
            out[kernel][name] = row
        del inputs
        torch.cuda.empty_cache()
    return out


def phase_kernel_timing(device, cfg, encode_ms) -> dict:
    """Per call of each kernel at the training shapes of vit_b16_hd128
    (batch 128, text lengths 4-64), bf16 and fp32 (the route of every run
    without --bf16; keys with "_fp32"): kernel, plain version, the library
    yardstick (scaled_dot_product_attention's forward and its backward on
    the same q/k/v; none for the moment sums) and the bound; the attention
    kernels also at vit_b16's D = 64 shapes (mha_timing). Inputs cycle
    through copies that together exceed the 50 MB L2."""
    import torch

    from forde_tpu_torch.ops import stat_sums

    out = {"flash_mha_fwd": {}, "flash_mha_bwd": {}, "moment_sums": {}}
    for dtype_name, suffix in (("bfloat16", ""), ("float32", "_fp32")):
        for kernel, rows in mha_timing(device, cfg, dtype_name).items():
            out[kernel].update({name + suffix: row for name, row in rows.items()})

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    s_vision = -(-((cfg.image_size // cfg.patch_size) ** 2 + 1) // 8) * 8
    for name, tw, s in (("vision", cfg.vision, s_vision), ("text", cfg.text, cfg.max_text_len)):
        n, f = MHA_TIMING_BATCH * s, tw.mlp_hidden_dim
        for dtype_name, suffix in (("bfloat16", ""), ("float32", "_fp32")):
            dt = getattr(torch, dtype_name)
            elem = 2 if dt == torch.bfloat16 else 4
            xs = [torch.randn(n, f, device=device, generator=gen).to(dt)
                  for _ in range(max(2, -(-200_000_000 // (n * f * elem))))]
            out["moment_sums"][name + suffix] = time_kernel(
                f"moment_sums {name} z ({n} x {f}, {'bf16' if suffix == '' else 'fp32'})",
                [lambda x=x: stat_sums.moment_sums(x) for x in xs],
                [lambda x=x: stat_sums.moment_sums_reference(x) for x in xs],
                None, *moment_bound(n, f, dtype_name), dtype=dtype_name, N=n, F=f)
            del xs
    fwd = out["flash_mha_fwd"]
    attn_share = (cfg.vision.num_layers * fwd["vision"]["ms"]
                  + cfg.text.num_layers * fwd["text"]["ms"]) / encode_ms
    log(f"[time] attention kernel share of the kernel-path encode: {attn_share:.3f}")
    return out


def fused_qkv_turns(device, path: str) -> None:
    """mha_timing of this checkout's flash_mha_fwd and flash_mha_bwd, bf16
    then fp32, at vit_b16_hd128 (main_path_config), written as JSON to
    ``path``: one turn of a comparison of two checkouts inside one chip
    call (parent, change, change, parent), this file copied into each."""
    cfg = main_path_config()
    rows = {dtype_name: mha_timing(device, cfg, dtype_name)
            for dtype_name in ("bfloat16", "float32")}
    with open(path, "w") as f:
        json.dump({"card": nvidia_smi(), "rows": rows}, f)


def lm_fp32_parity(device) -> dict:
    """Phase 12's fp32 readings: the fp32 LM step's kernel path against the
    all-plain and the plain attention paths (relative L2 of the grads and
    params), on the first of LM_PARITY_SEEDS' batches."""
    cfg = serve_config()
    weights = lm_weights(cfg, device)
    launches = {}
    outs = {name: lm_step_outputs(cfg, weights, device, name, LM_PARITY_SEEDS[0], launches)
            for name in ("kernel32", "plain32", "reference32")}
    parity = {"fp32": rel_l2s(outs["kernel32"], outs["plain32"]),
              "reference_fp32": rel_l2s(outs["kernel32"], outs["reference32"])}
    for name, r in parity.items():
        log(f"[lm parity] {name}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    return parity


def small_kv_bwd_turns(device, path: str) -> None:
    """small_kv_bwd_timing of this checkout (bf16 and fp32), the fp32 LM
    training step (lm_fp32_step_timing) and phase 12's fp32 readings
    (lm_fp32_parity), written as JSON to ``path``: one turn of a comparison
    of two checkouts inside one chip call (parent, change, change, parent),
    this file copied into each."""
    parity = lm_fp32_parity(device)
    rows = small_kv_bwd_timing(device)
    step = lm_fp32_step_timing(device)
    with open(path, "w") as f:
        json.dump({"card": nvidia_smi(), "small_kv_bwd": rows, "lm_fp32_step": step,
                   "lm_fp32_parity": parity}, f)


def flash_bwd_turns(device, path: str) -> None:
    """flash_bwd_timing of this checkout (flash_bwd_dq and flash_bwd_dkv,
    bf16 and fp32, a profile of each kernel's fp32 calls), the fp32 LM
    training step (lm_fp32_step_timing) and phase 12's fp32 readings
    (lm_fp32_parity), written as JSON to ``path``: one turn of a comparison
    of two checkouts inside one chip call (parent, change, change, parent),
    this file copied into each."""
    parity = lm_fp32_parity(device)
    rows = flash_bwd_timing(device)
    step = lm_fp32_step_timing(device)
    with open(path, "w") as f:
        json.dump({"card": nvidia_smi(), "flash_bwd": rows, "lm_fp32_step": step,
                   "lm_fp32_parity": parity}, f)


def fp32_prefill_timing(device, state) -> dict:
    """The serving batch's prefill (nsa_prefill of the 8 prompts) with
    DTypePolicy.fp32(), as serve runs without --bf16: median of 5 after a
    warm-up, the kernel path and the all-plain path in turns (kernel,
    plain, kernel, plain), and one kernel-path prefill under the profiler
    (its top kernels)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.generate import nsa_prefill

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    models = {impl: build_lm(cfg, state, device, DTypePolicy.fp32(), impl)
              for impl in ("auto", "reference")}

    def prefill(impl):
        with torch.inference_mode():
            nsa_prefill(models[impl], padded, lens)

    times = {"auto": [], "reference": []}
    for impl in ("auto", "reference", "auto", "reference"):
        prefill(impl)
        times[impl].append(float(np.median([wall_ms(lambda: prefill(impl)) for _ in range(5)])))
    log(f"[time] fp32 prefill of the serving batch ({len(SERVE_PROMPT_LENS)} prompts of "
        f"{SERVE_PROMPT_LENS[0]}-{SERVE_PROMPT_LENS[-1]} tokens), median of 5: kernel path "
        f"{' / '.join(f'{t:.2f}' for t in times['auto'])} ms, all-plain path "
        f"{' / '.join(f'{t:.2f}' for t in times['reference'])} ms")
    del models["reference"]
    torch.cuda.empty_cache()
    prof = profile_device(lambda: prefill("auto"),
                          f"one fp32 prefill ({len(SERVE_PROMPT_LENS)} prompts)", top=12)
    return {"prefill_ms": times["auto"], "plain_prefill_ms": times["reference"],
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"]}


def flash_fwd_turns(device, path: str) -> None:
    """flash_fwd_timing of this checkout (bf16 and fp32 at FLASH_FWD_TIMING,
    five fp32 calls of each row profiled), the fp32 prefill of the serving
    batch (fp32_prefill_timing), phase 9's fp32 readings
    (serve_fp32_readings), phase 12's fp32 readings (lm_fp32_parity) and
    the fp32 LM training step (lm_fp32_step_timing), written as JSON to
    ``path``: one turn of a comparison of two checkouts inside one chip call
    (parent, change, change, parent), this file copied into each. The
    kernels' profiles come first: after a large profile session the next
    ones can read no device time (PERF.md §7.7)."""
    import torch

    rows = flash_fwd_timing(device, torch.Generator(device=device).manual_seed(SEED + 21))
    state = seeded_state(serve_config(), device, SEED)
    prefill = fp32_prefill_timing(device, state)
    out, last = serve_parity_paths(device, state, ("kernel32", "plain32"))
    serve = serve_fp32_readings(device, state, out, last)
    log("[serve parity] fp32: " + ", ".join(f"{k} {v}" for k, v in serve.items()))
    del state, out, last
    torch.cuda.empty_cache()
    parity = lm_fp32_parity(device)
    step = lm_fp32_step_timing(device)
    with open(path, "w") as f:
        json.dump({"card": nvidia_smi(), "flash_fwd": rows, "fp32_prefill": prefill,
                   "serve_fp32_parity": serve, "lm_fp32_parity": parity,
                   "lm_fp32_step": step}, f)


# ---------------------------------------------------------------------------
# The decoder LM's serving path: kernels flash_fwd and small_kv_fwd
# ---------------------------------------------------------------------------

# flash_fwd and small_kv_fwd against their plain versions run in fp32 on
# the same (exactly widened) inputs, per element |Δ| <= atol + rtol *
# (|plain| + mag), mag the weighted sum of |v| the element adds up (the
# softmax weights times |v|). fp32 differs by summation order (atol, and
# rtol for long sums). In bf16 each kernel rounds the weights (p, or w) to
# bf16 before the product with v, as its TPU kernel does: a relative 2^-9
# of each term, at most 2^-9 * mag; and it rounds its output: 2^-9 of the
# value. rtol 2^-8 bounds the sum of the two.
TOL_ATTN = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 2.0 ** -8)}

# (name, B, H, S, D, causal, window): S and D as the caller gives them;
# flash_attention pads S to 64 and D to 64 (an odd S non-causal gets the
# static kv_len bound). The serving prefill (the ragged batch pads to its
# longest prompt; 2048 is the configuration's longest), the streaming side
# of the JAX package's split (S = 8192), an odd S and a padded D, D = 128,
# a window that is not a multiple of the tile (the interior boundary
# mid-tile), and padded rows that see no key (non-causal, window 16, kv_len
# 100 of 128: rows 115-127), whose blocks walk every key tile, so the
# kernel's mean of the walked v is the plain version's mean of all v.
FLASH_FWD_CASES = [
    ("serve_b8_s2048_window512", 8, 8, 2048, 64, True, 512),
    ("serve_b8_s2048_causal", 8, 8, 2048, 64, True, None),
    ("stream_b1_s8192_window512", 1, 8, 8192, 64, True, 512),
    ("stream_b1_s8192_causal", 1, 8, 8192, 64, True, None),
    ("odd_s1000_d48_causal", 2, 4, 1000, 48, True, None),
    ("odd_s1000_d48_noncausal_kv_len", 2, 4, 1000, 48, False, None),
    ("s512_d128_window128", 2, 4, 512, 128, True, 128),
    ("s1024_window100", 2, 4, 1024, 64, True, 100),
    ("blind_rows_s100_noncausal_window16", 4, 8, 100, 64, False, 16),
]
# (name, B, H, S, K, D, keys): the compressed and top-k branches of the
# serving prefill (S = 2048: 192 pools, 64 selected) and of a decode step
# (one query; 256 pools at max_seq_len 2048, 64 kept), pools a row does
# not have (INVALID_KEY_POS), every key in the future (the uniform quirk),
# D = 128, and K = 200, not a multiple of the kernels' 64-key tiles.
# Then the fp32 route's key chunks: a decode step's pools at max_seq_len
# 16,384 and ratio 4 (decode_scaling: 64 chunks), every one of them masked
# (the uniform quirk across chunks), K = FWD_MAX_KEYS, padding keys that
# fill whole chunks of a row, a few query rows at D = 128 (one block per
# row), and K past 1,024 that is not a multiple of the tile at D = 128.
SMALL_KV_CASES = [
    ("prefill_pools_s2048_k192", 8, 8, 2048, 192, 64, "pools"),
    ("prefill_topk_s2048_k64", 8, 8, 2048, 64, 64, "topk"),
    ("decode_pools_s1_k256", 8, 8, 1, 256, 64, "decode_pools"),
    ("decode_topk_s1_k64", 8, 8, 1, 64, 64, "decode_topk"),
    ("invalid_keys_s512_k96", 4, 8, 512, 96, 64, "invalid"),
    ("all_future_s64_k40", 2, 4, 64, 40, 64, "future"),
    ("pools_s256_k100_d128", 2, 2, 256, 100, 128, "pools"),
    ("pools_s2048_k200", 2, 4, 2048, 200, 64, "pools"),
    ("decode_pools_s1_k4096", 1, 4, 1, 4096, 64, "decode_pools"),
    ("decode_pools_s1_k4096_future", 1, 4, 1, 4096, 64, "future"),
    ("decode_pools_s1_k8192", 1, 4, 1, 8192, 64, "decode_pools"),
    ("decode_padded_s1_k4096", 2, 4, 1, 4096, 64, "decode_padded"),
    ("rows_s5_k300_d128", 1, 8, 5, 300, 128, "pools"),
    ("pools_s200_k1100_d128", 2, 2, 200, 1100, 128, "pools"),
]
POOL_RATIO, WINDOW, MAX_SEQ = 8, 512, 2048


def pad_for_flash(q, k, v, s, d, causal):
    """flash_attention's padding: S to the kernel's tile, D to 64; a
    padded non-causal call bounds the keys with kv_len = S."""
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    s_pad, d_pad = -(-s // fa.BLOCK) * fa.BLOCK, max(-(-d // 64) * 64, 64)
    pads = (0, d_pad - d, 0, s_pad - s)
    kv_len = s if (not causal and s_pad != s) else None
    return [F.pad(t, pads).contiguous() for t in (q, k, v)], kv_len


def flash_fwd_magnitude(q, k, v, scale, window, causal, kv_len):
    """(B, H, S, D) fp32: softmax weights of the visible keys times |v|."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = fa._visible(q.shape[2], q.device, causal, window, None, kv_len)
    if mask is not None:
        scores = scores.masked_fill(~mask, fa.MASK_VALUE)
    return torch.matmul(torch.softmax(scores, dim=-1), v.abs())


def small_kv_key_pos(kind, b, s, kk, device, gen):
    """Thresholds (B, K) int32 of one SMALL_KV_CASES kind."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    j = torch.arange(kk, device=device)
    if kind == "pools":
        return ((j + 1) * POOL_RATIO).expand(b, kk).to(torch.int32).contiguous()
    if kind == "topk":
        return torch.stack([torch.randperm(s, device=device, generator=gen)[:kk]
                            for _ in range(b)]).to(torch.int32)
    cur = torch.randint(600, MAX_SEQ - 64, (b, 1), device=device, generator=gen)
    if kind == "decode_pools":  # pool p joins once cur >= (p+1)*ratio + window - 1
        return ((j + 1) * POOL_RATIO + WINDOW - 1 - cur).to(torch.int32)
    if kind == "decode_padded":  # and a row's pools past its count are padding
        pos = (j + 1) * POOL_RATIO + WINDOW - 1 - cur
        count = torch.tensor([1000, 70], device=device)[:b]
        return torch.where(j[None, :] < count[:, None], pos, INVALID_KEY_POS).to(torch.int32)
    if kind == "decode_topk":  # kept source indices, a few slots empty
        idx = torch.randint(0, 600, (b, kk), device=device, generator=gen)
        idx[:, -3:] = MAX_SEQ
        return (idx - cur).to(torch.int32)
    if kind == "invalid":  # the ragged prefill's pools past a row's count
        pos = ((j + 1) * POOL_RATIO).expand(b, kk).clone()
        count = torch.tensor([kk, 60, 7, 1], device=device)[:b]
        return torch.where(j[None, :] < count[:, None], pos, INVALID_KEY_POS).to(torch.int32)
    if kind == "future":
        return torch.full((b, kk), s + 100, dtype=torch.int32, device=device)
    raise ValueError(kind)


def small_kv_magnitude(q, k, v, key_pos, scale):
    import torch

    from forde_tpu_torch.ops import nsa_attention as nsa

    weights = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    return torch.matmul(weights, v.abs())


def check_misaligned_refused(name, call, device, dtype_name="bfloat16") -> None:
    """A tensor that starts off a 16-byte boundary makes the wrapper
    ``name`` raise before any launch: ``call(x, lse)`` gets x (1, 1, 64,
    64) of ``dtype_name`` one element past an aligned start."""
    import torch

    buf = torch.zeros(64 * 64 + 8, dtype=getattr(torch, dtype_name), device=device)
    x = buf[1:1 + 64 * 64].view(1, 1, 64, 64)
    lse = torch.zeros(1, 1, 64, 1, device=device)
    try:
        call(x, lse)
    except ValueError as err:
        if "16-byte aligned" not in str(err):
            raise
        log(f"[check] {name}: a misaligned {dtype_name} tensor is refused ({err}) ok")
        return
    raise AssertionError(f"{name} launched on a misaligned {dtype_name} tensor")


def phase_check_serving_kernels(device) -> dict:
    """flash_fwd and small_kv_fwd against their plain versions run in fp32
    on the same values, FLASH_FWD_CASES and SMALL_KV_CASES in fp32 and
    bf16; flash_attention and small_kv_attention on CUDA tensors against
    the kernels they wrap. Returns the worst max |error| of each."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    worst = {"flash_fwd": 0.0, "small_kv_fwd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 20)

    def hold(name, case, dtype_name, got, want, mag):
        atol, rtol = TOL_ATTN[dtype_name]
        err, ratio = held_against(got, want, atol, rtol * (want.abs() + mag))
        finite = bool(torch.isfinite(got).all())
        ok = ratio <= 1.0 and finite
        log(f"[check] {name} {case} {dtype_name}: max|Δ| {err:.3e}, worst |Δ| / ({atol:g} + "
            f"{rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), finite {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {dtype_name}")
        worst[name] = max(worst[name], err)

    for case, b, h, s, d, causal, window in FLASH_FWD_CASES:
        x = [torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(3)]
        (q, k, v), kv_len = pad_for_flash(*x, s, d, causal)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            o, lse = fa.flash_fwd(qd, kd, vd, scale, window, causal, kv_len)
            again = fa.flash_fwd(qd, kd, vd, scale, window, causal, kv_len)
            same = torch.equal(again[0], o) and torch.equal(again[1], lse)
            log(f"[check] flash_fwd {case} {dtype_name}: o, lse of two calls bit-identical "
                f"{same} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"flash_fwd is not deterministic: {case} {dtype_name}")
            del again
            qf, kf, vf = (t.float() for t in (qd, kd, vd))
            o_ref, lse_ref = fa.flash_fwd_reference(qf, kf, vf, scale, window, causal, kv_len)
            mag = flash_fwd_magnitude(qf, kf, vf, scale, window, causal, kv_len)
            torch.cuda.synchronize()
            hold("flash_fwd", case, dtype_name, o, o_ref, mag)
            lse_err = (lse - lse_ref).abs().max().item()
            if not lse_err <= TOL_LSE:
                raise AssertionError(f"flash_fwd lse {case} {dtype_name}: {lse_err:.3e}")
            blind = int((lse_ref < fa.MASK_VALUE * 0.5).sum())
            if blind:
                log(f"[check] flash_fwd {case} {dtype_name}: {blind} rows see no key, their "
                    f"lse {lse[lse_ref < fa.MASK_VALUE * 0.5].max().item():.3e}")
            with torch.inference_mode():
                whole = fa.flash_attention(*(t.to(dt) for t in x), causal=causal,
                                           window_size=window, scale=scale)
            if not torch.equal(whole, o[:, :, :s, :d]):
                raise AssertionError(f"flash_attention on CUDA is not its kernel's output: {case}")
            del o, lse, o_ref, lse_ref, mag, whole
        del x, q, k, v
        torch.cuda.empty_cache()
    for dtype_name in ("bfloat16", "float32"):
        check_misaligned_refused(
            "flash_fwd", lambda x, lse: fa.flash_fwd(x, x, x, 0.125, None, True, None), device,
            dtype_name)

    for case, b, h, s, kk, d, kind in SMALL_KV_CASES:
        q = torch.randn(b, h, s, d, device=device, generator=gen)
        k, v = (torch.randn(b, h, kk, d, device=device, generator=gen) for _ in range(2))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            out = nsa.small_kv_fwd(qd, kd, vd, key_pos, scale)
            same = torch.equal(nsa.small_kv_fwd(qd, kd, vd, key_pos, scale), out)
            log(f"[check] small_kv_fwd {case} {dtype_name}: two calls bit-identical {same} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"small_kv_fwd is not deterministic: {case} {dtype_name}")
            qf, kf, vf = (t.float() for t in (qd, kd, vd))
            want = nsa.small_kv_fwd_reference(qf, kf, vf, key_pos, scale)
            mag = small_kv_magnitude(qf, kf, vf, key_pos, scale)
            torch.cuda.synchronize()
            hold("small_kv_fwd", case, dtype_name, out, want, mag)
            if kind == "future":  # the uniform quirk: the mean of v
                mean = vf.mean(dim=2, keepdim=True).expand_as(want)
                hold("small_kv_fwd", case + "_is_mean_v", dtype_name, out, mean, mag)
            with torch.inference_mode():
                whole = nsa.small_kv_attention(qd, kd, vd, key_pos, scale=scale)
            if not torch.equal(whole, out):
                raise AssertionError(f"small_kv_attention on CUDA is not its kernel's output: {case}")
    return worst


# ---------------------------------------------------------------------------
# The decoder LM's training path: kernels flash_bwd_dq, flash_bwd_dkv and
# small_kv_bwd
# ---------------------------------------------------------------------------

# The backward kernels against their plain versions run in fp32 on the same
# (exactly widened) inputs, per element |Δ| <= atol + rtol * (|plain| +
# mag), mag the sum of the absolute terms the element adds up (|ds|·|k| for
# dq, |ds|ᵀ·|q| for dk, |p|ᵀ·|do| for dv). flash_bwd as flash_mha_bwd
# (TOL_BWD): fp32 differs by summation order; in bf16 the kernels round p
# (for dv) and ds (for dq, dk) to bf16, at most 2^-8 of each term, and
# their output, 2^-8 of the value. small_kv_bwd sums dk and dv over up to
# S = 8192 queries, in 64-query tiles and then in chunks of tiles, in
# another order than the plain version's matmul: each addition a rounding
# of 2^-24 of the running magnitude, so its rtol takes 1e-4 more in both
# types.
TOL_SKV_BWD = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -8 + 1e-4)}
# And in bf16 each backward kernel's relative L2 error against the exact
# (fp32) result is at most this much above its plain version's run in bf16:
# the same roundings at the same places, summed in other orders (on an
# NVIDIA H100 the two read within 0.01% of each other at every case).
BF16_AS_PRECISE = 1.05

# (name, B, H, S, D, causal, window, dlse): the training step's shape (the
# NSA local branch), the --no_nsa dense causal one, the streaming side of
# the JAX package's split (S = 8192), an odd S with a padded D (S to the
# tile, D to 64), non-causal with padded keys (kv_len), D = 128, a
# nonzero lse cotangent (the ring-attention route), and a window that is
# not a multiple of the tile.
FLASH_BWD_CASES = [
    ("train_b8_s2048_window512", 8, 8, 2048, 64, True, 512, False),
    ("train_b8_s2048_causal", 8, 8, 2048, 64, True, None, False),
    ("stream_b1_s8192_window512", 1, 8, 8192, 64, True, 512, False),
    ("odd_s1000_d48_causal", 2, 4, 1000, 48, True, None, False),
    ("odd_s1000_d48_noncausal_kv_len", 2, 4, 1000, 48, False, None, False),
    ("s512_d128_window128", 2, 4, 512, 128, True, 128, False),
    ("s512_d64_window128_dlse", 2, 4, 512, 64, True, 128, True),
    ("s1024_window100", 2, 4, 1024, 64, True, 100, False),
]
# (name, B, H, S, K, D, keys): the compressed and top-k branches of the
# training step (S = 2048: 192 pools, 64 selected), 960 pools at S = 8192,
# pools a row does not have (INVALID_KEY_POS), every key in the future (the
# uniform quirk: dq = dk = 0), D = 128, K = 200, not a multiple of the
# kernels' 64-key tiles, MAX_KEYS at D = 128, and one dk/dv chunk at
# S = 8192 (dkdv_chunks(4, 8, 8192, 576) = 1: the fp32 dk/dv kernel's
# longest chain, 8,192 queries into one key row).
SMALL_KV_BWD_CASES = [
    ("train_pools_s2048_k192", 8, 8, 2048, 192, 64, "pools"),
    ("train_topk_s2048_k64", 8, 8, 2048, 64, 64, "topk"),
    ("long_pools_s8192_k960", 1, 8, 8192, 960, 64, "pools"),
    ("invalid_keys_s512_k96", 4, 8, 512, 96, 64, "invalid"),
    ("all_future_s64_k40", 2, 4, 64, 40, 64, "future"),
    ("pools_s256_k100_d128", 2, 2, 256, 100, 128, "pools"),
    ("pools_s2048_k200", 2, 4, 2048, 200, 64, "pools"),
    ("max_keys_s256_k1024_d128", 2, 2, 256, 1024, 128, "pools"),
    ("one_chunk_pools_s8192_k576", 4, 8, 8192, 576, 64, "pools"),
]


def flash_bwd_magnitudes(q, k, v, lse, do, delta, scale, window, causal, kv_len):
    """(mag_dq, mag_dk, mag_dv), each (B, H, S, D) fp32, from the plain
    version's fp32 p and ds."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    mask = fa._visible(q.shape[2], q.device, causal, window, None, kv_len)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    ds = (p * (do @ v.transpose(-1, -2) - delta) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), p.transpose(-1, -2) @ do.abs()


def small_kv_bwd_magnitudes(q, k, v, key_pos, do, scale):
    import torch

    from forde_tpu_torch.ops import nsa_attention as nsa

    w = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    dw = do @ v.transpose(-1, -2)
    ds = (w * (dw - (dw * w).sum(-1, keepdim=True)) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), w.transpose(-1, -2) @ do.abs()


def phase_check_training_kernels(device) -> dict:
    """flash_bwd (its dq and dk/dv kernels) and small_kv_bwd against their
    plain versions run in fp32 on the same values, FLASH_BWD_CASES and
    SMALL_KV_BWD_CASES in fp32 and bf16; the gradients of flash_attention
    and small_kv_attention on CUDA tensors against the kernels they wrap.
    Returns the worst max |error| of each kernel."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0, "small_kv_bwd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 30)

    def hold(name, case, dtype_name, got, want, mag, tol):
        atol, rtol = tol[dtype_name]
        err, ratio = held_against(got, want, atol, rtol * (want.abs() + mag))
        finite = bool(torch.isfinite(got).all())
        ok = ratio <= 1.0 and finite
        log(f"[check] {name} {case} {dtype_name}: max|Δ| {err:.3e}, worst |Δ| / ({atol:g} + "
            f"{rtol:.4g}(|plain| + mag)) {ratio:.3f} (tol 1), finite {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {dtype_name}")
        worst[name] = max(worst[name], err)

    def as_precise(name, case, got, plain, exact):
        """The kernel's bf16 result is as far from the exact (fp32) one as
        its plain version run in bf16, within BF16_AS_PRECISE."""
        err_k = ((got.float() - exact).norm() / exact.norm()).item()
        err_p = ((plain.float() - exact).norm() / exact.norm()).item()
        ok = err_k <= BF16_AS_PRECISE * err_p + 1e-6
        log(f"[check] {name} {case} bfloat16: relative L2 error kernel {err_k:.4e}, plain "
            f"version in bf16 {err_p:.4e} (tol {BF16_AS_PRECISE:g}x) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} is less precise in bf16 than its plain version: {case}")

    for case, b, h, s, d, causal, window, with_dlse in FLASH_BWD_CASES:
        x = [torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(4)]
        (q, k, v), kv_len = pad_for_flash(*x[:3], s, d, causal)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            o, lse = fa.flash_fwd(qd, kd, vd, scale, window, causal, kv_len)
            do = torch.zeros_like(o)
            do[:, :, :s, :d] = x[3].to(dt)  # the padded rows get no gradient
            dlse = (torch.randn(b, h, o.shape[2], 1, device=device, generator=gen)
                    if with_dlse else None)
            got = fa.flash_bwd(qd, kd, vd, o, lse, do, scale, window, causal, kv_len, dlse)
            delta = fa._delta(o, do, dlse)
            args = (qd, kd, vd, do, lse, delta, scale, window, causal, kv_len)
            again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
            for name, parts, a, g in (("flash_bwd_dq", "dq", again[:1], got[:1]),
                                      ("flash_bwd_dkv", "dk, dv", again[1:], got[1:])):
                same = all(torch.equal(x1, x2) for x1, x2 in zip(a, g))
                log(f"[check] {name} {case} {dtype_name}: {parts} of two calls bit-identical "
                    f"{same} {'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError(f"{name} is not deterministic: {case} {dtype_name}")
            del again
            f32 = [t.float() for t in (qd, kd, vd, o)]
            want = fa.flash_bwd_reference(*f32, lse, do.float(), scale, window, causal, kv_len,
                                          dlse)
            mags = flash_bwd_magnitudes(f32[0], f32[1], f32[2], lse, do.float(), delta, scale,
                                        window, causal, kv_len)
            torch.cuda.synchronize()
            for part, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
                name = "flash_bwd_dq" if part == "dq" else "flash_bwd_dkv"
                hold(name, f"{case} {part}", dtype_name, g, w, m, TOL_BWD)
            if dtype_name == "bfloat16":
                plain = fa.flash_bwd_reference(qd, kd, vd, o, lse, do, scale, window, causal,
                                               kv_len, dlse)
                for part, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
                    name = "flash_bwd_dq" if part == "dq" else "flash_bwd_dkv"
                    as_precise(name, f"{case} {part}", g, p, w)
            if dtype_name == "float32" and not with_dlse:
                # flash_attention's gradient on CUDA is these kernels' output.
                leaves = [t.to(dt).requires_grad_(True) for t in x[:3]]
                out = fa.flash_attention(*leaves, causal=causal, window_size=window, scale=scale)
                out.backward(x[3])
                for part, leaf, g in zip(("dq", "dk", "dv"), leaves, got):
                    if not torch.equal(leaf.grad, g[:, :, :s, :d]):
                        raise AssertionError(f"flash_attention's {part} on CUDA is not flash_bwd's: {case}")
            del o, lse, do, got, want, mags, f32
        del x, q, k, v
        torch.cuda.empty_cache()
    # Both routes copy tiles with 16-byte cp.async.
    for dtype_name in ("bfloat16", "float32"):
        check_misaligned_refused(
            "flash_bwd_dq",
            lambda x, lse: fa.flash_bwd_dq(x, x, x, x, lse, lse, 0.125, None, True, None),
            device, dtype_name)
        check_misaligned_refused(
            "flash_bwd_dkv",
            lambda x, lse: fa.flash_bwd_dkv(x, x, x, x, lse, lse, 0.125, None, True, None),
            device, dtype_name)

    for case, b, h, s, kk, d, kind in SMALL_KV_BWD_CASES:
        q, g_out = (torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(2))
        k, v = (torch.randn(b, h, kk, d, device=device, generator=gen) for _ in range(2))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, g_out))
            got = nsa.small_kv_bwd(qd, kd, vd, key_pos, dod, scale)
            again = nsa.small_kv_bwd(qd, kd, vd, key_pos, dod, scale)
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            log(f"[check] small_kv_bwd {case} {dtype_name}: dq, dk, dv of two calls "
                f"bit-identical {same} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"small_kv_bwd is not deterministic: {case} {dtype_name}")
            del again
            f32 = [t.float() for t in (qd, kd, vd)]
            want = nsa.small_kv_bwd_reference(*f32, key_pos, dod.float(), scale)
            mags = small_kv_bwd_magnitudes(*f32, key_pos, dod.float(), scale)
            torch.cuda.synchronize()
            for part, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
                hold("small_kv_bwd", f"{case} {part}", dtype_name, g, w, m, TOL_SKV_BWD)
            if dtype_name == "bfloat16" and kind != "future":
                plain = nsa.small_kv_bwd_reference(qd, kd, vd, key_pos, dod, scale)
                for part, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
                    as_precise("small_kv_bwd", f"{case} {part}", g, p, w)
            if kind == "future" and (got[0].abs().max().item() != 0.0
                                     or got[1].abs().max().item() != 0.0):
                raise AssertionError("small_kv_bwd: a row with no visible key moved dq or dk")
            if dtype_name == "float32":
                leaves = [t.clone().requires_grad_(True) for t in (qd, kd, vd)]
                nsa.small_kv_attention(*leaves, key_pos, scale=scale).backward(dod)
                for part, leaf, g in zip(("dq", "dk", "dv"), leaves, got):
                    if not torch.equal(leaf.grad, g):
                        raise AssertionError(
                            f"small_kv_attention's {part} on CUDA is not small_kv_bwd's: {case}")
            del got, want, mags
    return worst


# The reference-default decoder at full width, through the serving CLI's
# derivation of the config (benchmarks/decoder.py's configuration):
# vocab 50,257, d 512, 12 layers, 8 heads x 64, expert hidden 2048 (top-2
# of 8, dense dispatch), NSA window 512, ratio 8, top-k 64, 4 mHC streams
# with 5 Sinkhorn iterations, max_seq_len 2048, bf16.
SERVE_FLAGS = [
    "--d_model", "512", "--num_layers", "12", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "2048", "--bf16",
]
# 8 prompts spread over 640-1,920 tokens, every one past the window, so
# every NSA branch is live; 32 new tokens each.
SERVE_PROMPT_LENS = (640, 823, 1005, 1188, 1371, 1554, 1737, 1920)
SERVE_NEW_TOKENS = 32
SAMPLED_PROMPT_LEN = 1536


def serve_config():
    from forde_tpu_torch import serve

    return serve.config_from_args(serve.build_parser().parse_args(SERVE_FLAGS))


def serve_prompts(vocab_size: int):
    rng = np.random.RandomState(SEED + 10)
    return [rng.randint(1, vocab_size, n).tolist() for n in SERVE_PROMPT_LENS]


def serve_batch(prompts, device):
    """(right-padded ids (B, P_max), lengths (B,)) on ``device``."""
    import torch

    lens = torch.tensor([len(p) for p in prompts])
    padded = torch.zeros(len(prompts), int(lens.max()), dtype=torch.int64)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = torch.tensor(p)
    return padded.to(device), lens.to(device)


def serve_launches(cfg, new_tokens: int) -> dict:
    """Kernel launches of one cached generation: the prefill runs the NSA
    forward (flash_fwd for the local branch, small_kv_fwd for the
    compressed and top-k branches, per layer) and one top-k replay for
    every layer and row, each later token one decode step (small_kv_fwd
    twice per layer; the local ring is plain), eager or replayed."""
    n = cfg.num_layers
    return {"flash_fwd": n, "small_kv_fwd": 2 * n + (new_tokens - 1) * 2 * n, "topk_replay": 1}


def phase_serve_path(device, workdir) -> dict:
    """serve.main at SERVE_FLAGS from a checkpoint of seeded random weights:
    the ragged greedy batch (--prompts_file, --output_file), then one
    sampled prompt (--prompt_ids, temperature 0.8, top-k 50, top-p 0.95)."""
    import torch

    from forde_tpu_torch import interop, kernels, serve
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.checkpoint import save_params

    cfg = serve_config()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = FORDEDecoderLM(cfg, device=device, generator=gen)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ckpt = os.path.join(workdir, "lm_ckpt")
    t0 = time.perf_counter()
    save_params(ckpt, cfg, interop.flatten(interop.state_dict_to_flax(state)), {"step": 0})
    del model
    log(f"[serve] checkpoint of {sum(v.numel() for v in state.values()) / 1e6:.1f} M "
        f"values written in {time.perf_counter() - t0:.2f} s")

    prompts = serve_prompts(cfg.vocab_size)
    pfile, ofile = os.path.join(workdir, "prompts.txt"), os.path.join(workdir, "out.jsonl")
    with open(pfile, "w") as f:
        f.writelines(",".join(map(str, p)) + "\n" for p in prompts)
    common = ["--checkpoint_dir", ckpt, "--max_new_tokens", str(SERVE_NEW_TOKENS)]

    def run(argv):
        """serve.main with its printout kept to the [serve] lines (it also
        prints every row's token ids)."""
        printed = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rows = serve.main(argv)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, dict(kernels.launches)
        for line in printed.getvalue().splitlines():
            if line.startswith("[serve]"):
                log(f"[serve]   {line}")
        return rows, launches, secs

    want = serve_launches(cfg, SERVE_NEW_TOKENS)
    rows, launches, secs = run(common + ["--prompts_file", pfile, "--output_file", ofile,
                                         "--temperature", "0"])
    log(f"[serve] serve.main, {len(prompts)} prompts of {SERVE_PROMPT_LENS[0]}-{SERVE_PROMPT_LENS[-1]} "
        f"tokens, {SERVE_NEW_TOKENS} new, greedy: {secs:.2f} s including the checkpoint "
        f"load; launches {launches}")
    with open(ofile) as f:
        written = [json.loads(ln) for ln in f]
    for p, row, line in zip(prompts, rows, written):
        if (row[: len(p)] != p or len(row) != len(p) + SERVE_NEW_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in row) or line["output_ids"] != row):
            raise AssertionError("serving batch: a row lost its prompt, length or vocabulary")
    if len(rows) != len(prompts) or launches != want:
        raise AssertionError(f"serving batch launches {launches}, expected {want}")

    sampled = np.random.RandomState(SEED + 11).randint(
        1, cfg.vocab_size, SAMPLED_PROMPT_LEN).tolist()
    rows2, launches2, secs2 = run(common + [
        "--prompt_ids", ",".join(map(str, sampled)), "--temperature", "0.8", "--top_k", "50",
        "--top_p", "0.95", "--seed", str(SEED)])
    log(f"[serve] serve.main, one prompt of {SAMPLED_PROMPT_LEN} tokens, sampled (T 0.8, "
        f"top-k 50, top-p 0.95): {secs2:.2f} s; launches {launches2}; new ids "
        f"{rows2[0][SAMPLED_PROMPT_LEN:SAMPLED_PROMPT_LEN + 8]}...")
    row = rows2[0]
    if (row[:SAMPLED_PROMPT_LEN] != sampled or len(row) != SAMPLED_PROMPT_LEN + SERVE_NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in row) or launches2 != want):
        raise AssertionError(f"sampled prompt: launches {launches2}, expected {want}")
    return {"launches": launches, "launches_sampled": launches2, "seconds": secs,
            "state": state, "cfg": cfg}


# Phase 9 bar: the relative L2 of the prefill's last logits, kernel path
# vs all-plain path, both bf16, must stay under this share of the control
# (plain bf16 vs plain fp32 on the same weights). Both paths round every
# activation to bf16; the kernels round p (or w) before the product with v
# where the plain attention rounds the normalised weights, so the two
# differ by bf16 roundings and by the MoE routing flips these cause, which
# twelve layers of random weights carry far. Readings (NVIDIA H100, the
# same in every run): kernel vs plain 0.277, control 0.543, kernel bf16
# vs plain fp32 0.526. The bar sits between the reading and the control:
# a path that is only less precise than the plain bf16 one fails it.
SERVE_PARITY_OF_CONTROL = 0.75
SERVE_PARITY_NEW = 16


def serve_parity_paths(device, state, names) -> tuple:
    """The serving batch from the same weights on each path of ``names``
    (kernel32, plain32, kernel16, plain16: DTypePolicy fp32 or bf16, the
    kernels or the all-plain path): ({fp32 name: greedy tokens, SERVE_PARITY_NEW
    new}, {name: the prefill's last logits})."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_ragged, nsa_prefill

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    paths = {"kernel32": (DTypePolicy.fp32(), "auto"), "plain32": (DTypePolicy.fp32(), "reference"),
             "kernel16": (DTypePolicy.bf16(), "auto"), "plain16": (DTypePolicy.bf16(), "reference")}
    out, last = {}, {}
    for name in names:
        dtypes, impl = paths[name]
        m = FORDEDecoderLM(cfg.replace(dtypes=dtypes, attention_impl=impl), device=device)
        m.load_state_dict(state)
        m.eval()
        _, last[name] = nsa_prefill(m, padded, lens)
        if name.endswith("32"):
            out[name] = generate_ragged(m, padded, lens, None, max_new_tokens=SERVE_PARITY_NEW,
                                        temperature=0.0)
        del m
        torch.cuda.empty_cache()
    for name, t in last.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite last logits on the {name} path")
    return out, last


def serve_fp32_readings(device, state, out, last) -> dict:
    """Phase 9's fp32 readings from serve_parity_paths' kernel32 and
    plain32: whether the greedy tokens are identical, where they first
    differ ((row, column) of the batch, and the top-2 logit margin of the
    all-plain model at the first differing new position of that row), and
    the relative L2 of the prefill's last logits."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    got, want = out["kernel32"], out["plain32"]
    differ = (got != want).nonzero().tolist()
    readings = {"fp32_tokens_identical": not differ, "fp32_first_differing": differ[:4],
                "fp32_last_logits": rel_l2(last["kernel32"], last["plain32"])}
    if differ:
        cfg = serve_config()
        row = differ[0][0]
        prompt = serve_prompts(cfg.vocab_size)[row]
        m = FORDEDecoderLM(cfg.replace(dtypes=DTypePolicy.fp32(), attention_impl="reference"),
                           device=device)
        m.load_state_dict(state)
        n = len(prompt) + SERVE_PARITY_NEW
        pos, margin = top2_margin(m.eval(), prompt, got[row, :n].tolist(), want[row, :n].tolist())
        readings.update({"fp32_first_differing_new_position": pos, "fp32_top2_margin": margin})
        del m
        torch.cuda.empty_cache()
    return readings


def phase_serve_parity(device, state) -> dict:
    """The greedy batch on the kernel path against the all-plain path from
    the same weights: identical tokens in fp32; in bf16 the relative L2
    of the prefill's last logits beside the plain-bf16-vs-plain-fp32
    control."""
    out, last = serve_parity_paths(device, state, ("kernel32", "plain32", "kernel16", "plain16"))

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    fp32 = serve_fp32_readings(device, state, out, last)
    same = fp32["fp32_tokens_identical"]
    readings = {
        "fp32_last_logits": fp32["fp32_last_logits"],
        "bf16_last_logits": rel(last["kernel16"], last["plain16"]),
        "control_plain_bf16_vs_fp32": rel(last["plain16"], last["plain32"]),
        "kernel_bf16_vs_plain_fp32": rel(last["kernel16"], last["plain32"]),
    }
    bar = SERVE_PARITY_OF_CONTROL * readings["control_plain_bf16_vs_fp32"]
    log(f"[serve parity] fp32 greedy tokens ({SERVE_PARITY_NEW} new x {len(SERVE_PROMPT_LENS)} "
        f"rows), kernel path vs all-plain path: identical {same}" + ("" if same else
        f", first differing {fp32['fp32_first_differing']}, new position "
        f"{fp32['fp32_first_differing_new_position']}, top-2 margin "
        f"{fp32['fp32_top2_margin']:.3e}"))
    log("[serve parity] relative L2 of the prefill's last logits: " + ", ".join(
        f"{k} {v:.3e}" for k, v in readings.items()) + f"; bf16 bar {bar:.3e} "
        f"({SERVE_PARITY_OF_CONTROL:g} x control)")
    if not same:
        raise AssertionError("fp32 greedy tokens differ between the kernel and all-plain paths")
    if not readings["bf16_last_logits"] < bar:
        raise AssertionError(f"bf16 last logits: {readings['bf16_last_logits']:.3e} >= {bar:.3e}")
    return readings


def flash_fwd_bound(b, h, s, d, window, causal, kv_len, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one flash_fwd: q, k, v read once,
    o and lse written once; 4 * D operations per (query, visible key)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = 4 * b * h * s * d * elem + b * h * s * 4
    rows = np.arange(s)
    hi = rows + 1 if causal else np.full(s, s if kv_len is None else kv_len)
    lo = np.maximum(rows - window + 1, 0) if window is not None else np.zeros(s, int)
    pairs = float(np.maximum(hi - lo, 0).sum())
    ops = 4.0 * d * b * h * pairs
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def small_kv_bound(q, k, key_pos, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one small_kv_fwd: q, k, v and
    key_pos read once, out written once; 4 * D operations per visible
    (query, key) pair, and 2 * D per real key for a query that sees none
    (the uniform quirk averages v)."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    b, h, s, d = q.shape
    kk = k.shape[2]
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = (2 * b * h * s * d + 2 * b * h * kk * d) * elem + b * kk * 4
    pos = torch.arange(s, device=q.device)[None, :, None]
    real = key_pos[:, None, :] < INVALID_KEY_POS
    vis = (pos >= key_pos[:, None, :]) & real  # (B, S, K)
    n_vis = vis.sum(-1)
    pairs = float(n_vis.sum()) + 0.5 * float((real.sum(-1) * (n_vis == 0)).sum())
    ops = 4.0 * d * h * pairs
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def phase_serve_timing(device, state) -> dict:
    """The 8-prompt batch in bf16: time to first token (generate_ragged
    with one new token: the prefill and its sample) and the whole
    generation of SERVE_NEW_TOKENS, kernel path vs all-plain path, each
    with its decode steps replayed from a CUDA graph (plain, kernel,
    kernel, plain) and eager (cuda_graph=False, the control: kernel,
    plain); ms per output token = (whole - first) / (new - 1); output
    tokens/s; median of 3 graphed, one eager. One prefill, one replayed
    decode step and one eager decode step under the profiler."""
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_ragged, nsa_prefill

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    models = {}
    for impl in ("auto", "reference"):
        m = FORDEDecoderLM(cfg.replace(attention_impl=impl), device=device)
        m.load_state_dict(state)
        models[impl] = m.eval()

    def gen_ms(m, new, graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_ragged(m, padded, lens, None, max_new_tokens=new, temperature=0.0,
                        cuda_graph=graph)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def measure(impl, graph, reps=3):
        m = models[impl]
        gen_ms(m, 2, graph)  # warm-up (and the graph's capture)
        first = float(np.median([gen_ms(m, 1, graph) for _ in range(reps)]))
        whole = float(np.median([gen_ms(m, SERVE_NEW_TOKENS, graph) for _ in range(reps)]))
        return first, whole

    # plain, kernel, kernel, plain: the two paths share the card in turns.
    g_p1, g_k1, g_k2, g_p2 = (measure(i, True) for i in ("reference", "auto", "auto", "reference"))
    # the eager control once each: its decode is ~3 s a generation
    e_k, e_p = measure("auto", False, reps=1), measure("reference", False, reps=1)
    n_out = len(SERVE_PROMPT_LENS) * SERVE_NEW_TOKENS

    def summary(first_whole):
        first, whole = first_whole
        return {"ttft_ms": first, "ms_per_output_token": (whole - first) / (SERVE_NEW_TOKENS - 1),
                "out_tokens_per_s": n_out / whole * 1e3, "whole_ms": whole}

    out = {"graph": summary(min(g_k1, g_k2)), "plain_graph": summary(min(g_p1, g_p2)),
           "eager": summary(e_k), "plain_eager": summary(e_p)}
    log(f"[time] serving, {len(SERVE_PROMPT_LENS)} prompts of {SERVE_PROMPT_LENS[0]}-"
        f"{SERVE_PROMPT_LENS[-1]} tokens (bf16), graphed median of 3, eager once: time to first "
        f"token kernel path "
        f"{g_k1[0]:.2f} / {g_k2[0]:.2f} / {e_k[0]:.2f} ms, plain path {g_p1[0]:.2f} / "
        f"{g_p2[0]:.2f} / {e_p[0]:.2f} ms; {SERVE_NEW_TOKENS} new tokens, decode graphed: kernel "
        f"path {g_k1[1]:.2f} / {g_k2[1]:.2f} ms, plain path {g_p1[1]:.2f} / {g_p2[1]:.2f} ms; "
        f"eager: kernel path {e_k[1]:.2f} ms, plain path {e_p[1]:.2f} ms")
    for name, r in out.items():
        log(f"[time] serving {name}: TTFT {r['ttft_ms']:.2f} ms, ms per output token (decode "
            f"step, batch {len(SERVE_PROMPT_LENS)}) {r['ms_per_output_token']:.3f}, output "
            f"tokens/s {r['out_tokens_per_s']:.1f}")

    model = models["auto"]
    del models["reference"]
    torch.cuda.empty_cache()
    prefill = profile_device(
        lambda: generate_ragged(model, padded, lens, None, max_new_tokens=1, temperature=0.0),
        f"one prefill ({len(SERVE_PROMPT_LENS)} prompts, generate_ragged with 1 new token)")
    (graph, _, _), = model._decode_graphs.values()
    replayed = profile_device(graph.replay, f"one replayed decode step (batch {len(SERVE_PROMPT_LENS)})")
    with torch.inference_mode():
        cache, last = nsa_prefill(model, padded, lens)
        token = last.argmax(-1)
        decode = profile_device(lambda: model(token[:, None], cache=cache, positions=lens),
                                f"one eager decode step (batch {len(SERVE_PROMPT_LENS)})")
    out.update({"prefill_idle_share": prefill["idle_share"], "prefill_busy_ms": prefill["busy_ms"],
                "graph_decode_step_idle_share": replayed["idle_share"],
                "graph_decode_step_busy_ms": replayed["busy_ms"],
                "graph_decode_step_wall_ms": replayed["wall_ms"],
                "eager_decode_step_idle_share": decode["idle_share"],
                "eager_decode_step_busy_ms": decode["busy_ms"]})
    return out


# Timed shapes: (name, B, H, S, D, window, dtype) of flash_fwd, the
# serving prefill (bf16, and fp32 as serve runs it without --bf16) and the
# streaming side; (name, B, H, S, K, keys) of small_kv_fwd, one prefill
# layer's two launches and one decode step's two.
FLASH_FWD_TIMING = [
    ("serve_prefill_s2048_window512", 8, 8, 2048, 64, WINDOW, "bfloat16"),
    ("stream_s8192_window512", 1, 8, 8192, 64, WINDOW, "bfloat16"),
    ("serve_prefill_s2048_window512_fp32", 8, 8, 2048, 64, WINDOW, "float32"),
    ("stream_s8192_window512_fp32", 1, 8, 8192, 64, WINDOW, "float32"),
]
SMALL_KV_TIMING = [
    ("prefill_pools_s2048_k192", 8, 8, 2048, 192, "pools"),
    ("prefill_topk_s2048_k64", 8, 8, 2048, 64, "topk"),
    ("decode_pools_s1_k256", 8, 8, 1, 256, "decode_pools"),
    ("decode_topk_s1_k64", 8, 8, 1, 64, "decode_topk"),
]


def flash_fwd_timing(device, gen) -> dict:
    """Per call of flash_fwd at FLASH_FWD_TIMING: kernel, plain version, SDPA
    with the same mask in the same dtype and the bound; fp32 rows also carry
    the bound by operations at three TF32 passes (``operations_tf32x3_ms``),
    and five fp32 calls are profiled. Inputs from ``gen`` cycle through
    copies that together exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    out = {}
    for name, b, h, s, d, window, dtype_name in FLASH_FWD_TIMING:
        dt = getattr(torch, dtype_name)
        elem = 2 if dt == torch.bfloat16 else 4
        copies = max(2, -(-200_000_000 // (3 * b * h * s * d * elem)))
        inputs = [[torch.randn(b, h, s, d, device=device, generator=gen).to(dt)
                   for _ in range(3)] for _ in range(copies)]
        pos = torch.arange(s, device=device)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        scale = d ** -0.5

        def sdpa(q, k, v, mask=mask, scale=scale):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        label = f"flash_fwd {name} (B={b}, H={h}, S={s}, D={d}, {dtype_name})"
        kernel = [lambda i=i: fa.flash_fwd(*i, scale, window, True, None) for i in inputs]
        with torch.inference_mode():
            t = time_kernel(
                label, kernel,
                [lambda i=i: fa.flash_fwd_reference(*i, scale, window, True, None)
                 for i in inputs[:2]],
                [lambda i=i: sdpa(*i) for i in inputs],
                *flash_fwd_bound(b, h, s, d, window, True, None, dtype_name), dtype=dtype_name,
                B=b, H=h, S=s, D=d, window=window)
            if dt == torch.float32:
                add_tf32x3_bound(label, t)
                # Five calls: a one-call window after a large profile session
                # can read no device time (PERF.md §7.7).
                profile_device(lambda: [kernel[j % len(kernel)]() for j in range(5)],
                               f"five calls, {label}", top=4)
        out[name] = t
        del inputs, kernel
        torch.cuda.empty_cache()
    return out


def phase_serving_kernel_timing(device) -> dict:
    """Per call of flash_fwd (flash_fwd_timing) and small_kv_fwd at the
    serving shapes (bf16; flash_fwd's serving prefill and streaming side in
    fp32 too): kernel, plain version, SDPA with the same mask (a yardstick
    only: the port never calls it) and the bound. Inputs cycle through
    copies that together exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import nsa_attention as nsa

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    bf16 = torch.bfloat16
    out = {"flash_fwd": flash_fwd_timing(device, gen), "small_kv_fwd": {}}
    for name, b, h, s, kk, kind in SMALL_KV_TIMING:
        d = 64
        per_copy = (b * h * s * d + 2 * b * h * kk * d) * 2
        copies = max(2, -(-200_000_000 // per_copy))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        inputs = [(torch.randn(b, h, s, d, device=device, generator=gen).to(bf16),
                   *(torch.randn(b, h, kk, d, device=device, generator=gen).to(bf16)
                     for _ in range(2))) for _ in range(copies)]
        qpos = torch.arange(s, device=device)[None, None, :, None]
        kpos = key_pos[:, None, None, :]
        add = torch.where(qpos >= kpos, 0.0, nsa.NEG_BIG)
        add = torch.where(kpos >= nsa.INVALID_KEY_POS, -float("inf"), add).to(bf16)
        scale = d ** -0.5
        with torch.inference_mode():
            out["small_kv_fwd"][name] = time_kernel(
                f"small_kv_fwd {name} (B={b}, H={h}, S={s}, K={kk}, D={d}, bf16)",
                [lambda i=i: nsa.small_kv_fwd(*i, key_pos, scale) for i in inputs],
                [lambda i=i: nsa.small_kv_fwd_reference(*i, key_pos, scale) for i in inputs],
                [lambda i=i: F.scaled_dot_product_attention(*i, attn_mask=add, scale=scale)
                 for i in inputs],
                *small_kv_bound(inputs[0][0], inputs[0][1], key_pos, "bfloat16"),
                B=b, H=h, S=s, K=kk, D=d)
        del inputs
    return out


# ---------------------------------------------------------------------------
# The decoder LM's training path (train.loop), at the serving phases' width
# ---------------------------------------------------------------------------

# The training CLI at the reference-default width (SERVE_FLAGS: d 512, 12
# layers, 8 heads x 64, MoE top-2 of 8 dense, NSA window 512, 4 mHC
# streams, bf16) on batches of 8 x 2,048 seeded Markov tokens: 6 steps, the
# MoE slow loop every 3rd.
TRAIN_LM_STEPS = 6
TRAIN_LM_ARGV = SERVE_FLAGS + [
    "--batch_size", "8", "--use_markov_data", "--steps_per_epoch", str(TRAIN_LM_STEPS),
    "--slow_loop_interval", "3", "--log_interval", "3",
]
# The long-S route: the same width at 2 layers, one step of 1 x 8,192
# tokens, where the JAX package runs its streaming kernels and NSA has
# (8192 - 512) / 8 = 960 pools.
LONG_LM_ARGV = [
    "--d_model", "512", "--num_layers", "2", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "8192", "--bf16", "--batch_size", "1", "--use_markov_data",
    "--steps_per_epoch", "1", "--slow_loop_interval", "0", "--log_interval", "1",
]
LM_SERVE_NEW = 8
LM_SEQ = 2048  # the positions of the parity and timing batches


def lm_launches_per_step(cfg) -> dict:
    """Kernel launches of one training step of the decoder LM: per layer
    the NSA local branch (flash_fwd and its two backward kernels) and the
    compressed and top-k branches (small_kv_fwd and small_kv_bwd twice).
    With ``cfg.remat`` the backward recomputes each block's forward, so
    the forward kernels launch twice."""
    n, fwd = cfg.num_layers, 2 if cfg.remat else 1
    return {"flash_fwd": fwd * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "small_kv_fwd": 2 * fwd * n, "small_kv_bwd": 2 * n}


def run_train_loop(argv, workdir) -> tuple:
    """train.loop.main(argv) from ``workdir`` (its metrics land in ./runs):
    (result, launches, seconds, peak GiB allocated)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.train import loop

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = loop.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.chdir(cwd)
    return out, launches, secs, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train_lm_path(device, workdir) -> dict:
    """train.loop.main at TRAIN_LM_ARGV with a checkpoint: finite loss,
    exact launches, two brain updates that were not skipped; serve.main
    then decodes from the trained checkpoint."""
    import torch

    from forde_tpu_torch import kernels, serve
    from forde_tpu_torch.train import loop

    ckpt = os.path.join(workdir, "lm_train_ckpt")
    argv = TRAIN_LM_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    cfg = loop.config_from_args(loop.build_parser().parse_args(argv))
    out, launches, secs, peak = run_train_loop(argv, workdir)
    loss = out["final_metrics"]["loss/total"]
    log(f"[train_lm] train.loop.main ({' '.join(TRAIN_LM_ARGV)}) took {secs:.2f} s; final loss "
        f"{loss:.4f} (lm {out['final_metrics']['loss/lm']:.4f}), peak memory allocated "
        f"{peak:.2f} GiB, launches {launches}")
    if not np.isfinite(loss) or out["step"] != TRAIN_LM_STEPS:
        raise AssertionError(f"LM training path: loss {loss}, steps {out['step']}")
    want = {k: TRAIN_LM_STEPS * v for k, v in lm_launches_per_step(cfg).items()}
    if launches != want:
        raise AssertionError(f"LM training path launches {launches}, expected {want}")
    updates = out["brain_updates"]
    for u in updates:
        log(f"[train_lm] MoE slow loop @ {u['step']}: {u['latency_ms']:.2f} ms, skipped "
            f"{u['skipped']}, load imbalance {u['load_imbalance']:.4g}, routing entropy "
            f"{u['routing_entropy']:.4g}, router biases moved {u['updates_count']}")
    if [u["step"] for u in updates] != [3, 6] or any(
        u["skipped"] or u["updates_count"] != cfg.num_layers for u in updates
    ):
        raise AssertionError(f"MoE slow loop of the LM training path: {updates}")

    prompt = np.random.RandomState(SEED + 12).randint(1, cfg.vocab_size, 700).tolist()
    printed = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(printed):
        rows = serve.main(["--checkpoint_dir", ckpt, "--prompt_ids", ",".join(map(str, prompt)),
                           "--max_new_tokens", str(LM_SERVE_NEW), "--temperature", "0"])
    torch.cuda.synchronize()
    served = dict(kernels.launches)
    row = rows[0]
    if (row[: len(prompt)] != prompt or len(row) != len(prompt) + LM_SERVE_NEW
            or not all(0 <= t < cfg.vocab_size for t in row)
            or served != serve_launches(cfg, LM_SERVE_NEW)
            or f"restored step {TRAIN_LM_STEPS}" not in printed.getvalue()):
        raise AssertionError(f"serving the trained checkpoint: launches {served}, row {row[-8:]}")
    log(f"[train_lm] serve.main served the trained checkpoint (step {TRAIN_LM_STEPS}): a prompt "
        f"of {len(prompt)} tokens, greedy {row[len(prompt):]}; launches {served}")
    return {"launches": launches, "seconds": secs, "final_loss": loss,
            "peak_gib": peak, "brain_update_ms": [u["latency_ms"] for u in updates]}


def phase_long_lm_path(workdir) -> dict:
    """One step of train.loop.main at LONG_LM_ARGV (S = 8192, K = 960)."""
    from forde_tpu_torch.train import loop

    args = loop.build_parser().parse_args(LONG_LM_ARGV)
    cfg = loop.config_from_args(args)
    out, launches, secs, peak = run_train_loop(LONG_LM_ARGV + ["--seed", str(SEED)], workdir)
    loss = out["final_metrics"]["loss/total"]
    pools = (args.seq_len - cfg.window_size) // cfg.compression_ratio
    log(f"[train_lm] long S: train.loop.main ({' '.join(LONG_LM_ARGV)}) took {secs:.2f} s; "
        f"loss {loss:.4f}, {pools} pools per row, peak memory allocated {peak:.2f} GiB, "
        f"launches {launches}")
    if not np.isfinite(loss) or launches != lm_launches_per_step(cfg):
        raise AssertionError(f"long-S training step: loss {loss}, launches {launches}")
    return {"launches": launches, "seconds": secs, "loss": loss, "peak_gib": peak}


def lm_batch(batch: int, seq: int, vocab: int, device, seed: int) -> dict:
    import torch

    from forde_tpu_torch.data.lm import MarkovDataset

    host = next(iter(MarkovDataset(batch, seq, vocab, num_batches=1, seed=seed)))
    return {"input_ids": torch.from_numpy(host["input_ids"]).to(device)}


def lm_weights(cfg, device) -> dict:
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    model = FORDEDecoderLM(cfg, device=device, generator=gen)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def lm_train_state(cfg, weights, device, dtypes=None, impl="auto", moment_dtype=None):
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.state import create_train_state

    cfg = cfg.replace(attention_impl=impl, **({} if dtypes is None else {"dtypes": dtypes}))
    model = FORDEDecoderLM(cfg, device=device)
    model.load_state_dict(weights)
    return create_train_state(cfg, None, 3e-4, 0.01, moment_dtype=moment_dtype, model=model)


class plain_lm_kernels:
    """Context: every kernel wrapper of the decoder LM's path takes its
    plain version on CUDA tensors too (the all-plain path of phase 12):
    the same arithmetic as the kernels, in PyTorch operations."""

    NAMES = (("flash_attention", "flash_fwd"), ("flash_attention", "flash_bwd_dq"),
             ("flash_attention", "flash_bwd_dkv"), ("nsa_attention", "small_kv_fwd"),
             ("nsa_attention", "small_kv_bwd"))

    def __enter__(self):
        import importlib

        self.saved = []
        for module, name in self.NAMES:
            mod = importlib.import_module(f"forde_tpu_torch.ops.{module}")
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, f"{name}_reference"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# Phase 12 bars. One training step of the reference-default decoder from
# the same weights and batch (2 x 2,048): the relative L2 of the loss, the
# gradients (Adam's first moment after the step, i.e. 0.1 x the clipped
# gradient) and the parameters after the AdamW update, kernel path vs the
# all-plain path (every kernel replaced by its plain version). fp32 bars:
# summation order, and what that order flips (an MoE routing choice or an
# NSA top-k selection whose two candidates lie within fp32 noise; Adam's
# first step, ~lr * sign(g), for gradients at noise level; the parameters
# dilute the update by |update| / |params| ~ 1e-2). bf16: at random
# initialisation a fifth to a half of the NSA top-k selections and a tenth
# to a third of the MoE routings flip between ANY two bf16 runs (ties of
# bf16 importance scores and router logits), so one batch's bf16 step is
# chaotic: on an NVIDIA H100 two paths that are equally precise per
# kernel read 0.15-0.63 apart on three batches, and the plain path's own
# control 0.23-0.67 (scripts/lm_bf16_step_chaos.py shows the flips). So
# the bf16 bar holds the mean over LM_PARITY_SEEDS' batches of each reading
# to 1.5x the mean of its control (plain bf16 vs plain fp32); phase 3
# holds each kernel's bf16 error to its plain version's. The plain attention path (attention_impl="reference") is read
# beside them: fp32 to the same bars; its bf16 backward is autograd in fp32
# (ds and delta unrounded), so its bf16 readings are reported, not held.
LM_PARITY_BATCH = 2
LM_PARITY_SEEDS = (SEED + 41, SEED + 50, SEED + 51)
LM_PARITY_TOL_FP32 = {"loss": 1e-4, "grads": 5e-2, "params": 2e-3}
LM_PARITY_OF_CONTROL = 1.5


def lm_step_outputs(cfg, weights, device, name, seed, launches) -> dict:
    """One training step of the decoder ``cfg`` from ``weights`` on path
    ``name`` (kernel / plain / reference, then 32 or 16 for the dtype) on
    the batch of ``seed``: the loss, the gradients (Adam's first moment)
    and the parameters after it, flat fp32; the step's launches go into
    ``launches[name]``."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.step import train_step

    dtypes = DTypePolicy.fp32() if name.endswith("32") else DTypePolicy.bf16()
    impl = "reference" if name.startswith("reference") else "auto"
    state = lm_train_state(cfg, weights, device, dtypes, impl)
    batch = lm_batch(LM_PARITY_BATCH, LM_SEQ, cfg.vocab_size, device, seed)
    kernels.reset_launches()
    with plain_lm_kernels() if name.startswith("plain") else contextlib.nullcontext():
        state, m = train_step(state, batch, aux_loss_weight=0.01)
    torch.cuda.synchronize()
    launches[name] = dict(kernels.launches)
    out = {"loss": m["loss/total"].reshape(1).float(),
           "grads": torch.cat([t.flatten().float() for t in state.optimizer.mu]),
           "params": torch.cat([t.detach().flatten().float() for t in state.optimizer.params])}
    del state
    torch.cuda.empty_cache()
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"non-finite step on the {name} path")
    return out


def rel_l2s(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in a}


def phase_lm_step_parity(device) -> dict:
    """One training step of the reference-default decoder on the kernel
    path, the all-plain path (the kernels' plain versions) and the plain
    attention path (attention_impl="reference"): fp32 and bf16 on the
    first batch, bf16 and its control on every batch of LM_PARITY_SEEDS;
    and the launches of the kernel path's step."""
    cfg = serve_config()
    weights = lm_weights(cfg, device)
    launches = {}

    def one_step(name, seed):
        return lm_step_outputs(cfg, weights, device, name, seed, launches)

    readings = {}
    first = {name: one_step(name, LM_PARITY_SEEDS[0]) for name in (
        "kernel32", "plain32", "reference32", "kernel16", "plain16", "reference16")}
    readings["fp32"] = rel_l2s(first["kernel32"], first["plain32"])
    readings["reference_fp32"] = rel_l2s(first["kernel32"], first["reference32"])
    readings["reference_bf16"] = rel_l2s(first["kernel16"], first["reference16"])
    readings["reference_control"] = rel_l2s(first["reference16"], first["reference32"])
    per_batch = [(rel_l2s(first["kernel16"], first["plain16"]),
                  rel_l2s(first["plain16"], first["plain32"]))]
    del first
    for seed in LM_PARITY_SEEDS[1:]:
        run = {name: one_step(name, seed) for name in ("kernel16", "plain16", "plain32")}
        per_batch.append((rel_l2s(run["kernel16"], run["plain16"]),
                          rel_l2s(run["plain16"], run["plain32"])))
        del run
    for i, (bf16, control) in enumerate(per_batch):
        readings[f"bf16_batch{i}"], readings[f"control_batch{i}"] = bf16, control
    readings["bf16"] = {k: float(np.mean([b[k] for b, _ in per_batch])) for k in per_batch[0][0]}
    readings["control"] = {k: float(np.mean([c[k] for _, c in per_batch])) for k in per_batch[0][1]}
    for name, r in readings.items():
        log(f"[lm parity] {name}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    want = lm_launches_per_step(cfg)
    log(f"[lm parity] launches of one step: kernel path {launches['kernel32']}, all-plain "
        f"path {launches['plain32']}, plain attention path {launches['reference32']}")
    if (launches["kernel32"] != want or launches["kernel16"] != want
            or any(v for k, v in launches.items() if not k.startswith("kernel"))):
        raise AssertionError(f"launches of one training step: {launches}, expected {want}")
    for name in ("fp32", "reference_fp32"):
        for k, tol in LM_PARITY_TOL_FP32.items():
            if not readings[name][k] <= tol:
                raise AssertionError(f"LM step parity {name} {k}: {readings[name][k]:.3e} > {tol:g}")
    for k, v in readings["bf16"].items():
        bar = LM_PARITY_OF_CONTROL * readings["control"][k]
        if not v <= bar:
            raise AssertionError(f"LM step parity bf16 {k} (mean of {len(per_batch)} batches): "
                                 f"{v:.3e} > {bar:.3e}")
    return {"readings": readings, "launches_per_step": launches["kernel16"]}


def phase_lm_train_timing(device) -> dict:
    """The training step of the reference-default decoder, bf16, batch 8 x
    2,048: median of 5 after 2 warm-ups (host clock ending in a
    synchronize), tokens/s, the MoE slow loop's latency, one step under
    the profiler."""
    import torch

    from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step
    from forde_tpu_torch.train.step import train_step

    cfg = serve_config()
    state = lm_train_state(cfg, lm_weights(cfg, device), device)
    batch = lm_batch(8, LM_SEQ, cfg.vocab_size, device, SEED + 42)

    def step():
        train_step(state, batch, aux_loss_weight=0.01)

    for _ in range(2):
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    tokens = 8 * LM_SEQ / step_ms * 1e3
    log(f"[time] LM train step (8 x 2048, bf16): {' / '.join(f'{t:.1f}' for t in times)} ms, "
        f"median {step_ms:.2f} ms, {tokens:.0f} tokens/s")

    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    slow = []
    for _ in range(3):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = moe_slow_loop_step(state.model, cfg, gen)
        skipped = bool(diag["skipped"])
        torch.cuda.synchronize()
        slow.append((time.perf_counter() - t0) * 1e3)
        if skipped:
            raise AssertionError("the timed MoE slow loop skipped its update")
    log(f"[time] MoE slow loop ({cfg.num_layers} layers x {cfg.num_experts} experts): {' / '.join(f'{t:.2f}' for t in slow)} ms")
    prof = profile_device(step, "one LM train step (8 x 2048, bf16)", top=16)
    return {"step_ms": step_ms, "step_ms_all": times, "tokens_per_s": tokens,
            "slow_loop_ms": float(np.median(slow)), "idle_share": prof["idle_share"],
            "busy_ms": prof["busy_ms"]}


# The fp32 LM step's rows: 8 x 2,048 if the step's peak stays under this
# many GiB on both paths, else 4 x 2,048.
LM_FP32_PEAK_GIB = 70.0


def lm_fp32_step_timing(device) -> dict:
    """The reference-default decoder's training step with DTypePolicy.fp32()
    (every train.loop run without --bf16): median of 5 after a warm-up,
    the kernel path against the all-plain path (plain_lm_kernels), at 8 x
    2,048 if both paths' peaks stay under LM_FP32_PEAK_GIB, else at 4 x
    2,048; and one kernel-path step under the profiler (its top kernels)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.step import train_step

    cfg = serve_config()
    state = lm_train_state(cfg, lm_weights(cfg, device), device, DTypePolicy.fp32())

    def step(batch, plain=False):
        with plain_lm_kernels() if plain else contextlib.nullcontext():
            train_step(state, batch, aux_loss_weight=0.01)

    def peak_gib(batch, plain):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            step(batch, plain)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            return float("inf")
        return torch.cuda.max_memory_allocated() / 2 ** 30

    batch = lm_batch(8, LM_SEQ, cfg.vocab_size, device, SEED + 45)
    peaks = {"kernel": peak_gib(batch, False), "plain": peak_gib(batch, True)}
    rows = 8
    if max(peaks.values()) >= LM_FP32_PEAK_GIB:
        rows = 4
        batch = lm_batch(rows, LM_SEQ, cfg.vocab_size, device, SEED + 45)
        peaks = {"kernel": peak_gib(batch, False), "plain": peak_gib(batch, True)}
    times = {}
    for name, plain in (("kernel", False), ("plain", True)):
        step(batch, plain)
        times[name] = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, plain)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    medians = {name: float(np.median(ts)) for name, ts in times.items()}
    log(f"[time] LM train step fp32 ({rows} x {LM_SEQ}, peak kernel path "
        f"{peaks['kernel']:.2f} GiB, all-plain path {peaks['plain']:.2f} GiB; 8 rows if both "
        f"stay under {LM_FP32_PEAK_GIB:g} GiB, else 4): kernel path "
        f"{' / '.join(f'{t:.1f}' for t in times['kernel'])} ms, median {medians['kernel']:.2f}; "
        f"all-plain path {' / '.join(f'{t:.1f}' for t in times['plain'])} ms, median "
        f"{medians['plain']:.2f}")
    prof = profile_device(lambda: step(batch), f"one fp32 LM train step ({rows} x {LM_SEQ})",
                          top=16)
    return {"rows": rows, "step_ms": medians["kernel"], "plain_step_ms": medians["plain"],
            "step_ms_all": times["kernel"], "plain_step_ms_all": times["plain"],
            "peak_gib": peaks, "tokens_per_s": rows * LM_SEQ / medians["kernel"] * 1e3,
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"]}


def flash_bwd_bound(b, h, s, d, window, causal, part, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one flash_bwd_dq or
    flash_bwd_dkv call: q, k, v, do, lse and delta read once, dq (or dk and
    dv) written once; 2 * D operations per product and visible (query,
    key): three products for dq (q k^T, do v^T, ds k), four for dk/dv
    (q k^T, do v^T, p^T do, ds^T q)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    outs = 1 if part == "dq" else 2
    moved = (4 + outs) * b * h * s * d * elem + 2 * b * h * s * 4
    _, fwd_ops_ms = flash_fwd_bound(b, h, s, d, window, causal, None, dtype_name)
    products = 3 if part == "dq" else 4
    return moved / HBM_BYTES_PER_S * 1e3, fwd_ops_ms * products / 2


def small_kv_bwd_bound(q, k, key_pos, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one small_kv_bwd: q, do, k, v and
    key_pos read once, dq, dk, dv written once; 10 * D operations per
    visible (query, key) pair (q k^T, do v^T, w^T do, ds k, ds^T q), and
    2 * D per real key for a query that sees none (its uniform weights
    reach dv only)."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    b, h, s, d = q.shape
    kk = k.shape[2]
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = (3 * b * h * s * d + 4 * b * h * kk * d) * elem + b * kk * 4
    pos = torch.arange(s, device=q.device)[None, :, None]
    real = key_pos[:, None, :] < INVALID_KEY_POS
    n_vis = ((pos >= key_pos[:, None, :]) & real).sum(-1)  # (B, S)
    blind = float((real.sum(-1) * (n_vis == 0)).sum())
    ops = (10.0 * float(n_vis.sum()) + 2.0 * blind) * d * h
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


# Timed shapes of the backward kernels: (name, B, H, S, window) of the
# 4-D backward at the training step and on the streaming side; (name, B,
# H, S, K, keys) of small_kv_bwd, one step layer's two launches and the
# 960 pools of S = 8192.
FLASH_BWD_TIMING = [
    ("train_s2048_window512", 8, 8, 2048, WINDOW),
    ("stream_s8192_window512", 1, 8, 8192, WINDOW),
]
SMALL_KV_BWD_TIMING = [
    ("train_pools_s2048_k192", 8, 8, 2048, 192, "pools"),
    ("train_topk_s2048_k64", 8, 8, 2048, 64, "topk"),
    ("long_pools_s8192_k960", 1, 8, 8192, 960, "pools"),
]


def phase_training_kernel_timing(device) -> dict:
    """Per call of flash_bwd_dq, flash_bwd_dkv (flash_bwd_timing) and
    small_kv_bwd (small_kv_bwd_timing) at the training shapes, bf16 and
    fp32."""
    return {**flash_bwd_timing(device), "small_kv_bwd": small_kv_bwd_timing(device)}


def flash_bwd_timing(device) -> dict:
    """Per call of flash_bwd_dq and flash_bwd_dkv at FLASH_BWD_TIMING (D
    64), bf16 and fp32 (the route of every run without --bf16; names with
    "_fp32"): kernel, plain version, the backward of SDPA with the same
    mask in the same dtype (a yardstick only: the port never calls it; it
    computes dq, dk and dv in one call, so both kernels carry it) and the
    bound. fp32 rows also carry the bound by operations at three TF32
    passes (``operations_tf32x3_ms``), and five fp32 calls of each kernel
    are profiled. Inputs cycle through copies that together exceed the
    50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 44)
    d = 64
    scale = d ** -0.5
    out = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for (name, b, h, s, window), (dtype_name, suffix) in itertools.product(
            FLASH_BWD_TIMING, (("bfloat16", ""), ("float32", "_fp32"))):
        dt = getattr(torch, dtype_name)
        elem = 2 if dt == torch.bfloat16 else 4
        tag = suffix[1:] or "bf16"
        copies = max(2, -(-200_000_000 // (4 * b * h * s * d * elem)))
        pos = torch.arange(s, device=device)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        inputs = []
        for _ in range(copies):
            q, k, v, do = (torch.randn(b, h, s, d, device=device, generator=gen).to(dt)
                           for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, scale, window, True, None)
            delta = fa._delta(o, do, None)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
            inputs.append(((q, k, v, do, lse, delta, scale, window, True, None), o_lib, do))
        shape = {"B": b, "H": h, "S": s, "D": d, "window": window}
        library = [lambda i=i: i[1].backward(i[2], retain_graph=True) for i in inputs]
        for part, kernel, plain in (("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
                                    ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference)):
            label = f"flash_bwd_{part} {name} (B={b}, H={h}, S={s}, D={d}, {tag})"
            row = time_kernel(
                label, [lambda i=i: kernel(*i[0]) for i in inputs],
                [lambda i=i: plain(*i[0]) for i in inputs[:2]],
                library, *flash_bwd_bound(b, h, s, d, window, True, part, dtype_name),
                dtype=dtype_name, **shape)
            if dt == torch.float32:
                add_tf32x3_bound(label, row)
                # Five calls: a one-call window after a large profile session
                # can read no device time (PERF.md §7.7).
                profile_device(lambda: [kernel(*inputs[j % len(inputs)][0]) for j in range(5)],
                               f"five calls, {label}", top=4)
            out[f"flash_bwd_{part}"][name + suffix] = row
        del inputs, library
        torch.cuda.empty_cache()
    return out


def small_kv_bwd_timing(device) -> dict:
    """small_kv_bwd per call at SMALL_KV_BWD_TIMING (D 64), bf16 and fp32
    (names with "_fp32"): kernel, plain version, SDPA's backward with the
    same -1e9/-inf mask in the same dtype (a yardstick only) and the bound;
    fp32 rows also carry the bound by operations at three TF32 passes
    (``operations_tf32x3_ms``), and five fp32 calls are profiled (their
    CUDA kernels' device times). Inputs cycle through copies that together
    exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import nsa_attention as nsa

    gen = torch.Generator(device=device).manual_seed(SEED + 46)
    d = 64
    scale = d ** -0.5
    out = {}
    for (name, b, h, s, kk, kind), (dtype_name, suffix) in itertools.product(
            SMALL_KV_BWD_TIMING, (("bfloat16", ""), ("float32", "_fp32"))):
        dt = getattr(torch, dtype_name)
        elem = 2 if dt == torch.bfloat16 else 4
        tag = suffix[1:] or "bf16"
        per_copy = (2 * b * h * s * d + 2 * b * h * kk * d) * elem
        copies = max(2, -(-200_000_000 // per_copy))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        qpos = torch.arange(s, device=device)[None, None, :, None]
        kpos = key_pos[:, None, None, :]
        add = torch.where(qpos >= kpos, 0.0, nsa.NEG_BIG)
        add = torch.where(kpos >= nsa.INVALID_KEY_POS, -float("inf"), add).to(dt)
        inputs = []
        for _ in range(copies):
            q, do = (torch.randn(b, h, s, d, device=device, generator=gen).to(dt) for _ in range(2))
            k, v = (torch.randn(b, h, kk, d, device=device, generator=gen).to(dt) for _ in range(2))
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=add, scale=scale)
            inputs.append(((q, k, v, key_pos, do, scale), o_lib, do))
        label = f"small_kv_bwd {name} (B={b}, H={h}, S={s}, K={kk}, D={d}, {tag})"
        row = time_kernel(
            label, [lambda i=i: nsa.small_kv_bwd(*i[0]) for i in inputs],
            [lambda i=i: nsa.small_kv_bwd_reference(*i[0]) for i in inputs[:2]],
            [lambda i=i: i[1].backward(i[2], retain_graph=True) for i in inputs],
            *small_kv_bwd_bound(inputs[0][0][0], inputs[0][0][1], key_pos, dtype_name),
            dtype=dtype_name, B=b, H=h, S=s, K=kk, D=d)
        if dt == torch.float32:
            add_tf32x3_bound(label, row)
            # The dq, dk/dv and chunk-sum kernels' shares, over five calls: after
            # a large profile session (the fp32 LM step's) the profiler drops a
            # new session's first kernel records, so a one-call window can
            # read no device time; the counts say how many calls it kept.
            profile_device(lambda: [nsa.small_kv_bwd(*inputs[j % len(inputs)][0])
                                    for j in range(5)], f"five calls, {label}", top=4)
        out[name + suffix] = row
        del inputs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Compiled steps: the NSA prefill's top-k replay on the device, the decode
# step replayed from a CUDA graph, the dual encoder's fused k steps
# ---------------------------------------------------------------------------

TOPK_K = 64  # k_sel of the reference-default decoder (top_k_global)
# (name, rows, P, kind, empty index): the serving prefill's 12 layers x 8
# rows with the prompts' -inf pads, one position, every score tied, and the
# 8,192-token serving's 2 layers x 1 row of 6,000 positions.
TOPK_CASES = [
    ("serve_prefill_n96_p2048_ragged", 96, 2048, "ragged", 2048),
    ("p1_n96", 96, 1, "random", 2048),
    ("all_tied_n96_p2048", 96, 2048, "tied", 2048),
    ("long_n2_p6000", 2, 6000, "random", 8192),
]


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def topk_scores(kind, n, p, device, gen):
    import torch

    if kind == "tied":
        return torch.zeros(n, p, device=device)
    s = torch.randn(n, p, device=device, generator=gen)
    if kind == "ragged":
        lens = torch.tensor(SERVE_PROMPT_LENS * (n // len(SERVE_PROMPT_LENS)), device=device)
        s = torch.where(torch.arange(p, device=device)[None, :] < lens[:, None], s,
                        -float("inf"))
    return s


def topk_accepts(scores, k: int) -> np.ndarray:
    """Accepted insertions of each row's replay (numpy, on the host)."""
    s = scores.float().cpu().numpy()
    n, p = s.shape
    kept = np.full((n, k), -np.inf, np.float32)
    count = np.zeros(n, np.int64)
    rows = np.arange(n)
    for t in range(p):
        slot = kept.argmin(axis=1)
        accept = s[:, t] > kept[rows, slot]
        kept[rows[accept], slot[accept]] = s[accept, t]
        count += accept
    return count


def topk_replay_bound(scores, k: int, clock_hz: float) -> tuple:
    """(ms by bytes, ms by operations, longest row's accepted insertions)
    of one topk_replay. Bytes: the scores read once, the kept scores and
    positions written once. Operations: the insertion order makes a row a
    chain, each accepted insertion a first-minimum reduction over K slots,
    at least log2(K) dependent steps; the longest row's chain at one step a
    cycle of the SM clock, or the N * P comparisons at the fp32 peak,
    whichever is longer."""
    import math

    n, p = scores.shape
    moved = n * p * 4 + n * k * 8
    accepts = int(topk_accepts(scores, k).max())
    chain_ms = accepts * math.ceil(math.log2(max(k, 2))) / clock_hz * 1e3
    compare_ms = n * p / PEAK_OPS_PER_S["float32"] * 1e3
    return moved / HBM_BYTES_PER_S * 1e3, max(chain_ms, compare_ms), accepts


def phase_topk_replay(device) -> dict:
    """topk_replay against its plain version on the card, exactly (kept
    scores and positions, slot order included), at TOPK_CASES; then its
    time at the serving prefill's shape beside the plain version's and the
    bound (no one PyTorch call computes this insertion-ordered set)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.ops.topk_replay import topk_replay, topk_replay_reference

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    out, max_err, index_mismatches = {}, 0.0, 0
    for name, n, p, kind, empty in TOPK_CASES:
        scores = topk_scores(kind, n, p, device, gen)
        kept, idx = topk_replay(scores, TOPK_K, empty)
        want_kept, want_idx = topk_replay_reference(scores, TOPK_K, empty)
        torch.cuda.synchronize()
        # Equal slots (two empty ones included) differ by 0, a filled slot
        # against an empty one by inf.
        err = float(torch.where(kept == want_kept, 0.0, (kept - want_kept).abs()).max())
        wrong_idx = int((idx != want_idx).sum())
        max_err, index_mismatches = max(max_err, err), index_mismatches + wrong_idx
        same = bool(torch.equal(kept, want_kept) and wrong_idx == 0)
        filled = int((idx != empty).sum())
        log(f"[topk_replay] {name} (N={n}, P={p}, K={TOPK_K}): kernel vs plain identical {same} "
            f"(max |kept - plain| {err}, {wrong_idx} positions differ); {filled} of "
            f"{n * TOPK_K} slots filled")
        if not same:
            bad = (idx != want_idx) | (kept != want_kept)
            raise AssertionError(f"topk_replay {name}: {int(bad.sum())} slots differ, first at "
                                 f"{bad.nonzero()[:4].tolist()}")
        if name.startswith("serve_prefill"):
            clock = sm_clock_hz()
            bytes_ms, ops_ms, accepts = topk_replay_bound(scores, TOPK_K, clock)
            copies = [scores.clone() for _ in range(4)]
            kern = [lambda c=c: topk_replay(c, TOPK_K, empty) for c in copies]
            plain = [lambda c=c: topk_replay_reference(c, TOPK_K, empty) for c in copies[:2]]
            ms = cuda_ms(kern)
            dev_ms = device_ms(kern)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by = bound(bytes_ms, ops_ms)
            log(f"[topk_replay] {name}: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.5f} "
                f"ms; chain of {accepts} accepted insertions x log2 K at {clock / 1e9:.2f} GHz "
                f"{ops_ms:.5f} ms)")
            out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
                         "bytes_ms": bytes_ms, "operations_ms": ops_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "longest_chain_accepts": accepts, "N": n, "P": p,
                         "K": TOPK_K}
            del copies
    kernels.reset_launches()
    return {"max_abs_err": max_err, "index_mismatches": index_mismatches, "shapes": out}


DECODE_GRAPH_NEW = 16


def phase_decode_graph(device, state, serve_parity) -> dict:
    """The serving batch, greedy, fp32 and bf16: the decode replayed from
    its CUDA graph (the first call captures it, the second only replays)
    against eager decode (cuda_graph=False) from the same weights: the
    tokens identical, the last step's logits bit-identical (every kernel of
    a decode step is deterministic; were they not, the relative L2 would be
    held to phase 9's bar, SERVE_PARITY_OF_CONTROL x its control), and the
    launches of each call exact, replays counted."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import _generate

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    want = serve_launches(cfg, DECODE_GRAPH_NEW)
    bar = SERVE_PARITY_OF_CONTROL * serve_parity["control_plain_bf16_vs_fp32"]
    out = {}
    for name, dtypes in (("fp32", DTypePolicy.fp32()), ("bf16", DTypePolicy.bf16())):
        m = FORDEDecoderLM(cfg.replace(dtypes=dtypes), device=device)
        m.load_state_dict(state)
        m.eval()
        runs = {}
        for label, graph in (("capture", True), ("replay", True), ("eager", False)):
            kernels.reset_launches()
            with torch.no_grad():
                ids, last = _generate(m, padded, lens, None, DECODE_GRAPH_NEW, 0.0, None, None,
                                      None, 0, graph)
            torch.cuda.synchronize()
            runs[label] = (ids, last, dict(kernels.launches))
        (graph_obj, _, _), = m._decode_graphs.values()
        eager_ids, eager_last, _ = runs["eager"]
        readings = {}
        for label in ("capture", "replay"):
            ids, last, launches = runs[label]
            if not torch.equal(ids, eager_ids):
                raise AssertionError(f"decode graph {name} ({label}): tokens differ from eager at "
                                     f"{(ids != eager_ids).nonzero()[:4].tolist()}")
            identical = bool(torch.equal(last, eager_last))
            rel = float((last - eager_last).norm() / eager_last.norm())
            readings[label] = {"logits_bit_identical": identical, "logits_rel_l2": rel}
            if not identical and not rel < bar:
                raise AssertionError(f"decode graph {name} ({label}): last logits relative L2 "
                                     f"{rel:.3e} >= {bar:.3e}")
        for label, (_, _, launches) in runs.items():
            if launches != want:
                raise AssertionError(f"decode graph {name} ({label}): launches {launches}, "
                                     f"expected {want}")
        log(f"[decode graph] {name}: tokens ({DECODE_GRAPH_NEW} new x {len(SERVE_PROMPT_LENS)} "
            f"rows) identical to eager; last logits {readings}; launches per call {want}, per "
            f"replayed step {graph_obj.launches}")
        out[name] = readings
        out[f"{name}_launches_per_replay"] = dict(graph_obj.launches)
        out[f"{name}_sampled"] = decode_graph_sampled(m, name, padded, lens, want)
        del m, graph_obj
        torch.cuda.empty_cache()
    return out


# Sampled decoding in phase_decode_graph: serve's sampling flags.
DECODE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


def decode_graph_sampled(m, name, padded, lens, want) -> dict:
    """Sampled decoding (DECODE_SAMPLING) through the graph against eager,
    from two generators seeded alike, over two calls (the first captures,
    the second only replays): the tokens identical and each generator's
    state after the call equal. A replay that drew the same numbers on
    every step, or did not hand the advanced Philox state back to the
    caller's generator, fails."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.models.generate import _generate

    s = DECODE_SAMPLING
    gens = {label: torch.Generator(device=padded.device).manual_seed(SEED + 50)
            for label in ("graph", "eager")}
    start = gens["eager"].get_state()
    for call in ("capture", "replay"):
        ids = {}
        for label, graph in (("graph", True), ("eager", False)):
            kernels.reset_launches()
            with torch.no_grad():
                ids[label], _ = _generate(m, padded, lens, gens[label], DECODE_GRAPH_NEW,
                                          s["temperature"], s["top_k"], s["top_p"], None, 0, graph)
            torch.cuda.synchronize()
            if dict(kernels.launches) != want:
                raise AssertionError(f"decode graph {name} sampled ({call}, {label}): launches "
                                     f"{dict(kernels.launches)}, expected {want}")
        if not torch.equal(ids["graph"], ids["eager"]):
            raise AssertionError(f"decode graph {name} sampled ({call}): tokens differ from eager "
                                 f"at {(ids['graph'] != ids['eager']).nonzero()[:4].tolist()}")
        states = [g.get_state() for g in gens.values()]
        if not torch.equal(*states) or torch.equal(states[0], start):
            raise AssertionError(f"decode graph {name} sampled ({call}): generator state after "
                                 f"the graphed call differs from eager's, or did not advance")
    log(f"[decode graph] {name} sampled {s}: tokens identical to eager and generator states "
        f"equal after a capturing and a replaying call")
    return {"tokens_identical": True, "generator_state_equal": True}


# Serving at --seq_len 8192: 2 layers, one prompt of 6,000 tokens (the
# prefill's 4-D attention at S > 2,048, 750 complete pools), a few tokens.
SERVE_LONG_FLAGS = [
    "--d_model", "512", "--num_layers", "2", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "8192", "--bf16",
]
SERVE_LONG_PROMPT = 6000
SERVE_LONG_NEW = 8


def phase_serve_long(device) -> dict:
    """generate_cached at SERVE_LONG_FLAGS with seeded random weights: the
    graphed decode's tokens identical to eager decode's, exact launches."""
    import torch

    from forde_tpu_torch import kernels, serve
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_cached

    cfg = serve.config_from_args(serve.build_parser().parse_args(SERVE_LONG_FLAGS))
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    model = FORDEDecoderLM(cfg, device=device, generator=gen).eval()
    prompt = np.random.RandomState(SEED + 14).randint(1, cfg.vocab_size, SERVE_LONG_PROMPT)
    ids = torch.tensor(prompt[None], device=device)
    want = serve_launches(cfg, SERVE_LONG_NEW)
    rows, secs = {}, {}
    for label, graph in (("graph", True), ("eager", False)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows[label] = generate_cached(model, ids, None, max_new_tokens=SERVE_LONG_NEW,
                                      temperature=0.0, cuda_graph=graph)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if launches != want:
            raise AssertionError(f"serving at S 8192 ({label}): launches {launches}, "
                                 f"expected {want}")
    new = rows["graph"][0, SERVE_LONG_PROMPT:].tolist()
    if not torch.equal(rows["graph"], rows["eager"]) or not all(
            0 <= t < cfg.vocab_size for t in new):
        raise AssertionError(f"serving at S 8192: graphed {new}, eager "
                             f"{rows['eager'][0, SERVE_LONG_PROMPT:].tolist()}")
    pools = SERVE_LONG_PROMPT // cfg.compression_ratio
    log(f"[serve long] --seq_len 8192, {cfg.num_layers} layers, one prompt of "
        f"{SERVE_LONG_PROMPT} tokens ({pools} pools), {SERVE_LONG_NEW} new: graphed tokens "
        f"{new} identical to eager; {secs['graph']:.2f} s graphed (capture included), "
        f"{secs['eager']:.2f} s eager; launches {want}")
    del model
    torch.cuda.empty_cache()
    return {"launches": want, "seconds_graph": secs["graph"], "seconds_eager": secs["eager"],
            "new_tokens": new}


FUSE_K = 8
FUSE_BATCH = 128


def copy_train_state_(dst, src) -> None:
    """Everything a dual-encoder train step reads and writes, copied from
    ``src`` into ``dst`` in place."""
    import torch

    with torch.no_grad():
        for d, s in zip(dst.model.state_dict().values(), src.model.state_dict().values()):
            d.copy_(s)
        torch._foreach_copy_(dst.optimizer.mu, src.optimizer.mu)
        torch._foreach_copy_(dst.optimizer.nu, src.optimizer.nu)
        dst.optimizer.count.copy_(src.optimizer.count)
        for k in dst.grad_stats:
            dst.grad_stats[k].copy_(src.grad_stats[k])
        dst.grad_step_count.copy_(src.grad_step_count)
    dst.step = src.step


def phase_fused_steps(device) -> dict:
    """make_fused_step at vit_b16_hd128, bf16, batch 128, k = FUSE_K with
    sensing every FUSE_K-th step: the first call runs the k steps (the
    graph's warm-up) and captures them; a second state takes the first's
    values in place, and then one replayed call on another super-batch is
    held against the same k steps run eagerly from there. Params, both Adam
    moments, act_stats, grad_stats and the last step's loss and grad_norm
    bit-identical, or within phase 6's bf16 bars; the step counts and the
    launches exact. Then pairs/s fused against unfused, and one replayed
    call under the profiler."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.train.clip_step import (
        clip_train_step,
        make_fused_step,
        make_nosense_step,
        stack_batches,
    )

    torch.cuda.empty_cache()
    cfg = main_path_config().replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batches = []
    for i in range(FUSE_K):
        b = training_batch(cfg, FUSE_BATCH, device, SEED + 30 + i)
        b["image"] = b["image"].to(cfg.dtypes.compute)
        batches.append(b)
    rolled = batches[1:] + batches[:1]
    fused = make_fused_step(cfg, FUSE_K, FUSE_K)
    first = fused.prepare(next(stack_batches(iter(batches), FUSE_K)))
    second = fused.prepare(next(stack_batches(iter(rolled), FUSE_K)))
    nosense = make_nosense_step(cfg)

    def eager_steps(state, seq):
        m = None
        for i, b in enumerate(seq):
            state, m = (clip_train_step if i % FUSE_K == 0 else nosense)(state, b)
        return m

    fused_state = train_state(cfg, weights, device)
    eager_state = train_state(cfg, weights, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused(fused_state, first)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    copy_train_state_(eager_state, fused_state)

    kernels.reset_launches()
    fused_state, fm = fused(fused_state, second)
    torch.cuda.synchronize()
    fused_launches = dict(kernels.launches)
    kernels.reset_launches()
    em = eager_steps(eager_state, rolled)
    torch.cuda.synchronize()
    eager_launches = dict(kernels.launches)
    sensed, unsensed = launches_per_step(cfg, True), launches_per_step(cfg, False)
    want = {k: sensed[k] + (FUSE_K - 1) * unsensed[k] for k in sensed}
    for label, got in (("fused", fused_launches), ("eager", eager_launches)):
        if got != want:
            raise AssertionError(f"fused steps: {label} launches {got}, expected {want}")
    if (fused_state.step, int(fused_state.grad_step_count), int(fused_state.optimizer.count)) != (
            eager_state.step, int(eager_state.grad_step_count), int(eager_state.optimizer.count)):
        raise AssertionError("fused steps: step counts differ from the eager steps'")

    def gather(state, m):
        layers = stateful_layers(state.model).values()
        return {
            "loss": m["loss/contrastive"].reshape(1), "grad_norm": m["training/grad_norm"].reshape(1),
            "act_stats": torch.cat([layer.act_stats.flatten() for layer in layers]),
            "step_count": torch.stack([layer.step_count for layer in layers]).float(),
            "grad_stats": torch.cat([g.flatten() for g in state.grad_stats.values()]),
            "grads": torch.cat([x.float().flatten() for x in state.optimizer.mu]),
            "nu": torch.cat([x.float().flatten() for x in state.optimizer.nu]),
            "params": torch.cat([p.detach().float().flatten() for p in state.optimizer.params]),
        }

    got, ref = gather(fused_state, fm), gather(eager_state, em)
    readings = {}
    for k in ref:
        identical = bool(torch.equal(got[k], ref[k]))
        rel = float((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
        readings[k] = {"bit_identical": identical, "rel_l2": rel}
        tol = PARITY_TOL["bf16"].get("grads" if k == "nu" else k, 0.0)
        if not identical and not rel <= tol:
            raise AssertionError(f"fused vs eager steps {k}: relative L2 {rel:.3e} > {tol:g}")
    shown = ", ".join(f"{k} " + ("identical" if r["bit_identical"] else f"{r['rel_l2']:.3e}")
                      for k, r in readings.items())
    log(f"[fused] {FUSE_K} steps, sensing every {FUSE_K}th (vit_b16_hd128, bf16, batch 128): "
        f"first call (warm-up + capture) {capture_s:.2f} s; a replayed call against the same "
        f"steps run eagerly: {shown}; launches per call {want}; step {fused_state.step}, sensed "
        f"{int(fused_state.grad_step_count)}")

    def call_ms(run, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    unfused = lambda: eager_steps(eager_state, rolled)  # noqa: E731
    graphed = lambda: fused(fused_state, second)  # noqa: E731
    u1, f1, f2, u2 = (call_ms(r) for r in (unfused, graphed, graphed, unfused))
    fused_ms, unfused_ms = min(f1, f2), min(u1, u2)
    pairs = FUSE_BATCH * FUSE_K / fused_ms * 1e3
    unfused_pairs = FUSE_BATCH * FUSE_K / unfused_ms * 1e3
    log(f"[time] {FUSE_K} steps at batch 128 (sensing every {FUSE_K}th): fused (one graph) "
        f"{f1:.2f} / {f2:.2f} ms, unfused {u1:.2f} / {u2:.2f} ms; pairs/s fused {pairs:.1f}, "
        f"unfused {unfused_pairs:.1f}")
    prof = profile_device(graphed, f"one replayed fused call ({FUSE_K} steps, batch 128)")
    del fused, graphed, unfused, fused_state, eager_state
    torch.cuda.empty_cache()
    return {"readings": readings, "launches_per_call": want, "first_call_s": capture_s,
            "fused_ms": fused_ms, "unfused_ms": unfused_ms, "pairs_per_s_fused": pairs,
            "pairs_per_s_unfused": unfused_pairs, "fused_idle_share": prof["idle_share"],
            "fused_busy_ms": prof["busy_ms"]}


# The training CLI with --fuse_steps 4: vit_b16 (the CLI's preset), bf16,
# batch 128, sensing every 4th step, the GMM slow loop every 4 steps.
TRAIN_FUSED_ARGV = [
    "--preset", "vit_b16", "--bf16", "--use_dummy_data", "--dummy_pool", "4",
    "--batch_size", "128", "--num_steps", "8", "--sense_interval", "4",
    "--slow_loop_interval", "4", "--moment_dtype", "bfloat16", "--warmup_steps", "4",
    "--log_interval", "4", "--fuse_steps", "4",
]


def phase_train_fused_cli(workdir) -> dict:
    """clip_loop.main at TRAIN_FUSED_ARGV: finite loss, exact launches (two
    fused calls of 1 sensed + 3 unsensed steps), two brain updates between
    the calls that were not skipped."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.train import clip_loop

    args = clip_loop.build_parser().parse_args(TRAIN_FUSED_ARGV)
    cfg = clip_loop.config_from_args(args)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = clip_loop.main(TRAIN_FUSED_ARGV + ["--seed", str(SEED)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.chdir(cwd)
    loss = out["final_metrics"]["loss/contrastive"]
    sensed, unsensed = launches_per_step(cfg, True), launches_per_step(cfg, False)
    n_sensed = args.num_steps // args.sense_interval
    want = {k: n_sensed * sensed[k] + (args.num_steps - n_sensed) * unsensed[k] for k in sensed}
    layers = cfg.vision.num_layers + cfg.text.num_layers
    updates = out["brain_updates"]
    log(f"[train fused] clip_loop.main ({' '.join(TRAIN_FUSED_ARGV)}) took {secs:.2f} s; final "
        f"loss {loss:.4f}, launches {launches}, brain updates at "
        f"{[u['step'] for u in updates]}")
    if not np.isfinite(loss) or out["step"] != args.num_steps or launches != want:
        raise AssertionError(f"fused training CLI: loss {loss}, steps {out['step']}, launches "
                             f"{launches}, expected {want}")
    if [u["step"] for u in updates] != [4, 8] or any(
        u["skipped"] or u["sensed_steps_before"] != layers or u["grad_stats_abs_sum_after"] != 0
        for u in updates
    ):
        raise AssertionError(f"brain updates of the fused training CLI: {updates}")
    return {"launches": launches, "seconds": secs, "final_loss": loss,
            "pairs_per_s": out["pairs_per_sec"]}


# ---- generation extras (prefix caching, beam search, full recompute,
# speculative decoding, int8 weights) and their serve flags -------------

def build_lm(cfg, state, device, dtypes=None, impl="auto"):
    """The decoder LM of ``cfg`` (with ``dtypes``/``impl`` if given) holding
    ``state``, in eval mode."""
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    cfg = cfg.replace(attention_impl=impl, **({} if dtypes is None else {"dtypes": dtypes}))
    m = FORDEDecoderLM(cfg, device=device)
    m.load_state_dict(state)
    return m.eval()


def wall_ms(fn) -> float:
    """Host clock around ``fn()``, between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def counted(fn) -> tuple:
    """(fn(), the kernel launches it made): counts set to 0 just before,
    read just after."""
    import torch

    from forde_tpu_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def dense_serve_config():
    """SERVE_FLAGS + --no_nsa: the reference-default decoder with dense
    causal attention (the configs prefix caching and speculative decoding
    serve)."""
    from forde_tpu_torch import serve

    return serve.config_from_args(serve.build_parser().parse_args(SERVE_FLAGS + ["--no_nsa"]))


def seeded_state(cfg, device, seed: int) -> dict:
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    gen = torch.Generator(device=device).manual_seed(seed)
    m = FORDEDecoderLM(cfg, device=device, generator=gen)
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


# Prefix caching: one shared prefix of 1,024 tokens (a system prompt), 8
# ragged suffixes of 64-512 tokens, 32 new tokens, greedy.
PREFIX_LEN = 1024
PREFIX_SUFFIX_LENS = (64, 128, 192, 256, 320, 384, 448, 512)
PREFIX_NEW = 32
# bf16 bar: the relative L2 of the prefill's last logits (those that pick
# the first new token), prefix path vs the concatenated prompt's prefill,
# both bf16, under this share of the control (the concatenated prefill in
# bf16 vs in fp32). Both round every activation to bf16, at other GEMM
# shapes (a 1,024-row prefix, then the suffix rows, vs one prefill of
# both), so they differ by bf16 roundings and the routing flips these
# cause; a path less precise than bf16 allows reads at or above the
# control. The same reasoning as phase 9's SERVE_PARITY_OF_CONTROL.
PREFIX_BF16_OF_CONTROL = 0.75


def phase_prefix(device) -> dict:
    """Prefix caching on the dense variant: greedy tokens of
    generate_ragged continuing from prefill_prefix's cache, identical in
    fp32 to generate_ragged over prefix + suffix; in bf16 the prefill's
    last logits within PREFIX_BF16_OF_CONTROL x the control, the tokens'
    agreement printed; the prefix cache unchanged by the calls; no kernel
    of csrc launched (dense attention is plain); TTFT with and without the
    prefix (bf16)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import generate as G

    cfg = dense_serve_config()
    state = seeded_state(cfg, device, SEED + 60)
    rng = np.random.RandomState(SEED + 61)
    prefix = torch.tensor(rng.randint(1, cfg.vocab_size, (1, PREFIX_LEN)), device=device)
    sufs = [rng.randint(1, cfg.vocab_size, n).tolist() for n in PREFIX_SUFFIX_LENS]
    padded, lens = serve_batch(sufs, device)
    whole, whole_lens = serve_batch([prefix[0].tolist() + s for s in sufs], device)
    bidx = torch.arange(len(sufs), device=device)
    out, last, cover, path_launches = {}, {}, {}, Counter()
    for name, dtypes in (("fp32", DTypePolicy.fp32()), ("bf16", DTypePolicy.bf16())):
        m = build_lm(cfg, state, device, dtypes)
        with torch.no_grad():
            pc, launches = counted(lambda: G.prefill_prefix(m, prefix))
            before = {k: v.clone() for k, v in pc["layer_0"]["causal_attention"].items()}
            (ids_p, _), l1 = counted(lambda: G._generate(
                m, padded, lens, None, PREFIX_NEW, 0.0, None, None, None, 0, True, pc))
            (ids_w, _), l2 = counted(lambda: G._generate(
                m, whole, whole_lens, None, PREFIX_NEW, 0.0, None, None, None, 0, True))
            path_launches.update(launches)
            path_launches.update(l1)
            if launches or l1 or l2:
                raise AssertionError(f"prefix ({name}): the dense path launched {launches} "
                                     f"{l1} {l2}")
            if not all(torch.equal(pc["layer_0"]["causal_attention"][k], v)
                       for k, v in before.items()) or int(G.prefix_length(pc)) != PREFIX_LEN:
                raise AssertionError(f"prefix ({name}): the prefix cache changed")
            rows_p = [ids_p[i, : n + PREFIX_NEW] for i, n in enumerate(PREFIX_SUFFIX_LENS)]
            rows_w = [ids_w[i, PREFIX_LEN: PREFIX_LEN + n + PREFIX_NEW]
                      for i, n in enumerate(PREFIX_SUFFIX_LENS)]
            out[name] = (rows_p, rows_w)
            cache = G.tile_prefix_cache(pc, len(sufs))
            logits, _ = m(padded, cache=cache)
            last[f"{name}_prefix"] = logits[bidx, lens - 1]
            cache = m.init_cache(len(sufs), device)
            logits, _ = m(whole, cache=cache)
            last[f"{name}_whole"] = logits[bidx, whole_lens - 1]
            del cache, logits
        if name == "bf16":
            def gen(with_prefix, new):
                if with_prefix:
                    return G.generate_ragged(m, padded, lens, None, max_new_tokens=new,
                                             temperature=0.0, prefix_cache=pc)
                return G.generate_ragged(m, whole, whole_lens, None, max_new_tokens=new,
                                         temperature=0.0)
            for label, flag in (("prefix", True), ("whole", False)):
                gen(flag, 2)  # warm-up (and the decode graph's capture)
                cover[f"ttft_ms_{label}"] = float(np.median(
                    [wall_ms(lambda: gen(flag, 1)) for _ in range(3)]))
            cover["prefill_prefix_ms"] = float(np.median(
                [wall_ms(lambda: G.prefill_prefix(m, prefix)) for _ in range(3)]))
        del m
        torch.cuda.empty_cache()
    same32 = all(torch.equal(a, b) for a, b in zip(*out["fp32"]))
    agree16 = float(np.mean([float((a == b).float().mean()) for a, b in zip(*out["bf16"])]))
    readings = {"fp32_last_logits": rel_l2(last["fp32_prefix"], last["fp32_whole"]),
                "bf16_last_logits": rel_l2(last["bf16_prefix"], last["bf16_whole"]),
                "control_bf16_vs_fp32": rel_l2(last["bf16_whole"], last["fp32_whole"]),
                "bf16_token_agreement": agree16}
    bar = PREFIX_BF16_OF_CONTROL * readings["control_bf16_vs_fp32"]
    log(f"[prefix] dense variant, a prefix of {PREFIX_LEN} tokens, {len(sufs)} suffixes of "
        f"{PREFIX_SUFFIX_LENS[0]}-{PREFIX_SUFFIX_LENS[-1]}, {PREFIX_NEW} new, greedy: fp32 "
        f"tokens identical to the concatenated prompt's {same32}; readings {readings}; bf16 "
        f"bar {bar:.3e}; no csrc kernel launched; the prefix cache unchanged")
    log(f"[prefix] TTFT (bf16, median of 3): with the prefix cache {cover['ttft_ms_prefix']:.2f} "
        f"ms, the whole prompt {cover['ttft_ms_whole']:.2f} ms; prefill_prefix "
        f"{cover['prefill_prefix_ms']:.2f} ms once")
    if not same32:
        raise AssertionError("prefix: fp32 tokens differ from the concatenated prompt's")
    if not readings["bf16_last_logits"] < bar:
        raise AssertionError(f"prefix: bf16 last logits {readings['bf16_last_logits']:.3e} "
                             f">= {bar:.3e}")
    # launches: prefill_prefix and the generation from its cache, both dtypes
    return {**readings, **cover, "launches": dict(path_launches)}


# Beam search on the NSA config: 2 prompts of 1,100 and 1,500 tokens, beam
# 4, 32 new, length penalty 0.6, an EOS that the greedy path emits.
BEAM_PROMPT_LENS = (1100, 1500)
BEAM_SIZE = 4
BEAM_NEW = 32
BEAM_PENALTY = 0.6
BEAM_EOS_AT = 8  # the EOS is the greedy path's token at this new position


def beam_scores(model, prompt, new, eos_id, length_penalty):
    """(1, P) prompt, (R, N) continuations -> (R,) beam scores, rescored by
    ``model``'s own cached decode (nsa_prefill, then one decode step per
    token), apart from generate_beam's scoring: the summed fp32 logprobs
    up to and including the first EOS, over gen_len ** length_penalty."""
    import torch

    from forde_tpu_torch.models import generate as G

    r = new.shape[0]
    with torch.no_grad():
        cache, last = G.nsa_prefill(model, prompt.expand(r, -1).contiguous())
        total = torch.zeros(r, dtype=torch.float64, device=new.device)
        length = torch.zeros(r, dtype=torch.float64, device=new.device)
        live = torch.ones(r, dtype=torch.bool, device=new.device)
        for i in range(new.shape[1]):
            tok = new[:, i]
            lp = torch.log_softmax(last.float(), dim=-1).gather(1, tok[:, None])[:, 0]
            total += torch.where(live, lp.double(), 0.0)
            length += live.double()
            live &= tok != eos_id
            if i + 1 < new.shape[1]:
                logits, _ = model(tok[:, None], cache=cache)
                last = logits[:, 0, :]
    return (total / length ** length_penalty).tolist()


def phase_beam(device, state) -> dict:
    """generate_beam per prompt (batch 1, 4 beams) on the serving config's
    weights, in fp32: exact launches (flash_fwd, small_kv_fwd and
    topk_replay per call, the serving counts); on the first prompt the
    kernel path equal to the plain path token for token; on each prompt the
    best beam's score at least the greedy continuation's (generate_cached
    with the EOS), both rescored by the plain model's cached decode
    (beam_scores); bf16 ms per decode step and the tokens' agreement with
    fp32."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import generate as G

    cfg = serve_config()
    rng = np.random.RandomState(SEED + 70)
    prompts = [torch.tensor(rng.randint(1, cfg.vocab_size, (1, n)), device=device)
               for n in BEAM_PROMPT_LENS]
    want = serve_launches(cfg, BEAM_NEW)
    kern = build_lm(cfg, state, device, DTypePolicy.fp32())
    greedy = G.generate_cached(kern, prompts[0], None, max_new_tokens=BEAM_NEW,
                               temperature=0.0)
    eos = int(greedy[0, BEAM_PROMPT_LENS[0] + BEAM_EOS_AT])
    beam = dict(max_new_tokens=BEAM_NEW, beam_size=BEAM_SIZE, length_penalty=BEAM_PENALTY,
                eos_id=eos)
    res, launches, new = {}, [], {}
    for i, prompt in enumerate(prompts):
        ids4, l4 = counted(lambda: G.generate_beam(kern, prompt, **beam))
        cached = G.generate_cached(kern, prompt, None, max_new_tokens=BEAM_NEW,
                                   temperature=0.0, eos_id=eos)
        p = prompt.shape[1]
        new[i] = torch.cat([ids4[:, p:], cached[:, p:]])
        res[i] = {"ids": ids4, "beam_is_greedy": bool(torch.equal(ids4, cached))}
        launches.append(l4)
    del kern
    plain = build_lm(cfg, state, device, DTypePolicy.fp32(), impl="reference")
    res[0]["kernel_equals_plain"] = bool(torch.equal(
        G.generate_beam(plain, prompts[0], **beam), res[0]["ids"]))
    for i, prompt in enumerate(prompts):
        rows = new[i][:1] if res[i]["beam_is_greedy"] else new[i]
        scores = beam_scores(plain, prompt, rows, eos, BEAM_PENALTY)
        # The same tokens have the same score: one rescoring serves both.
        res[i]["score_beam"], res[i]["score_greedy"] = scores[0], scores[-1]
    del plain
    torch.cuda.empty_cache()
    m = build_lm(cfg, state, device, DTypePolicy.bf16())
    ids = [None]

    def run(n):
        ids[0] = G.generate_beam(m, prompts[0], **{**beam, "max_new_tokens": n})
    first = wall_ms(lambda: run(1))
    step_ms = (wall_ms(lambda: run(BEAM_NEW)) - first) / (BEAM_NEW - 1)
    agree = float((ids[0] == res[0]["ids"]).float().mean())
    del m
    torch.cuda.empty_cache()
    summary = {f"prompt_{n}": {k: v for k, v in res[i].items() if k != "ids"}
               for i, n in enumerate(BEAM_PROMPT_LENS)}
    log(f"[beam] NSA config, beam {BEAM_SIZE}, {BEAM_NEW} new, length penalty {BEAM_PENALTY}, "
        f"eos {eos}, scores rescored by the plain fp32 model's cached decode: {summary}; "
        f"launches per call {launches} (expected {want} each); bf16 ms per decode step (batch "
        f"{BEAM_SIZE}) {step_ms:.3f}, bf16 tokens agreeing with fp32 {agree}")
    if not res[0]["kernel_equals_plain"]:
        raise AssertionError("beam: fp32 kernel path differs from the plain path")
    for i, r in res.items():
        if not r["score_beam"] >= r["score_greedy"]:
            raise AssertionError(f"beam prompt {i}: best beam's score {r['score_beam']} < the "
                                 f"greedy continuation's {r['score_greedy']}")
    if any(l != want for l in launches):
        raise AssertionError(f"beam launches {launches}, expected {want} per call")
    return {"prompts": summary, "launches": launches[0], "bf16_ms_per_step": step_ms,
            "bf16_token_agreement": agree}


# Full-recompute generate: NSA config, batch 2, 256-token prompts (below
# the window, where it coincides with generate_cached), 16 new, greedy.
FULL_BATCH = 2
FULL_PROMPT = 256
FULL_NEW = 16


def phase_full_recompute(device, state) -> dict:
    """generate (one forward over the whole buffer per new token): fp32
    tokens identical to generate_cached's, launches exactly FULL_NEW
    forwards' (flash_fwd and each small_kv_fwd branch once per layer and
    token), the MoE stat buffers as loaded; bf16 tokens' agreement."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import generate as G

    cfg = serve_config()
    ids = torch.tensor(np.random.RandomState(SEED + 80).randint(
        1, cfg.vocab_size, (FULL_BATCH, FULL_PROMPT)), device=device)
    n = cfg.num_layers
    want = {"flash_fwd": FULL_NEW * n, "small_kv_fwd": 2 * FULL_NEW * n}
    out = {}
    for name, dtypes in (("fp32", DTypePolicy.fp32()), ("bf16", DTypePolicy.bf16())):
        m = build_lm(cfg, state, device, dtypes)
        usage = m.layers[0].moe.expert_usage.clone()
        full, launches = counted(lambda: G.generate(m, ids, None, max_new_tokens=FULL_NEW,
                                                    temperature=0.0))
        secs = wall_ms(lambda: G.generate(m, ids, None, max_new_tokens=FULL_NEW,
                                          temperature=0.0)) / 1e3
        cached = G.generate_cached(m, ids, None, max_new_tokens=FULL_NEW, temperature=0.0)
        out[name] = {"identical": bool(torch.equal(full, cached)),
                     "agreement": float((full == cached).float().mean()),
                     "launches": launches, "seconds": secs,
                     "usage_kept": bool(torch.equal(m.layers[0].moe.expert_usage, usage))}
        del m
        torch.cuda.empty_cache()
    log(f"[full recompute] NSA config, batch {FULL_BATCH}, prompt {FULL_PROMPT}, {FULL_NEW} new, "
        f"greedy: {out}; expected launches {want}")
    if not out["fp32"]["identical"]:
        raise AssertionError("full recompute: fp32 tokens differ from generate_cached's")
    for name, r in out.items():
        if r["launches"] != want or not r["usage_kept"]:
            raise AssertionError(f"full recompute ({name}): launches {r['launches']}, expected "
                                 f"{want}; expert usage kept {r['usage_kept']}")
    return {**out, "launches": out["fp32"]["launches"]}


# Speculative decoding: the dense variant as the target, a 512-token
# prompt, 32 new, gamma 4, greedy; drafts: (i) the target's own weights,
# (ii) a seeded 2-layer dense draft, each from a checkpoint.
SPEC_PROMPT = 512
SPEC_NEW = 32
SPEC_GAMMA = 4
SPEC_DRAFT_LAYERS = 2


def phase_speculative(device) -> dict:
    """generate_speculative with the two drafts loaded from checkpoints
    (train.checkpoint.load_lm_params, as serve loads them): in fp32 the
    tokens identical to the target's generate_cached for both, and the
    draft that is the target accepts every proposal (rounds =
    ceil(SPEC_NEW / (gamma + 1))); no csrc kernel launched; bf16 with the target
    as its own draft: tokens' agreement, tokens/forward and ms per output
    token beside generate_cached's, graphed and eager."""
    import torch

    from forde_tpu_torch import interop
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import generate as G
    from forde_tpu_torch.models.speculative import generate_speculative
    from forde_tpu_torch.train.checkpoint import load_lm_params, save_params

    cfg = dense_serve_config()
    state = seeded_state(cfg, device, SEED + 90)
    dcfg = cfg.replace(num_layers=SPEC_DRAFT_LAYERS)
    dstate = seeded_state(dcfg, device, SEED + 91)
    prompt = torch.tensor(np.random.RandomState(SEED + 92).randint(
        1, cfg.vocab_size, (1, SPEC_PROMPT)), device=device)
    rounds_all = -(-SPEC_NEW // (SPEC_GAMMA + 1))
    out, path_launches = {}, Counter()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        drafts = {}
        for label, c, s in (("self", cfg, state), ("draft2", dcfg, dstate)):
            save_params(os.path.join(tmp, label), c,
                        interop.flatten(interop.state_dict_to_flax(s)), {"step": 0})
            dc, loaded = load_lm_params(os.path.join(tmp, label), device)
            drafts[label] = (dc, loaded.state_dict())
            del loaded
        for name, dtypes in (("fp32", DTypePolicy.fp32()), ("bf16", DTypePolicy.bf16())):
            target = build_lm(cfg, state, device, dtypes)
            ref, _ = counted(lambda: G.generate_cached(target, prompt, None,
                                                       max_new_tokens=SPEC_NEW,
                                                       temperature=0.0))
            res = {}
            for label in ("self", "draft2") if name == "fp32" else ("self",):
                draft = build_lm(*drafts[label], device, dtypes)
                run = (lambda: generate_speculative(target, draft, prompt, None,
                                                    max_new_tokens=SPEC_NEW, gamma=SPEC_GAMMA,
                                                    temperature=0.0, with_stats=True))
                t0 = time.perf_counter()
                (ids, stats), launches = counted(run)
                path_launches.update(launches)
                res[label] = {"identical": bool(torch.equal(ids, ref)),
                              "agreement": float((ids == ref).float().mean()),
                              "tokens_per_forward": stats["generated"] / stats["rounds"],
                              "rounds": stats["rounds"], "launches": launches,
                              "ms_per_output_token":
                                  (time.perf_counter() - t0) * 1e3 / SPEC_NEW}
                del draft
            if name == "bf16":
                for label, graph in (("cached_graph", True), ("cached_eager", False)):
                    def cached():
                        G.generate_cached(target, prompt, None, max_new_tokens=SPEC_NEW,
                                          temperature=0.0, cuda_graph=graph)
                    if graph:
                        cached()  # warm-up (and the graph's capture)
                    res[label] = {"ms_per_output_token": wall_ms(cached) / SPEC_NEW}
            out[name] = res
            del target
            torch.cuda.empty_cache()
    log(f"[speculative] dense target, prompt {SPEC_PROMPT}, {SPEC_NEW} new, gamma {SPEC_GAMMA}, "
        f"greedy; drafts: the target itself, a {SPEC_DRAFT_LAYERS}-layer seeded draft; ms per "
        f"output token = the whole call / {SPEC_NEW}: {out}")
    for label, r in out["fp32"].items():
        if not r["identical"]:
            raise AssertionError(f"speculative ({label}): fp32 tokens differ from "
                                 "generate_cached's")
    if path_launches:
        raise AssertionError(f"speculative: the dense path launched {dict(path_launches)}")
    if out["fp32"]["self"]["rounds"] != rounds_all:
        raise AssertionError(f"speculative: the target as its own draft took "
                             f"{out['fp32']['self']['rounds']} rounds, expected {rounds_all}")
    return {**out, "launches": dict(path_launches)}


# int8 weights: the NSA serving batch (8 prompts of 640-1,920 tokens, 32
# new, greedy) with quantize_params applied to the bf16 model. Three
# exact gates hold the int8 path itself:
# * the int8 weights and scales equal a plain quantization of the bf16
#   model's weights (int8_weights_plain);
# * int8_matmul equals the integer product, computed in fp64 (exact: every
#   partial sum is an integer below 2^53), at each shape the serving path
#   gives it (recorded from one eager prefill and decode step) and at the
#   shapes of the other quantized paths (INT8_MM_EXTRA_SHAPES);
# * the quantized model's last logits against the same model with every
#   int8 product (QDense and the expert bank) computed by
#   plain_int8_product, which quantizes the activations by the same recipe
#   and rescales in the same fp32 order: every other op of the forward is
#   deterministic, so a right int8 path reads 0; the bar,
#   INT8_PLAIN_REL_L2, is a few fp32 roundings of the whole.
# Beside them a coarse bound on the quantization error: the relative L2 of
# the last logits, int8 vs the bf16 model it was quantized from, under
# INT8_OF_CONTROL x phase 9's control (the plain path in bf16 vs fp32, same
# weights and batch); both are dominated by the MoE routing flips that a
# rounding causes, which twelve layers of random weights carry far, so it
# catches only a gross fault (read 0.434 against a control of 0.543 on an
# NVIDIA H100 80GB HBM3 at 700 W).
INT8_OF_CONTROL = 1.0
INT8_PLAIN_REL_L2 = 1e-6
# (rows, K, N) of int8 products on quantized paths that the NSA serving
# batch does not take: the dense variant's qkv_proj/out_proj at a decode
# step (8 rows), beam search's batch of 4 beams, speculative
# verification's gamma + 1 = 5 rows, and the lm_head at those rows.
INT8_MM_EXTRA_SHAPES = ((8, 512, 1536), (8, 512, 512), (5, 512, 1536), (5, 512, 512),
                        (4, 512, 1536), (4, 512, 50257), (5, 512, 50257))


def weight_bytes(model, serving_dtype_bytes: int = 2) -> int:
    """Bytes of the weights the products read when serving: int8 leaves
    1 byte, their fp32 scales 4, every other floating-point parameter in
    the compute dtype (2 bytes in bf16)."""
    import torch

    total = 0
    for name, p in model.named_parameters():
        if p.dtype == torch.int8:
            total += p.numel()
        elif name.endswith("scale"):
            total += 4 * p.numel()
        else:
            total += serving_dtype_bytes * p.numel()
    return total


def plain_int8_product(x, w_q, w_scale):
    """x (..., din) float, w_q (din, dout) int8, w_scale (dout,) -> (...,
    dout) fp32: x quantized per row (s = max|x| / 127, round half to even),
    the integer product in fp64, rescaled by both scales in fp32."""
    import torch

    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / s), -127, 127)
    return (xq.double() @ w_q.double()).float() * s * w_scale


@contextlib.contextmanager
def plain_int8_products():
    """QDense and the expert bank computing their int8 products by
    plain_int8_product."""
    from unittest import mock

    import torch

    from forde_tpu_torch.nn.moe import ExpertsFFN
    from forde_tpu_torch.ops.quant import QDense

    def dense(self, x):
        out = plain_int8_product(x, self.weight_q.t(), self.scale)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(self.compute_dtype)

    def experts(x, w_q, w_scale, group=None):
        if group is not None:  # a row-parallel product: not one rank's
            raise ValueError("plain_int8_products is one rank's")
        return torch.stack([plain_int8_product(x if x.ndim == 2 else x[e], w_q[e], w_scale[e])
                            for e in range(w_q.shape[0])])

    with mock.patch.object(QDense, "forward", dense), \
            mock.patch.object(ExpertsFFN, "_q_products", staticmethod(experts)):
        yield


def int8_weights_plain(q, fp) -> list:
    """Names of q's int8 leaves that differ from a plain quantization of
    fp's weights (per output channel: s = max|w| / 127 over the input
    axis, q = round(w / s))."""
    import torch

    from forde_tpu_torch.nn.moe import ExpertsFFN
    from forde_tpu_torch.ops.quant import QDense

    def plain(w, axis):
        w = w.float()
        scale = torch.clamp(w.abs().amax(dim=axis, keepdim=True) / 127.0, min=1e-12)
        return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale

    bad = []
    for name, mod in q.named_modules():
        src = fp.get_submodule(name)
        if isinstance(mod, QDense):
            pairs = [(mod.weight_q, mod.scale, *plain(src.weight, 1))]
        elif isinstance(mod, ExpertsFFN) and mod.quantized:
            pairs = [(getattr(mod, f"w_{p}_q"), getattr(mod, f"w_{p}_scale"),
                      *plain(getattr(src, f"w_{p}"), 1)) for p in ("up", "down")]
        else:
            continue
        for got_q, got_s, want_q, want_s in pairs:
            if not (torch.equal(got_q, want_q) and torch.equal(got_s.flatten(),
                                                                want_s.flatten())):
                bad.append(name)
    return bad


def int8_matmul_exact(q, padded, lens, device) -> dict:
    """int8_matmul against the fp64 integer product at every shape one
    eager prefill and decode step of ``q`` give it (their own operands,
    the first call of each shape) and at INT8_MM_EXTRA_SHAPES (seeded
    int8 operands, the largest sums included): {shape: max |difference|}."""
    from unittest import mock

    import torch

    from forde_tpu_torch.models import generate as G
    from forde_tpu_torch.nn import moe
    from forde_tpu_torch.ops import quant

    real, seen = quant.int8_matmul, {}

    def record(xq, wq):
        if (xq.shape[0], *wq.shape) not in seen:
            seen[(xq.shape[0], *wq.shape)] = (xq.clone(), wq.clone())
        return real(xq, wq)

    with mock.patch.object(quant, "int8_matmul", record), \
            mock.patch.object(moe, "int8_matmul", record):
        G.generate_ragged(q, padded, lens, None, max_new_tokens=2, temperature=0.0,
                          cuda_graph=False)
    gen = torch.Generator(device=device).manual_seed(SEED + 110)
    for m, k, n in INT8_MM_EXTRA_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        xq[0], wq[0] = 127, -127
        seen.setdefault((m, k, n), (xq, wq.t()))
    err = {}
    for (m, k, n), (xq, wq) in seen.items():
        got = real(xq, wq)
        if got.dtype != torch.int32 or got.shape != (m, n):
            err[f"{m}x{k}x{n}"] = float("inf")
            continue
        worst = 0.0
        for i in range(0, m, 2048):  # the prefill's lm_head: 16,384 x 50,257
            want = xq[i: i + 2048].double() @ wq.double()
            worst = max(worst, float((got[i: i + 2048].double() - want).abs().max()))
        err[f"{m}x{k}x{n}"] = worst
        del got
    return err


def phase_int8(device, state, serve_parity) -> dict:
    """The serving batch on the bf16 model and on quantize_params of it:
    the int8 weights equal a plain quantization; int8_matmul exact at the
    path's shapes; the int8 model's prefill last logits within
    INT8_PLAIN_REL_L2 of the same model with plain int8 products, and
    within INT8_OF_CONTROL x phase 9's control (relative L2) of the bf16
    model's; its greedy tokens' agreement printed, exact launches (the
    int8 products are library calls); TTFT, ms per output token and output
    tokens/s (decode graphed), weight bytes against bf16."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import generate as G
    from forde_tpu_torch.ops.quant import quantize_params

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    bf16 = build_lm(cfg, state, device, DTypePolicy.bf16())
    q = quantize_params(bf16)
    want = serve_launches(cfg, SERVE_NEW_TOKENS)
    bad_weights = int8_weights_plain(q, bf16)
    mm_err = int8_matmul_exact(q, padded, lens, device)
    with torch.no_grad():
        _, last16 = G.nsa_prefill(bf16, padded, lens)
        _, last8 = G.nsa_prefill(q, padded, lens)
        with plain_int8_products():
            _, last8_plain = G.nsa_prefill(q, padded, lens)
    ids16 = G.generate_ragged(bf16, padded, lens, None, max_new_tokens=SERVE_NEW_TOKENS,
                              temperature=0.0)
    ids8, launches = counted(lambda: G.generate_ragged(
        q, padded, lens, None, max_new_tokens=SERVE_NEW_TOKENS, temperature=0.0))
    n_out = len(SERVE_PROMPT_LENS) * SERVE_NEW_TOKENS

    def gen(new):
        G.generate_ragged(q, padded, lens, None, max_new_tokens=new, temperature=0.0)

    ttft = float(np.median([wall_ms(lambda: gen(1)) for _ in range(3)]))
    whole = float(np.median([wall_ms(lambda: gen(SERVE_NEW_TOKENS)) for _ in range(3)]))
    new8, new16 = ([ids[i, n: n + SERVE_NEW_TOKENS] for i, n in enumerate(SERVE_PROMPT_LENS)]
                   for ids in (ids8, ids16))
    r = {"int8_weights_differing_from_plain": bad_weights,
         "int8_matmul_max_abs_err": mm_err,
         "last_logits_vs_plain_int8_rel_l2": rel_l2(last8, last8_plain),
         "last_logits_vs_plain_int8_max_abs": float((last8 - last8_plain).abs().max()),
         "last_logits_rel_l2": rel_l2(last8, last16),
         "last_argmax_agreement": float((last8.argmax(-1) == last16.argmax(-1)).float().mean()),
         "token_agreement": float(np.mean([float((a == b).float().mean())
                                           for a, b in zip(new8, new16)])),
         "ttft_ms": ttft, "ms_per_output_token": (whole - ttft) / (SERVE_NEW_TOKENS - 1),
         "out_tokens_per_s": n_out / whole * 1e3,
         "weight_bytes_int8": weight_bytes(q), "weight_bytes_bf16": weight_bytes(bf16),
         "launches": launches}
    bar = INT8_OF_CONTROL * serve_parity["control_plain_bf16_vs_fp32"]
    log(f"[int8] serving batch ({len(SERVE_PROMPT_LENS)} prompts, {SERVE_NEW_TOKENS} new, "
        f"greedy, decode graphed), int8 weights from the bf16 model: {r}; bars: int8 leaves "
        f"and int8_matmul exact, last logits vs plain int8 products {INT8_PLAIN_REL_L2:g}, vs "
        f"bf16 {bar:.3e} ({INT8_OF_CONTROL:g} x phase 9's control)")
    del bf16, q
    torch.cuda.empty_cache()
    if bad_weights:
        raise AssertionError(f"int8: weights differ from a plain quantization: {bad_weights}")
    if any(e != 0.0 for e in mm_err.values()):
        raise AssertionError(f"int8: int8_matmul differs from the integer product: {mm_err}")
    if not r["last_logits_vs_plain_int8_rel_l2"] <= INT8_PLAIN_REL_L2:
        raise AssertionError(f"int8: last logits {r['last_logits_vs_plain_int8_rel_l2']:.3e} "
                             f"from the plain int8 products' > {INT8_PLAIN_REL_L2:g}")
    if not torch.isfinite(last8).all() or not r["last_logits_rel_l2"] < bar:
        raise AssertionError(f"int8: last logits relative L2 {r['last_logits_rel_l2']:.3e} "
                             f">= {bar:.3e}")
    if launches != want:
        raise AssertionError(f"int8 launches {launches}, expected {want}")
    return r


# serve's new flags on the card, each one `python -m forde_tpu_torch.serve`
# at 2 layers of the reference-default width (seeded random weights; the
# draft a 1-layer checkpoint), all four started together.
CLI_EXTRAS_FLAGS = [
    "--d_model", "512", "--num_layers", "2", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "2048", "--bf16", "--max_new_tokens", "8", "--temperature", "0",
]
CLI_PROMPT_LEN = 600  # past the window: every NSA branch live
CLI_NEW = 8


def phase_cli_extras(device, workdir) -> dict:
    """One serve process each for --prefix_ids, --beam_size 4,
    --draft_checkpoint_dir and --quantize int8: exit 0, the [serve] line of
    the feature, the prompt kept and the new tokens in the vocabulary."""
    from forde_tpu_torch import interop, serve
    from forde_tpu_torch.train.checkpoint import save_params

    dense = serve.config_from_args(serve.build_parser().parse_args(
        CLI_EXTRAS_FLAGS + ["--no_nsa"]))
    draft_dir = os.path.join(workdir, "cli_draft")
    dcfg = dense.replace(num_layers=1)
    save_params(draft_dir, dcfg, interop.flatten(interop.state_dict_to_flax(
        seeded_state(dcfg, device, SEED + 100))), {"step": 0})
    prompt = ",".join(map(str, np.random.RandomState(SEED + 101).randint(
        1, dense.vocab_size, CLI_PROMPT_LEN)))
    runs = {
        "prefix_ids": (["--no_nsa", "--prefix_ids", "11,12,13,14,15"],
                       "shared prefix prefilled once (5 tokens)"),
        "beam_size": (["--beam_size", "4", "--length_penalty", "0.6"], None),
        "draft_checkpoint_dir": (["--no_nsa", "--draft_checkpoint_dir", draft_dir],
                                 "tokens/forward"),
        "quantize": (["--quantize", "int8"], "int8 weight-only quantization applied"),
    }
    procs = {}
    for name, (flags, _) in runs.items():
        argv = [sys.executable, "-m", "forde_tpu_torch.serve", *CLI_EXTRAS_FLAGS, *flags,
                "--prompt_ids", prompt]
        procs[name] = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    t0 = time.perf_counter()
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        ids = [ln for ln in text.splitlines() if ln.startswith("token ids:")]
        row = json.loads(ids[-1].split(":", 1)[1]) if ids else []
        expect = runs[name][1]
        ok = (proc.returncode == 0 and row[:CLI_PROMPT_LEN] == [int(t) for t in prompt.split(",")]
              and len(row) == CLI_PROMPT_LEN + CLI_NEW and all(0 <= t < dense.vocab_size for t in row)
              and (expect is None or expect in text))
        serve_lines = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
        log(f"[cli] serve {name}: rc {proc.returncode}, new ids {row[CLI_PROMPT_LEN:]}; " + " | ".join(
            serve_lines))
        if not ok:
            log(text[-4000:])
            raise AssertionError(f"serve {' '.join(runs[name][0])} failed")
        out[name] = {"rc": proc.returncode, "new_ids": row[CLI_PROMPT_LEN:]}
    out["seconds"] = time.perf_counter() - t0
    log(f"[cli] four serve processes together: {out['seconds']:.1f} s")
    return out


# ---- continuous batching (models/decode_pool.py) and the HTTP daemon
# (serve_http.py) --------------------------------------------------------

# Phase 25: an 8-row pool at the serving width. Requests arrive staggered:
# POOL_FIRST before the first tick, then one every POOL_EVERY pooled steps
# (every second tick at decode_fuse 1). The gate: 12 greedy requests of
# 640-1,920 tokens, 8-16 new each; the trace: 24 requests, 8-48 new.
POOL_ROWS = 8
POOL_FIRST = 8
POOL_EVERY = 2
POOL_FUSE = 4
POOL_PROMPT_LENS = (640, 1920)
POOL_GATE = (12, (8, 16))  # (requests, new tokens: least, most)
POOL_TRACE = (24, (8, 48))
# The dense variant: 4 requests, a 1,024-token prefix, suffixes of 128-512,
# chunked prefill in chunks of 256.
POOL_DENSE_PREFIX = 1024
POOL_DENSE_SUFFIXES = (128, 256, 384, 512)
POOL_DENSE_NEW = 8
POOL_DENSE_CHUNK = 256


def pool_requests(count, new_range, vocab, seed):
    """(prompts, new-token budgets), from ``seed``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(POOL_PROMPT_LENS[0], POOL_PROMPT_LENS[1] + 1, count)
    news = rng.randint(new_range[0], new_range[1] + 1, count)
    return [rng.randint(1, vocab, n).tolist() for n in lens], [int(n) for n in news]


def pool_launches(cfg, admissions: int, steps: int) -> dict:
    """Kernel launches of a pool run on the NSA config: per admission the
    one-row nsa_prefill (flash_fwd and two small_kv_fwd per layer, one
    top-k replay), per pooled step two small_kv_fwd per layer (replays
    counted)."""
    n = cfg.num_layers
    return {"flash_fwd": n * admissions, "small_kv_fwd": 2 * n * (admissions + steps),
            "topk_replay": admissions}


def drive_pool(pool, prompts, budgets, **submit) -> tuple:
    """The staggered arrivals through ``pool``: POOL_FIRST requests before
    the first tick, then one every POOL_EVERY pooled steps (at once when
    the pool is idle); tick until every request finished. Returns (outputs
    in request order, host times (submitted, first token, last token) per
    request, seconds, the host time of each tick that admitted no
    request)."""
    import torch

    n = len(prompts)
    times = [[0.0, None, None] for _ in range(n)]

    def on_token(i):
        def record(rid, tok):
            now = time.perf_counter()
            times[i][1] = times[i][1] or now
            times[i][2] = now
        return record

    index, out, base, steady = {}, {}, pool._steps, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(out) < n:
        due = min(n, POOL_FIRST + (pool._steps - base) // POOL_EVERY)
        if not pool.pending():
            due = max(due, len(index) + 1)
        while len(index) < due:
            i = len(index)
            times[i][0] = time.perf_counter()
            index[pool.submit(prompts[i], budgets[i], on_token=on_token(i), **submit)] = i
        started = sum(t[1] is not None for t in times)
        tick0 = time.perf_counter()
        for rid, ids in pool.tick():
            out[index[rid]] = ids
        if sum(t[1] is not None for t in times) == started:
            steady.append((time.perf_counter() - tick0) * 1e3)
    secs = time.perf_counter() - t0
    return [out[i] for i in range(n)], times, secs, steady


def trace_readings(times, budgets, secs, steady, fuse) -> dict:
    """Output tokens/s of the trace, TTFT (submission to the first token)
    p50/p90, ms per output token per request p50, and the median host time
    of a pooled step in the ticks that admitted no request."""
    ttft = [(f - s) * 1e3 for s, f, _ in times]
    tpot = [(last - f) * 1e3 / (b - 1) for (_, f, last), b in zip(times, budgets)]
    return {"out_tokens_per_s": sum(budgets) / secs, "seconds": secs,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p90": float(np.percentile(ttft, 90)),
            "ms_per_output_token_p50": float(np.percentile(tpot, 50)),
            "ms_per_step_without_admission_p50": (float(np.median(steady)) / fuse
                                                  if steady else None),
            "ticks_without_admission": len(steady)}


def top2_margin(m, prompt, got, want) -> tuple:
    """(first new position where ``got`` and ``want`` differ, the top-2
    logit margin there, from a teacher-forced forward over the prompt and
    the tokens both agree on)."""
    import torch

    p = len(prompt)
    j = next(k for k in range(len(want) - p) if p + k >= len(got) or got[p + k] != want[p + k])
    with torch.no_grad():
        logits, _ = m(torch.tensor([want[: p + j]], device=m.lm_head.weight.device))
    top = logits[0, -1].topk(2).values
    return j, float(top[0] - top[1])


def plain_greedy(m, prompts, news) -> list:
    """Each prompt's greedy continuation (generate_cached, batch 1) on the
    plain model ``m`` (impl="reference"), its NSA prefill's top-k replay
    the plain version too: a reference that runs no kernel of csrc, which
    the run checks."""
    import torch

    from forde_tpu_torch.models import generate as G
    from forde_tpu_torch.ops import topk_replay as T

    dev = m.lm_head.weight.device
    kernel, G.topk_replay = G.topk_replay, T.topk_replay_reference
    try:
        refs, got = counted(lambda: [G.generate_cached(
            m, torch.tensor([p], device=dev), None, max_new_tokens=n,
            temperature=0.0)[0].tolist() for p, n in zip(prompts, news)])
    finally:
        G.topk_replay = kernel
    if got:
        raise AssertionError(f"the plain reference launched {got}")
    return refs


def phase_pool(device, state) -> dict:
    """Continuous batching on the reference-default decoder (NSA, 12
    layers), an 8-row pool. Gates: fp32 greedy tokens of 12 staggered
    requests equal each one's generate_cached continuation on the plain
    model (plain_greedy; the top-2 margin printed at a mismatch), so the
    kernels are held at the pool's own shapes; the graphed pool equals the eager pool
    (cuda_graph=False) in fp32 and bf16; decode_fuse 4 equals decode_fuse 1
    on the 24-request trace; the dense variant's chunked prefill (chunks
    of 256) and 1,024-token registered prefix equal the one-shot prefill of
    the concatenated prompt; exact launches per admission and per pooled
    step, replays counted. Readings (bf16): the trace's output tokens/s,
    TTFT p50/p90 and ms per output token at decode_fuse 1 and 4, a pooled
    step graphed and eager with its idle share, a one-row admission, and
    the same 24 requests as closed batches of 8 (generate_ragged), all
    present at the start. The trace is illustrative: its arrivals are
    paced in the pool's own steps and the closed batches see other
    arrivals, so the two are not a like-for-like comparison."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import decode_pool as DP
    from forde_tpu_torch.models import generate as G

    cfg = serve_config()
    gate_prompts, gate_new = pool_requests(*POOL_GATE, cfg.vocab_size, SEED + 110)
    prompts, budgets = pool_requests(*POOL_TRACE, cfg.vocab_size, SEED + 111)
    out, launches = {}, Counter()

    def run_pool(m, prompts, budgets, label, warm=False, **kw):
        pool = DP.DecodePool(m, rows=POOL_ROWS, temperature=0.0, **kw)
        if warm:  # capture the step's graph before the clock starts
            pool.submit(prompts[0], 2)
            while pool.pending():
                pool.tick()
        steps = pool._steps
        (ids, times, secs, steady), got = counted(lambda: drive_pool(pool, prompts, budgets))
        want = pool_launches(cfg, len(prompts), pool._steps - steps)
        if got != want:
            raise AssertionError(f"pool {label}: launches {got}, expected {want}")
        launches.update(got)
        log(f"[pool] {label}: {len(prompts)} requests, {pool._steps - steps} pooled steps, "
            f"{secs:.2f} s; launches {got}")
        return pool, ids, (times, secs, steady)

    # fp32: every request's tokens = its own generate_cached continuation on
    # the plain model
    m = build_lm(cfg, state, device, DTypePolicy.fp32())
    _, graphed, _ = run_pool(m, gate_prompts, gate_new, "fp32 graphed")
    _, eager, _ = run_pool(m, gate_prompts, gate_new, "fp32 eager", cuda_graph=False)
    del m
    torch.cuda.empty_cache()
    plain = build_lm(cfg, state, device, DTypePolicy.fp32(), impl="reference")
    refs = plain_greedy(plain, gate_prompts, gate_new)
    for i, (p, want) in enumerate(zip(gate_prompts, refs)):
        if graphed[i] != want:
            j, margin = top2_margin(plain, p, graphed[i], want)
            raise AssertionError(f"pool fp32 request {i} (prompt {len(p)}): new token {j} "
                                 f"differs from the plain model's generate_cached; top-2 logit "
                                 f"margin there {margin:.3e}")
    if graphed != eager:
        raise AssertionError("pool fp32: graphed tokens differ from eager")
    log(f"[pool] fp32, {len(gate_prompts)} requests of {min(map(len, gate_prompts))}-"
        f"{max(map(len, gate_prompts))} tokens, {min(gate_new)}-{max(gate_new)} new, {POOL_FIRST} "
        f"at tick 0 then one every {POOL_EVERY} steps, {POOL_ROWS} rows: tokens identical to "
        f"each one's generate_cached on the plain model, graphed = eager")
    del plain
    torch.cuda.empty_cache()

    m = build_lm(cfg, state, device, DTypePolicy.bf16())
    _, g16, _ = run_pool(m, gate_prompts, gate_new, "bf16 graphed")
    _, e16, _ = run_pool(m, gate_prompts, gate_new, "bf16 eager", cuda_graph=False)
    if g16 != e16:
        raise AssertionError("pool bf16: graphed tokens differ from eager")
    traces = {}
    for fuse in (1, POOL_FUSE):
        pool, ids, timing = run_pool(m, prompts, budgets, f"bf16 trace fuse {fuse}",
                                     warm=True, decode_fuse=fuse)
        traces[fuse] = (pool, ids)
        times, secs, steady = timing
        out[f"trace_fuse{fuse}"] = {**trace_readings(times, budgets, secs, steady, fuse),
                                    "pooled_steps": pool._steps}
    if traces[1][1] != traces[POOL_FUSE][1]:
        raise AssertionError(f"pool: decode_fuse {POOL_FUSE} tokens differ from decode_fuse 1")
    log(f"[pool] bf16: graphed = eager on the {len(gate_prompts)} requests; decode_fuse "
        f"{POOL_FUSE} = decode_fuse 1 on the {len(prompts)}-request trace")

    pool = traces[1][0]
    st, graph = pool.static, pool._graphs[(False, 1)]
    with torch.no_grad():
        def eager_step():
            DP._step_pool(m, st, pool._gen, False)
        step = {"graph_ms": cuda_ms([graph.replay], reps=20),
                "eager_ms": cuda_ms([eager_step], reps=10, warmup=1)}
        prof_g = profile_device(graph.replay, f"one replayed pooled step ({POOL_ROWS} rows)")
        prof_e = profile_device(eager_step, f"one eager pooled step ({POOL_ROWS} rows)")
        mid = torch.tensor([prompts[0]], device=device)
        admit_ms = float(np.median([wall_ms(lambda: DP._prefill_one_nsa(
            m, mid, pool._gen, 0.0, 0, 1.0)) for _ in range(3)]))
    step.update(graph_idle_share=prof_g["idle_share"], graph_busy_ms=prof_g["busy_ms"],
                eager_idle_share=prof_e["idle_share"], eager_busy_ms=prof_e["busy_ms"])
    # a tick's host time with no admission, against one step's device busy
    for fuse in (1, POOL_FUSE):
        per_step = out[f"trace_fuse{fuse}"]["ms_per_step_without_admission_p50"]
        step[f"scheduler_idle_share_fuse{fuse}"] = (
            None if per_step is None else 1 - prof_g["busy_ms"] / per_step)
    out.update(pooled_step=step, admission_ms=admit_ms, admission_prompt=len(prompts[0]))

    # the control: closed batches of 8 in arrival order, every request present at the start
    def closed(new, rows):
        padded, lens = serve_batch([prompts[i] for i in rows], device)
        return G.generate_ragged(m, padded, lens, None, max_new_tokens=new, temperature=0.0)
    batches = [range(k, min(k + POOL_ROWS, len(prompts))) for k in range(0, len(prompts), POOL_ROWS)]
    closed(2, batches[0])  # warm-up (and the decode graph's capture)
    first = [wall_ms(lambda: closed(1, rows)) for rows in batches]
    whole = [wall_ms(lambda: closed(max(budgets[i] for i in rows), rows)) for rows in batches]
    ttft = [sum(whole[:k]) + first[k] for k, rows in enumerate(batches) for _ in rows]
    out["closed_batches"] = {"out_tokens_per_s": sum(budgets) / sum(whole) * 1e3,
                             "seconds": sum(whole) / 1e3,
                             "ttft_ms_p50": float(np.percentile(ttft, 50)),
                             "ttft_ms_p90": float(np.percentile(ttft, 90))}
    for name in ("trace_fuse1", f"trace_fuse{POOL_FUSE}", "closed_batches"):
        log(f"[pool] bf16 {name}, {len(prompts)} requests of {min(map(len, prompts))}-"
            f"{max(map(len, prompts))} tokens, {min(budgets)}-{max(budgets)} new: {out[name]}")
    log(f"[pool] bf16 pooled step ({POOL_ROWS} rows): {step}; one-row admission of "
        f"{len(prompts[0])} tokens {admit_ms:.2f} ms")
    del m, pool, traces, graph, st
    torch.cuda.empty_cache()
    out["dense"] = pool_dense(device)
    out["launches"] = dict(launches)
    return out


def pool_dense(device) -> dict:
    """The dense variant (--no_nsa), fp32: requests of a 1,024-token prefix
    and a suffix, through the one-shot pool with the concatenated prompts,
    the chunked pool (chunks of 256) with the same prompts, and both pools
    with the prefix registered and the suffixes as prompts: every run's
    tokens identical to the first's (continuation only), and to each
    concatenated prompt's generate_cached; no csrc kernel launched (dense
    attention is plain)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models import decode_pool as DP
    from forde_tpu_torch.models import generate as G

    cfg = dense_serve_config()
    m = build_lm(cfg, seeded_state(cfg, device, SEED + 112), device, DTypePolicy.fp32())
    rng = np.random.RandomState(SEED + 113)
    prefix = rng.randint(1, cfg.vocab_size, POOL_DENSE_PREFIX).tolist()
    sufs = [rng.randint(1, cfg.vocab_size, n).tolist() for n in POOL_DENSE_SUFFIXES]
    budgets = [POOL_DENSE_NEW] * len(sufs)
    runs, secs = {}, {}
    for label, chunk, with_prefix in (("one_shot", None, False), ("chunked", POOL_DENSE_CHUNK, False),
                                      ("prefix", None, True), ("prefix_chunked", POOL_DENSE_CHUNK, True)):
        pool = DP.DecodePool(m, rows=POOL_ROWS, temperature=0.0, prefill_chunk=chunk)
        t0 = time.perf_counter()
        if with_prefix:
            pid = pool.register_prefix(prefix)
            cache = pool._prefixes[pid][0]["layer_0"]["causal_attention"]
            before = {k: v.clone() for k, v in cache.items()}
            (ids, _, _, _), got = counted(lambda: drive_pool(pool, sufs, budgets, prefix_id=pid))
            if not all(torch.equal(cache[k], v) for k, v in before.items()):
                raise AssertionError(f"pool dense {label}: the prefix cache changed")
        else:
            (ids, _, _, _), got = counted(lambda: drive_pool(pool, [prefix + s for s in sufs],
                                                             budgets))
            ids = [row[len(prefix):] for row in ids]
        secs[label] = time.perf_counter() - t0
        if got:
            raise AssertionError(f"pool dense {label}: the dense path launched {got}")
        runs[label] = ids
        del pool
    for label, ids in runs.items():
        if ids != runs["one_shot"]:
            raise AssertionError(f"pool dense: {label} tokens differ from the one-shot prefill's")
    for s, row in zip(sufs, runs["one_shot"]):
        want = G.generate_cached(m, torch.tensor([prefix + s], device=device), None,
                                 max_new_tokens=POOL_DENSE_NEW, temperature=0.0)[0]
        if row != want[len(prefix):].tolist():
            raise AssertionError("pool dense: tokens differ from generate_cached's")
    log(f"[pool] dense variant fp32, a {POOL_DENSE_PREFIX}-token prefix + suffixes of "
        f"{POOL_DENSE_SUFFIXES[0]}-{POOL_DENSE_SUFFIXES[-1]}, {POOL_DENSE_NEW} new: chunked "
        f"({POOL_DENSE_CHUNK}), registered prefix and both together identical to the one-shot "
        f"prefill and to generate_cached; no csrc kernel launched; seconds {secs}")
    del m
    torch.cuda.empty_cache()
    return {"tokens_identical": True, "seconds": secs}


# Phase 26: serve_http in-process on 127.0.0.1 at the serving width in
# fp32, 16 concurrent clients of 8 new tokens; in continuous mode 4 stream
# over SSE and one of those drops its connection after the first token (it
# asks for the server's maximum, so that it is still decoding then).
HTTP_REQUESTS = 16
HTTP_NEW = 8
HTTP_SERVER_NEW = 48
HTTP_STREAMS = 4


def http_argv(*extra) -> list:
    flags = [f for f in SERVE_FLAGS if f != "--bf16"]
    return [*flags, "--device", "cuda", "--port", "0", "--max_batch", str(POOL_ROWS),
            "--max_new_tokens", str(HTTP_SERVER_NEW), "--temperature", "0",
            "--seed", str(SEED + 120), *extra]


def http_post(url, payload, timeout=300):
    import urllib.request

    req = urllib.request.Request(url + "/generate", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_sse(url, payload, timeout=300) -> dict:
    """The final event of a streamed request, with the streamed tokens."""
    import urllib.request

    req = urllib.request.Request(url + "/generate", json.dumps({**payload, "stream": True})
                                 .encode(), {"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return {**events[-1], "streamed": [e["token"] for e in events[:-1]]}


def http_drop(host, port, payload) -> dict:
    """A streamed request whose client closes the connection after the
    first token event."""
    import socket

    body = json.dumps({**payload, "stream": True})
    with socket.create_connection((host, port), timeout=300) as s:
        s.sendall(f"POST /generate HTTP/1.1\r\nHost: {host}\r\nContent-Type: application/json"
                  f"\r\nContent-Length: {len(body)}\r\n\r\n{body}".encode())
        buf = b""
        while b"data: " not in buf:
            chunk = s.recv(4096)
            if not chunk:
                raise AssertionError(f"http: the stream closed before a token: {buf[-300:]}")
            buf += chunk
    return {"dropped": True}


def phase_http(device) -> dict:
    """serve_http in-process (fp32, seeded weights at the serving width): 16
    concurrent greedy clients of 8 new tokens in batch mode, then with
    --continuous --decode_fuse 4, where 4 of them stream over SSE and one
    of these disconnects after its first token. Every completed output
    equals its prompt's generate_cached continuation on the plain model
    (plain_greedy, the servers' weights), no response carries
    an error, /stats counts the tokens served (the disconnected request
    not among them), its slot is freed, and the continuous server's
    launches are exact. Prints requests/s and output tokens/s."""
    import threading

    import torch

    from forde_tpu_torch import kernels, serve, serve_http
    from forde_tpu_torch.core.config import DTypePolicy

    cfg = serve_config()
    rng = np.random.RandomState(SEED + 121)
    lens = rng.randint(POOL_PROMPT_LENS[0], POOL_PROMPT_LENS[1] + 1, HTTP_REQUESTS)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]
    drop = HTTP_REQUESTS - 1
    out, refs, weights = {}, None, None
    for mode, extra in (("batch", ["--batch_window_ms", "200"]),
                        ("continuous", ["--continuous", "--decode_fuse", str(POOL_FUSE)])):
        args = serve_http.add_server_args(serve.build_parser()).parse_args(http_argv(*extra))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            srv, batcher = serve_http.make_server(args)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        host, port = srv.server_address[:2]
        url = f"http://{host}:{port}"
        streams = range(HTTP_REQUESTS - HTTP_STREAMS, HTTP_REQUESTS) if mode == "continuous" else ()
        results = [None] * HTTP_REQUESTS

        def client(i):
            payload = {"prompt_ids": prompts[i], "max_new_tokens": HTTP_NEW}
            try:
                if i == drop and mode == "continuous":
                    results[i] = http_drop(host, port, {**payload,
                                                        "max_new_tokens": HTTP_SERVER_NEW})
                elif i in streams:
                    results[i] = http_sse(url, payload)
                else:
                    results[i] = http_post(url, payload)
            except Exception as e:  # reported below, with the request's index
                results[i] = {"error": f"{type(e).__name__}: {e}"}

        try:
            threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_REQUESTS)]
            kernels.reset_launches()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            secs = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise AssertionError(f"http {mode}: a client did not finish in 300 s")
            deadline = time.monotonic() + 30
            while mode == "continuous" and batcher._inflight and time.monotonic() < deadline:
                time.sleep(0.05)
            with batcher._lock:
                stats = dict(batcher.stats)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            if mode == "continuous":
                pool = batcher.pool
                freed = not batcher._inflight and pool.active_rows() == 0 and not pool.pending()
                want_launches = pool_launches(cfg, HTTP_REQUESTS, pool._steps)
            else:
                freed = True
                b = stats["batches"]
                want_launches = {"flash_fwd": cfg.num_layers * b, "topk_replay": b,
                                 "small_kv_fwd": 2 * cfg.num_layers * b * HTTP_SERVER_NEW}
        finally:
            srv.shutdown()
            batcher.stop()
            srv.server_close()
        model = batcher.model
        if refs is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
            plain = build_lm(cfg, weights, device, DTypePolicy.fp32(), impl="reference")
            refs = plain_greedy(plain, prompts, [HTTP_NEW] * HTTP_REQUESTS)
            del plain
        elif not all(torch.equal(v, weights[k]) for k, v in model.state_dict().items()):
            raise AssertionError("http: the two servers' seeded weights differ")
        done = [i for i in range(HTTP_REQUESTS) if not (mode == "continuous" and i == drop)]
        errors = {i: r["error"] for i, r in enumerate(results) if "error" in r}
        if errors:
            raise AssertionError(f"http {mode}: responses with an error: {errors}")
        for i in done:
            r = results[i]
            if r["output_ids"] != refs[i] or ("streamed" in r
                                              and r["streamed"] != refs[i][len(prompts[i]):]):
                raise AssertionError(f"http {mode}: request {i} differs from the plain "
                                     f"model's generate_cached")
        served = HTTP_NEW * len(done)
        if stats["tokens_generated"] != served or stats["requests"] != HTTP_REQUESTS:
            raise AssertionError(f"http {mode}: /stats {stats}, expected {served} tokens of "
                                 f"{HTTP_REQUESTS} requests")
        if not freed:
            raise AssertionError("http continuous: the disconnected client's slot was not freed")
        if launches != want_launches:
            raise AssertionError(f"http {mode}: launches {launches}, expected {want_launches}")
        out[mode] = {"requests_per_s": len(done) / secs, "out_tokens_per_s": served / secs,
                     "seconds": secs, "stats": stats, "launches": launches}
        log(f"[http] {mode}: {len(done)} requests of {min(lens)}-{max(lens)} tokens served in "
            f"{secs:.2f} s ({len(done) / secs:.2f} requests/s, {served / secs:.1f} output "
            f"tokens/s), every output = the plain model's generate_cached, no error; /stats "
            f"{stats}"
            + ("; the dropped stream cancelled, its slot freed" if mode == "continuous" else ""))
        del model, batcher, srv
        torch.cuda.empty_cache()
    out["launches"] = dict(Counter(out["batch"]["launches"]) + Counter(out["continuous"]["launches"]))
    return out



# ---- the training extras: phase 27 (the decoder LM) and phase 28 (the dual
# encoder) -----------------------------------------------------------------

EMA_DECAY = 0.999
EXTRAS_ROWS = 2  # rows of the EMA and resume steps (fp32)
ACCUM = (4, 2)  # microbatches x rows, against one step of 8 rows
LORA_RANK = 8
DISTILL_LAYERS, DISTILL_ROWS, DISTILL_STEPS = 2, 4, 4
EVAL_FLAGS = ["--seq_len", "2048", "--batch_size", "8", "--num_batches", "4"]
EVAL_REL_TOL = 1e-4  # eval_lm's fp32 lm_loss against the plain model's
HELDOUT = os.path.join("data_local", "doc_corpus_heldout.txt.gz")
# The preemption subprocess: the reference-default width at 2 layers (the
# depth cut bounds its time), bf16, batch 2, bf16 Adam moments.
PREEMPT_FLAGS = [
    "--d_model", "512", "--num_layers", "2", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "2048", "--bf16", "--batch_size", "2", "--use_markov_data",
    "--slow_loop_interval", "0", "--log_interval", "1", "--moment_dtype", "bfloat16",
]
PREEMPT_TIMEOUT_S = 240


def capture_grads(state) -> list:
    """Wrap the optimizer's step so that it records the gradients it is
    given (one list per step)."""
    seen = []
    step = state.optimizer.step

    def record(grads):
        seen.append([g.detach().clone() for g in grads])
        return step(grads)

    state.optimizer.step = record
    return seen


def flat(tensors):
    import torch

    return torch.cat([t.detach().float().flatten() for t in tensors])


def same_tensors(a: dict, b: dict) -> list:
    """Keys of ``a`` whose tensor is not bit-identical to ``b``'s."""
    import torch

    if sorted(a) != sorted(b):
        raise AssertionError(f"tensor sets differ: {sorted(set(a) ^ set(b))[:8]}")
    return [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def state_tensors(state) -> dict:
    """Every tensor a train state checkpoints, by its checkpoint key."""
    from forde_tpu_torch.train.checkpoint import _state_tensors

    params, extra = _state_tensors(state)
    return {k: t for k, (t, _) in {**params, **extra}.items()}


def add_launches(total: Counter, launches: dict) -> dict:
    total.update(launches)
    return launches


def lm_ema_and_accum(device, cfg, weights, total) -> dict:
    """EMA: one fp32 step with EMA_DECAY leaves ema = decay * ema0 + (1 -
    decay) * params (the formula on copies) bit for bit, over the
    parameters only. Accumulation: fp32, aux 0, ACCUM microbatches against
    one step of their rows: gradients within phase 12's fp32 bar, launches
    ACCUM[0] x one step's, and each run's peak memory."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.ema import ema_update_, init_ema, with_ema
    from forde_tpu_torch.train.step import make_accum_train_step, train_step

    cfg32 = cfg.replace(dtypes=DTypePolicy.fp32())
    per_step = lm_launches_per_step(cfg)
    state = init_ema(lm_train_state(cfg32, weights, device))
    ema0 = [e.clone() for e in state.ema]
    batch = lm_batch(EXTRAS_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 60)
    step = with_ema(lambda s, b: train_step(s, b, aux_loss_weight=0.01), EMA_DECAY)
    (state, m), launches = counted(lambda: step(state, batch))
    add_launches(total, launches)
    params = state.optimizer.params
    with torch.no_grad():
        want = [e0.mul(EMA_DECAY).add_(p.detach(), alpha=1.0 - EMA_DECAY)
                for e0, p in zip(ema0, params)]
    wrong = [i for i, (e, w) in enumerate(zip(state.ema, want)) if not torch.equal(e, w)]
    buffers = {b.data_ptr() for b in state.model.buffers()}
    n_params = sum(p.numel() for p in state.model.parameters())
    covered = (len(state.ema) == len(list(state.model.parameters()))
               and sum(e.numel() for e in state.ema) == n_params
               and not buffers & {e.data_ptr() for e in state.ema})
    if wrong or not covered or launches != per_step or not bool(torch.isfinite(m["loss/total"])):
        raise AssertionError(f"EMA step: {len(wrong)} tensors off the formula, params only "
                             f"{covered}, launches {launches}")
    ema_bytes = 3 * sum(e.numel() * e.element_size() for e in state.ema)
    ema_ms = cuda_ms([lambda: ema_update_(state.ema, params, EMA_DECAY)], reps=10, warmup=2)
    log(f"[lm extras] EMA: one fp32 step ({EXTRAS_ROWS} x {LM_SEQ}) left ema = {EMA_DECAY} ema0 "
        f"+ {1 - EMA_DECAY:.3f} params bit for bit on all {len(state.ema)} parameters "
        f"({n_params / 1e6:.1f}M values, no stat buffer); the update alone {ema_ms:.3f} ms "
        f"({ema_bytes / ema_ms / 1e6:.0f} GB/s over {ema_bytes / 1e9:.2f} GB moved; bound "
        f"{ema_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    del state, ema0, want, params
    torch.cuda.empty_cache()

    mb, rows = ACCUM
    big = lm_batch(mb * rows, LM_SEQ, cfg.vocab_size, device, SEED + 61)
    runs = {}
    for name, make in (("full", lambda: lambda s, b: train_step(s, b, aux_loss_weight=0.0)),
                       ("accum", lambda: make_accum_train_step(mb, aux_loss_weight=0.0))):
        state = lm_train_state(cfg32, weights, device)
        seen = capture_grads(state)
        step = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (state, m), launches = counted(lambda: step(state, big))
        secs = time.perf_counter() - t0
        add_launches(total, launches)
        runs[name] = {"grads": flat(seen[0]), "loss": m["loss/lm"].reshape(1).float(),
                      "launches": launches, "ms": secs * 1e3,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del state, seen, m
        torch.cuda.empty_cache()
    rel = {k: rel_l2(runs["accum"][k], runs["full"][k]) for k in ("grads", "loss")}
    want_launches = {k: mb * v for k, v in per_step.items()}
    log(f"[lm extras] grad accumulation (fp32, aux 0): {mb} x {rows} rows against one step of "
        f"{mb * rows}: gradients relative L2 {rel['grads']:.3e}, lm loss {rel['loss']:.3e}; "
        f"step {runs['accum']['ms']:.1f} ms against {runs['full']['ms']:.1f} ms; peak "
        f"{runs['accum']['peak_gib']:.2f} GiB against {runs['full']['peak_gib']:.2f} GiB; "
        f"launches {runs['accum']['launches']}")
    if (rel["grads"] > LM_PARITY_TOL_FP32["grads"] or rel["loss"] > LM_PARITY_TOL_FP32["loss"]
            or runs["accum"]["launches"] != want_launches or runs["full"]["launches"] != per_step):
        raise AssertionError(f"gradient accumulation: {rel}, launches "
                             f"{runs['accum']['launches']} (expected {want_launches})")
    return {"ema_update_ms": ema_ms, "accum_rel_l2": rel,
            "accum_step_ms": runs["accum"]["ms"], "full_step_ms": runs["full"]["ms"],
            "accum_peak_gib": runs["accum"]["peak_gib"],
            "full_peak_gib": runs["full"]["peak_gib"]}


def lm_resume(device, cfg, weights, workdir, total) -> dict:
    """fp32 compute, bf16 Adam moments, EMA on: the state after 2 steps
    saved, restored into a fresh state of other weights (every tensor bit
    for bit), and the third step of both against each other. Returns the
    checkpoint directory and the saved weights and EMA too (eval_lm reads
    them)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from forde_tpu_torch.train.ema import init_ema, with_ema
    from forde_tpu_torch.train.step import train_step

    cfg32 = cfg.replace(dtypes=DTypePolicy.fp32())
    step = with_ema(lambda s, b: train_step(s, b, aux_loss_weight=0.01), EMA_DECAY)
    batches = [lm_batch(EXTRAS_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 62 + i)
               for i in range(3)]
    a = init_ema(lm_train_state(cfg32, weights, device, moment_dtype="bfloat16"))
    for b in batches[:2]:
        (a, _), launches = counted(lambda: step(a, b))
        add_launches(total, launches)
    ckpt = os.path.join(workdir, "lm_resume_ckpt")
    meta = {"moment_dtype": "bfloat16", "ema_decay": EMA_DECAY}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(ckpt, a, a.step, meta)
    save_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    b = init_ema(lm_train_state(cfg32, seeded_state(cfg, device, SEED + 70), device,
                                moment_dtype="bfloat16"))
    t0 = time.perf_counter()
    restore_train_state(ckpt, b)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    off = same_tensors(state_tensors(a), state_tensors(b))
    if off or b.step != a.step:
        raise AssertionError(f"restored train state: {len(off)} tensors differ ({off[:4]}), "
                             f"step {b.step} vs {a.step}")
    # the saved weights and EMA, which eval_lm's references read from memory
    saved = {k: v.clone() for k, v in a.model.state_dict().items()}
    saved_ema = {n: e.clone() for (n, _), e in zip(a.model.named_parameters(), a.ema)}
    (a, _), la = counted(lambda: step(a, batches[2]))
    (b, _), lb = counted(lambda: step(b, batches[2]))
    add_launches(total, la)
    add_launches(total, lb)
    ta, tb = state_tensors(a), state_tensors(b)
    off = same_tensors(ta, tb)
    worst = {k: rel_l2(tb[k], ta[k]) for k in off}
    bars = {k: LM_PARITY_TOL_FP32["grads" if k.startswith(("mu/", "nu/")) else "params"]
            for k in off}
    log(f"[lm extras] resume: 2 steps (fp32, bf16 moments, EMA), saved in {save_s:.2f} s "
        f"({disk / 1e9:.2f} GB on disk), restored in {load_s:.2f} s, every tensor and the step "
        f"bit-identical; the third step "
        + ("bit-identical to the uninterrupted state's" if not off else
           f"differs in {len(off)} tensors, worst relative L2 {max(worst.values()):.3e}"))
    if any(worst[k] > bars[k] for k in off):
        raise AssertionError(f"resumed step against the uninterrupted one: {worst}")
    del a, b, ta, tb
    torch.cuda.empty_cache()
    return {"ckpt": ckpt, "weights": saved, "ema": saved_ema,
            "save_s": save_s, "load_s": load_s, "bytes_on_disk": disk,
            "third_step_bit_identical": not off, "third_step_rel_l2": worst}


def run_preemption(workdir) -> dict:
    """``python -m forde_tpu_torch.train.loop`` (PREEMPT_FLAGS) in a
    subprocess: SIGTERM after its first logged step gives exit 0 and a
    checkpoint; ``--resume`` (in this process) goes on from its step."""
    import queue
    import signal
    import threading

    from forde_tpu_torch.train import checkpoint, loop

    ckpt = os.path.join(workdir, "lm_preempt_ckpt")
    argv = PREEMPT_FLAGS + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "forde_tpu_torch.train.loop", *argv, "--steps_per_epoch",
         "100000"], cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()

    def reader():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    out = []
    deadline = time.monotonic() + PREEMPT_TIMEOUT_S
    try:
        while True:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            if line is None:
                raise AssertionError("the training process ended before a logged step:\n"
                                     + "".join(out[-20:]))
            out.append(line)
            if " step " in line and "loss" in line:
                break
        first_step_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    while (line := lines.get(timeout=30)) is not None:
        out.append(line)
    text = "".join(out)
    if rc != 0 or "saving checkpoint" not in text or not checkpoint.has_train_state(ckpt):
        raise AssertionError(f"preempted training: exit {rc}\n{text[-3000:]}")
    saved = int(checkpoint.load_meta(ckpt)[1]["step"])
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(printed):
            res = loop.main(argv + ["--steps_per_epoch", str(saved + 1), "--resume"])
    finally:
        os.chdir(cwd)
    if f"resumed from step {saved}" not in printed.getvalue() or res["step"] != saved + 1:
        raise AssertionError(f"--resume after preemption: step {res['step']}, saved {saved}")
    layers = PREEMPT_FLAGS[PREEMPT_FLAGS.index("--num_layers") + 1]
    log(f"[lm extras] preemption ({layers} layers at full width): SIGTERM after the "
        f"first logged step ({first_step_s:.1f} s after the start) -> exit 0 with a checkpoint "
        f"of step {saved}; --resume went on to step {res['step']}")
    return {"saved_step": saved, "first_step_s": first_step_s,
            "seconds": time.perf_counter() - t0}


def lm_lora(device, cfg, weights, workdir, total) -> dict:
    """The seeded base written with save_params; at init the merged model's
    fp32 logits equal the base's exactly; the LM loop with --init_from
    --lora_rank LORA_RANK (default targets) takes 2 steps: the base
    bit-identical, the adapters moved, launches = 2 full steps'; its
    checkpoint through serve's loader gives the in-memory merged model's
    logits (1e-5); the LoRA step's time beside the full step's."""
    import torch

    from forde_tpu_torch import interop, serve
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train import lora as lora_lib
    from forde_tpu_torch.train.checkpoint import save_params
    from forde_tpu_torch.train.step import train_step

    base_dir = os.path.join(workdir, "lm_base_ckpt")
    save_params(base_dir, cfg, interop.flatten(interop.state_dict_to_flax(weights)))
    ids = lm_batch(1, LM_SEQ, cfg.vocab_size, device, SEED + 64)["input_ids"]
    m32 = FORDEDecoderLM(cfg.replace(dtypes=DTypePolicy.fp32()), device=device)
    m32.load_state_dict(weights)
    adapters = lora_lib.init_lora(m32, LORA_RANK, torch.Generator(device=device).manual_seed(1))
    scale = lora_lib.lora_scale(LORA_RANK, 16.0)
    with torch.no_grad():
        ref, _ = m32(ids)
        got, _ = torch.func.functional_call(m32, lora_lib.merge_lora(m32, adapters, scale),
                                            (ids,), strict=False)
    if not torch.equal(got, ref):
        raise AssertionError(f"LoRA at init: merged logits off the base's by "
                             f"{float((got - ref).abs().max()):.3e}")
    del m32, ref, got
    torch.cuda.empty_cache()

    lora_dir = os.path.join(workdir, "lm_lora_ckpt")
    argv = SERVE_FLAGS + ["--batch_size", "2", "--use_markov_data", "--steps_per_epoch", "2",
                          "--slow_loop_interval", "0", "--log_interval", "1", "--init_from",
                          base_dir, "--lora_rank", str(LORA_RANK), "--checkpoint_dir", lora_dir,
                          "--seed", str(SEED)]
    out, launches, secs, peak = run_train_loop(argv, workdir)
    add_launches(total, launches)
    state = out["state"]
    names = dict(state.model.named_parameters())
    moved_base = [k for k, p in names.items() if not torch.equal(p, weights[k])]
    still = [k for k, t in state.lora.tensors.items()
             if k.endswith("lora_b") and not bool(t.detach().abs().max() > 0)]
    want = {k: 2 * v for k, v in lm_launches_per_step(cfg).items()}
    loss = out["final_metrics"]["loss/total"]
    if moved_base or still or launches != want or not np.isfinite(loss):
        raise AssertionError(f"LoRA run: base tensors moved {moved_base[:4]}, adapters not "
                             f"moved {still[:4]}, launches {launches} (expected {want}), "
                             f"loss {loss}")
    n_adapt = lora_lib.adapter_param_count(state.lora)
    args = serve.build_parser().parse_args(["--checkpoint_dir", lora_dir])
    with contextlib.redirect_stdout(io.StringIO()):
        _, served = serve.load_serving_model(args, device)
    batch = lm_batch(1, LM_SEQ, cfg.vocab_size, device, SEED + 65)["input_ids"]
    with torch.no_grad():
        mem, _ = torch.func.functional_call(
            state.model, lora_lib.merge_lora(state.model, state.lora, scale), (batch,),
            strict=False)
        srv, _ = served(batch)
    serve_err = float((srv - mem).abs().max() / mem.abs().max())
    if not serve_err <= 1e-5:
        raise AssertionError(f"LoRA checkpoint served: logits {serve_err:.3e} off the merged "
                             "model's")
    del served, mem, srv
    # the LoRA step's time beside a full step's, bf16, 2 rows
    timing_batch = lm_batch(2, LM_SEQ, cfg.vocab_size, device, SEED + 66)
    lora_step = lora_lib.make_lora_train_step(scale, aux_loss_weight=0.01)
    lora_ms = float(np.median([wall_ms(lambda: lora_step(state, timing_batch))
                               for _ in range(4)][1:]))
    del state, out
    torch.cuda.empty_cache()
    full = lm_train_state(cfg, weights, device)
    full_ms = float(np.median([wall_ms(lambda: train_step(full, timing_batch, 0.01))
                               for _ in range(4)][1:]))
    adam_bytes = sum(2 * m.numel() * m.element_size() for m in full.optimizer.mu)
    del full
    torch.cuda.empty_cache()
    log(f"[lm extras] LoRA rank {LORA_RANK} (default targets): merged = base at init (fp32 "
        f"logits identical); --init_from --lora_rank: 2 steps in {secs:.2f} s, loss {loss:.4f}, "
        f"base bit-identical, every lora_b moved, {n_adapt:,} adapter values; launches "
        f"{launches}; served merge {serve_err:.2e} off the in-memory merge; step (bf16, 2 x "
        f"{LM_SEQ}) LoRA {lora_ms:.1f} ms, full {full_ms:.1f} ms; peak {peak:.2f} GiB")
    return {"adapter_values": n_adapt, "serve_rel_err": serve_err,
            "lora_step_ms": lora_ms, "full_step_ms": full_ms, "full_adam_bytes": adam_bytes,
            "peak_gib": peak, "loss": loss}


def lm_distill(device, cfg, weights, total) -> dict:
    """The full-depth model (``weights``) teaches a student of the same
    width and DISTILL_LAYERS layers, DISTILL_ROWS rows, DISTILL_STEPS steps
    on one batch: KL and loss finite, the loss falls, launches = the
    teacher's forward + the student's forward and backward per step."""
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.distill import make_distill_step
    from forde_tpu_torch.train.state import create_train_state

    teacher = build_lm(cfg, weights, device).requires_grad_(False)
    s_cfg = cfg.replace(num_layers=DISTILL_LAYERS)
    student = FORDEDecoderLM(s_cfg, device=device,
                             generator=torch.Generator(device=device).manual_seed(SEED + 71))
    state = create_train_state(s_cfg, None, 3e-4, 0.01, model=student)
    step = make_distill_step(teacher, aux_loss_weight=0.01, alpha=0.5, temperature=2.0)
    batch = lm_batch(DISTILL_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 72)
    t_fwd = {"flash_fwd": cfg.num_layers, "small_kv_fwd": 2 * cfg.num_layers}
    want = Counter(t_fwd)
    want.update(lm_launches_per_step(s_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, kls, times = [], [], []
    for _ in range(DISTILL_STEPS):
        t0 = time.perf_counter()
        (state, m), launches = counted(lambda: step(state, batch))
        times.append((time.perf_counter() - t0) * 1e3)
        add_launches(total, launches)
        if launches != dict(want):
            raise AssertionError(f"distill step launches {launches}, expected {dict(want)}")
        losses.append(float(m["loss/total"]))
        kls.append(float(m["loss/kl"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[lm extras] distillation ({cfg.num_layers}-layer teacher, {DISTILL_LAYERS}-layer "
        f"student, {DISTILL_ROWS} x {LM_SEQ}, bf16): loss {' -> '.join(f'{x:.4f}' for x in losses)}"
        f", KL {' -> '.join(f'{x:.4f}' for x in kls)}; step {float(np.median(times[1:])):.1f} ms; "
        f"peak {peak:.2f} GiB; launches per step {dict(want)}")
    if not (np.isfinite(losses).all() and np.isfinite(kls).all() and losses[-1] < losses[0]):
        raise AssertionError(f"distillation: losses {losses}, KL {kls}")
    del teacher, state, student
    torch.cuda.empty_cache()
    return {"losses": losses, "kl": kls, "step_ms": float(np.median(times[1:])),
            "peak_gib": peak}


def lm_eval(device, cfg, resume, workdir, total) -> dict:
    """eval_lm on the held-out corpus (decompressed into ``workdir``) from
    the resume checkpoint (fp32; EMA kept) and from the same weights under
    a bf16 config: the fp32 lm_loss against the plain model's
    (attention_impl="reference", no launch) within EVAL_REL_TOL relative,
    --use_ema against the EMA weights' loss (both references built from the
    weights the resume phase saved, held in memory), and evaluated
    tokens/s."""
    import gzip
    import shutil

    import torch

    from forde_tpu_torch import eval_lm
    from forde_tpu_torch.core.config import DTypePolicy, config_to_dict
    from forde_tpu_torch.data.lm import create_text_file_dataset
    from forde_tpu_torch.train.checkpoint import MODEL_CONFIG_FILENAME, PARAMS_FILENAME, load_meta
    from forde_tpu_torch.train.state import TrainState
    from forde_tpu_torch.train.step import eval_step

    corpus = os.path.join(workdir, "heldout.txt")
    with gzip.open(os.path.join(REPO, HELDOUT), "rb") as src, open(corpus, "wb") as dst:
        shutil.copyfileobj(src, dst)
    resume_ckpt = resume["ckpt"]
    ck16 = os.path.join(workdir, "lm_resume_bf16")
    os.makedirs(ck16, exist_ok=True)
    cfg32, meta = load_meta(resume_ckpt)
    with open(os.path.join(ck16, MODEL_CONFIG_FILENAME), "w") as f:
        json.dump({"model": config_to_dict(cfg32.replace(dtypes=DTypePolicy.bf16())),
                   "train": meta}, f)
    os.symlink(os.path.join(resume_ckpt, PARAMS_FILENAME), os.path.join(ck16, PARAMS_FILENAME))
    flags = ["--data_file", corpus, "--device", "cuda"] + EVAL_FLAGS
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        out32, l32 = counted(lambda: eval_lm.main(["--checkpoint_dir", resume_ckpt] + flags))
        out16, l16 = counted(lambda: eval_lm.main(["--checkpoint_dir", ck16] + flags))
        ema32, le = counted(lambda: eval_lm.main(["--checkpoint_dir", resume_ckpt, "--use_ema"]
                                                 + flags))
    for launches in (l32, l16, le):
        add_launches(total, launches)
    n = int(EVAL_FLAGS[EVAL_FLAGS.index("--num_batches") + 1])
    rows = int(EVAL_FLAGS[EVAL_FLAGS.index("--batch_size") + 1])
    seq = int(EVAL_FLAGS[EVAL_FLAGS.index("--seq_len") + 1])
    want = {"flash_fwd": n * cfg.num_layers, "small_kv_fwd": 2 * n * cfg.num_layers}
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in create_text_file_dataset(corpus, rows, seq, num_batches=n, seed=42)]

    def mean_loss(model):
        state = TrainState(model=model, optimizer=None)
        return float(np.mean([float(eval_step(state, b)["loss/lm"]) for b in batches]))

    weights = resume["weights"]
    plain = build_lm(cfg32, weights, device, impl="reference")
    plain_loss, lp = counted(lambda: mean_loss(plain))
    del plain
    ema_model = build_lm(cfg32, {**weights, **resume["ema"]}, device)
    ema_loss, lk = counted(lambda: mean_loss(ema_model))
    add_launches(total, lk)
    del ema_model
    m16 = build_lm(cfg32, weights, device, dtypes=DTypePolicy.bf16())
    mean_loss(m16)  # warm-up
    t0 = time.perf_counter()
    mean_loss(m16)
    torch.cuda.synchronize()
    tokens_per_s = n * rows * (seq - 1) / (time.perf_counter() - t0)
    del m16
    torch.cuda.empty_cache()
    rel = abs(out32["lm_loss"] - plain_loss) / plain_loss
    rel_ema = abs(ema32["lm_loss"] - ema_loss) / ema_loss
    log(f"[lm extras] eval_lm ({' '.join(EVAL_FLAGS)}, the held-out corpus): fp32 lm_loss "
        f"{out32['lm_loss']} (plain model {plain_loss:.6f}, relative {rel:.2e}), bf16 "
        f"{out16['lm_loss']}, --use_ema {ema32['lm_loss']} (the EMA weights' {ema_loss:.6f}); "
        f"{out32['tokens']} tokens, {tokens_per_s:,.0f} tokens/s evaluated (bf16); launches "
        f"{l32}")
    if (rel > EVAL_REL_TOL or rel_ema > 1e-5 or lp or l32 != want or l16 != want or le != want
            or not np.isfinite(out16["lm_loss"])):
        raise AssertionError(f"eval_lm: fp32 {out32} vs plain {plain_loss} ({rel:.2e}), EMA "
                             f"{ema32} vs {ema_loss}, launches {l32} {l16} {le} plain {lp}")
    return {"lm_loss_fp32": out32["lm_loss"], "lm_loss_bf16": out16["lm_loss"],
            "plain_lm_loss": plain_loss, "rel_err": rel, "ema_lm_loss": ema32["lm_loss"],
            "tokens": out32["tokens"], "tokens_per_s_bf16": tokens_per_s}


def phase_lm_extras(device, workdir) -> dict:
    """The decoder LM's training extras at the reference-default width and
    depth (phase 27): EMA, gradient accumulation, resume, preemption, LoRA,
    distillation and eval_lm, each held to its gate; the seconds of each."""
    import torch

    cfg = serve_config()
    weights = lm_weights(cfg, device)
    total: Counter = Counter()
    out, secs = {}, {}
    part = parts_timer(secs)
    out.update(part("ema_accum", lm_ema_and_accum, device, cfg, weights, total))
    resume = part("resume", lm_resume, device, cfg, weights, workdir, total)
    out["resume"] = {k: v for k, v in resume.items() if k not in ("ckpt", "weights", "ema")}
    out["preemption"] = part("preemption", run_preemption, workdir)
    out["lora"] = part("lora", lm_lora, device, cfg, weights, workdir, total)
    out["distill"] = part("distill", lm_distill, device, cfg, weights, total)
    out["eval_lm"] = part("eval_lm", lm_eval, device, cfg, resume, workdir, total)
    del weights, resume
    torch.cuda.empty_cache()
    log("[lm extras] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    out["seconds"] = secs
    out["launches"] = dict(total)
    return out


CLIP_EXTRAS_ARGV = [
    "--preset", "vit_b16", "--bf16", "--use_aligned_data", "--aligned_classes", "4096",
    "--batch_size", "128", "--num_steps", "8", "--eval_interval", "4", "--eval_batches", "2",
    "--ema_decay", str(EMA_DECAY), "--fuse_steps", "2",
]
CLIP_FUSE_K = 2
RANK_TIE_BAND = 1e-5  # fp32 rounding of a 512-wide cosine, with room


def clip_extras_config():
    """vit_b16 (the clip loop's preset), bf16, sensing on."""
    from forde_tpu_torch.core.config import DTypePolicy, vit_b16_config

    return vit_b16_config().replace(dtypes=DTypePolicy.bf16(), sense=True)
RENDER_BATCHES = 8


def clip_fused_ema(device, cfg, total) -> dict:
    """make_fused_step over with_ema steps (k = CLIP_FUSE_K, every step
    sensed): a replayed call against the same steps run eagerly with EMA
    from the same state, bit for bit (or within phase 6's bars, as phase
    16 holds fused steps); the EMA tensors keep their storage; launches."""
    import torch

    from forde_tpu_torch.train.clip_step import clip_train_step, make_fused_step, stack_batches
    from forde_tpu_torch.train.ema import init_ema, with_ema

    weights = build_model(cfg, device).state_dict()
    batches = []
    for i in range(CLIP_FUSE_K):
        b = training_batch(cfg, FUSE_BATCH, device, SEED + 80 + i)
        b["image"] = b["image"].to(cfg.dtypes.compute)
        batches.append(b)
    rolled = batches[1:] + batches[:1]
    sensed = with_ema(clip_train_step, EMA_DECAY)
    fused = make_fused_step(cfg, CLIP_FUSE_K, 1, sensed_step=sensed)
    first = fused.prepare(next(stack_batches(iter(batches), CLIP_FUSE_K)))
    second = fused.prepare(next(stack_batches(iter(rolled), CLIP_FUSE_K)))
    fus = init_ema(train_state(cfg, weights, device))
    eager = init_ema(train_state(cfg, weights, device))
    ptrs = [e.data_ptr() for e in fus.ema]
    fused(fus, first)
    copy_train_state_(eager, fus)
    with torch.no_grad():
        torch._foreach_copy_(eager.ema, fus.ema)
    (fus, fm), lf = counted(lambda: fused(fus, second))
    add_launches(total, lf)

    def eager_steps():
        m = None
        for b in rolled:
            _, m = sensed(eager, b)
        return m

    em, le = counted(eager_steps)
    add_launches(total, le)
    want = {k: CLIP_FUSE_K * v for k, v in launches_per_step(cfg, True).items()}
    if lf != want or le != want or [e.data_ptr() for e in fus.ema] != ptrs:
        raise AssertionError(f"fused steps with EMA: launches {lf} / {le} (expected {want}), "
                             "EMA storage kept " + str([e.data_ptr() for e in fus.ema] == ptrs))
    got = {"ema": flat(fus.ema), "params": flat(fus.optimizer.params),
           "grads": flat(fus.optimizer.mu), "loss": fm["loss/contrastive"].reshape(1)}
    ref = {"ema": flat(eager.ema), "params": flat(eager.optimizer.params),
           "grads": flat(eager.optimizer.mu), "loss": em["loss/contrastive"].reshape(1)}
    readings = {}
    for k in ref:
        identical = bool(torch.equal(got[k], ref[k]))
        rel = rel_l2(got[k], ref[k])
        readings[k] = {"bit_identical": identical, "rel_l2": rel}
        tol = PARITY_TOL["bf16"].get("params" if k == "ema" else k, 0.0)
        if not identical and not rel <= tol:
            raise AssertionError(f"fused + EMA vs eager + EMA {k}: relative L2 {rel:.3e} > {tol:g}")
    log(f"[clip extras] fused {CLIP_FUSE_K} steps with EMA (vit_b16, bf16, batch {FUSE_BATCH}): a "
        f"replayed call against the same steps run eagerly with EMA: " + ", ".join(
            f"{k} " + ("identical" if r["bit_identical"] else f"{r['rel_l2']:.3e}")
            for k, r in readings.items())
        + f"; the EMA's {len(ptrs)} tensors kept their storage; launches per call {want}")
    del fus, eager, fused, first, second, batches, rolled
    torch.cuda.empty_cache()
    return readings


def clip_renderer(device, cfg) -> dict:
    """AlignedDeviceRenderer with noise 0 against AlignedSyntheticVLDataset
    at batch 128, 224 px: ids and masks exactly, images within 1e-6; then
    renders per second with noise."""
    import torch

    from forde_tpu_torch.data.vl import AlignedDeviceRenderer, AlignedSyntheticVLDataset

    kw = dict(image_size=cfg.image_size, text_len=cfg.max_text_len, vocab_size=cfg.vocab_size,
              num_classes=4096, seed=SEED)
    clean = AlignedSyntheticVLDataset(FUSE_BATCH, 1, noise=0.0, **kw)
    host = next(iter(clean))
    dev = next(AlignedDeviceRenderer(clean, device).batches())
    img_err = float((dev["image"].cpu() - torch.from_numpy(host["image"])).abs().max())
    exact = all(np.array_equal(dev[k].cpu().numpy(), host[k])
                for k in ("input_ids", "attention_mask"))
    if not exact or not img_err <= 1e-6:
        raise AssertionError(f"renderer vs dataset: ids/masks exact {exact}, image {img_err:.3e}")
    noisy = AlignedDeviceRenderer(AlignedSyntheticVLDataset(FUSE_BATCH, RENDER_BATCHES, **kw),
                                  device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in noisy.batches():
        pass
    torch.cuda.synchronize()
    per_s = RENDER_BATCHES / (time.perf_counter() - t0)
    log(f"[clip extras] aligned data on the card: noise 0 against the numpy dataset, ids and "
        f"masks exact, images within {img_err:.2e}; {per_s:.1f} batches/s rendered "
        f"({per_s * FUSE_BATCH:,.0f} images/s, batch {FUSE_BATCH}, {cfg.image_size} px, noise)")
    return {"image_max_abs_err": img_err, "batches_per_s": per_s}


def clip_loop_extras(device, workdir, total) -> dict:
    """clip_loop.main at CLIP_EXTRAS_ARGV with a checkpoint: the seen_,
    unseen_, ema_seen_ and ema_unseen_ metrics at both evals, in [0, 1];
    exact launches (8 sensed steps, 2 evals of 4 sets x 2 batches); the
    card's retrieval ranks equal the CPU's on the same embeddings; the
    checkpoint restores the step, the EMA and Adam bit for bit."""
    import torch

    from forde_tpu_torch.models.dual_encoder import l2_normalize
    from forde_tpu_torch.obs.retrieval import _retrieval_ranks
    from forde_tpu_torch.train import clip_loop
    from forde_tpu_torch.train.checkpoint import restore_train_state
    from forde_tpu_torch.train.clip_step import clip_eval_embeddings, create_clip_train_state
    from forde_tpu_torch.train.ema import init_ema

    ckpt = os.path.join(workdir, "clip_extras_ckpt")
    argv = CLIP_EXTRAS_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    args = clip_loop.build_parser().parse_args(argv)
    cfg = clip_loop.config_from_args(args)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            t0 = time.perf_counter()
            out, launches = counted(lambda: clip_loop.main(argv))
            secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    add_launches(total, launches)
    layers = cfg.vision.num_layers + cfg.text.num_layers
    prefixes = ("seen_", "unseen_", "ema_seen_", "ema_unseen_")
    evals = out["retrieval"]
    n_enc = len(evals) * len(prefixes) * args.eval_batches
    per = launches_per_step(cfg, True)
    want = {"flash_mha_fwd": args.num_steps * per["flash_mha_fwd"] + n_enc * layers,
            "flash_mha_bwd": args.num_steps * per["flash_mha_bwd"],
            "moment_sums": args.num_steps * per["moment_sums"]}
    bad = [(r["step"], k) for r in evals for p in prefixes for k in
           (f"retrieval/{p}{d}_recall@{n}" for d in ("i2t", "t2i") for n in (1, 5, 10))
           if not 0.0 <= r["metrics"].get(k, -1.0) <= 1.0]
    loss = out["final_metrics"]["loss/contrastive"]
    if ([r["step"] for r in evals] != [4, 8] or bad or launches != want
            or not np.isfinite(loss) or out["step"] != args.num_steps):
        raise AssertionError(f"clip loop extras: evals at {[r['step'] for r in evals]}, metrics "
                             f"missing or out of [0, 1] {bad[:4]}, launches {launches} "
                             f"(expected {want}), loss {loss}")
    state = out["state"]
    held = clip_loop._eval_sets(args, cfg, device)["seen_"]
    with torch.no_grad():
        embs = [clip_eval_embeddings(state, b) for b in held]
    img = torch.cat([e[0] for e in embs])
    txt = torch.cat([e[1] for e in embs])
    card = [r.cpu() for r in _retrieval_ranks(img, txt)]
    host = _retrieval_ranks(img.cpu(), txt.cpu())
    # A rank may move only by candidates whose score lies within fp32
    # rounding (RANK_TIE_BAND, in float64 on the CPU) of the match's.
    sims = (l2_normalize(img.cpu().double()) @ l2_normalize(txt.cpu().double()).T)
    diag = torch.diagonal(sims)
    bands = ((sims - diag[:, None]).abs() <= RANK_TIE_BAND).sum(1) - 1, \
        ((sims - diag[None, :]).abs() <= RANK_TIE_BAND).sum(0) - 1
    moved = [int((a != b).sum()) for a, b in zip(card, host)]
    ranks_equal = all(bool(((a - b).abs() <= band).all())
                      for a, b, band in zip(card, host, bands))
    fresh = init_ema(create_clip_train_state(cfg, None, args.learning_rate, args.weight_decay,
                                             device=device))
    restore_train_state(ckpt, fresh)
    restored = state_tensors(fresh)
    off = same_tensors(restored, state_tensors(state))
    if not ranks_equal or off or fresh.step != state.step:
        raise AssertionError(f"retrieval ranks card = CPU {ranks_equal}; restored state: "
                             f"{len(off)} tensors differ ({off[:4]}), step {fresh.step}")
    eval_s = sum(r["seconds"] for r in evals)
    pairs = args.num_steps * args.batch_size
    log(f"[clip extras] clip_loop.main ({' '.join(CLIP_EXTRAS_ARGV)}) took {secs:.2f} s, final "
        f"loss {loss:.4f}; evals at {[r['step'] for r in evals]}: " + "; ".join(
            f"{p} i2t R@1 {evals[-1]['metrics'][f'retrieval/{p}i2t_recall@1']:.4f}"
            for p in prefixes)
        + f"; launches {launches}; ranks on the card = the CPU's ({img.shape[0]} pairs, "
        f"{sum(moved)} of {2 * img.shape[0]} moved within a tie band of {RANK_TIE_BAND:g}); the "
        f"checkpoint restored the step ({fresh.step}), the EMA and Adam bit for bit; "
        f"{pairs / secs:.1f} pairs/s with the eval, {pairs / (secs - eval_s):.1f} without "
        f"(the run's wall time, set-up and captures included); retrieval eval "
        f"{eval_s / n_enc * 1e3:.1f} ms per batch of {args.batch_size}")
    del state, fresh, out
    torch.cuda.empty_cache()
    return {"seconds": secs, "eval_seconds": eval_s, "final_loss": loss, "ranks_moved": moved,
            "pairs_per_s_with_eval": pairs / secs,
            "pairs_per_s_without_eval": pairs / (secs - eval_s),
            "eval_ms_per_batch": eval_s / n_enc * 1e3,
            "last_eval": evals[-1]["metrics"]}


def phase_clip_extras(device, workdir) -> dict:
    """The dual encoder's training extras at vit_b16, bf16, batch 128
    (phase 28): fused steps with EMA, the aligned data on the card, and
    the clip loop with the retrieval eval, EMA and a checkpoint."""
    cfg = clip_extras_config()
    total: Counter = Counter()
    out = {"fused_ema": clip_fused_ema(device, cfg, total),
           "renderer": clip_renderer(device, cfg),
           "clip_loop": clip_loop_extras(device, workdir, total)}
    out["launches"] = dict(total)
    return out


# ---- the training extras' second part: rematerialisation, the scanned
# layout, profiling, the NSA branch modules and the plots ---------------
# Phase 29's long-context run: benchmarks/decoder.py:46-52's configuration
# (--seq_len 8192 with --remat --scan_layers) at the reference-default
# width and depth, its batch cut to 4 (the one cut), 2 steps.
REMAT_LM_ROWS = 2  # the fp32 parity step's rows (phase 12's)
REMAT_TIMING_ROWS = 8  # the bf16 readings' rows (phase 13's)
LONG_REMAT_ARGV = SERVE_FLAGS[:-3] + [
    "--seq_len", "8192", "--bf16", "--remat", "--scan_layers", "--batch_size", "4",
    "--use_markov_data", "--steps_per_epoch", "2", "--slow_loop_interval", "0",
    "--log_interval", "1",
]
CLIP_REMAT_POLICIES = ("none", "block", "mlp")


def lm_stat_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("expert_usage", "step_count"))}


def remat_lm_parity(device, cfg, weights, total) -> dict:
    """One fp32 step (REMAT_LM_ROWS x LM_SEQ, aux 0.01) with remat against
    one without from the same weights: loss, gradients and stat buffers
    bit for bit (else phase 12's fp32 bars), exact launches."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.step import train_step

    batch = lm_batch(REMAT_LM_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 90)
    runs = {}
    for remat in (False, True):
        c = cfg.replace(dtypes=DTypePolicy.fp32(), remat=remat)
        state = lm_train_state(c, weights, device)
        seen = capture_grads(state)
        (state, m), launches = counted(lambda: train_step(state, batch, aux_loss_weight=0.01))
        add_launches(total, launches)
        runs[remat] = {"loss": m["loss/total"].reshape(1), "grads": flat(seen[0]),
                       "stats": lm_stat_buffers(state.model), "launches": launches}
        if launches != lm_launches_per_step(c):
            raise AssertionError(f"LM step (remat={remat}) launches {launches}, expected "
                                 f"{lm_launches_per_step(c)}")
        del state, seen
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    stats_off = same_tensors(a["stats"], b["stats"])
    same = {"loss": bool(torch.equal(a["loss"], b["loss"])),
            "grads": bool(torch.equal(a["grads"], b["grads"])), "stats": not stats_off}
    rel = {k: rel_l2(b[k], a[k]) for k in ("loss", "grads")}
    log(f"[remat] LM step (fp32, {REMAT_LM_ROWS} x {LM_SEQ}, {cfg.num_layers} layers): remat "
        f"against none: " + ", ".join(f"{k} " + ("identical" if v else f"{rel.get(k, 0):.3e}")
                                       for k, v in same.items())
        + f"; launches {b['launches']} (none: {a['launches']})")
    if stats_off or any(not same[k] and rel[k] > LM_PARITY_TOL_FP32[k] for k in rel):
        raise AssertionError(f"remat LM step against the plain step: {same}, {rel}, stat "
                             f"buffers off {stats_off[:4]}")
    return {"bit_identical": same, "rel_l2": rel, "launches": b["launches"]}


def remat_lm_lora(device, cfg, weights, total) -> dict:
    """2 fp32 LoRA steps (REMAT_LM_ROWS x LM_SEQ, rank LORA_RANK, aux 0.01)
    with remat against 2 without, from the same base and adapters: the
    losses and the adapters after them bit for bit (else phase 12's fp32
    bars), exact launches. After the first step lora_b is not zero, so the
    second step's recomputation must read the merged weights, not the
    base's."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train import lora as lora_lib

    step = lora_lib.make_lora_train_step(lora_lib.lora_scale(LORA_RANK, 16.0),
                                         aux_loss_weight=0.01)
    batches = [lm_batch(REMAT_LM_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 92 + i)
               for i in range(2)]
    runs = {}
    for remat in (False, True):
        c = cfg.replace(dtypes=DTypePolicy.fp32(), remat=remat)
        state = lora_lib.create_lora_train_state(
            lm_train_state(c, weights, device), LORA_RANK,
            torch.Generator(device=device).manual_seed(SEED + 94))
        launches, losses = Counter(), []
        for b in batches:
            (state, m), n = counted(lambda: step(state, b))
            launches.update(add_launches(total, n))
            losses.append(m["loss/total"].reshape(1))
        want = {k: 2 * v for k, v in lm_launches_per_step(c).items()}
        if dict(launches) != want:
            raise AssertionError(f"2 LoRA steps (remat={remat}) launches {dict(launches)}, "
                                 f"expected {want}")
        runs[remat] = {"loss": torch.cat(losses),
                       "adapters": flat(list(state.lora.tensors.values()))}
        del state
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    same = {k: bool(torch.equal(a[k], b[k])) for k in a}
    rel = {k: rel_l2(b[k], a[k]) for k in a}
    bars = {"loss": LM_PARITY_TOL_FP32["loss"], "adapters": LM_PARITY_TOL_FP32["params"]}
    log(f"[remat] LoRA rank {LORA_RANK} (fp32, 2 steps of {REMAT_LM_ROWS} x {LM_SEQ}): remat "
        f"against none: " + ", ".join(f"{k} " + ("identical" if v else f"{rel[k]:.3e}")
                                       for k, v in same.items()))
    if any(not same[k] and rel[k] > bars[k] for k in rel):
        raise AssertionError(f"LoRA steps with remat against without: {same}, {rel}")
    return {"bit_identical": same, "rel_l2": rel}


def remat_lm_readings(device, cfg, weights) -> dict:
    """bf16 steps at REMAT_TIMING_ROWS x LM_SEQ with and without remat:
    step ms (median of 3 after a warm-up, host clock between two
    synchronizes) and the peak memory of the steps."""
    import torch

    from forde_tpu_torch.train.step import train_step

    batch = lm_batch(REMAT_TIMING_ROWS, LM_SEQ, cfg.vocab_size, device, SEED + 91)
    out = {}
    for remat in (False, True):
        state = lm_train_state(cfg.replace(remat=remat), weights, device)
        train_step(state, batch, aux_loss_weight=0.01)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = [wall_ms(lambda: train_step(state, batch, aux_loss_weight=0.01))
                 for _ in range(3)]
        out["remat" if remat else "none"] = {
            "step_ms": float(np.median(times)), "step_ms_all": times,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_above_state_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
        del state
        torch.cuda.empty_cache()
    log(f"[remat] LM step (bf16, {REMAT_TIMING_ROWS} x {LM_SEQ}): " + "; ".join(
        f"{k} {v['step_ms']:.1f} ms ({' / '.join(f'{t:.1f}' for t in v['step_ms_all'])}), peak "
        f"{v['peak_gib']:.2f} GiB ({v['peak_above_state_gib']:.2f} above the state and what "
        f"else was allocated)" for k, v in out.items()))
    return out


def remat_long_lm(device, workdir, total) -> dict:
    """train.loop.main at LONG_REMAT_ARGV with a checkpoint: finite loss,
    exact launches (the streaming 4-D kernels, K = 960 pools, forward
    twice), a scanned checkpoint (layers/block/..., leading axis 12) that
    serve's loader reads; one more step timed; the peak."""
    import torch
    import zipfile

    from forde_tpu_torch.train import checkpoint as ckpt_lib
    from forde_tpu_torch.train import loop
    from forde_tpu_torch.train.step import train_step

    ckpt = os.path.join(workdir, "lm_long_remat_ckpt")
    args = loop.build_parser().parse_args(LONG_REMAT_ARGV)
    cfg = loop.config_from_args(args)
    out, launches, secs, peak = run_train_loop(
        LONG_REMAT_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)], workdir)
    add_launches(total, launches)
    loss = out["final_metrics"]["loss/total"]
    want = {k: args.steps_per_epoch * v for k, v in lm_launches_per_step(cfg).items()}
    state = out["state"]
    batch = lm_batch(args.batch_size, args.seq_len, cfg.vocab_size, device, SEED + 92)
    (_, step_ms), extra = counted(lambda: (None, wall_ms(
        lambda: train_step(state, batch, aux_loss_weight=args.aux_loss_weight))))
    add_launches(total, extra)
    del out, state
    torch.cuda.empty_cache()
    with zipfile.ZipFile(os.path.join(ckpt, ckpt_lib.PARAMS_FILENAME)) as zf:
        keys = [n.removesuffix(".npy") for n in zf.namelist()]
    key = "params/layers/block/attn_norm/scale"
    scanned = ckpt_lib.read_npz(os.path.join(ckpt, ckpt_lib.PARAMS_FILENAME),
                                lambda k: k == key)[key]
    saved_cfg, _ = ckpt_lib.load_meta(ckpt)
    _, served = ckpt_lib.load_lm_params(ckpt, device)
    prompt = torch.from_numpy(np.random.RandomState(SEED + 93).randint(
        1, cfg.vocab_size, (1, 640))).to(device)
    with torch.no_grad():
        logits, _ = served(prompt)
    finite = bool(torch.isfinite(logits).all())
    del served, logits
    torch.cuda.empty_cache()
    tokens = args.batch_size * args.seq_len / step_ms * 1e3
    pools = (args.seq_len - cfg.window_size) // cfg.compression_ratio
    log(f"[remat] long context: train.loop.main ({' '.join(LONG_REMAT_ARGV)}; the batch cut "
        f"from benchmarks/decoder.py's 8 to {args.batch_size}) took {secs:.2f} s: loss "
        f"{loss:.4f}, {pools} pools per row, launches {launches}, peak {peak:.2f} GiB; one more "
        f"step {step_ms:.1f} ms, {tokens:.0f} tokens/s; the checkpoint scanned "
        f"({key} {tuple(scanned.shape)}, no layer_0 key: "
        f"{not any('/layer_0/' in k for k in keys)}), served logits finite {finite}")
    if (not np.isfinite(loss) or launches != want or extra != lm_launches_per_step(cfg)
            or scanned.shape != (cfg.num_layers, cfg.d_model) or not saved_cfg.scan_layers
            or any("/layer_0/" in k for k in keys) or not finite):
        raise AssertionError(f"long-context remat run: loss {loss}, launches {launches} "
                             f"(expected {want}), one step {extra}, {key} {scanned.shape}, "
                             f"scan_layers {saved_cfg.scan_layers}, served finite {finite}")
    return {"seconds": secs, "loss": loss, "peak_gib": peak, "step_ms": step_ms,
            "tokens_per_s": tokens}


def remat_clip(device, total) -> dict:
    """vit_b16, bf16, batch 128: one sensed step under each of
    CLIP_REMAT_POLICIES from the same state (loss, gradients, act_stats and
    the gradient statistics equal "none"'s bit for bit, else phase 6's
    bars), exact launches (flash_mha_fwd doubled under "block" only,
    moment_sums never), a second step's ms and the peak; and fused "mlp"
    steps (k = CLIP_FUSE_K, a replayed call) against the same steps eager."""
    import torch

    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.train.clip_step import clip_train_step, make_fused_step, stack_batches

    cfg = clip_extras_config()
    weights = build_model(cfg, device).state_dict()
    batches = []
    for i in range(2 + 2 * CLIP_FUSE_K):
        b = training_batch(cfg, FUSE_BATCH, device, SEED + 94 + i)
        b["image"] = b["image"].to(cfg.dtypes.compute)
        batches.append(b)
    layers = cfg.vision.num_layers + cfg.text.num_layers
    runs, readings = {}, {}
    for policy in CLIP_REMAT_POLICIES:
        state = train_state(cfg.replace(remat=policy), weights, device)
        seen = capture_grads(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (state, m), launches = counted(lambda: clip_train_step(state, batches[0]))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        add_launches(total, launches)
        # kept on the host, so that the later policies' peaks do not hold them
        runs[policy] = {
            "loss": m["loss/contrastive"].reshape(1).cpu(), "grads": flat(seen[0]).cpu(),
            "act_stats": flat([l.act_stats for l in stateful_layers(state.model).values()]).cpu(),
            "grad_stats": flat(list(state.grad_stats.values())).cpu()}
        fwd = 2 if policy == "block" else 1
        want = {"flash_mha_fwd": fwd * layers, "flash_mha_bwd": layers,
                "moment_sums": 2 * layers}
        ms = wall_ms(lambda: clip_train_step(state, batches[1]))
        readings[policy] = {"step_ms": ms, "peak_gib": peak, "launches": launches,
                            "fwd_bwd": fwd_bwd_memory(state, batches[1])}
        if launches != want:
            raise AssertionError(f"sensed step under remat {policy!r}: launches {launches}, "
                                 f"expected {want}")
        del state, seen
        torch.cuda.empty_cache()
    for policy in CLIP_REMAT_POLICIES[1:]:
        got, ref = runs[policy], runs["none"]
        for k in ref:
            identical = bool(torch.equal(got[k], ref[k]))
            rel = rel_l2(got[k], ref[k])
            readings[policy][k] = {"bit_identical": identical, "rel_l2": rel}
            if not identical and not rel <= PARITY_TOL["bf16"][k]:
                raise AssertionError(f"sensed step under remat {policy!r} vs none, {k}: "
                                     f"relative L2 {rel:.3e} > {PARITY_TOL['bf16'][k]:g}")
    log(f"[remat] dual encoder (vit_b16, bf16, batch {FUSE_BATCH}), one sensed step: " + "; ".join(
        f"{p}: {r['step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB above the state's (an "
        f"unsensed forward and backward alone: {r['fwd_bwd']['forward_end_gib']:.2f} held at "
        f"the forward's end, peak {r['fwd_bwd']['peak_gib']:.2f}), launches {r['launches']}"
        + "".join(f", {k} " + ("identical" if r[k]["bit_identical"] else
                               f"{r[k]['rel_l2']:.3e}") for k in runs["none"] if k in r)
        for p, r in readings.items()))

    mlp = cfg.replace(remat="mlp")
    fus, eager = train_state(mlp, weights, device), train_state(mlp, weights, device)
    fused = make_fused_step(mlp, CLIP_FUSE_K, 1)
    first = fused.prepare(next(stack_batches(iter(batches[2:2 + CLIP_FUSE_K]), CLIP_FUSE_K)))
    rolled = batches[2 + CLIP_FUSE_K:]
    second = fused.prepare(next(stack_batches(iter(rolled), CLIP_FUSE_K)))
    fused(fus, first)
    copy_train_state_(eager, fus)
    (fus, fm), lf = counted(lambda: fused(fus, second))
    add_launches(total, lf)

    def eager_steps():
        m = None
        for b in rolled:
            _, m = clip_train_step(eager, b)
        return m

    em, le = counted(eager_steps)
    add_launches(total, le)
    want = {k: CLIP_FUSE_K * v for k, v in launches_per_step(cfg, True).items()}
    got = {"params": flat(fus.optimizer.params), "grads": flat(fus.optimizer.mu),
           "loss": fm["loss/contrastive"].reshape(1),
           "act_stats": flat([l.act_stats for l in stateful_layers(fus.model).values()]),
           "grad_stats": flat(list(fus.grad_stats.values()))}
    ref = {"params": flat(eager.optimizer.params), "grads": flat(eager.optimizer.mu),
           "loss": em["loss/contrastive"].reshape(1),
           "act_stats": flat([l.act_stats for l in stateful_layers(eager.model).values()]),
           "grad_stats": flat(list(eager.grad_stats.values()))}
    off = [k for k in ref if not torch.equal(got[k], ref[k])]
    log(f"[remat] fused {CLIP_FUSE_K} steps with 'mlp' remat, a replayed call against the same "
        f"steps eager: " + ("bit-identical" if not off else "differs in " + ", ".join(
            f"{k} {rel_l2(got[k], ref[k]):.3e}" for k in off)) + f"; launches {lf} / {le}")
    if off or lf != want or le != want:
        raise AssertionError(f"fused mlp remat vs eager: off {off}, launches {lf} / {le} "
                             f"(expected {want})")
    del fus, eager, fused, first, second, batches
    torch.cuda.empty_cache()
    readings["fused_mlp_bit_identical"] = True
    return readings


def fwd_bwd_memory(state, batch) -> dict:
    """GiB above what was allocated before it, of one unsensed forward and
    backward of the dual encoder (the optimizer left out): held at the end
    of the forward (the saved activations) and at the peak."""
    import torch

    from forde_tpu_torch.models.dual_encoder import clip_contrastive_loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    img, txt, scale = state.model(batch["image"], batch["input_ids"],
                                  batch.get("attention_mask"), sense=False)
    loss, _ = clip_contrastive_loss(img, txt, scale)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(loss, state.optimizer.params)
    del grads, loss, img, txt
    torch.cuda.synchronize()
    return {"forward_end_gib": held / 2 ** 30,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def phase_remat(device, workdir) -> dict:
    """Phase 29: rematerialisation at full width: the LM step with and
    without remat (fp32 parity, LoRA steps' parity, bf16 readings), the long-context
    configuration through the CLI (--remat --scan_layers, 4 x 8,192), and
    the dual encoder's three policies and fused "mlp" steps."""
    import torch

    cfg = serve_config()
    total: Counter = Counter()
    secs = {}
    part = parts_timer(secs)
    weights = lm_weights(cfg, device)
    out = {"lm_parity": part("lm_parity", remat_lm_parity, device, cfg, weights, total),
           "lm_lora": part("lm_lora", remat_lm_lora, device, cfg, weights, total),
           "lm_readings": part("lm_readings", remat_lm_readings, device, cfg, weights)}
    del weights
    torch.cuda.empty_cache()
    out["long_context"] = part("long_context", remat_long_lm, device, workdir, total)
    out["clip"] = part("clip", remat_clip, device, total)
    log("[remat] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    out["seconds"] = secs
    out["launches"] = dict(total)
    return out


def parts_timer(secs: dict):
    """part(name, fn, *args): fn(*args), its seconds kept in ``secs``."""
    def part(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        secs[name] = time.perf_counter() - t0
        return result

    return part


# Phase 30: the LM loop profiled at 2 layers of the full width; clip_loop
# profiled at vit_b16 (fused pairs of sensed steps); the scanned CLI round
# trip; the NSA branch modules at full width; the plots.
LM2_FLAGS = SERVE_FLAGS[:2] + ["--num_layers", "2"] + SERVE_FLAGS[4:]
PROFILE_LM_ARGV = LM2_FLAGS + [
    "--batch_size", "8", "--use_markov_data", "--steps_per_epoch", "2",
    "--slow_loop_interval", "0", "--log_interval", "1",
]
PROFILE_CLIP_ARGV = [
    "--preset", "vit_b16", "--bf16", "--use_dummy_data", "--dummy_pool", "2",
    "--batch_size", "128", "--num_steps", "4", "--fuse_steps", "2", "--slow_loop_interval", "0",
    "--log_interval", "2",
]
SCANNED_ARGV = LM2_FLAGS + [
    "--batch_size", "2", "--use_markov_data", "--slow_loop_interval", "0", "--log_interval", "1",
    "--scan_layers", "--ema_decay", str(EMA_DECAY),
]
# The CUDA names of each wrapper's kernels, as a profile shows them.
DEVICE_NAMES = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                "flash_bwd_dkv": "flash_bwd_dkv", "small_kv_fwd": "small_kv_fwd",
                "small_kv_bwd": "skv_bwd_", "flash_mha_fwd": "flash_mha_fwd",
                "flash_mha_bwd": "mha_bwd_", "moment_sums": "moment_"}
NSA_MODULE_SHAPE = dict(batch=2, seq=2048, d_model=512, heads=8, head_dim=64, ratio=8, top_k=64,
                        window=512)
NSA_MODULE_REL = 1e-5
PLOTS_ARGV = ["--preset", "tiny", "--bf16", "--use_dummy_data", "--batch_size", "16",
              "--num_steps", "2", "--slow_loop_interval", "2", "--log_interval", "2"]


def trace_kernels(path: str, names) -> dict:
    """{wrapper: device events of its kernels} in a profiler trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(DEVICE_NAMES[n] in k for k in kernels) for n in names}


def observe_profiles(device, workdir, total) -> dict:
    """--profile_dir in both loops: each trace exists, loads and holds
    device events of every kernel of its path; the step ms with and without
    the profiler (the LM at 2 layers), the traces' sizes."""
    import torch

    from forde_tpu_torch.obs import profiler
    from forde_tpu_torch.train import clip_loop
    from forde_tpu_torch.train.clip_step import make_fused_step, stack_batches
    from forde_tpu_torch.train.step import train_step

    out = {}
    prof = os.path.join(workdir, "profile_lm")
    res, launches, secs, _ = run_train_loop(
        PROFILE_LM_ARGV + ["--profile_dir", prof, "--seed", str(SEED)], workdir)
    add_launches(total, launches)
    cfg = res["state"].model.config
    lm_names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_kv_fwd", "small_kv_bwd")
    found = trace_kernels(res["traces"][0], lm_names) if len(res["traces"]) == 1 else {}
    size = os.path.getsize(res["traces"][0]) if res["traces"] else 0
    state = res["state"]
    batch = lm_batch(8, LM_SEQ, cfg.vocab_size, device, SEED + 95)
    plain = [wall_ms(lambda: train_step(state, batch, aux_loss_weight=0.01)) for _ in range(3)]
    with profiler.trace(os.path.join(workdir, "profile_lm_steps"), device):
        profiled = [wall_ms(lambda: train_step(state, batch, aux_loss_weight=0.01))
                    for _ in range(3)]
    out["lm"] = {"trace_mib": size / 2 ** 20, "kernel_events": found,
                 "step_ms": float(np.median(plain)), "step_ms_profiled": float(np.median(profiled)),
                 "seconds": secs}
    log(f"[observe] train.loop.main ({' '.join(PROFILE_LM_ARGV)} --profile_dir) took {secs:.2f} "
        f"s: trace {size / 2 ** 20:.1f} MiB, device events {found}; a step (8 x {LM_SEQ}, 2 "
        f"layers) {out['lm']['step_ms']:.2f} ms without the profiler, "
        f"{out['lm']['step_ms_profiled']:.2f} ms with it")
    if launches != {k: 2 * v for k, v in lm_launches_per_step(cfg).items()} or not found or (
            min(found.values()) == 0):
        raise AssertionError(f"profiled LM loop: launches {launches}, device events {found}")
    del res, state
    torch.cuda.empty_cache()

    prof = os.path.join(workdir, "profile_clip")
    argv = PROFILE_CLIP_ARGV + ["--profile_dir", prof, "--seed", str(SEED)]
    args = clip_loop.build_parser().parse_args(argv)
    ccfg = clip_loop.config_from_args(args)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        res, launches = counted(lambda: clip_loop.main(argv))
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    add_launches(total, launches)
    clip_names = ("flash_mha_fwd", "flash_mha_bwd", "moment_sums")
    found = trace_kernels(res["traces"][0], clip_names) if len(res["traces"]) == 1 else {}
    size = os.path.getsize(res["traces"][0]) if res["traces"] else 0
    want = {k: args.num_steps * v for k, v in launches_per_step(ccfg, True).items()}
    # a fused call (the loop's k steps, one graph replay) with and without
    # the profiler
    fused = make_fused_step(ccfg, args.fuse_steps, 1)
    b = training_batch(ccfg, args.batch_size, device, SEED + 98)
    b["image"] = b["image"].to(ccfg.dtypes.compute)
    stacked = fused.prepare(next(stack_batches(iter([b] * args.fuse_steps), args.fuse_steps)))
    state = res["state"]
    fused(state, stacked)
    plain = [wall_ms(lambda: fused(state, stacked)) for _ in range(3)]
    with profiler.trace(os.path.join(workdir, "profile_clip_calls"), device):
        profiled = [wall_ms(lambda: fused(state, stacked)) for _ in range(3)]
    out["clip"] = {"seconds": secs, "trace_mib": size / 2 ** 20, "kernel_events": found,
                   "fused_call_ms": float(np.median(plain)),
                   "fused_call_ms_profiled": float(np.median(profiled))}
    log(f"[observe] clip_loop.main ({' '.join(PROFILE_CLIP_ARGV)} --profile_dir) took "
        f"{secs:.2f} s: trace {size / 2 ** 20:.1f} MiB, device events {found}; a fused call of "
        f"{args.fuse_steps} sensed steps {out['clip']['fused_call_ms']:.2f} ms without the "
        f"profiler, {out['clip']['fused_call_ms_profiled']:.2f} ms with it")
    if launches != want or not found or min(found.values()) == 0:
        raise AssertionError(f"profiled clip loop: launches {launches} (expected {want}), "
                             f"device events {found}")
    del res, state, fused, stacked
    torch.cuda.empty_cache()
    return out


def observe_scanned_round_trip(device, workdir, total) -> dict:
    """The LM loop with --scan_layers --ema_decay at 2 layers of the full
    width, 2 steps, then --resume for 1 more: the restored state equals
    the saved one bit for bit; serving the checkpoint gives the logits of
    serving an unrolled save of the same weights, bit for bit."""
    import torch

    from forde_tpu_torch import interop
    from forde_tpu_torch.train import checkpoint as ckpt_lib

    ckpt = os.path.join(workdir, "scanned_ckpt")
    first, la, _, _ = run_train_loop(SCANNED_ARGV + ["--steps_per_epoch", "2",
                                                     "--checkpoint_dir", ckpt], workdir)
    add_launches(total, la)
    saved = {k: v.clone() for k, v in state_tensors(first["state"]).items()}
    del first
    fresh, lb, _, _ = run_train_loop(SCANNED_ARGV + ["--steps_per_epoch", "0"], workdir)
    ckpt_lib.restore_train_state(ckpt, fresh["state"])
    off = same_tensors(saved, state_tensors(fresh["state"]))
    del fresh
    resumed, lc, _, _ = run_train_loop(SCANNED_ARGV + ["--steps_per_epoch", "3", "--resume",
                                                       "--checkpoint_dir", ckpt], workdir)
    add_launches(total, lc)
    model = resumed["state"].model
    unrolled = os.path.join(workdir, "unrolled_ckpt")
    ckpt_lib.save_params(unrolled, model.config.replace(scan_layers=False),
                         interop.flatten(interop.state_dict_to_flax(model.state_dict())),
                         {"step": resumed["step"]})
    del resumed, model
    prompt = torch.from_numpy(np.random.RandomState(SEED + 96).randint(
        1, 50257, (1, 700))).to(device)
    logits = []
    for d in (ckpt, unrolled):
        _, m = ckpt_lib.load_lm_params(d, device)
        with torch.no_grad():
            logits.append(m(prompt)[0])
        del m
    same = bool(torch.equal(logits[0], logits[1]))
    cfg, meta = ckpt_lib.load_meta(ckpt)
    log(f"[observe] --scan_layers --ema_decay {EMA_DECAY} (2 layers, full width): the saved "
        f"state restored bit for bit ({len(saved)} tensors, {len(off)} off), --resume went on "
        f"to step {meta['step']}; served logits of the scanned checkpoint = an unrolled save's: "
        f"{same}")
    if off or not same or meta["step"] != 3 or not cfg.scan_layers:
        raise AssertionError(f"scanned round trip: {off[:4]} off, logits equal {same}, step "
                             f"{meta['step']}, scan_layers {cfg.scan_layers}")
    torch.cuda.empty_cache()
    return {"restored_bit_identical": True, "served_logits_bit_identical": same}


def observe_nsa_modules(device) -> dict:
    """CompressedGlobalAttention and TopKSelection at NSA_MODULE_SHAPE, fp32:
    the card's outputs within NSA_MODULE_REL relative L2 of the CPU's on the
    same weights, the top-k indices equal (a tie-free score: a seeded
    permutation)."""
    import torch

    from forde_tpu_torch.nn.nsa_modules import CompressedGlobalAttention, TopKSelection

    s = NSA_MODULE_SHAPE
    gen = torch.Generator().manual_seed(SEED + 97)
    mods = {"compressed": CompressedGlobalAttention(s["d_model"], s["heads"], s["head_dim"],
                                                    s["ratio"]),
            "topk": TopKSelection(s["d_model"], s["heads"], s["head_dim"], s["top_k"])}
    for m in mods.values():
        for sub in m.modules():
            if hasattr(sub, "init_params"):
                sub.init_params(gen)
    x = torch.randn(s["batch"], s["seq"], s["d_model"], generator=gen)
    scores = torch.stack([torch.randperm(s["seq"], generator=gen).float()
                          for _ in range(s["batch"])])
    start = s["seq"] - s["window"]
    with torch.no_grad():
        cpu = {"compressed": mods["compressed"](x, start), "topk": mods["topk"](x, scores)}
        card = {"compressed": mods["compressed"].to(device)(x.to(device), start),
                "topk": mods["topk"].to(device)(x.to(device), scores.to(device))}
    rel = {"compressed": rel_l2(card["compressed"].cpu(), cpu["compressed"]),
           "topk": rel_l2(card["topk"][0].cpu(), cpu["topk"][0])}
    same_idx = bool(torch.equal(card["topk"][1].cpu(), cpu["topk"][1]))
    log(f"[observe] NSA branch modules ({s}, fp32): card against CPU relative L2 "
        f"{rel}; top-k indices equal {same_idx}")
    if not same_idx or max(rel.values()) > NSA_MODULE_REL:
        raise AssertionError(f"NSA branch modules card vs CPU: {rel}, indices equal {same_idx}")
    return {"rel_l2": rel, "indices_equal": same_idx}


def observe_plots(workdir) -> dict:
    """clip_loop --plots_dir: with matplotlib the files are written; without
    it the flag raises before the first step, naming matplotlib."""
    import importlib.util

    from forde_tpu_torch.train import clip_loop

    plots = os.path.join(workdir, "plots")
    argv = PLOTS_ARGV + ["--plots_dir", plots, "--seed", str(SEED)]
    if importlib.util.find_spec("matplotlib") is not None:
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            clip_loop.main(argv)
        finally:
            os.chdir(cwd)
        files = sorted(os.path.relpath(os.path.join(d, f), plots)
                       for d, _, fs in os.walk(plots) for f in fs)
        log(f"[observe] matplotlib imports here: clip_loop --plots_dir wrote {files}")
        if len(files) != 6:
            raise AssertionError(f"clip_loop --plots_dir wrote {files}")
        return {"matplotlib": True, "files": files}
    try:
        clip_loop.main(argv)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("clip_loop --plots_dir ran without matplotlib")
    log(f"[observe] matplotlib does not import here: clip_loop --plots_dir raised before the "
        f"first step: {message}")
    if "matplotlib" not in message or os.path.exists(plots):
        raise AssertionError(f"--plots_dir without matplotlib: {message}")
    return {"matplotlib": False, "message": message}


def phase_observe(device, workdir) -> dict:
    """Phase 30: profiles of both loops, the scanned CLI round trip, the
    NSA branch modules on the card, the plots."""
    total: Counter = Counter()
    secs = {}
    part = parts_timer(secs)
    out = {"profiles": part("profiles", observe_profiles, device, workdir, total),
           "scanned": part("scanned", observe_scanned_round_trip, device, workdir, total),
           "nsa_modules": part("nsa_modules", observe_nsa_modules, device),
           "plots": part("plots", observe_plots, workdir)}
    log("[observe] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    out["seconds"] = secs
    out["launches"] = dict(total)
    return out


# Phase 31: multi-device training on thread ranks and the CLIs under one
# NCCL rank. The ring's blocks at the long-context step's shape (one
# sequence of 8,192 split over 4 context ranks: S_local = 2,048); NSA's
# context-parallel pieces at the same S (window 512, 960 pools of ratio 8,
# top-k 64); the LM's expert bank (E 8, D 512, H 2,048, top-2) at
# capacity factor 8 (no token drops) over (data 2, expert 2); vit_b16's
# batch of 128 over data 4 for the sharded contrastive loss.
PAR_B, PAR_H, PAR_S, PAR_D = 1, 8, 8192, 64
PAR_RANKS = 4
PAR_SKV = (("pools_k960", 960), ("topk_k64", 64))
PAR_EP = dict(b=8, s=2048, d=512, h=2048, e=8, k=2, factor=8.0)
PAR_CLIP = dict(b=128, d=512)
# The full-width LM step (fp32, the reference-default decoder at
# PAR_LM_LAYERS, NSA and mHC on, carried weights): 1 x 8,192 over (context 4),
# and over (data 2, expert 2) with ep dispatch at capacity factor 8
# against one rank's capacity dispatch at the same factor. The EP batch is
# 4 x 2,048, not 8 x 2,048: four fp32 replicas on one card, each with its
# 2 x 2,048 rows' activations alive at once, and the one-rank reference
# step beside them, fill its 80 GB at 8 rows.
PAR_LM_CASES = (("context4", {"context": 4}, 1, 8192, "capacity"),
                ("data2_expert2_ep", {"data": 2, "expert": 2}, 4, 2048, "ep"))
PAR_LM_FACTOR = 8.0
# The depth of the LM in phases 31 and 32, cut from the reference-default
# 12 layers for the run's time; pipe 4 and pipe 2 still split it evenly.
PAR_LM_LAYERS = 8
# The CLIs under a one-rank NCCL group against the same CLIs alone, fp32,
# the two processes of a pair side by side on the card: the LM loop 2
# steps at full width (2 x 2,048: two processes at 8 rows would not fit
# the card together), and clip_loop at vit_b16 with --fuse_steps 2 (its
# NCCL all-reduce inside the CUDA graph).
PAR_CLI_LM = [a for a in SERVE_FLAGS if a != "--bf16"] + [
    "--batch_size", "2", "--use_markov_data", "--steps_per_epoch", "2",
    "--slow_loop_interval", "0", "--log_interval", "1"]
PAR_CLI_CLIP = ["--preset", "vit_b16", "--use_dummy_data", "--dummy_pool", "2",
                "--batch_size", "128", "--num_steps", "2", "--fuse_steps", "2",
                "--sense_interval", "1", "--slow_loop_interval", "0", "--log_interval", "2"]


def thread_ranks(shape, fn) -> list:
    """``fn(mesh)`` on thread ranks of this process on the card, one per
    rank of ``shape`` (parallel/collectives.run_threads): [(result, the
    rank's own kernel launches)] in rank order."""
    import math

    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.mesh import Mesh
    from forde_tpu_torch.parallel.collectives import run_threads

    def rank(r, world):
        with kernels.thread_launches() as counts:
            out = fn(Mesh(shape, r, world))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return out, dict(counts)

    return run_threads(math.prod(shape.values()), rank)


def par_hold(what, got, want, mag, tol, dtype_name) -> float:
    """|got - want| <= atol + rtol (|want| + mag) per element, or raise;
    returns the worst ratio to the bar."""
    atol, rtol = tol[dtype_name]
    err, ratio = held_against(got, want, atol, rtol * (want.abs() + mag))
    log(f"[parallel] {what}: max |err| {err:.3e}, worst / bar {ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: {ratio:.3f} of the bar")
    return err


def par_ring(device, dtype, schedule, causal, launches) -> float:
    """Ring attention over (context 4) against one flash_attention call
    over the whole sequence: o, dq, dk, dv and the launches per rank. fp32
    against that call with the kernels; bf16 against the same ring run on
    the kernels' plain versions, which round at the same places (the ring
    adds bf16 partials that one call never forms), the one-call reading
    printed beside it."""
    import torch

    from forde_tpu_torch.core.mesh import Sharding
    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 310)
    shape = (PAR_B, PAR_H, PAR_S, PAR_D)
    q, k, v, w = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(4))
    dtype_name = str(dtype).removeprefix("torch.")

    def run(mesh):
        split = Sharding(mesh, (None, None, "context", None))
        tq, tk, tv = (split(t).contiguous().requires_grad_() for t in (q, k, v))
        o = ring_attention(tq, tk, tv, mesh, causal=causal, schedule=schedule)
        torch.sum(o.float() * split(w).float()).backward()
        return [t.detach() for t in (o, tq.grad, tk.grad, tv.grad)]

    ranks = thread_ranks({"context": PAR_RANKS}, run)
    got = [torch.cat([r[0][i] for r in ranks], dim=2) for i in range(4)]
    n = PAR_RANKS
    calls = 3 + 2 * (n - 1) if schedule == "zigzag" else n
    for r, (_, counts) in enumerate(ranks):
        want = {"flash_fwd": calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
        if counts != want:
            raise AssertionError(f"ring {schedule} rank {r}: launches {counts}, expected {want}")
        for name, c in counts.items():
            launches[name] += c
    # the reference: one call over the whole sequence, and its magnitudes
    scale = PAR_D ** -0.5
    f32 = [t.float() for t in (q, k, v)]
    if dtype == torch.float32:
        rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
        ro = fa.flash_attention(rq, rk, rv, causal=causal, scale=scale)
        torch.sum(ro.float() * w.float()).backward()
        want = [ro.detach(), rq.grad, rk.grad, rv.grad]
    else:
        with plain_lm_kernels():
            plain = thread_ranks({"context": PAR_RANKS}, run)
        want = [torch.cat([r[0][i] for r in plain], dim=2).float() for i in range(4)]
    o_ref, lse = fa.flash_fwd_reference(*f32, scale, None, causal, None)
    delta = fa._delta(o_ref, w.float(), None)
    mags = [flash_fwd_magnitude(*f32, scale, None, causal, None),
            *flash_bwd_magnitudes(*f32, lse, w.float(), delta, scale, None, causal, None)]
    worst = 0.0
    label = f"ring {schedule}{'' if causal else ' non-causal'} {dtype_name}"
    for part, g, want_t, mag, tol in zip(("o", "dq", "dk", "dv"), got, want, mags,
                                          (TOL_ATTN, TOL_BWD, TOL_BWD, TOL_BWD)):
        worst = max(worst, par_hold(f"{label} {part} (launches/rank {calls})", g, want_t.float(),
                                    mag, tol, dtype_name))
    if dtype != torch.float32:  # the one-call reading, printed only
        rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
        ro = fa.flash_attention(rq, rk, rv, causal=causal, scale=scale)
        torch.sum(ro.float() * w.float()).backward()
        for part, g, ref in zip(("o", "dq", "dk", "dv"), got,
                                (ro.detach(), rq.grad, rk.grad, rv.grad)):
            rel = float((g.float() - ref.float()).norm() / ref.float().norm())
            log(f"[parallel] {label} {part} against one kernel call: relative L2 {rel:.3e}")
    return worst


def par_window(device, dtype, launches) -> float:
    """window_attention_cp at window 512 over (context 4) against one
    windowed flash_attention call: 2 flash_fwd per rank."""
    import torch

    from forde_tpu_torch.core.mesh import Sharding
    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.parallel.nsa_context import window_attention_cp

    gen = torch.Generator(device=device).manual_seed(SEED + 311)
    shape = (PAR_B, PAR_H, PAR_S, PAR_D)
    q, k, v, w = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(4))
    dtype_name = str(dtype).removeprefix("torch.")

    def run(mesh):
        split = Sharding(mesh, (None, None, "context", None))
        tq, tk, tv = (split(t).contiguous().requires_grad_() for t in (q, k, v))
        o = window_attention_cp(tq, tk, tv, mesh, WINDOW)
        torch.sum(o.float() * split(w).float()).backward()
        return [t.detach() for t in (o, tq.grad, tk.grad, tv.grad)]

    ranks = thread_ranks({"context": PAR_RANKS}, run)
    for r, (_, counts) in enumerate(ranks):
        want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
        if counts != want:
            raise AssertionError(f"window_attention_cp rank {r}: launches {counts}, "
                                 f"expected {want}")
        for name, c in counts.items():
            launches[name] += c
    got = [torch.cat([r[0][i] for r in ranks], dim=2) for i in range(4)]
    scale = PAR_D ** -0.5
    f32 = [t.float() for t in (q, k, v)]
    if dtype == torch.float32:
        rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
        ro = fa.flash_attention(rq, rk, rv, causal=True, window_size=WINDOW, scale=scale)
        torch.sum(ro.float() * w.float()).backward()
        want = [ro.detach(), rq.grad, rk.grad, rv.grad]
    else:
        with plain_lm_kernels():
            plain = thread_ranks({"context": PAR_RANKS}, run)
        want = [torch.cat([r[0][i] for r in plain], dim=2) for i in range(4)]
    o_ref, lse = fa.flash_fwd_reference(*f32, scale, WINDOW, True, None)
    delta = fa._delta(o_ref, w.float(), None)
    mags = [flash_fwd_magnitude(*f32, scale, WINDOW, True, None),
            *flash_bwd_magnitudes(*f32, lse, w.float(), delta, scale, WINDOW, True, None)]
    worst = 0.0
    for part, g, want_t, mag, tol in zip(("o", "dq", "dk", "dv"), got, want, mags,
                                          (TOL_ATTN, TOL_BWD, TOL_BWD, TOL_BWD)):
        worst = max(worst, par_hold(f"window_attention_cp {str(dtype)[6:]} {part} (2 flash_fwd "
                                    "per rank)", g, want_t.float(), mag, tol, dtype_name))
    return worst


def par_small_kv(device, launches) -> float:
    """small_kv_attention_cp at the 8,192-token step's pools (K = 960,
    ratio 8) and top-k (K = 64), key_pos shifted by -rank * S_local,
    against one unsharded small_kv_attention call, fp32: out, dq, dk, dv."""
    import torch

    from forde_tpu_torch.core.mesh import Sharding
    from forde_tpu_torch.ops import nsa_attention as nsa
    from forde_tpu_torch.parallel.nsa_context import small_kv_attention_cp

    worst = 0.0
    for label, kk in PAR_SKV:
        gen = torch.Generator(device=device).manual_seed(SEED + 312 + kk)
        q, w = (torch.randn(PAR_B, PAR_H, PAR_S, PAR_D, device=device, generator=gen)
                for _ in range(2))
        k, v = (torch.randn(PAR_B, PAR_H, kk, PAR_D, device=device, generator=gen)
                for _ in range(2))
        key_pos = small_kv_key_pos("pools" if kk != 64 else "topk", PAR_B, PAR_S, kk, device, gen)

        def run(mesh):
            split = Sharding(mesh, (None, None, "context", None))
            tq = split(q).contiguous().requires_grad_()
            tk, tv = (t.clone().requires_grad_() for t in (k, v))
            o = small_kv_attention_cp(tq, tk, tv, key_pos, mesh)
            torch.sum(o * split(w)).backward()
            return [t.detach() for t in (o, tq.grad, tk.grad, tv.grad)]

        ranks = thread_ranks({"context": PAR_RANKS}, run)
        for r, (_, counts) in enumerate(ranks):
            if counts != {"small_kv_fwd": 1, "small_kv_bwd": 1}:
                raise AssertionError(f"small_kv_attention_cp {label} rank {r}: {counts}")
            for name, c in counts.items():
                launches[name] += c
        got = [torch.cat([r[0][i] for r in ranks], dim=2) for i in range(2)]
        got += [sum(r[0][i] for r in ranks) for i in (2, 3)]  # k, v: every rank's share
        rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
        ro = nsa.small_kv_attention(rq, rk, rv, key_pos)
        torch.sum(ro * w).backward()
        scale = PAR_D ** -0.5
        mags = [small_kv_magnitude(q, k, v, key_pos, scale),
                *small_kv_bwd_magnitudes(q, k, v, key_pos, w, scale)]
        for part, g, want, mag, tol in zip(("out", "dq", "dk", "dv"), got,
                                           (ro.detach(), rq.grad, rk.grad, rv.grad), mags,
                                           (TOL_ATTN, TOL_SKV_BWD, TOL_SKV_BWD, TOL_SKV_BWD)):
            worst = max(worst, par_hold(f"small_kv_attention_cp {label} {part}", g, want, mag,
                                        tol, "float32"))
    return worst


def par_exact_pieces(device) -> None:
    """gather_pool_means_cp and topk_select_cp over (context 4) equal the
    unsharded pool means and rows bit for bit."""
    import torch

    from forde_tpu_torch.core.mesh import Sharding
    from forde_tpu_torch.ops.moe_dispatch import top_k_desc
    from forde_tpu_torch.parallel.nsa_context import gather_pool_means_cp, topk_select_cp

    gen = torch.Generator(device=device).manual_seed(SEED + 313)
    x = torch.randn(2, PAR_S, 512, device=device, generator=gen)
    num_pools = (PAR_S - WINDOW) // POOL_RATIO
    idx = top_k_desc(torch.randn(2, PAR_S, device=device, generator=gen), 64)[1]
    want_pools = x[:, :num_pools * POOL_RATIO].reshape(2, num_pools, POOL_RATIO, 512).mean(2)
    want_rows = x[torch.arange(2, device=device)[:, None], idx]

    def run(mesh):
        local = Sharding(mesh, (None, "context"))(x).contiguous()
        return (gather_pool_means_cp(local, mesh, POOL_RATIO, num_pools),
                topk_select_cp(local, idx, mesh))

    for r, ((pools, rows), _) in enumerate(thread_ranks({"context": PAR_RANKS}, run)):
        if not (torch.equal(pools, want_pools) and torch.equal(rows, want_rows)):
            raise AssertionError(f"rank {r}: gather_pool_means_cp / topk_select_cp differ from "
                                 "the unsharded means and rows")
    log(f"[parallel] gather_pool_means_cp ({num_pools} pools) and topk_select_cp (64 rows) "
        "bit-identical to the unsharded functions on every rank")


def par_expert(device) -> dict:
    """expert_parallel_ffn, a2a and psum, over (data 2, expert 2) against
    one rank's capacity dispatch at the same factor (no drops), fp32."""
    import torch

    from forde_tpu_torch.core.mesh import batch_sharding, expert_sharding
    from forde_tpu_torch.ops import moe_dispatch as md
    from forde_tpu_torch.parallel.expert_parallel import _experts, expert_parallel_ffn

    p = PAR_EP
    gen = torch.Generator(device=device).manual_seed(SEED + 314)
    x = torch.randn(p["b"], p["s"], p["d"], device=device, generator=gen)
    logits = torch.randn(p["b"], p["s"], p["e"], device=device, generator=gen)
    idx, probs = md.top_k_gating(logits, p["k"])
    bank = (torch.randn(p["e"], p["d"], p["h"], device=device, generator=gen) * p["d"] ** -0.5,
            torch.zeros(p["e"], p["h"], device=device),
            torch.randn(p["e"], p["h"], p["d"], device=device, generator=gen) * p["h"] ** -0.5,
            torch.zeros(p["e"], p["d"], device=device))
    t = p["b"] * p["s"]
    plan = md.capacity_route(idx.reshape(t, p["k"]), probs.reshape(t, p["k"]), p["e"],
                             max(int(p["factor"] * t * p["k"] / p["e"]), p["k"]))
    want = md.capacity_combine(_experts(md.capacity_gather(x.reshape(t, -1), plan), *bank),
                               plan).reshape(x.shape)
    out = {}
    for variant in ("a2a", "psum"):
        def run(mesh, variant=variant):
            rows, experts = batch_sharding(mesh), expert_sharding(mesh)
            return expert_parallel_ffn(rows(x), rows(idx), rows(probs),
                                       tuple(experts(b) for b in bank), mesh,
                                       num_experts=p["e"], top_k=p["k"],
                                       capacity_factor=p["factor"], variant=variant)

        ranks = thread_ranks({"data": 2, "expert": 2}, run)
        got = torch.cat([ranks[0][0], ranks[2][0]])  # data 0 and data 1 (expert 0)
        for a, b in ((ranks[0][0], ranks[1][0]), (ranks[2][0], ranks[3][0])):
            if not torch.equal(a, b):
                raise AssertionError(f"EP {variant}: the expert ranks' outputs differ")
        rel = float((got - want).norm() / want.norm())
        log(f"[parallel] expert_parallel_ffn {variant} (E {p['e']}, D {p['d']}, H {p['h']}, "
            f"top-{p['k']}, factor {p['factor']:g}, {t} tokens over data 2 x expert 2): "
            f"relative L2 {rel:.3e} against one rank's capacity dispatch")
        if not rel <= 1e-5:
            raise AssertionError(f"EP {variant}: relative L2 {rel:.3e} > 1e-5")
        out[variant] = rel
    return out


def par_contrastive(device) -> dict:
    """sharded_contrastive_loss at vit_b16's batch of 128 over data 4
    against clip_contrastive_loss: loss, accuracies, gradients (fp32)."""
    import torch

    from forde_tpu_torch.core.mesh import batch_sharding
    from forde_tpu_torch.models.dual_encoder import clip_contrastive_loss
    from forde_tpu_torch.parallel.contrastive import sharded_contrastive_loss

    gen = torch.Generator(device=device).manual_seed(SEED + 315)
    img, txt = (torch.randn(PAR_CLIP["b"], PAR_CLIP["d"], device=device, generator=gen)
                for _ in range(2))
    # pairs aligned enough that the accuracies are not 0, and not so much
    # that p_ii ~ 1: the gradient's (p - 1) terms would then cancel in fp32
    # (at txt = img + 0.5 noise its relative L2 reads 3.4e-4 on an H100)
    txt = txt + 0.3 * img
    scale = torch.tensor(2.6592, device=device)
    ri, rt, rs = (t.clone().requires_grad_() for t in (img, txt, scale))
    want, want_m = clip_contrastive_loss(ri, rt, rs)
    want.backward()
    want = want.detach()

    def run(mesh):
        rows = batch_sharding(mesh)
        ti, tt = (rows(t).clone().requires_grad_() for t in (img, txt))
        ts = scale.clone().requires_grad_()
        loss, metrics = sharded_contrastive_loss(ti, tt, ts, mesh)
        (loss / mesh.size).backward()
        return loss.detach(), metrics, ti.grad, tt.grad, ts.grad

    ranks = [r for r, _ in thread_ranks({"data": PAR_RANKS}, run)]
    # the loss relative to max(|loss|, 1): 1e-5 as the CPU test holds it
    readings = {"loss": abs(float(ranks[0][0]) - float(want)) / max(abs(float(want)), 1.0)}
    for key in want_m:
        readings[key] = abs(float(ranks[0][1][key]) - float(want_m[key].detach()))
    gi, gt = torch.cat([r[2] for r in ranks]), torch.cat([r[3] for r in ranks])
    gs = sum(r[4] for r in ranks)
    for name, g, ref in (("d_img", gi, ri.grad), ("d_txt", gt, rt.grad), ("d_scale", gs, rs.grad)):
        readings[name] = float((g - ref).norm() / ref.norm())
    log("[parallel] sharded_contrastive_loss (128 over data 4) against clip_contrastive_loss: "
        + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    bars = {"loss": 1e-5, "d_img": 1e-4, "d_txt": 1e-4, "d_scale": 1e-4}
    for k, v in readings.items():
        if not v <= bars.get(k, 1e-6):
            raise AssertionError(f"sharded contrastive {k}: {v:.3e}")
    if any(not torch.equal(r[0], ranks[0][0]) for r in ranks):
        raise AssertionError("sharded contrastive: the ranks' losses differ")
    return readings


def par_lm_step(device, launches) -> dict:
    """One full-width fp32 LM train_step on thread ranks (PAR_LM_CASES)
    against one rank's step on the same batch: loss, grad norm, gradients
    (Adam's first moment, expert banks gathered) and the updated
    parameters to phase 12's fp32 bars; the kernels counted per rank."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.state import create_train_state, shard_train_state
    from forde_tpu_torch.train.step import lm_batch as split_batch, train_step

    base = serve_config().replace(dtypes=DTypePolicy.fp32(), moe_capacity_factor=PAR_LM_FACTOR,
                                  max_seq_len=max(s for *_, s, _ in PAR_LM_CASES),
                                  num_layers=PAR_LM_LAYERS)
    weights = lm_weights(base, device)
    out = {}
    for name, shape, b, s, dispatch in PAR_LM_CASES:
        cfg = base.replace(moe_dispatch=dispatch)
        ids = lm_batch(b, s, cfg.vocab_size, device, SEED + 316)["input_ids"]

        def run(mesh, cfg=cfg, ids=ids):
            model = FORDEDecoderLM(cfg, device=device, mesh=mesh)
            model.load_state_dict(weights)
            state = shard_train_state(create_train_state(cfg, None, 3e-4, 0.01, model=model),
                                      mesh)
            state, m = train_step(state, split_batch(ids, mesh), aux_loss_weight=0.01)
            res = {"loss": m["loss/total"].reshape(1), "grad_norm": m["training/grad_norm"],
                   "coords": mesh.coords, "marks": state.expert_params,
                   "mu": [t.clone() for t in state.optimizer.mu],
                   "params": [t.detach().clone() for t in state.optimizer.params]}
            del state, model
            return res

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ranks = thread_ranks(shape, run)
        ranks_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for _, counts in ranks:
            for k, c in counts.items():
                launches[k] += c
        counts0 = ranks[0][1]
        marks = ranks[0][0]["marks"]

        def whole(key):
            """The optimizer's tensors flattened, expert banks gathered."""
            first = sorted((r for r, _ in ranks
                            if r["coords"]["data"] == r["coords"]["context"] == 0),
                           key=lambda r: r["coords"]["expert"])
            return torch.cat([(torch.cat([r[key][i] for r in first]) if marks[i]
                               else ranks[0][0][key][i]).flatten() for i in range(len(marks))])

        got = {"loss": ranks[0][0]["loss"], "grads": whole("mu"), "params": whole("params")}
        grad_norm = float(ranks[0][0]["grad_norm"])
        ref_cfg = cfg.replace(moe_dispatch="capacity")
        model = FORDEDecoderLM(ref_cfg, device=device)
        model.load_state_dict(weights)
        state = create_train_state(ref_cfg, None, 3e-4, 0.01, model=model)
        kernels.reset_launches()
        state, m = train_step(state, {"input_ids": ids}, aux_loss_weight=0.01)
        torch.cuda.synchronize()
        want = {"loss": m["loss/total"].reshape(1),
                "grads": torch.cat([t.flatten() for t in state.optimizer.mu]),
                "params": torch.cat([t.detach().flatten() for t in state.optimizer.params])}
        want_norm = float(m["training/grad_norm"])
        del state, model
        torch.cuda.empty_cache()
        rel = {k: float((got[k].float() - want[k].float()).norm() / want[k].float().norm())
               for k in want}
        rel["grad_norm"] = abs(grad_norm - want_norm) / want_norm
        log(f"[parallel] LM step {name} ({b} x {s}, fp32, {cfg.num_layers} layers, {dispatch}): "
            "relative L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f"; launches of rank 0 {counts0}; {ranks_s:.1f} s, peak {peak:.2f} GiB")
        for k, tol in {**LM_PARITY_TOL_FP32, "grad_norm": LM_PARITY_TOL_FP32["loss"]}.items():
            if not rel[k] <= tol:
                raise AssertionError(f"LM step {name} {k}: {rel[k]:.3e} > {tol:g}")
        for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_kv_fwd", "small_kv_bwd"):
            if not counts0.get(key):
                raise AssertionError(f"LM step {name}: rank 0 launched no {key}")
        out[name] = {"relative_l2": rel, "launches_rank0": counts0, "seconds": ranks_s,
                     "peak_gib": peak}
    return out


def par_clis(workdir) -> dict:
    """The LM loop and clip_loop under a one-rank NCCL group (torchrun's
    variables, WORLD_SIZE=1) and alone, each in a subprocess, the two of
    a pair at once: the final losses equal bit for bit, the log naming
    the NCCL group."""
    import socket

    from forde_tpu_torch.obs.metrics import REFERENCE_TAGS

    def port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return str(s.getsockname()[1])

    def start(module, argv, name, group):
        """The process and its log file (a file, not a pipe: the pair runs
        at once and neither may block on output the other's wait leaves
        unread)."""
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = REPO
        if group:
            env.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port())
        path = os.path.join(workdir, f"{name}.log")
        with open(path, "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", module, *argv, "--experiment_name",
                                     name], cwd=workdir, env=env, stdout=f,
                                    stderr=subprocess.STDOUT, text=True)
        return proc, path

    def final(name, tag):
        import glob

        (path,) = glob.glob(os.path.join(workdir, "runs", f"{name}_*", "metrics.jsonl"))
        rows = [json.loads(line) for line in open(path)]
        return [r["value"] for r in rows if r["tag"] == tag][-1]

    out = {}
    for module, argv, tag in (
        ("forde_tpu_torch.train.loop", PAR_CLI_LM, REFERENCE_TAGS.get("loss/total", "loss/total")),
        ("forde_tpu_torch.train.clip_loop", PAR_CLI_CLIP, "loss/contrastive"),
    ):
        short = module.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        procs, logs = {}, {}
        for group in (True, False):
            procs[group] = start(module, argv, f"par_{short}_{group}", group)
        try:
            for group, (proc, path) in procs.items():
                proc.wait(timeout=600)
                with open(path) as f:
                    logs[group] = f.read()
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        procs = {g: p for g, (p, _) in procs.items()}
        secs = time.perf_counter() - t0
        for g, p in procs.items():
            if p.returncode != 0:
                raise AssertionError(f"{short} (group {g}) exited {p.returncode}:\n"
                                     + logs[g][-3000:])
        if "process group: nccl over 1 rank(s)" not in logs[True]:
            raise AssertionError(f"{short} under torchrun's variables did not start NCCL:\n"
                                 + logs[True][-2000:])
        with_group, alone = final(f"par_{short}_True", tag), final(f"par_{short}_False", tag)
        log(f"[parallel] {short} {' '.join(argv)}: final loss {with_group!r} under a one-rank "
            f"NCCL group, {alone!r} alone ({secs:.1f} s for the pair)")
        if with_group != alone:
            raise AssertionError(f"{short}: {with_group!r} under NCCL != {alone!r} alone")
        out[short] = {"final_loss": alone, "seconds": secs}
    return out


def phase_parallel(device, workdir) -> dict:
    """Phase 31: the multi-device modules on PAR_RANKS thread ranks of one
    process on the one card (their times are one card's, not a
    multi-GPU's), at full width: the ring (causal, zigzag, non-causal),
    the window with its halo, NSA's small-KV calls, pool means and top-k
    rows, the expert-parallel FFN, the sharded contrastive loss, and one
    full-width LM step over (context 4) and (data 2, expert 2); then the
    training CLIs under a one-rank NCCL group. Returns the launches of the
    thread ranks (the references' launches are not counted)."""
    import torch

    launches: Counter = Counter()
    secs, worst = {}, {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for schedule, causal in (("ring", True), ("zigzag", True), ("ring", False)):
            key = f"ring_{schedule}{'' if causal else '_noncausal'}_{str(dtype)[6:]}"
            worst[key] = par_ring(device, dtype, schedule, causal, launches)
        worst[f"window_{str(dtype)[6:]}"] = par_window(device, dtype, launches)
    worst["small_kv"] = par_small_kv(device, launches)
    par_exact_pieces(device)
    secs["attention"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    expert = par_expert(device)
    contrastive = par_contrastive(device)
    secs["expert_contrastive"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = par_lm_step(device, launches)
    secs["lm_step"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clis = par_clis(workdir)
    secs["clis"] = time.perf_counter() - t0
    log("[parallel] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    log(f"[parallel] launches of the thread ranks: {dict(launches)}")
    return {"launches": dict(launches), "worst_max_abs_err": worst, "expert": expert,
            "contrastive": contrastive, "lm_step": lm, "clis": clis, "seconds": secs}


# Phase 32: tensor parallelism, FSDP and the GPipe pipeline on
# thread ranks of one process on the one card, at full width, fp32. The LM
# of SERVE_FLAGS at PAR_LM_LAYERS (capacity dispatch at factor 8, so that
# no token drops and the ranks' capacity plans equal one rank's): (a)
# model 4 at 2 x 2,048;
# (b) data 2 x model 2 with fsdp at 4 x 2,048; (c) GPipe over pipe 4 with 4
# microbatches and over data 2 x pipe 2 with 2, at 4 x 1,024: at 4 x 2,048
# the four stages' activations of all M + S - 1 ticks (the bubble is
# computed) did not fit the 80 GB beside each other (pipe 4 ran out at 77.7
# GiB, at 12 layers), and 2 rows would not split into 4 microbatches, so the rows keep
# their number and their length halves. Each case: (name, mesh, rows,
# tokens a row, param_sharding, GPipe microbatches or 0).
PAR2_LM_CASES = (("model4", {"model": 4}, 2, 2048, "replicated", 0),
                 ("data2_model2_fsdp", {"data": 2, "model": 2}, 4, 2048, "fsdp", 0),
                 ("pipe4_m4", {"pipe": 4}, 4, 1024, "replicated", 4),
                 ("data2_pipe2_m2", {"data": 2, "pipe": 2}, 4, 1024, "replicated", 2))
# (d) the dual encoder at vit_b16, one sensed step at batch 128 over data 2 x
# model 2 with fsdp, held to phase 12's fp32 bars, act_stats included (its
# readings between two fp32 paths: the binary-step neurons turn fp32 noise
# in a pre-activation near 0 into a whole unit, ~4e-5 relative L2, and the
# split GEMMs and the partial sums over the model axis are such noise);
# (e) generate_cached over model 2 on SERVE_PROMPT_LENS.
PAR2_CLIP_BATCH = 128
PAR2_TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_kv_fwd",
                         "small_kv_bwd")


def par2_state_bytes(state) -> int:
    """A rank's parameter and Adam moment bytes."""
    opt = state.optimizer
    return sum(t.numel() * t.element_size() for t in (*opt.params, *opt.mu, *opt.nu))


def par2_whole(state, keep: bool) -> dict:
    """{name: (whole parameter, whole Adam mu)} of a sharded state (every
    rank calls it; ``keep`` False drops the result)."""
    names = [n for n, _ in state.model.named_parameters()]
    out = {}
    for n, p, m, sh in zip(names, state.optimizer.params, state.optimizer.mu, state.layouts):
        whole = (sh.gather(p.detach()), sh.gather(m))
        if keep:
            out[n] = whole
    return out


def par2_hold(what, got, want, grad_norm, want_norm, bars) -> dict:
    """fp32 bars (``bars``: phase 12's for the dual encoder, phase 31's LM
    step bars for the LM) on loss, grad norm, gradients (Adam's mu) and
    the updated parameters, as relative L2."""
    import torch

    def cat(d, i):
        return torch.cat([d[n][i].float().flatten() for n in sorted(want["whole"])])

    rel = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "grad_norm": abs(grad_norm - want_norm) / want_norm}
    for key, i in (("grads", 1), ("params", 0)):
        a, b = cat(got["whole"], i), cat(want["whole"], i)
        rel[key] = float((a - b).norm() / b.norm())
    log(f"[parallel2] {what}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    for k, tol in bars.items():
        if not rel[k] <= tol:
            raise AssertionError(f"{what} {k}: {rel[k]:.3e} > {tol:g}")
    return rel


PAR2_GROUPS = (("router", "router"), ("experts", "experts"),
               ("nsa_compressed", "compressed"), ("nsa_topk", "topk"),
               ("nsa_importance", "importance"), ("nsa_gates", "gate_"),
               ("local_attention", "local_attention"), ("hyper_connections", "stream"),
               ("embeddings", "embed"), ("lm_head", "lm_head"))


def par2_per_parameter(what, got, want) -> dict:
    """Where the gradient (Adam's mu) differs from one rank's: each
    parameter's share of the whole squared difference (the 12 largest
    logged with their own relative L2, which is noise for a gradient near
    0, such as a softmax-invariant key bias), and the shares by group and
    by layer. A router, expert or NSA top-k choice that flips within fp32
    noise sits in one layer's tensors; a fault of the layout spreads across
    the split ones."""
    per, sq = {}, {}
    for n in sorted(want["whole"]):
        (gp, gm), (wp, wm) = got["whole"][n], want["whole"][n]
        d = float((gm.float() - wm.float()).norm())
        sq[n] = d ** 2
        per[n] = {"grads": d / max(float(wm.float().norm()), 1e-30),
                  "params": float((gp.float() - wp.float()).norm())
                  / max(float(wp.float().norm()), 1e-30)}
    total = sum(sq.values()) or 1.0
    for n in per:
        per[n]["share"] = sq[n] / total
    worst = sorted(per, key=lambda n: -sq[n])[:12]
    log(f"[parallel2] {what}: largest shares of the squared gradient difference (share, own "
        f"relative L2 of grads, params): " + "; ".join(
            f"{n} {per[n]['share']:.3f} {per[n]['grads']:.1e} {per[n]['params']:.1e}"
            for n in worst))
    groups, layers = Counter(), Counter()
    for n, v in per.items():
        groups[next((g for g, key in PAR2_GROUPS if key in n), "other")] += v["share"]
        layers[int(n.split(".")[1]) if n.startswith("layers.") else -1] += v["share"]
    log(f"[parallel2] {what}: shares by group: "
        + ", ".join(f"{g} {v:.3f}" for g, v in groups.most_common()))
    log(f"[parallel2] {what}: shares by layer (-1: outside the layers): "
        + ", ".join(f"{i} {v:.3f}" for i, v in sorted(layers.items())))
    return {"worst": {n: per[n] for n in worst}, "group_shares": dict(groups),
            "layer_shares": {str(i): v for i, v in sorted(layers.items())}}


def par2_forward_probe(model) -> tuple:
    """Hooks that keep, per decoder layer, the block's output streams, its
    router's top-k experts per token and its NSA global top-k keys per row
    (the first forward of the step): ({kind: {layer: tensor}}, handles)."""
    import torch

    from forde_tpu_torch.ops.moe_dispatch import top_k_desc

    cfg = model.config
    seen = {"out": {}, "router": {}, "topk": {}}
    handles = []
    for i, layer in enumerate(model.layers):
        def out_hook(module, args, out, i=i):
            x, streams, _ = out
            seen["out"].setdefault(i, (x if streams is None else streams).detach().float())
        handles.append(layer.register_forward_hook(out_hook))
        if cfg.use_moe:
            def router_hook(module, args, logits, i=i):
                idx = top_k_desc(logits.detach(), cfg.top_k_experts)[1]
                seen["router"].setdefault(i, torch.sort(idx, -1).values)
            handles.append(layer.moe.moe_layer.router.register_forward_hook(router_hook))
        if cfg.use_sparse_attention:
            def topk_hook(module, args, imp, i=i):
                k = min(cfg.top_k_global, imp.shape[1])
                seen["topk"].setdefault(i, torch.sort(top_k_desc(imp[..., 0].detach(), k)[1],
                                                      -1).values)
            handles.append(layer.sparse_attention.importance_scorer.register_forward_hook(
                topk_hook))
    return seen, handles


def par2_forward_flips(what, got, want) -> dict:
    """Per layer: tokens whose router top-k set differs from one rank's,
    rows whose NSA top-k set differs, the block output's relative L2 and
    the tokens whose own relative difference passes 1e-4, with the first
    layer and token that do. A choice flipped within fp32 noise shows as a
    count at one layer and tokens that jump from there on; a fault of the
    layout moves every token from its first layer."""
    per = {}
    first = None
    for i in sorted(want["out"]):
        a, b = got["out"][i], want["out"][i]
        tok = ((a - b).flatten(2).norm(dim=-1) / b.flatten(2).norm(dim=-1).clamp_min(1e-30))
        jumped = tok > 1e-4
        if first is None and bool(jumped.any()):
            row, t = [int(v) for v in jumped.nonzero()[0]]
            first = {"layer": i, "row": row, "token": t}
        per[i] = {"router_tokens": int((got["router"][i] != want["router"][i]).any(-1).sum())
                  if i in want["router"] else 0,
                  "topk_rows": int((got["topk"][i] != want["topk"][i]).any(-1).sum())
                  if i in want["topk"] else 0,
                  "out_rel_l2": float((a - b).norm() / b.norm()),
                  "tokens_past_1e-4": int(jumped.sum()), "tokens": int(jumped.numel())}
    log(f"[parallel2] {what}: per layer against one rank's forward (router tokens with "
        f"another top-k set / NSA rows with another top-k set / block output relative L2 / "
        f"tokens past 1e-4 of {per[0]['tokens']}): " + "; ".join(
            f"{i} {v['router_tokens']}/{v['topk_rows']}/{v['out_rel_l2']:.1e}/"
            f"{v['tokens_past_1e-4']}" for i, v in per.items())
        + f"; first token past 1e-4: {first}")
    return {"per_layer": per, "first_jump": first}


def par2_lm_case(device, base, weights, case, launches) -> dict:
    """One LM train step of ``case`` (PAR2_LM_CASES) on thread ranks
    against one rank's step on the same batch (for GPipe: the same
    microbatches, as pieces of one microbatch's data shard, their aux
    losses averaged, the pipeline's semantics)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.mesh import AXIS_DATA, AXIS_MODEL
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.parallel.pipeline import make_pp_train_step
    from forde_tpu_torch.train.state import create_train_state, shard_train_state
    from forde_tpu_torch.train.step import lm_batch as split_batch, lm_loss, train_step

    name, shape, rows, seq, param_sharding, micro = case
    cfg = base.replace(scan_layers=bool(micro))
    ids = lm_batch(rows, seq, cfg.vocab_size, device, SEED + 330)["input_ids"]

    probe = shape.get("model") == 4

    def run(mesh):
        model = FORDEDecoderLM(cfg, device=device, mesh=mesh)
        model.load_state_dict(weights)
        state = shard_train_state(create_train_state(cfg, None, 3e-4, 0.01, model=model),
                                  mesh, param_sharding)
        held = par2_state_bytes(state)
        keep = mesh.coords[AXIS_DATA] == mesh.coords[AXIS_MODEL] == 0
        seen, handles = par2_forward_probe(model) if probe and keep else (None, [])
        if micro:
            step = make_pp_train_step(mesh, micro, aux_loss_weight=0.01)
            state, m = step(state, split_batch(ids, mesh, micro))
        else:
            state, m = train_step(state, split_batch(ids, mesh), aux_loss_weight=0.01)
        for h in handles:
            h.remove()
        res = {"loss": float(m["loss/total"]), "grad_norm": float(m["training/grad_norm"]),
               "bytes": held, "whole": par2_whole(state, keep), "seen": seen}
        del state, model
        return res

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ranks = thread_ranks(shape, run)
    ranks_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for _, counts in ranks:
        for k, c in counts.items():
            launches[k] += c
    whole = {}
    for r, _ in ranks:
        whole.update(r["whole"])
    got = {"loss": ranks[0][0]["loss"], "whole": whole}
    got_seen = ranks[0][0]["seen"]
    grad_norm = ranks[0][0]["grad_norm"]
    per_rank = [c for _, c in ranks]
    rank_bytes = [r["bytes"] for r, _ in ranks]
    for r, _ in ranks:
        r["whole"] = r["seen"] = None
    del ranks, whole
    torch.cuda.empty_cache()

    model = FORDEDecoderLM(cfg, device=device)
    model.load_state_dict(weights)
    state = create_train_state(cfg, None, 3e-4, 0.01, model=model)
    replicated_bytes = par2_state_bytes(state)
    if micro:
        data = shape.get("data", 1)
        mb = rows // micro
        pieces = [ids[m * mb:(m + 1) * mb][d * (mb // data):(d + 1) * (mb // data)]
                  for m in range(micro) for d in range(data)]
        params = state.optimizer.params
        grads = [torch.zeros_like(p) for p in params]
        lm_sum, aux_sum = 0.0, 0.0
        for piece in pieces:
            logits, aux = state.model(piece, update_stats=True)
            lm = lm_loss(logits, piece)
            g = torch.autograd.grad((lm + 0.01 * aux) / len(pieces), params,
                                    materialize_grads=True)
            torch._foreach_add_(grads, g)
            lm_sum, aux_sum = lm_sum + float(lm.detach()), aux_sum + float(aux.detach())
            del logits, aux, lm, g
        want_norm = float(state.optimizer.step(grads))
        want_loss = (lm_sum + 0.01 * aux_sum) / len(pieces)
    else:
        want_seen, handles = par2_forward_probe(state.model) if probe else (None, [])
        state, m = train_step(state, {"input_ids": ids}, aux_loss_weight=0.01)
        for h in handles:
            h.remove()
        want_norm, want_loss = float(m["training/grad_norm"]), float(m["loss/total"])
    names = [n for n, _ in state.model.named_parameters()]
    want = {"loss": want_loss, "whole": {n: (p.detach(), m) for n, p, m in zip(
        names, state.optimizer.params, state.optimizer.mu)}}
    torch.cuda.synchronize()
    kernels.reset_launches()
    what = (f"LM step {name} ({rows} x {seq}, {param_sharding}"
            + (f", {micro} microbatches" if micro else "") + ")")
    per_parameter = None
    if probe:
        per_parameter = par2_per_parameter(what, got, want)
        per_parameter["forward"] = par2_forward_flips(what, got_seen, want_seen)
        del got_seen, want_seen
    rel = par2_hold(what, got, want, grad_norm, want_norm,
                    {**LM_PARITY_TOL_FP32, "grad_norm": LM_PARITY_TOL_FP32["loss"]})
    del state, model, want, got
    torch.cuda.empty_cache()
    for key in PAR2_TRAINING_KERNELS:
        if not all(c.get(key) for c in per_rank):
            raise AssertionError(f"LM step {name}: a rank launched no {key}")
    log(f"[parallel2] LM step {name}: launches per rank "
        + "; ".join(str({k: c.get(k, 0) for k in PAR2_TRAINING_KERNELS}) for c in per_rank)
        + f"; {ranks_s:.1f} s for the ranks, peak {peak:.2f} GiB; parameter + moment bytes "
        f"per rank {[round(b / 2 ** 20, 1) for b in rank_bytes]} MiB against "
        f"{replicated_bytes / 2 ** 20:.1f} MiB replicated "
        f"({max(rank_bytes) / replicated_bytes:.3f} of it)")
    return {"relative_l2": rel, "launches_per_rank": per_rank, "seconds": ranks_s,
            "peak_gib": peak, "state_bytes_per_rank": rank_bytes,
            "state_bytes_replicated": replicated_bytes,
            **({"per_parameter": per_parameter} if per_parameter else {})}


# (d)'s discriminating check of its act_stats: a binary-step (specialist)
# unit whose z sits within fp32 noise of 0 steps the other way on the ranks
# than on one rank, and its output moves by a whole unit, which every later
# layer of its tower sees. The layers that no such flip reaches (each
# tower's layers up to and including its first with a flip) are held at
# this relative L2; the layers after it are logged.
PAR2_UNREACHED_ACT_STATS = 1e-5


def par2_binary_steps(model) -> tuple:
    """Hooks that keep, per StatefulLayer, z > 0 of its first forward in
    the step (a recomputing backward calls it again): ({name: bool}, the
    hooks' handles)."""
    from forde_tpu_torch.nn.stateful import stateful_layers

    steps, handles = {}, []
    for name, layer in stateful_layers(model).items():
        def hook(module, args, z, name=name):
            steps.setdefault(name, z.detach() > 0)
        handles.append(layer.w_in.register_forward_hook(hook))
    return steps, handles


def par2_flips(got_steps, want_steps, want_stats, got_stats, assignments) -> dict:
    """Per layer the specialist units (and their tokens) whose binary step
    differs from one rank's; each tower's layers up to its first with a
    flip held at PAR2_UNREACHED_ACT_STATS."""
    import torch

    from forde_tpu_torch.ops.stateful import SPECIALIST

    per = {}
    for n in want_steps:
        spec = assignments[n] == SPECIALIST
        diff = (got_steps[n] != want_steps[n]) & spec
        a, b = got_stats[n], want_stats[n]
        per[n] = {"units": int(diff.flatten(0, -2).any(0).sum()), "tokens": int(diff.sum()),
                  "act_stats": float((a - b).norm() / b.norm())}
    held = {}
    for tower in ("vision", "text"):
        names = sorted((n for n in per if n.startswith(f"{tower}.")),
                       key=lambda n: int(re.findall(r"\d+", n)[0]))
        for n in names:
            held[n] = per[n]["act_stats"]
            if per[n]["units"]:
                break
    log("[parallel2] dual encoder binary steps against one rank, per layer (specialist units "
        "that flip, their tokens, act_stats relative L2): "
        + "; ".join(f"{n} {v['units']}/{v['tokens']}/{v['act_stats']:.2e}"
                    for n, v in per.items()))
    worst = max(held.values())
    log(f"[parallel2] dual encoder act_stats of the {len(held)} layers no flip reaches: worst "
        f"relative L2 {worst:.3e} (bar {PAR2_UNREACHED_ACT_STATS:g}); "
        f"{sum(v['units'] for v in per.values())} specialist units flip in all")
    if not held or not worst <= PAR2_UNREACHED_ACT_STATS:
        raise AssertionError(f"dual encoder act_stats before any flipped binary step: "
                             f"{worst:.3e} > {PAR2_UNREACHED_ACT_STATS:g}")
    return {"per_layer": per, "unreached_worst": worst, "unreached_layers": sorted(held)}


def par2_clip(device, launches) -> dict:
    """(d): one sensed fp32 vit_b16 step at batch 128 over data 2 x model
    2 with fsdp against one rank's, to phase 12's fp32 bars: loss, grad
    norm, gradients, parameters, and the all-gathered act_stats against
    the one-rank buffers (each layer's relative L2); then the flipped
    binary steps (``par2_flips``)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy, vit_b16_config
    from forde_tpu_torch.core.mesh import AXIS_DATA, AXIS_MODEL, Sharding, shard_batch
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.train.clip_step import clip_train_step
    from forde_tpu_torch.train.state import shard_train_state

    cfg = vit_b16_config().replace(dtypes=DTypePolicy.fp32())
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, PAR2_CLIP_BATCH, device, SEED + 331)
    shape = {"data": 2, "model": 2}

    def stats(state):
        return {n: layer.act_stats.clone() for n, layer in stateful_layers(state.model).items()}

    def run(mesh):
        state = train_state(cfg, weights, device, moment_dtype=None)
        shard_train_state(state, mesh, "fsdp")
        held = par2_state_bytes(state)
        steps, handles = par2_binary_steps(state.model)
        state, m = clip_train_step(state, shard_batch(batch, mesh))
        for h in handles:
            h.remove()
        keep = mesh.coords[AXIS_DATA] == mesh.coords[AXIS_MODEL] == 0
        # rows over data, hidden columns over model: the whole (B, S, F)
        whole = Sharding(mesh, (AXIS_DATA, None, AXIS_MODEL))
        steps = {n: whole.gather(t.to(torch.uint8)).bool() for n, t in sorted(steps.items())}
        return {"loss": float(m["loss/contrastive"]), "grad_norm": float(m["training/grad_norm"]),
                "bytes": held, "act_stats": stats(state), "whole": par2_whole(state, keep),
                "steps": steps if keep else None}

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = thread_ranks(shape, run)
    ranks_s = time.perf_counter() - t0
    for _, counts in ranks:
        for k, c in counts.items():
            launches[k] += c
    per_rank = [c for _, c in ranks]
    state = train_state(cfg, weights, device, moment_dtype=None)
    replicated_bytes = par2_state_bytes(state)
    want_steps, handles = par2_binary_steps(state.model)
    state, m = clip_train_step(state, batch)
    for h in handles:
        h.remove()
    torch.cuda.synchronize()
    kernels.reset_launches()
    names = [n for n, _ in state.model.named_parameters()]
    want = {"loss": float(m["loss/contrastive"]), "whole": {n: (p.detach(), mu) for n, p, mu in zip(
        names, state.optimizer.params, state.optimizer.mu)}}
    got = {"loss": ranks[0][0]["loss"], "whole": ranks[0][0]["whole"]}
    want_stats = stats(state)
    worst, rel_l2 = 0.0, 0.0
    for r, _ in ranks:
        for n, t in r["act_stats"].items():
            worst = max(worst, float((t - want_stats[n]).abs().max() / want_stats[n].abs().max()))
            rel_l2 = max(rel_l2, float((t - want_stats[n]).norm() / want_stats[n].norm()))
    bar = PARITY_TOL["fp32"]["act_stats"]
    log(f"[parallel2] dual encoder act_stats, all-gathered, against one rank: worst layer's "
        f"relative L2 {rel_l2:.3e} (bar {bar:g}), worst |d| / the buffer's max {worst:.3e}")
    if not rel_l2 <= bar:
        raise AssertionError(f"dual encoder act_stats: {rel_l2:.3e} > {bar:g}")
    rank0 = next(r for r, _ in ranks if r["steps"] is not None)
    flips = par2_flips(rank0["steps"], want_steps, want_stats, rank0["act_stats"],
                       {n: layer.neuron_assignments for n, layer in
                        stateful_layers(state.model).items()})
    for r, _ in ranks:
        r["steps"] = None
    del want_steps
    fp32 = {k: v for k, v in PARITY_TOL["fp32"].items() if k in ("loss", "grad_norm", "grads",
                                                                "params")}
    rel = par2_hold("dual encoder vit_b16 step (data 2 x model 2, fsdp, batch 128)", got, want,
                    ranks[0][0]["grad_norm"], float(m["training/grad_norm"]), fp32)
    log("[parallel2] dual encoder launches per rank "
        + "; ".join(str({k: c.get(k, 0) for k in ("flash_mha_fwd", "flash_mha_bwd",
                                                    "moment_sums")}) for c in per_rank)
        + f"; {ranks_s:.1f} s; parameter + moment bytes per rank "
        f"{max(r['bytes'] for r, _ in ranks) / replicated_bytes:.3f} of replicated")
    for key in ("flash_mha_fwd", "flash_mha_bwd", "moment_sums"):
        if not all(c.get(key) for c in per_rank):
            raise AssertionError(f"dual encoder step: a rank launched no {key}")
    del state, ranks
    torch.cuda.empty_cache()
    return {"relative_l2": {**rel, "act_stats": rel_l2}, "act_stats_worst_of_max": worst,
            "binary_step_flips": flips, "launches_per_rank": per_rank,
            "seconds": ranks_s}


# (e)'s readings. Greedy decoding over model 2 against one rank: fp32 and
# the dense-causal int8 model exact (every int8 product's int32 sums are
# exact over the ranks, and its fp parts are replicated), the NSA int8
# model a share (its fp NSA branches add partial sums in another order, and
# an int8 activation that rounds the other way changes the rest of its row).
# Teacher forcing takes that cascade away: one forward of the TP model over
# each prompt and one rank's tokens, its argmax at the new positions against
# the one-rank model's on the same sequence, held at this share for fp32 and
# dense int8. For NSA int8 the share is held against a control: the one-rank
# model with every floating-point parameter moved by fp32 noise (relative
# 2^-23), the size of the noise the ranks' partial sums add. int8 turns such
# noise into whole rounding steps, which spread through the layers, so the
# share of such a control is far below 1; the ranks must reach this much of
# it.
PAR2_TEACHER_FORCED = 0.95
PAR2_TEACHER_FORCED_OF_CONTROL = 0.9
PAR2_CONTROL_NOISE = 2.0 ** -23
# The dense-causal int8 model's new tokens (one rank's graphed decode and
# the teacher-forced positions): half of SERVE_NEW_TOKENS.
PAR2_DENSE_NEW_TOKENS = 16
# The ranks' eager decode: PAR2_EAGER_NEW_TOKENS new tokens on the first
# PAR2_EAGER_PROMPTS prompts, held against the first ones of one rank's. An
# eager forward on two thread ranks takes 0.3-0.4 s, so the whole
# SERVE_NEW_TOKENS on the 8 prompts took 80-100 s a model. The
# teacher-forced agreement still reads every position one rank decoded.
PAR2_EAGER_NEW_TOKENS = 8
PAR2_EAGER_PROMPTS = 2


def par2_serving(device, launches) -> dict:
    """(e): generate_cached over model 2, greedy, eager (the thread
    transport cannot be captured in a CUDA graph), on the first
    PAR2_EAGER_PROMPTS prompts of SERVE_PROMPT_LENS with
    PAR2_EAGER_NEW_TOKENS each, against the first tokens of one rank's
    graphed decode of SERVE_NEW_TOKENS on all 8
    (PAR2_DENSE_NEW_TOKENS for the dense-causal int8 model; its tokens are
    its eager decode's, phase 17): fp32 (NSA) and int8 dense-causal tokens
    exactly one rank's; int8 NSA the share of tokens that match; each
    row's first differing position; each rank's int8 arrays exactly its
    slices of one rank's; and the teacher-forced argmax agreement
    (PAR2_TEACHER_FORCED) at every position one rank decoded."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_cached
    from forde_tpu_torch.ops.quant import quantize_params
    from forde_tpu_torch.train.state import shard_model

    def build(cfg, weights, quantized):
        model = FORDEDecoderLM(cfg, device=device)
        model.load_state_dict(weights)
        model.eval()
        return quantize_params(model) if quantized else model

    out = {}
    for label, cfg, quantized, new in (
        ("fp32", serve_config(), False, SERVE_NEW_TOKENS),
        ("int8", serve_config(), True, SERVE_NEW_TOKENS),
        ("int8_dense", dense_serve_config(), True, PAR2_DENSE_NEW_TOKENS),
    ):
        cfg = cfg.replace(dtypes=DTypePolicy.fp32())
        weights = lm_weights(cfg, device)
        prompts = [torch.tensor([p], device=device) for p in serve_prompts(cfg.vocab_size)]

        def decode(model, graphed, prompts=prompts, new=new):
            with torch.no_grad():
                return [generate_cached(model, p, None, max_new_tokens=new,
                                        temperature=0.0, cuda_graph=graphed)[0, p.shape[1]:]
                        .tolist() for p in prompts]

        def forced(model, seqs, prompts=prompts):
            """Argmax at each new position of one forward over prompt +
            one rank's tokens."""
            with torch.no_grad():
                return [model(torch.cat([p, torch.tensor([s], device=device)], 1))[0]
                        [0, p.shape[1] - 1:-1].argmax(-1).tolist()
                        for p, s in zip(prompts, seqs)]

        one_model = build(cfg, weights, quantized)
        whole = {n: p.detach() for n, p in one_model.named_parameters()}
        t0 = time.perf_counter()
        one = decode(one_model, True)  # graphed: the same tokens as eager (phase 17)
        one_s = time.perf_counter() - t0
        one_forced = forced(one_model, one)
        control = build(cfg, weights, quantized)
        gen = torch.Generator(device=device).manual_seed(SEED + 332)
        with torch.no_grad():
            for t in control.parameters():
                if t.is_floating_point():
                    t.mul_(1.0 + PAR2_CONTROL_NOISE * torch.randn(t.shape, device=device,
                                                                  generator=gen))
        control_forced = forced(control, one)
        del control
        torch.cuda.synchronize()
        kernels.reset_launches()

        def run(mesh, cfg=cfg, weights=weights, quantized=quantized, whole=whole, one=one):
            model = build(cfg, weights, quantized)
            layouts, _ = shard_model(model, mesh)
            own = dict(model.named_parameters())
            for n, sh in layouts.items():
                if sh.axes and not torch.equal(own[n], sh(whole[n])):
                    raise AssertionError(f"TP serving {n}: a rank's slice differs")
            t0 = time.perf_counter()
            toks = decode(model, False, prompts[:PAR2_EAGER_PROMPTS], PAR2_EAGER_NEW_TOKENS)
            secs = time.perf_counter() - t0
            return toks, secs, forced(model, one)

        ranks = thread_ranks({"model": 2}, run)
        for _, counts in ranks:
            for k, c in counts.items():
                launches[k] += c
        got, secs, got_forced = ranks[0][0]
        one_head = [w[:PAR2_EAGER_NEW_TOKENS] for w in one[:PAR2_EAGER_PROMPTS]]
        same = [a == b for g, w in zip(got, one_head) for a, b in zip(g, w)]
        share = sum(same) / len(same)
        first = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
                 for g, w in zip(got, one_head)]
        def agreement(a_rows, b_rows):
            hits = [a == b for g, w in zip(a_rows, b_rows) for a, b in zip(g, w)]
            return sum(hits) / len(hits)

        forced_share = agreement(got_forced, one_forced)
        control_share = agreement(control_forced, one_forced)
        bar = (PAR2_TEACHER_FORCED_OF_CONTROL * control_share if label == "int8"
               else PAR2_TEACHER_FORCED)
        log(f"[parallel2] TP serving {label} over model 2 (eager): {share:.4f} of "
            f"{len(same)} greedy tokens equal one rank's; each row's first differing new "
            f"position {first}; teacher-forced argmax agreement over "
            f"{sum(map(len, one))} positions {forced_share:.4f} (bar "
            f"{bar:.4f}; the control, one rank with fp32 noise in its weights: "
            f"{control_share:.4f}); {secs:.1f} s for {PAR2_EAGER_NEW_TOKENS} new tokens on "
            f"{len(got)} prompts against {one_s:.1f} s for {new} on {len(one)} on one rank "
            f"(graphed); launches per rank "
            + "; ".join(str(dict(c)) for _, c in ranks))
        if label != "int8" and got != one_head:
            raise AssertionError(f"TP serving {label}: tokens differ from one rank's")
        if ranks[1][0][0] != got:
            raise AssertionError(f"TP serving {label}: the ranks' tokens differ")
        if not forced_share >= bar:
            raise AssertionError(f"TP serving {label}: teacher-forced argmax agreement "
                                 f"{forced_share:.4f} < {bar:.4f}")
        out[label] = {"token_share": share, "first_differing": first,
                      "teacher_forced_agreement": forced_share,
                      "control_agreement": control_share, "seconds_tp": secs,
                      "seconds_one": one_s, "launches_per_rank": [c for _, c in ranks]}
        del one_model, whole, ranks, weights
        torch.cuda.empty_cache()
    return out


def phase_parallel_2(device) -> dict:
    """Phase 32: tensor parallelism, FSDP and the GPipe pipeline on thread
    ranks of one process on the one card (one card's times and memory,
    not a multi-GPU machine's): the LM steps of PAR2_LM_CASES, the dual
    encoder's sensed step, and tensor-parallel serving. Returns the
    launches of the thread ranks (the references' are not counted)."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy

    launches: Counter = Counter()
    secs, cases = {}, {}
    base = serve_config().replace(dtypes=DTypePolicy.fp32(), moe_capacity_factor=PAR_LM_FACTOR,
                                  moe_dispatch="capacity", num_layers=PAR_LM_LAYERS)
    weights = lm_weights(base, device)
    for case in PAR2_LM_CASES:
        t0 = time.perf_counter()
        cases[case[0]] = par2_lm_case(device, base, weights, case, launches)
        secs[case[0]] = time.perf_counter() - t0
    del weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clip = par2_clip(device, launches)
    secs["clip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = par2_serving(device, launches)
    secs["serving"] = time.perf_counter() - t0
    log("[parallel2] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    log(f"[parallel2] launches of the thread ranks: {dict(launches)}")
    return {"launches": dict(launches), "lm": cases, "clip": clip, "serving": serving,
            "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 33: the benchmark drivers (forde_tpu_torch/bench.py and
# forde_tpu_torch/benchmarks/*.py), each main called in-process on the card
# at reduced counts; their full-size runs are separate calls (README).
# ---------------------------------------------------------------------------

# bench.py: 4 timed steps a preset (16 at the headline's stride 8: the
# reference's max(steps, 2 * stride)), the fused sense 8 x 8 run once
# (its 24 steps: 3 replays after the capture; the full-size run's 32 x 32
# took 96).
BENCH_SMOKE_ENV = {"BENCH_STEPS": "4", "BENCH_SCAN_REPS": "1", "BENCH_SCAN_EXTRA": "8",
                   "BENCH_SCAN_STRIDE": "8"}
BENCH_DECODER_STEPS = 2
# serving_bench at the reference-default decoder's widths (ISSUE: the same
# flags as the full-size runs), 4 requests, with its open-loop arrivals.
SERVING_BENCH_FLAGS = ["--d_model", "512", "--num_layers", "12", "--num_heads", "8",
                       "--num_experts", "8", "--max_seq_len", "2048", "--bf16"]
SERVING_BENCH_SMOKE = ["--requests", "4", "--load_rate", "4"]
QUANT_SMOKE = ["--new", "16", "--reps", "1"]
SCALING_SMOKE = ["--new", "16"]
# The kernels each driver's timed sections must launch. Dense-causal cached
# generation (serving_bench without --nsa, quant_decode at its defaults)
# prefills and decodes through the cache's plain masked attention
# (nn/attention.py CausalSelfAttention.decode), as the JAX package's does:
# no kernel is on those paths.
BENCH_PATH_KERNELS = {
    "bench": ("flash_mha_fwd", "flash_mha_bwd", "moment_sums"),
    "bench_decoder": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_kv_fwd",
                      "small_kv_bwd"),
    "bench_serving": ("flash_fwd", "small_kv_fwd", "topk_replay"),
    "bench_serving_dense": (),
    "bench_quant": (),
    "bench_scaling": ("flash_fwd", "small_kv_fwd", "topk_replay"),
}
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


@contextlib.contextmanager
def environ(**env):
    """os.environ with ``env`` set, as it was after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sum_launches(tree) -> Counter:
    """The launch counts of a driver's ``extra["launches"]`` (per run,
    mode or length; lists of runs), summed by kernel."""
    total = Counter()
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, int):
            total[k] += v
        else:
            total.update(sum_launches(v))
    return total


def drive_benchmark(name, run) -> dict:
    """``run()`` (a driver's main) with its standard output echoed and its
    last line held: one JSON object of bench.py's keys, a finite positive
    value, and launches of every kernel of BENCH_PATH_KERNELS[name]."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            run()
    finally:
        out = buf.getvalue().strip().splitlines()
        for line in out:
            log(f"[benchmarks] {name}: {line}")
    secs = time.perf_counter() - t0
    line = json.loads(out[-1])
    if set(line) != BENCH_LINE_KEYS:
        raise AssertionError(f"{name}: last line keys {sorted(line)}")
    value = line["value"]
    if not (isinstance(value, (int, float)) and np.isfinite(value) and value > 0):
        raise AssertionError(f"{name}: value {value!r}")
    extra = line["extra"]
    if line["vs_baseline"] is not None or not all(k in extra for k in ("card", "peak_gib",
                                                                        "launches")):
        raise AssertionError(f"{name}: vs_baseline or extra's card, peak_gib, launches")
    launched = sum_launches(extra["launches"])
    missing = [k for k in BENCH_PATH_KERNELS[name] if not launched.get(k)]
    log(f"[benchmarks] {name}: {secs:.1f} s; launches of its timed sections {dict(launched)}")
    if missing:
        raise AssertionError(f"{name}: no launch of {missing} in its timed sections")
    torch.cuda.empty_cache()
    return {"line": line, "launches": dict(launched), "seconds": secs}


def int8_padding_cost(device) -> dict:
    """What ``int8_matmul``'s padding costs a batch-1 decode step of
    quant_decode's model (d 512, 12 layers, dense FFN 2,048, vocabulary
    50,257): per QDense shape, by CUDA events, ``int8_dense`` on one row
    (quantize, pad to 17 rows, ``torch._int_mm``, rescale), ``int8_matmul``
    on one int8 row (pad + product), ``torch._int_mm`` on a row block
    padded ahead of time, and the bf16 model's ``F.linear`` of one row;
    then each summed over one step's calls."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    shapes = {"qkv_proj": (512, 1536, 12), "out_proj": (512, 512, 12),
              "ffn_up": (512, 2048, 12), "ffn_down": (2048, 512, 12),
              "lm_head": (512, 50257, 1)}
    per, step = {}, Counter()
    for name, (k, n, calls) in shapes.items():
        w = torch.randn(k, n, device=device, generator=gen) * k ** -0.5
        wq, scale = quant.quantize_weight(w)
        # QDense's layout: weight_q (n, k) row-major, read through its
        # transpose (torch._int_mm takes no (k, n) row-major view of an N
        # that is not a multiple of 8, the lm_head's 50,257)
        wq = wq.t().contiguous().t()
        wt = w.t().contiguous().to(torch.bfloat16)
        x = torch.randn(1, k, device=device, generator=gen, dtype=torch.bfloat16)
        xq, _ = quant.quantize_activations(x)
        padded = F.pad(xq, (0, 0, 0, quant._MIN_ROWS - 1))
        n_main = n - n % quant._ALIGN
        ms = {
            "int8_dense": cuda_ms([lambda: quant.int8_dense(x, wq, scale, None, torch.bfloat16)]),
            "int8_matmul": cuda_ms([lambda: quant.int8_matmul(xq, wq)]),
            "int_mm_prepadded": cuda_ms([lambda: torch._int_mm(padded, wq[:, :n_main])]),
            "bf16_linear": cuda_ms([lambda: F.linear(x, wt)]),
        }
        per[name] = ms
        for key, v in ms.items():
            step[key] += v * calls
    step["padding"] = step["int8_matmul"] - step["int_mm_prepadded"]
    log("[benchmarks] int8 at batch 1, ms per call (int8_dense / int8_matmul / _int_mm "
        "pre-padded / bf16 linear): " + "; ".join(
            f"{n} " + " / ".join(f"{v:.4f}" for v in ms.values()) for n, ms in per.items()))
    log("[benchmarks] int8 at batch 1, ms per decode step (12 layers + lm_head): "
        + ", ".join(f"{k} {v:.4f}" for k, v in step.items()))
    return {"per_call_ms": per, "per_step_ms": dict(step)}


# small_kv_fwd's fp32 route, (name, B, H, S, K, keys): decode_scaling's
# decode step (4 heads of 64, the default config's ratio 4: the compressed
# pools at 2,048 positions, 512, and at 16,384, 4,096), the default serve's
# decode in fp32 (8 rows of 8 heads: its 256 pools and 64 kept rows, and
# one row's pools) and its prefill's two calls (S = 2,048: 192 pools, 64
# selected). A decode step splits the keys over many blocks; a prefill's
# query tiles fill the card alone.
LONG_KEYS_TIMING = [
    ("decode_pools_s1_k512_fp32", 1, 4, 1, 512, "decode_pools"),
    ("decode_pools_s1_k4096_fp32", 1, 4, 1, 4096, "decode_pools"),
    ("serve_decode_pools_s1_k256_fp32", 8, 8, 1, 256, "decode_pools"),
    ("serve_decode_topk_s1_k64_fp32", 8, 8, 1, 64, "decode_topk"),
    ("serve_decode_pools_b1_s1_k256_fp32", 1, 8, 1, 256, "decode_pools"),
    ("prefill_pools_s2048_k192_fp32", 8, 8, 2048, 192, "pools"),
    ("prefill_topk_s2048_k64_fp32", 8, 8, 2048, 64, "topk"),
]


def long_keys_timing(device) -> dict:
    """Per call of small_kv_fwd at LONG_KEYS_TIMING (fp32): kernel, plain
    version, SDPA with the same mask (a yardstick only) and the bound."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import nsa_attention as nsa

    gen = torch.Generator(device=device).manual_seed(SEED + 34)
    out = {}
    d = 64
    for name, b, h, s, kk, kind in LONG_KEYS_TIMING:
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        copies = max(2, -(-200_000_000 // ((b * h * s * d + 2 * b * h * kk * d) * 4)))
        inputs = [(torch.randn(b, h, s, d, device=device, generator=gen),
                   *(torch.randn(b, h, kk, d, device=device, generator=gen) for _ in range(2)))
                  for _ in range(copies)]
        qpos = torch.arange(s, device=device)[None, None, :, None]
        kpos = key_pos[:, None, None, :]
        add = torch.where(qpos >= kpos, 0.0, nsa.NEG_BIG)
        add = torch.where(kpos >= nsa.INVALID_KEY_POS, -float("inf"), add)
        scale = d ** -0.5
        with torch.inference_mode():
            t = time_kernel(
                f"small_kv_fwd {name} (B={b}, H={h}, S={s}, K={kk}, D={d}, fp32)",
                [lambda i=i: nsa.small_kv_fwd(*i, key_pos, scale) for i in inputs],
                [lambda i=i: nsa.small_kv_fwd_reference(*i, key_pos, scale) for i in inputs],
                [lambda i=i: F.scaled_dot_product_attention(*i, attn_mask=add, scale=scale)
                 for i in inputs],
                *small_kv_bound(inputs[0][0], inputs[0][1], key_pos, "float32"),
                B=b, H=h, S=s, K=kk, D=d)
        out[name] = {**t, "dtype": "float32"}
        del inputs, add
        torch.cuda.empty_cache()
    return out


def phase_benchmarks(device) -> dict:
    """Phase 33: the tiny_hd128 step against its plain version (phase 6's
    check, fp32 at its bars; bf16 against the plain fp32 step, within its
    bars or as precise as the plain bf16 path: PARITY_TOL["bf16"] sits
    between vit_b16_hd128's readings, and at tiny_hd128 the plain bf16
    path's own grad_norm reads 1.2e-2 from fp32, where the kernel path's
    reads 1.7e-4), then each driver's
    main in-process at reduced counts: bench.main, decoder.main,
    serving_bench.main twice (NSA, window 512; dense with its prefix mode),
    quant_decode.main, decode_scaling.main; each last line held
    (drive_benchmark); int8_matmul's padding at batch 1; small_kv_fwd's
    fp32 route at LONG_KEYS_TIMING."""
    from forde_tpu_torch import bench
    from forde_tpu_torch.benchmarks import decode_scaling, decoder, quant_decode, serving_bench
    from forde_tpu_torch.core.config import DTypePolicy

    tiny = bench.preset_config("tiny_hd128").replace(dtypes=DTypePolicy.bf16())
    parity = phase_step_parity(device, tiny, "bench", bf16_as_precise=True)
    runs = {}
    with environ(**BENCH_SMOKE_ENV):
        runs["bench"] = drive_benchmark("bench", lambda: bench.main(device="cuda"))
    runs["bench_decoder"] = drive_benchmark(
        "bench_decoder", lambda: decoder.main([], steps=BENCH_DECODER_STEPS))
    runs["bench_serving"] = drive_benchmark("bench_serving", lambda: serving_bench.main(
        SERVING_BENCH_FLAGS + SERVING_BENCH_SMOKE + ["--nsa", "--nsa_window", "512"]))
    runs["bench_serving_dense"] = drive_benchmark("bench_serving_dense", lambda: serving_bench.main(
        SERVING_BENCH_FLAGS + SERVING_BENCH_SMOKE))
    runs["bench_quant"] = drive_benchmark("bench_quant", lambda: quant_decode.main(QUANT_SMOKE))
    runs["bench_scaling"] = drive_benchmark(
        "bench_scaling", lambda: decode_scaling.main(SCALING_SMOKE))
    padding = int8_padding_cost(device)
    long_keys = long_keys_timing(device)
    launches = {name: r["launches"] for name, r in runs.items()}
    launches["bench_serving"] = dict(Counter(launches["bench_serving"])
                                     + Counter(launches.pop("bench_serving_dense")))
    return {"launches": launches, "lines": {n: r["line"] for n, r in runs.items()},
            "seconds": {n: r["seconds"] for n, r in runs.items()},
            "tiny_hd128_step_parity": parity, "int8_padding": padding,
            "small_kv_fwd_long_keys": long_keys}


# Phase 34: a train state written on the CPU resumed on the card, as a
# converted JAX run is (scripts/orbax_to_npz.py --train_state writes the
# same files): the Forde-lite tiny preset (vit_tiny_config: ViT-Ti/16 at
# 224 px, vision 12 x (3 heads x 64), text 2 x (3 x 64)) in fp32, batch 16,
# dummy data, sensing every step. RESUME_FIRST steps on the CPU end in a
# checkpoint; RESUME_STEPS more from it on the card and, for reference, on
# the CPU, with a Forde-lite update at step 4 that reads the statistics of
# steps 1-2 carried in the checkpoint. The control: the same CPU run from
# the checkpoint with every parameter moved by fp32 noise (relative 2^-23).
# Bars, card against CPU (kernels against their plain versions): the
# losses of steps 3-4 within PARITY_TOL["fp32"]'s loss (phases 6 and 16).
# After the update a third of the units are binary steps, which turn fp32
# noise in a pre-activation near 0 into a whole unit of change (phase 6's
# note), and the control alone reads past phase 6's bars there (in the
# first run: step 6's loss 2.9e-3, Adam's first moment 0.119 relative L2,
# on an H100): the losses of steps 5-6, the final parameters and Adam's
# moments (its grads bar) within phase 6's bar or RESUME_OF_CONTROL x the
# control's reading, whichever is larger (phase 33's rule for bf16). The
# neuron assignments after the update: a unit whose Forde-lite statistic
# sits within fp32 noise of a threshold may take the other class, so the
# count of units that differ is at most RESUME_FLIPS_OF_CONTROL x the
# control's count, or that many units where the control's count is 0.
RESUME_FIRST = 2
RESUME_STEPS = 4
RESUME_UPDATE_AT = 4  # the Forde-lite update, after this step
RESUME_ARGV = ["--preset", "tiny", "--forde_lite", "--use_dummy_data", "--batch_size", "16",
               "--sense_interval", "1", "--slow_loop_interval", str(RESUME_UPDATE_AT),
               "--log_interval", "1", "--seed", str(SEED)]
RESUME_FLIPS_OF_CONTROL = 4
RESUME_OF_CONTROL = 1.5
RESUME_CONTROL_NOISE = 2.0 ** -23


def resume_run(workdir, name, num_steps, ckpt_dir, *extra) -> dict:
    """clip_loop.main on RESUME_ARGV for ``num_steps`` with ``ckpt_dir``;
    its return, seconds and per-step losses (its metrics.jsonl)."""
    import glob

    from forde_tpu_torch.train import clip_loop

    argv = RESUME_ARGV + ["--num_steps", str(num_steps), "--checkpoint_dir", ckpt_dir,
                          "--experiment_name", f"resume_{name}", *extra]
    cwd = os.getcwd()
    os.chdir(workdir)  # the loop's metrics land in ./runs
    try:
        t0 = time.perf_counter()
        out = clip_loop.main(argv)
        out["seconds"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    (path,) = glob.glob(os.path.join(workdir, "runs", f"resume_{name}_*", "metrics.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    out["losses"] = {r["step"]: r["value"] for r in rows if r["tag"] == "loss/contrastive"}
    return out


def resume_readings(state) -> dict:
    """The final parameters, Adam's moments (flat fp32, on the host) and
    the neuron assignments of a clip train state."""
    import torch

    from forde_tpu_torch.nn.stateful import stateful_layers

    opt = state.optimizer

    def cat(ts):
        return torch.cat([t.detach().flatten().float().cpu() for t in ts])

    return {"params": cat(opt.params), "mu": cat(opt.mu), "nu": cat(opt.nu),
            "assignments": torch.cat([layer.neuron_assignments.flatten().cpu() for layer in
                                      stateful_layers(state.model).values()])}


def phase_resume(device, workdir) -> dict:
    """Phase 34: clip_loop --device cpu for RESUME_FIRST steps and a
    checkpoint; the checkpoint restored onto the card bit for bit; clip_loop
    --resume on the card for RESUME_STEPS steps through a Forde-lite update,
    with exact launches; the same on the CPU, and the control; the card's
    sensed step time, its busy time and idle share, its launches."""
    import shutil

    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.train import checkpoint as ckpt
    from forde_tpu_torch.train import clip_loop
    from forde_tpu_torch.train.clip_step import clip_train_step, create_clip_train_state

    cfg = clip_loop.config_from_args(clip_loop.build_parser().parse_args(RESUME_ARGV))
    last = RESUME_FIRST + RESUME_STEPS
    first_dir = os.path.join(workdir, "resume_first")
    first = resume_run(workdir, "first", RESUME_FIRST, first_dir, "--device", "cpu")
    if first["step"] != RESUME_FIRST or first["brain_updates"]:
        raise AssertionError(f"resume: the CPU run took {first['step']} steps, brain updates "
                             f"{first['brain_updates']}")

    # The CPU's files restored onto the card: every tensor bit for bit.
    state = create_clip_train_state(cfg, None, 1e-4, 0.01, device=device)
    ckpt.restore_train_state(first_dir, state)
    saved = {**ckpt.read_npz(os.path.join(first_dir, ckpt.PARAMS_FILENAME)),
             **ckpt.read_npz(os.path.join(first_dir, ckpt.OPT_STATE_FILENAME))}
    params_t, extra_t = ckpt._state_tensors(state)
    tensors = {k: ckpt._to_numpy(t, tr) for k, (t, tr) in {**params_t, **extra_t}.items()}
    differ = sorted(k for k, v in tensors.items() if not np.array_equal(v, saved[k]))
    if differ or state.step != RESUME_FIRST:
        raise AssertionError(f"resume: restored on the card, step {state.step}, differ {differ}")
    del state, params_t, extra_t, tensors

    dirs = {}
    for name in ("card", "cpu", "control"):
        dirs[name] = os.path.join(workdir, f"resume_{name}")
        shutil.copytree(first_dir, dirs[name])
    params_path = os.path.join(dirs["control"], ckpt.PARAMS_FILENAME)
    arrays = ckpt.read_npz(params_path)
    rng = np.random.RandomState(SEED + 35)
    for k, v in arrays.items():
        if k.startswith("params/") and v.dtype == np.float32:
            arrays[k] = (v * (1.0 + RESUME_CONTROL_NOISE * rng.randn(*v.shape))).astype(np.float32)
    np.savez(params_path, **arrays)

    kernels.reset_launches()
    card = resume_run(workdir, "card", last, dirs["card"], "--resume")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    cpu = resume_run(workdir, "cpu", last, dirs["cpu"], "--device", "cpu", "--resume")
    control = resume_run(workdir, "control", last, dirs["control"], "--device", "cpu", "--resume")
    steps = list(range(RESUME_FIRST + 1, last + 1))
    for name, run in (("card", card), ("cpu", cpu), ("control", control)):
        updates = [(u["step"], u["skipped"], u["sensed_steps_before"])
                   for u in run["brain_updates"]]
        layers = cfg.vision.num_layers + cfg.text.num_layers
        if (run["step"] != last or sorted(run["losses"]) != steps
                or updates != [(RESUME_UPDATE_AT, False, RESUME_UPDATE_AT * layers)]):
            raise AssertionError(f"resume {name}: step {run['step']}, logged steps "
                                 f"{sorted(run['losses'])}, brain updates {updates}")
    per_step = launches_per_step(cfg, True)
    want = {k: RESUME_STEPS * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"resume: launches on the card {launches}, expected {want}")

    got, ref, noise = (resume_readings(r["state"]) for r in (card, cpu, control))

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    loss_rel = {t: abs(card["losses"][t] - cpu["losses"][t]) / abs(cpu["losses"][t])
                for t in steps}
    readings = {k: rel(got[k], ref[k]) for k in ("params", "mu", "nu")}
    control_readings = {k: rel(noise[k], ref[k]) for k in ("params", "mu", "nu")}
    control_loss = {t: abs(control["losses"][t] - cpu["losses"][t]) / abs(cpu["losses"][t])
                    for t in steps}
    flips = int((got["assignments"] != ref["assignments"]).sum())
    control_flips = int((noise["assignments"] != ref["assignments"]).sum())
    units = got["assignments"].numel()
    flip_bar = RESUME_FLIPS_OF_CONTROL * max(control_flips, 1)
    tol = PARITY_TOL["fp32"]
    loss_bars = {t: tol["loss"] if t <= RESUME_UPDATE_AT
                 else max(tol["loss"], RESUME_OF_CONTROL * control_loss[t]) for t in steps}
    bars = {k: max(tol["params" if k == "params" else "grads"],
                   RESUME_OF_CONTROL * control_readings[k]) for k in readings}

    # The card's sensed step at this width, from the resumed state.
    batch = training_batch(cfg, 16, device, SEED + 36)
    step_state = card["state"]
    kernels.reset_launches()
    clip_train_step(step_state, batch)
    torch.cuda.synchronize()
    one_step = dict(kernels.launches)
    ms = median_step_ms(step_state, clip_train_step, batch)
    prof = profile_device(lambda: clip_train_step(step_state, batch),
                          "resume: vit_tiny fp32 sensed step, batch 16")
    if not prof["busy_ms"] > 0:
        log("[resume] the profiler read no device time: busy time and idle share not measured")
        prof.update(busy_ms=None, idle_share=None)
    log(f"[resume] clip_loop --preset tiny (fp32, batch 16, sensing every step, Forde-lite): "
        f"{RESUME_FIRST} CPU steps ({first['seconds']:.1f} s) -> checkpoint restored on the "
        f"card bit for bit -> {RESUME_STEPS} steps on the card ({card['seconds']:.1f} s, "
        f"launches {launches}), on the CPU ({cpu['seconds']:.1f} s) and the control "
        f"({control['seconds']:.1f} s)")
    log("[resume] card vs CPU: loss relative difference per step "
        + ", ".join(f"{t} {v:.3e} (bar {loss_bars[t]:.3e})" for t, v in loss_rel.items())
        + "; relative L2 "
        + ", ".join(f"{k} {v:.3e} (bar {bars[k]:.3e})" for k, v in readings.items())
        + f"; units assigned otherwise after the update at {RESUME_UPDATE_AT}: {flips} of "
        f"{units} (bar {flip_bar})")
    log("[resume] control, the CPU run with fp32 noise in its parameters, vs CPU: loss "
        + ", ".join(f"{t} {v:.3e}" for t, v in control_loss.items()) + "; relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in control_readings.items())
        + f"; units assigned otherwise {control_flips}")
    busy = ("not measured" if prof["busy_ms"] is None else
            f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}")
    log(f"[resume] card: sensed step {ms:.3f} ms (median of 5), device busy {busy}; "
        f"launches per step {one_step}")
    if one_step != per_step:
        raise AssertionError(f"resume: launches of one step {one_step}, expected {per_step}")
    for t, v in loss_rel.items():
        if not v <= loss_bars[t]:
            raise AssertionError(f"resume: step {t} loss, card vs CPU {v:.3e} > "
                                 f"{loss_bars[t]:.3e}")
    for k, v in readings.items():
        if not v <= bars[k]:
            raise AssertionError(f"resume: {k}, card vs CPU {v:.3e} > {bars[k]:.3e}")
    if not flips <= flip_bar:
        raise AssertionError(f"resume: {flips} units assigned otherwise on the card, "
                             f"bar {flip_bar} (control {control_flips})")
    return {"launches": launches, "launches_per_step": one_step, "step_ms": ms,
            "loss_bars": loss_bars, "bars": bars,
            "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"],
            "idle_share": prof["idle_share"], "loss_rel": loss_rel, "rel_l2": readings,
            "control_loss_rel": control_loss, "control_rel_l2": control_readings,
            "assignment_flips": flips, "control_flips": control_flips, "units": units,
            "seconds": {"first_cpu": first["seconds"], "card": card["seconds"],
                        "cpu": cpu["seconds"], "control": control["seconds"]}}


# The run's start (main sets it) and, past STACKS_AFTER_S of it, every
# thread's stack on stderr: a run that nears the time limit then says where
# it is, as a run cut at the limit shows only the end of its stderr.
RUN_START = time.perf_counter()
STACKS_AFTER_S = 1000


def timed(phase, *args):
    """phase(*args), its wall time and the run's so far logged; its name on
    stderr as it starts."""
    print(f"chip_smoke: {phase.__name__} at {time.perf_counter() - RUN_START:.0f} s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = phase(*args)
    now = time.perf_counter()
    log(f"[phase] {phase.__name__}: {now - t0:.1f} s (run {now - RUN_START:.1f} s)")
    return out


def main() -> int:
    global RUN_START
    import faulthandler

    import torch

    RUN_START = time.perf_counter()
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "forde_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    timed(phase_build)
    max_err = dict(zip(("flash_mha_fwd", "flash_mha_bwd"), timed(phase_check_attention, device)))
    max_err["moment_sums"] = timed(phase_check_moments, device)
    max_err.update(timed(phase_check_serving_kernels, device))
    max_err.update(timed(phase_check_training_kernels, device))
    topk = timed(phase_topk_replay, device)
    max_err["topk_replay"] = topk["max_abs_err"]

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as workdir:
        # phase 34 first: its profile of one step is the run's first (a
        # profiler session after a large one may read no device time)
        resume = timed(phase_resume, device, workdir)
        main_run = timed(phase_main_path, device, workdir)
        train_run = timed(phase_train_path, workdir)
        fused_run = timed(phase_train_fused_cli, workdir)
        serve_run = timed(phase_serve_path, device, workdir)
        lm_run = timed(phase_train_lm_path, device, workdir)
        long_run = timed(phase_long_lm_path, workdir)
        cli_extras = timed(phase_cli_extras, device, workdir)
    check_prefetch(device)
    parity = timed(phase_step_parity, device)
    timing = timed(phase_encode_timing, device, main_run["model"], main_run["cfg"])
    shapes = timed(phase_kernel_timing, device, main_run["cfg"], timing["encode_ms"])
    train_timing = timed(phase_train_timing, device)
    train_timing_fp32 = timed(fp32_step_timing, device)
    fused_steps = timed(phase_fused_steps, device)
    serve_parity = timed(phase_serve_parity, device, serve_run["state"])
    decode_graph = timed(phase_decode_graph, device, serve_run["state"], serve_parity)
    serve_timing = timed(phase_serve_timing, device, serve_run["state"])
    serve_long = timed(phase_serve_long, device)
    prefix = timed(phase_prefix, device)
    beam = timed(phase_beam, device, serve_run["state"])
    full = timed(phase_full_recompute, device, serve_run["state"])
    speculative = timed(phase_speculative, device)
    int8 = timed(phase_int8, device, serve_run["state"], serve_parity)
    pool = timed(phase_pool, device, serve_run["state"])
    http = timed(phase_http, device)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as workdir:
        lm_extras = timed(phase_lm_extras, device, workdir)
        clip_extras = timed(phase_clip_extras, device, workdir)
        remat = timed(phase_remat, device, workdir)
        observe = timed(phase_observe, device, workdir)
    shapes.update(timed(phase_serving_kernel_timing, device))
    shapes["topk_replay"] = topk["shapes"]
    lm_parity = timed(phase_lm_step_parity, device)
    lm_timing = timed(phase_lm_train_timing, device)
    lm_timing_fp32 = timed(lm_fp32_step_timing, device)
    shapes.update(timed(phase_training_kernel_timing, device))
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as workdir:
        parallel = timed(phase_parallel, device, workdir)
    parallel_2 = timed(phase_parallel_2, device)
    benchmarks = timed(phase_benchmarks, device)

    def by_path(name):
        return {"embed": main_run["launches"].get(name, 0),
                "train": train_run["launches"].get(name, 0),
                "train_fused": fused_run["launches"].get(name, 0),
                "serve": serve_run["launches"].get(name, 0),
                "serve_s8192": serve_long["launches"].get(name, 0),
                "train_lm": lm_run["launches"].get(name, 0),
                "train_lm_s8192": long_run["launches"].get(name, 0),
                "serve_prefix": prefix["launches"].get(name, 0),
                "serve_beam": beam["launches"].get(name, 0),
                "generate_full": full["launches"].get(name, 0),
                "serve_speculative": speculative["launches"].get(name, 0),
                "serve_int8": int8["launches"].get(name, 0),
                "pool": pool["launches"].get(name, 0),
                "http": http["launches"].get(name, 0),
                "lm_extras": lm_extras["launches"].get(name, 0),
                "clip_extras": clip_extras["launches"].get(name, 0),
                "remat": remat["launches"].get(name, 0),
                "observe": observe["launches"].get(name, 0),
                "parallel": parallel["launches"].get(name, 0),
                "parallel_2": parallel_2["launches"].get(name, 0),
                "resume": resume["launches"].get(name, 0),
                **{path: benchmarks["launches"][path].get(name, 0)
                   for path in ("bench", "bench_decoder", "bench_serving", "bench_quant",
                                "bench_scaling")}}

    entries = []
    for name, replaces in (
        ("flash_mha_fwd", "forde_tpu/ops/flash_attention.py:992"),
        ("flash_mha_bwd", "forde_tpu/ops/flash_attention.py:1036"),
        ("moment_sums", "forde_tpu/ops/stat_sums.py:28"),
    ):
        v, t = shapes[name]["vision"], shapes[name]["text"]
        bound_ms, bound_by = bound(
            v["bytes_ms"] + t["bytes_ms"], v["operations_ms"] + t["operations_ms"]
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            # The training path's run (phase 5); the other paths' below.
            "launches": train_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            # One call at the vision shape plus one at the text shape (a
            # layer of each tower at batch 128); "shapes" has each alone.
            "ms": v["ms"] + t["ms"],
            "plain_ms": v["plain_ms"] + t["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if v["library_ms"] is None else v["library_ms"] + t["library_ms"],
            "shapes": shapes[name],
        })
    # The serving path's kernels: flash_fwd at the serving prefill (one
    # launch per layer), small_kv_fwd at one prefill layer's two launches
    # (compressed pools and top-k); "shapes" has the streaming S and the
    # decode shapes.
    for name, replaces, also, parts in (
        ("flash_fwd", "forde_tpu/ops/flash_attention.py:98",
         "forde_tpu/ops/flash_attention.py:428", ("serve_prefill_s2048_window512",)),
        ("small_kv_fwd", "forde_tpu/ops/nsa_attention.py:115", None,
         ("prefill_pools_s2048_k192", "prefill_topk_s2048_k64")),
    ):
        ts = [shapes[name][part] for part in parts]
        bound_ms, bound_by = bound(sum(t["bytes_ms"] for t in ts),
                                   sum(t["operations_ms"] for t in ts))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": serve_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            "ms": sum(t["ms"] for t in ts),
            "plain_ms": sum(t["plain_ms"] for t in ts),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(t["library_ms"] for t in ts),
            "shapes": shapes[name],
        })
    # The LM training path's kernels: the 4-D backward at the training
    # step's shape (one launch of each per layer), small_kv_bwd at one step
    # layer's two launches; "shapes" has the streaming S = 8192 and K = 960.
    # SDPA's backward computes dq, dk and dv in one call: both 4-D kernels
    # carry its time as library_ms.
    for name, replaces, also, parts in (
        ("flash_bwd_dq", "forde_tpu/ops/flash_attention.py:201",
         "forde_tpu/ops/flash_attention.py:481", ("train_s2048_window512",)),
        ("flash_bwd_dkv", "forde_tpu/ops/flash_attention.py:250",
         "forde_tpu/ops/flash_attention.py:528", ("train_s2048_window512",)),
        ("small_kv_bwd", "forde_tpu/ops/nsa_attention.py:126", None,
         ("train_pools_s2048_k192", "train_topk_s2048_k64")),
    ):
        ts = [shapes[name][part] for part in parts]
        bound_ms, bound_by = bound(sum(t["bytes_ms"] for t in ts),
                                   sum(t["operations_ms"] for t in ts))
        source = "flash_bwd" if name.startswith("flash_bwd") else name
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": lm_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            "ms": sum(t["ms"] for t in ts),
            "plain_ms": sum(t["plain_ms"] for t in ts),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(t["library_ms"] for t in ts),
            "shapes": shapes[name],
        })
    # The prefill's top-k replay (the port of a lax.scan, not of a Pallas
    # kernel): one launch per prefill, at the serving prefill's shape.
    t = shapes["topk_replay"]["serve_prefill_n96_p2048_ragged"]
    entries.append({
        "name": "topk_replay",
        "route": "cuda",
        "source": "forde_tpu_torch/csrc/topk_replay.cu",
        "replaces": "forde_tpu/models/generate.py:566",
        "launches": serve_run["launches"].get("topk_replay", 0),
        "launches_by_path": by_path("topk_replay"),
        "max_abs_err": max_err["topk_replay"],
        "index_mismatches": topk["index_mismatches"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "shapes": shapes["topk_replay"],
    })
    result = {
        "kernels": entries,
        "encode_ms_batch128": timing["encode_ms"],
        "plain_encode_ms_batch128": timing["plain_encode_ms"],
        "pairs_per_s": timing["pairs_per_s"],
        "min_cosine_vs_plain": {
            k: main_run[f"min_cosine_{k}"] for k in ("fp32", "bf16", "plain_bf16_vs_fp32")
        },
        "train_path": {k: train_run[k] for k in ("seconds", "final_loss", "brain_update_ms")},
        "train_step_batch128": train_timing,
        "train_step_batch128_fp32": train_timing_fp32,
        "step_parity": parity,
        "serve_path": {"seconds": serve_run["seconds"], "launches": serve_run["launches"],
                       "launches_sampled": serve_run["launches_sampled"]},
        "serve_batch8": serve_timing,
        "serve_parity": serve_parity,
        "train_lm_path": {k: lm_run[k] for k in
                          ("seconds", "final_loss", "peak_gib", "brain_update_ms")},
        "train_lm_s8192": {k: long_run[k] for k in ("seconds", "loss", "peak_gib")},
        "train_lm_step_8x2048": lm_timing,
        "train_lm_step_fp32": lm_timing_fp32,
        "train_lm_step_parity": lm_parity,
        "train_fused_path": {k: fused_run[k] for k in ("seconds", "final_loss")},
        "fused_steps_batch128": fused_steps,
        "decode_graph": decode_graph,
        "serve_s8192": {k: serve_long[k] for k in ("seconds_graph", "seconds_eager")},
        "prefix": prefix,
        "beam": beam,
        "full_recompute": full,
        "speculative": speculative,
        "int8": int8,
        "cli_extras": cli_extras,
        "pool": pool,
        "http": {k: v for k, v in http.items() if k != "launches"},
        "lm_extras": {k: v for k, v in lm_extras.items() if k != "launches"},
        "clip_extras": {k: v for k, v in clip_extras.items() if k != "launches"},
        "remat": {k: v for k, v in remat.items() if k != "launches"},
        "observe": {k: v for k, v in observe.items() if k != "launches"},
        "parallel": {k: v for k, v in parallel.items() if k != "launches"},
        "parallel_2": {k: v for k, v in parallel_2.items() if k != "launches"},
        "benchmarks": benchmarks["lines"],
        "resume": {k: v for k, v in resume.items() if k != "launches"},
        "benchmarks_phase": {k: v for k, v in benchmarks.items()
                             if k not in ("launches", "lines")},
        "card": smi,
    }
    faulthandler.cancel_dump_traceback_later()
    log(f"[run] {time.perf_counter() - RUN_START:.1f} s")
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
