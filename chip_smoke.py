#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(printing each kernel's ptxas registers, static shared memory and
spills; K6's tensor-core kernel, K9's six instantiations and the scan's
backward at 4 and 8 lanes must spill nothing, and the backward's
occupancy), holds each kernel
against its plain PyTorch version at the shapes the serving and training
paths give it (K1 and K6 also at falcon-mamba-7b's in_proj and out_proj,
every K6 shape on the tensor-core route with the same bits on a second
call and its device time from the profiler, and the tensor-core routes
of K1, K6 and K7 also at ragged shapes; K9 at each of its shapes the same
bits on a second call, with a sweep of its lane count and its device
time; K1 with its epilogue, the norm assembly that replaced K2's launch
on the main paths, at every K1 shape and on both of K1's routes, within
1e-6 of max |w_norm| of K1's terms → the plain Gram row sum → K2's plain
version, bitwise the same with the Gram sum in the epilogue's lane order,
the same bits twice, and the per-module norm timed against the chain it
replaced), printing each row's achieved GB/s beside its bound and library
time, and prints each wrapper's host time per call at a small shape
beside one PyTorch op's (``index_select``), then serves full-width qwen2-7b
(28 layers, random weights from a seed) with r=384 DoRA adapters on all
seven projections through ``repro_torch.launch.serve.generate``:

  1. auto mode in bf16 (the main path): precompute, padded prefill of
     4 x 1024, 32 decode tokens; the kernel launch counts must be
     K1 = 196, every one ending in its epilogue (K2's assembly,
     ``assembled`` = 196), K2 = 0, K6 = 140, K3 = 0, every K6 launch on
     the tensor-core route (as on the training and Mamba main paths, 5
     and M1);
  2. forced kernel mode (``mode="fused"``), a few decode tokens: K6 = 196
     per prefill and K3 = 196 per decode token;
  3. the paper's criterion, prefill logit cosine >= 0.9999, between the
     kernel route and an explicitly requested eager route, and between
     forced and auto mode, on the same weights upcast to fp32 (see
     serve_checks for why not in bf16); in bf16 the kernel route must be
     no further from the fp32 logits than the bf16 eager route;
  4. a 2-layer fp32 model served on the card and on the CPU (the kernels'
     plain versions), whose prefill logits must agree within
     1e-4 x max|logit| and whose greedy tokens must match.

Then the continuous-batching engine (``repro_torch.launch.engine``) on
the same bf16 weights cut to their first ENGINE_LAYERS = 8 layers (views;
the engine, speculative, fault and FL2 phases are host-bound, and every
count they hold is derived from the depth L), with one folded serving
tree (g and g·s·B):

  E1. the engine's main path: the precompute and the paged engine (8
      slots, max_len 2048, blocks of 16, chunks of 256, 512 blocks) over
      24 requests with prompts uniform in 256-1024 and 64 new tokens,
      exponential arrivals of mean 3 ticks; K1 = assembled = 7 x L and
      K8 = 2 x L per decode and chunk step (2 x 8 x 305 = 4,880),
      nothing else; the pool
      drains;
  E2. the same engine with the plain gather: the same greedy streams,
      bitwise, and no kernel launched;
  E3. the committed ``BENCH_serve.json`` traces: the rectangular engine's
      and the paged engine's counters equal ``continuous.engine_model``
      and ``paged.schedule_model`` (peak 13 blocks, pool drained), and K8
      launches exactly 2 x 28 x (35 + 18) = 2,968 times;
  E4. paged == rectangular greedy streams in fp32 at 4 layers over the
      committed paged trace, and a 2-layer fp32 engine on the card and on
      the CPU with the same streams.

Then speculative decoding (k = 3) and the fault plan in the engine (see
spec_checks and fault_checks):

  S1. in fp32 at 2 layers, the committed ``speculative`` trace,
      rectangular and paged: identity adapters (B = 0, m the precompute's
      own norm, so g == 1 exactly) give the counters of
      ``speculative_model`` (45 drafts, 15 verifies, 63 accepted); the
      perturbed adapters with the ladder (floor 0.99, window 2, re-enable
      2) disable and re-enable it; the streams equal the plain engine's;
  S2. in bf16 at full width on E1's 8 layers, the realistic trace on its
      paged geometry: K1 = assembled = 7 x L (the precompute), K8 = 2 x L x
      (chunk + decode + draft + verify steps), nothing else; every
      request its 64 tokens, the pool drained, three drafts a verify;
      printed beside E1's plain run: the accept rate, ticks, ms a tick,
      tokens/s, the verify's 19.5 MB logits fetch, and the share of
      requests whose tokens equal the plain run's;
  F1. in bf16 at full width on 8 layers, the paged engine over the first 8
      requests of the realistic trace with 16 new tokens, clean and under
      a plan of a one-row NaN, an all-rows NaN, a 0.05 s slow tick, a
      stale and an evict event: the reference's containment (each request
      finishes once, no slot or block leaks, unaffected streams equal,
      affected ones a prefix) and the fault counters.

Then, on the same weights, multi-tenant serving (see serve_mt_checks):

  T1. three r=384 tenants (each perturbed from its own seed) in one batch
      of 6 (two rows each, interleaved; rows 0-2 share a prompt), prompt
      960 padded to 1024, 32 greedy tokens, through ``MultiTenantServer``
      over an ``AdapterStateCache``: a cold call (3 misses, K1 =
      assembled = 3 x 196 = 588, nothing else) and a warm call (3 hits,
      no kernel at all: the grouped prefill and decode launch no K1, K3
      or K6), the same tokens both times and pairwise different on the
      shared prompt; the single-tenant cached + gsB baseline at batch 6;
  T2. the host tier (two states on the card, three on the host): a spill,
      a reload bitwise leaf for leaf, reload ms against precompute ms;
  T3. in fp32 at 2 layers: the mixed batch against each tenant served
      alone by ``generate`` (equal tokens, logits within 1e-5 of max),
      w_gate's grouped delta bitwise the homogeneous gsB path's at the
      decode and prefill shapes, the dynamic grouping within 1e-6 of max
      of the static one at [6, 1, 3584];
  T4. the ``--tenants 3`` CLI at full width (K1 = 588).

Then fleet grouping and tracing in the engine (see fleet_parity and
fleet_checks):

  FL1. in fp32 at 2 layers, five perturbed tenants: the committed
       ``fleet`` trace through the dynamic and the static cache-routed
       engine, counters equal to ``fleet.schedule_model``, the static
       engine's four ``signature_keys`` and the dynamic one's
       ``"dynamic"``, equal streams, logits within 1e-5 of max, K1 =
       assembled = 14 a cache miss; dynamic + speculative (k = 3) + paged
       equal to static plain; the committed ``obs`` trace traced and
       untraced alike, its latencies ``obs.lifecycle_model`` exactly from
       136 events; ``MultiTenantServer.serve`` of six mixed-length
       requests (prompts 700-960) over three tenants through the engine,
       each equal to the request served alone; a tiered cache of two
       states whose spill and reload land on the engine's trace;
  FL2. in bf16 at full width on 8 layers, nine r=384 tenants (the memory
       reckoning printed first says why not twelve) through E1's paged
       geometry and trace, each request's tenant from its own stream, a
       cache of six states and no host tier, two slots an adapter at
       most, traced: the dynamic engine, then the static one (a fresh
       cache); K1 = assembled = 7 x L x the misses, K8 = 2 x L x (chunk +
       decode steps), nothing else, the dynamic decode under
       ``"dynamic"`` alone, stack inserts <= admissions, every request
       its 64 tokens, the trace complete (24 submitted, 24 terminal, 0
       dropped); printed: ms a tick and decode ms beside E1's, tokens/s,
       peak memory, the cache's counters, a profiled dynamic tick's idle
       share, lifecycle percentiles and the share of requests whose
       dynamic stream equals the static one.

Then it trains the same bf16 weights (the serving cache freed) through
``repro_torch.launch.steps.make_train_step``: batch 2 x seq 2048, loss on
the last 1024 tokens, layer remat, AdamW defaults:

  5. auto mode, 3 steps (the training main path): per step
     K1 = assembled = 196, K6 = 280 (the layers' forward and their
     recompute), K7 = 140 and no element-wise compose kernel; the loss
     finite, the gradient norm finite and non-zero;
  6. the element-wise route (``compose_matmul_fused=False``, the route of
     every rank that pads above 512), 3 steps: per step K4 = 280,
     K5 = 140, K6 = K7 = 0;
  7. the three routes (5, 6 and eager) one step each on the same weights
     upcast to fp32 at full width and 4 layers: losses within 1e-5
     relative, each kernel route's adapter gradient at cosine >= 0.99999
     with eager's;
  8. a 2-layer fp32 model trained 2 steps on the card and on the CPU, on
     both compose routes: losses and adapters within 1e-4 x max|value|.

With qwen2-7b's state freed, it drives the serve CLI's engine paths
in-process through ``repro_torch.launch.serve.main`` at qwen2-7b's full
width and depth, 8 slots, prompts of 512-1024 and 16 new tokens (see
cli_checks): ``--continuous --paged``; ``--continuous --speculative 3``
with ``--trace-out``/``--metrics-out`` (both files parsed, no event
dropped); ``--continuous --inject nan@3:1,slow@4 --deadline 40
--priority 1``; ``--fleet N`` with N from a memory reckoning printed
first. Each: K1 = assembled = 196 a tenant, K8 on the paged path alone,
the CLI's own checks, and its streams against the plain counterpart's
(asserted by the CLI in fp32, counted here in bf16).

Then it serves full-width falcon-mamba-7b (64 Mamba-1 layers, random
weights from a seed) with r=384 DoRA on in_proj and out_proj (see
mamba_checks):

  M1. auto mode in bf16 (the Mamba main path): precompute, exact-length
      prefill of 4 x 960, 32 greedy tokens; K1 = assembled = 128,
      K6 = 128, K9 = 64 and nothing else (decode launches no kernel);
  M2. kernel route (K6 + K9) vs eager route on the fp32 upcast at 4
      layers: prefill logit cosine >= 0.9999, final state h within
      1e-4 x max|h|, equal greedy tokens;
  M3. a 2-layer fp32 model on the card and on the CPU: prefill logits
      within 1e-4 x max|logit|, equal greedy tokens.

and trains it (see mamba_train_checks; the kernel phase has held K9 with
chunk states and the scan's backward against their plain versions at the
training shape [2, 2048, 8192] and a ragged one, same bits twice):

  MT1. auto mode in bf16, batch 2 x seq 2048, loss on the last 1024,
      layer remat, AdamW, 3 steps: per step K1 = assembled = 128,
      K6 = 256, K7 = 128, K9 = 128 (with chunk states) and the scan's
      backward = 64, nothing else; step ms, tokens/s, peak memory (the
      reckoning printed first) and a profiled step's idle share;
  MT2. kernel route vs eager route on the fp32 upcast at 4 layers: loss
      within 1e-5 relative, adapter-gradient cosine >= 0.99999.

Then the rest of the dense family (see vl_checks and arch_checks), after
the kernel phase has held K1 with its epilogue at each of the 27 weight
shapes of ARCH_K1_SHAPES and K6 and K7 at 4096 rows x each of the 11
d_out of ARCH_MM_N (arch_kernel_checks; K3 also
gets its device time there):

  V1-V4. qwen2-vl-7b, the paper's backbone, at full width and depth:
      3 training steps from bf16 patch embeddings with exactly
      K1 = assembled = 196, K6 = 280, K7 = 140 a step; the routes in fp32
      at 2 layers from embeddings; ``generate`` with K1 = 196, K6 = 140;
      an embeddings prefill, kernel vs eager route in fp32 at full depth;
  A1-A6. phi4-mini-3.8b, chatglm3-6b, musicgen-medium, qwen3-32b,
      qwen2-vl-72b and llama4-scout-17b-a16e (MoE, 12 of 48 layers) at
      their published widths, depth cut as ARCH_DEPTH says (printed),
      served with the launch counts the port's dispatch plans give,
      kernel vs eager route in fp32 at 4 layers (for the MoE arch with its
      dropped share at prefill and its routing flips between the routes).

Last, the MoE stack (see moe_checks): qwen2-moe-a2.7b at full width and
depth (24 layers, 60 experts top-4 and a shared expert), r=384 DoRA on
the attention and the shared expert:

  MoE1. ``generate`` as the dense archs: K1 = assembled = 168, K6 = 48,
      nothing at decode; the dropped share per layer at prefill, a
      profiled decode step's idle share;
  MoE2. 3 train steps as qwen2-7b's: K1 = assembled = 168, K6 = 96,
      K7 = 48 a step; a profiled step by MoE function; each layer's
      recompute routes bitwise as its forward;
  MoE3. one layer routed twice the same; kernel vs eager route in fp32
      at 4 layers, trained and served, with the routing flips counted.

Then the hybrid (see jamba_checks): jamba-v0.1-52b at full width on 16
of its 32 layers (two 8-layer units: seven Mamba-1 layers, NoPE
attention at index 4, a dense MLP on even layers and 16 experts top-2 on
odd ones), r=384 DoRA on the 30 modules a unit that the reference adapts:

  J1. ``generate`` with an exact-length prefill of 4 x 960 and 32 tokens:
      K1 = assembled = 60, K6 = 56, K9 = 14, nothing at decode; the
      dropped share per MoE layer, profiled prefill and decode steps;
  J2. 3 train steps as qwen2-7b's (at 16 layers when the memory
      reckoning printed first allows, else at one unit): K1 = assembled
      = 60, K6 = 112, K7 = 56, K9 = 28, the scan's backward 14 a step; a
      profiled step; each MoE layer's recompute routes bitwise;
  J3. the first unit in fp32 (cut and upcast leaf by leaf after the bf16
      model): kernel vs eager route, trained and served, with the routing
      flips counted.

Between the kernel phase and serving, the train step, single-tenant
serving, the continuous-batching engine, tenant groups, dynamic grouping
and speculation across a (data, model) mesh
(see mesh_kernel_checks and mesh_checks), as ranks that share this card
(``torch.multiprocessing`` spawn, gloo on ``cuda:0``, collectives built
on ``all_reduce``); this measures no multi-card speed:

  D1. K1's terms (no epilogue) and the standalone K2 on wo's and
      w_down's d_in shards at model = 2, K1 with its epilogue on wq's,
      wk's and w_gate's local rows at model = 2 ([1792 | 256 | 9472,
      3584]), K6 and K7 at the column-parallel local shapes [4096, 9472]
      and [4096, 1792] and the row-parallel prefill rows [2048, 3584]:
      each against its plain version, the same bits twice, K6 on the
      tensor cores; K8 at D5's local views [4, 1024, 2, 128], [2, 1024,
      4, 128] and [2, 1024, 2, 128], bitwise, timed beside
      ``index_select``;
  D2. qwen2-7b at full width on its first AGREE_LAYERS = 4 layers, batch
      2 x 2048, loss on the last 1024, 3 AdamW steps in bf16 on the
      meshes (data 1, model 2), (2, 1) and (2, 2) (2, 2 and 4 ranks):
      per rank and step the launch counts of ``mesh_counts`` exactly (K1
      with its epilogue on the column-parallel modules, K1's terms and the
      standalone K2 on wo and w_down at model = 2, with its epilogue on
      every module at model = 1), every K6 on the tensor cores, the
      norm's sums 8 x (2 x 14,336 + 589,824) = 4,947,968 B at model = 2
      (printed beside the 322,961,408 B that gathering the other halves
      of wo and w_down would move), the same loss on every rank; printed:
      step ms and peak memory by rank, the collectives' calls and bytes;
  D3. the same meshes in fp32: the sharded step's loss within 1e-5
      relative and its gathered adapter gradients at cosine >= 0.99999 of
      the unsharded port's on the card, and each adapter leaf within 1e-4
      of its max;
  D4. in the same ranks, ``generate(mesh=)`` of the same 4 layers, r =
      384, on 4 x 960 prompts padded to 1024 plus 32 tokens (the mesh
      precompute, the sequence-parallel padded prefill, the
      tensor-parallel decode): per rank the launch counts of
      ``mesh_serve_counts`` exactly (K1 = 28: with its epilogue on the 20
      column-parallel modules, terms only and the standalone K2 on the 8
      wo and w_down at model = 2, with its epilogue on all 28 at model =
      1; K6 = 20 at model 2 and data 1, else 8), every K6 on
      the tensor cores, each decode step's collective bytes by tag
      exactly ``mesh_decode_bytes``, the whole token matrix on every
      rank; the bf16 prefill logits within twice the unsharded bf16
      route's own distance (1 - cosine) from the fp32 logits of the same
      weights, both from the unsharded bf16 logits (each data replica's
      rows served as their own batch) and from the fp32 logits (the
      cosine against 0.9999 and the bf16 noise floor printed); in fp32
      the gathered g and every step's logits within 1e-5 of max of the
      unsharded port's, each step's top-2 gap at least 2e-5 of max
      |logit| and the tokens equal; printed: precompute, prefill and
      decode-step ms, peak memory by rank;
  D5. in the same ranks, on the same weights, ``DecodeEngine(mesh=)``
      with 4 slots of 1024 positions on 8 requests (one every 2 ticks,
      prompts of 64-768 tokens, 16 new tokens each), rectangular and
      paged (blocks of 16, chunks of 256, a pool of 72 blocks that forces
      a preemption), each from its own mesh precompute: per rank the
      launch counts of ``mesh_engine_counts`` exactly (K1 = 28 split as
      in D4, K6 by the plans, K8 = 2 x 4 x (chunk + decode steps) on the
      paged engine and 0 on the rectangular one), every K6 on the tensor
      cores, each decode step's collective bytes by tag exactly
      ``mesh_decode_bytes`` (the engine's data gather "engine.logits"),
      ``stats()``, ``device_steps()`` and ``pool_stats()`` those of the
      unsharded engine on the same trace, the streams those of rank 0; on
      (2, 2) ``EngineServer(mesh=)`` serving the same requests with the
      streams of the paged engine given them at once; in fp32 on the
      first 4 requests with 8 new tokens, paged == rectangular streams
      on every rank, and on (2, 2) both engines' fetched logits within
      1e-5 of max |logit| of the unsharded port's, each top-2 gap at
      least 2e-5 and the tokens equal; printed: ms a tick, decode-step,
      chunk and prefill-into-slot ms, decode bytes a step by tag, peak
      memory and D5's seconds by rank;
  D6. in the same ranks, static tenant groups: serve_mt's three r = 384
      tenants (this rank's shards, each state from a fresh
      ``AdapterStateCache.for_serving(mesh=)``) on the same model.
      ``MultiTenantServer(mesh=)`` cold then warm on 6 requests of 960
      tokens with interleaved owners (padded to 1024, 32 new): per rank
      launches exactly ``mesh_tenant_counts`` cold (3 x K1 = 28 split
      as in D4, K6 = 0: the grouped compose is the plain fp32 h·gsBᵀ) and
      none warm, each decode step's collective bytes by tag the
      single-tenant step's at batch 6, 3 misses then 3 hits, the same
      tokens warm, on every rank, and pairwise different on the shared
      prompt; ``DecodeEngine(mesh=)`` rectangular and paged on D5's
      geometry and trace with the requests spread over the tenants:
      launches of ``mesh_tenant_counts`` (K8 as in D5, K6 = 0), D5's
      decode bytes, D5's unsharded engine's schedule, rank 0's streams,
      a grouped signature; on (2, 2) ``EngineServer(mesh=)`` with the
      paged engine's streams; in fp32 paged == rectangular on every
      rank, the server's every step's logits within 5e-6 of max |logit|
      of one card's grouped run (top-2 gaps at least 2e-5, the tokens
      equal), and on (2, 2) the engines' fetched logits likewise;
      printed: server precompute, stack, prefill and decode-step ms, ms a
      tick and decode ms, peak memory and D6's seconds by rank;
  D7. in the same ranks, dynamic grouping and speculation across the
      mesh (``_mesh_fleet_spec``). bf16 (on D7_BF16_SHAPES):
      ``DecodeEngine(mesh=, dynamic_grouping=True)`` paged on D5's
      geometry and trace with D6's tenants and owners over a fresh cache:
      per rank the launches of ``mesh_fleet_counts`` exactly (K1 = 3 x 28
      split as in D4, K6 = 0, K8 = 2 x 4 x (chunk + decode steps)), three
      misses, D7_STACK_INSERTS stack inserts, every decode under
      ``"dynamic"``, each decode step's bytes
      by tag the single-tenant step's (``mesh_decode_bytes``), the
      schedule of D6's static paged engine, rank 0's streams; the
      speculative paged engine (k = 3) with D5's perturbed adapters on
      the committed ``speculative`` trace: its launches (K8 on every
      chunk, decode, draft and verify step), each draft, verify and
      decode step's bytes by tag exactly ``mesh_draft_bytes``,
      ``mesh_verify_bytes`` and ``mesh_decode_bytes``. fp32: the
      committed ``fleet`` trace over five tenants, dynamic rectangular
      and paged and static: ``fleet.schedule_model``'s counters and
      signatures, equal streams, the dynamic rows within D7_FLEET_TOL of
      the static ones; the speculative trace, rectangular and paged, with
      identity adapters (``speculative_model``'s counters; max |g - 1|
      printed: at model 2 wo's and w_down's g comes from norm partials
      summed over the axis) and with the perturbed ones and the ladder
      (a disable and a re-enable, the plain engine's streams), K8 on
      every paged step; on (2, 2) the fleet's dynamic and the verify's
      fetched logits within D6_TOL of max of one card's engines, tokens
      equal, ``MultiTenantServer(mesh=, dynamic_grouping=True)`` on D6's
      requests through the engine route the static grouping's tokens and
      with speculative_k=3 its plain ones, and ``EngineServer(mesh=)``
      with speculative_k at construction and in ``run`` the speculative
      paged engine's streams; printed: the accept rate, ms a tick,
      decode, draft and verify ms, peak memory and D7's seconds by rank.

With ``--kernel-phase-vs DIR`` it runs only the kernel phase, of the
checkout at DIR (a ``git archive`` of another commit) and of this one, in
turns (DIR, this, this, DIR), and prints K1's and K2's rows of each, with
the per-module norm (``ops.fused_norm``) and the qwen2-7b precompute
timed by this script on each checkout's package.

Any failed check raises, so the exit code is non-zero. The card's name
and power limit (as nvidia-smi gives them) are printed first and again
two lines before the last; the line before the last is the kernels' JSON
record and the last line is ``{"ok": true, "device": {...}}``. Every
shape's kernel row and each phase's full numbers are written to
``build/chip_smoke.json``. Without CUDA it exits non-zero before
printing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense; fp32 on CUDA cores (no TF32)
F32_OPS = 67e12
# exp on the special-function units: 16 per clock per SM, 132 SMs, boost
# clock 1.98 GHz (Hopper architecture white paper).
SFU_EXP_PER_S = 16 * 132 * 1.98e9

ARCH, BATCH, PROMPT, GEN, MAX_LEN = "qwen2-7b", 4, 960, 32, 1024
RANK, ALPHA, SEED = 384, 192.0, 0
FORCED_GEN = 3
COSINE_MIN = 0.9999

TRAIN_BATCH, TRAIN_SEQ, LOSS_TOKENS, TRAIN_STEPS = 2, 2048, 1024, 3
AGREE_LAYERS = 4
GRAD_COSINE_MIN = 0.99999

# The engine at realistic length: a chat or RAG server with long prompts
# of mixed length, short answers and a pool of half the blocks that a
# rectangular cache of the same slots would pin.
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_BLOCK, ENGINE_CHUNK = 8, 2048, 16, 256
ENGINE_BLOCKS = 512
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW, ENGINE_ARRIVAL = (
    24, (256, 1024), 64, 3.0)
# The engine, speculative, fault and FL2 phases run on the first 8 of
# qwen2-7b's 28 layers: they are host-bound, and every count they hold is
# derived from the depth.
ENGINE_LAYERS = 8

# falcon-mamba-7b served at full width: exact-length prefill of the same
# prompts, the route comparison in fp32 at 4 layers, card vs CPU at 2.
MAMBA_ARCH, MAMBA_AGREE_LAYERS, MAMBA_AGREE_GEN = "falcon-mamba-7b", 4, 8
SCAN_TOL = 1e-5
# qwen2-moe-a2.7b served and trained at full width and depth, with its
# route comparison in fp32 at 4 layers.
MOE_ARCH, MOE_AGREE_LAYERS = "qwen2-moe-a2.7b", 4
# K1's (d_out, d_in): qwen2-7b's wq, wk, w_gate, w_down, then
# falcon-mamba-7b's in_proj and out_proj.
K1_SHAPES = ((3584, 3584), (512, 3584), (18944, 3584), (3584, 18944),
             (16384, 4096), (4096, 8192))

SOURCES = {
    "norm_terms": ("src/repro_torch/kernels/csrc/norm_terms.cu",
                   "src/repro/kernels/factored_norm.py:49"),
    "assemble_norm": ("src/repro_torch/kernels/csrc/assemble_norm.cu",
                      "src/repro/kernels/norm_assembly.py:37"),
    "compose_fwd": ("src/repro_torch/kernels/csrc/compose.cu",
                    "src/repro/kernels/dora_compose.py:106"),
    "compose_fwd_dual": ("src/repro_torch/kernels/csrc/compose.cu",
                         "src/repro/kernels/dora_compose.py:106"),
    "compose_bwd": ("src/repro_torch/kernels/csrc/compose_bwd.cu",
                    "src/repro/kernels/dora_compose.py:136"),
    "compose_mm_fwd": ("src/repro_torch/kernels/csrc/compose_mm.cu",
                       "src/repro/kernels/dora_compose.py:211"),
    "compose_mm_bwd": ("src/repro_torch/kernels/csrc/compose_mm_bwd.cu",
                       "src/repro/kernels/dora_compose.py:239"),
    "paged_gather": ("src/repro_torch/kernels/csrc/paged_gather.cu",
                     "src/repro/kernels/paged_gather.py:90"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:60"),
    # No TPU kernel: the reference differentiates its XLA scan.
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/"
                           "selective_scan_bwd.cu",
                           "none (the reference differentiates "
                           "src/repro/models/mamba.py:50 _ssm_scan_fused)"),
}
# The path whose launch count each kernel's record carries (for K2, the
# launches of its arithmetic as K1's epilogue), and the index of the shape
# its top-level numbers are read at (w_gate, or the forced decode rows on
# w_gate for K3; the prefill shape for K9).
RECORD_PATH = {"norm_terms": ("serve_auto", 2),
               "assemble_norm": ("serve_auto", 2),
               "compose_fwd": ("serve_fused", 1),
               "compose_fwd_dual": ("train_elementwise", 0),
               "compose_bwd": ("train_elementwise", 0),
               "compose_mm_fwd": ("serve_auto", 1),
               "compose_mm_bwd": ("train_auto", 0),
               "paged_gather": ("engine_paged", 0),
               "selective_scan": ("serve_mamba", 0),
               "selective_scan_bwd": ("train_mamba", 0)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def check_k6_on_tensor_cores(mma_before: int, counts: dict,
                             path: str) -> None:
    """Every K6 launch of a main path since ``mma_before`` (the wrapper's
    tensor-core count then) took the tensor-core kernel."""
    from repro_torch.kernels import compose_mm_fwd

    took = compose_mm_fwd.mma_launches - mma_before
    check(took == counts["compose_mm_fwd"] > 0,
          f"{path}: {took} of {counts['compose_mm_fwd']} K6 launches took "
          f"the tensor-core route")


def counts_of(**launched) -> dict:
    """Every kernel's expected launch count, and "assembled" (K1's
    launches that ended in its epilogue): the named ones, 0 for the
    rest."""
    return {name: launched.get(name, 0) for name in (*SOURCES, "assembled")}


def launch_counts() -> dict:
    """Every kernel's launch count, and "assembled": K1's launches that
    ended in its epilogue, the norm assembly that replaced K2's launch on
    the main paths (``norm_terms.assembled_launches``)."""
    from repro_torch import kernels

    return {**kernels.launch_counts(),
            "assembled": kernels.norm_terms.assembled_launches}


def time_ms(fn, *, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events, after a warm-up,
    over enough launches to fill about ``target_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(50, max(3, target_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paged_table(b: int, table_rng, device, *,
                mb: int = ENGINE_MAX_LEN // ENGINE_BLOCK,
                n_blocks: int = ENGINE_BLOCKS) -> tuple[torch.Tensor, int]:
    """A block table of b rows x ``mb`` slots (the paged engine's
    max_len / 16) over a pool of ``n_blocks``: three quarters of the slots
    (at most the pool) hold distinct ids out of order, the rest -1.
    Returns the int32 table and the number of allocated slots."""
    table = np.full(b * mb, -1, np.int32)
    n_valid = min(n_blocks, b * mb * 3 // 4)
    table[table_rng.permutation(b * mb)[:n_valid]] = \
        table_rng.permutation(n_blocks)[:n_valid]
    return torch.as_tensor(table.reshape(b, mb), device=device), n_valid


def alternating_ms(a, b, windows: int = 5) -> tuple[list, list]:
    """time_ms of ``a()`` and of ``b()`` in alternating windows (a, b, a,
    b, ...). Launches paced by the host vary between windows, so a short
    kernel is compared with its yardstick by the medians."""
    ta, tb = [], []
    for _ in range(windows):
        ta.append(time_ms(a))
        tb.append(time_ms(b))
    return ta, tb


def bound_ms(nbytes: float, ops_s: float) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate
    and ``ops_s`` (operations already divided by their peak rates)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from the build log's ``ptxas -v``
    output: its name (and element type), registers, static shared
    memory and spill bytes; and ptxas's performance warnings (a wgmma
    serialised, for one)."""
    types = {"If": "fp32", "I13__nv_bfloat16": "bf16", "I6__half": "fp16"}
    out, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"entry function '_ZN([^']+)'", line)
        if entry:
            # A nested mangled name: <length><identifier> parts up to the
            # kernel's own, then its template arguments, if any.
            rest, parts = entry.group(1), []
            while (part := re.match(r"(\d+)", rest)):
                n = int(part.group(1))
                parts.append(rest[len(part.group(1)):len(part.group(1)) + n])
                rest = rest[len(part.group(1)) + n:]
            tag = next((t for k, t in types.items()
                        if rest.startswith(k + "E")), None)
            ints = re.match(r"I((?:L[ib]\d+E)+)E", rest)
            if tag is None and ints:
                tag = ", ".join(re.findall(r"L[ib](\d+)E", ints.group(1)))
            name = (parts[-1] if parts else entry.group(1)) + (
                f"<{tag}>" if tag else "")
        elif "spill" in line:
            spill = line.strip()
        elif "Performance Loss" in line:
            out.append(line.strip())
        elif "registers" in line and name:
            used = line.split(":", 1)[1].strip()
            out.append(f"{name}: {used}; {spill}")
            name = None
    return out


def split_sweep(module, plan_name: str, call, tiles: int, k: int,
                tile_k: int) -> dict:
    """ms of ``call()`` with the wrapper's split plan forced to 1-4 splits
    of ``k`` (the evidence behind ``_build.split_plan``'s cost model);
    keys are "splits/blocks"."""
    plan = getattr(module, plan_name)
    out = {}
    try:
        for want in (1, 2, 3, 4):
            per = math.ceil(math.ceil(k / tile_k) / want) * tile_k
            forced = (math.ceil(k / per), per)
            setattr(module, plan_name, lambda *_: forced)
            out[f"{forced[0]}/{forced[0] * tiles}"] = time_ms(call)
    finally:
        setattr(module, plan_name, plan)
    return out


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) in fp32."""
    g, w = got.float(), want.float()
    return (g - w).abs().max().item(), w.abs().max().item()


def gram_lane_sum(BG, B):
    """ba_sq = Σ_l BG_jl·B_jl in the order of K1's epilogue
    (csrc/norm_terms.cu gram_row_sum), in torch: lane l of a row's warp
    sums columns l, l + 32, ... in index order (each product rounded, then
    added), then the xor tree of offsets 16, 8, 4, 2, 1 adds the lanes."""
    from repro_torch.kernels.factored_norm import GRAM_LANES as lanes

    prod = BG * B.float()
    part = torch.zeros(BG.shape[0], lanes, device=BG.device)
    for c0 in range(0, BG.shape[1], lanes):
        chunk = prod[:, c0:c0 + lanes]
        part[:, :chunk.shape[1]] = part[:, :chunk.shape[1]] + chunk
    idx = torch.arange(lanes, device=BG.device)
    off = lanes // 2
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    return part[:, 0]


def check_epilogue(W, A, B, s: float, label: str) -> dict:
    """K1 with its epilogue at one shape. w_norm against K1's terms →
    the plain Gram row sum → assemble_norm_plain, within 1e-6 of max
    |w_norm| (only the order of ba_sq's sum differs); bitwise against
    K1's terms → the epilogue's lane-order Gram sum → assemble_norm_plain,
    without and with a base_sq override (so base_sq and cross are K1's
    bits, and ba_sq is summed in the designed order); the same bits on a
    second call."""
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka

    base, cross = kn.norm_terms(W, A, B)
    A32 = A.float()
    BG = B.float() @ (A32 @ A32.T)
    asm = kn.Assembly(BG, s)
    w = kn.norm_terms(W, A, B, asm)
    plain = ka.assemble_norm_plain(base, cross, (BG * B.float()).sum(dim=1),
                                   s)
    e, mx = max_err(w, plain)
    ba_lane = gram_lane_sum(BG, B)
    cache = base * 1.01
    wc = kn.norm_terms(W, A, B, kn.Assembly(BG, s, cache))
    out = {"w_norm_err": e, "w_norm_tol": 1e-6 * mx,
           "bitwise_lane_order": bool(torch.equal(
               w, ka.assemble_norm_plain(base, cross, ba_lane, s))),
           "bitwise_lane_order_base_override": bool(torch.equal(
               wc, ka.assemble_norm_plain(cache, cross, ba_lane, s))),
           "deterministic": bool(torch.equal(w, kn.norm_terms(W, A, B,
                                                              asm)))}
    check(e <= 1e-6 * mx and out["bitwise_lane_order"]
          and out["bitwise_lane_order_base_override"]
          and out["deterministic"], f"norm_terms epilogue {label}: {out}")
    return out


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def record_row(rows, name, shape, err, ref_max, rel, ms, plain, nbytes,
               ops_s, lib_ms=None, lib_call=None, grid=None, **extra):
    """Append one kernel row to ``rows[name]`` (error against the plain
    version and its tolerance ``rel`` x max |plain|, ms by events, the
    plain version's ms, the bound from ``nbytes`` and ``ops_s``, the
    PyTorch call's ms), print it, and fail if the error is above the
    tolerance."""
    tol = rel * ref_max
    b_ms, b_by = bound_ms(nbytes, ops_s)
    # The bytes the function must move over the kernel's time.
    gb_s = nbytes / ms / 1e6
    row = {"shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms,
           "library_call": lib_call, "gb_s": gb_s, "grid": grid,
           **extra}
    rows[name].append(row)
    print(f"  {name} {shape}: err {err:.3g} (tol {tol:.3g}), "
          f"{ms:.4f} ms ({gb_s:.0f} GB/s) vs plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})"
          + (f", {lib_call} {lib_ms:.4f} ms"
             if lib_ms is not None else "")
          + (f"; grid {grid}" if grid else "")
          + (f"; device {extra['device_ms']:.4f} ms"
             if extra.get("device_ms") is not None else ""), flush=True)
    check(err <= tol, f"{name} {shape}: max err {err} > tol {tol}")


def profiled_ms(run, kernel: str, calls: int, label: str):
    """The profiler's device time of one wrapper call over ``run()``
    (``calls`` calls): the time of every kernel whose name contains
    ``kernel`` (a main kernel and its split sum or epilogue together),
    over ``calls``; None where the profiler shows none."""
    prof = profile(run, label, echo=False)
    mine = [k["ms"] for k in prof.get("top_kernels_ms", [])
            if kernel in k["name"]]
    return sum(mine) / calls if mine else None


# ---------------------------------------------------------------------------
# Kernel-by-kernel checks at the serving path's shapes.
# ---------------------------------------------------------------------------

def kernel_checks(dev) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import dora_compose as kc
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16
    esz = 2
    s = ALPHA / math.sqrt(RANK)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    rows = {name: [] for name in SOURCES}

    def record(*args, **kw):
        record_row(rows, *args, **kw)

    # K1 and K2 on the wq, wk, w_gate and w_down weight shapes, then on
    # falcon-mamba-7b's in_proj and out_proj.
    for d_out, d_in in K1_SHAPES:
        W = randn(d_out, d_in, scale=d_in ** -0.5)
        A = ((torch.rand((RANK, d_in), generator=gen, device=dev) * 2 - 1)
             * d_in ** -0.5).to(bf)
        B = randn(d_out, RANK, scale=0.02)
        base, cross = kn.norm_terms(W, A, B)
        pb, pc = kn.norm_terms_plain(W, A, B)
        e1, m1 = max_err(base, pb)
        e2, m2 = max_err(cross, pc)
        # Both terms are fp32 sums of d_in (x r) products taken in another
        # order than the plain matmul: 1e-4 of the largest magnitude of
        # the output (base_sq and cross together).
        nbytes = (d_out * d_in + RANK * d_in + d_out * RANK) * esz \
            + 2 * d_out * 4
        ops_s = (2 * d_out * d_in * RANK) / PEAK_OPS[bf] \
            + (2 * d_out * d_in + 2 * d_out * RANK) / F32_OPS
        splits, split_k = kn.norm_terms_split(d_out, d_in, RANK)
        tiles = math.ceil(RANK / kn.TILE_RANK) * math.ceil(d_out /
                                                            kn.TILE_ROWS)
        grid = (f"{math.ceil(RANK / kn.TILE_RANK)} rank x "
                f"{math.ceil(d_out / kn.TILE_ROWS)} row tiles x {splits} "
                f"d_in splits of {split_k} = {tiles * splits} blocks")
        sweep = split_sweep(kn, "norm_terms_split",
                            lambda: kn.norm_terms(W, A, B), tiles, d_in,
                            kn.TILE_K)
        print(f"  norm_terms [{d_out}, {d_in}] ms by splits/blocks: {sweep}")
        record("norm_terms", [d_out, d_in, RANK], max(e1, e2), max(m1, m2),
               1e-4, time_ms(lambda: kn.norm_terms(W, A, B)),
               time_ms(lambda: kn.norm_terms_plain(W, A, B)), nbytes, ops_s,
               time_ms(lambda: W @ A.T), "W @ A.T", grid,
               base_sq_rel_err=e1 / m1, cross_rel_err=e2 / m2,
               splits=splits, split_sweep_ms=sweep,
               deterministic=bool(all(torch.equal(x, y) for x, y in zip(
                   (base, cross), kn.norm_terms(W, A, B)))))
        # K1 with its epilogue (the main paths' norm), held against K1's
        # terms → the Gram row sum → K2's plain version; the per-module
        # norm (ops.fused_norm) against the chain it replaced, K1's terms
        # → the Gram row sum in torch → K2, in this call; and the device
        # time of K1's kernels with and without the epilogue.
        ep = check_epilogue(W, A, B, s, f"[{d_out}, {d_in}, {RANK}]")
        A32, B32 = A.float(), B.float()
        G = A32 @ A32.T
        BG = B32 @ G
        asm = kn.Assembly(BG, s)

        def chain():
            b, c = kn.norm_terms(W, A, B)
            a32, b32 = A.float(), B.float()
            return ka.assemble_norm(
                b, c, ((b32 @ (a32 @ a32.T)) * b32).sum(dim=1), s)
        prof = profile(lambda: [(kn.norm_terms(W, A, B),
                                 kn.norm_terms(W, A, B, asm))
                                for _ in range(10)],
                       f"norm_terms [{d_out}, {d_in}] x 10, without and "
                       f"with the epilogue")
        dev_ms = {m.group(0): k["ms"] / k["launches"]
                  for k in prof.get("top_kernels_ms", [])
                  if (m := re.search(r"norm_terms\w*_kernel", k["name"]))}
        rows["norm_terms"][-1].update(
            epilogue=ep, fused_norm_ms=time_ms(
                lambda: ops.fused_norm(W, A, B, s)),
            chain_ms=time_ms(chain),
            assembled_ms=time_ms(lambda: kn.norm_terms(W, A, B, asm)),
            epilogue_bound_ms=(d_out * RANK * (4 + esz) + 12 * d_out)
            / HBM_BYTES_PER_S * 1e3,
            device_ms_by_kernel=dev_ms)
        print(f"  norm_terms [{d_out}, {d_in}] epilogue: {ep}; fused_norm "
              f"{rows['norm_terms'][-1]['fused_norm_ms']:.4f} ms vs the "
              f"K1 + torch + K2 chain "
              f"{rows['norm_terms'][-1]['chain_ms']:.4f} ms; device ms "
              f"{dev_ms}", flush=True)
        ba = (BG * B32).sum(dim=1)
        out = ka.assemble_norm(pb, pc, ba, s)
        ref = ka.assemble_norm_plain(pb, pc, ba, s)
        e, mx = max_err(out, ref)
        # K2's own device time (its events time is the wrapper's host
        # side).
        prof = profile(lambda: [ka.assemble_norm(pb, pc, ba, s)
                                for _ in range(20)],
                       f"assemble_norm [{d_out}] x 20")
        mine = [k for k in prof.get("top_kernels_ms", [])
                if "assemble_norm_kernel" in k["name"]]
        # Same pinned fp32 operations on both sides: within 1e-6.
        record("assemble_norm", [d_out], e, mx, 1e-6,
               time_ms(lambda: ka.assemble_norm(pb, pc, ba, s)),
               time_ms(lambda: ka.assemble_norm_plain(pb, pc, ba, s)),
               4 * d_out * 4, 5 * d_out / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(out, ref)),
               device_ms=(mine[0]["ms"] / mine[0]["launches"] if mine
                          else None))
        del W, A, B, BG, G

    # K3 at decode (M = 4) and prefill-sized rows: 4096, and the 3840
    # rows of a 4 x 960 prefill on the element-wise route (a rank that
    # pads above 512, as 768 does, materializes y_lora and composes it
    # here), each with its device time.
    for m, n in ((4, 3584), (4, 18944), (4096, 18944), (3840, 18944)):
        base = randn(m, n)
        lora = randn(m, n, scale=2.0)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        out = kc.compose_fwd(base, lora, gm1, s)
        ref = kc.compose_fwd_plain(base, lora, gm1, s)
        e, mx = max_err(out, ref)
        # Same pinned fp32 operations, one bf16 rounding: one bf16 ulp of
        # the largest value.
        record("compose_fwd", [m, n], e, mx, 2.0 ** -8,
               time_ms(lambda: kc.compose_fwd(base, lora, gm1, s)),
               time_ms(lambda: kc.compose_fwd_plain(base, lora, gm1, s)),
               3 * m * n * esz + n * 4, 5 * m * n / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(out, ref)),
               device_ms=profiled_ms(
                   lambda: [kc.compose_fwd(base, lora, gm1, s)
                            for _ in range(20)], "compose_fwd_kernel", 20,
                   f"compose_fwd [{m}, {n}] x 20"))
        del base, lora

    # K6 at prefill and training rows on the d_out of wq/wo/w_down and of
    # w_gate/w_up, then at falcon-mamba-7b's prefill rows (4 x 960) on
    # in_proj and out_proj: every main-path shape, each on the tensor-core
    # route.
    mm = kc.compose_mm_fwd
    for m, n in ((4096, 3584), (4096, 18944), (BATCH * PROMPT, 16384),
                 (BATCH * PROMPT, 4096)):
        base = randn(m, n)
        h = randn(m, RANK, scale=0.5)
        B = randn(n, RANK, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        mma0 = mm.mma_launches
        out = kc.compose_mm_fwd(base, h, B, gm1, s)
        check(mm.mma_launches == mma0 + 1,
              f"compose_mm_fwd [{m}, {n}, {RANK}] did not take the "
              f"tensor-core route")
        ref = kc.compose_mm_fwd_plain(base, h, B, gm1, s)
        e, mx = max_err(out, ref)
        blocks = kc.compose_mm_fwd_blocks(m, n)
        tiles = (math.ceil(m / kc.MM_FWD_TILE_ROWS)
                 * math.ceil(n / kc.MM_FWD_TILE_COLS))
        # The device time alone (the events above also time the wrapper's
        # host side where the kernel is short), and the rate at which the
        # tiles read h and B tiles from L2.
        prof = profile(lambda: [kc.compose_mm_fwd(base, h, B, gm1, s)
                                for _ in range(20)],
                       f"compose_mm_fwd [{m}, {n}] x 20")
        mine = [k for k in prof.get("top_kernels_ms", [])
                if "compose_mm_fwd_mma_kernel" in k["name"]]
        device_ms = mine[0]["ms"] / mine[0]["launches"] if mine else None
        l2_bytes = tiles * (kc.MM_FWD_TILE_ROWS + kc.MM_FWD_TILE_COLS) \
            * RANK * esz
        # The first version's FMA kernel on the same inputs, in this call
        # (the C entry point with blocks = 0; no wrapper, so uncounted).
        fma_out = torch.empty_like(base)

        def fma():
            _build.check(_build.library().compose_mm_fwd(
                base.data_ptr(), h.data_ptr(), B.data_ptr(), gm1.data_ptr(),
                fma_out.data_ptr(), m, n, RANK, s, 0,
                _build.DTYPE_CODE[bf], _build.stream_of(base)),
                "compose_mm_fwd (FMA)")
        # lora is an fp32 sum in another order than cuBLAS's, then one
        # bf16 rounding: two bf16 ulps of the largest value.
        record("compose_mm_fwd", [m, n, RANK], e, mx, 2.0 ** -7,
               time_ms(lambda: kc.compose_mm_fwd(base, h, B, gm1, s)),
               time_ms(lambda: kc.compose_mm_fwd_plain(base, h, B, gm1, s)),
               2 * m * n * esz + (m + n) * RANK * esz + n * 4,
               2 * m * n * RANK / PEAK_OPS[bf] + 5 * m * n / F32_OPS,
               time_ms(lambda: h @ B.T), "h @ B.T",
               f"{blocks} persistent blocks over {tiles} tiles of "
               f"[{kc.MM_FWD_TILE_ROWS} x {kc.MM_FWD_TILE_COLS}]",
               route="wgmma", device_ms=device_ms, fma_ms=time_ms(fma),
               l2_operand_gb_s=(l2_bytes / device_ms / 1e6
                                if device_ms else None),
               deterministic=bool(torch.equal(
                   out, kc.compose_mm_fwd(base, h, B, gm1, s))))
        row = rows["compose_mm_fwd"][-1]
        print(f"    device {device_ms} ms, h and B tiles from L2 at "
              f"{row['l2_operand_gb_s']} GB/s, first version (FMA) "
              f"{row['fma_ms']:.4f} ms, deterministic "
              f"{row['deterministic']}", flush=True)
        del base, h, B, out, ref, fma_out

    # The tensor-core route of K6 at ragged shapes: M and N inside a tile,
    # r ending inside a k-tile (136) and below one (40).
    for m, n, r in ((1000, 1000, 136), (130, 200, 40)):
        base = randn(m, n)
        h = randn(m, r, scale=0.5)
        B = randn(n, r, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        mma0 = mm.mma_launches
        out = kc.compose_mm_fwd(base, h, B, gm1, s)
        took_mma = mm.mma_launches == mma0 + 1
        e, mx = max_err(out, kc.compose_mm_fwd_plain(base, h, B, gm1, s))
        same = torch.equal(out, kc.compose_mm_fwd(base, h, B, gm1, s))
        check(took_mma and e <= 2.0 ** -7 * mx and same,
              f"compose_mm_fwd ragged [{m}, {n}, {r}]: tensor-core route "
              f"{took_mma}, err {e} (tol {2.0 ** -7 * mx}), deterministic "
              f"{same}")
    print("  compose_mm_fwd at ragged shapes: ok", flush=True)

    # K4, K5 and K7 at training rows (batch 2 x seq 2048) on the d_out of
    # w_gate/w_up and of wq/wo/w_down.
    for m, n in ((4096, 18944), (4096, 3584)):
        base = randn(m, n)
        lora = randn(m, n, scale=2.0)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        gs = (gm1 + 1.0) * s
        delta, inner = kc.compose_fwd_dual(base, lora, gm1, s)
        ref_d, ref_i = kc.compose_fwd_dual_plain(base, lora, gm1, s)
        e1, m1 = max_err(delta, ref_d)
        e2, m2 = max_err(inner, ref_i)
        # Same pinned fp32 operations, one bf16 rounding: one bf16 ulp of
        # the largest value.
        record("compose_fwd_dual", [m, n], max(e1, e2), max(m1, m2),
               2.0 ** -8,
               time_ms(lambda: kc.compose_fwd_dual(base, lora, gm1, s)),
               time_ms(lambda: kc.compose_fwd_dual_plain(base, lora, gm1,
                                                         s)),
               4 * m * n * esz + n * 4, 6 * m * n / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(delta, ref_d)
                                        and torch.equal(inner, ref_i)))
        del lora, delta, inner, ref_d, ref_i
        dy = base
        d_base, d_lora = kc.compose_bwd(dy, gm1, gs)
        ref_b, ref_l = kc.compose_bwd_plain(dy, gm1, gs)
        e1, m1 = max_err(d_base, ref_b)
        e2, m2 = max_err(d_lora, ref_l)
        # One fp32 product, one bf16 rounding: one bf16 ulp.
        record("compose_bwd", [m, n], max(e1, e2), max(m1, m2), 2.0 ** -8,
               time_ms(lambda: kc.compose_bwd(dy, gm1, gs)),
               time_ms(lambda: kc.compose_bwd_plain(dy, gm1, gs)),
               3 * m * n * esz + 2 * n * 4, 2 * m * n / F32_OPS,
               bitwise_equal_plain=bool(torch.equal(d_base, ref_b)
                                        and torch.equal(d_lora, ref_l)))
        del d_base, d_lora, ref_b, ref_l
        B = randn(n, RANK, scale=0.02)
        d_base, d_h = kc.compose_mm_bwd(dy, B, gm1, gs)
        ref_b, ref_h = kc.compose_mm_bwd_plain(dy, B, gm1, gs)
        e1, _ = max_err(d_base, ref_b)
        e2, m2 = max_err(d_h, ref_h)
        check(torch.equal(d_base, ref_b), f"compose_mm_bwd [{m}, {n}]: "
              f"d_base differs from the plain version (err {e1})")
        # d_h: fp32 sums of N products (of t's bf16 hi and lo parts) in
        # another order than cuBLAS's, 1e-4 of the largest |d_h|; d_base
        # must be bitwise equal. The kernel runs two bf16 products (hi·B
        # and lo·B), so its bound counts both.
        dys = (dy.float() * gs).to(dy.dtype)
        splits, split_n = kc.compose_mm_bwd_split(m, n, RANK)
        tiles = (math.ceil(RANK / kc.MM_BWD_TILE_RANK)
                 * math.ceil(m / kc.MM_BWD_TILE_ROWS))
        grid = (f"{math.ceil(RANK / kc.MM_BWD_TILE_RANK)} rank x "
                f"{math.ceil(m / kc.MM_BWD_TILE_ROWS)} row tiles x {splits} "
                f"N splits of {split_n} = {tiles * splits} blocks")
        sweep = split_sweep(kc, "compose_mm_bwd_split",
                            lambda: kc.compose_mm_bwd(dy, B, gm1, gs), tiles,
                            n, kc.MM_BWD_TILE_K)
        print(f"  compose_mm_bwd [{m}, {n}] ms by splits/blocks: {sweep}")
        record("compose_mm_bwd", [m, n, RANK], e2, m2, 1e-4,
               time_ms(lambda: kc.compose_mm_bwd(dy, B, gm1, gs)),
               time_ms(lambda: kc.compose_mm_bwd_plain(dy, B, gm1, gs)),
               2 * m * n * esz + n * RANK * esz + m * RANK * 4 + 2 * n * 4,
               2 * 2 * m * n * RANK / PEAK_OPS[bf] + 3 * m * n / F32_OPS,
               time_ms(lambda: dys @ B), "(dY*gs) @ B, bf16 product only",
               grid, d_base_bitwise_equal_plain=True, splits=splits,
               split_sweep_ms=sweep,
               deterministic=bool(torch.equal(
                   d_h, kc.compose_mm_bwd(dy, B, gm1, gs)[1])))
        del dy, base, B, d_base, d_h, ref_b, ref_h, dys

    # The tensor-core routes of K1 and K7 at ragged shapes (row, rank and
    # k edges inside a tile, many splits), against the plain versions.
    for d_out, d_in, r in ((1000, 1064, 40), (130, 200, 136)):
        W = randn(d_out, d_in, scale=d_in ** -0.5)
        A = randn(r, d_in, scale=d_in ** -0.5)
        B = randn(d_out, r, scale=0.02)
        got, want = kn.norm_terms(W, A, B), kn.norm_terms_plain(W, A, B)
        for g, w in zip(got, want):
            e, mx = max_err(g, w)
            check(e <= 1e-4 * mx, f"norm_terms ragged [{d_out}, {d_in}, "
                  f"{r}]: err {e} > {1e-4 * mx}")
        check_epilogue(W, A, B, s, f"ragged [{d_out}, {d_in}, {r}]")
    # The epilogue on the FMA route: fp32 operands, and bf16 ones whose
    # d_in is no multiple of 8.
    for d_out, d_in, r, dtype in ((130, 200, 136, torch.float32),
                                  (1000, 203, 40, bf)):
        check_epilogue(randn(d_out, d_in, scale=d_in ** -0.5, dtype=dtype),
                       randn(r, d_in, scale=d_in ** -0.5, dtype=dtype),
                       randn(d_out, r, scale=0.02, dtype=dtype), s,
                       f"FMA route [{d_out}, {d_in}, {r}] {dtype}")
    for m, n, r in ((100, 1064, 40), (130, 3584, 200)):
        dy = randn(m, n)
        B = randn(n, r, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        gs = (gm1 + 1.0) * s
        (d_base, d_h), (ref_b, ref_h) = (kc.compose_mm_bwd(dy, B, gm1, gs),
                                         kc.compose_mm_bwd_plain(dy, B, gm1,
                                                                 gs))
        e, mx = max_err(d_h, ref_h)
        check(torch.equal(d_base, ref_b) and e <= 1e-4 * mx,
              f"compose_mm_bwd ragged [{m}, {n}, {r}]: d_h err {e} "
              f"(tol {1e-4 * mx}), d_base bitwise "
              f"{torch.equal(d_base, ref_b)}")
    print("  norm_terms (and its epilogue on both routes), compose_mm_bwd "
          "at ragged shapes: ok", flush=True)

    # K8 at the paged engine's decode and chunk-step shapes: a pool of
    # 512 blocks of [16, 4 KV heads x 128] and tables of max_len / 16 = 128
    # slots per row, the ids out of order with -1 holes.
    from repro_torch.kernels import paged_gather as kp
    bs, hkv, hd = ENGINE_BLOCK, 4, 128
    mb = ENGINE_MAX_LEN // bs
    pool = randn(ENGINE_BLOCKS, bs, hkv, hd)
    block_bytes = bs * hkv * hd * esz
    table_rng = np.random.default_rng(SEED + 8)
    for b in (ENGINE_SLOTS, 1):
        pages, n_valid = paged_table(b, table_rng, dev)
        out = kp.paged_gather(pool, pages)
        ref = kp.paged_gather_plain(pool, pages)
        torch.cuda.synchronize()
        bitwise = torch.equal(out.view(torch.int16), ref.view(torch.int16))
        check(bitwise, f"paged_gather [{b}, {mb}]: not bitwise the plain "
              f"version")
        e, mx = max_err(out, ref)
        ids = pages.clamp_min(0).long().reshape(-1)
        # The kernel and index_select are both paced by the host here:
        # medians of 5 alternating windows.
        ms_k8, ms_lib = alternating_ms(
            lambda: kp.paged_gather(pool, pages),
            lambda: pool.index_select(0, ids))
        # A copy: bitwise, tolerance 0. Bytes: the output written once,
        # the allocated blocks and the table read once.
        record("paged_gather", [b, mb * bs, hkv, hd], e, mx, 0.0,
               float(np.median(ms_k8)),
               time_ms(lambda: kp.paged_gather_plain(pool, pages)),
               (b * mb + n_valid) * block_bytes + b * mb * 4, 0.0,
               float(np.median(ms_lib)),
               "pool.index_select(0, clamped ids), no zero fill",
               bitwise_equal_plain=bitwise, valid_entries=n_valid,
               ms_windows=ms_k8, library_ms_windows=ms_lib)
        # The events above time the wrapper's host side as much as the
        # copy; the profiler reads the kernel's own device time.
        prof = profile(lambda: [kp.paged_gather(pool, pages)
                                for _ in range(20)],
                       f"paged_gather [{b}, {mb}] x 20")
        mine = [k for k in prof.get("top_kernels_ms", [])
                if "paged_gather_kernel" in k["name"]]
        rows["paged_gather"][-1]["device_ms"] = (
            mine[0]["ms"] / mine[0]["launches"] if mine else None)
        del out, ref
    del pool

    # K9 at the falcon-mamba-7b prefill shape, a ragged shape (S and di no
    # multiple of anything) and the SMOKE width (n = 4). dt spans the
    # Mamba init's range [1e-3, 1e-1], A = -(1..n) with noise, as the
    # model's A = -exp(A_log).
    from repro_torch.kernels import selective_scan as ks
    f32 = torch.float32
    chosen = ks.LANES
    for b, seq, di, n in ((BATCH, PROMPT, 8192, 16), (1, 37, 8192 + 64, 16),
                          (2, 64, 128, 4)):
        u = torch.rand((b, seq, di), generator=gen, device=dev)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        dtx = dt * randn(b, seq, di, dtype=f32)
        Bm, Cm = randn(b, seq, n, dtype=f32), randn(b, seq, n, dtype=f32)
        A_t = -(torch.arange(1, n + 1, device=dev, dtype=f32)[:, None]
                * (1.0 + 0.1 * torch.rand((n, di), generator=gen,
                                          device=dev)))
        h0_t = randn(b, n, di, scale=0.5, dtype=f32)
        args = (dt, dtx, Bm, Cm, A_t, h0_t)
        y, h_f = ks.selective_scan(*args)
        ref_y, ref_h = ks.selective_scan_plain(*args)
        e1, m1 = max_err(y, ref_y)
        e2, m2 = max_err(h_f, ref_h)
        # fp32 recurrences whose products nvcc contracts into FMAs and
        # whose sum over n runs in another order than the plain version's:
        # 1e-5 of the largest |y|, and of the largest |h_f| for h_f.
        check(e2 <= SCAN_TOL * m2, f"selective_scan [{b}, {seq}, {di}, {n}]:"
              f" h_f err {e2} > tol {SCAN_TOL * m2}")
        # Bytes: dt, dtx read and y written once, B, C, A, h0 and h_f.
        # Operations: b*seq*di*n exps on the SFUs, and 6 fp32 flops per
        # exp on the FMA pipes, which issue beside them: the larger time.
        nbytes = 4 * (3 * b * seq * di + 2 * b * seq * n + n * di
                      + 2 * b * n * di)
        n_exp = b * seq * di * n
        y2, h_f2 = ks.selective_scan(*args)
        same = bool(torch.equal(y, y2) and torch.equal(h_f, h_f2))
        check(same, f"selective_scan [{b}, {seq}, {di}, {n}]: a second call "
              f"gave other bits")
        extra = {}
        if b == BATCH:
            # The lane sweep behind ks.LANES (the fastest), and the kernel's
            # own device time at the prefill shape.
            sweep = {}
            try:
                for lanes in (1, 2, 4):
                    ks.LANES = lanes
                    sweep[lanes] = time_ms(lambda: ks.selective_scan(*args))
            finally:
                ks.LANES = chosen
            print(f"  selective_scan [{b}, {seq}, {di}, {n}] ms by lanes: "
                  f"{sweep}", flush=True)
            prof = profile(lambda: [ks.selective_scan(*args)
                                    for _ in range(10)],
                           f"selective_scan [{b}, {seq}, {di}, {n}] x 10")
            mine = [k for k in prof.get("top_kernels_ms", [])
                    if "selective_scan_kernel" in k["name"]]
            extra = {"lane_sweep_ms": sweep, "lanes": chosen,
                     "device_ms": (mine[0]["ms"] / mine[0]["launches"]
                                   if mine else None)}
        blocks, _, channels = ks.scan_schedule(b, di, chosen)
        record("selective_scan", [b, seq, di, n], e1, m1, SCAN_TOL,
               time_ms(lambda: ks.selective_scan(*args)),
               time_ms(lambda: ks.selective_scan_plain(*args)), nbytes,
               max(n_exp / SFU_EXP_PER_S, 6 * n_exp / F32_OPS),
               grid=f"{blocks} x {b} blocks of {channels} channels x "
                    f"{chosen} lanes",
               h_f_err=e2, h_f_tol=SCAN_TOL * m2,
               bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_sfu_ms=n_exp / SFU_EXP_PER_S * 1e3,
               deterministic=same, **extra)
        del args, dt, dtx, y, h_f, ref_y, ref_h, y2, h_f2
    torch.cuda.empty_cache()
    scan_train_checks(gen, rows, record)
    return rows


def bwd_design_exps(b: int, seq: int, di: int, lanes: int) -> int:
    """The exps the backward kernel issues: for every (batch row, channel
    of its blocks, one of 16 states) and chunk, the pass from hc to the
    last window's start and every window's recompute (the walk back reuses
    those)."""
    from repro_torch.kernels import selective_scan as ks

    blocks, _, channels = ks.bwd_schedule(b, di, lanes)
    steps = 0
    for t0 in range(0, seq, ks.STATE_EVERY):
        windows = -(-min(ks.STATE_EVERY, seq - t0) // ks.BWD_WINDOW)
        steps += (2 * windows - 1) * ks.BWD_WINDOW
    return b * blocks * channels * ks.MAX_STATE * steps


def bwd_occupancy(lanes: int) -> dict:
    """The backward kernel's residency at ``lanes`` from the CUDA
    occupancy API: blocks and warps an SM, registers, shared memory and
    spilled bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 5)()
    _build.check(_build.library().selective_scan_bwd_occupancy(
        lanes, ctypes.cast(out, ctypes.c_void_p)), "selective_scan_bwd")
    blocks, threads, regs, smem, local = out
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "threads": threads, "registers": regs, "smem_bytes": smem,
            "local_bytes": local}


def scan_train_checks(gen, rows, record) -> None:
    """K9's training forward (chunk states) and the scan's backward at the
    falcon-mamba-7b training shape [2, 2048, 8192], n = 16, and a ragged
    one (S no multiple of the 32-step stride or the 8-step window, di no
    multiple of the backward's 64 or 32 channels a block): with chunk
    states K9 gives y and h_f bitwise as without and hc within 1e-5 of max
    of its plain version's; the backward within 1e-5 of max |grad| of its
    plain version for each of d_dt, d_dtx, d_B and d_C, the same bits
    twice; ms by events and device time beside the bound, the bound of
    the exps the design issues, a sweep of its lanes a channel and their
    residency. K9's row gains its chunk-state time."""
    from repro_torch.kernels import selective_scan as ks

    f32 = torch.float32
    dev = gen.device
    for b, seq, di, n in ((TRAIN_BATCH, TRAIN_SEQ, 8192, 16),
                          (1, 70, 8192 + 40, 16)):
        u = torch.rand((b, seq, di), generator=gen, device=dev)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        dtx = dt * torch.randn((b, seq, di), generator=gen, device=dev)
        Bm = torch.randn((b, seq, n), generator=gen, device=dev)
        Cm = torch.randn((b, seq, n), generator=gen, device=dev)
        A_t = -(torch.arange(1, n + 1, device=dev, dtype=f32)[:, None]
                * (1.0 + 0.1 * torch.rand((n, di), generator=gen,
                                          device=dev)))
        h0_t = torch.zeros((b, n, di), device=dev)
        dy = torch.randn((b, seq, di), generator=gen, device=dev)
        args = (dt, dtx, Bm, Cm, A_t, h0_t)
        label = f"[{b}, {seq}, {di}, {n}]"
        y0, hf0 = ks.selective_scan(*args)
        y, hf, hc = ks.selective_scan(*args, chunk_states=True)
        _, _, hc_ref = ks.selective_scan_plain(*args, chunk_states=True)
        e_hc, m_hc = max_err(hc, hc_ref)
        fwd = {"y_h_f_bitwise_without_states": bool(
                   torch.equal(y, y0) and torch.equal(hf, hf0)),
               "hc_err": e_hc, "hc_tol": SCAN_TOL * m_hc}
        check(fwd["y_h_f_bitwise_without_states"] and e_hc <= SCAN_TOL * m_hc,
              f"selective_scan with chunk states {label}: {fwd}")
        grads = ks.selective_scan_bwd(*args[:5], hc, dy)
        ref = ks.selective_scan_bwd_plain(*args[:5], hc, dy)
        again = ks.selective_scan_bwd(*args[:5], hc, dy)
        same = all(torch.equal(g, a) for g, a in zip(grads, again))
        errs = {name: max_err(g, r) for name, g, r in
                zip(("d_dt", "d_dtx", "d_B", "d_C"), grads, ref)}
        worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
        check(same, f"selective_scan_bwd {label}: a second call gave other "
                    f"bits")
        for name, (e, m) in errs.items():
            check(e <= SCAN_TOL * m, f"selective_scan_bwd {label} {name}: "
                                     f"err {e} > tol {SCAN_TOL * m}")
        # Bytes: dt, dtx, dy and hc read, d_dt and d_dtx written (B, C, A,
        # d_B and d_C besides). Operations: b*seq*di*n exps on the SFUs,
        # or about 10 fp32 flops each on the FMA pipes: the larger time.
        n_exp = b * seq * di * n
        nbytes = 4 * (5 * b * seq * di + 4 * b * seq * n + n * di
                      + hc.numel())
        extra = {}
        if b == TRAIN_BATCH:
            # The lane sweep behind ks.BWD_LANES (the faster), each lane
            # count's residency, and the chosen kernel's device time.
            sweep = {}
            chosen = ks.BWD_LANES
            try:
                for lanes in (4, 8):
                    ks.BWD_LANES = lanes
                    sweep[lanes] = time_ms(lambda: ks.selective_scan_bwd(
                        *args[:5], hc, dy))
            finally:
                ks.BWD_LANES = chosen
            print(f"  selective_scan_bwd {label} ms by lanes: {sweep}",
                  flush=True)
            states_ms = time_ms(lambda: ks.selective_scan(
                *args, chunk_states=True))
            serve_ms = time_ms(lambda: ks.selective_scan(*args))
            rows["selective_scan"][0]["train_shape"] = [b, seq, di, n]
            rows["selective_scan"][0]["chunk_states_ms"] = states_ms
            rows["selective_scan"][0]["without_states_ms_train_shape"] = \
                serve_ms
            print(f"  selective_scan {label} with chunk states: "
                  f"{states_ms:.4f} ms (without {serve_ms:.4f} ms); "
                  + json.dumps(fwd), flush=True)
            extra = {"device_ms": profiled_ms(
                lambda: [ks.selective_scan_bwd(*args[:5], hc, dy)
                         for _ in range(5)], "selective_scan_bwd", 5,
                f"selective_scan_bwd {label} x 5"),
                "lanes": chosen, "lane_sweep_ms": sweep,
                "occupancy": {lanes: bwd_occupancy(lanes)
                              for lanes in (4, 8)}}
        blocks, _, channels = ks.bwd_schedule(b, di, ks.BWD_LANES)
        design_exp = bwd_design_exps(b, seq, di, ks.BWD_LANES)
        record("selective_scan_bwd", [b, seq, di, n], errs[worst][0],
               errs[worst][1], SCAN_TOL,
               time_ms(lambda: ks.selective_scan_bwd(*args[:5], hc, dy)),
               time_ms(lambda: ks.selective_scan_bwd_plain(*args[:5], hc,
                                                           dy)),
               nbytes, max(n_exp / SFU_EXP_PER_S, 10 * n_exp / F32_OPS),
               grid=f"{blocks} x {b} blocks of {channels} channels x "
                    f"{ks.BWD_LANES} lanes, windows of {ks.BWD_WINDOW}",
               errors={k: {"err": e, "tol": SCAN_TOL * m}
                       for k, (e, m) in errs.items()},
               chunk_states_forward=fwd,
               bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_sfu_ms=n_exp / SFU_EXP_PER_S * 1e3,
               design_exps=design_exp,
               bound_sfu_design_ms=design_exp / SFU_EXP_PER_S * 1e3,
               deterministic=same, **extra)
        del args, dt, dtx, Bm, Cm, dy, y0, y, hc, hc_ref, grads, ref, again
    torch.cuda.empty_cache()


# The weight shapes [d_out, d_in] of the adapted modules of the archs
# this script serves beside qwen2-7b (qwen2-vl-7b has qwen2-7b's), and
# the d_out of every one that the auto prefill of 4 x 1024 rows sends to
# K6 (and a training step to K6 and K7).
ARCH_K1_SHAPES = (
    (3072, 8192), (8192, 3072), (1024, 3072), (3072, 3072),   # phi4-mini
    (4096, 13696), (13696, 4096), (256, 4096), (4096, 4096),  # chatglm3
    (5120, 25600), (25600, 5120), (1024, 5120), (5120, 8192),  # qwen3-32b
    (8192, 5120),
    (1536, 6144), (6144, 1536), (1536, 1536),                 # musicgen
    (8192, 29568), (29568, 8192), (1024, 8192), (8192, 8192),  # qwen2-vl-72b
    (2048, 2048), (5632, 2048), (2048, 5632),                 # qwen2-moe
    (5120, 5120),                                             # llama4-scout
    (14336, 4096), (4096, 14336), (1024, 4096))               # jamba
# 16384: falcon-mamba-7b's and jamba's in_proj, which the kernel phase
# holds K6 at on the prefill rows only.
ARCH_MM_N = (3072, 8192, 4096, 13696, 5120, 25600, 6144, 29568, 5632,
             14336, 16384)
ARCH_MM_ROWS = BATCH * MAX_LEN


def arch_kernel_checks(dev, rows) -> None:
    """K1 with its epilogue at every ARCH_K1_SHAPES weight, and K6 and K7
    at ARCH_MM_ROWS x every ARCH_MM_N, against their plain versions to
    the tolerances of kernel_checks; each timed by events and by the
    profiler's device time beside its bound and the PyTorch call for the
    same product. Rows go into ``rows`` with ``"arch_shape": True``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import dora_compose as kc
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16
    esz = 2
    s = ALPHA / math.sqrt(RANK)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    def record(*args, **kw):
        record_row(rows, *args, arch_shape=True, **kw)

    for d_out, d_in in ARCH_K1_SHAPES:
        W = randn(d_out, d_in, scale=d_in ** -0.5)
        A = ((torch.rand((RANK, d_in), generator=gen, device=dev) * 2 - 1)
             * d_in ** -0.5).to(bf)
        B = randn(d_out, RANK, scale=0.02)
        base, cross = kn.norm_terms(W, A, B)
        pb, pc = kn.norm_terms_plain(W, A, B)
        e1, m1 = max_err(base, pb)
        e2, m2 = max_err(cross, pc)
        ep = check_epilogue(W, A, B, s, f"[{d_out}, {d_in}, {RANK}]")
        A32, B32 = A.float(), B.float()
        BG = B32 @ (A32 @ A32.T)
        asm = kn.Assembly(BG, s)
        splits, split_k = kn.norm_terms_split(d_out, d_in, RANK)
        tiles = math.ceil(RANK / kn.TILE_RANK) * math.ceil(d_out /
                                                            kn.TILE_ROWS)
        # The main paths' call, K1 with its epilogue: W, A, B and BG read
        # once, w_norm written; the bf16 product on the tensor cores, the
        # squares, the cross and Gram row sums in fp32.
        nbytes = (d_out * d_in + RANK * d_in + d_out * RANK) * esz \
            + d_out * RANK * 4 + d_out * 4
        ops_s = (2 * d_out * d_in * RANK) / PEAK_OPS[bf] \
            + (2 * d_out * d_in + 4 * d_out * RANK) / F32_OPS
        record("norm_terms", [d_out, d_in, RANK], max(e1, e2), max(m1, m2),
               1e-4, time_ms(lambda: kn.norm_terms(W, A, B, asm)),
               time_ms(lambda: ka.assemble_norm_plain(
                   *kn.norm_terms_plain(W, A, B),
                   (BG * B.float()).sum(dim=1), s)),
               nbytes, ops_s, time_ms(lambda: W @ A.T), "W @ A.T",
               f"{tiles} tiles x {splits} d_in splits of {split_k} = "
               f"{tiles * splits} blocks",
               with_epilogue=True, epilogue=ep, splits=splits,
               terms_ms=time_ms(lambda: kn.norm_terms(W, A, B)),
               device_ms=profiled_ms(
                   lambda: [kn.norm_terms(W, A, B, asm) for _ in range(10)],
                   "norm_terms", 10, f"norm_terms [{d_out}, {d_in}] x 10"),
               deterministic=bool(torch.equal(
                   kn.norm_terms(W, A, B, asm),
                   kn.norm_terms(W, A, B, asm))))
        del W, A, B, BG, asm, pb, pc, base, cross
    print("  norm_terms with its epilogue at every new arch shape: ok",
          flush=True)

    m = ARCH_MM_ROWS
    for n in ARCH_MM_N:
        base = randn(m, n)
        h = randn(m, RANK, scale=0.5)
        B = randn(n, RANK, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        gs = (gm1 + 1.0) * s
        mma0 = kc.compose_mm_fwd.mma_launches
        out = kc.compose_mm_fwd(base, h, B, gm1, s)
        check(kc.compose_mm_fwd.mma_launches == mma0 + 1,
              f"compose_mm_fwd [{m}, {n}, {RANK}] did not take the "
              f"tensor-core route")
        e, mx = max_err(out, kc.compose_mm_fwd_plain(base, h, B, gm1, s))
        tiles = (math.ceil(m / kc.MM_FWD_TILE_ROWS)
                 * math.ceil(n / kc.MM_FWD_TILE_COLS))
        record("compose_mm_fwd", [m, n, RANK], e, mx, 2.0 ** -7,
               time_ms(lambda: kc.compose_mm_fwd(base, h, B, gm1, s)),
               time_ms(lambda: kc.compose_mm_fwd_plain(base, h, B, gm1, s)),
               2 * m * n * esz + (m + n) * RANK * esz + n * 4,
               2 * m * n * RANK / PEAK_OPS[bf] + 5 * m * n / F32_OPS,
               time_ms(lambda: h @ B.T), "h @ B.T",
               f"{kc.compose_mm_fwd_blocks(m, n)} persistent blocks over "
               f"{tiles} tiles of [{kc.MM_FWD_TILE_ROWS} x "
               f"{kc.MM_FWD_TILE_COLS}] (last column tile "
               f"{n - (n - 1) // kc.MM_FWD_TILE_COLS * kc.MM_FWD_TILE_COLS}"
               f" wide)",
               route="wgmma",
               device_ms=profiled_ms(
                   lambda: [kc.compose_mm_fwd(base, h, B, gm1, s)
                            for _ in range(10)],
                   "compose_mm_fwd_mma_kernel", 10,
                   f"compose_mm_fwd [{m}, {n}] x 10"),
               deterministic=bool(torch.equal(
                   out, kc.compose_mm_fwd(base, h, B, gm1, s))))
        del out, h
        dy = base
        d_base, d_h = kc.compose_mm_bwd(dy, B, gm1, gs)
        ref_b, ref_h = kc.compose_mm_bwd_plain(dy, B, gm1, gs)
        e, mx = max_err(d_h, ref_h)
        check(torch.equal(d_base, ref_b), f"compose_mm_bwd [{m}, {n}]: "
              f"d_base differs from the plain version")
        dys = (dy.float() * gs).to(dy.dtype)
        splits, split_n = kc.compose_mm_bwd_split(m, n, RANK)
        record("compose_mm_bwd", [m, n, RANK], e, mx, 1e-4,
               time_ms(lambda: kc.compose_mm_bwd(dy, B, gm1, gs)),
               time_ms(lambda: kc.compose_mm_bwd_plain(dy, B, gm1, gs)),
               2 * m * n * esz + n * RANK * esz + m * RANK * 4 + 2 * n * 4,
               2 * 2 * m * n * RANK / PEAK_OPS[bf] + 3 * m * n / F32_OPS,
               time_ms(lambda: dys @ B), "(dY*gs) @ B, bf16 product only",
               f"{splits} N splits of {split_n}",
               route=("wgmma" if _build.tensor_cores(
                   dy, B, gm1, gs, d_base, dims=(n, RANK)) else "fma"),
               d_base_bitwise_equal_plain=True,
               device_ms=profiled_ms(
                   lambda: [kc.compose_mm_bwd(dy, B, gm1, gs)
                            for _ in range(10)],
                   "compose_mm_bwd", 10, f"compose_mm_bwd [{m}, {n}] x 10"),
               deterministic=bool(torch.equal(
                   d_h, kc.compose_mm_bwd(dy, B, gm1, gs)[1])))
        del base, dy, B, d_base, d_h, ref_b, ref_h, dys
    torch.cuda.empty_cache()
    print("  compose_mm_fwd and compose_mm_bwd at every new arch d_out: ok",
          flush=True)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn()`` in microseconds: time.perf_counter
    over ``calls`` calls, with one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_checks(dev) -> dict:
    """Each wrapper's host time per call at a small shape, where the
    device's part is a few microseconds, under torch.no_grad() as the
    serving paths and the autograd Functions' passes call them; and, for
    scale, one PyTorch op (``index_select``, K8's yardstick)."""
    from repro_torch.kernels import dora_compose as kc
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka
    from repro_torch.kernels import paged_gather as kp
    from repro_torch.kernels import selective_scan as ks

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    m, n, r = 64, 512, 64
    W, A, B = randn(512, 512), randn(r, 512), randn(512, r)
    mat, h = randn(m, n), randn(m, r)
    vec = randn(n, dtype=f32)
    pool = randn(64, ENGINE_BLOCK, 4, 128)
    pages = torch.arange(16, device=dev, dtype=torch.int32).reshape(2, 8)
    ids = pages.reshape(-1).long()
    scan = (randn(1, 16, 128, dtype=f32).abs() * 0.01,
            randn(1, 16, 128, dtype=f32), randn(1, 16, 16, dtype=f32),
            randn(1, 16, 16, dtype=f32), -randn(16, 128, dtype=f32).abs(),
            randn(1, 16, 128, dtype=f32))
    scan_hc = randn(1, 1, 16, 128, dtype=f32)
    calls = {
        "norm_terms": lambda: kn.norm_terms(W, A, B),
        "assemble_norm": lambda: ka.assemble_norm(vec, vec, vec, 0.5),
        "compose_fwd": lambda: kc.compose_fwd(mat, mat, vec, 0.5),
        "compose_fwd_dual": lambda: kc.compose_fwd_dual(mat, mat, vec, 0.5),
        "compose_bwd": lambda: kc.compose_bwd(mat, vec, vec),
        "compose_mm_fwd": lambda: kc.compose_mm_fwd(mat, h, B, vec, 0.5),
        "compose_mm_bwd": lambda: kc.compose_mm_bwd(mat, B, vec, vec),
        "paged_gather": lambda: kp.paged_gather(pool, pages),
        "selective_scan": lambda: ks.selective_scan(*scan),
        "selective_scan_bwd": lambda: ks.selective_scan_bwd(
            *scan[:5], scan_hc, scan[1])}
    with torch.no_grad():
        out = {name: host_us(fn) for name, fn in calls.items()}
        out["index_select (PyTorch op)"] = host_us(
            lambda: pool.index_select(0, ids))
    print("host us per call (small shapes, 200 calls, one synchronize): "
          + json.dumps({k: round(v, 2) for k, v in out.items()}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Serving at full width.
# ---------------------------------------------------------------------------

def perturb_adapters(adapters, gen):
    """Nonzero B (normal x 0.02) and m = ||W||·(1 + 0.01·noise), so that
    g != 1 and the lora term is not zero."""
    for leaf in _adapter_leaves(adapters):
        B, m = leaf["B"], leaf["m"]
        leaf["B"] = (torch.randn(B.shape, generator=gen, device=B.device)
                     * 0.02).to(B.dtype)
        leaf["m"] = m * (1.0 + 0.01 * torch.randn(
            m.shape, generator=gen, device=m.device))
    return adapters


def _adapter_leaves(tree):
    if isinstance(tree, dict) and {"A", "B", "m"} <= set(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _adapter_leaves(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def serve_checks(dev) -> dict:
    """The main path (bf16, auto mode), then forced kernel mode, then the
    same weights upcast to fp32 for the logit-cosine criterion.

    Why fp32 for the criterion: with random weights every bf16 route sits
    about 1e-4 of cosine away from the exact logits (the rounding of some
    hundred bf16 activations per layer stack decorrelates once two routes
    differ by one ulp anywhere), so two bf16 routes cannot be held to
    cosine >= 0.9999 of each other. In fp32 the kernel route and the eager
    route must agree; in bf16 the kernel route must be no further from the
    fp32 eager logits than the bf16 eager route is (within 2x)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig

    mcfg = get_config(ARCH)
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "fused", "eager")}
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, cfg["auto"].dora, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    print(f"serve: built {ARCH} ({mcfg.num_layers} layers, d_model "
          f"{mcfg.d_model}, d_ff {mcfg.d_ff}, vocab {mcfg.vocab_size}, "
          f"{mcfg.dtype}) with r={RANK} DoRA on 7 targets in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))

    def prefill_logits(m, p, a, mode):
        _, lg = serve.generate(m, p, a, cfg[mode], prompts, gen_len=1,
                               max_len=MAX_LEN, device=dev,
                               return_logits=True)
        return lg[0].float()

    # Warm the path once (cuBLAS handles, allocator) outside the counts.
    prefill_logits(mcfg, params, adapters, "auto")

    # --- the main path: auto mode, bf16 ---
    torch.cuda.reset_peak_memory_stats(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    mma0 = kernels.compose_mm_fwd.mma_launches
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=stats)
    torch.cuda.synchronize()
    auto_counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_adapted = 7 * mcfg.num_layers
    check(auto_counts == counts_of(norm_terms=n_adapted,
                                   assembled=n_adapted,
                                   compose_mm_fwd=5 * mcfg.num_layers),
          f"auto-mode launch counts {auto_counts}")
    check_k6_on_tensor_cores(mma0, auto_counts, "serve auto")
    check(tuple(toks.shape) == (BATCH, PROMPT + GEN), f"tokens {toks.shape}")
    check(all(torch.isfinite(lg.float()).all().item() for lg in logits),
          "non-finite logits in the auto run")
    check(((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          "token ids out of range")
    serve_auto = {
        "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": peak, "launches": auto_counts}
    print("serve auto (bf16): " + json.dumps(serve_auto), flush=True)

    # --- forced kernel mode, bf16: K6 at every prefill projection, K3 at
    # every decode projection ---
    kernels.reset_launch_counts()
    fstats: dict = {}
    _, flogits = serve.generate(
        mcfg, params, adapters, cfg["fused"], prompts, gen_len=FORCED_GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=fstats)
    torch.cuda.synchronize()
    fused_counts = launch_counts()
    check(fused_counts == counts_of(norm_terms=n_adapted,
                                    assembled=n_adapted,
                                    compose_fwd=n_adapted * FORCED_GEN,
                                    compose_mm_fwd=n_adapted),
          f"forced-mode launch counts {fused_counts}")
    serve_fused = {"prefill_ms": fstats["prefill_s"] * 1e3,
                   "decode_ms_per_token":
                       fstats["decode_s"] * 1e3 / FORCED_GEN,
                   "launches": fused_counts}

    # --- eager route, bf16: no kernel may launch ---
    kernels.reset_launch_counts()
    eager_bf16 = prefill_logits(mcfg, params, adapters, "eager")
    check(sum(launch_counts().values()) == 0,
          "the eager route launched a kernel")

    # --- the same weights in fp32: the paper's cosine criterion ---
    mcfg32 = dataclasses.replace(mcfg, dtype=torch.float32)
    p32 = _tree_map(lambda t: t.float(), params)
    a32 = _tree_map(lambda t: t.float(), adapters)
    kernels.reset_launch_counts()
    auto32 = prefill_logits(mcfg32, p32, a32, "auto")
    check(launch_counts()["compose_mm_fwd"] == 5 * mcfg.num_layers,
          "fp32 auto run did not take the matmul-fused kernel")
    fused32 = prefill_logits(mcfg32, p32, a32, "fused")
    eager32 = prefill_logits(mcfg32, p32, a32, "eager")
    del p32, a32
    cos = {
        "fp32_auto_vs_eager": cosine(auto32, eager32),
        "fp32_fused_vs_auto": cosine(fused32, auto32),
        "bf16_auto_vs_bf16_eager": cosine(logits[0], eager_bf16),
        "bf16_fused_vs_bf16_auto": cosine(flogits[0], logits[0]),
        "bf16_auto_vs_fp32_eager": cosine(logits[0], eager32),
        "bf16_eager_vs_fp32_eager": cosine(eager_bf16, eager32),
    }
    print("serve fused (bf16): " + json.dumps(serve_fused), flush=True)
    print("prefill logit cosines: " + json.dumps(cos), flush=True)
    check(cos["fp32_auto_vs_eager"] >= COSINE_MIN,
          f"fp32 kernel route vs eager route cosine "
          f"{cos['fp32_auto_vs_eager']}")
    check(cos["fp32_fused_vs_auto"] >= COSINE_MIN,
          f"fp32 forced vs auto cosine {cos['fp32_fused_vs_auto']}")
    check(1 - cos["bf16_auto_vs_fp32_eager"]
          <= 2 * (1 - cos["bf16_eager_vs_fp32_eager"]) + 1e-9,
          "bf16 kernel route is further from the fp32 logits than the bf16 "
          "eager route")
    torch.cuda.empty_cache()
    return ({"auto": auto_counts, "fused": fused_counts,
             "serve_auto": serve_auto, "serve_fused": serve_fused,
             "cosines": cos}, mcfg, params, adapters)


# ---------------------------------------------------------------------------
# Multi-tenant serving at full width.
# ---------------------------------------------------------------------------

# Three tenants, two rows each (BENCH_serve.json multi_tenant.rows), the
# serve phase's prompt length, max_len and token count; the fp32 parities
# at MT_PARITY_LAYERS layers over MT_PARITY_GEN tokens.
MT_TENANTS, MT_ROWS = 3, 2
MT_PARITY_LAYERS, MT_PARITY_GEN, MT_CLI_GEN = 2, 4, 8


def _tenant_adapters(mcfg, params, dcfg, t: int, dev):
    """Tenant t's adapters: the DoRA init, then perturbed (B != 0, g != 1)
    from its own seeded generator."""
    from repro_torch.models.lm import init_adapters

    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + t)
    return perturb_adapters(init_adapters(gen, mcfg, params, dcfg), gen)


def _held_bytes(state, raw) -> int:
    """Bytes of ``state``'s leaves whose storage the raw (registry) tree
    does not already hold: what the state adds on the card."""
    shared = {t.untyped_storage().data_ptr() for t in _leaves_sorted(raw)}
    return sum(t.numel() * t.element_size() for t in _leaves_sorted(state)
               if t.untyped_storage().data_ptr() not in shared)


def serve_mt_checks(dev, mcfg, params) -> dict:
    """qwen2-7b at full width and depth serving three r=384 tenants in one
    batch through ``MultiTenantServer`` (the grouped gsB compose over an
    ``AdapterStateCache``): a cold call (3 misses: K1 with its epilogue
    3 x 196 times), a warm call (3 hits: no kernel), the single-tenant
    cached + gsB baseline at the same batch of 6, the host tier (spill,
    bitwise reload, reload ms against precompute ms), the fp32 parities
    at 2 layers (mixed batch against each tenant alone, a module's grouped
    delta bitwise the homogeneous path's, dynamic against static
    grouping) and the ``--tenants`` CLI."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core.adapter import (dora_linear_grouped, gsb_delta,
                                          stack_adapter_states)
    from repro_torch.core.adapter_cache import (AdapterStateCache,
                                                serving_state_nbytes)
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    n_adapted = 7 * mcfg.num_layers
    batch = MT_TENANTS * MT_ROWS
    tenants = [_tenant_adapters(mcfg, params, scfg.dora, t, dev)
               for t in range(MT_TENANTS)]
    # Rows 0-2 share one prompt under the three tenants; owners interleave,
    # so the server's sort permutes the batch.
    prompts = np.random.default_rng(SEED + 7).integers(
        0, mcfg.vocab_size, (batch, PROMPT))
    prompts[1:MT_TENANTS] = prompts[0]
    owners = [i % MT_TENANTS for i in range(batch)]
    requests = [serve.Request(p, f"tenant-{t}")
                for p, t in zip(prompts, owners)]
    out: dict = {"tenants": MT_TENANTS, "batch": batch, "prompt": PROMPT,
                 "max_len": MAX_LEN, "gen": GEN}

    def run_record(stats, toks, peak, launched):
        rec = {"prefill_ms": stats["prefill_s"] * 1e3,
               "decode_ms_per_step": stats["decode_s"] * 1e3 / GEN,
               "decode_tok_per_s": batch * GEN / stats["decode_s"],
               "max_memory_allocated_bytes": peak, "launches": launched}
        for k in ("precompute_s", "stack_s"):
            if k in stats:
                rec[k.replace("_s", "_ms")] = stats[k] * 1e3
        check(tuple(toks.shape) == (batch, PROMPT + GEN),
              f"tokens {tuple(toks.shape)}")
        check(((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
              "token ids out of range")
        return rec

    # --- the single-tenant cached + gsB baseline, same batch of 6, after
    # one untimed call at these shapes (cuBLAS handles, the allocator) ---
    folded = make_precompute_step(mcfg, scfg, fold_gsb=True)(params,
                                                             tenants[0])
    serve.generate(mcfg, params, folded, scfg, prompts, gen_len=1,
                   max_len=MAX_LEN, cache_adapters=False, device=dev)
    _reset_peak(dev)
    kernels.reset_launch_counts()
    stats: dict = {}
    toks = serve.generate(mcfg, params, folded, scfg, prompts, gen_len=GEN,
                          max_len=MAX_LEN, cache_adapters=False, device=dev,
                          stats=stats)
    _sync(dev)
    launched = launch_counts()
    check(launched == counts_of(), f"single-tenant gsB launches {launched}")
    out["single_tenant_gsb"] = run_record(stats, toks, _peak(dev), launched)
    out["single_tenant_gsb"]["profile"] = profile(
        lambda: serve.generate(mcfg, params, folded, scfg, prompts,
                               gen_len=1, max_len=MAX_LEN,
                               cache_adapters=False, device=dev),
        "serve_mt single-tenant gsB (prefill + 1 step)")
    del folded, toks

    # --- cold: three misses, one batch; then warm: three hits ---
    cache = AdapterStateCache.for_serving(mcfg, scfg, device=dev)
    for t, ad in enumerate(tenants):
        cache.register(f"tenant-{t}", ad)
    server = serve.MultiTenantServer(mcfg, scfg, params, cache=cache,
                                     device=dev)
    toks = {}
    for run, want in (("cold", counts_of(norm_terms=MT_TENANTS * n_adapted,
                                         assembled=MT_TENANTS * n_adapted)),
                      ("warm", counts_of())):
        _reset_peak(dev)
        kernels.reset_launch_counts()
        stats = {}
        toks[run] = server.serve(requests, gen_len=GEN, max_len=MAX_LEN,
                                 stats=stats)
        _sync(dev)
        launched = launch_counts()
        check(launched == want, f"serve_mt {run} launches {launched}")
        out[run] = run_record(stats, toks[run], _peak(dev), launched)
        out[run]["cache"] = cache.stats().as_dict()
    check(out["cold"]["cache"]["misses"] == MT_TENANTS
          and out["warm"]["cache"]["hits"] == MT_TENANTS,
          f"cache counters {out['warm']['cache']}")
    check(torch.equal(toks["cold"], toks["warm"]),
          "cold and warm calls served different tokens")
    out["warm"]["profile"] = profile(
        lambda: server.serve(requests, gen_len=1, max_len=MAX_LEN),
        "serve_mt warm (prefill + 1 step)")
    gen_part = toks["warm"][:MT_TENANTS, PROMPT:]
    for a in range(MT_TENANTS):
        for b in range(a + 1, MT_TENANTS):
            check(not torch.equal(gen_part[a], gen_part[b]),
                  f"tenants {a} and {b} greedy tokens are equal on the "
                  f"shared prompt")
    state0 = cache.get_state(params, cache.current_handle("tenant-0"))
    nbytes = serving_state_nbytes(state0)
    out["state_nbytes"] = nbytes
    out["state_held_bytes"] = _held_bytes(state0,
                                          cache.adapters("tenant-0"))
    print("serve_mt: " + json.dumps(out), flush=True)
    del server, cache, state0, toks
    _empty_cache(dev)

    # --- the host tier: two states on the card, three on the host ---
    tier = AdapterStateCache.for_serving(mcfg, scfg, device=dev,
                                         max_bytes=2 * nbytes,
                                         host_max_bytes=3 * nbytes)
    handles = [tier.register(f"tenant-{t}", ad)
               for t, ad in enumerate(tenants)]
    marks: dict = {}

    def on_event(kind, key):
        _sync(dev)
        marks.setdefault(kind, time.perf_counter())

    tier.on_event = on_event
    t0 = time.perf_counter()
    first = tier.get_state(params, handles[0])
    _sync(dev)
    precompute_ms = (time.perf_counter() - t0) * 1e3
    for h in handles[1:]:
        tier.get_state(params, h)       # the third spills tenant 0
    check(tier.is_spilled(handles[0]), "tenant 0 was not spilled")
    t0 = time.perf_counter()
    reloaded = tier.get_state(params, handles[0])
    _sync(dev)
    t1 = time.perf_counter()
    st = tier.stats()
    check(st.spills == 2 and st.reloads == 1 and st.misses == MT_TENANTS,
          f"host tier counters {st}")
    flat_a, flat_b = _leaves_sorted(first), _leaves_sorted(reloaded)
    check(len(flat_a) == len(flat_b) and all(
        a.device == b.device and torch.equal(a, b)
        for a, b in zip(flat_a, flat_b)),
        "a reloaded state is not bitwise the precomputed one")
    out["host_tier"] = {
        "precompute_ms": precompute_ms,
        "reload_ms": (marks["reload"] - t0) * 1e3,
        "spill_ms": (t1 - marks["reload"]) * 1e3,
        "state_nbytes": nbytes, "cache": st.as_dict()}
    print("serve_mt host tier: " + json.dumps(out["host_tier"]), flush=True)
    del tier, first, reloaded, flat_a, flat_b
    _empty_cache(dev)

    # --- fp32 at 2 layers: mixed batch vs each tenant alone ---
    n = MT_PARITY_LAYERS
    m32 = dataclasses.replace(mcfg, num_layers=n, dtype=torch.float32)
    p32 = _upcast_layers(params, n)
    cache32 = AdapterStateCache.for_serving(m32, scfg, device=dev)
    for t, ad in enumerate(tenants):
        cache32.register(f"tenant-{t}", _upcast_layers(ad, n))
    server32 = serve.MultiTenantServer(m32, scfg, p32, cache=cache32,
                                       device=dev)
    mtoks, mlogits = server32.serve(requests, gen_len=MT_PARITY_GEN,
                                    max_len=MAX_LEN, return_logits=True)
    parity = {"tokens_equal": True, "max_rel_logit_err": 0.0}
    for t in range(MT_TENANTS):
        rows = [i for i, o in enumerate(owners) if o == t]
        stoks, slogits = serve.generate(
            m32, p32, cache32.current_handle(f"tenant-{t}"), scfg,
            prompts[rows], gen_len=MT_PARITY_GEN, max_len=MAX_LEN,
            adapter_cache=cache32, return_logits=True, device=dev)
        parity["tokens_equal"] &= torch.equal(stoks, mtoks[rows])
        for s in range(MT_PARITY_GEN):
            err, mx = max_err(mlogits[s][rows], slogits[s])
            parity["max_rel_logit_err"] = max(parity["max_rel_logit_err"],
                                              err / mx)
    check(parity["tokens_equal"], "fp32 mixed batch tokens differ from "
          "each tenant served alone")
    check(parity["max_rel_logit_err"] <= 1e-5,
          f"fp32 mixed batch logits {parity['max_rel_logit_err']} of max "
          f"from each tenant served alone")

    # one module, w_gate of layer 0: the grouped delta against the
    # homogeneous gsB path, and the dynamic form against the static one
    states = [cache32.get_state(p32, cache32.current_handle(f"tenant-{t}"))
              ["stack"]["l0"]["ffn"]["w_gate"] for t in range(MT_TENANTS)]
    mods = [{k: v[0] for k, v in st.items()} for st in states]
    stacked = stack_adapter_states(mods, axis=0)
    W = p32["stack"]["l0"]["ffn"]["w_gate"][0]
    groups = tuple((k * MT_ROWS, MT_ROWS) for k in range(MT_TENANTS))
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for seq in (1, MAX_LEN):
        x = torch.randn((batch, seq, mcfg.d_model), generator=gen,
                        device=dev)
        yg = dora_linear_grouped(x, W, stacked, scfg.dora, groups)
        y_base = x @ W.T
        for k, (s, r) in enumerate(groups):
            rows = slice(s, s + r)
            delta = gsb_delta(y_base[rows], x[rows] @ mods[k]["A"].T,
                              mods[k]["g"], mods[k]["gsB"])
            check(torch.equal(yg[rows], y_base[rows] + delta),
                  f"grouped delta of tenant {k} at seq {seq} is not the "
                  f"homogeneous gsB path's")
        if seq == 1:
            idx = torch.arange(MT_TENANTS, device=dev).repeat_interleave(
                MT_ROWS)
            yd = dora_linear_grouped(x, W, stacked, scfg.dora, idx)
            err, mx = max_err(yd, yg)
            parity["dynamic_vs_static_rel_err"] = err / mx
            check(err <= 1e-6 * mx, f"dynamic vs static grouped w_gate "
                  f"{err / mx} of max")
    out["fp32_parity"] = parity
    print(f"serve_mt fp32 parity ({n} layers): " + json.dumps(parity),
          flush=True)
    del cache32, server32, p32, states, mods, stacked, tenants, W, x, yg
    _empty_cache(dev)

    # --- the --tenants CLI at full width (its own params and tenants) ---
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    serve.main(["--arch", ARCH, "--tenants", str(MT_TENANTS),
                "--batch", str(MT_ROWS), "--prompt-len", str(PROMPT),
                "--gen-len", str(MT_CLI_GEN), "--rank", str(RANK),
                "--alpha", str(ALPHA), "--seed", str(SEED)])
    _sync(dev)
    launched = launch_counts()
    check(launched == counts_of(norm_terms=MT_TENANTS * n_adapted,
                                assembled=MT_TENANTS * n_adapted),
          f"--tenants CLI launches {launched}")
    out["cli_s"] = time.perf_counter() - t0
    _empty_cache(dev)
    return out


# ---------------------------------------------------------------------------
# The continuous-batching engine at full width.
# ---------------------------------------------------------------------------

# make_arrival_trace, make_longcontext_trace, simulate_continuous and
# simulate_paged are copies of benchmarks/serve_bench.py's (which imports
# jax); simulate_paged also counts its chunk steps.

def make_arrival_trace(*, n_requests=12, mean_interarrival=2.0,
                       prompt_len=8, gen_lens=(4, 6, 8, 10), seed=0):
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(mean_interarrival)
        reqs.append({"arrival_step": int(t),
                     "prompt_len": int(prompt_len),
                     "gen_len": int(rng.choice(gen_lens))})
    return reqs


def make_longcontext_trace(trace_params, *, long_arrival: int,
                           long_prompt_len: int, long_gen_len: int):
    trace = make_arrival_trace(**trace_params)
    req = {"arrival_step": int(long_arrival),
           "prompt_len": int(long_prompt_len),
           "gen_len": int(long_gen_len)}
    idx = next((i for i, r in enumerate(trace)
                if r["arrival_step"] > long_arrival), len(trace))
    trace.insert(idx, req)
    return trace


def simulate_continuous(trace, *, slots: int) -> dict:
    from collections import deque
    queue: deque = deque()
    table = [None] * slots
    i, step = 0, 0
    decode_steps = prefills = generated = slot_steps = 0
    n = len(trace)

    def has_work():
        return bool(queue) or any(v is not None for v in table)

    while i < n or has_work():
        while i < n and trace[i]["arrival_step"] <= step:
            queue.append(trace[i])
            i += 1
        for j in range(slots):
            while table[j] is None and queue:
                r = queue.popleft()
                prefills += 1
                generated += 1
                if r["gen_len"] - 1 > 0:
                    table[j] = r["gen_len"] - 1
        active = [j for j in range(slots) if table[j] is not None]
        if active:
            decode_steps += 1
            slot_steps += len(active)
            for j in active:
                generated += 1
                table[j] -= 1
                if table[j] == 0:
                    table[j] = None
        step += 1
    occ = slot_steps / (decode_steps * slots) if decode_steps else 0.0
    return {"steps": step, "decode_steps": decode_steps,
            "prefills": prefills, "generated_tokens": generated,
            "slot_steps": slot_steps, "mean_occupancy": occ}


def simulate_paged(trace, *, slots: int, max_len: int, block_size: int,
                   n_blocks: int, chunk: int) -> dict:
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} % block_size={block_size}")
    max_blocks = max_len // block_size
    if n_blocks < max_blocks:
        raise ValueError(f"n_blocks={n_blocks} < max_blocks={max_blocks}")
    from collections import deque
    queue: deque = deque()
    rows = [None] * slots
    i, step = 0, 0
    decode_steps = prefills = generated = slot_steps = chunk_steps = 0
    free, used, peak_used = n_blocks, 0, 0
    resident_block_steps = deferral_ticks = 0
    n = len(trace)

    def blocks_for(upto):
        return -(-upto // block_size)

    def retire(j):
        nonlocal free, used
        free += rows[j]["blocks"]
        used -= rows[j]["blocks"]
        rows[j] = None

    def has_work():
        return bool(queue) or any(r is not None for r in rows)

    while i < n or has_work():
        while i < n and trace[i]["arrival_step"] <= step:
            queue.append(trace[i])
            i += 1
        for j in range(slots):
            if rows[j] is None and queue:
                r = queue[0]
                need = blocks_for(r["prompt_len"] + 1)
                if free < need:
                    deferral_ticks += 1
                    break
                queue.popleft()
                free -= need
                used += need
                peak_used = max(peak_used, used)
                rows[j] = {"p": r["prompt_len"], "budget": r["gen_len"],
                           "chunk_next": 0, "prefilling": True,
                           "pos": 0, "blocks": need, "emitted": 0}
        for j in range(slots):
            s = rows[j]
            if s is None or not s["prefilling"]:
                continue
            chunk_steps += 1
            if s["p"] - s["chunk_next"] <= chunk:
                s["prefilling"] = False
                s["pos"] = s["p"]
                prefills += 1
                generated += 1
                s["emitted"] = 1
                if s["emitted"] == s["budget"]:
                    retire(j)
            else:
                s["chunk_next"] += chunk
        active = [j for j in range(slots)
                  if rows[j] is not None and not rows[j]["prefilling"]]
        if active:
            for j in active:
                s = rows[j]
                need = blocks_for(s["pos"] + 1)
                grow = need - s["blocks"]
                if grow > 0:
                    if free < grow:
                        raise RuntimeError(
                            "simulate_paged does not model reclaim "
                            "preemption — size n_blocks above the "
                            "trace's peak demand")
                    free -= grow
                    used += grow
                    s["blocks"] = need
                    peak_used = max(peak_used, used)
            decode_steps += 1
            slot_steps += len(active)
            for j in active:
                s = rows[j]
                generated += 1
                s["emitted"] += 1
                s["pos"] += 1
                if s["emitted"] == s["budget"]:
                    retire(j)
        resident_block_steps += used
        step += 1
    occ = slot_steps / (decode_steps * slots) if decode_steps else 0.0
    return {"steps": step, "decode_steps": decode_steps,
            "prefills": prefills, "generated_tokens": generated,
            "slot_steps": slot_steps, "mean_occupancy": occ,
            "peak_used_blocks": peak_used,
            "resident_block_steps": resident_block_steps,
            "mean_resident_blocks":
                resident_block_steps / step if step else 0.0,
            "deferral_ticks": deferral_ticks, "chunk_steps": chunk_steps}


def committed_trace(section: str):
    """(trace, engine kwargs, committed model, simulated model) of a
    ``BENCH_serve.json`` section, the trace rebuilt from its parameters."""
    sec = json.loads((Path(__file__).resolve().parent
                      / "BENCH_serve.json").read_text())[section]
    tp = dict(sec["trace"])
    slots, max_len = tp.pop("slots"), tp.pop("max_len")
    kw = {"slots": slots, "max_len": max_len}
    if section == "continuous":
        trace = make_arrival_trace(**tp)
        return trace, kw, sec["engine_model"], simulate_continuous(
            trace, slots=slots)
    paged = {k: tp.pop(k) for k in ("block_size", "n_blocks",
                                    "prefill_chunk")}
    trace = make_longcontext_trace(
        tp, **{k: tp.pop(k) for k in ("long_arrival", "long_prompt_len",
                                      "long_gen_len")})
    kw.update(paged=True, **paged)
    return trace, kw, sec["schedule_model"], simulate_paged(
        trace, slots=slots, max_len=max_len, block_size=paged["block_size"],
        n_blocks=paged["n_blocks"], chunk=paged["prefill_chunk"])


def realistic_trace():
    """The long-prompt trace: prompts uniform in ENGINE_PROMPT, ENGINE_NEW
    new tokens each, exponential arrivals of mean ENGINE_ARRIVAL ticks."""
    rng = np.random.default_rng(SEED)
    t, reqs = 0.0, []
    lo, hi = ENGINE_PROMPT
    for _ in range(ENGINE_REQUESTS):
        t += rng.exponential(ENGINE_ARRIVAL)
        reqs.append({"arrival_step": int(t),
                     "prompt_len": int(rng.integers(lo, hi + 1)),
                     "gen_len": ENGINE_NEW})
    return reqs


def drive_engine(engine, trace, vocab: int, *, timed: bool = False,
                 adapters=None) -> dict:
    """Submit each request of ``trace`` as its arrival step comes due and
    tick once per step (the arrival loop of the committed models). Returns
    the token streams and the wall seconds; with ``timed``, also the wall
    ms of every decode, chunk, prefill-into-slot, draft and verify step
    and of every logits fetch (the verify's apart), each between device
    synchronisations.
    ``adapters``: the adapter id of each request (a cache-routed
    engine)."""
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, vocab, r["prompt_len"]) for r in trace]
    streams: dict = {}
    times: dict = {"decode": [], "prefill_chunk": [], "prefill_into_slot": [],
                   "draft": [], "verify": [], "fetch": [],
                   "verify_fetch": []}
    if timed:
        dev = engine.device     # not the engine: no reference cycle

        def timer(name, fn):
            def call(*a, **k):
                _sync(dev)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                _sync(dev)
                key = name(a) if callable(name) else name
                times[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        engine._decode = timer("decode", engine._decode)
        if engine._paged:
            engine._chunk_prefill = timer("prefill_chunk",
                                          engine._chunk_prefill)
        else:
            engine._prefill = timer("prefill_into_slot", engine._prefill)
        if engine.speculative_k:
            engine._draft = timer("draft", engine._draft)
            engine._verify = timer("verify", engine._verify)
        engine._fetch = timer(
            lambda a: "verify_fetch" if a[0].ndim == 3 else "fetch",
            engine._fetch)

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(tok)

    _sync(engine.device)
    t0 = time.perf_counter()
    i, step = 0, 0
    while i < len(trace) or engine.has_work():
        while i < len(trace) and trace[i]["arrival_step"] <= step:
            engine.submit(prompts[i], max_new_tokens=trace[i]["gen_len"],
                          key_id=i,
                          adapter=None if adapters is None else adapters[i])
            i += 1
        engine.step(on_token)
        step += 1
    _sync(engine.device)
    return {"streams": streams, "wall_s": time.perf_counter() - t0,
            "times_ms": times}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated(dev)
    return None


def _empty_cache(dev) -> None:
    if torch.device(dev).type == "cuda":
        # An engine whose steps drive_engine or capture_logits wrapped
        # holds itself through those bound methods: collect such cycles
        # before the allocator returns their memory.
        gc.collect()
        torch.cuda.empty_cache()


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def engine_checks(dev, mcfg, params, adapters) -> dict:
    """The engine phases at the model's full width (bf16, r = 384 DoRA):

    - the main path: the serving precompute (K1 with its epilogue) and
      the paged engine
      on the realistic trace, launch counts exact, the pool drained;
    - the same engine with the plain gather (``mode="eager"``, the only
      route the engine's dispatch decides with a folded serving tree):
      bitwise the same streams and schedule, no kernel launched;
    - both committed traces: counters equal ``BENCH_serve.json``'s models
      (and this file's copies of their simulators), K8 launched exactly
      twice per layer and device step on the paged one."""
    from repro_torch import kernels
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    L = mcfg.num_layers
    n_adapted = 7 * L
    auto, eager = (StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                              mode=mode))
                   for mode in ("auto", "eager"))
    paged_kw = dict(slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, paged=True,
                    block_size=ENGINE_BLOCK, n_blocks=ENGINE_BLOCKS,
                    prefill_chunk=ENGINE_CHUNK, device=dev)
    trace = realistic_trace()

    # --- the main path: precompute, then the paged engine at length ---
    _sync(dev)
    _reset_peak(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = make_precompute_step(mcfg, auto, fold_gsb=True)(params,
                                                            adapters)
    _sync(dev)
    precompute_ms = (time.perf_counter() - t0) * 1e3
    engine = DecodeEngine(mcfg, auto, params, adapters=state, **paged_kw)
    run = drive_engine(engine, trace, mcfg.vocab_size, timed=True)
    counts = launch_counts()
    peak = _peak(dev)
    steps = engine.device_steps()
    st, ps = engine.stats(), engine.pool_stats()
    check(counts == counts_of(norm_terms=n_adapted, assembled=n_adapted,
                              paged_gather=2 * L * (steps["decode"]
                                                    + steps["prefill_chunk"])),
          f"engine main-path launch counts {counts} (device steps {steps})")
    check(ps["used_blocks"] == 0 and ps["per_slot_blocks"]
          == [0] * ENGINE_SLOTS, f"engine pool did not drain: {ps}")
    check(st.generated_tokens == ENGINE_REQUESTS * ENGINE_NEW
          and st.retired == ENGINE_REQUESTS
          and all(len(v) == ENGINE_NEW for v in run["streams"].values()),
          f"engine generated {st.generated_tokens} tokens, "
          f"retired {st.retired}")
    check(all(0 <= t < mcfg.vocab_size for v in run["streams"].values()
              for t in v), "engine token ids out of range")
    # One decode tick with every slot active, profiled after the counts
    # were read: 8 prompts of 768 tokens admitted, one warm tick, then the
    # profiled one.
    rng = np.random.default_rng(SEED + 2)
    for _ in range(ENGINE_SLOTS):
        engine.submit(rng.integers(0, mcfg.vocab_size, 768),
                      max_new_tokens=8)
    while engine._queue or any(s.prefilling for s in engine._slots):
        engine.step()
    engine.step()
    tick_profile = profile(engine.step, "engine decode tick (8 rows, bf16)")
    engine.run()
    main = {
        "trace": {"requests": ENGINE_REQUESTS, "prompt_len": ENGINE_PROMPT,
                  "new_tokens": ENGINE_NEW,
                  "mean_interarrival_ticks": ENGINE_ARRIVAL,
                  "slots": ENGINE_SLOTS, "max_len": ENGINE_MAX_LEN,
                  "block_size": ENGINE_BLOCK, "n_blocks": ENGINE_BLOCKS,
                  "prefill_chunk": ENGINE_CHUNK,
                  "prompt_tokens": sum(r["prompt_len"] for r in trace)},
        "ticks": st.steps, "decode_steps": st.decode_steps,
        "chunk_steps": steps["prefill_chunk"],
        "preemptions": st.preemptions,
        "peak_used_blocks": ps["peak_used_blocks"],
        "mean_occupancy": st.mean_occupancy,
        "precompute_ms": precompute_ms,
        "decode_ms_per_tick": _mean(run["times_ms"]["decode"]),
        "chunk_step_ms": _mean(run["times_ms"]["prefill_chunk"]),
        "wall_s": run["wall_s"],
        "tokens_per_s": st.generated_tokens / run["wall_s"],
        "max_memory_allocated_bytes": peak, "launches": counts,
        "decode_tick_profile": tick_profile}
    print("engine paged, realistic length (bf16): " + json.dumps(main),
          flush=True)

    # --- the same engine with the plain gather: bitwise the same ---
    kernels.reset_launch_counts()
    plain = DecodeEngine(mcfg, eager, params, adapters=state, **paged_kw)
    plain_run = drive_engine(plain, trace, mcfg.vocab_size)
    check(sum(launch_counts().values()) == 0,
          f"the plain-gather engine launched {launch_counts()}")
    check(plain_run["streams"] == run["streams"],
          "K8 engine streams differ from the plain-gather engine's")
    check(plain.stats() == st, "the plain-gather engine ran another schedule")
    main["plain_gather_wall_s"] = plain_run["wall_s"]
    del engine, plain

    # --- the committed traces ---
    traces = {}
    for section in ("continuous", "paged"):
        trace_c, kw, model, sim = committed_trace(section)
        kernels.reset_launch_counts()
        engine = DecodeEngine(mcfg, auto, params, adapters=state, device=dev,
                              **kw)
        run_c = drive_engine(engine, trace_c, mcfg.vocab_size)
        st_c, steps_c = engine.stats(), engine.device_steps()
        counts_c = launch_counts()
        rec = {"stats": st_c.as_dict(), "device_steps": steps_c,
               "wall_s": run_c["wall_s"], "launches": counts_c}
        for field in ("steps", "decode_steps", "prefills",
                      "generated_tokens", "slot_steps"):
            check(sim[field] == model[field],
                  f"{section}: simulator {field}={sim[field]}, "
                  f"BENCH_serve.json {model[field]}")
            check(getattr(st_c, field) == model[field],
                  f"{section} engine {field}={getattr(st_c, field)}, "
                  f"BENCH_serve.json {model[field]}")
        if section == "paged":
            ps_c = engine.pool_stats()
            rec["pool"] = ps_c
            check(ps_c["peak_used_blocks"] == model["peak_used_blocks"]
                  == sim["peak_used_blocks"],
                  f"paged peak {ps_c['peak_used_blocks']} blocks, "
                  f"BENCH_serve.json {model['peak_used_blocks']}")
            check(ps_c["used_blocks"] == 0, f"paged pool leaked: {ps_c}")
            check(steps_c["prefill_chunk"] == sim["chunk_steps"],
                  f"paged chunk steps {steps_c} vs {sim['chunk_steps']}")
            want = counts_of(paged_gather=2 * L * (
                sim["decode_steps"] + sim["chunk_steps"]))
        else:
            want = counts_of()
        check(counts_c == want, f"{section} launch counts {counts_c}, "
              f"want {want}")
        traces[section] = rec
        print(f"engine {section} trace (bf16): " + json.dumps(rec),
              flush=True)
        del engine
    del state
    _empty_cache(dev)
    return {"engine_paged": main, "traces": traces,
            "realistic_streams": run["streams"]}


def engine_parity(dev, mcfg, params, adapters) -> dict:
    """Paged == rectangular greedy streams over the committed paged trace
    in fp32 at full width and AGREE_LAYERS layers on the card; then a
    2-layer fp32 paged engine on the card and on the CPU (the kernels'
    plain versions): the same streams."""
    import dataclasses

    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step
    from repro_torch.models.config import ModelConfig

    trace, kw, _, _ = committed_trace("paged")
    rect_kw = {"slots": kw["slots"], "max_len": kw["max_len"]}
    out = {}
    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    mcfg32 = dataclasses.replace(mcfg, num_layers=AGREE_LAYERS,
                                 dtype=torch.float32)
    p32 = _upcast_layers(params, AGREE_LAYERS)
    state = make_precompute_step(mcfg32, scfg, fold_gsb=True)(
        p32, _upcast_layers(adapters, AGREE_LAYERS))
    streams = {}
    for name, extra in (("rect", rect_kw), ("paged", kw)):
        engine = DecodeEngine(mcfg32, scfg, p32, adapters=state, device=dev,
                              **extra)
        streams[name] = drive_engine(engine, trace,
                                     mcfg.vocab_size)["streams"]
    check(streams["paged"] == streams["rect"],
          "fp32 paged engine streams differ from the rectangular engine's")
    out["fp32_paged_equals_rect"] = {
        "layers": AGREE_LAYERS, "requests": len(streams["paged"]),
        "tokens": sum(len(v) for v in streams["paged"].values())}
    del state, p32
    _empty_cache(dev)

    small = ModelConfig(name="parity-2l", family="dense", num_layers=2,
                        d_model=256, num_heads=2, num_kv_heads=1, d_ff=512,
                        vocab_size=512, qkv_bias=True, attn_chunk=16,
                        dtype=torch.float32)
    sm_cfg = StepConfig(dora=DoRAConfig(rank=16, alpha=32.0, mode="fused"))
    p_cpu, a_cpu = serve.build_state(small, sm_cfg.dora, SEED, "cpu")
    a_cpu = perturb_adapters(a_cpu, torch.Generator().manual_seed(SEED + 1))
    streams = {}
    for where in ("cpu", dev):
        p = _tree_map(lambda t: t.to(where), p_cpu)
        a = _tree_map(lambda t: t.to(where), a_cpu)
        state = make_precompute_step(small, sm_cfg, fold_gsb=True)(p, a)
        engine = DecodeEngine(small, sm_cfg, p, adapters=state, device=where,
                              **kw)
        streams[str(where)] = drive_engine(engine, trace, 512)["streams"]
    check(streams["cpu"] == streams[str(dev)],
          "2-layer engine streams differ between the card and the CPU")
    out["small_card_vs_cpu"] = {"layers": 2, "tokens": sum(
        len(v) for v in streams["cpu"].values())}
    print("engine parity: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Speculative decoding and the fault plan in the engine.
# ---------------------------------------------------------------------------

SPEC_K = 3
SPEC_LADDER = dict(spec_accept_floor=0.99, spec_window=2,
                   spec_reenable_after=2)
SPEC_LAYERS = 2
FAULT_REQUESTS, FAULT_NEW, FAULT_SLOW_S = 8, 16, 0.05


def speculative_trace():
    """(trace, slots, max_len, k, committed model) of ``BENCH_serve.json``'s
    ``speculative`` section, the trace rebuilt from its parameters."""
    sec = json.loads((Path(__file__).resolve().parent
                      / "BENCH_serve.json").read_text())["speculative"]
    tp = dict(sec["trace"])
    slots, max_len, k = tp.pop("slots"), tp.pop("max_len"), tp.pop("k")
    tp.pop("degraded_accept_rate")
    return (make_arrival_trace(**tp), slots, max_len, k,
            sec["speculative_model"])


def _identity_tree(params, adapters, dcfg):
    """``params``/``adapters`` walked together: every adapter leaf gets
    B = 0 and m = the row norm of W + s·0·A, per layer slice."""
    from repro_torch.core.adapter import compute_weight_norm

    if isinstance(adapters, dict) and {"A", "B", "m"} <= set(adapters):
        B = torch.zeros_like(adapters["B"])
        base_sq = adapters.get("base_sq")
        m = torch.stack([compute_weight_norm(
            params[i], adapters["A"][i], B[i], dcfg,
            base_sq_cache=None if base_sq is None else base_sq[i])
            for i in range(params.shape[0])])
        return {**adapters, "B": B, "m": m.to(adapters["m"].dtype)}
    return {k: _identity_tree(params[k], v, dcfg)
            for k, v in adapters.items()}


def spec_checks(dev, mcfg, params, adapters, plain_main) -> tuple:
    """The speculative engine (k = 3).

    (a) fp32 at SPEC_LAYERS layers of the full width, the committed
        ``speculative`` trace, rectangular and paged: with identity
        adapters (g == 1 exactly, asserted) the seven counters equal
        ``speculative_model`` and the streams equal the plain engine's;
        with the perturbed adapters and the ladder (floor 0.99, window 2,
        re-enable 2) at least one disable and one re-enable, and the
        streams equal the plain engine's. K8 = 2 x layers a paged device
        step. Then the realistic trace on (b)'s paged geometry with both
        trees: speculative streams equal plain ones.
    (b) bf16 at full width and the model's depth L, the realistic trace
        on the ``ENGINE_*`` paged geometry: the precompute (K1 = assembled
        = 7 x L) and the speculative engine, K8 = 2 x L x (chunk + decode +
        draft + verify steps), K3 = K6 = 0, every request its full budget,
        the pool drained, three drafts a verify; printed beside the plain
        paged engine's run of engine_checks (``plain_main``): the accept
        rate, ticks, ms a tick, tokens/s, the verify fetch's ms and the
        share of requests whose tokens equal the plain run's.

    Returns (record, the bf16 serving tree) for fault_checks."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    auto = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    out: dict = {}

    # --- (a) fp32 at SPEC_LAYERS layers, the committed trace ---
    trace, slots, max_len, k, model = speculative_trace()
    mcfg32 = dataclasses.replace(mcfg, num_layers=SPEC_LAYERS,
                                 dtype=torch.float32)
    p32 = _upcast_layers(params, SPEC_LAYERS)
    a32 = _upcast_layers(adapters, SPEC_LAYERS)
    precompute = make_precompute_step(mcfg32, auto, fold_gsb=True)
    trees = {"identity": precompute(p32, _identity_tree(p32, a32,
                                                        auto.dora)),
             "perturbed": precompute(p32, a32)}
    for leaf in _adapter_leaves(trees["identity"]):
        check(bool((leaf["g"] == 1.0).all()) and not leaf["gsB"].any(),
              "identity adapters: g != 1 or gsB != 0")
    fp32 = {}
    for name, state in trees.items():
        extra = {} if name == "identity" else SPEC_LADDER
        for layout in ("rect", "paged"):
            kw = dict(slots=slots, max_len=max_len, device=dev,
                      paged=layout == "paged")
            runs = {}
            for spec in (0, k):
                kernels.reset_launch_counts()
                engine = DecodeEngine(mcfg32, auto, p32, adapters=state,
                                      speculative_k=spec,
                                      **(extra if spec else {}), **kw)
                runs[spec] = drive_engine(engine, trace, mcfg.vocab_size)
                steps = engine.device_steps()
                want = counts_of(paged_gather=2 * SPEC_LAYERS * sum(
                    steps.values()) if layout == "paged" else 0)
                check(launch_counts() == want,
                      f"spec (a) {name} {layout} k={spec}: launches "
                      f"{launch_counts()}, want {want}")
            st = engine.stats()
            check(runs[k]["streams"] == runs[0]["streams"],
                  f"spec (a) {name} {layout}: fp32 speculative streams "
                  f"differ from the plain engine's")
            if name == "identity":
                got = {f: getattr(st, f) for f in model}
                check(got == model, f"spec (a) identity {layout}: "
                      f"counters {got}, BENCH_serve.json {model}")
            else:
                check(st.spec_disables >= 1 and st.spec_reenables >= 1,
                      f"spec (a) perturbed {layout}: the ladder did not "
                      f"trip and re-enable: {st}")
            fp32[f"{name}_{layout}"] = {
                f: getattr(st, f) for f in (
                    "steps", "decode_steps", "draft_steps", "verify_steps",
                    "accepted_drafts", "generated_tokens", "spec_disables",
                    "spec_reenables")}
    # The realistic trace on (b)'s paged geometry (chunked admission, the
    # fallback while a slot is mid-admission, long windows), in fp32.
    paged_kw = dict(slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, paged=True,
                    block_size=ENGINE_BLOCK, n_blocks=ENGINE_BLOCKS,
                    prefill_chunk=ENGINE_CHUNK, device=dev)
    for name, state in trees.items():
        runs = {spec: drive_engine(
            DecodeEngine(mcfg32, auto, p32, adapters=state,
                         speculative_k=spec, **paged_kw),
            realistic_trace(), mcfg.vocab_size)["streams"]
            for spec in (0, SPEC_K)}
        check(runs[SPEC_K] == runs[0],
              f"spec (a) {name}, realistic trace: fp32 speculative streams "
              f"differ from the plain engine's")
        fp32[f"{name}_realistic_tokens"] = sum(len(v) for v in
                                               runs[0].values())
    out["fp32"] = {"layers": SPEC_LAYERS, "k": k, "runs": fp32}
    print("spec (a) fp32: " + json.dumps(out["fp32"]), flush=True)
    del trees, p32, a32, engine
    _empty_cache(dev)

    # --- (b) bf16, full width and depth, the realistic trace ---
    L = mcfg.num_layers
    trace = realistic_trace()
    _sync(dev)
    kernels.reset_launch_counts()
    state = make_precompute_step(mcfg, auto, fold_gsb=True)(params,
                                                            adapters)
    engine = DecodeEngine(mcfg, auto, params, adapters=state,
                          speculative_k=SPEC_K, slots=ENGINE_SLOTS,
                          max_len=ENGINE_MAX_LEN, paged=True,
                          block_size=ENGINE_BLOCK, n_blocks=ENGINE_BLOCKS,
                          prefill_chunk=ENGINE_CHUNK, device=dev)
    run = drive_engine(engine, trace, mcfg.vocab_size, timed=True)
    counts = launch_counts()
    steps = engine.device_steps()
    st, ps = engine.stats(), engine.pool_stats()
    check(counts == counts_of(norm_terms=7 * L, assembled=7 * L,
                              paged_gather=2 * L * sum(steps.values())),
          f"spec engine launch counts {counts} (device steps {steps})")
    check(st.generated_tokens == ENGINE_REQUESTS * ENGINE_NEW
          and st.retired == ENGINE_REQUESTS
          and all(len(v) == ENGINE_NEW for v in run["streams"].values()),
          f"spec engine generated {st.generated_tokens} tokens, retired "
          f"{st.retired}")
    check(ps["used_blocks"] == 0, f"spec engine pool did not drain: {ps}")
    check(st.draft_steps == SPEC_K * st.verify_steps > 0
          and steps["draft"] == st.draft_steps
          and steps["verify"] == st.verify_steps,
          f"spec engine drafts {st.draft_steps}, verifies "
          f"{st.verify_steps}, device steps {steps}")
    plain = plain_main["streams"]
    # The index of each request's first token that differs from the plain
    # run's (None: the same tokens).
    diverge = {rid: next((i for i, (x, y) in enumerate(
        zip(run["streams"][rid], plain[rid])) if x != y), None)
        for rid in sorted(plain)}
    first = next(({"request": rid, "token": at}
                  for rid, at in diverge.items() if at is not None), None)
    # One speculative tick with every slot active, profiled after the
    # counts were read: 8 single-chunk prompts admitted, then the tick.
    rng = np.random.default_rng(SEED + 3)
    for _ in range(ENGINE_SLOTS):
        engine.submit(rng.integers(0, mcfg.vocab_size, ENGINE_CHUNK),
                      max_new_tokens=16)
    engine.step()
    tick_profile = profile(engine.step,
                           "engine speculative tick (8 rows, bf16)")
    engine.run()
    times = run["times_ms"]
    out["bf16"] = {
        "layers": L, "k": SPEC_K, "ticks": st.steps,
        "decode_steps": st.decode_steps, "draft_steps": st.draft_steps,
        "verify_steps": st.verify_steps,
        "accepted_drafts": st.accepted_drafts,
        "accept_rate": st.accepted_drafts / (SPEC_K * st.verify_steps),
        "chunk_steps": steps["prefill_chunk"],
        "wall_s": run["wall_s"],
        "ms_per_tick": run["wall_s"] * 1e3 / st.steps,
        "tokens_per_s": st.generated_tokens / run["wall_s"],
        "draft_ms": _mean(times["draft"]),
        "verify_ms": _mean(times["verify"]),
        "verify_fetch_ms": _mean(times["verify_fetch"]),
        "verify_fetch_bytes": ENGINE_SLOTS * (SPEC_K + 1)
        * mcfg.vocab_size * 4,
        "fetch_ms": _mean(times["fetch"]),
        "decode_ms": _mean(times["decode"]),
        "chunk_step_ms": _mean(times["prefill_chunk"]),
        "plain": {"ticks": plain_main["ticks"], "wall_s":
                  plain_main["wall_s"],
                  "ms_per_tick": plain_main["wall_s"] * 1e3
                  / plain_main["ticks"],
                  "tokens_per_s": plain_main["tokens_per_s"],
                  "decode_ms": plain_main["decode_ms_per_tick"]},
        "requests_equal_plain": sum(at is None for at in diverge.values())
        / len(plain),
        "first_divergence": first,
        "divergence_token_by_request": diverge,
        "peak_used_blocks": ps["peak_used_blocks"], "launches": counts,
        "tick_profile": tick_profile}
    print("spec (b) bf16, realistic length: " + json.dumps(
        {k2: v for k2, v in out["bf16"].items()
         if k2 not in ("launches", "tick_profile")}), flush=True)
    del engine
    return out, state


def fault_checks(dev, mcfg, params, state) -> dict:
    """The fault plan on the paged engine at full width and depth (bf16):
    the first FAULT_REQUESTS requests of the realistic trace with
    FAULT_NEW new tokens each (8 slots, so no request waits), clean and
    under a plan fixed from the clean run's schedule: a one-row NaN at the
    first tick that decodes at least three rows, a slow tick
    (FAULT_SLOW_S), a stale and an evict event, and an all-rows NaN three
    ticks after the first. Held: each request finishes once with a valid
    reason, no slot and no block leaks, the unaffected requests' tokens
    equal the clean run's and the affected ones' are a prefix of them, no
    new kind of device step, ``injected_nans``, ``quarantined`` and
    ``slow_ticks`` as the plan and the clean schedule say, and
    ``forced_evictions == stale_injected == 0``."""
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.engine import FINISH_REASONS, DecodeEngine
    from repro_torch.launch.faults import FaultEvent, FaultPlan
    from repro_torch.launch.steps import StepConfig

    auto = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    trace = [dict(r, gen_len=FAULT_NEW)
             for r in realistic_trace()[:FAULT_REQUESTS]]
    kw = dict(slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, paged=True,
              block_size=ENGINE_BLOCK, n_blocks=ENGINE_BLOCKS,
              prefill_chunk=ENGINE_CHUNK, device=dev)

    def engine_with(plan):
        return DecodeEngine(mcfg, auto, params, adapters=state,
                            fault_plan=plan, **kw)

    # The clean run, recording which request each slot decodes a tick.
    clean = engine_with(None)
    rows: dict = {}
    decode = clean._decode

    def recorded(*a, **k2):
        rows[clean._steps] = {i: s.req.request_id
                              for i, s in enumerate(clean._slots)
                              if s.active}
        return decode(*a, **k2)
    clean._decode = recorded
    clean_run = drive_engine(clean, trace, mcfg.vocab_size)
    t1 = min(t for t, r in rows.items() if len(r) >= 3)
    slot1 = max(rows[t1])
    victim = rows[t1][slot1]
    t2 = t1 + 3
    victims = {victim} | set(rows.get(t2, {}).values())
    plan = FaultPlan([FaultEvent("nan", t1, slot1),
                      FaultEvent("slow", t1 + 1, duration_s=FAULT_SLOW_S),
                      FaultEvent("stale", t1 + 2),
                      FaultEvent("evict", t1 + 2),
                      FaultEvent("nan", t2)])
    check(len(victims) >= 2 and len(victims) < FAULT_REQUESTS,
          f"fault plan {plan} hits {victims} of {FAULT_REQUESTS}")

    faulty = engine_with(plan)
    run = drive_engine(faulty, trace, mcfg.vocab_size)
    results = faulty.pop_results()
    st, ps = faulty.stats(), faulty.pool_stats()
    reasons = {r.request_id: r.finish_reason for r in results}
    check(sorted(r.request_id for r in results) == list(range(len(trace)))
          and set(reasons.values()) <= set(FINISH_REASONS),
          f"faults: results {reasons}")
    check(not faulty.has_work() and ps["used_blocks"] == 0
          and ps["per_slot_blocks"] == [0] * ENGINE_SLOTS,
          f"faults: a slot or a block leaked: {ps}")
    hit = {r.request_id for r in results
           if r.finish_reason == "error_numeric"}
    check(hit == victims, f"faults: quarantined {hit}, the plan hits "
          f"{victims}")
    for r in results:
        got, want = r.tokens.tolist(), clean_run["streams"][r.request_id]
        if r.request_id in hit:
            check(got == want[:len(got)] and len(got) < len(want),
                  f"faults: request {r.request_id}'s tokens are not a "
                  f"prefix of its clean stream")
        else:
            check(got == want and r.finish_reason == "length",
                  f"faults: unaffected request {r.request_id} differs "
                  f"from the clean run")
    check(st.injected_nans == st.quarantined == len(victims)
          and st.slow_ticks == 1
          and st.forced_evictions == st.stale_injected == 0,
          f"faults: counters {st}")
    new_kinds = {k2 for k2, v in faulty.device_steps().items() if v} - {
        k2 for k2, v in clean.device_steps().items() if v}
    check(not new_kinds, f"faults: new device step kinds {new_kinds}")
    out = {"plan": repr(plan), "victims": sorted(victims),
           "injected_nans": st.injected_nans, "quarantined": st.quarantined,
           "slow_ticks": st.slow_ticks, "ticks": st.steps,
           "clean_ticks": clean.stats().steps,
           "wall_s": run["wall_s"], "clean_wall_s": clean_run["wall_s"],
           "device_steps": faulty.device_steps()}
    print("faults (bf16): " + json.dumps(out), flush=True)
    del clean, faulty, state
    _empty_cache(dev)
    return out


# ---------------------------------------------------------------------------
# Training at full width.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Fleet grouping and tracing in the engine.
# ---------------------------------------------------------------------------

# FL1: fp32 at FLEET_LAYERS layers of the full width; the card's fp32
# tolerance for logits (serve_mt's: cuBLAS sums a batch of rows in another
# order than a batch of one).
FLEET_LAYERS, FLEET_TOL = 2, 1e-5
FLEET_MT_REQUESTS, FLEET_MT_TENANTS, FLEET_MT_PROMPT, FLEET_MT_GEN = (
    6, 3, (700, 960), 8)
# FL2: a server of one base model and many fine-tunes, more tenants than
# decode rows: E1's geometry and trace, each request's tenant drawn from
# its own seeded stream, a device budget of FLEET_CACHE_STATES states and
# no host tier (a spill costs about 2.1 s at this width). Nine tenants,
# not twelve: the registry's raw trees (1.94 GB each), the states pinned
# beyond the LRU (2.14 GB of g and gsB each; 12 at once with twelve
# tenants) and the 8-position stack (24.1 GB) with the weights (15.2 GB)
# need about 88.5 GB with twelve, 76.3 GB with nine (see fleet_checks).
FLEET_TENANTS, FLEET_CACHE_STATES, FLEET_MAX_ACTIVE = 9, 6, 2
FLEET_STATIC_REQUESTS = ENGINE_REQUESTS

# make_fleet_trace and simulate_fleet are copies of
# benchmarks/serve_bench.py's (which imports jax).


def make_fleet_trace(*, n_requests=12, tenants=5, mean_interarrival=2.0,
                     prompt_len=8, gen_lens=(4, 6, 8, 10), seed=0):
    trace = make_arrival_trace(n_requests=n_requests,
                               mean_interarrival=mean_interarrival,
                               prompt_len=prompt_len, gen_lens=gen_lens,
                               seed=seed)
    rng = np.random.default_rng(seed + 1)
    for r in trace:
        r["tenant"] = int(rng.integers(tenants))
    return trace


def simulate_fleet(trace, *, slots: int) -> dict:
    from collections import deque
    queue: deque = deque()
    table = [None] * slots
    i, step = 0, 0
    decode_steps = prefills = generated = slot_steps = 0
    signatures: set = set()
    n = len(trace)

    def has_work():
        return bool(queue) or any(v is not None for v in table)

    def signature():
        keys = [(table[j][1] if table[j] is not None else None)
                for j in range(slots)]
        last = None
        for j, k in enumerate(keys):
            if k is None:
                keys[j] = last
            else:
                last = k
        nxt = None
        for j in reversed(range(slots)):
            if keys[j] is None:
                keys[j] = nxt
            else:
                nxt = keys[j]
        if len(set(keys)) == 1:
            return None
        runs: list = []
        for k in keys:
            if runs and runs[-1][0] == k:
                runs[-1] = (k, runs[-1][1] + 1)
            else:
                runs.append((k, 1))
        groups, start = [], 0
        for _, cnt in runs:
            groups.append((start, cnt))
            start += cnt
        return tuple(groups)

    while i < n or has_work():
        while i < n and trace[i]["arrival_step"] <= step:
            queue.append(trace[i])
            i += 1
        for j in range(slots):
            while table[j] is None and queue:
                r = queue.popleft()
                prefills += 1
                generated += 1
                if r["gen_len"] - 1 > 0:
                    table[j] = [r["gen_len"] - 1, r["tenant"]]
        active = [j for j in range(slots) if table[j] is not None]
        if active:
            signatures.add(signature())
            decode_steps += 1
            slot_steps += len(active)
            for j in active:
                generated += 1
                table[j][0] -= 1
                if table[j][0] == 0:
                    table[j] = None
        step += 1
    occ = slot_steps / (decode_steps * slots) if decode_steps else 0.0
    return {"steps": step, "decode_steps": decode_steps,
            "prefills": prefills, "generated_tokens": generated,
            "slot_steps": slot_steps, "mean_occupancy": occ,
            "static_signatures": len(signatures),
            "signature_keys": sorted(str(s) for s in signatures),
            "dynamic_signatures": 1}


def capture_logits(engine) -> dict:
    """Record each sampled row's host logits by (key_id, tokens sampled
    before it), the keys the engine samples under."""
    seen: dict = {}
    sample = engine._sample_rows

    def recorded(rows, keys):
        for row, key in zip(rows, keys):
            seen[tuple(int(k) for k in key)] = np.asarray(row, np.float64)
        return sample(rows, keys)
    engine._sample_rows = recorded
    return seen


def max_rel_logits(got: dict, want: dict) -> float:
    """The largest gap between two records of :func:`capture_logits`, over
    each row's max |logit|."""
    check(got.keys() == want.keys(), "logit records of other rows")
    return max(float(np.abs(got[k] - want[k]).max()
                     / np.abs(want[k]).max()) for k in want)


def tick_pcts(xs) -> dict:
    """p50/p90/max in ticks with the obs layer's nearest-rank percentile,
    the definition of ``BENCH_serve.json``'s ``obs.lifecycle_model``."""
    from repro_torch.obs import percentile
    return {"p50": percentile(xs, 50), "p90": percentile(xs, 90),
            "max": float(max(xs)) if xs else 0.0}


def lifecycle_of(rec, slots: int) -> dict:
    """The committed lifecycle model's numbers from a trace: queue wait,
    TTFT and admission-to-retirement percentiles in ticks, and decode-tick
    occupancy from the token events."""
    from collections import Counter

    from repro_torch.obs import lifecycle_latencies
    lat = lifecycle_latencies(rec)
    out = {k: tick_pcts([r[k] for r in lat.values()])
           for k in ("queue_wait_ticks", "ttft_ticks",
                     "admit_to_retire_ticks")}
    per_tick = Counter(e.tick for e in rec if e.name == "token")
    occ = [per_tick[t] for t in sorted(per_tick)]
    out["occupancy"] = {"p50": tick_pcts(occ)["p50"],
                        "mean": sum(occ) / (len(occ) * slots)}
    out["n_requests"] = len(lat)
    return out


def fleet_parity(dev, mcfg, params) -> dict:
    """FL1: fleet grouping and tracing on the card in fp32 at FLEET_LAYERS
    layers of the full width, five perturbed tenants:

    - the committed ``fleet`` trace through the dynamic and the static
      engine (each with a fresh cache): the counters of
      ``fleet.schedule_model`` (and of this file's copy of its simulator),
      the static engine's four ``signature_keys``, the dynamic one's
      ``"dynamic"``, equal streams, logits within FLEET_TOL of max, K1 =
      assembled = 14 a miss and nothing else;
    - dynamic + speculative (k = 3) + paged: the static plain streams, K8 =
      2 x layers a paged step, the verify under ``('dynamic', 4)``;
    - the committed ``obs`` trace, traced and untraced (single tenant):
      the same streams, stats, device steps and signatures, and the trace
      gives ``obs.lifecycle_model`` exactly with 136 events;
    - ``MultiTenantServer.serve`` of six mixed-length requests (prompts
      700-960) over three tenants through the engine route: each request
      served alone gives its tokens, logits within FLEET_TOL of max;
    - a tiered cache of two states on the card, forced to spill and
      reload: each tier move is an event on the traced engine's trace."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core.adapter_cache import (AdapterStateCache,
                                                serving_state_nbytes)
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step
    from repro_torch.obs import TraceRecorder

    n = FLEET_LAYERS
    vocab = mcfg.vocab_size
    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    m32 = dataclasses.replace(mcfg, num_layers=n, dtype=torch.float32)
    p32 = _upcast_layers(params, n)
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_serve.json").read_text())
    tp = dict(bench["fleet"]["trace"])
    model = bench["fleet"]["schedule_model"]
    slots, max_len = tp.pop("slots"), tp.pop("max_len")
    tenants = [_tenant_adapters(m32, p32, scfg.dora, t, dev)
               for t in range(tp["tenants"])]

    def fresh_cache(**kw):
        cache = AdapterStateCache.for_serving(m32, scfg, device=dev, **kw)
        for t, ad in enumerate(tenants):
            cache.register(f"tenant-{t}", ad)
        return cache

    trace = make_fleet_trace(**tp)
    ids = [f"tenant-{r['tenant']}" for r in trace]
    sim = simulate_fleet(trace, slots=slots)
    for field in ("steps", "decode_steps", "prefills", "generated_tokens",
                  "slot_steps", "signature_keys"):
        check(sim[field] == model[field], f"fleet simulator {field}="
              f"{sim[field]}, BENCH_serve.json {model[field]}")
    out: dict = {"layers": n}
    runs = {}
    for form in ("dynamic", "static"):
        dyn = form == "dynamic"
        kernels.reset_launch_counts()
        cache = fresh_cache()
        eng = DecodeEngine(m32, scfg, p32, adapter_cache=cache, slots=slots,
                           max_len=max_len, dynamic_grouping=dyn,
                           device=dev)
        logits = capture_logits(eng)
        run = drive_engine(eng, trace, vocab, adapters=ids)
        st, misses = eng.stats(), cache.stats().misses
        for field in ("steps", "decode_steps", "prefills",
                      "generated_tokens", "slot_steps"):
            check(getattr(st, field) == model[field],
                  f"FL1 {form} {field}={getattr(st, field)}, "
                  f"BENCH_serve.json {model[field]}")
        sigs = eng.step_signatures()["decode"]
        check(sorted(sigs) == (["dynamic"] if dyn
                               else model["signature_keys"]),
              f"FL1 {form} decode signatures {sorted(sigs)}")
        want = counts_of(norm_terms=7 * n * misses, assembled=7 * n * misses)
        check(launch_counts() == want,
              f"FL1 {form} launches {launch_counts()}, want {want}")
        if dyn:
            check(0 < st.stack_inserts <= st.admitted
                  and eng.device_steps()["adapter_insert"]
                  == st.stack_inserts, f"FL1 stack inserts {st}")
        runs[form] = {"streams": run["streams"], "logits": logits}
        out[form] = {"stats": st.as_dict(), "signatures": sigs,
                     "cache": cache.stats().as_dict(),
                     "launches": launch_counts()}
    check(runs["dynamic"]["streams"] == runs["static"]["streams"],
          "FL1 dynamic streams differ from the static engine's")
    check(len({tuple(v) for v in runs["static"]["streams"].values()}) > 1,
          "FL1: every request streamed the same tokens")
    err = max_rel_logits(runs["dynamic"]["logits"], runs["static"]["logits"])
    check(err <= FLEET_TOL, f"FL1 dynamic vs static logits {err} of max")
    out["dynamic_vs_static_rel_err"] = err

    # --- dynamic + speculative + paged against the static plain run ---
    kernels.reset_launch_counts()
    cache = fresh_cache()
    eng = DecodeEngine(m32, scfg, p32, adapter_cache=cache, slots=slots,
                       max_len=max_len, dynamic_grouping=True,
                       speculative_k=SPEC_K, paged=True, device=dev)
    run = drive_engine(eng, trace, vocab, adapters=ids)
    steps, st = eng.device_steps(), eng.stats()
    misses = cache.stats().misses
    check(run["streams"] == runs["static"]["streams"],
          "FL1 dynamic + speculative + paged streams differ from static "
          "plain")
    want = counts_of(norm_terms=7 * n * misses, assembled=7 * n * misses,
                     paged_gather=2 * n * sum(
                         steps[k] for k in ("prefill_chunk", "decode",
                                            "draft", "verify")))
    check(launch_counts() == want,
          f"FL1 speculative paged launches {launch_counts()}, want {want}")
    check(st.verify_steps > 0 and list(eng.step_signatures()["verify"])
          == [str(("dynamic", SPEC_K + 1))],
          f"FL1 speculative verify signatures {eng.step_signatures()}")
    check(eng.pool_stats()["used_blocks"] == 0, "FL1 pool did not drain")
    out["dynamic_spec_paged"] = {"stats": st.as_dict(),
                                 "device_steps": steps,
                                 "launches": launch_counts()}

    # --- the committed obs trace, traced and untraced ---
    sec = bench["obs"]
    tp_o = dict(sec["trace"])
    slots_o, ml_o = tp_o.pop("slots"), tp_o.pop("max_len")
    trace_o = make_arrival_trace(**tp_o)
    state = make_precompute_step(m32, scfg, fold_gsb=True)(p32, tenants[0])
    seen, rec = {}, None
    for traced in (False, True):
        rec = TraceRecorder() if traced else None
        eng = DecodeEngine(m32, scfg, p32, adapters=state, slots=slots_o,
                           max_len=ml_o, trace=rec, device=dev)
        run = drive_engine(eng, trace_o, vocab)
        seen[traced] = (run["streams"], eng.stats().as_dict(),
                        eng.device_steps(), eng.step_signatures())
    check(seen[True] == seen[False], "FL1: tracing changed the obs run")
    life = lifecycle_of(rec, slots_o)
    for key, want in sec["lifecycle_model"].items():
        check(life[key] == want, f"FL1 obs trace {key}={life[key]}, "
              f"BENCH_serve.json {want}")
    check((rec.emitted, rec.dropped) == (sec["events"]["emitted"], 0) ==
          (136, 0), f"FL1 obs trace events {rec.emitted}, dropped "
          f"{rec.dropped}")
    for e in rec:
        json.dumps(e.as_dict())
    out["obs"] = {"lifecycle": life, "events": rec.emitted}
    del state

    # --- MultiTenantServer: mixed lengths through the engine route ---
    cache = fresh_cache()
    server = serve.MultiTenantServer(m32, scfg, p32, cache=cache, device=dev)
    rng = np.random.default_rng(SEED + 11)
    lo, hi = FLEET_MT_PROMPT
    reqs = [serve.Request(rng.integers(0, vocab, int(rng.integers(lo, hi + 1))),
                          f"tenant-{i % FLEET_MT_TENANTS}")
            for i in range(FLEET_MT_REQUESTS)]
    check(len({len(r.prompt) for r in reqs}) > 1, "FL1: uniform lengths")
    eng = server._get_engine(slots=server.engine_slots, max_len=MAX_LEN,
                             temperature=0.0, seed=0, allow_miss=True)
    logits = capture_logits(eng)
    rows = server.serve(reqs, gen_len=FLEET_MT_GEN, max_len=MAX_LEN)
    alone: dict = {}
    for i, r in enumerate(reqs):
        toks, lg = serve.generate(
            m32, p32, cache.current_handle(r.adapter), scfg,
            np.asarray(r.prompt)[None], gen_len=FLEET_MT_GEN,
            max_len=MAX_LEN, adapter_cache=cache, return_logits=True,
            device=dev)
        check(rows[i].tolist() == toks[0].tolist(),
              f"FL1 server request {i} differs from it served alone")
        for s, step_lg in enumerate(lg):
            alone[i, s] = step_lg[0].double().cpu().numpy()
    err = max_rel_logits(logits, alone)
    check(err <= FLEET_TOL, f"FL1 server vs alone logits {err} of max")
    out["server_mixed"] = {"requests": FLEET_MT_REQUESTS,
                           "prompt_lens": [len(r.prompt) for r in reqs],
                           "rel_err_vs_alone": err,
                           "engine_stats": eng.stats().as_dict()}
    nbytes = serving_state_nbytes(cache.get_state(
        p32, cache.current_handle("tenant-0")))
    del server, cache, eng

    # --- a tiered cache of two states: spill and reload on the trace ---
    tier = fresh_cache(max_bytes=2 * nbytes, host_max_bytes=3 * nbytes)
    rec = TraceRecorder()
    eng = DecodeEngine(m32, scfg, p32, adapter_cache=tier, slots=1,
                       max_len=32, trace=rec, device=dev)
    for t in (0, 1, 2, 0):
        eng.submit(rng.integers(0, vocab, 16), adapter=f"tenant-{t}",
                   max_new_tokens=2)
        eng.run()
    cst = tier.stats()
    moves = [(e.name, e.data["adapter"]) for e in rec
             if e.name in ("spill", "reload")]
    check(cst.spills >= 1 and cst.reloads == 1
          and moves.count(("reload", "tenant-0")) == 1
          and len(moves) == cst.spills + cst.reloads,
          f"FL1 tier events {moves}, cache {cst}")
    out["tier"] = {"events": moves, "cache": cst.as_dict()}
    print("fleet FL1 (fp32, " + f"{n} layers): " + json.dumps(
        {k: v for k, v in out.items() if k not in ("dynamic", "static")}
        | {k: {"signatures": out[k]["signatures"],
               "launches": out[k]["launches"]}
           for k in ("dynamic", "static")}), flush=True)
    del tier, eng, p32, tenants
    _empty_cache(dev)
    return out


def fleet_checks(dev, mcfg, params, adapters, plain_main) -> dict:
    """FL2: qwen2-7b at full width and depth (bf16, r = 384) serving
    FLEET_TENANTS perturbed tenants (tenant 0 the main path's own adapter
    tree) through the paged engine on E1's geometry and trace, each
    request's tenant drawn from its own stream, over a cache of
    FLEET_CACHE_STATES states and no host tier, FLEET_MAX_ACTIVE slots an
    adapter at most, traced: the dynamic engine first, then the static
    one on the same trace with a fresh cache (everything freed between).

    Gates: K1 = assembled = 7 x L x the cache's misses, K8 = 2 x L x
    (chunk + decode steps), nothing else; the dynamic decode under
    ``"dynamic"`` alone; stack inserts <= admissions; every request
    ``length`` with its 64 tokens; the pool drained; the trace drops
    nothing and holds 24 ``submitted`` and 24 ``terminal`` events.
    Printed: ticks, ms a tick, tokens/s, peak memory, the cache's
    counters, the static signatures, each engine's decode ms beside E1's
    (``plain_main``), a profiled dynamic decode tick's idle share, the
    lifecycle percentiles, and the share of requests whose dynamic stream
    equals the static one (bf16: reported, not gated)."""
    from collections import Counter

    from repro_torch import kernels
    from repro_torch.core.adapter_cache import (AdapterStateCache,
                                                serving_state_nbytes)
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step
    from repro_torch.obs import TraceRecorder

    L = mcfg.num_layers
    n_adapted = 7 * L
    auto = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    _empty_cache(dev)
    tenants = [adapters] + [_tenant_adapters(mcfg, params, auto.dora, t, dev)
                            for t in range(1, FLEET_TENANTS)]
    trace = realistic_trace()
    rng = np.random.default_rng(SEED + 5)
    ids = [f"tenant-{int(rng.integers(FLEET_TENANTS))}" for _ in trace]

    # The memory reckoning, from one state's measured bytes.
    probe = make_precompute_step(mcfg, auto, fold_gsb=True)(params,
                                                            adapters)
    state_bytes = serving_state_nbytes(probe)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    reckoning = {
        "weights": nbytes(_leaves_sorted(params)),
        "raw_per_tenant": nbytes(_leaves_sorted(adapters)),
        "state_counted": state_bytes,
        "state_held": _held_bytes(probe, adapters),
        "stack_position": nbytes(leaf[k] for leaf in _adapter_leaves(probe)
                                 for k in ("A", "g", "gsB"))}
    del probe
    reckoning["stack"] = ENGINE_SLOTS * reckoning["stack_position"]
    reckoning["predicted_peak"] = (
        reckoning["weights"] + FLEET_TENANTS * reckoning["raw_per_tenant"]
        + FLEET_TENANTS * reckoning["state_held"] + reckoning["stack"])
    reckoning["card_bytes"] = (
        torch.cuda.get_device_properties(dev).total_memory
        if torch.device(dev).type == "cuda" else None)
    print("fleet FL2 memory reckoning: " + json.dumps(reckoning), flush=True)

    paged_kw = dict(slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, paged=True,
                    block_size=ENGINE_BLOCK, n_blocks=ENGINE_BLOCKS,
                    prefill_chunk=ENGINE_CHUNK, device=dev)
    out: dict = {"tenants": FLEET_TENANTS,
                 "cache_states": FLEET_CACHE_STATES,
                 "max_active_per_adapter": FLEET_MAX_ACTIVE,
                 "requests_by_tenant": dict(sorted(Counter(ids).items())),
                 "reckoning": reckoning}
    streams = {}
    for form in ("dynamic", "static"):
        dyn = form == "dynamic"
        n_req = ENGINE_REQUESTS if dyn else FLEET_STATIC_REQUESTS
        cache = AdapterStateCache.for_serving(
            mcfg, auto, device=dev,
            max_bytes=FLEET_CACHE_STATES * state_bytes)
        for t, ad in enumerate(tenants):
            cache.register(f"tenant-{t}", ad)
        rec = TraceRecorder()
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng = DecodeEngine(mcfg, auto, params, adapter_cache=cache,
                           dynamic_grouping=dyn,
                           max_active_per_adapter=FLEET_MAX_ACTIVE,
                           trace=rec, **paged_kw)
        run = drive_engine(eng, trace[:n_req], mcfg.vocab_size, timed=True,
                           adapters=ids)
        counts, peak = launch_counts(), _peak(dev)
        steps, st, cst = eng.device_steps(), eng.stats(), cache.stats()
        results = eng.pop_results()
        want = counts_of(norm_terms=n_adapted * cst.misses,
                         assembled=n_adapted * cst.misses,
                         paged_gather=2 * L * (steps["decode"]
                                               + steps["prefill_chunk"]))
        check(counts == want, f"FL2 {form} launches {counts}, want {want} "
              f"(device steps {steps}, cache {cst})")
        check(steps["draft"] == steps["verify"] == 0,
              f"FL2 {form} device steps {steps}")
        sigs = eng.step_signatures()["decode"]
        if dyn:
            check(list(sigs) == ["dynamic"], f"FL2 dynamic signatures {sigs}")
            check(st.stack_inserts <= st.admitted == n_req,
                  f"FL2 stack inserts {st.stack_inserts}, admitted "
                  f"{st.admitted}")
        check(len(results) == n_req and all(
            r.finish_reason == "length" and len(r.tokens) == ENGINE_NEW
            for r in results), f"FL2 {form}: not every request finished "
            f"with its {ENGINE_NEW} tokens")
        names = Counter(e.name for e in rec)
        check(rec.dropped == 0 and names["submitted"] == names["terminal"]
              == n_req, f"FL2 {form} trace {dict(names)}, dropped "
              f"{rec.dropped}")
        check(eng.pool_stats()["used_blocks"] == 0,
              f"FL2 {form}: the pool did not drain")
        life = lifecycle_of(rec, ENGINE_SLOTS)
        times = run["times_ms"]
        out[form] = {
            "requests": n_req, "ticks": st.steps,
            "decode_steps": st.decode_steps,
            "chunk_steps": steps["prefill_chunk"],
            "wall_s": run["wall_s"],
            "ms_per_tick": run["wall_s"] * 1e3 / st.steps,
            "tokens_per_s": st.generated_tokens / run["wall_s"],
            "decode_ms": _mean(times["decode"]),
            "chunk_step_ms": _mean(times["prefill_chunk"]),
            "fetch_ms": _mean(times["fetch"]),
            "max_memory_allocated_bytes": peak,
            "cache": {k: cst.as_dict()[k] for k in (
                "hits", "misses", "evictions", "current_bytes")},
            "stack_inserts": st.stack_inserts, "admitted": st.admitted,
            "preemptions": st.preemptions,
            "signatures": len(sigs), "signature_steps": sigs,
            "events": rec.emitted,
            "lifecycle": {k: life[k] for k in (
                "queue_wait_ticks", "ttft_ticks", "admit_to_retire_ticks")},
            "launches": counts}
        streams[form] = run["streams"]
        if dyn:
            # One decode tick with every slot active under eight tenants,
            # profiled after the counts were read.
            prng = np.random.default_rng(SEED + 2)
            for t in range(ENGINE_SLOTS):
                eng.submit(prng.integers(0, mcfg.vocab_size,
                                         min(768, ENGINE_MAX_LEN // 2)),
                           adapter=f"tenant-{t}", max_new_tokens=8)
            while eng._queue or any(s.prefilling for s in eng._slots):
                eng.step()
            eng.step()
            out[form]["decode_tick_profile"] = profile(
                eng.step, "FL2 dynamic decode tick (8 rows, 8 tenants)")
            eng.run()
        out[form]["phase_s"] = time.perf_counter() - t0
        print(f"fleet FL2 {form} (bf16): " + json.dumps(
            {k: v for k, v in out[form].items()
             if k not in ("launches", "decode_tick_profile",
                          "signature_steps")}), flush=True)
        del eng, cache, rec, results
        _empty_cache(dev)
    shared = sorted(streams["static"])
    out["requests_equal_static"] = sum(
        streams["dynamic"][rid] == streams["static"][rid]
        for rid in shared) / len(shared)
    out["e1"] = {"ticks": plain_main["ticks"],
                 "ms_per_tick": plain_main["wall_s"] * 1e3
                 / plain_main["ticks"],
                 "decode_ms": plain_main["decode_ms_per_tick"],
                 "tokens_per_s": plain_main["tokens_per_s"]}
    print("fleet FL2 summary: " + json.dumps(
        {"dynamic_decode_ms": out["dynamic"]["decode_ms"],
         "static_decode_ms": out["static"]["decode_ms"],
         "e1_decode_ms": out["e1"]["decode_ms"],
         "dynamic_ms_per_tick": out["dynamic"]["ms_per_tick"],
         "static_ms_per_tick": out["static"]["ms_per_tick"],
         "e1_ms_per_tick": out["e1"]["ms_per_tick"],
         "requests_equal_static": out["requests_equal_static"],
         "idle_share": out["dynamic"]["decode_tick_profile"].get(
             "device_idle_share")}), flush=True)
    del tenants
    _empty_cache(dev)
    return out


def _train_batches(mcfg, steps: int, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ):
    """The port's synthetic pipeline at the training shape, on the host."""
    from repro_torch.data import DataConfig, make_train_iterator

    it = make_train_iterator(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=seq,
        global_batch=batch, seed=SEED + 2))
    return [next(it) for _ in range(steps)]


def _steps_on(dev, mcfg, params, adapters, dcfg, batches, name):
    """One train step of ``dcfg``'s route per batch, launch counts read
    per step; the counts are zeroed just before the first step and read
    just after the last (the record's "launches")."""
    from repro_torch import kernels
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.optim import adamw_init

    scfg = StepConfig(dora=dcfg, loss_tokens=LOSS_TOKENS)
    step = make_train_step(mcfg, scfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    opt = adamw_init(adapters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_step, steps = [], []
    kernels.reset_launch_counts()
    for batch in batches:
        before = launch_counts()
        stats: dict = {}
        bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        adapters, opt, met = step(params, adapters, opt, bt, stats=stats)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        steps.append({"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "lr": met["lr"], "grad_ms": stats["grad_s"] * 1e3,
                      "optim_ms": stats["optim_s"] * 1e3})
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    del opt
    torch.cuda.empty_cache()
    # The first step pays for cuBLAS and allocator warm-up: the later
    # steps are the steady state.
    warm = steps[1:] or steps
    step_ms = sum(st["grad_ms"] + st["optim_ms"] for st in warm) / len(warm)
    rec = {"steps": steps, "step_ms": step_ms,
           "grad_ms": sum(st["grad_ms"] for st in warm) / len(warm),
           "optim_ms": sum(st["optim_ms"] for st in warm) / len(warm),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "max_memory_allocated_bytes": peak, "launches_per_step": per_step,
           "launches": launches}
    print(f"train {name} (bf16): " + json.dumps(rec), flush=True)
    for st in steps:
        check(math.isfinite(st["loss"]), f"train {name}: loss {st['loss']}")
        check(math.isfinite(st["grad_norm"]) and st["grad_norm"] > 0,
              f"train {name}: grad norm {st['grad_norm']}")
    return rec


def _kernel_family(name: str) -> str:
    """A coarse class of a device kernel's name, for the step profile."""
    for ours in SOURCES:
        # A kernel's main and tensor-core launches, its split sum and
        # K1's epilogue.
        if any(f"{ours}{part}_kernel" in name
               for part in ("", "_mma", "_sum", "_assemble")):
            return ours
    low = name.lower()
    for family, keys in (("gemm", ("gemm", "xmma", "cutlass", "matmul",
                                   "nvjet")),
                         ("reduce", ("reduce",)),
                         ("memcpy/memset", ("memcpy", "memset")),
                         ("elementwise", ("elementwise", "vectorized",
                                          "unrolled"))):
        if any(k in low for k in keys):
            return family
    return "other"


def profile(run, label: str, echo: bool = True, ranges=()) -> dict:
    """``run()`` under torch.profiler, outside every launch count: device
    time by kernel family and by kernel, and the device's idle share of
    the wall time; printed unless ``echo`` is False. ``ranges``: names of
    ``record_function`` ranges that ``run`` opens (``moe_ranges``), whose
    kernels' device time is reported by range (the ranges' own device-side
    annotation spans count as no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    _sync(dev)
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            _sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict = {}
        in_range: dict = {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                if ev.name in ranges:
                    n, t = in_range.get(ev.name, (0, 0.0))
                    in_range[ev.name] = (n + 1, t + ev.device_time_total)
                continue
            if ev.name in ranges:
                continue
            us = ev.time_range.end - ev.time_range.start
            n, t = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (n + 1, t + us)
    except Exception as exc:   # the profiler is a measurement, not a check
        print(f"{label} profile: unavailable ({exc!r})", flush=True)
        return {"error": repr(exc)}
    busy_us = sum(t for _, t in by_name.values())
    families: dict = {}
    for name, (n, t) in by_name.items():
        fam = families.setdefault(_kernel_family(name), [0, 0.0])
        fam[0] += n
        fam[1] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    rec = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "families_ms": {k: {"launches": n, "ms": t / 1e3}
                           for k, (n, t) in sorted(
                               families.items(), key=lambda kv: -kv[1][1])},
           "top_kernels_ms": [{"name": k[:100], "launches": n, "ms": t / 1e3}
                              for k, (n, t) in top]}
    if ranges:
        rec["ranges_ms"] = {k: {"calls": n, "ms": t / 1e3}
                            for k, (n, t) in sorted(in_range.items())}
    if echo:
        print(f"{label} profile: " + json.dumps(rec), flush=True)
    return rec


def _profile_step(dev, mcfg, params, adapters, dcfg, batch,
                  ranges=()) -> dict:
    """One more training step under the profiler (``ranges``: as
    ``profile`` takes them)."""
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.optim import adamw_init

    step = make_train_step(mcfg, StepConfig(dora=dcfg,
                                            loss_tokens=LOSS_TOKENS),
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    opt = adamw_init(adapters)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    rec = profile(lambda: step(params, adapters, opt, bt),
                  f"train {mcfg.name} (auto, bf16, one step)", ranges=ranges)
    del opt
    torch.cuda.empty_cache()
    return rec


def _first_layers(tree, n: int):
    """Copies of the first ``n`` layer slices of a stacked tree's stack,
    beside its other leaves as they are: the rest of the stack is freed
    with the tree it came from, before an upcast of the copies."""
    return {k: _tree_map(lambda t: t[:n].clone(), v) if k == "stack" else v
            for k, v in tree.items()}


def _layer_views(tree, n: int):
    """The first ``n`` layer slices of a stacked tree's stack as views,
    beside its other leaves: a shallower model on the same weights."""
    return {k: _tree_map(lambda t: t[:n], v) if k == "stack" else v
            for k, v in tree.items()}


def full_depth_reckoning(reckoning: dict, params, layers: int,
                         cut: int) -> dict:
    """FL2's memory reckoning (taken at ``cut`` layers) at the full depth
    of ``params``: the adapter and state bytes scale with the layers, the
    weights are the full model's."""
    out = dict(reckoning)
    for k in ("raw_per_tenant", "state_counted", "state_held",
              "stack_position", "stack"):
        out[k] = reckoning[k] // cut * layers
    out["weights"] = sum(t.numel() * t.element_size()
                         for t in _leaves_sorted(params))
    return out


def _upcast_layers(tree, n: int):
    """fp32 copies of the first ``n`` layer slices of a stacked tree (the
    stack's leaves) and of every other leaf."""
    out = {}
    for k, v in tree.items():
        if k == "stack":
            out[k] = _tree_map(lambda t: t[:n].float(), v)
        elif isinstance(v, dict):
            out[k] = _tree_map(lambda t: t.float(), v)
        else:
            out[k] = v.float()
    return out


def train_checks(dev, mcfg, params, adapters) -> dict:
    """Phases 5-7: full-width bf16 training on both compose routes with
    exact launch counts, then the three routes held together in fp32."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch.steps import StepConfig, make_grad_step

    L = mcfg.num_layers
    n_adapted = 7 * L
    batches = _train_batches(mcfg, TRAIN_STEPS)
    auto = DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto")
    elem = dataclasses.replace(auto, compose_matmul_fused=False)

    # --- 5: the training main path (auto mode, bf16) ---
    mma0 = kernels.compose_mm_fwd.mma_launches
    t_auto = _steps_on(dev, mcfg, params, adapters, auto, batches, "auto")
    check_k6_on_tensor_cores(mma0, t_auto["launches"], "train auto")
    want = counts_of(norm_terms=n_adapted, assembled=n_adapted,
                     compose_mm_fwd=2 * 5 * L, compose_mm_bwd=5 * L)
    for i, got in enumerate(t_auto["launches_per_step"]):
        check(got == want, f"train auto step {i} launch counts {got}")
    t_auto["profile"] = _profile_step(dev, mcfg, params, adapters, auto,
                                      batches[-1])

    # --- 6: the element-wise route on the same state ---
    t_elem = _steps_on(dev, mcfg, params, adapters, elem, batches,
                       "elementwise")
    want = counts_of(norm_terms=n_adapted, assembled=n_adapted,
                     compose_fwd_dual=2 * 5 * L, compose_bwd=5 * L)
    for i, got in enumerate(t_elem["launches_per_step"]):
        check(got == want, f"train elementwise step {i} launch counts {got}")

    # --- 7: route agreement in fp32, full width, AGREE_LAYERS layers ---
    mcfg32 = dataclasses.replace(mcfg, num_layers=AGREE_LAYERS,
                                 dtype=torch.float32)
    p32 = _upcast_layers(params, AGREE_LAYERS)
    a32 = _upcast_layers(adapters, AGREE_LAYERS)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    agree, grads = {}, {}
    for name, dcfg in (("auto", auto), ("elementwise", elem),
                       ("eager", dataclasses.replace(auto, mode="eager"))):
        kernels.reset_launch_counts()
        loss, g = make_grad_step(mcfg32, StepConfig(
            dora=dcfg, loss_tokens=LOSS_TOKENS), batch=TRAIN_BATCH,
            seq=TRAIN_SEQ)(p32, a32, bt)
        counts = launch_counts()
        grads[name] = torch.cat([t.flatten() for t in
                                 _leaves_sorted(g)]).double()
        agree[name] = {"loss": float(loss), "launches": counts}
        del g
    check(agree["auto"]["launches"]["compose_mm_bwd"] == 5 * AGREE_LAYERS
          and agree["elementwise"]["launches"]["compose_bwd"]
          == 5 * AGREE_LAYERS
          and sum(agree["eager"]["launches"].values()) == 0,
          f"fp32 agreement routes launched {agree}")
    for name in ("auto", "elementwise"):
        rel = abs(agree[name]["loss"] / agree["eager"]["loss"] - 1)
        cos = cosine(grads[name], grads["eager"])
        agree[name].update(loss_rel_to_eager=rel, grad_cosine_to_eager=cos)
        check(rel <= 1e-5, f"fp32 {name} loss differs from eager by {rel}")
        check(cos >= GRAD_COSINE_MIN,
              f"fp32 {name} gradient cosine to eager {cos}")
    del p32, a32, grads
    torch.cuda.empty_cache()
    print("train fp32 route agreement: " + json.dumps(agree), flush=True)
    return {"train_auto": t_auto, "train_elementwise": t_elem,
            "fp32_agreement": agree}


def _leaves_sorted(tree):
    from repro_torch.tree import flatten_paths
    return [v for _, v in sorted(flatten_paths(tree).items())]


def train_parity(dev) -> dict:
    """Phase 8: a 2-layer fp32 model trained 2 steps on the card (kernels)
    and on the CPU (their plain versions) from the same state, on both
    compose routes. AdamW runs with lr 1e-2 and eps 1e-4 so the adapters
    move by a visible step and the step is smooth in the gradient (at
    eps = 1e-8 a gradient element near 1e-8 turns a rounding difference
    into a different step)."""
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import OptimizerConfig

    mcfg = ModelConfig(name="parity-2l", family="dense", num_layers=2,
                       d_model=256, num_heads=2, num_kv_heads=1, d_ff=512,
                       vocab_size=512, qkv_bias=True, attn_chunk=16,
                       dtype=torch.float32)
    toks = np.random.default_rng(SEED).integers(0, 512, (2, 2, 33))
    out = {}
    for route, extra in (("mm", {}), ("elementwise",
                                      {"compose_matmul_fused": False})):
        dcfg = DoRAConfig(rank=16, alpha=32.0, mode="fused", **extra)
        scfg = StepConfig(dora=dcfg, optim=OptimizerConfig(
            lr=1e-2, warmup_steps=1, total_steps=2, eps=1e-4))
        res = {}
        for where in ("cpu", "cuda"):
            params, adapters, opt = train.build_state(mcfg, dcfg, SEED, "cpu")
            perturb_adapters(adapters, torch.Generator().manual_seed(SEED))
            if where == "cuda":
                params, adapters, opt = (_tree_map(lambda t: t.to(dev), x)
                                         for x in (params, adapters, opt))
            step = make_train_step(mcfg, scfg, batch=2, seq=32)
            losses = []
            for t in toks:
                bt = {"tokens": torch.as_tensor(t[:, :-1], device=where),
                      "labels": torch.as_tensor(t[:, 1:], device=where)}
                adapters, opt, met = step(params, adapters, opt, bt)
                losses.append(float(met["loss"]))
            res[where] = (losses, _leaves_sorted(adapters))
        (l_cpu, a_cpu), (l_dev, a_dev) = res["cpu"], res["cuda"]
        loss_err = max(abs(a - b) for a, b in zip(l_dev, l_cpu))
        mx = max(abs(v) for v in l_cpu)
        ad_err = max((d.cpu() - c).abs().max().item() / c.abs().max().item()
                     for d, c in zip(a_dev, a_cpu))
        out[route] = {"losses_cpu": l_cpu, "losses_cuda": l_dev,
                      "loss_err": loss_err, "adapter_rel_err": ad_err}
        print(f"train parity {route} (2 layers, fp32, card vs CPU plain): "
              f"loss err {loss_err:.3g} (tol {1e-4 * mx:.3g}), adapter "
              f"err {ad_err:.3g} of max (tol 1e-4)", flush=True)
        check(loss_err <= 1e-4 * mx, f"train parity {route} loss {loss_err}")
        check(ad_err <= 1e-4, f"train parity {route} adapters {ad_err}")
    return out


def small_parity(dev) -> None:
    """A 2-layer fp32 model on the card (kernels) and on the CPU (their
    plain versions), from the same weights."""
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import ModelConfig

    mcfg = ModelConfig(name="parity-2l", family="dense", num_layers=2,
                       d_model=256, num_heads=2, num_kv_heads=1, d_ff=512,
                       vocab_size=512, qkv_bias=True, attn_chunk=16,
                       dtype=torch.float32)
    scfg = StepConfig(dora=DoRAConfig(rank=16, alpha=32.0, mode="fused"))
    params, adapters = serve.build_state(mcfg, scfg.dora, SEED, "cpu")
    adapters = perturb_adapters(adapters,
                                torch.Generator().manual_seed(SEED + 1))
    on_dev = lambda t: ({k: on_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(dev))
    prompts = np.random.default_rng(SEED).integers(0, 512, (2, 20))
    out = {}
    for where, p, a in (("cpu", params, adapters),
                        ("cuda", on_dev(params), on_dev(adapters))):
        out[where] = serve.generate(mcfg, p, a, scfg, prompts, gen_len=6,
                                    max_len=32, device=where,
                                    return_logits=True)
    (t_cpu, l_cpu), (t_dev, l_dev) = out["cpu"], out["cuda"]
    err, mx = max_err(l_dev[0].cpu(), l_cpu[0])
    print(f"small parity (2 layers, fp32, card vs CPU plain): prefill logit "
          f"err {err:.3g} (tol {1e-4 * mx:.3g}), tokens equal "
          f"{torch.equal(t_dev.cpu(), t_cpu)}", flush=True)
    check(err <= 1e-4 * mx, f"small parity logits err {err}")
    check(torch.equal(t_dev.cpu(), t_cpu), "small parity greedy tokens")


# ---------------------------------------------------------------------------
# falcon-mamba-7b served at full width.
# ---------------------------------------------------------------------------

def mamba_checks(dev) -> dict:
    """M1-M3: full-width falcon-mamba-7b (64 Mamba-1 layers) with r=384
    DoRA on in_proj and out_proj, served by ``generate``.

      M1. the main path (bf16, auto mode): precompute, exact-length
          prefill of 4 x 960, 32 greedy tokens; K1 = assembled = 128 and
          K6 = 128 (in_proj and out_proj of 64 layers) and K9 = 64,
          nothing else;
          then one prefill and one decode step under the profiler;
      M2. the same weights upcast to fp32 at 4 layers: the kernel route
          (K6 + K9) against the eager route: prefill logit cosine >=
          0.9999, final h within 1e-4 x max|h|, equal greedy tokens;
      M3. the same weights at 2 layers in fp32, on the card (kernels,
          forced mode) and on the CPU (their plain versions): prefill
          logits within 1e-4 x max|logit|, equal greedy tokens."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                          make_precompute_step,
                                          make_prefill_step)

    mcfg = get_config(MAMBA_ARCH)
    L = mcfg.num_layers
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "fused", "eager")}
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, cfg["auto"].dora, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    print(f"mamba: built {MAMBA_ARCH} ({L} layers, d_model {mcfg.d_model}, "
          f"d_inner {mcfg.d_inner}, n {mcfg.ssm_state}, dt_rank "
          f"{mcfg.dt_rank}, vocab {mcfg.vocab_size}, {mcfg.dtype}) with "
          f"r={RANK} DoRA on in_proj and out_proj in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))
    max_len = PROMPT + GEN

    # --- M1: the main path, auto mode, bf16 (warmed once, uncounted) ---
    serve.generate(mcfg, params, adapters, cfg["auto"], prompts, gen_len=1,
                   max_len=max_len, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    mma0 = kernels.compose_mm_fwd.mma_launches
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=max_len, device=dev, return_logits=True, stats=stats)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(counts == counts_of(norm_terms=2 * L, assembled=2 * L,
                              compose_mm_fwd=2 * L, selective_scan=L),
          f"mamba auto-mode launch counts {counts}")
    check_k6_on_tensor_cores(mma0, counts, "serve mamba")
    check(tuple(toks.shape) == (BATCH, PROMPT + GEN), f"tokens {toks.shape}")
    check(all(torch.isfinite(lg.float()).all().item() for lg in logits),
          "non-finite logits in the mamba run")
    check(((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          "mamba token ids out of range")
    serve_mamba = {
        "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": peak, "launches": counts}
    print("serve mamba (bf16, auto): " + json.dumps(serve_mamba), flush=True)
    del logits

    # One prefill and one decode step under the profiler (uncounted).
    state = make_precompute_step(mcfg, cfg["auto"])(params, adapters)
    tok_in = torch.as_tensor(prompts, device=dev)
    prefill = make_prefill_step(mcfg, cfg["auto"], batch=BATCH, seq=max_len)
    decode = make_decode_step(mcfg, cfg["auto"], batch=BATCH)
    held = {}

    def run_prefill():
        held["logits"], held["cache"] = prefill(params, state,
                                                {"tokens": tok_in})

    serve_mamba["prefill_profile"] = profile(run_prefill,
                                             "serve mamba prefill (bf16)")
    nxt = held["logits"].argmax(-1)[:, None]
    serve_mamba["decode_profile"] = profile(
        lambda: decode(params, state, held["cache"], {"tokens": nxt}),
        "serve mamba decode step (bf16)")
    del state, held

    # --- M2: kernel route vs eager route, fp32, 4 layers ---
    mcfg32 = dataclasses.replace(mcfg, num_layers=MAMBA_AGREE_LAYERS,
                                 dtype=torch.float32)
    p32 = _upcast_layers(params, MAMBA_AGREE_LAYERS)
    a32 = _upcast_layers(adapters, MAMBA_AGREE_LAYERS)
    del params, adapters
    torch.cuda.empty_cache()
    routes = {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        st = make_precompute_step(mcfg32, cfg[mode])(p32, a32)
        lg, cache = make_prefill_step(mcfg32, cfg[mode], batch=BATCH,
                                      seq=max_len)(p32, st,
                                                   {"tokens": tok_in})
        launched = launch_counts()
        gen_toks = serve.generate(mcfg32, p32, a32, cfg[mode], prompts,
                                  gen_len=MAMBA_AGREE_GEN,
                                  max_len=PROMPT + MAMBA_AGREE_GEN,
                                  device=dev)
        routes[mode] = (lg.float(), cache["stack"]["l0"]["h"], gen_toks,
                        launched)
        del st
    (lk, hk, tk, ck), (le, he, te, ce) = routes["auto"], routes["eager"]
    n_mod = 2 * MAMBA_AGREE_LAYERS
    check(ck == counts_of(norm_terms=n_mod, assembled=n_mod,
                          compose_mm_fwd=n_mod,
                          selective_scan=MAMBA_AGREE_LAYERS),
          f"fp32 mamba kernel route launched {ck}")
    check(sum(ce.values()) == 0, f"fp32 mamba eager route launched {ce}")
    h_err, h_max = max_err(hk, he)
    agree = {"prefill_logit_cosine": cosine(lk, le), "h_err": h_err,
             "h_tol": 1e-4 * h_max,
             "tokens_equal": bool(torch.equal(tk, te)),
             "kernel_route_launches": ck}
    print(f"mamba fp32 routes ({MAMBA_AGREE_LAYERS} layers, kernel vs "
          f"eager): " + json.dumps(agree), flush=True)
    check(agree["prefill_logit_cosine"] >= COSINE_MIN,
          f"mamba fp32 kernel vs eager cosine "
          f"{agree['prefill_logit_cosine']}")
    check(h_err <= 1e-4 * h_max, f"mamba fp32 final h err {h_err}")
    check(agree["tokens_equal"], "mamba fp32 routes' greedy tokens differ")
    del routes, lk, hk, le, he

    # --- M3: 2 layers, fp32, the card's kernels vs the CPU's plain ---
    mcfg2 = dataclasses.replace(mcfg32, num_layers=2)
    p2 = {**p32, "stack": _tree_map(lambda t: t[:2], p32["stack"])}
    a2 = {"stack": _tree_map(lambda t: t[:2], a32["stack"])}
    del p32, a32
    small = np.random.default_rng(SEED + 2).integers(
        0, mcfg.vocab_size, (2, 20))
    out = {}
    for where in ("cuda", "cpu"):
        on = (lambda t: t) if where == "cuda" else (lambda t: t.cpu())
        out[where] = serve.generate(mcfg2, _tree_map(on, p2),
                                    _tree_map(on, a2), cfg["fused"], small,
                                    gen_len=6, max_len=26,
                                    device=dev if where == "cuda" else "cpu",
                                    return_logits=True)
    (t_dev, l_dev), (t_cpu, l_cpu) = out["cuda"], out["cpu"]
    err, mx = max_err(l_dev[0].cpu(), l_cpu[0])
    parity = {"prefill_logit_err": err, "tol": 1e-4 * mx,
              "tokens_equal": bool(torch.equal(t_dev.cpu(), t_cpu))}
    print("mamba parity (2 layers, fp32, card vs CPU plain): "
          + json.dumps(parity), flush=True)
    check(err <= 1e-4 * mx, f"mamba parity logits err {err}")
    check(parity["tokens_equal"], "mamba parity greedy tokens")
    del p2, a2, out
    torch.cuda.empty_cache()
    return {"serve_mamba": serve_mamba, "fp32_routes": agree,
            "parity": parity}


# ---------------------------------------------------------------------------
# The rest of the dense family: qwen2-vl-7b trained and served at full
# width and depth from patch embeddings, five more archs served at their
# published widths with the depth cut.
# ---------------------------------------------------------------------------

VL_ARCH = "qwen2-vl-7b"
# Layers each arch is served at (of its published depth), and the depth
# of its fp32 route comparison. qwen3-32b (65.5 GB of bf16 weights),
# qwen2-vl-72b (145.4 GB) and llama4-scout-17b-a16e (203.5 GB; 4.15 GB a
# layer, 54.0 GB with its embedding and head at 12 layers) are cut to fit
# one card beside their fp32 copies; the three that fit whole run whole.
ARCH_DEPTH = {"phi4-mini-3.8b": 32, "chatglm3-6b": 28, "musicgen-medium": 48,
              "qwen3-32b": 24, "qwen2-vl-72b": 16,
              "llama4-scout-17b-a16e": 12}
ARCH_GEN, ARCH_AGREE_LAYERS = 8, 4


def serve_counts(mcfg, dcfg, *, prefill_rows: int, decode_rows: int,
                 decode_steps: int) -> dict:
    """The launch counts of a precompute, one prefill of ``prefill_rows``
    and ``decode_steps`` decode steps of ``decode_rows`` in auto mode on
    the card, from the port's dispatch plans (plan_norm, plan_compose) at
    every adapted module's d_out."""
    from repro_torch.core import dispatch
    from repro_torch.models import lm

    norms = mm = elem = 0
    for _, (d_out, _) in lm._adapted_paths(mcfg, lm.DEFAULT_DORA_TARGETS):
        norms += dispatch.plan_norm(dcfg, d_out=d_out).fused
        for rows, times in ((prefill_rows, 1), (decode_rows, decode_steps)):
            plan = dispatch.plan_compose(dcfg, training=False, rows=rows,
                                         d_out=d_out, rank=dcfg.rank)
            mm += times * plan.matmul_fused
            elem += times * (plan.fused and not plan.matmul_fused)
    n = mcfg.n_scan
    return counts_of(norm_terms=n * norms, assembled=n * norms,
                     compose_mm_fwd=n * mm, compose_fwd=n * elem)


def train_counts(mcfg, dcfg, *, rows: int) -> dict:
    """One train step's launch counts from the port's dispatch plans: the
    norm once per adapted module, the compose forward twice (the layer and
    its remat recompute) and its backward once."""
    from repro_torch.core import dispatch
    from repro_torch.models import lm

    norms = mm = elem = 0
    for _, (d_out, _) in lm._adapted_paths(mcfg, lm.DEFAULT_DORA_TARGETS):
        norms += dispatch.plan_norm(dcfg, d_out=d_out).fused
        plan = dispatch.plan_compose(dcfg, training=True, rows=rows,
                                     d_out=d_out, rank=dcfg.rank)
        mm += plan.matmul_fused
        elem += plan.fused and not plan.matmul_fused
    n = mcfg.n_scan
    return counts_of(norm_terms=n * norms, assembled=n * norms,
                     compose_mm_fwd=2 * n * mm, compose_mm_bwd=n * mm,
                     compose_fwd_dual=2 * n * elem, compose_bwd=n * elem)


def embeds_stream(mcfg, params, adapters, scfg, embeds, *, gen_len: int,
                  max_len: int):
    """Precompute, the unpadded prefill of ``embeds`` through
    make_prefill_step, then ``gen_len`` greedy tokens, each fed back as a
    token. Returns (prefill logits fp32 [B, V], tokens [B, gen_len])."""
    from repro_torch.launch.steps import (make_decode_step,
                                          make_precompute_step,
                                          make_prefill_step)

    b = embeds.shape[0]
    state = make_precompute_step(mcfg, scfg)(params, adapters)
    logits, cache = make_prefill_step(mcfg, scfg, batch=b, seq=max_len)(
        params, state, {"embeds": embeds})
    decode = make_decode_step(mcfg, scfg, batch=b)
    first = logits.float()
    toks = torch.empty((b, 0), dtype=torch.long, device=embeds.device)
    for _ in range(gen_len):
        nxt = logits.argmax(dim=-1)[:, None]
        toks = torch.cat([toks, nxt], dim=1)
        logits, cache = decode(params, state, cache, {"tokens": nxt})
    return first, toks


def _check_shapes_held(mcfg) -> None:
    """Every adapted weight of ``mcfg`` is a shape the kernel phase held
    K1 at, and every d_out it sends to K6 one it held K6 and K7 at."""
    from repro_torch.models import lm

    k1 = set(K1_SHAPES) | set(ARCH_K1_SHAPES)
    mm = set(ARCH_MM_N) | {3584, 18944}
    for path, shape in lm._adapted_paths(mcfg, lm.DEFAULT_DORA_TARGETS):
        check(tuple(shape) in k1, f"{mcfg.name} {path} {shape}: K1 was not "
              f"held at this shape")
        check(shape[0] < 3072 or shape[0] in mm,
              f"{mcfg.name} {path}: K6 was not held at d_out {shape[0]}")


def vl_checks(dev) -> dict:
    """V1-V4: qwen2-vl-7b (the paper's backbone; qwen2-7b's widths with
    M-RoPE and the patch frontend) at full width and depth, DoRA r=384 on
    all seven projections.

      V1. 3 training steps (bf16, auto) on patch embeddings [2, 2048,
          3584] drawn from a seed at the token table's scale (0.02), loss
          on the last 1024 tokens: per step exactly K1 = assembled = 196,
          K6 = 280, K7 = 140, no element-wise compose kernel;
      V2. the route parity on 2 layers in fp32 from the same embeddings:
          kernel and eager loss within 1e-5 relative, gradient cosine >=
          0.99999;
      V3. ``generate`` (bf16, auto), batch 4, prompt 960, 32 greedy
          tokens: K1 = assembled = 196 at precompute and K6 = 140 at the
          prefill, nothing at decode; and a prefill of patch embeddings
          [4, 960, 3584] through make_prefill_step;
      V4. that embeddings prefill and 8 greedy tokens after it on the
          weights upcast to fp32 at full depth, kernel route against
          eager route: prefill logit cosine >= 0.9999, equal tokens."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig, make_grad_step

    mcfg = get_config(VL_ARCH)
    L = mcfg.num_layers
    _check_shapes_held(mcfg)
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "eager")}
    auto = cfg["auto"].dora
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, auto, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    print(f"vl: built {VL_ARCH} ({L} layers, d_model {mcfg.d_model}, "
          f"M-RoPE sections {mcfg.mrope_sections}, frontend "
          f"{mcfg.frontend}, {mcfg.dtype}) with r={RANK} DoRA on 7 targets "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def patches(b, seq):
        return (torch.randn((b, seq, mcfg.d_model), generator=gen,
                            device=dev) * 0.02).to(mcfg.dtype)

    # --- V1: training from patch embeddings, bf16, auto ---
    batches = [{"embeds": patches(TRAIN_BATCH, TRAIN_SEQ),
                "labels": torch.randint(0, mcfg.vocab_size,
                                        (TRAIN_BATCH, TRAIN_SEQ),
                                        generator=gen, device=dev)}
               for _ in range(TRAIN_STEPS)]
    want = train_counts(mcfg, auto, rows=TRAIN_BATCH * TRAIN_SEQ)
    check(want == counts_of(norm_terms=7 * L, assembled=7 * L,
                            compose_mm_fwd=2 * 5 * L,
                            compose_mm_bwd=5 * L),
          f"{VL_ARCH} train: the dispatch plans give {want}")
    mma0 = kernels.compose_mm_fwd.mma_launches
    train = _steps_on(dev, mcfg, params, adapters, auto, batches,
                      f"{VL_ARCH} auto, patch embeddings")
    check_k6_on_tensor_cores(mma0, train["launches"], f"{VL_ARCH} train")
    for i, got in enumerate(train["launches_per_step"]):
        check(got == want, f"{VL_ARCH} train step {i} launch counts {got}")

    # --- V2: route parity in fp32 from embeddings, 2 layers ---
    m2 = dataclasses.replace(mcfg, num_layers=2, dtype=torch.float32)
    p2, a2 = _upcast_layers(params, 2), _upcast_layers(adapters, 2)
    bt = {"embeds": batches[0]["embeds"].float(),
          "labels": batches[0]["labels"]}
    agree, grads = {}, {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        loss, g = make_grad_step(m2, StepConfig(
            dora=cfg[mode].dora, loss_tokens=LOSS_TOKENS),
            batch=TRAIN_BATCH, seq=TRAIN_SEQ)(p2, a2, bt)
        agree[mode] = {"loss": float(loss), "launches": launch_counts()}
        grads[mode] = torch.cat([t.flatten() for t in
                                 _leaves_sorted(g)]).double()
        del g
    check(agree["auto"]["launches"] == train_counts(
        m2, auto, rows=TRAIN_BATCH * TRAIN_SEQ)
        and sum(agree["eager"]["launches"].values()) == 0,
        f"{VL_ARCH} fp32 train routes launched {agree}")
    agree["loss_rel"] = abs(agree["auto"]["loss"] / agree["eager"]["loss"]
                            - 1)
    agree["grad_cosine"] = cosine(grads["auto"], grads["eager"])
    print(f"{VL_ARCH} train fp32 routes (2 layers, from embeddings): "
          + json.dumps(agree), flush=True)
    check(agree["loss_rel"] <= 1e-5,
          f"{VL_ARCH} fp32 kernel loss differs by {agree['loss_rel']}")
    check(agree["grad_cosine"] >= GRAD_COSINE_MIN,
          f"{VL_ARCH} fp32 gradient cosine {agree['grad_cosine']}")
    del p2, a2, grads, batches, bt
    torch.cuda.empty_cache()

    # --- V3: serving, bf16, auto ---
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))
    serve.generate(mcfg, params, adapters, cfg["auto"], prompts, gen_len=1,
                   max_len=MAX_LEN, device=dev)
    want = serve_counts(mcfg, auto, prefill_rows=BATCH * MAX_LEN,
                        decode_rows=BATCH, decode_steps=GEN)
    check(want == counts_of(norm_terms=7 * L, assembled=7 * L,
                            compose_mm_fwd=5 * L),
          f"{VL_ARCH} serve: the dispatch plans give {want}")
    torch.cuda.reset_peak_memory_stats(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    mma0 = kernels.compose_mm_fwd.mma_launches
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=stats)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == want, f"{VL_ARCH} serve launch counts {counts}")
    check_k6_on_tensor_cores(mma0, counts, f"{VL_ARCH} serve")
    check(all(torch.isfinite(lg.float()).all().item() for lg in logits)
          and ((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          f"{VL_ARCH} serve: non-finite logits or tokens out of range")
    served = {
        "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": counts}
    del logits
    embeds = patches(BATCH, PROMPT)
    kernels.reset_launch_counts()
    _sync(dev)
    t1 = time.perf_counter()
    first, _ = embeds_stream(mcfg, params, adapters, cfg["auto"], embeds,
                             gen_len=0, max_len=MAX_LEN)
    _sync(dev)
    served["embeds_precompute_and_prefill_ms"] = \
        (time.perf_counter() - t1) * 1e3
    served["embeds_launches"] = launch_counts()
    check(served["embeds_launches"] == serve_counts(
        mcfg, auto, prefill_rows=BATCH * PROMPT, decode_rows=BATCH,
        decode_steps=0) and torch.isfinite(first).all().item(),
        f"{VL_ARCH} embeddings prefill: {served['embeds_launches']}")
    print(f"serve {VL_ARCH} (bf16, auto): " + json.dumps(served), flush=True)

    # --- V4: kernel vs eager route from embeddings, fp32, full depth ---
    m32 = dataclasses.replace(mcfg, dtype=torch.float32)
    p32, a32 = _upcast_layers(params, L), _upcast_layers(adapters, L)
    del params, adapters
    torch.cuda.empty_cache()
    routes = {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        lg, tk = embeds_stream(m32, p32, a32, cfg[mode], embeds.float(),
                               gen_len=ARCH_GEN, max_len=MAX_LEN)
        routes[mode] = (lg, tk, launch_counts())
    (lk, tk, ck), (le, te, ce) = routes["auto"], routes["eager"]
    check(ck == serve_counts(m32, auto, prefill_rows=BATCH * PROMPT,
                             decode_rows=BATCH, decode_steps=ARCH_GEN)
          and sum(ce.values()) == 0,
          f"{VL_ARCH} fp32 routes launched {ck} and {ce}")
    routes_out = {"prefill_logit_cosine": cosine(lk, le),
                  "tokens_equal": bool(torch.equal(tk, te)),
                  "kernel_route_launches": ck}
    print(f"{VL_ARCH} fp32 routes (full depth, from embeddings, kernel vs "
          f"eager): " + json.dumps(routes_out), flush=True)
    check(routes_out["prefill_logit_cosine"] >= COSINE_MIN,
          f"{VL_ARCH} fp32 kernel vs eager cosine "
          f"{routes_out['prefill_logit_cosine']}")
    check(routes_out["tokens_equal"], f"{VL_ARCH} fp32 routes' tokens")
    del p32, a32, routes
    torch.cuda.empty_cache()
    return {"train": train, "train_fp32_routes": agree, "serve": served,
            "fp32_routes": routes_out}


def arch_checks(dev) -> dict:
    """A1-A6: phi4-mini-3.8b, chatglm3-6b, musicgen-medium, qwen3-32b,
    qwen2-vl-72b and llama4-scout-17b-a16e (MoE: 16 experts top-1 in every
    layer, no shared expert) at their published widths, each at the depth
    of ARCH_DEPTH (printed with its published depth), random weights from
    a seed, DoRA r=384 on every projection the reference adapts:
    ``generate`` (bf16, auto), batch 4, prompt 960 padded to 1024, 8
    greedy tokens, with the launch counts the port's dispatch gives before
    the run (llama4-scout: K1 = 48, K6 = 24 on wq and wo); for the MoE
    arch, the dropped share per layer of a padded prefill and the bound
    of decode's read of every expert's weights; then copies of the
    weights' first ARCH_AGREE_LAYERS layers (the rest freed) upcast to
    fp32, kernel route against eager route: prefill logit cosine >=
    0.9999, equal tokens, and for the MoE arch the routing flips between
    the routes counted layer by layer with each flip's margin."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (StepConfig, make_precompute_step,
                                          make_prefill_step)

    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "eager")}
    auto = cfg["auto"].dora
    out = {}
    for arch, depth in ARCH_DEPTH.items():
        full = get_config(arch)
        mcfg = dataclasses.replace(full, num_layers=depth)
        _check_shapes_held(mcfg)
        t0 = time.perf_counter()
        params, adapters = serve.build_state(mcfg, auto, SEED, dev)
        adapters = perturb_adapters(
            adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        cut = (f"depth cut to {depth} of {full.num_layers} layers"
               if depth < full.num_layers else
               f"full depth, {depth} layers")
        print(f"{arch}: published widths (d_model {mcfg.d_model}, "
              f"{mcfg.num_heads} heads of {mcfg.head_dim}, "
              f"{mcfg.num_kv_heads} KV heads, d_ff {mcfg.d_ff} "
              f"{mcfg.mlp_kind}, vocab "
              f"{mcfg.vocab_size}, {mcfg.pos_mode}, {mcfg.norm_kind} norm"
              f"{', qk-norm' if mcfg.qk_norm else ''}"
              + (f", {mcfg.num_experts} experts of {mcfg.moe_d_ff} top-"
                 f"{mcfg.top_k}" if mcfg.moe else "")
              + f"), {cut}; built with r={RANK} DoRA in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        prompts = np.random.default_rng(SEED).integers(
            0, mcfg.vocab_size, (BATCH, PROMPT))
        serve.generate(mcfg, params, adapters, cfg["auto"], prompts,
                       gen_len=1, max_len=MAX_LEN, device=dev)
        want = serve_counts(mcfg, auto, prefill_rows=BATCH * MAX_LEN,
                            decode_rows=BATCH, decode_steps=ARCH_GEN)
        torch.cuda.reset_peak_memory_stats(dev)
        stats: dict = {}
        kernels.reset_launch_counts()
        mma0 = kernels.compose_mm_fwd.mma_launches
        toks, logits = serve.generate(
            mcfg, params, adapters, cfg["auto"], prompts, gen_len=ARCH_GEN,
            max_len=MAX_LEN, device=dev, return_logits=True, stats=stats)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == want, f"{arch} serve launch counts {counts}, the "
              f"dispatch plans give {want}")
        check_k6_on_tensor_cores(mma0, counts, f"{arch} serve")
        check(all(torch.isfinite(lg.float()).all().item() for lg in logits)
              and ((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
              f"{arch} serve: non-finite logits or tokens out of range")
        rec = {"layers": depth, "published_layers": full.num_layers,
               "precompute_ms": stats["precompute_s"] * 1e3,
               "prefill_ms": stats["prefill_s"] * 1e3,
               "decode_ms_per_token": stats["decode_s"] * 1e3 / ARCH_GEN,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated(dev),
               "launches": counts}
        del logits
        if mcfg.moe:
            expert_bytes = (depth * 3 * mcfg.num_experts * mcfg.moe_d_ff
                            * mcfg.d_model * 2)
            rec["decode_expert_read_bound_ms"] = \
                expert_bytes / HBM_BYTES_PER_S * 1e3
            state = make_precompute_step(mcfg, cfg["auto"])(params, adapters)
            with moe_recording() as moe_rec:
                make_prefill_step(mcfg, cfg["auto"], batch=BATCH,
                                  seq=MAX_LEN, padded=True)(
                    params, state, {"tokens": torch.nn.functional.pad(
                        torch.as_tensor(prompts, device=dev),
                        (0, MAX_LEN - PROMPT)), "prompt_len": PROMPT})
            rec["prefill_dropped_share_by_layer"] = dropped_shares(moe_rec)
            del state, moe_rec
        n = ARCH_AGREE_LAYERS
        m32 = dataclasses.replace(mcfg, num_layers=n, dtype=torch.float32)
        params, adapters = (_first_layers(params, n),
                            _first_layers(adapters, n))
        _empty_cache(dev)
        p32, a32 = _upcast_layers(params, n), _upcast_layers(adapters, n)
        del params, adapters
        _empty_cache(dev)
        routes, moe_routes = {}, {}
        for mode in ("auto", "eager"):
            kernels.reset_launch_counts()
            with moe_recording(margins=True) as moe_routes[mode]:
                tk, lg = serve.generate(m32, p32, a32, cfg[mode], prompts,
                                        gen_len=ARCH_GEN, max_len=MAX_LEN,
                                        device=dev, return_logits=True)
            routes[mode] = (lg[0].float(), tk, launch_counts())
        (lk, tk, ck), (le, te, ce) = routes["auto"], routes["eager"]
        check(ck == serve_counts(m32, auto, prefill_rows=BATCH * MAX_LEN,
                                 decode_rows=BATCH, decode_steps=ARCH_GEN)
              and sum(ce.values()) == 0,
              f"{arch} fp32 routes launched {ck} and {ce}")
        rec["fp32_routes"] = {
            "layers": ARCH_AGREE_LAYERS,
            "prefill_logit_cosine": cosine(lk, le),
            "tokens_equal": bool(torch.equal(tk, te))}
        if mcfg.moe:
            rec["fp32_routes"]["prefill_route_flips_by_layer"] = route_flips(
                moe_routes["auto"], moe_routes["eager"], n)
        print(f"serve {arch} (bf16, auto; fp32 routes at "
              f"{ARCH_AGREE_LAYERS} layers): " + json.dumps(rec),
              flush=True)
        check(rec["fp32_routes"]["prefill_logit_cosine"] >= COSINE_MIN,
              f"{arch} fp32 kernel vs eager cosine {rec['fp32_routes']}")
        check(rec["fp32_routes"]["tokens_equal"],
              f"{arch} fp32 routes' greedy tokens differ")
        out[arch] = rec
        del p32, a32, routes, moe_routes
        _empty_cache(dev)
    return out


# ---------------------------------------------------------------------------
# MoE: qwen2-moe-a2.7b served and trained at full width and depth (MoE1-
# MoE3); llama4-scout-17b-a16e is served with the dense family (A6).
# ---------------------------------------------------------------------------

# The functions of models/moe.py that a profiled MoE step times, each in
# a record_function range of this name.
MOE_RANGES = {"router_topk": "moe.router",
              "_dispatch_indices": "moe.dispatch_indices",
              "_dispatch": "moe.scatter", "_expert_ffn": "moe.experts",
              "_combine": "moe.gather"}


@contextlib.contextmanager
def moe_ranges():
    """Each MOE_RANGES function of ``models/moe.py`` inside a
    ``record_function`` range of its name while the block runs (for
    ``profile(ranges=...)``); yields the range names."""
    from repro_torch.models import moe as MOE

    saved = {f: getattr(MOE, f) for f in MOE_RANGES}

    def ranged(fn, name):
        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return wrapper
    for f, name in MOE_RANGES.items():
        setattr(MOE, f, ranged(saved[f], name))
    try:
        yield tuple(MOE_RANGES.values())
    finally:
        for f, fn in saved.items():
            setattr(MOE, f, fn)


@contextlib.contextmanager
def moe_recording(margins: bool = False):
    """What the MoE layers route while the block runs, call by call and
    outside every launch count: each router call's gate_i under "route"
    (with ``margins``, also each token's least gap between neighbours of
    its k + 1 largest probabilities, recomputed from the router's input:
    the change of probability that would change its experts or their
    order), each dispatch's slot and keep under "dispatch"."""
    from repro_torch.models import moe as MOE

    rec = {"route": [], "dispatch": []}
    router, dispatch = MOE.router_topk, MOE._dispatch_indices

    def router_rec(x, w, cfg):
        out = router(x, w, cfg)
        entry = {"gate_i": out[1].detach().clone()}
        if margins and cfg.top_k < cfg.num_experts:
            with torch.no_grad():
                probs = torch.softmax(x.detach().float() @ w.float().T, -1)
                top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
                entry["margin"] = (top[..., :-1] - top[..., 1:]).amin(-1)
        rec["route"].append(entry)
        return out

    def dispatch_rec(gate_i, E, capacity):
        slot, keep = dispatch(gate_i, E, capacity)
        rec["dispatch"].append({"slot": slot.clone(), "keep": keep.clone()})
        return slot, keep
    MOE.router_topk, MOE._dispatch_indices = router_rec, dispatch_rec
    try:
        yield rec
    finally:
        MOE.router_topk, MOE._dispatch_indices = router, dispatch


def dropped_shares(rec) -> list:
    """The share of dropped assignments of each recorded dispatch."""
    return [1.0 - d["keep"].float().mean().item() for d in rec["dispatch"]]


def route_flips(got, want, calls: int) -> list:
    """For each of the first ``calls`` recorded router calls (a layer
    each), the tokens whose experts (the set or their order) differ
    between two runs, with ``want``'s margin at each flip (at most 16
    listed) and its least margin over all tokens."""
    out = []
    for a, b in zip(got["route"][:calls], want["route"][:calls]):
        flip = (a["gate_i"] != b["gate_i"]).any(dim=-1)
        out.append({"flips": int(flip.sum()),
                    "flip_margins": b["margin"][flip][:16].tolist(),
                    "least_margin": float(b["margin"].min())})
    return out


def moe_checks(dev) -> dict:
    """MoE1-MoE3: qwen2-moe-a2.7b (24 layers, d_model 2048, 60 routed
    experts of 1408 top-4 and a shared expert of 5632 behind a sigmoid
    gate) at full width and depth, random weights from a seed, DoRA r=384
    on the seven projections the reference adapts (wq, wk, wv, wo and the
    shared expert's w_gate, w_up, w_down; the routed experts, the router
    and the gate stay frozen):

      MoE1. ``generate`` (bf16, auto), batch 4, prompt 960 padded to 1024,
          32 greedy tokens: K1 = assembled = 168 at precompute, K6 = 48
          (the shared expert's w_gate and w_up) at prefill, nothing at
          decode; precompute, prefill and decode ms, peak memory; the
          share of dropped assignments per layer at prefill (capacity 85
          from the padded 1024); one profiled decode step's idle share
          beside the bound of its read of every expert's weights;
      MoE2. 3 train steps (bf16, auto), batch 2 x seq 2048, loss on the
          last 1024, layer remat, AdamW: per step K1 = assembled = 168,
          K6 = 96 (forward and recompute), K7 = 48, nothing else; step
          ms, tokens/s, peak (the memory reckoning printed first); one
          profiled step with the device time of the MoE functions by
          range; one more gradient step recording the routing: each
          layer's recompute routes bitwise as its forward did;
      MoE3. one layer's router and dispatch called twice on one input
          give the same gate weights, gate_i, slots and keep; the first
          MOE_AGREE_LAYERS layers upcast to fp32, kernel route against
          eager route: train loss within 1e-5 relative, adapter-gradient
          cosine >= 0.99999, prefill logit cosine >= 0.9999, equal greedy
          tokens; the routing flips between the two routes counted layer
          by layer, with each flip's margin."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                          make_grad_step,
                                          make_precompute_step,
                                          make_prefill_step)
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE

    mcfg = get_config(MOE_ARCH)
    L, E, D = mcfg.num_layers, mcfg.num_experts, mcfg.d_model
    _check_shapes_held(mcfg)
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "eager")}
    auto = cfg["auto"].dora
    _empty_cache(dev)
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, auto, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    _sync(dev)
    print(f"moe: built {MOE_ARCH} ({L} layers, d_model {D}, "
          f"{mcfg.num_heads} heads, {E} experts of {mcfg.moe_d_ff} top-"
          f"{mcfg.top_k}, a shared expert of {mcfg.shared_d_ff}, vocab "
          f"{mcfg.vocab_size}, {mcfg.dtype}) with r={RANK} DoRA on 7 "
          f"targets in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))

    def capacity(seq):
        return max(int(mcfg.capacity_factor * mcfg.top_k * seq / E), 1)

    # --- MoE1: serving, bf16, auto ---
    serve.generate(mcfg, params, adapters, cfg["auto"], prompts, gen_len=1,
                   max_len=MAX_LEN, device=dev)
    want = serve_counts(mcfg, auto, prefill_rows=BATCH * MAX_LEN,
                        decode_rows=BATCH, decode_steps=GEN)
    check(want == counts_of(norm_terms=7 * L, assembled=7 * L,
                            compose_mm_fwd=2 * L),
          f"{MOE_ARCH} serve: the dispatch plans give {want}")
    _reset_peak(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    mma0 = kernels.compose_mm_fwd.mma_launches
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=MAX_LEN, device=dev, return_logits=True, stats=stats)
    _sync(dev)
    counts = launch_counts()
    check(counts == want, f"{MOE_ARCH} serve launch counts {counts}")
    check_k6_on_tensor_cores(mma0, counts, f"{MOE_ARCH} serve")
    check(tuple(toks.shape) == (BATCH, PROMPT + GEN)
          and all(torch.isfinite(lg.float()).all().item() for lg in logits)
          and ((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          f"{MOE_ARCH} serve: non-finite logits or tokens out of range")
    expert_bytes = L * 3 * E * mcfg.moe_d_ff * D * 2
    served = {
        "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": _peak(dev), "launches": counts,
        "prefill_capacity": capacity(MAX_LEN),
        "unpadded_capacity": capacity(PROMPT),
        "decode_expert_bytes": expert_bytes,
        "decode_expert_read_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3}
    del logits
    # The padded prefill again, recording each layer's dispatch, and one
    # decode step under the profiler (both outside the counts).
    state = make_precompute_step(mcfg, cfg["auto"])(params, adapters)
    prefill = make_prefill_step(mcfg, cfg["auto"], batch=BATCH,
                                seq=MAX_LEN, padded=True)
    padded = {"tokens": torch.nn.functional.pad(
        torch.as_tensor(prompts, device=dev), (0, MAX_LEN - PROMPT)),
        "prompt_len": PROMPT}
    with moe_recording() as rec:
        last, cache = prefill(params, state, padded)
    shares = dropped_shares(rec)
    check(len(shares) == L, f"{MOE_ARCH} prefill recorded {len(shares)} "
          f"dispatches")
    served["prefill_dropped_share_by_layer"] = shares
    decode = make_decode_step(mcfg, cfg["auto"], batch=BATCH)
    nxt = last.argmax(dim=-1)[:, None]
    served["decode_profile"] = profile(
        lambda: decode(params, state, cache, {"tokens": nxt}),
        f"serve {MOE_ARCH} decode step (bf16)")
    print(f"serve {MOE_ARCH} (bf16, auto): " + json.dumps(
        {k: v for k, v in served.items() if k != "decode_profile"}),
        flush=True)
    del state, cache, last, rec
    _empty_cache(dev)

    # --- MoE2: training, bf16, auto ---
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves_sorted(tree))

    ad32 = sum(t.numel() * 4 for t in _leaves_sorted(adapters))
    reckoning = {
        "weights_gb": _gb(nbytes(params)),
        "adapters_gb": _gb(nbytes(adapters)),
        "grads_gb": _gb(ad32), "adamw_gb": _gb(2 * ad32),
        "layer_inputs_gb": _gb(L * TRAIN_BATCH * TRAIN_SEQ * D * 2),
        "logits_fp32_gb": _gb(TRAIN_BATCH * LOSS_TOKENS * mcfg.vocab_size
                              * 4),
        "expert_buffer_one_layer_gb": _gb(E * TRAIN_BATCH
                                          * capacity(TRAIN_SEQ) * D * 2)}
    reckoning["total_gb"] = round(sum(reckoning.values()), 2)
    print(f"{MOE_ARCH} train memory reckoning ({L} layers, r={RANK}): "
          + json.dumps(reckoning), flush=True)
    batches = _train_batches(mcfg, TRAIN_STEPS)
    want = train_counts(mcfg, auto, rows=TRAIN_BATCH * TRAIN_SEQ)
    check(want == counts_of(norm_terms=7 * L, assembled=7 * L,
                            compose_mm_fwd=4 * L, compose_mm_bwd=2 * L),
          f"{MOE_ARCH} train: the dispatch plans give {want}")
    mma0 = kernels.compose_mm_fwd.mma_launches
    train = _steps_on(dev, mcfg, params, adapters, auto, batches,
                      f"{MOE_ARCH} auto")
    check_k6_on_tensor_cores(mma0, train["launches"], f"{MOE_ARCH} train")
    for i, got in enumerate(train["launches_per_step"]):
        check(got == want, f"{MOE_ARCH} train step {i} launch counts {got}")
    train["reckoning"] = reckoning
    with moe_ranges() as names:
        train["profile"] = _profile_step(dev, mcfg, params, adapters, auto,
                                         batches[-1], ranges=names)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    grad_step = make_grad_step(mcfg, StepConfig(dora=auto,
                                                loss_tokens=LOSS_TOKENS),
                               batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    with moe_recording() as rec:
        grad_step(params, adapters, bt)
    # The forward routes layers 0..L-1; the backward recomputes them from
    # the last layer down.
    fwd = list(zip(rec["route"][:L], rec["dispatch"][:L]))
    again = list(zip(rec["route"][L:], rec["dispatch"][L:]))[::-1]
    same = [torch.equal(r0["gate_i"], r1["gate_i"])
            and torch.equal(d0["slot"], d1["slot"])
            and torch.equal(d0["keep"], d1["keep"])
            for (r0, d0), (r1, d1) in zip(fwd, again)]
    check(len(rec["route"]) == 2 * L and all(same),
          f"{MOE_ARCH} train: the recompute routed differently from the "
          f"forward ({len(rec['route'])} router calls, layers equal: "
          f"{same})")
    train["recompute_routes_bitwise"] = True
    train["train_dropped_share_by_layer"] = dropped_shares(
        {"dispatch": rec["dispatch"][:L]})
    del rec

    # --- MoE3: one layer routed twice; the routes in fp32 ---
    layer = lm._slice_tree(params["stack"], 0)["l0"]["ffn"]
    h = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, D), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 5))).to(mcfg.dtype)
    runs = []
    for _ in range(2):
        w, i, _ = MOE.router_topk(h, layer["router"], mcfg)
        runs.append((w, i, *MOE._dispatch_indices(i, E,
                                                   capacity(TRAIN_SEQ))))
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{MOE_ARCH}: one layer's routing differs between two calls")
    del runs, h, layer
    n = MOE_AGREE_LAYERS
    m32 = dataclasses.replace(mcfg, num_layers=n, dtype=torch.float32)
    p32, a32 = _upcast_layers(params, n), _upcast_layers(adapters, n)
    del params, adapters
    _empty_cache(dev)
    agree, grads, routes = {}, {}, {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        with moe_recording(margins=True) as routes[mode]:
            loss, g = make_grad_step(m32, StepConfig(
                dora=cfg[mode].dora, loss_tokens=LOSS_TOKENS),
                batch=TRAIN_BATCH, seq=TRAIN_SEQ)(p32, a32, bt)
        agree[mode] = {"loss": float(loss), "launches": launch_counts()}
        grads[mode] = torch.cat([t.flatten() for t in
                                 _leaves_sorted(g)]).double()
        del g
    check(agree["auto"]["launches"] == train_counts(
        m32, auto, rows=TRAIN_BATCH * TRAIN_SEQ)
        and sum(agree["eager"]["launches"].values()) == 0,
        f"{MOE_ARCH} fp32 train routes launched {agree}")
    agree["loss_rel"] = abs(agree["auto"]["loss"] / agree["eager"]["loss"]
                            - 1)
    agree["grad_cosine"] = cosine(grads["auto"], grads["eager"])
    agree["route_flips_by_layer"] = route_flips(routes["auto"],
                                                routes["eager"], n)
    del grads, routes
    print(f"{MOE_ARCH} train fp32 routes ({n} layers, kernel vs eager): "
          + json.dumps(agree), flush=True)
    check(agree["loss_rel"] <= 1e-5,
          f"{MOE_ARCH} fp32 kernel loss differs by {agree['loss_rel']}")
    check(agree["grad_cosine"] >= GRAD_COSINE_MIN,
          f"{MOE_ARCH} fp32 gradient cosine {agree['grad_cosine']}")
    routes, outs = {}, {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        with moe_recording(margins=True) as routes[mode]:
            tk, lg = serve.generate(m32, p32, a32, cfg[mode], prompts,
                                    gen_len=ARCH_GEN, max_len=MAX_LEN,
                                    device=dev, return_logits=True)
        outs[mode] = (lg[0].float(), tk, launch_counts())
    (lk, tk, ck), (le, te, ce) = outs["auto"], outs["eager"]
    check(ck == serve_counts(m32, auto, prefill_rows=BATCH * MAX_LEN,
                             decode_rows=BATCH, decode_steps=ARCH_GEN)
          and sum(ce.values()) == 0,
          f"{MOE_ARCH} fp32 serve routes launched {ck} and {ce}")
    serve32 = {"layers": n, "prefill_logit_cosine": cosine(lk, le),
               "tokens_equal": bool(torch.equal(tk, te)),
               "prefill_route_flips_by_layer": route_flips(
                   routes["auto"], routes["eager"], n)}
    print(f"serve {MOE_ARCH} fp32 routes ({n} layers, kernel vs eager): "
          + json.dumps(serve32), flush=True)
    check(serve32["prefill_logit_cosine"] >= COSINE_MIN,
          f"{MOE_ARCH} fp32 kernel vs eager cosine {serve32}")
    check(serve32["tokens_equal"], f"{MOE_ARCH} fp32 routes' tokens differ")
    del p32, a32, routes, outs
    _empty_cache(dev)
    return {"serve": served, "train": train, "train_fp32_routes": agree,
            "serve_fp32_routes": serve32}


# ---------------------------------------------------------------------------
# The hybrid jamba-v0.1-52b at full width on two of its four 8-layer units.
# ---------------------------------------------------------------------------

# 16 of 32 layers (n_scan 2): 52.1 GB of bf16 weights, 25.5 GB a unit of
# which 22.5 GB are its four MoE layers' experts. J2 trains at 16 layers
# when the reckoned peak is at most JAMBA_TRAIN_PEAK, else at one unit.
JAMBA_ARCH, JAMBA_LAYERS, JAMBA_TRAIN_PEAK = "jamba-v0.1-52b", 16, 72e9


def _upcast_first_units(tree, n: int, stacked: bool = False):
    """``tree`` cut to its first ``n`` stack slices and cast to fp32 leaf
    by leaf IN PLACE: each bf16 leaf is dropped as soon as its fp32 copy
    exists, so the peak stays near the fp32 copy's size (the bf16 tree
    and an fp32 copy of a whole unit do not fit the card together)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _upcast_first_units(v, n, stacked or k == "stack")
        else:
            tree[k] = (v[:n] if stacked else v).to(torch.float32,
                                                   copy=True)
    return tree


def jamba_counts(mcfg, dcfg, *, train: bool) -> dict:
    """The launch counts of a jamba ``generate`` (precompute, the exact
    BATCH x PROMPT prefill, GEN decode steps) or of one train step, from
    the dispatch plans, with K9 once per Mamba layer at prefill (decode
    steps the recurrence without it) and, in a train step, twice (forward
    and recompute, with chunk states) and the scan's backward once."""
    n_mamba = mcfg.layer_kinds().count("mamba")
    if train:
        return {**train_counts(mcfg, dcfg, rows=TRAIN_BATCH * TRAIN_SEQ),
                "selective_scan": 2 * n_mamba,
                "selective_scan_bwd": n_mamba}
    return {**serve_counts(mcfg, dcfg, prefill_rows=BATCH * PROMPT,
                           decode_rows=BATCH, decode_steps=GEN),
            "selective_scan": n_mamba}


def jamba_checks(dev) -> dict:
    """J1-J3: jamba-v0.1-52b at full width (d_model 4096, 32 heads, 8 KV
    heads, NoPE attention at index 4 of each 8-layer unit, seven Mamba-1
    layers of d_inner 8192, a dense MLP of 14336 on even layers and 16
    experts of 14336 top-2 on odd ones) on JAMBA_LAYERS = 16 of its 32
    layers (two units), random weights from a seed, DoRA r=384 on the 30
    modules of a unit the reference adapts (wq, wk, wv, wo; in_proj and
    out_proj; w_gate, w_up, w_down; the experts and the router frozen):

      J1. ``generate`` (bf16, auto), batch 4, prompt 960 at its exact
          length (Mamba states cannot rewind a padded prefill), 32 greedy
          tokens: K1 = assembled = 60 at precompute, K6 = 56 and K9 = 14
          at prefill, nothing at decode; precompute, prefill and decode
          ms, peak; the dropped share of each MoE layer at prefill; one
          profiled prefill and decode step with their idle shares;
      J2. 3 train steps (bf16, auto), batch 2 x seq 2048, loss on the
          last 1024, layer remat, AdamW, at 16 layers if the reckoned
          peak (printed first) is at most JAMBA_TRAIN_PEAK, else at one
          unit: per step K1 = assembled = 60, K6 = 112, K7 = 56, K9 = 28
          (with chunk states), the scan's backward 14; step ms, tokens/s,
          peak; one profiled step with the MoE functions by range; one
          gradient step recording the routing: each MoE layer's recompute
          routes bitwise as its forward;
      J3. the first unit (8 layers) upcast to fp32 after the bf16 model
          is cut to it leaf by leaf: kernel route against eager route,
          train loss within 1e-5 relative, adapter-gradient cosine >=
          0.99999, prefill logit cosine >= 0.9999, equal greedy tokens,
          the routing flips layer by layer with their gaps."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                          make_grad_step,
                                          make_precompute_step,
                                          make_prefill_step)

    mcfg = dataclasses.replace(get_config(JAMBA_ARCH),
                               num_layers=JAMBA_LAYERS)
    L, E, D = mcfg.num_layers, mcfg.num_experts, mcfg.d_model
    n = mcfg.n_scan
    n_moe = mcfg.ffn_kinds().count("moe")
    _check_shapes_held(mcfg)
    cfg = {mode: StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA,
                                            mode=mode))
           for mode in ("auto", "eager")}
    auto = cfg["auto"].dora
    _empty_cache(dev)
    t0 = time.perf_counter()
    params, adapters = serve.build_state(mcfg, auto, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    _sync(dev)
    print(f"jamba: built {JAMBA_ARCH} ({L} of 32 layers, {n} units of "
          f"{mcfg.period}: {mcfg.layer_kinds()[:mcfg.period]}, "
          f"{mcfg.ffn_kinds()[:mcfg.period]}; d_model {D}, {E} experts of "
          f"{mcfg.moe_d_ff} top-{mcfg.top_k}, vocab {mcfg.vocab_size}, "
          f"{mcfg.dtype}, {mcfg.count_params()} params) with r={RANK} DoRA "
          f"on 30 modules a unit in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, mcfg.vocab_size, (BATCH, PROMPT))
    max_len = PROMPT + GEN

    def capacity(seq):
        return max(int(mcfg.capacity_factor * mcfg.top_k * seq / E), 1)

    # --- J1: serving, bf16, auto ---
    want = jamba_counts(mcfg, auto, train=False)
    check(want == counts_of(norm_terms=30 * n, assembled=30 * n,
                            compose_mm_fwd=28 * n, selective_scan=7 * n),
          f"{JAMBA_ARCH} serve: the dispatch plans give {want}")
    serve.generate(mcfg, params, adapters, cfg["auto"], prompts, gen_len=1,
                   max_len=max_len, device=dev)
    _reset_peak(dev)
    stats: dict = {}
    kernels.reset_launch_counts()
    mma0 = kernels.compose_mm_fwd.mma_launches
    toks, logits = serve.generate(
        mcfg, params, adapters, cfg["auto"], prompts, gen_len=GEN,
        max_len=max_len, device=dev, return_logits=True, stats=stats)
    _sync(dev)
    counts = launch_counts()
    check(counts == want, f"{JAMBA_ARCH} serve launch counts {counts}")
    check_k6_on_tensor_cores(mma0, counts, f"{JAMBA_ARCH} serve")
    check(tuple(toks.shape) == (BATCH, PROMPT + GEN)
          and all(torch.isfinite(lg.float()).all().item() for lg in logits)
          and ((toks >= 0) & (toks < mcfg.vocab_size)).all().item(),
          f"{JAMBA_ARCH} serve: non-finite logits or tokens out of range")
    served = {
        "layers": L, "precompute_ms": stats["precompute_s"] * 1e3,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": stats["decode_s"] * 1e3 / GEN,
        "decode_tok_per_s": BATCH * GEN / stats["decode_s"],
        "max_memory_allocated_bytes": _peak(dev), "launches": counts,
        "prefill_capacity": capacity(PROMPT)}
    del logits
    # The exact-length prefill again, recording each MoE layer's dispatch,
    # then a profiled prefill and decode step (all outside the counts).
    state = make_precompute_step(mcfg, cfg["auto"])(params, adapters)
    prefill = make_prefill_step(mcfg, cfg["auto"], batch=BATCH,
                                seq=max_len)
    decode = make_decode_step(mcfg, cfg["auto"], batch=BATCH)
    tok_in = torch.as_tensor(prompts, device=dev)
    with moe_recording() as rec:
        prefill(params, state, {"tokens": tok_in})
    shares = dropped_shares(rec)
    check(len(shares) == n_moe, f"{JAMBA_ARCH} prefill recorded "
          f"{len(shares)} dispatches")
    served["prefill_dropped_share_by_moe_layer"] = shares
    held = {}

    def run_prefill():
        held["logits"], held["cache"] = prefill(params, state,
                                                {"tokens": tok_in})
    served["prefill_profile"] = profile(run_prefill,
                                        f"serve {JAMBA_ARCH} prefill (bf16)")
    nxt = held["logits"].argmax(dim=-1)[:, None]
    served["decode_profile"] = profile(
        lambda: decode(params, state, held["cache"], {"tokens": nxt}),
        f"serve {JAMBA_ARCH} decode step (bf16)")
    print(f"serve {JAMBA_ARCH} (bf16, auto): " + json.dumps(
        {k: v for k, v in served.items() if not k.endswith("_profile")}),
        flush=True)
    del state, held, rec, prefill, decode
    _empty_cache(dev)

    # --- J2: training, bf16, auto ---
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves_sorted(tree))

    ad32 = sum(t.numel() * 4 for t in _leaves_sorted(adapters))
    groups = TRAIN_BATCH * capacity(TRAIN_SEQ)
    reckoning = {
        "weights_gb": _gb(nbytes(params)),
        "adapters_gb": _gb(nbytes(adapters)),
        "grads_gb": _gb(ad32), "adamw_gb": _gb(2 * ad32),
        "layer_inputs_gb": _gb(L * TRAIN_BATCH * TRAIN_SEQ * D * 2),
        "logits_fp32_gb": _gb(2 * TRAIN_BATCH * LOSS_TOKENS
                              * mcfg.vocab_size * 4),
        # One MoE layer's backward: the dispatched tokens and the gate, up
        # and activation products of every expert slot, and their grads.
        "moe_layer_gb": _gb(2 * E * groups * (D + 3 * mcfg.moe_d_ff) * 2),
        "chunk_states_one_layer_gb": _gb(
            TRAIN_BATCH * -(-TRAIN_SEQ // 32) * mcfg.ssm_state
            * mcfg.d_inner * 4)}
    reckoning["total_gb"] = round(sum(reckoning.values()), 2)
    print(f"{JAMBA_ARCH} train memory reckoning ({L} layers, r={RANK}): "
          + json.dumps(reckoning), flush=True)
    if reckoning["total_gb"] * 1e9 <= JAMBA_TRAIN_PEAK:
        tcfg, tp, ta = mcfg, params, adapters
    else:
        print(f"{JAMBA_ARCH} trains at one unit: the reckoned peak "
              f"{reckoning['total_gb']} GB is above "
              f"{JAMBA_TRAIN_PEAK / 1e9:.0f} GB", flush=True)
        tcfg = dataclasses.replace(mcfg, num_layers=mcfg.period)
        tp, ta = _first_layers(params, 1), _first_layers(adapters, 1)
    batches = _train_batches(tcfg, TRAIN_STEPS)
    want = jamba_counts(tcfg, auto, train=True)
    tn = tcfg.n_scan
    check(want == counts_of(norm_terms=30 * tn, assembled=30 * tn,
                            compose_mm_fwd=56 * tn, compose_mm_bwd=28 * tn,
                            selective_scan=14 * tn,
                            selective_scan_bwd=7 * tn),
          f"{JAMBA_ARCH} train: the dispatch plans give {want}")
    mma0 = kernels.compose_mm_fwd.mma_launches
    train = _steps_on(dev, tcfg, tp, ta, auto, batches, f"{JAMBA_ARCH} auto")
    check_k6_on_tensor_cores(mma0, train["launches"], f"{JAMBA_ARCH} train")
    for i, got in enumerate(train["launches_per_step"]):
        check(got == want, f"{JAMBA_ARCH} train step {i} launch counts {got}")
    train.update(layers=tcfg.num_layers, reckoning=reckoning)
    with moe_ranges() as names:
        train["profile"] = _profile_step(dev, tcfg, tp, ta, auto,
                                         batches[-1], ranges=names)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    grad_step = make_grad_step(tcfg, StepConfig(dora=auto,
                                                loss_tokens=LOSS_TOKENS),
                               batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    with moe_recording() as rec:
        grad_step(tp, ta, bt)
    # The forward routes the MoE layers first to last; the backward
    # recomputes them from the last down.
    m = tcfg.ffn_kinds().count("moe")
    fwd = list(zip(rec["route"][:m], rec["dispatch"][:m]))
    again = list(zip(rec["route"][m:], rec["dispatch"][m:]))[::-1]
    same = [torch.equal(r0["gate_i"], r1["gate_i"])
            and torch.equal(d0["slot"], d1["slot"])
            and torch.equal(d0["keep"], d1["keep"])
            for (r0, d0), (r1, d1) in zip(fwd, again)]
    check(len(rec["route"]) == 2 * m and all(same),
          f"{JAMBA_ARCH} train: the recompute routed differently from the "
          f"forward ({len(rec['route'])} router calls, layers equal: "
          f"{same})")
    train["recompute_routes_bitwise"] = True
    train["train_dropped_share_by_moe_layer"] = dropped_shares(
        {"dispatch": rec["dispatch"][:m]})
    del rec, tp, ta, grad_step

    # --- J3: the first unit in fp32, kernel route vs eager route ---
    m32 = dataclasses.replace(mcfg, num_layers=mcfg.period,
                              dtype=torch.float32)
    p32 = _upcast_first_units(params, 1)
    a32 = _upcast_first_units(adapters, 1)
    del params, adapters
    _empty_cache(dev)
    agree, grads, routes = {}, {}, {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        with moe_recording(margins=True) as routes[mode]:
            loss, g = make_grad_step(m32, StepConfig(
                dora=cfg[mode].dora, loss_tokens=LOSS_TOKENS),
                batch=TRAIN_BATCH, seq=TRAIN_SEQ)(p32, a32, bt)
        agree[mode] = {"loss": float(loss), "launches": launch_counts()}
        grads[mode] = torch.cat([t.flatten() for t in
                                 _leaves_sorted(g)]).double()
        del g
    check(agree["auto"]["launches"] == jamba_counts(m32, auto, train=True)
          and sum(agree["eager"]["launches"].values()) == 0,
          f"{JAMBA_ARCH} fp32 train routes launched {agree}")
    agree["layers"] = m32.num_layers
    agree["loss_rel"] = abs(agree["auto"]["loss"] / agree["eager"]["loss"]
                            - 1)
    agree["grad_cosine"] = cosine(grads["auto"], grads["eager"])
    agree["route_flips_by_moe_layer"] = route_flips(
        routes["auto"], routes["eager"], m32.ffn_kinds().count("moe"))
    del grads, routes
    print(f"{JAMBA_ARCH} train fp32 routes ({m32.num_layers} layers, kernel "
          f"vs eager): " + json.dumps(agree), flush=True)
    check(agree["loss_rel"] <= 1e-5,
          f"{JAMBA_ARCH} fp32 kernel loss differs by {agree['loss_rel']}")
    check(agree["grad_cosine"] >= GRAD_COSINE_MIN,
          f"{JAMBA_ARCH} fp32 gradient cosine {agree['grad_cosine']}")
    routes, outs = {}, {}
    for mode in ("auto", "eager"):
        kernels.reset_launch_counts()
        with moe_recording(margins=True) as routes[mode]:
            tk, lg = serve.generate(m32, p32, a32, cfg[mode], prompts,
                                    gen_len=ARCH_GEN,
                                    max_len=PROMPT + ARCH_GEN, device=dev,
                                    return_logits=True)
        outs[mode] = (lg[0].float(), tk, launch_counts())
    (lk, tk, ck), (le, te, ce) = outs["auto"], outs["eager"]
    want32 = {**serve_counts(m32, auto, prefill_rows=BATCH * PROMPT,
                             decode_rows=BATCH, decode_steps=ARCH_GEN),
              "selective_scan": m32.layer_kinds().count("mamba")}
    check(ck == want32 and sum(ce.values()) == 0,
          f"{JAMBA_ARCH} fp32 serve routes launched {ck} and {ce}")
    serve32 = {"layers": m32.num_layers,
               "prefill_logit_cosine": cosine(lk, le),
               "tokens_equal": bool(torch.equal(tk, te)),
               "prefill_route_flips_by_moe_layer": route_flips(
                   routes["auto"], routes["eager"],
                   m32.ffn_kinds().count("moe"))}
    print(f"serve {JAMBA_ARCH} fp32 routes ({m32.num_layers} layers, kernel "
          f"vs eager): " + json.dumps(serve32), flush=True)
    check(serve32["prefill_logit_cosine"] >= COSINE_MIN,
          f"{JAMBA_ARCH} fp32 kernel vs eager cosine {serve32}")
    check(serve32["tokens_equal"],
          f"{JAMBA_ARCH} fp32 routes' tokens differ")
    del p32, a32, routes, outs
    _empty_cache(dev)
    return {"serve": served, "train": train, "train_fp32_routes": agree,
            "serve_fp32_routes": serve32}


def fused_norm_ab(dev) -> dict:
    """With whichever ``repro_torch`` is importable (for kernel_phase_vs):
    ``kernels.ops.fused_norm``, the norm of one adapted module, in ms by
    events at qwen2-7b's wq, wk, w_gate and w_down (bf16, r = 384) and
    in host µs a call at a small shape; and the qwen2-7b serving
    precompute (the norms of all 196 adapted modules), ms on the host
    clock, 5 runs after a warm-up."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    s = ALPHA / math.sqrt(RANK)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    out = {}
    for d_out, d_in in K1_SHAPES[:4]:
        W = randn(d_out, d_in, scale=d_in ** -0.5)
        A = randn(RANK, d_in, scale=d_in ** -0.5)
        B = randn(d_out, RANK, scale=0.02)
        out[f"fused_norm [{d_out}, {d_in}, {RANK}] ms"] = time_ms(
            lambda: ops.fused_norm(W, A, B, s))
    W, A, B = randn(512, 512, scale=0.05), randn(64, 512, scale=0.05), \
        randn(512, 64, scale=0.02)
    with torch.no_grad():
        out["fused_norm [512, 512, 64] host us"] = host_us(
            lambda: ops.fused_norm(W, A, B, s))
    del W, A, B
    mcfg = get_config(ARCH)
    scfg = StepConfig(dora=DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto"))
    params, adapters = serve.build_state(mcfg, scfg.dora, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 1))
    precompute = make_precompute_step(mcfg, scfg)
    precompute(params, adapters)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = precompute(params, adapters)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        del state
    out["precompute_ms_runs"] = runs
    out["precompute_ms"] = float(np.median(runs))
    del params, adapters
    torch.cuda.empty_cache()
    return out


def kernel_phase_vs(other: Path) -> int:
    """The kernel phase (kernel_checks) of the checkout at ``other`` and of
    this one, in the order other, this, this, other, each in a process of
    its own on this card; then, with this script's own methods on each
    checkout's package, the per-module norm and the qwen2-7b precompute
    (fused_norm_ab) and each wrapper's host time (host_checks). Prints
    K1's, K2's, K9's and the scan backward's rows of each run and writes
    them to build/kernel_phase_vs.json."""
    here = Path(__file__).resolve().parent
    code = ("import importlib.util, json, sys, torch; "
            "sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1]]; "
            "import chip_smoke as c; "
            "spec = importlib.util.spec_from_file_location('this_smoke', "
            "sys.argv[2]); t = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(t); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "dev = torch.device('cuda', 0); "
            "rows = c.kernel_checks(dev); "
            "out = {k: rows[k] for k in ('norm_terms', 'assemble_norm', "
            "'selective_scan', 'selective_scan_bwd')}; "
            "out['fused_norm_ab'] = t.fused_norm_ab(dev); "
            "out['host_us'] = t.host_checks(dev); "
            "print('ROWS ' + json.dumps(out))")
    runs = []
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        run = subprocess.run([sys.executable, "-c", code,
                              str(root.resolve()),
                              str(Path(__file__).resolve())],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        rows = json.loads(run.stdout.split("ROWS ", 1)[1])
        runs.append({"label": label, "root": str(root), **rows})
        for name in ("norm_terms", "assemble_norm", "selective_scan",
                     "selective_scan_bwd"):
            for row in rows[name]:
                print(f"{label}: {name} {row['shape']} {row['ms']:.4f} ms, "
                      f"device {row.get('device_ms')}, library "
                      f"{row['library_ms']}, grid {row.get('grid')}",
                      flush=True)
        print(f"{label}: fused_norm_ab {rows['fused_norm_ab']}")
        print(f"{label}: host us {rows['host_us']}", flush=True)
    out = here / "build" / "kernel_phase_vs.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    return 0


# ---------------------------------------------------------------------------
# falcon-mamba-7b trained at full width and depth.
# ---------------------------------------------------------------------------

def _gb(nbytes) -> float:
    return round(nbytes / 1e9, 2)


def mamba_train_checks(dev) -> dict:
    """MT1-MT2: falcon-mamba-7b (64 layers, d_inner 8192) trained with
    r=384 DoRA on in_proj and out_proj through ``make_train_step``: batch
    2 x seq 2048, loss on the last 1024 tokens, layer remat, AdamW.

      MT1. auto mode in bf16, 3 steps, exact launch counts a step: K1 =
           assembled = 128 (the norms, before the remat checkpoint), K6 =
           256 (in_proj and out_proj, forward and recompute), K7 = 128, K9
           = 128 with chunk states (forward and recompute), the scan's
           backward = 64, nothing else; the memory reckoning printed
           first; step ms, tokens/s, peak memory and one profiled step;
      MT2. the same weights upcast to fp32 at MAMBA_AGREE_LAYERS layers:
           kernel route (K6/K7, K9 with chunk states, the backward kernel)
           against the eager route (autograd of the plain scan loop): loss
           within 1e-5 relative, adapter-gradient cosine >= 0.99999."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import StepConfig, make_grad_step

    mcfg = get_config(MAMBA_ARCH)
    L = mcfg.num_layers
    auto = DoRAConfig(rank=RANK, alpha=ALPHA, mode="auto")
    _empty_cache(dev)
    params, adapters = serve.build_state(mcfg, auto, SEED, dev)
    adapters = perturb_adapters(
        adapters, torch.Generator(device=dev).manual_seed(SEED + 3))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves_sorted(tree))

    # The reckoning: weights, the adapters and their gradient and two AdamW
    # moments (fp32), the 64 layer inputs the remat keeps, and one layer's
    # chunk states.
    ad = nbytes(adapters)
    ad32 = sum(t.numel() * 4 for t in _leaves_sorted(adapters))
    states = (TRAIN_BATCH * -(-TRAIN_SEQ // 32) * mcfg.ssm_state
              * mcfg.d_inner * 4)
    reckoning = {"weights_gb": _gb(nbytes(params)), "adapters_gb": _gb(ad),
                 "grads_gb": _gb(ad32), "adamw_gb": _gb(2 * ad32),
                 "layer_inputs_gb": _gb(L * TRAIN_BATCH * TRAIN_SEQ
                                        * mcfg.d_model * 2),
                 "chunk_states_one_layer_gb": _gb(states)}
    reckoning["total_gb"] = round(sum(reckoning.values()), 2)
    print(f"mamba train memory reckoning ({MAMBA_ARCH}, {L} layers, r="
          f"{RANK}): " + json.dumps(reckoning), flush=True)

    batches = _train_batches(mcfg, TRAIN_STEPS)
    mma0 = kernels.compose_mm_fwd.mma_launches
    rec = _steps_on(dev, mcfg, params, adapters, auto, batches,
                    "mamba auto")
    check_k6_on_tensor_cores(mma0, rec["launches"], "train mamba")
    want = counts_of(norm_terms=2 * L, assembled=2 * L,
                     compose_mm_fwd=4 * L, compose_mm_bwd=2 * L,
                     selective_scan=2 * L, selective_scan_bwd=L)
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"train mamba step {i} launch counts {got}")
    rec["reckoning"] = reckoning
    rec["profile"] = _profile_step(dev, mcfg, params, adapters, auto,
                                   batches[-1])

    # --- MT2: kernel route vs eager route, fp32, MAMBA_AGREE_LAYERS ---
    n = MAMBA_AGREE_LAYERS
    mcfg32 = dataclasses.replace(mcfg, num_layers=n, dtype=torch.float32)
    p32, a32 = _upcast_layers(params, n), _upcast_layers(adapters, n)
    del params, adapters
    _empty_cache(dev)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    agree, grads = {}, {}
    for name, dcfg in (("auto", auto),
                       ("eager", dataclasses.replace(auto, mode="eager"))):
        kernels.reset_launch_counts()
        loss, g = make_grad_step(mcfg32, StepConfig(
            dora=dcfg, loss_tokens=LOSS_TOKENS), batch=TRAIN_BATCH,
            seq=TRAIN_SEQ)(p32, a32, bt)
        grads[name] = torch.cat([t.flatten() for t in
                                 _leaves_sorted(g)]).double()
        agree[name] = {"loss": float(loss), "launches": launch_counts()}
        del g
    check(agree["auto"]["launches"] == counts_of(
              norm_terms=2 * n, assembled=2 * n, compose_mm_fwd=4 * n,
              compose_mm_bwd=2 * n, selective_scan=2 * n,
              selective_scan_bwd=n)
          and sum(agree["eager"]["launches"].values()) == 0,
          f"fp32 mamba train routes launched {agree}")
    rel = abs(agree["auto"]["loss"] / agree["eager"]["loss"] - 1)
    cos = cosine(grads["auto"], grads["eager"])
    agree["auto"].update(loss_rel_to_eager=rel, grad_cosine_to_eager=cos)
    print(f"mamba train fp32 routes ({n} layers, kernel vs eager): "
          + json.dumps(agree), flush=True)
    check(rel <= 1e-5, f"fp32 mamba train loss differs from eager by {rel}")
    check(cos >= GRAD_COSINE_MIN, f"fp32 mamba train gradient cosine {cos}")
    del p32, a32, grads
    _empty_cache(dev)
    return {"train": rec, "fp32_routes": agree}


# ---------------------------------------------------------------------------
# The serve CLI's engine paths at qwen2-7b's full width and depth.
# ---------------------------------------------------------------------------

CLI_BATCH, CLI_PROMPT, CLI_GEN = 8, 1024, 16
# The paged mode's block (and so prefill chunk) size: a divisor of max_len
# 1040 near E1's chunk of 256, so a prompt takes 3-5 chunk steps.
CLI_BLOCK = 208
# Card memory the fleet mode leaves free beyond its reckoning: activations,
# K/V caches, the allocator's slack.
CLI_FLEET_HEADROOM = 20e9


def cli_fleet_tenants(reckoning: dict, card_bytes: int) -> tuple[int, dict]:
    """The number of --fleet tenants whose states fit: the CLI's cache has
    no byte budget, so every tenant's raw tree and serving state stay on
    the card beside the weights and the dynamic stack (FL2's measured
    bytes)."""
    per = reckoning["raw_per_tenant"] + reckoning["state_held"]
    fixed = reckoning["weights"] + reckoning["stack"]
    n = int((card_bytes - CLI_FLEET_HEADROOM - fixed) // per)
    return n, {"weights_gb": _gb(reckoning["weights"]),
               "per_tenant_gb": _gb(per), "stack_gb": _gb(reckoning["stack"]),
               "tenants": n, "predicted_gb": _gb(fixed + n * per),
               "card_gb": _gb(card_bytes)}


def _run_cli(serve, argv: list) -> tuple[str, float, dict]:
    """serve.main(argv) in this process: (its printed output, wall
    seconds, the kernels it launched); the output is echoed."""
    import contextlib
    import io

    from repro_torch import kernels

    buf = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out, wall, launch_counts()


def cli_checks(dev, fl2_reckoning: dict) -> dict:
    """C1-C4: ``repro_torch.launch.serve.main`` at qwen2-7b's full width
    and depth (bf16, r=384, each call its own random weights), --batch 8
    slots, prompts of 512-1024, 16 new tokens:

      C1. --continuous --paged (blocks and chunks of CLI_BLOCK): the pool
          drains, every admission a chunked prefill; the streams against
          the rectangular engine's (counted in bf16);
      C2. --continuous --speculative 3 --trace-out x.jsonl --metrics-out
          x.prom: both files parse, > 0 events and none dropped;
      C3. --continuous --inject nan@3:1,slow@4 --deadline 40 --priority 1:
          every request finishes once with a known reason, the slot table
          drains (asserted by the CLI), a row quarantined, one slow tick;
      C4. --fleet N, N from the memory reckoning printed first: one
          dynamic decode signature, stack inserts counted, the static
          engine's streams against the dynamic one's (counted in bf16).
    Each: K1 = assembled = 196 a cache miss (a tenant's precompute) and
    K8 only on the paged path; wall seconds and tokens/s as the CLI
    prints them."""
    from repro_torch.launch import serve
    from repro_torch.obs import parse_prometheus

    n_adapted = 7 * serve.get_config(ARCH).num_layers
    base = ["--arch", ARCH, "--batch", str(CLI_BATCH), "--prompt-len",
            str(CLI_PROMPT), "--gen-len", str(CLI_GEN), "--rank", str(RANK),
            "--alpha", str(ALPHA), "--seed", str(SEED)]
    out_dir = Path(__file__).resolve().parent / "build" / "cli_obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    jsonl, prom = out_dir / "trace.jsonl", out_dir / "metrics.prom"
    for f in (jsonl, prom):
        f.unlink(missing_ok=True)
    tenants, reckoning = cli_fleet_tenants(
        fl2_reckoning, torch.cuda.get_device_properties(dev).total_memory)
    print("serve CLI --fleet memory reckoning: " + json.dumps(reckoning),
          flush=True)
    check(tenants >= 2, f"--fleet: no room for two tenants: {reckoning}")
    modes = {
        "paged": ["--continuous", "--paged", "--block-size", str(CLI_BLOCK)],
        "speculative": ["--continuous", "--speculative", "3", "--trace-out",
                        str(jsonl), "--metrics-out", str(prom)],
        "faults": ["--continuous", "--inject", "nan@3:1,slow@4",
                   "--deadline", "40", "--priority", "1"],
        "fleet": ["--fleet", str(tenants)]}
    res: dict = {"fleet_reckoning": reckoning}
    for mode, flags in modes.items():
        _empty_cache(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        print(f"serve CLI {mode}: {' '.join(flags)}", flush=True)
        out, wall, launched = _run_cli(serve, base + flags)
        first = next(ln for ln in out.splitlines()
                     if ln.startswith(("continuous:", "fleet:")))
        m = re.search(r"in ([0-9.]+) s \(([0-9.]+) tok/s", first)
        equal = re.search(r"(\d+) of (\d+) streams equal", out)
        res[mode] = {"wall_s": wall, "engine_s": float(m.group(1)),
                     "tokens_per_s": float(m.group(2)),
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated(dev),
                     "launches": launched,
                     "streams_equal": (None if equal is None else
                                       [int(equal.group(1)),
                                        int(equal.group(2))])}
        # One precompute a tenant the requests reach (its cache miss).
        misses = (int(re.search(r"/ (\d+) misses", out).group(1))
                  if mode == "fleet" else 1)
        res[mode]["cache_misses"] = misses
        check(launched["norm_terms"] == launched["assembled"]
              == misses * n_adapted,
              f"serve CLI {mode}: K1 launches {launched}")
        check((launched["paged_gather"] > 0) == (mode == "paged"),
              f"serve CLI {mode}: K8 launches {launched}")
        check(all(launched[k] == 0 for k in (
                  "assemble_norm", "compose_fwd_dual", "compose_bwd",
                  "compose_mm_bwd", "selective_scan", "selective_scan_bwd")),
              f"serve CLI {mode}: launches {launched}")
        if mode == "paged":
            check("(pool drained)" in out and "'prefill_into_slot': 0" in out
                  and equal is not None, f"serve CLI paged: {out}")
        elif mode == "speculative":
            events = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
            metrics = parse_prometheus(prom.read_text())
            res[mode].update(
                events=len(events),
                dropped=int(re.search(r"\((\d+) dropped\)", out).group(1)),
                metrics=len(metrics),
                generated_tokens=metrics[
                    "repro_engine_generated_tokens_total"],
                accepted_drafts=metrics["repro_engine_accepted_drafts_total"])
            check(res[mode]["events"] > 0 and res[mode]["dropped"] == 0
                  and res[mode]["generated_tokens"]
                  == 2 * CLI_BATCH * CLI_GEN and equal is not None,
                  f"serve CLI speculative: {res[mode]}")
        elif mode == "faults":
            line = next(ln for ln in out.splitlines()
                        if "finish reasons" in ln)
            res[mode]["finish_reasons"] = line.split("finish reasons ")[1]
            counters = dict(re.findall(r"(\w+)=(\d+)", next(
                ln for ln in out.splitlines() if "counters:" in ln)))
            res[mode]["counters"] = {k: int(v) for k, v in counters.items()}
            check(res[mode]["counters"]["quarantined"] >= 1
                  and res[mode]["counters"]["slow_ticks"] == 1,
                  f"serve CLI faults: {out}")
        else:
            check("one dynamic decode signature" in out and equal is not None,
                  f"serve CLI fleet: {out}")
        print(f"serve CLI {mode}: " + json.dumps(
            {k: v for k, v in res[mode].items() if k != "launches"}),
              flush=True)
    _empty_cache(dev)
    return res


# ---------------------------------------------------------------------------
# D1-D3: the train step across a (data, model) mesh, ranks sharing the card.
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, 2), (2, 1), (2, 2))
MESH_TIMEOUT_S = 420
MESH_LABEL = "ranks sharing one card, collectives staged by gloo"
# D3's bound on every adapter leaf's max |sharded - unsharded| / max
# |unsharded| gradient, the CPU tests' tolerance against the reference.
MESH_LEAF_REL_MAX = 1e-4
# D4: the fp32 route's logits and gathered g within 1e-5 of max of the
# unsharded port's (the CPU tests' tolerance against the reference), and
# each greedy step's least top-1 - top-2 gap over max |logit| at least
# twice that, so that equal tokens are a check and not luck.
MESH_SERVE_TOL = 1e-5
MESH_GAP_MIN = 2 * MESH_SERVE_TOL
# D4's bf16 route: the unsharded bf16 prefill is itself about 1.4e-4 of
# cosine from the fp32 logits of the same weights, and a change of
# rounding alone (g scaled by 1 + 1e-7·N) moves it about 1e-4, so a
# sharded bf16 run cannot be held at 1 - 1e-4 of the unsharded one. It
# is held within MESH_BF16_FACTOR times the unsharded route's own
# distance from the fp32 logits, both from them and from that route.
MESH_BF16_FACTOR = 2.0
# D5: the continuous-batching engine across the same meshes, on D4's
# model: 4 slots of 1024 positions, 8 requests arriving one every 2 ticks
# with prompts of 64-768 tokens and 16 new tokens each (no EOS, so the
# schedule is the same whatever the tokens); paged: blocks of 16, chunks
# of 256 and a pool of 72 blocks (one slot's 64 and 8 more), small enough
# that a decoding row preempts another once. The fp32 checks run the
# first D5_FP32_REQUESTS requests for D5_FP32_NEW tokens.
D5_SLOTS, D5_MAX_LEN, D5_BLOCK, D5_CHUNK, D5_BLOCKS = 4, 1024, 16, 256, 72
D5_REQUESTS, D5_EVERY, D5_PROMPT, D5_NEW = 8, 2, (64, 768), 16
D5_FP32_REQUESTS, D5_FP32_NEW = 4, 8
# D6: static tenant groups on the same meshes and model, serve_mt's three
# tenants: the fp32 logits within D6_TOL of max |logit| of one card's
# grouped run (D4 measured 4.5e-6 and D5 3.3e-6 against one card).
D6_TOL = 5e-6
# D7: dynamic grouping and speculation on the same meshes and model; the
# dynamic engine's fetched logits within D7_FLEET_TOL of max |logit| of
# the static one's on the same mesh (tests/test_torch_fleet.py's bound
# inside the port). Its bf16 engines run on D7_BF16_SHAPES.
D7_FLEET_TOL = 2e-6
D7_BF16_SHAPES = ((1, 2), (2, 1), (2, 2))
# The dynamic bf16 engine's stack inserts on D5's trace with d6_owners:
# a position is recycled when its tenant's last slot retires, so the
# three tenants are seated 7 times over the 9 admissions (one after the
# preemption); the host scheduler decides it, whatever the mesh.
D7_STACK_INSERTS = 7


class _DuckMesh:
    """``axis_names`` and ``shape``: what the rules and plans read."""

    def __init__(self, data: int, model: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


def mesh_counts(mcfg, dcfg, shape, *, batch: int, seq: int) -> dict:
    """Launches a rank makes in one train step on a (data, model) mesh,
    from the port's dispatch plans at the shapes ``models/layers.py``
    gives each module: column-parallel modules (local d_out, all rows)
    take K1 with its epilogue; row-parallel ones K1's terms and the
    standalone K2 where ``model`` splits their d_in, else K1 with its
    epilogue; a matmul-fused compose K6 twice (the layer and its
    recompute) and K7 once."""
    from repro_torch.core import dispatch
    from repro_torch.core.sharding import COLUMN_PARALLEL, P, plan_for_output

    data, tp = shape
    mesh = _DuckMesh(data, tp)
    rows = batch // data * seq
    col = plan_for_output(mesh, P(None, None, "model"), psum_dh=False)
    row = plan_for_output(mesh, P(None, "model", None))
    D, qd, kvd, ff = mcfg.d_model, mcfg.q_dim, mcfg.kv_dim, mcfg.d_ff
    dims = {"wq": qd, "wk": kvd, "wv": kvd, "w_gate": ff, "w_up": ff,
            "wo": D, "w_down": D}
    c = counts_of()
    for name, d_out in dims.items():
        is_col = name in COLUMN_PARALLEL
        local = d_out // tp if is_col else d_out
        if dispatch.plan_norm(dcfg, d_out=local).fused:
            c["norm_terms"] += 1
            if is_col or tp == 1:
                c["assembled"] += 1
            else:
                c["assemble_norm"] += 1
        plan = dispatch.plan_compose(dcfg, training=True, rows=rows,
                                     d_out=d_out, rank=dcfg.rank,
                                     sharding=col if is_col else row)
        if plan.matmul_fused:
            c["compose_mm_fwd"] += 2
            c["compose_mm_bwd"] += 1
        elif plan.fused:
            c["compose_fwd_dual"] += 2
            c["compose_bwd"] += 1
    return {k: v * mcfg.num_layers for k, v in c.items()}


def _mesh_step_counts(mcfg, dcfg, tp: int, runs) -> dict:
    """Launches a rank makes on a (data, model) mesh from the port's
    dispatch plans at the shapes ``models/layers.py`` gives each module:
    the mesh precompute takes K1 with its epilogue on the
    column-parallel modules' local rows and K1's terms and the standalone
    K2 on wo and w_down (with its epilogue where ``model`` has one rank);
    ``runs`` = (layout, rows, steps) of the steps that follow, whose
    compose runs under that layout's plans, K6 where matmul-fused, K3
    where element-wise."""
    from repro_torch.core import dispatch
    from repro_torch.core.sharding import COLUMN_PARALLEL

    D, qd, kvd, ff = mcfg.d_model, mcfg.q_dim, mcfg.kv_dim, mcfg.d_ff
    dims = {"wq": qd, "wk": kvd, "wv": kvd, "w_gate": ff, "w_up": ff,
            "wo": D, "w_down": D}
    c = counts_of()
    for name, d_out in dims.items():
        is_col = name in COLUMN_PARALLEL
        if dispatch.plan_norm(dcfg, d_out=d_out // tp if is_col
                              else d_out).fused:
            c["norm_terms"] += 1
            c["assembled" if is_col or tp == 1 else "assemble_norm"] += 1
        for lay, m, times in runs:
            plan = dispatch.plan_compose(
                dcfg, training=False, rows=m, d_out=d_out, rank=dcfg.rank,
                sharding=lay.col_plan if is_col else lay.row_plan)
            c["compose_mm_fwd"] += times * plan.matmul_fused
            c["compose_fwd"] += times * (plan.fused and not plan.matmul_fused)
    return {k: v * mcfg.num_layers for k, v in c.items()}


def mesh_serve_counts(mcfg, dcfg, shape, *, batch: int, seq: int,
                      decode_steps: int) -> dict:
    """Launches a rank makes in one ``generate(mesh=)`` on a (data, model)
    mesh (:func:`_mesh_step_counts`): the mesh precompute, the padded
    prefill under the sequence-parallel plans and each decode step under
    the decode plans (``make_boundary_constraint(decode=True)``)."""
    from repro_torch.launch.sharding import make_boundary_constraint

    data, tp = shape
    mesh = _DuckMesh(data, tp)
    rows = batch // data
    sp = make_boundary_constraint(mesh, batch=batch, seq=seq)
    dec = make_boundary_constraint(mesh, batch=batch, seq=1, decode=True)
    return _mesh_step_counts(mcfg, dcfg, tp, ((sp, rows * seq, 1),
                                              (dec, rows, decode_steps)))


def mesh_decode_bytes(mcfg, dcfg, shape, *, batch: int,
                      logits_tag: str = "generate.logits", window: int = 1,
                      adapted: bool = True,
                      vocab_tag: str = "decode.logits") -> dict:
    """Bytes a rank's collectives move in one decode step, by tag (one
    all-reduce of the tensor's bytes each): per layer y_base [B/data,
    d_model] and h [B/data, r] of wo and w_down all-reduced in fp32, the
    vocab-parallel embedding's rows, the head's local vocab columns
    gathered over ``model`` (``vocab_tag``) and the last logits over
    ``data`` (these in the model dtype, under ``logits_tag``:
    ``generate``'s gather, or the engine's decode step's,
    "engine.logits"); none over an axis of one rank. ``window``: each row
    runs that many positions (the speculative verify's k + 1), every
    tensor that many times as wide; ``adapted`` False: no adapter (the
    draft), so no h."""
    data, tp = shape
    rows, esz = batch // data, torch.tensor([], dtype=mcfg.dtype
                                            ).element_size()
    out = {}
    if tp > 1:
        n = 2 * mcfg.num_layers
        out["tp.y_base"] = n * rows * window * mcfg.d_model * 4
        if adapted:
            out["tp.h"] = n * rows * window * dcfg.rank * 4
        out["tp.embed"] = rows * window * mcfg.d_model * esz
        out[vocab_tag] = rows * window * mcfg.vocab_size * esz
    if data > 1:
        out[logits_tag] = batch * window * mcfg.vocab_size * esz
    return out


def mesh_verify_bytes(mcfg, dcfg, shape, *, batch: int,
                      window: int) -> dict:
    """Bytes a rank's collectives move in one speculative verify step of
    the engine, by tag: the decode step's over ``window`` = k + 1
    positions a row, its gathers tagged "verify.logits" (the vocab) and
    "engine.verify.logits" (the data axes)."""
    return mesh_decode_bytes(mcfg, dcfg, shape, batch=batch, window=window,
                             vocab_tag="verify.logits",
                             logits_tag="engine.verify.logits")


def mesh_draft_bytes(mcfg, dcfg, shape, *, batch: int) -> dict:
    """Bytes a rank's collectives move in one draft step of the engine, by
    tag: the decode step's less ``tp.h`` (the base model has no adapter),
    its gathers tagged "draft.logits" and "engine.draft.logits"."""
    return mesh_decode_bytes(mcfg, dcfg, shape, batch=batch, adapted=False,
                             vocab_tag="draft.logits",
                             logits_tag="engine.draft.logits")


def mesh_norm_bytes(mcfg, dcfg, tp: int) -> int:
    """Bytes a rank's norm sums move per step: base_sq and cross [d_model]
    and G [r, r], fp32, for each row-parallel module (none on one model
    rank)."""
    if tp == 1:
        return 0
    return 2 * mcfg.num_layers * (2 * mcfg.d_model * 4
                                  + dcfg.rank * dcfg.rank * 4)


def mesh_kernel_checks(dev, rows) -> dict:
    """D1: K1's terms (no epilogue) and the standalone K2 on wo's and
    w_down's d_in shards at model = 2, K1 with its epilogue on the
    column-parallel modules' local rows at model = 2 (the mesh
    precompute's), K6 and K7 at the column-parallel local shapes
    [4096, 9472] and [4096, 1792], K8 at D5's local views [4, 1024, 2,
    128], [2, 1024, 4, 128] and [2, 1024, 2, 128] (bitwise, timed beside
    ``index_select``); each against its plain version within the
    tolerance it holds today, the same bits twice."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dora_compose as kc
    from repro_torch.kernels import factored_norm as kn
    from repro_torch.kernels import norm_assembly as ka

    mcfg = get_config(ARCH)
    D, ff, qd = mcfg.d_model, mcfg.d_ff, mcfg.q_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf, esz = torch.bfloat16, 2
    s = ALPHA / math.sqrt(RANK)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    out = {}
    for name, d_in in (("wo", qd // 2), ("w_down", ff // 2)):
        W = randn(D, d_in, scale=(2 * d_in) ** -0.5)
        A = randn(RANK, d_in, scale=(2 * d_in) ** -0.5)
        B = randn(D, RANK, scale=0.02)
        base, cross = kn.norm_terms(W, A, B)
        pb, pc = kn.norm_terms_plain(W, A, B)
        e1, m1 = max_err(base, pb)
        e2, m2 = max_err(cross, pc)
        same = all(torch.equal(x, y) for x, y in zip(
            (base, cross), kn.norm_terms(W, A, B)))
        nbytes = (D * d_in + RANK * d_in + D * RANK) * esz + 2 * D * 4
        ops_s = (2 * D * d_in * RANK) / PEAK_OPS[bf] \
            + (2 * D * d_in + 2 * D * RANK) / F32_OPS
        record_row(rows, "norm_terms", [D, d_in, RANK], max(e1, e2),
                   max(m1, m2), 1e-4, time_ms(lambda: kn.norm_terms(W, A, B)),
                   time_ms(lambda: kn.norm_terms_plain(W, A, B)), nbytes,
                   ops_s, time_ms(lambda: W @ A.T), "W @ A.T",
                   mesh_shard=f"{name} d_in shard at model=2",
                   deterministic=bool(same))
        check(same, f"norm_terms {name} shard: not the same bits twice")
        A32, B32 = A.float(), B.float()
        ba = ((B32 @ (A32 @ A32.T)) * B32).sum(dim=1)
        w = ka.assemble_norm(base, cross, ba, s)
        ref = ka.assemble_norm_plain(base, cross, ba, s)
        e, mx = max_err(w, ref)
        same2 = torch.equal(w, ka.assemble_norm(base, cross, ba, s))
        record_row(rows, "assemble_norm", [D], e, mx, 1e-6,
                   time_ms(lambda: ka.assemble_norm(base, cross, ba, s)),
                   time_ms(lambda: ka.assemble_norm_plain(base, cross, ba,
                                                          s)),
                   4 * D * 4, 5 * D / F32_OPS,
                   mesh_shard=f"{name} at model=2 (standalone)",
                   bitwise=bool(torch.equal(w, ref)),
                   deterministic=bool(same2))
        check(same2, f"assemble_norm {name}: not the same bits twice")
        out[name] = {"k1_err": max(e1, e2), "k2_err": e}
    for name, d_out in (("wq", qd // 2), ("wk", mcfg.kv_dim // 2),
                        ("w_gate", ff // 2)):
        W = randn(d_out, D, scale=D ** -0.5)
        A = randn(RANK, D, scale=D ** -0.5)
        B = randn(d_out, RANK, scale=0.02)
        ep = check_epilogue(W, A, B, s, f"{name} local rows [{d_out}, {D}]")
        A32 = A.float()
        BG = B.float() @ (A32 @ A32.T)
        asm = kn.Assembly(BG, s)
        w = kn.norm_terms(W, A, B, asm)
        ref = ka.assemble_norm_plain(*kn.norm_terms_plain(W, A, B),
                                     (BG * B.float()).sum(dim=1), s)
        e, mx = max_err(w, ref)
        nbytes = (d_out * D + RANK * D + d_out * RANK) * esz \
            + d_out * RANK * 4 + d_out * 4
        ops_s = (2 * d_out * D * RANK) / PEAK_OPS[bf] \
            + (2 * d_out * D + 4 * d_out * RANK) / F32_OPS
        record_row(rows, "norm_terms", [d_out, D, RANK], e, mx, 1e-6,
                   time_ms(lambda: kn.norm_terms(W, A, B, asm)),
                   time_ms(lambda: ka.assemble_norm_plain(
                       *kn.norm_terms_plain(W, A, B),
                       (BG * B.float()).sum(dim=1), s)),
                   nbytes, ops_s, time_ms(lambda: W @ A.T), "W @ A.T",
                   mesh_shard=f"{name} local rows at model=2 (with its "
                              f"epilogue)",
                   with_epilogue=True, epilogue=ep,
                   deterministic=ep["deterministic"])
        out[f"{name}_epilogue"] = {"w_norm_err": e}
    mm = kc.compose_mm_fwd
    # The row-parallel partial product in fp32 (core/sharding.py
    # partial_product) against the bf16 product, at w_down's shard.
    from repro_torch.core.sharding import partial_product
    xp = randn(BATCH * MAX_LEN, ff // 2)
    wp = randn(D, ff // 2, scale=(2 * ff) ** -0.5)
    yp = partial_product(xp, wp)
    e, mx = max_err(yp, xp.float() @ wp.float().T)
    out["partial_product"] = {
        "shape": [BATCH * MAX_LEN, ff // 2, D],
        "ms": time_ms(lambda: partial_product(xp, wp)),
        "bf16_product_ms": time_ms(lambda: xp @ wp.T),
        "fp32_product_ms": time_ms(lambda: xp.float() @ wp.float().T),
        "max_rel_to_fp32": e / mx}
    print("  partial_product (fp32 sums) at w_down's shard: "
          + json.dumps(out["partial_product"]), flush=True)
    check(yp.dtype == torch.float32 and e <= 1e-4 * mx,
          f"partial_product: {out['partial_product']}")
    del xp, wp, yp
    col = "column-parallel local tile at model=2"
    for m, n, where in ((TRAIN_BATCH * TRAIN_SEQ, ff // 2, col),
                        (TRAIN_BATCH * TRAIN_SEQ, qd // 2, col),
                        (BATCH * MAX_LEN // 2, D,
                         "row-parallel prefill rows at model=2")):
        base = randn(m, n)
        h = randn(m, RANK, scale=0.5)
        B = randn(n, RANK, scale=0.02)
        gm1 = randn(n, scale=0.05, dtype=torch.float32)
        gs = (gm1 + 1.0) * s
        mma0 = mm.mma_launches
        delta = kc.compose_mm_fwd(base, h, B, gm1, s)
        check(mm.mma_launches == mma0 + 1,
              f"compose_mm_fwd [{m}, {n}] did not take the tensor cores")
        e, mx = max_err(delta, kc.compose_mm_fwd_plain(base, h, B, gm1, s))
        same = torch.equal(delta, kc.compose_mm_fwd(base, h, B, gm1, s))
        record_row(rows, "compose_mm_fwd", [m, n, RANK], e, mx, 2.0 ** -7,
                   time_ms(lambda: kc.compose_mm_fwd(base, h, B, gm1, s)),
                   time_ms(lambda: kc.compose_mm_fwd_plain(base, h, B, gm1,
                                                           s)),
                   2 * m * n * esz + (m + n) * RANK * esz + n * 4,
                   2 * m * n * RANK / PEAK_OPS[bf] + 5 * m * n / F32_OPS,
                   time_ms(lambda: h @ B.T), "h @ B.T",
                   mesh_shard=where, deterministic=bool(same))
        check(same, f"compose_mm_fwd [{m}, {n}]: not the same bits twice")
        dy = randn(m, n)
        d_base, d_h = kc.compose_mm_bwd(dy, B, gm1, gs)
        ref_b, ref_h = kc.compose_mm_bwd_plain(dy, B, gm1, gs)
        e2, m2 = max_err(d_h, ref_h)
        same = torch.equal(d_h, kc.compose_mm_bwd(dy, B, gm1, gs)[1])
        check(torch.equal(d_base, ref_b) and same,
              f"compose_mm_bwd [{m}, {n}]: d_base bitwise "
              f"{torch.equal(d_base, ref_b)}, same bits twice {same}")
        dys = (dy.float() * gs).to(dy.dtype)
        record_row(rows, "compose_mm_bwd", [m, n, RANK], e2, m2, 1e-4,
                   time_ms(lambda: kc.compose_mm_bwd(dy, B, gm1, gs)),
                   time_ms(lambda: kc.compose_mm_bwd_plain(dy, B, gm1, gs)),
                   2 * m * n * esz + n * RANK * esz + m * RANK * 4
                   + 2 * n * 4,
                   2 * 2 * m * n * RANK / PEAK_OPS[bf] + 3 * m * n / F32_OPS,
                   time_ms(lambda: dys @ B), "(dY*gs) @ B, bf16 product only",
                   mesh_shard=where,
                   d_base_bitwise_equal_plain=True, deterministic=bool(same))
        out[f"mm_{n}"] = {"k6_err": e, "k7_err": e2}
    out.update(mesh_paged_gather_checks(dev, rows, mcfg))
    return out


def mesh_paged_gather_checks(dev, rows, mcfg) -> dict:
    """K8 at D5's local views: a rank's pool of its Hkv / tp heads
    gathered through its replica's slot rows of the table, bitwise the
    plain version and the same bits twice, timed beside
    ``index_select`` (medians of alternating windows; both host-paced)."""
    from repro_torch.kernels import paged_gather as kp

    hd, hkv, mb = mcfg.head_dim, mcfg.num_kv_heads, D5_MAX_LEN // D5_BLOCK
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    table_rng = np.random.default_rng(SEED + 12)
    esz = 2
    out = {}
    for b, heads, at in ((D5_SLOTS, hkv // 2, "(data 1, model 2)"),
                         (D5_SLOTS // 2, hkv, "(data 2, model 1)"),
                         (D5_SLOTS // 2, hkv // 2, "(data 2, model 2)")):
        pool = torch.randn((D5_BLOCKS, D5_BLOCK, heads, hd), generator=gen,
                           device=dev).to(torch.bfloat16)
        pages, n_valid = paged_table(b, table_rng, dev, mb=mb,
                                     n_blocks=D5_BLOCKS)
        got = kp.paged_gather(pool, pages)
        ref = kp.paged_gather_plain(pool, pages)
        bitwise = torch.equal(got.view(torch.int16), ref.view(torch.int16))
        same = torch.equal(got.view(torch.int16),
                           kp.paged_gather(pool, pages).view(torch.int16))
        check(bitwise and same, f"paged_gather at D5's view {at}: bitwise "
              f"{bitwise}, the same bits twice {same}")
        e, mx = max_err(got, ref)
        ids = pages.clamp_min(0).long().reshape(-1)
        ms_k8, ms_lib = alternating_ms(
            lambda: kp.paged_gather(pool, pages),
            lambda: pool.index_select(0, ids))
        record_row(rows, "paged_gather", [b, mb * D5_BLOCK, heads, hd], e,
                   mx, 0.0, float(np.median(ms_k8)),
                   time_ms(lambda: kp.paged_gather_plain(pool, pages)),
                   (b * mb + n_valid) * D5_BLOCK * heads * hd * esz
                   + b * mb * 4, 0.0, float(np.median(ms_lib)),
                   "pool.index_select(0, clamped ids), no zero fill",
                   mesh_shard=f"D5's local view at {at}",
                   bitwise_equal_plain=bitwise, deterministic=same,
                   valid_entries=n_valid, ms_windows=ms_k8,
                   library_ms_windows=ms_lib)
        out[f"k8_{b}x{heads}"] = {"bitwise": bitwise, "deterministic": same}
        del pool, got, ref
    return out


def _mesh_state(mcfg, dcfg, mesh, dev, seed: int):
    """(params, adapters, adapter specs): the seeded full model and
    perturbed adapters drawn on the card, and with a mesh this rank's
    shards of them (the full trees freed)."""
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(gen, mcfg)
    adapters = perturb_adapters(lm.init_adapters(gen, mcfg, params, dcfg),
                                gen)
    if mesh is None:
        return params, adapters, None
    aspec = S.adapter_sharding(mcfg, dcfg, mesh)
    local = (S.shard_tree(params, S.param_sharding(mcfg, mesh), mesh),
             S.shard_tree(adapters, aspec, mesh))
    del params, adapters
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return (*local, aspec)


def _mesh_rank(rank: int, world: int, shape, store: str, out_dir: str,
               run: dict):
    """One rank of a D2-D4 run: its process group (gloo, file store), the
    mesh on ``run["device"]``, ``run["steps"]`` bf16 train steps of
    ``run["mcfg"]`` with their launch counts, collective bytes, ms and
    peak; then the fp32 route's loss and gathered gradients, held by rank
    0 against the unsharded port; then D4's serving (:func:`_mesh_serve`)."""
    import dataclasses
    import torch.distributed as dist

    dev = torch.device(run["device"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        from repro_torch import kernels
        from repro_torch.core import sharding as csh
        from repro_torch.core.config import DoRAConfig
        from repro_torch.launch import sharding as S
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.steps import (StepConfig, make_grad_step,
                                              make_train_step)
        from repro_torch.models import lm
        from repro_torch.optim import adamw_init
        from repro_torch.tree import flatten_paths

        mesh = make_debug_mesh(*shape, device=dev, backend="gloo")
        mcfg = run["mcfg"]
        dcfg = DoRAConfig(rank=run["rank"], alpha=run["alpha"],
                          mode=run["mode"])
        batch, seq = run["batch"], run["seq"]
        scfg = StepConfig(dora=dcfg, loss_tokens=run["loss_tokens"])
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        params, adapters, _ = _mesh_state(mcfg, dcfg, mesh, dev, SEED)
        bspec = S.batch_spec(mesh, batch=batch)
        batches = [S.shard_tree(
            {k: torch.as_tensor(v, device=dev) for k, v in b.items()},
            {"tokens": bspec, "labels": bspec}, mesh)
            for b in _train_batches(mcfg, run["steps"], batch, seq)]
        step = make_train_step(mcfg, scfg, mesh, batch=batch, seq=seq)
        opt = adamw_init(adapters)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        steps = []
        mm = kernels.KERNELS["compose_mm_fwd"]
        for b in batches:
            kernels.reset_launch_counts()
            csh.reset_collective_stats()
            mma0 = mm.mma_launches
            stats: dict = {}
            adapters, opt, met = step(params, adapters, opt, b, stats=stats)
            counts = launch_counts()
            steps.append({
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "ms": (stats["grad_s"] + stats["optim_s"]) * 1e3,
                "launches": counts,
                "k6_mma": mm.mma_launches - mma0,
                "collectives": csh.collective_stats()})
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        local_bytes = sum(t.numel() * t.element_size() for t in
                          list(flatten_paths(params).values())
                          + list(flatten_paths(adapters).values()))
        del params, adapters, opt, batches
        if on_card:
            torch.cuda.empty_cache()

        # D3: the fp32 route, sharded, gathered, against the unsharded
        # port on rank 0.
        m32 = dataclasses.replace(mcfg, dtype=torch.float32)
        p32, a32, aspec32 = _mesh_state(m32, dcfg, mesh, dev, SEED + 3)
        b0 = _train_batches(m32, 1, batch, seq)[0]
        full_b = {k: torch.as_tensor(v, device=dev) for k, v in b0.items()}
        loss_s, g_s = make_grad_step(m32, scfg, mesh, batch=batch,
                                     seq=seq)(
            p32, a32, S.shard_tree(full_b, {"tokens": bspec,
                                            "labels": bspec}, mesh))
        g_full = S.unshard_tree(g_s, aspec32, mesh)
        del p32, a32, g_s
        if on_card:
            torch.cuda.empty_cache()
        fp32 = None
        if rank == 0:
            p, a, _ = _mesh_state(m32, dcfg, None, dev, SEED + 3)
            loss_u, g_u = make_grad_step(m32, scfg, batch=batch,
                                         seq=seq)(p, a, full_b)
            gs, gu = flatten_paths(g_full), flatten_paths(g_u)
            va = torch.cat([gs[k].double().flatten() for k in sorted(gu)])
            vb = torch.cat([gu[k].double().flatten() for k in sorted(gu)])
            # Each leaf on its own: a fault in a leaf that is a small
            # share of the tree's norm (the m leaves, one module's B)
            # barely moves the whole tree's cosine.
            leaf_rel = {k: _leaf_max_rel(gs[k], gu[k]) for k in sorted(gu)}
            worst = max(leaf_rel, key=leaf_rel.get)
            fp32 = {"loss_sharded": float(loss_s),
                    "loss_unsharded": float(loss_u),
                    "loss_rel": abs(float(loss_s) / float(loss_u) - 1),
                    "grad_cosine": float(va @ vb / (va.norm() * vb.norm())),
                    "grad_max_rel": float((va - vb).abs().max()
                                          / vb.abs().max()),
                    "grad_leaf_max_rel": leaf_rel[worst],
                    "grad_leaf_worst": worst, "grad_leaves": len(leaf_rel)}
            del p, a, g_u, gs, gu, va, vb
        del g_full, full_b
        dist.barrier()
        # D4: single-tenant serving across the same mesh.
        serve = _mesh_serve(rank, mesh, run, dev)
        dist.barrier()
        rec = {"rank": rank, "coords": mesh.coords, "steps": steps,
               "peak_bytes": peak, "local_state_bytes": local_bytes,
               "fp32": fp32, "serve": serve}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def _mesh_serve(rank: int, mesh, run: dict, dev) -> dict:
    """D4 on one rank: ``generate(mesh=)`` of ``run["mcfg"]`` in bf16 on
    BATCH x PROMPT prompts padded to MAX_LEN plus GEN tokens (precompute
    on the mesh, sequence-parallel prefill, tensor-parallel decode) with
    its launch counts, K6's tensor-core launches, collective bytes by
    tag, phase times and peak; then the fp32 route: the mesh precompute's
    g gathered and the mesh generate's tokens and logits. Rank 0 holds
    both against the unsharded port on the whole trees (bf16: the prefill
    logits' cosine, each data replica's rows served as their own batch,
    and both routes' cosine to the fp32 logits of the same weights;
    fp32: g, every step's logits and top-2 gap, the tokens)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core import sharding as csh
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import StepConfig, make_precompute_step
    from repro_torch.tree import flatten_paths

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    mcfg = run["mcfg"]
    dcfg = DoRAConfig(rank=run["rank"], alpha=run["alpha"], mode=run["mode"])
    scfg = StepConfig(dora=dcfg)
    prompts = np.random.default_rng(SEED + 21).integers(
        0, mcfg.vocab_size, (run["serve_batch"], run["prompt"]))
    kw = dict(gen_len=run["gen"], max_len=run["max_len"])
    params, adapters, _ = _mesh_state(mcfg, dcfg, mesh, dev, SEED + 5)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mm = kernels.KERNELS["compose_mm_fwd"]
    kernels.reset_launch_counts()
    csh.reset_collective_stats()
    mma0 = mm.mma_launches
    stats: dict = {}
    toks, logits = SV.generate(mcfg, params, adapters, scfg, prompts,
                               mesh=mesh, stats=stats, return_logits=True,
                               **kw)
    counts = launch_counts()
    k6_mma = mm.mma_launches - mma0
    coll = csh.collective_stats()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    first = logits[0].float()
    del logits
    rec = {"launches": counts, "k6_mma": k6_mma, "collectives": coll,
           "precompute_ms": stats["precompute_s"] * 1e3,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_step": stats["decode_s"] * 1e3 / run["gen"],
           "peak_bytes": peak, "tokens_shape": list(toks.shape),
           "tokens_finite": bool(((toks >= 0)
                                  & (toks < mcfg.vocab_size)).all())}
    # D5: the continuous-batching engine on the same weights and mesh.
    rec["engine"] = _mesh_engine(rank, mesh, run, dev, params, adapters)
    del params, adapters
    if on_card:
        torch.cuda.empty_cache()
    # D6: static tenant groups on the same mesh.
    rec["tenants"] = _mesh_tenants(rank, mesh, run, dev)
    # D7: dynamic grouping and speculation on the same mesh.
    rec["d7"] = _mesh_fleet_spec(rank, mesh, run, dev)
    if rank == 0:
        # Each data replica serves its rows as one card serves that
        # batch (the compose route reads the rows of the call), so the
        # unsharded reference runs each replica's rows as its own batch.
        p, a, _ = _mesh_state(mcfg, dcfg, None, dev, SEED + 5)
        data = dict(mesh.shape)["data"]
        per = len(prompts) // data if len(prompts) % data == 0 else None
        parts = [prompts] if per is None else [
            prompts[i * per:(i + 1) * per] for i in range(data)]
        lu = torch.cat([SV.generate(mcfg, p, a, scfg, part, gen_len=1,
                                    max_len=run["max_len"], device=dev,
                                    return_logits=True)[1][0].float()
                        for part in parts])
        rec["bf16_prefill_cosine"] = cosine(first, lu)
        # The bf16 route's noise floor: the same unsharded prefill with
        # every g scaled by 1 + 1e-7·N(0, 1), a change of rounding alone.
        state = make_precompute_step(mcfg, scfg)(p, a)
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        for leaf in _adapter_leaves(state):
            leaf["g"] = leaf["g"] * (1.0 + 1e-7 * torch.randn(
                leaf["g"].shape, generator=gen, device=dev))
        lz = torch.cat([SV.generate(mcfg, p, state, scfg, part, gen_len=1,
                                    max_len=run["max_len"], device=dev,
                                    cache_adapters=False,
                                    return_logits=True)[1][0].float()
                        for part in parts])
        rec["bf16_noise_floor_cosine"] = cosine(lu, lz)
        del state, lz
        # Where the bf16 route itself stands: the unsharded port's fp32
        # logits on the same weights (recorded, not gated).
        m32 = dataclasses.replace(mcfg, dtype=torch.float32)
        up = _tree_map(lambda t: t.float(), p)
        ua = _tree_map(lambda t: t.float(), a)
        del p, a
        l32 = SV.generate(m32, up, ua, scfg, prompts, gen_len=1,
                          max_len=run["max_len"], device=dev,
                          return_logits=True)[1][0].float()
        rec["bf16_vs_fp32_cosine"] = {"mesh": cosine(first, l32),
                                      "unsharded": cosine(lu, l32)}
        del up, ua, lu, l32
    if on_card:
        torch.cuda.empty_cache()

    m32 = dataclasses.replace(mcfg, dtype=torch.float32)
    p32, a32, _ = _mesh_state(m32, dcfg, mesh, dev, SEED + 6)
    state = make_precompute_step(m32, scfg, mesh)(p32, a32)
    serving = flatten_paths(S.adapter_sharding(m32, dcfg, mesh,
                                               serving=True))
    g_mesh = {k: S.unshard_tree({"x": v}, {"x": serving[k]}, mesh)["x"]
              for k, v in flatten_paths(state).items()
              if k.endswith("/g")}
    t32, l32 = SV.generate(m32, p32, state, scfg, prompts, mesh=mesh,
                           cache_adapters=False, return_logits=True, **kw)
    del p32, a32, state
    if on_card:
        torch.cuda.empty_cache()
    if rank == 0:
        p, a, _ = _mesh_state(m32, dcfg, None, dev, SEED + 6)
        su = make_precompute_step(m32, scfg)(p, a)
        tu, lu = SV.generate(m32, p, su, scfg, prompts, device=dev,
                             cache_adapters=False, return_logits=True, **kw)
        gu = {k: v for k, v in flatten_paths(su).items() if k.endswith("/g")}
        g_rel = {k: _leaf_max_rel(g_mesh[k], gu[k]) for k in sorted(gu)}
        gaps = []
        for w in lu:
            top2 = w.float().topk(2, dim=-1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()
                              / w.abs().max()))
        rec["fp32"] = {
            "g_max_rel": max(g_rel.values()),
            "g_leaves": len(g_rel),
            "logit_max_rel": max(_leaf_max_rel(x, w)
                                 for x, w in zip(l32, lu)),
            "least_top2_gap": min(gaps),
            "tokens_equal": bool(torch.equal(t32, tu)),
            "generated": int(t32.shape[1] - run["prompt"])}
        del p, a, su, lu
    if on_card:
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def d5_trace(n: int = D5_REQUESTS, new: int = D5_NEW) -> list:
    """D5's arrivals (``drive_engine``'s form): request i at tick D5_EVERY
    x i with a prompt length drawn from a seed in D5_PROMPT and ``new``
    new tokens; the first ``n`` of them."""
    lo, hi = D5_PROMPT
    lens = np.random.default_rng(SEED + 31).integers(lo, hi + 1,
                                                     D5_REQUESTS)
    return [{"arrival_step": D5_EVERY * i, "prompt_len": int(lens[i]),
             "gen_len": new} for i in range(n)]


def d5_kwargs(paged: bool) -> dict:
    """D5's engine geometry, rectangular or paged."""
    kw = {"slots": D5_SLOTS, "max_len": D5_MAX_LEN}
    if paged:
        kw.update(paged=True, block_size=D5_BLOCK, n_blocks=D5_BLOCKS,
                  prefill_chunk=D5_CHUNK)
    return kw


def mesh_engine_counts(mcfg, dcfg, shape, steps: dict, *,
                       paged: bool) -> dict:
    """Launches a rank makes in one D5 run (:func:`_mesh_step_counts`):
    the mesh precompute of the engine's state, each prefill-into-slot (a
    row padded to D5_MAX_LEN) and each chunk (D5_CHUNK rows) under the
    sequence-parallel plans of a batch of one, each decode step over this
    replica's slot rows under the decode plans, and on the paged engine
    K8 twice a layer in every chunk and decode step (``steps``: the
    engine's ``device_steps()``)."""
    from repro_torch.launch.sharding import make_boundary_constraint

    data, tp = shape
    mesh = _DuckMesh(data, tp)
    rows = D5_SLOTS // data if D5_SLOTS % data == 0 else D5_SLOTS
    runs = ((make_boundary_constraint(mesh, batch=1, seq=D5_MAX_LEN),
             D5_MAX_LEN, steps["prefill_into_slot"]),
            (make_boundary_constraint(mesh, batch=1, seq=D5_CHUNK),
             D5_CHUNK, steps["prefill_chunk"]),
            (make_boundary_constraint(mesh, batch=D5_SLOTS, seq=1,
                                      decode=True), rows, steps["decode"]))
    c = _mesh_step_counts(mcfg, dcfg, tp, runs)
    c["paged_gather"] = paged * 2 * mcfg.num_layers * (
        steps["decode"] + steps["prefill_chunk"])
    return c


def _mesh_engine(rank: int, mesh, run: dict, dev, params, adapters) -> dict:
    """D5 on one rank: ``DecodeEngine(mesh=)`` of ``run["mcfg"]`` in bf16
    on :func:`d5_trace`, rectangular and paged, each from its own mesh
    precompute (g cached, B unfolded, as ``generate`` serves: the
    compose takes K6 where the plans say), with its launch counts, K6's tensor-core
    launches, collective bytes by tag, stats, device steps, pool, streams,
    ms a tick and a step, and peak; on rank 0 the unsharded engine's
    schedule on the same trace; on (2, 2) ``EngineServer(mesh=)`` on the
    same requests against the paged engine given them at once; then the
    fp32 route on the first D5_FP32_REQUESTS requests: paged == rect
    streams, and on (2, 2) rank 0 holds both engines' fetched logits and
    streams against the unsharded port's."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core import sharding as csh
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    t0 = time.perf_counter()
    mcfg, vocab = run["mcfg"], run["mcfg"].vocab_size
    dcfg = DoRAConfig(rank=run["rank"], alpha=run["alpha"], mode=run["mode"])
    scfg = StepConfig(dora=dcfg)
    square = dict(mesh.shape) == {"data": 2, "model": 2}
    trace = d5_trace()
    mm = kernels.KERNELS["compose_mm_fwd"]
    out = {}
    for name in ("rect", "paged"):
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        csh.reset_collective_stats()
        mma0 = mm.mma_launches
        state = make_precompute_step(mcfg, scfg, mesh)(
            params, adapters)
        engine = DecodeEngine(mcfg, scfg, params, adapters=state, mesh=mesh,
                              **d5_kwargs(name == "paged"))
        r = drive_engine(engine, trace, vocab, timed=True)
        st = engine.stats()
        out[name] = {
            "launches": launch_counts(), "k6_mma": mm.mma_launches - mma0,
            "collectives": csh.collective_stats(), "stats": st.as_dict(),
            "device_steps": engine.device_steps(),
            "pool": engine.pool_stats() if name == "paged" else None,
            "streams": {str(k): v for k, v in r["streams"].items()},
            "ms_per_tick": r["wall_s"] * 1e3 / st.steps,
            "decode_ms": _mean(r["times_ms"]["decode"]),
            "chunk_ms": _mean(r["times_ms"]["prefill_chunk"]),
            "prefill_into_slot_ms": _mean(
                r["times_ms"]["prefill_into_slot"]),
            "fetch_ms": _mean(r["times_ms"]["fetch"]),
            "wall_s": r["wall_s"], "peak_bytes": _peak(dev)}
        del engine, state
        _empty_cache(dev)
    if rank == 0:
        p, a, _ = _mesh_state(mcfg, dcfg, None, dev, SEED + 5)
        state = make_precompute_step(mcfg, scfg)(p, a)
        for name in ("rect", "paged"):
            engine = DecodeEngine(mcfg, scfg, p, adapters=state, device=dev,
                                  **d5_kwargs(name == "paged"))
            drive_engine(engine, trace, vocab)
            out[name]["one_card"] = {
                "stats": engine.stats().as_dict(),
                "device_steps": engine.device_steps(),
                "pool": engine.pool_stats() if name == "paged" else None}
            del engine
        del p, a, state
        _empty_cache(dev)
    if square:
        # The server submits every request at once: the paged engine is
        # given them the same way.
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, vocab, q["prompt_len"]) for q in trace]
        cache = AdapterStateCache.for_serving(mcfg, scfg, mesh,
                                              fold_gsb=False)
        cache.register("t0", adapters)
        server = SV.EngineServer(mcfg, scfg, params, cache=cache, mesh=mesh,
                                 **d5_kwargs(True))
        ts = time.perf_counter()
        res = server.run([SV.Request(q, "t0") for q in prompts],
                         gen_len=D5_NEW)
        wall = time.perf_counter() - ts
        state = make_precompute_step(mcfg, scfg, mesh)(
            params, adapters)
        engine = DecodeEngine(mcfg, scfg, params, adapters=state, mesh=mesh,
                              **d5_kwargs(True))
        for i, q in enumerate(prompts):
            engine.submit(q, max_new_tokens=D5_NEW, key_id=i)
        alone = engine.run()
        out["server"] = {
            "requests": len(res), "wall_s": wall,
            "ticks": server.engine.stats().steps,
            "reasons": sorted({x.finish_reason for x in res}),
            "streams_equal_engine": [x.tokens.tolist() for x in res]
            == [x.tokens.tolist() for x in alone]}
        del server, cache, engine, state
        _empty_cache(dev)

    m32 = dataclasses.replace(mcfg, dtype=torch.float32)
    short = d5_trace(D5_FP32_REQUESTS, D5_FP32_NEW)
    p32, a32, _ = _mesh_state(m32, dcfg, mesh, dev, SEED + 6)
    state = make_precompute_step(m32, scfg, mesh)(p32, a32)
    got = {}
    for name in ("rect", "paged"):
        engine = DecodeEngine(m32, scfg, p32, adapters=state, mesh=mesh,
                              **d5_kwargs(name == "paged"))
        seen = capture_logits(engine)
        got[name] = (drive_engine(engine, short, vocab)["streams"], seen)
        del engine
    del p32, a32, state
    _empty_cache(dev)
    out["fp32_paged_equals_rect"] = got["paged"][0] == got["rect"][0]
    if rank == 0 and square:
        p, a, _ = _mesh_state(m32, dcfg, None, dev, SEED + 6)
        state = make_precompute_step(m32, scfg)(p, a)
        fp32 = {}
        for name in ("rect", "paged"):
            engine = DecodeEngine(m32, scfg, p, adapters=state, device=dev,
                                  **d5_kwargs(name == "paged"))
            seen = capture_logits(engine)
            streams = drive_engine(engine, short, vocab)["streams"]
            del engine
            gaps = [float(np.diff(np.sort(w)[-2:])[0] / np.abs(w).max())
                    for w in seen.values()]
            fp32[name] = {"rows": len(seen),
                          "logit_max_rel": max_rel_logits(got[name][1], seen),
                          "least_top2_gap": min(gaps),
                          "tokens_equal": got[name][0] == streams}
        out["fp32"] = fp32
        del p, a, state
        _empty_cache(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def _mesh_tenant_state(mcfg, dcfg, mesh, dev, seed: int):
    """(params, tenants): the seeded full model and serve_mt's MT_TENANTS
    perturbed tenants (:func:`_tenant_adapters`), and with a mesh this
    rank's shards of them (the full trees freed)."""
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(gen, mcfg)
    tenants = [_tenant_adapters(mcfg, params, dcfg, t, dev)
               for t in range(MT_TENANTS)]
    if mesh is None:
        return params, tenants
    aspec = S.adapter_sharding(mcfg, dcfg, mesh)
    local = (S.shard_tree(params, S.param_sharding(mcfg, mesh), mesh),
             [S.shard_tree(a, aspec, mesh) for a in tenants])
    del params, tenants
    _empty_cache(dev)
    return local


def _tenant_cache(mcfg, scfg, mesh, dev, tenants):
    """An AdapterStateCache.for_serving of this mesh (or of ``dev``) with
    the tenants registered as tenant-0, tenant-1, ..."""
    from repro_torch.core.adapter_cache import AdapterStateCache

    cache = AdapterStateCache.for_serving(
        mcfg, scfg, mesh, device=None if mesh is not None else dev)
    for t, ad in enumerate(tenants):
        cache.register(f"tenant-{t}", ad)
    return cache


def d6_requests(vocab: int, prompt: int) -> list:
    """D6's static batch: MT_TENANTS x MT_ROWS requests of ``prompt``
    tokens with interleaved owners (the server's sort permutes them);
    rows 0..MT_TENANTS-1 share one prompt under the MT_TENANTS tenants."""
    from repro_torch.launch import serve as SV

    n = MT_TENANTS * MT_ROWS
    prompts = np.random.default_rng(SEED + 7).integers(0, vocab, (n, prompt))
    prompts[1:MT_TENANTS] = prompts[0]
    return [SV.Request(p, f"tenant-{i % MT_TENANTS}")
            for i, p in enumerate(prompts)]


def d6_owners(n: int) -> list:
    """The adapter of each of D5's ``n`` requests in D6: spread over the
    tenants in turn, so the slots hold two or three handles at once."""
    return [f"tenant-{i % MT_TENANTS}" for i in range(n)]


def mesh_tenant_counts(mcfg, dcfg, shape, steps: dict | None = None, *,
                       paged: bool = False) -> dict:
    """Launches a rank makes in one cold D6 run: MT_TENANTS mesh
    precomputes (:func:`_mesh_step_counts` with no step after it; K1
    with its epilogue on the column-parallel modules, K1's terms and the
    standalone K2 on wo and w_down at model > 1) and no compose kernel:
    every grouped prefill and decode step, and a folded state's admission,
    composes with the plain fp32 h·gsBᵀ (``core/adapter.py gsb_delta``),
    so K6 = 0. On the paged engine K8 twice a layer in every chunk and
    decode step (``steps``: its ``device_steps()``)."""
    c = _mesh_step_counts(mcfg, dcfg, shape[1], ())
    c = {k: MT_TENANTS * v for k, v in c.items()}
    if paged:
        c["paged_gather"] = 2 * mcfg.num_layers * (
            steps["decode"] + steps["prefill_chunk"])
    return c


def _mesh_tenants(rank: int, mesh, run: dict, dev) -> dict:
    """D6 on one rank: static tenant groups across the mesh on
    ``run["mcfg"]`` with serve_mt's three tenants (this rank's shards).
    bf16: ``MultiTenantServer(mesh=)`` cold then warm on
    :func:`d6_requests` padded to MAX_LEN plus GEN tokens (launches,
    K6's tensor-core launches, collective bytes by tag, cache counters,
    phase times, peak, tokens); ``DecodeEngine(mesh=)`` rectangular and
    paged on D5's geometry and trace with the requests spread over the
    tenants (:func:`d6_owners`), each over a fresh cache (launches, bytes,
    stats, device steps, pool, decode signatures, streams, ms); on (2, 2)
    ``EngineServer(mesh=)`` against the paged engine given the same
    requests at once. fp32: the
    server on D5_FP32_NEW tokens and the engines on the first
    D5_FP32_REQUESTS requests (paged == rect); rank 0 holds the server's
    every step's logits, and on (2, 2) the engines' fetched logits,
    against the unsharded port's grouped run."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core import sharding as csh
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig

    t0 = time.perf_counter()
    mcfg, vocab = run["mcfg"], run["mcfg"].vocab_size
    dcfg = DoRAConfig(rank=run["rank"], alpha=run["alpha"], mode=run["mode"])
    scfg = StepConfig(dora=dcfg)
    square = dict(mesh.shape) == {"data": 2, "model": 2}
    requests = d6_requests(vocab, run["prompt"])
    kw = dict(gen_len=run["gen"], max_len=run["max_len"])
    mm = kernels.KERNELS["compose_mm_fwd"]
    params, tenants = _mesh_tenant_state(mcfg, dcfg, mesh, dev, SEED + 5)
    out: dict = {}

    cache = _tenant_cache(mcfg, scfg, mesh, dev, tenants)
    server = SV.MultiTenantServer(mcfg, scfg, params, cache=cache, mesh=mesh)
    toks = {}
    for name in ("cold", "warm"):
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        csh.reset_collective_stats()
        mma0 = mm.mma_launches
        stats: dict = {}
        toks[name] = server.serve(requests, stats=stats, **kw)
        out[name] = {
            "launches": launch_counts(), "k6_mma": mm.mma_launches - mma0,
            "collectives": csh.collective_stats(),
            "cache": cache.stats().as_dict(),
            "precompute_ms": stats["precompute_s"] * 1e3,
            "stack_ms": stats["stack_s"] * 1e3,
            "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_ms_per_step": stats["decode_s"] * 1e3 / run["gen"],
            "peak_bytes": _peak(dev)}
    out["tokens"] = toks["warm"].tolist()
    out["warm_equals_cold"] = bool(torch.equal(toks["cold"], toks["warm"]))
    out["groups"] = [list(g) for g in list(server._steps)[-1][3]]
    del server, cache, toks
    _empty_cache(dev)

    trace = d5_trace()
    owners = d6_owners(len(trace))
    for name in ("rect", "paged"):
        cache = _tenant_cache(mcfg, scfg, mesh, dev, tenants)
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        csh.reset_collective_stats()
        mma0 = mm.mma_launches
        engine = DecodeEngine(mcfg, scfg, params, adapter_cache=cache,
                              mesh=mesh, **d5_kwargs(name == "paged"))
        r = drive_engine(engine, trace, vocab, timed=True, adapters=owners)
        st = engine.stats()
        out[name] = {
            "launches": launch_counts(), "k6_mma": mm.mma_launches - mma0,
            "collectives": csh.collective_stats(), "stats": st.as_dict(),
            "device_steps": engine.device_steps(),
            "signatures": engine.step_signatures()["decode"],
            "cache": cache.stats().as_dict(),
            "pool": engine.pool_stats() if name == "paged" else None,
            "streams": {str(k): v for k, v in r["streams"].items()},
            "ms_per_tick": r["wall_s"] * 1e3 / st.steps,
            "decode_ms": _mean(r["times_ms"]["decode"]),
            "wall_s": r["wall_s"], "peak_bytes": _peak(dev)}
        del engine, cache
        _empty_cache(dev)
    if square:
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, vocab, q["prompt_len"]) for q in trace]
        server = SV.EngineServer(
            mcfg, scfg, params, mesh=mesh, **d5_kwargs(True),
            cache=_tenant_cache(mcfg, scfg, mesh, dev, tenants))
        ts = time.perf_counter()
        res = server.run([SV.Request(q, o) for q, o in zip(prompts, owners)],
                         gen_len=D5_NEW)
        wall = time.perf_counter() - ts
        engine = DecodeEngine(mcfg, scfg, params, mesh=mesh,
                              adapter_cache=_tenant_cache(
                                  mcfg, scfg, mesh, dev, tenants),
                              **d5_kwargs(True))
        for i, (q, o) in enumerate(zip(prompts, owners)):
            engine.submit(q, max_new_tokens=D5_NEW, key_id=i, adapter=o)
        alone = engine.run()
        out["server"] = {
            "requests": len(res), "wall_s": wall,
            "ticks": server.engine.stats().steps,
            "signatures": server.engine.step_signatures()["decode"],
            "reasons": sorted({x.finish_reason for x in res}),
            "streams_equal_engine": [x.tokens.tolist() for x in res]
            == [x.tokens.tolist() for x in alone]}
        del server, engine
        _empty_cache(dev)
    del params, tenants
    _empty_cache(dev)

    m32 = dataclasses.replace(mcfg, dtype=torch.float32)
    short = d5_trace(D5_FP32_REQUESTS, D5_FP32_NEW)
    kw32 = dict(gen_len=D5_FP32_NEW, max_len=run["max_len"])
    p32, t32 = _mesh_tenant_state(m32, dcfg, mesh, dev, SEED + 6)
    server = SV.MultiTenantServer(m32, scfg, p32, mesh=mesh,
                                  cache=_tenant_cache(m32, scfg, mesh, dev,
                                                      t32))
    s_toks, s_logits = server.serve(requests, return_logits=True, **kw32)
    got = {}
    for name in ("rect", "paged"):
        engine = DecodeEngine(m32, scfg, p32, mesh=mesh,
                              adapter_cache=_tenant_cache(m32, scfg, mesh,
                                                          dev, t32),
                              **d5_kwargs(name == "paged"))
        seen = capture_logits(engine)
        got[name] = (drive_engine(engine, short, vocab,
                                  adapters=owners)["streams"], seen)
        del engine
    del server, p32, t32
    _empty_cache(dev)
    out["fp32_paged_equals_rect"] = got["paged"][0] == got["rect"][0]
    if rank == 0:
        p, a = _mesh_tenant_state(m32, dcfg, None, dev, SEED + 6)
        one = SV.MultiTenantServer(m32, scfg, p, device=dev,
                                   cache=_tenant_cache(m32, scfg, None, dev,
                                                       a))
        u_toks, u_logits = one.serve(requests, return_logits=True, **kw32)
        gaps = []
        for w in u_logits:
            top2 = w.float().topk(2, dim=-1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()
                              / w.abs().max()))
        first = u_logits[0].double()
        out["fp32_server"] = {
            "logit_max_rel": max(_leaf_max_rel(x, w)
                                 for x, w in zip(s_logits, u_logits)),
            "least_top2_gap": min(gaps),
            "tokens_equal": bool(torch.equal(s_toks, u_toks)),
            "generated": int(s_toks.shape[1] - run["prompt"]),
            "tenant_first_logits_min_rel": min(
                _leaf_max_rel(first[a_], first[b_])
                for a_ in range(MT_TENANTS)
                for b_ in range(a_ + 1, MT_TENANTS))}
        del one, u_logits
        if square:
            fp32 = {}
            for name in ("rect", "paged"):
                engine = DecodeEngine(m32, scfg, p, device=dev,
                                      adapter_cache=_tenant_cache(
                                          m32, scfg, None, dev, a),
                                      **d5_kwargs(name == "paged"))
                seen = capture_logits(engine)
                streams = drive_engine(engine, short, vocab,
                                       adapters=owners)["streams"]
                del engine
                gaps = [float(np.diff(np.sort(w)[-2:])[0] / np.abs(w).max())
                        for w in seen.values()]
                fp32[name] = {"rows": len(seen),
                              "logit_max_rel": max_rel_logits(got[name][1],
                                                              seen),
                              "least_top2_gap": min(gaps),
                              "tokens_equal": got[name][0] == streams}
            out["fp32_engine"] = fp32
        del p, a
        _empty_cache(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def _record_step_bytes(engine) -> dict:
    """Wrap ``engine``'s decode, draft and verify steps so that each
    records its own collectives' bytes by tag (the counts reset before
    the step and read after it): {kind: [bytes by tag of each step]}."""
    from repro_torch.core import sharding as csh

    seen: dict = {"decode": [], "draft": [], "verify": []}

    def wrap(kind, fn):
        def step(*a, **k):
            csh.reset_collective_stats()
            out = fn(*a, **k)
            seen[kind].append({t: v["bytes"] for t, v in
                               csh.collective_stats().items()})
            return out
        return step
    engine._decode = wrap("decode", engine._decode)
    engine._draft = wrap("draft", engine._draft)
    engine._verify = wrap("verify", engine._verify)
    return seen


def _distinct(steps: list) -> dict:
    """A step-bytes list of :func:`_record_step_bytes` as its length and
    its distinct records."""
    keys = sorted({json.dumps(s, sort_keys=True) for s in steps})
    return {"n": len(steps), "distinct": [json.loads(k) for k in keys]}


def _capture_verify_logits(engine) -> list:
    """Every fetched verify logits array ([slots, k + 1, V]) in order."""
    seen: list = []
    fetch = engine._fetch

    def recorded(logits):
        out = fetch(logits)
        if out.ndim == 3:
            seen.append(np.asarray(out, np.float64))
        return out
    engine._fetch = recorded
    return seen


def _mesh_fleet_spec(rank: int, mesh, run: dict, dev) -> dict:
    """D7 on one rank: dynamic grouping and speculation across the mesh.

    bf16 (on D7_BF16_SHAPES): ``DecodeEngine(mesh=, dynamic_grouping=
    True)`` paged on D5's geometry and trace with D6's tenants and owners
    over a fresh cache (launches, each decode step's bytes by tag, stats,
    device steps, pool, signatures, streams, ms), and the speculative
    paged engine (k = 3) with D5's perturbed adapters on the committed
    speculative trace (launches, each draft, verify and decode step's
    bytes by tag, streams, accept rate, ms). fp32: the committed fleet
    trace over five tenants, dynamic rectangular and paged and static
    (counters, signatures, streams, the dynamic rows' distance from the
    static ones); the speculative trace with identity adapters (max |g -
    1|) and with the perturbed ones and the ladder, rectangular and
    paged, and the plain engine (counters, streams, K8 launches). On (2,
    2) rank 0 holds the fleet's dynamic logits and the verify's fetched
    logits against the unsharded port's engines, and the ranks run the
    servers: ``MultiTenantServer(mesh=, dynamic_grouping=True)`` on D6's
    requests through the engine route against the static grouping and
    with speculative_k=3, and ``EngineServer(mesh=)`` with speculative_k
    at construction and in ``run`` against the speculative paged engine
    given the same requests at once."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.core import sharding as csh
    from repro_torch.core.config import DoRAConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as S
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step
    from repro_torch.models import lm

    t0 = time.perf_counter()
    mcfg, vocab = run["mcfg"], run["mcfg"].vocab_size
    dcfg = DoRAConfig(rank=run["rank"], alpha=run["alpha"], mode=run["mode"])
    scfg = StepConfig(dora=dcfg)
    shape = (dict(mesh.shape)["data"], dict(mesh.shape)["model"])
    square = shape == (2, 2)
    mm = kernels.KERNELS["compose_mm_fwd"]
    spec_trace, spec_slots, spec_len, k, _ = speculative_trace()
    spec_kw = {"slots": spec_slots, "max_len": spec_len}
    spec_paged = {"paged": True, "prefill_chunk": spec_len}
    out: dict = {}

    if shape in D7_BF16_SHAPES:
        # (a) dynamic grouping in bf16: D6's tenants and owners on D5's
        # paged geometry and trace.
        params, tenants = _mesh_tenant_state(mcfg, dcfg, mesh, dev,
                                             SEED + 5)
        trace = d5_trace()
        cache = _tenant_cache(mcfg, scfg, mesh, dev, tenants)
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        mma0 = mm.mma_launches
        engine = DecodeEngine(mcfg, scfg, params, adapter_cache=cache,
                              mesh=mesh, dynamic_grouping=True,
                              **d5_kwargs(True))
        nbytes = _record_step_bytes(engine)
        r = drive_engine(engine, trace, vocab, timed=True,
                         adapters=d6_owners(len(trace)))
        st = engine.stats()
        out["dynamic_bf16"] = {
            "launches": launch_counts(), "k6_mma": mm.mma_launches - mma0,
            "step_bytes": {kind: _distinct(v) for kind, v in nbytes.items()},
            "stats": st.as_dict(), "device_steps": engine.device_steps(),
            "pool": engine.pool_stats(),
            "signatures": engine.step_signatures()["decode"],
            "cache": cache.stats().as_dict(),
            "streams": {str(q): v for q, v in r["streams"].items()},
            "ms_per_tick": r["wall_s"] * 1e3 / st.steps,
            "decode_ms": _mean(r["times_ms"]["decode"]),
            "wall_s": r["wall_s"], "peak_bytes": _peak(dev)}
        del engine, cache, tenants
        _empty_cache(dev)
        # (d) speculation in bf16: D5's perturbed adapters, paged.
        _, adapters, _ = _mesh_state(mcfg, dcfg, mesh, dev, SEED + 5)
        _sync(dev)
        _reset_peak(dev)
        kernels.reset_launch_counts()
        state = make_precompute_step(mcfg, scfg, mesh, fold_gsb=True)(
            params, adapters)
        engine = DecodeEngine(mcfg, scfg, params, adapters=state, mesh=mesh,
                              speculative_k=k, **spec_kw, **spec_paged)
        nbytes = _record_step_bytes(engine)
        r = drive_engine(engine, spec_trace, vocab, timed=True)
        st = engine.stats()
        out["spec_bf16"] = {
            "launches": launch_counts(),
            "step_bytes": {kind: _distinct(v) for kind, v in nbytes.items()},
            "stats": st.as_dict(), "device_steps": engine.device_steps(),
            "pool": engine.pool_stats(),
            "streams": {str(q): v for q, v in r["streams"].items()},
            "accept_rate": st.accepted_drafts / max(k * st.verify_steps, 1),
            "ms_per_tick": r["wall_s"] * 1e3 / st.steps,
            "draft_ms": _mean(r["times_ms"]["draft"]),
            "verify_ms": _mean(r["times_ms"]["verify"]),
            "decode_ms": _mean(r["times_ms"]["decode"]),
            "wall_s": r["wall_s"], "peak_bytes": _peak(dev)}
        del engine, state, adapters, params
        _empty_cache(dev)

    # fp32: the model, D5's perturbed adapters, their identity tree and
    # the fleet trace's tenants, each built whole and cut to this rank's
    # shards at once (rank 0 keeps the whole trees on (2, 2) for the
    # one-card engines).
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_serve.json").read_text())["fleet"]
    tp = dict(bench["trace"])
    f_kw = {"slots": tp.pop("slots"), "max_len": tp.pop("max_len")}
    f_trace = make_fleet_trace(**tp)
    m32 = dataclasses.replace(mcfg, dtype=torch.float32)
    one_card = rank == 0 and square
    aspec = S.adapter_sharding(m32, dcfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    full_p = lm.init_params(gen, m32)
    full_a = perturb_adapters(lm.init_adapters(gen, m32, full_p, dcfg), gen)
    full_i = _identity_tree(full_p, full_a, dcfg)
    a32, i32 = (S.shard_tree(t, aspec, mesh) for t in (full_a, full_i))
    del full_i
    full_t, t32 = [], []
    for t in range(tp["tenants"]):
        whole = _tenant_adapters(m32, full_p, dcfg, t, dev)
        t32.append(S.shard_tree(whole, aspec, mesh))
        if one_card:
            full_t.append(whole)
        del whole
    p32 = S.shard_tree(full_p, S.param_sharding(m32, mesh), mesh)
    if not one_card:
        del full_p, full_a
    _empty_cache(dev)

    # (b) the committed fleet trace over its five tenants.
    ids = [f"tenant-{q['tenant']}" for q in f_trace]
    fleet, f_logits = {}, {}
    for form, geo in (("dynamic", {}),
                      ("dynamic_paged", {"paged": True,
                                         "prefill_chunk": f_kw["max_len"]}),
                      ("static", {})):
        cache = _tenant_cache(m32, scfg, mesh, dev, t32)
        engine = DecodeEngine(m32, scfg, p32, adapter_cache=cache, mesh=mesh,
                              dynamic_grouping=form != "static", **f_kw,
                              **geo)
        f_logits[form] = capture_logits(engine)
        kernels.reset_launch_counts()
        r = drive_engine(engine, f_trace, vocab, adapters=ids)
        fleet[form] = {"stats": engine.stats().as_dict(),
                       "device_steps": engine.device_steps(),
                       "signatures": engine.step_signatures()["decode"],
                       "cache": cache.stats().as_dict(),
                       "paged_gather": launch_counts()["paged_gather"],
                       "streams": {str(q): v for q, v in
                                   r["streams"].items()}}
        del engine, cache
    fleet["dyn_vs_static"] = max_rel_logits(f_logits["dynamic"],
                                            f_logits["static"])
    _empty_cache(dev)

    # (c) the speculative trace: identity and perturbed adapters.
    precompute = make_precompute_step(m32, scfg, mesh, fold_gsb=True)
    spec: dict = {}
    verify_logits = None
    for name, tree in (("identity", i32), ("perturbed", a32)):
        state = precompute(p32, tree)
        if name == "identity":
            spec["g_dev"] = max(float((leaf["g"] - 1).abs().max())
                                for leaf in _adapter_leaves(state))
        extra = SPEC_LADDER if name == "perturbed" else {}
        runs = [("rect", {}, k), ("paged", spec_paged, k)]
        if name == "perturbed":
            runs.append(("plain", {}, 0))
        for geo_name, geo, kk in runs:
            engine = DecodeEngine(m32, scfg, p32, adapters=state, mesh=mesh,
                                  speculative_k=kk, **(extra if kk else {}),
                                  **spec_kw, **geo)
            if name == "perturbed" and geo_name == "rect":
                verify_logits = _capture_verify_logits(engine)
            kernels.reset_launch_counts()
            r = drive_engine(engine, spec_trace, vocab)
            spec[f"{name}_{geo_name}"] = {
                "stats": engine.stats().as_dict(),
                "device_steps": engine.device_steps(),
                "paged_gather": launch_counts()["paged_gather"],
                "pool": engine.pool_stats() if geo else None,
                "streams": {str(q): v for q, v in r["streams"].items()}}
            del engine
        del state
    _empty_cache(dev)

    if square:
        # (e) the servers, fp32: D6's six requests through the engine
        # route, dynamic against static grouping and speculating; the
        # speculative EngineServer against the speculative paged engine
        # given the same requests at once.
        requests = d6_requests(vocab, run["prompt"])
        kw32 = dict(gen_len=D5_FP32_NEW, max_len=run["max_len"],
                    static=False)
        toks = {}
        for form in ("dynamic", "static"):
            server = SV.MultiTenantServer(
                m32, scfg, p32, mesh=mesh, dynamic_grouping=form == "dynamic",
                cache=_tenant_cache(m32, scfg, mesh, dev,
                                    t32[:MT_TENANTS]))
            toks[form] = [t.tolist() for t in server.serve(requests, **kw32)]
            if form == "dynamic":
                toks["speculative"] = [t.tolist() for t in server.serve(
                    requests, speculative_k=k, **kw32)]
                sigs = next(iter(server._engines.values())).step_signatures()
            del server
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, vocab, q["prompt_len"])
                   for q in spec_trace]
        new = [q["gen_len"] for q in spec_trace]
        streams = {}
        for when in ("built", "run"):
            cache = _tenant_cache(m32, scfg, mesh, dev, [a32])
            server = SV.EngineServer(m32, scfg, p32, cache=cache, mesh=mesh,
                                     speculative_k=k if when == "built"
                                     else 0, **spec_kw, **spec_paged)
            res = server.run([SV.Request(q, "tenant-0") for q in prompts],
                             gen_len=max(new),
                             speculative_k=None if when == "built" else k)
            streams[when] = [x.tokens.tolist() for x in res]
            del server, cache
        state = precompute(p32, a32)
        engine = DecodeEngine(m32, scfg, p32, adapters=state, mesh=mesh,
                              speculative_k=k, **spec_kw, **spec_paged)
        for i, q in enumerate(prompts):
            engine.submit(q, max_new_tokens=max(new), key_id=i)
        alone = [x.tokens.tolist() for x in engine.run()]
        del engine, state
        out["servers"] = {
            "mt_dynamic_equals_static": toks["dynamic"] == toks["static"],
            "mt_speculative_equals_plain":
                toks["speculative"] == toks["dynamic"],
            "mt_signatures": sigs,
            "engine_server_built_equals_engine": streams["built"] == alone,
            "engine_server_run_equals_engine": streams["run"] == alone}
    if one_card:
        # The unsharded port's dynamic engine on the fleet trace and its
        # speculative engine (the perturbed adapters, the ladder) on the
        # speculative trace.
        engine = DecodeEngine(m32, scfg, full_p, adapter_cache=_tenant_cache(
                                  m32, scfg, None, dev, full_t),
                              dynamic_grouping=True, device=dev, **f_kw)
        seen = capture_logits(engine)
        r = drive_engine(engine, f_trace, vocab, adapters=ids)
        gaps = [float(np.diff(np.sort(w)[-2:])[0] / np.abs(w).max())
                for w in seen.values()]
        out["fleet_one_card"] = {
            "logit_max_rel": max_rel_logits(f_logits["dynamic"], seen),
            "least_top2_gap": min(gaps),
            "tokens_equal": {str(q): v for q, v in r["streams"].items()}
            == fleet["dynamic"]["streams"]}
        del engine
        state = make_precompute_step(m32, scfg, fold_gsb=True)(full_p,
                                                               full_a)
        engine = DecodeEngine(m32, scfg, full_p, adapters=state,
                              speculative_k=k, device=dev, **SPEC_LADDER,
                              **spec_kw)
        want = _capture_verify_logits(engine)
        r = drive_engine(engine, spec_trace, vocab)
        out["verify_one_card"] = {
            "verifies": len(want),
            "logit_max_rel": max(
                float(np.abs(g - w).max() / np.abs(w).max())
                for g, w in zip(verify_logits, want))
            if len(want) == len(verify_logits) else math.inf,
            "tokens_equal": {str(q): v for q, v in r["streams"].items()}
            == spec["perturbed_rect"]["streams"]}
        del engine, state, full_p, full_a, full_t
    del p32, a32, i32, t32
    _empty_cache(dev)
    out["fleet"] = fleet
    out["spec"] = spec
    out["seconds"] = time.perf_counter() - t0
    return out


def _leaf_max_rel(got, want) -> float:
    """max |got - want| / max |want| of one gradient leaf (0 where both
    are all zeros, inf where only ``want`` is)."""
    diff = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    if ref == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / ref


def _spawn_ranks(shape, out_dir: Path, run: dict) -> list:
    """Start the ranks of one mesh on the card (spawn), join them under
    MESH_TIMEOUT_S (a hung collective kills them all and fails), and
    return their records."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*"):
        f.unlink()
    store = out_dir / "store"
    ctx = mp.start_processes(_mesh_rank,
                             args=(world, shape, str(store), str(out_dir),
                                   run),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise RuntimeError(f"mesh {shape}: ranks did not finish in "
                                   f"{MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(world)]


def mesh_checks(dev, mcfg=None) -> dict:
    """D2-D4 on each mesh of MESH_SHAPES: qwen2-7b at full width on its
    first AGREE_LAYERS layers, r = 384, ranks on this card under gloo.
    Held per rank and step: the launch counts of ``mesh_counts`` exactly,
    every K6 on the tensor cores, the norm's collective bytes
    (``mesh_norm_bytes``), a finite loss the same on every rank; the fp32
    route's loss within 1e-5 relative and its gathered adapter gradient
    at cosine >= GRAD_COSINE_MIN of the unsharded port's, each leaf within
    MESH_LEAF_REL_MAX of its max. D4, per rank: ``generate(mesh=)``'s
    launches exactly ``mesh_serve_counts``, every K6 on the tensor cores,
    each decode step's collective bytes by tag exactly
    ``mesh_decode_bytes``, the whole token matrix on every rank; the bf16
    prefill logits within MESH_BF16_FACTOR times the unsharded bf16
    route's own distance from the fp32 logits; the fp32 route's gathered
    g and logits within MESH_SERVE_TOL of max, every
    step's top-2 gap at least MESH_GAP_MIN, and its tokens equal to the
    unsharded port's. D5, D6 and D7 run in the same ranks and are held
    by :func:`mesh_engine_record`, :func:`mesh_tenant_record` and
    :func:`mesh_fleet_record`."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.config import DoRAConfig

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    if mcfg is None:
        mcfg = dataclasses.replace(get_config(ARCH),
                                   num_layers=AGREE_LAYERS)
    # A forced kernel mode on CPU ranks runs the plain versions (a
    # rehearsal); auto on the card.
    mode = "auto" if torch.device(dev).type == "cuda" else "fused"
    dcfg = DoRAConfig(rank=RANK, alpha=ALPHA, mode=mode)
    run = {"device": str(dev), "mcfg": mcfg, "rank": RANK, "alpha": ALPHA,
           "mode": mode, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "loss_tokens": LOSS_TOKENS, "steps": TRAIN_STEPS,
           "serve_batch": BATCH, "prompt": PROMPT, "gen": GEN,
           "max_len": MAX_LEN}
    D = mcfg.d_model
    gathered = 2 * mcfg.num_layers * (D * mcfg.q_dim // 2
                                      + D * mcfg.d_ff // 2)
    print(f"mesh phases ({MESH_LABEL}): {mcfg.name} at full width, "
          f"{mcfg.num_layers} layers ({mcfg.count_params():,} parameters, "
          f"{mcfg.count_params() * 2:,} B in bf16), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, loss on the last {LOSS_TOKENS}",
          flush=True)
    out = {"label": MESH_LABEL}
    root = Path(__file__).resolve().parent / "build" / "mesh"
    for shape in MESH_SHAPES:
        t0 = time.perf_counter()
        recs = _spawn_ranks(shape, root / f"{shape[0]}x{shape[1]}", run)
        want = mesh_counts(mcfg, dcfg, shape, batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ)
        norm_bytes = mesh_norm_bytes(mcfg, dcfg, shape[1])
        losses = set()
        for r in recs:
            for i, st in enumerate(r["steps"]):
                check(st["launches"] == want,
                      f"mesh {shape} rank {r['rank']} step {i}: launches "
                      f"{st['launches']} != {want}")
                check(st["k6_mma"] == st["launches"]["compose_mm_fwd"],
                      f"mesh {shape} rank {r['rank']}: {st['k6_mma']} of "
                      f"{st['launches']['compose_mm_fwd']} K6 launches on "
                      f"the tensor cores")
                got = st["collectives"].get("norm", {}).get("bytes", 0)
                check(got == norm_bytes,
                      f"mesh {shape} rank {r['rank']}: norm bytes {got} "
                      f"!= {norm_bytes}")
                check(math.isfinite(st["loss"])
                      and math.isfinite(st["grad_norm"])
                      and st["grad_norm"] > 0,
                      f"mesh {shape} rank {r['rank']} step {i}: {st}")
            losses.add(tuple(st["loss"] for st in r["steps"]))
        check(len(losses) == 1, f"mesh {shape}: ranks' losses differ "
              f"{losses}")
        fp32 = recs[0]["fp32"]
        check(fp32["loss_rel"] <= 1e-5
              and fp32["grad_cosine"] >= GRAD_COSINE_MIN
              and fp32["grad_leaf_max_rel"] <= MESH_LEAF_REL_MAX,
              f"mesh {shape} fp32 route: {fp32}")
        serve = mesh_serve_record(mcfg, dcfg, shape, recs)
        engine = mesh_engine_record(mcfg, dcfg, shape, recs)
        tenants = mesh_tenant_record(mcfg, dcfg, shape, recs)
        d7 = mesh_fleet_record(mcfg, dcfg, shape, recs)
        warm = [st["ms"] for st in recs[0]["steps"][1:]]
        rec = {"ranks": len(recs), "launches_per_step": want,
               "norm_bytes_per_step": norm_bytes,
               "gather_bytes_instead": gathered if shape[1] > 1 else 0,
               "step_ms_by_rank": [
                   sum(st["ms"] for st in r["steps"][1:])
                   / max(len(r["steps"]) - 1, 1) for r in recs],
               "peak_bytes_by_rank": [r["peak_bytes"] for r in recs],
               "local_state_bytes_by_rank": [r["local_state_bytes"]
                                             for r in recs],
               "losses": recs[0]["steps"] and [st["loss"] for st in
                                                recs[0]["steps"]],
               "collectives_step": recs[0]["steps"][-1]["collectives"],
               "fp32": fp32, "serve": serve, "engine": engine,
               "tenants": tenants, "d7": d7,
               "seconds": time.perf_counter() - t0}
        out[f"{shape[0]}x{shape[1]}"] = rec
        print(f"mesh (data {shape[0]}, model {shape[1]}) [{MESH_LABEL}]: "
              f"launches a step {want}; norm sums {norm_bytes:,} B a step "
              f"a rank (gathering the other halves of wo and w_down: "
              f"{rec['gather_bytes_instead']:,} B); step ms by rank "
              f"{[round(x, 1) for x in rec['step_ms_by_rank']]} (rank 0 "
              f"steps 2-3 {[round(x, 1) for x in warm]}); peak bytes by "
              f"rank {rec['peak_bytes_by_rank']}; fp32 {fp32}; "
              f"{rec['seconds']:.1f} s", flush=True)
        print(f"  collectives of rank 0's last step: "
              + json.dumps(rec["collectives_step"]), flush=True)
        print(f"  D4 serving (data {shape[0]}, model {shape[1]}) "
              f"[{MESH_LABEL}]: " + json.dumps(
                  {k: v for k, v in serve.items()
                   if k not in ("launches_per_rank",)}), flush=True)
        print(f"  D5 engine (data {shape[0]}, model {shape[1]}) "
              f"[{MESH_LABEL}; no multi-card speed]: " + json.dumps(engine),
              flush=True)
        print(f"  D6 tenants (data {shape[0]}, model {shape[1]}) "
              f"[{MESH_LABEL}; no multi-card speed]: " + json.dumps(tenants),
              flush=True)
        print(f"  D7 dynamic and speculative (data {shape[0]}, model "
              f"{shape[1]}) [{MESH_LABEL}; no multi-card speed]: "
              + json.dumps(d7), flush=True)
    return out


def mesh_serve_record(mcfg, dcfg, shape, recs) -> dict:
    """D4's checks over one mesh's rank records (``_mesh_serve``) and the
    numbers kept of them."""
    want = mesh_serve_counts(mcfg, dcfg, shape, batch=BATCH, seq=MAX_LEN,
                             decode_steps=GEN)
    want_bytes = mesh_decode_bytes(mcfg, dcfg, shape, batch=BATCH)
    per_step = []
    for r in recs:
        sv = r["serve"]
        check(sv["launches"] == want,
              f"D4 mesh {shape} rank {r['rank']}: launches "
              f"{sv['launches']} != {want}")
        check(sv["k6_mma"] == sv["launches"]["compose_mm_fwd"],
              f"D4 mesh {shape} rank {r['rank']}: {sv['k6_mma']} of "
              f"{sv['launches']['compose_mm_fwd']} K6 launches on the "
              f"tensor cores")
        coll = sv["collectives"]
        got = {t: coll[t]["bytes"] // (GEN + 1 if t == "generate.logits"
                                       else GEN)
               for t in coll if t.startswith(("tp.", "decode.",
                                              "generate."))}
        check(got == want_bytes,
              f"D4 mesh {shape} rank {r['rank']}: decode bytes a step "
              f"{got} != {want_bytes}")
        check(sv["tokens_shape"] == [BATCH, PROMPT + GEN]
              and sv["tokens_finite"],
              f"D4 mesh {shape} rank {r['rank']}: tokens {sv}")
        per_step.append(got)
    r0 = recs[0]["serve"]
    fp32 = r0["fp32"]
    check(fp32["g_max_rel"] <= MESH_SERVE_TOL
          and fp32["logit_max_rel"] <= MESH_SERVE_TOL
          and fp32["least_top2_gap"] >= MESH_GAP_MIN
          and fp32["tokens_equal"] and fp32["generated"] == GEN,
          f"D4 mesh {shape} fp32 route: {fp32}")
    own = 1 - r0["bf16_vs_fp32_cosine"]["unsharded"]
    check(1 - r0["bf16_prefill_cosine"] <= MESH_BF16_FACTOR * own
          and 1 - r0["bf16_vs_fp32_cosine"]["mesh"]
          <= MESH_BF16_FACTOR * own + 1e-9,
          f"D4 mesh {shape}: bf16 prefill logit cosine "
          f"{r0['bf16_prefill_cosine']} to the unsharded port, "
          f"{r0['bf16_vs_fp32_cosine']} to the fp32 logits: further than "
          f"{MESH_BF16_FACTOR} x the unsharded route's {own:.3g}")
    return {"launches_per_rank": want,
            "decode_bytes_per_step_per_rank": want_bytes,
            "precompute_ms_by_rank": [r["serve"]["precompute_ms"]
                                      for r in recs],
            "prefill_ms_by_rank": [r["serve"]["prefill_ms"] for r in recs],
            "decode_ms_per_step_by_rank": [
                r["serve"]["decode_ms_per_step"] for r in recs],
            "peak_bytes_by_rank": [r["serve"]["peak_bytes"] for r in recs],
            "seconds_by_rank": [r["serve"]["seconds"] for r in recs],
            "collectives_rank0": r0["collectives"],
            "bf16_prefill_cosine": r0["bf16_prefill_cosine"],
            "bf16_prefill_cosine_at_least_0.9999":
                r0["bf16_prefill_cosine"] >= COSINE_MIN,
            "bf16_vs_fp32_cosine": r0["bf16_vs_fp32_cosine"],
            "bf16_noise_floor_cosine": r0["bf16_noise_floor_cosine"],
            "fp32": fp32}


def mesh_engine_record(mcfg, dcfg, shape, recs) -> dict:
    """D5's checks over one mesh's rank records (``_mesh_engine``) and the
    numbers kept of them: per rank and engine the launches of
    :func:`mesh_engine_counts` exactly (K8 = 2 x layers x (chunk +
    decode steps) on the paged engine, 0 on the rectangular), every K6
    on the tensor cores, each decode step's collective bytes by tag
    exactly ``mesh_decode_bytes`` (the engine's data gather
    "engine.logits"), the stats, device steps and pool of the unsharded
    engine on the same trace, rank 0's streams, a preemption on the paged
    engine and its pool drained; the fp32 paged == rect streams on every
    rank; on (2, 2) the server's streams equal the paged engine's, and the
    fp32 engines' fetched logits within MESH_SERVE_TOL of max |logit| of
    the unsharded port's, each top-2 gap at least MESH_GAP_MIN, and their
    tokens equal."""
    out = {}
    for name in ("rect", "paged"):
        r0 = recs[0]["serve"]["engine"][name]
        one = r0["one_card"]
        want_bytes = mesh_decode_bytes(mcfg, dcfg, shape, batch=D5_SLOTS,
                                       logits_tag="engine.logits")
        for r in recs:
            e = r["serve"]["engine"][name]
            where = f"D5 mesh {shape} rank {r['rank']} {name}"
            for key in ("stats", "device_steps", "pool"):
                check(e[key] == one[key], f"{where}: {key} {e[key]} != the "
                      f"unsharded engine's {one[key]}")
            want = mesh_engine_counts(mcfg, dcfg, shape, e["device_steps"],
                                      paged=name == "paged")
            check(e["launches"] == want,
                  f"{where}: launches {e['launches']} != {want}")
            check(e["k6_mma"] == e["launches"]["compose_mm_fwd"],
                  f"{where}: {e['k6_mma']} of "
                  f"{e['launches']['compose_mm_fwd']} K6 launches on the "
                  f"tensor cores")
            n = e["device_steps"]["decode"]
            coll = e["collectives"]
            got = {t: coll[t]["bytes"] / n for t in coll
                   if t.startswith(("tp.", "decode.", "engine."))}
            check(got == want_bytes, f"{where}: decode bytes a step {got} "
                  f"!= {want_bytes}")
            check(e["streams"] == r0["streams"],
                  f"{where}: streams differ from rank 0's")
            check(len(e["streams"]) == D5_REQUESTS and all(
                len(v) == D5_NEW and all(0 <= t < mcfg.vocab_size for t in v)
                for v in e["streams"].values()),
                f"{where}: streams {e['streams']}")
        if name == "paged":
            check(r0["stats"]["preemptions"] >= 1
                  and r0["pool"]["used_blocks"] == 0,
                  f"D5 mesh {shape} paged: stats {r0['stats']}, pool "
                  f"{r0['pool']}")
        out[name] = {
            "launches_per_rank": want, "decode_bytes_per_step": want_bytes,
            "ticks": r0["stats"]["steps"],
            "device_steps": r0["device_steps"],
            "preemptions": r0["stats"]["preemptions"],
            "peak_used_blocks": (r0["pool"] or {}).get("peak_used_blocks"),
            **{f"{k}_by_rank": [r["serve"]["engine"][name][k] for r in recs]
               for k in ("ms_per_tick", "decode_ms", "chunk_ms",
                         "prefill_into_slot_ms", "fetch_ms", "wall_s",
                         "peak_bytes")}}
    for r in recs:
        check(r["serve"]["engine"]["fp32_paged_equals_rect"],
              f"D5 mesh {shape} rank {r['rank']}: fp32 paged streams "
              f"differ from the rectangular engine's")
    e0 = recs[0]["serve"]["engine"]
    if "server" in e0:
        check(e0["server"]["streams_equal_engine"]
              and e0["server"]["reasons"] == ["length"],
              f"D5 mesh {shape}: EngineServer {e0['server']}")
        out["server"] = e0["server"]
    if "fp32" in e0:
        for name, f in e0["fp32"].items():
            check(f["least_top2_gap"] >= MESH_GAP_MIN
                  and f["logit_max_rel"] <= MESH_SERVE_TOL
                  and f["tokens_equal"],
                  f"D5 mesh {shape} fp32 {name} engine against one card: "
                  f"{f}")
        out["fp32"] = e0["fp32"]
    out["seconds_by_rank"] = [r["serve"]["engine"]["seconds"] for r in recs]
    return out


def mesh_tenant_record(mcfg, dcfg, shape, recs) -> dict:
    """D6's checks over one mesh's rank records (``_mesh_tenants``) and
    the numbers kept of them: per rank the cold server's launches
    exactly :func:`mesh_tenant_counts` (K6 = 0) and the warm one's none,
    each decode step's collective bytes by tag exactly the single-tenant
    ``mesh_decode_bytes`` at the same batch (grouping adds no collective
    byte), three misses then three hits, the same tokens warm as cold and
    on every rank, the tenants' greedy tokens on the shared prompt
    pairwise different; per rank and engine the launches of
    :func:`mesh_tenant_counts` (K8 = 2 x layers x (chunk + decode steps)
    on the paged engine, K6 = 0), the decode bytes of D5, the stats,
    device steps and pool of D5's unsharded engine (the same trace and
    geometry: the schedule does not depend on the adapters, so D6 does
    not run it again), rank 0's streams, a grouped
    decode signature, a preemption and a drained pool on the paged one;
    the fp32 paged == rect streams on every rank; the fp32 server's every
    step's logits within D6_TOL of max |logit| of one card's grouped run,
    each top-2 gap at least MESH_GAP_MIN and the tokens equal, and the
    tenants' first logits apart; on (2, 2) the server's streams equal the
    paged engine's and the fp32 engines within D6_TOL of one card's."""
    batch = MT_TENANTS * MT_ROWS
    cold = mesh_tenant_counts(mcfg, dcfg, shape)
    want_bytes = mesh_decode_bytes(mcfg, dcfg, shape, batch=batch)
    r0 = recs[0]["serve"]["tenants"]
    for r in recs:
        t = r["serve"]["tenants"]
        where = f"D6 mesh {shape} rank {r['rank']}"
        for run, want in (("cold", cold), ("warm", counts_of())):
            check(t[run]["launches"] == want,
                  f"{where} server {run}: launches {t[run]['launches']} "
                  f"!= {want}")
            coll = t[run]["collectives"]
            got = {k: coll[k]["bytes"] // (GEN + 1 if k == "generate.logits"
                                           else GEN)
                   for k in coll if k.startswith(("tp.", "decode.",
                                                  "generate."))}
            check(got == want_bytes, f"{where} server {run}: decode bytes "
                  f"a step {got} != the single-tenant step's {want_bytes}")
        check(t["cold"]["cache"]["misses"] == MT_TENANTS
              and t["warm"]["cache"]["hits"] == MT_TENANTS,
              f"{where}: cache {t['warm']['cache']}")
        check(t["warm_equals_cold"] and t["tokens"] == r0["tokens"]
              and t["groups"] == [[2 * k, 2] for k in range(MT_TENANTS)],
              f"{where}: warm tokens, rank 0's tokens or groups differ "
              f"({t['groups']})")
        for name in ("rect", "paged"):
            e = t[name]
            one = recs[0]["serve"]["engine"][name]["one_card"]
            for key in ("stats", "device_steps", "pool"):
                check(e[key] == one[key], f"{where} {name}: {key} {e[key]} "
                      f"!= the unsharded engine's {one[key]}")
            want = mesh_tenant_counts(mcfg, dcfg, shape, e["device_steps"],
                                      paged=name == "paged")
            check(e["launches"] == want,
                  f"{where} {name}: launches {e['launches']} != {want}")
            n = e["device_steps"]["decode"]
            got = {k: v["bytes"] / n for k, v in e["collectives"].items()
                   if k.startswith(("tp.", "decode.", "engine."))}
            d5_bytes = mesh_decode_bytes(mcfg, dcfg, shape, batch=D5_SLOTS,
                                         logits_tag="engine.logits")
            check(got == d5_bytes, f"{where} {name}: decode bytes a step "
                  f"{got} != {d5_bytes}")
            check(e["streams"] == r0[name]["streams"]
                  and len(e["streams"]) == D5_REQUESTS
                  and e["cache"]["misses"] == MT_TENANTS
                  and any(k != "None" for k in e["signatures"]),
                  f"{where} {name}: streams, cache {e['cache']} or "
                  f"signatures {e['signatures']}")
        check(t["fp32_paged_equals_rect"],
              f"{where}: fp32 paged streams differ from the rectangular "
              f"engine's")
    gen_part = [row[PROMPT:] for row in r0["tokens"][:MT_TENANTS]]
    check(all(gen_part[a] != gen_part[b] for a in range(MT_TENANTS)
              for b in range(a + 1, MT_TENANTS)),
          f"D6 mesh {shape}: tenants' greedy tokens on the shared prompt "
          f"are not pairwise different")
    check(r0["paged"]["stats"]["preemptions"] >= 1
          and r0["paged"]["pool"]["used_blocks"] == 0,
          f"D6 mesh {shape} paged: {r0['paged']['stats']}")
    f = r0["fp32_server"]
    check(f["logit_max_rel"] <= D6_TOL
          and f["least_top2_gap"] >= MESH_GAP_MIN and f["tokens_equal"]
          and f["generated"] == D5_FP32_NEW
          and f["tenant_first_logits_min_rel"] > 1e-3,
          f"D6 mesh {shape} fp32 server against one card: {f}")
    out = {"server_launches_cold_per_rank": cold,
           "decode_bytes_per_step": want_bytes,
           "fp32_server": f,
           **{f"server_{run}_{k}_by_rank": [
               r["serve"]["tenants"][run][k] for r in recs]
              for run in ("cold", "warm")
              for k in ("precompute_ms", "stack_ms", "prefill_ms",
                        "decode_ms_per_step", "peak_bytes")}}
    for name in ("rect", "paged"):
        e = r0[name]
        out[name] = {
            "launches_per_rank": e["launches"], "ticks": e["stats"]["steps"],
            "device_steps": e["device_steps"],
            "signatures": e["signatures"],
            **{f"{k}_by_rank": [r["serve"]["tenants"][name][k]
                                for r in recs]
               for k in ("ms_per_tick", "decode_ms", "wall_s",
                         "peak_bytes")}}
    if "server" in r0:
        check(r0["server"]["streams_equal_engine"]
              and r0["server"]["reasons"] == ["length"],
              f"D6 mesh {shape}: EngineServer {r0['server']}")
        out["server"] = r0["server"]
    if "fp32_engine" in r0:
        for name, f in r0["fp32_engine"].items():
            check(f["least_top2_gap"] >= MESH_GAP_MIN
                  and f["logit_max_rel"] <= D6_TOL and f["tokens_equal"],
                  f"D6 mesh {shape} fp32 {name} engine against one card: "
                  f"{f}")
        out["fp32_engine"] = r0["fp32_engine"]
    out["seconds_by_rank"] = [r["serve"]["tenants"]["seconds"] for r in recs]
    return out


def mesh_fleet_counts(mcfg, dcfg, shape, steps: dict, *,
                      tenants: int) -> dict:
    """Launches a rank makes in one D7 bf16 run: ``tenants`` mesh
    precomputes (:func:`mesh_tenant_counts`' split: K1 with its epilogue
    on the column-parallel modules, K1's terms and the standalone K2 on
    wo and w_down at model > 1), no compose kernel (the states are
    gsB-folded: the dynamic and the verify's compose is the plain fp32
    h·gsBᵀ), and K8 twice a layer in every paged chunk, decode, draft and
    verify step (``steps``: the engine's ``device_steps()``)."""
    c = _mesh_step_counts(mcfg, dcfg, shape[1], ())
    c = {key: tenants * v for key, v in c.items()}
    c["paged_gather"] = 2 * mcfg.num_layers * (
        steps["decode"] + steps["prefill_chunk"] + steps["draft"]
        + steps["verify"])
    return c


def mesh_fleet_record(mcfg, dcfg, shape, recs) -> dict:
    """D7's checks over one mesh's rank records (``_mesh_fleet_spec``) and
    the numbers kept of them.

    bf16, per rank: the dynamic engine's launches exactly
    :func:`mesh_fleet_counts` (three tenants, K6 = 0), three cache misses
    and D7_STACK_INSERTS stack inserts, every decode under
    ``"dynamic"``, each decode step's bytes by
    tag exactly the single-tenant step's at D5_SLOTS rows
    (``mesh_decode_bytes``), its schedule (stats but the stack inserts,
    device steps but the inserts, pool) D6's static paged engine's on the
    same trace, rank 0's streams; the speculative paged engine's launches
    (one precompute, K8 on every paged step), each draft, verify and
    decode step's bytes by tag exactly ``mesh_draft_bytes``,
    ``mesh_verify_bytes`` and ``mesh_decode_bytes``, rank 0's streams, the
    pool drained. fp32, per rank: the fleet trace's dynamic counters
    ``fleet.schedule_model``, one signature, the static engine's four,
    equal streams dynamic, dynamic paged and static, the dynamic rows
    within D7_FLEET_TOL of the static ones; identity adapters' counters
    ``speculative_model`` rectangular and paged; the perturbed ones'
    ladder disabling and re-enabling, speculative streams equal the plain
    engine's; paged == rectangular; K8 2 x layers a paged step; on (2, 2)
    the fleet's dynamic logits and the verify's fetched logits within
    D6_TOL of max of one card's, the tokens equal, and the servers'
    streams."""
    bench = json.loads((Path(__file__).resolve().parent
                        / "BENCH_serve.json").read_text())
    f_model = bench["fleet"]["schedule_model"]
    _, slots, _, k, s_model = speculative_trace()
    L = mcfg.num_layers
    decode_bytes = mesh_decode_bytes(mcfg, dcfg, shape, batch=D5_SLOTS,
                                     logits_tag="engine.logits")
    spec_bytes = {
        "decode": mesh_decode_bytes(mcfg, dcfg, shape, batch=slots,
                                    logits_tag="engine.logits"),
        "draft": mesh_draft_bytes(mcfg, dcfg, shape, batch=slots),
        "verify": mesh_verify_bytes(mcfg, dcfg, shape, batch=slots,
                                    window=k + 1)}
    r0 = recs[0]["serve"]["d7"]
    out: dict = {}
    for r in recs:
        d = r["serve"]["d7"]
        where = f"D7 mesh {shape} rank {r['rank']}"
        if "dynamic_bf16" in d:
            e = d["dynamic_bf16"]
            steps = {**e["device_steps"], "draft": 0, "verify": 0}
            want = mesh_fleet_counts(mcfg, dcfg, shape, steps,
                                     tenants=MT_TENANTS)
            check(e["launches"] == want and e["k6_mma"] == 0,
                  f"{where} dynamic bf16: launches {e['launches']} != "
                  f"{want}")
            inserts = e["stats"]["stack_inserts"]
            check(e["device_steps"]["adapter_insert"] == inserts
                  == D7_STACK_INSERTS
                  and e["cache"]["misses"] == MT_TENANTS
                  and e["signatures"] == {"dynamic": steps["decode"]},
                  f"{where} dynamic bf16: {inserts} inserts, cache "
                  f"{e['cache']} or signatures {e['signatures']}")
            b = e["step_bytes"]["decode"]
            check(b["n"] == steps["decode"]
                  and b["distinct"] == [decode_bytes],
                  f"{where} dynamic bf16: decode bytes a step "
                  f"{b['distinct']} != {decode_bytes}")
            static = r["serve"]["tenants"]["paged"]
            same = {key: v for key, v in e["stats"].items()
                    if key != "stack_inserts"}
            check(same == {key: v for key, v in static["stats"].items()
                           if key != "stack_inserts"}
                  and {**e["device_steps"], "adapter_insert": 0}
                  == static["device_steps"]
                  and e["pool"] == static["pool"],
                  f"{where} dynamic bf16: schedule {e['stats']} differs "
                  f"from D6's static paged engine's")
            check(e["streams"] == r0["dynamic_bf16"]["streams"]
                  and len(e["streams"]) == D5_REQUESTS,
                  f"{where} dynamic bf16: streams differ from rank 0's")
            e = d["spec_bf16"]
            want = mesh_fleet_counts(mcfg, dcfg, shape, e["device_steps"],
                                     tenants=1)
            check(e["launches"] == want,
                  f"{where} speculative bf16: launches {e['launches']} != "
                  f"{want}")
            for kind, model in spec_bytes.items():
                b = e["step_bytes"][kind]
                check(b["n"] == e["device_steps"][kind]
                      and b["distinct"] in ([model], []),
                      f"{where} speculative bf16: {kind} bytes a step "
                      f"{b['distinct']} != {model}")
            check(e["streams"] == r0["spec_bf16"]["streams"]
                  and e["pool"]["used_blocks"] == 0
                  and e["device_steps"]["verify"] > 0,
                  f"{where} speculative bf16: streams, pool {e['pool']} or "
                  f"no verify")
        f = d["fleet"]
        st = f["dynamic"]["stats"]
        for field in ("steps", "decode_steps", "prefills",
                      "generated_tokens", "slot_steps", "mean_occupancy"):
            check(st[field] == f_model[field],
                  f"{where} fleet dynamic {field}={st[field]}, "
                  f"BENCH_serve.json {f_model[field]}")
        check(sorted(f["dynamic"]["signatures"]) == ["dynamic"]
              and sorted(f["static"]["signatures"])
              == f_model["signature_keys"]
              and sorted(f["dynamic_paged"]["signatures"]) == ["dynamic"],
              f"{where} fleet signatures")
        check(f["dynamic"]["streams"] == f["static"]["streams"]
              == f["dynamic_paged"]["streams"]
              and f["dyn_vs_static"] <= D7_FLEET_TOL
              and f["dynamic"]["streams"] == r0["fleet"]["dynamic"]["streams"],
              f"{where} fleet: streams or dynamic vs static "
              f"{f['dyn_vs_static']:.3g} (> {D7_FLEET_TOL})")
        pst = f["dynamic_paged"]["device_steps"]
        check(f["dynamic_paged"]["paged_gather"] == 2 * L * (
            pst["decode"] + pst["prefill_chunk"])
              and f["dynamic"]["paged_gather"] == 0,
              f"{where} fleet: K8 launches")
        s = d["spec"]
        for geo in ("rect", "paged"):
            got = {field: s[f"identity_{geo}"]["stats"][field]
                   for field in s_model}
            check(got == s_model, f"{where} identity {geo}: counters "
                  f"{got}, BENCH_serve.json {s_model}")
            pert = s[f"perturbed_{geo}"]["stats"]
            check(pert["spec_disables"] >= 1 and pert["spec_reenables"] >= 1,
                  f"{where} perturbed {geo}: the ladder {pert}")
            for name in ("identity", "perturbed"):
                e = s[f"{name}_{geo}"]
                st = e["device_steps"]
                want = 2 * L * (st["decode"] + st["prefill_chunk"]
                                + st["draft"] + st["verify"])
                check(e["paged_gather"] == (want if geo == "paged" else 0),
                      f"{where} {name} {geo}: K8 {e['paged_gather']} != "
                      f"{want}")
        check(s["identity_rect"]["streams"] == s["identity_paged"]["streams"]
              and s["perturbed_rect"]["streams"]
              == s["perturbed_paged"]["streams"]
              == s["perturbed_plain"]["streams"]
              and s["perturbed_rect"]["streams"]
              == r0["spec"]["perturbed_rect"]["streams"],
              f"{where}: speculative streams differ from the plain or "
              f"paged engine's or rank 0's")
    if "servers" in r0:
        check(all(v for key, v in r0["servers"].items()
                  if key != "mt_signatures")
              and set(r0["servers"]["mt_signatures"]["decode"])
              == {"dynamic"},
              f"D7 mesh {shape} servers: {r0['servers']}")
        out["servers"] = r0["servers"]
    for key in ("fleet_one_card", "verify_one_card"):
        if key in r0:
            f = r0[key]
            check(f["logit_max_rel"] <= D6_TOL and f["tokens_equal"]
                  and f.get("least_top2_gap", 1.0) >= MESH_GAP_MIN,
                  f"D7 mesh {shape} {key}: {f}")
            out[key] = f
    out["g_dev_by_rank"] = [r["serve"]["d7"]["spec"]["g_dev"] for r in recs]
    out["fleet_dyn_vs_static_by_rank"] = [
        r["serve"]["d7"]["fleet"]["dyn_vs_static"] for r in recs]
    out["spec_fp32"] = {name: {f: v["stats"][f] for f in (
        "steps", "decode_steps", "draft_steps", "verify_steps",
        "accepted_drafts", "spec_disables", "spec_reenables")}
        for name, v in r0["spec"].items() if name != "g_dev"}
    if "dynamic_bf16" in r0:
        out["dynamic_bf16"] = {
            "launches_per_rank": r0["dynamic_bf16"]["launches"],
            "decode_bytes_per_step": decode_bytes,
            "ticks": r0["dynamic_bf16"]["stats"]["steps"],
            "stack_inserts": r0["dynamic_bf16"]["stats"]["stack_inserts"],
            **{f"{key}_by_rank": [r["serve"]["d7"]["dynamic_bf16"][key]
                                  for r in recs]
               for key in ("ms_per_tick", "decode_ms", "wall_s",
                           "peak_bytes")}}
        e = r0["spec_bf16"]
        out["spec_bf16"] = {
            "launches_per_rank": e["launches"], "step_bytes": spec_bytes,
            "ticks": e["stats"]["steps"], "device_steps": e["device_steps"],
            "accept_rate": e["accept_rate"],
            **{f"{key}_by_rank": [r["serve"]["d7"]["spec_bf16"][key]
                                  for r in recs]
               for key in ("ms_per_tick", "draft_ms", "verify_ms",
                           "decode_ms", "wall_s", "peak_bytes")}}
    out["seconds_by_rank"] = [r["serve"]["d7"]["seconds"] for r in recs]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--kernel-phase-vs"]:
        return kernel_phase_vs(Path(sys.argv[2]))
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import probes
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: {probes.report()}", flush=True)
    probes.require_cuda(0)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(root)}", flush=True)
    ptxas = ptxas_report(lib.with_suffix(".log").read_text())
    for line in ptxas:
        print(f"  {line}")
    k6_ptxas = [ln for ln in ptxas
                if ln.startswith("compose_mm_fwd_mma_kernel:")]
    check(len(k6_ptxas) == 1 and " 0 bytes spill stores" in k6_ptxas[0],
          f"compose_mm_fwd_mma_kernel's ptxas report: {k6_ptxas}")
    k9_ptxas = [ln for ln in ptxas if ln.startswith("selective_scan_kernel")]
    check(len(k9_ptxas) == 6 and all(" 0 bytes spill stores" in ln
                                     for ln in k9_ptxas),
          f"selective_scan_kernel's ptxas report (one per lane count, with "
          f"and without chunk states): {k9_ptxas}")
    bwd_ptxas = [ln for ln in ptxas if ln.startswith("selective_scan_bwd")]
    check(len(bwd_ptxas) == 3 and all(" 0 bytes spill stores" in ln
                                      for ln in bwd_ptxas),
          f"selective_scan_bwd's ptxas report (the scan at 4 and 8 lanes "
          f"and its partial sum): {bwd_ptxas}")
    for lanes in (4, 8):
        occ = bwd_occupancy(lanes)
        print(f"  selective_scan_bwd_kernel<{lanes}> occupancy: "
              + json.dumps(occ), flush=True)
        check(occ["warps_per_sm"] > 4 and occ["local_bytes"] == 0,
              f"selective_scan_bwd at {lanes} lanes: {occ}")

    print("kernels vs plain versions:", flush=True)
    rows = kernel_checks(dev)
    print("kernels vs plain versions at the other archs' shapes:",
          flush=True)
    arch_kernel_checks(dev, rows)
    print("kernels vs plain versions at the mesh's local shapes (D1):",
          flush=True)
    mesh_kernels = mesh_kernel_checks(dev, rows)
    host = host_checks(dev)
    small_parity(dev)
    t0 = time.perf_counter()
    mesh = mesh_checks(dev)
    print(f"mesh phases D2-D7: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    served, mcfg, params, adapters = serve_checks(dev)
    print(f"serve phases: {time.perf_counter() - t0:.1f} s", flush=True)
    # The host-bound engine, speculative, fault and FL2 phases run on the
    # first ENGINE_LAYERS layers (views of the full model's stacks).
    emcfg = dataclasses.replace(mcfg, num_layers=ENGINE_LAYERS)
    eparams = _layer_views(params, ENGINE_LAYERS)
    eadapters = _layer_views(adapters, ENGINE_LAYERS)
    t0 = time.perf_counter()
    engine = engine_checks(dev, emcfg, eparams, eadapters)
    engine["parity"] = engine_parity(dev, mcfg, params, adapters)
    print(f"engine phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    plain_main = {**engine["engine_paged"],
                  "streams": engine.pop("realistic_streams")}
    spec, spec_state = spec_checks(dev, emcfg, eparams, eadapters,
                                   plain_main)
    faults = fault_checks(dev, emcfg, eparams, spec_state)
    del spec_state
    print(f"spec and fault phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    mt = serve_mt_checks(dev, mcfg, params)
    print(f"serve_mt phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fleet = {"fl1": fleet_parity(dev, mcfg, params)}
    print(f"fleet FL1: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fleet["fl2"] = fleet_checks(dev, emcfg, eparams, eadapters, plain_main)
    print(f"fleet FL2: {time.perf_counter() - t0:.1f} s", flush=True)
    cli_reckoning = full_depth_reckoning(fleet["fl2"]["reckoning"], params,
                                         mcfg.num_layers, ENGINE_LAYERS)
    del eparams, eadapters
    t0 = time.perf_counter()
    trained = train_checks(dev, mcfg, params, adapters)
    del params, adapters
    torch.cuda.empty_cache()
    parity = train_parity(dev)
    print(f"train phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cli = cli_checks(dev, cli_reckoning)
    print(f"serve CLI phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mamba = mamba_checks(dev)
    print(f"mamba phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mamba_train = mamba_train_checks(dev)
    print(f"mamba train phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    vl = vl_checks(dev)
    print(f"{VL_ARCH} phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    archs = arch_checks(dev)
    print(f"arch phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe = moe_checks(dev)
    print(f"{MOE_ARCH} phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    jamba = jamba_checks(dev)
    print(f"{JAMBA_ARCH} phases: {time.perf_counter() - t0:.1f} s",
          flush=True)

    by_path = {"serve_auto": served["auto"], "serve_fused": served["fused"],
               "train_auto": trained["train_auto"]["launches"],
               "train_elementwise": trained["train_elementwise"]["launches"],
               "engine_paged": engine["engine_paged"]["launches"],
               "engine_trace_paged": engine["traces"]["paged"]["launches"],
               "engine_spec": spec["bf16"]["launches"],
               "serve_mt": mt["cold"]["launches"],
               "engine_fleet_dynamic": fleet["fl2"]["dynamic"]["launches"],
               "engine_fleet_static": fleet["fl2"]["static"]["launches"],
               "serve_mamba": mamba["serve_mamba"]["launches"],
               "train_mamba": mamba_train["train"]["launches"],
               **{f"serve_cli_{m}": cli[m]["launches"]
                  for m in ("paged", "speculative", "faults", "fleet")},
               "train_vl": vl["train"]["launches"],
               "serve_vl": vl["serve"]["launches"],
               **{f"serve_{a}": r["launches"] for a, r in archs.items()},
               "serve_moe": moe["serve"]["launches"],
               "train_moe": moe["train"]["launches"],
               "serve_jamba": jamba["serve"]["launches"],
               "train_jamba": jamba["train"]["launches"],
               **{f"train_mesh_{k}_per_step_per_rank": r["launches_per_step"]
                  for k, r in mesh.items() if isinstance(r, dict)},
               **{f"serve_mesh_{k}_per_rank": r["serve"]["launches_per_rank"]
                  for k, r in mesh.items() if isinstance(r, dict)},
               **{f"engine_mesh_{k}_{e}_per_rank":
                  r["engine"][e]["launches_per_rank"]
                  for k, r in mesh.items() if isinstance(r, dict)
                  for e in ("rect", "paged")},
               **{f"tenants_mesh_{k}_server_cold_per_rank":
                  r["tenants"]["server_launches_cold_per_rank"]
                  for k, r in mesh.items() if isinstance(r, dict)},
               **{f"tenants_mesh_{k}_{e}_per_rank":
                  r["tenants"][e]["launches_per_rank"]
                  for k, r in mesh.items() if isinstance(r, dict)
                  for e in ("rect", "paged")}}
    record = []
    for name, (src, replaces) in SOURCES.items():
        path, at = RECORD_PATH[name]
        top = rows[name][at]
        # K2's arithmetic runs on the main paths as K1's epilogue: its
        # count there is K1's launches that ended in it.
        key = "assembled" if name == "assemble_norm" else name
        check(by_path[path][key] > 0, f"{name} never launched on {path}")
        record.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": by_path[path][key],
            "path": path,
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            **({"launched_as": "the epilogue of norm_terms "
                               "(csrc/norm_terms.cu; counted by "
                               "norm_terms.assembled_launches)",
                "standalone_launches_by_path": {
                    p: c[name] for p, c in by_path.items()},
                "device_ms": top["device_ms"]}
               if name == "assemble_norm" else {}),
            **({k: top[k] for k in ("assembled_ms", "fused_norm_ms",
                                    "chain_ms", "epilogue_bound_ms",
                                    "device_ms_by_kernel")}
               if name == "norm_terms" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "tol": top["tol"], "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library_call": top["library_call"], "at_shape": top["shape"],
            "gb_s": top["gb_s"], "host_us": host[name],
            **({"device_ms": top["device_ms"], "fma_ms": top["fma_ms"],
                "deterministic": top["deterministic"], "ptxas": k6_ptxas[0]}
               if name == "compose_mm_fwd" else {}),
            **({"device_ms": top["device_ms"],
                "index_select_host_us": host["index_select (PyTorch op)"],
                "mesh_local_views": [
                    {k: r[k] for k in ("shape", "ms", "library_ms",
                                       "bound_ms", "mesh_shard")}
                    for r in rows[name] if "mesh_shard" in r]}
               if name == "paged_gather" else {}),
            **({k: top[k] for k in ("device_ms", "lanes", "lane_sweep_ms",
                                    "deterministic", "train_shape",
                                    "chunk_states_ms",
                                    "without_states_ms_train_shape")}
               if name == "selective_scan" else {}),
            **({k: top[k] for k in ("device_ms", "deterministic", "errors",
                                    "chunk_states_forward", "lanes",
                                    "lane_sweep_ms", "occupancy",
                                    "bound_bytes_ms", "bound_sfu_ms",
                                    "bound_sfu_design_ms")}
               if name == "selective_scan_bwd" else {})})
    train_summary = {
        k: {f: trained[k][f] for f in ("step_ms", "grad_ms", "optim_ms",
                                       "tokens_per_s",
                                       "max_memory_allocated_bytes")}
        for k in ("train_auto", "train_elementwise")}
    train_summary["train_auto"]["profile"] = {
        k: v for k, v in trained["train_auto"]["profile"].items()
        if k != "top_kernels_ms"}
    # Every shape's row and every phase's numbers go to a file; the
    # output keeps the headline record short enough to read whole.
    detail = root / "build" / "chip_smoke.json"
    detail.parent.mkdir(exist_ok=True)
    detail.write_text(json.dumps({
        "card": smi, "kernel_rows": rows, "serve": served,
        "engine": engine, "spec": spec, "faults": faults, "serve_mt": mt,
        "fleet": fleet,
        "train": {k: trained[k] for k in ("train_auto", "train_elementwise",
                                          "fp32_agreement")},
        "train_parity": parity, "mamba": mamba, "mamba_train": mamba_train,
        "serve_cli": cli, "vl": vl, "archs": archs, "moe": moe,
        "jamba": jamba, "mesh": mesh, "mesh_kernels": mesh_kernels},
        indent=1))
    print(f"details: {detail.relative_to(root)}")
    print(smi)
    print(json.dumps({"kernels": record, "card": smi,
                      "mesh": {k: ({f: r[f] for f in (
                          "ranks", "launches_per_step",
                          "norm_bytes_per_step", "gather_bytes_instead",
                          "step_ms_by_rank", "peak_bytes_by_rank", "fp32")}
                          | {"serve": {f: v for f, v in r["serve"].items()
                                       if f != "collectives_rank0"},
                             "engine": r["engine"], "tenants": r["tenants"]}
                          if isinstance(r, dict) else r)
                          for k, r in mesh.items()},
                      "serve": {k: served[k] for k in
                                ("serve_auto", "serve_fused", "cosines")},
                      "engine": {k: v for k, v in engine["engine_paged"].items()
                                 if k not in ("trace", "launches",
                                              "decode_tick_profile")},
                      "spec": {k: v for k, v in spec["bf16"].items()
                               if k not in ("launches", "tick_profile",
                                            "divergence_token_by_request")},
                      "faults": {k: faults[k] for k in (
                          "victims", "injected_nans", "slow_ticks")},
                      "train": train_summary,
                      "mt": {**{run: {k: v for k, v in mt[run].items()
                                      if k not in ("launches", "cache",
                                                   "profile")}
                                for run in ("cold", "warm",
                                            "single_tenant_gsb")},
                             "host_tier": {k: mt["host_tier"][k] for k in (
                                 "precompute_ms", "reload_ms", "spill_ms")},
                             "state_nbytes": mt["state_nbytes"],
                             "state_held_bytes": mt["state_held_bytes"],
                             "fp32_parity": mt["fp32_parity"]},
                      "fleet": {form: {k: fleet["fl2"][form][k] for k in (
                          "ticks", "ms_per_tick", "decode_ms", "tokens_per_s",
                          "max_memory_allocated_bytes", "cache",
                          "stack_inserts", "signatures")}
                          for form in ("dynamic", "static")}
                      | {"tenants": FLEET_TENANTS,
                         "requests_equal_static":
                         fleet["fl2"]["requests_equal_static"],
                         "e1_decode_ms": fleet["fl2"]["e1"]["decode_ms"]},
                      "mamba": {k: v for k, v in mamba["serve_mamba"].items()
                                if not k.endswith("_profile")},
                      "mamba_train": {
                          **{f: mamba_train["train"][f] for f in (
                              "step_ms", "tokens_per_s",
                              "max_memory_allocated_bytes")},
                          "device_idle_share": mamba_train["train"][
                              "profile"].get("device_idle_share"),
                          "fp32_routes": {
                              k: mamba_train["fp32_routes"]["auto"][k]
                              for k in ("loss_rel_to_eager",
                                        "grad_cosine_to_eager")}},
                      "serve_cli": {m: {k: v for k, v in r.items()
                                        if k != "launches"}
                                    for m, r in cli.items()
                                    if m != "fleet_reckoning"},
                      "vl": {"train": {f: vl["train"][f] for f in (
                          "step_ms", "tokens_per_s",
                          "max_memory_allocated_bytes")},
                          "serve": {k: v for k, v in vl["serve"].items()
                                    if "launches" not in k}},
                      "archs": {a: {k: v for k, v in r.items()
                                    if k != "launches"}
                                for a, r in archs.items()},
                      "moe": {
                          "serve": {k: v for k, v in moe["serve"].items()
                                    if k not in ("launches",
                                                 "decode_profile")}
                          | {"decode_idle_share": moe["serve"][
                              "decode_profile"].get("device_idle_share")},
                          "train": {f: moe["train"][f] for f in (
                              "step_ms", "tokens_per_s",
                              "max_memory_allocated_bytes",
                              "recompute_routes_bitwise")}
                          | {"device_idle_share": moe["train"][
                              "profile"].get("device_idle_share"),
                             "ranges_ms": moe["train"]["profile"].get(
                                 "ranges_ms")},
                          "train_fp32_routes": {
                              k: moe["train_fp32_routes"][k] for k in (
                                  "loss_rel", "grad_cosine")},
                          "serve_fp32_routes": {
                              k: moe["serve_fp32_routes"][k] for k in (
                                  "prefill_logit_cosine",
                                  "tokens_equal")}},
                      "jamba": {
                          "serve": {k: v for k, v in jamba["serve"].items()
                                    if k not in ("launches",
                                                 "prefill_profile",
                                                 "decode_profile")}
                          | {f"{p}_idle_share": jamba["serve"][
                              f"{p}_profile"].get("device_idle_share")
                             for p in ("prefill", "decode")},
                          "train": {f: jamba["train"][f] for f in (
                              "layers", "step_ms", "tokens_per_s",
                              "max_memory_allocated_bytes",
                              "recompute_routes_bitwise")}
                          | {"device_idle_share": jamba["train"][
                              "profile"].get("device_idle_share")},
                          "train_fp32_routes": {
                              k: jamba["train_fp32_routes"][k] for k in (
                                  "loss_rel", "grad_cosine")},
                          "serve_fp32_routes": {
                              k: jamba["serve_fp32_routes"][k] for k in (
                                  "prefill_logit_cosine",
                                  "tokens_equal")}}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
