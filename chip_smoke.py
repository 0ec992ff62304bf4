#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` into the
gitignored ``build/`` and runs, in order, printing one JSON line each:

  device   nvidia-smi's name and power limit, torch/CUDA versions, the
           kernel build time, ptxas' register report, and the HGMMA count
           of each tensor-core K5 and K5b function in the library's SASS
           (``cuobjdump -sass``; a function without one fails the run);
  kernels  K1 (ring_lookup64), K2 (ring_lookup_bucketed), K3
           (decode_attention), K5 (flash_attention: qwen2.5-3b's
           1024-token admit in bf16 and fp16, a ragged 1000, a non-causal
           Sq != Sk, and f32; zamba2-7b's shared-block admit, 32 / 32 heads
           at hd 112, in bf16 and fp16; each case's route, tensor cores or
           SIMT, is checked against ``kernel.route``; qwen2.5-3b's admit on
           one shard of tp = 2, 8 / 1 heads), K5 with the rows' logsumexp
           (the training forward; lse within 1e-4 of the plain one, its
           output equal to the serve path's) and K5b (the flash backward,
           csrc/flash_attention_bwd.cu: qwen2.5-3b's training shape, B 8,
           S 1024, 16/2 heads of hd 128, causal, in bf16, fp16 and f32,
           lm-100m's, B 8, S 256, 12/4 of hd 64, deepseek-v2's, B 1,
           S 2048, 128/128 of q . k 192 and v 128, qwen3-moe's, B 4,
           S 1024, 64/4 of hd 128, zamba2-7b's, B 8, S 1024, 32/32 of hd
           112 in bf16 and fp16, and whisper-small's, B 8, 12/12 of hd 64,
           1500 x 1500 and 448 x 1500 unmasked and 448 causal, in bf16;
           max |d| / max |ref| per gradient within 2e-2, 5e-3 and 1e-4, two
           calls bit-equal; each case's route checked against
           ``kernel.bwd_route``; timed in turns with SDPA's backward pinned
           to its fastest backend; the bound is its five products over the
           pairs the mask lets through), K6 (ssm_scan at a
           falcon-mamba-7b admit's shape on random f32 inputs; and asked
           for its tile start states: y and h_last bit-equal to the call
           without, the states within 1e-5 of max |h| of the plain
           scan's) and K6b (ssm_scan_bwd, csrc/ssm_scan_bwd.cu, at
           falcon-mamba-7b's training shape, B 8, L 1024, Din 8192, N 16,
           x/B/C/D/dy in bf16, fed K6's tile start states, without and
           with h0 and dh_last: each gradient within 1e-2 of its max |ref|,
           two calls bit-equal; its bound from the bytes and the SFU's
           exponentials; the scan kernel's registers, spills and resident
           warps, the bytes of its dB / dC partials) at the main
           path's shapes, each held against its plain PyTorch version on
           the same inputs (K1/K2 exactly, also K2 at the fused round's 32
           keys; K3 within 1.6e-2 in bf16 and fp16 on the tensor-core route
           and 2e-5 in f32 on the SIMT one, each case's route checked
           against ``kernel.route``; K5 within 2e-2 in bf16, 2.5e-3 in fp16
           and 2e-5 in f32, K6 within 1e-4), with kernel, plain, library and
           bound times (K6 also with ``sfu_ms``, its exponentials at the
           SFU's 16 a clock per SM); K1, K2, K3, K5 and K7 are timed in 8
           rounds of turns with their library call (``in_turns``: medians, and the
           median and range of the rounds' ratios), K3's and K5's SDPA
           pinned to its fastest backend for those inputs (the least
           median of 5 readings in turns) and read unpinned beside it;
           K2's bound counts each touched row's live prefix (``k2_bound``);
  route    a 10^6-peer RingState: owners of both lookup paths against a
           numpy bisect, a delta bucket upload after one EDRA batch of
           64 events, no upload across 100 unchanged lookups;
  serve    qwen2.5-3b at full width (random weights from a seed): four
           Membership nodes, one Replica each (32 slots, 2048 positions,
           256-token prefill chunks), 32 routed requests of 128-1024
           prompt tokens, 32 fused route+decode rounds, then the same
           schedule unfused.  Fused and unfused tokens must be equal,
           every routed owner must be the router's, and the kernels'
           launch counters (zeroed just before) must show the path ran
           through K1, K2 and K3 (K3: 36 launches per replica round, all on
           the tensor-core route);
           then one Replica without prefill chunks admits 8 of the
           requests whole (K5: 36 launches an admit, all on the
           tensor-core route, finite logits) and
           decodes 8 rounds; its first tokens and last-position logits
           against the chunked path's are printed, not gated (the
           chunked path rounds p to bf16, K5 keeps it in f32);
  serve_cluster  qwen2.5-3b at full size through ``ServeCluster`` (the same
           weights; ``CLUSTER``): four Membership nodes and a §V-quarantined
           preemptible gateway, 32 slots x 2048 positions a replica,
           256-token chunks, duty beat 6, replication 2, fused rounds, the
           KV block store and the prefix cache on; 32 sessions of 128-1024
           prompt tokens, 8 of them opening with one 512-token system
           prompt, every other one submitted via the gateway, 32 new
           tokens each; 8 rounds, then the node with the most live
           sessions fails, then rounds to the end.  Gates: every session
           ends with 32 tokens and none is in flight, the gateway owns no
           replica and proxied 16; the failed node's sessions with an
           exported chunk are handed off from blocks (the rest are
           misses, re-prefilled), with handoff_chunks their covered
           chunks; each fetched block's bytes equal the donor's cache rows
           read before the failure, and the new slot's rows equal the
           blocks; prefix hits >= 7 x 2, the later system-prompt sessions'
           first tokens and rows [0, 512) equal to a fresh replica's
           without a prefix cache; owners on the key's replica set, the
           router's (K1, one launch a routed batch) its primary; K2 one
           launch a fused replica round plus the calibration's two, K3 36
           a fused replica round, all tensor-core; K1, K2 and K3 equal to
           their plain versions at the phase's shapes (K3 on the decode
           calls it recorded).  Printed: ms a cluster round, import us
           beside re-prefilling the same positions, the store's bytes,
           peak memory, and how many of the migrated sessions' tokens
           agree with an unfailed run of the same cluster;
  tp_cluster  qwen2.5-3b at full size through ``ServeCluster(tp=2)``
           (``TP_CLUSTER``): four groups of two shards carved from eight
           entries of ``cuda:0`` (one thread a shard, a psum at each
           row-parallel output), four nodes, 16 slots x 2048 positions,
           256-token chunks, 12 sessions of 256-1024 prompt tokens, 16 new
           tokens each; 4 rounds, then the first session's node fails
           (per-shard handoffs), one round, then one device of the oldest
           live group is lost (``lose_device``); then 4 whole-prompt admits
           on a live group.  The memory is reckoned and printed first; a
           tp = 1 run with the same membership events goes before and is
           freed.  Gates: no session lost, ``dead_groups`` 1, migrated >= 2,
           every migrated session handed off (no miss), each stored shard
           equal to the donor's kv-head slice, the reassembled slab to the
           donor group's full export and the new slot's rows to the
           shards; a shard's KV bytes half of tp = 1's; K3 one tensor-core
           launch a layer, shard and group round, K5 one a layer, shard and
           whole admit, K1 one a routed batch, K2 none (groups run no fused
           route); K3 and K5 at 8 / 1 heads within their bf16 bounds of the
           plain versions on the calls the run recorded; the first decode
           step's logits within ``TP_LOGIT_SHARE`` of max |logit| of tp =
           1's.  Printed: ms a cluster and a group round, peak memory, and
           the tokens equal to the tp = 1 run;
  tp_parity  the scenario of ``examples/tp_cluster.py`` (6 sessions of 40
           tokens, 8 new, a node failure and a device loss; the tp = 1 run
           fails the same two nodes) at full width and 4 layers in f32:
           the example's gates but token equality, and every stream equal
           to tp = 1's except where tp = 1's top-2 logit gap at the first
           divergent step is at most the max |dlogit| of tp = 1 and tp = 2
           there (recomputed teacher-forced);
  serve_dense  the rest of the dense family on the serve path
           (``DENSE_SERVE``): internlm2-20b at full size (48 layers, d 6144,
           48/8 heads, 19.86 B parameters; four Replicas of 16 slots x
           2048 positions, 16 requests, 16 rounds), nemotron-4-15b (relu2,
           two-matrix MLP, 256,000-token vocabulary) and command-r-35b at
           full width with depth cut to 8 layers (8 requests, 8 rounds).
           Counters zeroed before each model and read after it: owners
           against a numpy bisect, fused tokens equal to unfused, K2 one
           launch a fused replica round, K3 one a layer and replica round,
           all on the tensor cores (g = 6 and 8), a chunked prefill
           probe's first token the fused stream's, then 4 whole-prompt
           admits on K5 (one tensor-core launch a layer and admit); peak
           memory, decode ms per round and prefill tokens/s printed;
  serve_ssm  falcon-mamba-7b at full width and depth (64 layers, d 4096,
           d_inner 8192, state 16, random weights from the seed): K6 on
           layer 0's own scan inputs for a 1024-token prompt (h_last
           within 1e-4, bf16 y within 1e-2 of max |y|); two Membership
           nodes, one Replica each (16 slots), 16 routed whole-prompt
           admits of 128-1024 tokens, 16 lockstep rounds fused, then the
           same unfused.  Fused and unfused tokens equal, owners the
           router's, 64 K6 launches per admit, finite logits;
  serve_hybrid  zamba2-7b at full size (81 Mamba-2 layers, d 3584, 112 SSD
           heads of 64, state 64, one shared attention block at 14 sites,
           32 / 32 heads of hd 112; 6.75 B parameters) on the serve_dense
           path (``FAMILY_SERVE``): four Replicas of 16 slots x 2048
           positions, 16 whole-prompt admits of 128-1024 tokens, 16
           lockstep rounds fused, then unfused; the serve_dense gates, with
           K3 one tensor-core launch a shared site and replica round, K5
           one a shared site and admit (hd 112 on the tensor cores), and a
           whole prefill probe's first token the fused stream's;
  serve_moe  qwen3-moe-235b-a22b at full width (d 4096, 64 / 4 heads of
           hd 128, 128 experts top 8 of d_ff 1536, vocabulary 151,936),
           depth cut 94 -> 8 layers: the serve_dense path and gates
           (chunked admits, per-slot rounds, K3 at g 16), then 4
           whole-prompt admits with one tensor-core K5 launch a layer;
  churn    K4 (edra_tree) on one 2^21-pair batch at n ~ 10^6 in its three
           variants at the D1HT operating point of the cell, held
           against its plain version (integers exactly, and the acks
           bit-equal too: ``ack_not_bit_equal`` must read 0, and the
           acks stay within rtol 3e-5 / atol 1e-3), with kernel, plain
           and bound times; then the §VII
           churn cell, ``simulate_churn`` at n = 10^6, s_avg = 174 min,
           a 1800 s window after 300 s of warm-up, seed 1, for D1HT and
           1h-Calot: one-hop >= 0.99, equal events, Calot's bandwidth
           above D1HT's, each within [0.5, 2] of its analytical model,
           and ceil(pairs / 2^21) K4 launches per run;
  latency  the measured Figs 5-6 plane: the service profile, idle rows
           at n = 800..4000 with route times from K1/K2 on the card and
           f' from the churn plane (600 s windows), and a model row at
           10^6 on the churn cell's f'; the Fig-5 shape is checked as
           far as each row's measured regime allows;
  k7       K7 (ring_lookup, single-word) on the sorted uint32 high words of
           the route phase's 10^6 peer ids (duplicates kept) and 2^20 keys
           from a numpy seed: equal to its plain version and to numpy's
           searchsorted(..., "left") % N, exactly, on both routes (one
           level up to the crossover Q, the shared-memory sample tree
           above): each case on the wrapper's route (``kernel.k7_route``,
           whose counter must move) and on the other through its
           launcher; Q 2^20, 4096, the crossover and one past it, a
           table view 4 bytes off a 16-byte boundary; boundary keys (0,
           2^32 - 1, every entry and its neighbours) on that table and on
           tables of N = 1 and N = 7; an empty table raises
           LookupError; kernel, plain, torch.searchsorted (in turns) and
           bound times at Q 2^20 and at the quickstart's Q 4096;
  quickstart  ``repro_torch.quickstart``'s five steps on the card: step 5
           makes exactly one K7 launch (counter zeroed just before), and
           its indices equal the plain version's on the CPU;
  des_twin the churn plane's oracle at repro's twin configurations
           (tests/test_jax_sim.py): the message-level DES (``run_churn``,
           host) against ``simulate_churn`` on the card (K4) for D1HT at
           n = 1000 and 1h-Calot at n = 512: bandwidth ratio in [0.7, 1.4]
           / [0.6, 1.5], one-hop fractions within 0.006 / 0.008, both
           D1HT one-hop fractions >= 0.99;
  dht_cluster  ``repro_torch.dht_cluster`` (the twin of
           ``examples/dht_cluster.py``) with the ring's tables on the card:
           64 DES peers, an ElasticController (model axis 4), 32 blocks of
           256 B on 3 replicas, three adjacent crashes repaired between
           detections; gates: no block lost, torn or stale, every block on
           3 live replicas, the blocks' owners from one K1 lookup on the
           card equal to the host's.

  train    qwen2.5-3b at full size training (36 layers, bf16, remat
           full, random weights from the seed): B 8 x S 1024 of
           ``SyntheticLM``, one warm-up and 5 timed ``make_train_step``
           steps with AdamW on one repeated batch.  Gates: loss and grad
           norm finite and the last loss below the first; K5 72 launches a
           step (forward and remat recompute) and K5b 36 (one call a layer,
           each three kernel launches: D, dK/dV, dQ), all tensor-core, the
           counters zeroed before the first step; at full width and 2
           layers, one step's loss within 1e-2 relative and each leaf's
           gradient within 5e-2 of max |g| of the same step with
           ``FlashAttentionFn`` on the plain versions.  Printed: ms a step,
           tokens/s, the share of the bf16 dense peak that 6 N tokens a
           step reads, peak memory, and K5's and K5b's device ms a step
           (torch.profiler over one more step);
  train_mla deepseek-v2-236b at full width (d 5120, 128 heads, MLA q . k
           192 / v 128, 160 routed and 2 shared experts), depth cut 60 -> 1,
           bf16, remat full: ``Model.train_loss`` and its gradients on one
           batch of ``SyntheticLM``, B 1 x S 2048, one warm-up and 3 timed.
           Gates: the loss finite; K5 2 and K5b 1 launches a step, all
           tensor-core (K5b at (192, 128)); the loss within 1e-2 relative
           and each leaf's gradient within 5e-2 of max |g| of the same step
           with ``FlashAttentionFn`` on the plain versions.  Printed: ms a
           step, tokens/s, peak memory.  Then (``train_mla_step``) one
           ``make_train_step`` step with bf16 moments, AdamW updating the
           stacked experts in pieces: its ms, peak memory, launches (K5 2,
           K5b 1), the parameters finite;
  train_moe_ep qwen3-moe-235b-a22b at full width (d 4096, 64 / 4 heads,
           128 experts top-8, moe_d_ff 1536), depth cut 94 -> 2, bf16,
           bf16 moments, remat full, ``moe_impl="ep"`` under
           ``mesh_context(make_host_mesh(4, [cuda:0] * 4))`` (data 1,
           model 4): B 4 x S 1024 of ``SyntheticLM`` (T_loc 1024, c2 2560,
           c3 320).  Gates: (1) one layer's ``moe_block_ep`` within 2e-2 of
           max |ref| of ``moe_block`` on the same bf16 input at a capacity
           factor of E / k (neither drops a slot), ``moe_block``'s top-k
           replayed into the shards; (2) the EP step's loss and gradients
           against the same step with ``FlashAttentionFn`` on the plain
           versions, the router's choices replayed, under the train
           bounds; the timed steps: a warm-up and 3 EP steps, then as many
           without a mesh (the GSPMD block), each with K5 4 and K5b 2
           tensor-core launches a step, the EP losses falling; (3) one
           AdamW update in pieces of 2^16 values bit-equal to one on whole
           leaves.  Printed: losses, ms a step, tokens/s, peak memory, the
           slots each layer drops (EP: past c2 and past c3; GSPMD: past
           its cap), and one more profiled step of each (busy and idle
           share, K5's and K5b's ms, the top kernels);
  train_ssm, train_hybrid, train_encdec  the SSM, hybrid and
           encoder-decoder families training (``TRAIN_FAMILIES``, bf16,
           remat full, AdamW, one repeated batch, a warm-up and 3 timed
           steps): falcon-mamba-7b at full width, depth cut 64 -> 32, B 8
           x S 1024 (K6 64 and K6b 32 launches a step); zamba2-7b at full
           width, depth cut 81 -> 36, B 8 x S 1024 (K5 12 and K5b 6 a
           step, tensor cores at hd 112); whisper-small at full size, B 8
           x 1500 stub frames x 448 tokens (K5 72 and K5b 36 a step: the
           encoder's, the decoder's self and cross attention).  Gates: the
           losses finite and falling, the launches a step, and at full
           width and 2 layers one step's loss within 1e-2 relative and each
           leaf within 5e-2 of max |g| of the same step with
           ``FlashAttentionFn`` and ``SsmScanFn`` on the plain versions.
           Printed: ms a step, tokens/s, peak memory, the kernels' device
           ms a step;
  collectives the EDRA collectives over 8 entries of cuda:0: all-gather
           and broadcast (sources 0, 3, 7) equal to the plain results, the
           all-reduce within 1e-5 of the plain sum, eight batch shards'
           gradients synced by ``edra_allreduce`` / 8 within 1e-5 of the
           whole-batch gradient; an all-reduce of 2^24 f32 values a peer
           timed beside ``torch.stack(...).sum(0)``;
  train_lm the ``train_lm`` twin's lm-100m (12 x 768, 32k vocabulary)
           through ``Trainer``: B 8 x S 256, 60 steps, a checkpoint every
           20 into the gitignored ``build/``, a ``Membership`` peer failed
           during step 30.  Gates: the run restores step 20 and finishes at
           60, the restored params and moments equal what step 20 saved,
           bit for bit, the last logged loss below the first, K5 and K5b
           12 tensor-core launches a step run (70), and the checkpoint
           directory removed at the end;
  launch   the launch group (``launch/{presets,dryrun,hlo_cost}.py``), on
           the launch-shape defaults: (1) the dry run of every cell of
           ``all_cells()`` on both production meshes, and the skip
           records, in a child process that sees no card
           (``CUDA_VISIBLE_DEVICES`` empty; ``LAUNCH_JOBS`` workers trace
           the cells on ``meta``), a line a cell with its per-device peak,
           whether it fits in 80 GB, FLOPs, bytes, collective bytes and
           host seconds; gate: every cell ``ok``; (2) qwen2.5-3b at full
           size, a train step (the train phase's B 8 x S 1024), a
           whole-prompt prefill of 1024 tokens into a one-row cache of
           2048 and a decode step of 32 slots each at its own position
           in 2048, each counted by ``hlo_cost.CostCounter`` on the card
           and on ``meta``; gates: equal matmul FLOPs, HBM bytes and
           kernel charges, and the meta temporaries within 25% of the
           card's ``max_memory_allocated`` less what was allocated before
           the step (its arguments); printed: each step's device ms
           (CUDA events) beside its roofline ms, max(FLOPs / bf16 peak,
           bytes / HBM rate) from ``HARDWARE``, its mfu and its share of
           the roofline; (3) every K3/K5/K5b/K6/K6b case the kernels phase
           bounds, rebuilt on ``meta`` and run through its public wrapper:
           gate: the charge's bytes and operations equal to the bound's
           (K3's charge is the caches' whole capacity: held against the
           bound's work at every position);
  autotune the launch shapes searched on the card
           (``kernels/autotune.py``; the whole run points
           ``REPRO_TORCH_AUTOTUNE_CACHE`` at a fresh temporary file, so
           every phase above ran at the defaults): ``autotune_all`` over
           ``SWEEP_DIMS`` with a budget of ``AUTOTUNE_BUDGET_S``, K1's grid
           cap, K7's and K2's route switches, K4's grid waves and K3's
           chunk (tensor cores) and splits (SIMT); every candidate's
           output held against the plain version (K1, K2, K4, K7 exactly,
           K3 within 1.6e-2 in bf16 and 2e-5 in f32); a line a point with
           every candidate's device ms (``device_readings``: the calls
           queued behind a spin, so the host's launch cost is not
           timed) and their spread, the default's, the winner (the
           default unless beaten by more than its spread) and its ratio
           to the default, and nvidia-smi's name and power limit;
           ``tiles_for`` then returns the winners and ``status_label()``
           reads ``searched``; then qwen2.5-3b at full size, one replica of
           16 slots, 16 sessions admitted, its fused round (K2 on a
           10^6-peer directory, K3 at B 16) timed at the defaults and at
           the winners in turns from one saved state, the winners'
           resolutions all cache hits.  Gates: the round at the winners
           with K3 at its default launch shape gives the defaults' tokens,
           every one (it is the round at all the winners when K3's winner
           is its default); and at every K3 chunk candidate, the winner
           among them, the round's logits stay within ``K3_LOGIT_MOVE``
           of the defaults' (a chunk other than the default's merges the
           softmax partials in another order, which moves bf16 last bits
           and may flip a token whose top two logits are that close; the
           flips are printed, not gated).

Then the kernel summary line, and last ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is not 0.  Without a CUDA
card, or without the package beside it, it exits 1 and prints no result.
Imports nothing of jax or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # f32 outside the tensor cores
BF16_ATOL = 1.6e-2                 # 2 bf16 ulps at |out| < 2 (one rounding
                                   # each in kernel and plain version)
SEED = 0
N_PEERS = 1_000_000
CAPACITY = 1 << 20                 # device table of 10^6 peers
BUCKETS = 1 << 15                  # their directory under a 32 MiB budget
N_KEYS = 1 << 20
H, HKV, HD = 16, 2, 128            # qwen2.5-3b attention
ZAMBA2_HEADS = (32, 32, 112)       # zamba2-7b's shared block (g 1, hd 112)
QWEN3_MOE_HEADS = (64, 4, 128)     # qwen3-moe-235b-a22b (g 16)
WHISPER_HEADS = (12, 12, 64)       # whisper-small (g 1, hd 64)
INTERNVL_HEADS = (16, 8, 128)      # internvl2-2b (g 2, hd 128)
TP_HEADS = (8, 1, 128)             # qwen2.5-3b's heads on one shard of two
DEEPSEEK_HEADS = (128, 128, 192, 128)   # deepseek-v2's MLA prefill: q . k
                                        # over 128 nope + 64 rope, v 128
# (B, S, dtype, (H, Hkv, hd)): bf16 and fp16 on the tensor-core route, f32
# on the SIMT one; qwen2.5-3b's heads, then the decode bucket of 16 at the
# heads of the hybrid, MoE and VLM serve paths; whisper-small's cross and
# self attention (a step of B 8 over 1500 frames, and over its 448-token
# decoder cache) and internvl2-2b's 8 image rows (384 prompt positions and
# 32 steps in a cache of 416)
QWEN_HEADS = (H, HKV, HD)
K3_SHAPES = [(1, 2048, "bfloat16", QWEN_HEADS),
             (8, 2048, "bfloat16", QWEN_HEADS),
             (16, 2048, "bfloat16", QWEN_HEADS),
             (32, 2048, "bfloat16", QWEN_HEADS),
             (32, 2000, "bfloat16", QWEN_HEADS),
             (16, 2048, "float16", QWEN_HEADS),
             (16, 2048, "float32", QWEN_HEADS),
             (16, 2048, "bfloat16", ZAMBA2_HEADS),
             (16, 2048, "bfloat16", QWEN3_MOE_HEADS),
             (16, 2048, "bfloat16", INTERNVL_HEADS),
             (16, 2048, "bfloat16", TP_HEADS),
             (8, 1500, "bfloat16", WHISPER_HEADS),
             (8, 448, "bfloat16", WHISPER_HEADS),
             (8, 416, "bfloat16", INTERNVL_HEADS)]
# the rows whose lengths the main path fixes, drawn in [lo, hi] (the rest
# in [1, S]): whisper's cross attention (every row over all 1500 frames),
# its self attention (4 prompt tokens and 64 steps: lengths 5 to 68) and
# internvl2-2b's image rows (lengths 385 to 416)
K3_LENGTHS = {(8, 1500, "bfloat16", WHISPER_HEADS): (1500, 1500),
              (8, 448, "bfloat16", WHISPER_HEADS): (5, 68),
              (8, 416, "bfloat16", INTERNVL_HEADS): (385, 416)}
K3_MAIN = (16, 2048, "bfloat16", QWEN_HEADS)   # the largest decode bucket
K3_TOL = {"bfloat16": BF16_ATOL, "float16": BF16_ATOL, "float32": 2e-5}
K2_ROUND_KEYS = 32                 # the fused decode round's full house
# launch: qwen2.5-3b's three steps counted on the card and on meta at the
# serve phases' shapes (the train phase's are TRAIN_BATCH x TRAIN_SEQ): a
# whole-prompt admit of LAUNCH_PROMPT tokens into a one-row cache, and a
# fused round's decode step over LAUNCH_SLOTS slots, each at its own
# position, of LAUNCH_MAX_LEN; the meta temporaries within LAUNCH_TEMP_REL
# of the card's peak less the step's arguments; the dry run's cells traced
# by LAUNCH_JOBS worker processes
LAUNCH_PROMPT, LAUNCH_SLOTS, LAUNCH_MAX_LEN = 1024, 32, 2048
LAUNCH_TEMP_REL = 0.25
LAUNCH_JOBS = min(8, os.cpu_count() or 1)
AUTOTUNE_BUDGET_S = 90.0           # autotune_all's wall-time budget
AUTOTUNE_ROUND = 16                # the tuned round: 16 sessions, 16 slots
K3_LOGIT_MOVE = 0.25               # most a K3 chunk may move the round's logits
CHURN = dict(n=10**6, s_avg=174 * 60, duration=1800.0, warmup=300.0,
             seed=1)               # bench_maintenance.py --full, 10^6 row
K4_PAIRS = 1 << 21                 # pairs per launch of simulate_churn
K4_LEVELS = 20                     # ceil(log2(10^6))
K4_RTOL, K4_ATOL = 3e-5, 1e-3      # repro's kernel-vs-oracle ack tolerance
# operations K4 does, counted from csrc/edra_tree.cu with logf, sqrtf and
# the integer modulo as one each (so the bound is a lower one): per pair,
# per level (bit test and the Rule-8 count), and per hop of the chain by
# variant (unbuffered, buffered, early close)
K4_OPS_PAIR, K4_OPS_LEVEL, K4_OPS_HOP = 20, 9, (21, 42, 99)
LAT_SIZES = (800, 1600, 2400, 3200, 4000)    # Fig. 5's ring sizes
# K5 (flash attention): (B, Sq, Sk, causal, dtype) at qwen2.5-3b's heads;
# the first is the whole-prompt admit of a 1024-token prompt
K5_CASES = [(1, 1024, 1024, True, "bfloat16"), (1, 1000, 1000, True, "bfloat16"),
            (1, 512, 1024, False, "bfloat16"), (1, 1024, 1024, True, "float16"),
            (1, 1024, 1024, True, "float32")]
# then a 1024-token whole-prompt admit at zamba2-7b's shared block (the
# tensor-core route on zero-filled hd-128 tiles), at qwen3-moe's heads and
# at deepseek-v2's MLA (q . k 192, v 128; bf16, fp16 and f32); whisper-small's
# encoder (B 8, 1500 frames, no mask), its decoder's causal self attention
# over the 4 prompt tokens and its cross-attention prefill (4 prompt tokens
# over the 1500 frames); internvl2-2b's image prefill (B 8, 256 vision
# embeddings and 128 text tokens, causal)
K5_FAMILY_CASES = [((1, 1024, 1024, True, "bfloat16"), ZAMBA2_HEADS),
                   ((1, 1024, 1024, True, "float16"), ZAMBA2_HEADS),
                   ((1, 1024, 1024, True, "bfloat16"), QWEN3_MOE_HEADS),
                   ((1, 1024, 1024, True, "bfloat16"), DEEPSEEK_HEADS),
                   ((1, 1024, 1024, True, "float16"), DEEPSEEK_HEADS),
                   ((1, 1024, 1024, True, "float32"), DEEPSEEK_HEADS),
                   ((8, 1500, 1500, False, "bfloat16"), WHISPER_HEADS),
                   ((8, 4, 4, True, "bfloat16"), WHISPER_HEADS),
                   ((8, 4, 1500, False, "bfloat16"), WHISPER_HEADS),
                   ((8, 384, 384, True, "bfloat16"), INTERNVL_HEADS),
                   ((1, 1024, 1024, True, "bfloat16"), TP_HEADS)]
# repro's (tests/test_kernels.py) for bf16 and f32; fp16, whose mantissa
# is 3 bits finer, 2.5e-3 (H100 80GB HBM3, 700 W: 9.8e-4 at every fp16 case)
K5_TOL = {"bfloat16": 2e-2, "float16": 2.5e-3, "float32": 2e-5}
# K5b (the flash backward): (B, Sq, Sk, causal, dtype) at qwen2.5-3b's
# training shape in three types, at lm-100m's heads (the train_lm twin),
# at deepseek-v2's MLA (train_mla: one batch of 2048 tokens), at
# qwen3-moe's heads (train_moe_ep: B 4 x S 1024), at zamba2-7b's shared
# block (train_hybrid: hd 112 on the hd-128 tiles, bf16 and fp16) and at
# whisper-small's training shapes (train_encdec: the encoder, 1500 x 1500
# unmasked, whose last key tile has 28 rows; the decoder's causal self
# attention over 448 tokens; its cross attention, 448 over 1500
# unmasked); the tolerance is max |d| / max |ref| per gradient (P and dS
# enter the tensor cores' products rounded to the input type, FA2's
# recipe)
LM100M_HEADS = (12, 4, 64)
K5B_CASES = [((8, 1024, 1024, True, "bfloat16"), QWEN_HEADS),
             ((8, 1024, 1024, True, "float16"), QWEN_HEADS),
             ((8, 1024, 1024, True, "float32"), QWEN_HEADS),
             ((8, 256, 256, True, "bfloat16"), LM100M_HEADS),
             ((1, 2048, 2048, True, "bfloat16"), DEEPSEEK_HEADS),
             ((4, 1024, 1024, True, "bfloat16"), QWEN3_MOE_HEADS),
             ((8, 1024, 1024, True, "bfloat16"), ZAMBA2_HEADS),
             ((8, 1024, 1024, True, "float16"), ZAMBA2_HEADS),
             ((8, 1500, 1500, False, "bfloat16"), WHISPER_HEADS),
             ((8, 448, 448, True, "bfloat16"), WHISPER_HEADS),
             ((8, 448, 1500, False, "bfloat16"), WHISPER_HEADS)]
K5B_TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}
K5_LSE_ATOL = 1e-4                 # K5's logsumexp (f32) against the plain one
K5B_KERNELS = ("bwd_prep_kernel<", "bwd_dkdv_wgmma_kernel<", "bwd_dq_wgmma_kernel<",
               "bwd_delta_kernel<", "bwd_dkdv_simt_kernel<", "bwd_dq_simt_kernel<")
K6_KERNELS = ("ssm_scan_kernel<",)
K6B_KERNELS = ("ssm_scan_bwd_kernel<", "ssm_bwd_sum_kernel<")
# the tensor-core functions whose SASS must hold HGMMA: K5's forward and
# K5b's two products, each in bf16 and fp16 at three head-dim pairs
TC_FUNCTIONS = {"flash_tc_kernel": 6, "bwd_dkdv_wgmma_kernel": 6,
                "bwd_dq_wgmma_kernel": 6}
# train: qwen2.5-3b at full size, B 8 x S 1024 of SyntheticLM, one warm-up
# step and TRAIN_STEPS timed ones on one repeated batch; the gate at full
# width and TRAIN_GATE_LAYERS layers holds one step's loss and gradients
# with the kernels to those with FlashAttentionFn on the plain versions
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_GATE_LAYERS = 2
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_BOUND = 5e-2            # max |d| / max |plain| per leaf (bf16)
# train_ssm, train_hybrid, train_encdec: the SSM, hybrid and
# encoder-decoder families training on the card, each (arch, depth or None
# for the full model, batch, sequence, timed steps after one warm-up):
# falcon-mamba-7b at full width with depth cut 64 -> 32 (3.9 B parameters:
# 47 GB of bf16 weights and gradients and f32 moments); zamba2-7b at full
# width with depth cut 81 -> 36 (six shared-block sites; 3.2 B
# parameters, 38 GB); whisper-small at full size (0.24 B; B 8 x 1500
# stub frames, 448 decoder tokens)
TRAIN_FAMILIES = [("train_ssm", ("falcon-mamba-7b", 32, 8, 1024, 3)),
                  ("train_hybrid", ("zamba2-7b", 36, 8, 1024, 3)),
                  ("train_encdec", ("whisper-small", None, 8, 448, 3))]
# train_lm: the twin's lm-100m at B 8 x S 256 for 60 steps, a checkpoint
# every 20, a peer failed during step 30 (the run restores step 20)
TRAIN_LM = dict(batch=8, seq=256, steps=60, save_every=20, fail_at=30)
# train_mla: deepseek-v2-236b at full width, depth cut 60 -> 1 (the layer
# holds 3.97 B parameters, ~5.0 B with the embedding and head: 10 GB of bf16
# weights and 10 GB of gradients), one batch of B 1 x S 2048, a warm-up and
# ``steps`` timed forward + backward passes, then one ``make_train_step``
# step with bf16 moments (20 GB): AdamW updates the routed experts' stacked
# leaf (3.77 B values) in pieces of 2^26, where a whole-leaf update would
# make f32 temporaries of ~15.9 GB each
TRAIN_MLA = dict(arch="deepseek-v2-236b", layers=1, batch=1, seq=2048, steps=3)
# train_moe_ep: qwen3-moe-235b-a22b at full width, depth cut 94 -> 2 (two
# layers and the embedding and head hold 6.22 B parameters: bf16 weights,
# gradients and bf16 moments take 49.8 GB of the 80 GB card, the step's
# activations and AdamW's pieces a few GB more), B 4 x S 1024 of SyntheticLM on
# the mesh (data 1, model 4) of four cuda:0 entries: T_loc 1024, c2 2560,
# c3 320 at cf 1.25; a warm-up and ``steps`` timed EP steps, then as many
# without a mesh (the GSPMD block), on one repeated batch
TRAIN_MOE_EP = dict(arch="qwen3-moe-235b-a22b", layers=2, batch=4, seq=1024,
                    model_axis=4, steps=3)
EP_EXCHANGE_BOUND = 2e-2           # EP vs moe_block, of max |ref| (bf16)
# collectives: the EDRA tree over eight entries of cuda:0 (3 rounds), and
# one all-reduce of a gradient of COLLECTIVE_VALUES f32 values a peer timed
COLLECTIVE_PEERS = 8
COLLECTIVE_VALUES = 1 << 24
K6_SHAPE = (1, 1024, 8192, 16)     # (Bb, L, Din, N): one falcon-mamba-7b admit
K6_ATOL = 1e-4                     # repro's f32 tolerance (test_kernels.py)
K6_Y_REL = 1e-2                    # bf16 y: of max |y|
K6_STATES_REL = 1e-5               # K6's tile start states: of max |h|
# K6's and K6b's operation counts (K6_OPS_*, K6B_OPS_*) are in
# kernels/ssm_scan/ops.py, beside ssm_scan_work and ssm_scan_bwd_work
# K6b (the scan's backward) at falcon-mamba-7b's training shape (train_ssm:
# B 8 x S 1024), x, B, C, D and dy in bf16, dt and A in f32, without and
# with h0 and dh_last; each gradient within its K6B_REL of its max |ref|:
# 1e-2 for dx, dB, dC and dD, rounded once to bf16; K6's f32 1e-4 for the
# f32 ddt, dA and dh0 (the f32 sums in another order and the SFU's
# exponentials)
K6B_SHAPE = (8, 1024, 8192, 16)
K6B_REL = {"dx": 1e-2, "dB": 1e-2, "dC": 1e-2, "dD": 1e-2,
           "ddt": 1e-4, "dA": 1e-4, "dh0": 1e-4}
SFU_PER_CLOCK = 16                 # exponentials a clock on each SM (Hopper)
SSM_PROMPTS = (128, 256, 512, 1024)   # whole multiples of ssm_chunk 256
K7_KEYS = 1 << 20
# the rest of the dense family (arch, depth or None for the full model,
# slots a replica, requests, rounds fused and unfused, whole-prompt admits):
# internlm2-20b at full size (37.0 GiB of bf16 weights, 24 GiB of KV for
# 4 x 16 x 2048 positions); nemotron-4-15b and command-r-35b at full width,
# depth cut to 8 layers (full depth: 29.1 and 60.3 GiB of weights)
DENSE_SERVE = [("internlm2-20b", None, 16, 16, 16, 4),
               ("nemotron-4-15b", 8, 16, 8, 8, 4),
               ("command-r-35b", 8, 16, 8, 8, 4)]
# the hybrid and MoE families, one phase each (the same row layout):
# zamba2-7b at full size (81 Mamba-2 layers and 14 shared-block sites,
# 13.5 GB of bf16 weights, 9.0 GB of cache a replica: whole-prompt admits,
# lockstep rounds); qwen3-moe-235b-a22b at full width with depth cut 94 ->
# 8 layers (its experts take 4.83 GB a layer, ~450 GB at full depth):
# chunked admits, per-slot rounds, and 4 whole-prompt admits on K5 at g 16;
# deepseek-v2-236b at full width with depth cut 60 -> 6 layers (each layer's
# 160 routed experts are 3.78 B parameters, 7.55 GB: 6 layers are 24.88 B
# parameters, 46.3 GiB, where 60 would be 446 GiB): whole-prompt admits on
# K5 at q . k 192 / v 128, per-slot absorbed decode with no kernel;
# internvl2-2b at full size (1.89 B parameters): chunked text admits (its
# ``prefill`` takes image embeddings, so a text prompt is never admitted
# whole, as in repro), then 8 image prefills on K5 (``VLM_IMAGE``)
FAMILY_SERVE = [("serve_hybrid", ("zamba2-7b", None, 16, 16, 16, 0)),
                ("serve_moe", ("qwen3-moe-235b-a22b", 8, 16, 16, 16, 4)),
                ("serve_mla", ("deepseek-v2-236b", 6, 16, 16, 16, 0)),
                ("serve_vlm", ("internvl2-2b", None, 16, 16, 16, 0))]
# the VLM's image prefills: B, prompt tokens after the 256 stub vision
# embeddings, per-slot decode steps
VLM_IMAGE = (8, 128, 32)
# the serve cluster (qwen2.5-3b at full size): slots and positions a
# replica, prefill chunk and duty beat, sessions, of them how many open with
# the shared system prompt of system_len tokens, the prompt lengths and
# the system-prompt sessions' own tokens (ranges), new tokens a session,
# rounds before the node failure
CLUSTER = dict(slots=32, max_len=2048, chunk=256, duty=6, sessions=32,
               system=8, system_len=512, prompt=(128, 1024), own=(64, 512),
               max_new=32, rounds=8)
# the tensor-parallel cluster (qwen2.5-3b at full size, bf16, 4 groups of
# tp = 2 on the one card, 4 nodes): slots and positions a replica, prefill
# chunk, sessions, prompt lengths, new tokens a session, rounds before the
# node failure, whole-prompt admits on a group (K5 at the shard's heads)
TP_CLUSTER = dict(slots=16, max_len=2048, chunk=256, sessions=12,
                  prompt=(256, 1024), max_new=16, rounds=4, whole=4)
# the first decode step's max |logit(tp=2) - logit(tp=1)| in bf16, as a
# share of max |logit(tp=1)|: twice the largest share the serve phase's
# bf16 whole-prompt and chunked logits differ by (0.23 of 4.53 on an H100
# 80GB HBM3 at 700 W, its ``last_logits_max_abs_diff_vs_chunked``)
TP_LOGIT_SHARE = 0.1
TP_PARITY_LAYERS = 4               # the f32 parity leg: full width, 4 layers
# whisper-small at full size: B streams of 1500 stub frames, prompt tokens,
# max_len (whisper's decoder context), lockstep greedy steps
ENCDEC = (8, 4, 448, 64)
# repro's DES <-> vectorized twin tests (tests/test_jax_sim.py): config,
# bandwidth-ratio band, largest one-hop gap
DES_TWIN = {
    "d1ht": (dict(n=1000, s_avg=174 * 60, duration=600, warmup=120, seed=11),
             (0.7, 1.4), 0.006),
    "calot": (dict(n=512, s_avg=174 * 60, duration=600, warmup=120, seed=13,
                   protocol="calot"), (0.6, 1.5), 0.008),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after a warm-up)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def in_turns(kernel, library, rounds: int = 8, iters: int = 30) -> dict:
    """A kernel and the library call that computes the same function,
    timed in turns on one card: kernel, library, library, kernel, and so
    on (``rounds`` pairs), each turn the CUDA-event mean of ``iters``
    calls, after a warm-up of both.  Returns the medians over the turns
    (``ms``, ``library_ms``), the median of the rounds' ratios (kernel
    over library within a round: the rank of ROADMAP's queue) with their
    min and max, and every turn's reading."""
    for i in range(3):
        kernel(i)
        library(i)
    turns = {"kernel": [], "library": []}
    for r in range(rounds):
        for who in (("kernel", "library") if r % 2 == 0
                    else ("library", "kernel")):
            turns[who].append(cuda_ms(kernel if who == "kernel" else library,
                                      iters=iters, warmup=0))
    ratios = [k / lib for k, lib in zip(turns["kernel"], turns["library"])]
    return {"ms": float(np.median(turns["kernel"])),
            "library_ms": float(np.median(turns["library"])),
            "kernel_over_library": float(np.median(ratios)),
            "ratio_min_max": [min(ratios), max(ratios)],
            "turns_ms": turns}


def fastest_sdpa(call, rounds: int = 5, iters: int = 10):
    """The SDPA backend to pin for ``call`` (a function of no arguments).
    Each backend of ``torch.nn.attention.sdpa_kernel`` is tried once
    outside any timing; those that accept the call are then read in turns
    (``rounds`` rounds, the order reversed every other round, each reading
    the CUDA-event mean of ``iters`` calls), and the one with the least
    median is returned with every backend's median (None: refused)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backends = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH)
    usable = []
    for backend in backends:
        try:
            with sdpa_kernel(backend):
                call()
            usable.append(backend)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    readings = {b: [] for b in usable}
    for r in range(rounds):
        for backend in (usable if r % 2 == 0 else usable[::-1]):
            with sdpa_kernel(backend):
                readings[backend].append(cuda_ms(lambda i: call(),
                                                 iters=iters))
    medians = {b: float(np.median(t)) for b, t in readings.items()}
    best = min(medians, key=medians.get)
    return best, {b.name: medians.get(b) for b in backends}


def sdpa_in_turns(kernel, sdpa_call) -> dict:
    """``in_turns`` against SDPA pinned to its fastest backend for these
    inputs (the row names it), and beside it against SDPA left to choose
    its own backend (``default_sdpa``)."""
    from torch.nn.attention import sdpa_kernel
    best, tried = fastest_sdpa(lambda: sdpa_call(0))
    with sdpa_kernel(best):
        row = in_turns(kernel, sdpa_call)
    default = in_turns(kernel, sdpa_call)
    return {**row, "library_call": f"SDPA ({best.name})",
            "sdpa_backends_ms": tried,
            "default_sdpa": {key: default[key] for key in (
                "ms", "library_ms", "kernel_over_library", "ratio_min_max")}}


def sdpa_backward_in_turns(kernel, q, k, v, do, causal: bool = True) -> dict:
    """``in_turns`` of a flash backward against SDPA's backward on the same
    (B, S, heads, hd) inputs (``causal`` or unmasked, ``enable_gqa``),
    pinned to its
    fastest backend: each backend's forward runs once outside any timing,
    a library call is one ``autograd.grad`` through that graph, and the
    backends are read in turns (5 rounds, the CUDA-event mean of 10 calls)
    before the pinned one goes in turns with the kernel."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    graphs = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        try:
            with sdpa_kernel(backend):
                out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
            torch.autograd.grad(out, leaves, dot, retain_graph=True)
        except RuntimeError:
            continue
        graphs[backend] = (out, leaves)
    torch.cuda.synchronize()

    def backward(backend):
        out, leaves = graphs[backend]
        return lambda i: torch.autograd.grad(out, leaves, dot,
                                             retain_graph=True)
    readings = {b: [] for b in graphs}
    for r in range(5):
        for b in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            readings[b].append(cuda_ms(backward(b), iters=10))
    medians = {b: float(np.median(t)) for b, t in readings.items()}
    best = min(medians, key=medians.get)
    row = in_turns(kernel, backward(best))
    return {**row, "library_call": f"SDPA backward ({best.name})",
            "sdpa_backends_ms": {b.name: m for b, m in medians.items()}}


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def sass_hgmma(lib_path):
    """HGMMA instructions in each tensor-core function of ``TC_FUNCTIONS``
    (K5's forward, K5b's dK/dV and dQ kernels) in the built library's SASS
    (``cuobjdump -sass``, the toolkit's or the copy in Triton's package),
    by kernel, dtype and head dims, and the first one's text; ``None``
    where neither tool exists."""
    import re
    import subprocess
    from repro_torch.kernels import build
    tools = [Path(build._nvcc()).parent / "cuobjdump"]
    try:
        import triton
        tools.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((t for t in tools if t.exists()), None)
    if tool is None:
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn, first = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in TC_FUNCTIONS if k in name), None)
            fn = None
            if kernel:
                fn = "/".join((kernel, "bf16" if "bfloat16" in name else "fp16",
                               "x".join(re.findall(r"Li(\d+)E", name))))
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
            first = first or " ".join(line.split())
    return {"hgmma_per_function": counts, "first_hgmma": first}


def v_heads(heads):
    """(H, Hkv, hd) or (H, Hkv, q . k hd, v hd) -> (H, Hkv, hd, v hd)."""
    return tuple(heads) if len(heads) > 3 else tuple(heads) + heads[2:3]


def bound(nbytes: float, nops: float, peak: float):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, nops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def work_bound(work):
    """The bound of a kernel's ``*_work`` count (its ``ops.py``): bytes
    over the memory rate, matmul FLOPs and other operations over the peak
    of the work's type (bf16 and fp16 on the tensor cores, f32 outside
    them)."""
    return bound(work["bytes"], work["matmul_flops"] + work["ops"],
                 FP32_FLOPS if work["type"] == "float32" else BF16_FLOPS)


def k2_bound(keys, occ):
    """K2's bound for uint64 ``keys`` on a directory with row occupancies
    ``occ``: each key's two words in and two words out (16 B), and each
    touched row's occ once (4 B) and the slots the answer depends on once
    (count <= occ[b] and the owner is row[count]: slots 0..occ[b] of the
    hi and of the lo row, each rounded up to 32-byte sectors); operations,
    a lower bound over those occ[b] + 1 slots per key, 3 a probe."""
    bits = occ.size.bit_length() - 1
    b = (keys >> np.uint64(64 - bits)).astype(np.int64) if bits \
        else np.zeros(keys.size, np.int64)
    rows = np.unique(b)
    slots = np.minimum(occ[rows].astype(np.int64) + 1, 128)
    sectors = -(-slots * 4 // 32)
    nbytes = keys.size * 16 + rows.size * 4 + 2 * 32 * int(sectors.sum())
    probes = np.ceil(np.log2(np.minimum(occ[b].astype(np.int64) + 1, 128)))
    return bound(nbytes, 3 * float((probes + 1).sum()), FP32_FLOPS)


def k7_bound(keys, table):
    """K7's bound for uint32 ``keys`` on the sorted ``table``: each key in
    and its index out (8 B), and the words the answer depends on once
    (the count c needs table[c - 1] < key <= table[c]: the 32-byte sectors
    holding those words, distinct over the keys, at most the whole table);
    operations, a lower bound's probes over the N words, 3 a probe."""
    n = table.size
    c = np.searchsorted(table, keys, side="left").astype(np.int64)
    words = np.concatenate([c - 1, c])
    sectors = np.unique(words[(words >= 0) & (words < n)] // 8).size
    return bound(keys.size * 8 + min(n * 4, sectors * 32),
                 keys.size * (math.ceil(math.log2(n)) + 1) * 3, FP32_FLOPS)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.edra import Event
    from repro_torch.core.ringstate import RingState
    from repro_torch.kernels import backend, build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref)
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ring_lookup.ref import (ring_lookup64_ref,
                                                     ring_lookup_bucketed_ref,
                                                     sortable_ids)
    from repro_torch.models import Model
    from repro_torch.runtime import Membership
    from repro_torch.serve import Replica, Request, SessionRouter

    dev = _device()
    torch.cuda.set_device(dev)
    backend.strict_fp32()              # TF32 off: f32 products stay f32
    name = torch.cuda.get_device_name(0)

    # -- device --------------------------------------------------------------
    prov = backend.provenance(dev)
    if not prov["nvidia_smi"]:
        raise RuntimeError("nvidia-smi gave no name/power limit")
    print(prov["nvidia_smi"], flush=True)
    build.library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    sass = sass_hgmma(build.library_path)
    emit({"phase": "device", **prov, "build_seconds": build.build_seconds,
          "ptxas": ptxas, "sass": sass})
    counts = sass and sass["hgmma_per_function"]
    if sass is not None and (
            not all(counts.values()) or
            {k: sum(f.startswith(k + "/") for f in counts)
             for k in TC_FUNCTIONS} != TC_FUNCTIONS):
        raise AssertionError(f"a tensor-core K5 or K5b function without "
                             f"HGMMA: {sass}")

    # -- kernels -------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    ids = np.unique(rng.integers(0, 2**64, size=N_PEERS + 4096,
                                 dtype=np.uint64))
    ids = ids[rng.permutation(ids.size)[:N_PEERS]]
    state = RingState(ids, device=dev)
    act = state.active_ids()
    one = np.uint64(1)
    special = np.concatenate([act[:50_000], act[::20] + one,
                              np.array([act[-1] + one, 2**64 - 1, 0],
                                       np.uint64)])
    keys = np.concatenate([special, rng.integers(
        0, 2**64, size=N_KEYS - special.size, dtype=np.uint64)])
    want_owner = act[np.searchsorted(act, keys) % act.size]
    w = np.uint64(32)
    khi = torch.from_numpy((keys >> w).astype(np.uint32).view(np.int32)).to(dev)
    klo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)).to(dev)
    results = {}

    thi, tlo, n_live = state.device_table()
    if thi.numel() != CAPACITY:
        raise AssertionError(f"device table capacity {thi.numel()}")
    got1 = rl_ops.ring_lookup64(khi, klo, thi, tlo, n_live)
    torch.cuda.synchronize()
    plain1 = ring_lookup64_ref(khi, klo, thi, tlo, n_live)
    err1 = int((got1.long() - plain1.long()).abs().max())
    if err1 or not np.array_equal(act[got1.cpu().numpy()], want_owner):
        raise AssertionError("K1 disagrees with its plain version / bisect")
    table64 = sortable_ids(thi[:N_PEERS], tlo[:N_PEERS])
    keys64 = sortable_ids(khi, klo)
    b1, by1 = bound(N_KEYS * 12 + N_PEERS * 8 + 4,
                    N_KEYS * (math.ceil(math.log2(N_PEERS)) + 1) * 3, FP32_FLOPS)
    results["K1"] = {
        "name": "ring_lookup64", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_lookup.cu",
        "replaces": "src/repro/kernels/ring_lookup/kernel.py:123",
        "shape": f"Q={N_KEYS}, n={N_PEERS}, capacity={thi.numel()}",
        "max_abs_err": err1, "tolerance": 0,
        **in_turns(lambda i: rl_ops.ring_lookup64(khi, klo, thi, tlo, n_live),
                   lambda i: torch.searchsorted(table64, keys64)),
        "plain_ms": cuda_ms(lambda i: ring_lookup64_ref(khi, klo, thi, tlo,
                                                        n_live)),
        "bound_ms": b1, "bound_by": by1}

    table = state.device_bucket_table()
    stats = state.bucket_stats()
    if not stats["valid"] or stats["buckets"] != BUCKETS:
        raise AssertionError(f"10^6 peers left the bucketed path: {stats}")
    got2 = rl_ops.ring_lookup_bucketed(khi, klo, *table)
    torch.cuda.synchronize()
    plain2 = ring_lookup_bucketed_ref(khi, klo, *table)
    err2 = max(int((got2[i].long() - plain2[i].long()).abs().max())
               for i in range(2))
    words = torch.stack(got2).cpu().numpy().view(np.uint32).astype(np.uint64)
    if err2 or not np.array_equal((words[0] << w) | words[1], want_owner):
        raise AssertionError("K2 disagrees with its plain version / bisect")
    occ = table[2].cpu().numpy()
    rows = np.unique(keys >> np.uint64(64 - BUCKETS.bit_length() + 1)).size
    b2, by2 = k2_bound(keys, occ)
    act64 = sortable_ids(*(torch.from_numpy(
        a.astype(np.uint32).view(np.int32)).to(dev)
        for a in (act >> w, act & np.uint64(0xFFFFFFFF))))
    act_hi, act_lo = thi[:N_PEERS], tlo[:N_PEERS]

    def library2(i):
        at = torch.searchsorted(act64, keys64) % N_PEERS
        return act_hi[at], act_lo[at]

    # the fused round's shape: 32 keys (the first of them ids, the rest
    # random), exactly as at 2^20
    rk = slice(N_KEYS - K2_ROUND_KEYS // 2 - 16, N_KEYS - 16)
    khi32 = torch.cat([khi[:K2_ROUND_KEYS // 2], khi[rk]])
    klo32 = torch.cat([klo[:K2_ROUND_KEYS // 2], klo[rk]])
    keys32 = torch.cat([keys64[:K2_ROUND_KEYS // 2], keys64[rk]])
    got32 = rl_ops.ring_lookup_bucketed(khi32, klo32, *table)
    plain32 = ring_lookup_bucketed_ref(khi32, klo32, *table)
    want32 = np.concatenate([want_owner[:K2_ROUND_KEYS // 2],
                             want_owner[rk]])
    words32 = torch.stack(got32).cpu().numpy().view(np.uint32).astype(
        np.uint64)
    if not all(torch.equal(g, p) for g, p in zip(got32, plain32)) \
            or not np.array_equal((words32[0] << w) | words32[1], want32):
        raise AssertionError("K2 at Q=32 disagrees with its plain version / "
                             "bisect")

    def library32(i):
        at = torch.searchsorted(act64, keys32) % N_PEERS
        return act_hi[at], act_lo[at]
    b32, by32 = k2_bound(np.concatenate([keys[:K2_ROUND_KEYS // 2],
                                         keys[rk]]), occ)
    results["K2"] = {
        "name": "ring_lookup_bucketed", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_lookup.cu",
        "replaces": "src/repro/kernels/ring_lookup/kernel.py:217",
        "shape": f"Q={N_KEYS}, buckets={stats['buckets']}x128, "
                 f"rows touched={rows}",
        "max_abs_err": err2, "tolerance": 0,
        **in_turns(lambda i: rl_ops.ring_lookup_bucketed(khi, klo, *table),
                   library2),
        "plain_ms": cuda_ms(lambda i: ring_lookup_bucketed_ref(khi, klo,
                                                               *table)),
        "bound_ms": b2, "bound_by": by2,
        "q32": {"shape": f"Q={K2_ROUND_KEYS} (the fused round's full house)",
                "max_abs_err": 0,
                **in_turns(lambda i: rl_ops.ring_lookup_bucketed(
                    khi32, klo32, *table), library32),
                "plain_ms": cuda_ms(lambda i: ring_lookup_bucketed_ref(
                    khi32, klo32, *table)),
                "bound_ms": b32, "bound_by": by32}}

    k3_rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b, s, dtype_name, (h3, hkv3, hd3) in K3_SHAPES:
        dtype = getattr(torch, dtype_name)
        size = torch.finfo(dtype).bits // 8
        per = 2 * b * s * hkv3 * hd3 * size       # K and V bytes
        copies = max(1, math.ceil(128e6 / per))   # cycle past the 50 MB L2
        q = torch.randn((copies, b, h3, hd3), generator=gen, device=dev,
                        dtype=dtype)
        k = torch.randn((copies, b, s, hkv3, hd3), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((copies, b, s, hkv3, hd3), generator=gen, device=dev,
                        dtype=dtype)
        lo, hi = K3_LENGTHS.get((b, s, dtype_name, (h3, hkv3, hd3)), (1, s))
        length = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        fn3 = da_ops.decode_attention
        tc_before = fn3.tc_launches
        got3 = fn3(q[0], k[0], v[0], length)
        torch.cuda.synchronize()
        route3 = "tc" if fn3.tc_launches > tc_before else "simt"
        want3 = "simt" if dtype == torch.float32 else "tc"
        if route3 != want3 or route3 != da_kernel.route(dtype, hd3, h3 // hkv3):
            raise AssertionError(f"K3 {dtype_name} at {h3}/{hkv3} heads, hd "
                                 f"{hd3} took the {route3} route")
        plain3 = decode_attention_ref(q[0], k[0], v[0], length)
        err3 = float((got3.float() - plain3.float()).abs().max())
        if not err3 <= K3_TOL[dtype_name]:
            raise AssertionError(f"K3 at B={b}, S={s}, {h3}/{hkv3} heads, hd "
                                 f"{hd3}, {dtype_name}: max err {err3}")
        # the yardstick: SDPA with GQA and a length mask, on (B,Hkv,S,hd)
        # copies of the cache made outside the timed calls
        kt, vt = k.transpose(2, 3).contiguous(), v.transpose(2, 3).contiguous()
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None])[
            :, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        valid = int(length.sum())
        # K/V of the valid positions read once, q, the lengths and the
        # output once; q . k and p . v over those positions
        w3 = dict(da_ops.decode_attention_work(q[0], k[0], v[0], length,
                                               positions=valid),
                  positions=valid)
        bb, by3 = work_bound(w3)
        k3_rows.append({
            "B": b, "S": s, "H": h3, "Hkv": hkv3, "hd": hd3,
            "dtype": dtype_name, "kernel_route": route3,
            "max_abs_err": err3, "tolerance": K3_TOL[dtype_name],
            **sdpa_in_turns(lambda i: fn3(q[i % copies], k[i % copies],
                                          v[i % copies], length),
                            lambda i: sdpa(q[i % copies][:, :, None],
                                           kt[i % copies], vt[i % copies],
                                           attn_mask=mask, enable_gqa=True)),
            "plain_ms": cuda_ms(lambda i: decode_attention_ref(
                q[i % copies], k[i % copies], v[i % copies], length)),
            "bound_ms": bb, "bound_by": by3, "work": w3})
        del q, k, v, kt, vt
    torch.cuda.empty_cache()
    summary = ("kernel_route", "max_abs_err", "tolerance", "ms", "plain_ms",
               "library_ms", "library_call", "kernel_over_library",
               "ratio_min_max", "bound_ms", "bound_by")

    def k3_row(b, s, dtype_name, heads):
        return next(r for r in k3_rows
                    if (r["B"], r["S"], r["dtype"], (r["H"], r["Hkv"], r["hd"]))
                    == (b, s, dtype_name, heads))

    def heads_text(heads):
        dv = f", dv={heads[3]}" if len(heads) > 3 else ""
        return f"H={heads[0]}, Hkv={heads[1]}, hd={heads[2]}{dv}"

    main3 = k3_row(*K3_MAIN)
    results["K3"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_tc.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
        "shape": f"B={K3_MAIN[0]}, {heads_text(QWEN_HEADS)}, S={K3_MAIN[1]}, "
                 "bf16, lengths in [1, S]",
        **{key: main3[key] for key in summary}}
    for key, heads, model_name in (("hd112", ZAMBA2_HEADS, "zamba2-7b"),
                                   ("g16", QWEN3_MOE_HEADS, "qwen3-moe"),
                                   ("g2", INTERNVL_HEADS, "internvl2-2b"),
                                   ("tp_g8", TP_HEADS,
                                    "qwen2.5-3b, one shard of tp = 2")):
        row = k3_row(16, 2048, "bfloat16", heads)
        results["K3"][key] = {
            "shape": f"B=16, {heads_text(heads)}, S=2048, bf16, lengths in "
                     f"[1, S] ({model_name} decode bucket of 16)",
            **{k: row[k] for k in summary}}
    for key, b, s, heads, site in (
            ("whisper_cross", 8, 1500, WHISPER_HEADS,
             "whisper-small's cross attention, a step"),
            ("whisper_self", 8, 448, WHISPER_HEADS,
             "whisper-small's decoder self attention, a step"),
            ("internvl_image", 8, 416, INTERNVL_HEADS,
             "internvl2-2b's image rows, a step")):
        row = k3_row(b, s, "bfloat16", heads)
        lo, hi = K3_LENGTHS[(b, s, "bfloat16", heads)]
        results["K3"][key] = {
            "shape": f"B={b}, {heads_text(heads)}, S={s}, bf16, lengths in "
                     f"[{lo}, {hi}] ({site})",
            **{k: row[k] for k in summary}}
    k5_rows = []
    for (b, sq, sk, causal, dtype_name), heads in \
            [(c, QWEN_HEADS) for c in K5_CASES] + K5_FAMILY_CASES:
        h5, hkv5, hd5, dv5 = v_heads(heads)
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, sq, h5, hd5), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, hkv5, hd5), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, hkv5, dv5), generator=gen, device=dev).to(dtype)
        tc_before = fa_ops.flash_attention.tc_launches
        got5 = fa_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route5 = "tc" if fa_ops.flash_attention.tc_launches > tc_before \
            else "simt"
        want5 = "simt" if dtype == torch.float32 else "tc"
        if route5 != want5 or route5 != fa_kernel.route(dtype, hd5, dv5):
            raise AssertionError(f"K5 {dtype_name} at {h5}/{hkv5} heads, hd "
                                 f"{hd5} / {dv5} took the {route5} route")
        plain5 = flash_attention_ref(q, k, v, causal=causal)
        err5 = float((got5.float() - plain5.float()).abs().max())
        if not err5 <= K5_TOL[dtype_name]:
            raise AssertionError(f"K5 at {(b, sq, sk, causal, dtype_name)}, "
                                 f"{h5}/{hkv5} heads, hd {hd5} / {dv5}: max "
                                 f"err {err5}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # q, k and v read once and the output written once; q . k and p . v
        # over the pairs the mask lets through
        w5 = fa_ops.flash_attention_work(q, k, v, causal=causal)
        b5, by5 = work_bound(w5)
        k5_rows.append({
            "B": b, "Sq": sq, "Sk": sk, "H": h5, "Hkv": hkv5, "hd": hd5,
            "dv": dv5, "causal": causal, "dtype": dtype_name, "kernel_route": route5,
            "max_abs_err": err5, "tolerance": K5_TOL[dtype_name],
            **sdpa_in_turns(lambda i: fa_ops.flash_attention(q, k, v,
                                                             causal=causal),
                            lambda i: sdpa(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)),
            "plain_ms": cuda_ms(lambda i: flash_attention_ref(
                q, k, v, causal=causal)),
            "bound_ms": b5, "bound_by": by5, "work": w5})
        del q, k, v, qt, kt, vt, got5, plain5
    main5 = k5_rows[0]
    results["K5"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "shape": f"B=1, S={main5['Sq']}, {heads_text(QWEN_HEADS)}, bf16, "
                 "causal (qwen2.5-3b whole-prompt admit)",
        **{key: main5[key] for key in summary}}
    for key, heads, sq, sk, site in (
            ("hd112", ZAMBA2_HEADS, 1024, 1024,
             "zamba2-7b whole-prompt admit, a shared site"),
            ("g16", QWEN3_MOE_HEADS, 1024, 1024,
             "qwen3-moe whole-prompt admit, a layer"),
            ("mla", DEEPSEEK_HEADS, 1024, 1024,
             "deepseek-v2 whole-prompt admit, a layer"),
            ("whisper_encoder", WHISPER_HEADS, 1500, 1500,
             "whisper-small encoder, a layer"),
            ("whisper_self_prefill", WHISPER_HEADS, 4, 4,
             "whisper-small decoder self attention of a 4-token prefill"),
            ("whisper_cross_prefill", WHISPER_HEADS, 4, 1500,
             "whisper-small cross attention of a 4-token prefill"),
            ("internvl_image_prefill", INTERNVL_HEADS, 384, 384,
             "internvl2-2b image prefill, a layer"),
            ("tp_g8", TP_HEADS, 1024, 1024,
             "qwen2.5-3b whole-prompt admit on one shard of tp = 2")):
        row = next(r for r in k5_rows
                   if (r["H"], r["Hkv"], r["hd"], r["dv"]) == v_heads(heads)
                   and r["dtype"] == "bfloat16"
                   and (r["Sq"], r["Sk"]) == (sq, sk))
        mask = "causal" if row["causal"] else "no mask"
        results["K5"][key] = {
            "shape": f"B={row['B']}, Sq={row['Sq']}, Sk={row['Sk']}, "
                     f"{heads_text(heads)}, bf16, {mask} ({site})",
            **{k: row[k] for k in summary}}
    k5b_rows = []
    for (b, sq, sk, causal, dtype_name), heads in K5B_CASES:
        h5, hkv5, hd5, dv5 = v_heads(heads)
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, sq, h5, hd5), (b, sk, hkv5, hd5),
                                     (b, sk, hkv5, dv5), (b, sq, h5, dv5)))
        case = (b, sq, sk, causal, dtype_name)
        # K5 with lse (the training forward) against its plain version, and
        # its output equal to the serve path's
        o, lse = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                with_lse=True)
        ro, rlse = flash_attention_fwd_ref(q, k, v, causal=causal)
        lse_err = float((lse - rlse).abs().max())
        o_err = float((o.float() - ro.float()).abs().max())
        if not (lse_err <= K5_LSE_ATOL and o_err <= K5_TOL[dtype_name]) \
                or not torch.equal(o, fa_kernel.flash_attention_cuda(
                    q, k, v, causal=causal)):
            raise AssertionError(f"K5 with lse at {case}: lse err {lse_err}, "
                                 f"o err {o_err}")
        fn5 = fa_ops.flash_attention
        tc_before = fn5.bwd_tc_launches
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got5b = torch.autograd.grad(
            fa_ops.FlashAttentionFn.apply(*leaves, causal), leaves, do)
        torch.cuda.synchronize()
        route5b = "tc" if fn5.bwd_tc_launches > tc_before else "simt"
        if route5b != ("simt" if dtype == torch.float32 else "tc") \
                or route5b != fa_kernel.bwd_route(dtype, hd5, dv5):
            raise AssertionError(f"K5b {dtype_name} at hd {hd5} / {dv5} took "
                                 f"the {route5b} route")
        plain5b = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        errs = {name: rel_err(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), got5b, plain5b)}
        again = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                   causal=causal)
        if not max(errs.values()) <= K5B_TOL[dtype_name] \
                or not all(torch.equal(g, a) for g, a in zip(got5b, again)):
            raise AssertionError(f"K5b at {case}, {h5}/{hkv5} heads, hd "
                                 f"{hd5} / {dv5}: {errs}, or two calls "
                                 f"differ")
        del again
        # q, k, v, o, dO and lse read once (v, o and dO at the v head dim),
        # dq, dk, dv written once; the five products over the causal pairs:
        # q K^T, dS^T q and dS K at q . k's width, dO V^T and P^T dO at v's
        w5b = fa_ops.flash_attention_bwd_work(q, k, v, causal=causal)
        b5b, by5b = work_bound(w5b)
        k5b_rows.append({
            "B": b, "Sq": sq, "Sk": sk, "H": h5, "Hkv": hkv5, "hd": hd5,
            "dv": dv5, "causal": causal,
            "dtype": dtype_name, "kernel_route": route5b,
            "k5_lse_max_abs_err": lse_err,
            "max_abs_err": max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got5b, plain5b)),
            "rel_err": errs, "max_rel_err": max(errs.values()),
            "tolerance": K5B_TOL[dtype_name],
            "tolerance_of": "max_rel_err (max |d| / max |ref| per gradient)",
            **sdpa_backward_in_turns(
                lambda i: fa_kernel.flash_attention_bwd_cuda(
                    q, k, v, o, lse, do, causal=causal), q, k, v, do,
                causal=causal),
            "plain_ms": cuda_ms(lambda i: flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal), iters=10, warmup=1),
            "bound_ms": b5b, "bound_by": by5b, "work": w5b})
        del q, k, v, do, o, lse, ro, rlse, leaves, got5b, plain5b
        torch.cuda.empty_cache()
    main5b = k5b_rows[0]
    K5B_SUMMARY = ("rel_err", "max_rel_err", "tolerance_of")
    results["K5b"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:88",
        "shape": f"B={main5b['B']}, S={main5b['Sq']}, "
                 f"{heads_text(QWEN_HEADS)}, bf16, causal (qwen2.5-3b "
                 "training, a layer)",
        **{key: main5b[key] for key in summary + K5B_SUMMARY}}
    results["K5b"]["lm100m"] = {
        "shape": f"B=8, S=256, {heads_text(LM100M_HEADS)}, bf16, causal "
                 "(the train_lm twin's lm-100m, a layer)",
        **{key: k5b_rows[3][key] for key in summary + K5B_SUMMARY}}
    results["K5b"]["mla"] = {
        "shape": f"B=1, S=2048, {heads_text(DEEPSEEK_HEADS)}, bf16, causal "
                 "(deepseek-v2 training, a layer)",
        **{key: k5b_rows[4][key] for key in summary + K5B_SUMMARY}}
    results["K5b"]["moe"] = {
        "shape": f"B=4, S=1024, {heads_text(QWEN3_MOE_HEADS)}, bf16, causal "
                 "(qwen3-moe training, a layer)",
        **{key: k5b_rows[5][key] for key in summary + K5B_SUMMARY}}
    for key, heads, sq, sk, site in (
            ("hd112", ZAMBA2_HEADS, 1024, 1024,
             "zamba2-7b training, a shared site"),
            ("whisper_encoder", WHISPER_HEADS, 1500, 1500,
             "whisper-small training, an encoder layer"),
            ("whisper_self", WHISPER_HEADS, 448, 448,
             "whisper-small training, a decoder self attention"),
            ("whisper_cross", WHISPER_HEADS, 448, 1500,
             "whisper-small training, a decoder cross attention")):
        row = next(r for r in k5b_rows
                   if (r["H"], r["Hkv"], r["hd"], r["dv"]) == v_heads(heads)
                   and r["dtype"] == "bfloat16"
                   and (r["Sq"], r["Sk"]) == (sq, sk))
        mask = "causal" if row["causal"] else "no mask"
        results["K5b"][key] = {
            "shape": f"B=8, Sq={sq}, Sk={sk}, {heads_text(heads)}, bf16, "
                     f"{mask} ({site})",
            **{k: row[k] for k in summary + K5B_SUMMARY}}
    k6_f32 = k6_check(dev, *k6_random_inputs(dev, gen))
    results["K6b"] = k6b_check(dev, gen)
    emit({"phase": "kernels", "K1": results["K1"], "K2": results["K2"],
          "K3": k3_rows, "K5": k5_rows, "K5b": k5b_rows, "K6_f32": k6_f32,
          "K6b": results["K6b"]})
    results["K7"] = k7_phase(dev, ids)

    # -- route ---------------------------------------------------------------
    def owners_ok(keys_np):
        want = state.active_ids()
        want = want[np.searchsorted(want, keys_np) % want.size]
        for use_buckets in (True, False):
            if not np.array_equal(state.lookup(keys_np, use_buckets=use_buckets),
                                  want):
                raise AssertionError(f"lookup(use_buckets={use_buckets})")

    t0 = time.perf_counter()
    owners_ok(keys)
    route_s = time.perf_counter() - t0
    live = state.active_ids()
    gone = live[rng.choice(live.size, 32, replace=False)]
    fresh = rng.integers(0, 2**64, size=32, dtype=np.uint64)
    state.apply_events([Event(int(p), "leave", seq=1) for p in gone]
                       + [Event(int(p), "join", seq=1) for p in fresh])
    dirty = int(state._bkt_dirty.sum())
    deltas, sent = state.delta_uploads, state.upload_bytes
    state.device_bucket_table()
    if state.delta_uploads != deltas + 1 \
            or state.upload_bytes != sent + dirty * (128 * 8 + 4):
        raise AssertionError("the EDRA batch did not ship as a delta upload")
    owners_ok(keys)
    uploads = state.upload_count
    small = keys[:4096]
    t0 = time.perf_counter()
    for i in range(100):
        state.lookup(small, use_buckets=bool(i % 2))
    lookup_ms = (time.perf_counter() - t0) * 10
    if state.upload_count != uploads:
        raise AssertionError("an unchanged membership re-uploaded a table")
    emit({"phase": "route", "peers": len(state), "keys": N_KEYS,
          "both_paths_s": route_s, "dirty_rows": dirty,
          "delta_bytes": dirty * (128 * 8 + 4),
          "lookup_4096_keys_ms_host": lookup_ms, "uploads": uploads})
    del state, table, khi, klo, got1, plain1, got2, plain2, table64, keys64
    torch.cuda.empty_cache()

    # -- serve ---------------------------------------------------------------
    cfg = get_config("qwen2.5-3b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
    for i in range(4):
        mem.request_join(f"10.2.0.{i}", 9000)
    router = SessionRouter(mem)
    reqs = [Request(f"user-{i}", rng.integers(0, cfg.vocab, int(n),
                                              dtype=np.int32), 32)
            for i, n in enumerate(rng.integers(128, 1025, size=32))]
    for ops_fn in (rl_ops.ring_lookup64, rl_ops.ring_lookup_bucketed,
                   da_ops.decode_attention):
        ops_fn.launches = 0
    da_ops.decode_attention.tc_launches = 0
    da_ops.decode_attention.simt_launches = 0
    owner_of = dict(zip([r.session_id for r in reqs],
                        router.route([r.session_id for r in reqs])))

    def run(fused: bool):
        return serve_rounds(model, params, mem, reqs, owner_of, dev,
                            slots=32, rounds=32, fused=fused)

    k3_before = da_ops.decode_attention.launches
    fused = run(True)
    k3_fused = da_ops.decode_attention.launches - k3_before
    k2_fused = rl_ops.ring_lookup_bucketed.launches
    unfused = run(False)
    launches = {"K1": rl_ops.ring_lookup64.launches,
                "K2": rl_ops.ring_lookup_bucketed.launches,
                "K3": da_ops.decode_attention.launches,
                "K3_tc": da_ops.decode_attention.tc_launches}
    if fused[0] != unfused[0]:
        raise AssertionError("fused and unfused token streams differ")
    toks = np.array([t for s in fused[0].values() for t in s])
    if toks.min() < 0 or toks.max() >= cfg.vocab \
            or any(len(s) != 33 for s in fused[0].values()):
        raise AssertionError("tokens out of range or streams cut short")
    if k3_fused != cfg.num_layers * fused[3] or k2_fused != fused[3] \
            or launches["K3"] != cfg.num_layers * (fused[3] + unfused[3]) \
            or launches["K2"] != fused[3] or launches["K1"] < 1 \
            or launches["K3_tc"] != launches["K3"]:
        raise AssertionError(f"launch counts {launches} off the main path")
    # a whole-width prefill segment gives finite logits and the first token
    probe = reqs[0]
    cache = model.init_cache(1, 2048, device=dev)
    seg = np.zeros(256 * math.ceil(len(probe.prompt) / 256), np.int32)
    seg[:len(probe.prompt)] = probe.prompt
    for off in range(0, seg.size, 256):
        logits, cache = model.prefill_chunk(
            params, torch.from_numpy(seg[off:off + 256]).to(dev)[None],
            cache, off)
    last = logits[0, (len(probe.prompt) - 1) % 256]
    if not bool(torch.isfinite(logits).all()) \
            or int(torch.argmax(last)) != fused[0][probe.session_id][0]:
        raise AssertionError("prefill logits not finite / first token differs")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    emit({"phase": "serve", "model": cfg.name, "params": n_params,
          "layers": cfg.num_layers, "init_s": init_s,
          "sessions_per_replica": fused[4], "replica_rounds": fused[3],
          "prompt_tokens": prompt_tokens,
          "prefill_tokens_per_s": {"fused": prompt_tokens / fused[1],
                                   "unfused": prompt_tokens / unfused[1]},
          "decode_ms_per_round": {
              "fused_mean": float(np.mean(fused[2][1:])),
              "unfused_mean": float(np.mean(unfused[2][1:])),
              "fused_first": fused[2][0]},
          "launches": launches, "tokens_equal": True,
          "k3_tc_launches_per_replica_round":
              launches["K3_tc"] / (fused[3] + unfused[3]),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})

    results["K5"]["launches"] = whole_prompt_admits(
        model, params, reqs[:8], fused[0], dev)
    cluster_launches = serve_cluster_phase(dev, model, params)
    tp_launches = tp_cluster_phase(dev, model, params)

    del params, model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    tp_parity_phase(dev)
    for key in ("K1", "K2", "K3"):
        results[key]["launches"] = launches[key]
        results[key]["launches_serve_cluster"] = cluster_launches[key]
    for key in ("K1", "K2", "K3", "K5"):
        results[key]["launches_tp_cluster"] = tp_launches[key]
    dense = serve_models_phase(dev, rng, "serve_dense", DENSE_SERVE)
    for key in ("K1", "K2", "K3", "K5"):
        results[key]["launches_serve_dense"] = {
            arch: counts[key] for arch, counts in dense.items()}
    results["K6"] = serve_ssm_phase(dev, rng)
    for phase, row in FAMILY_SERVE:
        counts = serve_models_phase(
            dev, rng, phase, [row],
            after=vlm_image_prefills if phase == "serve_vlm" else None)[
                get_config(row[0]).name]
        for key in ("K1", "K2"):
            results[key][f"launches_{phase}"] = counts[key]
        results["K3"][f"launches_{phase}"] = counts["K3"] \
            + counts.get("K3_image", 0)
        results["K5"][f"launches_{phase}"] = counts["K5_serve"] \
            + counts["K5"] + counts.get("K5_image", 0)
    counts = encdec_phase(dev, rng)
    for key in ("K3", "K5"):
        results[key]["launches_encdec"] = counts[key]
    results["K4"], churn = churn_phase(dev)
    latency_phase(dev, churn)
    results["K7"]["launches"] = quickstart_phase(dev)
    results["K4"]["launches"] += des_twin_phase(dev)
    results["K1"]["launches_dht_cluster"] = dht_cluster_phase(dev)
    train = train_phase(dev)
    results["K5b"]["launches"] = train["K5b"]
    results["K5"]["launches_train"] = train["K5"]
    mla = train_mla_phase(dev)
    results["K5"]["launches_train_mla"] = mla["K5"]
    results["K5b"]["launches_train_mla"] = mla["K5b"]
    results["K5"]["launches_train_mla_step"] = mla["step"]["K5"]
    results["K5b"]["launches_train_mla_step"] = mla["step"]["K5b"]
    moe_ep_counts = train_moe_ep_phase(dev)
    results["K5"]["launches_train_moe_ep"] = moe_ep_counts["K5"]
    results["K5b"]["launches_train_moe_ep"] = moe_ep_counts["K5b"]
    for phase, spec in TRAIN_FAMILIES:
        counts = train_family_phase(dev, phase, spec)
        for key in ("K5", "K5b", "K6"):
            if counts[key]:
                results[key][f"launches_{phase}"] = counts[key]
        if counts["K6b"]:
            results["K6b"]["launches"] = counts["K6b"]
    collectives_phase(dev)
    train_lm_counts = train_lm_phase(dev)
    results["K5"]["launches_train_lm"] = train_lm_counts["K5"]
    results["K5b"]["launches_train_lm"] = train_lm_counts["K5b"]
    for key in results:
        results[key]["max_err"] = results[key]["max_abs_err"]
    if "launches" not in results["K6b"]:
        raise AssertionError("K6b never ran on a training path")
    launch_phase(dev, [("K3", r) for r in k3_rows]
                 + [("K5", r) for r in k5_rows]
                 + [("K5b", r) for r in k5b_rows]
                 + [("K6", k6_f32), ("K6", results["K6"]),
                    ("K6b", results["K6b"]),
                    ("K6b", {**results["K6b"],
                             **results["K6b"]["with_state"]})])
    autotune_phase(dev)
    emit({"kernels": [results[k] for k in ("K1", "K2", "K3", "K4", "K5",
                                           "K5b", "K6", "K6b", "K7")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def serve_rounds(model, params, mem, reqs, owner_of, dev, *, slots: int,
                 rounds: int, fused: bool):
    """One ``Replica`` (``slots`` x 2048 positions, 256-token prefill
    chunks) on each ``Membership`` node; each request admitted on its
    routed owner, then ``rounds`` cluster rounds, fused (each replica
    round resolves its sessions' owners on K2 and must find itself) or
    not.  Returns (streams, prefill s, ms per cluster round, replica
    rounds, sessions per replica, GiB of cache a replica)."""
    import torch
    from repro_torch.serve import Replica
    reps = {}
    for node in mem.members():
        reps[node] = Replica(model, slots=slots, max_len=2048,
                             prefill_chunk=256, device=dev)
        reps[node].attach_params(params)
    cache_gib = sum(t.numel() * t.element_size()
                    for t in next(iter(reps.values())).cache.values()) / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = {r.session_id: [reps[owner_of[r.session_id]].admit(r)]
               for r in reqs}
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    replica_rounds, round_ms = 0, []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for node, rep in reps.items():
            if not rep.sessions:
                continue
            route = mem.ring_state.device_bucket_table() if fused else None
            for sid, tok in rep.decode_round(route=route).items():
                streams[sid].append(tok)
            replica_rounds += 1
            if fused and any(rep.routed_owners[s] != owner_of[s]
                             or owner_of[s] != node for s in rep.sessions):
                raise AssertionError("a fused round routed off-owner")
        round_ms.append((time.perf_counter() - t0) * 1e3)
    buckets = sorted(len(rep.sessions) for rep in reps.values())
    del reps
    torch.cuda.empty_cache()
    return streams, prefill_s, round_ms, replica_rounds, buckets, cache_gib


def cluster_requests(cfg, rng, shape=CLUSTER):
    """The serve_cluster phase's sessions: prompts of ``prompt`` (128-1024)
    tokens drawn as the serve phase draws them, where ``system`` of them
    start with one shared ``system_len``-token system prompt and go on
    with ``own`` (64-512) tokens of their own; ``max_new`` tokens each."""
    from repro_torch.serve import Request
    n, k, sys_len = shape["sessions"], shape["system"], shape["system_len"]
    system = rng.integers(0, cfg.vocab, sys_len, dtype=np.int32)
    prompts = [rng.integers(0, cfg.vocab, int(m), dtype=np.int32)
               for m in rng.integers(shape["prompt"][0], shape["prompt"][1] + 1,
                                     size=n - k)]
    for m in rng.integers(shape["own"][0], shape["own"][1] + 1, size=k):
        prompts.append(np.concatenate([system, rng.integers(
            0, cfg.vocab, int(m), dtype=np.int32)]))
    order = rng.permutation(n)
    return [Request(f"cluster-{i}", prompts[j], shape["max_new"])
            for i, j in enumerate(order)], \
        {f"cluster-{i}" for i, j in enumerate(order) if j >= n - k}


def run_cluster(model, params, reqs, dev, *, fail: bool, shape=CLUSTER,
                hooks=None):
    """One ServeCluster (``shape``: slots, positions, chunk, duty,
    replication 2, fused rounds, KV blocks and the prefix cache on) on
    four Membership nodes and a §V-quarantined preemptible node that
    serves as the gateway of every other submit.  ``shape["rounds"]``
    rounds, then (with ``fail``) the node with the most live sessions
    fails, then rounds to the end.  ``hooks`` (a dict of callables) sees
    the cluster before the submits (``routed``), after them
    (``submitted``), just before the failure (``before_fail``) and just
    after it (``after_fail``).
    Returns (cluster, membership, gateway, ms per round)."""
    import torch
    from repro_torch.runtime import Membership
    from repro_torch.serve import ServeCluster
    hooks = hooks or {}
    mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
    for i in range(4):
        mem.request_join(f"10.5.0.{i}", 9000)
    gw = mem.request_join("10.5.9.9", 9999, preemptible=True)
    cluster = ServeCluster(mem, model, params, slots=shape["slots"],
                           max_len=shape["max_len"],
                           prefill_chunk=shape["chunk"],
                           prefill_duty=shape["duty"], replication=2,
                           fused=True, kv_blocks=True, prefix_cache=True,
                           device=dev)
    if "routed" in hooks:
        hooks["routed"](cluster)
    for i, r in enumerate(reqs):
        cluster.submit(r, via=gw if i % 2 else None)
    if "submitted" in hooks:
        hooks["submitted"](cluster)
    round_ms = []

    def step():
        t0 = time.perf_counter()
        cluster.step()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(shape["rounds"]):
        step()
    if fail:
        live = {}
        for rec in cluster.live_sessions:
            live[rec.owner] = live.get(rec.owner, 0) + 1
        victim = max(sorted(live), key=live.get)
        if "before_fail" in hooks:
            hooks["before_fail"](cluster, victim)
        mem.fail(victim)
        if "after_fail" in hooks:
            hooks["after_fail"](cluster, victim)
    while cluster.live_sessions:
        if len(round_ms) > 4 * shape["max_new"]:
            raise AssertionError("serve_cluster: sessions did not complete")
        step()
    return cluster, mem, gw, round_ms


def slab_bytes(cache, slot, lo, hi) -> bytes:
    """Cache rows [lo, hi) of one slot as a block's bytes, read straight
    from the cache tensors: (2, positions, layers, kv heads, hd)."""
    import torch
    rows = torch.stack([cache["k"][:, slot, lo:hi], cache["v"][:, slot, lo:hi]])
    rows = rows.transpose(1, 2).contiguous()
    return rows.view(torch.int16).cpu().numpy().tobytes() \
        if rows.dtype == torch.bfloat16 else rows.cpu().numpy().tobytes()


def serve_cluster_phase(dev, model, params, shape=CLUSTER) -> dict:
    """qwen2.5-3b's serve cluster on the card (see the module docstring):
    handoff from KV blocks, prefix-cache hits, a §V gateway and a node
    failure, with the gates listed there.  Counters are zeroed just
    before the gated run and read just after it; K1, K2 and K3 are then
    held against their plain versions at the phase's own shapes (K3 on
    the decode calls it recorded, one a bucket size).  Returns the
    launches by kernel."""
    import torch
    from repro_torch.core.ringstate import RingState
    from repro_torch.dht.data import unpack_array
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ring_lookup.ref import (ring_lookup64_ref,
                                                     ring_lookup_bucketed_ref)
    from repro_torch.models import layers
    from repro_torch.serve import Replica
    from repro_torch.serve.server import _words, session_key
    cfg, c = model.cfg, shape["chunk"]
    rng = np.random.default_rng([SEED, 11])
    reqs, system_sids = cluster_requests(cfg, rng, shape)
    sids = [r.session_id for r in reqs]
    notes = {"k1_batches": 0}

    def routed(cluster):
        # the submit batch through the router: one K1 launch
        notes["routed"] = dict(zip(sids, cluster.router.route(sids)))
        notes["k1_batches"] += 1

    def submitted(cluster):
        state = cluster.state
        for rec in cluster.sessions.values():
            group = state.replica_set(rec.key, 2)
            if group[0] != notes["routed"][rec.session_id] \
                    or rec.owner not in group:
                raise AssertionError(f"{rec.session_id}: owner {rec.owner} "
                                     f"outside {group} / off the router")
        # the later system-prompt sessions: first token and rows [0, 512)
        first = next(s for s in sids if s in system_sids)
        notes["prefix"] = {}
        for sid in sids:
            if sid in system_sids and sid != first:
                rec = cluster.sessions[sid]
                rep = cluster.replicas[rec.owner]
                notes["prefix"][sid] = (rec.generated[0], slab_bytes(
                    rep.cache, rep.sessions[sid], 0, shape["system_len"]))

    def before_fail(cluster, victim):
        rep = cluster.replicas[victim]
        notes["victim"] = {}
        for rec in cluster.live_sessions:
            if rec.owner != victim:
                continue
            s = len(rec.prompt) + len(rec.generated)
            covered = min(rec.exported_chunks, (s - 1) // c)
            slot = rep.sessions[rec.session_id]
            notes["victim"][rec.session_id] = (rec.exported_chunks, covered, [
                slab_bytes(rep.cache, slot, j * c, (j + 1) * c)
                for j in range(covered)])
        inner = cluster._fetch_blocks
        notes["fetched"] = {}

        def fetch(rec, s):
            blocks = inner(rec, s)
            notes["fetched"][rec.session_id] = blocks
            return blocks
        cluster._fetch_blocks = fetch
        notes["counts_before"] = (cluster.handoffs, cluster.handoff_misses,
                                  cluster.handoff_chunks)

    def after_fail(cluster, victim):
        del cluster._fetch_blocks
        moved = sorted(notes["victim"])
        h, m, ch = (a - b for a, b in zip(
            (cluster.handoffs, cluster.handoff_misses, cluster.handoff_chunks),
            notes["counts_before"]))
        want_h = sum(1 for e, _, _ in notes["victim"].values() if e >= 1)
        want_ch = sum(cov for _, cov, _ in notes["victim"].values())
        if not (h == want_h >= 1 and m == len(moved) - want_h
                and ch == want_ch):
            raise AssertionError(
                f"handoffs {h} (want {want_h}), misses {m} (want "
                f"{len(moved) - want_h}), chunks {ch} (want {want_ch})")
        exact = 0
        for sid in moved:
            exported, covered, donor = notes["victim"][sid]
            fetched = notes["fetched"].get(sid, [])
            got = [b.tobytes() for b in fetched]
            if got != donor:
                raise AssertionError(f"{sid}: fetched blocks differ from the "
                                     "donor's rows")
            rec = cluster.sessions[sid]
            if covered:
                rep = cluster.replicas[rec.owner]
                slot = rep.sessions[sid]
                if [slab_bytes(rep.cache, slot, j * c, (j + 1) * c)
                        for j in range(covered)] != got:
                    raise AssertionError(f"{sid}: imported rows differ from "
                                         "its blocks")
                exact += 1
        # the re-home batch through the router: one K1 launch
        owners = cluster.router.route(moved)
        notes["k1_batches"] += 1
        for sid, owner in zip(moved, owners):
            rec = cluster.sessions[sid]
            group = cluster.state.replica_set(rec.key, 2)
            if owner != group[0] or rec.owner not in group \
                    or rec.owner == victim:
                raise AssertionError(f"{sid} re-homed off its replica set")
        notes.update(moved=moved, handoffs=h, misses=m, chunks=ch,
                     rows_exact=exact, victim_id=victim)
        notes["stats_after_fail"] = cluster.stats()

    # the gated run: counters zeroed just before, read just after
    recorded = {}
    inner_op = layers._decode_op

    def recording(q, k, v, length):
        if q.shape[0] not in recorded:
            recorded[q.shape[0]] = tuple(t.clone() for t in (q, k, v, length))
        return inner_op(q, k, v, length)

    for fn in (rl_ops.ring_lookup64, rl_ops.ring_lookup_bucketed,
               da_ops.decode_attention):
        fn.launches = 0
    da_ops.decode_attention.tc_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers._decode_op = recording
    t0 = time.perf_counter()
    try:
        cluster, mem, gw, round_ms = run_cluster(
            model, params, reqs, dev, fail=True, shape=shape,
            hooks={"routed": routed, "submitted": submitted,
                   "before_fail": before_fail, "after_fail": after_fail})
    finally:
        layers._decode_op = inner_op
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"K1": rl_ops.ring_lookup64.launches,
                "K2": rl_ops.ring_lookup_bucketed.launches,
                "K3": da_ops.decode_attention.launches,
                "K3_tc": da_ops.decode_attention.tc_launches}
    peak = torch.cuda.max_memory_allocated()
    rounds = cluster.fused_rounds
    # fused owners that differ from the record: warm-prefix placements on
    # the replica set's second member
    route_divergence = cluster.route_divergence
    stats = cluster.stats()
    # gates: no session lost, the gateway, the launches
    lost = [s for s in sids if len(cluster.sessions[s].generated)
            != shape["max_new"]]
    if lost or cluster.pending_migrations or stats["live"]:
        raise AssertionError(f"sessions lost or in flight: {lost}")
    if gw in cluster.replicas or stats["proxied"] != len(reqs) // 2 \
            or cluster.proxied.get(gw) != len(reqs) // 2:
        raise AssertionError(f"gateway owned a replica or proxied "
                             f"{stats['proxied']}")
    k3_layers = cfg.num_layers
    if launches["K2"] != rounds + 2 or launches["K3"] != k3_layers * rounds \
            or launches["K3_tc"] != launches["K3"] \
            or launches["K1"] != notes["k1_batches"]:
        raise AssertionError(f"serve_cluster launch counts {launches} over "
                             f"{rounds} fused replica rounds")
    prefix_hits = cluster.prefix.hits
    want_hits = (len(system_sids) - 1) * (shape["system_len"] // c)
    if prefix_hits < want_hits:
        raise AssertionError(f"prefix hits {prefix_hits} < {want_hits}")
    # the kernels at the phase's shapes, against their plain versions
    state = cluster.state
    keys = np.array([session_key(s) for s in sids], np.uint64)
    khi = _words((keys >> np.uint64(32)).astype(np.uint32)).to(dev)
    klo = _words((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(dev)
    table = state.device_table()
    route = state.device_bucket_table()
    k1 = rl_ops.ring_lookup64(khi, klo, *table)
    k2 = rl_ops.ring_lookup_bucketed(khi, klo, *route)
    errs = {"K1": int((k1.long() - ring_lookup64_ref(khi, klo, *table)
                       .long()).abs().max()),
            "K2": max(int((a.long() - b.long()).abs().max()) for a, b in zip(
                k2, ring_lookup_bucketed_ref(khi, klo, *route)))}
    k3_err = {}
    for b, (q, k, v, length) in sorted(recorded.items()):
        got = da_ops.decode_attention(q, k, v, length)
        want = decode_attention_ref(q, k, v, length)
        k3_err[b] = float((got.float() - want.float()).abs().max())
    errs["K3"] = max(k3_err.values())
    if errs["K1"] or errs["K2"] or not errs["K3"] <= BF16_ATOL:
        raise AssertionError(f"serve_cluster kernels against plain: {errs}")
    gen_failed = {s: list(cluster.sessions[s].generated) for s in sids}
    import_us = [t.handoff_us for s, t in cluster.traces.items()
                 if s in notes["moved"]]
    store = cluster.blocks.stats()
    # the membership's listeners and the cluster refer to each other: free
    # the replicas' caches (and their hold on the weights) now
    del cluster, mem, recorded
    gc.collect()
    torch.cuda.empty_cache()

    # prefix hits exact: the same prompts on a fresh replica without a
    # prefix cache give the same first tokens and rows [0, system_len)
    fresh = Replica(model, slots=len(notes["prefix"]), max_len=shape["max_len"],
                    prefill_chunk=c, device=dev)
    fresh.attach_params(params)
    for r in reqs:
        if r.session_id in notes["prefix"]:
            tok = fresh.admit(r)
            want_tok, want_rows = notes["prefix"][r.session_id]
            if tok != want_tok or slab_bytes(
                    fresh.cache, fresh.sessions[r.session_id], 0,
                    shape["system_len"]) != want_rows:
                raise AssertionError(f"{r.session_id}: prefix-hit admit "
                                     "differs from a fresh admit")
    del fresh
    # import vs re-prefill of the same covered positions
    reprefill_us, imports = [], []
    moved_with_blocks = [s for s in notes["moved"]
                         if notes["victim"][s][1] > 0]
    by_sid = {r.session_id: r for r in reqs}
    for sid in moved_with_blocks:
        covered = notes["victim"][sid][1]
        blocks = [unpack_array(b) if isinstance(b, bytes) else b
                  for b in notes["fetched"][sid]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.cache_with_blocks(shape["max_len"], blocks, device=dev)
        torch.cuda.synchronize()
        imports.append((time.perf_counter() - t0) * 1e6)
        transcript = by_sid[sid].prompt
        cache = model.init_cache(1, shape["max_len"], device=dev)
        tokens = np.concatenate([transcript, np.asarray(
            gen_failed[sid], np.int32)])[:covered * c]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for off in range(0, covered * c, c):
            model.prefill_chunk(params, torch.from_numpy(
                tokens[off:off + c]).to(dev)[None], cache, off)
        torch.cuda.synchronize()
        reprefill_us.append((time.perf_counter() - t0) * 1e6)
        del cache
    # an unfailed run of the same cluster: how many of the migrated
    # sessions' tokens agree (not gated: a handed-off tail is one chunk
    # where the donor decoded it token by token)
    clean, cmem, _, clean_ms = run_cluster(model, params, reqs, dev,
                                           fail=False, shape=shape)
    agree = sum(a == b for s in notes["moved"] for a, b in zip(
        gen_failed[s], clean.sessions[s].generated))
    total = sum(len(gen_failed[s]) for s in notes["moved"])
    same_sessions = sum(gen_failed[s] == clean.sessions[s].generated
                        for s in notes["moved"])
    unmoved = [s for s in sids if s not in notes["moved"]]
    unmoved_agree = sum(a == b for s in unmoved for a, b in zip(
        gen_failed[s], clean.sessions[s].generated))
    unmoved_same = sum(gen_failed[s] == clean.sessions[s].generated
                       for s in unmoved)
    del clean, cmem
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_cluster", "model": cfg.name,
          "layers": cfg.num_layers, "nodes": 4, "gateway": 1,
          "slots": shape["slots"], "max_len": shape["max_len"],
          "prefill_chunk": c, "prefill_duty": shape["duty"],
          "replication": 2, "sessions": len(reqs),
          "system_prompt_sessions": len(system_sids),
          "system_prompt_tokens": shape["system_len"],
          "prompt_tokens": sum(len(r.prompt) for r in reqs),
          "max_new_tokens": shape["max_new"],
          "rounds_before_failure": shape["rounds"],
          "failed_node_sessions": len(notes["moved"]),
          "handoffs": notes["handoffs"], "handoff_misses": notes["misses"],
          "handoff_chunks": notes["chunks"],
          "imported_rows_exact": notes["rows_exact"],
          "prefix_hits": prefix_hits, "prefix_hits_floor": want_hits,
          "prefix_exact_sessions": len(notes["prefix"]),
          "proxied": stats["proxied"], "fused_replica_rounds": rounds,
          "route_divergence": route_divergence,
          "launches": launches,
          "kernels_vs_plain_max_abs_err": {**errs, "K3_by_bucket": k3_err},
          "decode_ms_per_cluster_round": {
              "mean": float(np.mean(round_ms)),
              "median": float(np.median(round_ms)),
              "rounds": len(round_ms),
              "unfailed_mean": float(np.mean(clean_ms))},
          "import_us": imports, "import_us_mean": float(np.mean(imports))
          if imports else None,
          "reprefill_same_positions_us": reprefill_us,
          "reprefill_us_mean": float(np.mean(reprefill_us))
          if reprefill_us else None,
          "handoff_us_traces": import_us,
          "exported_blocks": stats["exported_blocks"],
          "store": store,
          "route_upload_bytes": stats["route_upload_bytes"],
          "stats": stats, "stats_after_fail": notes["stats_after_fail"],
          "max_memory_allocated": peak,
          "max_memory_allocated_gib": peak / 2**30,
          "migrated_tokens_equal_to_unfailed_run": f"{agree}/{total}",
          "migrated_sessions_equal_to_unfailed_run":
              f"{same_sessions}/{len(notes['moved'])}",
          # the failure moves sessions between replicas, so the others
          # decode in other batches: bf16 GEMMs of another M round apart
          "unmoved_tokens_equal_to_unfailed_run":
              f"{unmoved_agree}/{len(unmoved) * shape['max_new']}",
          "unmoved_sessions_equal_to_unfailed_run":
              f"{unmoved_same}/{len(unmoved)}",
          "wall_s": wall_s})
    return launches


def serve_models_phase(dev, rng, phase: str, rows, after=None) -> dict:
    """Models on the path the qwen serve phase runs, one row of ``rows``
    each (``DENSE_SERVE``, ``FAMILY_SERVE``): each at full width from
    seeded random weights, four ``Membership`` nodes with one ``Replica``
    each, its requests routed (owners against a numpy bisect), ``rounds``
    cluster rounds fused then unfused, tokens equal; K2 one launch a fused
    replica round, K3 one an attention layer (the hybrid's: a shared site)
    and replica round, all on the tensor cores (MLA's absorbed decode: no
    K3 launch at all).  A family with chunked
    prefill (dense, MoE, VLM) admits in 256-token chunks, launches no K5 there,
    its chunked prefill probe's first token is the fused stream's, and then
    the first ``whole`` requests are admitted whole on K5 (one tensor-core
    launch an attention layer and admit); a family that admits whole
    prompts (the hybrid, MLA) launches K5 once an attention site and admit,
    on the tensor cores, and its whole prefill probe's first token is the
    fused stream's.  ``after(model, params, dev, rng)``, where given, runs
    next with the weights still on the card and adds its launch counts.
    Counters are zeroed just before each model's run and read just after.
    Returns each model's launches by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.models import Model
    from repro_torch.models.hybrid import num_shared_sites
    from repro_torch.runtime import Membership
    from repro_torch.serve import Request, SessionRouter
    from repro_torch.serve.server import session_key
    out = {}
    for arch, layers, slots, n_req, rounds, whole in rows:
        full = get_config(arch)
        cfg = full if layers is None else full.with_overrides(
            num_layers=layers)
        model = Model(cfg)
        chunked = model.supports_chunked_prefill
        attn_layers = num_shared_sites(cfg) if cfg.shared_attn_every \
            else cfg.num_layers
        # MLA decodes absorbed over the latent cache: plain torch products
        k3_layers = 0 if cfg.mla_kv_lora else attn_layers
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
        for i in range(4):
            mem.request_join(f"10.3.0.{i}", 9000)
        router = SessionRouter(mem)
        reqs = [Request(f"{arch}-{i}", rng.integers(0, cfg.vocab, int(n),
                                                    dtype=np.int32), rounds)
                for i, n in enumerate(rng.integers(128, 1025, size=n_req))]
        counters = (rl_ops.ring_lookup64, rl_ops.ring_lookup_bucketed,
                    da_ops.decode_attention, fa_ops.flash_attention)
        for fn in counters:
            fn.launches = 0
        da_ops.decode_attention.tc_launches = 0
        fa_ops.flash_attention.tc_launches = 0
        sids = [r.session_id for r in reqs]
        owner_of = dict(zip(sids, router.route(sids)))
        act = mem.ring_state.active_ids()
        keys = np.array([session_key(sid) for sid in sids], np.uint64)
        want = act[np.searchsorted(act, keys) % act.size]
        if [owner_of[sid] for sid in sids] != [int(w) for w in want]:
            raise AssertionError(f"{arch}: routed owners differ from a "
                                 "numpy bisect")
        fused = serve_rounds(model, params, mem, reqs, owner_of, dev,
                             slots=slots, rounds=rounds, fused=True)
        k2_fused = rl_ops.ring_lookup_bucketed.launches
        unfused = serve_rounds(model, params, mem, reqs, owner_of, dev,
                               slots=slots, rounds=rounds, fused=False)
        launches = {"K1": rl_ops.ring_lookup64.launches,
                    "K2": rl_ops.ring_lookup_bucketed.launches,
                    "K3": da_ops.decode_attention.launches,
                    "K3_tc": da_ops.decode_attention.tc_launches,
                    "K5_serve": fa_ops.flash_attention.launches,
                    "K5_serve_tc": fa_ops.flash_attention.tc_launches}
        if fused[0] != unfused[0]:
            raise AssertionError(f"{arch}: fused and unfused token streams "
                                 "differ")
        toks = np.array([t for st in fused[0].values() for t in st])
        if toks.min() < 0 or toks.max() >= cfg.vocab \
                or any(len(st) != rounds + 1 for st in fused[0].values()):
            raise AssertionError(f"{arch}: tokens out of range or streams "
                                 "cut short")
        rr = fused[3] + unfused[3]
        k5_serve = 0 if chunked else attn_layers * 2 * n_req
        if k2_fused != fused[3] or launches["K2"] != fused[3] \
                or launches["K3"] != k3_layers * rr \
                or launches["K3_tc"] != launches["K3"] or launches["K1"] < 1 \
                or launches["K5_serve"] != k5_serve \
                or launches["K5_serve_tc"] != k5_serve:
            raise AssertionError(f"{arch}: launch counts {launches} off the "
                                 "main path")
        probe = reqs[0]
        cache = model.init_cache(1, 2048, device=dev)
        if chunked:
            seg = np.zeros(256 * math.ceil(len(probe.prompt) / 256), np.int32)
            seg[:len(probe.prompt)] = probe.prompt
            for off in range(0, seg.size, 256):
                logits, cache = model.prefill_chunk(
                    params, torch.from_numpy(seg[off:off + 256]).to(dev)[None],
                    cache, off)
            last = logits[0, (len(probe.prompt) - 1) % 256]
        else:
            logits, cache = model.prefill(
                params, {"tokens": torch.from_numpy(probe.prompt).to(dev)[None]},
                cache)
            last = logits[0]
        if not bool(torch.isfinite(logits).all()) \
                or int(torch.argmax(last)) != fused[0][probe.session_id][0]:
            raise AssertionError(f"{arch}: prefill logits not finite / first "
                                 "token differs")
        del cache, logits, last
        launches["K5"] = whole_prompt_admits(
            model, params, reqs[:whole], fused[0], dev) if whole else 0
        if after is not None:
            launches.update(after(model, params, dev, rng))
        prompt_tokens = sum(len(r.prompt) for r in reqs)
        shape = {"d_model": cfg.d_model,
                 "heads": [cfg.num_heads, cfg.num_kv_heads],
                 "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab, "act": cfg.act}
        if cfg.shared_attn_every:
            shape.update(mamba_version=cfg.mamba_version,
                         d_inner=cfg.ssm_expand * cfg.d_model,
                         ssm_heads=cfg.ssm_expand * cfg.d_model
                         // cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
                         shared_sites=attn_layers)
        if cfg.moe_experts:
            shape.update(experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                         moe_d_ff=cfg.moe_d_ff,
                         shared_experts=cfg.moe_shared_experts)
        if cfg.mla_kv_lora:
            shape.update(head_dim=None, kv_lora=cfg.mla_kv_lora,
                         q_lora=cfg.mla_q_lora,
                         qk_nope_dim=cfg.mla_qk_nope_dim,
                         qk_rope_dim=cfg.mla_qk_rope_dim,
                         v_head_dim=cfg.mla_v_head_dim)
        emit({"phase": phase, "model": cfg.name, "params": n_params,
              "layers": cfg.num_layers, "full_layers": full.num_layers,
              "cut": None if layers is None else
              f"depth {full.num_layers} -> {layers} layers, full width",
              **shape, "init_s": init_s, "slots": slots, "requests": n_req,
              "admits": "256-token chunks" if chunked else "whole prompts",
              "sessions_per_replica": fused[4], "replica_rounds": fused[3],
              "cache_gib_per_replica": fused[5],
              "prompt_tokens": prompt_tokens,
              "prefill_tokens_per_s": {"fused": prompt_tokens / fused[1],
                                       "unfused": prompt_tokens / unfused[1]},
              "decode_ms_per_round": {
                  "fused_mean": float(np.mean(fused[2][1:])),
                  "unfused_mean": float(np.mean(unfused[2][1:])),
                  "fused_first": fused[2][0]},
              "launches": launches, "tokens_equal": True,
              "owners_equal_numpy_bisect": True,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "max_memory_allocated_gib":
                  torch.cuda.max_memory_allocated() / 2**30})
        out[cfg.name] = launches
        del params, model, mem, router
        torch.cuda.empty_cache()
    return out


def vlm_image_prefills(model, params, dev, rng) -> dict:
    """The VLM's image path (``VLM_IMAGE``): one prefill through
    ``Model.prefill`` of B prompts, each its 256 stub vision embeddings
    (N(0, 1) from the seed) and then 128 text tokens, then per-slot greedy
    decode steps.  Gates: finite logits, K5 one tensor-core launch a layer
    in the prefill, K3 one tensor-core launch a layer a step.  Returns
    those launches."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg = model.cfg
    b, n_txt, steps = VLM_IMAGE
    n_img = cfg.vision_tokens
    gen = torch.Generator(device=dev).manual_seed(SEED)
    img = torch.randn((b, n_img, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_txt),
                                           dtype=np.int32)).to(dev)
    cache = model.init_cache(b, n_img + n_txt + steps, device=dev)
    fa, da = fa_ops.flash_attention, da_ops.decode_attention
    fa.launches = fa.tc_launches = da.launches = da.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens,
                                           "image_embeds": img}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    idx = torch.full((b,), n_img + n_txt, dtype=torch.int32, device=dev)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    picked = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tok[:, None], idx)
        finite &= bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        picked.append(tok)
        idx += 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    toks = torch.stack(picked).cpu().numpy()
    counts = {"K5_image": fa.launches, "K5_image_tc": fa.tc_launches,
              "K3_image": da.launches, "K3_image_tc": da.tc_launches}
    if not finite or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{cfg.name}: image prefill or decode logits "
                             "not finite / tokens out of range")
    if counts["K5_image"] != cfg.num_layers \
            or counts["K5_image_tc"] != counts["K5_image"] \
            or counts["K3_image"] != cfg.num_layers * steps \
            or counts["K3_image_tc"] != counts["K3_image"]:
        raise AssertionError(f"{cfg.name}: image path launch counts "
                             f"{counts} off the main path")
    emit({"phase": "serve_vlm_image", "model": cfg.name, "batch": b,
          "vision_tokens": n_img, "prompt_tokens": n_txt,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": b * (n_img + n_txt) / prefill_ms * 1e3,
          "decode_steps": steps, "decode_ms_per_step": step_ms,
          "launches": counts, "finite": True})
    del cache, logits
    torch.cuda.empty_cache()
    return counts


def encdec_phase(dev, rng) -> dict:
    """whisper-small at full size (``ENCDEC``): seeded random weights, B
    streams of 1500 stub frames (N(0, 1) from the seed) and 4-token
    prompts through ``Model.prefill``, then lockstep greedy steps.  Gates:
    K5 36 launches a prefill (12 encoder layers without a mask, 12 causal
    decoder self attentions, 12 cross attentions without a mask at Sq 4,
    Sk 1500), K3 24 a step (12 self, 12 cross at length 1500), all on the
    tensor cores; finite logits, tokens in range.  Returns K3's and K5's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import Model
    cfg = get_config("whisper-small")
    b, n_txt, max_len, steps = ENCDEC
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    frames = torch.randn((b, cfg.audio_frames, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n_txt),
                                           dtype=np.int32)).to(dev)
    fa, da = fa_ops.flash_attention, da_ops.decode_attention
    fa.launches = fa.tc_launches = da.launches = da.tc_launches = 0
    cache = model.init_cache(b, max_len, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens,
                                           "frames": frames}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all()) \
        and bool(torch.isfinite(cache["xk"]).all())
    k5 = (fa.launches, fa.tc_launches)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    picked, step_ms = [tok], []
    for step in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok[:, None],
                                          n_txt + step)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(logits).all())
        picked.append(tok)
    toks = torch.stack(picked).cpu().numpy()
    k3 = (da.launches, da.tc_launches)
    attn_prefill = cfg.encoder_layers + 2 * cfg.num_layers
    if not finite or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError("whisper-small: logits not finite / tokens out "
                             "of range")
    if k5 != (attn_prefill, attn_prefill) \
            or k3 != (2 * cfg.num_layers * steps,) * 2:
        raise AssertionError(f"whisper-small: K5 {k5}, K3 {k3} (launches, "
                             "tensor-core launches) off the main path")
    emit({"phase": "encdec", "model": cfg.name, "params": n_params,
          "layers": [cfg.encoder_layers, cfg.num_layers],
          "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "act": cfg.act, "init_s": init_s,
          "batch": b, "audio_frames": cfg.audio_frames,
          "prompt_tokens": n_txt, "max_len": max_len, "steps": steps,
          "prefill_ms": prefill_ms,
          "decode_ms_per_step": float(np.mean(step_ms[1:])),
          "decode_ms_first_step": step_ms[0],
          "launches": {"K5": k5[0], "K5_tc": k5[1], "K3": k3[0],
                       "K3_tc": k3[1]},
          "k5_launches_per_prefill": k5[0],
          "k3_launches_per_step": k3[0] / steps,
          "finite": True,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30})
    del params, model, cache, logits, frames
    torch.cuda.empty_cache()
    return {"K3": k3[0], "K5": k5[0]}


def whole_prompt_admits(model, params, reqs, chunked_streams, dev) -> int:
    """A dense model admits whole prompts (``prefill_chunk=None``): the
    prefill attention runs on K5, one tensor-core launch a layer and
    admit.  Returns K5's launches in that run.  First tokens and
    last-position logits are compared with the chunked path, which rounds
    p to bf16 where K5 keeps it in f32: reported, not gated."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve import Replica
    cfg = model.cfg
    rep = Replica(model, slots=len(reqs), max_len=2048, prefill_chunk=None,
                   device=dev)
    rep.attach_params(params)
    fa_ops.flash_attention.launches = fa_ops.flash_attention.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    firsts = {r.session_id: rep.admit(r) for r in reqs}
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    round_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        rep.decode_round()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fa_ops.flash_attention.launches
    tc = fa_ops.flash_attention.tc_launches
    if launches != cfg.num_layers * len(reqs) or tc != launches:
        raise AssertionError(f"K5 launched {launches} times ({tc} on the "
                             f"tensor cores) for {len(reqs)} whole-prompt "
                             "admits")
    del rep
    deltas, finite, scale = [], True, 0.0
    for r in reqs:
        tokens = torch.from_numpy(r.prompt).to(dev)[None]
        whole, _ = model.prefill(params, {"tokens": tokens},
                                 model.init_cache(1, 2048, device=dev))
        n = len(r.prompt)
        seg = np.zeros(256 * math.ceil(n / 256), np.int32)
        seg[:n] = r.prompt
        cache = model.init_cache(1, 2048, device=dev)
        for off in range(0, seg.size, 256):
            logits, cache = model.prefill_chunk(
                params, torch.from_numpy(seg[off:off + 256]).to(dev)[None],
                cache, off)
        finite &= bool(torch.isfinite(whole).all())
        deltas.append(float((whole[0] - logits[0, (n - 1) % 256]).abs().max()))
        scale = max(scale, float(whole.abs().max()))
        del cache, logits, whole
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("whole-prompt prefill logits not finite")
    agree = sum(firsts[r.session_id] == chunked_streams[r.session_id][0]
                for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    emit({"phase": "serve_whole_prompt", "model": cfg.name,
          "admits": len(reqs), "prompt_tokens": prompt_tokens,
          "prefill_tokens_per_s": prompt_tokens / prefill_s,
          "decode_ms_per_round": float(np.mean(round_ms[1:])),
          "k5_launches": launches, "k5_tc_launches": tc,
          "first_tokens_equal_to_chunked": f"{agree}/{len(reqs)}",
          "last_logits_max_abs_diff_vs_chunked": max(deltas),
          "last_logits_max_abs_diff_each": deltas,
          "last_logits_max_abs": scale})
    return launches


def k6_random_inputs(dev, gen, shape=K6_SHAPE):
    """K6 at ``shape`` (the admit's by default) on test_kernels.py's f32
    distributions, with a random initial state."""
    import torch
    bb, l, din, n = shape

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (rnd(bb, l, din, scale=0.1), rnd(bb, l, din, scale=0.1).abs(),
            rnd(bb, l, n, scale=0.5), rnd(bb, l, n, scale=0.5),
            -rnd(din, n).abs() - 0.1, torch.ones(din, device=dev),
            rnd(bb, din, n, scale=0.1))


def k6_check(dev, x, dt, B, C, A, D, h0=None) -> dict:
    """K6 against its plain version on these inputs: h_last within
    K6_ATOL; y within K6_ATOL in f32, within K6_Y_REL of max |y| in a
    narrower type.  Then K6 asked for its tile start states (as training
    asks): y and h_last bit-equal to the call without, the states within
    K6_STATES_REL of max |h| of the plain scan's.  Times (with and
    without the states), and the bound from these inputs."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    y, h = ssm_ops.ssm_scan(x, dt, B, C, A, D, h0)
    y2, h2, hs = ssm_kernel.ssm_scan_cuda(x, dt, B, C, A, D, h0, states=True)
    torch.cuda.synchronize()
    wy, wh, whs = ssm_scan_ref(x, dt, B, C, A, D, h0,
                               state_tile=ssm_kernel.STATE_TILE)
    err_y = float((y.float() - wy.float()).abs().max())
    err_h = float((h - wh).abs().max())
    y_max = float(wy.float().abs().max())
    y_tol = K6_ATOL if x.dtype == torch.float32 else K6_Y_REL * y_max
    states_equal = torch.equal(y, y2) and torch.equal(h, h2)
    states_err = rel_err(hs, whs)
    del y2, h2, hs, whs
    if not (err_h <= K6_ATOL and err_y <= y_tol):
        raise AssertionError(f"K6 ({x.dtype}): y err {err_y} (tol {y_tol}), "
                             f"h err {err_h}")
    if not (states_equal and states_err <= K6_STATES_REL):
        raise AssertionError(f"K6 with tile states ({x.dtype}): y and h_last "
                             f"bit-equal {states_equal}, states rel err "
                             f"{states_err}")
    bb, l, din = x.shape
    n = A.shape[1]
    b6, by6, w6 = k6_bound(x, dt, B, C, A, D, h0)
    return {"shape": f"Bb={bb}, L={l}, Din={din}, N={n}, x {x.dtype}",
            "dims": [bb, l, din, n], "dtypes": _dtype_names(
                x, dt, B, C, A, D, h0), "work": w6,
            "max_abs_err": max(err_y, err_h), "y_max_abs_err": err_y,
            "h_max_abs_err": err_h, "y_tolerance": y_tol,
            "h_tolerance": K6_ATOL, "y_max_abs": y_max,
            "with_states_bit_equal": states_equal,
            "states_rel_err": states_err, "states_tolerance": K6_STATES_REL,
            "exponentials": w6["exponentials"],
            "ms": cuda_ms(lambda i: ssm_ops.ssm_scan(x, dt, B, C, A, D, h0)),
            "ms_with_states": cuda_ms(lambda i: ssm_kernel.ssm_scan_cuda(
                x, dt, B, C, A, D, h0, states=True)),
            "plain_ms": cuda_ms(lambda i: ssm_scan_ref(x, dt, B, C, A, D, h0),
                                iters=3, warmup=1),
            "library_ms": None, "bound_ms": b6, "bound_by": by6,
            "sfu_ms": sfu_ms(w6["exponentials"])}


def _dtype_names(*tensors) -> list:
    """Each tensor's dtype name (None for None): how the launch phase
    rebuilds a case's inputs on ``meta``."""
    return [None if t is None else str(t.dtype).replace("torch.", "")
            for t in tensors]


def k6_bound(x, dt, B, C, A, D, h0=None):
    """K6's bound on these inputs (``ssm_scan_work``: each input read
    once, y (x's type) and h_last (f32) written once; ``K6_OPS_*`` f32
    operations) and that work."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    work = ssm_ops.ssm_scan_work(x, dt, B, C, A, D, h0)
    return work_bound(work) + (work,)


def sfu_ms(exponentials: int) -> float:
    """The least time for this many exponentials on the SFUs: 16 a clock
    on each SM, at the SM clock nvidia-smi gives as clocks.max.sm."""
    import subprocess
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exponentials / (sms * SFU_PER_CLOCK * mhz * 1e6) * 1e3


def ptxas_of(log: str, kernel: str) -> list:
    """ptxas' -v report of each instantiation of ``kernel`` in a build
    log: [{"function", "registers", "spill_stores", "spill_loads"}]."""
    rows, cur, spill = [], None, (None, None)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur and m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            rows.append({"function": cur, "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            cur = None
    return rows


def k6b_check(dev, gen, shape=K6B_SHAPE) -> dict:
    """K6b (``ssm_scan_bwd_cuda``) against its plain version at ``shape``
    on K6's random distributions, x, B, C, D and dy in bf16: without h0
    and dh_last (training's case) and with both, each fed the tile start
    states K6 writes on the same inputs.  Each gradient within its
    K6B_REL of its max |ref|, a second call bit-equal to the first; times,
    the bound from these inputs and the SFU's floor; the scan kernel's
    registers, spills and residency, and the bytes of its dB / dC
    partials.  Returns K6b's row (the case without a state; the other
    under ``with_state``)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    bb, l, din, n = shape
    x, dt, B, C, A, D, h0 = k6_random_inputs(dev, gen, shape)
    x, B, C, D = (t.to(torch.bfloat16) for t in (x, B, C, D))
    dy = torch.randn((bb, l, din), generator=gen, device=dev).to(torch.bfloat16)
    dh = torch.randn((bb, din, n), generator=gen, device=dev)
    names = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")
    cases = {}
    for key, state in (("no_state", False), ("with_state", True)):
        args = (x, dt, B, C, A, D, h0 if state else None, dy,
                dh if state else None)
        hs = ssm_kernel.ssm_scan_cuda(*args[:7], states=True)[2]
        got = ssm_kernel.ssm_scan_bwd_cuda(*args, hs)
        again = ssm_kernel.ssm_scan_bwd_cuda(*args, hs)
        torch.cuda.synchronize()
        equal = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
        del again
        want = ssm_scan_bwd_ref(*args)
        errs = {nm: rel_err(g, w) for nm, g, w in zip(names, got, want)
                if w is not None}
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want) if w is not None)
        del got, want
        if not all(e <= K6B_REL[nm] for nm, e in errs.items()) \
                or not equal:
            raise AssertionError(f"K6b at {shape} ({key}): {errs}, bit-equal "
                                 f"{equal}")
        b6b, by6b, w6b = k6b_bound(*args)
        cases[key] = {
            "dtypes": _dtype_names(*args), "work": w6b,
            "max_abs_err": abs_err, "rel_err": errs,
            "max_rel_err": max(errs.values()), "bit_equal": equal,
            "ms": cuda_ms(lambda i: ssm_kernel.ssm_scan_bwd_cuda(*args, hs),
                          iters=10),
            "plain_ms": cuda_ms(lambda i: ssm_scan_bwd_ref(*args), iters=1,
                                warmup=0),
            "library_ms": None, "bound_ms": b6b, "bound_by": by6b,
            "sfu_ms": sfu_ms(bb * l * din * n),
            "k6_forward_ms": cuda_ms(lambda i: ssm_kernel.ssm_scan_cuda(
                *args[:7]), iters=10),
            "k6_forward_with_states_ms": cuda_ms(
                lambda i: ssm_kernel.ssm_scan_cuda(*args[:7], states=True),
                iters=10)}
        del hs
        torch.cuda.empty_cache()
    clusters = -(-din // (ssm_kernel.BWD_CHANNELS * ssm_kernel.BWD_CLUSTER))
    return {"name": "ssm_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:164",
            "shape": f"Bb={bb}, L={l}, Din={din}, N={n}, x, B, C, D, dy "
                     "bf16, no h0 or dh_last (falcon-mamba-7b training, a "
                     "layer)",
            "dims": [bb, l, din, n],
            "tolerance": K6B_REL,
            "tolerance_of": "max_rel_err (max |d| / max |ref| per gradient)",
            **cases["no_state"],
            "scan_kernel": {"ptxas": ptxas_of(build.build_log,
                                              "ssm_scan_bwd_kernel"),
                            **ssm_kernel.bwd_occupancy(n, torch.bfloat16)},
            "partial_bytes": 2 * bb * clusters * l * n * 4,
            "with_state": {"shape": "the same, with h0 and dh_last",
                           **cases["with_state"]}}


def k6b_bound(x, dt, B, C, A, D, h0, dy, dh):
    """K6b's bound on these inputs (``ssm_scan_bwd_work``: each input read
    once and each gradient written once; ``K6B_OPS_*`` f32 operations; and
    its exponentials, one a (position, channel, state), on the SFUs
    (``sfu_ms``), counted as operations) and that work."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    work = ssm_ops.ssm_scan_bwd_work(x, dt, B, C, A, D, h0, dy, dh)
    ms, by = work_bound(work)
    sfu = sfu_ms(work["exponentials"])
    return ((sfu, "operations") if sfu > ms else (ms, by)) + (work,)


def serve_ssm_phase(dev, rng) -> dict:
    """falcon-mamba-7b at full width and depth (random weights from the
    seed): K6 on the path's types from layer 0 of a real admit, then two
    Membership nodes with one Replica each, 16 routed whole-prompt admits,
    16 lockstep rounds fused, then the same unfused.  Returns K6's row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.runtime import Membership
    from repro_torch.serve import Replica, Request, SessionRouter

    cfg = get_config("falcon-mamba-7b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))

    # K6 on layer 0's own scan inputs for a 1024-token prompt
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, K6_SHAPE[1],
                                           dtype=np.int32)).to(dev)[None]
    lay = params["layers"]
    lp0 = {k: t[0] for k, t in lay["mamba"].items()}
    x0 = L.rms_norm(L.embed(params["embed"], prompt, cfg), lay["ln"][0],
                    cfg.norm_eps)
    xs, _, dt_v, Bc, Cc, A, _ = ssm.mamba1_scan_inputs(lp0, x0, cfg)
    k6 = k6_check(dev, xs, dt_v, Bc, Cc, A, lp0["D"])
    del prompt, x0, xs, dt_v, Bc, Cc, A

    # these two nodes' arcs split the 16 sessions 7 / 9: one replica runs
    # the bucketed round (a bucket of 8 of 16 slots), the other the full
    # house (9 rounds up to 16)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
    for i in range(2):
        mem.request_join(f"10.30.0.{i}", 9000)
    router = SessionRouter(mem)
    reqs = [Request(f"ssm-{i}", rng.integers(0, cfg.vocab, int(n),
                                             dtype=np.int32), 16)
            for i, n in enumerate(rng.choice(SSM_PROMPTS, size=16))]
    owner_of = dict(zip([r.session_id for r in reqs],
                        router.route([r.session_id for r in reqs])))
    ssm_ops.ssm_scan.launches = rl_ops.ring_lookup_bucketed.launches = 0

    def run(fused: bool):
        reps = {}
        for node in mem.members():
            reps[node] = Replica(model, slots=16, max_len=2048, device=dev)
            reps[node].attach_params(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = {r.session_id: [reps[owner_of[r.session_id]].admit(r)]
                   for r in reqs}
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        replica_rounds, round_ms = 0, []
        for _ in range(16):
            t0 = time.perf_counter()
            for node, rep in reps.items():
                if not rep.sessions:
                    continue
                route = mem.ring_state.device_bucket_table() if fused else None
                for sid, tok in rep.decode_round(route=route).items():
                    streams[sid].append(tok)
                replica_rounds += 1
                if fused and any(rep.routed_owners[s] != owner_of[s]
                                 or owner_of[s] != node for s in rep.sessions):
                    raise AssertionError("a fused SSM round routed off-owner")
            round_ms.append((time.perf_counter() - t0) * 1e3)
        buckets = sorted(len(rep.sessions) for rep in reps.values())
        del reps
        torch.cuda.empty_cache()
        return streams, prefill_s, round_ms, replica_rounds, buckets

    fused = run(True)
    k2_fused = rl_ops.ring_lookup_bucketed.launches
    unfused = run(False)
    launches = {"K6": ssm_ops.ssm_scan.launches,
                "K2": rl_ops.ring_lookup_bucketed.launches}
    if fused[0] != unfused[0]:
        raise AssertionError("fused and unfused SSM token streams differ")
    toks = np.array([t for s in fused[0].values() for t in s])
    if toks.min() < 0 or toks.max() >= cfg.vocab \
            or any(len(s) != 17 for s in fused[0].values()):
        raise AssertionError("SSM tokens out of range or streams cut short")
    if launches["K6"] != cfg.num_layers * 2 * len(reqs) \
            or launches["K2"] != fused[3] or k2_fused != fused[3]:
        raise AssertionError(f"SSM launch counts {launches} off the main path")
    probe = reqs[0]
    logits, _ = model.prefill(
        params, {"tokens": torch.from_numpy(probe.prompt).to(dev)[None]},
        model.init_cache(1, 2048, device=dev))
    if not bool(torch.isfinite(logits).all()) \
            or int(torch.argmax(logits[0])) != fused[0][probe.session_id][0]:
        raise AssertionError("SSM prefill logits not finite / first token "
                             "differs")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    emit({"phase": "serve_ssm", "model": cfg.name, "params": n_params,
          "layers": cfg.num_layers, "d_inner": ssm.d_inner(cfg),
          "state": cfg.ssm_state, "init_s": init_s,
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "sessions_per_replica": fused[4], "replica_rounds": fused[3],
          "prompt_tokens": prompt_tokens,
          "prefill_tokens_per_s": {"fused": prompt_tokens / fused[1],
                                   "unfused": prompt_tokens / unfused[1]},
          "decode_ms_per_round": {
              "fused_mean": float(np.mean(fused[2][1:])),
              "unfused_mean": float(np.mean(unfused[2][1:])),
              "fused_first": fused[2][0]},
          "launches": launches, "tokens_equal": True,
          "k6_path": k6,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params, model, logits
    torch.cuda.empty_cache()
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:45",
            "shape": k6["shape"] + " (layer 0 of a falcon-mamba-7b admit)",
            "tolerance": {"h": K6_ATOL, "y": k6["y_tolerance"]},
            "launches": launches["K6"],
            **{key: k6[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "library_ms", "bound_ms", "bound_by",
                                        "sfu_ms", "dims", "dtypes", "work")}}


def k4_inputs(dev, seed: int):
    """One launch's worth of pairs at the cell's scale: rings of
    10^6 +- a few hundred live peers, offsets and reporters uniform on
    them, detections across the cell's window, random event keys."""
    import torch
    rng = np.random.default_rng(seed)
    ring = rng.integers(CHURN["n"] - 400, CHURN["n"] + 400, K4_PAIRS,
                        dtype=np.uint64)
    words = (rng.integers(0, ring), ring, rng.integers(0, ring),
             rng.integers(0, 2**32, K4_PAIRS, dtype=np.uint64))
    t0 = rng.uniform(CHURN["warmup"] - 130.0,
                     CHURN["warmup"] + CHURN["duration"], K4_PAIRS)
    offset, n, rep, key = (torch.from_numpy(w.astype(np.uint32).view(
        np.int32)).to(dev) for w in words)
    return offset, n, rep, torch.from_numpy(t0.astype(np.float32)).to(dev), key


def k4_variants() -> dict:
    """K4's keyword arguments in its three variants at the D1HT operating
    point of the churn cell: unbuffered, buffered, early close."""
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.core.sim import _churn_event_stream
    from repro_torch.core.tuning import EdraParams
    cfg = ChurnConfig(**CHURN)
    params = EdraParams.derive(cfg.n, cfg.s_avg, cfg.f)
    t_ev = _churn_event_stream(cfg, np.random.default_rng(cfg.seed))[0]
    fill_rate = t_ev.size / (cfg.warmup + cfg.duration)
    e_cap = float(max(2.0, np.ceil(params.max_events)))
    base = dict(levels=K4_LEVELS, delta_avg=70e-6, seed=cfg.seed)
    return {"unbuffered": dict(base, theta=0.0),
            "buffered": dict(base, theta=params.theta),
            "early_close": dict(base, theta=params.theta,
                                fill_rate=fill_rate, e_cap=e_cap)}


def churn_phase(dev):
    """K4 against its plain version, then the 10^6-peer churn cell for
    D1HT and 1h-Calot.  Returns K4's summary row and the two results."""
    import torch
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.core.sim import simulate_churn
    from repro_torch.kernels.edra_tree import ops as et_ops
    from repro_torch.kernels.edra_tree.ref import tree_math

    t_phase = time.perf_counter()
    variants = k4_variants()
    rows = {}
    for i, (name, kw) in enumerate(variants.items()):
        args = k4_inputs(dev, seed=SEED + i)
        got = et_ops.edra_tree(*args, **kw)
        torch.cuda.synchronize()
        want = tree_math(*args, **kw)
        for g, w, what in zip(got[1:], want[1:],
                              ("ttl", "depth", "parent", "sends")):
            if not torch.equal(g, w):
                raise AssertionError(f"K4 {name}: {what} differs from plain")
        err = float((got[0] - want[0]).abs().max())
        not_equal = int((got[0].view(torch.int32)
                         != want[0].view(torch.int32)).sum())
        if not_equal or not torch.allclose(got[0], want[0], rtol=K4_RTOL,
                                           atol=K4_ATOL):
            raise AssertionError(f"K4 {name}: {not_equal} acks not "
                                 f"bit-equal, off by up to {err}")
        hops = int(got[2].sum())
        variant = 0 if kw["theta"] <= 0 else 2 if "fill_rate" in kw else 1
        ops = K4_PAIRS * (K4_OPS_PAIR + K4_LEVELS * K4_OPS_LEVEL) \
            + hops * K4_OPS_HOP[variant]
        b, by = bound(K4_PAIRS * 40, ops, FP32_FLOPS)
        rows[name] = {
            "max_abs_err": err, "ack_not_bit_equal": not_equal,
            "hops": hops, "operations": ops,
            "ms": cuda_ms(lambda j: et_ops.edra_tree(*args, **kw)),
            "plain_ms": cuda_ms(lambda j: tree_math(*args, **kw), iters=3,
                                warmup=1),
            "bound_ms": b, "bound_by": by}
        del args, got, want
    torch.cuda.empty_cache()
    ec = variants["early_close"]
    emit({"phase": "churn_k4", "pairs": K4_PAIRS, "levels": K4_LEVELS,
          "theta": ec["theta"], "fill_rate": ec["fill_rate"],
          "e_cap": ec["e_cap"], "delta_avg": ec["delta_avg"],
          "variants": rows})

    runs = {}
    for proto in ("d1ht", "calot"):
        et_ops.edra_tree.launches = et_ops.edra_tree.pairs = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = simulate_churn(ChurnConfig(protocol=proto, **CHURN), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, pairs = et_ops.edra_tree.launches, et_ops.edra_tree.pairs
        runs[proto] = (r, launches)
        emit({"phase": "churn", **r.summary(), "mean_ack_s": r.mean_ack_s,
              "p99_ack_s": r.p99_ack_s, "stale_fraction": r.stale_fraction,
              "wall_s": wall, "events_per_s": r.events / wall,
              "pairs": pairs, "k4_launches": launches,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if launches != math.ceil(pairs / K4_PAIRS) or not launches:
            raise AssertionError(f"{proto}: {launches} K4 launches for "
                                 f"{pairs} pairs")
        ratio = r.mean_out_bps / r.analytical_bps
        if r.one_hop_fraction < 0.99 or not 0.5 <= ratio <= 2.0:
            raise AssertionError(f"{proto}: {r.summary()}")
    d1, ca = runs["d1ht"][0], runs["calot"][0]
    if d1.events != ca.events or not ca.mean_out_bps > d1.mean_out_bps:
        raise AssertionError("the churn cell lost the paper's ordering")
    early = rows["early_close"]
    k4 = {"name": "edra_tree", "route": "cuda",
          "source": "src/repro_torch/csrc/edra_tree.cu",
          "replaces": "src/repro/kernels/edra_tree/kernel.py:49",
          "shape": f"P={K4_PAIRS}, levels={K4_LEVELS}, n~{CHURN['n']}, "
                   "early close (D1HT)",
          "tolerance": {"rtol": K4_RTOL, "atol": K4_ATOL},
          "launches": runs["d1ht"][1] + runs["calot"][1],
          "library_ms": None,
          **{key: early[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}}
    emit({"phase": "churn_done", "seconds": time.perf_counter() - t_phase})
    return k4, (d1, ca)


def latency_phase(dev, churn) -> None:
    """Figs 5-6 measured on the card: route times from K1/K2, f' from
    K4's churn plane, the worker service times from local sockets."""
    from repro_torch.dht import latency_sim
    from repro_torch.kernels.ring_lookup import ops as rl_ops

    t_phase = time.perf_counter()
    rl_ops.ring_lookup64.launches = rl_ops.ring_lookup_bucketed.launches = 0
    prof = latency_sim.measure_profile(device=dev)
    rows = []
    for n in LAT_SIZES:
        fp = {p: latency_sim.measured_retry_fraction(n, protocol=p,
                                                     device=dev)
              for p in ("d1ht", "calot")}
        rows.append(latency_sim.latency_point(
            n, busy=False, profile=prof, fprime=fp, drive_kernel=True,
            device=dev))
    d1, ca = churn
    ext = latency_sim.model_extended_point(
        CHURN["n"], busy=False, profile=prof,
        fprime={"d1ht": d1.stale_fraction, "calot": ca.stale_fraction})
    launches = {"K1": rl_ops.ring_lookup64.launches,
                "K2": rl_ops.ring_lookup_bucketed.launches}
    emit({"phase": "latency", "profile": vars(prof),
          "saturation_clients": prof.saturation_clients(),
          "rows": rows + [ext], "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if not launches["K1"] or not launches["K2"]:
        raise AssertionError(f"route timing skipped a kernel: {launches}")
    d1_means = [r["systems"]["d1ht"]["mean_ms"] for r in rows]
    if max(d1_means) > 1.1 * min(d1_means):
        raise AssertionError(f"D1HT latency not flat in n: {d1_means}")
    for r in rows:
        s = r["systems"]
        checked = s if r["sub_saturation"] else \
            {k: s[k] for k in ("d1ht", "calot", "pastry")}
        for name, st in checked.items():
            if not 0.7 <= st["ratio_measured_over_model"] <= 1.4:
                raise AssertionError(f"n={r['n']} {name}: {st}")
        # below saturation the directory server keeps up (< 1.5x D1HT),
        # so a 5x gap can only show on a row past the measured knee
        slow = s["dserver"]["mean_ms"] / s["d1ht"]["mean_ms"]
        if r["sub_saturation"] and slow >= 1.5:
            raise AssertionError(f"n={r['n']}: dserver {slow:.2f}x D1HT")


def k7_phase(dev, ids) -> dict:
    """K7 on the sorted high words of the 10^6 peer ids against its plain
    version and numpy on both routes (``kernel.k7_route`` picks one level
    up to ``K7_SAMPLE_KEYS`` keys, the shared-memory sample tree above;
    each case runs on both), the boundary and small-table cases, a table
    view off a 16-byte boundary, the empty table; times in turns against
    ``torch.searchsorted`` at Q 2^20 and at the quickstart's Q 4096, and
    bounds.  Returns K7's row (launches set later, from the quickstart's
    run)."""
    import torch
    from repro_torch.kernels.ring_lookup import kernel as rl_kernel
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ring_lookup.ref import ring_lookup_ref

    def dev_words(words, offset=0):
        buf = np.zeros(words.size + offset, np.uint32)
        buf[offset:] = words
        return torch.from_numpy(buf.view(np.int32)).to(dev)[offset:]

    fn7 = rl_ops.ring_lookup
    routes = {}

    def check(keys_np, table_np, what, offset=0):
        """The wrapper's route for this Q (its counter moves by one), then
        the other route through the launcher directly (no count): both
        equal the plain version and numpy."""
        kt, tt = dev_words(keys_np), dev_words(table_np, offset)
        route = rl_kernel.k7_route(keys_np.size)
        other, = set(rl_kernel.K7_ROUTES) - {route}
        before = fn7.one_level_launches, fn7.sampled_launches
        got = fn7(kt, tt)
        moved = (fn7.one_level_launches - before[0],
                 fn7.sampled_launches - before[1])
        if moved != ((1, 0) if route == "one_level" else (0, 1)):
            raise AssertionError(f"K7 {what}: route counters moved {moved}")
        also = rl_kernel.ring_lookup_cuda(kt, tt, other)
        torch.cuda.synchronize()
        plain = ring_lookup_ref(kt, tt)
        want = np.searchsorted(table_np, keys_np, side="left") % table_np.size
        err = 0
        for name, out in ((route, got), (other, also)):
            e = int((out.long() - plain.long()).abs().max()) \
                if out.numel() else 0
            if e or not np.array_equal(out.cpu().numpy(), want):
                raise AssertionError(f"K7 {what}: the {name} route disagrees "
                                     "with its plain version / numpy")
            err = max(err, e)
        routes[what] = (f"{route}, Q={keys_np.size}, N={table_np.size} "
                        f"(the {other} route checked too)")
        return kt, tt, err

    table = np.sort((ids >> np.uint64(32)).astype(np.uint32))
    n = table.size
    keys = np.random.default_rng(SEED + 7).integers(0, 2**32, K7_KEYS,
                                                    dtype=np.uint32)
    cross = rl_kernel.K7_SAMPLE_KEYS
    kt, tt, err = check(keys, table, f"Q={K7_KEYS}, N={n}")
    for q in (4096, cross, cross + 1):
        err = max(err, check(keys[:q], table, f"Q={q}")[2])
    err = max(err, check(keys, table, "table 4 bytes off a 16-byte "
                                      "boundary", offset=1)[2])
    small = {"N=1": table[:1], "N=7": table[::n // 7][:7],
             "N=7 with duplicates": np.sort(np.repeat(table[:3], 3)[:7])}
    boundary = {}
    for what, tbl in [("N=10^6", table)] + list(small.items()):
        ends = np.array([0, 2**32 - 1], np.uint32)
        bkeys = np.concatenate([tbl, tbl + np.uint32(1), tbl - np.uint32(1),
                                ends]).astype(np.uint32)
        err = max(err, check(bkeys, tbl, f"boundary keys, {what}")[2])
        boundary[what] = int(bkeys.size)
    try:
        fn7(kt[:4], tt[:0])
    except LookupError:
        pass
    else:
        raise AssertionError("K7 took an empty table")
    table64 = tt.long() & 0xFFFFFFFF
    keys64 = kt.long() & 0xFFFFFFFF

    b7, by7 = k7_bound(keys, table)
    kt4, keys4 = kt[:4096], keys64[:4096]
    b4, by4 = k7_bound(keys[:4096], table)
    row = {"name": "ring_lookup", "route": "cuda",
           "source": "src/repro_torch/csrc/ring_lookup.cu",
           "replaces": "src/repro/kernels/ring_lookup/kernel.py:60",
           "shape": f"Q={K7_KEYS}, N={n} (high words of the 10^6 peer ids)",
           "kernel_route": rl_kernel.k7_route(K7_KEYS),
           "crossover_q": cross, "routes_per_case": routes,
           "max_abs_err": err, "tolerance": 0,
           **in_turns(lambda i: fn7(kt, tt),
                      lambda i: torch.searchsorted(table64, keys64) % n),
           "plain_ms": cuda_ms(lambda i: ring_lookup_ref(kt, tt)),
           "bound_ms": b7, "bound_by": by7,
           "q4096": {"shape": "Q=4096 (the quickstart's step 5)",
                     "kernel_route": rl_kernel.k7_route(4096),
                     **in_turns(lambda i: fn7(kt4, tt),
                                lambda i: torch.searchsorted(table64,
                                                             keys4) % n),
                     "plain_ms": cuda_ms(lambda i: ring_lookup_ref(kt4, tt)),
                     "bound_ms": b4, "bound_by": by4}}
    emit({"phase": "k7", **row,
          "duplicate_words": int(n - np.unique(table).size),
          "boundary_keys": boundary, "empty_table": "LookupError"})
    return row


def quickstart_phase(dev) -> int:
    """``repro_torch.quickstart`` on the card: one K7 launch in step 5,
    whose indices equal the plain version's on the CPU.  Returns K7's
    launches in that run."""
    import torch
    from repro_torch import quickstart
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ring_lookup.ref import ring_lookup_ref

    lines = []
    fn7 = rl_ops.ring_lookup
    fn7.launches = fn7.one_level_launches = fn7.sampled_launches = 0
    t0 = time.perf_counter()
    res = quickstart.run(dev, out=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fn7.launches
    plain = ring_lookup_ref(torch.from_numpy(res["keys"].view(np.int32)),
                            torch.from_numpy(res["table"].view(np.int32)))
    idx = res["idx"].cpu()
    emit({"phase": "quickstart", "lines": lines, "k7_launches": launches,
          "k7_launches_by_route": {"one_level": fn7.one_level_launches,
                                   "sampled": fn7.sampled_launches},
          "first5": idx[:5].tolist(), "first5_plain": plain[:5].tolist(),
          "wall_s": wall})
    if launches != 1:
        raise AssertionError(f"quickstart step 5 made {launches} K7 launches")
    if not torch.equal(idx, plain):
        raise AssertionError("quickstart step 5 differs from the plain version")
    return launches


def des_twin_phase(dev) -> int:
    """The message-level DES (host) against ``simulate_churn`` on the card
    at repro's twin configurations, within repro's twin tolerances.
    Returns K4's launches in the two card runs."""
    import torch
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.core.sim import simulate_churn
    from repro_torch.dht import run_churn
    from repro_torch.kernels.edra_tree import ops as et_ops

    k4 = 0
    for proto, (kw, (lo, hi), gap) in DES_TWIN.items():
        cfg = ChurnConfig(**kw)
        t0 = time.perf_counter()
        des = run_churn(cfg)
        des_s = time.perf_counter() - t0
        et_ops.edra_tree.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vec = simulate_churn(cfg, device=dev)
        torch.cuda.synchronize()
        vec_s = time.perf_counter() - t0
        launches = et_ops.edra_tree.launches
        k4 += launches
        ratio = vec.mean_out_bps / des.mean_out_bps
        one_hop_gap = abs(vec.one_hop_fraction - des.one_hop_fraction)
        emit({"phase": "des_twin", "protocol": proto, "n": cfg.n,
              "des_wall_s": des_s, "des_events": des.events,
              "des_mean_out_bps": des.mean_out_bps,
              "des_ratio_sim_over_model": des.mean_out_bps / des.analytical_bps,
              "des_one_hop": des.one_hop_fraction,
              "card_wall_s": vec_s, "card_events": vec.events,
              "card_mean_out_bps": vec.mean_out_bps,
              "card_one_hop": vec.one_hop_fraction,
              "analytical_bps": des.analytical_bps,
              "card_over_des_bps": ratio, "one_hop_gap": one_hop_gap,
              "band": [lo, hi], "max_one_hop_gap": gap, "k4_launches": launches})
        if not launches:
            raise AssertionError(f"des_twin {proto}: simulate_churn made no "
                                 "K4 launch")
        if not lo <= ratio <= hi or one_hop_gap > gap:
            raise AssertionError(f"des_twin {proto}: DES {des.summary()} "
                                 f"against the card {vec.summary()}")
        if proto == "d1ht" and min(des.one_hop_fraction,
                                   vec.one_hop_fraction) < 0.99:
            raise AssertionError("des_twin d1ht: one-hop below 0.99")
    return k4


def tp_cluster_phase(dev, model, params, shape=TP_CLUSTER) -> dict:
    """qwen2.5-3b at full size through ``ServeCluster(tp=2)`` on the one
    card (see the module docstring): four groups of two shards carved
    from eight entries of ``cuda:0``, a node failure with per-shard
    handoffs, then the loss of one device of a live group.  A tp = 1 run
    with the same membership events goes first and is freed before it.
    Counters are zeroed just before the gated tp = 2 run (which ends with
    ``whole`` whole-prompt admits on a group) and read just after; K3
    and K5 are then held against their plain versions on the calls that
    run recorded.  Returns the launches by kernel."""
    import torch
    from repro_torch import tp_cluster
    from repro_torch.dht.data import unpack_array
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.models import layers
    from repro_torch.models.transformer import concat_kv_heads
    from repro_torch.serve import Replica, Request, server
    cfg, c, tp = model.cfg, shape["chunk"], 2
    rng = np.random.default_rng([SEED, 22])
    reqs = [Request(f"tp-{i}", rng.integers(0, cfg.vocab, int(n),
                                            dtype=np.int32), shape["max_new"])
            for i, n in enumerate(rng.integers(
                shape["prompt"][0], shape["prompt"][1] + 1,
                size=shape["sessions"]))]
    sids = [r.session_id for r in reqs]
    kw = dict(slots=shape["slots"], max_len=shape["max_len"],
              prefill_chunk=c, steps=shape["rounds"], mirror_loss=True)

    # the memory, reckoned before the runs
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    kv_token = 2 * cfg.num_layers * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    kv_replica = kv_token * shape["slots"] * shape["max_len"]
    reckoned = {"weights_gib": weight_bytes / 2**30,
                "four_groups_gib": 4 * weight_bytes / 2**30,
                "kv_bytes_per_token": kv_token,
                "kv_gb_per_replica": kv_replica / 1e9,
                "peak_gib": (5 * weight_bytes + 4 * kv_replica) / 2**30}
    emit({"phase": "tp_cluster_reckoning", **reckoned})

    # tp = 1 with the same events: its tokens and its cache bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base, st1, cl1 = tp_cluster.run(model, params, reqs, 1, dev, **kw)
    torch.cuda.synchronize()
    tp1_s = time.perf_counter() - t0
    tp1_peak = torch.cuda.max_memory_allocated()
    kv1 = sum(t.numel() * t.element_size()
              for t in next(iter(cl1.replicas.values())).cache.values())
    del cl1
    gc.collect()
    torch.cuda.empty_cache()

    notes = {"k1_batches": 0, "round_ms": [], "group_rounds": []}

    def routed(cluster):
        # the submit batch through the router: one K1 launch
        notes["routed"] = dict(zip(sids, cluster.router.route(sids)))
        notes["k1_batches"] += 1

    def submitted(cluster):
        rep = next(iter(cluster.replicas.values()))
        notes["per_shard_kv"] = rep.group.per_shard_cache_bytes(rep.cache)
        inner = cluster.step

        def timed():
            busy = sum(1 for r in cluster.replicas.values() if r.sessions)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner()
            torch.cuda.synchronize()
            notes["round_ms"].append((time.perf_counter() - t) * 1e3)
            notes["group_rounds"].append(busy)
            return out
        cluster.step = timed

    def donor_slabs(cluster, victim):
        """The victim's live sessions: chunks exported, chunks a handoff
        fetches, each chunk's per-shard rows and its full export."""
        rep = cluster.replicas[victim]
        g, out = rep.group, {}
        for rec in cluster.live_sessions:
            if rec.owner != victim:
                continue
            s = len(rec.prompt) + len(rec.generated)
            covered = min(rec.exported_chunks, (s - 1) // c)
            slot = rep.sessions[rec.session_id]
            out[rec.session_id] = (rec.exported_chunks, covered, [
                [slab_bytes(rep.cache[i], slot, j * c, (j + 1) * c)
                 for i in range(g.tp)] for j in range(covered)], [
                g.export_kv_block(rep.cache, slot, j * c, c).tobytes()
                for j in range(covered)])
        return out

    def before(cluster, victim, leg):
        notes[leg] = {"victim": victim,
                      "sessions": donor_slabs(cluster, victim),
                      "counts": (cluster.handoffs, cluster.handoff_misses,
                                 cluster.handoff_chunks)}

    def after(cluster, leg):
        info = notes[leg]
        moved = sorted(info["sessions"])
        h, m, ch = (a - b for a, b in zip(
            (cluster.handoffs, cluster.handoff_misses,
             cluster.handoff_chunks), info["counts"]))
        want_ch = sum(cov for _, cov, _, _ in info["sessions"].values())
        if not (h == len(moved) >= 1 and m == 0 and ch == want_ch):
            raise AssertionError(f"{leg}: handoffs {h} of {len(moved)}, "
                                 f"misses {m}, chunks {ch} (want {want_ch})")
        for sid in moved:
            _, covered, shards, full = info["sessions"][sid]
            rec = cluster.sessions[sid]
            rep = cluster.replicas[rec.owner]
            slot = rep.sessions[sid]
            for j in range(covered):
                got = [unpack_array(cluster.blocks.get(
                    cluster._block_name(sid, j, i))) for i in range(tp)]
                if [b.tobytes() for b in got] != shards[j]:
                    raise AssertionError(f"{sid} chunk {j}: a stored shard "
                                         "differs from the donor's kv-head "
                                         "slice")
                if concat_kv_heads(got).tobytes() != full[j]:
                    raise AssertionError(f"{sid} chunk {j}: the reassembled "
                                         "slab differs from the full export")
                if [slab_bytes(rep.cache[i], slot, j * c, (j + 1) * c)
                        for i in range(tp)] != shards[j]:
                    raise AssertionError(f"{sid} chunk {j}: imported rows "
                                         "differ from the shards")
            if rec.owner == info["victim"] or rec.owner not in \
                    cluster.state.replica_set(rec.key, 2):
                raise AssertionError(f"{sid} re-homed off its replica set")
        # the re-home batch through the router: one K1 launch
        cluster.router.route(moved)
        notes["k1_batches"] += 1
        info.update(moved=moved, handoffs=h, chunks=ch)

    def before_fail(cluster):
        before(cluster, cluster.sessions[sids[0]].owner, "fail")

    def before_loss(cluster):
        before(cluster, next(iter(cluster.replicas)), "loss")

    # the gated run: counters zeroed just before, read just after
    rec3, rec5, rows = {}, {}, [0]
    op3, op5, op_rows = layers._decode_op, layers._flash_op, \
        server._decode_rows

    def recording3(q, k, v, length):
        if q.shape[0] not in rec3:
            rec3[q.shape[0]] = tuple(t.clone() for t in (q, k, v, length))
        return op3(q, k, v, length)

    def recording5(q, k, v, causal):
        if q.shape[1] not in rec5:
            rec5[q.shape[1]] = tuple(t.clone() for t in (q, k, v))
        return op5(q, k, v, causal=causal)

    def counting_rows(*a, **k):
        rows[0] += 1
        return op_rows(*a, **k)

    for fn in (rl_ops.ring_lookup64, rl_ops.ring_lookup_bucketed,
               da_ops.decode_attention, fa_ops.flash_attention):
        fn.launches = 0
    da_ops.decode_attention.tc_launches = 0
    fa_ops.flash_attention.tc_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    layers._decode_op, layers._flash_op = recording3, recording5
    server._decode_rows = counting_rows
    t0 = time.perf_counter()
    try:
        toks, st2, cluster = tp_cluster.run(
            model, params, reqs, tp, dev, **kw, hooks={
                "routed": routed, "submitted": submitted,
                "before_fail": before_fail,
                "after_fail": lambda cl: after(cl, "fail"),
                "before_loss": before_loss,
                "after_loss": lambda cl: after(cl, "loss")})
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        # whole-prompt admits on a live group: K5 at the shard's heads
        gi = next(i for i in range(len(cluster._group_devices))
                  if i not in cluster._dead_groups)
        group = cluster._group_obj(gi)
        whole = Replica(model, slots=shape["whole"],
                        max_len=shape["max_len"], prefill_chunk=None,
                        group=group)
        whole.attach_params(cluster._params_for(gi))
        t0 = time.perf_counter()
        firsts = {r.session_id: whole.admit(r) for r in reqs[:shape["whole"]]}
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        group_ms = []
        for _ in range(4):
            t = time.perf_counter()
            whole.decode_round()
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        layers._decode_op, layers._flash_op = op3, op5
        server._decode_rows = op_rows
    launches = {"K1": rl_ops.ring_lookup64.launches,
                "K2": rl_ops.ring_lookup_bucketed.launches,
                "K3": da_ops.decode_attention.launches,
                "K3_tc": da_ops.decode_attention.tc_launches,
                "K5": fa_ops.flash_attention.launches,
                "K5_tc": fa_ops.flash_attention.tc_launches}
    peak = torch.cuda.max_memory_allocated()
    sharded = len(cluster._group_objs)     # groups whose weights were cut
    # gates: the cluster's, the shards' bytes, the launches
    lost = [s for s in sids if len(cluster.sessions[s].generated)
            != shape["max_new"]]
    if lost or st2["live"] or cluster.pending_migrations:
        raise AssertionError(f"tp_cluster: sessions lost: {lost}")
    if st2["dead_groups"] != 1 or st2["migrated"] < 2 \
            or st2["handoffs"] < 1 or st2["handoff_misses"]:
        raise AssertionError(f"tp_cluster stats {st2}")
    if notes["per_shard_kv"] * tp != kv1:
        raise AssertionError(f"a shard holds {notes['per_shard_kv']} B of KV "
                             f"against tp = 1's {kv1}")
    want3 = cfg.num_layers * rows[0]
    want5 = cfg.num_layers * tp * shape["whole"]
    if launches["K3"] != want3 or launches["K3_tc"] != want3 \
            or launches["K5"] != want5 or launches["K5_tc"] != want5 \
            or launches["K1"] != notes["k1_batches"] or launches["K2"]:
        raise AssertionError(f"tp_cluster launch counts {launches}: want K3 "
                             f"{want3}, K5 {want5}, K1 {notes['k1_batches']}"
                             ", K2 0")
    errs = {"K3": {}, "K5": {}}
    for b, (q, k, v, length) in sorted(rec3.items()):
        if (q.shape[1], k.shape[2], q.shape[2]) != TP_HEADS:
            raise AssertionError(f"K3 ran at {q.shape} / {k.shape}")
        got = da_ops.decode_attention(q, k, v, length)
        errs["K3"][b] = float((got.float() - decode_attention_ref(
            q, k, v, length).float()).abs().max())
    for sq, (q, k, v) in sorted(rec5.items()):
        if (q.shape[2], k.shape[2], q.shape[3]) != TP_HEADS:
            raise AssertionError(f"K5 ran at {q.shape} / {k.shape}")
        got = fa_ops.flash_attention(q, k, v, causal=True)
        errs["K5"][sq] = float((got.float() - flash_attention_ref(
            q, k, v, causal=True).float()).abs().max())
    if not errs["K3"] or not errs["K5"] \
            or max(errs["K3"].values()) > BF16_ATOL \
            or max(errs["K5"].values()) > K5_TOL["bfloat16"]:
        raise AssertionError(f"tp_cluster kernels against plain: {errs}")
    # where a group round's host time goes: the same 4 sessions' rounds on
    # a tp = 1 replica, and the group's 73 psums a forward (embedding, and
    # wo and w2 in each of 36 layers) on a 16-element tensor
    one = Replica(model, slots=shape["whole"], max_len=shape["max_len"],
                  prefill_chunk=None, device=dev)
    one.attach_params(params)
    for r in reqs[:shape["whole"]]:
        one.admit(r)
    tp1_ms = []
    for _ in range(4):
        t = time.perf_counter()
        one.decode_round()
        torch.cuda.synchronize()
        tp1_ms.append((time.perf_counter() - t) * 1e3)
    from repro_torch.sharding.specs import psum_tp
    x = torch.zeros(16, device=dev)
    psums = 1 + 2 * cfg.num_layers
    group.map(lambda i: [psum_tp(x) for _ in range(psums)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    group.map(lambda i: [psum_tp(x) for _ in range(psums)])
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t) * 1e3
    del whole, one, cluster, rec3, rec5
    gc.collect()
    torch.cuda.empty_cache()

    # the first decode step's logits, tp = 2 against tp = 1 (whole prompt)
    from repro_torch.models.tp import TPReplicaGroup
    g = TPReplicaGroup(model, [dev, dev])
    sp = g.shard_params(params)
    r = reqs[0]
    batch = {"tokens": torch.from_numpy(r.prompt).to(dev)[None]}
    l1, c1 = model.prefill(params, batch, model.init_cache(
        1, shape["max_len"], device=dev))
    l2, c2 = g.prefill(sp, batch, g.init_cache(1, shape["max_len"]))
    nxt = torch.argmax(l1, dim=-1).to(torch.int32)[:, None]
    d1, _ = model.decode_step(params, c1, nxt, len(r.prompt))
    d2, _ = g.decode_step(sp, c2, nxt, len(r.prompt))
    dlogit = float((d1 - d2).abs().max())
    scale = float(d1.abs().max())
    first_same = int(torch.argmax(l1)) == int(torch.argmax(l2))
    del g, sp, c1, c2
    gc.collect()
    torch.cuda.empty_cache()
    if not dlogit <= TP_LOGIT_SHARE * scale:
        raise AssertionError(f"tp = 2 decode logits {dlogit} off tp = 1's "
                             f"(max |logit| {scale})")
    agree = sum(a == b for s in sids for a, b in zip(base[s], toks[s]))
    same = sum(base[s] == toks[s] for s in sids)
    per_round = [ms / max(n, 1) for ms, n in zip(notes["round_ms"],
                                                  notes["group_rounds"])]
    emit({"phase": "tp_cluster", "model": cfg.name, "layers": cfg.num_layers,
          "tp": tp, "groups": st2["groups"], "sharded_groups": sharded,
          "nodes": 4,
          "pool": "8 x cuda:0", "slots": shape["slots"],
          "max_len": shape["max_len"], "prefill_chunk": c,
          "sessions": len(reqs),
          "prompt_tokens": sum(len(r.prompt) for r in reqs),
          "max_new_tokens": shape["max_new"],
          "rounds_before_failure": shape["rounds"],
          "failed_node_sessions": len(notes["fail"]["moved"]),
          "lost_group_sessions": len(notes["loss"]["moved"]),
          "handoffs_fail_loss": [notes["fail"]["handoffs"],
                                 notes["loss"]["handoffs"]],
          "handoff_chunks_fail_loss": [notes["fail"]["chunks"],
                                       notes["loss"]["chunks"]],
          "stats": st2, "stats_tp1": st1,
          "kv_bytes_per_shard": notes["per_shard_kv"],
          "kv_bytes_tp1_replica": kv1, "launches": launches,
          "group_decode_rows_calls": rows[0],
          "kernels_vs_plain_max_abs_err": errs,
          "first_step_max_abs_dlogit": dlogit,
          "first_step_max_abs_logit": scale,
          "first_step_bound": TP_LOGIT_SHARE * scale,
          "first_token_equal": first_same,
          "ms_per_cluster_round": {"mean": float(np.mean(notes["round_ms"])),
                                   "median": float(np.median(
                                       notes["round_ms"])),
                                   "rounds": len(notes["round_ms"])},
          "ms_per_group_round_mean": float(np.mean(per_round)),
          "whole_prompt_admits": shape["whole"], "whole_prompt_s": whole_s,
          "round_ms_b4": {"group": group_ms, "tp1": tp1_ms,
                          "group_median": float(np.median(group_ms[1:])),
                          "tp1_median": float(np.median(tp1_ms[1:]))},
          "psums_per_forward": psums,
          "psums_of_a_forward_ms": psum_ms,
          "whole_first_tokens_equal_to_tp1_stream": sum(
              firsts[s] == base[s][0] for s in firsts),
          "tokens_equal_to_tp1_run": f"{agree}/{len(sids) * shape['max_new']}",
          "sessions_equal_to_tp1_run": f"{same}/{len(sids)}",
          "tp1_run_s": tp1_s, "tp1_peak_gib": tp1_peak / 2**30,
          "tp2_run_s": run_s, "max_memory_allocated": peak,
          "max_memory_allocated_gib": peak / 2**30,
          "reckoned_peak_gib": reckoned["peak_gib"]})
    return launches


def tp_parity_phase(dev) -> None:
    """The scenario of ``examples/tp_cluster.py`` (6 sessions of 40
    tokens, 8 new, a node failure and a device loss; tp = 1 fails the
    same two nodes) on qwen2.5-3b at full width, depth cut to
    ``TP_PARITY_LAYERS``, in f32: the example's gates but token equality,
    and every token stream equal to tp = 1's except where tp = 1's top-2
    logit gap at the first divergent step is at most the max |Δlogit|
    between tp = 1 and tp = 2 there (recomputed teacher-forced)."""
    import torch
    from repro_torch import tp_cluster
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.tp import TPReplicaGroup
    cfg = get_config("qwen2.5-3b").with_overrides(
        num_layers=TP_PARITY_LAYERS, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    reqs = tp_cluster.requests(cfg)
    t0 = time.perf_counter()
    base, st1, cl = tp_cluster.run(model, params, reqs, 1, dev,
                                   mirror_loss=True)
    del cl
    toks, st2, cl = tp_cluster.run(model, params, reqs, 2, dev)
    del cl
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    faults = [f for f in tp_cluster.check(base, toks, st2)
              if not f.startswith("tp=2 token streams")]
    if faults:
        raise AssertionError(f"tp_parity: {faults}")
    g = TPReplicaGroup(model, [dev, dev])
    sp = g.shard_params(params)
    flips = []
    for r in reqs:
        a, b = base[r.session_id], toks[r.session_id]
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        seq = np.concatenate([r.prompt, np.asarray(a[:t], np.int32)])
        batch = {"tokens": torch.from_numpy(seq).to(dev)[None]}
        l1, _ = model.prefill(params, batch, model.init_cache(1, 64,
                                                              device=dev))
        l2, _ = g.prefill(sp, batch, g.init_cache(1, 64))
        top = torch.topk(l1[0], 2).values
        flips.append({"session": r.session_id, "step": t,
                      "tp1_top2_gap": float(top[0] - top[1]),
                      "max_abs_dlogit": float((l1 - l2).abs().max())})
    r = reqs[0]
    batch = {"tokens": torch.from_numpy(r.prompt).to(dev)[None]}
    l1, _ = model.prefill(params, batch, model.init_cache(1, 64, device=dev))
    l2, _ = g.prefill(sp, batch, g.init_cache(1, 64))
    admit_dlogit = float((l1 - l2).abs().max())
    same = sum(base[s] == toks[s] for s in base)
    emit({"phase": "tp_parity", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "sessions": len(reqs),
          "sessions_equal": f"{same}/{len(reqs)}", "flips": flips,
          "admit_max_abs_dlogit": admit_dlogit, "stats": st2,
          "stats_tp1": st1, "wall_s": wall})
    bad = [f for f in flips if f["tp1_top2_gap"] > f["max_abs_dlogit"]]
    if bad:
        raise AssertionError(f"tp_parity: tokens flipped where tp = 1's top-2 "
                             f"gap exceeds |dlogit|: {bad}")
    del g, sp, params
    gc.collect()
    torch.cuda.empty_cache()


def dht_cluster_phase(dev) -> int:
    """``repro_torch.dht_cluster`` with the ring's tables on the card: the
    example's gates (no block lost, torn or stale, every block on 3 live
    replicas) and the blocks' owners resolved on the card equal to the
    host's.  Returns K1's launches in that run."""
    import torch
    from repro_torch import dht_cluster
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    lines = []
    rl_ops.ring_lookup64.launches = 0
    t0 = time.perf_counter()
    out = dht_cluster.run(dev, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rl_ops.ring_lookup64.launches
    emit({"phase": "dht_cluster", "lines": lines, "k1_launches": launches,
          **{k: out[k] for k in ("ok", "nodes", "members", "device",
                                 "first_plan", "plan", "dropped",
                                 "generation", "stale_peers", "bad_blocks",
                                 "min_replicas", "upload_bytes", "repair",
                                 "owners_equal")}, "wall_s": wall})
    if not out["ok"] or not out["device"].startswith("cuda") \
            or out["min_replicas"] < dht_cluster.REPLICATION or launches < 1:
        raise AssertionError(f"dht_cluster: {out}, K1 {launches}")
    return launches


def _zero_k5(fn) -> None:
    for name in ("launches", "tc_launches", "simt_launches", "bwd_launches",
                 "bwd_tc_launches"):
        setattr(fn, name, 0)


def _k5_counts(fn) -> dict:
    return {"K5": fn.launches, "K5_tc": fn.tc_launches,
            "K5b": fn.bwd_launches, "K5b_tc": fn.bwd_tc_launches}


def _value_and_grad(model, params, batch):
    """(loss, [gradient of each leaf]) of ``model.train_loss``."""
    import torch
    leaves = list(_leaves(params))
    xs = [t.detach().requires_grad_() for t in leaves]
    it = iter(xs)

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) \
            else next(it)
    loss = model.train_loss(tree(params), batch)
    return loss.detach(), torch.autograd.grad(loss, xs)


@contextlib.contextmanager
def _routing(layers, replay=None):
    """Record the expert ids of every ``layers._top_k`` call (the MoE
    router's) in a list, yielded; given ``replay`` (such a list), return
    those ids in call order instead, each with its probabilities (so the
    gate weights keep their gradient)."""
    real, calls = layers._top_k, []

    def top_k(probs, k):
        if replay is None:
            vals, ids = real(probs, k)
        else:
            ids = replay[len(calls)]
            vals = probs.gather(-1, ids)
        calls.append(ids)
        return vals, ids
    layers._top_k = top_k
    try:
        yield calls
    finally:
        layers._top_k = real


def _plain_flash_fn():
    """``FlashAttentionFn`` with the kernels' plain versions on any device
    (the reference of the train gate; the port never runs it on the
    card)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)

    class PlainFlashAttentionFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            o, lse = flash_attention_fwd_ref(q, k, v, causal=causal)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            return (*flash_attention_bwd_ref(*ctx.saved_tensors, do,
                                             causal=ctx.causal), None)
    return PlainFlashAttentionFn


def train_phase(dev) -> dict:
    """qwen2.5-3b at full size training on the card: AdamW steps through
    ``make_train_step``, the launch gate, the kernels-against-plain gate at
    ``TRAIN_GATE_LAYERS`` layers; returns the K5 / K5b counts of the timed
    steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import Model
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config("qwen2.5-3b")
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        raise AssertionError(f"qwen2.5-3b trains with remat {cfg.remat}, "
                             f"{cfg.dtype}")
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    opt_cfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, total_steps=1000)
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(model, TrainConfig(opt=opt_cfg))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fn = fa_ops.flash_attention
    _zero_k5(fn)
    mets, times, first = [], [], None
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mets.append(met)
        if i == 0:
            first = _k5_counts(fn)
    counts = _k5_counts(fn)
    per_step = {"K5": 2 * cfg.num_layers, "K5_tc": 2 * cfg.num_layers,
                "K5b": cfg.num_layers, "K5b_tc": cfg.num_layers}
    if first != per_step or counts != {k: n * (1 + TRAIN_STEPS)
                                       for k, n in per_step.items()}:
        raise AssertionError(f"train: launch counts {first} in the first "
                             f"step, {counts} in all, want {per_step} a step")
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    dev_ms = {"K5": 0.0, "K5b": 0.0, "all": 0.0}
    for row in prof.key_averages():
        ms = row.self_device_time_total / 1e3
        dev_ms["all"] += ms
        if "flash_tc_kernel<" in row.key or "flash_kernel<" in row.key:
            dev_ms["K5"] += ms
        elif any(name in row.key for name in K5B_KERNELS):
            dev_ms["K5b"] += ms
    step_s = float(np.median(times[1:]))
    del params, opt, met, mets, step
    gc.collect()
    torch.cuda.empty_cache()

    # the gate at full width and TRAIN_GATE_LAYERS layers: one step's loss
    # and gradients with the kernels against FlashAttentionFn on the plain
    # versions (no kernel may launch there)
    cfg2 = cfg.with_overrides(num_layers=TRAIN_GATE_LAYERS)
    model2 = Model(cfg2)
    params2 = model2.init(torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    loss_k, grads_k = _value_and_grad(model2, params2, batch)
    launched = _k5_counts(fn)
    saved = layers.FlashAttentionFn
    layers.FlashAttentionFn = _plain_flash_fn()
    try:
        loss_p, grads_p = _value_and_grad(model2, params2, batch)
    finally:
        layers.FlashAttentionFn = saved
    if _k5_counts(fn) != launched:
        raise AssertionError("train gate: a kernel ran in the plain step")
    names = [n for n, _ in _paths(params2)]
    leaf_errs = {n: rel_err(gk, gp) for n, gk, gp in zip(names, grads_k,
                                                         grads_p)}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(leaf_errs, key=leaf_errs.get)
    if not loss_rel <= TRAIN_LOSS_RTOL \
            or not leaf_errs[worst] <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"train gate: loss {float(loss_k)} vs "
                             f"{float(loss_p)}, worst leaf {worst} "
                             f"{leaf_errs[worst]}")
    del params2, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train", "model": cfg.name, "params": n_params,
          "layers": cfg.num_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "remat": cfg.remat, "dtype": cfg.dtype, "losses": losses,
          "grad_norms": norms, "step_ms": [t * 1e3 for t in times],
          "ms_per_step_median": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "model_flops_share_of_bf16_peak": 6 * n_params * tokens / step_s
          / BF16_FLOPS,
          "max_memory_allocated_gib": peak / 2**30,
          "device_ms_per_step": dev_ms, "launches_per_step": first,
          "launches": counts,
          "gate": {"layers": TRAIN_GATE_LAYERS, "loss_kernels": float(loss_k),
                   "loss_plain": float(loss_p), "loss_rel": loss_rel,
                   "loss_rtol": TRAIN_LOSS_RTOL, "worst_leaf": worst,
                   "worst_leaf_rel_err": leaf_errs[worst],
                   "bound": TRAIN_GRAD_BOUND},
          "nvidia_smi": _smi()})
    return counts


def train_mla_phase(dev) -> dict:
    """deepseek-v2 (MLA: q . k 192, v 128) at full width and ``TRAIN_MLA``
    depth: ``train_loss`` and its gradients through K5 and K5b on the card,
    timed; the launch gate; the same step against ``FlashAttentionFn`` on
    the plain versions; then one ``make_train_step`` step (AdamW in
    pieces).  Returns the K5 / K5b counts of the timed passes, and the
    step's under ``"step"``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import Model
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step

    t = TRAIN_MLA
    cfg = get_config(t["arch"]).with_overrides(num_layers=t["layers"])
    dqk = cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
    dv = cfg.mla_v_head_dim
    if cfg.dtype != "bfloat16" or (dqk, dv) != (192, 128) \
            or fa_kernel.bwd_route(torch.bfloat16, dqk, dv) != "tc":
        raise AssertionError(f"{cfg.name}: {cfg.dtype} at q.k {dqk} / v {dv}")
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    n_params = sum(x.numel() for x in _leaves(params))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t["seq"],
                                  global_batch=t["batch"], seed=SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    # a layer runs K5 in its forward and, under remat, again in the
    # backward's recompute; K5b once
    k5 = cfg.num_layers * (1 if cfg.remat == "none" else 2)
    per_step = {"K5": k5, "K5_tc": k5, "K5b": cfg.num_layers,
                "K5b_tc": cfg.num_layers}
    fn = fa_ops.flash_attention
    _zero_k5(fn)
    times, losses, first = [], [], None
    for i in range(1 + t["steps"]):
        grads_k = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_k, grads_k = _value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss_k))
        if i == 0:
            first = _k5_counts(fn)
    counts = _k5_counts(fn)
    peak = torch.cuda.max_memory_allocated()
    if first != per_step or counts != {k: n * (1 + t["steps"])
                                       for k, n in per_step.items()}:
        raise AssertionError(f"train_mla: launch counts {first} in the first "
                             f"pass, {counts} in all, want {per_step} a pass")
    if not np.isfinite(losses).all() \
            or not all(bool(torch.isfinite(g).all()) for g in grads_k):
        raise AssertionError(f"train_mla: losses {losses}, or a gradient "
                             f"not finite")

    # the gate: the same step with FlashAttentionFn on the plain versions
    # (no kernel may launch there) and the router's top-k choices of the
    # kernels' step replayed.  Routing is discontinuous: K5's bf16 output
    # differs from the plain forward's by an ulp here and there, which
    # moves a token whose 6th and 7th expert nearly tie to another expert
    # with its whole gradient.  The plain step with its own routing is run
    # too and reported (``unpinned``), with the tokens whose experts moved.
    names = [n for n, _ in _paths(params)]
    del grads_k
    with _routing(layers) as kernel_ids:
        loss_k, grads_k = _value_and_grad(model, params, batch)
    launched = _k5_counts(fn)
    saved = layers.FlashAttentionFn
    layers.FlashAttentionFn = _plain_flash_fn()
    try:
        with _routing(layers) as own_ids:
            loss_u, grads_u = _value_and_grad(model, params, batch)
        unpinned = {n: rel_err(gk, gu) for n, gk, gu in zip(names, grads_k,
                                                            grads_u)}
        del grads_u
        with _routing(layers, replay=kernel_ids):
            loss_p, grads_p = _value_and_grad(model, params, batch)
    finally:
        layers.FlashAttentionFn = saved
    if _k5_counts(fn) != launched:
        raise AssertionError("train_mla gate: a kernel ran in the plain step")
    moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(kernel_ids, own_ids))
    leaf_errs = {n: rel_err(gk, gp) for n, gk, gp in zip(names, grads_k,
                                                         grads_p)}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(leaf_errs, key=leaf_errs.get)
    step_s = float(np.median(times[1:]))
    row = {"phase": "train_mla", "model": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "batch": t["batch"], "seq": t["seq"],
           "remat": cfg.remat, "dtype": cfg.dtype, "head_dims": [dqk, dv],
           "losses": losses, "step_ms": [x * 1e3 for x in times],
           "ms_per_step_median": step_s * 1e3,
           "tokens_per_s": t["batch"] * t["seq"] / step_s,
           "max_memory_allocated_gib": peak / 2**30,
           "launches_per_step": first, "launches": counts,
           "gate": {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                    "loss_rel": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
                    "worst_leaf": worst,
                    "worst_leaf_rel_err": leaf_errs[worst],
                    "bound": TRAIN_GRAD_BOUND, "leaf_rel_err": leaf_errs,
                    "routing": "the kernels' step's top-k replayed",
                    "unpinned": {
                        "loss_plain": float(loss_u),
                        "tokens_whose_experts_moved": moved,
                        "of_tokens": sum(a.shape[0] * a.shape[1]
                                         for a in kernel_ids),
                        "leaf_rel_err": unpinned}},
           "nvidia_smi": _smi()}
    emit(row)
    del grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    if not loss_rel <= TRAIN_LOSS_RTOL \
            or not leaf_errs[worst] <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"train_mla gate: loss {float(loss_k)} vs "
                             f"{float(loss_p)}, worst leaf {worst} "
                             f"{leaf_errs[worst]}")

    # one optimizer step at full width: AdamW in pieces, bf16 moments
    opt_cfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, total_steps=1000,
                              moment_dtype=cfg.opt_dtype)
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(model, TrainConfig(opt=opt_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_k5(fn)
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = _k5_counts(fn)
    finite = all(bool(torch.isfinite(x).all()) for x in _leaves(params))
    row = {"phase": "train_mla_step", "model": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "moment_dtype": opt_cfg.moment_dtype,
           "adamw_piece_values": adamw._PIECE, "step_ms": step_ms,
           "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
           / 2**30, "launches": step_counts, "params_finite": finite,
           "nvidia_smi": _smi()}
    emit(row)
    del params, opt, met, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    if step_counts != per_step or not finite \
            or not math.isfinite(row["loss"]):
        raise AssertionError(f"train_mla step: launches {step_counts}, want "
                             f"{per_step}; finite {finite}, loss {row['loss']}")
    return {**counts, "step": step_counts}


def _zero_k6(fn) -> None:
    fn.launches = fn.bwd_launches = 0


def _k56_counts(fa, sc) -> dict:
    return {**_k5_counts(fa), "K6": sc.launches, "K6b": sc.bwd_launches}


def _plain_ssm_fn():
    """``SsmScanFn`` with the plain versions on any device (the reference
    of the train gates; the port never runs it on the card)."""
    import torch
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

    class PlainSsmScanFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, B, C, A, D, h0):
            ctx.save_for_backward(x, dt, B, C, A, D, h0)
            ctx.set_materialize_grads(False)
            return ssm_scan_ref(x, dt, B, C, A, D, h0)

        @staticmethod
        def backward(ctx, dy, dh_last):
            return ssm_scan_bwd_ref(*ctx.saved_tensors, dy, dh_last)
    return PlainSsmScanFn


def train_family_phase(dev, phase: str, spec) -> dict:
    """One family of ``TRAIN_FAMILIES`` training on the card: random
    weights from the seed, bf16, remat full, a warm-up and ``steps`` timed
    ``make_train_step`` steps with AdamW on one repeated batch of
    ``SyntheticLM`` (whisper: and stub frames N(0, 0.02^2)).  Gates: the
    loss finite and falling; K5 / K5b and K6 / K6b launches a step (the
    counters zeroed before the first step: each attention call and each
    Mamba-1 scan once in the forward and once in the recompute, each
    backward once); at full width and ``TRAIN_GATE_LAYERS`` layers, one
    step's loss within TRAIN_LOSS_RTOL and each leaf within
    TRAIN_GRAD_BOUND of max |g| of the same step with ``FlashAttentionFn``
    and ``SsmScanFn`` on the plain versions (K6b's plain version is the
    reverse recurrence, so the gate runs at the phase's own batch).
    Prints ms a step, tokens/s, peak memory and the kernels' device ms a
    step (torch.profiler over one more step); returns the counts of the
    timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import Model, hybrid
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step

    arch, depth, b, s, steps = spec
    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if depth:
        cfg = cfg.with_overrides(num_layers=depth)
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} trains with remat {cfg.remat}, "
                             f"{cfg.dtype}")
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    opt_cfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, total_steps=1000)
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(model, TrainConfig(opt=opt_cfg))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                  seed=SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    if cfg.family == "encdec":
        batch["frames"] = (torch.randn(
            (b, cfg.audio_frames, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
            * 0.02).to(layers.dt(cfg))

    def per_step(c):
        """K5 / K5b and K6 / K6b launches a step of config ``c``."""
        calls = hybrid.num_shared_sites(c) if c.family == "hybrid" else \
            c.encoder_layers + 2 * c.num_layers if c.family == "encdec" else 0
        scans = c.num_layers if c.family in ("ssm", "hybrid") \
            and c.mamba_version == 1 else 0
        twice = 1 if c.remat == "none" else 2
        return {"K5": twice * calls, "K5_tc": twice * calls, "K5b": calls,
                "K5b_tc": calls, "K6": twice * scans, "K6b": scans}
    want = per_step(cfg)
    fa, sc = fa_ops.flash_attention, ssm_ops.ssm_scan
    _zero_k5(fa)
    _zero_k6(sc)
    mets, times, first = [], [], None
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mets.append(met)
        if i == 0:
            first = _k56_counts(fa, sc)
    counts = _k56_counts(fa, sc)
    if first != want or counts != {k: n * (1 + steps)
                                   for k, n in want.items()}:
        raise AssertionError(f"{phase}: launch counts {first} in the first "
                             f"step, {counts} in all, want {want} a step")
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}, grad norms {norms}")
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    dev_ms = {"K5": 0.0, "K5b": 0.0, "K6": 0.0, "K6b": 0.0, "all": 0.0}
    for row in prof.key_averages():
        ms = row.self_device_time_total / 1e3
        dev_ms["all"] += ms
        if "flash_tc_kernel<" in row.key or "flash_kernel<" in row.key:
            dev_ms["K5"] += ms
        elif any(name in row.key for name in K5B_KERNELS):
            dev_ms["K5b"] += ms
        elif any(name in row.key for name in K6_KERNELS):
            dev_ms["K6"] += ms
        elif any(name in row.key for name in K6B_KERNELS):
            dev_ms["K6b"] += ms
    step_s = float(np.median(times[1:]))
    del params, opt, met, mets, step
    gc.collect()
    torch.cuda.empty_cache()

    # the gate at full width and TRAIN_GATE_LAYERS layers (and encoder
    # layers): one step's loss and gradients with the kernels against the
    # plain versions (no kernel may launch there)
    small = {"num_layers": TRAIN_GATE_LAYERS}
    if cfg.family == "encdec":
        small["encoder_layers"] = TRAIN_GATE_LAYERS
    cfg2 = cfg.with_overrides(**small)
    model2 = Model(cfg2)
    params2 = model2.init(torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    _zero_k5(fa)
    _zero_k6(sc)
    loss_k, grads_k = _value_and_grad(model2, params2, batch)
    launched = _k56_counts(fa, sc)
    gate_want = per_step(cfg2)
    saved = layers.FlashAttentionFn, ssm_ops.SsmScanFn
    layers.FlashAttentionFn, ssm_ops.SsmScanFn = _plain_flash_fn(), \
        _plain_ssm_fn()
    try:
        loss_p, grads_p = _value_and_grad(model2, params2, batch)
    finally:
        layers.FlashAttentionFn, ssm_ops.SsmScanFn = saved
    if _k56_counts(fa, sc) != launched or launched != gate_want:
        raise AssertionError(f"{phase} gate: launches {launched} (want "
                             f"{gate_want}), {_k56_counts(fa, sc)} after "
                             f"the plain step")
    names = [n for n, _ in _paths(params2)]
    leaf_errs = {n: rel_err(gk, gp) for n, gk, gp in zip(names, grads_k,
                                                         grads_p)}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(leaf_errs, key=leaf_errs.get)
    del params2, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    tokens = b * s
    row = {"phase": phase, "model": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "full_layers": full_layers,
           "cut": f"depth {full_layers} -> {cfg.num_layers} layers, full "
                  "width" if depth else None,
           "batch": b, "seq": s, "remat": cfg.remat, "dtype": cfg.dtype,
           "losses": losses, "grad_norms": norms,
           "step_ms": [t * 1e3 for t in times],
           "ms_per_step_median": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "max_memory_allocated_gib": peak / 2**30,
           "device_ms_per_step": dev_ms,
           "K6b_share_of_device": dev_ms["K6b"] / dev_ms["all"],
           "launches_per_step": first, "launches": counts,
           "gate": {"layers": TRAIN_GATE_LAYERS,
                    "loss_kernels": float(loss_k),
                    "loss_plain": float(loss_p), "loss_rel": loss_rel,
                    "loss_rtol": TRAIN_LOSS_RTOL, "worst_leaf": worst,
                    "worst_leaf_rel_err": leaf_errs[worst],
                    "bound": TRAIN_GRAD_BOUND, "batch": b,
                    "launches": launched},
           "nvidia_smi": _smi()}
    if cfg.family == "encdec":
        row["frames"] = cfg.audio_frames
    emit(row)
    if not loss_rel <= TRAIN_LOSS_RTOL \
            or not leaf_errs[worst] <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"{phase} gate: loss {float(loss_k)} vs "
                             f"{float(loss_p)}, worst leaf {worst} "
                             f"{leaf_errs[worst]}")
    return counts


def _gspmd_drops(ids, cfg) -> int:
    """Slots ``layers.moe_block`` drops for one layer's top-k ids (B, S,
    k): each batch row keeps an expert's first ``cap`` slots."""
    import torch
    b, s, k = ids.shape
    cap = max(1, int(math.ceil(s * k * cfg.moe_capacity_factor
                               / cfg.moe_experts)))
    counts = torch.zeros((b, cfg.moe_experts), dtype=torch.int64,
                         device=ids.device)
    counts.scatter_add_(1, ids.reshape(b, s * k), torch.ones_like(
        ids.reshape(b, s * k)))
    return int((counts - cap).clamp_min(0).sum())


def _device_breakdown(prof, wall_ms: float, top: int = 14) -> dict:
    """A profiled step's device time: busy ms (the kernels' self time),
    the idle share of the wall, K5's and K5b's ms, and the ``top``
    kernels by self time ([name, ms, calls])."""
    rows = [(r.key, r.self_device_time_total / 1e3, r.count)
            for r in prof.key_averages() if r.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    k5 = sum(ms for key, ms, _ in rows
             if "flash_tc_kernel<" in key or "flash_kernel<" in key)
    k5b = sum(ms for key, ms, _ in rows
              if any(name in key for name in K5B_KERNELS))
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "K5_ms": k5, "K5b_ms": k5b,
            "top": [[key[:96], ms, n] for key, ms, n in rows[:top]]}


def _pieced_adamw_gate(dev) -> dict:
    """One AdamW update on the card with the leaves cut into pieces of
    2^16 values against the same update on whole leaves (bf16 parameters
    and moments, one stacked leaf and two others): bit-equal."""
    import torch
    from repro_torch.optim import adamw
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = {"layers": {"w": (2, 96, 4096, 64), "ln": (2, 4096)},
              "embed": (3000, 512)}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) for k, v in node.items()} \
            if isinstance(node, dict) else fn(node)
    base = tree(lambda shape: torch.randn(shape, generator=gen, device=dev)
                .to(torch.bfloat16))
    grads = tree(lambda shape: torch.randn(shape, generator=gen, device=dev)
                 .to(torch.bfloat16))
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10,
                          moment_dtype="bfloat16")
    def clone(t):
        return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.clone()
    runs, groups, real = [], [], adamw._PIECE
    for piece in (real, 1 << 16):
        params = clone(base)
        state = adamw.init_state(params, opt)
        adamw._PIECE = piece
        try:
            adamw.apply_updates(params, grads, state, opt)
            groups.append(len(adamw._groups(params)))
        finally:
            adamw._PIECE = real
        runs.append(list(_leaves(params)) + list(_leaves(state["m"]))
                    + list(_leaves(state["v"])))
    equal = all(torch.equal(a, b) for a, b in zip(*runs))
    if not equal or not groups[1] > groups[0]:
        raise AssertionError(f"AdamW in pieces: bit-equal {equal}, groups "
                             f"{groups}")
    return {"bit_equal": True, "groups_whole_and_pieced": groups,
            "piece_values": 1 << 16, "values": sum(
                x.numel() for x in _leaves(base))}


def train_moe_ep_phase(dev) -> dict:
    """qwen3-moe at full width and ``TRAIN_MOE_EP`` depth training with its
    experts on four shards of the card (``moe_impl="ep"`` under
    ``mesh_context(make_host_mesh(4, [cuda:0] * 4))``): the exchange gate,
    the step gate, timed EP steps with AdamW in pieces, the same steps
    without a mesh (the GSPMD block), and the pieced-AdamW gate.  Returns
    the K5 / K5b counts of the timed EP steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, layers, moe_ep
    from repro_torch.optim import adamw
    from repro_torch.sharding import specs as sh
    from repro_torch.train import TrainConfig, make_train_step

    t = TRAIN_MOE_EP
    cfg = get_config(t["arch"]).with_overrides(num_layers=t["layers"],
                                               moe_impl="ep")
    m_shards = t["model_axis"]
    mesh = make_host_mesh(m_shards, [dev] * m_shards)
    if cfg.dtype != "bfloat16" or cfg.opt_dtype != "bfloat16" \
            or cfg.remat != "full" or mesh.shape != {"data": 1,
                                                    "model": m_shards}:
        raise AssertionError(f"{cfg.name}: {cfg.dtype}, moments "
                             f"{cfg.opt_dtype}, remat {cfg.remat}, {mesh.shape}")
    t_loc = t["batch"] * t["seq"] // m_shards
    c2, c3 = moe_ep.capacities(t_loc, cfg, m_shards)
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    n_params = sum(x.numel() for x in _leaves(params))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t["seq"],
                                  global_batch=t["batch"], seed=SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}

    # gate 1, the exchange at full width: one layer's moe_block_ep against
    # moe_block on the same bf16 input at a capacity factor (E / k) at
    # which neither drops a slot, moe_block's top-k replayed into the shards
    cf = cfg.moe_experts / cfg.moe_top_k
    cfg1 = cfg.with_overrides(moe_capacity_factor=cf)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = (torch.randn((t["batch"], t["seq"], cfg.d_model),
                     generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)).to(torch.bfloat16)
    s_loc = t["seq"] // m_shards
    with torch.no_grad():
        with _routing(layers) as ref_ids:
            ref = layers.moe_block(lp, x, cfg1)
        replay = [ref_ids[0][:, j * s_loc:(j + 1) * s_loc].reshape(
            -1, cfg.moe_top_k) for j in range(m_shards)]
        with sh.mesh_context(mesh), _routing(layers, replay=replay):
            got = moe_ep.moe_block_ep(lp, x, cfg1)
    exchange = {"capacity_factor": cf, "c2_c3": list(moe_ep.capacities(
                    t_loc, cfg1, m_shards)),
                "dropped_ep": list(moe_ep.dropped_slots(replay, cfg1,
                                                        m_shards)),
                "dropped_gspmd": _gspmd_drops(ref_ids[0], cfg1),
                "max_abs_err": float((got.float() - ref.float()).abs().max()),
                "rel_err": rel_err(got, ref), "bound": EP_EXCHANGE_BOUND}
    del x, ref, got, ref_ids, replay
    gc.collect()
    torch.cuda.empty_cache()
    if not exchange["rel_err"] <= EP_EXCHANGE_BOUND \
            or exchange["dropped_ep"] != [0, 0] or exchange["dropped_gspmd"]:
        raise AssertionError(f"train_moe_ep exchange gate: {exchange}")

    # gate 2, the step: the kernels' EP step against the same EP step with
    # FlashAttentionFn on the plain versions, the router's choices of the
    # kernels' step replayed (no kernel may launch in the plain one)
    fn = fa_ops.flash_attention
    names = [n for n, _ in _paths(params)]
    with sh.mesh_context(mesh):
        with _routing(layers) as kernel_ids:
            loss_k, grads_k = _value_and_grad(model, params, batch)
        launched = _k5_counts(fn)
        saved = layers.FlashAttentionFn
        layers.FlashAttentionFn = _plain_flash_fn()
        try:
            with _routing(layers, replay=kernel_ids):
                loss_p, grads_p = _value_and_grad(model, params, batch)
        finally:
            layers.FlashAttentionFn = saved
    if _k5_counts(fn) != launched:
        raise AssertionError("train_moe_ep gate: a kernel ran in the plain "
                             "step")
    leaf_errs = {n: rel_err(gk, gp) for n, gk, gp in zip(names, grads_k,
                                                         grads_p)}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(leaf_errs, key=leaf_errs.get)
    gate = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
            "worst_leaf": worst, "worst_leaf_rel_err": leaf_errs[worst],
            "bound": TRAIN_GRAD_BOUND, "leaf_rel_err": leaf_errs,
            "routing": "the kernels' step's top-k replayed",
            "top_k_calls": len(kernel_ids)}
    del grads_k, grads_p, kernel_ids
    gc.collect()
    torch.cuda.empty_cache()
    if not loss_rel <= TRAIN_LOSS_RTOL \
            or not leaf_errs[worst] <= TRAIN_GRAD_BOUND:
        raise AssertionError(f"train_moe_ep step gate: {gate}")

    # the timed steps: EP under the mesh, then the GSPMD block without one
    opt_cfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, total_steps=1000,
                              moment_dtype=cfg.opt_dtype)
    opt = adamw.init_state(params, opt_cfg)
    step = make_train_step(model, TrainConfig(opt=opt_cfg))
    k5 = 2 * cfg.num_layers               # forward and remat recompute
    per_step = {"K5": k5, "K5_tc": k5, "K5b": cfg.num_layers,
                "K5b_tc": cfg.num_layers}
    runs = {}
    for name, ctx in (("ep", lambda: sh.mesh_context(mesh)),
                      ("gspmd", contextlib.nullcontext)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_k5(fn)
        mets, times, first, ids = [], [], None, None
        for i in range(1 + t["steps"]):
            with ctx(), (_routing(layers) if i == 0
                         else contextlib.nullcontext()) as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            mets.append(met)
            if i == 0:
                first, ids = _k5_counts(fn), calls
        counts = _k5_counts(fn)
        if first != per_step or counts != {k: n * (1 + t["steps"])
                                           for k, n in per_step.items()}:
            raise AssertionError(f"train_moe_ep {name}: launch counts {first} "
                                 f"in the first step, {counts} in all, want "
                                 f"{per_step} a step")
        # the forward's top-k calls, layer by layer (the remat recompute's
        # follow): m_shards a layer under the mesh, one without
        if name == "ep":
            per_layer = [ids[l * m_shards:(l + 1) * m_shards]
                         for l in range(cfg.num_layers)]
            drops = [list(moe_ep.dropped_slots(calls, cfg, m_shards))
                     for calls in per_layer]
        else:
            per_layer = [[ids[l]] for l in range(cfg.num_layers)]
            drops = [_gspmd_drops(ids[l], cfg) for l in range(cfg.num_layers)]
        # the share of a layer's slots its 8 busiest experts take (1/16 if
        # the router spread them evenly)
        busiest = [float(torch.bincount(torch.cat([c.reshape(-1) for c in
                                                   calls]),
                                        minlength=cfg.moe_experts)
                         .sort(descending=True).values[:8].sum())
                   / sum(c.numel() for c in calls) for calls in per_layer]
        step_s = float(np.median(times[1:]))
        with ctx(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        runs[name] = {"losses": [float(m["loss"]) for m in mets],
                      "grad_norms": [float(m["grad_norm"]) for m in mets],
                      "step_ms": [x * 1e3 for x in times],
                      "ms_per_step_median": step_s * 1e3,
                      "tokens_per_s": t["batch"] * t["seq"] / step_s,
                      "max_memory_allocated_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                      "dropped_slots_per_layer": drops,
                      "busiest_8_experts_share_per_layer": busiest,
                      "top_k_calls_per_step": len(ids),
                      "launches_per_step": first, "launches": counts,
                      "profiled_step": _device_breakdown(prof, wall_ms)}
        if name == "ep":
            ep_counts = counts
        del mets, met, ids
    losses = runs["ep"]["losses"] + runs["gspmd"]["losses"]
    del params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    pieces = _pieced_adamw_gate(dev)
    row = {"phase": "train_moe_ep", "model": cfg.name, "params": n_params,
           "layers": cfg.num_layers, "batch": t["batch"], "seq": t["seq"],
           "remat": cfg.remat, "dtype": cfg.dtype,
           "moment_dtype": opt_cfg.moment_dtype, "mesh": mesh.shape,
           "t_loc": t_loc, "c2": c2, "c3": c3,
           "capacity_factor": cfg.moe_capacity_factor,
           "adamw_piece_values": adamw._PIECE, **runs,
           "ep_over_gspmd_ms": runs["ep"]["ms_per_step_median"]
           / runs["gspmd"]["ms_per_step_median"],
           "gate_exchange": exchange, "gate_step": gate,
           "gate_adamw_pieces": pieces, "nvidia_smi": _smi()}
    emit(row)
    if not np.isfinite(losses).all() \
            or not runs["ep"]["losses"][-1] < runs["ep"]["losses"][0]:
        raise AssertionError(f"train_moe_ep: losses {losses}")
    return ep_counts


def collectives_phase(dev) -> None:
    """The EDRA collectives over ``COLLECTIVE_PEERS`` entries of the card:
    all-gather and broadcast (sources 0, 3, 7) equal to the plain results,
    the all-reduce within f32 rounding of the plain sum, and repro's
    gradient-sync scenario (eight batch shards' gradients, synced by
    ``edra_allreduce`` / 8, equal to the whole-batch gradient); then one
    all-reduce of ``COLLECTIVE_VALUES`` f32 values a peer, timed beside the
    plain sum."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import collectives as coll

    n = COLLECTIVE_PEERS
    entries = make_host_mesh(n, [dev] * n).entries()
    x = torch.arange(n * 4, dtype=torch.float32, device=dev).reshape(n, 4)
    xs = [x[i:i + 1].clone() for i in range(n)]
    gather_ok = all(torch.equal(g[:, 0], x) and g.device == e
                    for g, e in zip(coll.edra_allgather(xs), entries))
    bcast_ok = all(torch.equal(b, xs[src]) for src in (0, 3, 7)
                   for b in coll.edra_broadcast(xs, source=src))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ys = [torch.randn((5, 3), generator=gen, device=dev) for _ in range(n)]
    want = torch.stack(ys).sum(0)
    reduce_err = max(float((r - want).abs().max())
                     for r in coll.edra_allreduce(ys))
    rng = [np.random.default_rng(i) for i in range(3)]
    w = torch.from_numpy(rng[0].standard_normal((16, 8)).astype(np.float32))
    xb = torch.from_numpy(rng[1].standard_normal((32, 16)).astype(np.float32))
    yb = torch.from_numpy(rng[2].standard_normal((32, 8)).astype(np.float32))
    w, xb, yb = w.to(dev), xb.to(dev), yb.to(dev)
    grads = []
    for i in range(n):
        wi = w.clone().requires_grad_()
        rows = slice(i * 32 // n, (i + 1) * 32 // n)
        grads.append(torch.autograd.grad(
            torch.mean((xb[rows] @ wi - yb[rows]) ** 2), [wi])[0])
    wf = w.clone().requires_grad_()
    full = torch.autograd.grad(torch.mean((xb @ wf - yb) ** 2), [wf])[0]
    sync_err = max(float((g / n - full).abs().max())
                   for g in coll.edra_allreduce(grads))
    big = [torch.randn(COLLECTIVE_VALUES, generator=gen, device=dev)
           for _ in range(n)]
    row = {"phase": "collectives", "peers": n, "rounds": int(math.log2(n)),
           "allgather_equal": gather_ok, "broadcast_equal": bcast_ok,
           "allreduce_max_abs_err": reduce_err, "grad_sync_max_abs_err":
           sync_err, "tolerance": 1e-5,
           "allreduce_values_per_peer": COLLECTIVE_VALUES,
           "allreduce_ms": cuda_ms(lambda i: coll.edra_allreduce(big),
                                   iters=5, warmup=1),
           "plain_sum_ms": cuda_ms(lambda i: torch.stack(big).sum(0),
                                   iters=5, warmup=1),
           "nvidia_smi": _smi()}
    emit(row)
    del big
    torch.cuda.empty_cache()
    if not (gather_ok and bcast_ok and reduce_err <= 1e-5
            and sync_err <= 1e-5):
        raise AssertionError(f"collectives: {row}")


def train_lm_phase(dev) -> dict:
    """The train_lm twin's model (lm-100m) through ``Trainer`` with
    checkpoint failover: a peer fails during step ``fail_at``; the run
    restores the last checkpoint, bit for bit, and finishes.  Returns the
    K5 / K5b counts."""
    import shutil
    import torch
    from repro_torch import train_lm
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import FailoverConfig, Membership
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = train_lm.model_100m()
    t = TRAIN_LM
    ckpt_dir = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    members = Membership(device=dev)
    for i in range(4):
        members.request_join(f"10.0.0.{i}", 7000)
    trainer = Trainer(Model(cfg), TrainerConfig(
        steps=t["steps"], log_every=10, train=TrainConfig(
            opt=adamw.OptConfig(peak_lr=3e-4, warmup_steps=20,
                                total_steps=t["steps"])),
        failover=FailoverConfig(str(ckpt_dir),
                                save_every_steps=t["save_every"])),
        membership=members, model_axis=1, device=dev)
    saved, restored, save_s = {}, {}, []
    save, restore = trainer.failover.maybe_save, trainer.failover.restore_latest

    def spy_save(step, state):
        t0 = time.perf_counter()
        path = save(step, state)
        if path:
            save_s.append(time.perf_counter() - t0)
            if not restored:        # the last checkpoint before the restore
                saved.clear()
                saved[step] = [x.cpu().clone() for x in adamw.leaves(state)]
        return path

    def spy_restore(target):
        step, state = restore(target)
        restored[step] = [x.cpu().clone() for x in adamw.leaves(state)]
        return step, state
    trainer.failover.maybe_save = spy_save
    trainer.failover.restore_latest = spy_restore

    def batches():
        for i, b in enumerate(SyntheticLM(DataConfig(
                vocab=cfg.vocab, seq_len=t["seq"], global_batch=t["batch"],
                seed=0))):
            if i == t["fail_at"] - 1:           # step fail_at runs next
                members.fail(members.members()[-1])
            yield b
    fn = fa_ops.flash_attention
    _zero_k5(fn)
    try:
        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
        t0 = time.perf_counter()
        trainer.fit(state, batches())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    counts = _k5_counts(fn)
    back = t["fail_at"] // t["save_every"] * t["save_every"]
    ran = t["steps"] + t["fail_at"] - back
    hist = trainer.history
    if list(restored) != [back] or list(saved) != [back] \
            or not all(torch.equal(a, b)
                       for a, b in zip(saved[back], restored[back])) \
            or len(saved[back]) != len(restored[back]):
        raise AssertionError(f"train_lm: restored {list(restored)}, saved "
                             f"{list(saved)}, not equal bit for bit")
    if not hist[-1]["loss"] < hist[0]["loss"] or hist[-1]["step"] != t["steps"] \
            or ckpt_dir.exists():
        raise AssertionError(f"train_lm: history {hist}, checkpoint dir left: "
                             f"{ckpt_dir.exists()}")
    per = cfg.num_layers * ran
    if counts != {"K5": per, "K5_tc": per, "K5b": per, "K5b_tc": per}:
        raise AssertionError(f"train_lm: launch counts {counts}, want {per} "
                             f"of each ({ran} steps x {cfg.num_layers})")
    emit({"phase": "train_lm", "model": cfg.name,
          "params": cfg.param_count(), "steps_run": ran,
          "restored_step": back, "restored_bit_equal": True,
          "leaves_restored": len(restored[back]),
          "loss_first_last": [hist[0]["loss"], hist[-1]["loss"]],
          "history": hist, "wall_s": wall, "checkpoint_save_s": save_s,
          "launches": counts, "checkpoint_dir_removed": True})
    return counts


def launch_dryrun_start(out: str):
    """Start the dry run of every cell (``python -m
    repro_torch.launch.dryrun --all --mesh both --out out``) in a child
    process that sees no card (``CUDA_VISIBLE_DEVICES`` empty), its output
    to ``out`` + ``.log``, in a session of its own so that it and its
    ``LAUNCH_JOBS`` spawned workers can be stopped together."""
    import subprocess
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    with open(out + ".log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--jobs", str(LAUNCH_JOBS), "--out", out],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)


def launch_dryrun_wait(proc, out: str) -> list:
    """The dry run's records, skips included, once its child has exited
    (within 900 s)."""
    proc.wait(timeout=900)
    if proc.returncode:
        with open(out + ".log") as log:
            raise AssertionError(f"launch: the dry run exited "
                                 f"{proc.returncode}: {log.read()[-3000:]}")
    with open(out) as f:
        return [json.loads(line) for line in f]


def launch_dryrun_stop(proc) -> None:
    """Kill the dry run's session where its child still runs."""
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def launch_step_inputs(model, mode: str, dev):
    """qwen2.5-3b's step of ``mode`` at the shape the train, the
    serve_whole_prompt and the serve phases run, on ``dev`` (``cuda`` or
    ``meta``): (the step, its arguments).  On ``meta`` the parameters are
    ``abstract_params`` and every input empty."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    cfg = model.cfg
    meta = dev.type == "meta"
    params = model.abstract_params() if meta else model.init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    gen = None if meta else torch.Generator(device=dev).manual_seed(SEED)

    def tokens(shape, lo=0, hi=cfg.vocab):
        if meta:
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    if mode == "train":
        opt = adamw.OptConfig(moment_dtype=cfg.opt_dtype)
        state = adamw.init_state(params, opt)
        batch = {"tokens": tokens((TRAIN_BATCH, TRAIN_SEQ)),
                 "labels": tokens((TRAIN_BATCH, TRAIN_SEQ))}
        return (make_train_step(model, TrainConfig(opt=opt)),
                (params, state, batch))
    if mode == "prefill":
        return (lambda p, b, c: model.prefill(p, b, c),
                (params, {"tokens": tokens((1, LAUNCH_PROMPT))},
                 model.init_cache(1, LAUNCH_MAX_LEN, device=dev)))
    # a fused round's decode step: every slot at its own position
    return (lambda p, c, t, i: model.decode_step(p, c, t, i),
            (params, model.init_cache(LAUNCH_SLOTS, LAUNCH_MAX_LEN,
                                      device=dev),
             tokens((LAUNCH_SLOTS, 1)),
             tokens((LAUNCH_SLOTS,), 128, LAUNCH_MAX_LEN - 1)))


def launch_charges(cases) -> list:
    """Each bounded K3/K5/K5b/K6/K6b case of the kernels phase rebuilt on
    ``meta`` and run through its public wrapper under a ``CostCounter``:
    the charge's bytes, matmul FLOPs, other operations (and
    exponentials) against the work its bound used.  K3's charge is the
    caches' whole capacity, so it is held against the bound's work at
    every position (the bound's own bytes and FLOPs are linear in the
    positions it read)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.launch.hlo_cost import CostCounter
    meta = torch.device("meta")

    def empty(shape, dtype, grad=False):
        return torch.empty(shape, dtype=getattr(torch, dtype), device=meta,
                           requires_grad=grad)
    keys = ("bytes", "matmul_flops", "ops", "exponentials")
    rows = []
    for kernel, row in cases:
        want = {k: row["work"][k] for k in keys if k in row["work"]}
        with CostCounter() as counter:
            if kernel == "K3":
                b, s, h, hkv, hd = (row[k] for k in ("B", "S", "H", "Hkv",
                                                     "hd"))
                size = getattr(torch, row["dtype"]).itemsize
                extra = b * s - row["work"]["positions"]
                want["bytes"] += 2 * extra * hkv * hd * size
                want["matmul_flops"] += 4 * extra * h * hd
                da_ops.decode_attention(empty((b, h, hd), row["dtype"]),
                                        empty((b, s, hkv, hd), row["dtype"]),
                                        empty((b, s, hkv, hd), row["dtype"]),
                                        empty((b,), "int32"))
            elif kernel in ("K5", "K5b"):
                b, sq, sk, h, hkv, hd, dv = (row[k] for k in (
                    "B", "Sq", "Sk", "H", "Hkv", "hd", "dv"))
                grad = kernel == "K5b"
                q, k, v = (empty(shape, row["dtype"], grad) for shape in (
                    (b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, dv)))
                if grad:
                    o = fa_ops.FlashAttentionFn.apply(q, k, v, row["causal"])
                    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
                else:
                    fa_ops.flash_attention(q, k, v, causal=row["causal"])
            else:
                bb, l, din, n = row["dims"]
                shapes = ((bb, l, din), (bb, l, din), (bb, l, n), (bb, l, n),
                          (din, n), (din,), (bb, din, n), (bb, l, din),
                          (bb, din, n))
                grad = kernel == "K6b"
                ts = [None if dt is None else empty(shape, dt, grad and i < 7)
                      for i, (shape, dt) in enumerate(zip(shapes,
                                                          row["dtypes"]))]
                y, h_last = ssm_ops.SsmScanFn.apply(*ts[:7])
                if grad:
                    outs = [(y, ts[7])] + ([(h_last, ts[8])]
                                           if ts[8] is not None else [])
                    torch.autograd.grad([o for o, _ in outs],
                                        [t for t in ts[:7] if t is not None],
                                        [g for _, g in outs])
        got = {k: counter.kernels[kernel].get(k) for k in want}
        if counter.kernels[kernel]["calls"] != 1 or got != want:
            raise AssertionError(f"launch: {kernel}'s charge {got} on meta is "
                                 f"not its bound's work {want} "
                                 f"({row.get('shape', row)})")
        rows.append({"kernel": kernel, **want})
    return rows


def launch_phase(dev, cases) -> None:
    """The launch group (``launch/{presets,dryrun,hlo_cost}.py``): the dry
    run of every cell, qwen2.5-3b's three steps counted on the card and
    on ``meta``, the kernels' charges against their bounds, the meta
    temporaries against the card's peak, and each step's share of its
    roofline."""
    from repro_torch.configs import all_cells, skipped_cells
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch.mesh import HARDWARE

    # -- the dry run of every (arch x shape x mesh) cell, on no card, in a
    # child process while this one counts on the card and on meta; the
    # steps are timed after it, on a quiet host -------------------------
    with tempfile.TemporaryDirectory(prefix="repro-torch-dryrun-") as tmp:
        out = os.path.join(tmp, "dryrun.jsonl")
        t0 = time.perf_counter()
        proc = launch_dryrun_start(out)
        try:
            steps = launch_qwen_counts(dev)
            charges = launch_charges(cases)
            recs = launch_dryrun_wait(proc, out)
        finally:
            launch_dryrun_stop(proc)
        dry_s = time.perf_counter() - t0
    launch_qwen_times(dev, steps)
    cells = [r for r in recs if r.get("ok") is not None]
    skips = [r for r in recs if r.get("ok") is None]
    for r in cells:
        print(f"launch_cell {r['arch']} {r['shape']} {r['mesh']} "
              + (f"peak/dev {r['peak_memory_per_device']} fits {r['fits']} "
                 f"flops/dev {r['matmul_flops_per_device']} bytes/dev "
                 f"{r['hbm_bytes_per_device']} coll/dev "
                 f"{r['collective_bytes_per_device']} ({r['per_device']}) "
                 f"host_s {r['wall_s']}" if r["ok"] else
                 f"FAILED {r['error']}"), flush=True)
    want = sorted((a, s, m) for a, s in all_cells()
                  for m in ("16x16", "2x16x16"))
    if sorted((r["arch"], r["shape"], r.get("mesh")) for r in cells) != want \
            or not all(r["ok"] for r in cells) \
            or sorted((r["arch"], r["shape"]) for r in skips) != sorted(
                (a, s) for a in ARCH_IDS for s in skipped_cells(a)):
        raise AssertionError("launch: a dry-run cell failed or is missing: "
                             + "; ".join(f"{r['arch']} {r['shape']} "
                                         f"{r.get('mesh')}: {r.get('error')}"
                                         for r in cells if not r["ok"]))
    emit({"phase": "launch", "nvidia_smi": _smi(),
          "hardware": HARDWARE, "dryrun_cells": len(cells),
          "dryrun_skips": len(skips), "dryrun_s": dry_s,
          "dryrun_jobs": LAUNCH_JOBS,
          "dryrun_trace_s_max": max(r["trace_s"] for r in cells),
          "not_fitting": sorted(f"{r['arch']} {r['shape']} {r['mesh']}"
                                for r in cells if not r["fits"]),
          "qwen_steps": steps, "charges_equal_to_bounds": len(charges),
          "charges": charges})


def launch_qwen_counts(dev) -> dict:
    """qwen2.5-3b at full size: a train step, a whole-prompt prefill and a
    fused round's decode step, each counted under a ``CostCounter`` on the
    card (through the kernels) and on ``meta`` (through their meta
    routes), with the card's peak memory.  Gates: equal matmul FLOPs, HBM
    bytes and kernel charges; the meta temporaries within
    ``LAUNCH_TEMP_REL`` of the card's peak less what was allocated before
    the step (its arguments).  Returns each step's counts and memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.models import Model
    model = Model(get_config("qwen2.5-3b"))
    steps = {}
    for mode in ("train", "prefill", "decode"):
        gc.collect()
        torch.cuda.empty_cache()
        fn, args = launch_step_inputs(model, mode, dev)
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in _tree_list(args))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with CostCounter(args) as counter:
            fn(*args)
        torch.cuda.synchronize()
        card_temp = torch.cuda.max_memory_allocated() - before
        card = counter.result()
        del fn, args
        mfn, margs = launch_step_inputs(model, mode, torch.device("meta"))
        with CostCounter(margs) as counter:
            mfn(*margs)
        on_meta = counter.result()
        same = {k: card[k] == on_meta[k] for k in ("matmul_flops",
                                                   "hbm_bytes", "kernels")}
        temp_rel = abs(on_meta["temp_bytes"] - card_temp) / card_temp
        steps[mode] = {
            "matmul_flops": card["matmul_flops"],
            "hbm_bytes": card["hbm_bytes"],
            "aten": card["aten"], "kernels": card["kernels"],
            "equal_on_meta": same,
            "meta": {k: on_meta[k] for k in ("matmul_flops", "hbm_bytes",
                                             "kernels")},
            "argument_bytes": arg_bytes, "temp_bytes_meta":
                on_meta["temp_bytes"], "temp_bytes_card": card_temp,
            "temp_rel_diff": temp_rel}
        if not all(same.values()):
            raise AssertionError(f"launch: qwen2.5-3b {mode} counts differ "
                                 f"on the card and on meta: card "
                                 f"{ {k: card[k] for k in same} }, meta "
                                 f"{steps[mode]['meta']}")
        if not temp_rel <= LAUNCH_TEMP_REL:
            raise AssertionError(f"launch: qwen2.5-3b {mode} temporaries "
                                 f"{on_meta['temp_bytes']} on meta against "
                                 f"{card_temp} on the card")
    return steps


def launch_qwen_times(dev, steps: dict) -> None:
    """Each of ``launch_qwen_counts``' steps timed on the card (CUDA
    events, a warm-up and 3 calls), beside its roofline time, max(matmul
    FLOPs / bf16 peak, HBM bytes / HBM rate) from ``HARDWARE``: its mfu
    and its share of the roofline, added to ``steps``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HARDWARE
    from repro_torch.models import Model
    model = Model(get_config("qwen2.5-3b"))
    peak, rate = HARDWARE["peak_bf16_flops"], HARDWARE["hbm_bandwidth"]
    for mode, st in steps.items():
        gc.collect()
        torch.cuda.empty_cache()
        fn, args = launch_step_inputs(model, mode, dev)
        ms = cuda_ms(lambda i: fn(*args), iters=3, warmup=1)
        del fn, args
        by_flops, by_bytes = st["matmul_flops"] / peak, st["hbm_bytes"] / rate
        st.update({"device_ms": ms,
                   "roofline_ms": max(by_flops, by_bytes) * 1e3,
                   "roofline_by": "bytes" if by_bytes >= by_flops
                   else "flops",
                   "mfu": st["matmul_flops"] / (ms / 1e3 * peak),
                   "roofline_share": max(by_flops, by_bytes) * 1e3 / ms})


def _tree_list(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_list(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_list(v)]
    return [tree] if hasattr(tree, "element_size") else []


def autotune_phase(dev) -> None:
    """The launch shapes searched on the card, their outputs held against
    the plain versions, and qwen2.5-3b's fused round of 16 at the defaults
    and at the winners (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ringstate import RingState
    from repro_torch.kernels import autotune
    from repro_torch.models import Model
    from repro_torch.serve import Replica, Request
    smi = _smi()
    records = {}
    t0 = time.perf_counter()
    winners = autotune.autotune_all(budget_s=AUTOTUNE_BUDGET_S, device=dev,
                                    records=records)
    sweep_s = time.perf_counter() - t0
    points = {f"{k}/{autotune.shape_bucket(**d)}": (k, d)
              for k, shapes in autotune.SWEEP_DIMS.items() for d in shapes}
    if set(winners) != set(points):
        raise AssertionError(f"the sweep stopped at its budget: "
                             f"{sorted(set(points) - set(winners))} left")
    for name, (kernel, dims) in points.items():
        rec = records[name]
        cands = autotune.candidates_for(kernel, dims)
        if len(cands) > 1:
            ran = [c["tiles"] for c in rec.get("candidates", [])]
            if ran != cands:
                raise AssertionError(f"autotune {name}: candidates {cands} "
                                     f"but ran {ran}")
            tol = 1.6e-2 if kernel == "decode_attention" and dims["tc"] \
                else 2e-5 if kernel == "decode_attention" else 0.0
            bad = [c for c in rec["candidates"]
                   if not c["max_abs_err_vs_plain"] <= tol]
            if bad:
                raise AssertionError(f"autotune {name}: {bad} off the plain "
                                     f"version (tolerance {tol})")
        got = autotune.tiles_for(kernel, dev, **dims)
        if got != winners[name]:
            raise AssertionError(f"tiles_for({name}) = {got}, the search "
                                 f"found {winners[name]}")
        emit({"phase": "autotune", "point": name, "dims": dims,
              "candidates": rec.get("candidates", []),
              "default": autotune.DEFAULTS[kernel],
              "default_ms": rec.get("default_ms"),
              "default_spread_ms": rec.get("default_spread_ms"),
              "winner": winners[name],
              "winner_ms": rec.get("ms"),
              "winner_over_default": rec.get("winner_over_default"),
              "nvidia_smi": smi})
    if autotune.status_label() != "searched":
        raise AssertionError(f"status_label {autotune.status_label()}")

    # qwen2.5-3b's fused round of 16: one replica, K2 on a 10^6-peer
    # directory (2^15 buckets), K3 at B 16, S 2048 -- the sweep's points
    cfg = get_config("qwen2.5-3b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    rng = np.random.default_rng(SEED + 30)
    ring = RingState(np.unique(rng.integers(0, 2**64, N_PEERS,
                                            dtype=np.uint64)), device=dev)
    route = ring.device_bucket_table()
    if route is None or route[0].shape[0] != BUCKETS:
        raise AssertionError(f"the round's directory: {ring.bucket_stats()}")
    rep = Replica(model, slots=AUTOTUNE_ROUND, max_len=2048,
                  prefill_chunk=256, device=dev)
    rep.attach_params(params)
    for i, n in enumerate(rng.integers(128, 1025, size=AUTOTUNE_ROUND)):
        rep.admit(Request(f"tune-{i}", rng.integers(0, cfg.vocab, int(n),
                                                    dtype=np.int32), 4))
    saved = ({k: v.clone() for k, v in rep.cache.items()},
             rep.tokens.copy(), rep.lengths.copy())

    def restore():
        for k, v in saved[0].items():
            rep.cache[k].copy_(v)
        rep.tokens[:] = saved[1]
        rep.lengths[:] = saved[2]

    # one cache file a launch-shape set: the defaults (no file), the
    # winners, the winners with K3 at its default, and each K3 chunk alone
    winners_path = os.environ[autotune.CACHE_ENV]
    k3_point = "decode_attention/b16_h16_hd128_hkv2_s2048_tc1"
    k3_key = autotune._entry_key(dev, "decode_attention",
                                 k3_point.split("/")[1])
    tuned = autotune.load_cache(winners_path)
    if k3_key not in tuned["entries"]:
        raise AssertionError(f"no winner for {k3_point} in the cache")
    paths = {"defaults": winners_path + ".none", "winners": winners_path}
    k3_default = winners[k3_point] == autotune.DEFAULTS["decode_attention"]
    if not k3_default:
        paths["winners_k3_default"] = winners_path + ".k3default"
        autotune._save_cache(
            {"version": tuned["version"],
             "entries": {**tuned["entries"], k3_key: {
                 "tiles": autotune.DEFAULTS["decode_attention"]}}},
            paths["winners_k3_default"])
    chunks = [c["chunk"] for c in autotune.candidates_for(
        "decode_attention", points[k3_point][1]) if c["chunk"]]
    for c in chunks:
        paths[f"chunk{c}"] = f"{winners_path}.chunk{c}"
        autotune._save_cache(
            {"version": autotune.CACHE_VERSION,
             "entries": {k3_key: {"tiles": {"chunk": c, "splits": 0}}}},
            paths[f"chunk{c}"])

    def use(which):
        os.environ[autotune.CACHE_ENV] = paths[which]
        autotune.reset()
        restore()

    def round_at(which):
        use(which)
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = rep.decode_round(route=route)
        ms = (time.perf_counter() - t) * 1e3
        label = autotune.status_label()
        os.environ[autotune.CACHE_ENV] = winners_path
        return toks, ms, label

    def logits_at(which):
        """The round's (slots, V) logits from the saved state (the full
        house: row = slot, as ``decode_round`` steps it)."""
        use(which)
        with torch.no_grad():
            lg, _ = model.decode_step(
                params, rep.cache, torch.from_numpy(rep.tokens).to(dev),
                torch.from_numpy(rep.lengths).to(dev))
        os.environ[autotune.CACHE_ENV] = winners_path
        return lg.float()

    rounds = ["defaults", "winners"] + (["winners_k3_default"]
                                        if not k3_default else [])
    round_at("defaults")                     # warm-up
    runs = {which: [] for which in rounds}
    toks = {}
    for which in rounds + rounds[::-1]:
        toks[which], ms, label = round_at(which)
        if label != ("defaults" if which == "defaults" else "cache"):
            raise AssertionError(f"the round at the {which} resolved as "
                                 f"{label}")
        runs[which].append(ms)
    if sorted(toks["winners"]) != sorted(rep.sessions) \
            or len(toks["winners"]) != AUTOTUNE_ROUND:
        raise AssertionError("the round at the winners lost a session")
    exact = rounds[-1]                       # the winners, K3 at its default
    if toks[exact] != toks["defaults"]:
        raise AssertionError(f"the round at the {exact} gave other tokens: "
                             f"{toks[exact]} against {toks['defaults']}")
    ld = logits_at("defaults")
    top = ld.argmax(dim=-1)
    for sid, slot in rep.sessions.items():
        if int(top[slot]) != toks["defaults"][sid]:
            raise AssertionError("decode_step's logits and the round's "
                                 "tokens disagree")
    moves = {}
    for c in chunks:
        lc = logits_at(f"chunk{c}")
        moved = float((lc - ld).abs().max())
        moves[c] = {"max_abs_logit_moved": moved,
                    "tokens_flipped": int((lc.argmax(dim=-1) != top).sum())}
        if not moved <= K3_LOGIT_MOVE:
            raise AssertionError(f"K3 chunk {c} moved the round's logits by "
                                 f"{moved} > {K3_LOGIT_MOVE}")
    flips = {sid: {"defaults": toks["defaults"][sid],
                   "winners": toks["winners"][sid]}
             for sid in rep.sessions
             if toks["winners"][sid] != toks["defaults"][sid]}
    emit({"phase": "autotune_round", "model": cfg.name,
          "sessions": AUTOTUNE_ROUND, "sweep_s": sweep_s,
          "round_ms": runs, "tokens_equal_exact": exact,
          "winners_tokens_flipped": flips, "k3_chunk_moves": moves,
          "k3_logit_move_max": K3_LOGIT_MOVE,
          "max_abs_logit": float(ld.abs().max()),
          "k2_winner": winners["ring_lookup_bucketed/b32768_q16"],
          "k3_winner": winners[k3_point], "nvidia_smi": smi})
    del rep, params, model, saved, route, ring
    gc.collect()
    torch.cuda.empty_cache()


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _smi() -> str:
    from repro_torch.kernels import backend
    return backend.nvidia_smi_line()


def _device():
    import torch
    return torch.device("cuda", 0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    # every phase runs on the defaults of a fresh launch-shape cache: no
    # user's cache can move a gate, and the autotune phase writes here
    with tempfile.TemporaryDirectory(prefix="repro-torch-autotune-") as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune.json")
        sys.exit(main())
