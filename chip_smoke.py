#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
serving paths at the paper's deployment size (1,000,000 documents x 3584
dims, 2,470 queries, schedule d_start=128, d_max=3584, k0=64, final_k=10),
in phases that each print one JSON line:

  1. device    — ``nvidia-smi`` name and power limit, kernel build time,
                 ptxas's registers and spills, the tensor-core prefill's
                 and backward's plans as the built libraries report them
  2. kernels   — the flat stage-0 and rescore kernels against their plain
                 PyTorch versions on the card, at the serving shapes, with
                 CUDA-event timings (stage 0 also with its device time, the
                 kernel that served it and its bound both as float32 FMA
                 and as 3xTF32; the rescore kernel as each single step of
                 the flat ladder and as the whole ladder in one launch,
                 beside those five steps as separate launches, with its
                 device time and its bound from each row read once to its
                 deepest dim); the IVF and PQ scan kernels on their edge
                 cases (empty and fully tombstoned lists, a query probing
                 dead lists only, k beyond the rows scanned; the list-major
                 scans given the raw lists and the validity bits, and the
                 pre-masked table, which must give the same bits); the
                 stage-0 kernel at k = 512 and 1,024 on its tensor-core
                 pass-1 kernels (dim 128 on ``wgmma``, 512 on ``wide``) at
                 the serving batch, at the paper sweep's 2,470 queries (dims
                 64, 128 and 256 at k 1,024, 128 at 512, all on ``wgmma``'s
                 large-k kernel), with tombstones, and on stores with fewer
                 live rows than k, and on ``fma`` at dim 512 on rows TMA
                 cannot read (the store seen one float past its start);
                 the stage-0 kernel's bf16 route (``wgmma_bf16``) at the
                 serving shape on the rows' (N, 128) bf16 block, with its
                 bf16 bound and a bf16 ``matmul`` + ``topk`` yardstick
  3. corpus    — synthetic corpus generated on the card from ``--seed``,
                 loaded into a ``RetrievalEngine`` (flat backend), warmed up
  4. serving   — ``engine.search`` over every query and requests from client
                 threads through ``EngineDriver``; recall@10 / top-1 against
                 an exact full-dim search, agreement with the plain path,
                 and the kernels' launch counts during the phase (each
                 dispatch one stage-0 launch and one ladder launch); then one
                 more search traced with ``torch.profiler``
  5. mutations — deletes (sources of 50 queries among them) and appends,
                 then searches again: no deleted id may come back
     durability — around phase 5: first the flat engine turns on its
                 mutation WAL and snapshots its store (step 0, 14.3 GB
                 through ``repro_torch.checkpoint``), so phase 5's deletes
                 and appends are logged; after it a fresh engine
                 ``recover``s the state directory (the snapshot and two
                 records) and must hold the live ``db`` bit for bit, serve
                 the live engine's ids with one stage-0 and one ladder
                 launch a dispatch, and return no deleted id;
                 ``profile_stages`` runs there on 32 queries (one stage-0
                 launch, then one rescore step a stage); then a
                 ``ReplicaApplier`` on a third engine bootstraps from the
                 directory and catches up with 100 deletes and 1,000
                 appends of the live engine, and serves its ids.  Prints
                 free disk and MemAvailable, snapshot bytes, seconds and
                 GB/s, WAL bytes, ``recover``'s seconds split into read +
                 CRC, host to device, prefix norms and replay, and the
                 follower's bootstrap and catch-up seconds
     http      — then the live engine (the primary, WAL on) and the
                 caught-up follower are each served by
                 ``RetrievalHTTPServer`` over an ``EngineDriver``, behind a
                 ``ReplicaRouter`` and ``RouterHTTPServer``: 512 queries
                 from 8 client threads through the router, all 200, ids
                 equal to ``engine.search``, no deleted id, both replicas
                 serving, one stage-0 and one ladder launch a dispatch of
                 either engine; 32 of them against the plain path; 64 rows
                 added through the router found top-1 with their
                 ``min_seq`` token, then deleted and gone; a 403 from the
                 follower for a write; deep health and ``/metrics``; then
                 the follower's server stops and 64 searches still answer.
                 Prints qps, round-trip p50 / p95, the ``spans`` medians
                 and the primary's p50 beside phase 4's driver p50.
                 ``http_cli``: the launcher's ``--serve-http`` and
                 ``--connect`` modes as subprocesses on the card; SIGTERM
                 ends the server with exit code 0
  6. variants  — the same corpus behind each IVF / quantized backend (ivf
                 float32 / int8 / pq slabs, quantized pq / int8), one engine
                 at a time: build, ``engine.search`` over every query
                 (launch counts read around it: one stage-0 launch and one
                 ladder launch a dispatch), agreement with the same
                 backend's plain route on the same state, each scan kernel
                 against its plain version on that state after deletes
                 (tombstones inside lists; the list-major scans as the
                 dispatch calls them, the raw member table and the store's
                 validity bits, with the pre-masked route's bits, one
                 ``list_scan_kernel`` launch a call in the profile, the
                 wrapper's host time and the bounds from the distinct
                 probed lists and from each query's own rows; the flat PQ
                 scan also with its lookup bound and its merge's device
                 time, and the ladder at the quantized PQ dispatch shape),
                 and no deleted id returned; the float32 IVF engine also
                 serves through ``EngineDriver``, is profiled (the int8 and
                 PQ IVF engines and the quantized PQ engine too), and
                 absorbs 1,000 appends into spare list slots; its built
                 index is saved (``save_index``) and a second engine over
                 the same corpus loads it (``load_index``): no rebuild, the
                 first engine's ids, build seconds against load seconds
  7. rag       — the RAG generation path at full width: Mistral-Nemo-12B
                 (40 layers x 5120, bf16, random weights from ``--seed``)
                 behind a 262,144 x 5120 flat corpus of mean-pooled
                 256-token documents; 64 queries that copy documents are
                 retrieved through ``EngineDriver`` from 4 client threads
                 (top-1 must be the source) and answered with 32 greedy
                 tokens by ``RAGPipeline.generate`` in batches of 8 (prompt
                 512 tokens); every prefill and decode layer goes through
                 the flash-attention kernels (launches counted: 10,240, the
                 320 prefill calls on the tensor-core ``prefill_wgmma``
                 kernel, the 9,920 decode calls on ``decode_splitkv``, none
                 on ``fma``).  The
                 kernel path's logits are then held against the plain path
                 (the same LM code, each attention call given to the
                 kernel's plain version) on the same weights and prompts,
                 the plain path fed the kernel path's tokens (teacher
                 forcing), and every attention call of the replay against
                 the plain version on its own inputs; a control (one
                 layer's causal mask shifted by one key) must fail the
                 call-by-call check; one ``generate`` is traced with
                 ``torch.profiler``
 7b. lm_families — the other LM families of the registry, one model on
                 the card at a time, each behind a flat corpus of 16,384
                 mean-pooled documents: 16 queries that copy documents
                 (top-1 must be the source), ``RAGPipeline.generate`` in
                 batches of 8, 32 greedy tokens.  StarCoder2-3B (30 layers,
                 prompts of 512) and Gemma3-4B (34 layers, 5 local : 1
                 global, prompts of 2,048, so the 1,024-key window cuts in
                 prefill and decode wraps the ring caches) whole;
                 Qwen3-MoE-235B-A22B (8 of 94 layers) and DeepSeek-V2-236B
                 (the dense layer and 5 MoE layers of 60; MLA) at full width,
                 cut in depth to fit the card.  Flash launches are counted
                 by kernel and checked exactly (prefill on
                 ``prefill_wgmma`` — head dims 128, and 256 for Gemma3 and
                 MLA's padded call —, none on ``fma``, decode on
                 ``decode_splitkv``, none for MLA's absorbed decode);
                 each family is
                 teacher-forced against its plain path as phase 7 is, with
                 the shifted-mask controls (and, for Gemma3, a local
                 layer's window widened by one key) failing the
                 call-by-call check; in the MoE families the logits whose
                 token reached other experts on the two paths are counted
                 and held apart.  First, the flash kernel at the families'
                 new attention shapes (Gemma3's head dim 256 with and
                 without its window, its ring decode, MLA's prefill padded
                 to 256, each dh-256 prefill checked on ``prefill_wgmma``;
                 a head-dim-256 group-4 call off the tiles with a window
                 alone, with its log-sum-exp; Gemma3's global call twice,
                 bit-equal) against its plain version, with SDPA and bounds
  8. recsys    — the recsys serving path at CONFIG width, random weights
                 from ``--seed``, one model at a time: two-tower retrieval
                 (4 + 4 fields of 1M x 256 rows, towers 1024-1024-512-256)
                 builds a 1M-item DB with ``tower_item``, serves user
                 batches of 8 and 512 with ``retrieval_serve`` (progressive
                 search 64 -> 256, k0 128, final_k 10) and scores 512 users x
                 4,096 candidates with ``serve_candidates``, and times the
                 stage-0 kernel at the two-tower's shape (Q 512, dim 64,
                 k 128 over the item DB) beside ``matmul`` + ``topk``, in
                 float32 and on the bf16 route (the DB's (1M, 64) bf16
                 block);
                 DLRM-RM2 (26 x 5M x 64 tables) runs ``recsys_forward`` at
                 512 and 262,144 rows; DIN and AutoInt one 512-row batch
                 each.  Every
                 embedding-bag lookup goes through the CUDA kernel (launches
                 counted, all on its ``vec16`` route); each model is held
                 against its plain path (the same code with every ``ops``
                 entry given its plain version) on the same weights and
                 inputs; recall@10 of retrieval
                 against an exact search is recorded
  9. gnn       — EGNN at CONFIG width (4 layers x 64, 47 classes) on the
                 ogbn-products shape (2,449,029 nodes, 61,859,140 power-law
                 edges made on the card from ``--seed``), then the molecule
                 shape (128 graphs x 30 nodes / 64 edges): 12 segment-sum
                 launches per forward (4 on the kernel for wide rows, 8 on
                 the one for narrow rows); logits and coordinates against the
                 plain path; every segment-sum call of a replay against the
                 plain version on its own inputs, and a control (one call's
                 row pointer shifted by one edge) that must fail that check;
                 one forward traced with ``torch.profiler``
 10. paper     — the paper's experiments at its own scale through
                 ``launch/paper_tables.py``: ``make_corpus(1,000,000,
                 3,584, 2,470)`` (twins and near-twins included) made on
                 the host from ``--seed`` and moved to the card; Table II
                 (truncated top-1 by dim, to 3,584), the five Table III
                 configurations against truncated at their d_max (and
                 ``matmul`` + ``topk``), the reference benchmark's check
                 (the closest row within 2 points), one Fig. 3 cell at
                 k0 = 1,024 on each tensor-core stage-0 kernel (d_start
                 128 on ``wgmma``, 512 on ``wide``, as every truncated
                 search above 256 dims), Table 2b (PCA by power
                 iteration against truncation) and the pooled search
                 against the per-query one at (128, 3,584, 64); every
                 search held against the plain path on the same inputs,
                 and every per-query search one stage-0 and one ladder
                 launch
 11. train    — training through the port's ``TrainLoop`` (AdamW, the
                 train step, every gradient through the hand-written
                 backward kernels).  First each backward kernel against its
                 plain version on the card, with CUDA-event and device
                 times, its bound and the library's backward (SDPA through
                 ``torch.autograd.grad``, ``F.embedding_bag``,
                 ``index_select``): the flash backward, given the forward
                 kernel's log-sum-exp (held to the plain one), at
                 StarCoder2's training shape (q (1, 24, 4,096, 128), kv (1,
                 2, 4,096, 128); route ``bwd_wgmma``, and the same call
                 twice, bit-equal), a windowed head-dim-64 call of a group
                 of 4 off the tiles (``bwd_wgmma``), Gemma3's head dim 256
                 with its 1,024-key window and without it (global), and
                 MLA's padded group-1 call (all three ``bwd_wgmma``, each
                 also twice, bit-equal), and Gemma3's windowed call in
                 float32 at 2,048 tokens (``bwd_fma``, which no main path
                 takes any more); the bag backward at the two-tower shape
                 (4 fields x 8,192 bags onto 4 x 1M x 256) and a padded
                 mean case; the segment backward at EGNN's minibatch_lg
                 budget.  Then StarCoder2-3B at full depth and
                 width (30 layers, bf16, remat on), 6 steps of 4 x 4,096
                 tokens from ``lm_batch_stream`` (train_4k's global batch
                 of 256 cut to 4): finite losses and grad norms, the last
                 loss below the first, two flash forward launches (the
                 forward and its recompute) and one backward a layer a
                 step, all on ``bwd_wgmma``, step ms, tokens/s, the share
                 of the bf16 peak and
                 peak memory; then at batch 1 the kernel path against the
                 plain path (``impl="dense"``, plain attention under
                 autograd) from the same weights — loss within 1e-2, global
                 grad norm within 2%, cosine >= 0.99 for every leaf of the
                 first, middle and last layers and the embedding — and the
                 same check with the middle layer's causal mask shifted by
                 one key on the plain path, which must fail.  Gemma3-4B's
                 first 6 layers (5 windowed, 1 global) at full width, 2
                 steps of 2,048 tokens: the same kernel-vs-plain check at
                 the initial weights, every forward on ``prefill_wgmma``
                 (writing its log-sum-exp), every backward on
                 ``bwd_wgmma`` (none on ``bwd_fma``), step ms.
                 Two-tower retrieval whole (8 x 1M x 256 tables, batches
                 of 8,192, Matryoshka losses): its step-1 gradients against
                 the plain path's, 5 steps, the loss falls.  EGNN on
                 minibatch_lg subgraphs (1,024 seeds, fanout 15 / 10) of a
                 power-law random graph of Reddit's size (232,965 nodes,
                 114,615,892 edges, 602 features; drawn on the card) built
                 as a host CSR (its seconds recorded): step-1 gradients against the plain
                 path's, 5 steps over two subgraphs in turn, step 5's loss
                 (step 1's subgraph) below step 1's
 12. distributed — the multi-device paths over ``torch.distributed``
                 (the card is one GPU, so ranks share it): the
                 corpus-sharded progressive search at the paper's
                 deployment (1,000,000 x 3,584 rows drawn on the card chunk
                 by chunk from ``--seed``, prefix norms, 2,470 noisy-copy
                 queries in batches of 32) across 4 ``gloo`` ranks of
                 250,000 rows each — each rank draws its own slab on the
                 card — in ``local`` and ``global`` mode, then the same
                 calls as an NCCL world of one in this process; held
                 against the one-process ``progressive_search`` (global:
                 ids equal up to near-ties, their count printed; local:
                 recall@10 and top-1 against an exact search no lower;
                 sentinels equal) with each rank's launches (local: one
                 stage-0 and one ladder launch a call; global: one stage-0
                 launch and one rescore step a later stage), per-call ms
                 and the collectives' host time and bytes staged through
                 the host; first the rescore kernel on a candidate table
                 three quarters -1.  Then the staged bf16 search
                 (``build_sharded_search_staged``: each rank's (250,000,
                 128) bf16 block, its float32 rows, stage 0 on
                 ``wgmma_bf16``, one rescore step a later stage) over the
                 4 ``gloo`` ranks and in the NCCL world of one, against
                 the same calls on the plain versions and, top-1, the
                 float32 sharded search (above 0.95); then the two-tower
                 ``retrieval_cand`` cell (``launch/inputs.py``) at
                 1,000,000 items in an NCCL world of one (the bag, the
                 bf16 stage 0, two steps) against its plain path, beside
                 the dry run's bytes of that cell (its whole arguments
                 must be the real ones' bytes).  Then one Qwen3-MoE layer
                 at full width (d_model 4,096, 128 experts, top-8, bf16)
                 on 2 x 512 tokens, expert-parallel over 2 and 4 ranks
                 that each hold only their 128 / ep experts (their bytes
                 printed), against ``moe_apply`` (relative L2 <= 1e-2,
                 the aux loss equal);
                 then ``torch.distributed.run`` of the training launcher
                 on 2 ranks (Qwen3-MoE smoke, 10 steps, checkpointed),
                 resumed on one rank
 13. kernels line, card line, and the final ``{"ok": true, ...}`` line.

Phase 2 also holds the embedding-bag and segment-sum kernels against their
plain versions on their edge cases (bags of 8 and 100 ids with padding, sum
and mean, all-padding bags, an id beyond the vocabulary, bf16 tables, a row
of -0.0, the scalar route; every embedding-bag case ``torch.equal`` to the
plain version, in one launch a call on the route ``route`` names; empty
segments, no rows, one segment holding half the rows, one holding
ogbn-products' largest in-degree); phases 8 and 9 time
them at the path's shapes beside ``F.embedding_bag`` and
``Tensor.index_add_`` / ``torch.segment_reduce`` (yardsticks, timed only
there).  Phase 2 also holds the flash-attention kernels against their plain
version in bfloat16 and float32 at the serving shapes (prefill over 512
tokens, decode over a 543-position cache prefix, with the layouts the LM
path gives them), on the edge cases of the JAX package's tests and on one
compute-bound 4,096-token bf16 prompt, each row naming the kernel that
served it, with CUDA-event and profiler times beside
``F.scaled_dot_product_attention`` (timed only here, as a yardstick) and the
wrapper's host time per decode call (1,000 calls, no synchronise).

Any failed check raises and the script exits non-zero.  Run it from the
root of a checkout: ``python3 chip_smoke.py [--seed N]``.  It needs a CUDA
device and ``nvcc``; without a GPU it exits with an error and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Wall time at import: the clock line also gives the seconds since then,
# so a run's own time can be told from its interpreter's start and exit.
T_IMPORT = time.time()
# The seconds a whole run may take, its kernels' build included.
TIME_LIMIT_S = 1200

# The paper's deployment (configs/paper_rag.py): gte-Qwen2-7B widths, 1M
# docs, 2,470 queries, Table III schedule (128 -> 3584, k0=64); final_k=10
# because a RAG prompt takes several documents.
N_DOCS, D_EMB, N_QUERIES = 1_000_000, 3584, 2470
D_START, K0, FINAL_K = 128, 64, 10
CAPACITY = 1 << 20
BUCKETS = (1, 2, 4, 8, 16, 32)
N_REQUESTS, N_CLIENTS = 256, 4
N_DELETE, N_APPEND = N_DOCS // 100, 10_000

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth,
# float32 rate outside the tensor cores (the search kernels compute in FMA
# float32) and the dense bf16 tensor-core rate (attention on bf16 inputs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# Dense TF32 tensor-core rate: the stage-0 kernel's 3xTF32 products take
# three TF32 operations for each float32 one.
PEAK_TF32_FLOPS = 495e12
# Shared memory's bandwidth on one SM (32 banks of 4 bytes a clock) and the
# H100 SXM's boost clock (NVIDIA data sheet): the flat PQ scan's lookup bound.
SMEM_BYTES_PER_CLOCK = 128
PEAK_SM_CLOCK_HZ = 1.98e9

# Queries a block of the stage-0 yardstick (matmul + topk) scores at once:
# the (512, 1M) score block is 2 GB.
YARD_QUERIES = 512
# Traces taken before a device time is given up as not measured (a trace
# can lose kernel records; `device_ms`).
TRACE_ATTEMPTS = 10
# The stage-0 kernel's large-k cases (phase 2): the paper sweeps k0 to 1,024.
LARGE_K = (512, 1024)

KERNEL_LIBS = ("distance_topk", "distance_topk_bf16", "distance_topk_wide",
               "gather_rescore", "ivf_scan", "pq_scan",
               "flash_attention", "flash_attention_bwd",
               "flash_attention_bwd_wgmma", "embedding_bag", "segment_sum")

# The RAG phase (configs/mistral_nemo_12b.py at full width): a flat corpus
# of 262,144 documents of 256 tokens, 64 queries, 32 new tokens per request
# in LM batches of 8; the prompt is document + query = 512 tokens.
RAG_DOCS, RAG_DOC_LEN, RAG_QUERIES = 262_144, 256, 64
RAG_BATCH, RAG_NEW_TOKENS = 8, 32
# The compute-bound flash case: one 4,096-token prompt at Mistral's heads.
LONG_PROMPT = 4096
# The LM-families phase: each other LM family at full width from its config
# module, behind a flat corpus of FAM_DOCS mean-pooled documents; FAM_QUERIES
# queries that copy documents, LM batches of RAG_BATCH, RAG_NEW_TOKENS greedy
# tokens.  (arch, layers kept — None: the published depth —, document
# tokens — a prompt is twice that —, the flash kernel of its prefill and of
# its decode steps — None: MLA's absorbed decode, no attention kernel.)
# Qwen3-MoE and DeepSeek-V2 are cut in depth to fit the card's 80 GB: 8
# layers of 4.8 GB of bf16 experts; the dense layer and 5 MoE layers of 7.9.
FAMILIES = (("starcoder2-3b", None, 256, "prefill_wgmma", "decode_splitkv"),
            ("gemma3-4b", None, 1024, "prefill_wgmma", "decode_splitkv"),
            ("qwen3-moe-235b-a22b", 8, 256, "prefill_wgmma",
             "decode_splitkv"),
            ("deepseek-v2-236b", 6, 256, "prefill_wgmma", None))
FAM_DOCS, FAM_QUERIES = 16_384, 16
# Tolerances.  Flash kernel vs its plain version: float32 2e-4 (the JAX
# package's own); bfloat16 2e-2, a small multiple of the 7.8e-3 (one bf16
# step between 1 and 2) measured over every case — also the limit for each
# attention call of the RAG path replayed against the plain version on the
# same inputs.  LM logits (float32) of the kernel path vs the plain path
# (the same LM code, every attention call given to the kernel's plain
# version, which rounds where the kernel rounds) after 40 bf16 layers:
# twice the 0.127 measured on the H100 — a one-step bf16 difference in one
# layer grows to about that by the logits.  An argmax disagreement is
# allowed only where the plain path's top-2 margin is below LOGIT_TOL (a
# near-tie); the logit check alone would allow margins up to twice that.
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# The LM families' attention outputs reach |x| of 4 to 8, where one bf16
# step is 0.03125 (StarCoder2-3B on the H100: 0.03125 in prefill and
# decode calls, one rounding of the output): their call-by-call check
# holds each element within FLASH_TOL + FAMILY_CALL_RTOL * |plain|, the
# rtol = atol = 2e-2 of the card tests (tests/test_torch_cuda.py).
FAMILY_CALL_RTOL = FLASH_TOL["bfloat16"]
LOGIT_TOL = 0.25
NEAR_TIE = LOGIT_TOL
# Both are in units of the RMS of the plain path's logits, at least 1.  A
# fan-in head gives logits of RMS about 1 (Mistral-Nemo 0.987, StarCoder2
# 0.987); Gemma3-4B's head is its embedding, rows of unit variance, so its
# logits have RMS 49.9.  On the H100 the sound runs' gaps were 0.062-0.145
# RMS (the largest Gemma3's 7.26), the first layer's shifted-mask control
# 0.73-2.35 RMS: the limit lies between, and the check must reject that
# control.  Shifts in later layers move the logits no more than the sound
# run's bf16 noise, and only the call-by-call check sees them: the plain
# path with every attention output moved one bf16 step moved them as far
# as the kernel path did (Mistral-Nemo 0.139 against 0.132, Gemma3 7.22
# against 7.26; its head alone, on the last hidden state so moved, 1.62).
# A MoE family's logits are held only where their token reached the same
# experts on both paths; at least MOE_HELD_FLOOR of them must be (0.61 and
# 0.79 on the H100 for Qwen3-MoE and DeepSeek-V2 at random weights, where
# one bf16 step on the plain path routes 51% and 30% of tokens apart).
MOE_HELD_FLOOR = 0.5

# The recsys phase: a 1M-item DB from the item tower, user batches of 8
# (one request) and 512 (serve_p99), 512 users x 4,096 candidates; DLRM at
# serve_p99 and serve_bulk (configs/shapes.py).
TT_ITEMS, TT_BATCHES, TT_CANDIDATES = 1_000_000, (8, 512), 4096
P99_BATCH, BULK_BATCH = 512, 262_144
# Tolerances.  Embedding bag vs its plain version: none, torch.equal (both
# add each bag's rows in id order to a float32 sum from +0.0, float32 and
# bf16 tables alike).  Segment sum: 1e-5 of each
# segment's sum of |x| plus 1e-6 (the kernel's float32 order against the
# plain version's float64 sum).  DLRM logits 1e-4 relative to the largest.
# EGNN: logits within EGNN_LOGIT_TOL node-wise (max |Δ| of a node's row over
# the max |plain| of that row; a global ratio is dominated by the hubs and
# barely sees a wrong sum at a small node); coordinates within
# EGNN_COORD_TOL of the largest |plain| coordinate (a node's coordinates
# can cancel far below the terms summed into them, so their node-wise gap
# is recorded, not gated).  Set on the H100 from the measured gaps (logits
# 1.4e-6 node-wise, coordinates 3.5e-12 globally) and the shifted-pointer
# control (0.27 and 5.8e-4): about 70x and 3e5x the former, far below the
# latter.
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
# The largest in-degree of the ogbn-products graph made from seed 0 (the
# phase-9 row's max_segment_rows): one segment-sum case has a hub this long.
OGB_HUB_ROWS = 29_384
DLRM_TOL = 1e-4
EGNN_LOGIT_TOL = 1e-4
EGNN_COORD_TOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, *, runs: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` after ``warmup``.

    ``flush`` (a tensor larger than L2) is overwritten before each run so
    the timed launch finds the cache cold, as the serving path does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, own, *, per_call: int, runs: int = 10,
              at_most: bool = False):
    """Device time per call of ``fn`` from ``torch.profiler``: (every CUDA
    kernel and copy it launches, only those whose name contains one of
    ``own`` — the hand-written kernels, ``per_call`` launches a call).  The
    CUDA-event time of a call also counts the device's idle gaps while the
    host enqueues its small ops.

    A trace can lose kernel records.  Late in the script's run a trace of
    the same calls, taken again and again, alternates between holding all
    of them and holding only a few or none (a fresh process did not);
    traces that also record host ops, or that warm up in a schedule step,
    lose more often.  So the trace records the device alone, after one
    untraced call, and is taken again (up to `TRACE_ATTEMPTS` traces) while
    it holds fewer than ``runs * per_call`` own launches; the row is not
    measured (None, None) when none of them holds all.  With ``at_most``,
    a trace that holds more own launches than that fails the run (a trace
    loses records, it does not invent them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total = mine = 0.0
        launches = 0
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            total += us
            if any(name in ev.key for name in own):
                mine += us
                launches += ev.count
        if at_most and launches > runs * per_call:
            fail(f"{list(own)}: {launches} launches traced in {runs} calls, "
                 f"more than {per_call} a call")
        if launches == runs * per_call:
            return total / runs / 1e3, mine / runs / 1e3
        emit({"phase": "trace", "own": list(own), "runs": runs,
              "own_launches_expected": runs * per_call,
              "own_launches_traced": launches, "attempt": attempt,
              "measured": False})
    return None, None


def bound_ms(n_bytes: float, n_ops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, *, rtol: float = 2e-5, atol: float = 1e-3):
    """(max |Δscore| over finite slots, share of slots equal up to ties, tol).

    A slot agrees when the ids match or both scores agree within the
    tolerance (a near-tie swapped two rows).  The tolerance scales with the
    largest finite score: the kernels sum float32 products in another order
    than the plain versions."""
    gs, gi = got
    ws, wi = want
    if gs.shape != ws.shape or gi.shape != wi.shape:
        fail(f"shape mismatch {tuple(gs.shape)} vs {tuple(ws.shape)}")
    fin_g, fin_w = torch.isfinite(gs), torch.isfinite(ws)
    if not torch.equal(fin_g, fin_w):
        fail("finite / non-finite slots differ between kernel and plain")
    if not torch.equal(gi[~fin_g], torch.full_like(gi[~fin_g], -1)):
        fail("a non-finite slot carries an id other than -1")
    scale = float(ws[fin_w].abs().max()) if fin_w.any() else 0.0
    tol = atol + rtol * scale
    diff = (gs[fin_g] - ws[fin_w]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    close = torch.ones_like(gs, dtype=torch.bool)
    close[fin_g] = (gs[fin_g] - ws[fin_g]).abs() <= tol
    agree = (gi == wi) | close
    return max_err, float(agree.float().mean()), tol


def counters():
    """name -> (module, attribute) of every kernel's launch counter."""
    from repro_torch.kernels import (distance_topk, embedding_bag,
                                     flash_attention, gather_rescore,
                                     ivf_scan, pq_scan, segment_sum)
    return {"distance_topk.l2_topk": (distance_topk, "launches"),
            "gather_rescore.gather_rescore_topk": (gather_rescore, "launches"),
            "ivf_scan.ivf_scan_topk": (ivf_scan, "launches"),
            "pq_scan.pq_scan_topk": (pq_scan, "flat_launches"),
            "pq_scan.pq_ivf_scan_topk": (pq_scan, "ivf_launches"),
            "flash_attention.flash_attention": (flash_attention, "launches"),
            "embedding_bag.embedding_bag": (embedding_bag, "launches"),
            "segment_sum.sorted_segment_sum": (segment_sum, "launches"),
            "flash_attention.flash_attention_backward": (flash_attention,
                                                         "bwd_launches"),
            "embedding_bag.embedding_bag_backward": (embedding_bag,
                                                     "bwd_launches"),
            "segment_sum.sorted_segment_sum_backward": (segment_sum,
                                                        "bwd_launches")}


@contextlib.contextmanager
def plain_ops():
    """Every ``ops`` entry of ``ops.plain`` given its plain version while the
    block runs: the plain path of a model is its own code on the plain
    versions (checked to launch no kernel)."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in vars(ops.plain)}
    before = read_counts()
    for name, fn in vars(ops.plain).items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    if read_counts() != before:
        fail(f"the plain path launched a kernel: {before} -> {read_counts()}")


def by_kernel_counters():
    """module name -> its launches_by_kernel dict (the wrappers whose
    calls go to one of several kernels or kinds of launch)."""
    from repro_torch.kernels import (distance_topk, embedding_bag,
                                     flash_attention, gather_rescore,
                                     ivf_scan, pq_scan, segment_sum)
    return {"flash_attention": flash_attention.launches_by_kernel,
            "flash_attention_bwd": flash_attention.bwd_launches_by_kernel,
            "embedding_bag": embedding_bag.launches_by_kernel,
            "distance_topk": distance_topk.launches_by_kernel,
            "segment_sum": segment_sum.launches_by_kernel,
            "gather_rescore": gather_rescore.launches_by_kernel,
            "ivf_scan": ivf_scan.launches_by_kernel,
            "pq_scan": pq_scan.launches_by_kernel}


def zero_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    for counts in by_kernel_counters().values():
        for kind in counts:
            counts[kind] = 0


def read_counts() -> dict:
    """Every launch counter, with the launches of the flash, stage-0,
    segment-sum, rescore, IVF, PQ and embedding-bag wrappers also by
    kernel, kind or route (``<module>.<kernel>``)."""
    out = {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}
    for mod, counts in by_kernel_counters().items():
        out.update({f"{mod}.{kind}": n for kind, n in counts.items()})
    return out


def ptxas_rows(report: str, kernels: str) -> dict:
    """{"<kernel> <head dim>": (registers, spill store bytes, spill load
    bytes)} of the instantiations named by the regex ``kernels`` in
    ptxas's report (``-v``) of one source; empty when the libraries were
    not built in this process."""
    out = {}
    for m in re.finditer(r"Compiling entry function '\S*?(" + kernels +
                         r")ILi(\d+)E\S*'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers",
                         report, re.S):
        out[f"{m[1]} {m[2]}"] = (int(m[5]), int(m[3]), int(m[4]))
    return out


def run(args) -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import make_schedule
    from repro_torch.core import truncated as T
    from repro_torch.core.index import prefix_squared_norms
    from repro_torch.engine import EngineConfig, RetrievalEngine
    from repro_torch.kernels import _build, distance_topk, gather_rescore

    dev = torch.device("cuda")
    card = card_line()

    # -- 1. device + build ---------------------------------------------------
    t0 = time.perf_counter()
    clock = {}                 # wall seconds of the script's parts

    def lap(part: str) -> None:
        clock[part] = time.perf_counter() - t0 - sum(clock.values())

    for stem in KERNEL_LIBS:                 # the first call builds them all
        _build.library(stem)
    build_s = time.perf_counter() - t0
    lap("build")
    ptxas = {stem: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, rep in _build.ptxas_report.items()}
    # the tensor-core prefill's instantiations by head dim
    prefill = {int(k.split()[1]): v for k, v in ptxas_rows(
        _build.ptxas_report.get("flash_attention", ""),
        "flash_attention_kernel_prefill_wgmma").items()}
    if "flash_attention" in _build.ptxas_report and (
            sorted(prefill) != [64, 128, 256]
            or any(st or ld for _, st, ld in prefill.values())):
        fail(f"the tensor-core prefill's ptxas report: {prefill} (head dim: "
             f"registers, spill store and load bytes)")
    backward = ptxas_rows(_build.ptxas_report.get(
        "flash_attention_bwd_wgmma", ""), r"flash_bwd_\w+?")
    bwd_kernels = {"flash_bwd_dq_wgmma 64", "flash_bwd_dq_wgmma 128",
                   "flash_bwd_dq_wgmma 256", "flash_bwd_dkdv_wgmma 64",
                   "flash_bwd_dkdv_wgmma 128", "flash_bwd_dkdv_roles 256"}
    if "flash_attention_bwd_wgmma" in _build.ptxas_report and (
            set(backward) != bwd_kernels
            or any(st or ld for _, st, ld in backward.values())):
        fail(f"the tensor-core backward's ptxas report: {backward} (kernel "
             f"and head dim: registers, spill store and load bytes)")
    # the large-k tensor-core stage 0 (both row types; NT, HAS_SQ)
    bigk = {}
    for stem in ("distance_topk", "distance_topk_bf16"):
        for m in re.finditer(
                r"Compiling entry function '\S*?l2_scan_bigk_kernelILi(\d+)"
                r"ELb(\d)E\S*'.*?(\d+) bytes spill stores, (\d+) bytes spill "
                r"loads.*?Used (\d+) registers",
                _build.ptxas_report.get(stem, ""), re.S):
            bigk[f"{stem} {m[1]} {m[2]}"] = (int(m[5]), int(m[3]), int(m[4]))
    if "distance_topk" in _build.ptxas_report and (
            len(bigk) != 16 or any(st or ld for _, st, ld in bigk.values())):
        fail(f"the large-k tensor-core stage 0's ptxas report: {bigk} "
             f"(library, tile, norms given: registers, spill store and "
             f"load bytes)")
    plan, bwd_plan = {}, {}    # the tiles, read from the build
    if "flash_attention_bwd_wgmma" in _build.ptxas_report:
        from repro_torch.kernels import flash_attention as fa
        names = ("rows", "roles", "ring", "cluster", "order", "smem_dq",
                 "smem_kv")
        for dh in fa.BWD_WGMMA_HEAD_DIMS:
            built = fa.built_backward_plan(dh)
            if built != fa.backward_plan(dh):
                fail(f"the tensor-core backward at head dim {dh} is built "
                     f"with {built}, backward_plan says "
                     f"{fa.backward_plan(dh)}")
            bwd_plan[dh] = dict(zip(names, built))
    if "flash_attention" in _build.ptxas_report:
        from repro_torch.kernels import flash_attention as fa
        names = ("rows", "keys", "q_stages", "k_stages", "v_stages",
                 "smem_bytes")
        for dh in fa.WGMMA_HEAD_DIMS:
            built = fa.built_prefill_plan(dh)
            if built != fa.prefill_plan(dh):
                fail(f"the tensor-core prefill at head dim {dh} is built "
                     f"with {built}, prefill_plan says {fa.prefill_plan(dh)}")
            plan[dh] = dict(zip(names, built))
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": build_s, "nvcc_s": _build.build_seconds,
          "ptxas": ptxas, "prefill_wgmma_ptxas": prefill,
          "prefill_wgmma_plan": plan, "bwd_wgmma_ptxas": backward,
          "bigk_ptxas": bigk,
          "bwd_wgmma_plan": bwd_plan})

    d_emb, d_start, k0, final_k = D_EMB, D_START, K0, FINAL_K
    sched = make_schedule(d_start, d_emb, k0, final_k=final_k)
    cap = CAPACITY
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    scales = (1.0 + torch.arange(d_emb, device=dev, dtype=torch.float32)) ** -0.2
    scales = scales / scales.norm() * d_emb ** 0.5
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB

    # -- 2. kernels against their plain versions -----------------------------
    db = torch.randn((cap, d_emb), generator=gen, device=dev).mul_(scales)
    sq_all = prefix_squared_norms(db, tuple(s.dim for s in sched.stages))
    valid = torch.rand((cap,), generator=gen, device=dev) >= 0.01
    n_valid = int(valid.sum())
    stage_rows = []
    s0 = sched.stages[0]
    sq0 = sq_all[:, 0].contiguous()
    out32 = None
    for nq in (1, 32):
        src_rows = torch.randint(0, cap, (nq,), generator=gen, device=dev)
        q = db[src_rows] + torch.randn((nq, d_emb), generator=gen,
                                       device=dev) * scales
        row, got = l2_row(torch, f"flat_stage0_q{nq}", q, db, s0.dim, s0.k,
                          sq=sq0, valid=valid)
        stage_rows.append(row)
        if nq == 32:
            q32, out32 = q, got
    # the bf16 route at the same shape: the staged index's (N, d_start)
    # bf16 block of these rows, their float32 norms
    db0 = db[:, :s0.dim].to(torch.bfloat16)
    row, _ = l2_row(torch, "flat_stage0_bf16_q32", q32.to(torch.bfloat16),
                    db0, s0.dim, s0.k, sq=sq0, valid=valid)
    stage_rows.append(row)
    del db0

    # small stores: all rows invalid (every slot (+inf, -1)), and Ncap < k
    for n_small, all_invalid in ((1000, True), (50, False)):
        v_small = torch.full((n_small,), not all_invalid, dtype=torch.bool,
                             device=dev)
        got = distance_topk.l2_topk(q32, db[:n_small], dim=s0.dim, k=s0.k,
                                    sq_at_dim=sq0[:n_small], valid=v_small)
        want = T.truncated_search(q32, db[:n_small], dim=s0.dim, k=s0.k,
                                  db_sq_at_dim=sq0[:n_small], valid=v_small)
        err, agree, tol = compare(torch, got, want)
        n_empty = int((got[1] == -1).sum())
        expect_empty = 32 * (s0.k if all_invalid else s0.k - n_small)
        if agree < 1.0 or err > tol or n_empty != expect_empty \
                or not bool(torch.isinf(got[0][got[1] == -1]).all()):
            fail(f"l2_topk small store n={n_small} all_invalid={all_invalid}:"
                 f" agree={agree} err={err} empty={n_empty}/{expect_empty}")
        emit({"phase": "kernels", "kernel": "distance_topk.l2_topk",
              "case": "all_invalid" if all_invalid else "ncap_below_k",
              "Ncap": n_small, "k": s0.k, "empty_slots": n_empty,
              "ids_agree": agree, "max_abs_err": err})

    large_rows = large_k_rows(torch, dev, gen, db, scales, q32, sq_all,
                              [st.dim for st in sched.stages], valid)

    step_rows = []
    cand = out32[1]
    for j, st in enumerate(sched.stages[1:], start=1):
        sq_j = sq_all[:, j].contiguous()
        c_in = cand
        kern = lambda: gather_rescore.gather_rescore_topk(
            q32, db, c_in, dim=st.dim, k=st.k, sq_at_dim=sq_j, valid=valid)
        plain = lambda: T.rescore_candidates(
            q32, db, c_in, dim=st.dim, k=st.k, db_sq_at_dim=sq_j, valid=valid)

        def yardstick():
            safe = c_in.clamp(min=0).long()
            ip = torch.matmul(db[safe, :st.dim], q32[:, :st.dim, None])[..., 0]
            s = (sq_j[safe] - 2.0 * ip).masked_fill(
                (c_in < 0) | ~valid[safe], float("inf"))
            return torch.topk(s, st.k, dim=1, largest=False)

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, agree, tol = compare(torch, got, want)
        if agree < 1.0 or err > tol:
            fail(f"gather_rescore_topk stage {j}: max|Δ|={err} (tol {tol}), "
                 f"agree={agree}")
        n_c = c_in.shape[1]
        n_real = int(((c_in >= 0) & valid[c_in.clamp(min=0).long()]).sum())
        b, by = bound_ms(32 * n_c * 4 + n_real * (4 * st.dim + 5)
                         + 32 * st.dim * 4 + 32 * st.k * 8,
                         2.0 * n_real * st.dim)
        row = {"kernel": "gather_rescore.gather_rescore_topk", "stage": j,
               "Q": 32, "C": n_c, "dim": st.dim, "k": st.k,
               "max_abs_err": err, "tol": tol, "ids_agree": agree,
               "ms": cuda_ms(torch, kern, flush=flush),
               "plain_ms": cuda_ms(torch, plain, flush=flush),
               "matmul_topk_ms": cuda_ms(torch, yardstick, flush=flush),
               "bound_ms": b, "bound_by": by}
        step_rows.append(row)
        emit({"phase": "kernels", **row})
        cand = got[1]
    # the whole ladder of the dispatch in one launch (the serving path)
    ladder_rows = [ladder_row(
        torch, "flat_dispatch", q32, db, out32[1],
        [(st.dim, st.k) for st in sched.stages[1:]], sq=sq_all,
        cols=list(range(1, len(sched.stages))), valid=valid, flush=flush)]
    del db, sq_all, valid, sq0
    torch.cuda.empty_cache()
    scan_edge_cases(torch, dev)
    flash_rows = flash_kernel_phase(torch, dev, flush)
    bag_rows = bag_edge_cases(torch, dev, flush)
    seg_rows = segment_edge_cases(torch, dev, flush)

    # -- 3. corpus on the card ----------------------------------------------
    def load_corpus(engine):
        """Append the seeded corpus: the same rows for every engine."""
        cgen = torch.Generator(device=dev)
        cgen.manual_seed(args.seed + 1)
        for lo in range(0, N_DOCS, 1 << 16):
            rows = torch.randn((min(1 << 16, N_DOCS - lo), d_emb),
                               generator=cgen, device=dev) * scales
            engine.add_docs(rows)
        if engine.store.size != N_DOCS or engine.store.capacity != cap:
            fail(f"store holds {engine.store.size} rows at capacity "
                 f"{engine.store.capacity}")

    t0 = time.perf_counter()
    engine = RetrievalEngine(
        config=EngineConfig(d_emb=d_emb, d_start=d_start, k0=k0,
                            final_k=final_k, capacity=cap, buckets=BUCKETS),
        device="cuda")
    load_corpus(engine)
    store = engine.store
    nq = N_QUERIES
    src_rows = torch.randperm(N_DOCS, generator=gen, device=dev)[:nq]
    sig = 1.25 * torch.exp(0.55 * torch.randn((nq,), generator=gen, device=dev))
    queries = (store.db[src_rows] + sig[:, None] * scales
               * torch.randn((nq, d_emb), generator=gen, device=dev))
    engine.warmup()
    torch.cuda.synchronize()
    emit({"phase": "corpus", "n_docs": N_DOCS, "d_emb": d_emb,
          "capacity": cap, "queries": nq, "schedule": sched.describe(),
          "load_s": time.perf_counter() - t0,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    def exact_top(qs, k):
        """Exact full-dim L2 top-k over live rows (chunked torch.matmul;
        ground truth only)."""
        n_store = store.size
        out = []
        norms = (store.db[:n_store] ** 2).sum(dim=1)
        dead = ~store.valid[:n_store]
        for a in range(0, qs.shape[0], 256):
            s = norms - 2.0 * torch.matmul(qs[a:a + 256], store.db[:n_store].T)
            s.masked_fill_(dead, float("inf"))
            out.append(torch.topk(s, k, dim=1, largest=False).indices)
        return torch.cat(out)

    def recall(ids, truth, k=final_k):
        ids = torch.as_tensor(ids, device=dev).long()
        hit = (ids[:, :k, None] == truth[:, None, :k]).any(dim=2)
        return float(hit.float().mean()), float((ids[:, 0] == truth[:, 0]).float().mean())

    # -- 4. serving ------------------------------------------------------------
    q_host = queries.cpu().numpy()
    src_host = src_rows.cpu().numpy()
    truth = exact_top(queries, final_k)
    torch.cuda.synchronize()           # the exact search is not search time
    zero_counts()
    t0 = time.perf_counter()
    s_eng, i_eng = engine.search(q_host)
    search_s = time.perf_counter() - t0
    launches_search = read_counts()
    dispatches = len(engine.policy.plan(nq))
    if min(launches_search["distance_topk.l2_topk"],
           launches_search["gather_rescore.gather_rescore_topk"]) <= 0:
        fail(f"flat search launched no kernel: {launches_search}")
    if not (launches_search["distance_topk.l2_topk"]
            == launches_search["gather_rescore.ladder"]
            == launches_search["gather_rescore.gather_rescore_topk"]
            == dispatches):
        fail(f"flat search: {dispatches} dispatches did not each run one "
             f"stage-0 launch and one ladder launch: {launches_search}")

    stats0 = engine.stats.summary()
    drv = driver_run(engine, q_host, i_eng)
    launches = read_counts()
    if launches["distance_topk.l2_topk"] \
            <= launches_search["distance_topk.l2_topk"] \
            or launches["gather_rescore.gather_rescore_topk"] \
            <= launches_search["gather_rescore.gather_rescore_topk"]:
        fail(f"kernel launch counters did not grow on the main path: "
             f"{launches_search} then {launches}")
    if launches["distance_topk.wgmma"] != launches["distance_topk.l2_topk"]:
        fail(f"a flat stage-0 call missed the tensor-core kernel: {launches}")
    if launches["gather_rescore.ladder"] != launches["distance_topk.l2_topk"] \
            or launches["gather_rescore.step"] != 0:
        fail(f"a flat dispatch did not run its ladder as one launch: "
             f"{launches}")

    plain_ids = plain_route_ids(torch, engine, queries)
    r_eng, top1_eng = recall(i_eng, truth)
    r_plain, top1_plain = recall(plain_ids, truth)
    source_top1 = float((i_eng[:, 0] == src_host).mean())
    source_at_10 = float((i_eng == src_host[:, None]).any(axis=1).mean())
    agree_plain = float((torch.as_tensor(i_eng, device=dev) == plain_ids)
                        .float().mean())
    if abs(r_eng - r_plain) > 0.01:
        fail(f"recall@10 {r_eng} of the kernels vs {r_plain} of the plain path")
    if not (np.isfinite(s_eng).all() and s_eng.shape == (nq, final_k)):
        fail("engine scores not finite or of the wrong shape")
    st = engine.stats.summary()
    emit({"phase": "serving", "backend": "flat", "queries": nq,
          "search_s": search_s, "search_qps": nq / search_s, **drv,
          "latency_ms_p50": st["latency_ms_p50"],
          "latency_ms_p95": st["latency_ms_p95"],
          "compute_ms_p50": st["compute_ms_p50"],
          "recall_at_10": r_eng, "top1": top1_eng,
          "source_top1": source_top1, "source_in_10": source_at_10,
          "plain_recall_at_10": r_plain, "plain_top1": top1_plain,
          "ids_equal_plain": agree_plain, "dispatches": dispatches,
          "launches_search": launches_search, "launches": launches,
          "batches": st["n_batches"] - stats0["n_batches"]})
    profile_search(torch, engine, q_host, search_s, "flat")

    # -- 5. mutations, logged (phase durability recovers them) ---------------
    state_dir = tempfile.mkdtemp(prefix="chip_smoke_state_")
    try:
        durability_start(torch, engine, state_dir)
        extra = torch.randperm(N_DOCS, generator=gen,
                               device=dev)[:N_DELETE - 50]
        del_ids = torch.unique(torch.cat([src_rows[:50],
                                          extra])).cpu().numpy()
        deleted = set(int(x) for x in del_ids)
        zero_counts()
        n_gone = engine.delete_docs(del_ids)
        _, i_after = engine.search(q_host)
        back = sorted(set(int(x) for x in i_after.ravel()) & deleted)
        if back:
            fail(f"deleted ids returned: {back[:10]}")
        new_rows = torch.randn((N_APPEND, d_emb), generator=gen,
                               device=dev) * scales
        new_ids = engine.add_docs(new_rows)
        if store.capacity != cap:
            fail("appending within capacity grew the store")
        _, i_new = engine.search(new_rows[:1000].cpu().numpy())
        self_hit = float((i_new[:, 0] == new_ids[:1000]).mean())
        s_again, i_again = engine.search(q_host)
        back = sorted(set(int(x) for x in i_again.ravel()) & deleted)
        if back:
            fail(f"deleted ids returned after the append: {back[:10]}")
        if self_hit < 0.99:
            fail(f"appended rows found themselves top-1 for only {self_hit}")
        mut_counts = read_counts()
        truth2 = exact_top(queries, final_k)
        r_after, top1_after = recall(i_again, truth2)
        emit({"phase": "mutations", "backend": "flat", "deleted": int(n_gone),
              "deleted_sources": 50, "deleted_returned": 0,
              "appended": N_APPEND, "appended_self_top1": self_hit,
              "recall_at_10": r_after, "top1": top1_after,
              "launches": mut_counts})
        if min(mut_counts["distance_topk.l2_topk"],
               mut_counts["gather_rescore.gather_rescore_topk"]) <= 0:
            fail("mutation phase searched without launching the kernels")
        dur_counts = durability_phase(torch, engine, state_dir, q_host,
                                      (s_again, i_again), deleted, gen,
                                      scales, drv["driver_latency_ms_p50"])
    finally:
        if engine.wal is not None:
            engine.wal.close()
        shutil.rmtree(state_dir, ignore_errors=True)
    del engine, store, new_rows, truth2
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. the IVF and quantized backends -----------------------------------
    ctx = dict(torch=torch, dev=dev, queries=queries, q_host=q_host,
               src_host=src_host, truth=truth, recall=recall,
               del_ids=del_ids, load_corpus=load_corpus, flush=flush,
               scales=scales, gen=gen, d_emb=d_emb, sched=sched)
    scan_rows = {}
    for variant in VARIANTS:
        scan_rows.update(serve_variant(variant, ctx, launches))
    del ctx, queries, truth, flush, scales
    gc.collect()
    torch.cuda.empty_cache()

    lap("kernels_to_backends")

    # -- 7. the RAG generation path ------------------------------------------
    launches.update(rag_phase(torch, dev, args.seed))
    lap("rag")

    # -- 7b. the other LM families -------------------------------------------
    families = lm_families_phase(torch, dev, args.seed)
    lap("lm_families")

    # -- 8. the recsys serving path, 9. EGNN inference -------------------------
    counts, rows, tt_stage_rows = recsys_phase(torch, dev, args.seed)
    launches.update(counts)
    bag_rows += rows
    stage_rows += tt_stage_rows
    counts, rows = gnn_phase(torch, dev, args.seed)
    launches.update(counts)
    seg_rows += rows
    ladder_rows += [scan_rows.pop("quantized_pq_ladder")]
    gc.collect()
    torch.cuda.empty_cache()
    lap("recsys_gnn")

    # -- 10. the paper's experiments ------------------------------------------
    paper_counts = paper_phase(torch, dev, args.seed)
    lap("paper")

    # -- 11. training ----------------------------------------------------------
    train = train_phase(torch, dev, args.seed)
    lap("train")

    # -- 12. multi-device --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dist_counts, _ = distributed_phase(torch, dev, args.seed)
    lap("distributed")
    emit({"phase": "clock", "seconds": clock,
          "total_s": time.perf_counter() - t0,
          "since_import_s": time.time() - T_IMPORT, "limit_s": TIME_LIMIT_S,
          "share_of_limit": (time.time() - T_IMPORT) / TIME_LIMIT_S})
    finish(torch, card, stage_rows, large_rows, step_rows, ladder_rows,
           launches, paper_counts, dur_counts, scan_rows, flash_rows,
           bag_rows, seg_rows, families, train, dist_counts)


# -- 10. the paper's experiments ---------------------------------------------

# Timed runs of each search in the paper phase (after one warm-up call), and
# queries a block of the plain path's checks (a per-query search's results
# do not depend on the other queries).
PAPER_RUNS = 3
PLAIN_QUERIES = 512
# The Fig. 3 cells the phase runs: one at k0 = 1,024 on each tensor-core
# pass-1 kernel of stage 0 (d_start 128 on ``wgmma``, 512 on ``wide``), d_max
# 3,584; and the configuration of the pooled-against-per-query row.
PAPER_SWEEP_CELLS = ((128, 3584, 1024), (512, 3584, 1024))
PAPER_POOLED = (128, 3584, 64)


def paper_check(torch, kind, inputs, out) -> dict:
    """One search of the paper phase against the plain path on the same
    inputs (per-query searches in blocks of `PLAIN_QUERIES` queries, the
    pooled one whole), and a per-query progressive search run once more
    with the counters at 0: one stage-0 launch and one ladder launch."""
    from repro_torch.core import (progressive_search,
                                  progressive_search_plain,
                                  progressive_search_pooled_plain, stage_dims)
    from repro_torch.core import truncated as T

    q = inputs["q"]
    if kind == "truncated":
        plain = lambda qq: T.truncated_search(qq, inputs["db"],
                                              dim=inputs["dim"], k=inputs["k"])
        what = f"truncated dim={inputs['dim']}"
    else:
        sched, idx = inputs["sched"], inputs["index"]
        kw = dict(sq_prefix=idx["sq_prefix"], index_dims=stage_dims(sched))
        plain = lambda qq: progressive_search_plain(qq, idx["db"], sched, **kw)
        what = f"{kind} {sched.d_start};{sched.d_max};{sched.k0}"
    if kind == "pooled":
        want = progressive_search_pooled_plain(q, idx["db"], sched, **kw)
    else:
        parts = [plain(q[a:a + PLAIN_QUERIES])
                 for a in range(0, q.shape[0], PLAIN_QUERIES)]
        want = tuple(torch.cat([p[j] for p in parts]) for j in range(2))
    err, agree, tol = compare(torch, out, want)
    if agree < 1.0 or err > tol:
        fail(f"paper {what}: ids agree {agree}, max|Δ| {err} (tol {tol})")
    if kind == "progressive":
        zero_counts()
        progressive_search(q, idx["db"], sched, **kw)
        c = read_counts()
        if not (c["distance_topk.l2_topk"] == c["gather_rescore.ladder"]
                == c["gather_rescore.gather_rescore_topk"] == 1):
            fail(f"paper {what}: one search launched {c}")
    return {"search": what, "ids_agree": agree, "max_abs_err": err,
            "tol": tol}


def paper_phase(torch, dev, seed) -> dict:
    """The paper's experiments at the paper's scale (phase 10): the
    corpus of ``make_corpus(1,000,000, 3,584, 2,470)`` made on the host
    and moved to the card, then ``launch/paper_tables.py``'s Table II, the
    five Table III configurations, the Fig. 3 cells of
    `PAPER_SWEEP_CELLS`, Table 2b and the pooled row, with the launch
    counters at 0 before and read after.  Every search is then held
    against the plain path (`paper_check`).  Returns the phase's
    counters."""
    from repro_torch.configs.paper_rag import CONFIG
    from repro_torch.launch import paper_tables as P
    from repro_torch.rag import make_corpus, to_device

    t0 = time.perf_counter()
    host = make_corpus(CONFIG.n_docs, CONFIG.dim_gte, CONFIG.n_queries,
                       seed=seed)
    make_s = time.perf_counter() - t0
    corpus = to_device(host, dev)
    del host
    gc.collect()
    torch.cuda.synchronize()
    emit({"phase": "paper_corpus", "n_docs": CONFIG.n_docs,
          "dim": CONFIG.dim_gte, "queries": CONFIG.n_queries,
          "make_corpus_s": make_s,
          "to_device_s": time.perf_counter() - t0 - make_s})
    keep = []
    pt = P.PaperTables(corpus.db, corpus.queries, corpus.ground_truth,
                       runs=PAPER_RUNS, keep=keep)
    d_emb = CONFIG.dim_gte
    zero_counts()
    t0 = time.perf_counter()
    rows = P.table2(pt, [d for d in CONFIG.trunc_dims if d < d_emb]
                    + [d_emb])
    trunc = {r["dim"]: r for r in rows}
    rows += P.table3(pt, CONFIG.table3_configs, trunc)
    rows += P.fig3(pt, PAPER_SWEEP_CELLS, trunc)
    rows += P.table2b(pt, seed=seed)
    rows.append(P.pooled_vs_per_query(pt, PAPER_POOLED))
    counts = read_counts()
    run_s = time.perf_counter() - t0
    for r in rows:
        emit({"phase": "paper", **r})
    check = [r for r in rows if r.get("check")][0]
    if not check["ok"]:
        fail(f"Table III: no configuration within {P.MATCH_POINTS} points "
             f"of truncated at d_max: {check}")
    for r in rows:
        for key in ("acc", "prog_acc", "trunc_acc", "pca_acc"):
            if key in r and not 0.0 <= r[key] <= 100.0:
                fail(f"paper row {r}: {key} out of range")
    if min(counts["distance_topk.wgmma"], counts["distance_topk.wide"],
           counts["gather_rescore.ladder"]) <= 0 \
            or counts["distance_topk.fma"] != 0:
        fail(f"the paper phase missed a kernel or went to fma: {counts}")
    checks = [paper_check(torch, *k) for k in keep]
    emit({"phase": "paper_checks", "searches": len(checks),
          "min_ids_agree": min(c["ids_agree"] for c in checks),
          "max_abs_err": max(c["max_abs_err"] for c in checks),
          "run_s": run_s, "launches": counts})
    del pt, keep, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- durability: snapshot, WAL, recovery and a follower (phases 5 and 6) -----

# Runs of each stage in the recovered engine's ``profile_stages`` (after its
# warm-up run), and the mutations the live engine makes while a follower
# tails its log.
PROFILE_RUNS = 3
FOLLOW_DELETES = 100
FOLLOW_APPENDS = 1000


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


@contextlib.contextmanager
def timed_calls(torch, targets):
    """Time every call of each ``(owner, attribute, label)`` while the
    block runs, the device synchronised at both ends of a call: yields
    {label: seconds}, a call made inside another timed call counted under
    ``"label@outer"``."""
    totals, active, saved = {}, [], []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)

        def wrapper(*a, _fn=fn, _label=label, **kw):
            key = _label if not active else f"{_label}@{active[-1]}"
            active.append(_label)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
                active.pop()

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapper)
    try:
        yield totals
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def restore_targets():
    """What a snapshot restore spends its time in: reading the npz (and
    within it the CRC32 checks), the store's restore (host-to-device
    copies, and within it the prefix norms), and the WAL records
    replayed."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.engine import RetrievalEngine
    from repro_torch.engine import store as store_mod

    return [(ckpt, "_read_step", "read"), (ckpt, "_array_crc", "crc"),
            (store_mod.DocStore, "restore_state", "restore"),
            (store_mod, "prefix_squared_norms", "norms"),
            (RetrievalEngine, "_apply_record", "replay")]


def restore_split(t: dict, total_s: float) -> dict:
    read, restore = t.get("read", 0.0), t.get("restore", 0.0)
    norms = t.get("norms@restore", 0.0)
    replay = t.get("replay", 0.0)
    return {"read_crc_s": read, "crc_s": t.get("crc@read", 0.0),
            "host_to_device_s": restore - norms, "prefix_norms_s": norms,
            "replay_s": replay,
            "other_s": total_s - read - restore - replay}


def durability_start(torch, engine, state_dir) -> None:
    """Phase durability, before phase 5's mutations: turn on the live
    engine's WAL and snapshot its 1M x 3,584 store (step 0)."""
    need = engine.store.size * engine.store.d_emb * 4
    free = shutil.disk_usage(state_dir).free
    mem = mem_available_gb()
    if free < 1.2 * need:
        fail(f"the state directory {state_dir} has {free / 1e9:.1f} GB free; "
             f"the snapshot needs {need / 1e9:.1f} GB")
    engine.enable_durability(state_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = engine.save_snapshot()
    save_s = time.perf_counter() - t0
    if os.path.basename(path) != "step_00000000":
        fail(f"the first snapshot is {path}, not step 0")
    n_bytes = dir_bytes(path)
    emit({"phase": "durability_snapshot", "n_docs": engine.store.size,
          "d_emb": engine.store.d_emb, "disk_free_gb": free / 1e9,
          "mem_available_gib": mem, "snapshot_bytes": n_bytes,
          "save_snapshot_s": save_s, "snapshot_gb_per_s": n_bytes / save_s / 1e9})


def durability_phase(torch, engine, state_dir, q_host, again, deleted, gen,
                     scales, serving_p50) -> dict:
    """Phase durability, after phase 5: a fresh engine recovers the state
    directory (snapshot 0 + phase 5's two WAL records) and must hold the
    live engine's store bit for bit and serve its ids through the stage-0
    and ladder kernels; ``profile_stages`` runs there stage by stage; then
    a follower on a third engine bootstraps from the directory and tails
    the live engine's next mutations; then phase ``http`` serves the live
    engine and the follower over HTTP behind the router.  Returns the
    launch counts."""
    from repro_torch.engine import MutationWAL, ReplicaApplier, RetrievalEngine

    nq = q_host.shape[0]
    live = engine.store
    wal_bytes = dir_bytes(os.path.join(state_dir, "wal"))
    rec = RetrievalEngine(config=engine.config, device="cuda")
    with timed_calls(torch, restore_targets()) as t:
        t0 = time.perf_counter()
        report = rec.recover(state_dir)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
    if (report["snapshot_step"], report["replayed"], report["fallbacks"]) \
            != (0, 2, 0) or not isinstance(rec.wal, MutationWAL):
        fail(f"recovery report {report}: expected snapshot 0, 2 records "
             f"replayed, no fallback, and the WAL open")
    got, n = rec.store, live.size
    if (got.size, got.n_active, got.capacity) \
            != (n, live.n_active, live.capacity):
        fail(f"recovered store holds {got.size} rows ({got.n_active} live, "
             f"capacity {got.capacity}); the live one {n} "
             f"({live.n_active}, {live.capacity})")
    if not torch.equal(got.db[:n], live.db[:n]):
        fail("the recovered db differs from the live one")
    if not torch.equal(got.valid, live.valid):
        fail("the recovered validity bits differ from the live ones")

    zero_counts()
    t0 = time.perf_counter()
    s_rec, i_rec = rec.search(q_host)
    search_s = time.perf_counter() - t0
    counts = read_counts()
    dispatches = len(rec.policy.plan(nq))
    if not (counts["distance_topk.l2_topk"] == counts["gather_rescore.ladder"]
            == dispatches) or counts["gather_rescore.step"] != 0:
        fail(f"the recovered engine's {dispatches} dispatches did not each "
             f"run one stage-0 and one ladder launch: {counts}")
    err, agree, tol = compare(
        torch, (torch.as_tensor(s_rec), torch.as_tensor(i_rec)),
        tuple(torch.as_tensor(x) for x in again))
    if agree < 1.0 or err > tol:
        fail(f"recovered engine's ids agree with the live engine's on "
             f"{agree} of slots (max |Δscore| {err}, tol {tol})")
    back = sorted(set(int(x) for x in i_rec.ravel()) & deleted)
    if back:
        fail(f"the recovered engine returned deleted ids: {back[:10]}")
    emit({"phase": "durability", "wal_bytes": wal_bytes,
          "recover_s": recover_s, **restore_split(t, recover_s),
          "report": report, "db_equal": True, "valid_equal": True,
          "size": n, "n_active": got.n_active, "search_s": search_s,
          "queries": nq, "dispatches": dispatches, "ids_agree": agree,
          "max_abs_err": err, "tol": tol, "deleted_returned": 0,
          "launches": counts})

    zero_counts()
    prof = rec.profile_stages(q_host[:32], runs=PROFILE_RUNS)
    p_counts = read_counts()
    n_st = len(rec.sched.stages)
    calls = PROFILE_RUNS + 1                     # the warm-up run and the runs
    if [r["stage"] for r in prof] != list(range(n_st)) \
            or p_counts["distance_topk.l2_topk"] != calls \
            or p_counts["gather_rescore.step"] != (n_st - 1) * calls \
            or p_counts["gather_rescore.ladder"] != 0:
        fail(f"profile_stages: {len(prof)} rows for {n_st} stages, "
             f"launches {p_counts}")
    emit({"phase": "durability_profile", "queries": 32, "runs": PROFILE_RUNS,
          "stages": prof, "launches": p_counts})
    rec.wal.close()
    del rec, got
    gc.collect()
    torch.cuda.empty_cache()

    foll = RetrievalEngine(config=engine.config, device="cuda")
    applier = ReplicaApplier(foll, state_dir)
    with timed_calls(torch, restore_targets()) as t:
        t0 = time.perf_counter()
        boot = applier.bootstrap()
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
    if boot["snapshot_step"] != 0 or foll.wal is not None:
        fail(f"follower bootstrap {boot}")
    # the live engine deletes the top-1 rows of the first queries (so the
    # follower's results depend on applying them) and appends new rows
    del2 = np.unique(again[1][:FOLLOW_DELETES, 0])
    engine.delete_docs(del2)
    engine.add_docs(torch.randn((FOLLOW_APPENDS, live.d_emb), generator=gen,
                                device=live.db.device) * scales)
    t0 = time.perf_counter()
    applied = applier.catch_up()
    torch.cuda.synchronize()
    catch_s = time.perf_counter() - t0
    if applier.applied_seq != engine.wal.last_seq or applied != 4:
        fail(f"follower applied {applied} records to seq "
             f"{applier.applied_seq}; the live WAL is at {engine.wal.last_seq}")
    s_live, i_live = engine.search(q_host)
    zero_counts()
    s_f, i_f = foll.search(q_host)
    f_counts = read_counts()
    err_f, agree_f, tol_f = compare(
        torch, (torch.as_tensor(s_f), torch.as_tensor(i_f)),
        (torch.as_tensor(s_live), torch.as_tensor(i_live)))
    if agree_f < 1.0 or err_f > tol_f:
        fail(f"follower ids agree with the live engine's on {agree_f} of "
             f"slots (max |Δscore| {err_f}, tol {tol_f})")
    gone = deleted | set(int(x) for x in del2)
    back = sorted(set(int(x) for x in i_f.ravel()) & gone)
    if back:
        fail(f"the follower returned deleted ids: {back[:10]}")
    if f_counts["distance_topk.l2_topk"] != dispatches \
            or f_counts["gather_rescore.ladder"] != dispatches:
        fail(f"the follower's search missed the kernels: {f_counts}")
    emit({"phase": "durability_follower", "bootstrap_s": boot_s,
          **{f"bootstrap_{k}": v for k, v in restore_split(t, boot_s).items()},
          "deleted": len(del2), "appended": FOLLOW_APPENDS,
          "records_applied": applied, "catch_up_s": catch_s,
          "applied_seq": applier.applied_seq, "lag": applier.lag(),
          "ids_agree": agree_f, "max_abs_err": err_f, "tol": tol_f,
          "deleted_returned": 0, "launches": f_counts})
    h_counts = http_phase(torch, engine, foll, applier, q_host, gone, gen,
                          scales, serving_p50)
    del foll, applier
    gc.collect()
    torch.cuda.empty_cache()
    http_cli_phase()
    return {"search": counts, "profile": p_counts, "follower": f_counts,
            "http": h_counts}


# -- the serving surface: HTTP front end and router over both engines ---------

# Searches sent through the router (of the 2,470 paper queries) and client
# threads; rows added in one POST and searched back with ``min_seq``
# (a POST stays far below the 64 MiB body limit: 64 x 3,584 floats are
# about 4.6 MB of JSON); searches sent after the follower is stopped; the
# plain-path queries; seconds a launcher subprocess may take.
HTTP_QUERIES, HTTP_CLIENTS = 512, 8
HTTP_NEW_DOCS, HTTP_FAILOVER, HTTP_PLAIN = 64, 64, 32
CLI_TIMEOUT = 120


def http_fan_out(url, bodies, n_threads):
    """POST every body to ``url``/v1/search from ``n_threads`` threads:
    per body (status, payload, round-trip ms), and the wall seconds."""
    from repro_torch.serve import http_call

    out = [None] * len(bodies)

    def client(c):
        for i in range(c, len(bodies), n_threads):
            t0 = time.perf_counter()
            status, payload = http_call(url, "/v1/search", bodies[i],
                                        timeout=60)
            out[i] = (status, payload, (time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(o is None for o in out):
        fail("an HTTP client thread did not finish")
    return out, wall


def http_ok(name, results):
    bad = [(st, pl.get("error")) for st, pl, _ in results if st != 200]
    if bad:
        fail(f"{name}: {len(bad)} of {len(results)} requests failed: "
             f"{bad[:3]}")


def http_phase(torch, engine, foll, applier, q_host, gone, gen, scales,
               serving_p50) -> dict:
    """Phase http: the live engine (primary, WAL on) and its caught-up
    follower each behind ``RetrievalHTTPServer`` with an ``EngineDriver``,
    a ``ReplicaRouter`` in front of both behind ``RouterHTTPServer``:
    searches from client threads, against ``engine.search`` and the plain
    path, read-your-writes through ``min_seq``, the follower's 403, deep
    health and ``/metrics``, then failover.  Returns the launch counts of
    the router searches."""
    import urllib.request

    from repro_torch.engine import EngineDriver, PrimaryReplication
    from repro_torch.engine import wal as wal_mod
    from repro_torch.obs import parse_prometheus
    from repro_torch.serve import (ReplicaRouter, RouterHTTPServer,
                                   http_call, run_server_in_thread,
                                   serve_in_thread)

    t_phase = time.perf_counter()
    # one parse of the newest WAL segment from its start: what each of a
    # deep health probe's four lag reads cost before the cursor parsed
    # only the bytes added since its last read
    newest = wal_mod._list_segments(applier.wal_dir)[-1][1]
    t0 = time.perf_counter()
    wal_mod._scan_segment(newest)
    full_parse_ms = (time.perf_counter() - t0) * 1e3
    qs = q_host[:HTTP_QUERIES]
    k = engine.config.final_k
    s_want, i_want = engine.search(qs)
    drivers = [EngineDriver(engine, max_wait_ms=2.0).start(),
               EngineDriver(foll, max_wait_ms=2.0).start()]
    handles, router = [], None
    try:
        ph = serve_in_thread(engine, drivers[0], require_tenant=False,
                             replication=PrimaryReplication(engine))
        handles.append(ph)
        applier.start()
        fh = serve_in_thread(foll, drivers[1], require_tenant=False,
                             read_only=True, replication=applier)
        handles.append(fh)
        router = ReplicaRouter([ph.url, fh.url], hedge_ms=None).start()
        if not router.wait_ready(2, timeout=60):
            fail(f"replicas not ready behind the router: {router.status()}")
        rh = run_server_in_thread(RouterHTTPServer(router),
                                  thread_name="router-http")
        handles.append(rh)
        t0 = time.perf_counter()
        status, _ = http_call(fh.url, "/healthz?deep=1", timeout=60)
        deep_ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            fail(f"the follower's deep health answered {status}")

        # 1. searches through the router, against engine.search
        batches0 = [e.stats.n_batches for e in (engine, foll)]
        zero_counts()
        bodies = [{"query": q.tolist(), "k": k} for q in qs]
        res, wall = http_fan_out(rh.url, bodies, HTTP_CLIENTS)
        counts = read_counts()
        dispatches = sum(e.stats.n_batches - b
                         for e, b in zip((engine, foll), batches0))
        http_ok("router searches", res)
        if any(len(pl["ids"]) != k for _, pl, _ in res):
            fail("a router search returned fewer than k ids")
        got = (torch.tensor([pl["scores"] for _, pl, _ in res],
                            dtype=torch.float32),
               torch.tensor([pl["ids"] for _, pl, _ in res],
                            dtype=torch.int32))
        err, agree, tol = compare(
            torch, got, (torch.as_tensor(s_want), torch.as_tensor(i_want)))
        if agree < 1.0 or err > tol:
            fail(f"router searches agree with engine.search on {agree} of "
                 f"slots (max |Δscore| {err}, tol {tol})")
        back = sorted(set(int(x) for x in got[1].ravel().tolist()) & gone)
        if back:
            fail(f"the router returned deleted ids: {back[:10]}")
        by = {url: sum(1 for _, pl, _ in res if pl["served_by"] == url)
              for url in (ph.url, fh.url)}
        if min(by.values()) == 0:
            fail(f"one replica served no search: {by}")
        if not (counts["distance_topk.l2_topk"]
                == counts["gather_rescore.ladder"] == dispatches) \
                or counts["gather_rescore.step"] != 0:
            fail(f"{dispatches} HTTP dispatches did not each run one "
                 f"stage-0 and one ladder launch: {counts}")
        lat = [ms for _, _, ms in res]
        prim_lat = [ms for _, pl, ms in res if pl["served_by"] == ph.url]

        # 2. against the plain path
        with plain_ops():
            s_plain, i_plain = engine.search(qs[:HTTP_PLAIN])
        err_p, agree_p, tol_p = compare(
            torch, (got[0][:HTTP_PLAIN], got[1][:HTTP_PLAIN]),
            (torch.as_tensor(s_plain), torch.as_tensor(i_plain)))
        if agree_p < 1.0 or err_p > tol_p:
            fail(f"HTTP answers agree with the plain path on {agree_p} of "
                 f"slots (max |Δscore| {err_p}, tol {tol_p})")

        # 3. read your writes: add through the router, search with min_seq
        new = (torch.randn((HTTP_NEW_DOCS, engine.store.d_emb),
                           generator=gen, device=scales.device)
               * scales).cpu().numpy()
        status, added = http_call(rh.url, "/v1/docs",
                                  {"vectors": new.tolist()}, timeout=120)
        if status != 200 or added.get("served_by") != ph.url \
                or len(added.get("ids", ())) != HTTP_NEW_DOCS:
            fail(f"add through the router: {status} {added.get('error')} "
                 f"served by {added.get('served_by')}")
        new_ids, seq = added["ids"], added["seq"]
        if seq != engine.wal.last_seq:
            fail(f"the add returned seq {seq}; the WAL is at "
                 f"{engine.wal.last_seq}")
        ryw, _ = http_fan_out(rh.url, [
            {"query": v.tolist(), "k": k, "min_seq": seq} for v in new],
            HTTP_CLIENTS)
        http_ok("read-your-writes searches", ryw)
        ryw_top1 = sum(1 for (_, pl, _), i in zip(ryw, new_ids)
                       if pl["ids"][0] == i)
        ryw_by = {url: sum(1 for _, pl, _ in ryw if pl["served_by"] == url)
                  for url in (ph.url, fh.url)}
        if ryw_top1 != HTTP_NEW_DOCS:
            fail(f"only {ryw_top1} of {HTTP_NEW_DOCS} added rows came back "
                 f"top-1 with min_seq {seq}")
        status, deleted = http_call(rh.url, "/v1/docs/delete",
                                    {"ids": new_ids}, timeout=120)
        if status != 200 or deleted["n_deleted"] != HTTP_NEW_DOCS:
            fail(f"delete through the router: {status} {deleted}")
        gone_ryw, _ = http_fan_out(rh.url, [
            {"query": v.tolist(), "k": k, "min_seq": deleted["seq"]}
            for v in new], HTTP_CLIENTS)
        http_ok("searches after the delete", gone_ryw)
        back = set(i for _, pl, _ in gone_ryw for i in pl["ids"]) \
            & set(new_ids)
        if back:
            fail(f"deleted rows came back after min_seq {deleted['seq']}: "
                 f"{sorted(back)[:10]}")

        # 4. the follower is read-only
        status, _ = http_call(fh.url, "/v1/docs",
                              {"vectors": new[:1].tolist()}, timeout=60)
        if status != 403:
            fail(f"a POST /v1/docs to the follower got {status}, not 403")

        # 5. deep health and /metrics
        status, health = http_call(ph.url, "/healthz?deep=1", timeout=60)
        deep = health.get("deep", {})
        if status != 200 or deep.get("driver", {}).get("state") != "running" \
                or deep.get("wal", {}).get("last_seq") != engine.wal.last_seq:
            fail(f"deep health of the primary: {status} {deep}")
        key = (("route", "/v1/search"), ("status", "200"))
        n_200 = 0
        for h in handles[:2]:
            with urllib.request.urlopen(h.url + "/metrics",
                                        timeout=60) as r:
                fams = parse_prometheus(r.read().decode())
            n_200 += fams.get("repro_http_requests_total", {}).get(key, 0)
        if n_200 < HTTP_QUERIES + 2 * HTTP_NEW_DOCS:
            fail(f"/metrics counts {n_200} /v1/search 200s; "
                 f"{HTTP_QUERIES + 2 * HTTP_NEW_DOCS} were sent")

        # 6. failover: stop the follower's server, search on
        fh.stop()
        fo, _ = http_fan_out(rh.url, bodies[:HTTP_FAILOVER], HTTP_CLIENTS)
        n_fo = sum(1 for st, _, _ in fo if st == 200)
        if n_fo != HTTP_FAILOVER:
            errs = [pl for st, pl, _ in fo if st != 200]
            fail(f"{n_fo} of {HTTP_FAILOVER} searches answered after the "
                 f"follower stopped: {errs[:3]}")
        down, t_end = False, time.perf_counter() + 30
        while not down and time.perf_counter() < t_end:
            _, reps = http_call(rh.url, "/v1/replicas", timeout=60)
            down = any(r["url"] == fh.url and not r["alive"]
                       for r in reps.get("replicas", ()))
            time.sleep(0.05)
        if not down:
            fail(f"the router's /v1/replicas still shows the follower up: "
                 f"{reps}")
    finally:
        for h in reversed(handles):
            h.stop()
        if router is not None:
            router.stop()
        for d in drivers:
            d.stop()
        applier.stop()
    spans = {name: statistics.median(pl["spans"][name] for _, pl, _ in res)
             for name in ("queue_ms", "compute_ms")}
    emit({"phase": "http", "requests": HTTP_QUERIES,
          "clients": HTTP_CLIENTS, "http_s": wall,
          "qps": HTTP_QUERIES / wall,
          "http_ms_p50": float(np.percentile(lat, 50)),
          "http_ms_p95": float(np.percentile(lat, 95)),
          "served_by": {"primary": by[ph.url], "follower": by[fh.url]},
          "spans_ms_p50": spans,
          "primary_http_ms_p50": float(np.percentile(prim_lat, 50)),
          "serving_driver_ms_p50": serving_p50,
          "ids_agree": agree, "max_abs_err": err, "tol": tol,
          "deleted_returned": 0, "dispatches": dispatches,
          "launches": counts,
          "plain": {"queries": HTTP_PLAIN, "ids_agree": agree_p,
                    "max_abs_err": err_p, "tol": tol_p},
          "read_your_writes": {"added": HTTP_NEW_DOCS, "seq": seq,
                               "top1": ryw_top1,
                               "served_by": {"primary": ryw_by[ph.url],
                                             "follower": ryw_by[fh.url]},
                               "delete_seq": deleted["seq"],
                               "returned_after_delete": 0},
          "follower_add_status": 403, "metrics_search_200": n_200,
          "deep_wal_last_seq": deep["wal"]["last_seq"],
          "follower_deep_health_ms": deep_ms,
          "wal_segment_bytes": os.path.getsize(newest),
          "wal_segment_full_parse_ms": full_parse_ms,
          "failover": {"requests": HTTP_FAILOVER, "ok": n_fo,
                       "follower_down": down},
          "phase_s": time.perf_counter() - t_phase})
    return counts


def http_cli_phase() -> None:
    """Sub-phase http_cli: the launcher's server and client modes as
    subprocesses on the card; SIGTERM ends the server with exit code 0."""
    import queue
    import signal

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    launch = [sys.executable, "-u", "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    server = subprocess.Popen(
        launch + ["--serve-http", "--port", "0", "--allow-anonymous",
                  "--d-emb", "128", "--docs", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in server.stdout],
                     daemon=True).start()
    seen = []
    try:
        url = None
        while url is None:
            try:
                line = lines.get(timeout=max(0.0, t0 + CLI_TIMEOUT
                                             - time.perf_counter()))
            except queue.Empty:
                fail(f"the launcher printed no URL in {CLI_TIMEOUT} s: "
                     f"{seen[-5:]}")
            seen.append(line.rstrip())
            if line.startswith("[http]   serving on "):
                url = line.split()[3]
        boot_s = time.perf_counter() - t0
        client = subprocess.run(
            launch + ["--connect", url, "--docs", "2048", "--requests",
                      "256", "--clients", "8"],
            capture_output=True, text=True, timeout=CLI_TIMEOUT, env=env,
            cwd=HERE)
        if client.returncode != 0:
            fail(f"the launcher's client exited {client.returncode}: "
                 f"{client.stdout[-2000:]} {client.stderr[-2000:]}")
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=CLI_TIMEOUT)
        if rc != 0:
            fail(f"the launcher's server exited {rc} after SIGTERM: "
                 f"{seen[-5:]}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait(timeout=CLI_TIMEOUT)
    emit({"phase": "http_cli", "server_boot_s": boot_s,
          "client": [ln for ln in client.stdout.splitlines()
                     if ln.startswith(("[seed]", "[client]"))],
          "server_lines": seen[:4], "server_rc": rc,
          "client_rc": client.returncode,
          "total_s": time.perf_counter() - t0})


def index_reload(engine, ctx, i_eng, build_s) -> None:
    """``save_index`` of a built IVF engine, then a second engine over the
    same corpus ``load_index``es it: no rebuild, the first engine's ids."""
    torch = ctx["torch"]
    from repro_torch.engine import RetrievalEngine

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_index_")
    try:
        t0 = time.perf_counter()
        engine.save_index(ckpt_dir)
        save_s = time.perf_counter() - t0
        n_bytes = dir_bytes(ckpt_dir)
        twin = RetrievalEngine(config=engine.config, device="cuda")
        t0 = time.perf_counter()
        ctx["load_corpus"](twin)
        torch.cuda.synchronize()
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not twin.load_index(ckpt_dir):
            fail(f"load_index found no checkpoint in {ckpt_dir}")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    zero_counts()
    _, i_twin = twin.search(ctx["q_host"])
    counts = read_counts()
    if twin.stats.n_rebuilds != 0:
        fail(f"the loaded IVF engine rebuilt {twin.stats.n_rebuilds} times")
    if not np.array_equal(i_twin, i_eng):
        fail(f"the loaded IVF engine's ids equal the first engine's on "
             f"{float((i_twin == i_eng).mean())} of slots")
    if counts["ivf_scan.ivf_scan_topk"] <= 0:
        fail(f"the loaded IVF engine searched without its scan: {counts}")
    emit({"phase": "index_reload", "backend": "ivf", "build_s": build_s,
          "save_index_s": save_s, "index_bytes": n_bytes,
          "load_corpus_s": corpus_s, "load_index_s": load_s,
          "n_rebuilds": 0, "ids_equal": 1.0, "launches": counts})
    del twin
    gc.collect()
    torch.cuda.empty_cache()


# (variant, backend block kwargs, scan kernel its stage 0 runs, full phase)
VARIANTS = (
    ("ivf", ("ivf", {}), "ivf_scan.ivf_scan_topk", True),
    ("ivf_int8", ("ivf", {"stage0_dtype": "int8"}), "ivf_scan.ivf_scan_topk",
     False),
    ("ivf_pq", ("ivf", {"stage0_dtype": "pq"}), "pq_scan.pq_ivf_scan_topk",
     False),
    ("quantized_pq", ("quantized", {"codec": "pq"}), "pq_scan.pq_scan_topk",
     False),
    ("quantized_int8", ("quantized", {"codec": "int8"}), None, False),
)


def serve_variant(variant, ctx, launches) -> dict:
    """Serve the corpus behind one IVF / quantized backend (phase 6).

    Returns {kernel row key: measured row} for the scan kernel checked on
    this engine's state, and adds its serving-search launch counts into
    ``launches`` (the kernels line reports the main paths' counts)."""
    torch, dev = ctx["torch"], ctx["dev"]
    from repro_torch.engine import EngineConfig, RetrievalEngine
    from repro_torch.engine.config import IVFConfig, QuantizedConfig

    name, (backend, opts), kernel, full = variant
    block = (IVFConfig if backend == "ivf" else QuantizedConfig)(**opts)
    engine = RetrievalEngine(
        config=EngineConfig(d_emb=D_EMB, d_start=D_START, k0=K0,
                            final_k=FINAL_K, capacity=CAPACITY,
                            buckets=BUCKETS, backend=block),
        device="cuda")
    t0 = time.perf_counter()
    ctx["load_corpus"](engine)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.maybe_rebuild(force=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine.warmup()
    torch.cuda.synchronize()
    store = engine.store
    queries, q_host = ctx["queries"], ctx["q_host"]
    nq = q_host.shape[0]

    zero_counts()
    t0 = time.perf_counter()
    s_eng, i_eng = engine.search(q_host)
    search_s = time.perf_counter() - t0
    counts = read_counts()
    needed = ["gather_rescore.gather_rescore_topk"] + ([kernel] if kernel
                                                     else [])
    if min(counts[n] for n in needed) <= 0:
        fail(f"{name}: engine.search did not launch {needed}: {counts}")
    dispatches = len(engine.policy.plan(nq))
    if counts["gather_rescore.ladder"] != dispatches \
            or (kernel and counts[kernel] != dispatches):
        fail(f"{name}: {dispatches} dispatches did not each run one ladder "
             f"launch (and one stage-0 launch): {counts}")
    for n in ("ivf_scan.ivf_scan_topk", "pq_scan.pq_scan_topk",
              "pq_scan.pq_ivf_scan_topk", "gather_rescore.gather_rescore_topk",
              "gather_rescore.ladder", "gather_rescore.step",
              "ivf_scan.float32", "ivf_scan.int8", "pq_scan.list",
              *(f"pq_scan.{t}" for t in ("tile_8", "tile_4", "tile_2",
                                         "tile_1"))):
        launches[n] = launches.get(n, 0) + counts[n]
    if not (np.isfinite(s_eng).all() and s_eng.shape == (nq, FINAL_K)):
        fail(f"{name}: engine scores not finite or of the wrong shape")
    if name == "ivf":
        index_reload(engine, ctx, i_eng, build_s)

    state = engine.index_state
    plain_ids = plain_route_ids(torch, engine, queries)
    recall, truth, src_host = ctx["recall"], ctx["truth"], ctx["src_host"]
    r_eng, top1_eng = recall(i_eng, truth)
    r_plain, top1_plain = recall(plain_ids, truth)
    agree_plain = float((torch.as_tensor(i_eng, device=dev) == plain_ids)
                        .float().mean())
    if abs(r_eng - r_plain) > 0.01 or agree_plain < 0.99:
        fail(f"{name}: recall@10 {r_eng} vs plain {r_plain}, ids equal on "
             f"{agree_plain} of slots")
    row = {"phase": "variant", "backend": name,
           "describe": engine.backend.describe(), "queries": nq,
           "load_s": load_s, "build_s": build_s, "search_s": search_s,
           "search_qps": nq / search_s,
           "recall_at_10": r_eng, "top1": top1_eng,
           "source_top1": float((i_eng[:, 0] == src_host).mean()),
           "plain_recall_at_10": r_plain, "plain_top1": top1_plain,
           "ids_equal_plain": agree_plain, "dispatches": dispatches,
           "launches": counts,
           "gauges": {k: v for k, v in engine.backend.gauges(
               state, store.stats()).items() if k in (
                   "n_lists", "list_fill_frac", "coded_frac")},
           "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    if full:
        row.update(driver_run(engine, q_host, i_eng))
        st = engine.stats.summary()
        row.update({"latency_ms_p50": st["latency_ms_p50"],
                    "latency_ms_p95": st["latency_ms_p95"],
                    "compute_ms_p50": st["compute_ms_p50"]})
    emit(row)
    if full or name in ("quantized_pq", "ivf_int8", "ivf_pq"):
        profile_search(torch, engine, q_host, search_s, name)

    # deletes: no deleted id may come back; the scan kernels are then held
    # against their plain versions on this state (tombstones inside lists)
    del_ids = ctx["del_ids"]
    deleted = set(int(x) for x in del_ids)
    zero_counts()
    engine.delete_docs(del_ids)
    _, i_after = engine.search(q_host)
    back = sorted(set(int(x) for x in i_after.ravel()) & deleted)
    if back:
        fail(f"{name}: deleted ids returned: {back[:10]}")
    mut = {"phase": "mutations", "backend": name, "deleted": len(del_ids),
           "deleted_returned": 0}
    if full:
        # appends land in spare list slots (absorbed), found top-1
        new_rows = torch.randn((1000, D_EMB), generator=ctx["gen"],
                               device=dev) * ctx["scales"]
        new_ids = engine.add_docs(new_rows)
        _, i_new = engine.search(new_rows.cpu().numpy())
        g = engine.backend.gauges(engine.index_state, store.stats())
        self_hit = float((i_new[:, 0] == new_ids).mean())
        if g["absorbed_rows"] <= 0 or self_hit < 0.99:
            fail(f"{name}: appends absorbed {g['absorbed_rows']}, found "
                 f"top-1 {self_hit}")
        _, i_again = engine.search(q_host)
        back = sorted(set(int(x) for x in i_again.ravel()) & deleted)
        if back:
            fail(f"{name}: deleted ids returned after the append: {back[:10]}")
        mut.update({"appended": 1000, "absorbed_rows": g["absorbed_rows"],
                    "tail_pending": g["tail_pending"],
                    "appended_self_top1": self_hit})
    mut["launches"] = read_counts()
    if kernel and mut["launches"][kernel] <= 0:
        fail(f"{name}: mutation searches did not launch {kernel}")
    emit(mut)

    rows = {}
    if kernel:
        rows[name] = scan_kernel_row(name, kernel, engine, ctx)
    if name == "quantized_pq":
        rows["quantized_pq_ladder"] = pq_ladder_row(engine, ctx)
    del engine, store, state, plain_ids
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def plain_route_ids(torch, engine, queries):
    """Ids of the engine's backend through its plain route (the kernels'
    plain versions) on the same card tensors and index state, 32 queries
    at a time as the engine dispatches them."""
    store = engine.store
    out = []
    for a in range(0, queries.shape[0], 32):
        _, ids = engine.backend.search_plain(
            queries[a:a + 32], engine.index_state, store.db, store.valid,
            sq_prefix=store.sq_prefix, n_total=store.size, k=FINAL_K)
        out.append(ids)
    return torch.cat(out)


def pq_ladder_row(engine, ctx) -> dict:
    """The rescore ladder at the quantized PQ dispatch shape: the PQ scan's
    candidates (oversampled pool of k0 x 4) of the first 32 queries on the
    engine's own state, rescored at full precision through the remaining
    stages, norms from the rows (the quantized backend keeps no prefix
    norms)."""
    from repro_torch.core.pq import _stage0_ids, pq_lut
    from repro_torch.kernels import pq_scan

    torch, store = ctx["torch"], engine.store
    state = engine.index_state
    idx = state.data["idx"]
    cb, codes = idx["codebooks"], idx["codes"]
    q32 = ctx["queries"][:32].contiguous()
    lut = pq_lut(q32[:, :cb.shape[0] * cb.shape[2]], cb, idx["cent_sq"])
    ids = _stage0_ids(codes, store.valid, state.data["coded_upto"])
    k = ctx["sched"].stages[0].k * engine.backend.pq_oversample
    cand = pq_scan.pq_scan_topk(lut, codes, ids, k=k)[1]
    return ladder_row(torch, "quantized_pq_dispatch", q32, store.db, cand,
                      [(st.dim, st.k) for st in ctx["sched"].stages[1:]],
                      valid=store.valid, flush=ctx["flush"])


def scan_kernel_row(name, kernel, engine, ctx) -> dict:
    """One scan kernel against its plain version on the engine's own state
    (after deletes), at the serving dispatch shape (the first 32 queries),
    with CUDA-event times, a gather + matmul + top-k yardstick and the
    bound from the bytes and operations these inputs need: each probed
    list (or coded row) read once however many queries probe it, padding
    slots as ids only."""
    torch, flush = ctx["torch"], ctx["flush"]
    from repro_torch.core.ivf import _probe
    from repro_torch.core.pq import _stage0_ids, pq_lut
    from repro_torch.kernels import ivf_scan, pq_scan

    store = engine.store
    state = engine.index_state
    be = engine.backend
    q32 = ctx["queries"][:32].contiguous()
    valid = store.valid
    k0 = ctx["sched"].stages[0].k
    extra = {}
    if kernel == "pq_scan.pq_scan_topk":
        idx = state.data["idx"]
        cb, codes = idx["codebooks"], idx["codes"]
        lut = pq_lut(q32[:, :cb.shape[0] * cb.shape[2]], cb, idx["cent_sq"])
        ids = _stage0_ids(codes, valid, state.data["coded_upto"])
        k = k0 * be.pq_oversample
        kern = lambda: pq_scan.pq_scan_topk(lut, codes, ids, k=k)
        plain = lambda: pq_scan.pq_scan_topk_plain(lut, codes, ids, k=k)

        def yardstick():
            s = torch.gather(lut, 2, codes.long().T[None].expand(
                32, -1, -1)).sum(1)                     # (Q, N) ADC
            return torch.topk(s.masked_fill(ids < 0, float("inf")), k,
                              dim=1, largest=False)

        n_live = int((ids >= 0).sum())
        m = codes.shape[1]
        n_bytes = (4 * codes.shape[0] + m * n_live + lut.numel() * 4
                   + 32 * k * 8)
        model = 32 * pq_scan.flat_stage0_bytes_model(
            n=codes.shape[0], k=k, row_bytes=m,
            lut_bytes=4.0 * lut[0].numel())["fused_bytes"]
        n_ops = 32.0 * n_live * m
        tile = pq_scan.tile_size(32, m, lut.shape[2], k)
        shape = (f"Q=32 N={codes.shape[0]} M={m} k={k} tile={tile}")
    else:
        pack = state.data["pack"]
        lists = state.data["lists"]
        probe = _probe(q32, state.data["centroids"], be.n_probe, "l2",
                       state.data["cent_sq"])
        member = ivf_scan.mask_members(lists, valid)
        max_len, d0 = pack["max_len"], pack["dim"]
        pl = probe.long()
        slab = (pl[:, :, None] * max_len
                + torch.arange(max_len, device=pl.device)).reshape(32, -1)
        live_q = int((member[pl] >= 0).sum())          # (query, member) pairs
        distinct = torch.unique(pl)
        live_d = int((member[distinct] >= 0).sum())    # members to read once
        n_slots = distinct.numel() * max_len
        extra["distinct_list_share"] = distinct.numel() / pl.numel()
        extra["live_slot_share"] = live_q / (pl.numel() * max_len)
        if kernel == "ivf_scan.ivf_scan_topk":
            k = k0
            # as the dispatch calls it: the raw member table and the
            # store's validity bits (the plain version masks first)
            kern = lambda: ivf_scan.ivf_scan_topk(q32, probe, lists, pack,
                                                  k=k, valid=valid)
            premasked = lambda: ivf_scan.ivf_scan_topk(q32, probe, member,
                                                       pack, k=k)
            plain = lambda: ivf_scan.ivf_scan_topk_plain(
                q32, probe, lists, pack, k=k, valid=valid)
            qd = ivf_scan._query(q32, pack)

            def yardstick():
                rows = pack["rows"][slab].to(torch.float32)
                ip = torch.matmul(rows, qd[:, :, None])[..., 0]
                s = pack["sq"].reshape(-1)[slab] - 2.0 * ip
                s = s.masked_fill(member[pl].reshape(32, -1) < 0,
                                  float("inf"))
                return torch.topk(s, k, dim=1, largest=False)

            row_b = pack["rows"].element_size() * d0
            n_bytes = (4 * n_slots + (row_b + 4) * live_d + 32 * d0 * 4
                       + probe.numel() * 4 + 32 * k * 8)
            # every query's live rows read for it alone (this design)
            per_query = (4 * pl.numel() * max_len + (row_b + 4 + 1) * live_q
                         + 32 * d0 * 4 + probe.numel() * 4 + 32 * k * 8)
            model = 32 * ivf_scan.stage0_bytes_model(
                n_lists=lists.shape[0], max_len=max_len, n_probe=be.n_probe,
                d0=d0, k=k, member_bytes=pack["rows"].element_size(),
            )["fused_bytes"]
            n_ops = 2.0 * live_q * d0
            shape = (f"Q=32 n_probe={be.n_probe} max_len={max_len} dim={d0} "
                     f"k={k} {pack['dtype']}")
        else:
            k = k0 * be.pq_oversample
            lut = pq_lut(q32[:, :d0], pack["codebooks"], pack["cent_sq"])
            kern = lambda: pq_scan.pq_ivf_scan_topk(q32, probe, lists, pack,
                                                    k=k, lut=lut, valid=valid)
            premasked = lambda: pq_scan.pq_ivf_scan_topk(
                q32, probe, member, pack, k=k, lut=lut)
            plain = lambda: pq_scan.pq_ivf_scan_topk_plain(
                q32, probe, lists, pack, k=k, lut=lut, valid=valid)
            m = pack["rows"].shape[1]

            def yardstick():
                c = pack["rows"][slab].long()                  # (Q, C, M)
                s = torch.gather(lut, 2, c.transpose(1, 2)).sum(1)
                s = s.masked_fill(member[pl].reshape(32, -1) < 0,
                                  float("inf"))
                return torch.topk(s, k, dim=1, largest=False)

            n_bytes = (4 * n_slots + m * live_d + lut.numel() * 4
                       + probe.numel() * 4 + 32 * k * 8)
            per_query = (4 * pl.numel() * max_len + (m + 1) * live_q
                         + lut.numel() * 4 + probe.numel() * 4 + 32 * k * 8)
            model = 32 * ivf_scan.stage0_bytes_model(
                n_lists=lists.shape[0], max_len=max_len, n_probe=be.n_probe,
                d0=d0, k=k, row_bytes=m, lut_bytes=4.0 * lut[0].numel(),
                norms=False)["fused_bytes"]
            n_ops = float(live_q) * m
            shape = (f"Q=32 n_probe={be.n_probe} max_len={max_len} M={m} "
                     f"k={k}")
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err, agree, tol = compare(torch, got, want)
    if agree < 1.0 or err > tol:
        fail(f"{kernel} on the {name} state: max|Δ|={err} (tol {tol}), "
             f"agree={agree}")
    n_dead_slots = int((got[1] == -1).sum())
    b, by = bound_ms(n_bytes, n_ops)
    if kernel == "pq_scan.pq_scan_topk":         # the scan, the merge
        dev_all, dev_own = device_ms(
            torch, kern, ("pq_tile_kernel", "merge_kernel"), per_call=2)
    else:
        # one launch a call, the valid route's bits the pre-masked route's
        pre = premasked()
        torch.cuda.synchronize()
        if not (torch.equal(pre[0], got[0]) and torch.equal(pre[1], got[1])):
            fail(f"{kernel} on the {name} state: the valid route and the "
                 f"pre-masked route differ")
        dev_all, dev_own = device_ms(torch, kern, ("list_scan_kernel",),
                                     per_call=1)
        if dev_own is None:
            fail(f"{kernel}: the trace of {name} did not hold one "
                 f"list_scan_kernel launch a call")
        torch.cuda.synchronize()               # the wrapper's host time
        t0 = time.perf_counter()
        for _ in range(200):
            kern()
        extra["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        extra["launches_per_call"] = 1
        extra["cluster"] = ivf_scan.last_cluster(
            pq_scan._kernel()[0] if "pq_" in kernel else None)
        extra["premasked_ms"] = cuda_ms(torch, premasked, flush=flush)
        extra["bound_per_query_ms"] = bound_ms(per_query, n_ops)[0]
    row = {"kernel": kernel, "backend": name, "shape": shape,
           "max_abs_err": err, "tol": tol, "ids_agree": agree,
           "empty_slots": n_dead_slots,
           "ms": cuda_ms(torch, kern, flush=flush),
           "plain_ms": cuda_ms(torch, plain, flush=flush),
           "gather_matmul_topk_ms": cuda_ms(torch, yardstick, flush=flush),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": b, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
           # the per-query fused byte model summed over the batch: every
           # query's probed rows read for it alone, padding slots included
           "model_bytes": model, "model_bound_ms": bound_ms(model, 0)[0],
           **extra}
    if kernel == "pq_scan.pq_scan_topk":
        # what bounds the flat scan: its Q*N*M four-byte table reads at the
        # shared memory's 128 B a clock on every SM, conflict-free
        row["tile"] = tile
        row["bound_lookup_ms"] = n_ops * 4 / (
            torch.cuda.get_device_properties(0).multi_processor_count
            * SMEM_BYTES_PER_CLOCK * PEAK_SM_CLOCK_HZ) * 1e3
        row["merge_device_ms"] = device_ms(torch, kern, ("merge_kernel",),
                                           per_call=1)[1]
    emit({"phase": "kernels", **row})
    return row


def ladder_row(torch, case, q, db, cand, stages, *, sq=None, cols=None,
               valid=None, flush=None) -> dict:
    """The rescore ladder of one dispatch in one launch against its plain
    version (the plain steps chained), beside the same stages as separate
    single-step launches timed in the same run and beside the launch at
    one CTA a query; with its device time and the bound from the bytes
    these inputs need: each surviving row read once up to its deepest dim
    (``bound_reread_ms``: every stage reading its rows from dim 0)."""
    from repro_torch.kernels import gather_rescore as G

    def sq_col(j):
        return None if cols is None or cols[j] is None else sq[:, cols[j]]

    kern = lambda: G.rescore_ladder_topk(q, db, cand, stages, sq_prefix=sq,
                                         sq_cols=cols, valid=valid)
    one = lambda: G.rescore_ladder_topk(q, db, cand, stages, sq_prefix=sq,
                                        sq_cols=cols, valid=valid, cluster=1)
    plain = lambda: G.rescore_ladder_topk_plain(
        q, db, cand, stages, sq_prefix=sq, sq_cols=cols, valid=valid)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err, agree, tol = compare(torch, got, want)
    if agree < 1.0 or err > tol:
        fail(f"rescore ladder {case}: max|Δ|={err} (tol {tol}), "
             f"agree={agree}")
    alone = one()
    if not (torch.equal(alone[0], got[0]) and torch.equal(alone[1], got[1])):
        fail(f"rescore ladder {case}: one CTA a query changed the result")
    step_in, c = [], cand
    for j, (dim, k) in enumerate(stages):
        step_in.append(c)
        c = G.gather_rescore_topk(q, db, c, dim=dim, k=k, sq_at_dim=sq_col(j),
                                  valid=valid)[1]

    def steps():
        for j, (dim, k) in enumerate(stages):
            G.gather_rescore_topk(q, db, step_in[j], dim=dim, k=k,
                                  sq_at_dim=sq_col(j), valid=valid)

    nq, k_last = q.shape[0], stages[-1][1]
    d_max = max(dim for dim, _ in stages)
    n_bytes = n_reread = (cand.numel() * 4 + nq * 4 * d_max + nq * k_last * 8
                          + (int((cand >= 0).sum()) if valid is not None
                             else 0))
    prev = 0
    for j, (dim, k) in enumerate(stages):
        ok = step_in[j] >= 0
        if valid is not None:
            ok &= valid[step_in[j].clamp(min=0).long()]
        n_ok = int(ok.sum())
        lo = prev if 0 < prev < dim else 0
        norms = 4 * n_ok if sq_col(j) is not None else 0
        n_bytes += n_ok * 4 * (dim - lo) + norms
        n_reread += n_ok * 4 * dim + norms
        prev = dim
    b, by = bound_ms(n_bytes, 0)
    dev_all, dev_own = device_ms(torch, kern, ("rescore_ladder_kernel",),
                                 per_call=1)
    torch.cuda.synchronize()                  # the wrapper's host time a call
    t0 = time.perf_counter()
    for _ in range(200):
        kern()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    row = {"kernel": "gather_rescore.rescore_ladder_topk", "case": case,
           "Q": nq, "C": cand.shape[1], "stages": [list(st) for st in stages],
           "norm_columns": sq is not None and cols is not None,
           "cluster": G.cluster_size(
               nq, torch.cuda.get_device_properties(0).multi_processor_count),
           "max_abs_err": err, "tol": tol, "ids_agree": agree,
           "ms": cuda_ms(torch, kern, flush=flush),
           "ms_one_cta_a_query": cuda_ms(torch, one, flush=flush),
           "single_steps_ms": cuda_ms(torch, steps, flush=flush),
           "plain_ms": cuda_ms(torch, plain, flush=flush),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "host_us_per_call": host_us,
           "bound_ms": b, "bound_by": by,
           "bound_reread_ms": bound_ms(n_reread, 0)[0], "bytes": n_bytes,
           "shape": f"Q={nq} C={cand.shape[1]} (dim,k)="
                    + ",".join(f"({d},{kk})" for d, kk in stages)}
    emit({"phase": "kernels", **row})
    return row


def l2_row(torch, case, q, db, dim, k, *, sq=None, valid=None,
           plain_runs=20):
    """The stage-0 kernel on one input against its plain version, timed
    beside it and beside ``torch.matmul`` + ``torch.topk`` (the yardstick,
    in blocks of at most `YARD_QUERIES` queries), with its device time and
    both bounds: operations at the float32 FMA rate and as 3xTF32 on the
    tensor cores (the bound of ``wgmma`` and ``wide``); on bf16 rows and
    queries (the bf16 route) two bytes a dim and one bf16 product an
    operation, with a bf16 ``matmul`` (float32 accumulation) in the
    yardstick.  ``plain_runs`` runs time the plain version and the
    yardstick (fewer where one call takes seconds).
    Returns (row, kernel output)."""
    from repro_torch.core import truncated as T
    from repro_torch.kernels import distance_topk

    kern = lambda: distance_topk.l2_topk(q, db, dim=dim, k=k, sq_at_dim=sq,
                                         valid=valid)
    plain = lambda: T.truncated_search(q, db, dim=dim, k=k, db_sq_at_dim=sq,
                                       valid=valid)

    bf16 = db.dtype == torch.bfloat16

    def yardstick():
        x = db[:, :dim]
        norms = (x.float() * x.float()).sum(1) if sq is None else sq
        out = []
        for a in range(0, q.shape[0], YARD_QUERIES):
            s = norms - 2.0 * torch.matmul(q[a:a + YARD_QUERIES, :dim],
                                           x.T).float()
            if valid is not None:
                s = s.masked_fill(~valid, float("inf"))
            out.append(torch.topk(s, k, dim=1, largest=False))
        return out

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err, agree, tol = compare(torch, got, want)
    nq, n = q.shape[0], db.shape[0]
    if agree < 1.0 or err > tol:
        fail(f"l2_topk {case}: max|Δ|={err} (tol {tol}), agree={agree}")
    n_read = n if valid is None else int(valid.sum())
    esize = db.element_size()
    n_bytes = (n_read * (esize * dim + (4 if sq is not None else 0))
               + (n if valid is not None else 0) + nq * dim * esize
               + nq * k * 8)
    n_ops = 2.0 * nq * n_read * dim
    b32, by32 = bound_ms(n_bytes, n_ops)
    btf, bytf = bound_ms(n_bytes, 3 * n_ops, PEAK_TF32_FLOPS)
    bbf, bybf = bound_ms(n_bytes, n_ops, PEAK_BF16_FLOPS)
    served = distance_topk.route(q, db, dim, k)
    key = distance_topk.counter_key(served, db.dtype)
    n_groups = distance_topk.plan(q, db, dim, k)[-1]
    # ``wide`` launches its query pre-pass before pass 1
    dev_all, dev_own = device_ms(
        torch, kern, ("l2_scan", "l2_merge", "wide_split"),
        per_call=(2 if n_groups == 1 else 3) + (served == "wide"))
    tensor = served in ("wgmma", "wide")
    slow = dict(runs=plain_runs, warmup=min(3, plain_runs))
    before = distance_topk.launches_by_kernel[key]
    kern()
    if distance_topk.launches_by_kernel[key] != before + 1:
        fail(f"l2_topk {case}: the call did not launch {key}")
    row = {"kernel": "distance_topk.l2_topk", "case": case, "Q": nq,
           "Ncap": n, "dim": dim, "k": k, "served_by": key,
           "dtype": str(db.dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol, "ids_agree": agree,
           "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain, **slow),
           "matmul_topk_ms": cuda_ms(torch, yardstick, **slow),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": bbf if bf16 else btf if tensor else b32,
           "bound_by": bybf if bf16 else bytf if tensor else by32,
           "bound_f32_ms": b32, "bound_3xtf32_ms": btf, "bytes": n_bytes,
           "shape": f"Q={nq} Ncap={n} dim={dim} k={k}"}
    if bf16:
        row["bound_bf16_ms"] = bbf
    emit({"phase": "kernels", **row})
    return row, got


def large_k_rows(torch, dev, gen, db, scales, q32, sq_all, dims,
                 valid) -> list:
    """The stage-0 kernel above k = 256 (phase 2): k = 512 and 1,024 on
    the tensor-core pass-1 kernels at the serving batch (dim 128 on
    ``wgmma``, dim 512 on ``wide``, 1% tombstones) and on ``fma`` at dim
    512 on rows TMA cannot read (the store seen one float past its start,
    norms from the rows), the paper sweep's 2,470-query batch (Fig. 3's
    stage 0 below 512 dims: dims 64, 128 and 256 at k 1,024, 128 at 512;
    dims 64 and 256 with norms from the rows), and stores with fewer live
    rows than k; each held against the plain version.  Returns the timed
    rows."""
    from repro_torch.core import truncated as T
    from repro_torch.kernels import distance_topk

    rows = []
    sq = {d: sq_all[:, dims.index(d)].contiguous() for d in (128, 512)}
    route = {64: "wgmma", 128: "wgmma", 256: "wgmma", 512: "wide"}
    for k in LARGE_K:
        for dim in (128, 512):
            row, _ = l2_row(torch, f"q32_dim{dim}_k{k}", q32, db, dim, k,
                            sq=sq[dim], valid=valid)
            rows.append(row)
    # the rows one float past the store's start: a base TMA cannot read
    row, _ = l2_row(torch, "fma_q32_dim512_k1024", q32[:, 1:], db[:, 1:],
                    512, 1024, valid=valid)
    rows.append(row)
    src = torch.randint(0, db.shape[0], (N_QUERIES,), generator=gen,
                        device=dev)
    q_sweep = db[src] + torch.randn((N_QUERIES, db.shape[1]), generator=gen,
                                    device=dev) * scales
    for dim, k in ((128, 1024), (64, 1024), (256, 1024), (128, 512)):
        row, _ = l2_row(torch, f"sweep_q2470_dim{dim}_k{k}", q_sweep, db,
                        dim, k, sq=sq.get(dim), valid=valid, plain_runs=3)
        rows.append(row)
    for r in rows:
        want = "fma" if r["case"].startswith("fma_") else route[r["dim"]]
        if r["served_by"] != want:
            fail(f"l2_topk {r['case']} served by {r['served_by']}, not "
                 f"{want}")
    n_small = 4000
    few = torch.rand((n_small,), generator=gen, device=dev) < 0.1
    live = int(few.sum())
    for k in LARGE_K:
        for dim in (128, 512):
            got = distance_topk.l2_topk(q32, db[:n_small], dim=dim, k=k,
                                        sq_at_dim=sq[dim][:n_small],
                                        valid=few)
            want = T.truncated_search(q32, db[:n_small], dim=dim, k=k,
                                      db_sq_at_dim=sq[dim][:n_small],
                                      valid=few)
            err, agree, tol = compare(torch, got, want)
            n_empty = int((got[1] == -1).sum())
            if agree < 1.0 or err > tol or n_empty != 32 * (k - live) \
                    or not bool((got[1][:, live:] == -1).all()):
                fail(f"l2_topk k={k} dim={dim} with {live} live rows: "
                     f"agree={agree} err={err} empty={n_empty}")
            emit({"phase": "kernels", "kernel": "distance_topk.l2_topk",
                  "case": f"fewer_live_than_k_dim{dim}_k{k}",
                  "served_by": distance_topk.route(q32, db[:n_small], dim, k),
                  "Ncap": n_small, "live": live, "k": k,
                  "empty_slots": n_empty, "ids_agree": agree,
                  "max_abs_err": err})
    return rows


def scan_edge_cases(torch, dev) -> None:
    """The IVF and PQ scans against their plain versions on small cases:
    an empty list, a fully tombstoned list, tombstones inside lists (the
    list-major scans given the raw lists and the validity bits, as a
    dispatch calls them, and given the pre-masked table: the same bits), a
    query whose every probed list is dead, every member masked, and k
    beyond the rows scanned."""
    from repro_torch.kernels import ivf_scan, pq_scan

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n_lists, max_len, dim = 16, 64, 128
    n = n_lists * max_len
    db = torch.randn((n, dim), generator=g, device=dev)
    slot = torch.arange(max_len, device=dev)
    fill = torch.randint(16, max_len + 1, (n_lists,), generator=g, device=dev)
    lists = torch.arange(n_lists, device=dev)[:, None] * max_len + slot
    lists = torch.where(slot < fill[:, None], lists, -1).to(torch.int32)
    lists[0] = -1                                      # an empty list
    valid = torch.rand((n,), generator=g, device=dev) > 0.2
    valid[lists[1:4].clamp(min=0).long()] = False      # fully tombstoned
    member = ivf_scan.mask_members(lists, valid)
    none = torch.full_like(lists, -1)
    q = torch.randn((8, dim), generator=g, device=dev)
    probe = torch.stack([torch.randperm(n_lists, generator=g, device=dev)[:4]
                         for _ in range(8)]).to(torch.int32)
    probe[0, :2] = torch.tensor([0, 1], device=dev)
    probe[1] = torch.tensor([3, 0, 2, 1], device=dev)  # every list dead
    cb = torch.randn((16, 256, dim // 16), generator=g, device=dev)
    packs = {dt: ivf_scan.pack_ivf_lists(db, lists, dim=dim, dtype=dt,
                                         pq_codebooks=cb)
             for dt in ("float32", "int8", "pq")}
    lut = torch.randn((8, 16, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (n, 16), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.where(valid, torch.arange(n, device=dev, dtype=torch.int32),
                      torch.full((n,), -1, dtype=torch.int32, device=dev))
    cases = []                  # (name, case, k, kernel, plain, args, kw)
    for case, mem, kw in (("tombstones", lists, {"valid": valid}),
                          ("premasked", member, {}),
                          ("all_masked", none, {})):
        for k in (64, 300):                   # 300 > 4 lists x 64 slots
            for dt in ("float32", "int8", "pq"):
                kern, plain = ((ivf_scan.ivf_scan_topk,
                                ivf_scan.ivf_scan_topk_plain) if dt != "pq"
                               else (pq_scan.pq_ivf_scan_topk,
                                     pq_scan.pq_ivf_scan_topk_plain))
                cases.append((f"ivf_scan[{dt}]" if dt != "pq"
                              else "pq_ivf_scan", case, k, kern, plain,
                              (q, probe, mem, packs[dt]), kw))
    for case, idv, k in (("tombstones", ids, 256),
                         ("all_masked", torch.full_like(ids, -1), 64),
                         ("k_beyond_rows", ids[:200], 256)):
        cases.append(("pq_scan", case, k, pq_scan.pq_scan_topk,
                      pq_scan.pq_scan_topk_plain,
                      (lut, codes[:idv.numel()], idv), {}))
    routes = {}
    for kern_name, case, k, kern, plain, a, kw in cases:
        got, want = kern(*a, k=k, **kw), plain(*a, k=k, **kw)
        torch.cuda.synchronize()
        err, agree, tol = compare(torch, got, want)
        n_empty = int((got[1] == -1).sum())
        if agree < 1.0 or err > tol:
            fail(f"{kern_name} {case} k={k}: agree={agree} err={err}")
        if case == "all_masked" and n_empty != got[1].numel():
            fail(f"{kern_name} all masked returned an id")
        if kern_name != "pq_scan" and case != "all_masked":
            if not (bool((got[1][1] == -1).all())
                    and bool(torch.isinf(got[0][1]).all())):
                fail(f"{kern_name} {case}: a query probing dead lists only "
                     f"got an id")
            routes.setdefault((kern_name, k), []).append(got)
        emit({"phase": "kernels", "kernel": kern_name, "case": case, "k": k,
              "empty_slots": n_empty, "ids_agree": agree, "max_abs_err": err})
    for key, (a, b) in routes.items():
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"{key}: the valid route and the pre-masked route differ")


# (case, b, hq, hkv, sq, skv, dh, causal, window): the JAX package's
# TestFlashAttention cases and rows with nothing to attend (sq > skv under
# causal)
FLASH_EDGE_CASES = (
    ("causal", 2, 4, 4, 64, 64, 32, True, None),
    ("gqa", 2, 4, 2, 64, 64, 32, False, None),
    ("uneven_decode_aligned", 1, 2, 2, 50, 70, 32, True, None),
    ("sliding_window", 1, 2, 2, 96, 96, 64, True, 16),
    ("single_token_mqa", 1, 4, 1, 1, 128, 64, False, None),
    ("padding_both_axes_window", 1, 2, 2, 33, 65, 16, True, 8),
    ("nothing_to_attend", 1, 4, 2, 40, 24, 32, True, None),
)


def flash_keep(torch, sq, skv, causal, window, dev):
    """(sq, skv) bool: the keys each query keeps, queries aligned to the end
    of kv (the kernel's mask)."""
    q_pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=dev)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    return keep


def flash_row(torch, case, q, k, v, *, causal, window, flush, scale=None,
              host_time=False, sdpa_inputs=None, n_bytes=None,
              n_ops=None) -> dict:
    """One flash-attention case against its plain version on the card:
    the kernel that served it (the one ``route`` names), its largest error
    within ``FLASH_TOL``, rows with nothing to attend 0, CUDA-event times
    of the kernel, the plain version and ``F.scaled_dot_product_attention``
    (on ``sdpa_inputs`` when given: the same function on other tensors),
    the device time, and the bound from the bytes (q, k, v read once, the
    output written once) and the operations (two products of 2 * dh for
    every (query, key) pair the mask keeps), unless ``n_bytes`` / ``n_ops``
    are given.
    Emits and returns the row; ``host_time`` adds the wrapper's host time
    over 1,000 calls without a synchronise."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dtype = str(q.dtype).split(".")[-1]
    tol = FLASH_TOL[dtype]
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    keep = flash_keep(torch, sq, skv, causal, window, q.device)
    if bool(keep.all()):
        sdpa_kw = {}
    elif causal and window is None and sq == skv:
        sdpa_kw = {"is_causal": True}     # top-left = end-aligned here
    else:
        sdpa_kw = {"attn_mask": keep}     # end-aligned, explicit
    if scale is not None:
        sdpa_kw["scale"] = scale
    sq_, sk_, sv_ = sdpa_inputs or (q, k, v)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, scale=scale)
    sdpa = lambda: F.scaled_dot_product_attention(
        sq_, sk_, sv_, enable_gqa=True, **sdpa_kw)
    before = dict(fa.launches_by_kernel)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    served = [kind for kind, n in fa.launches_by_kernel.items()
              if n != before[kind]]
    if served != [fa.route(q.dtype, dh, sq, hq // hkv, skv)]:
        fail(f"flash_attention {case} {dtype}: served by {served}")
    err = float((got.float() - want.float()).abs().max())
    if err > tol or not bool(torch.isfinite(got).all()):
        fail(f"flash_attention {case} {dtype}: max|Δ|={err} (tol {tol})")
    empty_rows = int((~keep.any(dim=1)).sum())
    if empty_rows and bool(got[:, :, ~keep.any(dim=1)].any()):
        fail(f"flash_attention {case} {dtype}: a row with nothing to "
             f"attend is not 0")
    del got, want
    if n_bytes is None:
        n_bytes = q.element_size() * dh * (2 * b * hq * sq
                                           + 2 * b * hkv * skv)
    if n_ops is None:
        n_ops = 4.0 * dh * b * hq * int(keep.sum())
    bnd, by = bound_ms(n_bytes, n_ops, peak)
    dev_all, dev_own = device_ms(torch, kern, ("flash_attention_kernel",),
                                 per_call=1)
    row = {"kernel": "flash_attention.flash_attention", "case": case,
           "dtype": dtype, "served_by": served[0],
           "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} "
                    f"causal={causal} window={window}",
           "strides": [list(t.stride()) for t in (q, k, v)],
           "max_abs_err": err, "tol": tol, "empty_rows": empty_rows,
           "ms": cuda_ms(torch, kern, flush=flush),
           "plain_ms": cuda_ms(torch, plain, flush=flush),
           "library_ms": cuda_ms(torch, sdpa, flush=flush),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes, "ops": n_ops}
    if scale is not None:
        row["scale"] = scale
    if host_time:
        # the wrapper's host time: enqueue only, no synchronise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            kern()
        row["host_us_per_call"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    row["launches_by_kernel"] = dict(fa.launches_by_kernel)
    emit({"phase": "kernels", **row})
    return row


def flash_kernel_phase(torch, dev, flush) -> list:
    """The flash-attention kernel against its plain version (phase 2), in
    bfloat16 and float32: the serving shapes of the RAG phase (prefill over
    the 512-token prompt; decode at the last step's position over a prefix
    of the (8, 8, 544, 128) cache), the edge cases, and decode steps over
    strided cache prefixes (positions 0, 64, 543); q, k and v of the
    serving shapes have the layouts the LM path gives them.  Every case is
    a `flash_row`: timed beside its plain version and
    ``F.scaled_dot_product_attention`` (the yardstick, which the port never
    calls), with its bound.  Returns the measured rows."""
    from repro_torch.layers.rope import apply_rope

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    s_prompt = 2 * RAG_DOC_LEN
    s_cache = s_prompt + RAG_NEW_TOKENS
    theta = 1e6                           # Mistral-Nemo-12B's rope_theta
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        def projected(b, s, h, pos0=0):
            """(B, H, S, Dh) as ``mha_forward`` / ``mha_decode`` hand q and
            k to the kernel: a (B, S, H, Dh) projection, transposed and
            rotated."""
            pos = torch.arange(pos0, pos0 + s, device=dev)
            return apply_rope(rnd(b, s, h, 128).transpose(1, 2), pos, theta)

        # (case, q, k, v, causal, window); prefill's v is the transposed
        # (B, S, Hkv, Dh) projection, a strided view, as on the path
        cases = [("prefill", projected(RAG_BATCH, s_prompt, 32),
                  projected(RAG_BATCH, s_prompt, 8),
                  rnd(RAG_BATCH, s_prompt, 8, 128).transpose(1, 2), True,
                  None)]
        kc, vc = rnd(RAG_BATCH, 8, s_cache, 128), rnd(RAG_BATCH, 8, s_cache, 128)
        cases.append(("decode", projected(RAG_BATCH, 1, 32, s_cache - 2),
                      kc[:, :, :s_cache - 1], vc[:, :, :s_cache - 1], True,
                      None))
        for case, b, hq, hkv, sq, skv, dh, causal, window in FLASH_EDGE_CASES:
            cases.append((case, rnd(b, hq, sq, dh), rnd(b, hkv, skv, dh),
                          rnd(b, hkv, skv, dh), causal, window))
        kc2, vc2 = rnd(2, 8, 544, 128), rnd(2, 8, 544, 128)
        for pos in (0, 64, 543):
            cases.append((f"strided_cache_prefix_pos{pos}",
                          projected(2, 1, 32, pos), kc2[:, :, :pos + 1],
                          vc2[:, :, :pos + 1], True, None))
        if dtype == "bfloat16":
            # compute-bound: 137 GFLOP of causal products over 4,096 tokens
            cases.append(("prefill_4k", projected(1, LONG_PROMPT, 32),
                          projected(1, LONG_PROMPT, 8),
                          rnd(1, LONG_PROMPT, 8, 128).transpose(1, 2), True,
                          None))
        for case, q, k, v, causal, window in cases:
            rows.append(flash_row(torch, case, q, k, v, causal=causal,
                                  window=window, flush=flush,
                                  host_time=case == "decode"))
        del cases, kc, vc, kc2, vc2
    torch.cuda.empty_cache()
    return rows


def rag_phase(torch, dev, seed) -> dict:
    """The RAG generation path at full width (phase 7); returns the launch
    counts of its main path (retrieval through the driver, then
    generation)."""
    from repro_torch.configs.mistral_nemo_12b import CONFIG
    from repro_torch.launch.serve import run_clients
    from repro_torch.models import lm as LM
    from repro_torch.rag import RAGPipeline, mean_pool_embedder

    cfg = CONFIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM.init_lm(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    doc_tokens = torch.randint(1, cfg.vocab, (RAG_DOCS, RAG_DOC_LEN),
                               generator=g, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    embed = mean_pool_embedder(lm)
    db = embed(doc_tokens)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = RAGPipeline(lm, db, doc_tokens, d_start=D_START, k0=K0,
                       buckets=BUCKETS, device=dev)
    del db
    pipe.engine.warmup()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    src = torch.randperm(RAG_DOCS, generator=g, device=dev)[:RAG_QUERIES]
    queries = doc_tokens[src].cpu().numpy()      # copies of documents
    src = src.cpu().numpy()
    del doc_tokens
    emit({"phase": "rag_setup", "model": cfg.name, "params": n_params,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "dtype": cfg.param_dtype, "init_s": init_s, "docs": RAG_DOCS,
          "doc_len": RAG_DOC_LEN, "d_emb": cfg.d_model, "embed_s": embed_s,
          "engine_load_s": load_s, "schedule": pipe.sched.describe(),
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    # -- the main path: retrieval through the driver, then generation --------
    zero_counts()
    qvecs = embed(queries).cpu().numpy()
    driver = pipe.start_driver(max_wait_ms=2.0)
    try:
        results, wall = run_clients(driver, qvecs, N_CLIENTS, 0.0)
    finally:
        pipe.stop_driver()
    retrieved = np.stack([r.doc_ids for r in results])
    lat = sorted(r.stats.latency_ms for r in results)
    hit = float((retrieved[:, 0] == src).mean())
    if hit < 1.0:
        fail(f"rag: top-1 is the source document for only {hit} of queries")
    gen_ms, generated = [], []
    for i in range(0, RAG_QUERIES, RAG_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.generate(queries[i:i + RAG_BATCH],
                            retrieved[i:i + RAG_BATCH],
                            max_new_tokens=RAG_NEW_TOKENS)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(out)
    counts = read_counts()
    n_batches = RAG_QUERIES // RAG_BATCH
    want_launches = n_batches * cfg.n_layers * RAG_NEW_TOKENS  # 1 prefill + 31 steps
    want_by_kernel = {"prefill_wgmma": n_batches * cfg.n_layers,
                      "decode_splitkv": n_batches * cfg.n_layers
                      * (RAG_NEW_TOKENS - 1), "fma": 0}
    by_kernel = {kind: counts[f"flash_attention.{kind}"]
                 for kind in want_by_kernel}
    if counts["flash_attention.flash_attention"] != want_launches \
            or by_kernel != want_by_kernel:
        fail(f"rag: flash_attention launched "
             f"{counts['flash_attention.flash_attention']} times "
             f"({by_kernel}), expected {want_launches} ({want_by_kernel})")
    if min(counts["distance_topk.l2_topk"],
           counts["gather_rescore.gather_rescore_topk"]) <= 0:
        fail(f"rag: retrieval launched no search kernel: {counts}")
    if counts["gather_rescore.ladder"] != counts["distance_topk.l2_topk"] \
            or counts["gather_rescore.step"] != 0:
        fail(f"rag: a retrieval dispatch did not run its ladder as one "
             f"launch: {counts}")
    generated = torch.cat(generated)
    if generated.shape != (RAG_QUERIES, RAG_NEW_TOKENS) or bool(
            ((generated < 0) | (generated >= cfg.vocab)).any()):
        fail(f"rag: generated tokens of shape {tuple(generated.shape)} "
             f"out of range")

    emit({"phase": "rag", "queries": RAG_QUERIES, "clients": N_CLIENTS,
          "retrieval_s": wall, "retrieval_qps": RAG_QUERIES / wall,
          "retrieval_latency_ms_p50": lat[len(lat) // 2],
          "retrieval_latency_ms_p95": lat[int(0.95 * (len(lat) - 1))],
          "top1_hit_rate": hit, "batch": RAG_BATCH,
          "prompt_len": 2 * RAG_DOC_LEN, "new_tokens": RAG_NEW_TOKENS,
          "generate_ms": gen_ms, "generate_ms_mean": statistics.mean(gen_ms),
          "launches": counts,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    profile_generate(torch, pipe, queries[:RAG_BATCH],
                     retrieved[:RAG_BATCH], gen_ms[0])

    # -- kernel path vs plain path, teacher-forced ---------------------------
    teacher_forced_check(torch, pipe, queries, retrieved, generated)
    del pipe, lm, embed
    gc.collect()
    torch.cuda.empty_cache()
    return {name: n for name, n in counts.items()
            if name.startswith("flash_attention.")}


# ---------------------------------------------------------------------------
# the other LM families (phase 7b)
# ---------------------------------------------------------------------------

def family_flash_rows(torch, dev) -> list:
    """The flash kernel at the attention shapes the families bring to the
    card, bf16, batch 8, each a `flash_row` (kernel against its plain
    version, CUDA-event and device ms, bound, SDPA): StarCoder2's and
    Qwen3's 512-token prefill (groups of 12 and 16), Gemma3's 2,048-token
    prefill at head dim 256 with and without its 1,024-key window, its ring
    decode (a full ring of 1,024 slots, after the wrap) and a global layer's
    decode over the 2,079-position prefix; and DeepSeek-V2's MLA prefill,
    q / k of 192 and v of 128 zero-padded to 256, its bound reckoned from
    the unpadded tensors and products, SDPA run on the unpadded ones, and
    the kernel's output held to the plain version on the unpadded inputs
    too.  Every head-dim-256 prefill must be served by ``prefill_wgmma``;
    besides Gemma3's, a call of a group of 4 at head dim 256 with Sq !=
    Skv, neither a multiple of 64, and a window without the causal mask;
    the log-sum-exp of both held to the plain one (`flash_lse_check`), and
    Gemma3's global call made twice, bit-equal."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.layers.mla import padded_head_dim
    from repro_torch.layers.rope import apply_rope

    prompt = {arch: 2 * doc_len for arch, _, doc_len, _, _ in FAMILIES}
    g = torch.Generator(device=dev)
    g.manual_seed(13)

    def on_route(row):
        """A head-dim-256 bf16 prefill row, failed unless the tensor-core
        prefill served it."""
        if row["served_by"] != "prefill_wgmma":
            fail(f"flash_attention {row['case']}: served by "
                 f"{row['served_by']}, not prefill_wgmma")
        return row

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    b = RAG_BATCH

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def projected(s, h, dh, theta, pos0=0):
        """(B, H, S, Dh): a (B, S, H, Dh) projection, transposed, rotated."""
        pos = torch.arange(pos0, pos0 + s, device=dev)
        return apply_rope(rnd(b, s, h, dh).transpose(1, 2), pos, theta)

    rows = []
    for arch, case in (("starcoder2-3b", "starcoder2_prefill"),
                       ("qwen3-moe-235b-a22b", "qwen3_prefill")):
        c = get_arch(arch).CONFIG
        s = prompt[arch]
        rows.append(flash_row(
            torch, case, projected(s, c.n_heads, c.d_head, c.rope_theta),
            projected(s, c.n_kv_heads, c.d_head, c.rope_theta),
            rnd(b, s, c.n_kv_heads, c.d_head).transpose(1, 2), causal=True,
            window=None, flush=flush))
    gm = get_arch("gemma3-4b").CONFIG
    s = prompt["gemma3-4b"]
    for case, window, theta in (("gemma3_global_prefill", None,
                                 gm.rope_theta),
                                ("gemma3_window_prefill", gm.window,
                                 gm.rope_theta_local)):
        qkv = (projected(s, gm.n_heads, gm.d_head, theta),
               projected(s, gm.n_kv_heads, gm.d_head, theta),
               rnd(b, s, gm.n_kv_heads, gm.d_head).transpose(1, 2))
        row = on_route(flash_row(torch, case, *qkv, causal=True,
                                 window=window, flush=flush))
        if window is None:
            _, row["lse_rel_err"] = flash_lse_check(
                torch, case, *qkv, causal=True, window=None)
            first = fa.flash_attention(*qkv, causal=True)
            second = fa.flash_attention(*qkv, causal=True)
            row["twice_bit_equal"] = bool(torch.equal(first, second))
            if not row["twice_bit_equal"]:
                fail(f"flash_attention {case}: two calls differ")
            emit({"phase": "kernels", "case": f"{case}_twice",
                  "served_by": row["served_by"], "calls": 2,
                  "bit_equal": row["twice_bit_equal"],
                  "lse_rel_err": row["lse_rel_err"]})
            del first, second
        rows.append(row)
        del qkv
    # head dim 256, a group of 4, Sq != Skv and neither a multiple of 64,
    # a window without the causal mask
    qkv = (rnd(2, 16, 1000, 256), rnd(2, 4, 1234, 256), rnd(2, 4, 1234, 256))
    row = on_route(flash_row(torch, "dh256_group4_window", *qkv,
                             causal=False, window=300, flush=flush))
    _, row["lse_rel_err"] = flash_lse_check(
        torch, "dh256_group4_window", *qkv, causal=False, window=300)
    emit({"phase": "kernels", "case": "dh256_group4_window",
          "lse_rel_err": row["lse_rel_err"]})
    rows.append(row)
    del qkv
    pos = s + RAG_NEW_TOKENS - 2                     # the last decode step
    ring = rnd(b, gm.n_kv_heads, gm.window, gm.d_head)
    ring_v = rnd(b, gm.n_kv_heads, gm.window, gm.d_head)
    rows.append(flash_row(
        torch, "gemma3_ring_decode",
        projected(1, gm.n_heads, gm.d_head, gm.rope_theta_local, pos), ring,
        ring_v, causal=True, window=None, flush=flush))
    kc = rnd(b, gm.n_kv_heads, s + RAG_NEW_TOKENS, gm.d_head)
    vc = rnd(b, gm.n_kv_heads, s + RAG_NEW_TOKENS, gm.d_head)
    rows.append(flash_row(
        torch, "gemma3_global_decode",
        projected(1, gm.n_heads, gm.d_head, gm.rope_theta, pos),
        kc[:, :, :pos + 1], vc[:, :, :pos + 1], causal=True, window=None,
        flush=flush, host_time=True))
    del ring, ring_v, kc, vc

    m = get_arch("deepseek-v2-236b").CONFIG
    dqk, dv, h = m.mla.d_nope + m.mla.d_rope, m.mla.d_v, m.n_heads
    s, dh = prompt["deepseek-v2-236b"], padded_head_dim(m.mla)
    q, k, v = rnd(b, h, s, dqk), rnd(b, h, s, dqk), rnd(b, h, s, dv)
    qp, kp, vp = (F.pad(q, (0, dh - dqk)), F.pad(k, (0, dh - dqk)),
                  F.pad(v, (0, dh - dv)))
    kept = s * (s + 1) // 2
    n_ops = 2.0 * (dqk + dv) * b * h * kept
    row = on_route(flash_row(
        torch, "mla_prefill_padded", qp, kp, vp, causal=True, window=None,
        scale=dqk ** -0.5, flush=flush, sdpa_inputs=(q, k, v), n_ops=n_ops,
        n_bytes=q.element_size() * b * h * s * (2 * dqk + 2 * dv)))
    got = fa.flash_attention(qp, kp, vp, causal=True,
                             scale=dqk ** -0.5)[..., :dv]
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=dqk ** -0.5)
    err = float((got.float() - want.float()).abs().max())
    if err > FLASH_TOL["bfloat16"]:
        fail(f"flash_attention mla_prefill_padded: the padded call differs "
             f"from the unpadded plain version by {err}")
    row.update({"unpadded_max_abs_err": err, "unpadded_ops": n_ops,
                "padded_ops": 4.0 * dh * b * h * kept,
                "padded_bytes": qp.element_size() * b * h * s * 4 * dh})
    emit({"phase": "kernels", "case": "mla_prefill_padded",
          "unpadded_max_abs_err": err, "unpadded_ops": n_ops,
          "padded_ops": row["padded_ops"]})
    rows.append(row)
    del q, k, v, qp, kp, vp, got, want, flush
    torch.cuda.empty_cache()
    return rows


def family_run(torch, dev, seed, arch, n_layers, doc_len, prefill_kind,
               decode_kind) -> dict:
    """One LM family through ``RAGPipeline`` at full width (depth cut to
    ``n_layers`` when given): retrieval of copies of documents (top-1 must
    be the source), then ``generate`` a batch at a time, every flash call
    counted and its kernel checked; one ``generate`` traced; then the
    teacher-forced check against the plain path.  Emits the family's rows
    and returns its flash launches by kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm as LM
    from repro_torch.rag import RAGPipeline, mean_pool_embedder

    t_run = time.perf_counter()
    gc.collect()                  # what an earlier phase left for the collector
    torch.cuda.empty_cache()
    full = get_arch(arch).CONFIG
    cfg = (full if n_layers is None
           else dataclasses.replace(full, n_layers=n_layers))
    reduced = ([] if n_layers is None else
               [f"n_layers {full.n_layers} -> {n_layers} (the weights fit "
                f"the card's 80 GB)"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM.init_lm(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    doc_tokens = torch.randint(1, cfg.vocab, (FAM_DOCS, doc_len),
                               generator=g, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    embed = mean_pool_embedder(lm)
    db = embed(doc_tokens)
    pipe = RAGPipeline(lm, db, doc_tokens, d_start=D_START, k0=K0,
                       buckets=BUCKETS, device=dev)
    del db
    pipe.engine.warmup()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    src = torch.randperm(FAM_DOCS, generator=g, device=dev)[:FAM_QUERIES]
    queries = doc_tokens[src].cpu().numpy()      # copies of documents
    src = src.cpu().numpy()
    del doc_tokens

    # -- the main path: retrieval, then generation ----------------------------
    setup_s = time.perf_counter() - t_run
    zero_counts()
    _, retrieved = pipe.retrieve(queries)
    hit = float((retrieved[:, 0] == src).mean())
    if hit < 1.0:
        fail(f"{arch}: top-1 is the source document for only {hit} of "
             f"queries")
    gen_ms, generated = [], []
    for i in range(0, FAM_QUERIES, RAG_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.generate(queries[i:i + RAG_BATCH],
                            retrieved[i:i + RAG_BATCH],
                            max_new_tokens=RAG_NEW_TOKENS)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(out)
    counts = read_counts()
    n_batches = FAM_QUERIES // RAG_BATCH
    want = {"prefill_wgmma": 0, "decode_splitkv": 0, "fma": 0}
    want[prefill_kind] += n_batches * cfg.n_layers
    if decode_kind is not None:
        want[decode_kind] += n_batches * cfg.n_layers * (RAG_NEW_TOKENS - 1)
    by_kernel = {kind: counts[f"flash_attention.{kind}"] for kind in want}
    if by_kernel != want \
            or counts["flash_attention.flash_attention"] != sum(want.values()):
        fail(f"{arch}: flash_attention launched "
             f"{counts['flash_attention.flash_attention']} times "
             f"({by_kernel}), expected {want}")
    if counts["distance_topk.l2_topk"] <= 0 \
            or counts["gather_rescore.ladder"] != counts["distance_topk.l2_topk"]:
        fail(f"{arch}: retrieval did not run one stage-0 and one ladder "
             f"launch a dispatch: {counts}")
    generated = torch.cat(generated)
    if generated.shape != (FAM_QUERIES, RAG_NEW_TOKENS) or bool(
            ((generated < 0) | (generated >= cfg.vocab)).any()):
        fail(f"{arch}: generated tokens of shape {tuple(generated.shape)} "
             f"out of range")
    t0 = time.perf_counter()
    profile_generate(torch, pipe, queries[:RAG_BATCH], retrieved[:RAG_BATCH],
                     gen_ms[0], path=f"{arch} generate")
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- kernel path vs plain path, teacher-forced ---------------------------
    local = [l for l in range(cfg.n_layers) if cfg.layer_window(l) > 0]
    check = teacher_forced_check(
        torch, pipe, queries, retrieved, generated, phase="lm_families_check",
        window_layer=local[0] if cfg.local_global_period > 0 else None,
        call_rtol=FAMILY_CALL_RTOL)
    check_s = time.perf_counter() - t0
    emit({"phase": "lm_families", "arch": arch, "model": cfg.name,
          "layers": cfg.n_layers, "published_layers": full.n_layers,
          "reduced": reduced, "d_model": cfg.d_model, "dtype": cfg.param_dtype,
          "params": n_params, "published_params": full.param_count(),
          "active_params": cfg.active_param_count(), "init_s": init_s,
          "docs": FAM_DOCS, "doc_len": doc_len, "prompt_len": 2 * doc_len,
          "queries": FAM_QUERIES, "batch": RAG_BATCH,
          "new_tokens": RAG_NEW_TOKENS, "engine_load_s": load_s,
          "top1_hit_rate": hit, "generate_ms": gen_ms,
          "prefill_ms_per_batch": check["prefill_ms_per_batch"],
          "prefill_ms": check["prefill_ms"],
          "decode_ms_per_token": check["decode_ms_per_token"],
          "launches_by_kernel": by_kernel, "launches": counts,
          "call_max_abs_err": check["call_max_abs_err"],
          "logit_max_abs_diff": check["logit_max_abs_diff"],
          "logit_tol": check["logit_tol"],
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "setup_s": setup_s, "profile_s": profile_s, "check_s": check_s,
          "run_s": time.perf_counter() - t_run})
    del pipe, lm, embed
    gc.collect()
    torch.cuda.empty_cache()
    return by_kernel


def lm_families_phase(torch, dev, seed):
    """Phase 7b: the flash rows at the families' shapes, then each family in
    turn (one model on the card at a time).  Returns ({arch: flash launches
    by kernel}, the rows)."""
    rows = family_flash_rows(torch, dev)
    launches = {}
    for arch, n_layers, doc_len, prefill_kind, decode_kind in FAMILIES:
        launches[arch] = family_run(torch, dev, seed, arch, n_layers,
                                    doc_len, prefill_kind, decode_kind)
    return launches, rows


@contextlib.contextmanager
def moe_routes(torch, record):
    """Append, for every MoE dispatch while the block runs, each token's
    kept experts — its top-k expert ids, -1 where the capacity dropped the
    pair, sorted — as a (T, k) tensor to ``record``."""
    from repro_torch.layers import moe

    dispatch = moe._dispatch_local

    def recorded(x2, logits, cfg):
        buf, info, frac_t, frac_p = dispatch(x2, logits, cfg)
        experts, order, _, _, keep, _, _ = info
        kept = torch.empty_like(keep)
        kept[order] = keep
        ids = torch.where(kept, experts.reshape(-1),
                          torch.full_like(experts.reshape(-1), -1))
        record.append(ids.reshape(experts.shape).sort(dim=-1).values)
        return buf, info, frac_t, frac_p

    moe._dispatch_local = recorded
    try:
        yield
    finally:
        moe._dispatch_local = dispatch


def route_flips(torch, kern_routes, plain_routes, n_moe, b, s, n_logits):
    """(B, n_logits) bool: the logits whose own token reached another set of
    experts on the two paths in some MoE layer (the prefill's last prompt
    token for the prefill logits, the step's token for a decode step's),
    and the count of tokens, prompt tokens included, whose sets differ."""
    if len(kern_routes) != len(plain_routes):
        fail(f"{len(kern_routes)} MoE dispatches on the kernel path, "
             f"{len(plain_routes)} on the plain path")
    flipped = torch.zeros((b, n_logits), dtype=torch.bool,
                          device=kern_routes[0].device)
    tokens = torch.zeros((b, s + n_logits - 1), dtype=torch.bool,
                         device=flipped.device)
    for c, (a, p) in enumerate(zip(kern_routes, plain_routes)):
        differ = (a != p).any(dim=-1)
        step = c // n_moe
        if step == 0:
            differ = differ.reshape(b, s)
            tokens[:, :s] |= differ
            flipped[:, 0] |= differ[:, -1]
        else:
            tokens[:, s + step - 1] |= differ
            flipped[:, step] |= differ
    return flipped, int(tokens.sum())


def one_step(torch, x, gen):
    """bf16 ``x`` with every element moved one bf16 step, up or down in
    magnitude at random (zeros up): the smallest change a rounding can
    make."""
    bits = x.contiguous().view(torch.int16)
    mag = bits & 0x7FFF
    step = torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                         dtype=torch.int16) * 2 - 1
    step = torch.where(mag == 0, torch.ones_like(step), step)
    return ((bits & -0x8000) | (mag + step)).view(torch.bfloat16)


@contextlib.contextmanager
def head_nudged(torch, gen, record):
    """While the block runs, every head product also runs on its hidden
    state moved by ``one_step``; ``record[0]`` keeps the largest |Δ| of the
    logits.  The path goes on with the unmoved logits."""
    from repro_torch.models import lm as LM

    head_logits = LM._head_logits

    def nudged(x, head):
        out = head_logits(x, head)
        moved = head_logits(one_step(torch, x, gen), head)
        record[0] = max(record[0], float((moved - out).abs().max()))
        return out

    LM._head_logits = nudged
    try:
        yield
    finally:
        LM._head_logits = head_logits


def teacher_forced_check(torch, pipe, queries, retrieved, generated, *,
                         phase="rag_check", window_layer=None,
                         call_rtol=0.0) -> dict:
    """Replay every batch through the kernel path and the plain path — the
    same LM code with each attention call given to the kernel's plain
    version (``flash_attention_plain``: dense, with the kernel's masks and
    rounding) — both fed the kernel path's generated tokens, and compare
    the prefill logits and every decode step's logits.  The plain replay
    also runs the kernel on each call's inputs (the path's shapes, strides
    and data) and holds it against the plain output, call by call: each
    element within ``FLASH_TOL["bfloat16"] + call_rtol * |plain|``.

    The controls: the first batch again, with the kernel's causal mask
    shifted by one key (each query loses its own) in the first, the middle
    and the last layer in turn; the call-by-call check must reject each,
    and the logit check the first.  A one-key shift in a later layer moves
    the logits no more than bf16 noise does, so the logit check alone
    cannot see it; the line reports how far each control moved them.
    ``window_layer`` (a sliding-window layer) adds a control that widens
    that layer's window by one key, which must fail the call-by-call check
    too.  The witness of that noise: the first batch on the plain path
    with every attention output moved by one bf16 step (``one_step``),
    against the plain path; and each head product on its hidden state so
    moved.

    In a MoE model a bf16 difference in attention can send a token to
    another expert (or past an expert's capacity), which moves that
    token's logits by far more than the attention error: each path's
    routing is recorded, the logits whose own token reached another set of
    experts are counted and reported apart, and the logit checks hold the
    others, which must be at least ``MOE_HELD_FLOOR`` of them.  The
    witness reports how many tokens one bf16 step routes apart.  The logit
    tolerance and the near-tie margin are in units of the plain logits'
    RMS (at least 1) over the first batch: a head tied to unit-variance
    embedding rows gives logits sqrt(d_model) times a fan-in head's.
    Times the kernel path's prefill and decode steps on the way; emits and
    returns the ``phase`` line."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm as LM

    lm, cfg = pipe.lm, pipe.cfg
    n_moe = 0 if cfg.moe is None else cfg.n_layers - cfg.moe.first_k_dense
    prefill_ms, prefill_retries, step_ms = [], [], []
    n_queries, batch, new_tokens = len(queries), RAG_BATCH, RAG_NEW_TOKENS

    def run(prompts, toks, route=None, timed=False, routes=None):
        """(B, T, V) float32 logits, attention through ``route`` (the
        kernel unless given); MoE routing appended to ``routes``."""
        kernel = ops.flash_attention
        if route is not None:
            ops.flash_attention = route
        try:
            with (moe_routes(torch, routes) if routes is not None
                  else contextlib.nullcontext()):
                s = prompts.shape[1]
                retries = torch.cuda.memory_stats()["num_alloc_retries"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = LM.prefill(lm, prompts,
                                           decode_len=s + new_tokens)
                if timed:
                    torch.cuda.synchronize()
                    prefill_ms.append((time.perf_counter() - t0) * 1e3)
                    prefill_retries.append(torch.cuda.memory_stats()[
                        "num_alloc_retries"] - retries)
                out = [logits]
                for i in range(new_tokens - 1):
                    t0 = time.perf_counter()
                    logits, cache = LM.decode_step(lm, cache,
                                                   toks[:, i:i + 1], s + i)
                    if timed:
                        torch.cuda.synchronize()
                        step_ms.append((time.perf_counter() - t0) * 1e3)
                    out.append(logits)
        finally:
            ops.flash_attention = kernel
        return torch.stack(out, dim=1)

    def paired(err, over, shift_layer=None, widen_layer=None):
        """A route running the kernel (its causal mask shifted by one key
        in ``shift_layer``, or its window widened by one key in
        ``widen_layer``) and the plain version on each call's inputs; keeps
        the largest |Δ| of prefill and of decode calls in ``err``, and the
        largest |Δ| / (call_tol + call_rtol * |plain|) in ``over``, and
        returns the plain output, or the altered kernel's in a control."""
        calls = [0]
        control = shift_layer is not None or widen_layer is not None

        def route(q, k, v, *, causal=False, window=None, scale=None):
            layer = calls[0] % cfg.n_layers
            calls[0] += 1
            shift = layer == shift_layer
            kk, vv = (k[:, :, :-1], v[:, :, :-1]) if shift else (k, v)
            kw = window
            if layer == widen_layer and window is not None:
                kw = window + 1
            got = fa.flash_attention(q, kk, vv, causal=causal, window=kw,
                                     scale=scale)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, scale=scale)
            kind = "decode" if q.shape[2] == 1 else "prefill"
            d = (got.float() - want.float()).abs()
            err[kind] = max(err[kind], float(d.max()))
            over[kind] = max(over[kind], float(
                (d / (call_tol + call_rtol * want.float().abs())).max()))
            return got if control else want
        return route

    def nudged(gen):
        """The plain version, its output moved by one step."""
        def route(q, k, v, *, causal=False, window=None, scale=None):
            return one_step(torch, fa.flash_attention_plain(
                q, k, v, causal=causal, window=window, scale=scale), gen)
        return route

    def gap(got, plain, clean=None):
        """max |Δ|, positions, argmax agreements, near-ties, disagreements
        at a plain margin >= the near-tie margin, largest margin of a
        disagreement; over the ``clean`` (B, T) positions only when
        given."""
        if clean is not None:
            got, plain = got[clean], plain[clean]
        if got.numel() == 0:
            return 0.0, 0, 0, 0, 0, 0.0
        top2 = plain.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        agree = got.argmax(-1) == plain.argmax(-1)
        return (float((got - plain).abs().max()), agree.numel(),
                int(agree.sum()), int((margin < near_tie[0]).sum()),
                int((~agree & (margin >= near_tie[0])).sum()),
                float(margin[~agree].max()) if bool((~agree).any()) else 0.0)

    max_diff = pre_diff = worst_margin = flip_diff = 0.0
    n_cmp = n_agree = n_near = n_far = pre_agree = pre_n = n_replay_same = 0
    n_flip_logits = n_flip_tokens = n_tokens = 0
    call_tol = FLASH_TOL["bfloat16"]
    logit_rms, near_tie = None, [NEAR_TIE]
    call_err = {"prefill": 0.0, "decode": 0.0}
    call_over = {"prefill": 0.0, "decode": 0.0}
    first = None
    for i in range(0, n_queries, batch):
        prompts = pipe.assemble_prompts(queries[i:i + batch],
                                        retrieved[i:i + batch])
        toks = generated[i:i + batch]
        k_routes, p_routes = ([], []) if n_moe else (None, None)
        kern = run(prompts, toks, timed=True, routes=k_routes)
        n_replay_same += int(torch.equal(kern.argmax(-1), toks))
        plain = run(prompts, toks, paired(call_err, call_over),
                    routes=p_routes)
        if logit_rms is None:
            logit_rms = float(plain.pow(2).mean().sqrt())
            near_tie[0] = NEAR_TIE * max(1.0, logit_rms)
        clean = None
        if n_moe:
            b, s = prompts.shape
            flipped, n_tok = route_flips(torch, k_routes, p_routes, n_moe,
                                         b, s, new_tokens)
            clean = ~flipped
            n_flip_logits += int(flipped.sum())
            n_flip_tokens += n_tok
            n_tokens += b * (s + new_tokens - 1)
            if bool(flipped.any()):
                flip_diff = max(flip_diff, float(
                    (kern[flipped] - plain[flipped]).abs().max()))
        diff, n, agree, near, far, margin = gap(kern, plain, clean)
        max_diff, worst_margin = max(max_diff, diff), max(worst_margin, margin)
        n_cmp, n_agree, n_near, n_far = (n_cmp + n, n_agree + agree,
                                         n_near + near, n_far + far)
        diff, n, agree, _, _, _ = gap(
            kern[:, :1], plain[:, :1], None if clean is None else clean[:, :1])
        pre_diff, pre_agree = max(pre_diff, diff), pre_agree + agree
        pre_n += n
        if first is None:
            first = (prompts, toks, plain, clean, p_routes)
        del kern, plain, k_routes, p_routes

    logit_tol = LOGIT_TOL * max(1.0, logit_rms)
    controls = {"control_shifted_causal_mask_by_layer": {},
                "control_widened_window_by_layer": {}}
    prompts, toks, plain, clean, p_routes = first
    shift_layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)
    tried = [("control_shifted_causal_mask_by_layer", layer,
              {"shift_layer": layer}) for layer in shift_layers]
    if window_layer is not None:
        tried.append(("control_widened_window_by_layer", window_layer,
                      {"widen_layer": window_layer}))
    for name, layer, kw in tried:
        err = {"prefill": 0.0, "decode": 0.0}
        over = {"prefill": 0.0, "decode": 0.0}
        c = gap(run(prompts, toks, paired(err, over, **kw)), plain, clean)
        controls[name][str(layer)] = {
            "call_max_abs_err": err, "call_err_over_limit": over,
            "logit_max_abs_diff": c[0],
            "logit_max_abs_diff_over_rms": c[0] / logit_rms,
            "argmax_disagree": c[1] - c[2],
            "disagree_at_margin_ge_near_tie": c[4]}
    if window_layer is None:
        del controls["control_widened_window_by_layer"]
    gen = torch.Generator(device=plain.device)
    gen.manual_seed(0)
    head_diff, w_routes = [0.0], [] if n_moe else None
    with head_nudged(torch, gen, head_diff):
        w = gap(run(prompts, toks, nudged(gen), routes=w_routes), plain)
    witness = {"logit_max_abs_diff": w[0],
               "logit_max_abs_diff_over_rms": w[0] / logit_rms,
               "argmax_disagree": w[1] - w[2],
               "head_logit_max_abs_diff": head_diff[0]}
    if n_moe:
        b, s = prompts.shape
        witness.update({"tokens": b * (s + new_tokens - 1),
                        "tokens_with_other_experts": route_flips(
                            torch, w_routes, p_routes, n_moe, b, s,
                            new_tokens)[1]})
    del first, plain, clean, p_routes, w_routes
    n_attn = cfg.n_layers if cfg.mla is None else 0
    line = {"phase": phase, "model": cfg.name,
            "prefill_ms_per_batch": statistics.mean(prefill_ms),
            "prefill_ms": prefill_ms,
            "prefill_alloc_retries": prefill_retries,
            "decode_ms_per_token": statistics.mean(step_ms),
            "decode_ms_per_token_p50": statistics.median(step_ms),
            "calls_checked": n_queries // batch * (
                cfg.n_layers + n_attn * (new_tokens - 1)),
            "call_max_abs_err": call_err, "call_tol": call_tol,
            "call_rtol": call_rtol, "call_err_over_limit": call_over,
            "logits_compared": n_cmp, "logit_max_abs_diff": max_diff,
            "logit_max_abs_diff_over_rms": max_diff / logit_rms,
            "prefill_logit_max_abs_diff": pre_diff,
            "prefill_argmax_agree": pre_agree / max(pre_n, 1),
            "logit_tol": logit_tol, "logit_rms": logit_rms,
            "argmax_agree": n_agree / max(n_cmp, 1),
            "argmax_disagree": n_cmp - n_agree,
            "disagree_max_plain_margin": worst_margin,
            "near_tie_margin": near_tie[0], "near_ties": n_near,
            "replay_tokens_equal_batches": n_replay_same, **controls,
            "witness_one_bf16_step": witness}
    n_logits = n_queries // batch * batch * new_tokens
    if n_moe:
        line.update({"tokens": n_tokens,
                     "tokens_with_other_experts": n_flip_tokens,
                     "logits_of_tokens_with_other_experts": n_flip_logits,
                     "logit_max_abs_diff_other_experts": flip_diff,
                     "held_share": n_cmp / n_logits,
                     "held_floor": MOE_HELD_FLOOR})
    emit(line)
    if max(call_over.values()) > 1.0:
        fail(f"{cfg.name}: an attention call of the path differs from its "
             f"plain version by {call_err}, {call_over} of the limit "
             f"{call_tol} + {call_rtol} |plain|")
    if max_diff > logit_tol:
        fail(f"{cfg.name}: kernel vs plain logits differ by {max_diff} > "
             f"{logit_tol}")
    if n_far:
        fail(f"{cfg.name}: {n_far} argmax disagreements where the plain "
             f"top-2 margin is >= {near_tie[0]}")
    if n_cmp < MOE_HELD_FLOOR * n_logits:
        fail(f"{cfg.name}: the logit check held {n_cmp} of {n_logits} "
             f"logits, below the floor {MOE_HELD_FLOOR}")
    shift0 = controls["control_shifted_causal_mask_by_layer"]["0"]
    if shift0["logit_max_abs_diff"] <= logit_tol:
        fail(f"{cfg.name}: the logit check misses the first layer's "
             f"shifted-mask control ({shift0['logit_max_abs_diff']} <= "
             f"{logit_tol})")
    blind = [f"{name} {layer}" for name, by_layer in controls.items()
             for layer, c in by_layer.items()
             if max(c["call_err_over_limit"].values()) <= 1.0]
    if blind:
        fail(f"{cfg.name}: the call-by-call check misses control(s) "
             f"{blind}: {controls}")
    return line


def profile_generate(torch, pipe, queries, retrieved, wall_ms, *,
                     path="rag generate") -> None:
    """Trace one ``generate`` with ``torch.profiler``: device time by
    kernel, and the device's busy share of the untraced call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    # the device alone: a trace of host ops too takes tens of seconds to
    # summarise at tens of thousands of launches, and loses more records
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.generate(queries, retrieved, max_new_tokens=RAG_NEW_TOKENS)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    flash = sum(r["device_ms"] for r in rows
                if "flash_attention_kernel" in r["name"])
    emit({"phase": "profile", "path": path, "batch": len(queries),
          "device_busy_ms": busy, "generate_wall_ms": wall_ms,
          "device_busy_share": busy / wall_ms,
          "flash_attention_device_ms": flash, "kernels": rows[:12]})


# ---------------------------------------------------------------------------
# embedding bag and segment sum: kernel rows (phase 2 edge cases, phases 8-9
# path shapes)
# ---------------------------------------------------------------------------

def bag_row(torch, case, tables, ids, mode="sum", *, flush=None,
            library=False, runs=20) -> dict:
    """The embedding-bag kernel against its plain version on one input
    (``torch.equal``: both add each bag's rows in id order from +0.0),
    timed beside it (and beside ``F.embedding_bag``, the yardstick, where
    ``library``), with its bound from the bytes these ids need, the route
    `embedding_bag.route` names (checked taken, in one launch a call, by
    the counters and the profiler) and the wrapper's host time a call."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb

    kern = lambda: eb.embedding_bag(tables, ids, mode=mode)
    plain = lambda: eb.embedding_bag_plain(tables, ids, mode=mode)
    kind = eb.route(tables, ids)
    before = dict(eb.launches_by_kernel)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    after = eb.launches_by_kernel
    if after[kind] != before[kind] + 1 \
            or sum(after.values()) != sum(before.values()) + 1:
        fail(f"embedding_bag {case}: launches by route {before} -> {after}, "
             f"not one on {kind}")
    dtype = str(tables.dtype).replace("torch.", "")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"embedding_bag {case}: differs from the plain version "
             f"(max|Δ|={err})")
    del got, want
    b, f, bag_len = ids.shape
    n_bytes = eb.bound_bytes(tables, ids)
    bnd, by = bound_ms(n_bytes, float(int((ids >= 0).sum())) * tables.shape[-1])
    dev_all, dev_own = device_ms(
        torch, kern, ("embedding_bag_vec16", "embedding_bag_scalar"),
        per_call=1, at_most=True)
    torch.cuda.synchronize()                  # the wrapper's host time a call
    t0 = time.perf_counter()
    for _ in range(200):
        kern()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    row = {"kernel": "embedding_bag.embedding_bag", "case": case,
           "shape": f"tables {tuple(tables.shape)} {dtype}, ids "
                    f"{tuple(ids.shape)}, {mode}",
           "served_by": kind, "equal_plain": True, "max_abs_err": err,
           "ms": cuda_ms(torch, kern, flush=flush, runs=runs),
           "plain_ms": cuda_ms(torch, plain, flush=flush, runs=runs),
           "library_ms": None, "device_ms": dev_all,
           "kernel_device_ms": dev_own, "host_us_per_call": host_us,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}
    if library:
        # one (F * V, D) table, ids offset by field: the same sums (ids >= V
        # clamped as the kernel does).  Padded bags read a zero row appended
        # to a copy of the table as ``padding_idx``, which F.embedding_bag
        # leaves out of the sum and of a mean's count, as the kernel does
        v, d = tables.shape[1], tables.shape[2]
        flat = tables.reshape(-1, d)
        off = (ids.long().clamp(max=v - 1)
               + v * torch.arange(f, device=ids.device)[None, :, None]
               ).reshape(b * f, bag_len)
        pad = {}
        if bool((ids < 0).any()):
            pad = {"padding_idx": f * v}
            flat = torch.cat([flat, flat.new_zeros((1, d))])
            off = off.masked_fill(ids.reshape(b * f, bag_len) < 0, f * v)
        lib = lambda: F.embedding_bag(off, flat, mode=mode, **pad)
        got_lib = lib().view(b, f, d).float()
        want = eb.embedding_bag_plain(tables, ids, mode=mode).float()
        lib_err = float((got_lib - want).abs().max()) if want.numel() else 0.0
        # float32 sums in another order; a bf16 result one rounding apart
        rtol = 1e-5 if tables.dtype == torch.float32 else 1e-2
        row["library_max_abs_err"] = lib_err
        if torch.allclose(got_lib, want, rtol=rtol, atol=1e-6):
            row["library_ms"] = cuda_ms(torch, lib, flush=flush, runs=runs)
        else:
            row["library_note"] = "F.embedding_bag differs from the plain version"
        del got_lib, want, flat, off
    emit({"phase": "kernels", **row})
    return row


def bag_edge_cases(torch, dev, flush) -> list:
    """The embedding-bag kernel on its edge cases (phase 2): bags of 8 and
    100 ids with -1 padding in sum and mean, all-padding bags, ids beyond
    the vocabulary, bf16 tables, a row of -0.0 (its one-id bags give
    +0.0), and both routes (a table whose rows are not whole 16-byte words
    takes the scalar one)."""
    from repro_torch.kernels import embedding_bag as eb

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    rows = []
    f, v, d, b = 4, 100_000, 64, 4096
    for dtype in (torch.float32, torch.bfloat16):
        tabs = (torch.randn((f, v, d), generator=g, device=dev)
                * d ** -0.5).to(dtype)
        for bag_len in (8, 100):
            ids = torch.randint(0, v, (b, f, bag_len), generator=g,
                                device=dev, dtype=torch.int32)
            if bag_len == 8:
                ids8 = ids
            ids[torch.rand((b, f, bag_len), generator=g, device=dev) < 0.3] = -1
            ids[:64] = -1                                  # all padding
            ids[64:80, :, 0] = v + torch.arange(16, device=dev,
                                                dtype=torch.int32)[:, None]
            for mode in ("sum", "mean"):
                rows.append(bag_row(torch, f"L{bag_len}_padded_{mode}_{dtype}"
                                    .replace("torch.", ""), tabs, ids, mode,
                                    flush=flush, library=True, runs=10))
            got = eb.embedding_bag(tabs, ids, mode="sum")
            if bool(got[:64].any()):
                fail("embedding_bag: an all-padding bag is not 0")
            # an id beyond the vocabulary reads row V - 1: the same bags with
            # that id replaced by V - 1
            fixed = ids[64:80].clone()
            fixed[:, :, 0] = v - 1
            if not torch.equal(got[64:80],
                               eb.embedding_bag(tabs, fixed, mode="sum")):
                fail("embedding_bag: an id beyond the vocabulary did not "
                     "read row V - 1")
        # a row of -0.0 read by one-id bags, on both routes
        tabs[0, 5] = -0.0
        one = torch.full((b, f, 1), 5, dtype=torch.int32, device=dev)
        odd = torch.empty((f, v, d + 1), dtype=dtype, device=dev)[:, :, :d]
        odd.copy_(tabs)
        for t, kind in ((tabs, "vec16"), (odd, "scalar")):
            if eb.route(t, one) != kind:
                fail(f"embedding_bag: route {eb.route(t, one)}, not {kind}")
            got = eb.embedding_bag(t, one)
            if bool(got[:, 0].any()) or bool(torch.signbit(got[:, 0]).any()):
                fail(f"embedding_bag ({kind}): a row of -0.0 did not give "
                     f"+0.0")
            if not torch.equal(got, eb.embedding_bag_plain(t, one)):
                fail(f"embedding_bag ({kind}): one-id bags differ from the "
                     f"plain version")
        rows.append(bag_row(torch, f"L8_padded_sum_{dtype}_scalar_route"
                            .replace("torch.", ""), odd, ids8, "sum",
                            flush=flush, library=True, runs=10))
        del tabs, odd
    torch.cuda.empty_cache()
    return rows


def seg_ratio(torch, got, want, data, seg, n) -> float:
    """max |kernel - plain| / (SEG_RTOL * segment sum of |x| + SEG_ATOL),
    the sum of |x| built in row chunks (no full-size temporary)."""
    from repro_torch.kernels import segment_sum as ss

    if got.numel() == 0:
        return 0.0
    scale = torch.zeros_like(got)
    step = 1 << 23
    for lo in range(0, data.shape[0], step):
        scale += ss.segment_sum_plain(data[lo:lo + step].abs(),
                                      seg[lo:lo + step], num_segments=n)
    return float(((got - want).abs() / (SEG_RTOL * scale + SEG_ATOL)).max())


def seg_row(torch, case, data, seg, indptr, n, *, flush=None,
            library=False, runs=20) -> dict:
    """The segment-sum kernel (sorted entry) against its plain version on
    one input, timed beside it (and beside ``index_add_`` and
    ``torch.segment_reduce``, the yardsticks, where ``library``)."""
    from repro_torch.kernels import segment_sum as ss

    kern = lambda: ss.sorted_segment_sum(data, seg, indptr, num_segments=n)
    plain = lambda: ss.sorted_segment_sum_plain(data, seg, indptr,
                                                num_segments=n)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ratio = seg_ratio(torch, got, want, data, seg, n)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if ratio > 1.0 or not bool(torch.isfinite(got).all()):
        fail(f"sorted_segment_sum {case}: |Δ| at {ratio} of the limit "
             f"(max|Δ| {err})")
    n_live = int(indptr[-1])
    d = data.shape[1] if data.dim() == 2 else 1
    n_bytes = ss.bound_bytes(data, n_live, n)
    bnd, by = bound_ms(n_bytes, float(n_live) * d)
    dev_all, dev_own = device_ms(torch, kern, ("segment_sum_",),
                                 per_call=3)      # partition, sum, fix-up
    lengths = indptr[1:] - indptr[:-1]
    row = {"kernel": "segment_sum.sorted_segment_sum", "case": case,
           "served_by": ss.route(d),
           "shape": f"data {tuple(data.shape)}, N {n}",
           "max_abs_err": err, "err_over_limit": ratio,
           "max_segment_rows": int(lengths.max()) if n else 0,
           "mean_segment_rows": n_live / max(n, 1),
           "empty_segments": int((lengths == 0).sum()),
           "ms": cuda_ms(torch, kern, flush=flush, runs=runs),
           "plain_ms": cuda_ms(torch, plain, flush=flush, runs=runs),
           "library_ms": None, "device_ms": dev_all,
           "kernel_device_ms": dev_own, "bound_ms": bnd, "bound_by": by,
           "bytes": n_bytes}
    if library:
        seg_l = seg.long().clamp(max=n)
        rows2 = data if data.dim() == 2 else data[:, None]
        row["library_ms"] = cuda_ms(
            torch, lambda: torch.zeros((n + 1, d), device=data.device)
            .index_add_(0, seg_l, rows2), flush=flush, runs=runs)
        live, off = rows2[:n_live], indptr.long()
        row["segment_reduce_ms"] = cuda_ms(
            torch, lambda: torch.segment_reduce(live, "sum", offsets=off,
                                                axis=0),
            flush=flush, runs=runs)
    emit({"phase": "kernels", **row})
    return row


def segment_edge_cases(torch, dev, flush) -> list:
    """The segment-sum kernel on its edge cases (phase 2), through the
    sorted entry (timed) and the unsorted one: empty segments, no rows, one
    segment holding half the rows, EGNN's widths 64 / 3 / 1."""
    from repro_torch.kernels import segment_sum as ss

    g = torch.Generator(device=dev)
    g.manual_seed(17)
    rows = []
    n, e = 100_000, 2_000_000
    for case, d, n_rows in (("sparse_64", 64, e // 100),
                            ("uniform_64", 64, e),
                            ("uniform_3", 3, e),
                            ("uniform_1", 1, e),
                            ("half_in_one_64", 64, e),
                            ("hub_29384_64", 64, e),
                            ("no_rows_64", 64, 0)):
        seg = torch.randint(-1, n, (n_rows,), generator=g, device=dev,
                            dtype=torch.int32)
        if case.startswith("half"):
            seg[: n_rows // 2] = 7
        elif case.startswith("hub"):         # ogbn-products' largest in-degree
            seg[:OGB_HUB_ROWS] = 7
        data = torch.randn((n_rows, d), generator=g, device=dev)
        if d == 1:
            data = data[:, 0]
        order, seg_s, indptr = ss.sort_by_segment(seg, n)
        rows.append(seg_row(torch, case, data[order], seg_s, indptr, n,
                            flush=flush, library=True, runs=10))
        got = ss.segment_sum(data, seg, num_segments=n)
        want = ss.segment_sum_plain(data, seg, num_segments=n)
        ratio = seg_ratio(torch, got, want, data, seg, n)
        empty = indptr[1:] == indptr[:-1]
        if ratio > 1.0 or bool(got[empty].any()):
            fail(f"segment_sum {case} (unsorted entry): |Δ| at {ratio} of "
                 f"the limit, or an empty segment is not 0")
    del data, seg
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 8: the recsys serving path
# ---------------------------------------------------------------------------

def recsys_phase(torch, dev, seed):
    """Two-tower retrieval, DLRM-RM2, DIN and AutoInt at CONFIG width, one
    model at a time.  Returns ({embedding_bag: launches of the main paths},
    the embedding-bag rows at the path's shapes, the stage-0 rows at the
    two-tower's shape, float32 and bf16)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    counts, rows, stage_rows = two_tower_run(torch, dev, seed)
    n_dlrm, rows_dlrm = dlrm_run(torch, dev, seed, flush)
    counts += n_dlrm
    rows += rows_dlrm
    for arch in ("din", "autoint"):
        counts += ctr_run(torch, dev, seed, arch)
    del flush
    torch.cuda.empty_cache()
    # every table of the path is contiguous float32 with whole 16-byte rows
    return {"embedding_bag.embedding_bag": counts, "embedding_bag.vec16":
            counts, "embedding_bag.scalar": 0}, rows, stage_rows


def _batch(torch, dev, cfg, batch, seed):
    from repro_torch.data.synth import recsys_batch_stream

    b = next(recsys_batch_stream(
        np.random.default_rng(seed), cfg.family, batch, n_sparse=cfg.n_sparse,
        multi_hot=cfg.multi_hot, vocab=cfg.vocab_per_field,
        n_dense=cfg.n_dense, seq_len=cfg.seq_len))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def two_tower_run(torch, dev, seed):
    """The two-tower retrieval path; returns (embedding-bag launches of the
    main path, kernel rows at the item-build shape)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import make_schedule
    from repro_torch.models import recsys as R

    cfg = get_arch("two-tower-retrieval").CONFIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.recsys_init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nf = params["item_tables"].shape[0]
    item_ids = torch.arange(TT_ITEMS, dtype=torch.int32, device=dev)[
        :, None, None].expand(TT_ITEMS, nf, 1).contiguous()
    users = {bs: _batch(torch, dev, cfg, bs, seed + 10 + bs)["user_ids"]
             for bs in TT_BATCHES}
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    cand = torch.randperm(TT_ITEMS, generator=g, device=dev)[
        :TT_CANDIDATES].to(torch.int32)
    sched = make_schedule(cfg.retrieval_d_start, cfg.tower_mlp[-1],
                          cfg.retrieval_k0, final_k=10)

    def path():
        db = R.tower_item(params, item_ids)
        out = {bs: R.retrieval_serve(params, u, db, cfg, sched=sched)
               for bs, u in users.items()}
        sc = R.serve_candidates(params, {"user_ids": users[P99_BATCH]}, cand,
                                cfg)
        return db, out, sc

    path()                                         # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    db, out, sc = path()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = read_counts()
    want_bags = 1 + len(TT_BATCHES) + 2
    if counts["embedding_bag.embedding_bag"] != want_bags \
            or counts["embedding_bag.vec16"] != want_bags \
            or counts["distance_topk.l2_topk"] != len(TT_BATCHES) \
            or counts["distance_topk.wgmma"] != len(TT_BATCHES) \
            or counts["gather_rescore.gather_rescore_topk"] \
            != len(TT_BATCHES) \
            or counts["gather_rescore.ladder"] != len(TT_BATCHES):
        fail(f"two-tower: launches {counts}")
    with plain_ops():
        db_p, out_p, sc_p = path()
    torch.cuda.synchronize()
    if not torch.equal(db, db_p):
        fail(f"two-tower: item DB differs from the plain path by "
             f"{float((db - db_p).abs().max())}")
    ids_agree, score_err = {}, 0.0
    for bs in TT_BATCHES:
        err, agree, tol = compare(torch, out[bs], out_p[bs])
        if agree < 1.0 or err > tol:
            fail(f"two-tower retrieval B={bs}: ids agree {agree}, max|Δ| "
                 f"{err} (tol {tol})")
        ids_agree[bs], score_err = agree, max(score_err, err)
    sc_err = float((sc - sc_p).abs().max())
    if sc_err > 1e-5 or sc.shape != (P99_BATCH, TT_CANDIDATES):
        fail(f"two-tower serve_candidates: max|Δ| {sc_err}, shape "
             f"{tuple(sc.shape)}")
    del db_p, out_p, sc_p
    # recall@10 of the served ids against an exact full-dim search
    u = R.tower_user(params, users[P99_BATCH])
    s = (db * db).sum(1)[None] - 2.0 * (u @ db.T)
    truth = torch.topk(s, 10, dim=1, largest=False).indices
    got = out[P99_BATCH][1].long()
    recall = float((got[:, :, None] == truth[:, None, :]).any(2).float().mean())
    del s, u
    timed = {bs: cuda_ms(torch, lambda bs=bs: R.retrieval_serve(
        params, users[bs], db, cfg, sched=sched), runs=10) for bs in TT_BATCHES}
    build_ms = cuda_ms(torch, lambda: R.tower_item(params, item_ids), runs=5)
    cand_ms = cuda_ms(torch, lambda: R.serve_candidates(
        params, {"user_ids": users[P99_BATCH]}, cand, cfg), runs=10)
    emit({"phase": "recsys", "model": cfg.name, "init_s": init_s,
          "items": TT_ITEMS, "schedule": sched.describe(),
          "path_s": path_s, "item_db_build_ms": build_ms,
          "retrieval_ms": {str(k): v for k, v in timed.items()},
          "retrieval_qps": {str(k): k / v * 1e3 for k, v in timed.items()},
          "serve_candidates_ms": cand_ms,
          "serve_candidates_shape": [P99_BATCH, TT_CANDIDATES],
          "item_db_equal_plain": True,
          "ids_equal_plain_up_to_ties": {str(k): v
                                         for k, v in ids_agree.items()},
          "score_max_abs_err": score_err,
          "serve_candidates_max_abs_err": sc_err,
          "recall_at_10_vs_exact": recall, "launches": counts,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    profile_call(torch, lambda: R.retrieval_serve(
        params, users[P99_BATCH], db, cfg, sched=sched),
        timed[P99_BATCH], f"two-tower retrieval_serve B={P99_BATCH}")
    rows = [bag_row(torch, "two_tower_item_build", params["item_tables"],
                    item_ids, library=True, runs=10)]
    s0 = sched.stages[0]
    u = R.tower_user(params, users[P99_BATCH])
    stage_row, _ = l2_row(torch, "two_tower_stage0", u, db, s0.dim, s0.k)
    stage_row["launches"] = counts["distance_topk.l2_topk"]
    # the bf16 route at the same shape: the staged index's bf16 block and
    # the float32 rows' norms (the retrieval_cand cell's stage 0)
    bf_row, _ = l2_row(torch, "two_tower_stage0_bf16", u.to(torch.bfloat16),
                       db[:, :s0.dim].to(torch.bfloat16), s0.dim, s0.k,
                       sq=(db[:, :s0.dim] ** 2).sum(1))
    del params, db, out, sc, item_ids, users, u
    _free(torch)
    return (counts["embedding_bag.embedding_bag"], rows,
            [stage_row, bf_row])


def dlrm_run(torch, dev, seed, flush):
    """DLRM-RM2 at serve_p99 and serve_bulk; returns (embedding-bag
    launches of the main path, kernel rows at both shapes)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as R

    cfg = get_arch("dlrm-rm2").CONFIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.recsys_init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = {bs: _batch(torch, dev, cfg, bs, seed + 20 + bs)
               for bs in (P99_BATCH, BULK_BATCH)}

    def run():
        return {bs: R.recsys_forward(params, b, cfg)
                for bs, b in batches.items()}

    run()
    torch.cuda.synchronize()
    zero_counts()
    logits = run()
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["embedding_bag.embedding_bag"] != len(batches) \
            or counts["embedding_bag.vec16"] != len(batches):
        fail(f"dlrm: launches {counts}")
    with plain_ops():
        plain = run()
    rel = {}
    for bs in batches:
        got, want = logits[bs], plain[bs]
        if got.shape != (bs,) or not bool(torch.isfinite(got).all()):
            fail(f"dlrm B={bs}: logits of shape {tuple(got.shape)} not finite")
        rel[bs] = float((got - want).abs().max() / want.abs().max())
        if rel[bs] > DLRM_TOL:
            fail(f"dlrm B={bs}: logits differ from the plain path by "
                 f"{rel[bs]} relative > {DLRM_TOL}")
    fwd_ms = {bs: cuda_ms(torch, lambda b=b: R.recsys_forward(params, b, cfg),
                          flush=flush, runs=10) for bs, b in batches.items()}
    emit({"phase": "recsys", "model": cfg.name, "init_s": init_s,
          "table_gb": params["tables"].numel() * 4 / 1e9,
          "forward_ms": {str(k): v for k, v in fwd_ms.items()},
          "rows_per_s": {str(k): k / v * 1e3 for k, v in fwd_ms.items()},
          "logit_rel_err_vs_plain": {str(k): v for k, v in rel.items()},
          "logit_tol": DLRM_TOL, "launches": counts,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    rows = [bag_row(torch, f"dlrm_{name}", params["tables"],
                    batches[bs]["ids"], flush=flush, library=True, runs=10)
            for name, bs in (("bulk", BULK_BATCH), ("p99", P99_BATCH))]
    del params, batches, logits, plain
    _free(torch)
    return counts["embedding_bag.embedding_bag"], rows


def ctr_run(torch, dev, seed, arch) -> int:
    """One serve_p99 batch of DIN or AutoInt at CONFIG width against the
    plain path; returns the embedding-bag launches of the forward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as R

    cfg = get_arch(arch).CONFIG
    torch.cuda.reset_peak_memory_stats()
    params = R.recsys_init(cfg, seed=seed, device=dev)
    batch = _batch(torch, dev, cfg, P99_BATCH, seed + 30)
    R.recsys_forward(params, batch, cfg)
    torch.cuda.synchronize()
    zero_counts()
    logits = R.recsys_forward(params, batch, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    want = 1 if cfg.family == "autoint" else 0      # DIN's pooling is weighted
    if counts["embedding_bag.embedding_bag"] != want \
            or counts["embedding_bag.vec16"] != want:
        fail(f"{arch}: launches {counts}")
    with plain_ops():
        plain = R.recsys_forward(params, batch, cfg)
    rel = float((logits - plain).abs().max() / plain.abs().max())
    if logits.shape != (P99_BATCH,) or not bool(torch.isfinite(logits).all()) \
            or rel > DLRM_TOL:
        fail(f"{arch}: logits {tuple(logits.shape)}, relative gap to the "
             f"plain path {rel}")
    emit({"phase": "recsys", "model": cfg.name, "batch": P99_BATCH,
          "forward_ms": cuda_ms(torch, lambda: R.recsys_forward(
              params, batch, cfg), runs=10),
          "logit_rel_err_vs_plain": rel, "launches": counts,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    del params, batch
    _free(torch)
    return counts["embedding_bag.embedding_bag"]


# ---------------------------------------------------------------------------
# phase 9: EGNN inference
# ---------------------------------------------------------------------------

def ogb_graph(torch, dev, seed, shape, n_classes):
    """The ogbn-products shape as the port's ``random_graph`` makes it
    (power-law senders and receivers from Pareto(2) + 1 node weights,
    normal features and coordinates), drawn on the card from ``seed``."""
    from repro_torch.models.graph import Graph

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    n, e = shape.n_nodes, shape.n_edges
    u = torch.rand((n,), generator=g, device=dev, dtype=torch.float64)
    w = torch.exp(-torch.log1p(-u) / 2.0)              # pareto(2.0) + 1
    cdf = torch.cumsum(w / w.sum(), 0)

    def draw():
        x = torch.rand((e,), generator=g, device=dev, dtype=torch.float64)
        return torch.searchsorted(cdf, x, right=True).clamp_(max=n - 1).to(
            torch.int32)

    senders, receivers = draw(), draw()
    return Graph(
        nodes=torch.randn((n, shape.d_feat), generator=g, device=dev),
        coords=torch.randn((n, 3), generator=g, device=dev),
        senders=senders, receivers=receivers,
        edge_attr=torch.zeros((e, 0), device=dev),
        node_mask=torch.ones((n,), dtype=torch.bool, device=dev),
        edge_mask=torch.ones((e,), dtype=torch.bool, device=dev),
        labels=torch.randint(0, n_classes, (n,), generator=g, device=dev,
                             dtype=torch.int32))


def gaps(torch, got, want) -> dict:
    """{"global": max |Δ| / max |plain|, "node": max over nodes of max |Δ|
    in the node's row / max |plain| of that row}."""
    diff = (got - want).abs()
    return {"global": float(diff.max() / want.abs().max()),
            "node": float((diff.amax(1) / want.abs().amax(1).clamp(min=1e-30))
                          .max())}


@contextlib.contextmanager
def checked_segment_sums(torch, record, *, control_call=None, keep=None):
    """While the block runs, every ``ops.sorted_segment_sum`` call runs the
    kernel and the plain version on the call's inputs and appends the
    kernel's |Δ| over its limit to ``record``; the kernel's output goes on.
    ``control_call``: that call's kernel gets its row pointer shifted by one
    edge (the check must reject it).  ``keep``: the first three calls'
    inputs (layer 0: degree, coordinate update, messages) are appended."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss

    kernel, calls = ops.sorted_segment_sum, [0]

    def route(data, seg_ids, indptr, *, num_segments):
        i = calls[0]
        calls[0] += 1
        ip = indptr
        if i == control_call:
            ip = (indptr + 1).clamp_(max=data.shape[0])
            ip[0] = indptr[0]
        got = ss.sorted_segment_sum(data, seg_ids, ip,
                                    num_segments=num_segments)
        want = ss.sorted_segment_sum_plain(data, seg_ids, indptr,
                                           num_segments=num_segments)
        record.append(seg_ratio(torch, got, want, data, seg_ids,
                                num_segments))
        if keep is not None and i < 3:
            keep.append((data, seg_ids, indptr))
        return got

    ops.sorted_segment_sum = route
    try:
        yield
    finally:
        ops.sorted_segment_sum = kernel


def gnn_phase(torch, dev, seed):
    """EGNN on ogbn-products and the molecule batch; returns
    ({sorted_segment_sum: launches of the main paths}, the segment-sum rows
    at the path's shapes)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import egnn as EG
    from repro_torch.models.graph import batched_molecules

    arch = get_arch("egnn")
    shape = arch.SHAPES["ogb_products"]
    cfg = dataclasses.replace(arch.CONFIG, d_feat_in=shape.d_feat)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = ogb_graph(torch, dev, seed, shape, cfg.n_classes)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    max_in_degree = int(torch.bincount(graph.receivers,
                                       minlength=shape.n_nodes).max())
    params = EG.egnn_init(cfg, seed=seed, device=dev)
    per_forward = 3 * cfg.n_layers

    EG.egnn_forward(params, graph, cfg)                # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, coords = EG.egnn_forward(params, graph, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    counts = read_counts()
    if counts["segment_sum.sorted_segment_sum"] != per_forward \
            or counts["segment_sum.narrow"] != 2 * cfg.n_layers \
            or counts["segment_sum.wide"] != cfg.n_layers:
        fail(f"egnn: launches {counts}")
    if logits.shape != (shape.n_nodes, cfg.n_classes) \
            or coords.shape != (shape.n_nodes, 3) \
            or not bool(torch.isfinite(logits).all()
                        & torch.isfinite(coords).all()):
        fail("egnn: logits or coordinates of the wrong shape or not finite")
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30

    with plain_ops():
        p_logits, p_coords = EG.egnn_forward(params, graph, cfg)
    gap_logits = gaps(torch, logits, p_logits)
    gap_coords = gaps(torch, coords, p_coords)
    del p_logits, p_coords
    _free(torch)

    ratios, kept = [], []
    with checked_segment_sums(torch, ratios, keep=kept):
        r_logits, r_coords = EG.egnn_forward(params, graph, cfg)
    replay_equal = bool(torch.equal(r_logits, logits)
                        and torch.equal(r_coords, coords))
    del r_logits, r_coords
    rows = [seg_row(torch, f"egnn_layer0_{name}", data, seg, indptr,
                    shape.n_nodes, library=True, runs=10)
            for name, (data, seg, indptr) in zip(("deg", "wdx", "m"), kept)]
    del kept
    _free(torch)
    control_call = 2                                  # layer 0's message sum
    c_ratios = []
    with checked_segment_sums(torch, c_ratios, control_call=control_call):
        c_logits, c_coords = EG.egnn_forward(params, graph, cfg)
    control_gap = {"logits": gaps(torch, c_logits, logits),
                   "coords": gaps(torch, c_coords, coords)}
    del c_logits, c_coords
    _free(torch)
    emit({"phase": "gnn", "model": cfg.name, "shape": shape.name,
          "nodes": shape.n_nodes, "edges": shape.n_edges,
          "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
          "graph_s": graph_s, "max_in_degree": max_in_degree,
          "mean_in_degree": shape.n_edges / shape.n_nodes,
          "forward_s": fwd_s, "launches": counts,
          "logit_gap_vs_plain": gap_logits,
          "coord_gap_vs_plain": gap_coords,
          "logit_node_tol": EGNN_LOGIT_TOL, "coord_global_tol": EGNN_COORD_TOL,
          "calls_checked": len(ratios),
          "call_err_over_limit_max": max(ratios),
          "replay_equals_main_path": replay_equal,
          "control_call": control_call,
          "control_err_over_limit": c_ratios,
          "control_gap_vs_path": control_gap,
          "forward_gpu_mem_gb": fwd_peak,
          "gpu_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    if len(ratios) != per_forward or max(ratios) > 1.0:
        fail(f"egnn: a segment-sum call of the path is beyond its limit: "
             f"{ratios}")
    if c_ratios[control_call] <= 1.0:
        fail(f"egnn: the call-by-call check misses a row pointer shifted by "
             f"one edge: {c_ratios}")
    if gap_logits["node"] > EGNN_LOGIT_TOL \
            or gap_coords["global"] > EGNN_COORD_TOL:
        fail(f"egnn: kernel vs plain path gap {gap_logits} (logits), "
             f"{gap_coords} (coordinates)")
    if control_gap["logits"]["node"] <= EGNN_LOGIT_TOL:
        fail(f"egnn: the shifted-pointer control stays within the logit "
             f"limit: {control_gap}")
    if not replay_equal:
        fail("egnn: the checked replay's kernel outputs differ from the main "
             "path's (the kernel is not deterministic)")
    profile_call(torch, lambda: EG.egnn_forward(params, graph, cfg),
                 fwd_s * 1e3, f"egnn forward {shape.name}")
    del graph, logits, coords, params
    _free(torch)

    # the molecule batch: 128 graphs x 30 nodes / 64 edges
    mol = arch.SHAPES["molecule"]
    mcfg = dataclasses.replace(arch.CONFIG, d_feat_in=mol.d_feat)
    mparams = EG.egnn_init(mcfg, seed=seed, device=dev)
    mg = batched_molecules(np.random.default_rng(seed), mol.graph_batch,
                           mol.n_nodes, mol.n_edges, mol.d_feat,
                           n_classes=mcfg.n_classes, device=dev)
    EG.egnn_forward(mparams, mg, mcfg)
    torch.cuda.synchronize()
    zero_counts()
    m_logits, m_coords = EG.egnn_forward(mparams, mg, mcfg)
    torch.cuda.synchronize()
    m_counts = read_counts()
    with plain_ops():
        p_logits, p_coords = EG.egnn_forward(mparams, mg, mcfg)
    m_gap = {"logits": gaps(torch, m_logits, p_logits),
             "coords": gaps(torch, m_coords, p_coords)}
    m_ms = cuda_ms(torch, lambda: EG.egnn_forward(mparams, mg, mcfg), runs=10)
    emit({"phase": "gnn", "model": mcfg.name, "shape": mol.name,
          "graphs": mol.graph_batch, "nodes": mg.nodes.shape[0],
          "edges": mg.senders.shape[0], "forward_ms": m_ms,
          "gap_vs_plain": m_gap, "launches": m_counts})
    if m_counts["segment_sum.sorted_segment_sum"] != per_forward \
            or m_gap["logits"]["node"] > EGNN_LOGIT_TOL \
            or m_gap["coords"]["global"] > EGNN_COORD_TOL:
        fail(f"egnn molecule: launches {m_counts}, node gap {m_gap}")
    del mparams, mg
    _free(torch)
    return {name: counts[name] + m_counts[name]
            for name in ("segment_sum.sorted_segment_sum", "segment_sum.wide",
                         "segment_sum.narrow")}, rows


def profile_call(torch, fn, wall_ms, label) -> None:
    """Trace one call of ``fn`` with ``torch.profiler``: device time by
    kernel, and the device's busy share of the untraced call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    emit({"phase": "profile", "path": label, "device_busy_ms": busy,
          "wall_ms": wall_ms, "device_busy_share": busy / wall_ms,
          "kernels": rows[:12]})


def driver_run(engine, q_host, i_eng) -> dict:
    """Requests from client threads through ``EngineDriver``; each result
    must agree with ``engine.search`` on the same query."""
    from repro_torch.engine import EngineDriver

    nq = q_host.shape[0]
    driver = EngineDriver(engine, max_wait_ms=2.0).start()
    per_client = N_REQUESTS // N_CLIENTS
    errors, lat, same = [], [], []

    def client(c):
        try:
            base = c * per_client
            futs = [driver.submit(q_host[(base + r) % nq])
                    for r in range(per_client)]
            for r, f in enumerate(futs):
                res = f.result(timeout=120)
                lat.append(res.stats.latency_ms)
                same.append(float((res.doc_ids == i_eng[(base + r) % nq])
                                  .mean()))
        except BaseException as e:            # surfaced below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    driver_s = time.perf_counter() - t0
    driver.stop()
    if errors:
        fail(f"driver phase: {errors[:3]}")
    if len(same) != per_client * N_CLIENTS or statistics.mean(same) < 0.99:
        fail(f"driver results agree with engine.search on "
             f"{statistics.mean(same) if same else 0} of ids")
    return {"driver_requests": per_client * N_CLIENTS,
            "driver_clients": N_CLIENTS, "driver_s": driver_s,
            "driver_qps": per_client * N_CLIENTS / driver_s,
            "driver_latency_ms_p50": statistics.median(lat),
            "driver_ids_equal_search": statistics.mean(same)}


def profile_search(torch, engine, q_host, search_s: float, backend) -> None:
    """Trace one ``engine.search`` over every query with ``torch.profiler``:
    device time per kernel, and the device's busy share of the untraced
    search's wall time ``search_s``."""
    from torch.profiler import ProfilerActivity, profile

    engine.search(q_host[:64])                       # settle the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.search(q_host)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    emit({"phase": "profile", "backend": backend, "device_busy_ms": busy,
          "search_wall_ms": search_s * 1e3,
          "device_busy_share": busy / (search_s * 1e3),
          "kernels": rows[:12]})


# -- 11. training -------------------------------------------------------------

# The training phase (PERF.md §2, §5): StarCoder2-3B at its published width
# and depth (30 layers, bf16, remat), batches of TRAIN_LM_BATCH sequences of
# train_4k's 4,096 tokens (its global batch of 256 is a multi-card batch,
# cut to one card's 4); two-tower whole (8 x 1M x 256 tables) at batches of
# 8,192 (train_batch's 65,536 is a global batch); EGNN on minibatch_lg
# subgraphs (1,024 seeds, fanout 15 / 10, the JAX package's budgets,
# src/repro/launch/inputs.py:209-211) of a random graph of Reddit's size.
# StarCoder2's peak learning rate is 3e-4 after 3 warm-up steps: at 1e-3
# its AdamW steps (about lr a weight, all 3,072 inputs of a logit moving
# together) raised the loss from step 3 on (11.29 -> 12.05, H100).
TRAIN_LM = ("starcoder2-3b", 4, 4096, 6)        # arch, batch, seq, steps
# Gemma3-4B's first six layers (five windowed, one global) at full width:
# the training path of the head-dim-256 backward (`bwd_wgmma`).
TRAIN_GEMMA3 = ("gemma3-4b", 6, 1, 2048, 2)  # arch, layers, batch, seq, steps
TRAIN_LM_LR, TRAIN_LM_WARMUP = 3e-4, 3
TRAIN_TT_BATCH, TRAIN_TT_STEPS, TRAIN_TT_LR = 8192, 5, 1e-3
REDDIT_NODES, REDDIT_EDGES, REDDIT_FEATS = 232_965, 114_615_892, 602
TRAIN_EG_SEEDS, TRAIN_EG_FANOUT, TRAIN_EG_STEPS = 1024, (15, 10), 5
TRAIN_EG_LR = 1e-3
# Tolerances.  The flash backward against its plain version: the largest
# |Δ| over the largest |plain| of dq, dk, dv, 1e-4 in float32 (another
# summation order) and 8e-3 in bf16 (one rounding of the results, 2 ** -8
# of the largest, and the float32 sums' order).  The bag backward: 1e-5 of
# the largest |plain| (float32 atomics add ids that meet in one row in no
# fixed order).  The segment backward is a copy: equal bits.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# The forward kernels' log-sum-exp against the plain one: 1e-5 of
# max(1, |plain|) (float32 sums in another order; exp2 on the
# special-function unit in the bf16 prefill kernel).
LSE_RTOL = 1e-5
BAG_BWD_TOL = 1e-5
# The LM kernel path against the plain path (impl="dense": plain attention
# under autograd) from the same weights and batch of one sequence: the loss
# within 1e-2 relative, the global gradient norm within 2%, and a cosine of
# at least 0.99 between the two paths' gradients for every leaf of the
# first, middle and last layers and for the embedding (bf16 weights and
# activations, two attention implementations that round at other places).
LM_LOSS_RTOL, LM_GNORM_RTOL, LM_GRAD_COS = 1e-2, 2e-2, 0.99
# Recsys and EGNN step-1 gradients, kernel path against plain path: 1e-4
# of each leaf's largest |plain| (the same float32 products; the bag
# backward's atomics and the segment sum's compensated order apart).
TRAIN_GRAD_RTOL = 1e-4


def rel_err(torch, got, want) -> float:
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def grad_of(torch, fn, inputs, d_out):
    """The gradient of ``fn(*inputs)`` against ``d_out`` through autograd:
    (a timed callable of the backward alone, its first result)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    call = lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True)
    return call, call()


def flash_lse_check(torch, case, q, k, v, *, causal, window, scale=None):
    """The forward kernel's log-sum-exp (one call) against the plain one's:
    finite on the same rows, within ``LSE_RTOL`` of max(1, |plain|) there.
    Returns (the kernel's lse, its largest relative error)."""
    from repro_torch.kernels import flash_attention as fa

    _, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                scale=scale, return_lse=True)
    _, want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True)
    live = torch.isfinite(want)
    if not torch.equal(torch.isfinite(lse), live):
        fail(f"flash {case}: the forward's lse is finite on other rows than "
             f"the plain one's")
    err = float(((lse - want).abs() / want.abs().clamp(min=1.0))[live].max())
    if err > LSE_RTOL:
        fail(f"flash {case}: forward lse off by {err}")
    return lse, err


def flash_bwd_row(torch, case, q, k, v, *, causal, window, route,
                  scale=None, flush=None) -> dict:
    """The flash backward kernels against their plain version on the card:
    the forward kernel's log-sum-exp (one call, outside the timed lambda)
    against the plain one; dq, dk, dv within ``FLASH_BWD_TOL`` of the
    plain version, which computes its own log-sum-exp; the call on backward
    route ``route``; CUDA-event and device times, the plain version's and
    SDPA's backward (``torch.autograd.grad``) times, and the bound: bytes
    (q, k, v, dO read once, dq, dk, dv written once) and operations (the
    five products of 2 * dh for every kept (query, key) pair: S, dP, dV,
    dQ, dK — the function's, not the nine of `bwd_wgmma`) at the bf16
    tensor-core peak, or in float32 at the FMA peak."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dtype = str(q.dtype).split(".")[-1]
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = torch.Generator(device=q.device)
    g.manual_seed(sq + dh)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    lse, lse_err = flash_lse_check(torch, f"backward {case}", q, k, v,
                                   causal=causal, window=window, scale=scale)
    kind = fa.backward_route(q.dtype, dh)
    if kind != route:
        fail(f"flash backward {case}: route {kind}, expected {route}")
    kern = lambda: fa.flash_attention_backward(
        q, k, v, do, lse, causal=causal, window=window, scale=scale)
    plain = lambda: fa.flash_attention_backward_plain(
        q, k, v, do, causal=causal, window=window, scale=scale)
    before = (fa.bwd_launches, fa.bwd_launches_by_kernel[kind])
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    if (fa.bwd_launches, fa.bwd_launches_by_kernel[kind]) != \
            (before[0] + 1, before[1] + 1):
        fail(f"flash backward {case}: {fa.bwd_launches - before[0]} "
             f"launches, {fa.bwd_launches_by_kernel[kind] - before[1]} on "
             f"{kind}")
    errs = {n: rel_err(torch, x, y) for n, x, y in zip(("dq", "dk", "dv"),
                                                       got, want)}
    tol = FLASH_BWD_TOL[dtype]
    if max(errs.values()) > tol or not all(bool(torch.isfinite(x).all())
                                           for x in got):
        fail(f"flash backward {case}: relative errors {errs} (tol {tol})")
    max_abs = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want))
    del got, want
    keep = flash_keep(torch, sq, skv, causal, window, q.device)
    kept = int(keep.sum())
    sdpa_kw = ({"is_causal": True} if causal and window is None and sq == skv
               else {"attn_mask": keep})
    if scale is not None:
        sdpa_kw["scale"] = scale
    lib, _ = grad_of(torch, lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, enable_gqa=True, **sdpa_kw), (q, k, v), do)
    n_bytes = q.element_size() * dh * (4 * b * hq * sq + 4 * b * hkv * skv)
    n_ops = 10.0 * dh * b * hq * kept
    bnd, by = bound_ms(n_bytes, n_ops, PEAK_F32_FLOPS if dtype == "float32"
                       else PEAK_BF16_FLOPS)
    dev_all, dev_own = device_ms(torch, kern, ("flash_bwd",), per_call=2)
    row = {"kernel": "flash_attention.flash_attention_backward",
           "case": case, "dtype": dtype, "route": kind,
           "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} "
                    f"causal={causal} window={window}",
           "max_abs_err": max_abs, "rel_err": errs, "tol": tol,
           "lse_rel_err": lse_err,
           "ms": cuda_ms(torch, kern, runs=5, warmup=1, flush=flush),
           "plain_ms": cuda_ms(torch, plain, runs=3, warmup=1, flush=flush),
           "library_ms": cuda_ms(torch, lib, runs=5, warmup=1, flush=flush),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes, "ops": n_ops}
    if scale is not None:
        row["scale"] = scale
    emit({"phase": "train_kernels", **row})
    del lib
    torch.cuda.empty_cache()
    return row


def flash_bwd_twice(torch, case, q, k, v, *, causal, window,
                    scale=None) -> dict:
    """The same backward call twice on its route, checked bit-equal: no
    atomics, sums in a fixed order."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=q.device)
    g.manual_seed(q.shape[2] + 1)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    _, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                scale=scale, return_lse=True)
    call = lambda: fa.flash_attention_backward(q, k, v, do, lse,
                                               causal=causal, window=window,
                                               scale=scale)
    first, second = call(), call()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    if not equal:
        fail(f"flash backward {case}: two calls differ")
    row = {"kernel": "flash_attention.flash_attention_backward",
           "case": case, "route": fa.backward_route(q.dtype, q.shape[3]),
           "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} "
                    f"causal={causal} window={window}",
           "calls": 2, "bit_equal": equal}
    emit({"phase": "train_kernels", **row})
    return row


def bag_bwd_row(torch, case, ids, n_rows, d, mode, *, flush,
                library=False) -> dict:
    """The embedding-bag backward kernel against its plain version: dense
    (F, V, D) float32 table gradients within ``BAG_BWD_TOL``, CUDA-event
    and device times, the plain version's, and (``library``)
    ``F.embedding_bag``'s backward over the stacked tables, its gradient
    held to the plain version too; bound by bytes: d_out and the ids read
    once, the dense gradient written once."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb

    b, f, bag_len = ids.shape
    g = torch.Generator(device=ids.device)
    g.manual_seed(n_rows + d)
    d_out = torch.randn((b, f, d), generator=g, device=ids.device)
    kern = lambda: eb.embedding_bag_backward(d_out, ids, n_rows, mode)
    plain = lambda: eb.embedding_bag_backward_plain(d_out, ids, n_rows, mode)
    before = eb.bwd_launches
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    if eb.bwd_launches != before + 1:
        fail(f"embedding_bag backward {case}: not one launch")
    err = rel_err(torch, got, want)
    max_abs = float((got - want).abs().max())
    if err > BAG_BWD_TOL:
        fail(f"embedding_bag backward {case}: relative error {err}")
    del got, want
    torch.cuda.empty_cache()
    lib_ms = lib_err = None
    if library:
        # one (F * V + 2, D) table, ids offset by field; padding (-1) reads
        # row F * V as ``padding_idx`` (out of the sum, the mean's count and
        # the gradient, as in the kernel) and ids >= V a sink row F * V + 1
        # (in the count, its gradient dropped, as in the kernel)
        weight = torch.randn((f * n_rows + 2, d), generator=g,
                             device=ids.device)
        idx = ids.long()
        flat = torch.where(idx < 0, f * n_rows, torch.where(
            idx >= n_rows, f * n_rows + 1,
            idx + n_rows * torch.arange(f, device=ids.device)[None, :, None])
            ).reshape(b * f, bag_len)
        pad = {"padding_idx": f * n_rows} if bool((idx < 0).any()) else {}
        lib, (grad,) = grad_of(
            torch, lambda w: F.embedding_bag(flat, w, mode=mode, **pad),
            (weight,), d_out.reshape(b * f, d))
        lib_err = rel_err(torch, grad[:f * n_rows].view(f, n_rows, d),
                          plain())
        if lib_err > BAG_BWD_TOL:
            fail(f"embedding_bag backward {case}: F.embedding_bag's gradient "
                 f"differs from the plain version by {lib_err}")
        lib_ms = cuda_ms(torch, lib, runs=5, warmup=1, flush=flush)
        del lib, grad, weight, flat, idx
        torch.cuda.empty_cache()
    n_bytes = d_out.numel() * 4 + ids.numel() * 4 + f * n_rows * d * 4
    bnd, by = bound_ms(n_bytes, 0.0)
    dev_all, dev_own = device_ms(torch, kern,
                                 ("embedding_bag_backward_kernel",),
                                 per_call=1)
    row = {"kernel": "embedding_bag.embedding_bag_backward", "case": case,
           "shape": f"d_out {tuple(d_out.shape)} ids {tuple(ids.shape)} "
                    f"onto ({f}, {n_rows}, {d}) mode={mode}",
           "padded": int((ids < 0).sum()), "beyond_vocab":
               int((ids >= n_rows).sum()),
           "max_abs_err": max_abs, "rel_err": err, "tol": BAG_BWD_TOL,
           "ms": cuda_ms(torch, kern, runs=5, warmup=1, flush=flush),
           "plain_ms": cuda_ms(torch, plain, runs=3, warmup=1, flush=flush),
           "library_ms": lib_ms, "library_rel_err": lib_err,
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}
    emit({"phase": "train_kernels", **row})
    return row


def seg_bwd_row(torch, dev, case, n_rows, n_seg, d, *, flush) -> dict:
    """The segment-sum backward kernel against its plain version at
    EGNN's minibatch_lg budget (rows sorted by a random receiver, a tail of
    padded rows past indptr[N]): equal bits; CUDA-event and device times,
    the plain version's and ``index_select``'s (the same gather); bound by
    bytes: d_out and indptr read once, the rows' gradient written once."""
    from repro_torch.kernels import segment_sum as ss

    g = torch.Generator(device=dev)
    g.manual_seed(n_rows + n_seg)
    seg = torch.randint(0, n_seg, (n_rows,), generator=g, device=dev,
                        dtype=torch.int32)
    seg[-n_rows // 20:] = n_seg                       # padded edges
    _, seg_s, indptr = ss.sort_by_segment(seg, n_seg)
    d_out = torch.randn((n_seg, d), generator=g, device=dev)
    kern = lambda: ss.sorted_segment_sum_backward(d_out, seg_s, indptr)
    plain = lambda: ss.sorted_segment_sum_backward_plain(d_out, seg_s,
                                                         indptr)
    live = seg_s < n_seg
    idx = seg_s.clamp(max=n_seg - 1).long()
    lib = lambda: d_out.index_select(0, idx)
    before = ss.bwd_launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if ss.bwd_launches != before + 1 or not torch.equal(got, want):
        fail(f"segment_sum backward {case}: not equal to the plain version")
    if not torch.equal(lib()[live], got[live]):
        fail(f"segment_sum backward {case}: index_select disagrees")
    n_bytes = d_out.numel() * 4 + indptr.numel() * 4 + n_rows * d * 4
    bnd, by = bound_ms(n_bytes, 0.0)
    dev_all, dev_own = device_ms(torch, kern,
                                 ("segment_sum_backward_kernel",),
                                 per_call=1)
    row = {"kernel": "segment_sum.sorted_segment_sum_backward", "case": case,
           "shape": f"d_out ({n_seg}, {d}) onto {n_rows} rows "
                    f"({int(live.sum())} live)",
           "max_abs_err": 0.0, "equal_plain": True,
           "ms": cuda_ms(torch, kern, flush=flush),
           "plain_ms": cuda_ms(torch, plain, flush=flush),
           "library_ms": cuda_ms(torch, lib, flush=flush),
           "device_ms": dev_all, "kernel_device_ms": dev_own,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}
    emit({"phase": "train_kernels", **row})
    return row


def train_kernel_rows(torch, dev) -> dict:
    """Each backward kernel against its plain version at the training
    path's shapes: the flash backward at StarCoder2's (q (1, 24, 4096,
    128), kv (1, 2, 4096, 128); route `bwd_wgmma`, and twice, bit-equal),
    a windowed head-dim-64 call of a group of 4 off the tiles
    (`bwd_wgmma`), Gemma3's head dim 256 with its 1,024-key window and
    without it, and DeepSeek-V2's MLA call padded to 256 (group 1, 128
    heads, 1,024 tokens; all `bwd_wgmma`, each also twice, bit-equal), the
    windowed call in float32 at 2,048 tokens (`bwd_fma`); the bag backward
    at the two-tower shape and a padded mean case, both beside
    ``F.embedding_bag``'s backward; the segment backward at minibatch_lg's
    budget."""
    from repro_torch.configs import get_arch

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(29)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = {"flash": [], "flash_twice": [], "bag": [], "seg": []}
    sc = get_arch("starcoder2-3b").CONFIG
    s = TRAIN_LM[2]
    sc_qkv = (rnd(1, sc.n_heads, s, sc.d_head),
              rnd(1, sc.n_kv_heads, s, sc.d_head),
              rnd(1, s, sc.n_kv_heads, sc.d_head).transpose(1, 2))
    rows["flash"].append(flash_bwd_row(
        torch, "starcoder2_train", *sc_qkv, causal=True, window=None,
        route="bwd_wgmma", flush=flush))
    rows["flash_twice"].append(flash_bwd_twice(
        torch, "starcoder2_train_twice", *sc_qkv, causal=True, window=None))
    del sc_qkv
    # head dim 64, a group of 4, Sq < Skv and neither a multiple of 64, a
    # window without the causal mask
    rows["flash"].append(flash_bwd_row(
        torch, "dh64_group4_window", rnd(2, 16, 1000, 64),
        rnd(2, 4, 1234, 64), rnd(2, 4, 1234, 64), causal=False, window=300,
        route="bwd_wgmma", flush=flush))
    gm = get_arch("gemma3-4b").CONFIG
    gm_qkv = (rnd(1, gm.n_heads, s, gm.d_head),
              rnd(1, gm.n_kv_heads, s, gm.d_head),
              rnd(1, s, gm.n_kv_heads, gm.d_head).transpose(1, 2))
    for case, window in (("gemma3_window_dh256", gm.window),
                         ("gemma3_global_dh256", None)):
        rows["flash"].append(flash_bwd_row(
            torch, case, *gm_qkv, causal=True, window=window,
            route="bwd_wgmma", flush=flush))
        rows["flash_twice"].append(flash_bwd_twice(
            torch, case + "_twice", *gm_qkv, causal=True, window=window))
    # the FMA kernels, which no main path takes now: Gemma3's windowed call
    # in float32, cut to the cut run's 2,048 tokens
    n_tok = TRAIN_GEMMA3[3]
    rows["flash"].append(flash_bwd_row(
        torch, "gemma3_window_dh256_float32",
        *(x[:, :, :n_tok].float() for x in gm_qkv), causal=True,
        window=gm.window, route="bwd_fma", flush=flush))
    del gm_qkv
    m = get_arch("deepseek-v2-236b").CONFIG
    dqk = m.mla.d_nope + m.mla.d_rope
    mla_qkv = tuple(rnd(1, m.n_heads, 1024, 256) for _ in range(3))
    rows["flash"].append(flash_bwd_row(
        torch, "mla_padded_group1", *mla_qkv, causal=True, window=None,
        route="bwd_wgmma", scale=dqk ** -0.5, flush=flush))
    rows["flash_twice"].append(flash_bwd_twice(
        torch, "mla_padded_group1_twice", *mla_qkv, causal=True, window=None,
        scale=dqk ** -0.5))
    del mla_qkv

    tt = get_arch("two-tower-retrieval").CONFIG
    nf = tt.n_sparse // 2
    ids = torch.randint(0, tt.vocab_per_field, (TRAIN_TT_BATCH, nf, 1),
                        generator=g, device=dev, dtype=torch.int32)
    rows["bag"].append(bag_bwd_row(torch, "two_tower_train", ids,
                                   tt.vocab_per_field, tt.embed_dim, "sum",
                                   flush=flush, library=True))
    ids = torch.randint(-1, 100_000 + 2, (4096, 8, 20), generator=g,
                        device=dev, dtype=torch.int32)
    rows["bag"].append(bag_bwd_row(torch, "padded_mean_L20", ids, 100_000,
                                   64, "mean", flush=flush, library=True))
    del ids
    f = TRAIN_EG_FANOUT
    n_nodes = TRAIN_EG_SEEDS * (1 + f[0] + f[0] * f[1])
    n_edges = TRAIN_EG_SEEDS * (f[0] + f[0] * f[1])
    rows["seg"].append(seg_bwd_row(torch, dev, "minibatch_lg_m", n_edges,
                                   n_nodes,
                                   get_arch("egnn").CONFIG.d_hidden,
                                   flush=flush))
    del flush
    _free(torch)
    return rows


def _leaf_paths(tree, prefix=""):
    """(path, leaf) of a nested dict of tensors, in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaf_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def lm_grad_check(torch, cfg, params, batch, impl, layers):
    """(loss, global gradient norm, {leaf: float32 gradient}) of one
    batch through ``lm_loss(impl=)``: every leaf of ``layers`` of the
    stacked layers, and the embedding, kept."""
    from repro_torch.models import lm as LM

    paths = _leaf_paths(params)
    loss, _ = LM.lm_loss(LM.lm_view(params, cfg), batch, impl=impl)
    grads = torch.autograd.grad(loss, [p for _, p in paths])
    norm2 = sum(float(g.float().pow(2).sum()) for g in grads)
    kept = {}
    for (path, _), gr in zip(paths, grads):
        if path == "embed":
            kept[path] = gr.float()
        elif path.startswith("layers/"):
            for l in layers:
                kept[f"{path}[{l}]"] = gr[l].float()
    del grads
    return float(loss.detach()), norm2 ** 0.5, kept


def lm_compare(torch, kern, plain, calls=None) -> dict:
    """The kernel path's (loss, norm, grads) against the plain path's:
    relative loss and norm gaps, the least cosine, the plain attention
    calls' largest error against the kernel on their own inputs (over the
    call limit; ``calls``), and whether all are within their limits."""
    loss_gap = abs(kern[0] - plain[0]) / abs(plain[0])
    norm_gap = abs(kern[1] - plain[1]) / plain[1]
    cos = {}
    for name, a in kern[2].items():
        b = plain[2][name]
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()).clamp(
            min=1e-30))
    worst = min(cos, key=cos.get)
    out = {"loss": kern[0], "plain_loss": plain[0], "loss_rel_gap": loss_gap,
           "grad_norm": kern[1], "plain_grad_norm": plain[1],
           "grad_norm_rel_gap": norm_gap, "min_cosine": cos[worst],
           "min_cosine_leaf": worst, "leaves_checked": len(cos),
           "ok": bool(loss_gap <= LM_LOSS_RTOL and norm_gap <= LM_GNORM_RTOL
                      and cos[worst] >= LM_GRAD_COS)}
    if calls is not None:
        layer = max(calls, key=calls.get)
        out.update({"calls_checked": len(calls), "worst_call_layer": layer,
                    "worst_call_over_limit": calls[layer]})
        out["ok"] = out["ok"] and calls[layer] <= 1.0
    return out


@contextlib.contextmanager
def plain_attention(torch, params, n_layers, *, calls=None, shift=None,
                    nudge=False):
    """Hooks on the plain path's attention (``dense_attention``), each
    layer found by its ``wq`` view of ``params``.  ``calls``: each layer's
    first call (the forward's; the recompute repeats it) held against the
    flash kernel on its own inputs, ``calls[layer]`` the largest |Δ| over
    FLASH_TOL + FAMILY_CALL_RTOL * |plain|.  ``shift``: that layer's causal
    mask shifted by one key (each query also sees the next token).
    ``nudge``: every attention output moved one bf16 step (the witness of
    bf16 noise)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.layers import attention as A

    wq = params["layers"]["attn"]["wq"]
    layer_of = {wq[l].data_ptr(): l for l in range(n_layers)}
    mha, dense = A.mha_forward, A.dense_attention
    state = {"layer": None}

    def mha_hooked(p, x, **kw):
        state["layer"] = layer_of.get(p.wq.data_ptr())
        try:
            return mha(p, x, **kw)
        finally:
            state["layer"] = None

    def dense_hooked(q, k, v, *, causal, window, q_offset=0):
        l = state["layer"]
        o = dense(q, k, v, causal=causal, window=window,
                  q_offset=q_offset + int(l is not None and l == shift))
        if nudge:
            o = (o.float() * (1 + 2 ** -8)).to(o.dtype)
        if calls is not None and l is not None and l not in calls:
            with torch.no_grad():
                want = o.detach().float()
                got = fa.flash_attention(
                    q.detach(), k.detach(), v.detach(), causal=causal,
                    window=window if window > 0 else None).float()
                lim = FLASH_TOL["bfloat16"] + FAMILY_CALL_RTOL * want.abs()
                calls[l] = float(((got - want).abs() / lim).max())
        return o

    A.mha_forward, A.dense_attention = mha_hooked, dense_hooked
    try:
        yield
    finally:
        A.mha_forward, A.dense_attention = mha, dense


def lm_path_check(torch, cfg, params, batch, layers) -> dict:
    """The kernel path against the plain path (``impl="dense"``: plain
    attention under autograd, every call also held to the kernel on its own
    inputs) from ``params`` on one batch, then the same with the middle
    layer's causal mask shifted by one key on the plain path (the control),
    which must fail."""
    kern = lm_grad_check(torch, cfg, params, batch, "chunked", layers)
    calls = {}
    with plain_attention(torch, params, cfg.n_layers, calls=calls):
        plain = lm_grad_check(torch, cfg, params, batch, "dense", layers)
    check = lm_compare(torch, kern, plain, calls)
    ctl_calls = {}
    with plain_attention(torch, params, cfg.n_layers, calls=ctl_calls,
                         shift=layers[1]):
        control = lm_compare(torch, kern, lm_grad_check(
            torch, cfg, params, batch, "dense", layers), ctl_calls)
    return {"check": check, "control": control,
            "control_shift_layer": layers[1]}


def lm_train_run(torch, dev, seed) -> dict:
    """StarCoder2-3B trained at full depth and width through the port's
    ``TrainLoop``.  Before the first step, the kernel path against the
    plain path at batch 1 from the initial weights, and the shifted-mask
    control; after the last, the same comparison and a witness (the plain
    path with every attention output one bf16 step off) recorded."""
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import lm_batch_stream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm as LM
    from repro_torch.train import TrainLoop
    from repro_torch.train.loop import to_device

    arch, b, s, steps = TRAIN_LM
    cfg = get_arch(arch).CONFIG
    if not cfg.remat or cfg.param_dtype != "bfloat16":
        fail(f"{arch}: expected a bf16 config with remat")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.param_tree(LM.init_lm(cfg, seed=seed, device=dev))
    for p in _leaves(params)[0]:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the kernel path against the plain path, one sequence, same weights
    one = to_device(next(lm_batch_stream(np.random.default_rng(seed + 1),
                                         cfg.vocab, 1, s)), dev)
    layers = (0, cfg.n_layers // 2, cfg.n_layers - 1)
    t0 = time.perf_counter()
    first = lm_path_check(torch, cfg, params, one, layers)
    if not first["check"]["ok"]:
        fail(f"{arch}: kernel path against plain path {first['check']}")
    if first["control"]["ok"]:
        fail(f"{arch}: the shifted-mask control passed the check: "
             f"{first['control']}")
    check_s = time.perf_counter() - t0
    _free(torch)

    loop = TrainLoop(lambda p, bt: LM.lm_loss(LM.lm_view(p, cfg), bt),
                     lambda: params,
                     lm_batch_stream(np.random.default_rng(seed), cfg.vocab,
                                     b, s),
                     log_every=1, base_lr=TRAIN_LM_LR, warmup=TRAIN_LM_WARMUP,
                     total_steps=steps)
    n_params = sum(p.numel() for p in _leaves(params)[0])
    zero_counts()
    t0 = time.perf_counter()
    loop.run(steps)
    train_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in loop.history]
    gnorms = [h["grad_norm"] for h in loop.history]
    if not all(np.isfinite(losses + gnorms)) or not losses[-1] < losses[0]:
        fail(f"{arch} training: losses {losses}, grad norms {gnorms}")
    kind = fa.route(torch.bfloat16, cfg.d_head, s,
                    cfg.n_heads // cfg.n_kv_heads, s)
    if fa.backward_route(torch.bfloat16, cfg.d_head) != "bwd_wgmma":
        fail(f"{arch}: its backward is not on bwd_wgmma")
    want = {"flash_attention.flash_attention": 2 * cfg.n_layers * steps,
            f"flash_attention.{kind}": 2 * cfg.n_layers * steps,
            "flash_attention.flash_attention_backward": cfg.n_layers * steps,
            "flash_attention_bwd.bwd_wgmma": cfg.n_layers * steps,
            "flash_attention_bwd.bwd_fma": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"{arch} training launches {counts}, expected {want} (a "
             f"forward and a remat recompute, one backward a layer a step, "
             f"all on bwd_wgmma)")
    step_s = float(np.median(loop.step_times))
    tokens = b * s
    attn_flops = 3 * 4.0 * b * cfg.n_heads * cfg.d_head * s * (s + 1) / 2 \
        * cfg.n_layers
    flops = 6.0 * n_params * tokens + attn_flops
    row = {"phase": "train", "model": arch, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params, "batch": b, "seq": s,
           "global_batch_cut": "train_4k's 256 sequences to 4 (one card)",
           "steps": steps, "lr": TRAIN_LM_LR, "losses": losses,
           "grad_norms": gnorms, "init_s": init_s, "train_s": train_s,
           "step_ms_p50": step_s * 1e3,
           "step_ms": [t * 1e3 for t in loop.step_times],
           "tokens_per_s": tokens / step_s, "model_flops_per_step": flops,
           "attention_flops_per_step": attn_flops,
           "bf16_peak_share": flops / step_s / PEAK_BF16_FLOPS,
           "max_memory_allocated_gb": peak_gb,
           "launches": {k: counts[k] for k in want},
           "plain_check": first["check"], "control": first["control"],
           "control_shift_layer": first["control_shift_layer"],
           "check_s": check_s}
    del loop
    _free(torch)

    # after the steps: recorded, not gated (the plain path rounds dP to
    # bf16 through p.to(v.dtype)'s backward, which swamps dP - D in rows
    # peaked on one key; the witness shows that floor)
    kern = lm_grad_check(torch, cfg, params, one, "chunked", layers)
    plain = lm_grad_check(torch, cfg, params, one, "dense", layers)
    with plain_attention(torch, params, cfg.n_layers, nudge=True):
        witness = lm_grad_check(torch, cfg, params, one, "dense", layers)
    row["after_training"] = {
        "kernel_vs_plain": lm_compare(torch, kern, plain),
        "witness_vs_plain": lm_compare(torch, witness, plain)}
    emit(row)
    del params, kern, plain, witness
    _free(torch)
    return {k: counts[k] for k in want}


def gemma3_train_run(torch, dev, seed) -> dict:
    """Gemma3-4B at full width cut to its first ``TRAIN_GEMMA3`` layers
    (five windowed, one global; head dim 256, so every forward takes
    `prefill_wgmma`, writing its log-sum-exp, and every backward
    `bwd_wgmma`): the kernel path against the plain path at the initial
    weights on one sequence, then a few AdamW steps, their step ms."""
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import lm_batch_stream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm as LM
    from repro_torch.train import TrainLoop
    from repro_torch.train.loop import to_device

    arch, n_layers, b, s, steps = TRAIN_GEMMA3
    cfg = dataclasses.replace(get_arch(arch).CONFIG, n_layers=n_layers)
    params = LM.param_tree(LM.init_lm(cfg, seed=seed, device=dev))
    for p in _leaves(params)[0]:
        p.requires_grad_(True)
    one = to_device(next(lm_batch_stream(np.random.default_rng(seed + 2),
                                         cfg.vocab, 1, s)), dev)
    layers = (0, n_layers // 2, n_layers - 1)
    check = lm_compare(
        torch, lm_grad_check(torch, cfg, params, one, "chunked", layers),
        lm_grad_check(torch, cfg, params, one, "dense", layers))
    if not check["ok"]:
        fail(f"{arch} ({n_layers} layers): kernel path against plain path "
             f"{check}")
    _free(torch)
    loop = TrainLoop(lambda p, bt: LM.lm_loss(LM.lm_view(p, cfg), bt),
                     lambda: params,
                     lm_batch_stream(np.random.default_rng(seed), cfg.vocab,
                                     b, s),
                     log_every=1, base_lr=TRAIN_LM_LR, warmup=1,
                     total_steps=steps)
    zero_counts()
    loop.run(steps)
    counts = read_counts()
    losses = [h["loss"] for h in loop.history]
    if not all(np.isfinite(losses)):
        fail(f"{arch} training: losses {losses}")
    if fa.backward_route(torch.bfloat16, cfg.d_head) != "bwd_wgmma":
        fail(f"{arch}: its backward is not on bwd_wgmma")
    want = {"flash_attention.prefill_wgmma": 2 * n_layers * steps,
            "flash_attention.fma": 0,
            "flash_attention_bwd.bwd_wgmma": n_layers * steps,
            "flash_attention_bwd.bwd_fma": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"{arch} training launches {counts}, expected {want} (every "
             f"backward on bwd_wgmma)")
    emit({"phase": "train", "model": arch, "layers": n_layers,
          "layers_cut": f"{cfg.n_layers} of 34: five windowed and one global",
          "batch": b, "seq": s, "steps": steps, "losses": losses,
          "step_ms_p50": float(np.median(loop.step_times)) * 1e3,
          "step_ms": [t * 1e3 for t in loop.step_times],
          "plain_check": check, "launches": {k: counts[k] for k in want}})
    del loop, params
    _free(torch)
    return {k: counts[k] for k in ("flash_attention_bwd.bwd_wgmma",
                                   "flash_attention_bwd.bwd_fma")}


def loss_grads(torch, loss_fn, params, batch):
    """(loss, every leaf's gradient, zeros where the loss does not reach
    the leaf) of one batch."""
    from repro_torch.checkpoint.ckpt import _leaves

    leaves = _leaves(params)[0]
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for g, p in zip(grads, leaves)]


def step1_check(torch, name, loss_fn, params, batch) -> dict:
    """The kernel path's step-1 gradients against the plain path's (every
    ``ops`` entry on its plain version), leaf by leaf within
    ``TRAIN_GRAD_RTOL`` of the leaf's largest |plain|."""
    lk, gk = loss_grads(torch, loss_fn, params, batch)
    with plain_ops():
        lp, gp = loss_grads(torch, loss_fn, params, batch)
    errs = [rel_err(torch, a, b) for a, b in zip(gk, gp)]
    worst = max(errs)
    if worst > TRAIN_GRAD_RTOL or abs(lk - lp) > 1e-5 * abs(lp):
        fail(f"{name}: step-1 gradients of the kernel path against the "
             f"plain path: loss {lk} / {lp}, worst leaf {worst}")
    return {"loss": lk, "plain_loss": lp, "max_rel_grad_err": worst,
            "leaves": len(errs)}


def two_tower_train_run(torch, dev, seed) -> dict:
    """Two-tower retrieval trained whole (8 x 1M x 256 tables, towers
    1024-512-256, Matryoshka losses at 64 / 128) at batches of 8,192."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import recsys_batch_stream
    from repro_torch.models import recsys as R
    from repro_torch.train import TrainLoop
    from repro_torch.train.loop import to_device

    cfg = get_arch("two-tower-retrieval").CONFIG

    def stream():
        return recsys_batch_stream(np.random.default_rng(seed), cfg.family,
                                   TRAIN_TT_BATCH, n_sparse=cfg.n_sparse,
                                   vocab=cfg.vocab_per_field)

    loss_fn = lambda p, bt: R.recsys_loss(p, bt, cfg)
    torch.cuda.reset_peak_memory_stats()
    params = R.param_tree(R.recsys_init(cfg, seed=seed, device=dev))
    check = step1_check(torch, "two-tower", loss_fn, params,
                        to_device(next(stream()), dev))
    check["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 2**30
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(loss_fn, lambda: params, stream(), log_every=1,
                     base_lr=TRAIN_TT_LR, warmup=1,
                     total_steps=TRAIN_TT_STEPS)
    zero_counts()
    t0 = time.perf_counter()
    loop.run(TRAIN_TT_STEPS)
    train_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [h["loss"] for h in loop.history]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"two-tower training: losses {losses}")
    want = {"embedding_bag.embedding_bag": 2 * TRAIN_TT_STEPS,
            "embedding_bag.embedding_bag_backward": 2 * TRAIN_TT_STEPS}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"two-tower training launches {counts}, expected {want}")
    step_s = float(np.median(loop.step_times))
    emit({"phase": "train", "model": "two-tower-retrieval",
          "batch": TRAIN_TT_BATCH,
          "global_batch_cut": "train_batch's 65,536 to 8,192",
          "steps": TRAIN_TT_STEPS, "losses": losses,
          "accuracies": [h["acc"] for h in loop.history],
          "step1_check": check, "train_s": train_s,
          "step_ms_p50": step_s * 1e3,
          "step_ms": [t * 1e3 for t in loop.step_times],
          "examples_per_s": TRAIN_TT_BATCH / step_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches": {k: counts[k] for k in want}})
    del loop, params
    _free(torch)
    return {k: counts[k] for k in want}


def egnn_train_run(torch, dev, seed) -> dict:
    """EGNN (CONFIG width, 602 input features) trained on minibatch_lg
    subgraphs of a power-law random graph of Reddit's size (drawn on the
    card, built as a host CSR); two subgraphs taken in turn, so step 5 sees
    step 1's."""
    import itertools

    from repro_torch.configs import get_arch
    from repro_torch.models import egnn as EG
    from repro_torch.models import graph as G
    from repro_torch.train import TrainLoop

    cfg = dataclasses.replace(get_arch("egnn").CONFIG,
                              d_feat_in=REDDIT_FEATS)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    n, e = REDDIT_NODES, REDDIT_EDGES
    # power-law endpoints (random_graph's Pareto weights) drawn on the card
    # by inverse CDF, in bulk, then moved to the host the sampler reads
    w = rng.pareto(2.0, n) + 1.0
    cdf = torch.from_numpy(np.cumsum(w / w.sum())).to(dev)

    def endpoints():
        u = torch.rand((e,), generator=gen, device=dev, dtype=torch.float64)
        ids = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        return ids.to(torch.int32).cpu().numpy()

    senders, receivers = endpoints(), endpoints()
    feats = torch.randn((n, REDDIT_FEATS), generator=gen,
                        device=dev).cpu().numpy()
    labels = rng.integers(0, cfg.n_classes, n, dtype=np.int32)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    del cdf
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = G.CSRGraph(n, senders, receivers)
    csr_s = time.perf_counter() - t0
    max_deg = int(np.diff(csr.indptr).max())
    del senders, receivers
    f = TRAIN_EG_FANOUT
    budget = dict(node_budget=TRAIN_EG_SEEDS * (1 + f[0] + f[0] * f[1]),
                  edge_budget=TRAIN_EG_SEEDS * (f[0] + f[0] * f[1]))
    t0 = time.perf_counter()
    graphs = [G.sampled_subgraph(rng, csr, feats, labels, coords,
                                 TRAIN_EG_SEEDS, f, device=dev, **budget)
              for _ in range(2)]
    sample_s = (time.perf_counter() - t0) / 2
    del csr, feats
    live = [int(g_.edge_mask.sum()) for g_ in graphs]

    loss_fn = lambda pr, g_: EG.egnn_loss(pr, g_, cfg)
    params = EG.param_tree(EG.egnn_init(cfg, seed=seed, device=dev))
    check = step1_check(torch, "EGNN", loss_fn, params, graphs[0])
    loop = TrainLoop(loss_fn, lambda: params, itertools.cycle(graphs),
                     log_every=1, base_lr=TRAIN_EG_LR, warmup=1,
                     total_steps=TRAIN_EG_STEPS, prefetch=False)
    zero_counts()
    t0 = time.perf_counter()
    loop.run(TRAIN_EG_STEPS)
    train_s = time.perf_counter() - t0
    counts = read_counts()
    losses = [h["loss"] for h in loop.history]
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        fail(f"EGNN training: losses {losses} (steps 1 and 5 see the same "
             f"subgraph)")
    # a forward sums degrees, coordinates and messages in each layer; the
    # backward reaches every sum but the degrees' (no gradient) and the
    # last layer's coordinates (the loss reads the features only)
    want = {"segment_sum.sorted_segment_sum": 3 * cfg.n_layers
            * TRAIN_EG_STEPS,
            "segment_sum.sorted_segment_sum_backward":
                (2 * cfg.n_layers - 1) * TRAIN_EG_STEPS}
    if any(counts[k] != n_ for k, n_ in want.items()):
        fail(f"EGNN training launches {counts}, expected {want}")
    emit({"phase": "train", "model": "egnn", "shape": "minibatch_lg",
          "graph": {"nodes": n, "edges": e, "features": REDDIT_FEATS,
                    "max_out_degree": max_deg},
          "graph_draw_s": gen_s, "csr_build_s": csr_s,
          "sample_s": sample_s, "live_edges": live, **budget,
          "steps": TRAIN_EG_STEPS, "losses": losses,
          "step1_check": check, "train_s": train_s,
          "step_ms_p50": float(np.median(loop.step_times)) * 1e3,
          "step_ms": [t_ * 1e3 for t_ in loop.step_times],
          "launches": {k: counts[k] for k in want}})
    del loop, params, graphs
    _free(torch)
    return {k: counts[k] for k in want}


def train_phase(torch, dev, seed):
    """Phase 11: the backward kernels' rows, then the four training runs.
    Returns (the main paths' launches by counter, summed over the runs,
    and the kernel rows)."""
    emit({"phase": "train_memory", "before": "train_phase",
          "allocated_gb": torch.cuda.memory_allocated() / 2**30})
    rows = train_kernel_rows(torch, dev)
    counts = {}
    for run in (lm_train_run, gemma3_train_run, two_tower_train_run,
                egnn_train_run):
        for name, n in run(torch, dev, seed).items():
            counts[name] = counts.get(name, 0) + n
        # what a run leaves on the card (it should free all it made)
        emit({"phase": "train_memory", "after": run.__name__,
              "allocated_gb": torch.cuda.memory_allocated() / 2**30})
    return counts, rows


def _bwd_entry(name, source, launches, rows, note) -> dict:
    """The kernels-line entry of a backward kernel: its first row, the
    others beside it, the training path's launches."""
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "kernel_device_ms",
            "bound_ms", "bound_by", "shape")
    first = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": note, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: first[k] for k in keys},
            **{r["case"]: {k: r[k] for k in keys} for r in rows[1:]}}


def _flash_bwd_entry(counts, rows, note) -> dict:
    """The kernels-line entry of the flash backward, both routes in one as
    the forward's kernels are: StarCoder2's training row first, the other
    rows by case beside it (each naming the route that served it), every
    row's largest error, the training runs' launches in all and by route,
    the bit-equality of the calls made twice, the routes."""
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "kernel_device_ms",
            "bound_ms", "bound_by", "shape")
    flash = rows["flash"]
    first = flash[0]
    by_kernel = {kind: counts[f"flash_attention_bwd.{kind}"]
                 for kind in ("bwd_wgmma", "bwd_fma")}
    return {"name": "flash_attention.flash_attention_backward",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
            "sources_by_kernel": {
                kind: f"src/repro_torch/csrc/{stem}.cu" for kind, stem in (
                    ("bwd_wgmma", "flash_attention_bwd_wgmma"),
                    ("bwd_fma", "flash_attention_bwd"))},
            "replaces": note, "launches": sum(by_kernel.values()),
            "launches_by_kernel": by_kernel, "served_by": first["route"],
            "max_abs_err": max(r["max_abs_err"] for r in flash),
            **{k: first[k] for k in keys},
            **{r["case"]: {"served_by": r["route"],
                           "max_abs_err": r["max_abs_err"],
                           **{k: r[k] for k in keys}} for r in flash[1:]},
            "bit_equal": {r["case"]: r["bit_equal"]
                          for r in rows["flash_twice"]},
            "routes": {
                "bwd_wgmma": "bf16, head dims 64 / 128 / 256",
                "bwd_fma": "float32 at every head dim, bf16 at 16 / 32"}}


def train_entries(counts, rows) -> list:
    new = "none: new in the port, no Pallas counterpart (the JAX package " \
          "trains through XLA: {})"
    return [
        _flash_bwd_entry(counts, rows,
                         new.format("src/repro/layers/attention.py:95")),
        _bwd_entry("embedding_bag.embedding_bag_backward",
                   "src/repro_torch/csrc/embedding_bag.cu",
                   counts["embedding_bag.embedding_bag_backward"],
                   rows["bag"], new.format("src/repro/models/recsys.py:41")),
        _bwd_entry("segment_sum.sorted_segment_sum_backward",
                   "src/repro_torch/csrc/segment_sum.cu",
                   counts["segment_sum.sorted_segment_sum_backward"],
                   rows["seg"], new.format("src/repro/models/egnn.py:89")),
    ]


def _scan_entry(name, source, replaces, launches, rows) -> dict:
    first = rows[0]
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": first["ms"], "plain_ms": first["plain_ms"],
           "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
           "library_ms": None,
           "gather_matmul_topk_ms": first["gather_matmul_topk_ms"],
           "shape": first["shape"]}
    # the list-major scans: one launch a call, host time, the per-query
    # bound, the share of distinct lists among the probes
    keys = ("kernel_device_ms", "premasked_ms", "host_us_per_call",
            "launches_per_call", "cluster", "bound_per_query_ms",
            "model_bound_ms",
            "distinct_list_share", "live_slot_share")
    out.update({key: first[key] for key in keys if key in first})
    for r in rows[1:]:                 # the int8 slabs of the same kernel
        out[r["backend"]] = {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "gather_matmul_topk_ms",
            "shape", *keys) if key in r}
    return out


def _flash_entry(launches, rows, families) -> dict:
    """The kernels-line entry: the bf16 serving rows (prefill first, then
    decode and the 4k prompt), every case's largest error per type, the
    main path's launches in all and by kernel, the routes (which kernel
    takes which dtype and head dim, by name; the prefill's tiles are on
    the device line); then
    the LM families' launches by kernel and their rows (phase 7b)."""
    fam_launches, fam_rows = families
    rows = rows + fam_rows
    serve = {r["case"]: r for r in rows if r["dtype"] == "bfloat16"}
    f32 = {r["case"]: r for r in rows if r["dtype"] == "float32"
           and r["case"] in ("prefill", "decode")}
    keys = ("served_by", "ms", "plain_ms", "library_ms", "device_ms",
            "kernel_device_ms", "bound_ms", "bound_by", "shape")
    pre = serve["prefill"]
    by_kernel = {name.split(".", 1)[1]: n for name, n in launches.items()
                 if name.startswith("flash_attention.")
                 and name != "flash_attention.flash_attention"}
    return {"name": "flash_attention.flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:108",
            "launches": launches["flash_attention.flash_attention"],
            "launches_by_kernel": by_kernel, "served_by": pre["served_by"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                    if r["dtype"] == "bfloat16"),
            "max_abs_err_float32": max(r["max_abs_err"] for r in rows
                                       if r["dtype"] == "float32"),
            "ms": pre["ms"], "plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": pre["library_ms"],
            "kernel_device_ms": pre["kernel_device_ms"], "shape": pre["shape"],
            "decode": {k: serve["decode"][k]
                       for k in keys + ("host_us_per_call",)},
            "prefill_4k": {k: serve["prefill_4k"][k] for k in keys},
            "float32": {c: {k: r[k] for k in keys} for c, r in f32.items()},
            "routes": {
                "prefill_wgmma": "bf16 prefill, head dims 64 / 128 / 256",
                "decode_splitkv": "Sq * Hq / Hkv <= 64, bf16 and float32",
                "fma": "float32 prefill, head dims 16 / 32, no keys"},
            "lm_families_launches": fam_launches,
            "lm_families": {r["case"]: {k: r[k] for k in keys + tuple(
                                x for x in ("lse_rel_err", "twice_bit_equal")
                                if x in r)}
                            for r in fam_rows}}


def _bag_entry(launches, rows) -> dict:
    """The kernels-line entry: the two-tower item build first, the DLRM
    shapes and the padded bags beside it, every case's largest error, the
    main path's launches in all and by route."""
    by = {r["case"]: r for r in rows}
    keys = ("served_by", "ms", "plain_ms", "library_ms", "device_ms",
            "kernel_device_ms", "host_us_per_call", "bound_ms", "bound_by",
            "shape")
    first = by["two_tower_item_build"]
    return {"name": "embedding_bag.embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:79",
            "launches": launches["embedding_bag.embedding_bag"],
            "launches_by_kernel": {kind: launches[f"embedding_bag.{kind}"]
                                   for kind in ("vec16", "scalar")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "equal_plain": all(r["equal_plain"] for r in rows),
            **{k: first[k] for k in keys},
            **{case: {k: by[case][k] for k in keys}
               for case in ("dlrm_bulk", "dlrm_p99",
                            "L100_padded_sum_float32",
                            "L100_padded_sum_bfloat16",
                            "L8_padded_sum_float32_scalar_route")}}


def _seg_entry(launches, rows) -> dict:
    """The kernels-line entry: EGNN's layer-0 message sum first, its degree
    and coordinate sums, the one-hub cases beside it, every case's largest
    error, the main path's launches in all and by kernel."""
    by = {r["case"]: r for r in rows}
    keys = ("served_by", "ms", "plain_ms", "library_ms", "segment_reduce_ms",
            "device_ms", "kernel_device_ms", "bound_ms", "bound_by", "shape",
            "max_segment_rows")
    first = by["egnn_layer0_m"]
    return {"name": "segment_sum.sorted_segment_sum", "route": "cuda",
            "source": "src/repro_torch/csrc/segment_sum.cu",
            "replaces": "src/repro/kernels/segment_sum.py:100",
            "launches": launches["segment_sum.sorted_segment_sum"],
            "launches_by_kernel": {kind: launches[f"segment_sum.{kind}"]
                                   for kind in ("wide", "narrow")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err_over_limit": max(r["err_over_limit"] for r in rows),
            **{k: first[k] for k in keys},
            **{case.replace("egnn_layer0_", ""): {k: by[case][k] for k in keys}
               for case in ("egnn_layer0_wdx", "egnn_layer0_deg",
                            "half_in_one_64", "hub_29384_64")}}


def _ladder_entry(launches, step_rows, ladder_rows) -> dict:
    """The kernels-line entry of the rescore kernel: one launch of the
    flat dispatch's whole ladder (beside its stages as single-step
    launches), the quantized PQ dispatch's, each step of the flat ladder
    alone, and the launches of every serving search by kind."""
    lad = {r["case"]: r for r in ladder_rows}
    flat = lad["flat_dispatch"]
    keys = ("ms", "single_steps_ms", "ms_one_cta_a_query", "plain_ms",
            "device_ms", "kernel_device_ms", "host_us_per_call", "bound_ms",
            "bound_by", "bound_reread_ms", "cluster", "shape")
    return {"name": "gather_rescore.gather_rescore_topk", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rescore.cu",
            "replaces": "src/repro/kernels/gather_rescore.py:98",
            "launches": launches["gather_rescore.gather_rescore_topk"],
            "launches_by_kernel": {kind: launches[f"gather_rescore.{kind}"]
                                   for kind in ("ladder", "step")},
            "max_abs_err": max(r["max_abs_err"]
                               for r in step_rows + ladder_rows),
            "library_ms": None, **{k: flat[k] for k in keys},
            "quantized_pq": {k: lad["quantized_pq_dispatch"][k]
                             for k in keys},
            "steps": [{k: r[k] for k in ("C", "dim", "k", "ms", "plain_ms",
                                         "matmul_topk_ms", "bound_ms")}
                      for r in step_rows]}


# -- 12. multi-device ---------------------------------------------------------

# Phase 12: the corpus-sharded search at the paper's deployment over 4
# ``gloo`` ranks that share the card (250,000 rows each) and over an NCCL
# world of one; the expert-parallel MoE layer at Qwen3-MoE's width over 2
# and 4 ranks; the elastic training launcher across 2 ranks, resumed on 1.
DIST_RANKS = 4
DIST_CHUNK = 50_000            # rows drawn from one seed (slabs are whole chunks)
DIST_BATCH = 32
EP_RANKS = (2, 4)
EP_TOKENS = (2, 512)
EP_TOL = 1e-2                  # relative L2 of the EP layer against moe_apply
EP_RUNS = 5
DIST_TIMEOUT_S = 600
LAUNCH_ARCH, LAUNCH_STEPS = "qwen3-moe-235b-a22b", 10
# The ranks' device and the one-rank world's backend (a rehearsal on the
# CPU sets them to "cpu" and "gloo").
DIST_DEVICE, ONE_RANK_BACKEND = "cuda", "nccl"


def dist_scales(torch, dev):
    """The serving phase's per-dim scales (a decaying spectrum)."""
    s = (1.0 + torch.arange(D_EMB, device=dev, dtype=torch.float32)) ** -0.2
    return s / s.norm() * D_EMB ** 0.5


def dist_rows(torch, dev, seed, lo, hi):
    """Rows [lo, hi) of the phase's corpus, drawn on the card: chunk c of
    `DIST_CHUNK` rows from its own seed, so a rank draws its slab with the
    same bits as the whole corpus holds."""
    if lo % DIST_CHUNK or hi % DIST_CHUNK:
        fail(f"rows [{lo}, {hi}) are not whole chunks of {DIST_CHUNK}")
    scales = dist_scales(torch, dev)
    out = torch.empty((hi - lo, D_EMB), device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev)
    for c in range(lo // DIST_CHUNK, hi // DIST_CHUNK):
        gen.manual_seed(seed * 100_003 + 7_919 + c)
        a = c * DIST_CHUNK - lo
        torch.randn((DIST_CHUNK, D_EMB), generator=gen, device=dev,
                    out=out[a:a + DIST_CHUNK])
        out[a:a + DIST_CHUNK].mul_(scales)
    return out


def _rank_setup(rank, world, init, backend="gloo"):
    """A spawned rank: the checkout's ``src`` on the path, the card, the
    process group (a ``file://`` rendezvous, no port)."""
    import datetime
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.cuda.init()
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return torch, dist


def _search_calls(torch, fn, q, db_l, sqp_l):
    """``fn`` over every batch of ``q``: (scores, ids, per-call event ms,
    per-call (collective, staging) host s), one warm-up call first."""
    from repro_torch.sharding import collectives as C

    fn(q[:DIST_BATCH], db_l, sqp_l)
    torch.cuda.synchronize()
    zero_counts()
    C.reset_counts()
    out_s, out_i, ms, coll = [], [], [], []
    for a in range(0, q.shape[0], DIST_BATCH):
        c0, s0 = C.seconds, C.staged_seconds
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        s, i = fn(q[a:a + DIST_BATCH], db_l, sqp_l)
        ev1.record()
        ev1.synchronize()
        ms.append(ev0.elapsed_time(ev1))
        coll.append((C.seconds - c0, C.staged_seconds - s0))
        out_s.append(s)
        out_i.append(i)
    counts = read_counts()
    return (torch.cat(out_s).cpu().numpy(), torch.cat(out_i).cpu().numpy(),
            ms, coll, counts, C.staged_bytes, dict(C.calls))


def staged_calls(torch, mesh, sched, db_l, sqp_l, q):
    """The staged bf16 search over this rank's slab (its (rows, d_start)
    bf16 block, the float32 rows, the first stage's norms) on every batch
    of ``q``, on the kernels and then on the plain versions: ((scores, ids,
    per-call ms, collective s, counts, staged bytes, calls) of the kernel
    path, (scores, ids) of the plain path)."""
    from repro_torch.core.distributed import build_sharded_search_staged

    fn = build_sharded_search_staged(mesh, sched, N_DOCS)
    db0_l = db_l[:, :sched.stages[0].dim].to(torch.bfloat16)
    sq0_l = sqp_l[:, :1].contiguous()

    def staged(qb, _db, _sq):
        return fn(qb, db0_l, db_l, sq0_l)

    got = _search_calls(torch, staged, q, db_l, sqp_l)
    with plain_ops():
        plain = [staged(q[a:a + DIST_BATCH], None, None)
                 for a in range(0, q.shape[0], DIST_BATCH)]
    ps = torch.cat([x for x, _ in plain]).cpu().numpy()
    pi = torch.cat([x for _, x in plain]).cpu().numpy()
    del db0_l
    return got, (ps, pi)


def dist_search_rank(rank, world, init, seed, queries, out_dir):
    """One rank of the 4-rank ``gloo`` world: its slab drawn on the card,
    both modes and the staged bf16 search over every batch, the staged
    search also on the plain versions; results and counts to
    ``out_dir``."""
    torch, dist = _rank_setup(rank, world, init)
    from repro_torch.core import make_schedule
    from repro_torch.core.distributed import build_sharded_search
    from repro_torch.core.index import prefix_squared_norms
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh_compat

    dev = torch.device(DIST_DEVICE)
    if dev.type == "cuda":
        for stem in ("distance_topk", "distance_topk_bf16", "gather_rescore"):
            _build.library(stem)
    sched = make_schedule(D_START, D_EMB, K0, final_k=FINAL_K)
    dims = tuple(s.dim for s in sched.stages)
    rows = N_DOCS // world
    db_l = dist_rows(torch, dev, seed, rank * rows, (rank + 1) * rows)
    sqp_l = prefix_squared_norms(db_l, dims)
    q = queries.to(dev)
    mesh = make_mesh_compat((world,), ("data",), device_type=dev.type)
    res = {}
    for mode in ("local", "global"):
        fn = build_sharded_search(mesh, sched, N_DOCS, has_prefix=True,
                                  index_dims=dims, mode=mode)
        s, i, ms, coll, counts, staged, calls = _search_calls(
            torch, fn, q, db_l, sqp_l)
        res[mode] = {"ms": ms, "collective_s": coll, "staged_bytes": staged,
                     "calls": calls, "counts": counts}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"search_{mode}.npz"), s=s, i=i)
    (s, i, ms, coll, counts, staged, calls), (ps, pi) = staged_calls(
        torch, mesh, sched, db_l, sqp_l, q)
    res["staged"] = {"ms": ms, "collective_s": coll, "staged_bytes": staged,
                     "calls": calls, "counts": counts}
    if rank == 0:
        np.savez(os.path.join(out_dir, "search_staged.npz"), s=s, i=i,
                 ps=ps, pi=pi)
    with open(os.path.join(out_dir, f"search_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def ep_rank(rank, world, init, seed, out_dir):
    """One rank of an EP world (1, world) over ('data', 'model'): the
    Qwen3-MoE layer at full width holding only this rank's experts
    (``ShardingCtx.held_blocks``), EP against ``moe_apply`` of the whole
    layer on the same rank; the expert bytes this rank holds."""
    torch, dist = _rank_setup(rank, world, init)
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.layers.common import dtype_of
    from repro_torch.layers.moe import MoE, moe_apply, moe_init, moe_specs
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import make_ctx

    cfg = get_arch(LAUNCH_ARCH).CONFIG
    dev = torch.device(DIST_DEVICE)
    dt = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 404)
    p = moe_init(gen, cfg.d_model, cfg.moe, cfg.ffn_type, dt, device=dev)
    x = (torch.randn(EP_TOKENS + (cfg.d_model,), generator=gen, device=dev)
         .to(dtype_of(cfg.compute_dtype)))
    mesh = make_mesh_compat((1, world), ("data", "model"),
                            device_type=dev.type)
    ctx = make_ctx(mesh)
    experts = ("w_in", "w_gate", "w_out")
    whole = {k: getattr(p, k) for k in ("router", *experts)}
    held = ctx.held_blocks({k: moe_specs(cfg.moe, cfg.ffn_type)[k]
                            for k in whole}, whole)
    p_held = MoE(held["router"], held["w_in"], held["w_out"],
                 held["w_gate"], p.shared)
    held_bytes = sum(held[k].numel() * held[k].element_size()
                     for k in experts)
    whole_bytes = sum(whole[k].numel() * whole[k].element_size()
                      for k in experts)
    with torch.no_grad():
        y_ref, aux_ref = moe_apply(p, x, cfg.moe, cfg.ffn_type)
        C.reset_counts()
        y, aux = moe_apply(p_held, x, cfg.moe, cfg.ffn_type, ctx=ctx)
        torch.cuda.synchronize()
        if C.calls["all_to_all"] != 2:
            fail(f"EP rank {rank}: {C.calls} collectives, not 2 all-to-all")
        calls = dict(C.calls)
        rel = float((y.float() - y_ref.float()).norm()
                    / y_ref.float().norm())
        ep_ms = cuda_ms(torch, lambda: moe_apply(p_held, x, cfg.moe,
                                                 cfg.ffn_type, ctx=ctx),
                        runs=EP_RUNS, warmup=1)
        ref_ms = cuda_ms(torch, lambda: moe_apply(p, x, cfg.moe,
                                                  cfg.ffn_type),
                         runs=EP_RUNS, warmup=1)
    res = {"rel_l2": rel, "aux": float(aux), "aux_ref": float(aux_ref),
           "finite": bool(torch.isfinite(y).all()), "ms": ep_ms,
           "moe_apply_ms": ref_ms, "calls": calls,
           "staged_bytes_a_call": C.staged_bytes // (EP_RUNS + 2),
           "expert_bytes_held": held_bytes, "expert_bytes_whole": whole_bytes,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.path.join(out_dir, f"ep{world}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(torch, fn, world, args, out_dir):
    """``fn(rank, world, init, *args)`` on ``world`` spawned ranks; a rank
    that raises fails the phase (the others are ended)."""
    import torch.multiprocessing as mp

    init = "file://" + os.path.join(out_dir, f"rdzv_{fn.__name__}_{world}")
    t0 = time.perf_counter()
    mp.spawn(fn, args=(world, init) + tuple(args), nprocs=world, join=True)
    return time.perf_counter() - t0


def rescore_minus_one_check(torch, dev, q, db, sq, sched):
    """The rescore kernel on the candidate tables a rank sees in
    ``global`` mode: three quarters -1 (the rows other ranks own)."""
    from repro_torch.core import truncated as T
    from repro_torch.kernels import distance_topk, gather_rescore

    s0, st = sched.stages[0], sched.stages[1]
    _, cand = distance_topk.l2_topk(q, db, dim=s0.dim, k=s0.k,
                                    sq_at_dim=sq[:, 0].contiguous())
    rows = N_DOCS // DIST_RANKS
    mine = (cand >= rows) & (cand < 2 * rows)              # rank 1's rows
    local = torch.where(mine, cand - rows, torch.full_like(cand, -1))
    slab, sq_l = db[rows:2 * rows], sq[rows:2 * rows, 1].contiguous()
    got = gather_rescore.gather_rescore_topk(q, slab, local, dim=st.dim,
                                             k=st.k, sq_at_dim=sq_l)
    want = T.rescore_candidates(q, slab, local, dim=st.dim, k=st.k,
                                db_sq_at_dim=sq_l)
    err, agree, tol = compare(torch, got, want)
    n_slots = int((local >= 0).sum())
    if agree < 1.0 or err > tol:
        fail(f"rescore with -1 slots: agree={agree} err={err} (tol {tol})")
    row = {"phase": "distributed", "check": "rescore_minus_one",
           "Q": q.shape[0], "C": local.shape[1], "k": st.k, "dim": st.dim,
           "live_slots": n_slots, "minus_one_share":
           1.0 - n_slots / local.numel(), "max_abs_err": err,
           "ids_agree": agree}
    emit(row)


def nccl_world_of_one(torch, q, db, sq, sched, out_dir):
    """The same sharded calls as a one-rank NCCL world in this process (the
    whole corpus is its slab), the staged search on both paths too."""
    import datetime

    import torch.distributed as dist
    from repro_torch.core.distributed import build_sharded_search
    from repro_torch.launch.mesh import make_mesh_compat

    dims = tuple(s.dim for s in sched.stages)
    dist.init_process_group(
        ONE_RANK_BACKEND,
        init_method="file://" + os.path.join(out_dir, "rdzv_one"),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = make_mesh_compat((1,), ("data",), device_type=q.device.type)
        out = {}
        for mode in ("local", "global"):
            fn = build_sharded_search(mesh, sched, N_DOCS, has_prefix=True,
                                      index_dims=dims, mode=mode)
            s, i, ms, coll, counts, staged, calls = _search_calls(
                torch, fn, q, db, sq)
            out[mode] = (s, i, ms, coll, counts, staged, calls)
        out["staged"], out["staged_plain"] = staged_calls(
            torch, mesh, sched, db, sq, q)
    finally:
        dist.destroy_process_group()
    return out


def dist_search(torch, dev, seed, out_dir):
    """The sharded search part of phase 12; returns the launch counts of
    rank 0 by mode."""
    from repro_torch.core import make_schedule, progressive_search
    from repro_torch.core.index import prefix_squared_norms

    sched = make_schedule(D_START, D_EMB, K0, final_k=FINAL_K)
    dims = tuple(s.dim for s in sched.stages)
    t0 = time.perf_counter()
    db = dist_rows(torch, dev, seed, 0, N_DOCS)
    sq = prefix_squared_norms(db, dims)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 77)
    scales = dist_scales(torch, dev)
    src = torch.randperm(N_DOCS, generator=gen, device=dev)[:N_QUERIES]
    sig = 1.25 * torch.exp(0.55 * torch.randn((N_QUERIES,), generator=gen,
                                              device=dev))
    q = db[src] + sig[:, None] * scales * torch.randn(
        (N_QUERIES, D_EMB), generator=gen, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0

    # ground truth: exact full-dim L2 top-10 (chunked matmul)
    norms = (db * db).sum(1)
    truth = torch.cat([torch.topk(norms - 2.0 * q[a:a + 256] @ db.T, FINAL_K,
                                  dim=1, largest=False).indices
                       for a in range(0, N_QUERIES, 256)])
    del norms

    def single(qb):
        return progressive_search(qb, db, sched, sq_prefix=sq,
                                  index_dims=dims)

    single(q[:DIST_BATCH])
    torch.cuda.synchronize()
    ref_s, ref_i, ref_ms = [], [], []
    for a in range(0, N_QUERIES, DIST_BATCH):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        s, i = single(q[a:a + DIST_BATCH])
        ev1.record()
        ev1.synchronize()
        ref_ms.append(ev0.elapsed_time(ev1))
        ref_s.append(s)
        ref_i.append(i)
    ref_s, ref_i = torch.cat(ref_s), torch.cat(ref_i)

    rescore_minus_one_check(torch, dev, q[:DIST_BATCH], db, sq, sched)

    def recall(ids):
        ids = torch.as_tensor(ids, device=dev).long()
        hit = (ids[:, :, None] == truth[:, None, :]).any(dim=2)
        return (float(hit.float().mean()),
                float((ids[:, 0] == truth[:, 0]).float().mean()))

    def check(label, mode, s, i, ms, coll, counts, staged, calls, n_ranks):
        s_t = torch.as_tensor(s, device=dev)
        i_t = torch.as_tensor(i, device=dev)
        if s_t.shape != ref_s.shape or not bool(torch.isfinite(s_t).all()):
            fail(f"{label} {mode}: scores of shape {tuple(s_t.shape)} or "
                 f"not finite")
        if not torch.equal(i_t == -1, ref_i == -1):
            fail(f"{label} {mode}: sentinels differ from one process")
        err, agree, tol = compare(torch, (s_t, i_t), (ref_s, ref_i))
        differ = int((i_t != ref_i).sum())
        r10, top1 = recall(i)
        r10_1, top1_1 = recall(ref_i)
        n_calls = len(ms)
        row = {"phase": "distributed", "part": "search", "world": label,
               "ranks": n_ranks, "mode": mode, "queries": N_QUERIES,
               "batch": DIST_BATCH, "calls": n_calls,
               "ids_equal_share": float((i_t == ref_i).float().mean()),
               "ids_differ": differ,
               # global: every differing slot is a near-tie (checked below)
               "tied_slots": differ if mode == "global" else None,
               "agree_up_to_ties": agree, "max_abs_err": err, "tol": tol,
               "recall_at_10": r10, "top1": top1,
               "single_recall_at_10": r10_1, "single_top1": top1_1,
               "ms_p50": statistics.median(ms), "ms_mean": float(np.mean(ms)),
               "collective_host_ms_p50": 1e3 * statistics.median(
                   c for c, _ in coll),
               "staging_host_ms_p50": 1e3 * statistics.median(
                   st for _, st in coll),
               "collective_host_share": sum(c for c, _ in coll) / max(
                   1e-3 * float(np.sum(ms)), 1e-9),
               "single_ms_p50": statistics.median(ref_ms),
               "staged_bytes": staged, "staged_bytes_a_call":
               staged / n_calls, "collectives": calls,
               "launches": {k: counts[k] for k in (
                   "distance_topk.l2_topk", "distance_topk.wgmma",
                   "gather_rescore.ladder", "gather_rescore.step")}}
        emit(row)
        if mode == "global" and agree < 1.0:
            fail(f"{label} global: ids differ from one process beyond ties "
                 f"(agree {agree})")
        if mode == "local" and (r10 < r10_1 or top1 < top1_1):
            fail(f"{label} local: recall@10 {r10} / top-1 {top1} below one "
                 f"process's {r10_1} / {top1_1}")
        n_stages = len(sched.stages)
        want = ({"distance_topk.l2_topk": n_calls,
                 "gather_rescore.ladder": n_calls, "gather_rescore.step": 0}
                if mode == "local" else
                {"distance_topk.l2_topk": n_calls, "gather_rescore.ladder": 0,
                 "gather_rescore.step": n_calls * (n_stages - 1)})
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{label} {mode}: launches {got}, want {want}")
        return row

    # the 4-rank gloo world sharing the card
    spawn_s = _spawn(torch, dist_search_rank, DIST_RANKS,
                     (seed, q.cpu(), out_dir), out_dir)
    rows = {}
    for mode in ("local", "global"):
        z = np.load(os.path.join(out_dir, f"search_{mode}.npz"))
        per_rank = [json.load(open(os.path.join(
            out_dir, f"search_rank{r}.json")))[mode]
            for r in range(DIST_RANKS)]
        for r, pr in enumerate(per_rank):
            want = ({"distance_topk.l2_topk": len(pr["ms"]),
                     "gather_rescore.ladder": len(pr["ms"])}
                    if mode == "local" else
                    {"distance_topk.l2_topk": len(pr["ms"]),
                     "gather_rescore.step":
                     len(pr["ms"]) * (len(sched.stages) - 1)})
            got = {k: pr["counts"][k] for k in want}
            if got != want:
                fail(f"gloo rank {r} {mode}: launches {got}, want {want}")
        r0 = per_rank[0]
        rows[("gloo", mode)] = check(
            "gloo", mode, z["s"], z["i"], r0["ms"], r0["collective_s"],
            r0["counts"], r0["staged_bytes"], r0["calls"], DIST_RANKS)
        rows[("gloo", mode)]["rank_ms_p50"] = [
            statistics.median(pr["ms"]) for pr in per_rank]
    gloo_ids = {mode: np.load(os.path.join(out_dir, f"search_{mode}.npz"))["i"]
                for mode in ("local", "global")}

    def staged_check(label, got, plain, n_ranks, f32_ids, per_rank_counts):
        """The staged bf16 search: the kernel path against the plain path
        on the same slabs (ids up to near-ties, sentinels equal), top-1
        agreement with the float32 sharded search above 0.95 (the JAX
        package's own check of it), every stage-0 launch on a bf16
        route, one rescore step a later stage."""
        s, i, ms, coll, counts, staged_b, calls = got
        ps, pi = plain
        s_t = torch.as_tensor(s, device=dev)
        i_t = torch.as_tensor(i, device=dev)
        err, agree, tol = compare(torch, (s_t, i_t), (
            torch.as_tensor(ps, device=dev), torch.as_tensor(pi, device=dev)))
        if agree < 1.0 or err > tol or s_t.shape != ref_s.shape:
            fail(f"{label} staged: ids agree {agree} with the plain path, "
                 f"max|Δ| {err} (tol {tol})")
        top1_f32 = float((i[:, 0] == f32_ids[:, 0]).mean())
        if top1_f32 <= 0.95:
            fail(f"{label} staged: top-1 agrees with the float32 sharded "
                 f"search in {top1_f32} of the queries (want > 0.95)")
        n_calls = len(ms)
        want = {"distance_topk.l2_topk": n_calls,
                "distance_topk.wgmma_bf16": n_calls,
                "gather_rescore.step": n_calls * (len(sched.stages) - 1),
                "gather_rescore.ladder": 0}
        for r, c in enumerate(per_rank_counts):
            if {k: c[k] for k in want} != want:
                fail(f"{label} staged rank {r}: launches "
                     f"{ {k: c[k] for k in want} }, want {want}")
        r10, top1 = recall(i)
        row = {"phase": "distributed", "part": "staged_search",
               "world": label, "ranks": n_ranks, "queries": N_QUERIES,
               "batch": DIST_BATCH, "calls": n_calls,
               "block": f"bf16 (N, {sched.stages[0].dim})",
               "ids_agree_plain": agree, "max_abs_err": err, "tol": tol,
               "top1_agree_f32": top1_f32,
               "recall_at_10": r10, "top1": top1,
               "ms_p50": statistics.median(ms),
               "collective_host_ms_p50": 1e3 * statistics.median(
                   c for c, _ in coll),
               "staged_bytes_a_call": staged_b / n_calls,
               "collectives": calls, "launches": {k: counts[k] for k in (
                   "distance_topk.l2_topk", "distance_topk.wgmma_bf16",
                   "distance_topk.fma_bf16", "gather_rescore.step",
                   "gather_rescore.ladder")}}
        emit(row)
        return row

    z = np.load(os.path.join(out_dir, "search_staged.npz"))
    per_rank = [json.load(open(os.path.join(
        out_dir, f"search_rank{r}.json")))["staged"]
        for r in range(DIST_RANKS)]
    r0 = per_rank[0]
    staged_rows = {"gloo": staged_check(
        "gloo", (z["s"], z["i"], r0["ms"], r0["collective_s"], r0["counts"],
                 r0["staged_bytes"], r0["calls"]), (z["ps"], z["pi"]),
        DIST_RANKS, gloo_ids["local"], [pr["counts"] for pr in per_rank])}

    # the same calls as an NCCL world of one
    nccl = nccl_world_of_one(torch, q, db, sq, sched, out_dir)
    for mode in ("local", "global"):
        s, i, ms, coll, counts, staged, calls = nccl[mode]
        rows[("nccl", mode)] = check(ONE_RANK_BACKEND, mode, s, i, ms, coll,
                                     counts, staged, calls, 1)
        if staged:
            fail(f"nccl {mode}: {staged} bytes staged through the host")
    staged_rows["nccl"] = staged_check(
        ONE_RANK_BACKEND, nccl["staged"], nccl["staged_plain"], 1,
        nccl["local"][1], [nccl["staged"][4]])
    if not np.array_equal(nccl["local"][1], ref_i.cpu().numpy()):
        fail("nccl world of one, local: ids differ from one process")
    emit({"phase": "distributed", "part": "search_summary",
          "draw_s": draw_s, "gloo_world_s": spawn_s,
          "nccl_local_equals_single": True,
          "gloo_global_equals_nccl_global_share": float(
              (gloo_ids["global"] == nccl["global"][1]).mean())})
    del db, sq, q
    gc.collect()
    torch.cuda.empty_cache()
    return {**{mode: rows[("gloo", mode)]["launches"] for mode in
               ("local", "global")},
            **{f"staged_{w}": r["launches"] for w, r in staged_rows.items()}}


def dist_ep(torch, seed, out_dir):
    """The EP MoE part of phase 12."""
    out = {}
    for world in EP_RANKS:
        spawn_s = _spawn(torch, ep_rank, world, (seed, out_dir), out_dir)
        per = [json.load(open(os.path.join(out_dir,
                                           f"ep{world}_rank{r}.json")))
               for r in range(world)]
        for r, res in enumerate(per):
            if not res["finite"] or res["rel_l2"] > EP_TOL:
                fail(f"EP {world} rank {r}: rel L2 {res['rel_l2']} "
                     f"(tol {EP_TOL}), finite {res['finite']}")
            if abs(res["aux"] - res["aux_ref"]) > 1e-5 * abs(res["aux_ref"]):
                fail(f"EP {world} rank {r}: aux {res['aux']} vs "
                     f"{res['aux_ref']}")
            if res["expert_bytes_held"] * world != res["expert_bytes_whole"]:
                fail(f"EP {world} rank {r}: holds {res['expert_bytes_held']}"
                     f" expert bytes of {res['expert_bytes_whole']}")
        row = {"phase": "distributed", "part": "moe_ep", "ranks": world,
               "mesh": {"data": 1, "model": world}, "tokens": list(EP_TOKENS),
               "arch": LAUNCH_ARCH, "tol": EP_TOL,
               "rel_l2": [r["rel_l2"] for r in per],
               "aux": per[0]["aux"], "aux_moe_apply": per[0]["aux_ref"],
               "ms": [r["ms"] for r in per],
               "moe_apply_ms": [r["moe_apply_ms"] for r in per],
               "staged_bytes_a_call": per[0]["staged_bytes_a_call"],
               "collectives_a_call": per[0]["calls"],
               "expert_bytes_a_rank": [r["expert_bytes_held"] for r in per],
               "expert_bytes_whole": per[0]["expert_bytes_whole"],
               "peak_gb": [r["peak_gb"] for r in per], "world_s": spawn_s}
        emit(row)
        out[world] = row
    return out


def dist_launcher(out_dir):
    """The training launcher across 2 ranks sharing the card, then resumed
    on one; returns the two outputs' first lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    ck = os.path.join(out_dir, "ckpt")
    base = ["-m", "repro_torch.launch.train", "--arch", LAUNCH_ARCH,
            "--smoke", "--ckpt-dir", ck]
    runs = {}
    for label, pre, steps in (
            ("ranks2", ["-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node=2"], LAUNCH_STEPS),
            ("ranks1", [], LAUNCH_STEPS + 2)):
        t0 = time.perf_counter()
        cmd = [sys.executable] + pre + base + ["--steps", str(steps)]
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=HERE, timeout=CLI_TIMEOUT * 3)
        if r.returncode != 0:
            fail(f"launcher {label} exited {r.returncode}:\n{r.stdout[-3000:]}"
                 f"\n{r.stderr[-3000:]}")
        lines = r.stdout.strip().splitlines()
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
                  if ln.startswith("[train] step")]
        if not losses or not np.isfinite(losses).all():
            fail(f"launcher {label}: losses {losses}")
        runs[label] = {"first_line": lines[0], "losses": losses,
                       "s": time.perf_counter() - t0,
                       "restored": [ln for ln in lines if "restored" in ln]}
    if not runs["ranks2"]["first_line"].startswith(
            "[launch] process group: gloo, world 2"):
        fail(f"launcher 2 ranks: first line {runs['ranks2']['first_line']}")
    if runs["ranks1"]["restored"] != [
            f"[train] restored checkpoint at step {LAUNCH_STEPS}"]:
        fail(f"launcher 1 rank did not resume step {LAUNCH_STEPS}: "
             f"{runs['ranks1']}")
    emit({"phase": "distributed", "part": "launcher", "arch": LAUNCH_ARCH,
          **runs})
    return runs


def dryrun_cell_records(arch, shape, out_dir) -> dict:
    """The dry runs of one cell on both meshes (``repro_torch.launch.dryrun``,
    meta tensors, a fake process group of 256 or 512 ranks), each in a
    subprocess, both at once: a callable that waits for them and returns
    their JSON records by mesh."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    outdir = os.path.join(out_dir, "dryrun")
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", m, "--outdir", outdir, "--quiet"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=HERE) for m in ("single", "multi")}

    def wait() -> dict:
        out = {}
        for m, pr in procs.items():
            try:
                _, err = pr.communicate(timeout=CLI_TIMEOUT * 3)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p.kill()
                raise
            if pr.returncode != 0:
                fail(f"dry run of {arch} x {shape} x {m} exited "
                     f"{pr.returncode}:\n{err[-3000:]}")
            with open(os.path.join(outdir, f"{arch}__{shape}__{m}.json")) as f:
                out[m] = json.load(f)
        return out

    return wait


def profile_timeline(torch, fn, wall_ms, label, out_dir) -> None:
    """Trace one call of ``fn`` with ``torch.profiler`` and print where its
    time goes: each device launch in order with its device time and the
    device's idle gap before it, the device's busy and idle time over the
    call's span, the CUDA runtime calls (launches, copies, synchronisations)
    and the host ops with the most host time of their own.  A trace that
    lost kernel records (fewer kernels than kernel-launch calls, see
    `device_ms`; cuBLAS launches some kernels with no runtime launch call)
    is taken again, up to `TRACE_ATTEMPTS` times; the line says whether
    the one printed is whole."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(out_dir, f"{label}.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        evs = [e for e in (trace["traceEvents"] if isinstance(trace, dict)
                           else trace) if e.get("ph") == "X"]
        dev = sorted((e for e in evs if e.get("cat") in
                      ("kernel", "gpu_memcpy", "gpu_memset")),
                     key=lambda e: e["ts"])
        host = [e for e in evs if e.get("cat") == "cpu_op"]
        runtime = {}
        for e in evs:
            if e.get("cat") == "cuda_runtime":
                n, us = runtime.get(e["name"], (0, 0.0))
                runtime[e["name"]] = (n + 1, us + e["dur"])
        n_calls = sum(n for k, (n, _) in runtime.items()
                      if "LaunchKernel" in k)
        n_kernels = sum(e.get("cat") == "kernel" for e in dev)
        whole = bool(dev) and bool(host) and n_kernels >= n_calls
        if whole:
            break
    if not dev or not host:
        emit({"phase": "profile", "path": label, "wall_ms": wall_ms,
              "measured": False, "attempts": TRACE_ATTEMPTS,
              "device_events": len(dev), "host_events": len(host)})
        return
    start = min(e["ts"] for e in host)
    end = max(e["ts"] + e["dur"] for e in dev)
    launches, prev = [], start
    for e in dev:
        launches.append({"name": e["name"][:60], "us": e["dur"],
                         "gap_us": max(e["ts"] - prev, 0.0)})
        prev = max(prev, e["ts"] + e["dur"])
    busy_us = sum(e["dur"] for e in dev)
    host_top = sorted(
        ({"name": ev.key[:60], "count": ev.count,
          "self_host_ms": ev.self_cpu_time_total / 1e3}
         for ev in prof.key_averages()), key=lambda r: -r["self_host_ms"])
    emit({"phase": "profile", "path": label, "wall_ms": wall_ms,
          "trace_whole": whole, "attempts": attempt + 1,
          "kernel_launch_calls": n_calls, "kernels": n_kernels,
          "span_ms": (end - start) / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_ms": (end - start - busy_us) / 1e3,
          "device_busy_share": busy_us / (end - start),
          "n_launches": len(dev), "launches": launches,
          "cuda_runtime": {k: {"count": n, "ms": us / 1e3}
                           for k, (n, us) in runtime.items()},
          "host_top": host_top[:10]})


RETRIEVAL_CELL = ("two-tower-retrieval", "retrieval_cand")
RETRIEVAL_USERS = 8


def retrieval_cell_rank(rank, world, init, seed, out_dir):
    """The cell's rank, an NCCL world of one in a fresh process (a trace
    taken late in the script's own process loses its kernel records): the
    arguments at full width, one call on the kernels with the counters
    from 0, the same call on the plain versions, both timed, and one
    traced call (`profile_timeline`); its results to ``out_dir``."""
    torch, dist = _rank_setup(rank, world, init, backend=ONE_RANK_BACKEND)
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.inputs import two_tower_retrieval
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import recsys as R

    arch, shape = RETRIEVAL_CELL
    dev = torch.device(DIST_DEVICE)
    cfg = get_arch(arch).CONFIG
    c = get_arch(arch).SHAPES[shape].n_candidates
    base = torch.cuda.memory_allocated()
    params = R.recsys_init(cfg, seed=seed, device=dev)
    nf = params["item_tables"].shape[0]
    with torch.no_grad():
        db = torch.cat([R.tower_item(params, torch.arange(
            a, min(a + 250_000, c), dtype=torch.int32, device=dev)[
            :, None, None].expand(-1, nf, 1).contiguous())
            for a in range(0, c, 250_000)])
    d0 = cfg.retrieval_d_start
    db0 = db[:, :d0].to(torch.bfloat16)
    sqp = (db[:, :d0] ** 2).sum(1, keepdim=True)
    users = _batch(torch, dev, cfg, RETRIEVAL_USERS, seed + 31)["user_ids"]
    torch.cuda.synchronize()
    arg_bytes = tree_bytes((R.param_tree(params), users, db0, db, sqp))
    held_bytes = torch.cuda.memory_allocated() - base

    mesh = make_mesh_compat((1,), ("data",), device_type=dev.type)
    fn, sched = two_tower_retrieval(cfg, mesh, c)
    call = lambda: fn(params, users, db0, db, sqp)
    call()                                         # warm-up
    torch.cuda.synchronize()
    zero_counts()
    s, i = call()
    torch.cuda.synchronize()
    counts = read_counts()
    with plain_ops():
        ps, pi = call()
    torch.cuda.synchronize()
    err, agree, tol = compare(torch, (s, i), (ps, pi))
    ms = cuda_ms(torch, call, runs=10)
    with plain_ops():
        plain_ms = cuda_ms(torch, call, runs=3, warmup=1)
    profile_timeline(torch, call, ms, shape, out_dir)
    res = {"counts": counts, "n_steps": len(sched.stages) - 1,
           "schedule": sched.describe(), "block": f"bf16 ({c}, {d0})",
           "candidates": c, "shape": list(s.shape),
           "finite": bool(torch.isfinite(s).all()),
           "ids_negative": bool((i < 0).any()), "agree": agree,
           "err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "arg_bytes": arg_bytes, "held_bytes": held_bytes,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.path.join(out_dir, "retrieval_cand.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def retrieval_cell_run(torch, dev, seed, out_dir):
    """The two-tower ``retrieval_cand`` cell (``launch/inputs.py``) at its
    full width on the card (`retrieval_cell_rank`): 1,000,000 items (their
    DB built by the item tower), the staged index's (C, 64) bf16 block, 8
    users; the user tower (the embedding bag), the bf16 stage 0 and the
    rescore steps, held against the same function on the plain versions.
    Beside it the dry run's bytes of the cell, run meanwhile: its whole
    arguments must be the bytes of the real ones."""
    arch, shape = RETRIEVAL_CELL
    t0 = time.perf_counter()
    dry_wait = dryrun_cell_records(arch, shape, out_dir)
    cell_s = _spawn(torch, retrieval_cell_rank, 1, (seed, out_dir), out_dir)
    dry = dry_wait()
    dry_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "retrieval_cand.json")) as f:
        r = json.load(f)
    counts, n_steps = r["counts"], r["n_steps"]
    want = {"embedding_bag.embedding_bag": 1, "embedding_bag.vec16": 1,
            "distance_topk.l2_topk": 1, "distance_topk.wgmma_bf16": 1,
            "gather_rescore.gather_rescore_topk": n_steps,
            "gather_rescore.step": n_steps, "gather_rescore.ladder": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"retrieval_cand: launches {counts}, want {want}")
    if r["agree"] < 1.0 or r["err"] > r["tol"] \
            or r["shape"] != [RETRIEVAL_USERS, 1] or not r["finite"] \
            or r["ids_negative"]:
        fail(f"retrieval_cand: shape {r['shape']}, ids agree {r['agree']} "
             f"with the plain path, max|Δ| {r['err']} (tol {r['tol']})")
    whole = {m: sum(int(np.prod(x["shape"], dtype=np.int64)) * x["itemsize"]
                    for x in rec["leaves"]) for m, rec in dry.items()}
    if any(w != r["arg_bytes"] for w in whole.values()):
        fail(f"retrieval_cand: the dry run's arguments hold {whole} bytes, "
             f"the real ones {r['arg_bytes']}")
    emit({"phase": "distributed", "part": shape, "arch": arch,
          "candidates": r["candidates"], "users": RETRIEVAL_USERS,
          "schedule": r["schedule"], "block": r["block"],
          "ids_agree_plain": r["agree"], "max_abs_err": r["err"],
          "tol": r["tol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
          "launches": {k: counts[k] for k in want},
          "arg_bytes": r["arg_bytes"],
          "memory_allocated_bytes": r["held_bytes"], "peak_gb": r["peak_gb"],
          "cell_process_s": cell_s, "dryrun_s": dry_s,
          "dryrun": {m: {"arg_bytes_whole": whole[m],
                         "arg_bytes_rules_a_rank": rec["arg_bytes_rules"],
                         "arg_bytes_port_a_rank": rec["arg_bytes_port"],
                         "n_ranks": rec["n_ranks"], "flops": rec["flops"],
                         "roofline": rec["roofline"]}
                     for m, rec in dry.items()}})
    return {k: counts[k] for k in want}


def distributed_phase(torch, dev, seed):
    """Phase 12.  Returns the 4-rank search's launches of rank 0 by mode
    (and the staged search's, by world) and the retrieval cell's."""
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        launches = dist_search(torch, dev, seed, out_dir)
        launches["retrieval_cand"] = retrieval_cell_run(torch, dev, seed,
                                                        out_dir)
        ep = dist_ep(torch, seed, out_dir)
        dist_launcher(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "distributed", "part": "done",
          "seconds": time.perf_counter() - t0})
    return launches, ep


def finish(torch, card, stage_rows, large_rows, step_rows, ladder_rows,
           launches, paper_counts, dur_counts, scan_rows, flash_rows,
           bag_rows, seg_rows, families, train, dist_counts) -> None:
    """Print the kernels line, the card line and the final result line."""
    s32 = [r for r in stage_rows if r["case"] == "flat_stage0_q32"][0]
    tt = [r for r in stage_rows if r["case"] == "two_tower_stage0"][0]
    s_keys = ("served_by", "ms", "plain_ms", "matmul_topk_ms", "device_ms",
              "kernel_device_ms", "bound_ms", "bound_by", "bound_f32_ms",
              "bound_3xtf32_ms", "shape")
    kernels = [
        {"name": "distance_topk.l2_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cuh (built by "
                   "distance_topk.cu and distance_topk_bf16.cu)",
         "sources_by_kernel": {
             **{kind: "src/repro_torch/csrc/distance_topk.cuh"
                for kind in ("wgmma", "fma")},
             "wide": "src/repro_torch/csrc/distance_topk_wide.cu"},
         "replaces": "src/repro/kernels/distance_topk.py:128",
         "launches": launches["distance_topk.l2_topk"],
         "launches_by_kernel": {kind: launches[f"distance_topk.{kind}"]
                                for kind in ("wgmma", "wide", "fma",
                                             "wgmma_bf16",
                                             "fma_bf16")},
         "max_abs_err": max(r["max_abs_err"]
                            for r in stage_rows + large_rows),
         "library_ms": None, **{k: s32[k] for k in s_keys},
         "two_tower": {"launches": tt["launches"],
                       **{k: tt[k] for k in s_keys}},
         # the bf16 route (the staged index's stage 0) at the serving and
         # the two-tower shapes, and its launches on the staged search's
         # path and the retrieval_cand cell's (phase 12)
         "bf16": {"launches": {
             path: c["distance_topk.wgmma_bf16"] + c.get(
                 "distance_topk.fma_bf16", 0)
             for path, c in dist_counts.items()
             if path.startswith("staged") or path == "retrieval_cand"},
             **{r["case"]: {k: r[k] for k in s_keys + ("bound_bf16_ms",)}
                for r in stage_rows if r.get("dtype") == "bfloat16"}},
         "large_k": {r["case"]: {k: r[k] for k in s_keys}
                     for r in large_rows},
         "paper_launches": {kind: paper_counts[f"distance_topk.{kind}"]
                            for kind in ("l2_topk", "wgmma", "wide",
                                         "fma")}},
        _ladder_entry(launches, step_rows, ladder_rows),
        _scan_entry("ivf_scan.ivf_scan_topk", "src/repro_torch/csrc/ivf_scan.cu",
                    "src/repro/kernels/ivf_scan.py:275",
                    launches["ivf_scan.ivf_scan_topk"],
                    [scan_rows["ivf"], scan_rows["ivf_int8"]]),
        {**_scan_entry("pq_scan.pq_scan_topk",
                       "src/repro_torch/csrc/pq_scan.cu",
                       "src/repro/kernels/pq_scan.py:130",
                       launches["pq_scan.pq_scan_topk"],
                       [scan_rows["quantized_pq"]]),
         "launches_by_kernel": {kind: launches[f"pq_scan.{kind}"]
                                for kind in ("tile_8", "tile_4", "tile_2",
                                             "tile_1")},
         **{k: scan_rows["quantized_pq"][k]
            for k in ("tile", "bound_lookup_ms", "merge_device_ms")}},
        _scan_entry("pq_scan.pq_ivf_scan_topk",
                    "src/repro_torch/csrc/pq_scan.cu",
                    "src/repro/kernels/pq_scan.py:224",
                    launches["pq_scan.pq_ivf_scan_topk"],
                    [scan_rows["ivf_pq"]]),
        _flash_entry(launches, flash_rows, families),
        _bag_entry(launches, bag_rows),
        _seg_entry(launches, seg_rows),
        *train_entries(*train),
    ]
    kernels[1]["paper_launches"] = paper_counts["gather_rescore.ladder"]
    # phase 12: rank 0 of the 4-rank sharded search, by mode
    kernels[0]["distributed_launches"] = {
        mode: c["distance_topk.l2_topk"] for mode, c in dist_counts.items()}
    kernels[1]["distributed_launches"] = {
        mode: {kind: c[f"gather_rescore.{kind}"] for kind in ("ladder",
                                                              "step")}
        for mode, c in dist_counts.items()}
    # the recovered engine's and the follower's searches, and the recovered
    # engine's profile_stages (stage by stage: one rescore step a stage)
    for path, counts in dur_counts.items():
        kernels[0].setdefault("durability_launches", {})[path] = \
            counts["distance_topk.l2_topk"]
        kernels[1].setdefault("durability_launches", {})[path] = {
            kind: counts[f"gather_rescore.{kind}"] for kind in ("ladder",
                                                                "step")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated tensor (corpus, queries)")
    args = ap.parse_args()
    run(args)


if __name__ == "__main__":
    main()
