#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure ends the run with a nonzero exit code:

1. Card and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every CUDA kernel of the port
   (``src/repro_torch/**/csrc/*.cu``), with the compiler's register and
   spill report for each kernel instantiation.  Then the R-MAT graph (2^20
   vertices, 2^23 sampled edges) and the edge-balanced partition both
   counting kernels launch over: heavy rows, segments, light ranges, the
   kernels' scratch bytes, and the most edge visits (edges x column tiles)
   any warp makes on each u12 stage, counted on the host from the schedule
   both libraries export (checked as they load); more than 32,768 fails
   the run.
2. Colorings: the threefry draws of ``repro_torch.core.prng``
   (``randint(fold_in(...))``, ``split``) equal known-answer vectors of
   JAX's ``jax.random`` (written below; ``tests/test_torch_prng.py``
   recomputes them with JAX), and the same draws on the card equal those on
   the CPU, bit for bit, at the smoke graphs' sizes.  Then the committed
   ``tableIII/rmat2k/*/subgraph2vec`` counts reproduce to their 4 digits
   through the ``blocked`` engine, from ``benchmarks/bench_counting.py``'s
   seeded draws.
   The blocked SpMM kernel against its plain PyTorch version on the full
   graph, at 64 and 792 columns, and a second launch bitwise equal to the
   first; ``torch.sparse.mm`` on the same CSR is timed as a yardstick (the
   port never calls it).  Tree stages do not launch this kernel; bag
   extends do (phase 5b).
3. The fused SpMM+eMA kernel against its plain version on the full graph,
   at every stage geometry the main path gives it (u12 at 2 colorings),
   with the bitwise repeat; ``torch.sparse.mm`` on the passive state is
   timed beside it as the yardstick of its SpMM half.
4. The main path: ``CountingEngine(graph, [u12])`` with ``backend="auto"``
   (which must resolve to ``blocked``) counts one chunk of colorings drawn
   from ``split(prng_key(0), chunk)`` through ``count_keys``; the launch
   counters are reset just before
   and read just after, and every kernel of the path (the fused one) must
   have launched (``launches`` counts wrapper calls that launched,
   ``device_launches`` the kernels those calls issued).  The same colorings go through the plain ``edges``
   backend on the card, and the totals must agree.  Records the engine's
   build time (the partition's part of it too) and the kernels' scratch
   bytes.  The benchmark's ``rmat20-u12-batch`` cell times this path.
5. Exactness: on tiny grid and Erdos-Renyi graphs the ``blocked`` engine's
   raw counts equal the brute-force colorful counts: tree templates, every
   stage through the fused kernel, and the triangle, tailed triangle,
   4-cycle, diamond and K4, every bag extend with an eliminated neighbor
   through the blocked SpMM kernel.
5b. Motif counting of non-tree templates: on R-MAT with 8192 vertices
   (``benchmarks/bench_counting.py``'s rmat8k) two engines with
   ``backend="auto"`` (which must resolve to ``blocked``), the 3-vertex
   graphlets and four 4-vertex ones (two trees, the tailed triangle and the
   4-cycle), count the colorings of ``split(prng_key(0), 4)`` through
   ``count_keys``, with the launch counters reset just before and read just
   after (both kernels must launch, and the bag eMA once per bag update
   that the engine counts as ``bag_fused``, with none on its loop); totals
   per coloring within ``TOTALS_RTOL`` of an ``edges`` engine on the same
   keys whose bag updates all take the executor's loop (no bag eMA
   launch).  The benchmark's ``rmat8k-motifs-batch`` cell times this path.
   Then, at every bag width the engines launch the blocked SpMM kernel at
   (and at the widths of one coloring), the kernel against its plain
   version with its time, bound and ``torch.sparse.mm``'s time.  Then the
   bag eMA (``[bag_ema]``): g4-2, g4-3 and g3-1 each in a ``blocked``
   engine at a chunk of 10 colorings (the motif benchmark's), whose every
   bag extend and join hands its own operands to the kernel and to the
   executor's loop (``LocalBackend._bag_extend_loop`` /
   ``_bag_join_loop``): every output within ``BAG_EMA_RTOL`` of the
   loop's, a second launch bitwise equal, and the kernel's and the loop's
   times beside the update's bound (:func:`bag_update_bytes`: each output
   written once, each operand row read once where its masks are nonzero,
   the adjacency once).
5c. The counting service: one ``CountingService`` serves the same graph to
   two tenants, the 3-vertex graphlets with an (epsilon, delta) target and
   the four 4-vertex templates at 8 iterations, then repeats the second on
   the warm engine, which must build nothing new; every query's estimates
   equal ``CountingEngine.count_keys`` on its ``fold_in`` keys.
5d. Autotuning (``[tune]``): the port's tuner (``repro_torch.tune.tune``,
   ``top_n=4, probes=3``, the reference bench's settings, widened only as
   far as the best-ranked ``blocked`` candidate and the best-ranked
   ``mixed`` one that binds a group to ``blocked``) on the tableIII rmat2k
   and on rmat8k with ``u5-1``, into a temporary tuning cache that
   ``REPRO_TUNE_CACHE`` names for the whole script (so no earlier phase
   reads a tuned entry).  Prints every measured candidate, the lattice
   size, the winner, the heuristic's pick and the calibration ratios, then
   races the winner against the heuristic engine (7 interleaved timed
   launches each; the ratio is not gated).  Gates: a ``blocked`` candidate
   was measured and kernel A launched; an engine built afterwards with
   ``backend="auto"`` resolves with source ``tuned`` and its totals are
   within ``TOTALS_RTOL`` of ``edges`` on the same keys; an explicit
   ``mixed`` engine on rmat8k, binding alternate tree groups to ``blocked``
   and ``edges``, is within ``TOTALS_RTOL`` of ``edges`` and launches
   kernel A once per ``blocked``-bound stage per chunk.
5e. The asynchronous front-end (``[frontend]``), the counterpart of the
   reference's ``frontend_chaos32`` row: a started ``ServiceFrontend`` over
   a 48 GiB ``CountingService`` on rmat8k runs one ``fe.tune("rmat8k",
   "u5-1")`` task, then two tenant threads submit 16 queries each (16
   iterations, seeds 1000 k + i; tenant 0 ``u5-1``, tenant 1 the 3-vertex
   graphlets) under a seeded ``FaultPlan`` of 1-in-8 transient launch
   faults (installed after the tune: an injected fault in a tuner probe
   trips the scheduler by design).  Gates: no unresolved future, every
   query that did not fail has rows bit-equal to ``count_keys`` on its
   ``fold_in`` keys, ``tunes_run == 1`` and ``health()`` reports
   ``running``.  Prints p50/p99 latency, queries/s, faults injected,
   retries and failed queries.
6. The bf16 flash-attention kernel (tensor cores,
   ``flash_attention_sm90.cu``) against its plain version at granite-8b's
   head geometry (h=32, h_kv=8, d=128, bf16, causal) at (b, s) = (4, 4096),
   (1, 32768) and a ragged (2, 4000), with its achieved TFLOP/s;
   ``F.scaled_dot_product_attention`` is timed as a yardstick (the port
   never calls it).
7. The LM main path: granite-8b at full width and depth with
   ``attn_impl="flash"`` and seeded random weights, ``forward`` on b=4,
   s=4096 tokens.  In fp32 its logits must agree with the ``sdpa`` forward
   within 5e-5 of their largest magnitude, through the fp32 kernel alone
   (no tensor-core launch); then the config's bf16 forward, with the launch
   counters reset just before and read just after, must launch the
   tensor-core kernel once per layer and give finite logits.  Records
   tokens/s, peak memory and a ``torch.profiler`` split.
8. ``ServeEngine`` (fp32, 8 slots of 1024) answers 4 requests with 64-token
   prompts, token for token equal to offline greedy decoding through
   ``forward``, then 8 requests with prompts of 16-512 tokens, each of
   which must finish with its 16 tokens; 4 more run under
   ``torch.profiler``.
8b. MLA and fine-grained MoE (``[mla_moe]``), once granite-8b's weights
   are freed: deepseek-v2-lite-16b at full width and depth (27 layers,
   15.71 B parameters, 62.8 GB of seeded fp32 weights).  Gates: its first
   MoE layer's ``moe_apply`` in fp32 on 384 tokens at the published
   capacity (some pairs must drop) within ``MOE_RTOL`` of the plain
   per-expert loop (``repro_torch.testing.moe``) under the same routing;
   a 64-token prefill on 2 rows and one absorbed ``decode_step`` within
   ``rtol=2e-2, atol=2e-4`` of ``forward`` on the 65 tokens (fp32, no
   drops); then the bf16 forward at b=4, s=4096 and capacity factor 1.25,
   finite.  Records ms, tokens/s, peak memory and a ``torch.profiler``
   split (products, MoE dispatch, attention: n_layers times one layer's
   ``_sdpa_chunked`` profiled alone, and the rest).
8c. ``ServeEngine`` over the same weights (``[serve_mla]``), fp32 at
   ``capacity_factor = n_experts``, as phase 8: prefill on the
   decompressed path, decode on the absorbed one over the latent cache.
8d. DBRX (``[dbrx]``): kernel C against its plain version at DBRX's heads
   (b=4, s=4096, h=48, h_kv=8, d=128, bf16, causal) beside
   ``F.scaled_dot_product_attention``; then dbrx-132b at full width cut to
   2 of its 40 layers (7.75 B parameters, 31.0 GB fp32), ``forward`` with
   ``attn_impl="flash"`` as phase 7: the fp32 flash-vs-sdpa logits gate
   with no tensor-core launch, then the bf16 forward at b=4, s=4096 with
   exactly 2 tensor-core launches.
8e. Expert parallelism (``[moe_ep]``): one full-width DBRX MoE layer in
   bf16 on 2048 tokens at the published capacity (some pairs must drop),
   in one NCCL rank spawned by ``run_ranks``: ``moe_apply(...,
   group=WORLD)`` on the rank's share of the experts must equal the dense
   ``moe_apply`` bitwise.  The exchange between ranks is held by the CPU
   tests (2 and 4 gloo ranks); a card takes one NCCL rank.
8f. Training (``[train]``), once the MoE weights are freed; TF32 off, as
   in every phase.  The fp32 gates at granite-8b's full width cut to 2
   layers, on one ``token_batches`` batch of b=1 x s=512: ``loss_fn`` and
   every gradient leaf on the card against the same step on the CPU (the
   port's plain path; max |dg| / max |g| <= 1e-4 per leaf, the loss within
   1e-5), remat on against off (bitwise), ``loss_chunk=128`` against the
   whole loss (1e-5 relative), and ``attn_impl="flash"``: the forward
   launches kernel C once per layer, the backward raises
   ``NotImplementedError``.  The restart gate: ``TrainLoop`` over
   ``make_lm_job`` on granite-8b's ``SMOKE_CONFIG`` on the card, 20 steps
   with a checkpoint every 5, straight and with a fault at step 13 and a
   resume from step 10, equal bit for bit.  Then the run: granite-8b at
   full width cut to 12 of 36 layers (3.02 B parameters; parameters,
   gradients and AdamW moments 48.3 GB in fp32), bf16 compute, remat,
   ``attn_impl="sdpa"``, b=2 x s=4096 from ``token_batches(seed=0)``
   through ``make_lm_job`` and ``TrainLoop``: 2 warm-up steps and 6 timed
   (CUDA events), ms per step, tokens/s, the model-FLOP share (6 N T over
   989 TFLOP/s), peak memory, the loss per step, one step profiled and
   split (bf16 products, the fp32 attention core, the loss head, the
   optimizer, casts and copies, the rest), then 3 steps on one repeated
   batch, whose loss must fall; every loss finite, no flash launch.
8g. The GNN family, trained (``[gnn]``): no kernel of the port runs here,
   as no Pallas kernel runs on the reference's GNN path; every sum is
   ``torch.segment_reduce`` over rows sorted once per batch, and every
   gather's backward such a sum, so steps repeat bit for bit.  Gates: GCN
   and GAT ``CONFIG`` on ``synthetic_cora`` and NequIP (5 x 32) and MACE
   (2 x 128, correlation 3) ``CONFIG`` on the molecule cell (128 graphs of
   30 atoms, 16,384 edges), each on the card against the CPU from the same
   parameters (outputs within 1e-5 of their max, the loss within 1e-6
   relative, every gradient leaf within 1e-4 of its max |g|); NequIP's and
   MACE's energies under a proper rotation within 1e-4 of max(|E|, 1);
   NequIP's forward with ``edge_chunk=4096`` within 1e-5 of the unchunked;
   the sampler's draws from ``prng_key(0)`` on the card equal the CPU's;
   a MACE step (molecule) and a GCN step (ogb_products) repeated from one
   state are equal bit for bit.  Runs, each ``gnn_train_step`` (AdamW,
   global-norm clipping) with 1 warm-up and 4 timed steps (CUDA events),
   the peak memory and a profiler split (gathers, segment reductions,
   products, sorts, elementwise, the optimizer profiled alone): NequIP and
   MACE at molecule (graphs/s); GCN at ``GNN_SHAPES`` ogb_products (2.45 M
   nodes, 61.86 M edges, d_feat 100; edges/s); GAT there if its step fits
   the card, else its forward there (time and peak); the sampler at
   minibatch_lg (a 232,965-node, 114.6 M-entry CSR built on the card with
   ``torch.sort``; 1,024 seeds, fanouts 15 and 10; ms per sample and per
   ``node_flow_to_batch``), then a GCN and a GAT step on the sampled
   flow; finally ``python -m repro_torch.launch.train --arch gcn-cora
   --steps 20`` with no ``--device``.  The four kernel wrappers' counters
   must not move during the phase.
8h. The two-tower recommender, trained and served (``[recsys]``): no
   kernel of the port runs here, as no Pallas kernel runs on the
   reference's recsys path; the EmbeddingBag is ``F.embedding`` and a sum
   over the bag.  TF32 off.  Vocabularies are cut in the config
   (``max(int(v * s), 8)`` rows per field, so the click stream draws inside
   the tables); widths, fields, bag, towers, temperature and the
   ``RECSYS_SHAPES`` batches are the published ones.  Gates at vocab 1e-4,
   b=512: both towers within 1e-5 of their max, ``serve_scores`` within
   1e-5, the loss within 1e-6 relative and every gradient leaf within 1e-4
   of its max, card against CPU from the same parameters; top-100 over a
   1,000,000-candidate corpus (built by the card's item tower) card
   against CPU, values within 1e-5 and the same ids but for near ties; a
   bag with an index past its table NaN on the card as on the CPU (and a
   negative one wrapped); one ``make_recsys_job`` step at vocab 1e-3,
   b=4,096, repeated from one state, equal bit for bit.  Cells:
   ``train_batch`` (b=65,536, vocab 0.02: ``make_recsys_job`` steps, ms per
   step, examples/s, peak memory, the model-FLOP share of 67 TFLOP/s, a
   profiler split with the loss head and the optimizer profiled alone);
   ``serve_p99`` (b=512, vocab 0.25: p50/p99 per request), ``serve_bulk``
   (b=262,144 in one call) and ``retrieval_cand`` (the 1 M-row corpus
   built in chunks, then p50/p99 per query of ``retrieval_scores`` and
   ``retrieval_topk``), each beside its bound.  The four kernel wrappers'
   counters must not move during the phase.
8i. The launch tooling (``[launch]``): no kernel of the port runs here,
   as none runs on the reference's dry-run cells (prefill and decode take
   a cache, which takes ``_sdpa_chunked``; training has no flash
   backward).  First the dry run's analysis of every cell of
   ``all_cells(include_subgraph=True)`` on both production meshes, on
   ``meta`` tensors in a CPU subprocess started with the script (its
   records read here: one line per cell with its bottleneck, per-device GB
   and ``fits_80GB``; any cell that fails fails the phase).  Then, in one
   NCCL rank spawned by ``run_ranks``: granite-8b's ``train_4k`` cell's
   own step at mesh (1, 1), at 1 and 2 layers and the per-device batch of
   the single-pod mesh (16 x 4096; cut by halves only where the dry run
   predicts more than ``LAUNCH_FIT_BYTES``, each cut printed), bitwise
   equal to ``make_lm_job``'s single-device step (``loss_chunk=512``) on
   the same seed and batch, bitwise on repeat, its ``FlopCounterMode``
   count equal to the ``meta`` count; ms per step and peak memory at each
   depth, their affine fit to 36 layers, predicted over measured bytes,
   the step over the roofline's terms.  ``prefill_32k``'s step at 2
   layers and the per-device batch (2 x 32768, bf16): its last-position
   logits and caches bitwise equal to ``prefill``'s.  The ``vectorized``
   eMA mode against ``loop`` through ``make_distributed_count_fn`` on u12
   at R-MAT 2^17 (the widest stage's gathered operands 14.5 GB), within
   1e-5.  The four kernel wrappers' counters must not move.
9. Kernel A's wide path at full width (``[wide]``), once the LM weights
   and every earlier engine are freed: u18 on R-MAT with 2^17 vertices and
   u20 on 2^15 (8 sampled edges per vertex, as the main cell), the largest
   sizes whose one-coloring DP state fits the 48 GiB budget.  Each stage
   whose row does not fit the shared-memory path is launched twice at one
   coloring (bitwise equal), held against a plain version (the SpMM half
   with ``index_add_``, the eMA by blocks of outputs), and timed beside its
   bound and ``torch.sparse.mm`` on its SpMM half; its row names its route
   (streamed), its no-reuse gather floor (``e * C_p * 4`` bytes at 3.35
   TB/s) and the launch's scratch bytes.  The time is a third launch's,
   whose output reuses the repeat's freed block; the repeat's own time,
   with its output newly allocated, and the allocator's retries in it are
   recorded beside it.  Then one
   ``count_keys_chunk`` through the ``blocked`` engine, whose picker must
   choose a chunk of 1, launches kernel A once per stage, and
   ``compiled_memory_analysis`` must stay within the budget; u20's chunk
   is timed, split into the wide stages' launches (CUDA events) and the
   rest (the benchmark's ``rmat17-u18-wide`` cell times u18's).  The totals,
   past fp32's range at this size, must be finite: the engine's range
   shift (recorded beside them) holds them.  They are held against the
   plain ``edges`` engine within ``TOTALS_RTOL`` at :data:`WIDE_GATE_N`
   (the ``blocked`` totals at twice that n are recorded beside them).
10. The memory model on the card (``[memory]``): ``compiled_memory_analysis``
   of phase 4's u12 engine, phase 5b's 4-vertex motif engine and the u18 and
   u20 engines, written as ``memory_model`` rows into a temporary file that
   ``REPRO_FUSION_SLACK_BENCH`` names for the whole run (no earlier phase
   finds rows there), then the fusion slack ``load_fusion_slack`` derives
   from them and the chunk each engine would pick at that slack.
11. The mesh backend (``[mesh]``): one rank per card over NCCL
   (``torch.cuda.device_count()`` ranks, spawned through
   ``repro_torch.testing.ranks.run_ranks``; one on a one-card machine),
   each building ``CountingEngine(graph, [u12], mesh=<the group>)`` on phase
   4's graph at the 48 GiB budget: streamed eMA, the cost model's column
   batch and the shard model's chunk, priced without the ``[memory]`` rows
   (those were measured on ``blocked`` engines).  One chunk of
   ``split(prng_key(0), chunk)`` goes through ``count_keys`` twice (the
   repeat must be bitwise equal, and every rank must hold the same totals),
   then ``compiled_memory_analysis`` measures one chunk per shard.  Gate:
   totals within ``TOTALS_RTOL`` of a ``blocked`` engine on the same keys.
   Prints ``describe()["comm"]``, the per-shard predicted over measured
   bytes, and seconds per coloring beside ``blocked``'s.  No kernel of the
   port runs on this path: the reference's mesh path reaches no Pallas
   kernel, and its collectives and PyTorch tensor ops take their place.
   Several ranks need several cards: NCCL takes one rank per card, and gloo
   aborts on CUDA tensors in the card's torch build
   (``scripts/torch_mesh_probe.py``), so on one card the ring between ranks
   is held only by the CPU tests (``tests/test_torch_mesh.py``).

The second-to-last line of output is the ``kernels`` JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the repository beside this file, the script prints no result and exits
nonzero.  Times come from CUDA events, device splits and idle shares from
``portbench.trace``; ``bound_ms`` is the larger of the compulsory bytes
over 3.35 TB/s and the operations over the H100 SXM's published peak for
their type (``portbench.roofline``, which also counts kernels A's and B's
work): 67 TFLOP/s fp32 for the counting kernels, 989 TFLOP/s dense bf16
for attention.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM published peak (NVIDIA data sheet) of the bf16 tensor cores,
#: dense; the HBM and fp32 peaks are ``portbench.roofline``'s.
PEAK_BF16_FLOPS = 989e12

GRAPH_SPEC = dict(n=1 << 20, num_edges=8_388_608, seed=1)
TEMPLATE = "u12"
MEMORY_BUDGET_BYTES = 48 * 2**30
#: Motif counting: the reference's rmat8k graph and two template sets.
MOTIF_GRAPH_SPEC = dict(n=8192, num_edges=80_000, seed=2)
MOTIF_SETS = (("graphlets3", ("g3-0", "g3-1")), ("graphlets4", ("g4-0", "g4-1", "g4-2", "g4-3")))
MOTIF_KEYS = 4  # colorings of split(prng_key(0), MOTIF_KEYS)
#: Exact counts on tiny graphs: trees, and the non-trees through bag stages.
EXACT_BAG_TEMPLATES = ("triangle", "g4-2", "square", "diamond", "clique4")
SPMM_WIDTHS = (64, 792)
EMA_CHUNK = 2  # colorings per chunk at this budget (checked in phase 4)
#: Kernels that the tree counting path launches (the motif path checks its
#: own launches of both counting kernels).
COUNTING_PATH_KERNELS = ("spmm_ema",)
EXACT_TEMPLATES = ("u3", "u5-2", "u6", "u7")

#: ``jax.random.randint(fold_in(PRNGKey(seed), data), (n,), 0, k)`` under
#: JAX 0.9.0's defaults (threefry2x32, partitionable), keyed by (seed, data,
#: n, k); ``tests/test_torch_prng.py`` recomputes them with JAX.
KNOWN_COLORINGS = {
    (0, 0, 16, 3): (1, 2, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 2, 0),
    (42, 7, 25, 12): (9, 0, 6, 7, 10, 2, 3, 7, 10, 7, 7, 0, 7, 1, 3, 2, 0, 1, 9, 5, 1, 7, 5,
                      5, 5),
    (2**31 + 5, 1, 9, 5): (1, 4, 3, 2, 4, 0, 1, 4, 1),
    (7, 123456, 33, 4): (2, 0, 3, 3, 1, 3, 0, 1, 2, 1, 1, 2, 0, 2, 3, 3, 2, 0, 1, 2, 2, 0, 0,
                         0, 1, 1, 0, 2, 2, 3, 2, 0, 0),
}
#: ``jax.random.split(PRNGKey(seed), num)``, keyed by (seed, num).
KNOWN_SPLITS = {
    (0, 4): ((1797259609, 2579123966), (928981903, 3453687069), (4146024105, 2718843009),
             (2467461003, 3840466878)),
    (17, 2): ((1410583977, 344060510), (677216225, 3396477011)),
}
#: The committed ``tableIII/rmat2k/<t>/subgraph2vec`` raw colorful totals
#: (BENCH_counting.json, 4 digits), from ``benchmarks/bench_counting.py``'s
#: draws: ``default_rng(0).integers(0, k, size=n)`` per template, in order.
TABLE_III_GRAPH_SPEC = dict(n=2048, num_edges=20_000, seed=1)
TABLE_III_COUNTS = {"u5-1": 7.065e08, "u5-2": 1.535e09, "u6": 5.603e10, "u7": 4.652e12}

#: Kernel vs plain version: relative tolerance.  The plain versions sum
#: with ``index_add_``, whose CUDA atomics add in no fixed order, and the
#: kernels contract multiply-adds into FMAs.
KERNEL_RTOL = 1e-4
#: The bag eMA vs the executor's loop on the same operands: every output.
#: Both sum the terms in table order from zero; the loop's ``addcmul_`` need
#: not contract into an FMA as the kernel's does.
BAG_EMA_RTOL = 1e-6
#: Templates and chunk of the bag eMA check (the motif benchmark's chunk),
#: and the budget their engines are built at (the chunk is given).
BAG_EMA_CASES = (("g4-2", 10), ("g4-3", 10), ("g3-1", 10))
BAG_EMA_BUDGET = 72 * 2**30
#: Engine totals, ``blocked`` vs the plain ``edges`` path (same reasons).
TOTALS_RTOL = 1e-4
#: Most edge visits (edges x passive tiles) any warp may make on a stage of
#: TEMPLATE on the smoke graph.
VISIT_CAP = 32_768

#: Phase 5d: the reference bench's tuner settings (``bench_tuning.py``), the
#: template, and the interleaved timed launches of the winner-vs-heuristic race.
TUNE_TEMPLATE = "u5-1"
TUNE_TOP_N = 4
TUNE_PROBES = 3
TUNE_RACE_LAUNCHES = 7
TUNE_CHECK_KEYS = 8

#: Phase 5e: the reference's ``frontend_chaos32`` load on rmat8k.
FRONTEND_QUERIES_PER_TENANT = 16
FRONTEND_ITERATIONS = 16
FRONTEND_FAULT_RATE = 1 / 8
FRONTEND_FAULT_SEED = 0

#: Phase 9 ([wide]): kernel A's wide path at full width, u18 and u20 on
#: R-MAT at the main cell's density (8 sampled edges per vertex, seed 1), at
#: the largest n whose one-coloring DP state (79,611 and 354,066 columns)
#: fits the 48 GiB budget.  Their totals pass fp32's range there (the
#: engine's bound on them: 2^164.9 and 2^166.9), and the engine's range
#: shift (5 per template vertex for both) keeps them finite.  The totals are
#: held against the plain ``edges`` engine at the largest power of two where
#: the unshifted walk stayed finite (u18 at n = 4096 reaches 1.23e37 and u20
#: at 2048 1.04e38; H100 80GB HBM3 at 700 W): the ``edges`` engine takes 4
#: and 15 s there, under the 60 s it may take.
WIDE_CELLS = (("u18", 1 << 17), ("u20", 1 << 15))
#: The wide cells whose one chunk is timed here: the benchmark's
#: ``rmat17-u18-wide`` cell times u18's.
WIDE_TIMED = ("u20",)
WIDE_EDGES_PER_VERTEX = 8
WIDE_SEED = 1
WIDE_GATE_N = {"u18": 1 << 12, "u20": 1 << 11}
#: Most bytes one streamed slice of the gate's ``edges`` engine may gather
#: (``(|E| + n) * column_batch`` floats): its column batch is the widest
#: power of two under this, since at the default 16 columns u20's
#: streamed tables alone would not fit the card.
WIDE_GATE_GATHER_BYTES = 16 * 2**30
#: Outputs per block of the wide stages' plain check (bounds its scratch).
WIDE_PLAIN_BLOCK = 2048
#: A wide stage row's host-side figures (the no-reuse gather floor, the
#: launch's scratch, the plan's shape) and the first repeat's time with
#: its allocator retries: logged and in ``--out``, not in the kernels
#: line, which holds the kernel's own time.
WIDE_HOST_KEYS = ("gather_floor_ms", "scratch_bytes", "plan", "repeat_ms", "repeat_alloc_retries")

#: LM path: (b, s) of the flash checks, of the forward, and the serving run.
FLASH_SHAPES = ((4, 4096), (1, 32768), (2, 4000))
LM_BATCH, LM_SEQ = 4, 4096
SERVE_SLOTS, SERVE_LEN, SERVE_NEW = 8, 1024, 16
#: Flash kernel vs plain version, both outputs in bf16 of values computed
#: in fp32 by both: one bf16 rounding is at most 2^-7 of |want|, and the
#: absolute term only covers fp32 summation-order error near zero.  It must
#: stay well below a typical output (~0.009 on a 32k-key causal row), or a
#: dropped key tile or a shifted causal boundary on long rows would pass.
FLASH_RTOL = 1e-2
FLASH_ATOL = 1e-4
#: fp32 forward, flash vs sdpa: max |diff| over max |logits| (measured
#: 3.5e-6 on the H100, so the gate leaves a margin of about 14x).
LOGITS_RTOL = 5e-5

# [mesh]: the whole spawned group's wall-clock limit, and each collective's
MESH_TIMEOUT_S = 600.0

#: [mla_moe]: the MoE gate's tokens (b, s) of one full-width layer, at the
#: published capacity, against the plain per-expert loop in fp32: relative
#: max-abs, the logits gate's bar (both sum the same fp32 products, in other
#: orders and batchings).
MOE_GATE_TOKENS = (2, 192)
MOE_RTOL = LOGITS_RTOL
#: [mla_moe]: prefill of MLA_PROMPT tokens on MLA_ROWS rows, then one
#: absorbed decode step, against the 65-token forward at the reference's
#: decode-vs-forward bar (tests/test_arch_smoke.py).
MLA_ROWS, MLA_PROMPT = 2, 64
MLA_RTOL, MLA_ATOL = 2e-2, 2e-4
#: [dbrx]: layers kept of DBRX's 40 (526 GB of fp32 weights at 40).
DBRX_LAYERS = 2
#: [moe_ep]: tokens (b, s) of the full-width DBRX MoE layer and the seed of
#: its weights and tokens.
EP_TOKENS = (4, 512)
EP_SEED = 4
EP_TIMEOUT_S = 600.0
#: [train] fp32 gates (granite-8b at full width, TRAIN_GATE_LAYERS layers,
#: one batch of TRAIN_GATE_TOKENS): card vs CPU, each gradient leaf's max
#: |diff| over its max |g| (the two sum fp32 in other orders; TF32 is off),
#: the loss relative; the chunked loss against the whole one, the loss and
#: each leaf relative.
TRAIN_GATE_LAYERS = 2
TRAIN_GATE_TOKENS = (1, 512)
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_CHUNK = 128
#: [train] the restart gate on granite-8b's SMOKE_CONFIG: (batch, seq) and
#: the loop's steps, checkpoint interval and injected fault.
TRAIN_RESTART_TOKENS = (8, 128)
TRAIN_RESTART_STEPS, TRAIN_RESTART_EVERY, TRAIN_RESTART_FAULT = 20, 5, 13
#: [train] the bf16 run: granite-8b at full width cut to TRAIN_LAYERS of 36
#: layers (48.3 GB of fp32 parameters, gradients and AdamW moments; all 36
#: take 132.1 GB), b x s tokens per step, warm-up, timed and repeated-batch
#: steps, the launcher's constant learning rate.
TRAIN_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_REPEAT = 2, 6, 3
TRAIN_LR = 3e-4
#: [gnn] (the GNN family, trained): card vs CPU with the same parameters,
#: logits and energies max |diff| over max |out|, the loss relative, each
#: gradient leaf's max |diff| over its max |g| (the two sum fp32 in other
#: orders; TF32 is off); the energies under a proper rotation of the
#: positions, |dE| over max(|E|, 1) per graph (the reference's own test
#: bar is 1e-3).
GNN_OUT_RTOL = 1e-5
GNN_LOSS_RTOL = 1e-6
GNN_GRAD_RTOL = 1e-4
GNN_EQUIV_RTOL = 1e-4
#: [gnn] the cells, from GNN_SHAPES: ogb_products (GCN and GAT trained on
#: the full graph), minibatch_lg (the sampler over a 114.6 M-edge CSR on the
#: card, then a GCN and a GAT step on the sampled flow, d_feat 128 as the
#: reference's minibatch cell), molecule (NequIP and MACE on 128 graphs of
#: 30 atoms and 128 directed edges each, d_feat 16).
GNN_FULL_GRAPH = (2_449_029, 61_859_140, 100)
GNN_MINIBATCH_GRAPH = (232_965, 114_615_892, 128)
GNN_SEEDS, GNN_FANOUTS = 1024, (15, 10)
GNN_MOLECULE = (30, 128, 16, 128)  # atoms, edges per graph, d_feat, graphs
#: [gnn] NequIP's chunked forward: edges per chunk (divides the molecule
#: batch's 16,384 edges), held against the unchunked forward.
GNN_EDGE_CHUNK = 4096
#: [gnn] warm-up and timed steps per run (CUDA events), the sampler's timed
#: draws, the launcher's constant learning rate.
GNN_WARMUP, GNN_TIMED = 1, 4
GNN_SAMPLE_REPS = 5
GNN_LR = 3e-4
#: [recsys] gates (the published widths, vocabulary cut to
#: RECSYS_GATE_VOCAB, b=RECSYS_GATE_BATCH): card vs CPU, towers, serving
#: scores and retrieval values max |diff| over max |ref|, the loss relative,
#: each gradient leaf's max |diff| over its max |g| (TF32 is off).
RECSYS_OUT_RTOL = 1e-5
RECSYS_LOSS_RTOL = 1e-6
RECSYS_GRAD_RTOL = 1e-4
RECSYS_GATE_VOCAB, RECSYS_GATE_BATCH = 1e-4, 512
RECSYS_GATE_QUERIES = 4
#: [recsys] the bitwise repeat of one make_recsys_job step
RECSYS_REPEAT_VOCAB, RECSYS_REPEAT_BATCH = 1e-3, 4096
#: [recsys] the cells' vocabulary cuts: training holds its tables' dense
#: gradients, AdamW's moments and three (b, b) fp32 logits at b=65,536
#: (17.2 GB each); serving holds only the tables (44.4 GB at 0.25).
RECSYS_TRAIN_VOCAB = 0.02
RECSYS_SERVE_VOCAB = 0.25
#: [recsys] warm-up and timed train steps, warm-up and timed serving
#: requests and retrieval queries, timed bulk calls, corpus chunk rows,
#: top-k, the job's learning rate.
RECSYS_TRAIN_WARMUP, RECSYS_TRAIN_TIMED = 2, 6
RECSYS_WARMUP, RECSYS_REQUESTS = 10, 200
RECSYS_BULK_REPS = 3
RECSYS_CORPUS_CHUNK = 65536
RECSYS_TOPK = 100
RECSYS_LR = 3e-4
#: [launch]: granite-8b's train_4k cell at mesh (1, 1), at the per-device
#: batch of the single-pod mesh (256 sequences over 16 data ranks) and two
#: depths; a batch is cut by halves only while the dry run predicts more
#: than LAUNCH_FIT_BYTES on the card
LAUNCH_TRAIN_BATCH, LAUNCH_SEQ = 16, 4096
LAUNCH_DEPTHS = (1, 2)
LAUNCH_FULL_DEPTH = 36
LAUNCH_FIT_BYTES = 76e9
LAUNCH_TIMED = 3
#: [launch]: prefill_32k's per-device batch (32 sequences over 16 data
#: ranks) at 2 layers
LAUNCH_PREFILL_BATCH, LAUNCH_PREFILL_SEQ, LAUNCH_PREFILL_LAYERS = 2, 32768, 2
#: [launch]: the vectorized eMA on u12 at R-MAT 2^LAUNCH_VEC_LOG_N (8 edges
#: per vertex): its widest stage gathers two (n, 1, 924, 15) fp32 operands,
#: n x 13,860 x 2 x 4 bytes (14.5 GB at 2^17)
LAUNCH_VEC_LOG_N = 17
LAUNCH_VEC_RTOL = 1e-5
LAUNCH_TIMEOUT_S = 900.0
LAUNCH_SWEEP_TIMEOUT_S = 1200.0
#: the sweep's niceness: the counting phases before [launch] are partly
#: host-bound, and the sweep needs only to finish before [launch]
LAUNCH_SWEEP_NICE = 10


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want, rtol: float, what: str, atol=None) -> float:
    """Max |got - want|; raises unless every |got - want| <= atol + rtol |want|
    (``atol`` defaults to 1e-6 of the largest |want|)."""
    import torch

    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    atol = 1e-6 * scale if atol is None else atol
    ok = bool(torch.all(err <= rtol * want.abs() + atol))
    worst = float(err.max()) if err.numel() else 0.0
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max |err| {worst:g}, max |ref| {scale:g})")
    return worst


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``spmm_ema_kernel<4, 1, 32>`` from its mangled name (the last name of
    the nested name, and its integer template arguments)."""
    import re

    i, names = 3 if mangled.startswith("_ZN") else 2, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    targs = "<" + ", ".join(re.findall(r"Li(\d+)E", args[1])) + ">" if args else ""
    return names[-1] + targs if names else mangled


def build_kernels() -> None:
    """Build every source; per source, one line with its kernel instances'
    register range, and a line for each instance that spills or whose
    ``wgmma``s ptxas serialised (C7515)."""
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    log(f"[build] {len(per_source)} sources compiled in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items()) or 'cached'})")
    for source in _build.KERNEL_SOURCES:
        function, regs = "?", {}
        for line in _build.build_log(source).splitlines():
            if "Function properties for" in line:
                function = kernel_name(line.split()[-1])
            elif "Used" in line and "registers" in line:
                regs[function] = int(re.search(r"Used (\d+) registers", line)[1])
            elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill stores"):
                log(f"[build] {source.stem} {function}: {line.strip()}")
            elif "C7515" in line:   # ptxas serialised the wgmmas of a kernel
                log(f"[build] {source.stem} {kernel_name(line.split()[-1].strip(chr(39)))}: "
                    f"{line.split(':', 1)[-1].split(' in the function')[0].strip()}")
        if regs:
            lo, hi = min(regs.values()), max(regs.values())
            log(f"[build] {source.stem}: {len(regs)} kernel instances, {lo}-{hi} registers "
                f"({max(regs, key=regs.get)} the most)")
        _build.load(source)


def load_balance(graph, operand, geometries, bsz, widths) -> dict:
    """The partition the kernels launch over (``operand.partition``): heavy
    rows, segments, light ranges, and per fused stage and SpMM width the
    most edge visits (edges walked serially x column tiles walked for) any
    warp makes, counted on the host from the partition and the schedule
    that both libraries export (checked first).  Beside them, figures worked
    out here, not measured: the kernels' scratch bytes, the no-reuse gather
    floor of each stage's SpMM half (``|E| * B * C_p * 4`` bytes at
    ``portbench.roofline.PEAK_BYTES_PER_S``), the visits of a split by rows
    (one warp per row, rows ``w, w + 8, ...`` of a 64-row block, every
    64-column passive tile in turn), and the sizes of the compact operand and of the
    reference's padded one.  Raises if a fused stage exceeds
    :data:`VISIT_CAP`."""
    import numpy as np

    from portbench.roofline import PEAK_BYTES_PER_S
    from repro_torch.core.colorsets import binom
    from repro_torch.kernels.spmm_blocked import ops as blocked_ops
    from repro_torch.kernels.spmm_ema import ops as ema_ops

    for lib in (blocked_ops._library(), ema_ops._library()):
        blocked_ops.check_schedule(lib)
    part = operand.partition
    e = operand.num_directed
    deg = graph.degrees().astype(np.int64)
    rows, warps = 64, 8
    pad = (-graph.n) % rows
    per_row = np.concatenate([deg, np.zeros(pad, np.int64)]).reshape(-1, rows)
    row_split_warp = int(per_row.reshape(per_row.shape[0], rows // warps, warps).sum(axis=1).max())
    # the reference's blocked-ELL operand at its block of 256: every
    # (dst-block, src-block) pair padded to the largest (three 4-byte arrays)
    n_blocks = -(-graph.n // 256)
    pair = (graph.dst // 256).astype(np.int64) * n_blocks + graph.src // 256
    pair_sizes = np.unique(pair, return_counts=True)[1]
    stages = []
    for k, m, m_a in geometries:
        c_p, c_a = binom(k, m - m_a), binom(k, m_a)
        if not ema_ops.row_fits(c_p, c_a):
            raise AssertionError(f"{TEMPLATE} stage {(k, m, m_a)} takes the wide path, which "
                                 f"the visit count does not model")
        rows_pass = ema_ops.kernel_geometry(c_p, c_a, blocked_ops.RANGE_ROWS)
        v = blocked_ops.edge_visits(operand, c_p, rows_pass)
        stages.append({"stage": [k, m, m_a], "c_p": c_p, "rows_per_pass": rows_pass,
                       "max_warp_visits": v["max"], "light_warp_visits": v["light_warp"],
                       "heavy_warp_visits": v["heavy_warp"],
                       "row_split_warp_visits": row_split_warp * -(-c_p // 64),
                       "scratch_bytes": ema_ops.scratch_bytes(operand, bsz, c_p),
                       "gather_floor_ms": e * bsz * c_p * 4 / PEAK_BYTES_PER_S * 1e3})
    spmm = [{"cols": c, "max_warp_visits": blocked_ops.slab_visits(operand, c)["max"],
             "scratch_bytes": part.n_segments * c * 4} for c in widths]
    out = {
        "blocked_ell_256_pairs": int(pair_sizes.size),
        "blocked_ell_256_max_pair": int(pair_sizes.max()),
        "blocked_ell_256_padded_bytes": int(pair_sizes.size * pair_sizes.max() * 12),
        "compact_operand_bytes": int((graph.num_directed + graph.n + 1) * 4),
        "heavy_degree": blocked_ops.HEAVY_DEGREE, "segment_edges": blocked_ops.SEGMENT_EDGES,
        "range_rows": blocked_ops.RANGE_ROWS, "range_edges": blocked_ops.RANGE_EDGES,
        "heavy_rows": part.n_heavy,
        "heavy_edges": int(deg[deg > blocked_ops.HEAVY_DEGREE].sum()),
        "segments": part.n_segments,
        "light_ranges": part.n_ranges,
        "partition_build_s": part.build_seconds,
        "partition_bytes": int(sum(t.numel() * 4 for t in (
            part.range_ptr, part.heavy_rows, part.heavy_slot, part.seg_ptr, part.seg_beg,
            part.seg_end))),
        "row_split_max_warp_edges": row_split_warp,
        "fused_stages": stages,
        "gather_floor_ms": sum(st["gather_floor_ms"] for st in stages),
        "spmm_widths": spmm,
    }
    worst = max(st["max_warp_visits"] for st in stages)
    if worst > VISIT_CAP:
        raise AssertionError(f"a warp makes {worst} edge visits on a {TEMPLATE} stage "
                             f"(cap {VISIT_CAP})")
    return out


# ---------------------------------------------------------------------------
# phase 2: colorings, the tableIII counts, kernel B
# ---------------------------------------------------------------------------


def check_known_colorings(device) -> dict:
    """The port's threefry draws against JAX's known answers, then, on a
    device other than the CPU, the same draws there against the CPU's, bit
    for bit, at the sizes of the smoke graphs."""
    import torch

    from repro_torch.core.prng import fold_in, prng_key, randint, split

    for (seed, data, n, k), want in KNOWN_COLORINGS.items():
        got = randint(fold_in(prng_key(seed, device), data), (n,), 0, k).cpu().tolist()
        if got != list(want):
            raise AssertionError(f"randint(fold_in(prng_key({seed}), {data}), ({n},), 0, {k}) "
                                 f"= {got}, JAX draws {list(want)}")
    for (seed, num), want in KNOWN_SPLITS.items():
        got = split(prng_key(seed, device), num).cpu().tolist()
        if got != [list(w) for w in want]:
            raise AssertionError(f"split(prng_key({seed}), {num}) = {got}, JAX draws {want}")
    cpu = torch.device("cpu")
    compared = 0
    for n in (MOTIF_GRAPH_SPEC["n"], GRAPH_SPEC["n"]) if device.type != "cpu" else ():
        for k in (3, 4, 12):
            keys = split(prng_key(k, cpu), MOTIF_KEYS)
            want = randint(keys, (n,), 0, k)
            got = randint(keys.to(device), (n,), 0, k).cpu()
            folded = fold_in(keys.to(device), torch.arange(MOTIF_KEYS, device=device)).cpu()
            if not (torch.equal(got, want)
                    and torch.equal(folded, fold_in(keys, torch.arange(MOTIF_KEYS)))):
                raise AssertionError(f"draws on {device} differ from the CPU's at n={n} k={k}")
            compared += got.numel()
    out = {"known_colorings": len(KNOWN_COLORINGS), "known_splits": len(KNOWN_SPLITS),
           "device": str(device), "values_equal_to_cpu": compared}
    log(f"[colorings] {json.dumps(out)}")
    return out


def table_iii_counts(device) -> dict:
    """The rmat2k raw colorful totals of ``benchmarks/bench_counting.py``'s
    tableIII rows through the ``blocked`` engine; each must print as the
    committed 4 digits."""
    import numpy as np

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import rmat_graph
    from repro_torch.core.templates import get_template

    graph = rmat_graph(**TABLE_III_GRAPH_SPEC)
    rng = np.random.default_rng(0)
    out = {}
    for tname, want in TABLE_III_COUNTS.items():
        t = get_template(tname)
        colors = rng.integers(0, t.k, size=graph.n)
        got = float(CountingEngine(graph, [t], backend="blocked", device=device).raw_counts(colors)[0])
        if f"{got:.3e}" != f"{want:.3e}":
            raise AssertionError(f"tableIII/rmat2k/{tname}: count {got:.3e}, committed {want:.3e}")
        out[tname] = got
    log(f"[tableIII] rmat2k counts equal the committed ones to 4 digits: {json.dumps(out)}")
    return out


def check_spmm_blocked(operand, widths, device, reps=5) -> tuple:
    """Kernel B against its plain version at each width, with the launches
    that walked more than one column slab (``sliced_launches``); returns
    the rows and, per shape, what the host model gives (the grid's CTAs,
    slabs, the heaviest warp's edge visits and the launch's bound in them:
    not measured, so it stays out of the rows)."""
    import torch

    from portbench.roofline import bound_s, product_work
    from repro_torch.kernels.spmm_blocked.ops import (check_int32_counts, slab_visits,
                                                       spmm_blocked)
    from repro_torch.kernels.spmm_blocked.ref import spmm_ref

    n, e = operand.n, operand.num_directed
    gen = torch.Generator(device=device).manual_seed(0)
    csr = None
    if device.type == "cuda":
        csr = torch.sparse_csr_tensor(
            operand.row_ptr.long(), operand.src.long(),
            torch.ones(e, dtype=torch.float32, device=device), size=(n, n),
        )
    rows, grids = [], {}
    for c in widths:
        m = torch.rand((n, c), generator=gen, device=device)
        sliced = spmm_blocked.sliced_launches
        got = spmm_blocked(operand, m)
        sliced = spmm_blocked.sliced_launches - sliced
        bitwise = bool(torch.equal(got, spmm_blocked(operand, m)))
        if not bitwise:
            raise AssertionError(f"spmm_blocked C={c}: two launches differ")
        want = spmm_ref(operand.src, operand.dst, n, m, col_chunk=64)
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_blocked C={c}")
        del got, want
        row = {"shape": f"n={n} C={c}", "cols": c, "max_abs_err": err,
               "bitwise_repeatable": bitwise, "sliced_launches": sliced}
        counts, visits = check_int32_counts(operand, c), slab_visits(operand, c)
        grids[row["shape"]] = {
            "grid_ctas": counts["grid x (heavy blocks + light ranges)"] * counts["grid y (slabs)"],
            "slabs": visits["slabs"], "max_warp_visits": visits["max"],
            "bound_warp_visits": visits["bound"]}
        bound, row["bound_by"] = bound_s(*product_work(c, n, e))
        row["bound_ms"] = bound * 1e3
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: spmm_blocked(operand, m), reps)
            row["plain_ms"] = time_ms(
                lambda: spmm_ref(operand.src, operand.dst, n, m, col_chunk=64), 2)
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, m), reps)
        log(f"[spmm_blocked] {json.dumps(row)} model={json.dumps(grids[row['shape']])}")
        rows.append(row)
        del m
    return rows, grids


# ---------------------------------------------------------------------------
# phase 3: kernel A
# ---------------------------------------------------------------------------


def fused_geometries(template_name: str):
    """Distinct ``(k, m, m_a)`` stages of the template, in DP order: the
    blocked backend sends every one of them to the fused kernel."""
    from repro_torch.core.templates import get_template
    from repro_torch.plan.ir import build_template_plan

    plan = build_template_plan([get_template(template_name)])
    seen = []
    for cplan in plan.counting_plans:
        for table in cplan.tables:
            if table is None:
                continue
            key = (table.k, table.m, table.m_a)
            if key not in seen:
                seen.append(key)
    return seen


def check_spmm_ema(operand, geometries, bsz, device, reps=3) -> list:
    """Per stage: kernel vs plain version, two launches bitwise equal, and
    the times of the kernel, the plain version and ``torch.sparse.mm`` on the
    ``(n, B * C_p)`` passive state (``library_spmm_half_ms``: only the SpMM
    half of the function; the port never calls it)."""
    import torch

    from portbench.roofline import bound_s, fused_stage_work
    from portbench.shapes import TreeStage
    from repro_torch.core.colorsets import binom, build_split_table
    from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, spmm_ema
    from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref

    n, e = operand.n, operand.num_directed
    gen = torch.Generator(device=device).manual_seed(1)
    csr = None
    if device.type == "cuda":
        csr = torch.sparse_csr_tensor(
            operand.row_ptr.long(), operand.src.long(),
            torch.ones(e, dtype=torch.float32, device=device), size=(n, n),
        )
    rows = []
    for k, m, m_a in geometries:
        table = build_split_table(k, m, m_a)
        c_p, c_a = binom(k, m - m_a), binom(k, m_a)
        tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, device)
        m_p = torch.rand((n, bsz, c_p), generator=gen, device=device)
        m_aa = torch.rand((n, bsz, c_a), generator=gen, device=device)

        def plain():
            return spmm_ema_ref(operand.src, operand.dst, n, m_p, m_aa,
                                tables.idx_a, tables.idx_p, col_chunk=64)

        got = spmm_ema(operand, m_p, m_aa, tables)
        bitwise = bool(torch.equal(got, spmm_ema(operand, m_p, m_aa, tables)))
        if not bitwise:
            raise AssertionError(f"spmm_ema (k,m,m_a)={(k, m, m_a)}: two launches differ")
        want = plain()
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_ema (k,m,m_a)={(k, m, m_a)}")
        del got, want
        row = {"shape": f"k={k} m={m} m_a={m_a} B={bsz} C_p={c_p} C_a={c_a} "
                        f"n_out={table.n_out} splits={table.n_splits}",
               "max_abs_err": err, "bitwise_repeatable": bitwise}
        bound, row["bound_by"] = bound_s(*fused_stage_work(TreeStage(k, m, m_a), n, e, bsz))
        row["bound_ms"] = bound * 1e3
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: spmm_ema(operand, m_p, m_aa, tables), reps)
            row["plain_ms"] = time_ms(plain, 1)
            flat = m_p.reshape(n, bsz * c_p)
            row["library_spmm_half_ms"] = time_ms(lambda: torch.sparse.mm(csr, flat), reps)
        log(f"[spmm_ema] {json.dumps(row)}")
        rows.append(row)
        del m_p, m_aa
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def device_profile(fn, classify=None) -> dict:
    """Device time by kernel over one call of ``fn``, and the device's idle
    share of the call's window, read by ``portbench.trace.summarize``: the
    window is a ``portbench.trace.WINDOW_SPAN`` around the call and a
    synchronise, busy time the union of the device's kernels, copies and
    sets in it.  With ``classify`` (kernel name -> kind), also the device
    time per kind."""
    import torch
    from torch.profiler import record_function

    from portbench import trace

    torch.cuda.synchronize()
    with trace.profiler() as prof:
        with record_function(trace.WINDOW_SPAN):
            fn()
            torch.cuda.synchronize()
    summary = trace.summarize(prof)
    calls = {}
    for ev in summary.device_events:
        calls[ev.name] = calls.get(ev.name, 0) + 1
    out = {
        "wall_ms": summary.window_s * 1e3,
        "device_busy_ms": summary.busy_s * 1e3,
        "device_idle_share": 1.0 - summary.busy_s / summary.window_s,
        "top": [{"name": name[:60], "ms": sec * 1e3, "calls": calls[name]}
                for name, sec in summary.top_ops(6)],
    }
    if classify is not None:
        split = {}
        for name, sec in summary.seconds_by_name.items():
            kind = classify(name)
            split[kind] = split.get(kind, 0.0) + sec * 1e3
        out["split_ms"] = split
    return out


def kernel_family(name: str) -> str:
    """A device kernel's name without its return type, anonymous namespaces,
    template arguments and parameters: as :func:`device_profile`'s
    ``classify``, the device time of each kernel over all its instances."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def main_path(graph, template_name, device, budget) -> dict:
    import numpy as np

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import scratch_bytes, spmm_ema

    template = get_template(template_name)
    kwargs = {} if device.type == "cuda" else {"device": device}
    t0 = time.perf_counter()
    engine = CountingEngine(graph, [template], memory_budget_bytes=budget, **kwargs)
    build_s = time.perf_counter() - t0
    if engine.backend != "blocked":
        raise AssertionError(f"backend='auto' resolved to {engine.backend!r}, not 'blocked'")
    keys = split(prng_key(0, device), engine.chunk_size)
    reset_counting_launches()
    est = engine.count_keys(keys)
    launches = counting_launches()
    device_launches = {"spmm_ema": spmm_ema.device_launches,
                       "spmm_blocked": spmm_blocked.device_launches}
    raw = est / engine._norm_factors.cpu().numpy()[None, :]
    if not np.all(np.isfinite(est)) or np.any(est < 0):
        raise AssertionError(f"{template_name}: totals not finite and >= 0: {est.tolist()}")

    plain = CountingEngine(graph, [template], backend="edges",
                           memory_budget_bytes=budget, **kwargs)
    est_plain = plain.count_keys(keys)
    if not np.allclose(est, est_plain, rtol=TOTALS_RTOL, atol=0.0):
        raise AssertionError(f"blocked {est.tolist()} vs edges {est_plain.tolist()} "
                             f"beyond rtol={TOTALS_RTOL}")
    for name in COUNTING_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    out = {
        "template": template_name,
        "backend": engine.backend,
        "backend_reason": engine.backend_reason,
        "chunk_size": engine.chunk_size,
        "colorings": int(keys.shape[0]),
        "engine_build_s": build_s,
        "partition_build_s": engine.backend_impl.operand.partition.build_seconds,
        "kernel_scratch_bytes": max(
            scratch_bytes(engine.backend_impl.operand, engine.chunk_size, t.c_p)
            for t in engine.backend_impl._fused_tables.values()),
        "launches": launches,
        "device_launches": device_launches,
        "estimates": est[:, 0].tolist(),
        "raw_totals": raw[:, 0].tolist(),
        "max_rel_diff_vs_edges": float(np.max(np.abs(est - est_plain) / np.abs(est_plain))),
    }
    log(f"[main] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 5: exactness on tiny graphs
# ---------------------------------------------------------------------------


def exactness(device) -> None:
    import numpy as np

    from repro_torch.core.counting import brute_force_colorful, build_counting_plan
    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import erdos_renyi_graph, grid_graph
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import spmm_ema

    rng = np.random.default_rng(7)
    for gname, graph in (("grid5x7", grid_graph(5, 7)), ("er45", erdos_renyi_graph(45, 90, seed=3))):
        for tname in EXACT_TEMPLATES + EXACT_BAG_TEMPLATES:
            t = graphlet(tname)
            plan = build_counting_plan(t)
            # tree stages go through the fused kernel, bag extends through
            # the blocked SpMM kernel
            kernel = spmm_ema if plan.partition is not None else spmm_blocked
            engine = CountingEngine(graph, [t], backend="blocked", device=device)
            for _ in range(2):
                colors = rng.integers(0, t.k, size=graph.n)
                before = kernel.launches
                raw = float(engine.raw_counts(colors)[0]) / plan.automorphisms
                if kernel.launches <= before:
                    raise AssertionError(f"{gname}/{tname}: {kernel.__name__} was not launched")
                want = brute_force_colorful(graph, t, colors)
                if raw != want:
                    raise AssertionError(f"{gname}/{tname}: blocked {raw} != brute force {want}")
    log(f"[exact] blocked raw counts equal brute force on grid5x7 and er45: trees through "
        f"the fused kernel ({', '.join(EXACT_TEMPLATES)}), non-trees through the blocked "
        f"SpMM kernel ({', '.join(EXACT_BAG_TEMPLATES)})")


def reset_counting_launches() -> None:
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import bag_ema, spmm_ema

    spmm_ema.launches = spmm_blocked.launches = bag_ema.launches = 0
    spmm_ema.device_launches = spmm_blocked.device_launches = 0


def counting_launches() -> dict:
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import bag_ema, spmm_ema

    return {"spmm_ema": spmm_ema.launches, "spmm_blocked": spmm_blocked.launches,
            "bag_ema": bag_ema.launches}


@contextlib.contextmanager
def bag_updates_on_the_loop():
    """Every bag update inside the block takes the executor's per-term loop
    (the bag eMA's refusal gives a reason), so an engine run there launches
    no bag eMA: a plain side independent of the kernel."""
    from repro_torch.kernels.spmm_ema import ops

    refusal = ops.bag_ema_refusal
    ops.bag_ema_refusal = lambda *args, **kw: "held to the loop"
    try:
        yield
    finally:
        ops.bag_ema_refusal = refusal


# ---------------------------------------------------------------------------
# phase 5b: motif counting of non-tree templates (bag stages)
# ---------------------------------------------------------------------------


def bag_widths_of(record) -> list:
    """The bag widths of a motif record's engine at one coloring."""
    return [c // record["colorings_per_chunk"] for c in record["bag_widths"]]


def graphlet(name):
    from repro_torch.core.templates import connected_graphlets, get_template

    by_name = {t.name: t for k in (3, 4) for t in connected_graphlets(k)}
    return by_name[name] if name in by_name else get_template(name)


def bag_widths(engine, bsz) -> list:
    """Columns of each blocked-SpMM launch of one chunk of ``bsz``
    colorings: per distinct bag extend with an eliminated neighbor (states
    are shared by canon), ``n**(r_in - 1) * bsz * C(k, m_in)``."""
    from repro_torch.core.colorsets import binom

    n, seen, widths = engine.graph.n, set(), []
    for cplan, canons in zip(engine.plan_ir.counting_plans, engine.plan_ir.canons):
        if cplan.partition is not None:
            continue
        ops = cplan.bag_program.ops
        for i, op in enumerate(ops):
            if canons[i] in seen:
                continue
            seen.add(canons[i])
            if op.kind == "extend" and op.spmm_vertex is not None:
                src = ops[op.inputs[0]]
                widths.append(n ** (len(src.axes) - 1) * bsz * binom(cplan.k, src.m))
    return widths


def motif_kernel_kind(name: str) -> str:
    low = name.lower()
    if "bag_ema" in low:
        return "bag eMA (bag_ema)"
    if "spmm_blocked" in low:
        return "kernel B (spmm_blocked)"
    if "spmm_ema" in low or "heavy_segments" in low:
        return "kernel A (spmm_ema)"
    if "heavy_reduce" in low:
        return "heavy-row reductions (A and B)"
    if "copy" in low:
        return "copies"
    if "index" in low or "gather" in low:
        return "gathers (index_select)"
    if "reduce" in low:
        return "sums (forget)"
    return "other elementwise (masks, addcmul, threefry)"


def motif_path(graph, device, budget) -> dict:
    """Both motif engines through ``count_keys``, each held against the
    ``edges`` engine on the same keys."""
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import spmm_ema

    keys = split(prng_key(0, device), MOTIF_KEYS)
    records = []
    launches_total = {"spmm_ema": 0, "spmm_blocked": 0, "bag_ema": 0}
    device_launches_total = {"spmm_ema": 0, "spmm_blocked": 0}
    for set_name, tnames in MOTIF_SETS:
        templates = [graphlet(t) for t in tnames]
        t0 = time.perf_counter()
        engine = CountingEngine(graph, templates, memory_budget_bytes=budget)
        build_s = time.perf_counter() - t0
        if engine.backend != "blocked":
            raise AssertionError(f"{set_name}: backend='auto' resolved to {engine.backend!r}")
        bsz = min(engine.chunk_size, MOTIF_KEYS)
        n_chunks = -(-MOTIF_KEYS // bsz)
        bag_before = dict(engine.counters)
        reset_counting_launches()
        est = engine.count_keys(keys)
        launches = counting_launches()
        bag_ops = {k: engine.counters[k] - bag_before[k] for k in ("bag_fused", "bag_loop")}
        device_launches = {"spmm_ema": spmm_ema.device_launches,
                           "spmm_blocked": spmm_blocked.device_launches}
        widths = bag_widths(engine, bsz)
        if launches["spmm_blocked"] != len(widths) * n_chunks or launches["spmm_ema"] <= 0:
            raise AssertionError(f"{set_name}: launches {launches}, expected "
                                 f"{len(widths) * n_chunks} of spmm_blocked and some spmm_ema")
        # every fp32 bag update on the card is one bag eMA launch
        if launches["bag_ema"] != bag_ops["bag_fused"] or bag_ops["bag_loop"]:
            raise AssertionError(f"{set_name}: {launches['bag_ema']} bag eMA launches for "
                                 f"bag updates {bag_ops}")
        for name in launches:
            launches_total[name] += launches[name]
        for name in device_launches:
            device_launches_total[name] += device_launches[name]
        plain = CountingEngine(graph, templates, backend="edges", chunk_size=1, device=device)
        before = counting_launches()["bag_ema"]
        with bag_updates_on_the_loop():
            est_plain = plain.count_keys(keys)
        if counting_launches()["bag_ema"] != before or plain.counters["bag_fused"]:
            raise AssertionError(f"{set_name}: the plain engine launched the bag eMA")
        if not (np.all(np.isfinite(est)) and np.all(est >= 0)):
            raise AssertionError(f"{set_name}: estimates not finite and >= 0: {est.tolist()}")
        if not np.allclose(est, est_plain, rtol=TOTALS_RTOL, atol=0.0):
            raise AssertionError(f"{set_name}: blocked {est.tolist()} vs edges "
                                 f"{est_plain.tolist()} beyond rtol={TOTALS_RTOL}")
        nz = est_plain != 0
        rec = {
            "set": set_name, "templates": [t.name for t in engine.templates],
            "backend": engine.backend, "backend_reason": engine.backend_reason,
            "chunk_size": engine.chunk_size, "colorings_per_chunk": bsz, "chunks": n_chunks,
            "engine_build_s": build_s,
            "bag_widths": widths,
            "launches": launches,
            "device_launches": device_launches,
            "bag_ops": bag_ops,
            "plain_bag_ops": {"fused": plain.counters["bag_fused"],
                              "loop": plain.counters["bag_loop"]},
            "dense_adjacency_bytes": graph.n * graph.n * 4,
            "estimates": est.tolist(),
            "max_rel_diff_vs_edges": float(np.max(np.abs(est - est_plain)[nz] / est_plain[nz]))
            if nz.any() else 0.0,
        }
        log(f"[motif] {json.dumps(rec)}")
        records.append(rec)
        del engine, plain
        torch.cuda.empty_cache()
    return {"engines": records, "launches": launches_total,
            "device_launches": device_launches_total}


def viewed_bytes(t) -> int:
    """Bytes of the distinct elements a view reads (broadcast axes once)."""
    count = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            count *= size
    return count * t.element_size()


def bag_update_bytes(a, p, mask_axes, adj, n_out) -> dict:
    """The bag eMA's compulsory traffic on these operands, by part: the
    output once (``out``), each operand's rows at the vertex tuples whose
    masks are nonzero, at most its distinct elements (``a``, ``p``), the
    adjacency once where masked (``adj``); beside them, those tuples
    (``live_tuples``) and all of them (``tuples``)."""
    import torch

    r, n = p.dim() - 2, p.shape[0]
    tuples = live = n ** r
    if mask_axes:
        mask = torch.ones((1,) * r, device=p.device)
        for x in mask_axes:
            mask = mask * adj.reshape((n,) + (1,) * (x - 1) + (n,) + (1,) * (r - 1 - x))
        live = int(torch.count_nonzero(mask.expand((n,) * r)))
    row = p.shape[-2] * 4
    return {"out": tuples * row * n_out,
            "a": min(viewed_bytes(a), live * row * a.shape[-1]),
            "p": min(viewed_bytes(p), live * row * p.shape[-1]),
            "adj": n * n * 4 if mask_axes else 0,
            "live_tuples": live, "tuples": tuples}


def compare_rows(host, want, rtol: float, what: str) -> tuple:
    """``host`` (a copy in host memory) against ``want`` on the card, a few
    hundred MB of rows at a time: the largest |difference| (raising past
    ``rtol`` relative, with no absolute slack) and whether all bits agree."""
    import torch

    rows = max(1, (256 << 20) // max(1, want[:1].numel() * 4))
    worst, equal = 0.0, True
    for i in range(0, want.shape[0], rows):
        got = host[i:i + rows].to(want.device)
        worst = max(worst, max_abs_err(got, want[i:i + rows], rtol, what, atol=0.0))
        equal = equal and bool(torch.equal(got, want[i:i + rows]))
    return worst, equal


def check_bag_op(be, what, a, p, tables, mask_axes, host, reps) -> dict:
    """One bag update: the bag eMA's output (``host``, copied off the card)
    against a second launch and against the executor's loop on the same
    operands, with both times and the update's bound."""
    import torch

    from portbench.roofline import bound_s
    from repro_torch.exec.local import LocalBackend
    from repro_torch.kernels.spmm_ema.ops import bag_ema

    adj = be._bag_adj if mask_axes else None
    again = bag_ema(a, p, tables.ent, mask_axes, adj)
    _, bitwise = compare_rows(host, again, 0.0, f"{what} repeat")
    if not bitwise:
        raise AssertionError(f"{what}: two bag eMA launches differ")
    del again
    ms = time_ms(lambda: bag_ema(a, p, tables.ent, mask_axes, adj), reps)
    torch.cuda.empty_cache()  # the loop's blocks differ in size from the kernel's
    if tables.kind == "extend":
        # the new vertex's leaf, which ``a`` broadcasts over the other axes;
        # an SpMM'd state is kernel B's own output, which the loop masks in
        # place (0/1 masks: a repeat gives the same bits)
        leaf = a[(slice(None),) + (0,) * (a.dim() - 3)]
        owned = p.stride(0) != 0

        def loop():
            return LocalBackend._bag_extend_loop(p, owned, leaf, tables, list(mask_axes),
                                                 be._bag_adj, torch.float32)
    else:
        def loop():
            return LocalBackend._bag_join_loop(a, p, tables, torch.float32)
    want = loop()
    err, equal = compare_rows(host, want, BAG_EMA_RTOL, what)
    del want
    plain_ms = time_ms(loop, 1)
    torch.cuda.empty_cache()
    model = bag_update_bytes(a, p, mask_axes, adj, tables.n_out)
    nbytes, live = model["out"] + model["a"] + model["p"] + model["adj"], model["live_tuples"]
    row = {"shape": f"{what} r={p.dim() - 2} B={p.shape[-2]} C_a={a.shape[-1]} "
                    f"C_p={p.shape[-1]} n_out={tables.n_out} terms={tables.n_terms} "
                    f"masks={len(mask_axes)}",
           "max_abs_err": err, "bitwise_repeatable": bitwise, "bitwise_vs_loop": equal,
           "p_broadcast": p.stride(0) == 0, "p_contiguous": p.is_contiguous(),
           "live_tuples": live, "gb": nbytes / 1e9}
    bound, row["bound_by"] = bound_s(nbytes, 2 * live * p.shape[-2] * tables.n_out
                                     * tables.n_terms)
    row["bound_ms"] = bound * 1e3
    row["ms"], row["plain_ms"] = ms, plain_ms
    row["tb_s"] = nbytes / ms / 1e9
    return row


def check_bag_ema(graph, device, reps=3) -> list:
    """Per :data:`BAG_EMA_CASES` template, a ``blocked`` engine at its chunk
    counts one chunk; every bag extend and join hands its own operands to
    :func:`check_bag_op` (the engine goes on with the kernel's output).
    Each engine's bag updates must all have run in the kernel."""
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split

    rows = []
    for name, bsz in BAG_EMA_CASES:
        engine = CountingEngine(graph, [graphlet(name)], device=device, backend="blocked",
                                chunk_size=bsz, memory_budget_bytes=BAG_EMA_BUDGET)
        be = engine.backend_impl
        update, checked = be._bag_update, []

        def spy(a, p, tables, mask_axes=(), name=name, update=update, checked=checked):
            got = update(a, p, tables, mask_axes)
            if got is None:
                raise AssertionError(f"[bag_ema] {name}: an fp32 bag update took the loop")
            torch.cuda.synchronize()
            host = got.cpu()  # off the card: the loop's output takes its room
            del got
            checked.append(check_bag_op(be, f"{name} update {len(checked)}", a, p,
                                        tables, tuple(mask_axes), host, reps))
            log(f"[bag_ema] {json.dumps(checked[-1])}")
            return host.to(device)

        be._bag_update = spy
        est = engine.count_keys(split(prng_key(0, device), bsz))
        if not checked or engine.counters["bag_fused"] != len(checked) \
                or engine.counters["bag_loop"]:
            raise AssertionError(f"[bag_ema] {name}: {len(checked)} updates checked, "
                                 f"counters {engine.counters}")
        if not (est.size and (est >= 0).all() and bool(torch.isfinite(torch.as_tensor(est)).all())):
            raise AssertionError(f"[bag_ema] {name}: estimates {est.tolist()}")
        rows.extend(checked)
        del engine, be, spy
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5c: the counting service
# ---------------------------------------------------------------------------


def service_path(graph, device, budget) -> dict:
    """Two tenants on one ``CountingService``, then a warm repeat; every
    query's per-coloring rows equal ``count_keys`` on its ``fold_in`` keys."""
    import numpy as np
    import torch

    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import spmm_ema
    from repro_torch.serve.counting import CountingService

    kwargs = {} if device.type == "cuda" else {"device": device}
    svc = CountingService(memory_budget_bytes=budget, **kwargs)
    svc.register_graph("rmat8k", graph)
    g3 = [graphlet(t) for t in MOTIF_SETS[0][1]]
    g4 = [graphlet(t) for t in MOTIF_SETS[1][1]]
    tenants = (("tenant1", g3, dict(epsilon=0.1, delta=0.05, iterations=16, seed=1)),
               ("tenant2", g4, dict(iterations=8, seed=2)))
    reset_counting_launches()
    t0 = time.perf_counter()
    queries = [(name, svc.submit("rmat8k", ts, tenant=name, record_rows=True, **kw))
               for name, ts, kw in tenants]
    done_s = {}
    while svc.has_pending():
        if svc.step() is None:
            raise AssertionError("the service has pending work and nothing to run")
        for name, q in queries:
            if q.finished and name not in done_s:
                done_s[name] = time.perf_counter() - t0
    launches = counting_launches()
    device_launches = {"spmm_ema": spmm_ema.device_launches,
                       "spmm_blocked": spmm_blocked.device_launches}
    for name, q in queries:
        if not q.done:
            raise AssertionError(f"{name}: query ended {q.status} ({q.error})")
    warm = svc.engine(queries[1][1].engine_key)
    builds = warm.trace_count
    t0 = time.perf_counter()
    again = svc.submit("rmat8k", g4, tenant="tenant2", record_rows=True, **tenants[1][2])
    svc.run()
    warm_s = time.perf_counter() - t0
    if not again.done or svc.engine(again.engine_key) is not warm or warm.trace_count != builds:
        raise AssertionError(f"the warm repeat built again ({builds} -> {warm.trace_count} "
                             f"chunk-function builds) or did not finish ({again.status})")
    queries.append(("tenant2 repeat", again))
    rows = []
    for name, q in queries:
        seed = tenants[0 if name == "tenant1" else 1][2]["seed"]
        keys = fold_in(prng_key(seed, device), torch.arange(q.iterations, device=device))
        direct = svc.engine(q.engine_key).count_keys(keys)
        if not np.array_equal(q.per_iteration(), direct):
            raise AssertionError(f"{name}: served rows differ from count_keys on the same keys "
                                 f"(max |diff| {np.abs(q.per_iteration() - direct).max():g})")
        rows.append({"query": name, "templates": [t.name for t in q.templates],
                     "iterations": q.iterations, "converged": [bool(e.converged) for e in q.result()],
                     "means": [e.mean for e in q.result()],
                     "wall_s": warm_s if name == "tenant2 repeat" else done_s[name]})
    out = {"queries": rows, "launches": launches, "device_launches": device_launches,
           "service_launches": svc.stats()["launches"],
           "engines_built": svc.stats()["cache"]["misses"],
           "warm_repeat_chunk_function_builds": warm.trace_count - builds,
           "rows_equal_to_count_keys": True}
    log(f"[service] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 5d: autotuning
# ---------------------------------------------------------------------------


def binds_blocked(cfg) -> bool:
    return "blocked" in {cfg.default_backend, *cfg.bindings().values()}


def tune_one(name, graph, device, budget) -> dict:
    """Tune ``u5-1`` on one graph, race the winner against the heuristic,
    and hold the engine ``auto`` now builds against ``edges``."""
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template
    from repro_torch.plan.cost import CostModel, load_backend_calibration
    from repro_torch.plan.ir import build_template_plan
    from repro_torch.tune import tune

    template = get_template(TUNE_TEMPLATE)
    lattice = CostModel(build_template_plan([template]), graph, torch.float32).candidate_lattice(
        platform="cuda", calibration=load_backend_calibration(), memory_budget_bytes=budget)
    ranks = {"blocked": next(i for i, c in enumerate(lattice) if c.config.backend_name == "blocked")}
    mixed = [i for i, c in enumerate(lattice) if c.config.mixed and binds_blocked(c.config)]
    if mixed:
        ranks["mixed_with_blocked"] = mixed[0]
    top_n = max([TUNE_TOP_N] + [r + 1 for r in ranks.values()])
    t0 = time.perf_counter()
    result = tune(graph, [template], top_n=top_n, probes=TUNE_PROBES,
                  memory_budget_bytes=budget, device=device)
    tune_s = time.perf_counter() - t0
    if not any(m.config.backend_name == "blocked" for m in result.measured):
        raise AssertionError(f"[tune] {name}: no blocked candidate measured")
    measured = [{"backend": m.config.backend_name, "chunk": m.config.chunk_size,
                 "column_batch": m.config.column_batch,
                 "budget_gib": m.config.memory_budget_bytes / 2**30,
                 "groups": m.config.describe()["groups"],
                 "predicted_us_per_coloring": m.predicted_us,
                 "measured_us_per_coloring": m.measured_us,
                 "winner": m.config == result.config} for m in result.measured]

    # the winner, as backend="auto" now resolves it, against the heuristic
    tuned = CountingEngine(graph, [template], device=device)
    if tuned.backend_source != "tuned" or tuned.cache_key()[-1] != result.config.key_fragment():
        raise AssertionError(f"[tune] {name}: auto resolved {tuned.backend} "
                             f"({tuned.backend_source}), not the tuned winner")
    heuristic = CountingEngine(graph, [template], device=device,
                               backend=result.heuristic_backend, memory_budget_bytes=budget)
    race = {"tuned": [], "heuristic": []}
    engines = {"tuned": tuned, "heuristic": heuristic}
    keys = {k: split(prng_key(0, device), e.chunk_size) for k, e in engines.items()}
    for k, e in engines.items():
        e.count_keys_chunk(keys[k])  # warm-up
    for _ in range(TUNE_RACE_LAUNCHES):
        for k, e in engines.items():  # interleaved: drift hits both
            t0 = time.perf_counter()
            e.count_keys_chunk(keys[k])  # ends on the host
            race[k].append((time.perf_counter() - t0) * 1e6 / e.chunk_size)
    med = {k: float(np.median(v)) for k, v in race.items()}
    # where a chunk's time goes, for both engines (not in the race's times)
    profiles = {k: device_profile(lambda e=e, k=k: e.count_keys_chunk(keys[k]), motif_kernel_kind)
                for k, e in engines.items()}
    check = split(prng_key(1, device), TUNE_CHECK_KEYS)
    est = tuned.count_keys(check)
    want = CountingEngine(graph, [template], device=device, backend="edges",
                          memory_budget_bytes=budget).count_keys(check)
    if not (np.all(np.isfinite(est)) and np.allclose(est, want, rtol=TOTALS_RTOL, atol=0.0)):
        raise AssertionError(f"[tune] {name}: tuned {est.tolist()} vs edges {want.tolist()}")
    rec = {"graph": name, "template": TUNE_TEMPLATE, "lattice_size": result.lattice_size,
           "top_n": top_n, "probes": TUNE_PROBES, "ranks": ranks, "measured": measured,
           "winner": result.config.describe(), "heuristic": result.heuristic_backend,
           "calibration": result.calibration, "tune_s": tune_s,
           "race_us_per_coloring": med, "race_launches": TUNE_RACE_LAUNCHES,
           "tuned_over_heuristic": med["tuned"] / med["heuristic"], "profiles": profiles,
           "tuned_chunk": tuned.chunk_size, "heuristic_chunk": heuristic.chunk_size,
           "max_rel_diff_vs_edges": float(np.max(np.abs(est - want) / np.abs(want)))}
    log(f"[tune] {json.dumps(rec)}")
    del tuned, heuristic, engines
    torch.cuda.empty_cache()
    return rec


def mixed_check(graph, device, budget) -> dict:
    """An explicit ``mixed`` engine binding alternate tree groups to
    ``blocked`` and ``edges``: totals against ``edges``, and kernel A once
    per ``blocked``-bound stage per chunk."""
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template
    from repro_torch.plan.cost import CostModel
    from repro_torch.plan.ir import build_template_plan
    from repro_torch.tune import TuningConfig

    template = get_template(TUNE_TEMPLATE)
    plan = build_template_plan([template])
    leaders = CostModel(plan, graph, torch.float32).tree_group_leaders()
    bound = {addr: ("blocked", "edges")[k % 2] for k, addr in enumerate(leaders)}
    cfg = TuningConfig("edges", group_backends=tuple(bound.items()))
    engine = CountingEngine(graph, [template], device=device, backend="mixed", tuning=cfg,
                            memory_budget_bytes=budget)
    keys = split(prng_key(2, device), TUNE_CHECK_KEYS)
    engine.count_keys(keys)  # warm-up
    reset_counting_launches()
    est = engine.count_keys(keys)
    launches = counting_launches()
    chunks = -(-TUNE_CHECK_KEYS // min(engine.chunk_size, TUNE_CHECK_KEYS))
    blocked_stages = sum(len(plan.exec_groups[a]) for a, b in bound.items() if b == "blocked")
    want = CountingEngine(graph, [template], device=device, backend="edges",
                          memory_budget_bytes=budget).count_keys(keys)
    if launches["spmm_ema"] != blocked_stages * chunks:
        raise AssertionError(f"[tune] mixed: kernel A launched {launches['spmm_ema']} times, "
                             f"expected {blocked_stages} stages x {chunks} chunks")
    if not np.allclose(est, want, rtol=TOTALS_RTOL, atol=0.0):
        raise AssertionError(f"[tune] mixed {est.tolist()} vs edges {want.tolist()}")
    rec = {"groups": cfg.describe()["groups"], "blocked_stages": blocked_stages,
           "chunks": chunks, "launches": launches,
           "max_rel_diff_vs_edges": float(np.max(np.abs(est - want) / np.abs(want)))}
    log(f"[tune] mixed {json.dumps(rec)}")
    return rec


def tune_path(graphs, device, budget) -> dict:
    """Phase 5d over ``graphs`` (name -> graph), then the mixed check on the
    last; the tuner's probes are the counted launches."""
    reset_counting_launches()
    totals = {"spmm_ema": 0, "spmm_blocked": 0, "bag_ema": 0}
    records = []
    for name, graph in graphs.items():
        reset_counting_launches()
        rec = tune_one(name, graph, device, budget)
        rec["launches"] = counting_launches()  # the tuner's probes, race and gates
        for k in totals:
            totals[k] += rec["launches"][k]
        records.append(rec)
    if totals["spmm_ema"] <= 0:
        raise AssertionError(f"[tune] kernel A never launched: {totals}")
    mixed = mixed_check(graphs["rmat8k"], device, budget)
    return {"graphs": records, "mixed": mixed, "launches": totals}


# ---------------------------------------------------------------------------
# phase 5e: the asynchronous front-end under faults
# ---------------------------------------------------------------------------


def frontend_path(graph, device, budget) -> dict:
    """Two tenant threads through a started ``ServiceFrontend`` under 1-in-8
    transient launch faults, after one background tune task."""
    import numpy as np
    import torch

    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.serve import CountingService, RetryPolicy, ServiceError, ServiceFrontend
    from repro_torch.testing.faults import FaultPlan, FaultSpec

    svc = CountingService(memory_budget_bytes=budget, device=device,
                          retry_policy=RetryPolicy(max_retries=8, backoff_base=0.002,
                                                   max_backoff=0.05))
    svc.register_graph("rmat8k", graph)
    g3 = [graphlet(t) for t in MOTIF_SETS[0][1]]
    tenants = {"tenant0": [graphlet(TUNE_TEMPLATE)], "tenant1": g3}
    futs = {name: [] for name in tenants}
    reset_counting_launches()
    fe = ServiceFrontend(svc)
    t0 = time.perf_counter()
    with fe:
        fe.tune("rmat8k", [graphlet(TUNE_TEMPLATE)])
        while fe.tunes_run < 1:
            if fe.health()["state"] != "running":
                raise AssertionError(f"[frontend] the tune tripped the scheduler: "
                                     f"{fe.health()['last_error']}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("[frontend] the tune task did not run within 300 s")
            time.sleep(0.01)
        tune_s = time.perf_counter() - t0

        def submitter(k, name):
            for i in range(FRONTEND_QUERIES_PER_TENANT):
                futs[name].append(fe.submit(name, "rmat8k", tenants[name],
                                            iterations=FRONTEND_ITERATIONS,
                                            seed=1000 * k + i, record_rows=True))

        plan = FaultPlan([FaultSpec(site="launch", kind="transient", rate=FRONTEND_FAULT_RATE)],
                         seed=FRONTEND_FAULT_SEED)
        failed = 0
        t0 = time.perf_counter()
        with plan:
            threads = [threading.Thread(target=submitter, args=(k, name))
                       for k, name in enumerate(tenants)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for fs in futs.values():
                for f in fs:
                    try:
                        f.result(timeout=600)
                    except ServiceError:
                        failed += 1
        wall = time.perf_counter() - t0
        health = fe.health()
    launches = counting_launches()
    all_futs = [f for fs in futs.values() for f in fs]
    unresolved = sum(1 for f in all_futs if not f.done())
    if unresolved:
        raise AssertionError(f"[frontend] {unresolved} futures unresolved")
    if fe.tunes_run != 1 or health["state"] != "running":
        raise AssertionError(f"[frontend] tunes_run={fe.tunes_run}, health {health}")
    checked = 0
    for k, name in enumerate(tenants):
        for i, f in enumerate(futs[name]):
            if f.failed():
                continue
            q = f._query
            keys = fold_in(prng_key(1000 * k + i, device), torch.arange(q.iterations, device=device))
            direct = svc.engine(q.engine_key).count_keys(keys)
            if not np.array_equal(q.per_iteration(), direct):
                raise AssertionError(f"[frontend] {name} query {i}: served rows differ from "
                                     f"count_keys on the same keys")
            checked += 1
    lat_s = np.asarray([f.resolved_at - f.submitted_at for f in all_futs])
    stats = svc.stats()
    out = {"queries": len(all_futs), "failed": failed, "rows_checked": checked,
           "p50_s": float(np.percentile(lat_s, 50)), "p99_s": float(np.percentile(lat_s, 99)),
           "queries_per_s": len(all_futs) / wall, "wall_s": wall, "tune_s": tune_s,
           "faults_injected": plan.fires_by_site().get("launch", 0),
           "retries": stats["faults"]["retries"], "service_launches": stats["launches"],
           "tunes_run": fe.tunes_run, "health": health["state"],
           "backends": sorted({svc.engine(f._query.engine_key).backend for f in all_futs}),
           "launches": launches, "unresolved": unresolved}
    log(f"[frontend] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the flash-attention kernel
# ---------------------------------------------------------------------------


def check_flash(cfg, shapes, device, reps=3) -> list:
    """The kernel against its plain version at ``cfg``'s head geometry in
    bf16, causal, at each ``(b, s)``; ``F.scaled_dot_product_attention`` on
    the same inputs (laid out as it wants them beforehand) is the yardstick."""
    import torch
    import torch.nn.functional as F

    from portbench.roofline import PEAK_BYTES_PER_S
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    h, h_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for b, s in shapes:
        q = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
        k = torch.randn((b, s, h_kv, d), generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, h_kv, d), generator=gen, device=device).to(torch.bfloat16)

        def plain():
            return flash_attention_ref(q, k, v, causal=True)

        before = flash_attention.tensor_core_launches
        got = flash_attention(q, k, v, causal=True)
        if flash_attention.tensor_core_launches != before + 1:
            raise AssertionError(f"flash_attention b={b} s={s}: bf16 did not launch the "
                                 f"tensor-core kernel")
        want = plain()
        got, want = got.float(), want.float()
        err = max_abs_err(got, want, FLASH_RTOL, f"flash_attention b={b} s={s}", atol=FLASH_ATOL)
        # worst error relative to |want| (elements below the absolute term
        # are measured against it)
        rel = float(((got - want).abs() / want.abs().clamp_min(FLASH_ATOL)).max())
        del got, want
        row = {"shape": f"b={b} s={s} h={h} h_kv={h_kv} d={d} bf16 causal", "max_abs_err": err,
               "max_rel_err": rel}
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * h_kv * d)   # q, o; k, v
        flops = 4 * b * h * s * s * d / 2
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        row["bound_ms"], row["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                            else (t_ops, "operations"))
        row["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=True), reps)
        row["tflops"] = flops / row["ms"] / 1e9
        row["plain_ms"] = time_ms(plain, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        log(f"[flash] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 7: the LM forward
# ---------------------------------------------------------------------------


def lm_kernel_kind(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "cublas_products"
    return "rest"


def moe_kernel_kind(name: str) -> str:
    """:func:`lm_kernel_kind`, with the MoE dispatch apart: the router's sort
    (top-k), the queue positions' scan and gather, the scatter into expert
    rows and the gather back (the embedding lookup's gather is counted
    here too; it is 0.1 GB of a forward's reads)."""
    kind = lm_kernel_kind(name)
    low = name.lower()
    if kind == "rest" and any(t in low for t in ("sort", "scan", "index", "gather", "scatter")):
        return "moe_dispatch"
    return kind


def lm_forward(cfg, device, reps=2, tag="lm", classify=None):
    """A GQA config's forward at full width (granite-8b: and depth; phase 8d
    runs DBRX's cut to 2 layers): the fp32 flash-vs-sdpa gate, then the
    bf16 forward (the config's dtype) as the main path.  Returns the record
    and the parameters (phase 8 reuses them)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, attn_impl="flash", dtype="float32")
    t0 = time.perf_counter()
    params = T.init_params(cfg32, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_SEQ)), device=device)

    before = flash_attention.launches, flash_attention.tensor_core_launches
    t0 = time.perf_counter()
    ref32, _, _ = T.forward(params, cfg32, tokens)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    fp32_launches = flash_attention.launches - before[0]
    fp32_tensor_core = flash_attention.tensor_core_launches - before[1]
    sdpa32, _, _ = T.forward(params, dataclasses.replace(cfg32, attn_impl="sdpa"), tokens)
    scale = float(sdpa32.abs().max())
    diff = float((ref32 - sdpa32).abs().max())
    del sdpa32
    if not (diff <= LOGITS_RTOL * scale) or not bool(torch.isfinite(ref32).all()):
        raise AssertionError(f"fp32 logits: flash vs sdpa max |diff| {diff:g} > "
                             f"{LOGITS_RTOL} x max |logits| {scale:g}")
    if fp32_launches != cfg.n_layers or fp32_tensor_core != 0:
        raise AssertionError(f"fp32 forward launched flash_attention {fp32_launches} times "
                             f"({fp32_tensor_core} on the tensor cores), not {cfg.n_layers} "
                             f"(0 on the tensor cores)")

    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    logits, _, _ = T.forward(params, cfg16, tokens)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_tensor_core": flash_attention.tensor_core_launches}
    if set(launches.values()) != {cfg.n_layers}:
        raise AssertionError(f"bf16 forward launched flash_attention {launches}, not "
                             f"{cfg.n_layers} times, all on the tensor cores")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 logits are not finite")
    bf16_dev = float((logits.float() - ref32).abs().max())
    del logits, ref32
    torch.cuda.reset_peak_memory_stats()  # bf16 forwards over the resident weights
    ms = time_ms(lambda: T.forward(params, cfg16, tokens), reps)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(lambda: (T.forward(params, cfg16, tokens),
                                      torch.cuda.synchronize()), classify or lm_kernel_kind)
    out = {
        "config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_count": cfg.param_count(),
        "batch": LM_BATCH, "seq": LM_SEQ,
        "init_params_s": init_s,
        "fp32_forward_s": fp32_s,
        "fp32_flash_vs_sdpa_max_abs_diff": diff,
        "fp32_max_abs_logit": scale,
        "bf16_vs_fp32_max_abs_diff": bf16_dev,
        "launches": launches,
        "bf16_forward_ms": ms,
        "bf16_tokens_per_s": LM_BATCH * LM_SEQ / (ms / 1e3),
        "bf16_max_memory_allocated": peak,
        "profile": profile,
    }
    log(f"[{tag}] {json.dumps(out)}")
    return out, params, cfg32


# ---------------------------------------------------------------------------
# phase 8: ServeEngine
# ---------------------------------------------------------------------------


def serve(cfg32, params, device, tag="serve", classify=None) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(1)
    engine = ServeEngine(cfg32, params, max_batch=SERVE_SLOTS, max_len=SERVE_LEN)
    equal = [Request(uid=i, prompt=rng.integers(0, cfg32.vocab_size, 64).astype(np.int32),
                     max_new_tokens=SERVE_NEW) for i in range(4)]
    t0 = time.perf_counter()
    engine.run(equal)
    equal_s = time.perf_counter() - t0
    toks = torch.as_tensor(np.stack([r.prompt for r in equal]), device=device).long()
    for _ in range(SERVE_NEW):
        logits, _, _ = T.forward(params, cfg32, toks)
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], 1)
        del logits
    greedy = toks[:, 64:].tolist()
    for req, want in zip(equal, greedy):
        if req.generated != want:
            raise AssertionError(f"request {req.uid}: served {req.generated} != greedy {want}")

    lengths = rng.integers(16, 513, size=SERVE_SLOTS)
    mixed = [Request(uid=100 + i, prompt=rng.integers(0, cfg32.vocab_size, int(n)).astype(np.int32),
                     max_new_tokens=SERVE_NEW) for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    engine.run(mixed)
    mixed_s = time.perf_counter() - t0
    for req in mixed:
        if not req.done or len(req.generated) != SERVE_NEW:
            raise AssertionError(f"request {req.uid} ended with {len(req.generated)} tokens")
    st = dict(engine.stats)
    # four more requests under torch.profiler, for the device's idle share
    # while serving (kept out of the numbers above)
    more = [Request(uid=200 + i, prompt=rng.integers(0, cfg32.vocab_size, 64).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for i in range(4)]
    profile = device_profile(lambda: engine.run(more), classify or lm_kernel_kind)
    out = {
        "slots": SERVE_SLOTS, "max_len": SERVE_LEN, "dtype": cfg32.dtype,
        "requests": len(equal) + len(mixed),
        "equal_prompt_group_s": equal_s, "mixed_prompt_lengths": lengths.tolist(),
        "mixed_group_s": mixed_s,
        "prefill_ms_per_request": st["prefill_seconds"] / st["prefills"] * 1e3,
        "decode_steps": st["decode_steps"], "decode_tokens": st["decode_tokens"],
        "decode_tokens_per_s": st["decode_tokens"] / st["decode_seconds"],
        "decode_ms_per_step": st["decode_seconds"] / st["decode_steps"] * 1e3,
        "greedy_match": True,
        "profile_of_4_more_requests": profile,
    }
    log(f"[{tag}] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phases 8b-8e: MLA and MoE (deepseek-v2-lite-16b, dbrx-132b)
# ---------------------------------------------------------------------------


def skewed_tokens(shape, d, gen, device, dtype):
    """Normal activations plus one direction every token shares, so that
    they favour the same experts and some overflow their capacity."""
    import torch

    x = torch.randn(shape + (d,), generator=gen, device=device)
    return (x + 1.5 * torch.randn((d,), generator=gen, device=device)).to(dtype)


def moe_gate(moe, cfg32, device) -> dict:
    """One MoE layer in fp32 at the published capacity against the plain
    per-expert loop (``repro_torch.testing.moe``) on the card, both under
    the routing of one ``moe_route`` call."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.testing.moe import moe_loop

    gen = torch.Generator(device=device).manual_seed(3)
    x = skewed_tokens(MOE_GATE_TOKENS, cfg32.d_model, gen, device, torch.float32)
    got, aux = L.moe_apply(moe, cfg32, x)
    _, gates, experts = L.moe_route(moe["router"], x.reshape(-1, cfg32.d_model), cfg32.moe_top_k)
    want, dropped = moe_loop(moe, cfg32, x, gates, experts)
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    if not (diff <= MOE_RTOL * scale) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"moe_apply vs the per-expert loop: max |diff| {diff:g} > "
                             f"{MOE_RTOL} x max |out| {scale:g}")
    if dropped == 0:
        raise AssertionError("the MoE gate dropped no pair: capacity was not exercised")
    return {"tokens": MOE_GATE_TOKENS[0] * MOE_GATE_TOKENS[1], "dropped_pairs": dropped,
            "max_abs_diff": diff, "max_abs_out": scale, "aux": float(aux)}


def mla_gate(params, cfg32, device) -> dict:
    """Prefill of ``MLA_PROMPT`` tokens (decompressed path) and one
    ``decode_step`` (absorbed path) against ``forward`` on the whole
    sequence, in fp32 with no capacity drops."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(cfg32, capacity_factor=float(cfg32.n_experts))
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(MLA_ROWS, MLA_PROMPT)), device=device)
    caches = T.init_kv_cache(cfg, MLA_ROWS, 2 * MLA_PROMPT, device=device)
    lg, caches = T.prefill(params, cfg, tokens, caches)
    nxt = lg[:, -1].argmax(-1)[:, None]
    got, _ = T.decode_step(params, cfg, nxt, caches, MLA_PROMPT)
    full, _, _ = T.forward(params, cfg, torch.cat([tokens, nxt], 1))
    err = max_abs_err(got, full[:, -1], MLA_RTOL, "MLA absorbed decode vs forward", atol=MLA_ATOL)
    return {"rows": MLA_ROWS, "prompt": MLA_PROMPT, "max_abs_err": err,
            "max_abs_logit": float(full[:, -1].abs().max()),
            "cache_bytes_per_token_layer": 4 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)}


def attention_split(profile, core, n_layers) -> dict:
    """The forward's device time by kind with the attention core apart:
    ``core`` is the profile of one layer's ``_sdpa_chunked`` at the
    forward's shapes, whose kernels (batched products, masks, softmax) the
    forward's split counts under products and the rest; ``n_layers`` times
    its split moves to ``attention``."""
    split = dict(profile["split_ms"])
    for kind, ms in core["split_ms"].items():
        split[kind] = split.get(kind, 0.0) - n_layers * ms
    split["attention"] = n_layers * sum(core["split_ms"].values())
    return split


def mla_moe_path(cfg, device, reps=2):
    """Phase 8b: deepseek-v2-lite-16b at full width and depth, seeded random
    fp32 weights.  The MoE gate on its first MoE layer, the MLA gate, then
    the bf16 forward at b=4, s=4096 as the main path.  Returns the record,
    the parameters and the fp32 config ([serve_mla] reuses them)."""
    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    params = T.init_params(cfg32, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    moe = T._map(lambda p: p[0], params["groups"][1]["moe"])
    moe_rec = moe_gate(moe, cfg32, device)
    mla_rec = mla_gate(params, cfg32, device)

    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_SEQ)), device=device)
    logits, aux, _ = T.forward(params, cfg, tokens)
    if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bf16 logits {tuple(logits.shape)} are not finite or misshapen")
    del logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: T.forward(params, cfg, tokens), reps)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(lambda: (T.forward(params, cfg, tokens), torch.cuda.synchronize()),
                             moe_kernel_kind)

    # one layer's attention core at the forward's shapes, for the split
    gen = torch.Generator(device=device).manual_seed(5)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q, k = (torch.randn((LM_BATCH, LM_SEQ, cfg.n_heads, qk), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((LM_BATCH, LM_SEQ, cfg.n_heads, cfg.v_head_dim), generator=gen,
                    device=device).to(torch.bfloat16)
    pos = torch.arange(LM_SEQ, device=device)

    def core():
        return L._sdpa_chunked(q, k, v, pos, None, causal=True, q_chunk=cfg.attn_q_chunk)

    core_ms = time_ms(core, reps)
    core_profile = device_profile(lambda: (core(), torch.cuda.synchronize()), moe_kernel_kind)
    del q, k, v
    out = {
        "config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_count": cfg.param_count(), "capacity_factor": cfg.capacity_factor,
        "capacity_per_expert": max(int(LM_BATCH * LM_SEQ * cfg.moe_top_k * cfg.capacity_factor
                                       / cfg.n_experts), 4),
        "batch": LM_BATCH, "seq": LM_SEQ, "init_params_s": init_s,
        "moe_gate": moe_rec, "mla_gate": mla_rec, "bf16_aux": float(aux),
        "bf16_forward_ms": ms,
        "bf16_tokens_per_s": LM_BATCH * LM_SEQ / (ms / 1e3),
        "bf16_max_memory_allocated": peak,
        "attention_core_ms_per_layer": core_ms,
        "split_ms": attention_split(profile, core_profile, cfg.n_layers),
        "profile": profile,
    }
    log(f"[mla_moe] {json.dumps(out)}")
    return out, params, cfg32


def moe_ep_rank(rank, world, cfg, tokens_shape, seed, device_type) -> dict:
    """One rank of ``[moe_ep]`` (runs in a process ``run_ranks`` spawned):
    the whole layer and every rank's tokens from ``seed``, then this rank's
    tokens through the dense path and through the expert-parallel path
    with its share of the experts."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import layers as L

    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = L.init_moe(gen, cfg, device)
    x = skewed_tokens(tokens_shape, cfg.d_model, gen, device, getattr(torch, cfg.dtype))
    x = x.chunk(world)[rank]
    shard = L.moe_shard(params, rank, world)
    dense, dense_aux = L.moe_apply(params, cfg, x)
    ep, ep_aux = L.moe_apply(shard, cfg, x, group=dist.group.WORLD)
    _, _, experts = L.moe_route(params["router"], x.reshape(-1, cfg.d_model), cfg.moe_top_k)
    counts = torch.bincount(experts.reshape(-1), minlength=cfg.n_experts)
    capacity = max(int(experts.numel() * cfg.capacity_factor / cfg.n_experts), 4)
    out = {
        "rank": rank, "world": world, "backend": dist.get_backend(),
        "tokens": x.shape[0] * x.shape[1], "dtype": cfg.dtype, "capacity": capacity,
        "dropped_pairs": int((counts - capacity).clamp_min(0).sum()),
        "bitwise_equal": bool(torch.equal(ep, dense)) and float(ep_aux) == float(dense_aux),
        "max_abs_diff": float((ep.float() - dense.float()).abs().max()),
        "aux": float(ep_aux),
    }
    if device_type == "cuda":
        out["dense_ms"] = time_ms(lambda: L.moe_apply(params, cfg, x), 3)
        out["ep_ms"] = time_ms(lambda: L.moe_apply(shard, cfg, x, group=dist.group.WORLD), 3)
    return out


def moe_ep_path(cfg, device) -> dict:
    """Phase 8e: one full-width MoE layer of ``cfg`` through the
    expert-parallel path at one NCCL rank (one gloo rank on the CPU, for
    rehearsals), held bitwise against the dense path on the same tokens (at
    one rank the two run the same products on the same rows; the exchange
    is two copies)."""
    import torch

    from repro_torch.testing.ranks import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(moe_ep_rank, 1, args=(cfg, EP_TOKENS, EP_SEED, device.type),
                      backend="nccl" if device.type == "cuda" else "gloo", timeout_s=EP_TIMEOUT_S)
    out = dict(ranks[0], group_wall_s=time.perf_counter() - t0, config=cfg.name)
    if not out["bitwise_equal"]:
        raise AssertionError(f"[moe_ep] EP differs from the dense path: max |diff| "
                             f"{out['max_abs_diff']:g}")
    if out["dropped_pairs"] == 0:
        raise AssertionError("[moe_ep] no pair dropped: capacity was not exercised")
    log(f"[moe_ep] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 8f: training (granite-8b at full width)
# ---------------------------------------------------------------------------


def train_kernel_kind(name: str) -> str:
    """fp32 products (cuBLAS's ``f32f32`` and CUTLASS's ``sgemm`` kernels:
    the attention core, with TF32 off), the other products (bf16), casts
    and copies, and every other kernel."""
    low = name.lower()
    if lm_kernel_kind(name) == "cublas_products":
        return "fp32_products" if ("sgemm" in low or "f32f32_f32f32" in low) else "bf16_products"
    return "casts_and_copies" if "copy" in low else "rest"


def train_grads(params, cfg, tokens, labels, loss_chunk=0):
    """``loss_fn`` and its backward from zeroed gradients; returns the loss
    and the gradient leaves in ``jax.tree`` order."""
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = T.loss_fn(params, cfg, tokens, labels, loss_chunk=loss_chunk)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def leaf_errors(got, want) -> list:
    """Per leaf: max |got - want| over max |want|."""
    return [float((g.to(w.device) - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def train_gates(cfg, device) -> dict:
    """The fp32 gates of ``[train]`` at ``cfg``'s width and
    ``TRAIN_GATE_LAYERS`` layers on one ``token_batches`` batch: the card
    against the CPU (the port's plain path), remat on against off, the
    chunked loss against the whole one, and the flash path's forward
    launching with its backward refused."""
    import torch

    from repro_torch.data.pipeline import token_batches
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_GATE_LAYERS, dtype="float32", attn_impl="sdpa",
                              remat=False)
    params = T.init_params(cfg, seed=0, device=device)
    tokens, labels = next(token_batches(cfg, *TRAIN_GATE_TOKENS, seed=0, device=device))
    out = {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "parameters": sum(p.numel() for p in tree_leaves(params)),
           "tokens": list(TRAIN_GATE_TOKENS)}

    t0 = time.perf_counter()
    loss, grads = train_grads(params, cfg, tokens, labels)
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = train_grads(tree_map(lambda p: p.detach().to(cpu), params), cfg,
                                      tokens.to(cpu), labels.to(cpu))
    out["cpu_s"] = time.perf_counter() - t0
    errs = leaf_errors(grads, cpu_grads)
    out["card_vs_cpu_loss"] = [float(loss), float(cpu_loss)]
    out["card_vs_cpu_worst_leaf"] = max(errs)
    del cpu_grads
    if abs(float(loss) - float(cpu_loss)) > TRAIN_LOSS_RTOL * abs(float(cpu_loss)) or \
            max(errs) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"[train] card vs CPU: loss {float(loss)} vs {float(cpu_loss)}, "
                             f"worst leaf max |dg| / max |g| {max(errs):g} > {TRAIN_GRAD_RTOL}")
    log(f"[time] [train] card-vs-CPU gate: card {out['card_s']:.1f} s, CPU {out['cpu_s']:.1f} s")

    remat_loss, remat_grads = train_grads(params, dataclasses.replace(cfg, remat=True), tokens,
                                          labels)
    out["remat_bitwise"] = bool(torch.equal(remat_loss, loss)) and all(
        torch.equal(g, h) for g, h in zip(remat_grads, grads))
    out["remat_worst_leaf"] = max(leaf_errors(remat_grads, grads))
    del remat_grads
    if not out["remat_bitwise"]:
        raise AssertionError(f"[train] remat changed the gradients: worst leaf "
                             f"{out['remat_worst_leaf']:g}")

    chunk_loss, chunk_grads = train_grads(params, cfg, tokens, labels, loss_chunk=TRAIN_CHUNK)
    out["chunked_loss_rel"] = abs(float(chunk_loss) - float(loss)) / abs(float(loss))
    out["chunked_worst_leaf"] = max(leaf_errors(chunk_grads, grads))
    del chunk_grads, grads
    if max(out["chunked_loss_rel"], out["chunked_worst_leaf"]) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"[train] loss_chunk={TRAIN_CHUNK} vs whole: loss {out['chunked_loss_rel']:g}, "
                             f"worst leaf {out['chunked_worst_leaf']:g} > {TRAIN_LOSS_RTOL}")

    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    flash_loss = T.loss_fn(params, dataclasses.replace(cfg, attn_impl="flash"), tokens, labels)
    out["flash_refusal_launches"] = flash_attention.launches
    out["flash_refusal_tensor_core_launches"] = flash_attention.tensor_core_launches
    out["flash_loss"] = float(flash_loss.detach())
    try:
        flash_loss.backward()
        out["flash_backward_refused"] = False
    except NotImplementedError:
        out["flash_backward_refused"] = True
    if not out["flash_backward_refused"] or out["flash_refusal_launches"] != cfg.n_layers:
        raise AssertionError(f"[train] flash path: backward refused {out['flash_backward_refused']}, "
                             f"{out['flash_refusal_launches']} launches (want {cfg.n_layers})")
    del params, flash_loss
    torch.cuda.empty_cache()
    return out


def restart_gate(cfg, device) -> dict:
    """``TrainLoop`` over ``make_lm_job`` on ``cfg``: ``TRAIN_RESTART_STEPS``
    steps straight, and the same with a fault injected and a resume from the
    last checkpoint; the two final states must be equal bit for bit."""
    import torch

    from repro_torch.launch.train import make_lm_job
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.tree import tree_leaves

    steps, every, fault = TRAIN_RESTART_STEPS, TRAIN_RESTART_EVERY, TRAIN_RESTART_FAULT

    def job():
        return make_lm_job(cfg, *TRAIN_RESTART_TOKENS, TRAIN_LR, device=device)

    with tempfile.TemporaryDirectory() as d:
        state, step, data = job()
        straight = TrainLoop(LoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=every),
                             step, data, state).run()
    with tempfile.TemporaryDirectory() as d:
        loop_cfg = LoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=every)
        state, step, data = job()
        loop = TrainLoop(loop_cfg, step, data, state)
        loop.inject_fault_at(fault)
        try:
            loop.run()
            raise AssertionError("[train] the injected fault did not stop the loop")
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
        state, step, data = job()
        loop = TrainLoop(loop_cfg, step, data, state)
        restored = loop.try_restore()
        resumed_from = loop.step
        resumed = loop.run()
    pairs = list(zip(tree_leaves(resumed), tree_leaves(straight)))
    out = {"config": cfg.name, "steps": steps, "ckpt_every": every, "fault_at": fault,
           "resumed_from": resumed_from,
           "bitwise": restored and all(torch.equal(a, b) for a, b in pairs),
           "worst_leaf": max(leaf_errors([a.detach() for a, _ in pairs],
                                         [b.detach().float() for _, b in pairs]))}
    if not out["bitwise"] or resumed_from != fault - fault % every:
        raise AssertionError(f"[train] restart: resumed from {resumed_from}, bitwise "
                             f"{out['bitwise']} (worst leaf {out['worst_leaf']:g})")
    return out


def train_split(cfg, state, step, batch, device) -> dict:
    """Device time of one train step by kind: the step profiled whole, then
    its parts profiled alone at the step's shapes and taken out of the
    kinds they run: the fp32 attention core (one layer's ``_sdpa_chunked``
    forward, and its forward and backward, which remat runs again; times
    ``n_layers``), the loss head (unembedding, log-softmax, NLL and their
    backward) and the optimizer (clipping and the AdamW update)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_map

    whole = device_profile(lambda: (step(state, batch), torch.cuda.synchronize()),
                           train_kernel_kind)
    b, s = batch[0].shape
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(6)

    def leaf(shape):
        return torch.randn(shape, generator=gen, device=device).to(dt).requires_grad_(True)

    q = leaf((b, s, cfg.n_heads, cfg.d_head))
    k, v = leaf((b, s, cfg.n_kv_heads, cfg.d_head)), leaf((b, s, cfg.n_kv_heads, cfg.d_head))
    pos = torch.arange(s, device=device)

    def core():
        return L._sdpa_chunked(q, k, v, pos, None, causal=True, q_chunk=cfg.attn_q_chunk)

    core_fwd = device_profile(lambda: (core(), torch.cuda.synchronize()), train_kernel_kind)
    grad_out = torch.randn(q.shape, generator=gen, device=device).to(dt)
    core_fb = device_profile(lambda: (core().backward(grad_out), torch.cuda.synchronize()),
                             train_kernel_kind)
    del q, k, v, grad_out
    x = leaf((b, s, cfg.d_model))
    unembed = state["params"]["unembed"]
    loss = device_profile(lambda: (T._nll(x, unembed, batch[1]).mean().backward(),
                                   torch.cuda.synchronize()), train_kernel_kind)
    del x
    params = state["params"]
    grads = tree_map(lambda p: p.grad, params)
    optimizer = device_profile(lambda: (adamw_update(clip_by_global_norm(grads, 1.0)[0],
                                                     state["opt"], params, TRAIN_LR),
                                        torch.cuda.synchronize()), train_kernel_kind)
    parts = {"attention_core": (core_fwd, cfg.n_layers), "attention_core_backward": (core_fb, cfg.n_layers),
             "loss": (loss, 1), "optimizer": (optimizer, 1)}
    split = dict(whole["split_ms"])
    out = {}
    for name, (prof, times) in parts.items():
        for kind, ms in prof["split_ms"].items():
            split[kind] = split.get(kind, 0.0) - times * ms
        out[name] = times * sum(prof["split_ms"].values())
    out["attention_core"] += out.pop("attention_core_backward")
    # what is left of each kind; fp32 products left over (~0) check that
    # the core profiled alone is the step's
    out.update(split)
    return {"split_ms": out, "profile": whole,
            "attention_core_ms_per_layer_profiled": (sum(core_fwd["split_ms"].values())
                                                     + sum(core_fb["split_ms"].values()))}


def train_run(cfg, device) -> dict:
    """The bf16 run: ``make_lm_job`` through ``TrainLoop`` on ``token_batches
    (seed=0)``, ``TRAIN_WARMUP`` steps then ``TRAIN_TIMED`` timed with CUDA
    events, one step profiled and split, then ``TRAIN_REPEAT`` steps on one
    repeated batch, whose loss must fall."""
    import math

    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.train import make_lm_job
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    batch = TRAIN_BATCH
    state, step, data = make_lm_job(cfg, batch, TRAIN_SEQ, TRAIN_LR, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    events = []

    def timed_step(state, batch_data):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch_data)
        stop.record()
        events.append((start, stop))
        return out

    loop = TrainLoop(LoopConfig(total_steps=TRAIN_WARMUP + TRAIN_TIMED, log_every=1), timed_step,
                     data, state)
    state = loop.run()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [h["loss"] for h in loop.metrics_history]
    peak = torch.cuda.max_memory_allocated()
    ms = sum(step_ms[TRAIN_WARMUP:]) / TRAIN_TIMED
    tokens = batch * TRAIN_SEQ
    n_params = cfg.param_count()
    model_flops = 6 * n_params * tokens
    stream = data(TRAIN_WARMUP + TRAIN_TIMED)
    split = train_split(cfg, state, step, next(stream), device)
    repeated = next(stream)
    repeat_losses = []
    for _ in range(TRAIN_REPEAT):
        state, metrics = step(state, repeated)
        repeat_losses.append(float(metrics["loss"]))
    out = {
        "config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "remat": cfg.remat, "attn_impl": cfg.attn_impl, "batch": batch, "seq": TRAIN_SEQ,
        "param_count": n_params, "parameters": sum(p.numel() for p in tree_leaves(state["params"])),
        "init_s": init_s, "step_ms": step_ms, "ms_per_step": ms,
        "tokens_per_s": tokens / (ms / 1e3),
        "model_flops_per_step": model_flops,
        "model_flop_bound_ms": model_flops / PEAK_BF16_FLOPS * 1e3,
        "model_flop_share": model_flops / PEAK_BF16_FLOPS / (ms / 1e3),
        "host_step_s": loop._step_times, "max_memory_allocated": peak,
        "losses": losses, "repeat_losses": repeat_losses,
        "flash_launches": flash_attention.launches,
        "device_idle_share": split["profile"]["device_idle_share"], **split,
    }
    if not all(math.isfinite(x) for x in losses + repeat_losses):
        raise AssertionError(f"[train] a loss is not finite: {losses} {repeat_losses}")
    if not repeat_losses[-1] < repeat_losses[0]:
        raise AssertionError(f"[train] the loss did not fall on a repeated batch: {repeat_losses}")
    if flash_attention.launches:
        raise AssertionError(f"[train] the sdpa run launched flash_attention {flash_attention.launches} times")
    return out


def train_path(cfg, device) -> dict:
    """Phase 8f (``[train]``): the fp32 gates at ``cfg``'s full width, the
    restart gate on its ``SMOKE_CONFIG`` on the card, then the bf16 run at
    full width cut to ``TRAIN_LAYERS`` layers."""
    import torch

    from repro_torch.configs.granite_8b import SMOKE_CONFIG

    gates = train_gates(cfg, device)
    log(f"[train] gates {json.dumps(gates)}")
    restart = restart_gate(SMOKE_CONFIG, device)
    log(f"[train] restart {json.dumps(restart)}")
    run = train_run(dataclasses.replace(cfg, n_layers=TRAIN_LAYERS, attn_impl="sdpa"), device)
    log(f"[train] run {json.dumps(run)}")
    torch.cuda.empty_cache()
    return {"gates": gates, "restart": restart, "run": run}


# ---------------------------------------------------------------------------
# phase 8g: the GNN family, trained
# ---------------------------------------------------------------------------


def gnn_kernel_kind(name: str) -> str:
    """Segment reductions (``torch.segment_reduce``'s kernels), products
    (cuBLAS/CUTLASS), gathers (index reads: the edge gathers, the backward
    of a segment sum, rows permuted into segment order), sorts (the batch's
    argsorts and bincounts, made once per batch), and the rest
    (elementwise, reductions)."""
    low = name.lower()
    if "segment" in low:
        return "segment_reductions"
    if lm_kernel_kind(name) == "cublas_products":
        return "products"
    if any(t in low for t in ("index", "gather")):
        return "gathers"
    if any(t in low for t in ("sort", "radix", "histogram", "bincount")):
        return "sorts"
    return "elementwise"


def wrapper_launches() -> dict:
    """The four kernel wrappers' launch counters."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return {**counting_launches(), "flash_attention": flash_attention.launches}


def gnn_eval(params, cfg, batch, labels):
    """The outputs (no autograd), then the loss and every gradient leaf from
    zeroed gradients (zeros where the loss does not reach, as in
    ``gnn_train_step``)."""
    import torch

    from repro_torch.models import gnn as G
    from repro_torch.train.tree import tree_leaves

    leaves = tree_leaves(params)
    with torch.no_grad():
        out = G.forward(params, cfg, batch)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = G.loss_fn(params, cfg, batch, labels)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return out, loss.detach(), grads


def gnn_card_vs_cpu(cfg, params, batch, labels) -> dict:
    """The card against the CPU (the port's same code on CPU tensors) from
    the same parameters and batch: outputs, loss, every gradient leaf."""
    import torch

    from repro_torch.train.tree import tree_map

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    out, loss, grads = gnn_eval(params, cfg, batch, labels)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out, cpu_loss, cpu_grads = gnn_eval(tree_map(lambda p: p.detach().to(cpu), params), cfg,
                                            batch.to(cpu), labels.to(cpu))
    rec = {"card_s": card_s, "cpu_s": time.perf_counter() - t0,
           "out_rel": float((out.to(cpu) - cpu_out).abs().max()) / max(float(cpu_out.abs().max()), 1e-30),
           "loss": [float(loss), float(cpu_loss)],
           "loss_rel": abs(float(loss) - float(cpu_loss)) / max(abs(float(cpu_loss)), 1e-30),
           "worst_leaf": max(leaf_errors(grads, cpu_grads))}
    if rec["out_rel"] > GNN_OUT_RTOL or rec["loss_rel"] > GNN_LOSS_RTOL or \
            rec["worst_leaf"] > GNN_GRAD_RTOL:
        raise AssertionError(f"[gnn] {cfg.name} card vs CPU: outputs {rec['out_rel']:g} (limit "
                             f"{GNN_OUT_RTOL}), loss {rec['loss_rel']:g} ({GNN_LOSS_RTOL}), worst "
                             f"leaf {rec['worst_leaf']:g} ({GNN_GRAD_RTOL})")
    return rec


def random_rotation(seed: int = 0):
    """A random proper rotation (QR of a seeded normal matrix, det +1)."""
    import torch

    q, _ = torch.linalg.qr(torch.randn((3, 3), generator=torch.Generator().manual_seed(seed),
                                       dtype=torch.float64))
    if torch.det(q) < 0:
        q[:, 0] *= -1
    return q.to(torch.float32)


def gnn_equivariance(cfg, params, batch) -> float:
    """Per-graph energies under a proper rotation of every position:
    max |dE| / max(|E|, 1)."""
    import torch

    from repro_torch.models import gnn as G

    q = random_rotation().to(batch.positions.device)
    with torch.no_grad():
        e1 = G.forward(params, cfg, batch)
        e2 = G.forward(params, cfg, dataclasses.replace(batch, positions=batch.positions @ q.T))
    rel = float(((e2 - e1).abs() / e1.abs().clamp(min=1.0)).max())
    if not rel <= GNN_EQUIV_RTOL:
        raise AssertionError(f"[gnn] {cfg.name}: energies moved by {rel:g} of max(|E|, 1) under a "
                             f"rotation (limit {GNN_EQUIV_RTOL})")
    return rel


def gnn_repeat(cfg, state, batch, labels) -> bool:
    """Two train steps from copies of one state: loss, gradient norm,
    clipped gradients and the updated state must be equal bit for bit."""
    import torch

    from repro_torch.launch.train import gnn_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    step = gnn_train_step(cfg, GNN_LR)
    runs = []
    for _ in range(2):
        state_i, metrics = step(tree_map(lambda t: t.detach().clone(), state), (batch, labels))
        grads = [p.grad for p in tree_leaves(state_i["params"]) if p.grad is not None]
        runs.append([metrics["loss"], metrics["gnorm"], *grads,
                     *(t.detach() for t in tree_leaves(state_i))])
    if not (len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))):
        raise AssertionError(f"[gnn] {cfg.name}: two train steps from one state differ")
    return True


def gnn_split(state, step, batch, labels) -> dict:
    """Device time of one train step by :func:`gnn_kernel_kind`, with the
    optimizer (clipping and the AdamW update, profiled alone on the step's
    gradients) taken out of the kinds it runs."""
    import torch

    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_map

    whole = device_profile(lambda: (step(state, (batch, labels)), torch.cuda.synchronize()),
                           gnn_kernel_kind)
    params = state["params"]
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
    optimizer = device_profile(lambda: (adamw_update(clip_by_global_norm(grads, 1.0)[0],
                                                     state["opt"], params, GNN_LR),
                                        torch.cuda.synchronize()), gnn_kernel_kind)
    split = dict(whole["split_ms"])
    for kind, ms in optimizer["split_ms"].items():
        split[kind] = split.get(kind, 0.0) - ms
    split["optimizer"] = sum(optimizer["split_ms"].values())
    return {"split_ms": split, "device_idle_share": whole["device_idle_share"],
            "device_busy_ms": whole["device_busy_ms"], "profile_wall_ms": whole["wall_ms"],
            "top": whole["top"]}


def gnn_steps(tag, cfg, state, batch, labels, per_step: dict) -> dict:
    """``GNN_WARMUP + GNN_TIMED`` train steps timed with CUDA events, the
    peak memory over them (the batch and state included), one more step
    profiled and split.  ``per_step`` names units of work per step (edges,
    graphs); each is reported per second."""
    import math

    import torch

    from repro_torch.launch.train import gnn_train_step

    step = gnn_train_step(cfg, GNN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    for _ in range(GNN_WARMUP + GNN_TIMED):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, (batch, labels))
        stop.record()
        events.append((start, stop))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    ms = sum(step_ms[GNN_WARMUP:]) / GNN_TIMED
    out = {"config": cfg.name, "nodes": batch.n_nodes, "edges": batch.n_edges,
           "graphs": batch.n_graphs, "step_ms": step_ms, "ms_per_step": ms,
           **{f"{unit}_per_s": n / (ms / 1e3) for unit, n in per_step.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": [float(x) for x in losses]}
    out.update(gnn_split(state, step, batch, labels))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"[gnn] {tag}: a loss is not finite: {out['losses']}")
    log(f"[gnn] {tag} {json.dumps(out)}")
    return out


def gnn_edge_chunk(cfg, params, batch) -> dict:
    """NequIP's forward with ``edge_chunk`` (a divisor of the edge count,
    below it) against the unchunked forward: energies within
    ``GNN_OUT_RTOL`` of their max, each timed and its peak measured."""
    import torch

    from repro_torch.models import gnn as G

    if not (batch.n_edges > GNN_EDGE_CHUNK and batch.n_edges % GNN_EDGE_CHUNK == 0):
        raise AssertionError(f"[gnn] edge_chunk {GNN_EDGE_CHUNK} does not divide {batch.n_edges} edges")
    chunked = dataclasses.replace(cfg, edge_chunk=GNN_EDGE_CHUNK)
    rec = {"config": cfg.name, "edges": batch.n_edges, "edge_chunk": GNN_EDGE_CHUNK}
    energies = {}
    with torch.no_grad():
        for name, c in (("unchunked", cfg), ("chunked", chunked)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            energies[name] = G.forward(params, c, batch)
            torch.cuda.synchronize()
            rec[f"{name}_max_memory_allocated"] = torch.cuda.max_memory_allocated()
            rec[f"{name}_forward_ms"] = time_ms(lambda: G.forward(params, c, batch), 3)
    want = energies["unchunked"]
    rec["rel"] = float((energies["chunked"] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not rec["rel"] <= GNN_OUT_RTOL:
        raise AssertionError(f"[gnn] edge_chunk forward off the unchunked by {rec['rel']:g} "
                             f"(limit {GNN_OUT_RTOL})")
    return rec


def cora_batch(g, feat):
    """A ``GraphBatch`` over ``synthetic_cora``'s graph (both directions of
    every edge), on ``feat``'s device."""
    import torch

    from repro_torch.models.gnn import GraphBatch

    dev = feat.device
    e, n = len(g.src), g.n
    return GraphBatch(node_feat=feat, positions=None,
                      src=torch.as_tensor(g.src, device=dev).long(),
                      dst=torch.as_tensor(g.dst, device=dev).long(),
                      edge_mask=torch.ones((e,), device=dev), node_mask=torch.ones((n,), device=dev),
                      graph_id=torch.zeros((n,), dtype=torch.int64, device=dev))


def minibatch_graph(device):
    """The minibatch cell's global graph on the card: ``GNN_MINIBATCH_GRAPH``
    uniform (src, dst) pairs from a seeded generator, grouped into a CSR by
    destination with a stable ``torch.sort``, and seeded normal features."""
    import torch

    n, e, d = GNN_MINIBATCH_GRAPH
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.randint(0, n, (e,), generator=gen, device=device)
    dst = torch.randint(0, n, (e,), generator=gen, device=device)
    dst, order = torch.sort(dst, stable=True)
    col_idx = src[order]
    del src, order
    row_ptr = torch.zeros((n + 1,), dtype=torch.int64, device=device)
    row_ptr[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    del dst
    return row_ptr, col_idx, torch.randn((n, d), generator=gen, device=device)


def gnn_launcher() -> dict:
    """``python -m repro_torch.launch.train --arch gcn-cora --steps 20``
    with no ``--device``: ``make_gnn_job`` and ``TrainLoop`` on the card."""
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gcn-cora", "--steps", "20"]
    t0 = time.perf_counter()
    proc = subprocess.run(args, capture_output=True, text=True, timeout=300, cwd=str(HERE),
                          env=dict(os.environ, PYTHONPATH=str(HERE / "src")))
    rec = {"command": " ".join(args[1:]), "s": time.perf_counter() - t0,
           "returncode": proc.returncode, "stdout": proc.stdout.strip().splitlines()[-2:]}
    if proc.returncode != 0 or "done 20 steps" not in proc.stdout:
        raise AssertionError(f"[gnn] launcher failed: {rec} {proc.stderr[-2000:]}")
    return rec


def gnn_path(device) -> dict:
    """Phase 8g (``[gnn]``): the gates (card vs CPU for the four GNN
    configs at full width, equivariance, the sampler, bitwise repeats),
    then the training runs at ogb_products, minibatch_lg and molecule, and
    the launcher on the card."""
    import torch

    from repro_torch.configs import gat_cora, gcn_cora, mace, nequip
    from repro_torch.core.prng import prng_key
    from repro_torch.data.pipeline import graph_batch_from_shape, synthetic_cora
    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw_init

    t_start = time.perf_counter()
    before = wrapper_launches()
    out = {"gates": {}, "runs": {}}
    gcn, gat = gcn_cora.CONFIG, gat_cora.CONFIG

    def state_of(cfg, d_in):
        params = G.init_model(cfg, d_in, seed=0, device=device)
        return {"params": params, "opt": adamw_init(params)}

    # card vs CPU: GCN and GAT on Cora, NequIP and MACE on the molecule cell
    g, feat, labels = synthetic_cora(device=device)
    cora = cora_batch(g, feat)
    for cfg in (gcn, gat):
        out["gates"][cfg.name] = gnn_card_vs_cpu(
            cfg, G.init_model(cfg, feat.shape[1], seed=0, device=device), cora, labels)
    del g, feat, labels, cora
    atoms, edges, d_mol, graphs = GNN_MOLECULE
    mol, _ = graph_batch_from_shape(atoms, edges, d_mol, batch_graphs=graphs, device=device)
    energies = torch.zeros((graphs,), device=device)
    for cfg in (nequip.CONFIG, mace.CONFIG):
        state = state_of(cfg, d_mol)
        rec = gnn_card_vs_cpu(cfg, state["params"], mol, energies)
        rec["equivariance_rel"] = gnn_equivariance(cfg, state["params"], mol)
        if cfg.model == "nequip":
            out["edge_chunk"] = gnn_edge_chunk(cfg, state["params"], mol)
        else:
            rec["repeat_bitwise"] = gnn_repeat(cfg, state, mol, energies)
        out["gates"][cfg.name] = rec
        out["runs"][f"{cfg.name}_molecule"] = gnn_steps(f"{cfg.name} molecule", cfg, state, mol,
                                                        energies, {"graphs": graphs})
    log(f"[gnn] gates {json.dumps(out['gates'])}")
    log(f"[gnn] edge_chunk {json.dumps(out['edge_chunk'])}")
    del mol, energies, state
    torch.cuda.empty_cache()
    log(f"[time] [gnn] gates and molecule runs done in {time.perf_counter() - t_start:.1f} s")

    # ogb_products: GCN, then GAT if its step fits the card
    t0 = time.perf_counter()
    n, e, d = GNN_FULL_GRAPH
    big, big_labels = graph_batch_from_shape(n, e, d, with_positions=False, device=device)
    out["ogb_products_generate_s"] = time.perf_counter() - t0
    state = state_of(gcn, d)
    out["gates"]["gcn_ogb_products_repeat_bitwise"] = gnn_repeat(gcn, state, big, big_labels)
    out["runs"]["gcn_ogb_products"] = gnn_steps("gcn ogb_products", gcn, state, big, big_labels,
                                                {"edges": e})
    del state
    torch.cuda.empty_cache()
    gat_at_ogb = {"config": gat.name}
    try:
        out["runs"]["gat_ogb_products"] = gnn_steps("gat ogb_products", gat, state_of(gat, d), big,
                                                    big_labels, {"edges": e})
        gat_at_ogb["trained"] = True
    except torch.cuda.OutOfMemoryError as err:
        # the step does not fit: record where it stopped, then the forward
        gat_at_ogb.update(trained=False, error=str(err).splitlines()[0][:300],
                          max_memory_allocated_at_failure=torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    if not gat_at_ogb["trained"]:
        params = G.init_model(gat, d, seed=0, device=device)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            gat_at_ogb["forward_ms"] = time_ms(lambda: G.forward(params, gat, big), 2)
        gat_at_ogb["forward_max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del params
    out["gat_ogb_products"] = gat_at_ogb
    log(f"[gnn] gat ogb_products {json.dumps(gat_at_ogb)}")
    del big, big_labels
    torch.cuda.empty_cache()
    log(f"[time] [gnn] ogb_products done in {time.perf_counter() - t0:.1f} s")

    # minibatch_lg: the CSR on the card, the sampler, a GCN and a GAT step
    t0 = time.perf_counter()
    row_ptr, col_idx, features = minibatch_graph(device)
    torch.cuda.synchronize()
    sampler = {"nodes": row_ptr.numel() - 1, "edges": col_idx.numel(), "seeds": GNN_SEEDS,
               "fanouts": list(GNN_FANOUTS), "csr_build_s": time.perf_counter() - t0}
    seeds = torch.randperm(sampler["nodes"], generator=torch.Generator().manual_seed(0))[:GNN_SEEDS]
    seeds = seeds.to(device)
    key = prng_key(0, device=device)
    flow = G.sample_node_flow(key, row_ptr, col_idx, seeds, GNN_FANOUTS)
    cpu_flow = G.sample_node_flow(prng_key(0), row_ptr.cpu(), col_idx.cpu(), seeds.cpu(), GNN_FANOUTS)
    sampler["card_equals_cpu"] = all(torch.equal(a.cpu(), b) for a, b in zip(
        flow.layer_nodes + flow.layer_valid, cpu_flow.layer_nodes + cpu_flow.layer_valid))
    if not sampler["card_equals_cpu"]:
        raise AssertionError("[gnn] the sampler's draws on the card differ from the CPU's")
    sampler["ms_per_sample"] = time_ms(lambda: G.sample_node_flow(key, row_ptr, col_idx, seeds,
                                                                   GNN_FANOUTS), GNN_SAMPLE_REPS)
    sampler["ms_per_flow_to_batch"] = time_ms(lambda: G.node_flow_to_batch(flow, features),
                                              GNN_SAMPLE_REPS)
    sampled = G.node_flow_to_batch(flow, features)
    del row_ptr, col_idx, features, cpu_flow
    sampler.update(batch_nodes=sampled.n_nodes, batch_edges=sampled.n_edges,
                   valid_nodes=int(sampled.node_mask.sum()))
    out["sampler"] = sampler
    log(f"[gnn] sampler {json.dumps(sampler)}")
    flow_labels = torch.randint(0, gcn.n_classes, (sampled.n_nodes,),
                                generator=torch.Generator().manual_seed(1)).to(device)
    d_flow = sampled.node_feat.shape[1]
    for cfg in (gcn, gat):
        out["runs"][f"{cfg.name}_minibatch_lg"] = gnn_steps(
            f"{cfg.name} minibatch_lg", cfg, state_of(cfg, d_flow), sampled, flow_labels,
            {"edges": sampled.n_edges, "seeds": GNN_SEEDS})
    del sampled, flow
    torch.cuda.empty_cache()
    log(f"[time] [gnn] minibatch_lg done in {time.perf_counter() - t0:.1f} s")

    out["launcher"] = gnn_launcher()
    log(f"[gnn] launcher {json.dumps(out['launcher'])}")
    after = wrapper_launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    if any(out["launches"].values()):
        raise AssertionError(f"[gnn] the GNN path launched a port kernel: {out['launches']}")
    out["s"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 8h: the two-tower recommender, trained and served
# ---------------------------------------------------------------------------


def recsys_cell(name: str) -> dict:
    from repro_torch.configs.base import RECSYS_SHAPES

    return next(c for c in RECSYS_SHAPES if c.name == name).params


def recsys_cut(cfg, scale: float):
    """``cfg`` with each field's vocabulary cut to ``max(int(v * scale), 8)``,
    so the click stream draws inside the tables ``init_params`` builds."""
    def sizes(vs):
        return tuple(max(int(v * scale), 8) for v in vs)

    return dataclasses.replace(cfg, user_vocab_sizes=sizes(cfg.user_vocab_sizes),
                               item_vocab_sizes=sizes(cfg.item_vocab_sizes))


def recsys_vocab(cfg, scale: float) -> dict:
    return {"vocab_scale": scale, "user_vocab_sizes": list(cfg.user_vocab_sizes),
            "item_vocab_sizes": list(cfg.item_vocab_sizes)}


def recsys_flops(cfg, batch: int) -> float:
    """The reference cell's count (``src/repro/launch/cells.py``
    ``_recsys_flops``): the bags' adds and both towers' products."""
    d = cfg.embed_dim
    lookups = batch * (cfg.n_user_fields + cfg.n_item_fields) * cfg.multi_hot_per_field * d
    dims_u = [d * cfg.n_user_fields] + list(cfg.tower_mlp)
    mlp = sum(2.0 * a * b for a, b in zip(dims_u[:-1], dims_u[1:])) * 2 * batch
    return lookups + mlp


def tensor_bytes(tree) -> int:
    from repro_torch.train.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def rows_bytes(cfg, *indices) -> int:
    """Bytes of the distinct table rows the bags of ``indices`` read (each
    ``(b, fields, bag)``, field ``f`` of each its own table)."""
    import torch

    rows = sum(torch.unique(x[:, f]).numel() for x in indices for f in range(x.shape[1]))
    return rows * cfg.embed_dim * 4


def recsys_kernel_kind(name: str) -> str:
    """Products (cuBLAS/CUTLASS), the EmbeddingBag's gathers and their
    backward (index reads; the backward's sort, bincount and segment sums),
    and the rest (elementwise, reductions, fills)."""
    low = name.lower()
    if lm_kernel_kind(name) == "cublas_products":
        return "products"
    if any(t in low for t in ("embedding", "index", "gather", "radix", "sort", "histogram",
                              "segment")):
        return "embedding"
    return "rest"


def recsys_eval(params, cfg, uix, iix, log_q):
    """Both towers and the serving scores (no autograd), then the loss and
    every gradient leaf from zeroed gradients."""
    import torch

    from repro_torch.models import recsys as R
    from repro_torch.train.tree import tree_leaves

    leaves = tree_leaves(params)
    with torch.no_grad():
        outs = [*R.forward(params, cfg, uix, iix), R.serve_scores(params, cfg, uix, iix)]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = R.loss_fn(params, cfg, uix, iix, log_q)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return outs, loss.detach(), grads


def recsys_corpus(params, cfg, n: int, device, seed: int):
    """The item tower's vectors of ``n`` items (the click stream's item rows,
    ``RECSYS_CORPUS_CHUNK`` at a time), and the ms of the tower passes
    (CUDA events; the draws are made first)."""
    import torch

    from repro_torch.data.pipeline import click_batches
    from repro_torch.models import recsys as R

    stream = click_batches(cfg, RECSYS_CORPUS_CHUNK, seed=seed, device=device)
    chunks = [next(stream)[1] for _ in range(-(-n // RECSYS_CORPUS_CHUNK))]
    corpus = torch.empty((n, cfg.tower_mlp[-1]), device=device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.no_grad():
        for c, idx in enumerate(chunks):
            lo = c * RECSYS_CORPUS_CHUNK
            hi = min(lo + RECSYS_CORPUS_CHUNK, n)
            corpus[lo:hi] = R._encode(params["item_tables"], params["item_tower"], idx[:hi - lo])
    stop.record()
    torch.cuda.synchronize()
    return corpus, start.elapsed_time(stop)


def recsys_topk_gate(scores, cpu_scores) -> dict:
    """One query's top-``RECSYS_TOPK`` on the card against the CPU's: values
    within ``RECSYS_OUT_RTOL`` of the largest |score|, and the same ids but
    for near ties: where the two differ at a rank, the CPU's scores of both
    ids are within that tolerance, and the two sets of ids are equal unless
    the CPU's k-th and (k+1)-th scores are as near."""
    from repro_torch.models import recsys as R

    tol = RECSYS_OUT_RTOL * float(cpu_scores.abs().max())
    values, ids = (t.cpu() for t in R.retrieval_topk(scores, RECSYS_TOPK))
    cpu_values, cpu_ids = R.retrieval_topk(cpu_scores, RECSYS_TOPK + 1)
    swapped = ids != cpu_ids[:-1]
    near = (cpu_scores[ids] - cpu_scores[cpu_ids[:-1]]).abs() <= tol
    rec = {"value_err": float((values - cpu_values[:-1]).abs().max()), "tol": tol,
           "swapped_ranks": int(swapped.sum()),
           "edge_gap": float(cpu_values[-2] - cpu_values[-1]),
           "same_ids": set(ids.tolist()) == set(cpu_ids[:-1].tolist())}
    if rec["value_err"] > tol or not bool(near[swapped].all()) or \
            (rec["edge_gap"] > tol and not rec["same_ids"]):
        raise AssertionError(f"[recsys] retrieval top-{RECSYS_TOPK}: card vs CPU {rec}")
    return rec


def recsys_nan_gate(table) -> dict:
    """Bags holding an index past the table (and one below ``-rows``) are NaN
    on the card as on the CPU, a negative index ``>= -rows`` wraps, and the
    card's context survives (no device-side assert)."""
    import torch

    from repro_torch.models import recsys as R

    rows = table.shape[0]
    idx = torch.tensor([[0, 1, 2, 3], [rows, 0, 1, 2], [-1, -rows, 5, 6], [4, -rows - 1, 7, 8]])
    got = R.embedding_bag(table, idx.to(table.device)).cpu()
    want = R.embedding_bag(table.cpu(), idx)
    rec = {"rows": rows, "nan_bags": torch.isnan(got).all(-1).tolist(),
           "max_abs_err": float((got - want).nan_to_num().abs().max())}
    if rec["nan_bags"] != [False, True, False, True] or \
            not torch.equal(torch.isnan(got), torch.isnan(want)) or \
            rec["max_abs_err"] > RECSYS_OUT_RTOL * float(want.nan_to_num().abs().max()):
        raise AssertionError(f"[recsys] out-of-range bags: {rec}")
    return rec


def recsys_repeat(cfg, device) -> dict:
    """One ``make_recsys_job`` step from copies of one state, twice: loss,
    gradient norm, gradients and the updated state equal bit for bit."""
    import torch

    from repro_torch.launch.train import make_recsys_job
    from repro_torch.train.tree import tree_leaves, tree_map

    rep_cfg = recsys_cut(cfg, RECSYS_REPEAT_VOCAB)
    state, step, data = make_recsys_job(rep_cfg, RECSYS_REPEAT_BATCH, RECSYS_LR, device=device)
    batch = next(data(0))
    runs = []
    for _ in range(2):
        state_i, metrics = step(tree_map(lambda t: t.detach().clone(), state), batch)
        runs.append([metrics["loss"], metrics["gnorm"],
                     *(p.grad for p in tree_leaves(state_i["params"])),
                     *(t.detach() for t in tree_leaves(state_i))])
    rec = {**recsys_vocab(rep_cfg, RECSYS_REPEAT_VOCAB), "batch": RECSYS_REPEAT_BATCH,
           "loss": float(runs[0][0]),
           "bitwise": len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))}
    if not rec["bitwise"]:
        raise AssertionError(f"[recsys] two make_recsys_job steps from one state differ: {rec}")
    return rec


def recsys_gates(cfg, device) -> dict:
    """Card against CPU at ``cfg``'s widths with the vocabulary cut to
    ``RECSYS_GATE_VOCAB``: towers, serving scores, the loss, every gradient
    leaf; top-k retrieval over a corpus of ``retrieval_cand``'s size; the
    out-of-range bags; then the bitwise repeat of a step."""
    import torch

    from repro_torch.data.pipeline import click_batches
    from repro_torch.models import recsys as R
    from repro_torch.train.tree import tree_map

    cpu = torch.device("cpu")
    gate_cfg = recsys_cut(cfg, RECSYS_GATE_VOCAB)
    params = R.init_params(gate_cfg, seed=0, device=device)
    batch = next(click_batches(gate_cfg, RECSYS_GATE_BATCH, seed=1, device=device))
    t0 = time.perf_counter()
    outs, loss, grads = recsys_eval(params, gate_cfg, *batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu_params = tree_map(lambda p: p.detach().to(cpu), params)
    t0 = time.perf_counter()
    cpu_outs, cpu_loss, cpu_grads = recsys_eval(cpu_params, gate_cfg, *(x.to(cpu) for x in batch))
    rec = {**recsys_vocab(gate_cfg, RECSYS_GATE_VOCAB), "batch": RECSYS_GATE_BATCH,
           "card_s": card_s, "cpu_s": time.perf_counter() - t0,
           "out_rel": dict(zip(("user", "item", "serve"), leaf_errors(outs, cpu_outs))),
           "loss": [float(loss), float(cpu_loss)],
           "loss_rel": abs(float(loss) - float(cpu_loss)) / max(abs(float(cpu_loss)), 1e-30),
           "worst_leaf": max(leaf_errors(grads, cpu_grads))}
    if max(rec["out_rel"].values()) > RECSYS_OUT_RTOL or rec["loss_rel"] > RECSYS_LOSS_RTOL or \
            rec["worst_leaf"] > RECSYS_GRAD_RTOL:
        raise AssertionError(f"[recsys] card vs CPU: {rec} (limits: outputs {RECSYS_OUT_RTOL}, "
                             f"loss {RECSYS_LOSS_RTOL}, leaves {RECSYS_GRAD_RTOL})")
    del grads, cpu_grads
    n = recsys_cell("retrieval_cand")["n_candidates"]
    corpus, _ = recsys_corpus(params, gate_cfg, n, device, seed=2)
    cpu_corpus = corpus.cpu()
    queries = next(click_batches(gate_cfg, RECSYS_GATE_QUERIES, seed=3, device=device))[0]
    with torch.no_grad():
        rec["retrieval"] = [recsys_topk_gate(
            R.retrieval_scores(params, gate_cfg, queries[q:q + 1], corpus),
            R.retrieval_scores(cpu_params, gate_cfg, queries[q:q + 1].cpu(), cpu_corpus))
            for q in range(RECSYS_GATE_QUERIES)]
        rec["nan_bags"] = recsys_nan_gate(params["user_tables"][0].detach())
    del params, cpu_params, corpus, cpu_corpus
    torch.cuda.empty_cache()
    rec["repeat"] = recsys_repeat(cfg, device)
    return rec


def recsys_split(state, step, batch, cfg) -> dict:
    """Device time of one train step by :func:`recsys_kernel_kind`, with the
    loss head (the (b, b) logits, logQ, log-softmax, the NLL and their
    backward, from unit vectors of the towers' shape) and the optimizer
    (clipping and AdamW on the step's gradients) profiled alone and taken
    out of the kinds they run: what is left of the products is the towers'."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_map

    whole = device_profile(lambda: (step(state, batch), torch.cuda.synchronize()), recsys_kernel_kind)
    device, b, d = batch[0].device, batch[0].shape[0], cfg.tower_mlp[-1]
    gen = torch.Generator(device=device).manual_seed(7)
    u, i = (F.normalize(torch.randn((b, d), generator=gen, device=device), dim=-1).requires_grad_(True)
            for _ in range(2))
    head = device_profile(lambda: (R._sampled_softmax(u, i, cfg, batch[2]).backward(),
                                   torch.cuda.synchronize()), recsys_kernel_kind)
    del u, i
    params = state["params"]
    grads = tree_map(lambda p: p.grad, params)
    optimizer = device_profile(lambda: (adamw_update(clip_by_global_norm(grads, 1.0)[0],
                                                     state["opt"], params, RECSYS_LR),
                                        torch.cuda.synchronize()), recsys_kernel_kind)
    split = dict(whole["split_ms"])
    for part in (head, optimizer):
        for kind, ms in part["split_ms"].items():
            split[kind] = split.get(kind, 0.0) - ms
    return {"split_ms": {"embedding": split.get("embedding", 0.0),
                         "tower_products": split.get("products", 0.0),
                         "logits_and_softmax": sum(head["split_ms"].values()),
                         "optimizer": sum(optimizer["split_ms"].values()),
                         "rest": split.get("rest", 0.0)},
            "device_idle_share": whole["device_idle_share"],
            "device_busy_ms": whole["device_busy_ms"], "profile_wall_ms": whole["wall_ms"],
            "top": whole["top"]}


def recsys_train(cfg, device) -> dict:
    """``train_batch``: ``make_recsys_job`` at the cell's batch with the
    vocabulary cut to ``RECSYS_TRAIN_VOCAB``, its batches drawn first,
    ``RECSYS_TRAIN_WARMUP`` steps then ``RECSYS_TRAIN_TIMED`` timed (CUDA
    events), the peak memory over them, one more step profiled and split."""
    import math

    import torch

    from portbench.roofline import PEAK_FP32_FLOPS, bound_s
    from repro_torch.launch.train import make_recsys_job
    from repro_torch.train.tree import tree_leaves

    b = recsys_cell("train_batch")["batch"]
    train_cfg = recsys_cut(cfg, RECSYS_TRAIN_VOCAB)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, data = make_recsys_job(train_cfg, b, RECSYS_LR, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = data(0)
    batches = [next(stream) for _ in range(RECSYS_TRAIN_WARMUP + RECSYS_TRAIN_TIMED + 1)]
    events, losses = [], []
    for batch in batches[:-1]:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        events.append((start, stop))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(z) for a, z in events]
    ms = sum(step_ms[RECSYS_TRAIN_WARMUP:]) / RECSYS_TRAIN_TIMED
    flops = 3.0 * (recsys_flops(train_cfg, b) + 2.0 * b * b * train_cfg.tower_mlp[-1])
    # compulsory bytes: parameters and AdamW's moments read and written once
    nbytes = 2 * (tensor_bytes(state["params"]) + tensor_bytes(state["opt"])) + tensor_bytes(batches[0])
    bound, bound_by = bound_s(nbytes, flops)
    out = {"cell": "train_batch", **recsys_vocab(train_cfg, RECSYS_TRAIN_VOCAB), "batch": b,
           "parameters": sum(p.numel() for p in tree_leaves(state["params"])),
           "table_bytes": tensor_bytes(state["params"]["user_tables"] + state["params"]["item_tables"]),
           "init_s": init_s, "step_ms": step_ms, "ms_per_step": ms,
           "examples_per_s": b / (ms / 1e3), "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_flops_per_step": flops, "bound_ms": bound * 1e3, "bound_by": bound_by,
           "model_flop_share": flops / PEAK_FP32_FLOPS / (ms / 1e3),
           "losses": [float(x) for x in losses]}
    out.update(recsys_split(state, step, batches[-1], train_cfg))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"[recsys] train_batch: a loss is not finite: {out['losses']}")
    return out


def recsys_latency(fn, inputs) -> dict:
    """``fn`` on each input in turn, its result copied to the host: the first
    ``RECSYS_WARMUP`` untimed, the rest each timed with CUDA events (from
    its first launch to its last) and on the host clock (until its result is
    on the host); p50/p99 of both, then the device's idle share over 20
    more profiled."""
    import numpy as np
    import torch

    def to_host(y):
        return [t.cpu() for t in (y if isinstance(y, tuple) else (y,))]

    events, host_ms = [], []
    for n, x in enumerate(inputs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        y = fn(x)
        stop.record()
        to_host(y)
        if n >= RECSYS_WARMUP:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            events.append((start, stop))
    torch.cuda.synchronize()
    device_ms = [a.elapsed_time(z) for a, z in events]
    profile = device_profile(lambda: [to_host(fn(x)) for x in inputs[:20]])
    return {"requests": len(device_ms),
            "device_ms_p50": float(np.percentile(device_ms, 50)),
            "device_ms_p99": float(np.percentile(device_ms, 99)),
            "host_ms_p50": float(np.percentile(host_ms, 50)),
            "host_ms_p99": float(np.percentile(host_ms, 99)),
            "host_ms_mean": float(np.mean(host_ms)),
            "device_idle_share": profile["device_idle_share"], "profile_top": profile["top"]}


def recsys_serve(cfg, device) -> dict:
    """``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` on one set of
    parameters with the vocabulary cut to ``RECSYS_SERVE_VOCAB``, each
    beside its bound (the operations of both towers, or of the item tower
    for the corpus; the bytes of the distinct table rows read, the tower
    weights and the corpus)."""
    import torch

    from portbench.roofline import bound_s
    from repro_torch.data.pipeline import click_batches
    from repro_torch.models import recsys as R

    serve_cfg = recsys_cut(cfg, RECSYS_SERVE_VOCAB)
    d = serve_cfg.tower_mlp[-1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = R.init_params(serve_cfg, seed=0, device=device)
    torch.cuda.synchronize()
    towers = tensor_bytes([params["user_tower"], params["item_tower"]])
    out = {"cut": {**recsys_vocab(serve_cfg, RECSYS_SERVE_VOCAB), "init_s": time.perf_counter() - t0,
                   "table_bytes": tensor_bytes([params["user_tables"], params["item_tables"]])}}
    with torch.no_grad():
        # serve_p99: one request of the cell's batch at a time
        b = recsys_cell("serve_p99")["batch"]
        stream = click_batches(serve_cfg, b, seed=11, device=device)
        requests = [next(stream)[:2] for _ in range(RECSYS_WARMUP + RECSYS_REQUESTS)]
        rec = {"cell": "serve_p99", "batch": b,
               **recsys_latency(lambda x: R.serve_scores(params, serve_cfg, *x), requests)}
        bound, rec["bound_by"] = bound_s(rows_bytes(serve_cfg, *requests[-1]) + towers + 4 * b,
                                         recsys_flops(serve_cfg, b) + 2.0 * b * d)
        rec["bound_ms"] = bound * 1e3
        out["serve_p99"] = rec
        log(f"[recsys] serve_p99 {json.dumps(rec)}")
        del requests

        # serve_bulk: the cell's batch in one call
        b = recsys_cell("serve_bulk")["batch"]
        uix, iix, _ = next(click_batches(serve_cfg, b, seed=12, device=device))
        torch.cuda.reset_peak_memory_stats()
        scores = R.serve_scores(params, serve_cfg, uix, iix)
        if not bool(torch.isfinite(scores).all()):
            raise AssertionError("[recsys] serve_bulk: a score is not finite")
        ms = time_ms(lambda: R.serve_scores(params, serve_cfg, uix, iix), RECSYS_BULK_REPS)
        rec = {"cell": "serve_bulk", "batch": b, "chunk_rows": b, "ms": ms,
               "rows_per_s": b / (ms / 1e3), "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "distinct_row_bytes": rows_bytes(serve_cfg, uix, iix),
               "flops": recsys_flops(serve_cfg, b) + 2.0 * b * d}
        bound, rec["bound_by"] = bound_s(rec["distinct_row_bytes"] + towers + 4 * b, rec["flops"])
        rec["bound_ms"] = bound * 1e3
        out["serve_bulk"] = rec
        log(f"[recsys] serve_bulk {json.dumps(rec)}")
        del uix, iix, scores

        # retrieval_cand: the corpus built once, then one query at a time
        cell = recsys_cell("retrieval_cand")
        n = cell["n_candidates"]
        corpus, build_ms = recsys_corpus(params, serve_cfg, n, device, seed=13)
        build_bound = bound_s(corpus.numel() * 4, recsys_flops(serve_cfg, n) / 2)
        stream = click_batches(serve_cfg, cell["batch"], seed=14, device=device)
        queries = [next(stream)[0] for _ in range(RECSYS_WARMUP + RECSYS_REQUESTS)]
        rec = {"cell": "retrieval_cand", "n_candidates": n, "k": RECSYS_TOPK,
               "corpus_chunk": RECSYS_CORPUS_CHUNK, "corpus_build_ms": build_ms,
               "corpus_build_bound_ms": build_bound[0] * 1e3, "corpus_build_bound_by": build_bound[1],
               **recsys_latency(lambda q: R.retrieval_topk(
                   R.retrieval_scores(params, serve_cfg, q, corpus), RECSYS_TOPK), queries)}
        bound, rec["bound_by"] = bound_s(
            corpus.numel() * 4 + towers / 2 + rows_bytes(serve_cfg, queries[-1]),
            2.0 * n * d + recsys_flops(serve_cfg, 1) / 2)
        rec["bound_ms"] = bound * 1e3
        out["retrieval_cand"] = rec
        log(f"[recsys] retrieval_cand {json.dumps(rec)}")
    del params, corpus, queries
    torch.cuda.empty_cache()
    return out


def recsys_path(device) -> dict:
    """Phase 8h (``[recsys]``): the gates, then ``train_batch`` and the three
    serving cells of ``RECSYS_SHAPES`` at two-tower-retrieval's published
    widths, each with its vocabulary cut."""
    import torch

    from repro_torch.configs.two_tower_retrieval import CONFIG

    t_start = time.perf_counter()
    before = wrapper_launches()
    out = {"card": card_line(), "gates": recsys_gates(CONFIG, device)}
    log(f"[recsys] gates {json.dumps(out['gates'])}")
    log(f"[time] [recsys] gates done in {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    out["train_batch"] = recsys_train(CONFIG, device)
    log(f"[recsys] train_batch {json.dumps(out['train_batch'])}")
    torch.cuda.empty_cache()
    log(f"[time] [recsys] train_batch done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out.update(recsys_serve(CONFIG, device))
    log(f"[recsys] cut {json.dumps(out['cut'])}")
    log(f"[time] [recsys] serving cells done in {time.perf_counter() - t0:.1f} s")
    after = wrapper_launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    if any(out["launches"].values()):
        raise AssertionError(f"[recsys] the recsys path launched a port kernel: {out['launches']}")
    out["s"] = time.perf_counter() - t_start
    log(f"[recsys] card {out['card']} launches {json.dumps(out['launches'])} in {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8i: the launch tooling
# ---------------------------------------------------------------------------


def start_launch_sweep(out_dir: str):
    """Start the dry run of every cell on both meshes in a CPU subprocess
    (``meta`` tensors, no card), at a lower scheduling priority than the
    phases it runs beside; ``launch_sweep`` reads what it wrote."""
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log_file = open(os.path.join(out_dir, "sweep.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both",
         "--include-subgraph", "--out", os.path.join(out_dir, "records")],
        env=env, stdout=log_file, stderr=subprocess.STDOUT, cwd=str(HERE),
        preexec_fn=lambda: os.nice(LAUNCH_SWEEP_NICE))
    return {"proc": proc, "dir": out_dir, "t0": time.perf_counter(), "log": log_file}


def stop_launch_sweep(sweep) -> None:
    proc = sweep["proc"]
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)
    sweep["log"].close()


def launch_sweep(sweep) -> dict:
    """Wait for the sweep, print one line per cell, and fail unless every
    cell of ``all_cells(include_subgraph=True)`` was analysed on both
    meshes."""
    from repro_torch.configs.registry import all_cells

    import re

    proc = sweep["proc"]
    rc = proc.wait(timeout=LAUNCH_SWEEP_TIMEOUT_S)
    waited = time.perf_counter() - sweep["t0"]
    sweep["log"].close()
    out_log = Path(sweep["dir"], "sweep.log").read_text()
    if rc != 0:
        raise AssertionError(f"[launch] the dry run failed (exit {rc}):\n{out_log[-4000:]}")
    seconds = float(re.search(r"ALL CELLS ANALYSED in ([0-9.]+) s", out_log)[1])
    rows = []
    for arch, shape in all_cells(include_subgraph=True):
        for mesh_name in ("single", "multi"):
            path = Path(sweep["dir"], "records", f"{arch}__{shape.name}__{mesh_name}.json")
            if not path.is_file():
                raise AssertionError(f"[launch] no dry-run record for {path.name}")
            rec = json.loads(path.read_text())
            gb = rec["per_device_memory_bytes"] / 1e9
            log(f"[launch] cell {arch} {shape.name} {mesh_name}: {rec['bottleneck']} "
                f"{gb:.2f} GB/device fits_80GB={rec['fits_80GB']} "
                f"(compute {rec['compute_s']:.3e} s, memory {rec['memory_s']:.3e} s, "
                f"collective {rec['collective_s']:.3e} s)")
            rows.append({"cell": f"{arch}/{shape.name}/{mesh_name}", "bottleneck": rec["bottleneck"],
                         "gb": gb, "fits_80GB": rec["fits_80GB"]})
    log(f"[launch] dry run: {len(rows)} cells analysed in {seconds:.1f} s in its CPU subprocess, "
        f"read {waited:.1f} s after it started")
    return {"cells": len(rows), "s": seconds, "read_after_s": waited, "rows": rows,
            "fit": sum(r["fits_80GB"] for r in rows)}


def launch_train_cell(cfg, depth: int, batch: int):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import AbstractMesh

    shape = ShapeCell("train_4k", "train", {"seq_len": LAUNCH_SEQ, "global_batch": batch})
    return build_cell("granite-8b", shape, AbstractMesh((1, 1), ("data", "model")),
                      cfg_override=dataclasses.replace(cfg, n_layers=depth))


def launch_batch(cfg) -> tuple:
    """The per-device batch: the single-pod mesh's, halved while the dry
    run's prediction at the deeper depth exceeds ``LAUNCH_FIT_BYTES``."""
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh((1, 1), ("data", "model"))
    batch, cuts = LAUNCH_TRAIN_BATCH, []
    while True:
        report, _ = analyze_cell(launch_train_cell(cfg, LAUNCH_DEPTHS[-1], batch), mesh, "one")
        if report.per_device_memory_bytes <= LAUNCH_FIT_BYTES or batch == 1:
            return batch, cuts
        cuts.append({"batch": batch, "predicted_gb": report.per_device_memory_bytes / 1e9})
        log(f"[launch] cut: batch {batch} x {LAUNCH_SEQ} predicted "
            f"{report.per_device_memory_bytes / 1e9:.2f} GB > {LAUNCH_FIT_BYTES / 1e9:.0f} GB; "
            f"halved")
        batch //= 2


def launch_calibrate(cfg, depth: int, batch: int, comm, device) -> dict:
    """granite-8b's train_4k cell step at ``depth`` layers on this rank:
    the gates against ``make_lm_job``'s step, the FLOP count against the
    meta count, ms per step and peak memory against the dry run."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import sharded
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.train import make_lm_job
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import tree_leaves

    cell = launch_train_cell(cfg, depth, batch)
    report, counts = analyze_cell(cell, comm.mesh, "one")
    # the single-device job at the cell step's learning rate and loss chunk
    state, job_step, data = make_lm_job(dataclasses.replace(cfg, n_layers=depth), batch, LAUNCH_SEQ,
                                        sharded.LR, device=device, loss_chunk=sharded.LOSS_CHUNK)
    tokens, labels = next(iter(data(0)))
    params = state["params"]
    def host(t):
        return t.detach().to("cpu", copy=True)

    init = [host(p) for p in tree_leaves(params)]
    state, metrics = job_step(state, (tokens, labels))
    want_loss = host(metrics["loss"])
    want = [host(p) for p in tree_leaves(params)]
    del state, metrics

    def reset():
        with torch.no_grad():
            for p, p0 in zip(tree_leaves(params), init):
                p.copy_(p0)
        return adamw_init(params)

    runs = []
    for _ in range(2):
        opt = None
        opt = reset()
        params, opt, m = cell.fn(comm, params, opt, tokens, labels)
        runs.append(([host(p) for p in tree_leaves(params)], host(m["loss"])))
    bitwise = all(torch.equal(a, b) for a, b in zip(runs[0][0], want)) and \
        torch.equal(runs[0][1], want_loss)
    repeat = all(torch.equal(a, b) for a, b in zip(runs[1][0], runs[0][0])) and \
        torch.equal(runs[1][1], runs[0][1])
    del runs, want, init
    with FlopCounterMode(display=False) as fc:
        params, opt, m = cell.fn(comm, params, opt, tokens, labels)
    card_flops = float(fc.get_total_flops())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    start.record()
    for _ in range(LAUNCH_TIMED):
        params, opt, m = cell.fn(comm, params, opt, tokens, labels)
        losses.append(m["loss"])
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / LAUNCH_TIMED
    peak = torch.cuda.max_memory_allocated()
    out = {
        "depth": depth, "batch": batch, "seq": LAUNCH_SEQ, "ms_per_step": ms, "peak_gb": peak / 1e9,
        "predicted_gb": report.per_device_memory_bytes / 1e9,
        "predicted_over_measured": report.per_device_memory_bytes / peak,
        "meta_flops": counts["flops"], "card_flops": card_flops,
        "model_flops": cell.model_flops,
        "roofline_s": {"compute": report.compute_s, "memory": report.memory_s,
                       "collective": report.collective_s},
        "step_over_compute": ms / 1e3 / report.compute_s,
        "step_over_memory": ms / 1e3 / report.memory_s,
        "bottleneck": report.bottleneck,
        "bitwise_vs_make_lm_job": bitwise, "repeat_bitwise": repeat,
        "losses": [float(x) for x in losses],
    }
    del params, opt
    torch.cuda.empty_cache()
    return out


def launch_prefill(cfg, comm, device) -> dict:
    """prefill_32k's cell step at ``LAUNCH_PREFILL_LAYERS`` layers against
    ``transformer.prefill`` on the same weights and tokens."""
    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=LAUNCH_PREFILL_LAYERS)
    b, s = LAUNCH_PREFILL_BATCH, LAUNCH_PREFILL_SEQ
    cell = build_cell("granite-8b", ShapeCell("prefill_32k", "prefill",
                                              {"seq_len": s, "global_batch": b}),
                      comm.mesh, cfg_override=cfg2)
    report, counts = analyze_cell(cell, comm.mesh, "one")
    params = T.init_params(cfg2, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg2.vocab_size, (b, s), generator=gen, device=device)
    logits, want_caches = T.prefill(params, cfg2, tokens, T.init_kv_cache(cfg2, b, s, device=device))
    want = logits[:, -1].clone()
    del logits
    torch.cuda.empty_cache()
    caches = T.init_kv_cache(cfg2, b, s, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got, caches = cell.fn(comm, params, caches, tokens)
    stop.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bitwise = torch.equal(got, want) and all(
        torch.equal(a[k], w[k]) for a, w in zip(caches, want_caches) for k in a)
    out = {"layers": LAUNCH_PREFILL_LAYERS, "batch": b, "seq": s, "dtype": cfg2.dtype,
           "ms": start.elapsed_time(stop), "peak_gb": peak / 1e9,
           "predicted_gb": report.per_device_memory_bytes / 1e9,
           "predicted_over_measured": report.per_device_memory_bytes / peak,
           "meta_flops": counts["flops"], "bottleneck": report.bottleneck,
           "roofline_s": {"compute": report.compute_s, "memory": report.memory_s},
           "bitwise_vs_prefill": bitwise, "finite": bool(torch.isfinite(got.float()).all())}
    del params, caches, want_caches, got, want
    torch.cuda.empty_cache()
    return out


def launch_vectorized(device) -> dict:
    """u12's one-coloring mesh count, ``vectorized`` against ``loop``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.counting import build_counting_plan
    from repro_torch.core.distributed import make_distributed_count_fn, shard_graph
    from repro_torch.core.graph import rmat_graph
    from repro_torch.core.templates import get_template

    n = 1 << LAUNCH_VEC_LOG_N
    graph = rmat_graph(n, 8 * n, seed=1)
    plan = build_counting_plan(get_template("u12"))
    widest = max(t.n_out * t.n_splits for t in plan.tables if t is not None)
    sg = shard_graph(graph, dist.get_world_size())
    colors = np.random.default_rng(3).integers(0, plan.k, sg.n_padded).astype(np.int32)
    out = {"n": n, "directed_edges": int(graph.num_directed),
           "widest_gather_gb": 2 * sg.n_padded * widest * 4 / 1e9}
    for mode, cb in (("vectorized", None), ("loop", 128)):
        fn = make_distributed_count_fn(plan, dist.group.WORLD, sg.n_padded, sg.edges_per_shard,
                                       column_batch=cb, ema_mode=mode, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        total = float(fn(colors, sg.src, sg.dst_local, sg.edge_mask))
        torch.cuda.synchronize()
        out[mode] = {"total": total, "s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del fn
        torch.cuda.empty_cache()
    v, lp = out["vectorized"]["total"], out["loop"]["total"]
    out["rel_diff"] = abs(v - lp) / abs(lp) if lp else float("inf")
    return out


def launch_rank(rank, world, device_type) -> dict:
    """The card half of ``[launch]`` (one rank that ``run_ranks`` spawned):
    the train and prefill cells on mesh (1, 1), then the vectorized eMA."""
    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.launch.mesh import AbstractMesh, realize_mesh
    from repro_torch.launch.sharded import Comm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    mesh = AbstractMesh((1, 1), ("data", "model"))
    comm = Comm(mesh, rank, realize_mesh(mesh, device.type))
    before = wrapper_launches()
    batch, cuts = launch_batch(CONFIG)
    train = [launch_calibrate(CONFIG, depth, batch, comm, device) for depth in LAUNCH_DEPTHS]
    prefill = launch_prefill(CONFIG, comm, device)
    vectorized = launch_vectorized(device)
    after = wrapper_launches()
    return {"train": train, "cuts": cuts, "prefill": prefill, "vectorized": vectorized,
            "launches": {k: after[k] - before[k] for k in after}, "collectives": len(comm.log)}


def launch_path(device, sweep) -> dict:
    """Phase 8i (``[launch]``): the dry run's records, then the card half in
    one NCCL rank, its gates, and the probe's fit to full depth."""
    import torch

    from repro_torch.launch.probes import affine_fit
    from repro_torch.testing.ranks import run_ranks

    t_start = time.perf_counter()
    before = wrapper_launches()
    out = {"card": card_line(), "sweep": launch_sweep(sweep)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank = run_ranks(launch_rank, 1, args=(device.type,),
                     backend="nccl" if device.type == "cuda" else "gloo",
                     timeout_s=LAUNCH_TIMEOUT_S)[0]
    out.update(rank, rank_wall_s=time.perf_counter() - t0)
    for rec in out["train"]:
        log(f"[launch] train_4k L={rec['depth']} b={rec['batch']}x{rec['seq']}: "
            f"{rec['ms_per_step']:.1f} ms/step, peak {rec['peak_gb']:.2f} GB, predicted "
            f"{rec['predicted_gb']:.2f} GB ({rec['predicted_over_measured']:.3f} of measured), "
            f"step over roofline compute {rec['step_over_compute']:.2f}x memory "
            f"{rec['step_over_memory']:.2f}x ({rec['bottleneck']}-bound), FLOPs card "
            f"{rec['card_flops']:.6e} meta {rec['meta_flops']:.6e}, bitwise vs make_lm_job "
            f"{rec['bitwise_vs_make_lm_job']}, repeat {rec['repeat_bitwise']}")
        if rec["card_flops"] != rec["meta_flops"]:
            raise AssertionError(f"[launch] L={rec['depth']}: FlopCounterMode on the card "
                                 f"{rec['card_flops']} != the meta count {rec['meta_flops']}")
        if not rec["bitwise_vs_make_lm_job"]:
            raise AssertionError(f"[launch] L={rec['depth']}: the one-rank sharded step differs "
                                 "from make_lm_job's single-device step")
        if not rec["repeat_bitwise"]:
            raise AssertionError(f"[launch] L={rec['depth']}: a repeat of the step differs")
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise AssertionError(f"[launch] L={rec['depth']}: a loss is not finite {rec['losses']}")
    (l1, t1), (l2, t2) = [(r["depth"], r) for r in out["train"]]
    out["fit_36"] = {
        "ms_per_step": affine_fit(l1, t1["ms_per_step"], l2, t2["ms_per_step"], LAUNCH_FULL_DEPTH),
        "peak_gb": affine_fit(l1, t1["peak_gb"], l2, t2["peak_gb"], LAUNCH_FULL_DEPTH),
        "predicted_gb": affine_fit(l1, t1["predicted_gb"], l2, t2["predicted_gb"],
                                   LAUNCH_FULL_DEPTH),
    }
    log(f"[launch] affine fit to {LAUNCH_FULL_DEPTH} layers (L={l1},{l2}): "
        f"{out['fit_36']['ms_per_step']:.1f} ms/step, peak {out['fit_36']['peak_gb']:.2f} GB "
        f"(dry run {out['fit_36']['predicted_gb']:.2f} GB) at b={t1['batch']}x{LAUNCH_SEQ}")
    pf = out["prefill"]
    log(f"[launch] prefill_32k L={pf['layers']} b={pf['batch']}x{pf['seq']} {pf['dtype']}: "
        f"{pf['ms']:.1f} ms, peak {pf['peak_gb']:.2f} GB, predicted {pf['predicted_gb']:.2f} GB "
        f"({pf['predicted_over_measured']:.3f} of measured), bitwise vs prefill "
        f"{pf['bitwise_vs_prefill']}")
    if not pf["bitwise_vs_prefill"] or not pf["finite"]:
        raise AssertionError(f"[launch] prefill_32k's step differs from prefill: {pf}")
    vec = out["vectorized"]
    log(f"[launch] vectorized eMA u12 n={vec['n']}: total {vec['vectorized']['total']:.6e} "
        f"({vec['vectorized']['s']:.2f} s, peak {vec['vectorized']['peak_gb']:.2f} GB) vs loop "
        f"{vec['loop']['total']:.6e} ({vec['loop']['s']:.2f} s), rel diff {vec['rel_diff']:.2e}, "
        f"widest gather {vec['widest_gather_gb']:.2f} GB")
    if not (math.isfinite(vec["vectorized"]["total"]) and vec["rel_diff"] <= LAUNCH_VEC_RTOL):
        raise AssertionError(f"[launch] vectorized != loop: {vec}")
    after = wrapper_launches()
    out["launches"] = {k: after[k] - before[k] + out["launches"][k] for k in after}
    if any(out["launches"].values()):
        raise AssertionError(f"[launch] the launch path launched a port kernel: {out['launches']}")
    if out["collectives"]:
        raise AssertionError(f"[launch] mesh (1, 1) logged {out['collectives']} collectives")
    out["s"] = time.perf_counter() - t_start
    log(f"[launch] card {out['card']} launches {json.dumps(out['launches'])} in {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: kernel A's wide path at full width
# ---------------------------------------------------------------------------


def rows_equal(a, b, step=4096) -> bool:
    """``torch.equal`` over row blocks: no whole-size temporary."""
    import torch

    return all(torch.equal(a[i:i + step], b[i:i + step]) for i in range(0, a.shape[0], step))


def wide_stages(template_name) -> list:
    """The template's distinct ``(k, m, m_a)`` stages whose row does not fit
    kernel A's shared-memory budget (:func:`spmm_ema.ops.row_fits`)."""
    from repro_torch.core.colorsets import binom
    from repro_torch.kernels.spmm_ema.ops import row_fits

    return [(k, m, m_a) for k, m, m_a in fused_geometries(template_name)
            if not row_fits(binom(k, m - m_a), binom(k, m_a))]


def check_wide_stage(operand, k, m, m_a, device) -> dict:
    """One wide stage at one coloring (the chunk the engine picks): two
    launches bitwise equal, a third timed with its output's memory already
    cached, the kernel against a plain version (the SpMM
    half with ``index_add_`` in column chunks, then the eMA by blocks of
    outputs, each in split order; the whole plain two-pass does not fit the
    card next to the kernel's output), the launch time, its bound, and
    ``torch.sparse.mm`` on the ``(n, C_p)`` passive state (the SpMM half)."""
    import torch

    from portbench.roofline import PEAK_BYTES_PER_S, bound_s, fused_stage_work
    from portbench.shapes import TreeStage
    from repro_torch.core.colorsets import binom, build_split_table
    from repro_torch.kernels.spmm_blocked.ref import spmm_ref
    from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, scratch_bytes, spmm_ema

    n, e = operand.n, operand.num_directed
    table = build_split_table(k, m, m_a)
    c_p, c_a = binom(k, m - m_a), binom(k, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, device)
    if not tables.wide:
        raise AssertionError(f"stage {(k, m, m_a)} does not take the wide path")
    gen = torch.Generator(device=device).manual_seed(3)
    m_p = torch.rand((n, 1, c_p), generator=gen, device=device)
    m_aa = torch.rand((n, 1, c_a), generator=gen, device=device)
    got = spmm_ema(operand, m_p, m_aa, tables)
    row = {"stage": [k, m, m_a], "n": n, "c_p": c_p, "c_a": c_a, "n_out": table.n_out,
           "splits": table.n_splits, "route": tables.route,
           "shape": f"k={k} m={m} m_a={m_a} B=1 C_p={c_p} C_a={c_a} n_out={table.n_out} "
                    f"splits={table.n_splits} n={n} (wide, {tables.route})",
           # host-side figures, kept out of the kernels line (WIDE_HOST_KEYS)
           "gather_floor_ms": e * c_p * 4 / PEAK_BYTES_PER_S * 1e3,
           "scratch_bytes": scratch_bytes(operand, 1, c_p, tables)}
    if tables.plan is not None:
        row["plan"] = {"groups": tables.plan.n_groups, "pieces": tables.plan.n_pieces,
                       "max_group": tables.plan.max_group, "smem_bytes": tables.plan.smem_bytes,
                       "staged_columns_per_row": tables.plan.staged_columns}

    def timed_launch():
        if device.type != "cuda":
            return spmm_ema(operand, m_p, m_aa, tables), None, None
        retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = spmm_ema(operand, m_p, m_aa, tables)
        stop.record()
        torch.cuda.synchronize()
        return (out, start.elapsed_time(stop),
                torch.cuda.memory_stats(device).get("num_alloc_retries", 0) - retries)

    again, row["repeat_ms"], row["repeat_alloc_retries"] = timed_launch()
    row["bitwise_repeatable"] = rows_equal(got, again)
    del again
    if not row["bitwise_repeatable"]:
        raise AssertionError(f"spmm_ema wide {(k, m, m_a)}: two launches differ")
    third, ms, _ = timed_launch()  # its output takes the repeat's cached block
    del third
    if ms is not None:
        row["ms"] = ms

    t0 = time.perf_counter()
    agg = spmm_ref(operand.src, operand.dst, n, m_p.reshape(n, c_p), col_chunk=256)
    idx_a, idx_p = tables.idx_a.to(device), tables.idx_p.to(device)
    m_a2, worst = m_aa.reshape(n, c_a), 0.0
    for o0 in range(0, table.n_out, WIDE_PLAIN_BLOCK):
        o1 = min(table.n_out, o0 + WIDE_PLAIN_BLOCK)
        want = torch.zeros((n, o1 - o0), dtype=torch.float32, device=device)
        for t in range(table.n_splits):
            want += m_a2.index_select(1, idx_a[o0:o1, t]) * agg.index_select(1, idx_p[o0:o1, t])
        worst = max(worst, max_abs_err(got[:, 0, o0:o1], want, KERNEL_RTOL,
                                       f"spmm_ema wide {(k, m, m_a)} outputs {o0}:{o1}"))
        del want
    if device.type == "cuda":
        torch.cuda.synchronize()
    row["plain_ms"] = (time.perf_counter() - t0) * 1e3
    row["max_abs_err"] = worst
    del agg, got
    nbytes, flops = fused_stage_work(TreeStage(k, m, m_a), n, e, 1)
    # the wide rows price the split table at 8 bytes a split, the fused
    # stages' bound at 4: kept, so that the rows' bounds compare across runs
    bound, row["bound_by"] = bound_s(nbytes + table.n_out * table.n_splits * 4, flops)
    row["bound_ms"] = bound * 1e3
    if device.type == "cuda":
        torch.cuda.empty_cache()
        csr = torch.sparse_csr_tensor(
            operand.row_ptr.long(), operand.src.long(),
            torch.ones(e, dtype=torch.float32, device=device), size=(n, n))
        flat = m_p.reshape(n, c_p)
        row["library_spmm_half_ms"] = time_ms(lambda: torch.sparse.mm(csr, flat), 2)
        row["over_bound"] = row["ms"] / row["bound_ms"]
        del csr, flat
    del m_p, m_aa
    log(f"[wide] {json.dumps(row)}")
    return row


def gate_column_batch(graph, template) -> int:
    """The gate's ``edges`` column batch: the widest passive state, or the
    widest power of two whose slice gathers at most
    :data:`WIDE_GATE_GATHER_BYTES`."""
    from repro_torch.plan.ir import build_template_plan

    widest = build_template_plan([template]).max_passive_columns
    per_column = (graph.num_directed + graph.n) * 4
    if widest * per_column <= WIDE_GATE_GATHER_BYTES:
        return widest
    cb = 16
    while cb * 2 * per_column <= WIDE_GATE_GATHER_BYTES:
        cb *= 2
    return cb


@contextlib.contextmanager
def timed_wide_launches(engine, device):
    """While open, every stage the ``blocked`` engine sends to kernel A's
    wide path is bracketed by CUDA events; yields the list of (start,
    stop) pairs, to be read after the work synchronises."""
    import torch

    impl, events = engine.backend_impl, []
    real = impl.aggregate_ema

    def timed(m_p, m_a, tables):
        if device.type != "cuda" or not impl._fused_tables[(tables.k, tables.m, tables.m_a)].wide:
            return real(m_p, m_a, tables)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(m_p, m_a, tables)
        stop.record()
        events.append((start, stop))
        return out

    impl.aggregate_ema = timed
    try:
        yield events
    finally:
        del impl.aggregate_ema


def wide_gate(template, n, keys, device) -> dict:
    """``blocked`` against ``edges`` on R-MAT at ``n`` (one coloring each)."""
    import numpy as np

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import rmat_graph

    gate = rmat_graph(n, WIDE_EDGES_PER_VERTEX * n, seed=WIDE_SEED)
    cb = gate_column_batch(gate, template)
    t0 = time.perf_counter()
    got = CountingEngine(gate, [template], backend="blocked", chunk_size=1,
                         device=device).count_keys(keys)
    blocked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = CountingEngine(gate, [template], backend="edges", chunk_size=1, column_batch=cb,
                          device=device).count_keys(keys)
    edges_s = time.perf_counter() - t0
    finite = bool(np.all(np.isfinite(got)) and np.all(np.isfinite(want)))
    return {"n": gate.n, "directed_edges": gate.num_directed, "edges_column_batch": cb,
            "blocked": got[:, 0].tolist(), "edges": want[:, 0].tolist(),
            "blocked_seconds": blocked_s, "edges_seconds": edges_s,
            "finite": finite,
            "max_rel_diff_vs_edges": float(np.max(np.abs(got - want) / np.abs(want)))
            if finite else None}


def wide_cell(template_name, n, device, budget) -> dict:
    """One template at full width: its wide stages checked and timed, then
    one ``count_keys_chunk`` through the ``blocked`` engine (which must pick
    a chunk of 1 under the budget), kernel A launched once per stage, and
    ``compiled_memory_analysis`` within the budget; the totals against the
    ``edges`` engine on the gate graph."""
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import rmat_graph
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template
    from repro_torch.kernels.spmm_blocked.ops import prepare_operand
    from repro_torch.kernels.spmm_ema.ops import spmm_ema

    template = get_template(template_name)
    graph = rmat_graph(n, WIDE_EDGES_PER_VERTEX * n, seed=WIDE_SEED)
    log(f"[graph] rmat n={graph.n} directed edges={graph.num_directed} "
        f"max degree={graph.max_degree()} ({template_name})")
    operand = prepare_operand(graph, device)
    rows = [check_wide_stage(operand, k, m, m_a, device) for k, m, m_a in wide_stages(template_name)]
    del operand
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kwargs = {} if device.type == "cuda" else {"device": device}
    t0 = time.perf_counter()
    engine = CountingEngine(graph, [template], backend="blocked", memory_budget_bytes=budget,
                            **kwargs)
    build_s = time.perf_counter() - t0
    if engine.chunk_size != 1:
        raise AssertionError(f"[wide] {template_name}: the picker chose a chunk of "
                             f"{engine.chunk_size}, not 1")
    stages = sum(1 for st in engine.plan_ir.stages if not st.is_leaf)
    keys = split(prng_key(0, device), 1)
    timed = template_name in WIDE_TIMED
    reset_counting_launches()
    t0 = time.perf_counter()
    with (timed_wide_launches(engine, device) if timed else contextlib.nullcontext()) as wide_events:
        est = engine.count_keys_chunk(keys)  # returns on the host: synchronised
    run_s = time.perf_counter() - t0
    launches = counting_launches()
    device_launches = spmm_ema.device_launches
    if launches["spmm_ema"] != stages:
        raise AssertionError(f"[wide] {template_name}: kernel A launched {launches['spmm_ema']} "
                             f"times for {stages} stages")
    mem_rec = memory_record(f"rmat{graph.n}/{template_name}", engine)
    memory = {k: mem_rec[k] for k in ("predicted_bytes", "actual_temp_bytes", "ratio")}
    if memory["actual_temp_bytes"] is not None and memory["actual_temp_bytes"] > budget:
        raise AssertionError(f"[wide] {template_name}: one chunk took "
                             f"{memory['actual_temp_bytes']:.0f} bytes, past the budget {budget}")
    finite = bool(np.all(np.isfinite(est)))
    rec = {"template": template_name, "n": graph.n, "directed_edges": graph.num_directed,
           "max_degree": int(graph.max_degree()), "peak_columns": engine.peak_columns(),
           "chunk_size": engine.chunk_size, "engine_build_s": build_s,
           "stages": stages, "launches": launches,
           "device_launches": device_launches, "estimate": est[:, 0].tolist(),
           "totals_finite": finite, "memory": memory,
           "bytes_per_coloring": engine.bytes_per_coloring(), "wide_stages": rows}
    rec["range"] = engine.describe()["range"]
    if timed:
        wide_ms = sum(start.elapsed_time(stop) for start, stop in wide_events)
        rec.update(seconds_per_coloring=run_s, wide_stage_launches=len(wide_events),
                   wide_stage_ms=wide_ms, rest_ms=run_s * 1e3 - wide_ms)
    if not finite:
        raise AssertionError(f"[wide] {template_name}: totals not finite at n={graph.n} "
                             f"({est[:, 0].tolist()}) under the range shift {rec['range']}")
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reset_counting_launches()
    gate = wide_gate(template, WIDE_GATE_N[template_name], keys, device)
    if counting_launches()["spmm_ema"] != stages:
        raise AssertionError(f"[wide] {template_name} gate: kernel A launched "
                             f"{counting_launches()['spmm_ema']} times for {stages} stages")
    if not gate["finite"]:
        raise AssertionError(f"[wide] {template_name} gate n={gate['n']}: totals not finite "
                             f"(blocked {gate['blocked']}, edges {gate['edges']})")
    if not np.allclose(gate["blocked"], gate["edges"], rtol=TOTALS_RTOL, atol=0.0):
        raise AssertionError(f"[wide] {template_name} gate n={gate['n']}: blocked "
                             f"{gate['blocked']} vs edges {gate['edges']} beyond rtol={TOTALS_RTOL}")
    # one size up, recorded: the unshifted walk's totals were inf there
    up = rmat_graph(2 * gate["n"], 2 * WIDE_EDGES_PER_VERTEX * gate["n"], seed=WIDE_SEED)
    over = CountingEngine(up, [template], backend="blocked", chunk_size=1,
                          device=device).count_keys(keys)
    gate["next_n"], gate["next_n_totals"] = up.n, over[:, 0].tolist()
    rec["gate"] = gate
    log(f"[wide] {json.dumps({k: v for k, v in rec.items() if k != 'wide_stages'})}")
    return rec, mem_rec


def wide_path(device, budget) -> tuple:
    """Phase 9 over :data:`WIDE_CELLS`; returns the record and each cell's
    memory record for phase 10."""
    cells, mem_recs = zip(*(wide_cell(t, n, device, budget) for t, n in WIDE_CELLS))
    return ({"cells": list(cells),
             "launches": {k: sum(c["launches"][k] for c in cells)
                          for k in ("spmm_ema", "bag_ema")},
             "rows": [r for c in cells for r in c["wide_stages"]]}, list(mem_recs))


# ---------------------------------------------------------------------------
# phase 10: the memory model on the card
# ---------------------------------------------------------------------------


def memory_record(name, engine) -> dict:
    """``compiled_memory_analysis`` of one engine, with what phase 10 needs
    to price it again at another fusion slack."""
    return {"engine": name, "backend": engine.backend, "chunk_size": engine.chunk_size,
            "applied_fusion_slack": engine.cost.fusion_slack,
            "transient_elements": engine.backend_impl.transient_elements(),
            "resident_elements": engine.backend_impl.resident_elements(),
            "plan": engine.plan_ir, "graph": engine.graph,
            **engine.compiled_memory_analysis()}


def memory_engine_analysis(name, graph, templates, device, budget) -> dict:
    """Build one engine as its phase did (``backend="auto"``) and measure
    one chunk's memory."""
    import torch

    from repro_torch.core.engine import CountingEngine

    kwargs = {} if device.type == "cuda" else {"device": device}
    engine = CountingEngine(graph, templates, memory_budget_bytes=budget, **kwargs)
    rec = memory_record(name, engine)
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def memory_path(records, device, budget) -> dict:
    """Write the engines' ``memory_model`` rows into the run's slack file
    (``REPRO_FUSION_SLACK_BENCH``), read the fusion slack back through
    ``load_fusion_slack`` for this card, and print what each engine's chunk
    would be at that slack."""
    import torch

    from repro_torch.plan.cost import (
        BENCH_ENV_VAR,
        CostModel,
        load_fusion_slack,
        memory_model_row,
    )

    path = os.environ[BENCH_ENV_VAR]
    rows = []
    for rec in records:
        if rec["ratio"] is None:
            raise AssertionError(f"[memory] {rec['engine']}: no measured bytes on {device}")
        rows.append(memory_model_row(f"chip_smoke/{rec['engine']}/memory_model", rec, device,
                                     rec["applied_fusion_slack"]))
    with open(path, "w") as fh:
        json.dump({"rows": rows}, fh, indent=1)
    slack = load_fusion_slack(path, device)
    out = []
    for rec in records:
        cm = CostModel(rec["plan"], rec["graph"], torch.float32, fusion_slack=slack)
        per = cm.bytes_per_coloring(rec["transient_elements"], rec["resident_elements"])
        out.append({"engine": rec["engine"], "backend": rec["backend"],
                    "predicted_bytes": rec["predicted_bytes"],
                    "actual_temp_bytes": rec["actual_temp_bytes"], "ratio": rec["ratio"],
                    "chunk_size": rec["chunk_size"],
                    "chunk_at_derived_slack": cm.pick_chunk_size(per, budget),
                    "bytes_per_coloring_at_derived_slack": per})
    result = {"rows": rows, "derived_fusion_slack": slack, "engines": out}
    log(f"[memory] {json.dumps(result)}")
    return result


# ---------------------------------------------------------------------------
# phase 11: the mesh backend
# ---------------------------------------------------------------------------


def mesh_rank(rank, world, graph, template_name, budget, device_type) -> dict:
    """One rank of ``[mesh]`` (runs in a process ``run_ranks`` spawned)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template

    kwargs = {} if device_type == "cuda" else {"device": "cpu"}
    t0 = time.perf_counter()
    engine = CountingEngine(graph, [get_template(template_name)], mesh=dist.group.WORLD,
                            memory_budget_bytes=budget, **kwargs)
    build_s = time.perf_counter() - t0
    if engine.backend != "mesh":
        raise AssertionError(f"mesh= resolved to {engine.backend!r}")
    keys = split(prng_key(0, engine.device), engine.chunk_size)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        est = engine.count_keys(keys)  # returns on the host: synchronised
        runs.append((time.perf_counter() - t0, est))
    if not np.array_equal(runs[0][1], runs[1][1]):
        raise AssertionError(f"[mesh] rank {rank}: a repeat differs: "
                             f"{runs[0][1].tolist()} vs {runs[1][1].tolist()}")
    if not np.all(np.isfinite(runs[0][1])):
        raise AssertionError(f"[mesh] rank {rank}: totals not finite: {runs[0][1].tolist()}")
    d = engine.describe()
    return {
        "rank": rank,
        "world": world,
        "group_backend": dist.get_backend(),
        "device": str(engine.device),
        "chunk_size": engine.chunk_size,
        "column_batch": d["column_batch"],
        "comm": d["comm"],
        "rows_per_shard": engine.backend_impl.sharded.rows_per_shard,
        "edges_per_shard": engine.backend_impl.sharded.edges_per_shard,
        "engine_build_s": build_s,
        "seconds_per_coloring": [t / keys.shape[0] for t, _ in runs],
        "estimates": runs[0][1],
        "predicted_transient_bytes": d["memory"]["predicted_transient_bytes"],
        "predicted_resident_bytes": d["memory"]["predicted_resident_bytes"],
        "fusion_slack": d["memory"]["fusion_slack"],
        "memory": engine.compiled_memory_analysis(),
    }


def mesh_path(graph, device, budget) -> dict:
    """Phase 11: the mesh engine on every card (or 2 gloo ranks on the CPU,
    for rehearsals) against a ``blocked`` engine in this process."""
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.prng import prng_key, split
    from repro_torch.core.templates import get_template
    from repro_torch.plan.cost import BENCH_ENV_VAR
    from repro_torch.testing.ranks import run_ranks

    if device.type == "cuda":
        world, backend = torch.cuda.device_count(), "nccl"
        torch.cuda.empty_cache()
    else:
        world, backend = 2, "gloo"
    # the ranks price with the uncalibrated model: the [memory] rows were
    # measured on blocked engines (the ranks inherit this environment)
    slack_file = os.environ.get(BENCH_ENV_VAR)
    empty_dir = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    os.environ[BENCH_ENV_VAR] = os.path.join(empty_dir, "BENCH_counting.json")
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(mesh_rank, world, args=(graph, TEMPLATE, budget, device.type),
                          backend=backend, timeout_s=MESH_TIMEOUT_S)
    finally:
        shutil.rmtree(empty_dir, ignore_errors=True)
        if slack_file is None:
            os.environ.pop(BENCH_ENV_VAR)
        else:
            os.environ[BENCH_ENV_VAR] = slack_file
    group_s = time.perf_counter() - t0
    est = ranks[0]["estimates"]
    for r in ranks[1:]:
        if not np.array_equal(r["estimates"], est):
            raise AssertionError(f"[mesh] rank {r['rank']} totals differ from rank 0's")

    kwargs = {} if device.type == "cuda" else {"device": device}
    blocked = CountingEngine(graph, [get_template(TEMPLATE)], backend="blocked",
                             memory_budget_bytes=budget, **kwargs)
    keys = split(prng_key(0, device), ranks[0]["chunk_size"])
    blocked.count_keys(keys)  # warm: kernels loaded, partition built
    t0 = time.perf_counter()
    want = blocked.count_keys(keys)
    blocked_s = time.perf_counter() - t0
    del blocked
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not np.allclose(est, want, rtol=TOTALS_RTOL, atol=0.0):
        raise AssertionError(f"[mesh] {est.tolist()} vs blocked {want.tolist()} "
                             f"beyond rtol={TOTALS_RTOL}")
    out = {
        "template": TEMPLATE,
        "world": world,
        "group_backend": backend,
        "group_wall_s": group_s,
        "blocked_seconds_per_coloring": blocked_s / keys.shape[0],
        "max_rel_diff_vs_blocked": float(np.max(np.abs(est - want) / np.abs(want))),
        "estimates": est[:, 0].tolist(),
        "ranks": [{k: v for k, v in r.items() if k != "estimates"} for r in ranks],
    }
    log(f"[mesh] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------


def kernel_record(name, path, source, replaces, launches, rows, timed=None) -> dict:
    """One kernel's entry.  Times and bounds sum over ``timed`` (default:
    every row; for the fused kernel, the shapes the main path gives it);
    the error is the worst over all rows."""
    timed = rows if timed is None else timed
    return {
        "name": name,
        "path": path,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": max(timed, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": (sum(r["library_ms"] for r in timed)
                       if all("library_ms" in r for r in timed) else None),
        "roofline_share": sum(r["bound_ms"] for r in timed) / sum(r["ms"] for r in timed),
        "shapes": rows,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the full record to this JSON file")
    args = parser.parse_args(argv)

    if not (HERE / "src" / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one empty tuning cache for the whole run: no phase before [tune] reads
    # a tuned entry, and nothing outlives the run
    tune_dir = tempfile.mkdtemp(prefix="chip-smoke-tuning-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tune_dir, "TUNED_counting.json")
    # likewise one memory-model file, written only by the last phase
    # ([memory]): every engine before it prices with the uncalibrated model
    os.environ["REPRO_FUSION_SLACK_BENCH"] = os.path.join(tune_dir, "BENCH_counting.json")
    # [launch]'s dry run of every cell runs on the CPU beside the other phases
    sweep = start_launch_sweep(tune_dir)
    try:
        return run(args, device, sweep)
    finally:
        stop_launch_sweep(sweep)
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(args, device, sweep) -> int:
    import torch

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    build_kernels()
    colorings = check_known_colorings(device)
    table_iii = table_iii_counts(device)

    from repro_torch.core.graph import rmat_graph
    from repro_torch.kernels.spmm_blocked.ops import prepare_operand

    t0 = time.perf_counter()
    graph = rmat_graph(**GRAPH_SPEC)
    log(f"[graph] rmat n={graph.n} directed edges={graph.num_directed} "
        f"max degree={graph.max_degree()} in {time.perf_counter() - t0:.1f} s")
    operand = prepare_operand(graph, device)
    geometries = fused_geometries(TEMPLATE)
    partition = load_balance(graph, operand, geometries, EMA_CHUNK, SPMM_WIDTHS)
    log(f"[partition] {json.dumps(partition)}")

    spmm_rows, spmm_grids = check_spmm_blocked(operand, SPMM_WIDTHS, device)
    ema_rows = check_spmm_ema(operand, geometries, EMA_CHUNK, device)
    del operand
    torch.cuda.empty_cache()

    main = main_path(graph, TEMPLATE, device, MEMORY_BUDGET_BYTES)
    if main["chunk_size"] != EMA_CHUNK:
        raise AssertionError(f"chunk {main['chunk_size']} != the {EMA_CHUNK} the kernels were checked at")
    torch.cuda.empty_cache()
    exactness(device)

    motif_graph = rmat_graph(**MOTIF_GRAPH_SPEC)
    log(f"[graph] rmat n={motif_graph.n} directed edges={motif_graph.num_directed} "
        f"max degree={motif_graph.max_degree()}")
    motif = motif_path(motif_graph, device, MEMORY_BUDGET_BYTES)
    bag_launch_widths = sorted({c for rec in motif["engines"] for c in rec["bag_widths"]})
    one_coloring_widths = sorted({c for rec in motif["engines"]
                                  for c in bag_widths_of(rec)} - set(bag_launch_widths))
    bag_rows, bag_grids = check_spmm_blocked(prepare_operand(motif_graph, device),
                                  bag_launch_widths + one_coloring_widths, device, reps=3)
    torch.cuda.empty_cache()
    bag_ema_rows = check_bag_ema(motif_graph, device)
    served = service_path(motif_graph, device, MEMORY_BUDGET_BYTES)
    tuned = tune_path({"rmat2k": rmat_graph(**TABLE_III_GRAPH_SPEC), "rmat8k": motif_graph},
                      device, MEMORY_BUDGET_BYTES)
    front = frontend_path(motif_graph, device, MEMORY_BUDGET_BYTES)
    torch.cuda.empty_cache()
    log(f"[time] counting phases done at {time.perf_counter() - t_start:.1f} s")

    from repro_torch.configs.granite_8b import CONFIG as LM_CONFIG

    flash_rows = check_flash(LM_CONFIG, FLASH_SHAPES, device)
    lm, params, cfg32 = lm_forward(LM_CONFIG, device)
    lm_served = serve(cfg32, params, device)
    del params
    torch.cuda.empty_cache()
    log(f"[time] LM phases done at {time.perf_counter() - t_start:.1f} s")

    from repro_torch.configs.dbrx_132b import CONFIG as DBRX_CONFIG
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as MLA_CONFIG

    mla, params, mla32 = mla_moe_path(MLA_CONFIG, device)
    mla_served = serve(dataclasses.replace(mla32, capacity_factor=float(mla32.n_experts)),
                       params, device, tag="serve_mla", classify=moe_kernel_kind)
    del params
    torch.cuda.empty_cache()
    dbrx_flash_rows = check_flash(DBRX_CONFIG, FLASH_SHAPES[:1], device)
    dbrx, params, _ = lm_forward(dataclasses.replace(DBRX_CONFIG, n_layers=DBRX_LAYERS), device,
                                 tag="dbrx", classify=moe_kernel_kind)
    del params
    torch.cuda.empty_cache()
    moe_ep = moe_ep_path(DBRX_CONFIG, device)
    log(f"[time] MLA and MoE phases done at {time.perf_counter() - t_start:.1f} s")
    train = train_path(LM_CONFIG, device)
    log(f"[time] train phase done at {time.perf_counter() - t_start:.1f} s")
    gnn = gnn_path(device)
    log(f"[time] gnn phase done at {time.perf_counter() - t_start:.1f} s")
    recsys = recsys_path(device)
    log(f"[time] recsys phase done at {time.perf_counter() - t_start:.1f} s")
    launch = launch_path(device, sweep)
    log(f"[time] launch phase done at {time.perf_counter() - t_start:.1f} s")

    # the LM weights and every earlier engine are freed: the wide cells'
    # 41.7 and 46.4 GB of DP state fit beside nothing else
    wide, wide_memory = wide_path(device, MEMORY_BUDGET_BYTES)
    memory = memory_path([
        memory_engine_analysis(f"rmat{graph.n}/{TEMPLATE}", graph, [graphlet(TEMPLATE)], device,
                               MEMORY_BUDGET_BYTES),
        memory_engine_analysis(f"rmat{motif_graph.n}/graphlets4", motif_graph,
                               [graphlet(t) for t in MOTIF_SETS[1][1]], device,
                               MEMORY_BUDGET_BYTES),
        *wide_memory,
    ], device, MEMORY_BUDGET_BYTES)
    log(f"[time] wide and memory phases done at {time.perf_counter() - t_start:.1f} s")
    mesh = mesh_path(graph, device, MEMORY_BUDGET_BYTES)
    del graph, motif_graph
    log(f"[time] mesh phase done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        # times: the u12 stages of the tree path at 2 colorings; the wide
        # stages of u18 and u20 are in "shapes" (and the error) only
        dict(kernel_record(
            "spmm_ema", "counting", "src/repro_torch/kernels/spmm_ema/csrc/spmm_ema.cu",
            "src/repro/kernels/spmm_ema/kernel.py:48", main["launches"]["spmm_ema"],
            ema_rows + [{k: v for k, v in r.items() if k not in WIDE_HOST_KEYS}
                        for r in wide["rows"]], timed=ema_rows,
        ), library_spmm_half_ms=sum(r["library_spmm_half_ms"] for r in ema_rows),
            device_launches=main["device_launches"]["spmm_ema"],
            launches_by_path={"tree": main["launches"]["spmm_ema"],
                              "motif": motif["launches"]["spmm_ema"],
                              "service": served["launches"]["spmm_ema"],
                              "tune": tuned["launches"]["spmm_ema"],
                              "frontend": front["launches"]["spmm_ema"],
                              "wide": wide["launches"]["spmm_ema"],
                              "gnn": gnn["launches"]["spmm_ema"],
                              "recsys": recsys["launches"]["spmm_ema"],
                              "launch": launch["launches"]["spmm_ema"]}),
        # times: one launch at each bag width of the motif path (its
        # launches), the widths of one coloring and the n=2^20 widths in
        # "shapes" only
        dict(kernel_record(
            "spmm_blocked", "motif",
            "src/repro_torch/kernels/spmm_blocked/csrc/spmm_blocked.cu",
            "src/repro/kernels/spmm_blocked/kernel.py:62",
            motif["launches"]["spmm_blocked"], spmm_rows + bag_rows,
            timed=[r for r in bag_rows if r["cols"] in bag_launch_widths],
        ), device_launches=motif["device_launches"]["spmm_blocked"],
            launches_by_path={"tree": main["launches"]["spmm_blocked"],
                             "motif": motif["launches"]["spmm_blocked"],
                             "service": served["launches"]["spmm_blocked"],
                             "tune": tuned["launches"]["spmm_blocked"],
                             "frontend": front["launches"]["spmm_blocked"],
                             "gnn": gnn["launches"]["spmm_blocked"],
                             "recsys": recsys["launches"]["spmm_blocked"],
                             "launch": launch["launches"]["spmm_blocked"]}),
        # times: every bag extend and join of g4-2, g4-3 and g3-1 at a chunk
        # of 10, each template in an engine of its own; "plain_ms" is the
        # executor's loop on the same operands
        dict(kernel_record(
            "bag_ema", "motif", "src/repro_torch/kernels/spmm_ema/csrc/spmm_ema.cu",
            "none: src/repro/exec/local.py:220 _bag_extend / :279 _bag_join (XLA gathers "
            "and multiply-adds)", motif["launches"]["bag_ema"], bag_ema_rows,
        ), launches_by_path={"tree": main["launches"]["bag_ema"],
                             "motif": motif["launches"]["bag_ema"],
                             "service": served["launches"]["bag_ema"],
                             "tune": tuned["launches"]["bag_ema"],
                             "frontend": front["launches"]["bag_ema"],
                             "wide": wide["launches"]["bag_ema"],
                             "gnn": gnn["launches"]["bag_ema"],
                             "recsys": recsys["launches"]["bag_ema"],
                             "launch": launch["launches"]["bag_ema"]}),
        # times: one launch at granite-8b's forward shape (b=4, s=4096),
        # which the bf16 forward launches once per layer (the fp32 gate
        # forward runs flash_attention.cu, checked by the logits gate); the
        # DBRX-shape row (h=48, h_kv=8) is in "shapes"
        dict(kernel_record(
            "flash_attention", "lm",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:30",
            lm["launches"]["flash_attention"], flash_rows + dbrx_flash_rows, timed=flash_rows[:1],
        ), tensor_core_launches=lm["launches"]["flash_attention_tensor_core"],
            launches_by_path={"lm": lm["launches"]["flash_attention"],
                              "dbrx": dbrx["launches"]["flash_attention"],
                              "train": train["run"]["flash_launches"],
                              "train_flash_refusal": train["gates"]["flash_refusal_launches"],
                              "gnn": gnn["launches"]["flash_attention"],
                              "recsys": recsys["launches"]["flash_attention"],
                              "launch": launch["launches"]["flash_attention"]},
            fp32_source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "colorings": colorings, "table_iii": table_iii,
             "partition": partition, "main": main, "motif": motif, "bag_spmm": bag_rows,
             "bag_ema": bag_ema_rows,
             "spmm_blocked_model": {**spmm_grids, **bag_grids},
             "service": served, "tune": tuned, "frontend": front, "lm": lm, "serve": lm_served,
             "mla_moe": mla, "serve_mla": mla_served, "dbrx": dbrx, "moe_ep": moe_ep,
             "train": train, "gnn": gnn, "recsys": recsys, "launch": launch, "wide": wide, "memory": memory, "mesh": mesh, "kernels": kernels},
            indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
