#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py            # R-MAT scale 21, the default
    python3 chip_smoke.py --scale 16 # a quicker rehearsal

It builds the port's CUDA kernels from ``src/repro_torch/kernels`` (five
``.cu`` sources, one ``nvcc`` each, in parallel) and drives BFS, SSSP,
PageRank/PPR, CC, the generic mxv rows, triangle counting, boolean
SpGEMM, k-hop reachability, the multi-source engine (msbfs, mskhop,
ms_sssp, batched PPR, the query batcher), the bit-packing entry points,
BitGNN inference (``gnn_infer`` at gcn-cora's widths), the serving front
end (``GraphQueryServer`` with its telemetry, warm restart and injected
faults), GCN training (``train_steps.gnn_train_step`` and the trainer
at the same widths) and the sharded rows over a mesh of slots on the
card (``GraphMatrix.shard``), the other GNN families, the LM family
(five configs at full width, block-sparse attention over B2SR block
masks) and the recsys family (DIN and the int8 compressed psum) through
the port's entry points. Each phase prints one JSON line;
a failed phase exits non-zero.

  1. kernels: each kernel against its plain PyTorch version
     (``kernels/bmv/ref.py``) on the card, at tile dims 4/8/16/32 on small
     dot/rmat/road graphs and on the full graph. ``bmv_bbb_push`` bit
     for bit (frontiers at 0.1%/10%/60% density; no mask, a mask kept
     and its complement) and ``bmv_bbb_pull`` (the masks; with and
     without the rows' lane occupancy); ``bmv_bbf``
     bit for bit (the same frontiers); ``bmv_bff`` bit for bit in modes
     min_plus and max_times and, in mode sum, within
     ``|y - y_plain| <= 1e-5 * (A·|a·x|)`` elementwise and equal bit for
     bit on a second launch, each with ``a_value`` 1.0 and 0.0. Push,
     pull, ``bmv_bbf`` and ``bmv_bff`` run with their default work items
     and with items of 3 tiles (every row of more than 3 tiles cut and
     merged).
  2. bfs: Graph500 R-MAT scale 21, edgefactor 16 (n = 2,097,152;
     A/B/C = 0.57/0.19/0.19; symmetrised, no self-loops), tile dim 32.
     ``direction`` push/pull/auto from 4 sources on ``b2sr_cuda``, then on
     ``csr``: levels, n_iterations and directions must be equal, and levels
     must equal SciPy's unweighted ``shortest_path`` (-1 for unreachable).
     Prints each traversal's wall time and the median rate in traversed
     edges per second.
  3. sssp: from the same 4 sources on ``b2sr_cuda`` and ``csr``;
     distances must equal SciPy's levels (inf for unreachable) and the two
     backends' iterations must be equal.
  4. pagerank: PageRank and PPR (from the first source) on ``b2sr_cuda``
     and ``csr``; ranks allclose (rtol 1e-4) to a float64 numpy power
     iteration of the same update and to each other.
  5. cc: push, pull and auto on ``b2sr_cuda`` and ``csr``; labels must
     equal SciPy's ``connected_components`` with the minimum vertex id of
     each component as its label, iterations and directions equal.
  6. mxv: the generic rows no algorithm of this slice runs, through
     ``GraphMatrix.mxv``: the count row (``BitVector`` x, arithmetic) on
     one BFS traversal's frontiers and the max-times dense row, masked and
     unmasked, on ``b2sr_cuda`` against ``csr``.
     In phases 2-6 the kernels' launch counts are set to 0 just before
     the phase's ``b2sr_cuda`` runs and read just after; a kernel of the
     phase that never launched fails the run.
  7. tc: triangle counting on the same graph: L's split and packing
     timed, ``triangle_count`` on ``b2sr_cuda`` (the ``bmm_tc`` kernel)
     and on ``csr`` (sorted-row intersection); the counts must be equal,
     and ``bmm_tc`` must equal its plain version on L. Prints whether
     float32, the reference's type, holds the count, and times the
     kernel (with the plan the triangle row keeps, and building the plan
     in the call), its plain version and the tile-row with the most work
     alone; prints L's longest row, the probes and the least merge walk,
     which the bound counts.
  8. spgemm: Graph500 R-MAT scale 16 (edgefactor 16, seed 0), tile dim
     32: ``g.mxm(g)`` and ``g.mxm(g, mask=g, complement=True)`` on
     ``b2sr_cuda`` (the ``spgemm_bbb`` kernel) and ``csr``: every B2SR
     array equal, and equal to the kernel's plain version. Times the
     kernel, and its window, count and fill launches (each row list's)
     apart, beside one
     ``torch.sparse.mm`` of the float CSR by itself (cuSPARSE, the
     yardstick; the port never calls it on this path); prints the work
     counts (tile pairs, ORs, (non-zero word, tile) pairs, the pairs whose
     occupancies meet and the words of B they read) and the phase's peak
     device memory.
  9. khop: a road grid of side 2048 (n = 4,194,304), tile dim 32:
     ``khop_reachability(g, 3)`` on ``b2sr_cuda`` and ``csr``; the reach
     matrices' B2SR arrays and ``n_iterations`` must be equal. The
     first call's wall beside two more calls', one after
     ``torch.cuda.empty_cache()``, and the host's time by op of a warm
     and a cold call. One hop's product A²⟨¬A⟩ alone: equal to the plain
     version, timed (and its launches apart) beside its plain version,
     its bound and its work counts.
     In phases 2-9 the kernels' launch counts are set to 0 just before
     the phase's ``b2sr_cuda`` runs and read just after; a kernel of the
     phase that never launched fails the run.
 10. msbfs: 64 sources (the bfs phase's 4 as columns 0-3, 60 more drawn
     with a seed) on the same graph, push/pull/auto on ``b2sr_cuda``
     (``spmm_bbb``) and ``csr``: levels, n_iterations and directions
     equal; columns 0-3 equal SciPy's levels; 8 columns equal
     single-source ``bfs``. Prints the batch's queries per second beside
     single-source BFS's, and the time of ``GraphMatrix.fingerprint``.
 11. mskhop (k = 2) and ms_sssp (edge weights 1.0 and 0.5), the same
     sources: equal to ``csr``, and to ``khop_frontier`` / ``sssp`` for 4
     columns.
 12. batched_ppr: 32 seeds, 10 iterations, eps 0, on ``b2sr_cuda``
     (``spmm_dense``) and ``csr``: within rtol 1e-4 of each other, of
     single-seed ``ppr`` and, for 4 columns, of a float64 numpy power
     iteration.
 13. batcher: one ``QueryBatcher.flush`` of 140 BFS and 60 PPR queries
     with duplicates: every handle equals its msbfs / batched_ppr column
     (PPR within rtol 1e-6), the dedup count is right; queries per
     second.
     In phases 10-13 the kernels' launch counts are set to 0 just before
     the phase's ``b2sr_cuda`` runs and read just after.
 14. spmm_timing: ``spmm_bbb`` per launch on each msbfs (auto) iteration's
     inputs and ``spmm_dense`` on each PPR iteration's, beside their
     plain versions, the ``csr`` rows, one cuSPARSE SpMM
     (``torch.sparse.mm`` of the float CSR by [n, 64] frontiers and by
     [n, 32] and [n, 64] float X: the yardstick, which the port never
     calls) and the bound; ``spmm_dense`` on the last PPR input with
     each V the kernel has (columns a lane takes per pass), beside the
     registers ``ptxas`` gave each.
 15. bitpack: ``kernels.bitpack.ops.bit_transpose`` of the graph's
     tiles (equal to the tiles of the stored transpose, which is built
     from the swapped COO) and ``pack_dense`` of a [32768, 32768] uint8
     0/1 matrix (equal to its plain version, row- and column-major, and
     on the same entries as float32 with -0.0 among the zeros), their
     launch counts, and each kernel's time beside its plain version and
     its bound (``pack_dense`` also column-major and on the float32
     entries, beside their own bound).
 16. gnn: BitGNN inference at gcn-cora's widths (d_in 1433, d_hidden 16,
     7 classes, 2 layers) on the same graph, bag-of-words features and
     random weights made on the card from the seed: ``gnn_infer`` of the
     64 engine sources with ``binarize`` True (hidden layer: ``pack_rows``
     and ``spmm_bbf``) and False on ``b2sr_cuda`` and ``csr``, the input
     layer on ``spmm_dense`` at D = 1433. Each backend's logits against a
     float64 SciPy second layer from its own first-layer activations
     (within 1e-5 on the bit path, 1e-4 on the float path, relative to
     |agg|·|W| + |b|), the float path's backends against each other, and
     ``spmm_bbf``'s counts equal to ``csr``'s and the plain version's on
     the same ``BitMatrix``; one ``QueryBatcher.flush`` of 96 queries per
     model, every handle equal to its ``gnn_infer`` column. Prints the
     walls, the nodes per second of the flush, the peak device memory,
     ``spmm_dense`` at D = 1433 beside cuSPARSE with its scratch bytes,
     the V the launcher chose and each V's time and registers, and
     ``spmm_bbf`` and ``pack_rows`` per launch beside their plain
     versions, the ``csr`` row and (``spmm_bbf``) cuSPARSE SpMM of the
     unpacked 0/1 matrix; ``pack_rows`` also by its device time alone
     (torch.profiler), on h itself as float32 entries (equal to the
     packing of h > 0), and the wrapper's floor (a [32, 1] bool).
     In phases 15-16 the kernels' launch counts are set to 0 just before
     the phase's ``b2sr_cuda`` runs and read just after.
 17. serve: the serving front end (``engine.GraphQueryServer``) on the
     same graph, with the gnn phase's models: a stream of 256 queries (96
     bfs, 48 khop at k = 2, 48 sssp, 32 ppr of 10 iterations at eps 0,
     32 gnn_infer on the bit model; sources from the seed, the bfs
     phase's among them), 8 at a time 10 ms apart with ``poll()`` after
     each batch, ``max_batch`` 64 and the default 100 ms budget. Every
     handle must resolve on ``b2sr_cuda`` (no degraded launch, no failed
     query, every breaker closed) and equal its launch replayed through
     ``launch_group`` bit for bit; the bfs phase's sources equal SciPy's
     levels; ``spmm_bbb``, ``spmm_dense``, ``spmm_bbf`` and ``pack_rows``
     must launch (counts set to 0 before the stream, read after). Prints
     p50/p99 latency by kind from the traces, the share of trace time by
     stage, flushes by reason, plan-cache hits and misses, queries per
     second, deadlines missed by kind and the stream's wall with
     ``obs.disabled()`` and on (twice each, in turns). Then the metrics
     exported and read back (``write_metrics``, ``parse_prometheus``,
     ``dump_traces``), a warm restart (``save_warmup``, a fresh server's
     ``warmup``: the first arrival batch again adds no plan-cache miss;
     the first query cold and warm, 5 times each in turns), and faults
     on R-MAT scale 16: a scripted ``FaultInjector`` on
     bfs/``b2sr_cuda`` over 2-hop bfs queries (answers on ``b2sr``, the
     breaker opens, skips, half-opens and closes), every launch of bfs,
     khop, sssp and ppr faulted (answers on ``b2sr`` equal the healthy
     ``b2sr_cuda`` answers, ppr within rtol 1e-4), and a direct ``bfs``
     raising ``InjectedFault`` while the injector is installed; every
     degraded launch must follow an injected fault.
 18. train: GCN training at gcn-cora's widths on the same graph, from
     the gnn phase's features (its other tensors freed first), labels of
     the 7 classes, a 30% train mask and random weights made on the card
     from the seed; AdamW, lr 5e-3, no warmup. 4 steps of
     ``gnn_train_step`` on ``b2sr_cuda`` and ``csr`` from the same
     weights: losses finite and within rtol 1e-4 of each other at every
     step, step 1's gradients within 1e-4 of each one's max |value|; on
     ``b2sr_cuda`` a run with a checkpoint every step that fails at step
     2 and is restarted from its checkpoint: its parameters equal the
     uninterrupted run's bit for bit. The launch count of ``spmm_dense``
     is set to 0 before the ``b2sr_cuda`` steps and must read 3 a step
     after (two forward, one backward over Aᵀ). One backward launch's
     Aᵀ·dY, caught by hooks on its autograd node, within 1e-5·(Aᵀ·|dY|)
     of a float64 SciPy product and of the plain version, the same bits
     on a second launch, and timed beside its plain version, the ``csr``
     row, one cuSPARSE SpMM of the float CSR of Aᵀ by [n, 16] and its
     bound. Prints the step walls (median of steps 2-4) and the peak
     device memory.
 19. shard: the sharded rows (``GraphMatrix.shard``) on the same graph
     and on the spgemm phase's scale-16 graph, over a mesh of 4 slots
     that all name the one card and a mesh of 1 slot, each with
     ``combine`` "gather" and "exchange": BFS push/pull/auto from the 4
     sources, SSSP, PageRank, PPR, CC, the count mxv, msbfs and mskhop
     of the 64 engine sources, ``triangle_count``, A² at scale 16,
     ``signed_aggregate`` at D = 16 and, at gcn-cora's widths, the GCN
     forward and one ``gnn_train_step`` with ``shardmap_agg_axes``. Every
     result equals the unsharded ``b2sr_cuda`` graph's bit for bit;
     every kernel launches on every sharding (counts set to 0 before,
     read after). Prints the walls beside the unsharded ones, the words
     each combine moves, the partitions' balance and edge cut, the
     device time outside the hand kernels (torch.profiler), the peak
     device memory and the card's name and power limit.
 20. timing: per kernel of phases 2-6 the median time of one launch (CUDA
     events) on the main path's inputs (each iteration of one run),
     beside its plain version, the ``csr`` row, one cuSPARSE SpMV call
     (``torch.mv`` on the float CSR) where that computes the same
     function, and the bound (bytes over 3.35 TB/s or operations over
     67 TFLOP/s); the graph's B2SR and CSR bytes. Push, ``bmv_bff`` and
     ``bmv_bbf`` run with the work items the registry keeps, and the
     line gives the cut's (and pull's lane occupancy's) one-off time
     apart, each kernel on the hub tile-rows' items alone (push and pull
     beside each other), and ``bmv_bff`` (sum) at tile dims 16 and 8 on
     the same graph (time, bytes, bound, error against the plain
     version). Pull runs with the
     items and the lane occupancy the registry keeps. Phases 7-8 time
     their own kernels the same way.
 21. profile: one run per algorithm and BFS direction, triangle counting,
     k-hop, msbfs (auto), batched PPR, ``gnn_infer`` (bit and float) and
     one GCN train step on ``b2sr_cuda`` under ``torch.profiler``: device
     time by kernel and the card's idle share.
 22. families: the other GNN families at their published widths, random
     seeded weights, AdamW. GatedGCN (16 layers, d 70): 3 train steps on
     ``minibatch_lg`` (a neighbour-sampled subgraph of a 232,965-node dot
     graph, 1,024 seeds, fanout 15-10: the static 169,984 nodes and
     168,960 edges), 2 on ``molecule`` (128 graphs of 30 nodes and 64
     edges, graph-level loss), and on R-MAT scale 16 (edges partitioned
     by receiver block, ``remat``) the forward and a step with
     ``shardmap_agg_axes`` over 4 slots of the card against the dense
     path: logits within rtol and atol 2e-4, loss within rtol 1e-4, the
     sharded aggregation counted. EGNN (4 layers, d 64): 3 steps on
     ``molecule`` and on ``minibatch_lg`` with coordinates; a rotation and
     a translation leave h and move x within 1e-4 of the values' scale.
     GraphCast (16 layers, d 512, refinement 6): the forward on the 0.25°
     grid (1,038,240 nodes) within 1e-4 of max |out| of a float64 run of
     the same weights (written out plainly, in chunks); one train step at
     1° with 4 processor layers. The GCN at gcn-cora's widths on a B2SR
     molecule batch: 3 steps on ``b2sr_cuda`` (``spmm_dense``: 3 launches
     a step) and on the segment sum, losses within rtol 1e-4.
     ``spmm_b2sr_shardmap`` at D = 16 on the main graph over 4 slots, bit
     for bit against the unsharded row (``spmm_dense`` launched per
     shard). ``sample_profile`` (64 rows) beside the B2SR's real bytes at
     t = 4, 8, 16, 32. Prints the step walls, the sharded/dense ratio,
     peak device memory per part, the cuts (``reduced``) and the card.
 23. lm: the LM family (no hand kernel: attention, RoPE, the MoE dispatch
     and the matmuls are PyTorch operations, as the reference's are
     ``jnp``), after the graphs are freed; random seeded weights from the
     port's own initialisation, float32 checks with TF32 off.
     (b) phi4-mini-3.8b (arXiv:2412.08905: 32 layers, d 3,072, 24/8
     heads of 128, d_ff 8,192, vocab 200,064, tied) with float32 weights
     on one 2,048-token prompt: ``lm_decode_step`` after an
     ``lm_prefill_step`` of the first 2,047 tokens equals the forward's
     last position within rtol and atol 2e-3; the bfloat16 forward's
     last logits within 5e-2 of max |logit| of the float32 run; layer
     0's ``chunked_causal_attention`` at S = 4,096 within 1e-5 of max
     |out| of ``gqa_attention`` with the causal mask (float32
     probabilities) and 1e-2 (bfloat16); its q and k in bfloat16 give
     ``attn_scores`` within 1e-5 of max |s| of the float32 product of
     the same values (the scores are summed in float32, never rounded to
     bfloat16). (a) The same weights in
     bfloat16 (7.67 GB): a 32,768-token prefill (``prefill_32k`` at
     batch 1; the chunked path) and 32 greedy decode steps into a cache
     of 32,800 (``decode_32k``'s context at batch 1): prefill tokens/s,
     decode p50/p99 and tokens/s, the cache bytes and the time of the
     weights-and-cache read at 3.35 TB/s; one decode step under
     torch.profiler. (c) phi4 with 2 of 32 layers (816 M parameters),
     AdamW, ``remat``, train_4k's 4,096 tokens at batch 2: 3 steps on
     one batch (lr 1e-3): losses finite, step 1 within 0.5 of the loss
     the initialisation gives (ln V + σ²/2, σ² the logits' variance),
     step 3 below step 1; one step under torch.profiler; ``grad_accum=2``
     against 1 at float32 compute and float32 probabilities (SGD's
     momentum after one step is the gradient): within 1e-4 of max |g|.
     (d) qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B: 128 experts, top-8,
     d_ff 768, QK-norm) with 4 of 48 layers in bfloat16 (3.11 B
     parameters): a 4,096-token prefill and 16 decode steps; layer 0's
     ``moe_ffn`` at float32 on 1,024 tokens: at capacity factor 8.0
     nothing drops and y equals a plain per-expert sum of gate ×
     SwiGLU_e(x) over each token's top-8 within 1e-4 of max |y|; at 1.25
     the dropped assignments equal a numpy recount of the same routing
     and y the plain sum over the kept ones; one train step with 2
     layers (AdamW, bfloat16 moments), its loss within 0.5 of the
     initialisation's. (e) gemma-7b (GeGLU, head_dim 256) and
     minitron-4b (ReLU², untied head) at full width with 2 layers: a
     2,048-token prefill and 8 decode steps each; arctic-480b at its
     reduced config: one train step (SGD, bfloat16 parameters and
     moments) and a prefill with 4 decode steps. (f) Block-sparse
     attention: ``local_strided_pattern(window=4, stride=8)`` over S =
     16,384 in blocks of 128, stored as B2SR at tile dims 8 and 32 (the
     same block lists), with phi4's 24 heads of 128 in float32, within
     rtol and atol 2e-5 of a dense masked attention computed head by
     head; both walls and the share of score blocks computed. Prints
     peak device memory per part, the cuts (``reduced``) and the card.
 24. din: the recsys family (no hand kernel: the embedding lookups, the
     attention MLP and the compressed psum are PyTorch operations, as
     the reference's are ``jnp``) at DIN's published widths
     (arXiv:1706.06978: d 18, L 100, attention MLP 80-40, MLP 200-80,
     1,000,000 items, 10,000 categories, 8 user fields of 100,000; 20.05
     M parameters), after the LM's tensors are freed; random seeded
     weights from the port's own initialisation, checks with TF32 off.
     (a) The float32 forward of a ``serve_p99`` batch within 1e-5 of max
     |logit| of a float64 forward of the same weights; ``score_candidates``
     of one user over 10,007 candidates in blocks of 4,096 equal to the
     forward of that user with each candidate as target within 1e-5 of
     max |score|; the loss and every gradient of a batch of 4,096 within
     1e-4 of max |g| of a float64 run. (b) The reference's four shapes
     (``launch/specs.py``): ``train_batch`` (4 ``din_train_step``s at
     65,536 on one batch, AdamW at lr 1e-3 from step 1: losses finite,
     step 4 below step 1; median wall of steps 2-4), ``serve_p99`` (60
     synchronized ``din_serve_step`` calls at 512: p50/p99),
     ``serve_bulk`` (one call at 262,144 after a warm-up) and
     ``retrieval_cand`` (``din_retrieval_step``, 1 user × 1,000,000
     candidates, after a warm-up), each beside its bound (the FLOPs of
     ``launch/specs.py`` over 67 TFLOP/s or the bytes it must move over
     3.35 TB/s), its peak device memory and its attention features'
     bytes; one train step and one ``serve_p99`` call under
     torch.profiler. (c) ``launch.train --arch din --full-config --batch
     4096 --steps 2`` through its ``main``: losses finite. (d)
     ``compressed_psum_tree`` over a mesh of 4 slots of the card, of DIN's
     gradients from 4 batches of 4,096: sums and residuals equal the
     same call on the CPU bit for bit, the one-shot error below 0.1 of
     max |exact sum| per tensor, the error of 4 steps of error feedback
     (each step's sum and the mean of the sums so far);
     ``topk_compress`` at 1% equal to the CPU's; its wall beside the
     exact psum's copies. Prints the cuts (``reduced``: none), the card
     and the phase's wall.
 25. spmd: the SPMD layer (DTensor, ``repro_torch.sharding``; no hand
     kernel). (a) On the card, a one-rank NCCL world and a (1, 1)
     ``("data", "model")`` mesh (NCCL takes no two ranks on one card: the
     multi-rank values are held by ``tests/test_torch_spmd.py`` on 8 gloo
     ranks on the CPU); TF32 off. phi4-mini-3.8b at full width with 2 of
     32 layers, in its own bfloat16: one AdamW step (lr 1e-3, no warmup)
     at train_4k's 4,096 tokens and batch 2 with parameters, AdamW state
     and batch placed as DTensors by ``rules`` against the same step on
     plain tensors from the same weights: loss and gradient norm within
     rtol 1e-5, every first moment within 1e-4 of its tensor's max (the
     CPU test's limit; a repeat of the plain step is printed beside), and
     at most 1% of each updated parameter's elements off by over 1% of lr
     (AdamW's first update is about lr·sign(g): a gradient near zero has
     a noisy sign), a share that a control step with a wrong gradient
     (other labels) must exceed. qwen3-moe-30b-a3b at full width with 2
     of 48 layers, float32 (the dispatch's ``index_add`` sums with atomics,
     so in bfloat16 even one path run twice parts by its roundings),
     capacity factor E/k = 16 (C = N: nothing can drop), 2 × 1,024
     tokens: the loss and its gradients through ``moe_ffn_shardmap``
     (counted) against the dense dispatch, loss within rtol 1e-5, every
     gradient within 1e-4 of its tensor's max. Layer 0 of the phi4
     weights saved, then restored onto the mesh by
     ``rules.tree_shardings``: equal bit for bit. Walls of each, sharded
     and plain. (b) Meanwhile, on the host, the production dry run
     (``launch.dryrun``, every layer counted) of the LM cells
     ``train_4k`` and ``decode_32k`` of the five archs on 16 × 16 and
     2 × 16 × 16, one process a cell and mesh, seven at a time: one JSON
     line a cell (``prefill_32k`` takes minutes a cell and is left out;
     ``long_500k`` is a skipped cell). Prints the walls, peak device
     memory and the card.

The kernels phase also holds ``bmm_tc`` and ``spgemm_bbb`` against their
plain versions on the small graphs at every tile dim (SpGEMM with no
mask, a keep mask and its complement; TC on L and on a masked A·Aᵀ), and
the triangle counts and A² patterns of those graphs against SciPy;
``bmm_tc`` with A, Bᵀ and the mask all different (a directed graph with
self-loops, repeated edges and a hub row, its transpose and a random
mask) against the plain version and SciPy, also with items of 64 probes,
split by the shorter row and not, and with a mask whose every tile the
plan moves (its kept part empty);
``spgemm_bbb`` also with blocks of 64 threads and rounds of 3 slots (the
rows of C built in rounds); ``spmm_bbb`` at 1, 33 and 70 sources (W = 1,
2, 3; on the small graphs also 1,056, W = 33, and with items of 3
tiles) and frontier densities 0.05% and 5%, unmasked, masked and
complemented, bit for bit,
and ``spmm_dense`` at D = 1, 32, 33, 64, 130, 1433 on the small graphs
(with work items of 3 tiles too) and at D = 1, 32, 33, 64 on the full
graph, bit for bit with small-integer X and, with random X, within
``|y - y_plain| <= 1e-5 * (A·|X|)``, the same bits on a second launch
and (D > 32, small graphs) the same bits with every V; ``spmm_bbf``
(the default work items, items of 3 tiles and of 5 set bits) and
``pack_rows`` (float32 and bool input) at D = 1, 7, 16, 33, 130 on the
small graphs and at D = 16 on the full graph, ``pack_rows`` also on
[70, D] bool, uint8, int8, int32 and float32 entries (-0.0 and NaN among
the float32) at the same D (16: the kernel's 16-byte loads, the others
its scalar path) and on [70, 16] views with a storage offset (5 entries:
the scalar path; 16 bytes: the 16-byte loads) at every tile dim,
``pack_dense`` of
each small graph's dense adjacency, row- and column-major (row-major also
equal to the graph's own B2SR tiles), and of [70, m] bool, uint8, int8,
int32 and float32 entries (-0.0 and NaN among the float32) at m = 1, 15,
17, 33, 100, 1,024 and 1,040 and of contiguous views with a storage
offset, at every tile dim, both orders, and ``bit_transpose`` of every
graph's tiles, all bit for bit.

Then the card's name and power limit, the kernel table as one JSON line,
and last ``{"ok": true, "device": {...}}``. Without CUDA it exits 1
before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SCALE = 21
EDGEFACTOR = 16
TILE_DIM = 32
N_SOURCES = 4
DIRECTIONS = ("push", "pull", "auto")
DENSITIES = (0.001, 0.1, 0.6)
REPS = 15
PLAIN_REPS = 3
SUM_TOL = 1e-5                 # bmv_bff sum mode: |y - y_plain| <= SUM_TOL * A·|a·x|
RANK_RTOL = 1e-4               # float32 ranks against float64 numpy
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
LANE_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
DEVICE = "cuda"
SPGEMM_SCALE = 16
ROAD_SIDE = 2048
KHOP_K = 3
#: kernel -> (the TPU kernel it replaces, its source in the port)
KERNELS = {
    "bmv_bbb_push": ("src/repro/kernels/bmv/bmv.py:96",
                     "src/repro_torch/kernels/bmv/bmv.cu"),
    "bmv_bbb_pull": ("src/repro/kernels/bmv/bmv.py:170",
                     "src/repro_torch/kernels/bmv/bmv.cu"),
    "bmv_bff": ("src/repro/kernels/bmv/bmv.py:235",
                "src/repro_torch/kernels/bmv/bmv.cu"),
    "bmv_bbf": ("src/repro/kernels/bmv/bmv.py:43",
                "src/repro_torch/kernels/bmv/bmv.cu"),
    "bmm_tc": ("src/repro/kernels/bmm/bmm.py:70",
               "src/repro_torch/kernels/bmm/bmm.cu"),
    "spgemm_bbb": ("src/repro/kernels/spgemm/spgemm.py:96",
                   "src/repro_torch/kernels/spgemm/spgemm.cu"),
    "spmm_bbb": ("src/repro/kernels/spmm/spmm.py:61",
                 "src/repro_torch/kernels/spmm/spmm.cu"),
    "spmm_dense": ("src/repro/kernels/spmm/spmm.py:150",
                   "src/repro_torch/kernels/spmm/spmm.cu"),
    "spmm_bbf": ("src/repro/kernels/spmm/spmm.py:109",
                 "src/repro_torch/kernels/spmm/spmm.cu"),
    "pack_rows": ("src/repro/kernels/bitpack/bitpack.py:59",
                  "src/repro_torch/kernels/bitpack/bitpack.cu"),
    "pack_dense": ("src/repro/kernels/bitpack/bitpack.py:32",
                   "src/repro_torch/kernels/bitpack/bitpack.cu"),
    "bit_transpose": ("src/repro/kernels/bitpack/bitpack.py:89",
                      "src/repro_torch/kernels/bitpack/bitpack.cu"),
}
MS_SOURCES = 64                # msbfs / mskhop / ms_sssp batch
PPR_SEEDS = 32                 # batched PPR batch
MSKHOP_K = 2
SPMM_SOURCES = (1, 33, 70)     # spmm_bbb checks: W = 1, 2, 3 source words
SPMM_WIDE = 1056               # and W = 33 on the small graphs
SPMM_DENSITIES = (0.0005, 0.05)
SPMM_WIDTHS = (1, 32, 33, 64, 130, 1433)  # spmm_dense checks: D
SPMM_FULL_WIDTHS = (1, 32, 33, 64)         # the same on the full graph
BATCH_QUERIES = (140, 60)      # batcher: BFS and PPR queries, duplicates in
GNN_WIDTHS = (1, 7, 16, 33, 130)  # spmm_bbf / pack_rows checks: D
BOW_WORDS = 18                 # words per node of the bag-of-words features
GNN_QUERIES = 96               # batcher: gnn_infer queries per model
BIT_TOL = 1e-5                 # bit-path logits against float64, see phase_gnn
FLOAT_TOL = 1e-4               # float-path logits, see phase_gnn
PACK_SIDE = 32768              # pack_dense timing: [PACK_SIDE, PACK_SIDE]
PACK_ROWS = 70                 # pack_dense checks: rows, widths, types
PACK_WIDTHS = (1, 15, 17, 33, 100, 1024, 1040)
PACK_DTYPES = ("bool", "uint8", "int8", "int32", "float32")  # entry types
TRANSPOSE_CHUNK = 1 << 19      # tiles per plain bit_transpose call
TRAIN_STEPS = 4                # train: steps per run
TRAIN_FAIL_AT = 2              # the resumed run's injected failure
TRAIN_LR = 5e-3
TRAIN_MASK = 0.3               # share of the nodes in the loss
LOSS_RTOL = 1e-4               # train: b2sr_cuda's losses against csr's
GRAD_TOL = 1e-4                # step 1's gradients, over each one's max |g|
#: serve: queries of the stream by kind (bfs, khop, sssp, ppr, gnn_infer)
SERVE_QUERIES = {"bfs": 96, "khop": 48, "sssp": 48, "ppr": 32, "gnn_infer": 32}
SERVE_ARRIVAL = 8              # queries admitted between polls
SERVE_GAP_S = 0.010            # seconds between arrival batches
SERVE_MAX_BATCH = 64
SERVE_KHOP_K = 2
SERVE_PPR_ITERS = 10
SERVE_RESTARTS = 5             # cold / warm first-batch samples, in turns
SERVE_FAULT_HOPS = 2           # serve (d): hops of the scripted bfs queries
SHARD_SLOTS = 4                # shard: slots of the mesh on the one card
#: shard: (label, slots, combine) of each sharding
SHARD_CONFIGS = (("p4/gather", SHARD_SLOTS, "gather"),
                 ("p4/exchange", SHARD_SLOTS, "exchange"),
                 ("p1/gather", 1, "gather"), ("p1/exchange", 1, "exchange"))
FAM_SHARD_SLOTS = 4            # families: GatedGCN / spmm_b2sr_shardmap slots
FAM_SCALE = 16                 # families: GatedGCN sharded-vs-dense graph
FAM_MINIBATCH = (232965, 1024, (15, 10))   # minibatch_lg (launch/specs.py)
FAM_MOLECULES = (128, 30, 64)  # molecule: graphs, nodes and edges a graph
FAM_STEPS = 3                  # train steps a family and shape (molecule 2)
FAM_LR = 1e-3
GRID_025 = (721, 1440)         # GraphCast's published 0.25° grid
GRID_1 = (181, 360)            # the 1° grid of the train step
GC_TRAIN_LAYERS = 4            # the 1° step's processor depth (see reduced)
SHARD_TOL_FAM = 2e-4           # sharded GatedGCN logits against dense
GC_TOL = 1e-4                  # GraphCast against float64, of max |out|
EQUIV_TOL = 1e-4               # EGNN equivariance, of the values' scale
PROFILE_SAMPLES = 64           # sample_profile's rows
#: families: the train steps also run once under torch.profiler
PROFILED = ("gatedgcn/minibatch_lg", "gatedgcn/molecule", "egnn/molecule",
            "graphcast/1deg_4_layers")
LM_PREFILL = 32768             # lm (a): prefill_32k's prompt, batch 32 -> 1
LM_DECODE = 32                 # lm (a): greedy steps into a 32,800 cache
LM_CHECK = 2048                # lm (b): the float32 checks' prompt
LM_CHUNK_CHECK = 4096          # lm (b): chunked vs plain attention, S
LM_TRAIN = (2, 2, 4096)        # lm (c): layers, batch, tokens a row
LM_TRAIN_STEPS = 3
LM_LR = 1e-3
LM_DECODE_TOL = 2e-3           # decode vs forward (tests/test_models.py)
LM_BF16_TOL = 5e-2             # bf16 logits vs float32, of max |logit|
LM_CHUNK_TOL = 1e-5            # chunked vs plain, of max |out|
LM_CHUNK_BF16_TOL = 1e-2       # the same with bfloat16 probabilities
LM_SCORES_TOL = 1e-5           # bfloat16 q·k summed in float32, of max |s|
LM_ACCUM_TOL = 1e-4            # grad_accum 2 vs 1, of max |g|
MOE_LAYERS = (4, 2)            # lm (d): qwen3 serving and training depth
MOE_PREFILL, MOE_DECODE = 4096, 16
MOE_CHECK_TOKENS = 1024
MOE_TOL = 1e-4                 # moe_ffn vs the plain sum, of max |y|
OTHER_PREFILL, OTHER_DECODE = 2048, 8   # lm (e): gemma / minitron, 2 layers
BS_SEQ, BS_BLOCK = 16384, 128  # lm (f): block-sparse attention
BS_TILE_DIMS = (8, 32)
BS_TOL = 2e-5
BF16_TFLOPS = 989e12           # H100 SXM dense bf16 (data sheet)
#: din: the reference's four DIN shapes (launch/specs.py DIN_SHAPE_TABLE):
#: samples, or candidates for the one user of retrieval_cand
DIN_SIZES = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
             "retrieval_cand": 1_000_000}
DIN_TRAIN_STEPS = 4            # din: train_batch steps on one batch
DIN_LR = 1e-3
DIN_P99_CALLS = 60             # din: serve_p99 calls, each synchronized
DIN_CANDS = 10007              # din (a): score_candidates check, padded
DIN_CHUNK = 4096               # score_candidates' default block
DIN_GRAD_BATCH = 4096          # din (a) gradients, (c) launcher, (d) psum
DIN_TOL = 1e-5                 # forward vs float64, scores vs forward
DIN_GRAD_TOL = 1e-4            # gradients vs float64, of max |g|
DIN_SLOTS = 4                  # din (d): compressed psum's slots
DIN_PSUM_STEPS = 4             # error feedback steps
DIN_PSUM_TOL = 0.1             # one-shot error, of max |exact sum|
DIN_TOPK = 0.01                # topk_compress's k_frac
SPMD_PHI4 = (2, 2, 4096)       # spmd (a): phi4 layers, batch, tokens a row
SPMD_MOE = (2, 2, 1024)        # spmd (a): qwen3 layers, batch, tokens a row
SPMD_LR = 1e-3                 # spmd (a): AdamW, no warmup
SPMD_LOSS_RTOL = 1e-5          # sharded vs unsharded loss and grad norm
SPMD_GRAD_TOL = 1e-4           # moments / gradients: max |Δ| of their max
#: the largest share of a parameter's elements that may be off by over 1%
#: of lr after the first AdamW step (the 8-rank CPU test reads 2.4e-4
#: sound and 0.55 for a wrong gradient)
SPMD_SHARE = 1e-2
#: spmd (b): the dry-run cells (both meshes each, every layer counted),
#: longest first, in parallel processes on the host; ``prefill_32k`` is
#: left out (minutes a cell: 64 q blocks a layer)
SPMD_DRYRUN = tuple((a, s) for s in ("train_4k", "decode_32k")
                    for a in ("gemma-7b", "qwen3-moe-30b-a3b", "minitron-4b",
                              "arctic-480b", "phi4-mini-3.8b"))
SPMD_DRYRUN_PROCS = 7          # one process a cell and mesh
SPMD_DRYRUN_TIMEOUT = 400      # seconds a dry-run process may take
#: shard: the kernels the sharded rows launch per shard
SHARD_KERNELS = ("bmv_bbb_push", "bmv_bbb_pull", "bmv_bff", "bmv_bbf",
                 "bmm_tc", "spgemm_bbb", "spmm_bbb", "spmm_dense",
                 "spmm_bbf", "pack_rows")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def sync_time(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = REPS) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = REPS):
    """Median device time of one launch of the kernel whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` (torch.profiler, CUPTI); None
    where three profiles in a row record no such launch (the profiler
    now and then drops a window's device events, or some of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times:
            return statistics.median(times)
    return None


def wrapper(name: str):
    """The wrapper of kernel ``name`` (it carries the launch count)."""
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bmm import bmm
    from repro_torch.kernels.bmv import bmv
    from repro_torch.kernels.spgemm import spgemm
    from repro_torch.kernels.spmm import spmm
    for mod in (bmv, bmm, spgemm, spmm, bitpack):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def reset_launches(names):
    for k in names:
        wrapper(k).launches = 0


def read_launches(phase: str, names):
    """The launch counts of ``names``; a kernel that never launched fails."""
    launches = {k: wrapper(k).launches for k in names}
    if not all(launches.values()):
        fail(phase, f"a kernel of the path never launched: {launches}")
    return launches


def kernel_args(m, x, mask, comp):
    return (m.tile_row_ptr, m.tile_col_idx, m.bit_tiles, x, mask), \
        {"t": m.tile_dim, "complement": comp}


def b2sr_args(m):
    return m.tile_row_ptr, m.tile_col_idx, m.bit_tiles


def value_err(got, want):
    """Largest |got - want| with equal entries (inf == inf) counting 0."""
    import torch
    d = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    return float(d.max()) if d.numel() else 0.0


def check_bff(m, x3, mode, a_value, items=None):
    """bmv_bff against its plain version: (error, error over the bound, ok).

    min_plus and max_times must be equal entry for entry; sum must stay
    within SUM_TOL · (A·|a·x|) elementwise (the plain sum is float64) and
    give the same bits on a second launch.
    """
    import torch
    from repro_torch.kernels.bmv import bmv, ref
    args, t = b2sr_args(m), m.tile_dim
    got = bmv.bmv_bff(*args, x3, t=t, mode=mode, a_value=a_value,
                      items=items)
    want = ref.bmv_bff(*args, x3, t=t, mode=mode, a_value=a_value)
    sync()
    err = value_err(got, want)
    if mode != "sum":
        return err, None, err == 0
    again = bmv.bmv_bff(*args, x3, t=t, mode=mode, a_value=a_value,
                        items=items)
    bound = SUM_TOL * ref.bmv_bff(*args, x3.abs(), t=t, mode="sum",
                                  a_value=abs(a_value))
    excess = (got.double() - want.double()).abs() - bound.double()
    ratio = float(((got - want).abs() / bound.clamp_min(1e-30)).max())
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    return err, ratio, bool((excess <= 0).all()) and same


def bff_inputs(n_tile_cols, t, rng, mode):
    """x3 for one mode: uniform [0, 1); min_plus gets 30% inf (unreached
    vertices, as in SSSP), max_times negative values too."""
    import torch
    x = rng.random((n_tile_cols, t), dtype=np.float32)
    if mode == "max_times":
        x = 2 * x - 1
    if mode == "min_plus":
        x[rng.random(x.shape) < 0.3] = np.inf
    return torch.as_tensor(x, device=DEVICE)


def phase_kernels(full_g, rng):
    """Each kernel against its plain version, on the card."""
    import torch
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.core.words import to_uint
    from repro_torch.data import graphs as G
    from repro_torch.kernels.bmv import bmv, ref
    from repro_torch.kernels.items import work_items

    small = {"dot": (G.dot_graph(3000, 0.004, seed=SEED), 3000),
             "rmat": (G.rmat_graph(4096, 16, seed=SEED), 4096),
             "road": (G.road_graph(64), 4096)}
    cases = [(name, GraphMatrix.from_coo(r, c, n, n, t, device=DEVICE))
             for name, ((r, c), n) in small.items() for t in (4, 8, 16, 32)]
    cases.append(("rmat_full", full_g.transposed()))
    n_checks, bad = 0, []
    max_err = dict.fromkeys(KERNELS, 0.0)
    worst_sum_ratio = 0.0
    for name, g in cases:
        m = g.b2sr
        # push, pull, bmv_bbf and bmv_bff also with items of 3 tiles:
        # every row of more than 3 tiles is cut and merged
        cuts = (None, work_items(m, 3))
        every_lane = {"lanes": torch.full((m.n_tile_rows,), -1,
                                          dtype=torch.int32, device=DEVICE)}
        for dens in DENSITIES:
            x = g.pack(torch.as_tensor(rng.random(g.n_cols) < dens,
                                       device=DEVICE))
            mask = g.pack_rows(torch.as_tensor(rng.random(g.n_rows) < 0.5,
                                               device=DEVICE))
            # push with no mask, the mask kept and its complement; pull
            # with the mask
            for mk, comp in ((None, True), (mask, True), (mask, False)):
                args, kw = kernel_args(m, x, mk, comp)
                runs = [("bmv_bbb_push", items, {}) for items in cuts]
                if mk is not None:   # pull with its row_lanes and without
                    runs += [("bmv_bbb_pull", items, extra)
                             for items, extra in itertools.product(
                                 cuts, ({}, every_lane))]
                for k, items, extra in runs:
                    got = getattr(bmv, k)(*args, **kw, items=items, **extra)
                    want = getattr(ref, k)(*args, **kw)
                    sync()
                    err = int((to_uint(got) - to_uint(want)).abs().max())
                    max_err[k] = max(max_err[k], err)
                    n_checks += 1
                    if err:
                        bad.append([k, name, m.tile_dim, dens,
                                    mk is not None, comp, items is None,
                                    bool(extra)])
            want = ref.bmv_bbf(*b2sr_args(m), x, t=m.tile_dim)
            for items in cuts:
                got = bmv.bmv_bbf(*b2sr_args(m), x, t=m.tile_dim,
                                  items=items)
                sync()
                err = int((got - want).abs().max())
                max_err["bmv_bbf"] = max(max_err["bmv_bbf"], err)
                n_checks += 1
                if err:
                    bad.append(["bmv_bbf", name, m.tile_dim, dens,
                                items is None])
        for mode in ref.BFF_MODES:
            x3 = bff_inputs(m.n_tile_cols, m.tile_dim, rng, mode)
            for a_value, items in itertools.product((1.0, 0.0), cuts):
                err, ratio, ok = check_bff(m, x3, mode, a_value, items)
                max_err["bmv_bff"] = max(max_err["bmv_bff"], err)
                if ratio is not None:
                    worst_sum_ratio = max(worst_sum_ratio, ratio)
                n_checks += 1
                if not ok:
                    bad.append(["bmv_bff", name, m.tile_dim, mode, a_value,
                                items is None])
    n_checks += check_row_products(cases[:-1], rng, max_err, bad)
    spmm_checks, dense_ratio = check_spmm(cases, max_err, bad)
    n_checks += spmm_checks
    n_checks += check_bit_kernels(cases, max_err, bad)
    emit({"phase": "kernels", "ok": not bad, "checks": n_checks,
          "max_abs_err": max_err,
          "bff_sum_err_over_bound": worst_sum_ratio,
          "spmm_dense_err_over_bound": dense_ratio,
          "mismatches": bad[:10]})
    if bad:
        fail("kernels", f"{len(bad)} kernel/plain mismatches")
    return max_err


def b2sr_mismatch(got, want) -> int:
    """0 when every B2SR array and ``nnz`` are equal, else the number of
    differing parts (shapes included)."""
    import torch
    bad = int(got.nnz != want.nnz)
    for part in ("tile_row_ptr", "tile_col_idx", "bit_tiles"):
        x, y = getattr(got, part), getattr(want, part)
        bad += int(x.shape != y.shape or not torch.equal(x, y))
    return bad


def scipy_adj(m):
    """The SciPy CSR of a B2SR's pattern."""
    import scipy.sparse as sp
    from repro_torch.core.b2sr import b2sr_to_coo
    rows, cols = (x.cpu().numpy() for x in b2sr_to_coo(m))
    return sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                         shape=(m.n_rows, m.n_cols))


def check_row_products(cases, rng, max_err, bad) -> int:
    """bmm_tc and spgemm_bbb against their plain versions, bit for bit,
    and the triangle counts and A² patterns against SciPy, on the small
    graphs. Returns the number of checks."""
    from repro_torch.core.b2sr import coo_to_b2sr
    from repro_torch.kernels.bmm import bmm, ref as bmm_ref
    from repro_torch.kernels.spgemm import ref as spgemm_ref, spgemm

    n_checks = 0
    for name, g in cases:
        m, t, n = g.b2sr, g.tile_dim, g.n_rows
        adj = scipy_adj(m)
        a2 = (adj @ adj).tocoo()
        sel = rng.random(a2.nnz) < 0.5           # half of A²'s pattern
        mask = coo_to_b2sr(a2.row[sel], a2.col[sel], n, n, t, DEVICE)
        for mk, comp in ((None, False), (mask, False), (mask, True)):
            got = spgemm.spgemm_bbb(m, m, mk, complement=comp)
            want = spgemm_ref.spgemm_bbb(m, m, mk, complement=comp)
            err = b2sr_mismatch(got, want)
            # every row heavy, none, or those of 64 pairs and more; blocks
            # of 2 warps (light: 1), rounds of 3 slots (light: 2): rows
            # built in rounds
            for heavy, threads, slots in ((0, (64, 64), (3, 3)),
                                          (spgemm.NEVER, (64, 64), (3, 3)),
                                          (64, (64, 32), (3, 2))):
                err += b2sr_mismatch(spgemm._spgemm_bbb(
                    m, m, mk, comp, heavy, threads, slots), want)
            if mk is None:                       # SciPy's A² pattern
                err += b2sr_mismatch(got, coo_to_b2sr(
                    a2.row, a2.col, n, n, t, DEVICE))
            max_err["spgemm_bbb"] = max(max_err["spgemm_bbb"], err)
            n_checks += 1
            if err:
                bad.append(["spgemm_bbb", name, t, mk is not None, comp])
        rows, cols = adj.nonzero()
        low = rows > cols
        lower = coo_to_b2sr(rows[low], cols[low], n, n, t, DEVICE)
        triangles = int(adj.multiply(adj @ adj).sum()) // 6
        for case, args in (("L", (lower, lower, lower)),
                           ("A.At<mask>", (m, m, mask))):
            got = int(bmm.bmm_tc(*args))
            err = abs(got - int(bmm_ref.bmm_tc(*args)))
            if case == "L":
                err += abs(got - triangles)
            max_err["bmm_tc"] = max(max_err["bmm_tc"], err)
            n_checks += 1
            if err:
                bad.append(["bmm_tc", name, t, case])
    for t in (4, 8, 16, 32):
        n_checks += check_tc_directed(t, rng, max_err, bad)
    return n_checks


def check_tc_directed(t: int, rng, max_err, bad) -> int:
    """bmm_tc with A, Bᵀ and the mask all different: A a directed graph
    with self-loops, repeated edges and a hub row, Bᵀ = Aᵀ (so B = A) and
    a random mask, against the plain version and SciPy's Σ M ⊙ (A·A);
    also with items of 64 probes, with the shorter-row split and with one
    walk of every Bᵀ row, and on a mask of the non-zero entries of A·A
    whose A row is shorter than their Bᵀ row (the plan moves every tile:
    the moved launch alone runs). Returns the number of checks."""
    import scipy.sparse as sp
    from repro_torch.core.b2sr import coo_to_b2sr
    from repro_torch.kernels.bmm import bmm, ref as bmm_ref

    n = 3000
    r = rng.integers(0, n, 30000)
    c = rng.integers(0, n, 30000)
    hub = np.arange(0, n, 2)
    loops = np.arange(0, n, 7)
    rows = np.concatenate([r, r[:5000], loops, np.full(hub.size, 5)])
    cols = np.concatenate([c, c[:5000], loops, hub])
    mr, mc = rng.integers(0, n, 60000), rng.integers(0, n, 60000)
    a = coo_to_b2sr(rows, cols, n, n, t, DEVICE)
    at = coo_to_b2sr(cols, rows, n, n, t, DEVICE)
    mask = coo_to_b2sr(mr, mc, n, n, t, DEVICE)
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    adj.data[:] = 1.0                    # repeated edges count once
    msk = sp.csr_matrix((np.ones(mr.size), (mr, mc)), shape=(n, n))
    msk.data[:] = 1.0
    prod = (adj @ adj).tocoo()
    want = int(prod.multiply(msk).sum())
    # the entries of A·A in tiles whose A row is shorter than the Bᵀ row
    a_len = (a.tile_row_ptr[1:] - a.tile_row_ptr[:-1]).cpu().numpy()
    at_len = (at.tile_row_ptr[1:] - at.tile_row_ptr[:-1]).cpu().numpy()
    short = a_len[prod.row // t] < at_len[prod.col // t]
    moved = coo_to_b2sr(prod.row[short], prod.col[short], n, n, t, DEVICE)
    n_checks = 0
    for case, m, probes, shorter, total in (
            ("default", mask, bmm.ITEM_PROBES, True, want),
            ("items_64", mask, 64, True, want),
            ("items_64_one_walk", mask, 64, False, want),
            ("every_tile_moved", moved, bmm.ITEM_PROBES, True,
             int(prod.data[short].sum()))):
        plan = bmm.tc_plan(a, at, m, probes, shorter)
        got = int(bmm.bmm_tc(a, at, m, plan=plan))
        plain = int(bmm_ref.bmm_tc(a, at, m))
        err = abs(got - plain) + abs(got - total)
        if case == "every_tile_moved":  # the case moves every tile
            err += plan.kept.n_tiles + int(m.n_tiles == 0)
        max_err["bmm_tc"] = max(max_err["bmm_tc"], err)
        n_checks += 1
        if err:
            bad.append(["bmm_tc", "directed", t, case, got, plain, total])
    return n_checks


def check_spmm(cases, max_err, bad):
    """spmm_bbb and spmm_dense against their plain versions on every case:
    spmm_bbb bit for bit at W = 1, 2, 3 source words, unmasked, masked and
    complemented (the plain masked result is the plain unmasked one ANDed
    with the mask, as ``ref.spmm_bbb`` computes it); spmm_dense bit for bit
    with small-integer X and within SUM_TOL · (A·|X|) with random X.
    Returns (checks, worst error over the bound)."""
    import torch
    from repro_torch.core.b2sr import pack_frontier_matrix
    from repro_torch.core.words import to_uint
    from repro_torch.kernels.spmm import ref, spmm

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    n_checks, worst = 0, 0.0
    for name, g in cases:
        m, t = g.b2sr, g.tile_dim
        full = name == "rmat_full"
        # on the small graphs also 33 source words, and items of 3 tiles
        sources = SPMM_SOURCES if full else SPMM_SOURCES + (SPMM_WIDE,)
        bbb_cuts = (None,) if full else (None, spmm.work_items(m, 3))
        for s in sources:
            mk = pack_frontier_matrix(rand(g.n_rows, s) < 0.5, t, g.n_rows)
            for dens in SPMM_DENSITIES:
                f = pack_frontier_matrix(rand(g.n_cols, s) < dens, t,
                                         g.n_cols)
                plain = ref.spmm_bbb(m, f)
                for (mask, comp), items in itertools.product(
                        ((None, True), (mk, True), (mk, False)), bbb_cuts):
                    got = spmm.spmm_bbb(m, f, mask, complement=comp,
                                        items=items)
                    want = (plain if mask is None
                            else plain & (~mk if comp else mk))
                    sync()
                    err = int((to_uint(got) - to_uint(want)).abs().max())
                    max_err["spmm_bbb"] = max(max_err["spmm_bbb"], err)
                    n_checks += 1
                    if err:
                        bad.append(["spmm_bbb", name, t, s, dens,
                                    mask is not None, comp, items is None])
        # items of 3 tiles cut every row of more than 3 tiles; on the
        # full graph their scratch would take n_slots · t · D floats
        cuts = (None,) if full else (None, spmm.work_items(m, 3))
        for d in (SPMM_FULL_WIDTHS if full else SPMM_WIDTHS):
            xi = torch.randint(-3, 4, (g.n_cols, d), generator=gen,
                               device=DEVICE).float()
            want_i = ref.spmm_dense(m, xi)
            xf = torch.randn((g.n_cols, d), generator=gen, device=DEVICE)
            want = ref.spmm_dense(m, xf)
            bound = SUM_TOL * ref.spmm_dense(m, xf.abs()).double()
            for items in cuts:
                err = value_err(spmm.spmm_dense(m, xi, items=items), want_i)
                got = spmm.spmm_dense(m, xf, items=items)
                again = spmm.spmm_dense(m, xf, items=items)
                same = torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))
                # every V sums in the same order: the same bits
                for vec in (spmm.DENSE_VECS if d > 32 and not full
                            else ()):
                    same &= torch.equal(got.view(torch.int32),
                                        spmm._spmm_dense(
                                            m, xf, items,
                                            vec).view(torch.int32))
                diff = (got.double() - want.double()).abs()
                worst = max(worst,
                            float((diff / bound.clamp_min(1e-30)).max()))
                max_err["spmm_dense"] = max(max_err["spmm_dense"], err,
                                            value_err(got, want))
                n_checks += 3
                if err or not same or not bool((diff <= bound).all()):
                    bad.append(["spmm_dense", name, t, d, err, same,
                                items is None])
    return n_checks, worst


def plain_bit_transpose(words, t: int):
    """The plain bit transpose, TRANSPOSE_CHUNK tiles at a time (it
    unpacks every tile to t * t values)."""
    import torch
    from repro_torch.kernels.bitpack import ref
    return torch.cat([ref.bit_transpose(words[s:s + TRANSPOSE_CHUNK], t)
                      for s in range(0, words.shape[0], TRANSPOSE_CHUNK)])


def uint_err(got, want) -> int:
    from repro_torch.core.words import to_uint
    if got.shape != want.shape:
        return -1
    return int((to_uint(got) - to_uint(want)).abs().max()) if got.numel() \
        else 0


def check_bit_kernels(cases, max_err, bad) -> int:
    """spmm_bbf, pack_rows, pack_dense and bit_transpose against their
    plain versions, bit for bit: spmm_bbf at D = 1, 7, 16, 33, 130 on the
    small graphs (with work items of 3 tiles and of 5 set bits too, so
    every row merges several items) and at D = 16 on the full graph;
    pack_rows on [n, D] float32 and bool inputs at the same widths, and
    on ``rows_inputs`` at every tile dim; pack_dense of each small
    graph's dense adjacency, row- and column-major, also against the
    B2SR's own tiles, and of ``pack_inputs``; bit_transpose of every
    case's tiles. Returns the number of checks."""
    import torch
    from repro_torch.core.b2sr import b2sr_to_coo, b2sr_to_packed_grid
    from repro_torch.kernels.bitpack import bitpack, ref as bref
    from repro_torch.kernels.spmm import ref, spmm

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    n_checks = 0

    def record(kernel, err, *where):
        nonlocal n_checks
        max_err[kernel] = max(max_err[kernel], abs(err))
        n_checks += 1
        if err:
            bad.append([kernel, *where, err])

    for name, g in cases:
        m, t, n = g.b2sr, g.tile_dim, g.n_rows
        full = name == "rmat_full"
        for d in ((16,) if full else GNN_WIDTHS):
            x = torch.randn((g.n_cols, d), generator=gen, device=DEVICE)
            x[torch.rand((g.n_cols, d), generator=gen, device=DEVICE)
              < 0.5] = 0.0
            for xx in (x, x != 0):
                got = bitpack.pack_rows(xx, t)
                record("pack_rows", uint_err(got, bref.pack_rows(xx, t)),
                       name, t, d, str(xx.dtype))
            xw = got
            want = ref.spmm_bbf(m, xw, torch.int32)
            cuts = (None,) if full else (
                None, spmm.work_items(m, 3),
                spmm.work_items(m, 5, by_bits=True))
            for items in cuts:
                got = spmm.spmm_bbf(m, xw, torch.int32, items=items)
                record("spmm_bbf", int((got - want).abs().max()), name, t,
                       d, items is None)
        record("bit_transpose",
               uint_err(bitpack.bit_transpose(m.bit_tiles, t),
                        plain_bit_transpose(m.bit_tiles, t)), name, t)
        if full:
            continue
        rows, cols = b2sr_to_coo(m)
        dense = torch.zeros((n, g.n_cols), dtype=torch.bool, device=DEVICE)
        dense[rows, cols] = True
        grid = b2sr_to_packed_grid(m)
        for col_major in (False, True):
            got = bitpack.pack_dense(dense, t, col_major)
            err = uint_err(got, bref.pack_dense(dense, t, col_major))
            if not col_major:
                err = err or uint_err(got, grid)
            record("pack_dense", err, name, t, col_major)
    for (label, x), t, col_major in itertools.product(
            pack_inputs(gen), (4, 8, 16, 32), (False, True)):
        record("pack_dense", uint_err(bitpack.pack_dense(x, t, col_major),
                                      bref.pack_dense(x, t, col_major)),
               label, t, col_major)
    for (label, x), t in itertools.product(rows_inputs(gen), (4, 8, 16, 32)):
        record("pack_rows", uint_err(bitpack.pack_rows(x, t),
                                     bref.pack_rows(x, t)), label, t)
    return n_checks


def pack_entries(gen, dtype, n, m):
    """[n, m] 0/1-pattern entries of ``dtype`` on the card: about 30%
    non-zero (values -3..3 where signed), float32 with -0.0 for about half
    its zeros and a NaN at [0, -1]."""
    import torch
    keep = torch.rand((n, m), generator=gen, device=DEVICE) < 0.3
    v = torch.randint(-3, 4, (n, m), generator=gen, device=DEVICE)
    if dtype == torch.bool:
        return keep
    if dtype == torch.uint8:
        v = v.abs()
    x = torch.where(keep, v, 0).to(dtype)
    if dtype == torch.float32:
        x[~keep & (torch.rand((n, m), generator=gen, device=DEVICE)
                   < 0.5)] = -0.0
        x[0, -1] = float("nan")
    return x


def entry_inputs(gen, widths, offset_width):
    """(label, [PACK_ROWS, m] entries) for each entry type at ``widths``
    (70 rows: not a multiple of 32 or of any tile dim), and contiguous
    [PACK_ROWS, offset_width] views with a storage offset of 5 entries
    (rows off 16 bytes) and of 16 bytes."""
    import torch
    n = PACK_ROWS
    for name, m in itertools.product(PACK_DTYPES, widths):
        yield (f"{name}[{n}, {m}]",
               pack_entries(gen, getattr(torch, name), n, m))
    m = offset_width
    for name in PACK_DTYPES:
        flat = pack_entries(gen, getattr(torch, name), 1,
                            n * m + 64).flatten()
        for off in (5, 16 // flat.element_size()):
            yield (f"{name}[{n}, {m}] offset {off}",
                   flat[off:off + n * m].view(n, m))


def pack_inputs(gen):
    """pack_dense inputs beside the adjacencies: each entry type at
    PACK_WIDTHS (widths whose rows start off 16 bytes, and runs past the
    last column, take the kernel's scalar path), float32 with -0.0 and
    NaN, and offset views of width 1,040."""
    return entry_inputs(gen, PACK_WIDTHS, 1040)


def rows_inputs(gen):
    """pack_rows inputs beside the graphs' activations: each entry type at
    GNN_WIDTHS (D = 16 takes the kernel's 16-byte loads, the other widths
    its scalar path) and offset views of width 16 (5 entries: the scalar
    path; 16 bytes: the 16-byte loads from a base with an offset)."""
    return entry_inputs(gen, GNN_WIDTHS, 16)


def one_row(m, r: int):
    """The B2SR of the same shape holding only tile-row ``r`` of ``m``."""
    import dataclasses
    ptr = m.tile_row_ptr
    lo, hi = int(ptr[r]), int(ptr[r + 1])
    only = ptr.new_zeros(ptr.shape)
    only[r + 1:] = hi - lo
    return dataclasses.replace(m, tile_row_ptr=only,
                               tile_col_idx=m.tile_col_idx[lo:hi],
                               bit_tiles=m.bit_tiles[lo:hi])


def b2sr_bytes(*mats) -> int:
    """Bytes of the B2SR arrays of ``mats``, each distinct one once."""
    seen = {id(m): m for m in mats}
    return sum(4 * (m.tile_row_ptr.numel() + m.n_tiles * (1 + m.tile_dim))
               for m in seen.values())


def phase_tc(g):
    """Triangle counting on b2sr_cuda (bmm_tc on L) and csr: equal counts,
    the kernel equal to its plain version on L, and times."""
    import torch
    from repro_torch.algorithms import triangle_count
    from repro_torch.core.b2sr import tile_rows
    from repro_torch.core.graphblas import LowerTriangle
    from repro_torch.kernels.bmm import bmm, ref

    t = g.tile_dim
    lt, split_s = sync_time(lambda: LowerTriangle(g.csr, t, g.n_rows))
    _, pack_s = sync_time(lambda: lt.b2sr)
    g.tri_cache = lt
    gc = g.with_backend("csr")                  # shares the memoized L
    reset_launches(("bmm_tc",))
    count, wall = sync_time(lambda: triangle_count(g))
    _, wall2 = sync_time(lambda: triangle_count(g))
    launches = read_launches("tc", ("bmm_tc",))
    _, csr_build_s = sync_time(lambda: lt.csr)
    count_csr, wall_csr = sync_time(lambda: triangle_count(gc))
    low = lt.b2sr
    # the plan the triangle row keeps with L: the mask's tiles split by
    # the shorter row, and the items (built once, timed apart)
    plan, plan_s = sync_time(lambda: bmm.tc_plan(low, low, low))
    total, work, queued = bmm._bmm_tc(low, low, low, True, True, plan)
    plain, plain_s = sync_time(lambda: ref.bmm_tc(low, low, low))
    err = abs(int(total) - int(plain))
    ms = event_ms(lambda: bmm.bmm_tc(low, low, low, plan=plan), reps=5)
    ms_building_plan = event_ms(lambda: bmm.bmm_tc(low, low, low), reps=3)
    ptr = low.tile_row_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    probes = torch.zeros_like(lens).index_add_(
        0, tile_rows(low), lens[low.tile_col_idx.long()])
    heavy = {}
    for key, r in (("most_probes", int(probes.argmax())),
                   ("most_tiles", int(lens.argmax()))):
        heavy[key] = {"row": r, "tiles": int(lens[r]),
                      "probes": int(probes[r]),
                      "ms": event_ms(lambda r=r: bmm.bmm_tc(
                          low, low, one_row(low, r)), reps=3)}
    problems = []
    if count != count_csr:
        problems.append(f"b2sr_cuda {count} != csr {count_csr}")
    if err:
        problems.append(f"bmm_tc {int(total)} != plain {int(plain)}")
    # a few operations per (mask bit, common tile) pair, and the least
    # merge of the two sorted rows that finds the common tiles
    walk = bmm.min_walk(low, low, low)
    bound = bound_row(b2sr_bytes(low) + 8, 3 * int(work) + walk)
    emit({"phase": "tc", "ok": not problems, "problems": problems,
          "triangles": count, "float32_exact": float(np.float32(count))
          == count, "launches": launches,
          "lower": {"nnz": low.nnz, "n_tiles": low.n_tiles,
                    "max_tiles_per_row": int(lens.max()),
                    "probes": int(probes.sum()),
                    "mask_bit_tile_pairs": int(work), "min_walk": walk,
                    "queued_entries": int(queued)},
          "split_s": split_s, "pack_s": pack_s, "csr_build_s": csr_build_s,
          "wall_s": {"b2sr_cuda": [wall, wall2], "csr": wall_csr},
          "kernel_ms": ms, "kernel_building_plan_ms": ms_building_plan,
          "plan_s": plan_s, "plan": {
              "kept_tiles": plan.kept.n_tiles,
              "moved_tiles": 0 if plan.moved is None else plan.moved.n_tiles,
              "items": int(plan.kept_items[0].numel()) + (
                  0 if plan.moved is None
                  else int(plan.moved_items[0].numel()))},
          "plain_s": plain_s, "heavy_rows": heavy,
          **bound})
    if problems:
        fail("tc", "; ".join(problems))
    return {"name": "bmm_tc", "ms": ms, "plain_ms": 1e3 * plain_s,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "csr_row_ms": 1e3 * wall_csr,
            "launches": launches["bmm_tc"], "max_abs_err": err,
            "inputs": "L of the R-MAT graph (A = mask = Bᵀ = L); no one "
                      "PyTorch call computes the masked sum"}


def spgemm_ops(a, b) -> int:
    """ORs the boolean SpGEMM needs: per A tile (I, X), its set bits times
    the tiles of B's row X."""
    from repro_torch.core.words import popcount
    ptr = b.tile_row_ptr.long()
    lens = (ptr[1:] - ptr[:-1])[a.tile_col_idx.long()]
    return int((popcount(a.bit_tiles).sum(1).long() * lens).sum())


def spgemm_work(a, b):
    """The work counts of A·B: tile pairs (A(I,X), B(X,J)); the ORs the
    word algorithm needs (set bits of A(I,X) times the tiles of B's row
    X); (non-zero word of A(I,X), tile of B's row X) pairs; the pairs
    whose A column occupancy meets B's row occupancy, which the kernel
    works on, and the words of B they read (set bits of the two
    occupancies' AND)."""
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.core.words import popcount
    t = a.tile_dim
    ptr = b.tile_row_ptr.long()
    lens = (ptr[1:] - ptr[:-1])[a.tile_col_idx.long()]
    acol = torch.zeros(a.n_tiles, dtype=torch.int32, device=a.device)
    for r in range(t):
        acol |= a.bit_tiles[:, r]
    occ = torch.zeros(b.n_tiles, dtype=torch.int32, device=b.device)
    for r in range(t):
        occ |= (b.bit_tiles[:, r] != 0).int() << r
    rows_set = (a.bit_tiles != 0).sum(1).long()
    meet = reads = 0
    for k0, k1 in csr_mod.work_chunks(lens):
        rep, off = csr_mod.expand(lens[k0:k1], k0)
        q = ptr[a.tile_col_idx[rep].long()] + off
        m = acol[rep] & occ[q]
        meet += int((m != 0).sum())
        reads += int(popcount(m).sum(dtype=torch.int64))
        del rep, off, q, m
    return {"tile_pairs": int(lens.sum()), "ors": spgemm_ops(a, b),
            "set_row_pairs": int((rows_set * lens).sum()),
            "meeting_pairs": meet, "b_word_reads": reads}


def spgemm_passes(a, b, mk, comp, reps: int = 3):
    """Median ms of the window, count and fill launches of spgemm_bbb
    (CUDA events around each) and the shape each took (threads, and the
    fill's slots a round and tiles of A a run)."""
    from repro_torch.kernels.spgemm import spgemm
    times, shapes = {}, {}
    for _ in range(reps + 1):                # the first warms up
        events = []
        spgemm._spgemm_bbb(a, b, mk, comp, events=events)
        sync()
        for name, start, end, shape in events:
            times.setdefault(name, []).append(start.elapsed_time(end))
            shapes[name] = list(shape)
    return {name: {"ms": statistics.median(v[1:]), "shape": shapes[name]}
            for name, v in times.items()}


def cusparse_spgemm_ms(csr):
    """cuSPARSE's SpGEMM (``torch.sparse.mm``) of the float CSR by itself,
    one call per row chunk of at most ``csr.CHUNK_WEDGES`` wedges (the
    chunks of the ``csr`` row; one call over all of R-MAT scale 16's A·A
    fails with CUSPARSE_STATUS_INSUFFICIENT_RESOURCES), summed: the
    yardstick, which the port never calls on the b2sr_cuda path."""
    import torch
    from repro_torch.core import csr as csr_mod
    spm = csr_mod.to_sparse(csr)
    wedges = torch.zeros(csr.n_rows, dtype=torch.int64,
                         device=csr.values.device).index_add_(
        0, csr.row_idx.long(), csr_mod.row_lengths(csr)[csr.col_idx.long()])
    chunks = list(csr_mod.work_chunks(wedges))
    total = 0.0
    for r0, r1 in chunks:
        part = csr_mod.to_sparse(csr, slice(r0, r1))
        total += event_ms(lambda: torch.sparse.mm(part, spm), reps=3)
    return total, len(chunks)


def phase_spgemm():
    """A² and A²⟨¬A⟩ at R-MAT scale 16 on b2sr_cuda and csr."""
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels.spgemm import ref, spgemm

    n = 1 << SPGEMM_SCALE
    rows, cols = rmat_graph(n, avg_degree=2 * EDGEFACTOR, seed=SEED)
    g = GraphMatrix.from_coo(rows, cols, n, n, TILE_DIM, backend="b2sr_cuda",
                             device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    cases = {"A2": lambda gg: gg.mxm(gg),
             "A2_not_A": lambda gg: gg.mxm(gg, mask=gg, complement=True)}
    res, wall, launches = run_both("spgemm", g, ("spgemm_bbb",), cases)
    a = g.b2sr
    problems, err, timing = [], 0, {}
    for key, (mk, comp) in {"A2": (None, False),
                            "A2_not_A": (a, True)}.items():
        got = res["b2sr_cuda", key].b2sr
        if b2sr_mismatch(got, res["csr", key].b2sr):
            problems.append(f"{key}: b2sr_cuda != csr")
        plain, plain_s = sync_time(lambda: ref.spgemm_bbb(
            a, a, mk, complement=comp))
        e = b2sr_mismatch(got, plain)
        err = max(err, e)
        if e:
            problems.append(f"{key}: spgemm_bbb != plain")
        timing[key] = {
            "nnz": got.nnz, "n_tiles": got.n_tiles,
            "ms": event_ms(lambda: spgemm.spgemm_bbb(a, a, mk,
                                                     complement=comp),
                           reps=5),
            "passes": spgemm_passes(a, a, mk, comp),
            "plain_ms": 1e3 * plain_s,
            **bound_row(b2sr_bytes(a, got), spgemm_ops(a, a))}
    peak = torch.cuda.max_memory_allocated()
    del res
    torch.cuda.empty_cache()
    work = spgemm_work(a, a)
    library_ms, n_chunks = cusparse_spgemm_ms(g.csr)
    emit({"phase": "spgemm", "ok": not problems, "problems": problems,
          "scale": SPGEMM_SCALE, "directed_edges": len(rows),
          "n_tiles": a.n_tiles, "launches": launches,
          "wall_s": {f"{be}/{k}": wall[be, k] for be in ("b2sr_cuda", "csr")
                     for k in cases},
          "kernel": timing, "work": work,
          "cusparse_spgemm_ms": library_ms,
          "cusparse_row_chunks": n_chunks, "peak_device_bytes": peak})
    if problems:
        fail("spgemm", "; ".join(problems))
    row = timing["A2"]
    return {"name": "spgemm_bbb", "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms,
            "csr_row_ms": 1e3 * wall["csr", "A2"],
            "launches": launches["spgemm_bbb"], "max_abs_err": err,
            "inputs": f"A·A of R-MAT scale {SPGEMM_SCALE}, no mask; road_hop_*: "
                      f"one k-hop product A²<¬A> of the road grid of side "
                      f"{ROAD_SIDE}"}


def khop_calls(g):
    """Walls of the k-hop calls after the phase's first: two more, then
    one after ``torch.cuda.empty_cache()`` (the caching allocator takes
    its blocks anew with cudaMalloc); and for a warm call and a call
    after ``empty_cache``, the host's time by op (torch.profiler, self CPU
    time, the ten largest: the waits at the host syncs show as
    ``cudaStreamSynchronize``, the allocator's as ``cudaMalloc``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.algorithms import khop_reachability

    def run():
        return khop_reachability(g, KHOP_K)

    out = {"repeat_wall_s": [sync_time(run)[1] for _ in range(2)]}
    torch.cuda.empty_cache()
    out["after_empty_cache_wall_s"] = sync_time(run)[1]
    for name in ("warm", "after_empty_cache"):
        if name != "warm":
            torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = sync_time(run)
        ops = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)
        out[f"host_{name}"] = {
            "wall_ms": 1e3 * wall,
            "top_self_cpu_ms": [[e.key, e.self_cpu_time_total / 1e3,
                                 e.count] for e in ops[:10]]}
    return out


def phase_khop():
    """3-hop reachability on a road grid on b2sr_cuda and csr."""
    from repro_torch.algorithms import khop_reachability
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import road_graph
    from repro_torch.kernels.spgemm import ref, spgemm

    n = ROAD_SIDE * ROAD_SIDE
    rows, cols = road_graph(ROAD_SIDE)
    g = GraphMatrix.from_coo(rows, cols, n, n, TILE_DIM, backend="b2sr_cuda",
                             device=DEVICE)
    res, wall, launches = run_both(
        "khop", g, ("spgemm_bbb",),
        {"khop": lambda gg: khop_reachability(gg, KHOP_K)})
    a, b = res["b2sr_cuda", "khop"], res["csr", "khop"]
    problems = []
    if a.n_iterations != b.n_iterations:
        problems.append(f"n_iterations {a.n_iterations} != csr "
                        f"{b.n_iterations}")
    if b2sr_mismatch(a.reach.b2sr, b.reach.b2sr):
        problems.append("reach != csr")
    calls = khop_calls(g)
    m = g.b2sr                                   # one hop: A²⟨¬A⟩
    hop = spgemm.spgemm_bbb(m, m, m, complement=True)
    plain, plain_s = sync_time(lambda: ref.spgemm_bbb(m, m, m,
                                                      complement=True))
    hop_err = b2sr_mismatch(hop, plain)
    if hop_err:
        problems.append("spgemm_bbb != plain on the hop A²<¬A>")
    hop_row = {"nnz": hop.nnz, "n_tiles": hop.n_tiles,
               "ms": event_ms(lambda: spgemm.spgemm_bbb(m, m, m,
                                                        complement=True)),
               "passes": spgemm_passes(m, m, m, True),
               "plain_ms": 1e3 * plain_s, "work": spgemm_work(m, m),
               **bound_row(b2sr_bytes(m, hop), spgemm_ops(m, m))}
    emit({"phase": "khop", "ok": not problems, "problems": problems,
          "side": ROAD_SIDE, "k": KHOP_K, "n": n, "directed_edges": len(rows),
          "n_iterations": a.n_iterations, "reach_nnz": a.reach.nnz,
          "reach_tiles": a.reach.b2sr.n_tiles, "launches": launches,
          "wall_s": {be: wall[be, "khop"] for be in ("b2sr_cuda", "csr")},
          "b2sr_cuda_calls": calls, "hop_product": hop_row})
    if problems:
        fail("khop", "; ".join(problems))
    return g, launches, hop_err, hop_row


def scipy_levels(adj, sources):
    from scipy.sparse.csgraph import shortest_path
    d = shortest_path(adj, directed=True, unweighted=True, indices=sources)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def phase_bfs(g, deg, sources, want):
    """The BFS path on b2sr_cuda, checked against csr and SciPy.

    Rate: Graph500's traversed edges per second, the undirected edges of
    the source's component over the traversal's wall time.
    """
    from repro_torch.algorithms import bfs

    names = ("bmv_bbb_push", "bmv_bbb_pull")
    reset_launches(names)
    runs, wall = {}, {}
    for d in DIRECTIONS:
        for s in sources:
            runs["b2sr_cuda", d, s], wall["b2sr_cuda", d, s] = sync_time(
                lambda: bfs(g, s, direction=d))
    launches = read_launches("bfs", names)
    gc = g.with_backend("csr")
    for d in DIRECTIONS:
        for s in sources:
            runs["csr", d, s], wall["csr", d, s] = sync_time(
                lambda: bfs(gc, s, direction=d))
    problems = []
    for d in DIRECTIONS:
        for i, s in enumerate(sources):
            a, b = runs["b2sr_cuda", d, s], runs["csr", d, s]
            lv = a.levels.cpu().numpy()
            if not np.array_equal(lv, b.levels.cpu().numpy()):
                problems.append(f"levels != csr ({d}, {s})")
            if (a.n_iterations, a.directions) != (b.n_iterations,
                                                  b.directions):
                problems.append(f"schedule != csr ({d}, {s})")
            if not np.array_equal(lv, want[i]):
                problems.append(f"levels != scipy ({d}, {s})")
    first = runs["b2sr_cuda", "auto", sources[0]]
    edges = {s: int(deg[want[i] >= 0].sum()) // 2
             for i, s in enumerate(sources)}
    emit({"phase": "bfs", "ok": not problems, "problems": problems[:10],
          "sources": sources, "launches": launches,
          "reached": [int((want[i] >= 0).sum()) for i in range(len(sources))],
          "traversed_edges": [edges[s] for s in sources],
          "n_iterations": {d: [runs["b2sr_cuda", d, s].n_iterations
                               for s in sources] for d in DIRECTIONS},
          "auto_directions": list(first.directions),
          "bfs_wall_s": {f"{be}/{d}": [wall[be, d, s] for s in sources]
                         for be in ("b2sr_cuda", "csr")
                         for d in DIRECTIONS},
          "median_gteps": {f"{be}/{d}": statistics.median(
              edges[s] / wall[be, d, s] / 1e9 for s in sources)
              for be in ("b2sr_cuda", "csr") for d in DIRECTIONS}})
    if problems:
        fail("bfs", "; ".join(problems[:5]))
    return runs["b2sr_cuda", "push", sources[0]], launches


def run_both(phase, g, names, cases):
    """Run ``cases`` ({key: fn(graph)}) on b2sr_cuda (launch counts reset
    just before, read just after), then on csr; results and wall times."""
    reset_launches(names)
    res, wall = {}, {}
    for key, fn in cases.items():
        res["b2sr_cuda", key], wall["b2sr_cuda", key] = sync_time(
            lambda: fn(g))
    launches = read_launches(phase, names)
    gc = g.with_backend("csr")
    for key, fn in cases.items():
        res["csr", key], wall["csr", key] = sync_time(lambda: fn(gc))
    return res, wall, launches


def phase_sssp(g, sources, want):
    """SSSP on both backends; distances must equal SciPy's levels."""
    from repro_torch.algorithms import sssp

    res, wall, launches = run_both(
        "sssp", g, ("bmv_bff",),
        {s: (lambda gg, s=s: sssp(gg, s)) for s in sources})
    problems = []
    for i, s in enumerate(sources):
        ref_d = np.where(want[i] < 0, np.inf, want[i]).astype(np.float32)
        for be in ("b2sr_cuda", "csr"):
            if not np.array_equal(res[be, s].distances.cpu().numpy(), ref_d):
                problems.append(f"distances != scipy ({be}, {s})")
        if res["b2sr_cuda", s].n_iterations != res["csr", s].n_iterations:
            problems.append(f"n_iterations != csr ({s})")
    emit({"phase": "sssp", "ok": not problems, "problems": problems[:10],
          "sources": sources, "launches": launches,
          "n_iterations": [res["b2sr_cuda", s].n_iterations for s in sources],
          "sssp_wall_s": {be: [wall[be, s] for s in sources]
                          for be in ("b2sr_cuda", "csr")}})
    if problems:
        fail("sssp", "; ".join(problems[:5]))
    return res["b2sr_cuda", sources[0]], launches


def numpy_ranks(adj, n_iterations, alpha=0.85, restart=None):
    """The port's PageRank / PPR update in float64 with SciPy's A."""
    n = adj.shape[0]
    at = adj.T.tocsr()
    deg = np.asarray(adj.getnnz(axis=1), dtype=np.float64)
    dangling = deg == 0
    safe = np.where(dangling, 1.0, deg)
    pr = np.full(n, 1.0 / n) if restart is None else restart.copy()
    for _ in range(n_iterations):
        contrib = at @ (pr / safe)
        dm = pr[dangling].sum()
        if restart is None:
            pr = alpha * (contrib + dm / n) + (1 - alpha) / n
        else:
            pr = alpha * contrib + (alpha * dm + 1 - alpha) * restart
    return pr


def phase_pagerank(g, adj, source):
    """PageRank and PPR on both backends against float64 numpy."""
    from repro_torch.algorithms import pagerank, ppr

    res, wall, launches = run_both(
        "pagerank", g, ("bmv_bff",),
        {"pagerank": pagerank, "ppr": lambda gg: ppr(gg, source)})
    restart = np.zeros(g.n_rows)
    restart[source] = 1.0
    problems, rel = [], {}
    for key, rs in (("pagerank", None), ("ppr", restart)):
        n_it = res["b2sr_cuda", key].n_iterations
        want = numpy_ranks(adj, n_it, restart=rs)
        got = {be: res[be, key].ranks.cpu().numpy().astype(np.float64)
               for be in ("b2sr_cuda", "csr")}
        for be, other in (("b2sr_cuda", want), ("csr", want),
                          ("b2sr_cuda", got["csr"])):
            label = f"{key}/{be} vs {'numpy' if other is want else 'csr'}"
            nz = other != 0
            rel[label] = float(np.max(np.abs(got[be] - other)[nz]
                                      / np.abs(other[nz])))
            if not np.allclose(got[be], other, rtol=RANK_RTOL, atol=0):
                problems.append(label)
        if n_it != res["csr", key].n_iterations:
            problems.append(f"{key} n_iterations != csr")
    emit({"phase": "pagerank", "ok": not problems, "problems": problems,
          "launches": launches, "max_rel_err": rel,
          "n_iterations": {k: res["b2sr_cuda", k].n_iterations
                           for k in ("pagerank", "ppr")},
          "wall_s": {f"{be}/{k}": wall[be, k]
                     for be in ("b2sr_cuda", "csr")
                     for k in ("pagerank", "ppr")}})
    if problems:
        fail("pagerank", "; ".join(problems))
    return res["b2sr_cuda", "pagerank"], launches


def phase_cc(g, adj):
    """CC push/pull/auto on both backends against SciPy's components."""
    from scipy.sparse.csgraph import connected_components as scipy_cc
    from repro_torch.algorithms import connected_components

    n_comp, comp = scipy_cc(adj, directed=False)
    rep = np.full(n_comp, g.n_rows, dtype=np.int64)
    np.minimum.at(rep, comp, np.arange(g.n_rows))
    want = rep[comp].astype(np.int32)
    res, wall, launches = run_both(
        "cc", g, ("bmv_bff",),
        {d: (lambda gg, d=d: connected_components(gg, direction=d))
         for d in DIRECTIONS})
    problems = []
    for d in DIRECTIONS:
        a, b = res["b2sr_cuda", d], res["csr", d]
        if not np.array_equal(a.labels.cpu().numpy(), want):
            problems.append(f"labels != scipy (b2sr_cuda, {d})")
        if not np.array_equal(b.labels.cpu().numpy(), want):
            problems.append(f"labels != scipy (csr, {d})")
        if (a.n_iterations, a.directions) != (b.n_iterations, b.directions):
            problems.append(f"schedule != csr ({d})")
    emit({"phase": "cc", "ok": not problems, "problems": problems,
          "components": int(n_comp), "launches": launches,
          "n_iterations": {d: res["b2sr_cuda", d].n_iterations
                           for d in DIRECTIONS},
          "directions": {d: list(res["b2sr_cuda", d].directions)
                         for d in DIRECTIONS},
          "cc_wall_s": {f"{be}/{d}": wall[be, d]
                        for be in ("b2sr_cuda", "csr") for d in DIRECTIONS}})
    if problems:
        fail("cc", "; ".join(problems))
    return res["b2sr_cuda", "push"], launches


def frontiers(gt, levels, n_iterations):
    """The packed frontier of each iteration of one BFS (column space of
    ``gt``), as BitVectors."""
    import torch
    from repro_torch.core.operands import BitVector
    return [BitVector.pack((levels == it).to(torch.int32), gt.tile_dim,
                           gt.n_cols) for it in range(n_iterations)]


def phase_mxv(g, levels, n_iterations, rng):
    """The count row and the max-times dense row through GraphMatrix.mxv
    on b2sr_cuda, each against csr (exact), masked and unmasked."""
    import torch
    from repro_torch.core.descriptor import Descriptor
    from repro_torch.core.operands import BitVector
    from repro_torch.core.semiring import ARITHMETIC, MAX_TIMES

    gt = g.transposed()
    mask = BitVector.pack(torch.as_tensor(rng.random(gt.n_rows) < 0.5,
                                          device=DEVICE), gt.tile_dim,
                          gt.n_rows)
    x = torch.as_tensor(2 * rng.random(gt.n_cols, dtype=np.float32) - 1,
                        device=DEVICE)
    fronts = frontiers(gt, levels, n_iterations)
    cases = {f"count/{i}": (lambda gg, xf=xf: gg.mxv(
        xf, ARITHMETIC, out_dtype=torch.int32)) for i, xf in enumerate(fronts)}
    cases["count/masked"] = lambda gg: gg.mxv(
        fronts[n_iterations // 2], ARITHMETIC,
        Descriptor(mask=mask, complement=True))
    for a_value in (1.0, 0.5):
        cases[f"max_times/{a_value}"] = (lambda gg, a=a_value: gg.mxv(
            x, MAX_TIMES, a_value=a))
    cases["max_times/masked"] = lambda gg: gg.mxv(
        x, MAX_TIMES, Descriptor(mask=mask), a_value=0.5)
    res, wall, launches = run_both("mxv", gt, ("bmv_bff", "bmv_bbf"), cases)
    problems = [k for k in cases
                if not torch.equal(res["b2sr_cuda", k], res["csr", k])]
    emit({"phase": "mxv", "ok": not problems, "problems": problems,
          "launches": launches,
          "wall_ms": {f"{be}/{k}": 1e3 * wall[be, k]
                      for be in ("b2sr_cuda", "csr") for k in cases}})
    if problems:
        fail("mxv", f"b2sr_cuda != csr on {problems}")
    return launches


def needed_bytes_ops(m, x, mask, kernel):
    """Bytes and operations the inputs need (data-dependent).

    Counted once: row pointers, x, mask and the output. Push and pull
    compute one function: bit b of a row's output is set iff an allowed
    lane b of the row is set by some tile (word b & x word != 0). For
    each allowed lane that some tile sets, one witness suffices: the
    first such tile in stored order, its column index (once per tile,
    however many lanes it witnesses) and its word b. A row with an
    allowed lane that no tile sets must show it: the column index of
    every tile of the row, and word b of every tile whose x word is
    non-zero, for each such lane b. Operations: an AND and an OR per
    tile word read. The count kernel reads the column index of every
    tile and the words of each tile whose frontier word is non-zero, and
    writes t int32 per tile-row, with an AND, a popcount and an add per
    tile word read.
    """
    import torch
    from repro_torch.core.b2sr import tile_rows
    from repro_torch.core.words import lane_mask, unpack_bits

    t = m.tile_dim
    r, c = m.n_tile_rows, m.n_tile_cols
    xw = x[m.tile_col_idx.long()]
    xw_nz = xw != 0
    if kernel == "bmv_bbf":
        n_tiles = int(xw_nz.sum())
        nbytes = 4 * ((r + 1) + m.n_tiles + n_tiles * t + c + r * t)
        return nbytes, 3 * n_tiles * t
    tr = tile_rows(m)
    dev = x.device
    count = (m.tile_row_ptr[1:] - m.tile_row_ptr[:-1]).long()
    live = torch.zeros(r, dtype=torch.long, device=dev).index_add_(
        0, tr, xw_nz.long())       # tiles with a non-zero x word, by row
    allowed = unpack_bits(~mask & lane_mask(t), t)
    tile_id = torch.arange(m.n_tiles, device=dev)
    unset = torch.zeros(r, dtype=torch.long, device=dev)
    witnesses, n_words = [], 0
    for b in range(t):
        hit = torch.nonzero((m.bit_tiles[:, b] & xw) != 0).flatten()
        first = torch.full((r,), m.n_tiles, dtype=torch.long, device=dev)
        first = first.scatter_reduce(0, tr[hit], tile_id[hit], "amin")
        found = first < m.n_tiles
        witnesses.append(first[allowed[:, b] & found])
        n_words += int((allowed[:, b] & found).sum())
        unset += (allowed[:, b] & ~found).long()
    shown = unset > 0
    wit = torch.unique(torch.cat(witnesses))
    n_col = int((~shown[tr[wit]]).sum()) + int(count[shown].sum())
    n_words += int((unset * live).sum())
    nbytes = 4 * ((r + 1) + n_col + n_words + c + r + r)
    return nbytes, 2 * n_words


def bff_bytes_ops(m, nnz):
    """bmv_bff reads every tile whole (dense x): pointers, column indices,
    tiles, x3 and y once each; a ⊗ and a ⊕ per set bit."""
    r, c, t = m.n_tile_rows, m.n_tile_cols, m.tile_dim
    nbytes = 4 * ((r + 1) + m.n_tiles + m.n_tiles * t + c * t + r * t)
    return nbytes, 2 * nnz


def bound_row(nbytes, ops):
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops / LANE_OPS_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / LANE_OPS_PER_S else "operations")}


def csr_spmv(csr_t):
    """One cuSPARSE SpMV on the float CSR (``torch.mv``): the yardstick."""
    import torch
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        spm = torch.sparse_csr_tensor(
            csr_t.row_ptr, csr_t.col_idx, csr_t.values,
            size=(csr_t.n_rows, csr_t.n_cols), check_invariants=False)
    return lambda x: torch.mv(spm, x)


def bfs_timing(gt, levels, n_iterations, spmv):
    """Push, pull and count per launch on each BFS iteration's inputs."""
    import torch
    from repro_torch.core.descriptor import Descriptor
    from repro_torch.core.operands import BitVector
    from repro_torch.kernels.bmv import bmv, ref
    from repro_torch.kernels.items import items_for, lanes_for

    m = gt.b2sr
    gc = gt.with_backend("csr")
    items = items_for(gt, bmv.BBF_ITEM_WORK)
    lanes = lanes_for(gt)
    rows = {k: [] for k in ("bmv_bbb_push", "bmv_bbb_pull", "bmv_bbf")}
    csr_row_ms = []
    for it, xf in enumerate(frontiers(gt, levels, n_iterations)):
        front = xf.words
        visited = gt.pack_rows(((levels >= 0) & (levels <= it)).to(
            torch.int32))
        vis = BitVector.from_words(visited, gt.n_rows, gt.tile_dim)
        x_dense = xf.unpack(torch.float32)
        lib_ms = event_ms(lambda: spmv(x_dense))
        csr_row_ms.append(event_ms(lambda: gc.mxv(
            xf, desc=Descriptor(mask=vis, complement=True))))
        args, kw = kernel_args(m, front, visited, True)
        calls = {
            "bmv_bbb_push": (lambda: bmv.bmv_bbb_push(*args, **kw,
                                                      items=items),
                             lambda: ref.bmv_bbb_push(*args, **kw)),
            "bmv_bbb_pull": (lambda: bmv.bmv_bbb_pull(*args, **kw,
                                                      items=items,
                                                      lanes=lanes),
                             lambda: ref.bmv_bbb_pull(*args, **kw))}
        calls["bmv_bbf"] = (
            lambda: bmv.bmv_bbf(*b2sr_args(m), front, t=m.tile_dim,
                                items=items),
            lambda: ref.bmv_bbf(*b2sr_args(m), front, t=m.tile_dim))
        for k, (kern, plain) in calls.items():
            rows[k].append({"it": it, "ms": event_ms(kern),
                            "plain_ms": event_ms(plain, reps=PLAIN_REPS),
                            "library_ms": lib_ms,
                            **bound_row(*needed_bytes_ops(m, front, visited,
                                                          k))})
    return rows, statistics.fmean(csr_row_ms)


def cut_ms(m, budget, by_bits=False) -> float:
    """Wall time of cutting ``m`` into work items (median of 3): the
    one-off cost a registry row pays on its first call."""
    from repro_torch.kernels.items import work_items
    return 1e3 * statistics.median(
        sync_time(lambda: work_items(m, budget, by_bits))[1]
        for _ in range(3))


def row_items(items, r: int, lo: int):
    """The work items of tile-row ``r`` (whose tiles start at ``lo``)
    alone, as the items of the one-row matrix of its tiles."""
    import torch
    from repro_torch.kernels.items import WorkItems
    sel = torch.nonzero(items.row == r).flatten()
    i0, n = int(sel[0]), int(sel.numel())
    dev, i32 = items.row.device, torch.int32
    cut = int(n > 1)
    return WorkItems(
        row=torch.zeros(n, dtype=i32, device=dev),
        begin=items.begin[i0:i0 + n + 1] - lo,
        slot=(torch.arange(n, dtype=i32, device=dev) if cut
              else torch.full((1,), -1, dtype=i32, device=dev)),
        cut_row=torch.zeros(cut, dtype=i32, device=dev),
        cut_first=torch.zeros(cut, dtype=i32, device=dev),
        cut_count=torch.full((cut,), n, dtype=i32, device=dev),
        n_slots=n if cut else 0)


def heavy_rows(gt, x):
    """bmv_bff (sum mode), bmv_bbf, push (every x word non-zero, no
    mask: push stops each item once every lane is set) and pull (the
    same x, a mask that allows every lane: the same function) on one
    tile-row alone, its work items as the registry keeps them, for the
    row with the most tiles and the row with the most set bits: what a
    hub row costs now that its items spread over many warps."""
    import torch
    from repro_torch.kernels.bmv import bmv
    from repro_torch.kernels.items import items_for, row_lanes

    m = gt.b2sr
    t = m.tile_dim
    ptr = m.tile_row_ptr
    x3 = pad_x3(x, t, 0.0)
    xw = torch.full((m.n_tile_cols,), -1, dtype=torch.int32,
                    device=x.device)
    none_visited = torch.zeros(1, dtype=torch.int32, device=x.device)
    bff_items = items_for(gt, bmv.BFF_ITEM_WORK, by_bits=True)
    bbf_items = items_for(gt, bmv.BBF_ITEM_WORK)
    deg = gt.degrees()
    bits = torch.cat([deg, deg.new_zeros(m.n_tile_rows * t - deg.numel())])
    rows = {"most_tiles": int((ptr[1:] - ptr[:-1]).argmax()),
            "most_set_bits": int(bits.view(-1, t).sum(1).argmax())}
    out = {}
    for key, r in rows.items():
        lo, hi = int(ptr[r]), int(ptr[r + 1])
        one = (ptr.new_tensor([0, hi - lo]), m.tile_col_idx[lo:hi],
               m.bit_tiles[lo:hi])
        fi, ci = row_items(bff_items, r, lo), row_items(bbf_items, r, lo)
        lanes = row_lanes(one[0], one[2])
        out[key] = {
            "row": r, "tiles": hi - lo,
            "set_bits": int(bits[r * t:(r + 1) * t].sum()),
            "items": fi.n_items,
            "ms": event_ms(lambda: bmv.bmv_bff(*one, x3, t=t, mode="sum",
                                               items=fi)),
            "bbf_items": ci.n_items,
            "bbf_ms": event_ms(lambda: bmv.bmv_bbf(*one, xw, t=t,
                                                   items=ci)),
            "push_ms": event_ms(lambda: bmv.bmv_bbb_push(
                *one, xw, None, t=t, items=ci)),
            "pull_ms": event_ms(lambda: bmv.bmv_bbb_pull(
                *one, xw, none_visited, t=t, items=ci, lanes=lanes))}
    return out


def pad_x3(x, t, ident):
    """x padded with the identity to whole column tiles: [C, t]."""
    import torch
    n_tc = -(-x.numel() // t)
    return torch.cat([x, x.new_full((n_tc * t - x.numel(),), ident)]
                     ).view(n_tc, t)


def bff_tile_dims(coo, x, spmv_ms):
    """bmv_bff (sum mode) on the first PageRank input at t = 16 and 8 on
    the same graph (its transpose, as ``bff_timing`` reads it): time per
    launch with the items kept for it, the cut's one-off time, the B2SR's
    bytes and the bound, and the error against the plain version."""
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.kernels.bmv import bmv
    from repro_torch.kernels.items import items_for

    rows, cols = coo
    n = x.numel()
    out = {}
    for t in (16, 8):
        g = GraphMatrix.from_coo(cols, rows, n, n, t, with_transpose=False,
                                 backend="b2sr_cuda", device=DEVICE)
        m = g.b2sr
        x3 = pad_x3(x, t, 0.0)
        items = items_for(g, bmv.BFF_ITEM_WORK, by_bits=True)
        err, ratio, ok = check_bff(m, x3, "sum", 1.0, items)
        if not ok:
            fail("timing", f"bmv_bff sum at t = {t}: error {err} "
                           f"({ratio} of the bound)")
        out[t] = {"ms": event_ms(lambda: bmv.bmv_bff(
            *b2sr_args(m), x3, t=t, mode="sum", items=items)),
            "cut_ms": cut_ms(m, bmv.BFF_ITEM_WORK, by_bits=True),
            "n_tiles": m.n_tiles, "items": items.n_items,
            "b2sr_bytes": b2sr_bytes(m), "err_over_bound": ratio,
            "library_ms": spmv_ms, **bound_row(*bff_bytes_ops(m, g.nnz))}
        del g, m, items
    return out


def bff_timing(g, sources, spmv, coo):
    """bmv_bff per launch on each iteration's input of one PageRank
    (sum), one SSSP (min_plus) and one CC (min_plus, a_value 0), with the
    work items the registry keeps; the plain version on the first input of
    each; the cut's one-off time; the hub rows alone; sum mode at t = 16
    and 8."""
    import torch
    from repro_torch.algorithms import connected_components, pagerank, sssp
    from repro_torch.kernels.bmv import bmv, ref
    from repro_torch.kernels.items import items_for, row_lanes

    gt = g.transposed()
    m = gt.b2sr
    t = m.tile_dim
    items = items_for(gt, bmv.BFF_ITEM_WORK, by_bits=True)
    safe_deg = torch.where(g.degrees() == 0, 1.0, g.degrees())
    pr_n = pagerank(g).n_iterations
    sssp_n = sssp(g, sources[0]).n_iterations
    cc_n = connected_components(g, direction="push").n_iterations
    inputs = {
        "pagerank": ("sum", 1.0, [pagerank(g, max_iters=k).ranks / safe_deg
                                  for k in range(pr_n)]),
        "sssp": ("min_plus", 1.0, [sssp(g, sources[0],
                                        max_iters=k).distances
                                   for k in range(sssp_n)]),
        "cc": ("min_plus", 0.0, [connected_components(
            g, max_iters=k, direction="push").labels.float()
            for k in range(cc_n)]),
    }
    bound = bound_row(*bff_bytes_ops(m, g.nnz))
    first_pr = inputs["pagerank"][2][0]
    out = {"heavy_rows": heavy_rows(gt, first_pr),
           "items": items.n_items, "cut_rows": int(items.cut_row.numel()),
           "cut_ms": {"bmv_bff": cut_ms(m, bmv.BFF_ITEM_WORK, by_bits=True),
                      "bmv_bbf": cut_ms(m, bmv.BBF_ITEM_WORK),
                      "row_lanes": 1e3 * statistics.median(
                          sync_time(lambda: row_lanes(m.tile_row_ptr,
                                                      m.bit_tiles))[1]
                          for _ in range(3))}}
    for name, (mode, a_value, xs) in inputs.items():
        ident = float("inf") if mode == "min_plus" else 0.0
        x3s = [pad_x3(x, t, ident) for x in xs]
        args = (*b2sr_args(m),)
        ms = [event_ms(lambda x3=x3: bmv.bmv_bff(*args, x3, t=t, mode=mode,
                                                 a_value=a_value,
                                                 items=items))
              for x3 in x3s]
        out[name] = {
            "mode": mode, "a_value": a_value, "ms": ms,
            "median_ms": statistics.median(ms),
            "plain_ms": event_ms(lambda: ref.bmv_bff(
                *args, x3s[0], t=t, mode=mode, a_value=a_value),
                reps=PLAIN_REPS),
            "library_ms": (statistics.median(event_ms(lambda x=x: spmv(x))
                                             for x in xs)
                           if mode == "sum" else None),
            **bound}
    out["tile_dims"] = bff_tile_dims(coo, first_pr,
                                     out["pagerank"]["library_ms"])
    return out


def phase_timing(g, bfs_first, sources, launches, coo):
    """Per-launch times on the main path's inputs; the kernel table."""
    from repro_torch.core.words import lane_mask
    from repro_torch.kernels.items import lanes_for
    gt = g.transposed()
    m = gt.b2sr
    spmv = csr_spmv(gt.csr)
    bfs_rows, csr_ms = bfs_timing(gt, bfs_first.levels,
                                  bfs_first.n_iterations, spmv)
    bff = bff_timing(g, sources, spmv, coo)
    b2sr_bytes = 4 * (m.tile_row_ptr.numel() + m.n_tiles
                      + m.n_tiles * m.tile_dim)
    csr_bytes = 4 * (gt.csr.row_ptr.numel() + 2 * g.nnz)
    full = lane_mask(m.tile_dim)
    emit({"phase": "timing", "ok": True, "per_iteration": bfs_rows,
          "bmv_bff": bff, "csr_row_ms": csr_ms,
          "graph": {"n": g.n_rows, "nnz": g.nnz, "n_tiles": m.n_tiles,
                    "n_tile_rows": m.n_tile_rows,
                    # tile-rows of Aᵀ with a lane no tile can set (pull's
                    # row_lanes; a vertex without edges)
                    "tile_rows_with_an_empty_lane": int(
                        ((lanes_for(gt) & full) != full).sum()),
                    "b2sr_bytes": b2sr_bytes, "csr_bytes": csr_bytes}})

    def mean(rows, key):
        return statistics.fmean(r[key] for r in rows)

    table = []
    for k in ("bmv_bbb_push", "bmv_bbb_pull", "bmv_bbf"):
        rows = bfs_rows[k]
        b_bytes = mean(rows, "bytes") / HBM_BYTES_PER_S
        b_ops = mean(rows, "ops") / LANE_OPS_PER_S
        table.append({
            "name": k, "ms": mean(rows, "ms"),
            "plain_ms": mean(rows, "plain_ms"),
            "bound_ms": mean(rows, "bound_ms"),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": mean(rows, "library_ms"),
            "inputs": "BFS push traversal, mean over iterations"})
    pr = bff["pagerank"]
    table.append({
        "name": "bmv_bff", "ms": pr["median_ms"], "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"], "bound_by": pr["bound_by"],
        "library_ms": pr["library_ms"],
        "ms_by_input": {k: bff[k]["median_ms"]
                        for k in ("pagerank", "sssp", "cc")},
        "inputs": "PageRank iterations (sum mode), median"})
    for row in table:
        row["launches"] = launches[row["name"]]
    return table, csr_ms


def engine_sources(deg, bfs_sources):
    """The engine phases' sources: the bfs phase's 4 as columns 0-3, then
    distinct vertices with an edge, drawn with a seed."""
    rng = np.random.default_rng(SEED + 2)
    cand = np.setdiff1d(np.flatnonzero(deg), bfs_sources)
    more = rng.choice(cand, MS_SOURCES - len(bfs_sources), replace=False)
    return [*bfs_sources, *(int(v) for v in more)]


def phase_msbfs(g, srcs, want):
    """msbfs push/pull/auto on b2sr_cuda (spmm_bbb) and csr: levels,
    iterations and direction traces equal; columns 0-3 equal SciPy's
    levels; 8 columns equal single-source bfs on b2sr_cuda. Queries per
    second of the batch beside single-source BFS."""
    import torch
    from repro_torch.algorithms import bfs
    from repro_torch.engine import DEFAULT_PLANNER, msbfs

    fp, fp_s = sync_time(g.fingerprint)       # the plan key's first read
    gc = g.with_backend("csr")
    reset_launches(("spmm_bbb",))
    runs, wall = {}, {}
    for d in DIRECTIONS:
        runs["b2sr_cuda", d], wall["b2sr_cuda", d] = sync_time(
            lambda: msbfs(g, srcs, direction=d))
    launches = read_launches("msbfs", ("spmm_bbb",))
    for d in DIRECTIONS:
        runs["csr", d], wall["csr", d] = sync_time(
            lambda: msbfs(gc, srcs, direction=d))
    problems = []
    for d in DIRECTIONS:
        a, b = runs["b2sr_cuda", d], runs["csr", d]
        if not torch.equal(a.levels, b.levels):
            problems.append(f"levels != csr ({d})")
        if (a.n_iterations, a.directions) != (b.n_iterations, b.directions):
            problems.append(f"schedule != csr ({d})")
        if not np.array_equal(a.levels[:, :len(want)].T.cpu().numpy(),
                              want):
            problems.append(f"columns 0-3 != scipy ({d})")
    auto = runs["b2sr_cuda", "auto"]
    cols = list(range(0, MS_SOURCES, MS_SOURCES // 8))
    single_s = []
    for i in cols:
        one, sec = sync_time(lambda: bfs(g, srcs[i]))
        single_s.append(sec)
        if not torch.equal(auto.levels[:, i], one.levels):
            problems.append(f"column {i} != bfs({srcs[i]})")
    single = statistics.median(single_s)
    batch = wall["b2sr_cuda", "auto"]
    emit({"phase": "msbfs", "ok": not problems, "problems": problems[:10],
          "n_sources": len(srcs), "launches": launches,
          "n_iterations": {d: runs["b2sr_cuda", d].n_iterations
                           for d in DIRECTIONS},
          "auto_directions": list(auto.directions),
          "wall_s": {f"{be}/{d}": wall[be, d]
                     for be in ("b2sr_cuda", "csr") for d in DIRECTIONS},
          "single_bfs_median_s": single,
          "batch_wall_s": batch,
          "single_source_batch_s": len(srcs) * single,
          "qps": {"batched": len(srcs) / batch, "single_source": 1 / single},
          "fingerprint_first_s": fp_s, "fingerprint": fp,
          "plan_cache": DEFAULT_PLANNER.stats()})
    if problems:
        fail("msbfs", "; ".join(problems[:5]))
    return auto, launches


def phase_mskhop(g, srcs):
    """mskhop (k = 2) on b2sr_cuda and csr, equal; 4 columns equal
    single-source khop_frontier."""
    import torch
    from repro_torch.algorithms import khop_frontier
    from repro_torch.engine import mskhop

    res, wall, launches = run_both(
        "mskhop", g, ("spmm_bbb",),
        {"mskhop": lambda gg: mskhop(gg, srcs, MSKHOP_K)})
    a = res["b2sr_cuda", "mskhop"]
    problems = [] if torch.equal(a, res["csr", "mskhop"]) else ["!= csr"]
    for i in range(4):
        if not torch.equal(a[:, i], khop_frontier(g, srcs[i], MSKHOP_K)):
            problems.append(f"column {i} != khop_frontier")
    emit({"phase": "mskhop", "ok": not problems, "problems": problems,
          "k": MSKHOP_K, "launches": launches,
          "reached": [int(a[:, i].sum()) for i in range(4)],
          "wall_s": {be: wall[be, "mskhop"] for be in ("b2sr_cuda", "csr")}})
    if problems:
        fail("mskhop", "; ".join(problems))
    return launches


def phase_ms_sssp(g, srcs):
    """ms_sssp with edge weights 1.0 and 0.5 on b2sr_cuda and csr, equal;
    4 columns equal single-source sssp."""
    import torch
    from repro_torch.algorithms import sssp
    from repro_torch.engine import ms_sssp

    weights = (1.0, 0.5)
    res, wall, launches = run_both(
        "ms_sssp", g, ("spmm_bbb",),
        {w: (lambda gg, w=w: ms_sssp(gg, srcs, edge_weight=w))
         for w in weights})
    problems = []
    for w in weights:
        a, b = res["b2sr_cuda", w], res["csr", w]
        if not torch.equal(a.distances, b.distances) or \
                a.n_iterations != b.n_iterations:
            problems.append(f"!= csr (weight {w})")
        for i in range(4):
            one = sssp(g, srcs[i], edge_weight=w)
            if not torch.equal(a.distances[:, i], one.distances):
                problems.append(f"column {i} != sssp (weight {w})")
    emit({"phase": "ms_sssp", "ok": not problems, "problems": problems,
          "launches": launches,
          "n_iterations": res["b2sr_cuda", 1.0].n_iterations,
          "wall_s": {f"{be}/{w}": wall[be, w] for be in ("b2sr_cuda", "csr")
                     for w in weights}})
    if problems:
        fail("ms_sssp", "; ".join(problems))
    return launches


def phase_batched_ppr(g, adj, seeds):
    """batched_ppr (10 iterations, eps 0) on b2sr_cuda (spmm_dense) and
    csr: within RANK_RTOL of each other, of single-seed ppr and, for 4
    columns, of a float64 numpy power iteration."""
    from repro_torch.algorithms import ppr
    from repro_torch.engine import batched_ppr

    res, wall, launches = run_both(
        "batched_ppr", g, ("spmm_dense",),
        {"ppr": lambda gg: batched_ppr(gg, seeds, max_iters=10, eps=0.0)})
    a, b = res["b2sr_cuda", "ppr"], res["csr", "ppr"]
    got = a.ranks.cpu().numpy().astype(np.float64)
    problems, rel = [], {}

    def close(label, x, y):
        nz = y != 0
        rel[label] = float(np.max(np.abs(x - y)[nz] / np.abs(y[nz])))
        if not np.allclose(x, y, rtol=RANK_RTOL, atol=0):
            problems.append(label)

    close("csr", got, b.ranks.cpu().numpy().astype(np.float64))
    for i in range(4):
        one = ppr(g, seeds[i], max_iters=10, eps=0.0).ranks
        close(f"ppr/{i}", got[:, i], one.cpu().numpy().astype(np.float64))
        restart = np.zeros(g.n_rows)
        restart[seeds[i]] = 1.0
        close(f"numpy/{i}", got[:, i],
              numpy_ranks(adj, a.n_iterations, restart=restart))
    if a.n_iterations != b.n_iterations:
        problems.append("n_iterations != csr")
    emit({"phase": "batched_ppr", "ok": not problems, "problems": problems,
          "n_seeds": len(seeds), "n_iterations": a.n_iterations,
          "launches": launches, "max_rel_err": rel,
          "wall_s": {be: wall[be, "ppr"] for be in ("b2sr_cuda", "csr")}})
    if problems:
        fail("batched_ppr", "; ".join(problems))
    return a, launches


def phase_batcher(g, srcs, levels, ranks):
    """One flush of BFS and PPR queries with duplicates through the
    QueryBatcher: every handle equals its msbfs / batched_ppr column, and
    the dedup count is right."""
    import torch
    from repro_torch.engine import QueryBatcher

    rng = np.random.default_rng(SEED + 3)
    n_bfs, n_ppr = BATCH_QUERIES
    bfs_q = [int(v) for v in rng.choice(srcs, n_bfs)]
    ppr_q = [int(v) for v in rng.choice(srcs[:PPR_SEEDS], n_ppr)]
    b = QueryBatcher()
    reset_launches(("spmm_bbb", "spmm_dense"))

    def serve():
        hb = [b.bfs(g, s) for s in bfs_q]
        hp = [b.ppr(g, s, max_iters=10, eps=0.0) for s in ppr_q]
        b.flush()
        return hb, hp

    (hb, hp), wall = sync_time(serve)
    launches = read_launches("batcher", ("spmm_bbb", "spmm_dense"))
    problems = []
    for s, h in zip(bfs_q, hb):
        if not torch.equal(h.result(), levels[:, srcs.index(s)]):
            problems.append(f"bfs {s} != msbfs column")
    worst = 0.0
    for s, h in zip(ppr_q, hp):
        want = ranks[:, srcs.index(s)]
        worst = max(worst, float(((h.result() - want).abs()
                                  / want.abs().clamp_min(1e-30)).max()))
        if not torch.allclose(h.result(), want, rtol=1e-6, atol=0):
            problems.append(f"ppr {s} != batched_ppr column")
    dedup = (n_bfs - len(set(bfs_q))) + (n_ppr - len(set(ppr_q)))
    if b.n_deduped != dedup:
        problems.append(f"deduped {b.n_deduped} != {dedup}")
    emit({"phase": "batcher", "ok": not problems, "problems": problems[:10],
          "queries": n_bfs + n_ppr, "groups": b.n_launches,
          "deduped": b.n_deduped, "launches": launches, "wall_s": wall,
          "qps": (n_bfs + n_ppr) / wall, "ppr_max_rel_diff": worst})
    if problems:
        fail("batcher", "; ".join(problems[:5]))
    return launches


def bbb_bytes_ops(m, f, mask):
    """Bytes and operations spmm_bbb needs on these inputs: row pointers,
    every column index, the words of each tile whose column holds a
    frontier bit and whose tile-row an allowed bit, F, the mask and the
    output once; one OR per (set bit of those tiles, source word)."""
    import torch
    from repro_torch.core.b2sr import tile_rows
    from repro_torch.core.words import popcount
    t, w = m.tile_dim, f.shape[2]
    col_live = (f != 0).flatten(1).any(1)
    row_live = (~mask != 0).flatten(1).any(1)
    read = col_live[m.tile_col_idx.long()] & row_live[tile_rows(m)]
    n_read = int(read.sum())
    set_bits = int(popcount(m.bit_tiles[read]).sum(dtype=torch.int64))
    nbytes = 4 * ((m.n_tile_rows + 1) + m.n_tiles + n_read * t + f.numel()
                  + 2 * mask.numel())
    return nbytes, set_bits * w


def dense_by_vec(m, x, items, reps: int):
    """spmm_dense on ``x`` with each V of the kernel (columns a lane takes
    per pass): time per launch beside the registers and spill stores and
    loads ``ptxas`` gave that instance at this tile dim, and whether its
    output is the chosen V's, bit for bit."""
    import re
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.spmm import spmm
    res = {}
    for name, r in common.kernel_resources("spmm").items():
        hit = re.search(r"spmm_dense_kernelILi(\d+)ELi(\d+)E", name)
        if hit and int(hit[1]) == m.tile_dim:
            res[int(hit[2])] = r
    chosen = spmm.dense_vec(x.shape[1])
    want = spmm._spmm_dense(m, x, items, chosen).view(torch.int32)
    by_vec = {}
    for v in spmm.DENSE_VECS:
        same = torch.equal(spmm._spmm_dense(m, x, items, v).view(
            torch.int32), want)
        by_vec[v] = {"ms": event_ms(lambda v=v: spmm._spmm_dense(
            m, x, items, v), reps=reps), "same_bits": same,
            **res.get(v, {})}
    return {"chosen": chosen, "by_vec": by_vec}


def dense_bytes_ops(m, d, nnz):
    """spmm_dense reads every tile (X is dense): pointers, column indices,
    tiles, X and Y once each; one add per (set bit, column)."""
    t = m.tile_dim
    nbytes = 4 * ((m.n_tile_rows + 1) + m.n_tiles * (1 + t)
                  + (m.n_cols + m.n_rows) * d)
    return nbytes, nnz * d


def spmm_timing(g, levels, n_iterations, seeds):
    """spmm_bbb per launch on each iteration's inputs of the msbfs (auto)
    run, spmm_dense on each PPR iteration's input, beside their plain
    versions, the csr rows and one cuSPARSE SpMM (``torch.sparse.mm`` of
    the float CSR by an [n, S] float matrix), the yardstick."""
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.core.b2sr import pack_frontier_matrix
    from repro_torch.core.descriptor import Descriptor
    from repro_torch.core.operands import FrontierBatch
    from repro_torch.engine import batched_ppr
    from repro_torch.kernels.spmm import ref, spmm

    gt = g.transposed()
    gct = gt.with_backend("csr")
    m, t, n = gt.b2sr, gt.tile_dim, gt.n_rows
    spm = csr_mod.to_sparse(gt.csr)
    items = spmm.work_items(m, spmm.BBB_ITEM_WORK)
    bbb = []
    for it in range(n_iterations):
        f = pack_frontier_matrix(levels == it, t, n)
        vis = pack_frontier_matrix((levels >= 0) & (levels <= it), t, n)
        fb = FrontierBatch.from_words(f, n, levels.shape[1], t)
        mb = FrontierBatch.from_words(vis, n, levels.shape[1], t)
        dense_f = (levels == it).float()
        bbb.append({
            "it": it,
            "ms": event_ms(lambda: spmm.spmm_bbb(m, f, vis, items=items),
                           reps=5),
            "plain_ms": event_ms(lambda: ref.spmm_bbb(m, f, vis), reps=1),
            "csr_row_ms": event_ms(lambda: gct.mxm(fb, desc=Descriptor(
                mask=mb, complement=True)), reps=3),
            "library_ms": event_ms(lambda: torch.sparse.mm(spm, dense_f),
                                   reps=3),
            **bound_row(*bbb_bytes_ops(m, f, vis))})
    safe_deg = torch.where(g.degrees() == 0, 1.0, g.degrees())[:, None]
    dense_items = spmm.work_items(m, spmm.DENSE_ITEM_WORK, by_bits=True)
    dense = []
    for k in range(10):
        x = (batched_ppr(g, seeds, max_iters=k, eps=0.0).ranks
             / safe_deg).contiguous()
        dense.append({
            "it": k, "d": x.shape[1],
            "ms": event_ms(lambda: spmm.spmm_dense(m, x, items=dense_items),
                           reps=5),
            "plain_ms": (event_ms(lambda: ref.spmm_dense(m, x), reps=1)
                         if k in (0, 9) else None),
            "csr_row_ms": event_ms(lambda: gct.mxm(x), reps=3),
            "library_ms": event_ms(lambda: torch.sparse.mm(spm, x), reps=3),
            **bound_row(*dense_bytes_ops(m, x.shape[1], g.nnz))})
    vecs = dense_by_vec(m, x, dense_items, reps=5)   # the last iteration's
    if not all(r["same_bits"] for r in vecs["by_vec"].values()):
        fail("spmm_timing", f"spmm_dense's V instances differ at D = "
                            f"{x.shape[1]}: {vecs['by_vec']}")
    x64 = torch.rand((n, 64), generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    wide = {"ms": event_ms(lambda: spmm.spmm_dense(m, x64,
                                                   items=dense_items)),
            "library_ms": event_ms(lambda: torch.sparse.mm(spm, x64)),
            **bound_row(*dense_bytes_ops(m, 64, g.nnz))}
    emit({"phase": "spmm_timing", "ok": True, "spmm_bbb": bbb,
          "spmm_dense": dense, "spmm_dense_d64": wide,
          "spmm_dense_vec": vecs,
          "items": {"spmm_bbb": items.n_items,
                    "spmm_dense": dense_items.n_items,
                    "spmm_dense_cut_rows": int(dense_items.cut_row.numel())}})

    def mean(rows, key):
        vals = [r[key] for r in rows if r[key] is not None]
        return statistics.fmean(vals)

    table = []
    for name, rows, inputs in (
            ("spmm_bbb", bbb, f"msbfs (auto) of {levels.shape[1]} sources, "
                              f"mean over its iterations; library: "
                              f"cuSPARSE SpMM of the unpacked frontiers"),
            ("spmm_dense", dense, f"batched PPR of {len(seeds)} seeds, mean "
                                  f"over 10 iterations; library: cuSPARSE "
                                  f"SpMM")):
        b_bytes = mean(rows, "bytes") / HBM_BYTES_PER_S
        b_ops = mean(rows, "ops") / LANE_OPS_PER_S
        table.append({"name": name, "ms": mean(rows, "ms"),
                      "plain_ms": mean(rows, "plain_ms"),
                      "bound_ms": mean(rows, "bound_ms"),
                      "bound_by": "bytes" if b_bytes >= b_ops
                      else "operations",
                      "library_ms": mean(rows, "library_ms"),
                      "csr_row_ms": mean(rows, "csr_row_ms"),
                      "inputs": inputs})
    return table


def phase_bitpack(g):
    """The packing entry points (``kernels.bitpack.ops``) at full size:
    ``bit_transpose`` of the graph's tiles, which must be the tiles of the
    stored transpose (built from the swapped COO), and ``pack_dense`` of
    a [PACK_SIDE, PACK_SIDE] uint8 0/1 matrix, against its plain version;
    then each kernel's time beside its plain version and its bound."""
    import torch
    from repro_torch.core.b2sr import tile_rows
    from repro_torch.kernels.bitpack import bitpack, ops, ref

    m, mt = g.b2sr, g.transposed().b2sr
    t = m.tile_dim
    x = torch.randint(0, 2, (PACK_SIDE, PACK_SIDE), dtype=torch.uint8,
                      generator=torch.Generator(device=DEVICE).manual_seed(
                          SEED + 6), device=DEVICE)
    names = ("pack_dense", "bit_transpose")
    reset_launches(names)
    (tt, packed), wall = sync_time(lambda: (ops.bit_transpose(m.bit_tiles, t),
                                            ops.pack_dense(x, t)))
    launches = read_launches("bitpack", names)
    problems = []
    # tile k of A at (r, c) is tile (c, r) of Aᵀ, its bits transposed
    order = torch.argsort(m.tile_col_idx.long() * m.n_tile_rows
                          + tile_rows(m))
    if not torch.equal(tt[order], mt.bit_tiles):
        problems.append("bit_transpose != the stored transpose's tiles")
    del tt, order
    if not torch.equal(packed, ref.pack_dense(x, t)):
        problems.append("pack_dense != plain")
    del packed
    if not torch.equal(bitpack.pack_dense(x, t, True),
                       ref.pack_dense(x, t, True)):
        problems.append("pack_dense column-major != plain")
    torch.cuda.empty_cache()
    r_c = -(-PACK_SIDE // t)
    out_bytes = 4 * r_c * r_c * t
    # float32 entries at the same shape, -0.0 among the zeros
    xf = x.float()
    xf[(x == 0) & (torch.rand(x.shape, device=DEVICE) < 0.5)] = -0.0
    if not torch.equal(bitpack.pack_dense(xf, t), ref.pack_dense(xf, t)):
        problems.append("pack_dense float32 != plain")
    torch.cuda.empty_cache()
    f32 = {"float32_ms": event_ms(lambda: bitpack.pack_dense(xf, t)),
           **{f"float32_{k}": v for k, v in bound_row(
               xf.numel() * 4 + out_bytes, 2 * xf.numel()).items()}}
    del xf
    torch.cuda.empty_cache()
    nbytes_t = 2 * 4 * m.bit_tiles.numel()
    rows = [
        {"name": "bit_transpose",
         "ms": event_ms(lambda: bitpack.bit_transpose(m.bit_tiles, t)),
         "plain_ms": event_ms(lambda: plain_bit_transpose(m.bit_tiles, t),
                              reps=1),
         # log2(t) steps of a shuffle and about 5 word operations per word
         **bound_row(nbytes_t, 6 * 5 * m.bit_tiles.numel()),
         "library_ms": None, "csr_row_ms": None,
         "inputs": f"the {m.n_tiles} tiles of the graph (n = {g.n_rows}); "
                   f"no PyTorch call transposes bits, no csr row"},
        {"name": "pack_dense",
         "ms": event_ms(lambda: bitpack.pack_dense(x, t)),
         "plain_ms": event_ms(lambda: ref.pack_dense(x, t), reps=1),
         # a compare and an OR per entry
         **bound_row(x.numel() + out_bytes, 2 * x.numel()),
         "library_ms": None, "csr_row_ms": None,
         "col_major_ms": event_ms(lambda: bitpack.pack_dense(x, t, True)),
         **f32,
         "inputs": f"[{PACK_SIDE}, {PACK_SIDE}] uint8 0/1, row-major "
                   f"(col_major_ms: column-major; float32_*: the same "
                   f"entries as float32); no PyTorch call packs bits, no "
                   f"csr row"},
    ]
    for row in rows:
        row["launches"] = launches[row["name"]]
    emit({"phase": "bitpack", "ok": not problems, "problems": problems,
          "launches": launches, "wall_s": wall, "timing": rows})
    if problems:
        fail("bitpack", "; ".join(problems))
    del x
    torch.cuda.empty_cache()
    return rows


def gcn_cora_model(n: int):
    """gcn-cora's widths at n nodes, made on the card from SEED: bag-of-
    words features (each of the d_in words present with probability
    BOW_WORDS / d_in, as Cora's papers hold about 18 of 1,433 words, each
    row then divided by its sum, Kipf and Welling's preprocessing) and
    Glorot-scaled random weights and biases."""
    import torch
    from repro_torch.configs import gcn_cora

    cfg = gcn_cora.CONFIG
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.rand((n, cfg.d_in), generator=gen, device=DEVICE)
    x.lt_(BOW_WORDS / cfg.d_in)           # 0/1 in place: one [n, d_in] copy
    x.div_(x.sum(1, keepdim=True).clamp_min(1.0))
    dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [cfg.n_classes])
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=DEVICE)
        params.append((w * (2.0 / (a + b)) ** 0.5,
                       0.1 * torch.randn(b, generator=gen, device=DEVICE)))
    return cfg, x, params


def layer2_float64(adj, deg, h1, params, nodes, bit: bool):
    """The second layer's logits of ``nodes`` in float64 (SciPy) from the
    port's own first-layer activations ``h1`` ([n, d] numpy): the bit
    path's α·(2·A·(h1 > 0) − rowsum) + h1, or A·h1 + h1; then @ W + b.
    Returns (logits [len(nodes), classes], the scale |agg|·|W| + |b|)."""
    w, b = (p.double().cpu().numpy() for p in params[1])
    sub = adj[nodes]
    if bit:
        alpha = np.abs(h1).mean(0)
        agg = alpha * (2.0 * (sub @ (h1 > 0).astype(np.float64))
                       - deg[nodes][:, None]) + h1[nodes]
    else:
        agg = sub @ h1 + h1[nodes]
    return agg @ w + b, np.abs(agg) @ np.abs(w) + np.abs(b)


def bbf_bytes_ops(m, xw):
    """spmm_bbf reads every tile (XW is dense): pointers, column indices,
    tiles, XW and Y once each; an AND, a popcount and an add per
    (non-zero tile word, column)."""
    t, d = m.tile_dim, xw.shape[1]
    nz_words = int((m.bit_tiles != 0).sum())
    nbytes = 4 * ((m.n_tile_rows + 1) + m.n_tiles * (1 + t) + xw.numel()
                  + m.n_rows * d)
    return nbytes, 3 * nz_words * d


def phase_gnn(g, adj, deg, srcs):
    """BitGNN inference at gcn-cora's widths on the full graph.

    ``gnn_infer`` of the 64 engine sources with ``binarize`` True (the
    hidden layer's aggregation on the bit path: ``pack_rows``,
    ``spmm_bbf``) and False, on ``b2sr_cuda`` and ``csr``; the input
    layer aggregates the float features with ``spmm_dense`` at D = 1433.
    Checks (tolerances relative to |agg|·|W| + |b|, elementwise):
      - each backend's logits against a float64 SciPy evaluation of the
        second layer from that backend's own first-layer activations:
        within BIT_TOL on the bit path (the counts are exact; only α,
        the epilogue and the 16-term product round in float32) and
        FLOAT_TOL on the float path (float32 sums over up to ~40,000
        neighbours, in another order than float64);
      - binarize=False logits of b2sr_cuda against csr within FLOAT_TOL
        (the first layers round differently, so h > 0 may flip a few
        bits between backends: the bit path is held per backend);
      - on b2sr_cuda's activations, the ``BitMatrix`` words equal the
        plain packing, and the counts of ``spmm_bbf``, the csr row and
        the plain version are equal bit for bit;
      - one ``QueryBatcher.flush`` of GNN_QUERIES queries per model (with
        duplicates): every handle equals its ``gnn_infer`` column;
      - ``spmm_dense`` of the features (D = 1433) against its plain
        version on their first and last 64 columns, within
        SUM_TOL · (A·|X|), and every V's output equal to the chosen V's
        bit for bit.
    Returns the kernel table rows of spmm_bbf and pack_rows, the
    b2sr_cuda launches, and the runs for the profile phase.
    """
    import torch
    from repro_torch.core import csr as csr_mod
    from repro_torch.engine import (PlanCache, QueryBatcher, gnn_infer,
                                    register_gnn_model)
    from repro_torch.gnn_bit import binarize
    from repro_torch.kernels.bitpack import bitpack, ref as bref
    from repro_torch.kernels.spmm import ref, spmm

    n, t = g.n_rows, g.tile_dim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (cfg, x, params), make_s = sync_time(lambda: gcn_cora_model(n))
    models = {"bit": True, "float": False}
    for k, bz in models.items():
        register_gnn_model(f"gcn-cora/{k}", params, x, binarize=bz,
                           device=DEVICE)
    register_gnn_model("gcn-cora/layer0", params[:1], x, binarize=False,
                       device=DEVICE)
    planner = PlanCache()
    names = ("spmm_dense", "spmm_bbf", "pack_rows")
    nodes = np.asarray(srcs)
    logits, h1, wall, peak, err = {}, {}, {}, {}, {}
    launches = None
    problems = []
    for be in ("b2sr_cuda", "csr"):
        gg = g.with_backend(be)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if be == "b2sr_cuda":
            reset_launches(names)
        for k in models:
            for run in ("first", "second"):
                logits[be, k], wall[f"{be}/{k}/{run}"] = sync_time(
                    lambda: gnn_infer(gg, nodes, f"gcn-cora/{k}",
                                      planner=planner).logits)
        if be == "b2sr_cuda":
            launches = read_launches("gnn", names)
        peak[be] = torch.cuda.max_memory_allocated()
        layer0 = gnn_infer(gg, np.arange(n), "gcn-cora/layer0",
                           planner=planner).logits
        h1[be] = torch.relu(layer0.T).contiguous()
        del layer0
        h_np = h1[be].double().cpu().numpy()
        for k, bz in models.items():
            want, scale = layer2_float64(adj, deg, h_np, params, nodes, bz)
            got = logits[be, k].T.double().cpu().numpy()
            err[f"{be}/{k}"] = float(np.max(np.abs(got - want) / scale))
            if err[f"{be}/{k}"] > (BIT_TOL if bz else FLOAT_TOL):
                problems.append(f"{be}/{k} logits != float64 layer 2")
            if not np.isfinite(got).all() or got.shape != (len(nodes),
                                                           cfg.n_classes):
                problems.append(f"{be}/{k} logits not finite [64, 7]")
        del h_np
    want, scale = layer2_float64(adj, deg, h1["b2sr_cuda"].double().cpu()
                                 .numpy(), params, nodes, False)
    diff = (logits["b2sr_cuda", "float"] - logits["csr", "float"]).T
    cross = float(np.max(np.abs(diff.double().cpu().numpy()) / scale))
    if cross > FLOAT_TOL:
        problems.append("binarize=False: b2sr_cuda != csr")
    flips = int(((h1["b2sr_cuda"] > 0) != (h1["csr"] > 0)).sum())
    del h1["csr"]
    torch.cuda.empty_cache()

    # the bit layer's operands, from b2sr_cuda's activations
    hb = h1["b2sr_cuda"] > 0
    bm = binarize.pack_activations(h1["b2sr_cuda"], t)
    if not torch.equal(bm.words, bref.pack_rows(hb, t)):
        problems.append("pack_activations != plain packing")
    counts = g.mxm(bm, out_dtype=torch.int32)
    if not torch.equal(counts, g.with_backend("csr").mxm(
            bm, out_dtype=torch.int32)):
        problems.append("spmm_bbf counts != csr")
    if not torch.equal(counts, ref.spmm_bbf(g.b2sr, bm.words, torch.int32)):
        problems.append("spmm_bbf counts != plain")

    # the batcher: two groups (one per model), duplicates in
    rng = np.random.default_rng(SEED + 4)
    queries = [(k, int(v)) for k in models
               for v in rng.choice(nodes, GNN_QUERIES)]
    b = QueryBatcher(planner=planner)
    reset_launches(names)

    def serve():
        hs = [b.gnn_infer(g, v, f"gcn-cora/{k}") for k, v in queries]
        b.flush()
        return hs

    handles, flush_s = sync_time(serve)
    batch_launches = read_launches("gnn", names)
    col = {int(v): i for i, v in enumerate(nodes)}
    worst = 0.0
    for (k, v), h in zip(queries, handles):
        want_col = logits["b2sr_cuda", k][:, col[v]]
        worst = max(worst, float((h.result() - want_col).abs().max()))
        if not torch.allclose(h.result(), want_col, rtol=1e-6, atol=0):
            problems.append(f"batcher {k}/{v} != gnn_infer column")
    dedup = sum(GNN_QUERIES - len({v for kk, v in queries if kk == k})
                for k in models)
    if b.n_deduped != dedup:
        problems.append(f"deduped {b.n_deduped} != {dedup}")

    # kernel timing on the main path's inputs
    m = g.b2sr
    gc = g.with_backend("csr")
    spm = csr_mod.to_sparse(g.csr)
    x01 = bm.unpack(torch.float32)
    bbf_items = spmm.work_items(m, spmm.BBF_ITEM_WORK)
    bbf = {"name": "spmm_bbf",
           "ms": event_ms(lambda: spmm.spmm_bbf(m, bm.words,
                                                items=bbf_items)),
           "plain_ms": event_ms(lambda: ref.spmm_bbf(m, bm.words), reps=1),
           "csr_row_ms": event_ms(lambda: gc.mxm(bm), reps=3),
           "library_ms": event_ms(lambda: torch.sparse.mm(spm, x01), reps=3),
           **bound_row(*bbf_bytes_ops(m, bm.words)),
           "inputs": f"the hidden layer of gnn_infer (binarize=True), "
                     f"D = {cfg.d_hidden}; library: cuSPARSE SpMM of the "
                     f"unpacked 0/1 [n, {cfg.d_hidden}]"}
    pack = {"name": "pack_rows",
            "ms": event_ms(lambda: bitpack.pack_rows(hb, t)),
            "plain_ms": event_ms(lambda: bref.pack_rows(hb, t), reps=3),
            "device_ms": device_ms(lambda: bitpack.pack_rows(hb, t),
                                   "pack_rows_kernel"),
            # a compare and an OR per entry
            **bound_row(hb.numel() + 4 * bm.words.numel(), 2 * hb.numel()),
            "library_ms": None, "csr_row_ms": None,
            "inputs": f"h > 0 of the hidden layer, bool [n, "
                      f"{cfg.d_hidden}]; no PyTorch call packs bits, no "
                      f"csr row"}
    # the same shape as float32 entries: h itself (h != 0 is h > 0)
    h32 = h1["b2sr_cuda"]
    if not torch.equal(bitpack.pack_rows(h32, t), bm.words):
        problems.append("pack_rows of float32 h != of h > 0")
    pack["float32"] = {
        "device_ms": device_ms(lambda: bitpack.pack_rows(h32, t),
                               "pack_rows_kernel"),
        **bound_row(4 * h32.numel() + 4 * bm.words.numel(), 2 * h32.numel())}
    # the wrapper's floor: a launch with next to no work
    tiny = torch.ones((32, 1), dtype=torch.bool, device=DEVICE)
    pack["floor_ms"] = event_ms(lambda: bitpack.pack_rows(tiny, t))
    pack["floor_device_ms"] = device_ms(lambda: bitpack.pack_rows(tiny, t),
                                        "pack_rows_kernel")
    del x01, counts, hb
    dense_items = spmm.work_items(m, spmm.DENSE_ITEM_WORK, by_bits=True)
    torch.cuda.empty_cache()
    # the input layer's product at full size (row · D offsets past 2^31)
    # against the plain version on its first and last 64 columns
    y = spmm.spmm_dense(m, x, items=dense_items)
    slice_err = 0.0
    for lo in (0, cfg.d_in - 64):
        xs = x[:, lo:lo + 64].contiguous()
        want = ref.spmm_dense(m, xs).double()
        bound = SUM_TOL * ref.spmm_dense(m, xs.abs()).double()
        diff = (y[:, lo:lo + 64].double() - want).abs()
        slice_err = max(slice_err,
                        float((diff / bound.clamp_min(1e-30)).max()))
        if not bool((diff <= bound).all()):
            problems.append(f"spmm_dense D = {cfg.d_in} columns "
                            f"{lo}:{lo + 64} != plain")
    del y, xs, want, bound, diff
    torch.cuda.empty_cache()
    dense_1433 = {
        "ms": event_ms(lambda: spmm.spmm_dense(m, x, items=dense_items),
                       reps=3),
        "library_ms": event_ms(lambda: torch.sparse.mm(spm, x), reps=1),
        "scratch_bytes": max(dense_items.n_slots, 1) * t * cfg.d_in * 4,
        "err_over_bound_first_last_64": slice_err,
        **dense_by_vec(m, x, dense_items, reps=1),
        **bound_row(*dense_bytes_ops(m, cfg.d_in, g.nnz))}
    if not all(r["same_bits"] for r in dense_1433["by_vec"].values()):
        problems.append(f"spmm_dense's V instances differ at D = "
                        f"{cfg.d_in}")
    emit({"phase": "gnn", "ok": not problems, "problems": problems[:10],
          "config": "gcn-cora", "n": n, "d_in": cfg.d_in,
          "d_hidden": cfg.d_hidden, "n_classes": cfg.n_classes,
          "n_nodes_queried": len(nodes), "launches": launches,
          "features_s": make_s, "wall_s": wall,
          "err_over_scale": err, "float_b2sr_cuda_vs_csr": cross,
          "bit_flips_between_backends": flips,
          "peak_device_bytes": peak, "device_bytes_before": before,
          "batcher": {"queries": len(queries), "groups": b.n_launches,
                      "deduped": b.n_deduped, "launches": batch_launches,
                      "wall_s": flush_s,
                      "nodes_per_s": len(queries) / flush_s,
                      "max_abs_diff": worst},
          "spmm_dense_d1433": dense_1433,
          "timing": [bbf, pack]})
    if problems:
        fail("gnn", "; ".join(problems[:5]))
    for k in names:
        launches[k] += batch_launches[k]
    runs = {f"gnn_infer/{k}": (lambda k=k: gnn_infer(g, nodes,
                                                     f"gcn-cora/{k}"))
            for k in models}
    return [bbf, pack], launches, runs, x


def serve_stream(g, rng_seed, sources):
    """The serve phase's query stream: (kind, source, params) in arrival
    order, the bfs phase's sources among the bfs queries."""
    rng = np.random.default_rng(rng_seed)
    n = g.n_rows
    params = {"bfs": {}, "khop": {"k": SERVE_KHOP_K},
              "sssp": {"edge_weight": 1.0},
              "ppr": {"max_iters": SERVE_PPR_ITERS, "eps": 0.0},
              "gnn_infer": {"model": "gcn-cora/bit"}}
    stream = []
    for kind, count in SERVE_QUERIES.items():
        srcs = [int(s) for s in rng.integers(0, n, count)]
        if kind == "bfs":
            srcs[:len(sources)] = sources
        stream += [(kind, s, params[kind]) for s in srcs]
    order = rng.permutation(len(stream))
    return [stream[i] for i in order]


def serve_run(g, stream, planner, check=False):
    """Serve ``stream`` through a GraphQueryServer (max_batch 64, the
    default 100 ms budget): SERVE_ARRIVAL queries every SERVE_GAP_S
    seconds, ``poll()`` after each batch, then ``flush()``. With
    ``check``, each handle is mapped to the launch that answered it (the
    records a submit or poll appended, by kind and parameters). Returns
    the server, the handles with their submit times, the wall and the
    mapping."""
    from repro_torch.engine import GraphQueryServer, ServerConfig

    server = GraphQueryServer(planner=planner,
                              config=ServerConfig(max_batch=SERVE_MAX_BATCH))
    handles, owner = [], {}

    def settle(n_records):
        if not check:
            return
        new = server.launch_log[n_records:]
        for i, (h, (kind, _, params), _) in enumerate(handles):
            if i in owner or not h.done():
                continue
            key = (kind, tuple(sorted(params.items())))
            recs = [r for r in new if (r.kind, r.params) == key]
            owner[i] = recs[0] if len(recs) == 1 else None

    sync()
    t0 = time.monotonic()
    for start in range(0, len(stream), SERVE_ARRIVAL):
        for q in stream[start:start + SERVE_ARRIVAL]:
            kind, src, params = q
            n_records = len(server.launch_log)
            t_submit = time.monotonic()
            h = server.submit(g, kind, src, **params)
            handles.append((h, q, t_submit))
            settle(n_records)
        n_records = len(server.launch_log)
        server.poll()
        settle(n_records)
        time.sleep(SERVE_GAP_S)
    n_records = len(server.launch_log)
    server.flush()
    settle(n_records)
    sync()
    return server, handles, time.monotonic() - t0, owner


def trace_breakdown(traces):
    """Latency of each trace (first span's start to the last one's end)
    and the share of all trace time in each stage (exclusive times)."""
    lat, stage = [], {}
    for tr in traces:
        start = min(s.start_s for s in tr.spans)
        end = max(s.start_s + s.duration_s for s in tr.spans)
        lat.append(end - start)
        stack = list(tr.spans)
        while stack:
            s = stack.pop()
            stage[s.name] = stage.get(s.name, 0.0) + s.exclusive_s
            stack.extend(s.children)
    total = sum(stage.values())
    return lat, {k: v / total for k, v in sorted(stage.items())}


def percentiles_ms(xs):
    return {"p50": 1e3 * float(np.percentile(xs, 50)),
            "p99": 1e3 * float(np.percentile(xs, 99))}


def serve_faults(problems):
    """Part (d): faults on R-MAT scale 16 (the spgemm phase's graph).

    A scripted injector on ("bfs", "b2sr_cuda") with fail_threshold 2 and
    an injected clock drives the breaker through open, skip, half-open,
    re-open and close (tests/test_serving.py's scenario) on bfs queries
    of SERVE_FAULT_HOPS hops (``max_iters``: a traversal on the ``b2sr``
    word schemes takes seconds at this scale); a rate-1.0 rule
    on every b2sr_cuda launch sends bfs, khop, sssp and ppr groups to
    b2sr, whose answers must equal the healthy b2sr_cuda answers (ppr
    within rtol 1e-4); the injector installed on the dispatch hook makes
    a direct bfs raise. Every degraded launch must follow a fault the
    injector fired or a skip of an open breaker.
    """
    import torch
    from repro_torch.algorithms import bfs
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.engine import (FaultInjector, GraphQueryServer,
                                    InjectedFault, PlanCache, ServerConfig)
    from repro_torch.engine.server import CLOSED, OPEN

    part_s = {}
    t_part = time.perf_counter()
    n = 1 << SPGEMM_SCALE
    rows, cols = rmat_graph(n, avg_degree=2 * EDGEFACTOR, seed=SEED)
    g = GraphMatrix.from_coo(rows, cols, n, n, TILE_DIM, backend="b2sr_cuda",
                             device=DEVICE)
    rng = np.random.default_rng(SEED + 6)
    srcs = [int(s) for s in rng.choice(np.flatnonzero(np.bincount(
        rows, minlength=n)), 4, replace=False)]
    kinds = {"bfs": {}, "khop": {"k": SERVE_KHOP_K},
             "sssp": {"edge_weight": 1.0},
             "ppr": {"max_iters": SERVE_PPR_ITERS, "eps": 0.0},
             "bfs_hops": {"max_iters": SERVE_FAULT_HOPS}}

    def serve(server, kind_list, sources=srcs):
        hs = [(k, s, server.submit(g, k.split("_")[0], s, **kinds[k]))
              for k in kind_list for s in sources]
        server.flush()
        return hs

    healthy = {(k, s): h.result() for k, s, h in serve(
        GraphQueryServer(planner=PlanCache()), kinds)}
    full = [k for k in kinds if k != "bfs_hops"]
    sync()
    part_s["graph_and_healthy"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    audit = []

    def audited(server, inj, fn):
        before = (server.stats["degraded_launches"], inj.n_faults,
                  server.stats["breaker_skips"])
        out = fn()
        d_deg, d_fault, d_skip = (a - b for a, b in zip(
            (server.stats["degraded_launches"], inj.n_faults,
             server.stats["breaker_skips"]), before))
        audit.append((d_deg, d_fault, d_skip))
        if d_deg > d_fault + d_skip:
            problems.append(f"faults: {d_deg} degraded launches after "
                            f"{d_fault} faults and {d_skip} skips")
        return out

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clk = Clock()
    inj = FaultInjector(seed=0).fail(op="bfs", backend="b2sr_cuda",
                                     script=[True] * 4)
    srv = GraphQueryServer(
        planner=PlanCache(), fault_injector=inj, clock=clk,
        sleep=lambda s: None,
        config=ServerConfig(max_retries=1, fail_threshold=2, cooldown_s=1.0,
                            backoff_base_s=0.0))
    steps = []
    for dt in (0.0, 0.0, 1.0, 1.0, 1.0):
        clk.t += dt
        (_, s, h), = audited(srv, inj, lambda: serve(srv, ["bfs_hops"],
                                                     srcs[:1]))
        br = srv.breaker("bfs", "b2sr_cuda")
        steps.append((h.degraded, h.backend_used, br.state, br.n_opens,
                      inj.script_remaining("bfs", "b2sr_cuda")))
        if not torch.equal(h.result(), healthy["bfs_hops", s]):
            problems.append("faults: scripted bfs answer != healthy")
    want = [(True, "b2sr", OPEN, 1, 2), (True, "b2sr", OPEN, 1, 2),
            (True, "b2sr", OPEN, 2, 1), (True, "b2sr", OPEN, 3, 0),
            (False, "b2sr_cuda", CLOSED, 3, 0)]
    if steps != want:
        problems.append(f"faults: breaker steps {steps} != {want}")
    sync()
    part_s["scripted"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    inj2 = FaultInjector(seed=1).fail(backend="b2sr_cuda", rate=1.0)
    srv2 = GraphQueryServer(planner=PlanCache(), fault_injector=inj2,
                            config=ServerConfig(backoff_base_s=0.0))
    degraded = audited(srv2, inj2, lambda: serve(srv2, full))
    ppr_rel = 0.0
    for k, s, h in degraded:
        got, ref = h.result(), healthy[k, s]
        if not (h.degraded and h.backend_used == "b2sr"):
            problems.append(f"faults: {k} not answered on b2sr")
        if k == "ppr":
            ppr_rel = max(ppr_rel, float(((got - ref).abs() / ref.abs()
                                          .clamp_min(1e-30)).max()))
            if not torch.allclose(got, ref, rtol=1e-4, atol=0):
                problems.append("faults: degraded ppr != healthy")
        elif not torch.equal(got, ref):
            problems.append(f"faults: degraded {k} != healthy")

    sync()
    part_s["rate_rule"] = time.perf_counter() - t_part
    with FaultInjector(seed=2).fail(backend="b2sr_cuda", rate=1.0):
        try:
            bfs(g, srcs[0])
            problems.append("faults: installed injector did not fault bfs")
        except InjectedFault:
            pass
    if not torch.equal(bfs(g, srcs[0]).levels, healthy["bfs", srcs[0]]):
        problems.append("faults: bfs after uninstall != healthy")
    return {"scale": SPGEMM_SCALE, "sources": srcs,
            "breaker_steps": [list(s) for s in steps],
            "scripted_stats": {k: srv.stats[k] for k in (
                "launches", "degraded_launches", "retries", "breaker_skips",
                "completed")},
            "rate_rule": {"faults": inj2.n_faults, "checks": inj2.n_checks,
                          **{k: srv2.stats[k] for k in (
                              "launches", "degraded_launches", "retries",
                              "completed")}},
            "audit_degraded_faults_skips": audit,
            "ppr_max_rel_diff": ppr_rel, "part_s": part_s}


def phase_serve(g, sources, want):
    """The serving front end on the full graph (after the gnn phase, whose
    models and features it serves).

    (a) SERVE_QUERIES through a GraphQueryServer on b2sr_cuda (max_batch
        64, default budget), SERVE_ARRIVAL at a time SERVE_GAP_S apart,
        ``poll()`` after each batch, a final ``flush()``: every handle
        resolves on b2sr_cuda, no launch degrades, no query fails, every
        breaker stays closed, spmm_bbb, spmm_dense, spmm_bbf and
        pack_rows launch, every handle equals its LaunchRecord replayed
        through ``launch_group`` bit for bit, and the bfs handles of the
        bfs phase's sources equal SciPy's levels. Then the same stream
        with ``obs.disabled()``, with telemetry on, and on without the
        planner's sync (``planner.SYNC_LATENCY``), twice each, in turns.
    (b) ``write_metrics`` to .prom and .json, read back with
        ``parse_prometheus``; the completed-query counter equals the
        server's count; ``dump_traces`` writes one trace a query.
    (c) ``save_warmup``; a new server with a fresh PlanCache replays
        every recipe; the first arrival batch, served again, adds no
        plan-cache miss; the first query's latency cold (a fresh server
        and PlanCache, no warmup) and warm, SERVE_RESTARTS times in
        turns.
    (d) faults on R-MAT scale 16 (:func:`serve_faults`).
    """
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.engine import GraphQueryServer, PlanCache
    from repro_torch.engine import planner as planner_mod
    from repro_torch.engine.batcher import _Pending, QueryHandle, launch_group
    from repro_torch.engine.server import CLOSED
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import metrics as obs_metrics

    t_phase = time.perf_counter()
    names = ("spmm_bbb", "spmm_dense", "spmm_bbf", "pack_rows")
    stream = serve_stream(g, SEED + 5, sources)
    problems = []
    prev_reg = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    reset_launches(names)
    server, handles, wall, owner = serve_run(g, stream, PlanCache(),
                                             check=True)
    launches = read_launches("serve", names)
    stats = dict(server.stats)
    snap = server.stats()
    n_q = len(stream)
    for i, (h, (kind, src, _), _) in enumerate(handles):
        try:
            h.result()
        except Exception as e:               # noqa: BLE001 — the verdict
            problems.append(f"{kind}/{src} failed: {e!r}")
            continue
        if h.backend_used != "b2sr_cuda" or h.degraded:
            problems.append(f"{kind}/{src} answered on {h.backend_used}")
        if owner.get(i) is None:
            problems.append(f"{kind}/{src}: no launch record")
    if stats["degraded_launches"] or stats["failed_queries"]:
        problems.append(f"degraded {stats['degraded_launches']}, failed "
                        f"{stats['failed_queries']}")
    if stats["completed"] != n_q:
        problems.append(f"completed {stats['completed']} != {n_q}")
    open_breakers = [k for k, b in snap["breakers"].items()
                     if b["state"] != CLOSED]
    if open_breakers:
        problems.append(f"breakers not closed: {open_breakers}")

    # every handle against its launch replayed on b2sr_cuda
    replay_planner = PlanCache()
    mismatches = 0
    for rec in server.launch_log:
        uniq = sorted(set(rec.sources))
        qs = [_Pending(graph=g, kind=rec.kind, source=s, params=rec.params,
                       handle=QueryHandle(None)) for s in uniq]
        _, padded = launch_group(g, rec.kind, dict(rec.params), qs,
                                 replay_planner)
        if padded != rec.sources or rec.backend != "b2sr_cuda":
            problems.append(f"replay of {rec.kind} launched {padded}")
        got = {q.source: q.handle.result() for q in qs}
        for i, (h, (_, src, _), _) in enumerate(handles):
            if owner.get(i) is rec and not torch.equal(h.result(), got[src]):
                mismatches += 1
    if mismatches:
        problems.append(f"{mismatches} handles != their replayed launch")
    for i, s in enumerate(sources):
        h = next(h for h, (k, src, _), _ in handles
                 if k == "bfs" and src == s)
        if not np.array_equal(h.result().cpu().numpy(), want[i]):
            problems.append(f"bfs {s} != scipy")

    traces = [h.trace for h, _, _ in handles]
    by_kind = {}
    for (h, (kind, _, _), t_submit), tr in zip(handles, traces):
        by_kind.setdefault(kind, []).append(tr)
    latency = {k: percentiles_ms(trace_breakdown(trs)[0])
               for k, trs in by_kind.items()}
    _, shares = trace_breakdown(traces)
    missed = {}
    for h, (kind, _, _), _ in handles:
        missed[kind] = missed.get(kind, 0) + int(h.completed_at > h.deadline)

    # (b) export
    with tempfile.TemporaryDirectory() as tmp:
        prom = obs_export.write_metrics(f"{tmp}/serve.prom")
        js = obs_export.write_metrics(f"{tmp}/serve.json")
        parsed = obs_export.parse_prometheus(open(prom).read())
        completed = sum(parsed["server_queries_completed_total"].values())
        json_completed = sum(json.load(open(js))["counters"][
            "server_queries_completed_total"].values())
        n_traces = server.dump_traces(f"{tmp}/traces.jsonl")
        n_lines = len(open(f"{tmp}/traces.jsonl").read().splitlines())
        warm_path = f"{tmp}/warmup.json"
        n_recipes = server.save_warmup(warm_path)
        if completed != stats["completed"] or json_completed != completed:
            problems.append(f"exported completed {completed} != "
                            f"{stats['completed']}")
        if n_traces != stats["completed"] or n_lines != n_traces:
            problems.append(f"dumped {n_traces} traces ({n_lines} lines)")

        # (c) warm restart: cold and warm first batches
        first = stream[:SERVE_ARRIVAL]

        def first_batch(srv):
            sync()
            t0 = time.monotonic()
            hs = [srv.submit(g, k, s, **p) for k, s, p in first]
            srv.flush()
            sync()
            return hs[0].completed_at - t0, hs

        cold, warm = [], []
        for _ in range(SERVE_RESTARTS):       # in turns: cold, warm
            cold.append(first_batch(GraphQueryServer(planner=PlanCache()))[0])
            warm_srv = GraphQueryServer(planner=PlanCache())
            warm_srv.register(g)
            replayed = warm_srv.warmup(warm_path)
            misses = warm_srv.planner.misses
            warm_s, warm_hs = first_batch(warm_srv)
            warm.append(warm_s)
            if replayed != n_recipes or warm_srv.stats["warmup_failed"] or \
                    warm_srv.stats["warmup_skipped"]:
                problems.append(f"warmup replayed {replayed} of {n_recipes}")
            if warm_srv.planner.misses != misses:
                problems.append("warm first batch missed the plan cache")
            if any(h.degraded for h in warm_hs):
                problems.append("warm first batch degraded")
    t_ab = time.perf_counter() - t_phase

    # telemetry's cost: the same stream with obs off, on, and on without
    # the planner's sync at the end of each latency window, in turns
    t0 = time.perf_counter()
    wall_off, wall_on, wall_no_sync = [], [], []
    for _ in range(2):
        with obs.disabled():
            wall_off.append(serve_run(g, stream, PlanCache())[2])
        wall_on.append(serve_run(g, stream, PlanCache())[2])
        planner_mod.SYNC_LATENCY = False
        try:
            wall_no_sync.append(serve_run(g, stream, PlanCache())[2])
        finally:
            planner_mod.SYNC_LATENCY = True
    obs_metrics.set_registry(prev_reg)
    t_telemetry = time.perf_counter() - t0

    faults = serve_faults(problems)
    row = {"phase": "serve", "ok": not problems, "problems": problems[:10],
           "queries": {k: v for k, v in SERVE_QUERIES.items()},
           "launches": launches, "wall_s": wall, "qps": n_q / wall,
           "latency_ms_by_kind": latency, "trace_share": shares,
           "deadline_missed_by_kind": missed,
           "flushes": {"deadline": stats["deadline_flushes"],
                       "fill": stats["fill_flushes"],
                       "forced": stats["flushes"] - stats["deadline_flushes"]
                       - stats["fill_flushes"]},
           "plan_cache": snap["plan_cache"], "deduped": stats["deduped"],
           "group_launches": stats["launches"],
           "telemetry": {"wall_s_on_first": wall, "wall_s_off": wall_off,
                         "wall_s_on": wall_on,
                         "wall_s_on_no_sync": wall_no_sync},
           "export": {"completed": completed, "traces": n_traces},
           "warm_restart": {"recipes": n_recipes, "replayed": replayed,
                            "first_query_cold_ms": [1e3 * x for x in cold],
                            "first_query_warm_ms": [1e3 * x for x in warm]},
           "faults": faults,
           "part_s": {"stream_checks_export_restart": t_ab,
                      "telemetry_streams": t_telemetry,
                      "faults": sum(faults["part_s"].values())},
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(row)
    if problems:
        fail("serve", "; ".join(problems[:5]))
    return launches


def backward_node(root, name: str):
    """The first node of the autograd graph under ``root`` whose name holds
    ``name`` (breadth first)."""
    todo, seen = [root], set()
    while todo:
        node = todo.pop(0)
        if node is None or node in seen:
            continue
        if name in node.name():
            return node
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    raise LookupError(f"no {name} node in the autograd graph")


def phase_train(g, adj, deg, x):
    """GCN training at gcn-cora's full width on the full graph.

    The batch: ``x`` (the gnn phase's bag-of-words features, made on the
    card from SEED; its other tensors are freed by then), labels of the 7
    classes and a TRAIN_MASK share of the nodes in the loss, drawn on the
    card from a seed, the degrees plus one (the graph is symmetric, so
    the receivers' counts are the rows'), Glorot-scaled random weights.
    AdamW at TRAIN_LR, no warmup. Runs, through ``train_steps``:
      - TRAIN_STEPS steps on ``b2sr_cuda`` and on ``csr`` from the same
        weights: every loss finite, the backends' losses within LOSS_RTOL
        at each step; ``spmm_dense``'s launch count over the b2sr_cuda
        steps must be 3 a step (layer 0's and layer 1's forward, layer
        1's backward over Aᵀ: layer 0's input needs no gradient);
      - step 1's gradients (``value_and_grad``) on both, within GRAD_TOL
        of each gradient's max |value|; on b2sr_cuda the backward
        launch's dY and Aᵀ·dY are caught by hooks on the autograd node,
        and Aᵀ·dY must lie within SUM_TOL·(Aᵀ·|dY|) of a float64 SciPy
        product and of the plain version, and give the same bits on a
        second launch;
      - on ``b2sr_cuda`` a run with a checkpoint every step and a failure
        at step TRAIN_FAIL_AT, restarted from its checkpoint to step
        TRAIN_STEPS: its parameters equal the uninterrupted run's bit for
        bit.
    Prints the steps' walls (median of steps 2-4 per backend), the peak
    device memory, and the backward launch's time beside its plain
    version, the csr row, one cuSPARSE SpMM of the float CSR of Aᵀ by
    [n, 16] and its bound. Returns the table row of the backward launch,
    the b2sr_cuda launches of spmm_dense, and a train step for the
    profile phase.
    """
    import tempfile
    import torch
    from repro_torch.configs import gcn_cora
    from repro_torch.core import csr as csr_mod
    from repro_torch.kernels.items import items_for
    from repro_torch.kernels.spmm import ref, spmm
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps
    from repro_torch.training.trainer import (SimulatedFailure,
                                              TrainerConfig, TrainState, run)

    cfg = gcn_cora.CONFIG
    n = g.n_rows
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen,
                           device=DEVICE)
    train_mask = torch.rand(n, generator=gen, device=DEVICE) < TRAIN_MASK
    dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [cfg.n_classes])
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layers.{i}.weight"] = (torch.randn(
            (b, a), generator=gen, device=DEVICE) * (2.0 / (a + b)) ** 0.5)
        params[f"layers.{i}.bias"] = 0.1 * torch.randn(
            b, generator=gen, device=DEVICE)
    none = torch.zeros(0, dtype=torch.int64, device=DEVICE)
    # the GCN reads the edge list only without a graph or degrees
    batches = {be: GraphBatch(
        node_feat=x, senders=none, receivers=none,
        edge_mask=none.bool(), graph=g.with_backend(be),
        degrees=torch.as_tensor(deg + 1.0, dtype=torch.float32,
                                device=DEVICE),
        labels=labels, train_mask=train_mask)
        for be in ("b2sr_cuda", "csr")}
    ocfg = opt_mod.OptimizerConfig(name="adamw", lr=TRAIN_LR,
                                   warmup_steps=0)
    step = train_steps.gnn_train_step(cfg, ocfg)
    problems = []

    # step 1's gradients; on b2sr_cuda catch the backward launch's dY
    base = train_steps.gnn_loss_fn(cfg)
    caught = {}

    def hooked(p, batch):
        loss, aux = base(p, batch)
        node = backward_node(loss.grad_fn, "_DenseProduct")
        node.register_prehook(lambda go: caught.update(dy=go[0].detach()))
        node.register_hook(lambda gi, go: caught.update(dx=gi[-1].detach()))
        return loss, aux

    grads = {}
    reset_launches(["spmm_dense"])
    (_, _), grads["b2sr_cuda"] = train_steps.value_and_grad(
        hooked, params, batches["b2sr_cuda"])
    grad_launches = read_launches("train", ["spmm_dense"])["spmm_dense"]
    (_, _), grads["csr"] = train_steps.value_and_grad(
        base, params, batches["csr"])
    grad_err = {}
    for k, want in grads["csr"].items():
        scale = float(want.abs().max())
        grad_err[k] = float((grads["b2sr_cuda"][k] - want).abs().max()
                            ) / max(scale, 1e-30)
        if grad_err[k] > GRAD_TOL:
            problems.append(f"step 1 gradient {k}: b2sr_cuda != csr")
    del grads

    # the backward launch against float64 SciPy and the plain version
    dy, dx = caught["dy"].contiguous(), caught["dx"]
    gt = g.transposed()
    mt = gt.b2sr
    dy64 = dy.double().cpu().numpy()
    err64 = np.abs(dx.double().cpu().numpy() - adj.T @ dy64)
    bound64 = SUM_TOL * (adj.T @ np.abs(dy64))
    scipy_ratio = float(np.max(err64 / np.maximum(bound64, 1e-30)))
    if not bool((err64 <= bound64).all()):
        problems.append("backward Aᵀ·dY != float64 SciPy")
    del dy64, err64, bound64
    want = ref.spmm_dense(mt, dy).double()
    bound = SUM_TOL * ref.spmm_dense(mt, dy.abs()).double()
    diff = (dx.double() - want).abs()
    plain_ratio = float((diff / bound.clamp_min(1e-30)).max())
    plain_err = float(diff.max())
    if not bool((diff <= bound).all()):
        problems.append("backward Aᵀ·dY != plain version")
    items_t = items_for(gt, spmm.DENSE_ITEM_WORK, by_bits=True)
    again = spmm.spmm_dense(mt, dy, items=items_t)
    if not torch.equal(again.view(torch.int32), dx.view(torch.int32)):
        problems.append("backward Aᵀ·dY differs on a second launch")
    del want, bound, diff, again
    spm_t = csr_mod.to_sparse(gt.csr)
    gct = gt.with_backend("csr")
    backward = {
        "name": "spmm_dense", "d": int(dy.shape[1]),
        "ms": event_ms(lambda: spmm.spmm_dense(mt, dy, items=items_t)),
        "plain_ms": event_ms(lambda: ref.spmm_dense(mt, dy), reps=1),
        "csr_row_ms": event_ms(lambda: gct.mxm(dy), reps=3),
        "library_ms": event_ms(lambda: torch.sparse.mm(spm_t, dy), reps=3),
        "err_over_bound_scipy": scipy_ratio,
        "err_over_bound_plain": plain_ratio,
        "max_abs_err": plain_err,
        **bound_row(*dense_bytes_ops(mt, int(dy.shape[1]), g.nnz)),
        "inputs": f"the GCN's layer-1 backward, Aᵀ·dY at D = "
                  f"{cfg.d_hidden} over the stored transpose; library: "
                  f"cuSPARSE SpMM of the float CSR of Aᵀ"}
    del spm_t, dy, dx, caught
    torch.cuda.empty_cache()

    # TRAIN_STEPS steps per backend from the same weights
    losses, walls, final = {}, {}, {}
    launches = None
    for be in ("b2sr_cuda", "csr"):
        p, o = params, opt_mod.init(ocfg, params)
        losses[be], walls[be] = [], []
        if be == "b2sr_cuda":
            reset_launches(["spmm_dense"])
        for _ in range(TRAIN_STEPS):
            (p, o, m), wall = sync_time(
                lambda: step(p, o, batches[be]))
            losses[be].append(float(m["loss"]))
            walls[be].append(wall)
        if be == "b2sr_cuda":
            launches = read_launches("train", ["spmm_dense"])["spmm_dense"]
            if launches != 3 * TRAIN_STEPS:
                problems.append(f"spmm_dense launched {launches} times in "
                                f"{TRAIN_STEPS} steps, not 3 a step")
        final[be] = p
    for be, ls in losses.items():
        if not all(np.isfinite(ls)):
            problems.append(f"{be} loss not finite: {ls}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["b2sr_cuda"],
                                                    losses["csr"])]
    if max(loss_rel) > LOSS_RTOL:
        problems.append(f"losses b2sr_cuda != csr: {loss_rel}")

    # fail at TRAIN_FAIL_AT, restart from the checkpoint
    reset_launches(["spmm_dense"])
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=1,
                             ckpt_dir=d, log_every=0,
                             fail_at_step=TRAIN_FAIL_AT)
        start = TrainState(params, opt_mod.init(ocfg, params))
        data = itertools.repeat((batches["b2sr_cuda"],))
        try:
            run(tcfg, step, start, data)
            problems.append("the injected failure did not fire")
        except SimulatedFailure:
            pass
        resumed = run(dataclasses.replace(tcfg, fail_at_step=None), step,
                      start, data)
    resume_launches = read_launches("train", ["spmm_dense"])["spmm_dense"]
    same = all(torch.equal(resumed["state"].params[k], v)
               for k, v in final["b2sr_cuda"].items())
    if not same:
        problems.append("resumed parameters != uninterrupted run's")
    if resumed["losses"] != losses["b2sr_cuda"][TRAIN_FAIL_AT:]:
        problems.append("resumed losses != uninterrupted run's")
    peak = torch.cuda.max_memory_allocated()

    emit({"phase": "train", "ok": not problems, "problems": problems[:10],
          "config": "gcn-cora", "n": n, "d_in": cfg.d_in,
          "d_hidden": cfg.d_hidden, "n_classes": cfg.n_classes,
          "steps": TRAIN_STEPS, "train_nodes": int(train_mask.sum()),
          "losses": losses, "loss_rel_diff": loss_rel,
          "step_wall_s": walls,
          "step_wall_median_2_4_s": {be: statistics.median(w[1:])
                                     for be, w in walls.items()},
          "grad_err_over_max": grad_err,
          "resume": {"fail_at": TRAIN_FAIL_AT, "same_params": same,
                     "losses": resumed["losses"]},
          "spmm_dense_launches": {"steps": launches,
                                  "gradient_check": grad_launches,
                                  "fail_and_resume": resume_launches},
          "peak_device_bytes": peak, "device_bytes_before": before,
          "backward": backward})
    if problems:
        fail("train", "; ".join(problems[:5]))
    p, o = final["b2sr_cuda"], opt_mod.init(ocfg, params)
    total = launches + grad_launches + resume_launches
    return backward, total, {"train_step/b2sr_cuda": (
        lambda: step(p, o, batches["b2sr_cuda"]))}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def same_bits(a, b) -> bool:
    """Results equal bit for bit: tensors by their bytes (float32 as
    int32, so -0.0 and NaN payloads count), anything else by ``==``."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    return a == b


def max_diff(a, b) -> float:
    """The largest absolute difference of the floating tensors in two
    results (0 where none differs)."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.is_floating_point() and a.shape == b.shape:
            d = (a.double() - b.double()).abs()
            return float(d[torch.isfinite(d)].max()) if d.numel() else 0.0
        return 0.0 if same_bits(a, b) else float("inf")
    if isinstance(a, (tuple, list)):
        return max([max_diff(x, y) for x, y in zip(a, b)] + [0.0])
    return 0.0 if a == b else float("inf")


def shard_cases(G, G16, sources, srcs, bv, h16, rowsum, gcn):
    """The shard phase's runs on ``G`` (R-MAT scale 21) and ``G16``
    (scale 16), each a function returning its results."""
    from repro_torch.algorithms import (bfs, connected_components,
                                        pagerank, ppr, sssp, triangle_count)
    from repro_torch.core.semiring import ARITHMETIC
    from repro_torch.engine import msbfs, mskhop
    from repro_torch.gnn_bit import layers

    def bfs_all(d):
        return tuple((r.levels, r.n_iterations, tuple(r.directions))
                     for r in (bfs(G, s, direction=d) for s in sources))

    infer, step, params, opt0, batch = gcn

    def gcn_step():
        new, _, m = step(params, opt0, batch(G))
        return tuple(new[k] for k in sorted(new)) + (m["loss"],)

    cases = {f"bfs/{d}": (lambda d=d: bfs_all(d)) for d in DIRECTIONS}
    cases.update({
        "sssp": lambda: (sssp(G, sources[0]).distances,),
        "pagerank": lambda: (pagerank(G).ranks,),
        "ppr": lambda: (ppr(G, sources[0]).ranks,),
        "cc": lambda: (connected_components(G, direction="auto").labels,),
        "count_mxv": lambda: (G.mxv(bv, ARITHMETIC),),
        "msbfs": lambda: (msbfs(G, srcs, direction="auto").levels,),
        "mskhop": lambda: (mskhop(G, srcs, MSKHOP_K),),
        "tc": lambda: (triangle_count(G),),
        "a2/scale16": lambda: (lambda m: (m.tile_row_ptr, m.tile_col_idx,
                                          m.bit_tiles))(G16.mxm(G16).b2sr),
        "bitgnn_aggregate": lambda: (layers.signed_aggregate(G, h16,
                                                             rowsum),),
        "gcn/forward": lambda: (infer(params, batch(G)),),
        "gcn/step": gcn_step})
    return cases


def copy_profile(fn):
    """Device ms of one call of ``fn`` (torch.profiler): in the hand
    kernels, and in everything else (the combines' copies, index_select,
    index_copy_ and concatenation, and torch's own elementwise work), with
    the five largest of the latter; None where the profile recorded no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    hand = ("bbb_walk", "bmv_", "bmm_tc", "spgemm", "spmm_", "pack_rows",
            "window_kernel", "occupancy_kernel", "frontier_columns")
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kern, other = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        if any(h in name for h in hand):
            kern += ms
        else:
            other[name[:80]] = other.get(name[:80], 0.0) + ms
    if not kern and not other:
        return None
    return {"hand_kernels_ms": kern, "other_ms": sum(other.values()),
            "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:5]}


def phase_shard(g, deg, sources, srcs, x):
    """The sharded rows (``GraphMatrix.shard``) on the card.

    R-MAT scale 21 (t = 32, the bfs phase's graph) and scale 16 (the
    spgemm phase's), sharded over a mesh of SHARD_SLOTS slots that all
    name the one card and over a mesh of 1 slot, with ``combine``
    "gather" and "exchange" (on 1 slot the exchange falls to gather, as
    in the reference: no plan). On each sharding, and on the unsharded
    ``b2sr_cuda`` graph: BFS push, pull and auto from the bfs phase's 4
    sources, SSSP, PageRank and PPR (from the first source), CC auto, the
    count mxv on a 5% frontier, msbfs auto and mskhop (k = 2) of the 64
    engine sources, ``triangle_count``, A² at scale 16 (``mxm graph``),
    ``gnn_bit.layers.signed_aggregate`` of a [n, 16] float (``pack_rows``
    and ``spmm_bbf``), and at gcn-cora's widths (the gnn phase's
    features) the GCN forward and one ``gnn_train_step`` with
    ``shardmap_agg_axes=("data",)`` (``spmm_dense`` forward, and its Aᵀ
    backward over the transposed partition). Every result must equal the
    unsharded graph's bit for bit (float rows included: a block's work
    items cut each row as the whole graph's do). Every kernel launches on
    every sharding: counts set to 0 before its runs, read after. The
    unsharded graph's and each sharding's runs go twice; the second pass
    is timed. Prints the walls
    beside the unsharded graph's, the words each combine moves per call
    (one push step, one D = 16 SpMM) and per pass, the partitions'
    balance and edge cut, the device time outside the hand kernels (the
    copies) of PageRank, msbfs and the GCN forward (torch.profiler), the
    shard() wall, the peak device memory and the phase's wall, beside the
    card's name and power limit. Returns the launches per kernel over the shardings.
    """
    import torch
    from repro_torch.configs import gcn_cora
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.operands import BitVector
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps

    t_phase = time.perf_counter()
    card = card_line()
    n = g.n_rows
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    bv = BitVector.pack(torch.rand(n, generator=gen, device=DEVICE) < 0.05,
                        g.tile_dim)
    h16 = torch.randn((n, 16), generator=gen, device=DEVICE)
    rowsum = torch.as_tensor(deg, dtype=torch.float32, device=DEVICE)
    n16 = 1 << SPGEMM_SCALE
    r16, c16 = rmat_graph(n16, avg_degree=2 * EDGEFACTOR, seed=SEED)
    g16 = GraphMatrix.from_coo(r16, c16, n16, n16, TILE_DIM,
                               backend="b2sr_cuda", device=DEVICE)

    # the GCN: the train phase's batch and weights (its seed), gcn-cora
    cfg = gcn_cora.CONFIG
    cfg_sharded = dataclasses.replace(cfg, shardmap_agg_axes=("data",))
    tgen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=tgen,
                           device=DEVICE)
    train_mask = torch.rand(n, generator=tgen, device=DEVICE) < TRAIN_MASK
    dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [cfg.n_classes])
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layers.{i}.weight"] = (torch.randn(
            (b, a), generator=tgen, device=DEVICE) * (2.0 / (a + b)) ** 0.5)
        params[f"layers.{i}.bias"] = 0.1 * torch.randn(
            b, generator=tgen, device=DEVICE)
    none = torch.zeros(0, dtype=torch.int64, device=DEVICE)
    degrees = torch.as_tensor(deg + 1.0, dtype=torch.float32, device=DEVICE)

    def batch(G):
        return GraphBatch(node_feat=x, senders=none, receivers=none,
                          edge_mask=none.bool(), graph=G, degrees=degrees,
                          labels=labels, train_mask=train_mask)

    ocfg = opt_mod.OptimizerConfig(name="adamw", lr=TRAIN_LR,
                                   warmup_steps=0)
    opt0 = opt_mod.init(ocfg, params)

    def gcn(c):
        return (train_steps.gnn_infer_step(c),
                train_steps.gnn_train_step(c, ocfg), params, opt0, batch)

    problems = []
    base = shard_cases(g, g16, sources, srcs, bv, h16, rowsum, gcn(cfg))
    want, walls = {}, {}
    for name, fn in base.items():
        want[name] = fn()
    for name, fn in base.items():               # the timed pass
        _, walls[name, "unsharded"] = sync_time(fn)
    profiles = {"unsharded": {k: copy_profile(base[k]) for k in
                              ("pagerank", "msbfs", "gcn/forward")}}
    del base
    torch.cuda.empty_cache()

    prev_registry = obs_metrics.get_registry()
    totals = dict.fromkeys(SHARD_KERNELS, 0)
    configs = {}
    try:
        for label, slots, combine in SHARD_CONFIGS:
            mesh = make_mesh((slots,), ("data",), [DEVICE] * slots)
            (G, G16), shard_s = sync_time(lambda: (
                g.shard(mesh, combine=combine),
                g16.shard(mesh, combine=combine)))
            cases = shard_cases(G, G16, sources, srcs, bv, h16, rowsum,
                                gcn(cfg_sharded))
            reset_launches(SHARD_KERNELS)
            got = {}
            for name, fn in cases.items():
                got[name] = fn()
                if not same_bits(got[name], want[name]):
                    problems.append(f"{label} {name} != unsharded (max "
                                    f"diff {max_diff(got[name], want[name])})")
            launches = read_launches("shard", SHARD_KERNELS)
            del got
            obs_metrics.set_registry(obs_metrics.MetricsRegistry())
            for name, fn in cases.items():          # the timed pass
                _, walls[name, label] = sync_time(fn)
            per_pass = words(obs_metrics.get_registry())
            per_call = {}
            for what, fn in (("mxv_bitvec", lambda: G.mxv(bv)),
                             ("mxm_dense_d16", lambda: G.mxm(h16))):
                obs_metrics.set_registry(obs_metrics.MetricsRegistry())
                fn()
                per_call[what] = words(obs_metrics.get_registry())
            for k in SHARD_KERNELS:         # both passes and the calls
                totals[k] += wrapper(k).launches
            configs[label] = {
                "slots": slots, "combine": combine, "shard_s": shard_s,
                "exchange_plan": G.xplan is not None,
                "row_starts": list(G.partitioned.row_starts),
                "balance": {"forward": G.partitioned.balance(),
                            "transpose": G.partitioned_t.balance()},
                "edge_cut": {"forward": G.partitioned.edge_cut(),
                             "transpose": G.partitioned_t.edge_cut()},
                "launches_first_pass": launches,
                "words_per_call": per_call, "words_per_pass": per_pass}
            if slots > 1:
                configs[label]["profile"] = {
                    k: copy_profile(cases[k])
                    for k in ("pagerank", "msbfs", "gcn/forward")}
            del G, G16, cases
            torch.cuda.empty_cache()
    finally:
        obs_metrics.set_registry(prev_registry)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "shard", "ok": not problems, "problems": problems[:10],
          "card": card, "scale": int(np.log2(n)), "tile_dim": g.tile_dim,
          "configs": configs, "profile_unsharded": profiles["unsharded"],
          "walls_s": {name: {lbl: walls[name, lbl] for lbl in
                             ["unsharded"] + [c[0] for c in SHARD_CONFIGS]}
                      for name in want},
          "peak_device_bytes": peak,
          "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail("shard", "; ".join(problems[:5]))
    return totals


def words(reg) -> dict:
    """The comm counters of a registry: elements by counter and (op,
    backend, shards)."""
    out = {}
    for c in ("gather_words_total", "exchange_words_total"):
        m = reg.get(c)
        if m is not None:
            out[c] = {",".join(k): v for k, v in m._series.items()}
    return out


def phase_profile(g, source, road, srcs, extra_runs):
    """Device busy time of one run per algorithm and BFS direction
    (torch.profiler, CUPTI): kernel time by name, and the share of the
    wall time the card idled."""
    from repro_torch.algorithms import (bfs, connected_components,
                                        khop_reachability, pagerank, sssp,
                                        triangle_count)
    from repro_torch.engine import batched_ppr, msbfs

    runs = {f"bfs/{d}": (lambda d=d: bfs(g, source, direction=d))
            for d in DIRECTIONS}
    runs["sssp"] = lambda: sssp(g, source)
    runs["pagerank"] = lambda: pagerank(g)
    runs["cc/auto"] = lambda: connected_components(g, direction="auto")
    runs["tc"] = lambda: triangle_count(g)
    runs["khop/road"] = lambda: khop_reachability(road, KHOP_K)
    runs["msbfs/auto"] = lambda: msbfs(g, srcs, direction="auto")
    runs["batched_ppr"] = lambda: batched_ppr(g, srcs[:PPR_SEEDS],
                                              max_iters=10, eps=0.0)
    runs.update(extra_runs)
    out = {name: profiled(fn) for name, fn in runs.items()}
    emit({"phase": "profile", "ok": True, "source": source, "runs": out})


def profiled(fn) -> dict:
    """One call of ``fn`` under torch.profiler (CUPTI): its wall, the
    device's busy time by kernel and the share of the wall it idled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # drop the parameter list, keep the kernel and its functor
            kname = e.name.replace("(anonymous namespace)::", "")
            kname = kname.split("(")[0][:120]
            busy[kname] = (busy.get(kname, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    total = sum(busy.values())
    return {"wall_ms": 1e3 * wall,
            "device_busy_ms": total if busy else None,
            "idle_share": 1 - total / (1e3 * wall) if busy else None,
            "top": sorted(busy.items(), key=lambda kv: -kv[1])[:6]}


def graphcast_float64(model, feat, mesh, chunk: int = 1 << 18):
    """GraphCast's forward in float64 on the card with ``model``'s weights,
    written out plainly (no module code) and in chunks of ``chunk`` rows
    or edges, so the grid-sized edge blocks never stand whole in float64."""
    import torch
    import torch.nn.functional as F
    w = {k: v.detach().double() for k, v in model.state_dict().items()}

    def mlp(name, x):
        i = 0
        while f"{name}.layer_{i}.weight" in w:
            if i:
                x = F.silu(x)
            x = x @ w[f"{name}.layer_{i}.weight"].T + w[f"{name}.layer_{i}.bias"]
            i += 1
        return x

    def rows(fn, n, d):
        out = torch.empty((n, d), dtype=torch.float64, device=feat.device)
        for lo in range(0, n, chunk):
            out[lo:lo + chunk] = fn(slice(lo, min(lo + chunk, n)))
        return out

    def edges(fn, rcv, n_out, d):
        out = torch.zeros((n_out, d), dtype=torch.float64,
                          device=feat.device)
        for lo in range(0, rcv.shape[0], chunk):
            sl = slice(lo, min(lo + chunk, rcv.shape[0]))
            out.index_add_(0, rcv[sl], fn(sl))
        return out

    d = model.cfg.d_hidden
    n_grid = feat.shape[0]
    hg = rows(lambda sl: mlp("grid_encoder", feat[sl].double()), n_grid, d)
    zeros = torch.zeros((1, d), dtype=torch.float64, device=feat.device)
    hm = edges(lambda sl: mlp("g2m_edge", torch.cat(
        [hg[mesh.g2m_senders[sl]],
         zeros.expand(sl.stop - sl.start, d)], -1)),
        mesh.g2m_receivers, mesh.n_mesh, d)
    hm = hm @ w["mesh_embed.weight"].T + w["mesh_embed.bias"]
    snd, rcv = mesh.mesh_senders, mesh.mesh_receivers
    e = torch.zeros((snd.shape[0], d), dtype=torch.float64,
                    device=feat.device)
    for i in range(model.cfg.n_layers):
        e = rows(lambda sl: e[sl] + mlp(f"layers.{i}.edge_mlp", torch.cat(
            [hm[snd[sl]], hm[rcv[sl]], e[sl]], -1)), e.shape[0], d)
        agg = torch.zeros_like(hm).index_add_(0, rcv, e)
        hm = hm + mlp(f"layers.{i}.node_mlp", torch.cat([hm, agg], -1))
    agg = edges(lambda sl: mlp("m2g_edge", torch.cat(
        [hm[mesh.m2g_senders[sl]], hg[mesh.m2g_receivers[sl]]], -1)),
        mesh.m2g_receivers, n_grid, d)
    return rows(lambda sl: mlp("grid_decoder", torch.cat(
        [hg[sl], agg[sl]], -1)), n_grid, model.cfg.n_classes)


def phase_families(g, adj):
    """The other GNN families at their published widths, the GCN's
    graph-level loss over B2SR, the call-time sharded SpMM and Algorithm
    1's profiler (see the module doc, phase 22). Returns the launches of
    ``spmm_dense`` (the GCN steps and ``spmm_b2sr_shardmap``)."""
    import torch
    from repro_torch import nn as rnn
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.configs import gatedgcn as gg_cfg
    from repro_torch.configs import gcn_cora
    from repro_torch.configs import graphcast as gc_cfg
    from repro_torch.core import sampling
    from repro_torch.core.b2sr import coo_to_b2sr
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.ops_sharded import spmm_b2sr_shardmap
    from repro_torch.data import synthetic
    from repro_torch.data.graphs import partition_edges_by_receiver_block
    from repro_torch.data.neighbor_sampler import sampled_sizes
    from repro_torch.models.gnn import egnn, gatedgcn, graphcast
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    problems, walls, peaks, out, prof = [], {}, {}, {}, {}
    ocfg = opt_mod.OptimizerConfig(name="adamw", lr=FAM_LR, warmup_steps=0)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    mesh = make_mesh((FAM_SHARD_SLOTS,), ("data",), [dev] * FAM_SHARD_SLOTS)

    def init(model, seed):
        model = model.to(dev)
        rnn.reset_parameters(model, torch.Generator(device=dev).manual_seed(
            SEED + seed))
        return {k: v.detach() for k, v in model.named_parameters()}

    def train(name, step, params, args, n_steps):
        """``n_steps`` steps from ``params``: losses and walls; a loss
        that is not finite is a problem."""
        o = opt_mod.init(ocfg, params)
        p, losses, ws = params, [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n_steps):
            (p, o, m), wall = sync_time(lambda: step(p, o, *args))
            losses.append(float(m["loss"]))
            ws.append(wall)
        if not all(np.isfinite(losses)):
            problems.append(f"{name}: loss not finite {losses}")
        walls[name] = {"steps_s": ws, "median_2_3_s": statistics.median(
            ws[1:]) if len(ws) > 1 else ws[0], "losses": losses}
        peaks[name] = torch.cuda.max_memory_allocated()
        if name in PROFILED:
            prof[name] = profiled(lambda: step(params, opt_mod.init(
                ocfg, params), *args))
        return p

    # -- GatedGCN: minibatch_lg, molecule, sharded against dense ----------
    cfg = gg_cfg.CONFIG
    params = init(gatedgcn.GatedGCN(cfg), 11)
    step = train_steps.gnn_train_step(cfg, ocfg)
    n_tot, seeds, fanout = FAM_MINIBATCH
    (mb, mb_s) = sync_time(lambda: synthetic.minibatch_batch(
        cfg, n_tot, seeds, fanout, seed=SEED, device=dev))
    if (mb.node_feat.shape[0], mb.senders.shape[0]) != sampled_sizes(
            seeds, fanout):
        problems.append("minibatch_lg: not the static bounds")
    out["minibatch_lg"] = {"nodes": mb.node_feat.shape[0],
                           "edges": mb.senders.shape[0],
                           "real_nodes": int(mb.node_mask.sum()),
                           "real_edges": int(mb.edge_mask.sum()),
                           "build_s": mb_s}
    train("gatedgcn/minibatch_lg", step, params, (mb,), FAM_STEPS)
    mol = synthetic.molecule_batch(cfg, *FAM_MOLECULES, seed=SEED,
                                   device=dev)
    train("gatedgcn/molecule", step, params, (mol,), 2)

    n16 = 1 << FAM_SCALE
    rb = synthetic.rmat_batch(cfg, n16, seed=SEED, with_b2sr=False,
                              device=dev)
    snd, rcv, msk = partition_edges_by_receiver_block(
        rb.senders.cpu().numpy(), rb.receivers.cpu().numpy(), n16,
        FAM_SHARD_SLOTS)
    rb = dataclasses.replace(
        rb, senders=torch.as_tensor(snd, device=dev),
        receivers=torch.as_tensor(rcv, device=dev),
        edge_mask=torch.as_tensor(msk, device=dev))
    dense_cfg = dataclasses.replace(cfg, remat=True)
    shard_cfg = dataclasses.replace(dense_cfg, shardmap_agg_axes=("data",))
    calls = []
    orig = gatedgcn.GatedGCNLayer.agg_sharded
    gatedgcn.GatedGCNLayer.agg_sharded = (
        lambda *a: calls.append(1) or orig(*a))
    try:
        res = {}
        for name, c in (("dense", dense_cfg), ("sharded", shard_cfg)):
            n_calls = len(calls)
            infer = train_steps.gnn_infer_step(c, mesh=mesh)
            logits, fwd_s = sync_time(lambda: infer(params, rb))
            _, fwd_s = sync_time(lambda: infer(params, rb))
            s = train_steps.gnn_train_step(c, ocfg, mesh=mesh)
            o = opt_mod.init(ocfg, params)
            (_, _, m), _ = sync_time(lambda: s(params, o, rb))
            (_, _, m), step_s = sync_time(lambda: s(params, o, rb))
            res[name] = (logits, float(m["loss"]), fwd_s, step_s,
                         len(calls) - n_calls)
            if name == "dense":
                prof["gatedgcn/rmat16/dense_step"] = profiled(
                    lambda: s(params, o, rb))
    finally:
        gatedgcn.GatedGCNLayer.agg_sharded = orig
    (ld, lossd, fd, sd, cd), (ls_, losss, fs, ss, cs) = (res["dense"],
                                                         res["sharded"])
    if cd != 0 or cs != 6 * cfg.n_layers:
        # two sharded forwards and two steps of a forward and its
        # recomputation (remat): n_layers calls each; the dense path none
        problems.append(f"gatedgcn sharded path calls: dense {cd}, "
                        f"sharded {cs}")
    close = bool(torch.allclose(ls_, ld, rtol=SHARD_TOL_FAM,
                                atol=SHARD_TOL_FAM))
    if not close:
        problems.append("gatedgcn sharded logits != dense")
    loss_rel = abs(losss - lossd) / abs(lossd)
    if loss_rel > LOSS_RTOL:
        problems.append(f"gatedgcn sharded loss != dense ({loss_rel})")
    out["gatedgcn_sharded"] = {
        "graph": f"rmat scale {FAM_SCALE}", "n": n16,
        "edges_padded": int(msk.size), "edges": int(msk.sum()),
        "slots": FAM_SHARD_SLOTS, "remat": True,
        "logits_max_abs_diff": float((ls_ - ld).abs().max()),
        "loss_rel_diff": loss_rel, "sharded_layer_calls": cs,
        "forward_s": {"dense": fd, "sharded": fs},
        "step_s": {"dense": sd, "sharded": ss},
        "sharded_over_dense": {"forward": fs / fd, "step": ss / sd}}
    del rb, ld, ls_, res, mb, mol, params

    # -- EGNN: molecule and minibatch_lg with coordinates, equivariance ---
    cfg = egnn_cfg.CONFIG
    params = init(egnn.EGNN(cfg), 12)
    step = train_steps.gnn_train_step(cfg, ocfg)
    mol = synthetic.molecule_batch(cfg, *FAM_MOLECULES, seed=SEED + 1,
                                   device=dev)
    train("egnn/molecule", step, params, (mol,), FAM_STEPS)
    mb = synthetic.minibatch_batch(cfg, n_tot, seeds, fanout, seed=SEED,
                                   coords=True, device=dev)
    train("egnn/minibatch_lg", step, params, (mb,), FAM_STEPS)
    model = egnn.EGNN(cfg).to(dev)
    model.load_state_dict(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, _ = torch.linalg.qr(torch.randn((3, 3), generator=gen, device=dev))
    shift = torch.randn(3, generator=gen, device=dev)
    with torch.no_grad():
        h, x = model(mol)
        h2, x2 = model(dataclasses.replace(mol,
                                           coords=mol.coords @ q.T + shift))
    eq = {"h_err_over_scale": float((h2 - h).abs().max() / h.abs().max()),
          "x_err_over_scale": float((x2 - (x @ q.T + shift)).abs().max()
                                    / (x @ q.T + shift).abs().max())}
    if max(eq.values()) > EQUIV_TOL:
        problems.append(f"egnn equivariance {eq}")
    out["egnn_equivariance"] = eq
    del mol, mb, model, h, x, h2, x2, params

    # -- GraphCast: 0.25° forward against float64, a 1° train step --------
    cfg = gc_cfg.CONFIG
    model = graphcast.GraphCast(cfg)
    params = init(model, 14)
    gc = {"tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    if gc["tf32"]:
        problems.append("float32 matmuls run as TF32")
    for label, (lat, lon) in (("0.25deg", GRID_025),):
        n_grid = lat * lon
        gmesh = graphcast.build_mesh(n_grid, cfg.mesh_refinement, seed=SEED,
                                     device=dev)
        feat = torch.randn((n_grid, cfg.d_in), generator=torch.Generator(
            device=dev).manual_seed(SEED + 15), device=dev)
        infer = train_steps.graphcast_infer_step(cfg, gmesh)
        torch.cuda.reset_peak_memory_stats()
        pred, first_s = sync_time(lambda: infer(params, feat))
        _, fwd_s = sync_time(lambda: infer(params, feat))
        peaks[f"graphcast/{label}/forward"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ref64, ref_s = sync_time(lambda: graphcast_float64(model, feat,
                                                               gmesh))
        peaks[f"graphcast/{label}/float64"] = torch.cuda.max_memory_allocated()
        scale = float(ref64.abs().max())
        err = float((pred.double() - ref64).abs().max()) / scale
        if not (err <= GC_TOL and bool(torch.isfinite(pred).all())):
            problems.append(f"graphcast {label} vs float64: {err}")
        gc[label] = {"grid": [lat, lon], "grid_nodes": n_grid,
                     "mesh_nodes": gmesh.n_mesh,
                     "mesh_edges": int(gmesh.mesh_senders.shape[0]),
                     "m2g_edges": int(gmesh.m2g_senders.shape[0]),
                     "forward_s": fwd_s, "first_forward_s": first_s,
                     "float64_s": ref_s, "max_abs": scale,
                     "err_over_max": err}
        del gmesh, feat, pred, ref64, infer
        torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=GC_TRAIN_LAYERS)
    params4 = {k: v for k, v in params.items()
               if not k.startswith("layers.")
               or int(k.split(".")[1]) < GC_TRAIN_LAYERS}
    n_grid = GRID_1[0] * GRID_1[1]
    gmesh = graphcast.build_mesh(n_grid, cfg.mesh_refinement, seed=SEED,
                                 device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    feat = torch.randn((n_grid, cfg.d_in), generator=gen, device=dev)
    target = torch.randn((n_grid, cfg.n_classes), generator=gen, device=dev)
    train("graphcast/1deg_4_layers",
          train_steps.graphcast_train_step(cfg4, ocfg, gmesh), params4,
          (feat, target), 1)
    gc["1deg"] = {"grid": list(GRID_1), "grid_nodes": n_grid,
                  "processor_layers": GC_TRAIN_LAYERS}
    out["graphcast"] = gc
    del gmesh, feat, target, params, params4, model
    torch.cuda.empty_cache()

    # -- GCN graph-level over B2SR: spmm_dense forward and Aᵀ backward ----
    cfg = gcn_cora.CONFIG
    mol = synthetic.molecule_batch(cfg, *FAM_MOLECULES, seed=SEED + 2,
                                   with_b2sr=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dims = ([cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [cfg.n_classes])
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layers.{i}.weight"] = (torch.randn(
            (b, a), generator=gen, device=dev) * (2.0 / (a + b)) ** 0.5)
        params[f"layers.{i}.bias"] = 0.1 * torch.randn(
            b, generator=gen, device=dev)
    reset_launches(["spmm_dense"])
    step = train_steps.gnn_train_step(cfg, ocfg)
    train("gcn/molecule/b2sr_cuda", step, params, (mol,), FAM_STEPS)
    gcn_launches = read_launches("families", ["spmm_dense"])["spmm_dense"]
    if gcn_launches != 3 * FAM_STEPS:
        problems.append(f"gcn graph-level: spmm_dense launched "
                        f"{gcn_launches} times in {FAM_STEPS} steps")
    # profiled once more after the count is read
    prof["gcn/molecule/b2sr_cuda"] = profiled(lambda: step(
        params, opt_mod.init(ocfg, params), mol))
    train("gcn/molecule/segment_sum", train_steps.gnn_train_step(
        dataclasses.replace(cfg, use_b2sr=False), ocfg), params, (mol,),
        FAM_STEPS)
    a = walls["gcn/molecule/b2sr_cuda"]["losses"]
    b = walls["gcn/molecule/segment_sum"]["losses"]
    gcn_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if gcn_rel > LOSS_RTOL:
        problems.append(f"gcn graph-level b2sr_cuda != segment sum: {a} {b}")
    out["gcn_graph_level"] = {"graphs": FAM_MOLECULES[0],
                              "edges_kept": int(mol.edge_mask.sum()),
                              "loss_rel_diff": gcn_rel,
                              "spmm_dense_launches": gcn_launches}
    del mol, params

    # -- spmm_b2sr_shardmap at D = 16 on the main graph over 4 slots ------
    x = torch.randn((g.n_rows, 16), generator=torch.Generator(
        device=dev).manual_seed(SEED + 18), device=dev)
    want, unsharded_s = sync_time(lambda: g.mxm(x))
    reset_launches(["spmm_dense"])
    got, shardmap_s = sync_time(lambda: spmm_b2sr_shardmap(
        g, x, ("data",), mesh))
    sm_launches = read_launches("families", ["spmm_dense"])["spmm_dense"]
    same = same_bits(got, want)
    if not same or sm_launches < FAM_SHARD_SLOTS:
        problems.append(f"spmm_b2sr_shardmap: same bits {same}, "
                        f"{sm_launches} launches")
    out["spmm_b2sr_shardmap"] = {"d": 16, "slots": FAM_SHARD_SLOTS,
                                 "same_bits": same,
                                 "spmm_dense_launches": sm_launches,
                                 "wall_s": shardmap_s,
                                 "unsharded_wall_s": unsharded_s}
    del x, want, got

    # -- Algorithm 1 on the main graph against the built B2SR -------------
    n = g.n_rows
    est, est_s = sync_time(lambda: sampling.sample_profile(
        adj.indptr, adj.indices, n, n, PROFILE_SAMPLES, seed=SEED))
    coo = adj.tocoo()
    rows_t = torch.as_tensor(coo.row, device=dev)
    cols_t = torch.as_tensor(coo.col, device=dev)
    del coo
    real = {}
    for t in (4, 8, 16, 32):
        m = (g.b2sr if t == g.tile_dim
             else coo_to_b2sr(rows_t, cols_t, n, n, t, device=dev))
        real[t] = sampling.b2sr_storage_bytes(m)
        del m
        torch.cuda.empty_cache()
    del rows_t, cols_t
    out["sample_profile"] = {
        "samples": PROFILE_SAMPLES, "profile_s": est_s,
        "est_bytes": est.est_b2sr_bytes, "real_bytes": real,
        "est_over_real_minus_1": {t: est.est_b2sr_bytes[t] / real[t] - 1
                                  for t in real},
        "csr_bytes": sampling.csr_storage_bytes(n, len(adj.indices)),
        "recommended_tile_dim": est.recommended_tile_dim,
        "best_real_tile_dim": min(real, key=real.get)}

    emit({"phase": "families", "ok": not problems,
          "problems": problems[:10],
          "step_walls": walls, "profile": prof,
          "peak_device_bytes": peaks,
          "phase_peak_device_bytes": max(peaks.values()),
          "phase_s": time.perf_counter() - t_phase,
          "reduced": [
              f"graphcast train step at 1 degree ({GRID_1[0] * GRID_1[1]:,} "
              f"grid nodes) with {GC_TRAIN_LAYERS} processor layers, not "
              "16: autograd of 16 layers at d 512 over 327,660 multimesh "
              "edges keeps about 75-80 GB of activations (the reference's "
              "GraphCast has no remat)",
              "minibatch_lg's graph is the reference's minibatch_batch dot "
              f"graph ({FAM_MINIBATCH[0]:,} nodes at density 20/n), not "
              "ogbn-products' 114,615,892 edges",
              f"the sharded GatedGCN and spmm_b2sr_shardmap run on "
              f"{FAM_SHARD_SLOTS} slots of one card",
              "random weights and features from seeds"],
          "card": card_line(), **out})
    if problems:
        fail("families", "; ".join(problems[:5]))
    return gcn_launches + sm_launches


def lm_params(cfg, dev, seed: int, dtype=None):
    """``cfg``'s transformer drawn by the port's own seeded initialisation
    on ``dev`` (in ``dtype``, default float32), as named tensors."""
    import torch
    from repro_torch import nn as rnn
    from repro_torch.models.transformer import Transformer
    with torch.device("meta"):
        model = Transformer(cfg)
    model = model.to_empty(device=dev)
    if dtype is not None:
        model = model.to(dtype)
    rnn.reset_parameters(model, torch.Generator(device=dev).manual_seed(
        SEED + seed))
    return {k: v.detach() for k, v in model.named_parameters()}


def lm_serve(cfg, params, prompt, n_decode: int, profile_decode=False):
    """``lm_prefill_step`` of ``prompt`` [B, S], its keys and values
    copied into a cache of ``S + n_decode`` (``prefill_into_cache``, one
    wall for both), then ``n_decode`` greedy
    ``lm_decode_step``s: walls, tokens, cache bytes, finiteness (and one
    more decode step under torch.profiler)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training import train_steps
    prefill = train_steps.lm_prefill_step(cfg)
    decode = train_steps.lm_decode_step(cfg)
    B, S = prompt.shape
    (logits, ck, cv), prefill_s = sync_time(lambda: T.prefill_into_cache(
        cfg, lambda t: prefill(params, t), prompt, S + n_decode))
    finite = bool(torch.isfinite(logits).all())
    tok = logits[:, -1].argmax(-1).reshape(B, 1)
    walls, toks = [], [tok]
    for i in range(n_decode):
        (logits, ck, cv), wall = sync_time(
            lambda: decode(params, tok, ck, cv, S + i))
        finite &= bool(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1).reshape(B, 1)
        walls.append(wall)
        toks.append(tok)
    out = {"batch": B, "prompt": S, "decode_steps": n_decode,
           "prefill_s": prefill_s, "prefill_tok_s": B * S / prefill_s,
           "decode_step_s": walls,
           "decode_p50_ms": 1e3 * float(np.percentile(walls, 50)),
           "decode_p99_ms": 1e3 * float(np.percentile(walls, 99)),
           "decode_tok_s": B / statistics.mean(walls),
           "cache_bytes": 2 * ck.numel() * ck.element_size(),
           "finite": finite,
           "tokens": torch.cat(toks, 1)[0, :8].tolist(),
           "tokens_in_vocab": bool(all(0 <= int(t.min()) and int(t.max())
                                       < cfg.vocab_size for t in toks))}
    if profile_decode:
        out["decode_profile"] = profiled(
            lambda: decode(params, tok, ck, cv, S + n_decode - 1))
    return out


def init_loss(cfg) -> float:
    """The cross entropy expected at the port's initialisation: the head
    sees unit-RMS states, so the logits are Gaussian with variance
    ``d·0.02²`` (tied to the N(0, 0.02²) embedding) or 1 (an N(0, 1/d)
    head), and E[logsumexp] is about ln V + σ²/2."""
    var = cfg.d_model * 0.02 ** 2 if cfg.tie_embeddings else 1.0
    return math.log(cfg.vocab_size) + var / 2


def plain_moe(p, x, moe, cap=None):
    """``moe_ffn``'s routed output written plainly: per expert, the
    tokens whose top-k holds it (in token order; with ``cap``, the first
    ``cap`` of them) get gate × SwiGLU_e(x); and the top-k."""
    import torch
    import torch.nn.functional as F
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router.weight"].T, -1)
    gate, idx = torch.topk(probs, moe.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(moe.n_experts):
        n, j = (idx == e).nonzero(as_tuple=True)
        n, j = n[:cap], j[:cap]
        h = F.silu(xt[n] @ p["w_gate"][e]) * (xt[n] @ p["w_up"][e])
        y.index_add_(0, n, (h @ p["w_down"][e]) * gate[n, j, None])
    return y.reshape(x.shape), idx


def phase_lm():
    """The LM family at full width (see the module doc, phase 23)."""
    import gc

    import torch
    import torch.nn.functional as F
    from repro_torch import nn as rnn
    from repro_torch.configs import (arctic_480b, gemma_7b, minitron_4b,
                                     phi4_mini_3_8b, qwen3_moe_30b_a3b)
    from repro_torch.core import blockmask
    from repro_torch.data import synthetic
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, torch.cuda.current_device())
    problems, out, peaks, prof = [], {}, {}, {}
    out["start_allocated_bytes"] = torch.cuda.memory_allocated()
    out["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    if out["tf32"]:
        problems.append("float32 matmuls run as TF32")
    torch.cuda.reset_peak_memory_stats()

    def part_done(name):
        peaks[name] = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def of_max(got, want) -> float:
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    # -- (b) phi4-mini-3.8b, float32 weights: decode, bf16, chunked -------
    cfg = phi4_mini_3_8b.CONFIG
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm_params(cfg, dev, 20)
    tokens = synthetic.lm_batch(cfg, 1, LM_CHECK, seed=SEED, device=dev)[0]
    pre32 = train_steps.lm_prefill_step(cfg32)
    (full, _), full_s = sync_time(lambda: pre32(params, tokens))
    _, K, V = T.prefill_into_cache(cfg32, lambda t: pre32(params, t),
                                   tokens[:, :-1], LM_CHECK)
    dec, _, _ = train_steps.lm_decode_step(cfg32)(params, tokens[:, -1:], K,
                                                  V, LM_CHECK - 1)
    del K, V
    dec_ok = bool(torch.allclose(dec[:, 0], full[:, -1], rtol=LM_DECODE_TOL,
                                 atol=LM_DECODE_TOL))
    (bf, _), bf_s = sync_time(lambda: train_steps.lm_prefill_step(cfg)(
        params, tokens))
    bf_rel = of_max(bf[:, -1], full[:, -1])
    if not dec_ok:
        problems.append("phi4 decode_step != forward's last position")
    if not bf_rel <= LM_BF16_TOL:
        problems.append(f"phi4 bfloat16 logits {bf_rel} of max |logit|")
    checks = {"prompt": LM_CHECK, "forward_s": full_s, "bf16_forward_s": bf_s,
              "decode_vs_forward_max_abs": float(
                  (dec[:, 0] - full[:, -1]).abs().max()),
              "max_abs_logit": float(full[:, -1].abs().max()),
              "bf16_vs_f32_of_max_logit": bf_rel}
    blk = T.Block(cfg32).to(dev)
    blk.load_state_dict({k[len("layers.0."):]: v for k, v in params.items()
                         if k.startswith("layers.0.")})
    t4k = synthetic.lm_batch(cfg, 1, LM_CHUNK_CHECK, seed=SEED + 1,
                             device=dev)[0]
    S4 = LM_CHUNK_CHECK
    with torch.no_grad():
        x = blk.attn_norm(F.embedding(t4k.long(), params["embed"]))
        pos = torch.arange(S4, device=dev)[None]
        q = T.rope(blk.wq(x).reshape(1, S4, cfg.n_heads, cfg.head_dim),
                   pos, cfg.rope_theta)
        k = T.rope(blk.wk(x).reshape(1, S4, cfg.n_kv_heads, cfg.head_dim),
                   pos, cfg.rope_theta)
        v = blk.wv(x).reshape(1, S4, cfg.n_kv_heads, cfg.head_dim)
        causal = torch.tril(torch.ones((S4, S4), dtype=torch.bool,
                                       device=dev))[None, None]
        plain, plain_s = sync_time(lambda: T.gqa_attention(q, k, v, causal))
        chunk = {}
        for probs_bf16, tol in ((False, LM_CHUNK_TOL),
                                (True, LM_CHUNK_BF16_TOL)):
            c = dataclasses.replace(cfg32, attn_probs_bf16=probs_bf16)
            got, wall = sync_time(lambda: T.chunked_causal_attention(
                q, k, v, c))
            err = of_max(got, plain)
            chunk[f"probs_bf16_{probs_bf16}"] = {"of_max": err, "s": wall}
            if not err <= tol:
                problems.append(f"chunked attention (probs_bf16 "
                                f"{probs_bf16}) {err} of max |out|")
        # the scores of bfloat16 q and k against the float32 product of
        # the same values: rounding them to bfloat16 would miss by ~2e-3
        qg = q.bfloat16().reshape(1, S4, cfg.n_kv_heads, -1, cfg.head_dim)
        s16, s32 = (T.attn_scores(qg.to(dt), k.bfloat16().to(dt))
                    for dt in (torch.bfloat16, torch.float32))
        checks["scores_bf16_vs_f32_of_max"] = of_max(s16, s32)
        checks["scores_rounded_to_bf16_of_max"] = of_max(s16.bfloat16(), s32)
        checks["max_abs_score"] = float(s32.abs().max())
        del qg, s16, s32
        if not checks["scores_bf16_vs_f32_of_max"] <= LM_SCORES_TOL:
            problems.append("bfloat16 attention scores "
                            f"{checks['scores_bf16_vs_f32_of_max']} of "
                            "max |s| from their float32 product")
    checks["chunked_vs_plain"] = dict(chunk, S=S4, plain_s=plain_s)
    out["phi4_checks"] = checks
    del blk, x, q, k, v, causal, plain, got, full, bf, dec
    params16 = rnn.tree_cast(params, torch.bfloat16)
    del params
    part_done("phi4_checks")

    # -- (a) phi4-mini-3.8b serving: a 32k prefill and 32 decode steps ----
    prompt = synthetic.lm_batch(cfg, 1, LM_PREFILL, seed=SEED + 2,
                                device=dev)[0]
    res = lm_serve(cfg, params16, prompt, LM_DECODE, profile_decode=True)
    prof["phi4/decode_step"] = res.pop("decode_profile")
    w_bytes = rnn.param_bytes(params16)
    flops = (2 * (cfg.n_params() - cfg.vocab_size * cfg.d_model)
             * LM_PREFILL + 2 * cfg.d_model * cfg.vocab_size
             + 2 * LM_PREFILL * LM_PREFILL * cfg.q_dim * cfg.n_layers)
    res.update(weight_bytes=w_bytes, n_params=cfg.n_params(),
               decode_read_ms=1e3 * (w_bytes + res["cache_bytes"])
               / HBM_BYTES_PER_S,
               prefill_flops=flops,
               prefill_bound_s=flops / BF16_TFLOPS)
    if not (res["finite"] and res["tokens_in_vocab"]):
        problems.append("phi4 serving: logits not finite or bad tokens")
    out["phi4_serve"] = res
    del params16, prompt
    part_done("phi4_serve")

    # -- (c) phi4-mini-3.8b training, 2 layers at train_4k's 4,096 tokens -
    n_layers, batch, seq = LM_TRAIN
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    params = lm_params(cfg2, dev, 21)
    t, lab = synthetic.lm_batch(cfg2, batch, seq, seed=SEED + 3, device=dev)
    ocfg = opt_mod.OptimizerConfig(name="adamw", lr=LM_LR, warmup_steps=0)
    step = train_steps.lm_train_step(cfg2, ocfg)
    p, o, losses, walls = params, opt_mod.init(ocfg, params), [], []
    for _ in range(LM_TRAIN_STEPS):
        (p, o, m), wall = sync_time(lambda: step(p, o, t, lab))
        losses.append(float(m["loss"]))
        walls.append(wall)
    del p, o, m
    peaks["phi4_train_steps"] = torch.cuda.max_memory_allocated()
    if not (all(np.isfinite(losses)) and abs(losses[0] - init_loss(cfg))
            <= 0.5 and losses[-1] < losses[0]):
        problems.append(f"phi4 train losses {losses} (at init "
                        f"{init_loss(cfg)})")
    prof["phi4/train_step_2_layers"] = profiled(
        lambda: step(params, opt_mod.init(ocfg, params), t, lab))
    # SGD's momentum after one step is the gradient (no clipping); at
    # float32 compute and float32 attention probabilities, since bfloat16
    # rounds the two microbatches' products and probabilities apart
    sgd = opt_mod.OptimizerConfig(name="sgd", lr=LM_LR, warmup_steps=0,
                                  grad_clip=1e9)
    cfg2_32 = dataclasses.replace(cfg2, dtype="float32",
                                  attn_probs_bf16=False)
    g1 = train_steps.lm_train_step(cfg2_32, sgd)(
        params, opt_mod.init(sgd, params), t, lab)[1].m
    g2 = train_steps.lm_train_step(cfg2_32, sgd, grad_accum=2)(
        params, opt_mod.init(sgd, params), t, lab)[1].m
    accum = max(of_max(g2[k], g1[k]) for k in g1)
    if not accum <= LM_ACCUM_TOL:
        problems.append(f"phi4 grad_accum 2 vs 1: {accum} of max |g|")
    out["phi4_train"] = {"layers": n_layers, "batch": batch, "seq": seq,
                         "n_params": cfg2.n_params(), "optimizer": "adamw",
                         "losses": losses,
                         "ln_vocab": math.log(cfg.vocab_size),
                         "init_loss": init_loss(cfg),
                         "step_s": walls, "grad_accum_2_of_max_g": accum}
    del params, g1, g2, t, lab
    part_done("phi4_train_accum")

    # -- (d) qwen3-moe-30b-a3b: 4 layers serving, MoE checks, 2 layers train
    qcfg = qwen3_moe_30b_a3b.CONFIG
    scfg = dataclasses.replace(qcfg, n_layers=MOE_LAYERS[0])
    params16 = lm_params(scfg, dev, 22, torch.bfloat16)
    prompt = synthetic.lm_batch(scfg, 1, MOE_PREFILL, seed=SEED + 4,
                                device=dev)[0]
    res = lm_serve(scfg, params16, prompt, MOE_DECODE)
    res.update(layers=MOE_LAYERS[0], n_params=scfg.n_params(),
               weight_bytes=rnn.param_bytes(params16))
    if not (res["finite"] and res["tokens_in_vocab"]):
        problems.append("qwen3 serving: logits not finite or bad tokens")
    moe_p = {k[len("layers.0.moe."):]: v.float()
             for k, v in params16.items() if k.startswith("layers.0.moe.")}
    del params16, prompt
    layer = moe_mod.MoE(qcfg).to(dev)
    layer.load_state_dict(moe_p)
    x = torch.randn((1, MOE_CHECK_TOKENS, qcfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 24), device=dev)
    moe_checks = {}
    with torch.no_grad():
        for cf in (8.0, qcfg.moe.capacity_factor):
            c = dataclasses.replace(qcfg, moe=dataclasses.replace(
                qcfg.moe, capacity_factor=cf))
            cap = moe_mod.capacity(MOE_CHECK_TOKENS, c.moe)
            (y, _), wall = sync_time(lambda: moe_mod.moe_ffn(layer, x, c))
            _, _, gates, experts = moe_mod.route(layer, x.reshape(
                -1, qcfg.d_model), c.moe)
            _, _, dropped = moe_mod.dispatch_table(
                experts, gates, c.moe.n_experts, cap)
            want, idx = plain_moe(moe_p, x, c.moe, cap)
            counts = np.bincount(idx.reshape(-1).cpu().numpy(),
                                 minlength=c.moe.n_experts)
            recount = int(np.maximum(counts - cap, 0).sum())
            err = of_max(y, want)
            moe_checks[f"cf_{cf}"] = {
                "capacity": cap, "dropped": int(dropped),
                "numpy_recount": recount, "of_max_y": err, "s": wall,
                "same_top_k": bool(torch.equal(idx, experts))}
            if (not err <= MOE_TOL or int(dropped) != recount
                    or (cf == 8.0 and recount)):
                problems.append(f"qwen3 moe_ffn cf {cf}: "
                                f"{moe_checks[f'cf_{cf}']}")
    del layer, moe_p, x, y, want
    part_done("qwen3_serve_moe")
    tcfg = dataclasses.replace(qcfg, n_layers=MOE_LAYERS[1])
    params = lm_params(tcfg, dev, 23)
    t, lab = synthetic.lm_batch(tcfg, 1, LM_TRAIN[2], seed=SEED + 5,
                                device=dev)
    ocfg16 = dataclasses.replace(ocfg, moment_dtype="bfloat16")
    (_, _, m), wall = sync_time(lambda: train_steps.lm_train_step(
        tcfg, ocfg16)(params, opt_mod.init(ocfg16, params), t, lab))
    loss = float(m["loss"])
    if not abs(loss - init_loss(qcfg)) <= 0.5:
        problems.append(f"qwen3 train loss {loss} (at init "
                        f"{init_loss(qcfg)})")
    out["qwen3_moe"] = {"serve": res, "moe_ffn": moe_checks,
                        "train": {"layers": MOE_LAYERS[1], "batch": 1,
                                  "seq": LM_TRAIN[2],
                                  "n_params": tcfg.n_params(),
                                  "optimizer": "adamw, bfloat16 moments",
                                  "loss": loss,
                                  "init_loss": init_loss(qcfg),
                                  "step_s": wall}}
    del params, t, lab, m
    part_done("qwen3_train")

    # -- (e) gemma-7b and minitron-4b (2 layers), arctic-480b reduced -----
    others = {}
    for seed, mod in ((25, gemma_7b), (26, minitron_4b)):
        c = dataclasses.replace(mod.CONFIG, n_layers=2)
        params16 = lm_params(c, dev, seed, torch.bfloat16)
        prompt = synthetic.lm_batch(c, 1, OTHER_PREFILL, seed=SEED + seed,
                                    device=dev)[0]
        res = lm_serve(c, params16, prompt, OTHER_DECODE)
        res.update(layers=2, n_params=c.n_params())
        if not (res["finite"] and res["tokens_in_vocab"]):
            problems.append(f"{c.name} serving: not finite or bad tokens")
        others[c.name] = res
        del params16, prompt
    acfg = arctic_480b.reduced()
    params = lm_params(acfg, dev, 27, torch.bfloat16)
    sgd16 = opt_mod.OptimizerConfig(name="sgd", moment_dtype="bfloat16",
                                    lr=LM_LR, warmup_steps=0)
    t, lab = synthetic.lm_batch(acfg, 2, acfg.max_seq_len, seed=SEED + 6,
                                device=dev)
    (newp, st, m), wall = sync_time(lambda: train_steps.lm_train_step(
        acfg, sgd16)(params, opt_mod.init(sgd16, params), t, lab))
    res = lm_serve(acfg, params, t, 4)
    arctic_ok = (math.isfinite(float(m["loss"])) and res["finite"]
                 and all(v.dtype == torch.bfloat16 for v in newp.values())
                 and all(v.dtype == torch.bfloat16 for v in st.m.values()))
    if not arctic_ok:
        problems.append("arctic reduced: train step or prefill failed")
    others["arctic-smoke"] = {"train_loss": float(m["loss"]),
                              "train_step_s": wall, "serve": res}
    out["others"] = others
    del params, newp, st, t, lab
    part_done("others")

    # -- (f) block-sparse attention over B2SR block masks -----------------
    nb, bs = BS_SEQ // BS_BLOCK, BS_BLOCK
    rows, cols = blockmask.local_strided_pattern(nb, window=4, stride=8)
    w = int(np.bincount(rows).max())
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    q, k, v = (torch.randn((1, BS_SEQ, cfg.n_heads, cfg.head_dim),
                           generator=gen, device=dev) for _ in range(3))
    ids, bsa = {}, {}
    for td in BS_TILE_DIMS:
        _, ell = blockmask.pattern_to_b2sr(rows, cols, nb, td, device=dev)
        ids[td] = blockmask.block_lists_from_ell(ell, w)
        bsa[td] = sync_time(lambda: blockmask.block_sparse_attention(
            q, k, v, ids[td], bs))
    block = torch.zeros((nb, nb), dtype=torch.bool, device=dev)
    block[torch.as_tensor(rows, device=dev), torch.as_tensor(cols,
                                                             device=dev)] = True
    listed = {tuple(sorted(int(j) for j in r if j >= 0))
              for r in ids[BS_TILE_DIMS[0]].cpu().tolist()}

    def dense_masked():
        el = (block[:, None, :, None].expand(nb, bs, nb, bs)
              .reshape(BS_SEQ, BS_SEQ)
              & torch.tril(torch.ones((BS_SEQ, BS_SEQ), dtype=torch.bool,
                                      device=dev)))
        res = torch.empty_like(q)
        for h in range(cfg.n_heads):
            sc = (q[0, :, h] @ k[0, :, h].T) / math.sqrt(cfg.head_dim)
            res[0, :, h] = torch.softmax(torch.where(el, sc, -1e30),
                                         -1) @ v[0, :, h]
        return res

    want, dense_s = sync_time(dense_masked)
    bs_out = {"seq": BS_SEQ, "block": bs, "n_blocks": nb, "max_blocks": w,
              "heads": cfg.n_heads, "head_dim": cfg.head_dim,
              "dense_s": dense_s,
              "score_blocks_computed_share": nb * w / nb ** 2,
              "score_blocks_listed_share": len(rows) / nb ** 2,
              "of_causal_blocks": len(rows) / (nb * (nb + 1) / 2)}
    if not torch.equal(ids[BS_TILE_DIMS[0]], ids[BS_TILE_DIMS[1]]):
        problems.append("block lists differ between tile dims")
    if len(listed) != nb:
        problems.append("block lists: a row repeated")
    for td, (got, wall) in bsa.items():
        err = float((got - want).abs().max())
        close = bool(torch.allclose(got, want, rtol=BS_TOL, atol=BS_TOL))
        bs_out[f"t{td}"] = {"s": wall, "max_abs_diff": err, "close": close}
        if not close:
            problems.append(f"block_sparse_attention t {td}: {err}")
    out["block_sparse"] = bs_out
    del q, k, v, want, bsa, block
    part_done("block_sparse")

    emit({"phase": "lm", "ok": not problems, "problems": problems[:10],
          "peak_device_bytes": peaks,
          "phase_peak_device_bytes": max(peaks.values()),
          "profile": prof, "phase_s": time.perf_counter() - t_phase,
          "reduced": [
              f"phi4-mini-3.8b prefill_32k at batch 1, not 32 (its KV "
              f"cache: 4.30 GB at batch 1, 137 GB at 32); decode_32k's "
              f"context at batch 1, not 128, {LM_DECODE} steps",
              f"phi4-mini-3.8b training: {LM_TRAIN[0]} of 32 layers, "
              f"train_4k's {LM_TRAIN[2]} tokens at batch {LM_TRAIN[1]}, not "
              f"256; {LM_TRAIN_STEPS} steps on one batch",
              f"qwen3-moe-30b-a3b: {MOE_LAYERS[0]} of 48 layers serving "
              f"({MOE_PREFILL} prompt tokens, {MOE_DECODE} decode steps), "
              f"{MOE_LAYERS[1]} training (one step of {LM_TRAIN[2]} "
              "tokens, AdamW's moments in bfloat16: float32 moments and "
              "the update's new copies of 1.87 B parameters peaked at "
              "64.9 GB), one layer's moe_ffn at float32 on "
              f"{MOE_CHECK_TOKENS} tokens",
              f"gemma-7b and minitron-4b: 2 layers, a {OTHER_PREFILL}-token "
              f"prefill and {OTHER_DECODE} decode steps",
              "arctic-480b at its reduced config (one full-width layer is "
              "13.6 B parameters, 27 GB in bfloat16)",
              "random weights and tokens from seeds"],
          "card": card_line(), **out})
    if problems:
        fail("lm", "; ".join(problems[:5]))


def din_params(cfg, dev, seed: int):
    """DIN's parameters drawn by the port's own seeded initialisation on
    ``dev``, as named tensors."""
    import torch
    from repro_torch import nn as rnn
    from repro_torch.training import train_steps
    model = train_steps._din_model(cfg).to_empty(device=dev)
    rnn.reset_parameters(model, torch.Generator(device=dev).manual_seed(
        SEED + seed))
    return {k: v.detach() for k, v in model.named_parameters()}


def din_flops(cfg) -> int:
    """Forward FLOPs of one sample or candidate, the reference's count
    (``launch/specs.py``): the attention MLP's first two layers over the
    L positions and the final MLP's first two layers."""
    d, (a0, a1), (m0, m1) = cfg.embed_dim, cfg.attn_mlp, cfg.mlp
    attn = 2 * cfg.seq_len * (8 * d * a0 + a0 * a1)
    return attn + 2 * ((cfg.n_user_feats * d + 4 * d) * m0 + m0 * m1)


def din_bytes(params, batch, out_bytes: int, cands=None,
              train: bool = False) -> int:
    """The bytes a call must move, each input read once and each output
    written once: the batch; the table rows its ids reach (the history's
    unmasked positions, the targets or candidates, the user fields),
    each distinct row once; the MLPs' weights; the output. A train step
    reads and writes every parameter and both AdamW moments instead of
    the rows."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in batch) + out_bytes
    if train:
        return nbytes + 6 * sum(v.numel() * v.element_size()
                                for v in params.values())
    items = [batch.hist_items[batch.hist_mask], batch.target_item]
    cates = [batch.hist_cates[batch.hist_mask], batch.target_cate]
    if cands is not None:
        nbytes += sum(c.numel() * c.element_size() for c in cands)
        items, cates = [items[0], cands[0]], [cates[0], cands[1]]
    for name, ids in (("item_table", items), ("cate_table", cates),
                      ("user_table", [batch.user_feats.reshape(-1)])):
        t = params[name]
        rows = torch.unique(torch.cat(ids)).numel()
        nbytes += rows * t.shape[1] * t.element_size()
    return nbytes + sum(v.numel() * v.element_size()
                        for k, v in params.items() if "mlp" in k)


def exact_psum(grads):
    """The float32 psum of each named tensor over the slots: copies to
    the first slot, the sum there, copies back to each slot."""
    out = [{} for _ in grads]
    for k in grads[0]:
        total = grads[0][k]
        for g in grads[1:]:
            total = total + g[k].to(total.device)
        for i, g in enumerate(grads):
            out[i][k] = total.to(g[k].device)
    return out


def phase_din():
    """The recsys family at DIN's published widths (see the module doc,
    phase 24)."""
    import gc

    import torch
    from repro_torch.configs import din as din_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.data import synthetic
    from repro_torch.launch import train as launch_train
    from repro_torch.models.recsys.din import DINBatch
    from repro_torch.training import compression
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, torch.cuda.current_device())
    problems, out, prof = [], {}, {}
    out["start_allocated_bytes"] = torch.cuda.memory_allocated()
    out["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    if out["tf32"]:
        problems.append("float32 matmuls run as TF32")
    cfg = din_config.CONFIG
    params = din_params(cfg, dev, 40)
    p64 = {k: v.double() for k, v in params.items()}
    out["params"] = sum(v.numel() for v in params.values())
    out["param_bytes"] = sum(v.numel() * v.element_size()
                             for v in params.values())
    fwd = din_flops(cfg)
    feat_bytes = cfg.seq_len * 8 * cfg.embed_dim * 4     # a sample's
    serve = train_steps.din_serve_step(cfg)
    retrieve = train_steps.din_retrieval_step(cfg)
    loss_fn = train_steps.din_loss_fn(cfg)

    def of_max(got, want) -> float:
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    # -- (a) checks at CONFIG's widths ----------------------------------
    checks = {}
    b = synthetic.din_batch(cfg, DIN_SIZES["serve_p99"], seed=SEED + 41,
                            device=dev)
    got, want = serve(params, b), serve(p64, b)
    checks["forward_vs_f64_of_max"] = of_max(got, want)
    checks["max_abs_logit"] = float(want.abs().max())
    if not checks["forward_vs_f64_of_max"] <= DIN_TOL:
        problems.append(f"forward {checks['forward_vs_f64_of_max']} of max "
                        "|logit| from float64")
    user = synthetic.din_batch(cfg, 1, seed=SEED + 42, device=dev)
    rng = np.random.default_rng(SEED + 43)

    def cand_ids(n):
        return (torch.from_numpy(rng.integers(0, cfg.n_items, n,
                                              dtype=np.int32)).to(dev),
                torch.from_numpy(rng.integers(0, cfg.n_cates, n,
                                              dtype=np.int32)).to(dev))

    ci, cc = cand_ids(DIN_CANDS)
    scores = retrieve(params, user, ci, cc)[0]
    n = DIN_CANDS
    each = DINBatch(user.hist_items.expand(n, -1), user.hist_cates.expand(
        n, -1), user.hist_mask.expand(n, -1), ci, cc,
        user.user_feats.expand(n, -1), torch.zeros(n, device=dev))
    want = serve(params, each)
    checks["candidates"] = n
    checks["candidate_blocks"] = -(-n // DIN_CHUNK)
    checks["scores_vs_forward_of_max"] = of_max(scores, want)
    if scores.shape != (n,) or not checks["scores_vs_forward_of_max"] \
            <= DIN_TOL:
        problems.append(f"score_candidates {checks['scores_vs_forward_of_max']}"
                        " of max |score| from the forward")
    b = synthetic.din_batch(cfg, DIN_GRAD_BATCH, seed=SEED + 44, device=dev)
    (loss, _), grads = train_steps.value_and_grad(loss_fn, params, b)
    (loss64, _), grads64 = train_steps.value_and_grad(loss_fn, p64, b)
    checks["loss"], checks["loss_f64"] = float(loss), float(loss64)
    checks["grads_vs_f64_of_max"] = {
        k: of_max(grads[k], grads64[k]) for k in grads}
    worst = max(checks["grads_vs_f64_of_max"].values())
    if not abs(float(loss) - float(loss64)) <= DIN_TOL * abs(float(loss64)) \
            or not worst <= DIN_GRAD_TOL:
        problems.append(f"loss/gradients from float64: {worst} of max |g|")
    out["checks"] = checks
    del p64, got, want, each, grads, grads64, b

    # -- (b) the four shapes ----------------------------------------------
    shapes = {}

    def bound(flops, nbytes):
        f_ms, b_ms = 1e3 * flops / LANE_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
        return {"flops": flops, "bytes": nbytes, "bound_ms": max(f_ms, b_ms),
                "bound_by": "operations" if f_ms >= b_ms else "bytes"}

    def shape_done(name, row):
        row["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        shapes[name] = row
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    B = DIN_SIZES["train_batch"]
    ocfg = opt_mod.OptimizerConfig(name="adamw", lr=DIN_LR, warmup_steps=0)
    step = train_steps.din_train_step(cfg, ocfg)
    b = synthetic.din_batch(cfg, B, seed=SEED + 45, device=dev)
    p, st = params, opt_mod.init(ocfg, params)
    losses, walls = [], []
    for _ in range(DIN_TRAIN_STEPS):
        (p, st, m), wall = sync_time(lambda: step(p, st, b))
        losses.append(float(m["loss"]))
        walls.append(wall)
    med = statistics.median(walls[1:])
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        problems.append(f"train_batch losses {losses}")
    row = {"batch": B, "losses": losses, "step_s": walls,
           "median_step_s": med, "samples_per_s": B / med,
           "attention_feature_bytes": B * feat_bytes,
           **bound(3 * B * fwd, din_bytes(params, b, 4, train=True))}
    row["of_bound"] = row["bound_ms"] / (1e3 * med)
    prof["train_step"] = profiled(lambda: step(p, st, b))
    del p, st, m, b
    shape_done("train_batch", row)

    B = DIN_SIZES["serve_p99"]
    b = synthetic.din_batch(cfg, B, seed=SEED + 46, device=dev)
    for _ in range(3):
        serve(params, b)
    walls = [sync_time(lambda: serve(params, b))[1]
             for _ in range(DIN_P99_CALLS)]
    logits = serve(params, b)
    if logits.shape != (B,) or not bool(torch.isfinite(logits).all()):
        problems.append("serve_p99 logits")
    row = {"batch": B, "calls": len(walls),
           "p50_ms": 1e3 * float(np.percentile(walls, 50)),
           "p99_ms": 1e3 * float(np.percentile(walls, 99)),
           "samples_per_s": B / statistics.median(walls),
           "attention_feature_bytes": B * feat_bytes,
           **bound(B * fwd, din_bytes(params, b, 4 * B))}
    row["of_bound_p50"] = row["bound_ms"] / row["p50_ms"]
    prof["serve_p99"] = profiled(lambda: serve(params, b))
    del b, logits
    shape_done("serve_p99", row)

    B = DIN_SIZES["serve_bulk"]
    b = synthetic.din_batch(cfg, B, seed=SEED + 47, device=dev)
    serve(params, b)
    logits, wall = sync_time(lambda: serve(params, b))
    if logits.shape != (B,) or not bool(torch.isfinite(logits).all()):
        problems.append("serve_bulk logits")
    row = {"batch": B, "s": wall, "samples_per_s": B / wall,
           "attention_feature_bytes": B * feat_bytes,
           **bound(B * fwd, din_bytes(params, b, 4 * B))}
    row["of_bound"] = row["bound_ms"] / (1e3 * wall)
    del b, logits
    shape_done("serve_bulk", row)

    N = DIN_SIZES["retrieval_cand"]
    user = synthetic.din_batch(cfg, 1, seed=SEED + 48, device=dev)
    ci, cc = cand_ids(N)
    retrieve(params, user, ci, cc)
    scores, wall = sync_time(lambda: retrieve(params, user, ci, cc))
    if scores.shape != (1, N) or not bool(torch.isfinite(scores).all()):
        problems.append("retrieval_cand scores")
    row = {"users": 1, "candidates": N, "chunk": DIN_CHUNK, "s": wall,
           "candidates_per_s": N / wall,
           "attention_feature_bytes_a_block": DIN_CHUNK * feat_bytes,
           **bound(N * fwd, din_bytes(params, user, 4 * N, cands=(ci, cc)))}
    row["of_bound"] = row["bound_ms"] / (1e3 * wall)
    del scores, ci, cc
    shape_done("retrieval_cand", row)
    out["shapes"] = shapes

    # -- (c) the launcher ---------------------------------------------------
    launch, wall = sync_time(lambda: launch_train.main(
        ["--arch", "din", "--full-config", "--batch", str(DIN_GRAD_BATCH),
         "--steps", "2"]))
    out["launcher"] = {"losses": launch["losses"], "s": wall}
    if len(launch["losses"]) != 2 or not all(map(math.isfinite,
                                                  launch["losses"])):
        problems.append(f"launcher losses {launch['losses']}")
    del launch
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the compressed psum over 4 slots of the card -----------------
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((DIN_SLOTS,), ("dp",), [dev] * DIN_SLOTS)
    slots = list(mesh.devices.flat)
    grads = []
    for i, d in enumerate(slots):
        b = synthetic.din_batch(cfg, DIN_GRAD_BATCH, seed=SEED + 50 + i,
                                device=d)
        grads.append(train_steps.value_and_grad(
            loss_fn, {k: v.to(d) for k, v in params.items()}, b)[1])
    zeros = [{k: torch.zeros_like(v) for k, v in g.items()} for g in grads]
    compression.compressed_psum_tree(grads, zeros)
    (sums, errs), psum_s = sync_time(
        lambda: compression.compressed_psum_tree(grads, zeros))
    exact, exact_s = sync_time(lambda: exact_psum(grads))
    cpu_g = [{k: v.cpu() for k, v in g.items()} for g in grads]
    cpu_sums, cpu_errs = compression.compressed_psum_tree(
        cpu_g, [{k: torch.zeros_like(v) for k, v in g.items()}
                for g in cpu_g])
    same = all(same_bits(a[k].cpu(), c[k]) for got_, want_ in
               ((sums, cpu_sums), (errs, cpu_errs))
               for a, c in zip(got_, want_) for k in c)
    exact64 = {k: sum(g[k].double() for g in grads) for k in grads[0]}
    one_shot = {k: of_max(sums[0][k], exact64[k]) for k in exact64}
    if not same:
        problems.append("compressed psum on the card != the CPU's")
    if not max(one_shot.values()) < DIN_PSUM_TOL:
        problems.append(f"compressed psum one-shot error {one_shot}")
    # the same gradients each step: the error of each step's sum, and of
    # the mean of the sums so far (error feedback keeps its bias down)
    feedback, feedback_mean, e, acc = [], [], zeros, None
    for t in range(1, DIN_PSUM_STEPS + 1):
        s, e = compression.compressed_psum_tree(grads, e)
        acc = ({k: v.double() for k, v in s[0].items()} if acc is None
               else {k: acc[k] + s[0][k] for k in acc})
        feedback.append(max(of_max(s[0][k], exact64[k]) for k in exact64))
        feedback_mean.append(max(of_max(acc[k] / t, exact64[k])
                                 for k in exact64))
    topk = {}
    for k in grads[0]:
        (kept, rest), wall = sync_time(
            lambda: compression.topk_compress(grads[0][k], DIN_TOPK))
        ck, cr = compression.topk_compress(cpu_g[0][k], DIN_TOPK)
        topk[k] = {"k": int(max(1, int(kept.numel() * DIN_TOPK))), "s": wall,
                   "same_as_cpu": same_bits(kept.cpu(), ck)
                   and same_bits(rest.cpu(), cr)}
        if not topk[k]["same_as_cpu"]:
            problems.append(f"topk_compress {k} != the CPU's")
    out["psum"] = {
        "slots": [str(d) for d in slots],
        "floats_a_slot": sum(v.numel() for v in grads[0].values()),
        "bitwise_as_cpu": same, "one_shot_of_max": one_shot,
        "feedback_of_max": feedback, "feedback_mean_of_max": feedback_mean,
        "compressed_s": psum_s,
        "exact_copies_s": exact_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "topk": topk}
    del grads, zeros, sums, errs, exact, cpu_g, cpu_sums, cpu_errs, e, s, acc

    emit({"phase": "din", "ok": not problems, "problems": problems[:10],
          "flops_a_sample": fwd, "profile": prof,
          "phase_s": time.perf_counter() - t_phase,
          "reduced": [], "card": card_line(), **out})
    if problems:
        fail("din", "; ".join(problems[:5]))


def spmd_dryrun(out_dir: str):
    """The production dry run of ``SPMD_DRYRUN`` on both meshes in
    ``SPMD_DRYRUN_PROCS`` host processes (kept off the card), one a cell
    and mesh; returns the pool and its futures, each ``(arch, shape,
    mesh, returncode, passed, output tail, seconds)``."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}

    def run(job):
        arch, shape, mesh = job
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out",
                 out_dir], capture_output=True, text=True, env=env,
                timeout=SPMD_DRYRUN_TIMEOUT)
            code = r.returncode
            passed = "ALL DRY-RUN CELLS PASSED" in r.stdout
            tail = (r.stdout if passed else r.stdout + r.stderr)[-600:]
        except subprocess.TimeoutExpired:
            code, passed, tail = None, False, "timed out"
        return arch, shape, mesh, code, passed, tail, time.perf_counter() - t0

    pool = ThreadPoolExecutor(SPMD_DRYRUN_PROCS)
    return pool, [pool.submit(run, (a, s, m)) for a, s in SPMD_DRYRUN
                  for m in ("multi", "single")]


def share_off(got, want, lr: float) -> float:
    """The largest share, over two dicts of updated parameters (``got``'s
    may be DTensors), of a parameter's elements off by over 1% of lr."""
    from repro_torch.sharding import spmd
    return max(float(((spmd.full(got[k]).float() - w.float()).abs()
                      > 1e-2 * lr).float().mean()) for k, w in want.items())


def phase_spmd():
    """The SPMD layer on the card and the production dry run on the host
    (see the module doc, phase 25)."""
    import gc
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import phi4_mini_3_8b, qwen3_moe_30b_a3b
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding import rules, spmd
    from repro_torch.training import checkpoint
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_steps

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    problems, out = [], {}
    tmp = tempfile.TemporaryDirectory()
    pool, jobs = spmd_dryrun(tmp.name)
    torch.cuda.reset_peak_memory_stats()
    out["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    if out["tf32"]:
        problems.append("float32 matmuls run as TF32")

    def rel(a, b) -> float:
        return abs(float(a) / float(b) - 1)

    def apart(got, want) -> dict:
        """Over two dicts of tensors, the largest per-tensor ‖Δ‖/‖want‖
        (``norm``) and max |Δ| / max |want| (``of_max``), each with its
        tensor's name."""
        norm, elem = (0.0, ""), (0.0, "")
        for k, w in want.items():
            d = spmd.full(got[k]).double() - w.double()
            norm = max(norm, (float(d.norm() / max(float(w.double().norm()),
                                                   1e-30)), k))
            elem = max(elem, (float(d.abs().max() / max(
                float(w.double().abs().max()), 1e-30)), k))
        return {"norm": norm[0], "norm_at": norm[1], "of_max": elem[0],
                "of_max_at": elem[1]}

    with mesh_mod.real_world(DEVICE) as dev:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        bt = (("data",), None)
        # -- phi4: one AdamW step, sharded against plain ---------------------
        layers, batch, seq = SPMD_PHI4
        cfg = dataclasses.replace(phi4_mini_3_8b.CONFIG, n_layers=layers,
                                  batch_axes=("data",), tp_width=1)
        params = lm_params(cfg, dev, 60)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        tok = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device=dev, dtype=torch.int32)
        lab = torch.roll(tok, -1, 1)
        ocfg = opt_mod.OptimizerConfig(lr=SPMD_LR, warmup_steps=0)
        lr = float(opt_mod.lr_at(ocfg, 1))
        step = train_steps.lm_train_step(cfg, ocfg)
        (p_plain, s_plain, m_plain), plain_s = sync_time(
            lambda: step(params, opt_mod.init(ocfg, params), tok, lab))
        s_plain = s_plain._replace(v=None)    # only m is compared
        # the plain step again (the card's own run-to-run spread), and a
        # control with a wrong gradient (other labels) for the share bound
        s_again = step(params, opt_mod.init(ocfg, params), tok, lab)[1]
        repeat = apart(s_again.m, s_plain.m)
        del s_again
        p_ctrl = step(params, opt_mod.init(ocfg, params), tok,
                      lab.roll(1, 1))[0]
        control = share_off(p_ctrl, p_plain, lr)
        del p_ctrl
        specs = rules.lm_param_specs(cfg, params)
        state = opt_mod.init(ocfg, params)
        dp = spmd.place_tree(params, mesh, specs)
        dst = spmd.place_tree(state, mesh, rules.opt_state_specs(specs,
                                                                 state))
        dtok, dlab = spmd.place(tok, mesh, bt), spmd.place(lab, mesh, bt)
        del state
        first_s = sync_time(lambda: step(dp, dst, dtok, dlab))[1]
        (p_sh, s_sh, m_sh), sharded_s = sync_time(
            lambda: step(dp, dst, dtok, dlab))
        s_sh = s_sh._replace(v=None)
        phi = {"layers": layers, "batch": batch, "tokens_a_row": seq,
               "dtype": cfg.dtype, "attn_probs_bf16": cfg.attn_probs_bf16,
               "n_params": sum(v.numel() for v in params.values()),
               "loss": float(spmd.full(m_sh["loss"])),
               "loss_plain": float(m_plain["loss"]),
               "loss_rel": rel(spmd.full(m_sh["loss"]), m_plain["loss"]),
               "grad_norm_rel": rel(spmd.full(m_sh["grad_norm"]),
                                    m_plain["grad_norm"]),
               "m_apart": apart(s_sh.m, s_plain.m),
               "m_apart_plain_repeat": repeat,
               "params_share_off": share_off(p_sh, p_plain, lr),
               "params_share_off_wrong_grad": control,
               "step_s": {"plain": plain_s, "sharded_first": first_s,
                          "sharded": sharded_s},
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        out["phi4"] = phi
        if not (phi["loss_rel"] <= SPMD_LOSS_RTOL
                and phi["grad_norm_rel"] <= SPMD_LOSS_RTOL
                and phi["m_apart"]["of_max"] <= SPMD_GRAD_TOL
                and phi["params_share_off"] <= SPMD_SHARE < control):
            problems.append(f"phi4 sharded step != plain: {phi}")

        # -- a sharded restore of layer 0 onto the mesh, bit for bit ----------
        tree = {k: v for k, v in params.items() if k.startswith("layers.0.")}
        with tempfile.TemporaryDirectory() as d:
            (_, save_s) = sync_time(lambda: checkpoint.save(d, 1, tree))
            (restored, _), restore_s = sync_time(lambda: checkpoint.restore(
                d, 1, tree, device=dev,
                shardings=rules.tree_shardings(mesh, {k: specs[k]
                                                      for k in tree})))
        same = all(spmd.is_dtensor(restored[k])
                   and same_bits(restored[k].full_tensor(), v)
                   for k, v in tree.items())
        out["restore"] = {"arrays": len(tree),
                          "bytes": sum(v.numel() * 4 for v in tree.values()),
                          "bitwise": same, "save_s": save_s,
                          "restore_s": restore_s}
        if not same:
            problems.append("the sharded restore is not bit for bit")
        del params, p_plain, s_plain, p_sh, s_sh, dp, dst, restored, tree
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # -- qwen3: the MoE through moe_ffn_shardmap, against the dense one ---
        layers, batch, seq = SPMD_MOE
        base = qwen3_moe_30b_a3b.CONFIG
        # float32: the dispatch's index_add sums with atomics, so in
        # bfloat16 even one path run twice parts by its roundings
        qcfg = dataclasses.replace(
            base, n_layers=layers, batch_axes=("data",), tp_width=1,
            dtype="float32",
            moe=dataclasses.replace(base.moe, capacity_factor=(
                base.moe.n_experts / base.moe.top_k)))
        qp = lm_params(qcfg, dev, 61)
        qtok = torch.randint(0, qcfg.vocab_size, (batch, seq), generator=gen,
                             device=dev, dtype=torch.int32)
        qlab = torch.roll(qtok, -1, 1)
        loss_fn = train_steps.lm_loss_fn(qcfg)
        ((l_plain, _), g_plain), qplain_s = sync_time(
            lambda: train_steps.value_and_grad(loss_fn, qp, qtok, qlab))
        calls = [0]
        ep = moe_mod.moe_ffn_shardmap

        def counted_ep(*a, **kw):
            calls[0] += 1
            return ep(*a, **kw)

        moe_mod.moe_ffn_shardmap = counted_ep
        try:
            qspecs = rules.lm_param_specs(qcfg, qp)
            dqp = spmd.place_tree(qp, mesh, qspecs)
            ((l_sh, _), g_sh), qsh_s = sync_time(
                lambda: train_steps.value_and_grad(
                    loss_fn, dqp, spmd.place(qtok, mesh, bt),
                    spmd.place(qlab, mesh, bt)))
        finally:
            moe_mod.moe_ffn_shardmap = ep
        moe = {"layers": layers, "tokens": batch * seq,
               "capacity_factor": qcfg.moe.capacity_factor,
               "capacity": moe_mod.capacity(batch * seq, qcfg.moe),
               "ep_calls": calls[0],
               "loss": float(spmd.full(l_sh)), "loss_plain": float(l_plain),
               "loss_rel": rel(spmd.full(l_sh), l_plain),
               "grads_apart": apart(g_sh, g_plain),
               "loss_and_grads_s": {"plain": qplain_s, "sharded": qsh_s},
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        out["qwen3_moe"] = moe
        if calls[0] < layers:
            problems.append(f"moe_ffn_shardmap ran {calls[0]} times, "
                            f"not once a layer ({layers})")
        if not (moe["loss_rel"] <= SPMD_LOSS_RTOL
                and moe["grads_apart"]["of_max"] <= SPMD_GRAD_TOL):
            problems.append(f"qwen3 EP loss/grads != dense: {moe}")
        del qp, dqp, g_plain, g_sh
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the production dry run, run meanwhile on the host ---------------
    t_wait = time.perf_counter()
    cells = []
    for job in jobs:
        arch, shape, which, code, passed, tail, secs = job.result()
        if code != 0 or not passed:
            problems.append(f"dry run {arch} x {shape} ({which}): exit "
                            f"{code}: {tail[-300:]}")
        mesh_name = {"single": "16x16", "multi": "2x16x16"}[which]
        path = Path(tmp.name) / f"{arch}__{shape}__{mesh_name}.json"
        if path.exists():
            rec = json.loads(path.read_text())
            line = {"phase": "spmd_dryrun", "arch": arch, "shape": shape,
                    "mesh": mesh_name, "process_s": secs,
                    **{k: rec[k] for k in (
                        "kind", "n_chips", "seconds", "layers_counted",
                        "memory", "flops_per_device", "bytes_per_device",
                        "ops_per_device", "collectives", "meta")}}
            emit(line)
            cells.append(line)
    pool.shutdown()
    tmp.cleanup()
    if len(cells) != 2 * len(SPMD_DRYRUN):
        problems.append(f"dry run: {len(cells)} of "
                        f"{2 * len(SPMD_DRYRUN)} cells recorded")
    out["dryrun"] = {"cells": len(cells), "wait_after_card_s":
                     time.perf_counter() - t_wait,
                     "left_out": {"prefill_32k": "minutes a cell on the "
                                  "host (64 q blocks a layer), beyond the "
                                  "phase's budget",
                                  "long_500k": "a skipped cell "
                                  "(SKIPPED_CELLS)"}}
    emit({"phase": "spmd", "ok": not problems, "problems": problems[:10],
          "one_rank": "NCCL takes no two ranks on one card: the multi-rank "
                      "values are held by tests/test_torch_spmd.py on 8 "
                      "gloo ranks on the CPU",
          "phase_s": time.perf_counter() - t_phase,
          "reduced": [f"phi4 {SPMD_PHI4[0]} of 32 layers",
                      f"qwen3 {SPMD_MOE[0]} of 48 layers",
                      "dry run without prefill_32k"],
          "card": card_line(), **out})
    if problems:
        fail("spmd", "; ".join(problems[:5]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=SCALE,
                        help="R-MAT scale (n = 2**scale); default 21")
    scale = parser.parse_args().scale
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a GPU and has no CPU mode", file=sys.stderr)
        return 1
    import scipy.sparse as sp
    from repro_torch.core.graphblas import GraphMatrix
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    sources = sorted({ROOT / src for _, src in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(common.load_library, sources))
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "ptxas": {src.stem: [ln for ln in common.BUILD_LOG.get(
              src.stem, "").splitlines() if "registers" in ln
              or "spill" in ln] for src in sources}})

    rng = np.random.default_rng(SEED)
    n = 1 << scale
    t0 = time.perf_counter()
    rows, cols = rmat_graph(n, avg_degree=2 * EDGEFACTOR, seed=SEED)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    g, build_s = sync_time(lambda: GraphMatrix.from_coo(
        rows, cols, n, n, TILE_DIM, backend="b2sr_cuda", device=DEVICE))
    ptr = g.b2sr.tile_row_ptr
    emit({"phase": "graph", "ok": True, "scale": scale, "n": n,
          "directed_edges": len(rows), "n_tiles": g.b2sr.n_tiles,
          "max_tiles_per_row": int((ptr[1:] - ptr[:-1]).max()),
          "generate_s": gen_s,
          "from_coo_s": build_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})

    max_err = phase_kernels(g, rng)

    adj = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    deg = np.bincount(rows, minlength=n)
    sources = [int(s) for s in np.random.default_rng(SEED + 1).choice(
        np.flatnonzero(deg), N_SOURCES, replace=False)]
    want = scipy_levels(adj, sources)
    first, launches = phase_bfs(g, deg, sources, want)
    bff_launches = 0
    _, ls = phase_sssp(g, sources, want)
    bff_launches += ls["bmv_bff"]
    _, ls = phase_pagerank(g, adj, sources[0])
    bff_launches += ls["bmv_bff"]
    _, ls = phase_cc(g, adj)
    bff_launches += ls["bmv_bff"]
    ls = phase_mxv(g, first.levels, first.n_iterations, rng)
    launches.update(bmv_bff=bff_launches + ls["bmv_bff"],
                    bmv_bbf=ls["bmv_bbf"])

    tc_row = phase_tc(g)
    spgemm_row = phase_spgemm()
    road, khop_launches, hop_err, hop_row = phase_khop()
    spgemm_row["launches"] += khop_launches["spgemm_bbb"]
    spgemm_row.update({f"road_hop_{k}": hop_row[k]
                       for k in ("ms", "plain_ms", "bound_ms", "bound_by")})

    srcs = engine_sources(deg, sources)
    ms_auto, ls = phase_msbfs(g, srcs, want)
    bbb_launches = ls["spmm_bbb"]
    bbb_launches += phase_mskhop(g, srcs)["spmm_bbb"]
    bbb_launches += phase_ms_sssp(g, srcs)["spmm_bbb"]
    ppr_res, ls = phase_batched_ppr(g, adj, srcs[:PPR_SEEDS])
    dense_launches = ls["spmm_dense"]
    ls = phase_batcher(g, srcs, ms_auto.levels, ppr_res.ranks)
    bbb_launches += ls["spmm_bbb"]
    dense_launches += ls["spmm_dense"]
    del ppr_res
    spmm_rows = spmm_timing(g, ms_auto.levels, ms_auto.n_iterations,
                            srcs[:PPR_SEEDS])
    pack_rows_ = phase_bitpack(g)
    gnn_rows, ls, gnn_runs, features = phase_gnn(g, adj, deg, srcs)
    dense_launches += ls["spmm_dense"]
    serve_ls = phase_serve(g, sources, want)
    bbb_launches += serve_ls["spmm_bbb"]
    dense_launches += serve_ls["spmm_dense"]
    for k in ("spmm_bbf", "pack_rows"):
        ls[k] += serve_ls[k]
    train_row, train_launches, train_runs = phase_train(g, adj, deg,
                                                        features)
    dense_launches += train_launches
    shard_ls = phase_shard(g, deg, sources, srcs, features)
    bbb_launches += shard_ls["spmm_bbb"]
    dense_launches += shard_ls["spmm_dense"]
    for k in ("spmm_bbf", "pack_rows"):
        ls[k] += shard_ls[k]
    for k in ("bmv_bbb_push", "bmv_bbb_pull", "bmv_bff", "bmv_bbf"):
        launches[k] += shard_ls[k]
    tc_row["launches"] += shard_ls["bmm_tc"]
    spgemm_row["launches"] += shard_ls["spgemm_bbb"]
    for row, n_launches in zip(spmm_rows, (bbb_launches, dense_launches)):
        row["launches"] = n_launches
    spmm_rows[1].update(train_backward=train_row,
                        max_abs_err=train_row["max_abs_err"])
    for row in gnn_rows:
        row["launches"] = ls[row["name"]]

    table, csr_ms = phase_timing(g, first, sources, launches,
                                 (rows, cols))
    for row in table:
        row["csr_row_ms"] = csr_ms
    table += [tc_row, spgemm_row, *spmm_rows, *gnn_rows, *pack_rows_]
    for row in table:
        src = KERNELS[row["name"]]
        row.update(route="cuda", replaces=src[0], source=src[1],
                   max_abs_err=max(row.get("max_abs_err", 0),
                                   max_err[row["name"]]))
    spgemm_row["max_abs_err"] = max(spgemm_row["max_abs_err"], hop_err)
    order = list(KERNELS)
    table.sort(key=lambda r: order.index(r["name"]))
    phase_profile(g, sources[0], road, srcs, {**gnn_runs, **train_runs})
    del gnn_runs, train_runs, features
    fam_launches = phase_families(g, adj)
    spmm_rows[1]["launches"] += fam_launches
    spmm_rows[1]["families_launches"] = fam_launches
    # the graphs, the plans over them and the gnn phase's served models
    # (12 GB of gcn-cora features) end with the last graph phase
    from repro_torch.engine import DEFAULT_PLANNER, queries
    DEFAULT_PLANNER.clear()
    queries._GNN_MODELS.clear()
    del g, adj, road, first, ms_auto
    phase_lm()
    phase_din()
    phase_spmd()

    print(card_line(), flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
