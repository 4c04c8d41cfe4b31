#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``pytorch_geometric_tpu_torch``).

Drives the port's serving and full-batch training paths on one CUDA card and
checks them:

  1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build: every CUDA kernel of the paths, from the sources in this checkout
     (one ``nvcc`` per source, all started together), with the register and
     spill report, and the count of ``HGMMA`` (``wgmma``) instructions in the
     block-sparse library's SASS (``cuobjdump -sass``);
  3. each kernel against its plain PyTorch version on the card: the
     segment-sum kernel forward over narrow, unaligned, weighted, unweighted,
     bipartite and empty-row cases and the serving shapes, and on the
     bipartite cases every plan branch (load width, lanes, lane groups,
     staged or direct) with and without a base, two launches and both modes
     bitwise equal; the block-sparse
     (BSR) kernel over F in {1, 10, 16, 64, 128}, a rectangular graph whose
     sizes are not multiples of 128, empty block rows, both layouts, and
     path A's shapes; the segment-sum kernel's backward (``grad_x`` from its
     autograd Function against the plain version's autograd) at the serving,
     path-A residual and path-B shapes;
  4. GCN serving at the headline configuration (the ``sparse-f32`` arm of
     ``benchmarks/inference_bench.py``: 30,000 nodes, 1,000,000 random edges
     plus 30,000 self loops with host-side GCN normalisation, width 128,
     3 layers, 16 outputs, float32, random weights from ``--seed``): timed
     forwards, a ``torch.profiler`` breakdown of where the device time goes,
     launch counts, and the output held against the same weights run
     through the plain path on the CPU;
  5. GraphSAGE and GIN: one forward each on the same graph, same checks;
  6. segment-sum kernel timings at the serving shapes (kernel, plain
     version, a library call as a yardstick only, and the bound from the
     bytes the work must move; the launch plan, the share of the bound and
     the rate of the gathered x rows): device time from ``torch.profiler``,
     and CUDA-event wall time beside it; the lane-group and mode sweep at F
     = 16;
  7. path A, GCN training over the block-sparse cache: the repo's BSR
     configuration (``benchmarks/spmm_bench.py --clustered 2400 --nodes
     250000 --edges 5000000 --bsr``, seed ``--seed``) cached through
     ``cache_gcn_norm(block_sparse=True)``, ``bench.py``'s model (GCN 64 ->
     64 -> 64 -> 10, softmax cross-entropy, Adam 1e-2); the build's time and
     size, ms per step, launches per step, a ``torch.profiler`` breakdown,
     kernel 2's share of it (pre-pass included) and idle share, and 3 steps
     held against the CPU plain path from the same weights (losses each
     step, the first step's gradients); the profile's add launches, of
     which none may add two same-shape tensors (the residual lands on the
     block product inside the segment-sum kernel);
  8. path B, ``bench.py``'s protocol (10,000 nodes, 200,000 random edges,
     F = 64, hidden 64, 3 layers, 10 classes, Adam 1e-2, 500 steps) for GCN,
     GraphSAGE and GIN through the segment-sum kernel forward and backward:
     seconds per 500 steps, ms per step, launches per step, a profile, and
     the first 3 losses against the CPU plain path;
  9. training-kernel timings: the BSR kernel at F = 64 and 10 on both
     layouts (``torch.sparse.mm`` on a BSR tensor of the same blocks as the
     yardstick), with its pre-pass's share, the rate of the bytes it must
     move and the HGMMA count; the segment-sum kernel at path B's shapes
     (forward and ``A^T g``) and at path A's residual with a base (forward
     and backward; yardstick ``torch.addmm``), and its sweep at path B's
     forward shapes and the residual;
 10. the attention kernels against their plain versions: the multi-head
     GAT mix kernel over H in {1, 4, 8} and F in {1, 10, 16, 64} (p_s !=
     p_u, v absent, empty rows, padded slots) and its backward pass, and
     the segment-max kernel (``-inf`` entries, masked edges, empty rows),
     which must be bitwise equal; both also at path C's shapes;
 11. path C, GAT serving: the attention bench's graph
     (``benchmarks/attention_bench.py:45-47``: 100,000 nodes, 2,000,000
     random edges from ``--seed``) plus one self loop per node added on the
     host by ``add_remaining_self_loops`` (``examples/gat_fused.py:45``),
     ``fill_cache(blocked=True)``, ``GAT(64, 256, 3, 10, heads=4,
     add_self_loops=False)``, f32, nothing cut: ms per forward, launches
     per forward, a profile (a whole window, in which the mix kernel's 6
     launches per forward are checked) and idle share, the output held
     against the CPU plain path with the same weights;
 12. path D, GAT training on the same cell (cross-entropy, Adam 1e-2): ms
     per step, launches per step, a profile (a whole window, 9 mix
     launches and 3 launches of the per-edge dot kernel, ``grad_p_u``, per
     step checked), and 3 steps held against the CPU plain path on path
     C's generator at 0.1 scale (``PD_SMALL``, the cap scaled with it);
 13. attention-kernel timings at path C's shapes: the mix at H*F = 256 and
     40, the stabiliser pass, the backward pass at 256 (yardstick: H
     ``torch.sparse.mm`` CSR calls, or ``torch.segment_reduce`` for the
     stabiliser), and the segment max at [2.1M, 4] (yardstick
     ``torch.segment_reduce(..., 'max')``); the mix kernel's slice-width
     sweep (W in {256, 128, 64, 32}) at H*F = 256, forward, backward and
     bf16, each width's output bitwise equal to one slice's; the segment
     max at every lanes-per-row width, each output bitwise equal;
 14. the precision ladder's kernels against their plain versions on the
     card: the segment-sum kernel's bf16 arm (forward and ``grad_x``;
     narrow, unaligned, weighted and unweighted, empty rows, the serving
     shapes), the BSR kernel's tensor-core bf16 arm (F in {1, 10, 16, 64,
     128}, the rectangular graph, both layouts, path E's layouts) and the
     mix kernel's bf16 arm (path C's shapes too);
 15. path E, GCN training over bf16 blocks: path A's graph cached through
     ``cache_gcn_norm(block_sparse=True, cache_dtype=torch.bfloat16)``
     (``spmm_bench.py --bsr --bf16``), 20 steps after 2, 5 bf16 block
     launches per step, 3 steps against the CPU plain path over the same
     cache;
 16. path F, ``bench.py``'s accelerator regime (``bench.py:80-90``): path
     B's graphs and models over ``fill_cache(dense_weight=w,
     cache_dtype=torch.bfloat16)``, 500 steps each, no kernel launched;
 17. path G, the dense serving ladder of ``inference_bench.py:67-78``: the
     f32, bf16 and int8 dense caches of the serving graph (cap lifted as at
     ``:55``), ms per forward and edges/s, each against the reference its
     bench holds it to;
 18. path H, bf16-feature serving (``products_bench.py:77-82``'s bf16
     input): GraphSAGE and GIN forwards on the serving graph from bf16
     features, one bf16 segment-sum launch per forward;
 19. timings of the bf16 kernels at their paths' shapes, and the
     segment-sum bf16 arm's sweep at path H's layer 1;
 20. ``benchmarks/products_bench.py --train``'s sampled training through
     the port's loaders (2,449,029 x 100 features and 47 labels on the card;
     ``NeighborLoader`` on the native sampler, which must have built: batch
     512, fan-outs [15, 10], 4 sampling threads; ``PrefetchLoader``,
     ``stack_batches``; GraphSAGE 100 -> 64 -> 47, K = 8) on the kernel
     route: each batch's ``EdgeIndex`` built on the card, kernel 1 three
     times a step; one ``scan_fn`` replay and 8 ``step_fn`` replays bitwise
     equal to 8 eager steps from one state; ms per step of each, and of the
     gather route on the same batches; 56 steps end to end, host sampling
     included, without and with the prefetch overlap (pinned buffers and a
     copy stream), three loops each in turns, with the card's idle share;
     then one pass of layer-wise serving (``basic_gnn_inference``, 64
     neighbours, batch 4096) of all nodes with the trained model, profiled
     over 40 batches of each layer, kernel 1 twice a batch, its first
     batches held
     against the CPU, and at 0.01 scale with whole neighbourhoods against
     the full-graph forward; kernel 1 timed at the five sampled shapes;
 21. the per-edge dot kernel (``csrc/sddmm.cu``), both arms, against its
     plain version: a bipartite graph in edge order and in slot order at
     H*F = 256 and 40, one head as 2-D tables, out-of-range indices with a
     mask, an empty edge list, and paths I's and D's shapes; float32 within
     1e-5 of the largest output, bf16 within the mix's bf16 bound;
 22. path I, TransformerConv serving on path C's graph and slot orders at
     ``attention_bench.py --qkv``'s shape: 3 layers (64 -> 4 x 64, 256 -> 4
     x 64, 256 -> 4 x 10 averaged), beta gate and root weight in each, ReLU
     between; ms per forward, launches (3 dot, 6 mix and, where the dot's
     plan cuts a head into column slices, its combine pass per forward), a
     profile, the output against the CPU plain path at 1e-4 of its largest;
 23. path J, the same stack trained with Adam on path D's labels: ms per
     step, launches (6 dot, 15 mix and the forward's combine passes per
     step), a profile, 3 steps against the CPU plain path at 0.1 scale;
 24. the dot kernel's timings at path I's shapes (edge order) and path D's
     (slot order, on the runs arm as path D's grad_p_u asks), H*F = 256
     (float32 and bf16) and 40, with its plain version,
     ``torch.sparse.sampled_addmm`` one call per head as the yardstick, and
     the bound from the bytes each call must move; its sweep of every slice
     shape of the arm (whole heads: 4, 2, 1; then one head in 2, 4, ...
     column slices) at every shape, each output bitwise equal to one
     slice's, and the other arm at its own rule;
 25. path N, ``benchmarks/hetero_bench.py --arms hgt`` at full scale (its
     OGB-MAG-shaped graph, ``build_mag_like(1.0)``: 1,939,743 nodes in 4
     types, 36,804,743 edges in 7 edge types; ``run_hgt``'s model, HGTConv
     64 x 4 heads twice and a Linear to 8 classes, Adam 1e-3) on raw COOs:
     'paper', 'author' and 'field' on the flash kernels, 'institution' on
     the wide op and the dot kernel; served and trained eager and captured,
     against the plain versions on the card and at 0.002 scale against the
     CPU; the bench's ``--layouts`` arm (``build_hgt_flash_layouts``) trained
     eager and captured, the sort launches a step of both arms; the flash
     kernels over the three flash unions and the dot kernel over
     institution's, against their plain versions and timed;
 26. path O, the same model on the blocked route at the bench's 0.25 scale
     (slot orders of every relation, rectangular ones included): the mix
     kernel through ``multi_relation_softmax_aggregate``, served and trained
     eager and captured, at 0.002 scale against the CPU, the mix timed at
     the ``writes`` relation;
 27. path P, ``--arms rgcn,proj`` at full scale: the graph homogenised by
     ``HeteroData.to_homogeneous`` (offsets held against ``run_rgcn``'s),
     FastRGCN trained (no port kernel: the JAX package's ``scatter``), at
     0.002 scale against the CPU; the typed-projection A/B (per-type GEMM,
     ``typed_matmul``'s ragged arm and dense einsum) over 1.94M rows;
 28. path Q, sampled heterogeneous GraphSAGE at full scale:
     ``HeteroNeighborLoader`` ([10, 10], 1,024 'paper' seeds) on the native
     hetero sampler, each batch's relations as ``EdgeIndex`` es on the card,
     ``to_hetero`` of SAGE 64 -> ReLU -> SAGE 64 and a Linear, 6 eager steps
     (host sampling a batch beside the card's time a step), the first batch
     against the CPU, one ``HGTLoader`` batch; kernel 1 timed at the batch's
     ``writes`` relation, forward and ``A^T g``;
 29. the SpMM regimes (``ops/spmm.py``, ``ops/chunked_spmm.py``,
     ``ops/dense_spmm.py``): the
     windowed, chunked and uncached dense regimes, each forced by its knob
     (``PGT_WIN_EDGES`` 2**18 over 60,000 nodes and 1.5M edges: 6 windows;
     ``PGT_SPMM_CHUNK_TRIGGER`` 0 with 2**18-edge chunks: 6 chunks;
     ``PGT_FORCE_DENSE_SPMM`` on 6,000 nodes), through the public ``spmm``
     with 1,000 padded edges: forward, ``grad_x`` and ``grad_w``, sum and
     mean, forward and transposed, against the float64 plain gather and its
     autograd, the launches each arm must make counted; each arm raising
     with ``backend.use_kernel_spmm = False``; the dot kernel timed as
     ``grad_w`` at the windowed (slot order) and chunked (edge order)
     shapes;
 30. path R, ``products_bench.py --infer`` at full scale: the products
     graph through ``fill_cache(auto=True)`` (its time and memory, the
     regime it reports; the windowed layouts built beside it, what they
     share with the CSC and CSR and add),
     the bench's 2-layer net (F = 100 -> 64 -> 47) served eagerly and
     captured, 20 forwards after 2, in float32 and with bf16 x: ms per
     forward, edges/s, launches, idle share, peak memory; the windowed
     forward equal bit for bit to the kernel regime's; at 0.01 scale against
     the CPU; kernel 1 at each layer's shape against the float64 sum (a hub
     row missing 1 % of its edges must fail the bound), its
     plain version (over 16 row ranges) and ``torch.sparse.mm``; the regime
     auto picks on path A's graph;
 31. path S, ``examples/giant_graph.py``'s model at full products scale:
     SAGE over the kernel regime (kernel 1) and ``GATConv(8, heads=4)``
     over the raw COO (the flash kernels), Adam 1e-2, served and trained
     eager and captured (1 step, then 5 timed), the captured losses and
     gradients against the eager ones; at the example's toy scale and knobs
     against the CPU (forward, 3 losses, first-step gradients); kernel 1 at
     the SAGE layer's shape;
 32. path T, Cluster-GCN at Reddit's shape (PyG's
     ``examples/cluster_gcn_reddit.py``; ``examples/cluster_gcn.py``): a
     generated graph of 232,965 nodes and 114,615,892 directed edges (80 %
     inside seeded communities), 602 features on the card;
     ``ClusterData(num_parts=1500)`` on the native partitioner (its
     symmetric CSR and partition timed, every node in one part, the parts
     within the balance cap, the edge cut under 0.5),
     ``ClusterLoader(batch_size=20, shuffle=True)``, GraphSAGE 602 -> 128
     -> 41, Adam 0.005, 20 eager steps: host ms a batch, card ms a step,
     kernel 1 three times a step, the idle share; the first batch's 3 steps
     against the CPU; kernel 1 at F = 602 and 128 (forward) and 128 (``A^T
     g``) against its plain version and timed;
 33. path U, GraphSAINT at Flickr's shape (PyG's
     ``examples/graph_saint.py``): 89,250 nodes, 899,756 directed edges,
     500 features; ``GraphSAINTRandomWalkSampler(6000, walk_length=2,
     num_steps=5, sample_coverage=100)`` on the native random walk
     (``_estimate_norms`` timed); three GraphConvs 500 -> 256 -> 256 -> 256
     and a Linear 768 -> 7 over ``edge_norm / deg[col]`` weights, loss
     ``(nll * node_norm).sum()``, Adam 0.001, 5 eager steps: kernel 1's
     weighted arm five times a step; the first batch's 3 steps against the
     CPU; kernel 1 at F = 500 and 256 (forward) and 256 (``A^T g``);
 34. path V, PNA at PyG's ``examples/pna.py`` configuration on ZINC's
     shape: 10,000 generated molecules (``zinc_like``), PNA's degree
     statistics from their in-degree histogram, 4 x PNAConv(75, towers=5,
     edge_dim=50) with BatchNorm and ReLU, sum pooling, MLP 75 -> 50 -> 25
     -> 1, L1 loss, Adam 1e-3, batch 128 unpadded, 10 eager steps (no port
     kernel: its reductions are index_add_ / scatter_reduce_) and 4
     eval-mode batches; the first batch's 3 steps against the CPU at the
     card's parameters (``synced_parity``), the running statistics too;
     a host breakdown of one step (``host_breakdown``: host ms, waits for
     the card, operators by self CPU time);
 35. path W, GIN-0 at COLLAB's shape (5,000 graphs of 32-492 nodes built
     per batch, ``collab_like``, the largest with a hub of degree 491,
     one-hot degree 492 wide): GIN(492, 64, 5, batch norm,
     jk='cat'), sum pooling, Linear 320 -> 3, Adam 0.01, batch 128, 10
     eager steps with kernel 1 nine times a step, 4 eval batches; the
     first batch against the CPU and its gradients against float64; kernel
     1 at F = 492 and 64 (forward) and 64 (``A^T g``); a host breakdown of
     one step;
 36. path X, GraphGPS as PyG's ``examples/graph_gps.py`` runs it on
     ZINC's shape (``zinc_like``'s molecules, ``AddRandomWalkPE(20)`` on
     the host as each batch is drawn): atom and PE encoders, 10 x
     GPSConv(64, GINEConv, heads=4) with batch norm, sum pooling, MLP 64 ->
     32 -> 16 -> 1, L1, Adam(1e-3, weight_decay=1e-5), batch 32, 10 eager
     steps and 4 eval batches, in a multi-head and a Performer arm (no port
     kernel: GINE's messages and the attention are plain PyTorch, as the
     JAX package's are XLA); each arm's first-batch float32 loss against
     the CPU's, and its 3 steps against the CPU at the card's parameters in
     float64 on both (``synced_parity``); host ms a batch with the PE
     transform's share;
 37. path Y, SGFormer at its ogbn-arxiv setting on ogbn-arxiv's shape
     (``arxiv_like``: 169,343 nodes, 2,332,486 directed edges, 128
     features, 40 classes), full graph, the GCN layers on
     ``cache_gcn_norm(auto=True)`` (kernel 1 three times a forward, six a
     step): served and trained eager and captured, 3 steps against the
     CPU on the graph cut to 0.1 (the first step's gradients against
     float64), kernel 1 at F = 256 forward and ``A^T g`` against its plain
     version and timed;
 38. every convolution, aggregation, norm and pooling function of the
     graph-level slice, the dense round trip (``to_dense_adj``,
     ``dense_to_sparse``), the graph-transformer modules (RGATConv in
     every mechanism, mode and mod, HEATConv, GPSConv with each attention,
     the attention modules, SGFormer and Polynormer on kernel 1,
     GraphMixer, the encodings), and every class of the propagation convs
     and the model zoo (``spectral_conv.py``, ``graph_conv.py``,
     ``misc_conv.py``, ``dna_conv.py``, ``misc_models.py``,
     ``autoencoder.py``; AntiSymmetricConv's GCNConv on an ``EdgeIndex``,
     JumpingKnowledge's lstm mode), and the point family and kernel
     convolutions (SplineConv at degrees 1-3 in 1-3 dimensions, GMMConv,
     NNConv, CGConv, FeaStConv, the point convs, XConv with and without x,
     knn / radius / fps / knn_interpolate and the KNN indexes, the top-k
     poolings, GraphUNet at Cora's size), once on the card, forward and
     backward, against the CPU, each launching no port kernel;
 39. path Z (run after path S, on the same products graph), PyG's
     ``examples/correct_and_smooth.py`` at ogbn-products' shape: an MLP
     base predictor (100 -> 200 -> 200 -> 47, batch norm, dropout 0.5 from
     a CUDA generator) trained 10 full-batch Adam steps on 196,615 seeded
     training rows, then ``CorrectAndSmooth`` (50 correction hops at alpha
     1.0, scale 20; 50 smoothing hops at 0.8) over the raw COO: ms a base
     step, a C&S pass with ``correct`` and ``smooth`` apart, a propagation
     layer, peak memory, a profiled pass's busy and idle share and
     launches a layer, host issue ms; no port kernel (the gather path, as
     the JAX package's XLA scatter), eager, not captured; at 0.01 scale
     the card's corrected and smoothed outputs against the CPU's float64
     within 1e-4 * max(1, max|ref|), and the correction without its
     re-pin of the training rows failing that limit;
 40. path AA, PyG's ``examples/dgcnn_classification.py`` on ModelNet10's
     shape: 10 seeded families of closed meshes (3,040 faces) through
     ``NormalizeScale`` once and ``SamplePoints(1024)`` as each cloud is
     drawn, batch 32 (32,768 points, 655,360 knn edges a layer), two
     ``DynamicEdgeConv`` (k = 20; ``knn_graph`` every forward, the tiled
     branch), Linear 192 -> 1024, global max pooling, MLP 1024 -> 512 ->
     256 -> 10 (dropout 0.5 from a CUDA generator), Adam 1e-3, 10 eager
     steps and 4 eval batches: host ms a batch, card ms a step, the two
     ``knn_graph`` calls timed apart beside their pair, FLOP and byte
     reckoning, busy and idle share, peak memory, no port kernel; the
     card's ``knn_graph`` of the first batch against the CPU's at the
     positions and layer 2's features (swapped places counted, each within
     float32 rounding), the first batch cut to 8 clouds: its float32 loss
     against the CPU's and 3 steps in float64 on both (``synced_parity``);
 41. path AB, PyG's ``examples/faust.py`` on FAUST's shape (a UV sphere of
     6,890 vertices and 13,776 triangles, smooth seeded bumps, 41,328
     edges from the port's ``to_undirected``, ``Cartesian()``
     pseudo-coordinates): 6 SplineConv (dim 3, kernel 5, 'add') with ELU,
     Linear 64 -> 256 -> 6890, NLL over the vertex ids, Adam 1e-3, 10
     eager steps and eval-mode serving: ms a step and a forward, busy and
     idle share, peak memory, no port kernel; 3 steps at full size against
     the CPU with one dropout mask;
 42. path AC, the JAX package's ``examples/mem_pool.py`` net on TU's
     PROTEINS_full shape (``proteins_like``'s raw files parsed by
     ``TUDataset``), batch 20, kernel 1 three times a step, 3 steps against
     the CPU;
 43. path AD, the Kipf & Welling GCN (PyG's ``examples/gcn.py``) on
     Planetoid's published shapes: ``planetoid_raw`` writes Cora's,
     CiteSeer's and PubMed's raw files, the port's ``Planetoid`` parses
     them (CiteSeer through the refill of its isolated test rows), and on
     Cora and PubMed ``NormalizeFeatures`` and GCN(in, 16, classes) over
     the normalisation computed once and carried as edge weights (kernel 1
     four times a step), 200 epochs on the card and on the CPU from the
     same weights and dropout masks (final test accuracies within 5 of the
     1,000 test nodes), 3 steps without dropout against the CPU, kernel 1
     at F = 16, 7 and 3 against its plain version and timed; the module
     phase also holds the data plumbing (stores, ``HypergraphData.to``,
     ``LightningNodeData``, ``summary``) on the card to the CPU.
 44. path AE, DimeNet++ (PyG's ``DimeNetPlusPlus.from_qm9_pretrained``
     configuration) and SchNet (PyG's defaults) on QM9's shape:
     ``qm9_raw`` writes 10,000 molecules' ``gdb9.sdf`` and
     ``gdb9.sdf.csv``, the port's ``QM9`` parses them (checked against
     what was written), and in batches of 32 each model trains (Adam 1e-3
     on the standardised U0, 10 steps after 1) and serves (20 eval batches
     after 2): card and host ms, DimeNet++'s host-side interaction graph
     and triplets apart, busy and idle share, peak memory, no port kernel;
     the float32 serving outputs against the CPU, 3 float64 steps against
     the CPU, and SchNet's radius graph on the card against the CPU's;
     the module phase also runs the molecular models (``molecule_cases``;
     AttentiveFP's fused atom conv launches the mix and per-edge dot
     kernels) and parses a dataset of each new family on the host and
     moves it to the card (``data_cases``).

Every path of phases 4, 7, 8, 11, 12, 15-18, 22 and 23 (serving GCN; paths
A, B, C, D, E, F, G, H, I, J) also runs captured, through
``compat.compile`` (a CUDA
graph: 2 eager warm-ups, the capture, then replays): ms per forward or step,
device busy time and idle share over replays, the launches a replay holds
(equal to the eager per-call counts) times the replays; a forward's output
against the eager one (bitwise or not) and the CPU plain path, a step's 5
losses (the last 3 replays) and the first replayed step's gradients against
the eager step from the same weights with ``Adam(capturable=True)``. Paths
B and F print ``bench.py``'s one-line JSON, eager and captured.

Every profile of a path is a whole window (``whole_window``): it follows a
warm-up window, and a window that lost launches is profiled again.

Usage: ``python3 chip_smoke.py [--seed 0] [--iters 20]`` from the root of a
checkout, on a machine with one CUDA card. The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Any failed phase raises, and the run then exits non-zero without that line.
It also exits non-zero when no card is visible or the package is missing.
"""

import argparse
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# An H100 SXM's published HBM rate and float32 (non-tensor-core) rate, the
# peaks the bounds below are taken against.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# and its dense bf16 tensor-core rate
BF16_FLOP_PER_S = 989e12

N_NODES, N_EDGES, WIDTH, N_LAYERS, N_OUT = 30_000, 1_000_000, 128, 3, 16

# bench.py's training model and protocol (bench.py:23-26, 93-114)
TR_F, TR_HIDDEN, TR_LAYERS, TR_CLASSES, TR_LR = 64, 64, 3, 10, 1e-2
PB_NODES, PB_EDGES, PB_STEPS = 10_000, 200_000, 500
# bench.py's reference eager seconds per 500 steps (compile.rst:95-142, an
# unspecified GPU), printed beside path B's seconds for orientation only
REFERENCE_EAGER_S = {'GCN': 4.8093, 'GraphSAGE': 3.2451, 'GIN': 3.3690}
# path A: the repo's BSR configuration (benchmarks/spmm_bench.py:103-114,
# benchmarks/round5_chip_runbook.md:46)
PA_NODES, PA_EDGES, PA_CLUSTER = 250_000, 5_000_000, 2400
PA_WARMUP, PA_STEPS = 2, 20
PROFILED_STEPS, PARITY_STEPS = 3, 3
# each training step runs 3 forward SpMM passes and 2 backward ones: layer
# 1 aggregates the leaf input, so its A^T pass never runs (bench.py:152-155)
PASSES_PER_STEP = 5
# paths C and D: the attention bench's graph (benchmarks/attention_bench.py:
# 45-47, H = 4 heads of 64) under bench.py's 3 layers and 10 classes
PC_NODES, PC_EDGES, PC_F, PC_HIDDEN, PC_HEADS = 100_000, 2_000_000, 64, 256, 4
PC_LAYERS, PC_CLASSES = 3, 10
# per layer, a forward runs the mix kernel twice (the stabiliser sum and the
# mix); a training step adds grad_v, since v = lin_src(x) needs a gradient
MIX_PER_FORWARD, MIX_PER_STEP = 2 * PC_LAYERS, 3 * PC_LAYERS
# the mix kernel's name in a profile (every template instance holds it)
MIX_KERNEL = 'gat_mix_kernel'
# paths I and J: TransformerConv served and trained on path C's graph at
# attention_bench.py --qkv's shape (:25-28, :58: H = 4 heads of 64), 3
# layers of (heads, channels, concat), each with the beta gate and the root
# weight, ReLU between
PI_LAYERS = ((PC_HEADS, PC_HIDDEN // PC_HEADS, True),
             (PC_HEADS, PC_HIDDEN // PC_HEADS, True),
             (PC_HEADS, PC_CLASSES, False))
# per layer a forward launches the dot kernel once (the scores) and the mix
# kernel twice; a step adds the dot for grad_p_u, and grad_v and the two
# score gradients (sddmm's backward) on the mix kernel
DOT_PER_FORWARD, DOT_PER_STEP = PC_LAYERS, 2 * PC_LAYERS
PI_MIX_PER_FORWARD, PI_MIX_PER_STEP = 2 * PC_LAYERS, 5 * PC_LAYERS
# path D: the dot kernel computes grad_p_u, once per layer and step
DOT_PER_GAT_STEP = PC_LAYERS
# the dot kernel's name in a profile, and its column slices' combine pass
EDGE_DOT_KERNEL, EDGE_DOT_COMBINE = 'edge_dot_kernel', 'edge_dot_combine'
# kernel 2's two launches per call, its pre-pass and the kernel proper
BSR_PREP, BSR_MAIN = 'bsr_prep_kernel', 'bsr_spmm_kernel'
# kernel 1's name in a profile, and PyTorch's add kernel
SEG_MAIN, ADD = 'segment_spmm_kernel', 'CUDAFunctor_add'
# the count of HGMMA (wgmma) instructions in a built library's SASS
HGMMA = {}
# compat.compile's eager warm-up calls before the call that captures
CAPTURE_WARMUP = 2
# the reference's compiled seconds per 500 steps (BASELINE.md:11-13,
# torch.compile on an unspecified GPU), beside the eager ones above
REFERENCE_COMPILED_S = {'GCN': 1.6978, 'GraphSAGE': 1.4498, 'GIN': 1.4727}
# bench.py's metric names (bench.py:26)
BENCH_NAMES = {'GCN': 'gcn', 'GraphSAGE': 'sage', 'GIN': 'gin'}
# the scan phase: products_bench.py's sampled training (:38-40, :171-196):
# ogbn-products' node and edge counts, F and classes, batch 512, fan-outs
# [15, 10], GraphSAGE hidden 64 over 2 layers, Adam 1e-3, K = 8 steps a
# dispatch; the batches come from its graph and its loader's epoch
N_PRODUCTS, E_PRODUCTS, PR_F, PR_CLASSES = 2_449_029, 123_718_280, 100, 47
PR_BATCH, PR_FANOUTS, PR_HIDDEN, PR_LR, PR_K = 512, (15, 10), 64, 1e-3, 8
PR_REPS = 10
# its end-to-end run (products_bench.py:752-754: 50 steps, K steps a
# dispatch, rounded up to whole groups) with 4 sampling threads
PR_STEPS, PR_WORKERS = 50, 4
# end-to-end loops per mode (and per thread count), their median kept
PR_E2E_ROUNDS = 3
# layer-wise serving (basic_gnn_inference): its default 64 neighbours a
# layer, batch 4096; the first 2 batches of each layer held against the CPU
LW_BATCH, LW_NEIGHBORS, LW_CPU_BATCHES = 4096, 64, 2
# the full-neighbourhood check on the products graph at 0.01 scale (24,490
# nodes; its largest in-degree is 16,969 at seed 0): batch 240 keeps twice a
# batch's node budget (240 * 16,970) under 2**23, the size of the sampler's
# hash table, which a batch of 256 would double
LW_CHECK_SCALE, LW_CHECK_BATCH = 0.01, 240
# the layer-wise pass's batches profiled at the start of each layer (after
# its first); the card's time in the pass is scaled up from them
LW_PROF_BATCHES = 40
# paths K, L, M: the flash kernels' names in a profile, by counter; a
# forward of each launches kernel (a) once per flash layer (2), a step adds
# kernels (b) and (c) per flash layer
FLASH_KERNELS = {'flash_fwd': 'flash_fwd_kernel',
                 'flash_bwd_dst': 'flash_bwd_dst_kernel',
                 'flash_bwd_src': 'flash_bwd_src_kernel'}
FLASH_PER_FORWARD = {'flash_fwd': 2}
FLASH_PER_STEP = {'flash_fwd': 2, 'flash_bwd_dst': 2, 'flash_bwd_src': 2}
# path K's timed steps, and the scale of its check against the CPU; paths L
# and M's
PK_STEPS, PK_SMALL, PL_SMALL = 5, 0.01, 0.05
# paths D and J: their 3 steps against the CPU run on path C's generator at
# this share of its nodes and edges (the cap scaled with it), as paths K-M
# and N-P hold theirs: at full size the CPU took 48 and 93 s of the time
# limit; at full size the card's steps are held to the captured twin and
# their kernels to the plain versions
PD_SMALL = 0.1
# paths K, L, M: besides 1e-4 of the largest gradient of all, each gradient
# is held to this share of its own largest (``flash_parity``); the readings
# it rests on are in PERF.md
FLASH_OWN_TOL = 1e-2
# the flash kernels' device ms per launch as PERF.md's kernel table recorded
# them before kernel (a) was redesigned and the flash route padded heads to
# 16-byte rows (kernel (a) one team per (row, head); K layer 2 unpadded, C
# = 47, on the float arm; one H100 80GB HBM3 at 700 W). Not measured by
# this script: the timing phase's log quotes them, labelled as recorded,
# beside its own readings, and no printed record holds them
FLASH_RECORDED_BEFORE_MS = {
    ('K layer 1', 'flash_fwd'): 25.5571, ('K layer 2', 'flash_fwd'): 16.5081,
    ('L layer 1', 'flash_fwd'): 1.6165, ('M layer 1', 'flash_fwd'): 2.0572,
    ('K layer 1', 'flash_bwd_dst'): 14.6890,
    ('K layer 2', 'flash_bwd_dst'): 24.3339,
    ('L layer 1', 'flash_bwd_dst'): 1.2188,
    ('M layer 1', 'flash_bwd_dst'): 1.6127,
    ('K layer 1', 'flash_bwd_src'): 16.4607,
    ('K layer 2', 'flash_bwd_src'): 23.5000,
    ('L layer 1', 'flash_bwd_src'): 1.6394,
    ('M layer 1', 'flash_bwd_src'): 1.8432}
# the regime arm checks: a graph that really chunks (6 windows of the
# windowed layout, 6 chunks of the chunked regime) plus padded edges, F =
# 32; the uncached dense regime on a graph its [N, N] build holds
RA_NODES, RA_EDGES, RA_F, RA_PAD, RA_CHUNK = 60_000, 1_500_000, 32, 1_000, \
    1 << 18
RA_DENSE_NODES, RA_DENSE_EDGES = 6_000, 200_000
# path R: products_bench.py --infer on the products graph; the regime
# fill_cache(auto=True) must report there (and path S's SAGE layer take):
# the card's policy builds no windowed layouts unasked (ops/spmm.py)
PR_REGIME = 'kernel'
# path S: examples/giant_graph.py's model (:57-63): x [N, 32], SAGEConv(32),
# GATConv(8, heads=4), Linear 7, Adam 1e-2; its toy scale and the env caps
# it sets (:35-40) for the check against the CPU
PS_F, PS_HIDDEN, PS_HEADS, PS_CLASSES, PS_LR = 32, 32, 4, 7, 1e-2
PS_TOY_NODES, PS_TOY_EDGES = 2_000, 20_000
PS_TOY_ENV = {'PGT_ATTN_WIDE_BYTES': '1', 'PGT_ATTN_CHUNK_EDGES': '4096',
              'PGT_AUTO_WIN_MIN_EDGES': '1000',
              'PGT_DENSE_SPMM_ENTRIES': '100'}
# the flash wrappers' kernel names, as ops/flash_softmax.py::kernel_shape
# takes them, by launch counter
FLASH_SHAPE_KERNEL = {'flash_fwd': 'fwd', 'flash_bwd_dst': 'dst',
                      'flash_bwd_src': 'src'}


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def reset_counts():
    """Every kernel arm's launch count to 0, just before a path runs."""
    from pytorch_geometric_tpu_torch.compat import launch_counters
    for _, fn, attr in launch_counters():
        setattr(fn, attr, 0)


def launch_counts():
    """Every kernel arm's launch count: the host calls that launched it (a
    graph's replays are counted by its compiled callable)."""
    from pytorch_geometric_tpu_torch.compat import launch_counts as counts
    return counts()


def check_counts(tag, counts, want, over):
    """Every arm launched as often as ``want`` says, and the others never."""
    for name, n in counts.items():
        check(n == want.get(name, 0), f'{tag}: {name} launched {n} times in '
                                      f'{over}, expected {want.get(name, 0)}')


# -- phase 1 ------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('[device] torch.backends.cuda.matmul.allow_tf32 = False, '
        'torch.backends.cudnn.allow_tf32 = False (float32 runs in full '
        'float32)')
    log(f'[device] {torch.cuda.get_device_name(0)}, count '
        f'{torch.cuda.device_count()}, torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}')
    return smi


# -- phase 2 ------------------------------------------------------------------
def sass_count(lib, opcode):
    """How often ``opcode`` appears in the SASS of the built library
    ``lib`` (``cuobjdump -sass``), or "not available" without the tool."""
    tool = Path('/usr/local/cuda/bin/cuobjdump')
    if not tool.is_file():
        return 'not available'
    sass = subprocess.run([str(tool), '-sass', str(lib)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        return 'not available'
    return len(re.findall(rf'\b{opcode}\b', sass.stdout))


def phase_build(csrc):
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    # the host libraries (the sampler, the partitioner) build with g++
    # while nvcc runs
    with ThreadPoolExecutor(2) as pool:
        host = {name: pool.submit(fn) for name, fn in (
            ('sampler', csrc.sampler_library),
            ('partition', csrc.partition_library))}
        libs = csrc.build_all()
        log(f"[build] {', '.join(sorted(csrc.SOURCES))} (one nvcc each, in "
            f'parallel) in {time.perf_counter() - t0:.2f} s')
        for name, fut in host.items():
            check(fut.result() is not None,
                  f'the native {name} library did not build (g++)')
    log(f'[build] the native sampler and partitioner (g++ '
        f"{' '.join(csrc.HOST_FLAGS)}) beside them, all in "
        f'{time.perf_counter() - t0:.2f} s')
    HGMMA['bsr_spmm'] = sass_count(libs['bsr_spmm'], 'HGMMA')
    log(f"[build] bsr_spmm: {HGMMA['bsr_spmm']} HGMMA instructions in its "
        'SASS (cuobjdump -sass)')
    for name, text in csrc.build_logs.items():
        fn, spill, lines = None, '', []
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m:
                spill = f'spill stores {m.group(1)} B, loads {m.group(2)} B'
            m = re.search(r'Used (\d+) registers', line)
            if m and fn:
                args = (['bf16'] if '__nv_bfloat16' in fn else []) + \
                    re.findall(r'Li(\d+)E', fn)
                tag = f"<{', '.join(args)}>" if args else ''
                lines.append((f'[build] {name}{tag}: {m.group(1)} registers, '
                              f'{spill}', int(m.group(1)),
                              not spill.startswith('spill stores 0 ')))
        if len(lines) <= 48:
            for text_line, _, _ in lines:
                log(text_line)
        else:
            # a source of many template instances: the range only
            log(f'[build] {name}: {len(lines)} kernels, '
                f'{min(r for _, r, _ in lines)}-'
                f'{max(r for _, r, _ in lines)} registers, '
                f'{sum(sp for _, _, sp in lines)} of them spill')


# -- graph --------------------------------------------------------------------
def serving_graph(seed):
    """The inference bench's graph: random COO plus one self loop per node,
    with its host-side GCN weights (``deg^-1/2[src] * deg^-1/2[dst]``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_NODES, WIDTH)).astype(np.float32)
    coo = rng.integers(0, N_NODES, (2, N_EDGES)).astype(np.int32)
    loops = np.arange(N_NODES, dtype=np.int32)
    coo = np.stack([np.concatenate([coo[0], loops]),
                    np.concatenate([coo[1], loops])])
    deg = np.bincount(coo[1], minlength=N_NODES).astype(np.float32)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1))
    return x, coo, (dis[coo[0]] * dis[coo[1]]).astype(np.float32)


def spmm_bytes(x_rows, n_dst, e, f, weighted, itemsize=4, base=False):
    """Bytes the function must move: the ``x_rows`` rows of x that its edges
    read, base (when given) and out once, indptr, src and w."""
    return ((x_rows + n_dst * (2 if base else 1)) * f * itemsize
            + (n_dst + 1) * 4 + e * 4 + (e * itemsize if weighted else 0))


def bound_ms(x_rows, n_dst, e, f, weighted, itemsize=4, base=False):
    """The least time of one segment-sum pass: its bytes over the HBM rate
    or its ``2 * E * F`` FLOPs (float32 FMAs, both arms) over the float32
    rate, the larger, with which of the two it is."""
    t_bytes = spmm_bytes(x_rows, n_dst, e, f, weighted, itemsize,
                         base) / HBM_BYTES_PER_S
    t_ops = 2.0 * e * f / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def segment_plans(f, itemsize, x_ptr):
    """Every plan of kernel 1 for F = f that the rule's lanes allow: each
    load width of the arm that divides F and suits x's address, the lanes
    that cover a row at that width, each lane-group count a warp holds, the
    staged and the direct mode."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import VEC_WIDTHS
    plans = []
    for vec in VEC_WIDTHS[itemsize]:
        if f % vec or x_ptr % (vec * itemsize):
            continue
        lanes = 1
        while lanes < min(-(-f // vec), 32):
            lanes *= 2
        g = 1
        while lanes * g <= 32:
            plans += [(vec, lanes, g, 32 // (lanes * g), st) for st in (1, 0)]
            g *= 2
    return plans


def segment_close(torch, indptr, src, w, x, out, base=None):
    """Kernel 1's output against its plain version on the same inputs:
    (max abs err, ok) within the float32 limit, one bf16 ulp more for bf16
    (``bf16_ok``)."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import \
        segment_spmm_plain
    ref = segment_spmm_plain(indptr, src, w, x, base)
    scale = segment_spmm_plain(indptr, src, None if w is None else
                               w.float().abs(), x.float().abs())
    if x.dtype == torch.bfloat16:
        return bf16_ok(torch, out, ref, scale)
    err = (out - ref).abs()
    return ((float(err.max()) if err.numel() else 0.0),
            bool((err <= 1e-5 + 1e-5 * scale).all()))


def segment_timed(torch, label, indptr, src, w, x, base=None):
    """One timing row of kernel 1 on these inputs: its launch plan, the
    device time (``timed_fns``) of the kernel, of its plain version and of
    the one library call that computes the same function
    (``torch.sparse.mm`` on a CSR tensor of the matrix, ``torch.addmm``
    with a base; a yardstick the port never calls), the bound from the
    bytes the function must move, the share of it the kernel reaches, and
    the rate of the x rows it gathers (``E * F * itemsize`` over its
    time). The bound counts the rows of x that the edges read, each once
    (a sampled batch's padded rows and unreached sources are never read)."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_plan, segment_spmm, segment_spmm_plain)
    n_dst, (n_src, f) = indptr.shape[0] - 1, x.shape
    e, item = int(indptr[-1]), x.element_size()
    x_rows = int(torch.unique(src[:e]).numel())
    plan = segment_plan(f, item, n_dst, src.shape[0], x.data_ptr(), 0,
                        0 if base is None else base.data_ptr())
    fns = {'ms': lambda: segment_spmm(indptr, src, w, x, base=base),
           'plain_ms': lambda: segment_spmm_plain(indptr, src, w, x, base)}
    call = ('torch.sparse.mm (CSR)' if base is None else
            'torch.addmm (base + CSR @ x)')
    row = {'shape': label, 'F': f, 'dtype': str(x.dtype).split('.')[-1],
           'n_src': n_src, 'x_rows_read': x_rows, 'n_dst': n_dst, 'edges': e,
           'weighted': w is not None, 'base': base is not None,
           'plan': list(plan), 'library_call': call,
           'bytes': spmm_bytes(x_rows, n_dst, e, f, w is not None, item,
                               base is not None),
           'gathered_bytes': e * f * item, 'flops': 2.0 * e * f}
    row['bound_ms'], row['bound_by'] = bound_ms(
        x_rows, n_dst, e, f, w is not None, item, base is not None)
    try:
        a = torch.sparse_csr_tensor(
            indptr, src, w if w is not None else torch.ones(
                e, dtype=x.dtype, device=x.device), size=(n_dst, n_src))

        def lib():
            return (torch.sparse.mm(a, x) if base is None
                    else torch.addmm(base, a, x))
        ref = fns['plain_ms']().float()
        d = float((lib().float() - ref).abs().max())
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as err:
        row['library_ms'] = None
        row['library_error'] = f'{type(err).__name__}: {str(err)[:200]}'
    else:
        lim = (1e-2 if x.dtype == torch.bfloat16 else 1e-4) * max(
            1.0, float(ref.abs().max()))
        check(d <= lim, f'{call} disagrees with the plain version by {d} '
                        f'({label})')
        fns['library_ms'] = lib
    timed_fns(torch, row, fns, reps=200, warmup=50, calls=100)
    row['share'] = row['bound_ms'] / row['ms']
    row['gathered_tb_per_s'] = row['gathered_bytes'] / (row['ms'] * 1e-3) \
        / 1e12
    lib_txt = (f"{row['library_ms']:.4f} ms" if row['library_ms'] is not None
               else f"none ({row['library_error']})")
    log(f"[timing] segment_spmm {label}: plan {tuple(plan)} (vec, lanes, "
        f"groups, rows per warp); device time per call: kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, {call} "
        f"{lib_txt}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"x rows read {x_rows} of {n_src}), share "
        f"{100 * row['share']:.1f}%; gathered x rows "
        f"{row['gathered_bytes'] / 1e6:.1f} MB at "
        f"{row['gathered_tb_per_s']:.3f} TB/s; CUDA-event wall per "
        f"back-to-back call: kernel {row['event_ms']:.4f} ms")
    return row


def plan_sweep(torch, label, indptr, src, w, x):
    """Kernel 1's device time per call at every lane-group count the
    rule's lanes allow (the rule's load width and lanes), in both modes,
    each output held to its plain version within the limit; the rows that
    justify ``segment_plan``'s ``MIN_GROUP_RUN`` and ``STAGED_MAX_LANES``."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_plan, segment_spmm)
    n_dst, f = indptr.shape[0] - 1, x.shape[1]
    rule = segment_plan(f, x.element_size(), n_dst, src.shape[0],
                        x.data_ptr(), 0)
    mean = src.shape[0] / max(n_dst, 1)
    rows, g = [], 1
    while rule.lanes * g <= 32:
        for staged in (1, 0):
            plan = (rule.vec, rule.lanes, g, 32 // (rule.lanes * g), staged)
            err, ok = segment_close(torch, indptr, src, w, x, segment_spmm(
                indptr, src, w, x, plan=plan))
            check(ok, f'segment_spmm {label} plan {plan} disagrees with its '
                      f'plain version by {err}')
            ms = device_ms(torch, lambda: segment_spmm(indptr, src, w, x,
                                                       plan=plan), calls=100)
            is_rule = plan == tuple(rule)
            rows.append({'shape': label, 'plan': list(plan), 'groups': g,
                         'staged': staged, 'mean_edges_per_group': mean / g,
                         'ms': ms, 'max_abs_err': err, 'rule': is_rule})
            log(f"[sweep] segment_spmm {label} plan {plan}: {mean / g:.1f} "
                f"mean edges a lane group, "
                f"{'staged' if staged else 'direct'}, {ms:.4f} ms device "
                f"time per call, max abs err {err:.3e}"
                f"{' (the rule)' if is_rule else ''}")
        g *= 2
    return rows


# -- phase 3 ------------------------------------------------------------------
def kernel_cases(torch, seed):
    """(label, indptr, src, w, x) on the card: narrow and unaligned widths,
    weighted and unweighted, bipartite sizes with empty dst rows and padded
    edges, and the serving shapes."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    rng = np.random.default_rng(seed + 1)
    cases = []
    n_src, n_dst, e = 700, 1000, 20_000
    # dst drawn from half the rows: the other half stay empty
    dst = rng.choice(n_dst, n_dst // 2, replace=False)[
        rng.integers(0, n_dst // 2, e)]
    src = rng.integers(0, n_src, e)
    coo = np.stack([np.concatenate([src, np.full(64, n_src)]),
                    np.concatenate([dst, np.full(64, n_dst)])])  # + padding
    csc = EdgeIndex(coo.astype(np.int32), (n_src, n_dst),
                    device='cuda').fill_cache().csc
    w_all = torch.as_tensor(rng.random(coo.shape[1]).astype(np.float32),
                            device='cuda')
    for f in (1, 10, 16, 128):
        x = torch.as_tensor(
            rng.standard_normal((n_src, f)).astype(np.float32),
            device='cuda')
        for weighted in (True, False):
            w = w_all[csc.perm].contiguous() if weighted else None
            cases.append((f'bipartite {n_src}->{n_dst} E={e}+64 pad F={f} '
                          f"{'weighted' if weighted else 'unweighted'}",
                          csc.indptr, csc.indices, w, x))
    x_np, coo, w_np = serving_graph(seed)
    ei = EdgeIndex(coo, (N_NODES, N_NODES), device='cuda').fill_cache()
    w = torch.as_tensor(w_np, device='cuda')[ei.csc.perm].contiguous()
    for f in (WIDTH, N_OUT):
        x = torch.as_tensor(x_np[:, :f].copy(), device='cuda')
        cases.append((f'serving N={N_NODES} E={coo.shape[1]} F={f} '
                      'weighted', ei.csc.indptr, ei.csc.indices, w, x))
    return cases


def phase_kernel_vs_plain(torch, seed):
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_plain)
    worst = 0.0
    for label, indptr, src, w, x in kernel_cases(torch, seed):
        out = segment_spmm(indptr, src, w, x)
        torch.cuda.synchronize()
        ref = segment_spmm_plain(indptr, src, w, x)
        # f32 sums in another order: allow 1e-5 of the row's sum of
        # |w * x| terms, plus 1e-5
        scale = segment_spmm_plain(indptr, src,
                                   None if w is None else w.abs(), x.abs())
        torch.cuda.synchronize()
        err = (out - ref).abs()
        ok = bool((err <= 1e-5 + 1e-5 * scale).all())
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        log(f'[kernel] segment_spmm {label}: max abs err '
            f'{float(err.max()) if err.numel() else 0.0:.3e} '
            f"{'ok' if ok else 'FAILED'}")
        check(ok, f'segment_spmm disagrees with its plain version: {label}')
        if not label.startswith('bipartite'):
            continue
        # every plan branch at this width, with and without a base; two
        # launches of each bitwise equal
        base = torch.as_tensor(np.random.default_rng(seed + 9).standard_normal(
            ref.shape).astype(np.float32), device='cuda')
        errs, first = [], {}
        for plan in segment_plans(x.shape[1], 4, x.data_ptr()):
            for b in (None, base):
                out = segment_spmm(indptr, src, w, x, base=b, plan=plan)
                again = segment_spmm(indptr, src, w, x, base=b, plan=plan)
                err, ok = segment_close(torch, indptr, src, w, x, out, b)
                # the staged and direct modes take the same sums in order
                other = first.setdefault((plan[:4], b is None), out)
                same = bool(torch.equal(out, again)
                            and torch.equal(out, other))
                errs.append(err)
                check(ok and same, f'segment_spmm {label} plan {plan} base '
                                   f'{b is not None}: max abs err {err}, '
                                   'bitwise equal to another launch and to '
                                   f'the other mode: {same}')
        worst = max(worst, *errs)
        log(f'[kernel] segment_spmm {label}: '
            f"{len(segment_plans(x.shape[1], 4, x.data_ptr()))} plans "
            f'(vec, lanes, groups, staged) with and without a base: max abs '
            f'err {max(errs):.3e}, two launches of each and both modes '
            'bitwise equal, ok')
    return worst


# -- phases 4 and 5 -----------------------------------------------------------
def build_model(torch, kind, device, seed):
    from pytorch_geometric_tpu_torch.nn.models import GCN, GIN, GraphSAGE
    g = torch.Generator().manual_seed(seed)
    if kind == 'GCN':
        # the bench's sparse-f32 arm: weights normalised on the host
        return GCN(WIDTH, WIDTH, N_LAYERS, N_OUT, device=device,
                   generator=g, conv_kwargs={'normalize': False,
                                             'add_self_loops': False})
    cls = {'GraphSAGE': GraphSAGE, 'GIN': GIN}[kind]
    return cls(WIDTH, WIDTH, N_LAYERS, N_OUT, device=device, generator=g)


def cpu_reference(torch, model, kind, x_np, coo, w_np):
    """The same weights through the plain path on the CPU."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    ref = build_model(torch, kind, 'cpu', 0)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref.eval()
    ei = EdgeIndex(coo, (N_NODES, N_NODES), device='cpu').fill_cache()
    kw = {'edge_weight': torch.from_numpy(w_np)} if kind == 'GCN' else {}
    with torch.inference_mode():
        return ref(torch.from_numpy(x_np), ei, **kw)


def compare(torch, kind, out, ref, shape=None):
    out = out.float().cpu()
    shape = shape or (N_NODES, N_OUT)
    check(tuple(out.shape) == shape,
          f'{kind}: output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), f'{kind}: non-finite output')
    diff = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((out.argmax(-1) == ref.argmax(-1)).double().mean())
    log(f'[{kind}] vs the CPU plain path, same weights: max abs diff '
        f'{diff:.3e} (max |ref| {scale:.3e}), argmax agreement {agree:.6f}')
    # f32 with sums in another order on both the SpMM and the matmuls
    check(diff <= 1e-4 * max(1.0, scale),
          f'{kind}: max abs diff {diff} vs the CPU plain path')
    check(agree >= 0.999, f'{kind}: argmax agreement {agree}')
    return diff, agree


def phase_serving(torch, seed, iters, warmup):
    from pytorch_geometric_tpu_torch import EdgeIndex
    x_np, coo, w_np = serving_graph(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ei = EdgeIndex(coo, (N_NODES, N_NODES)).fill_cache()   # on the card
    torch.cuda.synchronize()
    log(f'[serving] EdgeIndex + fill_cache (copy and both sorts on the '
        f'card): {(time.perf_counter() - t0) * 1e3:.3f} ms')
    x = torch.as_tensor(x_np, device='cuda')
    w = torch.as_tensor(w_np, device='cuda')
    results = {}
    for kind in ('GCN', 'GraphSAGE', 'GIN'):
        model = build_model(torch, kind, None, seed).eval()
        kw = {'edge_weight': w} if kind == 'GCN' else {}
        torch.cuda.synchronize()
        reset_counts()
        with torch.inference_mode():
            if kind == 'GCN':
                ms, enqueue_ms, _, out = timed_calls(
                    torch, lambda: model(x, ei, **kw), iters, warmup)
                breakdown = profile_forwards(torch, lambda: model(x, ei, **kw))
                n_fwd = warmup + iters + breakdown[2]
            else:
                out = model(x, ei, **kw)
                torch.cuda.synchronize()
                ms, n_fwd = None, 1
        counts = launch_counts()
        launches = counts['segment_spmm']
        log(f'[{kind}] launches in {n_fwd} forwards: {counts}')
        check_counts(kind, counts, {'segment_spmm': N_LAYERS * n_fwd},
                     f'{n_fwd} forwards')
        ref = cpu_reference(torch, model, kind, x_np, coo, w_np)
        diff, agree = compare(torch, kind, out, ref)
        res = {'launches': launches, 'launch_counts': counts,
               'forwards': n_fwd,
               'max_abs_diff_vs_cpu': diff, 'argmax_agreement': agree}
        if ms is not None:
            res.update(ms_per_forward=ms, edges_per_s=3 * N_EDGES / (ms / 1e3),
                       host_enqueue_ms_per_forward=enqueue_ms)
            log(f'[{kind}] {ms:.4f} ms per forward on the card (CUDA events, '
                f'{iters} forwards); the host issues one in '
                f'{enqueue_ms:.4f} ms')
            rows, prof_ms, _ = breakdown
            busy = sum(t for _, t, _ in rows)
            # busy and wall from the same profiled forwards; the kernels run
            # on one stream, so busy cannot exceed the wall
            check(busy <= 1.05 * prof_ms,
                  f'{kind}: device busy {busy} ms exceeds the wall '
                  f'{prof_ms} ms of the same forwards')
            res.update(device_busy_ms_per_forward=busy,
                       profiled_ms_per_forward=prof_ms,
                       device_idle_share=1 - busy / prof_ms,
                       busy_over_timed_forward=busy / ms,
                       kernels_per_forward=rows[:12])
            log(f'[{kind}] torch.profiler, a whole window of '
                f'{PROFILED_FORWARDS} forwards: device busy {busy:.4f} ms per '
                f'forward of a {prof_ms:.4f} ms wall (CUDA events over the '
                f'same forwards), idle share {res["device_idle_share"]:.4f}; '
                f'busy / unprofiled forward '
                f'{res["busy_over_timed_forward"]:.4f}')
            for name, t, n in rows[:12]:
                log(f'[{kind}]   {t:.4f} ms  x{n:g}  {name[:90]}')
            log(json.dumps({'metric': 'gcn_inference_fwd', 'arm':
                            'sparse-f32', 'ms': ms,
                            'edges_per_s': res['edges_per_s'],
                            'nodes': N_NODES, 'edges': N_EDGES,
                            'hidden': WIDTH, 'iters': iters}))
            cap, cap_out = captured_serving(
                torch, 'serving GCN captured', lambda x: model(x, ei, **kw),
                x, out, iters, warmup, {'segment_spmm': N_LAYERS})
            cap['max_abs_diff_vs_cpu'], cap['argmax_agreement'] = compare(
                torch, 'serving GCN captured', cap_out, ref)
            res['captured'] = cap
        results[kind] = res
    return results


PROFILED_FORWARDS = 5
PROFILE_ATTEMPTS = 6


def device_kernels(torch, fn, calls, warm=False):
    """Device time per call by kernel name, from ``torch.profiler`` over
    ``calls`` calls of ``fn``, and the wall per call over the same calls
    (CUDA events): ``([(name, ms, launches), ...], wall_ms)``, longest
    first; ``None`` when the trace holds no device time. With ``warm``, a
    first window of ``calls`` calls runs under the profiler's warm-up
    stage and only the second window is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    windows = 2 if warm else 1
    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for _ in range(windows):
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            if warm:
                prof.step()
    rows = trace_rows(prof, calls)
    return None if rows is None else (rows, start.elapsed_time(end) / calls)


def trace_rows(prof, calls):
    """A finished profile's device time per call by kernel name:
    ``[(name, ms, launches), ...]`` over ``calls`` calls, longest first;
    ``None`` when the trace holds no device time."""
    from torch.autograd import DeviceType
    total, count = {}, {}
    for ev in prof.events():
        # a user annotation on the device timeline (the optimizer's
        # Optimizer.step range, the schedule's ProfilerStep#) spans kernels
        # that are counted already
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, 'is_user_annotation', False)
                and not ev.name.startswith('ProfilerStep')):
            total[ev.name] = total.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us()
            count[ev.name] = count.get(ev.name, 0) + 1
    if not total:
        log('[profile] the trace holds no device time')
        return None
    return sorted(((k, v / 1e3 / calls, count[k] / calls)
                   for k, v in total.items()), key=lambda r: -r[1])


def profile_forwards(torch, fwd, expect=None):
    """``(rows, wall_ms, forwards_run)`` over a whole window of
    ``PROFILED_FORWARDS`` forwards (``whole_window``)."""
    return whole_window(torch, fwd, PROFILED_FORWARDS, expect)


# -- phase 6 ------------------------------------------------------------------
def timed_calls(torch, fn, iters, warmup):
    """``warmup`` then ``iters`` back-to-back calls of ``fn``: (ms per call
    on the card's clock (CUDA events), host ms to issue one, host seconds
    until the calls finished, the last call's result). Where one call's
    device work is shorter than the host's time to issue it, the card's
    clock measures the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return start.elapsed_time(end) / iters, enqueue_ms, wall_s, out


def launches_of(rows, part):
    """Launches per call of the kernels whose name holds ``part``."""
    return sum(n for name, _, n in rows if part in name)


def whole_window(torch, fn, calls, expect=None, warm=True):
    """Device time per call by kernel name over one whole profiled window
    of ``calls`` calls of ``fn``: ``(rows, wall_ms, calls_run)``, rows as
    ``device_kernels`` gives them, ``calls_run`` every call of ``fn`` made
    here, warm-up windows included.

    The profiler now and then loses device events: a whole window, or some
    launches of a kernel (up to half the calls of a window), which would
    understate the time. Each window follows a warm-up window, unless
    ``warm`` is false (for a call of tens of seconds, whose start-up is
    lost in it; ``expect`` then guards the window). A window
    whose launches of every kernel are a whole multiple of ``calls`` (and,
    for each name part in ``expect``, the launches per call it gives) is
    taken as it is; otherwise it is profiled again, up to
    ``PROFILE_ATTEMPTS`` windows. If none is whole, each kernel counts its
    recorded mean time per launch times its launches per call,
    ``ceil(recorded / calls)``: right while fewer than ``calls`` of its
    launches are lost. A window that reads more device time than its wall
    is profiled again too."""
    est, run = None, 0
    for _ in range(PROFILE_ATTEMPTS):
        got = device_kernels(torch, fn, calls, warm=warm)
        run += (2 if warm else 1) * calls
        if got is None:
            continue
        rows, wall = got
        lost = [(name, n) for name, _, n in rows
                if abs(n - round(n)) >= 1e-9]
        rows = [(name, t / n * math.ceil(n - 1e-9), math.ceil(n - 1e-9))
                for name, t, n in rows]
        window = sum(t for _, t, _ in rows)
        if window > 1.05 * wall:
            # a window that lost launches can also misread the rest
            log(f'[profile] a window read {window:.4f} ms of device time per '
                f'call against a {wall:.4f} ms wall; profiled again')
            continue
        lost += [(part, launches_of(rows, part))
                 for part, n in (expect or {}).items()
                 if launches_of(rows, part) != n]
        est = rows, wall
        if not lost:
            return rows, wall, run
        log('[profile] a window lost launches: ' + ', '.join(
            f'{name[:40]} x{n:g}' for name, n in lost))
    check(est is not None, 'the profiler saw no device time within the '
                           f'wall in {PROFILE_ATTEMPTS} windows')
    log(f'[profile] no whole window in {PROFILE_ATTEMPTS}: lost launches '
        'counted at their recorded mean time')
    for part, n in (expect or {}).items():
        check(launches_of(est[0], part) == n,
              f'{part}: {launches_of(est[0], part)} launches per call in '
              f'the profile, expected {n}')
    return est[0], est[1], run


def device_ms(torch, fn, calls=100):
    """Device time per call: the summed time of every kernel one call runs,
    from ``torch.profiler`` over a whole window (``whole_window``); host
    issue time and gaps are not in it."""
    rows, _, _ = whole_window(torch, fn, calls)
    return sum(t for _, t, _ in rows)


def phase_timings(torch, seed):
    """Per serving shape (F = 128 and 16): kernel 1, its plain version and
    ``torch.sparse.mm`` on a CSR tensor (a yardstick the port never calls),
    each on the same inputs, L2 warm as in a forward (``segment_timed``);
    then the lane-group sweep at F = 16 (``plan_sweep``)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    x_np, coo, w_np = serving_graph(seed)
    ei = EdgeIndex(coo, (N_NODES, N_NODES), device='cuda').fill_cache()
    csc = ei.csc
    w = torch.as_tensor(w_np, device='cuda')[csc.perm].contiguous()
    shapes = []
    with torch.inference_mode():
        for f in (WIDTH, N_OUT):
            x = torch.as_tensor(x_np[:, :f].copy(), device='cuda')
            shapes.append(segment_timed(torch, f'serving F={f}', csc.indptr,
                                        csc.indices, w, x))
        sweep = plan_sweep(torch, f'serving F={N_OUT}', csc.indptr,
                           csc.indices, w, x)
    return shapes, sweep


# -- training graphs ----------------------------------------------------------
def gcn_norm_np(coo, n):
    """``bench.py``'s host-side D^-1/2 (A+I) D^-1/2 (``bench.py:44-57``):
    one self loop appended per node, degrees over destinations."""
    loops = np.arange(n, dtype=coo.dtype)
    row = np.concatenate([coo[0], loops])
    col = np.concatenate([coo[1], loops])
    deg = np.bincount(col, minlength=n).astype(np.float64)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return np.stack([row, col]), (dinv[row] * dinv[col]).astype(np.float32)


def path_b_graph(kind, seed):
    """``bench.py``'s graph (``bench.py:61-77``): x, a random COO and
    labels from ``seed``; GCN gets the host-normalised weights, GraphSAGE
    and GIN unit weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((PB_NODES, TR_F)).astype(np.float32)
    coo = rng.integers(0, PB_NODES, (2, PB_EDGES)).astype(np.int32)
    y = rng.integers(0, TR_CLASSES, PB_NODES)
    if kind == 'GCN':
        coo, w = gcn_norm_np(coo, PB_NODES)
    else:
        w = np.ones(PB_EDGES, np.float32)
    return x, coo, w, y


def path_a_graph(seed):
    """``benchmarks/spmm_bench.py``'s clustered generator (``:103-114``):
    communities of ``PA_CLUSTER`` nodes, 90 % of the edges inside one; then
    x and labels from the same generator."""
    rng = np.random.default_rng(seed)
    n, e, cs = PA_NODES, PA_EDGES, PA_CLUSTER
    comm = rng.integers(0, max(n // cs, 1), e)
    intra = rng.random(e) < 0.9
    s_loc = comm * cs + rng.integers(0, cs, e)
    d_loc = comm * cs + rng.integers(0, cs, e)
    s_rnd = rng.integers(0, n, e)
    d_rnd = rng.integers(0, n, e)
    coo = np.stack([np.where(intra, s_loc, s_rnd),
                    np.where(intra, d_loc, d_rnd)])
    coo = np.minimum(coo, n - 1).astype(np.int32)
    x = rng.standard_normal((n, TR_F)).astype(np.float32)
    y = rng.integers(0, TR_CLASSES, n)
    return coo, x, y


def build_path_a(torch, seed, bf16=False):
    """Path A's cache (path E's with ``bf16``), built on the card:
    ``cache_gcn_norm(EdgeIndex(coo), block_sparse=True)`` as
    ``spmm_bench.py:128-130`` forces it, the blocks bf16 under ``--bf16``."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    tag = 'path E' if bf16 else 'path A'
    coo, x, y = path_a_graph(seed)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ei = cache_gcn_norm(EdgeIndex(coo, (PA_NODES, PA_NODES)),
                        block_sparse=True,
                        cache_dtype=torch.bfloat16 if bf16 else None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    regime = spmm_regime(ei, TR_F)
    check(regime == 'bsr', f'{tag} runs the {regime!r} regime, not bsr')
    check(ei.bsr_perm is None, f'{tag}: an unexpected relabel')
    want = torch.bfloat16 if bf16 else torch.float32
    check(ei.bsr.vals.dtype == want and ei.bsr_t.vals.dtype == want,
          f'{tag}: blocks are {ei.bsr.vals.dtype}')
    nb = int(ei.bsr.vals.shape[0])
    layout_bytes = sum(t.numel() * t.element_size()
                       for layout in (ei.bsr, ei.bsr_t) for t in layout)
    info = {'nodes': PA_NODES, 'edges_after_self_loops': ei.num_edges,
            'blocks': nb, 'block_dtype': str(want),
            'residual_edges': ei.bsr_res.num_edges,
            'captured_frac': 1 - ei.bsr_res.num_edges / ei.num_edges,
            'block_layouts_gb': layout_bytes / 1e9,
            'cache_gb_on_card': (torch.cuda.memory_allocated() - mem0) / 1e9,
            'build_s': build_s, 'regime': regime}
    log(f'[{tag}] cache_gcn_norm(block_sparse=True'
        f"{', cache_dtype=torch.bfloat16' if bf16 else ''}) of {PA_NODES} "
        f'nodes, {PA_EDGES} edges in {build_s:.3f} s (host numpy keys, block '
        f'sums and transpose on the card): E = {ei.num_edges} with self '
        f'loops, {nb} blocks of 128x128 {want}, {info["residual_edges"]} '
        f'residual edges (captured {info["captured_frac"]:.4f}), both block '
        f'layouts {info["block_layouts_gb"]:.3f} GB, the whole cache '
        f'{info["cache_gb_on_card"]:.3f} GB on the card; regime {regime!r}')
    return {'coo': coo, 'x': x, 'y': y, 'ei': ei, 'info': info}


# -- phase 3, the block-sparse kernel and the segment-sum backward ------------
def bsr_close(torch, layout, x, num_out):
    """The kernel against its plain version on one layout; returns the max
    abs error. Tolerance as for the segment-sum kernel."""
    from pytorch_geometric_tpu_torch.ops.bsr_spmm import (bsr_matmul,
                                                          bsr_spmm_plain)
    out = bsr_matmul(layout, x, num_out)
    torch.cuda.synchronize()
    ref = bsr_spmm_plain(layout, x, num_out)
    scale = bsr_spmm_plain(layout._replace(vals=layout.vals.abs()), x.abs(),
                           num_out)
    err = (out - ref).abs()
    ok = bool((err <= 1e-5 + 1e-5 * scale).all())
    del ref, scale
    return (float(err.max()) if err.numel() else 0.0), ok


def phase_bsr_vs_plain(torch, seed, pa, bf16=False):
    """The BSR kernel against its plain version: F in {1, 10, 16, 64, 128}
    on a rectangular graph whose sizes are not multiples of 128, with empty
    block rows and padded edges, on both layouts; then path A's layouts at
    F = 64 and 10. With ``bf16`` the tensor-core arm: the same cases with
    bf16 blocks, and path E's layouts (``pa`` is path E's cache). Both arms
    multiply exactly in float32, so both take the float32 row-scaled
    limit."""
    from pytorch_geometric_tpu_torch.ops.bsr_spmm import build_bsr_pair
    rng = np.random.default_rng(seed + 2)
    n_src, n_dst, e = 1000, 1300, 60_000
    c = rng.integers(0, n_dst // 128 + 1, e)
    coo = np.stack([np.clip(c * 128 + rng.integers(0, 128, e), 0, n_src - 1),
                    np.clip(c * 128 + rng.integers(0, 128, e), 0,
                            n_dst - 1)])
    coo = np.concatenate([coo, rng.integers(0, n_src, (2, 500))], 1)
    coo = coo[:, (coo[1] // 128) % 4 != 2]       # empty dst block rows
    coo = np.concatenate([coo, [[n_src] * 16, [n_dst] * 16]], 1).astype(
        np.int32)                                 # padded edges
    w = rng.random(coo.shape[1]).astype(np.float32)
    fwd, bwd, _ = build_bsr_pair(coo, w, n_src, n_dst, device='cuda')
    check(bool((torch.diff(fwd.row_ptr) == 0).any()),
          'phase 3 BSR case has no empty block row')
    if bf16:
        fwd = fwd._replace(vals=fwd.vals.to(torch.bfloat16))
        bwd = bwd._replace(vals=bwd.vals.to(torch.bfloat16))
    name, path = ('bsr_spmm bf16', 'path E') if bf16 else ('bsr_spmm',
                                                           'path A')
    cases = []
    for f in (1, 10, 16, 64, 128):
        cases.append((f'rectangular {n_src}->{n_dst} F={f}', fwd,
                      rng.standard_normal((n_src, f)), n_dst))
        cases.append((f'rectangular {n_src}->{n_dst} F={f} transposed', bwd,
                      rng.standard_normal((n_dst, f)), n_src))
    ei = pa['ei']
    for f in (TR_F, TR_CLASSES):
        cases.append((f'{path} N={PA_NODES} F={f}', ei.bsr,
                      pa['x'][:, :f], PA_NODES))
        cases.append((f'{path} N={PA_NODES} F={f} transposed', ei.bsr_t,
                      rng.standard_normal((PA_NODES, f)), PA_NODES))
    worst = 0.0
    for label, layout, x, num_out in cases:
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                             device='cuda')
        err, ok = bsr_close(torch, layout, xt, num_out)
        worst = max(worst, err)
        log(f"[kernel] {name} {label}: max abs err {err:.3e} "
            f"{'ok' if ok else 'FAILED'}")
        check(ok, f'{name} disagrees with its plain version: {label}')
    return worst


def segment_backward_cases(torch, seed, pa):
    """(label, EdgeIndex on the card, COO weights) at the serving, path-A
    residual and path-B shapes, each with the widths its passes take."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    _, coo, w_np = serving_graph(seed)
    serving = EdgeIndex(coo, (N_NODES, N_NODES), device='cuda').fill_cache()
    _, coo_b, w_b, _ = path_b_graph('GCN', seed)
    path_b = EdgeIndex(coo_b, (PB_NODES, PB_NODES),
                       device='cuda').fill_cache()
    res = pa['ei'].bsr_res
    return [(f'serving N={N_NODES}', serving,
             torch.as_tensor(w_np, device='cuda'), (WIDTH, N_OUT)),
            (f'path A residual E={res.num_edges}', res, res.weight,
             (TR_F, TR_CLASSES)),
            (f'path B N={PB_NODES}', path_b,
             torch.as_tensor(w_b, device='cuda'), (TR_F, TR_CLASSES))]


def phase_segment_backward_vs_plain(torch, seed, pa):
    """The segment-sum kernel through its autograd Function (forward over
    the CSC, ``grad_x`` over the CSR) against the plain version's autograd
    on the same inputs. Tolerance: 1e-5 + 1e-5 of each row's sum of |w * x|
    (forward) or |w * g| (backward) terms."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_plain)
    rng = np.random.default_rng(seed + 3)
    worst = 0.0
    for label, ei, w, widths in segment_backward_cases(torch, seed, pa):
        csc, csr = ei.csc, ei.csr
        w_csc = w[csc.perm].contiguous()
        w_csr = w[csr.perm].contiguous()
        n_src, n_dst = ei.sparse_size
        for f in widths:
            x = torch.as_tensor(rng.standard_normal((n_src, f)).astype(
                np.float32), device='cuda').requires_grad_()
            g = torch.as_tensor(rng.standard_normal((n_dst, f)).astype(
                np.float32), device='cuda')
            out = segment_spmm(csc.indptr, csc.indices, w_csc, x,
                               (csr.indptr, csr.indices, w_csr))
            out.backward(g)
            torch.cuda.synchronize()
            xr = x.detach().clone().requires_grad_()
            ref = segment_spmm_plain(csc.indptr, csc.indices, w_csc, xr)
            ref.backward(g)
            with torch.no_grad():
                fwd_scale = segment_spmm_plain(csc.indptr, csc.indices,
                                               w_csc.abs(), x.abs())
                bwd_scale = segment_spmm_plain(csr.indptr, csr.indices,
                                               w_csr.abs(), g.abs())
                errs = []
                for a, b, scale in ((out, ref, fwd_scale),
                                    (x.grad, xr.grad, bwd_scale)):
                    err = (a - b).abs()
                    errs.append((float(err.max()),
                                 bool((err <= 1e-5 + 1e-5 * scale).all())))
            worst = max(worst, errs[0][0], errs[1][0])
            ok = errs[0][1] and errs[1][1]
            log(f'[kernel] segment_spmm {label} F={f}: forward max abs err '
                f'{errs[0][0]:.3e}, backward grad_x max abs err '
                f"{errs[1][0]:.3e} {'ok' if ok else 'FAILED'}")
            check(ok, f'segment_spmm backward disagrees with the plain '
                      f'version: {label} F={f}')
    return worst


# -- phases 7 and 8, training -------------------------------------------------
def train_model(torch, kind, device, seed):
    """``bench.py``'s model for ``kind``, weights from ``seed``."""
    from pytorch_geometric_tpu_torch.nn.models import GCN, GIN, GraphSAGE
    g = torch.Generator().manual_seed(seed)
    if kind == 'GCN':
        return GCN(TR_F, TR_HIDDEN, TR_LAYERS, TR_CLASSES, device=device,
                   generator=g, conv_kwargs={'normalize': False,
                                             'add_self_loops': False})
    cls = {'GraphSAGE': GraphSAGE, 'GIN': GIN}[kind]
    return cls(TR_F, TR_HIDDEN, TR_LAYERS, TR_CLASSES, device=device,
               generator=g)


def from_state(torch, build, state):
    """``build()`` (a model on the card) with the weights ``state``."""
    model = build()
    model.load_state_dict({k: v.cuda() for k, v in state.items()})
    return model


def train_step(torch, model, opt, x, ei, y, **kw):
    """One full-batch step as ``bench.py`` runs it: softmax cross-entropy,
    mean over the nodes, backward, Adam. Returns the loss, on the device."""
    opt.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(model(x, ei, **kw), y)
    loss.backward()
    opt.step()
    return loss


def grads_of(torch, model):
    """A copy of every parameter's gradient; zeros for a parameter the
    loss does not reach (HGT's layer 2 serves every node type, the loss
    reads one)."""
    return {k: (torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone())
            for k, p in model.named_parameters()}


def parity_run(torch, kind, state, x, ei, y, device, **kw):
    """``PARITY_STEPS`` steps from ``state``: the losses and the first
    step's gradients."""
    model = train_model(torch, kind, device, 0)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    opt = torch.optim.Adam(model.parameters(), lr=TR_LR)
    losses, grads = [], None
    for i in range(PARITY_STEPS):
        losses.append(train_step(torch, model, opt, x, ei, y, **kw).item())
        if i == 0:
            grads = {k: g.cpu() for k, g in grads_of(torch, model).items()}
    return losses, grads


def check_parity(torch, tag, card, cpu, grads_too, tol=1e-4, cancelled=(),
                 own_tol=None):
    """Losses within ``tol`` relative at each step, first-step gradients
    within ``tol`` of each parameter's own largest magnitude. A parameter
    whose name ends in one of ``cancelled`` (a gradient the model cancels
    exactly, rounding noise on both devices) is held within ``tol`` of the
    largest gradient of all instead. With ``own_tol`` (a model that is not
    smooth, ``flash_parity``) every other gradient is held within ``tol``
    of the largest gradient of all and within ``own_tol`` of its own
    largest. Every gradient's gap is logged before any is checked."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(l_card, l_cpu)]
    log(f'[{tag}] losses over {PARITY_STEPS} steps, card {l_card} vs CPU '
        f'plain path {l_cpu}: max relative diff {max(rel):.3e} (limit '
        f'{tol:g})')
    check(max(rel) <= tol, f'{tag}: losses differ from the CPU plain path '
                           f'by {max(rel)} relative')
    out = {'losses_card': l_card, 'losses_cpu': l_cpu,
           'max_loss_rel_diff': max(rel)}
    if grads_too:
        worst = 0.0
        largest = max(float(r.abs().max()) for r in g_cpu.values())
        gaps = {k: float((g_card[k] - ref).abs().max())
                / max(float(ref.abs().max()), 1e-30)
                for k, ref in g_cpu.items()}
        log(f'[{tag}] first-step gradient gaps, of each tensor\'s largest '
            '(the tensor\'s largest over the largest of all; * cancelled): '
            + ', '.join(
                f'{k}{"*" if k.endswith(tuple(cancelled)) else ""} {v:.3e} '
                f'({float(g_cpu[k].abs().max()) / largest:.1e})'
                for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])))
        for k, ref in g_cpu.items():
            d = float((g_card[k] - ref).abs().max())
            own = float(ref.abs().max())
            if k.endswith(tuple(cancelled)):
                scale = largest
            elif own_tol is not None:
                scale = min(largest, own_tol / tol * own)
            else:
                scale = own
            lim = tol * scale
            worst = max(worst, d / max(scale, 1e-30))
            check(d <= lim, f'{tag}: first-step gradient of {k} differs by '
                            f'{d} (limit {lim})')
        log(f'[{tag}] first-step gradients: max |card - CPU| / max|CPU| '
            f'{worst:.3e} over {len(g_cpu)} tensors')
        out['max_grad_rel_diff'] = worst
    return out


def profile_steps(torch, step, tag, expect=None):
    """A whole window of ``PROFILED_STEPS`` steps (``whole_window``): the
    profile's record and the steps run."""
    rows, wall, run = whole_window(torch, step, PROFILED_STEPS, expect)
    busy = sum(t for _, t, _ in rows)
    check(busy <= 1.05 * wall, f'{tag}: device busy {busy} ms exceeds the '
                               f'wall {wall} ms of the same steps')
    log(f'[{tag}] torch.profiler, a whole window of {PROFILED_STEPS} steps: '
        f'device busy {busy:.4f} ms per step of a {wall:.4f} ms wall (CUDA '
        f'events over the same steps), idle share {1 - busy / wall:.4f}')
    for name, t, n in rows[:10]:
        log(f'[{tag}]   {t:.4f} ms  x{n:g}  {name[:90]}')
    return {'device_busy_ms_per_step': busy, 'profiled_ms_per_step': wall,
            'device_idle_share': 1 - busy / wall,
            'kernel2_ms_per_step': sum(t for name, t, _ in rows
                                       if BSR_PREP in name
                                       or BSR_MAIN in name),
            'kernel2_prep_ms_per_step': sum(t for name, t, _ in rows
                                            if BSR_PREP in name),
            'kernel1_ms_per_step': sum(t for name, t, _ in rows
                                       if SEG_MAIN in name),
            'mix_ms_per_step': sum(t for name, t, _ in rows
                                   if MIX_KERNEL in name),
            'edge_dot_ms_per_step': sum(t for name, t, _ in rows
                                        if EDGE_DOT_KERNEL in name
                                        or EDGE_DOT_COMBINE in name),
            'add_launches_per_step': launches_of(rows, ADD),
            # out + res, and autograd's sum of two gradients, are adds of
            # two same-shape tensors: PyTorch's vectorised kernel
            'same_shape_add_launches_per_step': sum(
                n for name, _, n in rows if ADD in name
                and 'vectorized_elementwise_kernel' in name),
            'kernels_per_step': [[name[:80], t, n] for name, t, n in rows[:8]]
            }, run


def timed_steps(torch, step, warmup, steps):
    """:func:`timed_calls` over training steps: (ms per step on the card's
    clock, host seconds for the steps, host ms to issue one step, the last
    loss), which must be finite."""
    ms, enqueue_ms, wall_s, loss = timed_calls(torch, step, steps, warmup)
    check(bool(torch.isfinite(loss)), 'non-finite loss')
    return ms, wall_s, enqueue_ms, loss.item()


def ei_to_cpu(torch, ei):
    """A copy of an EdgeIndex and every cache it holds on the CPU."""
    from pytorch_geometric_tpu_torch import EdgeIndex

    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if isinstance(v, EdgeIndex):
            return ei_to_cpu(torch, v)
        if isinstance(v, tuple):
            vals = [mv(a) for a in v]
            return type(v)(*vals) if hasattr(v, '_fields') else tuple(vals)
        return v

    names = ('csr', 'csc', 'weight', 'bsr', 'bsr_t', 'bsr_res', 'bsr_perm',
             'bsr_inv', 'blocked', 'blocked_t', 'dense_adj', 'dense_scale',
             'win', 'win_t')
    return EdgeIndex(ei.coo.cpu(), ei.sparse_size,
                     num_real_edges=ei.num_real_edges, device='cpu',
                     **{k: mv(getattr(ei, k)) for k in names})


def phase_path_a(torch, seed, pa, bf16=False):
    """GCN training over the block cache: path A (float32 blocks), or with
    ``bf16`` path E (bf16 blocks through the tensor-core arm). Path A is
    held against the CPU plain segment sum over all the edges; path E
    against the CPU plain path over the same bf16 cache, within 1e-3 (bf16
    roundings of a layer's input flip where the card's and the CPU's
    float32 sums differ in the last bit)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    tag = 'path E' if bf16 else 'path A'
    ei = pa['ei']
    x = torch.as_tensor(pa['x'], device='cuda')
    y = torch.as_tensor(pa['y'], device='cuda')
    model = train_model(torch, 'GCN', None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TR_LR)

    def step():
        return train_step(torch, model, opt, x, ei, y)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    ms, _, enqueue_ms, last = timed_steps(torch, step, PA_WARMUP, PA_STEPS)
    prof, prof_steps = profile_steps(torch, step, tag)
    counts = launch_counts()
    n_steps = PA_WARMUP + PA_STEPS + prof_steps
    bsr_key = 'bsr_spmm_bf16' if bf16 else 'bsr_spmm'
    launches = {bsr_key: counts[bsr_key],
                'segment_spmm': counts['segment_spmm']}
    log(f'[{tag}] GCN training step over the BSR cache: {ms:.4f} ms per '
        f'step on the card (CUDA events, {PA_STEPS} steps after '
        f'{PA_WARMUP} warm-up); the host issues one in {enqueue_ms:.4f} ms; '
        f'loss after {PA_WARMUP + PA_STEPS} steps {last:.6f}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
    log(f'[{tag}] launches in {n_steps} steps: {counts}')
    log(f"[{tag}] kernel 2 (pre-pass and kernel) "
        f"{prof['kernel2_ms_per_step']:.4f} ms of the "
        f"{prof['device_busy_ms_per_step']:.4f} ms busy per step (share "
        f"{prof['kernel2_ms_per_step'] / prof['device_busy_ms_per_step']:.4f}"
        f"), its pre-pass {prof['kernel2_prep_ms_per_step']:.4f} ms; kernel "
        f"1 (the residual onto the block product) "
        f"{prof['kernel1_ms_per_step']:.4f} ms; {ADD} launches per step "
        f"{prof['add_launches_per_step']:g}, of two same-shape tensors "
        f"{prof['same_shape_add_launches_per_step']:g}")
    # the residual's sum lands on the block product inside kernel 1, and
    # the backward's two gradient parts are one pass too: no separate add
    check(prof['same_shape_add_launches_per_step'] == 0,
          f"{tag}: {prof['same_shape_add_launches_per_step']} same-shape "
          f'{ADD} launches per step; the residual add should be in kernel 1')
    check_counts(tag, counts, {k: PASSES_PER_STEP * n_steps
                               for k in launches}, f'{n_steps} steps')
    card = parity_run(torch, 'GCN', state, x, ei, y, 'cuda')
    t0 = time.perf_counter()
    if bf16:
        ei_cpu = ei_to_cpu(torch, ei)
        check(spmm_regime(ei_cpu) == 'bsr', f'{tag} CPU reference regime')
    else:
        ei_cpu = cache_gcn_norm(EdgeIndex(pa['coo'], (PA_NODES, PA_NODES),
                                          device='cpu'), block_sparse=False)
        check(spmm_regime(ei_cpu) == 'plain', f'{tag} CPU reference regime')
    cpu = parity_run(torch, 'GCN', state, torch.from_numpy(pa['x']),
                     ei_cpu, torch.from_numpy(pa['y']), 'cpu')
    log(f'[{tag}] CPU plain path ('
        + ('the same bf16 blocks and residual' if bf16 else
           f'segment sum over all {ei_cpu.num_edges} edges')
        + f') for {PARITY_STEPS} steps in {time.perf_counter() - t0:.1f} s')
    del ei_cpu
    res = {'ms_per_step': ms, 'host_enqueue_ms_per_step': enqueue_ms,
           'steps': n_steps, 'launches': launches, 'launch_counts': counts,
           'launches_per_step': {k: v / n_steps for k, v in launches.items()},
           'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
           'cache': pa['info']}
    res.update(prof)
    res['parity'] = check_parity(torch, tag, card, cpu, True,
                                 tol=1e-3 if bf16 else 1e-4)
    cap = captured_training(
        torch, f'{tag} captured', lambda: from_state(
            torch, lambda: train_model(torch, 'GCN', None, seed), state),
        x, ei, y, None, {k: PASSES_PER_STEP for k in launches}, PA_STEPS,
        1e-3 if bf16 else 1e-4)
    check(cap['same_shape_add_launches_per_step'] == 0,
          f"{tag} captured: {cap['same_shape_add_launches_per_step']} "
          f'same-shape {ADD} launches per step')
    res['captured'] = cap
    log(json.dumps({'metric': 'gcn_train_step_bsr_bf16' if bf16 else
                    'gcn_train_step_bsr', 'ms': ms,
                    'ms_captured': cap['ms_per_step'],
                    'nodes': PA_NODES, 'edges': PA_EDGES,
                    'blocks': pa['info']['blocks'],
                    'residual_edges': pa['info']['residual_edges']}))
    return res


def phase_path_b(torch, seed):
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    results = {}
    for kind in ('GCN', 'GraphSAGE', 'GIN'):
        x_np, coo, w_np, y_np = path_b_graph(kind, seed)
        # bench.py's CPU branch (bench.py:87-90): no baked cache, GCN's
        # weights passed per call, GraphSAGE and GIN unweighted
        ei = EdgeIndex(coo, (PB_NODES, PB_NODES)).fill_cache()
        kw = ({'edge_weight': torch.as_tensor(w_np, device='cuda')}
              if kind == 'GCN' else {})
        reduce = 'mean' if kind == 'GraphSAGE' else 'sum'
        check(spmm_regime(ei, TR_F, reduce, bool(kw)) == 'kernel',
              f'path B {kind}: regime {spmm_regime(ei, TR_F, reduce)!r}')
        x = torch.as_tensor(x_np, device='cuda')
        y = torch.as_tensor(y_np, device='cuda')
        model = train_model(torch, kind, None, seed)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        opt = torch.optim.Adam(model.parameters(), lr=TR_LR)

        def step():
            return train_step(torch, model, opt, x, ei, y, **kw)

        torch.cuda.synchronize()
        reset_counts()
        ms, wall_s, enqueue_ms, last = timed_steps(torch, step, 2, PB_STEPS)
        prof, prof_steps = profile_steps(torch, step, f'path B {kind}')
        n_steps = 2 + PB_STEPS + prof_steps
        counts = launch_counts()
        launches = {'segment_spmm': counts['segment_spmm'],
                    'bsr_spmm': counts['bsr_spmm']}
        check_counts(f'path B {kind}', counts,
                     {'segment_spmm': PASSES_PER_STEP * n_steps},
                     f'{n_steps} steps')
        log(f'[path B {kind}] {PB_STEPS} steps in {wall_s:.4f} s on the '
            f'host clock ({ms:.4f} ms per step on the card, the host issues '
            f'one in {enqueue_ms:.4f} ms; bench.py reference eager '
            f'{REFERENCE_EAGER_S[kind]} s on an unspecified GPU); final '
            f'loss {last:.6f}; launches {launches} in {n_steps} steps')
        card = parity_run(torch, kind, state, x, ei, y, 'cuda', **kw)
        ei_cpu = EdgeIndex(coo, (PB_NODES, PB_NODES),
                           device='cpu').fill_cache()
        cpu = parity_run(torch, kind, state, torch.from_numpy(x_np), ei_cpu,
                         torch.from_numpy(y_np), 'cpu',
                         **{k: v.cpu() for k, v in kw.items()})
        res = {'seconds_per_500_steps': wall_s, 'ms_per_step': ms,
               'host_enqueue_ms_per_step': enqueue_ms, 'steps': n_steps,
               'launches': launches, 'launch_counts': counts,
               'launches_per_step': launches['segment_spmm'] / n_steps}
        res.update(prof)
        res['parity'] = check_parity(torch, f'path B {kind}', card, cpu,
                                     False)
        cap = captured_training(
            torch, f'path B {kind} captured', lambda: from_state(
                torch, lambda: train_model(torch, kind, None, seed), state),
            x, ei, y, kw.get('edge_weight'),
            {'segment_spmm': PASSES_PER_STEP}, PB_STEPS, 1e-4)
        res['captured'] = cap
        for mode, secs in (('eager', wall_s),
                           ('captured', cap['seconds_for_steps'])):
            log(json.dumps(bench_line(torch, kind, secs, mode, 'sparse-f32',
                                      1.5 * PB_EDGES * TR_F * 4
                                      + PB_NODES * TR_F * 4 + PB_EDGES * 4)))
        results[kind] = res
    return results


def bench_line(torch, kind, secs, mode, adj, pass_bytes):
    """``bench.py``'s one-line JSON (``bench.py:150-175``) for ``secs``
    per 500 steps: its byte count per SpMM pass, 5 passes a step, the rate
    against the H100's 3.35 TB/s (not the v5e's 819 GB/s of
    ``bench.py:172``), and ``vs_baseline`` against ``BASELINE.md:11-13``'s
    eager seconds (``vs_baseline_compiled``: its compiled ones)."""
    gbps = PASSES_PER_STEP * PB_STEPS * pass_bytes / 1e9 / secs
    return {'metric': f'{BENCH_NAMES[kind]}_train_500steps', 'value': secs,
            'unit': 's', 'vs_baseline': REFERENCE_EAGER_S[kind] / secs,
            'vs_baseline_compiled': REFERENCE_COMPILED_S[kind] / secs,
            'backend': 'cuda', 'mode': mode,
            'edges_per_s': PASSES_PER_STEP / 2 * PB_STEPS * PB_EDGES / secs,
            'spmm_gbps': gbps,
            'pct_roofline': 100 * gbps / (HBM_BYTES_PER_S / 1e9),
            'adj_dtype': adj, 'device': torch.cuda.get_device_name(0)}


# -- phase 9, training-kernel timings -----------------------------------------
def bsr_bound_ms(nb, nnz, n_row_blocks, n_src, num_out, f, val_bytes=4,
                 flop_rate=F32_FLOP_PER_S):
    """Least time for one BSR pass: the blocks (``val_bytes`` a value),
    their column ids and row pointer, x and out (float32) once over the HBM
    rate, or the FLOPs this data needs, ``2 * nnz * F`` over the blocks'
    ``nnz`` nonzeros (not the stored zeros), over ``flop_rate`` (the f32
    rate, or the bf16 tensor-core rate for bf16 blocks), whichever is
    larger."""
    by = (nb * 128 * 128 * val_bytes + nb * 4 + (n_row_blocks + 1) * 4
          + (n_src + num_out) * f * 4)
    t_bytes = by / HBM_BYTES_PER_S
    t_ops = 2.0 * nnz * f / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations', by)


def bsr_library_call(torch, layout, n_src, x):
    """``torch.sparse.mm`` on a BSR tensor of the same blocks (a yardstick;
    the port never calls it): ``(fn, None)`` or ``(None, error)``."""
    d_blocks = layout.row_ptr.shape[0] - 1
    s_blocks = (n_src + 127) // 128
    xp = x.new_zeros((s_blocks * 128, x.shape[1]))
    xp[:n_src] = x
    try:
        a = torch.sparse_bsr_tensor(layout.row_ptr, layout.cols, layout.vals,
                                    size=(d_blocks * 128, s_blocks * 128))
        out = torch.sparse.mm(a, xp)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f'{type(e).__name__}: {str(e)[:200]}'
    return (lambda: torch.sparse.mm(a, xp)), out


def phase_training_timings(torch, seed, pa):
    """Device time per call of the BSR kernel (both layouts, F = 64 and 10,
    path A's shapes) and of kernel 1 (``segment_timed``): path B's GCN
    graph forward (CSC) and ``A^T g`` (CSR) at F = 64 and 10, and path A's
    residual, forward and backward at F = 64 and 10 with a base (its
    yardstick ``torch.addmm``: the base plus the CSR product in one call);
    beside the plain version, a library call and the bound. Then kernel 1's
    lane-group sweep at path B's forward shapes and the residual's F =
    64."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops.bsr_spmm import (bsr_matmul,
                                                          bsr_spmm_plain)
    rng = np.random.default_rng(seed + 4)
    ei = pa['ei']
    bsr_rows = []
    with torch.inference_mode():
        for lay_name, layout in (('forward', ei.bsr),
                                 ('transposed', ei.bsr_t)):
            nb = int(layout.vals.shape[0])
            nnz = int(torch.count_nonzero(layout.vals))
            for f in (TR_F, TR_CLASSES):
                x = torch.as_tensor(rng.standard_normal(
                    (PA_NODES, f)).astype(np.float32), device='cuda')
                b_ms, b_by, by = bsr_bound_ms(
                    nb, nnz, layout.row_ptr.shape[0] - 1, PA_NODES, PA_NODES,
                    f)
                row = {'layout': lay_name, 'F': f, 'blocks': nb,
                       'block_nonzeros': nnz,
                       'bound_ms': b_ms, 'bound_by': b_by, 'bytes': by,
                       'flops': 2.0 * nnz * f,
                       'kernel_flops': 2.0 * nb * 128 * 128 * f}
                fns = {'ms': lambda: bsr_matmul(layout, x, PA_NODES),
                       'plain_ms': lambda: bsr_spmm_plain(layout, x,
                                                          PA_NODES)}
                lib, lib_out = bsr_library_call(torch, layout, PA_NODES, x)
                if lib is None:
                    row['library_ms'] = None
                    row['library_error'] = lib_out
                else:
                    ref = bsr_spmm_plain(layout, x, PA_NODES)
                    check(bool(torch.allclose(lib_out[:PA_NODES], ref,
                                              rtol=1e-4, atol=1e-4)),
                          f'torch.sparse.mm (BSR) disagrees at F={f}')
                    fns['library_ms'] = lib
                bsr_rows.append(bsr_timed(torch, row, fns))
                lib_txt = (f"{row['library_ms']:.4f} ms" if lib else
                           f"none ({row['library_error']})")
                log(f"[timing] bsr_spmm {lay_name} F={f}, device time per "
                    f"call: kernel {row['ms']:.4f} ms (pre-pass "
                    f"{row['prep_ms']:.4f}, kernel proper "
                    f"{row['main_ms']:.4f}; {row['tb_per_s']:.3f} TB/s of "
                    f"the bytes it must move; HGMMA in the SASS: "
                    f"{row['hgmma_in_sass']}), plain "
                    f"{row['plain_ms']:.4f} ms, torch.sparse.mm (BSR) "
                    f"{lib_txt}; bound {b_ms:.4f} ms ({b_by}), kernel at "
                    f"{100 * b_ms / row['ms']:.1f}% of the bound; CUDA-event "
                    f"wall per call: kernel {row['event_ms']:.4f} ms")
        _, coo, w_np, _ = path_b_graph('GCN', seed)
        pb = EdgeIndex(coo, (PB_NODES, PB_NODES), device='cuda').fill_cache()
        w_b = torch.as_tensor(w_np, device='cuda')
        seg_rows = {'path_b': [], 'residual': [], 'sweep': []}
        for lay_name, lay in (('forward', pb.csc), ('backward A^T g', pb.csr)):
            w_l = w_b[lay.perm].contiguous()
            for f in (TR_F, TR_CLASSES):
                x = torch.as_tensor(rng.standard_normal((PB_NODES, f)).astype(
                    np.float32), device='cuda')
                row = segment_timed(torch, f'path B {lay_name} F={f}',
                                    lay.indptr, lay.indices, w_l, x)
                row['pass'] = lay_name
                seg_rows['path_b'].append(row)
                if lay_name == 'forward':
                    seg_rows['sweep'] += plan_sweep(
                        torch, f'path B forward F={f}', lay.indptr,
                        lay.indices, w_l, x)
        # path A's residual, its base the block product: the CSC in the
        # forward, the CSR (grad_x) in the backward
        res = pa['ei'].bsr_res
        for lay_name, lay in (('forward', res.get_csc()),
                              ('backward', res.get_csr())):
            w_l = res.weight[lay.perm].contiguous()
            for f in (TR_F, TR_CLASSES):
                x, base = (torch.as_tensor(rng.standard_normal(
                    (PA_NODES, f)).astype(np.float32), device='cuda')
                    for _ in range(2))
                row = segment_timed(
                    torch, f'path A residual {lay_name} F={f} with base',
                    lay.indptr, lay.indices, w_l, x, base)
                row['pass'] = lay_name
                seg_rows['residual'].append(row)
        csc = res.get_csc()
        seg_rows['sweep'] += plan_sweep(
            torch, f'path A residual forward F={TR_F}', csc.indptr,
            csc.indices, res.weight[csc.perm].contiguous(),
            torch.as_tensor(rng.standard_normal((PA_NODES, TR_F)).astype(
                np.float32), device='cuda'))
    return bsr_rows, seg_rows


def per_step(rows, picks):
    """Sum ``ms``-like keys of ``rows`` over the passes ``picks`` of one
    training step; ``library_ms`` is None when any pass lacks one."""
    out = {}
    for key in ('ms', 'prep_ms', 'plain_ms', 'bound_ms', 'library_ms'):
        vals = [next(r for r in rows if all(r[k] == v for k, v in p.items())
                     ).get(key) for p in picks]
        out[key] = None if any(v is None for v in vals) else sum(vals)
    return out


# -- phases 10 to 13, attention ----------------------------------------------
def build_path_c(torch, seed):
    """Path C's graph and cache: random COO from ``seed`` (as
    ``attention_bench.py`` draws it), one self loop per node added on the
    host by the port's ``add_remaining_self_loops``, then
    ``fill_cache(blocked=True)`` on the card; x and labels from the same
    generator."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.utils import add_remaining_self_loops
    rng = np.random.default_rng(seed)
    n = PC_NODES
    coo = rng.integers(0, n, (2, PC_EDGES)).astype(np.int32)
    coo, _ = add_remaining_self_loops(torch.from_numpy(coo), num_nodes=n)
    coo = coo.numpy()
    x = rng.standard_normal((n, PC_F)).astype(np.float32)
    y = rng.integers(0, PC_CLASSES, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ei = EdgeIndex(coo, (n, n)).fill_cache(blocked=True)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    check(ei.num_edges == PC_EDGES + n, f'path C has {ei.num_edges} edges')
    log(f'[path C] EdgeIndex + fill_cache(blocked=True) of {n} nodes, '
        f'{ei.num_edges} edges (both sorts and slot orders on the card): '
        f'{build_ms:.3f} ms')
    return {'coo': coo, 'x': x, 'y': y, 'ei': ei, 'build_ms': build_ms}


def gat_model(torch, device, seed):
    from pytorch_geometric_tpu_torch.nn.models import GAT
    return GAT(PC_F, PC_HIDDEN, PC_LAYERS, PC_CLASSES, heads=PC_HEADS,
               conv_kwargs={'add_self_loops': False}, device=device,
               generator=torch.Generator().manual_seed(seed))


def mix_close(torch, blk, p_s, p_u, v, f):
    """The mix kernel against its plain version on the same card tensors;
    tolerance 1e-5 + 1e-5 of the row's sum of |p * v| terms (f32 sums in
    another order). Returns (max abs err, ok)."""
    from pytorch_geometric_tpu_torch.ops.gat_fused import (gat_mix,
                                                           gat_mix_plain)
    s, u = gat_mix(blk.indptr, blk.src, p_s, p_u, v, f)
    torch.cuda.synchronize()
    rs, ru = gat_mix_plain(blk.indptr, blk.src, p_s, p_u, v, f)
    worst, ok = 0.0, True
    pairs = []
    if p_s is not None:
        ss, _ = gat_mix_plain(blk.indptr, blk.src, p_s.abs(), None, None, f)
        pairs.append((s, rs, ss))
    if v is not None:
        _, su = gat_mix_plain(blk.indptr, blk.src, None, p_u.abs(), v.abs(),
                              f)
        pairs.append((u, ru, su))
    for out, ref, scale in pairs:
        err = (out - ref).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        ok = ok and bool((err <= 1e-5 + 1e-5 * scale).all())
    return worst, ok


def attention_cases(torch, seed):
    """A bipartite graph (700 sources, 1000 destinations, half of them
    empty, 64 padded edges) with its slot orders on the card."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    rng = np.random.default_rng(seed + 5)
    n_src, n_dst, e = 700, 1000, 20_000
    dst = rng.choice(n_dst, n_dst // 2, replace=False)[
        rng.integers(0, n_dst // 2, e)]
    coo = np.stack([np.concatenate([rng.integers(0, n_src, e),
                                    np.full(64, n_src)]),
                    np.concatenate([dst, np.full(64, n_dst)])])
    return EdgeIndex(coo.astype(np.int32), (n_src, n_dst),
                     device='cuda').fill_cache(blocked=True), rng


def phase_gat_mix_vs_plain(torch, seed, pc):
    """The mix kernel over H in {1, 4, 8} and F in {1, 10, 16, 64}, with
    p_s != p_u, and with v absent (the stabiliser pass); its backward pass
    (grad_v over the source-major order); then path C's shapes."""
    ei, rng = attention_cases(torch, seed)
    worst = 0.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device='cuda')

    cases = []
    n_src, n_dst = ei.sparse_size
    for h in (1, 4, 8):
        s_slots = ei.blocked.src.shape[0]
        p_s, p_u = t(rng.random((s_slots, h))), t(rng.random((s_slots, h)))
        cases.append((f'bipartite H={h} stabiliser (v absent)', ei.blocked,
                      p_s, None, None, 0))
        for f in (1, 10, 16, 64):
            cases.append((f'bipartite H={h} F={f} p_s != p_u', ei.blocked,
                          p_s, p_u, t(rng.standard_normal((n_src, h * f))),
                          f))
            cases.append((f'bipartite H={h} F={f} backward (grad_v over '
                          f'the CSR)', ei.blocked_t, None,
                          p_u[ei.blocked_t.t_pos].contiguous(),
                          t(rng.standard_normal((n_dst, h * f))), f))
    blk, blk_t = pc['ei'].blocked, pc['ei'].blocked_t
    s_slots = blk.src.shape[0]
    p = t(rng.random((s_slots, PC_HEADS)))
    for f, hf in ((PC_HIDDEN // PC_HEADS, PC_HIDDEN), (PC_CLASSES,
                                                       PC_HEADS * PC_CLASSES)):
        cases.append((f'path C H={PC_HEADS} F={f}', blk, p, p,
                      t(rng.standard_normal((PC_NODES, hf))), f))
    cases.append((f'path C H={PC_HEADS} stabiliser', blk, p, None, None, 0))
    cases.append((f'path C H={PC_HEADS} F={PC_HIDDEN // PC_HEADS} backward',
                  blk_t, None, p[blk_t.t_pos].contiguous(),
                  t(rng.standard_normal((PC_NODES, PC_HIDDEN))),
                  PC_HIDDEN // PC_HEADS))
    for label, lay, p_s, p_u, v, f in cases:
        err, ok = mix_close(torch, lay, p_s, p_u, v, f)
        worst = max(worst, err)
        log(f"[kernel] gat_mix {label}: max abs err {err:.3e} "
            f"{'ok' if ok else 'FAILED'}")
        check(ok, f'gat_mix disagrees with its plain version: {label}')
    # the whole fused aggregation with its autograd, card against CPU
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops.gat_fused import gat_aggregate
    coo = ei.coo.cpu().numpy()
    e = coo.shape[1]
    logits = (rng.standard_normal((e, 4)) * 3).astype(np.float32)
    v = rng.standard_normal((n_src, 4, 16)).astype(np.float32)
    c = rng.standard_normal((n_dst, 4, 16)).astype(np.float32)
    mask = rng.random(e) < 0.8
    res = []
    for d, graph in (('cuda', ei), ('cpu', EdgeIndex(
            coo, (n_src, n_dst), device='cpu').fill_cache(blocked=True))):
        lt = torch.as_tensor(logits, device=d).requires_grad_()
        vt = torch.as_tensor(v, device=d).requires_grad_()
        out = gat_aggregate(graph, lt, vt,
                            edge_mask=torch.as_tensor(mask, device=d))
        (out * torch.as_tensor(c, device=d)).sum().backward()
        res.append([x.detach().cpu() for x in (out, lt.grad, vt.grad)])
    for name, got, ref in zip(('out', 'grad logits', 'grad v'), *res):
        d = float((got - ref).abs().max())
        lim = 1e-4 * float(ref.abs().max())
        log(f'[kernel] gat_aggregate autograd, card vs CPU, {name}: max abs '
            f"diff {d:.3e} (limit {lim:.3e}) {'ok' if d <= lim else 'FAILED'}")
        check(d <= lim, f'gat_aggregate {name} differs from the CPU by {d}')
    return worst


def phase_segment_max_vs_plain(torch, seed, pc):
    """The segment-max kernel against its plain version, bitwise: H in {1,
    3, 4, 8, 40}, -inf entries and masked (all -inf) edges, empty rows and
    padded slots; then path C's slots at H = 4."""
    from pytorch_geometric_tpu_torch.ops.segment_max import (
        segment_max_blocked, segment_max_plain)
    ei, rng = attention_cases(torch, seed + 1)
    cases = []
    for h in (1, 3, 4, 8, 40):
        vals = rng.standard_normal((ei.blocked.src.shape[0], h)) * 10
        vals[rng.random(vals.shape) < 0.2] = -np.inf
        vals[rng.random(vals.shape[0]) < 0.3] = -np.inf      # masked edges
        cases.append((f'bipartite H={h}', ei.blocked, vals,
                      ei.num_dst_nodes))
    vals = rng.standard_normal((pc['ei'].num_edges, PC_HEADS)) * 3
    vals[rng.random(vals.shape[0]) < 0.1] = -np.inf
    cases.append((f'path C [{vals.shape[0]}, {PC_HEADS}]', pc['ei'].blocked,
                  vals, PC_NODES))
    worst = 0.0
    for label, lay, vals, n in cases:
        v = torch.as_tensor(vals.astype(np.float32), device='cuda')
        out = segment_max_blocked(v, lay, n)
        torch.cuda.synchronize()
        ref = segment_max_plain(lay.indptr, v)
        same = bool(torch.equal(out, ref))
        # -inf against -inf is no difference
        err = float(torch.where(out == ref, 0.0, (out - ref).abs()).max())
        worst = max(worst, err)
        n_inf = int(torch.isneginf(out).any(1).sum())
        log(f"[kernel] segment_max {label}: bitwise equal {same}, max abs "
            f"err {err:.3e} ({n_inf} rows -inf)")
        check(same, f'segment_max differs from its plain version: {label}')
    return worst


def phase_path_c(torch, seed, iters, warmup, pc):
    """GAT serving on path C: ms per forward, launches, profile, the output
    against the CPU plain path with the same weights."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    ei = pc['ei']
    x = torch.as_tensor(pc['x'], device='cuda')
    model = gat_model(torch, None, seed).eval()
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        ms, enqueue_ms, _, out = timed_calls(torch, lambda: model(x, ei),
                                             iters, warmup)
        rows, prof_ms, n_prof = profile_forwards(
            torch, lambda: model(x, ei), {MIX_KERNEL: MIX_PER_FORWARD})
    n_fwd = warmup + iters + n_prof
    counts = launch_counts()
    launches = counts['gat_mix']
    log(f'[path C] launches in {n_fwd} forwards: {counts}')
    check_counts('path C', counts, {'gat_mix': MIX_PER_FORWARD * n_fwd},
                 f'{n_fwd} forwards')
    ref_model = gat_model(torch, 'cpu', 0).eval()
    ref_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    ei_cpu = EdgeIndex(pc['coo'], (PC_NODES, PC_NODES),
                       device='cpu').fill_cache(blocked=True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = ref_model(torch.from_numpy(pc['x']), ei_cpu)
    log(f'[path C] CPU plain path forward in {time.perf_counter() - t0:.1f} '
        f's')
    diff, agree = compare(torch, 'path C', out, ref,
                          (PC_NODES, PC_CLASSES))
    cap, cap_out = captured_serving(
        torch, 'path C captured', lambda x: model(x, ei), x, out, iters,
        warmup, {'gat_mix': MIX_PER_FORWARD})
    cap['max_abs_diff_vs_cpu'], cap['argmax_agreement'] = compare(
        torch, 'path C captured', cap_out, ref, (PC_NODES, PC_CLASSES))
    res = {'captured': cap,
           'ms_per_forward': ms, 'host_enqueue_ms_per_forward': enqueue_ms,
           'forwards': n_fwd, 'launches': launches, 'launch_counts': counts,
           'launches_per_forward': launches / n_fwd,
           'edges': ei.num_edges, 'cache_build_ms': pc['build_ms'],
           'max_abs_diff_vs_cpu': diff, 'argmax_agreement': agree}
    log(f'[path C] {ms:.4f} ms per forward on the card (CUDA events, '
        f'{iters} forwards after {warmup}); the host issues one in '
        f'{enqueue_ms:.4f} ms')
    busy = sum(t for _, t, _ in rows)
    mix_ms = sum(t for name, t, _ in rows if MIX_KERNEL in name)
    check(busy <= 1.05 * prof_ms, f'path C: device busy {busy} ms '
                                  f'exceeds the wall {prof_ms} ms')
    res.update(device_busy_ms_per_forward=busy,
               profiled_ms_per_forward=prof_ms,
               device_idle_share=1 - busy / prof_ms,
               mix_ms_per_forward=mix_ms, mix_share_of_busy=mix_ms / busy,
               kernels_per_forward=[[n[:80], t, c] for n, t, c in rows[:12]])
    log(f'[path C] torch.profiler, a whole window of {PROFILED_FORWARDS} '
        f'forwards ({MIX_PER_FORWARD} mix launches each): device busy '
        f'{busy:.4f} ms per forward of a {prof_ms:.4f} ms wall, idle share '
        f'{1 - busy / prof_ms:.4f}; the mix kernel {mix_ms:.4f} ms, '
        f'{100 * mix_ms / busy:.1f}% of busy')
    for name, t, n in rows[:12]:
        log(f'[path C]   {t:.4f} ms  x{n:g}  {name[:90]}')
    log(json.dumps({'metric': 'gat_inference_fwd', 'ms': ms,
                    'ms_captured': cap['ms_per_forward'],
                    'nodes': PC_NODES, 'edges': ei.num_edges,
                    'heads': PC_HEADS, 'hidden': PC_HIDDEN}))
    return res


def gat_parity_run(torch, state, x, ei, y, device, build=None, lr=TR_LR):
    """``PARITY_STEPS`` steps of the model ``build`` makes (GAT by
    default) from ``state``, Adam at ``lr``: the losses and the first
    step's gradients."""
    model = (build or gat_model)(torch, device, 0)
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses, grads = [], None
    for i in range(PARITY_STEPS):
        losses.append(train_step(torch, model, opt, x, ei, y).item())
        if i == 0:
            grads = {k: g.cpu() for k, g in grads_of(torch, model).items()}
    return losses, grads


def phase_path_d(torch, seed, pc):
    """GAT training on path C's cell: ms per step, launches per step, a
    profile, 3 steps against the CPU plain path at ``PD_SMALL`` scale
    (``small_parity``)."""
    ei = pc['ei']
    x = torch.as_tensor(pc['x'], device='cuda')
    y = torch.as_tensor(pc['y'], device='cuda')
    model = gat_model(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TR_LR)

    def step():
        return train_step(torch, model, opt, x, ei, y)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    ms, _, enqueue_ms, last = timed_steps(torch, step, PA_WARMUP, PA_STEPS)
    prof, prof_steps = profile_steps(torch, step, 'path D',
                                     {MIX_KERNEL: MIX_PER_STEP,
                                      EDGE_DOT_KERNEL: DOT_PER_GAT_STEP})
    counts = launch_counts()
    launches = counts['gat_mix']
    n_steps = PA_WARMUP + PA_STEPS + prof_steps
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f'[path D] GAT training step: {ms:.4f} ms per step on the card (CUDA '
        f'events, {PA_STEPS} steps after {PA_WARMUP}); the host issues one '
        f'in {enqueue_ms:.4f} ms; loss after {PA_WARMUP + PA_STEPS} steps '
        f'{last:.6f}; peak memory {peak:.3f} GB; launches in {n_steps} '
        f'steps: {counts}')
    check_counts('path D', counts, {'gat_mix': MIX_PER_STEP * n_steps,
                                    'edge_dot': DOT_PER_GAT_STEP * n_steps},
                 f'{n_steps} steps')
    log(f"[path D] the dot kernel (grad_p_u) "
        f"{prof['edge_dot_ms_per_step']:.4f} ms per step, the mix "
        f"{prof['mix_ms_per_step']:.4f} ms; the step {ms:.4f} ms")
    res = {'ms_per_step': ms, 'host_enqueue_ms_per_step': enqueue_ms,
           'steps': n_steps, 'launches': launches, 'launch_counts': counts,
           'launches_per_step': launches / n_steps, 'peak_memory_gb': peak}
    res.update(prof)
    res['parity'] = small_parity(torch, 'path D', gat_model, state, seed)
    res['captured'] = captured_training(
        torch, 'path D captured', lambda: from_state(
            torch, lambda: gat_model(torch, None, seed), state),
        x, ei, y, None, {'gat_mix': MIX_PER_STEP,
                         'edge_dot': DOT_PER_GAT_STEP}, PA_STEPS, 1e-4)
    log(json.dumps({'metric': 'gat_train_step', 'ms': ms,
                    'ms_captured': res['captured']['ms_per_step'],
                    'nodes': PC_NODES, 'edges': ei.num_edges}))
    return res


def mix_bytes(n_src, n_dst, slots, h, f, p_reads, out_s):
    """Bytes one mix pass must move: v, the p arrays, src, indptr and the
    outputs once each (the stabiliser pass reads no v and no src)."""
    by = p_reads * slots * h * 4 + (n_dst + 1) * 4 + (n_dst * h * 4
                                                      if out_s else 0)
    if f:
        by += (n_src + n_dst) * h * f * 4 + slots * 4
    return by


def bsr_timed(torch, row, fns):
    """``timed_fns`` for a kernel-2 row, plus the pre-pass's and the kernel
    proper's device time per call (a second whole window of the kernel),
    the rate of the bytes the row must move at its measured time, and the
    HGMMA count of the built library."""
    timed_fns(torch, row, fns)
    rows, _, _ = whole_window(torch, fns['ms'], 10)
    row['prep_ms'] = sum(t for name, t, _ in rows if BSR_PREP in name)
    row['main_ms'] = sum(t for name, t, _ in rows if BSR_MAIN in name)
    row['tb_per_s'] = row['bytes'] / (row['ms'] * 1e-3) / 1e12
    row['hgmma_in_sass'] = HGMMA.get('bsr_spmm', 'not available')
    return row


def timed_fns(torch, row, fns, reps=20, warmup=3, calls=10):
    """``row`` with each of ``fns`` (key ``*ms``) timed on the card: device
    time (``device_ms``) and CUDA-event wall (``*event_ms``)."""
    for key, fn in fns.items():
        row[key.replace('ms', 'event_ms')] = timed_calls(
            torch, fn, reps, warmup)[0]
        row[key] = device_ms(torch, fn, calls=calls)
    return row


def timed_row(torch, fns, info, by, flops, **timing):
    """``info`` plus the bound from ``by`` bytes and ``flops`` (float32
    rate), and each of ``fns`` timed on the card."""
    t_bytes, t_ops = by / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    row = {'bytes': by, 'flops': flops,
           'bound_ms': max(t_bytes, t_ops) * 1e3,
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
    row.update(info)
    return timed_fns(torch, row, fns, **timing)


SWEEP_SLICE_COLS = (PC_HIDDEN, 128, 64, 32)
SWEEP_LANES = (1, 2, 4, 8, 16, 32)


def slice_sweep(torch, label, call, hf, n_src, itemsize, rule):
    """The mix kernel's device time per call at each slice width of
    ``SWEEP_SLICE_COLS`` (``call(w)`` runs it at width ``w``), each output
    held bitwise against the one-slice output."""
    ref = call(hf)
    rows = []
    for w in SWEEP_SLICE_COLS:
        out = call(w)
        same = all(torch.equal(a, b) for a, b in zip(out, ref)
                   if a is not None)
        check(same, f'gat_mix {label}: slice width {w} changes the output')
        ms = device_ms(torch, lambda: call(w), calls=10)
        rows.append({'call': label, 'slice_cols': w, 'slices': hf // w,
                     'slice_mb': n_src * w * itemsize / 1e6, 'ms': ms,
                     'rule': w == rule})
        log(f"[timing] gat_mix {label} slice width {w} ({hf // w} x "
            f"{n_src * w * itemsize / 1e6:.1f} MB"
            f"{', the rule' if w == rule else ''}): {ms:.4f} ms device time "
            f"per call, output bitwise equal to one slice's")
    return rows


def phase_attention_timings(torch, seed, pc):
    """At path C's shapes: the mix at H*F = 256 and 40, the stabiliser
    pass, the backward pass at 256, and the segment max at [E, 4]; each
    with the plain version, a library yardstick and the bound. Then the
    mix's slice-width sweep at H*F = 256 (forward, backward, bf16) and the
    segment max at every lanes-per-row width."""
    from pytorch_geometric_tpu_torch.ops.gat_fused import (card_slice_cols,
                                                           gat_mix,
                                                           gat_mix_plain)
    from pytorch_geometric_tpu_torch.ops.segment_max import (
        segment_max_blocked, segment_max_lanes, segment_max_plain)
    rng = np.random.default_rng(seed + 6)
    blk, blk_t = pc['ei'].blocked, pc['ei'].blocked_t
    n, h, slots = PC_NODES, PC_HEADS, blk.src.shape[0]
    e = int(blk.indptr[-1])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device='cuda')

    p = t(rng.random((slots, h)))
    p_t = p[blk_t.t_pos].contiguous()
    rows = []

    def library_mix(lay, pp, v, f):
        """H ``torch.sparse.mm`` CSR calls, one per head (a yardstick; the
        port never calls it), checked against the plain version."""
        mats = [torch.sparse_csr_tensor(lay.indptr, lay.src,
                                        pp[:, k].contiguous(), size=(n, n))
                for k in range(h)]
        vs = [v.view(n, h, f)[:, k].contiguous() for k in range(h)]

        def call():
            return [torch.sparse.mm(a, b) for a, b in zip(mats, vs)]

        _, ref = gat_mix_plain(lay.indptr, lay.src, None, pp, v, f)
        lib = torch.stack(call(), 1).reshape(n, h * f)
        check(bool(torch.allclose(lib, ref, rtol=1e-4, atol=1e-4)),
              f'torch.sparse.mm disagrees at F={f}')
        return call

    vs = {}
    with torch.inference_mode():
        for f in (PC_HIDDEN // h, PC_CLASSES):
            v = vs[f] = t(rng.standard_normal((n, h * f)))
            fns = {'ms': lambda: gat_mix(blk.indptr, blk.src, p, p, v, f),
                   'plain_ms': lambda: gat_mix_plain(blk.indptr, blk.src, p,
                                                     p, v, f),
                   'library_ms': library_mix(blk, p, v, f)}
            rows.append(timed_row(
                torch, fns, {'pass': 'mix (s, u)', 'H': h, 'F': f,
                             'HF': h * f, 'slots': e,
                             'slice_cols': card_slice_cols(v, h, f)},
                mix_bytes(n, n, e, h, f, 1, True), 2.0 * e * h * f + e * h))
        z = p
        offsets = blk.indptr.long()
        fns = {'ms': lambda: gat_mix(blk.indptr, blk.src, z, None, None),
               'plain_ms': lambda: gat_mix_plain(blk.indptr, blk.src, z,
                                                 None, None, 0),
               'library_ms': lambda: torch.segment_reduce(
                   z, 'sum', offsets=offsets)}
        check(bool(torch.allclose(fns['library_ms'](), fns['plain_ms']()[0],
                                  rtol=1e-4, atol=1e-4)),
              'torch.segment_reduce (sum) disagrees')
        rows.append(timed_row(
            torch, fns, {'pass': 'stabiliser s0 (v absent)', 'H': h, 'F': 0,
                         'HF': 0, 'slots': e},
            mix_bytes(n, n, e, h, 0, 1, True), 1.0 * e * h))
        f = PC_HIDDEN // h
        gu = t(rng.standard_normal((n, h * f)))
        fns = {'ms': lambda: gat_mix(blk_t.indptr, blk_t.src, None, p_t, gu,
                                     f),
               'plain_ms': lambda: gat_mix_plain(blk_t.indptr, blk_t.src,
                                                 None, p_t, gu, f),
               'library_ms': library_mix(blk_t, p_t, gu, f)}
        rows.append(timed_row(
            torch, fns, {'pass': 'backward grad_v (u only, over the CSR)',
                         'H': h, 'F': f, 'HF': h * f, 'slots': e,
                         'slice_cols': card_slice_cols(gu, h, f)},
            mix_bytes(n, n, e, h, f, 1, False), 2.0 * e * h * f))
        for r in rows:
            log(f"[timing] gat_mix {r['pass']} H*F={r['HF']}, device time "
                f"per call: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; "
                f"CUDA-event wall per call: kernel {r['event_ms']:.4f} ms"
                + (f"; slice width {r['slice_cols']}" if r['F'] else ''))
        # the slice-width sweep at H*F = 256
        hf = PC_HIDDEN
        pb = p.bfloat16()
        vb = vs[hf // h].bfloat16()
        sweep = slice_sweep(
            torch, 'mix f32 H*F=256',
            lambda w: gat_mix(blk.indptr, blk.src, p, p, vs[hf // h],
                              hf // h, slice_cols=w),
            hf, n, 4, card_slice_cols(vs[hf // h], h, hf // h))
        sweep += slice_sweep(
            torch, 'backward grad_v f32 H*F=256',
            lambda w: gat_mix(blk_t.indptr, blk_t.src, None, p_t, gu, hf // h,
                              slice_cols=w),
            hf, n, 4, card_slice_cols(gu, h, hf // h))
        sweep_bf16 = slice_sweep(
            torch, 'mix bf16 H*F=256',
            lambda w: gat_mix(blk.indptr, blk.src, pb, pb, vb, hf // h,
                              slice_cols=w),
            hf, n, 2, card_slice_cols(vb, h, hf // h))
        vals = rng.standard_normal((slots, h)) * 3
        vals[rng.random(slots) < 0.1] = -np.inf
        vals = t(vals)
        lanes = segment_max_lanes(slots, n)
        fns = {'ms': lambda: segment_max_blocked(vals, blk, n),
               'plain_ms': lambda: segment_max_plain(blk.indptr, vals),
               'library_ms': lambda: torch.segment_reduce(
                   vals, 'max', offsets=offsets)}
        by = slots * h * 4 + (n + 1) * 4 + n * h * 4
        max_row = timed_row(torch, fns, {'H': h, 'slots': e,
                                         'lanes_per_row': lanes}, by,
                            1.0 * e * h)
        log(f"[timing] segment_max [{e}, {h}], device time per call: kernel "
            f"{max_row['ms']:.4f} ms, plain {max_row['plain_ms']:.4f} ms, "
            f"torch.segment_reduce {max_row['library_ms']:.4f} ms; bound "
            f"{max_row['bound_ms']:.4f} ms ({max_row['bound_by']}), kernel "
            f"at {100 * max_row['bound_ms'] / max_row['ms']:.1f}% of the "
            f"bound; CUDA-event wall per call: kernel "
            f"{max_row['event_ms']:.4f} ms; {lanes} lanes per row at a mean "
            f"run of {slots / n:.2f} slots")
        ref = segment_max_blocked(vals, blk, n)
        max_row['lanes_sweep'] = []
        for g in SWEEP_LANES:
            check(torch.equal(segment_max_blocked(vals, blk, n, lanes=g), ref),
                  f'segment_max: {g} lanes per row changes the output')
            ms = device_ms(torch, lambda: segment_max_blocked(vals, blk, n,
                                                              lanes=g))
            max_row['lanes_sweep'].append({'lanes_per_row': g, 'ms': ms})
            log(f"[timing] segment_max [{e}, {h}] at {g} lanes per row"
                f"{' (the rule)' if g == lanes else ''}: {ms:.4f} ms device "
                f"time per call, output bitwise equal")
    return rows, max_row, sweep, sweep_bf16


# -- phases 21 to 24: the per-edge dot kernel, paths I and J ----------------
def transformer_model(torch, device, seed):
    """Paths I and J's model: ``PI_LAYERS`` TransformerConv layers from
    ``PC_F`` inputs (beta gate and root weight each), ReLU between, random
    weights from ``seed``."""
    from pytorch_geometric_tpu_torch.nn.conv import TransformerConv
    gen = torch.Generator().manual_seed(seed)
    convs, width = [], PC_F
    for h, c, concat in PI_LAYERS:
        convs.append(TransformerConv(width, c, heads=h, concat=concat,
                                     beta=True, root_weight=True,
                                     device=device, generator=gen))
        width = h * c if concat else c

    class TransformerStack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList(convs)

        def forward(self, x, ei):
            for i, conv in enumerate(self.convs):
                x = conv(x, ei)
                if i < len(self.convs) - 1:
                    x = torch.relu(x)
            return x

    return TransformerStack()


def dot_close(torch, a, b, ia, ib, mask=None):
    """The dot kernel against its plain version on the same card tensors:
    float32 within 1e-5 of the largest output; bf16 within ``bf16_ok``'s
    bound (one bf16 ulp plus 1e-5 + 1e-5 of the edge's sum of |a * b|
    terms), the mix's bf16 arm's. Returns (max abs err, ok)."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import (edge_dot,
                                                          edge_dot_plain)
    out = edge_dot(a, b, ia, ib, mask)
    torch.cuda.synchronize()
    ref = edge_dot_plain(a, b, ia, ib, mask)
    if out.numel() == 0:
        return 0.0, tuple(out.shape) == tuple(ref.shape)
    err = float((out.float() - ref.float()).abs().max())
    if a.dtype == torch.bfloat16:
        scale = edge_dot_plain(a.float().abs(), b.float().abs(), ia, ib,
                               mask)
        return err, bf16_ok(torch, out, ref, scale)
    return err, err <= 1e-5 * max(float(ref.abs().max()), 1e-30)


def phase_edge_dot_vs_plain(torch, seed, pc):
    """The dot kernel, both arms, against its plain version: a bipartite
    graph in edge order and in slot order at H*F = 256 and 40, one head as
    2-D tables, out-of-range indices (negative and past the tables) with a
    mask, an empty edge list; then path I's shapes (edge order, the scores)
    and path D's (slot order, grad_p_u). Returns the worst error of each
    arm."""
    ei, rng = attention_cases(torch, seed + 7)
    n_src, n_dst = ei.sparse_size
    coo, blk = ei.coo, ei.blocked
    g = torch.Generator('cuda').manual_seed(seed)

    def tables(na, nb, h, f):
        return (torch.randn(na, h, f, device='cuda', generator=g),
                torch.randn(nb, h, f, device='cuda', generator=g))

    cases = []
    for h, f in ((PC_HEADS, PC_HIDDEN // PC_HEADS), (PC_HEADS, PC_CLASSES)):
        a, b = tables(n_src, n_dst, h, f)
        cases.append((f'bipartite edge order H={h} F={f}', a, b, coo[0],
                      coo[1], None))
        cases.append((f'bipartite slot order H={h} F={f}', a, b, blk.src,
                      blk.dst, None))
    a, b = tables(n_src, n_dst, 1, 64)
    cases.append(('bipartite H=1 2-D F=64', a[:, 0], b[:, 0], coo[0], coo[1],
                  None))
    a, b = tables(n_src, n_dst, PC_HEADS, PC_HIDDEN // PC_HEADS)
    e = 30_000
    ia = torch.randint(-3, n_src + 4, (e,), device='cuda', generator=g)
    ib = torch.randint(-3, n_dst + 4, (e,), device='cuda', generator=g)
    mask = torch.rand(e, device='cuda', generator=g) < 0.8
    cases.append(('out-of-range indices and a mask', a, b, ia, ib, mask))
    cases.append(('an empty edge list', a, b, ia[:0], ib[:0], None))
    pa, pb = tables(PC_NODES, PC_NODES, PC_HEADS, PC_HIDDEN // PC_HEADS)
    pe = pc['ei']
    cases.append((f'path I scores [{pe.num_edges}, {PC_HEADS}, '
                  f'{PC_HIDDEN // PC_HEADS}] (edge order)', pa, pb,
                  pe.coo[0], pe.coo[1], None))
    cases.append((f'path D grad_p_u [{pe.num_edges}, {PC_HEADS}, '
                  f'{PC_HIDDEN // PC_HEADS}] (slot order)', pa, pb,
                  pe.blocked.src, pe.blocked.dst, None))
    pa10, pb10 = tables(PC_NODES, PC_NODES, PC_HEADS, PC_CLASSES)
    cases.append((f'path I layer 3 [{pe.num_edges}, {PC_HEADS}, '
                  f'{PC_CLASSES}]', pa10, pb10, pe.coo[0], pe.coo[1], None))
    worst = {'f32': 0.0, 'bf16': 0.0}
    with torch.inference_mode():
        for label, a, b, ia, ib, m in cases:
            for arm, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
                err, ok = dot_close(torch, a.to(dt), b.to(dt), ia, ib, m)
                worst[arm] = max(worst[arm], err)
                log(f"[kernel] edge_dot {arm} {label}: max abs err "
                    f"{err:.3e} {'ok' if ok else 'FAILED'}")
                check(ok, f'edge_dot {arm} disagrees with its plain version: '
                          f'{label}')
    log(f"[kernel] edge_dot worst error: float32 {worst['f32']:.3e} (limit "
        f"1e-5 of the largest output), bf16 {worst['bf16']:.3e} (one bf16 "
        f"ulp plus the float32 limit)")
    return worst


def dot_combines(torch, e):
    """The score calls of a path I forward (one a layer, ``PI_LAYERS``, in
    edge order over two tables of ``PC_NODES`` rows, float32) that the dot
    kernel's plan cuts into column slices: each runs the pass that sums the
    slices' partials once. A path J step adds none (its grad_p_u takes the
    runs arm)."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import dot_plan, runs_arm
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = 0
    for h, f, _ in PI_LAYERS:
        vec = 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1
        plan = dot_plan(PC_NODES, PC_NODES, e, h, f, vec, 4, l2)
        n += not runs_arm(f, None) and plan is not None and plan[1] > 1
    return n


def phase_path_i(torch, seed, iters, warmup, pc):
    """TransformerConv serving on path C's graph and slot orders: ms per
    forward, launches (``DOT_PER_FORWARD`` dot, ``dot_combines`` combine
    and ``PI_MIX_PER_FORWARD`` mix launches per forward), a profile, the
    output against the CPU plain path with the same weights at 1e-4 of its
    largest magnitude; then the same forward captured."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    ei = pc['ei']
    x = torch.as_tensor(pc['x'], device='cuda')
    model = transformer_model(torch, None, seed).eval()
    per_fwd = {'edge_dot': DOT_PER_FORWARD, 'gat_mix': PI_MIX_PER_FORWARD,
               'edge_dot_combine': dot_combines(torch, ei.num_edges)}
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        ms, enqueue_ms, _, out = timed_calls(torch, lambda: model(x, ei),
                                             iters, warmup)
        rows, prof_ms, n_prof = profile_forwards(
            torch, lambda: model(x, ei), replay_expect(per_fwd))
    n_fwd = warmup + iters + n_prof
    counts = launch_counts()
    log(f'[path I] launches in {n_fwd} forwards: {counts}')
    check_counts('path I', counts, {k: n * n_fwd for k, n in per_fwd.items()},
                 f'{n_fwd} forwards')
    ref_model = transformer_model(torch, 'cpu', 0).eval()
    ref_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    ei_cpu = EdgeIndex(pc['coo'], (PC_NODES, PC_NODES),
                       device='cpu').fill_cache(blocked=True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = ref_model(torch.from_numpy(pc['x']), ei_cpu)
    log(f'[path I] CPU plain path forward in {time.perf_counter() - t0:.1f} '
        f's')
    shape = (PC_NODES, PC_CLASSES)
    diff, agree = compare(torch, 'path I', out, ref, shape)
    check(diff <= 1e-4 * float(ref.abs().max()),
          f'path I: {diff} from the CPU plain path, past 1e-4 of its largest')
    cap, cap_out = captured_serving(
        torch, 'path I captured', lambda x: model(x, ei), x, out, iters,
        warmup, per_fwd)
    cap['max_abs_diff_vs_cpu'], cap['argmax_agreement'] = compare(
        torch, 'path I captured', cap_out, ref, shape)
    busy = sum(t for _, t, _ in rows)
    dot_ms = sum(t for name, t, _ in rows if EDGE_DOT_KERNEL in name
                 or EDGE_DOT_COMBINE in name)
    mix_ms = sum(t for name, t, _ in rows if MIX_KERNEL in name)
    check(busy <= 1.05 * prof_ms, f'path I: device busy {busy} ms exceeds '
                                  f'the wall {prof_ms} ms')
    res = {'captured': cap, 'ms_per_forward': ms,
           'host_enqueue_ms_per_forward': enqueue_ms, 'forwards': n_fwd,
           'launches': counts['edge_dot'], 'launch_counts': counts,
           'launches_per_forward': {k: counts[k] / n_fwd for k in per_fwd},
           'launches_expected_per_forward': per_fwd,
           'edges': ei.num_edges, 'layers': [list(c) for c in PI_LAYERS],
           'max_abs_diff_vs_cpu': diff, 'max_abs_ref': float(
               ref.abs().max()), 'argmax_agreement': agree,
           'device_busy_ms_per_forward': busy,
           'profiled_ms_per_forward': prof_ms,
           'device_idle_share': 1 - busy / prof_ms,
           'edge_dot_ms_per_forward': dot_ms, 'mix_ms_per_forward': mix_ms,
           'kernels_per_forward': [[n[:80], t, c] for n, t, c in rows[:12]]}
    log(f'[path I] TransformerConv x{PC_LAYERS} (H={PC_HEADS}, F='
        f'{PC_HIDDEN // PC_HEADS}; beta, root weight): {ms:.4f} ms per '
        f'forward on the card (CUDA events, {iters} forwards after {warmup}); '
        f'the host issues one in {enqueue_ms:.4f} ms; device busy {busy:.4f} '
        f'ms of a {prof_ms:.4f} ms wall, idle share {1 - busy / prof_ms:.4f}; '
        f'the dot kernel {dot_ms:.4f} ms, the mix {mix_ms:.4f} ms; launches '
        f'per forward {res["launches_per_forward"]} (expected {per_fwd})')
    for name, t, n in rows[:12]:
        log(f'[path I]   {t:.4f} ms  x{n:g}  {name[:90]}')
    log(json.dumps({'metric': 'transformer_inference_fwd', 'ms': ms,
                    'ms_captured': cap['ms_per_forward'],
                    'nodes': PC_NODES, 'edges': ei.num_edges,
                    'heads': PC_HEADS, 'hidden': PC_HIDDEN}))
    return res


def phase_path_j(torch, seed, pc):
    """Path I's stack trained with Adam (labels as path D's): ms per step,
    launches (``DOT_PER_STEP`` dot, ``dot_combines`` combine and
    ``PI_MIX_PER_STEP`` mix launches per step), a profile, 3 steps against
    the CPU plain path at ``PD_SMALL`` scale (losses and first-step
    gradients at 1e-4, ``small_parity``); then the step captured."""
    ei = pc['ei']
    x = torch.as_tensor(pc['x'], device='cuda')
    y = torch.as_tensor(pc['y'], device='cuda')
    model = transformer_model(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=TR_LR)
    per_step = {'edge_dot': DOT_PER_STEP, 'gat_mix': PI_MIX_PER_STEP,
                'edge_dot_combine': dot_combines(torch, ei.num_edges)}

    def step():
        return train_step(torch, model, opt, x, ei, y)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    ms, _, enqueue_ms, last = timed_steps(torch, step, PA_WARMUP, PA_STEPS)
    prof, prof_steps = profile_steps(torch, step, 'path J',
                                     replay_expect(per_step))
    counts = launch_counts()
    n_steps = PA_WARMUP + PA_STEPS + prof_steps
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f'[path J] TransformerConv training step: {ms:.4f} ms per step on '
        f'the card (CUDA events, {PA_STEPS} steps after {PA_WARMUP}); the '
        f'host issues one in {enqueue_ms:.4f} ms; loss after '
        f'{PA_WARMUP + PA_STEPS} steps {last:.6f}; peak memory {peak:.3f} '
        f'GB; launches in {n_steps} steps: {counts}')
    check_counts('path J', counts, {k: n * n_steps
                                    for k, n in per_step.items()},
                 f'{n_steps} steps')
    res = {'ms_per_step': ms, 'host_enqueue_ms_per_step': enqueue_ms,
           'steps': n_steps, 'launches': counts['edge_dot'],
           'launch_counts': counts,
           'launches_per_step': {k: counts[k] / n_steps for k in per_step},
           'launches_expected_per_step': per_step, 'peak_memory_gb': peak}
    res.update(prof)
    # the softmax cancels a shift of every score of a destination, so the
    # key biases' gradients are 0 but for rounding
    res['parity'] = small_parity(torch, 'path J', transformer_model, state,
                                 seed, cancelled=('lin_key.bias',))
    res['captured'] = captured_training(
        torch, 'path J captured', lambda: from_state(
            torch, lambda: transformer_model(torch, None, seed), state),
        x, ei, y, None, per_step, PA_STEPS, 1e-4)
    log(json.dumps({'metric': 'transformer_train_step', 'ms': ms,
                    'ms_captured': res['captured']['ms_per_step'],
                    'nodes': PC_NODES, 'edges': ei.num_edges}))
    return res


def dot_bytes(na, nb, e, h, f, itemsize, index_bytes):
    """Bytes one dot call must move: a and b once, the two index arrays,
    and the ``[E, H]`` output."""
    return (na + nb) * h * f * itemsize + e * index_bytes + e * h * itemsize


def sampled_addmm_call(torch, lay, a, b, n_dst, n_src, e):
    """``torch.sparse.sampled_addmm`` on the slot-order CSR (rows the
    destinations), one call per head, ``out[d, s] = <b[d], a[s]>`` (a
    yardstick; the port never calls it), checked against the plain dot."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot_plain
    h = a.shape[1]
    mats = [torch.sparse_csr_tensor(
        lay.indptr, lay.src[:e], torch.zeros(e, device='cuda', dtype=a.dtype),
        size=(n_dst, n_src)) for _ in range(h)]
    bs = [b[:, k].contiguous() for k in range(h)]
    ats = [a[:, k].t().contiguous() for k in range(h)]

    def call():
        return [torch.sparse.sampled_addmm(m, bb, at, beta=0.0)
                for m, bb, at in zip(mats, bs, ats)]

    got = torch.stack([o.values() for o in call()], 1)
    ref = edge_dot_plain(a, b, lay.src[:e], lay.dst[:e])
    check(bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-4)),
          'torch.sparse.sampled_addmm disagrees with the plain dot')
    return call


def phase_edge_dot_timings(torch, seed, pc, path_i, path_d):
    """The dot kernel at path I's shapes (the scores in edge order, H*F =
    256 and 40) and path D's (grad_p_u in slot order, 256 and 40), both
    arms at 256: device time per call (the column slices' combine pass
    included), the plain version's, the library yardstick's
    (``sampled_addmm_call``; none takes bf16), the bound from the bytes the
    call must move, and the arm and slices the wrapper chose (path D says
    that its destinations come in runs, as its grad_p_u does, and takes the
    runs arm); at every shape the sweep of every slice shape of that arm
    and the other arm at its own rule (``dot_slice_sweep``)."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import (dot_plan, dot_vec,
                                                          edge_dot,
                                                          edge_dot_plain,
                                                          runs_arm,
                                                          runs_slice_heads)
    ei = pc['ei']
    blk = ei.blocked
    n, e = PC_NODES, ei.num_edges
    g = torch.Generator('cuda').manual_seed(seed + 8)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    rows, sweep = [], []
    with torch.inference_mode():
        for path, order, ia, ib in (('I', 'edge', ei.coo[0], ei.coo[1]),
                                    ('D', 'slot', blk.src, blk.dst)):
            for h, f in ((PC_HEADS, PC_HIDDEN // PC_HEADS),
                         (PC_HEADS, PC_CLASSES)):
                for dt in ((torch.float32, torch.bfloat16) if f > PC_CLASSES
                           else (torch.float32,)):
                    a = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                    b = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                    # path D's grad_p_u reads b through the slot order's
                    # sorted destinations, and says so
                    named = True if path == 'D' else None
                    runs = runs_arm(f, named)
                    fns = {'ms': lambda: edge_dot(a, b, ia, ib, runs=named),
                           'plain_ms': lambda: edge_dot_plain(a, b, ia, ib)}
                    if dt == torch.float32:
                        fns['library_ms'] = sampled_addmm_call(
                            torch, blk, a, b, n, n, e)
                    itemsize = a.element_size()
                    by = dot_bytes(n, n, e, h, f, itemsize,
                                   ia.element_size() + ib.element_size())
                    flops = 2.0 * e * h * f
                    t_bytes = by / HBM_BYTES_PER_S
                    t_ops = flops / (F32_FLOP_PER_S if dt == torch.float32
                                     else BF16_FLOP_PER_S)
                    vec = dot_vec(a, b, f, h * f, h * f)
                    rules = {True: (runs_slice_heads(n, h, f, itemsize, l2),
                                    1),
                             False: dot_plan(n, n, e, h, f, vec, itemsize,
                                             l2)}
                    rule = rules[runs]
                    row = {'path': path, 'order': order,
                           'dtype': str(dt).split('.')[-1], 'H': h, 'F': f,
                           'HF': h * f, 'edges': e, 'vec': vec,
                           'arm': 'runs' if runs else 'tree',
                           'slice_heads': rule[0], 'col_slices': rule[1],
                           'bytes': by, 'flops': flops,
                           'bound_ms': max(t_bytes, t_ops) * 1e3,
                           'bound_by': ('bytes' if t_bytes >= t_ops
                                        else 'operations'),
                           'library_ms': None}
                    timed_fns(torch, row, fns)
                    rows.append(row)
                    log(f"[timing] edge_dot {row['dtype']} path {path} "
                        f"({order} order) H*F={h * f}, device time per call: "
                        f"kernel {row['ms']:.4f} ms, plain "
                        f"{row['plain_ms']:.4f} ms, library "
                        + (f"{row['library_ms']:.4f} ms"
                           if row['library_ms'] is not None else 'none')
                        + f"; bound {row['bound_ms']:.4f} ms "
                        f"({row['bound_by']}), kernel at "
                        f"{100 * row['bound_ms'] / row['ms']:.1f}% of the "
                        f"bound; CUDA-event wall per call: kernel "
                        f"{row['event_ms']:.4f} ms; the {row['arm']} arm, "
                        f"{rule[0]} heads a slice in {rule[1]} column "
                        "slices")
                    sweep += dot_slice_sweep(torch, path, order, a, b, ia,
                                             ib, rules, vec, runs)
    log(f"[timing] edge_dot launches per path I forward "
        f"{path_i['launches_per_forward']['edge_dot']:g}, per path J step "
        f"(see path J), per path D step "
        f"{path_d['launch_counts']['edge_dot'] / path_d['steps']:g}")
    return rows, sweep


def dot_slice_sweep(torch, path, order, a, b, ia, ib, rules, vec, runs):
    """The dot kernel's device time per call at every slice shape of the
    arm the call takes (the tree arm, ``dot_slice_widths``: whole heads, a
    divisor of H, then one head in 2, 4, ... column slices; the runs arm,
    for a call saying one side comes in ``runs``: whole heads), each
    output bitwise equal to the arm's one slice of every head; then the
    other arm at its own rule (``rules`` by arm; its own order of sums,
    within 1e-5 of the largest output, and a bf16 ulp for bf16), the A/B
    of the wrapper's choice."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import (dot_slice_widths,
                                                          edge_dot)
    h, f = a.shape[1], a.shape[2]
    widths = ([(d, 1) for d in range(h, 0, -1) if h % d == 0] if runs
              else dot_slice_widths(h, f, vec))

    def call(hs, cs, arm=runs):
        return edge_dot(a, b, ia, ib, slice_heads=hs,
                        col_slices=None if arm else cs, runs=arm)

    def row(arm, hs, cs, ms, is_rule):
        mb = a.shape[0] * hs * f * a.element_size() / cs / 1e6
        out.append({'path': path, 'order': order,
                    'dtype': str(a.dtype).split('.')[-1],
                    'arm': 'runs' if arm else 'tree', 'slice_heads': hs,
                    'col_slices': cs, 'slices': h // hs * cs,
                    'slice_mb_of_a': mb, 'ms': ms, 'rule': is_rule})
        log(f"[sweep] edge_dot {out[-1]['dtype']} path {path} ({order} "
            f"order, the {out[-1]['arm']} arm) {hs} of {h} heads a slice in "
            f"{cs} column slices ({h // hs * cs} x {mb:.1f} MB of a"
            f"{', the rule' if is_rule else ''}): {ms:.4f} ms device time "
            f"per call")

    ref = call(h, 1)
    out = []
    for hs, cs in widths:
        check(torch.equal(call(hs, cs), ref),
              f'edge_dot path {path}: {hs} heads a slice in {cs} column '
              'slices change the output')
        row(runs, hs, cs, device_ms(torch, lambda: call(hs, cs), calls=10),
            (hs, cs) == tuple(rules[runs]))
    hs, cs = rules[not runs]
    top = float(ref.float().abs().max())
    lim = 1e-5 * max(1.0, top) + (top * 2.0 ** -7
                                  if a.dtype == torch.bfloat16 else 0.0)
    err = float((call(hs, cs, not runs).float() - ref.float()).abs().max())
    check(err <= lim, f'edge_dot path {path}: the two arms differ by {err}, '
                      f'past {lim}')
    row(not runs, hs, cs, device_ms(torch, lambda: call(hs, cs, not runs),
                                    calls=10), False)
    return out


# -- phases 14 to 19, the precision ladder -----------------------------------
def bf16_ok(torch, out, ref, scale):
    """``out`` within one bf16 ulp of ``ref`` plus the float32 row-scaled
    limit ``1e-5 + 1e-5 * scale``: both sum in float32 in another order,
    and a sum on a rounding boundary can land one bf16 ulp apart. Returns
    (max abs err, ok)."""
    ref = ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    err = (out.float() - ref).abs()
    ok = bool((err <= ulp + 1e-5 + 1e-5 * scale.float()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def phase_kernel_bf16_vs_plain(torch, seed):
    """The segment-sum kernel's bf16 arm against its plain version, forward
    over the CSC and ``grad_x`` over the CSR through its autograd Function:
    a bipartite graph (700 -> 1000, half the rows empty, 64 padded edges)
    at F in {1, 10, 16, 24, 128}, the serving graph at F = 128 and 16, each
    weighted (bf16 weights) and unweighted; then an x 2 bytes past a 16-byte
    boundary."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_plain)
    rng = np.random.default_rng(seed + 7)
    n_src, n_dst, e = 700, 1000, 20_000
    dst = rng.choice(n_dst, n_dst // 2, replace=False)[
        rng.integers(0, n_dst // 2, e)]
    coo = np.stack([np.concatenate([rng.integers(0, n_src, e),
                                    np.full(64, n_src)]),
                    np.concatenate([dst, np.full(64, n_dst)])])
    bip = EdgeIndex(coo.astype(np.int32), (n_src, n_dst),
                    device='cuda').fill_cache(blocked=False)
    _, s_coo, s_w = serving_graph(seed)
    srv = EdgeIndex(s_coo, (N_NODES, N_NODES), device='cuda').fill_cache(
        blocked=False)
    graphs = [(f'bipartite {n_src}->{n_dst} E={e}+64 pad', bip,
               rng.random(coo.shape[1]), (1, 10, 16, 24, 128)),
              (f'serving N={N_NODES} E={s_coo.shape[1]}', srv, s_w,
               (WIDTH, N_OUT))]

    def bf(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device='cuda').bfloat16()

    worst = 0.0
    for label, ei, w_np, widths in graphs:
        csc, csr = ei.csc, ei.csr
        n_s, n_d = ei.sparse_size
        w = bf(w_np)
        for f in widths:
            for weighted in (True, False):
                w_c = w[csc.perm].contiguous() if weighted else None
                w_r = w[csr.perm].contiguous() if weighted else None
                x = bf(rng.standard_normal((n_s, f))).requires_grad_()
                g = bf(rng.standard_normal((n_d, f)))
                out = segment_spmm(csc.indptr, csc.indices, w_c, x,
                                   (csr.indptr, csr.indices, w_r))
                out.backward(g)
                torch.cuda.synchronize()
                with torch.no_grad():
                    xd = x.detach()
                    a_c = None if w_c is None else w_c.abs()
                    a_r = None if w_r is None else w_r.abs()
                    e1, ok1 = bf16_ok(
                        torch, out,
                        segment_spmm_plain(csc.indptr, csc.indices, w_c, xd),
                        segment_spmm_plain(csc.indptr, csc.indices, a_c,
                                           xd.abs()))
                    e2, ok2 = bf16_ok(
                        torch, x.grad,
                        segment_spmm_plain(csr.indptr, csr.indices, w_r, g),
                        segment_spmm_plain(csr.indptr, csr.indices, a_r,
                                           g.abs()))
                worst = max(worst, e1, e2)
                tag = (f"{label} F={f} "
                       f"{'weighted' if weighted else 'unweighted'}")
                log(f'[kernel] segment_spmm bf16 {tag}: forward max abs err '
                    f'{e1:.3e}, grad_x {e2:.3e} '
                    f"{'ok' if ok1 and ok2 else 'FAILED'}")
                check(ok1 and ok2, f'segment_spmm bf16 disagrees with its '
                                   f'plain version: {tag}')
    csc = bip.csc
    base = bf(rng.standard_normal(n_src * 16 + 1))
    x = base[1:].view(n_src, 16)
    check(x.data_ptr() % 16 != 0, 'the unaligned case is aligned')
    with torch.no_grad():
        err, ok = bf16_ok(torch, segment_spmm(csc.indptr, csc.indices, None,
                                              x),
                          segment_spmm_plain(csc.indptr, csc.indices, None,
                                             x),
                          segment_spmm_plain(csc.indptr, csc.indices, None,
                                             x.abs()))
    worst = max(worst, err)
    log(f"[kernel] segment_spmm bf16 bipartite F=16, x 2 bytes past a 16-byte "
        f"boundary: max abs err {err:.3e} {'ok' if ok else 'FAILED'}")
    check(ok, 'segment_spmm bf16 disagrees on an unaligned x')
    return worst


def phase_gat_mix_bf16_vs_plain(torch, seed, pc):
    """The mix kernel's bf16 arm (p_s, p_u and v all bf16) against its
    plain version: the bipartite slot orders at H in {1, 4, 8} and F in
    {1, 10, 16, 64}, the stabiliser pass, the backward pass over the
    source-major order; then path C's shapes."""
    ei, rng = attention_cases(torch, seed + 2)
    n_src, n_dst = ei.sparse_size
    from pytorch_geometric_tpu_torch.ops.gat_fused import (gat_mix,
                                                           gat_mix_plain)

    def bf(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device='cuda').bfloat16()

    cases = []
    for h in (1, 4, 8):
        slots = ei.blocked.src.shape[0]
        p_s, p_u = bf(rng.random((slots, h))), bf(rng.random((slots, h)))
        cases.append((f'bipartite H={h} stabiliser', ei.blocked, p_s, None,
                      None, 0))
        for f in (1, 10, 16, 64):
            cases.append((f'bipartite H={h} F={f} p_s != p_u', ei.blocked,
                          p_s, p_u, bf(rng.standard_normal((n_src, h * f))),
                          f))
            cases.append((f'bipartite H={h} F={f} backward', ei.blocked_t,
                          None, p_u[ei.blocked_t.t_pos].contiguous(),
                          bf(rng.standard_normal((n_dst, h * f))), f))
    blk = pc['ei'].blocked
    p = bf(rng.random((blk.src.shape[0], PC_HEADS)))
    f = PC_HIDDEN // PC_HEADS
    cases.append((f'path C H={PC_HEADS} F={f}', blk, p, p,
                  bf(rng.standard_normal((PC_NODES, PC_HIDDEN))), f))
    cases.append((f'path C H={PC_HEADS} stabiliser', blk, p, None, None, 0))
    worst = 0.0
    for label, lay, p_s, p_u, v, f in cases:
        s, u = gat_mix(lay.indptr, lay.src, p_s, p_u, v, f)
        torch.cuda.synchronize()
        rs, ru = gat_mix_plain(lay.indptr, lay.src, p_s, p_u, v, f)
        pairs = []
        if p_s is not None:
            pairs.append((s, rs, rs))                # p_s >= 0
        if v is not None:
            _, su = gat_mix_plain(lay.indptr, lay.src, None, p_u, v.abs(), f)
            pairs.append((u, ru, su))
        ok, case_err = True, 0.0
        for out, ref, scale in pairs:
            err, good = bf16_ok(torch, out, ref, scale)
            case_err, ok = max(case_err, err), ok and good
        worst = max(worst, case_err)
        log(f"[kernel] gat_mix bf16 {label}: max abs err {case_err:.3e} "
            f"{'ok' if ok else 'FAILED'}")
        check(ok, f'gat_mix bf16 disagrees with its plain version: {label}')
    return worst


def phase_path_f(torch, seed):
    """``bench.py``'s accelerator regime (``bench.py:80-90``): path B's
    graph and models over ``fill_cache(dense_weight=w,
    cache_dtype=torch.bfloat16)`` (GCN's normalised weights, GraphSAGE's
    and GIN's unit weights), 500 steps each; the dense bf16 products are
    PyTorch's matmuls, so no kernel of the port launches. 3 losses against
    the CPU plain path over the same cache, within 1e-3 (bf16 roundings of
    a layer's input flip where the float32 sums differ in the last bit)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    results = {}
    for kind in ('GCN', 'GraphSAGE', 'GIN'):
        x_np, coo, w_np, y_np = path_b_graph(kind, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ei = EdgeIndex(coo, (PB_NODES, PB_NODES)).fill_cache(
            dense_weight=w_np, cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        reduce = 'mean' if kind == 'GraphSAGE' else 'sum'
        regime = spmm_regime(ei, TR_F, reduce)
        check(regime == 'dense-cached'
              and ei.dense_adj.dtype == torch.bfloat16,
              f'path F {kind}: regime {regime!r}, {ei.dense_adj}')
        x = torch.as_tensor(x_np, device='cuda')
        y = torch.as_tensor(y_np, device='cuda')
        model = train_model(torch, kind, None, seed)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        opt = torch.optim.Adam(model.parameters(), lr=TR_LR)

        def step():
            return train_step(torch, model, opt, x, ei, y)

        torch.cuda.synchronize()
        reset_counts()
        ms, wall_s, enqueue_ms, last = timed_steps(torch, step, 2, PB_STEPS)
        prof, prof_steps = profile_steps(torch, step, f'path F {kind}')
        counts = launch_counts()
        n_steps = 2 + PB_STEPS + prof_steps
        check(not any(counts.values()),
              f'path F {kind}: kernels launched {counts}')
        log(f'[path F {kind}] dense bf16 cache ({PB_NODES}^2, built in '
            f'{build_ms:.3f} ms): {PB_STEPS} steps in {wall_s:.4f} s on the '
            f'host clock ({ms:.4f} ms per step on the card, the host issues '
            f'one in {enqueue_ms:.4f} ms); final loss {last:.6f}; no kernel '
            f'launched in {n_steps} steps')
        card = parity_run(torch, kind, state, x, ei, y, 'cuda')
        ei_cpu = EdgeIndex(coo, (PB_NODES, PB_NODES), device='cpu'
                           ).fill_cache(dense_weight=w_np,
                                        cache_dtype=torch.bfloat16)
        cpu = parity_run(torch, kind, state, torch.from_numpy(x_np), ei_cpu,
                         torch.from_numpy(y_np), 'cpu')
        res = {'seconds_per_500_steps': wall_s, 'ms_per_step': ms,
               'host_enqueue_ms_per_step': enqueue_ms, 'steps': n_steps,
               'cache_build_ms': build_ms, 'launches': counts}
        res.update(prof)
        res['parity'] = check_parity(torch, f'path F {kind}', card, cpu,
                                     False, tol=1e-3)
        cap = captured_training(
            torch, f'path F {kind} captured', lambda: from_state(
                torch, lambda: train_model(torch, kind, None, seed), state),
            x, ei, y, None, {}, PB_STEPS, 1e-3)
        res['captured'] = cap
        for mode, secs in (('eager', wall_s),
                           ('captured', cap['seconds_for_steps'])):
            log(json.dumps(bench_line(torch, kind, secs, mode, 'bfloat16',
                                      PB_NODES * PB_NODES * 2
                                      + 2 * PB_NODES * TR_F * 4)))
        results[kind] = res
        del ei, ei_cpu
    return results


def phase_path_g(torch, seed, iters, warmup):
    """The dense serving ladder of ``inference_bench.py:67-78``: GCN over
    the f32, bf16 and int8 dense caches of the serving graph, with the cap
    lifted as at ``:55``. f32 against the CPU plain sparse path (1e-4 of the
    largest output: float32 sums in another order, TF32 off); bf16 against
    the f32 dense arm, relative < 2e-2 (``tests/test_dense_spmm.py:114``);
    int8 < 3e-2 (``tests/test_int8_spmm.py:39``); argmax agreement with
    the sparse arm printed, not held (random weights)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    x_np, coo, w_np = serving_graph(seed)
    x = torch.as_tensor(x_np, device='cuda')
    model = build_model(torch, 'GCN', None, seed).eval()
    ref = cpu_reference(torch, model, 'GCN', x_np, coo, w_np)
    old_cap = os.environ.get('PGT_DENSE_SPMM_ENTRIES')
    os.environ['PGT_DENSE_SPMM_ENTRIES'] = str(N_NODES * N_NODES + 1)
    results, outs = {}, {}
    try:
        for arm, dt in (('f32', None), ('bf16', torch.bfloat16),
                        ('int8', torch.int8)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ei = EdgeIndex(coo, (N_NODES, N_NODES)).fill_cache(
                dense_weight=w_np, cache_dtype=dt)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            build_peak = torch.cuda.max_memory_allocated() / 1e9
            check(spmm_regime(ei) == 'dense-cached',
                  f'path G {arm}: regime {spmm_regime(ei)!r}')
            cache_gb = ei.dense_adj.numel() * ei.dense_adj.element_size() / 1e9
            reset_counts()
            with torch.inference_mode():
                ms, _, _, out = timed_calls(torch, lambda: model(x, ei),
                                            iters, warmup)
                breakdown = profile_forwards(torch, lambda: model(x, ei))
            counts = launch_counts()
            check(not any(counts.values()),
                  f'path G {arm}: kernels launched {counts}')
            outs[arm] = out.float().cpu()
            res = {'ms_per_forward': ms,
                   'edges_per_s': 3 * N_EDGES / (ms / 1e3),
                   'cache_build_s': build_s, 'cache_gb': cache_gb,
                   'build_peak_gb': build_peak, 'launches': counts,
                   'argmax_agreement_vs_sparse': float(
                       (outs[arm].argmax(-1) == ref.argmax(-1)).double()
                       .mean())}
            cap, cap_out = captured_serving(
                torch, f'path G {arm} captured', lambda x: model(x, ei), x,
                out, iters, warmup, {})
            res['captured'] = cap
            if arm == 'f32':
                diff, _ = compare(torch, 'path G f32', out, ref)
                res['max_abs_diff_vs_cpu_sparse'] = diff
                cap['max_abs_diff_vs_cpu_sparse'], _ = compare(
                    torch, 'path G f32 captured', cap_out, ref)
            else:
                base = outs['f32']
                lim = 2e-2 if arm == 'bf16' else 3e-2
                for key, tag, got in (
                        ('max_rel_diff_vs_f32_dense', arm, outs[arm]),
                        ('captured_max_rel_diff_vs_f32_dense',
                         f'{arm} captured', cap_out.float().cpu())):
                    rel = float((got - base).abs().max() / base.abs().max())
                    res[key] = rel
                    log(f'[path G {tag}] against the f32 dense arm: max '
                        f'|diff| / max |f32| {rel:.3e} (limit {lim:g})')
                    check(rel < lim, f'path G {tag}: {rel} relative to f32')
            rows, prof_ms, _ = breakdown
            busy = sum(t for _, t, _ in rows)
            res.update(device_busy_ms_per_forward=busy,
                       profiled_ms_per_forward=prof_ms,
                       device_idle_share=1 - busy / prof_ms,
                       kernels_per_forward=[[n[:80], t, c]
                                            for n, t, c in rows[:6]])
            log(f'[path G {arm}] torch.profiler, a whole window: device busy '
                f'{busy:.4f} ms per forward of {prof_ms:.4f} ms, idle share '
                f'{1 - busy / prof_ms:.4f}; top: ' + '; '.join(
                    f'{n[:50]} {t:.4f} ms x{c:g}' for n, t, c in rows[:3]))
            log(f"[path G {arm}] dense {arm} cache ({cache_gb:.3f} GB, built "
                f"in {build_s:.3f} s, build peak {build_peak:.3f} GB): "
                f"{ms:.4f} ms per forward, {res['edges_per_s']:.4e} edges/s; "
                f"argmax agreement with the sparse arm "
                f"{res['argmax_agreement_vs_sparse']:.6f}")
            log(json.dumps({'metric': 'gcn_inference_fwd',
                            'arm': f'dense-{arm}', 'ms': ms,
                            'ms_captured': cap['ms_per_forward'],
                            'edges_per_s': res['edges_per_s'],
                            'nodes': N_NODES, 'edges': N_EDGES,
                            'hidden': WIDTH, 'iters': iters}))
            results[arm] = res
            del ei, out, cap_out
            torch.cuda.empty_cache()
    finally:
        if old_cap is None:
            os.environ.pop('PGT_DENSE_SPMM_ENTRIES', None)
        else:
            os.environ['PGT_DENSE_SPMM_ENTRIES'] = old_cap
    return results


def phase_path_h(torch, seed, iters, warmup):
    """bf16-feature serving: GraphSAGE and GIN on the serving graph from
    bf16 features over ``fill_cache()``, the JAX ``'pallas'`` regime with
    bf16 messages. Layer 1 aggregates bf16 (one bf16 segment-sum launch per
    forward); the float32 parameters promote the rest (two float32
    launches). Against the CPU plain path from the same bf16 input and
    weights, within 1e-2 of the largest output (a bf16 rounding of a layer-1
    sum can flip where the two sum orders differ), argmax agreement >=
    0.99."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    x_np, coo, _ = serving_graph(seed)
    ei = EdgeIndex(coo, (N_NODES, N_NODES)).fill_cache()
    ei_cpu = EdgeIndex(coo, (N_NODES, N_NODES), device='cpu').fill_cache()
    xb = torch.as_tensor(x_np, device='cuda').bfloat16()
    results = {}
    for kind in ('GraphSAGE', 'GIN'):
        model = build_model(torch, kind, None, seed).eval()
        torch.cuda.synchronize()
        reset_counts()
        with torch.inference_mode():
            ms, enqueue_ms, _, out = timed_calls(
                torch, lambda: model(xb, ei), iters, warmup)
            breakdown = profile_forwards(torch, lambda: model(xb, ei))
        n_fwd = warmup + iters + breakdown[2]
        counts = launch_counts()
        check_counts(f'path H {kind}', counts,
                     {'segment_spmm_bf16': n_fwd,
                      'segment_spmm': (N_LAYERS - 1) * n_fwd},
                     f'{n_fwd} forwards')
        ref_model = build_model(torch, kind, 'cpu', 0).eval()
        ref_model.load_state_dict({k: v.cpu()
                                   for k, v in model.state_dict().items()})
        with torch.inference_mode():
            ref = ref_model(xb.cpu(), ei_cpu)
        eager_out, out = out, out.float().cpu()
        check(tuple(out.shape) == (N_NODES, N_OUT)
              and bool(torch.isfinite(out).all()),
              f'path H {kind}: output {tuple(out.shape)}')
        diff = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        agree = float((out.argmax(-1) == ref.argmax(-1)).double().mean())
        log(f'[path H {kind}] bf16 features: {ms:.4f} ms per forward on the '
            f'card (CUDA events, {iters} forwards), the host issues one in '
            f'{enqueue_ms:.4f} ms; launches {counts} in {n_fwd} forwards; '
            f'vs the CPU plain path from the same bf16 input: max abs diff '
            f'{diff:.3e} (max |ref| {scale:.3e}), argmax agreement '
            f'{agree:.6f}')
        check(diff <= 1e-2 * max(1.0, scale),
              f'path H {kind}: max abs diff {diff}')
        check(agree >= 0.99, f'path H {kind}: argmax agreement {agree}')
        res = {'ms_per_forward': ms, 'host_enqueue_ms_per_forward':
               enqueue_ms, 'edges_per_s': 3 * N_EDGES / (ms / 1e3),
               'forwards': n_fwd, 'launches': counts,
               'max_abs_diff_vs_cpu': diff, 'argmax_agreement': agree}
        rows, prof_ms, _ = breakdown
        busy = sum(t for _, t, _ in rows)
        res.update(device_busy_ms_per_forward=busy,
                   profiled_ms_per_forward=prof_ms,
                   device_idle_share=1 - busy / prof_ms)
        log(f'[path H {kind}] torch.profiler, a whole window: device busy '
            f'{busy:.4f} ms per forward of {prof_ms:.4f} ms, idle share '
            f'{1 - busy / prof_ms:.4f}')
        cap, cap_out = captured_serving(
            torch, f'path H {kind} captured', lambda x: model(x, ei), xb,
            eager_out, iters, warmup,
            {'segment_spmm_bf16': 1, 'segment_spmm': N_LAYERS - 1})
        cap_out = cap_out.float().cpu()
        cap['max_abs_diff_vs_cpu'] = float((cap_out - ref).abs().max())
        cap['argmax_agreement'] = float(
            (cap_out.argmax(-1) == ref.argmax(-1)).double().mean())
        log(f"[path H {kind} captured] vs the CPU plain path: max abs diff "
            f"{cap['max_abs_diff_vs_cpu']:.3e}, argmax agreement "
            f"{cap['argmax_agreement']:.6f}")
        check(cap['max_abs_diff_vs_cpu'] <= 1e-2 * max(1.0, scale),
              f"path H {kind} captured: max abs diff "
              f"{cap['max_abs_diff_vs_cpu']}")
        check(cap['argmax_agreement'] >= 0.99,
              f"path H {kind} captured: argmax agreement "
              f"{cap['argmax_agreement']}")
        res['captured'] = cap
        results[kind] = res
    return results


def sparse_library_call(torch, indptr, cols, vals, n_rows, n_cols, x):
    """``torch.sparse.mm`` on a CSR tensor (a yardstick; the port never
    calls it): ``(fn, out)`` or ``(None, error)``."""
    try:
        a = torch.sparse_csr_tensor(indptr, cols, vals, size=(n_rows, n_cols))
        out = torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f'{type(e).__name__}: {str(e)[:200]}'
    return (lambda: torch.sparse.mm(a, x)), out


def phase_bf16_timings(torch, seed, pe, pc):
    """Device time per call of each bf16 kernel at its path's shapes, with
    its plain version, a library call where one computes the same function
    in bf16 (``torch.sparse.mm`` on a bf16 CSR or BSR tensor; its output is
    bf16, so it is held to the plain version within 1e-2 of the largest
    magnitude), and the bound: the segment sum at path H's layer 1 (F =
    128, unweighted), the BSR kernel on path E's layouts at F = 64 and 10,
    the mix at path C's H*F = 256; then kernel 1's lane-group sweep at
    path H's layer 1."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops.bsr_spmm import (bsr_matmul,
                                                          bsr_spmm_plain)
    from pytorch_geometric_tpu_torch.ops.gat_fused import (card_slice_cols,
                                                           gat_mix,
                                                           gat_mix_plain)
    rng = np.random.default_rng(seed + 8)

    def lib_row(info, lib, ref):
        """The library call's ``fns`` entry, or its error in ``info``."""
        fn, out = lib
        if fn is None:
            info['library_ms'], info['library_error'] = None, out
            return {}
        d = float((out.float()[:ref.shape[0]] - ref.float()).abs().max())
        check(d <= 1e-2 * float(ref.float().abs().max()),
              f"library call disagrees with the plain version by {d}")
        return {'library_ms': fn}

    def lib_txt(row):
        return (f"{row['library_ms']:.4f} ms" if row['library_ms'] is not None
                else f"none ({row['library_error']})")

    rows = {}
    with torch.inference_mode():
        # kernel 1 bf16: path H's layer-1 aggregation, and its lane-group
        # sweep
        x_np, coo, _ = serving_graph(seed)
        csc = EdgeIndex(coo, (N_NODES, N_NODES), device='cuda').fill_cache(
            blocked=False).csc
        xb = torch.as_tensor(x_np, device='cuda').bfloat16()
        label = f'bf16 F={WIDTH} (path H layer 1)'
        rows['segment_spmm_bf16'] = [segment_timed(
            torch, label, csc.indptr, csc.indices, None, xb)]
        rows['segment_spmm_bf16_sweep'] = plan_sweep(
            torch, label, csc.indptr, csc.indices, None, xb)
        # kernel 2 bf16: path E's layouts
        rows['bsr_spmm_bf16'] = []
        for lay_name, layout in (('forward', pe['ei'].bsr),
                                 ('transposed', pe['ei'].bsr_t)):
            nb = int(layout.vals.shape[0])
            nnz = int(torch.count_nonzero(layout.vals))
            for f in (TR_F, TR_CLASSES):
                x = torch.as_tensor(rng.standard_normal(
                    (PA_NODES, f)).astype(np.float32), device='cuda')
                b_ms, b_by, by = bsr_bound_ms(
                    nb, nnz, layout.row_ptr.shape[0] - 1, PA_NODES,
                    PA_NODES, f, val_bytes=2, flop_rate=BF16_FLOP_PER_S)
                row = {'layout': lay_name, 'F': f, 'blocks': nb,
                       'block_nonzeros': nnz, 'bound_ms': b_ms,
                       'bound_by': b_by, 'bytes': by,
                       'flops': 2.0 * nnz * f,
                       'kernel_flops': 2.0 * nb * 128 * 128 * f}
                fns = {'ms': lambda: bsr_matmul(layout, x, PA_NODES),
                       'plain_ms': lambda: bsr_spmm_plain(layout, x,
                                                          PA_NODES)}
                fns.update(lib_row(row, bsr_library_call(
                    torch, layout, PA_NODES, x.bfloat16()),
                    fns['plain_ms']()))
                rows['bsr_spmm_bf16'].append(bsr_timed(torch, row, fns))
                log(f"[timing] bsr_spmm bf16 {lay_name} F={f}, device time "
                    f"per call: kernel {row['ms']:.4f} ms (pre-pass "
                    f"{row['prep_ms']:.4f}, kernel proper "
                    f"{row['main_ms']:.4f}; {row['tb_per_s']:.3f} TB/s of "
                    f"the bytes it must move; HGMMA in the SASS: "
                    f"{row['hgmma_in_sass']}), plain "
                    f"{row['plain_ms']:.4f} ms, torch.sparse.mm (bf16 BSR) "
                    f"{lib_txt(row)}; bound {b_ms:.4f} ms ({b_by}), kernel "
                    f"at {100 * b_ms / row['ms']:.1f}% of the bound; "
                    f"CUDA-event wall per call: kernel {row['event_ms']:.4f} "
                    f"ms")
        # the mix's bf16 arm at path C's hidden width
        blk = pc['ei'].blocked
        n, h = PC_NODES, PC_HEADS
        f = PC_HIDDEN // h
        slots, e = blk.src.shape[0], int(blk.indptr[-1])
        p = torch.as_tensor(rng.random((slots, h)).astype(np.float32),
                            device='cuda').bfloat16()
        v = torch.as_tensor(rng.standard_normal((n, h * f)).astype(
            np.float32), device='cuda').bfloat16()
        fns = {'ms': lambda: gat_mix(blk.indptr, blk.src, p, p, v, f),
               'plain_ms': lambda: gat_mix_plain(blk.indptr, blk.src, p, p,
                                                 v, f)}
        _, ref = fns['plain_ms']()
        mats = [torch.sparse_csr_tensor(blk.indptr, blk.src,
                                        p[:, k].contiguous(), size=(n, n))
                for k in range(h)]
        vs = [v.view(n, h, f)[:, k].contiguous() for k in range(h)]
        try:
            lib_out = torch.stack([torch.sparse.mm(a, b)
                                   for a, b in zip(mats, vs)], 1)
            torch.cuda.synchronize()
            lib = (lambda: [torch.sparse.mm(a, b) for a, b in zip(mats, vs)],
                   lib_out.reshape(n, h * f))
        except (RuntimeError, NotImplementedError, TypeError) as err:
            lib = (None, f'{type(err).__name__}: {str(err)[:200]}')
        info = {'pass': 'mix (s, u)', 'H': h, 'F': f, 'HF': h * f,
                'slots': e, 'slice_cols': card_slice_cols(v, h, f)}
        fns.update(lib_row(info, lib, ref))
        # p, v, s, u in bf16, the indices, once each
        row = timed_row(torch, fns, info,
                        slots * h * 2 + (n + 1) * 4 + n * h * 2
                        + 2 * n * h * f * 2 + slots * 4,
                        2.0 * e * h * f + e * h)
        rows['gat_mix_bf16'] = [row]
        log(f"[timing] gat_mix bf16 mix H*F={h * f} (slice width "
            f"{row['slice_cols']}), device time per call: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"{h} torch.sparse.mm (bf16 CSR) {lib_txt(row)}; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), kernel at "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound; "
            f"CUDA-event wall per call: kernel {row['event_ms']:.4f} ms")
    return rows


# -- the captured paths (compat.compile) -------------------------------------
def replay_expect(per_call):
    """Per call, the launches a profile of replays must show of each port
    kernel, from the wrappers' per-call counts (both arms of a kernel share
    its name)."""
    out = {}
    for part, arms in ((SEG_MAIN, ('segment_spmm', 'segment_spmm_bf16')),
                       (BSR_MAIN, ('bsr_spmm', 'bsr_spmm_bf16')),
                       (MIX_KERNEL, ('gat_mix', 'gat_mix_bf16')),
                       (EDGE_DOT_KERNEL, ('edge_dot', 'edge_dot_bf16')),
                       (EDGE_DOT_COMBINE, ('edge_dot_combine',)),
                       *((k, (c,)) for c, k in FLASH_KERNELS.items())):
        n = sum(per_call.get(a, 0) for a in arms)
        if n:
            out[part] = n
    return out


def check_replays(tag, compiled, counts, per_call, over):
    """The counts of a captured path: the wrappers counted the eager
    warm-ups only (``per_call`` each), the graph holds ``per_call``
    launches, and the replays made the rest. Returns the launches of the
    whole path, warm-ups and replays."""
    check_counts(tag, counts, {k: n * CAPTURE_WARMUP
                               for k, n in per_call.items()},
                 f'{CAPTURE_WARMUP} eager warm-ups')
    want = {k: n for k, n in per_call.items() if n}
    check(compiled.launches_per_replay == want,
          f'{tag}: launches per replay {compiled.launches_per_replay}, '
          f'expected the eager per-call counts {want}')
    replayed = compiled.replay_launches()
    total = {k: counts[k] + replayed.get(k, 0) for k in counts}
    log(f'[{tag}] launches: {CAPTURE_WARMUP} eager warm-ups counted '
        f'{ {k: v for k, v in counts.items() if v} }, the graph holds '
        f'{compiled.launches_per_replay} per replay, {compiled.replays} '
        f'replays in {over}: {total} in all')
    return total


def captured_serving(torch, tag, fwd, x, eager_out, iters, warmup,
                     per_call):
    """``fwd(x)`` through ``compat.compile`` under inference mode: 2 eager
    warm-ups, the capture (replayed once), then ``iters`` timed replays
    after ``warmup``; a whole-window profile of the replays, which must
    show the port's kernels (``replay_expect``); the launch counts
    (``check_replays``); the output against the eager one. Returns ``(res,
    out)``; the caller holds ``out`` against the CPU plain path."""
    from pytorch_geometric_tpu_torch import compat
    comp = compat.compile(fwd)
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        for _ in range(CAPTURE_WARMUP + 1):
            out = comp(x)
        check(comp.captures == 1 and comp.replays == 1,
              f'{tag}: {comp.captures} captures, {comp.replays} replays')
        ms, enqueue_ms, _, _ = timed_calls(torch, lambda: comp(x), iters,
                                          warmup)
        rows, prof_ms, _ = profile_forwards(torch, lambda: comp(x),
                                            replay_expect(per_call))
    torch.cuda.synchronize()
    launches = check_replays(tag, comp, launch_counts(), per_call,
                             f'{comp.replays} forwards')
    bitwise = bool(torch.equal(out, eager_out))
    diff = float((out.float() - eager_out.float()).abs().max())
    busy = sum(t for _, t, _ in rows)
    res = {'ms_per_forward': ms, 'host_enqueue_ms_per_forward': enqueue_ms,
           'replays': comp.replays,
           'launches_per_replay': comp.launches_per_replay,
           'launch_counts': launches,
           'bitwise_equal_to_eager': bitwise, 'max_abs_diff_vs_eager': diff,
           'device_busy_ms_per_forward': busy,
           'profiled_ms_per_forward': prof_ms,
           'device_idle_share': 1 - busy / prof_ms,
           'kernels_per_forward': [[n[:80], t, c] for n, t, c in rows[:8]]}
    log(f'[{tag}] compat.compile (a CUDA graph): {ms:.4f} ms per forward on '
        f'the card (CUDA events, {iters} replays after {warmup}), the host '
        f'issues one in {enqueue_ms:.4f} ms; device busy {busy:.4f} ms per '
        f'forward of a {prof_ms:.4f} ms wall (torch.profiler), idle share '
        f"{res['device_idle_share']:.4f}; output bitwise equal to the eager "
        f'forward: {bitwise} (max abs diff {diff:.3e})')
    del comp
    return res, out


def captured_training(torch, tag, make_model, x, ei, y, w, per_step, steps,
                      tol, lr=TR_LR, sync_state=False, cancelled=()):
    """A training step through ``compat.compile`` from the weights
    ``make_model`` gives, with ``Adam(capturable=True)``; ``x``, ``ei``,
    ``y`` and ``w`` (GCN's per-call weights, or None) are read in place.

    Parity: 5 steps (2 eager warm-ups, the capture replayed once, 2
    replays) against 5 eager steps of the same step from the same weights:
    each loss within ``tol`` relative, the gradients of the first replayed
    step (the third) within ``tol`` of each tensor's largest magnitude,
    with whether they are bitwise equal. Then ``steps`` timed replays after
    2 (ms per step, the host seconds they took), a whole-window profile
    that must show the port's kernels (``replay_expect``) and the launch
    counts.

    ``sync_state``: for a step that is not bitwise repeatable eagerly (its
    sums use atomics), the eager run's parameters and Adam moments after
    its 2 warm-ups are copied into the compiled run's before the capture,
    so the compared gradients start from the same weights. Otherwise Adam
    turns the rounding of gradients that cancel (near zero) into steps of
    the full learning rate, and two eager runs of such a step part by more
    than ``tol`` by step 3. ``cancelled``: as ``check_parity``'s, gradients
    the model cancels exactly, held to ``tol`` of the largest of all."""
    from pytorch_geometric_tpu_torch import compat

    def tensors(model, opt):
        return [p for p in model.parameters()] + [
            st[k] for p in model.parameters()
            for st in (opt.state.get(p, {}),) for k in sorted(st)
            if isinstance(st[k], torch.Tensor)]

    def new():
        model = make_model()
        opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True)
        opts.append(opt)

        def step(x, ei, y, w):
            opt.zero_grad(set_to_none=True)
            kw = {} if w is None else {'edge_weight': w}
            loss = torch.nn.functional.cross_entropy(model(x, ei, **kw), y)
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step

    n = CAPTURE_WARMUP + PARITY_STEPS
    runs, opts, snap = [], [], None
    for compiled in (False, True):
        model, step = new()
        if compiled:
            step = compat.compile(step, static_argnums=(0, 1, 2, 3))
            torch.cuda.synchronize()
            reset_counts()
        losses, grads = [], None
        for i in range(n):
            if sync_state and i == CAPTURE_WARMUP:
                held = tensors(model, opts[-1])
                if snap is None:
                    snap = [t.detach().clone() for t in held]
                else:
                    with torch.no_grad():
                        for t, v in zip(held, snap):
                            t.copy_(v)
                    log(f'[{tag}] the eager run\'s weights and Adam moments '
                        f'after {CAPTURE_WARMUP} steps copied in before the '
                        'capture')
            losses.append(step(x, ei, y, w))
            if i == CAPTURE_WARMUP:
                grads = grads_of(torch, model)
        runs.append((torch.stack(losses).cpu(), grads, step))
    (l_eager, g_eager, _), (l_cap, g_cap, comp) = runs
    check(comp.captures == 1 and comp.replays == PARITY_STEPS,
          f'{tag}: {comp.captures} captures, {comp.replays} replays')
    rel = float(((l_cap - l_eager).abs() / l_eager.abs()).max())
    losses_bitwise = bool(torch.equal(l_cap, l_eager))
    grad_rel, grads_bitwise, by_tensor = 0.0, True, {}
    largest = max(float(g.abs().max()) for g in g_eager.values())
    for k, ref in g_eager.items():
        d = float((g_cap[k] - ref).abs().max())
        grads_bitwise = grads_bitwise and bool(torch.equal(g_cap[k], ref))
        scale = largest if k.endswith(tuple(cancelled)) else float(
            ref.abs().max())
        by_tensor[k] = d / max(scale, 1e-30)
        grad_rel = max(grad_rel, by_tensor[k])
    far = sorted(by_tensor.items(), key=lambda kv: -kv[1])[:3]
    log(f'[{tag}] largest captured-vs-eager gradient gaps (of each '
        f'tensor\'s largest): ' + ', '.join(f'{k} {v:.3e}' for k, v in far))
    log(f'[{tag}] compat.compile step vs the eager step, same weights and '
        f'capturable Adam, {n} steps ({CAPTURE_WARMUP} eager warm-ups, then '
        f'replays): losses {l_cap.tolist()} vs {l_eager.tolist()}, max '
        f'relative diff {rel:.3e} (limit {tol:g}), bitwise {losses_bitwise}; '
        f'gradients of step {CAPTURE_WARMUP + 1} (the first replay): max '
        f'|diff| / max|eager| {grad_rel:.3e}, bitwise {grads_bitwise}')
    check(rel <= tol, f'{tag}: captured losses differ from the eager ones by '
                      f'{rel} relative')
    check(grad_rel <= tol, f'{tag}: captured gradients differ from the '
                           f'eager ones by {grad_rel} of their largest')
    ms, wall_s, enqueue_ms, last = timed_steps(
        torch, lambda: comp(x, ei, y, w), 2, steps)
    prof, _ = profile_steps(torch, lambda: comp(x, ei, y, w), tag,
                            replay_expect(per_step))
    torch.cuda.synchronize()
    launches = check_replays(tag, comp, launch_counts(), per_step,
                             f'{comp.replays} steps')
    res = {'ms_per_step': ms, 'seconds_for_steps': wall_s,
           'timed_steps': steps, 'host_enqueue_ms_per_step': enqueue_ms,
           'final_loss': last, 'replays': comp.replays,
           'launches_per_replay': comp.launches_per_replay,
           'launch_counts': launches,
           'parity_vs_eager': {
               'losses_captured': l_cap.tolist(),
               'losses_eager': l_eager.tolist(), 'max_loss_rel_diff': rel,
               'losses_bitwise': losses_bitwise,
               'max_grad_rel_diff': grad_rel,
               'grads_bitwise': grads_bitwise}}
    res.update(prof)
    log(f'[{tag}] compat.compile: {ms:.4f} ms per step on the card (CUDA '
        f'events, {steps} replays after 2), {wall_s:.4f} s for the {steps} '
        f'steps on the host clock; the host issues one in {enqueue_ms:.4f} '
        f'ms; final loss {last:.6f}')
    del comp
    return res


# -- the sampled scan (loader/scan_train.py) ----------------------------------
def products_graph(n, e, seed):
    """``benchmarks/products_bench.py::build_products_like`` (``:44-65``):
    ``e`` directed edges over ``n`` nodes, 60 % inside communities of 2,400
    nodes and the rest toward hub-skewed ids, ids scrambled; ``[2, e]``
    int32 (source, destination)."""
    rng = np.random.default_rng(seed)
    csize = 2400
    n_comm = max(n // csize, 1)
    src = rng.integers(0, n, e, dtype=np.int64)
    intra = rng.random(e) < 0.6
    comm = np.minimum(src // csize, n_comm - 1)
    dst_intra = comm * csize + rng.integers(0, csize, e)
    dst_hub = (n * rng.random(e) ** 3).astype(np.int64)
    dst = np.minimum(np.where(intra, dst_intra, dst_hub), n - 1)
    perm = rng.permutation(n)
    return np.stack([perm[src], perm[dst]]).astype(np.int32)


def products_gat(torch, device, seed):
    """Path K's model, ``products_bench.py --gat``'s (``run_gat``,
    ``:347-410``): ``GATConv(100, 16, heads=4)`` -> ReLU -> ``GATConv(64, 47,
    heads=1, concat=False)``, default self loops, random weights from
    ``seed``. Its parameter names are those of a flax ``Net`` whose convs
    are named ``conv_0`` and ``conv_1``."""
    from pytorch_geometric_tpu_torch.nn.conv import GATConv
    gen = torch.Generator().manual_seed(seed)
    convs = [GATConv(PR_F, PR_HIDDEN // 4, heads=4, device=device,
                     generator=gen),
             GATConv(PR_HIDDEN, PR_CLASSES, heads=1, concat=False,
                     device=device, generator=gen)]

    class ProductsGAT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList(convs)

        def forward(self, x, ei):
            return self.convs[1](torch.relu(self.convs[0](x, ei)), ei)

    return ProductsGAT()


def batch_fill(batches, fanouts):
    """The share of node and edge slots the batches fill, the real edges per
    hop, and the padded edges (all gathered from one clamped row)."""
    bs = int(batches[0].batch_size)
    caps = [bs]
    for f in fanouts:
        caps.append(caps[-1] * f)
    e_caps = [caps[h] * f for h, f in enumerate(fanouts)]
    n_cap, e_cap = sum(caps), sum(e_caps)
    nodes = np.array([int(b.node_mask.sum()) for b in batches])
    edges = np.array([int(b.edge_mask.sum()) for b in batches])
    hop_edges, lo = [], 0
    for c in e_caps:
        hop_edges.append(float(np.mean([int(b.edge_mask[lo:lo + c].sum())
                                        for b in batches])))
        lo += c
    return {'n_cap': n_cap, 'edge_slots': e_cap,
            'nodes_per_batch': float(nodes.mean()),
            'node_fill': float(nodes.mean() / n_cap),
            'edges_per_batch': float(edges.mean()),
            'edge_fill': float(edges.mean() / e_cap),
            'edges_per_hop': hop_edges, 'edge_slots_per_hop': e_caps,
            'padded_edges_per_batch': float(e_cap - edges.mean())}


def products_data(torch, coo, seed):
    """``products_bench.py``'s training data (``:165-168``) over ``coo``: X
    [N, 100] float32 and 47 labels, made on the card from ``seed``, in a
    ``Data`` that keeps them there."""
    from pytorch_geometric_tpu_torch.data import Data
    gen = torch.Generator(device='cuda').manual_seed(seed)
    X = torch.randn((N_PRODUCTS, PR_F), generator=gen, device='cuda')
    Y = torch.randint(0, PR_CLASSES, (N_PRODUCTS,), generator=gen,
                      device='cuda')
    return Data(x=X, edge_index=coo, y=Y, num_nodes=N_PRODUCTS)


def kernels_and_copies(rows):
    """Device ms per call of a profile's rows (``whole_window``): kernels,
    and host-to-card copies and fills (a copy on another stream may overlap
    a kernel)."""
    copies = sum(t for n, t, _ in rows if n.startswith(('Memcpy', 'Memset')))
    return sum(t for _, t, _ in rows) - copies, copies


def stacked_groups(it, groups):
    """``groups`` host-stacked groups of K batches drawn from ``it``."""
    from pytorch_geometric_tpu_torch.loader import stack_batches
    for _ in range(groups):
        yield stack_batches([next(it) for _ in range(PR_K)], device='cpu')


def end_to_end(torch, scan_fn, X, Y, loader, overlap):
    """``products_bench.py``'s end-to-end loop (``:198-280``): ``PR_STEPS``
    steps rounded up to whole groups of K, host sampling included, the
    loader's batches sampled ahead on a producer thread
    (``PrefetchLoader(put=False)``, its own ``num_workers`` threads inside).
    Without ``overlap`` the main thread stacks each group and uploads it
    (a pageable copy, which waits for the card) before its replay; with it a
    second ``PrefetchLoader`` stacks and uploads group k+1 through pinned
    buffers on a copy stream while group k's replay runs. Returns (steps,
    the last loss)."""
    from pytorch_geometric_tpu_torch.loader import (PrefetchLoader,
                                                    stack_batches)
    groups = -(-PR_STEPS // PR_K)
    it = iter(PrefetchLoader(loader, num_threads=1, put=False))
    loss = None
    try:
        if overlap:
            for dev in PrefetchLoader(stacked_groups(it, groups),
                                      device='cuda', num_threads=1):
                loss = scan_fn(X, Y, dev)
        else:
            for _ in range(groups):
                group = [next(it) for _ in range(PR_K)]
                loss = scan_fn(X, Y, stack_batches(group, device='cuda'))
    finally:
        it.close()
    return groups * PR_K, loss


def route_timings(torch, tag, step_fn, scan_fn, X, Y, rows, stacked,
                  expect):
    """ms per step of one route on the same K batches: eager steps (the
    body), ``step_fn`` replays, ``scan_fn`` replays over K (CUDA events,
    ``PR_REPS`` rounds), and a whole-window profile of the scan replay,
    which must show ``expect`` launches per replay."""
    def eager_steps():
        for r in rows:
            step_fn.__wrapped__(X, Y, r)

    def step_replays():
        for r in rows:
            step_fn(X, Y, r)

    res = {}
    for name, fn in (('eager', eager_steps), ('step_fn', step_replays),
                     ('scan_fn', lambda: scan_fn(X, Y, stacked))):
        ms, enq, _, _ = timed_calls(torch, fn, PR_REPS, 1)
        res[f'ms_per_step_{name}'] = ms / PR_K
        res[f'host_enqueue_ms_per_step_{name}'] = enq / PR_K
    # the idle share against the unprofiled replay (the profiler slows the
    # host's side of it)
    prof_rows, prof_ms, _ = whole_window(
        torch, lambda: scan_fn(X, Y, stacked), PROFILED_STEPS, expect)
    busy = sum(t for _, t, _ in prof_rows)
    res.update({'scan_device_busy_ms_per_step': busy / PR_K,
                'scan_profiled_ms_per_step': prof_ms / PR_K,
                'scan_device_idle_share':
                    1 - busy / PR_K / res['ms_per_step_scan_fn'],
                'kernel1_ms_per_step': sum(
                    t for n, t, _ in prof_rows if SEG_MAIN in n) / PR_K,
                'kernels_per_scan': [[n[:80], t, c]
                                     for n, t, c in prof_rows[:8]]})
    log(f"[{tag}] ms per step on K = {PR_K} batches: eager "
        f"{res['ms_per_step_eager']:.4f}, step_fn replays "
        f"{res['ms_per_step_step_fn']:.4f}, scan_fn "
        f"{res['ms_per_step_scan_fn']:.4f} (CUDA events, {PR_REPS} rounds); "
        f"the scan replay busies the card {busy / PR_K:.4f} ms per step "
        f"(torch.profiler; {prof_ms / PR_K:.4f} ms a step profiled), idle "
        f"share {res['scan_device_idle_share']:.4f} of the unprofiled "
        "replay")
    for name, t, n in prof_rows[:8]:
        log(f'[{tag}]   {t / PR_K:.4f} ms a step  x{n / PR_K:g}  '
            f'{name[:90]}')
    return res


def sampled_kernel_rows(torch, seed, r, X, served):
    """Kernel 1 at the sampled path's shapes, each on the CSC (or CSR) of a
    real batch: training layers 1 and 2 forward (F = 100, 64) and layer 2's
    transposed backward (F = 64) on the first training batch ``r``, serving
    layers 1 and 2 (F = 100, 64) on the first served batch (``served``:
    its recorded layer-1 input, COO, size and layer-2 input); each against
    its plain version (``segment_close``), timed with its bound and
    ``torch.sparse.mm`` (``segment_timed``). Returns (rows, worst error)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        batch_edge_index
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm
    gen = torch.Generator(device='cuda').manual_seed(seed + 13)
    rows, worst = [], 0.0
    mask = r['node_mask']
    x_train = torch.where(mask[:, None],
                          X[torch.where(mask, r['n_id'], 0).long()], 0.0)
    train = batch_edge_index(r['edge_index'], r['edge_mask'],
                             mask.shape[0])
    x1, coo, size, x2 = served
    serve = EdgeIndex(coo.cuda(), size).fill_cache(blocked=False)
    for label, ei, x, layout, f in (
            ('train layer 1 forward', train, x_train, 'csc', PR_F),
            ('train layer 2 forward', train, None, 'csc', PR_HIDDEN),
            ('train layer 2 backward (A^T g)', train, None, 'csr',
             PR_HIDDEN),
            ('serve layer 1', serve, x1.cuda(), 'csc', PR_F),
            ('serve layer 2', serve, x2.cuda(), 'csc', PR_HIDDEN)):
        o = ei.csc if layout == 'csc' else ei.csr
        if x is None:
            x = torch.randn((ei.num_src_nodes, f), generator=gen,
                            device='cuda')
        with torch.inference_mode():
            out = segment_spmm(o.indptr, o.indices, None, x)
            err, ok = segment_close(torch, o.indptr, o.indices, None, x, out)
            torch.cuda.synchronize()
            check(ok, f'segment_spmm sampled {label}: {err} from the plain '
                      'version')
            worst = max(worst, err)
            row = segment_timed(torch, f'sampled {label}', o.indptr,
                                o.indices, None, x)
        row['max_abs_err'] = err
        row['slots'] = int(o.indices.shape[0])
        rows.append(row)
    return rows, worst


def phase_scan_train(torch, seed, coo):
    """``products_bench.py --train`` (``:154-335``) through the port's own
    entry points: ``Data`` (X [N, 100] and 47 labels on the card, from
    ``seed``) -> ``NeighborLoader([15, 10], batch 512, shuffle,
    filter_features=False, num_workers=4)`` on the native sampler (the
    phase fails without it: the numpy sampler draws other neighbours) ->
    ``PrefetchLoader`` -> ``stack_batches`` -> ``GraphSAGE(100 -> 64 ->
    47)``, ``Adam(1e-3, capturable=True)``, ``make_device_train_step`` on
    the kernel route (each batch's ``EdgeIndex`` built on the card: kernel
    1 forward at F = 100 and 64, its transposed backward at 64, 3 launches
    a step).

    From one state S (parameters and Adam moments, restored in place so the
    graphs' addresses hold), on the epoch's first K = 8 batches: 8 eager
    steps, 8 ``step_fn`` replays and one ``scan_fn`` replay, bitwise equal
    in loss and parameters. Then the end-to-end loop (``PR_STEPS`` steps,
    host sampling included) without and with the prefetch overlap, each
    timed (the median of ``PR_E2E_ROUNDS`` loops in turns), then profiled
    (``whole_window``; the idle share is taken against the unprofiled
    wall); the gather route (``gather_cross_entropy``, which
    launches no kernel of the port) timed beside the kernel route on the
    same batches. Returns the phase's record, the trained model, the
    ``Data`` (X on the card) and the first batch's row, for
    ``phase_layerwise``, which also times kernel 1 at the sampled shapes."""
    from pytorch_geometric_tpu_torch import csrc
    from pytorch_geometric_tpu_torch.loader import (NeighborLoader,
                                                    make_device_train_step,
                                                    stack_batches)
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        gather_cross_entropy
    from pytorch_geometric_tpu_torch.nn.models import GraphSAGE
    tag = 'scan_train'
    check(csrc.WITH_NATIVE_SAMPLER, f'{tag}: the native sampler did not '
          'build (g++); the numpy sampler would draw other neighbours')
    data = products_data(torch, coo, seed)
    X, Y = data.x, data.y
    t0 = time.perf_counter()
    loader = NeighborLoader(data, num_neighbors=list(PR_FANOUTS),
                            batch_size=PR_BATCH, shuffle=True,
                            filter_features=False, num_workers=PR_WORKERS,
                            seed=seed)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = iter(loader)
    batches = [next(it) for _ in range(PR_K)]
    sample_s = time.perf_counter() - t0
    fill = batch_fill(batches, PR_FANOUTS)
    log(f'[{tag}] NeighborLoader over the products graph ({N_PRODUCTS} '
        f'nodes, {E_PRODUCTS} edges): CSC built in {build_s:.2f} s on the '
        f'host, the first {PR_K} batches sampled in {sample_s:.3f} s (native '
        f'sampler, {PR_WORKERS} threads); per batch '
        f"{fill['nodes_per_batch']:.1f} of {fill['n_cap']} node slots (fill "
        f"{fill['node_fill']:.4f}), {fill['edges_per_batch']:.1f} of "
        f"{fill['edge_slots']} edge slots (fill {fill['edge_fill']:.4f}; by "
        f"hop {fill['edges_per_hop']} of {fill['edge_slots_per_hop']})")
    stacked = stack_batches(batches, device='cuda')
    rows = [{k: v[i] for k, v in stacked.items()} for i in range(PR_K)]
    n_cap = batches[0].num_nodes

    def new_pair(loss_fn=None):
        model = GraphSAGE(PR_F, PR_HIDDEN, 2, PR_CLASSES,
                          generator=torch.Generator().manual_seed(seed))
        opt = torch.optim.Adam(model.parameters(), lr=PR_LR,
                               capturable=True)
        return (model, opt) + make_device_train_step(model, opt, loss_fn)

    model, opt, step_fn, scan_fn = new_pair()
    per_step = {'segment_spmm': 3}
    per_scan = {'segment_spmm': 3 * PR_K}
    torch.cuda.synchronize()
    # the two compiled callables' warm-ups and captures (the first call of
    # step_fn fills Adam's moments)
    reset_counts()
    for i in range(CAPTURE_WARMUP + 1):
        step_fn(X, Y, rows[i])
    torch.cuda.synchronize()
    check_replays(f'{tag} step_fn', step_fn, launch_counts(), per_step,
                  '1 replay')
    reset_counts()
    for _ in range(CAPTURE_WARMUP + 1):
        scan_fn(X, Y, stacked)
    torch.cuda.synchronize()
    check_replays(f'{tag} scan_fn', scan_fn, launch_counts(), per_scan,
                  '1 replay')
    tensors = [p for p in model.parameters()] + [
        v for st in opt.state.values() for v in st.values()
        if isinstance(v, torch.Tensor)]
    state = [t.detach().clone() for t in tensors]

    def restore():
        with torch.no_grad():
            for t, s in zip(tensors, state):
                t.copy_(s)

    def params():
        return [p.detach().clone() for p in model.parameters()]

    reset_counts()
    restore()
    for r in rows:
        l_eager = step_fn.__wrapped__(X, Y, r)
    p_eager = params()
    torch.cuda.synchronize()
    check_counts(tag, launch_counts(), {k: v * PR_K
                                        for k, v in per_step.items()},
                 f'{PR_K} eager steps')
    restore()
    for r in rows:
        l_step = step_fn(X, Y, r)
    p_step = params()
    restore()
    l_scan = scan_fn(X, Y, stacked)
    p_scan = params()
    torch.cuda.synchronize()
    parity = {}
    for name, ls, ps in (('step_fn', l_step, p_step),
                         ('scan_fn', l_scan, p_scan)):
        bitwise = bool(torch.equal(ls, l_eager)) and all(
            torch.equal(a, b) for a, b in zip(ps, p_eager))
        d = max(float((a - b).abs().max()) for a, b in zip(ps, p_eager))
        parity[name] = {'loss': float(ls), 'bitwise_equal_to_eager': bitwise,
                        'max_param_abs_diff': d}
        check(bitwise, f'{tag}: {name} from S is not bitwise the eager '
                       f'steps: loss {float(ls)} vs {float(l_eager)}, '
                       f'parameters {d:.3e} apart')
    log(f'[{tag}] from one state, {PR_K} steps: eager loss '
        f'{float(l_eager):.6f}, {PR_K} step_fn replays {float(l_step):.6f}, '
        f'one scan_fn replay {float(l_scan):.6f}: losses and parameters '
        'bitwise equal (kernel 1 adds without atomics)')
    restore()
    kernel = route_timings(torch, f'{tag} kernel route', step_fn, scan_fn, X,
                           Y, rows, stacked, replay_expect(per_scan))

    # the main path: the end-to-end loop, counts from 0. The host-bound
    # loop's wall moves by up to 25 % from one loop to the next, so each
    # mode runs PR_E2E_ROUNDS times, the modes in turns, and keeps the
    # median
    def kernel1_so_far():
        return (launch_counts()['segment_spmm']
                + scan_fn.replay_launches().get('segment_spmm', 0))

    modes = {'no_overlap': False, 'overlap': True}
    walls = {name: [] for name in modes}
    launched = dict.fromkeys(modes, 0)
    reset_counts()
    for _ in range(PR_E2E_ROUNDS):
        for name, overlap in modes.items():
            k0 = kernel1_so_far()
            t0 = time.perf_counter()
            steps, loss = end_to_end(torch, scan_fn, X, Y, loader, overlap)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            launched[name] += kernel1_so_far() - k0
            check(bool(torch.isfinite(loss)),
                  f'{tag} end to end ({name}): loss {float(loss)}')
    e2e = {}
    for name, overlap in modes.items():
        check(launched[name] == 3 * steps * PR_E2E_ROUNDS,
              f'{tag} end to end ({name}): kernel 1 launched '
              f'{launched[name]} times in {PR_E2E_ROUNDS} loops of {steps} '
              'steps')
        wall = float(np.median(walls[name]))
        # the card's time in the loop from a profiled loop; the idle share
        # is taken against the unprofiled wall (the profiler slows the host)
        prof_rows, wall_p, _ = whole_window(
            torch, lambda: end_to_end(torch, scan_fn, X, Y, loader, overlap),
            1, {SEG_MAIN: 3 * steps})
        kern_ms, copy_ms = kernels_and_copies(prof_rows)
        e2e[name] = {'steps': steps, 'loops': PR_E2E_ROUNDS,
                     'ms_per_step': wall * 1e3 / steps,
                     'ms_per_step_each_loop': [w * 1e3 / steps
                                               for w in walls[name]],
                     'final_loss': float(loss),
                     'kernel1_launches': launched[name],
                     'profiled_ms_per_step': wall_p / steps,
                     'device_kernel_ms_per_step': kern_ms / steps,
                     'device_copy_ms_per_step': copy_ms / steps,
                     'device_idle_share': 1 - kern_ms / (wall * 1e3)}
        log(f'[{tag}] end to end, {name.replace("_", " ")}: {steps} steps '
            '(host sampling, stacking and upload included), median of '
            f'{PR_E2E_ROUNDS} loops {wall * 1e3 / steps:.4f} ms per step ('
            + ', '.join(f'{w * 1e3 / steps:.4f}' for w in walls[name])
            + f'); kernel 1 launched {launched[name]} times; under the '
            f'profiler {wall_p / steps:.4f} ms per step, the card runs '
            f'kernels {kern_ms / steps:.4f} ms and copies '
            f'{copy_ms / steps:.4f} ms a step, idle share '
            f"{e2e[name]['device_idle_share']:.4f} of the unprofiled wall")

    # where the loop's host time goes: the same loop, no overlap, with 1, 2
    # and 8 sampling threads, PR_E2E_ROUNDS loops each in turns, the median
    threads = {w: [] for w in (1, 2, 8)}
    for _ in range(PR_E2E_ROUNDS):
        for workers, got in threads.items():
            loader.num_workers = workers
            t0 = time.perf_counter()
            steps, _ = end_to_end(torch, scan_fn, X, Y, loader, False)
            torch.cuda.synchronize()
            got.append((time.perf_counter() - t0) * 1e3 / steps)
    loader.num_workers = PR_WORKERS
    sweep = {w: float(np.median(got)) for w, got in threads.items()}
    sweep[PR_WORKERS] = e2e['no_overlap']['ms_per_step']
    log(f'[{tag}] end to end, no overlap, ms per step by sampling threads: '
        + ', '.join(f'{w}: {sweep[w]:.4f}' for w in sorted(sweep)))

    # the gather route on the same batches, from the same weights
    _, _, g_step, g_scan = new_pair(gather_cross_entropy)
    reset_counts()
    for i in range(CAPTURE_WARMUP + 1):
        g_step(X, Y, rows[i])
        g_scan(X, Y, stacked)
    gather = route_timings(torch, f'{tag} gather route', g_step, g_scan, X,
                           Y, rows, stacked, None)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(not any(counts.values()) and not g_step.launches_per_replay
          and not g_scan.launches_per_replay,
          f'{tag} gather route: port kernels launched: {counts}')
    main_counts = {k: 0 for k in launch_counts()}
    main_counts['segment_spmm'] = sum(v['kernel1_launches']
                                      for v in e2e.values())
    res = {'nodes': N_PRODUCTS, 'edges': E_PRODUCTS, 'features': PR_F,
           'classes': PR_CLASSES, 'x_gb': X.numel() * 4 / 1e9,
           'batch': PR_BATCH, 'fanouts': list(PR_FANOUTS),
           'num_workers': PR_WORKERS, 'n_cap': n_cap,
           'edge_slots': int(batches[0].edge_index.shape[1]), 'k': PR_K,
           'edge_index_dtype': str(stacked['edge_index'].dtype),
           'loader_build_s': build_s, 'first_k_sample_s': sample_s,
           'fill': fill, 'parity': parity, 'kernel_route': kernel,
           'gather_route': gather, 'end_to_end': e2e,
           'end_to_end_ms_per_step_by_workers': sweep,
           'launches_per_step': per_step, 'launch_counts': main_counts,
           'launches_per_scan_replay': scan_fn.launches_per_replay}
    del g_step, g_scan, step_fn, scan_fn, loader
    return res, model, data, rows[0]


def record_conv_calls(model, calls):
    """Hooks on ``model``'s convs keeping, per conv, the inputs and output of
    its first ``calls`` calls (moved to the host); returns the records and
    the hooks' handles."""
    records = {i: [] for i in range(len(model.convs))}

    def hook(i):
        def keep(mod, args, out):
            if len(records[i]) < calls:
                x, ei = args[:2]
                records[i].append((x.cpu(), ei.coo.cpu(), ei.sparse_size,
                                   out.cpu()))
        return keep

    handles = [c.register_forward_hook(hook(i))
               for i, c in enumerate(model.convs)]
    return records, handles


def phase_layerwise(torch, seed, model, data, row):
    """Serving the trained model layer by layer
    (``basic_gnn_inference``) over all 2,449,029 nodes: 64 neighbours a
    layer (the JAX package's default), batch 4096, ``x_all`` kept on the
    card; each batch's ``EdgeIndex`` built there, kernel 1 once a batch and
    layer. Seconds a pass and the card's kernel time in it, from the
    profiler over ``LW_PROF_BATCHES`` batches of each layer of the same
    pass, scaled to the pass (the rest of the wall is the host's:
    sampling, the batches' upload, launches). The
    first ``LW_CPU_BATCHES`` batches of each layer (their recorded inputs
    and output) held against the port on the CPU, within 1e-4 * max(1,
    max|ref|). Then the products graph at 0.01
    scale with ``num_neighbors_per_layer`` its largest in-degree: the
    layer-wise output held against the full-graph forward over a cached
    ``EdgeIndex`` on the card (the JAX package's ``test_wave5.py:40-59``),
    within the same limit. Last, kernel 1 at the sampled shapes
    (``sampled_kernel_rows``)."""
    import copy
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.nn.models import basic_gnn_inference
    tag = 'layerwise'
    model.eval()
    n_batches = -(-N_PRODUCTS // LW_BATCH)
    records, handles = record_conv_calls(model, LW_CPU_BATCHES)

    def serve():
        return basic_gnn_inference(model, data, batch_size=LW_BATCH,
                                   num_neighbors_per_layer=LW_NEIGHBORS)

    # one pass, timed; the profiler runs over batches 2 to
    # LW_PROF_BATCHES + 1 of each layer (started and stopped at conv calls)
    from torch.profiler import ProfilerActivity, profile
    windows, conv_calls = [], [0]

    def window(_mod, _inp, _out):
        j = conv_calls[0] % n_batches
        conv_calls[0] += 1
        if j == 0:
            windows.append(profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]))
            windows[-1].start()
        elif j == LW_PROF_BATCHES:
            torch.cuda.synchronize()
            windows[-1].stop()

    handles += [conv.register_forward_hook(window) for conv in model.convs]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for h in handles:
        h.remove()
    check_counts(tag, counts, {'segment_spmm': 2 * n_batches},
                 f'a pass of {n_batches} batches over 2 layers')
    check(tuple(out.shape) == (N_PRODUCTS, PR_CLASSES)
          and bool(torch.isfinite(out).all()),
          f'{tag}: output {tuple(out.shape)}, finite '
          f'{bool(torch.isfinite(out).all())}')
    # the card's kernel and copy time a pass, scaled up from the windows;
    # the idle share is taken against the timed wall
    kern_s = copy_s = 0.0
    for i, prof in enumerate(windows):
        rows = trace_rows(prof, LW_PROF_BATCHES)
        check(rows is not None, f'{tag}: layer {i + 1}\'s window holds no '
                                'device time')
        # launches the profiler lost count at their recorded mean time
        # (whole_window's rule)
        rows = [(name, t / n * math.ceil(n - 1e-9), math.ceil(n - 1e-9))
                for name, t, n in rows]
        check(launches_of(rows, SEG_MAIN) == 1,
              f'{tag}: layer {i + 1}\'s profiled batches show '
              f'{launches_of(rows, SEG_MAIN)} kernel 1 launches a batch, '
              'expected 1')
        k, c = kernels_and_copies(rows)
        kern_s += k * n_batches / 1e3
        copy_s += c * n_batches / 1e3
    cpu = copy.deepcopy(model).cpu()
    worst_cpu = 0.0
    with torch.inference_mode():
        for i, recs in records.items():
            for b, (x, coo, size, got) in enumerate(recs):
                ei = EdgeIndex(coo, size, device='cpu').fill_cache(
                    blocked=False)
                ref = cpu.convs[i](x, ei)
                d = float((got - ref).abs().max())
                lim = 1e-4 * max(1.0, float(ref.abs().max()))
                worst_cpu = max(worst_cpu, d / lim)
                check(d <= lim, f'{tag}: layer {i + 1} batch {b}: {d} from '
                                f'the CPU (limit {lim})')
    log(f'[{tag}] basic_gnn_inference over {N_PRODUCTS} nodes, batch '
        f'{LW_BATCH}, {LW_NEIGHBORS} neighbours a layer ({n_batches} batches '
        f'a layer): {wall:.3f} s a pass, the card runs kernels {kern_s:.3f} '
        f's and copies {copy_s:.3f} s of it (torch.profiler over '
        f'{LW_PROF_BATCHES} batches of each layer, scaled to the pass), '
        f'idle share {1 - kern_s / wall:.4f}; kernel 1 launched '
        f"{counts['segment_spmm']} times (2 a batch); the first "
        f'{LW_CPU_BATCHES} batches of each layer within '
        f'{worst_cpu:.3e} of their limit from the CPU')
    # the full-neighbourhood check at 0.01 scale
    n_s = int(N_PRODUCTS * LW_CHECK_SCALE)
    e_s = int(E_PRODUCTS * LW_CHECK_SCALE)
    coo_s = products_graph(n_s, e_s, seed)
    max_deg = int(np.bincount(coo_s[1], minlength=n_s).max())
    gen = torch.Generator(device='cuda').manual_seed(seed + 7)
    x_s = torch.randn((n_s, PR_F), generator=gen, device='cuda')
    t0 = time.perf_counter()
    lw = basic_gnn_inference(model, Data(x=x_s, edge_index=coo_s,
                                         num_nodes=n_s),
                             batch_size=LW_CHECK_BATCH,
                             num_neighbors_per_layer=max_deg)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    with torch.inference_mode():
        full = model(x_s, EdgeIndex(coo_s, (n_s, n_s),
                                    device='cuda').fill_cache(blocked=False))
    d_full = float((lw - full).abs().max())
    lim = 1e-4 * max(1.0, float(full.abs().max()))
    check(d_full <= lim, f'{tag}: layer-wise output {d_full} from the full '
                         f'forward at {LW_CHECK_SCALE} scale (limit {lim})')
    log(f'[{tag}] products graph at {LW_CHECK_SCALE} scale ({n_s} nodes, '
        f'{e_s} edges), {max_deg} neighbours a layer (its largest '
        f'in-degree), batch {LW_CHECK_BATCH}: layer-wise output '
        f'{d_full:.3e} from the full-graph forward (limit {lim:.3e}), in '
        f'{check_s:.2f} s')
    x1, coo, size, _ = records[0][0]
    served = (x1, coo, size, records[1][0][0])
    kernel_rows, worst = sampled_kernel_rows(torch, seed, row, data.x,
                                             served)
    return {'nodes': N_PRODUCTS, 'batch': LW_BATCH,
            'neighbors': LW_NEIGHBORS, 'batches_per_layer': n_batches,
            'n_cap': int(size[0]), 'edge_slots': int(coo.shape[1]),
            'seconds_per_pass': wall,
            'profiled_batches_per_layer': LW_PROF_BATCHES,
            'device_kernel_s': kern_s,
            'device_copy_s': copy_s, 'device_idle_share': 1 - kern_s / wall,
            'launch_counts': counts,
            'cpu_check': {'batches_per_layer': LW_CPU_BATCHES,
                          'worst_over_limit': worst_cpu},
            'full_check': {'scale': LW_CHECK_SCALE, 'nodes': n_s,
                           'edges': e_s, 'neighbors': max_deg,
                           'batch': LW_CHECK_BATCH,
                           'max_abs_diff': d_full, 'limit': lim,
                           'seconds': check_s}}, kernel_rows, worst


# -- the flash kernels and paths K, L, M --------------------------------------
def plain_flash(torch):
    """A context in which the flash routes run their plain versions on the
    card: ``ops/flash_softmax.py``'s wrappers swapped for the chunked plain
    scans (the routes look them up at call time). For holding a path
    against the plain versions on the same card tensors; nothing counts."""
    import contextlib
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs

    @contextlib.contextmanager
    def ctx():
        saved = fs.flash_forward, fs.flash_backward
        fs.flash_forward = (lambda ops, s, d, rel, n, chunk, plan=None:
                            fs.flash_forward_plain(ops, s, d, rel, n, chunk))
        fs.flash_backward = (lambda ops, s, d, rel, n, chunk, m, l, out, g,
                             plan=None, plan_t=None: fs.flash_backward_plain(
                                 ops, s, d, rel, n, chunk, m, l, out, g))
        try:
            yield
        finally:
            fs.flash_forward, fs.flash_backward = saved

    return ctx()


def scaled_cap(scale):
    """A context in which ``PGT_ATTN_WIDE_BYTES`` is its value times
    ``scale``: a graph cut to ``scale`` of its edges then takes, at every
    layer, the branch its full size takes (the branch rule compares the
    edges' bytes with the cap)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get('PGT_ATTN_WIDE_BYTES')
        os.environ['PGT_ATTN_WIDE_BYTES'] = repr(float(old or 1e9) * scale)
        try:
            yield
        finally:
            if old is None:
                del os.environ['PGT_ATTN_WIDE_BYTES']
            else:
                os.environ['PGT_ATTN_WIDE_BYTES'] = old

    return ctx()


def small_parity(torch, tag, build, state, seed, scale=PD_SMALL,
                 cancelled=()):
    """``PARITY_STEPS`` steps of ``build``'s model from ``state`` on path
    C's generator at ``scale`` (``small_path_c``) with its slot orders, on
    the card and on the CPU, the cap scaled with it: ``check_parity``'s
    losses and first-step gradients at 1e-4 of their own largest."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    coo, x, y = small_path_c(seed, scale)
    n = len(x)
    runs = []
    t0 = time.perf_counter()
    with scaled_cap(scale):
        for dev in ('cuda', 'cpu'):
            ei = EdgeIndex(coo, (n, n), device=dev).fill_cache(blocked=True)
            runs.append(gat_parity_run(
                torch, state, torch.as_tensor(x, device=dev), ei,
                torch.as_tensor(y, device=dev), dev, build))
    log(f'[{tag}] {PARITY_STEPS} steps on the card and the CPU plain path at '
        f'{scale} scale ({n} nodes, {coo.shape[1]} edges) in '
        f'{time.perf_counter() - t0:.1f} s')
    return check_parity(torch, f'{tag} at {scale} scale', *runs, True,
                        cancelled=cancelled)


def small_path_c(seed, scale):
    """Path C's generator at ``scale`` of its nodes and edges (random COO,
    one self loop per node by ``add_remaining_self_loops``, x and labels
    from the same generator)."""
    import torch
    from pytorch_geometric_tpu_torch.utils import add_remaining_self_loops
    rng = np.random.default_rng(seed)
    n, e = int(PC_NODES * scale), int(PC_EDGES * scale)
    coo = rng.integers(0, n, (2, e)).astype(np.int32)
    coo = add_remaining_self_loops(torch.from_numpy(coo), num_nodes=n)[0]
    x = rng.standard_normal((n, PC_F)).astype(np.float32)
    y = rng.integers(0, PC_CLASSES, n)
    return coo.numpy(), x, y


def flash_case(torch, form, h, c, seed, n_src=20_000, n_dst=12_000,
               e=250_000):
    """A bipartite flash case on the card: a third of the destinations
    empty, one destination holding 55 % of the edges, 64 padded edges
    (destination ``n_dst``) and 64 invalid ones (``n_dst + 5``); 2 relations
    for the dot form. Returns ``(ops, s, d, rel, n_dst)``."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, 2 * n_dst // 3, replace=False)
    d = rows[rng.integers(0, len(rows), e)]
    d[: 55 * e // 100] = rows[0]
    d[-128:-64], d[-64:] = n_dst, n_dst + 5
    d = d[rng.permutation(e)]
    s = rng.integers(0, n_src, e)
    g = torch.Generator(device='cuda').manual_seed(seed)
    sw = h if form == 'gat' else h * c
    src_tab = torch.randn(n_src, sw, device='cuda', generator=g)
    dst_tab = torch.randn(n_dst, sw, device='cuda', generator=g)
    val = (src_tab if form == 'gatv2' else
           torch.randn(n_src, h * c, device='cuda', generator=g))
    extra = rel = None
    if form == 'gatv2':
        extra = torch.randn(h * c, device='cuda', generator=g) / math.sqrt(c)
    if form == 'dot':
        extra = torch.rand(2, h, device='cuda', generator=g) / math.sqrt(c)
        rel = torch.as_tensor(rng.integers(0, 2, e), device='cuda')
    ops = fs.FlashOperands(form, h, src_tab, dst_tab, val, extra, 0.2)
    return (ops, torch.as_tensor(s, device='cuda'),
            torch.as_tensor(d, device='cuda'), rel, n_dst)


def flash_route(torch, ops, s, d, n_dst, gcot, layout):
    """The public flash route of ``ops``' form as a conv calls it, under
    autograd on leaf copies of ``ops``' tables: ``gat_flash_attention``,
    ``gatv2_flash_attention``, or ``hetero_edge_attention_multi`` of one
    relation past the cap (or over a ``FlashLayout`` with its source-sorted
    copy when ``layout``). So ``_FlashAttention`` builds its own plans and
    routes its gradients. Returns the output ``[n_dst, H C]`` and the
    tables' gradients for ``gcot`` in ``flash_backward``'s order (None
    where the form has no such table)."""
    from pytorch_geometric_tpu_torch.ops import edge_attention as ea
    h, c = ops.heads, ops.columns
    with torch.inference_mode(False), torch.enable_grad():
        def leaf(t):
            return t.detach().clone().requires_grad_()
        s, d, gcot = s.clone(), d.clone(), gcot.clone()
        src, dst = leaf(ops.src_tab), leaf(ops.dst_tab)
        if ops.form == 'gat':
            val = leaf(ops.val)
            out = ea.gat_flash_attention(src, dst, val.view(-1, h, c), s, d,
                                         n_dst, ops.slope)
            leaves = (src, dst, val, None)
        elif ops.form == 'gatv2':
            att = leaf(ops.extra)
            out = ea.gatv2_flash_attention(
                src.view(-1, h, c), dst.view(-1, h, c), att.view(h, c), s,
                d, n_dst, ops.slope)
            leaves = (src, dst, None, att)
        else:
            val, p = leaf(ops.val), leaf(ops.extra[0])
            lay = None
            if layout:
                lay = ea.build_union_flash_layout(
                    [s.cpu().numpy()], [d.cpu().numpy()], [src.shape[0]],
                    n_dst, device=s.device)
            with scaled_cap(0.0):
                out = ea.hetero_edge_attention_multi(
                    [src.view(-1, h, c)], [val.view(-1, h, c)],
                    dst.view(-1, h, c), [p], [s], [d], n_dst, layout=lay)
            leaves = (src, dst, val, p)
        out.backward(gcot.view(out.shape))
    return (out.detach().reshape(n_dst, -1),
            [None if t is None else t.grad for t in leaves])


def flash_close(torch, ops, s, d, rel, n_dst, sorted_dst=False, route=False,
                keep=None):
    """Kernels (a), (b), (c) against the plain versions on the same card
    tensors, the plain versions computed in float64 from the same float32
    inputs (a float32 plain version sums a hub row's 137,500 terms with
    atomics, in no fixed order, and rounds by about as much as the kernel
    may): the output within 1e-5 of max(1, its largest), m's infinities
    where the plain version has them, each gradient entry within 1e-4 of
    that gradient's largest plus 1e-5 of the sum of the entry's terms'
    magnitudes (``abs_terms``: every row's ``dlogit`` sums to zero, so the
    gradients summed over a row's edges, or GATv2's ``att`` over all edges,
    cancel, and their float32 terms round by more than the small sum they
    leave); both launches twice, bitwise equal. With ``route`` (one
    relation), ``flash_route``'s output and every input's gradient within
    the same limits, and for the dot form its layout route too. Returns
    ``(max abs err, max err over its limit)``; a ``keep`` dict receives the
    output gradient and the float64 gradients and term magnitudes
    (``gcot``, ``want``, ``terms``)."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    plan = fs.dst_plan(s, d, rel, n_dst, sorted_dst)
    plan_t = fs.src_plan(s, d, rel, n_dst, ops.src_tab.shape[0])
    chunk = 2_000_000
    out, m, l = fs.flash_forward(ops, s, d, rel, n_dst, chunk, plan)
    again = fs.flash_forward(ops, s, d, rel, n_dst, chunk, plan)
    torch.cuda.synchronize()
    src64 = ops.src_tab.double()
    ops64 = ops._replace(
        src_tab=src64, dst_tab=ops.dst_tab.double(),
        val=src64 if ops.form == 'gatv2' else ops.val.double(),
        extra=None if ops.extra is None else ops.extra.double())
    ref = fs.flash_forward_plain(ops64, s, d, rel, n_dst, chunk)
    check(all(torch.equal(a, b) for a, b in zip((out, m, l), again)),
          'flash forward: two launches differ')
    check(torch.equal(torch.isinf(m), torch.isinf(ref[1])),
          'flash forward: m is -inf on other rows than the plain version\'s')
    lim_out = 1e-5 * max(1.0, float(ref[0].abs().max()))
    err = float((out.double() - ref[0]).abs().max())
    check(err <= lim_out, f'flash forward: {err} from the plain version '
                          f'(limit {lim_out})')
    worst = (err, err / lim_out)
    rel_err = {'out': err / max(float(ref[0].abs().max()), 1e-300)}
    gcot = torch.randn(out.shape, device='cuda',
                       generator=torch.Generator('cuda').manual_seed(1))
    got = fs.flash_backward(ops, s, d, rel, n_dst, chunk, m, l, out, gcot,
                            plan, plan_t)
    twice = fs.flash_backward(ops, s, d, rel, n_dst, chunk, m, l, out, gcot,
                              plan, plan_t)
    torch.cuda.synchronize()
    want = fs.flash_backward_plain(ops64, s, d, rel, n_dst, chunk, ref[1],
                                   ref[2], ref[0], gcot.double())
    terms = fs.flash_backward_plain(ops64, s, d, rel, n_dst, chunk, ref[1],
                                    ref[2], ref[0], gcot.double(),
                                    abs_terms=True)
    if keep is not None:
        keep.update(gcot=gcot, want=want, terms=terms)
    for name, a, b, a2, t in zip(('d_src', 'd_dst', 'd_val', 'd_extra'), got,
                                 want, twice, terms):
        check((a is None) == (b is None), f'flash backward: {name} missing')
        if a is None:
            continue
        check(torch.equal(a, a2), f'flash backward: two launches differ in '
                                  f'{name}')
        a = a.double()
        lim = 1e-4 * max(float(b.abs().max()), 1e-30) + 1e-5 * t
        over = float(((a - b).abs() / lim).max())
        err = float((a - b).abs().max())
        rel_err[name] = err / max(float(b.abs().max()), 1e-300)
        check(over <= 1.0, f'flash backward: {name} {err} from the plain '
                           f'version ({over:.3f} of its limit)')
        worst = (max(worst[0], err), max(worst[1], over))
    for layout in ((False, True) if route and ops.form == 'dot' else
                   (False,) if route else ()):
        what = 'layout route' if layout else 'route'
        out_r, grads = flash_route(torch, ops, s, d, n_dst, gcot, layout)
        err = float((out_r.double() - ref[0]).abs().max())
        check(err <= lim_out, f'flash {what}: output {err} from the plain '
                              f'version (limit {lim_out})')
        worst = (max(worst[0], err), max(worst[1], err / lim_out))
        for name, a, b, t in zip(('d_src', 'd_dst', 'd_val', 'd_extra'),
                                 grads, want, terms):
            if b is None:
                continue
            check(a is not None, f'flash {what}: no gradient for {name}')
            a = a.double().reshape(b.shape)
            lim = 1e-4 * max(float(b.abs().max()), 1e-30) + 1e-5 * t
            over = float(((a - b).abs() / lim).max())
            err = float((a - b).abs().max())
            check(over <= 1.0, f'flash {what}: gradient {name} {err} from '
                               f'the plain version ({over:.3f} of its '
                               f'limit)')
            worst = (max(worst[0], err), max(worst[1], over))
        log(f'[kernel]   the {what} (plans, autograd): output and every '
            'input\'s gradient within the same limits')
    log('[kernel]   against the float64 plain version, each output\'s max '
        'abs err over its largest: ' + ', '.join(
            f'{k} {v:.2e}' for k, v in rel_err.items()))
    return worst


def phase_flash_vs_plain(torch, seed):
    """Each flash kernel against its plain version in each logit form, H in
    {1, 4, 8} and C in {1, 10, 16, 47, 64}, on ``flash_case``'s graph:
    empty rows, padded and invalid edges, a destination of 137,500 edges
    (269 pieces), 2 relations for the dot form; two launches bitwise
    equal. Returns the worst (abs err, err over limit)."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    worst = (0.0, 0.0)
    t0 = time.perf_counter()
    for form in fs.FORMS:
        for h in (1, 4, 8):
            for c in (1, 10, 16, 47, 64):
                case = flash_case(torch, form, h, c, seed + h + c)
                with torch.inference_mode():
                    err = flash_close(torch, *case)
                worst = (max(worst[0], err[0]), max(worst[1], err[1]))
                log(f'[kernel] flash {form} H={h} C={c}: (a), (b), (c) '
                    f'max abs err {err[0]:.3e}, {err[1]:.3f} of the limit, '
                    'two launches bitwise equal')
    log(f'[kernel] flash kernels, 45 cases in {time.perf_counter() - t0:.1f}'
        f' s: worst abs err {worst[0]:.3e}, {worst[1]:.3f} of its limit '
        '(forward 1e-5 of max(1, the largest output); a gradient entry 1e-4 '
        'of that gradient\'s largest plus 1e-5 of the sum of its terms\' '
        'magnitudes)')
    return worst


def gatv2_model(torch, device, seed):
    """Path L's model: path C's GAT with ``GATv2Conv`` layers and default
    self loops (64 -> 4 x 64, 256 -> 4 x 64, 256 -> 4 x 10 averaged)."""
    from pytorch_geometric_tpu_torch.nn.models import GAT
    return GAT(PC_F, PC_HIDDEN, PC_LAYERS, PC_CLASSES, heads=PC_HEADS,
               v2=True, device=device,
               generator=torch.Generator().manual_seed(seed))


def flash_serve_train(torch, tag, build, seed, x, ei, y, per_fwd, per_step,
                      iters, steps, lr, sync_state=False, cancelled=()):
    """A flash path served (``inference_mode``) and trained (softmax
    cross-entropy, Adam at ``lr``), each eager and through
    ``compat.compile``: ms per forward or step, the host's issue time,
    launches (``per_fwd`` / ``per_step`` per call, every other kernel arm
    none), whole-window profiles and idle shares, peak memory; the eager
    step run twice from the same weights (is it bitwise repeatable?), and
    ``sync_state`` for ``captured_training`` where it is not. The model
    serves in eval mode (a batch norm's running statistics; no path's
    model has dropout) and trains in training mode. Returns ``(res, state,
    eager forward output)``."""
    model = build(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    model.eval()
    fwd = lambda: model(x, ei)      # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        ms, enq, _, out = timed_calls(torch, fwd, iters, 1)
        rows, prof_ms, n_prof = profile_forwards(torch, fwd,
                                                 replay_expect(per_fwd))
    n_fwd = 1 + iters + n_prof
    counts = launch_counts()
    check_counts(tag, counts, {k: n * n_fwd for k, n in per_fwd.items()},
                 f'{n_fwd} forwards')
    check(bool(torch.isfinite(out).all()), f'{tag}: non-finite output')
    busy = sum(t for _, t, _ in rows)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    flash_ms = {k: sum(t for name, t, _ in rows if v in name)
                for k, v in FLASH_KERNELS.items()}
    res = {'ms_per_forward': ms, 'host_enqueue_ms_per_forward': enq,
           'forwards': n_fwd, 'launch_counts': counts,
           'launches_per_forward': {k: counts[k] / n_fwd for k in per_fwd},
           'device_busy_ms_per_forward': busy,
           'profiled_ms_per_forward': prof_ms,
           'device_idle_share': 1 - busy / prof_ms,
           'flash_ms_per_forward': flash_ms,
           'peak_memory_gb_serving': serve_peak,
           'kernels_per_forward': [[n[:80], t, c] for n, t, c in rows[:10]]}
    log(f'[{tag}] serving: {ms:.4f} ms per forward (CUDA events, {iters} '
        f'after 1), the host issues one in {enq:.4f} ms; device busy '
        f'{busy:.4f} of a {prof_ms:.4f} ms wall, idle share '
        f'{1 - busy / prof_ms:.4f}; flash kernels {flash_ms}; launches per '
        f'forward {res["launches_per_forward"]}; peak memory {serve_peak:.3f}'
        ' GB')
    for name, t, n in rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{n:g}  {name[:90]}')
    cap, cap_out = captured_serving(torch, f'{tag} captured', lambda x:
                                    model(x, ei), x, out, iters, 1, per_fwd)
    res['captured'] = cap
    del model
    model = from_state(torch, lambda: build(torch, None, seed), state)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step():
        return train_step(torch, model, opt, x, ei, y)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sms, _, senq, last = timed_steps(torch, step, 1, steps)
    prof, prof_steps = profile_steps(torch, step, tag,
                                     replay_expect(per_step))
    n_steps = 1 + steps + prof_steps
    counts = launch_counts()
    check_counts(tag, counts, {k: n * n_steps for k, n in per_step.items()},
                 f'{n_steps} steps')
    peak = torch.cuda.max_memory_allocated() / 1e9
    train = {'ms_per_step': sms, 'host_enqueue_ms_per_step': senq,
             'steps': n_steps, 'launch_counts': counts,
             'launches_per_step': {k: counts[k] / n_steps for k in per_step},
             'peak_memory_gb': peak, 'loss_after': last}
    train.update(prof)
    log(f'[{tag}] training: {sms:.4f} ms per step (CUDA events, {steps} '
        f'after 1), the host issues one in {senq:.4f} ms; loss {last:.6f}; '
        f'launches per step {train["launches_per_step"]}; peak memory '
        f'{peak:.3f} GB')
    del model, opt
    # the eager step's own repeatability on this card: two runs from the
    # same weights, first-step gradients per tensor
    runs = [gat_parity_run(torch, state, x, ei, y, 'cuda', build, lr)
            for _ in range(2)]
    gaps = {k: float((runs[0][1][k] - g).abs().max())
            / max(float(g.abs().max()), 1e-30)
            for k, g in runs[1][1].items()}
    far = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    train['eager_repeat_grad_gaps'] = dict(far)
    train['eager_repeat_bitwise'] = all(v == 0 for v in gaps.values())
    log(f'[{tag}] the eager step run twice from the same weights: '
        f'first-step gradients bitwise equal: '
        f'{train["eager_repeat_bitwise"]}; largest gaps ' + ', '.join(
            f'{k} {v:.3e}' for k, v in far))
    train['captured'] = captured_training(
        torch, f'{tag} training captured', lambda: from_state(
            torch, lambda: build(torch, None, seed), state), x, ei, y, None,
        per_step, steps, 1e-4, lr=lr, sync_state=sync_state,
        cancelled=cancelled)
    res['training'] = train
    return res, state, out


def flash_parity(torch, tag, build, state, x, ei, y, lr, against,
                 cancelled=()):
    """The path's forward output and ``PARITY_STEPS`` training steps (losses,
    first-step gradients) from ``state`` on the card, against the plain
    versions on the same card tensors (``against='plain'``) or against the
    CPU plain path (``against`` a tuple of CPU ``(x, ei, y)``): the output
    within 1e-4 of max(1, its largest), losses within 1e-4 relative, each
    first-step gradient within 1e-4 of the largest gradient of all and
    within ``FLASH_OWN_TOL`` of its own largest (``check_parity``'s
    ``own_tol``; ``cancelled`` as there).

    Why not 1e-4 of its own largest: the model is not smooth (ReLU between
    layers, leaky_relu in GAT's and GATv2's logits). Two computations that
    round differently put a few pre-activations on opposite sides of a
    kink, and each such node moves a weight gradient summed over all nodes
    by a whole term: about 1e-3 of that gradient's own largest where it is
    small, in most weights of the layers below a ReLU (path M at 0.05
    scale: the kernels and the plain versions on the card within 6.5e-7 of
    each other, both 1.3e-3 from the CPU in layer 1's ``lin_value``, while
    outputs and losses agreed to 1e-7). The kernels, and the flash route's
    plans and gradient wiring on the card, are held per entry and per input
    at the paths' shapes in ``flash_close``."""
    model = from_state(torch, lambda: build(torch, None, 0), state)
    with torch.inference_mode():
        out = model(x, ei)
        if against == 'plain':
            with plain_flash(torch):
                ref = model(x, ei)
        else:
            cpu = build(torch, 'cpu', 0)
            cpu.load_state_dict(state)
            ref = cpu(against[0], against[1])
    diff = float((out.cpu() - ref.cpu()).abs().max())
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    what = ('plain versions on the card' if against == 'plain'
            else 'CPU plain path')
    log(f'[{tag}] forward output vs the {what}: max abs diff {diff:.3e} '
        f'(limit {lim:.3e})')
    check(diff <= lim, f'{tag}: forward {diff} from its reference')
    del model
    card = gat_parity_run(torch, state, x, ei, y, 'cuda', build, lr)
    t0 = time.perf_counter()
    if against == 'plain':
        with plain_flash(torch):
            ref = gat_parity_run(torch, state, x, ei, y, 'cuda', build, lr)
    else:
        ref = gat_parity_run(torch, state, *against, 'cpu', build, lr)
    log(f'[{tag}] reference steps in {time.perf_counter() - t0:.1f} s')
    res = check_parity(torch, tag, card, ref, True, cancelled=cancelled,
                       own_tol=FLASH_OWN_TOL)
    res['max_abs_diff_forward'] = diff
    return res


def flash_arms():
    """A context that records, for every flash launch through the wrappers,
    the arm its team shape took, keyed by ``(kernel, heads, columns)``:
    ``ops/flash_softmax.py::kernel_shape``'s ``vec`` (4: the 16-byte arm,
    1: floats). Yields the record."""
    import contextlib
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs

    @contextlib.contextmanager
    def ctx():
        seen, orig = {}, fs.kernel_shape

        def spy(ops, kernel, *rows):
            shape = orig(ops, kernel, *rows)
            seen[(kernel, ops.heads, ops.columns)] = shape.vec
            return shape

        fs.kernel_shape = spy
        try:
            yield seen
        finally:
            fs.kernel_shape = orig

    return ctx()


def phase_path_k(torch, seed, coo, iters):
    """Path K, ``products_bench.py --gat`` at full size: the products graph
    (``products_graph``, 2,449,029 nodes, 123,718,280 edges; each layer
    adds a self loop per node), X [N, 100] and Y from ``seed`` on the card,
    ``products_gat`` (both layers past the cap, on the flash kernels), Adam
    1e-3. Served and trained eager and captured (``flash_serve_train``);
    held against the plain versions on the card (forward, 3 losses, first
    step's gradients); then the same at ``products_graph``'s 0.01 scale
    against the CPU plain path, the cap scaled with it (``scaled_cap``)."""
    tag = 'path K'
    ei = torch.as_tensor(coo, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((N_PRODUCTS, PR_F), generator=gen, device='cuda')
    y = torch.randint(0, PR_CLASSES, (N_PRODUCTS,), generator=gen,
                      device='cuda')
    with flash_arms() as arms:
        res, state, _ = flash_serve_train(
            torch, tag, products_gat, seed, x, ei, y, FLASH_PER_FORWARD,
            FLASH_PER_STEP, iters, PK_STEPS, PR_LR)
    # layer 2's 47 columns a head reach the kernels padded to 48, on the
    # 16-byte arm, as layer 1's 16 do
    res['flash_arms'] = {f'{k} H={h} C={c}': ('16-byte' if v == 4 else
                                               'float')
                         for (k, h, c), v in sorted(arms.items())}
    log(f"[{tag}] the flash launches' arms: {res['flash_arms']}")
    check(set(arms) == {(k, h, c) for k in ('fwd', 'dst', 'src')
                        for h, c in ((4, 16), (1, 48))}
          and all(v == 4 for v in arms.values()),
          f'{tag}: a flash launch took the float arm or another shape: '
          f'{res["flash_arms"]}')
    res['parity_vs_plain_on_card'] = flash_parity(
        torch, tag, products_gat, state, x, ei, y, PR_LR, 'plain')
    res.update(nodes=N_PRODUCTS, edges=E_PRODUCTS + N_PRODUCTS,
               edges_per_s_training=2 * (E_PRODUCTS + N_PRODUCTS)
               / (res['training']['captured']['ms_per_step'] / 1e3))
    del x, y, ei
    torch.cuda.empty_cache()
    n, e = int(N_PRODUCTS * PK_SMALL), int(E_PRODUCTS * PK_SMALL)
    small = products_graph(n, e, seed)
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, PR_F)).astype(np.float32)
    ys = rng.integers(0, PR_CLASSES, n)
    model = products_gat(torch, None, seed)
    sstate = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    del model
    with scaled_cap(PK_SMALL):
        res['parity_small_vs_cpu'] = flash_parity(
            torch, f'{tag} at {PK_SMALL} scale ({n} nodes, {e} edges)',
            products_gat, sstate, torch.as_tensor(xs, device='cuda'),
            torch.as_tensor(small, device='cuda'),
            torch.as_tensor(ys, device='cuda'), PR_LR,
            (torch.from_numpy(xs), torch.from_numpy(small),
             torch.from_numpy(ys)))
    log(json.dumps({'metric': 'products_fullgraph_gat_train_step',
                    'ms': res['training']['ms_per_step'],
                    'ms_captured': res['training']['captured'][
                        'ms_per_step'], 'nodes': N_PRODUCTS,
                    'edges': E_PRODUCTS, 'path': 'flash kernels'}))
    return res


def phase_path_lm(torch, seed, pc, iters):
    """Path L (GATv2, ``gatv2_model``) and path M (path I's TransformerConv
    stack, ``transformer_model``) on path C's graph as a plain COO (no slot
    orders), Adam 1e-2 on path D's labels: layers 1-2 take the flash route
    (L: 2.2M x 256 x 4 B of messages past the cap; M: the wide union's 2.1M
    x 4 x 2 x 64 x 4 B), layer 3 the plain branch (L) or the wide op on the
    dot kernel (M). Served and trained as path K, and checked as path K is:
    against the plain versions on the card at full size, and against the
    CPU plain path on path C's generator at ``PL_SMALL`` of its size, the
    cap scaled with it (forward, 3 losses, first step's gradients).

    Cancelled gradients, held to 1e-4 of the largest gradient of all (as
    path J's key biases): TransformerConv's key bias, which the softmax
    cancels exactly; and, in the captured step's check against the eager
    one only, GATv2's ``lin_r``, which reaches the loss only through
    ``x_r``, whose gradient sums each row's ``dlogit`` (which sums to zero)
    times a leaky slope, so it is mostly rounding on both sides."""
    ei = torch.as_tensor(pc['coo'], device='cuda')
    x = torch.as_tensor(pc['x'], device='cuda')
    y = torch.as_tensor(pc['y'], device='cuda')
    coo_s, x_s, y_s = small_path_c(seed, PL_SMALL)
    small = (torch.as_tensor(x_s, device='cuda'),
             torch.as_tensor(coo_s, device='cuda'),
             torch.as_tensor(y_s, device='cuda'))
    cpu = (torch.from_numpy(x_s), torch.from_numpy(coo_s),
           torch.from_numpy(y_s))
    out = {}
    for tag, build, per_fwd, per_step, cancelled, parity_cancelled in (
            ('path L', gatv2_model, FLASH_PER_FORWARD, FLASH_PER_STEP,
             ('lin_r.weight', 'lin_r.bias'), ()),
            ('path M', transformer_model,
             dict(FLASH_PER_FORWARD, edge_dot=1),
             dict(FLASH_PER_STEP, edge_dot=2), ('lin_key.bias',),
             ('lin_key.bias',))):
        # layer 3 (the plain branch, the wide op) adds with atomics, so the
        # eager step is not bitwise repeatable
        res, state, _ = flash_serve_train(
            torch, tag, build, seed, x, ei, y, per_fwd, per_step, iters,
            PA_STEPS, TR_LR, sync_state=True, cancelled=cancelled)
        res['parity_vs_plain_on_card'] = flash_parity(
            torch, tag, build, state, x, ei, y, TR_LR, 'plain',
            parity_cancelled)
        t0 = time.perf_counter()
        small_state = {k: v.detach().cpu().clone() for k, v in build(
            torch, None, seed).state_dict().items()}
        with scaled_cap(PL_SMALL):
            res['parity_small_vs_cpu'] = flash_parity(
                torch, f'{tag} at {PL_SMALL} scale ({len(x_s)} nodes, '
                f'{coo_s.shape[1]} edges)', build, small_state, *small,
                TR_LR, cpu, parity_cancelled)
        log(f'[{tag}] CPU checks in {time.perf_counter() - t0:.1f} s')
        res['edges'] = int(pc['coo'].shape[1])
        out[tag] = res
        torch.cuda.empty_cache()
    return out


def flash_bytes(ops, plan, plan_t, n_dst, n_edges, kernel):
    """Bytes one flash launch must move: its node tables read once, the
    residuals it reads, the CSR it walks (int32 neighbours and relations,
    int64 row and piece offsets) and its outputs written once."""
    h, c = ops.heads, ops.columns
    ns = ops.src_tab.shape[0]
    tables = (ops.src_tab.numel() + ops.dst_tab.numel()
              + (0 if ops.form == 'gatv2' else ops.val.numel())
              + (0 if ops.extra is None else ops.extra.numel())) * 4
    csr = n_edges * 4 * (2 if ops.form == 'dot' else 1)
    if kernel == 'flash_fwd':
        return tables + csr + 16 * (n_dst + 1) + n_dst * (h * c + 2 * h) * 4
    if kernel == 'flash_bwd_dst':
        return (tables + csr + 16 * (n_dst + 1)
                + n_dst * (2 * h + 2 * h * c) * 4
                + n_dst * (h + ops.dst_tab.shape[1]) * 4)
    return (tables + csr + 16 * (ns + 1) + n_dst * (3 * h + h * c) * 4
            + ns * ops.src_tab.shape[1] * 4
            + (0 if ops.form == 'gatv2' else ns * h * c * 4))


def flash_gathered(ops, n_edges, kernel):
    """Bytes a launch gathers per edge list: per edge and head, the value
    row and the logit operand (kernels a, b), or the output gradient row,
    the destination's row (GATv2, dot) and its record (m, l, gdot, a_dst;
    kernel c)."""
    h, c = ops.heads, ops.columns
    operand = h if ops.form == 'gat' else h * c
    if kernel == 'flash_bwd_src':
        return n_edges * 4 * (h * c + 4 * h
                              + (0 if ops.form == 'gat' else h * c))
    return n_edges * 4 * (h * c + (0 if ops.form == 'gatv2' else operand))


def flash_kernel_rows(torch, label, base, s, d, rel, nd, route=True):
    """Kernels (a), (b) and (c) at one shape: held against the plain
    versions (``flash_close``: the kernels on the tables as given, and with
    ``route`` the public route, which pads), then device time per launch
    (``whole_window``), CUDA-event wall, the plain version's time (its
    backward covers both passes), the bound (the unpadded tables' bytes
    once at 3.35 TB/s), the rate of gathered rows and each launch's team
    shape (``kernel_shape``: the 16-byte arm is ``vec`` 4). ``base``'s
    values are padded to whole 16-byte heads as the flash route pads them.
    Returns (rows, (max abs err, max err over its limit))."""
    from pytorch_geometric_tpu_torch.ops import edge_attention as ea
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    form, h, c = base.form, base.heads, base.columns
    ns = base.src_tab.shape[0]
    e = int(s.shape[0])
    rows = []
    with torch.inference_mode():
        log(f'[kernel] flash {label} ({form} H={h} C={c}, {e} edges) '
            'against the plain version:')
        keep = {}
        worst = flash_close(torch, base, s.long(), d.long(), rel, nd,
                            route=route, keep=keep)
        # the tables as the flash route hands them to the kernels
        cp = -(-c // ea.ALIGN_COLUMNS) * ea.ALIGN_COLUMNS
        ops = base
        if cp != c:
            ops = base._replace(val=ea._pad_heads(base.val, h, c, cp))
        order = torch.argsort(d.long(), stable=True)
        sd, dd = s.long()[order], d.long()[order]
        rd = None if rel is None else rel[order]
        del order
        plan = fs.dst_plan(sd, dd, rd, nd, True)
        plan_t = fs.src_plan(sd, dd, rd, nd, ns)
        out, m, l = fs.flash_forward(ops, sd, dd, rd, nd, 0, plan)
        gcot = ea._pad_heads(keep['gcot'], h, c, cp)
        rec = fs.flash_backward_dst(ops, m, l, out, gcot, plan)[0]
        calls = {
            'flash_fwd': lambda: fs.flash_forward(ops, sd, dd, rd, nd, 0,
                                                  plan),
            'flash_bwd_dst': lambda: fs.flash_backward_dst(
                ops, m, l, out, gcot, plan),
            'flash_bwd_src': lambda: fs.flash_backward_src(
                ops, gcot, rec, plan_t)}
        teams = {'flash_fwd': fs.kernel_shape(ops, 'fwd', out),
                 'flash_bwd_dst': fs.kernel_shape(ops, 'dst', gcot, out),
                 'flash_bwd_src': fs.kernel_shape(ops, 'src', gcot)}
        plain = {
            'flash_fwd': lambda: fs.flash_forward_plain(
                ops, sd, dd, rd, nd, 2_000_000),
            'flash_bwd': lambda: fs.flash_backward_plain(
                ops, sd, dd, rd, nd, 2_000_000, m, l, out, gcot)}
        plain_ms = {k: device_ms(torch, f, calls=1)
                    for k, f in plain.items()}
        for kernel, fn in calls.items():
            by = flash_bytes(base, plan, plan_t, nd, e, kernel)
            gathered = flash_gathered(base, e, kernel)
            krows, _, _ = whole_window(torch, fn, 5)
            ms = sum(t for name, t, _ in krows
                     if FLASH_KERNELS[kernel] in name)
            event_ms = timed_calls(torch, fn, 5, 1)[0]
            row = {'shape': label, 'kernel': kernel, 'form': form, 'H': h,
                   'C': c, 'C_padded': cp, 'edges': e, 'n_src': ns,
                   'n_dst': nd, 'split_edges': plan.split,
                   'team': teams[kernel]._asdict(),
                   'arm': ('16-byte' if teams[kernel].vec == 4
                           else 'float'),
                   'bytes': by,
                   'gathered_bytes': gathered, 'ms': ms,
                   'event_ms': event_ms,
                   'plain_ms': plain_ms['flash_fwd' if kernel ==
                                        'flash_fwd' else 'flash_bwd'],
                   'plain_covers': ('the forward' if kernel == 'flash_fwd'
                                    else 'the whole backward (both '
                                         'passes)'),
                   'bound_ms': by / HBM_BYTES_PER_S * 1e3,
                   'bound_by': 'bytes', 'library_ms': None,
                   'library_note': 'no one PyTorch call computes a '
                                   'segment softmax-aggregation',
                   'gathered_tb_per_s': gathered / (ms / 1e3) / 1e12}
            row['share'] = row['bound_ms'] / ms
            rows.append(row)
            before = FLASH_RECORDED_BEFORE_MS.get((label, kernel))
            log(f"[timing] {kernel} {label} ({form} H={h} C={c}"
                f"{f' padded to {cp}' if cp != c else ''}, {e} edges): "
                f"device {ms:.4f} ms per launch [CUDA-event wall "
                f"{event_ms:.4f} ms]"
                + (f" (recorded before kernel (a)'s redesign, not measured "
                   f"here: {before:.4f})" if before is not None else '')
                + f", plain {row['plain_ms']:.4f} ms ({row['plain_covers']}),"
                f" bound {row['bound_ms']:.4f} ms (bytes), "
                f"{100 * row['share']:.1f} % of it; gathered rows "
                f"{row['gathered_tb_per_s']:.3f} TB/s; {row['arm']} arm, "
                f"team {tuple(teams[kernel])} (vec, lanes, heads, slots, "
                f"nv, unroll, depth); library: none")
    return rows, worst


def phase_flash_timings(torch, seed, coo, pc):
    """Kernels (a), (b) and (c) at path K's two layers (products graph with
    self loops: GAT H=4 C=16, then H=1 C=47, its values padded to C=48 as
    the flash route pads them), path L's layer 1 (GATv2 H=4 C=64 on path
    C's graph with self loops) and path M's (the dot form), random tables
    from ``seed``: each held against its plain version (``flash_close``: the
    kernels on the tables as given, and the public route, which pads), then
    device time per launch (``device_ms``), CUDA-event wall, the plain
    version's time (its backward covers both passes), the bound (the
    unpadded tables' bytes once at 3.35 TB/s), the rate of gathered rows and
    each launch's team shape (``kernel_shape``: the 16-byte arm is ``vec``
    4); the log quotes beside them the times recorded before kernel (a)'s
    redesign (``FLASH_RECORDED_BEFORE_MS``, in no printed record). No
    library yardstick: no one PyTorch call computes a segment
    softmax-aggregation. The A/B of kernel (a)'s batch runs from
    ``kernel_ab.py``."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    g = torch.Generator(device='cuda').manual_seed(seed + 11)
    rows = []
    shapes = []
    n = N_PRODUCTS
    loops = np.arange(n, dtype=np.int32)
    kd = torch.as_tensor(np.concatenate([coo[1], loops]), device='cuda')
    ks = torch.as_tensor(np.concatenate([coo[0], loops]), device='cuda')
    shapes.append(('K layer 1', 'gat', 4, 16, ks, kd, n, n))
    shapes.append(('K layer 2', 'gat', 1, PR_CLASSES, ks, kd, n, n))
    npc = PC_NODES
    lp = np.arange(npc, dtype=np.int32)
    keep = pc['coo'][0] != pc['coo'][1]
    ls = torch.as_tensor(np.concatenate([pc['coo'][0][keep], lp]),
                         device='cuda')
    ld = torch.as_tensor(np.concatenate([pc['coo'][1][keep], lp]),
                         device='cuda')
    shapes.append(('L layer 1', 'gatv2', PC_HEADS, PC_HIDDEN // PC_HEADS, ls,
                   ld, npc, npc))
    # path M's layer 1: the union attention of one relation over path C's
    # graph as it is (TransformerConv adds no loops), prior 1 / sqrt(C)
    shapes.append(('M layer 1', 'dot', PC_HEADS, PC_HIDDEN // PC_HEADS,
                   torch.as_tensor(pc['coo'][0], device='cuda'),
                   torch.as_tensor(pc['coo'][1], device='cuda'), npc, npc))
    worst = (0.0, 0.0)
    for label, form, h, c, s, d, ns, nd in shapes:
        sw = h if form == 'gat' else h * c
        src_tab = torch.randn(ns, sw, device='cuda', generator=g)
        dst_tab = torch.randn(nd, sw, device='cuda', generator=g)
        val = (src_tab if form == 'gatv2' else
               torch.randn(ns, h * c, device='cuda', generator=g))
        extra = rel = None
        if form == 'gatv2':
            extra = (torch.randn(h * c, device='cuda', generator=g)
                     / math.sqrt(c))
        if form == 'dot':
            extra = torch.full((1, h), 1 / math.sqrt(c), device='cuda')
            rel = torch.zeros(s.shape[0], dtype=torch.int64, device='cuda')
        base = fs.FlashOperands(form, h, src_tab, dst_tab, val, extra, 0.2)
        got, err = flash_kernel_rows(torch, label, base, s, d, rel, nd)
        rows += got
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        del base, src_tab, dst_tab, val, rel
        torch.cuda.empty_cache()
    return rows, worst


# -- heterogeneous graphs: paths N, O, P, Q -----------------------------------
# benchmarks/hetero_bench.py's OGB-MAG shape (:35-43): 4 node types, 4
# relations and the reverses of the 3 between two types, F = 64, 8 classes
MAG_NODES = {'paper': 736_389, 'author': 1_134_649,
             'institution': 8_740, 'field': 59_965}
MAG_EDGES = {
    ('author', 'affiliated_with', 'institution'): 1_043_998,
    ('author', 'writes', 'paper'): 7_145_660,
    ('paper', 'cites', 'paper'): 5_416_271,
    ('paper', 'has_topic', 'field'): 7_505_078,
}
MAG_F, MAG_C = 64, 8
# run_hgt's model (:84-151): HGTConv(64, heads=4) twice, then a Linear to 8
# classes on 'paper', Adam 1e-3 (paths N and O; path Q's optimiser too)
HG_HIDDEN, HG_HEADS, HG_LR = 64, 4, 1e-3
# the timed steps of each training arm, after one warm-up
HG_STEPS = 5
# path O at the bench's default scale (:331); path N carries full scale
PO_SCALE = 0.25
# the scale of paths N, O and P's checks against the CPU
HG_SMALL = 0.002
# path Q: HeteroNeighborLoader fan-outs [10, 10], 1,024 'paper' seeds a
# batch, PQ_STEPS eager steps
PQ_FANOUTS, PQ_BATCH, PQ_STEPS = (10, 10), 1024, 6


def build_mag_like(scale=1.0, seed=0, reverse=True):
    """``benchmarks/hetero_bench.py::build_mag_like`` (``:46-60``): the
    OGB-MAG counts times ``scale`` (at least 8 nodes and 16 edges a type),
    uniform random endpoints, the reverse ``rev_{rel}`` of each relation
    between two types, x [n, 64] per type and 8 labels on 'paper', all from
    ``seed``."""
    rng = np.random.default_rng(seed)
    nodes = {t: max(int(n * scale), 8) for t, n in MAG_NODES.items()}
    edges = {}
    for (s, r, d), e in MAG_EDGES.items():
        e = max(int(e * scale), 16)
        coo = np.stack([rng.integers(0, nodes[s], e),
                        rng.integers(0, nodes[d], e)]).astype(np.int32)
        edges[(s, r, d)] = coo
        if reverse and s != d:
            edges[(d, f'rev_{r}', s)] = coo[::-1].copy()
    x = {t: rng.standard_normal((n, MAG_F)).astype(np.float32)
         for t, n in nodes.items()}
    y = rng.integers(0, MAG_C, nodes['paper']).astype(np.int32)
    return nodes, edges, x, y


class Held(dict):
    """A dict that ``compat.compile`` takes as a static argument: keyed by
    its identity and read in place (a plain dict is unhashable)."""
    __hash__ = object.__hash__


def mag_inputs(torch, x, edges, y, device='cuda'):
    """The bench graph's features, raw COOs and 'paper' labels on
    ``device``."""
    return (Held({t: torch.as_tensor(v, device=device)
                  for t, v in x.items()}),
            Held({et: torch.as_tensor(c, device=device)
                  for et, c in edges.items()}),
            torch.as_tensor(y, device=device).long())


def hgt_net(torch, device, seed, metadata=None, attn_path=None,
            layouts=None):
    """Paths N's and O's model, ``run_hgt``'s (``hetero_bench.py:92-101``):
    HGTConv(64 -> 64, 4 heads) twice, then a Linear to 8 classes on
    'paper', weights from ``seed``; ``layouts``
    (``build_hgt_flash_layouts``) go to both layers."""
    from pytorch_geometric_tpu_torch.nn import HGTConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.backend import resolve_device
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList([HGTConv(
                MAG_F if i == 0 else HG_HIDDEN, HG_HIDDEN, metadata,
                heads=HG_HEADS, attn_path=attn_path, device=device,
                generator=g) for i in range(2)])
            self.lin = linear(HG_HIDDEN, MAG_C, device=device, generator=g)

        def forward(self, x, ei):
            for conv in self.convs:
                x = conv(x, ei, layouts)
            return self.lin(x['paper'])

    return Net()


def hgt_routes(edges):
    """Each destination type's union of incoming edges and the fused route
    ``hetero_edge_attention_multi`` takes for it: 'flash' past
    ``PGT_ATTN_WIDE_BYTES`` of ``[E, H, 2 D]`` float32, else 'wide'."""
    from pytorch_geometric_tpu_torch.ops.edge_attention import wide_bytes_cap
    union = {}
    for (_, _, d), coo in edges.items():
        union[d] = union.get(d, 0) + int(coo.shape[1])
    d_hid = HG_HIDDEN // HG_HEADS
    return {t: (e, 'flash' if e * HG_HEADS * 2 * d_hid * 4 > wide_bytes_cap()
                else 'wide') for t, e in union.items()}


def hgt_backward_layers(edges):
    """Per node type, the layers of path N's model whose union for that
    type enters a step's backward: those whose outputs reach the loss,
    which reads layer 2's 'paper' (in layer 2 'paper' alone, in layer 1
    'paper' and the types of the relations into it)."""
    reach = [{s for (s, _, d) in edges if d == 'paper'} | {'paper'},
             {'paper'}]
    return {d: sum(d in r for r in reach) for (_, _, d) in edges}


def hgt_launches(routes, edges):
    """Path N's kernel launches per forward and per step, on raw COOs
    (``routes``: ``hgt_routes``) and with a flash layout for every type. A
    forward runs each union once per layer: kernel (a) for a flash union,
    one dot launch (the logits) for a wide one. In a step's backward
    (``hgt_backward_layers``) a flash union adds kernels (b) and (c), a
    wide one two dot launches (``dalpha`` and the prior's ``base``)."""
    bwd = hgt_backward_layers(edges)
    per_fwd, per_step, per_step_l = {}, {}, {}

    def add(want, k, n):
        if n:
            want[k] = want.get(k, 0) + n

    for t, (_, route) in routes.items():
        for k in ('flash_fwd', 'flash_bwd_dst', 'flash_bwd_src'):
            add(per_step_l, k, 2 if k == 'flash_fwd' else bwd[t])
            if route == 'flash':
                add(per_step, k, 2 if k == 'flash_fwd' else bwd[t])
        if route == 'flash':
            add(per_fwd, 'flash_fwd', 2)
        else:
            add(per_fwd, 'edge_dot', 2)
            add(per_step, 'edge_dot', 2 + 2 * bwd[t])
    return per_fwd, per_step, per_step_l


def sort_launches(torch, fn):
    """Launches and device ms per call of the sort kernels (names holding
    'sort') in a whole profiled window of one call of ``fn``."""
    rows, _, _ = whole_window(torch, fn, 1)
    picks = [(t, n) for name, t, n in rows if 'sort' in name.lower()]
    return sum(n for _, n in picks), sum(t for t, _ in picks)


def idle_unprofiled(res, busy_key, ms_key):
    """The idle share of the card against the unprofiled wall."""
    return 1 - res[busy_key] / res[ms_key]


def union_operands(torch, edges, nodes, dst, g):
    """HGT's fused-route operands for ``dst``'s union at path N's width:
    random node tables (keys and values of every source relation stacked,
    the destination's queries, one prior per relation), and the union's
    sources (offset into the stacked tables), destinations and relation
    ids, on the card. Returns ``(ops, s, d, rel)``."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    h, c = HG_HEADS, HG_HIDDEN // HG_HEADS
    rels = [(et, coo) for et, coo in edges.items() if et[2] == dst]
    off, s, d, rel = 0, [], [], []
    for i, (et, coo) in enumerate(rels):
        s.append(coo[0].astype(np.int64) + off)
        d.append(coo[1].astype(np.int64))
        rel.append(np.full(coo.shape[1], i, np.int64))
        off += nodes[et[0]]
    k = torch.randn(off, h * c, device='cuda', generator=g)
    v = torch.randn(off, h * c, device='cuda', generator=g)
    q = torch.randn(nodes[dst], h * c, device='cuda', generator=g)
    p = torch.rand(len(rels), h, device='cuda', generator=g) / math.sqrt(c)
    ops = fs.FlashOperands('dot', h, k, q, v, p, 0.0)
    return (ops,) + tuple(torch.as_tensor(np.concatenate(a), device='cuda')
                          for a in (s, d, rel))


def institution_dot_row(torch, edges, nodes, g):
    """The dot kernel at the wide route's shape, ``institution``'s union
    (``<q[dst], k[src]>`` per head, H = 4, D = 16, in edge order as
    ``_Attention`` calls it): against its plain version (``dot_close``),
    timed with the plain version, ``torch.sparse.sampled_addmm`` (one call
    per head, on the dst-sorted CSR) and the bound. Returns (row, err)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops.edge_dot import (edge_dot,
                                                          edge_dot_plain)
    h, f = HG_HEADS, HG_HIDDEN // HG_HEADS
    (et, coo), = [(et, c) for et, c in edges.items()
                  if et[2] == 'institution']
    ns, nd, e = nodes[et[0]], nodes['institution'], coo.shape[1]
    q = torch.randn(nd, h, f, device='cuda', generator=g)
    k = torch.randn(ns, h, f, device='cuda', generator=g)
    src = torch.as_tensor(coo[0], device='cuda').long()
    dst = torch.as_tensor(coo[1], device='cuda').long()
    with torch.inference_mode():
        err, ok = dot_close(torch, q, k, dst, src)
        check(ok, f'edge_dot at institution\'s union: {err} from the plain '
                  'version')
        blk = EdgeIndex(torch.as_tensor(coo, device='cuda'),
                        (ns, nd)).fill_cache(blocked=True).blocked
        fns = {'ms': lambda: edge_dot(q, k, dst, src),
               'plain_ms': lambda: edge_dot_plain(q, k, dst, src),
               'library_ms': sampled_addmm_call(torch, blk, k, q, nd, ns, e)}
        row = timed_row(torch, fns, {
            'path': 'N', 'shape': 'institution union (wide route)',
            'order': 'edge', 'dtype': 'float32', 'H': h, 'F': f,
            'HF': h * f, 'edges': e, 'n_src': ns, 'n_dst': nd,
            'library_call': 'torch.sparse.sampled_addmm, one call a head'},
            dot_bytes(nd, ns, e, h, f, 4, 16), 2.0 * e * h * f)
    row['max_abs_err'] = err
    log(f"[timing] edge_dot path N institution union ({e} edges, H*F="
        f"{h * f}): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
        f"ms, sampled_addmm {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs err "
        f'{err:.3e}')
    return row, err


def phase_path_n(torch, seed, mag, iters):
    """Path N: ``hetero_bench.py --arms hgt`` at full scale (``build_mag_like
    (1.0)``: 1,939,743 nodes, 36,804,743 edges), the fused route on raw
    COOs: per layer, 'paper', 'author' and 'field' past the cap on the
    flash kernels (a), (b), (c), 'institution' on the wide op and the dot
    kernel. Served and trained (5 steps after 1) eager and captured
    (``flash_serve_train``); held against the plain versions on the card
    (forward, 3 losses, first step's gradients) and at ``HG_SMALL`` scale
    against the CPU, the cap scaled with it. Then the bench's
    ``--layouts`` arm: ``build_hgt_flash_layouts`` (every type on flash
    over host-presorted unions), trained eager and captured; the sort
    launches a step of each arm. Then each kernel of the path at its
    shapes: the flash kernels over the three flash unions and the dot
    kernel over institution's union, against their plain versions and
    timed."""
    from pytorch_geometric_tpu_torch.ops import build_hgt_flash_layouts
    tag = 'path N'
    nodes, edges, x, y = mag
    meta = (tuple(nodes), tuple(edges))
    routes = hgt_routes(edges)
    log(f'[{tag}] union edges and routes by destination type: {routes}')
    check({t for t, (_, r) in routes.items() if r == 'flash'}
          == {'paper', 'author', 'field'}
          and routes['institution'][1] == 'wide',
          f'{tag}: routes {routes}, expected flash for paper, author and '
          'field and the wide op for institution')
    per_fwd, per_step, per_step_l = hgt_launches(routes, edges)
    X, EI, Y = mag_inputs(torch, x, edges, y)
    build = functools.partial(hgt_net, metadata=meta)
    # the wide op adds with atomics: the eager step is not bitwise
    # repeatable
    res, state, _ = flash_serve_train(
        torch, tag, build, seed, X, EI, Y, per_fwd, per_step, iters,
        HG_STEPS, HG_LR, sync_state=True)
    res['routes'] = {t: {'union_edges': e, 'route': r}
                     for t, (e, r) in routes.items()}
    res['nodes'] = sum(nodes.values())
    res['edges'] = sum(c.shape[1] for c in edges.values())
    res['device_idle_share_unprofiled'] = idle_unprofiled(
        res, 'device_busy_ms_per_forward', 'ms_per_forward')
    tr = res['training']
    tr['device_idle_share_unprofiled'] = idle_unprofiled(
        tr, 'device_busy_ms_per_step', 'ms_per_step')
    res['parity_vs_plain_on_card'] = flash_parity(
        torch, tag, build, state, X, EI, Y, HG_LR, 'plain')
    small = build_mag_like(HG_SMALL, seed)
    sstate = {k: v.detach().cpu().clone() for k, v in build(
        torch, None, seed).state_dict().items()}
    with scaled_cap(HG_SMALL):
        check({t: r for t, (_, r) in hgt_routes(small[1]).items()}
              == {t: r for t, (_, r) in routes.items()},
              f'{tag}: the routes at {HG_SMALL} scale differ')
        res['parity_small_vs_cpu'] = flash_parity(
            torch, f'{tag} at {HG_SMALL} scale', build, sstate,
            *mag_inputs(torch, small[2], small[1], small[3]), HG_LR,
            mag_inputs(torch, small[2], small[1], small[3], 'cpu'))
    # the bench's --layouts arm: every union presorted on the host once
    t0 = time.perf_counter()
    lay = build_hgt_flash_layouts(meta, edges, nodes)
    lay_s = time.perf_counter() - t0
    build_l = functools.partial(hgt_net, metadata=meta, layouts=lay)
    arms = {}
    for name, make, want in (('raw COO', build, per_step),
                             ('layouts', build_l, per_step_l)):
        model = from_state(torch, lambda: make(torch, None, seed), state)
        opt = torch.optim.Adam(model.parameters(), lr=HG_LR)

        def step():
            return train_step(torch, model, opt, X, EI, Y)

        torch.cuda.synchronize()
        reset_counts()
        ms, _, enq, loss = timed_steps(torch, step, 1, HG_STEPS)
        counts = launch_counts()
        check_counts(f'{tag} {name}', counts,
                     {k: n * (1 + HG_STEPS) for k, n in want.items()},
                     f'{1 + HG_STEPS} steps')
        sorts, sort_ms = sort_launches(torch, step)
        arms[name] = {'ms_per_step': ms, 'host_enqueue_ms_per_step': enq,
                      'loss_after': loss, 'launch_counts': counts,
                      'sort_launches_per_step': sorts,
                      'sort_ms_per_step': sort_ms}
        log(f'[{tag}] {name} arm, eager: {ms:.4f} ms per step (CUDA events, '
            f'{HG_STEPS} after 1), the host issues one in {enq:.4f} ms; '
            f'{sorts:g} sort launches a step ({sort_ms:.4f} ms)')
        del model, opt
        torch.cuda.empty_cache()
    arms['layouts']['build_s'] = lay_s
    arms['layouts']['captured'] = captured_training(
        torch, f'{tag} layouts captured', lambda: from_state(
            torch, lambda: build_l(torch, None, seed), state), X, EI, Y,
        None, per_step_l, HG_STEPS, 1e-4, lr=HG_LR, sync_state=True)
    arms['layouts']['launches_per_step'] = per_step_l
    res['layouts_arm'] = arms
    log(f"[{tag}] build_hgt_flash_layouts on the host in {lay_s:.2f} s; "
        f"captured step with layouts "
        f"{arms['layouts']['captured']['ms_per_step']:.4f} ms against "
        f"{tr['captured']['ms_per_step']:.4f} ms on raw COOs")
    del lay, build_l
    torch.cuda.empty_cache()
    # each kernel of the path at its shapes
    g = torch.Generator(device='cuda').manual_seed(seed + 21)
    rows, worst = [], (0.0, 0.0)
    for dst in ('paper', 'author', 'field'):
        ops, s, d, rel = union_operands(torch, edges, nodes, dst, g)
        got, err = flash_kernel_rows(torch, f'N {dst} union', ops, s, d, rel,
                                     nodes[dst], route=False)
        for r in got:
            r['launches_per_step'] = 2 if r['kernel'] == 'flash_fwd' else \
                hgt_backward_layers(edges)[dst]
        rows += got
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        del ops, s, d, rel
        torch.cuda.empty_cache()
    dot_row, dot_err = institution_dot_row(torch, edges, nodes, g)
    dot_row['launches_per_step'] = per_step['edge_dot']
    del X, EI, Y
    torch.cuda.empty_cache()
    return res, rows, worst, dot_row, dot_err


def mix_library_call(torch, lay, pp, v, f, n_dst, n_src):
    """H ``torch.sparse.mm`` CSR calls, one per head (a yardstick; the port
    never calls it) over a rectangular slot order, checked against the
    plain version."""
    from pytorch_geometric_tpu_torch.ops.gat_fused import gat_mix_plain
    h = pp.shape[1]
    mats = [torch.sparse_csr_tensor(lay.indptr, lay.src,
                                    pp[:, k].contiguous(),
                                    size=(n_dst, n_src)) for k in range(h)]
    vs = [v.view(n_src, h, f)[:, k].contiguous() for k in range(h)]

    def call():
        return [torch.sparse.mm(a, b) for a, b in zip(mats, vs)]

    _, ref = gat_mix_plain(lay.indptr, lay.src, None, pp, v, f)
    lib = torch.stack(call(), 1).reshape(n_dst, h * f)
    check(bool(torch.allclose(lib, ref, rtol=1e-4, atol=1e-4)),
          f'torch.sparse.mm disagrees at F={f}')
    return call


def blocked_inputs(torch, nodes, edges, device='cuda'):
    """Every relation as an ``EdgeIndex`` of its rectangular size with the
    slot orders (``fill_cache(blocked=True)``), built on ``device``."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    return Held({et: EdgeIndex(torch.as_tensor(c, device=device),
                               (nodes[et[0]], nodes[et[2]])).fill_cache(
        blocked=True) for et, c in edges.items()})


def phase_path_o(torch, seed, iters):
    """Path O: path N's model on the blocked route (``attn_path='blocked'``,
    every relation ``fill_cache(blocked=True)``, rectangular ones
    included), ``hetero_bench.py``'s default 0.25 scale: the union softmax
    through ``multi_relation_softmax_aggregate`` on the mix kernel (and the
    dot kernel in its backward). Served and trained eager and captured,
    each kernel arm's launches per call measured on a first forward and
    step and held thereafter; held against the CPU at ``HG_SMALL`` scale;
    the mix against its plain version and timed at the ``writes``
    relation (H*F = 64)."""
    from pytorch_geometric_tpu_torch.ops.gat_fused import (card_slice_cols,
                                                           gat_mix,
                                                           gat_mix_plain)
    tag = 'path O'
    nodes, edges, x, y = build_mag_like(PO_SCALE, seed)
    meta = (tuple(nodes), tuple(edges))
    X, _, Y = mag_inputs(torch, x, edges, y)
    t0 = time.perf_counter()
    EI = blocked_inputs(torch, nodes, edges)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = functools.partial(hgt_net, metadata=meta, attn_path='blocked')
    model = build(torch, None, seed)
    opt = torch.optim.Adam(model.parameters(), lr=HG_LR)
    reset_counts()
    with torch.inference_mode():
        model(X, EI)
    per_fwd = {k: v for k, v in launch_counts().items() if v}
    reset_counts()
    train_step(torch, model, opt, X, EI, Y)
    per_step = {k: v for k, v in launch_counts().items() if v}
    del model, opt
    log(f'[{tag}] slot orders of the {len(edges)} relations built on the '
        f'card in {build_s:.2f} s; launches per forward {per_fwd}, per step '
        f'{per_step}')
    check(per_fwd.get('gat_mix', 0) > 0 and per_step.get('gat_mix', 0) > 0
          and set(per_fwd) | set(per_step) <= {'gat_mix', 'edge_dot'},
          f'{tag}: launches per forward {per_fwd}, per step {per_step}')
    res, state, _ = flash_serve_train(
        torch, tag, build, seed, X, EI, Y, per_fwd, per_step, iters,
        HG_STEPS, HG_LR, sync_state=True)
    res.update(scale=PO_SCALE, nodes=sum(nodes.values()),
               edges=sum(c.shape[1] for c in edges.values()),
               slot_orders_build_s=build_s)
    res['device_idle_share_unprofiled'] = idle_unprofiled(
        res, 'device_busy_ms_per_forward', 'ms_per_forward')
    res['training']['device_idle_share_unprofiled'] = idle_unprofiled(
        res['training'], 'device_busy_ms_per_step', 'ms_per_step')
    small = build_mag_like(HG_SMALL, seed)
    sstate = {k: v.detach().cpu().clone() for k, v in build(
        torch, None, seed).state_dict().items()}
    xs, _, ys = mag_inputs(torch, small[2], small[1], small[3])
    xc, _, yc = mag_inputs(torch, small[2], small[1], small[3], 'cpu')
    res['parity_small_vs_cpu'] = flash_parity(
        torch, f'{tag} at {HG_SMALL} scale', build, sstate, xs,
        blocked_inputs(torch, small[0], small[1]), ys, HG_LR,
        (xc, blocked_inputs(torch, small[0], small[1], 'cpu'), yc))
    # the mix at the writes relation (author -> paper), H*F = 64
    et = ('author', 'writes', 'paper')
    blk = EI[et].blocked
    h, f = HG_HEADS, HG_HIDDEN // HG_HEADS
    ns, nd, e = nodes['author'], nodes['paper'], int(blk.src.shape[0])
    g = torch.Generator(device='cuda').manual_seed(seed + 22)
    p = torch.rand(e, h, device='cuda', generator=g)
    v = torch.randn(ns, h * f, device='cuda', generator=g)
    with torch.inference_mode():
        err, ok = mix_close(torch, blk, p, p, v, f)
        check(ok, f'{tag}: the mix at the writes relation {err} from its '
                  'plain version')
        fns = {'ms': lambda: gat_mix(blk.indptr, blk.src, p, p, v, f),
               'plain_ms': lambda: gat_mix_plain(blk.indptr, blk.src, p, p,
                                                 v, f),
               'library_ms': mix_library_call(torch, blk, p, v, f, nd, ns)}
        row = timed_row(torch, fns, {
            'path': 'O', 'pass': 'mix (s, u)', 'shape': 'writes relation '
            f'at {PO_SCALE} scale', 'H': h, 'F': f, 'HF': h * f,
            'slots': e, 'n_src': ns, 'n_dst': nd,
            'slice_cols': card_slice_cols(v, h, f),
            'launches_per_step': per_step['gat_mix']},
            mix_bytes(ns, nd, e, h, f, 1, True), 2.0 * e * h * f + e * h)
    row['max_abs_err'] = err
    log(f"[timing] gat_mix path O writes relation ({e} slots, H*F={h * f}):"
        f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"{h} sparse.mm {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs err "
        f'{err:.3e}')
    del X, EI, Y
    torch.cuda.empty_cache()
    return res, row, err


def rgcn_net(torch, device, seed, num_relations=0, p_off=0, p_n=0):
    """Path P's model, ``run_rgcn``'s (``hetero_bench.py:179-185``):
    FastRGCNConv(64 -> 64) -> ReLU -> FastRGCNConv(64 -> 64) -> Linear to 8
    classes, over ``(coo, edge_type)``; returns the 'paper' rows' logits
    (the homogenised ids ``[p_off, p_off + p_n)``)."""
    from pytorch_geometric_tpu_torch.nn import FastRGCNConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.backend import resolve_device
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList([FastRGCNConv(
                MAG_F if i == 0 else HG_HIDDEN, HG_HIDDEN,
                num_relations=num_relations, device=device, generator=g)
                for i in range(2)])
            self.lin = linear(HG_HIDDEN, MAG_C, device=device, generator=g)

        def forward(self, x, ei):
            coo, et = ei
            h = torch.relu(self.convs[0](x, coo, et))
            h = self.convs[1](h, coo, et)
            return self.lin(h[p_off:p_off + p_n])

    return Net()


def homogenised(torch, nodes, edges, x, device='cuda'):
    """The bench graph through the port's ``HeteroData.to_homogeneous`` (x
    kept on ``device``), its type offsets and edge layout held bit for bit
    against ``run_rgcn``'s own (``hetero_bench.py:162-177``). Returns
    ``(x, (coo, edge_type), paper offset, seconds)``."""
    from pytorch_geometric_tpu_torch.data import HeteroData
    data = HeteroData()
    for t in nodes:
        data[t].x = torch.as_tensor(x[t], device=device)
    for et, coo in edges.items():
        data[et].edge_index = coo
    t0 = time.perf_counter()
    homo = data.to_homogeneous()
    secs = time.perf_counter() - t0
    offs, off = {}, 0
    for t in nodes:
        offs[t] = off
        off += nodes[t]
    want = np.concatenate([coo + np.array([[offs[s]], [offs[d]]], np.int32)
                           for (s, _, d), coo in edges.items()], 1)
    ety = np.concatenate([np.full(c.shape[1], i, np.int32)
                          for i, c in enumerate(edges.values())])
    check(homo.num_nodes == off
          and np.array_equal(homo.edge_index.numpy(), want)
          and np.array_equal(homo.edge_type.numpy(), ety)
          and homo.edge_index.dtype == torch.int32,
          'to_homogeneous: offsets or edge layout differ from run_rgcn\'s')
    return (homo.x, (homo.edge_index.to(device), homo.edge_type.to(device)),
            offs['paper'], secs)


def phase_path_p(torch, seed, mag):
    """Path P: ``hetero_bench.py --arms rgcn,proj`` at full scale. The graph
    homogenised by the port's ``HeteroData.to_homogeneous`` (offsets held
    against ``run_rgcn``'s), ``rgcn_net`` trained (Adam 1e-3, 5 steps after
    1; the JAX package aggregates with ``scatter``, no Pallas kernel, so no
    kernel of the port launches, which is checked), profiled, held against
    the CPU at ``HG_SMALL`` scale. Then ``run_projection_ab`` (``:216-276``):
    the three typed-projection strategies over the 1,939,743 rows of 4
    types, F = 64 -> 64: per-type GEMM, ``typed_matmul``'s ragged arm and
    its dense einsum (``nf,rfc->nrc``, the module's; the bench's arm 3
    gathers ``W`` per row, a ``[N, 64, 64]`` float32 transient of 31.8 GB),
    each against the per-type GEMM, device time and CUDA-event wall."""
    from pytorch_geometric_tpu_torch.ops import (build_ragged_layout,
                                                 typed_matmul)
    tag = 'path P'
    nodes, edges, x, y = mag
    X, EI, p_off, homo_s = homogenised(torch, nodes, edges, x)
    Y = torch.as_tensor(y, device='cuda').long()
    build = functools.partial(rgcn_net, num_relations=len(edges),
                              p_off=p_off, p_n=nodes['paper'])
    model = build(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=HG_LR)

    def step():
        return train_step(torch, model, opt, X, EI, Y)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, _, enq, loss = timed_steps(torch, step, 1, HG_STEPS)
    prof, n_prof = profile_steps(torch, step, tag)
    n_steps = 1 + HG_STEPS + n_prof
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{n_steps} steps')
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = {'nodes': sum(nodes.values()), 'edges': int(EI[0].shape[1]),
           'relations': len(edges), 'to_homogeneous_s': homo_s,
           'ms_per_step': ms, 'host_enqueue_ms_per_step': enq,
           'steps': n_steps, 'loss_after': loss, 'launch_counts': counts,
           'peak_memory_gb': peak}
    res.update(prof)
    res['device_idle_share_unprofiled'] = idle_unprofiled(
        res, 'device_busy_ms_per_step', 'ms_per_step')
    log(f'[{tag}] FastRGCN on the homogenised graph ({res["nodes"]} nodes, '
        f'{res["edges"]} edges, 7 relations; to_homogeneous {homo_s:.2f} s): '
        f'{ms:.4f} ms per step (CUDA events, {HG_STEPS} after 1), the host '
        f'issues one in {enq:.4f} ms; loss {loss:.6f}; no port kernel '
        f'launched; peak memory {peak:.3f} GB')
    del model, opt
    torch.cuda.empty_cache()
    small = build_mag_like(HG_SMALL, seed)
    xs, eis, ps, _ = homogenised(torch, small[0], small[1], small[2])
    xc, eic, _, _ = homogenised(torch, small[0], small[1], small[2], 'cpu')
    build_s = functools.partial(rgcn_net, num_relations=len(edges),
                                p_off=ps, p_n=small[0]['paper'])
    sstate = {k: v.detach().cpu().clone() for k, v in build_s(
        torch, None, seed).state_dict().items()}
    res['parity_small_vs_cpu'] = flash_parity(
        torch, f'{tag} at {HG_SMALL} scale', build_s, sstate, xs, eis,
        torch.as_tensor(small[3], device='cuda').long(), HG_LR,
        (xc, eic, torch.from_numpy(small[3]).long()))
    # run_projection_ab: the three typed-projection arms
    types = np.concatenate([np.full(n, i, np.int64)
                            for i, n in enumerate(nodes.values())])
    g = torch.Generator(device='cuda').manual_seed(seed + 23)
    w = torch.randn(len(nodes), MAG_F, HG_HIDDEN, device='cuda',
                    generator=g) / math.sqrt(MAG_F)
    tv = torch.as_tensor(types, device='cuda')
    ragged = build_ragged_layout(types, len(nodes))
    bounds = np.cumsum([0] + list(nodes.values()))
    fns = {'per_type_gemm': lambda: torch.cat([
               X[bounds[i]:bounds[i + 1]] @ w[i] for i in range(len(nodes))]),
           'ragged': lambda: typed_matmul(X, tv, w, ragged),
           'dense_einsum': lambda: typed_matmul(X, tv, w)}
    ab = {'rows': int(X.shape[0]), 'types': len(nodes), 'F': MAG_F,
          'C': HG_HIDDEN}
    with torch.inference_mode():
        ref = fns['per_type_gemm']()
        for name, fn in fns.items():
            torch.cuda.reset_peak_memory_stats()
            d = float((fn() - ref).abs().max())
            check(d <= 1e-5 * float(ref.abs().max()),
                  f'{tag}: typed projection {name} {d} from the per-type '
                  'GEMM')
            ab[name] = {'ms': device_ms(torch, fn, calls=10),
                        'event_ms': timed_calls(torch, fn, 10, 2)[0],
                        'max_abs_diff': d,
                        'peak_memory_gb':
                            torch.cuda.max_memory_allocated() / 1e9}
    res['projection_ab'] = ab
    log(f'[{tag}] typed projection A/B over {ab["rows"]} rows of 4 types, '
        f'64 -> 64: ' + ', '.join(
            f"{k} {ab[k]['ms']:.4f} ms [CUDA-event wall "
            f"{ab[k]['event_ms']:.4f}]" for k in fns)
        + ' (device time a call; the per-type GEMM is what HGTConv does)')
    del X, EI, Y
    torch.cuda.empty_cache()
    return res


def sage_hetero_net(torch, device, seed, metadata=None):
    """Path Q's model: ``to_hetero`` of SAGEConv(64 -> 64) -> ReLU ->
    SAGEConv(64 -> 64) over the metadata, then a Linear to 8 classes on
    'paper'."""
    from pytorch_geometric_tpu_torch.nn import SAGEConv, to_hetero
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.backend import resolve_device
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gnn = to_hetero([
                SAGEConv(MAG_F, HG_HIDDEN, device=device, generator=g),
                torch.relu,
                SAGEConv(HG_HIDDEN, HG_HIDDEN, device=device, generator=g)],
                metadata)
            self.lin = linear(HG_HIDDEN, MAG_C, device=device, generator=g)

        def forward(self, x, ei):
            return self.lin(self.gnn(x, ei)['paper'])

    return Net()


def phase_path_q(torch, seed, mag):
    """Path Q: sampled heterogeneous GraphSAGE at full scale. The bench
    graph in a ``HeteroData`` (x and labels on the card) ->
    ``HeteroNeighborLoader([10, 10], 1,024 'paper' seeds, shuffle)`` on the
    native hetero sampler (the phase fails without it) -> each batch's
    relations as ``EdgeIndex`` es on the card (``batch_edge_index_dict``:
    the sampler's padding past both ends) -> ``sage_hetero_net``, so every
    SAGE mean runs kernel 1 forward and, for the relations the loss
    reaches, its ``A^T g``; cross-entropy over the seeds, Adam 1e-3,
    ``PQ_STEPS`` eager steps: the host's sampling time a batch beside the
    card's time a step, kernel 1's launches a step (measured on the first,
    held for the rest), a whole-window profile of a step, the first batch's
    forward against the CPU. One ``HGTLoader`` batch through the same
    model. Kernel 1 against its plain version and timed at the first
    batch's ``writes`` relation (forward and ``A^T g``, F = 64)."""
    from pytorch_geometric_tpu_torch import csrc
    from pytorch_geometric_tpu_torch.data import HeteroData
    from pytorch_geometric_tpu_torch.loader import (HGTLoader,
                                                    HeteroNeighborLoader,
                                                    batch_edge_index_dict)
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm
    tag = 'path Q'
    check(csrc.WITH_NATIVE_SAMPLER, f'{tag}: the native sampler did not '
          'build (g++)')
    nodes, edges, x, y = mag
    meta = (tuple(nodes), tuple(edges))
    data = HeteroData()
    for t in nodes:
        data[t].x = torch.as_tensor(x[t], device='cuda')
    data['paper'].y = torch.as_tensor(y, device='cuda')
    for et, coo in edges.items():
        data[et].edge_index = coo
    t0 = time.perf_counter()
    loader = HeteroNeighborLoader(data, list(PQ_FANOUTS), ('paper', None),
                                  batch_size=PQ_BATCH, shuffle=True,
                                  seed=seed)
    csc_s = time.perf_counter() - t0
    model = sage_hetero_net(torch, None, seed, meta)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=HG_LR)

    def step(batch):
        eis = batch_edge_index_dict(batch)
        bs = int(batch['paper'].batch_size)
        opt.zero_grad(set_to_none=True)
        logits = model(batch.x_dict, eis)
        loss = torch.nn.functional.cross_entropy(
            logits[:bs], batch['paper'].y[:bs].long())
        loss.backward()
        opt.step()
        return loss

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    it = iter(loader)
    sample_ms, card_ms, losses, first = [], [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    per_step = None
    for i in range(PQ_STEPS):
        t0 = time.perf_counter()
        batch = next(it)
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        start.record()
        losses.append(step(batch))
        end.record()
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end))
        if i == 0:
            first = batch
            per_step = {k: v for k, v in launch_counts().items() if v}
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(set(per_step) == {'segment_spmm'},
          f'{tag}: launches in the first step {per_step}')
    check_counts(tag, counts, {k: n * PQ_STEPS for k, n in per_step.items()},
                 f'{PQ_STEPS} steps')
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f'{tag}: losses {losses}')
    fill = {t: int(first[t].node_mask.sum()) for t in nodes}
    caps = {t: int(first[t].n_id.shape[0]) for t in nodes}
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(first), 3)
    busy = sum(t for _, t, _ in prof_rows)
    res = {'batch': PQ_BATCH, 'fanouts': list(PQ_FANOUTS),
           'csc_build_s': csc_s, 'steps': PQ_STEPS, 'losses': losses,
           'host_sampling_ms_per_batch': sample_ms,
           'card_ms_per_step': card_ms, 'launch_counts': counts,
           'launches_per_step': per_step, 'peak_memory_gb': peak,
           'nodes_per_batch': fill, 'node_budget_per_batch': caps,
           'edges_per_batch': {
               '__'.join(et): int(first[et].edge_mask.sum())
               for et in edges},
           'device_busy_ms_per_step': busy,
           'profiled_ms_per_step': prof_ms,
           'kernel1_ms_per_step': sum(t for n, t, _ in prof_rows
                                      if SEG_MAIN in n),
           'kernels_per_step': [[n[:80], t, c] for n, t, c in prof_rows[:8]]}
    res['device_idle_share_unprofiled'] = 1 - busy / float(
        np.median(card_ms[1:]))
    log(f'[{tag}] HeteroNeighborLoader over the bench graph (CSCs of 7 '
        f'relations in {csc_s:.2f} s): per batch the host samples in '
        f'{np.median(sample_ms):.2f} ms (median of {PQ_STEPS}; '
        f'{sample_ms}), the card runs a step in '
        f'{np.median(card_ms[1:]):.4f} ms (CUDA events; {card_ms}), busy '
        f'{busy:.4f} ms (torch.profiler), kernel 1 '
        f"{res['kernel1_ms_per_step']:.4f} ms, {per_step['segment_spmm']} "
        f'launches a step; losses {losses}; nodes per batch {fill} of '
        f'{caps}; peak memory {peak:.3f} GB')
    for name, t, n in prof_rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{n:g}  {name[:90]}')
    # the first batch's forward against the CPU, same weights
    cpu = sage_hetero_net(torch, 'cpu', seed, meta)
    cpu.load_state_dict(state)
    card = sage_hetero_net(torch, None, seed, meta)
    card.load_state_dict({k: v.cuda() for k, v in state.items()})
    with torch.inference_mode():
        got = card(first.x_dict, batch_edge_index_dict(first))
        ref = cpu({t: v.cpu() for t, v in first.x_dict.items()},
                  batch_edge_index_dict(first, 'cpu'))
    d = float((got.cpu() - ref).abs().max())
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    check(d <= lim, f'{tag}: the first batch\'s forward {d} from the CPU '
                    f'(limit {lim})')
    res['first_batch_vs_cpu'] = {'max_abs_diff': d, 'limit': lim}
    # one HGTLoader batch
    t0 = time.perf_counter()
    hgt_loader = HGTLoader(data, list(PQ_FANOUTS), ('paper', None),
                           batch_size=PQ_BATCH, seed=seed)
    hgt_csc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hb = next(iter(hgt_loader))
    hgt_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    with torch.inference_mode():
        out = card(hb.x_dict, batch_edge_index_dict(hb))
    torch.cuda.synchronize()
    hgt_counts = launch_counts()
    check(bool(torch.isfinite(out).all()) and hgt_counts['segment_spmm'] > 0,
          f'{tag}: HGTLoader batch: finite {bool(torch.isfinite(out).all())}'
          f', launches {hgt_counts}')
    res['hgt_loader'] = {'csc_build_s': hgt_csc_s, 'sampling_ms': hgt_ms,
                         'launch_counts': hgt_counts}
    log(f'[{tag}] one HGTLoader batch sampled in {hgt_ms:.2f} ms (CSCs '
        f"{hgt_csc_s:.2f} s), served on kernel 1 "
        f"({hgt_counts['segment_spmm']} launches)")
    # kernel 1 at the first batch's writes relation, F = 64
    et = ('author', 'writes', 'paper')
    ei = batch_edge_index_dict(first)[et]
    gen = torch.Generator(device='cuda').manual_seed(seed + 24)
    rows, worst = [], 0.0
    for label, lay, x_in in (
            ('Q writes forward', ei.csc, first['author'].x),
            ('Q writes backward (A^T g)', ei.csr,
             torch.randn((caps['paper'], HG_HIDDEN), generator=gen,
                         device='cuda'))):
        with torch.inference_mode():
            out = segment_spmm(lay.indptr, lay.indices, None, x_in)
            err, ok = segment_close(torch, lay.indptr, lay.indices, None,
                                    x_in, out)
            torch.cuda.synchronize()
            check(ok, f'segment_spmm {label}: {err} from the plain version')
            worst = max(worst, err)
            row = segment_timed(torch, label, lay.indptr, lay.indices, None,
                                x_in)
        row['max_abs_err'] = err
        row['slots'] = int(lay.indices.shape[0])
        rows.append(row)
    del data, loader, hgt_loader, model, opt, card, first, hb, it
    torch.cuda.empty_cache()
    return res, rows, worst


# -- the SpMM regimes: arm checks, paths R and S ---------------------------------
@contextlib.contextmanager
def knobs(env=None, attrs=()):
    """Environment variables and module attributes set for the block, put
    back after it."""
    env = env or {}
    old_env = {k: os.environ.get(k) for k in env}
    old_attr = [(m, a, getattr(m, a)) for m, a, _ in attrs]
    os.environ.update({k: str(v) for k, v in env.items()})
    for m, a, v in attrs:
        setattr(m, a, v)
    try:
        yield
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for m, a, v in old_attr:
            setattr(m, a, v)


def arm_graph(n, e, f, seed):
    """A random square graph of ``n`` nodes and ``e`` edges plus
    ``RA_PAD`` padded edges (both endpoints ``n``), its weights and x."""
    rng = np.random.default_rng(seed)
    coo = np.concatenate([rng.integers(0, n, (2, e)),
                          np.full((2, RA_PAD), n)], 1).astype(np.int32)
    return (coo, rng.random(coo.shape[1]).astype(np.float32),
            rng.standard_normal((n, f)).astype(np.float32))


def regime_reference(torch, coo, w, x, n_dst, reduce, g):
    """The plain version of one SpMM and its VJP in float64 on the card:
    gather, multiply, ``index_add_`` over the edges whose endpoints are in
    range, the mean over their count; ``(out, grad_x, grad_w)`` for the
    cotangent ``g``."""
    x64 = x.detach().double().requires_grad_()
    w64 = w.detach().double().requires_grad_()
    s, d = coo[0].long(), coo[1].long()
    ok = (s < x.shape[0]) & (d < n_dst)
    out = x64.new_zeros((n_dst, x.shape[1])).index_add_(
        0, d[ok], x64[s[ok]] * w64[ok][:, None])
    if reduce == 'mean':
        deg = torch.bincount(d[ok], minlength=n_dst).double()
        out = out / deg.clamp(min=1)[:, None]
    out.backward(g.double())
    return out.detach(), x64.grad, w64.grad


def phase_regime_arms(torch, seed):
    """The windowed, chunked and uncached dense regimes on the card, each
    forced by its knob at a size that really chunks (``RA_*``: several
    windows, several chunks), through the public ``spmm``: forward,
    ``grad_x`` and ``grad_w`` (weights that need a gradient), ``sum`` and
    ``mean``, forward and transposed, with padded edges; each against the
    float64 plain version (``regime_reference``) within PERF.md's limits
    (output 1e-5 of max(1, max|ref|), gradients 1e-4 of their largest),
    with the kernels each arm must launch counted (kernel 1 once a window
    pass or chunk, the dot kernel for ``grad_w``); then every arm raises
    with ``backend.use_kernel_spmm = False``. Returns the worst errors and
    the dot kernel's ``grad_w`` rows (timed, with the plain version and
    ``torch.sparse.sampled_addmm``)."""
    import importlib
    from types import SimpleNamespace
    from pytorch_geometric_tpu_torch import EdgeIndex, backend
    from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime
    from pytorch_geometric_tpu_torch.ops.edge_dot import (edge_dot,
                                                          edge_dot_plain)
    sm = importlib.import_module('pytorch_geometric_tpu_torch.ops.spmm')
    f = RA_F
    chunk_buf = RA_CHUNK * f * 4
    cases = {
        'windowed': (RA_NODES, RA_EDGES, {'PGT_WIN_EDGES': RA_CHUNK}),
        'chunked': (RA_NODES, RA_EDGES, {'PGT_SPMM_CHUNK_TRIGGER': 0,
                                         'PGT_SPMM_CHUNK_BUF': chunk_buf}),
        'dense': (RA_DENSE_NODES, RA_DENSE_EDGES,
                  {'PGT_FORCE_DENSE_SPMM': 1})}
    worst = {'out': 0.0, 'grad_x': 0.0, 'grad_w': 0.0}
    res = {}
    for arm, (n, e, env) in cases.items():
        coo_np, w_np, x_np = arm_graph(n, e, f, seed)
        coo = torch.as_tensor(coo_np, device='cuda')
        w0 = torch.as_tensor(w_np, device='cuda')
        x0 = torch.as_tensor(x_np, device='cuda')
        with knobs(env):
            ei = EdgeIndex(coo, (n, n))
            if arm == 'windowed':
                ei = ei.fill_cache(blocked=False, windowed=True)
                windows = ei.win.src.shape[0]
            chunks = -(-coo.shape[1] // sm.chunk_edges(f))
            for reduce in ('sum', 'mean'):
                for transpose in (False, True):
                    tag = f'{arm} {reduce}{" transposed" if transpose else ""}'
                    regime = spmm_regime(ei.flip() if transpose else ei, f,
                                         reduce, True)
                    check(regime == arm, f'{tag}: the {regime!r} regime ran')
                    x = x0.clone().requires_grad_()
                    w = w0.clone().requires_grad_()
                    torch.cuda.synchronize()
                    reset_counts()
                    out = spmm(ei, x, w, reduce=reduce, transpose=transpose)
                    g = torch.randn_like(out)
                    out.backward(g)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                    want = {'windowed': {'segment_spmm': 2, 'edge_dot': 1},
                            'chunked': {'segment_spmm': 2 * chunks,
                                        'edge_dot': chunks},
                            'dense': {'edge_dot': 1}}[arm]
                    check_counts(tag, counts, want, 'one forward and backward')
                    rc = coo.flip(0) if transpose else coo
                    ref, rgx, rgw = regime_reference(torch, rc, w0, x0, n,
                                                     reduce, g)
                    errs = {
                        'out': float((out.detach().double() - ref).abs().max())
                        / max(1.0, float(ref.abs().max())),
                        'grad_x': float((x.grad.double() - rgx).abs().max())
                        / max(float(rgx.abs().max()), 1e-30),
                        'grad_w': float((w.grad.double() - rgw).abs().max())
                        / max(float(rgw.abs().max()), 1e-30)}
                    log(f'[regimes] {tag}: {n} nodes, {coo.shape[1]} edges '
                        f'({RA_PAD} padded), F={f}; relative errors '
                        + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
                        + f' (limits 1e-5, 1e-4, 1e-4); launches {want}')
                    check(errs['out'] <= 1e-5, f'{tag}: output off by '
                                               f'{errs["out"]}')
                    check(errs['grad_x'] <= 1e-4 and errs['grad_w'] <= 1e-4,
                          f'{tag}: gradients off by {errs}')
                    for k in worst:
                        worst[k] = max(worst[k], errs[k])
                    res[tag] = dict(errs, launches=want)
            # no arm runs on the card without the kernels
            be_old = backend.use_kernel_spmm
            backend.use_kernel_spmm = False
            try:
                try:
                    spmm(ei, x0, w0)
                except RuntimeError as err:
                    check('use_kernel_spmm' in str(err), f'{arm}: {err}')
                else:
                    check(False, f'{arm}: ran with use_kernel_spmm = False')
            finally:
                backend.use_kernel_spmm = be_old
        if arm == 'windowed':
            res['windows'], win, win_ip = windows, ei.win, ei.csc.indptr
        elif arm == 'chunked':
            res['chunks'] = chunks
        del ei
    log(f'[regimes] each arm raised with backend.use_kernel_spmm = False')
    # the dot kernel as grad_w: the windowed arm's per-slot call (slot
    # order, the destinations in runs) and the chunked arm's per-chunk call
    # (edge order), at the checks' shapes
    n = RA_NODES
    coo_np, _, x_np = arm_graph(n, RA_EDGES, f, seed)
    x = torch.as_tensor(x_np, device='cuda')
    g = torch.randn_like(x)
    e_all = coo_np.shape[1]
    lay = SimpleNamespace(indptr=win_ip, src=win.src.reshape(-1),
                          dst=win.dst.reshape(-1))
    coo = torch.as_tensor(coo_np, device='cuda')
    rows = []
    for label, ia, ib, runs in (
            ('windowed grad_w, slot order', lay.src, lay.dst, True),
            ('chunked grad_w, one chunk, edge order',
             coo[0, :RA_CHUNK], coo[1, :RA_CHUNK], None)):
        e = ia.shape[0]
        fns = {'ms': lambda: edge_dot(x, g, ia, ib, runs=runs),
               'plain_ms': lambda: edge_dot_plain(x, g, ia, ib)}
        out = fns['ms']()
        ref = fns['plain_ms']()
        err = float((out - ref).abs().max())
        check(err <= 1e-5 * max(1.0, float(ref.abs().max())),
              f'dot kernel {label}: {err} off the plain version')
        if runs:
            fns['library_ms'] = sampled_addmm_call(
                torch, lay, x.view(n, 1, f), g.view(n, 1, f), n, n,
                int(win_ip[-1]))
        row = timed_row(torch, fns, {'shape': label, 'edges': e,
                                     'H': 1, 'F': f, 'max_abs_err': err,
                                     'runs_arm': bool(runs)},
                        dot_bytes(n, n, e, 1, f, 4, 8), 2.0 * e * f)
        row.setdefault('library_ms', None)
        if row['library_ms'] is None:
            row['library_note'] = ('sampled_addmm takes a CSR, so it '
                                   'timed at the slot order only')
        log(f"[timing] edge_dot {label}: {e} slots, F={f}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        rows.append(row)
    del win, win_ip, lay
    torch.cuda.empty_cache()
    return {'cases': res, 'worst': worst, 'edges': e_all}, rows


def products_infer_net(torch, device, seed):
    """Path R's model, ``products_bench.py --infer``'s (``run_infer``,
    ``:68-150``): per layer ``spmm(mean)`` plus two Linear layers (``l`` on
    the aggregate, ``r`` on the input), F = 100 -> ReLU -> 64 -> 47; random
    weights from ``seed``, named as the flax ``Net``'s (``Layer_0``,
    ``Layer_1``). A bf16 ``x`` reaches layer 1's SpMM as bf16 and the
    Linear layers promote it to float32, as flax's ``Dense`` does."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.ops import spmm
    gen = torch.Generator().manual_seed(seed)

    class Layer(torch.nn.Module):
        def __init__(self, fin, fout):
            super().__init__()
            self.l = linear(fin, fout, generator=gen)
            self.r = linear(fin, fout, generator=gen)

        def forward(self, x, ei):
            return self.l(spmm(ei, x, reduce='mean')) + self.r(x)

    class InferNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Layer_0 = Layer(PR_F, PR_HIDDEN)
            self.Layer_1 = Layer(PR_HIDDEN, PR_CLASSES)

        def forward(self, x, ei):
            return self.Layer_1(torch.relu(self.Layer_0(x, ei)), ei)

    return InferNet().to(resolve_device(device))


def giant_graph_net(torch, device, seed):
    """Path S's model, ``examples/giant_graph.py``'s (``:57-63``):
    ``SAGEConv(32)`` over an EdgeIndex -> ReLU -> ``GATConv(8, heads=4)``
    over the raw COO (its default self loops; the flash kernels past the
    cap) -> ReLU -> Linear 7; random weights from ``seed``, named as the
    flax ``Net``'s (``SAGEConv_0``, ``GATConv_0``, ``Dense_0``). The graph
    argument is a ``Held`` of the EdgeIndex (``'ei'``) and the COO
    (``'coo'``)."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn.conv import GATConv, SAGEConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    class GiantNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.SAGEConv_0 = SAGEConv(PS_F, PS_HIDDEN, device=dev,
                                       generator=gen)
            self.GATConv_0 = GATConv(PS_HIDDEN, PS_HIDDEN // PS_HEADS,
                                     heads=PS_HEADS, device=dev,
                                     generator=gen)
            self.Dense_0 = linear(PS_HIDDEN, PS_CLASSES, generator=gen).to(
                dev)

        def forward(self, x, graph):
            x = torch.relu(self.SAGEConv_0(x, graph['ei']))
            x = torch.relu(self.GATConv_0(x, graph['coo']))
            return self.Dense_0(x)

    return GiantNet()


def cache_report(torch, tag, ei, build_s, mem0):
    """What ``fill_cache`` built and kept: its time, the card memory it
    holds, and which bytes the windowed layouts share with the CSC and CSR
    (their ``src`` and ``perm``) and which they add (``dst``, ``inv_pos``,
    the pads)."""
    kept = (torch.cuda.memory_allocated() - mem0) / 1e9
    info = {'build_s': build_s, 'cache_gb_on_card': kept}
    if ei.win is not None:
        shared = sum(t.numel() * t.element_size() for o in (ei.csc, ei.csr)
                     for t in (o.indices, o.perm))
        added = sum(w.dst.numel() * w.dst.element_size()
                    + w.inv_pos.numel() * w.inv_pos.element_size()
                    + (w.src.numel() - ei.num_edges) * 12
                    for w in (ei.win, ei.win_t))
        check(ei.csc.indices.data_ptr() == ei.win.src.data_ptr()
              and ei.csr.perm.data_ptr() == ei.win_t.perm.data_ptr(),
              f'{tag}: the CSC and CSR are not views of the windowed layouts')
        info.update(windows=int(ei.win.src.shape[0]),
                    window_edges=int(ei.win.src.shape[1]),
                    shared_with_csc_csr_gb=shared / 1e9,
                    added_by_windowed_gb=added / 1e9)
    log(f'[{tag}] fill_cache built in {build_s:.3f} s, {kept:.3f} GB kept '
        f'on the card' + (
            f"; the windowed layouts ({info['windows']} windows of "
            f"{info['window_edges']} edges) share "
            f"{info['shared_with_csc_csr_gb']:.3f} GB with the CSC and CSR "
            f"(views) and add {info['added_by_windowed_gb']:.3f} GB"
            if ei.win is not None else ''))
    return info


def long_rows_close(torch, indptr, src, x, out):
    """Kernel 1's output over rows of any length against the float64 sum of
    the same terms: ``(max abs err, ok)`` within ``1e-5 + 2 * sqrt(n) *
    2**-24 * sum|x|`` for a row of ``n`` edges (PERF.md section 2: a
    float32 sum's rounding errors add as a random walk, about ``sqrt(n)``
    roundings of the running sum, which ``sum|x|`` bounds; the products
    graph's hub rows hold ~370,000 edges, and a row missing 1 % of them
    fails, ``kernel1_row``), one bf16 ulp more for a bf16 output."""
    from pytorch_geometric_tpu_torch.ops.segment import ptr2index
    e, n_dst = int(indptr[-1]), indptr.shape[0] - 1
    dst = ptr2index(indptr.long(), e)
    terms = x.double()[src[:e].long()]
    ref = terms.new_zeros((n_dst, x.shape[1])).index_add_(0, dst, terms)
    scale = terms.new_zeros((n_dst, x.shape[1])).index_add_(0, dst,
                                                             terms.abs_())
    del terms
    n = torch.diff(indptr).double()[:, None]
    lim = 1e-5 + 2 * n.sqrt() * 2.0 ** -24 * scale
    if out.dtype == torch.bfloat16:
        _, ex = torch.frexp(ref)
        lim = lim + torch.ldexp(torch.ones_like(ref), ex - 8)
    err = (out.double() - ref).abs()
    return (float(err.max()) if err.numel() else 0.0), bool(
        (err <= lim).all())


def hub_row_drop_fails(torch, label, indptr, src, x):
    """The bound of :func:`long_rows_close` is tight enough to see a lost
    edge: kernel 1 over the longest row with every hundredth of its edges
    dropped (1 %) must fail it against the whole row. Returns the row's
    length and the dropped sum's error."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm
    deg = torch.diff(indptr.long())
    r = int(deg.argmax())
    lo, m = int(indptr[r]), int(deg[r])
    row = src[lo:lo + m]
    keep = torch.ones(m, dtype=torch.bool, device=row.device)
    keep[::100] = False
    kept = row[keep].contiguous()
    dropped = segment_spmm(torch.tensor([0, kept.shape[0]], dtype=torch.int32,
                                        device=row.device), kept, None, x)
    err, ok = long_rows_close(
        torch, torch.tensor([0, m], dtype=torch.int32, device=row.device),
        row, x, dropped)
    verdict = 'passes: the bound is too loose' if ok else 'fails, as it must'
    log(f'[timing] segment_spmm {label}: the longest row ({m} edges) with '
        f'{m - kept.shape[0]} of its edges dropped is {err:.3e} off the '
        f'float64 sum and {verdict}')
    check(not ok, f'kernel 1 {label}: a row missing 1 % of its {m} edges '
                  f'passes the row-length bound')
    return m, err


def kernel1_row(torch, label, indptr, src, x, pieces=16):
    """Kernel 1 timed at a full-graph shape, where its plain version's
    ``[E, F]`` gather does not fit beside the graph: the kernel's device
    time and CUDA-event wall; its output held, over ``pieces`` ranges of
    destination rows, to the float64 sum (``long_rows_close``, whose bound
    must fail the longest row with 1 % of its edges dropped); the plain
    version run over the same ranges, its time the sum over them (CUDA
    events, one pass); ``torch.sparse.mm`` on a CSR tensor; the bound from
    the bytes (x rows read once) and the gathered rate."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import (
        segment_plan, segment_spmm, segment_spmm_plain)
    n_dst, (n_src, f) = indptr.shape[0] - 1, x.shape
    e, item = int(indptr[-1]), x.element_size()
    x_rows = int(torch.unique(src[:e]).numel())
    row = {'shape': label, 'F': f, 'dtype': str(x.dtype).split('.')[-1],
           'n_src': n_src, 'x_rows_read': x_rows, 'n_dst': n_dst,
           'edges': e, 'weighted': False,
           'plan': list(segment_plan(f, item, n_dst, src.shape[0],
                                     x.data_ptr(), 0)),
           'library_call': 'torch.sparse.mm (CSR)',
           'bytes': spmm_bytes(x_rows, n_dst, e, f, False, item),
           'gathered_bytes': e * f * item}
    row['bound_ms'], row['bound_by'] = bound_ms(x_rows, n_dst, e, f, False,
                                                item)
    fns = {'ms': lambda: segment_spmm(indptr, src, None, x)}
    fn_lib, lib_out = sparse_library_call(
        torch, indptr, src[:e], torch.ones(e, dtype=x.dtype,
                                           device=x.device), n_dst, n_src, x)
    out = fns['ms']()
    cuts = [n_dst * k // pieces for k in range(pieces + 1)]
    ip = indptr.long()
    parts = [(r0, r1, (ip[r0:r1 + 1] - ip[r0]).to(torch.int32),
              src[int(ip[r0]):int(ip[r1])]) for r0, r1 in zip(cuts, cuts[1:])]
    worst = 0.0
    for r0, r1, pip, ps in parts:
        err, ok = long_rows_close(torch, pip, ps, x, out[r0:r1])
        check(ok, f'kernel 1 {label}: rows {r0}-{r1} off the float64 sum by '
                  f'{err}')
        worst = max(worst, err)
    row['max_abs_err'] = worst
    row['longest_row'], row['longest_row_one_percent_dropped_err'] = \
        hub_row_drop_fails(torch, label, indptr, src, x)
    if fn_lib is None:
        row['library_ms'], row['library_error'] = None, lib_out
    else:
        d = float((lib_out.float() - out.float()).abs().max())
        lim = (1e-2 if item == 2 else 1e-4) * max(
            1.0, float(out.float().abs().max()))
        if d <= lim:
            fns['library_ms'] = fn_lib
        else:
            # not the same function: a bf16 CSR product that rounds its sums
            # of hundreds of thousands of terms in bf16
            check(item == 2, f'torch.sparse.mm disagrees with kernel 1 by '
                             f'{d} ({label})')
            row['library_ms'] = None
            row['library_error'] = (f'torch.sparse.mm on the bf16 CSR is {d} '
                                    f'off the kernel (limit {lim:.3g})')
    del out, lib_out
    timed_fns(torch, row, fns, reps=5, warmup=1, calls=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _, _, pip, ps in parts:
        segment_spmm_plain(pip, ps, None, x)
    end.record()
    torch.cuda.synchronize()
    row['plain_ms'] = start.elapsed_time(end)
    row['plain_note'] = f'over {pieces} row ranges, CUDA events'
    row['share'] = row['bound_ms'] / row['ms']
    row['gathered_tb_per_s'] = row['gathered_bytes'] / (row['ms'] * 1e-3) \
        / 1e12
    log(f"[timing] segment_spmm {label}: plan {tuple(row['plan'])}; kernel "
        f"{row['ms']:.4f} ms (event {row['event_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f} ms ({pieces} row ranges), torch.sparse.mm "
        f"{row.get('library_ms')} ms; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), share {100 * row['share']:.1f}%; gathered "
        f"{row['gathered_bytes'] / 1e9:.2f} GB at "
        f"{row['gathered_tb_per_s']:.3f} TB/s; max abs err against the "
        f"float64 sum {worst:.3e}")
    torch.cuda.empty_cache()
    return row


def phase_path_r(torch, seed, coo, iters, warmup):
    """Path R, ``products_bench.py --infer`` (``:68-150``) at full scale:
    the products graph cached by ``fill_cache(auto=True)`` on the card (its
    time, its memory, the regime ``spmm_regime`` reports at the hidden
    width, which must be ``PR_REGIME``), ``products_infer_net`` over X
    [2,449,029, 100] made on the card from ``seed``, in float32 and with
    bf16 X (kernel 1's bf16 arm at layer 1), each served eagerly and
    captured (``compat.compile``), ``iters`` forwards after ``warmup``: ms
    per forward, edges/s as the bench counts them (2 E / t), launches per
    forward (kernel 1 once a layer), a whole-window profile and its idle
    share, the peak memory. The windowed layouts built on the same graph
    (``fill_cache(windowed=True)``: their time and the memory they share
    with the CSC and CSR and add) give a ``'windowed'`` forward equal to
    the ``'kernel'`` regime's bit for bit (the same sums over the same
    arrays), and at 0.01 scale the card's forward is held against the
    CPU's. Kernel 1 is timed at each layer's shape
    (``kernel1_row``). Also the regime auto picks on path A's clustered
    graph."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    tag = 'path R'
    n, e = N_PRODUCTS, coo.shape[1]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ei = EdgeIndex(coo, (n, n)).fill_cache(auto=True)
    torch.cuda.synchronize()
    res = {'cache': cache_report(torch, tag, ei, time.perf_counter() - t0,
                                 mem0)}
    regime = spmm_regime(ei, num_feats=PR_HIDDEN)
    res['regime'] = regime
    log(f'[{tag}] fill_cache(auto=True) of {n} nodes, {e} edges: '
        f'spmm_regime {regime!r}')
    check(regime == PR_REGIME, f'{tag}: auto picked {regime!r}, expected '
                               f'{PR_REGIME!r}')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((n, PR_F), generator=gen, device='cuda')
    model = products_infer_net(torch, None, seed)
    for dt, xx, per_fwd in (
            ('float32', x, {'segment_spmm': 2}),
            ('bf16 x', x.to(torch.bfloat16),
             {'segment_spmm_bf16': 1, 'segment_spmm': 1})):
        sub = f'{tag} {dt}'

        def fwd():
            return model(xx, ei)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with torch.inference_mode():
            ms, enq, _, out = timed_calls(torch, fwd, iters, warmup)
            rows, prof_ms, n_prof = profile_forwards(torch, fwd,
                                                     replay_expect(per_fwd))
        n_fwd = warmup + iters + n_prof
        counts = launch_counts()
        check_counts(sub, counts, {k: v * n_fwd for k, v in per_fwd.items()},
                     f'{n_fwd} forwards')
        check(tuple(out.shape) == (n, PR_CLASSES)
              and bool(torch.isfinite(out).all()),
              f'{sub}: output {tuple(out.shape)}, finite '
              f'{bool(torch.isfinite(out).all())}')
        busy = sum(t for _, t, _ in rows)
        peak = torch.cuda.max_memory_allocated() / 1e9
        r = {'ms_per_forward': ms, 'host_enqueue_ms_per_forward': enq,
             'edges_per_s': 2 * e / (ms / 1e3), 'forwards': n_fwd,
             'launch_counts': counts,
             'launches_per_forward': {k: counts[k] / n_fwd for k in per_fwd},
             'device_busy_ms_per_forward': busy,
             'profiled_ms_per_forward': prof_ms,
             'device_idle_share': 1 - busy / prof_ms,
             'kernel1_ms_per_forward': sum(t for name, t, _ in rows
                                           if SEG_MAIN in name),
             'peak_memory_gb': peak,
             'kernels_per_forward': [[k[:80], t, c] for k, t, c in rows[:8]]}
        log(f'[{sub}] {ms:.4f} ms per forward (CUDA events, {iters} after '
            f'{warmup}), {r["edges_per_s"]:.4e} edges/s (2 E / t), the host '
            f'issues one in {enq:.4f} ms; device busy {busy:.4f} of a '
            f'{prof_ms:.4f} ms wall, idle share {r["device_idle_share"]:.4f};'
            f' kernel 1 {r["kernel1_ms_per_forward"]:.4f} ms a forward; peak '
            f'{peak:.3f} GB')
        for name, t, c in rows[:6]:
            log(f'[{sub}]   {t:.4f} ms  x{c:g}  {name[:90]}')
        cap, cap_out = captured_serving(torch, f'{sub} captured',
                                        lambda v: model(v, ei), xx, out,
                                        iters, warmup, per_fwd)
        lim = 1e-5 * max(1.0, float(out.abs().max()))
        check(cap['max_abs_diff_vs_eager'] <= lim,
              f'{sub}: captured forward {cap["max_abs_diff_vs_eager"]} off '
              'the eager one')
        r['captured'] = cap
        res[dt] = r
        del cap_out
    # the windowed regime, asked for, is the kernel regime over the CSC
    # views of its layouts
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    win_ei = ei.fill_cache(blocked=False, windowed=True)
    torch.cuda.synchronize()
    res['windowed_cache'] = cache_report(
        torch, f'{tag} windowed', win_ei, time.perf_counter() - t0, mem1)
    with torch.inference_mode():
        check(spmm_regime(win_ei, PR_HIDDEN) == 'windowed',
              f'{tag}: the windowed layouts did not take the windowed regime')
        a, b = model(x, win_ei), model(x, ei)
        res['equals_kernel_regime_bitwise'] = bool(torch.equal(a, b))
    log(f'[{tag}] the windowed forward equals the {regime!r} regime\'s bit '
        f'for bit: {res["equals_kernel_regime_bitwise"]}')
    check(res['equals_kernel_regime_bitwise'],
          f'{tag}: the windowed forward differs from the kernel regime\'s')
    del win_ei
    # kernel 1 at each layer's shape, over the arrays the regime reads
    csc = ei.csc
    with torch.inference_mode():
        h = torch.relu(model.Layer_0(x, ei)).contiguous()
        rows = [kernel1_row(torch, f'R layer 1, F={PR_F}', csc.indptr,
                            csc.indices, x),
                kernel1_row(torch, f'R layer 2, F={PR_HIDDEN}', csc.indptr,
                            csc.indices, h),
                kernel1_row(torch, f'R layer 1, bf16 x, F={PR_F}',
                            csc.indptr, csc.indices, x.to(torch.bfloat16))]
    del h, model, x, ei, a, b, csc
    torch.cuda.empty_cache()
    # at 0.01 scale against the CPU
    ns, es = int(n * PK_SMALL), int(e * PK_SMALL)
    small = products_graph(ns, es, seed)
    xs = np.random.default_rng(seed).standard_normal(
        (ns, PR_F)).astype(np.float32)
    card_ei = EdgeIndex(small, (ns, ns)).fill_cache(auto=True)
    cpu_ei = EdgeIndex(small, (ns, ns), device='cpu').fill_cache(auto=True)
    check(spmm_regime(card_ei, PR_HIDDEN) == regime
          and spmm_regime(cpu_ei, PR_HIDDEN) in (regime, 'plain'),
          f'{tag} at {PK_SMALL} scale: regimes {spmm_regime(card_ei)!r} / '
          f'{spmm_regime(cpu_ei)!r}')
    model = products_infer_net(torch, None, seed)
    cpu = products_infer_net(torch, 'cpu', seed)
    with torch.inference_mode():
        got = model(torch.as_tensor(xs, device='cuda'), card_ei).cpu()
        ref = cpu(torch.from_numpy(xs), cpu_ei)
    diff = float((got - ref).abs().max())
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    log(f'[{tag}] at {PK_SMALL} scale ({ns} nodes, {es} edges, regime '
        f'{spmm_regime(card_ei)!r} on both): card vs CPU max abs diff '
        f'{diff:.3e} (limit {lim:.3e})')
    check(diff <= lim, f'{tag}: {diff} off the CPU at {PK_SMALL} scale')
    res['small_vs_cpu'] = {'scale': PK_SMALL, 'max_abs_diff': diff}
    # the regime auto picks on path A's clustered graph
    pa_coo, _, _ = path_a_graph(seed)
    t0 = time.perf_counter()
    pa = EdgeIndex(pa_coo, (PA_NODES, PA_NODES)).fill_cache(auto=True)
    torch.cuda.synchronize()
    res['path_a_auto'] = {'regime': spmm_regime(pa, TR_F),
                          'build_s': time.perf_counter() - t0}
    log(f"[{tag}] fill_cache(auto=True) on path A's clustered graph "
        f"({PA_NODES} nodes, {PA_EDGES} edges): regime "
        f"{res['path_a_auto']['regime']!r} in "
        f"{res['path_a_auto']['build_s']:.2f} s")
    del pa, card_ei, model
    torch.cuda.empty_cache()
    log(json.dumps({'metric': 'products_fullgraph_inference',
                    'regime': regime, 'ms': res['float32']['ms_per_forward'],
                    'ms_captured': res['float32']['captured'][
                        'ms_per_forward'],
                    'ms_bf16': res['bf16 x']['ms_per_forward'],
                    'edges_per_s': res['float32']['edges_per_s'],
                    'nodes': n, 'edges': e}))
    return res, rows


def phase_path_s(torch, seed, coo, iters):
    """Path S, ``examples/giant_graph.py``'s model at full products scale:
    the SAGE layer over ``fill_cache(auto=True, block_sparse=False)`` (the
    kernel regime on kernel 1), GATConv over the raw COO (126.2M edges
    with its self loops, the flash kernels), X [2,449,029, 32] and 7-class
    labels made on the card from ``seed``, Adam 1e-2; served and trained
    eager and captured (``flash_serve_train``: 1 step then ``PK_STEPS``
    timed, the captured losses and gradients against the eager ones); then
    the first step's gradients and 3 losses at the example's own toy
    scale and knobs (``PS_TOY_*``) against the CPU (``flash_parity``)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    tag = 'path S'
    n = N_PRODUCTS
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ei = EdgeIndex(coo, (n, n)).fill_cache(auto=True, block_sparse=False)
    torch.cuda.synchronize()
    cache = cache_report(torch, tag, ei, time.perf_counter() - t0, mem0)
    regime = spmm_regime(ei, PS_F, 'mean')
    check(regime == PR_REGIME, f'{tag}: the SAGE layer takes {regime!r}')
    graph = Held(ei=ei, coo=ei.coo)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((n, PS_F), generator=gen, device='cuda')
    y = torch.randint(0, PS_CLASSES, (n,), generator=gen, device='cuda')
    k1 = 'segment_spmm'
    res, state, _ = flash_serve_train(
        torch, tag, giant_graph_net, seed, x, graph, y,
        {k1: 1, 'flash_fwd': 1},
        {k1: 1, 'flash_fwd': 1, 'flash_bwd_dst': 1, 'flash_bwd_src': 1},
        iters, PK_STEPS, PS_LR)
    res.update(cache=cache, regime=regime, nodes=n,
               edges=coo.shape[1] + n)
    with torch.inference_mode():
        row = kernel1_row(torch, f'S SAGE layer, F={PS_F}', ei.csc.indptr,
                          ei.csc.indices, x)
    del ei, graph, x, y
    torch.cuda.empty_cache()
    # the example's own scale and knobs, against the CPU
    with knobs(PS_TOY_ENV):
        rng = np.random.default_rng(0)
        nt, et = PS_TOY_NODES, PS_TOY_EDGES
        tcoo = np.stack([rng.integers(0, nt, et),
                         rng.integers(0, nt, et)]).astype(np.int32)
        xt = rng.standard_normal((nt, PS_F)).astype(np.float32)
        yt = rng.integers(0, PS_CLASSES, nt)
        graphs = {}
        for dev in ('cuda', 'cpu'):
            tei = EdgeIndex(tcoo, (nt, nt), device=dev).fill_cache(
                auto=True, block_sparse=False)
            check(spmm_regime(tei, PS_F, 'mean') == 'windowed',
                  f'{tag} toy on {dev}: {spmm_regime(tei, PS_F, "mean")!r}')
            graphs[dev] = Held(ei=tei, coo=tei.coo)
        model = giant_graph_net(torch, None, seed)
        tstate = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        del model
        res['parity_toy_vs_cpu'] = flash_parity(
            torch, f'{tag} toy ({nt} nodes, {et} edges, the example\'s '
            'knobs)', giant_graph_net, tstate,
            torch.as_tensor(xt, device='cuda'), graphs['cuda'],
            torch.as_tensor(yt, device='cuda'), PS_LR,
            (torch.from_numpy(xt), graphs['cpu'], torch.from_numpy(yt)))
    log(json.dumps({'metric': 'giant_graph_fullgraph_train_step',
                    'ms': res['training']['ms_per_step'],
                    'ms_captured': res['training']['captured'][
                        'ms_per_step'], 'nodes': n,
                    'edges': coo.shape[1], 'regime': regime}))
    return res, row


# -- paths T and U: Cluster-GCN at Reddit's shape, GraphSAINT at Flickr's -------
# Reddit's published shape (PyG's examples/cluster_gcn_reddit.py): 232,965
# nodes, 114,615,892 directed edges (57,307,946 pairs stored both ways), 602
# features, 41 classes, 153,431 training nodes. The graph is generated: the
# nodes fall into communities of about REDDIT_COMMUNITY nodes, and a share
# REDDIT_INSIDE of the pairs stays inside one
REDDIT_NODES, REDDIT_PAIRS = 232_965, 57_307_946
REDDIT_F, REDDIT_C, REDDIT_TRAIN = 602, 41, 153_431
REDDIT_COMMUNITY, REDDIT_INSIDE = 155, 0.8
# the reference's loader and model: 1,500 parts, 20 a batch, SAGE 602 ->
# 128 -> 41 with dropout 0.5, Adam 0.005; 20 eager batches timed
PT_PARTS, PT_BATCH, PT_STEPS = 1500, 20, 20
PT_HIDDEN, PT_DROPOUT, PT_LR = 128, 0.5, 0.005
# the partitioner's balance cap (loader/cluster.py), and the edge cut the
# path must stay under (a random split into 1,500 parts cuts 1 - 1/1500)
PT_BALANCE, PT_MAX_CUT = 1.05, 0.5
# Flickr's published shape (PyG's examples/graph_saint.py): 89,250 nodes,
# 899,756 directed edges (449,878 pairs both ways, uniform), 500 features,
# 7 classes; the reference's sampler and model
FLICKR_NODES, FLICKR_PAIRS = 89_250, 449_878
FLICKR_F, FLICKR_C = 500, 7
PU_BATCH, PU_WALK, PU_STEPS, PU_COVERAGE = 6000, 2, 5, 100
PU_HIDDEN, PU_LR = 256, 0.001


def community_graph(n, pairs, community, inside, rng):
    """A symmetric graph over ``n`` nodes: ``[2, 2 * pairs]`` int32, each
    of ``pairs`` undirected edges stored in both directions, no self loop.
    The nodes fall into ``n // community`` seeded communities; a share
    ``inside`` of the pairs joins a node to another of its community, the
    rest to a uniform other node. Returns the COO and each node's
    community."""
    k = max(n // community, 1)
    comm = rng.integers(0, k, n)
    order = np.argsort(comm, kind='stable')
    size = np.bincount(comm, minlength=k)
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n) - start[comm[order]]
    src = rng.integers(0, n, pairs)
    c = comm[src]
    inner = (rng.random(pairs) < inside) & (size[c] > 1)
    # another member of the community: an offset of 1 .. size - 1 from the
    # source's own place in it
    hop = rng.integers(1, np.maximum(size[c], 2))
    dst = np.where(inner, order[start[c] + (pos[src] + hop) % size[c]],
                   (src + rng.integers(1, max(n, 2), pairs)) % n)
    coo = np.stack([np.concatenate([src, dst]),
                    np.concatenate([dst, src])]).astype(np.int32)
    return coo, comm


def reddit_like(scale=1.0, seed=0):
    """Path T's graph at ``scale`` of Reddit's shape: ``(coo, y,
    train_mask)``, labels one class per community."""
    rng = np.random.default_rng(seed)
    n = max(int(round(REDDIT_NODES * scale)), 2)
    coo, comm = community_graph(n, int(round(REDDIT_PAIRS * scale)),
                                REDDIT_COMMUNITY, REDDIT_INSIDE, rng)
    y = rng.integers(0, REDDIT_C, int(comm.max()) + 1)[comm]
    train = np.zeros(n, bool)
    train[rng.permutation(n)[:int(round(REDDIT_TRAIN * scale))]] = True
    return coo, y, train


def flickr_like(scale=1.0, seed=0):
    """Path U's graph at ``scale`` of Flickr's shape: ``(coo, y)``, uniform
    pairs and labels."""
    rng = np.random.default_rng(seed)
    n = max(int(round(FLICKR_NODES * scale)), 2)
    coo, _ = community_graph(n, int(round(FLICKR_PAIRS * scale)), n, 0.0,
                             rng)
    return coo, rng.integers(0, FLICKR_C, n)


def cluster_gcn_net(torch, device, seed, dropout=PT_DROPOUT):
    """Path T's model: GraphSAGE 602 -> 128 -> 41, ReLU and dropout
    between the layers."""
    from pytorch_geometric_tpu_torch.nn.models import GraphSAGE
    return GraphSAGE(REDDIT_F, PT_HIDDEN, 2, REDDIT_C, dropout=dropout,
                     device=device,
                     generator=torch.Generator().manual_seed(seed))


def saint_net(torch, device, seed):
    """Path U's model (PyG's examples/graph_saint.py): three GraphConvs,
    500 -> 256 -> 256 -> 256 with ``aggr='add'`` and ReLU, the three
    outputs concatenated into a Linear 768 -> 7, log-softmax."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import GraphConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList([
                GraphConv(c, PU_HIDDEN, aggr='add', device=device,
                          generator=g)
                for c in (FLICKR_F, PU_HIDDEN, PU_HIDDEN)])
            self.lin = linear(3 * PU_HIDDEN, FLICKR_C, device=device,
                              generator=g)

        def forward(self, x, ei, w):
            xs = []
            for conv in self.convs:
                x = torch.relu(conv(x, ei, w))
                xs.append(x)
            return torch.log_softmax(self.lin(torch.cat(xs, -1)), -1)

    return Net()


def spied(calls, module, name):
    """``(module, name, fn)`` for ``knobs``: ``module.name`` wrapped so that
    each call appends ``(seconds, result)`` to ``calls[name]``."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.setdefault(name, []).append((time.perf_counter() - t0, out))
        return out
    return module, name, run


def sampled_parity(torch, tag, build, state, batch_cpu, batch_card, loss_of,
                   lr, batch64=None, own_tol=None):
    """``PARITY_STEPS`` Adam steps from ``state`` on one batch, on the card
    and on the CPU: the losses within 1e-4 relative, the first step's
    gradients within 1e-4 of each tensor's largest (``check_parity``; with
    ``own_tol``, within 1e-4 of the largest of all and ``own_tol`` of their
    own). With ``batch64`` (the batch in float64 over its raw COO, the
    gather path), the first step's gradients are also taken in float64 on
    the CPU: each of the card's must lie within 1e-4 of its own largest
    from them, and the CPU's gap to them is logged beside."""
    def run(device, batch, dtype=torch.float32, steps=PARITY_STEPS):
        model = build(device).to(dtype)
        model.load_state_dict({k: v.to(device) for k, v in state.items()})
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses, grads = [], None
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model, *batch)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if i == 0:
                grads = {k: g.cpu() for k, g in grads_of(torch,
                                                         model).items()}
        return losses, grads
    card, cpu = run('cuda', batch_card), run('cpu', batch_cpu)
    gaps64 = None
    if batch64 is not None:
        _, g64 = run('cpu', batch64, torch.float64, steps=1)
        gaps64 = {k: [float((g[k].double() - ref).abs().max())
                      / max(float(ref.abs().max()), 1e-300)
                      for g in (card[1], cpu[1])] for k, ref in g64.items()}
        log(f'[{tag}] first-step gradients against float64 on the CPU (the '
            'gather path), of each tensor\'s largest, card / CPU: '
            + ', '.join(f'{k} {a:.3e} / {b:.3e}' for k, (a, b) in sorted(
                gaps64.items(), key=lambda kv: -kv[1][1])))
        for k, (gap, _) in gaps64.items():
            check(gap <= 1e-4, f'{tag}: first-step gradient of {k} is '
                               f'{gap} of its largest from float64')
    out = check_parity(torch, tag, card, cpu, grads_too=True,
                       own_tol=own_tol)
    if gaps64 is not None:
        out['grad_gaps_to_float64_card_cpu'] = gaps64
    return out


def kernel1_rows(torch, tag, ei, cases, seed):
    """Kernel 1 at a batch's shapes: for each ``(label, layout, w, x)``
    (``x`` an int: that many random columns) its launch against the plain
    version (``segment_close``) and its timing row (``segment_timed``);
    ``(rows, worst error)``."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm
    gen = torch.Generator(device='cuda').manual_seed(seed)
    rows, worst = [], 0.0
    for label, lay, w, x in cases:
        if isinstance(x, int):
            # x for a forward over the CSC, g for A^T g over the CSR
            rows_in = (ei.num_src_nodes if lay is ei.csc
                       else ei.num_dst_nodes)
            x = torch.randn((rows_in, x), generator=gen, device='cuda')
        with torch.inference_mode():
            out = segment_spmm(lay.indptr, lay.indices, w, x)
            err, ok = segment_close(torch, lay.indptr, lay.indices, w, x,
                                    out)
            torch.cuda.synchronize()
            check(ok, f'segment_spmm {tag} {label}: {err} from the plain '
                      'version')
            worst = max(worst, err)
            row = segment_timed(torch, f'{tag} {label}', lay.indptr,
                                lay.indices, w, x)
        row['max_abs_err'] = err
        rows.append(row)
    return rows, worst


def timed_batches(torch, it, prepare, step, steps):
    """``steps`` eager steps over the batches of ``it``: host ms to take a
    batch and put it on the card (``prepare``), card ms a step (CUDA
    events), the losses, the first prepared batch, and the launches of
    the first step."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_ms, card_ms, losses, first, per_step = [], [], [], None, None
    torch.cuda.synchronize()
    reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = prepare(next(it))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        start.record()
        losses.append(step(*batch))
        end.record()
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end))
        if i == 0:
            first = batch
            per_step = {k: v for k, v in launch_counts().items() if v}
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f'losses {losses}')
    return host_ms, card_ms, losses, first, per_step


def phase_path_t(torch, seed):
    """Path T: Cluster-GCN at Reddit's shape (PyG's
    examples/cluster_gcn_reddit.py). ``reddit_like(1.0)`` on the host, x
    (602 standard-normal features), labels and the training mask on the
    card; ``ClusterData(num_parts=1500)`` on the native partitioner (the
    phase fails without it), its symmetric CSR and partition timed; every
    node in one part, parts within the balance cap, the edge cut under
    ``PT_MAX_CUT``; ``ClusterLoader(batch_size=20, shuffle=True)``, each
    batch's rows gathered on the card by ``n_id`` and its ``EdgeIndex``
    built there; ``cluster_gcn_net`` trained with cross-entropy on the
    batch's training nodes, Adam 0.005, ``PT_STEPS`` eager steps: host ms
    a batch, card ms a step, kernel 1's launches (3 a step: forward at F =
    602 and 128, ``A^T g`` at 128), a whole-window profile and the idle
    share; the first batch's 3 steps (dropout 0) against the CPU; kernel 1
    at the first batch's three shapes against its plain version and
    timed."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import (ClusterData,
                                                    ClusterLoader, cluster)
    tag = 'path T'
    t0 = time.perf_counter()
    coo, y, train = reddit_like(1.0, seed)
    n = len(y)
    gen_s = time.perf_counter() - t0
    gen = torch.Generator(device='cuda').manual_seed(seed + 40)
    data = Data(x=torch.randn((n, REDDIT_F), generator=gen, device='cuda'),
                edge_index=coo,
                y=torch.as_tensor(y, device='cuda'),
                train_mask=torch.as_tensor(train, device='cuda'),
                num_nodes=n)
    del coo
    calls = {}
    t0 = time.perf_counter()
    with knobs(env={'PGT_DISABLE_NATIVE_PARTITION': ''}, attrs=[
            spied(calls, cluster, '_sym_csr'),
            spied(calls, cluster, '_native_multilevel')]):
        cd = ClusterData(data, PT_PARTS, seed=seed)
    build_s = time.perf_counter() - t0
    (csr_s, _), = calls['_sym_csr']
    (part_s, native), = calls['_native_multilevel']
    check(native is not None, f'{tag}: the native partitioner did not run')
    parts = cd.partition.parts
    sizes = np.bincount(parts, minlength=PT_PARTS)
    cap = PT_BALANCE * n / PT_PARTS
    cut = cluster.edge_cut(data.edge_index, parts)
    check(len(parts) == n and parts.min() >= 0 and parts.max() < PT_PARTS
          and int(sizes.sum()) == n
          and np.array_equal(np.sort(cd.partition.node_perm), np.arange(n)),
          f'{tag}: not every node lies in exactly one part')
    check(sizes.max() <= cap, f'{tag}: the largest part holds {sizes.max()} '
                              f'nodes, over the cap {cap:.1f}')
    check(cut < PT_MAX_CUT, f'{tag}: edge cut {cut} (limit {PT_MAX_CUT})')
    log(f'[{tag}] reddit_like: {n} nodes, {data.num_edges} edges, built on '
        f'the host in {gen_s:.1f} s; ClusterData({PT_PARTS} parts) in '
        f'{build_s:.2f} s: symmetric CSR {csr_s:.2f} s, native multilevel '
        f'partition {part_s:.2f} s; parts of {sizes.min()}-{sizes.max()} '
        f'nodes (cap {cap:.1f}), edge cut {cut:.4f}')
    loader = ClusterLoader(cd, batch_size=PT_BATCH, shuffle=True, seed=0)

    def prepare(batch):
        nb = batch.num_nodes
        ei = EdgeIndex(batch.edge_index.to('cuda'), (nb, nb)).fill_cache(
            blocked=False)
        return ei, batch.x, batch.y.long(), batch.train_mask

    def loss_of(model, ei, x, y, mask):
        ce = torch.nn.functional.cross_entropy(model(x, ei), y,
                                               reduction='none')
        m = mask.to(ce.dtype)
        return (ce * m).sum() / m.sum()

    model = cluster_gcn_net(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PT_LR)

    def step(*batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PT_STEPS)
    counts = launch_counts()
    check(per_step == {'segment_spmm': 3},
          f'{tag}: launches in the first step {per_step}')
    check_counts(tag, counts, {'segment_spmm': 3 * PT_STEPS},
                 f'{PT_STEPS} steps')
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 3)
    busy = sum(t for _, t, _ in prof_rows)
    ei = first[0]
    res = {'nodes': n, 'edges': data.num_edges, 'graph_build_s': gen_s,
           'cluster_data_s': build_s, 'sym_csr_s': csr_s,
           'partition_s': part_s, 'part_sizes': [int(sizes.min()),
                                                 int(sizes.max())],
           'balance_cap': cap, 'edge_cut': cut, 'steps': PT_STEPS,
           'losses': losses, 'host_ms_per_batch': host_ms,
           'card_ms_per_step': card_ms, 'launch_counts': counts,
           'launches_per_step': per_step,
           'first_batch': {'nodes': ei.num_src_nodes,
                           'edges': ei.num_edges},
           'device_busy_ms_per_step': busy, 'profiled_ms_per_step': prof_ms,
           'kernel1_ms_per_step': sum(t for name, t, _ in prof_rows
                                      if SEG_MAIN in name),
           'kernels_per_step': [[name[:80], t, c]
                                for name, t, c in prof_rows[:8]]}
    res['device_idle_share_unprofiled'] = 1 - busy / float(
        np.median(card_ms[1:]))
    log(f'[{tag}] ClusterLoader({PT_BATCH} parts a batch): per batch the '
        f'host takes {np.median(host_ms):.2f} ms (median of {PT_STEPS}; '
        f'{host_ms}), the card runs a step in {np.median(card_ms[1:]):.4f} '
        f'ms (CUDA events; {card_ms}), busy {busy:.4f} ms (torch.profiler), '
        f"idle {res['device_idle_share_unprofiled']:.3f}, kernel 1 "
        f"{res['kernel1_ms_per_step']:.4f} ms, 3 launches a step; first "
        f'batch {ei.num_src_nodes} nodes, {ei.num_edges} edges; losses '
        f'{losses}')
    for name, t, c in prof_rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {name[:90]}')
    # the first batch: 3 steps without dropout against the CPU
    cpu_ei = EdgeIndex(ei.coo.cpu(), ei.sparse_size,
                       device='cpu').fill_cache(blocked=False)
    res['first_batch_vs_cpu'] = sampled_parity(
        torch, tag, lambda d: cluster_gcn_net(torch, d, seed, dropout=0.0),
        state, (cpu_ei, *(t.cpu() for t in first[1:])), first, loss_of,
        PT_LR)
    # kernel 1 at the first batch's shapes
    rows, worst = kernel1_rows(torch, 'T', ei, [
        (f'forward F={REDDIT_F}', ei.csc, None, first[1]),
        (f'forward F={PT_HIDDEN}', ei.csc, None, PT_HIDDEN),
        (f'A^T g F={PT_HIDDEN}', ei.csr, None, PT_HIDDEN)], seed + 41)
    del data, cd, loader, model, opt, first
    torch.cuda.empty_cache()
    return res, rows, worst


def phase_path_u(torch, seed):
    """Path U: GraphSAINT at Flickr's shape (PyG's examples/graph_saint.py).
    ``flickr_like(1.0)``, x (500 standard-normal features) and labels on
    the card; ``GraphSAINTRandomWalkSampler(batch_size=6000,
    walk_length=2, num_steps=5, sample_coverage=100)`` on the native random
    walk (the phase fails without it), ``_estimate_norms`` timed;
    ``saint_net`` over each batch's ``EdgeIndex`` on the card with the
    reference's edge weights ``edge_norm * 1 / deg[col]`` (in-degree over
    the whole graph) and loss ``(nll * node_norm).sum()``, Adam 0.001, 5
    eager steps: host ms a batch, card ms a step, kernel 1's weighted
    launches (5 a step: forward at F = 500, 256, 256, ``A^T g`` at 256
    twice), a whole-window profile and the idle share; the first batch's 3
    steps against the CPU; kernel 1 at the first batch's three shapes
    against its plain version and timed."""
    from pytorch_geometric_tpu_torch import EdgeIndex, csrc
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import (
        GraphSAINTRandomWalkSampler, GraphSAINTSampler)
    from pytorch_geometric_tpu_torch.nn.models import node2vec
    tag = 'path U'
    check(csrc.WITH_NATIVE_SAMPLER, f'{tag}: the native sampler did not '
          'build (g++)')
    t0 = time.perf_counter()
    coo, y = flickr_like(1.0, seed)
    n = len(y)
    gen_s = time.perf_counter() - t0
    gen = torch.Generator(device='cuda').manual_seed(seed + 50)
    data = Data(x=torch.randn((n, FLICKR_F), generator=gen, device='cuda'),
                edge_index=coo, y=torch.as_tensor(y, device='cuda'),
                num_nodes=n)
    # the reference's edge weights: 1 / in-degree of each edge's target
    deg = np.bincount(coo[1], minlength=n).astype(np.float32)
    inv_deg = torch.as_tensor(1.0 / deg[coo[1]], device='cuda')
    calls = {}
    t0 = time.perf_counter()
    with knobs(attrs=[spied(calls, GraphSAINTSampler, '_estimate_norms'),
                      spied(calls, node2vec, '_random_walk_native')]):
        sampler = GraphSAINTRandomWalkSampler(
            data, batch_size=PU_BATCH, walk_length=PU_WALK,
            num_steps=PU_STEPS, sample_coverage=PU_COVERAGE, seed=seed)
        build_s = time.perf_counter() - t0
        (norm_s, _), = calls['_estimate_norms']
        walks = len(calls['_random_walk_native'])
        check(walks > 0, f'{tag}: the native random walk did not run')

        def prepare(batch):
            nb = batch.num_nodes
            ei = EdgeIndex(batch.edge_index.to('cuda'), (nb, nb)).fill_cache(
                blocked=False)
            w = batch.edge_norm.to('cuda') * inv_deg[
                batch.e_id.to('cuda').long()]
            return (ei, batch.x, w, batch.y.long(),
                    batch.node_norm.to('cuda'))

        def loss_of(model, ei, x, w, y, node_norm):
            nll = torch.nn.functional.nll_loss(model(x, ei, w), y,
                                               reduction='none')
            return (nll * node_norm).sum()

        model = saint_net(torch, None, seed)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        opt = torch.optim.Adam(model.parameters(), lr=PU_LR)

        def step(*batch):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model, *batch)
            loss.backward()
            opt.step()
            return loss.detach()

        host_ms, card_ms, losses, first, per_step = timed_batches(
            torch, iter(sampler), prepare, step, PU_STEPS)
        check(len(calls['_random_walk_native']) == walks + PU_STEPS,
              f'{tag}: the batches were not walked natively')
    counts = launch_counts()
    check(per_step == {'segment_spmm': 5},
          f'{tag}: launches in the first step {per_step}')
    check_counts(tag, counts, {'segment_spmm': 5 * PU_STEPS},
                 f'{PU_STEPS} steps')
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 3)
    busy = sum(t for _, t, _ in prof_rows)
    ei = first[0]
    res = {'nodes': n, 'edges': data.num_edges, 'graph_build_s': gen_s,
           'sampler_build_s': build_s, 'estimate_norms_s': norm_s,
           'norm_walks': walks, 'steps': PU_STEPS, 'losses': losses,
           'host_ms_per_batch': host_ms, 'card_ms_per_step': card_ms,
           'launch_counts': counts, 'launches_per_step': per_step,
           'first_batch': {'nodes': ei.num_src_nodes,
                           'edges': ei.num_edges},
           'device_busy_ms_per_step': busy, 'profiled_ms_per_step': prof_ms,
           'kernel1_ms_per_step': sum(t for name, t, _ in prof_rows
                                      if SEG_MAIN in name),
           'kernels_per_step': [[name[:80], t, c]
                                for name, t, c in prof_rows[:8]]}
    res['device_idle_share_unprofiled'] = 1 - busy / float(
        np.median(card_ms[1:]))
    log(f'[{tag}] flickr_like: {n} nodes, {data.num_edges} edges, built in '
        f'{gen_s:.2f} s; GraphSAINTRandomWalkSampler({PU_BATCH} roots, walk '
        f'length {PU_WALK}, coverage {PU_COVERAGE}) in {build_s:.2f} s, '
        f'_estimate_norms {norm_s:.2f} s over {walks} native walks; per '
        f'batch the host takes {np.median(host_ms):.2f} ms ({host_ms}), the '
        f'card runs a step in {np.median(card_ms[1:]):.4f} ms ({card_ms}), '
        f'busy {busy:.4f} ms, idle '
        f"{res['device_idle_share_unprofiled']:.3f}, kernel 1 "
        f"{res['kernel1_ms_per_step']:.4f} ms, 5 launches a step; first "
        f'batch {ei.num_src_nodes} nodes, {ei.num_edges} edges; losses '
        f'{losses}')
    for name, t, c in prof_rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {name[:90]}')
    cpu_ei = EdgeIndex(ei.coo.cpu(), ei.sparse_size,
                       device='cpu').fill_cache(blocked=False)
    # a node-normalised sum over ~15,700 rows: layers 1-2's weight
    # gradients cancel to 1e-3 of the largest, and the CPU's float32 GEMMs
    # over that many rows land 1e-3 of their own from float64 where the
    # card's land 4e-7 on an H100 (PERF.md, path U): the card is held to
    # float64 at 1e-4 of each gradient's own largest, and to the CPU as
    # paths K-P are (1e-4 of the largest of all, 1e-2 of its own)
    batch64 = (ei.coo.cpu().long(), *(
        t.cpu().double() if t.is_floating_point() else t.cpu()
        for t in first[1:]))
    res['first_batch_vs_cpu'] = sampled_parity(
        torch, tag, lambda d: saint_net(torch, d, seed), state,
        (cpu_ei, *(t.cpu() for t in first[1:])), first, loss_of, PU_LR,
        batch64=batch64, own_tol=FLASH_OWN_TOL)
    w = first[2]
    rows, worst = kernel1_rows(torch, 'U', ei, [
        (f'weighted forward F={FLICKR_F}', ei.csc,
         w[ei.csc.perm].contiguous(), first[1]),
        (f'weighted forward F={PU_HIDDEN}', ei.csc,
         w[ei.csc.perm].contiguous(), PU_HIDDEN),
        (f'weighted A^T g F={PU_HIDDEN}', ei.csr,
         w[ei.csr.perm].contiguous(), PU_HIDDEN)], seed + 51)
    del data, sampler, model, opt, first
    torch.cuda.empty_cache()
    return res, rows, worst


# -- paths V and W: graph-level models at ZINC's and COLLAB's shapes -----------
# ZINC's subset as PyG's examples/pna.py trains on it (the PNA paper's and
# the benchmarking-GNNs suite's setting): 10,000 training graphs of 9-37
# atoms, 23.2 on average, 49.8 directed bond edges a graph on average
# (both directions stored), atom types in [0, 21), bond types in [1, 4),
# one float target a graph. The graphs are generated: a random spanning
# tree plus Poisson ring closures.
ZINC_TRAIN, ZINC_MIN, ZINC_MAX = 10_000, 9, 37
ZINC_MEAN_NODES, ZINC_MEAN_EDGES = 23.2, 49.8
ZINC_ATOMS, ZINC_BONDS = 21, 4
# examples/pna.py's model and protocol: Embedding(21, 75), Embedding(4, 50),
# 4 x PNAConv(75, towers=5, edge_dim=50) each with BatchNorm(75) and ReLU,
# global_add_pool, MLP 75 -> 50 -> 25 -> 1; L1 loss, Adam 1e-3, batch 128
PV_HIDDEN, PV_EDGE_DIM, PV_LAYERS, PV_TOWERS = 75, 50, 4, 5
PV_AGGREGATORS = ('mean', 'min', 'max', 'std')
PV_SCALERS = ('identity', 'amplification', 'attenuation')
PV_MLP = (50, 25, 1)
PV_BATCH, PV_STEPS, PV_EVAL_BATCHES, PV_LR = 128, 10, 4, 1e-3
# COLLAB's shape (TUDataset, as PyG's benchmark/kernel runs GIN-0 on it):
# 5,000 graphs of 32-492 nodes, 74.49 on average, 2,457.78 undirected
# edges on average (stored both ways), one-hot degree features 492 wide
# (the largest degree is 491), 3 classes. Generated: sizes 32 plus an
# exponential tail, each graph a uniform draw of pairs at one density
COLLAB_GRAPHS, COLLAB_MIN, COLLAB_MAX = 5000, 32, 492
COLLAB_MEAN_NODES, COLLAB_MEAN_PAIRS = 74.49, 2457.78
COLLAB_F, COLLAB_C = 492, 3
# GIN-0 (Xu et al., ICLR 2019) at its widths: 5 layers, hidden 64, batch
# norm, the 5 layers' outputs concatenated (320), global_add_pool, Linear
# 320 -> 3, cross-entropy, Adam 0.01, batch 128
PW_HIDDEN, PW_LAYERS, PW_BATCH, PW_STEPS, PW_EVAL_BATCHES, PW_LR = (
    64, 5, 128, 10, 4, 0.01)


def zinc_like(num_graphs=ZINC_TRAIN, seed=0):
    """Path V's graphs: a list of ``(atoms [n] int64, coo [2, E] int32,
    bonds [E] int64, y [1] float32)``, each bond stored both ways with its
    type on both. Sizes are a normal of ZINC's mean and spread clipped to
    its range; the bonds a chain-like spanning tree (atom i bonds to one of
    the few atoms before it) plus Poisson ring closures between atoms of
    fewer than 4 bonds, so the mean comes to ZINC's 49.8 directed edges."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.normal(ZINC_MEAN_NODES, 4.5, num_graphs)),
                    ZINC_MIN, ZINC_MAX).astype(np.int64)
    closures = ZINC_MEAN_EDGES / 2 - (sizes.mean() - 1)
    atom_p = 1.0 / np.arange(1, ZINC_ATOMS + 1) ** 2
    atom_p /= atom_p.sum()
    graphs = []
    for n in sizes:
        i = np.arange(1, n)
        src = list(np.maximum(i - rng.geometric(0.6, n - 1), 0))
        dst = list(i)
        deg = np.bincount(src + dst, minlength=n)
        have = set(zip(src, dst)) | set(zip(dst, src))
        want, tries = rng.poisson(closures), 0
        while want and tries < 50:
            tries += 1
            a, b = (int(v) for v in rng.integers(0, n, 2))
            if a != b and (a, b) not in have and max(deg[a], deg[b]) < 4:
                have |= {(a, b), (b, a)}
                deg[[a, b]] += 1
                src.append(a)
                dst.append(b)
                want -= 1
        src, dst = np.asarray(src), np.asarray(dst)
        bonds = rng.choice(np.arange(1, ZINC_BONDS), len(src),
                           p=[0.6, 0.3, 0.1])
        graphs.append((
            rng.choice(ZINC_ATOMS, n, p=atom_p).astype(np.int64),
            np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])]).astype(np.int32),
            np.concatenate([bonds, bonds]).astype(np.int64),
            rng.standard_normal(1).astype(np.float32)))
    return graphs


def pna_degree_stats(graphs):
    """PNA's degree statistics of a training set, as PyG's
    ``PNAConv.get_degree_histogram`` and ``DegreeScalerAggregation`` take
    them: the histogram of in-degrees over every node, then ``avg_deg_lin``
    = E[deg] and ``avg_deg_log`` = E[log(deg + 1)] under it. Returns
    ``(histogram, avg_deg_log, avg_deg_lin)``."""
    hist = np.zeros(1, np.int64)
    for atoms, coo, _, _ in graphs:
        d = np.bincount(coo[1], minlength=len(atoms))
        h = np.bincount(d)
        if len(h) > len(hist):
            hist = np.pad(hist, (0, len(h) - len(hist)))
        hist[:len(h)] += h
    bins = np.arange(len(hist), dtype=np.float64)
    total = float(hist.sum())
    return (hist, float((np.log(bins + 1) * hist).sum() / total),
            float((bins * hist).sum() / total))


def collab_like(seed=0):
    """Path W's dataset plan: each graph's size, undirected pair count and
    label, for ``collab_graph`` to build on demand. Sizes are COLLAB's
    least plus an exponential tail scaled to its mean, clipped to its
    largest; the largest graph is set to COLLAB's largest (492 nodes), which
    ``collab_graph`` gives a hub of degree 491, so that every column of the
    one-hot degree feature can be set."""
    rng = np.random.default_rng(seed)
    tail = rng.exponential(1.0, COLLAB_GRAPHS)
    tail *= (COLLAB_MEAN_NODES - COLLAB_MIN) / tail.mean()
    sizes = np.clip(COLLAB_MIN + np.round(tail), COLLAB_MIN,
                    COLLAB_MAX).astype(np.int64)
    sizes[np.argmax(sizes)] = COLLAB_MAX
    full = sizes * (sizes - 1) // 2
    density = COLLAB_MEAN_PAIRS * COLLAB_GRAPHS / full.sum()
    pairs = np.minimum(np.round(density * full), full).astype(np.int64)
    return sizes, pairs, rng.integers(0, COLLAB_C, COLLAB_GRAPHS)


def collab_graph(i, plan, seed=0):
    """Graph ``i`` of ``collab_like``'s plan: ``(x [n, 492] one-hot degree,
    coo [2, 2 * pairs] int32, y [1])``, its pairs a uniform draw without
    repeats, each stored both ways; a graph of COLLAB's largest size holds
    node 0's pairs with every other node (a hub of degree n - 1) and draws
    the rest."""
    sizes, pairs, labels = plan
    n, m = int(sizes[i]), int(pairs[i])
    rng = np.random.default_rng([seed, i])
    a, b = np.triu_indices(n, 1)    # node 0's pairs come first
    hub = n - 1 if n == COLLAB_MAX else 0
    pick = np.concatenate([np.arange(hub), hub + rng.choice(
        len(a) - hub, m - hub, replace=False)])
    coo = np.stack([np.concatenate([a[pick], b[pick]]),
                    np.concatenate([b[pick], a[pick]])]).astype(np.int32)
    x = np.zeros((n, COLLAB_F), np.float32)
    x[np.arange(n), np.bincount(coo[1], minlength=n)] = 1.0
    return x, coo, labels[i:i + 1]


def pna_zinc_net(torch, device, seed, avg_deg_log, avg_deg_lin,
                 hidden=PV_HIDDEN, edge_dim=PV_EDGE_DIM, layers=PV_LAYERS,
                 towers=PV_TOWERS, mlp=PV_MLP):
    """Path V's model (PyG's examples/pna.py): atom and bond embeddings,
    ``layers`` x (PNAConv, BatchNorm, ReLU), ``global_add_pool``, the MLP;
    called as ``model(atoms, coo, bonds, batch, num_graphs)``, one output a
    graph."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import MLP, BatchNorm, PNAConv
    from pytorch_geometric_tpu_torch.nn.pool import global_add_pool
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    def embedding(num, dim):
        emb = torch.nn.Embedding(num, dim)
        with torch.no_grad():
            emb.weight.copy_(torch.randn((num, dim), generator=g)
                             / math.sqrt(dim))
        return emb.to(device)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.node_emb = embedding(ZINC_ATOMS, hidden)
            self.edge_emb = embedding(ZINC_BONDS, edge_dim)
            self.convs = torch.nn.ModuleList(
                PNAConv(hidden, hidden, PV_AGGREGATORS, PV_SCALERS,
                        avg_deg_log=avg_deg_log, avg_deg_lin=avg_deg_lin,
                        towers=towers, edge_dim=edge_dim, device=device,
                        generator=g) for _ in range(layers))
            self.norms = torch.nn.ModuleList(
                BatchNorm(hidden, device=device) for _ in range(layers))
            self.mlp = MLP(hidden, list(mlp), device=device, generator=g)

        def forward(self, atoms, coo, bonds, batch, num_graphs):
            x = self.node_emb(atoms.long())
            e = self.edge_emb(bonds.long())
            for conv, norm in zip(self.convs, self.norms):
                x = torch.relu(norm(conv(x, coo, e)))
            return self.mlp(global_add_pool(x, batch, num_graphs))[:, 0]

    return Net()


def gin_collab_net(torch, device, seed, in_channels=COLLAB_F,
                   hidden=PW_HIDDEN, layers=PW_LAYERS, classes=COLLAB_C):
    """Path W's model (GIN-0 at the GIN paper's widths): the port's ``GIN``
    with batch norm and the layers' outputs concatenated,
    ``global_add_pool``, a Linear to the classes; called as ``model(x, ei,
    batch, num_graphs)`` with an ``EdgeIndex`` ``ei`` (GIN then aggregates
    on kernel 1)."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.nn.models import GIN
    from pytorch_geometric_tpu_torch.nn.pool import global_add_pool
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gnn = GIN(in_channels, hidden, layers, norm='batch_norm',
                           jk='cat', device=device, generator=g)
            self.lin = linear(hidden * layers, classes, device=device,
                              generator=g)

        def forward(self, x, ei, batch, num_graphs):
            return self.lin(global_add_pool(self.gnn(x, ei), batch,
                                            num_graphs))

    return Net()


def synced_parity(torch, tag, build, state, batch_card, batch_cpu, batch64,
                  loss_of, lr, build64=None, exact=False, opt_of=None):
    """``PARITY_STEPS`` Adam steps from ``state`` on one batch on the card;
    before each, a CPU model takes the card's parameters (its running
    statistics stay its own, updated by its own forwards in training mode)
    and its loss and gradients on the same batch are held to the card's:
    losses within 1e-4 relative, first-step gradients within 1e-4 of the
    largest of all and 1e-2 of their own (``check_parity``'s
    ``own_tol``), or within 1e-4 of the largest of all where the gradient
    vanishes (its largest under 1e-6 of all: the bias of a layer that a
    batch norm follows, whose shift the norm removes; ``check_parity``'s
    ``cancelled``). With ``batch64``, the first step's gradients are also
    taken in float64 on the CPU, which then decides what vanishes: each of
    the card's within 1e-4 of its own largest from them, or within 1e-6 of
    the largest of all where that is more (a tensor whose terms cancel in
    part, as the first Linear's bias in a GIN MLP that a batch norm
    follows: float32 leaves rounding noise of about 1e-7 of the cancelling
    terms, which on an H100 came to 1.4e-4 of such a tensor's own largest
    at path W's first batch). After the steps, every running statistic
    within 1e-4 * max(1, max|CPU|) of the CPU's.

    The CPU model runs at the card's parameters at every step, rather than
    stepping on its own: Adam's first steps move each parameter by about
    ``lr`` whatever the size of its gradient, so the cancelled gradients
    (rounding noise of random sign on each device) would move the two runs
    apart by ``lr`` a step in parameters that a later batch does feel.

    ``build64`` makes the float64 model (``build`` by default; a model
    whose float32 route has no float64 arm, as kernel 1's, takes the
    gather path there). ``exact``: the first-step gradients are held to
    float64 rather than to the CPU's float32 ones: each of the card's
    within 1e-4 of the largest of all from float64, or within twice the
    CPU float32 gradient's own gap to float64 where that is more. For a
    model whose float32 gradients sit near or past 1e-4 of the largest
    from exact on either device (deep batch-normed stacks with ReLUs, sums
    over many nodes that cancel), the card must be as exact as the CPU is,
    and the two float32 errors do not add up against one limit.
    ``opt_of(model)`` makes the card's optimizer (``Adam(lr)`` by
    default)."""
    card = build('cuda')
    card.load_state_dict({k: v.cuda() for k, v in state.items()})
    cpu = build('cpu')
    cpu.load_state_dict(state)
    card.train()
    cpu.train()
    opt = (opt_of(card) if opt_of is not None
           else torch.optim.Adam(card.parameters(), lr=lr))
    l_card, l_cpu = [], []
    for i in range(PARITY_STEPS):
        params = {k: v.detach().cpu() for k, v in card.named_parameters()}
        cpu.load_state_dict(params, strict=False)
        for model, batch, losses in ((card, batch_card, l_card),
                                     (cpu, batch_cpu, l_cpu)):
            model.zero_grad(set_to_none=True)
            loss = loss_of(model, *batch)
            loss.backward()
            losses.append(loss.item())
        if i == 0:
            g_card = {k: g.cpu() for k, g in grads_of(torch, card).items()}
            g_cpu = grads_of(torch, cpu)
        if i == 0 and batch64 is not None:
            m64 = (build64 or build)('cpu').double()
            m64.load_state_dict(state)
            m64.load_state_dict(params, strict=False)
            m64.train()
            loss_of(m64, *batch64).backward()
            g64 = grads_of(torch, m64)
        opt.step()
    ref_g = g_cpu if batch64 is None else g64
    largest = max(float(g.abs().max()) for g in ref_g.values())
    cancelled = sorted(k for k, g in ref_g.items()
                       if float(g.abs().max()) <= 1e-6 * largest)
    worst64 = None
    if exact:
        gaps = {k: [float((g[k].double() - ref).abs().max()) / largest
                    for g in (g_card, g_cpu)] for k, ref in g64.items()}
        log(f'[{tag}] first-step gradients against float64 on the CPU, of '
            'the largest of all, card / CPU float32: ' + ', '.join(
                f'{k} {a:.3e} / {b:.3e}' for k, (a, b) in sorted(
                    gaps.items(), key=lambda kv: -kv[1][0])[:12]))
        for k, (gap, cpu_gap) in gaps.items():
            lim = max(1e-4, 2 * cpu_gap)
            check(gap <= lim, f'{tag}: first-step gradient of {k} is {gap} '
                              f'of the largest from float64 (limit {lim})')
        out = check_parity(torch, tag, (l_card, g_card), (l_cpu, g_cpu),
                           grads_too=False)
        out['grad_gaps_vs_float64_card_cpu'] = {
            'card': max(a for a, _ in gaps.values()),
            'cpu': max(b for _, b in gaps.values())}
        out['cancelled'] = cancelled
        worst_stat = 0.0
    elif batch64 is not None:
        worst64 = 0.0
        for k, ref in g64.items():
            d = float((g_card[k].double() - ref).abs().max())
            lim = max(1e-4 * float(ref.abs().max()), 1e-6 * largest)
            worst64 = max(worst64, d / lim * 1e-4)
            check(d <= lim, f'{tag}: first-step gradient of {k} is {d} '
                            f'from float64 (limit {lim})')
        log(f'[{tag}] first-step gradients against float64 on the CPU: '
            f'worst {worst64:.3e} of each tensor\'s largest (or 1e-2 of '
            'the largest of all)')
    if not exact:
        log(f'[{tag}] {len(cancelled)} cancelled tensors (largest gradient '
            f'under 1e-6 of all): {cancelled}')
        out = check_parity(torch, tag, (l_card, g_card), (l_cpu, g_cpu),
                           grads_too=True, cancelled=cancelled,
                           own_tol=FLASH_OWN_TOL)
        out['grad_worst_vs_float64'] = worst64
        out['cancelled'] = cancelled
    worst_stat = 0.0
    cpu_bufs = dict(cpu.named_buffers())
    for k, buf in card.named_buffers():
        if 'running' not in k:
            continue
        ref = cpu_bufs[k]
        d = float((buf.cpu() - ref).abs().max())
        lim = 1e-4 * max(1.0, float(ref.abs().max()))
        worst_stat = max(worst_stat, d / lim * 1e-4)
        check(d <= lim, f'{tag}: {k} differs from the CPU by {d} (limit '
                        f'{lim})')
    log(f'[{tag}] running statistics after {PARITY_STEPS} steps: worst '
        f'{worst_stat:.3e} of max(1, max|CPU|)')
    out['running_stats_rel_diff'] = worst_stat
    return out


def eval_batches(torch, loader, prepare, metric, batches):
    """``batches`` eval-mode forwards (running statistics) without
    gradients; the metric of each, all finite."""
    vals = []
    with torch.no_grad():
        for _, batch in zip(range(batches), loader):
            vals.append(float(metric(*prepare(batch))))
    check(all(math.isfinite(v) for v in vals), f'eval metrics {vals}')
    return vals


def graph_path_result(tag, host_ms, card_ms, losses, per_step, prof_rows,
                      prof_ms):
    """The common part of paths V's and W's records, and its log line."""
    busy = sum(t for _, t, _ in prof_rows)
    res = {'steps': len(losses), 'losses': losses,
           'host_ms_per_batch': host_ms, 'card_ms_per_step': card_ms,
           'launches_per_step': per_step,
           'device_busy_ms_per_step': busy, 'profiled_ms_per_step': prof_ms,
           'kernel1_ms_per_step': sum(t for name, t, _ in prof_rows
                                      if SEG_MAIN in name),
           'kernels_per_step': [[name[:80], t, c]
                                for name, t, c in prof_rows[:8]]}
    res['device_idle_share_unprofiled'] = 1 - busy / float(
        np.median(card_ms[1:]))
    log(f'[{tag}] per batch the host takes {np.median(host_ms):.2f} ms '
        f'(median; {host_ms}), the card runs a step in '
        f'{np.median(card_ms[1:]):.4f} ms (CUDA events, median after the '
        f'first; {card_ms}), busy {busy:.4f} ms (torch.profiler), idle '
        f"{res['device_idle_share_unprofiled']:.3f}, kernel 1 "
        f"{res['kernel1_ms_per_step']:.4f} ms, launches a step {per_step}; "
        f'losses {losses}')
    for name, t, c in prof_rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {name[:90]}')
    return res


def host_breakdown(torch, tag, fn, top=10):
    """Where the host's time goes in a call of ``fn`` (one training step),
    over three calls: the first timed alone (host ms until ``fn`` returns,
    and until the card is done); the second under
    ``torch.cuda.set_sync_debug_mode('warn')``, whose warnings count the
    calls that wait for the card, by the line that made them; the third
    under ``torch.profiler`` with CPU activity only: the operators by self
    CPU time, and how many were called (the profiler's own cost inflates
    these times, not the count)."""
    import collections
    import warnings
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    returned = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    done = (time.perf_counter() - t0) * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = collections.Counter(
        f'{os.path.basename(w.filename)}:{w.lineno}' for w in caught
        if 'synchroniz' in str(w.message))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    res = {'host_ms_to_return': returned, 'host_ms_to_card_done': done,
           'syncs': sum(syncs.values()), 'sync_sites': dict(syncs),
           'ops_called': sum(e.count for e in ops),
           'ops_self_cpu_ms': sum(e.self_cpu_time_total for e in ops) / 1e3,
           'top_ops': [[e.key, e.self_cpu_time_total / 1e3, e.count]
                       for e in ops[:top]]}
    log(f"[{tag}] host breakdown of one step: fn returns after "
        f"{returned:.2f} ms, the card is done at {done:.2f} ms; "
        f"{res['syncs']} waits for the card ({dict(syncs)}); "
        f"{res['ops_called']} operators called, "
        f"{res['ops_self_cpu_ms']:.2f} ms of self CPU time under the "
        f"profiler; most: " + ', '.join(
            f'{k} {t:.2f} ms x{c}' for k, t, c in res['top_ops']))
    return res


def float32_first_step(torch, tag, build, state, batch_card, batch_cpu,
                       loss_of):
    """The first step in float32 from ``state`` on one batch in training
    mode, twice on the card and once on the CPU. The card against itself:
    each tensor's largest gap between its two runs over its own largest
    (logged, the worst first, for the tensors whose largest passes 1e-6 of
    the largest of all). The card against the CPU: the loss within 1e-4
    relative, and every gradient within 1e-4 of the largest gradient of
    all."""
    card = build('cuda')
    card.load_state_dict({k: v.cuda() for k, v in state.items()})
    card.train()
    losses, runs = [], []
    for _ in range(2):
        card.zero_grad(set_to_none=True)
        loss = loss_of(card, *batch_card)
        loss.backward()
        losses.append(loss.item())
        runs.append({k: g.cpu() for k, g in grads_of(torch, card).items()})
    cpu = build('cpu')
    cpu.load_state_dict(state)
    cpu.train()
    loss = loss_of(cpu, *batch_cpu)
    loss.backward()
    l_cpu, g_cpu = loss.item(), grads_of(torch, cpu)
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    own = {k: float(g.abs().max()) for k, g in runs[0].items()}
    spread = {k: float((runs[1][k] - g).abs().max()) / own[k]
              for k, g in runs[0].items() if own[k] > 1e-6 * largest}
    log(f'[{tag}] the card against itself, two float32 first steps: worst '
        f'gap of each tensor over its own largest (the tensors past 1e-6 of '
        f'the largest of all) ' + ', '.join(
            f'{k} {v:.3e}' for k, v in sorted(spread.items(),
                                              key=lambda kv: -kv[1])[:10]))
    rel = abs(losses[0] - l_cpu) / abs(l_cpu)
    log(f'[{tag}] float32 first-batch loss, card {losses[0]} vs CPU {l_cpu}: '
        f'relative diff {rel:.3e} (limit 1e-4)')
    check(rel <= 1e-4, f'{tag}: float32 first-batch loss {rel} from the CPU')
    gaps = {k: float((runs[0][k] - g).abs().max()) / largest
            for k, g in g_cpu.items()}
    worst = max(gaps.values())
    log(f'[{tag}] float32 first-step gradients against the CPU, of the '
        f'largest of all (limit 1e-4): worst {worst:.3e}; ' + ', '.join(
            f'{k} {v:.3e}' for k, v in sorted(gaps.items(),
                                              key=lambda kv: -kv[1])[:6]))
    for k, gap in gaps.items():
        check(gap <= 1e-4, f'{tag}: float32 first-step gradient of {k} is '
                           f'{gap} of the largest from the CPU')
    return {'loss_rel_diff': rel, 'grad_worst_of_largest': worst,
            'card_self_spread': spread}


def phase_path_v(torch, seed):
    """Path V: PNA at PyG's examples/pna.py configuration on ZINC's shape.
    ``zinc_like`` (10,000 training graphs) on the host, PNA's degree
    statistics from its in-degree histogram; ``DataLoader(batch_size=128,
    shuffle=True, pad=False)``; ``pna_zinc_net`` (4 x PNAConv(75, towers=5,
    edge_dim=50) with BatchNorm and ReLU, sum pooling, MLP 75 -> 50 -> 25
    -> 1), L1 loss, Adam 1e-3, ``PV_STEPS`` eager steps on the card: host
    ms a batch, card ms a step, no port kernel launched (PNA's reductions
    are ``index_add_`` / ``scatter_reduce_``, as the JAX package's are XLA
    segment ops), a whole-window profile and the idle share; then
    ``PV_EVAL_BATCHES`` eval-mode batches (running statistics); the first
    step in float32 against the CPU and the card against itself
    (``float32_first_step``), then the first batch's 3 steps against the
    CPU in float64 on both devices (``synced_parity``)."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import DataLoader
    tag = 'path V'
    t0 = time.perf_counter()
    graphs = zinc_graphs(seed)
    hist, log_avg, lin_avg = pna_degree_stats(graphs)
    data = [Data(x=a, edge_index=c, edge_attr=b, y=y, num_nodes=len(a))
            for a, c, b, y in graphs]
    gen_s = time.perf_counter() - t0
    nodes = float(np.mean([len(g[0]) for g in graphs]))
    edges = float(np.mean([g[1].shape[1] for g in graphs]))
    log(f'[{tag}] zinc_like: {len(graphs)} graphs, {nodes:.2f} nodes and '
        f'{edges:.2f} directed edges a graph, built in {gen_s:.2f} s; '
        f'in-degree histogram {hist.tolist()}, avg_deg_log {log_avg:.6f}, '
        f'avg_deg_lin {lin_avg:.6f}')
    loader = DataLoader(data, batch_size=PV_BATCH, shuffle=True, pad=False,
                        seed=seed)

    def prepare(batch):
        return (batch.x.to('cuda'), batch.edge_index.coo.to('cuda'),
                batch.edge_attr.to('cuda'), batch.batch.to('cuda'),
                batch.y.to('cuda'), batch.num_graphs)

    def loss_of(model, atoms, coo, bonds, bvec, y, ng):
        return (model(atoms, coo, bonds, bvec, ng) - y).abs().mean()

    def build(device):
        return pna_zinc_net(torch, device, seed, log_avg, lin_avg)

    model = build(None)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PV_LR)

    def step(*batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    t0 = time.perf_counter()
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PV_STEPS)
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{PV_STEPS} steps')
    steps_s = time.perf_counter() - t0
    # one step a profiled window: a step's ~3,000 launches make the
    # profiler's own bookkeeping the slowest part of the phase
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 1)
    prof_s = time.perf_counter() - t0 - steps_s
    res = graph_path_result(tag, host_ms, card_ms, losses, per_step,
                            prof_rows, prof_ms)
    res['host_breakdown'] = host_breakdown(torch, tag, lambda: step(*first))
    res.update(graphs=len(graphs), nodes_per_graph=nodes,
               edges_per_graph=edges, build_s=gen_s,
               degree_histogram=hist.tolist(), avg_deg_log=log_avg,
               avg_deg_lin=lin_avg, launch_counts=counts,
               first_batch={'graphs': first[5], 'nodes': len(first[0]),
                            'edges': first[1].shape[1]})
    model.eval()
    res['eval_mae'] = eval_batches(
        torch, DataLoader(data, batch_size=PV_BATCH, pad=False), prepare,
        lambda a, c, b, bv, y, ng: (model(a, c, b, bv, ng) - y).abs().mean(),
        PV_EVAL_BATCHES)
    log(f"[{tag}] eval-mode MAE over {PV_EVAL_BATCHES} batches "
        f"{res['eval_mae']}")
    # a float32 run is never held to a float64 one here: the std
    # aggregator's E[x^2] - E[x]^2 in float32 leaves rounding noise (up to
    # ~1e-7 of E[x^2]) where a node's messages are equal, the 1e-5 clamp
    # and the sqrt then magnify it, and float64 sits 1e-3-1e-2 away in the
    # loss on zinc_like's batches; the two devices run one formula in one
    # dtype and are held to each other
    cpu_batch = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                      for t in first)
    t0 = time.perf_counter()
    res['first_step_float32'] = float32_first_step(
        torch, tag, build, state, first, cpu_batch, loss_of)
    # the steps in float64 on both: index_add_'s atomics sum in no fixed
    # order, and the card's float32 gradients differ from themselves by up
    # to 1.2e-2 of a tensor's own largest (PNA's pre_nns weights), past the
    # 1e-2 that synced_parity holds each tensor to

    def cast(batch):
        return tuple(t.double() if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t for t in batch)

    res['first_batch_vs_cpu'] = synced_parity(
        torch, f'{tag} float64', lambda dev: build(dev).double(), state,
        cast(first), cast(cpu_batch), None, loss_of, PV_LR)
    res['phase_s'] = {'build': gen_s, 'steps': steps_s, 'profile': prof_s,
                      'cpu_parity': time.perf_counter() - t0}
    log(f"[{tag}] seconds: {res['phase_s']}")
    del data, loader, model, opt, first
    torch.cuda.empty_cache()
    return res


class CollabSet:
    """Path W's dataset: graph ``i`` of ``collab_like``'s plan, built on the
    host when the loader asks for it."""

    def __init__(self, plan, seed, data_cls):
        self.plan, self.seed, self.data_cls = plan, seed, data_cls

    def __len__(self):
        return len(self.plan[0])

    def __getitem__(self, i):
        x, coo, y = collab_graph(i, self.plan, self.seed)
        return self.data_cls(x=x, edge_index=coo, y=y, num_nodes=len(x))


def phase_path_w(torch, seed):
    """Path W: GIN-0 at the GIN paper's widths on COLLAB's shape
    (``benchmark/kernel``'s protocol). ``collab_like`` (5,000 graphs, each
    built on the host when its batch asks for it: one-hot degree features
    492 wide); ``DataLoader(batch_size=128, shuffle=True, pad=False)``, each
    batch's ``EdgeIndex`` with its CSC and CSR built on the card;
    ``gin_collab_net`` (GIN 492 -> 64 x 5 with batch norm and ``jk='cat'``,
    sum pooling, Linear 320 -> 3), cross-entropy, Adam 0.01, ``PW_STEPS``
    eager steps: host ms a batch, card ms a step, kernel 1 nine times a
    step (5 forward, 4 ``A^T g``: x needs no gradient), a whole-window
    profile and the idle share; ``PW_EVAL_BATCHES`` eval-mode batches; the
    first batch's 3 steps against the CPU (``synced_parity``); kernel 1 at
    the first batch's shapes (F = 492 and 64 forward, 64 ``A^T g``) against
    its plain version and timed."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import DataLoader
    tag = 'path W'
    plan = collab_like(seed)
    dataset = CollabSet(plan, seed, Data)
    log(f'[{tag}] collab_like: {len(dataset)} graphs, '
        f'{plan[0].mean():.2f} nodes and {plan[1].mean():.2f} undirected '
        f'edges a graph ({plan[0].min()}-{plan[0].max()} nodes), '
        f'{COLLAB_F} one-hot degree features, {COLLAB_C} classes')
    loader = DataLoader(dataset, batch_size=PW_BATCH, shuffle=True,
                        pad=False, seed=seed)

    def prepare(batch):
        n = batch.num_nodes
        ei = EdgeIndex(batch.edge_index.coo.to('cuda'), (n, n)).fill_cache(
            blocked=False)
        return (batch.x.to('cuda'), ei, batch.batch.to('cuda'),
                batch.y.to('cuda').long(), batch.num_graphs)

    def loss_of(model, x, ei, bvec, y, ng):
        return torch.nn.functional.cross_entropy(model(x, ei, bvec, ng), y)

    def build(device):
        return gin_collab_net(torch, device, seed)

    model = build(None)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PW_LR)

    def step(*batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    per_step_want = {'segment_spmm': 2 * PW_LAYERS - 1}
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PW_STEPS)
    counts = launch_counts()
    check(per_step == per_step_want,
          f'{tag}: launches in the first step {per_step}')
    check_counts(tag, counts, {k: v * PW_STEPS
                               for k, v in per_step_want.items()},
                 f'{PW_STEPS} steps')
    prof_rows, prof_ms, _ = whole_window(
        torch, lambda: step(*first), 3,
        expect={SEG_MAIN: per_step_want['segment_spmm']})
    res = graph_path_result(tag, host_ms, card_ms, losses, per_step,
                            prof_rows, prof_ms)
    res['host_breakdown'] = host_breakdown(torch, tag, lambda: step(*first))
    ei = first[1]
    res.update(graphs=len(dataset), nodes_per_graph=float(plan[0].mean()),
               edges_per_graph=2 * float(plan[1].mean()),
               launch_counts=counts,
               first_batch={'graphs': first[4], 'nodes': ei.num_src_nodes,
                            'edges': ei.num_edges})
    model.eval()
    res['eval_accuracy'] = eval_batches(
        torch, DataLoader(dataset, batch_size=PW_BATCH, pad=False), prepare,
        lambda x, e, bv, y, ng: (model(x, e, bv, ng).argmax(-1) == y).float()
        .mean(), PW_EVAL_BATCHES)
    log(f"[{tag}] first batch {first[4]} graphs, {ei.num_src_nodes} nodes, "
        f"{ei.num_edges} edges; eval-mode accuracy over {PW_EVAL_BATCHES} "
        f"batches {res['eval_accuracy']}")
    cpu_ei = EdgeIndex(ei.coo.cpu(), ei.sparse_size,
                       device='cpu').fill_cache(blocked=False)
    cpu_batch = (first[0].cpu(), cpu_ei, first[2].cpu(), first[3].cpu(),
                 first[4])
    batch64 = (first[0].cpu().double(), ei.coo.cpu().long(),
               *cpu_batch[2:])
    res['first_batch_vs_cpu'] = synced_parity(
        torch, tag, build, state, first, cpu_batch, batch64, loss_of, PW_LR)
    rows, worst = kernel1_rows(torch, 'W', ei, [
        (f'forward F={COLLAB_F}', ei.csc, None, first[0]),
        (f'forward F={PW_HIDDEN}', ei.csc, None, PW_HIDDEN),
        (f'A^T g F={PW_HIDDEN}', ei.csr, None, PW_HIDDEN)], seed + 61)
    del loader, model, opt, first
    torch.cuda.empty_cache()
    return res, rows, worst


# -- paths X and Y: graph transformers at ZINC's and ogbn-arxiv's shapes ------
# PyG's examples/graph_gps.py on ZINC's subset (the GraphGPS paper's ZINC
# setting at the example's widths): atom Embedding(28, 64 - 8) beside the
# 20-step random-walk PE (``AddRandomWalkPE(20)``) through BatchNorm(20)
# and Linear(20, 8), bond Embedding(4, 64), 10 x GPSConv(64,
# GINEConv(Linear 64 -> 64, ReLU, Linear 64 -> 64), heads=4) with batch
# norm, multi-head ('multihead') or Performer ('performer') attention, sum
# pooling, MLP 64 -> 32 -> 16 -> 1; L1 loss, Adam(1e-3, weight_decay=1e-5),
# batch 32. Cut: the attention dropout (0.5 there) is 0, as the JAX package
# applies none, and there is no ReduceLROnPlateau over 10 steps
PX_ATOMS, PX_CHANNELS, PX_PE_DIM, PX_WALK = 28, 64, 8, 20
PX_LAYERS, PX_HEADS, PX_MLP = 10, 4, (32, 16, 1)
PX_BATCH, PX_STEPS, PX_EVAL_BATCHES = 32, 10, 4
PX_LR, PX_WEIGHT_DECAY = 1e-3, 1e-5
# ogbn-arxiv's shape: 169,343 papers, 1,166,243 citations, made undirected
# (both directions stored), 128 features, 40 classes. Generated: each
# citation from a uniform paper to one drawn with weight rank^-PY_SKEW over
# a random ranking of the papers (a skewed in-degree), no self loop, each
# unordered pair once; at 0.75 the largest degree is 14,270 (ogbn-arxiv's
# 13,161), the mean 13.77 (13.67)
ARXIV_NODES, ARXIV_PAIRS, ARXIV_F, ARXIV_C = 169_343, 1_166_243, 128, 40
PY_SKEW = 0.75
# SGFormer (Wu et al., NeurIPS 2023) at its ogbn-arxiv setting: hidden 256,
# 1 attention layer of 1 head, 3 GCN layers with batch norm and residuals,
# graph_weight 0.5, Adam 1e-3; full graph, 10 timed training steps. The GCN
# layers run on the cached normalisation (``cache_gcn_norm(auto=True)``,
# the reference's GCNConv(cached=True)): kernel 1 three times a forward,
# and three ``A^T g`` a step
PY_HIDDEN, PY_TRANS_LAYERS, PY_HEADS, PY_GNN_LAYERS = 256, 1, 1, 3
PY_GRAPH_WEIGHT, PY_LR, PY_STEPS = 0.5, 1e-3, 10
# the CPU reference steps run on arxiv_like at this scale (16,934 nodes):
# the CPU's plain segment sum over the whole graph would take most of the
# path's time
PY_CHECK_SCALE = 0.1


@functools.lru_cache(maxsize=1)
def zinc_graphs(seed):
    """``zinc_like``'s 10,000 graphs, built once for paths V and X."""
    return tuple(zinc_like(ZINC_TRAIN, seed))


def gps_zinc_net(torch, device, seed, attn_type='multihead',
                 channels=PX_CHANNELS, pe_dim=PX_PE_DIM, walk=PX_WALK,
                 layers=PX_LAYERS, heads=PX_HEADS, mlp=PX_MLP):
    """Path X's model (PyG's examples/graph_gps.py): ``model(atoms, pe,
    coo, bonds, batch, num_graphs, max_nodes)``, one output a graph;
    ``max_nodes`` the batch's largest graph, as the reference's
    ``to_dense_batch`` pads to it."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import (MLP, BatchNorm, GINEConv,
                                                GPSConv)
    from pytorch_geometric_tpu_torch.nn.inits import embedding, linear
    from pytorch_geometric_tpu_torch.nn.pool import global_add_pool
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    kw = dict(device=device, generator=g)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.node_emb = embedding(PX_ATOMS, channels - pe_dim, **kw)
            self.pe_norm = BatchNorm(walk, device=device)
            self.pe_lin = linear(walk, pe_dim, **kw)
            self.edge_emb = embedding(ZINC_BONDS, channels, **kw)
            self.convs = torch.nn.ModuleList(
                GPSConv(channels, GINEConv(MLP(channels, [channels, channels],
                                               **kw)),
                        heads=heads, attn_type=attn_type, **kw)
                for _ in range(layers))
            self.mlp = MLP(channels, list(mlp), **kw)

        def forward(self, atoms, pe, coo, bonds, batch, num_graphs,
                    max_nodes):
            x = torch.cat([self.node_emb(atoms.long()),
                           self.pe_lin(self.pe_norm(pe))], -1)
            e = self.edge_emb(bonds.long())
            for conv in self.convs:
                x = conv(x, coo, batch, num_graphs, max_nodes, edge_attr=e)
            return self.mlp(global_add_pool(x, batch, num_graphs))[:, 0]

    return Net()


class ZincPESet:
    """Path X's dataset: ``zinc_like``'s graphs, each given its
    random-walk PE by ``transform`` when the loader asks for it (PyG runs
    it once a graph, as a pre-transform); ``seconds`` sums the transform's
    host time."""

    def __init__(self, graphs, transform, data_cls):
        self.graphs, self.transform, self.data_cls = graphs, transform, \
            data_cls
        self.seconds = 0.0

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        a, c, b, y = self.graphs[i]
        d = self.data_cls(x=a, edge_index=c, edge_attr=b, y=y,
                          num_nodes=len(a))
        t0 = time.perf_counter()
        d = self.transform(d)
        self.seconds += time.perf_counter() - t0
        return d


def gps_arm(torch, seed, dataset, attn_type, breakdown):
    """One arm of path X: ``PX_STEPS`` eager steps on the card (host ms a
    batch and the PE transform's share of it, card ms a step, no port
    kernel launched: GINE's messages and the attention are plain PyTorch,
    as the JAX package's are XLA), a whole-window profile of one step and
    its launches, ``PX_EVAL_BATCHES`` eval batches; the first batch's
    float32 loss against the CPU's, and its 3 steps against the CPU in
    float64 on both (``synced_parity``); with ``breakdown`` a host
    breakdown of one step."""
    from pytorch_geometric_tpu_torch.loader import DataLoader
    tag = f'path X {attn_type}'
    loader = DataLoader(dataset, batch_size=PX_BATCH, shuffle=True,
                        pad=False, seed=seed)
    pe_ms, seen = [], [dataset.seconds]

    def prepare(batch):
        pe_ms.append((dataset.seconds - seen[0]) * 1e3)
        seen[0] = dataset.seconds
        largest = int(np.diff(batch.ptr.numpy()).max())
        return (batch.x.to('cuda'), batch.random_walk_pe.to('cuda'),
                batch.edge_index.coo.to('cuda'), batch.edge_attr.to('cuda'),
                batch.batch.to('cuda'), batch.y.to('cuda'), batch.num_graphs,
                largest)

    def loss_of(model, atoms, pe, coo, bonds, bvec, y, ng, largest):
        return (model(atoms, pe, coo, bonds, bvec, ng, largest)
                - y).abs().mean()

    def build(device):
        return gps_zinc_net(torch, device, seed, attn_type)

    model = build(None)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PX_LR,
                           weight_decay=PX_WEIGHT_DECAY)

    def step(*batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    t0 = time.perf_counter()
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PX_STEPS)
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{PX_STEPS} steps')
    steps_s = time.perf_counter() - t0
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 1)
    res = graph_path_result(tag, host_ms, card_ms, losses, per_step,
                            prof_rows, prof_ms)
    res['pe_transform_ms_per_batch'] = pe_ms
    res['pe_share_of_host_ms'] = float(np.sum(pe_ms) / np.sum(host_ms))
    res['cuda_launches_per_step'] = sum(c for _, _, c in prof_rows)
    log(f"[{tag}] the PE transform takes {np.median(pe_ms):.2f} ms of a "
        f"batch's host time (median; {res['pe_share_of_host_ms']:.3f} of "
        f"the total); {res['cuda_launches_per_step']:g} kernel launches a "
        f"step in the profile")
    if breakdown:
        res['host_breakdown'] = host_breakdown(torch, tag,
                                               lambda: step(*first))
    res.update(launch_counts=counts,
               first_batch={'graphs': first[6], 'nodes': len(first[0]),
                            'edges': first[2].shape[1],
                            'max_nodes': first[7]})
    model.eval()
    res['eval_mae'] = eval_batches(
        torch, DataLoader(dataset, batch_size=PX_BATCH, pad=False), prepare,
        lambda *b: loss_of(model, *b), PX_EVAL_BATCHES)
    log(f"[{tag}] eval-mode MAE over {PX_EVAL_BATCHES} batches "
        f"{res['eval_mae']}")
    cpu_batch = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                      for t in first)
    t1 = time.perf_counter()
    # float32: the first batch's loss on the card and on the CPU from the
    # same weights, in training mode
    losses = []
    for dev, batch in (('cuda', first), ('cpu', cpu_batch)):
        m = build(dev)
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
        with torch.no_grad():
            losses.append(float(loss_of(m.train(), *batch)))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    log(f'[{tag}] float32 first-batch loss, card {losses[0]} vs CPU '
        f'{losses[1]}: relative diff {rel:.3e} (limit 1e-4)')
    check(rel <= 1e-4, f'{tag}: float32 first-batch loss {rel} from the CPU')
    # the steps in float64 on both: the model is not smooth (40 ReLU sites
    # over 10 layers), and at these weights a 1e-7 relative nudge of the
    # weights moves the float32 gradient of layer 1's GINE weight by up to
    # 7e-4 of the largest from float64 (a ReLU input crossing 0); float32
    # gradients cannot be held to 1e-4 on any device

    def cast(batch):
        return tuple(t.double() if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t for t in batch)

    res['first_batch_vs_cpu'] = synced_parity(
        torch, f'{tag} float64', lambda dev: build(dev).double(), state,
        cast(first), cast(cpu_batch), None, loss_of, PX_LR)
    res['first_batch_vs_cpu']['float32_loss_rel_diff'] = rel
    res['phase_s'] = {'steps': steps_s,
                      'cpu_parity': time.perf_counter() - t1}
    del loader, model, opt, first
    return res


def phase_path_x(torch, seed):
    """Path X: GraphGPS as PyG's examples/graph_gps.py runs it, on ZINC's
    shape (``zinc_like``'s 10,000 graphs, each with ``AddRandomWalkPE(20)``
    on the host when its batch is drawn): ``gps_zinc_net``, batch 32
    unpadded, ``max_num_nodes`` the batch's largest graph; the multi-head
    arm, then the Performer arm (``gps_arm``)."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.transforms import AddRandomWalkPE
    t0 = time.perf_counter()
    dataset = ZincPESet(zinc_graphs(seed), AddRandomWalkPE(PX_WALK), Data)
    res = {'graphs': len(dataset), 'build_s': time.perf_counter() - t0}
    for attn in ('multihead', 'performer'):
        res[attn] = gps_arm(torch, seed, dataset, attn, attn == 'multihead')
    torch.cuda.empty_cache()
    return res


def arxiv_like(scale=1.0, seed=0):
    """Path Y's graph at ``scale`` of ogbn-arxiv's shape: ``[2, 2 *
    pairs]`` int32, each citation stored both ways."""
    rng = np.random.default_rng(seed)
    n = max(int(round(ARXIV_NODES * scale)), 2)
    want = max(int(round(ARXIV_PAIRS * scale)), 1)
    weight = 1.0 / np.arange(1, n + 1) ** PY_SKEW
    p = (weight / weight.sum())[rng.permutation(n)]
    keys = np.zeros(0, np.int64)
    while len(keys) < want:
        m = int((want - len(keys)) * 1.3) + 16
        src = rng.integers(0, n, m)
        dst = rng.choice(n, m, p=p)
        keep = src != dst
        k = (np.minimum(src, dst) * n + np.maximum(src, dst))[keep]
        keys = np.concatenate([keys, k])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:want]
    a, b = keys // n, keys % n
    return np.stack([np.concatenate([a, b]),
                     np.concatenate([b, a])]).astype(np.int32)


def sgformer_arxiv_net(torch, device, seed, cached=True):
    """Path Y's model: ``SGFormer`` at its ogbn-arxiv setting on the cached
    GCN normalisation (``cached``), called as ``model(x, ei)``."""
    from pytorch_geometric_tpu_torch.nn.models import SGFormer
    return SGFormer(ARXIV_F, PY_HIDDEN, ARXIV_C,
                    trans_num_layers=PY_TRANS_LAYERS,
                    trans_num_heads=PY_HEADS, gnn_num_layers=PY_GNN_LAYERS,
                    graph_weight=PY_GRAPH_WEIGHT, cached=cached,
                    device=device,
                    generator=torch.Generator().manual_seed(seed))


def phase_path_y(torch, seed, iters):
    """Path Y: SGFormer at ogbn-arxiv's shape, full graph. ``arxiv_like``
    (169,343 nodes, 2,332,486 directed edges) through
    ``cache_gcn_norm(auto=True)`` on the card, which must choose kernel 1
    (``spmm_regime`` 'kernel': no dense or block cache); X [169,343, 128]
    and 40-class labels made on the card from ``seed``; served and trained
    (softmax cross-entropy, Adam 1e-3) eager and captured
    (``flash_serve_train``: kernel 1 three times a forward and six times a
    step, the captured outputs, losses and
    gradients against the eager ones); 3 steps against the CPU at the
    card's parameters on the graph cut to ``PY_CHECK_SCALE``, the first
    step's gradients against float64 (``synced_parity``, ``exact``;
    running statistics too); kernel 1 at
    F = 256, forward and ``A^T g``, against its plain version and timed
    beside ``torch.sparse.mm``. The global attention is O(N D^2): no
    ``[N, N]`` array."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn.conv import cache_gcn_norm
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    tag = 'path Y'
    n = ARXIV_NODES
    t0 = time.perf_counter()
    coo = arxiv_like(1.0, seed)
    gen_s = time.perf_counter() - t0
    deg = np.bincount(coo[1], minlength=n)
    log(f'[{tag}] arxiv_like: {n} nodes, {coo.shape[1]} directed edges '
        f'built on the host in {gen_s:.2f} s; in-degree mean '
        f'{deg.mean():.2f}, max {deg.max()}, 99th percentile '
        f'{np.percentile(deg, 99):.0f}')
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ei = cache_gcn_norm(EdgeIndex(coo, (n, n)), auto=True)
    torch.cuda.synchronize()
    cache = cache_report(torch, tag, ei, time.perf_counter() - t0, mem0)
    regime = spmm_regime(ei, PY_HIDDEN, 'sum')
    check(regime == 'kernel' and ei.weight is not None,
          f'{tag}: the GCN layers take {regime!r}')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((n, ARXIV_F), generator=gen, device='cuda')
    y = torch.randint(0, ARXIV_C, (n,), generator=gen, device='cuda')
    k1 = {'segment_spmm': PY_GNN_LAYERS}
    res, state, _ = flash_serve_train(
        torch, tag, sgformer_arxiv_net, seed, x, ei, y, k1,
        {'segment_spmm': 2 * PY_GNN_LAYERS}, iters, PY_STEPS, PY_LR,
        sync_state=True)
    res.update(cache=cache, regime=regime, nodes=n, edges=coo.shape[1],
               build_s=gen_s)
    # the CPU reference: 3 steps at the card's parameters on the graph cut
    # to PY_CHECK_SCALE, on the card (kernel 1 again) and on the CPU
    t0 = time.perf_counter()
    cut = arxiv_like(PY_CHECK_SCALE, seed)
    nc = int(cut.max()) + 1
    cut_ei = {dev: cache_gcn_norm(EdgeIndex(cut, (nc, nc), device=dev),
                                  auto=True) for dev in ('cuda', 'cpu')}
    check(spmm_regime(cut_ei['cuda'], PY_HIDDEN, 'sum') == 'kernel',
          f'{tag}: the cut graph\'s GCN layers leave kernel 1')
    xc, yc = x[:nc].contiguous(), y[:nc].contiguous()

    def build(device):
        return sgformer_arxiv_net(torch, device, seed)

    def build64(device):
        # the GCN layers normalise the raw COO (no loops, no duplicates: the
        # same matrix) and aggregate by gather, which takes float64
        return sgformer_arxiv_net(torch, device, seed, cached=False)

    def loss_of(model, xs, e, ys):
        return torch.nn.functional.cross_entropy(model(xs, e), ys)

    res['first_steps_vs_cpu'] = synced_parity(
        torch, f'{tag} at {PY_CHECK_SCALE} scale', build, state,
        (xc, cut_ei['cuda'], yc), (xc.cpu(), cut_ei['cpu'], yc.cpu()),
        (xc.cpu().double(), torch.as_tensor(cut).long(), yc.cpu()),
        loss_of, PY_LR, build64=build64, exact=True)
    res['cpu_parity_s'] = time.perf_counter() - t0
    res['cpu_parity_graph'] = {'nodes': nc, 'edges': int(cut.shape[1])}
    w = ei.weight
    rows, worst = kernel1_rows(torch, 'Y', ei, [
        (f'forward F={PY_HIDDEN}', ei.csc, w[ei.csc.perm].contiguous(),
         PY_HIDDEN),
        (f'A^T g F={PY_HIDDEN}', ei.csr, w[ei.csr.perm].contiguous(),
         PY_HIDDEN)], seed + 81)
    log(f"[{tag}] CPU parity took {res['cpu_parity_s']:.1f} s; kernel 1 at "
        f'F={PY_HIDDEN}: ' + ', '.join(
            f"{r['shape']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"torch.sparse.mm {r['library_ms']})" for r in rows))
    del ei, cut_ei, x, y, xc, yc
    torch.cuda.empty_cache()
    return res, rows, worst


# -- path Z: Correct & Smooth at ogbn-products' shape --------------------------
# PyG's examples/correct_and_smooth.py: an MLP base predictor (100 -> 200 ->
# 200 -> 47, batch norm, dropout 0.5, Adam 0.01 on the training rows, full
# batch) and CorrectAndSmooth(num_correction_layers=50, correction_alpha=1.0,
# num_smoothing_layers=50, smoothing_alpha=0.8, autoscale=False, scale=20)
# over the GCN normalisation without self loops, on the products graph
# (products_graph, products_data). The training rows are the first 196,615
# of a seeded permutation (ogbn-products' train split). Cut: 10 base steps
# (300 epochs there); the graph, widths and the 50 + 50 layers are not cut
PZ_TRAIN, PZ_HIDDEN, PZ_DROPOUT = 196_615, (200, 200), 0.5
PZ_LR, PZ_STEPS = 0.01, 10
PZ_CS = dict(num_correction_layers=50, correction_alpha=1.0,
             num_smoothing_layers=50, smoothing_alpha=0.8, autoscale=False,
             scale=20.0)
# the CPU reference runs on products_graph cut to this scale (24,490 nodes)
PZ_CHECK_SCALE = 0.01
# corrected and smoothed outputs against the CPU's float64, relative to
# max(1, max|ref|): correction at alpha 1.0 does not contract over its 50
# hops and scale 20 multiplies its error, so the margin is measured and
# logged (PERF.md section 2)
PZ_TOL = 1e-4


def cs_model(torch, device, seed, dropout=PZ_DROPOUT):
    """Path Z's base predictor: the port's ``MLP(100, [200, 200, 47],
    norm='batch_norm', dropout=0.5)``, random weights from ``seed``."""
    from pytorch_geometric_tpu_torch.nn.models import MLP
    return MLP(PR_F, [*PZ_HIDDEN, PR_CLASSES], norm='batch_norm',
               dropout=dropout, device=device,
               generator=torch.Generator().manual_seed(seed))


def cs_train(torch, model, x, y, rows, steps, generator, lr=PZ_LR,
             on_step=None):
    """``steps`` full-batch Adam steps of softmax cross-entropy on ``x[rows]``
    (dropout drawn from ``generator``); ``on_step(i)`` after each. Returns
    the losses."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    xt, yt = x[rows], y[rows]
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            model(xt, generator=generator), yt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            on_step(i)
    return [float(v) for v in losses]


def cs_soft(torch, model, x):
    """The base predictor's class probabilities, eval mode."""
    model.eval()
    with torch.no_grad():
        return torch.softmax(model(x), -1)


def cs_post(torch, cs, y_soft, y, train_mask, coo, repin=True):
    """``(corrected, smoothed)`` of ``CorrectAndSmooth`` ``cs`` from
    ``y_soft`` and the labels ``y`` (one-hot in ``y_soft``'s dtype). With
    ``repin`` false the correction leaves the training rows' error free
    after each hop (the sensitivity variant: no post step at all)."""
    from pytorch_geometric_tpu_torch.nn.models import LabelPropagation
    y_true = torch.nn.functional.one_hot(y, y_soft.shape[1]).to(y_soft.dtype)
    with torch.no_grad():
        if repin:
            corrected = cs.correct(y_soft, y_true, train_mask, coo)
        else:
            err = torch.where(train_mask[:, None], y_true - y_soft, 0)
            lp = LabelPropagation(cs.num_correction_layers,
                                  cs.correction_alpha)
            corrected = y_soft + cs.scale * lp(err, coo,
                                               post_step=lambda v: v)
        return corrected, cs.smooth(corrected, y_true, train_mask, coo)


def cs_err(torch, got, ref):
    """``max|got - ref| / max(1, max|ref|)``, on the CPU in float64."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def cs_train_mask(torch, n, train, seed, device):
    """The first ``train`` rows of a permutation of ``n`` from ``seed`` as a
    bool mask."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    mask = torch.zeros(n, dtype=torch.bool)
    mask[perm[:train]] = True
    return mask.to(device)


def cs_timed(torch, fn):
    """``fn()``'s result, its ms on the card's clock (CUDA events) and the
    host ms until it returned."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), host


def phase_path_z(torch, seed, coo):
    """Path Z: Correct & Smooth at ogbn-products' shape (``PZ_*``): the
    products graph (2,449,029 nodes, 123,718,280 edges) on the card as a
    raw COO, X [N, 100] and 47 labels from ``products_data``; the base MLP
    trained 10 full-batch Adam steps on the 196,615 training rows (dropout
    from a CUDA generator), served in eval mode and softmaxed, then
    ``CorrectAndSmooth`` with ``correct`` and ``smooth`` timed apart (CUDA
    events), one propagation layer timed alone, peak memory, and a second
    pass profiled as a whole window (busy and idle share, launches a layer;
    host issue ms and the caching allocator's retries from the first
    pass); the smoothed output finite and in [0, 1], the two passes within
    ``PZ_TOL``. Against the CPU: the card's trained weights on the graph
    cut to ``PZ_CHECK_SCALE`` (1 % of the training rows), on the card in
    float32 and on the CPU in float64 (on a host thread while the card runs
    the full-scale passes), the corrected and the smoothed outputs within
    ``PZ_TOL`` * max(1, max|ref|); the correction without its re-pin of
    the training rows must fail that limit.

    Runs eagerly, as paths V, W and X run; it is not captured: a CUDA
    graph's pool would keep the ~47 GB of ``[E, 47]`` intermediates of a
    layer reserved. It launches no port kernel: as in the JAX package,
    ``LabelPropagation`` propagates over the raw COO through
    ``MessagePassing``'s gather path (an ``index_select`` of ``[E, 47]``,
    the weighted message, and ``index_add_``, what the JAX package's XLA
    scatter becomes), not through ``spmm``."""
    from pytorch_geometric_tpu_torch.nn.models import (CorrectAndSmooth,
                                                       LabelPropagation)
    from pytorch_geometric_tpu_torch.nn.conv import gcn_norm
    tag = 'path Z'
    n, layers = N_PRODUCTS, (PZ_CS['num_correction_layers']
                             + PZ_CS['num_smoothing_layers'])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    data = products_data(torch, coo, seed)
    x, y = data.x, data.y
    ei = torch.as_tensor(coo, device='cuda')
    train = cs_train_mask(torch, n, PZ_TRAIN, seed + 90, 'cuda')
    rows = train.nonzero()[:, 0]
    model = cs_model(torch, 'cuda', seed)
    gen = torch.Generator(device='cuda').manual_seed(seed + 91)
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(PZ_STEPS + 1)]
    events[0].record()
    losses = cs_train(torch, model, x, y, rows, PZ_STEPS, gen,
                      on_step=lambda i: events[i + 1].record())
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(PZ_STEPS)]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f'{tag}: base losses {losses}')
    cs = CorrectAndSmooth(**PZ_CS)
    # the CPU reference at PZ_CHECK_SCALE from the card's trained weights,
    # on a host thread while the card runs the full-scale passes
    nc = int(N_PRODUCTS * PZ_CHECK_SCALE)
    cut = products_graph(nc, int(E_PRODUCTS * PZ_CHECK_SCALE), seed)
    train_c = cs_train_mask(torch, nc, int(round(PZ_TRAIN * PZ_CHECK_SCALE)),
                            seed + 92, 'cpu')
    xc, yc = x[:nc].contiguous(), y[:nc].contiguous()
    ref_model = cs_model(torch, 'cpu', seed)
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    ref_model.double()
    ref_in = (xc.cpu().double(), yc.cpu())
    box = {}

    def reference():
        t = time.perf_counter()
        try:
            box['ref'] = cs_post(torch, cs, cs_soft(torch, ref_model,
                                                    ref_in[0]),
                                 ref_in[1], train_c, torch.as_tensor(cut))
        except BaseException as exc:   # re-raised after the join
            box['error'] = exc
        box['seconds'] = time.perf_counter() - t

    t_ref = threading.Thread(target=reference, daemon=True)
    t_ref.start()
    y_true = torch.nn.functional.one_hot(y, PR_CLASSES).float()
    y_soft, soft_ms, _ = cs_timed(torch, lambda: cs_soft(torch, model, x))
    torch.cuda.reset_peak_memory_stats()
    stats0 = torch.cuda.memory_stats()
    with torch.no_grad():
        corrected, correct_ms, correct_host = cs_timed(
            torch, lambda: cs.correct(y_soft, y_true, train, ei))
        smoothed, smooth_ms, smooth_host = cs_timed(
            torch, lambda: cs.smooth(corrected, y_true, train, ei))
    peak = torch.cuda.max_memory_allocated()
    stats1 = torch.cuda.memory_stats()
    # a retry frees cached blocks (cudaFree, which waits for the card) to
    # fit a new allocation
    allocator = {k: stats1.get(k, 0) - stats0.get(k, 0)
                 for k in ('num_alloc_retries', 'num_device_alloc',
                           'num_device_free')}
    check(bool(torch.isfinite(smoothed).all()) and float(smoothed.min()) >= 0
          and float(smoothed.max()) <= 1, f'{tag}: the smoothed output is not '
                                          'finite within [0, 1]')
    check(bool(torch.isfinite(corrected).all()),
          f'{tag}: the corrected output is not finite')
    # one propagation layer alone: gather, weight and index_add_ over the
    # 123.7M edges at 47 columns, the normalised weights made once
    lp = LabelPropagation(1, PZ_CS['smoothing_alpha'])
    _, ew = gcn_norm(ei, None, n, add_self_loops=False)
    layer_ms = []
    with torch.no_grad():
        for _ in range(3):
            layer_ms.append(cs_timed(torch, lambda: lp.propagate(
                ei, x=y_soft, edge_weight=ew, size=(n, n)))[1])
    del ew
    # the second pass, profiled as one whole window
    second = []

    def one_pass():
        with torch.no_grad():
            c = cs.correct(y_soft, y_true, train, ei)
            second.append((c, cs.smooth(c, y_true, train, ei)))
            del second[:-1]

    t0 = time.perf_counter()
    prof_rows, prof_wall, passes = whole_window(torch, one_pass, 1,
                                                warm=False)
    prof_s = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(tag, counts, {}, 'its base steps and C&S passes')
    busy = sum(ms for _, ms, _ in prof_rows)
    launches = sum(k for _, _, k in prof_rows)
    agree = max(cs_err(torch, second[-1][0], corrected),
                cs_err(torch, second[-1][1], smoothed))
    check(agree <= PZ_TOL, f'{tag}: two passes differ by {agree} of '
                           f'max(1, max|out|)')
    del second, corrected, smoothed
    top = [{'kernel': k[:90], 'ms': ms, 'launches': c}
           for k, ms, c in prof_rows[:8]]
    res = {'nodes': n, 'edges': int(coo.shape[1]), 'train_rows': PZ_TRAIN,
           'base_losses': losses, 'base_step_ms': step_ms,
           'ms_per_base_step': float(np.median(step_ms[1:])),
           'softmax_forward_ms': soft_ms,
           'correct_ms': correct_ms, 'smooth_ms': smooth_ms,
           'ms_per_pass': correct_ms + smooth_ms,
           'host_issue_ms_per_pass': correct_host + smooth_host,
           'ms_per_layer': float(np.median(layer_ms)), 'layer_ms': layer_ms,
           'layers_per_pass': layers, 'peak_gb': peak / 1e9,
           'allocator_first_pass': allocator,
           'peak_over_start_gb': (peak - mem0) / 1e9,
           'profiled_pass': {'wall_ms': prof_wall, 'busy_ms': busy,
                             'busy_share': busy / prof_wall,
                             'idle_share': 1 - busy / prof_wall,
                             'launches': launches,
                             'launches_per_layer': launches / layers,
                             'passes_run': passes, 'seconds': prof_s,
                             'top_kernels': top},
           'passes_agree': agree, 'launch_counts': counts}
    log(f"[{tag}] base MLP {res['ms_per_base_step']:.3f} ms a step (losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}); C&S pass "
        f"{res['ms_per_pass']:.1f} ms (correct {correct_ms:.1f}, smooth "
        f"{smooth_ms:.1f}; host issue {res['host_issue_ms_per_pass']:.1f}; "
        f"allocator {allocator}), "
        f"a layer {res['ms_per_layer']:.2f} ms, peak {peak / 1e9:.2f} GB; "
        f"profiled pass {prof_wall:.1f} ms wall, busy "
        f"{res['profiled_pass']['busy_share']:.3f}, "
        f"{launches / layers:.1f} launches a layer; passes agree to "
        f'{agree:.2e}; top kernels ' + ', '.join(
            f"{r['kernel'][:40]} {r['ms']:.1f} ms x{r['launches']:g}"
            for r in top[:4]))
    del ei, y_soft, y_true
    torch.cuda.empty_cache()
    # the card's float32 at PZ_CHECK_SCALE, then the host thread's float64
    t0 = time.perf_counter()
    cut_card = torch.as_tensor(cut, device='cuda')
    soft_c = cs_soft(torch, model, xc)
    card = cs_post(torch, cs, soft_c, yc, train_c.cuda(), cut_card)
    loose = cs_post(torch, cs, soft_c, yc, train_c.cuda(), cut_card,
                    repin=False)
    t_ref.join()
    wait_s = time.perf_counter() - t0
    if 'error' in box:
        raise box['error']
    ref = box['ref']
    errs = {'corrected': cs_err(torch, card[0], ref[0]),
            'smoothed': cs_err(torch, card[1], ref[1])}
    loose_err = cs_err(torch, loose[0], ref[0])
    for what, err in errs.items():
        check(err <= PZ_TOL, f'{tag}: the {what} output at '
                             f'{PZ_CHECK_SCALE} scale is {err} of max(1, '
                             f'max|ref|) from the CPU\'s float64')
    verdict = ('passes: the limit is too loose' if loose_err <= PZ_TOL
               else 'fails, as it must')
    log(f"[{tag}] at {PZ_CHECK_SCALE} scale ({nc} nodes, {cut.shape[1]} "
        f"edges) against the CPU's float64: corrected "
        f"{errs['corrected']:.3e}, smoothed {errs['smoothed']:.3e} of "
        f"max(1, max|ref|) (limit {PZ_TOL}, margin "
        f"{PZ_TOL / max(max(errs.values()), 1e-30):.1f}x); without the "
        f're-pin {loose_err:.3e}, which {verdict}; the float64 reference '
        f"took {box['seconds']:.1f} s on its host thread, "
        f'{wait_s:.1f} s after the full-scale passes')
    check(loose_err > PZ_TOL, f'{tag}: the correction without its re-pin is '
                              f'{loose_err} from the reference and passes '
                              f'the limit {PZ_TOL}')
    res['vs_cpu'] = {'nodes': nc, 'edges': int(cut.shape[1]),
                     'train_rows': int(train_c.sum()), **errs,
                     'limit': PZ_TOL,
                     'margin': PZ_TOL / max(max(errs.values()), 1e-30),
                     'without_repin': loose_err,
                     'reference_s': box['seconds'],
                     'waited_s': wait_s}
    del data, x, y, model, card, loose
    torch.cuda.empty_cache()
    return res


# -- paths AA and AB: the point family and the kernel convolutions -------------
# path AA: DGCNN as PyG's examples/dgcnn_classification.py runs it: two
# DynamicEdgeConv (k = 20, max) over MLP([6, 64, 64, 64]) with batch norm and
# MLP([128, 128]), Linear(192, 1024), global max pooling, MLP([1024, 512,
# 256, 10], dropout 0.5, no norm), NLL of the log-softmax, Adam 1e-3, batch
# 32; on ModelNet10's shape (10 classes, SamplePoints(1024) after
# NormalizeScale). Cut: the example's StepLR schedule
PAA_CLASSES, PAA_POINTS, PAA_K, PAA_BATCH = 10, 1024, 20, 32
PAA_EDGE_MLP, PAA_EDGE_MLP2 = (64, 64, 64), (128,)
PAA_LIN, PAA_HEAD, PAA_DROPOUT = 1024, (512, 256), 0.5
PAA_LR, PAA_STEPS, PAA_EVAL_BATCHES = 1e-3, 10, 4
# the generated meshes: per class PAA_MESHES closed UV spheres of PAA_RINGS
# rings x PAA_SEGS segments (2 * rings * segs = 3,040 faces), deformed by
# the class's smooth radial bumps and axis scales
PAA_MESHES, PAA_RINGS, PAA_SEGS = 12, 38, 40
# the first batch's 3 steps against the CPU run at this many clouds: 8,192
# points, 6.7e7 pairs, past _DENSE_LIMIT, so the tiled branch runs there
# as at full size
PAA_CHECK_CLOUDS = 8
# a neighbour list of the card's knn and the CPU's may differ only where
# two candidates' float64 distances lie within this share of each other,
# or within the float32 expansion's error bound of the pair (``knn_swaps``:
# at the positions the card swapped candidates 6.5e-6 apart, relative)
PAA_SWAP_REL = 1e-6
# path AB: SplineCNN as PyG's examples/faust.py runs it: SplineConv(1, 32),
# five SplineConv(-> 64), each dim 3, kernel_size 5, degree 1, aggr 'add'
# and ELU; Linear(64, 256), ELU, dropout 0.5, Linear(256, 6890), NLL over
# the vertex ids, Adam 1e-3; on FAUST's mesh shape: 6,890 vertices, 13,776
# triangles (a UV sphere of 84 rings x 82 vertices and 2 poles), 41,328
# directed edges, pseudo-coordinates from Cartesian(), x = 1
PAB_RINGS, PAB_SEGS, PAB_NODES, PAB_EDGES = 84, 82, 6890, 41_328
PAB_CHANNELS, PAB_DIM, PAB_KERNEL = (32, 64, 64, 64, 64, 64), 3, 5
PAB_HIDDEN, PAB_DROPOUT, PAB_LR, PAB_STEPS = 256, 0.5, 1e-3, 10


def uv_sphere(rings, segs):
    """A closed triangle mesh of the unit sphere: ``rings`` rings of
    ``segs`` vertices between two poles. ``(pos [rings * segs + 2, 3]
    float64, face [3, 2 * rings * segs] int64)``; the polar angle and
    azimuth of each vertex beside."""
    theta = np.pi * np.arange(1, rings + 1) / (rings + 1)
    phi = 2 * np.pi * np.arange(segs) / segs
    th, ph = np.meshgrid(theta, phi, indexing='ij')
    th = np.concatenate([[0.0], th.reshape(-1), [np.pi]])
    ph = np.concatenate([[0.0], ph.reshape(-1), [0.0]])
    pos = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], -1)
    vid = 1 + np.arange(rings * segs).reshape(rings, segs)
    nxt = np.roll(vid, -1, axis=1)
    south = rings * segs + 1
    face = np.concatenate([
        np.stack([np.zeros(segs, np.int64), vid[0], nxt[0]]),
        np.stack([vid[:-1], vid[1:], nxt[:-1]]).reshape(3, -1),
        np.stack([nxt[:-1], vid[1:], nxt[1:]]).reshape(3, -1),
        np.stack([np.full(segs, south), nxt[-1], vid[-1]])], 1)
    return pos, face, th, ph


def bumpy(pos, th, ph, rng, terms, amp, scale=(1.0, 1.0, 1.0)):
    """``pos`` pushed along its radius by ``terms`` smooth bumps ``a sin(m
    theta + p) cos(n phi + q)`` (``a`` up to ``amp``, ``m``, ``n`` in
    1-4, seeded), then scaled per axis."""
    r = np.ones(len(pos))
    for _ in range(terms):
        a, p, q = rng.uniform(0, amp), *rng.uniform(0, 2 * np.pi, 2)
        m, n = rng.integers(1, 5, 2)
        r += a * np.sin(m * th + p) * np.cos(n * ph + q)
    return pos * r[:, None] * np.asarray(scale)


def modelnet_like(seed=0, meshes=PAA_MESHES):
    """Path AA's meshes: for each of the ``PAA_CLASSES`` classes a family
    (its seeded axis scales and 3 bump terms), ``meshes`` instances (the
    family's bumps with their own phases and axes jittered by 10 %), each
    a UV sphere of ``PAA_RINGS`` x ``PAA_SEGS`` through ``NormalizeScale``
    once. A list of ``(Data(pos, face), label)``."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.transforms import NormalizeScale
    pos0, face, th, ph = uv_sphere(PAA_RINGS, PAA_SEGS)
    norm = NormalizeScale()
    out = []
    for c in range(PAA_CLASSES):
        fam = np.random.default_rng([seed, c])
        scale = fam.uniform(0.5, 1.5, 3)
        amp = fam.uniform(0.1, 0.4)
        for i in range(meshes):
            rng = np.random.default_rng([seed, c, i])
            pos = bumpy(pos0, th, ph, rng, 3, amp,
                        scale * rng.uniform(0.9, 1.1, 3))
            out.append((norm(Data(pos=pos.astype(np.float32),
                                  face=face.astype(np.int32),
                                  num_nodes=len(pos))), c))
    return out


class CloudBatches:
    """Path AA's batches: ``batch`` clouds a batch, each a mesh drawn at
    random (seeded) through ``SamplePoints(PAA_POINTS)`` on the host when
    drawn; ``(pos [B * points, 3], batch [B * points], y [B])`` as CPU
    tensors."""

    def __init__(self, torch, meshes, batch, seed):
        from pytorch_geometric_tpu_torch.transforms import SamplePoints
        self.torch, self.meshes, self.batch = torch, meshes, batch
        self.rng = np.random.default_rng(seed)
        self.sample = SamplePoints(PAA_POINTS, seed=seed)

    def __iter__(self):
        return self

    def __next__(self):
        torch = self.torch
        pick = self.rng.integers(0, len(self.meshes), self.batch)
        pos = torch.cat([self.sample(self.meshes[i][0]).pos for i in pick])
        vec = torch.arange(self.batch).repeat_interleave(PAA_POINTS)
        y = torch.as_tensor([self.meshes[i][1] for i in pick])
        return pos, vec, y


def dgcnn_net(torch, device, seed, k=PAA_K, edge_mlp=PAA_EDGE_MLP,
              edge_mlp2=PAA_EDGE_MLP2, lin=PAA_LIN, head=PAA_HEAD,
              classes=PAA_CLASSES, dropout=PAA_DROPOUT):
    """Path AA's model: ``model(pos, batch, num_graphs, generator)``, the
    log-softmax a cloud; the head's dropout drawn from ``generator``."""
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import MLP, DynamicEdgeConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.nn.pool import global_max_pool
    device = resolve_device(device)
    kw = dict(device=device, generator=torch.Generator().manual_seed(seed))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = DynamicEdgeConv(
                MLP(6, list(edge_mlp), norm='batch_norm', **kw), k)
            self.conv2 = DynamicEdgeConv(
                MLP(2 * edge_mlp[-1], list(edge_mlp2), norm='batch_norm',
                    **kw), k)
            self.lin1 = linear(edge_mlp[-1] + edge_mlp2[-1], lin, **kw)
            self.mlp = MLP(lin, [*head, classes], dropout=dropout, **kw)

        def forward(self, pos, batch, num_graphs, generator=None):
            x1 = self.conv1(pos, batch)
            x2 = self.conv2(x1, batch)
            out = self.lin1(torch.cat([x1, x2], 1))
            out = global_max_pool(out, batch, num_graphs)
            return torch.log_softmax(self.mlp(out, generator), -1)

    return Net()


def faust_like(seed=0, rings=PAB_RINGS, segs=PAB_SEGS):
    """Path AB's mesh: a UV sphere of ``rings`` x ``segs`` vertices and 2
    poles (FAUST's 6,890 vertices and 13,776 triangles at the defaults),
    pushed along its radius by 6 seeded smooth bumps; its edges as PyG's
    ``FaceToEdge`` makes them (the faces' sides through the port's
    ``to_undirected``) and its pseudo-coordinates from the port's
    ``Cartesian()``. ``(pos, face, coo, pseudo)``, numpy and CPU tensors."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.transforms import Cartesian
    from pytorch_geometric_tpu_torch.utils import to_undirected
    pos, face, th, ph = uv_sphere(rings, segs)
    pos = bumpy(pos, th, ph, np.random.default_rng(seed), 6, 0.08)
    pos = pos.astype(np.float32)
    sides = np.concatenate([face[:2], face[1:], face[::2]], 1)
    coo = to_undirected(sides, num_nodes=len(pos))
    data = Cartesian()(Data(pos=pos, edge_index=coo.astype(np.int64),
                            num_nodes=len(pos)))
    return pos, face, coo, data.edge_attr


def spline_faust_net(torch, device, seed, channels=PAB_CHANNELS,
                     hidden=PAB_HIDDEN, classes=PAB_NODES,
                     kernel_size=PAB_KERNEL, dim=PAB_DIM, degree=1):
    """Path AB's model: ``model(x, coo, pseudo, keep)``, the log-softmax
    over the vertex ids a vertex; in training mode the dropout after
    ``lin1`` keeps the entries ``keep`` marks (drawn with ``torch.rand``
    when it is None)."""
    import torch.nn.functional as F
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import SplineConv
    from pytorch_geometric_tpu_torch.nn.inits import linear
    device = resolve_device(device)
    kw = dict(device=device, generator=torch.Generator().manual_seed(seed))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            widths = [1, *channels]
            self.convs = torch.nn.ModuleList(
                SplineConv(i, o, dim=dim, kernel_size=kernel_size,
                           degree=degree, aggr='add', **kw)
                for i, o in zip(widths[:-1], widths[1:]))
            self.lin1 = linear(channels[-1], hidden, **kw)
            self.lin2 = linear(hidden, classes, **kw)

        def forward(self, x, coo, pseudo, keep=None):
            for conv in self.convs:
                x = F.elu(conv(x, coo, pseudo))
            x = F.elu(self.lin1(x))
            if self.training:
                if keep is None:
                    keep = torch.rand(x.shape, device=x.device) >= \
                        PAB_DROPOUT
                x = x * keep / (1 - PAB_DROPOUT)
            return torch.log_softmax(self.lin2(x), -1)

    return Net()


def knn_swaps(torch, pos, got, want, valid_got, valid_want, k):
    """A card knn graph (``got``, ``[2, N * k]`` neighbour over centre)
    against the CPU's (``want``) from the same float32 points: the
    validity masks equal, and at each place where the neighbour lists
    differ, the two candidates' float64 distances to the centre within
    ``PAA_SWAP_REL`` of each other, or within the sum of the two float32
    distances' error bounds, where float32 cannot order them: the
    expansion ``|c|^2 + |x|^2 - 2 c.x`` over F features rounds to within
    ``(F + 3) 2^-24 (|c| + |x|)^2`` of the exact distance, whatever the
    order of its sums. Returns (places that differ, rows that differ, the
    worst gap over PAA_SWAP_REL, the worst over the rounding bound)."""
    check(torch.equal(valid_got, valid_want), 'knn validity masks differ')
    a = got[0].view(-1, k).cpu()
    b = want[0].view(-1, k)
    diff = a != b
    places, rows = int(diff.sum()), int(diff.any(1).sum())
    if not places:
        return 0, 0, 0.0, 0.0
    r, j = diff.nonzero(as_tuple=True)
    p = pos.double()
    c, ia, ib = p[r], p[a[r, j]], p[b[r, j]]
    da, db = ((ia - c) ** 2).sum(-1), ((ib - c) ** 2).sum(-1)
    gap = (da - db).abs()
    rel = gap / torch.maximum(da, db).clamp(min=1e-300)
    nc, na, nb = (v.norm(dim=-1) for v in (c, ia, ib))
    rounding = (p.shape[1] + 3) * 2.0 ** -24 * ((nc + na) ** 2
                                               + (nc + nb) ** 2)
    worst_rel = float((rel / PAA_SWAP_REL).max())
    worst_round = float((gap / rounding).max())
    ok = (rel <= PAA_SWAP_REL) | (gap <= rounding)
    check(bool(ok.all()), f'knn: {int((~ok).sum())} of {places} swapped '
                          'places are further apart than float32 rounding')
    return places, rows, worst_rel, worst_round


def phase_path_aa(torch, seed):
    """Path AA: DGCNN at PyG's examples/dgcnn_classification.py
    configuration on ModelNet10's shape (``PAA_*``): ``modelnet_like``'s
    meshes, each batch's 32 clouds drawn and sampled on the host
    (``CloudBatches``), ``dgcnn_net`` trained ``PAA_STEPS`` eager steps
    (Adam 1e-3, dropout from a CUDA generator): host ms a batch, card ms a
    step, no port kernel launched (``knn_graph`` is a distance product and
    top-k merges, the messages ``MessagePassing``'s gather path, as the
    JAX package computes them in XLA), a whole-window profile, busy and
    idle share, peak memory; the two ``knn_graph`` calls of a forward
    timed apart (CUDA events) beside their reckoning (every one of the
    32,768^2 pairs scored, since other clouds are masked, not skipped);
    ``PAA_EVAL_BATCHES`` eval-mode batches. Checks: the card's
    ``knn_graph`` of the whole first batch (the tiled branch) at layer 1's
    positions and layer 2's features, its rows of the first
    ``PAA_CHECK_CLOUDS`` clouds against the CPU's ``knn_graph`` of those
    clouds from the same float32 inputs (``knn_swaps``; the count of
    swapped places printed);
    the first batch cut to ``PAA_CHECK_CLOUDS`` clouds: its float32 loss
    against the CPU's within 1e-4 relative, and its 3 steps in float64 on
    both devices (``synced_parity``; the edge MLPs' batch norms run in
    training mode), the head's dropout one mask on both (a CPU generator
    reseeded for each call)."""
    from pytorch_geometric_tpu_torch.nn.pool import knn_graph
    tag = 'path AA'
    t0 = time.perf_counter()
    meshes = modelnet_like(seed)
    build_s = time.perf_counter() - t0
    faces = int(meshes[0][0].face.shape[1])
    log(f'[{tag}] {len(meshes)} meshes of {faces} faces in '
        f'{PAA_CLASSES} classes built in {build_s:.2f} s')
    loader = CloudBatches(torch, meshes, PAA_BATCH, seed)
    model = dgcnn_net(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PAA_LR)
    gen = torch.Generator(device='cuda').manual_seed(seed + 95)
    nll = torch.nn.functional.nll_loss

    def prepare(batch):
        pos, vec, y = batch
        return pos.to('cuda'), vec.to('cuda'), y.to('cuda')

    def step(pos, vec, y):
        opt.zero_grad(set_to_none=True)
        loss = nll(model(pos, vec, PAA_BATCH, gen), y)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, loader, prepare, step, PAA_STEPS)
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{PAA_STEPS} steps')
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps_s = time.perf_counter() - t0
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 1)
    res = graph_path_result(tag, host_ms, card_ms, losses, per_step,
                            prof_rows, prof_ms)
    pos, vec, y = first
    n = pos.shape[0]
    # the two knn_graph calls of a forward, timed apart
    with torch.no_grad():
        x1 = model.conv1(pos, vec)
    knn_ms = {}
    for name, pts in (('layer 1 (positions, F = 3)', pos),
                      (f'layer 2 (features, F = {x1.shape[1]})', x1)):
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            knn_graph(pts, PAA_K, vec)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        pairs = n * n
        knn_ms[name] = {'ms': ms, 'pairs': pairs,
                        'gflop': 2 * pairs * pts.shape[1] / 1e9,
                        'distance_tile_gb': 4 * pairs / 1e9}
        log(f'[{tag}] knn_graph at {name}: {np.median(ms):.3f} ms (median '
            f'of {ms}); {pairs:.3e} pairs scored, '
            f"{knn_ms[name]['gflop']:.1f} GFLOP of distance products, "
            f"{knn_ms[name]['distance_tile_gb']:.2f} GB of float32 "
            'distance tiles written once and read once')
    res.update(meshes=len(meshes), faces_per_mesh=faces, build_s=build_s,
               points=n, knn_edges_per_layer=n * PAA_K,
               launch_counts=counts, peak_memory_gb=peak, knn=knn_ms)
    log(f'[{tag}] {n} points and {n * PAA_K} knn edges a layer; peak '
        f'{peak:.3f} GB')
    # the card's knn of the full batch (the tiled branch over all 32 clouds)
    # against the CPU's: its rows of the first PAA_CHECK_CLOUDS clouds
    # against the CPU's knn_graph of those clouds (no cloud sees another,
    # so those rows are one function of the same float32 inputs; the CPU's
    # full batch took ~15 s a call on an 8-core host)
    swaps = {}
    cut = vec < PAA_CHECK_CLOUDS
    rows = int(cut.sum())
    t1 = time.perf_counter()
    for name, pts in (('positions', pos), ('features', x1)):
        got, v_got = knn_graph(pts, PAA_K, vec)
        want, v_want = knn_graph(pts[cut].cpu(), PAA_K, vec[cut].cpu())
        places, diff_rows, w_rel, w_round = knn_swaps(
            torch, pts[cut].cpu(), got[:, :rows * PAA_K],
            want, v_got[:rows * PAA_K].cpu(), v_want, PAA_K)
        swaps[name] = {'rows_compared': rows, 'places': places,
                       'rows': diff_rows,
                       'worst_gap_over_rel_limit': w_rel,
                       'worst_gap_over_rounding': w_round}
        log(f'[{tag}] knn_graph of the first batch at its {name}, card '
            f'against CPU over the {rows} rows of {PAA_CHECK_CLOUDS} '
            f'clouds: {places} swapped places in {diff_rows} rows (worst '
            f'gap {w_rel:.3e} of {PAA_SWAP_REL:g} relative, {w_round:.3e} '
            'of the float32 error bound)')
    knn_check_s = time.perf_counter() - t1
    res['knn_vs_cpu'] = swaps
    model.eval()
    res['eval_nll'] = eval_batches(
        torch, loader, prepare,
        lambda p, v, t: nll(model(p, v, PAA_BATCH), t), PAA_EVAL_BATCHES)
    log(f"[{tag}] eval-mode NLL over {PAA_EVAL_BATCHES} batches "
        f"{res['eval_nll']}")
    # the first batch cut to PAA_CHECK_CLOUDS clouds against the CPU
    small = (pos[cut], vec[cut], y[:PAA_CHECK_CLOUDS])
    small_cpu = tuple(t.cpu() for t in small)

    def loss_of(m, p, v, t):
        g = torch.Generator().manual_seed(seed + 96)
        return nll(m(p, v, PAA_CHECK_CLOUDS, g), t)

    def build(device):
        return dgcnn_net(torch, device, seed)

    t1 = time.perf_counter()
    losses = []
    for dev, batch in (('cuda', small), ('cpu', small_cpu)):
        m = build(dev)
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
        with torch.no_grad():
            losses.append(float(loss_of(m.train(), *batch)))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    log(f'[{tag}] float32 loss of the first batch at {PAA_CHECK_CLOUDS} '
        f'clouds, card {losses[0]} vs CPU {losses[1]}: relative diff '
        f'{rel:.3e} (limit 1e-4)')
    check(rel <= 1e-4, f'{tag}: float32 first-batch loss {rel} from the CPU')

    def cast(batch):
        return tuple(t.double() if t.is_floating_point() else t
                     for t in batch)

    res['first_batch_vs_cpu'] = synced_parity(
        torch, f'{tag} float64', lambda dev: build(dev).double(), state,
        cast(small), cast(small_cpu), None, loss_of, PAA_LR)
    res['first_batch_vs_cpu']['float32_loss_rel_diff'] = rel
    res['phase_s'] = {'build': build_s, 'steps': steps_s,
                      'knn_check': knn_check_s,
                      'cpu_parity': time.perf_counter() - t1}
    log(f"[{tag}] seconds: {res['phase_s']}")
    del model, opt, first, x1
    torch.cuda.empty_cache()
    return res


def phase_path_ab(torch, seed, iters):
    """Path AB: SplineCNN at PyG's examples/faust.py configuration on
    FAUST's shape (``PAB_*``, ``faust_like``): ``spline_faust_net`` trained
    ``PAB_STEPS`` eager steps (NLL over the vertex ids, Adam 1e-3, dropout
    from a CUDA generator): card ms a step (CUDA events), no port kernel
    launched (SplineConv's ``x @ weight`` for every kernel, one gather of
    the corners and ``index_add_``), a whole-window profile with busy and idle
    share, peak memory; then served in eval mode (ms a forward, ``iters``
    after 2, and a profile). Checks: 3 steps at full size against the CPU
    from the same weights (losses within 1e-4 relative, first-step
    gradients within 1e-4 of each tensor's largest), one dropout mask from
    a seeded CPU generator on both devices."""
    tag = 'path AB'
    t0 = time.perf_counter()
    pos, face, coo, pseudo = faust_like(seed)
    build_s = time.perf_counter() - t0
    n = len(pos)
    check(n == PAB_NODES and face.shape[1] == 13_776
          and coo.shape[1] == PAB_EDGES,
          f'{tag}: mesh of {n} vertices, {face.shape[1]} faces, '
          f'{coo.shape[1]} edges')
    lo, hi = float(pseudo.min()), float(pseudo.max())
    check(0.0 <= lo and hi <= 1.0, f'{tag}: pseudo-coordinates in '
                                   f'[{lo}, {hi}]')
    log(f'[{tag}] mesh of {n} vertices, {face.shape[1]} triangles, '
        f'{coo.shape[1]} directed edges, built with its Cartesian '
        f'pseudo-coordinates in {build_s:.2f} s')
    x = torch.ones((n, 1), device='cuda')
    ei = torch.as_tensor(coo, device='cuda')
    ea = pseudo.to('cuda')
    y = torch.arange(n, device='cuda')
    model = spline_faust_net(torch, None, seed)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PAB_LR)
    gen = torch.Generator(device='cuda').manual_seed(seed + 97)
    nll = torch.nn.functional.nll_loss

    def step():
        opt.zero_grad(set_to_none=True)
        keep = torch.rand((n, PAB_HIDDEN), generator=gen,
                          device='cuda') >= PAB_DROPOUT
        loss = nll(model(x, ei, ea, keep), y)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    card_ms, losses = [], []
    for _ in range(PAB_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step())
        end.record()
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end))
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f'{tag}: losses {losses}')
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{PAB_STEPS} steps')
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof_rows, prof_ms, _ = whole_window(torch, step, 1)
    busy = sum(t for _, t, _ in prof_rows)
    step_ms = float(np.median(card_ms[1:]))
    res = {'nodes': n, 'edges': int(coo.shape[1]), 'build_s': build_s,
           'steps': PAB_STEPS, 'losses': losses, 'card_ms_per_step': card_ms,
           'device_busy_ms_per_step': busy, 'profiled_ms_per_step': prof_ms,
           'device_idle_share_unprofiled': 1 - busy / step_ms,
           'peak_memory_gb_training': peak, 'launch_counts': counts,
           'kernels_per_step': [[k[:80], t, c] for k, t, c in prof_rows[:8]]}
    log(f'[{tag}] a step {step_ms:.4f} ms (median after the first; '
        f'{card_ms}), busy {busy:.4f} ms, idle '
        f"{res['device_idle_share_unprofiled']:.3f}, peak {peak:.3f} GB; "
        f'losses {losses}')
    for name, t, c in prof_rows[:8]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {name[:90]}')
    # served in eval mode
    model.eval()
    with torch.no_grad():
        def fwd():
            return model(x, ei, ea)
        for _ in range(2):
            out = fwd()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fwd()
        end.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(end) / iters
        f_rows, f_wall, _ = whole_window(torch, fwd, 5)
    check(bool(torch.isfinite(out).all()) and out.shape == (n, n),
          f'{tag}: served output {tuple(out.shape)}')
    f_busy = sum(t for _, t, _ in f_rows)
    res.update(forward_ms=fwd_ms, forward_busy_ms=f_busy,
               forward_idle_share=1 - f_busy / fwd_ms,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f'[{tag}] served: {fwd_ms:.4f} ms a forward ({iters} after 2), '
        f"busy {f_busy:.4f} ms, idle {res['forward_idle_share']:.3f}")
    # 3 steps at full size against the CPU, one dropout mask on both
    t1 = time.perf_counter()
    keep = torch.rand((n, PAB_HIDDEN), generator=torch.Generator()
                      .manual_seed(seed + 98)) >= PAB_DROPOUT
    args_cpu = (torch.ones((n, 1)), torch.as_tensor(coo), pseudo,
                torch.arange(n), keep)
    args_card = tuple(a.to('cuda') for a in args_cpu)
    runs = []
    for dev, args in (('cuda', args_card), ('cpu', args_cpu)):
        m = spline_faust_net(torch, dev, seed)
        m.load_state_dict({k: v.to(dev) for k, v in state.items()})
        m.train()
        o = torch.optim.Adam(m.parameters(), lr=PAB_LR)
        ls, g = [], None
        for i in range(PARITY_STEPS):
            o.zero_grad(set_to_none=True)
            loss = nll(m(*args[:3], args[4]), args[3])
            loss.backward()
            ls.append(loss.item())
            if i == 0:
                g = {k: v.cpu() for k, v in grads_of(torch, m).items()}
            o.step()
        runs.append((ls, g))
    res['first_steps_vs_cpu'] = check_parity(torch, tag, runs[0], runs[1],
                                             grads_too=True)
    res['phase_s'] = {'build': build_s,
                      'cpu_parity': time.perf_counter() - t1}
    log(f"[{tag}] seconds: {res['phase_s']}")
    del model, opt
    torch.cuda.empty_cache()
    return res


# -- path AC: MemPooling at PROTEINS_full's shape ------------------------------
# TU's PROTEINS_full, as PyG's examples/mem_pool.py trains on it: 1,113
# graphs, 43,471 nodes (at most 620 a graph), 162,088 directed edges
# (81,044 pairs, both ways), 3 node labels and 29 node attributes (x 32
# wide under use_node_attr), 2 classes (663 / 450). Generated
# (``proteins_like``): graph sizes log-normal, scaled to the total with
# one graph at the largest size; a random spanning path in each graph plus
# uniform pairs, each pair once, to the graph's share of the pairs; labels
# and attributes drawn per node, the attributes shifted by the label
PROTEINS_GRAPHS, PROTEINS_NODES, PROTEINS_PAIRS = 1113, 43_471, 81_044
PROTEINS_MAX, PROTEINS_LABELS, PROTEINS_ATTRS = 620, 3, 29
PROTEINS_CLASS_SHARE = 663 / 1113
# the JAX package's examples/mem_pool.py model at its widths: 2 x
# GraphConv(32) with leaky_relu, MemPooling(32, 32, heads=4,
# num_clusters=4), MemPooling(32, 2, heads=4, num_clusters=1); loss
# cross-entropy + 0.1 (KL_1 + KL_2), Adam 1e-3; PyG's MemPool example's
# batch of 20
PAC_HIDDEN, PAC_HEADS, PAC_CLUSTERS, PAC_KL = 32, 4, 4, 0.1
PAC_BATCH, PAC_STEPS, PAC_LR = 20, 20, 1e-3


def proteins_like(root, seed=0, graphs=PROTEINS_GRAPHS, nodes=PROTEINS_NODES,
                  pairs=PROTEINS_PAIRS, largest=PROTEINS_MAX,
                  name='PROTEINS_full'):
    """TU raw files at PROTEINS_full's shape under ``root/name/raw``
    (``DS_A``, ``DS_graph_indicator``, ``DS_graph_labels``,
    ``DS_node_labels``, ``DS_node_attributes``, TU's comma-and-space
    text); returns the graph sizes."""
    rng = np.random.default_rng(seed)
    sizes = np.maximum(np.rint(rng.lognormal(
        math.log(nodes / graphs) - 0.28, 0.75, graphs)), 4.0)
    big = int(rng.integers(graphs))
    rest = np.delete(np.arange(graphs), big)
    share = sizes[rest]
    for _ in range(20):
        # scaled to the total, none past the largest
        share = share * (nodes - largest) / share.sum()
        if share.max() <= largest - 1:
            break
        share = np.minimum(share, largest - 1)
    sizes = np.zeros(graphs, np.int64)
    sizes[rest] = np.floor(share)
    short = nodes - largest - int(sizes[rest].sum())
    sizes[rest[np.argsort(-(share - np.floor(share)), kind='stable')[
        :short]]] += 1
    sizes[big] = largest
    room = sizes * (sizes - 1) // 2
    want = np.minimum(np.maximum(np.floor(pairs * sizes / nodes), sizes - 1),
                      room).astype(np.int64)
    for i in rng.permutation(graphs):
        if want.sum() >= pairs:
            break
        want[i] += min(room[i] - want[i], pairs - want.sum())
    check(want.sum() == pairs, f'proteins_like: {want.sum()} pairs')
    off = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g in range(graphs):
        n, m = int(sizes[g]), int(want[g])
        perm = rng.permutation(n)
        a, b = perm[:-1], perm[1:]
        keys = set((np.minimum(a, b) * n + np.maximum(a, b)).tolist())
        while len(keys) < m:
            u = rng.integers(0, n, 2 * (m - len(keys)) + 8)
            v = rng.integers(0, n, len(u))
            for k in (np.minimum(u, v) * n + np.maximum(u, v))[u != v]:
                if len(keys) == m:
                    break
                keys.add(int(k))
        k = np.array(sorted(keys), np.int64)
        s, d = k // n, k % n
        both = np.stack([np.concatenate([s, d]), np.concatenate([d, s])])
        both = both[:, np.lexsort((both[1], both[0]))]
        edges.append(both + off[g])
    coo = np.concatenate(edges, 1) + 1
    labels = rng.integers(0, PROTEINS_LABELS, nodes)
    attrs = (rng.standard_normal((nodes, PROTEINS_ATTRS))
             + labels[:, None] * 0.5).astype(np.float32)
    graph_y = np.where(rng.random(graphs) < PROTEINS_CLASS_SHARE, 1, 2)
    raw = Path(root) / name / 'raw'
    raw.mkdir(parents=True, exist_ok=True)
    for suffix, arr, fmt in (
            ('A', coo.T, '%d'),
            ('graph_indicator', np.repeat(np.arange(1, graphs + 1), sizes),
             '%d'),
            ('graph_labels', graph_y, '%d'),
            ('node_labels', labels, '%d'),
            ('node_attributes', attrs, '%.6f')):
        np.savetxt(raw / f'{name}_{suffix}.txt', arr, fmt=fmt,
                   delimiter=', ')
    return sizes


def mem_pool_net(torch, device, seed, in_channels=PROTEINS_LABELS
                 + PROTEINS_ATTRS, hidden=PAC_HIDDEN, classes=2,
                 heads=PAC_HEADS, clusters=PAC_CLUSTERS):
    """Path AC's model, the JAX package's ``examples/mem_pool.py`` net:
    ``model(x, ei, batch, num_graphs)`` gives the logits ``[B, classes]``
    and the two poolings' summed KL loss; an ``EdgeIndex`` ``ei`` with
    its caches makes both GraphConvs aggregate on kernel 1."""
    import torch.nn.functional as F
    from pytorch_geometric_tpu_torch.backend import resolve_device
    from pytorch_geometric_tpu_torch.nn import GraphConv, MemPooling
    device = resolve_device(device)
    kw = dict(device=device, generator=torch.Generator().manual_seed(seed))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = GraphConv(in_channels, hidden, **kw)
            self.conv2 = GraphConv(hidden, hidden, **kw)
            self.pool1 = MemPooling(hidden, hidden, heads, clusters, **kw)
            self.pool2 = MemPooling(hidden, classes, heads, 1, **kw)

        def forward(self, x, ei, batch, num_graphs):
            h = F.leaky_relu(self.conv1(x, ei))
            h = F.leaky_relu(self.conv2(h, ei))
            hp, s1 = self.pool1(h, batch, num_graphs)
            out, s2 = self.pool2(hp)
            return out[:, 0], (MemPooling.kl_loss(s1)
                               + MemPooling.kl_loss(s2))

    return Net()


def phase_path_ac(torch, seed):
    """Path AC: MemPooling as the JAX package's ``examples/mem_pool.py``
    runs it, on PROTEINS_full's shape as PyG's MemPool example trains:
    ``proteins_like``'s raw files parsed by the port's
    ``TUDataset(use_node_attr=True)``, ``DataLoader(batch_size=20,
    shuffle=True, pad=False)``, each batch's ``EdgeIndex`` with its CSC and
    CSR built on the card; ``mem_pool_net``, ``PAC_STEPS`` eager steps:
    host ms a batch, card ms a step, kernel 1 three times a step (2
    forward, ``A^T g`` of layer 2: x needs no gradient), a whole-window
    profile and the idle share, the peak memory above what earlier phases
    hold; one eval pass over all 1,113 graphs; the first batch's 3 steps against the CPU
    (``synced_parity``); kernel 1 at the first batch's shapes (F = 32
    forward and ``A^T g``) against its plain version and timed."""
    import tempfile
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.datasets import TUDataset
    from pytorch_geometric_tpu_torch.loader import DataLoader
    tag = 'path AC'
    # the peak is counted over what earlier phases still hold on the card
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sizes = proteins_like(root, seed)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dataset = TUDataset(root, 'PROTEINS_full', use_node_attr=True)
        parse_s = time.perf_counter() - t0
    graphs = [dataset[i] for i in range(len(dataset))]
    n_nodes = sum(d.num_nodes for d in graphs)
    n_edges = sum(d.num_edges for d in graphs)
    check(len(graphs) == PROTEINS_GRAPHS and n_nodes == PROTEINS_NODES
          and n_edges == 2 * PROTEINS_PAIRS
          and max(d.num_nodes for d in graphs) == PROTEINS_MAX
          and graphs[0].x.shape[1] == PROTEINS_LABELS + PROTEINS_ATTRS
          and dataset.num_classes == 2,
          f'{tag}: the parsed dataset, {len(graphs)} graphs, {n_nodes} '
          f'nodes, {n_edges} edges')
    log(f'[{tag}] proteins_like: {len(graphs)} graphs, {n_nodes} nodes '
        f'({sizes.min()}-{sizes.max()} a graph), {n_edges} directed edges, '
        f'x {graphs[0].x.shape[1]} wide; raw files written in '
        f'{write_s:.2f} s, TUDataset parse {parse_s:.2f} s')
    loader = DataLoader(dataset, batch_size=PAC_BATCH, shuffle=True,
                        pad=False, seed=seed)

    def prepare(batch):
        n = batch.num_nodes
        ei = EdgeIndex(batch.edge_index.coo.to('cuda'), (n, n)).fill_cache(
            blocked=False)
        return (batch.x.to('cuda'), ei, batch.batch.to('cuda'),
                batch.y.to('cuda').long(), batch.num_graphs)

    def loss_of(model, x, ei, bvec, y, ng):
        logits, kl = model(x, ei, bvec, ng)
        return torch.nn.functional.cross_entropy(logits, y) + PAC_KL * kl

    def build(device):
        return mem_pool_net(torch, device, seed)

    model = build(None)
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=PAC_LR)

    def step(*batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    per_step_want = {'segment_spmm': 3}
    t0 = time.perf_counter()
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PAC_STEPS)
    counts = launch_counts()
    check(per_step == per_step_want,
          f'{tag}: launches in the first step {per_step}')
    check_counts(tag, counts, {k: v * PAC_STEPS
                               for k, v in per_step_want.items()},
                 f'{PAC_STEPS} steps')
    steps_s = time.perf_counter() - t0
    prof_rows, prof_ms, _ = whole_window(
        torch, lambda: step(*first), 3,
        expect={SEG_MAIN: per_step_want['segment_spmm']})
    res = graph_path_result(tag, host_ms, card_ms, losses, per_step,
                            prof_rows, prof_ms)
    res['peak_gb'] = (torch.cuda.max_memory_allocated() - held) / 1e9
    res['held_gb_at_start'] = held / 1e9
    ei = first[1]
    res.update(graphs=len(graphs), nodes=n_nodes, edges=n_edges,
               raw_write_s=write_s, tu_parse_s=parse_s,
               launch_counts=counts,
               first_batch={'graphs': first[4], 'nodes': ei.num_src_nodes,
                            'edges': ei.num_edges})
    model.eval()
    t0 = time.perf_counter()
    eval_loader = DataLoader(dataset, batch_size=PAC_BATCH, pad=False)
    acc = eval_batches(
        torch, eval_loader, prepare,
        lambda x, e, bv, y, ng: (model(x, e, bv, ng)[0].argmax(-1) == y)
        .float().sum(), len(eval_loader))
    res['eval_accuracy'] = sum(acc) / len(graphs)
    res['eval_s'] = time.perf_counter() - t0
    log(f"[{tag}] first batch {first[4]} graphs, {ei.num_src_nodes} nodes, "
        f"{ei.num_edges} edges; peak {res['peak_gb']:.3f} GB over the "
        f"{res['held_gb_at_start']:.3f} GB held at the start; eval pass "
        f"over all {len(graphs)} graphs in {res['eval_s']:.2f} s, accuracy "
        f"{res['eval_accuracy']:.4f}")
    cpu_ei = EdgeIndex(ei.coo.cpu(), ei.sparse_size,
                       device='cpu').fill_cache(blocked=False)
    cpu_batch = (first[0].cpu(), cpu_ei, first[2].cpu(), first[3].cpu(),
                 first[4])
    t0 = time.perf_counter()
    res['first_batch_vs_cpu'] = synced_parity(
        torch, tag, build, state, first, cpu_batch, None, loss_of, PAC_LR)
    res['cpu_parity_s'] = time.perf_counter() - t0
    rows, worst = kernel1_rows(torch, 'AC', ei, [
        (f'forward F={PAC_HIDDEN}', ei.csc, None, first[0]),
        (f'A^T g F={PAC_HIDDEN}', ei.csr, None, PAC_HIDDEN)], seed + 81)
    del loader, model, opt, first, dataset, graphs
    torch.cuda.empty_cache()
    return res, rows, worst


# -- path AD: the Kipf & Welling GCN on Planetoid's shapes --------------------
# The public Planetoid splits (Yang et al. 2016) as PyG's
# datasets/planetoid.py reads them and examples/gcn.py trains on them: nodes,
# bag-of-words features, classes, training rows (20 a class), the rows of
# allx (every node outside test.index's range), the isolated nodes in that
# range that tx lacks (CiteSeer's 15), and the directed edges left after
# parsing (self loops removed, duplicates merged, both directions kept)
PLANETOID = {
    'cora': dict(nodes=2708, features=1433, classes=7, train=140,
                 allx=1708, missing=0, edges=10_556),
    'citeseer': dict(nodes=3327, features=3703, classes=6, train=120,
                     allx=2312, missing=15, edges=9104),
    'pubmed': dict(nodes=19_717, features=500, classes=3, train=60,
                   allx=18_717, missing=0, edges=88_648)}
# Cora's density of words a row (49,216 of 2,708 x 1,433) and its share of
# edges inside a class (0.81); the share of a row's expected words drawn
# from its class's topic words
PLANETOID_DENSITY, PLANETOID_HOMOPHILY, PLANETOID_TOPIC = 0.0127, 0.81, 0.3
# examples/gcn.py: GCN(in, 16, classes), dropout 0.5, Adam 0.01 with weight
# decay 5e-4 on the first layer only, 200 full-batch epochs
PAD_HIDDEN, PAD_DROPOUT, PAD_LR, PAD_WD, PAD_EPOCHS = 16, 0.5, 0.01, 5e-4, 200
PAD_TRAIN = ('cora', 'pubmed')
# the card's and the CPU's final test accuracies may differ by this many of
# the 1,000 test nodes (the same weights and dropout masks)
PAD_ACC_NODES = 5


def planetoid_raw(root, name, seed=0, shape=None):
    """Planetoid's raw files at a dataset's published shape (``PLANETOID``;
    ``shape`` overrides its entries) under ``root/<name>/raw``, in the real
    format: ``ind.<name>.{x,tx,allx}`` pickled scipy CSR matrices of binary
    bag-of-words rows (``PLANETOID_DENSITY``), ``{y,ty,ally}`` one-hot
    arrays, ``graph`` a dict of neighbour lists (symmetric, salted with self
    loops and duplicate entries), ``test.index`` the test ids shuffled, the
    ``missing`` ids of the test range absent from it and from ``tx``
    (isolated). Labels are planted: ``train / classes`` training rows a
    class, every class with its own topic words (``PLANETOID_TOPIC`` of a
    row's expected words), edges inside a class with probability
    ``PLANETOID_HOMOPHILY``. Returns the shape used."""
    import pickle
    import scipy.sparse as sp
    name = name.lower()
    s = dict(PLANETOID[name], **(shape or {}))
    n, f, c = s['nodes'], s['features'], s['classes']
    n_all, train, pairs = s['allx'], s['train'], s['edges'] // 2
    rng = np.random.default_rng(seed)
    missing = np.sort(rng.choice(np.arange(n_all + 1, n - 1), s['missing'],
                                 replace=False))
    y = rng.integers(0, c, n)
    y[:train] = rng.permutation(np.arange(train) % c)
    y[missing] = 0
    k = max(4, f // (2 * c))
    topics = np.stack([rng.choice(f, k, replace=False) for _ in range(c)])
    words = PLANETOID_DENSITY * f
    probs = np.full((c, f), words * (1 - PLANETOID_TOPIC) / (f - k),
                    np.float32)
    probs[np.arange(c)[:, None], topics] = words * PLANETOID_TOPIC / k
    x = rng.random((n, f), dtype=np.float32) < probs[y]
    empty = np.nonzero(~x.any(1))[0]
    x[empty, topics[y[empty], rng.integers(0, k, len(empty))]] = True
    x[missing] = False
    ok = np.setdiff1d(np.arange(n), missing)
    by_class = [ok[y[ok] == j] for j in range(c)]
    keys = np.zeros(0, np.int64)
    while len(keys) < pairs:
        m = 2 * (pairs - len(keys)) + 64
        u, v = rng.choice(ok, m), rng.choice(ok, m)
        same = rng.random(m) < PLANETOID_HOMOPHILY
        for j in range(c):
            sel = same & (y[u] == j)
            v[sel] = rng.choice(by_class[j], int(sel.sum()))
        keep = u != v
        new = np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep]
        uniq, first = np.unique(np.concatenate([keys, new]),
                                return_index=True)
        keys = uniq[np.argsort(first, kind='stable')][:pairs]
    a, b = keys // n, keys % n
    src, dst = np.concatenate([a, b]), np.concatenate([b, a])
    loops = rng.choice(ok, max(1, n // 100), replace=False)
    dup = rng.choice(len(src), max(1, len(src) // 100), replace=False)
    src = np.concatenate([src, loops, src[dup]])
    dst = np.concatenate([dst, loops, dst[dup]])
    perm = rng.permutation(len(src))
    src, dst = src[perm], dst[perm]
    order = np.argsort(src, kind='stable')
    ptr = np.searchsorted(src[order], np.arange(n + 1))
    nbrs = dst[order]
    graph = {i: nbrs[ptr[i]:ptr[i + 1]].tolist() for i in range(n)}
    test = rng.permutation(np.setdiff1d(np.arange(n_all, n), missing))
    onehot = np.eye(c, dtype=np.int32)
    raw = Path(root) / name / 'raw'
    raw.mkdir(parents=True, exist_ok=True)
    for part, obj in (
            ('x', sp.csr_matrix(x[:train], dtype=np.float32)),
            ('tx', sp.csr_matrix(x[test], dtype=np.float32)),
            ('allx', sp.csr_matrix(x[:n_all], dtype=np.float32)),
            ('y', onehot[y[:train]]), ('ty', onehot[y[test]]),
            ('ally', onehot[y[:n_all]]), ('graph', graph)):
        with open(raw / f'ind.{name}.{part}', 'wb') as fh:
            pickle.dump(obj, fh, protocol=2)
    (raw / f'ind.{name}.test.index').write_text(
        ''.join(f'{int(i)}\n' for i in test))
    return dict(s, test=len(test), missing_ids=missing.tolist())


def planetoid_gcn(torch, device, seed, in_channels, classes,
                  dropout=PAD_DROPOUT):
    """Path AD's model, PyG's ``examples/gcn.py`` on the port's ``GCN``:
    two GCNConv layers (``in -> 16 -> classes``) over the normalisation
    computed once (``gcn_norm``, as ``cached=True`` does) and carried as
    edge weights: ``normalize=False, add_self_loops=False``, kernel 1 on the
    ``EdgeIndex``'s CSC forward and its CSR for ``A^T g``."""
    from pytorch_geometric_tpu_torch.nn.models import GCN
    return GCN(in_channels, PAD_HIDDEN, 2, classes, dropout=dropout,
               conv_kwargs={'normalize': False, 'add_self_loops': False},
               device=device, generator=torch.Generator().manual_seed(seed))


def planetoid_opt(torch, model):
    """Adam 0.01, weight decay 5e-4 on the first layer only, as PyG's
    example applies it."""
    return torch.optim.Adam([
        {'params': model.convs[0].parameters(), 'weight_decay': PAD_WD},
        {'params': model.convs[1].parameters(), 'weight_decay': 0.0}],
        lr=PAD_LR)


def planetoid_inputs(torch, data, device):
    """``(x, EdgeIndex, edge weights, y, train / val / test indices)`` on
    ``device``: the GCN normalisation with self loops computed there once
    (``gcn_norm``), the ``EdgeIndex``'s CSC and CSR built there."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import gcn_norm
    n = data.num_nodes
    coo, w = gcn_norm(data.edge_index.to(device), None, n)
    ei = EdgeIndex(coo, (n, n), device=device).fill_cache(blocked=False)
    idx = [torch.nonzero(m).view(-1).to(device)
           for m in (data.train_mask, data.val_mask, data.test_mask)]
    return (data.x.to(device), ei, w, data.y.to(device).long(), *idx)


def planetoid_loss(torch, model, x, ei, w, y, train, generator=None):
    out = model(x, ei, w, generator=generator)
    return torch.nn.functional.cross_entropy(out[train], y[train])


def planetoid_epochs(torch, model, inputs, epochs, seed):
    """``epochs`` full-batch steps of ``model`` on ``inputs`` with the
    dropout masks drawn from one CPU generator seeded ``seed``, each
    followed by an eval-mode forward: the losses, the train / val / test
    correct counts an epoch, and where the inputs lie on the card, the
    card ms a step (CUDA events), the host ms until each step returns, and
    the launches of the first step."""
    x, ei, w, y, tr, va, te = inputs
    cuda = x.device.type == 'cuda'
    opt = planetoid_opt(torch, model)
    gen = torch.Generator().manual_seed(seed)
    losses, correct, card_ms, host_ms, per_step = [], [], [], [], None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
    for i in range(epochs):
        model.train()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        opt.zero_grad(set_to_none=True)
        loss = planetoid_loss(torch, model, x, ei, w, y, tr, gen)
        loss.backward()
        opt.step()
        if cuda:
            end.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            card_ms.append(start.elapsed_time(end))
            if i == 0:
                per_step = {k: v for k, v in launch_counts().items() if v}
        losses.append(loss.detach())
        model.eval()
        with torch.no_grad():
            pred = model(x, ei, w).argmax(-1)
            correct.append(torch.stack([(pred[m] == y[m]).sum()
                                        for m in (tr, va, te)]))
    losses = torch.stack(losses).cpu().tolist()
    correct = torch.stack(correct).cpu().numpy()
    check(all(math.isfinite(v) for v in losses), f'losses {losses}')
    return losses, correct, card_ms, host_ms, per_step


def phase_path_ad(torch, seed):
    """Path AD: the Kipf & Welling GCN as PyG's ``examples/gcn.py`` trains
    it, on Planetoid's published shapes. ``planetoid_raw`` writes Cora's,
    CiteSeer's and PubMed's raw files; the port's ``Planetoid`` parses each
    (seconds, and the counts against ``PLANETOID``: CiteSeer takes the
    refill branch). On Cora and PubMed, ``NormalizeFeatures`` and
    ``planetoid_gcn`` (dropout 0.5, Adam 0.01, first-layer weight decay),
    ``PAD_EPOCHS`` full-batch epochs on the card: card ms a step, host ms a
    step, kernel 1 four times a step (forward at F = 16 and classes, ``A^T
    g`` at both), a whole-window profile and its idle share, the peak
    memory above what earlier phases hold; the same epochs on the CPU from
    the same weights and dropout masks (one seeded CPU generator), the
    final and best-validation test accuracies within ``PAD_ACC_NODES``
    nodes; 3 steps without dropout against the CPU (``synced_parity``);
    kernel 1 at Cora's four shapes and PubMed's F = 3 against its plain
    version, timed beside it and ``torch.sparse.mm``."""
    import tempfile
    from pytorch_geometric_tpu_torch.datasets import Planetoid
    from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures
    tag = 'path AD'
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res, rows, worst, datasets = {'datasets': {}}, [], 0.0, {}
    with tempfile.TemporaryDirectory() as root:
        for name in PLANETOID:
            t0 = time.perf_counter()
            s = planetoid_raw(root, name, seed)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ds = Planetoid(root, name, transform=NormalizeFeatures())
            parse_s = time.perf_counter() - t0
            d = ds[0]
            got = {'nodes': d.num_nodes, 'features': d.num_node_features,
                   'classes': ds.num_classes,
                   'train': int(d.train_mask.sum()),
                   'val': int(d.val_mask.sum()),
                   'test': int(d.test_mask.sum()), 'edges': d.num_edges}
            # the JAX package's refill marks every id of the test range a
            # test node, the 15 isolated ones too (PyG's keeps the 1,000)
            want = {k: s[k] for k in ('nodes', 'features', 'classes',
                                      'train', 'edges')}
            want.update(val=500, test=1000 + s['missing'])
            check(got == want, f'{tag}: {name} parsed to {got}, expected '
                               f'{want}')
            res['datasets'][name] = dict(got, raw_write_s=write_s,
                                         parse_s=parse_s,
                                         missing=s['missing'])
            log(f'[{tag}] {name}: raw files written in {write_s:.2f} s, '
                f'Planetoid parse {parse_s:.2f} s: {got}')
            datasets[name] = (d, ds.num_classes)
    for name in PAD_TRAIN:
        d, classes = datasets[name]
        f = d.num_node_features

        def build(device, dropout=PAD_DROPOUT):
            return planetoid_gcn(torch, device, seed, f, classes, dropout)

        state = {k: v.detach().cpu().clone()
                 for k, v in build('cpu').state_dict().items()}
        card_in = planetoid_inputs(torch, d, 'cuda')
        cpu_in = planetoid_inputs(torch, d, 'cpu')
        model = build('cuda')
        model.load_state_dict({k: v.cuda() for k, v in state.items()})
        t0 = time.perf_counter()
        losses, correct, card_ms, host_ms, per_step = planetoid_epochs(
            torch, model, card_in, PAD_EPOCHS, seed + 91)
        card_s = time.perf_counter() - t0
        counts = launch_counts()
        check(per_step == {'segment_spmm': 4},
              f'{tag} {name}: launches in the first step {per_step}')
        # 4 a step, 2 an eval-mode forward
        check_counts(f'{tag} {name}', counts,
                     {'segment_spmm': 6 * PAD_EPOCHS},
                     f'{PAD_EPOCHS} epochs')
        x, ei, w, y, tr = card_in[:5]
        opt = planetoid_opt(torch, model)
        model.train()

        def step():
            opt.zero_grad(set_to_none=True)
            loss = planetoid_loss(torch, model, x, ei, w, y, tr)
            loss.backward()
            opt.step()
            return loss.detach()
        prof_rows, prof_ms, _ = whole_window(torch, step, 3,
                                             expect={SEG_MAIN: 4})
        busy = sum(t for _, t, _ in prof_rows)
        cpu_model = build('cpu')
        cpu_model.load_state_dict(state)
        t0 = time.perf_counter()
        cpu_losses, cpu_correct, _, _, _ = planetoid_epochs(
            torch, cpu_model, cpu_in, PAD_EPOCHS, seed + 91)
        cpu_s = time.perf_counter() - t0
        n_test = len(cpu_in[6])
        best = int(np.argmax(correct[:, 1]))
        cpu_best = int(np.argmax(cpu_correct[:, 1]))
        acc = {'card_final': correct[-1, 2] / n_test,
               'cpu_final': cpu_correct[-1, 2] / n_test,
               'card_best_val': correct[best, 2] / n_test,
               'cpu_best_val': cpu_correct[cpu_best, 2] / n_test,
               'card_best_epoch': best, 'cpu_best_epoch': cpu_best}
        check(abs(int(correct[-1, 2]) - int(cpu_correct[-1, 2]))
              <= PAD_ACC_NODES,
              f'{tag} {name}: final test accuracy {acc} on the card and '
              f'the CPU differ by more than {PAD_ACC_NODES} nodes')
        out = {'nodes': d.num_nodes, 'edges_with_loops': ei.num_edges,
               'features': f, 'classes': classes, 'epochs': PAD_EPOCHS,
               'card_s': card_s, 'cpu_s': cpu_s,
               'losses_first_last': [losses[0], losses[-1]],
               'cpu_losses_first_last': [cpu_losses[0], cpu_losses[-1]],
               'accuracy': {k: float(v) for k, v in acc.items()},
               'card_ms_per_step': float(np.median(card_ms[1:])),
               'card_ms_first_steps': card_ms[:5],
               'host_ms_per_step': float(np.median(host_ms[1:])),
               'launch_counts': counts, 'launches_per_step': per_step,
               'device_busy_ms_per_step': busy,
               'profiled_ms_per_step': prof_ms,
               'kernel1_ms_per_step': sum(t for n_, t, _ in prof_rows
                                          if SEG_MAIN in n_),
               'kernels_per_step': [[n_[:80], t, c]
                                    for n_, t, c in prof_rows[:8]]}
        out['device_idle_share_unprofiled'] = 1 - busy / out[
            'card_ms_per_step']
        log(f"[{tag}] {name}: {PAD_EPOCHS} epochs in {card_s:.2f} s on the "
            f"card ({cpu_s:.2f} s on the CPU); card "
            f"{out['card_ms_per_step']:.4f} ms a step (median after the "
            f"first), host {out['host_ms_per_step']:.4f} ms until a step "
            f"returns, busy {busy:.4f} ms, idle "
            f"{out['device_idle_share_unprofiled']:.3f}, kernel 1 "
            f"{out['kernel1_ms_per_step']:.4f} ms in {per_step} launches a "
            f"step; loss {losses[0]:.4f} -> {losses[-1]:.4f}; test accuracy "
            f"final {acc['card_final']:.4f} (CPU {acc['cpu_final']:.4f}), "
            f"at the best validation {acc['card_best_val']:.4f} (CPU "
            f"{acc['cpu_best_val']:.4f}; epochs {best} / {cpu_best})")
        for n_, t, c in prof_rows[:8]:
            log(f'[{tag}]   {t:.4f} ms  x{c:g}  {n_[:90]}')
        t0 = time.perf_counter()
        out['steps_vs_cpu'] = synced_parity(
            torch, f'{tag} {name}', lambda dev: build(dev, 0.0), state,
            card_in[:5], cpu_in[:5], None,
            lambda m, *b: planetoid_loss(torch, m, *b), PAD_LR,
            opt_of=lambda m: planetoid_opt(torch, m))
        out['cpu_parity_s'] = time.perf_counter() - t0
        res[name] = out
        # the hidden width on Cora; the class widths, odd, on both
        widths = (classes,) if name == 'pubmed' else (PAD_HIDDEN, classes)
        r, err = kernel1_rows(torch, f'AD {name}', ei, [
            (f'weighted {p} F={width}', lay, w[lay.perm].contiguous(), width)
            for width in widths
            for p, lay in (('forward', ei.csc), ('A^T g', ei.csr))],
            seed + 93)
        rows += r
        worst = max(worst, err)
        del model, cpu_model, opt, card_in, cpu_in, x, ei, w, y, tr
    res['peak_gb'] = (torch.cuda.max_memory_allocated() - held) / 1e9
    res['held_gb_at_start'] = held / 1e9
    res['launch_counts'] = {k: sum(res[n]['launch_counts'].get(k, 0)
                                   for n in PAD_TRAIN)
                            for k in res[PAD_TRAIN[0]]['launch_counts']}
    res['launches_per_step'] = res[PAD_TRAIN[0]]['launches_per_step']
    log(f"[{tag}] peak {res['peak_gb']:.3f} GB over the "
        f"{res['held_gb_at_start']:.3f} GB held at the start")
    torch.cuda.empty_cache()
    return res, rows, worst


# -- path AE: DimeNet++ and SchNet on QM9's shape ------------------------------
# QM9 (Ramakrishnan et al. 2014) as PyG's datasets/qm9.py reads it: 130,831
# molecules of at most 9 heavy atoms (C, N, O, F) and 29 atoms in all, 18.0
# atoms a molecule on average; gdb9.sdf.csv's 15 target columns after
# mol_id, U0 (Hartree) the 11th. Path AE keeps 10,000 molecules
QM9_MOLECULES = 10_000
QM9_MAX_HEAVY, QM9_MAX_ATOMS = 9, 29
QM9_TARGETS = ('A', 'B', 'C', 'mu', 'alpha', 'homo', 'lumo', 'gap', 'r2',
               'zpve', 'u0', 'u298', 'h298', 'g298', 'cv')
QM9_U0 = QM9_TARGETS.index('u0')
# the heavy atoms a molecule (QM9: most have 9), the elements of a heavy
# atom, their valences, and the bond orders of a tree bond (MDL types 1-3
# and 4, aromatic, which takes one valence here)
QM9_HEAVY_P = {9: 0.83, 8: 0.12, 7: 0.03, 6: 0.01, 5: 0.005, 4: 0.003,
               3: 0.001, 2: 0.0005, 1: 0.0005}
QM9_ELEMENTS = (('C', 0.72, 4), ('N', 0.115, 3), ('O', 0.16, 2),
                ('F', 0.005, 1))
QM9_BONDS = ((1, 0.7), (2, 0.16), (3, 0.06), (4, 0.08))
# ring closures a molecule: 0, 1, 2, 3
QM9_RINGS_P = (0.2, 0.35, 0.3, 0.15)
# bond lengths (Angstrom) by MDL type, and of a bond to hydrogen; a new atom
# is placed at least QM9_CLEAR from every atom but its parent (a geminal
# H-H pair sits 1.78 apart, a 1-3 heavy pair ~2.5), and no two atoms of a
# molecule come closer than QM9_MIN_DIST
QM9_LENGTHS = {1: (1.43, 1.54), 2: (1.20, 1.34), 3: (1.16, 1.20),
               4: (1.37, 1.40), 'H': (0.96, 1.09)}
QM9_CLEAR, QM9_MIN_DIST = 1.8, 0.9
# QM9's U0 of the free atoms (Hartree), PyG's qm9.py atomref
QM9_ATOM_U0 = {'H': -0.500273, 'C': -37.846772, 'N': -54.583861,
               'O': -75.064579, 'F': -99.718730}
# PyG's qm9_pretrained_dimenet.py / qm9_pretrained_schnet.py evaluate in
# batches of 32; DimeNetPlusPlus.from_qm9_pretrained's and SchNet's default
# configurations
PAE_BATCH = 32
PAE_DIMENET = dict(hidden_channels=128, out_channels=1, num_blocks=4,
                   int_emb_size=64, basis_emb_size=8, out_emb_channels=256,
                   num_spherical=7, num_radial=6, cutoff=5.0,
                   envelope_exponent=5, num_before_skip=1, num_after_skip=2,
                   num_output_layers=3)
PAE_SCHNET = dict(hidden_channels=128, num_filters=128, num_interactions=6,
                  num_gaussians=50, cutoff=10.0, max_num_neighbors=32)
# serving: eval batches after warm-up ones; training: Adam steps after a
# warm-up one at 1e-3, DimeNet++'s rising linearly over its first 3,000
# steps (the DimeNet++ paper's schedule; from its zero output layers, a
# first step at the full rate throws the outputs to ~1e4 on these batches)
PAE_SERVE_WARM, PAE_SERVE = 2, 20
PAE_TRAIN_WARM, PAE_TRAIN = 1, 10
PAE_LR, PAE_LR_WARMUP = 1e-3, {'dimenet++': 3000, 'schnet': 1}
# the float32 serving outputs of the first batch, card against CPU, within
# this share of max(1, max|CPU|) (PERF.md, path AE's prediction)
PAE_SERVE_TOL = {'dimenet++': 1e-4, 'schnet': 1e-5}


def qm9_molecules(count, seed=0):
    """``count`` molecules at QM9's shape: per molecule the element symbols
    (heavy atoms first, then hydrogens), the bonds ``(a, b, MDL type)`` of
    a tree over the heavy atoms with each hydrogen on the atom whose
    valence it fills (at most ``QM9_MAX_ATOMS`` atoms), and coordinates
    from a bonded walk: each atom at its bond length (``QM9_LENGTHS``) from
    its parent in a random direction drawn until it clears every other
    atom by ``QM9_CLEAR`` (the best of 40 draws otherwise), rounded to the
    SDF's 4 decimals; a molecule with two atoms closer than
    ``QM9_MIN_DIST`` is drawn again. The placements run over all molecules
    at once, one atom slot at a time. Returns ``(symbols, bonds, pos)``
    lists."""
    rng = np.random.default_rng(seed)
    heavy_n = np.array(list(QM9_HEAVY_P))
    heavy_p = np.array(list(QM9_HEAVY_P.values()))
    el_names = [e[0] for e in QM9_ELEMENTS]
    el_p = np.array([e[1] for e in QM9_ELEMENTS])
    valence = {e[0]: e[2] for e in QM9_ELEMENTS}
    orders = np.array([b[0] for b in QM9_BONDS])
    order_p = np.array([b[1] for b in QM9_BONDS])
    symbols, bonds, parents, lengths = [], [], [], []
    heavy = rng.choice(heavy_n, count, p=heavy_p / heavy_p.sum())
    # uniform draws in bulk: a molecule's slot, attempt, (element, parent,
    # order); the first attempt whose bond fits both valences and leaves a
    # free valence for the atoms still to come is taken (a carbon on a
    # single bond always does)
    draws = rng.random((count, QM9_MAX_HEAVY, 8, 3))
    el_at = np.searchsorted(np.cumsum(el_p) / el_p.sum(), draws[..., 0])
    order_at = orders[np.searchsorted(np.cumsum(order_p) / order_p.sum(),
                                      draws[..., 2])]
    ring_at = rng.choice(len(QM9_RINGS_P), count, p=QM9_RINGS_P)
    for i in range(count):
        h = int(heavy[i])
        els = [el_names[min(el_at[i, 0, 0], len(el_names) - 1)]]
        free = [valence[els[0]]]
        bnd, par, ln, linked = [], [-1], [0.0], set()
        for t in range(1, h):
            cand = [a for a in range(t) if free[a] >= 1]
            left = sum(free)
            for k in range(draws.shape[2]):
                e = el_names[min(el_at[i, t, k], len(el_names) - 1)]
                a = cand[int(draws[i, t, k, 1] * len(cand))]
                o = int(order_at[i, t, k])
                take = 1 if o == 4 else o
                if take <= min(free[a], valence[e]) and (
                        t == h - 1 or left - 2 * take + valence[e] >= 1):
                    break
            else:
                e, a, o, take = 'C', cand[0], 1, 1
            els.append(e)
            free[a] -= take
            free.append(valence[e] - take)
            bnd.append((a, t, o))
            linked.add((a, t))
            par.append(a)
            ln.append(rng.uniform(*QM9_LENGTHS[o]))
        # ring closures: bonds between two heavy atoms not yet bonded, each
        # with a free valence
        for _ in range(int(ring_at[i])):
            pairs = [(a, b) for a in range(h) for b in range(a + 1, h)
                     if free[a] >= 1 and free[b] >= 1
                     and (a, b) not in linked]
            if not pairs:
                break
            a, b = pairs[int(rng.integers(len(pairs)))]
            o = 2 if min(free[a], free[b]) >= 2 and rng.random() < 0.3 \
                else (4 if rng.random() < 0.4 else 1)
            take = 1 if o == 4 else o
            free[a] -= take
            free[b] -= take
            bnd.append((a, b, o))
            linked.add((a, b))
        sym = list(els)
        for a in range(h):
            for _ in range(free[a]):
                if len(sym) == QM9_MAX_ATOMS:
                    break
                bnd.append((a, len(sym), 1))
                par.append(a)
                ln.append(rng.uniform(*QM9_LENGTHS['H']))
                sym.append('H')
        symbols.append(sym)
        bonds.append(bnd)
        parents.append(par)
        lengths.append(ln)
    pos = _qm9_walk(rng, parents, lengths)
    for i in range(count):
        while _min_dist(pos[i]) < QM9_MIN_DIST:
            pos[i] = _qm9_walk(rng, parents[i:i + 1], lengths[i:i + 1])[0]
    return symbols, bonds, pos


def _min_dist(p):
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    d[np.arange(len(p)), np.arange(len(p))] = np.inf
    return float(d.min()) if len(p) > 1 else np.inf


def _qm9_walk(rng, parents, lengths, tries=40):
    """The bonded walk of ``qm9_molecules`` over every molecule at once:
    slot ``t`` of each molecule that has one is placed from its parent in
    turn, earlier slots fixed."""
    m = len(parents)
    size = np.array([len(p) for p in parents])
    top = int(size.max())
    par = np.zeros((m, top), np.int64)
    ln = np.zeros((m, top))
    for i, (p, l) in enumerate(zip(parents, lengths)):
        par[i, :len(p)], ln[i, :len(l)] = p, l
    pos = np.zeros((m, top, 3))
    for t in range(1, top):
        rows = np.nonzero(size > t)[0]
        best = np.full(len(rows), -1.0)
        best_p = np.zeros((len(rows), 3))
        todo = np.arange(len(rows))
        anchor = pos[rows, par[rows, t]]
        others = np.arange(t)[None, :] != par[rows, t][:, None]   # [R, t]
        for _ in range(tries):
            d = rng.standard_normal((len(todo), 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            cand = anchor[todo] + d * ln[rows[todo], t][:, None]
            gap = np.linalg.norm(pos[rows[todo], :t] - cand[:, None], axis=-1)
            gap = np.where(others[todo], gap, np.inf).min(1)
            better = gap > best[todo]
            best[todo[better]] = gap[better]
            best_p[todo[better]] = cand[better]
            todo = todo[best[todo] < QM9_CLEAR]
            if not len(todo):
                break
        pos[rows, t] = best_p
    return [np.round(pos[i, :size[i]], 4) for i in range(m)]


def qm9_raw(root, count=QM9_MOLECULES, seed=0):
    """QM9's raw files at its published shape under ``root/raw``:
    ``gdb9.sdf``, one V2000 block a molecule of ``qm9_molecules`` (the
    header's three lines, the counts line, the atom block, the bond block,
    ``M  END``) separated by ``$$$$``, and ``gdb9.sdf.csv``, ``mol_id`` and
    the 15 targets of ``QM9_TARGETS`` in the layout ``QM9`` reads. U0 is the
    free atoms' U0 (``QM9_ATOM_U0``) less about 0.1 Hartree a bond (QM9's
    atomisation energies), the other targets drawn at their scale. Returns
    what was written: atoms and heavy atoms a molecule, bonds by type, the
    U0 column."""
    raw = Path(root) / 'raw'
    raw.mkdir(parents=True, exist_ok=True)
    symbols, bonds, pos = qm9_molecules(count, seed)
    rng = np.random.default_rng(seed + 1)
    blocks, rows = [], ['mol_id,' + ','.join(QM9_TARGETS)]
    u0 = np.zeros(count)
    for i, (sym, bnd, p) in enumerate(zip(symbols, bonds, pos)):
        lines = [f'gdb_{i + 1}', '     synthetic      3D', '',
                 f'{len(sym):3d}{len(bnd):3d}  0  0  0  0  0  0  0  0999 '
                 'V2000']
        lines += [f'{x:10.4f}{y:10.4f}{z:10.4f} {s:<3} 0  0  0  0  0  0  0  '
                  '0  0  0  0  0' for (x, y, z), s in zip(p, sym)]
        lines += [f'{a + 1:3d}{b + 1:3d}{o:3d}  0' for a, b, o in bnd]
        lines.append('M  END')
        blocks.append('\n'.join(lines) + '\n$$$$\n')
        u0[i] = (sum(QM9_ATOM_U0[s] for s in sym)
                 - len(bnd) * rng.uniform(0.08, 0.12))
        t = rng.standard_normal(len(QM9_TARGETS))
        t[QM9_U0] = u0[i]
        rows.append(f'gdb_{i + 1},' + ','.join(f'{v:.6f}' for v in t))
    (raw / 'gdb9.sdf').write_text(''.join(blocks))
    (raw / 'gdb9.sdf.csv').write_text('\n'.join(rows) + '\n')
    types = np.bincount([o for bnd in bonds for _, _, o in bnd], minlength=5)
    return {'molecules': count,
            'atoms': np.array([len(s) for s in symbols]),
            'heavy': np.array([sum(x != 'H' for x in s) for s in symbols]),
            'bond_types': types[1:].tolist(),
            'u0': np.array([float(f'{v:.6f}') for v in u0])}


def qm9_model(torch, name, device, seed):
    """Path AE's models: ``'dimenet++'``, PyG's
    ``DimeNetPlusPlus.from_qm9_pretrained`` configuration (``PAE_DIMENET``),
    or ``'schnet'``, PyG's SchNet defaults (``PAE_SCHNET``); random weights
    from ``seed``."""
    from pytorch_geometric_tpu_torch.nn.models import DimeNetPlusPlus, SchNet
    cls, cfg = ((DimeNetPlusPlus, PAE_DIMENET) if name == 'dimenet++'
                else (SchNet, PAE_SCHNET))
    return cls(**cfg, device=device,
               generator=torch.Generator().manual_seed(seed))


def qm9_inputs(torch, name, batch, device, u0_mean, u0_std,
               prepare_ms=None):
    """One batch of ``QM9`` graphs as path AE's model ``name`` takes it on
    ``device``: ``(z, pos[, coo, idx_kj, idx_ji, triplet_mask], batch,
    num_graphs, y)``, y the standardised U0. DimeNet++'s interaction graph
    and triplets are built on the host (``DimeNet.prepare``), their ms
    appended to ``prepare_ms``."""
    from pytorch_geometric_tpu_torch.nn.models import DimeNet
    z, pos, bvec = batch.z, batch.pos, batch.batch
    y = ((batch.y[:, QM9_U0].double() - u0_mean) / u0_std).float()
    args = [z, pos]
    if name == 'dimenet++':
        t0 = time.perf_counter()
        host = DimeNet.prepare(pos.numpy(), bvec.numpy(),
                               PAE_DIMENET['cutoff'])
        if prepare_ms is not None:
            prepare_ms.append((time.perf_counter() - t0) * 1e3)
        args += [torch.from_numpy(a) for a in host]
    args.append(bvec)
    return tuple(a.to(device, non_blocking=True) for a in args) + (
        batch.num_graphs, y.to(device, non_blocking=True))


def qm9_loss(model, *batch):
    """The L1 loss of the standardised U0 (``batch`` as ``qm9_inputs``
    gives it)."""
    *args, num_graphs, y = batch
    return (model(*args, num_graphs).view(-1) - y).abs().mean()


def check_qm9_parse(torch, tag, ds, written):
    """The port's ``QM9`` parse of ``qm9_raw``'s files: a graph a molecule,
    its atoms, its bonds in both directions by type, and U0 as written."""
    atoms = np.array([d.num_nodes for d in ds])
    check(len(ds) == written['molecules'] and np.array_equal(
        atoms, written['atoms']), f'{tag}: QM9 parsed {len(ds)} graphs, '
                                  f'{atoms.sum()} atoms')
    types = torch.cat([d.edge_attr for d in ds]).sum(0).long().tolist()
    check(types == [2 * t for t in written['bond_types']],
          f'{tag}: bonds by type {types}, written '
          f"{written['bond_types']} (each in both directions)")
    u0 = torch.cat([d.y[:, QM9_U0] for d in ds]).numpy()
    check(np.array_equal(u0, written['u0'].astype(np.float32)),
          f'{tag}: the parsed U0 column differs from the written one')
    heavy = np.array([int((d.z > 1).sum()) for d in ds])
    check(heavy.max() <= QM9_MAX_HEAVY and atoms.max() <= QM9_MAX_ATOMS,
          f'{tag}: molecules of up to {heavy.max()} heavy atoms and '
          f'{atoms.max()} atoms')
    return {'molecules': len(ds), 'atoms_mean': float(atoms.mean()),
            'atoms_max': int(atoms.max()), 'heavy_mean': float(heavy.mean()),
            'bonds_by_type': written['bond_types']}


def serve_batches(torch, model, it, prepare, warm, batches):
    """``warm + batches`` eval-mode forwards under ``torch.inference_mode``
    over the batches of ``it``: host ms to take a batch and put it on the
    card, card ms a forward (CUDA events), the first prepared batch and
    its output, for the last ``batches``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_ms, card_ms, first, out0 = [], [], None, None
    model.eval()
    with torch.inference_mode():
        for i in range(warm + batches):
            t0 = time.perf_counter()
            batch = prepare(next(it))
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            start.record()
            out = model(*batch[:-1])
            end.record()
            torch.cuda.synchronize()
            if i == 0:
                first, out0 = batch, out.clone()
            if i >= warm:
                host_ms.append(host)
                card_ms.append(start.elapsed_time(end))
    check(bool(torch.isfinite(out0).all()), 'serving outputs not finite')
    return host_ms, card_ms, first, out0


def ae_model_run(torch, tag, name, seed, ds, u0_mean, u0_std):
    """Path AE for one model: ``PAE_TRAIN_WARM + PAE_TRAIN`` Adam steps on
    the card over shuffled batches of 32 (``PAE_LR`` with DimeNet++'s
    warm-up; host ms a batch, DimeNet++'s
    host-side ``prepare`` ms apart, card ms a step, no port kernel, the
    peak memory above what was held before, a whole-window profile of a
    step: busy and idle share, kernels a step), ``PAE_SERVE_WARM +
    PAE_SERVE`` serving batches from the trained weights (host and card ms
    a batch, a whole-window profile of a forward; ``host_breakdown`` of a
    training step), the first serving
    batch's float32 outputs against the CPU's within ``PAE_SERVE_TOL`` and
    the card against itself, and the first training batch's
    ``PARITY_STEPS`` steps in float64 on both devices from the trained
    weights (``synced_parity``)."""
    from pytorch_geometric_tpu_torch.loader import DataLoader
    prep_ms = []

    def prepare(batch):
        return qm9_inputs(torch, name, batch, 'cuda', u0_mean, u0_std,
                          prepare_ms=prep_ms)

    def build(device):
        return qm9_model(torch, name, device, seed)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = build('cuda')
    opt = torch.optim.Adam(model.parameters(), lr=PAE_LR)
    taken = []

    def step(*batch):
        for group in opt.param_groups:
            group['lr'] = PAE_LR * min(1.0, (len(taken) + 1)
                                       / PAE_LR_WARMUP[name])
        taken.append(1)
        opt.zero_grad(set_to_none=True)
        loss = qm9_loss(model, *batch)
        loss.backward()
        opt.step()
        return loss.detach()

    loader = DataLoader(ds, batch_size=PAE_BATCH, shuffle=True, pad=False,
                        seed=seed)
    model.train()
    t0 = time.perf_counter()
    host_ms, card_ms, losses, first, per_step = timed_batches(
        torch, iter(loader), prepare, step, PAE_TRAIN_WARM + PAE_TRAIN)
    counts = launch_counts()
    check_counts(tag, counts, {}, f'{PAE_TRAIN_WARM + PAE_TRAIN} steps')
    train_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    train_prep = list(prep_ms)
    prof_rows, prof_ms, _ = whole_window(torch, lambda: step(*first), 3)
    busy = sum(t for _, t, _ in prof_rows)
    card_step = float(np.median(card_ms[PAE_TRAIN_WARM:]))
    res = {'train': {
        'steps': PAE_TRAIN, 'warm_steps': PAE_TRAIN_WARM, 'losses': losses,
        'card_ms_per_step': card_step, 'card_ms': card_ms,
        'host_ms_per_batch': float(np.median(host_ms[PAE_TRAIN_WARM:])),
        'peak_gb': peak, 'held_gb_at_start': held / 1e9,
        'launch_counts': counts, 'launches_per_step': per_step,
        'device_busy_ms_per_step': busy, 'profiled_ms_per_step': prof_ms,
        'device_idle_share': 1 - busy / card_step,
        'device_kernels_per_step': sum(c for _, _, c in prof_rows),
        'kernels_per_step': [[n_[:80], t, c] for n_, t, c in prof_rows[:10]],
        'seconds': train_s}}
    if train_prep:
        res['train']['host_prepare_ms_per_batch'] = float(
            np.median(train_prep[PAE_TRAIN_WARM:]))
    log(f'[{tag}] training: {PAE_TRAIN} Adam steps after '
        f'{PAE_TRAIN_WARM}, card {card_step:.4f} ms a step (median), host '
        f"{res['train']['host_ms_per_batch']:.3f} ms a batch"
        + (f" (of it prepare {res['train']['host_prepare_ms_per_batch']:.3f}"
           ' ms)' if train_prep else '')
        + f', busy {busy:.4f} ms, idle {res["train"]["device_idle_share"]:.3f}'
        f", {res['train']['device_kernels_per_step']:g} device kernels a "
        f'step, no port kernel; peak {peak:.3f} GB over {held / 1e9:.3f} GB '
        f'held; losses {losses}')
    for n_, t, c in prof_rows[:10]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {n_[:90]}')
    res['train']['host_breakdown'] = host_breakdown(
        torch, f'{tag} training', lambda: step(*first))

    # serving from the trained weights
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    prep_ms.clear()
    reset_counts()
    s_host, s_card, s_first, s_out = serve_batches(
        torch, model, iter(DataLoader(ds, batch_size=PAE_BATCH, pad=False)),
        prepare, PAE_SERVE_WARM, PAE_SERVE)
    check_counts(f'{tag} serving', launch_counts(), {},
                 f'{PAE_SERVE_WARM + PAE_SERVE} forwards')

    def forward():
        with torch.inference_mode():
            return model(*s_first[:-1])

    s_rows, s_prof_ms, _ = whole_window(torch, forward, 3)
    s_busy = sum(t for _, t, _ in s_rows)
    serve_card = float(np.median(s_card))
    res['serve'] = {
        'batches': PAE_SERVE, 'warm_batches': PAE_SERVE_WARM,
        'card_ms_per_batch': serve_card, 'card_ms': s_card,
        'host_ms_per_batch': float(np.median(s_host)),
        'device_busy_ms_per_batch': s_busy,
        'profiled_ms_per_batch': s_prof_ms,
        'device_idle_share': 1 - s_busy / serve_card,
        'device_kernels_per_batch': sum(c for _, _, c in s_rows),
        'molecules_per_s': PAE_BATCH / (serve_card + float(
            np.median(s_host))) * 1e3,
        'kernels_per_batch': [[n_[:80], t, c] for n_, t, c in s_rows[:10]]}
    if prep_ms:
        res['serve']['host_prepare_ms_per_batch'] = float(
            np.median(prep_ms[PAE_SERVE_WARM:]))
    log(f'[{tag}] serving: {PAE_SERVE} eval batches after {PAE_SERVE_WARM} '
        f'under inference_mode, card {serve_card:.4f} ms a batch (median), '
        f"host {res['serve']['host_ms_per_batch']:.3f} ms a batch"
        + (f" (of it prepare {res['serve']['host_prepare_ms_per_batch']:.3f}"
           ' ms)' if prep_ms else '')
        + f', busy {s_busy:.4f} ms, idle '
        f"{res['serve']['device_idle_share']:.3f}, "
        f"{res['serve']['device_kernels_per_batch']:g} device kernels a "
        'forward')
    for n_, t, c in s_rows[:10]:
        log(f'[{tag}]   {t:.4f} ms  x{c:g}  {n_[:90]}')

    # the float32 serving outputs against the CPU, and the card against
    # itself
    cpu_first = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                      for t in s_first)
    cpu = build('cpu')
    cpu.load_state_dict(state)
    cpu.eval()
    with torch.inference_mode():
        ref = cpu(*cpu_first[:-1])
        again = model(*s_first[:-1]).cpu()
    scale = max(1.0, float(ref.abs().max()))
    err = float((s_out.cpu() - ref).abs().max()) / scale
    spread = float((again - s_out.cpu()).abs().max()) / scale
    tol = PAE_SERVE_TOL[name]
    log(f'[{tag}] float32 serving outputs of the first batch against the '
        f'CPU: {err:.3e} of max(1, max|CPU|) (limit {tol:g}); the card '
        f'against itself over two forwards {spread:.3e}')
    check(err <= tol, f'{tag}: float32 serving outputs {err} from the CPU '
                      f'(limit {tol})')
    res['serve'].update(outputs_vs_cpu=err, card_self_spread=spread,
                        outputs_tol=tol)

    # float64 parity steps from the trained weights
    def cast(batch):
        return tuple(t.double() if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t for t in batch)

    cpu_train = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                      for t in first)
    t0 = time.perf_counter()
    res['steps_vs_cpu'] = synced_parity(
        torch, f'{tag} float64', lambda dev: build(dev).double(), state,
        cast(first), cast(cpu_train), None, qm9_loss,
        PAE_LR / PAE_LR_WARMUP[name])
    res['cpu_parity_s'] = time.perf_counter() - t0
    del model, opt, cpu
    torch.cuda.empty_cache()
    return res, first


def phase_path_ae(torch, seed):
    """Path AE: DimeNet++ and SchNet on QM9's shape. ``qm9_raw`` writes
    ``QM9_MOLECULES`` molecules' ``gdb9.sdf`` and ``gdb9.sdf.csv``; the
    port's ``QM9`` parses them (seconds; graphs, atoms, bonds by type and
    U0 against what was written); the regression target is U0
    standardised over the set. For each model (``ae_model_run``): training
    and serving on the card in batches of 32, the float32 serving outputs
    and 3 float64 steps against the CPU. Edges and triplets a batch:
    DimeNet++'s interaction graph at 5 Angstrom and its triplets
    (``DimeNet.prepare``) over the serving batches; SchNet's radius graph
    at 10 Angstrom (32 slots an atom) of the first training batch, on the
    card against the CPU's, pair for pair."""
    import tempfile
    from pytorch_geometric_tpu_torch.datasets import QM9
    from pytorch_geometric_tpu_torch.loader import DataLoader
    from pytorch_geometric_tpu_torch.nn.models import DimeNet
    from pytorch_geometric_tpu_torch.nn.pool import radius_graph
    tag = 'path AE'
    res = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        written = qm9_raw(root, QM9_MOLECULES, seed)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = QM9(root)
        parse_s = time.perf_counter() - t0
        res['dataset'] = check_qm9_parse(torch, tag, ds, written)
        res['dataset'].update(raw_write_s=write_s, parse_s=parse_s)
        log(f'[{tag}] qm9_raw: {QM9_MOLECULES} molecules written in '
            f'{write_s:.2f} s; QM9 parse {parse_s:.2f} s: {res["dataset"]}')
        # the data lives in memory from here on
        ds = [ds[i] for i in range(len(ds))]
    u0 = torch.cat([d.y[:, QM9_U0] for d in ds]).double()
    u0_mean, u0_std = float(u0.mean()), float(u0.std())
    res['u0_mean_hartree'], res['u0_std_hartree'] = u0_mean, u0_std

    edges, trips = [], []
    for batch in DataLoader(ds[:PAE_BATCH * (PAE_SERVE_WARM + PAE_SERVE)],
                            batch_size=PAE_BATCH, pad=False):
        coo, kj, _, _ = DimeNet.prepare(batch.pos.numpy(),
                                        batch.batch.numpy(),
                                        PAE_DIMENET['cutoff'])
        edges.append(coo.shape[1])
        trips.append(len(kj))
    res['dimenet_graph'] = {'cutoff': PAE_DIMENET['cutoff'],
                            'edges_per_batch': float(np.mean(edges)),
                            'triplets_per_batch': float(np.mean(trips))}
    log(f'[{tag}] DimeNet++ at {PAE_DIMENET["cutoff"]} A over the serving '
        f'batches: {np.mean(edges):.1f} directed edges and '
        f'{np.mean(trips):.1f} triplets a batch of {PAE_BATCH} '
        f'({min(trips)}-{max(trips)})')

    for name in ('dimenet++', 'schnet'):
        t0 = time.perf_counter()
        res[name], first = ae_model_run(torch, f'{tag} {name}', name, seed,
                                        ds, u0_mean, u0_std)
        res[name]['seconds'] = time.perf_counter() - t0
    # SchNet's radius graph of the first training batch, card and CPU
    z, pos, bvec = first[0], first[1], first[2]
    graphs = {}
    for dev in ('cuda', 'cpu'):
        coo, valid = radius_graph(pos.to(dev), PAE_SCHNET['cutoff'],
                                  batch=bvec.to(dev),
                                  max_num_neighbors=PAE_SCHNET[
                                      'max_num_neighbors'])
        keep = valid.cpu()
        pairs = coo.cpu()[:, keep]
        graphs[dev] = set(map(tuple, pairs.t().tolist()))
    check(graphs['cuda'] == graphs['cpu'],
          f"{tag}: SchNet's radius graph on the card has "
          f"{len(graphs['cuda'] - graphs['cpu'])} pairs the CPU's lacks and "
          f"lacks {len(graphs['cpu'] - graphs['cuda'])}")
    res['schnet_graph'] = {
        'cutoff': PAE_SCHNET['cutoff'], 'atoms': int(z.shape[0]),
        'slots': int(z.shape[0]) * PAE_SCHNET['max_num_neighbors'],
        'edges': len(graphs['cuda'])}
    log(f"[{tag}] SchNet at {PAE_SCHNET['cutoff']} A, first training batch: "
        f"{len(graphs['cuda'])} edges of {res['schnet_graph']['slots']} slots "
        f'({z.shape[0]} atoms), the same pairs on the card and the CPU')
    res['launch_counts'] = {
        k: res['dimenet++']['train']['launch_counts'].get(k, 0)
        + res['schnet']['train']['launch_counts'].get(k, 0)
        for k in res['schnet']['train']['launch_counts']}
    del ds
    torch.cuda.empty_cache()
    return res


def _write_off(path, pos, faces, header_counts=False):
    """An OFF mesh; ``faces`` may mix triangles and quads; with
    ``header_counts`` the counts share the header's line."""
    head = (f'OFF{len(pos)} {len(faces)} 0\n' if header_counts
            else f'OFF\n{len(pos)} {len(faces)} 0\n')
    Path(path).write_text(
        head + ''.join(' '.join(f'{v:.6f}' for v in p) + '\n' for p in pos)
        + ''.join(f'{len(f)} ' + ' '.join(map(str, f)) + '\n'
                  for f in faces))


def _write_ply(path, pos, faces):
    """An ASCII PLY mesh with a vertex and a face element."""
    Path(path).write_text(
        'ply\nformat ascii 1.0\ncomment synthetic\n'
        f'element vertex {len(pos)}\nproperty float x\nproperty float y\n'
        f'property float z\nelement face {len(faces)}\n'
        'property list uchar int vertex_indices\nend_header\n'
        + ''.join(' '.join(f'{v:.6f}' for v in p) + '\n' for p in pos)
        + ''.join(f'{len(f)} ' + ' '.join(map(str, f)) + '\n'
                  for f in faces))


def _write_obj(path, pos, faces):
    """An OBJ mesh, face vertices as ``v/vt/vn``."""
    Path(path).write_text(
        '# synthetic\n'
        + ''.join('v ' + ' '.join(f'{v:.6f}' for v in p) + '\n' for p in pos)
        + ''.join('f ' + ' '.join(f'{i + 1}/{i + 1}/{i + 1}' for i in f)
                  + '\n' for f in faces))


def _mesh(rng, n):
    """``n`` vertices and a strip of triangles and quads over them."""
    pos = rng.standard_normal((n, 3))
    faces = [list(range(i, i + 3)) for i in range(0, n - 2, 3)]
    faces += [[i, i + 1, i + 2, i + 3] for i in range(0, n - 3, 4)]
    return pos, faces


def dataset_raws(torch, root, seed=0):
    """Raw files of every dataset family of ``datasets/geometry.py``,
    ``molecules.py`` and ``point_datasets.py`` at small shapes under
    ``root``, in each one's format (the layouts the JAX package reads):
    SDF and csv (QM9, ``qm9_raw``), npz (MD17), OFF with quads and a
    header that holds the counts (ModelNet, the OFF mesh folders), PLY
    (FAUST, CoMA), OBJ (Teeth3DS), csv (MovieLens, JODIE, MoleculeNet),
    pickles (ZINC, AQSOL, LRGB), ``torch.save`` payloads
    (GNNBenchmarkDataset, MNISTSuperpixels), edge lists (MalNetTiny),
    ``.mat`` (TOSCA, PascalPF with NaN rows, WILLOW), text clouds
    (PCPNet, ShapeNet) and ``.npy`` rooms (S3DIS). Returns ``{family:
    (class name, args, keywords)}``: ``getattr(datasets, name)(*args,
    **keywords)`` builds the dataset of either package."""
    import pickle
    import scipy.io
    rng = np.random.default_rng(seed)
    root = Path(root)
    out = {}

    def mk(*parts):
        p = root.joinpath(*parts)
        p.mkdir(parents=True, exist_ok=True)
        return p

    qm9_raw(mk('qm9'), 12, seed)
    out['QM9'] = ('QM9', (str(root / 'qm9'),), {})
    np.savez(mk('md17', 'aspirin', 'raw') / 'aspirin.npz',
             z=np.array([6, 6, 8, 1, 1]), R=rng.standard_normal((7, 5, 3)),
             E=rng.standard_normal(7), F=rng.standard_normal((7, 5, 3)))
    out['MD17'] = ('MD17', (str(root / 'md17'), 'aspirin'), {})
    for split in ('train', 'test'):
        for cat in ('chair', 'desk'):
            d = mk('modelnet', 'modelnet10_' + split, 'raw', cat, split)
            for i in range(2):
                _write_off(d / f'{cat}_{i:04d}.off', *_mesh(rng, 9 + i),
                           header_counts=(i == 1))
    out['ModelNet'] = ('ModelNet', (str(root / 'modelnet'), '10'),
                       {'train': True})
    out['ModelNet test'] = ('ModelNet', (str(root / 'modelnet'), '10'),
                            {'train': False})
    d = mk('faust', 'raw', 'MPI-FAUST', 'training', 'registrations')
    for i in range(3):
        _write_ply(d / f'tr_reg_{i:03d}.ply', *_mesh(rng, 10))
    out['FAUST'] = ('FAUST', (str(root / 'faust'),), {})
    (mk('movielens', 'raw') / 'ratings.csv').write_text(
        'userId,movieId,rating,timestamp\n' + ''.join(
            f'{u},{m},{r:.1f},0\n' for u, m, r in zip(
                rng.integers(1, 6, 20), rng.integers(10, 18, 20),
                rng.integers(1, 11, 20) / 2)))
    out['MovieLens'] = ('MovieLens', (str(root / 'movielens'),), {})
    (mk('jodie', 'wikipedia', 'raw') / 'wikipedia.csv').write_text(
        'user,item,timestamp,state_label,f0,f1,f2\n' + ''.join(
            f'{u},{i},{t:.2f},{s},{a:.4f},{b:.4f},{c:.4f}\n'
            for u, i, t, s, (a, b, c) in zip(
                rng.integers(0, 4, 15), rng.integers(0, 5, 15),
                np.sort(rng.uniform(0, 100, 15)), rng.integers(0, 2, 15),
                rng.standard_normal((15, 3)))))
    out['JODIEDataset'] = ('JODIEDataset', (str(root / 'jodie'),
                                            'wikipedia'), {})
    mols = [{'atom_type': rng.integers(0, 28, k),
             'bond_type': np.triu(rng.integers(0, 4, (k, k)), 1),
             'logP_SA_cycle_normalized': rng.normal()}
            for k in (5, 8, 3)]
    for m in mols:
        m['bond_type'] = m['bond_type'] + m['bond_type'].T
    with open(mk('zinc', 'raw') / 'train.pickle', 'wb') as fh:
        pickle.dump(mols, fh)
    out['ZINC'] = ('ZINC', (str(root / 'zinc'),), {})
    out['ZINC subset'] = ('ZINC', (str(root / 'zinc'),), {'subset': True})
    with open(mk('aqsol', 'raw') / 'train.pickle', 'wb') as fh:
        pickle.dump([(rng.integers(0, 60, k), rng.integers(0, 4, 2 * k),
                      rng.integers(0, k, (2, 2 * k)), float(rng.normal()))
                     for k in (4, 6)], fh)
    out['AQSOL'] = ('AQSOL', (str(root / 'aqsol'),), {})
    (mk('molnet', 'esol', 'raw') / 'delaney-processed.csv').write_text(
        'Compound ID,ESOL predicted log solubility,Minimum Degree,smiles\n'
        'A,-0.77,1,OCC3OC(OCC2OC(OC(C#N)c1ccccc1)C(O)C(O)C2O)C(O)C(O)C3O\n'
        'B,-3.3,1,Cc1occc1C(=O)Nc2ccccc2\nC,,2,C\n'
        'D,-1.2,1,ClC(Cl)(Cl)Br\n')
    out['MoleculeNet'] = ('MoleculeNet', (str(root / 'molnet'), 'esol'), {})

    def graph_dict(k, pos=False):
        g = {'x': torch.randn(k, 3, generator=gen),
             'edge_index': torch.randint(0, k, (2, 2 * k), generator=gen),
             'y': torch.randint(0, 4, (k,), generator=gen)}
        if pos:
            g['pos'] = torch.rand(k, 2, generator=gen)
        return g

    gen = torch.Generator().manual_seed(seed)
    torch.save([[graph_dict(k) for k in (5, 7)], [graph_dict(4)],
                [graph_dict(6)]], mk('gnnb', 'CLUSTER', 'raw') / 'CLUSTER.pt')
    out['GNNBenchmarkDataset'] = ('GNNBenchmarkDataset',
                                  (str(root / 'gnnb'), 'CLUSTER'),
                                  {'split': 'val'})
    torch.save([[graph_dict(k, True) for k in (6, 5)], [graph_dict(4, True)]],
               mk('mnist', 'raw') / 'MNISTSuperpixels.pt')
    out['MNISTSuperpixels'] = ('MNISTSuperpixels', (str(root / 'mnist'),),
                               {'train': False})
    with open(mk('lrgb', 'PascalVOC-SP', 'raw') / 'train.pickle', 'wb') as fh:
        pickle.dump([(rng.standard_normal((k, 14)), rng.standard_normal(
            (3 * k, 2)), rng.integers(0, k, (2, 3 * k)),
            rng.integers(0, 21, k)) for k in (7, 9)], fh)
    out['LRGBDataset'] = ('LRGBDataset', (str(root / 'lrgb'),
                                          'PascalVOC-SP'), {})
    d = mk('malnet', 'raw')
    lines = []
    for i, k in enumerate((6, 4)):
        coo = rng.integers(0, k, (3 * k, 2))
        (d / f'g{i}.edgelist').write_text(
            '# src dst\n' + ''.join(f'{a} {b}\n' for a, b in coo))
        lines.append(f'g{i}.edgelist {i % 2}')
    (d / 'train.txt').write_text('\n'.join(lines) + '\n')
    out['MalNetTiny'] = ('MalNetTiny', (str(root / 'malnet'),), {})
    for cat in ('cube', 'tet'):
        d = mk('shapes', 'raw', cat)
        _write_off(d / 'a.off', *_mesh(rng, 8))
        _write_off(d / 'b.OFF', *_mesh(rng, 6))
    for name in ('GeometricShapes', 'SHREC2016', 'MedShapeNet'):
        out[name] = (name, (str(root / 'shapes'),), {})
    for cat in ('upper', 'lower'):
        _write_obj(mk('teeth', 'raw', cat) / 'scan.obj', *_mesh(rng, 9))
        _write_ply(mk('coma', 'raw', cat) / 'face.ply', *_mesh(rng, 7))
    out['Teeth3DS'] = ('Teeth3DS', (str(root / 'teeth'),), {})
    out['CoMA'] = ('CoMA', (str(root / 'coma'),), {})
    d = mk('tosca', 'raw')
    for name in ('cat0', 'cat1', 'dog0'):
        pos, faces = _mesh(rng, 9)
        tri = np.array([f for f in faces if len(f) == 3]) + 1
        scipy.io.savemat(d / f'{name}.vert.mat', {'surface': pos})
        scipy.io.savemat(d / f'{name}.tri.mat', {'tri': tri})
    out['TOSCA'] = ('TOSCA', (str(root / 'tosca'),), {})
    d = mk('pcpnet', 'raw')
    mk('pcpnet', 'raw', 'list')
    (d / 'list' / 'train.txt').write_text('cloud_a\ncloud_b\n')
    for i, name in enumerate(('cloud_a', 'cloud_b')):
        np.savetxt(d / f'{name}.xyz', rng.standard_normal((12, 3)))
        if i == 0:
            np.savetxt(d / f'{name}.normals', rng.standard_normal((12, 3)))
    out['PCPNetDataset'] = ('PCPNetDataset', (str(root / 'pcpnet'),), {})
    for cat, cols in (('airplane', 7), ('mug', 6)):
        np.savetxt(mk('shapenet', 'raw', cat) / 'p0.txt', np.concatenate(
            [rng.standard_normal((15, 6)), rng.integers(0, 4, (15, 1))],
            1)[:, :cols])
    out['ShapeNet'] = ('ShapeNet', (str(root / 'shapenet'),), {})
    d = mk('s3dis', 'raw')
    for name in ('Area_1_office', 'Area_6_lobby'):
        np.save(d / f'{name}.npy', np.concatenate(
            [rng.standard_normal((20, 3)), rng.integers(0, 256, (20, 3)),
             rng.integers(0, 13, (20, 1))], 1))
    out['S3DIS'] = ('S3DIS', (str(root / 's3dis'),), {})
    out['S3DIS test'] = ('S3DIS', (str(root / 's3dis'),), {'train': False})
    d = mk('pascalpf', 'raw', 'Annotations', 'car')
    for i in range(2):
        kps = rng.standard_normal((6, 2))
        kps[i + 1] = np.nan
        scipy.io.savemat(d / f'car_{i}.mat', {'kps': kps})
    out['PascalPF'] = ('PascalPF', (str(root / 'pascalpf'), 'car'), {})
    d = mk('willow', 'raw', 'Duck')
    for i in range(2):
        scipy.io.savemat(d / f'duck_{i}.mat',
                         {'pts_coord': rng.standard_normal((2, 10))})
    out['WILLOWObjectClass'] = ('WILLOWObjectClass', (str(root / 'willow'),
                                                      'Duck'), {})
    return out


# the dataset families ``data_cases`` parses on the host and moves to the
# card
DATA_FAMILIES = ('QM9', 'MD17', 'ModelNet', 'FAUST', 'ZINC', 'LRGBDataset',
                 'GeometricShapes', 'TOSCA', 'MoleculeNet')


def molecule_cases(torch, seed, inputs, n, e, f, graphs, g):
    """``module_cases``' molecular models: SchNet (plain, with ``dipole``,
    with ``atomref``), DimeNet (bilinear) and DimeNet++ at narrow widths,
    each on 8 ``qm9_molecules`` whose positions move with 0.01 of x's
    first three columns (DimeNet's interaction graph and triplets from
    ``DimeNet.prepare`` at the unmoved positions, glorot output layers so
    that every first-step gradient flows; DimeNet's two in float64 on both
    devices); AttentiveFP over an
    ``EdgeIndex`` with the slot orders (its atom GATConv fused: the mix
    kernel twice forward, once and the per-edge dot kernel once backward)
    and over the raw COO with its mask; SignedGCN over the COO's two
    halves as positive and negative edges; RECT_L over a cached
    ``EdgeIndex`` (its GCNConv normalises on every call and propagates over
    the raw COO that ``gcn_norm`` returns); GroupAddRev around a GCNConv,
    its groups recomputed in the backward pass. Adds the molecules'
    tensors to ``inputs``."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn.conv import GCNConv
    from pytorch_geometric_tpu_torch.nn.models import (
        AttentiveFP, DimeNet, DimeNetPlusPlus, GroupAddRev, RECT_L, SchNet,
        SignedGCN)
    numbers = {'H': 1, 'C': 6, 'N': 7, 'O': 8, 'F': 9}
    symbols, _, pos = qm9_molecules(8, seed + 74)
    z = np.array([numbers[s] for mol in symbols for s in mol])
    pos = np.concatenate(pos).astype(np.float32)
    mol = np.repeat(np.arange(8), [len(s) for s in symbols])
    atoms = len(z)
    coo, kj, ji, tmask = DimeNet.prepare(pos, mol, 5.0)
    inputs.update({'mol_z': torch.as_tensor(z),
                   'mol_pos': torch.as_tensor(pos),
                   'mol_batch': torch.as_tensor(mol),
                   'mol_coo': torch.as_tensor(coo),
                   'mol_kj': torch.as_tensor(kj),
                   'mol_ji': torch.as_tensor(ji),
                   'mol_tmask': torch.as_tensor(tmask)})

    def pos_of(x, d):
        return d['mol_pos'] + 0.01 * x[:atoms, :3]

    def schnet_run(m, x, d):
        return m(d['mol_z'], pos_of(x, d), d['mol_batch'], 8)

    def dimenet_run(m, x, d):
        # float64 on both devices: at float32 a gradient of these narrow
        # models sits up to 9.6e-5 of its own largest from float64 on the
        # CPU (the l = 6 Bessel recurrence near its series switch), too
        # near the phase's 1e-4 to hold one device to the other
        return m(d['mol_z'], pos_of(x, d).double(), d['mol_coo'],
                 d['mol_kj'], d['mol_ji'], d['mol_tmask'], d['mol_batch'], 8)

    narrow = dict(hidden_channels=32, num_filters=32, num_interactions=2,
                  num_gaussians=16, cutoff=5.0, max_num_neighbors=16)
    dime = dict(hidden_channels=32, out_channels=2, num_blocks=2,
                num_spherical=7, num_radial=6, cutoff=5.0,
                output_initializer='glorot')

    def slots(x, d):
        return EdgeIndex(d['coo'][:, :e], (n, n), device=x.device
                         ).fill_cache(blocked=True)

    def rect_graph(x, d):
        return EdgeIndex(d['coo'][:, :e], (n, n), device=x.device
                         ).fill_cache(blocked=False)

    return [
        ('SchNet', lambda dev: SchNet(**narrow, **g(dev)), schnet_run),
        ('SchNet dipole', lambda dev: SchNet(**narrow, dipole=True, **g(dev)),
         schnet_run),
        ('SchNet atomref', lambda dev: SchNet(
            **narrow, atomref=np.linspace(-1.0, 1.0, 100), **g(dev)),
         schnet_run),
        ('DimeNet', lambda dev: DimeNet(**dime, num_bilinear=4,
                                        **g(dev)).double(), dimenet_run),
        ('DimeNetPlusPlus', lambda dev: DimeNetPlusPlus(
            **dime, int_emb_size=16, basis_emb_size=8, out_emb_channels=48,
            **g(dev)).double(), dimenet_run),
        ('AttentiveFP fused', lambda dev: AttentiveFP(f, 32, 2, 8, **g(dev)),
         lambda m, x, d: m(x, slots(x, d), d['ea'][:e], d['batch'],
                           graphs)),
        ('AttentiveFP', lambda dev: AttentiveFP(f, 32, 2, 8, **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['ea'], d['batch'], graphs,
                           edge_mask=d['mask'])),
        ('SignedGCN', lambda dev: SignedGCN(f, 16, 3, **g(dev)),
         lambda m, x, d: m(x, d['coo'][:, :e // 2], d['coo'][:, e // 2:e])),
        ('RECT_L', lambda dev: RECT_L(f, 24, **g(dev)),
         lambda m, x, d: m(x, rect_graph(x, d))),
        ('GroupAddRev', lambda dev: GroupAddRev(GCNConv(f // 2, f // 2,
                                                        **g(dev)), 2),
         lambda m, x, d: m(x, d['coo'], edge_mask=d['mask']))]


def cluster_cases(torch, seed, inputs, n, e, f, graphs, cap, g):
    """``module_cases``' cluster pools, dense and advanced aggregations and
    dense convs and pools: ``avg_pool_x`` / ``max_pool_x`` over graclus
    clusters, ``EdgePooling``'s device score in its three methods,
    ``ASAPooling``, ``MemPooling`` (node list and dense batch),
    ``ClusterPooling`` (its clusters from each device's own scores: a
    flipped threshold decision shows as a cluster mismatch), every new
    aggregation over the 8 graphs (``max_num_elements`` the largest), the
    five dense convs, the three dense pool functions and ``DMoNPooling``
    over the dense batch and adjacency. The host merges run on the card's
    own scores in ``host_decision_checks``."""
    from pytorch_geometric_tpu_torch.nn import aggr, dense, pool
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.utils.dense import (to_dense_adj,
                                                         to_dense_batch)
    rng = np.random.default_rng(seed + 77)
    coo = inputs['coo'][:, :e]
    inside = inputs['batch'][coo[0]] == inputs['batch'][coo[1]]
    inputs.update({
        'coo_in': coo[:, inside],
        'cluster': torch.as_tensor(pool.graclus(coo[:, inside].numpy(), n,
                                                seed=seed)),
        'w_in': torch.as_tensor(rng.uniform(0.5, 1.5, int(inside.sum())),
                                dtype=torch.float32)})
    k_cl = int(np.unique(inputs['cluster'].numpy()).size)
    inputs['cluster'] = torch.as_tensor(
        np.unique(inputs['cluster'].numpy(), return_inverse=True)[1])

    def dense_in(x, d):
        xd, mask = to_dense_batch(x, d['batch'], graphs, cap)
        adj = to_dense_adj(d['coo_in'], d['batch'], graphs, cap, d['w_in'])
        return xd, adj, mask

    def seg_run(m, x, d):
        return m(x, d['batch'], graphs, None, cap)

    def flat(*outs):
        return torch.cat([o.reshape(-1) for o in outs
                          if o.is_floating_point()])

    cases = [
        ('avg_pool_x graclus', lambda dev: torch.nn.Identity(),
         lambda m, x, d: pool.avg_pool_x(d['cluster'], m(x), k_cl)),
        ('max_pool_x graclus', lambda dev: torch.nn.Identity(),
         lambda m, x, d: pool.max_pool_x(d['cluster'], m(x), k_cl))]
    for method in ('softmax', 'tanh', 'sigmoid'):
        cases.append((f'EdgePooling {method}',
                      lambda dev, method=method: pool.EdgePooling(
                          f, method, **g(dev)),
                      lambda m, x, d: m(x, d['coo_in'])))
    cases += [
        ('ASAPooling', lambda dev: pool.ASAPooling(f, 0.5, **g(dev)),
         lambda m, x, d: flat(*m(x, d['coo_in'], d['w_in'], d['batch'],
                                 graphs, cap)[:2])),
        ('MemPooling', lambda dev: pool.MemPooling(f, 16, 4, 4, **g(dev)),
         lambda m, x, d: flat(*m(x, d['batch'], graphs))),
        ('MemPooling dense', lambda dev: pool.MemPooling(f, 16, 4, 2,
                                                         **g(dev)),
         lambda m, x, d: (lambda xd, adj, mask: flat(*m(xd, mask=mask)))(
             *dense_in(x, d))),
        ('ClusterPooling', lambda dev: pool.ClusterPooling(f, 'tanh',
                                                           **g(dev)),
         lambda m, x, d: (lambda o: torch.cat([
             o[0].reshape(-1), o[1].to(x.dtype) / 1e3]))(
                 m(x, d['coo_in'])))]
    for name, build in (
            ('SortAggregation', lambda dev: aggr.SortAggregation(30)),
            ('QuantileAggregation', lambda dev: aggr.QuantileAggregation(
                0.3, 'linear')),
            ('MedianAggregation', lambda dev: aggr.MedianAggregation()),
            ('GRUAggregation', lambda dev: aggr.GRUAggregation(f, 16,
                                                               **g(dev))),
            ('LSTMAggregation', lambda dev: aggr.LSTMAggregation(f, 16,
                                                                 **g(dev))),
            ('MLPAggregation', lambda dev: aggr.MLPAggregation(f, 16, cap,
                                                               **g(dev))),
            ('SetTransformerAggregation', lambda dev:
             aggr.SetTransformerAggregation(f, 32, 2, 4, 1, **g(dev))),
            ('GraphMultisetTransformer', lambda dev:
             aggr.GraphMultisetTransformer(f, 32, **g(dev))),
            ('LCMAggregation', lambda dev: aggr.LCMAggregation(f, 16,
                                                               **g(dev))),
            ('PatchTransformerAggregation', lambda dev:
             aggr.PatchTransformerAggregation(f, 32, 8, 4, **g(dev))),
            ('EquilibriumAggregation', lambda dev:
             aggr.EquilibriumAggregation(f, 8, **g(dev)))):
        cases.append((f'aggr {name}', build, seg_run))

    def dense_conv_run(m, x, d):
        xd, adj, mask = dense_in(x, d)
        return m(xd, adj, mask)

    cases += [
        ('DenseGCNConv', lambda dev: dense.DenseGCNConv(f, 16, **g(dev)),
         dense_conv_run),
        ('DenseSAGEConv', lambda dev: dense.DenseSAGEConv(
            f, 16, normalize=True, **g(dev)), dense_conv_run),
        ('DenseGINConv', lambda dev: dense.DenseGINConv(
            linear(f, 16, **g(dev)), train_eps=True, device=dev),
         dense_conv_run),
        ('DenseGraphConv', lambda dev: dense.DenseGraphConv(
            f, 16, aggr='mean', **g(dev)), dense_conv_run),
        ('DenseGATConv', lambda dev: dense.DenseGATConv(f, 8, heads=4,
                                                        **g(dev)),
         dense_conv_run),
        ('DMoNPooling', lambda dev: dense.DMoNPooling(f, 6, **g(dev)),
         lambda m, x, d: flat(*m(*dense_in(x, d))))]
    for name in ('dense_diff_pool', 'dense_mincut_pool', 'dense_dmon_pool'):
        fn = getattr(dense, name)

        def run(m, x, d, fn=fn, name=name):
            xd, adj, mask = dense_in(x, d)
            s = m(xd)
            if name == 'dense_dmon_pool':
                s = torch.softmax(s, -1)
            return flat(*fn(xd, adj, s, mask))

        cases.append((name, lambda dev: linear(f, 6, **g(dev)), run))
    return cases


def host_decision_checks(torch, seed, inputs, n, f):
    """The host halves of EdgePooling and ClusterPooling on the card's own
    scores, on ``module_cases``' graph: EdgePooling's merge of the card's
    scores must be a matching (each cluster one node, or the two ends of
    an edge taken in the order of the scores, no node twice), its rows the
    members' sum times the chosen score; ClusterPooling's clusters on the
    card must be the components of the edges whose card score passes the
    threshold, and its pooled rows those clusters' score-weighted sums,
    recomputed on the host from the card's scores. The decisions are not
    held to the CPU's: a last-place difference in a score may change them
    (logged: whether the CPU's own decisions agree). ``inputs``, ``n``,
    ``f``: ``module_cases``'."""
    from pytorch_geometric_tpu_torch.nn import pool
    from pytorch_geometric_tpu_torch.utils.coalesce import coalesce
    x_cpu = torch.randn((n, f), generator=torch.Generator().manual_seed(
        seed + 72))
    coo = inputs['coo_in']
    res = {}

    def gen(dev):
        return dict(device=dev,
                    generator=torch.Generator().manual_seed(seed + 71))

    scores = {}
    with torch.no_grad():
        for dev in ('cpu', 'cuda'):
            m = pool.EdgePooling(f, 'tanh', **gen(dev))
            scores[dev] = m(x_cpu.to(dev), coo.to(dev)).cpu()
    s_card = scores['cuda'].numpy()
    new_x, new_coo, cluster = pool.EdgePooling.merge(x_cpu, coo, s_card)
    c = coo.numpy()
    members = {}
    for v, cl in enumerate(cluster):
        members.setdefault(int(cl), []).append(v)
    edge_of = {}
    for i in np.argsort(-s_card, kind='stable'):
        edge_of.setdefault((int(c[0, i]), int(c[1, i])), float(s_card[i]))
    ok = all(len(v) <= 2 for v in members.values())
    want_x = np.zeros_like(new_x)
    for cl, vs in members.items():
        # a lone node: its own loop's score where it has one, else 1
        w = edge_of.get((vs[0], vs[0]), 1.0)
        if len(vs) == 2:
            a, b = vs
            w = max(edge_of.get((a, b), -np.inf), edge_of.get((b, a),
                                                             -np.inf))
            ok &= np.isfinite(w)
        want_x[cl] = x_cpu.numpy()[vs].sum(0) * np.float32(w)
    ok &= np.abs(new_x - want_x).max() <= 1e-5 * max(1.0, np.abs(
        want_x).max())
    ok &= np.array_equal(new_coo, coalesce(cluster[c], num_nodes=len(
        members)).astype(np.int32))
    cpu_same = np.array_equal(pool.EdgePooling.merge(
        x_cpu, coo, scores['cpu'].numpy())[2], cluster)
    check(ok, 'EdgePooling: the merge of the card\'s scores is no greedy '
              'matching of them')
    res['edge_pooling'] = {'clusters': len(members), 'merge_ok': bool(ok),
                           'cpu_merge_same': bool(cpu_same)}
    m = pool.ClusterPooling(f, 'tanh', **gen('cuda'))
    with torch.no_grad():
        pooled, cl, _, _, k = m(x_cpu.cuda(), coo.cuda())
        raw = m.lin(torch.cat([x_cpu.cuda()[coo[0]], x_cpu.cuda()[coo[1]]],
                              -1))[:, 0]
        score = torch.tanh(raw).cpu().numpy()
    keep = (score > 0) & (c[0] != c[1])
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    _, comp = connected_components(sp.coo_matrix(
        (np.ones(int(keep.sum())), (c[0][keep], c[1][keep])), (n, n)),
        directed=True, connection='weak')
    cl = cl.cpu().numpy()
    same = np.array_equal(cl, comp)
    touched = np.zeros(n, bool)
    touched[c[0][keep]] = touched[c[1][keep]] = True
    sv = np.where(c[0] != c[1], score, 0.0)
    row_w = np.zeros((n, n))
    np.add.at(row_w, (c[0], cl[c[1]]), sv)
    row_w[np.arange(n), cl] += ~touched
    want = row_w.T @ x_cpu.double().numpy()
    err = float(np.abs(pooled.cpu().double().numpy() - want).max()
                / max(1.0, np.abs(want).max()))
    with torch.no_grad():
        cpu_cl = pool.ClusterPooling(f, 'tanh', **gen('cpu'))(
            x_cpu, coo)[1].numpy()
    log(f'[modules] host decisions on the card\'s scores: EdgePooling '
        f'{len(members)} clusters, a greedy matching {bool(ok)}, the CPU '
        f'scores merge the same {bool(cpu_same)}; ClusterPooling {k} '
        f'clusters, the components of the card\'s kept edges {same}, pooled '
        f'rows {err:.3e} from float64 (limit 1e-4), the CPU clusters the '
        f'same {np.array_equal(cpu_cl, cl)}')
    check(same and err <= 1e-4, f'ClusterPooling: clusters {same}, pooled '
                                f'rows {err} from the host recomputation')
    res['cluster_pooling'] = {'clusters': int(k), 'components_ok': same,
                              'pooled_rel_err': err,
                              'cpu_clusters_same': bool(np.array_equal(
                                  cpu_cl, cl))}
    return res


def point_cases(torch, seed, inputs, n, e, f, g):
    """``module_cases``' point family and kernel convolutions: SplineConv at
    degrees 1-3 in 1-3 dimensions, GMMConv, NNConv, CGConv, FeaStConv,
    PointNetConv, PPFConv, PointTransformerConv, DynamicEdgeConv,
    GravNetConv (a masked point among them), XConv with and without x;
    ``knn`` / ``knn_graph`` / ``radius`` / ``radius_graph`` / ``nearest``
    / ``fps`` / ``knn_interpolate`` / ``voxel_grid`` and the KNN indexes
    (their indices shown through a gather of x, so a wrong index moves the
    output); TopKPooling, SAGPooling, PANPooling; GraphUNet at Cora's size
    (2,708 nodes, 10,556 edges; x's rows first). Adds the tensors they
    read to ``inputs``: pseudo-coordinates in [0, 1], normals, a point
    mask, a second point set, Cora-sized rows and edges."""
    from pytorch_geometric_tpu_torch.nn import conv, models, pool
    from pytorch_geometric_tpu_torch.nn import knn_interpolate
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.nn.models import MLP
    rng = np.random.default_rng(seed + 76)
    f32 = torch.float32
    cora_n, cora_e = 2708, 10_556
    inputs.update({
        'pseudo': torch.as_tensor(rng.random((inputs['coo'].shape[1], 3)),
                                  dtype=f32),
        'normal': torch.as_tensor(rng.standard_normal((n, 3)), dtype=f32),
        'pmask': torch.as_tensor(rng.random(n) < 0.95),
        'pos_y': torch.as_tensor(rng.standard_normal((n // 2, 3)),
                                 dtype=f32),
        'batch_y': torch.as_tensor(np.sort(rng.integers(0, 8, n // 2))),
        'cora_rows': torch.as_tensor(
            rng.standard_normal((cora_n - n, f)), dtype=f32),
        'cora_coo': torch.as_tensor(rng.integers(0, cora_n, (2, cora_e)))})

    def mp_attr(m, x, d):
        return m(x, d['coo'], d['pseudo'][:, :m.dim], edge_mask=d['mask'])

    def gather(idx, valid, x):
        # a float picture of an index list: x's rows, zero where invalid
        rows = x[idx.clamp(max=x.shape[0] - 1)]
        return torch.where(valid[:, None], rows, 0.0)

    cases = []
    for degree in (1, 2, 3):
        for dim in (1, 2, 3):
            cases.append((f'SplineConv degree {degree} dim {dim}',
                          lambda dev, degree=degree, dim=dim:
                          conv.SplineConv(f, 16, dim=dim, kernel_size=4,
                                          degree=degree, **g(dev)),
                          mp_attr))
    cases += [
        ('SplineConv add', lambda dev: conv.SplineConv(
            f, 16, dim=3, kernel_size=5, aggr='add', **g(dev)), mp_attr),
        ('GMMConv', lambda dev: conv.GMMConv(f, 16, dim=3, kernel_size=4,
                                             **g(dev)), mp_attr),
        ('NNConv', lambda dev: conv.NNConv(
            f, 8, MLP(3, [16, f * 8], **g(dev)), aggr='mean', **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['pseudo'], edge_mask=d['mask'])),
        ('CGConv', lambda dev: conv.CGConv(f, dim=3, **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['pseudo'], edge_mask=d['mask'])),
        ('FeaStConv', lambda dev: conv.FeaStConv(f, 16, heads=4, **g(dev)),
         lambda m, x, d: m(x, d['coo'], edge_mask=d['mask'])),
        ('PointNetConv', lambda dev: conv.PointNetConv(
            MLP(f + 3, [24, 24], **g(dev)), linear(24, 16, **g(dev))),
         lambda m, x, d: m(x, d['pos'], d['coo'], edge_mask=d['mask'])),
        ('PPFConv', lambda dev: conv.PPFConv(MLP(f + 4, [24, 16],
                                                 **g(dev))),
         lambda m, x, d: m(x, d['pos'], d['normal'], d['coo'],
                           edge_mask=d['mask'])),
        ('PointTransformerConv', lambda dev: conv.PointTransformerConv(
            f, 16, attn_nn=linear(16, 16, **g(dev)), **g(dev)),
         lambda m, x, d: m(x, d['pos'], d['coo'], edge_mask=d['mask'])),
        ('DynamicEdgeConv', lambda dev: conv.DynamicEdgeConv(
            MLP(2 * f, [24, 16], norm='batch_norm', **g(dev)), k=10),
         lambda m, x, d: m(x, d['batch'], d['pmask'])),
        ('GravNetConv', lambda dev: conv.GravNetConv(f, 16, k=8, **g(dev)),
         lambda m, x, d: m(x, d['batch'], d['pmask'])),
        ('XConv with x', lambda dev: conv.XConv(f, 16, kernel_size=8,
                                                dilation=2, **g(dev)),
         lambda m, x, d: m(x, d['pos'], d['batch'], d['pmask'])),
        ('XConv without x', lambda dev: conv.XConv(0, 16, kernel_size=8,
                                                   **g(dev)),
         lambda m, x, d: m(None, d['pos'] + x[:, :3], d['batch'])),
        ('knn', lambda dev: torch.nn.Identity(),
         lambda m, x, d: gather(*_edge_pick(
             pool.knn(d['pos'], d['pos_y'], 6, d['batch'], d['batch_y']),
             1), m(x))),
        ('knn_graph', lambda dev: torch.nn.Identity(),
         lambda m, x, d: gather(*_edge_pick(
             pool.knn_graph(d['pos'], 12, d['batch'], mask=d['pmask'])),
             m(x))),
        ('radius_graph', lambda dev: torch.nn.Identity(),
         lambda m, x, d: gather(*_edge_pick(
             pool.radius_graph(d['pos'], 1.0, d['batch'],
                               max_num_neighbors=16)), m(x))),
        ('radius', lambda dev: torch.nn.Identity(),
         lambda m, x, d: gather(*_edge_pick(
             pool.radius(d['pos'], d['pos_y'], 1.0, d['batch'],
                         d['batch_y'], max_num_neighbors=16), 1), m(x))),
        ('nearest', lambda dev: torch.nn.Identity(),
         lambda m, x, d: m(x)[pool.nearest(d['pos_y'], d['pos'],
                                           d['batch_y'], d['batch'])]),
        ('fps', lambda dev: torch.nn.Identity(),
         lambda m, x, d: m(x)[pool.fps(d['pos'], 0.25)]),
        ('voxel_grid', lambda dev: torch.nn.Identity(),
         lambda m, x, d: m(x) * pool.voxel_grid(
             d['pos'], 0.5, d['batch'])[:, None].to(x.dtype) / 1e3),
        ('knn_interpolate', lambda dev: torch.nn.Identity(),
         lambda m, x, d: knn_interpolate(m(x), d['pos'], d['pos_y'], 3,
                                         d['batch'], d['batch_y'])),
        ('L2KNNIndex', lambda dev: torch.nn.Identity(),
         lambda m, x, d: _index_run(torch, pool.L2KNNIndex, m(x))),
        ('MIPSKNNIndex', lambda dev: torch.nn.Identity(),
         lambda m, x, d: _index_run(torch, pool.MIPSKNNIndex, m(x))),
        ('TopKPooling', lambda dev: pool.TopKPooling(f, 0.5, **g(dev)),
         lambda m, x, d: _pool_run(torch, m, x, d)),
        ('SAGPooling', lambda dev: pool.SAGPooling(f, 0.5, **g(dev)),
         lambda m, x, d: _pool_run(torch, m, x, d)),
        ('PANPooling', lambda dev: pool.PANPooling(f, 0.5, device=dev),
         lambda m, x, d: _pool_run(torch, m, x, d)),
        ('GraphUNet Cora', lambda dev: models.GraphUNet(f, 32, 7, depth=3,
                                                        **g(dev)),
         lambda m, x, d: m(torch.cat([x, d['cora_rows']]), d['cora_coo']))]
    return cases


def _edge_pick(graph, col=0):
    """``(index, valid)`` of a knn or radius graph's ``col`` row."""
    coo, valid = graph
    return coo[col], valid


def _index_run(torch, cls, x):
    """A KNN index over x's first half searched by its second half (the
    first 40 index rows excluded for query 0), as a gather of x."""
    half = x.shape[0] // 2
    index = cls(x[:half].detach(), device=x.device)
    out = index.search(x[half:].detach(), 5,
                       torch.stack([torch.zeros(40, dtype=torch.long),
                                    torch.arange(40)]).to(x.device))
    return x[out.index.reshape(-1)] * out.score.reshape(-1, 1)


def _pool_run(torch, m, x, d):
    """A pooling's gated rows and its relabelled edges, as one tensor."""
    out = m(x, d['coo'], d['batch'], 8, int(np.bincount(
        d['batch'].cpu().numpy()).max()))
    e = out.edge_index.to(x.dtype)
    return torch.cat([out.x.reshape(-1), e.reshape(-1) / 1e3,
                      out.edge_mask.to(x.dtype)])


def module_cases(torch, seed):
    """Each convolution, aggregation, norm and pooling function of the
    graph-level slice, the dense round trip, the graph-transformer modules
    (``transformer_cases``) and the propagation convs and model zoo
    (``zoo_cases``), with its inputs: ``(name,
    build(device), run(module, x, inputs))``, ``inputs`` a dict of CPU
    tensors that ``run`` moves with x. One small graph: 2,000 nodes, 20,000
    edges plus 64 padded ones at the sentinel (masked), F = 32, 8
    graphs."""
    from pytorch_geometric_tpu_torch.nn import aggr, conv, norm, pool
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.nn.models import MLP
    from pytorch_geometric_tpu_torch.utils import dense
    n, e, f, pad, graphs = 2000, 20_000, 32, 64, 8
    rng = np.random.default_rng(seed + 70)
    coo = np.concatenate([rng.integers(0, n, (2, e)),
                          np.full((2, pad), n)], 1)
    inputs = {
        'coo': torch.as_tensor(coo),
        'mask': torch.as_tensor(np.concatenate([rng.random(e) < 0.9,
                                                np.zeros(pad, bool)])),
        'ea': torch.as_tensor(rng.standard_normal((e + pad, 8)),
                              dtype=torch.float32),
        'etype': torch.as_tensor(rng.integers(0, 3, e + pad)),
        'batch': torch.as_tensor(np.sort(rng.integers(0, graphs, n))),
        'types': torch.as_tensor(rng.integers(0, 3, n)),
        'msg': torch.as_tensor(rng.standard_normal((n, f)),
                               dtype=torch.float32)}

    def g(device):
        return dict(device=device,
                    generator=torch.Generator().manual_seed(seed + 71))

    def mp(m, x, d):
        return m(x, d['coo'], edge_mask=d['mask'])

    def aggr_run(m, x, d):
        return m(x, d['batch'], graphs)

    cases = [
        ('GINEConv', lambda dev: conv.GINEConv(
            MLP(f, [f, f], **g(dev)), train_eps=True, edge_dim=8,
            generator=g(dev)['generator']),
         lambda m, x, d: m(x, d['coo'], d['ea'], edge_mask=d['mask'])),
        ('GENConv softmax', lambda dev: conv.GENConv(
            f, 24, learn_t=True, msg_norm=True, learn_msg_scale=True,
            edge_dim=8, **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['ea'], d['mask'])),
        ('GENConv powermean', lambda dev: conv.GENConv(
            f, f, aggr_mode='powermean', learn_p=True, **g(dev)),
         lambda m, x, d: m(x, d['coo'], None, d['mask'])),
        ('FiLMConv', lambda dev: conv.FiLMConv(f, 24, num_relations=3,
                                               **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['etype'], d['mask'])),
        ('PDNConv', lambda dev: conv.PDNConv(f, 24, edge_dim=8, **g(dev)),
         lambda m, x, d: m(x, d['coo'][:, :e], d['ea'][:e])),
        ('GeneralConv', lambda dev: conv.GeneralConv(
            f, 24, in_edge_channels=8, attention=True, directed_msg=False,
            **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['ea'], d['mask'])),
        ('PNAConv', lambda dev: conv.PNAConv(
            f, 24, towers=2, edge_dim=8, avg_deg_log=2.3, avg_deg_lin=10.0,
            **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['ea'], d['mask'])),
        ('EGConv', lambda dev: conv.EGConv(
            f, 24, aggregators=('symnorm', 'max', 'std'), num_heads=4,
            **g(dev)),
         lambda m, x, d: m(x, d['coo'][:, :e])),
        ('EdgeConv', lambda dev: conv.EdgeConv(MLP(2 * f, [24, 24],
                                                   **g(dev))), mp),
    ]
    def edge_run(m, x, d):
        # per-edge rows into each destination (about 10 a segment, so a
        # product stays finite)
        return m(x[d['coo'][0].clamp(max=n - 1)],
                 d['coo'][1].clamp(max=n - 1), n, d['mask'])

    for name in ('sum', 'mean', 'max', 'min', 'mul', 'var', 'std',
                 'softmax', 'powermean', 'variance_preserving'):
        cases.append((f'aggr {name}',
                      lambda dev, name=name: aggr.aggregation_resolver(name),
                      edge_run if name == 'mul' else aggr_run))
    cases += [
        ('aggr MultiAggregation proj', lambda dev: aggr.MultiAggregation(
            ('mean', 'max', 'std'), mode='proj', in_channels=3 * f,
            **g(dev)), aggr_run),
        ('aggr DegreeScalerAggregation', lambda dev:
         aggr.DegreeScalerAggregation(scaler=(
             'identity', 'amplification', 'attenuation', 'linear',
             'inverse_linear'), avg_deg_log=2.3, avg_deg_lin=10.0),
         edge_run),
        ('aggr AttentionalAggregation', lambda dev:
         aggr.AttentionalAggregation(linear(f, 1, **g(dev)),
                                     linear(f, 16, **g(dev))), aggr_run),
        ('aggr Set2Set', lambda dev: aggr.Set2Set(f, 3, **g(dev)),
         aggr_run),
        ('aggr DeepSetsAggregation', lambda dev: aggr.DeepSetsAggregation(
            linear(f, 16, **g(dev)), linear(16, 8, **g(dev))), aggr_run),
        ('norm BatchNorm', lambda dev: norm.BatchNorm(f, device=dev),
         lambda m, x, d: m(x)),
        ('norm DiffGroupNorm', lambda dev: norm.DiffGroupNorm(f, **g(dev)),
         lambda m, x, d: m(x)),
        ('norm HeteroBatchNorm', lambda dev: norm.HeteroBatchNorm(
            f, 3, device=dev), lambda m, x, d: m(x, d['types'])),
        ('norm HeteroLayerNorm', lambda dev: norm.HeteroLayerNorm(
            f, 3, device=dev), lambda m, x, d: m(x, d['types'])),
        ('norm MsgNorm', lambda dev: norm.MsgNorm(True, device=dev),
         lambda m, x, d: m(x, d['msg']))]
    for name, kw in (('InstanceNorm', {'affine': True}), ('LayerNorm', {}),
                     ('LayerNorm node', {'mode': 'node'}), ('GraphNorm', {}),
                     ('GraphSizeNorm', None), ('PairNorm', None),
                     ('MeanSubtractionNorm', None)):
        cls = getattr(norm, name.split()[0])
        cases.append((f'norm {name}',
                      (lambda dev, cls=cls, kw=kw: cls(f, device=dev, **kw))
                      if kw is not None else (lambda dev, cls=cls: cls()),
                      lambda m, x, d: m(x, d['batch'], graphs)))
    for name in ('global_add_pool', 'global_mean_pool', 'global_max_pool'):
        fn = getattr(pool, name)
        cases.append((name, lambda dev: torch.nn.Identity(),
                      lambda m, x, d, fn=fn: fn(m(x), d['batch'], graphs)))
    cap = int(np.bincount(inputs['batch'].numpy()).max())

    def dense_run(m, x, d):
        # the edges inside a graph, weighted by x, to the padded dense
        # adjacency and back; each node's weights summed by source and by
        # destination, so a wrong index shows in the output
        s, t = d['coo'][:, :e]
        s, t = (v[d['batch'][s] == d['batch'][t]] for v in (s, t))
        adj = dense.to_dense_adj(torch.stack([s, t]), d['batch'], graphs,
                                 cap, (m(x)[s] * x[t]).sum(-1))
        _, mask = dense.to_dense_batch(x, d['batch'], graphs, cap)
        coo, w = dense.dense_to_sparse(adj, mask)
        return torch.stack([x.new_zeros(n).index_add(0, coo[0], w),
                            x.new_zeros(n).index_add(0, coo[1], w)], 1)

    cases.append(('to_dense_adj / dense_to_sparse',
                  lambda dev: torch.nn.Identity(), dense_run))
    cases += transformer_cases(torch, seed, inputs, n, e, f, graphs, cap, g)
    cases += zoo_cases(torch, seed, inputs, n, e, f, graphs, g)
    cases += point_cases(torch, seed, inputs, n, e, f, g)
    cases += cluster_cases(torch, seed, inputs, n, e, f, graphs, cap, g)
    cases += molecule_cases(torch, seed, inputs, n, e, f, graphs, g)
    return cases, inputs, n, f


# the kernel launches of a module case's card run (forward and backward):
# kernel 1 in the GCN layers on the cached normalisation, once forward and
# once A^T g each (x needs a gradient); AttentiveFP's atom GATConv over the
# slot orders, the mix kernel's stabiliser pass and mix forward, its
# grad_v pass and the per-edge dot kernel's grad_p_u backward; no other
# case launches a kernel
MODULE_KERNELS = {'SGFormer cached': {'segment_spmm': 4},
                  'Polynormer local cached': {'segment_spmm': 4},
                  'Polynormer global cached': {'segment_spmm': 4},
                  'AttentiveFP fused': {'gat_mix': 3, 'edge_dot': 1}}


def transformer_cases(torch, seed, inputs, n, e, f, graphs, cap, g):
    """``module_cases``' graph-transformer modules: ``RGATConv`` in every
    mechanism, mode and mod (``num_bases`` and ``edge_dim`` in turn),
    ``HEATConv`` both ways, ``GPSConv`` with each attention, the four
    attention modules and flax's multi-head attention over the dense batch,
    ``SGFormer`` and ``Polynormer`` (local and global) on the cached GCN
    normalisation, ``GraphMixer`` and the encodings. Adds the link
    tensors ``GraphMixer`` reads to ``inputs``."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn import attention, conv, encoding
    from pytorch_geometric_tpu_torch.nn.conv import cache_gcn_norm
    from pytorch_geometric_tpu_torch.nn.models import (MLP, GraphMixer,
                                                       Polynormer, SGFormer)
    from pytorch_geometric_tpu_torch.utils.dense import to_dense_batch
    rng = np.random.default_rng(seed + 74)
    tokens = 8
    inputs['times'] = torch.as_tensor(rng.random((n // tokens, tokens)) * 50,
                                      dtype=torch.float32)
    inputs['links'] = torch.as_tensor(rng.random((n // tokens, tokens))
                                      < 0.8)
    cases = []
    for i, (mech, mode, mod) in enumerate(
            (a, b, c) for a in ('across-relation', 'within-relation')
            for b in ('additive-self-attention',
                      'multiplicative-self-attention')
            for c in (None, 'f-additive', 'f-scaled')):
        kw = dict(num_relations=3, num_bases=2 if i % 2 else None,
                  heads=2, dim=1 if mode.startswith('add') else 2,
                  concat=i % 3 != 2, attention_mechanism=mech,
                  attention_mode=mode, mod=mod,
                  edge_dim=8 if (i // 2) % 2 else None)
        cases.append((f'RGATConv {mech} {mode.split("-")[0]} {mod}',
                      lambda dev, kw=kw: conv.RGATConv(f, 12, **kw, **g(dev)),
                      lambda m, x, d, kw=kw: m(
                          x, d['coo'], d['etype'],
                          d['ea'] if kw['edge_dim'] else None, d['mask'])))
    for concat in (True, False):
        cases.append((f'HEATConv concat={concat}', lambda dev, c=concat:
                      conv.HEATConv(f, 16, num_node_types=3,
                                    num_edge_types=3, edge_dim=8, heads=2,
                                    concat=c, **g(dev)),
                      lambda m, x, d: m(x, d['coo'], d['types'], d['etype'],
                                        d['ea'], d['mask'])))
    for attn in ('multihead', 'performer'):
        cases.append((f'GPSConv {attn}', lambda dev, a=attn: conv.GPSConv(
            f, conv.GINEConv(MLP(f, [f, f], **g(dev)), edge_dim=8,
                             generator=g(dev)['generator']),
            heads=4, attn_type=a, **g(dev)),
            lambda m, x, d: m(x, d['coo'], d['batch'], graphs, cap,
                              edge_mask=d['mask'], edge_attr=d['ea'])))

    def dense(x, d):
        return to_dense_batch(x, d['batch'], graphs, cap)

    for name, make, as_float in (
            ('PerformerAttention', lambda dev: attention.PerformerAttention(
                f, 4, **g(dev)), True),
            ('SGFormerAttention', lambda dev: attention.SGFormerAttention(
                f, 2, head_channels=16, **g(dev)), True),
            ('PolynormerAttention', lambda dev:
             attention.PolynormerAttention(f, 2, qk_shared=False, **g(dev)),
             True),
            ('QFormer', lambda dev: attention.QFormer(f, 16, num_queries=8,
                                                      **g(dev)), False)):
        cases.append((name, make, lambda m, x, d, fl=as_float: m(
            dense(x, d)[0], mask=(dense(x, d)[1].float() if fl
                                  else dense(x, d)[1]))))
    cases.append(('MultiHeadDotProductAttention', lambda dev:
                  attention.MultiHeadDotProductAttention(f, 4, **g(dev)),
                  lambda m, x, d: m(dense(x, d)[0], mask=dense(x, d)[1][
                      :, None, None, :])))

    def cached(x, d):
        return cache_gcn_norm(EdgeIndex(d['coo'][:, :e], (n, n),
                                        device=x.device), auto=True)

    cases.append(('SGFormer cached', lambda dev: SGFormer(
        f, 32, 5, trans_num_layers=1, gnn_num_layers=2, cached=True,
        **g(dev)), lambda m, x, d: m(x, cached(x, d))))
    for glob in (False, True):
        cases.append((f'Polynormer {"global" if glob else "local"} cached',
                      lambda dev, gl=glob: Polynormer(
                          f, 16, 5, local_layers=2, global_layers=1,
                          heads=2, use_global=gl, cached=True, **g(dev)),
                      lambda m, x, d: m(x, cached(x, d))))
    cases.append(('GraphMixer', lambda dev: GraphMixer(
        f, 24, 6, num_tokens=tokens, time_channels=8, **g(dev)),
        lambda m, x, d: m(x.view(n // tokens, tokens, f), d['times'],
                          d['links'])))
    cases += [
        ('PositionalEncoding', lambda dev: encoding.PositionalEncoding(16),
         lambda m, x, d: m(x[:, 0] * 10)),
        ('TemporalEncoding', lambda dev: encoding.TemporalEncoding(16),
         lambda m, x, d: m(x[:, 0] * 10)),
        ('TimeEncoder', lambda dev: encoding.TimeEncoder(16, **g(dev)),
         lambda m, x, d: m(x[:, 0] * 10))]
    return cases


def zoo_cases(torch, seed, inputs, n, e, f, graphs, g):
    """``module_cases``' propagation convs and model zoo: every class of
    ``nn/conv/spectral_conv.py``, the rest of ``graph_conv.py``,
    ``misc_conv.py``, ``dna_conv.py``, ``nn/models/misc_models.py`` and
    ``autoencoder.py`` (the propagations and ``LabelPropagation`` with edge
    weights, ``CorrectAndSmooth`` in both arms), on the masked COO where a
    class takes a mask; ``AntiSymmetricConv``'s ``GCNConv`` phi on an
    ``EdgeIndex`` with its caches filled; ``JumpingKnowledge('lstm')``.
    Each run returns one tensor (a tuple's parts and losses flattened into
    it). Adds the tensors they read to ``inputs``: edge weights, a second
    (negative) edge set, node pairs, noise, a permutation, labels and
    training rows, hyperedges, mesh rings, positions, PANConv's 300-node
    subgraph."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.nn import conv, models
    from pytorch_geometric_tpu_torch.nn.inits import linear
    from pytorch_geometric_tpu_torch.nn.norm.norms import RunningBatchNorm
    from pytorch_geometric_tpu_torch.ops import scatter
    rng = np.random.default_rng(seed + 75)
    pad = inputs['coo'].shape[1] - e
    k, c, hyper, sub = 24, 5, 300, 300
    f32 = torch.float32
    coo = inputs['coo'].numpy()
    inner = (coo[0] < sub) & (coo[1] < sub)
    hyper_inc = np.stack([rng.integers(0, n, 3 * n), rng.integers(0, hyper,
                                                                   3 * n)])
    inputs.update({
        'w': torch.as_tensor(rng.uniform(0.5, 1.5, e + pad), dtype=f32),
        'neg_coo': torch.as_tensor(rng.integers(0, n, (2, e // 2))),
        'neg_mask': torch.as_tensor(rng.random(e // 2) < 0.9),
        'pairs': torch.as_tensor(rng.integers(0, n, (2, 500))),
        'neg_pairs': torch.as_tensor(rng.integers(0, n, (2, 500))),
        'noise': torch.as_tensor(rng.standard_normal((n, 16)), dtype=f32),
        'perm': torch.as_tensor(rng.permutation(n)),
        'labels': torch.as_tensor(rng.integers(0, c, n)),
        'train': torch.as_tensor(rng.random(n) < 0.3),
        'hyper': torch.as_tensor(hyper_inc),
        'hyper_w': torch.as_tensor(rng.uniform(0.5, 2.0, hyper), dtype=f32),
        'hyper_mask': torch.as_tensor(rng.random(3 * n) < 0.9),
        'ring': torch.as_tensor(rng.integers(0, n, (n, 4))),
        'pos': torch.as_tensor(rng.standard_normal((n, 3)), dtype=f32),
        'sub': torch.as_tensor(coo[:, inner])})

    def flat(*parts):
        return torch.cat([p.reshape(-1) for p in parts])

    def mp(m, x, d):
        return m(x, d['coo'], edge_mask=d['mask'])

    def mpw(m, x, d):
        return m(x, d['coo'], edge_weight=d['w'], edge_mask=d['mask'])

    def cached(x, d):
        return EdgeIndex(d['coo'][:, :e], (n, n),
                         device=x.device).fill_cache()

    def soft(x):
        return torch.softmax(x[:, :c], -1)

    def one_hot(d, x):
        return torch.nn.functional.one_hot(d['labels'], c).to(x.dtype)

    def dgi_run(m, x, d):
        m.corruption = lambda xs, ei, **kw: (xs[d['perm']], ei)
        pos, neg, s = m(x, d['coo'], edge_mask=d['mask'])
        return flat(pos, neg, s, m.loss(pos, neg, s))

    def lightgcn_run(m, x, d):
        pos = m(d['coo'], d['pairs'], edge_mask=d['mask'])
        neg = m(d['coo'], d['neg_pairs'], edge_mask=d['mask'])
        return flat(pos, m.recommendation_loss(pos, neg, 1e-4,
                                               m.parameters()))

    def cs_run(cs):
        def run(m, x, d):
            y_true = one_hot(d, x)
            out = cs.correct(soft(x), y_true, d['train'], d['coo'], d['w'])
            return flat(out, cs.smooth(out, y_true, d['train'], d['coo']))
        return run

    class MetaEdge(torch.nn.Module):
        def __init__(self, dev):
            super().__init__()
            self.lin = linear(2 * f + 8, 16, **g(dev))

        def forward(self, src, dst, ea, u, batch):
            return self.lin(torch.cat([src, dst, ea], -1))

    class MetaNode(torch.nn.Module):
        def __init__(self, dev):
            super().__init__()
            self.lin = linear(f + 16, f, **g(dev))

        def forward(self, x, edges, ea, u, batch):
            agg = scatter(ea, edges[1], x.shape[0], 'mean')
            return self.lin(torch.cat([x, agg], -1))

    class VEncoder(torch.nn.Module):
        def __init__(self, dev):
            super().__init__()
            self.conv_mu = conv.GCNConv(f, 16, **g(dev))
            self.conv_logstd = conv.GCNConv(f, 16, **g(dev))

        def forward(self, x, ei, edge_mask=None):
            return (self.conv_mu(x, ei, edge_mask=edge_mask),
                    self.conv_logstd(x, ei, edge_mask=edge_mask))

    def discriminator(dev):
        return torch.nn.Sequential(linear(16, 16, **g(dev)), torch.nn.ReLU(),
                                   linear(16, 1, **g(dev)))

    def autoencoder_run(m, x, d):
        if isinstance(m, (models.VGAE, models.ARGVA)):
            z, mu, logstd = m(x, d['coo'], noise=d['noise'],
                              edge_mask=d['mask'])
            parts = [z, mu, logstd, m.kl_loss(mu, logstd)]
        else:
            z = m(x, d['coo'], edge_mask=d['mask'])
            parts = [z]
        if isinstance(m, models.ARGA):
            parts += [m.reg_loss(z), m.discriminator_loss(z,
                                                          noise=d['noise'])]
        return flat(*parts, m.recon_loss(z, d['pairs'], d['neg_pairs']))

    cases = [
        ('ChebConv', lambda dev: conv.ChebConv(f, k, K=3, **g(dev)), mpw),
        ('ARMAConv shared', lambda dev: conv.ARMAConv(
            f, k, num_stacks=2, num_layers=2, shared_weights=True, **g(dev)),
         mpw),
        ('SGConv', lambda dev: conv.SGConv(f, k, K=2, **g(dev)), mpw),
        ('SSGConv', lambda dev: conv.SSGConv(f, k, alpha=0.2, K=3, **g(dev)),
         mpw),
        ('TAGConv', lambda dev: conv.TAGConv(f, k, K=3, **g(dev)), mpw),
        ('APPNP', lambda dev: conv.APPNP(K=5, alpha=0.2), mpw),
        ('MixHopConv', lambda dev: conv.MixHopConv(f, k, **g(dev)), mpw),
        ('ResGatedGraphConv', lambda dev: conv.ResGatedGraphConv(f, k,
                                                                 **g(dev)),
         mp),
        ('GatedGraphConv', lambda dev: conv.GatedGraphConv(40, num_layers=2,
                                                           **g(dev)), mpw),
        ('LEConv', lambda dev: conv.LEConv(f, k, **g(dev)), mpw),
        ('MFConv', lambda dev: conv.MFConv(f, k, max_degree=12, **g(dev)),
         mp),
        ('FAConv', lambda dev: conv.FAConv(f, **g(dev)),
         lambda m, x, d: m(x, d['coo'], x_0=0.5 * x, edge_mask=d['mask'])),
        ('AGNNConv', lambda dev: conv.AGNNConv(device=dev), mp),
        ('WLConvContinuous', lambda dev: conv.WLConvContinuous(), mpw),
        ('LGConv', lambda dev: conv.LGConv(), mpw),
        ('SignedConv first', lambda dev: conv.SignedConv(f, k, **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['neg_coo'], d['mask'],
                           d['neg_mask'])),
        ('SignedConv deep', lambda dev: conv.SignedConv(
            f // 2, k, first_aggr=False, **g(dev)),
         lambda m, x, d: m(x, d['coo'], d['neg_coo'], d['mask'],
                           d['neg_mask'])),
        ('DirGNNConv', lambda dev: conv.DirGNNConv(
            conv.ResGatedGraphConv(f, k, **g(dev)), alpha=0.3, **g(dev)), mp),
        ('AntiSymmetricConv EdgeIndex', lambda dev: conv.AntiSymmetricConv(
            f, num_iters=2, **g(dev)), lambda m, x, d: m(x, cached(x, d))),
        ('HypergraphConv', lambda dev: conv.HypergraphConv(f, k, **g(dev)),
         lambda m, x, d: m(x, d['hyper'], d['hyper_w'], hyper,
                           d['hyper_mask'])),
        ('WLConv', lambda dev: conv.WLConv(),
         lambda m, x, d: m(d['types'], d['coo']).to(x.dtype)[:, None] * x),
        ('MeshCNNConv', lambda dev: conv.MeshCNNConv(f, k, **g(dev)),
         lambda m, x, d: m(x, d['ring'])),
        ('SimpleConv', lambda dev: conv.SimpleConv('mean', 'self_loop'), mpw),
        ('GCN2Conv', lambda dev: conv.GCN2Conv(
            f, alpha=0.2, theta=0.5, layer=2, shared_weights=False, **g(dev)),
         lambda m, x, d: m(x, 0.5 * x, d['coo'], d['w'], d['mask'])),
        ('PointGNNConv', lambda dev: conv.PointGNNConv(f, **g(dev)),
         lambda m, x, d: m(x, d['pos'], d['coo'], d['mask'])),
        ('DNAConv', lambda dev: conv.DNAConv(f, heads=4, groups=2, **g(dev)),
         lambda m, x, d: m(torch.stack([x, 0.5 * x, torch.tanh(x)], 1),
                           d['coo'], d['w'], d['mask'])),
        ('PANConv', lambda dev: conv.PANConv(f, k, filter_size=2, **g(dev)),
         lambda m, x, d: flat(*m(x[:sub], d['sub'])))]
    for mode in ('cat', 'max', 'lstm'):
        cases.append((f'JumpingKnowledge {mode}',
                      lambda dev, mode=mode: models.JumpingKnowledge(
                          mode, f, 3, **g(dev)),
                      lambda m, x, d: m([x, torch.tanh(x), 0.5 * x])))
    cases += [
        ('HeteroJumpingKnowledge lstm', lambda dev:
         models.HeteroJumpingKnowledge(('a', 'b'), 'lstm', f, 2, **g(dev)),
         lambda m, x, d: flat(*m({'a': [x, torch.tanh(x)],
                                  'b': [x[:100], x[100:200]]}).values())),
        ('DeepGraphInfomax', lambda dev: models.DeepGraphInfomax(
            k, conv.GCNConv(f, k, **g(dev)), **g(dev)), dgi_run),
        ('LightGCN', lambda dev: models.LightGCN(n, 16, 2, **g(dev)),
         lightgcn_run),
        ('LabelPropagation', lambda dev: models.LabelPropagation(5, 0.8),
         lambda m, x, d: m(soft(x), d['coo'], label_mask=d['train'],
                           edge_weight=d['w'])),
        ('CorrectAndSmooth autoscale', lambda dev: torch.nn.Identity(),
         cs_run(models.CorrectAndSmooth(5, 0.8, 5, 0.8))),
        ('CorrectAndSmooth fixed scale', lambda dev: torch.nn.Identity(),
         cs_run(models.CorrectAndSmooth(8, 1.0, 8, 0.8, scale=20.0,
                                        autoscale=False))),
        ('LINKX', lambda dev: models.LINKX(n, f, 16, c, 2, 2, 2, **g(dev)),
         mpw),
        ('PMLP', lambda dev: models.PMLP(f, 16, c, 3, **g(dev)),
         lambda m, x, d: m(x, d['coo'][:, :e], use_conv=True)),
        ('MaskLabel', lambda dev: models.MaskLabel(c, f, **g(dev)),
         lambda m, x, d: m(x, d['labels'], d['train'])),
        ('MetaLayer', lambda dev: models.MetaLayer(MetaEdge(dev),
                                                   MetaNode(dev)),
         lambda m, x, d: flat(*m(x, d['coo'][:, :e], d['ea'][:e])[:2])),
        ('NeuralFingerprint', lambda dev: models.NeuralFingerprint(
            f, 16, c, 2, **g(dev)),
         lambda m, x, d: m(x, d['coo'][:, :e], d['batch'], graphs)),
        ('DeepGCNLayer', lambda dev: models.DeepGCNLayer(
            conv.GCNConv(f, f, **g(dev)), RunningBatchNorm(f, device=dev)),
         lambda m, x, d: m(x, d['coo'][:, :e], edge_weight=d['w'][:e])),
        ('ARLinkPredictor', lambda dev: models.ARLinkPredictor(
            f, 16, num_layers=3, **g(dev)), lambda m, x, d: m(x, d['pairs'])),
        ('InnerProductDecoder', lambda dev: models.InnerProductDecoder(),
         lambda m, x, d: flat(m(x, d['pairs']), m.decode_all(x[:200])))]
    for name, make in (
            ('GAE', lambda dev: models.GAE(conv.GCNConv(f, 16, **g(dev)))),
            ('VGAE', lambda dev: models.VGAE(VEncoder(dev))),
            ('ARGA', lambda dev: models.ARGA(conv.GCNConv(f, 16, **g(dev)),
                                             discriminator(dev))),
            ('ARGVA', lambda dev: models.ARGVA(VEncoder(dev),
                                               discriminator(dev)))):
        cases.append((name, make, autoencoder_run))
    return cases


def data_cases(torch, seed):
    """The data plumbing of the datasets slice on the card against the
    CPU, each result within 1e-4 * max(1, max|CPU|) and on the device it
    was asked for: ``InMemoryFeatureStore`` (a table put on the device,
    rows rewritten through an index, rows read through another),
    ``InMemoryGraphStore`` (the CSC and CSR of a COO on the device),
    ``HypergraphData.to`` (the class and hyperedge count kept; a
    ``HypergraphConv`` over the moved incidence), ``LightningNodeData``'s
    train loader over a graph whose features lie on the device (its
    batches gathered there) and ``summary`` of a dataset of graphs on the
    device; and each dataset family of ``DATA_FAMILIES``, parsed once on the
    host from ``dataset_raws``' files by the port's class, every graph moved
    to the device and its tensors read there (bitwise: the limit is met
    only by equal values). None launches a port kernel. Returns ``(rows,
    worst)``."""
    import tempfile
    from pytorch_geometric_tpu_torch import datasets as tds
    from pytorch_geometric_tpu_torch.data import (
        Data, HypergraphData, InMemoryFeatureStore, InMemoryGraphStore,
        LightningNodeData, summary)
    from pytorch_geometric_tpu_torch.nn import HypergraphConv
    parsed = {}
    with tempfile.TemporaryDirectory() as root:
        spec = dataset_raws(torch, root, seed)
        for fam in DATA_FAMILIES:
            name, args, kw = spec[fam]
            ds = getattr(tds, name)(*args, **kw)
            parsed[fam] = [ds[i] for i in range(len(ds))]
    rng = np.random.default_rng(seed + 95)
    n, f, e, m = 600, 12, 4000, 90
    x = rng.standard_normal((n, f)).astype(np.float32)
    coo = rng.integers(0, n, (2, e))
    inc = np.stack([rng.integers(0, n, 3 * n), rng.integers(0, m, 3 * n)])
    y = rng.integers(0, 4, n)
    train = rng.random(n) < 0.3

    def run(dev):
        out = {}
        fs = InMemoryFeatureStore()
        fs['paper', 'x'] = torch.as_tensor(x, device=dev)
        fs.put_tensor(torch.full((4, f), 2.0, device=dev), 'paper', 'x',
                      index=torch.tensor([3, 1, 7, 400], device=dev))
        out['feature store'] = fs.get_tensor(
            'paper', 'x', index=torch.arange(0, n, 3, device=dev))
        gs = InMemoryGraphStore()
        gs.put_edge_index(torch.as_tensor(coo, device=dev), ('p', 'c', 'p'))
        out['graph store csc'] = torch.cat(gs.csc(('p', 'c', 'p')))
        out['graph store csr'] = torch.cat(gs.csr(('p', 'c', 'p')))
        hg = HypergraphData(x=x, edge_index=inc, num_hyperedges=m).to(dev)
        check(type(hg) is HypergraphData and hg.num_hyperedges == m,
              f'HypergraphData.to({dev}) gave {type(hg).__name__} with '
              f'{hg.num_hyperedges} hyperedges')
        conv = HypergraphConv(f, 8, device=dev,
                              generator=torch.Generator().manual_seed(seed))
        out['HypergraphData.to + HypergraphConv'] = conv(
            hg.x, hg.edge_index, num_edges=hg.num_hyperedges).detach()
        data = Data(x=torch.as_tensor(x, device=dev), edge_index=coo, y=y,
                    train_mask=train, num_nodes=n)
        batch = next(iter(LightningNodeData(
            data, num_neighbors=[5, 3], batch_size=32,
            seed=seed).train_dataloader()))
        out['LightningNodeData batch x'] = batch.x
        graphs = [Data(x=torch.zeros((k, 2), device=dev),
                       edge_index=rng_edges[:, :2 * k], num_nodes=k)
                  for k, rng_edges in ((30, coo % 30), (45, coo % 45),
                                       (12, coo % 12))]
        s = summary(graphs)
        out['summary'] = torch.tensor([
            s.num_graphs, *(getattr(st, k) for st in (s.num_nodes,
                                                      s.num_edges)
                            for k in ('mean', 'std', 'min', 'quantile25',
                                      'median', 'quantile75', 'max'))],
            dtype=torch.float64)
        for fam, graphs in parsed.items():
            moved = [d.to(dev) for d in graphs]
            vals = [t for d in moved for _, t in sorted(d.items())
                    if isinstance(t, torch.Tensor)]
            check(all(t.device.type == dev for t in vals),
                  f'{fam}: a tensor left off {dev}')
            flat = torch.cat([t.reshape(-1).double() for t in vals] + [
                torch.tensor([float(d.num_nodes) for d in moved],
                             dtype=torch.float64, device=dev)])
            # a missing label (MoleculeNet's) is NaN: its place is compared
            out[f'dataset {fam}'] = torch.cat([
                torch.nan_to_num(flat, nan=0.0), flat.isnan().double()])
        for k, v in out.items():
            if k != 'summary':
                check(v.device.type == dev, f'{k}: on {v.device} for {dev}')
        return {k: v.cpu() for k, v in out.items()}

    ref = run('cpu')
    reset_counts()
    got = run('cuda')
    check_counts('data cases', launch_counts(), {}, 'their card runs')
    rows, worst = [], 0.0
    for k, r in ref.items():
        g = got[k]
        check(g.shape == r.shape and g.dtype == r.dtype,
              f'{k}: {g.dtype} {tuple(g.shape)} on the card, {r.dtype} '
              f'{tuple(r.shape)} on the CPU')
        err = float((g.double() - r.double()).abs().max()) / max(
            1.0, float(r.double().abs().max()))
        check(err <= 1e-4, f'{k}: {err} from the CPU')
        worst = max(worst, err)
        rows.append({'case': k, 'rel_err': err})
    log(f'[modules] {len(rows)} data cases on the card against the CPU: '
        f'worst {worst:.3e} (limit 1e-4); ' + ', '.join(
            f"{r['case']} {r['rel_err']:.1e}" for r in rows))
    return rows, worst


def phase_graph_modules(torch, seed):
    """Each convolution, aggregation, norm and pooling function of the
    graph-level slice, each graph-transformer module and each class of the
    propagation convs and model zoo (``module_cases``) once on the card,
    forward and backward in training mode, against the same module on the
    CPU from the same weights: the output within 1e-4 * max(1, max|CPU|)
    and every
    gradient (input and parameters) within 1e-4 of its largest on the CPU,
    or of the largest of all for one that vanishes in exact arithmetic
    (under 1e-6 of the largest on the CPU: a softmax gate's bias); the
    output on the card; each card run launches the port kernels
    ``MODULE_KERNELS`` names for it (kernel 1 in the cached GCN layers),
    and no case any other. Catches an op that runs only on the CPU or a
    tensor left on the wrong device."""
    cases, inputs, n, f = module_cases(torch, seed)
    x_cpu = torch.randn((n, f), generator=torch.Generator().manual_seed(
        seed + 72))
    worst, rows, total = 0.0, [], {}
    for name, build, run in cases:
        res = []
        for dev in ('cpu', 'cuda'):
            if dev == 'cuda':
                reset_counts()
            m = build(dev).train()
            if res:
                m.load_state_dict({k: v.to(dev) for k, v in state.items()})
            else:
                state = m.state_dict()
            x = x_cpu.to(dev, copy=True).requires_grad_()
            d = {k: v.to(dev) for k, v in inputs.items()}
            out = run(m, x, d)
            check(out.device.type == dev, f'{name}: output on '
                                          f'{out.device} for {dev}')
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(seed + 73)).to(dev)
            (out * cot).sum().backward()
            # a model of the graph alone (LightGCN) leaves x without one
            grads = {} if x.grad is None else {'x': x.grad}
            grads.update({k: p.grad for k, p in m.named_parameters()
                          if p.grad is not None})
            res.append((out.detach().cpu(), {k: v.cpu()
                                             for k, v in grads.items()}))
        counts = launch_counts()
        check_counts(name, counts, MODULE_KERNELS.get(name, {}),
                     'its card run')
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        (o_cpu, g_cpu), (o_card, g_card) = res
        check(set(g_cpu) == set(g_card), f'{name}: gradients '
                                         f'{sorted(g_cpu)} / {sorted(g_card)}')
        err = float((o_card - o_cpu).abs().max()) / max(
            1.0, float(o_cpu.abs().max()))
        check(err <= 1e-4, f'{name}: output {err} from the CPU')
        largest = max(float(g.abs().max()) for g in g_cpu.values())
        gerr = 0.0
        for k, ref in g_cpu.items():
            own = float(ref.abs().max())
            scale = largest if own <= 1e-6 * largest else own
            d = float((g_card[k] - ref).abs().max()) / max(scale, 1e-30)
            gerr = max(gerr, d)
            check(d <= 1e-4, f'{name}: gradient of {k} {d} of its largest '
                             'from the CPU')
        worst = max(worst, err, gerr)
        rows.append({'module': name, 'out_rel_err': err,
                     'grad_rel_err': gerr, 'params': len(g_cpu) - 1})
    log(f'[modules] {len(rows)} graph-level modules on the card against '
        f'the CPU, forward and backward: worst {worst:.3e} (limit 1e-4); '
        + ', '.join(f"{r['module']} {max(r['out_rel_err'], r['grad_rel_err']):.1e}"
                    for r in rows))
    data_rows, data_worst = data_cases(torch, seed)
    return {'modules': rows, 'worst': max(worst, data_worst),
            'launch_counts': total, 'data_cases': data_rows,
            'host_decisions': host_decision_checks(torch, seed, inputs, n,
                                                   f)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=2)
    args = ap.parse_args()

    if not (ROOT / 'pytorch_geometric_tpu_torch' / 'csrc').is_dir():
        log('chip_smoke: the pytorch_geometric_tpu_torch package is not '
            f'next to this script in {ROOT}')
        return 2
    import torch
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA card is visible')
        return 2
    sys.path.insert(0, str(ROOT))
    from pytorch_geometric_tpu_torch import csrc
    t_run = time.perf_counter()

    def lap(what):
        """The run's seconds so far, after a group of phases: where the
        time limit goes."""
        log(f'[time] {time.perf_counter() - t_run:.1f} s: {what} done')

    phase_device(torch)
    phase_build(csrc)
    worst = phase_kernel_vs_plain(torch, args.seed)
    worst_seg_bf16 = phase_kernel_bf16_vs_plain(torch, args.seed)
    pa = build_path_a(torch, args.seed)
    worst_bsr = phase_bsr_vs_plain(torch, args.seed, pa)
    worst_bwd = phase_segment_backward_vs_plain(torch, args.seed, pa)
    serving = phase_serving(torch, args.seed, args.iters, args.warmup)
    shapes, serving_sweep = phase_timings(torch, args.seed)
    path_a = phase_path_a(torch, args.seed, pa)
    path_b = phase_path_b(torch, args.seed)
    bsr_rows, seg_rows = phase_training_timings(torch, args.seed, pa)
    lap('build, kernel checks, serving, paths A and B')
    del pa
    torch.cuda.empty_cache()
    pe = build_path_a(torch, args.seed, bf16=True)
    worst_bsr_bf16 = phase_bsr_vs_plain(torch, args.seed, pe, bf16=True)
    path_e = phase_path_a(torch, args.seed, pe, bf16=True)
    path_f = phase_path_f(torch, args.seed)
    path_g = phase_path_g(torch, args.seed, args.iters, args.warmup)
    path_h = phase_path_h(torch, args.seed, args.iters, args.warmup)
    pc = build_path_c(torch, args.seed)
    worst_mix = phase_gat_mix_vs_plain(torch, args.seed, pc)
    worst_max = phase_segment_max_vs_plain(torch, args.seed, pc)
    worst_mix_bf16 = phase_gat_mix_bf16_vs_plain(torch, args.seed, pc)
    worst_dot = phase_edge_dot_vs_plain(torch, args.seed, pc)
    path_c = phase_path_c(torch, args.seed, args.iters, args.warmup, pc)
    path_d = phase_path_d(torch, args.seed, pc)
    path_i = phase_path_i(torch, args.seed, args.iters, args.warmup, pc)
    path_j = phase_path_j(torch, args.seed, pc)
    mix_rows, max_row, sweep, sweep_bf16 = phase_attention_timings(
        torch, args.seed, pc)
    dot_rows, dot_sweep = phase_edge_dot_timings(torch, args.seed, pc,
                                                 path_i, path_d)
    bf16_rows = phase_bf16_timings(torch, args.seed, pe, pc)
    lap('paths C-J and their timings')
    del pe
    worst_flash = phase_flash_vs_plain(torch, args.seed)
    paths_lm = phase_path_lm(torch, args.seed, pc, args.iters)
    pc_coo = {'coo': pc['coo']}
    del pc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    coo = products_graph(N_PRODUCTS, E_PRODUCTS, args.seed)
    log(f'[products] products_bench graph ({N_PRODUCTS} nodes, {E_PRODUCTS} '
        f'edges, seed {args.seed}) built on the host in '
        f'{time.perf_counter() - t0:.1f} s')
    lap('the flash checks, paths L and M, the products graph')
    scan, sage, pr_data, pr_row = phase_scan_train(torch, args.seed, coo)
    lap('the scan phase')
    layerwise, sampled_rows, worst_sampled = phase_layerwise(
        torch, args.seed, sage, pr_data, pr_row)
    del sage, pr_data, pr_row
    torch.cuda.empty_cache()
    lap('layer-wise serving')
    path_k = phase_path_k(torch, args.seed, coo, args.iters)
    torch.cuda.empty_cache()
    flash_rows, worst_flash_t = phase_flash_timings(torch, args.seed, coo,
                                                    pc_coo)
    torch.cuda.empty_cache()
    lap('path K and the flash timings')
    # the SpMM regimes: the arms forced by their knobs, then products
    # full-graph serving (R) and training (S) through fill_cache(auto=True)
    regime_arms, gradw_rows = phase_regime_arms(torch, args.seed)
    path_r, r_rows = phase_path_r(torch, args.seed, coo, args.iters,
                                  args.warmup)
    torch.cuda.empty_cache()
    path_s, s_row = phase_path_s(torch, args.seed, coo, args.iters)
    torch.cuda.empty_cache()
    lap('the regime arms, paths R and S')
    # Correct & Smooth on the same graph (Z)
    t0 = time.perf_counter()
    path_z = phase_path_z(torch, args.seed, coo)
    del coo
    torch.cuda.empty_cache()
    log(f'[time] path Z took {time.perf_counter() - t0:.1f} s')
    lap('path Z')
    # the heterogeneous paths on hetero_bench.py's graph: full scale for N,
    # P and Q, its default 0.25 for O
    t0 = time.perf_counter()
    mag = build_mag_like(1.0, args.seed)
    log(f'[hetero] hetero_bench graph (scale 1.0, seed {args.seed}: '
        f'{sum(mag[0].values())} nodes in {len(mag[0])} types, '
        f'{sum(c.shape[1] for c in mag[1].values())} edges in '
        f'{len(mag[1])} edge types) built on the host in '
        f'{time.perf_counter() - t0:.1f} s')
    path_n, n_flash_rows, worst_n, n_dot_row, n_dot_err = phase_path_n(
        torch, args.seed, mag, args.iters)
    path_o, o_mix_row, o_mix_err = phase_path_o(torch, args.seed, args.iters)
    path_p = phase_path_p(torch, args.seed, mag)
    path_q, q_rows, q_err = phase_path_q(torch, args.seed, mag)
    del mag
    lap('paths N-Q')
    # the sampled subgraph loaders: Cluster-GCN at Reddit's shape (T) and
    # GraphSAINT at Flickr's (U)
    path_t, t_rows, t_err = phase_path_t(torch, args.seed)
    lap('path T')
    path_u, u_rows, u_err = phase_path_u(torch, args.seed)
    lap('path U')
    # the graph-level models: PNA at ZINC's shape (V), GIN at COLLAB's (W),
    # and every module of their slice once on the card
    t0 = time.perf_counter()
    path_v = phase_path_v(torch, args.seed)
    path_w, w_rows, w_err = phase_path_w(torch, args.seed)
    log(f'[time] paths V and W took {time.perf_counter() - t0:.1f} s')
    lap('paths V and W')
    # the graph transformers: GraphGPS at ZINC's shape (X), SGFormer at
    # ogbn-arxiv's (Y), and every module of both slices once on the card
    t0 = time.perf_counter()
    path_x = phase_path_x(torch, args.seed)
    path_y, y_rows, y_err = phase_path_y(torch, args.seed, args.iters)
    modules = phase_graph_modules(torch, args.seed)
    log(f'[time] paths X, Y and the module phase took '
        f'{time.perf_counter() - t0:.1f} s')
    lap('paths X, Y and the module phase')
    # the point family and the kernel convolutions: DGCNN at ModelNet10's
    # shape (AA) and SplineCNN at FAUST's (AB)
    t0 = time.perf_counter()
    path_aa = phase_path_aa(torch, args.seed)
    path_ab = phase_path_ab(torch, args.seed, args.iters)
    log(f'[time] paths AA and AB took {time.perf_counter() - t0:.1f} s')
    lap('paths AA and AB')
    # the cluster pools: MemPooling at PROTEINS_full's shape (AC)
    t0 = time.perf_counter()
    path_ac, ac_rows, ac_err = phase_path_ac(torch, args.seed)
    log(f'[time] path AC took {time.perf_counter() - t0:.1f} s')
    lap('path AC')
    # the datasets slice: the Kipf & Welling GCN on Planetoid's shapes (AD)
    t0 = time.perf_counter()
    path_ad, ad_rows, ad_err = phase_path_ad(torch, args.seed)
    log(f'[time] path AD took {time.perf_counter() - t0:.1f} s')
    lap('path AD')
    # the molecules slice: DimeNet++ and SchNet on QM9's shape (AE)
    t0 = time.perf_counter()
    path_ae = phase_path_ae(torch, args.seed)
    log(f'[time] path AE took {time.perf_counter() - t0:.1f} s')
    lap('path AE')
    worst_flash = (max(worst_flash[0], worst_flash_t[0], worst_n[0]),
                   max(worst_flash[1], worst_flash_t[1], worst_n[1]))
    flash_paths = {'path_k': path_k, 'path_l': paths_lm['path L'],
                   'path_m': paths_lm['path M'], 'path_n': path_n,
                   'path_s': path_s}

    # the GCN forward runs the kernel twice at F=128 and once at F=16
    per_fwd = {'F': [WIDTH, WIDTH, N_OUT]}
    by_f = {s['F']: s for s in shapes}
    for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms'):
        vals = [by_f[f][key] for f in per_fwd['F']]
        per_fwd[key] = None if None in vals else sum(vals)
    bound_by = ('bytes' if all(s['bound_by'] == 'bytes' for s in shapes)
                else 'operations')
    # every path's measured counts, all arms, keyed by path
    path_counts = {f'serving_{k.lower()}': v['launch_counts']
                   for k, v in serving.items()}
    path_counts.update(path_a=path_a['launch_counts'],
                       path_c=path_c['launch_counts'],
                       path_d=path_d['launch_counts'],
                       path_e=path_e['launch_counts'],
                       path_i=path_i['launch_counts'],
                       path_j=path_j['launch_counts'])
    for tag, res in (('b', path_b), ('f', path_f), ('g', path_g),
                     ('h', path_h)):
        path_counts.update({f'path_{tag}_{k.lower()}': v.get(
            'launch_counts', v['launches']) for k, v in res.items()})

    # the captured twins: eager warm-ups plus the graphs' replays
    twins = {'serving_gcn': serving['GCN'], 'path_a': path_a,
             'path_c': path_c, 'path_d': path_d, 'path_e': path_e,
             'path_i': path_i, 'path_j': path_j}
    for tag, res in (('b', path_b), ('f', path_f), ('g', path_g),
                     ('h', path_h)):
        twins.update({f'path_{tag}_{k.lower()}': v for k, v in res.items()})
    path_counts.update({f'{name}_captured': v['captured']['launch_counts']
                        for name, v in twins.items()})
    path_counts['scan_train'] = scan['launch_counts']
    path_counts['layerwise'] = layerwise['launch_counts']
    for name, res in dict(flash_paths, path_o=path_o).items():
        path_counts.update({
            name: res['launch_counts'],
            f'{name}_captured': res['captured']['launch_counts'],
            f'{name}_training': res['training']['launch_counts'],
            f'{name}_training_captured': res['training']['captured'][
                'launch_counts']})
    arms = path_n['layouts_arm']
    path_counts.update(
        path_n_raw_coo_steps=arms['raw COO']['launch_counts'],
        path_n_layouts_steps=arms['layouts']['launch_counts'],
        path_n_layouts_captured=arms['layouts']['captured']['launch_counts'],
        path_p=path_p['launch_counts'], path_q=path_q['launch_counts'],
        path_q_hgt_loader=path_q['hgt_loader']['launch_counts'],
        path_t=path_t['launch_counts'], path_u=path_u['launch_counts'],
        path_v=path_v['launch_counts'], path_w=path_w['launch_counts'],
        path_x_multihead=path_x['multihead']['launch_counts'],
        path_x_performer=path_x['performer']['launch_counts'],
        path_y=path_y['launch_counts'],
        path_y_captured=path_y['captured']['launch_counts'],
        path_y_training=path_y['training']['launch_counts'],
        path_y_training_captured=path_y['training']['captured'][
            'launch_counts'],
        path_z=path_z['launch_counts'],
        path_aa=path_aa['launch_counts'], path_ab=path_ab['launch_counts'],
        path_ac=path_ac['launch_counts'],
        path_ad=path_ad['launch_counts'],
        path_ae=path_ae['launch_counts'],
        graph_modules=modules['launch_counts'])

    for dt, key in (('float32', 'f32'), ('bf16 x', 'bf16')):
        path_counts[f'path_r_{key}'] = path_r[dt]['launch_counts']
        path_counts[f'path_r_{key}_captured'] = path_r[dt]['captured'][
            'launch_counts']

    def by_path(name):
        return {p: c[name] for p, c in path_counts.items()}

    seg_bf16 = bf16_rows['segment_spmm_bf16'][0]
    mix_bf16 = bf16_rows['gat_mix_bf16'][0]
    # a path A step: forward layout at F = 64 (layers 1, 2) and 10 (layer
    # 3), transposed layout at 10 (layer 3) and 64 (layer 2)
    step_picks = [
        {'layout': 'forward', 'F': TR_F}, {'layout': 'forward', 'F': TR_F},
        {'layout': 'forward', 'F': TR_CLASSES},
        {'layout': 'transposed', 'F': TR_CLASSES},
        {'layout': 'transposed', 'F': TR_F}]
    bsr_step = per_step(bsr_rows, step_picks)
    # path A's residual in a step: the forward at F = 64 twice and 10, the
    # backward (grad_x) at 10 and 64
    residual_step = per_step(seg_rows['residual'], [
        {'pass': 'forward', 'F': TR_F}, {'pass': 'forward', 'F': TR_F},
        {'pass': 'forward', 'F': TR_CLASSES},
        {'pass': 'backward', 'F': TR_CLASSES},
        {'pass': 'backward', 'F': TR_F}])
    bsr_bf16_step = per_step(bf16_rows['bsr_spmm_bf16'], step_picks)
    # a path C forward: per layer the stabiliser pass and the mix, at
    # H*F = 256 in layers 1-2 and 40 in layer 3
    by_pass = {(r['pass'].split()[0], r['HF']): r for r in mix_rows}
    mix_fwd = [by_pass[('mix', PC_HIDDEN)], by_pass[('mix', PC_HIDDEN)],
               by_pass[('mix', PC_HEADS * PC_CLASSES)]] + \
        [by_pass[('stabiliser', 0)]] * PC_LAYERS
    mix_sum = {k: sum(r[k] for r in mix_fwd)
               for k in ('ms', 'plain_ms', 'bound_ms', 'library_ms')}
    # a path I forward: the scores at H*F = 256 in layers 1-2 and 40 in
    # layer 3, float32, edge order
    by_dot = {(r['path'], r['dtype'], r['HF']): r for r in dot_rows}
    dot_fwd = [by_dot[('I', 'float32', PC_HIDDEN)]] * 2 + [
        by_dot[('I', 'float32', PC_HEADS * PC_CLASSES)]]
    dot_sum = {k: sum(r[k] for r in dot_fwd)
               for k in ('ms', 'plain_ms', 'bound_ms', 'library_ms')}
    dot_bf16 = by_dot[('I', 'bfloat16', PC_HIDDEN)]
    log(json.dumps({'paths': {'serving': serving, 'path_a': path_a,
                              'path_b': path_b, 'path_c': path_c,
                              'path_d': path_d, 'path_e': path_e,
                              'path_f': path_f, 'path_g': path_g,
                              'path_h': path_h, 'path_i': path_i,
                              'path_j': path_j, 'scan_train': scan,
                              'layerwise': layerwise, **flash_paths,
                              'path_o': path_o, 'path_p': path_p,
                              'path_q': path_q, 'path_r': path_r,
                              'path_t': path_t, 'path_u': path_u,
                              'path_v': path_v, 'path_w': path_w,
                              'path_x': path_x, 'path_y': path_y,
                              'path_z': path_z, 'path_aa': path_aa,
                              'path_ab': path_ab, 'path_ac': path_ac,
                              'path_ad': path_ad, 'path_ae': path_ae,
                              'graph_modules': modules,
                              'regime_arms': regime_arms}}))
    # a path K training step launches each flash kernel once per layer: the
    # rows of layer 1 (H=4, C=16) and layer 2 (H=1, C=47)
    flash_step = {}
    for k in FLASH_KERNELS:
        picks = [r for r in flash_rows if r['kernel'] == k
                 and r['shape'].startswith('K ')]
        flash_step[k] = {key: sum(r[key] for r in picks)
                         for key in ('ms', 'event_ms', 'plain_ms',
                                     'bound_ms')}
    flash_replaces = {
        'flash_fwd': ('pytorch_geometric_tpu/ops/edge_attention.py:821',
                      'no Pallas body: the forward lax.scans _gat_flash_fwd '
                      ':821, _gatv2_flash_fwd :1091, _attention_flash_fwd '
                      ':343'),
        'flash_bwd_dst': ('pytorch_geometric_tpu/ops/edge_attention.py:871',
                          'no Pallas body: the backward lax.scans '
                          '_gat_flash_bwd :871, _gatv2_flash_bwd :1141, '
                          '_attention_flash_bwd :398 (their destination '
                          'sides)'),
        'flash_bwd_src': ('pytorch_geometric_tpu/ops/edge_attention.py:871',
                          'no Pallas body: the same backward scans\' source '
                          'sides, over the source-sorted edges of '
                          '_attention_flash_dual_bwd :498')}
    flash_entries = [{
        'name': k, 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/flash_softmax.cu',
        'replaces': flash_replaces[k][0],
        'replaces_note': flash_replaces[k][1],
        'launches': sum(by_path(k).values()),
        'launches_by_path': by_path(k),
        'launches_per_step': {name: res['training']['launches_per_step']
                              .get(k, 0) for name, res in
                              flash_paths.items()},
        'max_abs_err': worst_flash[0],
        'max_err_over_limit': worst_flash[1],
        'ms': flash_step[k]['ms'], 'event_ms': flash_step[k]['event_ms'],
        'plain_ms': flash_step[k]['plain_ms'],
        'bound_ms': flash_step[k]['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None,
        'library_note': 'no one PyTorch call computes a segment '
                        'softmax-aggregation',
        'times_are': 'per path K training step: one launch at layer 1 '
                     '(GAT H=4, C=16) and one at layer 2 (H=1, C=47, padded '
                     'to 48 by the flash route); the plain backward covers '
                     'both passes; paths L and M layer 1 in per_shape',
        'per_shape': [r for r in flash_rows if r['kernel'] == k],
        'path_n_per_shape': [r for r in n_flash_rows if r['kernel'] == k]}
        for k in FLASH_KERNELS]
    log(json.dumps({'kernels': [{
        'name': 'segment_spmm', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/segment_spmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/pallas_spmm.py:74',
        'launches': sum(by_path('segment_spmm').values()),
        'launches_by_path': by_path('segment_spmm'),
        'launches_per_forward': serving['GCN']['launches']
        // serving['GCN']['forwards'],
        'launches_per_step': {'path_a': path_a['launches_per_step'][
            'segment_spmm'], **{f'path_b_{k.lower()}': v['launches_per_step']
                                for k, v in path_b.items()},
            'scan_train': scan['launches_per_step']['segment_spmm'],
            'path_q': path_q['launches_per_step']['segment_spmm'],
            'path_s': path_s['training']['launches_per_step'][
                'segment_spmm'],
            'path_t': path_t['launches_per_step']['segment_spmm'],
            'path_u': path_u['launches_per_step']['segment_spmm'],
            'path_w': path_w['launches_per_step']['segment_spmm'],
            'path_y': path_y['training']['launches_per_step'][
                'segment_spmm'],
            'path_ac': path_ac['launches_per_step']['segment_spmm'],
            'path_ad': path_ad['launches_per_step']['segment_spmm']},
        'launches_per_layerwise_batch': 2,
        'launches_per_path_r_forward': path_r['float32'][
            'launches_per_forward'],
        'launches_per_path_y_forward': path_y['launches_per_forward'][
            'segment_spmm'],
        'max_abs_err': max(worst, worst_bwd, worst_sampled, q_err,
                           *(r['max_abs_err'] for r in r_rows[:2]),
                           s_row['max_abs_err'], t_err, u_err, w_err,
                           y_err, ac_err, ad_err),
        'ms': per_fwd['ms'], 'kernel_ms': per_fwd['ms'],
        'plain_ms': per_fwd['plain_ms'],
        'bound_ms': per_fwd['bound_ms'], 'bound_by': bound_by,
        'library_ms': per_fwd['library_ms'],
        'times_are': 'per GCN serving forward: 2 launches at F=128, 1 at '
                     'F=16; path B\'s forward and backward passes per call '
                     'in path_b_per_shape, path A\'s residual (with the '
                     'block product as base) per call in residual_per_shape '
                     'and per step in residual_per_step, the sampled '
                     'training and layer-wise serving shapes per call in '
                     'sampled_per_shape',
        'per_shape': shapes,
        'backward_per_shape': [r for r in seg_rows['path_b']
                               if r['pass'] != 'forward'],
        'path_b_per_shape': seg_rows['path_b'],
        'residual_per_shape': seg_rows['residual'],
        'residual_per_step': residual_step,
        'sampled_per_shape': sampled_rows,
        'path_q_per_shape': q_rows,
        'path_r_per_shape': r_rows[:2], 'path_s_per_shape': [s_row],
        'path_t_per_shape': t_rows, 'path_u_per_shape': u_rows,
        'path_w_per_shape': w_rows, 'path_y_per_shape': y_rows,
        'path_ac_per_shape': ac_rows, 'path_ad_per_shape': ad_rows,
        'regime_arms_rel_err': regime_arms['worst'],
        'plan_sweep': serving_sweep + seg_rows['sweep']}, {
        'name': 'bsr_spmm', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/bsr_spmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/bsr_spmm.py:114',
        'launches': sum(by_path('bsr_spmm').values()),
        'launches_by_path': by_path('bsr_spmm'),
        'launches_per_step': {'path_a': path_a['launches_per_step'][
            'bsr_spmm']},
        'max_abs_err': worst_bsr,
        'ms': bsr_step['ms'], 'prep_ms': bsr_step['prep_ms'],
        'plain_ms': bsr_step['plain_ms'],
        'bound_ms': bsr_step['bound_ms'],
        'bound_by': max(('bytes', 'operations'), key=lambda b: sum(
            r['bound_ms'] for r in bsr_rows if r['bound_by'] == b)),
        'library_ms': bsr_step['library_ms'],
        'times_are': 'per path A training step: the forward layout at F=64 '
                     'twice and F=10, the transposed layout at F=10 and F=64',
        'hgmma_in_sass': HGMMA.get('bsr_spmm', 'not available'),
        'per_shape': bsr_rows}, {
        'name': 'gat_mix', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/gat_mix.cu',
        'replaces': 'pytorch_geometric_tpu/ops/pallas_spmm.py:74',
        'replaces_site': 'pytorch_geometric_tpu/ops/pallas_spmm.py:212 '
                         '(segment_sum_blocked, from ops/gat_fused.py:80, '
                         ':111, :161)',
        'launches': sum(by_path('gat_mix').values()),
        'launches_by_path': by_path('gat_mix'),
        'launches_per_forward': path_c['launches_per_forward'],
        'launches_per_step': path_d['launches_per_step'],
        'path_o_launches_per_step': path_o['training']['launches_per_step'][
            'gat_mix'],
        'max_abs_err': max(worst_mix, o_mix_err),
        'ms': mix_sum['ms'], 'plain_ms': mix_sum['plain_ms'],
        'bound_ms': mix_sum['bound_ms'],
        'bound_by': ('bytes' if all(r['bound_by'] == 'bytes'
                                    for r in mix_fwd) else 'operations'),
        'library_ms': mix_sum['library_ms'],
        'slice_cols': by_pass[('mix', PC_HIDDEN)]['slice_cols'],
        'times_are': 'per path C forward: the mix at H*F=256 twice and 40 '
                     'once, the stabiliser pass three times; the backward '
                     'pass per call in per_shape',
        'per_shape': mix_rows, 'path_o_per_shape': [o_mix_row],
        'slice_sweep': sweep}, {
        'name': 'segment_max', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/segment_max.cu',
        'replaces': 'pytorch_geometric_tpu/ops/pallas_spmm.py:327',
        'launches': sum(by_path('segment_max').values()),
        'launches_by_path': by_path('segment_max'),
        'launches_note': 'no path of the JAX package or of the port calls '
                         'segment_max_blocked (ops/gat_fused.py:29 only '
                         'imports it); its launches are the comparison and '
                         'timing phases, which do not count',
        'max_abs_err': worst_max,
        'ms': max_row['ms'], 'plain_ms': max_row['plain_ms'],
        'bound_ms': max_row['bound_ms'], 'bound_by': max_row['bound_by'],
        'library_ms': max_row['library_ms'],
        'lanes_per_row': max_row['lanes_per_row'],
        'times_are': f'one call at [{max_row["slots"]}, {PC_HEADS}]',
        'per_shape': [max_row]}, {
        'name': 'segment_spmm_bf16', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/segment_spmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/pallas_spmm.py:74',
        'replaces_site': 'pytorch_geometric_tpu/ops/pallas_spmm.py:212 '
                         '(segment_sum_blocked with bf16 messages, '
                         ':199-229)',
        'launches': sum(by_path('segment_spmm_bf16').values()),
        'launches_by_path': by_path('segment_spmm_bf16'),
        'launches_per_forward': dict(
            {k: v['launches']['segment_spmm_bf16'] / v['forwards']
             for k, v in path_h.items()},
            path_r_bf16_x=path_r['bf16 x']['launches_per_forward'][
                'segment_spmm_bf16']),
        'max_abs_err': max(worst_seg_bf16, r_rows[2]['max_abs_err']),
        'ms': seg_bf16['ms'], 'plain_ms': seg_bf16['plain_ms'],
        'bound_ms': seg_bf16['bound_ms'], 'bound_by': seg_bf16['bound_by'],
        'library_ms': seg_bf16['library_ms'],
        'times_are': f'one call at path H layer 1 (F={WIDTH}, unweighted), '
                     'one per forward',
        'per_shape': [seg_bf16], 'path_r_per_shape': [r_rows[2]],
        'plan_sweep': bf16_rows['segment_spmm_bf16_sweep']}, {
        'name': 'bsr_spmm_bf16', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/bsr_spmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/bsr_spmm.py:114',
        'replaces_arm': 'bf16 blocks, pytorch_geometric_tpu/ops/bsr_spmm.py:'
                        '129-140',
        'launches': sum(by_path('bsr_spmm_bf16').values()),
        'launches_by_path': by_path('bsr_spmm_bf16'),
        'launches_per_step': {'path_e': path_e['launches_per_step'][
            'bsr_spmm_bf16']},
        'max_abs_err': worst_bsr_bf16,
        'ms': bsr_bf16_step['ms'], 'prep_ms': bsr_bf16_step['prep_ms'],
        'plain_ms': bsr_bf16_step['plain_ms'],
        'bound_ms': bsr_bf16_step['bound_ms'],
        'bound_by': max(('bytes', 'operations'), key=lambda b: sum(
            r['bound_ms'] for r in bf16_rows['bsr_spmm_bf16']
            if r['bound_by'] == b)),
        'library_ms': bsr_bf16_step['library_ms'],
        'times_are': 'per path E training step: the forward layout at F=64 '
                     'twice and F=10, the transposed layout at F=10 and F=64',
        'hgmma_in_sass': HGMMA.get('bsr_spmm', 'not available'),
        'per_shape': bf16_rows['bsr_spmm_bf16']}, {
        'name': 'gat_mix_bf16', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/gat_mix.cu',
        'replaces': 'pytorch_geometric_tpu/ops/pallas_spmm.py:74',
        'replaces_site': 'pytorch_geometric_tpu/ops/pallas_spmm.py:212 '
                         '(segment_sum_blocked from ops/gat_fused.py:76-81 '
                         'with p_s, p_u and v all bf16)',
        'launches': sum(by_path('gat_mix_bf16').values()),
        'launches_by_path': by_path('gat_mix_bf16'),
        'launches_note': 'no model path feeds the mix bf16 (GATConv\'s float32 '
                         'parameters promote v and the logits); its launches '
                         'are the comparison and timing phases, which do not '
                         'count',
        'max_abs_err': worst_mix_bf16,
        'ms': mix_bf16['ms'], 'plain_ms': mix_bf16['plain_ms'],
        'bound_ms': mix_bf16['bound_ms'], 'bound_by': mix_bf16['bound_by'],
        'library_ms': mix_bf16['library_ms'],
        'slice_cols': mix_bf16['slice_cols'],
        'times_are': f'one mix call at path C H*F={PC_HIDDEN}',
        'per_shape': [mix_bf16], 'slice_sweep': sweep_bf16}, {
        'name': 'edge_dot', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/sddmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/sddmm.py:38',
        'replaces_note': 'no Pallas body: XLA (a[src] * b[dst]).sum(-1) in '
                         'ops/sddmm.py:38, ops/edge_attention.py:110, :139, '
                         ':145, nn/conv/transformer_conv.py:65, '
                         'nn/conv/gps_conv.py:230-233 and grad_p_u of '
                         'ops/gat_fused.py:103-105',
        'launches': sum(by_path('edge_dot').values()),
        'launches_by_path': by_path('edge_dot'),
        'combine_launches_by_path': by_path('edge_dot_combine'),
        'launches_per_forward': {'path_i': path_i['launches_per_forward'][
            'edge_dot']},
        'combine_launches_per_forward': {
            'path_i': path_i['launches_per_forward']['edge_dot_combine']},
        'launches_per_step': {
            'path_j': path_j['launches_per_step']['edge_dot'],
            'path_d': path_d['launch_counts']['edge_dot']
            / path_d['steps'],
            'path_n': path_n['training']['launches_per_step']['edge_dot']},
        'max_abs_err': max(worst_dot['f32'], n_dot_err),
        'ms': dot_sum['ms'], 'plain_ms': dot_sum['plain_ms'],
        'bound_ms': dot_sum['bound_ms'],
        'bound_by': ('bytes' if all(r['bound_by'] == 'bytes'
                                    for r in dot_fwd) else 'operations'),
        'library_ms': dot_sum['library_ms'],
        'times_are': 'per path I forward: the scores at H*F=256 twice and 40 '
                     'once (edge order); path D\'s grad_p_u (slot order) per '
                     'call in per_shape',
        'slices': {k: by_dot[('I', 'float32', PC_HIDDEN)][k]
                   for k in ('slice_heads', 'col_slices')},
        'per_shape': dot_rows, 'path_n_per_shape': [n_dot_row],
        'grad_w_per_shape': gradw_rows,
        'grad_w_note': 'grad_w of the kernel (and so windowed), chunked and '
                       'uncached dense regimes, launched in the regime arm '
                       'checks; no main path trains edge weights (path S\'s '
                       'SAGE layer is unweighted)',
        'slice_sweep': dot_sweep}, {
        'name': 'edge_dot_bf16', 'route': 'cuda',
        'source': 'pytorch_geometric_tpu_torch/csrc/sddmm.cu',
        'replaces': 'pytorch_geometric_tpu/ops/sddmm.py:38',
        'replaces_note': 'no Pallas body: the same XLA dot on bf16 inputs',
        'launches': sum(by_path('edge_dot_bf16').values()),
        'launches_by_path': by_path('edge_dot_bf16'),
        'launches_note': 'no model path feeds the dot bf16 (the convs\' '
                         'float32 parameters promote their inputs); its '
                         'launches are the comparison and timing phases, '
                         'which do not count',
        'max_abs_err': worst_dot['bf16'],
        'ms': dot_bf16['ms'], 'plain_ms': dot_bf16['plain_ms'],
        'bound_ms': dot_bf16['bound_ms'], 'bound_by': dot_bf16['bound_by'],
        'library_ms': None,
        'library_note': 'torch.sparse.sampled_addmm takes no bf16',
        'times_are': f'one call at path I H*F={PC_HIDDEN} (edge order)',
        'per_shape': [dot_bf16]}] + flash_entries}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
