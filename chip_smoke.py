#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--n 4000000] [--workers 32] [--seed 0]

Phases; any failure exits non-zero and prints no result:

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and builds the four kernel sources from ``src/``
   (segment_combine, flash_attention, ssd_scan, worker_count: one nvcc
   each, started together), printing each ``-Xptxas -v`` report.
2. kernels vs plain: random cases (sum/min/max x int32/float32/float16/
   bfloat16 x several (eb, nb), eb=0 and eb=2048 with nb=1024 among them,
   for the vector kernel x F in {1, 3, 32, 64, 130}, and 256 for the half
   types (8 values a load); -1 padding, indices nb and beyond, a row with
   every lane on one slot and an all-padding row, values at the int32
   bounds and +-inf, and 30% +-0.0 and +-inf (+-1.5 in sums) in the half
   types, float16 also at its +-65504 sentinels) against the plain
   PyTorch version on the same inputs.  Integers and min/max must be
   equal value for value (the sign of a zero aside); a float32 sum may
   differ by the summation order, at most 2*eb*2^-24 times the slot's sum
   of |values| (twice the textbook bound on a recursive sum of eb terms),
   a half sum by that plus one ulp of the half type (both sum in float32
   and round once).  F=1 through the vector kernel must equal the scalar
   kernel bit for bit.  Then ``plan._combine_rows`` on a float16 payload:
   the kernel's +-65504 sentinels come back as +-inf, bitwise; and both
   kernels timed on float32, float16 and bfloat16 values at the Ch_msg
   plan's shape (``half_timing``; the entries' ``payload_types``).  Then
   the worker_count kernel (``plan.per_worker``'s tally) against its
   plain version on CPU copies at phase 3's per_worker shapes (int64
   sorted edge owners and int32 sorted segment owners with bool flags, a
   few ids at -1 and M; random owners with int64 and int32 counts; two
   unaligned views), every total equal, and timed at the
   ``per_worker_basic`` shape beside its plain version and
   ``torch.bincount``.
3. the algorithms at full size: a weighted, symmetrized
   ``powerlaw(n, avg_deg=8)`` graph (n=4M: 62.5M directed edges, the scale
   of LiveJournal) with the GCN's normalized weights (``normalize_adjacency``,
   so one partition serves both paths) is partitioned once (csr layout,
   hash balance, tau from the cost model, M workers) onto the card, and
   ``Engine(backend="pallas")`` runs Hash-Min, PageRank (30 iterations),
   SSSP (from original vertex 0), and the request-respond algorithms:
   S-V, MSF and attribute broadcast (attr = 3 * arange(n_pad)).  Each
   result is held against an oracle independent of the port (scipy's
   connected_components, dijkstra and minimum_spanning_tree on the same
   weights, a float64 power iteration, the attributes read on the host)
   and against the port's own dense backend on the card; the scalar
   kernel's launch counter must show 3 launches per Hash-Min superstep
   (Ch_msg values, Ch_msg hit counts, Ch_mir fan-out), 2 per S-V superstep
   (the ``all`` plan's values and hit counts) and none in MSF and
   attribute broadcast, whose combines have runtime targets; the
   worker_count kernel's (the tracing counter, read before and after each
   run) ``WC_PER_SS`` a superstep, 3/3/3/13/26/4, and MSF 2 more a
   pointer jump.  ``[reqresp]``
   lines give the paper's Fig. 13 comparison: msgs_rr against msgs_basic
   and the busiest worker's load with and without Ch_req (Theorem 3).
   Then S-V on ids that straddle 2^24 (n = 2^24 + 4, M = 2): the labels
   2^24 and 2^24 + 1 must stay apart.
3b. the sharded executor on that partition: an in-process NCCL group of
   world size 1 (a ``HashStore``), the tables built once (host seconds
   and device bytes printed), then ``Engine(devices=1)`` runs the six
   algorithms with the parameters above, cold and warm.  Gates against the
   phase's own single-device runs: states bitwise (PageRank rtol 1e-5,
   MSF's weight 1e-6), every ``msgs_*``/``per_worker_*`` equal, the same
   supersteps, and the scalar kernel's launches a superstep of
   ``SHARDED_PER_SS``, 3/3/3/2/0/0 (the counts are zeroed before each run
   and read after it).
   ``[sharded] D=1`` lines give the device ms a superstep beside the
   single-device one and the host reads a superstep; ``[profile] sharded``
   lines the device time of Hash-Min, S-V, MSF and attr_bcast by op.  One
   superstep's plan launches of Hash-Min and S-V are then replayed through
   the kernel and its plain version (exact).  Then three more modes over
   a new group of world size 1, each algorithm once under the same gates:
   ``devices=(1, 1)`` (the hierarchical exchanges through subgroups of
   one rank), ``devices=1, pipeline=True`` with two chunks a join (forced:
   the default on one rank is one; the exchanged plans must hold two
   chunks, and the kernel runs once a chunk, ``PIPELINED_PER_SS``
   4/4/4/3/0/0), and a ``balance="split"`` partition of the same graph at
   ``SPLIT_FACTOR`` 1.0, which must cut workers (M_phys > M; host seconds
   of the partition and its shard build printed), held to its own
   one-device run; one superstep of Hash-Min and S-V under split and
   under the pipeline replayed through the kernel and its plain version
   (exact).  ``[balance]`` lines: each device's edge load (max/mean)
   under the hash and split partitions at D = 2, 4, 8, and the
   cross-worker/device/host fractions and exchange volume of the (2, 4)
   mesh beside the flat D=8 mesh's lanes across the same host boundary
   (host tables of the hash partition, not host-affine: the paper's load
   balance and per-level combining).  After phase 4, the sharded GCN over
   a new NCCL group of world size 1: ``Engine(devices=1).run("gcn")``
   for 4 epochs on the 1-D mesh and 2 epochs each on the (1, 1) mesh,
   under the pipeline (two chunks, forced and checked) and on the split
   partition, each from phase 4's params (the split partition's in its
   vertex layout) after one warm-up epoch.  Gates against the one-device
   run of the same partition and epochs: the loss history within rtol
   2e-4 and atol 2e-5 (the reference's sharded contract; at n=4M the
   loss moves about 1e-4 in 4 epochs, so this gate cannot fail there and
   the params gate carries the check), every trained leaf finite and its
   change within PARAM_RTOL of the one-device change, the vector kernel's
   launches (counted from 0 before each run, read after it)
   ``SHARDED_VEC_PER_EPOCH`` = 222 an epoch on the hash partition and
   ``SPLIT_VEC_PER_EPOCH`` = 310 on the split one (a D=1 rank's plans are
   the one-device plans and nothing leaves the rank), and no scalar
   launch.  The params gate's control: the 1-D run again with its first
   vector combine dropped, which that gate must reject.  ``[sharded] ...
   gcn`` lines give ms an epoch beside the one-device epoch, the peak
   device memory beside phase 4's, and ``[profile] sharded D=1 gcn`` the
   busy share of one epoch; then one ``gspmm_sharded("u_mul_e_sum")``
   call at F=64 whose stats must equal ``gspmm_stats`` on one device,
   integer for integer.
3c. ranks (spawned, a file store) on the n=200k graph of phase 5
   with M=8, each building it from ``--seed``: on one card, gloo with
   every rank on cuda:0 (gloo stages every collective through the host;
   those host-clock times are labelled so): 2 ranks on the 1-D mesh
   (csr/pallas and padded/dense), under split (``SPLIT_FACTOR``, which
   must cut workers; the cut workers whose shards lie on two ranks are
   counted) and under the pipeline (two chunks a join, checked), and 4
   ranks on the (2, 2) mesh of a host-affine partition; with two or
   more cards NCCL, a card a rank: the 1-D mesh on D the largest of 2, 4,
   8, the (1, 2) and (2, 1) meshes, split and the pipeline on 2, and the
   (2, 2) mesh where there are four.  The six algorithms in each; rank 0
   holds each to the one-device run on its card under the gates of 3b and
   prints the exchange rounds of each routed join and inter-host leg.  In
   each csr/pallas mode also the GCN for 2 epochs, held to the one-device
   run under the GCN gates of 3b, with at least one vector launch a join
   on rank 0.
4. GCN training at full width on that graph: ``Engine.run("gcn")`` with
   F=32, hidden=64, 8 classes, lr=1e-2, 4 epochs.  The vector kernel's
   launch count must equal what the plan chunks predict (2 joins at F=32
   and 2 at F=64 an epoch) and the loss must fall; the first layer's join
   and its gradient are held against scipy's float64 ``A_hat^T X`` and
   ``A_hat G`` within (deg+3)*2^-24 of ``|A_hat|^T |X|`` (the
   summation-order bound of deg products); the assembled step (every
   leaf's gradient, and its change after one epoch of clip + AdamW) is
   held against a float64 scipy/numpy step that takes the card's relu
   (every flip must lie within round-off of 0): gradients within 1e-4 of
   their norm, the change within 1e-3.  Those float64 oracles run on the
   card's results, saved to a temporary directory, in a spawned process of
   their own beside phases 12 to 15, and are waited for after phase 15.  A
   replay of the run records every join's input for phase 6; one join with
   and without the message accounting is timed; device ms an epoch, a
   profile of one epoch and the peak device memory are printed.
5. pallas == dense at n=200k on the card: the three gSpMM kinds (max
   bitwise, sums within 1e-5 of ``|A_hat|^T |X|``, every ``msgs_*`` and
   ``per_worker_*`` equal) and a 3-epoch GCN loss history (within 1e-6;
   it must fall by more than 1e-4).
6. the kernels at the main paths' shapes: their time, the plain version's,
   one PyTorch call computing the same function (``library_ms``, never
   called by the port: ``scatter_reduce`` for the scalar kernel,
   ``torch.zeros`` + ``index_add_`` for the vector kernel) and the bound
   (bytes over 3.35 TB/s), each timed on every launch of its counted run
   (the scalar kernel in a replay of the algorithm runs, the vector kernel
   on the recorded join inputs), so that its times and launches cover the
   same runs; each line and entry adds kernel/library and bound/kernel.
7. serve Hymba-1.5B at full width (32 layers, d_model 1600, 25/5 heads,
   window 1024 with layers 16 and 32 global, a Mamba-2 mixer beside the
   attention in every layer; 1.64B parameters in float32 from
   ``torch.Generator(seed)`` on the card; TF32 off).  First the two new
   kernels against their plain versions in float64 on random cases (flash:
   causal on/off x window 0/16/100/1024 x n_rep 1/5 x d 16/64/128/256 x S
   64/100/129/2048/2112, and unmasked with (Sq, Sk) in (1, 1500), (384,
   1500), (1600, 1500), (37, 100) x the same d and n_rep, within 1e-5 of
   max|v| (Sq > Sk refused under a causal mask or a window), and bfloat16
   within 2e-2, at d=256 over the same grid against the float64 plain
   version;
   SSD: S a chunk multiple and ragged, chunk 128 and 64 x (P, N) (64,
   16)/(64, 128) x groups 1/2, y and final state within 1e-4 of their
   max).  Then B=4 random
   prompts of 2048 tokens (twice the window, so the masks and ring buffers
   wrap): prefill and 63 greedy decode steps through ``model_zoo``, timed
   with CUDA events.  Checks: (a) both kernels on every launch's recorded
   inputs against the float64 plain version; (b) each layer's update with
   the kernels against the plain path ("ref") on the same input; (c) the
   prefill + decode path against the no-cache forward over the 2112 tokens
   (both kernels at that ragged length), layer by layer with teacher
   forcing at positions 2047..2110, and the logits through the last layer;
   (d) 32 flash and 32 SSD launches in the prefill, none in decode; (e)
   finite logits, the padded vocabulary at -2^30.  The whole-model logits
   (kernels vs plain, served decode vs forward) are printed but not held to
   a bound: the random-weight 32-layer model amplifies float32 rounding.
   ``[serve]`` lines give the prefill and decode device times, tokens/s
   and peak memory; ``[kernel]`` lines each kernel's time, plain time,
   library time (SDPA for flash; none for the scan) and bound over the 32
   launches of a prefill; for flash also per layer kind (window, global),
   for the scan each of its three passes' device time over the 32 calls
   of the profiled prefill (torch.profiler) and its CUDA launches a call.
8. serve Gemma-3-4B at full width (34 layers, d_model 2560, 8/4 heads of
   dim 256, window 1024 on five layers of six, vocab 262,144, tied
   embeddings; 3.88B float32 parameters from ``torch.Generator(seed)``):
   the same B=4 prompts of 2048 tokens, prefill and 63 decode steps,
   timed.  Gates: 34 flash launches (d=256) in the prefill, none in
   decode; finite logits, pad at -2^30; layers 0-5 (five window layers
   and the first global one) with the kernel against the plain path on
   the same input, and prefill + decode against the no-cache forward,
   layer by layer (the tolerances of phase 7); the kernel on the first
   window and global layer's recorded inputs against the float64 plain
   version, timed beside the plain version and SDPA (``[kernel]
   flash_attention gemma3_4b ...`` lines; the flash entry's per_launch
   rows with ``model`` gemma3_4b).  ``[serve] gemma3_4b`` lines: prefill
   and decode device times, peak memory; ``[profile] gemma3_4b``: the
   busy share of a prefill and of a decode step.
9. the resident graph service (``core/service.py``) at serve_graph's
   defaults (powerlaw n=200k, avg_deg 8, weighted; M=32, csr, edges;
   buckets 4/16/64, PPR 20 iterations) on an in-process NCCL group of
   world size 1: boot and warm, the 64-query mixed batch, a 1% churn
   fold, the batch and three probes at epoch 1.  Gates: every answer
   before and after the fold against scipy / float64 oracles (Dijkstra,
   a power iteration, connected_components), the post-fold probes
   against a fresh ``partition()``'s Engine runs, the executor counter
   flat, the tables' storage kept, epoch 1 with no answer straddling the
   fold, no kernel launched (backend "dense").  ``[service]`` lines:
   batch ms (host, and device by CUDA events) and supersteps, ms a
   query, ``fold_delta`` against ``partition(apply_delta(...))`` on the
   host, the epoch barrier's seconds, peak device memory; ``[profile]
   service``: one more batch by op.  Then two more programs, each on a
   new service (bucket 4, PPR 6 iterations): the elastic repartition
   (``rebalance_threshold`` 1.0, a batch, a 5% churn fold, a batch) and
   the profile overflow (``profile_slack`` 1.01, a fold that doubles the
   edge count, a batch); every answer against the oracles, the
   repartition on the first batch with no executor rebuilt, the overflow
   freezing a new profile and rebuilding two.  Then the same client
   program and the two programs on two spawned ranks (gloo on cuda:0 on
   a one-card machine, NCCL with a card a rank on two) must give world
   size 1's answers and statistics, repartition counts, executors and
   epochs.
15. serve Whisper-medium at full width and depth (24 encoder and 24
   decoder layers, d_model 1024, 16 heads of dim 64, d_ff 4096, 1500
   frames, vocab 51,865 padded to 51,968; 1.0B float32 parameters from
   ``torch.Generator(seed)``): B=4 requests of 1500 frame embeddings
   (numpy normals after the prompts, the reference's stub front end) and
   384 prompt tokens, prefill and 63 greedy decode steps (448 positions,
   Whisper's text context).  Gates: (a) the encoder's unmasked 1500 x
   1500, the decoder's causal 384, the prefill's cross 384 x 1500 and a
   decode step's cross 1 x 1500 launch on layer 0's recorded inputs
   against the float64 plain version (phase 7's rule), timed beside the
   plain version and SDPA; (b) encoder and decoder layers 0-3, kernels
   against the plain path on the same input; (c) prefill + decode
   against the no-cache forward on decoder layers 0-3, teacher-forced;
   (d) exactly 72 flash launches a prefill and 24 a decode step (the cross
   K/V recomputed from the encoder's output at every step, as the
   reference does); (e) finite logits, the 103 padded entries at -2^30.
   ``[serve] whisper_medium`` lines: prefill ms beside the products'
   bound, decode ms a step beside its bound, tokens/s, peak memory;
   ``[profile] whisper_medium``: the busy share of a prefill and a decode
   step; ``[kernel] flash_attention whisper_medium ...`` a line a launch
   shape.
16. train TinyLlama-1.1B at full width and depth (22 layers, d_model
   2048, 32/4 heads of dim 64, d_ff 5632, vocab 32,000, untied;
   1,100,048,384 float32 parameters from ``torch.Generator(seed)``, TF32
   off) through ``train_step.make_train_step`` under the reference's
   default ``ModelContext`` (remat "full", the ``rr`` lookup) on
   ``SyntheticLM(vocab, seq_len=2048, global_batch=4, seed)`` batches
   (8192 tokens a step): one warm-up step, then ``TRAIN_STEPS`` steps
   each between two CUDA events, one more under torch.profiler.  Step 0,
   in phase 7 (``half_type_cases``): the flash kernel on float16 at every
   head dim (causal, window 1024, unmasked, unmasked Sq > Sk) and the SSD
   kernel on float16 and bfloat16 inputs at Hymba's layer shape (and
   bfloat16 x with float32 B and C) against the float64 plain versions
   within one ulp of the half output on top of float32's tolerance, each
   timed beside its float32 time.  Gates: (a) the flash Function (the
   kernel forward, the plain chunked backward) on layer 0's recorded q,
   k, v with a seeded upstream gradient: o, dq, dk, dv against a float64
   autograd of the plain version, each within ``PLAIN_FACTOR`` times the
   float32 plain path's own error; (b) layers 0-3, on each layer's input
   (first sequence) and a seeded upstream gradient, every parameter
   gradient of the kernel path against a float64 recomputation of the
   plain path (its norms and rotary angles, as the model's, in float32),
   within the larger of ``LAYER_GRAD_RTOL`` and ``PLAIN_FACTOR`` times the
   float32 plain path's error; (c) one step at B=1 under remat "none" and
   "full" on the same batch: the loss bitwise, every leaf bitwise but the
   embedding, within the float32 bound of two summation orders of its
   rows (index_add_'s atomics); (d) 22 flash launches a step under "none"
   and 44 under "full" (the recomputed forward), the Function's backward
   none; (e) loss and grad_norm finite on every step, every parameter
   leaf moved by the first; (f) the SSD Function at Hymba-1.5B's layer
   shape (b=4, S=2048, 50 heads of dim 64, d_state 16, chunk 128): y, dx,
   ddt, dA, dB, dC against float64 autograd of ``ssd_chunked`` within
   ``PLAIN_FACTOR`` times float32's own error; (g) ``launch/train.py``'s
   ``run(..., reduced=False)`` at full width with the depth cut to
   ``TRAIN_LAUNCHER_LAYERS`` layers (to keep the checkpoint small;
   ``get_config`` is swapped in the launcher's module), the ``onehot``
   lookup (a product, where ``rr``'s index_add_ atomics would make two
   runs differ): straight, then cut after ``TRAIN_CUT`` steps and resumed
   from its checkpoint in a fresh state, the losses equal bitwise.
   ``[train] tinyllama_1_1b`` lines: ms a step (median and each),
   tokens/s, the products' bound and ``mfu_fp32`` (6NT over 67 TFLOP/s),
   peak memory under "full" and at B=1 under "none" and "full", loss and
   grad_norm per step; ``[profile] tinyllama_1_1b train step``: the busy
   share and top device ops, and the plain attention backward's share
   (its kernels' device time on layer 0's inputs under torch.profiler,
   times 22).
17. (inside phase 16, after gate (c)) the training mesh: phase 16's
   state and batches through ``make_train_step`` under
   ``ModelContext(mesh=make_mesh((1, 1), ("data", "model")))`` over an
   in-process NCCL group of world size 1 (a ``HashStore``).  Gate (h):
   the mesh step from that state against the step without a mesh (each as
   its ``grads`` then its ``update``): the loss bitwise, every gradient
   leaf bitwise but the embedding's (gate (c)'s atomics bound), grad_norm
   within ``MESH_GNORM_RTOL``, the new state bitwise where grad_norm is
   equal (else within ``MESH_STATE_RTOL``), the embedding's params and
   master within AdamW's sign-flip bound.  Then one warm-up step and
   ``MESH_STEPS`` steps between CUDA events; gate (i): 44 flash launches
   a step; gate (j): U of each worker's sharded lookup (its distinct ids)
   equals ``token_stats`` of its slice.  ``[mesh-train]`` lines: each
   worker's T, U, U/T and the response bytes (U x D x 4) beside the
   all-gathered table's (V x D x 4); ms a step beside phase 16's, flash
   launches, peak memory.  The step's placement is
   ``train_state_specs(zero1=True, fsdp=True)``'s, which at data size 1
   splits nothing over the data axis (checked).  And, in the launchers'
   thread after phase 14, the (2, 2) mesh on 4 spawned ranks (gloo on
   cuda:0 on a one-card machine, NCCL with a card a rank on four):
   TinyLlama at full width with its depth cut to 2, one step from one
   state on the global batch under the tensor-parallel placement, ZeRO-1
   (the optimizer state over the data axis) and fsdp (the parameters
   too), then OLMoE-1B-7B at full width cut to 1 layer (32 of 64 experts
   stored a rank) under fsdp with no pair dropped (``MESH_OLMOE_LAYERS``'
   comment); for each, rank 0 holds every rank's loss equal, and the
   gathered loss, grad_norm and every gathered leaf to the one-device
   step (``MESH_RANK_SHAPE``'s comment has the tolerances), each rank's
   flash launches (2 a layer) and its bytes of params and optimizer
   state, placed and after the step, to what the placed specs imply;
   ``[mesh-ranks]`` lines and ``[mesh-zero]`` lines (each rank's bytes
   beside the tensor-parallel placement's, its peak device memory and
   its step's host seconds); each rank's collectives of each step are
   recorded (``launch.comm_stats.record_collectives``) for phase 20.
19. the four examples of ``examples/torch/`` in a spawned process of its
   own, each through its ``main``: at the reference's defaults on the
   card (quickstart at 20,000 vertices, graph_analytics at 10,000,
   serve_lm's three reduced archs, train_lm's 200 steps), then the two
   graph examples again with ``--device cpu``.  Gates: every integer the
   graph examples return (``msgs_*`` and ``per_worker_*`` counts,
   supersteps, rounds, labels) equal between card and CPU; train_lm's
   losses finite and falling; serve_lm's tokens 4 x 16 (its logits
   finite).  ``[examples]`` lines: seconds, the counts, ``loss a -> b``.
20. the dry run of the production mesh (``launch/dryrun.py``: rank 0's
   program on ``meta`` tensors in a fake world of 256 or 512 ranks; no
   device) in a spawned process of its own: ``DRYRUN_ARCHS`` x the four
   shapes on the 16 x 16 and 2 x 16 x 16 meshes, one ``[dryrun]`` line a
   cell (the roofline's three terms at the H100's published rates, FLOPs
   and argument bytes a chip, the collectives); then phase 17's (2, 2)
   runs at their own dtype (float32), depth and batch in a fake world of
   4.  Gate 1: each run's params and optimizer-state bytes a rank equal,
   byte for byte, what every rank of phase 17's (2, 2) ranks held placed
   and after its step (``[mesh-zero]``); gate 2: the recorded
   collectives (kind, bytes, operand shapes and dtypes, group size, in
   order) equal rank 0's record of the same step.  And phase 16's
   TinyLlama step (the (1, 1) mesh) for its FLOPs beside
   ``train_products``, term by term.
Four threads run processes of their own beside phase 3's host set-up
(graph build and partition), started once the kernels are built and
waited for before phase 3's first timed run: phases 10 and 11; phase 14,
phase 17's (2, 2) ranks and phase 18's ranks (the "launchers' thread");
phase 19; phase 20 (whose gates run after the wait); phase 13 runs after
phase 8.  Two more spawns whose card work
is not timed run beside host-only phases of the main thread: phase 3c's
ranks and phase 9's spawned ranks (its comparison with world size 1
comes in phase 9), side by side, beside phase 3's scipy oracles (through
the dense-parity check), both waited for at the end of that window.
That
partition and its plans are made on the CPU (no card use) in a spawned
process of their own (no GIL shared with the main thread) from phase
3's oracles on, beside them, the profiles, the S-V 2^24 check and phase
3b's first runs, and moved to the card after the wait.

10. ``python -m repro_torch.launch.shard_check --suite tier1``
   on the card: 40 parity cells (n=180, M=8) over 8 ranks (gloo on cuda:0
   on a one-card machine, NCCL with a card a rank on eight) and 2 ranks,
   and the collective gates (an all-to-all over 8 ranks; no all-reduce
   or all-gather operand of n_pad elements in the four gated programs;
   groups of 4 and 2 on the (2, 4) mesh, for gSpMM at F=4 and F=1;
   masked lanes; per-level caps); each gate must reject its control, and
   rank 0 of the 8-rank world must launch both kernels.  Prints each
   program's worst operand against n_pad, its all-to-all group sizes and
   its peak device bytes.
11. ``python -m repro_torch.launch.dist_smoke --hosts 2 --per-host 2`` at
   n=PARITY_N, M=8 over the launchers' TCP store (``--port 0``): four
   ranks (gloo on cuda:0 on a one-card machine) must print parity OK
   against their one-device Hash-Min and the launcher exit 0; prints the
   ranks' rendezvous seconds and the wall seconds.
12. (after phase 4's sharded GCN) the preemption drill: phase 4's GCN
   killed after epoch ``DRILL_KILL`` of 4, saved to a fresh temporary
   directory (``train/checkpoint.py``), the state dropped, restored by
   ``restore_or_init`` and trained on.  Gates: the restored state bitwise
   equal to the saved; the loss curve within the reference drill's rtol
   2e-4, atol 1e-5 of phase 4's straight run; each trained leaf within
   PARAM_RTOL of the straight run's change; the vector launches of phase
   4's run.  Prints save and restore ms and the bytes on disk, and the
   params' element-wise distance beside phase 4's replay's.
13. serve OLMoE-1B-7B at full width (16 layers, d_model 2048, 16/16 heads
   of dim 128, 64 experts top-8 of d_ff 1024, capacity factor 1.25, vocab
   50,304; 7.0B float32 parameters from ``torch.Generator(seed)``): the
   same B=4 prompts of 2048 tokens, prefill and 63 decode steps, timed.
   Gates: 16 flash launches (d=128) in the prefill, none in decode;
   finite logits, pad at -2^30; on layers 0-3, (b) in two halves on each
   layer's input: the attention update, kernel against plain (phase 7's
   tolerance), and the MoE half against a float64 recomputation on the
   same routing (each kept pair's gated expert output, gathered by
   expert; the keep mask held to each expert's first cap pairs) within
   ``MOE_RTOL``; and (c) with teacher forcing: the K/V that prefill and
   decode write against the no-cache forward's within ``KV_RTOL``, the
   attention update at positions 2047..2110 against the forward's, each
   decode step's MoE half against float64 (a decode step's capacity, T=4,
   is not the forward's, so whole-layer updates are not compared); the
   kernel on layer 0's recorded inputs against the float64 plain version,
   timed beside the plain version and SDPA (``[kernel] flash_attention
   olmoe_1b_7b`` rows).  ``[serve] olmoe_1b_7b`` lines: prefill ms and
   prompt tokens/s beside the products' bound, decode ms a step beside
   the bytes a step must read, peak memory; ``[profile] olmoe_1b_7b``:
   the busy share of a prefill and a decode step; ``[moe]`` lines per
   layer of the prefill and summed over decode: tokens per expert (max,
   mean), the share of (token, slot) pairs dropped, the aux loss, the
   combined buffer's E*cap rows against the T*k token messages.
14. ``moe_ffn_ep`` on 2 spawned ranks (gloo on cuda:0 on a one-card
   machine, NCCL with a card a rank on two) over one full-width OLMoE MoE
   layer (E=64, D=2048, F=1024) at 8192 tokens, ``n_mirrored_experts`` 0
   and 2 (copies tied to experts 0-1).  Gates: each rank's output against
   its slice computed on one device under the rank's own cap and mirror
   mask (unmirrored: ``moe_ffn_ref`` on the slice) within ``EP_RTOL``; the
   mirrored run's occupied send-buffer rows fewer than the unmirrored
   run's by exactly the pairs that run kept for experts 0-1.  ``[moe-ep]``
   lines: occupied rows against E*cap with and without mirroring, the
   bytes an all_to_all moves (static: the same mirrored), and
   ``moe_mirror_threshold`` at these shapes with the card's float32 ratio
   beside the hottest expert's load.  Then one backward on each rank
   (``moe_rank_backward``): ``EP_GRAD_TOKENS`` tokens a rank, unmirrored,
   at the largest expert load of any rank as the capacity (no drops); x's
   gradient, each of the rank's expert rows' and the router's (summed over
   the ranks, without the aux term) against ``moe_ffn_ref``'s autograd on
   one device within ``EP_GRAD_RTOL``, the other ranks' expert rows zero.
18. serving on the (1, 2) mesh (tensor parallelism and the cache's
   sequence split), on 2 spawned ranks in the launchers' thread after
   phase 17's (gloo on cuda:0 on a one-card machine; NCCL with a card a
   rank on two): TinyLlama-1.1B at full width and depth (16 of 32 query
   heads and 2 of 4 kv heads a rank, d_ff 2816 a rank) and Hymba-1.5B at
   full width with its depth cut to a window, a global and a window
   layer (its 25 heads whole on each rank, d_ff 2752 and 25 of 50 SSM
   heads a rank), each through ``model_zoo.prefill`` / ``decode_step`` on
   the mesh: B=2 prompts of 1024 tokens, then 16 greedy decode steps at
   max_len 1040.  Each rank's flash and SSD launches are counted (one a
   prefill's attention or SSM layer, none in decode) and held against
   their float64 plain version on the rank's own inputs (phase 7's rule);
   rank 0 gathers the logits and the cache and holds them, and the first
   ``SERVE_MESH_CHECK_LAYERS`` layers one by one on the same input, to
   the same params served on one device (``SERVE_MESH_FLOOR``'s
   comment), and the greedy tokens wherever the one-device top-2 margin
   clears that bound.  ``[serve-mesh]`` lines: each rank's launches and
   their shapes, ms a prefill and a decode step (gloo staging through the
   host on one card: not a speed of the port), the gates' figures.

One JSON line ``{"kernels": [...]}`` with all five kernels (the flash
and SSD entries carry ``half_types``, phase 7's step-0 timings on
float32, bfloat16 and float16 inputs beside their bounds, and the flash
entry phase 16's summary and its timed steps' launches under
``launches_by_model["tinyllama_1_1b train"]``, phase 17's under
``"tinyllama_1_1b mesh train"``, and both phase 18's launches of each
rank under ``launches_mesh_serve``, the flash entry the (2, 2) training
ranks' of each run under ``launches_mesh_train``, outside ``launches``;
the scalar
kernel's entry carries ``sharded``: phase 3b's launches, each mode's, the
replays' times and the static balance figures; the vector kernel's the
sharded GCN's launches, ms an epoch and peak memory by mode, and phase
3c's GCN runs; the flash entry's ``launches`` counts the models'
counted runs (the prefills of Hymba, Gemma and OLMoE; Whisper's prefill
and decode steps; TinyLlama's timed training steps, with and without the
mesh),
``launches_by_model`` each, and its sums
the Hymba prefill's timed launches, ``timed`` says so; the scalar
entry's ``launches`` also counts rank 0's launches in phases 10 and 11
and the vector entry's those
of phase 10's rank 0 and of the drill, each listed under its own key;
the worker_count entry's ``launches`` counts every launch in the
script's own process, ``launches_main_path`` phase 3's timed runs), then
the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:    # the card's published rates, as the dry run's roofline has them
    from repro_torch.launch.roofline import FP32_FLOPS, HBM_BW
except ImportError as exc:
    print(f"chip_smoke: FAILED: no src/repro_torch beside "
          f"{Path(__file__).name} ({exc}): run it from a checkout of the "
          "repository", file=sys.stderr, flush=True)
    sys.exit(1)
HBM_BYTES_PER_S = HBM_BW           # H100 SXM device memory rate
FP32_OPS_PER_S = FP32_FLOPS        # H100 SXM float32 outside tensor cores
KERNEL_SOURCE = "src/repro_torch/csrc/segment_combine.cu"
KERNEL_REPLACES = "src/repro/kernels/segment_combine/kernel.py:60"
VEC_KERNEL_REPLACES = "src/repro/kernels/segment_combine/kernel.py:84"
WC_SOURCE = "src/repro_torch/csrc/worker_count.cu"
WC_REPLACES = ("none: the JAX package's zeros(M).at[w].add(c) is an XLA "
               "scatter")
# The worker_count kernel's launches (plan.per_worker on CUDA tensors) a
# superstep of phase 3's runs: the broadcast algorithms' Ch_msg flags,
# plan segments and mirror fan-out; S-V's request-respond gathers, its
# broadcast and its sorted combines; attribute broadcast's one gather;
# MSF's election and its gathers, and 2 more a pointer jump beyond the
# first read of each superstep (res.jump_reads - supersteps jumps)
WC_PER_SS = {"hashmin": 3, "pagerank": 3, "sssp": 3, "sv": 13, "msf": 26,
             "attr_bcast": 4}
WC_PER_JUMP = 2
GCN = {"feat_dim": 32, "hidden": 64, "n_classes": 8, "lr": 1e-2}
GCN_EPOCHS = 4
GCN_CLIP, ADAM_EPS = 1.0, 1e-8     # the GCN step's clip norm, AdamW's eps
PARITY_N = 200_000
U32 = 2.0 ** -24                   # float32 unit roundoff
# a float32 loss is a mean of n float32 terms, each within a few ulps
LOSS_RTOL = 1e-5
# with the card's own relu derivative, a float32 gradient differs from
# float64 by summation order only, ~1e-6 of its norm; a wrong or missing
# term moves it by O(1)
GRAD_RTOL = 1e-4
# one epoch of Engine.run evaluates the forward again: the merge's atomic
# adds reorder its float32 sums, so a few pre-activations within round-off
# of 0 may take the other side of the relu, each moving the step by about
# 1e-4 of its norm
STEP_RTOL = 1e-3
LM_ARCH = "hymba_1_5b"
GEMMA_ARCH = "gemma3_4b"
# Gemma-3-4B's layers checked against the plain path and the no-cache
# forward: the first six, five window layers and the first global one
# (every sixth layer is global)
GEMMA_CHECK_LAYERS = 6
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 64
OLMOE_ARCH = "olmoe_1b_7b"
# OLMoE's layers checked in the forms (b) and (c) of phase 13
OLMOE_CHECK_LAYERS = 4
# the OLMoE prefill's device ms on an H100 80GB HBM3 at 700 W when the MoE
# dispatch packed only the kept pairs (nonzero, bincount), printed beside
# the static-shape dispatch's (the dump-row scatter)
OLMOE_PREFILL_BEFORE_MS = 574.893
WHISPER_ARCH = "whisper_medium"
WHISPER_PROMPT = 384         # + 64 generated: 448, Whisper's text context
WHISPER_CHECK_LAYERS = 4     # encoder and decoder layers of (b) and (c)
# The MoE half of a layer against its float64 recomputation on the same
# routing: float32 products over D=2048 and F=1024 and a sum of k=8 gated
# terms sit near 1e-6 of max|y|; an index or slot fault moves a whole
# token's row, O(1) of it.
MOE_RTOL = 1e-4
# The K/V a decode step writes against the no-cache forward's (the same
# projections of the same rows, products of another shape): ~1e-6 of max.
KV_RTOL = 1e-5
# Phase 14: one full-width OLMoE MoE layer on MOE_EP_RANKS spawned ranks
# over MOE_EP_TOKENS tokens (B*S of the serve phases), n_mirrored_experts
# 0 and 2 (copies tied to experts 0-1); each rank's output within EP_RTOL
# of max|y| of the same slice computed on one device with the rank's cap
# and mirror mask (the experts' products over another row count, and
# index_add_'s order of the k gated terms)
MOE_EP_RANKS = 2
MOE_EP_TOKENS = 8192
MOE_EP_MIRRORED = (0, 2)
EP_RTOL = 1e-5
MOE_JOIN_S = 600
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:27"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:20"
# Tolerances of the serve phase.  Random cases (scores ~N(0, 1)): the
# flash kernel sums each query's d-long products and Sk weighted rows in
# float32 in another order than the plain version, ~1e-6 of max|v|.
FLASH_F32_TOL = 1e-5
FLASH_BF16_TOL = 2e-2      # bfloat16 output rounding, as the JAX tests
LIB_TOL = 1e-4             # SDPA (another float32 order) vs float64
FLASH_CASE_S = (64, 100, 129, 2048, 2112)   # the random cases' lengths
# unmasked (Sq, Sk): a decode step's, a prompt's and a longer prompt's
# cross-attention against Whisper's 1500 frames, and a ragged small pair
FLASH_RECT = ((1, 1500), (384, 1500), (1600, 1500), (37, 100))
# the chunked scan takes exp of differences of float32 cumulative sums
# (|cum| up to ~100 in a chunk: ~1e-5 relative), the oracle is the float64
# recurrence
SSD_RTOL = 1e-4
# On the path's own inputs the scores reach the hundreds, and rounding a
# score to float32 (~1e-5 there) becomes a relative error of its softmax
# weight: both the kernel and the float32 plain version sit ~5e-5 of
# max|v| from float64, above the 1e-5 that holds for random cases.  There
# each kernel is held to the larger of its random-case bound and
# PLAIN_FACTOR times the float32 plain version's own distance from the
# float64 oracle: no less accurate than the plain float32 computation.
PLAIN_FACTOR = 4.0
# a layer's update on the same input, kernels vs plain path, or prefill +
# decode vs the no-cache forward: float32 order and the conditioning
# above (attention, scan and MLP errors of ~1e-5..1e-4 of the update's
# max); a mask, GQA, state or ring-buffer fault moves it by O(1)
LAYER_RTOL = 1e-3
LOGIT_RTOL = 1e-3
SHARDED_M = 8                # workers of phase 3c, M=8 over D ranks
# Phase 9, the graph service at serve_graph's defaults.  SSSP distances
# are float32 sums along a path, Dijkstra's float64 (np.allclose's rtol,
# as the launcher's check); PPR within the launcher's atol of the float64
# power iteration; between world sizes, PPR's float32 sums of each
# vertex's in-edges combine in another order across ranks
SERVICE_SSSP_RTOL = 1e-5
SERVICE_PPR_ATOL = 1e-5
SERVICE_PPR_RTOL = 1e-5      # of max|ppr|, world size 2 vs 1
SERVICE_RANKS = 2
# The scalar kernel's launches a superstep on a rank of the sharded
# executor, the same on the 1-D and 2-D meshes and under split: the
# broadcast algorithms launch for the eg plan's values and hit counts and
# the mirror plan's values, S-V for the all plan's values and hit counts,
# MSF and attribute broadcast never (their combines have runtime targets
# and go through the routed sorted segments).  A rank's stacked plan has
# at least one row, so it launches even when it holds no edge of a kind.
SHARDED_PER_SS = {"hashmin": 3, "pagerank": 3, "sssp": 3, "sv": 2,
                  "msf": 0, "attr_bcast": 0}
# under the pipeline with PIPELINE_CHUNKS chunks a join, the exchanged
# plans' values (eg, all) launch once a chunk; the mirror fan-out of a
# partition that is not split is destination-local, one launch
PIPELINE_CHUNKS = 2
PIPELINED_PER_SS = {"hashmin": 4, "pagerank": 4, "sssp": 4, "sv": 3,
                    "msf": 0, "attr_bcast": 0}
CHUNKED_PLAN = {"hashmin": "eg", "pagerank": "eg", "sssp": "eg",
                "sv": "all"}
# the split partitions' hot-worker factor: the partitioner's own vertex
# cut already holds every worker of these graphs under 1.2 (and 1.05) of
# the mean edge load, so the default 1.2 cuts none; at 1.0 every worker
# above the mean is cut into two shards (M=32 -> 61 at n=200k)
SPLIT_FACTOR = 1.0
GROUP_TIMEOUT_S = 120        # every process group's collective timeout
SHARDED_JOIN_S = 600         # deadline for the phase 3c ranks
# The vector kernel's launches an epoch of the sharded GCN on a rank at
# D=1 (n=4M, M=32): each of an epoch's four joins (two forward, two
# backward) runs the eg and mirror plans in vec_chunk_rows chunks; a D=1
# rank's plans are the single-device plans, and no segment leaves the rank
# (so the pipeline cuts no rows either), so it launches what one device
# launches: 222 an epoch (888 in 4 epochs).
SHARDED_VEC_PER_EPOCH = 222
# The same on the split partition at SPLIT_FACTOR 1.0: a D=1 rank runs the
# split partition's one-device plans, whose eg plan has more rows (its
# cut workers' shards pad their blocks apart), so it launches what the
# one-device GCN launches on that partition: 310 an epoch (measured on
# the H100, PERF.md), checked against that one-device run here too.
SPLIT_VEC_PER_EPOCH = 310
# the (n, M) those constants are for; at another --n the one-device runs'
# counts stand in
GCN_SIZE = (4_000_000, 32)
GCN_SHARDED_EPOCHS = 2       # epochs of each sharded GCN mode but the 1-D
# the loss history of a sharded GCN against one device (the reference's
# own sharded contract, tests/test_gspmm.py)
GCN_LOSS_RTOL, GCN_LOSS_ATOL = 2e-4, 2e-5
# Trained params against one device, |d change| / |change| of each leaf:
# two one-device runs on the card already differ (atomic float adds
# reorder the joins' sums, a pre-activation within round-off of 0 may
# take the other side of the relu, and the epochs amplify it): H100 runs
# (PERF.md) read at most 6.3e-4 between two one-device runs and 5.9e-4
# between a sharded and a one-device run.  The control (one vector
# combine of the run dropped) must read above the limit.
PARAM_RTOL = 5e-3
# Phase 10: shard_check's gates that must hold, and its deadline
SHARD_CHECK_GATES = ("all_to_all", "routed_memory", "masked_lanes_ok",
                     "hier_levels", "hier_caps_ok", "gspmm_hier",
                     "gspmm_hier_f1")
SHARD_CHECK_TIMEOUT_S = 600
DIST_SMOKE_TIMEOUT_S = 300
# Phase 12: the drill kills the GCN after this many of its GCN_EPOCHS;
# the loss curve is held to the reference drill's tolerance
# (tests/test_checkpoint_fault.py)
DRILL_KILL = 2
DRILL_RTOL, DRILL_ATOL = 2e-4, 1e-5
# Phase 16: TinyLlama-1.1B trained at full width and depth on SyntheticLM
# batches of 4 x 2048 tokens; one warm-up step, TRAIN_STEPS timed
TRAIN_ARCH = "tinyllama_1_1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 3
TRAIN_CHECK_LAYERS = 4       # (b): layers 0-3
# (b): a parameter gradient of a layer sums T=2048 tokens' float32
# products, ~1e-5 of its max from float64; the floor of the PLAIN_FACTOR
# rule
LAYER_GRAD_RTOL = 1e-4
# (g): the launcher at full width with the depth cut to 2 layers (a
# checkpoint of 3.5 GB), 4 steps straight, cut after 2 and resumed
TRAIN_LAUNCHER_LAYERS, TRAIN_LAUNCHER_STEPS, TRAIN_CUT = 2, 4, 2
# Phase 17: the training mesh.  TinyLlama-1.1B on the (1, 1) mesh over an
# in-process NCCL group of world size 1: one warm-up step, MESH_STEPS
# timed.  Gate (h), the mesh step against the one-device step from one
# state: the loss bitwise (the same forward: the collectives of groups of
# one rank are skipped), every gradient leaf bitwise but the embedding's
# (gate (c)'s atomics bound); grad_norm within MESH_GNORM_RTOL (the
# embedding's sum of squares takes the atomics' order: 2 (n-1) 2^-24 of
# a row's squares at most, far inside 1e-6), and then the clip scale too:
# each state leaf equal bitwise when grad_norm is, else within
# MESH_STATE_RTOL of its max (a scale off by rtol r moves an AdamW
# update by about r; m and v by r and 2r), the embedding's params and
# master within AdamW's sign-flip bound (4 lr + 1e-6 of the max: an entry
# whose gradient is float32 noise moves by +-lr either way)
MESH_STEPS = 2
MESH_GNORM_RTOL = 1e-6
MESH_STATE_RTOL = 1e-5
# the (2, 2) mesh on the card: MESH_RANKS spawned ranks, TinyLlama at full
# width with the depth cut to MESH_RANK_LAYERS, one step from one state on
# the global batch of TRAIN_BATCH x TRAIN_SEQ, gathered and held to the
# one-device step on rank 0 at tests/test_torch_train_step.py's
# tolerances: loss rtol 1e-5 and grad_norm 1e-3 (float32 sums over the
# data slices, the vocab shards and the token slices in another order), m
# and v within the larger of 3e-3 and 6e-3 of their max and PLAIN_FACTOR
# times the distance between two one-device orders of the same step (the
# whole batch, and 2 microbatches: the same function, its sums split as
# the data slices split them; at full width a leaf such as layer 0's wq
# has gradients that cancel to float32 noise, where 3e-3 of the max alone
# is below the noise of any second order), params and master within the
# sign-flip bound and their change within 0.1 of the one-device change
MESH_RANK_SHAPE = (2, 2)
MESH_RANKS = 4
MESH_RANK_LAYERS = 2
MESH_JOIN_S = 600
MESH_LOSS_RTOL, MESH_RANK_GNORM_RTOL = 1e-5, 1e-3
MESH_M_RTOL, MESH_V_RTOL = 3e-3, 6e-3
MESH_UPDATE_MAX, MESH_CHANGE_RTOL = 2.0, 0.1
# In the same spawn, after the tensor-parallel step, the same TinyLlama
# from the same state and batch under train_state_specs(zero1=True) and
# (fsdp=True), then OLMoE-1B-7B at full width (64 experts, 32 stored a
# rank) with its depth cut to MESH_OLMOE_LAYERS under fsdp, one step on
# MESH_OLMOE_BATCH x MESH_OLMOE_SEQ tokens with aux_weight 0 and a
# capacity factor of n_experts / top_k (a capacity of every token: no
# (token, slot) pair is dropped, so the routing of each rank's slice is
# the routing over the whole batch, and the one-device step is the
# target); each held to its one-device step under the tolerances above,
# each rank's bytes of params and optimizer state equal to what the
# placed specs imply ([mesh-zero] lines)
MESH_OLMOE_LAYERS = 1
MESH_OLMOE_BATCH, MESH_OLMOE_SEQ = 2, 1024
# phase 14's backward: EP_GRAD_TOKENS tokens a rank at a capacity with no
# drops; x's and each expert leaf's gradient, and the router's without the
# aux term, against moe_ffn_ref's autograd on one device within
# EP_GRAD_RTOL of the leaf's max (each side sums the expert products in
# cuBLAS's order for its own batch shapes; MOE_RTOL)
EP_GRAD_TOKENS = 1024
EP_GRAD_RTOL = 1e-4
# phase 18: serving on the (1, 2) mesh, SERVE_MESH_RANKS spawned ranks
# (gloo on cuda:0 on a one-card machine; NCCL refuses two ranks on one
# card): TinyLlama-1.1B at full width and depth, then Hymba-1.5B at full
# width with its depth cut to a window, a global and a window layer; B x S
# prompts, then SERVE_MESH_GEN greedy decode steps at max_len S + GEN
# (every stage's cache length splits over the model axis).  Rank 0 holds
# the gathered logits and cache to the same params served on one device
# ("auto"): each within the larger of SERVE_MESH_FLOOR and PLAIN_FACTOR
# times the distance between two one-device orders ("auto" and "ref":
# the kernels and the plain attention / scan) of the same quantity; the
# first SERVE_MESH_CHECK_LAYERS layers one by one on the same input
# likewise, the first layers also through prefill and decode on the
# served tokens (teacher forcing).  The floors are tests/test_torch_lm.py's
# tolerances: 1e-4 of the max for the prefill's logits, the cache and a
# layer on the same input, 1e-3 (its chained steps') for the logits of
# the decode steps, each step's input the mesh's own cache: the float32
# reorderings of the row-parallel sums compound there (on an H100 at
# 700 W Hymba's steps 10 and 16 reached 3.9e-4 and 6.3e-4 of the max,
# where the two one-device orders differ by 3.9e-5 and 5.2e-5).  The greedy tokens equal
# wherever the one-device top-2 margin exceeds the step's bound
SERVE_MESH_SHAPE = (1, 2)
SERVE_MESH_RANKS = 2
SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_GEN = 2, 1024, 16
SERVE_MESH_ARCHS = (("tinyllama_1_1b", {}),
                    ("hymba_1_5b", {"n_layers": 3, "global_every": 2}))
SERVE_MESH_CHECK_LAYERS = 2
SERVE_MESH_FLOOR = 1e-4
SERVE_MESH_CHAIN_FLOOR = 1e-3
SERVE_MESH_JOIN_S = 600
# phase 19: the four examples of examples/torch/ through their main() in a
# spawned process of its own at the reference's defaults on the card
# (quickstart at 20,000 vertices, graph_analytics at 10,000, serve_lm's
# three reduced archs, train_lm's 200 steps), then the two graph examples
# again with --device cpu (EXAMPLES_CPU_THREADS threads: the process runs
# beside phase 3's host work): every integer they return (msgs_* and
# per_worker_* counts, supersteps, rounds, labels) equal between card and
# CPU; train_lm's losses finite and falling
EXAMPLES = ("quickstart", "graph_analytics", "serve_lm", "train_lm")
EXAMPLES_CPU = ("quickstart", "graph_analytics")
EXAMPLES_CPU_THREADS = 2
EXAMPLES_TIMEOUT_S = 900
# phase 20: the dry run of the production mesh (launch/dryrun.py: rank 0's
# program on meta tensors in a fake world; no device) in a spawned process
# of its own: DRYRUN_ARCHS x every shape on the 16 x 16 and 2 x 16 x 16
# meshes (the whole matrix takes about 8 minutes on a CPU: these four
# cover the dense, MoE, local/global and hybrid SSM stage kinds); then
# phase 17's (2, 2) runs (mesh_rank_archs) at float32 in a fake world of
# MESH_RANKS, gated against that phase's ranks of the same call; and
# phase 16's TinyLlama step on the (1, 1) mesh, its FLOPs beside
# train_products
DRYRUN_ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "gemma3_4b", "hymba_1_5b")
DRYRUN_TIMEOUT_S = 900


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Per-phase wall seconds, printed as each phase ends."""

    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {self.seconds[name]:.3f} s")
        return out


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def build_kernels():
    """Build the four kernel sources, one nvcc each, all started together,
    and print each build's -Xptxas -v report."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_combine import kernel as sc
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.worker_count import kernel as wc
    t0 = time.perf_counter()
    infos = _build.build_libraries([(m.SOURCE, m.LIB_NAME)
                                    for m in (sc, flash, ssd, wc)])
    for info in infos:
        log(f"[build] {info['path'].name}: built={info['built']} in "
            f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "smem" in line):
                log(f"[ptxas] {info['name']}: {line.strip()}")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 2 / 4: kernel against its plain version, timings
# ---------------------------------------------------------------------------

HALF_MANTISSA = {"torch.float16": 10, "torch.bfloat16": 7}


def half_ulp(torch, x, dtype):
    """The spacing of ``dtype`` (float16 or bfloat16) at magnitude ``x``
    (float64): 2^(floor(log2 x) - mantissa bits), the subnormals' below
    the least normal."""
    fi = torch.finfo(dtype)
    e = torch.floor(torch.log2(x.clamp(min=fi.tiny)))
    return torch.exp2(e - HALF_MANTISSA[str(dtype)])


def compare(torch, got, want, vals, idx, op, nb, ref_fn):
    """Max |got - want| (0 where both are equal, infinities included);
    fails unless ints and min/max are equal value for value (+0 and -0
    are one value) and a float sum is within the summation-order bound:
    2*eb*2^-24 of the slot's sum of |values| for float32 (both sides sum
    in float32, in other orders), and for a half type that plus one ulp
    of the half type at the larger of the two results (both sides sum in
    float32, then round once)."""
    g = got.double()
    w = want.double()
    same = (g == w)
    err = float((g - w).abs().masked_fill(same, 0).max()) if g.numel() else 0.
    if op == "sum" and vals.dtype.is_floating_point:
        abs_sum = ref_fn(vals.float().abs(), idx, "sum", nb).double()
        eb = vals.shape[1]
        bound = 2.0 * eb * 2.0 ** -24 * abs_sum
        if vals.dtype != torch.float32:
            bound = bound + half_ulp(torch, torch.maximum(g.abs(), w.abs()),
                                     vals.dtype)
        bad = ~same & ((g - w).abs() > bound)
    else:
        bad = ~same
    if bool(bad.any()):
        i = int(bad.reshape(-1).nonzero()[0])
        fail(f"kernel != plain ({op}, {vals.dtype}, {tuple(vals.shape)}, "
             f"nb={nb}) at flat slot {i}: {g.reshape(-1)[i].item()} vs "
             f"{w.reshape(-1)[i].item()}")
    return err


def random_idx(np, rng, R, eb, nb):
    """Random block-local indices in [-1, nb + 3), so padding, nb and
    beyond appear; row 0 (if R > 1) has all its lanes on one slot, row 1
    (if R > 2) is all padding."""
    idx = rng.randint(-1, nb + 3, (R, eb)).astype(np.int32)
    if R > 1:
        idx[0] = rng.randint(0, nb)
    if R > 2:
        idx[1] = -1
    return idx


def random_values(torch, np, rng, dtype, op, shape, dev):
    """Random payload values of ``shape`` as a tensor of ``dtype`` on
    ``dev``: int32 over its whole range with its bounds and -1 first;
    float32 normals with +-inf first under min/max; a half type's normals
    with 30% of them +-0.0 and +-inf (under min/max; +-1.5 in a sum, which
    keeps infinities out as the reference's own test does), float16 also
    at +-65504, its sentinels (drawn on the device from a generator seeded
    from ``rng``)."""
    if dtype.itemsize == 2:
        gen = torch.Generator(dev).manual_seed(int(rng.randint(2 ** 31)))
        v = torch.randn(shape, generator=gen, device=dev)
        special = torch.tensor([0.0, -0.0, 1.5, -1.5] if op == "sum"
                               else [0.0, -0.0, np.inf, -np.inf], device=dev)
        use = torch.rand(shape, generator=gen, device=dev) < 0.3
        pick = torch.randint(0, 4, shape, generator=gen, device=dev)
        v = torch.where(use, special[pick], v)
        if op != "sum" and dtype == torch.float16 and v.numel() >= 2:
            v.view(-1)[-2:] = torch.tensor([65504.0, -65504.0], device=dev)
        return v.to(dtype)
    if dtype == torch.int32:
        info = np.iinfo(np.int32)
        v = rng.randint(info.min, info.max, shape,
                        dtype=np.int64).astype(np.int32)
        v.reshape(-1)[:3] = [info.min, info.max, -1][:v.size]
        return torch.from_numpy(v).to(dev)
    v = rng.randn(*shape).astype(np.float32)
    if op != "sum":
        v.reshape(-1)[:2] = [np.inf, -np.inf][:v.size]
    return torch.from_numpy(v).to(dev)


PAYLOAD_DTYPES = ("int32", "float32", "float16", "bfloat16")


def random_cases(torch, np, kernel, ref_fn, dev, seed):
    rng = np.random.RandomState(seed)
    max_err = 0.0
    n_cases = 0
    for op in ("sum", "min", "max"):
        for dtype in (getattr(torch, d) for d in PAYLOAD_DTYPES):
            for eb, nb in [(8, 32), (64, 128), (512, 32), (512, 128),
                           (37, 100), (1, 1), (0, 16), (2048, 1024)]:
                R = int(rng.randint(1, 4000))
                idx = random_idx(np, rng, R, eb, nb)
                vt = random_values(torch, np, rng, dtype, op, (R, eb), dev)
                it = torch.from_numpy(idx).to(dev)
                got = kernel.segment_combine_blocks(vt, it, op, nb)
                torch.cuda.synchronize()
                if got.dtype != dtype:
                    fail(f"the scalar kernel returned {got.dtype} for "
                         f"{dtype} values")
                want = ref_fn(vt, it, op, nb)
                max_err = max(max_err, compare(torch, got, want, vt, it, op,
                                               nb, ref_fn))
                n_cases += 1
    log(f"[kernel] {n_cases} random cases ({', '.join(PAYLOAD_DTYPES)}; "
        "skewed, all-padding and out-of-range rows; +-0 and +-inf in the "
        f"half types) match the plain version (max |err| {max_err:.3g})")
    return max_err


def half_timing(torch, kernel, ref_fn, dev):
    """Both kernels on float32, float16 and bfloat16 values of one shape,
    min and sum: the scalar kernel at the main path's Ch_msg plan shape
    (1,387,616 rows x eb=64 into nb=128), the vector kernel at 50,000 of
    those rows and F=32.  One launch each between two CUDA events after a
    warm-up, beside its bytes' bound (values and indices read once, the
    blocks written once), each output held to the plain version
    (``compare``).  No path of either package sends a half payload to the
    kernel yet, so these are no main-path launches."""
    R, eb, nb = 1_387_616, 64, 128
    gen = torch.Generator(dev).manual_seed(11)
    idx = torch.randint(-1, nb, (R, eb), generator=gen, device=dev,
                        dtype=torch.int32)
    out = {}
    for F, rows in ((None, R), (32, 50_000)):
        it = idx[:rows]
        shape = (rows, eb) if F is None else (rows, eb, F)
        base = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            v = base.to(dt)
            s, f = v.element_size(), F or 1
            bound = (rows * eb * (s * f + 4) + rows * nb * s * f) \
                / HBM_BYTES_PER_S * 1e3
            for op in ("min", "sum"):
                def call():
                    return kernel.segment_combine_blocks(v, it, op, nb)
                call()                                           # warm-up
                got, ms = event_ms(torch, call)
                compare(torch, got, ref_fn(v, it, op, nb), v, it, op, nb,
                        ref_fn)
                key = (f"{'scalar' if F is None else 'vector'} {op} "
                       f"{str(dt).replace('torch.', '')}")
                out[key] = {"ms": ms, "bound_ms": bound}
            del v
        del base
    log("[kernel] segment_combine by payload type, one launch (ms, bound ms):"
        " " + "; ".join(f"{k} {v['ms']:.3f} ({v['bound_ms']:.3f})"
                        for k, v in out.items())
        + f" (scalar: {R} x {eb} rows into nb={nb}; vector: 50000 of them "
        "at F=32)")
    return out


def half_remap_case(torch, np, planlib, kernel, dev):
    """``plan._combine_rows`` on a float16 payload on the card: through the
    scalar kernel, the slots no edge reaches come back as the channel
    identities +-inf (not the kernel's +-65504 sentinels), the others as
    numpy's float16 reduction, bitwise."""
    from repro_torch.kernels.segment_combine.ops import (pack_edges,
                                                         pack_values)
    rng = np.random.RandomState(5)
    N, E, nb = 200, 600, 64
    dst = rng.randint(0, N // 2, E)
    vals = rng.randn(E).astype(np.float16)
    order, idxl = pack_edges(dst, N, nb=nb, eb_align=128)
    for op, red, ident in (("min", np.minimum, np.inf),
                           ("max", np.maximum, -np.inf)):
        pv = pack_values(vals, order, idxl, op)
        before = kernel.segment_combine_blocks.launches
        out = planlib._combine_rows(torch.from_numpy(pv).to(dev),
                                    torch.from_numpy(idxl).to(dev), op, nb)
        torch.cuda.synchronize()
        if kernel.segment_combine_blocks.launches != before + 1:
            fail("plan._combine_rows on float16 did not launch the kernel")
        got = out.cpu().numpy().reshape(-1)[:N]
        want = np.full(N, ident, np.float16)
        red.at(want, dst, vals)
        if got.dtype != np.float16 or not np.array_equal(
                got.view(np.int16), want.view(np.int16)):
            fail(f"plan._combine_rows float16 {op}: the remapped blocks "
                 "differ from numpy's reduction")
    log("[kernel] plan._combine_rows on a float16 payload (min, max): the "
        "kernel's +-65504 sentinels come back as +-inf where no edge "
        "lands, every slot bitwise equal to numpy's float16 reduction")


def random_vec_cases(torch, np, kernel, ref_fn, dev, seed):
    """The vector kernel against the plain version, and F=1 against the
    scalar kernel."""
    rng = np.random.RandomState(seed + 1)
    max_err = 0.0
    n_cases = 0
    for op in ("sum", "min", "max"):
        for dtype in (getattr(torch, d) for d in PAYLOAD_DTYPES):
            # F = 256 takes 8 half values (16 bytes) a load
            widths = (1, 3, 32, 64, 130) + ((256,) if dtype.itemsize == 2
                                            else ())
            for eb, nb in [(8, 32), (64, 128), (512, 128), (37, 100),
                           (64, 1024), (0, 8), (2048, 1024)]:
                for F in widths:
                    R = int(rng.randint(1, max(2, 2 ** 22 // (max(eb, 1)
                                                               * F))))
                    R = min(R, 2000)
                    idx = random_idx(np, rng, R, eb, nb)
                    vt = random_values(torch, np, rng, dtype, op,
                                       (R, eb, F), dev)
                    it = torch.from_numpy(idx).to(dev)
                    got = kernel.segment_combine_blocks(vt, it, op, nb)
                    torch.cuda.synchronize()
                    if got.dtype != dtype:
                        fail(f"the vector kernel returned {got.dtype} for "
                             f"{dtype} values")
                    want = ref_fn(vt, it, op, nb)
                    max_err = max(max_err, compare(torch, got, want, vt, it,
                                                   op, nb, ref_fn))
                    if F == 1:
                        scalar = kernel.launch(vt[:, :, 0].contiguous(), it,
                                               op, nb)
                        torch.cuda.synchronize()
                        bits = {2: torch.int16, 4: torch.int32}[
                            dtype.itemsize]
                        if not torch.equal(scalar.view(bits),
                                           got[:, :, 0].view(bits)):
                            fail(f"vector kernel at F=1 != scalar kernel "
                                 f"({op}, {dtype}, eb={eb}, nb={nb})")
                    n_cases += 1
    log(f"[kernel] {n_cases} random vector cases ({', '.join(PAYLOAD_DTYPES)}"
        "; skewed, all-padding and out-of-range rows; +-0 and +-inf in the "
        f"half types) match the plain version (max |err| {max_err:.3g}); "
        "F=1 equals the scalar kernel bit for bit")
    return max_err


def worker_count_cases(torch, np, dev, n, M, iters):
    """The worker_count kernel against its plain version on CPU copies of
    the same inputs, at phase 3's per_worker shapes: ``m`` (the powerlaw
    graph's ~15.6 n directed edges) int64 edge owners sorted by worker
    with bool flags (``per_worker_basic``), int32 sorted segment owners
    with bool flags (S-V's ``seg_row``), ``n`` random owners with int64
    and int32 counts (Ch_req), and unaligned views of the first two (one
    id a load).  A few ids at -1 and M must add nothing.  Every total must
    be equal; then the kernel, its plain version on the card and
    ``torch.bincount`` (the library yardstick, with its where copy) timed
    at the ``per_worker_basic`` shape."""
    from repro_torch.kernels.worker_count import kernel as wc
    from repro_torch.kernels.worker_count.ref import worker_count_ref
    m = n * 125 // 8
    gen = torch.Generator(device=dev).manual_seed(7)

    def sorted_ids(k, dtype):
        return torch.sort(torch.randint(-1, M + 1, (k,), device=dev,
                                        generator=gen)).values.to(dtype)
    flags = torch.rand(m, device=dev, generator=gen) < 0.5
    owners = sorted_ids(m, torch.int64)
    segs = sorted_ids(m, torch.int32)
    req = torch.randint(0, M, (n,), device=dev, generator=gen)
    cnt64 = torch.randint(0, 2 ** 40, (n,), device=dev, generator=gen)
    cnt32 = torch.randint(0, 1000, (n,), device=dev, generator=gen,
                          dtype=torch.int32)
    cases = [("edge owners int64, bool", owners, flags, True),
             ("seg_row int32, bool", segs, flags, True),
             ("Ch_req int64, int64 counts", req, cnt64, True),
             ("Ch_req int32, int32 counts", req.int(), cnt32, True),
             ("edge owners int64, bool, view [1:]", owners[1:], flags[1:],
              False),
             ("seg_row int32, bool, view [3:]", segs[3:], flags[3:], False)]
    before = wc.launches()
    for name, ids, counts, aligned in cases:
        if wc._aligned(ids, counts) != aligned:
            fail(f"worker_count case {name}: aligned={not aligned}, the "
                 "case does not take the load it names")
        got = wc.worker_count(ids, counts, M)
        torch.cuda.synchronize()
        want = worker_count_ref(ids.cpu(), counts.cpu(), M)
        if not torch.equal(got.cpu(), want):
            fail(f"worker_count kernel != plain version: {name}, "
                 f"{ids.numel()} ids, M={M}")
    if wc.launches() - before != len(cases):
        fail(f"worker_count: {wc.launches() - before} launches for "
             f"{len(cases)} cases")
    row = {"n": m, "M": M, "ids": "int64 sorted", "counts": "bool",
           "bytes": m * (owners.element_size() + 1) + 8 * M,
           "ms": cuda_ms(torch, lambda: wc.launch(owners, flags, M), iters),
           "plain_ms": cuda_ms(torch, lambda: worker_count_ref(
               owners, flags, M), iters),
           "library_ms": cuda_ms(torch, lambda: torch.bincount(
               torch.where(flags & (owners >= 0), owners, M),
               minlength=M + 1)[:M], iters)}
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] worker_count: {len(cases)} cases at phase 3's per_worker "
        f"shapes ({m} and {n} ids, M={M}, aligned and unaligned) equal the "
        f"plain version; at {m} sorted int64 ids and bool flags: kernel "
        f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f}, bincount "
        f"{row['library_ms']:.3f}, bound {row['bound_ms']:.3f} (bytes)")
    return row


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def add_launch(torch, row, fns, outs_cmp, ref_fn):
    """Time one launch's calls once each (CUDA events) into ``row`` and
    hold the kernel and the library call against the plain version."""
    outs = {}
    for key, fn in fns.items():
        outs[key], ms = event_ms(torch, fn)
        row[key] += ms
    row["launches"] += 1
    packed, idx, op, nb, shape = outs_cmp
    row["max_abs_err"] = max(row["max_abs_err"], compare(
        torch, outs["ms"], outs["plain_ms"], packed, idx, op, nb, ref_fn))
    compare(torch, outs["library_ms"].view(shape), outs["plain_ms"], packed,
            idx, op, nb, ref_fn)
    return outs["ms"]


def finish_rows(rows, bytes_of, ops_of):
    """Each row's bound over all its launches: the larger of its least
    bytes (``bytes_of``) at the memory rate and its operations
    (``ops_of``) at the float32 rate; and its ratios."""
    for row in rows:
        row["bytes"] = bytes_of(row)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S
        t_ops = ops_of(row) / FP32_OPS_PER_S
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        add_ratios(row)


def add_ratios(row):
    """``kernel_over_library`` (below 1: the kernel is faster than the
    library call) and ``bound_over_kernel`` (the share of the bound the
    kernel reaches) of a row or a kernels-line entry."""
    row["kernel_over_library"] = row["ms"] / row["library_ms"]
    row["bound_over_kernel"] = row["bound_ms"] / row["ms"]
    return row


def ratio_text(row) -> str:
    return (f"kernel/library {row['kernel_over_library']:.3f}, "
            f"bound/kernel {row['bound_over_kernel']:.3f}")


def algo_launches(torch, kernel, ref_fn, eng, pg, algos, kinds):
    """Time the scalar kernel on every launch of the counted algorithm
    runs: a replay runs each algorithm twice, as counted, with
    ``kernel.launch`` wrapped so that each launch, on the inputs the path
    hands it, is timed once (kernel, plain version, and one
    ``torch.full`` + ``scatter_reduce_`` into a flat (rows*nb,) buffer,
    which writes the output once) and held against the plain version.
    Returns one row per (algorithm, plan, op)."""
    from repro_torch.kernels.segment_combine.ref import block_identity
    acc = {}
    launch = kernel.launch
    algo_now = []

    def timed_launch(vals, idx, op, nb):
        R, eb = vals.shape
        dtype = str(vals.dtype).split(".")[-1]
        name = f"{algo_now[-1]}/{kinds[(R, eb)]}-{op}"
        row = acc.get(name)
        ident = block_identity(op, vals.dtype)
        hit = idx >= 0
        flat_idx = (torch.arange(R, device=vals.device)[:, None] * nb
                    + torch.where(hit, idx, 0).long()).reshape(-1)
        flat_val = torch.where(hit, vals, ident).reshape(-1)
        red = {"sum": "sum", "min": "amin", "max": "amax"}[op]
        fns = {"ms": lambda: launch(vals, idx, op, nb),
               "plain_ms": lambda: ref_fn(vals, idx, op, nb),
               "library_ms": lambda: torch.full(
                   (R * nb,), ident, dtype=vals.dtype,
                   device=vals.device).scatter_reduce_(
                       0, flat_idx, flat_val, red)}
        if row is None:                           # warm-up, not timed
            row = acc[name] = {
                "launch": name, "op": op, "dtype": dtype, "rows": R,
                "eb": eb, "nb": nb, "item": vals.element_size(),
                "launches": 0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0}
            for fn in fns.values():
                fn()
        return add_launch(torch, row, fns, (vals, idx, op, nb, (R, nb)),
                          ref_fn)
    kernel.launch = timed_launch
    try:
        for algo, params in algos:
            algo_now.append(algo)
            for _ in ("cold", "warm"):
                eng.run(algo, pg, **params)
    finally:
        kernel.launch = launch
    rows = list(acc.values())
    # a launch reads every lane and index once and writes its output once
    finish_rows(rows, lambda r: r["launches"] * r["rows"] * (
                    r["eb"] * (r["item"] + 4) + r["nb"] * r["item"]),
                lambda r: r["launches"] * r["rows"] * r["eb"])
    for r in rows:
        n = r["launches"]
        log(f"[kernel] {r['launch']}: {r['op']} {r['dtype']} {r['rows']} x "
            f"{r['eb']} -> nb={r['nb']}, {n} launches: kernel "
            f"{r['ms']:.4f} ms ({r['ms'] / n:.4f} each), plain "
            f"{r['plain_ms']:.4f} ({r['plain_ms'] / n:.4f}), library "
            f"{r['library_ms']:.4f} ({r['library_ms'] / n:.4f}), bound "
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / n:.4f}) ms; "
            f"{ratio_text(r)}")
    return rows


def event_ms(torch, fn):
    """(result, device ms) of one call of ``fn`` between two CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def join_inputs(torch, eng, pg, params0):
    """The input of every gSpMM join of a replay of the counted GCN run
    (same params, same epochs), in call order: per epoch the two forward
    joins' features and the two backward joins' cotangents.  Recorded by
    wrapping ``channels.broadcast``, through which every join runs.
    Returns them and the replay's result."""
    from repro_torch.core import channels
    seen = []
    broadcast = channels.broadcast

    def record(g, vals, *a, **kw):
        seen.append(vals.detach().clone())
        return broadcast(g, vals, *a, **kw)
    channels.broadcast = record
    try:
        res = eng.run("gcn", pg, epochs=GCN_EPOCHS, params=params0, **GCN)
    finally:
        channels.broadcast = broadcast
    if len(seen) != 4 * GCN_EPOCHS:
        fail(f"gcn replay: {len(seen)} joins in {GCN_EPOCHS} epochs, "
             "expected 4 an epoch")
    return seen, res


def gcn_launches(torch, planlib, kernel, ref_fn, pg, inputs):
    """Time the vector kernel on every launch of the counted GCN run: for
    each join input of its replay (``join_inputs``) and each of the Ch_msg
    and mirror plans, every row chunk, its lanes composed as the join
    composes them (a source gather times the normalized weight).  Each
    chunk is timed once (kernel, plain version, and one ``torch.zeros`` +
    ``index_add_`` on the (rows*nb, F) view, which writes the output once)
    and held against the plain version.  Returns one row per (plan, F),
    summed over its joins."""
    dev = pg.device
    safe = pg.mir_ids.long().clamp(0, pg.n_pad - 1)
    valid = (pg.mir_ids < pg.n_pad).reshape(-1)
    acc = {}
    for x in inputs:
        F = x.shape[-1]
        flat = x.reshape(-1, F)
        maps = {"eg": (flat, pg.eg_src.long(), pg.eg_w),
                "mir": (torch.where(valid[:, None], flat[safe], 0.0),
                        pg.mir_esrc.long().reshape(-1),
                        pg.mir_ew.reshape(-1))}
        for kind, (src, index, w) in maps.items():
            plan = planlib.get_plan(pg, kind)
            dp = planlib.device_plan(plan, dev)
            step = planlib.vec_chunk_rows(plan, F)
            nb, eb = plan.nb, plan.eb
            first = (kind, F) not in acc
            row = acc.setdefault((kind, F), {
                "launch": f"gcn/{kind}-F{F}", "op": "sum",
                "dtype": "float32", "rows": plan.n_rows, "eb": eb, "nb": nb,
                "F": F, "chunk_rows": step, "joins": 0, "launches": 0,
                "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "max_abs_err": 0.0})
            for r0 in range(0, plan.n_rows, step):
                sl = slice(r0, r0 + step)
                lanes = dp.row_gather[sl]
                packed = torch.where(dp.row_valid[sl][..., None],
                                     src[index[lanes]] * w[lanes][..., None],
                                     0.0).contiguous()
                idx = dp.row_local[sl]
                R = packed.shape[0]
                hit = idx >= 0
                flat_idx = (torch.arange(R, device=dev)[:, None] * nb
                            + torch.where(hit, idx, 0).long()).reshape(-1)
                flat_val = torch.where(hit[..., None], packed, 0.0
                                       ).reshape(-1, F)
                fns = {"ms": lambda: kernel.segment_combine_blocks(
                           packed, idx, "sum", nb),
                       "plain_ms": lambda: ref_fn(packed, idx, "sum", nb),
                       "library_ms": lambda: torch.zeros(
                           (R * nb, F), device=dev).index_add_(
                               0, flat_idx, flat_val)}
                if first and r0 == 0:             # warm-up, not timed
                    for fn in fns.values():
                        fn()
                add_launch(torch, row, fns,
                           (packed, idx, "sum", nb, (R, nb, F)), ref_fn)
                del packed, flat_val
            row["joins"] += 1
    rows = list(acc.values())
    # a join reads every lane and index once and writes the dense
    # (rows, nb, F) output once
    finish_rows(rows, lambda r: r["joins"] * r["rows"] * (
                    r["eb"] * (4 * r["F"] + 4) + r["nb"] * 4 * r["F"]),
                lambda r: r["joins"] * r["rows"] * r["eb"] * r["F"])
    for row in rows:
        R, eb, nb, F = row["rows"], row["eb"], row["nb"], row["F"]
        j = row["joins"]
        log(f"[kernel] {row['launch']}: sum float32 {R} x {eb} x {F} -> "
            f"nb={nb}, {j} joins in {row['launches']} launches: kernel "
            f"{row['ms']:.4f} ms ({row['ms'] / j:.4f} a join), plain "
            f"{row['plain_ms']:.4f} ({row['plain_ms'] / j:.4f}), library "
            f"{row['library_ms']:.4f} ({row['library_ms'] / j:.4f}), bound "
            f"{row['bound_ms']:.4f} ({row['bound_ms'] / j:.4f}) ms "
            f"({row['bytes'] / 1e9:.3f} GB); {ratio_text(row)}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path and its oracles
# ---------------------------------------------------------------------------

def adjacency(np, g):
    """scipy's float64 (n, n) adjacency: A[u, v] = w(u, v)."""
    import scipy.sparse as sp
    return sp.csr_matrix((g.weight.astype(np.float64), (g.src, g.dst)),
                         shape=(g.n, g.n))


def oracles(np, g, A, source: int, n_iters: int, damping: float = 0.85):
    """Connected components, shortest distances and PageRank of ``g`` by
    scipy / float64 numpy, independent of the port."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = g.n
    _, cc = csgraph.connected_components(A, directed=True,
                                         connection="weak")
    rep = np.full(cc.max() + 1, n, np.int64)
    np.minimum.at(rep, cc, np.arange(n))
    dist = csgraph.dijkstra(A, directed=True, indices=source)
    deg = np.bincount(g.src, minlength=n).astype(np.float64)
    P = sp.csr_matrix((np.ones(g.m), (g.dst, g.src)), shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(n_iters):
        contrib = np.where(deg > 0, x / np.maximum(deg, 1), 0.0)
        x = (1 - damping) / n + damping * (P @ contrib)
    return rep[cc], dist, x


def assert_stats_equal(np, name, sa, sb,
                       between="the pallas and dense backends"):
    """Stats as ``Engine.run`` returns them (host numbers) or as a channel
    join returns them (tensors on the card): equal, integer for integer."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    if set(sa) != set(sb):
        fail(f"{name}: stat keys differ: {sorted(sa)} vs {sorted(sb)}")
    for k in sa:
        if not np.array_equal(host(sa[k]), host(sb[k])):
            fail(f"{name}: {k} differs between {between}: {sa[k]} vs "
                 f"{sb[k]}")


def timed(torch, fn):
    """(result, device ms, host s) of ``fn`` bracketed by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def profile_run(torch, fn, name: str, top: int = 12,
                unit: str = "supersteps"):
    """Where the device time of one run goes (torch.profiler): the busy
    share of the run's wall time and the operators with the most device
    time of their own."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == cuda)
    if kernels_us <= 0:
        log(f"[profile] {name}: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[profile] {name}: {res.n_supersteps} {unit}, wall "
        f"{wall_us / 1e3:.3f} ms (profiled), device busy "
        f"{kernels_us / 1e3:.3f} ms = {100 * kernels_us / wall_us:.1f}%")
    ops = [e for e in prof.key_averages() if e.device_type != cuda
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:top]:
        log(f"[profile] {name}:   {e.key:40s} calls={e.count:5d} "
            f"device={e.self_device_time_total / 1e3:9.3f} ms "
            f"({100 * e.self_device_time_total / kernels_us:5.1f}%)")


def main_path(torch, np, mods, args, dev, phases, ready=None, beside=None,
              host_side=None):
    """Phase 3; ``ready()`` runs once the host set-up (graph, partition)
    is done, before any timed device work; ``beside()`` starts work whose
    card use is not timed before the host-only oracles and returns the
    call that waits for it, made before the profiles; ``host_side(g,
    pg)`` starts host work of a later phase at the same point."""
    api, structs, gen, cost_model, planlib, kernel = mods
    from repro_torch.kernels.worker_count import kernel as wc
    from repro_torch.train.gcn import normalize_adjacency
    g = phases.run("graph", lambda: normalize_adjacency(gen.powerlaw(
        args.n, avg_deg=8, seed=args.seed, weighted=True).symmetrized()))
    M = args.workers
    tau = cost_model.choose_tau(g.out_degrees(), M)
    log(f"[graph] powerlaw n={g.n} m={g.m} M={M} tau={tau} max_deg="
        f"{int(g.out_degrees().max())} layout=csr balance=hash")
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    pg = phases.run("partition", eng.partition, g, M, tau=tau,
                    seed=args.seed)
    if ready is not None:
        phases.run("launchers-wait", ready)

    def plans():
        out = {}
        for kind in ("eg", "mir", "all"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            plan = planlib.get_plan(pg, kind)
            planlib.device_plan(plan, dev)
            torch.cuda.synchronize()
            out[kind] = (plan, torch.cuda.memory_allocated() - before,
                         torch.cuda.max_memory_allocated() - before)
        return out
    plan = phases.run("plans", plans)
    for kind, (p, held, peak) in plan.items():
        log(f"[plan] {kind}: {p.n_rows} rows x eb={p.eb}, nb={p.nb}, "
            f"{p.n_segs} segments; {held / 2**30:.3f} GiB on the device "
            f"(peak {peak / 2**30:.3f} GiB while uploading)")
    plan = {kind: p for kind, (p, _, _) in plan.items()}
    # scalar launches a superstep: Ch_msg values and hit counts plus the
    # mirror fan-out (broadcast algorithms); the all plan's values and hit
    # counts (S-V's neighbour minimum); none where every combine has
    # runtime targets (MSF, attribute broadcast)
    bc_ss = 3 if plan["mir"].n_rows else 2
    per_ss = {"hashmin": bc_ss, "pagerank": bc_ss, "sssp": bc_ss, "sv": 2,
              "msf": 0, "attr_bcast": 0}

    attr = 3 * torch.arange(pg.n_pad, dtype=torch.float32,
                            device=dev).view(pg.M, pg.n_loc)
    # the algorithms through the kernel (replayed for the kernel timing),
    # then those without a kernel launch
    algos = [("hashmin", {}), ("pagerank", {"n_iters": 30, "tol": 0.0}),
             ("sssp", {"source": int(pg.perm[0])}), ("sv", {})]
    rr_algos = [("msf", {}), ("attr_bcast", {"attr": attr})]
    runs = {}
    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0   # the path starts here
    wc_launches = 0
    for algo, params in algos + rr_algos:
        # the first run pays the caching allocator's growth; the second
        # is the steady state
        for tag in ("cold", "warm"):
            before, wc_before = counter.launches, wc.launches()
            res, dev_ms, host_s = phases.run(
                f"{algo}-{tag}", timed, torch,
                lambda: eng.run(algo, pg, **params))
            launches = counter.launches - before
            wc_n = wc.launches() - wc_before
            wc_want = WC_PER_SS[algo] * res.n_supersteps + (
                0 if res.jump_reads is None
                else WC_PER_JUMP * (res.jump_reads - res.n_supersteps))
            if wc_n != wc_want:
                fail(f"{algo}: {wc_n} worker_count launches in "
                     f"{res.n_supersteps} supersteps, expected {wc_want}: "
                     "a per_worker tally did not go through the kernel")
            wc_launches += wc_n
            key = "msgs_total" if "msgs_total" in res.stats else "msgs_rr"
            jumps = ("" if res.jump_reads is None else
                     f"; {res.jump_reads} host reads in its pointer jumping")
            log(f"[run] {algo} ({tag}): {res.n_supersteps} supersteps, "
                f"{dev_ms:.3f} ms on the device clock "
                f"({dev_ms / res.n_supersteps:.3f} ms per superstep), "
                f"{host_s:.3f} s host; {launches} kernel launches, {wc_n} "
                f"worker_count; {key}={res.stats[key]}{jumps}")
            if launches != per_ss[algo] * res.n_supersteps:
                fail(f"{algo}: {launches} kernel launches in "
                     f"{res.n_supersteps} supersteps, expected "
                     f"{per_ss[algo]} per superstep: the path did not go "
                     "through the kernel" if per_ss[algo] else
                     f"{algo}: {launches} kernel launches, expected none")
        runs[algo] = (res, launches, dev_ms)
    main_launches = counter.launches          # ... and ends here
    if counter.launches_vec:
        fail(f"{counter.launches_vec} vector kernel launches on a scalar path")
    if bc_ss != 3:
        fail("no mirrored vertices at this size: Ch_mir did not run")

    # oracles independent of the port (host only)
    wait_beside = beside() if beside is not None else None
    if host_side is not None:
        host_side(g, pg)
    A = phases.run("adjacency", adjacency, np, g)
    cc, dist_o, pr_o = phases.run("oracles", oracles, np, g, A, 0, 30)
    labels = structs.canonical_labels(pg, runs["hashmin"][0].state)
    if not np.array_equal(labels, cc):
        fail(f"Hash-Min components differ from scipy's in "
             f"{int((labels != cc).sum())} vertices")
    dist = runs["sssp"][0].state.reshape(-1).cpu().numpy()[pg.perm]
    fin = np.isfinite(dist_o)
    if not (np.array_equal(np.isfinite(dist), fin)
            and np.allclose(dist[fin], dist_o[fin], rtol=1e-5, atol=0)):
        fail("SSSP distances differ from scipy's dijkstra beyond rtol=1e-5")
    pr = runs["pagerank"][0].state.reshape(-1).cpu().numpy()[pg.perm]
    if not np.allclose(pr, pr_o, rtol=1e-4, atol=0):
        fail("PageRank differs from the float64 power iteration beyond "
             f"rtol=1e-4 (max rel {np.max(np.abs(pr - pr_o) / pr_o):.3g})")
    d_rel = np.abs(dist[fin] - dist_o[fin]) / np.maximum(dist_o[fin], 1e-30)
    log(f"[check] oracles: {len(np.unique(cc))} components equal scipy's; "
        f"SSSP max rel err {d_rel.max():.3g} over {int(fin.sum())} "
        f"reachable vertices; PageRank max rel err "
        f"{np.max(np.abs(pr - pr_o) / pr_o):.3g}")
    phases.run("rr-oracles", rr_oracles, torch, np, structs, g, A, pg, runs,
               cc, attr)

    # the port's own dense backend on the card
    dense = api.Engine(backend="dense", layout="csr", balance="hash",
                       device=dev)

    def dense_checks():
        for algo, params in algos + rr_algos:
            res = dense.run(algo, pg, **params)
            ref = runs[algo][0]
            if res.n_supersteps != ref.n_supersteps:
                fail(f"{algo}: {res.n_supersteps} dense supersteps vs "
                     f"{ref.n_supersteps} pallas")
            assert_stats_equal(np, algo, res.stats, ref.stats)
            if algo == "msf":
                (la, wa, na), (lb, wb, nb) = res.state, ref.state
                ok = (torch.equal(la, lb) and int(na) == int(nb)
                      and float(wa) == float(wb))
            elif algo == "pagerank":
                ok = np.allclose(res.state.cpu().numpy(),
                                 ref.state.cpu().numpy(), rtol=1e-5, atol=0)
            else:
                ok = torch.equal(res.state, ref.state)
            if not ok:
                fail(f"{algo}: the pallas and dense backends disagree")
    phases.run("dense-parity", dense_checks)
    if wait_beside is not None:
        phases.run("beside-oracles-wait", wait_beside)
    log("[check] pallas == dense on the card: Hash-Min and S-V labels, SSSP "
        "distances, MSF labels, edge count and total weight, and the "
        "broadcast attributes bitwise, PageRank rtol=1e-5; every "
        "msgs_*/per_worker_* equal, and the same supersteps")
    for algo in ("sv", "msf", "attr_bcast"):
        st = runs[algo][0].stats
        pw_rr, pw_b = st["per_worker_rr"].max(), st["per_worker_basic"].max()
        log(f"[reqresp] {algo}: msgs_rr={st['msgs_rr']} msgs_basic="
            f"{st['msgs_basic']} (rr/basic {st['msgs_rr'] / st['msgs_basic']:.4f});"
            f" busiest worker {pw_rr} messages with Ch_req, {pw_b} without "
            f"({pw_rr / pw_b:.4f})")
    for algo, params in [("hashmin", {}),
                         ("pagerank", {"n_iters": 5, "tol": 0.0}),
                         ("sv", {}), ("msf", {})]:
        phases.run(f"profile-{algo}", profile_run, torch,
                   lambda: eng.run(algo, pg, **params), algo)
    return g, A, pg, (main_launches, wc_launches), algos, runs, rr_algos


def rr_oracles(torch, np, structs, g, A, pg, runs, cc, attr):
    """S-V, MSF and attribute broadcast against oracles independent of the
    port: S-V labels are scipy's components and, on real slots, Hash-Min's
    labels bitwise (both the least relabelled id of the component); MSF
    keeps exactly n - #components edges, its labels are the components,
    and its weight is scipy's minimum spanning forest's within 1e-5
    (float64 there, float32 sums here); the broadcast attributes are
    ``attr`` read at every edge's destination on the host, and without
    dedup the channel returns the same values with msgs_rr == msgs_basic.
    Every algorithm sends no more messages with Ch_req than without."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    from repro_torch.core import channels
    n_cc = len(np.unique(cc))
    sv = runs["sv"][0].state
    if not np.array_equal(structs.canonical_labels(pg, sv), cc):
        fail("S-V components differ from scipy's")
    vm = pg.vmask
    if not torch.equal(sv[vm], runs["hashmin"][0].state[vm]):
        fail("S-V labels differ from Hash-Min's on the real slots")
    labels, total_w, n_edges = runs["msf"][0].state
    if int(n_edges) != g.n - n_cc:
        fail(f"MSF kept {int(n_edges)} edges, expected n - #components = "
             f"{g.n - n_cc}")
    if not np.array_equal(structs.canonical_labels(pg, labels), cc):
        fail("MSF labels do not partition the vertices as the components")
    # each undirected edge once (both directions carry the same weight)
    mst = float(csgraph.minimum_spanning_tree(sp.triu(A, k=1).tocsr()).sum())
    w_err = abs(float(total_w) - mst) / mst
    if not w_err <= 1e-5:
        fail(f"MSF weight {float(total_w)} vs scipy's {mst}: rel err "
             f"{w_err:.3g} beyond 1e-5")
    edge_attr = runs["attr_bcast"][0].state
    want = attr.reshape(-1).cpu().numpy()[pg.host["all_dst"]]
    if not np.array_equal(edge_attr.cpu().numpy(), want):
        fail("attr_bcast: the per-edge attributes differ from attr[all_dst]")
    off, s_off = channels.gather_edges(pg, attr, pg.all_dst, pg.all_mask,
                                       dedup=False)
    if not (torch.equal(off, edge_attr)
            and int(s_off["msgs_rr"]) == int(s_off["msgs_basic"])):
        fail("attr_bcast without dedup: other values, or msgs_rr != "
             "msgs_basic")
    for algo in ("sv", "msf", "attr_bcast"):
        st = runs[algo][0].stats
        if not st["msgs_rr"] <= st["msgs_basic"]:
            fail(f"{algo}: msgs_rr {st['msgs_rr']} > msgs_basic "
                 f"{st['msgs_basic']}")
    log(f"[check] request-respond oracles: S-V = scipy's {n_cc} components "
        f"= Hash-Min's labels; MSF {int(n_edges)} edges = n - #components, "
        f"weight {float(total_w):.9g} vs scipy's {mst:.9g} (rel err "
        f"{w_err:.3g}, limit 1e-5); attr_bcast = attr[all_dst] on "
        f"{edge_attr.numel()} edges, and without dedup the same values "
        f"with msgs_rr = msgs_basic = {int(s_off['msgs_basic'])}")


B24 = 2 ** 24


def large_ids(torch, np, api, structs, kernel, dev):
    """S-V on ids that straddle 2^24, on the card (tests/test_large_ids.py's
    graph): n = 2^24 + 4 over M = 2 workers, where the seeded relabelling
    puts a singleton at 2^24 and a pair at 2^24 + 1 / 2^24 + 3.  A float32
    id path would give all three the label 2^24."""
    n, M, seed = B24 + 4, 2, 0
    perm = np.random.RandomState(seed).permutation(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    b, d = inv[B24 + 1], inv[B24 + 3]
    g = structs.Graph(n, np.array([b, d], np.int64),
                      np.array([d, b], np.int64))
    eng = api.Engine(backend="pallas", layout="csr", device=dev)
    pg = eng.partition(g, M, tau=None, seed=seed)
    if not np.array_equal(pg.perm, perm):
        fail("the hash relabelling is not RandomState(seed).permutation(n)")
    before = kernel.segment_combine_blocks.launches
    res = eng.run("sv", pg)
    launches = kernel.segment_combine_blocks.launches - before
    lab = res.state.reshape(-1)
    got = [int(lab[i]) for i in (B24, B24 + 1, B24 + 3)]
    if got != [B24, B24 + 1, B24 + 1]:
        fail(f"S-V labels at ids 2^24, 2^24+1, 2^24+3: {got}, expected "
             f"{[B24, B24 + 1, B24 + 1]}")
    if res.state.dtype != torch.int32 or launches != 2 * res.n_supersteps:
        fail(f"S-V at n=2^24+4: labels {res.state.dtype}, {launches} kernel "
             f"launches in {res.n_supersteps} supersteps")
    log(f"[check] S-V at n={n}, M={M}: labels of ids 2^24, 2^24+1, 2^24+3 = "
        f"{got} (exact, int32), {res.n_supersteps} supersteps, {launches} "
        "kernel launches")


# ---------------------------------------------------------------------------
# phases 3b and 3c: the sharded executor
# ---------------------------------------------------------------------------

def per_ss_of(pipeline: bool) -> dict:
    return PIPELINED_PER_SS if pipeline else SHARDED_PER_SS


def check_chunks(sg, algo, name):
    """Fail unless the plan that ``algo`` exchanges was cut into
    ``PIPELINE_CHUNKS`` chunks on this rank."""
    kind = CHUNKED_PLAN.get(algo)
    if kind is not None and sg.plans[kind].n_chunks != PIPELINE_CHUNKS:
        fail(f"{name}: the {kind} plan has {sg.plans[kind].n_chunks} "
             f"pipeline chunks, expected {PIPELINE_CHUNKS}")


def check_cut(pg, name):
    """Fail unless the split partition ``pg`` cut at least one worker."""
    if pg.M_phys <= pg.M:
        fail(f"{name}: the split partition cut no worker (M_phys="
             f"{pg.M_phys}, M={pg.M})")


def straddling(pg, bounds) -> int:
    """Workers of a split partition whose shards lie on two or more
    ranks, from the shard bounds ``bounds["phys"]`` of the placement."""
    pb = bounds["phys"][1:-1]
    pb = pb[(pb > 0) & (pb < pg.M_phys)]
    return len(set(int(pg.phys_log[b]) for b in pb
                   if pg.phys_log[b - 1] == pg.phys_log[b]))


@contextlib.contextmanager
def forced_chunks(exec_mod, on: bool):
    """``PIPELINE_CHUNKS`` chunks a join under the pipeline on a mesh of
    one rank, where the executor's default is one (nothing to overlap),
    so that the chunked plan exchange runs at the main path's size."""
    chunks_of = exec_mod._chunks_of
    if on:
        exec_mod._chunks_of = (lambda D, pipeline, chunks:
                               PIPELINE_CHUNKS if pipeline else None)
    try:
        yield
    finally:
        exec_mod._chunks_of = chunks_of


def sharded_gate(torch, np, name, algo, one, sh):
    """Fail unless the sharded run ``sh`` equals the single-device run
    ``one``: state bitwise (PageRank within rtol 1e-5; MSF's labels and
    edge count bitwise, its float32 weight within 1e-6), every stat equal,
    the same supersteps."""
    if sh.n_supersteps != one.n_supersteps:
        fail(f"{name}: {sh.n_supersteps} sharded supersteps vs "
             f"{one.n_supersteps} on one device")
    assert_stats_equal(np, name, one.stats, sh.stats,
                       between="the sharded and one-device runs")
    if algo == "msf":
        (la, wa, na), (lb, wb, nb) = sh.state, one.state
        ok = (torch.equal(la.to(lb.device), lb) and int(na) == int(nb)
              and abs(float(wa) - float(wb)) <= 1e-6 * abs(float(wb)))
    elif algo == "pagerank":
        ok = np.allclose(sh.state.cpu().numpy(), one.state.cpu().numpy(),
                         rtol=1e-5, atol=0)
    else:
        ok = torch.equal(sh.state.to(one.state.device), one.state)
    if not ok:
        fail(f"{name}: the sharded state differs from the one-device run")


def rounds_text(info) -> str:
    r = info["rounds"]
    if not r:
        return "no routed join"
    inner = info.get("inner_rounds") or []
    text = (f"{len(r) - len(inner)} routed joins, exchange rounds a join: "
            f"max {max(r)}, mean {sum(r) / len(r):.3f}")
    if inner:
        text += (f"; {len(inner)} inter-host legs (one host read each), "
                 f"rounds max {max(inner)}")
    return text


def sharded_run(torch, np, name, eng, pg, algo, params, one, one_ms, per_ss,
                kernel, phases):
    """One sharded run held to its one-device run ``one`` (device ms
    ``one_ms``), with the scalar kernel's launches counted from 0 just
    before it and read just after, against ``per_ss[algo]`` a superstep."""
    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0
    res, dev_ms, host_s = phases.run(name, timed, torch,
                                     lambda: eng.run(algo, pg, **params))
    launches, vec = counter.launches, counter.launches_vec
    sharded_gate(torch, np, name, algo, one, res)
    n = res.n_supersteps
    per_ss = per_ss[algo]
    if launches != per_ss * n or vec:
        fail(f"{name}: {launches} kernel launches ({vec} vector) in {n} "
             f"supersteps, expected {per_ss} per superstep: the path did "
             "not go through the kernel")
    reads = res.sharded["host_reads"] + (res.jump_reads or 0)
    log(f"[sharded] {name}: {n} supersteps, {dev_ms / n:.3f} ms a "
        f"superstep on the device clock (one device {one_ms / n:.3f}), "
        f"{host_s:.3f} s host; "
        f"{launches} kernel launches ({per_ss} a superstep); "
        f"{reads / n:.2f} host reads a superstep; "
        f"{rounds_text(res.sharded)}")
    return res, launches, dev_ms, host_s


def sharded_one(torch, np, mods, pg, runs, algos, ref_fn, dev, phases):
    """Phase 3b: the n=4M partition of the main path on the sharded
    executor over an in-process NCCL group of world size 1, each
    algorithm twice (cold, then warm; tables built first), held to the
    main path's own single-device runs, and four of them profiled; then one superstep's plan launches of Hash-Min and
    S-V replayed through the kernel and its plain version."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.core import exec as exec_mod
    api, kernel = mods[0], mods[5]
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                         devices=1, device=dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        sg = phases.run("sharded-1-build", exec_mod.shard, pg, 1,
                        ("eg", "mir", "all"), dev)
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - before
        log(f"[sharded] D=1 shard build: {sg.build_s:.3f} s on the host; "
            f"the rank's tables {sg.table_bytes() / 2**30:.3f} GiB on the "
            f"device ({added / 2**30:.3f} GiB allocated)")
        total = 0
        for algo, params in algos:
            # the first run also pays NCCL's lazy set-up and the caching
            # allocator's growth; the second is the steady state
            for tag in ("cold", "warm"):
                one, _, one_ms = runs[algo]
                _, launches, _, _ = sharded_run(
                    torch, np, f"sharded D=1 {algo} ({tag})", eng, pg, algo,
                    params, one, one_ms, SHARDED_PER_SS, kernel, phases)
                total += launches
        want_n = SHARDED_PER_SS["hashmin"] + SHARDED_PER_SS["sv"]
        row = phases.run("sharded-1-replay", sharded_replay, torch, kernel,
                         ref_fn, eng, pg, want_n, "D=1")
        profiled = dict(algos)
        for algo in ("hashmin", "sv", "msf", "attr_bcast"):
            phases.run(f"profile-sharded-{algo}", profile_run, torch,
                       lambda: eng.run(algo, pg, **profiled[algo]),
                       f"sharded D=1 {algo}")
    finally:
        meshlib.destroy()
    drop_shards(pg)
    del sg
    torch.cuda.empty_cache()
    log(f"[check] sharded D=1 over NCCL == one device at n={pg.n}: states "
        "bitwise (PageRank rtol 1e-5, MSF weight 1e-6), every "
        "msgs_*/per_worker_* equal, the same supersteps, the kernel "
        f"launches of SHARDED_PER_SS a superstep; {total} launches")
    return dict(D=1, launches=total, **row)


def drop_shards(pg):
    """Free the sharded executor's tables cached on ``pg``."""
    for key in [k for k in pg.plan_cache
                if k[0] in ("shard", "device_plans")]:
        del pg.plan_cache[key]


SPLIT_KINDS = ("eg", "mir", "all")


def split_partition(api, planlib, g, M, tau, nb):
    """Phase 3b's split partition of the main path's graph
    (``SPLIT_FACTOR``) on the CPU and its three plans packed at block
    width ``nb`` from its numpy arrays: host work, no card.  Returns (the
    host partition, host seconds)."""
    t0 = time.perf_counter()
    eng_s = api.Engine(backend="pallas", layout="csr", balance="split",
                       split_factor=SPLIT_FACTOR, device="cpu")
    pgs = eng_s.partition(g, M, tau=tau, seed=0)
    for kind in SPLIT_KINDS:
        planlib.get_plan(pgs, kind, nb=nb)
    return pgs, time.perf_counter() - t0


def start_split_partition(np, planlib, g, pg, dev):
    """Save the main path's graph and start ``split_partition_worker`` on
    it in a spawned process: its own interpreter, so the main thread's
    timed runs share no GIL with it.  Returns the call that waits for it
    and gives (the partition's numpy fields, its plans, the worker's
    seconds)."""
    import multiprocessing
    import pickle
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix="split-partition-")
    d = Path(tmp.name)
    np.save(d / "src.npy", g.src)
    np.save(d / "dst.npy", g.dst)
    np.save(d / "weight.npy", g.weight)
    (d / "meta.json").write_text(json.dumps(
        {"n": int(g.n), "M": int(pg.M), "tau": int(pg.tau),
         "nb": int(planlib.default_nb(dev))}))
    proc = multiprocessing.get_context("spawn").Process(
        target=split_partition_worker, args=(str(d),), daemon=True)
    proc.start()

    def wait():
        proc.join()
        if proc.exitcode != 0:
            log((d / "log.txt").read_text()
                if (d / "log.txt").exists() else "")
            fail(f"the split partition's process exited {proc.exitcode}")
        with open(d / "split.pkl", "rb") as f:
            out = pickle.load(f)
        tmp.cleanup()
        return out["fields"], out["plans"], out["seconds"]
    return wait


def split_partition_worker(path):
    """The split partition's process: reads the graph beside it, runs
    ``split_partition`` and pickles the partition's numpy fields and
    plans to ``split.pkl``; its lines go to ``log.txt``."""
    import pickle
    d = Path(path)
    sys.stdout = sys.stderr = open(d / "log.txt", "w", buffering=1)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import api
    from repro_torch.core import plan as planlib
    from repro_torch.graph import structs
    meta = json.loads((d / "meta.json").read_text())
    g = structs.Graph(meta["n"], np.load(d / "src.npy"),
                      np.load(d / "dst.npy"), np.load(d / "weight.npy"))
    pgs, seconds = split_partition(api, planlib, g, meta["M"], meta["tau"],
                                   meta["nb"])
    with open(d / "split.tmp", "wb") as f:
        pickle.dump({"fields": structs.to_numpy(pgs),
                     "plans": dict(pgs.plan_cache), "seconds": seconds}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    (d / "split.tmp").rename(d / "split.pkl")


def split_to_device(structs, fields, plans, dev):
    """The split partition from its numpy ``fields`` with its arrays on
    ``dev`` and its packed ``plans`` carried over (their device copies
    are made at first use, as for any partition)."""
    out = structs.from_numpy(fields, dev)
    out.plan_cache.update(plans)
    return out


def sharded_modes(torch, np, mods, g, pg, runs, algos, ref_fn, dev, phases,
                  split_wait, host_work=None):
    """Phase 3b, continued: the (1, 1) mesh (the hierarchical exchanges
    through subgroups of one rank), the pipeline (``PIPELINE_CHUNKS``
    chunks a join, forced) and a ``balance="split"`` partition of the
    same graph that cuts workers (``SPLIT_FACTOR``), over an NCCL group of
    world size 1, each algorithm once, each held to its one-device run
    (the split partition to its own warm run, made first); the scalar
    kernel's launches counted from 0 before each run and read after it;
    one superstep of Hash-Min and S-V replayed through the kernel and its
    plain version under split and under the pipeline's chunks.  The split
    partition comes from ``split_wait`` (``split_partition``'s host
    result, made in a spawned process from phase 3's oracles on, moved to
    the card here); ``host_work(pgs)`` (host-only, untimed) runs on
    this thread after the wait.  Returns
    (the modes' launches, the two replay rows, the split partition)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.core import exec as exec_mod
    api, kernel = mods[0], mods[5]
    kinds = ("eg", "mir", "all")
    eng_s = api.Engine(backend="pallas", layout="csr", balance="split",
                       split_factor=SPLIT_FACTOR, device=dev)
    fields, plans, split_s = phases.run("split-partition-wait", split_wait)
    pgs = phases.run("split-partition-upload", split_to_device, mods[1],
                     fields, plans, dev)
    del fields, plans
    if host_work is not None:
        host_work(pgs)
    log(f"[sharded] split partition (split_factor {SPLIT_FACTOR}) of the "
        f"n={g.n} graph and its plans: {split_s:.3f} s on the host (no "
        f"card) in a process from phase 3's oracles on, M={pgs.M} -> "
        f"M_phys={pgs.M_phys} physical shards")
    check_cut(pgs, "phase 3b")
    split_runs = {}
    for algo, params in algos:
        p = dict(params)
        if algo == "sssp":
            p["source"] = int(pgs.perm[0])
        if algo == "attr_bcast":
            p["attr"] = 3 * torch.arange(pgs.n_pad, dtype=torch.float32,
                                         device=dev).view(pgs.M, pgs.n_loc)
        # the first run pays the allocator's growth; the second is the
        # steady state, the yardstick
        for tag in ("cold", "warm"):
            res, dev_ms, _ = phases.run(f"split-one-{algo}-{tag}", timed,
                                        torch,
                                        lambda: eng_s.run(algo, pgs, **p))
        log(f"[sharded] split one device {algo}: {res.n_supersteps} "
            f"supersteps, {dev_ms / res.n_supersteps:.3f} ms a superstep "
            "on the device clock (warm)")
        split_runs[algo] = (res, p, dev_ms)
    modes = [("mesh 1x1", pg, dict(devices=(1, 1), balance="hash")),
             ("pipeline", pg, dict(devices=1, balance="hash",
                                   pipeline=True)),
             ("split", pgs, dict(devices=1, balance="split",
                                 split_factor=SPLIT_FACTOR))]
    out, replays = {}, {}
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        for mode, p_g, cfg in modes:
            pipe = cfg.get("pipeline", False)
            eng = api.Engine(backend="pallas", layout="csr", device=dev,
                             **cfg)
            with forced_chunks(exec_mod, pipe):
                sg = phases.run(f"sharded-{mode}-build", exec_mod.shard, p_g,
                                cfg["devices"], kinds, dev, pipeline=pipe)
                log(f"[sharded] {mode} shard build: {sg.build_s:.3f} s on "
                    f"the host; the rank's tables "
                    f"{sg.table_bytes() / 2**30:.3f} GiB on the device")
                if pipe:
                    for algo in ("hashmin", "sv"):
                        check_chunks(sg, algo, f"sharded {mode}")
                # NCCL's communicators of the mode's subgroups form on
                # first use: one superstep of Hash-Min before the timed runs
                eng.run("hashmin", p_g, max_supersteps=1)
                launches = {}
                for algo, params in algos:
                    if mode == "split":
                        one, params, one_ms = split_runs[algo]
                    else:
                        one, _, one_ms = runs[algo]
                    _, launches[algo], _, _ = sharded_run(
                        torch, np, f"sharded {mode} {algo}", eng, p_g, algo,
                        params, one, one_ms, per_ss_of(pipe), kernel,
                        phases)
                out[mode] = launches
                if mode in ("pipeline", "split"):
                    per_ss = per_ss_of(pipe)
                    replays[mode] = phases.run(
                        f"sharded-{mode}-replay", sharded_replay, torch,
                        kernel, ref_fn, eng, p_g,
                        per_ss["hashmin"] + per_ss["sv"], mode)
            drop_shards(p_g)
            del sg
            torch.cuda.empty_cache()
    finally:
        meshlib.destroy()
    log(f"[check] sharded (1, 1) mesh, pipeline ({PIPELINE_CHUNKS} chunks a "
        f"join) and split (M_phys={pgs.M_phys} > M={pgs.M}) over NCCL == "
        f"one device at n={pg.n}: states bitwise (PageRank rtol 1e-5, MSF "
        "weight 1e-6), every msgs_*/per_worker_* equal, the same "
        "supersteps, the kernel launches a superstep of SHARDED_PER_SS "
        f"(PIPELINED_PER_SS under the pipeline): {json.dumps(out)}")
    del split_runs
    return out, replays, pgs


def flat_lanes(np, exec_mod, pg, D, hosts, kinds, nb):
    """The wire lanes a superstep of the flat D-device mesh's static
    exchanges (the plan exchanges of ``kinds`` and the fetch plans), in
    all and those between devices of different hosts when the D devices
    are grouped ``hosts`` to a host block in flat order (what
    ``exchange_volume_report`` counts on the 1-D mesh as its total)."""
    meta, arrays = exec_mod._shard_graph(pg, D, kinds, nb)
    hid = np.arange(D) // (D // hosts)
    off = hid[:, None] != hid[None]
    sent = [arrays[f"plan_{k}_xval"].sum(axis=2) for k in meta["plan_meta"]]
    sent += [(arrays[f"fetch_{f}_send_slot"] >= 0).sum(axis=2)
             for f in meta["fetch_meta"]]
    total = sum(int(x.sum() - np.trace(x)) for x in sent)
    return total, sum(int(x[off].sum()) for x in sent)


def balance_lines(np, exec_mod, pg, pgs, nb):
    """The static load balance of the n=4M graph, read from host tables:
    each device's superstep edge load (Ch_msg + mirror fan-out) under the
    hash partition and the split partition of phase 3b at D = 2, 4 and 8;
    the cross-worker, device and host message fractions and the
    per-superstep exchange volume of the (2, 4) mesh beside the flat D=8
    mesh's lanes that cross the same host boundary (both on the hash
    partition, which is not host-affine: ``graph_run --hosts`` builds a
    host-affine one)."""
    out = {}
    for D in (2, 4, 8):
        for name, p in (("hash", pg), (f"split {SPLIT_FACTOR}", pgs)):
            loads = exec_mod.device_edge_loads(p, D)
            ratio = float(loads.max() / loads.mean())
            out[f"{name.split()[0]}-{D}"] = ratio
            cut = ""
            if p.M_phys > p.M:
                cut = (f", {straddling(p, exec_mod.device_edge_bounds(p, D))}"
                       " cut workers on two ranks")
            log(f"[balance] {name} D={D}: device edge-load max/mean "
                f"{ratio:.4f} (max {int(loads.max())}, mean "
                f"{loads.mean():.1f} edges; M_phys={p.M_phys}{cut})")
    cr = exec_mod.crossness_report(pg, (2, 4))
    log(f"[balance] crossness at (2, 4), hash: {cr['total']} combined "
        f"messages, cross-worker {cr['cross_worker_frac']:.4f}, "
        f"cross-device {cr['cross_device_frac']:.4f}, cross-host "
        f"{cr['cross_host_frac']:.4f}")
    kinds = ("eg", "mir")
    vol = exec_mod.exchange_volume_report(pg, (2, 4), kinds, nb=nb)
    flat_total, flat_cross = flat_lanes(np, exec_mod, pg, 8, 2, kinds, nb)
    log(f"[balance] exchange volume a superstep on the hash partition "
        f"(plan and fetch lanes, nb={nb}): (2, 4) total {vol['total']}, "
        f"intra-host {vol['intra_host']}, cross-host {vol['cross_host']}; "
        f"flat D=8 total {flat_total}, of which between devices 0-3 and "
        f"4-7 {flat_cross} (cross-host, (2, 4) / flat "
        f"{vol['cross_host'] / max(flat_cross, 1):.4f})")
    for name, e in sorted(vol["per_exchange"].items()):
        log(f"[balance]   (2, 4) {name}: intra {e['intra_host']}, cross "
            f"{e['cross_host']}")
    drop_shards(pg)
    drop_shards(pgs)
    return dict(out, cross_host=vol["cross_host"], flat_total=flat_total,
                flat_cross_host=flat_cross)


def sharded_replay(torch, kernel, ref_fn, eng, pg, want_n, tag):
    """One superstep's plan launches of Hash-Min and S-V on the rank,
    recorded and replayed through the kernel and the plain version on the
    same inputs (these launches are not counted); min and max combines
    must agree exactly."""
    seen = []
    launch = kernel.launch

    def record(vals, idx, op, nb):
        seen.append((vals.clone(), idx.clone(), op, nb))
        return launch(vals, idx, op, nb)
    kernel.launch = record
    try:
        for algo in ("hashmin", "sv"):
            eng.run(algo, pg, max_supersteps=1)
    finally:
        kernel.launch = launch
    if len(seen) != want_n:
        fail(f"sharded {tag} replay: {len(seen)} launches in one superstep "
             f"of Hash-Min and S-V, expected {want_n}")
    row = {"replayed": len(seen), "ms": 0.0, "plain_ms": 0.0,
           "max_abs_err": 0.0}
    for vals, idx, op, nb in seen:
        got, ms = event_ms(torch, lambda: launch(vals, idx, op, nb))
        want, plain_ms = event_ms(torch, lambda: ref_fn(vals, idx, op, nb))
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["max_abs_err"] = max(row["max_abs_err"], compare(
            torch, got, want, vals, idx, op, nb, ref_fn))
        log(f"[kernel] sharded {tag} replay: {op} {tuple(vals.shape)} -> "
            f"nb={nb}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if row["max_abs_err"] != 0.0:
        fail(f"sharded {tag} replay: max |kernel - plain| "
             f"{row['max_abs_err']}")
    return row


#: phase 3c's modes: (tag, layout, backend, balance, hosts, devices,
#: pipeline); ``devices`` None is the world size (the 1-D mesh)
MODES_1D = [("1-D", "csr", "pallas", "hash", None, None, False),
            ("1-D", "padded", "dense", "hash", None, None, False)]
MODES_2 = [("split", "csr", "pallas", "split", None, 2, False),
           ("pipeline", "csr", "pallas", "hash", None, 2, True)]
MODES_MESH2 = [("mesh 1x2", "csr", "pallas", "hash", None, (1, 2), False),
               ("mesh 2x1", "csr", "pallas", "hash", None, (2, 1), False)]
MODES_MESH4 = [("mesh 2x2", "csr", "pallas", "hash", 2, (2, 2), False)]


def sharded_spawns(count: int):
    """Phase 3c's spawns, ``[(backend, world size, modes)]``: NCCL with a
    card a rank where the machine has two or more (the 1-D modes on the
    largest of 2, 4, 8 it allows; the (1, 2) and (2, 1) meshes, split and
    the pipeline on 2; the (2, 2) mesh on 4 where there are four), else
    gloo with every rank on cuda:0 (2 ranks, and 4 on the (2, 2) mesh)."""
    if count < 2:
        return [("gloo", 2, MODES_1D + MODES_2), ("gloo", 4, MODES_MESH4)]
    D = max(d for d in (2, 4, 8) if d <= count)
    spawns = {D: list(MODES_1D)}
    spawns.setdefault(2, []).extend(MODES_MESH2 + MODES_2)
    if count >= 4:
        spawns.setdefault(4, []).extend(MODES_MESH4)
    return [("nccl", d, m) for d, m in sorted(spawns.items())]


def sharded_many(torch, args):
    """Phase 3c: ranks on the n=200k graph of phase 5, M=8, in the
    spawns of ``sharded_spawns`` (gloo stages each CUDA collective through
    the host, so those times are not the executor's).  Rank 0 holds every
    run to the one-device run on its card."""
    import tempfile
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    count = torch.cuda.device_count()
    summary = []
    for backend, D, modes in sharded_spawns(count):
        log(f"[sharded] D={D}: {backend} over {count} card(s)"
            + ("; every rank on cuda:0, every collective staged through "
               "the host by gloo" if backend == "gloo" else ", one a rank")
            + f"; modes {sorted({m[0] for m in modes})}")
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "rank0.json"
            spawn_ranks(sharded_rank, (D, backend, rendezvous(tmp),
                                       args.seed, str(out), modes), D,
                        SHARDED_JOIN_S)
            summary += json.loads(out.read_text())
    log(f"[check] sharded ranks == one device at n={PARITY_N}, "
        f"M={SHARDED_M}: {len(summary)} runs (six algorithms in each "
        "mode, the GCN in each csr/pallas mode), states bitwise (PageRank "
        "rtol 1e-5, MSF weight 1e-6), every msgs_*/per_worker_* equal, "
        "the same supersteps, the kernel launches of SHARDED_PER_SS "
        "(PIPELINED_PER_SS under the pipeline)")
    return summary


def sharded_rank(rank, D, backend, init_method, seed, out_path, modes):
    """One rank of phase 3c (spawned): joins the group, builds the graph
    from ``seed``, runs the six algorithms sharded in each mode; rank 0
    also runs each on one device and holds the two to the gates of phase
    3b."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.core import exec as exec_mod
    from repro_torch.graph import generators as gen
    from repro_torch.graph import structs
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.train.gcn import normalize_adjacency
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=D,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    where = ("staged through the host by gloo" if backend == "gloo"
             else "NCCL")
    summary = []
    try:
        g = normalize_adjacency(gen.powerlaw(
            PARITY_N, avg_deg=8, seed=seed, weighted=True).symmetrized())
        tau = cost_model.choose_tau(g.out_degrees(), SHARDED_M)
        parts = {}
        for tag, layout, be, balance, hosts, devices, pipe in modes:
            devices = devices or D
            part = dict(layout=layout, balance=balance, hosts=hosts)
            if balance == "split":
                part["split_factor"] = SPLIT_FACTOR
            eng = api.Engine(backend=be, devices=devices, pipeline=pipe,
                             device=dev, **part)
            key = tuple(part.items())
            if key not in parts:
                parts[key] = eng.partition(g, SHARDED_M, tau=tau, seed=seed)
            pg = parts[key]
            if rank == 0 and balance == "split":
                check_cut(pg, f"phase 3c D={D} {tag}")
                log(f"[sharded] D={D} {tag}: split_factor {SPLIT_FACTOR}, "
                    f"M={pg.M} -> M_phys={pg.M_phys}, "
                    f"{straddling(pg, exec_mod.device_edge_bounds(pg, D))} "
                    "cut workers with shards on two ranks")
            if rank == 0:
                one = api.Engine(backend=be, device=dev, **part)
                pg_one = structs.from_numpy(structs.to_numpy(pg), device=dev)
            attr = 3 * torch.arange(pg.n_pad, dtype=torch.float32).view(
                pg.M, pg.n_loc)
            for algo, params in [
                    ("hashmin", {}), ("pagerank", {"n_iters": 30, "tol": 0.0}),
                    ("sssp", {"source": int(pg.perm[0])}), ("sv", {}),
                    ("msf", {}), ("attr_bcast", {"attr": attr})]:
                counter = kernel.segment_combine_blocks
                counter.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.run(algo, pg, **params)
                torch.cuda.synchronize()
                host_s = time.perf_counter() - t0
                launches = counter.launches
                if rank != 0:
                    continue
                name = f"sharded D={D} {tag} {layout}/{be} {algo}"
                if pipe:
                    check_chunks(exec_mod.shard(pg, devices, (), dev,
                                                pipeline=True), algo, name)
                if algo == "attr_bcast":
                    params = {"attr": attr.to(dev)}
                sharded_gate(torch, np, name, algo,
                             one.run(algo, pg_one, **params), res)
                n = res.n_supersteps
                per_ss = per_ss_of(pipe)[algo] if be == "pallas" else 0
                if launches != per_ss * n:
                    fail(f"{name}: {launches} kernel launches in {n} "
                         f"supersteps, expected {per_ss * n}: the path did "
                         "not go through the kernel")
                reads = res.sharded["host_reads"] + (res.jump_reads or 0)
                log(f"[sharded] {name}: {n} supersteps in {host_s:.3f} s on "
                    f"the host clock ({where}); {launches} kernel launches; "
                    f"{reads / n:.2f} host reads a superstep; "
                    f"{rounds_text(res.sharded)}")
                summary.append({"mode": tag, "layout": layout,
                                "backend": be, "algo": algo,
                                "supersteps": n, "host_s": host_s,
                                "launches": launches,
                                "rounds": res.sharded["rounds"],
                                "inner_rounds": res.sharded["inner_rounds"]})
            if be == "pallas" and layout == "csr":
                summary += sharded_rank_gcn(
                    torch, np, rank, D, tag, eng, pg, devices, pipe,
                    one if rank == 0 else None,
                    pg_one if rank == 0 else None, kernel, dev, where)
        if rank == 0:
            Path(out_path).write_text(json.dumps(summary))
    finally:
        meshlib.destroy()


# ---------------------------------------------------------------------------
# phases 3b and 3c, continued: the sharded GCN
# ---------------------------------------------------------------------------

def gcn_readings(torch, np, name, sh, runs, p0):
    """The gates' readings of a sharded GCN run ``sh`` against the
    one-device run from the same params ``p0``: ``runs`` holds two
    one-device runs (``(one, again)``) of the same epochs.  Returns
    whether the loss history is within GCN_LOSS_RTOL / GCN_LOSS_ATOL of
    ``one``, and for each trained leaf (failing on a leaf that is not
    finite) |change - one-device change| / |one-device change|, the same
    for the two one-device runs, and the limit of the first (PARAM_RTOL
    plus the float32 rounding of the values)."""
    one, again = runs
    loss_ok = (len(sh.history) == len(one.history)
               and np.allclose(sh.history, one.history, rtol=GCN_LOSS_RTOL,
                               atol=GCN_LOSS_ATOL))
    norm = torch.linalg.vector_norm
    errs = {}
    for k, v in one.state.items():
        s = sh.state[k].to(v.device)
        if s.shape != v.shape or not bool(torch.isfinite(s).all()):
            fail(f"{name}: the trained {k} is {tuple(s.shape)}, finite "
                 f"{bool(torch.isfinite(s).all())}")
        diff = float(norm((s - v).double()))
        spread = float(norm((again.state[k].to(v.device) - v).double()))
        step = max(float(norm((v - p0[k].to(v.device)).double())), 1e-30)
        lim = PARAM_RTOL + U32 * float(norm(v.double())) / step
        errs[k] = (diff / step, spread / step, lim)
    return loss_ok, errs


def gcn_gate(torch, np, name, sh, runs, p0):
    """Fail unless the sharded GCN run ``sh`` equals the one-device run
    from the same params ``p0`` (``gcn_readings``): the loss history
    within its tolerance, every trained leaf finite and within its
    limit.  Returns the leaves' readings."""
    loss_ok, errs = gcn_readings(torch, np, name, sh, runs, p0)
    if not loss_ok:
        fail(f"{name}: loss {sh.history} vs one device {runs[0].history}")
    for k, (err, spread, lim) in errs.items():
        if err > lim:
            fail(f"{name}: the trained {k} differs from one device by "
                 f"{err:.3g} of its change (limit {lim:.3g}); two "
                 f"one-device runs differ by {spread:.3g}")
    return errs


def gcn_control(torch, np, planlib, eng, pg, p0, runs):
    """The params gate's control: GCN_SHARDED_EPOCHS epochs of the sharded
    GCN with the run's first vector combine dropped (its rows' lanes never
    reach their blocks; one of the run's hundreds of launches), held to
    the one-device runs ``runs`` of those epochs.  Fails unless the
    params gate rejects it.  Returns its readings."""
    combine = planlib._combine_rows
    left = [1]

    def dropped(packed, row_local, op, nb):
        out = combine(packed, row_local, op, nb)
        if packed.dim() == 3 and left[0]:
            left[0] = 0
            if op != "sum":
                fail(f"the control drops a sum combine, not a {op} one")
            out = torch.zeros_like(out)
        return out
    planlib._combine_rows = dropped
    try:
        res = eng.run("gcn", pg, epochs=GCN_SHARDED_EPOCHS, params=p0, **GCN)
    finally:
        planlib._combine_rows = combine
    if left[0]:
        fail("the control dropped no vector combine")
    loss_ok, errs = gcn_readings(torch, np, "control", res, runs, p0)
    if all(err <= lim for err, _, lim in errs.values()):
        fail("the params gate passes a GCN run with a vector combine "
             "dropped: " + gate_text(errs))
    log(f"[check] the params gate's control, one vector combine of "
        f"{GCN_SHARDED_EPOCHS} epochs dropped: rejected (loss gate "
        f"{'passed' if loss_ok else 'failed'}, loss "
        f"{' -> '.join(f'{x:.5f}' for x in res.history)}); "
        + gate_text(errs))
    return {k: err for k, (err, _, _) in errs.items()}


def gate_text(errs) -> str:
    return ("trained leaf vs one device |d change|/|change| (two one-device "
            "runs) " + ", ".join(f"{k} {a:.2g} ({b:.2g})"
                                 for k, (a, b, _) in errs.items()))


def relayout(torch, params, pg_from, pg_to):
    """GCN params of ``pg_from`` in the vertex layout of ``pg_to``: each
    original vertex's embedding row moves to its slot there."""
    emb = params["emb"]
    F = emb.shape[-1]
    src = torch.as_tensor(pg_from.perm, device=emb.device).long()
    dst = torch.as_tensor(pg_to.perm, device=emb.device).long()
    out = torch.zeros((pg_to.n_pad, F), dtype=emb.dtype, device=emb.device)
    out[dst] = emb.reshape(-1, F)[src]
    return dict(params, emb=out.view(pg_to.M, pg_to.n_loc, F))


def gspmm_sharded_check(torch, np, gspmm, kernel, pg, dev):
    """One ``gspmm_sharded("u_mul_e_sum")`` call at F=64 on the rank of
    world size 1 against ``gspmm_stats`` on one device: stats equal,
    integer for integer; values within 1e-5 of |A_hat|^T |X| (summation
    order).  Returns the call's (scalar, vector) launches."""
    x = torch.randn((pg.M, pg.n_loc, GCN["hidden"]), device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0
    got, stats = gspmm.gspmm_sharded(pg, "u_mul_e_sum", x, devices=1,
                                     backend="pallas", device=dev)
    launches = (counter.launches, counter.launches_vec)
    want, wstats = gspmm.gspmm_stats(pg, "u_mul_e_sum", x, backend="pallas")
    assert_stats_equal(np, "gspmm_sharded", wstats, stats,
                       between="the sharded and one-device joins")
    mag, _ = gspmm.gspmm_stats(pg, "u_mul_e_sum", x.abs(), backend="pallas")
    worst = float(((got - want).abs() / mag.clamp(min=1e-30)).max())
    if not worst <= 1e-5:
        fail(f"gspmm_sharded: |sharded - one device| / (|A|^T|X|) {worst:.3g}"
             " (limit 1e-5)")
    log(f"[check] gspmm_sharded(u_mul_e_sum) at F={x.shape[-1]}, D=1 == "
        f"one device: every msgs_*/per_worker_* equal (msgs_total "
        f"{int(stats['msgs_total'])}), values max |err|/(|A|^T|X|) "
        f"{worst:.3g} (limit 1e-5); {launches[1]} vector and {launches[0]}"
        " scalar launches")
    return launches


def sharded_gcn(torch, np, mods, pg, pgs, params0, runs4, one_ms, one_added,
                one_vec, dev, phases):
    """Phase 3b, GCN: ``Engine(devices=1).run("gcn")`` over an NCCL group
    of world size 1 on the main path's partition, GCN_EPOCHS epochs on the
    1-D mesh, GCN_SHARDED_EPOCHS each on the (1, 1) mesh, under the
    pipeline (PIPELINE_CHUNKS chunks, forced) and on the split partition
    of phase 3b; each from the one-device run's params (the split
    partition's in its layout), held by ``gcn_gate`` to two one-device
    runs of its partition and epochs (``runs4``: phase 4's run and its
    replay), with the vector kernel's launches counted from 0 before each
    run and read after it: SHARDED_VEC_PER_EPOCH an epoch on the hash
    partition, SPLIT_VEC_PER_EPOCH on the split one (which its one-device
    run must launch too), and no scalar launch (a training join keeps no
    message count).  Device ms are set beside a warm one-device run's,
    the memory a run adds beside what phase 4's one-device run added.
    After the 1-D run, the params gate's control (``gcn_control``) and
    one ``gspmm_sharded`` call.  Returns the launches, times and memory
    by mode."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.core import exec as exec_mod
    from repro_torch.core import gspmm
    api, kernel = mods[0], mods[5]
    counter = kernel.segment_combine_blocks
    E = GCN_SHARDED_EPOCHS
    eng1 = api.Engine(backend="pallas", layout="csr", balance="hash",
                      device=dev)
    runs2 = tuple(phases.run(f"gcn-one-{E}-{i}", timed, torch,
                             lambda: eng1.run("gcn", pg, epochs=E,
                                              params=params0, **GCN))
                  for i in (0, 1))
    warm_ms = runs2[1][1] / E
    split = dict(balance="split", split_factor=SPLIT_FACTOR)
    ps0 = relayout(torch, params0, pg, pgs)
    eng_s = api.Engine(backend="pallas", layout="csr", device=dev, **split)
    runs_s = []
    for i in (0, 1):
        counter.launches_vec = 0
        runs_s.append(phases.run(f"gcn-split-one-{i}", timed, torch,
                                 lambda: eng_s.run("gcn", pgs, epochs=E,
                                                   params=ps0, **GCN)))
    split_per_epoch = counter.launches_vec // E
    split_ms = runs_s[1][1] / E
    log(f"[gcn] one device, warm, {E} epochs: {warm_ms:.3f} ms an epoch "
        f"(phase 4's first run {one_ms / GCN_EPOCHS:.3f}); split "
        f"partition: {split_ms:.3f} ms an epoch, {split_per_epoch} vector "
        "launches an epoch; loss "
        f"{' -> '.join(f'{x:.5f}' for x in runs_s[0][0].history)}")
    # the constants hold at the default size; elsewhere the one-device
    # runs' counts stand in
    want, want_split = one_vec // GCN_EPOCHS, split_per_epoch
    if (pg.n, pg.M) == GCN_SIZE:
        want, want_split = SHARDED_VEC_PER_EPOCH, SPLIT_VEC_PER_EPOCH
        if split_per_epoch != want_split:
            fail(f"the one-device GCN on the split partition launched "
                 f"{split_per_epoch} vector combines an epoch, the design "
                 f"{want_split}")
    pair2 = (runs2[0][0], runs2[1][0])
    modes = [("1-D", pg, dict(devices=1, balance="hash"), GCN_EPOCHS,
              params0, runs4, warm_ms, want),
             ("mesh 1x1", pg, dict(devices=(1, 1), balance="hash"), E,
              params0, pair2, warm_ms, want),
             ("pipeline", pg, dict(devices=1, balance="hash",
                                   pipeline=True), E, params0, pair2,
              warm_ms, want),
             ("split", pgs, dict(devices=1, **split), E, ps0,
              (runs_s[0][0], runs_s[1][0]), split_ms, want_split)]
    out = {}
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        for mode, p_g, cfg, epochs, p0, yard, yard_ms, per_epoch in modes:
            name = f"sharded {mode} gcn"
            pipe = cfg.get("pipeline", False)
            eng = api.Engine(backend="pallas", layout="csr", device=dev,
                             **cfg)
            with forced_chunks(exec_mod, pipe):
                sg = phases.run(f"sharded-gcn-{mode}-build", exec_mod.shard,
                                p_g, cfg["devices"], ("eg", "mir"), dev,
                                pipeline=pipe)
                if pipe and sg.plans["eg"].n_chunks != PIPELINE_CHUNKS:
                    fail(f"{name}: the eg plan has {sg.plans['eg'].n_chunks}"
                         f" pipeline chunks, expected {PIPELINE_CHUNKS}")
                # NCCL's communicators form on first use: one epoch first
                eng.run("gcn", p_g, epochs=1, params=p0, **GCN)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                counter.launches = counter.launches_vec = 0
                res, dev_ms, host_s = phases.run(
                    name, timed, torch, lambda: eng.run(
                        "gcn", p_g, epochs=epochs, params=p0, **GCN))
                scalar, vec = counter.launches, counter.launches_vec
                added = torch.cuda.max_memory_allocated() - held
                errs = gcn_gate(torch, np, name, res, yard, p0)
                if vec != per_epoch * epochs or scalar:
                    fail(f"{name}: {vec} vector and {scalar} scalar kernel "
                         f"launches in {epochs} epochs, expected "
                         f"{per_epoch} vector launches an epoch and no "
                         "scalar one: the path did not go through the "
                         "kernel")
                log(f"[sharded] {name}: {epochs} epochs, "
                    f"{dev_ms / epochs:.3f} ms an epoch on the device clock "
                    f"(one device, warm: {yard_ms:.3f}), {host_s:.3f} s "
                    f"host; {vec} vector launches ({per_epoch} an epoch), "
                    f"{scalar} scalar; the run added "
                    f"{added / 2**30:.2f} GiB to the device memory it held "
                    f"(one device {one_added / 2**30:.2f}), beside the "
                    f"rank's tables {sg.table_bytes() / 2**30:.3f} GiB; "
                    f"host reads {res.sharded['host_reads']}; loss "
                    f"{' -> '.join(f'{x:.5f}' for x in res.history)}; "
                    + gate_text(errs))
                out[mode] = {"epochs": epochs, "launches": vec,
                             "ms_epoch": dev_ms / epochs,
                             "one_device_ms_epoch": yard_ms,
                             "added_gib": added / 2**30,
                             "one_device_added_gib": one_added / 2**30,
                             "table_gib": sg.table_bytes() / 2**30}
                if mode == "1-D":
                    phases.run("profile-sharded-gcn", profile_run, torch,
                               lambda: eng.run("gcn", p_g, epochs=1,
                                               params=p0, **GCN),
                               "sharded D=1 gcn", unit="epochs")
                    out["gspmm_sharded"] = phases.run(
                        "gspmm-sharded", gspmm_sharded_check, torch, np,
                        gspmm, kernel, p_g, dev)
                    out["control"] = phases.run(
                        "gcn-control", gcn_control, torch, np, mods[4], eng,
                        p_g, p0, pair2)
            del sg, res
            drop_shards(p_g)
            torch.cuda.empty_cache()
    finally:
        meshlib.destroy()
    log(f"[check] sharded GCN over NCCL == one device at n={pg.n}: loss "
        f"within rtol {GCN_LOSS_RTOL}, atol {GCN_LOSS_ATOL}; trained params "
        f"within PARAM_RTOL {PARAM_RTOL} of the change; vector launches "
        f"{want} an epoch (split {want_split}): {json.dumps(out)}")
    return out


def sharded_rank_gcn(torch, np, rank, D, tag, eng, pg, devices, pipe, one,
                     pg_one, kernel, dev, where):
    """Phase 3c's GCN in one mode: GCN_SHARDED_EPOCHS epochs on the ranks
    from the same numpy-drawn params; rank 0 holds the run to two
    one-device runs on its card (``gcn_gate``) and to at least one vector
    launch a join, and returns its summary entry."""
    from repro_torch.core import exec as exec_mod
    from repro_torch.train.gcn import init_gcn_params
    E = GCN_SHARDED_EPOCHS
    dims = {k: GCN[k] for k in ("feat_dim", "hidden", "n_classes")}
    p0 = init_gcn_params(pg, **dims)
    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run("gcn", pg, epochs=E, params=p0, **GCN)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    vec, scalar = counter.launches_vec, counter.launches
    if rank != 0:
        return []
    name = f"sharded D={D} {tag} gcn"
    if pipe:
        sg = exec_mod.shard(pg, devices, (), dev, pipeline=True)
        if sg.plans["eg"].n_chunks < 2:
            fail(f"{name}: the eg plan has {sg.plans['eg'].n_chunks} "
                 "pipeline chunk")
    p_dev = {k: v.to(dev) for k, v in p0.items()}
    pair = tuple(one.run("gcn", pg_one, epochs=E, params=p_dev, **GCN)
                 for _ in range(2))
    errs = gcn_gate(torch, np, name, res, pair, p_dev)
    if vec < 4 * E or scalar:
        fail(f"{name}: {vec} vector and {scalar} scalar launches on rank 0 "
             f"in {E} epochs of 4 joins: the path did not go through the "
             "kernel")
    log(f"[sharded] {name}: {E} epochs in {host_s:.3f} s on the host clock "
        f"({where}); {vec} vector launches on rank 0; loss "
        f"{' -> '.join(f'{x:.5f}' for x in res.history)}; "
        + gate_text(errs))
    return [{"mode": tag, "layout": "csr", "backend": "pallas",
             "algo": "gcn", "epochs": E, "host_s": host_s,
             "launches": vec, "rounds": res.sharded["rounds"],
             "inner_rounds": res.sharded["inner_rounds"]}]


# ---------------------------------------------------------------------------
# phase 4: GCN training at full width, and its oracles
# ---------------------------------------------------------------------------

def within_sum_bound(np, name, got, want, mag, deg, factor=None):
    """Fail unless |got - want| <= factor * |A|^T|X| per entry; ``factor``
    defaults to the summation bound (deg+3)*2^-24 of each row.  Returns the
    largest |err| / |A|^T|X| seen."""
    err = np.abs(got - want)
    lim = (factor if factor is not None else (deg[:, None] + 3.0) * U32) * mag
    bad = err > lim
    if bad.any():
        i = np.argwhere(bad)[0]
        fail(f"{name}: {got[tuple(i)]} vs {want[tuple(i)]} at {tuple(i)}, "
             f"beyond {lim[tuple(i)]:.3g}")
    return float(np.max(err / np.maximum(mag, 1e-30)))


def gcn_path(torch, np, args, dev, phases, g, A, pg):
    """The GCN slice's main path on the algorithms' partition."""
    from repro_torch import api
    from repro_torch.core import gspmm
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.train.gcn import init_gcn_params

    widths = (GCN["feat_dim"], GCN["hidden"])
    chunks = {(k, F): planlib.vec_chunks(planlib.get_plan(pg, k), F)
              for k in ("eg", "mir") for F in widths}
    per_epoch = 2 * sum(chunks.values())      # forward + backward joins
    log(f"[gcn] vector chunks a join: {chunks}; {per_epoch} launches an "
        "epoch expected")
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    counter = kernel.segment_combine_blocks
    # the random init (numpy, 128M normals at n=4M) is host set-up: made
    # before the clock starts and handed to the run
    dims = {k: GCN[k] for k in ("feat_dim", "hidden", "n_classes")}
    params0 = phases.run("gcn-init", init_gcn_params, pg, **dims)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    counter.launches = counter.launches_vec = 0   # the path starts here
    res, dev_ms, host_s = phases.run(
        "gcn", timed, torch, lambda: eng.run(
            "gcn", pg, epochs=GCN_EPOCHS, params=params0, **GCN))
    scalar, vec = counter.launches, counter.launches_vec  # ... ends here
    peak = torch.cuda.max_memory_allocated()
    losses = res.history
    log(f"[run] gcn: {GCN_EPOCHS} epochs, {dev_ms:.3f} ms on the device "
        f"clock ({dev_ms / GCN_EPOCHS:.3f} ms an epoch), {host_s:.3f} s "
        f"host; {vec} vector and {scalar} scalar kernel launches; peak "
        f"device memory {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} held "
        f"before the run; loss {' -> '.join(f'{x:.5f}' for x in losses)}")
    if vec != per_epoch * GCN_EPOCHS:
        fail(f"gcn: {vec} vector kernel launches in {GCN_EPOCHS} epochs, "
             f"expected {per_epoch} an epoch: the path did not go through "
             "the kernel")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"gcn: the loss did not fall: {losses}")
    for k, v in res.state.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"gcn: non-finite values in the trained {k}")
    inputs, again = phases.run("gcn-replay", join_inputs, torch, eng, pg,
                               params0)
    phases.run("gcn-stats-cost", stats_cost, torch, np, gspmm, pg, dev)

    # the first layer's join and its gradient against scipy in float64
    def join_and_grad():
        x = params0["emb"].clone().requires_grad_(True)
        out = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")(x)
        cot = torch.randn(out.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
        (grad,) = torch.autograd.grad(torch.sum(out * cot), [x])
        torch.cuda.synchronize()
        return {k: t.detach().reshape(pg.n_pad, -1).cpu().numpy()[pg.perm]
                for k, t in (("x", x), ("out", out), ("cot", cot),
                             ("grad", grad))}
    host = phases.run("gcn-join", join_and_grad)
    host.update(phases.run("gcn-step-on-card", step_on_card, torch, np, eng,
                           pg, params0))
    # the float64 scipy oracles of the join, its gradient and the step run
    # in a process of their own, beside the later device phases
    oracles = phases.run("gcn-oracles-start", start_gcn_oracles, np, g, A,
                         host, res.history[0])
    del host
    phases.run("profile-gcn", profile_run, torch,
               lambda: eng.run("gcn", pg, epochs=1, params=res.state, **GCN),
               "gcn", unit="epochs")
    return (vec, peak, inputs, params0, (res, again), dev_ms, peak - held,
            oracles)


def gcn_join_oracles(np, A, deg_in, deg_out, x, out, cot, grad):
    """The first layer's join and its gradient against scipy in float64:
    products summed into each row, its in-edges (A^T X) and out-edges
    (A G).  Returns (errors, At, z1 = A^T x, z1's float32 error bound)."""
    At = A.T.tocsr()
    z1 = At @ x
    mag = At @ np.abs(x)
    e1 = within_sum_bound(np, "u_mul_e_sum(emb) vs scipy A^T X", out, z1,
                          mag, deg_in)
    # the summation-order bound of the float32 join, per entry
    z1_err = (deg_in[:, None] + 3.0) * U32 * mag
    e2 = within_sum_bound(np, "join gradient vs scipy A G", grad, A @ cot,
                          A @ np.abs(cot), deg_out)
    log(f"[check] gcn: u_mul_e_sum(emb) vs scipy A_hat^T X max "
        f"|err|/(|A|^T|X|) {e1:.3g}; gradient vs scipy A_hat G {e2:.3g} "
        "(bound (deg+3)*2^-24 per row)")
    return At, z1, z1_err


GCN_ORACLE_TIMEOUT_S = 900
GCN_ORACLE_ARRAYS = ("indptr", "indices", "data", "deg_in", "deg_out", "x",
                     "out", "cot", "grad", "labels", "relu_on", "W1", "b1",
                     "W2", "b2", "g_emb", "g_W1", "g_b1", "g_W2", "g_b2",
                     "s_emb", "s_W1", "s_b1", "s_W2", "s_b2")


class GcnOracles:
    """The GCN's float64 oracles running in a spawned process
    (``gcn_oracle_worker``) on arrays saved in a fresh temporary
    directory; ``finish`` waits for it, prints its lines and fails the
    phase if it failed."""

    def __init__(self, tmp, proc):
        self.tmp, self.proc = tmp, proc

    def finish(self):
        t0 = time.perf_counter()
        self.proc.join(GCN_ORACLE_TIMEOUT_S)
        wait = time.perf_counter() - t0
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()
        lines = (Path(self.tmp.name) / "log.txt").read_text().splitlines()
        code = self.proc.exitcode
        self.tmp.cleanup()
        for line in lines:
            log(line)
        log(f"[gcn] the float64 oracles' process ended with code {code} "
            f"(waited {wait:.3f} s for it)")
        if code != 0:
            fail(f"the GCN's float64 oracles failed (exit code {code}): "
                 + (lines[-1] if lines else "no output"))


def start_gcn_oracles(np, g, A, host, first_loss):
    """Save what the oracles need (the adjacency, the degrees, the card's
    join and gradient, the params, the card's relu, gradients and stepped
    params, all in the original vertex order) and start
    ``gcn_oracle_worker`` on them in a spawned process."""
    import multiprocessing
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix="gcn-oracles-")
    d = Path(tmp.name)
    arrays = dict(host, indptr=A.indptr, indices=A.indices, data=A.data,
                  deg_in=np.bincount(g.dst, minlength=g.n),
                  deg_out=np.bincount(g.src, minlength=g.n))
    for k in GCN_ORACLE_ARRAYS:
        np.save(d / f"{k}.npy", arrays[k])
    (d / "meta.json").write_text(json.dumps(
        {"n": int(g.n), "first_loss": float(first_loss)}))
    proc = multiprocessing.get_context("spawn").Process(
        target=gcn_oracle_worker, args=(str(d),), daemon=True)
    proc.start()
    return GcnOracles(tmp, proc)


def gcn_oracle_worker(path):
    """The GCN oracles' process: the join and gradient against scipy
    (``gcn_join_oracles``), then the step (``step_against_oracle``); its
    lines go to ``log.txt`` beside the arrays."""
    d = Path(path)
    sys.stdout = sys.stderr = open(d / "log.txt", "w", buffering=1)
    import numpy as np
    import scipy.sparse as sp
    meta = json.loads((d / "meta.json").read_text())
    a = {k: np.load(d / f"{k}.npy") for k in GCN_ORACLE_ARRAYS}
    n = meta["n"]
    A = sp.csr_matrix((a["data"], a["indices"], a["indptr"]), shape=(n, n))
    f64 = {k: a[k].astype(np.float64) for k in ("x", "out", "cot", "grad")}
    At, z1, z1_err = gcn_join_oracles(
        np, A, a["deg_in"].astype(np.float64),
        a["deg_out"].astype(np.float64), f64["x"], f64["out"], f64["cot"],
        f64["grad"])
    del f64["out"], f64["cot"], f64["grad"]
    p0 = {"emb": f64["x"]}
    p0.update({k: a[k].astype(np.float64) for k in ("W1", "b1", "W2", "b2")})
    step_against_oracle(np, A, At, z1, z1_err, p0, a, meta["first_loss"])


def stats_cost(torch, np, gspmm, pg, dev, reps: int = 3):
    """Device ms of one u_mul_e_sum join at each GCN width without the
    message accounting (the training join, ``gspmm_join``) and with it
    (``gspmm_stats``), alternated ``reps`` times after a warm-up of each:
    what skipping the accounting saves an epoch (4 joins)."""
    gen = torch.Generator(dev).manual_seed(3)
    join = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")
    saving = 0.0
    with torch.no_grad():
        for F in (GCN["feat_dim"], GCN["hidden"]):
            x = torch.randn((pg.M, pg.n_loc, F), generator=gen, device=dev)
            calls = {"without": lambda: join(x),
                     "with": lambda: gspmm.gspmm_stats(
                         pg, "u_mul_e_sum", x, backend="pallas")}
            ms = {k: [] for k in calls}
            for fn in calls.values():
                fn()
            for _ in range(reps):
                for k, fn in calls.items():
                    ms[k].append(event_ms(torch, fn)[1])
            med = {k: float(np.median(v)) for k, v in ms.items()}
            saving += 2 * (med["with"] - med["without"])
            log(f"[gcn] one join at F={F}: without the message accounting "
                f"{med['without']:.3f} ms {ms['without']}, with it "
                f"{med['with']:.3f} ms {ms['with']}")
    log(f"[gcn] skipping the message accounting saves {saving:.3f} ms an "
        "epoch (2 joins at each width, medians)")


def gcn_step_oracle(np, A, At, z1, z1_err, p, labels, relu_on):
    """One full-batch step of the 2-layer GCN in float64 with scipy and
    numpy, independent of the port: the mean cross-entropy over the
    labelled rows (every vertex), each leaf's gradient, the global-norm
    clip and AdamW's first step, where m/(1-b1) = g and v/(1-b2) = g^2,
    so the step is -lr * g / (|g| + eps).  ``z1`` is ``A^T emb`` in the
    original vertex order and ``z1_err`` bounds the float32 join's error
    in it.

    The relu's derivative is the card's own (``relu_on``): a float32
    pre-activation within round-off of 0 may fall on either side of it,
    and such a flip moves a gradient by far more than summation order
    does.  Every flip must lie within ``band`` of 0: the join's bound
    carried through ``@ W1``, plus the product's own rounding.  Returns
    (loss, grads, step, grad norm, flips, pre-activations in the band)."""
    n = z1.shape[0]
    abs_w1 = np.abs(p["W1"])
    p1 = z1 @ p["W1"] + p["b1"]
    band = z1_err @ abs_w1 + (z1.shape[1] + 2) * U32 * (
        np.abs(z1) @ abs_w1 + np.abs(p["b1"]))
    in_band = np.abs(p1) <= band
    flips = (p1 > 0) != relu_on
    if (flips & ~in_band).any():
        v, j = np.argwhere(flips & ~in_band)[0]
        fail(f"gcn: the card's relu of pre-activation ({v}, {j}) = "
             f"{p1[v, j]:.6g} flipped beyond its round-off {band[v, j]:.3g}")
    z2 = At @ np.maximum(p1, 0.0)
    logits = z2 @ p["W2"] + p["b2"]
    logits -= logits.max(axis=1, keepdims=True)
    prob = np.exp(logits)
    prob /= prob.sum(axis=1, keepdims=True)
    rows = np.arange(n)
    loss = -np.mean(np.log(prob[rows, labels]))
    d_logits = prob
    d_logits[rows, labels] -= 1.0
    d_logits /= n
    grads = {"W2": z2.T @ d_logits, "b2": d_logits.sum(axis=0)}
    del z2, p1, band
    d_p1 = (A @ (d_logits @ p["W2"].T)) * relu_on
    grads["W1"] = z1.T @ d_p1
    grads["b1"] = d_p1.sum(axis=0)
    grads["emb"] = A @ (d_p1 @ p["W1"].T)
    gnorm = float(np.sqrt(sum(np.sum(v * v) for v in grads.values())))
    scale = min(1.0, GCN_CLIP / max(gnorm, 1e-9))
    step = {k: -GCN["lr"] * (scale * v) / (np.abs(scale * v) + ADAM_EPS)
            for k, v in grads.items()}
    return (loss, grads, step, gnorm, int(flips.sum()),
            int(in_band.sum()))


def step_on_card(torch, np, eng, pg, params0):
    """The assembled training step on the card, the half of the step check
    that needs it: each leaf's gradient of the mean loss (autograd through
    both joins, relu and the ``@ W`` products; the forward is
    ``gcn_forward``'s, written out to read the relu, and held to it within
    LOSS_RTOL here), the relu's side of every pre-activation, and the
    params after one ``Engine.run("gcn", epochs=1)`` (clip and AdamW).
    Returns them on the host in the original vertex order, for
    ``step_against_oracle``."""
    from repro_torch.core import gspmm
    from repro_torch.models.embedding import softmax_xent
    from repro_torch.train.gcn import gcn_forward, gcn_labels

    def host(t):
        t = t.detach().cpu().numpy()
        return t.reshape(pg.n_pad, -1)[pg.perm] if t.ndim == 3 else t
    labels, mask = gcn_labels(pg, GCN["n_classes"])
    join = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")
    p = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    p1 = join(p["emb"]) @ p["W1"] + p["b1"]
    logits = join(torch.relu(p1)) @ p["W2"] + p["b2"]
    loss = softmax_xent(logits, labels, mask)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
        ref = gcn_forward(pg, params0, backend="pallas")
        dev_rel = float(torch.linalg.vector_norm(ref - logits)
                        / torch.linalg.vector_norm(logits))
    if not dev_rel <= LOSS_RTOL:
        fail(f"gcn: the written-out forward differs from gcn_forward by "
             f"{dev_rel:.3g}")
    stepped = eng.run("gcn", pg, epochs=1, params=params0, **GCN).state
    out = {k: host(v) for k, v in params0.items() if k != "emb"}
    out["labels"] = host(labels).reshape(-1)[pg.perm]
    out["relu_on"] = host(p1 > 0)
    for k in p:
        out[f"g_{k}"] = host(grads[k])
        out[f"s_{k}"] = host(stepped[k])
    return out


def step_against_oracle(np, A, At, z1, z1_err, p0, card, first_loss):
    """The card's step (``step_on_card``'s arrays in ``card``) against
    :func:`gcn_step_oracle` from the params ``p0`` (float64): each leaf's
    gradient within GRAD_RTOL of the float64 norm, its change after one
    epoch within STEP_RTOL plus the float32 rounding of the stepped
    values, and the first loss within LOSS_RTOL."""
    (loss64, g64, step64, gnorm, n_flip, n_band) = gcn_step_oracle(
        np, A, At, z1, z1_err, p0, card["labels"], card["relu_on"])
    if abs(first_loss - loss64) > LOSS_RTOL * loss64:
        fail(f"gcn: first loss {first_loss} vs float64 {loss64}")
    norm = np.linalg.norm
    errs = {}
    for k in p0:
        eg = norm(card[f"g_{k}"] - g64[k]) / norm(g64[k])
        s1 = card[f"s_{k}"].astype(np.float64)
        diff = norm((s1 - p0[k]) - step64[k])
        es = diff / norm(step64[k])
        if not (eg <= GRAD_RTOL and diff <= STEP_RTOL * norm(step64[k])
                + U32 * norm(s1)):
            fail(f"gcn step: {k}: gradient rel err {eg:.3g} (limit "
                 f"{GRAD_RTOL}), step rel err {es:.3g} (limit {STEP_RTOL}) "
                 "against float64")
        errs[k] = (eg, es)
    log(f"[check] gcn step vs float64 scipy/numpy: loss {first_loss:.7f} "
        f"vs {loss64:.7f}; grad norm {gnorm:.4g}; {n_flip} of {n_band} "
        "pre-activations within round-off of 0 on the other side of the "
        "relu; per leaf |g - g64|/|g64|, |step - step64|/|step64|: "
        + ", ".join(f"{k} {a:.2g}, {b:.2g}" for k, (a, b) in errs.items())
        + f" (limits {GRAD_RTOL}, {STEP_RTOL})")


# ---------------------------------------------------------------------------
# phase 5: pallas == dense at n=200k
# ---------------------------------------------------------------------------

def parity_small(torch, np, args, dev, phases):
    from repro_torch import api
    from repro_torch.core import cost_model, gspmm
    from repro_torch.graph import generators as gen
    from repro_torch.train.gcn import normalize_adjacency
    g = normalize_adjacency(gen.powerlaw(
        PARITY_N, avg_deg=8, seed=args.seed, weighted=True).symmetrized())
    M = args.workers
    tau = cost_model.choose_tau(g.out_degrees(), M)
    engines = {b: api.Engine(backend=b, layout="csr", balance="hash",
                             device=dev) for b in ("pallas", "dense")}
    pg = engines["pallas"].partition(g, M, tau=tau, seed=args.seed)
    x = torch.randn((pg.M, pg.n_loc, GCN["feat_dim"]), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    x = torch.where(pg.vmask[..., None], x, 0.0)
    worst = 0.0
    for kind in gspmm.GSPMM_KINDS:
        a, sa = gspmm.gspmm_stats(pg, kind, x, backend="pallas")
        b, sb = gspmm.gspmm_stats(pg, kind, x, backend="dense")
        assert_stats_equal(np, kind, sa, sb)
        if kind == "u_mul_e_max":
            if not torch.equal(a, b):
                fail(f"{kind}: pallas != dense at n={PARITY_N}")
            continue
        mag, _ = gspmm.gspmm_stats(pg, kind, x.abs(), backend="dense")
        worst = max(worst, within_sum_bound(
            np, f"{kind} pallas vs dense", a.cpu().numpy(),
            b.cpu().numpy(), mag.cpu().numpy(), None, factor=1e-5))
    hist = {b: e.run("gcn", pg, epochs=3, **GCN).history
            for b, e in engines.items()}
    # the backends differ in summation order only: a few float32 ulps of a
    # loss near ln(8) (2.4e-7 each), far below the history's fall
    fall = hist["dense"][0] - hist["dense"][-1]
    if not (np.allclose(hist["pallas"], hist["dense"], rtol=0, atol=1e-6)
            and fall > 1e-4):
        fail(f"gcn loss pallas {hist['pallas']} vs dense {hist['dense']}")
    log(f"[check] pallas == dense at n={PARITY_N} on the card: max bitwise, "
        f"sums max |err|/(|A|^T|X|) {worst:.3g} (limit 1e-5), every "
        f"msgs_*/per_worker_* equal; gcn loss {hist['pallas']} vs "
        f"{hist['dense']} (atol=1e-6; it falls by {fall:.3g})")


# ---------------------------------------------------------------------------
# phase 7: serve Hymba-1.5B at full width
# ---------------------------------------------------------------------------

def flash_pairs(S: int, window: int) -> int:
    """Query-key pairs a causal mask (and a window, if any) keeps for
    Sq = Sk = S."""
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def flash_random_cases(torch, np, dev, seed):
    """The flash kernel against its plain version in float64 (the oracle)
    over causal x window x n_rep x d x S, float32 within FLASH_F32_TOL of
    max|v|; bfloat16 inputs against the float32 plain version within
    FLASH_BF16_TOL, and at d=256 (Gemma-3's heads) over the whole grid
    against the float64 plain version of the bfloat16 inputs.  Returns the
    largest |kernel - oracle| in float32."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(dev).manual_seed(seed + 7)
    worst, worst_plain, n = 0.0, 0.0, 0
    for S in FLASH_CASE_S:
        for d in (16, 64, 128, 256):
            for n_rep in (1, 5):
                BKV = 2
                q = torch.randn((BKV * n_rep, S, d), generator=gen, device=dev)
                k = torch.randn((BKV, S, d), generator=gen, device=dev)
                v = torch.randn((BKV, S, d), generator=gen, device=dev)
                q64, k64, v64 = q.double(), k.double(), v.double()
                for causal in (True, False):
                    for window in (0, 16, 100, 1024):
                        got = fk.launch(q, k, v, causal=causal, window=window)
                        want = flash_attention_ref(q64, k64, v64,
                                                   causal=causal,
                                                   window=window)
                        plain = flash_attention_ref(q, k, v, causal=causal,
                                                    window=window)
                        torch.cuda.synchronize()
                        err = float((got.double() - want).abs().max())
                        lim = FLASH_F32_TOL * float(v.abs().max())
                        if not err <= lim:
                            fail(f"flash kernel vs float64 plain: |err| {err:.3g}"
                                 f" > {lim:.3g} (S={S}, d={d}, n_rep={n_rep}, "
                                 f"causal={causal}, window={window})")
                        worst = max(worst, err)
                        worst_plain = max(worst_plain, float(
                            (plain.double() - want).abs().max()))
                        n += 1
    log(f"[kernel] flash_attention: {n} random float32 cases within "
        f"{FLASH_F32_TOL} x max|v| of the float64 plain version (max |err| "
        f"{worst:.3g}; the float32 plain version's own {worst_plain:.3g})")
    rect, n_rect = 0.0, 0
    for Sq, Sk in FLASH_RECT:
        for d in (16, 64, 128, 256):
            for n_rep in (1, 5):
                q = torch.randn((2 * n_rep, Sq, d), generator=gen, device=dev)
                k = torch.randn((2, Sk, d), generator=gen, device=dev)
                v = torch.randn((2, Sk, d), generator=gen, device=dev)
                got = fk.launch(q, k, v, causal=False, window=0)
                want = flash_attention_ref(q.double(), k.double(), v.double(),
                                           causal=False, window=0)
                torch.cuda.synchronize()
                err = float((got.double() - want).abs().max())
                lim = FLASH_F32_TOL * float(v.abs().max())
                if got.shape != q.shape or not err <= lim:
                    fail(f"flash kernel unmasked vs float64 plain: shape "
                         f"{tuple(got.shape)}, |err| {err:.3g} > {lim:.3g} "
                         f"(Sq={Sq}, Sk={Sk}, d={d}, n_rep={n_rep})")
                rect, n_rect = max(rect, err), n_rect + 1
                worst = max(worst, err)
                if Sq > Sk:
                    for causal, window in ((True, 0), (False, 16)):
                        try:
                            fk.launch(q, k, v, causal=causal, window=window)
                        except ValueError:
                            continue
                        fail(f"the flash kernel took Sq={Sq} > Sk={Sk} under "
                             f"causal={causal}, window={window}")
    log(f"[kernel] flash_attention: {n_rect} unmasked rectangular float32 "
        f"cases (Sq, Sk) in {FLASH_RECT} x d 16/64/128/256 x n_rep 1/5 "
        f"within {FLASH_F32_TOL} x max|v| of the float64 plain version (max "
        f"|err| {rect:.3g}); Sq > Sk refused under a causal mask or a window")
    bf_worst = 0.0
    for S, window in ((2048, 0), (2048, 1024), (2112, 16)):
        q = torch.randn((10, S, 64), generator=gen, device=dev)
        k = torch.randn((2, S, 64), generator=gen, device=dev)
        v = torch.randn((2, S, 64), generator=gen, device=dev)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = fk.launch(qb, kb, vb, causal=True, window=window)
        want = flash_attention_ref(qb.float(), kb.float(), vb.float(),
                                   causal=True, window=window)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            fail(f"flash kernel returned {got.dtype} for bfloat16 inputs")
        err = float((got.float() - want).abs().max())
        if not err <= FLASH_BF16_TOL:
            fail(f"bfloat16 flash kernel vs float32 plain: |err| {err:.3g} > "
                 f"{FLASH_BF16_TOL} (S={S}, window={window})")
        bf_worst = max(bf_worst, err)
    log(f"[kernel] flash_attention: 3 bfloat16 cases within {FLASH_BF16_TOL} "
        f"of the float32 plain version (max |err| {bf_worst:.3g})")
    bf_worst, n = 0.0, 0
    for S in FLASH_CASE_S:
        for n_rep in (1, 5):
            qb, kb, vb = (torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16) for shape in [(2 * n_rep, S, 256),
                                              (2, S, 256), (2, S, 256)])
            q64, k64, v64 = qb.double(), kb.double(), vb.double()
            for causal in (True, False):
                for window in (0, 16, 100, 1024):
                    got = fk.launch(qb, kb, vb, causal=causal, window=window)
                    want = flash_attention_ref(q64, k64, v64, causal=causal,
                                               window=window)
                    torch.cuda.synchronize()
                    if got.dtype != torch.bfloat16:
                        fail(f"flash kernel returned {got.dtype} for "
                             "bfloat16 inputs at d=256")
                    err = float((got.double() - want).abs().max())
                    if not err <= FLASH_BF16_TOL:
                        fail(f"bfloat16 flash kernel at d=256 vs float64 "
                             f"plain: |err| {err:.3g} > {FLASH_BF16_TOL} "
                             f"(S={S}, n_rep={n_rep}, causal={causal}, "
                             f"window={window})")
                    bf_worst = max(bf_worst, err)
                    n += 1
    log(f"[kernel] flash_attention: {n} bfloat16 cases at d=256 within "
        f"{FLASH_BF16_TOL} of the float64 plain version (max |err| "
        f"{bf_worst:.3g})")
    return worst


def ssd_case_err(torch, got, want):
    """max |got - want| / max |want| (0 for an all-zero want)."""
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / max(scale, 1e-30)


def ssd_random_cases(torch, np, dev, seed):
    """The SSD kernel against the float64 recurrence (its plain version in
    float64): y and the final state within SSD_RTOL of their max, at S a
    multiple of the chunk and ragged, (P, N) in {(64, 16), (64, 128)},
    groups 1 and 2, with and without an initial state."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    gen = torch.Generator(dev).manual_seed(seed + 8)
    worst, n = 0.0, 0
    for S, chunk in ((256, 128), (200, 128), (2112, 128), (2112, 64)):
        for P, N in ((64, 16), (64, 128)):
            for g, init in ((1, False), (2, True)):
                b, h = 2, 4
                x = torch.randn((b, S, h, P), generator=gen, device=dev)
                dt = torch.nn.functional.softplus(torch.randn(
                    (b, S, h), generator=gen, device=dev) - 1.0)
                A = -torch.exp(0.5 * torch.randn((h,), generator=gen,
                                                 device=dev))
                B = torch.randn((b, S, g, N), generator=gen, device=dev)
                C = torch.randn((b, S, g, N), generator=gen, device=dev)
                s0 = (torch.randn((b, h, P, N), generator=gen, device=dev)
                      if init else None)
                y, st = sk.launch(x, dt, A, B, C, chunk=chunk, init_state=s0)
                y64, st64 = ssd_scan_ref_model(
                    x.double(), dt.double(), A.double(), B.double(),
                    C.double(), None if s0 is None else s0.double())
                torch.cuda.synchronize()
                ey = ssd_case_err(torch, y, y64)
                es = ssd_case_err(torch, st, st64)
                if not (ey <= SSD_RTOL and es <= SSD_RTOL):
                    fail(f"SSD kernel vs float64 recurrence: y {ey:.3g}, "
                         f"state {es:.3g} of max (limit {SSD_RTOL}; S={S}, "
                         f"chunk={chunk}, P={P}, N={N}, g={g}, init={init})")
                worst = max(worst, ey, es)
                n += 1
    log(f"[kernel] ssd_scan: {n} random cases, y and final state within "
        f"{SSD_RTOL} of their max against the float64 recurrence (max "
        f"{worst:.3g})")
    return worst


def _slice_tree(tree, i):
    return {k: _slice_tree(v, i) if isinstance(v, dict) else v[i:i + 1]
            for k, v in tree.items()}


def one_layer_stages(params, cfg):
    """Every layer of the model as a one-layer stage, in order:
    (StageSpec, stage params), run by the model's own apply_stage_seq /
    apply_stage_decode."""
    from repro_torch.models.transformer import StageSpec, build_stages
    out = []
    for sp, stage in zip(params["stages"], build_stages(cfg)):
        for i in range(stage.n_layers):
            out.append((StageSpec(stage.kind, 1, stage.window),
                        {"layers": _slice_tree(sp["layers"], i)}))
    return out


def record_launches(mods, fn):
    """Run ``fn`` with each module's ``launch`` wrapped to keep a copy of
    every launch's arguments; returns {module name: [(args, kw), ...]}."""
    seen = {name: [] for name in mods}
    saved = {name: m.launch for name, m in mods.items()}

    def wrap(name):
        def rec(*a, **kw):
            seen[name].append((tuple(t.clone() if hasattr(t, "clone") else t
                                     for t in a), dict(kw)))
            return saved[name](*a, **kw)
        return rec
    for name, m in mods.items():
        m.launch = wrap(name)
    try:
        fn()
    finally:
        for name, m in mods.items():
            m.launch = saved[name]
    return seen


def flash_rows(torch, launches, fk, flash_ref, lib_factor=None,
               unmasked=False):
    """Time the flash kernel on each recorded launch of the counted prefill
    (kernel, plain version, and SDPA on kv repeated: the window as a
    boolean mask, ``is_causal`` for a global causal layer, no mask for an
    unmasked one), hold the kernel and SDPA against the float64 plain
    version; one row per launch.  SDPA is held within LIB_TOL of max|v|,
    or, with ``lib_factor``, within the larger of that and ``lib_factor``
    times the float32 plain version's own error (the kernel's rule).
    Unmasked launches (an encoder, cross-attention: Sq may differ from Sk)
    fail the phase unless ``unmasked``."""
    F = torch.nn.functional
    rows = []
    for idx, ((q, k, v), kw) in enumerate(launches):
        BH, S, d = q.shape
        BKV, Sk = k.shape[0], k.shape[1]
        rep = BH // BKV
        window = kw["window"]
        kr = torch.repeat_interleave(k, rep, dim=0)[None]
        vr = torch.repeat_interleave(v, rep, dim=0)[None]
        if window:
            pos = torch.arange(S, device=q.device)
            dq = pos[:, None] - pos[None, :]
            mask = (dq >= 0) & (dq < window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], kr, vr, attn_mask=mask)
        elif kw["causal"]:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], kr, vr, is_causal=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], kr, vr)
        fns = {"ms": lambda: fk.launch(q, k, v, **kw),
               "plain_ms": lambda: flash_ref(q, k, v, **kw),
               "library_ms": lib}
        if idx == 0:                                   # warm-up, not timed
            for fn in fns.values():
                fn()
        row = {"launch": f"layer{idx}", "window": window,
               "causal": bool(kw["causal"]), "BH": BH, "S": S, "Sk": Sk,
               "d": d, "n_rep": rep}
        outs = {}
        for key, fn in fns.items():
            outs[key], row[key] = event_ms(torch, fn)
        want = flash_ref(q.double(), k.double(), v.double(), **kw)
        vmax = float(v.abs().max())
        row["max_abs_err"] = float((outs["ms"].double() - want).abs().max())
        row["plain_err"] = float((outs["plain_ms"].double() - want).abs().max())
        row["rel_err"] = row["max_abs_err"] / vmax
        row["plain_rel_err"] = row["plain_err"] / vmax
        lim = max(FLASH_F32_TOL * vmax, PLAIN_FACTOR * row["plain_err"])
        if not row["max_abs_err"] <= lim:
            fail(f"flash kernel at the path's shapes (layer {idx}): |err| "
                 f"{row['max_abs_err']:.3g} > {lim:.3g} (the float32 plain "
                 f"version's {row['plain_err']:.3g}, max|v| {vmax:.3g})")
        lib_err = float((outs["library_ms"][0].double() - want).abs().max())
        row["library_err"] = lib_err
        lib_lim = LIB_TOL * vmax
        if lib_factor is not None:
            lib_lim = max(lib_lim, lib_factor * row["plain_err"])
        if not lib_err <= lib_lim:
            fail(f"SDPA does not compute the flash kernel's function (layer "
                 f"{idx}): |err| {lib_err:.3g} > {lib_lim:.3g} (the float32 "
                 f"plain version's {row['plain_err']:.3g}, max|v| "
                 f"{vmax:.3g})")
        if not kw["causal"] and not unmasked:
            fail(f"a non-causal flash launch on the serving path (layer {idx})")
        pairs = flash_pairs(S, window) if kw["causal"] else S * Sk
        row["ops"] = 4 * d * pairs * BH
        row["bytes"] = 4 * (2 * BH * S * d + 2 * BKV * Sk * d)
        row["bound_ms"] = max(row["ops"] / FP32_OPS_PER_S,
                              row["bytes"] / HBM_BYTES_PER_S) * 1e3
        rows.append(row)
        del want, outs, kr, vr
    return rows


def ssd_rows(torch, launches, sk, ssd_ref):
    """Time the SSD kernel on each recorded launch of the counted prefill
    (kernel and plain version; no single PyTorch call computes the scan)
    and hold y and the final state against the float64 recurrence; one
    row per launch."""
    rows = []
    for idx, ((x, dt, A, B, C), kw) in enumerate(launches):
        b, S, h, P = x.shape
        g, N = B.shape[2], B.shape[3]
        Q = kw["chunk"]
        fns = {"ms": lambda: sk.launch(x, dt, A, B, C, **kw),
               "plain_ms": lambda: ssd_ref(x, dt, A, B, C)}
        if idx == 0:
            for fn in fns.values():
                fn()
        row = {"launch": f"layer{idx}", "b": b, "S": S, "h": h, "P": P,
               "N": N, "g": g, "chunk": Q}
        outs = {}
        for key, fn in fns.items():
            outs[key], row[key] = event_ms(torch, fn)
        y64, st64 = ssd_ref(x.double(), dt.double(), A.double(), B.double(),
                            C.double())
        y, st = outs["ms"]
        ey, es = ssd_case_err(torch, y, y64), ssd_case_err(torch, st, st64)
        py, ps = outs["plain_ms"]
        row["plain_rel_err"] = max(ssd_case_err(torch, py, y64),
                                   ssd_case_err(torch, ps, st64))
        lim = max(SSD_RTOL, PLAIN_FACTOR * row["plain_rel_err"])
        if not (ey <= lim and es <= lim):
            fail(f"SSD kernel at the path's shapes (layer {idx}): y {ey:.3g},"
                 f" state {es:.3g} of max (limit {lim:.3g}; the float32 "
                 f"plain version's {row['plain_rel_err']:.3g})")
        row["max_abs_err"] = float((y.double() - y64).abs().max())
        row["rel_err"] = max(ey, es)
        tri = Q * (Q + 1) // 2
        n_chunks = -(-S // Q)
        row["ops"] = b * h * n_chunks * (2 * tri * (N + P) + 4 * Q * P * N)
        row["bytes"] = 4 * (2 * b * S * h * P + b * S * h + 2 * b * S * g * N
                            + b * h * P * N + h)
        rows.append(row)
        del y64, st64, outs
    return rows


def ssd_passes(by_name, calls):
    """The SSD kernel's passes in the profiled prefill (``profile_kernels``
    by kernel name): each pass's launches and device time over the
    prefill's ``calls`` calls, and the CUDA launches a call.  Fails unless
    the profiler saw every pass launched once a call."""
    if not by_name:
        log("[kernel] ssd_scan passes: the profiler saw no device time "
            "(not measured)")
        return {}
    seen = {}
    for name, (n, us) in by_name.items():
        label = next((o for o in ("chunk_state", "state_pass", "chunk_scan")
                      if f"ssd_{o}" in name), None)
        if label:
            seen[label] = {"launches": n, "ms": us / 1e3}
    if sorted(seen) != ["chunk_scan", "chunk_state", "state_pass"] or any(
            v["launches"] != calls for v in seen.values()):
        fail(f"ssd_scan passes in the profiled prefill: {seen}, expected "
             f"chunk_state, state_pass and chunk_scan {calls} times each")
    per_call = sum(v["launches"] for v in seen.values()) / calls
    log(f"[kernel] ssd_scan passes over the {calls} calls of the profiled "
        "prefill: " + ", ".join(f"{k} {v['ms']:.3f} ms ({v['launches']} "
                                "launches)" for k, v in seen.items())
        + f"; {per_call:g} CUDA launches a call")
    return seen


def flash_kinds(rows, tag: str = ""):
    """The [kernel] flash_attention line of each layer kind (window or
    global): kernel, SDPA and bound, in total and per launch."""
    for kind, sel in (("window", [r for r in rows if r["window"]]),
                      ("global", [r for r in rows if not r["window"]])):
        if not sel:
            continue
        bound = [max(r["ops"] / FP32_OPS_PER_S,
                     r["bytes"] / HBM_BYTES_PER_S) * 1e3 for r in sel]
        ms = [r["ms"] for r in sel]
        lib = [r["library_ms"] for r in sel]
        faster = sum(r["ms"] <= r["library_ms"] for r in sel)
        log(f"[kernel] flash_attention{tag} {kind} layers ({len(sel)}): kernel "
            f"{sum(ms):.3f} ms ({min(ms):.3f}-{max(ms):.3f} a launch), SDPA "
            f"{sum(lib):.3f} ms ({min(lib):.3f}-{max(lib):.3f}), bound "
            f"{sum(bound):.3f} ms ({min(bound):.3f}-{max(bound):.3f}); "
            f"bound/kernel {sum(bound) / sum(ms):.3f}; kernel no slower than "
            f"SDPA on {faster} of {len(sel)}")


def kernel_entry(name, source, replaces, launches, rows, rand_err, library):
    """One entry of the kernels JSON line: the sums over the rows (one a
    launch of the counted run), the bound from their bytes and operations."""
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
    t_ops = sum(r["ops"] for r in rows) / FP32_OPS_PER_S
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max([rand_err] + [r["max_abs_err"] for r in rows]),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (sum(r["library_ms"] for r in rows) if library
                       else None),
        "per_launch": rows,
    }


def rel_max(torch, got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def per_layer_kernels_vs_plain(torch, cfg, zoo, tf, params, prompts, layers,
                               h=None, enc_out=None, tag=""):
    """Check (b): each layer's update h_{l+1} - h_l with the kernels
    ("auto") against the same layer's plain path ("ref") on the same input
    (the kernels' run's h_l), within LAYER_RTOL of its max.  The first
    input is the prompts' embeddings, or ``h`` (an encoder's frames);
    ``enc_out`` is handed to the layers (a decoder's cross-attention).
    Returns the worst relative error and the kernels' final hidden
    state."""
    q_chunk = max(prompts.shape[1], 64)
    auto = tf.ModelContext(q_chunk=q_chunk)
    ref = tf.ModelContext(q_chunk=q_chunk, kernels="ref")
    if h is None:
        h = zoo._embed_in(params, cfg, prompts, auto)
    B, S = h.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    errs = []
    for stage, sp in layers:
        h_k = tf.apply_stage_seq(h, sp, stage, cfg, auto, pos,
                                 enc_out=enc_out)[0]
        h_r = tf.apply_stage_seq(h, sp, stage, cfg, ref, pos,
                                 enc_out=enc_out)[0]
        errs.append(rel_max(torch, h_k - h, h_r - h))
        h = h_k
    log(f"[check] (b){tag} per layer: " + ", ".join(f"{e:.2g}" for e in errs))
    for li, ((stage, _), err) in enumerate(zip(layers, errs)):
        if not err <= LAYER_RTOL:
            fail(f"layer {li} ({stage.kind}, window {stage.window}): the "
                 f"kernels' update differs from the plain path's by {err:.3g}"
                 f" of its max (limit {LAYER_RTOL})")
    return max(errs), h


def per_layer_decode_vs_forward(torch, cfg, zoo, tf, params, seq, n_prompt,
                                layers, enc_out=None):
    """Check (c), layer by layer with teacher forcing: the no-cache forward
    ("auto": both kernels, at the ragged length of ``seq``) gives each
    layer's input H_l at every position.  For each layer, the prefill path
    runs H_l over the prompt and builds the cache, then the decode path
    runs the next positions one token at a time on H_l.  At positions
    n_prompt-1 (the prefill's last) .. S-2 the layer's update must match
    the forward's within LAYER_RTOL of its max, and the last layer's
    outputs through the final norm and the logits must match the
    forward's logits within LOGIT_RTOL.  ``enc_out`` is handed to every
    layer (a decoder's cross-attention).  Returns (worst layer error, logit
    error, positions checked)."""
    B, S = seq.shape
    steps = S - n_prompt - 1             # decode at n_prompt .. S-2
    lo, hi = n_prompt - 1, S - 1         # the positions checked
    pos = torch.arange(S, dtype=torch.int32, device=seq.device).expand(B, S)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    h = zoo._embed_in(params, cfg, seq, ctx)
    errs = []
    for stage, sp in layers:
        h_next = tf.apply_stage_seq(h, sp, stage, cfg, ctx, pos,
                                    enc_out=enc_out)[0]
        clen = zoo._stage_cache_len(stage, S)
        h_pre, cache, _ = tf.apply_stage_seq(
            h[:, :n_prompt], sp, stage, cfg, ctx, pos[:, :n_prompt],
            enc_out=enc_out, want_cache=True, cache_len=clen)
        if stage.kind != "ssm":
            cache["k_pos"] = tf.stage_kpos(B, n_prompt, clen, seq.device)
        p = torch.full((B,), n_prompt, dtype=torch.int32, device=seq.device)
        outs = [h_pre[:, -1:]]
        for i in range(steps):
            t = n_prompt + i
            o, cache = tf.apply_stage_decode(h[:, t:t + 1], sp, stage, cfg,
                                             ctx, p + i, cache,
                                             enc_out=enc_out)
            outs.append(o)
        dec = torch.cat(outs, dim=1)
        base = h[:, lo:hi]
        errs.append(rel_max(torch, dec - base, h_next[:, lo:hi] - base))
        h, last = h_next, dec
        del cache, h_pre, outs
    log("[check] (c) per layer: " + ", ".join(f"{e:.2g}" for e in errs))
    for li, ((stage, _), err) in enumerate(zip(layers, errs)):
        if not err <= LAYER_RTOL:
            fail(f"layer {li} ({stage.kind}, window {stage.window}): prefill "
                 f"+ decode differ from the no-cache forward by {err:.3g} of "
                 f"the update's max (limit {LAYER_RTOL})")
    from repro_torch.models import embedding as emb
    from repro_torch.models.layers import rms_norm

    def logits(x):
        return emb.logits_matmul(rms_norm(x, params["final_norm"],
                                          cfg.norm_eps),
                                 params["out_embed"])[..., :cfg.vocab]
    lerr = rel_max(torch, logits(last), logits(h[:, lo:hi]))
    if not lerr <= LOGIT_RTOL:
        fail(f"decode logits differ from the no-cache forward's by {lerr:.3g}"
             f" of the max (limit {LOGIT_RTOL})")
    return max(errs), lerr, hi - lo


def profile_kernels(torch, fn, name: str, top: int = 10,
                    no_grad: bool = True):
    """Where the device time of one call of ``fn`` goes, by device kernel
    (torch.profiler; the ctypes-launched kernels appear under their own
    names): the busy share of the wall time and the kernels with the most
    device time.  ``fn`` runs under ``torch.no_grad`` unless ``no_grad``
    is False (a training step).  Returns {kernel name: (launches, device
    us)}, empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    if busy <= 0:
        log(f"[profile] {name}: the profiler saw no device time "
            "(not measured)")
        return {}
    log(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms (profiled), device "
        f"busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}%, "
        f"{sum(n for n, _ in by_name.values())} kernels")
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile] {name}:   {kname[:70]:70s} calls={n:5d} "
            f"device={us / 1e3:9.3f} ms ({100 * us / busy:5.1f}%)")
    return by_name


def serve_path(torch, np, args, dev, phases):
    """Phase 7: Hymba-1.5B at full width (32 layers, d_model 1600, float32,
    random weights from torch.Generator(seed) on the card) serves B=4
    random prompts of 2048 tokens: prefill, then 63 greedy decode steps (64
    generated tokens), through model_zoo.prefill / decode_step, the
    functions serve_model.run calls.  Returns the two kernels' JSON
    entries."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf

    log(f"[serve] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} (float32 products in full "
        f"float32), float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    flash_err = phases.run("flash-vs-plain", flash_random_cases, torch, np,
                           dev, args.seed)
    ssd_err = phases.run("ssd-vs-plain", ssd_random_cases, torch, np, dev,
                         args.seed)
    half = phases.run("half-types", half_type_cases, torch, np, dev,
                      args.seed)
    cfg = get_config(LM_ARCH)
    params = phases.run("lm-init", lambda: zoo.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(params)
    stages = tf.build_stages(cfg)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, ssm "
        f"{cfg.n_ssm_heads} heads x P={cfg.ssm.head_dim} x N="
        f"{cfg.ssm.d_state}, vocab {cfg.vocab} (padded "
        f"{cfg.padded_vocab(1)}); {n_par:,} parameters float32 "
        f"({4 * n_par / 1e9:.2f} GB; param_counts()['total'] "
        f"{cfg.param_counts()['total']:,} unpadded); stages "
        + ", ".join(f"{s.kind}x{s.n_layers}(w={s.window})" for s in stages))
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    n_attn = sum(s.n_layers for s in stages if s.kind != "ssm")
    n_ssm = sum(s.n_layers for s in stages if s.kind != "dense")

    def serve():
        with torch.no_grad():
            logits, cache = zoo.prefill(params, cfg, ctx, prompts,
                                        max_len=S + G)
            step_logits, toks = [logits], [zoo.greedy(logits)]
            for _ in range(G - 1):
                logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache)
                step_logits.append(logits)
                toks.append(zoo.greedy(logits))
        return step_logits, torch.cat(toks, dim=1)

    # one untimed warm run (the caching allocator's growth, cuBLAS set-up)
    phases.run("serve-warm", serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.flash_attention_bhsd.launches = 0             # the path starts here
    sk.ssd_chunk_scan.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    t0 = time.perf_counter()
    with torch.no_grad():
        ev[0].record()
        logits, cache = zoo.prefill(params, cfg, ctx, prompts, max_len=S + G)
        ev[1].record()
        pre_launches = (fk.flash_attention_bhsd.launches,
                        sk.ssd_chunk_scan.launches)
        step_logits, toks = [logits], [zoo.greedy(logits)]
        for i in range(G - 1):
            logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1], cache)
            ev[i + 2].record()
            step_logits.append(logits)
            toks.append(zoo.greedy(logits))
        gen_toks = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = (fk.flash_attention_bhsd.launches,     # ... and ends here
                sk.ssd_chunk_scan.launches)
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G - 1)]
    log(f"[serve] {cfg.name}: batch={B} prompt={S} gen={G}: prefill "
        f"{prefill_ms:.3f} ms device ({B * S / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s), decode {float(np.mean(decode_ms)):.3f} ms a step "
        f"(median {float(np.median(decode_ms)):.3f}, {G - 1} steps), "
        f"{host_s:.3f} s host for the request ({B * G / host_s:.1f} "
        f"generated tokens/s); peak device memory {peak / 2**30:.2f} GiB")
    log(f"[serve] launches in the counted run: prefill {pre_launches[0]} "
        f"flash, {pre_launches[1]} SSD; decode {launches[0] - pre_launches[0]}"
        f" flash, {launches[1] - pre_launches[1]} SSD")
    # (d) the launch counters
    if pre_launches != (n_attn, n_ssm) or launches != pre_launches:
        fail(f"serve: launches (flash, SSD) {pre_launches} in the prefill, "
             f"{launches} in all, expected ({n_attn}, {n_ssm}) and none in "
             "decode: the path did not go through the kernels")
    # (e) finite logits
    for i, lg in enumerate(step_logits):
        if not bool(torch.isfinite(lg).all()):
            fail(f"serve: non-finite logits at step {i}")
    pad = step_logits[0][:, cfg.vocab:]
    if pad.numel() and not bool((pad == -2.0 ** 30).all()):
        fail("serve: the padded vocabulary's logits are not -2^30")
    log(f"[serve] sample generations (token ids): "
        f"{gen_toks[0, :16].tolist()}")
    prof = phases.run("profile-prefill", profile_kernels, torch,
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G), "prefill")
    s_passes = ssd_passes(prof, n_ssm)
    phases.run("profile-decode", profile_kernels, torch,
               lambda: zoo.decode_step(params, cfg, ctx, toks[-1], cache),
               "decode step")

    # (a) both kernels at the path's shapes, on a replay's recorded inputs
    seen = phases.run("serve-record", record_launches,
                      {"flash": fk, "ssd": sk},
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G))
    f_rows = phases.run("flash-timing", flash_rows, torch, seen["flash"],
                        fk, flash_attention_ref)
    s_rows = phases.run("ssd-timing", ssd_rows, torch, seen["ssd"], sk,
                        ssd_scan_ref_model)
    del seen
    if len(f_rows) != launches[0] or len(s_rows) != launches[1]:
        fail(f"{len(f_rows)} flash / {len(s_rows)} SSD launches timed, "
             f"{launches} in the counted prefill")
    log(f"[check] (a) both kernels on the prefill's own inputs against the "
        f"float64 plain version: flash max |err| / max|v| "
        f"{max(r['rel_err'] for r in f_rows):.3g} (the float32 plain "
        f"version's {max(r['plain_rel_err'] for r in f_rows):.3g}), SSD max "
        f"rel {max(r['rel_err'] for r in s_rows):.3g} (plain "
        f"{max(r['plain_rel_err'] for r in s_rows):.3g}); limits: the larger "
        f"of {FLASH_F32_TOL} / {SSD_RTOL} and {PLAIN_FACTOR} x the plain "
        "version's")
    log("[check] (a) per layer, flash |err|/max|v| (plain): " + ", ".join(
        f"{r['rel_err']:.2g} ({r['plain_rel_err']:.2g})" for r in f_rows))
    log("[check] (a) per layer, SSD rel err (plain): " + ", ".join(
        f"{r['rel_err']:.2g} ({r['plain_rel_err']:.2g})" for r in s_rows))

    # (b) kernels against the plain path
    layers = one_layer_stages(params, cfg)
    with torch.no_grad():
        worst_b, h_last = phases.run(
            "kernels-vs-plain", per_layer_kernels_vs_plain, torch, cfg, zoo,
            tf, params, prompts, layers)
        ref_ctx = tf.ModelContext(q_chunk=max(S, 64), kernels="ref")
        ref_logits, _ = zoo.prefill(params, cfg, ref_ctx, prompts,
                                    max_len=S + G)
    V = cfg.vocab
    e2e = rel_max(torch, step_logits[0][:, :V], ref_logits[:, :V])
    log(f"[check] (b) kernels vs plain, layer by layer on the same input: "
        f"max |update error| {worst_b:.3g} of the update's max over "
        f"{len(layers)} layers (limit {LAYER_RTOL}); last-token logits of "
        f"the whole prefill, kernels vs plain: {e2e:.3g} of max|logit| (not "
        "a gate: the random-weight 32-layer model amplifies float32 "
        "rounding; see PERF.md)")
    del ref_logits

    # (c) decode against teacher forcing, layer by layer
    seq = torch.cat([prompts, gen_toks], dim=1)             # (B, S + G)
    with torch.no_grad():
        worst_c, logit_c, steps = phases.run(
            "decode-vs-forward", per_layer_decode_vs_forward, torch, cfg, zoo,
            tf, params, seq, S, layers)
        full, _ = zoo.forward_logits(params, cfg, ctx, seq)
    served = torch.stack(step_logits, dim=1)[..., :V]        # (B, G, V)
    e2e_c = rel_max(torch, served, full[:, S - 1:S - 1 + G, :V])
    log(f"[check] (c) prefill + decode vs the no-cache forward over {S + G} "
        f"tokens, layer by layer with teacher forcing at {steps} positions "
        f"{S - 1}..{S + G - 2}"
        f": max |update error| {worst_c:.3g} (limit {LAYER_RTOL}); logits "
        f"through the last layer {logit_c:.3g} of max (limit {LOGIT_RTOL}); "
        f"the served run's logits at positions {S - 1}..{S + G - 2} vs the "
        f"forward's: {e2e_c:.3g} of max|logit| (not a gate, as in (b))")
    del full, served

    for name, rows in (("flash_attention", f_rows), ("ssd_scan", s_rows)):
        lib = sum(r.get("library_ms", 0.0) for r in rows)
        t_b = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        t_o = sum(r["ops"] for r in rows) / FP32_OPS_PER_S * 1e3
        log(f"[kernel] {name}: {len(rows)} launches a prefill: kernel "
            f"{sum(r['ms'] for r in rows):.3f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows):.3f} ms, library "
            f"{(f'{lib:.3f} ms' if name == 'flash_attention' else 'none')}, "
            f"bound {max(t_b, t_o):.3f} ms ({t_o:.3f} operations, "
            f"{t_b:.3f} bytes)")
    flash_kinds(f_rows)
    entries = [
        kernel_entry("flash_attention_bhsd", FLASH_SOURCE, FLASH_REPLACES,
                     launches[0], f_rows, flash_err, library=True),
        kernel_entry("ssd_scan_bh", SSD_SOURCE, SSD_REPLACES, launches[1],
                     s_rows, ssd_err, library=False),
    ]
    entries[1]["passes"] = s_passes
    entries[0]["half_types"] = half["flash"]
    entries[1]["half_types"] = half["ssd"]
    del params, cache, step_logits
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 8: serve Gemma-3-4B at full width (head dim 256)
# ---------------------------------------------------------------------------

def gemma_path(torch, np, args, dev, phases):
    """Phase 8: Gemma-3-4B at full width (34 layers, d_model 2560, 8 query
    / 4 kv heads of dim 256, window 1024 on five layers of six, vocab
    262,144, tied embeddings; float32, random weights from
    torch.Generator(seed) on the card) serves B=4 random prompts of 2048
    tokens: prefill, then 63 greedy decode steps, through
    model_zoo.prefill / decode_step, the functions serve_model.run calls.
    Checks: 34 flash launches in the prefill (one a layer, all at d=256)
    and none in decode; finite logits, the padded vocabulary at -2^30;
    the first GEMMA_CHECK_LAYERS layers (five window layers, one global)
    with the kernel against the plain path on the same input, and prefill
    + decode against the no-cache forward, layer by layer; the kernel on
    the first window and the first global layer's recorded prefill inputs
    against the float64 plain version, timed beside the plain version and
    SDPA.  Returns {"launches", "rows", "prefill_ms", "decode_ms",
    "peak_gib"}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf

    cfg = get_config(GEMMA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = phases.run("gemma-init", lambda: zoo.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(params)
    stages = tf.build_stages(cfg)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab(1)}), "
        f"tied embeddings {cfg.tie_embeddings}; {n_par:,} parameters "
        f"float32 ({4 * n_par / 1e9:.2f} GB); stages "
        + ", ".join(f"{s.kind}x{s.n_layers}(w={s.window})" for s in stages))
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    n_attn = sum(s.n_layers for s in stages)

    def serve():
        with torch.no_grad():
            logits, cache = zoo.prefill(params, cfg, ctx, prompts,
                                        max_len=S + G)
            step_logits, toks = [logits], [zoo.greedy(logits)]
            for _ in range(G - 1):
                logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache)
                step_logits.append(logits)
                toks.append(zoo.greedy(logits))
        return step_logits, torch.cat(toks, dim=1), cache

    phases.run("gemma-warm", serve)
    torch.cuda.synchronize()
    fk.flash_attention_bhsd.launches = 0             # the path starts here
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    t0 = time.perf_counter()
    with torch.no_grad():
        ev[0].record()
        logits, cache = zoo.prefill(params, cfg, ctx, prompts, max_len=S + G)
        ev[1].record()
        pre_launches = fk.flash_attention_bhsd.launches
        step_logits, toks = [logits], [zoo.greedy(logits)]
        for i in range(G - 1):
            logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1], cache)
            ev[i + 2].record()
            step_logits.append(logits)
            toks.append(zoo.greedy(logits))
        gen_toks = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fk.flash_attention_bhsd.launches       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G - 1)]
    log(f"[serve] {cfg.name}: batch={B} prompt={S} gen={G}: prefill "
        f"{prefill_ms:.3f} ms device ({B * S / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s), decode {float(np.mean(decode_ms)):.3f} ms a step "
        f"(median {float(np.median(decode_ms)):.3f}, {G - 1} steps), "
        f"{host_s:.3f} s host for the request ({B * G / host_s:.1f} "
        f"generated tokens/s); peak device memory {peak / 2**30:.2f} GiB")
    log(f"[serve] {cfg.name} launches in the counted run: prefill "
        f"{pre_launches} flash (d={cfg.hd}), decode "
        f"{launches - pre_launches} flash")
    if pre_launches != n_attn or launches != pre_launches:
        fail(f"{cfg.name}: {pre_launches} flash launches in the prefill, "
             f"{launches} in all, expected {n_attn} and none in decode: the "
             "path did not go through the kernel")
    for i, lg in enumerate(step_logits):
        if not bool(torch.isfinite(lg).all()):
            fail(f"{cfg.name}: non-finite logits at step {i}")
    pad = step_logits[0][:, cfg.vocab:]
    if pad.numel() and not bool((pad == -2.0 ** 30).all()):
        fail(f"{cfg.name}: the padded vocabulary's logits are not -2^30")
    log(f"[serve] {cfg.name} sample generations (token ids): "
        f"{gen_toks[0, :16].tolist()}")
    prof = phases.run("gemma-profile-prefill", profile_kernels, torch,
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G),
                      f"{cfg.name} prefill")
    busy = sum(us for _, us in prof.values())
    phases.run("gemma-profile-decode", profile_kernels, torch,
               lambda: zoo.decode_step(params, cfg, ctx, toks[-1], cache),
               f"{cfg.name} decode step")
    del step_logits, cache

    # the kernel at the path's shapes: the first window and global layers
    seen = phases.run("gemma-record", record_launches, {"flash": fk},
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G))["flash"]
    layers = one_layer_stages(params, cfg)
    pick = [next(i for i, (st, _) in enumerate(layers) if st.window),
            next(i for i, (st, _) in enumerate(layers) if not st.window)]
    if len(seen) != n_attn or pick != [0, GEMMA_CHECK_LAYERS - 1]:
        fail(f"{cfg.name}: {len(seen)} recorded launches, window/global "
             f"layers at {pick}")
    # On these inputs float32 attention itself sits far from float64
    # (SDPA's default and math backends both missed LIB_TOL of max|v| on
    # the first window layer on the H100, |err| 1.9e-2 and 3.4e-2): SDPA
    # is held, as the kernel is, to PLAIN_FACTOR times the float32 plain
    # version's own error
    rows = phases.run("gemma-flash-timing", flash_rows, torch,
                      [seen[i] for i in pick], fk, flash_attention_ref,
                      PLAIN_FACTOR)
    del seen
    for i, r in zip(pick, rows):
        r.update(launch=f"{cfg.name} layer{i}", model=cfg.name)
        if r["d"] != 256:
            fail(f"{cfg.name}: a flash launch at d={r['d']}")
    log(f"[check] {cfg.name} (a) the kernel on layers {pick}'s prefill "
        "inputs against the float64 plain version: |err|/max|v| "
        + ", ".join(f"{r['rel_err']:.3g} (plain {r['plain_rel_err']:.3g})"
                    for r in rows))
    flash_kinds(rows, f" {cfg.name}")
    for r in rows:
        log(f"[kernel] flash_attention {r['launch']} (window {r['window']},"
            f" BH={r['BH']}, S={r['S']}, d={r['d']}, n_rep={r['n_rep']}): "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, SDPA "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; "
            f"|err| from float64: kernel {r['max_abs_err']:.3g}, plain "
            f"{r['plain_err']:.3g}, SDPA {r['library_err']:.3g}")

    # the layers against the plain path, and decode against the forward
    checked = layers[:GEMMA_CHECK_LAYERS]
    with torch.no_grad():
        worst_b, _ = phases.run(
            "gemma-kernels-vs-plain", per_layer_kernels_vs_plain, torch, cfg,
            zoo, tf, params, prompts, checked)
        seq = torch.cat([prompts, gen_toks], dim=1)
        worst_c, logit_c, steps = phases.run(
            "gemma-decode-vs-forward", per_layer_decode_vs_forward, torch,
            cfg, zoo, tf, params, seq, S, checked)
    log(f"[check] {cfg.name} (b) the kernel vs the plain path on layers "
        f"0..{GEMMA_CHECK_LAYERS - 1} (window x{GEMMA_CHECK_LAYERS - 1}, "
        f"global x1), each on the same input: max |update error| "
        f"{worst_b:.3g} (limit {LAYER_RTOL}); (c) prefill + decode vs the "
        f"no-cache forward over {S + G} tokens at {steps} positions: "
        f"{worst_c:.3g} (limit {LAYER_RTOL}), logits of layer "
        f"{GEMMA_CHECK_LAYERS - 1}'s output {logit_c:.3g} (limit "
        f"{LOGIT_RTOL})")
    del params, layers, checked
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "prefill_ms": prefill_ms,
            "decode_ms": float(np.mean(decode_ms)),
            "busy_ms": busy / 1e3, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# phase 13: serve OLMoE-1B-7B at full width (the moe stage kind)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_calls(tf):
    """Within, every MoE layer the transformer runs appends [h, x2d, y] to
    the yielded list: h the residual stream after attention (the MoE
    half's input), x2d the normed, flattened tokens the MoE FFN routes and
    y its output (``tf._moe_update`` and ``tf._moe_call`` wrapped)."""
    seen, update, call = [], tf._moe_update, tf._moe_call

    def rec_update(h, w, cfg, ctx):
        seen.append([h])
        return update(h, w, cfg, ctx)

    def rec_call(x2d, w, cfg, ctx):
        y, aux = call(x2d, w, cfg, ctx)
        seen[-1] += [x2d, y]
        return y, aux
    tf._moe_update, tf._moe_call = rec_update, rec_call
    try:
        yield seen
    finally:
        tf._moe_update, tf._moe_call = update, call


def moe_half_err(torch, moe, w, x2, y, mcfg):
    """The MoE half of one call against float64 on the same routing: the
    port's router and ``_slots`` give idx and keep (as inside the call),
    keep is held to the reference's own derivation (the exclusive cumsum
    down a (T*k, E) one-hot: each expert keeps its first cap pairs in
    flat token-major order), and every kept pair's gated
    expert output is recomputed in float64, expert by expert, from the
    tokens gathered directly (no ``_pack`` / ``_unpack``).  Fails on a
    keep mismatch; returns |y - y64| / max|y64|."""
    T, D = x2.shape
    E, k = mcfg.n_experts, mcfg.top_k
    cap = max(1, int(mcfg.capacity_factor * T * k / E))
    gates, idx, _ = moe.router_probs(x2, w["router"], k)
    none = torch.zeros(E, dtype=torch.bool, device=x2.device)
    flat_e, _, _, keep = moe._slots(idx, E, cap, none)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    if not torch.equal(keep, rank < cap):
        fail(f"MoE keep mask at T={T}, cap={cap}: "
             f"{int((keep != (rank < cap)).sum())} pairs differ from each "
             "expert's first cap pairs")
    tok = torch.div(torch.arange(T * k, device=x2.device), k,
                    rounding_mode="floor")
    g = gates.reshape(-1).double()
    y64 = torch.zeros(T, D, dtype=torch.float64, device=x2.device)
    kept = keep.nonzero()[:, 0]
    ke = flat_e[kept]
    for e in torch.unique(ke).tolist():
        sel = kept[ke == e]
        o = moe._expert_mlp(x2[tok[sel]].double(), w["w_gate"][e].double(),
                            w["w_up"][e].double(), w["w_down"][e].double())
        y64.index_add_(0, tok[sel], o * g[sel, None])
    return rel_max(torch, y.double(), y64)


def moe_kernels_vs_plain(torch, cfg, zoo, tf, moe, params, prompts, layers):
    """Check (b) for a moe stage, in two halves on each layer's input (the
    kernel run's h_l): the attention update with the kernel against the
    plain path's, within LAYER_RTOL of its max; the MoE half of the kernel
    run against its float64 recomputation (``moe_half_err``), within
    MOE_RTOL.  Returns (attention errors, MoE errors)."""
    B, S = prompts.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=prompts.device).expand(B, S)
    auto = tf.ModelContext(q_chunk=max(S, 64))
    ref = tf.ModelContext(q_chunk=max(S, 64), kernels="ref")
    h = zoo._embed_in(params, cfg, prompts, auto)
    attn, moe_errs = [], []
    for stage, sp in layers:
        with moe_calls(tf) as k_calls:
            h_k = tf.apply_stage_seq(h, sp, stage, cfg, auto, pos)[0]
        with moe_calls(tf) as r_calls:
            tf.apply_stage_seq(h, sp, stage, cfg, ref, pos)
        (ha_k, x2, y), = k_calls
        (ha_r, _, _), = r_calls
        attn.append(rel_max(torch, ha_k - h, ha_r - h))
        moe_errs.append(moe_half_err(torch, moe, tf._layer(sp["layers"], 0)[
            "moe"], x2, y, cfg.moe))
        h = h_k
        del k_calls, r_calls, ha_k, ha_r, x2, y
    return attn, moe_errs


def moe_decode_vs_forward(torch, cfg, zoo, tf, moe, params, seq, n_prompt,
                          layers):
    """Check (c) for a moe stage, layer by layer with teacher forcing (the
    no-cache forward ("auto") over ``seq`` gives each layer's input H_l).
    A decode step routes B tokens and the forward B*S, so their capacities
    and drops differ and whole-layer updates are not compared; instead,
    for each layer: the prefill path runs H_l over the prompt and builds
    the cache, the decode path runs positions n_prompt .. S-2 one token at
    a time; the K/V ring buffers they wrote must equal the forward's
    rotated K/V at positions 0 .. S-2 within KV_RTOL of the max; the
    attention update at positions n_prompt-1 .. S-2 must equal the
    forward's within LAYER_RTOL; each decode step's MoE half is held to
    float64 as in (b) (T=B, cap 1).  Returns (attention, K/V and MoE
    errors a layer, positions checked)."""
    B, S = seq.shape
    steps = S - n_prompt - 1
    lo, hi = n_prompt - 1, S - 1
    pos = torch.arange(S, dtype=torch.int32, device=seq.device).expand(B, S)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    h = zoo._embed_in(params, cfg, seq, ctx)
    attn, kv, moe_errs = [], [], []
    for stage, sp in layers:
        w = tf._layer(sp["layers"], 0)["moe"]
        with moe_calls(tf) as f_calls:
            h_next, fcache, _ = tf.apply_stage_seq(
                h, sp, stage, cfg, ctx, pos, want_cache=True, cache_len=S)
        with moe_calls(tf) as p_calls:
            _, cache, _ = tf.apply_stage_seq(
                h[:, :n_prompt], sp, stage, cfg, ctx, pos[:, :n_prompt],
                want_cache=True, cache_len=S)
        cache["k_pos"] = tf.stage_kpos(B, n_prompt, S, seq.device)
        p = torch.full((B,), n_prompt, dtype=torch.int32, device=seq.device)
        with moe_calls(tf) as d_calls:
            for i in range(steps):
                t = n_prompt + i
                _, cache = tf.apply_stage_decode(h[:, t:t + 1], sp, stage,
                                                 cfg, ctx, p + i, cache)
        worst = 0.0
        for _, x2, y in d_calls:
            worst = max(worst, moe_half_err(torch, moe, w, x2, y, cfg.moe))
        moe_errs.append(worst)
        dec = torch.cat([p_calls[0][0][:, -1:]] + [c[0] for c in d_calls],
                        dim=1)
        base = h[:, lo:hi]
        attn.append(rel_max(torch, dec - base, f_calls[0][0][:, lo:hi] - base))
        kv.append(max(rel_max(torch, cache[n][0][:, :hi], fcache[n][0][:, :hi])
                      for n in ("k", "v")))
        h = h_next
        del f_calls, p_calls, d_calls, cache, fcache, dec, base
    return attn, kv, moe_errs, hi - lo


def moe_lines(torch, cfg, recs, n_steps):
    """The [moe] lines: per layer of the prefill, and per layer summed over
    the decode steps, the tokens routed to each expert (max and mean: the
    paper's load balance), the share of (token, slot) pairs dropped, the
    aux loss, and the combined buffer's rows E*cap beside the token
    messages T*k.  ``recs``: moe.record of one prefill and ``n_steps``
    decode steps."""
    L, E = cfg.n_layers, cfg.moe.n_experts
    if len(recs) != L * (1 + n_steps):
        fail(f"{len(recs)} recorded MoE calls, expected {L} a pass x "
             f"{1 + n_steps} passes")
    load = torch.stack([r["load"] for r in recs]).cpu().reshape(
        1 + n_steps, L, E)
    kept = torch.stack([r["kept"] for r in recs]).cpu().reshape(
        1 + n_steps, L, E)
    aux = torch.stack([r["aux"] for r in recs]).cpu().reshape(1 + n_steps, L)
    rows, pairs = recs[0]["rows"], recs[0]["pairs"]
    out = {"prefill": [], "decode": []}
    for li in range(L):
        ld = load[0, li].double()
        drop = 1.0 - float(kept[0, li].sum()) / pairs
        out["prefill"].append({"max": int(ld.max()), "mean": float(ld.mean()),
                               "dropped": drop, "aux": float(aux[0, li])})
        log(f"[moe] {cfg.name} prefill layer {li}: tokens per expert max "
            f"{int(ld.max())}, mean {float(ld.mean()):.1f} (max/mean "
            f"{float(ld.max() / ld.mean()):.3f}), dropped {100 * drop:.2f}% "
            f"of {pairs} (token, slot) pairs, aux {float(aux[0, li]):.5f}; "
            f"combined buffer {rows} rows (E*cap, cap {recs[0]['cap']}) for "
            f"{pairs} token messages (T*k)")
    d_rows = sum(r["rows"] for r in recs[L:]) // L
    d_pairs = sum(r["pairs"] for r in recs[L:]) // L
    for li in range(L):
        ld = load[1:, li].sum(0).double()
        drop = 1.0 - float(kept[1:, li].sum()) / d_pairs
        out["decode"].append({"max": int(ld.max()), "mean": float(ld.mean()),
                              "dropped": drop,
                              "aux": float(aux[1:, li].mean())})
        log(f"[moe] {cfg.name} decode layer {li}, summed over {n_steps} "
            f"steps: tokens per expert max {int(ld.max())}, mean "
            f"{float(ld.mean()):.2f}, dropped {100 * drop:.2f}% of {d_pairs}"
            f" pairs (cap {recs[L]['cap']} a step), aux mean "
            f"{float(aux[1:, li].mean()):.5f}; buffer rows {d_rows} for "
            f"{d_pairs} token messages")
    return out


def decode_bytes(zoo, cfg, params, B, ctx_len):
    """Bytes one decode step must read: every weight it uses (each layer's
    leaves but the mirrored experts', which one device never reads, the
    final norm and the output embedding; B rows of the input embedding)
    and the K/V ring buffers of ``ctx_len`` slots, which its attention
    reads whole."""
    n = sum(t.numel() for path, t in zoo._leaves(params["stages"])
            if not str(path[-1]).endswith("_m"))
    n += params["final_norm"].numel() + params["out_embed"].numel()
    n += B * cfg.d_model
    n += 2 * cfg.n_layers * B * ctx_len * cfg.n_kv_heads * cfg.hd
    return 4 * n


def prefill_ops(cfg, B, S):
    """Operations of one prefill: the q/k/v/o products, attention (causal
    pairs), the router, the experts over the whole combined buffer (E*cap
    rows: the static design computes empty slots too) and the last
    position's logits."""
    T, D, H, K, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    E, k, F = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
    cap = max(1, int(cfg.moe.capacity_factor * T * k / E))
    layer = (4 * T * D * H * hd + 4 * T * D * K * hd
             + 4 * hd * (S * (S + 1) // 2) * B * H
             + 2 * T * D * E + 6 * E * cap * D * F)
    return cfg.n_layers * layer + 2 * B * D * cfg.padded_vocab(1)


def olmoe_path(torch, np, args, dev, phases):
    """Phase 13: OLMoE-1B-7B at full width (16 layers, d_model 2048, 16/16
    heads of dim 128, 64 experts top-8 of d_ff 1024, capacity 1.25, vocab
    50,304; float32, random weights from torch.Generator(seed) on the
    card) serves B=4 random prompts of 2048 tokens: prefill, then 63
    greedy decode steps, through model_zoo.prefill / decode_step.  Checks:
    16 flash launches (d=128) in the prefill, none in decode; finite
    logits, the padded vocabulary at -2^30; (b) and (c) in their moe forms
    on the first OLMOE_CHECK_LAYERS layers; the kernel on layer 0's
    recorded inputs against the float64 plain version, timed beside the
    plain version and SDPA.  Returns {"launches", "rows", "prefill_ms",
    "prefill_bound_ms", "decode_ms", "decode_bound_ms", "busy_ms",
    "peak_gib", "moe"}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = get_config(OLMOE_ARCH)
    mc = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    params = phases.run("olmoe-init", lambda: zoo.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(params)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, "
        f"{mc.n_experts} experts top-{mc.top_k} of d_ff {mc.d_ff_expert}, "
        f"capacity factor {mc.capacity_factor}, {mc.n_mirrored_experts} "
        f"mirrored, vocab {cfg.vocab} (padded {cfg.padded_vocab(1)}); "
        f"{n_par:,} parameters float32 ({4 * n_par / 1e9:.2f} GB; "
        f"param_counts()['total'] {cfg.param_counts()['total']:,} without "
        "the mirrored leaf the layout keeps)")
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    n_attn = cfg.n_layers

    def serve():
        with torch.no_grad():
            logits, cache = zoo.prefill(params, cfg, ctx, prompts,
                                        max_len=S + G)
            step_logits, toks = [logits], [zoo.greedy(logits)]
            for _ in range(G - 1):
                logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache)
                step_logits.append(logits)
                toks.append(zoo.greedy(logits))
        return step_logits, torch.cat(toks, dim=1), cache

    # the untimed warm run also records the routing of every MoE call
    moe.record = []
    try:
        phases.run("olmoe-warm", serve)
        torch.cuda.synchronize()
        recs = moe.record
    finally:
        moe.record = None
    fk.flash_attention_bhsd.launches = 0             # the path starts here
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    t0 = time.perf_counter()
    with torch.no_grad():
        ev[0].record()
        logits, cache = zoo.prefill(params, cfg, ctx, prompts, max_len=S + G)
        ev[1].record()
        pre_launches = fk.flash_attention_bhsd.launches
        step_logits, toks = [logits], [zoo.greedy(logits)]
        for i in range(G - 1):
            logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1], cache)
            ev[i + 2].record()
            step_logits.append(logits)
            toks.append(zoo.greedy(logits))
        gen_toks = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fk.flash_attention_bhsd.launches       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G - 1)]
    step_bytes = decode_bytes(zoo, cfg, params, B, S + G)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    expert_ms = (4 * cfg.n_layers * 3 * mc.n_experts * cfg.d_model
                 * mc.d_ff_expert / HBM_BYTES_PER_S * 1e3)
    pre_bound_ms = prefill_ops(cfg, B, S) / FP32_OPS_PER_S * 1e3
    log(f"[serve] {cfg.name}: batch={B} prompt={S} gen={G}: prefill "
        f"{prefill_ms:.3f} ms device (beside {OLMOE_PREFILL_BEFORE_MS} ms "
        f"with the dispatch's data-dependent shapes; "
        f"{B * S / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s; its products' bound {pre_bound_ms:.3f} ms at "
        f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s float32), decode "
        f"{float(np.mean(decode_ms)):.3f} ms a step (median "
        f"{float(np.median(decode_ms)):.3f}, {G - 1} steps) beside its bound "
        f"{bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB a step at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the experts' weights alone "
        f"{expert_ms:.3f} ms), {host_s:.3f} s host for the request "
        f"({B * G / host_s:.1f} generated tokens/s); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[serve] {cfg.name} launches in the counted run: prefill "
        f"{pre_launches} flash (d={cfg.hd}), decode "
        f"{launches - pre_launches} flash")
    if pre_launches != n_attn or launches != pre_launches:
        fail(f"{cfg.name}: {pre_launches} flash launches in the prefill, "
             f"{launches} in all, expected {n_attn} and none in decode: the "
             "path did not go through the kernel")
    for i, lg in enumerate(step_logits):
        if not bool(torch.isfinite(lg).all()):
            fail(f"{cfg.name}: non-finite logits at step {i}")
    pad = step_logits[0][:, cfg.vocab:]
    if pad.numel() and not bool((pad == -2.0 ** 30).all()):
        fail(f"{cfg.name}: the padded vocabulary's logits are not -2^30")
    log(f"[serve] {cfg.name} sample generations (token ids): "
        f"{gen_toks[0, :16].tolist()}")
    routing = moe_lines(torch, cfg, recs, G - 1)
    del recs
    prof = phases.run("olmoe-profile-prefill", profile_kernels, torch,
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G),
                      f"{cfg.name} prefill")
    busy = sum(us for _, us in prof.values())
    phases.run("olmoe-profile-decode", profile_kernels, torch,
               lambda: zoo.decode_step(params, cfg, ctx, toks[-1], cache),
               f"{cfg.name} decode step")
    del step_logits, cache

    # the kernel at the path's shapes: layer 0's launch
    seen = phases.run("olmoe-record", record_launches, {"flash": fk},
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G))["flash"]
    if len(seen) != n_attn:
        fail(f"{cfg.name}: {len(seen)} recorded launches, expected {n_attn}")
    rows = phases.run("olmoe-flash-timing", flash_rows, torch, seen[:1], fk,
                      flash_attention_ref, PLAIN_FACTOR)
    del seen
    r = rows[0]
    r.update(launch=f"{cfg.name} layer0", model=cfg.name)
    if r["d"] != 128 or r["window"]:
        fail(f"{cfg.name}: a flash launch at d={r['d']}, window "
             f"{r['window']}")
    log(f"[check] {cfg.name} (a) the kernel on layer 0's prefill inputs "
        f"against the float64 plain version: |err|/max|v| "
        f"{r['rel_err']:.3g} (plain {r['plain_rel_err']:.3g})")
    flash_kinds(rows, f" {cfg.name}")
    log(f"[kernel] flash_attention {r['launch']} (window {r['window']}, "
        f"BH={r['BH']}, S={r['S']}, d={r['d']}, n_rep={r['n_rep']}): kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, SDPA "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; |err| "
        f"from float64: kernel {r['max_abs_err']:.3g}, plain "
        f"{r['plain_err']:.3g}, SDPA {r['library_err']:.3g}")

    # (b) and (c) in their moe forms
    checked = one_layer_stages(params, cfg)[:OLMOE_CHECK_LAYERS]
    with torch.no_grad():
        attn_b, moe_b = phases.run(
            "olmoe-kernels-vs-plain", moe_kernels_vs_plain, torch, cfg, zoo,
            tf, moe, params, prompts, checked)
        seq = torch.cat([prompts, gen_toks], dim=1)
        attn_c, kv_c, moe_c, n_pos = phases.run(
            "olmoe-decode-vs-forward", moe_decode_vs_forward, torch, cfg, zoo,
            tf, moe, params, seq, S, checked)
    log(f"[check] {cfg.name} (b) layers 0..{OLMOE_CHECK_LAYERS - 1}, each on "
        f"the kernel run's input: attention update, kernel vs plain, "
        + ", ".join(f"{e:.2g}" for e in attn_b) + f" (limit {LAYER_RTOL}); "
        "MoE half vs its float64 recomputation on the same idx and keep "
        + ", ".join(f"{e:.2g}" for e in moe_b) + f" (limit {MOE_RTOL})")
    log(f"[check] {cfg.name} (c) prefill + decode vs the no-cache forward "
        f"over {S + G} tokens, teacher-forced at {n_pos} positions: K/V ring "
        "buffers " + ", ".join(f"{e:.2g}" for e in kv_c)
        + f" (limit {KV_RTOL}); attention update "
        + ", ".join(f"{e:.2g}" for e in attn_c) + f" (limit {LAYER_RTOL}); "
        f"each decode step's MoE half (T={B}) vs float64 "
        + ", ".join(f"{e:.2g}" for e in moe_c) + f" (limit {MOE_RTOL}); "
        "whole-layer updates are not compared: a decode step's capacity "
        "(T=B) is not the forward's (T=B*S)")
    for name, errs, lim in (("(b) attention", attn_b, LAYER_RTOL),
                            ("(b) MoE half", moe_b, MOE_RTOL),
                            ("(c) K/V", kv_c, KV_RTOL),
                            ("(c) attention", attn_c, LAYER_RTOL),
                            ("(c) decode MoE half", moe_c, MOE_RTOL)):
        for li, e in enumerate(errs):
            if not e <= lim:
                fail(f"{cfg.name} layer {li}: {name} differs by {e:.3g} of "
                     f"its max (limit {lim})")
    del params, checked, seq
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "prefill_ms": prefill_ms,
            "prefill_bound_ms": pre_bound_ms,
            "decode_ms": float(np.mean(decode_ms)),
            "decode_bound_ms": bound_ms, "busy_ms": busy / 1e3,
            "peak_gib": peak / 2**30, "moe": routing}


# ---------------------------------------------------------------------------
# phase 15: Whisper-medium, the encoder and cross-attention
# ---------------------------------------------------------------------------

def whisper_prefill_ops(cfg, B, S):
    """Operations of one Whisper prefill: the encoder over B*enc_seq frames
    (q/k/v/o products, unmasked attention, the MLP), the decoder over B*S
    tokens (self-attention with causal pairs, the cross q/o products, the
    cross k/v products over the frames, unmasked cross-attention, the MLP)
    and the last position's logits."""
    D, H, K, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    Se = cfg.enc_seq
    Te, Td = B * Se, B * S

    def proj(T):
        return 4 * T * D * H * hd + 4 * T * D * K * hd
    enc = proj(Te) + 6 * Te * D * F + 4 * hd * Se * Se * B * H
    dec = (proj(Td) + 6 * Td * D * F + 4 * hd * (S * (S + 1) // 2) * B * H
           + 4 * Td * D * H * hd + 4 * Te * D * K * hd
           + 4 * hd * S * Se * B * H)
    return (cfg.n_enc_layers * enc + cfg.n_layers * dec
            + 2 * B * D * cfg.padded_vocab(1))


def whisper_decode_cost(zoo, cfg, params, B, ctx_len):
    """(operations, bytes) of one Whisper decode step: every decoder
    weight, the final norm, the output embedding, B rows of the input
    embedding, the K/V ring buffers of ``ctx_len`` slots and the encoder's
    output read once; the cross K/V recomputed from the encoder's output
    in every layer (as the reference does), the other products at B
    tokens, attention over the caches and the frames, the logits."""
    D, H, K, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    Se, L = cfg.enc_seq, cfg.n_layers
    layer = (8 * B * D * H * hd + 4 * B * D * K * hd + 6 * B * D * F
             + 4 * B * Se * D * K * hd + 4 * hd * (ctx_len + Se) * B * H)
    ops = L * layer + 2 * B * D * cfg.padded_vocab(1)
    n = sum(t.numel() for _, t in zoo._leaves(params["stages"]))
    n += params["final_norm"].numel() + params["out_embed"].numel()
    n += B * D + 2 * L * B * ctx_len * K * hd + B * Se * D
    return ops, 4 * n


def whisper_path(torch, np, args, dev, phases):
    """Phase 15: Whisper-medium at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of dim 64, d_ff 4096, 1500
    frames, vocab 51,865 padded to 51,968; float32, random weights from
    torch.Generator(seed) on the card) serves B=4 requests: 1500 frame
    embeddings (numpy normals, the reference's stub front end) and a
    prompt of WHISPER_PROMPT tokens each, prefill, then 63 greedy decode
    steps (448 positions: Whisper's decoder context), through
    model_zoo.prefill / decode_step.  Checks: (a) each of the four launch
    shapes (the encoder's unmasked 1500 x 1500, the decoder's causal
    self-attention, the prefill's cross-attention 384 x 1500 and a decode
    step's 1 x 1500) on layer 0's recorded inputs against the float64
    plain version, timed beside the plain version and SDPA; (b) encoder
    and decoder layers 0-3, kernels against the plain path on the same
    input; (c) prefill + decode against the no-cache forward on decoder
    layers 0-3, teacher-forced; (d) 72 flash launches a prefill (24
    encoder, 24 self, 24 cross) and 24 a decode step (cross; decode
    self-attention is the plain cached path); (e) finite logits, the 103
    padded vocabulary entries at -2^30.  Returns {"launches", "rows",
    "prefill_ms", "prefill_bound_ms", "decode_ms", "decode_bound_ms",
    "busy_ms", "decode_busy_ms", "peak_gib"}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import StageSpec

    cfg = get_config(WHISPER_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = phases.run("whisper-init", lambda: zoo.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(params)
    V, Vp, Se = cfg.vocab, cfg.padded_vocab(1), cfg.enc_seq
    log(f"[serve] {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv of dim {cfg.hd}, d_ff {cfg.d_ff}, {Se} frames, "
        f"vocab {V} (padded {Vp}: {Vp - V} pad logits a row); {n_par:,} "
        f"parameters float32 ({4 * n_par / 1e9:.2f} GB)")
    B, S, G = SERVE_BATCH, WHISPER_PROMPT, SERVE_GEN
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(
        rng.randint(0, V, (B, S)).astype(np.int32)).to(dev)
    frames = torch.from_numpy(
        rng.randn(B, Se, cfg.d_model).astype(np.float32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    n_pre = cfg.n_enc_layers + 2 * cfg.n_layers
    n_step = cfg.n_layers

    def prefill():
        return zoo.prefill(params, cfg, ctx, prompts, enc_embeds=frames,
                           max_len=S + G)

    def serve():
        with torch.no_grad():
            logits, cache = prefill()
            toks = [zoo.greedy(logits)]
            for _ in range(G - 1):
                logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache)
                toks.append(zoo.greedy(logits))
        return toks

    phases.run("whisper-warm", serve)
    torch.cuda.synchronize()
    counter = fk.flash_attention_bhsd
    counter.launches = 0                             # the path starts here
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    per_step = []
    t0 = time.perf_counter()
    with torch.no_grad():
        ev[0].record()
        logits, cache = prefill()
        ev[1].record()
        pre_launches = counter.launches
        step_logits, toks = [logits], [zoo.greedy(logits)]
        for i in range(G - 1):
            before = counter.launches
            logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1], cache)
            ev[i + 2].record()
            per_step.append(counter.launches - before)
            step_logits.append(logits)
            toks.append(zoo.greedy(logits))
        gen_toks = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = counter.launches                      # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G - 1)]
    pre_bound_ms = whisper_prefill_ops(cfg, B, S) / FP32_OPS_PER_S * 1e3
    d_ops, d_bytes = whisper_decode_cost(zoo, cfg, params, B, S + G)
    d_bound_ms = max(d_ops / FP32_OPS_PER_S, d_bytes / HBM_BYTES_PER_S) * 1e3
    log(f"[serve] {cfg.name}: batch={B} frames={Se} prompt={S} gen={G}: "
        f"prefill {prefill_ms:.3f} ms device ({B * S / prefill_ms * 1e3:.0f} "
        f"prompt tokens/s, {B * Se / prefill_ms * 1e3:.0f} frames/s; its "
        f"products' bound {pre_bound_ms:.3f} ms, "
        f"{whisper_prefill_ops(cfg, B, S) / 1e12:.3f} TFLOP at "
        f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s float32), decode "
        f"{float(np.mean(decode_ms)):.3f} ms a step (median "
        f"{float(np.median(decode_ms)):.3f}, {G - 1} steps) beside its bound "
        f"{d_bound_ms:.3f} ms ({d_ops / 1e12:.3f} TFLOP, the cross K/V "
        f"recomputed in every layer; {d_bytes / 1e9:.3f} GB read, "
        f"{d_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {host_s:.3f} s host for the "
        f"request ({B * G / host_s:.1f} generated tokens/s); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[serve] {cfg.name} launches in the counted run: prefill "
        f"{pre_launches} flash (d={cfg.hd}), decode {launches - pre_launches}"
        f" flash over {G - 1} steps ({min(per_step)}-{max(per_step)} a step)")
    if pre_launches != n_pre or any(n != n_step for n in per_step):
        fail(f"{cfg.name}: {pre_launches} flash launches in the prefill and "
             f"{sorted(set(per_step))} a decode step, expected {n_pre} and "
             f"{n_step}: the path did not go through the kernel")
    for i, lg in enumerate(step_logits):
        if not bool(torch.isfinite(lg).all()):
            fail(f"{cfg.name}: non-finite logits at step {i}")
        if not bool((lg[:, V:] == -2.0 ** 30).all()):
            fail(f"{cfg.name}: the padded vocabulary's logits are not -2^30 "
                 f"at step {i}")
    log(f"[serve] {cfg.name} sample generations (token ids): "
        f"{gen_toks[0, :16].tolist()}")
    prof = phases.run("whisper-profile-prefill", profile_kernels, torch,
                      prefill, f"{cfg.name} prefill")
    busy = sum(us for _, us in prof.values())
    prof_d = phases.run("whisper-profile-decode", profile_kernels, torch,
                        lambda: zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache),
                        f"{cfg.name} decode step")
    d_busy = sum(us for _, us in prof_d.values())
    del step_logits, cache

    # (a) the four launch shapes on layer 0's inputs
    def prefill_and_step():
        with torch.no_grad():
            lg, c = prefill()
            zoo.decode_step(params, cfg, ctx, zoo.greedy(lg), c)
    seen = phases.run("whisper-record", record_launches, {"flash": fk},
                      prefill_and_step)["flash"]
    if len(seen) != n_pre + n_step:
        fail(f"{cfg.name}: {len(seen)} recorded launches, expected "
             f"{n_pre + n_step}")
    ne = cfg.n_enc_layers
    picked = [("encoder layer0", seen[0]), ("decoder self layer0", seen[ne]),
              ("cross layer0", seen[ne + 1]),
              ("decode cross layer0", seen[n_pre])]
    del seen
    rows = phases.run("whisper-flash-timing", flash_rows, torch,
                      [launch for _, launch in picked], fk,
                      flash_attention_ref, PLAIN_FACTOR, unmasked=True)
    want = [(Se, Se, False), (S, S, True), (S, Se, False), (1, Se, False)]
    for (name, _), r, (sq, sk, causal) in zip(picked, rows, want):
        r.update(launch=f"{cfg.name} {name}", model=cfg.name)
        if (r["S"], r["Sk"], r["causal"], r["window"], r["d"]) != (
                sq, sk, causal, 0, cfg.hd):
            fail(f"{cfg.name} {name}: a launch of Sq={r['S']}, Sk={r['Sk']}, "
                 f"causal {r['causal']}, window {r['window']}, d={r['d']}; "
                 f"expected Sq={sq}, Sk={sk}, causal {causal}")
        log(f"[kernel] flash_attention {r['launch']} (BH={r['BH']}, Sq="
            f"{r['S']}, Sk={r['Sk']}, "
            f"{'causal' if r['causal'] else 'unmasked'}, d={r['d']}): kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['ops'] / 1e9:.2f} GFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB); bound/kernel "
            f"{r['bound_ms'] / r['ms']:.3f}; |err| from float64: kernel "
            f"{r['max_abs_err']:.3g}, plain {r['plain_err']:.3g}, SDPA "
            f"{r['library_err']:.3g}")
    log(f"[check] {cfg.name} (a) the four launch shapes on layer 0's inputs "
        "against the float64 plain version: |err|/max|v| "
        + ", ".join(f"{r['rel_err']:.3g} (plain {r['plain_rel_err']:.3g})"
                    for r in rows)
        + f"; limits: the larger of {FLASH_F32_TOL} and {PLAIN_FACTOR} x the "
        "plain version's")

    # (b) encoder and decoder layers 0-3, kernels vs plain
    enc_sp = params["enc"]["stages"][0]["layers"]
    enc_layers = [(StageSpec("enc", 1), {"layers": _slice_tree(enc_sp, i)})
                  for i in range(WHISPER_CHECK_LAYERS)]
    dec_layers = one_layer_stages(params, cfg)[:WHISPER_CHECK_LAYERS]
    with torch.no_grad():
        enc_out = zoo._run_encoder(params, cfg, ctx, frames)
        worst_e, _ = phases.run(
            "whisper-encoder-vs-plain", per_layer_kernels_vs_plain, torch,
            cfg, zoo, tf, params, prompts, enc_layers, h=frames,
            tag=f" {cfg.name} encoder")
        worst_d, _ = phases.run(
            "whisper-decoder-vs-plain", per_layer_kernels_vs_plain, torch,
            cfg, zoo, tf, params, prompts, dec_layers, enc_out=enc_out,
            tag=f" {cfg.name} decoder")
        seq = torch.cat([prompts, gen_toks], dim=1)
        worst_c, logit_c, n_pos = phases.run(
            "whisper-decode-vs-forward", per_layer_decode_vs_forward, torch,
            cfg, zoo, tf, params, seq, S, dec_layers, enc_out=enc_out)
    log(f"[check] {cfg.name} (b) layers 0..{WHISPER_CHECK_LAYERS - 1}, "
        f"kernels vs plain on the same input: encoder {worst_e:.3g}, decoder "
        f"(self- and cross-attention) {worst_d:.3g} of the update's max "
        f"(limit {LAYER_RTOL})")
    log(f"[check] {cfg.name} (c) prefill + decode vs the no-cache forward "
        f"over {S + G} tokens on decoder layers 0..{WHISPER_CHECK_LAYERS - 1}"
        f", teacher-forced at {n_pos} positions: max |update error| "
        f"{worst_c:.3g} (limit {LAYER_RTOL}); logits through layer "
        f"{WHISPER_CHECK_LAYERS - 1} {logit_c:.3g} of max (limit "
        f"{LOGIT_RTOL})")
    del params, enc_out, seq, frames
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_prefill": pre_launches,
            "launches_decode": launches - pre_launches, "rows": rows,
            "prefill_ms": prefill_ms, "prefill_bound_ms": pre_bound_ms,
            "decode_ms": float(np.mean(decode_ms)),
            "decode_bound_ms": d_bound_ms, "busy_ms": busy / 1e3,
            "decode_busy_ms": d_busy / 1e3, "host_s": host_s,
            "tokens_per_s": B * G / host_s, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# phase 14: moe_ffn_ep on spawned ranks
# ---------------------------------------------------------------------------

def moe_spawns(count: int):
    """Phase 14's spawn: (backend, world size): NCCL with a card a rank
    where the machine has MOE_EP_RANKS cards, else gloo with every rank on
    cuda:0 (gloo stages each collective through the host)."""
    return ("nccl" if count >= MOE_EP_RANKS else "gloo"), MOE_EP_RANKS


def moe_layer(torch, mcfg, d_model, seed, dev):
    """One MoE layer's weights at full width (the init recipe: normal /
    sqrt(shape[-2])), the mirrored copies tied to experts 0-1, and
    MOE_EP_TOKENS unit-variance tokens, from torch.Generator(seed) on
    ``dev``."""
    import math
    g = torch.Generator(dev).manual_seed(seed)
    D, E, F = d_model, mcfg.n_experts, mcfg.d_ff_expert

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev) / math.sqrt(
            shape[-2])
    w = {"router": normal((D, E)), "w_gate": normal((E, D, F)),
         "w_up": normal((E, D, F)), "w_down": normal((E, F, D))}
    for n in ("w_gate", "w_up", "w_down"):
        w[n + "_m"] = w[n][:2]
    return w, torch.randn((MOE_EP_TOKENS, D), generator=g, device=dev)


def moe_rank_reference(torch, moe, xs, w, mcfg):
    """One device's computation of a rank's token slice under the rank's
    semantics: its cap (from its T_loc), the same mirror mask, the
    combined buffer through all E experts, and the mirrored experts
    dense-gated (the port's _pack, _expert_mlp and _unpack)."""
    T, D = xs.shape
    E, k, n_m = mcfg.n_experts, mcfg.top_k, mcfg.n_mirrored_experts
    cap = max(1, int(mcfg.capacity_factor * T * k / E))
    gates, idx, _ = moe.router_probs(xs, w["router"], k)
    mirrored = torch.arange(E, device=xs.device) < n_m
    buf, bg, bt = moe._pack(xs, idx, gates, E, cap, mirrored)
    out = moe._unpack(moe._expert_mlp(buf, w["w_gate"], w["w_up"],
                                      w["w_down"]), bg, bt, T, D)
    for j in range(n_m):
        g = ((idx == j) * gates).sum(-1)
        out = out + moe._expert_mlp(xs, w["w_gate_m"][j], w["w_up_m"][j],
                                    w["w_down_m"][j]) * g[:, None]
    return out


def moe_rank(rank, D, backend, init_method, seed, out_path):
    """One rank of phase 14: joins the group, builds the layer from
    ``seed``, runs moe_ffn_ep on its token slice with n_mirrored_experts
    0 and 2, then the same slice on its device alone (and, unmirrored,
    moe_ffn_ref); writes its errors and routing counts."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=D, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        cfg = get_config(OLMOE_ARCH)
        w, x = moe_layer(torch, cfg.moe, cfg.d_model, seed, dev)
        ctx = moe.ep_context(1, D)
        T_loc = x.shape[0] // D
        xs = x[rank * T_loc:(rank + 1) * T_loc]
        out = {"rank": rank, "T_loc": T_loc}
        with torch.no_grad():
            for n_m in MOE_EP_MIRRORED:
                mcfg = dataclasses.replace(cfg.moe, n_mirrored_experts=n_m)
                moe.moe_ffn_ep(xs, w, mcfg, ctx)        # warm
                torch.cuda.synchronize()
                moe.record = []
                try:
                    t0 = time.perf_counter()
                    y, aux = moe.moe_ffn_ep(xs, w, mcfg, ctx)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    rec, = moe.record
                finally:
                    moe.record = None
                want = moe_rank_reference(torch, moe, xs, w, mcfg)
                # the record's aux is the rank's own; "aux" the returned
                # mean over the ranks
                res = {**{k: (v.cpu().tolist() if torch.is_tensor(v) else v)
                          for k, v in rec.items() if k != "aux"},
                       "err": rel_max(torch, y, want), "aux": float(aux),
                       "aux_local": float(rec["aux"]), "wall_s": wall,
                       "finite": bool(torch.isfinite(y).all())}
                if n_m == 0:
                    res["err_ref"] = rel_max(
                        torch, y, moe.moe_ffn_ref(xs, w, mcfg)[0])
                out[n_m] = res
        out["grad"] = moe_rank_backward(torch, dist, moe, cfg, w, x, ctx,
                                        rank, D, seed, dev)
        Path(f"{out_path}.{rank}").write_bytes(pickle.dumps(out))
    finally:
        meshlib.destroy()


def moe_rank_backward(torch, dist, moe, cfg, w, x, ctx, rank, D, seed, dev):
    """Phase 14's backward: moe_ffn_ep on this rank's first EP_GRAD_TOKENS
    tokens, unmirrored, at the capacity of the largest expert load of any
    rank (no drops, so expert parallelism computes moe_ffn_ref's function
    on all the ranks' tokens); the gradient of sum(y * cot) with respect
    to x, the router and the experts, against moe_ffn_ref's autograd on
    the ranks' tokens together on this device.  The rank's expert rows
    are compared (the others must be zero), the router's gradient after a
    sum over the ranks (each routed its own tokens).  Returns the errors
    (of each leaf's max)."""
    import dataclasses
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T_loc = x.shape[0] // D
    Tb = min(EP_GRAD_TOKENS, T_loc)
    xs = x[rank * T_loc:rank * T_loc + Tb]
    _, idx, _ = moe.router_probs(xs, w["router"], k)
    peak = torch.bincount(idx.reshape(-1), minlength=E).max().reshape(1)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    mcfg = dataclasses.replace(
        cfg.moe, n_mirrored_experts=0,
        capacity_factor=(int(peak) + 0.5) * E / (Tb * k))
    names = ("router", "w_gate", "w_up", "w_down")
    g = torch.Generator(dev).manual_seed(seed + 1)
    cot = torch.randn((D * Tb, x.shape[1]), generator=g, device=dev)

    def grads(x_in, fn):
        wl = {n: w[n].detach().clone().requires_grad_(True) for n in names}
        wl.update({n + "_m": w[n + "_m"] for n in names[1:]})
        xl = x_in.detach().clone().requires_grad_(True)
        y, c = fn(xl, wl)
        return torch.autograd.grad((y * c).sum(), [xl] + [wl[n]
                                                          for n in names])
    t0 = time.perf_counter()
    got = grads(xs, lambda xl, wl: (moe.moe_ffn_ep(xl, wl, mcfg, ctx)[0],
                                    cot[rank * Tb:(rank + 1) * Tb]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router = got[1].clone()
    dist.all_reduce(router)
    x_all = torch.cat([x[r * T_loc:r * T_loc + Tb] for r in range(D)])
    want = grads(x_all, lambda xl, wl: (moe.moe_ffn_ref(xl, wl, mcfg)[0],
                                        cot))
    e_loc = E // D
    lo = rank * e_loc
    errs = {"x": rel_max(torch, got[0], want[0][rank * Tb:(rank + 1) * Tb]),
            "router": rel_max(torch, router, want[1])}
    outside = 0.0
    for n, gl, wl in zip(names[1:], got[2:], want[2:]):
        errs[n] = rel_max(torch, gl[lo:lo + e_loc], wl[lo:lo + e_loc])
        rest = torch.cat([gl[:lo], gl[lo + e_loc:]])
        outside = max(outside, float(rest.abs().max()) if rest.numel()
                      else 0.0)
    return {"errs": errs, "outside": outside, "tokens": Tb,
            "cap": int(peak), "wall_s": wall,
            "nonzero": all(float(t.abs().max()) > 0 for t in got)}


def moe_ep_path(seed):
    """Phase 14: moe_ffn_ep over MOE_EP_RANKS spawned ranks on one
    full-width OLMoE MoE layer (E=64, D=2048, F=1024) at MOE_EP_TOKENS
    tokens.  Gates: every rank's output within EP_RTOL of its slice on one
    device under the rank's own cap and mirror mask (unmirrored: of
    moe_ffn_ref on the slice), finite, every rank's aux the same; the
    mirrored run's occupied send-buffer rows fewer than the unmirrored
    run's by exactly the pairs that run kept for experts 0-1.  Prints the
    occupied rows against the buffer's E*cap, the bytes each all_to_all
    moves (the buffer's static shape: the same with mirroring) and
    moe_mirror_threshold at these shapes with the card's ratio."""
    import pickle
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.cost_model import moe_mirror_threshold
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    backend, D = moe_spawns(torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(moe_rank, (D, backend, rendezvous(tmp), seed,
                               str(Path(tmp) / "rank")), D, MOE_JOIN_S)
        wall = time.perf_counter() - t0
        outs = [pickle.loads((Path(tmp) / f"rank.{r}").read_bytes())
                for r in range(D)]
    cfg = get_config(OLMOE_ARCH)
    Dm, F = cfg.d_model, cfg.moe.d_ff_expert
    fpb = FP32_OPS_PER_S / HBM_BYTES_PER_S
    summary = {"backend": backend, "D": D, "wall_s": wall, "ranks": []}
    for o in outs:
        plain, mirr = o[0], o[2]
        for n_m in MOE_EP_MIRRORED:
            res = o[n_m]
            if not (res["finite"] and res["err"] <= EP_RTOL
                    and res.get("err_ref", 0.0) <= EP_RTOL):
                fail(f"[moe-ep] rank {o['rank']} n_m={n_m}: |y - one "
                     f"device| {res['err']:.3g} (moe_ffn_ref "
                     f"{res.get('err_ref', 0.0):.3g}) of max, finite "
                     f"{res['finite']} (limit {EP_RTOL})")
            if res["aux"] != outs[0][n_m]["aux"]:
                fail(f"[moe-ep] n_m={n_m}: rank {o['rank']}'s aux "
                     f"{res['aux']} differs from rank 0's")
        gone = sum(plain["kept"][:2])
        if mirr["occupied"] != plain["occupied"] - gone:
            fail(f"[moe-ep] rank {o['rank']}: {mirr['occupied']} occupied "
                 f"rows mirrored, {plain['occupied']} unmirrored, whose "
                 f"experts 0-1 kept {gone} pairs")
        wire = plain["rows"] * Dm * 4
        thr = moe_mirror_threshold(o["T_loc"], D, Dm, F, flops_per_byte=fpb)
        thr_ref = moe_mirror_threshold(o["T_loc"], D, Dm, F)
        hot = max(plain["load"])
        log(f"[moe-ep] rank {o['rank']} ({backend}, {D} ranks, T_loc "
            f"{o['T_loc']}, cap {plain['cap']}): send buffer {plain['rows']} "
            f"rows (E*cap), occupied {plain['occupied']} unmirrored, "
            f"{mirr['occupied']} with experts 0-1 mirrored ({gone} pairs "
            f"served locally); each all_to_all moves {wire / 2**20:.1f} MiB "
            "a rank either way (the buffer's static shape: the same "
            f"mirrored); |y - one device| {plain['err']:.3g} / "
            f"{mirr['err']:.3g} (moe_ffn_ref {plain['err_ref']:.3g}); "
            f"hottest expert {hot} pairs against moe_mirror_threshold "
            f"{thr:.1f} at flops_per_byte {fpb:.1f} (the card's float32 "
            f"ratio; {thr_ref:.1f} at the reference's default 240); step "
            f"{plain['wall_s'] * 1e3:.1f} / {mirr['wall_s'] * 1e3:.1f} ms "
            "host clock"
            + (" (gloo stages through the host)" if backend == "gloo" else ""))
        summary["ranks"].append({
            "rank": o["rank"], "rows": plain["rows"],
            "occupied": plain["occupied"],
            "occupied_mirrored": mirr["occupied"],
            "err": max(plain["err"], mirr["err"]), "threshold": thr,
            "hottest": hot})
    for o in outs:
        bw = o["grad"]
        worst = max(bw["errs"].values())
        if not (worst <= EP_GRAD_RTOL and bw["outside"] == 0.0
                and bw["nonzero"]):
            fail(f"[moe-ep] rank {o['rank']}: the backward's gradients "
                 f"against moe_ffn_ref's autograd {bw['errs']} of each "
                 f"leaf's max (limit {EP_GRAD_RTOL}), other ranks' expert "
                 f"rows {bw['outside']} (must be 0), every gradient nonzero "
                 f"{bw['nonzero']}")
        log(f"[moe-ep] rank {o['rank']} backward ({bw['tokens']} tokens, cap "
            f"{bw['cap']}: no drops): |grad - moe_ffn_ref autograd| of each "
            "leaf's max: " + ", ".join(f"{n} {e:.3g}" for n, e in
                                       bw["errs"].items())
            + f" (the router without the aux term, summed over the ranks); "
            f"forward and backward {bw['wall_s'] * 1e3:.1f} ms host clock")
        summary["ranks"][outs.index(o)]["grad_err"] = worst
    log(f"[check] moe_ffn_ep on {D} spawned ranks ({backend}) == one device "
        f"under each rank's cap and mirror mask (limit {EP_RTOL}); mirroring "
        "experts 0-1 removes exactly their kept pairs from every send "
        f"buffer; its backward == moe_ffn_ref's autograd (limit "
        f"{EP_GRAD_RTOL}); {wall:.1f} s of spawned program")
    return summary


# ---------------------------------------------------------------------------
# phase 9: the resident graph service
# ---------------------------------------------------------------------------

def min_adjacency(np, g):
    """scipy's float64 adjacency with the least weight of parallel edges
    (a fold may add an edge that exists)."""
    import scipy.sparse as sp
    key = g.src.astype(np.int64) * g.n + g.dst
    order = np.argsort(key, kind="stable")
    k = key[order]
    heads = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    w = np.minimum.reduceat(g.weight[order].astype(np.float64), heads)
    return sp.csr_matrix((w, (k[heads] // g.n, k[heads] % g.n)),
                         shape=(g.n, g.n))


def service_oracles(np, g, results, alpha, iters, tag):
    """Hold every answer of ``results`` to scipy / float64 numpy on ``g``:
    SSSP to Dijkstra (rtol SERVICE_SSSP_RTOL, the same unreachable set),
    PPR to a float64 power iteration (atol SERVICE_PPR_ATOL), ego to
    connected_components (root the least original id, size exact)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    A = min_adjacency(np, g)
    by = {k: sorted({r.query.source for r in results if r.query.kind == k})
          for k in ("sssp", "ppr", "ego")}
    want = {}
    if by["sssp"]:
        d = csgraph.dijkstra(A, directed=True, indices=by["sssp"])
        want.update({("sssp", s): d[j] for j, s in enumerate(by["sssp"])})
    if by["ppr"]:
        deg = np.bincount(g.src, minlength=g.n).astype(np.float64)
        P = sp.csr_matrix((np.ones(g.m), (g.dst, g.src)), shape=(g.n, g.n))
        X = np.zeros((g.n, len(by["ppr"])))
        X[by["ppr"], np.arange(len(by["ppr"]))] = 1.0
        R = X.copy()
        for _ in range(iters):
            contrib = np.where(deg[:, None] > 0,
                               X / np.maximum(deg, 1)[:, None], 0.0)
            X = alpha * R + (1 - alpha) * (P @ contrib)
        want.update({("ppr", s): X[:, j] for j, s in enumerate(by["ppr"])})
    _, cc = csgraph.connected_components(A, directed=True,
                                         connection="weak")
    rep = np.full(cc.max() + 1, g.n, np.int64)
    np.minimum.at(rep, cc, np.arange(g.n))
    size = np.bincount(cc)
    worst = {"sssp": 0.0, "ppr": 0.0}
    for r in results:
        k, s = r.query.kind, r.query.source
        if k == "ego":
            exp = (int(rep[cc[s]]), int(size[cc[s]]))
            if r.value != exp:
                fail(f"[service] {tag}: ego({s}) {r.value} != {exp}")
            continue
        got, exp = np.asarray(r.value, np.float64), want[(k, s)]
        if k == "sssp":
            if not (np.array_equal(np.isinf(got), np.isinf(exp))
                    and np.allclose(got, exp, rtol=SERVICE_SSSP_RTOL,
                                    atol=0.0)):
                fail(f"[service] {tag}: sssp({s}) differs from Dijkstra")
            fin = np.isfinite(exp) & (exp > 0)
            worst[k] = max(worst[k], float(np.max(
                np.abs(got[fin] - exp[fin]) / exp[fin], initial=0.0)))
        else:
            err = float(np.abs(got - exp).max())
            if not err <= SERVICE_PPR_ATOL:
                fail(f"[service] {tag}: ppr({s}) |err| {err:.3g} > "
                     f"{SERVICE_PPR_ATOL}")
            worst[k] = max(worst[k], err)
    return worst


def service_program(torch, svc, batch, delta, probe):
    """The client program of phase 9, the same on every rank: the mixed
    batch, a fold of ``delta`` and probe + batch at epoch 1.  Returns
    (pre answers, post answers, readings); the fold + reshard that the
    second pump makes before it serves is timed on its own (the epoch
    barrier)."""
    from repro_torch.core.service import GraphClient
    client = GraphClient(svc)
    out = {}
    pre, out["pre_ms"], out["pre_s"] = timed(torch,
                                             lambda: client.request(batch))
    out["pre_pump"], out["pre_batch"] = dict(svc.last_pump), dict(
        svc.last_batch)
    fold = svc._fold_pending

    def barrier():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold()
        torch.cuda.synchronize()
        out["barrier_s"] = time.perf_counter() - t0
    svc._fold_pending = barrier
    try:
        svc.mutate(delta)
        post, out["post_ms"], out["post_s"] = timed(
            torch, lambda: client.request(probe + batch))
    finally:
        del svc._fold_pending
    out["post_pump"], out["post_batch"] = dict(svc.last_pump), dict(
        svc.last_batch)
    return pre, post, out


def doubling_delta(np, g, seed):
    """As many new random edges as ``g`` has, both directions: a fold that
    outgrows any profile of slack below 2."""
    from repro_torch.graph import structs
    rng = np.random.RandomState(seed)
    a_s = rng.randint(0, g.n, size=g.m)
    a_d = rng.randint(1, g.n, size=g.m)
    keep = a_s != a_d
    return structs.EdgeDelta(
        add_src=a_s[keep], add_dst=a_d[keep],
        add_w=rng.rand(int(keep.sum())).astype(np.float32) + 0.01
    ).symmetrized()


def service_scenarios(torch, np, g, sa, dev, devices, oracles=False):
    """Phase 9's repartition and overflow programs on the phase's graph,
    each on a new service over the default group of world size
    ``devices`` (bucket 4, PPR 6 iterations): the elastic repartition
    (``rebalance_threshold`` 1.0: every served batch repartitions) with a
    batch, a 5% churn fold and another batch; the profile overflow
    (``profile_slack`` 1.01) with a fold that doubles the edge count and
    a batch.  ``oracles`` holds every answer to scipy / float64 on the
    graph it was served on.  Returns each program's answers, repartition
    and executor counts, whether the profile was frozen again, the epoch
    and its seconds."""
    from repro_torch.api import EngineConfig
    from repro_torch.core.service import GraphClient, GraphService, Query
    from repro_torch.graph import structs
    from repro_torch.launch import serve_graph as sgl
    cfg = EngineConfig(layout="csr", balance="edges", devices=devices)
    cases = {
        "repartition": (dict(rebalance_threshold=1.0),
                        [Query("sssp", 0), Query("ppr", 7)],
                        sgl.churn_delta(g, 0.05, sa.seed + 21),
                        [Query("sssp", 12), Query("ppr", 29),
                         Query("ego", 4)]),
        "overflow": (dict(profile_slack=1.01), [],
                     doubling_delta(np, g, sa.seed + 9),
                     [Query("sssp", 3), Query("ppr", 8), Query("ego", 3)])}
    out = {}
    for name, (kw, first, delta, second) in cases.items():
        t0 = time.perf_counter()
        svc = GraphService(g, M=sa.workers, config=cfg, buckets=(4,),
                           ppr_iters=6, seed=sa.seed, device=dev, **kw)
        svc.warmup()
        client = GraphClient(svc)
        warm, prof0 = svc.traces, svc.profile
        a = client.request(first)
        reps = svc.repartitions
        svc.mutate(delta)
        b = client.request(second)
        torch.cuda.synchronize()
        if oracles:
            service_oracles(np, g, a, svc.ppr_alpha, 6, f"{name} before")
            service_oracles(np, svc.snapshot_graph(), b, svc.ppr_alpha, 6,
                            f"{name} after the fold")
        out[name] = {"first": answers_of(a), "second": answers_of(b),
                     "first_repartitions": reps,
                     "repartitions": svc.repartitions, "warm_traces": warm,
                     "traces": svc.traces,
                     "refrozen": svc.profile != prof0, "epoch": svc.epoch,
                     "seconds": time.perf_counter() - t0}
        del svc, client
    return out


def scenario_gates(out, tag):
    """What each scenario must show at any world size: the repartition
    ran on the first batch and rebuilt nothing; the overflow froze a new
    profile and rebuilt the bucket's executor and the component program;
    both end at epoch 1."""
    rp, ov = out["repartition"], out["overflow"]
    if not rp["first_repartitions"] >= 1:
        fail(f"[service] {tag}: the repartition did not trigger")
    if rp["traces"] != rp["warm_traces"]:
        fail(f"[service] {tag}: the repartition rebuilt executors "
             f"({rp['warm_traces']} -> {rp['traces']})")
    if not ov["refrozen"] or ov["traces"] != ov["warm_traces"] + 2:
        fail(f"[service] {tag}: the overflow froze a new profile: "
             f"{ov['refrozen']}, executors {ov['warm_traces']} -> "
             f"{ov['traces']} (want +2)")
    if rp["epoch"] != 1 or ov["epoch"] != 1:
        fail(f"[service] {tag}: epochs {rp['epoch']}, {ov['epoch']} != 1")


def same_answers(np, want, got, tag):
    """``got`` equals ``want`` (answers_of lists): kind, source, epoch
    and cached flag; SSSP and ego bitwise, PPR within SERVICE_PPR_RTOL of
    its max.  Returns the worst PPR difference."""
    if len(want) != len(got):
        fail(f"[service] {tag}: {len(got)} answers, want {len(want)}")
    worst = 0.0
    for (k, s, e, c, v), (k2, s2, e2, c2, v2) in zip(want, got):
        if (k, s, e, c) != (k2, s2, e2, c2):
            fail(f"[service] {tag}: answer {(k2, s2, e2, c2)} where world "
                 f"size 1 gave {(k, s, e, c)}")
        if k == "ppr":
            err = float(np.abs(np.asarray(v2) - v).max()) / max(
                float(np.abs(v).max()), 1e-30)
            worst = max(worst, err)
            ok = err <= SERVICE_PPR_RTOL
        elif k == "sssp":
            ok = np.array_equal(v2, v)
        else:
            ok = v2 == v
        if not ok:
            fail(f"[service] {tag}: {k}({s}) differs from world size 1")
    return worst


def service_path(torch, np, args, dev, phases, spawned_ranks):
    """Phase 9: the resident graph service at serve_graph's defaults
    (powerlaw n=200k, avg_deg 8, weighted, symmetrized; M=32, csr,
    balance edges, buckets 4/16/64, PPR 20 iterations) on an in-process
    NCCL group of world size 1: boot and warm, the 64-query mixed batch,
    a 1% churn fold and the 64 queries plus three probes at epoch 1.
    Gates: every answer before and after the fold against scipy / float64
    oracles, the post-fold probes against a fresh partition() of the
    mutated graph, the executor counter flat across the batch and the
    fold, the tables' storage kept, epoch 1 with no answer straddling the
    fold, no kernel launched (the service runs backend "dense"); then
    the same program on SERVICE_RANKS spawned ranks (``spawned_ranks``,
    ``service_ranks_run``'s result, run earlier beside a host-only phase)
    must give world size 1's answers and statistics."""
    import datetime
    import torch.distributed as dist
    from repro_torch.api import Engine, EngineConfig
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.service import GraphService, Query
    from repro_torch.graph import generators as gen
    from repro_torch.graph import structs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.segment_combine import kernel as sc
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve_graph as sgl

    sa = sgl.build_parser().parse_args(["--seed", str(args.seed)])
    g = phases.run("service-graph", lambda: gen.powerlaw(
        sa.n, avg_deg=sa.avg_deg, seed=sa.seed, weighted=True).symmetrized())
    batch = sgl.mixed_batch(g.n, sa.batch, sa.seed)
    delta = sgl.churn_delta(g, sa.churn, sa.seed)
    probe = [Query("sssp", 17), Query("ppr", 23), Query("ego", 5)]
    counters = (sc.segment_combine_blocks, fk.flash_attention_bhsd,
                sk.ssd_chunk_scan)
    cfg = EngineConfig(layout="csr", balance="edges", devices=1)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        svc = GraphService(g, M=sa.workers, config=cfg, buckets=sa.buckets,
                           ppr_iters=sa.ppr_iters, seed=sa.seed, device=dev)
        boot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        traces = svc.traces
        ptrs = {k: t.data_ptr() for k, t in exec_mod._tensors(svc.sg)}
        log(f"[service] boot: n={g.n} m={g.m} M={sa.workers} tau="
            f"{svc.pg.tau} on {dev}: partition + profile + tables "
            f"{boot_s:.3f} s host; warmup {warm_s:.3f} s ({traces} "
            f"executors: buckets {svc.buckets} + components); the rank's "
            f"tables {svc.sg.table_bytes() / 2**20:.1f} MiB; profile "
            f"{svc.profile}")
        pg0 = svc.pg
        for c in counters:
            c.launches = 0                           # the path starts here
        pre, post, rd = phases.run("service-batches", service_program,
                                   torch, svc, batch, delta, probe)
        launched = [c.launches for c in counters]    # ... and ends here
        peak = torch.cuda.max_memory_allocated() - base
        lp, lb = rd["pre_pump"], rd["pre_batch"]
        if svc.traces != traces:
            fail(f"[service] {svc.traces - traces} executors built after "
                 "warmup (batch or fold)")
        if lp["slices"] != 1:
            fail(f"[service] the 64-query batch took {lp['slices']} runs")
        if svc.epoch != 1 or any(r.epoch != 1 for r in post) or any(
                r.epoch != 0 for r in pre):
            fail("[service] an answer straddled the fold")
        if ptrs != {k: t.data_ptr() for k, t in exec_mod._tensors(svc.sg)}:
            fail("[service] the fold moved the resident tables")
        if any(launched):
            fail(f"[service] launches (scalar, flash, SSD) {launched}: the "
                 "dense service launches no kernel")
        n_q = len(batch)
        log(f"[service] batch of {n_q} (sssp={lp['lanes_sssp']} ppr="
            f"{lp['lanes_ppr']} ego={sum(q.kind == 'ego' for q in batch)}): "
            f"{rd['pre_s'] * 1e3:.3f} ms host, {rd['pre_ms']:.3f} ms device "
            f"(CUDA events), {lp['n_supersteps']} supersteps (bucket "
            f"{lb['bucket']}, {lp['slices']} run), "
            f"{rd['pre_s'] * 1e3 / n_q:.3f} ms a query; msgs_total "
            f"{int(lb['stats']['msgs_total']):,d}")
        t0 = time.perf_counter()
        structs.fold_delta(pg0, delta)
        fold_s = time.perf_counter() - t0
        g2 = svc.snapshot_graph()
        t0 = time.perf_counter()
        pg2 = structs.partition(g2, sa.workers, tau=svc.pg.tau, seed=sa.seed,
                                layout="csr", balance="edges", device="cpu")
        full_s = time.perf_counter() - t0
        pp = rd["post_pump"]
        log(f"[service] fold of {len(delta.rem_src):,d} removals + "
            f"{len(delta.add_src):,d} adds: fold_delta {fold_s * 1e3:.3f} ms"
            f" vs partition(apply_delta(...)) {full_s * 1e3:.3f} ms on the "
            f"host ({full_s / fold_s:.2f}x); epoch barrier (fold + reshard "
            f"in place) {rd['barrier_s']:.3f} s; then {len(post)} queries "
            f"in {rd['post_s'] * 1e3:.3f} ms host, {rd['post_ms']:.3f} ms "
            f"device (barrier included), {pp['n_supersteps']} supersteps in "
            f"{pp['slices']} run(s), epoch {svc.epoch}")
        log(f"[service] peak device memory {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB held before the phase; launches "
            f"(scalar, flash, SSD) {launched}")
        w_pre = service_oracles(np, g, pre, svc.ppr_alpha, sa.ppr_iters,
                                "before the fold")
        w_post = service_oracles(np, g2, post, svc.ppr_alpha, sa.ppr_iters,
                                 "after the fold")
        eng = Engine(cfg, device=dev)
        want = eng.run("sssp", pg2, source=int(pg2.perm[17])).state
        want = want.cpu().numpy().reshape(-1)[pg2.perm]
        if not np.allclose(post[0].value, want, equal_nan=True):
            fail("[service] sssp(17) after the fold differs from the fresh "
                 "partition's run")
        roots = structs.canonical_labels(pg2, eng.run("hashmin", pg2).state)
        sizes = np.bincount(roots, minlength=g2.n)
        for r in post:
            if r.query.kind == "ego" and r.value != (
                    int(roots[r.query.source]),
                    int(sizes[roots[r.query.source]])):
                fail(f"[service] ego({r.query.source}) after the fold "
                     "differs from the fresh partition's Hash-Min")
        log(f"[check] service before and after the fold: sssp within rtol "
            f"{SERVICE_SSSP_RTOL} of Dijkstra (max rel {w_pre['sssp']:.3g} /"
            f" {w_post['sssp']:.3g}), ppr within {SERVICE_PPR_ATOL} of the "
            f"float64 power iteration (max |err| {w_pre['ppr']:.3g} / "
            f"{w_post['ppr']:.3g}), ego exact against connected_components;"
            " post-fold probes equal a fresh partition()'s Engine runs; "
            f"executors {traces} before and after; tables kept in place")
        extra = sgl.mixed_batch(g.n, sa.batch, sa.seed + 2)

        def serve_extra():
            svc.submit(extra)
            svc.pump()
            return types.SimpleNamespace(
                n_supersteps=svc.last_pump["n_supersteps"])
        phases.run("profile-service", profile_run, torch, serve_extra,
                   "service batch of 64 new queries")
        one = {"pre": answers_of(pre), "post": answers_of(post),
               "pre_stats": lb["stats"], "post_stats": rd["post_batch"]["stats"]}
        del svc
        for c in counters:
            c.launches = 0
        scen = phases.run("service-scenarios", service_scenarios, torch, np,
                          g, sa, dev, 1, oracles=True)
        if any(c.launches for c in counters):
            fail("[service] the scenarios launched a kernel")
        scenario_gates(scen, "world size 1")
        one["scenarios"] = scen
        rp, ov = scen["repartition"], scen["overflow"]
        log(f"[service] repartition program: {rp['repartitions']} "
            f"repartitions ({rp['first_repartitions']} on the first batch), "
            f"executors {rp['warm_traces']} -> {rp['traces']}, "
            f"{rp['seconds']:.3f} s; overflow program: profile frozen "
            f"again {ov['refrozen']}, executors {ov['warm_traces']} -> "
            f"{ov['traces']}, {ov['seconds']:.3f} s; every answer against "
            "scipy / float64 oracles OK")
    finally:
        meshlib.destroy()
    torch.cuda.empty_cache()
    spawned = service_many(np, one, spawned_ranks)
    return {"boot_s": boot_s, "warm_s": warm_s, "traces": traces,
            "batch_ms_host": rd["pre_s"] * 1e3, "batch_ms_device":
            rd["pre_ms"], "supersteps": lp["n_supersteps"],
            "ms_a_query": rd["pre_s"] * 1e3 / n_q, "fold_ms": fold_s * 1e3,
            "full_partition_ms": full_s * 1e3,
            "barrier_s": rd["barrier_s"], "post_ms_host": rd["post_s"] * 1e3,
            "peak_gib": peak / 2**30, "ranks": spawned,
            "scenario_s": {k: v["seconds"] for k, v in scen.items()}}


def answers_of(results):
    """(kind, source, epoch, cached, value) of each answer."""
    return [(r.query.kind, r.query.source, r.epoch, r.cached, r.value)
            for r in results]


def service_spawns(count: int):
    """Phase 9's spawn: (backend, world size): NCCL with a card a rank
    where the machine has SERVICE_RANKS cards, else gloo with every rank
    on cuda:0 (gloo stages each collective through the host)."""
    return ("nccl" if count >= SERVICE_RANKS else "gloo"), SERVICE_RANKS


def service_ranks_run(torch, args):
    """The service's client program on SERVICE_RANKS spawned ranks (each
    builds the graph from ``args.seed``): (backend, D, wall seconds, rank
    0's answers and statistics)."""
    import pickle
    import tempfile
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    backend, D = service_spawns(torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.pkl"
        t0 = time.perf_counter()
        spawn_ranks(service_rank, (D, backend, rendezvous(tmp), args.seed,
                                   str(out)), D, SHARDED_JOIN_S)
        wall = time.perf_counter() - t0
        return backend, D, wall, pickle.loads(out.read_bytes())


def service_many(np, one, spawned):
    """Rank 0's answers and statistics of ``service_ranks_run`` must equal
    world size 1's (SSSP and ego bitwise, PPR within SERVICE_PPR_RTOL of
    its max)."""
    backend, D, wall, got = spawned
    worst = 0.0
    for key in ("pre", "post"):
        worst = max(worst, same_answers(np, one[key], got[key],
                                        f"D={D} {backend} {key}"))
    scen = got["scenarios"]
    scenario_gates(scen, f"D={D}")
    for name, want in one["scenarios"].items():
        for key in ("first", "second"):
            worst = max(worst, same_answers(np, want[key], scen[name][key],
                                            f"D={D} {name} {key}"))
        for key in ("first_repartitions", "repartitions", "warm_traces",
                    "traces", "refrozen", "epoch"):
            if scen[name][key] != want[key]:
                fail(f"[service] D={D} {name}: {key} {scen[name][key]} "
                     f"where world size 1 gave {want[key]}")
    for key in ("pre_stats", "post_stats"):
        assert_stats_equal(np, f"[service] D={D} {key}", one[key], got[key],
                           between=f"world size 1 and {D}")
    log(f"[check] service on {D} spawned ranks ({backend}"
        + (", every rank on cuda:0, collectives staged through the host"
           if backend == "gloo" else ", a card a rank")
        + f") == world size 1: every answer, epoch and cached flag, sssp "
        f"and ego bitwise, ppr max rel {worst:.3g} (limit "
        f"{SERVICE_PPR_RTOL}), every msgs_*/per_worker_* equal; the "
        "repartition and overflow programs: the same answers, repartition "
        f"counts ({scen['repartition']['repartitions']}), executors and "
        "new profile as world size 1; "
        f"{wall:.1f} s of spawned program; rank 0's batch "
        f"{got['pre_s'] * 1e3:.1f} ms on the host clock")
    return {"backend": backend, "D": D, "wall_s": wall,
            "batch_ms_host": got["pre_s"] * 1e3,
            "scenario_s": {k: v["seconds"] for k, v in scen.items()}}


def service_rank(rank, D, backend, init_method, seed, out_path):
    """One rank of phase 9's spawn: joins the group, builds the graph from
    ``seed``, runs the client program on its own GraphService (no warmup:
    the executors are built by the first batch); rank 0 writes its
    answers and statistics."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import EngineConfig
    from repro_torch.core.service import GraphService, Query
    from repro_torch.graph import generators as gen
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve_graph as sgl
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=D, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        sa = sgl.build_parser().parse_args(["--seed", str(seed)])
        g = gen.powerlaw(sa.n, avg_deg=sa.avg_deg, seed=sa.seed,
                         weighted=True).symmetrized()
        svc = GraphService(g, M=sa.workers, config=EngineConfig(
            layout="csr", balance="edges", devices=D), buckets=sa.buckets,
            ppr_iters=sa.ppr_iters, seed=sa.seed, device=dev)
        pre, post, rd = service_program(
            torch, svc, sgl.mixed_batch(g.n, sa.batch, sa.seed),
            sgl.churn_delta(g, sa.churn, sa.seed),
            [Query("sssp", 17), Query("ppr", 23), Query("ego", 5)])
        del svc
        scen = service_scenarios(torch, np, g, sa, dev, D)
        if rank == 0:
            Path(out_path).write_bytes(pickle.dumps({
                "pre": answers_of(pre), "post": answers_of(post),
                "pre_stats": rd["pre_batch"]["stats"],
                "post_stats": rd["post_batch"]["stats"],
                "pre_s": rd["pre_s"], "scenarios": scen}))
    finally:
        meshlib.destroy()


# ---------------------------------------------------------------------------
# phases 10-12: the launchers and the preemption drill
# ---------------------------------------------------------------------------

def run_launcher(module: str, argv, timeout_s: float):
    """Run ``python -m module argv`` from the checkout (its own process
    tree: the launchers spawn their ranks); log its standard output; fail
    unless it exits 0.  Returns (stdout, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout_s)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        fail(f"{module} {' '.join(argv)} exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def shard_check_path(device_kind="cuda"):
    """Phase 10: ``shard_check --suite tier1`` on the card: 8
    ranks for the 1-D and (2, 4) cells and the gates (gloo with every rank
    on cuda:0 on a one-card machine, NCCL with a card a rank on eight), 2
    for the devices=2 cells (sv, dense).  Every cell OK, every gate true,
    every control rejected, and rank 0 of the 8-rank world launched the
    scalar and the vector kernel.  Prints each gated program's worst
    all-reduce / all-gather operand against n_pad, its all-to-all group
    sizes and its peak device bytes."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "report.json"
        _, seconds = run_launcher(
            "repro_torch.launch.shard_check",
            ["--suite", "tier1", "--device", device_kind,
             "--out", str(out)], SHARD_CHECK_TIMEOUT_S)
        rep = json.loads(out.read_text())
    bad = {k: v for k, v in rep["cells"].items() if v}
    if not rep["ok"] or bad or not rep["cells"]:
        fail(f"[shard_check] violations: {bad}")
    gates = {k: (rep[k]["ok"] if isinstance(rep[k], dict) else rep[k])
             for k in SHARD_CHECK_GATES}
    if not all(gates.values()):
        fail(f"[shard_check] gates {gates}")
    if any(rep["controls"].values()):
        fail(f"[shard_check] a gate accepted its control: {rep['controls']}")
    launches = {w: v["launches"] for w, v in rep["worlds"].items()}
    # world 8 holds the pallas cells and the gSpMM plan program (world
    # 2's are dense: no kernel)
    if device_kind == "cuda" and not (launches["8"]["scalar"] > 0
                                      and launches["8"]["vector"] > 0):
        fail(f"[shard_check] rank 0's kernel launches {launches}: the "
             "pallas cells did not go through the kernels")
    programs = {}
    for key in ("routed_memory", "hier_levels", "gspmm_hier",
                "gspmm_hier_f1"):
        for name, e in rep[key]["programs"].items():
            tag = f"{key}/{name}"
            worst = max(e["collective_max_elems"]["all_reduce"],
                        e["collective_max_elems"]["all_gather"])
            programs[tag] = {"worst": worst, "n_pad": rep[key]["n_pad"],
                             "groups": e["all_to_all_group_sizes"],
                             "peak_bytes": e.get("peak_bytes")}
            log(f"[shard_check] {tag}: worst all-reduce/all-gather operand "
                f"{worst} of n_pad {rep[key]['n_pad']}, all-to-all group "
                f"sizes {e['all_to_all_group_sizes']}, peak device bytes "
                f"{e.get('peak_bytes', 'not measured')}")
    log(f"[shard_check] {len(rep['cells'])} cells OK, gates {gates}, "
        f"controls rejected {sorted(rep['controls'])}; rank 0's launches "
        f"(scalar, vector) by world {launches}; {seconds:.3f} s")
    return {"seconds": seconds, "cells": len(rep["cells"]),
            "worlds": rep["worlds"], "programs": programs,
            "scalar": sum(v["scalar"] for v in launches.values()),
            "vector": sum(v["vector"] for v in launches.values())}


def dist_smoke_path(device_kind="cuda"):
    """Phase 11: ``dist_smoke --hosts 2 --per-host 2`` at n=PARITY_N and
    M=SHARDED_M over the launchers' TCP store on a port the first
    launcher binds: four ranks (gloo on cuda:0 on a one-card machine)
    must print parity OK and the launcher exit 0.  Prints each rank's
    rendezvous seconds and the wall seconds."""
    import re
    text, seconds = run_launcher(
        "repro_torch.launch.dist_smoke",
        ["--hosts", "2", "--per-host", "2", "--n", str(PARITY_N),
         "--workers", str(SHARDED_M), "--device", device_kind, "--port",
         "0", "--timeout", str(DIST_SMOKE_TIMEOUT_S)],
        DIST_SMOKE_TIMEOUT_S + 60)
    ok = re.findall(r"^\[dist_smoke\] rank (\d+): hashmin .* (\d+) scalar "
                    r"kernel launches: parity OK$", text, re.M)
    if sorted(int(r) for r, _ in ok) != [0, 1, 2, 3]:
        fail(f"[dist_smoke] parity OK on ranks {sorted(ok)}, want 0-3")
    rdv = {int(r): float(x) for r, x in re.findall(
        r"^\[dist_smoke\] rank (\d+): world size 4, .*rendezvous "
        r"([\d.]+) s$", text, re.M)}
    wall = float(re.search(r"launcher exit codes: \[0, 0\] .*wall "
                           r"([\d.]+) s", text).group(1))
    launches = dict((int(r), int(k)) for r, k in ok)
    if device_kind == "cuda" and not launches[0]:
        fail("[dist_smoke] rank 0 launched no scalar kernel")
    log(f"[dist_smoke] 4 ranks parity OK; rendezvous s by rank {rdv}; "
        f"launcher wall {wall:.3f} s, command {seconds:.3f} s; rank 0's "
        f"scalar launches {launches[0]}")
    return {"seconds": seconds, "wall_s": wall, "rendezvous_s": rdv,
            "scalar": launches[0]}


def clone_tree(tree):
    """A copy of a tree of dicts of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def tree_bytes(torch, tree) -> int:
    from repro_torch.train import checkpoint as ckpt
    return sum(x.numel() * x.element_size()
               for _, x in ckpt._leaves_with_paths(tree)
               if isinstance(x, torch.Tensor))


def preemption_drill(torch, np, pg, params0, straight, replay, vec_want):
    """Phase 12: the GCN of phase 4 (same partition, params0, optimizer
    and epochs) killed after DRILL_KILL epochs: ``run_steps(start, stop)``
    restores or inits {params, opt, step} from a fresh temporary
    directory, trains, and saves at the kill; the state is then dropped
    and a fresh call restores it and trains to GCN_EPOCHS
    (``fault.simulate_preemption``).  Gates: the restored state equals
    the saved one bitwise; the loss curve equals phase 4's straight run
    within the reference drill's rtol 2e-4, atol 1e-5; every trained leaf
    finite and within PARAM_RTOL of the straight run's change (the gate
    of the sharded GCN: two runs on the card differ by the atomic adds'
    order); the vector kernel launched what phase 4's run launched.
    Element-wise distances beside those of phase 4's replay (a second
    straight run) are printed.  Returns the readings."""
    import shutil
    import tempfile
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import simulate_preemption
    from repro_torch.train.gcn import gcn_labels, make_gcn_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    cfg = OptConfig(lr=GCN["lr"], weight_decay=0.0, clip_norm=GCN_CLIP,
                    warmup_steps=0, total_steps=GCN_EPOCHS, min_lr_frac=1.0)
    step_fn = make_gcn_step(cfg, "pallas")(pg)
    labels, mask = gcn_labels(pg, GCN["n_classes"], 0)
    tmp = tempfile.mkdtemp(prefix="gcn_drill_")
    rd = {"saved": None, "final": None}

    def init():
        return {"params": dict(params0), "opt": init_opt_state(params0),
                "step": torch.zeros((), dtype=torch.int64)}

    def run_steps(start, stop):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, at = ckpt.restore_or_init(tmp, init)
        torch.cuda.synchronize()
        if at != start or int(state["step"]) != start:
            fail(f"[drill] restart at {start} found step {at}")
        if start:
            rd["restore_ms"] = (time.perf_counter() - t0) * 1e3
            for (p, a), (_, b) in zip(ckpt._leaves_with_paths(rd["saved"]),
                                      ckpt._leaves_with_paths(state)):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"[drill] restored leaf {p} differs from the saved")
            rd["saved"] = None
        params, opt = state["params"], state["opt"]
        losses = []
        for _ in range(start, stop):
            (params, opt), metrics = step_fn(params, opt, labels, mask)
            losses.append(float(metrics["loss"]))
        out = {"params": params, "opt": opt, "step": torch.tensor(stop)}
        if stop < GCN_EPOCHS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save(tmp, stop, out)
            rd["save_ms"] = (time.perf_counter() - t0) * 1e3
            rd["disk_bytes"] = sum(f.stat().st_size
                                   for f in Path(path).iterdir())
            rd["state_bytes"] = tree_bytes(torch, out)
            rd["saved"] = clone_tree(out)
        else:
            rd["final"] = params
        return losses

    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0     # the drill starts
    try:
        losses = simulate_preemption(run_steps, GCN_EPOCHS, DRILL_KILL)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    vec, scalar = counter.launches_vec, counter.launches   # ... ends here
    if vec != vec_want or scalar:
        fail(f"[drill] {vec} vector and {scalar} scalar launches, phase 4's "
             f"run {vec_want} vector")
    want = np.asarray(straight.history)
    if not np.allclose(losses, want, rtol=DRILL_RTOL, atol=DRILL_ATOL):
        fail(f"[drill] losses {losses} vs the straight run's {list(want)}")

    def distances(got):
        """(max |d|, elements outside rtol/atol, worst leaf |d|/|change|)"""
        mx, outside, rel = 0.0, 0, 0.0
        for k, v in straight.state.items():
            d = (got[k] - v).abs()
            mx = max(mx, float(d.max()))
            outside += int((d > DRILL_ATOL + DRILL_RTOL * v.abs()).sum())
            ch = float(torch.linalg.vector_norm(v - params0[k]))
            rel = max(rel, float(torch.linalg.vector_norm(got[k] - v))
                      / max(ch, 1e-30))
        return mx, outside, rel
    final = rd["final"]
    for k, v in final.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"[drill] non-finite values in the resumed {k}")
    d_drill, d_replay = distances(final), distances(replay.state)
    if d_drill[2] > PARAM_RTOL:
        fail(f"[drill] a leaf's params moved {d_drill[2]:.3g} of its change "
             f"from the straight run (limit {PARAM_RTOL})")
    n_el = sum(v.numel() for v in final.values())
    log(f"[drill] gcn n={pg.n} killed after epoch {DRILL_KILL} of "
        f"{GCN_EPOCHS}: save {rd['save_ms']:.3f} ms, restore "
        f"{rd['restore_ms']:.3f} ms (template included), "
        f"{rd['disk_bytes']:,d} bytes on disk for {rd['state_bytes']:,d} "
        f"bytes of state; restored state bitwise equal to the saved")
    log(f"[check] drill vs straight run: losses "
        f"{' '.join(f'{x:.6f}' for x in losses)} within rtol {DRILL_RTOL} "
        f"atol {DRILL_ATOL}; params max |d| {d_drill[0]:.3g}, "
        f"{d_drill[1]} of {n_el} elements outside rtol {DRILL_RTOL} / atol "
        f"{DRILL_ATOL}, worst leaf {d_drill[2]:.3g} of its change (limit "
        f"{PARAM_RTOL}); phase 4's replay vs the straight run: max |d| "
        f"{d_replay[0]:.3g}, {d_replay[1]} elements outside, worst leaf "
        f"{d_replay[2]:.3g}")
    return {"save_ms": rd["save_ms"], "restore_ms": rd["restore_ms"],
            "disk_bytes": rd["disk_bytes"], "vector": vec,
            "losses": losses, "max_abs": d_drill[0],
            "outside": d_drill[1], "leaf_rel": d_drill[2],
            "replay_max_abs": d_replay[0], "replay_outside": d_replay[1],
            "replay_leaf_rel": d_replay[2]}


# ---------------------------------------------------------------------------
# step 0 of phase 16: the LM kernels on half types
# ---------------------------------------------------------------------------

def half_type_cases(torch, np, dev, seed):
    """The flash kernel on float16 (every head dim of ``HEAD_DIMS``;
    causal, windowed, unmasked and unmasked with Sq > Sk) and the SSD
    kernel on float16 and bfloat16 inputs at Hymba-1.5B's layer shape (and
    a mix: bfloat16 x with float32 B and C), each against its float64
    plain version on the same inputs, within one ulp of the half output
    at each value on top of float32's own tolerance (FLASH_F32_TOL of
    max|v|, SSD_RTOL of max|y|); then each kernel timed once on float32,
    bfloat16 and float16 inputs at the main path's shape (flash: Hymba's
    global layer, BH=100, S=2048, d=64, causal; SSD: b=4, S=2048, 50
    heads, P=64, N=16, chunk 128), beside its bound (operations the same,
    the half types' bytes halved).  Returns {"flash": ..., "ssd": ...}."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    gen = torch.Generator(dev).manual_seed(seed + 16)
    f16 = torch.float16
    worst, n = 0.0, 0
    for d in (16, 32, 64, 128, 256):
        for Sq, Sk, causal, window in ((257, 257, True, 0),
                                       (2112, 2112, True, 1024),
                                       (129, 129, False, 0),
                                       (384, 1500, False, 0),
                                       (1600, 1500, False, 0)):
            for n_rep in (1, 5):
                q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
                    f16) for shape in [(2 * n_rep, Sq, d), (2, Sk, d),
                                       (2, Sk, d)])
                got = fk.launch(q, k, v, causal=causal, window=window)
                want = flash_attention_ref(q.double(), k.double(),
                                           v.double(), causal=causal,
                                           window=window)
                torch.cuda.synchronize()
                vmax = float(v.abs().max())
                excess = ((got.double() - want).abs()
                          - half_ulp(torch, want.abs(), f16)
                          - FLASH_F32_TOL * vmax)
                if got.dtype != f16 or float(excess.max()) > 0:
                    fail(f"float16 flash kernel vs float64 plain: {got.dtype}"
                         f", {float(excess.max()):.3g} past one ulp + "
                         f"{FLASH_F32_TOL} x max|v| (d={d}, Sq={Sq}, Sk={Sk},"
                         f" causal={causal}, window={window}, n_rep={n_rep})")
                worst = max(worst, float((got.double() - want).abs().max()))
                n += 1
                del want
    log(f"[kernel] flash_attention: {n} float16 cases (d 16-256; causal, "
        f"window 1024 at 2112, unmasked, unmasked 1600 x 1500) within one "
        f"float16 ulp + {FLASH_F32_TOL} x max|v| of the float64 plain "
        f"version (max |err| {worst:.3g})")
    flash = {"cases": n, "max_abs_err": worst}
    BH, S, d = 100, 2048, 64
    q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
               [(BH, S, d), (20, S, d), (20, S, d)])
    ops = 4 * d * flash_pairs(S, 0) * BH
    for dt in (torch.float32, torch.bfloat16, f16):
        qq, kk, vv = (t.to(dt) for t in (q, k, v))
        fk.launch(qq, kk, vv, causal=True, window=0)        # warm-up
        _, ms = event_ms(torch, lambda: fk.launch(qq, kk, vv, causal=True,
                                                  window=0))
        size = torch.finfo(dt).bits // 8
        nbytes = size * (2 * BH * S * d + 2 * 20 * S * d)
        bound = max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        flash[str(dt).split(".")[1]] = {"ms": ms, "bound_ms": bound,
                                        "bytes": nbytes, "ops": ops}
    log("[kernel] flash_attention by input type (BH=100, S=2048, d=64, "
        "causal, n_rep 5): " + ", ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for k, v in flash.items() if isinstance(v, dict)))
    del q, k, v
    b, S, h, P, g, N, Q = 4, 2048, 50, 64, 1, 16, 128
    x = torch.randn((b, S, h, P), generator=gen, device=dev)
    dt_ = torch.nn.functional.softplus(torch.randn((b, S, h), generator=gen,
                                                   device=dev) - 1.0)
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    Bm, Cm = (torch.randn((b, S, g, N), generator=gen, device=dev)
              for _ in range(2))
    ssd, worst = {}, 0.0
    for xt, bt in ((torch.float16, torch.float16),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        xx, BB, CC = x.to(xt), Bm.to(bt), Cm.to(bt)
        y, st = sk.ssd_chunk_scan(xx, dt_, A, BB, CC, chunk=Q)
        y64, st64 = ssd_scan_ref_model(xx.double(), dt_.double(), A.double(),
                                       BB.double(), CC.double())
        torch.cuda.synchronize()
        excess = ((y.double() - y64).abs() - half_ulp(torch, y64.abs(), xt)
                  - SSD_RTOL * float(y64.abs().max()))
        es = ssd_case_err(torch, st, st64)
        if (y.dtype != xt or st.dtype != torch.float32
                or float(excess.max()) > 0 or not es <= SSD_RTOL):
            fail(f"SSD kernel on x {xt}, B/C {bt}: y {y.dtype} "
                 f"{float(excess.max()):.3g} past one ulp + {SSD_RTOL} x "
                 f"max|y|, state {es:.3g} of max (limit {SSD_RTOL})")
        worst = max(worst, float((y.double() - y64).abs().max()))
        del y64, st64
    for xt in (torch.float32, torch.bfloat16, f16):
        xx, BB, CC = x.to(xt), Bm.to(xt), Cm.to(xt)
        sk.launch(xx, dt_, A, BB, CC, chunk=Q)               # warm-up
        _, ms = event_ms(torch, lambda: sk.launch(xx, dt_, A, BB, CC,
                                                  chunk=Q))
        size = torch.finfo(xt).bits // 8
        tri = Q * (Q + 1) // 2
        ops = b * h * (S // Q) * (2 * tri * (N + P) + 4 * Q * P * N)
        nbytes = (size * (2 * b * S * h * P + 2 * b * S * g * N)
                  + 4 * (b * S * h + h + b * h * P * N))
        ssd[str(xt).split(".")[1]] = {
            "ms": ms, "ops": ops, "bytes": nbytes,
            "bound_ms": max(ops / FP32_OPS_PER_S,
                            nbytes / HBM_BYTES_PER_S) * 1e3}
    ssd["max_abs_err"] = worst
    log(f"[kernel] ssd_scan: float16 and bfloat16 x, B, C (and bfloat16 x "
        f"with float32 B, C) at Hymba's layer shape within one ulp + "
        f"{SSD_RTOL} x max|y| of the float64 recurrence (max |err| "
        f"{worst:.3g}); by input type: " + ", ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for k, v in ssd.items() if isinstance(v, dict)))
    del x, Bm, Cm
    torch.cuda.empty_cache()
    return {"flash": flash, "ssd": ssd}


# ---------------------------------------------------------------------------
# phase 16: train TinyLlama-1.1B at full width and depth
# ---------------------------------------------------------------------------

def train_products(cfg, B, S, remat: bool):
    """Products of one training step of a dense model (T = B*S tokens), in
    operations (an FMA is 2): the weight products forward (the layers and
    the logits), twice that backward, the layers' forward again under
    recomputation; the flash kernel's QK^T and PV over the causal pairs
    (once, twice under recomputation), and the plain attention backward:
    six products (QK^T and PV recomputed, dP, dV, dQ, dK) over the pairs
    its query chunks compute (every key up to the chunk's last row)."""
    from repro_torch.kernels.flash_attention.ref import vjp_chunk_rows
    T, D, L = B * S, cfg.d_model, cfg.n_layers
    H, K, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    layer_w = D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F
    head_w = cfg.padded_vocab(1) * D
    dense = 3 * 2 * T * (L * layer_w + head_w)
    if remat:
        dense += 2 * T * L * layer_w
    BH = B * H
    attn_fwd = 4 * hd * flash_pairs(S, 0) * BH
    c = vjp_chunk_rows(BH, S, S)
    pairs = sum((min(S, i + c) - i) * min(S, i + c) for i in range(0, S, c))
    attn_bwd = 6 * 2 * hd * pairs * BH
    attn = L * (attn_fwd * (2 if remat else 1) + attn_bwd)
    return {"dense": dense, "attn_fwd": L * attn_fwd * (2 if remat else 1),
            "attn_bwd": L * attn_bwd, "total": dense + attn}


def grads_of(torch, zoo, cfg, ctx, params, batch, dh_too=False):
    """(loss, gradient leaves of ``params``[, the embedding output's
    gradient]) of ``loss_fn``; the flash and SSD launches of the call."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.train.optimizer import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    seen = []
    saved = zoo._embed_in

    def spy(*a):
        h = saved(*a)
        seen.append(h)
        return h
    fk.flash_attention_bhsd.launches = 0
    zoo._embed_in = spy
    try:
        loss, _ = zoo.loss_fn(p, cfg, ctx, batch)
    finally:
        zoo._embed_in = saved
    leaves = tree_leaves(p)
    got = torch.autograd.grad(loss, leaves + (seen[:1] if dh_too else []))
    torch.cuda.synchronize()
    return loss.detach(), got, fk.flash_attention_bhsd.launches


def flash_grads(torch, ref, q, k, v, do, dtype, slices=4):
    """[o, dq, dk, dv] of the causal plain version ``ref`` in ``dtype`` by
    torch.autograd over the whole sequence (none of the Function's query
    chunks or key slices), taken in ``slices`` slices of the kv heads with
    their query heads (heads do not interact), which holds each float64
    score tensor to 1 GiB at the training shape (BH=128, S=2048)."""
    BKV = k.shape[0]
    r = q.shape[0] // BKV
    step = max(1, BKV // slices)
    parts = [[], [], [], []]
    for g0 in range(0, BKV, step):
        g1 = min(BKV, g0 + step)
        ins = [t.detach().to(dtype).requires_grad_(True)
               for t in (q[g0 * r:g1 * r], k[g0:g1], v[g0:g1])]
        o = ref(*ins, causal=True)
        grads = torch.autograd.grad(o, ins, do[g0 * r:g1 * r].to(dtype))
        for part, t in zip(parts, (o.detach(), *grads)):
            part.append(t)
        del o, grads, ins
    return [torch.cat(part) for part in parts]


def train_flash_check(torch, fk, q, k, v, dev, seed):
    """Gate (a): the Function's o, dq, dk, dv (kernel forward, plain
    backward, ``flash_attention_vjp``) on layer 0's recorded q, k, v
    against ``flash_grads`` in float64 (plain autograd of the whole plain
    version, independent of the backward's chunking), each within
    PLAIN_FACTOR times the error of ``flash_grads`` in float32 (the plain
    path's own) or FLASH_F32_TOL of its max.  Returns (rows, the backward's
    device ms on these inputs, the sum of its kernels' device time under
    torch.profiler: one call alone is bound by its ~500 launches on the
    host, which the training step's queue hides)."""
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         flash_attention_vjp)
    gen = torch.Generator(dev).manual_seed(seed + 160)
    do = torch.randn(q.shape, generator=gen, device=dev)
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = fk.flash_attention_bhsd.launches
    o = fk.flash_attention_bhsd(*ins, causal=True, window=0)
    if type(o.grad_fn).__name__ != "FlashAttentionBackward":
        fail(f"the flash kernel's output on the card has grad_fn "
             f"{o.grad_fn}: not the FlashAttention Function")
    got = [o.detach()] + list(torch.autograd.grad(o, ins, do))
    torch.cuda.synchronize()
    if fk.flash_attention_bhsd.launches != before + 1:
        fail(f"{fk.flash_attention_bhsd.launches - before} flash launches for"
             " one forward and backward of the Function: expected 1 (the "
             "backward is plain PyTorch)")
    plain = flash_grads(torch, flash_attention_ref, q, k, v, do,
                        torch.float32)
    want = flash_grads(torch, flash_attention_ref, q, k, v, do,
                       torch.float64)
    rows = {}
    for name, g, p, w in zip(("o", "dq", "dk", "dv"), got, plain, want):
        err = float((g.double() - w).abs().max())
        own = float((p.double() - w).abs().max())
        wmax = float(w.abs().max())
        lim = max(FLASH_F32_TOL * wmax, PLAIN_FACTOR * own)
        if not err <= lim:
            fail(f"(a) flash Function {name} at the training shape: |err| "
                 f"{err:.3g} > {lim:.3g} (the float32 plain path's "
                 f"{own:.3g}, max {wmax:.3g})")
        rows[name] = {"err": err, "plain_err": own, "max": wmax}
    del want, plain
    flash_attention_vjp(q, k, v, do, causal=True)          # warm-up
    prof = profile_kernels(torch, lambda: flash_attention_vjp(
        q, k, v, do, causal=True), "flash_attention_vjp, layer 0", 5)
    bwd_ms = sum(us for _, us in prof.values()) / 1e3 if prof else None
    return rows, bwd_ms


def train_layer_check(torch, zoo, tf, cfg, params, tokens, seed):
    """Gate (b): for layers 0-3 of the model, on each layer's input (the
    kernels' run's, first sequence) and a seeded upstream gradient, every
    parameter gradient of the kernel path (training's context, remat
    "full") against a float64 recomputation of the plain path, within the
    larger of LAYER_GRAD_RTOL of its max and PLAIN_FACTOR times the
    float32 plain path's own error.  Returns the worst rel errors."""
    from repro_torch.train.optimizer import tree_leaves, tree_map
    dev = tokens.device
    gen = torch.Generator(dev).manual_seed(seed + 161)
    layers = one_layer_stages(params, cfg)[:TRAIN_CHECK_LAYERS]
    ctxs = {"kernel": tf.ModelContext(),
            "plain": tf.ModelContext(kernels="ref", remat="none"),
            "f64": tf.ModelContext(kernels="ref", remat="none")}
    with torch.no_grad():
        h = zoo._embed_in(params, cfg, tokens[:1], ctxs["kernel"])
    S = h.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(1, S)
    worst = []
    for li, (stage, sp) in enumerate(layers):
        cot = torch.randn(h.shape, generator=gen, device=dev)
        grads = {}
        for name, ctx in ctxs.items():
            dt = torch.float64 if name == "f64" else torch.float32
            w = tree_map(lambda t: t.detach().to(dt).requires_grad_(True), sp)
            out = tf.apply_stage_seq(h.to(dt), w, stage, cfg, ctx, pos)[0]
            grads[name] = torch.autograd.grad(out, tree_leaves(w),
                                              cot.to(dt))
            if name == "kernel":
                h_next = out.detach()
        rel = 0.0
        for gk, gp, g64 in zip(grads["kernel"], grads["plain"],
                               grads["f64"]):
            err = float((gk.double() - g64).abs().max())
            own = float((gp.double() - g64).abs().max())
            gmax = float(g64.abs().max())
            lim = max(LAYER_GRAD_RTOL * gmax, PLAIN_FACTOR * own)
            if not err <= lim:
                fail(f"(b) layer {li}: a parameter gradient of the kernel "
                     f"path differs from float64 by {err:.3g} > {lim:.3g} "
                     f"(float32 plain {own:.3g}, max {gmax:.3g})")
            rel = max(rel, err / max(gmax, 1e-30))
        worst.append(rel)
        h = h_next
        del grads
    log("[check] (b) train, layers 0-3: worst parameter-gradient error of "
        "the kernel path against float64, of the leaf's max: "
        + ", ".join(f"{e:.2g}" for e in worst) + f" (limits: the larger of "
        f"{LAYER_GRAD_RTOL} and {PLAIN_FACTOR} x the float32 plain path's)")
    return worst


def train_remat_check(torch, zoo, tf, cfg, params, tokens):
    """Gate (c) and (d): one step's loss and gradients at B=1 under
    remat "none" and "full" on the same batch: the loss bitwise, every
    leaf bitwise but the embedding, whose rows sum their tokens'
    gradients with index_add_ atomics in no fixed order: within
    2 (n - 1) 2^-24 sum_t |g_t| of each row (n its token count, g_t the
    embedding output's gradient), any two orders' float32 bound; 22 flash
    launches under "none" and 44 under "full".  Peak memory of each."""
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.models import model_zoo as zoo_mod
    batch = {"tokens": tokens[:1]}
    out = {}
    for remat in ("none", "full"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[remat] = grads_of(torch, zoo, cfg, tf.ModelContext(remat=remat),
                              params, batch, dh_too=True)
        out[remat] += (torch.cuda.max_memory_allocated(),)
    L = cfg.n_layers
    if out["none"][2] != L or out["full"][2] != 2 * L:
        fail(f"(d) flash launches a step: {out['none'][2]} under remat "
             f"'none', {out['full'][2]} under 'full'; expected {L} and "
             f"{2 * L} (the forward, and the recomputed forward; the "
             "Function's backward launches none)")
    if not torch.equal(out["none"][0], out["full"][0]):
        fail(f"(c) the loss under remat 'none' {float(out['none'][0])!r} and "
             f"'full' {float(out['full'][0])!r} differ")
    paths = [p for p, _ in zoo_mod._leaves(params)]
    emb_i = paths.index(("embed",))
    n_g = len(paths)
    differ = [paths[i] for i in range(n_g) if i != emb_i and not torch.equal(
        out["none"][1][i], out["full"][1][i])]
    if differ:
        fail(f"(c) leaves whose gradient differs under remat 'full': {differ}")
    ids = tokens[:1].reshape(-1).long()
    dh = out["none"][1][n_g].reshape(-1, cfg.d_model).double().abs()
    mass = torch.zeros(params["embed"].shape, dtype=torch.float64,
                       device=ids.device).index_add_(0, ids, dh)
    count = torch.bincount(ids, minlength=params["embed"].shape[0])
    bound = 2 * (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mass
    diff = (out["none"][1][emb_i].double()
            - out["full"][1][emb_i].double()).abs()
    if not bool((diff <= bound).all()):
        fail(f"(c) the embedding's gradient under 'none' and 'full' differs "
             f"past its summation-order bound: "
             f"{float((diff - bound).max()):.3g}")
    log(f"[check] (c) remat 'none' vs 'full' at B=1, S={tokens.shape[1]}: "
        f"loss bitwise equal ({float(out['none'][0]):.6f}), {n_g - 1} of "
        f"{n_g} leaves' gradients bitwise equal, the embedding's within its "
        f"summation-order bound (max |diff| {float(diff.max()):.3g}, bound "
        f"at that row up to {float(bound.max()):.3g}); (d) flash launches "
        f"{out['none'][2]} / {out['full'][2]}")
    return {"peak_none": out["none"][3], "peak_full": out["full"][3],
            "embed_max_diff": float(diff.max())}


def ssd_grad_check(torch, dev, seed):
    """Gate (f): the SSD Function (kernel forward, backward through
    ``ssd_chunked``) at Hymba-1.5B's layer shape: y, dx, ddt, dA, dB, dC
    against float64 autograd of ``ssd_chunked`` at the same chunk, each
    within the larger of SSD_RTOL of its max and PLAIN_FACTOR times the
    float32 ``ssd_chunked`` path's own error; one kernel call.  Returns
    the rows and the backward's ms."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models.ssm import ssd_chunked
    b, S, h, P, g, N, Q = 4, 2048, 50, 64, 1, 16, 128
    gen = torch.Generator(dev).manual_seed(seed + 162)
    x = torch.randn((b, S, h, P), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, S, h), generator=gen,
                                                  device=dev) - 1.0)
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, S, g, N), generator=gen, device=dev)
            for _ in range(2))
    dy = torch.randn((b, S, h, P), generator=gen, device=dev)

    def run(fn, dtype):
        ins = [t.to(dtype).requires_grad_(True) for t in (x, dt, A, B, C)]
        y = fn(*ins)
        return [y.detach()] + list(torch.autograd.grad(y, ins, dy.to(dtype)))
    before = sk.ssd_chunk_scan.launches
    got = run(lambda *a: sk.ssd_chunk_scan(*a, chunk=Q)[0], torch.float32)
    torch.cuda.synchronize()
    if sk.ssd_chunk_scan.launches != before + 1:
        fail(f"{sk.ssd_chunk_scan.launches - before} SSD calls for one "
             "forward and backward of the Function: expected 1")
    plain = run(lambda *a: ssd_chunked(*a, Q)[0], torch.float32)
    want = run(lambda *a: ssd_chunked(*a, Q)[0], torch.float64)
    rows = {}
    for name, gg, p, w in zip(("y", "dx", "ddt", "dA", "dB", "dC"), got,
                              plain, want):
        err = float((gg.double() - w).abs().max())
        own = float((p.double() - w).abs().max())
        wmax = float(w.abs().max())
        lim = max(SSD_RTOL * wmax, PLAIN_FACTOR * own)
        if not err <= lim:
            fail(f"(f) SSD Function {name} at Hymba's layer shape: |err| "
                 f"{err:.3g} > {lim:.3g} (float32 ssd_chunked {own:.3g}, max"
                 f" {wmax:.3g})")
        rows[name] = {"err": err, "plain_err": own, "max": wmax}
    del want, plain
    ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    y = sk.ssd_chunk_scan(*ins, chunk=Q)[0]
    _, bwd_ms = event_ms(torch, lambda: torch.autograd.grad(y, ins, dy))
    log("[check] (f) SSD Function at b=4, S=2048, 50 heads, P=64, N=16, "
        "chunk 128 against float64 autograd of ssd_chunked, |err| (float32 "
        "plain's): " + ", ".join(f"{k} {v['err']:.3g} ({v['plain_err']:.3g})"
                                 for k, v in rows.items())
        + f"; the backward (ssd_chunked recomputed) {bwd_ms:.3f} ms")
    return rows, bwd_ms


def train_launcher_check(torch, dev):
    """Gate (g): ``launch/train.py``'s ``run(..., reduced=False)`` at full
    width with the depth cut to TRAIN_LAUNCHER_LAYERS layers (to keep the
    checkpoint a few GB; ``get_config`` is swapped in the launcher's module
    for the cut config), B=4, S=2048, token lookup ``onehot`` (its
    gradient is a product, where ``rr``'s index_add_ sums with atomics in
    no fixed order, so that two runs can agree bit for bit): a straight
    run of TRAIN_LAUNCHER_STEPS steps, then a run cut after TRAIN_CUT
    steps (its checkpoint written at its end) and a fresh run resumed from
    that checkpoint; the losses must be equal bitwise.  The warm-up is 20
    steps, so the cut run's shorter schedule is the same."""
    import dataclasses
    import tempfile
    from repro_torch.launch import train as launcher
    real = launcher.get_config
    launcher.get_config = lambda a: dataclasses.replace(
        real(a), n_layers=TRAIN_LAUNCHER_LAYERS)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
              embed_method="onehot", device=dev)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            straight = launcher.run(TRAIN_ARCH, False,
                                    steps=TRAIN_LAUNCHER_STEPS,
                                    ckpt_dir=f"{tmp}/a", ckpt_every=0, **kw)
            t1 = time.perf_counter()
            cut = launcher.run(TRAIN_ARCH, False, steps=TRAIN_CUT,
                               ckpt_dir=f"{tmp}/b",
                               ckpt_every=TRAIN_LAUNCHER_STEPS, **kw)
            t2 = time.perf_counter()
            resumed = launcher.run(TRAIN_ARCH, False,
                                   steps=TRAIN_LAUNCHER_STEPS,
                                   ckpt_dir=f"{tmp}/b", ckpt_every=0, **kw)
            t3 = time.perf_counter()
            disk = sum(p.stat().st_size for p in Path(tmp, "b").rglob("*")
                       if p.is_file())
    finally:
        launcher.get_config = real
    if cut + resumed != straight or not all(map(math.isfinite, straight)):
        fail(f"(g) the launcher's losses: straight {straight}, cut {cut} + "
             f"resumed {resumed}: not equal bitwise (or not finite)")
    log(f"[check] (g) launch/train.py at full width, {TRAIN_LAUNCHER_LAYERS}"
        f" layers, B={TRAIN_BATCH}, S={TRAIN_SEQ}: straight "
        f"{TRAIN_LAUNCHER_STEPS} steps {straight} in {t1 - t0:.3f} s; cut "
        f"after {TRAIN_CUT} ({t2 - t1:.3f} s, checkpoint "
        f"{disk / 1e9:.3f} GB) and resumed in a fresh state ({t3 - t2:.3f} "
        "s): the losses equal bitwise")
    return {"losses": straight, "ckpt_bytes": disk,
            "straight_s": t1 - t0, "cut_s": t2 - t1, "resumed_s": t3 - t2}


def train_path(torch, np, args, dev, phases):
    """Phase 16: train TinyLlama-1.1B at full width and depth (22 layers,
    d_model 2048, 32/4 heads of dim 64, d_ff 5632, vocab 32,000; float32
    parameters from ``torch.Generator(seed)``, TF32 off) on
    ``SyntheticLM(vocab, seq_len=2048, global_batch=4, seed)`` batches
    (T = 8192 tokens a step) through ``make_train_step`` under the
    reference's default context (remat "full", ``rr`` lookup): one warm-up
    step and TRAIN_STEPS steps timed between CUDA events, one profiled.
    Gates (a)-(g) of the module docstring.  Returns the phase's
    summary."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf
    from repro_torch.train import data as tdata
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    T = B * S
    state = phases.run("train-init", lambda: ts.init_train_state(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(state["params"])
    data = tdata.SyntheticLM(tdata.DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=args.seed))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch_at(i).items()} for i in range(1 + TRAIN_STEPS)]
    stats = tdata.token_stats(data.batch_at(1)["tokens"])
    log(f"[train] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of dim {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab(1)}), "
        f"untied; {n_par:,} parameters float32 (train state: params, master,"
        f" m, v {4 * 4 * n_par / 1e9:.2f} GB); B={B}, S={S}: {T} tokens a "
        f"step, {stats['unique']} distinct (dedup ratio "
        f"{stats['dedup_ratio']:.4f})")
    ctx = tf.ModelContext()
    if ctx.remat != "full" or ctx.embed_method != "rr":
        fail(f"the reference's default context is remat 'full', lookup "
             f"'rr'; the port's is {ctx.remat!r}, {ctx.embed_method!r}")
    step_fn = ts.make_train_step(cfg, ctx)
    params0 = state["params"]
    state, m0 = phases.run("train-warm", step_fn, state, batches[0])
    torch.cuda.synchronize()
    still = [i for i, (a, b) in enumerate(zip(tree_leaves(params0),
                                              tree_leaves(state["params"])))
             if torch.equal(a, b)]
    if still:
        fail(f"(e) {len(still)} parameter leaves did not move in the first "
             f"step: {still[:8]}")
    del params0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, gnorms, launches = [], [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        fk.flash_attention_bhsd.launches = 0        # the path starts here
        sk.ssd_chunk_scan.launches = 0
        ev[0].record()
        state, m = step_fn(state, batches[1 + i])
        ev[1].record()
        ev[1].synchronize()
        launches.append((fk.flash_attention_bhsd.launches,   # ... ends here
                         sk.ssd_chunk_scan.launches))
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    host_s = time.perf_counter() - t0
    peak_full = torch.cuda.max_memory_allocated()
    losses = [float(m0["loss"])] + losses
    gnorms = [float(m0["grad_norm"])] + gnorms
    if any(n != (2 * L, 0) for n in launches):
        fail(f"(d) launches (flash, SSD) a step {launches}: expected "
             f"({2 * L}, 0), the forward and the recomputed forward of each "
             "layer")
    if not all(map(math.isfinite, losses + gnorms)):
        fail(f"(e) non-finite loss or grad_norm: {losses}, {gnorms}")
    med = float(np.median(step_ms))
    prods = train_products(cfg, B, S, remat=True)
    bound_ms = prods["total"] / FP32_OPS_PER_S * 1e3
    model_flops = 6 * n_par * T
    mfu = model_flops / (med / 1e3) / FP32_OPS_PER_S
    log(f"[train] {cfg.name}: {med:.3f} ms a step (median of "
        f"{TRAIN_STEPS}; each " + ", ".join(f"{x:.3f}" for x in step_ms)
        + f"), {T / med * 1e3:.0f} tokens/s, {host_s:.3f} s host for the "
        f"{TRAIN_STEPS} steps; products {prods['total'] / 1e12:.2f} TFLOP a "
        f"step (weights {prods['dense'] / 1e12:.2f}, flash forward "
        f"{prods['attn_fwd'] / 1e12:.2f}, plain attention backward "
        f"{prods['attn_bwd'] / 1e12:.2f}): bound {bound_ms:.3f} ms at 67 "
        f"TFLOP/s float32, bound/step {bound_ms / med:.3f}; model FLOPs "
        f"6NT {model_flops / 1e12:.2f} TFLOP, mfu_fp32 {mfu:.4f}; peak "
        f"device memory under remat 'full' (B={B}) {peak_full / 2**30:.2f} "
        "GiB")
    log(f"[train] {cfg.name}: loss by step " + ", ".join(
        f"{x:.4f}" for x in losses) + "; grad_norm " + ", ".join(
        f"{x:.4f}" for x in gnorms) + f"; flash launches a step "
        f"{[n for n, _ in launches]}")
    params = state["params"]
    prof = phases.run("train-profile", profile_kernels, torch,
                      lambda: step_fn(state, batches[1]),
                      f"{cfg.name} train step", 12, False)
    with torch.no_grad():
        seen = record_launches({"flash": fk}, lambda: zoo.forward_logits(
            params, cfg, ctx, batches[1]["tokens"]))["flash"]
    (q, k, v), _ = seen[0]
    del seen
    torch.cuda.empty_cache()
    rows_a, vjp_ms = phases.run("train-flash-check", train_flash_check,
                                torch, fk, q, k, v, dev, args.seed)
    busy_ms = sum(us for _, us in prof.values()) / 1e3 if prof else None
    share = (L * vjp_ms / busy_ms) if busy_ms and vjp_ms else None
    if share is None:
        log(f"[profile] {cfg.name} train step: the plain attention "
            "backward's share not measured (the profiler saw no device "
            "time)")
    else:
        log(f"[profile] {cfg.name} train step: the plain attention backward "
            f"(flash_attention_vjp, its kernels' device time on layer 0's "
            f"inputs) {vjp_ms:.3f} ms a layer, {L * vjp_ms:.3f} ms a step = "
            f"{100 * share:.1f}% of the profiled step's device time")
    log(f"[check] (a) flash Function at (BH, S, d) {tuple(q.shape)} on "
        "layer 0's inputs against float64, |err| (float32 plain's): "
        + ", ".join(
            f"{n} {r['err']:.3g} ({r['plain_err']:.3g})"
            for n, r in rows_a.items()))
    del q, k, v
    worst_b = phases.run("train-layers", train_layer_check, torch, zoo, tf,
                         cfg, params, batches[1]["tokens"], args.seed)
    remat = phases.run("train-remat", train_remat_check, torch, zoo, tf,
                       cfg, params, batches[1]["tokens"])
    log(f"[train] {cfg.name}: peak device memory at B=1: remat 'none' "
        f"{remat['peak_none'] / 2**30:.2f} GiB, 'full' "
        f"{remat['peak_full'] / 2**30:.2f} GiB (the train state "
        f"{16 * n_par / 2**30:.2f} GiB of it); at B={B} 'full' "
        f"{peak_full / 2**30:.2f} GiB")
    holder = [state]
    del state, params
    mesh = phases.run("mesh-train", mesh_train_path, torch, np, args, dev,
                      phases, holder, batches, med)
    del batches
    torch.cuda.empty_cache()
    rows_f, ssd_bwd_ms = phases.run("train-ssd-check", ssd_grad_check, torch,
                                    dev, args.seed)
    torch.cuda.empty_cache()
    launcher = phases.run("train-launcher", train_launcher_check, torch, dev)
    torch.cuda.empty_cache()
    return {"launches": sum(n for n, _ in launches), "steps": TRAIN_STEPS,
            "step_ms": step_ms, "median_ms": med,
            "tokens_per_s": T / med * 1e3, "bound_ms": bound_ms,
            "products": prods, "mfu_fp32": mfu, "n_params": n_par,
            "peak_full_gib": peak_full / 2**30,
            "peak_b1_none_gib": remat["peak_none"] / 2**30,
            "peak_b1_full_gib": remat["peak_full"] / 2**30,
            "losses": losses, "grad_norms": gnorms,
            "vjp_ms_layer": vjp_ms, "vjp_share": share,
            "busy_ms": busy_ms, "flash_check": rows_a,
            "layer_check": worst_b, "ssd_check": rows_f,
            "ssd_bwd_ms": ssd_bwd_ms, "launcher": launcher, "mesh": mesh}


# ---------------------------------------------------------------------------
# phase 17: the training mesh
# ---------------------------------------------------------------------------

def flat_state(tree):
    """(keystr path, leaf) of a train state, in the checkpoint's order."""
    from repro_torch.train.checkpoint import _leaves_with_paths
    return _leaves_with_paths(tree)


def embed_bound(torch, ids, dh, rows):
    """Gate (c)'s bound on two index_add_ orders of the embedding's
    gradient: 2 (n - 1) 2^-24 sum_t |g_t| a row (n its token count, g_t
    the embedding output's gradient)."""
    dh = dh.reshape(-1, dh.shape[-1]).double().abs()
    mass = torch.zeros((rows, dh.shape[1]), dtype=torch.float64,
                       device=ids.device).index_add_(0, ids, dh)
    count = torch.bincount(ids, minlength=rows)
    return 2 * (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mass


def mesh_gate_h(torch, zoo, tf, ts, cfg, state, batch, step):
    """Gate (h): the mesh step (``step``) against make_train_step without
    a mesh from ``state`` on ``batch``, each as its ``grads`` then its
    ``update``; see MESH_STEPS's comment.  Returns (the mesh step's new
    state, the gate's figures)."""
    from repro_torch.train.optimizer import tree_leaves
    params = state["params"]
    paths = [p for p, _ in zoo._leaves(params)]
    n = len(paths)
    emb_i = paths.index(("embed",))
    plain = ts.make_train_step(cfg, tf.ModelContext())
    dh, saved = [], zoo._embed_in

    def spy(*a):       # the embedding output's gradient, for the bound
        h = saved(*a)
        h.register_hook(dh.append)
        return h
    zoo._embed_in = spy
    try:
        got_p = plain.grads(params, batch)
    finally:
        zoo._embed_in = saved
    got_m = step.grads(params, batch)
    leaves_p, leaves_m = tree_leaves(got_p[2]), tree_leaves(got_m[2])
    if not torch.equal(got_p[0], got_m[0]):
        fail(f"(h) the mesh step's loss {float(got_m[0])!r} is not the "
             f"one-device step's {float(got_p[0])!r}")
    differ = [paths[i] for i in range(n) if i != emb_i
              and not torch.equal(leaves_p[i], leaves_m[i])]
    if differ:
        fail(f"(h) gradient leaves that differ on the (1, 1) mesh: {differ}")
    ids = batch["tokens"].reshape(-1).long()
    bound = embed_bound(torch, ids, dh[0], params["embed"].shape[0])
    diff = (leaves_p[emb_i].double() - leaves_m[emb_i].double()).abs()
    if not bool((diff <= bound).all()):
        fail(f"(h) the embedding's gradient on the mesh differs past its "
             f"summation-order bound: {float((diff - bound).max()):.3g}")
    emb_diff, emb_bound = float(diff.max()), float(bound.max())
    del dh, diff, bound, leaves_p, leaves_m
    new_p, mp = plain.update(state, got_p)
    del got_p
    new_m, mm = step.update(state, got_m)
    del got_m
    gp, gm = float(mp["grad_norm"]), float(mm["grad_norm"])
    if not (torch.equal(mp["loss"], mm["loss"])
            and abs(gm - gp) <= MESH_GNORM_RTOL * gp):
        fail(f"(h) the mesh step's loss {float(mm['loss'])!r} / grad_norm "
             f"{gm!r} against the one-device step's {float(mp['loss'])!r} "
             f"/ {gp!r} (grad_norm rtol {MESH_GNORM_RTOL})")
    lr = float(mp["lr"])
    same_norm = torch.equal(mp["grad_norm"], mm["grad_norm"])
    worst, bitwise, n_leaves = 0.0, 0, 0
    for (path, a), (_, b) in zip(flat_state(new_p), flat_state(new_m)):
        n_leaves += 1
        if torch.equal(a, b):
            bitwise += 1
            continue
        err = float((a - b).abs().max())
        top = float(b.abs().max())
        if "['embed']" in path and ("['params']" in path
                                    or "['master']" in path):
            limit = 2 * MESH_UPDATE_MAX * lr + 1e-6 * top
        elif "['embed']" in path or not same_norm:
            limit = MESH_STATE_RTOL * top
        else:
            limit = 0.0
        if err > limit:
            fail(f"(h) state leaf {path}: the mesh step's differs from the "
                 f"one-device step's by {err:.3g} (limit {limit:.3g}; "
                 f"grad_norm bitwise equal: {same_norm})")
        worst = max(worst, err / max(top, 1e-30))
    del new_p
    log(f"[check] (h) the (1, 1) mesh step == the one-device step from one "
        f"state: loss bitwise ({float(mm['loss']):.6f}), {n - 1} of {n} "
        f"gradient leaves bitwise, the embedding's within the atomics bound "
        f"(max |diff| {emb_diff:.3g}, bound up to {emb_bound:.3g}); "
        f"grad_norm {gm!r} / {gp!r}; {bitwise} of {n_leaves} state leaves "
        f"bitwise, the rest within {worst:.3g} of their max")
    return new_m, {"embed_max_diff": emb_diff, "state_bitwise": bitwise,
                   "state_leaves": n_leaves, "grad_norm_equal": same_norm,
                   "state_worst": worst}


def mesh_train_path(torch, np, args, dev, phases, holder, batches,
                    phase16_ms):
    """Phase 17: TinyLlama-1.1B (phase 16's state, taken from ``holder``,
    and batches) through make_train_step on the (1, 1) training mesh over
    an in-process NCCL group of world size 1 (a HashStore): gate (h)
    from the state, then one warm-up step and MESH_STEPS steps between
    CUDA events, each with its flash launches (gate (i): 2L, the forward
    and the recomputed one) and each worker's request set (gate (j): U,
    the distinct ids of the sharded lookup, equal to token_stats of the
    worker's slice).  Returns the phase's summary."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import shardings as sh
    from repro_torch.models import embedding as emb
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf
    from repro_torch.train import data as tdata
    from repro_torch.train import train_step as ts
    cfg = get_config(TRAIN_ARCH)
    L, B, S = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ
    T = B * S
    state = holder.pop()
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = meshlib.make_mesh((1, 1), ("data", "model"))
        setup_s = time.perf_counter() - t0
        # ZeRO-1 and fsdp's placement: at data size 1 the plain one
        specs = sh.placement_specs(sh.train_state_specs(
            cfg, mesh, ts.abstract_train_state(cfg, 1, torch.float32),
            zero1=True, fsdp=True))
        if sh.data_leaves(specs):
            fail(f"(h) leaves split over the data axes of a (1, 1) mesh: "
                 f"{sorted(sh.data_leaves(specs))[:4]}")
        step = ts.make_train_step(cfg, tf.ModelContext(mesh=mesh),
                                  specs=specs)
        state, gate_h = phases.run("mesh-train-gate-h", mesh_gate_h, torch,
                                   zoo, tf, ts, cfg, state, batches[1], step)
        torch.cuda.synchronize()
        # gate (h)'s second state leaves the allocator's cache before the
        # warm-up, so that the timed steps reuse the warm-up's blocks
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, _ = step(state, batches[0])                   # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        step_ms, launches, losses, stats = [], [], [], []
        for i in range(MESH_STEPS):
            batch = batches[1 + i]
            fk.flash_attention_bhsd.launches = 0        # the path starts here
            emb.record = []
            try:
                ev[0].record()
                state, m = step(state, batch)
                ev[1].record()
                ev[1].synchronize()
                recs = emb.record
            finally:
                emb.record = None
            launches.append(fk.flash_attention_bhsd.launches)  # ... ends here
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(m["loss"]))
            if len(recs) != mesh.data_size:
                fail(f"(j) {len(recs)} sharded lookups in a step, expected "
                     f"one a worker ({mesh.data_size})")
            want = tdata.token_stats(batch["tokens"].cpu().numpy())
            U = int(recs[0]["unique"])
            if (U, recs[0]["tokens"]) != (want["unique"], want["tokens"]):
                fail(f"(j) the worker's lookup saw T {recs[0]['tokens']}, U "
                     f"{U}; token_stats of its slice {want}")
            stats.append({"T": recs[0]["tokens"], "U": U,
                          "cap": recs[0]["cap"]})
        peak = torch.cuda.max_memory_allocated()
    finally:
        meshlib.destroy()
    if any(n != 2 * L for n in launches):
        fail(f"(i) flash launches a mesh step {launches}: expected {2 * L}")
    if not all(map(math.isfinite, losses)):
        fail(f"(e) non-finite loss on the mesh: {losses}")
    med = float(np.median(step_ms))
    D, V = cfg.d_model, cfg.padded_vocab(1)
    for st in stats:
        log(f"[mesh-train] {cfg.name} on the (1, 1) mesh, worker 0: T "
            f"{st['T']}, U {st['U']} (cap {st['cap']}), U/T "
            f"{st['U'] / st['T']:.4f}; responses U x D x 4 = "
            f"{st['U'] * D * 4 / 1e6:.2f} MB against the all-gathered "
            f"table's V x D x 4 = {V * D * 4 / 1e6:.2f} MB")
    log(f"[mesh-train] {cfg.name}: {med:.3f} ms a step on the (1, 1) mesh "
        f"(median of {MESH_STEPS}; each " + ", ".join(
            f"{x:.3f}" for x in step_ms) + f"), {T / med * 1e3:.0f} "
        f"tokens/s; phase 16's step without a mesh {phase16_ms:.3f} ms "
        f"(mesh / none {med / phase16_ms:.4f}); flash launches a step "
        f"{launches}; loss {', '.join(f'{x:.4f}' for x in losses)}; peak "
        f"device memory {peak / 2**30:.2f} GiB; the warm-up step "
        f"{warm_s * 1e3:.3f} ms host clock; NCCL group and mesh "
        f"{setup_s:.3f} s")
    return {"launches": sum(launches), "steps": MESH_STEPS,
            "step_ms": step_ms, "median_ms": med,
            "tokens_per_s": T / med * 1e3, "phase16_ms": phase16_ms,
            "peak_gib": peak / 2**30, "losses": losses, "workers": stats,
            "response_bytes": stats[0]["U"] * D * 4,
            "table_bytes": V * D * 4, "gate_h": gate_h, "setup_s": setup_s,
            "warm_ms": warm_s * 1e3}


def mesh_spawns(count: int):
    """The (2, 2) mesh's spawn: (backend, world size): NCCL with a card a
    rank where the machine has MESH_RANKS cards, else gloo with every rank
    on cuda:0."""
    return ("nccl" if count >= MESH_RANKS else "gloo"), MESH_RANKS


def state_bytes(sh, tree, specs, abstract, mesh) -> dict:
    """{"params" | "opt": (bytes allocated, bytes implied)}: the bytes of
    the storages behind a train state's tensors on this rank (each storage
    once a tree), and what ``local_shape`` of each placed spec implies for
    the state's leaves (``abstract``, on the meta device)."""
    from repro_torch.train.optimizer import tree_leaves
    out = {}
    for part in ("params", "opt"):
        seen = {}
        for t in tree_leaves(tree[part]):
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
        implied = []
        sh._zip(abstract[part], specs[part], lambda path, leaf, spec:
                implied.append(math.prod(sh.local_shape(
                    spec, tuple(leaf.shape), mesh)) * leaf.element_size()))
        out[part] = (sum(seen.values()), sum(implied))
    return out


def experts_whole(sh, specs, path=()):
    """A placed spec tree with the routed expert stacks whole (the
    placement before stored expert shards)."""
    if isinstance(specs, dict):
        return {k: experts_whole(sh, v, path + (k,))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [experts_whole(sh, v, path) for v in specs]
    if path[-2:-1] == ("moe",) and path[-1] in sh.EXPERT_LEAVES:
        return (None,) * len(specs)
    return specs


def mesh_rank_refs(torch, ts, ModelContext, init_opt_state, cfg, step_cfg,
                   params, batch):
    """Rank 0's one-device steps from the whole state: {path: leaf} of
    the new state on the global batch (``one``) and the m and v of the
    same step in 2 microbatches (``alt``: another summation order), the
    one-device loss, grad_norm and lr."""
    from repro_torch.launch import shardings as sh
    state = {"params": params, "opt": init_opt_state(params)}
    one, m1 = ts.make_train_step(cfg, ModelContext(), step_cfg)(state, batch)
    alt, _ = ts.make_train_step(cfg, ModelContext(), dataclasses.replace(
        step_cfg, n_microbatches=2))(state, batch)
    del state
    flat = {}
    sh._walk(one, lambda path, t: flat.setdefault(("one",) + path, t))
    sh._walk(alt["opt"], lambda path, t: flat.setdefault(
        ("alt", "opt") + path, t) if path[0] in ("m", "v") else None)
    return flat, {"loss_one": float(m1["loss"]),
                  "grad_norm_one": float(m1["grad_norm"]),
                  "lr": float(m1["lr"])}


def mesh_rank_errs(torch, sh, new, specs, mesh, params0, refs, lr):
    """Gather the mesh step's state leaf by leaf (every rank takes part)
    and, on rank 0, hold each leaf to the one-device step's (``refs``):
    {path: (err, bound)}, see MESH_RANK_SHAPE's comment (params and
    master: the sign-flip bound and the change rule, as a ratio against
    1; m and v: the larger of a fraction of the max and PLAIN_FACTOR times
    two one-device orders' distance; the step bitwise).  None elsewhere."""
    leaves = []
    sh._zip(new, specs, lambda path, leaf, spec: leaves.append(
        (path, leaf, spec)))
    errs = {}
    for path, leaf, spec in leaves:
        g = sh.gather_tree({"x": leaf}, {"x": spec}, mesh)["x"]
        if mesh.rank != 0:
            continue
        w = refs[("one",) + path]
        if path[-1] == "step":
            errs[path] = (0.0 if torch.equal(g, w) else 1.0, 0.0)
            continue
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        if path[:2] in (("opt", "m"), ("opt", "v")):
            rtol = MESH_M_RTOL if path[1] == "m" else MESH_V_RTOL
            noise = float((refs[("alt",) + path] - w).abs().max())
            errs[path] = (err, max(rtol * top, PLAIN_FACTOR * noise))
            continue
        s0 = params0
        for k in path[1:] if path[0] == "params" else path[2:]:
            s0 = s0[int(k)] if isinstance(s0, list) else s0[k]
        bound = 2 * MESH_UPDATE_MAX * lr + 1e-6 * top
        dw, dg = (w - s0).double(), (g - s0).double()
        change = float((dg - dw).norm()) / max(float(dw.norm()), 1e-30)
        errs[path] = (max(err / bound, change / MESH_CHANGE_RTOL), 1.0)
    return errs if mesh.rank == 0 else None


def mesh_rank_arch(torch, cfg, step_cfg, B, S, placements, mesh, dev, seed,
                   out, warm_up=False):
    """One arch on the (2, 2) mesh: its whole params drawn from ``seed``
    (the same on every rank), then for each placement of ``placements``
    ("tp": ``train_state_specs`` plain; "zero1", "fsdp": that flag) this
    rank's blocks of the train state, one step of make_train_step on the
    global batch of B x S with its flash launches, its collectives
    (``record_collectives``, for phase 20's gate 2), peak memory, host
    seconds and bytes, and the new state held to the one-device step on
    rank 0 (``mesh_rank_errs``).  Adds a run a placement to ``out``.
    ``warm_up``: one step of the tensor-parallel placement first, outside
    the runs (a process's first step also pays for its CUDA libraries'
    and gloo's first use: 13.9 s against 2.1-2.3 s a step after it on an
    H100 at 700 W)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.comm_stats import record_collectives
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe
    from repro_torch.models.transformer import ModelContext
    from repro_torch.train import data as tdata
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import init_opt_state
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                             dev)
    if cfg.tie_embeddings:
        params["out_embed"] = params["embed"].clone()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tdata.SyntheticLM(
        tdata.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                         seed=seed)).batch_at(0).items()}
    abstract = ts.abstract_train_state(cfg, mesh.model_size, torch.float32)
    tp_specs = sh.placement_specs(sh.train_state_specs(cfg, mesh, abstract))
    empty = {"params": {}, "opt": {}}
    tp_implied = {k: v[1] for k, v in state_bytes(
        sh, empty, tp_specs, abstract, mesh).items()}
    if cfg.is_moe:      # and with the expert stacks whole on every rank
        tp_implied["experts_whole"] = {k: v[1] for k, v in state_bytes(
            sh, empty, experts_whole(sh, tp_specs), abstract,
            mesh).items()}
    if warm_up:
        local = {"params": sh.shard_tree(params, tp_specs["params"], mesh),
                 "opt": init_opt_state(sh.shard_tree(
                     params, tp_specs["opt"]["master"], mesh))}
        ts.make_train_step(cfg, ModelContext(mesh=mesh), step_cfg,
                           tp_specs)(local, batch)
        del local
    refs = None
    for placement in placements:
        kw = {} if placement == "tp" else {placement: True}
        specs = sh.placement_specs(sh.train_state_specs(cfg, mesh, abstract,
                                                        **kw))
        local = {"params": sh.shard_tree(params, specs["params"], mesh),
                 "opt": init_opt_state(sh.shard_tree(
                     params, specs["opt"]["master"], mesh))}
        placed = state_bytes(sh, local, specs, abstract, mesh)
        step = ts.make_train_step(cfg, ModelContext(mesh=mesh), step_cfg,
                                  specs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fk.flash_attention_bhsd.launches = 0        # the path starts here
        moe.record = [] if cfg.is_moe else None
        t0 = time.perf_counter()
        try:
            with record_collectives() as rec:
                new, m = step(local, batch)
            torch.cuda.synchronize()
            recs = moe.record
        finally:
            moe.record = None
        wall = time.perf_counter() - t0
        launches = fk.flash_attention_bhsd.launches    # ... ends here
        peak = torch.cuda.max_memory_allocated(dev)
        del local
        drops = sum(int(r["pairs"]) - int(r["kept"].sum())
                    for r in recs or ())
        run = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_s": wall, "peak_gib": peak / 2**30,
               "launches": launches, "layers": cfg.n_layers,
               "moe_records": len(recs or ()), "drops": drops,
               "placed": placed,
               "new": state_bytes(sh, new, specs, abstract, mesh),
               "tp_implied": tp_implied,
               "embed_shape": tuple(new["params"]["embed"].shape),
               "collectives": [dataclasses.asdict(op) for op in rec.ops]}
        if cfg.is_moe:
            run["expert_rows"] = new["params"]["stages"][0]["layers"][
                "moe"]["w_gate"].shape[1]
        if refs is None and mesh.rank == 0:
            refs, figures = mesh_rank_refs(torch, ts, ModelContext,
                                           init_opt_state, cfg, step_cfg,
                                           params, batch)
        if mesh.rank == 0:
            run.update(figures)
        run["errs"] = mesh_rank_errs(torch, sh, new, specs, mesh, params,
                                     refs, run.get("lr", 0.0))
        del new
        out["runs"][f"{cfg.name} {placement}"] = run
    del refs, params
    torch.cuda.empty_cache()


def mesh_rank_archs():
    """The (2, 2) ranks' models, each (cfg, step config, B, S,
    placements): TinyLlama at full width with its depth cut to
    MESH_RANK_LAYERS under the tensor-parallel placement, ZeRO-1 and
    fsdp, then OLMoE-1B-7B at full width with its depth cut to
    MESH_OLMOE_LAYERS under fsdp (see MESH_RANK_SHAPE's and MESH_OLMOE's
    comments).  A run's key is "<cfg.name> <placement>"."""
    from repro_torch.configs.base import get_config
    from repro_torch.train import train_step as ts
    tiny = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=MESH_RANK_LAYERS)
    olmoe = get_config(OLMOE_ARCH)
    olmoe = dataclasses.replace(
        olmoe, n_layers=MESH_OLMOE_LAYERS, moe=dataclasses.replace(
            olmoe.moe, capacity_factor=olmoe.moe.n_experts
            / olmoe.moe.top_k))
    return [(tiny, ts.StepConfig(), TRAIN_BATCH, TRAIN_SEQ,
             ("tp", "zero1", "fsdp")),
            (olmoe, ts.StepConfig(aux_weight=0.0), MESH_OLMOE_BATCH,
             MESH_OLMOE_SEQ, ("fsdp",))]


def mesh_rank(rank, D, backend, init_method, seed, out_path):
    """One rank of the (2, 2) mesh (see MESH_RANK_SHAPE's and
    MESH_OLMOE's comments): TinyLlama at full width with its depth cut to
    MESH_RANK_LAYERS under the tensor-parallel placement, ZeRO-1 and fsdp,
    then OLMoE-1B-7B at full width with its depth cut to
    MESH_OLMOE_LAYERS under fsdp with its experts stored, a step each
    (``mesh_rank_archs``, ``mesh_rank_arch``: each step's collectives
    recorded); rank 0 holds each run to the one-device step.  Writes its
    figures."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=D, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = meshlib.make_mesh(MESH_RANK_SHAPE, ("data", "model"))
        out = {"rank": rank, "runs": {}}
        for i, (cfg, step_cfg, B, S, placements) in enumerate(
                mesh_rank_archs()):
            mesh_rank_arch(torch, cfg, step_cfg, B, S, placements, mesh, dev,
                           seed, out, warm_up=i == 0)
        Path(f"{out_path}.{rank}").write_bytes(pickle.dumps(out))
    finally:
        meshlib.destroy()


def mesh_rank_gate(key, outs):
    """The gates of one run of the (2, 2) ranks (fail on any): the same
    loss on every rank; rank 0's loss and grad_norm against one device
    and every gathered leaf within its bound; each rank's flash launches
    2 a layer (the forward and the recomputed one); no MoE pair dropped;
    each rank's bytes of params and of optimizer state, placed and after
    the step, equal to what the placed specs imply.  Returns the figures
    of its lines."""
    runs = [o["runs"][key] for o in outs]
    r0 = runs[0]
    if len({r["loss"] for r in runs}) != 1:
        fail(f"[mesh-ranks] {key}: the ranks' losses differ: "
             f"{[r['loss'] for r in runs]}")
    dl = abs(r0["loss"] - r0["loss_one"]) / abs(r0["loss_one"])
    dg = abs(r0["grad_norm"] - r0["grad_norm_one"]) / r0["grad_norm_one"]
    bad = {p: e for p, e in r0["errs"].items() if not e[0] <= e[1]}
    if dl > MESH_LOSS_RTOL or dg > MESH_RANK_GNORM_RTOL or bad:
        fail(f"[mesh-ranks] {key} on the (2, 2) mesh against one device: "
             f"loss rtol {dl:.3g} (limit {MESH_LOSS_RTOL}), grad_norm "
             f"{dg:.3g} (limit {MESH_RANK_GNORM_RTOL}), leaves past their "
             f"bound: {list(bad.items())[:6]}")
    launches = [r["launches"] for r in runs]
    if any(n != 2 * r0["layers"] for n in launches):
        fail(f"[mesh-ranks] {key}: flash launches a rank {launches}, "
             f"expected {2 * r0['layers']} (the forward and the recomputed "
             "one, a layer)")
    moe_layers = r0["layers"] if r0.get("expert_rows") else 0
    if any(r["drops"] or r["moe_records"] != moe_layers for r in runs):
        fail(f"[mesh-ranks] {key}: MoE records "
             f"{[r['moe_records'] for r in runs]}, dropped pairs "
             f"{[r['drops'] for r in runs]}: expected one record a layer "
             "and no drop on every rank")
    for rank, r in enumerate(runs):
        for when in ("placed", "new"):
            for part, (got, want) in r[when].items():
                if got != want:
                    fail(f"[mesh-zero] {key} rank {rank}: {part} holds "
                         f"{got} bytes {when}, its placed specs imply "
                         f"{want}")

    def ratio(part):
        return max(e / max(b, 1e-30) for p, (e, b) in r0["errs"].items()
                   if p[:2] in part or p[:1] in part)
    return {"loss": r0["loss"], "loss_one": r0["loss_one"],
            "loss_rtol": dl, "grad_norm_rtol": dg,
            "mv_worst": ratio((("opt", "m"), ("opt", "v"))),
            "params_worst": ratio((("params",), ("opt", "master"))),
            "step_s": [r["wall_s"] for r in runs],
            "peak_gib": [r["peak_gib"] for r in runs],
            "launches": launches,
            "bytes": [{p: r["new"][p][0] for p in ("params", "opt")}
                      for r in runs],
            "placed": [{p: r["placed"][p][0] for p in ("params", "opt")}
                       for r in runs],
            "tp_implied": [r["tp_implied"] for r in runs],
            "embed_shape": r0["embed_shape"],
            "expert_rows": r0.get("expert_rows")}


def mesh_ranks_path(seed):
    """The (2, 2) training mesh on MESH_RANKS spawned ranks (see
    MESH_RANK_SHAPE's and MESH_OLMOE's comments): every run's gates
    (``mesh_rank_gate``), its ``[mesh-ranks]`` and ``[mesh-zero]``
    lines."""
    import pickle
    import tempfile
    import torch
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    backend, D = mesh_spawns(torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(mesh_rank, (D, backend, rendezvous(tmp), seed,
                                str(Path(tmp) / "rank")), D, MESH_JOIN_S)
        wall = time.perf_counter() - t0
        outs = [pickle.loads((Path(tmp) / f"rank.{r}").read_bytes())
                for r in range(D)]
    staging = " (gloo stages through the host)" if backend == "gloo" else ""
    runs = {}
    for key in outs[0]["runs"]:
        g = runs[key] = mesh_rank_gate(key, outs)
        errs = outs[0]["runs"][key]["errs"]
        for path, (e, b) in sorted(errs.items(), key=lambda x: -x[1][0]
                                   / max(x[1][1], 1e-30))[:2]:
            log(f"[mesh-ranks] {key} {'/'.join(path)}: {e:.3g} against its "
                f"bound {b:.3g}")
        log(f"[mesh-ranks] {key} on the {MESH_RANK_SHAPE} mesh ({backend}, "
            f"{D} ranks, embed {g['embed_shape']} a rank"
            + (f", {g['expert_rows']} experts a rank" if g["expert_rows"]
               else "") + f"): loss {g['loss']:.6f} (one device "
            f"{g['loss_one']:.6f}, rtol {g['loss_rtol']:.3g}), grad_norm "
            f"rtol {g['grad_norm_rtol']:.3g}; every gathered leaf within "
            f"its bound: m / v at {g['mv_worst']:.3g} of theirs, params / "
            f"master at {g['params_worst']:.3g} of the sign-flip bound and "
            f"the change rule; flash launches a rank {g['launches']}")
        for rank in range(D):
            b, tp = g["bytes"][rank], g["tp_implied"][rank]
            whole = tp.get("experts_whole")
            log(f"[mesh-zero] {key} rank {rank}: params {b['params']} B, "
                f"optimizer state {b['opt']} B as allocated, equal to the "
                f"placed specs' (the tensor-parallel placement's "
                f"{tp['params']} B and {tp['opt']} B; state "
                f"{(b['params'] + b['opt']) / (tp['params'] + tp['opt']):.4f}"
                f"x" + (f"; with the experts whole {whole['params']} B and "
                        f"{whole['opt']} B" if whole else "")
                + "); peak device memory of the step "
                f"{g['peak_gib'][rank]:.3f} GiB; step {g['step_s'][rank]:.3f}"
                f" s host clock{staging}")
    log(f"[mesh-ranks] {len(runs)} runs in {wall:.1f} s of spawned program")
    # rank 0's recorded collectives of each run, for phase 20's gate 2
    # (kept apart from the summary line)
    return {"backend": backend, "D": D, "wall_s": wall, "runs": runs,
            "collectives": {k: r["collectives"]
                            for k, r in outs[0]["runs"].items()}}


# ---------------------------------------------------------------------------
# phase 18: serving on the (1, 2) mesh (tensor parallelism, the cache's
# sequence split)
# ---------------------------------------------------------------------------

def serve_mesh_spawns(count: int):
    """Phase 18's spawn: (backend, world size): NCCL with a card a rank
    where the machine has SERVE_MESH_RANKS cards, else gloo on cuda:0."""
    return ("nccl" if count >= SERVE_MESH_RANKS else "gloo"), SERVE_MESH_RANKS


def serve_mesh_bound(torch, got, auto, ref, floor=SERVE_MESH_FLOOR):
    """(distance of ``got`` from ``auto``, its bound): relative to
    max|auto|, the bound the larger of ``floor`` and PLAIN_FACTOR times
    ``ref``'s distance from ``auto``."""
    return (rel_max(torch, got, auto),
            max(floor, PLAIN_FACTOR * rel_max(torch, ref, auto)))


def serve_mesh_arch(torch, np, arch, over, mesh, dev, seed, rank):
    """One model served on this rank of the mesh; on rank 0 also on one
    device, and the gates.  Returns this rank's figures."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    from repro_torch.launch import shardings as sh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch), **over)
    B, S, G = SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_GEN
    L = S + G
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    pspecs = sh.placement_specs(sh.param_specs(
        cfg, mesh, zoo.abstract_params(cfg, mesh.model_size)))
    local = sh.shard_tree(params, pspecs, mesh)
    prompts = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64), mesh=mesh)
    lspec = sh.logits_spec(cfg, ShapeConfig("serve", 1, B, "decode"), mesh)
    cspecs = zoo.cache_placement(cfg, B, L, mesh)
    stages = tf.build_stages(cfg)
    n_attn = sum(s.n_layers for s in stages if s.kind != "ssm")
    n_ssm = sum(s.n_layers for s in stages if s.kind in ("ssm", "hybrid"))

    def whole(lg):
        return sh.gather_tree({"x": lg}, {"x": lspec}, mesh)["x"]

    def served(prefill_ms=None):
        """Prefill and G greedy decode steps on the mesh: (logits, tokens,
        this rank's cache); ``prefill_ms`` (a list) gets the prefill's and
        each step's device ms."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 2)]
        with torch.no_grad():
            ev[0].record()
            lg, cache = zoo.prefill(local, cfg, ctx, prompts, max_len=L)
            logits = [whole(lg)]
            ev[1].record()
            toks = [zoo.greedy(logits[-1])]
            for i in range(G):
                lg, cache = zoo.decode_step(local, cfg, ctx, toks[-1], cache,
                                            max_len=L)
                logits.append(whole(lg))
                ev[i + 2].record()
                toks.append(zoo.greedy(logits[-1]))
        torch.cuda.synchronize()
        if prefill_ms is not None:
            prefill_ms += [ev[i].elapsed_time(ev[i + 1])
                           for i in range(G + 1)]
        return logits, toks, cache

    served()                                  # warm (allocator, cuBLAS)
    torch.cuda.synchronize()
    fk.flash_attention_bhsd.launches = 0      # the counted run starts here
    sk.ssd_chunk_scan.launches = 0
    ms = []
    t0 = time.perf_counter()
    logits, toks, cache = served(ms)
    host_s = time.perf_counter() - t0
    launches = (fk.flash_attention_bhsd.launches,   # ... and ends here
                sk.ssd_chunk_scan.launches)
    if launches != (n_attn, n_ssm):
        fail(f"[serve-mesh] {arch} rank {rank}: launches (flash, SSD) "
             f"{launches} in the prefill and {G} decode steps, expected "
             f"({n_attn}, {n_ssm}): the path did not go through the kernels")
    # each rank's kernel launches against the plain version on its inputs
    seen = record_launches({"flash": fk, "ssd": sk}, lambda: zoo.prefill(
        local, cfg, ctx, prompts, max_len=L))
    f_rows = flash_rows(torch, seen["flash"], fk, flash_attention_ref)
    s_rows = ssd_rows(torch, seen["ssd"], sk, ssd_scan_ref_model)
    del seen
    shapes = sorted({(r["BH"], r["S"], r["d"], r["n_rep"], r["window"])
                     for r in f_rows})
    out = {"launches": launches, "flash_shapes": shapes,
           "ssd_shapes": sorted({(r["b"], r["S"], r["h"], r["P"], r["N"])
                                 for r in s_rows}),
           "flash_rel_err": max((r["rel_err"] for r in f_rows), default=0.0),
           "ssd_rel_err": max((r["rel_err"] for r in s_rows), default=0.0),
           "flash_ms": sum(r["ms"] for r in f_rows),
           "ssd_ms": sum(r["ms"] for r in s_rows),
           "prefill_ms": ms[0], "decode_ms": float(np.median(ms[1:])),
           "host_s": host_s, "local_k": [
               tuple(c["k"].shape) for c in cache["stages"] if "k" in c]}
    # the first layers one by one on the same input, teacher-forced on the
    # served tokens: the no-cache forward over S + G positions, and the
    # prefill of the first S and G decode steps (the mesh's forward output
    # is the next layer's input on both sides)
    one = tf.ModelContext(q_chunk=max(S, 64))
    ref = tf.ModelContext(q_chunk=max(S, 64), kernels="ref")
    seq = torch.cat([prompts] + toks[:-1], dim=1)            # (B, S + G)
    pos = torch.arange(S + G, dtype=torch.int32, device=dev).expand(B, S + G)
    stage_of = [i for i, st in enumerate(stages) for _ in range(st.n_layers)]

    def decoded(h, stage, w, c, si):
        """The layer's prefill of h's first S positions, then its decode
        of the next G one at a time: (B, G, D)."""
        clen = zoo._stage_cache_len(stage, L)
        _, kv, _ = tf.apply_stage_seq(h[:, :S], w, stage, cfg, c,
                                      pos[:, :S], want_cache=True,
                                      cache_len=clen)
        seq_group = None
        if stage.kind != "ssm":
            kv["k_pos"] = tf.stage_kpos(B, S, clen, dev)
        if c.mesh is not None:
            kv = zoo._place_stage_cache(kv, cspecs["stages"][si], cfg, mesh)
            if "k" in kv:
                seq_group = zoo._seq_group(cspecs["stages"][si]["k"], mesh)
        p = torch.full((B,), S, dtype=torch.int32, device=dev)
        outs = []
        for i in range(G):
            o, kv = tf.apply_stage_decode(h[:, S + i:S + i + 1], w, stage,
                                          cfg, c, p + i, kv,
                                          seq_group=seq_group)
            outs.append(o)
        return torch.cat(outs, dim=1)
    layer_errs, decode_errs = [], []
    with torch.no_grad():
        h = zoo._embed_in(params, cfg, seq, one)
        mine = one_layer_stages(local, cfg)[:SERVE_MESH_CHECK_LAYERS]
        whole_layers = one_layer_stages(params, cfg)[:SERVE_MESH_CHECK_LAYERS]
        for li, ((stage, sp), (_, wp)) in enumerate(zip(mine, whole_layers)):
            si = stage_of[li]
            h_m = tf.apply_stage_seq(h, sp, stage, cfg, ctx, pos)[0]
            d_m = decoded(h, stage, sp, ctx, si)
            if rank == 0:
                h_a = tf.apply_stage_seq(h, wp, stage, cfg, one, pos)[0]
                h_r = tf.apply_stage_seq(h, wp, stage, cfg, ref, pos)[0]
                layer_errs.append(serve_mesh_bound(torch, h_m - h, h_a - h,
                                                   h_r - h))
                base = h[:, S:]
                decode_errs.append(serve_mesh_bound(
                    torch, d_m - base, decoded(h, stage, wp, one, si) - base,
                    decoded(h, stage, wp, ref, si) - base))
            h = h_m
    gathered = sh.gather_tree(cache, cspecs, mesh)
    del cache
    if rank != 0:
        return out

    def one_device(c):
        """The one-device prefill and decode steps fed the mesh's
        tokens."""
        with torch.no_grad():
            lg, kv = zoo.prefill(params, cfg, c, prompts, max_len=L)
            got = [lg]
            for t in toks[:-1]:
                lg, kv = zoo.decode_step(params, cfg, c, t, kv)
                got.append(lg)
        return got, kv
    auto, auto_cache = one_device(one)
    plain, plain_cache = one_device(ref)
    V = cfg.vocab
    step_errs = [serve_mesh_bound(torch, m[:, :V], a[:, :V], p[:, :V],
                                  SERVE_MESH_FLOOR if i == 0
                                  else SERVE_MESH_CHAIN_FLOOR)
                 for i, (m, a, p) in enumerate(zip(logits, auto, plain))]
    # the greedy tokens where the one-device top-2 margin clears the bound
    tok_bad = tok_checked = 0
    for (e, b), a, t in zip(step_errs, auto, toks):
        top2 = torch.topk(a[:, :V], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > b * float(a[:, :V].abs().max())
        want = zoo.greedy(a)[:, 0]
        tok_checked += int(clear.sum())
        tok_bad += int(((want != t[:, 0]) & clear).sum())
    cache_errs = {}
    flat_m = dict(flat_state(gathered))
    for (path, a), (_, p) in zip(flat_state(auto_cache),
                                 flat_state(plain_cache)):
        m = flat_m[path]
        if path.endswith("['k_pos']") or path == "['pos']":
            cache_errs[path] = (0.0 if torch.equal(m, a) else 1.0, 0.0)
        else:
            cache_errs[path] = serve_mesh_bound(torch, m.float(), a.float(),
                                                p.float())
    bad = ([f"layer {i}: {e:.3g} > {b:.3g}" for i, (e, b) in
            enumerate(layer_errs) if not e <= b]
           + [f"decode layer {i}: {e:.3g} > {b:.3g}" for i, (e, b) in
              enumerate(decode_errs) if not e <= b]
           + [f"logits {i}: {e:.3g} > {b:.3g}" for i, (e, b) in
              enumerate(step_errs) if not e <= b]
           + [f"cache {p}: {e:.3g} > {b:.3g}" for p, (e, b) in
              cache_errs.items() if not e <= b])
    if tok_bad:
        bad.append(f"{tok_bad} of {tok_checked} clear greedy tokens differ")
    if bad:
        fail(f"[serve-mesh] {arch} on the {SERVE_MESH_SHAPE} mesh against one "
             f"device: {bad[:8]}")
    out.update(layer_errs=layer_errs, decode_errs=decode_errs,
               step_errs=step_errs,
               cache_worst=max(cache_errs.items(),
                               key=lambda x: x[1][0] / max(x[1][1], 1e-30)),
               tokens_checked=tok_checked, tokens_total=B * (G + 1))
    return out


def serve_mesh_rank(rank, D, backend, init_method, seed, out_path):
    """One rank of phase 18: each model of SERVE_MESH_ARCHS served on the
    (1, 2) mesh (``serve_mesh_arch``); writes its figures."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=D, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = meshlib.make_mesh(SERVE_MESH_SHAPE, ("data", "model"))
        out = {arch: serve_mesh_arch(torch, np, arch, over, mesh, dev, seed,
                                     rank)
               for arch, over in SERVE_MESH_ARCHS}
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        Path(f"{out_path}.{rank}").write_bytes(pickle.dumps(out))
    finally:
        meshlib.destroy()


def serve_mesh_path(seed):
    """Phase 18 on SERVE_MESH_RANKS spawned ranks: the gates run on rank 0
    (``serve_mesh_arch``); prints the ``[serve-mesh]`` lines and returns
    the figures of every rank."""
    import pickle
    import tempfile
    import torch
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    backend, D = serve_mesh_spawns(torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(serve_mesh_rank, (D, backend, rendezvous(tmp), seed,
                                      str(Path(tmp) / "rank")), D,
                    SERVE_MESH_JOIN_S)
        wall = time.perf_counter() - t0
        outs = [pickle.loads((Path(tmp) / f"rank.{r}").read_bytes())
                for r in range(D)]
    B, S, G = SERVE_MESH_BATCH, SERVE_MESH_PROMPT, SERVE_MESH_GEN
    summary = {"backend": backend, "D": D, "wall_s": wall,
               "peak_gib": [o["peak_gib"] for o in outs]}
    for arch, _ in SERVE_MESH_ARCHS:
        r0 = outs[0][arch]
        for r, o in enumerate(outs):
            a = o[arch]
            log(f"[serve-mesh] {arch} rank {r}: {a['launches'][0]} flash "
                f"launches at (BH, S, d, n_rep, window) {a['flash_shapes']}, "
                f"{a['launches'][1]} SSD at (b, S, h, P, N) "
                f"{a['ssd_shapes']}; against the float64 plain version: "
                f"flash {a['flash_rel_err']:.3g}, SSD {a['ssd_rel_err']:.3g}"
                f" of max; kernel time flash {a['flash_ms']:.3f} ms, SSD "
                f"{a['ssd_ms']:.3f} ms a prefill; cache blocks (k) "
                f"{a['local_k']}")
        log(f"[serve-mesh] {arch} on the {SERVE_MESH_SHAPE} mesh ({backend}, "
            f"{D} ranks): B={B} prompt={S} gen={G}: prefill "
            f"{r0['prefill_ms']:.3f} ms, decode {r0['decode_ms']:.3f} ms a "
            f"step (median; device clock of rank 0, "
            + ("gloo staging every collective through the host, "
               if backend == "gloo" else "")
            + f"both ranks on one card), {r0['host_s']:.3f} s host for the "
            "request")
        log(f"[serve-mesh] {arch} against one device: layers (forward) "
            + ", ".join(f"{e:.3g} (bound {b:.3g})" for e, b in
                        r0["layer_errs"])
            + "; layers (prefill + decode, teacher-forced) "
            + ", ".join(f"{e:.3g} (bound {b:.3g})" for e, b in
                        r0["decode_errs"])
            + "; logits of the prefill and each step, worst "
            + "{:.3g} (bound {:.3g})".format(*max(
                r0["step_errs"], key=lambda x: x[0] / x[1]))
            + f"; cache worst {r0['cache_worst'][0]} "
            + "{:.3g} (bound {:.3g})".format(*r0["cache_worst"][1])
            + f"; greedy tokens equal at {r0['tokens_checked']} of "
            f"{r0['tokens_total']} with a clear one-device margin")
        summary[arch] = {
            "launches_per_rank": [o[arch]["launches"] for o in outs],
            "flash_shapes": r0["flash_shapes"],
            "ssd_shapes": r0["ssd_shapes"],
            "prefill_ms": r0["prefill_ms"], "decode_ms": r0["decode_ms"],
            "host_s": r0["host_s"],
            "logit_err": max(e for e, _ in r0["step_errs"]),
            "tokens_checked": r0["tokens_checked"]}
    log(f"[serve-mesh] {wall:.1f} s of spawned program")
    return summary


# ---------------------------------------------------------------------------
# phases 19 and 20: the examples (a spawned process, on the card and the
# CPU) and the dry run of the production mesh (a spawned process, on no
# device), both beside phase 3's host set-up
# ---------------------------------------------------------------------------

def spawned(worker, name: str, timeout_s: float):
    """Run ``worker(path)`` in a spawned process of its own (``path`` a
    fresh temporary directory; its lines go to ``log.txt`` there, its
    result to ``out.pkl``).  Returns (the result, its log lines, wall
    seconds); fails, with the log's tail, unless it exits 0 in time."""
    import multiprocessing
    import pickle
    import tempfile
    with tempfile.TemporaryDirectory(prefix=f"{name}-") as tmp:
        d = Path(tmp)
        proc = multiprocessing.get_context("spawn").Process(
            target=worker, args=(tmp,), daemon=True)
        t0 = time.perf_counter()
        proc.start()
        proc.join(timeout_s)
        wall = time.perf_counter() - t0
        if proc.is_alive():
            proc.terminate()
            proc.join()
        lines = ((d / "log.txt").read_text().splitlines()
                 if (d / "log.txt").exists() else [])
        if proc.exitcode != 0 or not (d / "out.pkl").exists():
            for line in lines[-40:]:
                log(f"[{name}] | {line}")
            fail(f"the {name} process exited {proc.exitcode} after "
                 f"{wall:.1f} s (limit {timeout_s} s)")
        with open(d / "out.pkl", "rb") as f:
            return pickle.load(f), lines, wall


def worker_log(path):
    """A spawned phase's own stdout and stderr: ``log.txt`` in ``path``."""
    sys.stdout = sys.stderr = open(Path(path) / "log.txt", "w", buffering=1)


def write_result(path, out) -> None:
    import pickle
    d = Path(path)
    with open(d / "out.tmp", "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    (d / "out.tmp").rename(d / "out.pkl")


def host_tree(x):
    """A returned tree with its tensors as numpy arrays."""
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_tree(v) for v in x)
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return x


def examples_worker(path):
    """Phase 19's process: each example of ``EXAMPLES`` through its
    ``main`` at the reference's defaults on the card, then those of
    ``EXAMPLES_CPU`` again with ``--device cpu``; pickles each returned
    dict (tensors as arrays) with its seconds."""
    worker_log(path)
    import importlib.util
    import torch
    torch.set_num_threads(EXAMPLES_CPU_THREADS)
    out = {}
    runs = [(n, []) for n in EXAMPLES] + [(n, ["--device", "cpu"])
                                          for n in EXAMPLES_CPU]
    for name, argv in runs:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        key = name + (" cpu" if argv else "")
        print(f"== {key}", flush=True)
        t0 = time.perf_counter()
        got = mod.main(argv)
        if not argv:
            torch.cuda.synchronize()
        out[key] = {"result": host_tree(got),
                    "seconds": time.perf_counter() - t0}
    write_result(path, out)


def integer_leaves(np, tree, path=()) -> dict:
    """{path: value} of every integer a returned tree holds: ints, lists
    of ints and integer arrays (as tuples)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(integer_leaves(np, v, path + (k,)))
    elif isinstance(tree, (bool, int, np.integer)):
        out[path] = int(tree)
    elif isinstance(tree, list) and all(isinstance(v, (int, np.integer))
                                        for v in tree):
        out[path] = tuple(int(v) for v in tree)
    elif isinstance(tree, np.ndarray) and tree.dtype.kind in "iub":
        out[path] = (tree.shape, tree.tobytes())
    return out


def examples_path():
    """Phase 19 (see EXAMPLES' comment): the examples' process and its
    gates: card and CPU equal in every integer of the graph examples
    (counts, supersteps, rounds, labels), train_lm's losses finite and
    falling, serve_lm's tokens of the expected shape; ``[examples]``
    lines."""
    import numpy as np
    out, _, wall = spawned(examples_worker, "examples", EXAMPLES_TIMEOUT_S)
    summary = {"wall_s": wall,
               "seconds": {k: v["seconds"] for k, v in out.items()}}
    for name in EXAMPLES_CPU:
        card = integer_leaves(np, out[name]["result"])
        cpu = integer_leaves(np, out[name + " cpu"]["result"])
        bad = sorted(k for k in set(card) | set(cpu)
                     if card.get(k) != cpu.get(k))
        if bad or not card:
            fail(f"[examples] {name}: card and CPU differ at {bad[:8]}")
        counts = {"/".join(map(str, k)): v for k, v in card.items()
                  if isinstance(v, int)}
        summary[name] = counts
        log(f"[examples] {name} (default scale) on the card in "
            f"{out[name]['seconds']:.3f} s, on the CPU in "
            f"{out[name + ' cpu']['seconds']:.3f} s: equal in all "
            f"{len(card)} integer results (counts, supersteps, rounds, "
            f"per-worker loads, labels): {json.dumps(counts)}")
    pr = out["graph_analytics"]["result"]["pagerank"]["state"]
    pr_cpu = out["graph_analytics cpu"]["result"]["pagerank"]["state"]
    w = [out[k]["result"]["msf"]["weight"]
         for k in ("graph_analytics", "graph_analytics cpu")]
    summary["pagerank_rel"] = float(np.abs(pr - pr_cpu).max()
                                    / np.abs(pr_cpu).max())
    log(f"[examples] graph_analytics: PageRank card against CPU "
        f"{summary['pagerank_rel']:.3g} of the max; MSF weight {w[0]!r} "
        f"on the card, {w[1]!r} on the CPU")
    toks = out["serve_lm"]["result"]
    for arch, t in toks.items():
        if tuple(t.shape) != (4, 16):
            fail(f"[examples] serve_lm {arch}: tokens of shape "
                 f"{tuple(t.shape)}, expected (4, 16)")
    log(f"[examples] serve_lm on the card in "
        f"{out['serve_lm']['seconds']:.3f} s: {', '.join(toks)} (reduced) "
        "each 4 x 16 tokens, finite logits")
    losses = out["train_lm"]["result"]["losses"]
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"[examples] train_lm: losses {losses[:3]} ... {losses[-3:]} "
             "must stay finite and fall")
    summary["train_lm"] = {"steps": len(losses), "first": losses[0],
                           "last": losses[-1], "min": min(losses)}
    log(f"[examples] train_lm (tinyllama_1_1b reduced, batch 8 x 128) on "
        f"the card: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps (min {min(losses):.4f}) in "
        f"{out['train_lm']['seconds']:.3f} s")
    log(f"[examples] {wall:.1f} s of spawned program")
    return summary


def dryrun_worker(path):
    """Phase 20's process, on no device: ``lower_cell`` of DRYRUN_ARCHS x
    every shape on both production meshes; the (2, 2) ranks' runs
    (``mesh_rank_archs``) at float32 in a fake world of MESH_RANKS; phase
    16's TinyLlama step on the (1, 1) mesh.  Pickles the artifacts."""
    worker_log(path)
    import torch
    from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    out = {"cells": [], "mesh_runs": {}}
    for multi_pod in (False, True):
        for arch in DRYRUN_ARCHS:
            for shape in SHAPES:
                art = dryrun.lower_cell(arch, shape, multi_pod)
                art.pop("flops_by_op", None)
                out["cells"].append(art)
                print(art["arch"], art["shape"], art["mesh"], art["status"],
                      flush=True)
    for cfg, step_cfg, B, S, placements in mesh_rank_archs():
        for placement in placements:
            flags = {} if placement == "tp" else {placement: True}
            with dryrun.fake_world(MESH_RANKS):
                mesh = meshlib.make_mesh(MESH_RANK_SHAPE, ("data", "model"))
                art = dryrun.run_cell(cfg, ShapeConfig("mesh", S, B, "train"),
                                      mesh, dtype=torch.float32,
                                      step_cfg=step_cfg, **flags)
            out["mesh_runs"][f"{cfg.name} {placement}"] = art
    with dryrun.fake_world(1):
        mesh = meshlib.make_mesh((1, 1), ("data", "model"))
        out["phase16"] = dryrun.run_cell(
            get_config(TRAIN_ARCH),
            ShapeConfig("phase16", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
            dtype=torch.float32)
    write_result(path, out)


def kinds_text(coll) -> str:
    return ", ".join(f"{k} {v['count']} x {v['bytes']} B"
                     for k, v in coll.items() if v["count"] and k != "total")


def dryrun_path():
    """Phase 20's process and its lines (see DRYRUN_ARCHS' comment): one
    ``[dryrun]`` line a cell.  Returns its artifacts for ``dryrun_gates``,
    which waits for the (2, 2) ranks."""
    out, _, wall = spawned(dryrun_worker, "dryrun", DRYRUN_TIMEOUT_S)
    for art in out["cells"]:
        name = f"{art['arch']}.{art['shape']}.{art['mesh']}"
        if art["status"] != "ok":
            log(f"[dryrun] {name}: {art['status']} ({art['reason']})")
            continue
        r, ma = art["roofline"], art["memory_analysis"]
        log(f"[dryrun] {name}: {r['dominant']}-bound, compute "
            f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s (unfused "
            f"upper bound), collective {r['collective_s']:.4g} s; "
            f"{art['flops_per_chip']:.6g} FLOPs a chip (useful "
            f"{r['useful_ratio']:.4f}), arguments "
            f"{ma['argument_size_in_bytes'] / 1e9:.3f} GB a chip, temp "
            f"{ma['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
            f"{kinds_text(art['collectives'])}; roofline fraction "
            f"{r['roofline_fraction']:.4f} ({art['timing']['run_s']:.1f} s "
            "on meta)")
    ok = sum(a["status"] == "ok" for a in out["cells"])
    log(f"[dryrun] {ok} cells ok, {len(out['cells']) - ok} skipped, on the "
        f"16 x 16 and 2 x 16 x 16 meshes (H100 SXM published rates: "
        f"{HBM_BW / 1e12:.2f} TB/s, 989.4 TFLOP/s bfloat16, 50 GB/s a "
        f"GPU across nodes); {wall:.1f} s of spawned program")
    return {"wall_s": wall, "out": out}


def dryrun_gates(dry, mesh_ranks):
    """Phase 20's gates against phase 17's (2, 2) ranks of this call:
    (1) each run's dry-run bytes of params and optimizer state a rank
    equal, byte for byte, what every rank held placed and after its step
    (``[mesh-zero]``); (2) the dry run's recorded collectives (kind,
    bytes, operand shapes and dtypes, group size, in order) equal rank
    0's record of the same step.  Then phase 16's shape: the dry run's
    FLOPs beside ``train_products``."""
    from repro_torch.configs.base import get_config
    out = dry["out"]
    figures = {}
    for key, art in out["mesh_runs"].items():
        args = art["memory_analysis"]["arguments"]
        want = {"params": args["params"], "opt": args["opt"]}
        ran = mesh_ranks["runs"][key]
        for when in ("placed", "bytes"):
            for rank, got in enumerate(ran[when]):
                if got != want:
                    fail(f"[dryrun] gate 1, {key}: rank {rank} held {got} "
                         f"bytes ({when}), the dry run places {want}")
        rec = mesh_ranks["collectives"][key]
        if art["ops"] != rec:
            diff = next((i for i, (a, b) in enumerate(zip(art["ops"], rec))
                         if a != b), min(len(art["ops"]), len(rec)))
            fail(f"[dryrun] gate 2, {key}: the dry run records "
                 f"{len(art['ops'])} collectives, rank 0 {len(rec)}; first "
                 f"difference at {diff}: "
                 f"{art['ops'][diff] if diff < len(art['ops']) else None} "
                 f"against {rec[diff] if diff < len(rec) else None}")
        figures[key] = {"params": want["params"], "opt": want["opt"],
                        "collectives": art["collectives"]}
        log(f"[dryrun] gate 1 and 2, {key} on the {MESH_RANK_SHAPE} mesh "
            f"(float32, fake world of {MESH_RANKS}): params "
            f"{want['params']} B and optimizer state {want['opt']} B a "
            f"rank, equal to every rank's [mesh-zero] bytes placed and "
            f"after its step; {len(rec)} collectives equal to rank 0's "
            f"record call for call ({kinds_text(art['collectives'])}); "
            f"{art['flops_per_chip']:.6g} FLOPs a rank")
    p16 = out["phase16"]
    prods = train_products(get_config(TRAIN_ARCH), TRAIN_BATCH, TRAIN_SEQ,
                           remat=True)
    flops = p16["flops_per_chip"]
    by_op = ", ".join(f"{k} {v:.6g}" for k, v in sorted(
        p16["flops_by_op"].items()))
    log(f"[dryrun] {TRAIN_ARCH} at phase 16's shape (B={TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, float32, remat full; the (1, 1) mesh): "
        f"{flops:.6g} FLOPs on meta ({by_op}) beside train_products: dense "
        f"{prods['dense']:.6g}, attention forward {prods['attn_fwd']:.6g}, "
        f"attention backward {prods['attn_bwd']:.6g}, total "
        f"{prods['total']:.6g}; beyond the dense products the dry run "
        f"counts {flops - prods['dense']:.6g} against the kernel path's "
        f"{prods['attn_fwd'] + prods['attn_bwd']:.6g} (the dry run takes "
        f"the plain attention: every key up to each query chunk's end); "
        f"ratio {flops / prods['total']:.4f}")
    return {"mesh_runs": figures, "phase16_flops": flops,
            "phase16_products": prods, "wall_s": dry["wall_s"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4_000_000,
                    help="vertices of the powerlaw graph")
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20,
                    help="launches per kernel timing")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs the port on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.core import plan as planlib
    from repro_torch.graph import generators as gen
    from repro_torch.graph import structs
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_blocks_ref as ref_fn)

    phases = Phases()
    dev = torch.device("cuda")
    log(f"[device] {card_line()}")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind} x{count}")
    phases.run("build", build_kernels)
    rand_err = phases.run("kernel-vs-plain", random_cases, torch, np,
                          kernel, ref_fn, dev, args.seed)
    phases.run("half-remap", half_remap_case, torch, np, planlib, kernel,
               dev)
    half_times = phases.run("half-timing", half_timing, torch, kernel,
                            ref_fn, dev)
    vec_err = phases.run("vec-kernel-vs-plain", random_vec_cases, torch, np,
                         kernel, ref_fn, dev, args.seed)
    wc_row = phases.run("worker-count-vs-plain", worker_count_cases, torch,
                        np, dev, args.n, args.workers, args.iters)
    # the comparisons' float64 buffers leave the allocator's cache: the
    # spawned ranks below share the card
    torch.cuda.empty_cache()
    # four threads run spawns in processes of their own beside phase 3's
    # host-only graph build and partition, waited for before any timed
    # device work: the launchers of phases 10 and 11; phases 14, 17's
    # (2, 2) ranks and 18 (the expert-parallel and training-mesh ranks);
    # phase 19 (the examples); phase 20 (the dry run, on no device)
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=4)
    launchers_runs = [pool.submit(lambda: {
        "shard_check": phases.run("shard-check", shard_check_path),
        "dist_smoke": phases.run("dist-smoke", dist_smoke_path)}),
        pool.submit(lambda: {
            "moe_ep": phases.run("moe-ep", moe_ep_path, args.seed),
            "mesh_ranks": phases.run("mesh-ranks", mesh_ranks_path,
                                     args.seed),
            "serve_mesh": phases.run("serve-mesh", serve_mesh_path,
                                     args.seed)}),
        pool.submit(lambda: {"examples": phases.run("examples",
                                                    examples_path)}),
        pool.submit(lambda: {"dryrun": phases.run("dryrun", dryrun_path)})]

    def launchers_wait():
        return {k: v for run in launchers_runs
                for k, v in run.result().items()}
    # phase 3c's ranks and phase 9's spawned ranks (card work that is not
    # timed) run side by side, each from a thread of its own, beside the
    # host-only oracles of phase 3, and are both waited for at the end of
    # that window
    side = ThreadPoolExecutor(max_workers=2)
    beside_runs = {}

    def beside_3c():
        for name, fn in (("sharded-D", sharded_many),
                         ("service-ranks", service_ranks_run)):
            beside_runs[name] = side.submit(phases.run, name, fn, torch,
                                            args)
        return lambda: [beside_runs[n].result() for n in beside_runs]
    mods = (api, structs, gen, cost_model, planlib, kernel)
    # phase 3b's split partition and its plans (host work) in a process
    # of their own from phase 3's oracles on, through the S-V check and
    # phase 3b's first runs
    split_run = []
    g, A, pg, (launches, wc_main), algos, runs, rr_algos = main_path(
        torch, np, mods, args, dev, phases, ready=launchers_wait,
        beside=beside_3c,
        host_side=lambda g, pg: split_run.append(phases.run(
            "split-partition-start", start_split_partition, np, planlib, g,
            pg, dev)))
    launchers = launchers_wait()
    pool.shutdown()
    mesh_ops = launchers["mesh_ranks"].pop("collectives")
    examples = launchers.pop("examples")
    dryrun = phases.run("dryrun-gates", dryrun_gates,
                        launchers.pop("dryrun"),
                        dict(launchers["mesh_ranks"], collectives=mesh_ops))
    phases.run("sv-2^24", large_ids, torch, np, api, structs, kernel, dev)
    sharded_row = sharded_one(torch, np, mods, pg, runs, algos + rr_algos,
                              ref_fn, dev, phases)
    # the balance lines (host tables only) run before phase 3b's timed runs
    from repro_torch.core import exec as exec_mod
    balance = {}
    mode_launches, replays, pgs = sharded_modes(
        torch, np, mods, g, pg, runs, algos + rr_algos, ref_fn, dev, phases,
        split_run[0],
        host_work=lambda pgs: balance.update(phases.run(
            "balance", balance_lines, np, exec_mod, pg, pgs,
            planlib.default_nb(dev))))
    del runs
    torch.cuda.empty_cache()
    sharded_row.update(modes=mode_launches, replay_split=replays["split"],
                       replay_pipeline=replays["pipeline"], balance=balance)
    summary_3c = beside_runs["sharded-D"].result()
    (vec_launches, gcn_peak, inputs, params0, gcn_runs, gcn_ms,
     gcn_added, gcn_oracles) = gcn_path(torch, np, args, dev, phases, g, A,
                                        pg)
    del g, A
    sharded_vec = sharded_gcn(torch, np, mods, pg, pgs, params0, gcn_runs,
                              gcn_ms, gcn_added, vec_launches, dev, phases)
    sharded_vec["ranks"] = [r for r in summary_3c if r["algo"] == "gcn"]
    drill = phases.run("preemption-drill", preemption_drill, torch, np, pg,
                       params0, gcn_runs[0], gcn_runs[1], vec_launches)
    del pgs, params0, gcn_runs
    torch.cuda.empty_cache()
    phases.run("parity-200k", parity_small, torch, np, args, dev, phases)
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    plans = {k: planlib.get_plan(pg, k) for k in ("eg", "mir", "all")}
    kinds = {(p.n_rows, p.eb): k for k, p in plans.items()}
    if len(kinds) != len(plans):
        fail(f"two plans share a launch shape: {kinds}")
    rows = phases.run("kernel-timing", algo_launches, torch, kernel, ref_fn,
                      eng, pg, algos, kinds)
    if sum(r["launches"] for r in rows) != launches:
        fail(f"{sum(r['launches'] for r in rows)} scalar launches timed, "
             f"{launches} in the counted algorithm runs")
    vec_rows = phases.run("vec-kernel-timing", gcn_launches, torch, planlib,
                          kernel, ref_fn, pg, inputs)
    del inputs
    timed_launches = sum(r["launches"] for r in vec_rows)
    if timed_launches != vec_launches:
        fail(f"{timed_launches} vector launches timed, {vec_launches} in the "
             "counted GCN run")
    del eng, pg, plans, kinds
    torch.cuda.empty_cache()
    serve_entries = serve_path(torch, np, args, dev, phases)
    gemma = gemma_path(torch, np, args, dev, phases)
    olmoe = olmoe_path(torch, np, args, dev, phases)
    whisper = whisper_path(torch, np, args, dev, phases)
    train = train_path(torch, np, args, dev, phases)
    phases.run("gcn-oracles-wait", gcn_oracles.finish)
    service = service_path(torch, np, args, dev, phases,
                           beside_runs["service-ranks"].result())
    side.shutdown()
    flash = serve_entries[0]
    for r in flash["per_launch"]:
        r["model"] = LM_ARCH
    flash["launches_by_model"] = {LM_ARCH: flash["launches"],
                                  GEMMA_ARCH: gemma["launches"],
                                  OLMOE_ARCH: olmoe["launches"],
                                  WHISPER_ARCH: whisper["launches"],
                                  f"{TRAIN_ARCH} train": train["launches"],
                                  f"{TRAIN_ARCH} mesh train":
                                  train["mesh"]["launches"]}
    flash["launches"] += (gemma["launches"] + olmoe["launches"]
                          + whisper["launches"] + train["launches"]
                          + train["mesh"]["launches"])
    flash["per_launch"] += gemma["rows"] + olmoe["rows"] + whisper["rows"]
    # phase 18's launches, each rank's, beside the count
    mesh_serve = launchers["serve_mesh"]
    for i, e in enumerate(serve_entries[:2]):
        e["launches_mesh_serve"] = {
            arch: [n[i] for n in mesh_serve[arch]["launches_per_rank"]]
            for arch, _ in SERVE_MESH_ARCHS}
    # the (2, 2) training ranks' flash launches, each rank's, beside them
    flash["launches_mesh_train"] = {
        key: run["launches"]
        for key, run in launchers["mesh_ranks"]["runs"].items()}
    flash["max_abs_err"] = max(
        [flash["max_abs_err"]]
        + [r["max_abs_err"]
           for r in gemma["rows"] + olmoe["rows"] + whisper["rows"]])
    flash["timed"] = (f"ms, plain_ms, bound_ms and library_ms sum the "
                      f"{LM_ARCH} prefill's {flash['launches_by_model'][LM_ARCH]}"
                      f" launches; {GEMMA_ARCH}: its first window and first "
                      f"global layer's launches, {OLMOE_ARCH}: its layer 0's "
                      f"launch, {WHISPER_ARCH}: layer 0's encoder, decoder "
                      "self, prefill cross and decode cross launches "
                      f"(per_launch rows); {TRAIN_ARCH} train: the "
                      f"{TRAIN_STEPS} timed steps' launches (untimed one by "
                      "one; the step's time is in its summary); "
                      f"{TRAIN_ARCH} mesh train: phase 17's {MESH_STEPS} "
                      "timed steps' launches on the (1, 1) mesh (likewise)")
    flash[GEMMA_ARCH] = {k: gemma[k] for k in ("prefill_ms", "decode_ms",
                                               "busy_ms", "peak_gib")}
    flash[OLMOE_ARCH] = {k: olmoe[k] for k in (
        "prefill_ms", "prefill_bound_ms", "decode_ms", "decode_bound_ms",
        "busy_ms", "peak_gib")}
    flash[f"{TRAIN_ARCH} train"] = train
    flash[WHISPER_ARCH] = {k: whisper[k] for k in (
        "launches_prefill", "launches_decode", "prefill_ms",
        "prefill_bound_ms", "decode_ms", "decode_bound_ms", "busy_ms",
        "decode_busy_ms", "tokens_per_s", "peak_gib")}
    import resource
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[device] peak device memory of the GCN path "
        f"{gcn_peak / 2**30:.2f} GiB, of the later phases "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; peak host RSS "
        f"{host_gib:.2f} GiB; phases {json.dumps(phases.seconds)}")
    # every launch of the counted algorithm runs
    entry = add_ratios({
        "name": "segment_combine_blocks", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max([rand_err] + [r["max_abs_err"] for r in rows]),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in rows),
        "per_launch": rows,
        "sharded": sharded_row,
    })
    # every launch of the counted GCN runs: GCN_EPOCHS epochs of 4 joins on
    # one device (the timed rows), then the sharded runs of phase 3b and
    # rank 0's of phase 3c
    sharded_launches = (
        sum(v["launches"] for k, v in sharded_vec.items()
            if isinstance(v, dict) and "epochs" in v)
        + sum(r["launches"] for r in sharded_vec["ranks"]))
    vec_entry = add_ratios({
        "name": "segment_combine_blocks_vec", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": VEC_KERNEL_REPLACES,
        "launches": vec_launches + sharded_launches,
        "max_abs_err": max([vec_err] + [r["max_abs_err"] for r in vec_rows]),
        "ms": sum(r["ms"] for r in vec_rows),
        "plain_ms": sum(r["plain_ms"] for r in vec_rows),
        "bound_ms": sum(r["bound_ms"] for r in vec_rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in vec_rows) else "operations"),
        "library_ms": sum(r["library_ms"] for r in vec_rows),
        "epochs": GCN_EPOCHS,
        "launches_one_device": vec_launches,
        "launches_sharded": sharded_launches,
        "per_launch": vec_rows,
        "sharded": sharded_vec,
    })
    # the launchers' rank 0 and the drill (phases 10-12)
    entry["launches_main_path"] = launches
    entry["payload_types"] = {k: v for k, v in half_times.items()
                              if k.startswith("scalar")}
    vec_entry["payload_types"] = {k: v for k, v in half_times.items()
                                  if k.startswith("vector")}
    entry["launches_launchers"] = {
        "shard_check_rank0": launchers["shard_check"]["scalar"],
        "dist_smoke_rank0": launchers["dist_smoke"]["scalar"]}
    entry["launches"] += sum(entry["launches_launchers"].values())
    vec_entry["launches_drill"] = drill["vector"]
    vec_entry["launches_shard_check_rank0"] = launchers["shard_check"][
        "vector"]
    vec_entry["launches"] += drill["vector"] + launchers["shard_check"][
        "vector"]
    vec_entry["drill"] = {k: drill[k] for k in (
        "save_ms", "restore_ms", "disk_bytes", "max_abs", "outside",
        "leaf_rel", "replay_max_abs", "replay_outside", "replay_leaf_rel")}
    log(f"[kernel] segment_combine_blocks: {launches} launches in the "
        f"algorithm runs: kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, library {entry['library_ms']:.3f}, bound "
        f"{entry['bound_ms']:.3f}; {ratio_text(entry)}")
    E = GCN_EPOCHS
    log(f"[kernel] segment_combine_blocks_vec: {vec_launches} launches in "
        f"{E} epochs on one device (and {sharded_launches} in the sharded "
        f"runs): kernel {vec_entry['ms']:.3f} ms ({vec_entry['ms'] / E:.3f}"
        f" an epoch), plain {vec_entry['plain_ms']:.3f} "
        f"({vec_entry['plain_ms'] / E:.3f}), library "
        f"{vec_entry['library_ms']:.3f} ({vec_entry['library_ms'] / E:.3f}), "
        f"bound {vec_entry['bound_ms']:.3f} ({vec_entry['bound_ms'] / E:.3f})"
        f"; {ratio_text(vec_entry)}")
    # every launch in this process: phase 2's cases and timings, phase 3's
    # runs (and its dense, profiled and sharded runs, the GCN's counts)
    from repro_torch.kernels.worker_count import kernel as wc
    wc_entry = {
        "name": "worker_count", "route": "cuda", "source": WC_SOURCE,
        "replaces": WC_REPLACES, "launches": wc.launches(),
        "launches_main_path": wc_main, "max_abs_err": 0,
        "ms": wc_row["ms"], "plain_ms": wc_row["plain_ms"],
        "bound_ms": wc_row["bound_ms"], "bound_by": "bytes",
        "library_ms": wc_row["library_ms"], "per_launch": [wc_row]}
    log(f"[kernel] worker_count: {wc_main} launches in the algorithm runs "
        f"({wc_entry['launches']} in this process): kernel "
        f"{wc_entry['ms']:.3f} ms, plain {wc_entry['plain_ms']:.3f}, "
        f"library {wc_entry['library_ms']:.3f}, bound "
        f"{wc_entry['bound_ms']:.3f} at the per_worker_basic shape")
    log(f"[service] summary {json.dumps(service)}")
    log(f"[launchers] summary {json.dumps(launchers)}")
    log(f"[moe] summary {json.dumps(olmoe['moe'])}")
    log(f"[mesh-train] summary {json.dumps(train['mesh'])}")
    log(f"[serve-mesh] summary {json.dumps(mesh_serve)}")
    log(f"[examples] summary {json.dumps(examples)}")
    log(f"[dryrun] summary {json.dumps(dryrun)}")
    log(json.dumps({"kernels": [entry, vec_entry, wc_entry]
                    + serve_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
