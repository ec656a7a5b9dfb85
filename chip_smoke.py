#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--out FILE.json] [--profile] [--spans-only]
                          [--ghost-pull-only] [--spmm-sparse-only]

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit (``nvcc``). It builds the port's three kernels from
the sources in the checkout (the block-sparse SpMM, the WKV6 recurrence and
flash attention, one ``nvcc`` each, all at once), holds each against its
plain PyTorch version on the card, and drives the port's main paths with
random weights from a seed:

* GCN serving: the pubmed configuration at the paper's widths (19,717
  nodes, 500 features, 3 classes, GraphSAGE 256/128, max degree 32, 25%
  node headroom: capacity 24,647 rows) through ``ServedModel`` →
  ``QueryEngine`` → ``LoadGenerator`` (the SpMM kernel; each (body,
  bucket) a CUDA graph, replayed);
* LM serving: ``rwkv6-1.6b`` and ``gemma3-12b`` at full width (24 and 48
  layers, bf16), Griffin's ``recurrentgemma-2b`` whole (26 layers) and the
  MoE ``dbrx-132b`` at full width with 2 of its 40 layers, through
  ``launch.serve_lm_cli.serve``: a prefill of 4 x 2,048 prompt tokens,
  then 32 greedy tokens (WKV6 and flash attention); ``whisper-large-v3``
  whole (32 encoder layers over 1,500 frames, 32 decoder layers with cross
  attention, a 224-token decoder prompt) and ``internvl2-2b`` whole (256
  image tokens before the 2,048-token prompt), the same way (flash
  attention with Sq != Sk for the cross attention);
* FedAIS training: the same pubmed graph over 10 clients (Dirichlet alpha
  0.5: n_max 4,370, g_max 12,374), 5 a round, J = 4 local epochs, batch
  256, fanout 10, GraphSAGE 256/128, 3 rounds through
  ``api.FedEngine(g, fed, "fedais", ...).run()`` with the ``spmm``
  training and eval backends (the SpMM kernel forward and, transposed,
  backward);
* the method space: each of the paper's nine methods (FedAIS, its
  ablations and the five baselines, FedSage+'s generator and FedGraph's
  fanout bandit included), FedAIS under the async scheduler (full quorum
  and heterogeneous) and under the bf16 and int8 sync wire, on the same
  partition and the same entry point;
* the fused executor (the default wherever every component is fusable,
  as for ``fedais``): one round captured as a CUDA graph per graph key and
  replayed each round, the SpMM inside the graph; against the stepwise
  executor, and under a fault plan (``fused_faulty``, and async);
* the deployment path: train → ``save_federation`` (the msgpack
  checkpoint) → ``ServedModel.restore`` → ``QueryEngine`` → traffic,
  through ``launch.serve_fed``, on the training configuration, and the
  chaos harness ``launch.fed_chaos --quick``;
* the multi-device executors: ``FedEngine(..., mesh=...)`` on a one-rank
  NCCL group (the card is the whole world), the client-sharded and the
  pod-sharded round, each a CUDA graph per key with its collectives
  inside, on the training configuration;
* the examples: ``examples.quickstart`` (FedAIS against FedAll) and
  ``examples.variance_analysis`` (Eq. 3-5 and Eq. 7), their aggregation
  on the SpMM kernel;
* LM training: ``internvl2-2b`` whole through ``models.lm.make_train_step``
  (flash attention's forward and its two backward kernels), ``rwkv6-1.6b``
  whole the same way (the WKV6 forward saving its stage states, and the
  WKV6 backward), mini through ``launch.train`` (``train``,
  ``train_federated``) and ``examples.train_lm_federated``, rwkv6-1.6b's
  smoke configuration through ``launch.train``.

Phases, one or more lines each:
  1 device      the card (nvidia-smi name and power limit), torch and CUDA
                versions, the fp32 matmul flags (set to full fp32);
  2 build       nvcc time and the ptxas register report; from the built
                flash library (cuobjdump, so a cached build is read too),
                the bf16 forward's three instances spill nothing, the
                tensor-core backward's four (dq and dk/dv at hd 64 and 128)
                have no spill load or store among their HGMMA, and its SASS
                holds HGMMA (wgmma) instructions, counted; the fp32
                tensor-core backward's six (``x3``: dq and dk/dv at hd 64,
                128 and 256) exist with 0 B of stack and local memory,
                their registers recorded; each of
                the 18 wkv6 forward instances', the 6 wkv6 backward
                instances' (3 head sizes x 2 types) and the 8 SpMM
                instances' registers, and none spills;
  3 kernels     the SpMM against its plain version at the serving path's
                shapes, a ragged one, one with two windows of mask columns
                and two column slabs, a dense one and an all-dead one
                (atol = rtol = 1e-5, finite inputs), a second launch bit for
                bit equal to the first, with its time, the plain version's,
                the library call's and the bound (2·D operations per
                nonzero of A); every split ``block_spmm`` did not pick is
                checked the same way and timed; a NaN row of X reaches
                exactly the rows of A that name it; then the training
                path's shapes (a client's loss pass, a batch step at 500 and
                256 columns, and the backward's transposed launch Aᵀ @ dy),
                and the backward through autograd against autograd of the
                plain version (1e-5); then the batch step at all n_max rows
                (the methods that train on every local node) @ 500 and @
                256, its transposed launch, and the time of the
                ``a.t().contiguous()`` copy in front of it (recorded);
  4 serve       warm fill + warmup + a few hundred ids under both policies;
                historical and fresh logits agree at 1e-4;
  5 traffic     a closed-loop LoadGenerator run (200 queries, 20 updates,
                90/10 historical/fresh, Zipf ids): p50, p99, queries/s;
                no fallback, and the SpMM launch count moved;
  6 check       the served logits against the port's eval path on the card
                and against the port's plain path on the CPU (1e-4); then,
                on the graph the traffic mutated, one more edge insert and a
                refresh, and the refreshed rows' historical logits against
                their fresh logits and the plain CPU path on that graph;
                with one feature row poisoned (NaN), the fresh fallbacks
                count the same chunks under gather, segment and spmm on the
                card and spmm on the CPU;
  7 lm-kernels  WKV6 and flash attention against their plain versions at
                the LM prefill's shapes and at a ragged shape each, in fp32
                (1e-5 / 2e-5, the reference's tolerances) and in bf16 (rtol
                2^-7, one bf16 ulp; atol 1e-4, or 1e-2 for WKV6's y), with
                the kernel's time, the plain version's, SDPA's (attention
                only), the bound and the kernel's own floor; wkv6 also at
                N = 32 and 128 at the prefill's width, T = 1, one step
                past a stage of its input ring and on misaligned bases,
                and at the prefill shapes every launch (columns per
                thread, blocks per row) ``ops.CONFIG`` did not pick, each
                bit for bit equal to the chosen one;
                bf16 attention also at hd 128 (ragged S), non-causal hd 240
                and an hd that is not a multiple of 8, so each width of
                the tensor-core kernel and the FMA kernel's bf16 instance
                (the layouts TMA cannot take) are held; attention at the
                new families' shapes in bf16 and fp32: recurrentgemma-2b's
                local blocks (B 4, S 4,096, H 10, Hkv 1, hd 256, window
                2,048: the window bites) and dbrx-132b's (B 4, S 2,048, H
                48, Hkv 8, hd 128, causal); whisper-large-v3's encoder (B 4,
                S 1,500, H = Hkv = 20, hd 64, unmasked), cross attention
                (Sq 224, Sk 1,500, unmasked) and decoder (S 224, causal),
                internvl2-2b's (S 2,304, H 16, Hkv 8, hd 128, causal), and
                causal with Sq 200, Sk 333 and with Sq 333, Sk 200 under a
                window of 64 (its last rows keep no key and come out 0);
  8 lm-serve    ``serve`` for each LM: prefill ms, decode tokens/s, peak
                memory, and the launches over the prefill (24 WKV6 for
                rwkv6-1.6b, 48 flash attention for gemma3-12b, 8 for
                recurrentgemma-2b's local blocks, 2 for dbrx-132b at 2
                layers, 96 for whisper-large-v3 (32 encoder, 32 decoder
                self, 32 cross), 24 for internvl2-2b; nothing else: ``rec``
                blocks and MoE FFNs launch no kernel of the port);
  9 lm-check    at full width, block by block, each block's kernel path
                against its plain path on the same input on the card (output
                and decode state, relative L2 ``TOL_BLOCK_REL``; an MoE
                block's attention output and its output over the tokens
                both paths route alike, the tokens routed differently
                under ``MAX_REROUTED_SHARE``), and the
                whole plain-path prefill against the kernel path's, and
                beside it the plain path against itself with one bf16 ulp
                flipped in as many of the first changed block's outputs as
                the kernel path changed (both recorded: they measure how far
                the stack carries a rounding difference); the same for
                recurrentgemma-2b (``rec`` blocks, ``local`` at hd 256),
                dbrx-132b at 2 layers and arctic-480b at 1 (MoE ``attn``
                blocks; arctic's with its dense residual), whisper-large-v3
                (encoder blocks first, then each unit's cross K/V from the
                encoder's output on each path, then the decoder blocks,
                all of them on the kernel walk's encoder output) and
                internvl2-2b (zero image embeddings before the prompt); at
                the smoke configurations (fp32) of the ten archs and of
                ``mini``, the card's kernel path against the plain path on
                the CPU (prefill and 4 decode steps, 1e-4);
  10 train      ``FedEngine.run()`` twice from one seed, through the fused
                executor (rounds after a graph key's first replayed): the
                SpMM launched exactly rounds x (m·(2 + 3J) + 2) times (a
                loss pass, then J steps of 2 forward and 1 transposed
                launch per client, plus the eval's 2 layers a round) and
                the ghost pull once a gated sync epoch, counted through
                the replays, and nothing else; the same
                cohorts, tables (params, hist1, age, ghost_feat,
                prev_loss: the batches' witness), tau and test_acc bits in
                both runs; the first LocalUpdate of one client under spmm
                against gather on the card with the same draws (discrete
                outputs exact, ``loss_all`` and the first step's grads
                1e-4); ms per round, peak memory, test_acc per round;
  11 methods    on phase 10's partition, each of the nine registered
                methods for 2 rounds, ``fedais`` under ``AsyncScheduler()``
                (3 rounds, bit-identical to the sync run of the same seed,
                virtual_time = wall_clock, staleness 0), under a
                heterogeneous ``AsyncScheduler`` (quorum 3 of 5, one client
                4x slower, 4 merges: some merge stale, no fault counted)
                and with the bf16 and int8 sync wire (2 rounds each: the
                fp32 run's cohorts and tau); every run launches the SpMM
                exactly (clients dispatched) x (2 + 3J) + 2 x (merges)
                times, the ghost pull once a gated sync epoch on the fp32
                wire, and nothing else; per method what defines it
                (FedSage+ syncs nothing and its generator rides the model
                link, FedLocal pulls no ghost, FedPNS keeps tau 2,
                FedGraph's fanouts come from its bandit's actions); ms per
                round, peak memory, test_acc per round (the fusable
                methods run fused);
  12 fused      on phase 10's partition, ``fedais`` for 6 rounds with an
                eval every 2 (chunks [0], [1, 2], [3, 4], [5]) fused by
                default against ``SyncScheduler(fused=False)``: every
                history column, the final row, the params and the tables
                bit-identical; the SpMM launched exactly rounds x m x
                (2 + 3J) + evals x 2 times and the ghost pull once a gated
                sync epoch (its captured launches folded into the
                replays) through the replays, nothing else; the graph keys and their capture time; the device
                memory allocated after each chunk, no growth; each other
                fusable method's phase-11 fused run against its stepwise
                run (bit-identical); ``fedais`` under a ``FaultPlan``
                (drops, NaN corruption, stragglers) for 4 rounds:
                ``fused_faulty`` against faulty stepwise (history, tables,
                fault counters equal; a quarantine and drops counted); an
                async run under the same plan that completes, its
                counters recorded.
  13 deploy     a row's product bits among b rows against among 19,717
                (``torch.matmul`` recorded, ``row_matmul`` gated); on
                phase 10's graph and partition, ``serve_fed.
                serve_pipeline`` (fedais 3 rounds fused, spmm training)
                under ``--backend spmm``: the restored step, the file's
                leaves, params and table_age equal the trained state's
                bits; a fresh restore's served logits within 1e-4 of the
                eval path; the fused-vs-two-call gates (bit parity, fused
                p50 <= two-call p50, nothing prepared after warmup); 3
                graphs a bucket, each body's SpMM launches, the traffic's
                launches exactly its replays' sum; p50, p99, queries/s,
                capture seconds; under ``--backend gather
                --parity-check`` every node's served logits bit-identical
                to the eval path (segment's recorded); the int8 cache's
                column; ``fed_chaos --quick`` exits 0, its rows recorded;
  14 sharded    a one-rank NCCL group from a ``FileStore`` in a temporary
                directory; on phase 10's partition ``fedais`` 6 rounds, an
                eval every 2, fused, then ``sharded_fused`` on a (1,)
                client mesh (``merge_reduce`` psum and pairwise) and
                ``pod_sharded`` on a (1, 1) pod mesh (fp32, and int8 with
                the fp32 run's cohorts and tau): the executor named;
                cohorts, tau, comm, flops and wall clock exact; test_acc
                and test_loss within 1e-4 (params and tables bit-equal
                recorded); the SpMM exactly rounds x m x (2 + 3J) + evals
                x 2 through the replays, the ghost pull once a gated sync
                epoch (none on the pod mesh); each round's collectives, calls
                and bytes, those of ``sharding.ledger``; memory after each
                chunk equal from the second on; a pod run at tau0 8 whose
                gated-off rounds move no ghost byte; under
                ``FaultPlan(seed=78, dropout=0.2, straggler_frac=0.3)``
                ``sharded_fused`` against ``fused_faulty`` (discrete
                columns and ``FaultCounters`` equal, a dropped client's
                rows unchanged to the bit);
  15 examples   ``examples.quickstart --backend spmm`` (its own Pubmed at
                1/32, 16 clients, 5 a round) for 5 rounds, FedAIS and
                FedAll: finite histories, accuracies, comm bytes, tau;
                ``examples.variance_analysis --backend spmm`` on the whole
                Pubmed with 4 noise draws: the error is ~0 without
                staleness and grows with it, and importance sampling's
                Eq. 7 objective is below uniform's; each launches the
                SpMM kernel, the ghost pull once a gated sync epoch, and
                nothing else;
  16 lm-train   the flash attention backward kernels (dq, then dk/dv) and
                the forward's row log-sum-exp against their plain versions
                (``attention_bwd_ref``, ``attention_ref(return_lse=True)``)
                at the training path's shapes: internvl2-2b's (B 2, S 2,304,
                H 16/8, hd 128, causal) in bf16 and fp32, mini's, gemma3-12b's
                local block (hd 240, window 1,024) in bf16, in fp32 and in
                bf16 off TMA's 16-byte alignment, its global block (causal)
                in bf16 and fp32,
                recurrentgemma-2b's local attention (H 10/1, hd 256, window
                2,048), whisper-large-v3's cross attention and encoder,
                causal Sq != Sk both ways (rows with no live key), an hd of
                80 under a window and a ragged hd 136; lse 1e-5, fp32
                gradients 1e-4, bf16 one ulp relative and 4 x the fp32 FMA
                kernels' error on the same inputs (the widened copies off a
                16-byte boundary, so the FMA pair, asserted; the 3xTF32
                pair's error on them recorded beside); each row on the
                route it must take (the bf16 tensor-core kernels for bf16
                at any hd up to 256 in a TMA layout, the 3xTF32 kernels for
                fp32 in such a layout, the FMA kernels for the rows off a
                16-byte boundary, from the wrappers' route counts); each
                launch twice, the same bits; times against the plain
                backward, SDPA's autograd backward and the bound (fp32 at
                3xTF32's rate, the FMA pipes' beside; the 3xTF32 pair's
                floor); appended, gemma3-12b's global block in fp32 and
                internvl2-2b's fp32 shape off a 16-byte boundary (the FMA
                pair, timed). Then ROADMAP C7's probe, recorded:
                whisper_enc_bf16's shape over 16 draws of its own generator,
                the elements beyond the gate and the worst excess over atol
                per draw. The WKV6
                training forward (the kernel writing the
                state at the start of each 32-step stage) against the
                serving forward, y and S bit for bit, and the WKV6 backward
                kernel against ``wkv6_bwd_ref`` at rwkv6-1.6b's training
                shape (B 2, T 2,048, H 32, N 64) in bf16 and fp32 and with
                an incoming gradient of S, at T 2,047 and 37, at N 32 and
                128, with w 0.999 and 1e-6: fp32 1e-4; bf16 dr/dk/dv one ulp
                relative and 4 x the fp32 kernels' error on the same inputs;
                dw and du 1e-4; each launch twice, the same bits; no scratch
                beyond du's B shares; times, with and without the timer's
                device-side wait, against the plain backward and the bound
                (no library call computes it). Then
                internvl2-2b at 2 of its 24 layers, full width: loss and every
                gradient, kernel path vs plain path (relative L2 1e-2), and
                rwkv6-1.6b at 2 of its 24 layers with the model in fp32
                (relative L2 1e-4; in bf16 the loss at 1e-2 and the
                gradients recorded); then
                the main path, internvl2-2b whole (1.89 B params, bf16, AdamW
                moments fp32) for 4 steps of ``make_train_step`` on 2 x (256
                image embeddings, a seeded draw at scale 0.02, + 2,048
                ``TokenPipeline`` tokens; zero embeddings, which phase 8
                serves, make the image rows' gradient grow ~10^3 a layer:
                recorded at 8 layers): finite
                losses and grad norms, exactly 24 forward, 24 dq and 24 dk/dv
                launches a step and nothing else, every backward launch on
                the tensor-core route; first and steady step ms,
                tokens/s, peak memory. gemma3-12b at full width, 2 of its
                48 layers (both local) kernel path vs plain path as
                internvl2's, then 6 layers (one 5:1 local:global unit; one
                card cannot hold the whole model's training state) for 4
                steps on 2 x 2,048 ``TokenPipeline`` tokens: exactly 6
                forward, 6 dq and 6 dk/dv launches a step and nothing else,
                every backward launch on the tensor-core route (hd 240);
                the same records. The RWKV main path, rwkv6-1.6b whole
                (1.6 B params, bf16, AdamW moments fp32, no remat) for 4
                steps on 2 x 2,048 ``TokenPipeline`` tokens: finite losses
                and grad norms, exactly 24 WKV6 forward and 24 backward
                launches a step and nothing else, no plain WKV version
                called; first and steady step ms, tokens/s, peak memory.
                ``launch.train``'s ``train`` and
                ``train_federated`` on mini, card against CPU from the same
                params (losses 1e-4; tau, steps, syncs equal; fp32, so
                every backward launch on the 3xTF32 route);
                ``examples.train_lm_federated`` at a cut size;
                ``launch.train`` on rwkv6-1.6b's smoke configuration, card
                against CPU from the same params (losses 1e-4; exactly one
                launch of each WKV6 kernel per layer a step); an RWKV
                forward in grad mode that wants no gradient (``rwkv_chunk``
                16) launches the forward kernel alone;
 17 roofline    the dry run (``launch.dryrun --all --mesh both``, every
                arch x shape on the fake 256- and 512-rank production
                meshes, on meta tensors) in a child process, away from
                phase 14's NCCL group: its counts (66 ok, 14 skipped, 0
                errors, gated) and seconds; then each LM step the card
                timed (phase 9's steady prefills of the seven models,
                phase 16's steady train steps of internvl2-2b, gemma3-12b
                at 6 of 48 layers and rwkv6-1.6b) beside the dry run's row
                of that configuration and shape on a 1x1 mesh (another
                child): mfu = model FLOPs / (time x 989 TFLOP/s), the
                row's bound / time and its useful-FLOPs ratio (recorded);
 18 fed-dryrun  ``launch.fed_dryrun``, each run a child process, all at
                once, away from phase 14's NCCL group: on fake worlds, on
                meta tensors, pod1 and pod2 client-sharded and with 16 pods
                (the production meshes at the reference's defaults), the
                reference's two CI commands (``--assert-k-flat`` K 10^5
                against 10^4, ``--assert-quant-bytes`` at K 1,024) and K
                10^4, 10^6 and int8 at its CI widths: each exits 0, each
                round's counted collectives equal to the ledger's and the
                rank's residents to its ``per_device_resident_bytes``; then
                ``--mesh host --pods 1`` at K 10^5 on the card, one rank
                over NCCL with real tensors (~7.4 GB of hist1): its
                gate-on and gate-off rounds count what a one-rank fake-world
                meta walk at the same arguments counts (gated), each
                round's ms after a synchronise and
                ``torch.cuda.max_memory_allocated`` beside the ledger's
                resident total (recorded).
 19 spans       the span system (``repro_torch.utils.spans``) on the
                fused executor: fedais on phase 10's partition with the
                spans on, against the same run with them off (history,
                params and tables bit-equal); every keyed round (eager,
                and each replay) behind a device-side wait; beside each
                stamp a timing event (an event node in a graph) and a
                second stamp after it, which bounds the gap between the
                stamp and its event on the stamp's own clock; each
                stamp-to-stamp phase held against its event pair within
                the gaps at its two ends and ``SPANS_TOL_MS`` (the timer's
                step and the event timer's resolution), not within a
                share of the phase; every stamp of every read written, in
                order; each key's phases in the round's order (m (1 + 4J
                + open gates) + 5); the stamp kernel's launches the eager
                rounds', the captures' and the evals', twice (gated).
                ``--spans-only`` runs phases 1 and 19 alone.
 20 ghost-pull  the one-pass ghost pull kernel (``kernels/ghost_pull``) at
                Coauthor's shape (K 16, n_max 1,994, g_max 12,390, F 6,805,
                H1 256) and Pubmed's (n_max 3,423, g_max 11,560, F 500),
                ``need`` drawn at a half, all 1 and all 0, a third of the
                slots masked with owner -1: both tables bit-equal to the
                plain version on the card; at widths 1 to 6,805 with every
                base 0 to 3 elements off a 16-byte boundary, bit-equal
                (gated); the median with L2 flushed, against the bytes
                bound (each output row written once and each row that feeds
                it read once) and the plain version (recorded); a launch
                under a graph capture counts in ``captured`` and not in
                ``launches``, and its replays write the plain version's
                bits (gated); its launches on the main paths are phases
                10-15's. ``--ghost-pull-only`` runs phases 1 and 20 alone.
 21 spmm-sparse the SpMM's sparse route (``kernels/spmm/csrc/
                spmm_sparse.cu``) at Reddit's shapes (FedAIS Table 1,
                232,965 nodes, 602 features): the eval's layer-0
                aggregation (232,965 rows over 232,965 x 602), a loss pass
                (24,592 rows over 229,783 x 602) and the batch's transposed
                launch (256 rows, fanout 10, into 229,783 x 256); each
                bit-equal to its plain version on the card and to itself
                across two launches, at widths 1 to 70 and 602 with bases
                off 16 and 8 bytes too (gated); the median of 21 with L2
                flushed against the bound of
                ``bench/fedbench/work.py::launch_work`` and the plain
                version, and the same at Pubmed's and Coauthor's shapes
                (recorded; those cells take the dense route); a launch
                under capture counts 1 in ``captured`` and 0 in
                ``launches`` and its replay writes the plain bits (gated).
                Phases 10-15 launch it 0 times (gated: their graphs take
                the dense route). ``--spmm-sparse-only`` runs phases 1 and
                21 alone.
The SpMM's launch counter is set to 0 just before phase 4 and read just
after phase 5; every counter is set to 0 just before each ``serve`` of
phase 8, each ``run`` of phases 10, 11, 12 and 14 (the collective counts
too), each pipeline of phase 13 and its chaos matrix, and each example of
phase 15, and the internvl2-2b, gemma3-12b and rwkv6-1.6b training runs of
phase 16 and each of its other runs, and read just after it.
``--profile`` traces one steady internvl2-2b, gemma3-12b and rwkv6-1.6b
train step in phase 16, a
second traffic run after phase 6, one prefill + 4 decode steps of each LM
in phase 9, one steady training round replayed from its CUDA graph in phase
10 and one stepwise in phase 12 (the host's kernel and graph launches, the
device's busy share, the SpMM's kernels under the replay), one steady
stepwise round of fedall and of fedsage+ in phase 11, and a second traffic
run of phase 13's spmm pipeline (host calls per replayed chunk), and one
replayed pod-sharded round in phase 14 (graph launches, the NCCL kernels'
device time, the busy share).
Before the last line it prints a ``{"kernels": [...]}`` line (the three
forward kernels, flash attention's two backward kernels on each of their
three routes, the WKV6 backward and the ghost pull). The last
line is ``{"ok": true, "device": {...}}``. Any failure raises and the exit
code is not 0; without CUDA it prints no result and exits 2, outside a
checkout 1.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch" / "__init__.py").is_file():
    sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout of "
             "the repository")
sys.path.insert(0, str(SRC))

from repro_torch.utils import roofline  # noqa: E402

# H100 SXM published peaks (``utils/roofline.py``, from NVIDIA's data
# sheet, dense): fp32 outside the tensor cores, bf16 and TF32 on them, and
# HBM3 bandwidth. The bound of a kernel is the larger of its bytes over the
# bandwidth and its operations over the peak for their operands' type.
# fp32-accurate products also run on the tensor cores as three TF32
# products each (big.big + big.small + small.big, x = big + small):
# PEAK_TF32_FLOPS / 3, faster than the FMA pipes, so flash attention's fp32
# bounds take the faster of the two (FP32_MM_FLOPS) and keep the FMA one
# beside.
PEAK_FP32_FLOPS = roofline.PEAK_FLOPS_FP32
PEAK_BF16_FLOPS = roofline.PEAK_FLOPS_BF16
PEAK_TF32_FLOPS = roofline.PEAK_FLOPS_TF32
FP32_MM_FLOPS = max(PEAK_FP32_FLOPS, PEAK_TF32_FLOPS / 3)
PEAK_BYTES_PER_S = roofline.HBM_BW
TOL_KERNEL = 1e-5
TOL_LOGITS = 1e-4
N_IDS = 256
# LM kernels: the reference's own tolerances in fp32 (wkv6 1e-5 on y and S,
# attention 2e-5); in bf16 see _tol
TOL_WKV = 1e-5
TOL_ATTN = 2e-5
# the training path (phase 16): the forward's row log-sum-exp in fp32, and
# the per-op gradient tier of the backward kernels (ROADMAP) in fp32
TOL_LSE = 1e-5
TOL_GRAD = 1e-4
# what a WKV6 backward call may allocate beyond its outputs: du's B shares
# and the tickets (17 KB at rwkv6-1.6b's training shape), never an fp32
# scratch of dv (134 MB there)
WKV6_BWD_SCRATCH = 2**20
# bf16 outputs: both versions round an fp32 value to bf16, so they land at
# most one bf16 ulp apart (2^-7 of the value); the atol covers outputs near
# 0, where the fp32 values differ by their own rounding: about 1e-6 for
# attention, and up to 1e-2 for WKV6's y, a small sum of cancelling terms
# of up to |y| = 17
RTOL_BF16 = 2.0 ** -7
ATOL_BF16_ATTN = 1e-4
ATOL_BF16_WKV_Y = 1e-2
# full-width bf16 prefill, block by block: one block's kernel path vs its
# plain path on the same input (relative L2 error of the block's output and
# decode state). Both take fp32 sums in another order and round them to
# bf16, so an element lands one bf16 ulp (2^-8..2^-7 of it) apart now and
# then: more often where the recurrence's y is a small sum of large
# cancelling terms; the block's norms carry that on into its output
TOL_BLOCK_REL = 1e-2
# an MoE block routes each token discretely: where the attention's one-ulp
# differences move a token's router scores across a tie (or its rank across
# an expert's capacity), the two paths route it differently and its output
# differs by a whole expert's share. Such tokens are counted and must stay
# under this share of the block's tokens; the rest of the block is held at
# TOL_BLOCK_REL
MAX_REROUTED_SHARE = 1e-2
# rwkv6-1.6b at 2 layers, full width, with the model in fp32: the loss and
# every gradient through the WKV6 kernels vs the plain path (relative L2).
# Both compute one fp32 function with sums in another order: on an H100
# the worst leaf reads 1.6e-5, the median 1.2e-5 (PERF.md). In bf16 the
# same comparison is recorded, not gated: at random bf16 weights each path
# lies 12-27% from the fp32 gradient and the two 0.6-1.7% apart, so a
# wrong gradient would hide in that spread
TOL_RWKV_FP32_REL = 1e-4
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_ARCHS = ("rwkv6-1.6b", "gemma3-12b")
# the Griffin and MoE families at full width, each with the layer count one
# card holds (None: the whole model). recurrentgemma-2b runs whole (26
# layers, 2.89 B params); dbrx-132b (131.6 B) at 2 layers (7.75 B);
# arctic-480b (476.9 B) at 1 layer (14.07 B), checked block by block only
LM_FAMILIES_SERVE = (("recurrentgemma-2b", None), ("dbrx-132b", 2))
LM_FAMILIES_CHECK = (("recurrentgemma-2b", None), ("dbrx-132b", 2), ("arctic-480b", 1))
LM_FAMILIES_SMOKE = ("recurrentgemma-2b", "dbrx-132b", "arctic-480b", "deepseek-67b",
                     "llama3-405b", "nemotron-4-15b", "whisper-large-v3", "internvl2-2b")
# the encoder-decoder and the image-token model, whole, with the decoder
# prompt each takes: whisper-large-v3 (1,500 encoder frames, a 224-token
# decoder prompt: 224 + 32 within its 448-token text context) and
# internvl2-2b (256 image tokens before a 2,048-token prompt)
LM_ENC_IMG = (("whisper-large-v3", 224), ("internvl2-2b", LM_PROMPT))
# the examples (phase 15): the quickstart at its own defaults for a few
# rounds, the variance analysis on the whole Pubmed with several noise draws
EXAMPLE_ROUNDS, VARIANCE_SCALE, VARIANCE_DRAWS = 5, 1, 4
# FedAIS training: the paper's Pubmed over 10 clients, 5 a round, J = 4
TRAIN_CLIENTS, TRAIN_M, TRAIN_ROUNDS = 10, 5, 3
# the method space (phase 11): rounds per method and per quantized run, the
# full-quorum async run's rounds, the heterogeneous async run's merges and
# its slow client's factor
METHOD_ROUNDS, ASYNC_ROUNDS, HET_MERGES, HET_SLOW = 2, 3, 4, 4.0
ASYNC_PARITY_KEYS = ("test_acc", "test_loss", "tau", "comm_total", "comm_embed", "flops",
                     "wall_clock")
# the fused executor (phase 12): fedais rounds and eval cadence (chunks of
# up to 2 rounds), the fault-plan runs' rounds, and the plan: drops and
# stragglers every round, NaN corruption only at version 0 (one member of
# the first cohort), so no async merge of 3 is emptied by the guard (an
# emptied merge on an eval round stops the reference's HistoryCallback,
# ROADMAP C5)
FUSED_ROUNDS, FUSED_EVAL_EVERY, FAULT_ROUNDS = 6, 2, 4
FAULT_PLAN = dict(seed=78, dropout=0.2, corrupt=0.05, corrupt_mode="nan", straggler_frac=0.3)
FAULT_ASYNC = dict(quorum=3, concurrency=TRAIN_M, timeout_s=1.0, max_retries=1)
# the span system's check (phase 19): rounds and eval cadence; the device
# wait before each keyed round (~1 s at the H100's 1.98 GHz); and how far a
# stamp phase and its event pair may differ beyond the measured gaps
# between each end's stamp and event: the global timer's 32 ns step on
# the stamp and on the stamp after the event, and the event timer's
# ~0.5 us resolution, at each end
SPANS_ROUNDS, SPANS_EVAL_EVERY = 5, 2
SPANS_WAIT_CYCLES = 2_000_000_000
SPANS_TOL_MS = 2 * (2 * 32e-6 + 0.5e-3)
# the ghost pull's check (phase 20): each shape's K, n_max, g_max, F, H1;
# the widths and base offsets (elements off a 16-byte boundary) of the
# alignment sweep
GHOST_PULL_SHAPES = {"coauthor": (16, 1994, 12390, 6805, 256),
                     "pubmed": (16, 3423, 11560, 500, 256)}
GHOST_PULL_WIDTHS = (1, 2, 3, 4, 5, 7, 31, 64, 129, 500, 6805)
# the sparse SpMM route's check (phase 21): per shape, the rows, the table
# rows, the width, the share of live slots (max_deg 32) and whether it is
# the transposed launch; the widths of its bit sweep
SPMM_SPARSE_SHAPES = {
    "reddit_eval_l0": (232_965, 232_965, 602, 0.98, False),
    "reddit_loss_pass_l0": (24_592, 229_783, 602, 0.9, False),
    "reddit_batch_t_l1": (256, 229_783, 256, 10 / 32, True),
    "pubmed_eval_l0": (19_717, 19_717, 500, 0.9, False),
    "pubmed_loss_pass_l0": (3_423, 14_983, 500, 0.9, False),
    "pubmed_batch_t_l1": (256, 14_983, 256, 10 / 32, True),
    "coauthor_eval_l0": (18_333, 18_333, 6_805, 0.9, False),
    "coauthor_loss_pass_l0": (1_994, 14_384, 6_805, 0.9, False),
    "coauthor_batch_t_l1": (256, 14_384, 256, 10 / 32, True),
}
SPMM_SPARSE_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 31, 33, 64, 70, 256, 602)
FUSABLE = ("fedall", "fedrandom", "fedpns", "fedlocal", "fedais1", "fedais2")
# host API calls counted in a traced round
API_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch",
             "cudaMemcpyAsync", "cudaStreamSynchronize")


# the timer's device-side wait before its start event: ~1 ms at the H100's
# 1.98 GHz boost clock, several times a kernel wrapper's host call
WAIT_CYCLES = 2_000_000


def log(*parts) -> None:
    print(*parts, flush=True)


class Timer:
    """Median device time of a callable over ``reps`` launches with CUDA
    events, the 50 MB L2 flushed before each (the serving path meets its
    operands cold). Between the flush and the start event the stream waits
    on the device (``torch.cuda._sleep`` for ``WAIT_CYCLES``, ~1 ms, longer
    than a wrapper's host call), so the callable's launches are enqueued
    when the device reaches the start event and a short kernel's reading
    holds no host time; ``wait=False`` takes the reading without the wait,
    where a host call longer than the flush shows in it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int, wait: bool = True) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if wait:
                torch.cuda._sleep(WAIT_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def spmm_bound(torch, n, m, d, mask, nnz, bm, bk):
    """(bound_ms, bound_by, live_fraction): the bytes the block-sparse
    product must move over HBM bandwidth, against the fp32 FMA operations
    these inputs need (2·D per nonzero of A, ``nnz``) over the fp32 peak, for
    this run's mask. The bytes are the live A tiles, the rows of X under a
    column tile that some row tile has live (no other row of X is needed),
    Y and the mask, each once."""
    rows = torch.clamp(n - torch.arange(mask.shape[0], device=mask.device) * bm, max=bm)
    cols = torch.clamp(m - torch.arange(mask.shape[1], device=mask.device) * bk, max=bk)
    live = float((mask.double() * rows[:, None].double() * cols[None, :].double()).sum())
    x_rows = float((mask.any(0).double() * cols.double()).sum())
    frac = float(mask.double().mean()) if mask.numel() else 0.0
    nbytes = 4 * (live + x_rows * d + n * d + mask.numel())
    flops = 2.0 * nnz * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            frac)


def check_spmm(torch, ops, ref, timer, name, a, x, mask, reps):
    """One SpMM shape: kernel vs plain version on the card (finite inputs),
    the same bits from a second launch, then times. Every split
    ``block_spmm`` did not pick is checked (1e-5, and twice the same bits)
    and timed too."""
    y = ops.block_spmm(a, x, mask)
    y_again = ops.block_spmm(a, x, mask)
    want = ref.spmm_ref(a, x)
    nnz = int((a != 0).sum())
    torch.cuda.synchronize()
    if y.shape != want.shape or not torch.isfinite(y).all():
        raise AssertionError(f"spmm {name}: shape {tuple(y.shape)} or non-finite output")
    err = float((y - want).abs().max()) if y.numel() else 0.0
    if not torch.allclose(y, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
        raise AssertionError(f"spmm {name}: max abs err {err} beyond {TOL_KERNEL}")
    if not torch.equal(y, y_again):
        raise AssertionError(f"spmm {name}: a second launch gave other bits")
    n, m = a.shape
    d = x.shape[1]
    bound_ms, bound_by, frac = spmm_bound(torch, n, m, d, mask, nnz, ops.TILE_M, ops.TILE_K)
    live_tiles = int(mask.sum())
    splits = ops.split_count(n, m, d, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    row = {
        "shape": name, "n": n, "m": m, "d": d, "tile": [ops.TILE_M, ops.TILE_K],
        "splits": splits, "live_fraction": frac, "nnz": nnz,
        "nnz_per_live_tile": nnz / live_tiles if live_tiles else 0.0, "max_abs_err": err,
        "ms": timer(lambda: ops.block_spmm(a, x, mask), reps),
        "plain_ms": timer(lambda: ref.spmm_ref(a, x), reps),
        "library_ms": timer(lambda: torch.matmul(a, x), reps),
        "bound_ms": bound_ms, "bound_by": bound_by, "other_splits": {},
    }
    for s in ops.SPLITS:
        if s == splits:
            continue
        y2, y3 = ops.launch(a, x, mask, s), ops.launch(a, x, mask, s)
        if not torch.allclose(y2, want, atol=TOL_KERNEL, rtol=TOL_KERNEL):
            raise AssertionError(f"spmm {name} at {s} splits: max abs err "
                                 f"{float((y2 - want).abs().max())}")
        if not torch.equal(y2, y3):
            raise AssertionError(f"spmm {name} at {s} splits: a second launch gave "
                                 "other bits")
        row["other_splits"][s] = timer(lambda: ops.launch(a, x, mask, s), reps)
    log(f"phase 3 kernels: spmm {name} ({n} x {m}) @ ({m} x {d}) splits {splits} live "
        f"{frac:.4f} nnz {nnz} ({row['nnz_per_live_tile']:.3f} per live tile) max_abs_err "
        f"{err} kernel {row['ms']} ms plain {row['plain_ms']} ms torch.matmul "
        f"{row['library_ms']} ms bound {bound_ms} ms ({bound_by}); at other splits "
        f"{json.dumps(row['other_splits'])}")
    return row


def check_spmm_nonfinite(torch, ops, name, a, x, mask):
    """One NaN row k of X, at every split: exactly the rows of A with a
    nonzero in column k come out NaN (all of their columns), and every
    other row has the bits the finite X gives it."""
    k = int((a != 0).sum(0).argmax())
    reach = a[:, k] != 0
    xb = x.clone()
    xb[k] = float("nan")
    for s in ops.SPLITS:
        y, yb = ops.launch(a, x, mask, s), ops.launch(a, xb, mask, s)
        nan_rows = torch.isnan(yb).any(1)
        if not (torch.equal(nan_rows, reach) and torch.isnan(yb[reach]).all()
                and torch.equal(yb[~reach], y[~reach])):
            raise AssertionError(f"spmm nonfinite {name} at {s} splits: NaN rows "
                                 f"{int(nan_rows.sum())}, rows naming column {k} "
                                 f"{int(reach.sum())}")
    log(f"phase 3 kernels: spmm nonfinite {name}: a NaN row {k} of X reaches exactly "
        f"the {int(reach.sum())} rows of A that name it, at splits {list(ops.SPLITS)}; "
        "the other rows keep their bits")
    return {"shape": name, "row": k, "rows_reached": int(reach.sum())}


def wkv6_bound(torch, B, T, H, N, dtype):
    """(bound_ms, bound_by): r, k, v (dtype), w (fp32), u read once, y
    (dtype) and S (fp32) written once, over HBM bandwidth, against the
    recurrence's operations, each over the peak for its operands' type.
    Per step and row: 3N for the bonus and 2N for its product with v, 2N^2
    for r·S, N^2 for w·S and N^2 for adding k vᵀ into S, all on the fp32
    state, w or u (fp32 peak); N^2 for the product k vᵀ itself, on two
    inputs of the given dtype (bf16 peak when they are bf16)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    elems = B * T * H * N
    nbytes = 4 * elems * esz + 4 * elems + 4 * H * N + 4 * B * H * N * N
    rows = B * H * T
    kv_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops = (rows * (4.0 * N * N + 5.0 * N) / PEAK_FP32_FLOPS
             + rows * 1.0 * N * N / kv_peak)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def live_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the mask keeps, for one (batch, head): query i
    keeps keys j < Sk with, when causal, j <= i and i - j < window."""
    if not causal:
        return Sq * Sk
    w = window or max(Sq, Sk)
    return sum(max(0, min(i, Sk - 1) - max(0, i - w + 1) + 1) for i in range(Sq))


def flash_bound(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype, fp32_peak=FP32_MM_FLOPS):
    """(bound_ms, bound_by): q, k, v read once and o written once over HBM
    bandwidth, against 4·hd operations (q·k and p·v) per live pair over the
    peak for the inputs' type: bf16 inputs and output leave both products
    to the tensor cores (989 TFLOP/s), fp32 ones to ``fp32_peak`` (3×TF32
    on the tensor cores, 164.9; ``PEAK_FP32_FLOPS`` gives the FMA pipes'
    bound, 67)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd)
    flops = 4.0 * hd * B * H * live_pairs(Sq, Sk, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else fp32_peak
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_floor(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype, route):
    """The kernel's own floor (ms): the operations it executes, over the peak
    of the units that execute them, or the bound's bytes if more. It counts
    the (query, key) tile pairs the kernel computes, masked parts of the
    diagonal and edge tiles included, with hd at the kernel's padded width
    (64, 128 or 256), for the kernel ``route`` names. ``"tensor_core"``
    (bf16, flash_fwd_tc_kernel): 64-row halves of 128-row query tiles
    against 64-key tiles, a tile skipped when no pair of the half is live;
    2·hd for Q·Kᵀ and 4·hd for P·V (P as hi + lo) per pair, on the tensor
    cores. ``"tf32x3"`` (fp32, x3::flash_fwd_x3_kernel): 64-row halves of
    128-row query tiles against 32-key tiles (``X3_TILE_ROWS``), skipped as
    above; 4·hd per pair as three TF32 products, at 3×TF32's 164.9 TFLOP/s.
    ``"fma"`` (flash_fwd_kernel): 64-row tiles against 32-key tiles, 4·hd
    per pair, on the FMA pipes."""
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    bk, block, per_pair, peak = {
        "tensor_core": (64, 128, 6.0, PEAK_BF16_FLOPS),
        "tf32x3": (X3_TILE_ROWS, 128, 4.0, PEAK_TF32_FLOPS / 3),
        "fma": (32, 64, 4.0, PEAK_FP32_FLOPS)}[route]
    rows = 64
    win = window if (causal and window) else 0
    pairs = 0
    for q0 in range(0, Sq, block):
        q_last = min(q0 + block, Sq) - 1
        kt_lo, kt_hi = 0, (Sk - 1) // bk
        if causal:
            kt_hi = min(q_last, Sk - 1) // bk
            if win:
                kt_lo = max(0, q0 - win + 1) // bk
        for first in range(q0, q0 + block, rows):
            last = min(first + rows - 1, Sq - 1)
            if last < first:
                continue
            for kt in range(kt_lo, kt_hi + 1):
                k0 = kt * bk
                if causal and (k0 > last or (win and k0 + bk - 1 <= first - win)):
                    continue
                pairs += rows * bk
    t_ops = per_pair * hdp * B * H * pairs / peak
    esz = torch.tensor([], dtype=dtype).element_size()
    t_bytes = esz * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


def _tol(torch, dtype, tol32, atol_bf16):
    """(atol, rtol): fp32, the reference's tolerance for both; bf16, one
    bf16 ulp relative and ``atol_bf16`` (see ``RTOL_BF16``)."""
    return (tol32, tol32) if dtype == torch.float32 else (atol_bf16, RTOL_BF16)


def cuobjdump(build, name: str, flag: str) -> str:
    """``cuobjdump <flag>`` of the built library (the tool sits beside nvcc),
    so a cached library answers as a fresh build does."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_count(build, name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the built library's SASS."""
    return sum(1 for line in cuobjdump(build, name, "-sass").splitlines()
               if opcode in line)


def spills_among_hgmma(build, name: str, pattern: str) -> dict:
    """{function matching ``pattern`` (a regex with one group naming it):
    the local-memory loads and stores (LDL, STL: spill traffic) between its
    first and its last HGMMA} in the built library's SASS, so a spill left
    outside the tensor-core loop can be told from one inside it."""
    out, fn, ops = {}, None, []

    def close():
        if fn is not None:
            hg = [i for i, o in enumerate(ops) if o.startswith("HGMMA")]
            out[fn] = (sum(1 for o in ops[hg[0]:hg[-1]] if o.split(".")[0] in ("LDL", "STL"))
                       if hg else 0)

    for line in cuobjdump(build, name, "-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            k = re.search(pattern, m.group(1))
            fn, ops = (k.group(1) if k else None), []
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is not None and op:
            ops.append(op.group(1))
    close()
    return out


def ptxas_spills(log: str) -> dict:
    """{mangled function: {"stack_frame": bytes, "spill_stores": bytes,
    "spill_loads": bytes}} from ``ptxas -v``'s report in a build log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if fn and m:
            out[fn] = dict(zip(("stack_frame", "spill_stores", "spill_loads"),
                               map(int, m.groups())))
            fn = None
    return out


def res_usage(build, name: str) -> dict:
    """{mangled function: {"REG": n, "STACK": bytes, "LOCAL": bytes, ...}} from
    ``cuobjdump -res-usage``. A spill goes to the stack frame, so STACK and
    LOCAL both 0 means nothing spills."""
    out, fn = {}, None
    for line in cuobjdump(build, name, "-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            fn = m.group(1)
        elif fn and "REG:" in line:
            out[fn] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            fn = None
    return out


def wkv6_floor(torch, B, T, H, N, dtype, cols, splits):
    """The kernel's own floor (ms): the fp32 instructions it executes over
    the card's fp32 issue rate (one instruction per lane and cycle, half
    the fp32 FLOP peak), or the bound's bytes if more. Per step and state
    element an FMA (r·S), a multiply (k·v) and an FMA (w·S + kv); per step,
    row and block, 2 per key row for coef (r·u, then the FMA with k) and
    log2(KT) adds on each of its KT = N/8 lanes; per output, KT - 1 adds of
    the partial sums and the FMA with coef·v. ``cols`` does not change the
    count; ``splits`` repeats coef in every block of a row."""
    kt = N // 8
    rows = B * H * T
    instr = (3.0 * rows * N * N
             + rows * splits * (2.0 * N + kt * (kt.bit_length() - 1))
             + rows * N * float(kt))
    esz = torch.tensor([], dtype=dtype).element_size()
    elems = B * T * H * N
    nbytes = 4 * elems * esz + 4 * elems + 4 * H * N + 4 * B * H * N * N
    return max(instr / (PEAK_FP32_FLOPS / 2), nbytes / PEAK_BYTES_PER_S) * 1e3


def check_wkv6(torch, ops, ref, timer, gen, name, B, T, H, N, dtype, reps, plain_reps,
               others=False, misalign=False):
    """One WKV6 shape: kernel vs plain version on the card, then times.
    ``others`` also checks and times every launch ``ops.configs`` lists
    beside ``ops.CONFIG``'s, each bit for bit equal to it; ``misalign``
    hands the kernel r, k, v, w as views one element past a 16-byte
    boundary (TMA cannot take them; the wrapper copies them first)."""
    dev = gen.device

    def make(x):
        if not misalign:
            return x
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0
        return view

    r, k, v = (make((torch.randn((B, T, H, N), generator=gen, device=dev) * 0.5).to(dtype))
               for _ in range(3))
    w = make(torch.exp(-torch.exp(torch.randn((B, T, H, N), generator=gen, device=dev)
                                  - 2.0)))
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    y, s = ops.wkv6(r, k, v, w, u)
    yr, sr = ref.wkv6_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    atol, rtol = _tol(torch, dtype, TOL_WKV, ATOL_BF16_WKV_Y)

    def hold(y, s, what):
        err_y = float((y.float() - yr.float()).abs().max()) if y.numel() else 0.0
        err_s = float((s - sr).abs().max())
        if not (torch.isfinite(y.float()).all() and torch.isfinite(s).all()):
            raise AssertionError(f"wkv6 {what}: non-finite output")
        if not torch.allclose(y.float(), yr.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"wkv6 {what}: y max abs err {err_y} beyond atol {atol} "
                                 f"rtol {rtol}")
        if not torch.allclose(s, sr, atol=TOL_WKV, rtol=TOL_WKV):
            raise AssertionError(f"wkv6 {what}: S max abs err {err_s} beyond {TOL_WKV}")
        return err_y, err_s

    err_y, err_s = hold(y, s, name)
    cols, splits = ops.CONFIG[N]
    bound_ms, bound_by = wkv6_bound(torch, B, T, H, N, dtype)
    row = {"shape": name, "B": B, "T": T, "H": H, "N": N, "dtype": str(dtype),
           "misaligned": misalign, "cols": cols, "splits": splits,
           "atol_y": atol, "rtol_y": rtol, "tol_s": TOL_WKV, "max_abs_err": max(err_y, err_s),
           "ms": timer(lambda: ops.wkv6(r, k, v, w, u), reps),
           "plain_ms": timer(lambda: ref.wkv6_ref(r, k, v, w, u), plain_reps),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "floor_ms": wkv6_floor(torch, B, T, H, N, dtype, cols, splits),
           "other_splits": {}}
    for c, sp in (ops.configs(N, dtype) if others else ()):
        if (c, sp) == (cols, splits):
            continue
        y2, s2 = ops.launch(r, k, v, w, u, c, sp)
        hold(y2, s2, f"{name} at cols {c} splits {sp}")
        # no step of the kernel's order depends on the launch
        if not (torch.equal(y2, y) and torch.equal(s2, s)):
            raise AssertionError(f"wkv6 {name}: cols {c} splits {sp} differs in its bits "
                                 f"from cols {cols} splits {splits}")
        row["other_splits"][f"cols{c}_splits{sp}"] = timer(
            lambda: ops.launch(r, k, v, w, u, c, sp), reps)
    log(f"phase 7 lm-kernels: wkv6 {name} B={B} T={T} H={H} N={N} {dtype}"
        f"{' misaligned' if misalign else ''}: max abs err y {err_y} S {err_s} (y atol "
        f"{atol} rtol {rtol}, S {TOL_WKV}); cols {cols} splits {splits}: kernel "
        f"{row['ms']} ms plain {row['plain_ms']} ms library none bound {bound_ms} ms "
        f"({bound_by}) floor {row['floor_ms']} ms"
        + (f"; at other launches {json.dumps(row['other_splits'])}" if others else ""))
    return row


def check_flash(torch, ops, ref, timer, gen, name, B, S, H, Hkv, hd, causal, window, dtype,
                reps, route, Sk=None, unaligned=False):
    """One attention shape: q (B, S, H, hd) against k, v (B, Sk, Hkv, hd)
    (``Sk`` defaults to S), kernel vs plain version on the card, the launch
    on the kernel ``route`` names (the wrapper's forward route counts, from
    the library's own rule) and made twice with the same bits, then the
    kernel's, the plain version's and SDPA's times, the bound and the
    kernel's floor. ``unaligned`` puts q, k and v one element past a
    16-byte boundary (contiguous views), a layout TMA cannot take."""
    import torch.nn.functional as F

    dev = gen.device
    Sq, Sk = S, Sk or S

    def draw(shape):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        return off_boundary(torch, x) if unaligned else x

    q = draw((B, Sq, H, hd))
    k, v = (draw((B, Sk, Hkv, hd)) for _ in range(2))
    before = dict(ops.flash_attention.routes)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    moved = [r for r, c in ops.flash_attention.routes.items() if c != before[r]]
    if moved != [route]:
        raise AssertionError(f"flash {name}: forward route {moved}, want {route}")
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    atol, rtol = _tol(torch, dtype, TOL_ATTN, ATOL_BF16_ATTN)
    err = float((o.float() - want.float()).abs().max())
    if o.shape != want.shape or not torch.isfinite(o.float()).all():
        raise AssertionError(f"flash {name}: shape {tuple(o.shape)} or non-finite output")
    if not torch.allclose(o.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"flash {name}: max abs err {err} beyond atol {atol} "
                             f"rtol {rtol}")
    if not torch.equal(o, again):
        raise AssertionError(f"flash {name}: a second launch gave other bits")
    del again
    # the library yardstick: one SDPA call on the same inputs in its own
    # (B, H, S, hd) layout, with the same mask (``is_causal`` aligns the
    # diagonal top left: key j <= query i, as the kernel counts); never
    # called by the port
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kw = {"enable_gqa": Hkv != H}
    if causal and window:
        diff = (torch.arange(Sq, device=dev)[:, None]
                - torch.arange(Sk, device=dev)[None, :])
        kw["attn_mask"] = (diff >= 0) & (diff < window)
    else:
        kw["is_causal"] = causal
    bound_ms, bound_by = flash_bound(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype)
    bound_fma_ms = flash_bound(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype,
                               PEAK_FP32_FLOPS)[0]
    floor_ms = flash_floor(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype, route)
    row = {"shape": name, "B": B, "S": Sq, "Sk": Sk, "H": H, "Hkv": Hkv, "hd": hd,
           "causal": causal,
           "window": window, "dtype": str(dtype), "route": route, "unaligned": unaligned,
           "atol": atol, "rtol": rtol, "max_abs_err": err,
           "ms": timer(lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                       reps),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                       window=window), reps),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                               reps),
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_fma_ms": bound_fma_ms,
           "floor_ms": floor_ms}
    log(f"phase 7 lm-kernels: flash {name} B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} causal "
        f"{causal} window {window} {dtype}{' unaligned' if unaligned else ''}, {route} route: "
        f"max abs err {err} (atol {atol} rtol {rtol}), the same bits twice; kernel "
        f"{row['ms']} ms plain {row['plain_ms']} ms sdpa {row['library_ms']} ms bound "
        f"{bound_ms} ms ({bound_by}; at the FMA peak {bound_fma_ms}) floor {floor_ms} ms")
    return row


def flash_bwd_bound(torch, B, Sq, Sk, H, Hkv, hd, causal, window, dtype, products=5,
                    reads_o=True, fp32_peak=FP32_MM_FLOPS):
    """(bound_ms, bound_by) of the attention backward: q, k, v, o, dO (in
    their type) and lse (fp32) read once, dq, dk, dv written once, over HBM
    bandwidth, against ``products`` products of 2·hd operations per live
    pair (the backward as a whole needs five: s, dp, dv, dq, dk) over the
    peak for the inputs' type (fp32: ``fp32_peak``, 3×TF32 on the tensor
    cores; ``PEAK_FP32_FLOPS`` for the FMA pipes' bound). Per kernel: the
    dq kernel's work is three products (s, dp, dq) reading o and writing dq
    and delta; the dK/dV kernel's four (s, dp, dv, dk) reading delta in o's
    place and writing dk and dv."""
    esz = torch.tensor([], dtype=dtype).element_size()
    q_elems, kv_elems = B * Sq * H * hd, B * Sk * Hkv * hd
    rows = B * H * Sq
    nbytes = esz * (3 * q_elems + 2 * kv_elems) + 4 * rows   # q, o, dO, k, v, lse
    if products == 5:
        nbytes += esz * (q_elems + 2 * kv_elems)             # dq, dk, dv
    elif reads_o:
        nbytes += esz * q_elems + 4 * rows                   # dq, delta
    else:
        nbytes += -esz * q_elems + 4 * rows + esz * 2 * kv_elems  # delta for o; dk, dv
    flops = products * 2.0 * hd * B * H * live_pairs(Sq, Sk, causal, window)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else fp32_peak
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# rows of a streamed tile of the fp32 tensor-core pair (``x3::kTileRows``):
# keys of the dq kernel's K/V tiles, queries of the dK/dV kernel's Q/dO tiles
X3_TILE_ROWS = 32


def flash_bwd_x3_floor(B, Sq, Sk, H, Hkv, hd, causal, window) -> dict:
    """{"dq", "dkdv", "pair": ms}: the fp32 tensor-core pair's own floor,
    the TF32 products it executes over ``PEAK_TF32_FLOPS``. It counts the
    tiles each kernel computes, masked parts and the padded hd (64, 128 or
    256) included: the dq kernel, per 64-row query block and each T-key
    tile from the first to the last some row of it leaves live, three
    products (S, dP, dQ) of 64 x T x hd; the dK/dV kernel, per 64-key block,
    query head of its group and T-query tile some key of it leaves live,
    four (S^T, dP^T, dV, dK); each product as three TF32 products. (At hd
    256 a cluster pair splits each product's hd between its two blocks.)"""
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    T = X3_TILE_ROWS
    win = window if (causal and window) else 0
    dq_tiles = 0
    for q0 in range(0, Sq, 64):
        q_last = min(q0 + 64, Sq) - 1
        lo, hi = 0, (Sk - 1) // T
        if causal:
            hi = min(q_last, Sk - 1) // T
            if win:
                lo = max(0, q0 - win + 1) // T
        dq_tiles += max(0, hi - lo + 1)
    kv_tiles = 0
    for k0 in range(0, Sk, 64):
        k_last = min(k0 + 64, Sk) - 1
        lo, hi = 0, (Sq - 1) // T
        if causal:
            lo = k0 // T
            if win:
                hi = min(Sq - 1, k_last + win - 1) // T
        kv_tiles += max(0, hi - lo + 1)
    per_tile = 3 * 2.0 * 64 * T * hdp   # one product as three TF32 products
    out = {"dq": 3 * per_tile * dq_tiles * B * H / PEAK_TF32_FLOPS * 1e3,
           "dkdv": 4 * per_tile * kv_tiles * B * H / PEAK_TF32_FLOPS * 1e3}
    out["pair"] = out["dq"] + out["dkdv"]
    return out


def check_flash_bwd(torch, ops, ref, timer, gen, name, B, Sq, H, Hkv, hd, causal, window,
                    dtype, reps, want_route, Sk=None, unaligned=False):
    """One attention shape of the training path: the forward's lse against
    the plain lse (1e-5), then the backward kernels against
    ``attention_bwd_ref`` on the same (q, k, v, o, lse, dO): fp32 atol =
    rtol = 1e-4; bf16 rtol 2^-7 (one ulp) and an atol of 4 x the max abs
    error the fp32 FMA kernels make on the same inputs widened to fp32 (the
    FMA route's bf16 instance runs the same fp32 arithmetic and rounds once
    at the end; the tensor-core route forms s and dp in fp32 from the bf16
    operands and takes p and dS as three bf16 terms). That yardstick is
    pinned to the FMA pair: the widened copies lie one element off a
    16-byte boundary, which the route rule sends there (asserted); the
    3×TF32 pair's error on the aligned widened copies is recorded beside.
    Both kernels, and the forward that gives o and lse, must run
    ``want_route`` (the wrappers' route counts, from the library's own
    rules). Each backward launch is made twice and must
    give the same bits. Then the times and bounds, each of the whole
    backward and of each kernel alone: the kernels', their plain versions'
    (the two halves of ``attention_bwd_ref``) and the library's (autograd's
    backward of one SDPA call, for all of q, k, v; for q alone; for k and v
    alone); fp32 bounds at 3×TF32's rate and at the FMA pipes' beside, and
    the 3×TF32 pair's floor. ``unaligned`` puts q, k, v and dO one element
    past a 16-byte boundary (contiguous views), a layout TMA cannot take."""
    import torch.nn.functional as F

    dev = gen.device
    Sk = Sk or Sq

    def draw(shape):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        return off_boundary(torch, x) if unaligned else x

    q = draw((B, Sq, H, hd))
    k, v = (draw((B, Sk, Hkv, hd)) for _ in range(2))
    do = draw((B, Sq, H, hd))
    kw = {"causal": causal, "window": window}
    fwd_before = dict(ops.flash_attention.routes)
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    fwd_route = [r for r, c in ops.flash_attention.routes.items() if c != fwd_before[r]]
    if fwd_route != [want_route]:
        raise AssertionError(f"flash bwd {name}: forward route {fwd_route}, want {want_route}")
    lse_want = ref.attention_ref(q, k, v, return_lse=True, **kw)[1]
    before = {n: dict(getattr(ops, n).routes) for n in BWD_KERNELS}
    dq, dk, dv = ops.flash_bwd(q, k, v, o, lse, do, **kw)
    route = {n: [r for r, c in getattr(ops, n).routes.items() if c != before[n][r]]
             for n in BWD_KERNELS}
    if any(r != [want_route] for r in route.values()):
        raise AssertionError(f"flash bwd {name}: routes {route}, want {want_route}")
    again = ops.flash_bwd(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    dead = int(torch.isinf(lse_want).sum())
    if not (torch.equal(torch.isinf(lse), torch.isinf(lse_want))
            and torch.allclose(lse, lse_want, atol=TOL_LSE, rtol=TOL_LSE)):
        fin = torch.isfinite(lse_want)
        raise AssertionError(f"flash bwd {name}: lse max abs err "
                             f"{float((lse[fin] - lse_want[fin]).abs().max())}")
    lse_err = float((lse - lse_want)[torch.isfinite(lse_want)].abs().max())
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash bwd {name}: a second launch gave other bits")
    e_x3 = None
    if dtype == torch.float32:
        atol = rtol = TOL_GRAD
        e32 = None
    else:
        atol, e32, e_x3, g32 = bf16_gate_atol(torch, ops, ref, q, k, v, o, lse, do, kw, name)
        rtol = RTOL_BF16
        # recorded: the bf16 outputs are the fp32 kernels' rounded to bf16
        # (so on the FMA route; the tensor-core route rounds p and dS)
        same_bits = all(torch.equal(a, b.to(dtype)) for a, b in zip((dq, dk, dv), g32))
    errs = {}
    for gname, got, exp in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        if got.shape != exp.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash bwd {name}: {gname} shape {tuple(got.shape)} or "
                                 "non-finite")
        errs[gname] = float((got.float() - exp.float()).abs().max())
        if not torch.allclose(got.float(), exp.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"flash bwd {name}: {gname} max abs err {errs[gname]} beyond "
                                 f"atol {atol} rtol {rtol}")
    # the library yardstick: autograd's backward of one SDPA call in its own
    # (B, H, S, hd) layout with the same mask; never called by the port
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    skw = {"enable_gqa": Hkv != H}
    if causal and window:
        diff = (torch.arange(Sq, device=dev)[:, None] - torch.arange(Sk, device=dev)[None, :])
        skw["attn_mask"] = (diff >= 0) & (diff < window)
    else:
        skw["is_causal"] = causal
    out_t = F.scaled_dot_product_attention(qt, kt, vt, **skw)
    dq_only, delta = ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)
    delta_plain = ref.attention_bwd_dq_ref(q, k, v, o, lse, do, **kw)[1]
    plain_reps = max(1, reps // 3)
    sdpa_grad = lambda *ins: timer(lambda: torch.autograd.grad(out_t, ins, dot,
                                                               retain_graph=True), reps)
    row = {"shape": name, "B": B, "S": Sq, "Sk": Sk, "H": H, "Hkv": Hkv, "hd": hd,
           "causal": causal, "window": window, "dtype": str(dtype), "route": want_route,
           "unaligned": unaligned,
           "atol": atol, "rtol": rtol, "fp32_max_abs_err_same_inputs": e32,
           "fp32_tf32x3_max_abs_err_same_inputs": e_x3,
           "lse_max_abs_err": lse_err,
           "dead_rows": dead, "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "bf16_is_fp32_rounded": None if e32 is None else same_bits,
           "ms": timer(lambda: ops.flash_bwd(q, k, v, o, lse, do, **kw), reps),
           "dq_ms": timer(lambda: ops.flash_bwd_dq(q, k, v, o, lse, do, **kw), reps),
           "dkdv_ms": timer(lambda: ops.flash_bwd_dkdv(q, k, v, lse, delta, do, **kw), reps),
           "plain_ms": timer(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, **kw),
                             plain_reps),
           "plain_dq_ms": timer(lambda: ref.attention_bwd_dq_ref(q, k, v, o, lse, do, **kw),
                                plain_reps),
           "plain_dkdv_ms": timer(lambda: ref.attention_bwd_dkdv_ref(q, k, v, lse, delta_plain,
                                                                     do, **kw), plain_reps),
           "library_ms": sdpa_grad(qt, kt, vt), "library_dq_ms": sdpa_grad(qt),
           "library_dkdv_ms": sdpa_grad(kt, vt)}
    dims = (B, Sq, Sk, H, Hkv, hd, causal, window, dtype)
    for part, kw_b in (("", {}), ("dq_", {"products": 3}),
                       ("dkdv_", {"products": 4, "reads_o": False})):
        row[f"{part}bound_ms"], row[f"{part}bound_by"] = flash_bwd_bound(torch, *dims, **kw_b)
        row[f"{part}bound_fma_ms"] = flash_bwd_bound(torch, *dims, **kw_b,
                                                     fp32_peak=PEAK_FP32_FLOPS)[0]
    if want_route == "tf32x3":
        floor = flash_bwd_x3_floor(B, Sq, Sk, H, Hkv, hd, causal, window)
        row["floor_ms"], row["dq_floor_ms"], row["dkdv_floor_ms"] = (
            floor["pair"], floor["dq"], floor["dkdv"])
    del qt, kt, vt, out_t
    log(f"phase 16 lm-train: flash bwd {name} B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} hd={hd} "
        f"causal {causal} window {window} {dtype}, {want_route} route: lse max abs err "
        f"{lse_err} ({dead} rows "
        f"with no live key); max abs err {json.dumps(errs)} (atol {atol} rtol {rtol}); "
        f"deterministic; kernels {row['ms']} ms (dq {row['dq_ms']}, dkdv {row['dkdv_ms']}) "
        f"plain {row['plain_ms']} ms (dq {row['plain_dq_ms']}, dkdv {row['plain_dkdv_ms']}) "
        f"sdpa backward {row['library_ms']} ms (q alone {row['library_dq_ms']}, k and v "
        f"{row['library_dkdv_ms']}) bound {row['bound_ms']} ms ({row['bound_by']}; dq "
        f"{row['dq_bound_ms']}, dkdv {row['dkdv_bound_ms']}; at the FMA peak "
        f"{row['bound_fma_ms']})"
        + (f" floor {row['floor_ms']} ms (dq {row['dq_floor_ms']}, dkdv "
           f"{row['dkdv_floor_ms']})" if "floor_ms" in row else "")
        + ("" if e32 is None else f"; bf16 = fp32 kernels rounded: {same_bits}; the 3xTF32 "
           f"pair's fp32 error on the same inputs {e_x3} (the FMA pair's {e32})"))
    return row


def off_boundary(torch, x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary: a
    layout TMA cannot take, so the backward's route rule sends it to the
    FMA pair."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def bf16_gate_atol(torch, ops, ref, q, k, v, o, lse, do, kw, name) -> tuple:
    """(atol, e32, e_x3, g32) of a bf16 row's gate: atol = 4 x e32, the max
    abs error of the fp32 FMA pair against ``attention_bwd_ref`` on the
    inputs widened to fp32, the widened copies placed off a 16-byte
    boundary so that the route rule sends them to the FMA pair (asserted;
    the yardstick the bf16 gate has always taken); e_x3 the 3×TF32 pair's
    error on the aligned widened copies, recorded; g32 the FMA pair's
    gradients."""
    w32 = [t.float() for t in (q, k, v, o, do)]
    r32 = ref.attention_bwd_ref(*w32[:4], lse, w32[4], **kw)
    before = {n: dict(getattr(ops, n).routes) for n in BWD_KERNELS}
    g32 = ops.flash_bwd(*(off_boundary(torch, t) for t in w32[:4]), lse,
                        off_boundary(torch, w32[4]), **kw)
    moved = {n: [r for r, c in getattr(ops, n).routes.items() if c != before[n][r]]
             for n in BWD_KERNELS}
    if any(r != ["fma"] for r in moved.values()):
        raise AssertionError(f"flash bwd {name}: the bf16 gate's fp32 yardstick ran {moved}, "
                             "not the FMA pair")
    x3 = ops.flash_bwd(*w32[:4], lse, w32[4], **kw)
    e32 = max(float((a - b).abs().max()) for a, b in zip(g32, r32))
    e_x3 = max(float((a - b).abs().max()) for a, b in zip(x3, r32))
    return 4 * e32, e32, e_x3, g32


def wkv6_bwd_bound(torch, B, T, H, N, dtype, with_ds=False) -> dict:
    """{part: (bound_ms, bound_by)} of the WKV6 backward: the function
    ("whole", the yardstick) and the kernel as it runs ("kernel"): inputs
    read once and outputs written once over HBM bandwidth, against the
    operations, each over the peak for its operands' type.

    whole: r, k, v, dy (dtype), w (fp32), u, the forward's stage states
    (fp32) and ds (fp32, when given) in; dr, dk, dv (dtype), dw (fp32), du
    out. Per step and state element: the state recomputed (w·S + k·v), dr
    (S·dy), G's update (w·G + r·dy), dk (G·v), dv (G·k) and dw (S·G), 14
    operations, of which the products k·v and r·dy take two inputs of the
    given dtype (bf16 peak when they are bf16) and the other 12 the fp32
    state (fp32 peak); per step and key row 16 more: v·dy (2), coef (3),
    the u terms of dr, dk and du (3 each) and coef·dy (2).
    kernel: the same, and du's B shares (fp32) written and read back by the
    ticket's last block, and the tickets (written by a memset, counted
    once); dv's sums cross the cluster in distributed shared memory, which
    is not HBM."""
    esz = torch.tensor([], dtype=dtype).element_size()
    elems = B * T * H * N
    n_stages = -(-T // 32)
    rows = B * H * T
    pair_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ins = (4 * elems * esz + 4 * elems + 4 * H * N + 4 * B * H * n_stages * N * N
           + (4 * B * H * N * N if with_ds else 0))
    outs = 3 * elems * esz + 4 * elems + 4 * H * N
    from repro_torch.kernels.wkv6.ops import bwd_rows

    scratch = 2 * 4 * B * H * N + 4 * H * (N // bwd_rows(N))
    t_ops = (rows * 12.0 * N * N / PEAK_FP32_FLOPS + rows * 2.0 * N * N / pair_peak
             + rows * 16.0 * N / PEAK_FP32_FLOPS)
    out = {}
    for part, nbytes in (("whole", ins + outs), ("kernel", ins + outs + scratch)):
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[part] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def wkv6_grads_fp64(torch, r, k, v, w, u, dy, ds):
    """(dr, dk, dv, dw, du) in fp64: autograd through the recurrence written
    out in fp64 (independent of both the kernels and ``wkv6_bwd_ref``), the
    answer both fp32 versions round towards."""
    ins = [t.double().requires_grad_(True) for t in (r, k, v, w, u)]
    rd, kd, vd, wd, ud = ins
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N), dtype=torch.float64, device=r.device)
    ys = []
    with torch.enable_grad():
        for t in range(T):
            rt, kt, vt, wt = rd[:, t], kd[:, t], vd[:, t], wd[:, t]
            coef = (rt * ud * kt).sum(-1, keepdim=True)
            ys.append(coef * vt + torch.einsum("bhn,bhnm->bhm", rt, S))
            S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
        outs, cots = [torch.stack(ys, 1)], [dy.double()]
        if ds is not None:
            outs.append(S)
            cots.append(ds.double())
        return torch.autograd.grad(outs, ins, cots)


def check_wkv6_bwd(torch, ops, ref, timer, gen, name, B, T, H, N, dtype, w_value, with_ds,
                   reps, plain_reps, fp64=False):
    """One WKV6 shape of the training path. The training forward (the kernel
    writing its stage states) against the serving forward on the same
    inputs, y and S bit for bit (its states against the plain version's
    recorded); then the backward kernel against ``wkv6_bwd_ref`` on the
    same (r, k, v, w, u, dy, ds): fp32 dr, dk, dv atol = rtol = 1e-4; bf16
    dr, dk, dv rtol 2^-7 (one ulp) and an atol of 4 x the max abs error the
    fp32 kernels make on the same inputs widened to fp32 (held at 1e-4
    themselves); dw and du, fp32 sums of the same widened inputs, 1e-4 in
    both dtypes. Each backward launch is made twice and must give the same
    bits. w is drawn as the model draws it (exp(-exp(.))) or is
    ``w_value`` everywhere. With ``fp64`` (fp32 only: w near 1, where the
    state carries its rounding over ~1,000 steps and two fp32 versions
    part by more than 1e-4 on terms of ~10^3) both are also held against
    ``wkv6_grads_fp64``: the kernels' max abs error against it must be at
    most twice the plain version's (or 1e-4), and the kernels against the
    plain version take an atol of twice the plain version's own error
    against fp64 where that is above 1e-4. The memory a backward call takes
    beyond its outputs (du's B shares and the tickets) must stay under
    ``WKV6_BWD_SCRATCH``: no fp32 scratch of dv. Then the times, each with
    and without the timer's device-side wait: the backward kernel, the
    forward with and without its stage states; the plain backward (given
    the states, as the kernel is); the bounds of the function and of the
    kernel as it runs."""
    dev = gen.device
    r, k, v = ((torch.randn((B, T, H, N), generator=gen, device=dev) * 0.5).to(dtype)
               for _ in range(3))
    if w_value is None:
        w = torch.exp(-torch.exp(torch.randn((B, T, H, N), generator=gen, device=dev) - 2.0))
    else:
        w = torch.full((B, T, H, N), w_value, device=dev)
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    dy = torch.randn((B, T, H, N), generator=gen, device=dev).to(dtype)
    ds = torch.randn((B, H, N, N), generator=gen, device=dev) if with_ds else None
    cfg = ops.CONFIG[N]
    y, s, states = ops.launch(r, k, v, w, u, *cfg, stage_states=True)
    y0, s0 = ops.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    if not (torch.equal(y, y0) and torch.equal(s, s0)):
        raise AssertionError(f"wkv6 bwd {name}: the training forward's y / S differ in their "
                             "bits from the serving forward's")
    states_want = ref.wkv6_ref(r, k, v, w, u, stage_states=True)[2]
    states_err = float((states - states_want).abs().max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = ops.wkv6_bwd(r, k, v, w, u, dy, ds, states)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - held - sum(
        t.numel() * t.element_size() for t in got)
    again = ops.wkv6_bwd(r, k, v, w, u, dy, ds, states)
    want = ref.wkv6_bwd_ref(r, k, v, w, u, dy, ds)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"wkv6 bwd {name}: a second launch gave other bits")
    names = ("dr", "dk", "dv", "dw", "du")
    fails = []
    if scratch > WKV6_BWD_SCRATCH:
        fails.append(f"the backward took {scratch} bytes beyond its outputs (at most "
                     f"{WKV6_BWD_SCRATCH})")

    def hold(outs, exps, atol, rtol, which, tag, keys=names):
        errs = {}
        for gname, a, b in zip(keys, outs, exps):
            if gname not in which:
                continue
            if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a.float()).all():
                fails.append(f"{tag}{gname}: shape {tuple(a.shape)} {a.dtype} or non-finite")
                continue
            errs[gname] = float((a.float() - b.float()).abs().max())
            if not torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol):
                bad = ((a.float() - b.float()).abs() > atol + rtol * b.float().abs())
                fails.append(f"{tag}{gname}: max abs err {errs[gname]} beyond atol {atol} rtol "
                             f"{rtol} at {int(bad.sum())} of {bad.numel()}")
        return errs

    e32 = None
    fp64_errs = None
    if dtype == torch.float32:
        atol = rtol = TOL_GRAD
        if fp64:
            exact = wkv6_grads_fp64(torch, r, k, v, w, u, dy, ds)
            fp64_errs = {n: {"kernel": float((a.double() - x).abs().max()),
                             "plain": float((b.double() - x).abs().max())}
                         for n, a, b, x in zip(names, got, want, exact)}
            del exact
            for gname, e in fp64_errs.items():
                if e["kernel"] > max(2 * e["plain"], TOL_GRAD):
                    fails.append(f"{gname}: the kernels' max abs error against fp64 "
                                 f"{e['kernel']} beyond twice the plain version's {e['plain']}")
            errs = {}
            for gname in names:
                errs.update(hold(got, want, max(TOL_GRAD, 2 * fp64_errs[gname]["plain"]),
                                 rtol, [gname], ""))
        else:
            errs = hold(got, want, atol, rtol, names, "")
    else:
        wide = [t.float() for t in (r, k, v)]
        states32 = ops.launch(*wide, w, u, *cfg, stage_states=True)[2]
        g32 = ops.wkv6_bwd(*wide, w, u, dy.float(), ds, states32)
        r32 = ref.wkv6_bwd_ref(*wide, w, u, dy.float(), ds)
        fp32_errs = hold(g32, r32, TOL_GRAD, TOL_GRAD, names, "fp32 on the widened inputs: ")
        e32 = max(fp32_errs.get(n, 0.0) for n in names[:3])
        atol, rtol = 4 * e32, RTOL_BF16
        errs = hold(got, want, atol, rtol, names[:3], "")
        errs.update(hold(got, want, TOL_GRAD, TOL_GRAD, names[3:], ""))
        del g32, r32, states32, wide
    if fails:
        raise AssertionError(f"wkv6 bwd {name} B={B} T={T} H={H} N={N} {dtype} w {w_value} ds "
                             f"{with_ds}: " + "; ".join(fails))
    bounds = wkv6_bwd_bound(torch, B, T, H, N, dtype, with_ds)
    bound_ms, bound_by = bounds["whole"]
    bwd = lambda: ops.wkv6_bwd(r, k, v, w, u, dy, ds, states)
    fwd_states = lambda: ops.launch(r, k, v, w, u, *cfg, stage_states=True)
    fwd = lambda: ops.launch(r, k, v, w, u, *cfg)
    row = {"shape": name, "B": B, "T": T, "H": H, "N": N, "dtype": str(dtype),
           "w": "model" if w_value is None else w_value, "ds": with_ds,
           "atol": atol, "rtol": rtol, "dw_du_tol": TOL_GRAD,
           "fp32_max_abs_err_same_inputs": e32, "stage_states_max_abs_err": states_err,
           "max_abs_err_against_fp64": fp64_errs,
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "scratch_bytes": scratch,
           "ms": timer(bwd, reps), "ms_no_wait": timer(bwd, reps, wait=False),
           "fwd_states_ms": timer(fwd_states, reps),
           "fwd_states_ms_no_wait": timer(fwd_states, reps, wait=False),
           "fwd_ms": timer(fwd, reps), "fwd_ms_no_wait": timer(fwd, reps, wait=False),
           "plain_ms": timer(lambda: ref.wkv6_bwd_ref(r, k, v, w, u, dy, ds, states=states),
                             plain_reps),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "kernel_bound_ms": bounds["kernel"][0], "kernel_bound_by": bounds["kernel"][1]}
    log(f"phase 16 lm-train: wkv6 bwd {name} B={B} T={T} H={H} N={N} {dtype} w {row['w']} "
        f"ds {with_ds}: training forward = serving forward (bits), stage states max abs err "
        f"{states_err}; max abs err {json.dumps(errs)} (atol {atol} rtol {rtol}; dw, du "
        f"{TOL_GRAD}); deterministic; scratch {scratch} bytes; backward {row['ms']} ms "
        f"(without the timer's wait {row['ms_no_wait']}; kernel bound "
        f"{row['kernel_bound_ms']} ({row['kernel_bound_by']})), forward with states "
        f"{row['fwd_states_ms']} ms (without {row['fwd_ms']}; no wait "
        f"{row['fwd_states_ms_no_wait']}, {row['fwd_ms_no_wait']}), plain backward "
        f"{row['plain_ms']} ms, library none exists, bound {bound_ms} ms ({bound_by})"
        + ("" if fp64_errs is None else f"; max abs err against fp64 {json.dumps(fp64_errs)}"))
    return row


def rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| in fp64 (0 when both are 0)."""
    d = (got.double() - want.double()).norm()
    n = want.double().norm()
    return float(d / n) if n > 0 else float(d)


def flip_ulps(torch, x, frac, gen):
    """x with a random ``frac`` of its elements moved one ulp away from 0
    (one added to their bit pattern)."""
    itype = {2: torch.int16, 4: torch.int32}[x.element_size()]
    pick = torch.rand(x.shape, generator=gen, device=x.device) < frac
    return (x.contiguous().view(itype) + pick.to(itype)).view(x.dtype)


def _state_leaves(state):
    """(name, tensor) for every leaf of a decode state, in a fixed order
    (the units', the remainder's, then each unit's cross K/V)."""
    out = []
    for u, unit in enumerate(state["units"]):
        for b, st in unit.items():
            out += [(f"unit{u}.{b}.{k}", t) for k, t in st.items()]
    for b, st in state.get("rem", {}).items():
        out += [(f"rem.{b}.{k}", t) for k, t in st.items()]
    for u, xc in enumerate(state.get("cross", [])):
        out += [(f"cross.unit{u}.{k}", t) for k, t in xc.items()]
    return out


def extra_inputs(torch, cfg, batch, dev, gen=None):
    """``lm_prefill``'s other inputs, as ``serve`` makes them: image
    embeddings (B, n_image_tokens, d) and encoder frames (B, Se, d), zero,
    or drawn from ``gen`` when one is given."""
    def make(shape):
        if gen is None:
            return torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        return torch.randn(shape, generator=gen).to(cfg.torch_dtype).to(dev)

    kw = {}
    if cfg.n_image_tokens:
        kw["image_embeds"] = make((batch, cfg.n_image_tokens, cfg.d_model))
    if cfg.n_encoder_layers:
        kw["enc_frames"] = make((batch, cfg.encoder_seq_len, cfg.d_model))
    return kw


def _trace(torch, fn, top: int):
    """Run ``fn`` under ``torch.profiler``: wall time, the device's busy
    time (the sum over the device-side events: kernels, copies, memsets,
    all on one stream) and its busy share, and the events that take most of
    the device and of the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        t = getattr(e, "device_time_total", None)
        return getattr(e, "cuda_time_total", 0) if t is None else t

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    by_dev = sorted(on_dev, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    spmm = [e for e in on_dev if "spmm" in e.key]
    nccl = [e for e in on_dev if "nccl" in e.key.lower()]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "api_calls": {n: sum(e.count for e in on_host if e.key == n) for n in API_CALLS},
        "spmm_kernels": {"count": sum(e.count for e in spmm),
                         "device_ms": sum(dev_us(e) for e in spmm) / 1e3},
        "nccl_kernels": {"count": sum(e.count for e in nccl),
                         "device_ms": sum(dev_us(e) for e in nccl) / 1e3},
        "top_device": [{"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
                       for e in by_dev],
        "top_host": [{"name": e.key, "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def profile_lm(torch, lm, params, cfg, prompts, max_len, kw, top: int = 8) -> dict:
    """One prefill, then 4 decode steps, each traced on its own."""
    n = prompts.shape[1] + (cfg.n_image_tokens or 0)

    def decode(state, tok):
        for i in range(4):
            logits, state = lm.decode_step(params, cfg, state, tok, n + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        return tok

    with torch.inference_mode():
        (last, state), pre = _trace(torch, lambda: lm.lm_prefill(params, cfg, prompts,
                                                                 max_len, **kw), top)
        _, dec = _trace(torch, lambda: decode(state, last.argmax(-1)[:, None]), top)
    return {"prefill": pre, "decode_4_steps": dec}


def full_width(get_config, arch, n_layers):
    """(config, reduction): the full config, with ``n_layers`` layers when
    one card cannot hold the whole model (``dataclasses.replace``)."""
    import dataclasses

    cfg = get_config(arch)
    if n_layers is None:
        return cfg, None
    return (dataclasses.replace(cfg, n_layers=n_layers),
            f"n_layers {cfg.n_layers} -> {n_layers} ({cfg.param_count():,} -> "
            f"{dataclasses.replace(cfg, n_layers=n_layers).param_count():,} params)")


def lm_serve(torch, serve, counters, cfg, dev, tag, batch, prompt, gen,
             reduced=None) -> dict:
    """Phase 8 for one model: ``serve`` at full width with every launch
    counter set to 0 just before and read just after; the prefill must
    launch the WKV6 kernel once per ``rwkv`` block and flash attention once
    per ``attn``/``local`` block and encoder layer and twice per ``dec``
    block (its self attention and its cross attention), and nothing else
    (``rec`` blocks and MoE FFNs launch no kernel of the port)."""
    kinds = list(cfg.block_pattern) * cfg.n_units + list(cfg.remainder_pattern)
    want = {n: 0 for n in counters}
    want["wkv6"] = kinds.count("rwkv")
    want["flash_attention"] = (sum(k in ("attn", "local") for k in kinds)
                               + 2 * kinds.count("dec") + cfg.n_encoder_layers)
    args = argparse.Namespace(arch=cfg.arch_id, batch=batch, prompt_len=prompt, gen=gen,
                              seed=0, device=str(dev))
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    out = serve(args, cfg=cfg)
    torch.cuda.synchronize()
    got = {n: c.launches for n, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    if (tuple(toks.shape) != (batch, gen) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"lm-serve {cfg.arch_id}: tokens {tuple(toks.shape)} or out "
                             "of the vocabulary")
    log(f"phase 8 lm-serve: {tag}: {cfg.arch_id} ({cfg.param_count():,} params, "
        f"{cfg.dtype}{'; reduced ' + reduced if reduced else ''}) batch {batch} prompt "
        f"{prompt} gen {gen}"
        f"{' image tokens ' + str(cfg.n_image_tokens) if cfg.n_image_tokens else ''}"
        f"{' encoder frames ' + str(cfg.encoder_seq_len) if cfg.n_encoder_layers else ''}"
        f": prefill "
        f"{out['prefill_s'] * 1e3} ms, decode {out['decode_tok_s']} tokens/s, peak memory "
        f"{peak_gb} GB; launches over the prefill {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"lm-serve {cfg.arch_id}: launches {got}, want {want}")
    return {"params": cfg.param_count(), "reduced": reduced, "batch": batch,
            "prompt": prompt, "gen": gen, "image_tokens": cfg.n_image_tokens,
            "encoder_frames": cfg.encoder_seq_len if cfg.n_encoder_layers else 0,
            "prefill_ms": out["prefill_s"] * 1e3, "decode_tok_s": out["decode_tok_s"],
            "peak_gb": peak_gb, "launches": got}


def moe_split(torch, cfg, bp, kind, h, out_k, out_p) -> dict:
    """An MoE block's kernel path (``out_k``) against its plain path
    (``out_p``) on the input ``h``, in two halves: the attention's output
    (what the kernel computes) and the block's output over the tokens both
    paths route alike (the same experts, the same kept pairs). Also the
    number routed differently and the whole block's error."""
    from repro_torch.models import attention, moe
    from repro_torch.models.layers import rmsnorm

    akind = "local" if kind == "local" else "causal"

    def ffn_input(use_kernel):
        return h + attention.multihead_attn(bp["attn"], cfg, h, kind=akind,
                                            use_kernel=use_kernel)

    def decisions(x):
        hn = rmsnorm(bp["ffn"]["ln"], x, cfg.norm_eps).reshape(-1, cfg.d_model)
        _, _, top_i, _ = moe.route(bp["ffn"]["moe"], cfg, hn)
        T = hn.shape[0]
        order, _, keep = moe.sort_dispatch(top_i, moe.capacity(T, cfg), cfg.n_experts)
        kept = torch.empty_like(keep)
        kept[order] = keep
        return top_i, kept.reshape(T, cfg.top_k)

    x_k, x_p = ffn_input(True), ffn_input(False)
    (ti_k, kp_k), (ti_p, kp_p) = decisions(x_k), decisions(x_p)
    alike = ((ti_k == ti_p) & (kp_k == kp_p)).all(-1)
    d = cfg.d_model
    return {"attn_rel_err": rel_err(torch, x_k, x_p),
            "routed_alike_rel_err": rel_err(torch, out_k.reshape(-1, d)[alike],
                                            out_p.reshape(-1, d)[alike]),
            "block_rel_err": rel_err(torch, out_k, out_p), "tokens": int(alike.numel()),
            "routed_differently": int((~alike).sum()),
            "dropped_pairs": int((~kp_k).sum())}


def lm_check_full(torch, lm, rmsnorm, cfg, dev, tag, batch, prompt, gen, profile,
                  reduced=None) -> dict:
    """Phase 9 at full width, on the weights and prompts ``serve`` drew
    (seed 0).

    Gated, block by block: the prefill runs along the kernel path, and at
    every block the same input also goes through the block's plain path;
    the block's output and its decode state (S, ``x_tm``, ``x_cm``, ``h``
    and ``conv`` or the K/V) must agree within ``TOL_BLOCK_REL`` (relative
    L2). An MoE block is held in two halves (``moe_split``): its attention
    output and its output over the tokens both paths route alike, each
    within ``TOL_BLOCK_REL``, and the tokens routed differently under
    ``MAX_REROUTED_SHARE``; its whole output's error is recorded. An
    encoder-decoder is walked encoder first, each ``enc`` block gated the
    same way; the encoder norm of the last ``enc`` block's output on each
    path gives each unit's cross K/V (``init_decode_state``), held kernel
    path against plain path; then every ``dec`` block of both paths attends
    to the kernel walk's encoder output, its state its self K/V. Image
    embeddings and encoder frames are zero, as ``serve`` makes them. Then
    the last logits of that walk must equal those of ``lm_prefill``.

    Recorded, no gate: the first prefill after the init (allocations
    included) and the steady state (the median of three more); the whole
    prefill along the plain path against the kernel path's; and, as its
    witness, the plain path against itself with one bf16 ulp flipped in a
    random share of the output of the first block the kernel path changes,
    the share of that output in which the kernel path differs from the
    plain path. If the witness diverges as far as the kernel path does, the stack
    (random bf16 weights) amplifies any one-ulp difference, and the
    end-to-end number measures the model, not a kernel.

    With ``profile``, a traced prefill + 4 decode steps."""
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(g, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=dev)
    kw = extra_inputs(torch, cfg, batch, dev)
    max_len = prompt + gen + (cfg.n_image_tokens or 0)
    blocks = [(f"enc{u}.b0", up["b0"], "enc") for u, up in enumerate(params.get("enc_units",
                                                                               []))]
    n_enc = len(blocks)
    blocks += [(f"unit{u}.b{i}", up[f"b{i}"], kind) for u, up in enumerate(params["units"])
               for i, kind in enumerate(cfg.block_pattern)]
    blocks += [(f"rem.b{i}", params["rem"][f"b{i}"], kind)
               for i, kind in enumerate(cfg.remainder_pattern)]

    def enc_norm(x):
        return rmsnorm(params["enc_norm"], x, cfg.norm_eps)

    def plain_from(start, h, enc_out):
        """The plain path from block ``start`` on, its input ``h``; the
        encoder's output is taken where the walk leaves the encoder."""
        for bi in range(start, len(blocks)):
            if n_enc and bi == n_enc:
                enc_out, h = enc_norm(h), h_dec0
            h, _, _ = lm.apply_block_full(blocks[bi][1], cfg, blocks[bi][2], h,
                                          enc_out=enc_out, use_kernel=False)
        return h
    errs, whole, moe_rows = {}, {}, {}
    by_kind: dict = {}
    first_plain = flip_frac = None
    first_idx = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_k, st_k = lm.lm_prefill(params, cfg, prompts, max_len, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the first call after a fresh init allocates its activations anew;
        # three more give the steady state
        steady = []
        for _ in range(3):
            ts = time.perf_counter()
            lm.lm_prefill(params, cfg, prompts, max_len, **kw)
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - ts) * 1e3)
        t_walk = time.perf_counter()
        h_dec0 = lm._embed_tokens(params, cfg, prompts, kw.get("image_embeds"))
        h, enc_out = h_dec0, None
        if n_enc:
            frames = kw["enc_frames"]
            h = frames + params["enc_pos"][None, :frames.shape[1]]
        for bi, (name, bp, kind) in enumerate(blocks):
            if n_enc and bi == n_enc:
                # every decoder block of both paths attends to the kernel
                # walk's encoder output
                enc_out, h = enc_norm(h), h_dec0
            out_k, _, sk = lm.apply_block_full(bp, cfg, kind, h, enc_out=enc_out,
                                               collect_state=True)
            out_p, _, sp = lm.apply_block_full(bp, cfg, kind, h, enc_out=enc_out,
                                               collect_state=True, use_kernel=False)
            if not torch.isfinite(out_k.float()).all():
                raise AssertionError(f"lm-check {cfg.arch_id}: {name} output not finite")
            whole[name] = rel_err(torch, out_k, out_p)
            if "moe" in bp.get("ffn", {}):
                m = moe_rows[name] = moe_split(torch, cfg, bp, kind, h, out_k, out_p)
                errs[f"{name}.attn"] = m["attn_rel_err"]
                errs[f"{name}.out_routed_alike"] = m["routed_alike_rel_err"]
                if m["routed_differently"] > MAX_REROUTED_SHARE * m["tokens"]:
                    raise AssertionError(f"lm-check {cfg.arch_id}: {name} routes "
                                         f"{m['routed_differently']} of {m['tokens']} tokens "
                                         "differently on the two paths")
            else:
                errs[f"{name}.out"] = whole[name]
            for key in sk or {}:
                errs[f"{name}.{key}"] = rel_err(torch, sk[key], sp[key])
            worst_here = max(v for k, v in errs.items() if k.startswith(f"{name}."))
            by_kind[kind] = max(by_kind.get(kind, 0.0), worst_here)
            if bi == n_enc - 1:
                # each unit's cross K/V from the encoder's output on each path
                xs = [lm.init_decode_state(params, cfg, batch, 1, enc_out=enc_norm(o))["cross"]
                      for o in (out_k, out_p)]
                for u, (xc_k, xc_p) in enumerate(zip(*xs)):
                    for key in xc_k:
                        errs[f"cross.unit{u}.{key}"] = rel_err(torch, xc_k[key], xc_p[key])
                        by_kind["cross"] = max(by_kind.get("cross", 0.0),
                                               errs[f"cross.unit{u}.{key}"])
                del xs
            if first_plain is None and (bool((out_k != out_p).any()) or bi == len(blocks) - 1):
                first_idx, first_plain = bi, out_p
                flip_frac = float((out_k != out_p).double().mean())
            h = out_k
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        walk_last = rmsnorm(params["final_norm"], h, cfg.norm_eps)[:, -1] @ head
        errs["last_logits_vs_lm_prefill"] = rel_err(torch, walk_last, last_k)
        del h, out_k, out_p, sk, sp
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        last_p, st_p = lm.lm_prefill(params, cfg, prompts, max_len, use_kernel=False, **kw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        # the witness: the plain path from the first block's plain output
        # with one ulp flipped in ``flip_frac`` of it
        h = flip_ulps(torch, first_plain, flip_frac, torch.Generator(device=dev).manual_seed(1))
        witness = {"block": blocks[first_idx][0], "flip_frac": flip_frac,
                   "first_block_rel_err": rel_err(torch, h, first_plain),
                   "kernel_first_block_rel_err": whole[blocks[first_idx][0]]}
        # (a first changed block in the decoder means no encoder block
        # changed, so the walk's encoder output is the plain path's)
        h = plain_from(first_idx + 1, h, enc_out)
        last_w = rmsnorm(params["final_norm"], h, cfg.norm_eps)[:, -1] @ head
        witness["last_logits_rel_err"] = rel_err(torch, last_w, last_p)
        del h, first_plain, last_w, h_dec0, enc_out
    free = {"last_logits": rel_err(torch, last_k, last_p)}
    for (name, a), (_, b) in zip(_state_leaves(st_k), _state_leaves(st_p)):
        free[name] = rel_err(torch, a, b)
    worst = max(errs, key=errs.get)
    free_worst = max(free, key=free.get)
    row = {"reduced": reduced, "block_rel_err": errs, "worst_by_kind": by_kind,
           "whole_block_rel_err": whole, "moe": moe_rows,
           "free_running_rel_err": free, "ulp_witness": witness,
           "warm_prefill_ms": (t1 - t0) * 1e3,
           "steady_prefill_ms": sorted(steady)[1], "plain_prefill_ms": (t3 - t2) * 1e3,
           "block_walk_s": t2 - t_walk}
    log(f"phase 9 lm-check: {cfg.arch_id} full width {cfg.dtype}"
        f"{' (reduced ' + reduced + ')' if reduced else ''}, block by block on the "
        f"card ({len(blocks)} blocks, kernel path vs plain path on the same input): worst "
        f"of {len(errs)} relative L2 errors {worst} {errs[worst]} (tol {TOL_BLOCK_REL}); "
        f"worst by block kind {json.dumps(by_kind)}"
        f"{' (MoE FFN, ' + str(cfg.n_experts) + ' experts top ' + str(cfg.top_k) + ')' if cfg.n_experts else ''}; "
        f"walk's last logits vs lm_prefill {errs['last_logits_vs_lm_prefill']}")
    for name, m in moe_rows.items():
        log(f"phase 9 lm-check: {cfg.arch_id} {name} MoE: attention relative L2 "
            f"{m['attn_rel_err']}, output over the tokens routed alike "
            f"{m['routed_alike_rel_err']} (tol {TOL_BLOCK_REL}); "
            f"{m['routed_differently']} of {m['tokens']} tokens routed differently (at most "
            f"{MAX_REROUTED_SHARE} of them); whole output {m['block_rel_err']} (recorded); "
            f"{m['dropped_pairs']} (token, expert) pairs over capacity")
    log(f"phase 9 lm-check: {cfg.arch_id} free-running (recorded, no gate): plain-path "
        f"prefill vs kernel-path prefill relative L2 error last logits "
        f"{free['last_logits']}, worst {free_worst} {free[free_worst]}; first block's "
        f"state {list(free.items())[1]}; warm prefill kernel path {row['warm_prefill_ms']} "
        f"ms (steady, median of 3 more: {row['steady_prefill_ms']} ms), plain path "
        f"{row['plain_prefill_ms']} ms")
    log(f"phase 9 lm-check: {cfg.arch_id} witness (recorded, no gate): plain path with one "
        f"bf16 ulp flipped in {witness['flip_frac']} of {witness['block']}'s output (relative "
        f"L2 {witness['first_block_rel_err']}; the kernel path's there "
        f"{witness['kernel_first_block_rel_err']}) vs the plain path, last logits relative "
        f"L2 {witness['last_logits_rel_err']} (kernel path vs plain path "
        f"{free['last_logits']})")
    if errs[worst] > TOL_BLOCK_REL or not torch.isfinite(last_k.float()).all():
        raise AssertionError(f"lm-check {cfg.arch_id}: {worst} relative error "
                             f"{errs[worst]} beyond {TOL_BLOCK_REL}")
    del last_k, st_k, last_p, st_p
    if profile:
        row["profile"] = profile_lm(torch, lm, params, cfg, prompts, max_len, kw)
        for what, prof in row["profile"].items():
            log(f"profile: {tag}: {cfg.arch_id} {what} wall {prof['wall_ms']} ms, device "
                f"busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
            for e in prof["top_device"]:
                log(f"profile: {cfg.arch_id} {what} device {e['device_ms']} ms "
                    f"x{e['count']} {e['name']}")
            for e in prof["top_host"]:
                log(f"profile: {cfg.arch_id} {what} host {e['self_cpu_ms']} ms "
                    f"x{e['count']} {e['name']}")
    return row


def lm_check_smoke(torch, lm, cfg, dev, from_numpy, to_numpy) -> dict:
    """Phase 9 at a smoke configuration (fp32): the same params on the card
    (kernel path) and on the CPU (plain path); the prefill's last logits and
    decode state (with random image embeddings or encoder frames where the
    configuration takes them), then 4 decode steps fed the same tokens, at
    1e-4. Returns the largest difference and the card's flash forward
    launches by route (recorded)."""
    from repro_torch.kernels.flash_attention import ops as fops

    before = dict(fops.flash_attention.routes)
    cpu_params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    params = from_numpy(to_numpy(cpu_params), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1),
                          generator=torch.Generator().manual_seed(2))
    cpu_kw = extra_inputs(torch, cfg, 2, "cpu", torch.Generator().manual_seed(3))
    kw = {n: t.to(dev) for n, t in cpu_kw.items()}
    n = 40 + (cfg.n_image_tokens or 0)
    errs = []

    def hold(a, b, what):
        errs.append(float((a.cpu() - b).abs().max()))
        if not torch.allclose(a.cpu(), b, atol=TOL_LOGITS, rtol=TOL_LOGITS):
            raise AssertionError(f"lm-check {cfg.arch_id} smoke fp32: {what}: card vs CPU "
                                 f"max abs diff {errs[-1]}")

    with torch.inference_mode():
        got, st = lm.lm_prefill(params, cfg, toks.to(dev), n + 4, **kw)
        want, st_c = lm.lm_prefill(cpu_params, cfg, toks, n + 4, **cpu_kw)
        hold(got, want, "prefill logits")
        leaves = list(zip(_state_leaves(st), _state_leaves(st_c)))
        for (name, a), (_, b) in leaves:
            hold(a, b, name)
        for i in range(4):
            o, st = lm.decode_step(params, cfg, st, steps[i].to(dev), n + i)
            o_c, st_c = lm.decode_step(cpu_params, cfg, st_c, steps[i], n + i)
            hold(o, o_c, f"decode step {i}")
    routes = {r: c - before[r] for r, c in fops.flash_attention.routes.items()}
    log(f"phase 9 lm-check: {cfg.arch_id} smoke fp32, kernel path on the card vs plain "
        f"path on the CPU: prefill logits, {len(leaves)} state leaves and 4 decode steps "
        f"max abs diff {max(errs)} (tol {TOL_LOGITS}); flash forward launches by route "
        f"{json.dumps(routes)}")
    return {"max_abs_diff": max(errs), "flash_fwd_routes": routes}


def spmm_training_shapes(torch, ops, ref, timer, fed, dev, gen, rng) -> tuple[list, dict, dict]:
    """Phase 3 at the training path's shapes, from client 0 of the train
    phase's partition: the loss pass's adjacency (all n_max rows over the
    n_tot = n_max + g_max columns of [own | ghost]) @ the 500 features and @
    the 256 of layer 1; a batch step's (256 sampled rows, neighbors kept by
    the fanout of 10) @ 500 and @ 256; and the backward's transposed launch,
    Aᵀ (n_tot x 256) @ dy (256 x 256), whose rows do not sum to 1. The
    backward is also held through autograd: ``block_spmm``'s against
    autograd of the plain version, at 1e-5, launching the kernel twice.
    Then the shapes of the methods that train on every local node (fedall,
    fedsage+, fedpns, fedgraph, fedlocal, fedais2: batch = n_max): the
    batch step's forward at all n_max rows (neighbours kept by the fanout
    of 10) @ 500 and @ 256, its transposed launch Aᵀ (n_tot x n_max) @ dy
    (n_max x 256), and the ``a.t().contiguous()`` copy ``_BlockSpmm``'s
    backward makes in front of that launch, timed against its bytes bound
    (read and written once). Returns the rows, the autograd check and the
    copy's record."""
    from repro_torch.core.importance import stable_rank

    n_tot = fed.n_max + fed.g_max
    idx = torch.tensor(fed.nbr_idx[0], device=dev)
    nm = torch.tensor(fed.nbr_mask[0], device=dev)
    table0 = torch.cat([torch.tensor(fed.features[0], device=dev),
                        torch.randn((fed.g_max, fed.n_features), generator=gen, device=dev)])
    table1 = torch.randn((n_tot, 256), generator=gen, device=dev)
    rows = []
    a = ops.adjacency_from_neighbors(idx, nm, n_tot)
    mk = ops.adjacency_block_mask(idx, nm, n_tot, ops.TILE_M, ops.TILE_K)
    rows.append(check_spmm(torch, ops, ref, timer, "train_loss_pass_f500", a, table0, mk, 5))
    rows.append(check_spmm(torch, ops, ref, timer, "train_loss_pass_h256", a, table1, mk, 5))
    del a, mk
    batch = torch.tensor(rng.choice(int(fed.client_sizes[0]), 256, replace=False), device=dev)
    b_idx, b_mask = idx[batch], nm[batch]
    ranks = torch.where(b_mask > 0, torch.rand(b_mask.shape, generator=gen, device=dev), 2.0)
    b_mask = b_mask * (stable_rank(ranks) < 10)
    a = ops.adjacency_from_neighbors(b_idx, b_mask, n_tot)
    mk = ops.adjacency_block_mask(b_idx, b_mask, n_tot, ops.TILE_M, ops.TILE_K)
    rows.append(check_spmm(torch, ops, ref, timer, "train_batch_f500", a, table0, mk, 20))
    rows.append(check_spmm(torch, ops, ref, timer, "train_batch_h256", a, table1, mk, 20))
    dy = torch.randn((a.shape[0], 256), generator=gen, device=dev)
    rows.append(check_spmm(torch, ops, ref, timer, "train_transposed_h256",
                           a.t().contiguous(), dy, mk.t().contiguous(), 20))
    x = table1.clone().requires_grad_(True)
    before = ops.block_spmm.launches
    ops.block_spmm(a, x, mk).backward(dy)
    torch.cuda.synchronize()
    launched = ops.block_spmm.launches - before
    xp = table1.clone().requires_grad_(True)
    ref.spmm_ref(a, xp).backward(dy)
    err = float((x.grad - xp.grad).abs().max())
    log(f"phase 3 kernels: spmm backward through autograd (train_batch_h256): dx = Aᵀ·dy by "
        f"the kernel ({launched} launches: forward + transposed) vs autograd of the plain "
        f"version, max abs err {err}")
    if launched != 2 or not torch.allclose(x.grad, xp.grad, atol=TOL_KERNEL, rtol=TOL_KERNEL):
        raise AssertionError(f"spmm backward: {launched} launches, max abs err {err}")
    backward = {"shape": "train_batch_h256", "launches": launched, "max_abs_err": err}
    del a, mk, x, xp
    # every local node a batch (their own generator, so the rows above draw
    # what they drew before)
    gen_all = torch.Generator(device=dev).manual_seed(3)
    ranks = torch.where(nm > 0, torch.rand(nm.shape, generator=gen_all, device=dev), 2.0)
    keep = nm * (stable_rank(ranks) < 10)
    a = ops.adjacency_from_neighbors(idx, keep, n_tot)
    mk = ops.adjacency_block_mask(idx, keep, n_tot, ops.TILE_M, ops.TILE_K)
    rows.append(check_spmm(torch, ops, ref, timer, "train_allrows_f500", a, table0, mk, 5))
    rows.append(check_spmm(torch, ops, ref, timer, "train_allrows_h256", a, table1, mk, 5))
    dy = torch.randn((a.shape[0], 256), generator=gen_all, device=dev)
    rows.append(check_spmm(torch, ops, ref, timer, "train_transposed_allrows_h256",
                           a.t().contiguous(), dy, mk.t().contiguous(), 5))
    nbytes = 2 * 4 * a.numel()
    copy = {"shape": "train_allrows", "n": a.shape[0], "m": a.shape[1], "bytes": nbytes,
            "ms": timer(lambda: a.t().contiguous(), 5),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"phase 3 kernels: the backward's a.t().contiguous() at train_allrows "
        f"({a.shape[0]} x {a.shape[1]} fp32, {nbytes} bytes read + written): {copy['ms']} ms, "
        f"bound {copy['bound_ms']} ms (recorded)")
    return rows, backward, copy


def poisoned_fallbacks(torch, g, idx, mask, params, dev, ids, GraphStore, ServedModel,
                       QueryEngine) -> dict:
    """Phase 6: one NaN feature row (a neighbor of the first query, not row
    0, which padding slots name), fresh queries in chunks of 8 with the
    fallback on: ``n_fallbacks`` under gather, segment and spmm on the
    card, and spmm on the CPU. Each backend lets the NaN reach only the
    rows that name it, so all four count the same chunks, some but not
    all of them."""
    nbrs = idx[ids[0]][mask[ids[0]] > 0]
    bad = int(nbrs[nbrs != 0][0])
    feats = g.features.copy()
    feats[bad] = float("nan")
    cases = [(be, dev) for be in ("gather", "segment", "spmm")] + [("spmm", "cpu")]
    counts = {}
    for be, d in cases:
        model = ServedModel({k: v.to(d) for k, v in params.items()},
                            GraphStore(feats, idx, mask), backend=be, warm="cold", device=d)
        engine = QueryEngine(model, buckets=(8,), fallback=True)
        for i in range(0, len(ids), 8):
            engine.query(ids[i: i + 8], policy="fresh")
        counts[f"{be}_{torch.device(d).type}"] = engine.n_fallbacks
    n_chunks = -(-len(ids) // 8)
    log(f"phase 6 check: feature row {bad} poisoned, {n_chunks} fresh chunks of 8: "
        f"fallbacks {json.dumps(counts)}")
    if len(set(counts.values())) != 1 or not 0 < counts[f"spmm_{dev.type}"] < n_chunks:
        raise AssertionError(f"check: fallbacks differ by backend or reach no/every chunk: "
                             f"{counts}")
    return {"row": bad, "chunks": n_chunks, "fallbacks": counts}


class RoundTimer:
    """A round callback: the host clock at the end of each round, after a
    synchronise (the round's work is done). It observes nothing of a
    round's state, so the fused executor may take it: there its stamps come
    from the host tail, which replays a chunk's rounds after the chunk ran
    (per round when a chunk is one round, as with an eval every round)."""

    fused_safe = True

    def __init__(self, torch):
        self.torch = torch
        self.stamps = []

    def on_run_start(self, engine, state):
        self.torch.cuda.synchronize()
        self.stamps = [time.perf_counter()]

    def on_round_end(self, ctx):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def on_run_end(self, engine, state):
        pass


def train_tables(state) -> list:
    """The params and every table of a run's state, in a fixed order."""
    return [*(state.params[k] for k in sorted(state.params)), state.hist.hist1,
            state.hist.age, state.hist.ghost_feat, state.prev_loss]


def train_first_update(torch, fedais, ops, ref, eng, state, k, dev) -> dict:
    """The first LocalUpdate of client ``k`` (round 0's first) under ``spmm``
    against ``gather`` on the card, from the same round-start tables and
    the same draws (a ``TorchDraws`` seeded alike): the sampled batches,
    fanout ranks, ghost ``need`` masks, ``n_sync`` and ``n_ghost_pulled``
    exact; ``loss_all`` and the first step's grads at 1e-4. The first
    backward's A and dy (a real step's) are kept to hold the transposed
    launch on them."""
    client = {n: v[k] for n, v in state.arrays.items()}
    names = ("sample_batch", "stable_rank", "ghost_need", "adamw_update")
    out, logs = {}, {}
    real = {n: getattr(fedais, n) for n in names}
    real_bwd = ops._BlockSpmm.backward
    seen = []

    def bwd(ctx, dy):
        if not seen:
            seen.append((ctx.saved_tensors[0].detach().clone(), dy.detach().clone()))
        return real_bwd(ctx, dy)

    for be in ("spmm", "gather"):
        log_be = logs[be] = {n: [] for n in names}
        for n in names:
            def wrapped(*a, _r=real[n], _n=n, _l=log_be, **kw):
                o = _r(*a, **kw)
                _l[_n].append((a, o))
                return o
            setattr(fedais, n, wrapped)
        ops._BlockSpmm.backward = staticmethod(bwd)
        try:
            one = fedais.make_local_update(eng.mcfg, eng.fed.n_max, train_backend=be)
            out[be] = one(state.params, client, state.arrays["features"],
                          state.hist.hist1, state.hist.hist1[k], state.hist.age[k],
                          state.hist.ghost_feat[k], state.prev_loss[k], state.tau,
                          eng.mcfg.neighbor_fanout, 0,
                          fedais.TorchDraws(eng.seed, dev))
            torch.cuda.synchronize()
        finally:
            for n in names:
                setattr(fedais, n, real[n])
            ops._BlockSpmm.backward = real_bwd
    s, gth = logs["spmm"], logs["gather"]
    exact = {}
    for n in ("sample_batch", "stable_rank", "ghost_need"):
        exact[n] = len(s[n]) == len(gth[n]) and all(
            all(torch.equal(x, y) for x, y in zip(
                o1 if isinstance(o1, tuple) else (o1,), o2 if isinstance(o2, tuple) else (o2,)))
            for (_, o1), (_, o2) in zip(s[n], gth[n]))
    st_s, st_g = out["spmm"][4], out["gather"][4]
    exact["n_sync"] = st_s["n_sync"] == st_g["n_sync"]
    exact["n_ghost_pulled"] = float(st_s["n_ghost_pulled"]) == float(st_g["n_ghost_pulled"])
    loss_err = float((st_s["loss_all"] - st_g["loss_all"]).abs().max())
    grads_s, grads_g = s["adamw_update"][0][0][0], gth["adamw_update"][0][0][0]
    grad_err = max(float((grads_s[n] - grads_g[n]).abs().max()) for n in grads_s)
    close = (torch.allclose(st_s["loss_all"], st_g["loss_all"], atol=TOL_LOGITS,
                            rtol=TOL_LOGITS)
             and all(torch.allclose(grads_s[n], grads_g[n], atol=TOL_LOGITS, rtol=TOL_LOGITS)
                     for n in grads_s))
    a, dy = seen[0]
    want = ref.spmm_ref(a.t(), dy)
    got = ops.block_spmm(a.t().contiguous(), dy)
    real_dy_err = float((got - want).abs().max())
    log(f"phase 10 train: first LocalUpdate of client {k}, spmm vs gather on the card, same "
        f"draws: exact {json.dumps(exact)}; loss_all max abs diff {loss_err}, first step's "
        f"grads {grad_err} (gate 1e-4); the transposed launch on that step's real dy "
        f"({tuple(dy.shape)}, max |dy| {float(dy.abs().max())}) vs the plain version, max abs "
        f"err {real_dy_err} (recorded)")
    if not all(exact.values()) or not close:
        raise AssertionError(f"train: spmm vs gather first LocalUpdate: exact {exact}, loss "
                             f"{loss_err}, grads {grad_err}")
    return {"client": k, "exact": exact, "loss_all_err": loss_err, "grad_err": grad_err,
            "real_dy_max_abs_err": real_dy_err}


def profile_traffic(torch, engine, load_cls, top: int = 8) -> dict:
    """A second closed-loop run (seed 1) under ``torch.profiler``."""
    gen = load_cls(engine, seed=1, n_queries=200, n_updates=20, mode="closed",
                   concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
    return _trace(torch, gen.run, top)[1]


class RecordingSelector:
    """The default selector, keeping the cohorts it drew."""

    def __init__(self, base):
        self.base, self.cohorts = base, []
        self.precomputable = getattr(base, "precomputable", False)

    def select(self, engine, state):
        sel = self.base.select(engine, state)
        self.cohorts.append([int(c) for c in sel])
        return sel


def train_phase(torch, api, fedais, ops, ref, counters, g, fed, dev, tag,
                profile) -> tuple[dict, int]:
    """Phase 10: ``FedEngine(g, fed, "fedais", ...).run()`` on the card with
    ``train_backend = eval_backend = "spmm"``, twice from the same seed.
    Gates: the SpMM launched exactly rounds x (m·(2 + 3J) + 2) times (a
    loss pass and J steps of 2 forward + 1 transposed launch per client,
    the eval's 2 layers per round), the ghost pull once a gated sync epoch
    (``sync_epochs``, more than 0), nothing else, counted through the CUDA
    graph replays of the fused executor both runs take;
    finite history; the two runs draw the same cohorts, write the same
    tables and give the same tau and test_acc bits; the first LocalUpdate
    under spmm against gather (``train_first_update``). Recorded: ms per
    round (the first, then the steady rounds), peak memory, test_acc per
    round; under ``profile`` a traced steady round replayed from its
    graph."""
    r1, r2 = (method_run(torch, api, counters, g, fed, dev, "fedais", TRAIN_ROUNDS)
              for _ in range(2))
    eng, res = r1["engine"], r1["result"]
    J = eng.mcfg.local_epochs
    want = {n: 0 for n in counters}
    want["spmm"] = TRAIN_ROUNDS * (TRAIN_M * (2 + 3 * J) + 2)
    want["ghost_pull"] = r1["sync_epochs"]
    hist = res.history
    steady = sorted(r1["round_ms"][1:] + r2["round_ms"][1:])
    log(f"phase 10 train: {tag}: fedais on pubmed ({fed.n_clients} clients, {TRAIN_M} a "
        f"round, J {J}, batch {eng.bsz}, fanout {eng.mcfg.neighbor_fanout}, GraphSAGE "
        f"{eng.H1}/128, spmm) {TRAIN_ROUNDS} rounds: ms per round {r1['round_ms']} (second "
        f"run {r2['round_ms']}); first {r1['round_ms'][0]}, steady median "
        f"{steady[len(steady) // 2]}; peak memory {r1['peak_gb']} GB; launches "
        f"{json.dumps(r1['launches'])} (want {json.dumps(want)}); cohorts {r1['cohorts']}; "
        f"tau {hist['tau']}; test_acc {hist['test_acc']}; test_loss {hist['test_loss']}")
    if (r1["launches"] != want or r2["launches"] != want or not want["ghost_pull"] > 0
            or r2["sync_epochs"] != want["ghost_pull"]):
        raise AssertionError(f"train: launches {r1['launches']} / {r2['launches']}, want {want} "
                             f"/ ghost pulls {r2['sync_epochs']}")
    if (len(hist["test_acc"]) != TRAIN_ROUNDS or not all(0.0 <= a <= 1.0 for a in hist["test_acc"])
            or not all(math.isfinite(x) for x in hist["test_loss"])):
        raise AssertionError(f"train: history {hist}")
    # a replayed round's batches never reach the host: the tables they
    # wrote (age restarts at 0 on every row a batch pushed) stand witness
    same = {"executor": r1["executor"] == r2["executor"] == "fused",
            "cohorts": r1["cohorts"] == r2["cohorts"],
            "tables": all(torch.equal(a, b) for a, b in zip(train_tables(r1["state"]),
                                                            train_tables(r2["state"]))),
            "tau": hist["tau"] == r2["result"].history["tau"],
            "test_acc": hist["test_acc"] == r2["result"].history["test_acc"]}
    log(f"phase 10 train: a second seeded run: the same {json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"train: two seeded runs differ: {same}")
    first = train_first_update(torch, fedais, ops, ref, eng, eng.init_state(),
                               r1["cohorts"][0][0], dev)
    rec = {"rounds": TRAIN_ROUNDS, "clients_per_round": TRAIN_M, "local_epochs": J,
           "batch": eng.bsz, "round_ms": [r1["round_ms"], r2["round_ms"]],
           "first_round_ms": r1["round_ms"][0], "steady_round_ms": steady[len(steady) // 2],
           "peak_gb": r1["peak_gb"], "launches": r1["launches"], "history": hist,
           "final": res.final, "cohorts": r1["cohorts"], "first_update": first}
    del r2
    if profile:
        rec["profile"] = profile_round(torch, api, g, fed, dev, tag, fused=True)
    return rec, r1["launches"]["spmm"]


def profile_round(torch, api, g, fed, dev, tag, *, fused: bool) -> dict:
    """One steady ``fedais`` round of phase 10's configuration (its eval
    included) under ``torch.profiler``: round 1 after round 0, replayed
    from its CUDA graph (``fused``) or stepwise. Logs the wall time, the
    device's busy share, the host's kernel and graph launches and the
    SpMM's kernels on the device."""
    peng = api.FedEngine(g, fed, "fedais", rounds=2, clients_per_round=TRAIN_M, seed=0,
                         train_backend="spmm", eval_backend="spmm", device=dev)
    pstate = peng.init_state()
    if fused:
        peng._run_chunk(pstate, 0, 1)
        _, prof = _trace(torch, lambda: peng._run_chunk(pstate, 1, 1), 10)
    else:
        peng.run_round(pstate, 0)
        _, prof = _trace(torch, lambda: peng.run_round(pstate, 1), 10)
    what = f"train round 1 ({peng.last_executor})"
    log(f"profile: {tag}: {what} wall {prof['wall_ms']} ms, device busy "
        f"{prof['device_busy_ms']} ms (share {prof['device_busy_share']}); host API calls "
        f"{json.dumps(prof['api_calls'])}; SpMM kernels on the device {prof['spmm_kernels']}")
    for e in prof["top_device"]:
        log(f"profile: {peng.last_executor} device {e['device_ms']} ms x{e['count']} "
            f"{e['name']}")
    for e in prof["top_host"]:
        log(f"profile: {peng.last_executor} host {e['self_cpu_ms']} ms x{e['count']} "
            f"{e['name']}")
    if fused and (prof["api_calls"].get("cudaGraphLaunch", 0) < 1
                  or prof["spmm_kernels"]["count"] < 1):
        raise AssertionError(f"profile: the replayed round shows no graph launch or no "
                             f"SpMM kernel: {prof['api_calls']}, {prof['spmm_kernels']}")
    prof["executor"] = peng.last_executor
    del peng, pstate
    gc.collect()
    torch.cuda.empty_cache()
    return prof


@contextlib.contextmanager
def sync_epochs():
    """While entered, counts (in the yielded list's one item) the gated sync
    epochs (Algorithm 1, lines 15-17) of every client an engine trains on
    the path that pulls with the ghost pull kernel, the fp32 pull from the
    tables: the ghost pull's launches a run should count. Read from the
    ``n_sync`` each executor returns for its cohort: ``FedEngine.dispatch``
    (stepwise, async), ``FusedRounds`` (fused, fused_faulty) and the
    client-sharded ``ShardedRounds``. The quantised wire and the
    pod-sharded executor's prefetched rows gather, mask and select as
    separate ops, so their epochs count none. A dropped client trains
    (and pulls) but bills no sync, so the cost meter's ``sync_events``
    leaves it out; ``n_sync`` does not."""
    import numpy as np

    from repro_torch.api import FedEngine
    from repro_torch.api.fused import FusedRounds, ShardedRounds

    got = [0]
    real = (FedEngine.dispatch, FusedRounds.run_chunk, ShardedRounds.run_chunk)

    def dispatch(eng, *a, **k):
        out = real[0](eng, *a, **k)
        if eng.sync_dtype == "fp32":
            got[0] += int(np.sum(out[-1]["n_sync"]))
        return out

    def fused_chunk(rounds, *a, **k):
        out = real[1](rounds, *a, **k)
        if rounds.engine.sync_dtype == "fp32":
            got[0] += int(out["n_sync"].sum())
        return out

    def sharded_chunk(rounds, *a, **k):
        out = real[2](rounds, *a, **k)
        if rounds.engine.sync_dtype == "fp32" and not rounds.pods:
            got[0] += int(out["n_sync"].sum())
        return out

    FedEngine.dispatch, FusedRounds.run_chunk = dispatch, fused_chunk
    ShardedRounds.run_chunk = sharded_chunk
    try:
        yield got
    finally:
        FedEngine.dispatch, FusedRounds.run_chunk, ShardedRounds.run_chunk = real


def method_run(torch, api, counters, g, fed, dev, method, rounds, eval_every=1,
               **kw) -> dict:
    """One seeded ``FedEngine(g, fed, method, ...).run()`` on the card with
    the ``spmm`` backends, every launch counter set to 0 just before and
    read just after; keeps the cohorts, the size of every dispatch, the
    fanouts the strategy chose, the gated sync epochs on the ghost pull
    kernel's path (``sync_epochs``), ms per round (or merge) and peak
    memory (the runs before it collected first, so it is this run's
    alone)."""
    with sync_epochs() as epochs:
        run = _method_run(torch, api, counters, g, fed, dev, method, rounds, eval_every, **kw)
    run["sync_epochs"] = epochs[0]
    return run


def _method_run(torch, api, counters, g, fed, dev, method, rounds, eval_every,
                **kw) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    timer = RoundTimer(torch)
    sel = RecordingSelector(api.UniformSelector())
    eng = api.FedEngine(g, fed, method, rounds=rounds, clients_per_round=TRAIN_M, seed=0,
                        selector=sel, callbacks=[api.EvalCallback(eval_every),
                                                 api.HistoryCallback(), timer],
                        train_backend="spmm", eval_backend="spmm", device=dev, **kw)
    dispatched, fanouts, chunks = [], [], []
    real_dispatch, real_fanouts = eng.dispatch, eng.strategy.choose_fanouts
    real_chunk = eng._run_chunk

    def run_chunk(state, t0, n):
        # a fused chunk: its host clock (after a synchronise), the device
        # memory still allocated after it, the graph keys captured so far
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        stop = real_chunk(state, t0, n)
        torch.cuda.synchronize()
        chunks.append({"rounds": [t0, n], "ms": (time.perf_counter() - c0) * 1e3,
                       "allocated": torch.cuda.memory_allocated(),
                       "graphs": len(_captures(eng))})
        return stop

    def dispatch(state, s, t):
        dispatched.append(len(s))
        return real_dispatch(state, s, t)

    def choose_fanouts(engine, s):
        out = real_fanouts(engine, s)
        fanouts.append([int(f) for f in out])
        return out

    eng.dispatch, eng.strategy.choose_fanouts = dispatch, choose_fanouts
    eng._run_chunk = run_chunk
    state = eng.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = eng.run(state)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    ms = [(b - a) * 1e3 for a, b in zip(timer.stamps, timer.stamps[1:])]
    if eng.last_executor in ("fused", "fused_faulty", "sharded_fused", "pod_sharded"):
        # the fused executors train every cohort they select; they never
        # call dispatch
        dispatched = [len(c) for c in sel.cohorts]
    return {"engine": eng, "state": state, "result": res, "launches": launches,
            "round_ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cohorts": sel.cohorts, "dispatched": dispatched, "fanouts": fanouts,
            "executor": eng.last_executor, "chunks": chunks, "captures": _captures(eng)}


def _captures(eng) -> list:
    """The graph keys every fused executor of ``eng`` captured."""
    rounds = ([] if eng._fused is None else [eng._fused]) + list(eng._sharded.values())
    return [c for r in rounds for c in r.captures]


def _method_gate(counters, run, name, merges) -> dict:
    """The launch gate of one phase-11 run: the SpMM exactly (clients
    dispatched) x (2 + 3J) + 2 x (merges) times (a loss pass and J steps of
    2 forward + 1 transposed launch per client, the eval's 2 layers per
    merge), the ghost pull once a gated sync epoch on its path
    (``sync_epochs``), nothing else; a finite history of ``merges`` rows
    with test_acc in [0, 1]."""
    J = run["engine"].mcfg.local_epochs
    want = {n: 0 for n in counters}
    want["spmm"] = sum(run["dispatched"]) * (2 + 3 * J) + 2 * merges
    want["ghost_pull"] = run["sync_epochs"]
    hist = run["result"].history
    if run["launches"] != want:
        raise AssertionError(f"methods: {name}: launches {run['launches']}, want {want}")
    if (len(hist["test_acc"]) != merges or not all(0.0 <= a <= 1.0 for a in hist["test_acc"])
            or not all(math.isfinite(x) for x in hist["test_loss"])):
        raise AssertionError(f"methods: {name}: history {hist}")
    return want


def _method_record(run) -> dict:
    hist = run["result"].history
    return {"round_ms": run["round_ms"], "peak_gb": run["peak_gb"],
            "launches": run["launches"], "cohorts": run["cohorts"],
            **{k: list(hist[k]) for k in ("test_acc", "test_loss", "tau", "comm_total",
                                          "comm_embed")},
            "final": dict(run["result"].final)}


def methods_phase(torch, api, counters, g, fed, dev, tag, profile) -> tuple[dict, int, dict]:
    """Phase 11: the paper's method space on the card, on phase 10's
    partition, with the spmm backends; every launch counter set to 0 just
    before each run and read just after it.

    * each of the nine registered methods for ``METHOD_ROUNDS`` rounds: the
      launch gate (``_method_gate``) and, per method, what defines it:
      fedsage+ syncs nothing (no sync events, no embedding bytes) and its
      generator's bytes ride the model link; fedlocal pulls no ghost;
      fedpns keeps tau 2; fedgraph draws every fanout from the bandit's
      actions, and its counts add up to m x rounds;
    * ``fedais`` under ``AsyncScheduler()`` (full quorum) for
      ``ASYNC_ROUNDS`` rounds: the history bit-identical to the sync run of
      the same seed, ``virtual_time`` equal to ``wall_clock``, staleness 0;
    * a heterogeneous async run (quorum 3 of 5 in flight, the largest
      client ``HET_SLOW`` x slower) for ``HET_MERGES`` merges: some merge
      stale, the launch gate over the clients dispatched, no fault counted;
    * ``fedais`` with the bf16 and int8 sync wire: the cohorts and tau of
      the fp32 run of the same seed, a finite history.

    Recorded: ms per round, peak memory, test_acc per round; under
    ``profile`` a traced steady round of fedall and of fedsage+ (stepwise).
    The fusable methods take the fused executor; each method's history and
    final row are returned for phase 12 to hold against its stepwise run."""
    import numpy as np

    from repro_torch.federated.baselines import FANOUT_ACTIONS, generator_param_count
    from repro_torch.federated.costs import model_bytes

    rec: dict = {"methods": {}}
    runs: dict = {}
    total = collections.Counter()
    for method in api.available_methods():
        run = method_run(torch, api, counters, g, fed, dev, method, METHOD_ROUNDS)
        want = _method_gate(counters, run, method, METHOD_ROUNDS)
        eng, res = run["engine"], run["result"]
        hist, final = res.history, res.final
        if sum(run["dispatched"]) != METHOD_ROUNDS * TRAIN_M:
            raise AssertionError(f"methods: {method}: dispatched {run['dispatched']}")
        checks = {}
        if method == "fedsage+":
            per_client = 2 * model_bytes(eng.n_params) + 2 * model_bytes(
                generator_param_count(eng.F))
            checks = {"sync_events": final["sync_events"] == 0,
                      "comm_embed": hist["comm_embed"] == [0.0] * METHOD_ROUNDS,
                      "comm_model": final["comm_model_bytes"]
                      == METHOD_ROUNDS * TRAIN_M * per_client}
        elif method == "fedlocal":
            checks = {"comm_embed": hist["comm_embed"] == [0.0] * METHOD_ROUNDS}
        elif method == "fedpns":
            checks = {"tau": hist["tau"] == [2] * METHOD_ROUNDS}
        elif method == "fedgraph":
            checks = {"fanouts": all(f in FANOUT_ACTIONS for row in run["fanouts"] for f in row),
                      "bandit_counts": int(eng.strategy.bandit.n.sum())
                      == TRAIN_M * METHOD_ROUNDS}
        steady = run["round_ms"][1:] or run["round_ms"]
        # copies: the traced round below appends to this run's history
        runs[method] = argparse.Namespace(history=copy.deepcopy(hist), final=dict(final),
                                          executor=run["executor"])
        log(f"phase 11 methods: {tag}: {method} {METHOD_ROUNDS} rounds ({run['executor']}): "
            f"ms per round {run['round_ms']} (steady {min(steady)}); peak memory "
            f"{run['peak_gb']} GB; "
            f"launches {json.dumps(run['launches'])} (want {json.dumps(want)}); tau "
            f"{hist['tau']}; test_acc {hist['test_acc']}; comm_embed {hist['comm_embed']}; "
            f"checks {json.dumps(checks)}"
            + (f"; fanouts {run['fanouts']}" if method == "fedgraph" else ""))
        if not all(checks.values()):
            raise AssertionError(f"methods: {method}: {checks}")
        rec["methods"][method] = dict(_method_record(run), checks=checks,
                                      executor=run["executor"])
        total.update(run["launches"])
        if profile and method in ("fedall", "fedsage+"):
            _, prof = _trace(torch, lambda: eng.run_round(run["state"], METHOD_ROUNDS), 10)
            rec["methods"][method]["profile"] = prof
            log(f"profile: {tag}: {method} round {METHOD_ROUNDS} wall {prof['wall_ms']} ms, "
                f"device busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
            for e in prof["top_device"]:
                log(f"profile: {method} device {e['device_ms']} ms x{e['count']} {e['name']}")
            for e in prof["top_host"]:
                log(f"profile: {method} host {e['self_cpu_ms']} ms x{e['count']} {e['name']}")
        del run, eng, res

    # full-quorum async against the sync run of the same seed
    sync = method_run(torch, api, counters, g, fed, dev, "fedais", ASYNC_ROUNDS)
    _method_gate(counters, sync, "fedais sync", ASYNC_ROUNDS)
    sync_ms, sync_launches, sh = sync["round_ms"], sync["launches"], sync["result"].history
    del sync
    asy = method_run(torch, api, counters, g, fed, dev, "fedais", ASYNC_ROUNDS,
                     scheduler=api.AsyncScheduler())
    _method_gate(counters, asy, "fedais async", ASYNC_ROUNDS)
    ah = asy["result"].history
    same = {k: sh[k] == ah[k] for k in ASYNC_PARITY_KEYS}
    same["virtual_time"] = ah["virtual_time"] == sh["wall_clock"]
    same["staleness"] = ah["staleness_max"] == [0] * ASYNC_ROUNDS
    log(f"phase 11 methods: {tag}: fedais async full quorum vs sync, {ASYNC_ROUNDS} rounds: "
        f"the same {json.dumps(same)}; ms per merge {asy['round_ms']} (sync {sync_ms}); peak "
        f"memory {asy['peak_gb']} GB")
    if not all(same.values()):
        raise AssertionError(f"methods: async full quorum differs from sync: {same}")
    rec["async_full_quorum"] = dict(_method_record(asy), same=same, sync_round_ms=sync_ms)
    total.update(sync_launches)
    total.update(asy["launches"])
    del asy

    # heterogeneous async: one client HET_SLOW x slower
    factors = np.ones(fed.n_clients)
    slow = int(np.argmax(fed.client_sizes))
    factors[slow] = HET_SLOW
    het = method_run(torch, api, counters, g, fed, dev, "fedais", HET_MERGES,
                     scheduler=api.AsyncScheduler(quorum=3, concurrency=TRAIN_M,
                                                  speed_factors=factors))
    want = _method_gate(counters, het, "fedais async heterogeneous", HET_MERGES)
    hh, events = het["result"].history, het["state"].fault_events
    log(f"phase 11 methods: {tag}: fedais async quorum 3 of {TRAIN_M}, client {slow} "
        f"{HET_SLOW}x slower, {HET_MERGES} merges: dispatched {het['dispatched']}, staleness "
        f"max {hh['staleness_max']}, merged {hh['merged']}, virtual_time {hh['virtual_time']}; "
        f"launches {json.dumps(het['launches'])} (want {json.dumps(want)}); fault events "
        f"{json.dumps(events.snapshot())}; ms per merge {het['round_ms']}; peak memory "
        f"{het['peak_gb']} GB")
    if max(hh["staleness_max"]) < 1 or events.any():
        raise AssertionError(f"methods: heterogeneous async: staleness {hh['staleness_max']}, "
                             f"faults {events.snapshot()}")
    rec["async_heterogeneous"] = dict(_method_record(het), dispatched=het["dispatched"],
                                      staleness_max=hh["staleness_max"], merged=hh["merged"],
                                      slow_client=slow, fault_events=events.snapshot())
    total.update(het["launches"])
    del het
    # the quantized sync wire against the fp32 run of the same seed
    base = rec["methods"]["fedais"]
    for dtype in ("bf16", "int8"):
        q = method_run(torch, api, counters, g, fed, dev, "fedais", METHOD_ROUNDS,
                       sync_dtype=dtype)
        _method_gate(counters, q, f"fedais {dtype}", METHOD_ROUNDS)
        qh = q["result"].history
        same = {"cohorts": q["cohorts"] == base["cohorts"], "tau": qh["tau"] == base["tau"]}
        log(f"phase 11 methods: {tag}: fedais sync_dtype {dtype}, {METHOD_ROUNDS} rounds: "
            f"the fp32 run's {json.dumps(same)}; test_acc {qh['test_acc']} (fp32 "
            f"{base['test_acc']}); comm_embed {qh['comm_embed']}; peak memory {q['peak_gb']} "
            f"GB; ms per round {q['round_ms']}")
        if not all(same.values()):
            raise AssertionError(f"methods: sync_dtype {dtype}: {same}")
        rec[f"sync_{dtype}"] = dict(_method_record(q), same_as_fp32=same)
        total.update(q["launches"])
        del q
    rec["spmm_launches"] = total["spmm"]
    rec["ghost_pull_launches"] = total["ghost_pull"]
    return rec, total["spmm"], runs


def _same_history(a, b) -> dict:
    """Which history columns (and the final row) two runs share, bit for bit."""
    same = {k: a.history.get(k) == b.history.get(k) for k in sorted(set(a.history)
                                                                     | set(b.history))}
    same["final"] = a.final == b.final
    return same


def round_phases(m: int, gates) -> list:
    """The device phases of one fused fedais round of ``m`` members, in the
    order its body opens them (``FusedRounds._body``, ``local_update``)."""
    member = ["loss_pass"]
    for gate in gates:
        member += ["sampling"] + ["ghost_pull"] * bool(gate) + ["train_step", "optimizer",
                                                             "table_traffic"]
    return ["table_traffic"] + member * m + ["table_traffic", "merge", "table_traffic",
                                             "merge"]


def spans_phase(torch, api, g, fed, dev, tag) -> dict:
    """Phase 19: the span system's device phases on the card (module
    docstring). Returns the record; any failed gate raises."""
    from repro_torch.api.fused import FusedRounds
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.stamp import ops as stamp_ops
    from repro_torch.utils import spans

    counters = {"spmm": sops.block_spmm, "stamp": stamp_ops}
    spans.enable(False)
    off = method_run(torch, api, counters, g, fed, dev, "fedais", SPANS_ROUNDS,
                     eval_every=SPANS_EVAL_EVERY)
    off_tables = [t.clone() for t in train_tables(off["state"])]
    off_res = off["result"]
    del off
    keyed, stamp, read = FusedRounds._keyed, spans.Marks.stamp, spans.read_phases
    new_marks, kept_marks = spans.new_marks, spans.kept_marks
    beside: dict = {}     # id(marks) -> (marks, its events, the stamps after them)
    held: list = []

    def made_with_events(make):
        # the second stamps' buffer made with the marks, outside any capture
        def made(*a, **k):
            marks = make(*a, **k)
            if marks is not None and id(marks) not in beside:
                beside[id(marks)] = (marks, [], torch.zeros(marks.slots, dtype=torch.int64,
                                                            device=dev))
            return marks
        return made

    def keyed_behind_wait(self, key, body):
        marks = self._marks.get(key)
        if marks is not None:
            marks.buf.zero_()            # the replay writes every slot again
        torch.cuda._sleep(SPANS_WAIT_CYCLES)
        return keyed(self, key, body)

    def stamp_and_event(self, slot):
        stamp(self, slot)
        _, ev, after = beside[id(self)]
        if slot == len(ev):
            ev.append(torch.cuda.Event(enable_timing=True, external=True))
        ev[slot].record()
        stamp_ops.stamp(after, slot)

    def read_and_hold(marks, times=1):
        if marks is not None and marks.n:
            _, ev, after = beside[id(marks)]
            t, a = marks.times(), after[:marks.n].tolist()
            gap = [(y - x) / 1e6 for x, y in zip(t, a)]
            stamp_ms = [(y - x) / 1e6 for x, y in zip(t, t[1:])]
            event_ms = [x.elapsed_time(y) for x, y in zip(ev[:marks.n], ev[1:marks.n])]
            held.append({"marks": id(marks), "names": list(marks.names), "n": marks.n,
                         "ordered": t[0] > 0 and all(x <= y for x, y in zip(t, t[1:]))
                         and all(g >= 0 for g in gap),
                         "gap_ms": gap, "stamp_ms": stamp_ms, "event_ms": event_ms,
                         "over_ms": max(abs(x - y) - gap[i] - gap[i + 1] - SPANS_TOL_MS
                                        for i, (x, y) in enumerate(zip(stamp_ms, event_ms)))})
        return read(marks, times)

    # the stamp kernel built before the run, so no build stalls an eager round
    stamp(spans.Marks(dev, 1), 0)
    torch.cuda.synchronize()
    FusedRounds._keyed, spans.Marks.stamp = keyed_behind_wait, stamp_and_event
    spans.new_marks, spans.kept_marks = made_with_events(new_marks), made_with_events(kept_marks)
    spans.read_phases = read_and_hold
    spans.reset()
    spans.enable()
    try:
        on = method_run(torch, api, counters, g, fed, dev, "fedais", SPANS_ROUNDS,
                        eval_every=SPANS_EVAL_EVERY)
    finally:
        spans.enable(False)
        FusedRounds._keyed, spans.Marks.stamp, spans.read_phases = keyed, stamp, read
        spans.new_marks, spans.kept_marks = new_marks, kept_marks
    totals = spans.totals()
    spans.reset()
    eng = on["engine"]
    same = _same_history(off_res, on["result"])
    same["tables"] = all(torch.equal(a, b) for a, b in zip(off_tables,
                                                           train_tables(on["state"])))
    keys = eng._fused._marks
    structure = {str(k): m.names == round_phases(k[0], k[2]) and m.n == len(m.names) + 1
                 for k, m in keys.items()}
    graphs = {id(m) for m in keys.values()}
    n_evals = sum(1 for h in held if h["names"] == ["eval"])
    gaps = sorted(g for h in held for g in h["gap_ms"])
    over = max((h["over_ms"] for h in held), default=math.inf)
    # a stamp and the stamp after its event at every boundary
    want_stamps = 2 * (sum(2 * m.n for m in keys.values()) + 2 * n_evals)
    c = totals["counters"]
    rec = {"same": same, "keys": len(keys), "structure": structure,
           "boundaries_a_key": {str(k): m.n for k, m in keys.items()},
           "reads": len(held), "evals": n_evals, "replays": c.get("replays", 0),
           "eager_rounds": c.get("eager_rounds", 0),
           "ordered": all(h["ordered"] for h in held),
           "over_ms": over, "over_ms_by_read": [h["over_ms"] for h in held],
           "replayed_by_read": [h["marks"] in graphs for h in held],
           "worst_ms_by_read": [max(abs(x - y) for x, y in zip(h["stamp_ms"], h["event_ms"]))
                                for h in held],
           "gap_ms_median_max": [gaps[len(gaps) // 2], gaps[-1]] if gaps else None,
           "tol_ms": SPANS_TOL_MS,
           "sum_stamp_ms": [sum(h["stamp_ms"]) for h in held],
           "sum_event_ms": [sum(h["event_ms"]) for h in held],
           "stamp_launches": on["launches"]["stamp"], "want_stamp_launches": want_stamps,
           "phases_ms": {k: v["ms"] for k, v in totals["phases"].items()},
           "phase_counts": {k: v["count"] for k, v in totals["phases"].items()}}
    log(f"phase 19 spans: {tag}: fedais {SPANS_ROUNDS} rounds, eval every "
        f"{SPANS_EVAL_EVERY}: {json.dumps(rec)}")
    if not all(same.values()):
        raise AssertionError(f"spans: the run with the spans on differs: {same}")
    if not keys or not all(structure.values()) or not rec["replays"]:
        raise AssertionError(f"spans: keys {structure}, replays {rec['replays']}")
    if not rec["ordered"] or not over <= 0:
        raise AssertionError(f"spans: stamps in order {rec['ordered']}; a phase {over} ms "
                             f"further from its event pair than its ends' gaps and "
                             f"{SPANS_TOL_MS} ms")
    if rec["stamp_launches"] != want_stamps:
        raise AssertionError(f"spans: {rec['stamp_launches']} stamp launches, want "
                             f"{want_stamps}")
    return rec


def ghost_pull_inputs(torch, K, n_max, g_max, F, H, dev, gen, need_kind="drawn",
                      offsets=(0, 0, 0, 0)):
    """One client's ghost pull arguments on the card: sources, slots (a third
    masked, owner -1 and row 0) and tables. ``offsets`` puts feats_all,
    hist1_all, ghost_feat and hist1 that many elements into a buffer of
    their own, off its 16-byte aligned start."""
    def at(shape, off):
        n = math.prod(shape)
        return torch.randn(n + off, generator=gen, device=dev)[off:].view(shape)

    feats_all = at((K, n_max, F), offsets[0])
    hist1_all = at((K, n_max + g_max, H), offsets[1])
    owner = torch.randint(0, K, (g_max,), generator=gen, device=dev, dtype=torch.int32)
    row = torch.randint(0, n_max, (g_max,), generator=gen, device=dev, dtype=torch.int32)
    masked = torch.rand(g_max, generator=gen, device=dev) < 1 / 3
    owner[masked], row[masked] = -1, 0
    mask = (~masked).float()
    need = {"none": torch.zeros(g_max, device=dev), "all": torch.ones(g_max, device=dev),
            "drawn": (torch.rand(g_max, generator=gen, device=dev) < 0.5).float()}[need_kind]
    return (feats_all, hist1_all, owner, row, mask, need * mask,
            at((g_max, F), offsets[2]), at((n_max + g_max, H), offsets[3]), n_max)


def _bit_equal(torch, got, want) -> bool:
    return all(a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def ghost_pull_phase(torch, dev, tag) -> dict:
    """Phase 20: the one-pass ghost pull kernel on the card (module
    docstring). Returns the record; any failed gate raises."""
    from repro_torch.kernels.ghost_pull import ops as gops
    from repro_torch.kernels.ghost_pull.ref import ghost_pull_ref

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    timer = Timer(torch)
    rec: dict = {"shapes": [], "alignment": {}}
    for name, (K, n_max, g_max, F, H) in GHOST_PULL_SHAPES.items():
        n_tot = n_max + g_max
        # each output row written once, each row that feeds it read once,
        # the slots' owner, row, mask and need read once
        nbytes = 4 * 2 * (g_max * F + n_tot * H) + 16 * g_max
        row = {"shape": name, "K": K, "n_max": n_max, "g_max": g_max, "F": F, "H1": H,
               "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        for need_kind in ("drawn", "all", "none"):
            args = ghost_pull_inputs(torch, K, n_max, g_max, F, H, dev, gen, need_kind)
            before = [a.clone() for a in args[:-1]]
            got = gops.ghost_pull(*args)
            want = ghost_pull_ref(*args)
            row[f"bit_equal_{need_kind}"] = _bit_equal(torch, got, want)
            row[f"inputs_kept_{need_kind}"] = all(torch.equal(a, b)
                                                  for a, b in zip(args[:-1], before))
            if need_kind == "drawn":
                row["pulled"] = int((args[5] > 0).sum())
                row["ms"] = timer(lambda: gops.ghost_pull(*args), 21)
                row["plain_ms"] = timer(lambda: ghost_pull_ref(*args), 11)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["tb_per_s"] = nbytes / row["ms"] / 1e9
            del args, before, got, want
        torch.cuda.empty_cache()
        rec["shapes"].append(row)
        log(f"phase 20 ghost-pull: {tag}: {name}: {json.dumps(row)}")
    # every base phase of the four row arrays, at every width
    for F in GHOST_PULL_WIDTHS:
        ok = True
        for off in range(4):
            for offsets in ((off, 0, 0, 0), (0, 0, off, 0), (0, off, 0, off),
                            (off, 3 - off, (off + 1) % 4, (off + 2) % 4)):
                args = ghost_pull_inputs(torch, 3, 37, 45, F, F, dev, gen, "drawn", offsets)
                ok &= _bit_equal(torch, gops.ghost_pull(*args), ghost_pull_ref(*args))
        rec["alignment"][F] = ok
    log(f"phase 20 ghost-pull: {tag}: alignment sweep (widths x base offsets): "
        f"{json.dumps(rec['alignment'])}")
    # a launch under capture counts in captured; its replays are the plain bits
    K, n_max, g_max, F, H = GHOST_PULL_SHAPES["pubmed"]
    args = ghost_pull_inputs(torch, K, n_max, g_max, F, H, dev, gen)
    gops.ghost_pull(*args)
    torch.cuda.synchronize()
    l0, c0 = gops.ghost_pull.launches, gops.ghost_pull.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gops.ghost_pull(*args)
    captured = (gops.ghost_pull.captured - c0, gops.ghost_pull.launches - l0)
    for t in out:
        t.fill_(float("nan"))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    rec["capture"] = {"captured": captured[0], "launches_while_capturing": captured[1],
                      "replay_bit_equal": _bit_equal(torch, out, ghost_pull_ref(*args))}
    del graph, out, args
    log(f"phase 20 ghost-pull: {tag}: capture {json.dumps(rec['capture'])}")
    bad = [r["shape"] for r in rec["shapes"]
           if not all(v for k, v in r.items() if k.startswith(("bit_equal", "inputs_kept")))]
    if bad or not all(rec["alignment"].values()):
        raise AssertionError(f"ghost-pull: not the plain version's bits at {bad}, "
                             f"alignment {rec['alignment']}")
    if rec["capture"] != {"captured": 1, "launches_while_capturing": 0,
                          "replay_bit_equal": True}:
        raise AssertionError(f"ghost-pull: capture {rec['capture']}")
    return rec


def spmm_sparse_inputs(torch, n, m, d, live, dev, gen, off: int = 0):
    """A neighbour list (n, 32) into a table of m rows, each slot live with
    probability ``live``, and the table (m, d), ``off`` elements into a
    buffer of its own."""
    idx = torch.randint(0, m, (n, 32), generator=gen, device=dev, dtype=torch.int32)
    mask = (torch.rand((n, 32), generator=gen, device=dev) < live).float()
    mask[: max(1, n // 97)] = 0.0          # rows with no live slot
    x = torch.randn(m * d + off, generator=gen, device=dev)[off:].view(m, d)
    return idx, mask, x


def _work_module():
    """``bench/fedbench/work.py`` (the benchmark's bound of an SpMM launch),
    loaded by path."""
    import importlib.util

    path = Path(__file__).resolve().parent / "bench" / "fedbench" / "work.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bench_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spmm_sparse_phase(torch, dev, tag) -> dict:
    """Phase 21: the SpMM's sparse route on the card (module docstring).
    Returns the record; any failed gate raises."""
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    gc.collect()
    torch.cuda.empty_cache()
    work = _work_module()
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    timer = Timer(torch)
    rec: dict = {"shapes": [], "widths": {}}
    for name, (n, m, d, live, transposed) in SPMM_SPARSE_SHAPES.items():
        idx, mask, x = spmm_sparse_inputs(torch, n, m, d, live, dev, gen)
        nnz = int((mask > 0).sum())
        if transposed:
            # dX (m, d) = Aᵀ dY: Y's rows are the n batch rows, X's the m
            # table rows; the operand is built once, as the backward does
            dy = torch.randn((n, d), generator=gen, device=dev)
            op = sops.column_sorted(idx, mask, m)
            run = lambda: sops.sparse_transposed(dy, op)
            plain = lambda: sref.ell_spmm_t_ref(dy, op["rows"], op["w"], op["ptr"], m)
            bound = work.launch_work("backward", m, n, d, nnz,
                                     int((mask > 0).any(1).sum()))
        else:
            run = lambda: sops.sparse_forward(x, idx, mask)
            plain = lambda: sref.ell_spmm_ref(x, idx, mask)
            bound = work.launch_work("forward", n, m, d, nnz,
                                     int(torch.unique(idx[mask > 0]).numel()))
        got, again, want = run(), run(), plain()
        row = {"shape": name, "rows": n, "table_rows": m, "width": d, "nnz": nnz,
               "transposed": transposed, "bit_equal_plain": _bit_equal(torch, [got], [want]),
               "bit_equal_twice": _bit_equal(torch, [got], [again]),
               "bound_ms": bound["bound_s"] * 1e3, "bytes": bound["bytes"],
               "bound_by": "bytes" if bound["bytes"] / work.PEAK_BYTES_PER_S
               >= bound["flops"] / work.PEAK_FP32_FLOPS else "operations"}
        del got, again, want
        row["ms"] = timer(run, 21)
        row["plain_ms"] = timer(plain, 5)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rec["shapes"].append(row)
        log(f"phase 21 spmm-sparse: {tag}: {name}: {json.dumps(row)}")
        del idx, mask, x
        torch.cuda.empty_cache()
    # every width, with the table and the output off 16 and 8 bytes
    for d in SPMM_SPARSE_WIDTHS:
        ok = True
        for off in (0, 1, 2, 3):
            idx, mask, x = spmm_sparse_inputs(torch, 53, 41, d, 0.5, dev, gen, off)
            ok &= _bit_equal(torch, [sops.sparse_forward(x, idx, mask)],
                             [sref.ell_spmm_ref(x, idx, mask)])
            dy = torch.randn(53 * d + off, generator=gen, device=dev)[off:].view(53, d)
            op = sops.column_sorted(idx, mask, 41)
            ok &= _bit_equal(torch, [sops.sparse_transposed(dy, op)],
                             [sref.ell_spmm_t_ref(dy, op["rows"], op["w"], op["ptr"], 41)])
        rec["widths"][d] = ok
    log(f"phase 21 spmm-sparse: {tag}: widths x base offsets bit-equal: "
        f"{json.dumps(rec['widths'])}")
    # a launch under capture counts in captured; its replay is the plain bits
    idx, mask, x = spmm_sparse_inputs(torch, 3_423, 14_983, 500, 0.9, dev, gen)
    sops.sparse_forward(x, idx, mask)
    torch.cuda.synchronize()
    c = sops.block_spmm
    before = (c.captured, c.launches, c.sparse_captured, c.sparse_launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sops.sparse_forward(x, idx, mask)
    after = (c.captured, c.launches, c.sparse_captured, c.sparse_launches)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    rec["capture"] = {"captured": after[0] - before[0],
                      "launches_while_capturing": after[1] - before[1],
                      "sparse_captured": after[2] - before[2],
                      "sparse_launches_while_capturing": after[3] - before[3],
                      "replay_bit_equal": _bit_equal(torch, [out],
                                                     [sref.ell_spmm_ref(x, idx, mask)])}
    del graph, out, idx, mask, x
    log(f"phase 21 spmm-sparse: {tag}: capture {json.dumps(rec['capture'])}")
    bad = [r["shape"] for r in rec["shapes"]
           if not (r["bit_equal_plain"] and r["bit_equal_twice"])]
    if bad or not all(rec["widths"].values()):
        raise AssertionError(f"spmm-sparse: not the plain version's bits at {bad}, "
                             f"widths {rec['widths']}")
    if rec["capture"] != {"captured": 1, "launches_while_capturing": 0, "sparse_captured": 1,
                          "sparse_launches_while_capturing": 0, "replay_bit_equal": True}:
        raise AssertionError(f"spmm-sparse: capture {rec['capture']}")
    return rec


def fused_phase(torch, api, counters, g, fed, dev, tag, method_runs,
                profile) -> tuple[dict, int]:
    """Phase 12: the fused executor on the card, on phase 10's partition,
    GraphSAGE 256/128, spmm backends; every launch counter set to 0 just
    before each run and read just after it.

    * ``fedais`` for ``FUSED_ROUNDS`` rounds, an eval every
      ``FUSED_EVAL_EVERY``: the default ``SyncScheduler`` takes the fused
      executor (chunks [0], [1, 2], [3, 4], [5]); every history column and
      the final row bit-identical to ``SyncScheduler(fused=False)``, and
      the params and tables too; the SpMM launched exactly rounds x m x
      (2 + 3J) + evals x 2 times and the ghost pull once a gated sync
      epoch (more than 0, and in the captured keys), counted through the
      replays, nothing else; the graph keys and their capture time; the
      device memory allocated the same after the second chunk as after
      the last (no growth per chunk; a chunk that captured a new key is
      named);
    * each other fusable method (phase 11 ran it fused, 2 rounds): its
      stepwise run of the same seed, every history column and the final
      row bit-identical;
    * ``fedais`` under ``FaultPlan(**FAULT_PLAN)`` for ``FAULT_ROUNDS``
      rounds: ``fused_faulty`` against faulty stepwise, every history
      column, the final row, the params, the tables and ``FaultCounters``
      equal, ``n_quarantined`` > 0, drops counted; the launch gate;
    * an async run under the same plan (``AsyncScheduler(**FAULT_ASYNC)``)
      that completes: its counters recorded, the launch gate over the
      clients dispatched.

    Under ``profile`` one stepwise round traced beside phase 10's replayed
    round."""
    rec: dict = {}
    total = collections.Counter()

    def gate(run, name, merges, evals=None):
        J = run["engine"].mcfg.local_epochs
        want = {n: 0 for n in counters}
        want["spmm"] = (sum(run["dispatched"]) * (2 + 3 * J)
                        + 2 * (merges if evals is None else evals))
        want["ghost_pull"] = run["sync_epochs"]
        if run["launches"] != want:
            raise AssertionError(f"fused: {name}: launches {run['launches']}, want {want}")
        hist = run["result"].history
        if not all(math.isfinite(x) for x in hist["test_loss"]):
            raise AssertionError(f"fused: {name}: history {hist}")
        return want

    # fedais, fused by default, against stepwise
    evals = len([t for t in range(FUSED_ROUNDS)
                 if t % FUSED_EVAL_EVERY == 0 or t == FUSED_ROUNDS - 1])
    fz = method_run(torch, api, counters, g, fed, dev, "fedais", FUSED_ROUNDS,
                    eval_every=FUSED_EVAL_EVERY)
    want = gate(fz, "fedais fused", FUSED_ROUNDS, evals)
    fz_tables = [t.clone() for t in train_tables(fz["state"])]
    fz_res, fz_exec, chunks, captures = fz["result"], fz["executor"], fz["chunks"], fz["captures"]
    fz_peak, fz_launches = fz["peak_gb"], fz["launches"]
    del fz
    st = method_run(torch, api, counters, g, fed, dev, "fedais", FUSED_ROUNDS,
                    eval_every=FUSED_EVAL_EVERY, scheduler=api.SyncScheduler(fused=False))
    gate(st, "fedais stepwise", FUSED_ROUNDS, evals)
    same = _same_history(fz_res, st["result"])
    same["tables"] = all(torch.equal(a, b) for a, b in zip(fz_tables,
                                                           train_tables(st["state"])))
    same["executors"] = (fz_exec, st["executor"]) == ("fused", "stepwise")
    mem = [c["allocated"] for c in chunks]
    graphs = [c["graphs"] for c in chunks]
    growth = {f"chunk {i}": mem[i] - mem[i - 1] for i in range(2, len(mem))
              if graphs[i] == graphs[i - 1] and mem[i] != mem[i - 1]}
    chunk_ms = [c["ms"] for c in chunks]
    per_round = [c["ms"] / c["rounds"][1] for c in chunks]
    log(f"phase 12 fused: {tag}: fedais {FUSED_ROUNDS} rounds, eval every "
        f"{FUSED_EVAL_EVERY}: fused vs stepwise the same {json.dumps(same)}; chunks "
        f"{[c['rounds'] for c in chunks]} ms {chunk_ms} (per round {per_round}); stepwise ms "
        f"per round {st['round_ms']}; launches {json.dumps(fz_launches)} (want "
        f"{json.dumps(want)}); graph keys {len(captures)}: "
        f"{json.dumps(captures)}; memory allocated after each chunk {mem} (graph keys "
        f"{graphs}); peak memory fused {fz_peak} GB, stepwise {st['peak_gb']} GB; tau "
        f"{fz_res.history['tau']}; test_acc {fz_res.history['test_acc']}")
    if not all(same.values()):
        raise AssertionError(f"fused: fedais fused differs from stepwise: {same}")
    if growth or not captures:
        raise AssertionError(f"fused: memory grew per chunk {growth}, captures {captures}")
    if not (fz_launches["ghost_pull"] > 0
            and any(c["ghost_pull_launches"] for c in captures)):
        raise AssertionError(f"fused: the ghost pull not in the replayed rounds: launches "
                             f"{fz_launches}, captures {captures}")
    rec["fedais"] = {"same": same, "chunks": chunks, "captures": captures,
                     "launches": fz_launches, "peak_gb": fz_peak,
                     "stepwise_peak_gb": st["peak_gb"], "stepwise_round_ms": st["round_ms"],
                     "history": fz_res.history, "final": fz_res.final}
    total.update(fz_launches)
    total.update(st["launches"])
    del st

    # every other fusable method: phase 11's fused run against stepwise
    rec["methods"] = {}
    for method in FUSABLE:
        fused_run = method_runs[method]
        st = method_run(torch, api, counters, g, fed, dev, method, METHOD_ROUNDS,
                        scheduler=api.SyncScheduler(fused=False))
        gate(st, f"{method} stepwise", METHOD_ROUNDS)
        same = _same_history(fused_run, st["result"])
        same["executors"] = (fused_run.executor, st["executor"]) == ("fused", "stepwise")
        log(f"phase 12 fused: {tag}: {method} {METHOD_ROUNDS} rounds, phase 11's fused run "
            f"vs stepwise: the same {json.dumps(same)}; stepwise ms per round "
            f"{st['round_ms']}")
        if not all(same.values()):
            raise AssertionError(f"fused: {method} fused differs from stepwise: {same}")
        rec["methods"][method] = {"same": same, "stepwise_round_ms": st["round_ms"]}
        total.update(st["launches"])
        del st

    # the fault plan: fused_faulty against faulty stepwise, then async
    from repro_torch.faults import FaultPlan

    plan = FaultPlan(**FAULT_PLAN)
    fr = method_run(torch, api, counters, g, fed, dev, "fedais", FAULT_ROUNDS,
                    eval_every=FUSED_EVAL_EVERY, faults=plan)
    f_evals = len([t for t in range(FAULT_ROUNDS)
                   if t % FUSED_EVAL_EVERY == 0 or t == FAULT_ROUNDS - 1])
    gate(fr, "fedais fused_faulty", FAULT_ROUNDS, f_evals)
    fr_tables = [t.clone() for t in train_tables(fr["state"])]
    fr_res, fr_exec = fr["result"], fr["executor"]
    fr_events, fr_launches = fr["state"].fault_events.snapshot(), fr["launches"]
    del fr
    sf = method_run(torch, api, counters, g, fed, dev, "fedais", FAULT_ROUNDS,
                    eval_every=FUSED_EVAL_EVERY, faults=plan,
                    scheduler=api.SyncScheduler(fused=False))
    gate(sf, "fedais faulty stepwise", FAULT_ROUNDS, f_evals)
    same = _same_history(fr_res, sf["result"])
    same["tables"] = all(torch.equal(a, b) for a, b in zip(fr_tables,
                                                           train_tables(sf["state"])))
    same["fault_events"] = fr_events == sf["state"].fault_events.snapshot()
    same["executors"] = (fr_exec, sf["executor"]) == ("fused_faulty", "stepwise")
    log(f"phase 12 fused: {tag}: fedais under FaultPlan({FAULT_PLAN}) {FAULT_ROUNDS} rounds: "
        f"fused_faulty vs faulty stepwise the same {json.dumps(same)}; fault events "
        f"{json.dumps(fr_events)}; launches {json.dumps(fr_launches)}; test_acc "
        f"{fr_res.history['test_acc']}; wall_clock {fr_res.history['wall_clock']}")
    if not all(same.values()) or fr_events["n_quarantined"] < 1 or fr_events["n_dropped"] < 1:
        raise AssertionError(f"fused: fused_faulty vs faulty stepwise {same}, events "
                             f"{fr_events}")
    rec["faulty"] = {"plan": FAULT_PLAN, "same": same, "fault_events": fr_events,
                     "launches": fr_launches, "history": fr_res.history}
    total.update(fr_launches)
    total.update(sf["launches"])
    del sf
    ar = method_run(torch, api, counters, g, fed, dev, "fedais", FAULT_ROUNDS, faults=plan,
                    scheduler=api.AsyncScheduler(**FAULT_ASYNC))
    gate(ar, "fedais async under the plan", FAULT_ROUNDS)
    ah, a_events = ar["result"].history, ar["state"].fault_events.snapshot()
    log(f"phase 12 fused: {tag}: fedais async {json.dumps(FAULT_ASYNC)} under the plan, "
        f"{FAULT_ROUNDS} merges: dispatched {ar['dispatched']}, merged {ah['merged']}, "
        f"staleness max {ah['staleness_max']}; fault events {json.dumps(a_events)}; launches "
        f"{json.dumps(ar['launches'])}; test_acc {ah['test_acc']}")
    if len(ah["test_acc"]) != FAULT_ROUNDS or not any(a_events.values()):
        raise AssertionError(f"fused: async under the plan: history {ah}, events {a_events}")
    rec["async_faults"] = {"scheduler": FAULT_ASYNC, "fault_events": a_events,
                           "dispatched": ar["dispatched"], "merged": ah["merged"],
                           "launches": ar["launches"]}
    total.update(ar["launches"])
    del ar
    if profile:
        rec["profile_stepwise"] = profile_round(torch, api, g, fed, dev, tag, fused=False)
    rec["spmm_launches"] = total["spmm"]
    rec["ghost_pull_launches"] = total["ghost_pull"]
    return rec, total["spmm"]


# the deployment path (phase 13): serve_fed's arguments on phase 10's graph
# and partition, training and serving through the SpMM kernel
DEPLOY_ARGS = ["--scale", "1", "--max-features", "500", "--clients", str(TRAIN_CLIENTS),
               "--cohort", str(TRAIN_M), "--rounds", str(TRAIN_ROUNDS), "--queries", "200",
               "--updates", "20", "--mode", "closed", "--train-backend", "spmm",
               "--device", "cuda:0"]
# SpMM launches per serve body under spmm: the historical body aggregates
# once, the fresh body twice (layer 0 over the refresh rows, then layer 1),
# the refresh once
BODY_SPMM = {"hist": 1, "fresh": 2, "refresh": 1}


def _pipeline(torch, serve_fed, counters, argv) -> tuple:
    """One ``serve_fed.serve_pipeline`` on the card, every launch counter
    set to 0 just before and read just after: the SpMM launched, the
    ghost pull once a gated sync epoch of its training (none where it
    restores a checkpoint instead), nothing else."""
    args = serve_fed.build_args(DEPLOY_ARGS + argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sync_epochs() as epochs:
        payload, ctx = serve_fed.serve_pipeline(args)
    torch.cuda.synchronize()
    ctx["seconds"] = time.perf_counter() - t0
    ctx["launches"] = {n: c.launches for n, c in counters.items()}
    ctx["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ctx["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    want = {n: 0 for n in counters if n != "spmm"}
    want["ghost_pull"] = epochs[0]
    if (any(ctx["launches"][n] != v for n, v in want.items()) or not ctx["launches"]["spmm"]
            or (ctx["state"] is not None and not epochs[0] > 0)):
        raise AssertionError(f"deploy: launches {ctx['launches']}, ghost pulls {epochs[0]}")
    return args, payload, ctx


def _served_vs_eval(torch, ServedModel, QueryEngine, build_eval_graph, eval_logits, ckpt,
                    g, fed, params, backend, dev) -> tuple[float, bool]:
    """A fresh restore of ``ckpt`` under ``backend``, every node's served
    historical logits against the eval path's: (max abs diff, bit-equal)."""
    import numpy as np

    model = ServedModel.restore(ckpt, g, fed, backend=backend, seed=0, device=dev)
    engine = QueryEngine(model)
    engine.warmup()
    got = np.concatenate([engine.query(np.arange(i, min(i + 128, g.n_nodes)),
                                       policy="historical")
                          for i in range(0, g.n_nodes, 128)])
    eg = build_eval_graph(g, max_deg=fed.max_deg, seed=0, backend=backend, device=dev)
    want = eval_logits(params, eg).cpu().numpy()
    del eg, engine, model
    return float(np.abs(got - want).max()), bool(np.array_equal(got, want))


def row_invariance(torch, dev) -> dict:
    """Whether a row of a product gets the same bits among b rows as among
    the eval path's 19,717, at the layer-1 shape (256 -> 128, fp32): through
    ``torch.matmul`` (recorded: cuBLAS picks its kernel by the shape) and
    through ``models.gcn.row_matmul`` (gated: the serving parity rests on
    it)."""
    from repro_torch.models.gcn import row_matmul

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((19717, 256), generator=gen, device=dev)
    w = torch.randn((256, 128), generator=gen, device=dev)
    full, blocked = x @ w, row_matmul(x, w)
    sizes = (8, 128, 1024, 4224)
    return {"matmul": {b: bool(torch.equal(x[:b] @ w, full[:b])) for b in sizes},
            "row_matmul": {b: bool(torch.equal(row_matmul(x[:b], w), blocked[:b]))
                           for b in sizes}}


def eval_cost(torch, build_eval_graph, eval_logits, g, params, dev, reps: int = 10) -> dict:
    """Recorded: host ms (after a synchronise) of the eval path under spmm,
    whose products run in row blocks, against the same forward with one
    product a layer (``_sage_layer``), in turns (blocked, whole, whole,
    blocked, ...); medians."""
    from repro_torch.models.gcn import HIDDEN, _sage_layer, neighbor_aggregate

    eg = build_eval_graph(g, max_deg=32, seed=0, backend="spmm", device=dev)

    def whole():
        h = eg["features"]
        for l in range(len(HIDDEN)):
            h = _sage_layer(params, l, h, neighbor_aggregate(
                h, eg["nbr_idx"], eg["nbr_mask"], backend="spmm", adj=eg["adj"]))
        return h @ params["w_cls"] + params["b_cls"]

    fns = {"row_blocks": lambda: eval_logits(params, eg), "one_product": whole}
    times: dict = {k: [] for k in fns}
    for i in range(2 * reps):
        for k in (("row_blocks", "one_product") if i % 2 == 0 else ("one_product",
                                                                    "row_blocks")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    del eg
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def deploy_phase(torch, counters, dev, tag, profile) -> tuple[dict, int]:
    """Phase 13: the deployment path on the card, on phase 10's graph and
    partition (fedais, 3 rounds, fused, spmm training):

    * ``serve_fed.serve_pipeline`` under ``--backend spmm`` (fp32 cache,
      closed loop, 200 queries, 20 updates): the restored step is the one
      written; the file's leaves, the restored params and ``table_age``
      equal the trained state's bits (and the template's dtypes); a fresh
      restore's served historical logits of every node within 1e-4 of the
      eval path; ``fused_ab``'s gates (bit parity with the two-call
      pipeline, fused p50 <= two-call p50, nothing prepared after
      warmup); 3 graphs a bucket, nothing captured after warmup; each
      graph's SpMM launches per body (``BODY_SPMM``) and the traffic's
      launches exactly the replays' sum. Recorded: p50, p99, queries/s,
      the graphs' capture seconds, memory; under ``profile`` the host's
      ``cudaLaunchKernel`` / ``cudaGraphLaunch`` calls per replayed chunk
      of a second traffic run;
    * the same under ``--backend gather --parity-check``: served historical
      logits bit-identical to the eval path (the reference's gate);
      recorded: the segment backend's served logits against its eval path
      (bit-equal or not);
    * ``--cache-dtype int8`` (spmm): the cache column (resident bytes,
      served accuracy) beside fp32's;
    * ``fed_chaos.main(["--quick", ...])``: exit code 0; every row's
      executor, accuracy, delta and fault counters recorded.
    """
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.federated.server import build_eval_graph, eval_logits
    from repro_torch.launch import fed_chaos, serve_fed
    from repro_torch.serve import (LoadGenerator, QueryEngine, ServedModel,
                                   federation_template, federation_tree)
    from repro_torch.serve.model import _scatter_tables

    rec: dict = {"row_invariance": row_invariance(torch, dev)}
    log(f"phase 13 deploy: {tag}: a row's bits among b rows vs among 19,717 (256 -> 128): "
        f"torch.matmul {json.dumps(rec['row_invariance']['matmul'])} (recorded), row_matmul "
        f"{json.dumps(rec['row_invariance']['row_matmul'])}")
    if not all(rec["row_invariance"]["row_matmul"].values()):
        raise AssertionError(f"deploy: row_matmul is not row-invariant: {rec['row_invariance']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as work:
        ckpt = f"{work}/ckpt_spmm"
        args, pay, ctx = _pipeline(torch, serve_fed, counters, [
            "--backend", "spmm", "--ckpt-dir", ckpt, "--out", f"{work}/serve_spmm.json"])
        g, fed, state, model, eng = (ctx[k] for k in ("graph", "fed", "state", "model",
                                                      "engine"))
        total = collections.Counter(ctx["launches"])

        def leaves(t):
            return {**{f"params/{k}": v for k, v in t["params"].items()},
                    **{k: v for k, v in t.items() if k != "params"}}

        tmpl = leaves(federation_template(fed))
        in_file = leaves(load_checkpoint(ckpt, args.rounds, federation_template(fed)))
        trained = leaves(federation_tree(state))
        bits = {
            "step": model.restored_step == latest_step(ckpt) == args.rounds,
            "file": all(np.array_equal(in_file[k], trained[k]) and in_file[k].dtype == t.dtype
                        for k, t in tmpl.items()),
            "params": all(torch.equal(model.params[k], state.params[k]) for k in state.params),
            "table_age": bool(np.array_equal(model.table_age,
                                             _scatter_tables(fed, trained["age"]))),
        }
        n_b = len(eng.buckets)
        by_key = {tuple(c["key"]): c["spmm_launches"] for c in eng.captures}
        traffic = ctx["traffic"]
        replayed = sum(n * by_key[k] for k, n in traffic["replays"].items())
        graphs = {
            "count": eng.graph_count, "captures": eng.captures,
            "capture_s": sum(c["seconds"] for c in eng.captures),
            "prepared": eng.trace_count, "after_warmup": eng.trace_count_after_warmup,
            "body_launches": all(c["spmm_launches"] == BODY_SPMM[c["key"][0]]
                                 for c in eng.captures),
            "traffic_launches": traffic["spmm_launches"], "replayed_launches": replayed,
            "traffic_replays": sum(traffic["replays"].values()),
        }
        err, _ = _served_vs_eval(torch, ServedModel, QueryEngine, build_eval_graph,
                                 eval_logits, ckpt, g, fed, state.params, "spmm", dev)
        rec["eval_ms"] = eval_cost(torch, build_eval_graph, eval_logits, g, state.params, dev)
        log(f"phase 13 deploy: {tag}: the spmm eval path, median host ms (recorded): "
            f"{json.dumps(rec['eval_ms'])}")
        log(f"phase 13 deploy: {tag}: serve_fed spmm ({ctx['seconds']:.1f} s): restored step "
            f"{model.restored_step}, bits {json.dumps(bits)}; served historical vs eval path "
            f"max abs diff {err}; p50 {pay['p50_ms']} ms p99 {pay['p99_ms']} ms "
            f"{pay['queries_per_s']} queries/s; fused column {json.dumps(pay['fused'])}; "
            f"graphs {graphs['count']} (prepared {graphs['prepared']}, after warmup "
            f"{graphs['after_warmup']}), capture {graphs['capture_s']:.3f} s in all, "
            f"{json.dumps([round(c['seconds'], 4) for c in eng.captures])}; traffic "
            f"{graphs['traffic_replays']} replays, SpMM launches {graphs['traffic_launches']} "
            f"(replays' sum {replayed}); launches {json.dumps(ctx['launches'])}; peak "
            f"{ctx['peak_gb']:.3f} GB, reserved {ctx['reserved_gb']:.3f} GB")
        if not all(bits.values()):
            raise AssertionError(f"deploy: the restored state is not the trained one: {bits}")
        if not err <= TOL_LOGITS:
            raise AssertionError(f"deploy: served vs eval path max abs diff {err}")
        if (graphs["count"] != 3 * n_b or graphs["prepared"] != 3 * n_b
                or graphs["after_warmup"] != 3 * n_b or not graphs["body_launches"]
                or pay["fused"]["recompiles_after_warmup"] != 0):
            raise AssertionError(f"deploy: graphs {graphs}")
        if not 0 < replayed == traffic["spmm_launches"]:
            raise AssertionError(f"deploy: traffic launched {traffic['spmm_launches']} SpMM, "
                                 f"its replays hold {replayed}")
        rec["spmm"] = {"payload": pay, "bits": bits, "served_vs_eval_max_abs": err,
                       "graphs": graphs, "seconds": ctx["seconds"],
                       "launches": ctx["launches"], "peak_gb": ctx["peak_gb"],
                       "reserved_gb": ctx["reserved_gb"]}
        if profile:
            before = sum(eng.replays.values())
            prof = profile_traffic(torch, eng, LoadGenerator)
            prof["replays"] = sum(eng.replays.values()) - before
            prof["calls_per_replay"] = {k: v / max(prof["replays"], 1)
                                        for k, v in prof["api_calls"].items()}
            rec["spmm"]["profile"] = prof
            log(f"profile: {tag}: deploy traffic (replayed) wall {prof['wall_ms']} ms, device "
                f"busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']}), "
                f"{prof['replays']} replays; host calls {json.dumps(prof['api_calls'])}, "
                f"per replay {json.dumps(prof['calls_per_replay'])}")
        del model, eng, ctx
        # the reference's bit gate under gather, and what holds for segment
        _, gpay, gctx = _pipeline(torch, serve_fed, counters, [
            "--backend", "gather", "--parity-check", "--ckpt-dir", f"{work}/ckpt_gather",
            "--out", f"{work}/serve_gather.json"])
        total.update(gctx["launches"])
        seg_err, seg_bits = _served_vs_eval(torch, ServedModel, QueryEngine, build_eval_graph,
                                            eval_logits, f"{work}/ckpt_gather", gctx["graph"],
                                            gctx["fed"], gctx["state"].params, "segment", dev)
        log(f"phase 13 deploy: {tag}: serve_fed gather --parity-check: every node "
            f"bit-identical to the eval path; p50 {gpay['p50_ms']} ms p99 {gpay['p99_ms']} ms; "
            f"fused column {json.dumps(gpay['fused'])}; segment (recorded): bit-identical "
            f"{seg_bits}, max abs diff {seg_err}")
        rec["gather"] = {"payload": gpay, "parity": True, "launches": gctx["launches"],
                         "segment_bit_identical": seg_bits, "segment_max_abs": seg_err}
        del gctx
        # the int8 cache on the spmm run's checkpoint (no training)
        _, ipay, ictx = _pipeline(torch, serve_fed, counters, [
            "--backend", "spmm", "--cache-dtype", "int8", "--ckpt-dir", ckpt,
            "--out", f"{work}/serve_int8.json"])
        total.update(ictx["launches"])
        log(f"phase 13 deploy: {tag}: serve_fed spmm int8 cache: {json.dumps(ipay['cache'])} "
            f"(fp32: {json.dumps(pay['cache'])}); p50 {ipay['p50_ms']} ms p99 "
            f"{ipay['p99_ms']} ms")
        rec["int8"] = {"payload": ipay, "launches": ictx["launches"]}
        del ictx
        # the chaos matrix
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rc = fed_chaos.main(["--quick", "--out", f"{work}/faults.json", "--device", "cuda:0"])
        torch.cuda.synchronize()
        faults = json.loads(Path(f"{work}/faults.json").read_text())
        rows = [{k: r[k] for k in ("scenario", "scheduler", "executor", "final_acc",
                                   "acc_delta", "rounds_completed", "crashed", "faults")}
                for r in faults["rows"]]
        rec["chaos"] = {"rc": rc, "seconds": time.perf_counter() - t0, "rows": rows,
                        "serve": faults["serve"], "ckpt": faults["ckpt"],
                        "crashes": faults["crashes"], "max_acc_delta": faults["max_acc_delta"],
                        "launches": {n: c.launches for n, c in counters.items()}}
        log(f"phase 13 deploy: {tag}: fed_chaos --quick exit {rc} in "
            f"{rec['chaos']['seconds']:.1f} s: {len(rows)} rows, crashes {faults['crashes']}, "
            f"max acc delta {faults['max_acc_delta']}; ckpt {json.dumps(faults['ckpt'])}; "
            f"serve {json.dumps(faults['serve'])}")
        for r in rows:
            log(f"phase 13 deploy: chaos {r['scheduler']} {r['scenario']}: executor "
                f"{r['executor']!r} acc {r['final_acc']} delta {r['acc_delta']} faults "
                f"{json.dumps({k: v for k, v in r['faults'].items() if v})}")
        if rc != 0:
            raise AssertionError(f"deploy: fed_chaos --quick exited {rc}")
    rec["spmm_launches"] = total["spmm"]
    rec["ghost_pull_launches"] = total["ghost_pull"]
    return rec, total["spmm"]


# the multi-device executors (phase 14): fedais rounds and eval cadence as
# phase 12's fused run, a 4-round run at tau0 8 (J 4: every other round's
# sync gate off) and a 4-round run under a fault plan without corruption
# (the sharded executors refuse it); float columns against the fused run at
# the reference's tolerance (tests/test_sharding.py), discrete ones exact
SHARD_ROUNDS, SHARD_EVAL_EVERY, SHARD_GATED_TAU0, SHARD_FAULT_ROUNDS = 6, 2, 8, 4
SHARD_FAULTS = dict(seed=78, dropout=0.2, straggler_frac=0.3)
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-6
EXACT_KEYS = ("tau", "comm_total", "comm_embed", "flops", "wall_clock")


def _shard_compare(ref, got) -> dict:
    """A sharded run's history against the fused run's: the discrete
    columns equal, test_acc / test_loss within the reference's tolerance,
    and whether the floats are bit-equal."""
    import numpy as np

    out = {k: ref.history[k] == got.history[k] for k in EXACT_KEYS}
    for k in ("test_acc", "test_loss"):
        a = np.asarray(got.history[k], np.float64)
        b = np.asarray(ref.history[k], np.float64)
        out[k] = bool(np.allclose(a, b, rtol=SHARD_RTOL, atol=SHARD_ATOL))
    out["floats_bit_equal"] = (got.history["test_acc"] == ref.history["test_acc"]
                               and got.history["test_loss"] == ref.history["test_loss"])
    return out


def _shard_ledger_rounds(eng, sync_dtype: str) -> tuple[list, list]:
    """Each round's counted collectives of a sharded run against what the
    ledger says that round moves (``sharding.ledger``)."""
    from repro_torch.federated.partition import ghost_exchange_buckets
    from repro_torch.sharding import ledger

    fed, m = eng.fed, TRAIN_M
    rounds = eng._sharded[eng.last_executor == "pod_sharded"].round_log
    got, want = [], []
    for r in rounds:
        got.append({k: list(v) for k, v in r["collectives"].items()})
        if eng.last_executor == "pod_sharded":
            b = ghost_exchange_buckets(fed.ghost_owner, fed.ghost_row, fed.ghost_mask, 1)
            led = ledger.pod_placement_ledger(
                b, n_pods=1, cohort_pad=m, wb_cap=r["cap"], n_max=fed.n_max, g_max=fed.g_max,
                n_feat=fed.n_features, n_classes=fed.n_classes, tau=2,
                local_epochs=eng.mcfg.local_epochs, max_deg=fed.max_deg,
                sync_dtype=sync_dtype)
            w = ledger.round_collectives(led, gate=r["gate"], merge_reduce=eng.merge_reduce)
        else:
            w = ledger.sharded_round_collectives(
                cohort_pad=m, n_shards=1, n_max=fed.n_max, g_max=fed.g_max,
                n_feat=fed.n_features, n_classes=fed.n_classes, merge_reduce=eng.merge_reduce,
                sync_dtype=sync_dtype)
        want.append({k: list(v) for k, v in w.items()})
    return got, want


def sharded_phase(torch, api, counters, g, fed, dev, tag, profile) -> tuple[dict, int]:
    """Phase 14: the multi-device executors on a one-rank NCCL group (the
    card is the whole world): ``FedEngine(..., mesh=...)`` on phase 10's
    partition, spmm backends, every launch counter and the collective
    counts set to 0 just before each run and read just after it.

    * ``fedais`` for ``SHARD_ROUNDS`` rounds, an eval every
      ``SHARD_EVAL_EVERY``, fused (the reference run), then
      ``sharded_fused`` on a ``(1,)`` client mesh with ``merge_reduce``
      psum and pairwise, ``pod_sharded`` on a ``(1, 1)`` pod mesh at fp32
      and at ``sync_dtype="int8"`` (the fp32 run's cohorts and tau): the
      executor named; cohorts, tau, the comm, flops and wall-clock columns
      exact; test_acc / test_loss within 1e-4 (bit-equal recorded); the SpMM
      exactly rounds x m x (2 + 3J) + evals x 2 through the replays, the
      ghost pull once a gated sync epoch (none on the pod mesh, whose rows
      come prefetched), nothing else; each round's collectives (calls and bytes) those of
      ``sharding.ledger``; the memory allocated after each chunk equal from
      the second chunk on (a chunk that captured a new key aside);
    * ``pod_sharded`` at tau0 ``SHARD_GATED_TAU0`` for 4 rounds: some
      round's sync gate off, and such a round moves no ghost byte (its
      graph holds no ghost exchange), the ledger per round;
    * under ``FaultPlan(**SHARD_FAULTS)`` (dropout and stragglers)
      ``sharded_fused`` against ``fused_faulty``: the discrete columns and
      ``FaultCounters`` equal, floats within 1e-4; the rows of a client
      dropped in a chunk and trained in none of its rounds unchanged to the
      bit.

    Under ``profile`` one replayed pod-sharded round is traced: graph
    launches, the NCCL kernels' device time, the busy share."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.faults import FaultPlan
    from repro_torch.sharding import comm
    from repro_torch.sharding.fed import make_client_mesh
    from repro_torch.sharding.tables import gather_tables, make_pod_mesh

    rec: dict = {}
    total = collections.Counter()
    store = tempfile.mkdtemp(prefix="phase14-")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        cmesh = make_client_mesh()
        pmesh = make_pod_mesh(1, 1)
        evals = len([t for t in range(SHARD_ROUNDS)
                     if t % SHARD_EVAL_EVERY == 0 or t == SHARD_ROUNDS - 1])

        def run(name, rounds, n_evals, executor, method="fedais", **kw):
            comm.reset()
            r = method_run(torch, api, counters, g, fed, dev, method, rounds,
                           eval_every=SHARD_EVAL_EVERY, **kw)
            J = r["engine"].mcfg.local_epochs
            want = {n: 0 for n in counters}
            want["spmm"] = rounds * TRAIN_M * (2 + 3 * J) + 2 * n_evals
            want["ghost_pull"] = r["sync_epochs"]
            hist = r["result"].history
            if r["executor"] != executor or r["launches"] != want:
                raise AssertionError(f"sharded: {name}: executor {r['executor']} (want "
                                     f"{executor}), launches {r['launches']}, want {want}")
            if not all(math.isfinite(x) for x in hist["test_loss"]):
                raise AssertionError(f"sharded: {name}: history {hist}")
            mem = [c["allocated"] for c in r["chunks"]]
            graphs = [c["graphs"] for c in r["chunks"]]
            r["growth"] = {f"chunk {i}": mem[i] - mem[i - 1] for i in range(2, len(mem))
                           if graphs[i] == graphs[i - 1] and mem[i] != mem[i - 1]}
            r["memory"] = mem
            r["collectives"] = comm.snapshot()
            return r

        base = run("fedais fused", SHARD_ROUNDS, evals, "fused")
        base_params = {k: v.clone() for k, v in base["state"].params.items()}
        base_tables = [t.clone() for t in train_tables(base["state"])[len(base_params):]]
        base_res, base_cohorts = base["result"], base["cohorts"]
        total.update(base["launches"])
        del base
        rec["runs"] = {}
        fp32_pod = None
        for name, executor, kw in (
                ("sharded psum", "sharded_fused", dict(mesh=cmesh)),
                ("sharded pairwise", "sharded_fused", dict(mesh=cmesh, merge_reduce="pairwise")),
                ("pod fp32", "pod_sharded", dict(mesh=pmesh)),
                ("pod int8", "pod_sharded", dict(mesh=pmesh, sync_dtype="int8"))):
            r = run(name, SHARD_ROUNDS, evals, executor, **kw)
            eng, res = r["engine"], r["result"]
            got, want = _shard_ledger_rounds(eng, kw.get("sync_dtype", "fp32"))
            if kw.get("sync_dtype") == "int8":
                same = {"cohorts": r["cohorts"] == fp32_pod["cohorts"],
                        "tau": res.history["tau"] == fp32_pod["tau"]}
            else:
                same = _shard_compare(base_res, res)
                same["cohorts"] = r["cohorts"] == base_cohorts
            same["ledger"] = got == want
            same["memory"] = not r["growth"]
            params_equal = all(torch.equal(r["state"].params[k], base_params[k])
                               for k in base_params)
            st = r["state"]
            tables = (st.hist.hist1, st.hist.age, st.hist.ghost_feat, st.prev_loss)
            if st.pod_shard is not None:
                # this rank's pod shards back to the K rows
                tables = gather_tables(tables, pmesh, fed.n_clients)
            tables_equal = all(torch.equal(a, b) for a, b in zip(tables, base_tables))
            del st, tables
            cap = [c["key"] for c in r["captures"]]
            log(f"phase 14 sharded: {tag}: {name} ({r['executor']}) {SHARD_ROUNDS} rounds vs "
                f"fused: {json.dumps(same)}; params bit-equal {params_equal}, tables "
                f"{tables_equal}; test_acc "
                f"{res.history['test_acc']}; test_loss {res.history['test_loss']}; launches "
                f"{json.dumps(r['launches'])}; collectives {json.dumps(r['collectives'])}; "
                f"round 0 {json.dumps(got[0])}; chunks ms {[c['ms'] for c in r['chunks']]}; "
                f"memory after each chunk {r['memory']}; graph keys {len(cap)}, capture s "
                f"{[c['seconds'] for c in r['captures']]}; peak {r['peak_gb']} GB")
            failed = {k: v for k, v in same.items() if not v and k != "floats_bit_equal"}
            if failed:
                raise AssertionError(f"sharded: {name}: {failed}; ledger got {got} want "
                                     f"{want}; growth {r['growth']}")
            if name == "pod fp32":
                fp32_pod = {"cohorts": r["cohorts"], "tau": res.history["tau"]}
            rec["runs"][name] = {
                "executor": r["executor"], "same": same, "params_bit_equal": params_equal,
                "tables_bit_equal": tables_equal,
                "launches": r["launches"], "collectives": r["collectives"],
                "round_collectives": got, "chunks": r["chunks"], "captures": r["captures"],
                "peak_gb": r["peak_gb"], "history": res.history}
            total.update(r["launches"])
            del r, eng, res

        # the gate: tau0 8 leaves every other round's ghost exchange out
        gated_rounds = 4
        gated_evals = len([t for t in range(gated_rounds)
                           if t % SHARD_EVAL_EVERY == 0 or t == gated_rounds - 1])
        r = run("pod tau0 8", gated_rounds, gated_evals, "pod_sharded",
                method=api.method_config("fedais", tau0=SHARD_GATED_TAU0), mesh=pmesh)
        log_rounds = r["engine"]._sharded[True].round_log
        got, want = _shard_ledger_rounds(r["engine"], "fp32")
        gates = [x["gate"] for x in log_rounds]
        off_bytes = [sum(v[1] for k, v in x["collectives"].items() if k.startswith("ghost"))
                     for x in log_rounds if not x["gate"]]
        log(f"phase 14 sharded: {tag}: pod tau0 {SHARD_GATED_TAU0}: gates {gates}, ghost "
            f"bytes on the gated-off rounds {off_bytes}; ledger per round {got == want}; "
            f"graph keys {[c['key'] for c in r['captures']]} with collectives "
            f"{[c['collectives'] for c in r['captures']]}")
        if all(gates) or not any(gates) or any(off_bytes) or got != want:
            raise AssertionError(f"sharded: gated run: gates {gates}, off bytes {off_bytes}, "
                                 f"ledger got {got} want {want}")
        rec["gated"] = {"gates": gates, "round_collectives": got,
                        "captures": r["captures"], "history": r["result"].history}
        total.update(r["launches"])
        del r

        # the fault plan (dropout, stragglers): fused_faulty vs sharded_fused
        plan = FaultPlan(**SHARD_FAULTS)
        f_evals = len([t for t in range(SHARD_FAULT_ROUNDS)
                       if t % SHARD_EVAL_EVERY == 0 or t == SHARD_FAULT_ROUNDS - 1])
        fr = run("fedais fused_faulty", SHARD_FAULT_ROUNDS, f_evals, "fused_faulty",
                 faults=plan)
        fr_res, fr_events = fr["result"], fr["state"].fault_events.snapshot()
        total.update(fr["launches"])
        del fr
        checked = []
        real = api.FedEngine._run_chunk

        def watched(self, state, t0, n):
            # the tables before and after each chunk, and its dropped clients
            # that trained in none of its rounds
            before = [t.clone() for t in (state.hist.hist1, state.hist.age,
                                          state.hist.ghost_feat, state.prev_loss)]
            stop = real(self, state, t0, n)
            cohorts = self.selector.cohorts[-n:]
            dropped, trained = set(), set()
            for t, c in zip(range(t0, t0 + n), cohorts):
                mask = self.faults.drops(t, np.asarray(c))
                dropped |= {k for k, d in zip(c, mask) if d}
                trained |= {k for k, d in zip(c, mask) if not d}
            after = (state.hist.hist1, state.hist.age, state.hist.ghost_feat,
                     state.prev_loss)
            for k in sorted(dropped - trained):
                checked.append(all(torch.equal(a[k], b[k]) for a, b in zip(before, after)))
            return stop

        api.FedEngine._run_chunk = watched
        try:
            sf = method_run(torch, api, counters, g, fed, dev, "fedais", SHARD_FAULT_ROUNDS,
                            eval_every=SHARD_EVAL_EVERY, faults=plan, mesh=cmesh)
        finally:
            api.FedEngine._run_chunk = real
        comm.reset()
        same = _shard_compare(fr_res, sf["result"])
        same["fault_events"] = sf["state"].fault_events.snapshot() == fr_events
        same["executor"] = sf["executor"] == "sharded_fused"
        same["dropped_rows_unchanged"] = bool(checked) and all(checked)
        log(f"phase 14 sharded: {tag}: fedais under FaultPlan({SHARD_FAULTS}) "
            f"{SHARD_FAULT_ROUNDS} rounds, sharded_fused vs fused_faulty: {json.dumps(same)}; "
            f"fault events {json.dumps(fr_events)}; dropped clients checked {len(checked)}; "
            f"launches {json.dumps(sf['launches'])}")
        J = sf["engine"].mcfg.local_epochs
        want = {n: 0 for n in counters}
        want["spmm"] = SHARD_FAULT_ROUNDS * TRAIN_M * (2 + 3 * J) + 2 * f_evals
        want["ghost_pull"] = sf["sync_epochs"]
        failed = {k: v for k, v in same.items() if not v and k != "floats_bit_equal"}
        if failed or sf["launches"] != want or fr_events["n_dropped"] < 1:
            raise AssertionError(f"sharded: faults: {failed}, launches {sf['launches']} "
                                 f"(want {want}), events {fr_events}")
        rec["faults"] = {"plan": SHARD_FAULTS, "same": same, "fault_events": fr_events,
                         "dropped_checked": len(checked), "launches": sf["launches"]}
        total.update(sf["launches"])
        del sf

        if profile:
            peng = api.FedEngine(g, fed, "fedais", rounds=2, clients_per_round=TRAIN_M,
                                 seed=0, train_backend="spmm", eval_backend="spmm",
                                 device=dev, mesh=pmesh)
            pstate = peng.init_state()
            peng._run_chunk(pstate, 0, 1)
            peng._run_chunk(pstate, 1, 1)
            _, prof = _trace(torch, lambda: peng._run_chunk(pstate, 1, 1), 10)
            log(f"profile: {tag}: pod_sharded round replayed: wall {prof['wall_ms']} ms, "
                f"device busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']}); "
                f"host API calls {json.dumps(prof['api_calls'])}; NCCL kernels "
                f"{json.dumps(prof['nccl_kernels'])}; SpMM kernels "
                f"{json.dumps(prof['spmm_kernels'])}")
            for e in prof["top_device"]:
                log(f"profile: pod_sharded device {e['device_ms']} ms x{e['count']} {e['name']}")
            rec["profile"] = prof
            del peng, pstate
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    rec["spmm_launches"] = total["spmm"]
    rec["ghost_pull_launches"] = total["ghost_pull"]
    return rec, total["spmm"]


def examples_phase(torch, counters, dev, tag) -> tuple[dict, int]:
    """Phase 15: the port's two examples on the card, their aggregation on
    the SpMM kernel (``--backend spmm``); every counter set to 0 just
    before each and read just after.

    quickstart at its own configuration (Pubmed at 1/32 scale, 16 clients,
    5 a round) for ``EXAMPLE_ROUNDS`` rounds, FedAIS then FedAll: finite
    histories of that length, accuracies in [0, 1], SpMM launches counted
    and nothing else. variance_analysis on the whole Pubmed with
    ``VARIANCE_DRAWS`` noise draws: the error is ~0 without staleness and
    grows with it, and importance sampling's Eq. 7 objective is below
    uniform's, as the paper claims and the reference prints. Each run
    launches the SpMM and the ghost pull once a gated sync epoch of the
    federated training it runs (``sync_epochs``; quickstart's FedAIS syncs),
    nothing else."""
    import numpy as np

    from repro_torch.examples import quickstart, variance_analysis

    def zero():
        for c in counters.values():
            c.launches = 0

    def read(what, pulls):
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counters.items()}
        if (got["spmm"] <= 0 or got["ghost_pull"] != pulls
                or any(v for n, v in got.items() if n not in ("spmm", "ghost_pull"))):
            raise AssertionError(f"examples {what}: launches {got}; want SpMM (> 0) and "
                                 f"{pulls} ghost pulls only")
        return got

    argv = ["--device", str(dev), "--backend", "spmm"]
    zero()
    t0 = time.perf_counter()
    with sync_epochs() as epochs:
        runs = quickstart.run(quickstart.build_args(argv + ["--rounds", str(EXAMPLE_ROUNDS)]))
    quick_s = time.perf_counter() - t0
    if not epochs[0] > 0:
        raise AssertionError("examples quickstart: FedAIS synced no ghost")
    quick_launches = read("quickstart", epochs[0])
    quick = {}
    for method, res in runs.items():
        h = res.history
        acc = np.asarray(h["test_acc"], np.float64)
        if (len(h["round"]) != EXAMPLE_ROUNDS or not np.isfinite(h["test_loss"]).all()
                or not ((acc >= 0) & (acc <= 1)).all()):
            raise AssertionError(f"examples quickstart {method}: history {h}")
        quick[method] = {"acc": res.final["acc"], "f1": res.final["f1"],
                         "comm_total_bytes": res.final["comm_total_bytes"],
                         "comm_embed_bytes": res.final["comm_embed_bytes"],
                         "tau": h["tau"], "test_acc": h["test_acc"]}
    log(f"phase 15 examples: {tag}: quickstart --backend spmm {EXAMPLE_ROUNDS} rounds in "
        f"{quick_s:.2f} s: " + "; ".join(
            f"{m} acc {r['acc']} f1 {r['f1']} comm {r['comm_total_bytes']} B (embeddings "
            f"{r['comm_embed_bytes']} B) tau {r['tau']}" for m, r in quick.items())
        + f"; launches {json.dumps(quick_launches)}")

    zero()
    t0 = time.perf_counter()
    with sync_epochs() as epochs:
        var = variance_analysis.run(variance_analysis.build_args(
            argv + ["--scale", str(VARIANCE_SCALE), "--rounds", str(VARIANCE_DRAWS)]))
    var_s = time.perf_counter() - t0
    var_launches = read("variance_analysis", epochs[0])
    errs = [r["err"] for r in var["staleness"]]
    log(f"phase 15 examples: variance_analysis --backend spmm --scale {VARIANCE_SCALE} "
        f"--rounds {VARIANCE_DRAWS} in {var_s:.2f} s: errors by staleness "
        f"{json.dumps({r['staleness']: r['err'] for r in var['staleness']})}, logit "
        f"variance {json.dumps({r['staleness']: r['logit_variance'] for r in var['staleness']})}; "
        f"Eq. 7 objective importance {var['v_imp']} < uniform {var['v_uni']} (reduction "
        f"{var['reduction']}); launches {json.dumps(var_launches)}")
    if (not np.isfinite(errs).all() or errs[0] > 1e-3
            or not all(a < b for a, b in zip(errs, errs[1:]))):
        raise AssertionError(f"examples variance_analysis: errors by staleness {errs}")
    if not var["v_imp"] < var["v_uni"]:
        raise AssertionError(f"examples variance_analysis: importance's Eq. 7 objective "
                             f"{var['v_imp']} not below uniform's {var['v_uni']}")
    launches = quick_launches["spmm"] + var_launches["spmm"]
    return {"quickstart": quick, "quickstart_s": quick_s, "quickstart_launches": quick_launches,
            "variance": var, "variance_s": var_s, "variance_launches": var_launches,
            "ghost_pull_launches": quick_launches["ghost_pull"]
            + var_launches["ghost_pull"]}, launches


# LM training (phase 16): internvl2-2b whole at its training shape (2 x (256
# image + 2,048 text) tokens; the image embeddings drawn, see lm_train_phase), AdamW with fp32 moments under
# linear_warmup_cosine at 3e-4, 4 steps (the first is the warm-up); the
# kernel-vs-plain gradient check at 2 of its 24 layers; mini on the card
# against the CPU; the example at a cut size
TRAIN_ARCH, TRAIN_BATCH, TRAIN_TEXT, TRAIN_STEPS, TRAIN_LR = "internvl2-2b", 2, 2048, 4, 3e-4
TRAIN_CHECK_LAYERS = 2
# gemma3-12b at full width, one 5:1 local:global unit of its 48 layers (one
# card cannot hold the whole model's training state: 11.6 B params x 12
# bytes), at the same batch and schedule; its first 2 (local) blocks in the
# kernel-vs-plain check
GEMMA_ARCH, GEMMA_TRAIN_LAYERS = "gemma3-12b", 6
ZERO_IMAGE_LAYERS = 8
# rwkv6-1.6b whole at the same batch and text length (attention-free: no
# image tokens), and launch.train on its smoke configuration
RWKV_ARCH = "rwkv6-1.6b"
RWKV_SMOKE_TRAIN = dict(steps=4, batch=2, seq_len=64)
MINI_TRAIN = dict(steps=4, batch=2, seq_len=64)
MINI_FED = dict(steps=8, batch=2, seq_len=64, clients=2, tau0=2)
TOL_MINI = 1e-4


def _counts(counters) -> dict:
    return {n: c.launches for n, c in counters.items()}


BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkdv")
# the wrappers that count their launches by route: the forward and the
# backward pair
ROUTED = ("flash_attention", *BWD_KERNELS)


def _routes(counters) -> dict:
    """{flash kernel wrapper: {route: launches}}, the wrappers' route counts."""
    return {n: dict(counters[n].routes) for n in ROUTED}


def _routes_since(counters, before) -> dict:
    return {n: {r: c - before[n][r] for r, c in now.items()}
            for n, now in _routes(counters).items()}


def _zero(counters) -> None:
    for c in counters.values():
        c.launches = 0


def flash_bwd_shapes(torch, fops, fref, timer, gen) -> list:
    """Phase 16's per-op rows: the backward kernels (and the forward's lse)
    at the training path's shapes, each with the route it must run: the
    bf16 tensor-core pair for bf16 at any hd up to 256 in a layout TMA can
    take (gemma3-12b's hd 240 and recurrentgemma-2b's hd 256 at 256), the
    fp32 tensor-core pair (3×TF32) for fp32 in such a layout, the FMA
    kernels for either type one element off a 16-byte boundary."""
    bf16, f32 = torch.bfloat16, torch.float32
    tc, x3, fma = "tensor_core", "tf32x3", "fma"
    cases = [
        # internvl2-2b's training shape: 256 image + 2,048 text tokens
        ("internvl2_train_bf16", 2, 2304, 16, 8, 128, True, None, bf16, 5, tc),
        ("internvl2_train_fp32", 2, 2304, 16, 8, 128, True, None, f32, 3, x3),
        ("mini_fp32", 8, 256, 6, 2, 64, True, None, f32, 10, x3),
        # gemma3-12b's local block (hd 240 runs at 256)
        ("gemma3_local_bf16", 2, 2048, 16, 8, 240, True, 1024, bf16, 5, tc),
        # whisper-large-v3's cross attention and encoder, unmasked
        ("whisper_cross_bf16", 2, 224, 20, 20, 64, False, None, bf16, 10, tc, 1500),
        ("whisper_enc_bf16", 2, 1500, 20, 20, 64, False, None, bf16, 5, tc),
        # causal with Sq != Sk both ways; the second's last rows keep no key
        ("causal_cross_fp32", 2, 200, 8, 4, 64, True, None, f32, 10, x3, 333),
        ("causal_cross_bf16", 2, 200, 8, 4, 64, True, None, bf16, 10, tc, 333),
        ("causal_past_sk_window_fp32", 2, 333, 8, 4, 128, True, 64, f32, 10, x3, 200),
        ("causal_past_sk_window_bf16", 2, 333, 8, 4, 128, True, 64, bf16, 10, tc, 200),
        # an hd between the widths (80 runs at 128; TMA zero-fills the
        # columns past hd), windowed, ragged S
        ("ragged_hd80_window_bf16", 1, 300, 4, 2, 80, True, 100, bf16, 10, tc),
        # (the rows draw their inputs in turn from one generator: a row
        # added at the end leaves every other row's inputs as they were)
        # gemma3-12b's global block; recurrentgemma-2b's local attention,
        # MQA 10/1 at hd 256
        ("gemma3_global_bf16", 2, 2048, 16, 8, 240, True, None, bf16, 5, tc),
        ("recurrentgemma_local_bf16", 2, 2048, 10, 1, 256, True, 2048, bf16, 5, tc),
        # hd 136 runs at 256: TMA zero-fills the columns past hd, most of
        # the third panel and all of the fourth; ragged S
        ("ragged_hd136_bf16", 1, 300, 4, 2, 136, True, None, bf16, 10, tc),
        # gemma3-12b's local block in fp32, and in bf16 one element off a
        # 16-byte boundary: the FMA pair (the route bf16 took there before)
        ("gemma3_local_fp32", 2, 2048, 16, 8, 240, True, 1024, f32, 3, x3),
        ("gemma3_local_bf16_unaligned", 2, 2048, 16, 8, 240, True, 1024, bf16, 3, fma,
         None, True),
        # gemma3-12b's global block in fp32; internvl2-2b's fp32 shape one
        # element off a 16-byte boundary: the FMA pair, timed
        ("gemma3_global_fp32", 2, 2048, 16, 8, 240, True, None, f32, 3, x3),
        ("internvl2_train_fp32_unaligned", 2, 2304, 16, 8, 128, True, None, f32, 3, fma,
         None, True),
    ]
    rows = []
    for c in cases:
        rows.append(check_flash_bwd(torch, fops, fref, timer, gen, *c[:11],
                                    Sk=c[11] if len(c) > 11 else None,
                                    unaligned=len(c) > 12 and c[12]))
        torch.cuda.empty_cache()
    return rows


C7_DRAWS = 16


def c7_probe(torch, fops, fref, dev) -> dict:
    """ROADMAP C7, recorded: whisper-large-v3's unmasked encoder shape in
    bf16 (``whisper_enc_bf16``: B 2, S 1,500, H 20, hd 64) over
    ``C7_DRAWS`` draws from a generator of its own (so no gated row's
    draws move), each held to the row's gate as ``check_flash_bwd`` forms
    it (rtol one bf16 ulp, atol 4 x the fp32 FMA pair's error on the same
    inputs): per draw and gradient the elements beyond the gate and the
    worst (|err| - rtol |want|) / atol (beyond the gate when > 1)."""
    gen = torch.Generator(device=dev).manual_seed(77)
    B, S, H, hd = 2, 1500, 20, 64
    kw = {"causal": False, "window": None}
    draws = []
    for _ in range(C7_DRAWS):
        q, k, v, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        o, lse = fops.flash_attention_lse(q, k, v, **kw)
        got = fops.flash_bwd(q, k, v, o, lse, do, **kw)
        want = fref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        atol, e32, e_x3, _ = bf16_gate_atol(torch, fops, fref, q, k, v, o, lse, do, kw, "c7")
        row = {"atol": atol, "fp32_max_abs_err": e32, "fp32_tf32x3_max_abs_err": e_x3,
               "beyond": {}, "worst_ratio": {}}
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs()
            excess = (err - RTOL_BF16 * w.float().abs()) / atol
            row["beyond"][gname] = int((excess > 1).sum())
            row["worst_ratio"][gname] = float(excess.max())
        draws.append(row)
        del q, k, v, do, o, lse, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    beyond = [sum(d["beyond"].values()) for d in draws]
    worst = [max(d["worst_ratio"].values()) for d in draws]
    out = {"draws": draws, "draws_beyond": sum(1 for b in beyond if b),
           "elements_beyond": sum(beyond), "worst_ratio_max": max(worst),
           "worst_ratio_median": sorted(worst)[len(worst) // 2],
           "atol_min": min(d["atol"] for d in draws), "atol_max": max(d["atol"] for d in draws)}
    log(f"phase 16 lm-train: C7 probe (recorded): whisper_enc_bf16's shape over {C7_DRAWS} "
        f"draws of its own: {out['draws_beyond']} draws with elements beyond the gate "
        f"({out['elements_beyond']} elements: "
        f"{json.dumps([d['beyond'] for d in draws if sum(d['beyond'].values())])}); worst "
        f"(|err| - rtol |want|) / atol per draw {json.dumps(worst)} (median "
        f"{out['worst_ratio_median']}); atol {out['atol_min']} to {out['atol_max']}")
    return out


def wkv6_bwd_shapes(torch, wops, wref, timer, gen) -> list:
    """Phase 16's WKV6 rows: the training forward and the backward kernels
    at rwkv6-1.6b's training shape (B 2, T 2,048, H 32, N 64; d 2,048) in
    bf16 and fp32, with an incoming gradient of S, at a ragged T (2,047
    and 37), at N 32 and 128 at the same width, and with w near 1 (0.999)
    and near 0 (1e-6)."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("rwkv6_train_bf16", 2, 2048, 32, 64, bf16, None, False, 10, 1),
        ("rwkv6_train_fp32", 2, 2048, 32, 64, f32, None, False, 10, 1),
        ("rwkv6_train_ds_bf16", 2, 2048, 32, 64, bf16, None, True, 5, 1),
        ("ragged_t2047_bf16", 2, 2047, 32, 64, bf16, None, False, 5, 1),
        ("ragged_t37_fp32", 2, 37, 32, 64, f32, None, True, 10, 2),
        ("n32_bf16", 2, 2048, 64, 32, bf16, None, False, 5, 1),
        ("n128_bf16", 2, 2048, 16, 128, bf16, None, True, 5, 1),
        ("w_near1_fp32", 2, 2048, 32, 64, f32, 0.999, False, 5, 1, True),
        ("w_near0_fp32", 2, 2048, 32, 64, f32, 1e-6, True, 5, 1),
    ]
    rows = []
    for c in cases:
        rows.append(check_wkv6_bwd(torch, wops, wref, timer, gen, *c))
        torch.cuda.empty_cache()
    return rows


def _grad_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _grad_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _grad_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def train_kernel_vs_plain(torch, lm, cfg, dev, batch, tag) -> dict:
    """At ``TRAIN_CHECK_LAYERS`` layers of the full-width config, one
    batch's loss and every param's gradient through the kernels against the
    plain path (``use_kernel=False``: ``attention_ref`` under autograd), on
    the same params: relative L2 within ``TOL_BLOCK_REL`` (bf16 sums in
    another order, rounded)."""
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(1), cfg, dev)
    loss_k, _, g_k = lm.loss_and_grads(params, cfg, batch, use_kernel=True)
    loss_p, _, g_p = lm.loss_and_grads(params, cfg, batch, use_kernel=False)
    torch.cuda.synchronize()
    errs = {name: rel_err(torch, a, b)
            for (name, a), (_, b) in zip(_grad_leaves(g_k), _grad_leaves(g_p))}
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(errs, key=errs.get)
    if loss_err > TOL_BLOCK_REL or errs[worst] > TOL_BLOCK_REL:
        raise AssertionError(f"lm-train kernel vs plain: loss relative error {loss_err}, "
                             f"worst gradient {worst} {errs[worst]} beyond {TOL_BLOCK_REL}")
    log(f"phase 16 lm-train: {tag}: {cfg.arch_id} at {cfg.n_layers} layers, full width "
        f"{cfg.dtype}: kernel path vs plain path, loss {float(loss_k)} vs {float(loss_p)} "
        f"(relative {loss_err}); {len(errs)} gradients, worst relative L2 {errs[worst]} "
        f"({worst}), median {sorted(errs.values())[len(errs) // 2]}")
    return {"layers": cfg.n_layers, "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": loss_err, "grad_rel_l2": errs}


def rwkv_kernel_vs_plain(torch, lm, cfg, dev, batch, tag) -> dict:
    """rwkv6-1.6b at ``TRAIN_CHECK_LAYERS`` layers, full width: one batch's
    loss and every param's gradient through the WKV6 kernels against the
    plain path (``use_kernel=False``: autograd through ``wkv_scan``), on
    the same params (drawn in bf16), twice: with the model in fp32 (the
    params widened, ``cfg.dtype`` float32; the kernels take fp32 r/k/v),
    loss and gradients within ``TOL_RWKV_FP32_REL``; and in bf16, the
    model's own type, the loss within ``TOL_BLOCK_REL`` and the gradients
    recorded beside each bf16 path's distance to the fp32 plain path."""
    import dataclasses

    from repro_torch.utils.tree import tree_map

    params = lm.init_lm(torch.Generator(device=dev).manual_seed(1), cfg, dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wide = tree_map(lambda t: t.float(), params)
    runs = {}
    for kind, c, p in (("fp32", cfg32, wide), ("bf16", cfg, params)):
        for path, use in (("kernel", True), ("plain", False)):
            loss, _, g = lm.loss_and_grads(p, c, batch, use_kernel=use)
            runs[kind, path] = (float(loss), dict(_grad_leaves(g)))
    torch.cuda.synchronize()

    def compare(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        errs = {n: rel_err(torch, ga[n], gb[n]) for n in gb}
        worst = max(errs, key=errs.get)
        return {"loss": [la, lb], "loss_rel_err": abs(la - lb) / abs(lb), "grad_rel_l2": errs,
                "worst": [worst, errs[worst]], "median": sorted(errs.values())[len(errs) // 2]}

    out = {"layers": cfg.n_layers, "tol_fp32": TOL_RWKV_FP32_REL,
           "fp32": compare(("fp32", "kernel"), ("fp32", "plain")),
           "bf16": compare(("bf16", "kernel"), ("bf16", "plain"))}
    for path in ("kernel", "plain"):
        c = compare(("bf16", path), ("fp32", "plain"))
        out[f"bf16_{path}_to_fp32_plain"] = {k: c[k] for k in ("worst", "median")}
    f32, b16 = out["fp32"], out["bf16"]
    if (f32["loss_rel_err"] > TOL_RWKV_FP32_REL or f32["worst"][1] > TOL_RWKV_FP32_REL
            or b16["loss_rel_err"] > TOL_BLOCK_REL):
        raise AssertionError(f"lm-train {cfg.arch_id} kernel vs plain: fp32 loss relative "
                             f"error {f32['loss_rel_err']}, worst gradient {f32['worst']} (limit "
                             f"{TOL_RWKV_FP32_REL}); bf16 loss relative error "
                             f"{b16['loss_rel_err']} (limit {TOL_BLOCK_REL})")
    log(f"phase 16 lm-train: {tag}: {cfg.arch_id} at {cfg.n_layers} layers, full width, "
        f"kernel path vs plain path: fp32 loss relative error {f32['loss_rel_err']}, "
        f"{len(f32['grad_rel_l2'])} gradients, worst relative L2 {f32['worst']}, median "
        f"{f32['median']} (limit {TOL_RWKV_FP32_REL}); bf16 (recorded) loss relative error "
        f"{b16['loss_rel_err']}, worst {b16['worst']}, median {b16['median']}; bf16 to the "
        f"fp32 plain path: kernel path worst {out['bf16_kernel_to_fp32_plain']['worst']}, "
        f"plain path worst {out['bf16_plain_to_fp32_plain']['worst']}")
    return out


def mini_card_vs_cpu(torch, counters, dev, tag) -> dict:
    """``launch.train``'s ``train`` and ``train_federated`` on ``mini``, on
    the card and on the CPU, from the same initial params (handed in
    through ``_init_params``): losses within ``TOL_MINI``; tau, steps and
    sync events equal; the backward kernels launched once per attention
    block per train step on the card, the forward at least as often, every
    launch on the 3×TF32 route."""
    import argparse as ap

    import numpy as np

    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm

    cfg = train_mod.mini_config()
    host = lm_params_to_numpy(lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"))
    real = train_mod._init_params
    train_mod._init_params = lambda cfg, seed, device: lm_params_from_numpy(host, cfg, device)
    base = dict(arch="mini", lr=3e-4, seed=0, log_every=1000, ckpt_dir=None,
                ckpt_every=1000, fed=False, clients=2, tau0=2)
    out = {}
    try:
        for name, fn, kw in (("train", train_mod.train, MINI_TRAIN),
                             ("train_federated", train_mod.train_federated, MINI_FED)):
            runs = {}
            for where in (str(dev), "cpu"):
                _zero(counters)
                routes0 = _routes(counters)
                t0 = time.perf_counter()
                runs[where] = fn(ap.Namespace(**{**base, **kw, "device": where}))
                torch.cuda.synchronize()
                runs[where]["seconds"] = time.perf_counter() - t0
                runs[where]["launches"] = _counts(counters)
                runs[where]["routes"] = _routes_since(counters, routes0)
            card, cpu = runs[str(dev)], runs["cpu"]
            n_layers = cfg.n_layers
            if name == "train":
                a, b = np.asarray(card["losses"]), np.asarray(cpu["losses"])
                steps = len(a)
                same = {}
            else:
                a = np.asarray([h["loss"] for h in card["history"]])
                b = np.asarray([h["loss"] for h in cpu["history"]])
                steps = sum(len(p) for r in card["picks"] for p in r)
                same = {k: [h[k] for h in card["history"]] == [h[k] for h in cpu["history"]]
                        for k in ("tau", "steps", "round")}
                same["sync_events"] = card["sync_events"] == cpu["sync_events"]
                same["picks"] = card["picks"] == cpu["picks"]
            err = float(np.abs(a - b).max())
            got = card["launches"]
            want_bwd = steps * n_layers
            # mini is fp32: every forward and backward launch on the 3xTF32 route
            want_routes = {n: {"fma": 0, "tensor_core": 0, "tf32x3": want_bwd}
                           for n in BWD_KERNELS}
            want_routes["flash_attention"] = {"fma": 0, "tensor_core": 0,
                                              "tf32x3": got["flash_attention"]}
            if (a.shape != b.shape or not np.isfinite(a).all() or err > TOL_MINI
                    or not all(v for k, v in same.items() if k != "picks")
                    or got["flash_bwd_dq"] != want_bwd or got["flash_bwd_dkdv"] != want_bwd
                    or card["routes"] != want_routes
                    or got["flash_attention"] < want_bwd or got["wkv6"]
                    or got["wkv6_bwd"] or got["spmm"]
                    or any(cpu["launches"].values())):
                raise AssertionError(f"lm-train mini {name}: card vs CPU max loss diff {err}, "
                                     f"same {same}, card launches {got} (want {want_bwd} of "
                                     f"each backward kernel), routes {card['routes']} (want "
                                     f"{want_routes}), CPU {cpu['launches']}")
            log(f"phase 16 lm-train: {tag}: mini {name} {json.dumps(kw)}: card vs CPU max "
                f"loss diff {err} over {len(a)} {'steps' if name == 'train' else 'rounds'}; "
                f"{json.dumps(same)}; card launches {json.dumps(got)}, routes "
                f"{json.dumps(card['routes'])}; "
                f"{card['seconds']:.2f} s on the card, {cpu['seconds']:.2f} s on the CPU")
            out[name] = {"max_loss_diff": err, "same": same, "launches": got,
                         "routes": card["routes"],
                         "card_s": card["seconds"], "cpu_s": cpu["seconds"],
                         "losses_card": a.tolist(), "losses_cpu": b.tolist()}
    finally:
        train_mod._init_params = real
    return out


class PlainCalls:
    """Counts calls of the WKV plain versions (``wkv6_ref``, ``wkv6_bwd_ref``
    as the kernels' wrapper reaches them, ``wkv_scan``, ``wkv_chunked_scan``
    as the RWKV block does) while it is entered: the card's main path must
    make none."""

    def __init__(self):
        from repro_torch.kernels.wkv6 import ops as wops
        from repro_torch.models import rwkv as rwkv_mod

        self.slots = [(wops, "wkv6_ref"), (wops, "wkv6_bwd_ref"), (rwkv_mod, "wkv_scan"),
                      (rwkv_mod, "wkv_chunked_scan")]
        self.calls = {name: 0 for _, name in self.slots}

    def __enter__(self):
        self.real = [getattr(mod, name) for mod, name in self.slots]
        for (mod, name), fn in zip(self.slots, self.real):
            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.slots, self.real):
            setattr(mod, name, fn)


def rwkv_train_whole(torch, lm, counters, get_config, dev, tag, profile) -> tuple[dict, dict]:
    """The RWKV main path: rwkv6-1.6b whole (24 layers, d 2,048, 32 heads of
    64, vocab 65,536, bf16, AdamW moments fp32) for ``TRAIN_STEPS`` steps of
    ``make_train_step`` on ``TRAIN_BATCH`` x ``TRAIN_TEXT`` ``TokenPipeline``
    tokens, the counts from 0: finite losses and grad norms, exactly one
    launch of each WKV6 kernel (the forward, the backward) per layer a step
    and nothing else, no plain WKV version called; first and steady step
    ms, tokens/s, peak memory (no remat). Returns (record, launches)."""
    from repro_torch.data import TokenPipeline, make_lm_batch
    from repro_torch.optim import linear_warmup_cosine

    cfg = get_config(RWKV_ARCH)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_TEXT, TRAIN_BATCH, seed=0)
    t0 = time.perf_counter()
    params, opt = lm.init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                      torch.float32, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = lm.make_train_step(cfg, linear_warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1,
                                                        TRAIN_STEPS))
    layers = cfg.n_layers
    want = {n: 0 for n in counters}
    want.update(wkv6=layers, wkv6_bwd=layers)
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    steps = []
    with PlainCalls() as plain:
        for i in range(TRAIN_STEPS):
            batch = make_lm_batch(pipe, i, dev)
            before = _counts(counters)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            got = {n: c - before[n] for n, c in _counts(counters).items()}
            row = {"step": i, "ms": ms, "loss": float(m["loss"]), "grad_norm":
                   float(m["grad_norm"]), "lr": m["lr"], "launches": got}
            steps.append(row)
            if (got != want or not math.isfinite(row["loss"])
                    or not (math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0)):
                raise AssertionError(f"lm-train {RWKV_ARCH} step {i}: {row}; want launches "
                                     f"{want}")
    launches = _counts(counters)
    if any(plain.calls.values()):
        raise AssertionError(f"lm-train {RWKV_ARCH}: the main path called a plain WKV "
                             f"version: {plain.calls}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sorted(r["ms"] for r in steps[1:])[len(steps[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_TEXT
    rec = {"arch": RWKV_ARCH, "params": cfg.param_count(), "dtype": cfg.dtype,
           "moments": "float32", "remat": cfg.remat, "batch": TRAIN_BATCH,
           "text_tokens": TRAIN_TEXT, "init_s": init_s, "steps": steps,
           "first_step_ms": steps[0]["ms"], "steady_step_ms": steady,
           "tokens_per_s": tokens / (steady / 1e3), "peak_memory_gb": peak_gb,
           "launches": launches, "plain_calls": plain.calls}
    log(f"phase 16 lm-train: {tag}: {RWKV_ARCH} whole ({cfg.param_count():,} params, "
        f"{cfg.dtype}, AdamW moments fp32, remat {cfg.remat}) batch {TRAIN_BATCH} x "
        f"{TRAIN_TEXT} tokens, {TRAIN_STEPS} steps: losses {[r['loss'] for r in steps]} grad "
        f"norms {[r['grad_norm'] for r in steps]}; first step {steps[0]['ms']:.1f} ms, steady "
        f"{steady:.1f} ms ({rec['tokens_per_s']:.0f} tokens/s); peak memory {peak_gb:.2f} "
        f"GB; launches a step {json.dumps(want)}, in all {json.dumps(launches)}; plain WKV "
        f"calls {json.dumps(plain.calls)}; init {init_s:.1f} s")
    if profile:
        batch = make_lm_batch(pipe, TRAIN_STEPS, dev)
        (params, opt, _), prof = _trace(torch, lambda: step(params, opt, batch), 16)
        rec["profile"] = prof
        log(f"profile: {tag}: {RWKV_ARCH} one steady train step: wall {prof['wall_ms']} ms, "
            f"device busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']}); "
            f"host calls {json.dumps(prof['api_calls'])}")
        for e in prof["top_device"]:
            log(f"profile: device {e['device_ms']} ms x{e['count']} {e['name']}")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def rwkv_train_card_vs_cpu(torch, counters, dev, tag) -> dict:
    """``launch.train.train`` on rwkv6-1.6b's smoke configuration (fp32, 2
    layers, N 32), on the card and on the CPU from the same initial params:
    losses within ``TOL_MINI``, the same steps; on the card exactly one
    launch of each WKV6 kernel per layer a step and nothing else, on the CPU
    none."""
    import argparse as ap

    import numpy as np

    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm

    cfg = train_mod.get_train_config(RWKV_ARCH)
    host = lm_params_to_numpy(lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"))
    real = train_mod._init_params
    train_mod._init_params = lambda cfg, seed, device: lm_params_from_numpy(host, cfg, device)
    args = dict(arch=RWKV_ARCH, lr=3e-4, seed=0, log_every=1000, ckpt_dir=None,
                ckpt_every=1000, fed=False, clients=2, tau0=2, **RWKV_SMOKE_TRAIN)
    runs = {}
    try:
        for where in (str(dev), "cpu"):
            _zero(counters)
            t0 = time.perf_counter()
            runs[where] = train_mod.train(ap.Namespace(**args, device=where))
            torch.cuda.synchronize()
            runs[where]["seconds"] = time.perf_counter() - t0
            runs[where]["launches"] = _counts(counters)
    finally:
        train_mod._init_params = real
    card, cpu = runs[str(dev)], runs["cpu"]
    a, b = np.asarray(card["losses"]), np.asarray(cpu["losses"])
    err = float(np.abs(a - b).max()) if a.shape == b.shape else math.inf
    want = {n: 0 for n in counters}
    want.update(wkv6=RWKV_SMOKE_TRAIN["steps"] * cfg.n_layers,
                wkv6_bwd=RWKV_SMOKE_TRAIN["steps"] * cfg.n_layers)
    if (len(a) != RWKV_SMOKE_TRAIN["steps"] or a.shape != b.shape or not np.isfinite(a).all()
            or err > TOL_MINI or card["launches"] != want or any(cpu["launches"].values())):
        raise AssertionError(f"lm-train {RWKV_ARCH} launch.train card vs CPU: max loss diff "
                             f"{err}, card launches {card['launches']} (want {want}), CPU "
                             f"{cpu['launches']}, losses {a.tolist()} vs {b.tolist()}")
    log(f"phase 16 lm-train: {tag}: launch.train --arch {RWKV_ARCH} (smoke config) "
        f"{json.dumps(RWKV_SMOKE_TRAIN)}: card vs CPU max loss diff {err}; card launches "
        f"{json.dumps(card['launches'])}; {card['seconds']:.2f} s on the card, "
        f"{cpu['seconds']:.2f} s on the CPU")
    return {"max_loss_diff": err, "launches": card["launches"], "card_s": card["seconds"],
            "cpu_s": cpu["seconds"], "losses_card": a.tolist(), "losses_cpu": b.tolist()}


def flash_train_whole(torch, lm, counters, cfg, batch_at, dev, tag, profile) -> tuple:
    """An attention LM's training main path: ``cfg`` (bf16, AdamW moments
    fp32) for ``TRAIN_STEPS`` steps of ``make_train_step`` under
    ``linear_warmup_cosine``, ``batch_at(i)`` the i-th batch, the counts from
    0: finite losses and grad norms > 0, exactly one forward, one dq and
    one dk/dv flash launch a layer a step and nothing else, every launch on
    the bf16 tensor-core route; first and steady step ms, tokens/s,
    peak memory; with ``profile`` one more step traced. Returns (record,
    launches)."""
    from repro_torch.optim import linear_warmup_cosine

    t0 = time.perf_counter()
    params, opt = lm.init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                      torch.float32, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = lm.make_train_step(cfg, linear_warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1,
                                                        TRAIN_STEPS))
    layers = cfg.n_layers
    want = {n: 0 for n in counters}
    want.update(flash_attention=layers, flash_bwd_dq=layers, flash_bwd_dkdv=layers)
    want_routes = {n: {"fma": 0, "tensor_core": layers, "tf32x3": 0} for n in ROUTED}
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    routes0 = _routes(counters)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = batch_at(i)
        before, before_routes = _counts(counters), _routes(counters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got = {n: c - before[n] for n, c in _counts(counters).items()}
        routes = _routes_since(counters, before_routes)
        row = {"step": i, "ms": ms, "loss": float(m["loss"]), "xent": float(m["xent"]),
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"], "launches": got,
               "routes": routes}
        steps.append(row)
        if (got != want or routes != want_routes or not math.isfinite(row["loss"])
                or not (math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0)):
            raise AssertionError(f"lm-train {cfg.arch_id} step {i}: {row}; want launches "
                                 f"{want}, routes {want_routes}")
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sorted(r["ms"] for r in steps[1:])[len(steps[1:]) // 2]
    text = TRAIN_BATCH * TRAIN_TEXT
    rec = {"arch": cfg.arch_id, "layers": layers, "params": cfg.param_count(),
           "dtype": cfg.dtype, "moments": "float32", "batch": TRAIN_BATCH,
           "image_tokens": cfg.n_image_tokens, "text_tokens": TRAIN_TEXT, "init_s": init_s,
           "steps": steps, "first_step_ms": steps[0]["ms"], "steady_step_ms": steady,
           "text_tokens_per_s": text / (steady / 1e3),
           "all_tokens_per_s": TRAIN_BATCH * (TRAIN_TEXT + cfg.n_image_tokens) / (steady / 1e3),
           "peak_memory_gb": peak_gb, "launches": launches,
           "routes": _routes_since(counters, routes0)}
    image = f"{cfg.n_image_tokens} image + " if cfg.n_image_tokens else ""
    log(f"phase 16 lm-train: {tag}: {cfg.arch_id} at {layers} layers ({cfg.param_count():,} "
        f"params, {cfg.dtype}, AdamW moments fp32) batch {TRAIN_BATCH} x ({image}"
        f"{TRAIN_TEXT} text) tokens, {TRAIN_STEPS} steps: losses "
        f"{[r['loss'] for r in steps]} grad norms {[r['grad_norm'] for r in steps]} lr "
        f"{[r['lr'] for r in steps]}; first step {steps[0]['ms']:.1f} ms, steady "
        f"{steady:.1f} ms ({rec['text_tokens_per_s']:.0f} text tokens/s); peak "
        f"memory {peak_gb:.2f} GB; launches a step {json.dumps(want)}, in all "
        f"{json.dumps(launches)}, every launch on the tensor-core route "
        f"{json.dumps(rec['routes'])}; init {init_s:.1f} s")
    if profile:
        batch = batch_at(TRAIN_STEPS)
        (params, opt, _), prof = _trace(torch, lambda: step(params, opt, batch), 16)
        rec["profile"] = prof
        log(f"profile: {tag}: {cfg.arch_id} one steady train step: wall {prof['wall_ms']} ms, "
            f"device busy {prof['device_busy_ms']} ms (share {prof['device_busy_share']}); "
            f"host calls {json.dumps(prof['api_calls'])}")
        for e in prof["top_device"]:
            log(f"profile: device {e['device_ms']} ms x{e['count']} {e['name']}")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def lm_train_phase(torch, counters, get_config, get_smoke_config, dev, tag,
                   profile) -> tuple[dict, dict]:
    """Phase 16: LM training on the card. Returns (record, {main path: its
    launches}) for internvl2-2b's, gemma3-12b's and rwkv6-1.6b's."""
    import dataclasses

    from repro_torch.data import TokenPipeline, make_lm_batch
    from repro_torch.examples import train_lm_federated
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import ref as wref
    from repro_torch.models import lm

    rec = {}
    timer = Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(16)
    rec["flash_bwd_shapes"] = flash_bwd_shapes(torch, fops, fref, timer, gen)
    rec["c7_probe"] = c7_probe(torch, fops, fref, dev)
    rec["wkv6_bwd_shapes"] = wkv6_bwd_shapes(torch, wops, wref, timer, gen)
    del timer
    torch.cuda.empty_cache()

    cfg = get_config(TRAIN_ARCH)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_TEXT, TRAIN_BATCH, seed=0)
    # the image embeddings: a seeded draw at the embedding table's init scale
    # (0.02), standing in for the vision projector's output. Zero embeddings
    # (what serving feeds) keep the image rows exactly 0 through every
    # layer; RMSNorm's gradient at 0 is 1/sqrt(eps) = 1000, so the gradient
    # into those rows grows about 10^3 a layer through their K/V and
    # overflows fp32 within the 24 layers, on either path (recorded below)
    image = (torch.randn((TRAIN_BATCH, cfg.n_image_tokens, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(23)) * 0.02
             ).to(cfg.torch_dtype)

    def batch_at(i, img=image):
        return dict(make_lm_batch(pipe, i, dev), image_embeds=img)

    # the kernel path's gradients against the plain path's, 2 layers
    cut, reduced = full_width(get_config, TRAIN_ARCH, TRAIN_CHECK_LAYERS)
    rec["kernel_vs_plain"] = train_kernel_vs_plain(torch, lm, cut, dev, batch_at(0), tag)
    rec["kernel_vs_plain"]["reduced"] = reduced
    gc.collect()
    torch.cuda.empty_cache()
    # the same for rwkv6-1.6b: WKV6's forward and backward kernels against
    # autograd through the plain scan
    rcut, rreduced = full_width(get_config, RWKV_ARCH, TRAIN_CHECK_LAYERS)
    rbatch = make_lm_batch(TokenPipeline(rcut.vocab_size, TRAIN_TEXT, TRAIN_BATCH, seed=0), 0,
                           dev)
    rec["rwkv_kernel_vs_plain"] = rwkv_kernel_vs_plain(torch, lm, rcut, dev, rbatch, tag)
    rec["rwkv_kernel_vs_plain"]["reduced"] = rreduced
    gc.collect()
    torch.cuda.empty_cache()
    # recorded: the largest |d loss / d image embedding| with drawn and with
    # zero image embeddings, on both paths, at ZERO_IMAGE_LAYERS layers. The
    # growth lives in the image rows' activation gradients; the params'
    # gradients see it only once it overflows (it meets activations of 0)
    probe, _ = full_width(get_config, TRAIN_ARCH, ZERO_IMAGE_LAYERS)
    pparams = lm.init_lm(torch.Generator(device=dev).manual_seed(1), probe, dev)
    norms = {}
    for name, img in (("drawn", image), ("zero", torch.zeros_like(image))):
        for path, use in (("kernel", True), ("plain", False)):
            leaf = img.clone().requires_grad_(True)
            with torch.enable_grad():
                loss, _ = lm.lm_loss(pparams, probe, batch_at(0, leaf), use_kernel=use)
                (g,) = torch.autograd.grad(loss, (leaf,))
            norms[f"{name}_{path}"] = float(g.float().abs().max())
            del g, loss, leaf
            gc.collect()
            torch.cuda.empty_cache()
    del pparams
    rec["image_embeds_grad_max"] = {"layers": ZERO_IMAGE_LAYERS, **norms}
    log(f"phase 16 lm-train: {tag}: {TRAIN_ARCH} at {ZERO_IMAGE_LAYERS} layers, max |d loss / "
        f"d image embedding| with drawn vs zero image embeddings (recorded): "
        f"{json.dumps(norms)}")
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: internvl2-2b whole, 4 steps (counts from 0)
    rec["train_full"], main_launches = flash_train_whole(torch, lm, counters, cfg, batch_at,
                                                         dev, tag, profile)
    rec["routes"] = {f"{TRAIN_ARCH} train": rec["train_full"]["routes"]}
    if profile:
        rec["profile"] = rec["train_full"].pop("profile")

    # gemma3-12b at full width, one 5:1 unit (6 of 48 layers): hd 240 on the
    # tensor-core backward. Its kernel path against the plain path at 2
    # local blocks, then 4 steps (counts from 0)
    gcut, greduced = full_width(get_config, GEMMA_ARCH, TRAIN_CHECK_LAYERS)
    gpipe = TokenPipeline(gcut.vocab_size, TRAIN_TEXT, TRAIN_BATCH, seed=0)
    rec["gemma_kernel_vs_plain"] = train_kernel_vs_plain(torch, lm, gcut, dev,
                                                         make_lm_batch(gpipe, 0, dev), tag)
    rec["gemma_kernel_vs_plain"]["reduced"] = greduced
    gc.collect()
    torch.cuda.empty_cache()
    gcfg, greduced = full_width(get_config, GEMMA_ARCH, GEMMA_TRAIN_LAYERS)
    rec["gemma_train"], gemma_launches = flash_train_whole(
        torch, lm, counters, gcfg, lambda i: make_lm_batch(gpipe, i, dev), dev, tag, profile)
    rec["gemma_train"]["reduced"] = greduced
    rec["routes"][f"{GEMMA_ARCH} train"] = rec["gemma_train"]["routes"]

    # the RWKV main path: rwkv6-1.6b whole (counts from 0)
    rec["rwkv_train_full"], rwkv_launches = rwkv_train_whole(torch, lm, counters, get_config,
                                                             dev, tag, profile)

    rec["mini"] = mini_card_vs_cpu(torch, counters, dev, tag)

    # the example at a cut size
    _zero(counters)
    routes0 = _routes(counters)
    t0 = time.perf_counter()
    ex = train_lm_federated.main(["--steps", "8", "--batch", "2", "--seq-len", "64",
                                  "--clients", "2", "--device", str(dev)])
    torch.cuda.synchronize()
    got = _counts(counters)
    rec["routes"]["mini train"] = {
        n: {r: sum(rec["mini"][run]["routes"][n][r] for run in rec["mini"]) for r in c}
        for n, c in routes0.items()}
    rec["routes"]["example"] = _routes_since(counters, routes0)
    losses = [ex["centralized"]["final_loss"], ex["federated"]["final_loss"]]
    # mini is fp32: every launch on the 3xTF32 route
    want_routes = {n: {"fma": 0, "tensor_core": 0, "tf32x3": got[n]} for n in ROUTED}
    if (not all(math.isfinite(x) for x in losses) or got["flash_bwd_dq"] <= 0
            or got["flash_bwd_dq"] != got["flash_bwd_dkdv"] or got["wkv6"]
            or got["wkv6_bwd"] or got["spmm"] or rec["routes"]["example"] != want_routes):
        raise AssertionError(f"lm-train example: final losses {losses}, launches {got}, routes "
                             f"{rec['routes']['example']} (want {want_routes})")
    rec["example"] = {"final_losses": losses, "sync_events": ex["federated"]["sync_events"],
                      "launches": got, "routes": rec["routes"]["example"],
                      "seconds": time.perf_counter() - t0}
    log(f"phase 16 lm-train: {tag}: examples.train_lm_federated --steps 8 --batch 2 "
        f"--seq-len 64 --clients 2: final losses {losses}, "
        f"{ex['federated']['sync_events']} syncs, launches {json.dumps(got)}, routes "
        f"{json.dumps(rec['routes']['example'])}")

    # launch.train on rwkv6-1.6b's smoke configuration, card against CPU
    rec["rwkv_launch_train"] = rwkv_train_card_vs_cpu(torch, counters, dev, tag)
    # a forward in grad mode that wants no gradient takes the serving path:
    # the forward kernel alone, without its stage states
    rcfg = dataclasses.replace(get_smoke_config(RWKV_ARCH), rwkv_chunk=16)
    rparams = lm.init_lm(torch.Generator(device=dev).manual_seed(0), rcfg, dev)
    tokens = make_lm_batch(TokenPipeline(rcfg.vocab_size, 32, 2, seed=0), 0, dev)["tokens"]
    _zero(counters)
    logits, _ = lm.lm_forward(rparams, rcfg, tokens)
    torch.cuda.synchronize()
    want = {n: 0 for n in counters}
    want["wkv6"] = rcfg.n_layers
    if _counts(counters) != want or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"lm-train: RWKV forward with rwkv_chunk and no gradient: "
                             f"launches {_counts(counters)}, want {want}")
    log(f"phase 16 lm-train: {tag}: rwkv6-1.6b smoke forward in grad mode with no gradient "
        f"wanted (rwkv_chunk 16): WKV6 forward launched {rcfg.n_layers} times, no backward")
    return rec, {f"{TRAIN_ARCH} train": main_launches, f"{GEMMA_ARCH} train": gemma_launches,
                 f"{RWKV_ARCH} train": rwkv_launches}


DRYRUN_COUNTS = {"ok": 66, "skipped": 14, "errors": 0}


def dryrun_sweep() -> dict:
    """``python -m repro_torch.launch.dryrun --all --mesh both`` in a child
    process (its fake 512-rank world must not meet phase 14's NCCL group
    in this one): the counts, the seconds and the rows. The child's exit
    code and the counts are gated."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                              "--mesh", "both", "--out", out], cwd=ROOT, capture_output=True,
                             text=True, timeout=900,
                             env=dict(os.environ, PYTHONPATH=str(SRC)))
        seconds = time.perf_counter() - t0
        m = re.search(r"dry-run: (\d+) ok, (\d+) skipped, (\d+) errors", run.stdout)
        counts = dict(zip(("ok", "skipped", "errors"), map(int, m.groups()))) if m else None
        if run.returncode != 0 or counts != DRYRUN_COUNTS:
            raise AssertionError(f"roofline: the dry run exited {run.returncode} with counts "
                                 f"{counts} (want {DRYRUN_COUNTS}): {run.stdout[-3000:]} "
                                 f"{run.stderr[-3000:]}")
        rows = [json.loads(f.read_text()) for f in sorted(Path(out).glob("*.json"))]
    return {"counts": counts, "seconds": seconds, "rows": rows}


def roofline_phase(record, tag) -> dict:
    """Phase 17: the dry run's sweep, then each LM step the card timed
    (phase 9's steady prefills, phase 16's steady train steps) beside the
    dry run's row of that configuration and shape on a 1x1 mesh, walked in
    a spawned child: mfu = model FLOPs / (time x the bf16 peak), the row's
    bound / time, its useful-FLOPs ratio. Recorded, not gated. The walk is
    the plain path (attention over every query-key pair, the products in
    bf16 at the bf16 peak, unfused bytes); the card ran the kernels. A
    train row walks ``loss_and_grads`` (the timed step also runs the clip
    and AdamW); a prefill row's decode state holds the prompt's positions
    (the timed prefill's holds 32 more, for the decode)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from repro_torch.launch import dryrun

    sweep = dryrun_sweep()
    log(f"phase 17 roofline: {tag}: dry run --all --mesh both (every arch x shape on the "
        f"fake 256- and 512-rank meshes, on meta tensors): {sweep['counts']['ok']} ok, "
        f"{sweep['counts']['skipped']} skipped, {sweep['counts']['errors']} errors in "
        f"{sweep['seconds']:.1f} s")
    timed = []
    for arch, n_layers, prompt in [*((a, None, LM_PROMPT) for a in LM_ARCHS),
                                   *((a, n, LM_PROMPT) for a, n in LM_FAMILIES_CHECK),
                                   *((a, None, p) for a, p in LM_ENC_IMG)]:
        timed.append(({"arch": arch, "label": "prefill", "kind": "prefill",
                       "batch": LM_BATCH, "seq_len": prompt,
                       "extra": {"n_layers": n_layers} if n_layers else {}},
                      record["lm_check"][arch]["steady_prefill_ms"], "phase 9"))
    lt = record["lm_train"]
    for arch, n_layers, key in ((TRAIN_ARCH, None, "train_full"),
                                (GEMMA_ARCH, GEMMA_TRAIN_LAYERS, "gemma_train"),
                                (RWKV_ARCH, None, "rwkv_train_full")):
        extra = {"remat": False, **({"n_layers": n_layers} if n_layers else {})}
        timed.append(({"arch": arch, "label": "train", "kind": "train",
                       "batch": TRAIN_BATCH, "seq_len": TRAIN_TEXT, "extra": extra},
                      lt[key]["steady_step_ms"], "phase 16"))
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        rows = pool.submit(dryrun.unit_mesh_rows, [c for c, _, _ in timed]).result()
    steps = []
    for (case, ms, phase), row in zip(timed, rows):
        if row["status"] != "ok":
            raise AssertionError(f"roofline: the dry run's row of {case}: {row}")
        rf, t = row["roofline"], ms / 1e3
        rec = {**case, "phase": phase, "time_ms": ms, "model_flops": row["model_flops"],
               "walk_flops": rf["hlo_flops"], "walk_bytes": rf["hlo_bytes"],
               "bound_s": rf["bound_s"], "dominant": rf["dominant"],
               "mfu": roofline.mfu(row["model_flops"], t), "bound_over_time": rf["bound_s"] / t,
               "useful_flops_ratio": rf["useful_flops_ratio"], "memory": row["memory"]}
        steps.append(rec)
        cut = f", n_layers {case['extra']['n_layers']}" if case["extra"].get("n_layers") else ""
        log(f"phase 17 roofline: {tag}: {case['arch']} {case['kind']} (B {case['batch']} x "
            f"S {case['seq_len']}{cut}): {ms:.1f} ms ({phase}, steady); model FLOPs "
            f"{rec['model_flops']:.4e} -> mfu {rec['mfu']:.4f}; dry-run bound "
            f"{rec['bound_s'] * 1e3:.1f} ms ({rec['dominant']}; walk {rec['walk_flops']:.4e} "
            f"FLOPs, {rec['walk_bytes']:.4e} B) -> bound / time "
            f"{rec['bound_over_time']:.4f}; useful FLOPs ratio "
            f"{rec['useful_flops_ratio']:.4f}")
    return {"sweep": sweep, "steps": steps}


# launch.fed_dryrun's runs: the reference's CI widths (its dryrun-smoke job)
FED_CI = ["--n-max", "64", "--g-max", "8", "--features", "32", "--cohort", "64"]
FED_FAKE = ["--mesh", "host", "--force-devices", "8", "--pods", "8"]
FED_DRYRUNS = {
    "pod1": ["--mesh", "pod1"],
    "pod1_pods16": ["--mesh", "pod1", "--pods", "16"],
    "pod2": ["--mesh", "pod2"],
    "pod2_pods16": ["--mesh", "pod2", "--pods", "16"],
    "ci_k_flat": [*FED_FAKE, "--clients", "100000", "--assert-k-flat", "10000", *FED_CI],
    "ci_quant": [*FED_FAKE, "--clients", "1024", "--assert-quant-bytes", *FED_CI],
    "ci_int8": [*FED_FAKE, "--clients", "1024", "--sync-dtype", "int8", *FED_CI],
    "k1e4": [*FED_FAKE, "--clients", "10000", *FED_CI],
    "k1e6": [*FED_FAKE, "--clients", "1000000", *FED_CI],
    "host_meta": ["--mesh", "host", "--force-devices", "1", "--pods", "1",
                  "--clients", "100000", *FED_CI],
    "host_card": ["--mesh", "host", "--pods", "1", "--clients", "100000", *FED_CI],
}


def fed_dryrun_phase(torch, tag) -> dict:
    """Phase 18: every ``FED_DRYRUNS`` run of ``launch.fed_dryrun`` in a
    child process of its own, started together (the fake worlds must not
    meet phase 14's NCCL group in this process; ``host_card`` makes its own
    one-rank NCCL group on the card). Gated: each exits 0 with no check
    failed (its rounds' counted collectives equal to the ledger's, its
    residents to the ledger's), and the card's rounds count what the
    one-rank meta walk counts. Recorded: the rows, each round's ms on the
    card, its peak memory beside the ledger's resident total."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runs = {}
        for name, argv in FED_DRYRUNS.items():
            out = Path(tmp) / name
            runs[name] = (out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.fed_dryrun", *argv, "--out",
                 str(out)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=dict(os.environ, PYTHONPATH=str(SRC))))
        rows, done_s = {}, {}
        for name, (out, proc) in runs.items():
            text, _ = proc.communicate(timeout=600)
            done_s[name] = time.perf_counter() - t0
            files = sorted(out.glob("*.json"))
            if proc.returncode != 0 or len(files) != 1:
                raise AssertionError(f"fed-dryrun: {name} ({' '.join(FED_DRYRUNS[name])}) "
                                     f"exited {proc.returncode} with {len(files)} rows: "
                                     f"{text[-3000:]}")
            rows[name] = json.loads(files[0].read_text())
            if rows[name]["checks"]:
                raise AssertionError(f"fed-dryrun: {name}: {rows[name]['checks']}")
    for name, r in rows.items():
        ledger_note = ""
        if "pods" in r:
            p = r["pods"]
            res = p["per_device_resident_bytes"]
            ledger_note = (f"; K/P {p['table_shard_rows_per_pod']} rows, residents "
                           f"{sum(res['k_sharded'].values()):,} B sharded / "
                           f"{sum(res['replicated'].values()):,} B replicated (ledger), "
                           f"{r['memory']['resident_bytes']:,} B held")
        log(f"phase 18 fed-dryrun: {tag}: {name}: {r['mesh']} x {r['chips']} ranks, K "
            f"{r['clients']}, cohort {r['cohort']}, {r['sync_dtype']}, on {r['device']}: "
            f"gate-on {r['rounds']['gate_on']['counts']}, gate-off "
            f"{r['rounds']['gate_off']['counts']} (= the ledger's){ledger_note}; walk "
            f"{r['walk_s']:.1f} s, done {done_s[name]:.1f} s after the start")
    card, meta = rows["host_card"], rows["host_meta"]
    if card["device"] != "cuda" or meta["device"] != "meta":
        raise AssertionError(f"fed-dryrun: host_card on {card['device']}, host_meta on "
                             f"{meta['device']}")
    for g in ("gate_on", "gate_off"):
        for got in (card["rounds"][g]["counts"], card["timed"][g]["counts"]):
            if got != meta["rounds"][g]["counts"]:
                raise AssertionError(f"fed-dryrun: the card's {g} round counted {got}, the "
                                     f"meta walk {meta['rounds'][g]['counts']}")
    timed = card["timed"]
    ledger_total = sum(sum(e.values())
                       for e in card["pods"]["per_device_resident_bytes"].values())
    log(f"phase 18 fed-dryrun: {tag}: host on {timed['device_name']}, one NCCL rank, K "
        f"{card['clients']}, cohort {card['cohort']}: gate-on round "
        f"{timed['gate_on']['ms']:.1f} ms, gate-off {timed['gate_off']['ms']:.1f} ms (after "
        f"a synchronise; the walk's instrumented rounds came first); max memory allocated "
        f"{timed['max_memory_allocated']:,} B beside the ledger's residents "
        f"{ledger_total:,} B (held {card['memory']['resident_bytes']:,} B); counts = the "
        f"one-rank meta walk's")
    return {"rows": rows, "done_s": done_s, "ledger_resident_bytes": ledger_total,
            "card": {"gate_on_ms": timed["gate_on"]["ms"],
                     "gate_off_ms": timed["gate_off"]["ms"],
                     "max_memory_allocated": timed["max_memory_allocated"],
                     "held_resident_bytes": card["memory"]["resident_bytes"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="trace a second traffic run after phase 6, one LM "
                         "prefill + 4 decode steps per model in phase 9 and one "
                         "training round in phase 10 with torch.profiler, and "
                         "print where their time goes")
    ap.add_argument("--spans-only", action="store_true",
                    help="run phase 1 and phase 19 (the span system) alone")
    ap.add_argument("--ghost-pull-only", action="store_true",
                    help="run phase 1 and phase 20 (the ghost pull kernel) alone")
    ap.add_argument("--spmm-sparse-only", action="store_true",
                    help="run phase 1 and phase 21 (the SpMM's sparse route) alone")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    import repro_torch.api as api
    import repro_torch.core.fedais as fedais
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.convert import (
        lm_params_from_numpy,
        lm_params_to_numpy,
        params_from_numpy,
        params_to_numpy,
    )
    from repro_torch.federated.partition import partition_graph
    from repro_torch.federated.server import build_eval_graph, eval_logits, evaluate_global
    from repro_torch.graph.csr import build_padded_neighbors
    from repro_torch.graph.data import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ghost_pull import ops as gops
    from repro_torch.kernels.spmm import ops, ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import ref as wref
    from repro_torch.launch.serve_lm_cli import serve
    from repro_torch.launch.train import mini_config
    from repro_torch.models import lm
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.gcn import HIDDEN, gcn_init
    from repro_torch.serve import GraphStore, LoadGenerator, QueryEngine, ServedModel

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    record: dict = {}

    # -- phase 1: device ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase 1 device: {kind} | nvidia-smi: {smi} | cards {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda} | "
        f"float32_matmul_precision {torch.get_float32_matmul_precision()} "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    record["device"] = {"name": kind, "nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    if args.spans_only or args.ghost_pull_only or args.spmm_sparse_only:
        if args.spans_only:
            g = make_dataset("pubmed", scale=1, max_features=500, seed=0)
            fed = partition_graph(g, TRAIN_CLIENTS, alpha=0.5, seed=0)
            record["spans"] = spans_phase(torch, api, g, fed, dev, f"{kind}, {smi}")
        if args.ghost_pull_only:
            record["ghost_pull"] = ghost_pull_phase(torch, dev, f"{kind}, {smi}")
        if args.spmm_sparse_only:
            record["spmm_sparse"] = spmm_sparse_phase(torch, dev, f"{kind}, {smi}")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(record, indent=1))
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
        return 0

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    log(f"phase 2 build: {json.dumps(build.build_seconds)} s of nvcc "
        f"({time.perf_counter() - t0:.2f} s wall) into {build.BUILD_DIR}")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"phase 2 build: {name}: {line.strip()}")
    record["build_s"] = dict(build.build_seconds)
    # the bf16 flash kernel runs on the tensor cores (HGMMA is wgmma in
    # SASS) and spills nothing
    hgmma = sass_count(build, "flash_attention", "HGMMA")
    tc_fns = {}
    for n, r in res_usage(build, "flash_attention").items():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_tc_kernel)ILi(\d+)E", n)
        if m:
            tc_fns[f"{m.group(1)}<{m.group(2)}>"] = {
                "registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                "local_bytes": r.get("LOCAL")}
    # the backward's spill traffic among its tensor-core instructions
    among = spills_among_hgmma(build, "flash_attention",
                               r"(flash_bwd_(?:dq|dkdv)_tc_kernelILi\d+E)")
    for n, c in among.items():
        m = re.match(r"(\w+)ILi(\d+)E", n)
        tc_fns[f"{m.group(1)}<{m.group(2)}>"]["spill_ops_among_hgmma"] = c
    # ptxas's own spill report, where this run built the library
    for n, r in ptxas_spills(build.build_log.get("flash_attention", "")).items():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_tc_kernel)ILi(\d+)E", n)
        if m:
            tc_fns[f"{m.group(1)}<{m.group(2)}>"].update(r)
    for n, r in sorted(tc_fns.items()):
        log(f"phase 2 build: flash_attention: {n}: {r['registers']} registers a thread "
            f"as ptxas allocated them, stack {r['stack_bytes']} B, local "
            f"{r['local_bytes']} B"
            + (f", {r['spill_ops_among_hgmma']} spill loads and stores among its HGMMA"
               if "spill_ops_among_hgmma" in r else "")
            + (f", ptxas: {r['spill_stores']} B of spill stores, {r['spill_loads']} B of "
               f"spill loads" if "spill_stores" in r else ""))
    log(f"phase 2 build: flash_attention: {hgmma} HGMMA instructions in the library's "
        f"SASS; {len(tc_fns)} tensor-core kernel instances")
    if hgmma == 0:
        raise AssertionError("build: no HGMMA in the flash attention library: the bf16 "
                             "kernel does not run on the tensor cores")
    # the forward at three widths (64, 128, 256), none with a stack frame or
    # local memory; each backward kernel at three (64, 128, 256), with no
    # spill traffic among its tensor-core instructions (what ptxas spills of
    # the consumers' 240 registers at 64 and 128 lies before or after the
    # loop's products), and at 256 with no stack frame at all
    fwd = [r for n, r in tc_fns.items() if n.startswith("flash_fwd")]
    bwd = [r for n, r in tc_fns.items() if not n.startswith("flash_fwd")]
    wide = [r for n, r in tc_fns.items() if n.endswith("<256>")]
    if (len(fwd) != 3 or len(bwd) != 6
            or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0 for r in fwd + wide)
            or any(r["local_bytes"] != 0 or r.get("spill_ops_among_hgmma") != 0
                   for r in bwd)):
        raise AssertionError(f"build: the bf16 flash kernels' instances spill or are "
                             f"missing: {tc_fns}")
    # the fp32 tensor-core kernels (3xTF32): the forward, dq and dk/dv at 64,
    # 128 and 256, each with no stack frame, no local memory and (where this
    # run built the library) no spill
    x3_fns = {}
    for n, r in res_usage(build, "flash_attention").items():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_x3_kernel)ILi(\d+)E", n)
        if m:
            x3_fns[f"{m.group(1)}<{m.group(2)}>"] = {
                "registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                "local_bytes": r.get("LOCAL")}
    for n, r in ptxas_spills(build.build_log.get("flash_attention", "")).items():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_x3_kernel)ILi(\d+)E", n)
        if m:
            x3_fns[f"{m.group(1)}<{m.group(2)}>"].update(r)
    for n, r in sorted(x3_fns.items()):
        log(f"phase 2 build: flash_attention: {n}: {r['registers']} registers a thread "
            f"as ptxas allocated them, stack {r['stack_bytes']} B, local "
            f"{r['local_bytes']} B"
            + (f", ptxas: {r['spill_stores']} B of spill stores, {r['spill_loads']} B of "
               f"spill loads" if "spill_stores" in r else ""))
    want_x3 = {f"flash_{k}_x3_kernel<{w}>" for k in ("fwd", "bwd_dq", "bwd_dkdv")
               for w in (64, 128, 256)}
    if (set(x3_fns) != want_x3
            or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                   or r.get("spill_stores", 0) or r.get("spill_loads", 0)
                   for r in x3_fns.values())):
        raise AssertionError(f"build: the fp32 tensor-core kernels' instances spill or are "
                             f"missing: {x3_fns}")
    record["flash_build"] = {"hgmma": hgmma, "tc_kernels": tc_fns, "x3_kernels": x3_fns}
    # every instance of the wkv6 kernel (3 head sizes x 3 column tiles x 2
    # types) keeps its state tile in registers: no stack, no local memory
    wkv_fns = {n: {"registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                   "local_bytes": r.get("LOCAL")}
               for n, r in res_usage(build, "wkv6").items() if "wkv6_kernel" in n}
    for n, r in sorted(wkv_fns.items()):
        log(f"phase 2 build: wkv6: {n}: {r['registers']} registers, stack "
            f"{r['stack_bytes']} B, local {r['local_bytes']} B")
    if len(wkv_fns) != 18 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                                 for r in wkv_fns.values()):
        raise AssertionError(f"build: wkv6 kernel instances spill or are missing: {wkv_fns}")
    # the backward's instances (3 head sizes x 2 types): a sub-stage's S, G
    # and the row sums in registers, no spill
    bwd_fns = {n: {"registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                   "local_bytes": r.get("LOCAL")}
               for n, r in res_usage(build, "wkv6").items() if "wkv6_bwd" in n}
    for n, r in sorted(bwd_fns.items()):
        log(f"phase 2 build: wkv6: {n}: {r['registers']} registers, stack "
            f"{r['stack_bytes']} B, local {r['local_bytes']} B")
    if len(bwd_fns) != 6 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                                 for r in bwd_fns.values()):
        raise AssertionError(f"build: wkv6 backward instances spill or are missing: "
                             f"{bwd_fns}")
    wkv_fns.update(bwd_fns)
    record["wkv6_build"] = wkv_fns
    # every instance of the SpMM kernel (4 column widths x 16-byte or 4-byte
    # loads of X) keeps its sums and its batch of A in registers
    spmm_fns = {n: {"registers": r.get("REG"), "stack_bytes": r.get("STACK"),
                    "local_bytes": r.get("LOCAL")}
                for n, r in res_usage(build, "spmm").items() if "spmm_nnz_kernel" in n}
    for n, r in sorted(spmm_fns.items()):
        log(f"phase 2 build: spmm: {n}: {r['registers']} registers, stack "
            f"{r['stack_bytes']} B, local {r['local_bytes']} B")
    if len(spmm_fns) != 8 or any(r["stack_bytes"] != 0 or r["local_bytes"] != 0
                                 for r in spmm_fns.values()):
        raise AssertionError(f"build: spmm kernel instances spill or are missing: "
                             f"{spmm_fns}")
    record["spmm_build"] = spmm_fns

    # -- the configuration ------------------------------------------------------
    g = make_dataset("pubmed", scale=1, max_features=500, seed=0)
    idx, mask = build_padded_neighbors(g.adjacency_lists(), 32, seed=0)
    store = GraphStore(g.features, idx, mask)
    cap, n_nodes = store.capacity, g.n_nodes
    log(f"config: pubmed scale 1: {n_nodes} nodes, {len(g.edges)} edges, "
        f"{g.n_features} features, {g.n_classes} classes, hidden {HIDDEN}, "
        f"max_deg 32, capacity {cap}")
    t0 = time.perf_counter()
    fed = partition_graph(g, TRAIN_CLIENTS, alpha=0.5, seed=0)
    log(f"config: train: {TRAIN_CLIENTS} clients (Dirichlet alpha 0.5), n_max {fed.n_max}, "
        f"g_max {fed.g_max}, n_tot {fed.n_max + fed.g_max}, client sizes "
        f"{fed.client_sizes.tolist()}, {fed.n_cross_edges} cross edges; partitioned in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- phase 3: kernels against their plain versions --------------------------
    timer = Timer(torch)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.tensor(store.features, device=dev)
    table1 = torch.randn((cap, HIDDEN[0]), generator=gen, device=dev)
    rows_all = rng.permutation(n_nodes)
    shapes = []

    def adj_case(rows: np.ndarray):
        i = torch.tensor(store.nbr_idx[rows], device=dev)
        mk = torch.tensor(store.nbr_mask[rows], device=dev)
        a = ops.adjacency_from_neighbors(i, mk, cap)
        return a, ops.adjacency_block_mask(i, mk, cap, ops.TILE_M, ops.TILE_K)

    a, mk = adj_case(np.arange(cap))
    shapes.append(check_spmm(torch, ops, ref, timer, "warm_fill", a, feat, mk, 5))
    del a, mk
    for b in (8, 32, 128):
        a, mk = adj_case(rows_all[:b])
        shapes.append(check_spmm(torch, ops, ref, timer, f"historical_b{b}", a, table1,
                                 mk, 20))
        shapes.append(check_spmm(torch, ops, ref, timer, f"refresh_b{b}", a, feat, mk, 20))
    for b in (8, 32, 128):
        q = rows_all[:b]
        r = np.unique(np.concatenate([q, store.nbr_idx[q][store.nbr_mask[q] > 0]]))
        rows = np.zeros(b * 33, np.int64)
        rows[: len(r)] = r
        a, mk = adj_case(rows)
        shapes.append(check_spmm(torch, ops, ref, timer, f"fresh_b{b}", a, feat, mk, 10))
    nonfinite = [check_spmm_nonfinite(torch, ops, "fresh_b128", a, feat, mk)]
    del a, mk
    a = torch.rand((1000, 3001), generator=gen, device=dev)
    a = torch.where(torch.rand(a.shape, generator=gen, device=dev) < 0.01, a, 0.0)
    x = torch.randn((3001, 77), generator=gen, device=dev)
    mk = ops.block_mask_from_dense(a, ops.TILE_M, ops.TILE_K)
    shapes.append(check_spmm(torch, ops, ref, timer, "ragged", a, x, mk, 20))
    nonfinite.append(check_spmm_nonfinite(torch, ops, "ragged", a, x, mk))
    # the shapes below draw from their own generator, so that the later
    # phases draw what they drew before these were added. More than 1,024
    # mask columns (two windows of the kernel's live-tile list) and D over
    # 512 (two column slabs, the second ragged)
    gen_new = torch.Generator(device=dev).manual_seed(1)
    a = torch.rand((100, 40000), generator=gen_new, device=dev)
    a = torch.where(torch.rand(a.shape, generator=gen_new, device=dev) < 0.002, a, 0.0)
    x = torch.randn((40000, 600), generator=gen_new, device=dev)
    shapes.append(check_spmm(torch, ops, ref, timer, "windows_slabs", a, x,
                             ops.block_mask_from_dense(a, ops.TILE_M, ops.TILE_K), 10))
    # every element nonzero: 32 FMAs per row of every tile, each row summing
    # to 1 as the mean aggregation's adjacency does
    a_raw = torch.rand((512, 2048), generator=gen_new, device=dev) + 0.1
    x = torch.randn((2048, 128), generator=gen_new, device=dev)
    mk = ops.block_mask_from_dense(a_raw, ops.TILE_M, ops.TILE_K)
    a = a_raw / a_raw.sum(1, keepdim=True)
    shapes.append(check_spmm(torch, ops, ref, timer, "dense", a, x, mk, 5))
    # recorded, no gate: the rows before they are normalised (entries in
    # [0.1, 1.1), |y| above 100), where a chain of 2,048 / splits fp32
    # FMAs per output drifts from the library's blocked sums
    want = ref.spmm_ref(a_raw, x)
    raw = {s: float((ops.launch(a_raw, x, mk, s) - want).abs().max()) for s in ops.SPLITS}
    log(f"phase 3 kernels: spmm dense_unnormalised (recorded, no gate): max abs err by "
        f"split {json.dumps(raw)}, max |y| {float(want.abs().max())}")
    record["spmm_dense_unnormalised"] = {"max_abs_err": raw,
                                         "max_abs_y": float(want.abs().max())}
    del a_raw, want
    a = torch.zeros((300, 500), device=dev)
    x = torch.randn((500, 64), generator=gen, device=dev)
    dead = torch.zeros((10, 16), dtype=torch.int32, device=dev)
    row = check_spmm(torch, ops, ref, timer, "all_dead", a, x, dead, 20)
    if any(ops.launch(a, x, dead, s).abs().max() != 0 for s in ops.SPLITS):
        raise AssertionError("spmm all_dead: output is not exactly zero")
    shapes.append(row)
    del a, x, dead, table1, mk
    # the training path's shapes, from their own generators too
    train_shapes, record["spmm_backward"], record["spmm_transpose_copy"] = \
        spmm_training_shapes(torch, ops, ref, timer, fed, dev,
                             torch.Generator(device=dev).manual_seed(2), np.random.default_rng(2))
    shapes += train_shapes
    record["spmm_shapes"] = shapes
    record["spmm_nonfinite"] = nonfinite

    # -- phase 4: serve (the main path; counts from 0) --------------------------
    params = gcn_init(torch.Generator().manual_seed(0), g.n_features, g.n_classes,
                      device=dev)
    ids = np.sort(rng.choice(n_nodes, size=N_IDS, replace=False))
    ops.block_spmm.launches = 0
    t0 = time.perf_counter()
    model = ServedModel(params, store, backend="spmm", warm="refresh", device=dev)
    engine = QueryEngine(model, fallback=False)
    warm_launches = engine.warmup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    hist = np.concatenate([engine.query(ids[i: i + 128], policy="historical")
                           for i in range(0, N_IDS, 128)])
    fresh = np.concatenate([engine.query(ids[i: i + 128], policy="fresh")
                            for i in range(0, N_IDS, 128)])
    if hist.shape != (N_IDS, g.n_classes) or not np.isfinite(hist).all():
        raise AssertionError(f"serve: logits {hist.shape} or non-finite")
    if not np.allclose(hist, fresh, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"serve: historical vs fresh max abs diff "
                             f"{np.abs(hist - fresh).max()}")
    log(f"phase 4 serve: warm fill + warmup {t_setup} s ({warm_launches} warmup "
        f"launches); {N_IDS} ids: historical vs fresh max abs diff "
        f"{float(np.abs(hist - fresh).max())}")

    # -- phase 5: traffic ------------------------------------------------------
    before = ops.block_spmm.launches
    gen_load = LoadGenerator(engine, seed=0, n_queries=200, n_updates=20, mode="closed",
                             concurrency=8, policy_mix={"historical": 0.9, "fresh": 0.1})
    ledger = gen_load.run()
    torch.cuda.synchronize()
    launches = ops.block_spmm.launches
    summ = ledger.summary(backend="spmm", devices=1, quick=False, mode="closed",
                          policy_mix=gen_load.policy_mix,
                          degraded=engine.degraded_snapshot())
    log(f"phase 5 traffic: {kind}, {smi}: closed loop 8 clients, {summ['n_queries']} "
        f"queries + {summ['n_updates']} updates: p50 {summ['p50_ms']} ms p99 "
        f"{summ['p99_ms']} ms {summ['queries_per_s']} queries/s; per policy "
        f"{json.dumps(summ['policies'])}; fallbacks {engine.n_fallbacks}; spmm "
        f"launches {launches - before} in traffic, {launches} on the main path")
    record["traffic"] = summ
    if engine.n_fallbacks != 0:
        raise AssertionError(f"traffic: {engine.n_fallbacks} fallbacks")
    if launches - before <= 0:
        raise AssertionError("traffic: the SpMM kernel was not launched")

    # -- phase 6: served logits against the eval path and the CPU path ---------
    eg = build_eval_graph(g, max_deg=32, seed=0, backend="spmm", device=dev)
    want = eval_logits(params, eg)[torch.from_numpy(ids).to(dev)].cpu().numpy()
    metrics = evaluate_global(params, eg)
    del eg
    err_eval = float(np.abs(hist - want).max())
    if not np.allclose(hist, want, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"check: served vs eval path max abs diff {err_eval}")
    cpu_store = GraphStore(g.features, idx, mask)
    cpu_model = ServedModel(params_from_numpy(params_to_numpy(params), "cpu"), cpu_store,
                            backend="spmm", warm="cold", device="cpu")
    cpu_engine = QueryEngine(cpu_model, buckets=(32,), fallback=False)
    cpu = np.concatenate([cpu_engine.query(ids[i: i + 32], policy="fresh")
                          for i in range(0, N_IDS, 32)])
    err_cpu = float(np.abs(hist - cpu).max())
    if not np.allclose(hist, cpu, atol=TOL_LOGITS, rtol=TOL_LOGITS):
        raise AssertionError(f"check: served vs CPU plain path max abs diff {err_cpu}")
    log(f"phase 6 check: {N_IDS} served ids vs eval path on the card max abs diff "
        f"{err_eval}, vs plain path on the CPU {err_cpu}; eval metrics (random "
        f"weights) {json.dumps(metrics)}")

    # refreshed rows on the graph the traffic mutated: invalidate a few more
    # rows, refresh the cache, and hold what the refresh wrote
    engine.add_edges(np.stack([ids[:16], rng.choice(n_nodes, 16, replace=False)], 1))
    stale = model.invalid_rows()
    n_ref = engine.refresh()
    if n_ref != len(stale) or len(model.invalid_rows()) or not len(stale):
        raise AssertionError(f"check: refresh wrote {n_ref} of {len(stale)} stale rows, "
                             f"{len(model.invalid_rows())} still stale")
    ids2 = np.union1d(stale[:192], ids[:64])
    hist2 = np.concatenate([engine.query(ids2[i: i + 128], policy="historical")
                            for i in range(0, len(ids2), 128)])
    fresh2 = np.concatenate([engine.query(ids2[i: i + 128], policy="fresh")
                             for i in range(0, len(ids2), 128)])
    cpu_model = ServedModel(cpu_model.params, copy.deepcopy(store), backend="spmm",
                            warm="cold", device="cpu")
    cpu_engine = QueryEngine(cpu_model, buckets=(32,), fallback=False)
    cpu2 = np.concatenate([cpu_engine.query(ids2[i: i + 32], policy="fresh")
                           for i in range(0, len(ids2), 32)])
    err_fresh2 = float(np.abs(hist2 - fresh2).max())
    err_cpu2 = float(np.abs(hist2 - cpu2).max())
    if (not np.isfinite(hist2).all()
            or not np.allclose(hist2, fresh2, atol=TOL_LOGITS, rtol=TOL_LOGITS)
            or not np.allclose(hist2, cpu2, atol=TOL_LOGITS, rtol=TOL_LOGITS)):
        raise AssertionError(f"check: after refresh, historical vs fresh max abs diff "
                             f"{err_fresh2}, vs plain path on the CPU {err_cpu2}")
    log(f"phase 6 check: mutated graph ({store.n_active} nodes), {n_ref} rows "
        f"refreshed; {len(ids2)} ids ({min(len(stale), 192)} refreshed): historical vs "
        f"fresh max abs diff {err_fresh2}, vs plain path on the CPU {err_cpu2}")
    record["poisoned"] = poisoned_fallbacks(torch, g, idx, mask, params, dev, ids[:128],
                                            GraphStore, ServedModel, QueryEngine)

    if args.profile:
        prof = profile_traffic(torch, engine, LoadGenerator)
        record["profile"] = prof
        log(f"profile: {kind}, {smi}: traffic wall {prof['wall_ms']} ms, device busy "
            f"{prof['device_busy_ms']} ms (share {prof['device_busy_share']})")
        for e in prof["top_device"]:
            log(f"profile: device {e['device_ms']} ms x{e['count']} {e['name']}")
        for e in prof["top_host"]:
            log(f"profile: host {e['self_cpu_ms']} ms x{e['count']} {e['name']}")

    del engine, model, cpu_engine, cpu_model, store, cpu_store
    torch.cuda.empty_cache()

    # -- phase 7: lm-kernels against their plain versions ----------------------
    bf16, f32 = torch.bfloat16, torch.float32
    wkv_rows = [
        check_wkv6(torch, wops, wref, timer, gen, "prefill_bf16", 4, 2048, 32, 64, bf16,
                   20, 2, others=True),
        check_wkv6(torch, wops, wref, timer, gen, "prefill_fp32", 4, 2048, 32, 64, f32,
                   10, 2, others=True),
        check_wkv6(torch, wops, wref, timer, gen, "ragged_fp32", 2, 77, 4, 64, f32, 20, 3),
        check_wkv6(torch, wops, wref, timer, gen, "ragged_bf16", 2, 77, 4, 64, bf16, 20, 3),
        # the other head sizes at the prefill's width (d 2,048)
        check_wkv6(torch, wops, wref, timer, gen, "n32_bf16", 4, 2048, 64, 32, bf16, 10, 1),
        check_wkv6(torch, wops, wref, timer, gen, "n128_bf16", 4, 2048, 16, 128, bf16, 10,
                   1),
        # one step; one step past a stage of the input ring
        check_wkv6(torch, wops, wref, timer, gen, "t1_bf16", 4, 1, 32, 64, bf16, 20, 3),
        check_wkv6(torch, wops, wref, timer, gen, "stage_plus_1_fp32", 2,
                   wops.STAGE_STEPS + 1, 4, 64, f32, 20, 3),
        # bases the copy engine cannot take
        check_wkv6(torch, wops, wref, timer, gen, "misaligned_bf16", 2, 77, 4, 64, bf16, 20,
                   3, misalign=True),
    ]
    tc, x3, fma = "tensor_core", "tf32x3", "fma"
    flash_rows = [
        check_flash(torch, fops, fref, timer, gen, "local_bf16", 4, 2048, 16, 8, 240, True,
                    1024, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "attn_bf16", 4, 2048, 16, 8, 240, True,
                    None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "local_fp32", 4, 2048, 16, 8, 240, True,
                    1024, f32, 5, x3),
        check_flash(torch, fops, fref, timer, gen, "attn_fp32", 4, 2048, 16, 8, 240, True,
                    None, f32, 5, x3),
        check_flash(torch, fops, fref, timer, gen, "ragged_fp32", 2, 1000, 6, 2, 64, True,
                    None, f32, 10, x3),
        check_flash(torch, fops, fref, timer, gen, "ragged_local_bf16", 2, 1000, 6, 2, 64,
                    True, 256, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "ragged_bf16_hd128", 2, 1000, 8, 4, 128,
                    True, None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "noncausal_bf16", 1, 512, 4, 4, 240,
                    False, None, bf16, 10, tc),
        # hd not a multiple of 8: TMA cannot take it, bf16 runs the FMA kernel
        check_flash(torch, fops, fref, timer, gen, "odd_hd_bf16", 1, 300, 4, 2, 36, True,
                    None, bf16, 10, fma),
        # the new families' shapes: recurrentgemma-2b's local blocks (MQA, hd
        # 256, a prompt twice its window, so the window bites) and dbrx-132b's
        # causal GQA blocks
        check_flash(torch, fops, fref, timer, gen, "rgemma_local_bf16", 4, 4096, 10, 1, 256,
                    True, 2048, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "rgemma_local_fp32", 4, 4096, 10, 1, 256,
                    True, 2048, f32, 3, x3),
        check_flash(torch, fops, fref, timer, gen, "dbrx_attn_bf16", 4, 2048, 48, 8, 128,
                    True, None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "dbrx_attn_fp32", 4, 2048, 48, 8, 128,
                    True, None, f32, 3, x3),
        # whisper-large-v3 and internvl2-2b: the encoder (1,500 frames = 23 key
        # tiles of 64 and 28 keys, unmasked: the zero-filled keys past Sk are
        # the first place a missing mask shows), the cross attention (the
        # 224-token decoder prompt against the 1,500 frames), the decoder's
        # causal self attention, internvl2's causal GQA over 256 image + 2,048
        # text tokens; then causal with Sq != Sk both ways, the second with a
        # window that leaves the last rows no live key (they come out 0)
        check_flash(torch, fops, fref, timer, gen, "whisper_enc_bf16", 4, 1500, 20, 20, 64,
                    False, None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "whisper_enc_fp32", 4, 1500, 20, 20, 64,
                    False, None, f32, 3, x3),
        check_flash(torch, fops, fref, timer, gen, "whisper_cross_bf16", 4, 224, 20, 20, 64,
                    False, None, bf16, 10, tc, Sk=1500),
        check_flash(torch, fops, fref, timer, gen, "whisper_cross_fp32", 4, 224, 20, 20, 64,
                    False, None, f32, 5, x3, Sk=1500),
        check_flash(torch, fops, fref, timer, gen, "whisper_dec_bf16", 4, 224, 20, 20, 64,
                    True, None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "whisper_dec_fp32", 4, 224, 20, 20, 64,
                    True, None, f32, 5, x3),
        check_flash(torch, fops, fref, timer, gen, "internvl2_attn_bf16", 4, 2304, 16, 8, 128,
                    True, None, bf16, 10, tc),
        check_flash(torch, fops, fref, timer, gen, "internvl2_attn_fp32", 4, 2304, 16, 8, 128,
                    True, None, f32, 3, x3),
        check_flash(torch, fops, fref, timer, gen, "causal_cross_bf16", 2, 200, 8, 4, 64,
                    True, None, bf16, 10, tc, Sk=333),
        check_flash(torch, fops, fref, timer, gen, "causal_cross_fp32", 2, 200, 8, 4, 64,
                    True, None, f32, 10, x3, Sk=333),
        check_flash(torch, fops, fref, timer, gen, "causal_past_sk_window_bf16", 2, 333, 8, 4,
                    128, True, 64, bf16, 10, tc, Sk=200),
        check_flash(torch, fops, fref, timer, gen, "causal_past_sk_window_fp32", 2, 333, 8, 4,
                    128, True, 64, f32, 10, x3, Sk=200),
        # (the rows draw their inputs in turn from one generator: a row added
        # at the end leaves every other row's inputs as they were)
        # internvl2-2b's and whisper's encoder fp32 shapes one element off a
        # 16-byte boundary: the FMA kernel (the route fp32 took there before
        # the 3xTF32 forward), timed in the same run
        check_flash(torch, fops, fref, timer, gen, "internvl2_attn_fp32_unaligned", 4, 2304, 16,
                    8, 128, True, None, f32, 3, fma, unaligned=True),
        check_flash(torch, fops, fref, timer, gen, "whisper_enc_fp32_unaligned", 4, 1500, 20, 20,
                    64, False, None, f32, 3, fma, unaligned=True),
    ]
    record["wkv6_shapes"], record["flash_shapes"] = wkv_rows, flash_rows
    del timer
    torch.cuda.empty_cache()

    # -- phase 8: lm-serve (the LM main paths; counts from 0 before each) ------
    counters = {"spmm": ops.block_spmm, "wkv6": wops.wkv6,
                "wkv6_bwd": wops.wkv6_bwd,
                "flash_attention": fops.flash_attention, "flash_bwd_dq": fops.flash_bwd_dq,
                "flash_bwd_dkdv": fops.flash_bwd_dkdv, "ghost_pull": gops.ghost_pull}
    tag = f"{kind}, {smi}"
    lm_counts = {}
    for arch, n_layers, prompt in [*((a, None, LM_PROMPT) for a in LM_ARCHS),
                                   *((a, n, LM_PROMPT) for a, n in LM_FAMILIES_SERVE),
                                   *((a, None, p) for a, p in LM_ENC_IMG)]:
        cfg, reduced = full_width(get_config, arch, n_layers)
        row = lm_serve(torch, serve, counters, cfg, dev, tag, LM_BATCH, prompt, LM_GEN,
                       reduced)
        record.setdefault("lm_serve", {})[arch] = row
        lm_counts[arch] = row["launches"]
        torch.cuda.empty_cache()

    # -- phase 9: lm-check ------------------------------------------------------
    for arch, n_layers, prompt in [*((a, None, LM_PROMPT) for a in LM_ARCHS),
                                   *((a, n, LM_PROMPT) for a, n in LM_FAMILIES_CHECK),
                                   *((a, None, p) for a, p in LM_ENC_IMG)]:
        cfg, reduced = full_width(get_config, arch, n_layers)
        record.setdefault("lm_check", {})[arch] = lm_check_full(
            torch, lm, rmsnorm, cfg, dev, tag, LM_BATCH, prompt, LM_GEN, args.profile,
            reduced)
        torch.cuda.empty_cache()
    for arch in (*LM_ARCHS, "mini", *LM_FAMILIES_SMOKE):
        cfg = mini_config() if arch == "mini" else get_smoke_config(arch)
        record.setdefault("lm_check_smoke", {})[arch] = lm_check_smoke(
            torch, lm, cfg, dev, lm_params_from_numpy, lm_params_to_numpy)

    # the sparse route stays off through phases 10-15 (their graphs' dense
    # operands fit, kernels.spmm.ops.spmm_route)
    sparse_before = ops.block_spmm.sparse_launches

    # -- phase 10: train (the FedAIS main path; counts from 0) -------------------
    record["train"], train_launches = train_phase(torch, api, fedais, ops, ref, counters, g,
                                                  fed, dev, tag, args.profile)

    # -- phase 11: methods (the method space; counts from 0 before each run) ---
    t11 = time.perf_counter()
    record["methods"], methods_launches, method_runs = methods_phase(
        torch, api, counters, g, fed, dev, tag, args.profile)
    record["methods"]["seconds"] = time.perf_counter() - t11
    log(f"phase 11 methods: {tag}: {methods_launches} SpMM launches in "
        f"{record['methods']['seconds']:.1f} s")

    # -- phase 12: fused (the fused executor; counts from 0 before each run) ---
    t12 = time.perf_counter()
    record["fused"], fused_launches = fused_phase(torch, api, counters, g, fed, dev, tag,
                                                  method_runs, args.profile)
    record["fused"]["seconds"] = time.perf_counter() - t12
    log(f"phase 12 fused: {tag}: {fused_launches} SpMM launches in "
        f"{record['fused']['seconds']:.1f} s")

    # -- phase 13: deploy (train -> checkpoint -> restore -> serve; chaos) ------
    t13 = time.perf_counter()
    record["deploy"], deploy_launches = deploy_phase(torch, counters, dev, tag, args.profile)
    record["deploy"]["seconds"] = time.perf_counter() - t13
    log(f"phase 13 deploy: {tag}: {deploy_launches} SpMM launches in "
        f"{record['deploy']['seconds']:.1f} s")

    # -- phase 14: sharded (the multi-device executors; counts from 0 before each)
    t14 = time.perf_counter()
    record["sharded"], sharded_launches = sharded_phase(torch, api, counters, g, fed, dev, tag,
                                                        args.profile)
    record["sharded"]["seconds"] = time.perf_counter() - t14
    log(f"phase 14 sharded: {tag}: {sharded_launches} SpMM launches in "
        f"{record['sharded']['seconds']:.1f} s")

    # -- phase 15: examples (quickstart, variance analysis; counts from 0) -----
    t15 = time.perf_counter()
    record["examples"], examples_launches = examples_phase(torch, counters, dev, tag)
    record["examples"]["seconds"] = time.perf_counter() - t15
    log(f"phase 15 examples: {tag}: {examples_launches} SpMM launches in "
        f"{record['examples']['seconds']:.1f} s")
    record["sparse_launches_10_15"] = ops.block_spmm.sparse_launches - sparse_before
    if record["sparse_launches_10_15"]:
        raise AssertionError(f"phases 10-15 launched the sparse SpMM route "
                             f"{record['sparse_launches_10_15']} times, want 0")

    # -- phase 16: lm-train (LM training on the card; counts from 0) ------------
    t16 = time.perf_counter()
    record["lm_train"], train_lm_launches = lm_train_phase(
        torch, counters, get_config, get_smoke_config, dev, tag, args.profile)
    record["lm_train"]["seconds"] = time.perf_counter() - t16
    log(f"phase 16 lm-train: {tag}: {json.dumps(train_lm_launches)} launches on the main "
        f"path in {record['lm_train']['seconds']:.1f} s")

    # -- phase 17: roofline (the dry run; each timed LM step beside its row) ----
    t17 = time.perf_counter()
    record["roofline"] = roofline_phase(record, tag)
    record["roofline"]["seconds"] = time.perf_counter() - t17

    # -- phase 18: fed-dryrun (the FedAIS round on fake worlds and on the card)
    t18 = time.perf_counter()
    record["fed_dryrun"] = fed_dryrun_phase(torch, tag)
    record["fed_dryrun"]["seconds"] = time.perf_counter() - t18

    # -- phase 19: spans (the span system's device phases) ----------------------
    t19 = time.perf_counter()
    record["spans"] = spans_phase(torch, api, g, fed, dev, tag)
    record["spans"]["seconds"] = time.perf_counter() - t19

    # -- phase 20: ghost-pull (the one-pass ghost pull kernel) -------------------
    t20 = time.perf_counter()
    record["ghost_pull"] = ghost_pull_phase(torch, dev, tag)
    record["ghost_pull"]["seconds"] = time.perf_counter() - t20

    # -- phase 21: spmm-sparse (the SpMM's sparse route) ------------------------
    t21 = time.perf_counter()
    record["spmm_sparse"] = spmm_sparse_phase(torch, dev, tag)
    record["spmm_sparse"]["seconds"] = time.perf_counter() - t21

    # -- the kernels line --------------------------------------------------------
    warm = shapes[0]
    kernels = [{
        "name": "spmm_block_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:45",
        "launches": (launches + train_launches + methods_launches + fused_launches
                     + deploy_launches + sharded_launches + examples_launches),
        "launches_by_path": {"gcn_serving": launches, "fedais_training": train_launches,
                             "fedais_methods": methods_launches,
                             "fedais_fused": fused_launches, "deploy": deploy_launches,
                             "fedais_sharded": sharded_launches,
                             "examples": examples_launches},
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": warm["ms"], "plain_ms": warm["plain_ms"], "bound_ms": warm["bound_ms"],
        "bound_by": warm["bound_by"], "library_ms": warm["library_ms"],
        "timed_shape": "warm_fill", "shapes": shapes,
    }]
    for name, src, replaces, rows, counter in (
            ("wkv6_fwd", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/wkv6.py:54", wkv_rows, "wkv6"),
            ("flash_attention_fwd",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:89", flash_rows,
             "flash_attention")):
        main_row = rows[0]
        by_path = {arch: c[counter] for arch, c in lm_counts.items() if c[counter]}
        by_path.update({path: c[counter] for path, c in train_lm_launches.items()
                        if c[counter]})
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "timed_shape": main_row["shape"],
            # floor_ms is a model of the kernel's work, not a measurement:
            # it stays in the phase-7 rows of the record, not in this line
            "shapes": [{k: v for k, v in r.items() if k != "floor_ms"} for r in rows]})
    # the fp32 forward on the 3xTF32 route, timed at internvl2-2b's fp32 shape
    # (the FMA kernel's time at that shape one element off a 16-byte boundary
    # beside); launches by path from the forward route counts of phase 16's
    # main paths (mini's runs and the example)
    x3_rows = [r for r in flash_rows if r["route"] == "tf32x3"]
    main_row = next(r for r in x3_rows if r["shape"] == "internvl2_attn_fp32")
    fma_row = next(r for r in flash_rows if r["shape"] == "internvl2_attn_fp32_unaligned")
    by_path = {p: c["flash_attention"]["tf32x3"]
               for p, c in record["lm_train"]["routes"].items() if c["flash_attention"]["tf32x3"]}
    kernels.append({
        "name": "flash_attention_fwd_tf32x3", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:89",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in x3_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_fma_ms": main_row["bound_fma_ms"], "library_ms": main_row["library_ms"],
        "fma_kernel_ms": fma_row["ms"], "timed_shape": main_row["shape"],
        "shapes": [{k: v for k, v in r.items() if k != "floor_ms"} for r in x3_rows]})
    # the backward pair on each route: each kernel's own time, bound, plain
    # version (its half of attention_bwd_ref) and library call (autograd of
    # SDPA asked for its outputs only) at internvl2-2b's training shape, in
    # bf16 for the bf16 tensor-core kernels (the main path's), in fp32 for
    # the 3xTF32 ones (mini's) and in fp32 one element off a 16-byte
    # boundary for the FMA ones (the layouts TMA cannot take: no main path
    # has one, so they count no launch); launches by path from the route
    # counts
    bwd_rows = record["lm_train"]["flash_bwd_shapes"]
    bwd_routes = record["lm_train"]["routes"]
    for route, suffix, timed in (("tensor_core", "tc", "internvl2_train_bf16"),
                                 ("tf32x3", "tf32x3", "internvl2_train_fp32"),
                                 ("fma", "fma", "internvl2_train_fp32_unaligned")):
        rows = [r for r in bwd_rows if r["route"] == route]
        main_row = next(r for r in rows if r["shape"] == timed)
        for name, key in (("flash_bwd_dq", "dq"), ("flash_bwd_dkdv", "dkdv")):
            by_path = {p: c[name][route] for p, c in bwd_routes.items() if c[name][route]}
            kernels.append({
                "name": f"{name}_{suffix}", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "replaces": ("src/repro/models/attention.py:212 (_flash_bwd, jnp; no Pallas "
                             "kernel)"),
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row[f"{key}_ms"], "plain_ms": main_row[f"plain_{key}_ms"],
                "bound_ms": main_row[f"{key}_bound_ms"],
                "bound_by": main_row[f"{key}_bound_by"],
                "bound_fma_ms": main_row[f"{key}_bound_fma_ms"],
                "library_ms": main_row[f"library_{key}_ms"], "timed_shape": main_row["shape"],
                "shapes": [{k: v for k, v in r.items()
                            if k != "max_abs_err_by_grad" and not k.endswith("floor_ms")}
                           for r in rows]})
    # the WKV6 backward at rwkv6-1.6b's bf16 training shape: its time (with
    # the timer's wait; the reading without it beside), the bound of the
    # function, the plain backward, launches from the RWKV main paths
    wrows = record["lm_train"]["wkv6_bwd_shapes"]
    main_row = next(r for r in wrows if r["shape"] == "rwkv6_train_bf16")
    by_path = {path: c["wkv6_bwd"] for path, c in train_lm_launches.items() if c["wkv6_bwd"]}
    kernels.append({
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": ("src/repro/models/rwkv.py:105 (wkv_scan's jnp autodiff; no Pallas "
                     "kernel)"),
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in wrows),
        "ms": main_row["ms"], "ms_no_wait": main_row["ms_no_wait"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "timed_shape": main_row["shape"],
        "shapes": [{k: v for k, v in r.items() if k != "max_abs_err_by_grad"}
                   for r in wrows]})
    # the ghost pull at Coauthor's shape; launches from the FedAIS main
    # paths' runs (phases 10-15)
    gp = record["ghost_pull"]
    main_row = next(r for r in gp["shapes"] if r["shape"] == "coauthor")
    by_path = {"fedais_training": record["train"]["launches"]["ghost_pull"],
               **{path: record[phase]["ghost_pull_launches"] for path, phase in (
                   ("fedais_methods", "methods"), ("fedais_fused", "fused"),
                   ("deploy", "deploy"), ("fedais_sharded", "sharded"),
                   ("examples", "examples"))}}
    kernels.append({
        "name": "ghost_pull", "route": "cuda",
        "source": "src/repro_torch/kernels/ghost_pull/csrc/ghost_pull.cu",
        "replaces": ("src/repro/core/fedais.py:211 (the sync's pull: pull_ghosts, "
                     "jnp.where and .at[].set; no Pallas kernel)"),
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": 0.0, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "timed_shape": "coauthor", "shapes": gp["shapes"]})
    # the sparse route at Reddit's eval shape; no phase's graph takes it
    sp = record["spmm_sparse"]
    main_row = next(r for r in sp["shapes"] if r["shape"] == "reddit_eval_l0")
    kernels.append({
        "name": "spmm_ell_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm_sparse.cu",
        "replaces": ("src/repro/kernels/spmm/spmm.py:45 (spmm_pallas, for graphs whose "
                     "dense operand does not fit)"),
        "launches": record["sparse_launches_10_15"], "launches_by_path": {},
        "max_abs_err": 0.0, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "timed_shape": "reddit_eval_l0", "shapes": sp["shapes"]})
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
