"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train,
measure.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --trace trace.txt   # also profile requests

Phases, each of which stops the run with a non-zero exit when it fails:

1. build: one ``nvcc`` per CUDA source of ``repro_torch`` (dequant_bag,
   bag_grad, bag_matmul, cin, hashed_gather, rowwise_quant,
   dequant_bag_rowgrid, bag_grad_rowgrid), all started together, for
   sm_90a into ``build/repro_torch/``;
2. kernel check: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0): dequant_bag for int8, bf16, fp16 and
   fp32 payloads, and on its cases (``kernels/cases.py``: every dtype at
   D 1/10/32/33/64/128, K 1/8/40, B 61/37/64, 30% zero weights, a NaN row
   under zero weights, payloads off 16-byte alignment, an int8 payload
   over 2.1 GB read past 2^31 bytes); its tiered entry on the tiered
   cases (int32 and int64 ids, K 1/8/40, fp16 half tiers, empty int8 and
   fp32 tiers, NaN and inf weights: NaN bags) against the per-tier
   composition through the plain bag and through three single-tier
   launches; its shard window on the window cases (stores cut 2, 3 and 4
   ways at the reference's stride ceil(V_t / n), a one-row last shard and
   empty last windows, an empty int8 tier, int32 and int64 ids, K 1 / 8 /
   40, NaN and inf weights on slots outside the window: NaN bags in every
   shard), each shard's launch against the windowed per-shard composition
   through the plain bag and through three single-tier launches; bag_grad
   at K = 1 and 8, with and without scales, 40% masked slots, heavy duplicates, B that no block divides, D = 64, 33
   and 200, B = 0, and on its schedules and the (B, K)-grid oracle's
   (``kernels/cases.py``: one row of 65,536 slots, runs at the heavy-run
   threshold and one either side, zero coefficients over a NaN
   cotangent, D 1/8/10/33/64/128/200 off 16-byte alignment; one row's
   65,536 slots beside other rows of its bucket, every slot in one
   bucket, rows repeating inside and across the oracle's 32-slot windows,
   runs of rows sharing a bucket at K = 3, B = 0), with and without a
   precomputed grouping, also against bag_grad_rowgrid; bag_matmul for every payload dtype, K = 1 and K > 1,
   30% dead slots, with and without ``scale_after``, B and H that no tile
   divides, D = 200 and the full-width shapes of wide&deep (B 512, K 40,
   D 32, H 1024) and xDeepFM (B 512, K 39, D 10, H 400), and on B
   1/31/512/513, K 1/39/40, D 1/10/32/384, H 1/63/400/1024 and dead
   fields over a NaN in w3 (NaN in both); cin at shapes
   that no block divides and D = 128, and on its tile cases
   (``kernels/cases.py``: O 17, 200, 201 and 400, a sample's D = 6 or
   D = 128 columns split across n tiles, K of 72, 1,521 and 7,800, H = M
   = 1, W off 16-byte alignment at K = 72, a NaN in W; the full-width layers are checked on served data in phase
   9); hashed_gather for int8 and fp32 pools, Z
   = 8, 4 and 5, K = 1 with sign coefficients (B = 20,480, a request's
   ids, and B = 1001), K = 5 with random weights and 30% zero
   coefficients, and B = 0, and on its cases (Z 4/5/8, T 1/2/6, S no
   power of two, seeds 0 and 7, int64 ids past 2^32), its plan and ids
   entries both; quantize_rowwise in narrow and full mode,
   round-to-nearest and stochastic, dividing and reciprocal scale, D =
   64, 32, 10 and 8 at V = 1001, with an all-zero row (the 1e-12 floor),
   a row of exact .5 multiples of its scale (half to even) and rows
   holding NaN and inf (NaN and inf scales, codes 0, as the plain
   version), and on its path cases (``kernels/cases.py``: D = 64, 32, 10,
   8, 3, 68 and 133 at V = 1001, NaN and inf rows beside finite rows of one
   warp step, x or noise off 16-byte alignment); the two (B, K)-grid
   oracles against their plain versions and
   against the tiled kernels: dequant_bag_rowgrid for every payload
   dtype, D = 64 and 33, K = 1 and 8, B = 0, and a NaN row (a NaN scale
   for int8) in a zero-weight slot, where the rowgrid forms give NaN bags
   and the tiled forms finite ones, each equal to its own plain version;
   its vector path at D 1/10/33/200 (a payload off 16-byte alignment at
   D 10) and K 1-8 with an inf row (an inf scale for int8) under a zero
   weight, and on the gather cases (the 2.1 GB int8 payload included);
   bag_grad_rowgrid at bag_grad's shapes and a NaN cotangent under zero
   coefficients (skipped by both);
3. serve: ``repro_torch.launch.serve`` at ``--model full`` — dlrm-rm2 at
   its published widths (26 fields, 204,185,088 rows x 64 packed at a 50%
   budget, MLPs 13-512-256-64 and 415-512-512-256-1), batch 512.  Launch
   counts are set to 0 just before and read just after: one tiered
   dequant_bag launch a request and no single-tier one; the build must
   quantize its int8 tier through quantize_rowwise, and the pack's tier
   rows and bytes must be what they were before it did; one request's
   embeddings must equal the plain ``lookup`` bit for bit, and its logits
   the same head run on the CPU within 1e-4 * max(1, |ref|) (GPU and CPU
   GEMMs reduce 512-long dot products in different orders); after the
   counts are read, a training batch's 65,536 x 26 uniform ids through
   ``lookup_fused`` must equal the plain ``lookup`` and the per-tier
   composition bit for bit, with slots in each of the three tiers;
4. measure serving: dequant_bag at the serving shapes (B*F = 13,312
   slots, K = 1, the served store's tiers), checked bit for bit against
   its plain version on those inputs, then timed beside it, its bound and
   a library call; the tiered entry on the same requests' ids, bit-equal
   to the per-tier composition, timed beside it (three single-tier
   launches and their glue, events around the whole call), its plain
   version and its bound; quantize_rowwise on the int8 rows of the
   build's first 4M-row chunk (bit-equal to its plain version and to the
   pack's first int8 rows), timed beside its bound and its plain version;
   dequant_bag_rowgrid on the same tier inputs (all 13,312 slots read),
   bit-equal to its plain version and to dequant_bag, timed beside the
   tiled kernel, its bound, its plain version and ``F.embedding_bag``;
5. train: the compressed train step (``train.setup.build_recsys_training
   (model="full", max_ind_range=24_000_000)``: published widths, every
   field capped at 24M rows, 124,185,088 rows x 64) at batch 65,536 for
   9 steps.  Counts are set to 0 just before and read just after: each
   kernel must launch once a step; every loss must be finite; one step's
   embeddings must equal ``table[gidx]`` bit for bit.  Prints the step
   time, the per-stage device split (CUDA events) and the peak memory;
6. measure training: dequant_bag at the training forward (one batch's
   1,703,936 slots over the 124,185,088-row table) bit for bit against
   its plain version and ``F.embedding_bag``, timed beside both and its
   bound, and dequant_bag_rowgrid on the same slots (bit-equal to it,
   timed before and after the library call); bag_grad on the real
   duplicate pattern of one
   training batch (1,703,936 slots, rows renumbered by rank so that the
   plain version's dense output fits beside the kernel's) bit for bit,
   then timed at the training shapes (the full 124,185,088-row output),
   with its sort and with the slots grouped beforehand, beside the zero
   fill, its byte bound and chain bound (the longest row's slots x the FMA
   latency at the card's top clock), the plain version and ``index_add_``;
   bag_grad_rowgrid on the same slots (bit-equal to bag_grad; 10
   launches timed at the full vocab, twice, around bag_grad and
   ``index_add_`` timed again) and at the pipeline gradcheck's shape
   (8 samples x 26 fields into the rows they touch: bit-equal to its plain
   version and to bag_grad, timed beside both, its bound and
   ``index_add_``).  ``--rowgrid-only`` builds the kernels and runs phase
   2's bag_grad schedule and oracle checks and this phase's timings at
   phase 5's first batch, drawn from the data stream without the train
   state (prints a ``rowgrid`` line, no kernels line, no ok line);
7. resume: ``python -m repro_torch.launch.train --model smoke`` is killed
   after its first checkpoint and rerun; the rerun must resume from it;
8. online fused serve: ``repro_torch.launch.serve --online --fuse-matmul``
   for wide-deep and then xdeepfm at their published widths (22,216,000
   rows x 32 and 86,709,150 rows x 10, nothing cut), batch 512, 16
   drifting-zipf requests (drift 4.0, seed 0), a re-tier every 2
   requests, 256 cache rows.  Counts are set to 0 just before each and
   read just after: ``bag_matmul`` must launch 3 times a request (one per
   tier) and ``cin`` 3 times a request on xdeepfm, dequant_bag once a
   packed lookup (a tiered launch a cache build and, on xdeepfm, a
   request); the pack and its
   re-tiers quantize through quantize_rowwise, and the pack's bytes, the
   rows moved and the cache hits must be what they were before; after
   the run the pack's int8 rows and scales (the build's and the
   re-tiers' quantize_rowwise output) must equal the plain quantizer on
   the table rows they hold, bit for bit.  Before each request,
   outside its timed window, the unfused ``model.head(params,
   lookup(packed, gidx), batch)`` runs on the same card on the store the
   request will read (its own launches are not counted); each request's
   fused logits must be finite and within 1e-4 * max(1, |ref|) of it;
9. measure the fused head: ``bag_matmul`` at both archs' serving shapes
   (the served store's three tier launches of 16 requests) and ``cin``
   at xdeepfm's three layer shapes on a served batch, each checked bit
   for bit against its plain version on those inputs (CIN on 64 and on
   all 512 samples), then timed beside its bound and a library call;
   and quantize_rowwise (D = 10, the scalar path) on the int8 rows of the
   xdeepfm pack's first 4M-row chunk, bit-equal to the plain quantizer
   and to the pack's rows, timed beside its bound and plain version;
10. hashed serve: ``repro_torch.launch.serve --arch wide-deep --online
   --store-backend hashed`` at full width (22,216,192 rows x 32 fitted
   into a pool at ratio 100, chunk width 8), first with ``--hash-bits
   32``, then with ``--hash-bits 8``, batch 512, 16 drifting-zipf
   requests, the same re-tier and cache settings.  Counts are set to 0
   just before each and read just after: ``hashed_gather`` must launch
   once a request and once per cache rebuild, and the start-up exactly
   as the fit and the first cache build launch them (13 + 1
   hashed_gather, 14 bag_grad, 1 quantize_rowwise for 8 bits), every
   gather through the ids entry.  Outside
   each request's timed window its embeddings come from the plain
   ``hashed_gather_ref`` on the card and must equal the ones the loop
   served bit for bit (logits finite, within 1e-4 of the head on them).
   Then the start-up's kernels are held to their plain versions at the
   shapes it gave them: the fit is rerun (it is deterministic) and must
   give the served pool; its fwd over all 22,216,192 rows (unit scales;
   the ids entry it runs and the plan entry, both also timed beside
   their bounds and ``F.embedding_bag``), its first adj (bag_grad over
   the (V*C, NH) plan) and, for 8 bits, quantize_pool's quantize_rowwise
   over the fitted pool must equal the plain versions bit for bit; the
   fit-shaped bag_grad is timed with the fit's grouping (made once a fit)
   and with its own sort, beside its bounds, its plain version and
   ``index_add_``.  Prints the fit's seconds, its relative residual
   ||fwd(pool) - table|| / ||table|| (it must lie in (0, 1): the zero
   pool gives 1) and the store's bytes, then measures hashed_gather at
   the served shapes (20,480 ids x C 4 x T 2), both entries, beside their
   bounds, their plain versions and ``F.embedding_bag`` over the
   dequantized pool;
11. pipeline: ``python -m repro_torch.launch.pipeline --model full
   --max-ind-range 6000000 --batch 65536 --steps 40`` through its
   ``main``: dlrm-rm2 at its published widths over 34,184,704 rows (every
   field capped at 6M rows: a cut of rows, not widths, from the train
   cell's 124,185,088 for the time limit) trained 40 steps (one checkpoint
   of the ~9.2 GB train state), gradcheck,
   Taylor field pruning to 85% of the table bytes with a 16-step masked
   finetune, Eq. 8 quantization at a 50% budget, pack and its
   ``packed_store/v1`` checkpoint round trip, eval of 8 held-out batches
   and 96 requests served micro-batched by 8 (a re-tier every 24, 64
   cache rows, drift 2.0).  Counts are set to 0 just before and read just
   after: dequant_bag (single-tier) and bag_grad once a train and a
   finetune step, the pack's int8 tier through quantize_rowwise, the eval
   and the serve through one tiered dequant_bag launch a lookup (one an
   eval batch), the rowgrid oracles never; all four ``verify_*``
   flags true and every loss finite.  The served lookups are held bit
   for bit to the plain gather on the pipeline's own inputs: the first
   eval batch's 1,703,936 slots through the restored pack (every tier)
   against ``packed_store.lookup``, and every micro-batch that did not
   re-tier against the plain gather of the pack that served it.  The run
   has ``--metrics-out`` (checked in phase 13).  Prints the record, the
   stage seconds, the peak memory and each checkpoint's bytes and write
   rate;
12. hashed pipeline: the same pipeline with ``--store-backend hashed``
   over the same 34,184,704 rows (batch 65,536, 40 steps), the pool
   fitted at ratio 100 in 9 row chunks (``store.hashed.fit_chunk_rows``):
   the fit's hashed_gather (ids entry: 13 a chunk, then the residual's
   gathers) and bag_grad (14 a chunk) launches, the ids entry in the eval
   and the serve; each chunk's scatter in the fit's first adj held bit
   for bit to the plain ``bag_grad`` accumulated onto the same running
   result, and the eval batch and the micro-batches to
   ``hashed_gather_ref`` over the restored pool.  Prints the fit's
   seconds (with and without those checks), chunk count and relative
   residual (in (0, 1)) and the peak memory;
13. metrics: (a) phase 8's wide-deep serve again, with ``--metrics-out F
   --metrics-every 4``: every line of F passes the unchanged
   ``tools/check_bench_schema.py`` (run as a subprocess), the final
   snapshot's ``serve.requests``, ``serve.lookups``, ``serve.cache.hits``
   and ``serve.retier.rows_moved`` and the count of ``serve.retier_us``
   equal the record's ``requests``, ``lookups``, ``hits``, ``rows_moved``
   and ``retiers`` (which still equal what they were before), each
   request's fused logits equal phase 8's bit for bit (the audit hook,
   outside the timed window), the launches are checked as in phase 8, and
   p50 / p99 are printed beside phase 8's (metrics off); (b) phase 11's
   stream: every line valid, ``train.steps`` the steps the train loop
   ran, one observation in each ``pipeline.<stage>_us``,
   ``serve.requests`` 96; (c) ``python -m repro_torch.benchmarks.qps
   --online --serve-batch 1,8,32 --emit F`` through its ``main`` at the
   reference's defaults (the bench DLRM, 384 single-user requests, 512
   cache rows, a re-tier every 128, drift 4.0): the record validates,
   its byte columns are equal across the sweep, and the tiered
   dequant_bag and quantize_rowwise launched (counts set to 0 just
   before and read just after);
14. shadow re-tiers: (a) phase 8's online fused serve of wide-deep and
   of xdeepfm again with ``--retier-async --shadow-rows 4194304
   --verify-swap`` and 32 requests, the same audit of every request (fused logits finite
   and within 1e-4 * max(1, |ref|) of the unfused head on the store the
   request read); the record's ``retier_async`` is true, at least two
   swaps land on request ticks before the final drain, every swap is
   verified bit for bit against a fresh ``pack`` at its snapshot (a
   failure stops the run), and the counts (set to 0 just before, read
   just after) are: ``quantize_rowwise`` the start-up's launches + one a
   shadow chunk + one a 4M-row block of each verify pack, the tiered
   dequant_bag one a cache build (and a request on xdeepfm),
   ``bag_matmul`` three a request, ``cin`` three a request on xdeepfm;
   the pack's int8 rows equal the plain quantizer on their table rows;
   builds, chunks, swaps and p50 / p99 / p99 while re-tiering / p99
   attributed are printed beside phase 8's synchronous run (nothing is
   gated on the times); (b) on the drained wide-deep server: one
   drifting fold, ``begin_retier`` and one chunk, whose materialized
   store unpacks bit for bit to ``repack_delta`` over the movers done;
   the drain, verified; a second build discarded after a chunk, leaving
   the live store's tensors (``data_ptr``) and bytes; (c) phase 13's
   ``bench_qps`` with ``--retier-async``: the record passes the unchanged
   ``tools/check_bench_schema.py`` (which holds each entry's p99 and p99
   while re-tiering to 10x its p50), every entry swapped, and
   quantize_rowwise launched.
15. paper tables: ``python -m repro_torch.benchmarks.run --fast`` through
   its ``main``: the paper's six jobs (Table 2-4, Fig. 2-3, the
   frequency/error study) on the bench DLRM at the reference's reduced
   budgets (depth cut from the full ~16,000 training steps, which took
   ~120 s, to make room for phase 17), every CSV row and each job's
   seconds printed; every AUC finite and in [0, 1], the closed-form
   memory columns (``mpe_lfu``, ``alpt_int8``, the uniform rows, Table
   4's F-Permutation share) and Table 2's passes equal their formulas,
   ``eval_auc`` of Table 3's fp32 params (retrained, same seeds) on the
   card and on the CPU within 1e-5, and no kernel launched (counts set to
   0 just before, read just after; the bench looks up by plain indexing,
   as the reference's uses ``jnp.take``).  Table 2's measured F-P
   speedup and how many planted-dead fields F-Permutation ranks least
   important are printed, not checked.  The six jobs run one ``--only``
   each (the runner's ``qps`` and ``hashed`` jobs launch kernels);
16. the hashed train step and the runner's records, each with the counts
   set to 0 just before and read just after: (a) ``python -m
   repro_torch.benchmarks.run --fast --emit TMP/BENCH_hash.json`` at the
   reference's reduced budgets (ratios 4 and 100, 120 steps each and the
   dense arm's, 32 requests by 8, 4 eval batches; cut from its full ones
   for the time limit): the
   record passes ``tools/check_bench_schema.py``; hashed_gather's plan
   entry and bag_grad launch once a hashed step, dequant_bag and
   bag_grad once a dense step, quantize_rowwise once a ``quantize_pool``,
   the ids entry once a materialisation, served micro-batch and cache
   build; before each hashed arm's first step, outside the counts, that
   step's forward and pool gradient equal ``hashed_gather_ref`` and
   ``hashed_grad_ref`` bit for bit, and (first arm) the plan entry is
   timed at the step's shape; ms a dense and a hashed step are printed;
   (b) ``benchmarks.run --only qps`` (the offline proxy, 20 timed
   forwards of each arm): the byte rows equal their formulas over the
   pack's tiers, the packed embeddings equal the plain ``lookup`` bit for
   bit, 21 tiered dequant_bag launches; the fp32 and packed forward times
   are printed; (c) ``--emit TMP/BENCH_qps.json --fast`` and
   ``--emit-pipeline TMP/p.json --fast``: both records pass the schema
   tool.
17. the hierarchical store, each run with the counts set to 0 just before
   and read just after, its cold shards of 1,048,576 rows in a temporary
   directory removed when the run ends: (a) ``launch.serve --arch
   wide-deep --online --serve-batch 8 --store-backend hier`` at the
   published widths (22,216,000 x 32), hot and warm budgets each a tenth
   of the fully packed bytes, 256 drifting-zipf requests, ``--cache-rows
   256 --retier-every 64 --drift 4.0 --verify-hier``; (b) the same with
   ``--retier-async --shadow-rows 4194304 --verify-swap`` and 4,096
   requests: at least one verified swap on a request tick published a new
   cold generation; (c) dlrm-rm2 over all 204,185,088 rows x 64, 4 GiB on
   the card and 8 GiB in host RAM, 64 requests by 8, one synchronous
   migration, ``--verify-hier``.  Every 4th audited micro-batch (one that
   did not re-tier): the hot level's fused gather bit-equal to the plain
   ``lookup`` and the served embeddings to the host oracle
   (``HierStore.gather_fp32_host``); one tiered dequant_bag launch a
   micro-batch (and a verify block), no single-tier launch, and
   quantize_rowwise at the build and in the migrations.  Prints each
   record (p50 / p99, miss rate, hits, migrations, levels, build / serve /
   verify seconds, ms a re-tier, the device peak and the host peak RSS).
   (d) ``python -m repro_torch.benchmarks.hier`` at the reference's
   budgets (fractions 0.05 / 0.15 / 0.4 / 1.0, 256 requests by 8), again
   with ``--retier-async``, and ``benchmarks.run --emit
   TMP/BENCH_hier.json --fast``: each record through the unchanged schema
   tool, the tiered dequant_bag and quantize_rowwise launched.
   ``--hier-only`` builds the kernels and runs this phase alone (no
   kernels line, no ok line).
18. the serving fleet (``repro_torch.serve.fleet``), each run with the
   counts set to 0 just before and read just after: (a) ``launch.fleet
   --arch wide-deep --model full --replicas 1,2,4,8`` (22,216,000 x 32,
   nothing cut) at the CLI's other defaults (256 requests by 8, a merge
   and a staggered re-tier every 64, 128 cache rows, drift 4.0) with
   ``--metrics-out`` and ``--emit`` into a temporary directory, through
   ``run`` in process: the record and every stream pass the unchanged
   schema tool (capacity rising to 4 replicas, the router under 10% of
   the per-request p50, ordered percentiles, divergence after the merges
   no higher than before), the port's ``merge_snapshots`` of each count's
   per-source streams equals its ``replicasN_fleet.jsonl`` line, the
   tiered dequant_bag launches once a served micro-batch and once a cache
   build and no single-tier one launches, quantize_rowwise launches in
   each server's pack (the same count each) and in the re-tiers, and
   nowhere else; one micro-batch of each replica (the audit hook, outside
   its window) is served embeddings bit-equal to the plain ``lookup`` of
   its pack; after each count's final merge every replica's priority
   equals the others' and a numpy oracle (the eager fp32 fold of the
   merge base with the pooled counts of the micro-batches the merge
   pooled) bit for bit; each replica's int8 rows and scales equal the
   plain quantizer on their table rows; (b) the same for xdeepfm
   (86,709,150 x 10) at 1, 2 and 4 replicas, with cin 3 times a
   micro-batch; (c) the library's ``Fleet`` and ``Replica`` driven
   directly over wide&deep at full width, async (``OnlineConfig(
   retier_async=True, shadow_rows_per_step=4194304, verify_swap=True)``),
   1,024 requests at 1, 2 and 4 replicas: swaps land on request ticks,
   every swap verified, the ``serve.shadow.*`` histograms in the
   replicas' registries and none in the default one, quantize_rowwise
   once a server start's launches, a shadow chunk and a 4M-row block of
   each verify pack; (d) ``python -m repro_torch.launch.fleet --emit
   TMP/BENCH_fleet.json`` (the reference record's configuration: smoke
   dlrm-rm2, 1, 2, 4 and 8 replicas, 256 requests) through the schema
   tool.  Prints for each count the aggregate and per-replica QPS, the
   fleet p50 / p99, the route p50, ``fleet.merge_us`` p50, a pulse's ms,
   the rows moved and the device memory.  ``--fleet-only`` builds the
   kernels and runs this phase alone (no kernels line, no ok line).

19. the mesh (``repro_torch.dist``: mesh N is N row shards on this one
   card, each a view of the store), each run with the counts set to 0 just
   before and read just after: (a) beside phase 4, on its live dlrm-rm2
   pack (204,185,088 x 64, nothing cut), meshes 1, 2 and 4 with no copy,
   16 requests of batch 512 through ``sharded_lookup`` at each: the tiered
   entry N times a request and nothing else; every request's embeddings
   bit-equal to the plain ``lookup``, logits within 1e-4 * max(1, |ref|)
   of mesh 1's; the device memory allocated equal at every mesh; a
   training batch's 65,536 x 26 uniform ids at mesh 4 bit-equal to the
   plain ``lookup`` with slots in every (tier, shard) cell; a windowed
   launch, the sharded lookup and the shard sum timed; (b) ``launch.serve
   --online --fuse-matmul --model full --mesh 4`` for wide&deep and
   xDeepFM at phase 8's arguments: bag_matmul 12 times a request, cin 3
   times, the tiered entry 4 times a packed lookup; each request's logits
   within 1e-4 * max(1, |ref|) of phase 8's (mesh 1), the re-tiers and
   rows moved phase 8's, the cache's rows bit-equal to the plain ``lookup``
   of the live pack; (c) the hashed wide&deep store at ``--mesh 4``: the
   plan entry 4 times a request, 1,048,576 rows within 1e-6 * max(1,
   |ref|) of the unsharded gather (bit-equality reported); the hier
   wide&deep store at phase 17's budgets, 256 requests by 8, ``--mesh 4
   --verify-hier``, audited as phase 17, its hot level (the card's four
   shards, views of it) within ``--hbm-budget-mb``; (d) the compressed train step at
   the train cell (124,185,088 rows, batch 65,536) over a 4-shard mesh for
   3 steps from phase 5's seed, the state placed a row shard a shard
   (``place_train_state``: row views on the one card) and the gather,
   scatter, adagrad, snap and EMAs run a shard at a time: the forward and
   bag_grad 4 times a step; after each step the table, adagrad
   accumulator, priority and access EMA (64-bit digests of every bit,
   ``digest``) and the loss equal phase 5's, and its peak (above what
   was allocated before it) within 1 GB of phase 5's (no whole
   gradient, no second state); (e)
   ``launch.pipeline --fast --max-ind-range 1000000`` (7,116,800 rows x
   64, the 512-padded total) at mesh 1, then with ``--mesh 2`` packed and
   hashed, every stage from the placed state (the one-card case of the
   pipeline over a ``--device`` list: prune a shard at a time, the fp32
   eval one float32 dequant_bag a shard a batch, the snap a shard at a
   time, the packs and the fit reading the table in row blocks), through
   ``pipeline_phase`` (launch counts x 2, the served lookups bit-equal to
   the plain gather); the packed mesh-2 record equal to mesh 1's on the
   losses, the gradcheck's error, the tier rows, the bytes, the eval
   losses and AUCs, the re-tiers, the hit rate and the final pack's
   64-bit digest (``MESH_PIPELINE_SAME``);
   (f) ``python -m repro_torch.benchmarks.qps_sharded --emit-dir TMP``
   (smoke dlrm-rm2, meshes 1, 2, 4): each record through the schema tool.
   Prints p50 / p99 a request at each mesh, launches a request, the shard
   sum's ms, ms a train step at mesh 1 and 4 and the peaks as one JSON
   ``mesh`` line.  ``--mesh-only`` builds the kernels and runs phase 2's
   window cases and phase 19 alone, its mesh-1 references included (no
   kernels line, no ok line).

20. the kernel record, the fused head's training twin, the family smoke
   and the examples, each run with the counts set to 0 just before and
   read just after: (a) ``python -m repro_torch.benchmarks.kernels
   --seed-cache --emit TMP/BENCH_kernel.json --shapes KERNEL_SHAPES`` (the
   reference's two shapes, wide&deep's fused head 512:40:32:1024 and
   xDeepFM's 512:39:10:400) through ``main``, the autotune cache under
   TMP: the record through the schema tool, measured <= analytic on every
   entry, the roofline kernel table printed (the rowgrid oracle of row 2
   runs here, and only here); (b) every candidate tiling of every swept
   shape, and of a wide&deep hashed request over both pools, bit-equal to
   the analytic pick, each analytic rule equal to its Python mirror (not
   counted: comparisons); (c) phase 8's wide&deep serve with
   ``--autotune-cache`` of (a): the fused head reads the cache, the
   logits bit-equal to phase 8's, both p50s printed; dlrm-rm2's offline
   serve with the cache file present and absent, in turns, p50s printed;
   (d) ``bag_matmul_train`` at wide&deep's widths (B 512, K 40, D 32, H
   1024, the 22,216,192-row table): its forward bit-equal to
   ``bag_matmul``, the table's gradient to ``bag_grad`` of the slot
   cotangents, dw3 and dweights within 1e-5 of the float64 contractions;
   (e) ``python -m repro_torch.launch.train --arch X --smoke`` for the four
   recsys archs through ``run``; (f) bert4rec at ``FULL_CFG`` (5,000,002
   items x 64, 2 blocks, 2 heads, sequence 200): one generic train step
   with the F-Quantization hook and one forward at batch 2 (8.0 GB of
   logits), finite, the peak memory printed; (g) the four examples
   (``repro_torch.examples``, ``train_lm`` among them) on the card at
   their defaults.
   ``--record-only`` builds the kernels and runs phase 8's wide&deep
   serve and phase 20 alone (no kernels line, no ok line).
21. the GNN and LM families at published widths, random weights from
   seed 0, fp32 params, each run's CUDA-event ms, peak device memory and
   ``reduced`` (each cut with its reason) on a ``family_run`` line:
   (a) PNA (75 x 4 layers, Adam 0.01, 5 steps, then a forward) on
   full_graph_sm (2,708 nodes x 1,433 features), molecule (128 graphs x
   30 nodes, 64 edges) and minibatch_lg (a 232,965-node, 114.6M-edge
   random graph built on the host, a fresh 1,024-seed 15-10 block a step
   under ``_block_shape``'s bound, the F-Quantization hook on the
   233,472 x 75 node table; the host seconds of the graph and of each
   sample printed); (b) the five LMs in bf16 compute: smollm-135m whole
   (train_4k at batch 8, 3 steps, the hook on ``embed``, Adam 3e-4,
   ``remat="full"``), qwen3-8b whole, deepseek-coder-33b, mixtral-8x22b
   and deepseek-v2-lite-16b cut in depth to what fits beside a prefill
   (``LM_DEPTH``); each prefill_32k at batch 1 (qwen3-8b's and
   deepseek-coder's at 16,384 tokens, ``LM_PREFILL_TOKENS``) and 8
   decode_32k steps (``LM_DECODE_BATCH``), mixtral's and deepseek-v2-lite's long_500k (2
   steps near position 524,287: a rolling 4,096-slot cache, an MLA latent
   cache of 524,288 slots); (c) at each LM's depth, fp32 compute and
   cache: 4 decode steps after a 256-token prefill held to prefills over
   the longer prefixes within 1e-3 * max(1, max|ref|) (MoE capacity factor
   num_experts / top_k); (d) ``python -m repro_torch.launch.train --arch
   X --smoke`` for pna and the five LMs through ``run``, finite, the last
   loss <= 1.05 x the first.  None of the eight kernels runs on these
   paths (their launches printed, all 0).  ``--families-only`` builds the
   kernels and runs phase 21 alone (no kernels line, no ok line).
22. the SPMD layer (``dist.collectives``, ``optim.grad_compress``,
   ``launch.dryrun``): (a) ``error_feedback_allreduce`` over 4 logical
   shards of the card, each a seeded gradient of smollm-135m's parameter
   count (``param_count``, ~134.5M fp32), 3 steps carrying the residual:
   every quantisation launch (``rowwise_quant.cu`` at D = 256, 4 a step,
   ``reciprocal=True``) bit-equal to the plain quantizer, each mean
   within the half-step bound of the fp32 mean of the corrected
   gradients, each residual ``corrected - q * s`` exactly (the fused
   form); the exchange's CUDA-event ms a step, the D = 256 launch's ms
   (in ``quantize_rowwise``'s ``d256``) and the wire bytes against fp32;
   (b) ``split_kv_decode_attention`` at qwen3-8b's decode width (batch 4,
   32 heads, head dim 128, 32,768 fp32 slots, position 16,384) over 4
   views of one cache, within 2e-5 of the full softmax, its ms; (c) the
   dry run through ``launch.dryrun.run`` on dlrm-rm2 serve_p99 and
   train_batch, pna full_graph_sm and smollm-135m decode_32k into a
   temporary directory, ``benchmarks.roofline``'s rows of the records
   printed, no kernel launched.  ``--spmd-only`` builds the kernels and
   runs phase 22 alone (no kernels line, no ok line).

Prints the card's name and power limit, the serve, train, both online,
both hashed and both pipeline records, one JSON ``kernels`` line
(dequant_bag per tier dtype and its tiered entry, bag_grad, bag_matmul
per arch, cin, hashed_gather and hashed_gather_ids per pool dtype,
quantize_rowwise, dequant_bag_rowgrid per tier dtype, bag_grad_rowgrid;
each with its launches on every path, phase 13's to 18's runs
included, phase 19's mesh paths and phase 20's too; the run fails if a
kernel of a main path launched no time on
it, hashed_gather's fp32 plan entry, the hashed train step's forward,
among them), and
as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without that line when there is no CUDA device, or when
the rest of the repository is missing.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the train phase holds a 31.8 GB table and its 31.8 GB gradient; let the
# allocator grow segments instead of fragmenting the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
TPU_KERNEL = ("src/repro/kernels/dequant_bag/kernel.py:172 "
              "dequant_bag_pallas")
SOURCE = "src/repro_torch/csrc/dequant_bag.cu"
TPU_BAG_GRAD = ("src/repro/kernels/dequant_bag/kernel.py:410 "
                "bag_grad_pallas")
SOURCE_BAG_GRAD = "src/repro_torch/csrc/bag_grad.cu"
TPU_BAG_MATMUL = ("src/repro/kernels/bag_matmul/kernel.py:180 "
                  "bag_matmul_pallas")
SOURCE_BAG_MATMUL = "src/repro_torch/csrc/bag_matmul.cu"
TPU_CIN = "src/repro/kernels/cin/kernel.py:53 cin_layer_pallas"
SOURCE_CIN = "src/repro_torch/csrc/cin.cu"
TPU_HASHED = ("src/repro/kernels/hashed_gather/kernel.py:143 "
              "hashed_gather_pallas")
SOURCE_HASHED = "src/repro_torch/csrc/hashed_gather.cu"
TPU_QUANT = ("src/repro/kernels/rowwise_quant/kernel.py:44 "
             "quantize_rowwise_pallas")
SOURCE_QUANT = "src/repro_torch/csrc/rowwise_quant.cu"
TPU_ROWGRID = ("src/repro/kernels/dequant_bag/kernel.py:251 "
               "dequant_bag_pallas_rowgrid")
SOURCE_ROWGRID = "src/repro_torch/csrc/dequant_bag_rowgrid.cu"
TPU_GRAD_ROWGRID = ("src/repro/kernels/dequant_bag/kernel.py:488 "
                    "bag_grad_pallas_rowgrid")
SOURCE_GRAD_ROWGRID = "src/repro_torch/csrc/bag_grad_rowgrid.cu"
SOURCES = ("dequant_bag", "bag_grad", "bag_matmul", "cin", "hashed_gather",
           "rowwise_quant", "dequant_bag_rowgrid", "bag_grad_rowgrid")
HASH_BITS = ("32", "8")
# What the packed paths built and moved before their int8 tier went through
# the rowwise_quant kernel (the last chip run of the previous slice, same
# seeds): the kernel must leave every pack and re-tier as it was.
PACKED_BEFORE = {
    "dlrm-rm2": {"tier_rows": [177837430, 8992843, 17354815],
                 "packed_fp32_ratio": 0.3546792262108044},
    "wide-deep": {"packed_mib": 1227.591, "packed_fp32_ratio": 0.4527,
                  "rows_moved": 6519629, "lookups": 327680, "hits": 0},
    "xdeepfm": {"packed_mib": 1707.587, "packed_fp32_ratio": 0.5162,
                "rows_moved": 11186987, "lookups": 319488, "hits": 36553}}
ONLINE_ARCHS = ("wide-deep", "xdeepfm")
REQUESTS = 16
TRAIN_STEPS = 9
MAX_IND_RANGE = 24_000_000
# the full-width pipeline: 40 steps, so that one checkpoint of the train
# state is written (the reference's ckpt_every 40), every field capped at
# 6M rows (34,184,704 rows: its two branches' checkpoints, packs and fit
# took ~130 s of the 1200 s limit at 12M rows on a slow host; the pipeline
# at 124,185,088 and all 204,185,088 rows is scripts/pipeline_cards.py's)
PIPELINE_STEPS = 40
PIPELINE_MAX_IND_RANGE = 6_000_000
# phase 13: a snapshot line every 4 of wide&deep's 16 requests; the
# bench_qps/v1 sweep at the reference's serve batches
METRICS_EVERY = 4
BENCH_QPS_BATCHES = "1,8,32"
# phase 15: the paper's six jobs, one ``--only`` run each (the runner's
# other jobs, qps and hashed, are phase 16's)
# at the runner's --fast budgets (one shuffle a field in Table 2's
# Permutation arm, 150 training steps a job)
PAPER_SHUFFLES = 1
PAPER_JOBS = ("table2_time", "table3_fquant", "fig3_thresholds",
              "table4_combined", "fig2_fperm", "freq_error")
# phase 14: the shadow build budget in rows a request (a full-width first
# build moves 6.5M / 11.2M rows: 2 / 3 chunks), and requests enough for
# two verified swaps to land on request ticks
SHADOW_ROWS = 1 << 22
SHADOW_REQUESTS = 32
# phase 17: the hier store at full width.  Cold shards of 1,048,576 rows
# (tens of shards; the CLI's default of 4,096 would make thousands), the
# wide&deep budgets each a tenth of the fully packed bytes, dlrm-rm2's
# 4 GiB on the card and 8 GiB in host RAM; every 4th audited micro-batch
# is checked bit for bit
HIER_ROWS_PER_SHARD = 1 << 20
HIER_FRACTION = 0.1
HIER_REQUESTS = 256
HIER_ASYNC_REQUESTS = 4096
HIER_DLRM_REQUESTS = 64
HIER_DLRM_RETIER_EVERY = 64
HIER_DLRM_HBM_MB = 4096
HIER_DLRM_HOST_MB = 8192
HIER_AUDIT_EVERY = 4
# phase 18: the serving fleet at published widths, at the fleet CLI's
# other defaults (256 requests by 8, a merge and a staggered re-tier every
# 64, 128 cache rows, drift 4.0); the async fleet at phase 14's shadow
# budget, with requests enough for swaps to land on request ticks
FLEET_SYNC = (("fleet_wide-deep", "wide-deep", "1,2,4,8"),
              ("fleet_xdeepfm", "xdeepfm", "1,2,4"))
FLEET_ASYNC_REPLICAS = (1, 2, 4)
FLEET_ASYNC_REQUESTS = 1024
# phase 19: the mesh on the one card, N logical row shards of a store;
# the train cell's first 3 steps at mesh 4 beside phase 5's, the pipeline
# at --fast with every field capped at 1,000,000 rows (7,116,800 rows x
# 64: a full-width pipeline writes a 33 GB train checkpoint, ~50 s)
MESHES = (1, 2, 4)
MESH_N = 4
MESH_TRAIN_STEPS = 3
MESH_PIPELINE_ROWS = 1_000_000
# phase 19(e)'s mesh-2 pipeline record equals mesh 1's on these keys
# (tests/test_torch_pipeline_mesh.py's), the final pack's digest included
MESH_PIPELINE_SAME = (
    "train_losses", "finetune_losses", "gradcheck_max_abs_err",
    "tier_rows_int8", "tier_rows_half", "tier_rows_fp32", "bytes_packed",
    "eval_loss_fp32", "eval_loss_packed", "eval_auc_fp32", "eval_auc_packed",
    "retiers", "cache_hit_rate", "final_pack_digest")
SHARD_SUM_ITERS = 50
# phase 20: the kernel record at the reference's shapes, wide&deep's fused
# head and xDeepFM's; bag_matmul_train at wide&deep's widths; the recsys
# family smoke; the examples
KERNEL_SHAPES = "64:8:64:32,32:4:96:16,512:40:32:1024,512:39:10:400"
SMOKE_ARCHS = ("dlrm-rm2", "wide-deep", "xdeepfm", "bert4rec")
EXAMPLES = ("quickstart", "compress_dlrm", "serve_quantized", "train_lm")
BERT4REC_BATCH = 2
# phase 21: the GNN and LM families at published widths.  PNA: 5 steps a
# cell; full_graph_sm's 2,708 nodes at an integer degree of 4 (10,832 of
# the published 10,556 edges), minibatch_lg's 232,965 nodes at degree 492
# (114,618,780 edges).  LMs: the depth that fits in fp32 beside a prefill
# and a decode cache with ~10 GB to spare (absent: whole), smollm's
# train_4k batch, each decode_32k batch, the steps
PNA_STEPS = 5
PNA_SM_DEGREE = 4
PNA_LG_DEGREE = 492
LM_ARCHS = ("smollm-135m", "qwen3-8b", "deepseek-coder-33b", "mixtral-8x22b",
            "deepseek-v2-lite-16b")
LM_DEPTH = {"deepseek-coder-33b": 20, "mixtral-8x22b": 4,
            "deepseek-v2-lite-16b": 20}
LM_TRAIN_BATCH = 8
LM_TRAIN_STEPS = 3
LM_DECODE_BATCH = {"smollm-135m": 64, "qwen3-8b": 4, "deepseek-coder-33b": 8,
                   "mixtral-8x22b": 16, "deepseek-v2-lite-16b": 8}
# prefill tokens cut from 32,768 for the whole smoke's headroom: at 32k
# these two took 44.4 / 48.2 s on an H100 80GB HBM3 at 700 W (20 coder
# layers), and the whole smoke 990.5 s of its 1,200 s on a host whose
# host-bound work ran ~1.3x faster than another's (the minibatch_lg graph
# 30.8 s against 40.2 s)
LM_PREFILL_TOKENS = {"qwen3-8b": 16384, "deepseek-coder-33b": 16384}
LM_DECODE_STEPS = 8
LM_LONG_STEPS = 2
# phase 21(c): decode against prefill at fp32
AGREE_PREFIX = 256
AGREE_STEPS = 4
# phase 22: the SPMD layer.  (a) the int8 gradient exchange over 4 logical
# shards of one card, each a gradient the size of smollm-135m's whole
# parameter vector, 3 steps with the residual carried; (b) split-KV decode
# at qwen3-8b's decode width over 4 views of one cache; (c) the dry run's
# cheap cells, one a family
SPMD_SHARDS = 4
SPMD_STEPS = 3
SPLIT_KV = {"batch": 4, "heads": 32, "head_dim": 128, "slots": 32768}
DRYRUN_CELLS = (("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "train_batch"),
                ("pna", "full_graph_sm"), ("smollm-135m", "decode_32k"))


T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def scales_equal(a, b) -> bool:
    """Bit for bit, except that any NaN equals any NaN (a NaN's payload
    bits are the arithmetic's, not the function's): quantizer scales, and
    the NaN bags of non-finite weights."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                            torch.where(nb, 0.0, b).view(torch.int32)))


def check_kernels(torch, ops, ref) -> float:
    """Phase 2: dequant_bag against dequant_bag_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    worst = 0.0
    for dtype in (torch.int8, torch.bfloat16, torch.float16,
                  torch.float32):
        for d in (64, 33):
            v = 5000
            if dtype == torch.int8:
                payload = torch.randint(-128, 128, (v, d), generator=g,
                                        device=dev, dtype=torch.int8)
            else:
                payload = (torch.randn((v, d), generator=g, device=dev)
                           * 0.1).to(dtype)
            scales = torch.rand(v, generator=g, device=dev) * 0.01
            for b, k in ((1000, 1), (1000, 8), (7, 8), (13_312, 1)):
                idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                    dtype=torch.int32)
                w = torch.rand((b, k), generator=g, device=dev)
                w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
                for s in ((scales, None) if dtype == torch.float32
                          else (scales,)):
                    got = ops.dequant_bag(payload, s, idx, w)
                    want = ref.dequant_bag_ref(payload, s, idx, w)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    if not bits_equal(got, want):
                        raise SystemExit(
                            f"dequant_bag != plain: {dtype} D={d} B={b} "
                            f"K={k} scales={s is not None} max err {err}")
    log(f"kernel check: dequant_bag bit-equal to plain over 4 dtypes x "
        f"D in (64, 33) x (B, K) in 4 shapes (max abs err {worst})")
    return worst


def check_gather_cases(torch, kernel, ops, ref, cases) -> float:
    """Phase 2: the single-tier kernel on ``cases.gather_cases`` (finite
    bags over a NaN row under zero weights; the 2.1 GB int8 payload read
    past 2^31 bytes) and the tiered entry on ``cases.tiered_cases``,
    against the per-tier composition through the plain bag and through
    three single-tier launches (NaN bags under NaN and inf weights)."""
    from repro_torch.core.packed_store import PackedStore

    dev = torch.device("cuda")
    worst = 0.0
    gather = cases.gather_cases(dev)
    for c in gather:
        got = kernel.dequant_bag_cuda(c.payload, c.scales, c.indices,
                                      c.weights)
        want = ref.dequant_bag_ref(c.payload, c.scales, c.indices, c.weights)
        torch.cuda.synchronize()
        if not (bits_equal(got, want) and bool(torch.isfinite(got).all())):
            raise SystemExit(f"dequant_bag != plain on case {c.name}")
        worst = max(worst, float((got - want).abs().max()))
    del gather
    tiered = cases.tiered_cases(dev)
    for c in tiered:
        packed = PackedStore(*c.leaves)
        got = ops.packed_bag_lookup(packed, c.ids, c.weights)
        plain = ops.packed_bag_lookup_tiers(packed, c.ids, c.weights,
                                            bag=ref.dequant_bag_ref)
        composed = ops.packed_bag_lookup_tiers(packed, c.ids, c.weights)
        torch.cuda.synchronize()
        if not (scales_equal(got, plain) and scales_equal(got, composed)):
            raise SystemExit(f"dequant_bag[tiered] != the composition on "
                             f"case {c.name}")
        live = torch.isfinite(got)
        worst = max(worst, float((got[live] - plain[live]).abs().max()))
    log(f"kernel check: dequant_bag bit-equal to plain on "
        f"{len(cases.GATHER_CASE_NAMES) + 1} gather cases, the tiered entry "
        f"to the plain and the three-launch composition on "
        f"{len(tiered)} tiered cases (max abs err {worst})")
    return worst


def check_bag_grad(torch, ops, ref) -> float:
    """Phase 2: bag_grad against bag_grad_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    worst, n = 0.0, 0
    # (B, K, V): sparse rows at K = 1, K = 8 over many / few rows (heavy
    # duplicates), a B that no 8-warp block divides, and B = 0
    shapes = ((4096, 1, 1_000_000), (1001, 8, 5000), (1001, 8, 50),
              (37, 3, 7), (0, 4, 10))
    for d in (64, 33, 200):
        for b, k, v in shapes:
            grad = torch.randn((b, d), generator=g, device=dev)
            idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            scales = torch.rand(v, generator=g, device=dev) * 3
            w = torch.rand((b, k), generator=g, device=dev)
            masked = w.clone()
            masked[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
            for s in (None, scales):
                for wt in (None, w, masked):
                    got = ops.bag_grad(grad, s, idx, wt, v)
                    want = ref.bag_grad_ref(grad, s, idx, wt, v)
                    torch.cuda.synchronize()
                    if not bits_equal(got, want):
                        err = float((got - want).abs().max())
                        raise SystemExit(
                            f"bag_grad != plain: B={b} K={k} D={d} V={v} "
                            f"scales={s is not None} weights="
                            f"{'none' if wt is None else 'set'} err {err}")
                    if got.numel():
                        worst = max(worst, float((got - want).abs().max()))
                    n += 1
    log(f"kernel check: bag_grad bit-equal to plain in {n} cases (K 1-8, "
        f"scales on/off, 40% masked, duplicates, D 64/33/200, B=0; max abs "
        f"err {worst})")
    return worst


def check_bag_grad_schedules(torch, kernel, ref) -> float:
    """Phase 2: bag_grad's schedules and the (B, K)-grid oracle's
    (``cases.bag_grad_cases``: one row of every slot, runs at the
    heavy-run threshold and one either side, zero coefficients over a NaN
    cotangent, D 1-200 off 16-byte alignment; a hot row's bucket, every
    slot in one bucket, rows repeating inside and across the oracle's
    windows, K 3, B 0), each with and without a precomputed grouping, bit
    for bit against the plain version and the oracle."""
    from repro_torch.kernels import cases
    dev = torch.device("cuda")
    worst, n = 0.0, 0
    for case in cases.bag_grad_cases(dev, kernel.HEAVY_RUN):
        want = ref.bag_grad_ref(case.g, None, case.indices, case.coeff,
                                case.vocab)
        oracle = kernel.bag_grad_rowgrid_cuda(
            case.g, case.indices, case.coeff, torch.zeros_like(want))
        for plan in (None, kernel.plan_slots(case.indices)):
            case.out.zero_()
            got = kernel.bag_grad_cuda(case.g, case.indices, case.coeff,
                                       case.out, plan=plan)
            torch.cuda.synchronize()
            if not (bits_equal(got, want) and bits_equal(oracle, want)
                    and bool(torch.isfinite(got).all())):
                raise SystemExit(
                    f"bag_grad[{case.name}, plan={plan is not None}] != "
                    f"plain or rowgrid: max err "
                    f"{float((got - want).abs().max())}, rowgrid "
                    f"{float((oracle - want).abs().max())}")
            worst = max(worst, float((got - want).abs().max()))
            n += 1
    log(f"kernel check: bag_grad bit-equal to plain and to "
        f"bag_grad_rowgrid in {n} schedule cases (one row of 65,536 slots; "
        f"runs of {kernel.HEAVY_RUN} +- 1 and {16 * kernel.HEAVY_RUN} + 0/1 "
        f"slots; 30% zero coefficients over a NaN cotangent; D 1/8/10/33/"
        f"64/128/200 off 16-byte alignment; the oracle's buckets: one row's "
        f"65,536 slots beside rows of its bucket, every slot in one bucket, "
        f"runs of rows sharing a bucket, rows repeating inside and across "
        f"32-slot windows, K 3, B 0; each with and without a precomputed "
        f"grouping; max abs err {worst})")
    return worst


def check_rowgrid(torch, ops, ref) -> tuple[float, float]:
    """Phase 2: the two (B, K)-grid oracles against their plain versions
    and against the tiled kernels on the card, bit for bit."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    worst_dq, n_dq = 0.0, 0
    for dtype in (torch.int8, torch.bfloat16, torch.float16,
                  torch.float32):
        for d in (64, 33):
            v = 5000
            payload = _payload(torch, dtype, v, d, g, dev)
            scales = torch.rand(v, generator=g, device=dev) * 0.01
            for b, k in ((1000, 1), (1000, 8), (7, 8), (13_312, 1), (0, 3)):
                idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                    dtype=torch.int32)
                w = torch.rand((b, k), generator=g, device=dev)
                w[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
                for s in ((scales, None) if dtype == torch.float32
                          else (scales,)):
                    got = ops.dequant_bag_rowgrid(payload, s, idx, w)
                    want = ref.dequant_bag_rowgrid_ref(payload, s, idx, w)
                    tiled = ops.dequant_bag(payload, s, idx, w)
                    torch.cuda.synchronize()
                    if not (bits_equal(got, want) and bits_equal(got, tiled)):
                        raise SystemExit(
                            f"dequant_bag_rowgrid != plain or tiled: {dtype} "
                            f"D={d} B={b} K={k} scales={s is not None}")
                    if got.numel():
                        worst_dq = max(worst_dq,
                                       float((got - want).abs().max()))
                    n_dq += 1
        # the rule each kernel keeps: a NaN row (a NaN scale for int8) in
        # a zero-weight slot makes the rowgrid bag NaN, the tiled kernel
        # skips the slot
        b, k, bad = 64, 4, 17
        payload = _payload(torch, dtype, v, 64, g, dev)
        scales = torch.rand(v, generator=g, device=dev) * 0.01
        idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                            dtype=torch.int32)
        idx[idx == bad] = bad + 1
        w = torch.rand((b, k), generator=g, device=dev) + 0.5
        idx[::2, 1], w[::2, 1] = bad, 0.0
        if dtype == torch.int8:
            scales[bad] = float("nan")
        else:
            payload[bad] = float("nan")
        got = ops.dequant_bag_rowgrid(payload, scales, idx, w)
        want = ref.dequant_bag_rowgrid_ref(payload, scales, idx, w)
        tiled = ops.dequant_bag(payload, scales, idx, w)
        tiled_want = ref.dequant_bag_ref(payload, scales, idx, w)
        torch.cuda.synchronize()
        if not (scales_equal(got, want) and bits_equal(tiled, tiled_want)
                and bool(torch.isnan(got[::2]).all())
                and bool(torch.isfinite(tiled).all())
                and bits_equal(got[1::2], tiled[1::2])):
            raise SystemExit(f"dequant_bag_rowgrid NaN rule broken: {dtype}")
        n_dq += 1
    # the vector path: every dtype at K 1-8 over ragged and wide D (a
    # lane's last columns partial, G capped at 32 lanes), a payload off
    # 16-byte alignment, and an inf row (an inf scale for int8) under a
    # zero weight: NaN bags in the rowgrid forms only
    for dtype in (torch.int8, torch.bfloat16, torch.float16,
                  torch.float32):
        for d in (1, 10, 33, 200):
            v = 997
            payload = _payload(torch, dtype, v, d, g, dev)
            if d == 10:               # one element off 16-byte alignment
                flat = torch.empty(v * d + 1, dtype=dtype, device=dev)
                payload = flat[1:].view(v, d).copy_(payload)
            scales = torch.rand(v, generator=g, device=dev) * 0.01
            for k in range(1, 9):
                b, bad = 37 + 8 * k, 5
                idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                    dtype=torch.int32)
                idx[idx == bad] = bad + 1
                w = torch.rand((b, k), generator=g, device=dev) + 0.5
                w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
                idx[::3, k - 1], w[::3, k - 1] = bad, 0.0
                sc = scales.clone()
                if dtype == torch.int8:
                    sc[bad] = float("inf")
                else:
                    payload[bad] = float("inf")
                got = ops.dequant_bag_rowgrid(payload, sc, idx, w)
                want = ref.dequant_bag_rowgrid_ref(payload, sc, idx, w)
                tiled = ops.dequant_bag(payload, sc, idx, w)
                torch.cuda.synchronize()
                if not (scales_equal(got, want)
                        and bool(torch.isnan(got[::3]).all())
                        and bits_equal(got[torch.isfinite(got).all(1)],
                                       tiled[torch.isfinite(got).all(1)])
                        and int(torch.isfinite(got).all(1).sum())
                        == b - len(range(0, b, 3))):
                    raise SystemExit(f"dequant_bag_rowgrid != plain or tiled "
                                     f"on the vector path: {dtype} D={d} "
                                     f"K={k}")
                live = torch.isfinite(got)
                worst_dq = max(worst_dq, float((got[live] - want[live])
                                               .abs().max()))
                n_dq += 1
    # the tiled kernel's gather cases (every dtype at D 1/10/32/33/64/128,
    # K 1/8/40, payloads off 16-byte alignment, a NaN row under zero
    # weights, the 2.1 GB int8 payload read past 2^31 bytes)
    from repro_torch.kernels import cases
    gather = cases.gather_cases(dev)
    for c in gather:
        args = (c.payload, c.scales, c.indices, c.weights)
        got = ops.dequant_bag_rowgrid(*args)
        want = ref.dequant_bag_rowgrid_ref(*args)
        tiled = ops.dequant_bag(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(got).all(1)
        if not (scales_equal(got, want) and bits_equal(got[fin], tiled[fin])):
            raise SystemExit(f"dequant_bag_rowgrid != plain or tiled on case "
                             f"{c.name}")
        n_dq += 1
    del gather
    log(f"kernel check: dequant_bag_rowgrid bit-equal to its plain version "
        f"and to dequant_bag in {n_dq} cases (4 dtypes, D 1/10/33/64/200, K "
        f"1-8, B 0, a payload off 16-byte alignment; the "
        f"{len(cases.GATHER_CASE_NAMES) + 1} gather cases; a NaN or inf row "
        f"in a zero-weight slot: NaN bags in both rowgrid forms, finite in "
        f"both tiled forms; max abs err {worst_dq})")

    worst_grad, n_grad = 0.0, 0
    shapes = ((4096, 1, 1_000_000), (1001, 8, 5000), (1001, 8, 50),
              (37, 3, 7), (0, 4, 10))
    for d in (64, 33, 200):
        for b, k, v in shapes:
            grad = torch.randn((b, d), generator=g, device=dev)
            idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            scales = torch.rand(v, generator=g, device=dev) * 3
            w = torch.rand((b, k), generator=g, device=dev)
            masked = w.clone()
            masked[torch.rand((b, k), generator=g, device=dev) < 0.4] = 0.0
            for s in (None, scales):
                for wt in (None, w, masked):
                    got = ops.bag_grad_rowgrid(grad, s, idx, wt, v)
                    want = ref.bag_grad_rowgrid_ref(grad, s, idx, wt, v)
                    tiled = ops.bag_grad(grad, s, idx, wt, v)
                    torch.cuda.synchronize()
                    if not (bits_equal(got, want) and bits_equal(got, tiled)):
                        raise SystemExit(
                            f"bag_grad_rowgrid != plain or tiled: B={b} K={k}"
                            f" D={d} V={v} scales={s is not None}")
                    if got.numel():
                        worst_grad = max(worst_grad,
                                         float((got - want).abs().max()))
                    n_grad += 1
    # a NaN cotangent in a bag whose coefficients are all zero: skipped
    grad = torch.randn((64, 64), generator=g, device=dev)
    idx = torch.randint(0, 100, (64, 4), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((64, 4), generator=g, device=dev) + 0.5
    grad[5], w[5] = float("nan"), 0.0
    got = ops.bag_grad_rowgrid(grad, None, idx, w, 100)
    want = ref.bag_grad_rowgrid_ref(grad, None, idx, w, 100)
    tiled = ops.bag_grad(grad, None, idx, w, 100)
    torch.cuda.synchronize()
    if not (bits_equal(got, want) and bits_equal(got, tiled)
            and bool(torch.isfinite(got).all())):
        raise SystemExit("bag_grad_rowgrid: a NaN cotangent under zero "
                         "coefficients leaked")
    n_grad += 1
    log(f"kernel check: bag_grad_rowgrid bit-equal to its plain version and "
        f"to bag_grad in {n_grad} cases (K 1-8, scales on/off, 40% masked, "
        f"duplicates, D 64/33/200, B=0, a NaN cotangent under zero "
        f"coefficients; max abs err {worst_grad})")
    return worst_dq, worst_grad


def time_launches(torch, fn, args_list, flush) -> float:
    """Mean ms of ``fn(*args)`` over ``args_list``, each launch timed by
    its own CUDA events with the 50 MB L2 flushed before it (a request's
    rows are cold: the next request draws other rows)."""
    fn(*args_list[0])
    pairs = []
    for args in args_list:
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def serve_tier_inputs(torch, served, n: int = 64) -> tuple:
    """Each tier's dequant_bag launch inputs for ``n`` served requests
    (B*F = 13,312 slots, K = 1; other tiers' slots weigh 0), and per tier
    the mean live slots, distinct live rows and distinct rows over all
    slots a request."""
    from repro_torch.core.packed_store import _split
    from repro_torch.models.embedding import globalize

    packed = served.packed
    dev = packed.payload32.device
    tiers = (("int8", packed.payload8, packed.scale8),
             ("bfloat16", packed.payload16, packed.scale16),
             ("float32", packed.payload32, None))
    inputs = {name: [] for name, _, _ in tiers}
    live_slots = {name: 0 for name, _, _ in tiers}
    touched = {name: 0 for name, _, _ in tiers}
    read = {name: 0 for name, _, _ in tiers}
    for r in range(n):
        idx = served.make_request(1000 + r)["indices"].to(dev)
        tier, loc = _split(packed, globalize(idx, served.model.spec)
                           .reshape(-1, 1))
        for t, (name, payload, scales) in enumerate(tiers):
            w = (tier == t).to(torch.float32).contiguous()
            li = loc.clamp(0, payload.shape[0] - 1).to(torch.int32)
            inputs[name].append((payload, scales, li.contiguous(), w))
            live_slots[name] += int((w != 0).sum())
            touched[name] += int(torch.unique(li[w != 0]).numel())
            read[name] += int(torch.unique(li).numel())
    per = {name: {"live_slots": live_slots[name] / n,
                  "distinct_live_rows": touched[name] / n,
                  "distinct_rows": read[name] / n} for name in inputs}
    return tiers, inputs, per


def measure(torch, served, kernel, ref, launches, worst) -> list[dict]:
    """Phase 4: each tier's launch at the serving shapes."""
    import torch.nn.functional as F

    dev = served.packed.payload32.device
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tiers, inputs, per = serve_tier_inputs(torch, served)
    out = []
    for name, payload, scales in tiers:
        args = inputs[name]
        b, k = args[0][2].shape
        d = payload.shape[1]
        # Bytes the function must move: every weight, the index of each
        # live slot (w != 0), each distinct live row with its scale once,
        # and the output; flops: 3 per element of a live slot (2 unscaled).
        slots = per[name]["live_slots"]
        rows = per[name]["distinct_live_rows"]
        row_bytes = d * payload.element_size() + (4 if scales is not None
                                                  else 0)
        nbytes = b * k * 4 + slots * 4 + rows * row_bytes + b * d * 4
        flops = slots * d * (3 if scales is not None else 2)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        for a in args[:4]:            # the main path's own inputs
            got, want = kernel.dequant_bag_cuda(*a), ref.dequant_bag_ref(*a)
            if not bits_equal(got, want):
                raise SystemExit(f"dequant_bag[{name}] != plain on the "
                                 "served store")
            worst = max(worst, float((got - want).abs().max()))
        ms = time_launches(torch, kernel.dequant_bag_cuda, args, flush)
        plain_ms = time_launches(torch, ref.dequant_bag_ref, args, flush)
        library_ms = None
        if scales is None:
            def library(p, s, i, w):
                return F.embedding_bag(i, p, mode="sum",
                                       per_sample_weights=w)
            got = library(*args[0])
            if not torch.equal(got, kernel.dequant_bag_cuda(*args[0])):
                raise SystemExit("embedding_bag disagrees with the fp32 "
                                 "tier launch")
            library_ms = time_launches(torch, library, args, flush)
        out.append({
            "name": f"dequant_bag[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": TPU_KERNEL,
            "launches": launches[name], "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / FP32_FLOPS else "operations",
            "library_ms": library_ms,
            "slots": b * k, "live_slots": slots, "distinct_live_rows": rows,
            "bytes": nbytes})
    return out


def measure_tiered(torch, served, ops, ref, launches: int, worst: float,
                   flush) -> dict:
    """Phase 4: the tiered entry on 64 served requests' ids (512 x 26
    global ids a request, K = 1) against the per-tier composition (three
    single-tier launches and the glue that splits, masks, clamps and adds:
    events around the whole call), its plain version (the composition
    through the plain bag) and its bound."""
    from repro_torch.core.packed_store import _TIER_SHIFT
    from repro_torch.models.embedding import globalize

    packed = served.packed
    dev = packed.payload32.device
    args, nbytes = [], 0.0
    row_bytes = (packed.dim * 1 + 4, packed.dim * packed.payload16
                 .element_size() + 4, packed.dim * 4)
    n = 64
    for r in range(n):
        ids = globalize(served.make_request(1000 + r)["indices"].to(dev),
                        served.model.spec).reshape(-1, 1)
        args.append((packed, ids))
        # the ids, each distinct id's indirect word, its row (and scale)
        # once, the output
        distinct = torch.unique(ids)
        tiers = (packed.indirect[distinct] >> _TIER_SHIFT).to(torch.int64)
        by_tier = torch.bincount(tiers, minlength=3).tolist()
        nbytes += (ids.numel() * ids.element_size() + distinct.numel() * 4
                   + sum(c * b for c, b in zip(by_tier, row_bytes))
                   + ids.shape[0] * packed.dim * 4) / n
    for a in args[:4]:
        got = ops.packed_bag_lookup(*a)
        plain = ops.packed_bag_lookup_tiers(*a, bag=ref.dequant_bag_ref)
        composed = ops.packed_bag_lookup_tiers(*a)
        torch.cuda.synchronize()
        if not (bits_equal(got, plain) and bits_equal(got, composed)):
            raise SystemExit("dequant_bag[tiered] != the per-tier composition "
                             "on the served store")
        worst = max(worst, float((got - plain).abs().max()))
    b, d = args[0][1].shape[0], packed.dim
    ms = time_launches(torch, ops.packed_bag_lookup, args, flush)
    composed_ms = time_launches(torch, ops.packed_bag_lookup_tiers, args,
                                flush)
    plain_ms = time_launches(
        torch, lambda p, i: ops.packed_bag_lookup_tiers(
            p, i, bag=ref.dequant_bag_ref), args[:4], flush)
    bound_ms, bound_by = _bound(nbytes, 3 * b * d)
    log(f"dequant_bag[tiered] at a dlrm request's {b:,} ids: {ms:.4f} ms "
        f"(per-tier composition {composed_ms:.4f}, plain {plain_ms:.3f}, "
        f"bound {bound_ms:.5f}); bit-equal to both compositions")
    return {"name": "dequant_bag[tiered]", "route": "cuda",
            "source": SOURCE, "replaces": TPU_KERNEL + " (one call a tier, "
            "src/repro/kernels/dequant_bag/ops.py:181-207)",
            "launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "composition_ms": composed_ms,
            "slots": b, "bytes": nbytes,
            "per": "call (one dlrm request's lookup: the tiered launch; "
                   "composition_ms the three single-tier launches and glue)"}


def measure_dequant_rowgrid(torch, served, kernel, ref, worst: float
                            ) -> list[dict]:
    """Phase 4: the (B, K)-grid oracle on each tier's launch inputs of 64
    served requests (13,312 slots, all read: the other tiers' slots weigh
    0 but the oracle reads their clamped rows too), held to its plain
    version and to the tiled kernel, then timed beside both, its bound and
    a library call."""
    import torch.nn.functional as F

    dev = served.packed.payload32.device
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tiers, inputs, per = serve_tier_inputs(torch, served)
    out = []
    for name, payload, scales in tiers:
        args = inputs[name]
        b, k = args[0][2].shape
        d = payload.shape[1]
        for a in args[:4]:
            got = kernel.dequant_bag_rowgrid_cuda(*a)
            want = ref.dequant_bag_rowgrid_ref(*a)
            if not (bits_equal(got, want)
                    and bits_equal(got, kernel.dequant_bag_cuda(*a))):
                raise SystemExit(f"dequant_bag_rowgrid[{name}] != plain or "
                                 "tiled on the served store")
            worst = max(worst, float((got - want).abs().max()))
        ms = time_launches(torch, kernel.dequant_bag_rowgrid_cuda, args,
                           flush)
        tiled_ms = time_launches(torch, kernel.dequant_bag_cuda, args, flush)
        plain_ms = time_launches(torch, ref.dequant_bag_rowgrid_ref, args,
                                 flush)
        library_ms = None
        if scales is None:
            library_ms = time_launches(
                torch, lambda p, s, i, w: F.embedding_bag(
                    i, p, mode="sum", per_sample_weights=w), args, flush)
        # bytes the oracle's function must move: every slot's index and
        # weight, each distinct row any slot reads (with its scale), the
        # output; 3 flops an element of every slot (2 unscaled)
        row_bytes = d * payload.element_size() + (4 if scales is not None
                                                  else 0)
        nbytes = (b * k * 8 + per[name]["distinct_rows"] * row_bytes
                  + b * d * 4)
        bound_ms, bound_by = _bound(
            nbytes, b * k * d * (3 if scales is not None else 2))
        out.append({
            "name": f"dequant_bag_rowgrid[{name}]", "route": "cuda",
            "source": SOURCE_ROWGRID, "replaces": TPU_ROWGRID,
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "tiled_ms": tiled_ms, "slots": b * k,
            "distinct_rows": per[name]["distinct_rows"], "bytes": nbytes,
            "per": "launch (one tier of a dlrm serve request)"})
        log(f"dequant_bag_rowgrid[{name}] at the serve request's {b * k:,} "
            f"slots: {ms:.4f} ms (tiled {tiled_ms:.4f}, plain {plain_ms:.4f},"
            f" bound {bound_ms:.5f}); bit-equal to plain and tiled")
    return out


def check_packed_as_before(rec: dict, arch: str) -> None:
    """The pack (and, online, the re-tiers and the cache) is what it was
    before the int8 tier went through the rowwise_quant kernel."""
    for key, want in PACKED_BEFORE[arch].items():
        if rec[key] != want:
            raise SystemExit(f"{arch}: {key} {rec[key]} != {want}, the value "
                             "before the int8 tier quantized through the "
                             "kernel")


def serve_full(torch, serve, kernels_mod, kernel, ops, ps) -> tuple:
    """Phase 3: the main path at full width, with the counts around it."""
    from repro_torch.configs.common import RECSYS_SHAPES
    batch_size = RECSYS_SHAPES["serve_p99"]["batch"]
    argv = ["--model", "full", "--batch", str(batch_size), "--requests",
            str(REQUESTS)]
    kernels_mod.reset_launches()
    served = serve.run(serve.parse_args(argv))
    launches = dict(kernel.launches)
    quant = kernels_mod.launch_counts()["quantize_rowwise"]
    rec = served.record
    # one tiered launch a request, no single-tier launch
    single = sum(n for t, n in launches.items() if t != "tiered")
    if (launches["tiered"] != REQUESTS or single
            or rec["kernel_launches"] != REQUESTS):
        raise SystemExit(f"main path did not launch the tiered kernel once "
                         f"a request: {launches}, record "
                         f"{rec['kernel_launches']}")
    if quant <= 0 or rec["build_kernel_launches"]["quantize_rowwise"] != quant:
        raise SystemExit(f"the build did not quantize its int8 tier through "
                         f"the kernel: {quant} launches, record "
                         f"{rec['build_kernel_launches']}")
    launches["quantize_rowwise"] = quant
    if rec["device"] != "cuda" or rec["packed_fp32_ratio"] > 0.55:
        raise SystemExit(f"unexpected serve record {rec}")
    check_packed_as_before(rec, "dlrm-rm2")

    from repro_torch.models.embedding import globalize
    dev = served.packed.payload32.device
    batch = {k: v.to(dev) for k, v in served.make_request(0).items()}
    with torch.inference_mode():
        gidx = globalize(batch["indices"], served.model.spec)
        emb = ps.lookup_fused(served.packed, gidx)
        plain = ps.lookup(served.packed, gidx)
        logits = served.model.head(served.params, emb, batch)
        cpu_params = {"net": {m: {layer: {p: x.cpu() for p, x in q.items()}
                                  for layer, q in net.items()}
                              for m, net in served.params["net"].items()}}
        ref_logits = served.model.head(
            cpu_params, plain.cpu(), {k: v.cpu() for k, v in batch.items()})
    torch.cuda.synchronize()
    if not bits_equal(emb, plain):
        raise SystemExit("served embeddings differ from the plain lookup")
    if logits.shape != (batch_size,) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"bad logits {tuple(logits.shape)}")
    diff = (logits.cpu() - ref_logits).abs()
    if not bool((diff <= 1e-4 * ref_logits.abs().clamp_min(1.0)).all()):
        raise SystemExit(f"served logits off the CPU head by "
                         f"{float(diff.max())}")
    # every tier at a training batch's 1,703,936 slots (uniform ids): the
    # pipeline's pack has no bf16 row at its priorities, this one has all
    # three tiers
    n = RECSYS_SHAPES["train_batch"]["batch"]
    spec = served.model.spec
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        ids = torch.randint(0, 1 << 62, (n, spec.num_fields), generator=gen,
                            device=dev) % torch.tensor(
                                spec.cardinalities, device=dev)
        gidx = globalize(ids, spec)
        emb = ps.lookup_fused(served.packed, gidx)
        plain = ps.lookup(served.packed, gidx)
        # the per-tier composition: three single-tier launches and glue
        composed = ops.packed_bag_lookup_tiers(
            served.packed, gidx.reshape(-1, 1)).reshape(emb.shape)
        by_tier = torch.bincount(
            ps.packed_tiers(served.packed)[gidx.to(torch.int64)].reshape(-1)
            .to(torch.int64), minlength=3).tolist()
    if (not bits_equal(emb, plain) or not bits_equal(emb, composed)
            or min(by_tier) <= 0):
        raise SystemExit(f"a {n}-sample lookup differs from the plain one "
                         f"or the per-tier composition, or misses a tier: "
                         f"slots by tier {by_tier}")
    rec["check_full_batch_lookup"] = {"slots": int(gidx.numel()),
                                      "slots_by_tier": by_tier}
    del ids, gidx, emb, plain, composed
    log(f"serve check: one tiered launch a request; embeddings bit-equal to "
        f"plain lookup (a request, and {n} x {spec.num_fields} slots by tier "
        f"{by_tier}, also to the per-tier composition), logits within "
        f"{float(diff.max()):.3g} of the CPU head; int8 tier quantized in "
        f"{quant} rowwise_quant launches, tiers {rec['tier_rows']} as before")
    return served, launches


def train_full(torch, kernel, autodiff, setup_mod, arch) -> tuple:
    """Phase 5: the compressed train step at full width, with the counts
    around it.  Returns (record, one batch's (B, F) global rows, V)."""
    import numpy as np

    from repro_torch.configs.common import RECSYS_SHAPES
    dev = torch.device("cuda")
    batch = RECSYS_SHAPES["train_batch"]["batch"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr = setup_mod.build_recsys_training(
        arch, batch=batch, device=dev, model="full",
        max_ind_range=MAX_IND_RANGE)
    batches = [tr.batch_fn(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = tr.state
    vocab, dim = state.params["embed_table"].shape
    log(f"train setup: {vocab:,} rows x {dim}, batch {batch}, "
        f"{build_s:.1f}s; reduced: {tr.reduced}")

    losses, step_ms, stages, digests = [], [], [], []
    kernel.reset_launches()
    for b in batches:
        marks = []

        def mark(stage, marks=marks):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))

        torch.cuda.synchronize()
        t = time.perf_counter()
        mark("start")
        state, m = tr.step(state, b, mark=mark)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        stages.append({name: a.elapsed_time(e) for (_, a), (name, e)
                       in zip(marks, marks[1:])})
        if len(digests) < MESH_TRAIN_STEPS:
            # phase 19(d)'s mesh-1 reference, outside the step's window
            digests.append(state_digests(torch, state))
    launches = {"dequant_bag": kernel.total_launches(),
                "bag_grad": kernel.bag_grad_launches["float32"]}
    peak = torch.cuda.max_memory_allocated()
    if launches != {"dequant_bag": TRAIN_STEPS, "bag_grad": TRAIN_STEPS}:
        raise SystemExit(f"train path did not launch each kernel once a "
                         f"step: {launches} over {TRAIN_STEPS} steps")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite training loss: {losses}")

    gidx = tr.indices_fn(batches[0])
    table = state.params["embed_table"]
    with torch.no_grad():
        emb = autodiff.lookup_train(table, gidx)
    if not bits_equal(emb, table[gidx.to(torch.int64)]):
        raise SystemExit("training gather != table[gidx]")
    names = list(stages[-1])
    rec = {"train": {
        "arch": arch.name, "model": "full", "batch": batch,
        "steps": TRAIN_STEPS, "rows": vocab, "dim": dim,
        "reduced": tr.reduced, "losses": losses,
        "step_ms": step_ms, "step_ms_p50": float(np.median(step_ms[1:])),
        "stage_ms_p50": {n: float(np.median([st[n] for st in stages[1:]]))
                         for n in names},
        "kernel_launches": launches,
        "max_memory_allocated_bytes": peak, "base_allocated_bytes": base,
        "digests": digests,
        "device_name": torch.cuda.get_device_name(0), "setup_s": build_s}}
    log(f"train check: {TRAIN_STEPS} steps, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, one launch of each kernel a step, gather "
        f"bit-equal to table[gidx]; peak {peak / 1e9:.2f} GB")
    return rec, gidx, vocab


def train_batch_ids(torch, arch) -> tuple:
    """Phase 5's first batch's (B, F) global rows and the table's rows,
    from the data stream alone (``train.setup.build_recsys_training``'s
    ``CriteoSynth`` at seed 0, fields capped at ``MAX_IND_RANGE``), with
    no train state: ``--rowgrid-only``'s training batch."""
    import dataclasses

    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.data.criteo import CriteoConfig, CriteoSynth
    from repro_torch.models import embedding as E
    from repro_torch.models.recsys import make_dlrm
    cfg = dataclasses.replace(arch.cfg, cardinalities=tuple(
        min(int(c), MAX_IND_RANGE) for c in arch.cfg.cardinalities))
    spec = make_dlrm(cfg).spec
    ds = CriteoSynth(CriteoConfig(
        num_fields=spec.num_fields,
        cardinalities=tuple(int(c) for c in spec.cardinalities),
        num_dense=max(arch.num_dense, 1),
        important_fields=max(1, spec.num_fields // 2), seed=0))
    batch = ds.batch(RECSYS_SHAPES["train_batch"]["batch"], 0)
    ids = torch.from_numpy(batch["indices"]).to("cuda")
    return E.globalize(ids, spec), spec.total_rows


def measure_train_forward(torch, kernel, ref, gidx, vocab: int,
                          flush) -> dict:
    """Phase 6: the single-tier kernel at the training forward's shape
    (one batch's 65,536 x 26 slots, K = 1, unit weights, no scales) over
    a (V, 64) fp32 table whose touched rows are drawn from a seed: bit for
    bit against its plain version and ``F.embedding_bag``, then timed
    beside both and its bound; the (B, K)-grid oracle on the same slots,
    bit-equal to it and timed beside it (twice, around the library call).
    Returns (the tiled kernel's train_shape, the oracle's)."""
    import torch.nn.functional as F

    dev = gidx.device
    idx = gidx.reshape(-1, 1).to(torch.int32).contiguous()
    w = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    distinct = torch.unique(idx).to(torch.int64)
    table = torch.empty((vocab, 64), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    table[distinct] = torch.randn((distinct.numel(), 64), generator=g,
                                  device=dev) * 0.01
    args = [(table, None, idx, w)]
    got = kernel.dequant_bag_cuda(*args[0])
    want = ref.dequant_bag_ref(*args[0])

    def library(p, s, i, wt):
        return F.embedding_bag(i, p, mode="sum", per_sample_weights=wt)
    lib = library(*args[0])
    torch.cuda.synchronize()
    if not (bits_equal(got, want) and bits_equal(got, lib)):
        raise SystemExit("dequant_bag at the training shape != plain or "
                         "embedding_bag")
    # the (B, K)-grid oracle on the same slots (unit weights: every slot
    # is live, so it reads what the tiled kernel reads), bit-equal to it
    oracle = kernel.dequant_bag_rowgrid_cuda(*args[0])
    torch.cuda.synchronize()
    if not bits_equal(oracle, got):
        raise SystemExit("dequant_bag_rowgrid at the training shape != "
                         "dequant_bag")
    del got, want, lib, oracle
    reps = args * 10
    ms = time_launches(torch, kernel.dequant_bag_cuda, reps, flush)
    rowgrid_ms = time_launches(torch, kernel.dequant_bag_rowgrid_cuda, reps,
                               flush)
    library_ms = time_launches(torch, library, reps, flush)
    rowgrid_ms_again = time_launches(
        torch, kernel.dequant_bag_rowgrid_cuda, reps, flush)
    plain_ms = time_once(torch, ref.dequant_bag_ref, *args[0])
    rowgrid_plain_ms = time_once(torch, ref.dequant_bag_rowgrid_ref,
                                 *args[0])
    n = idx.numel()
    # each slot's index and weight, each distinct row once, the output
    nbytes = n * 8 + distinct.numel() * 256 + n * 256
    bound_ms, bound_by = _bound(nbytes, 2 * n * 64)
    log(f"dequant_bag[float32] at the training forward ({n:,} slots over "
        f"{vocab:,} rows, {distinct.numel():,} distinct): {ms:.4f} ms "
        f"({bound_ms / ms:.1%} of its {bound_ms:.4f} ms bound; "
        f"embedding_bag {library_ms:.4f}, plain {plain_ms:.2f}); bit-equal "
        f"to both; dequant_bag_rowgrid {rowgrid_ms:.4f} / "
        f"{rowgrid_ms_again:.4f} ms ({bound_ms / rowgrid_ms:.1%} of the "
        f"bound), bit-equal")
    del table
    shape = {"slots": n, "distinct_rows": int(distinct.numel()),
             "vocab": vocab, "bytes": nbytes, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms,
             "per": "launch (the training forward)"}
    return ({"ms": ms, "plain_ms": plain_ms, **shape},
            {"ms": rowgrid_ms, "ms_again": rowgrid_ms_again,
             "plain_ms": rowgrid_plain_ms, "tiled_ms": ms, **shape})


def kernel_split(torch, fn, args, launches: int = 3) -> dict:
    """Device ms a launch of each CUDA kernel that ``fn(*args)`` runs,
    from a profiler window over ``launches`` calls (names cut at their
    template arguments); empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn(*args)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            name = e.key.replace("(anonymous namespace)::", "")
            name = (name.split("(")[0].split("<")[0].split("::")[-1].split()
                    or [name])[-1]
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / launches)
    return split


def measure_bag_grad(torch, kernel, ref, gidx, vocab: int, flush,
                     worst: float) -> dict:
    """Phase 6: bag_grad on one training batch's slots."""
    dev = gidx.device
    n, d = gidx.numel(), 64
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    grad = torch.randn((n, d), generator=g, device=dev)
    idx = gidx.reshape(-1, 1).contiguous()
    coeff = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    # the batch's duplicate pattern on a compact vocab: rows renumbered
    # by rank, so the plain version's dense output fits beside ours
    uniq, inv = torch.unique(idx.reshape(-1), return_inverse=True)
    u = uniq.numel()
    depth = int(torch.bincount(inv).max())
    cidx = inv.to(torch.int32).reshape(-1, 1).contiguous()
    got = kernel.bag_grad_cuda(grad, cidx, coeff, torch.zeros((u, d),
                                                               device=dev))
    want = ref.bag_grad_ref(grad, None, cidx, coeff, u)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise SystemExit("bag_grad != plain on a training batch's slots")
    worst = max(worst, float((got - want).abs().max()))
    got_rg = kernel.bag_grad_rowgrid_cuda(grad, cidx, coeff,
                                          torch.zeros((u, d), device=dev))
    torch.cuda.synchronize()
    if not bits_equal(got_rg, got):
        raise SystemExit("bag_grad_rowgrid != bag_grad on a training "
                         "batch's slots")
    del got, want, got_rg, cidx, inv
    log(f"kernel check: bag_grad bit-equal to plain on one training "
        f"batch ({n:,} slots, {u:,} distinct rows, longest row {depth:,} "
        f"slots)")

    out = torch.zeros((vocab, d), device=dev)
    reps = [(grad, idx, coeff, out)] * 10
    ms = time_launches(torch, kernel.bag_grad_cuda, reps, flush)
    plan = kernel.plan_slots(idx)
    ms_grouped = time_launches(
        torch, lambda *a: kernel.bag_grad_cuda(*a, plan=plan), reps, flush)
    del plan
    flat = idx.reshape(-1)
    sort_ms = time_launches(
        torch, lambda x: torch.sort(x, stable=True), [(flat,)] * 10, flush)
    zero_ms = time_launches(torch, lambda o: o.zero_(), [(out,)] * 5, flush)
    flat64 = flat.to(torch.int64)
    library_ms = time_launches(
        torch, lambda o: o.index_add_(0, flat64, coeff * grad),
        [(out,)] * 10, flush)
    out.zero_()
    kernel.bag_grad_cuda(grad, idx, coeff, out)
    t0 = time.perf_counter()
    plain = ref.bag_grad_ref(grad, None, idx, coeff, vocab)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not bits_equal(out[uniq], plain[uniq]):
        raise SystemExit("bag_grad != plain at the full training vocab")
    del plain
    # the (B, K)-grid oracle at the same shapes, bit-equal to the tiled
    # kernel's rows, then timed as the tiled kernel is (10 launches, each
    # accumulating onto the same touched rows), beside it and index_add_
    tiled_rows = out[uniq].clone()
    out.zero_()
    kernel.bag_grad_rowgrid_cuda(grad, idx, coeff, out)
    torch.cuda.synchronize()
    if not bits_equal(out[uniq], tiled_rows):
        raise SystemExit("bag_grad_rowgrid != bag_grad at the full training "
                         "vocab")
    del tiled_rows
    rowgrid_ms = time_launches(torch, kernel.bag_grad_rowgrid_cuda, reps,
                               flush)
    tiled_again_ms = time_launches(torch, kernel.bag_grad_cuda, reps, flush)
    library_again_ms = time_launches(
        torch, lambda o: o.index_add_(0, flat64, coeff * grad),
        [(out,)] * 10, flush)
    rowgrid_again_ms = time_launches(torch, kernel.bag_grad_rowgrid_cuda,
                                     reps, flush)
    # where the oracle's time goes: its kernels' device ms a launch
    split = kernel_split(torch, kernel.bag_grad_rowgrid_cuda, reps[0])
    # bytes the function must move: g, the indices and coefficients
    # once, and each distinct touched row written once; 2 flops a
    # column per slot
    nbytes = n * d * 4 + n * 4 + n * 4 + u * d * 4
    flops = 2 * n * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    chain_ms = chain_bound_ms(depth)
    log(f"bag_grad at the training shapes: {ms:.4f} ms with its sort "
        f"({sort_ms:.4f}), {ms_grouped:.4f} ms grouped beforehand, zero fill "
        f"{zero_ms:.4f} ms, plain {plain_ms:.1f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms, chain bound "
        f"{chain_ms:.4f} ms ({depth:,} slots); bag_grad_rowgrid "
        f"{rowgrid_ms:.4f} / {rowgrid_again_ms:.4f} ms (bag_grad "
        f"{tiled_again_ms:.4f}, index_add_ {library_again_ms:.4f} between "
        f"them), bit-equal; its kernels (profiler, ms a launch): "
        f"{ {k: round(v, 4) for k, v in split.items()} }")
    rowgrid_train = {"ms": rowgrid_ms, "ms_again": rowgrid_again_ms,
                     "tiled_ms": ms, "tiled_ms_again": tiled_again_ms,
                     "bound_ms": bound_ms, "chain_bound_ms": chain_ms,
                     "library_ms": library_ms,
                     "library_ms_again": library_again_ms,
                     "kernels_ms": split, "slots": n,
                     "distinct_rows": u, "longest_row": depth,
                     "vocab": vocab,
                     "per": "launch (the training batch's scatter)"}
    return rowgrid_train, {
        "name": "bag_grad", "route": "cuda", "source": SOURCE_BAG_GRAD,
        "replaces": TPU_BAG_GRAD, "launches": None, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / FP32_FLOPS else "operations",
        "library_ms": library_ms, "chain_bound_ms": chain_ms,
        "sort_ms": sort_ms, "grouped_ms": ms_grouped,
        "zero_fill_ms": zero_ms, "zero_fill_bytes": vocab * d * 4,
        "slots": n, "distinct_rows": u, "longest_row": depth,
        "vocab": vocab, "bytes": nbytes}


def measure_bag_grad_rowgrid(torch, kernel, ref, gidx, flush,
                             worst: float) -> dict:
    """Phase 6: the (B, K)-grid scatter oracle at the pipeline gradcheck's
    shape (8 training samples x 26 fields, K = 1, into the sub-table of
    the rows they touch), held to its plain version and to bag_grad, then
    timed beside both, its bound and ``index_add_``."""
    dev = gidx.device
    flat = gidx[:8].reshape(-1)
    uniq, inv = torch.unique(flat, return_inverse=True)
    n, u, d = flat.numel(), uniq.numel(), 64
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    grad = torch.randn((n, d), generator=g, device=dev)
    idx = inv.to(torch.int32).reshape(-1, 1).contiguous()
    coeff = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    got = kernel.bag_grad_rowgrid_cuda(grad, idx, coeff,
                                       torch.zeros((u, d), device=dev))
    tiled = kernel.bag_grad_cuda(grad, idx, coeff,
                                 torch.zeros((u, d), device=dev))
    want = ref.bag_grad_rowgrid_ref(grad, None, idx, coeff, u)
    torch.cuda.synchronize()
    if not (bits_equal(got, want) and bits_equal(got, tiled)):
        raise SystemExit("bag_grad_rowgrid != plain or tiled at the "
                         "gradcheck shape")
    worst = max(worst, float((got - want).abs().max()))
    out = torch.zeros((u, d), device=dev)
    reps = [(grad, idx, coeff, out)] * 10
    ms = time_launches(torch, kernel.bag_grad_rowgrid_cuda, reps, flush)
    tiled_ms = time_launches(torch, kernel.bag_grad_cuda, reps, flush)
    plain_ms = time_once(torch, ref.bag_grad_rowgrid_ref, grad, None, idx,
                         coeff, u)
    flat64 = idx.reshape(-1).to(torch.int64)
    library_ms = time_launches(
        torch, lambda o: o.index_add_(0, flat64, coeff * grad), [(out,)] * 10,
        flush)
    nbytes = n * d * 4 + n * 4 + n * 4 + u * d * 4
    bound_ms, bound_by = _bound(nbytes, 2 * n * d)
    # its kernels' device time: the rest of a launch's ms is the host's
    split = kernel_split(torch, kernel.bag_grad_rowgrid_cuda, reps[0])
    log(f"bag_grad_rowgrid at the gradcheck shape ({n} slots, {u} rows): "
        f"{ms:.4f} ms (tiled {tiled_ms:.4f}, plain {plain_ms:.2f}, "
        f"index_add_ {library_ms:.4f}, bound {bound_ms:.6f}); bit-equal to "
        f"plain and tiled; its kernels (profiler, ms a launch): "
        f"{ {k: round(v, 4) for k, v in split.items()} }")
    return {"name": "bag_grad_rowgrid", "route": "cuda",
            "source": SOURCE_GRAD_ROWGRID, "replaces": TPU_GRAD_ROWGRID,
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "tiled_ms": tiled_ms,
            "kernels_ms": split,
            "shape": {"slots": n, "K": 1, "D": d, "distinct_rows": u},
            "bytes": nbytes,
            "per": "launch (the pipeline gradcheck's 8 x 26 slots)"}


def _payload(torch, dtype, v, d, g, dev):
    if dtype == torch.int8:
        return torch.randint(-128, 128, (v, d), generator=g, device=dev,
                             dtype=torch.int8)
    return (torch.randn((v, d), generator=g, device=dev) * 0.1).to(dtype)


def check_bag_matmul(torch, bm_ops, bm_ref) -> float:
    """Phase 2: bag_matmul against bag_matmul_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    worst, n = 0.0, 0
    # (B, K, D, H): K = 1; B and H that no 32 x 64 tile divides; the
    # full-width fused first layers of wide&deep and xDeepFM; D = 200
    # (dynamic shared memory above 48 KB)
    shapes = ((512, 1, 32, 1024), (37, 5, 10, 70), (512, 40, 32, 1024),
              (512, 39, 10, 400), (7, 3, 200, 33))
    for dtype in (torch.int8, torch.bfloat16, torch.float16, torch.float32):
        for b, k, d, h in shapes:
            v = 5000
            payload = _payload(torch, dtype, v, d, g, dev)
            scales = torch.rand(v, generator=g, device=dev) * 0.01
            idx = torch.randint(0, v, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            w = torch.rand((b, k), generator=g, device=dev)
            w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0.0
            w3 = torch.randn((k, d, h), generator=g, device=dev)
            for after in (False, True):
                got = bm_ops.bag_matmul(payload, scales, idx, w, w3,
                                        scale_after=after)
                want = bm_ref.bag_matmul_ref(payload, scales, idx, w, w3,
                                             scale_after=after)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not bits_equal(got, want):
                    raise SystemExit(
                        f"bag_matmul != plain: {dtype} B={b} K={k} D={d} "
                        f"H={h} scale_after={after} max err {err}")
                worst = max(worst, err)
                n += 1
    # B 1/31/512/513, K 1/39/40, D 1/10/32/384, H 1/63/400/1024, and two
    # dead fields with a NaN in w3 under one: that column is NaN in both
    from repro_torch.kernels import cases
    n_cases = 0
    for dtype in (torch.int8, torch.bfloat16, torch.float16, torch.float32):
        for case in cases.bag_matmul_cases(dev, dtype):
            for after in (False, True):
                got = bm_ops.bag_matmul(*case[1:], scale_after=after)
                want = bm_ref.bag_matmul_ref(*case[1:], scale_after=after)
                torch.cuda.synchronize()
                if not scales_equal(got, want):
                    raise SystemExit(
                        f"bag_matmul[{case.name}] != plain: {dtype} "
                        f"scale_after={after}")
                if case.name.startswith("dead") and not bool(
                        torch.isnan(got[:, 7]).all()):
                    raise SystemExit("bag_matmul: a NaN in w3 under dead "
                                     "slots did not reach its column")
                fin = torch.isfinite(want)
                if bool(fin.any()):
                    worst = max(worst, float((got - want)[fin].abs().max()))
                n_cases += 1
    log(f"kernel check: bag_matmul bit-equal to plain in {n} cases (4 "
        f"dtypes x 5 shapes x scale_after) and {n_cases} schedule cases "
        f"(B 1/31/512/513, K 1/39/40, D 1/10/32/384, H 1/63/400/1024; dead "
        f"fields over a NaN in w3: NaN in both); max abs err {worst})")
    return worst


def check_cin(torch, cin_ops, cin_ref) -> float:
    """Phase 2: cin against cin_layer_ref on the card (synthetic)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    worst = 0.0
    # (B, O, H, M, D): nothing divides a block; D = 128 (one sample a
    # block); the full-width first layer
    for b, o, h, m, d in ((13, 17, 9, 8, 6), (5, 3, 1, 1, 128),
                          (70, 200, 39, 39, 10)):
        w = torch.randn((o, h, m), generator=g, device=dev) / (h * m) ** 0.5
        xk = torch.randn((b, h, d), generator=g, device=dev)
        x0 = torch.randn((b, m, d), generator=g, device=dev)
        got = cin_ops.cin_layer(w, xk, x0)
        want = cin_ref.cin_layer_ref(w, xk, x0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bits_equal(got, want):
            raise SystemExit(f"cin != plain: B={b} O={o} H={h} M={m} D={d} "
                             f"max err {err}")
        worst = max(worst, err)
    # the kernel's 200 x 40 tiles and 32-deep chunks: O 17 / 200 / 201 /
    # 400, a sample's columns split across n tiles (D = 6, D = 128), K of
    # 72, 1,521 and 7,800, H = M = 1, W off alignment at K = 72, and a NaN
    # in W (its output channel NaN in both)
    from repro_torch.kernels import cases
    for case in cases.cin_cases(dev):
        got = cin_ops.cin_layer(*case[1:])
        want = cin_ref.cin_layer_ref(*case[1:])
        torch.cuda.synchronize()
        if not scales_equal(got, want):
            raise SystemExit(f"cin[{case.name}] != plain")
        nan = torch.isnan(got)
        if int(nan.sum()) != (nan[:, 5].numel() if case.name == "nan_w"
                              else 0):
            raise SystemExit(f"cin[{case.name}]: NaN outputs {int(nan.sum())}")
        worst = max(worst, float((got - want)[~nan].abs().max()))
    log(f"kernel check: cin bit-equal to plain in 3 synthetic cases and "
        f"{len(cases.CIN_CASE_NAMES)} tile cases (O 17/200/201/400, a "
        f"sample's D=6 or D=128 columns split across tiles, K 72/1521/7800, "
        f"H=M=1, W off alignment at K=72, a NaN in W: NaN in its channel "
        f"in both; max abs err {worst})")
    return worst


def check_hashed_gather(torch, hg_ops, hg_ref) -> float:
    """Phase 2: hashed_gather against hashed_gather_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    worst, n = 0.0, 0
    s = 100_003
    # (B, K, weighted): the serving lookup (K = 1, +-1 signs) at a
    # request's 20,480 ids and at a B that no block divides; weighted
    # K = 5 bags with 30% zero coefficients; B = 0
    cases = ((20_480, 1, False), (1001, 1, False), (333, 5, True),
             (0, 1, False))
    for dtype in (torch.int8, torch.float32):
        for z in (8, 4, 5):
            pool = _payload(torch, dtype, s, z, g, dev)
            scales = torch.rand(s, generator=g, device=dev) * 0.01
            for b, k, weighted in cases:
                idx = torch.randint(0, 22_216_192, (b, k), generator=g,
                                    device=dev, dtype=torch.int32)
                w = None
                if weighted:
                    w = torch.randn((b, k), generator=g, device=dev)
                    w[torch.rand((b, k), generator=g, device=dev) < 0.3] = 0
                slots, coeff = hg_ops.slot_plan(idx, w, num_chunks=4,
                                                num_hashes=2, num_slots=s)
                got = hg_ops.hashed_gather(pool, scales, slots, coeff,
                                           num_chunks=4)
                by_ids = hg_ops.hashed_gather_ids(pool, scales, idx, w,
                                                  num_chunks=4, num_hashes=2)
                want = hg_ref.hashed_gather_ref(pool, scales, slots, coeff,
                                                num_chunks=4)
                torch.cuda.synchronize()
                if not (bits_equal(got, want) and bits_equal(by_ids, want)):
                    err = float((got - want).abs().max())
                    raise SystemExit(
                        f"hashed_gather (plan or ids) != plain: {dtype} Z={z} "
                        f"B={b} K={k} weighted={weighted} max err {err}")
                if got.numel():
                    worst = max(worst, float((got - want).abs().max()))
                n += 1
    from repro_torch.kernels import cases
    for c in cases.hashed_cases(dev):
        kw = dict(num_chunks=c.num_chunks, num_hashes=c.num_hashes,
                  seed=c.seed)
        slots, coeff = hg_ops.slot_plan(c.ids, c.weights,
                                        num_slots=c.pool.shape[0], **kw)
        got = hg_ops.hashed_gather(c.pool, c.scales, slots, coeff,
                                   num_chunks=c.num_chunks)
        by_ids = hg_ops.hashed_gather_ids(c.pool, c.scales, c.ids,
                                          c.weights, **kw)
        want = hg_ref.hashed_gather_ref(c.pool, c.scales, slots, coeff,
                                        num_chunks=c.num_chunks)
        torch.cuda.synchronize()
        if not (bits_equal(got, want) and bits_equal(by_ids, want)):
            raise SystemExit(f"hashed_gather (plan or ids) != plain on case "
                             f"{c.name}")
        worst = max(worst, float((got - want).abs().max()))
        n += 1
    log(f"kernel check: hashed_gather's plan and ids entries bit-equal to "
        f"plain in {n} cases (int8/fp32 pools x Z 8/4/5 x K=1 signs, K=5 "
        f"weighted with 30% zeros, B=0, and the {len(cases.HASH_CASE_NAMES)} "
        f"hashed_cases; max abs err {worst})")
    return worst


def check_rowwise_quant(torch, rq_ops, rq_ref) -> float:
    """Phase 2: quantize_rowwise against quantize_rowwise_ref on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    n, worst = 0, 0.0
    v = 1001                      # no 8-row block divides it
    for d in (64, 32, 10, 8):
        x = torch.randn((v, d), generator=g, device=dev) * (
            torch.rand((v, 1), generator=g, device=dev) * 10 + 1e-3)
        x[1] = 0.0                # the 1e-12 floor
        half = (torch.arange(d, device=dev) % 9 - 4).float() + 0.5
        x[2] = half * 0.25        # exact .5 multiples of the scale 0.25
        x[2, 0] = 127 * 0.25
        x[3, d - 1] = float("nan")     # NaN scale, codes 0
        x[4, 0] = float("inf")         # inf scale, codes 0
        noise = torch.rand((v, d), generator=g, device=dev)
        for mode in ("narrow", "full"):
            for nz in (None, noise):
                for recip in (False, True):
                    q, sc = rq_ops.quantize_rowwise(x, nz, mode,
                                                    reciprocal=recip)
                    wq, ws = rq_ref.quantize_rowwise_ref(x, nz, mode,
                                                         reciprocal=recip)
                    torch.cuda.synchronize()
                    if not (torch.equal(q, wq) and scales_equal(sc, ws)):
                        raise SystemExit(
                            f"quantize_rowwise != plain: D={d} {mode} "
                            f"stochastic={nz is not None} reciprocal={recip}")
                    fin = torch.isfinite(sc[:, 0])
                    worst = max(worst, _quant_err(q[fin], sc[fin], wq[fin],
                                                  ws[fin]))
                    n += 1
    # the vector, scalar and wide-row paths: D 64/32/10/8/3/68/133 with
    # zero, .5-multiple, NaN and inf rows beside finite rows of the same
    # warp step, and x or noise off 16-byte alignment
    from repro_torch.kernels import cases
    from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
    n_cases = 0
    for case in cases.quant_cases(dev):
        for mode in ("narrow", "full"):
            for nz in (None, case.noise):
                for recip in (False, True):
                    q, sc = rq_kernel.quantize_rowwise_cuda(
                        case.x, nz, mode, reciprocal=recip)
                    wq, ws = rq_ref.quantize_rowwise_ref(case.x, nz, mode,
                                                         reciprocal=recip)
                    torch.cuda.synchronize()
                    if not (torch.equal(q, wq) and scales_equal(sc, ws)):
                        raise SystemExit(
                            f"quantize_rowwise[{case.name}] != plain: {mode} "
                            f"stochastic={nz is not None} reciprocal={recip}")
                    fin = torch.isfinite(sc[:, 0])
                    worst = max(worst, _quant_err(q[fin], sc[fin], wq[fin],
                                                  ws[fin]))
                    n_cases += 1
    log(f"kernel check: quantize_rowwise bit-equal to plain in {n} cases "
        f"(D 64/32/10/8 x narrow/full x nearest/stochastic x divide/"
        f"reciprocal, V=1001 with a zero row, a row of .5 multiples and "
        f"NaN and inf rows) and {n_cases} path cases (D 64/32/10/8/3/68/133, "
        f"NaN and inf rows beside finite ones, x or noise off 16-byte "
        f"alignment); max abs err {worst})")
    return worst


def _quant_err(q, sc, wq, ws) -> float:
    """Largest absolute difference of the codes or the scales."""
    return max(float((q.int() - wq.int()).abs().max()),
               float((sc - ws).abs().max())) if q.numel() else 0.0


def measure_quantize(torch, served, rq_kernel, rq_ref, flush,
                     worst: float) -> dict:
    """Phase 4: quantize_rowwise on the first 4M-row chunk of the dlrm-rm2
    build: the int8 rows of that chunk, snapped as the build snaps them,
    are the kernel's input there and its output is the pack's first int8
    rows."""
    from repro_torch.core import rowwise_quant as rq
    from repro_torch.launch.serve import CHUNK_ROWS, SEED
    from repro_torch.models.embedding import table_rows

    packed, spec = served.packed, served.model.spec
    dev = packed.indirect.device
    tier = packed.indirect[:CHUNK_ROWS] >> 28
    sel = torch.nonzero(tier == 0).reshape(-1)
    x = rq.fake_quant_rowwise(table_rows(spec, SEED, dev)(0, CHUNK_ROWS)[sel],
                              8).contiguous()
    v, d = x.shape
    q, sc = rq_kernel.quantize_rowwise_cuda(x)
    wq, ws = rq_ref.quantize_rowwise_ref(x)
    torch.cuda.synchronize()
    if not (torch.equal(q, wq) and bits_equal(sc, ws)):
        raise SystemExit("quantize_rowwise != plain on a build chunk")
    worst = max(worst, _quant_err(q, sc, wq, ws))
    if not (torch.equal(q, packed.payload8[:v])
            and bits_equal(sc[:, 0], packed.scale8[:v])):
        raise SystemExit("quantize_rowwise on a build chunk != the pack's "
                         "int8 rows")
    t = _time_quantize(torch, x, "narrow", rq_kernel, rq_ref, flush)
    log(f"quantize_rowwise at a build chunk's int8 rows (V={v:,}, D={d}): "
        f"{t['ms']:.4f} ms, {t['gb_per_s']:.0f} GB/s (bound "
        f"{t['bound_ms']:.4f}, {t['bound_ms'] / t['ms']:.1%} of it; plain "
        f"{t['plain_ms']:.4f}); bit-equal to plain and to the pack's first "
        f"{v:,} int8 rows")
    return {"name": "quantize_rowwise", "route": "cuda",
            "source": SOURCE_QUANT, "replaces": TPU_QUANT, "launches": None,
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": {"V": v, "D": d},
            "bytes": t["bytes"], "gb_per_s": t["gb_per_s"],
            "per": "launch (the int8 rows of one 4,194,304-row build chunk)"}


def _time_quantize(torch, x, mode: str, rq_kernel, rq_ref, flush) -> dict:
    """The kernel's and the plain version's ms on ``x``, and the bound."""
    v, d = x.shape
    ms = time_launches(torch, lambda a: rq_kernel.quantize_rowwise_cuda(
        a, None, mode), [(x,)] * 10, flush)
    plain_ms = time_launches(torch, lambda a: rq_ref.quantize_rowwise_ref(
        a, None, mode), [(x,)] * 3, flush)
    # 4 bytes read and 1 written an element, 4 bytes of scale a row;
    # |x|, max, divide, round, clip: 5 operations an element
    nbytes = v * d * 5 + v * 4
    bound_ms, bound_by = _bound(nbytes, 5 * v * d)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes,
            "gb_per_s": nbytes / ms / 1e6}


def measure_quantize_tier(torch, served, rq_kernel, rq_ref, flush) -> dict:
    """Phase 9: quantize_rowwise on the int8 rows of the first 4M-row chunk
    of the xdeepfm pack after its online run (D = 10: the kernel's scalar
    path, which each of the pack's build chunks and re-tiers runs), bit
    for bit against the plain version and the pack's rows, then timed."""
    from repro_torch.core.packed_store import _IDX_MASK, _TIER_SHIFT
    from repro_torch.launch.serve import CHUNK_ROWS

    packed, backend = served.server.packed, served.server.backend
    mode = backend.cfg.mode
    with torch.inference_mode():
        rows = torch.nonzero((packed.indirect[:CHUNK_ROWS] >> _TIER_SHIFT)
                             == 0).reshape(-1)
        loc = (packed.indirect[rows] & _IDX_MASK).to(torch.int64)
        x = backend.store.table[rows].to(torch.float32).contiguous()
        v, d = x.shape
        q, sc = rq_kernel.quantize_rowwise_cuda(x, None, mode)
        wq, ws = rq_ref.quantize_rowwise_ref(x, None, mode)
        torch.cuda.synchronize()
        if not (torch.equal(q, wq) and bits_equal(sc, ws)
                and torch.equal(q, packed.payload8[loc])
                and bits_equal(sc[:, 0], packed.scale8[loc])):
            raise SystemExit("quantize_rowwise on the xdeepfm chunk != plain "
                             "or the pack's rows")
        t = _time_quantize(torch, x, mode, rq_kernel, rq_ref, flush)
    log(f"quantize_rowwise at the xdeepfm pack's first chunk's int8 rows "
        f"(V={v:,}, D={d}, {mode}): {t['ms']:.4f} ms, {t['gb_per_s']:.0f} "
        f"GB/s (bound {t['bound_ms']:.4f}, {t['bound_ms'] / t['ms']:.1%} of "
        f"it; plain {t['plain_ms']:.4f}); bit-equal to plain and to the "
        f"pack's rows")
    return {"shape": {"V": v, "D": d}, "mode": mode, **t,
            "per": "launch (the int8 rows of the first 4,194,304-row chunk "
                   "of the xdeepfm pack)"}


def serve_hashed(torch, serve, kernels_mod, bits: str) -> tuple:
    """Phase 10: the hashed online serve of wide-deep at full width, with
    the counts around it and the plain gather as each request's check."""
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.ops import slot_plan
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.loop import request_batch
    from repro_torch.store.hashed import CG_ITERS

    batch_size = RECSYS_SHAPES["serve_p99"]["batch"]
    argv = ["--arch", "wide-deep", "--online", "--store-backend", "hashed",
            "--hash-bits", bits, "--model", "full", "--batch",
            str(batch_size), "--requests", str(REQUESTS), "--retier-every",
            "2", "--cache-rows", "256", "--drift", "4.0"]
    checked = {"requests": 0, "logit_diff": 0.0}

    def make_audit(server, model, params):
        hs, hcfg = server.backend.hs, server.backend.hcfg

        def audit(r, idx):
            with torch.inference_mode():
                b = request_batch(idx, r, 0, server.device)
                gidx = globalize(b["indices"], model.spec)
                slots, coeff = slot_plan(
                    gidx.reshape(-1, 1), None, num_chunks=hcfg.num_chunks,
                    num_hashes=hcfg.num_hashes, num_slots=hcfg.num_slots,
                    seed=hcfg.seed)
                plain = hg_ref.hashed_gather_ref(
                    hs.pool, hs.pool_scale, slots, coeff,
                    num_chunks=hcfg.num_chunks).reshape(*gidx.shape, -1)
                ref = model.head(params, plain, b)

            def after(out, emb):
                if emb is None or not bits_equal(emb, plain):
                    raise SystemExit(f"hashed {bits}b request {r}: served "
                                     "embeddings != the plain gather")
                if out.shape != (idx.shape[0],) or not bool(
                        torch.isfinite(out).all()):
                    raise SystemExit(f"hashed {bits}b request {r}: bad "
                                     f"logits {tuple(out.shape)}")
                diff = float((out - ref).abs().max())
                if diff > 1e-4 * max(1.0, float(ref.abs().max())):
                    raise SystemExit(f"hashed {bits}b request {r}: logits "
                                     f"off the plain head by {diff}")
                checked["requests"] += 1
                checked["logit_diff"] = max(checked["logit_diff"], diff)
            return after
        return audit

    kernels_mod.reset_launches()
    served = serve.run(serve.parse_args(argv), make_audit=make_audit)
    launches = kernels_mod.launch_counts()
    by_entry = dict(hg_kernel.launches)
    rec = served.record
    in_loop, build = rec["kernel_launches"], rec["build_kernel_launches"]
    # every gather (the fit's forward, the cache builds, the requests)
    # takes the ids entry; the plan entry runs on no path
    if (by_entry["int8"] or by_entry["float32"]
            or by_entry["ids_int8"] + by_entry["ids_float32"]
            != launches["hashed_gather"]):
        raise SystemExit(f"hashed {bits}b: hashed_gather launches by entry "
                         f"{by_entry}, want the ids entry only")
    per_request = 1                   # one gather of the request's ids
    # the start-up: the fit (fwd 1 + CG_ITERS times, adj 2 + CG_ITERS
    # times), the 8-bit pool's quantize_pool, the first cache build
    want_build = {"hashed_gather": CG_ITERS + 1 + 1,
                  "bag_grad": CG_ITERS + 2,
                  "quantize_rowwise": 1 if bits == "8" else 0}
    want_loop = {"hashed_gather": per_request * REQUESTS + rec["retiers"],
                 "bag_grad": 0, "quantize_rowwise": 0}   # + cache rebuilds
    if (any(build[k] != n for k, n in want_build.items())
            or any(in_loop[k] != n for k, n in want_loop.items())
            or any(launches[k] != build[k] + in_loop[k] for k in launches)
            or checked["requests"] != REQUESTS):
        raise SystemExit(f"hashed {bits}b path launches {launches}, record "
                         f"{in_loop} / {build}, want {want_loop} / "
                         f"{want_build}; {checked['requests']} requests "
                         "checked")
    if (rec["device"] != "cuda" or rec["store_backend"] != "hashed"
            or rec["hash_bits"] != int(bits) or rec["rows_moved"] != 0
            or rec["retiers"] != REQUESTS // 2):
        raise SystemExit(f"unexpected hashed record {rec}")
    rec["check_vs_plain"] = {
        "requests_bit_equal": checked["requests"],
        "max_logit_diff_vs_plain_head": checked["logit_diff"]}
    log(f"hashed {bits}b: pool {rec['pool_slots']:,} x 8, "
        f"{rec['packed_mib']:.3f} MiB ({rec['hash_ratio']}x), fit "
        f"{rec['fit_s']:.2f} s; {REQUESTS} requests bit-equal to the plain "
        f"gather, logits within {checked['logit_diff']:.3g} of the plain "
        f"head; launches {launches} (start-up {build}; by entry "
        f"{by_entry}); p50 "
        f"{rec['p50_us']:.0f} us p99 {rec['p99_us']:.0f} us")
    return served, launches, by_entry


def check_hashed_build(torch, served, table, bits: str, counters,
                       flush) -> dict:
    """Phase 10: the hashed start-up's kernels against their plain
    versions at the shapes the start-up gave them.  The fit is rerun on
    the same table (it is deterministic: bag_grad has no float atomics)
    and must give the served pool; then its fwd over every row (the ids
    entry it runs and the plan entry), its first adj and the 8-bit pool's
    quantize are each held bit for bit, and the fit-shaped fwd (both
    entries) and bag_grad are timed.  Returns (the bag_grad timing, the
    fwd timings by entry)."""
    import torch.nn.functional as F

    from repro_torch.kernels.dequant_bag.ops import bag_grad, plan_slots
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.ops import (hashed_gather,
                                                       hashed_gather_ids)
    from repro_torch.kernels.rowwise_quant import ref as rq_ref
    from repro_torch.store import hashed as H

    backend = served.server.backend
    hs, hcfg = backend.hs, backend.hcfg
    v = table.shape[0]
    c, z, nh, s = (hcfg.num_chunks, hcfg.chunk_dim, hcfg.num_hashes,
                   hcfg.num_slots)
    with Uncounted(counters), torch.inference_mode():
        fit = H.fit_pool_from_table(table, hcfg)
        if bits == "8":
            q = H.quantize_pool(fit)
            wq, ws = rq_ref.quantize_rowwise_ref(fit.pool)
            torch.cuda.synchronize()
            if not (torch.equal(q.pool, wq)
                    and bits_equal(q.pool_scale, ws[:, 0])):
                raise SystemExit(f"hashed 8b: quantize_pool != plain at "
                                 f"{tuple(fit.pool.shape)}")
            if not (torch.equal(q.pool, hs.pool)
                    and bits_equal(q.pool_scale, hs.pool_scale)):
                raise SystemExit("hashed 8b: a rerun fit + quantize_pool != "
                                 "the served pool")
            del q, wq, ws
        elif not bits_equal(fit.pool, hs.pool):
            raise SystemExit("hashed 32b: a rerun fit != the served pool")
        # the fit's slot plan, as fit_pool_from_table builds it
        slots, signs = hg_ref.hash_slots(
            torch.arange(v, dtype=torch.int32, device=table.device),
            num_chunks=c, num_hashes=nh, num_slots=s, seed=hcfg.seed)
        plan, coeff = slots.reshape(v, c * nh), signs.reshape(v, c * nh)
        del slots, signs
        # fwd over every row, unit scales: the ids entry (what the fit
        # runs) and the plan entry, one launch each
        ids = torch.arange(v, dtype=torch.int32,
                           device=table.device).reshape(v, 1)
        kw = dict(num_chunks=c, num_hashes=nh, seed=hcfg.seed)
        by_ids = hashed_gather_ids(fit.pool, None, ids, **kw)
        got = hashed_gather(fit.pool, None, plan, coeff, num_chunks=c)
        step, fwd_plain_ms = 1 << 22, 0.0
        for r0 in range(0, v, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = hg_ref.hashed_gather_ref(fit.pool, None,
                                            plan[r0:r0 + step],
                                            coeff[r0:r0 + step],
                                            num_chunks=c)
            torch.cuda.synchronize()
            fwd_plain_ms += (time.perf_counter() - t0) * 1e3
            if not (bits_equal(got[r0:r0 + step], want)
                    and bits_equal(by_ids[r0:r0 + step], want)):
                raise SystemExit(f"hashed {bits}b: the fit's fwd (plan or "
                                 f"ids entry) != plain at rows {r0}+")
        del got, by_ids, want
        ids_ms = time_launches(
            torch, lambda: hashed_gather_ids(fit.pool, None, ids, **kw),
            [()] * 3, flush)
        plan_ms = time_launches(
            torch, lambda: hashed_gather(fit.pool, None, plan, coeff,
                                         num_chunks=c), [()] * 3, flush)

        def fwd_library():       # (V*C, NH) bags over the pool
            return F.embedding_bag(plan.reshape(-1, nh), fit.pool,
                                   mode="sum", per_sample_weights=coeff
                                   .reshape(-1, nh)).reshape(v, c * z)
        fwd_library_diff = float((fwd_library() - hashed_gather_ids(
            fit.pool, None, ids, **kw)).abs().max())
        fwd_library_ms = time_launches(torch, fwd_library, [()] * 3, flush)
        del ids
        # the first adj(x): bag_grad on the (V*C, NH) plan
        g = table.reshape(v * c, z)
        bags, bag_signs = plan.reshape(v * c, nh), coeff.reshape(v * c, nh)
        got = bag_grad(g, None, bags, bag_signs, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = hg_ref.hashed_grad_ref(table, None, plan, coeff, s,
                                      num_chunks=c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not bits_equal(got, want):
            raise SystemExit(f"hashed {bits}b: the fit's adj (bag_grad over "
                             f"{v * c:,} x {nh} bags) != plain, max err "
                             f"{float((got - want).abs().max())}")
        del got, want
        # the fit groups its slots once and each adj reuses the grouping
        plan = plan_slots(bags)
        ms = time_launches(torch, lambda *a: bag_grad(*a, plan=plan),
                           [(g, None, bags, bag_signs, s)] * 3, flush)
        ms_sorted = time_launches(torch, bag_grad,
                                  [(g, None, bags, bag_signs, s)] * 3, flush)
        sort_ms = time_launches(torch, plan_slots, [(bags,)] * 3, flush)
        longest = int(torch.bincount(plan.rows.to(torch.int64)).max())
        del plan
        flat = bags.reshape(-1).to(torch.int64)
        out = torch.zeros((s, z), device=table.device)

        def library(o):
            return o.index_add_(0, flat, (bag_signs[:, :, None]
                                          * g[:, None, :]).reshape(-1, z))
        library_ms = time_launches(torch, library, [(out,)] * 3, flush)
        del flat, out
    # g once, each slot's index and coefficient once, the (S, Z) output;
    # 2 flops a column per slot
    n = v * c * nh
    nbytes = v * c * z * 4 + n * 8 + s * z * 4
    bound_ms, bound_by = _bound(nbytes, 2 * n * z)
    log(f"hashed {bits}b start-up at its shapes: fit rerun = served pool; "
        f"fwd over {v:,} rows, adj over {v * c:,} x {nh} bags"
        f"{', quantize_pool' if bits == '8' else ''} bit-equal to plain; "
        f"fit-shaped bag_grad {ms:.4f} ms with the fit's grouping, "
        f"{ms_sorted:.4f} ms with its own sort ({sort_ms:.4f}) (bound "
        f"{bound_ms:.4f}, chain bound {chain_bound_ms(longest):.4f}, plain "
        f"{plain_ms:.1f}, index_add_ {library_ms:.4f})")
    # the fwd: the ids (4 bytes a row) or the plan (8 bytes a slot), the
    # pool once, the (V, C*Z) output; 3 flops a column per slot
    out_bytes, pool_bytes = v * c * z * 4, s * z * 4
    fwd = {}
    for entry, fwd_ms, in_bytes in (("ids", ids_ms, v * 4),
                                    ("plan", plan_ms, n * 8)):
        fb = in_bytes + pool_bytes + out_bytes
        f_bound, f_by = _bound(fb, 2 * n * z)
        fwd[entry] = {"path": f"online_hashed_{bits}b", "ms": fwd_ms,
                      "plain_ms": fwd_plain_ms, "bound_ms": f_bound,
                      "bound_by": f_by, "library_ms": fwd_library_ms,
                      "library_max_abs_diff": fwd_library_diff, "bytes": fb,
                      "shape": {"B": v, "C": c, "T": nh, "Z": z, "S": s},
                      "per": "launch (the fit's forward over every row)"}
    log(f"hashed {bits}b fit-shaped fwd over {v:,} rows: ids entry "
        f"{ids_ms:.4f} ms ({fwd['ids']['bound_ms'] / ids_ms:.1%} of its "
        f"{fwd['ids']['bound_ms']:.4f} ms bound), plan entry {plan_ms:.4f} "
        f"ms ({fwd['plan']['bound_ms'] / plan_ms:.1%} of "
        f"{fwd['plan']['bound_ms']:.4f}); plain {fwd_plain_ms:.1f} ms")
    return {"path": f"online_hashed_{bits}b", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_bound_ms": chain_bound_ms(longest),
            "library_ms": library_ms, "bytes": nbytes,
            "sorted_ms": ms_sorted, "sort_ms": sort_ms,
            "longest_row": longest,
            "shape": {"bags": v * c, "K": nh, "D": z, "vocab": s},
            "per": "launch (the fit's adj: zero fill and kernel, its slots "
                   "grouped once a fit; sorted_ms sorts them anew)"}, fwd


def measure_hashed_gather(torch, served, by_entry: dict, flush,
                          worst: float) -> list[dict]:
    """Phase 10: hashed_gather's plan and ids entries at the served
    shapes: 16 requests' ids (20,480 a request, C 4, T 2) on the served
    pool; one entry each."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.ops import (hashed_gather_ids_ref,
                                                       slot_plan)
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.loop import drifting_zipf_batch
    from repro_torch.store.hashed import pool_f32

    backend, spec = served.server.backend, served.model.spec
    hs, hcfg = backend.hs, backend.hcfg
    b = served.record["batch"]
    c, z = hcfg.num_chunks, hcfg.chunk_dim
    kw = dict(num_chunks=c, num_hashes=hcfg.num_hashes, seed=hcfg.seed)
    cards = np.asarray(spec.cardinalities, np.int64)
    args, ids_args, live, rows = [], [], 0, 0
    n = 16
    for r in range(n):
        idx = torch.from_numpy(drifting_zipf_batch(
            cards, b, 1000 + r, n)).to(backend.device)
        gidx = globalize(idx, spec).reshape(-1, 1)
        slots, coeff = slot_plan(gidx, None, num_slots=hcfg.num_slots, **kw)
        args.append((hs.pool, hs.pool_scale, slots, coeff))
        ids_args.append((hs.pool, hs.pool_scale, gidx, None))
        live += int((coeff != 0).sum())
        rows += int(torch.unique(slots[coeff != 0]).numel())
    for a, ia in zip(args[:4], ids_args[:4]):
        got = hg_kernel.hashed_gather_cuda(*a, num_chunks=c)
        by_ids = hg_kernel.hashed_gather_ids_cuda(*ia, **kw)
        want = hg_ref.hashed_gather_ref(*a, num_chunks=c)
        torch.cuda.synchronize()
        if not (bits_equal(got, want) and bits_equal(by_ids, want)):
            raise SystemExit("hashed_gather (plan or ids) != plain at the "
                             "served shapes")
        worst = max(worst, float((got - want).abs().max()))
    nb, t = args[0][2].shape[0], args[0][2].shape[1] // c
    # the slot plan (4 + 4 bytes a slot) or the ids (8 bytes each), each
    # distinct live pool row and its scale once, the output; 3 flops an
    # element of a live slot
    slots_n, rows_n = live / n, rows / n
    common = rows_n * (z * hs.pool.element_size() + 4) + nb * c * z * 4
    plan_bytes, ids_bytes = nb * c * t * 8 + common, nb * 8 + common

    def kernel_fn(p, s, sl, cf):
        return hg_kernel.hashed_gather_cuda(p, s, sl, cf, num_chunks=c)

    def ids_fn(p, s, i, w):
        return hg_kernel.hashed_gather_ids_cuda(p, s, i, w, **kw)

    def plain_fn(p, s, sl, cf):
        return hg_ref.hashed_gather_ref(p, s, sl, cf, num_chunks=c)

    def ids_plain_fn(p, s, i, w):
        return hashed_gather_ids_ref(p, s, i, w, **kw)

    ms = time_launches(torch, kernel_fn, args, flush)
    ids_ms = time_launches(torch, ids_fn, ids_args, flush)
    plain_ms = time_launches(torch, plain_fn, args[:4], flush)
    ids_plain_ms = time_launches(torch, ids_plain_fn, ids_args[:4], flush)
    dq = pool_f32(hs)

    def library(sl, cf):
        return F.embedding_bag(sl.reshape(-1, t), dq, mode="sum",
                               per_sample_weights=cf.reshape(-1, t)
                               ).reshape(nb, c * z)
    lib_args = [(a[2], a[3]) for a in args]
    lib_diff = float((library(*lib_args[0]) - kernel_fn(*args[0])).abs().max())
    library_ms = time_launches(torch, library, lib_args, flush)
    name = str(hs.pool.dtype).removeprefix("torch.")
    out = []
    for entry, counter, t_ms, p_ms, nbytes in (
            ("hashed_gather", name, ms, plain_ms, plan_bytes),
            ("hashed_gather_ids", "ids_" + name, ids_ms, ids_plain_ms,
             ids_bytes)):
        bound_ms, bound_by = _bound(nbytes, 3 * z * slots_n)
        out.append({
            "name": f"{entry}[{name}]", "route": "cuda",
            "source": SOURCE_HASHED, "replaces": TPU_HASHED,
            "launches": by_entry[counter], "counter": counter,
            "max_abs_err": worst, "ms": t_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_max_abs_diff": lib_diff,
            "shape": {"B": nb, "C": c, "T": t, "Z": z, "S": hcfg.num_slots},
            "live_slots": slots_n, "distinct_pool_rows": rows_n,
            "bytes": nbytes, "per": "launch (one request's lookup)"})
    log(f"hashed_gather[{name}] at B={nb} C={c} T={t} Z={z}: plan entry "
        f"{ms:.4f} ms (bound {out[0]['bound_ms']:.5f}), ids entry "
        f"{ids_ms:.4f} ms (bound {out[1]['bound_ms']:.5f}); embedding_bag "
        f"{library_ms:.4f}, plain {plain_ms:.3f} / {ids_plain_ms:.3f}; "
        f"{rows_n:,.0f} distinct pool rows a request")
    return out


class Uncounted:
    """Launches inside the block are taken back out of the counters: the
    card check's unfused reference head is not the main path."""

    def __init__(self, counters):
        self.counters = counters

    def __enter__(self):
        self.saved = [dict(c) for c in self.counters]

    def __exit__(self, *exc):
        for c, saved in zip(self.counters, self.saved):
            c.update(saved)


def serve_online(torch, serve, kernels, counters, arch: str,
                 metrics_out: str | None = None,
                 logits_before: list | None = None,
                 shadow_rows: int | None = None,
                 requests: int = REQUESTS,
                 autotune_cache: str | None = None) -> tuple:
    """Phase 8: the online fused serve of one arch at full width, with the
    counts around it and the unfused head as each request's check.
    Returns (served, launches, each request's fused logits on the host).
    Phase 13 runs it again with ``--metrics-out metrics_out``; each
    request's logits must then equal ``logits_before`` bit for bit.
    Phase 14 runs it with ``--retier-async --shadow-rows shadow_rows
    --verify-swap``: every swap verified, at least two of them on request
    ticks, and each shadow chunk and verify pack counted; it serves
    ``requests`` requests.  Phase 20(c) runs it with ``--autotune-cache
    autotune_cache``; its logits must equal ``logits_before`` (phase 8's,
    no cache) bit for bit."""
    from repro_torch import configs
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.core import packed_store as ps
    from repro_torch.core.qat_store import CHUNK_ROWS
    from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.loop import request_batch

    batch_size = RECSYS_SHAPES["serve_p99"]["batch"]
    argv = ["--arch", arch, "--online", "--fuse-matmul", "--model", "full",
            "--batch", str(batch_size), "--requests", str(requests),
            "--retier-every", "2", "--cache-rows", "256", "--drift", "4.0"]
    if metrics_out is not None:
        argv += ["--metrics-out", metrics_out, "--metrics-every",
                 str(METRICS_EVERY)]
    if shadow_rows is not None:
        argv += ["--retier-async", "--shadow-rows", str(shadow_rows),
                 "--verify-swap"]
    if autotune_cache is not None:
        argv += ["--autotune-cache", autotune_cache]
    worst = {"abs": 0.0, "rel": 0.0}
    logits = []
    # the audit launches no quantize_rowwise, and a shadow's staging thread
    # may launch it while the audit runs: its counter is left alone
    audited = [c for c in counters if c is not rq_kernel.launches]

    def make_audit(server, model, params):
        dev = server.device

        def audit(r, idx):
            with Uncounted(audited), torch.inference_mode():
                b = request_batch(idx, r, 0, dev)
                gidx = globalize(b["indices"], model.spec)
                ref = model.head(params, ps.lookup(server.packed, gidx), b)

            def after(out, emb):
                if out.shape != (idx.shape[0],) or not bool(
                        torch.isfinite(out).all()):
                    raise SystemExit(f"{arch} request {r}: bad logits "
                                     f"{tuple(out.shape)}")
                diff = (out - ref).abs()
                lim = 1e-4 * ref.abs().clamp_min(1.0)
                if not bool((diff <= lim).all()):
                    raise SystemExit(f"{arch} request {r}: fused logits off "
                                     f"the unfused head by "
                                     f"{float(diff.max())}")
                worst["abs"] = max(worst["abs"], float(diff.max()))
                worst["rel"] = max(worst["rel"], float((diff / lim).max()))
                logits.append(out.cpu())
            return after
        return audit

    kernels.reset_launches()
    served = serve.run(serve.parse_args(argv), make_audit=make_audit)
    launches = kernels.launch_counts()
    rec, stats = served.record, served.server.stats
    # the full model's config, as ``--model full`` serves it
    cin_layers = len(getattr(configs.get(arch).cfg, "cin_layers", ()))
    # the record counts the request loop; the global counts add the
    # server's start (its first cache build: one dequant_bag per tier)
    in_loop = rec["kernel_launches"]
    if (launches["bag_matmul"] != 3 * requests
            or in_loop["bag_matmul"] != 3 * requests
            or launches["cin"] != cin_layers * requests
            or in_loop["cin"] != cin_layers * requests
            or (arch == "xdeepfm" and in_loop["dequant_bag"] <= 0)):
        raise SystemExit(f"{arch} online path launches {launches}, record "
                         f"{rec['kernel_launches']}")
    if rec["device"] != "cuda" or rec["requests"] != requests:
        raise SystemExit(f"unexpected online record {rec}")
    # one tiered launch a packed lookup: each cache build (the server's
    # first and one a re-tier or swap, the final drain's included) and,
    # on xdeepfm, each request's embeddings
    dq = counters[0]
    lookups = (requests if arch == "xdeepfm" else 0) + 1 + stats.retiers
    if dq["tiered"] != lookups or any(
            n for t, n in dq.items() if t != "tiered"):
        raise SystemExit(f"{arch}: dequant_bag launches {dq}, want "
                         f"{lookups} tiered and no single-tier launch")
    if (launches["quantize_rowwise"] <= 0
            or rec["build_kernel_launches"]["quantize_rowwise"] <= 0
            or in_loop["quantize_rowwise"] <= 0):
        raise SystemExit(f"{arch}: the pack or its re-tiers did not quantize "
                         f"through the kernel: {launches}, record "
                         f"{rec['build_kernel_launches']}, {in_loop}")
    if shadow_rows is None:
        check_packed_as_before(rec, arch)
    else:
        # one launch a shadow chunk, and one a 4M-row block of each swap's
        # verify pack (the int8 tier holds rows in every block after the
        # first fold's decay); nothing else quantizes after the start-up
        blocks = -(-served.server.backend.vocab // CHUNK_ROWS)
        want = (rec["build_kernel_launches"]["quantize_rowwise"]
                + stats.shadow_chunks + stats.swaps * blocks)
        if (launches["quantize_rowwise"] != want or not rec["retier_async"]
                or rec["swaps"] < 2 or served.server.shadow is not None):
            raise SystemExit(
                f"{arch} shadow: quantize_rowwise {launches} against "
                f"{want}, record swaps {rec['swaps']} (want >= 2 on request "
                f"ticks), final {stats}")
    rec["int8_rows_checked"] = check_int8_tier(torch, served.server, arch)
    rec["check_fused_vs_unfused"] = {
        "max_abs_diff": worst["abs"], "max_diff_over_limit": worst["rel"]}
    if logits_before is not None and (
            len(logits) != requests or len(logits_before) != requests
            or not all(bits_equal(a, b) for a, b in zip(logits,
                                                         logits_before))):
        raise SystemExit(f"{arch}: the fused logits of this run ({argv}) "
                         "differ from phase 8's")
    log(f"online {arch}: {requests} requests, fused logits within "
        f"{worst['abs']:.3g} of the unfused head ({worst['rel']:.3g} of "
        f"the limit), launches {launches}, p50 {rec['p50_us']:.0f} us, "
        f"{rec['retiers']} re-tiers moved {rec['rows_moved']:,} rows"
        + (f"; shadow {stats.shadow_builds} builds, {stats.shadow_chunks} "
           f"chunks, {stats.swaps} swaps ({rec['swaps']} on request ticks), "
           f"each verified" if shadow_rows is not None else ""))
    return served, launches, logits


def check_int8_tier(torch, server, arch: str) -> int:
    """Phase 8: the pack's int8 tier after the run (the build's and every
    re-tier's quantize_rowwise output) against the plain quantizer on the
    table rows it holds, bit for bit.  Returns the rows checked."""
    from repro_torch.core.packed_store import _IDX_MASK, _TIER_SHIFT
    from repro_torch.kernels.rowwise_quant import ref as rq_ref

    packed, backend = server.packed, server.backend
    with torch.inference_mode():
        rows = torch.nonzero((packed.indirect >> _TIER_SHIFT) == 0
                             ).reshape(-1)
        loc = (packed.indirect[rows] & _IDX_MASK).to(torch.int64)
        wq, ws = rq_ref.quantize_rowwise_ref(
            backend.store.table[rows].to(torch.float32),
            mode=backend.cfg.mode)
        torch.cuda.synchronize()
        n = rows.numel()
        if (packed.payload8.shape[0] != max(n, 1)
                or not torch.equal(packed.payload8[loc], wq)
                or not bits_equal(packed.scale8[loc], ws[:, 0])):
            raise SystemExit(f"{arch}: the pack's int8 rows != the plain "
                             f"quantizer on the {n:,} table rows they hold")
    log(f"online {arch}: the pack's {n:,} int8 rows x {wq.shape[1]} and "
        f"scales bit-equal to the plain quantizer on their table rows")
    return n


FMA_CYCLES = 4          # latency of a dependent fp32 FMA on Hopper
SM_CLOCK_HZ = 1.98e9    # the card's top SM clock; main() reads the card's


def chain_bound_ms(longest_run: int) -> float:
    """The least time one row's (b, k)-ordered FMA chain can take: its
    slots, one dependent FMA latency each, at the SM clock."""
    return longest_run * FMA_CYCLES / SM_CLOCK_HZ * 1e3


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_once(torch, fn, *args) -> float:
    """ms of one warm call (the plain versions take seconds)."""
    fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def measure_bag_matmul(torch, served, arch: str, launches: int, flush,
                       worst: float) -> dict:
    """Phase 9: bag_matmul's three tier launches at the serving shapes of
    16 requests on the served store."""
    import numpy as np

    from repro_torch.core.packed_store import _split
    from repro_torch.kernels.bag_matmul import kernel as bm_kernel
    from repro_torch.kernels.bag_matmul import ref as bm_ref
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.loop import drifting_zipf_batch

    server, model, params = served.server, served.model, served.params
    packed, spec = server.packed, model.spec
    b = served.record["batch"]
    f, d = spec.num_fields, spec.dim
    w = params["net"]["deep"]["l0"]["w"]
    h = w.shape[1]
    w3 = w.reshape(f, d, h).contiguous()
    cards = np.asarray(spec.cardinalities, np.int64)
    tiers = (("int8", packed.payload8, packed.scale8),
             ("bfloat16", packed.payload16, packed.scale16),
             ("float32", packed.payload32, None))
    inputs = {name: [] for name, _, _ in tiers}
    live = {name: 0 for name, _, _ in tiers}
    rows = {name: 0 for name, _, _ in tiers}
    n = 16
    for r in range(n):
        idx = torch.from_numpy(drifting_zipf_batch(
            cards, b, 1000 + r, n)).to(packed.indirect.device)
        tier, loc = _split(packed, globalize(idx, spec))
        for t, (name, payload, scales) in enumerate(tiers):
            wt = (tier == t).to(torch.float32).contiguous()
            li = loc.clamp(0, payload.shape[0] - 1).to(torch.int32)
            inputs[name].append((payload, scales, li.contiguous(), wt, w3))
            live[name] += int((wt != 0).sum())
            rows[name] += int(torch.unique(li[wt != 0]).numel())
    for name, _, _ in tiers:
        for a in inputs[name][:2]:
            got = bm_kernel.bag_matmul_cuda(*a)
            want = bm_ref.bag_matmul_ref(*a)
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                raise SystemExit(f"bag_matmul[{arch}, {name}] != plain on the "
                                 "served store")
            worst = max(worst, float((got - want).abs().max()))
    by_tier, bounds, t_bytes, t_flops = {}, [], 0.0, 0.0
    for name, payload, scales in tiers:
        args = inputs[name]
        slots, distinct = live[name] / n, rows[name] / n
        row_bytes = d * payload.element_size() + (4 if scales is not None
                                                  else 0)
        # every weight, the index of each live slot, each distinct live
        # row (and scale) once, w3 once, the output; 2 D H flops a slot
        nbytes = (b * f * 4 + slots * 4 + distinct * row_bytes
                  + f * d * h * 4 + b * h * 4)
        flops = slots * 2 * d * h
        bound_ms, _ = _bound(nbytes, flops)
        bounds.append(bound_ms)
        t_bytes += nbytes
        t_flops += flops
        ms = time_launches(torch, bm_kernel.bag_matmul_cuda, args, flush)
        plain_ms = time_once(torch, bm_ref.bag_matmul_ref, *args[0])
        acts = [(bm_ref.slot_rows(p, s, i, wt).reshape(b, f * d),)
                for p, s, i, wt, _ in args]
        want = bm_kernel.bag_matmul_cuda(*args[0])
        lib = torch.matmul(acts[0][0], w)
        lib_err = float((lib - want).abs().max())
        library_ms = time_launches(torch, lambda x: torch.matmul(x, w),
                                   acts, flush)
        by_tier[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "library_ms": library_ms, "live_slots": slots,
                         "distinct_live_rows": distinct, "bytes": nbytes,
                         "flops": flops, "library_max_abs_diff": lib_err}
        del acts
    mean = {k: sum(t[k] for t in by_tier.values()) / 3
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"bag_matmul[{arch}] at B={b} K={f} D={d} H={h}: "
        + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                    f"matmul {v['library_ms']:.4f}, plain "
                    f"{v['plain_ms']:.1f})" for k, v in by_tier.items()))
    return {
        "name": f"bag_matmul[{arch}]", "route": "cuda",
        "source": SOURCE_BAG_MATMUL, "replaces": TPU_BAG_MATMUL,
        "launches": launches, "max_abs_err": worst, "ms": mean["ms"],
        "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"],
        "bound_by": _bound(t_bytes, t_flops)[1],
        "library_ms": mean["library_ms"], "by_tier": by_tier,
        "shape": {"B": b, "K": f, "D": d, "H": h},
        "per": "launch (mean of the 3 tier launches of a request)"}


def measure_cin(torch, served, launches: int, flush, worst: float) -> dict:
    """Phase 9: the three CIN layers on a served xDeepFM batch."""
    import numpy as np

    from repro_torch.kernels.cin import kernel as cin_kernel
    from repro_torch.kernels.cin import ref as cin_ref
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.cache import cached_lookup
    from repro_torch.serve.loop import drifting_zipf_batch

    server, model, params = served.server, served.model, served.params
    spec = model.spec
    b = served.record["batch"]
    cards = np.asarray(spec.cardinalities, np.int64)
    idx = torch.from_numpy(drifting_zipf_batch(cards, b, REQUESTS,
                                               REQUESTS)).to(server.device)
    with torch.inference_mode():
        emb, _ = cached_lookup(server.packed, server.cache,
                               globalize(idx, spec), server.lookup_fn())
    emb = emb.contiguous()
    layers, x = [], emb
    for i in range(len(params["net"]["cin"])):
        wi = params["net"]["cin"][f"w{i}"].contiguous()
        layers.append((wi, x, emb))
        x = cin_kernel.cin_layer_cuda(wi, x, emb)
    by_layer, t_bytes, t_flops = [], 0.0, 0.0
    for i, (wi, xk, x0) in enumerate(layers):
        part = (wi, xk[:64].contiguous(), x0[:64].contiguous())
        got, want = cin_kernel.cin_layer_cuda(*part), cin_ref.cin_layer_ref(
            *part)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise SystemExit(f"cin layer {i} != plain on 64 served samples")
        worst = max(worst, float((got - want).abs().max()))
        o, h, m = wi.shape
        d = xk.shape[2]
        flops = 2 * b * o * h * m * d
        nbytes = (o * h * m + b * h * d + b * m * d + b * o * d) * 4
        bound_ms, _ = _bound(nbytes, flops)
        t_bytes += nbytes
        t_flops += flops
        ms = time_launches(torch, cin_kernel.cin_layer_cuda,
                           [(wi, xk, x0)] * 10, flush)
        full = cin_kernel.cin_layer_cuda(wi, xk, x0)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        plain = cin_ref.cin_layer_ref(wi, xk, x0)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        if not bits_equal(full, plain):
            raise SystemExit(f"cin layer {i} != plain on {b} served samples")

        def library(w_, xk_, x0_):
            outer = torch.einsum("bhd,bmd->bhmd", xk_, x0_)
            return torch.einsum("bhmd,ohm->bod", outer, w_)
        lib_err = float((library(wi, xk, x0) - full).abs().max())
        library_ms = time_launches(torch, library, [(wi, xk, x0)] * 10,
                                   flush)
        by_layer.append({"H": h, "M": m, "O": o, "D": d, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "library_ms": library_ms, "flops": flops,
                         "bytes": nbytes, "library_max_abs_diff": lib_err,
                         "ratio_to_library": ms / library_ms})
        del plain, full
    mean = {k: sum(t[k] for t in by_layer) / len(by_layer)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"cin at B={b}: " + ", ".join(
        f"H={t['H']} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, einsum "
        f"{t['library_ms']:.4f}: {t['ms'] / t['library_ms']:.2f}x it, plain "
        f"{t['plain_ms']:.0f})" for t in by_layer)
        + f"; mean {mean['ms']:.4f} ms against a {mean['bound_ms']:.4f} ms "
        f"bound ({mean['bound_ms'] / mean['ms']:.1%}); bit-equal to plain on "
        "64 and 512 samples")
    return {
        "name": "cin[xdeepfm]", "route": "cuda", "source": SOURCE_CIN,
        "replaces": TPU_CIN, "launches": launches, "max_abs_err": worst,
        "ms": mean["ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": _bound(t_bytes, t_flops)[1],
        "library_ms": mean["library_ms"], "by_layer": by_layer,
        "per": "launch (mean of the layer launches of a request)"}


def resume_smoke() -> dict:
    """Phase 7: kill the smoke trainer after its first checkpoint, rerun
    it, and check that it resumed there."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--model",
               "smoke", "--steps", "200", "--batch", "256", "--ckpt-every",
               "5", "--ckpt-dir", ckpt]
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 300
            # a published version: the manager writes manifest.json into
            # a .tmp_* directory first and renames it to step_* after
            while not any(e.startswith("step_") and os.path.exists(
                    os.path.join(ckpt, e, "manifest.json"))
                          for e in os.listdir(ckpt)):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise SystemExit("smoke trainer wrote no checkpoint "
                                     f"(exit {proc.returncode})")
                time.sleep(0.05)
        finally:
            proc.kill()
            proc.wait()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"resumed smoke trainer failed:\n{out.stderr}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
    resumed = rec["resumed_from"]
    if (resumed is None or not 5 <= resumed < 200
            or rec["steps_run"] != 200 - resumed
            or rec["kernel_launches"] != {"dequant_bag": rec["steps_run"],
                                          "bag_grad": rec["steps_run"]}
            or rec["device"] != "cuda"):
        raise SystemExit(f"smoke trainer did not resume: {rec}")
    log(f"resume check: killed after a checkpoint, resumed at step "
        f"{resumed}, ran {rec['steps_run']} steps, loss "
        f"{rec['loss_last']:.4f}")
    return rec


def pipeline_audit(torch, kernels_mod, label: str) -> tuple:
    """(audit, fit_audit, seen) for ``pipeline.main``: the pipeline's
    served lookups (its first served-table eval batch, every micro-batch
    that did not re-tier) held bit for bit to the plain gather of the
    store that served them, on the card: ``packed_store.lookup`` of the
    pack (the eval: the restored pack at the full batch, every tier's
    slots), or ``hashed_gather_ref`` over the hashed backend's pool; and
    the hashed fit's first ``adj``, chunk by chunk, to the plain
    ``bag_grad`` accumulated onto the same running result.  The plain
    versions launch no kernel (checked), so the run's counts stay the
    main path's."""
    from repro_torch.core import packed_store as ps
    from repro_torch.dist.packed import ShardedPack, unshard_packed
    from repro_torch.kernels.dequant_bag import ref as db_ref
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.ops import slot_plan

    seen = {"eval": {"batches": 0, "slots": 0},
            "serve": {"batches": 0, "slots": 0}, "eval_slots_by_tier": None,
            "fit": {"chunks": 0, "rows": 0, "slots": 0, "check_s": 0.0}}

    def check_fit_chunk(hcfg, r0, r1, g, bags, signs, before, after):
        t0 = time.perf_counter()
        launched = kernels_mod.launch_counts()
        with torch.inference_mode():
            want = db_ref.bag_grad_ref(g, None, bags, signs,
                                       hcfg.num_slots, out=before)
            ok = bits_equal(after, want)
        if kernels_mod.launch_counts() != launched:
            raise SystemExit(f"pipeline {label}: the plain adj launched a "
                             "kernel")
        if not ok:
            raise SystemExit(f"pipeline {label}: the fit's first adj over "
                             f"rows [{r0}, {r1}) != the plain bag_grad, max "
                             f"err {float((after - want).abs().max())}")
        del want
        fit = seen["fit"]
        fit["chunks"] += 1
        fit["rows"] += r1 - r0
        fit["slots"] += int(bags.numel())
        fit["check_s"] += time.perf_counter() - t0

    def audit(stage, store, gidx, emb):
        before = kernels_mod.launch_counts()
        if isinstance(store, ShardedPack):      # --mesh: the shards' pack
            store = unshard_packed(store)
        with torch.inference_mode():
            if isinstance(store, ps.PackedStore):
                plain = ps.lookup(store, gidx)
                by_tier = torch.bincount(
                    ps.packed_tiers(store)[gidx.to(torch.int64)].reshape(-1)
                    .to(torch.int64), minlength=3).tolist()
            else:
                hs, hcfg = store.hs, store.hcfg
                slots, coeff = slot_plan(
                    gidx.reshape(-1, 1), None, num_chunks=hcfg.num_chunks,
                    num_hashes=hcfg.num_hashes, num_slots=hcfg.num_slots,
                    seed=hcfg.seed)
                plain = hg_ref.hashed_gather_ref(
                    hs.pool, hs.pool_scale, slots, coeff,
                    num_chunks=hcfg.num_chunks).reshape(*gidx.shape, -1)
                by_tier = None
        if kernels_mod.launch_counts() != before:
            raise SystemExit(f"pipeline {label}: the plain {stage} gather "
                             "launched a kernel")
        if emb is None or not bits_equal(emb, plain):
            raise SystemExit(f"pipeline {label}: served {stage} embeddings "
                             "!= the plain gather")
        seen[stage]["batches"] += 1
        seen[stage]["slots"] += int(gidx.numel())
        if stage == "eval":
            seen["eval_slots_by_tier"] = by_tier
    return audit, check_fit_chunk, seen


def pipeline_phase(torch, kernels_mod, kernel, pipeline, argv: list,
                   label: str, mesh: int = 1) -> tuple[dict, dict]:
    """Phases 11 and 12: ``repro_torch.launch.pipeline`` as its CLI runs,
    with the counts set to 0 just before and read just after, and its
    served lookups held to the plain gather (``pipeline_audit``).
    Returns (the record, the run's launches by kernel and, for
    dequant_bag, by payload dtype).  Phase 19(e) runs it with ``--mesh
    mesh`` in ``argv``: the train, finetune and eval gathers then launch
    ``mesh`` times, the fp32 eval one float32 ``dequant_bag`` a shard a
    batch (``sharded_lookup_train``'s forward over the placed table), the
    hashed serve its plan entry a shard."""
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.store.hashed import CG_ITERS, FIT_CHUNK_ROWS

    audit, fit_audit, seen = pipeline_audit(torch, kernels_mod, label)
    with tempfile.TemporaryDirectory() as ckpt:
        kernels_mod.reset_launches()
        t0 = time.perf_counter()
        # prints the record; raises on a false verify_* or a non-finite loss
        rec = pipeline.main([*argv, "--ckpt-dir", ckpt], audit=audit,
                            fit_audit=fit_audit)
        wall = time.perf_counter() - t0
        counts = kernels_mod.launch_counts()
        counts["dequant_bag_by_dtype"] = dict(kernel.launches)
        counts["hashed_gather_by_entry"] = dict(hg_kernel.launches)
    kl = rec["kernel_launches"]
    micro_batches = -(-rec["serve_requests"] // rec["serve_batch"])
    steps, ft = len(rec["train_losses"]), len(rec["finetune_losses"])
    summed = {k: sum(stage[k] for stage in kl.values()) for k in kl["train"]}
    hashed = rec["store_backend"] == "hashed"
    wanted = [
        rec["device"] == "cuda", steps == rec["train_steps"],
        {k: counts[k] for k in summed} == summed,
        kl["train"]["dequant_bag"] == mesh * steps,
        kl["train"]["bag_grad"] == mesh * steps,
        kl["finetune"]["dequant_bag"] == mesh * ft,
        kl["finetune"]["bag_grad"] == mesh * ft, rec["mesh"] == mesh,
        ft > 0, kl["gradcheck"]["bag_grad"] == 1,
        counts["dequant_bag_rowgrid"] == counts["bag_grad_rowgrid"] == 0,
        seen["eval"]["batches"] == 1,
        seen["eval"]["slots"] == rec["batch"] * rec["fields_total"],
        seen["serve"]["batches"] == micro_batches - rec["retiers"] > 0]
    # the train forward is the single-tier kernel on the fp32 table; every
    # packed lookup one tiered launch (one an eval batch); every hashed
    # gather the ids entry on the fp32 pool
    by_dtype, by_entry = (counts["dequant_bag_by_dtype"],
                          counts["hashed_gather_by_entry"])
    cfg = (pipeline.fast_config() if "--fast" in argv
           else pipeline.PipelineConfig())
    # under a mesh the fp32 eval reads the placed table through the
    # float32 instance, one launch a shard a batch (its eval share)
    fp32_eval = mesh * cfg.eval_batches if mesh > 1 else 0
    lookups = sum(kl[s]["dequant_bag"] for s in ("pack", "eval", "serve"))
    # under a mesh the hashed serve gathers through the plan entry, one
    # launch a shard
    plan = by_entry["float32"]
    wanted += [
        by_dtype["int8"] == by_dtype["bfloat16"] == by_dtype["float16"] == 0,
        by_dtype["tiered"] == lookups - fp32_eval,
        kl["eval"]["dequant_bag"] >= fp32_eval,
        by_dtype["float32"] + by_dtype["tiered"] == counts["dequant_bag"],
        by_entry["int8"] == by_entry["ids_int8"] == 0,
        plan == 0 if mesh == 1 else plan % mesh == 0,
        by_entry["ids_float32"] + plan == counts["hashed_gather"]]
    if hashed:
        # the fit: 1 + CG_ITERS fwd and 2 + CG_ITERS adj passes over its
        # chunks, then fit_residual's gathers
        chunks = rec["fit_chunks"]
        residual = -(-rec["rows"] // FIT_CHUNK_ROWS)
        wanted += [kl["pack"]["hashed_gather"]
                   == (CG_ITERS + 1) * chunks + residual,
                   kl["pack"]["bag_grad"] == (CG_ITERS + 2) * chunks,
                   seen["fit"]["chunks"] == chunks,
                   seen["fit"]["rows"] == rec["rows"],
                   0.0 < rec["fit_relative_residual"] < 1.0,
                   kl["serve"]["hashed_gather"] > 0]
    else:
        wanted += [kl["pack"]["quantize_rowwise"] > 0,
                   kl["eval"]["dequant_bag"]
                   == mesh * cfg.eval_batches + fp32_eval,
                   kl["serve"]["dequant_bag"] > 0]
    if not all(wanted):
        raise SystemExit(f"pipeline {label}: unexpected launches, record "
                         f"or audit: {wanted}, {counts}, {kl}, {seen}")
    writes = rec["checkpoints"]["train"] + rec["checkpoints"]["pack"]
    summary = {
        "label": label, "wall_s": wall, "stage_seconds": rec["stage_seconds"],
        "fit": ({k: rec[k] for k in ("fit_s", "fit_chunks",
                                     "fit_relative_residual")}
                | {"fit_s_without_checks": rec["fit_s"]
                   - seen["fit"]["check_s"]} if hashed else None),
        "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
        "rows": rec["rows"], "reduced": rec["reduced"],
        "checkpoints": [dict(w, write_gb_per_s=w["bytes"] / w["write_s"]
                             / 1e9) for w in writes],
        "launches": counts, "device_name": rec["device_name"],
        "served_vs_plain_bit_equal": seen}
    print(json.dumps({"pipeline": summary}), flush=True)
    if hashed:
        log(f"pipeline {label}: fit of {rec['rows']:,} rows in "
            f"{rec['fit_chunks']} chunks {rec['fit_s']:.2f} s "
            f"({summary['fit']['fit_s_without_checks']:.2f} s without the "
            f"per-chunk plain checks), relative residual "
            f"{rec['fit_relative_residual']:.4f}; each chunk's first adj "
            f"bit-equal to the plain bag_grad")
    log(f"pipeline {label}: {wall:.1f}s, stages {rec['stage_seconds']}, "
        f"peak {(rec['max_memory_allocated_bytes'] or 0) / 1e9:.2f} GB, "
        f"{rec['fields_pruned']}/{rec['fields_total']} fields pruned, ratio "
        f"{rec['compression_ratio']}, AUC {rec['eval_auc_fp32']} -> "
        f"{rec['eval_auc_packed']}, all verify_* true, served lookups "
        f"bit-equal to the plain gather {seen}, launches {counts}")
    return rec, counts


def path_counts(kernels_mod, kernel, hg_kernel) -> dict:
    """The launches since the last reset, by kernel, with dequant_bag by
    payload dtype (and its tiered entry) and hashed_gather by entry."""
    counts = kernels_mod.launch_counts()
    counts["dequant_bag_by_dtype"] = dict(kernel.launches)
    counts["hashed_gather_by_entry"] = dict(hg_kernel.launches)
    return counts


def record_path(kernels: list, grad_entry: dict, quant_by_path: dict,
                rowgrid_by_path: dict, label: str, counts: dict,
                arch: str | None = None) -> None:
    """Write one main path's launches (``path_counts``) into the kernels
    line's entries; ``arch``, when given, is the only arch whose fused
    head ran on the path."""
    from repro_torch.kernels.dequant_bag import kernel
    rowgrid_by_path[label] = {k: counts[k] for k in kernel.rowgrid_launches}
    for k in kernels:
        if k["name"].startswith("dequant_bag["):
            dtype = k["name"][len("dequant_bag["):-1]
            k["launches_by_path"][label] = counts[
                "dequant_bag_by_dtype"][dtype]
        elif k.get("counter") is not None:
            # hashed_gather's entries by pool dtype
            k["launches_by_path"][label] = counts[
                "hashed_gather_by_entry"][k["counter"]]
        elif k["name"].startswith(("bag_matmul[", "cin[")):
            kern, k_arch = k["name"][:-1].split("[")
            k.setdefault("launches_by_path",
                         {f"online_{k_arch}": k["launches"]})
            k["launches_by_path"][label] = (
                counts[kern] if arch in (None, k_arch) else 0)
    grad_entry["launches_by_path"][label] = counts["bag_grad"]
    quant_by_path[label] = counts["quantize_rowwise"]


def check_stream(path: str) -> list[dict]:
    """Phase 13: every record of ``path`` (one a line for ``.jsonl``)
    through the unchanged ``tools/check_bench_schema.py``, run as a
    subprocess; returns the records."""
    return check_files([path])[path]


def check_files(paths: list) -> dict:
    """``check_stream`` of many files in one subprocess; returns each
    path's records."""
    out = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "check_bench_schema.py"), *paths],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"records do not validate:\n{out.stdout}"
                         f"{out.stderr}")
    log(out.stdout.strip())
    recs = {}
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        recs[path] = ([json.loads(ln) for ln in text.splitlines()
                       if ln.strip()] if path.endswith(".jsonl")
                      else [json.loads(text)])
    return recs


def metrics_off() -> None:
    """Close the metrics sink and turn the registry off and empty, so
    that the next phase runs with metrics off, as before."""
    from repro_torch import obs
    obs.close_sink()
    obs.disable()
    obs.get_registry().reset()


def hist_summary(h: dict) -> dict:
    return {k: h[k] for k in ("count", "sum", "min", "p50", "p99", "max")}


def metrics_online(torch, serve, kernels_mod, counters, logits_before: list,
                   rec_off: dict, path: str) -> tuple:
    """Phase 13 (a): phase 8's wide&deep serve again with ``--metrics-out``;
    its stream validates, its final snapshot's counters equal the record's
    (which still equal ``PACKED_BEFORE``: ``serve_online`` checks), and
    each request's fused logits equal phase 8's bit for bit.  Returns
    (the record, the run's launches by kernel)."""
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    try:
        served, _, _ = serve_online(torch, serve, kernels_mod, counters,
                                    "wide-deep", metrics_out=path,
                                    logits_before=logits_before)
        counts = path_counts(kernels_mod, kernel, hg_kernel)
    finally:
        metrics_off()
    rec = served.record
    lines = check_stream(path)
    last = lines[-1]
    want = {"serve.requests": rec["requests"], "serve.lookups": rec["lookups"],
            "serve.cache.hits": rec["hits"],
            "serve.retier.rows_moved": rec["rows_moved"],
            "serve.retier_us": rec["retiers"]}
    got = {k: last["counters"].get(k) for k in want}
    got["serve.retier_us"] = last["histograms"]["serve.retier_us"]["count"]
    if (got != want or last["ticks"] != REQUESTS
            or len(lines) != REQUESTS // METRICS_EVERY + 1
            or last["histograms"]["serve.request_us"]["count"] != REQUESTS):
        raise SystemExit(f"metrics wide-deep: the snapshot {got} (ticks "
                         f"{last['ticks']}, {len(lines)} lines) != the "
                         f"record's {want}")
    h = last["histograms"]
    summary = {
        "arch": "wide-deep", "lines": len(lines), "counters": got,
        "gauges": last["gauges"],
        "p50_us": {"metrics_on": rec["p50_us"], "metrics_off":
                   rec_off["p50_us"]},
        "p99_us": {"metrics_on": rec["p99_us"], "metrics_off":
                   rec_off["p99_us"]},
        "spans": {k: hist_summary(v) for k, v in h.items() if v["count"]},
        "logits_bit_equal_to_metrics_off": True,
        "device_name": rec["device_name"]}
    print(json.dumps({"metrics_online": summary}), flush=True)
    log(f"metrics wide-deep: {len(lines)} valid snapshot lines, counters "
        f"{got} equal to the record's, logits bit-equal to phase 8's; p50 "
        f"{rec['p50_us']:.0f} us (metrics off {rec_off['p50_us']:.0f}), p99 "
        f"{rec['p99_us']:.0f} us (off {rec_off['p99_us']:.0f})")
    del served
    torch.cuda.empty_cache()
    return rec, counts


def check_pipeline_metrics(rec: dict, path: str, requests: int) -> dict:
    """Phase 13 (b): phase 11's ``--metrics-out`` stream validates; the
    train loop's steps, one observation of each stage and the served
    requests are the record's."""
    lines = check_stream(path)
    last = lines[-1]
    h, c = last["histograms"], last["counters"]
    steps = len(rec["train_losses"])
    stages = {s: h.get(f"pipeline.{s}_us", {}).get("count")
              for s in rec["stage_seconds"]}
    if (c.get("train.steps") != steps or h["train.step_us"]["count"] != steps
            or set(stages.values()) != {1}
            or c.get("serve.requests") != requests
            or rec["serve_requests"] != requests):
        raise SystemExit(f"pipeline metrics: steps {c.get('train.steps')} / "
                         f"{steps}, stages {stages}, requests "
                         f"{c.get('serve.requests')} / {requests}")
    summary = {"lines": len(lines), "counters": c,
               "stages": {s: hist_summary(h[f"pipeline.{s}_us"])
                          for s in rec["stage_seconds"]},
               "spans": {k: hist_summary(v) for k, v in h.items()
                         if v["count"] and not k.startswith("pipeline.")},
               "device_name": rec["device_name"]}
    print(json.dumps({"metrics_pipeline": summary}), flush=True)
    stage_s = {k: round(v["sum"] / 1e6, 3)
               for k, v in summary["stages"].items()}
    log(f"metrics pipeline: {len(lines)} valid snapshot lines, {steps} train "
        f"steps, {requests} requests, one observation a stage: {stage_s} s")
    return summary


def bench_qps(torch, kernels_mod, path: str,
              retier_async: bool = False) -> dict:
    """Phase 13 (c): ``python -m repro_torch.benchmarks.qps --online
    --serve-batch 1,8,32 --emit path`` through its ``main``, with the
    counts set to 0 just before and read just after.  The record
    validates, its byte columns are equal across the sweep, and the
    tiered dequant_bag and rowwise_quant launched.  Phase 14 (c) adds
    ``--retier-async``: the schema tool then holds each entry's p99 and
    ``p99_while_retiering`` to 10x its p50, and every entry must have
    swapped."""
    from repro_torch.benchmarks import qps
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    # garbage collections during the run (a full one over a large heap
    # would stall a request): (generation, ms) each
    pauses, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           (time.perf_counter() - started["t"]) * 1e3))
    kernels_mod.reset_launches()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        rec = qps.main(["--online", "--serve-batch", BENCH_QPS_BATCHES,
                        "--emit", path]
                       + (["--retier-async"] if retier_async else []))
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t0
    gcs = {"objects": len(gc.get_objects()),
           "collections": [sum(g == k for g, _ in pauses) for k in range(3)],
           "longest_ms": max((ms for _, ms in pauses), default=0.0)}
    log(f"bench_qps{' --retier-async' if retier_async else ''}: garbage "
        f"collections by generation {gcs['collections']}, longest "
        f"{gcs['longest_ms']:.2f} ms, {gcs['objects']} objects tracked")
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    (written,) = check_stream(path)
    sweep = written["sweep"]
    byte_cols = {(e["bytes_per_request_fp32"], e["bytes_per_request_packed"])
                 for e in sweep}
    if (written != json.loads(json.dumps(rec)) or rec["device"] != "cuda"
            or [e["serve_batch"] for e in sweep]
            != [int(x) for x in BENCH_QPS_BATCHES.split(",")]
            or len(byte_cols) != 1
            or counts["dequant_bag_by_dtype"]["tiered"] <= 0
            or counts["quantize_rowwise"] <= 0
            or counts["dequant_bag"] != counts["dequant_bag_by_dtype"][
                "tiered"]
            or rec["retier_async"] is not retier_async
            or (retier_async and not all(e["swaps"] > 0 for e in sweep))):
        raise SystemExit(f"bench_qps: unexpected record or launches: "
                         f"{byte_cols}, {counts}, {sweep}")
    keys = ("serve_batch", "qps", "steady_qps", "p50_us", "p99_us",
            "requests", "lookups", "hits", "retiers", "rows_moved")
    if retier_async:
        keys += ("p99_while_retiering", "p99_retier_attributed",
                 "shadow_builds", "swaps")
    summary = {"wall_s": wall, "retier_async": retier_async,
               "packed_fp32_ratio": rec["packed_fp32_ratio"],
               "bytes_per_request": sorted(byte_cols)[0],
               "sweep": [{k: e[k] for k in keys} for e in sweep],
               "launches": counts, "device_name": rec["device_name"],
               "gc": gcs}
    print(json.dumps({"bench_qps": summary}), flush=True)
    log(f"bench_qps{' --retier-async' if retier_async else ''}: a valid "
        f"bench_qps/v1 record in {wall:.1f}s, "
        f"{[(e['serve_batch'], round(e['p50_us'], 1)) for e in sweep]} "
        f"(serve batch, p50 us), launches {counts}")
    return counts


def paper_tables(torch, kernels_mod) -> dict:
    """Phase 15: ``python -m repro_torch.benchmarks.run --fast`` (the
    paper's six tables and figures at the reference's reduced budgets, on
    the card; phase 17 took the time of the full ones)
    through its ``main``, with the counts set to 0 just before and read
    just after: no kernel of the port launches on this path.  Checks
    every AUC finite and in [0, 1], the closed-form memory columns and
    Table 2's passes against their formulas, and ``eval_auc`` of Table
    3's fp32 params (retrained: the same seeds and steps) on the card
    against the same params on the CPU within 1e-5.  Prints, as a finding
    and not a check, how many planted-dead fields F-Permutation ranks
    least important."""
    import itertools

    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.fig2_fperm import rank_fperm
    from repro_torch.core.baselines import mpe
    from repro_torch.core.tiers import fp32_bytes
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.optim.optimizers import tree_map
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    out = {}
    for name in PAPER_JOBS:
        out.update(bench_run.main(["--only", name, "--fast"]))
    wall = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    launched = {k: v for k, v in counts.items() if isinstance(v, int) and v}
    launched.update({f"{k}[{e}]": n for k in ("dequant_bag_by_dtype",
                                              "hashed_gather_by_entry")
                     for e, n in counts[k].items() if n})
    bad = []
    if launched:
        bad.append(f"kernels launched: {launched}")
    if list(out) != list(PAPER_JOBS):
        bad.append(f"jobs {list(out)}")
    for name, job in out.items():
        for row in job["rows"]:
            if "auc" in row and not (math.isfinite(row["auc"])
                                     and 0.0 <= row["auc"] <= 1.0):
                bad.append(f"{name}: AUC {row}")
    setup = common.make_setup(num_fields=10, important=5, train_steps=800)
    spec = setup.model.spec
    v, d = spec.total_rows, spec.dim
    fp32 = fp32_bytes(v, d)
    t3 = {r["method"]: r for r in out["table3_fquant"]["rows"]}
    want = {"fp32": 1.0, "uniform_fp16_sr": 0.5, "uniform_int8_sr": 0.25,
            "mpe_lfu": round(mpe.memory_bytes(
                v, d, mpe.MPEConfig(capacity=int(v * 0.18))) / fp32, 3),
            "alpt_int8": round((v * d + v * 4) / fp32, 3)}
    for method, mem in want.items():
        if t3[method]["memory"] != mem:
            bad.append(f"table3 {method} memory {t3[method]} != {mem}")
    t4 = {r["method"]: r for r in out["table4_combined"]["rows"]}
    tb = [float(b) for b in spec.table_bytes()]
    shares = {round(sum(tb[i] for i in c) / sum(tb), 3)
              for c in itertools.combinations(range(10), 6)}
    if t4["baseline"]["memory"] != 1.0 or \
            t4["f_permutation"]["memory"] not in shares:
        bad.append(f"table4 memory {t4}")
    t2 = {r["method"]: r for r in out["table2_time"]["rows"]}
    speed = t2["speedup f_p vs permutation (measured)"]
    if ((t2["f_permutation"]["passes"],
         t2["f_permutation"]["paper_scale_passes"]) != (3, 3)
            or (t2["permutation"]["passes"],
                t2["permutation"]["paper_scale_passes"]) != (
                    10 * PAPER_SHUFFLES + 1, 180 * 10 + 1)
            or speed["paper_scale_passes"] != round(1801 / 3, 1)):
        bad.append(f"table2 passes {t2}")
    # Table 3's fp32 params again, evaluated on the card and on the CPU
    t1 = time.perf_counter()
    params = common.train_fp32(setup)
    auc_card = common.eval_auc(setup, params)
    cpu = common.make_setup(num_fields=10, important=5, device="cpu",
                            params=tree_map(lambda t: t.cpu(), params))
    auc_cpu = common.eval_auc(cpu, cpu.params)
    if abs(auc_card - auc_cpu) > 1e-5:
        bad.append(f"eval_auc card {auc_card} cpu {auc_cpu}")
    order = rank_fperm(setup, params)
    dead = sorted(int(f) for f in setup.ds.lossless_fields())
    found = sorted(set(int(f) for f in order[:len(dead)]) & set(dead))
    check_s = time.perf_counter() - t1
    summary = {
        "wall_s": wall, "seconds": {k: j["seconds"] for k, j in out.items()},
        "table2_measured_speedup": speed["measured_s"],
        "table2_s": {m: t2[m]["measured_s"]
                     for m in ("f_permutation", "permutation")},
        "table3_fp32_auc_retrained": {"card": auc_card, "cpu": auc_cpu,
                                      "table3_row": t3["fp32"]["auc"]},
        "fperm_least_important": [int(f) for f in order],
        "planted_dead_fields": dead,
        "dead_fields_ranked_least": f"{len(found)} of {len(dead)}",
        "check_s": check_s, "launches": counts}
    print(json.dumps({"paper_tables": summary}), flush=True)
    log(f"paper tables: six jobs in {wall:.1f}s "
        f"{ {k: round(j['seconds'], 1) for k, j in out.items()} }, "
        f"Table 2 F-P speedup {speed['measured_s']:.2f}x, "
        f"{len(found)} of {len(dead)} planted-dead fields ranked least "
        f"important by F-P")
    if bad:
        raise SystemExit(f"paper tables: {bad}")
    return counts


def hash_step_audit(torch, counters, flush, seen: dict):
    """Phase 16 (a): the audit ``run_hashed_sweep`` calls before each
    hashed arm's first step.  Outside the counts (``Uncounted``), the
    step's forward (``hashed_gather``'s plan entry, through the training
    twin) and its pool gradient (``bag_grad``, the cotangent of the head's
    loss) on the arm's initial pool and first batch are held bit for bit
    to ``hashed_gather_ref`` and ``hashed_grad_ref``; at the first arm the
    forward is also timed at that shape beside its bound, its plain
    version and ``F.embedding_bag``."""
    import torch.nn.functional as F

    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.hashed_gather.autodiff import hashed_lookup_train
    from repro_torch.kernels.hashed_gather.kernel import hashed_gather_cuda
    from repro_torch.kernels.hashed_gather.ops import slot_plan
    from repro_torch.models.embedding import globalize

    def audit(model, hcfg, params, batch):
        c, z, s = hcfg.num_chunks, hcfg.chunk_dim, hcfg.num_slots
        kw = dict(num_chunks=c, num_hashes=hcfg.num_hashes, seed=hcfg.seed)
        with Uncounted(counters):
            pool = params["embed_table"]
            gidx = globalize(batch["indices"], model.spec)
            leaf = pool.detach().clone().requires_grad_()
            with torch.enable_grad():
                emb = hashed_lookup_train(leaf, gidx, **kw)
                e = emb.detach().requires_grad_()
                loss = model.loss_from_emb(params, e, batch).mean()
                (g_emb,) = torch.autograd.grad(loss, e)
                (dpool,) = torch.autograd.grad(emb, leaf, g_emb)
            with torch.inference_mode():
                slots, coeff = slot_plan(gidx.reshape(-1, 1), None,
                                         num_slots=s, **kw)
                want = hg_ref.hashed_gather_ref(pool, None, slots, coeff,
                                                num_chunks=c)
                want_grad = hg_ref.hashed_grad_ref(
                    g_emb.reshape(-1, c * z), None, slots, coeff, s,
                    num_chunks=c)
                torch.cuda.synchronize()
                if not (bits_equal(emb.detach().reshape(want.shape), want)
                        and bits_equal(dpool, want_grad)):
                    raise SystemExit(
                        f"bench_hash S={s}: the first hashed step's forward "
                        "or pool gradient != plain")
                seen["steps_checked"] += 1
                if "train_shape" not in seen:
                    seen["train_shape"] = time_train_gather(
                        torch, F, hashed_gather_cuda, hg_ref, pool, slots,
                        coeff, c, flush)
    return audit


def time_train_gather(torch, F, kernel_fn, hg_ref, pool, slots, coeff,
                      c: int, flush) -> dict:
    """Row 6 at the hashed train step's shape (a batch's ids x C x T over
    the pool): ms a launch beside its bound, its plain version and
    ``F.embedding_bag``."""
    nb, z = slots.shape[0], pool.shape[1]
    t = slots.shape[1] // c
    reps = [(pool, None, slots, coeff)] * 20
    ms = time_launches(torch, lambda *a: kernel_fn(*a, num_chunks=c), reps,
                       flush)
    plain_ms = time_launches(
        torch, lambda *a: hg_ref.hashed_gather_ref(*a, num_chunks=c),
        reps[:3], flush)

    def library():
        return F.embedding_bag(slots.reshape(-1, t), pool, mode="sum",
                               per_sample_weights=coeff.reshape(-1, t))
    library_ms = time_launches(torch, library, [()] * 20, flush)
    live = slots[coeff != 0]
    rows = int(torch.unique(live).numel())
    nbytes = slots.numel() * 8 + rows * z * 4 + nb * c * z * 4
    bound_ms, bound_by = _bound(nbytes, 3 * z * live.numel())
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "shape": {"B": nb, "C": c, "T": t, "Z": z, "S": pool.shape[0]},
            "distinct_pool_rows": rows,
            "per": "launch (a hashed train step's forward)"}


def bench_hash(torch, kernels_mod, counters, path: str) -> dict:
    """Phase 16 (a): ``python -m repro_torch.benchmarks.run --fast --emit
    path/BENCH_hash.json`` through its ``main`` at the reference's reduced
    budgets, with the counts set to 0 just before and read just after;
    the record through the unchanged schema tool; each kernel's launches
    as the sweep's steps, materialisations and requests make them."""
    from repro_torch.benchmarks import hashed
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import make_setup
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.store import hashed as H

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    seen = {"steps_checked": 0}
    audit = hash_step_audit(torch, counters, flush, seen)
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    out = bench_run.main(["--fast", "--emit", path], audit=audit)
    wall = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    rec = out["BENCH_hash.json"]["record"]
    (written,) = check_stream(path)
    sweep, steps = rec["sweep"], rec["train_steps"]
    n = len(sweep)
    by_dtype, by_entry = (counts["dequant_bag_by_dtype"],
                          counts["hashed_gather_by_entry"])
    # a serve: one gather a micro-batch, a cache build at the start and at
    # each re-tier; a ratio's two materialisations (fp32 and int8 pools)
    serving = sum(-(-rec["requests"] // rec["serve_batch"]) + 1 + e["retiers"]
                  for e in sweep)
    wanted = {
        "record as written": written == json.loads(json.dumps(rec)),
        "device": rec["device"] == "cuda",
        "reduced budgets": (tuple(e["ratio_target"] for e in sweep),
                            steps, rec["requests"])
        == (hashed.FAST_RATIOS, 120, 32),
        "plan entry a hashed step": by_entry["float32"] == n * steps,
        "bag_grad a step": counts["bag_grad"] == (n + 1) * steps,
        "dequant_bag a dense step": (by_dtype["float32"], counts[
            "dequant_bag"]) == (steps, steps),
        "quantize_rowwise a quantize_pool": counts["quantize_rowwise"] == n,
        "ids entry, int8 pools": by_entry["ids_int8"] == n,
        "ids entry, fp32 pools": by_entry["ids_float32"] == n + serving,
        "no int8 plan entry": by_entry["int8"] == 0,
        "first steps checked": seen["steps_checked"] == n,
        "AUCs": all(0.0 <= e[k] <= 1.0 for e in sweep
                    for k in ("auc", "auc_combined"))
        and 0.0 <= rec["auc_fp32"] <= 1.0,
        "rowgrid": counts["dequant_bag_rowgrid"] == counts[
            "bag_grad_rowgrid"] == 0}
    bad = [k for k, ok in wanted.items() if not ok]
    if bad:
        raise SystemExit(f"bench_hash: {bad}: {counts}, {rec}")
    # ms a step of each arm, apart from the counted run
    setup = make_setup(seed=0)
    v, d = setup.model.spec.total_rows, setup.model.spec.dim
    step_ms = {}
    for label, ratio in (("dense", None), ("hashed_100", 100.0)):
        hcfg = None if ratio is None else H.HashedConfig(
            vocab=v, dim=d, chunk_dim=8, num_hashes=4,
            num_slots=H.plan_pool_slots(v, d, 8, ratio))
        hashed._train(setup, hcfg, 5, 0.2, 0.05)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hashed._train(setup, hcfg, 100, 0.2, 0.05)
        torch.cuda.synchronize()
        step_ms[label] = (time.perf_counter() - t1) * 10.0
    keys = ("ratio_target", "pool_slots", "bytes", "bytes_combined", "auc",
            "auc_gap", "auc_combined", "p50_us", "p99_us", "steady_qps",
            "lookups", "hits", "retiers")
    summary = {"wall_s": wall, "auc_fp32": rec["auc_fp32"],
               "step_ms": step_ms, "sweep": [{k: e[k] for k in keys}
                                             for e in sweep],
               "row6_train_shape": seen["train_shape"], "launches": counts,
               "device_name": rec["device_name"]}
    print(json.dumps({"bench_hash": summary}), flush=True)
    log(f"bench_hash: a valid bench_hash/v1 record in {wall:.1f}s at the "
        f"reference's --fast budgets ({n} ratios x {steps} steps + the dense arm; "
        f"{step_ms['dense']:.2f} / {step_ms['hashed_100']:.2f} ms a dense / "
        f"hashed step); AUC fp32 {rec['auc_fp32']}, by ratio "
        f"{[(e['ratio_target'], e['auc'], e['auc_combined']) for e in sweep]}"
        f"; each arm's first step bit-equal to plain; row 6 at the step's "
        f"shape {seen['train_shape']['ms']:.4f} ms (bound "
        f"{seen['train_shape']['bound_ms']:.4f}, embedding_bag "
        f"{seen['train_shape']['library_ms']:.4f}); launches {counts}")
    return counts, seen["train_shape"]


def offline_qps(torch, kernels_mod) -> dict:
    """Phase 16 (b): ``python -m repro_torch.benchmarks.run --only qps``
    (the offline proxy, 20 timed forwards of each arm) through its
    ``main``, counts set to 0 just before and read just after: one tiered
    dequant_bag launch a packed forward (20 and the warm-up), the pack's
    int8 tier through quantize_rowwise; the packed arm's embeddings equal
    the plain ``lookup`` bit for bit; the byte rows equal their formulas
    over the pack's own tiers."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.core import packed_store as ps
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel

    seen = {}

    def audit(packed, gidx, emb):
        with torch.inference_mode():
            plain = ps.lookup(packed, gidx)
            tiers = ps.packed_tiers(packed)[gidx.reshape(-1).to(
                torch.int64)].to(torch.int64)
        d = packed.dim
        per_tier = torch.tensor([d + 4, 2 * d + 4, 4 * d], device=gidx.device)
        seen.update(equal=bits_equal(emb, plain), rows=gidx.numel(), dim=d,
                    packed_bytes=int((per_tier[tiers] + 4).sum()),
                    memory=round(packed.nbytes() / (packed.vocab * d * 4), 3),
                    slots_by_tier=torch.bincount(tiers, minlength=3).tolist())
    kernels_mod.reset_launches()
    out = bench_run.main(["--only", "qps"], audit=audit)
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    rows = {r["metric"]: r["value"] for r in out["qps"]["rows"]}
    fp32 = seen["rows"] * seen["dim"] * 4
    want = {"bytes_per_request_fp32": fp32,
            "bytes_per_request_packed": seen["packed_bytes"],
            "hbm_bytes_ratio (QPS headroom on bw-bound serving)": round(
                fp32 / seen["packed_bytes"], 2),
            "table_memory_ratio": seen["memory"]}
    bad = [k for k, v in want.items() if rows[k] != v]
    if (bad or not seen["equal"] or counts["dequant_bag"] != 21
            or counts["dequant_bag_by_dtype"]["tiered"] != 21
            or counts["quantize_rowwise"] <= 0 or counts["bag_grad"]
            or counts["hashed_gather"]):
        raise SystemExit(f"offline qps: rows {rows} against {want}, "
                         f"embeddings equal {seen['equal']}, launches "
                         f"{counts}")
    ratio = rows["forward_us_fp32"] / rows["forward_us_packed"]
    print(json.dumps({"offline_qps": {"rows": rows, "seconds": out["qps"][
        "seconds"], "fp32_over_packed": ratio, "slots_by_tier": seen[
        "slots_by_tier"], "launches": counts}}), flush=True)
    log(f"offline qps: forward {rows['forward_us_fp32']} us fp32, "
        f"{rows['forward_us_packed']} us packed ({ratio:.3f}x), bytes a "
        f"request {fp32} / {seen['packed_bytes']}; packed embeddings "
        f"bit-equal to the plain lookup; launches {counts}")
    return counts


def emit_records(torch, kernels_mod, tmp: str) -> dict:
    """Phase 16 (c): ``benchmarks.run --emit tmp/BENCH_qps.json --fast``
    and ``--emit-pipeline tmp/p.json --fast`` through ``main``; both
    records through the unchanged schema tool.  Returns each run's
    launches (counts set to 0 just before each, read just after)."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel

    by_path = {}
    for label, argv, path in (
            ("emit_qps", ["--emit"], os.path.join(tmp, "BENCH_qps.json")),
            ("emit_pipeline", ["--emit-pipeline"],
             os.path.join(tmp, "p.json"))):
        kernels_mod.reset_launches()
        out = bench_run.main([*argv, path, "--fast"])
        by_path[label] = counts = path_counts(kernels_mod, kernel, hg_kernel)
        (rec,) = out.values()
        (written,) = check_stream(path)
        if (written != json.loads(json.dumps(rec["record"]))
                or written.get("device") != "cuda"
                or counts["dequant_bag"] <= 0):
            raise SystemExit(f"{label}: unexpected record or launches "
                             f"{counts}")
        log(f"{label}: {path} valid, launches {counts}")
    return by_path


def shadow_summary(rec: dict, sync_rec: dict, stats) -> dict:
    """Phase 14 (a): the async run's counters and tail beside phase 8's
    synchronous run of the same arch (printed; nothing is gated on the
    times)."""
    keys = ("p50_us", "p99_us", "p99_while_retiering",
            "p99_retier_attributed", "steady_qps", "retiers", "rows_moved")
    summary = {"arch": rec["arch"], "shadow_rows": SHADOW_ROWS,
               "requests": rec["requests"],
               "sync_requests": sync_rec["requests"],
               "shadow_builds": stats.shadow_builds,
               "shadow_chunks": stats.shadow_chunks,
               "swaps_on_request_ticks": rec["swaps"],
               "swaps_with_drain": stats.swaps,
               "async": {k: rec[k] for k in keys},
               "sync_phase_8": {k: sync_rec[k] for k in keys},
               "device_name": rec["device_name"]}
    print(json.dumps({"shadow_online": summary}), flush=True)
    log(f"shadow {rec['arch']}: {stats.shadow_builds} builds, "
        f"{stats.shadow_chunks} chunks, {stats.swaps} swaps ({rec['swaps']} "
        f"on request ticks); p50 {rec['p50_us']:.0f} / p99 "
        f"{rec['p99_us']:.0f} / p99 while re-tiering "
        f"{rec['p99_while_retiering']:.0f} us (sync {sync_rec['p50_us']:.0f}"
        f" / {sync_rec['p99_us']:.0f} / {sync_rec['p99_while_retiering']:.0f}"
        f"), p99 attributed {rec['p99_retier_attributed']:.3f} (sync "
        f"{sync_rec['p99_retier_attributed']:.3f})")
    return summary


def unpack_equal(torch, ps, a, b) -> bool:
    """Two packed stores unpack to the same bits, compared in 4M-row
    blocks (a full-width table unpacked whole is 2.8-3.5 GB)."""
    step = 1 << 22
    for r0 in range(0, a.vocab, step):
        r1 = min(a.vocab, r0 + step)
        if not bits_equal(ps.unpack(a, r0, r1), ps.unpack(b, r0, r1)):
            return False
    return True


def shadow_invariants(torch, served) -> dict:
    """Phase 14 (b), on the drained full-width wide&deep server: after one
    drifting fold and one chunk, the shadow materializes bit for bit to
    ``repack_delta`` over the movers done; the build then drains with
    its verify; a second build is discarded after a chunk and the live
    store keeps its tensors and bytes."""
    from repro_torch.core import packed_store as ps
    from repro_torch.models.embedding import globalize
    from repro_torch.serve.loop import drifting_zipf_batch
    server, model = served.server, served.model
    spec, batch = model.spec, served.record["batch"]

    # explicit begins only: the boundary the last request crossed while a
    # build was in flight is drained first, and no later fold opens one
    server.drain_shadow()
    server.online = server.online._replace(retier_every=0)

    def fold(r: int) -> None:
        idx = drifting_zipf_batch(spec.cardinalities, batch, r, r + 1)
        server.observe(globalize(torch.from_numpy(idx).cuda(), spec))

    with torch.inference_mode():
        fold(REQUESTS)
        if not server.begin_retier():
            raise SystemExit("shadow invariants: the fold moved no row")
        sh = server.shadow
        sh.step(max(1, sh.moved // 3))
        delta = ps.repack_delta(server.packed, sh.snapshot, server.cfg,
                                sh.movers[:sh.pos])
        chunk_ok = (not sh.staged
                    and unpack_equal(torch, ps, sh.materialize(), delta))
        del delta
        moved, done = sh.moved, sh.pos
        swaps = server.stats.swaps
        server.drain_shadow()
        fold(REQUESTS + 1)
        if not server.begin_retier():
            raise SystemExit("shadow invariants: the second fold moved no "
                             "row")
        server.shadow.step(max(1, server.shadow.moved // 3))
        live = server.packed
        ptrs = [x.data_ptr() for x in live]
        before = [x.clone() for x in live]
        server.discard_shadow()
        kept = (server.packed is live and server.shadow is None
                and [x.data_ptr() for x in server.packed] == ptrs
                and all(a.shape == b.shape and torch.equal(
                    a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(before, live)))
        torch.cuda.synchronize()
    if not (chunk_ok and kept and server.stats.swaps == swaps + 1):
        raise SystemExit(f"shadow invariants: chunk {chunk_ok}, discard "
                         f"kept the live store {kept}, swaps "
                         f"{server.stats.swaps} after {swaps}")
    out = {"movers": moved, "chunk_rows_done": done,
           "materialize_equals_repack_delta": True,
           "drain_verified": True, "discard_kept_live_store": True}
    print(json.dumps({"shadow_invariants": out}), flush=True)
    log(f"shadow invariants (wide-deep): {moved:,} movers, materialized "
        f"after {done:,} bit-equal to repack_delta, drained with verify, "
        f"a discarded build left the live store's tensors and bytes")
    return out


def trace(torch, serve, served, requests: int, path: str) -> None:
    """--trace: kernel time by name over served requests (the table goes
    to ``path``) and the device busy share (printed)."""
    from torch.profiler import ProfilerActivity, profile
    dev = served.packed.payload32.device
    batches = [{k: v.to(dev) for k, v in served.make_request(r).items()}
               for r in range(requests)]
    with torch.inference_mode():
        serve.serve_request(served.model, served.params, served.packed,
                            batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                serve.serve_request(served.model, served.params,
                                    served.packed, b)
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    table = ev.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"trace": {
        "requests": requests, "wall_us": wall_us,
        "device_busy_us": busy_us, "device_busy_share": busy_us / wall_us,
        "top": [{"name": e.key[:80], "device_us": e.self_device_time_total,
                 "count": e.count} for e in top]}}))


def trace_online(torch, served, arch: str, requests: int, path: str,
                 fuse_matmul: bool = True) -> None:
    """--trace: kernel time by name over ``requests`` more online
    requests of the served arch (one re-tier every 2, as served; through
    the fused head unless ``fuse_matmul`` is False); the table goes to
    ``path``, the busy share and the top kernels are printed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.loop import serve_forward_loop
    server, model = served.server, served.model
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve_forward_loop(server, model, model.spec, served.params,
                                 batch=served.record["batch"],
                                 requests=requests,
                                 fuse_matmul=fuse_matmul)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as fh:
        fh.write(f"\n== online {arch}, {requests} requests ==\n")
        fh.write(ev.table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({"trace_online": {
        "arch": arch, "requests": requests, "wall_us": wall_us,
        "lat_us": [x * 1e6 for x in res.lat_s],
        "retiers_total": res.stats["retiers"],
        "device_busy_us": busy_us, "device_busy_share": busy_us / wall_us,
        "top": [{"name": e.key[:80], "device_us": e.self_device_time_total,
                 "count": e.count} for e in top]}}), flush=True)


def hier_budget_mb(torch, serve, arch: str, frac: float) -> float:
    """Phase 17: ``frac`` of the fully packed bytes of ``arch``'s online
    store at full width (its tiers from the serve CLI's priorities), in
    MiB."""
    from repro_torch import configs
    from repro_torch.core.tiers import assign_tiers, memory_bytes
    spec = configs.get(arch).model.spec
    pri, cfg = serve.plan_store(spec, torch.device("cuda"))
    total = memory_bytes(assign_tiers(pri, cfg.tiers), spec.dim)
    del pri
    return frac * total / 2 ** 20


def hier_serve(torch, serve, kernels_mod, counters, label: str, argv: list,
               store_dir: str) -> tuple:
    """Phase 17 (a)-(c): ``launch.serve`` through the hier store at full
    width (``run(rows_per_shard=HIER_ROWS_PER_SHARD)``, with
    ``--verify-hier``), the counts set to 0 just before and read just
    after.  Every ``HIER_AUDIT_EVERY``-th audited micro-batch (those that
    did not re-tier): the hot level's fused gather against the plain
    ``lookup``, and the embeddings the head got against the host oracle
    (``HierStore.gather_fp32_host``: ``np_lookup`` of every level), bit
    for bit (the fused check's launches uncounted).  A shadow run records
    which swaps published a new cold generation.  Returns (record, the
    path's counts, the audit's stats, the commits)."""
    from repro_torch.core import packed_store as ps
    from repro_torch.dist.packed import ShardedPack
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
    from repro_torch.serve import shadow

    # a shadow's staging thread may quantize while an audit runs: the
    # quantizer's counter is left alone (the audit launches none)
    audited = [c for c in counters if c is not rq_kernel.launches]
    stats = {"batches": 0, "audited": 0, "hot_slots": 0, "staged_rows": 0}

    def make_audit(server, model, params):
        def audit(hot, sb, gidx, emb):
            stats["batches"] += 1
            if (stats["batches"] - 1) % HIER_AUDIT_EVERY:
                return
            with Uncounted(audited), torch.inference_mode():
                # the hot level's gather: fused, or sharded under a mesh
                fused = server.lookup_fn()(hot, sb.hot_local)
                plain = ps.lookup(hot.base if isinstance(hot, ShardedPack)
                                  else hot, sb.hot_local)
            want = torch.from_numpy(server.hier.gather_fp32_host(
                gidx.cpu().numpy()))
            if not (bits_equal(fused, plain) and bits_equal(emb.cpu(), want)):
                raise SystemExit(f"{label}: micro-batch {stats['batches']}: "
                                 "the staged rows are not the plain gather "
                                 "and the host oracle's")
            stats["audited"] += 1
            stats["hot_slots"] += int((sb.stage_slot < 0).sum())
            stats["staged_rows"] += sb.staged
        return audit

    commits = []
    commit = shadow.ShadowMigrate.commit

    def spy(self, server, staged):
        commits.append({"cold_rewritten": self._cold_needed,
                        "shards": (self.writer.num_shards
                                   if self.writer is not None else 0)})
        return commit(self, server, staged)
    shadow.ShadowMigrate.commit = spy
    kernels_mod.reset_launches()
    try:
        served = serve.run(serve.parse_args(
            argv + ["--online", "--model", "full", "--store-backend", "hier",
                    "--store-dir", store_dir, "--verify-hier"]),
            make_audit=make_audit, rows_per_shard=HIER_ROWS_PER_SHARD)
    finally:
        shadow.ShadowMigrate.commit = commit
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    rec = served.record
    dq = counts["dequant_bag_by_dtype"]
    batches = -(-rec["requests"] // rec["serve_batch"])
    if (rec["device"] != "cuda" or stats["audited"] <= 0
            or dq["tiered"] < batches
            or any(n for t, n in dq.items() if t != "tiered")
            or rec["kernel_launches"]["quantize_rowwise"] <= 0
            and rec["retiers"] > 0
            or rec["build_kernel_launches"]["quantize_rowwise"] <= 0
            or counts["quantize_rowwise"] <= 0
            or rec["level_rows"]["cold_rows"] <= 0):
        raise SystemExit(f"{label}: unexpected record or launches: {counts}, "
                         f"{stats}, {rec}")
    keys = ("arch", "requests", "serve_batch", "retier_every",
            "retier_async", "qps", "steady_qps", "p50_us", "p99_us",
            "p99_while_retiering", "cache_hit_rate", "hier_miss_rate",
            "warm_hits", "cold_hits", "staged_rows", "migrations",
            "promoted", "demoted", "retiers", "rows_moved", "shadow_builds",
            "swaps", "hbm_budget_mb", "level_rows", "level_bytes",
            "packed_mib", "build_s", "serve_s", "retier_ms", "verify_s",
            "build_device_peak_bytes", "device_peak_bytes",
            "host_peak_rss_bytes", "kernel_launches",
            "build_kernel_launches", "device_name")
    summary = {k: rec[k] for k in keys}
    summary.update({"path": label, "audit": stats, "path_launches": counts,
                    "commits": commits})
    print(json.dumps({"hier": summary}), flush=True)
    log(f"{label}: {rec['requests']} requests by {rec['serve_batch']}, p50 "
        f"{rec['p50_us']:.0f} us p99 {rec['p99_us']:.0f} us, miss rate "
        f"{rec['hier_miss_rate']}, {rec['migrations']} migrations "
        f"({rec['retier_ms']:.0f} ms a re-tier), {rec['swaps']} swaps on "
        f"request ticks, levels {rec['level_rows']}, build "
        f"{rec['build_s']:.1f}s, serve {rec['serve_s']:.1f}s, verify "
        f"{rec['verify_s']:.1f}s over {sum(rec['level_rows'].values()):,} "
        f"rows, device peak {rec['build_device_peak_bytes'] / 1e9:.2f} GB "
        f"after the build, {rec['device_peak_bytes'] / 1e9:.2f} GB, host "
        f"peak RSS {rec['host_peak_rss_bytes'] / 1e9:.2f} GB; audited "
        f"{stats['audited']} of {stats['batches']} batches; launches "
        f"{counts}")
    del served
    return rec, counts, stats, commits


def hier_phase(torch, serve, kernels_mod, counters) -> dict:
    """Phase 17: the hierarchical store at full width, then its benchmark.
    Returns each path's counts."""
    by_path = {}
    wd_mb = hier_budget_mb(torch, serve, "wide-deep", HIER_FRACTION)
    wd = ["--arch", "wide-deep", "--serve-batch", "8", "--cache-rows", "256",
          "--retier-every", "64", "--drift", "4.0", "--hbm-budget-mb",
          repr(wd_mb), "--host-budget-mb", repr(wd_mb)]
    runs = (("hier_wide-deep", wd + ["--requests", str(HIER_REQUESTS)]),
            ("hier_async_wide-deep",
             wd + ["--requests", str(HIER_ASYNC_REQUESTS), "--retier-async",
                   "--shadow-rows", str(SHADOW_ROWS), "--verify-swap"]),
            ("hier_dlrm-rm2",
             ["--arch", "dlrm-rm2", "--serve-batch", "8", "--cache-rows",
              "256", "--retier-every", str(HIER_DLRM_RETIER_EVERY),
              "--drift", "4.0", "--requests", str(HIER_DLRM_REQUESTS),
              "--hbm-budget-mb", str(HIER_DLRM_HBM_MB), "--host-budget-mb",
              str(HIER_DLRM_HOST_MB)]))
    recs = {}
    for label, argv in runs:
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            recs[label], by_path[label], _, commits = hier_serve(
                torch, serve, kernels_mod, counters, label, argv,
                os.path.join(tmp, "cold"))
        torch.cuda.empty_cache()
        if label.startswith("hier_async"):
            landed = commits[:recs[label]["swaps"]]
            if not any(c["cold_rewritten"] for c in landed):
                raise SystemExit(f"{label}: no swap on a request tick "
                                 f"published a new cold generation: "
                                 f"{commits}, {recs[label]['swaps']} swaps")
            log(f"{label}: p99 while re-tiering "
                f"{recs[label]['p99_while_retiering']:.0f} us against the "
                f"synchronous run's p99 {recs['hier_wide-deep']['p99_us']:.0f}"
                f" us; {len(landed)} swaps on request ticks, "
                f"{sum(c['cold_rewritten'] for c in landed)} of them with a "
                f"new cold generation")
        elif recs[label]["migrations"] <= 0:
            raise SystemExit(f"{label}: no migration on the serve")
    by_path.update(bench_hier(torch, kernels_mod))
    return by_path


def bench_hier(torch, kernels_mod) -> dict:
    """Phase 17 (d): ``python -m repro_torch.benchmarks.hier`` at the
    reference's budgets (fractions 0.05 / 0.15 / 0.4 / 1.0, 256 requests by
    8), then with ``--retier-async``, then ``benchmarks.run --emit
    TMP/BENCH_hier.json --fast``: each record through the unchanged schema
    tool (``hier_miss_rate`` not rising with the budget; the async one's
    tail within 10x its p50), the counts set to 0 just before each and
    read just after."""
    from repro_torch.benchmarks import hier as bhier
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel

    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv in (("bench_hier", []),
                            ("bench_hier_async", ["--retier-async"]),
                            ("emit_hier", None)):
            path = os.path.join(tmp, f"{label}.json")
            kernels_mod.reset_launches()
            t0 = time.perf_counter()
            if argv is None:
                path = os.path.join(tmp, "BENCH_hier.json")
                rec = bench_run.main(["--emit", path, "--fast"])[
                    "BENCH_hier.json"]["record"]
            else:
                rec = bhier.main(["--emit", path] + argv)
            wall = time.perf_counter() - t0
            by_path[label] = counts = path_counts(kernels_mod, kernel,
                                                  hg_kernel)
            (written,) = check_stream(path)
            if (written != json.loads(json.dumps(rec))
                    or rec["device"] != "cuda"
                    or counts["dequant_bag_by_dtype"]["tiered"] <= 0
                    or counts["quantize_rowwise"] <= 0):
                raise SystemExit(f"{label}: unexpected record or launches "
                                 f"{counts}")
            keys = ("hbm_budget_fraction", "p50_us", "p99_us",
                    "p99_while_retiering", "steady_qps", "hier_miss_rate",
                    "cache_hit_rate", "warm_hits", "cold_hits",
                    "staged_rows", "migrations", "promoted", "demoted",
                    "swaps", "hot_rows", "warm_rows", "cold_rows")
            print(json.dumps({"bench_hier": {
                "path": label, "wall_s": wall,
                "retier_async": rec["retier_async"],
                "full_store_bytes": rec["full_store_bytes"],
                "sweep": [{k: e[k] for k in keys} for e in rec["sweep"]],
                "launches": counts}}), flush=True)
            cols = [(e["hbm_budget_fraction"], e["hier_miss_rate"],
                     round(e["p50_us"], 1)) for e in rec["sweep"]]
            log(f"{label}: a valid bench_hier/v1 record in {wall:.1f}s, "
                f"{cols} (fraction, miss rate, p50 us), launches {counts}")
    return by_path


class FleetProbe:
    """Phase 18: what a fleet run's hooks and spies see.  ``after_batch``
    (``launch.fleet.run``'s hook, outside each micro-batch's window) keeps
    every served micro-batch since the last merge and holds one
    micro-batch of each replica (one that did not re-tier) to the plain
    ``lookup`` of the pack that served it, bit for bit; the spies record
    the merge base and the micro-batches each merge pooled, each pulse's
    seconds, and the quantizer's launches inside each server's start (its
    pack and, async, the prewarm) and each synchronous re-tier."""

    def __init__(self, torch, counters):
        from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
        from repro_torch.serve import fleet as fleet_mod
        from repro_torch.serve.online import OnlineServer

        self.torch = torch
        self.rq = rq_kernel
        self.audited_counters = [c for c in counters
                                 if c is not rq_kernel.launches]
        self.pending, self.merges = [], []
        self.audited, self.pulses = set(), []
        self.init_rq, self.retier_rq = [], []
        probe = self
        self._saved = [(fleet_mod.Fleet, "merge_priorities"),
                       (fleet_mod.Fleet, "_pulse"),
                       (OnlineServer, "__init__"), (OnlineServer, "retier")]
        self._orig = [getattr(c, n) for c, n in self._saved]
        merge, pulse, init, retier = self._orig

        def merge_spy(fleet):
            probe.merges = probe.merges[-1:] + [(fleet._merge_base,
                                                  probe.pending)]
            probe.pending = []
            return merge(fleet)

        def pulse_spy(fleet):
            t0 = time.perf_counter()
            pulse(fleet)
            probe.pulses.append(time.perf_counter() - t0)

        def init_spy(server, *a, **kw):
            n0 = probe.rq.total_launches()
            init(server, *a, **kw)
            probe.init_rq.append(probe.rq.total_launches() - n0)

        def retier_spy(server):
            n0 = probe.rq.total_launches()
            out = retier(server)
            probe.retier_rq.append(probe.rq.total_launches() - n0)
            return out

        for (cls, name), spy in zip(self._saved, (merge_spy, pulse_spy,
                                                  init_spy, retier_spy)):
            setattr(cls, name, spy)

    def close(self) -> None:
        for (cls, name), orig in zip(self._saved, self._orig):
            setattr(cls, name, orig)

    def after_batch(self, rep, mb, served) -> None:
        from repro_torch.core import packed_store as ps
        self.pending.append((rep.rid, mb))
        if rep.rid in self.audited or rep._retiered[-1]:
            return
        with Uncounted(self.audited_counters), self.torch.inference_mode():
            plain = ps.lookup(served["packed"], served["gidx"])
            self.torch.cuda.synchronize()
        if not bits_equal(served["emb"], plain):
            raise SystemExit(f"fleet replica {rep.rid}: the served "
                             "embeddings are not the plain lookup of its "
                             "pack")
        self.audited.add(rep.rid)

    def merge_oracle(self, merge, offsets):
        """A merge recomputed with numpy: the pooled counts of the
        micro-batches it pooled (float64 ``np.add.at``, as the reference
        counts), then the eager fp32 fold of its base, each op rounded on
        its own, subnormals flushed.  Returns (the merged vector, the
        micro-batches pooled)."""
        import numpy as np

        from repro_torch.core.priority import PriorityConfig
        base, batches = merge
        w = base.cpu().numpy()
        counts = np.zeros(w.shape[0], np.float64)
        for _, mb in batches:
            g = mb.indices.astype(np.int64) + offsets[None, :]
            np.add.at(counts, g[mb.valid].reshape(-1), 1.0)
        cfg = PriorityConfig()
        out = (np.float32(1.0 - cfg.beta) * w
               + np.float32(cfg.beta) * counts.astype(np.float32))
        out[np.abs(out) < np.finfo(np.float32).tiny] = 0.0
        return out, len(batches)


def fleet_entry(torch, probe, label: str, n: int, fleet, res, arch: str,
                stats: dict) -> None:
    """Phase 18 (a), (b): one replica count's checks, before its fleet is
    released: every replica's priority after the final merge equals the
    others' and the numpy oracle of that merge bit for bit, and the
    oracle of the merge before it equals the final merge's base (so a
    merge that pooled served micro-batches is checked even when the final
    one pools none); each replica was audited once, and its int8 rows and
    scales equal the plain quantizer's on the table rows they hold.  Adds
    the entry's figures to ``stats``."""
    import numpy as np

    from repro_torch import configs

    reps = fleet.replicas
    offsets = np.asarray(configs.get(arch).model.spec.offsets(), np.int64)
    (prev, final) = probe.merges
    oracle, pooled_final = probe.merge_oracle(final, offsets)
    oracle_prev, pooled = probe.merge_oracle(prev, offsets)
    first = reps[0].server.store.priority
    if (probe.pending or not pooled
            or not all(torch.equal(r.server.store.priority, first)
                       for r in reps)
            or not bits_equal(first.cpu(), torch.from_numpy(oracle))
            or not bits_equal(final[0].cpu(), torch.from_numpy(oracle_prev))):
        raise SystemExit(f"{label} replicas={n}: the merged priorities are "
                         "not equal to each other and the numpy oracle "
                         f"({pooled} and {pooled_final} micro-batches "
                         "pooled)")
    if probe.audited != set(range(n)):
        raise SystemExit(f"{label} replicas={n}: audited {probe.audited}")
    int8_rows = [check_int8_tier(torch, r.server, f"{label}[{r.rid}]")
                 for r in reps]
    merge_h = fleet.reg.histograms["fleet.merge_us"]
    agg = fleet.aggregate()
    spans = {name: agg.percentiles(f"serve.{name}_us", (50,))[0]
             for name in ("request", "synth", "lookup", "combine", "retier")}
    e = res.as_dict()
    entry = {
        "replicas": n, "aggregate_qps": e["aggregate_qps"],
        "per_replica_qps": e["per_replica_qps"], "p50_us": e["p50_us"],
        "p99_us": e["p99_us"], "route_p50_us": e["route_p50_us"],
        "router_overhead_frac": e["router_overhead_frac"],
        "merge_p50_us": merge_h.percentile(50), "merges": res.merges,
        "span_p50_us": spans,
        "pulse_ms_mean": 1e3 * sum(probe.pulses) / len(probe.pulses),
        "pulse_ms_max": 1e3 * max(probe.pulses), "pulses": len(probe.pulses),
        "divergence_premerge": res.divergence_premerge,
        "divergence": res.divergence,
        "batches": sum(len(r._lat) for r in reps),
        "retiers": sum(r.server.stats.retiers for r in reps),
        "rows_moved": sum(r.server.stats.rows_moved for r in reps),
        "cache_builds": sum(1 + r.server.stats.retiers for r in reps),
        "oracle_pooled_batches": [pooled, pooled_final],
        "int8_rows_checked": int8_rows,
        "device_allocated_bytes": torch.cuda.memory_allocated(),
        "device_peak_bytes": torch.cuda.max_memory_allocated()}
    stats["entries"].append(entry)
    probe.audited, probe.pulses, probe.merges = set(), [], []
    log(f"{label} replicas={n}: aggregate {e['aggregate_qps']} qps "
        f"(per replica {e['per_replica_qps']}), fleet p50 {e['p50_us']} us "
        f"p99 {e['p99_us']} us (spans' p50 us: "
        f"{ {k: round(v) for k, v in spans.items()} }), route p50 "
        f"{e['route_p50_us']} us, fleet.merge p50 "
        f"{entry['merge_p50_us']:.0f} us x {res.merges}, a "
        f"pulse {entry['pulse_ms_mean']:.2f} ms (max "
        f"{entry['pulse_ms_max']:.2f}), {entry['retiers']} re-tiers moved "
        f"{entry['rows_moved']:,} rows, divergence "
        f"{res.divergence_premerge:.4f} -> {res.divergence:.4f}, merged "
        f"priorities bit-equal to the numpy oracle of the last two merges "
        f"({pooled} and {pooled_final} micro-batches pooled), device {entry['device_allocated_bytes'] / 1e9:.2f} "
        f"GB with the fleet live, peak "
        f"{entry['device_peak_bytes'] / 1e9:.2f} GB")


def check_fleet_launches(label: str, counts: dict, bad: bool,
                         want: str) -> None:
    """Phase 18: stop the run when a fleet path's launches (``counts``)
    are not what its micro-batches, cache builds and quantizer calls
    (``want``) say."""
    if bad:
        raise SystemExit(f"{label}: launches {counts} against {want}")


def fleet_sync(torch, kernels_mod, counters, label: str, arch: str,
               replicas: str, tmp: str) -> dict:
    """Phase 18 (a), (b): ``launch.fleet --arch ARCH --model full
    --replicas REPLICAS`` at the reference CLI's other defaults, with
    ``--metrics-out`` and ``--emit`` into ``tmp``, through ``run`` with
    the probe's hooks, the counts set to 0 just before and read just
    after.  Returns the path's counts."""
    from repro_torch import obs
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.launch import fleet as fleet_cli

    mdir = os.path.join(tmp, f"{label}_metrics")
    emit = os.path.join(tmp, f"{label}_BENCH_fleet.json")
    args = fleet_cli.parse_args(
        ["--arch", arch, "--model", "full", "--replicas", replicas,
         "--metrics-out", mdir, "--emit", emit])
    stats = {"entries": []}
    probe = FleetProbe(torch, counters)
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    try:
        rec = fleet_cli.run(
            args, after_batch=probe.after_batch,
            on_entry=lambda n, fleet, res: fleet_entry(
                torch, probe, label, n, fleet, res, arch, stats))
    finally:
        probe.close()
    wall = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    batches = sum(e["batches"] for e in stats["entries"])
    builds = sum(e["cache_builds"] for e in stats["entries"])
    dq = counts["dequant_bag_by_dtype"]
    cin = 3 * batches if arch == "xdeepfm" else 0
    rq_want = sum(probe.init_rq) + sum(probe.retier_rq)
    n_servers = sum(args.replica_counts)
    check_fleet_launches(
        label, counts, dq["tiered"] != batches + builds
        or any(n for t, n in dq.items() if t != "tiered")
        or counts["cin"] != cin or counts["bag_matmul"]
        or counts["hashed_gather"] or counts["bag_grad"]
        or counts["dequant_bag_rowgrid"] or counts["bag_grad_rowgrid"]
        or len(probe.init_rq) != n_servers
        or min(probe.init_rq) < 1 or len(set(probe.init_rq)) != 1
        or counts["quantize_rowwise"] != rq_want
        or (sum(e["rows_moved"] for e in stats["entries"])
            and not sum(probe.retier_rq)),
        f"{batches} micro-batches + {builds} cache builds, cin {cin}, "
        f"quantize_rowwise {rq_want} (starts {probe.init_rq}, re-tiers "
        f"{probe.retier_rq})")
    # the record and every stream validate; each count's per-source
    # streams re-merge to its fleet stream's line
    paths = [emit] + sorted(os.path.join(mdir, f) for f in os.listdir(mdir))
    recs = check_files(paths)
    if recs[emit][0] != json.loads(json.dumps(rec)):
        raise SystemExit(f"{label}: the emitted record is not the returned "
                         "one")
    for n in args.replica_counts:
        srcs = [recs[os.path.join(mdir, f"replicas{n}_replica{i}.jsonl")][-1]
                for i in range(n)]
        srcs.append(recs[os.path.join(mdir, f"replicas{n}_router.jsonl")][-1])
        fleet_line = recs[os.path.join(mdir, f"replicas{n}_fleet.jsonl")][-1]
        if obs.merge_snapshots(srcs) != fleet_line:
            raise SystemExit(f"{label} replicas={n}: the per-source streams "
                             "do not re-merge to the fleet stream")
    print(json.dumps({"fleet": {
        "path": label, "arch": arch, "wall_s": wall,
        "record": rec, "entries": stats["entries"],
        "server_start_quantize_launches": probe.init_rq[0],
        "retier_quantize_launches": sum(probe.retier_rq),
        "launches": counts}}), flush=True)
    log(f"{label}: a valid bench_fleet/v1 record and {len(paths) - 1} valid "
        f"streams in {wall:.1f}s; {batches} micro-batches, {builds} cache "
        f"builds, launches {counts}")
    return counts


def fleet_async(torch, kernels_mod, counters) -> dict:
    """Phase 18 (c): the library's ``Fleet`` and ``Replica`` driven
    directly, wide&deep at full width, ``OnlineConfig(retier_async=True,
    shadow_rows_per_step=SHADOW_ROWS, verify_swap=True)``, the launcher's
    forward (``serve.loop.microbatch_serve_fn``) and cadences (a merge and
    a staggered re-tier every 64), ``FLEET_ASYNC_REQUESTS`` requests at 1,
    2 and 4 replicas, the counts set to 0 just before each and read just
    after.  Swaps must land on request ticks (before the final drain),
    each verified; the shadow spans must be in the replicas' registries
    and none in the default one.  Returns each count's counts."""
    import numpy as np

    from repro_torch import configs, obs
    from repro_torch.core.qat_store import CHUNK_ROWS
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.launch.serve import online_store
    from repro_torch.serve import (Fleet, FleetConfig, OnlineConfig,
                                   OnlineServer, Replica,
                                   drifting_zipf_batch)
    from repro_torch.serve.loop import microbatch_serve_fn

    dev = torch.device("cuda")
    model = configs.get("wide-deep").model
    spec = model.spec
    params, store, cfg = online_store(model, spec, dev)
    cards = np.asarray(spec.cardinalities, np.int64)
    offsets = np.asarray(spec.offsets(), np.int64)
    blocks = -(-spec.total_rows // CHUNK_ROWS)
    by_path = {}
    probe = FleetProbe(torch, counters)
    try:
        for n in FLEET_ASYNC_REPLICAS:
            label = f"fleet_async_wide-deep_{n}"
            probe.init_rq, probe.pulses = [], []
            kernels_mod.reset_launches()
            t0 = time.perf_counter()
            reps = []
            for i in range(n):
                server = OnlineServer(store, cfg, OnlineConfig(
                    cache_rows=128, retier_every=0, retier_async=True,
                    shadow_rows_per_step=SHADOW_ROWS, verify_swap=True))
                reps.append(Replica(
                    i, server, microbatch_serve_fn(server, model, spec,
                                                   params),
                    8, spec.num_fields,
                    globalize=lambda idx: idx.astype(np.int64)
                    + offsets[None, :]))
            fleet = Fleet(reps, FleetConfig(serve_batch=8, merge_every=64,
                                            retier_every=64))
            for r in range(FLEET_ASYNC_REQUESTS):
                fleet.submit(drifting_zipf_batch(
                    cards, 1, r, FLEET_ASYNC_REQUESTS, drift=4.0)[0])
            on_ticks = [rep.server.stats.swaps for rep in reps]
            fleet.flush()
            fleet.merge_priorities()
            res = fleet.result()
            wall = time.perf_counter() - t0
            counts = path_counts(kernels_mod, kernel, hg_kernel)
            st = [rep.server.stats for rep in reps]
            batches = sum(len(rep._lat) for rep in reps)
            builds = sum(1 + s.retiers for s in st)
            rq_want = (sum(probe.init_rq) + sum(s.shadow_chunks for s in st)
                       + blocks * sum(s.swaps for s in st))
            dq = counts["dequant_bag_by_dtype"]
            shadow_h = [{k: h.count for k, h in rep.reg.histograms.items()
                         if k.startswith("serve.shadow.")} for rep in reps]
            default = obs.get_registry()
            check_fleet_launches(
                label, counts, dq["tiered"] != batches + builds
                or any(c for t, c in dq.items() if t != "tiered")
                or counts["quantize_rowwise"] != rq_want
                or counts["cin"] or counts["bag_matmul"],
                f"{batches} micro-batches + {builds} cache builds, "
                f"quantize_rowwise {rq_want}")
            if (sum(on_ticks) < 1 or any(s.shadow is not None for s in
                                         (rep.server for rep in reps))
                    or any(h.get("serve.shadow.verify_us", 0)
                           != h.get("serve.shadow.swap_us", 0)
                           or h.get("serve.shadow.build_us", 0) != s.swaps
                           for h, s in zip(shadow_h, st))
                    or not any(h.get("serve.shadow.stage_us", 0)
                               for h in shadow_h)
                    or any(k.startswith("serve.shadow.")
                           for k in list(default.histograms)
                           + list(default.counters))):
                raise SystemExit(
                    f"{label}: swaps on request ticks {on_ticks}, stats "
                    f"{[s.as_dict() for s in st]}, shadow histograms "
                    f"{shadow_h}")
            e = res.as_dict()
            summary = {
                "path": label, "replicas": n, "wall_s": wall,
                "requests": FLEET_ASYNC_REQUESTS,
                "result": e, "swaps_on_request_ticks": on_ticks,
                "swaps": [s.swaps for s in st],
                "builds": [s.shadow_builds for s in st],
                "chunks": [s.shadow_chunks for s in st],
                "rows_moved": [s.rows_moved for s in st],
                "shadow_histograms": shadow_h,
                "merge_p50_us": fleet.reg.histograms[
                    "fleet.merge_us"].percentile(50),
                "pulse_ms_mean": 1e3 * sum(probe.pulses) / len(probe.pulses),
                "device_peak_bytes": torch.cuda.max_memory_allocated(),
                "launches": counts}
            print(json.dumps({"fleet_async": summary}), flush=True)
            log(f"{label}: {FLEET_ASYNC_REQUESTS} requests, aggregate "
                f"{e['aggregate_qps']} qps (per replica "
                f"{e['per_replica_qps']}), p50 {e['p50_us']} us p99 "
                f"{e['p99_us']} us, route p50 {e['route_p50_us']} us, "
                f"swaps {summary['swaps']} ({on_ticks} on request ticks, "
                f"each verified), swaps_colocated {res.swaps_colocated}, "
                f"rows moved {sum(summary['rows_moved']):,}, merge p50 "
                f"{summary['merge_p50_us']:.0f} us, a pulse "
                f"{summary['pulse_ms_mean']:.2f} ms, {wall:.1f}s")
            by_path[label] = counts
            del fleet, reps, server
            torch.cuda.empty_cache()
    finally:
        probe.close()
    return by_path


def fleet_reference_record(torch, kernels_mod, tmp: str) -> dict:
    """Phase 18 (d): ``python -m repro_torch.launch.fleet --emit
    TMP/BENCH_fleet.json`` through its ``main`` (the reference record's
    configuration: smoke dlrm-rm2, 1, 2, 4 and 8 replicas, 256 requests)
    on the card, through the schema tool; the counts set to 0 just
    before and read just after."""
    from repro_torch.kernels.dequant_bag import kernel
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.launch import fleet as fleet_cli

    path = os.path.join(tmp, "BENCH_fleet.json")
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    rec = fleet_cli.main(["--emit", path])
    wall = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    written = check_files([path])[path][0]
    if (written != json.loads(json.dumps(rec))
            or counts["dequant_bag_by_dtype"]["tiered"] <= 0
            or counts["quantize_rowwise"] <= 0):
        raise SystemExit(f"fleet_smoke: unexpected record or launches "
                         f"{counts}")
    keys = ("replicas", "aggregate_qps", "per_replica_qps", "p50_us",
            "p99_us", "route_p50_us", "router_overhead_frac", "merges",
            "divergence_premerge", "divergence", "swaps_colocated")
    print(json.dumps({"fleet_smoke": {
        "wall_s": wall, "sweep": [{k: e[k] for k in keys}
                                  for e in rec["sweep"]],
        "launches": counts}}), flush=True)
    log(f"fleet_smoke: a valid bench_fleet/v1 record in {wall:.1f}s, "
        f"{[(e['replicas'], e['aggregate_qps'], e['p50_us']) for e in rec['sweep']]}"
        f" (replicas, aggregate qps, p50 us), launches {counts}")
    return counts


def check_window_cases(torch, ops, ref, cases) -> float:
    """Phase 2: the tiered entry's shard window on ``cases.window_cases``
    (stores cut 2, 3 and 4 ways at the reference's stride, a one-row last
    shard and empty windows, an empty int8 tier, int32 and int64 ids, K 1 /
    8 / 40, NaN and inf weights on slots outside the window): each shard's
    windowed launch against the windowed plain version (the reference's
    per-shard composition through the plain bag) and through three
    single-tier launches, bit for bit (NaN bags alike)."""
    from repro_torch.core.packed_store import PackedStore
    from repro_torch.dist import make_mesh
    from repro_torch.dist import packed as dp

    worst, launches = 0.0, 0
    for c in cases.window_cases(torch.device("cuda")):
        packed = PackedStore(*c.leaves)
        sp = dp.shard_packed(packed, make_mesh(c.shards))
        for shard, firsts in zip(sp.shards, sp.firsts):
            got = ops.packed_bag_lookup(shard, c.ids, c.weights,
                                        firsts=firsts)
            plain = ops.packed_bag_lookup_tiers(
                shard, c.ids, c.weights, bag=ref.dequant_bag_ref,
                firsts=firsts)
            composed = ops.packed_bag_lookup_tiers(shard, c.ids, c.weights,
                                                   firsts=firsts)
            torch.cuda.synchronize()
            if not (scales_equal(got, plain) and scales_equal(got, composed)):
                raise SystemExit(f"dequant_bag[tiered] window != the "
                                 f"per-shard composition on case {c.name}, "
                                 f"shard window {firsts}")
            live = torch.isfinite(plain)
            if bool(live.any()):
                worst = max(worst, float((got[live] - plain[live]).abs()
                                         .max()))
            launches += 1
    log(f"kernel check: dequant_bag[tiered]'s shard window bit-equal to the "
        f"plain and the three-launch per-shard composition on "
        f"{len(cases.WINDOW_CASE_NAMES)} window cases ({launches} shard "
        f"launches; max abs err {worst})")
    return worst


def digest(torch, t) -> int:
    """A 64-bit fingerprint of every bit of ``t``: each 32-bit word times a
    weight of its row and column, summed mod 2^64 on the card in 2M-row
    blocks.  Equal tensors give equal digests; a flipped bit changes it."""
    rows = t.shape[0]
    words = t.reshape(rows, -1).view(torch.int32)
    colw = torch.arange(words.shape[1], device=t.device,
                        dtype=torch.int64) * 7919 + 1
    acc = torch.zeros((), dtype=torch.int64, device=t.device)
    for r0 in range(0, rows, 1 << 21):
        r1 = min(rows, r0 + (1 << 21))
        roww = torch.arange(r0, r1, device=t.device,
                            dtype=torch.int64) * 1000003 + 12345
        acc += ((words[r0:r1].to(torch.int64) * roww[:, None])
                * colw[None, :]).sum()
    return int(acc)


def state_digests(torch, state) -> dict:
    """Phase 5 and 19(d): digests of the row-aligned training state after a
    step (the table, the adagrad accumulator, the priority, the access
    EMA), a placed leaf's gathered whole."""
    from repro_torch.dist.packed import whole
    return {"table": digest(torch, whole(state.params["embed_table"])),
            "adagrad": digest(torch, whole(state.opt[1])),
            "priority": digest(torch, whole(state.priority)),
            "access": digest(torch, whole(state.accum.access))}


def mesh_dlrm(torch, serve, served, kernels_mod, kernel, hg_kernel, ops,
              flush) -> tuple:
    """Phase 19(a): the full-width dlrm-rm2 pack (204,185,088 x 64) sharded
    with no copy at meshes 1, 2 and 4 (row views; ``indirect`` held once)
    and 16 requests of batch 512 served through ``sharded_lookup`` at each
    (``launch.serve``'s timed loop), the counts set to 0 just before and
    read just after: the tiered entry N times a request, nothing else.
    Then, outside the counts: every request's embeddings against the
    plain ``lookup`` bit for bit, its logits within 1e-4 * max(1, |ref|)
    of mesh 1's; the device memory allocated beside mesh 1's; a training
    batch's 65,536 x 26 uniform ids through ``sharded_lookup`` at mesh 4
    against the plain ``lookup`` with slots in every tier and shard; one
    windowed launch, a sharded lookup and the shard sum timed (CUDA
    events).  Returns (summary, counts by path, the tiered entry's mesh
    timings)."""
    import numpy as np

    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.core import packed_store as ps
    from repro_torch.core.packed_store import _IDX_MASK, _TIER_SHIFT
    from repro_torch.dist import make_mesh, psum
    from repro_torch.dist import packed as dp
    from repro_torch.models.embedding import globalize

    dev = torch.device("cuda")
    packed, model, params = served.packed, served.model, served.params
    make = served.make_request
    summary, by_path, timing, ref_logits, alloc = {}, {}, {}, None, {}
    for n in MESHES:
        mesh = make_mesh(n)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        sp = dp.shard_packed(packed, mesh)
        torch.cuda.synchronize()
        alloc[n] = torch.cuda.memory_allocated()
        kernels_mod.reset_launches()
        lat = serve.time_requests(model, params, sp, make, REQUESTS, dev)
        counts = path_counts(kernels_mod, kernel, hg_kernel)
        dq = counts["dequant_bag_by_dtype"]
        others = {k: v for k, v in counts.items()
                  if isinstance(v, int) and k != "dequant_bag" and v}
        if (dq["tiered"] != n * REQUESTS or others
                or any(v for t, v in dq.items() if t != "tiered")):
            raise SystemExit(f"mesh {n} dlrm-rm2: the tiered entry did not "
                             f"launch {n} times a request and nothing else: "
                             f"{counts}")
        by_path[f"mesh{n}_dlrm-rm2"] = counts
        logits = []
        with torch.inference_mode():
            for r in range(REQUESTS):
                batch = {k: v.to(dev) for k, v in make(r).items()}
                gidx = globalize(batch["indices"], model.spec)
                emb = dp.sharded_lookup(sp, gidx)
                if not bits_equal(emb, ps.lookup(packed, gidx)):
                    raise SystemExit(f"mesh {n} request {r}: embeddings != "
                                     "the plain lookup")
                logits.append(model.head(params, emb, batch))
        if ref_logits is None:
            ref_logits = logits
        worst = 0.0
        for a, b in zip(logits, ref_logits):
            diff = (a - b).abs()
            lim = 1e-4 * b.abs().clamp_min(1.0)
            if not bool((diff <= lim).all()):
                raise SystemExit(f"mesh {n}: logits off mesh 1's by "
                                 f"{float(diff.max())}")
            worst = max(worst, float(diff.max()))
        # one request's lookup: the N windowed launches, the sharded lookup
        # (launches and shard sum) and the shard sum alone
        batch = {k: v.to(dev) for k, v in make(0).items()}
        gidx = globalize(batch["indices"], model.spec)
        ids = gidx.reshape(-1, 1)
        window_ms = time_launches(torch, ops.packed_bag_lookup, [
            (sh, ids, None, f) for sh, f in zip(sp.shards, sp.firsts)]
            * (SHARD_SUM_ITERS // n), flush)
        lookup_ms = time_launches(torch, dp.sharded_lookup,
                                  [(sp, gidx)] * SHARD_SUM_ITERS, flush)
        parts = [ops.packed_bag_lookup(sh, ids, None, firsts=f)
                 for sh, f in zip(sp.shards, sp.firsts)]
        firsts = [p.clone() for p in parts[:1] * SHARD_SUM_ITERS]
        sum_ms = time_launches(torch, lambda p0: psum([p0, *parts[1:]],
                                                      mesh),
                               [(p,) for p in firsts], flush)
        del parts, firsts
        lat_us = np.asarray(lat[1:]) * 1e6
        summary[n] = {"p50_us": float(np.percentile(lat_us, 50)),
                      "p99_us": float(np.percentile(lat_us, 99)),
                      "launches_a_request": dq["tiered"] / REQUESTS,
                      "logits_max_abs_diff_vs_mesh1": worst,
                      "allocated_bytes": alloc[n],
                      "allocated_by_sharding_bytes": alloc[n] - before,
                      "window_launch_ms": window_ms,
                      "sharded_lookup_ms": lookup_ms,
                      "shard_sum_ms": sum_ms}
        timing[n] = {k: summary[n][k] for k in ("window_launch_ms",
                                                "sharded_lookup_ms",
                                                "shard_sum_ms")}
        if n == MESH_N:
            # a training batch's uniform ids: slots in every tier and shard
            m = RECSYS_SHAPES["train_batch"]["batch"]
            spec = model.spec
            gen = torch.Generator(device=dev).manual_seed(0)
            with torch.inference_mode():
                tids = torch.randint(0, 1 << 62, (m, spec.num_fields),
                                     generator=gen, device=dev) % torch.tensor(
                                         spec.cardinalities, device=dev)
                tg = globalize(tids, spec)
                emb = dp.sharded_lookup(sp, tg)
                plain = ps.lookup(packed, tg)
                code = packed.indirect[tg.to(torch.int64)].reshape(-1)
                tier = (code >> _TIER_SHIFT).to(torch.int64)
                stride = torch.tensor([dp.shard_stride(r, n)
                                       for r in sp.tier_rows], device=dev)
                shard = (code & _IDX_MASK).to(torch.int64) // stride[tier]
                cells = torch.bincount(tier * n + shard,
                                       minlength=3 * n).tolist()
            if not bits_equal(emb, plain) or min(cells) <= 0:
                raise SystemExit(f"mesh {n}: a training batch's lookup != "
                                 f"the plain one, or a (tier, shard) cell "
                                 f"has no slot: {cells}")
            summary[n]["train_batch_slots_by_tier_and_shard"] = cells
            del tids, tg, emb, plain, code, tier, shard
        del sp
        torch.cuda.empty_cache()
        log(f"mesh {n} dlrm-rm2: {REQUESTS} requests, p50 "
            f"{summary[n]['p50_us']:.0f} us p99 {summary[n]['p99_us']:.0f} "
            f"us, {n} tiered launches a request, embeddings bit-equal to the "
            f"plain lookup, logits within {worst:.3g} of mesh 1's; a "
            f"window launch {window_ms:.4f} ms, the sharded lookup "
            f"{lookup_ms:.4f} ms, the shard sum {sum_ms:.4f} ms; "
            f"{alloc[n] - before} bytes allocated by the sharding")
    if abs(alloc[MESH_N] - alloc[1]) > 8 << 20:
        raise SystemExit(f"mesh {MESH_N} allocates {alloc[MESH_N]} bytes, "
                         f"mesh 1 {alloc[1]}: the shards are not views")
    return summary, by_path, timing


def mesh_online(torch, serve, kernels_mod, kernel, hg_kernel, arch: str,
                n: int, ref_logits: list | None, ref_rec: dict | None
                ) -> tuple:
    """Phase 19(b): ``launch.serve --online --fuse-matmul --model full
    --mesh n`` (phase 8's arguments), the counts set to 0 just before and
    read just after: bag_matmul 3 x n times a request, cin 3 times a
    request on xDeepFM, the tiered entry n times a packed lookup (each
    cache build, and each request on xDeepFM), no single-tier launch.
    Each request's fused logits within 1e-4 * max(1, |ref|) of
    ``ref_logits`` (mesh 1's, phase 8); the re-tiers and rows moved
    those of ``ref_rec``; after the run the cache's rows equal the plain
    ``lookup`` of the live pack bit for bit.  Returns (record, counts,
    logits)."""
    from repro_torch import configs
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.core import packed_store as ps
    from repro_torch.dist.packed import ShardedPack

    argv = ["--arch", arch, "--online", "--fuse-matmul", "--model", "full",
            "--batch", str(RECSYS_SHAPES["serve_p99"]["batch"]),
            "--requests", str(REQUESTS), "--retier-every", "2",
            "--cache-rows", "256", "--drift", "4.0", "--mesh", str(n)]
    logits, worst = [], {"abs": 0.0}

    def make_audit(server, model, params):
        def audit(r, idx):
            def after(out, emb):
                if out.shape != (idx.shape[0],) or not bool(
                        torch.isfinite(out).all()):
                    raise SystemExit(f"mesh {n} {arch} request {r}: bad "
                                     f"logits {tuple(out.shape)}")
                got = out.cpu()
                if ref_logits is not None:
                    ref = ref_logits[r]
                    diff = (got - ref).abs()
                    if not bool((diff <= 1e-4 * ref.abs().clamp_min(1.0))
                                .all()):
                        raise SystemExit(f"mesh {n} {arch} request {r}: "
                                         f"logits off mesh 1's by "
                                         f"{float(diff.max())}")
                    worst["abs"] = max(worst["abs"], float(diff.max()))
                logits.append(got)
            return after
        return audit

    kernels_mod.reset_launches()
    served = serve.run(serve.parse_args(argv), make_audit=make_audit)
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    rec, server = served.record, served.server
    layers = len(getattr(configs.get(arch).cfg, "cin_layers", ()))
    lookups = (REQUESTS if arch == "xdeepfm" else 0) + 1 + server.stats.retiers
    dq = counts["dequant_bag_by_dtype"]
    if (counts["bag_matmul"] != 3 * n * REQUESTS
            or counts["cin"] != layers * REQUESTS
            or dq["tiered"] != n * lookups
            or any(v for t, v in dq.items() if t != "tiered")
            or rec["mesh"] != n or len(logits) != REQUESTS
            or (n > 1) != isinstance(server.packed, ShardedPack)):
        raise SystemExit(f"mesh {n} {arch}: launches {counts}, record "
                         f"{rec['kernel_launches']}, {lookups} lookups")
    if ref_rec is not None and (rec["retiers"], rec["rows_moved"]) != (
            ref_rec["retiers"], ref_rec["rows_moved"]):
        raise SystemExit(f"mesh {n} {arch}: re-tiers {rec['retiers']} moved "
                         f"{rec['rows_moved']}, mesh 1 {ref_rec['retiers']} / "
                         f"{ref_rec['rows_moved']}")
    cache = server.cache
    with torch.inference_mode():
        plain = ps.lookup(server.host_packed, cache.ids)
    if not bits_equal(cache.rows[:cache.capacity], plain):
        raise SystemExit(f"mesh {n} {arch}: the cache's rows != the plain "
                         "lookup of the live pack")
    summary = {k: rec[k] for k in ("p50_us", "p99_us", "steady_qps",
                                   "retiers", "rows_moved", "hits",
                                   "lookups", "build_s")}
    summary.update({"arch": arch, "mesh": n, "path_launches": counts,
                    "logits_max_abs_diff_vs_mesh1": worst["abs"]})
    print(json.dumps({"mesh_online": summary}), flush=True)
    log(f"mesh {n} {arch} online: p50 {rec['p50_us']:.0f} us p99 "
        f"{rec['p99_us']:.0f} us, {rec['retiers']} re-tiers moved "
        f"{rec['rows_moved']:,} rows under the mesh, bag_matmul "
        f"{counts['bag_matmul']} and tiered {dq['tiered']} launches, logits "
        f"within {worst['abs']:.3g} of mesh 1's, cache rows bit-equal to the "
        f"plain lookup")
    del served, server
    return rec, counts, logits


def mesh_hashed(torch, serve, kernels_mod, kernel, hg_kernel) -> tuple:
    """Phase 19(c): the hashed wide&deep store at full width (22,216,192 x
    32 fitted at ratio 100) with ``--mesh 4``, the counts set to 0 just
    before and read just after: the plan entry 4 times a request (the
    sharded request path), the ids entry at the fit and the cache
    builds.  Then 1,048,576 uniform ids through the sharded gather
    against the unsharded one: within 1e-6 * max(1, |ref|) (the shard
    partials round on their own; with two draws a chunk they keep the
    bits, which the summary reports).  Returns (summary, counts)."""
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.store import hashed as H

    argv = ["--arch", "wide-deep", "--online", "--store-backend", "hashed",
            "--model", "full", "--batch",
            str(RECSYS_SHAPES["serve_p99"]["batch"]), "--requests",
            str(REQUESTS), "--retier-every", "2", "--cache-rows", "256",
            "--drift", "4.0", "--mesh", str(MESH_N)]
    kernels_mod.reset_launches()
    served = serve.run(serve.parse_args(argv))
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    rec, backend = served.record, served.server.backend
    by_entry = counts["hashed_gather_by_entry"]
    in_loop = rec["kernel_launches"]["hashed_gather"]
    if (by_entry["float32"] != MESH_N * REQUESTS
            or in_loop != MESH_N * REQUESTS + rec["retiers"]
            or by_entry["int8"] or by_entry["ids_int8"]):
        raise SystemExit(f"mesh hashed: launches {counts}, in the loop "
                         f"{in_loop}, {rec['retiers']} re-tiers")
    dev = backend.device
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        ids = torch.randint(0, backend.vocab, (1 << 20,), generator=gen,
                            device=dev)
        got = backend.lookup_fn()(backend.packed, ids)
        ref = H.hashed_lookup(backend.hs, backend.hcfg, ids)
        diff = (got - ref).abs()
        ok = bool((diff <= 1e-6 * ref.abs().clamp_min(1.0)).all())
        same = bits_equal(got, ref)
    if not ok:
        raise SystemExit(f"mesh hashed: sharded rows off the unsharded ones "
                         f"by {float(diff.max())}")
    summary = {k: rec[k] for k in ("p50_us", "p99_us", "retiers", "hits",
                                   "pool_slots", "fit_s")}
    summary.update({"mesh": MESH_N, "rows_checked": int(ids.numel()),
                    "max_abs_diff_vs_mesh1": float(diff.max()),
                    "bit_equal_to_mesh1": same, "path_launches": counts})
    print(json.dumps({"mesh_hashed": summary}), flush=True)
    log(f"mesh {MESH_N} hashed wide&deep: p50 {rec['p50_us']:.0f} us, the "
        f"plan entry {by_entry['float32']} times ({MESH_N} a request), "
        f"{ids.numel():,} rows within {float(diff.max()):.3g} of the "
        f"unsharded gather (bit-equal: {same})")
    del served, backend, got, ref, diff
    return summary, counts


def train_mesh(torch, kernel, setup_mod, arch, n: int) -> dict:
    """Phase 19(d): the compressed train step at the train cell
    (124,185,088 rows, batch 65,536) over an n-shard mesh for
    ``MESH_TRAIN_STEPS`` steps from phase 5's seed, the counts set to 0
    just before and read just after (the forward and bag_grad n times a
    step); after each step, outside its window, the state's digests."""
    import numpy as np

    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.dist import make_mesh

    dev = torch.device("cuda")
    batch = RECSYS_SHAPES["train_batch"]["batch"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = setup_mod.build_recsys_training(
        arch, batch=batch, device=dev, model="full",
        max_ind_range=MAX_IND_RANGE, mesh=None if n == 1 else make_mesh(n))
    batches = [tr.batch_fn(s) for s in range(MESH_TRAIN_STEPS)]
    state = tr.state
    losses, step_ms, digests = [], [], []
    kernel.reset_launches()
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = tr.step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches = {"dequant_bag": kernel.launches["float32"],
                    "bag_grad": kernel.bag_grad_launches["float32"]}
        losses.append(float(m["loss"]))
        digests.append(state_digests(torch, state))
    peak = torch.cuda.max_memory_allocated()
    want = n * MESH_TRAIN_STEPS
    if (launches != {"dequant_bag": want, "bag_grad": want}
            or kernel.total_launches() != want
            or not all(np.isfinite(losses))):
        raise SystemExit(f"mesh {n} train: launches {launches} (want {n} a "
                         f"step), losses {losses}")
    del tr, state, batches
    torch.cuda.empty_cache()
    return {"mesh": n, "losses": losses, "step_ms": step_ms,
            "digests": digests, "kernel_launches": launches,
            "max_memory_allocated_bytes": peak, "base_allocated_bytes": base}


def mesh_qps_sharded(torch, kernels_mod, kernel, hg_kernel, tmp: str
                     ) -> tuple:
    """Phase 19(f): ``python -m repro_torch.benchmarks.qps_sharded
    --emit-dir TMP`` (the reference record's configuration: smoke
    dlrm-rm2, meshes 1, 2, 4, serve batches 1 and 8, 48 requests) in
    process, the counts around it; each record through the unchanged
    schema tool in a subprocess."""
    from repro_torch.benchmarks import qps_sharded
    kernels_mod.reset_launches()
    recs = qps_sharded.main(["--emit-dir", tmp])
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    paths = [os.path.join(tmp, f"BENCH_qps_mesh{n}.json") for n in MESHES]
    check_files(paths)
    if (sorted(recs) != list(MESHES)
            or counts["dequant_bag_by_dtype"]["tiered"] <= 0
            or any(recs[n]["mesh"] != n for n in MESHES)):
        raise SystemExit(f"qps_sharded: records {sorted(recs)}, launches "
                         f"{counts}")
    summary = {n: [{k: e[k] for k in ("serve_batch", "p50_us", "p99_us",
                                      "steady_qps", "retiers")}
                   for e in recs[n]["sweep"]] for n in MESHES}
    print(json.dumps({"qps_sharded": summary}), flush=True)
    log(f"qps_sharded: {len(paths)} bench_qps/v1 records valid: {summary}")
    return summary, counts


def mesh_phase(torch, serve, pipeline, kernels_mod, kernel, hg_kernel,
               setup_mod, counters, online_refs: dict,
               train_ref: dict | None) -> tuple:
    """Phase 19 (b)-(f); (a) runs beside phase 4, on its live pack.
    ``online_refs`` holds phase 8's (logits, record) by arch and
    ``train_ref`` phase 5's digests; without them (``--mesh-only``) mesh 1
    runs here first.  Returns (summary, counts by path)."""
    from repro_torch import configs

    summary, by_path = {}, {}
    for arch in ONLINE_ARCHS:
        if arch not in online_refs:
            rec, _, logits = mesh_online(torch, serve, kernels_mod, kernel,
                                         hg_kernel, arch, 1, None, None)
            online_refs[arch] = (logits, rec)
            torch.cuda.empty_cache()
        ref_logits, ref_rec = online_refs[arch]
        rec, counts, _ = mesh_online(torch, serve, kernels_mod, kernel,
                                     hg_kernel, arch, MESH_N, ref_logits,
                                     ref_rec)
        by_path[f"mesh{MESH_N}_online_{arch}"] = counts
        summary[f"online_{arch}"] = {
            "mesh1": {k: ref_rec[k] for k in ("p50_us", "p99_us")},
            f"mesh{MESH_N}": {k: rec[k] for k in ("p50_us", "p99_us")},
            "bag_matmul_a_request": counts["bag_matmul"] / REQUESTS}
        torch.cuda.empty_cache()
    summary["hashed"], by_path[f"mesh{MESH_N}_hashed"] = mesh_hashed(
        torch, serve, kernels_mod, kernel, hg_kernel)
    torch.cuda.empty_cache()
    wd_mb = hier_budget_mb(torch, serve, "wide-deep", HIER_FRACTION)
    argv = ["--arch", "wide-deep", "--serve-batch", "8", "--cache-rows",
            "256", "--retier-every", "64", "--drift", "4.0",
            "--hbm-budget-mb", repr(wd_mb), "--host-budget-mb", repr(wd_mb),
            "--requests", str(HIER_REQUESTS), "--mesh", str(MESH_N)]
    with tempfile.TemporaryDirectory() as tmp:
        rec, counts, _, _ = hier_serve(
            torch, serve, kernels_mod, counters,
            f"mesh{MESH_N}_hier_wide-deep", argv, os.path.join(tmp, "cold"))
    by_path[f"mesh{MESH_N}_hier_wide-deep"] = counts
    # the card's budget holds all its shards: the hot level once
    if rec["level_bytes"]["hot"] > rec["hbm_budget_mb"] * 2 ** 20:
        raise SystemExit(f"mesh {MESH_N} hier: the hot level's "
                         f"{rec['level_bytes']['hot']:,} bytes exceed "
                         f"--hbm-budget-mb {rec['hbm_budget_mb']}")
    summary["hier_wide-deep"] = {k: rec[k] for k in (
        "p50_us", "p99_us", "level_rows", "level_bytes", "migrations",
        "verify_s")}
    torch.cuda.empty_cache()

    arch = configs.get("dlrm-rm2")
    if train_ref is None:
        train_ref = train_mesh(torch, kernel, setup_mod, arch, 1)
    got = train_mesh(torch, kernel, setup_mod, arch, MESH_N)
    for step, (a, b) in enumerate(zip(got["digests"], train_ref["digests"])):
        if a != b or got["losses"][step] != train_ref["losses"][step]:
            raise SystemExit(f"mesh {MESH_N} train step {step}: state "
                             f"digests {a} or loss {got['losses'][step]} != "
                             f"mesh 1's {b} / {train_ref['losses'][step]}")
    # the placed state holds no whole gradient and no second table: the
    # peaks above what each run found allocated within 1 GB
    peak_gap = ((got["max_memory_allocated_bytes"]
                 - got["base_allocated_bytes"])
                - (train_ref["max_memory_allocated_bytes"]
                   - train_ref["base_allocated_bytes"]))
    if abs(peak_gap) > 1e9:
        raise SystemExit(f"mesh {MESH_N} train: peak "
                         f"{got['max_memory_allocated_bytes']:,} bytes, "
                         f"{peak_gap:,} from mesh 1's (limit 1 GB)")
    by_path[f"mesh{MESH_N}_train"] = {
        "dequant_bag": got["kernel_launches"]["dequant_bag"],
        "bag_grad": got["kernel_launches"]["bag_grad"]}
    summary["train"] = {
        "mesh1": {"step_ms": train_ref["step_ms"][:MESH_TRAIN_STEPS],
                  "max_memory_allocated_bytes":
                  train_ref["max_memory_allocated_bytes"]},
        f"mesh{MESH_N}": {"step_ms": got["step_ms"],
                          "max_memory_allocated_bytes":
                          got["max_memory_allocated_bytes"]},
        "losses": got["losses"], "bit_equal_steps": len(got["digests"]),
        "peak_gap_bytes": peak_gap}
    log(f"mesh {MESH_N} train: {MESH_TRAIN_STEPS} steps at "
        f"{got['step_ms']} ms (mesh 1 {train_ref['step_ms'][:3]}), table, "
        f"adagrad, priority, access EMA and loss bit-equal to mesh 1's after "
        f"each step; peak {got['max_memory_allocated_bytes'] / 1e9:.2f} GB "
        f"(mesh 1 {train_ref['max_memory_allocated_bytes'] / 1e9:.2f} GB)")

    # (e): the pipeline at mesh 1, then at mesh 2 (every stage from the
    # placed state, the one-device case of the pipeline over cards), held
    # to mesh 1's record and final pack
    cut = ["--fast", "--max-ind-range", str(MESH_PIPELINE_ROWS)]
    one, by_path["mesh1_pipeline"] = pipeline_phase(
        torch, kernels_mod, kernel, pipeline, cut, "mesh1_pipeline")
    torch.cuda.empty_cache()
    for label, extra in (("mesh2_pipeline", []),
                         ("mesh2_pipeline_hashed",
                          ["--store-backend", "hashed"])):
        rec, counts = pipeline_phase(
            torch, kernels_mod, kernel, pipeline,
            ["--mesh", "2", *cut, *extra], label, mesh=2)
        by_path[label] = counts
        summary[label] = {k: rec[k] for k in ("rows", "train_loss_last",
                                              "eval_auc_packed",
                                              "stage_seconds")}
        if label == "mesh2_pipeline":
            differ = {k: (rec[k], one[k]) for k in MESH_PIPELINE_SAME
                      if rec[k] != one[k]}
            if differ:
                raise SystemExit(f"pipeline mesh 2 != mesh 1 on {differ}")
            summary[label]["equal_to_mesh1"] = list(MESH_PIPELINE_SAME)
            summary["mesh1_pipeline"] = {
                k: one[k] for k in ("rows", "stage_seconds",
                                    "final_pack_digest")}
            log(f"pipeline mesh 2: {len(MESH_PIPELINE_SAME)} record keys "
                f"and the final pack's digest {rec['final_pack_digest']} "
                f"equal to mesh 1's")
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        summary["qps_sharded"], by_path["qps_sharded"] = mesh_qps_sharded(
            torch, kernels_mod, kernel, hg_kernel, tmp)
    torch.cuda.empty_cache()
    return summary, by_path


def fleet_phase(torch, kernels_mod, counters) -> dict:
    """Phase 18: the serving fleet; returns each path's counts."""
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, arch, replicas in FLEET_SYNC:
            by_path[label] = fleet_sync(torch, kernels_mod, counters, label,
                                        arch, replicas, tmp)
            torch.cuda.empty_cache()
        by_path.update(fleet_async(torch, kernels_mod, counters))
        by_path["fleet_smoke"] = fleet_reference_record(torch, kernels_mod,
                                                        tmp)
    torch.cuda.empty_cache()
    return by_path


# ---- phase 20: the kernel record, bag_matmul_train, the smoke, examples --

def kernel_record(torch, kernels_mod, kernel, hg_kernel, tmp: str) -> tuple:
    """Phase 20 (a): ``python -m repro_torch.benchmarks.kernels --seed-cache
    --emit tmp/BENCH_kernel.json --shapes KERNEL_SHAPES`` through ``main``,
    the cache at ``tmp/autotune.json``; the record through the unchanged
    schema tool, measured <= analytic on every entry, the roofline's
    kernel table printed.  Returns (record, cache path, the run's
    launches)."""
    from repro_torch.benchmarks import kernels as bench_kernels
    from repro_torch.benchmarks import roofline
    from repro_torch.kernels import autotune

    cache = os.path.join(tmp, "autotune.json")
    path = os.path.join(tmp, "BENCH_kernel.json")
    autotune.set_cache_path(cache)
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    rec = bench_kernels.main(["--seed-cache", "--emit", path, "--shapes",
                              KERNEL_SHAPES])
    seconds = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    (written,) = check_stream(path)
    slow = [(e["kernel"], e["b"], e["measured_us"], e["analytic_us"])
            for e in rec["sweep"] if e["measured_us"] > e["analytic_us"]]
    with open(cache) as fh:
        entries = json.load(fh)["entries"]
    shapes = KERNEL_SHAPES.count(":") // 3
    if (written != json.loads(json.dumps(rec)) or slow or rec["interpret"]
            or rec["backend"] != torch.cuda.get_device_name(0)
            or len(rec["sweep"]) != 5 * shapes or len(entries) != 3 * shapes
            or counts["dequant_bag_rowgrid"] <= 0 or counts["bag_grad"] <= 0
            or counts["bag_matmul"] <= 0):
        raise SystemExit(f"kernel record: slow {slow}, {len(entries)} cache "
                         f"entries, launches {counts}")
    print(roofline.kernel_markdown(path), flush=True)
    print(json.dumps({"bench_kernel": rec}), flush=True)
    log(f"phase 20(a): bench_kernel/v1 valid, {len(rec['sweep'])} entries, "
        f"measured <= analytic on each, {len(entries)} cache entries, "
        f"{seconds:.1f}s")
    return rec, cache, counts


def check_tilings(torch, kernel, bm_kernel, hg_kernel, hg_ops) -> int:
    """Phase 20 (b): every candidate tiling of every swept shape (and of
    a wide&deep hashed request) gives the analytic pick's bits, and each
    kernel's analytic rule is its Python mirror.  Launches here are
    comparisons: no path counts them.  Returns the tilings checked."""
    from repro_torch.benchmarks.kernels import VOCAB, _case
    from repro_torch.kernels import autotune
    from repro_torch.kernels.dequant_bag import ref

    dev = torch.device("cuda")
    checked = 0

    def same(name, want, got, t):
        nonlocal checked
        if not bits_equal(got, want):
            raise SystemExit(f"{name}: tiling {t} differs from the analytic "
                             "pick's output")
        checked += 1

    for shape in KERNEL_SHAPES.split(","):
        b, k, d, h = (int(x) for x in shape.split(":"))
        payload, scales, idx, w, w3, g = _case(b, k, d, h, dev)
        picks = {"dequant_bag": (kernel.dequant_bag_analytic(b, k, d, dev),
                                 kernel.dequant_bag_analytic(b, k, d)),
                 "bag_grad": (kernel.bag_grad_analytic(d, device=dev),
                              kernel.bag_grad_analytic(d)),
                 "bag_matmul": (bm_kernel.bag_matmul_analytic(b, h, dev),
                                bm_kernel.bag_matmul_analytic(b, h))}
        for name, (card, mirror) in picks.items():
            if card != mirror:
                raise SystemExit(f"{name} {shape}: analytic {card} on the "
                                 f"card, {mirror} in its mirror")
        want = kernel.dequant_bag_cuda(payload, scales, idx, w)
        for t in autotune.candidate_tilings("dequant_bag",
                                            picks["dequant_bag"][0], dev,
                                            b=b, k=k, d=d):
            same(f"dequant_bag {shape}", want, kernel.dequant_bag_cuda(
                payload, scales, idx, w, tiling=t), t)
        coeff = ref.bag_grad_coeff(scales, idx, w).contiguous()
        plan = kernel.plan_slots(idx)
        want = kernel.bag_grad_cuda(g, idx, coeff, torch.zeros(
            (VOCAB, d), device=dev), plan=plan)
        for t in autotune.candidate_tilings("bag_grad", picks["bag_grad"][0],
                                            dev, d=d):
            same(f"bag_grad {shape}", want, kernel.bag_grad_cuda(
                g, idx, coeff, torch.zeros((VOCAB, d), device=dev),
                plan=plan, tiling=t), t)
        want = bm_kernel.bag_matmul_cuda(payload, scales, idx, w, w3)
        for t in autotune.candidate_tilings("bag_matmul",
                                            picks["bag_matmul"][0], dev,
                                            b=b, h=h):
            same(f"bag_matmul {shape}", want, bm_kernel.bag_matmul_cuda(
                payload, scales, idx, w, w3, tiling=t), t)
    # the hashed gather at a wide&deep request: 20,480 ids, C 4, NH 2,
    # Z 8, over an fp32 and an int8 pool, both entries
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    ids = torch.randint(0, 22_216_000, (20480, 1), generator=gen,
                        device=dev)
    for pool, sc in ((torch.randn((888_648, 8), generator=gen, device=dev),
                      None),
                     (torch.randint(-128, 128, (2_369_727, 8), generator=gen,
                                    device=dev, dtype=torch.int8),
                      torch.rand(2_369_727, generator=gen, device=dev))):
        an = hg_kernel.hashed_gather_analytic(4, 8, dev)
        if an != hg_kernel.hashed_gather_analytic(4, 8):
            raise SystemExit(f"hashed_gather analytic {an} off its mirror")
        want = hg_kernel.hashed_gather_ids_cuda(pool, sc, ids, None,
                                                num_chunks=4, num_hashes=2)
        slots, cf = hg_ops.slot_plan(ids, None, num_chunks=4, num_hashes=2,
                                     num_slots=pool.shape[0])
        for t in autotune.candidate_tilings("hashed_gather", an, dev,
                                            num_chunks=4, z=8):
            same("hashed_gather_ids", want, hg_kernel.hashed_gather_ids_cuda(
                pool, sc, ids, None, num_chunks=4, num_hashes=2, tiling=t),
                t)
            same("hashed_gather", want, hg_kernel.hashed_gather_cuda(
                pool, sc, slots, cf, num_chunks=4, tiling=t), t)
    log(f"phase 20(b): {checked} candidate tilings bit-equal to the "
        "analytic picks; the analytic mirrors equal the kernels' rules")
    return checked


def autotune_serve(torch, serve, kernels_mod, kernel, hg_kernel, counters,
                   cache: str, tmp: str, logits_before: list,
                   rec_before: dict) -> dict:
    """Phase 20 (c): phase 8's wide&deep online fused serve at published
    widths with ``--autotune-cache`` of (a): its logits bit-equal to phase
    8's (no cache), the cache read by the fused head's launches; its p50
    beside phase 8's; then the dlrm-rm2 offline serve's p50 with the cache
    file present and absent, in turns.  Returns each run's launches."""
    from repro_torch.kernels import autotune

    hits0 = autotune.hits.get("bag_matmul", 0)
    served, _, _ = serve_online(torch, serve, kernels_mod, counters,
                                "wide-deep", logits_before=logits_before,
                                autotune_cache=cache)
    by_path = {"autotune_online_wide-deep": path_counts(
        kernels_mod, kernel, hg_kernel)}
    hits = autotune.hits.get("bag_matmul", 0) - hits0
    rec = served.record
    del served
    torch.cuda.empty_cache()
    if hits <= 0:
        raise SystemExit("phase 20(c): the fused head read no cache entry")
    dlrm = {}
    for label, path in (("present", cache),
                        ("absent", os.path.join(tmp, "absent.json"))):
        kernels_mod.reset_launches()
        d = serve.run(serve.parse_args([
            "--model", "full", "--batch", "512", "--requests",
            str(REQUESTS), "--autotune-cache", path])).record
        by_path[f"autotune_dlrm_{label}"] = path_counts(kernels_mod, kernel,
                                                        hg_kernel)
        dlrm[label] = {"p50_us": d["p50_us"], "p99_us": d["p99_us"]}
        torch.cuda.empty_cache()
    summary = {"wide-deep": {"cache_hits_bag_matmul": hits,
                             "p50_us": rec["p50_us"],
                             "p50_us_phase8_no_cache": rec_before["p50_us"],
                             "logits": "bit-equal to phase 8's"},
               "dlrm-rm2": dlrm,
               "device_name": torch.cuda.get_device_name(0)}
    autotune.set_cache_path(None)
    print(json.dumps({"autotune_serve": summary}), flush=True)
    log(f"phase 20(c): wide&deep with the cache p50 {rec['p50_us']:.1f} us "
        f"(phase 8 {rec_before['p50_us']:.1f}), {hits} bag_matmul cache "
        f"hits, logits bit-equal; dlrm p50 present "
        f"{dlrm['present']['p50_us']:.1f} / absent "
        f"{dlrm['absent']['p50_us']:.1f} us")
    return by_path


def train_twin(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 20 (d): ``bag_matmul_train`` at wide&deep's widths (B 512, K
    40, D 32, H 1024, the 22,216,192-row table): one forward and backward
    (one bag_matmul and one bag_grad launch), the forward bit-equal to
    ``bag_matmul``, the table's gradient to ``bag_grad`` of the slot
    cotangents, dw3 and dweights within 1e-5 (relative to their largest
    magnitude) of the float64 plain contractions.  Returns its
    launches."""
    from repro_torch import configs
    from repro_torch.kernels.bag_matmul import bag_matmul_train
    from repro_torch.kernels.bag_matmul import ops as bm_ops
    from repro_torch.kernels.dequant_bag import ops
    from repro_torch.models.embedding import globalize

    dev = torch.device("cuda")
    spec = configs.get("wide-deep").model.spec
    v, d, k, b, h = spec.total_rows, spec.dim, spec.num_fields, 512, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    table = torch.randn((v, d), generator=gen, device=dev) * 0.01
    cards = torch.tensor(spec.cardinalities, device=dev)
    local = (torch.rand((b, k), generator=gen, device=dev) * cards).long()
    idx = globalize(local, spec).to(torch.int32)
    w = torch.rand((b, k), generator=gen, device=dev) + 0.5
    w3 = torch.randn((k, d, h), generator=gen, device=dev) * 0.05
    r = torch.randn((b, h), generator=gen, device=dev)
    tt, tw, tm = (x.clone().requires_grad_() for x in (table, w, w3))
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    out = bag_matmul_train(tt, idx, tm, tw)
    torch.sum(out * r).backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    if counts["bag_matmul"] != 1 or counts["bag_grad"] != 1:
        raise SystemExit(f"bag_matmul_train launches {counts}")
    with torch.no_grad():
        fwd_ok = bits_equal(out, bm_ops.bag_matmul(table, None, idx, w, w3))
        gk = torch.einsum("bh,kdh->bkd", r, w3)
        dtable = ops.bag_grad(gk.reshape(b * k, d).contiguous(), None,
                              idx.reshape(-1, 1), w.reshape(-1, 1), v)
        grad_ok = bits_equal(tt.grad, dtable)
        rows = table[idx.long()].double()
        rd = r.double()
        errs = {}
        for name, got, want in (
                ("dw3", tm.grad, torch.einsum(
                    "bkd,bh->kdh", rows * w.double()[..., None], rd)),
                ("dweights", tw.grad, torch.einsum(
                    "bkd,kdh,bh->bk", rows, w3.double(), rd))):
            errs[name] = float((got.double() - want).abs().max()
                               / want.abs().max())
    if not (fwd_ok and grad_ok) or max(errs.values()) > 1e-5:
        raise SystemExit(f"bag_matmul_train: forward bit-equal {fwd_ok}, "
                         f"dtable bit-equal {grad_ok}, {errs}")
    summary = {"b": b, "k": k, "d": d, "h": h, "rows": v,
               "forward_bit_equal": True, "dtable_bit_equal": True,
               "rel_err": errs, "fwd_bwd_s": seconds,
               "launches": {"bag_matmul": 1, "bag_grad": 1}}
    print(json.dumps({"bag_matmul_train": summary}), flush=True)
    log(f"phase 20(d): bag_matmul_train at {v:,} x {d}: forward and dtable "
        f"bit-equal, dw3 / dweights within {errs['dw3']:.2e} / "
        f"{errs['dweights']:.2e}")
    del table, tt, tw, tm, out, dtable, gk
    torch.cuda.empty_cache()
    return counts


def family_smoke(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 20 (e): ``python -m repro_torch.launch.train --arch X --smoke``
    through ``run`` for the four recsys archs; finite metrics each.
    Returns each arch's launches."""
    from repro_torch.launch import train

    by_path = {}
    for arch in SMOKE_ARCHS:
        kernels_mod.reset_launches()
        m = train.run(train.parse_args(["--arch", arch, "--smoke"]))
        by_path[f"smoke_{arch}"] = path_counts(kernels_mod, kernel,
                                               hg_kernel)
        if not m["finite"]:
            raise SystemExit(f"smoke {arch}: {m}")
    log(f"phase 20(e): the family smoke finite on {', '.join(SMOKE_ARCHS)}")
    return by_path


def bert4rec_full(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 20 (f): bert4rec at ``FULL_CFG`` (5,000,002 items x 64, 2
    blocks, 2 heads, sequence 200): one generic train step with the
    F-Quantization hook and one forward, at batch 2 (the (2, 200,
    5,000,002) fp32 logits are 8.0 GB); both finite; the peak memory
    printed.  Returns the run's launches."""
    from repro_torch import configs
    from repro_torch.data.sequences import SeqConfig, SeqSynth
    from repro_torch.optim import rowwise_adagrad
    from repro_torch.train import steps

    dev = torch.device("cuda")
    arch = configs.get("bert4rec")
    model = arch.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    seqs = SeqSynth(SeqConfig(num_items=arch.cfg.num_items - 2,
                              seq_len=arch.seq_len)).batch(BERT4REC_BATCH, 0)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in seqs.items()}
    opt = rowwise_adagrad(0.05)
    hook = arch._fquant_hook(model)
    step = steps.make_train_step(arch._loss_fn(model), opt, hook)
    state = steps.init_state(params, opt, hook)
    del params
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with torch.no_grad():
        out = model.forward(state.params, batch)
    torch.cuda.synchronize()
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    finite = (math.isfinite(loss) and math.isfinite(norm)
              and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(state.params["embed_table"]).all()))
    summary = {"items": arch.cfg.num_items, "dim": arch.cfg.embed_dim,
               "seq_len": arch.seq_len, "batch": BERT4REC_BATCH,
               "table_rows": model.spec.total_rows, "loss": loss,
               "grad_norm": norm, "forward_shape": list(out.shape),
               "finite": finite, "step_s": step_s,
               "device_peak_bytes": torch.cuda.max_memory_allocated(dev),
               "device_name": torch.cuda.get_device_name(0)}
    print(json.dumps({"bert4rec_full": summary}), flush=True)
    if not finite or tuple(out.shape) != (BERT4REC_BATCH,):
        raise SystemExit(f"bert4rec FULL_CFG: {summary}")
    log(f"phase 20(f): bert4rec FULL_CFG step finite (loss {loss:.4f}), "
        f"{step_s:.2f}s, peak {summary['device_peak_bytes'] / 1e9:.2f} GB")
    del state, out, batch, m
    torch.cuda.empty_cache()
    return counts


def examples_phase(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 20 (g): the four examples through ``main`` on the card at
    their defaults.  Returns each one's launches."""
    import importlib

    by_path = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        kernels_mod.reset_launches()
        t0 = time.perf_counter()
        out = mod.main(["--device", "cuda"])
        by_path[f"example_{name}"] = path_counts(kernels_mod, kernel,
                                                 hg_kernel)
        if not all(math.isfinite(x) for x in out.values()
                   if isinstance(x, float)):
            raise SystemExit(f"example {name}: {out}")
        print(json.dumps({f"example_{name}": out}), flush=True)
        log(f"phase 20(g): {name} {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
    return by_path


def kernel_record_phase(torch, serve, kernels_mod, kernel, bm_kernel,
                        hg_kernel, hg_ops, counters, logits_before: list,
                        rec_before: dict) -> dict:
    """Phase 20, (a) to (g); returns each main path's launches (the
    tiling checks of (b) are comparisons and count on no path)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _, cache, counts = kernel_record(torch, kernels_mod, kernel,
                                         hg_kernel, tmp)
        by_path = {"bench_kernel": counts}
        check_tilings(torch, kernel, bm_kernel, hg_kernel, hg_ops)
        by_path.update(autotune_serve(torch, serve, kernels_mod, kernel,
                                      hg_kernel, counters, cache, tmp,
                                      logits_before, rec_before))
    by_path["bag_matmul_train"] = train_twin(torch, kernels_mod, kernel,
                                             hg_kernel)
    by_path.update(family_smoke(torch, kernels_mod, kernel, hg_kernel))
    by_path["bert4rec_full"] = bert4rec_full(torch, kernels_mod, kernel,
                                             hg_kernel)
    by_path.update(examples_phase(torch, kernels_mod, kernel, hg_kernel))
    log(f"phase 20: {time.perf_counter() - t0:.1f}s")
    return by_path


# ---- phase 21: the GNN and LM families at published widths -------------

def timed(torch, fn, *args):
    """``fn(*args)`` between two CUDA events: (its result, ms)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn(*args)
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def family_run(torch, label: str, reduced: list, **fields) -> dict:
    """One phase 21 run's line: its fields, the peak device memory since
    the run's start (``run_start``), ``reduced`` (each cut with its
    reason)."""
    rec = {"run": label, **fields,
           "device_peak_bytes": torch.cuda.max_memory_allocated(),
           "reduced": reduced}
    print(json.dumps({"family_run": rec}), flush=True)
    return rec


def run_start(torch) -> None:
    """A phase 21 run starts: what earlier runs left goes back to the
    card, and the peak counts from here."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _finite(torch, *tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def pna_train(torch, label: str, cfg, batch_fn, loss_name: str, steps: int,
              hook, reduced: list, extra: dict) -> dict:
    """``steps`` generic PNA train steps (Adam at the arch's lr, 0.01;
    ``hook``) on ``batch_fn(step)``, then a forward; times each step and
    the forward with CUDA events."""
    from repro_torch import configs
    from repro_torch.models import gnn as G
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import steps as steps_lib

    run_start(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = G.init_params(gen, cfg, dev)
    optimizer = opt_lib.adam(configs.get("pna").lr)
    loss_fn = getattr(G, loss_name)
    step = steps_lib.make_train_step(lambda p, b: loss_fn(p, cfg, b),
                                     optimizer, hook)
    state = steps_lib.init_state(params, optimizer, hook)
    losses, step_ms = [], []
    for i in range(steps):
        batch = batch_fn(i)
        (state, m), ms = timed(torch, step, state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    with torch.no_grad():
        out, fwd_ms = timed(torch, G.forward, state.params, cfg, batch)
    ok = (_finite(torch, out) and all(math.isfinite(x) for x in losses)
          and losses[-1] <= losses[0])
    rec = family_run(torch, label, reduced, loss_first=losses[0],
                     loss_last=losses[-1], step_ms=step_ms,
                     forward_ms=fwd_ms, forward_shape=list(out.shape),
                     **extra)
    if not ok:
        raise SystemExit(f"phase 21 {label}: {rec}")
    return rec


def _to_dev(torch, blk: dict) -> dict:
    import numpy as np
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
            for k, v in blk.items()}


def pna_small(torch) -> list:
    """Phase 21 (a) on full_graph_sm and molecule."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data import graphs

    arch = configs.get("pna")
    recs = []
    # full_graph_sm: a Cora-sized random graph, every node labelled
    sm = GNN_SHAPES["full_graph_sm"]
    g = graphs.random_graph(sm["n_nodes"], PNA_SM_DEGREE, sm["d_feat"],
                            seed=0)
    src, dst = graphs.to_edge_list(g)
    full = _to_dev(torch, {"features": g.features, "src": src, "dst": dst,
                           "labels": g.labels})
    recs.append(pna_train(
        torch, "pna full_graph_sm", arch._cfg("full_graph_sm"),
        lambda i: full, "node_loss", PNA_STEPS, None,
        [f"random graph of {g.num_edges:,} edges (average degree "
         f"{PNA_SM_DEGREE}) for the published {sm['n_edges']:,}: "
         "random_graph takes an integer degree",
         f"{PNA_STEPS} train steps, then a forward"],
        {"nodes": g.num_nodes, "edges": g.num_edges}))
    # molecule: 128 graphs x 30 nodes, 64 edges each
    mol = GNN_SHAPES["molecule"]
    mb = _to_dev(torch, graphs.molecule_batch(mol["batch"], mol["n_nodes"],
                                              mol["n_edges"], mol["d_feat"],
                                              seed=0))
    recs.append(pna_train(
        torch, "pna molecule", arch._cfg("molecule"), lambda i: mb,
        "graph_loss", PNA_STEPS, None,
        [f"{PNA_STEPS} train steps on one batch, then a forward"],
        {"graphs": mol["batch"], "edges": int(mb["src"].shape[0])}))
    log("phase 21(a): PNA on full_graph_sm and molecule")
    return recs


def pna_large(torch) -> dict:
    """Phase 21 (a) on minibatch_lg: the 114.6M-edge graph built on the
    host (after the LM runs, so that no host work overlaps their
    timings), then a fresh 1,024-seed 15-10 block a step from it, the hook
    on the 233,472 x 75 node table."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data import graphs

    arch = configs.get("pna")
    lg = GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    g = graphs.random_graph(lg["n_nodes"], PNA_LG_DEGREE, lg["d_feat"],
                            seed=0)
    graph_s = time.perf_counter() - t0
    log(f"phase 21(a): minibatch_lg graph {g.num_edges:,} edges built on "
        f"the host in {graph_s:.1f}s")
    cfg = arch._cfg("minibatch_lg")
    max_nodes, max_edges, _ = arch._block_shape("minibatch_lg")
    sampler_s, blocks = [], []

    def block(i):
        rng = np.random.default_rng(100 + i)
        seeds = rng.choice(g.num_nodes, lg["batch_nodes"], replace=False)
        t = time.perf_counter()
        blk = graphs.padded_subgraph(g, seeds, lg["fanout"], seed=i)
        sampler_s.append(time.perf_counter() - t)
        blocks.append((len(blk["node_ids"]), len(blk["src"])))
        if blocks[-1][0] > max_nodes or blocks[-1][1] > max_edges:
            raise SystemExit(f"phase 21 minibatch_lg: block {blocks[-1]} "
                             f"over {(max_nodes, max_edges)}")
        return _to_dev(torch, blk)

    return pna_train(
        torch, "pna minibatch_lg", cfg, block, "node_loss", PNA_STEPS,
        arch._fquant_hook(),
        [f"{PNA_STEPS} train steps, a fresh sampled block each, then a "
         "forward"],
        {"nodes": g.num_nodes, "edges": g.num_edges,
         "published_edges": lg["n_edges"],
         "node_table": [cfg.node_vocab, cfg.d_hidden],
         "graph_host_s": graph_s,
         "sampler_host_s": sampler_s, "blocks_nodes_edges": blocks})


def lm_depth_cut(cfg, layers: int | None):
    """``cfg`` cut to ``layers`` whole layers (the first dense ones
    kept), or unchanged."""
    import dataclasses
    if layers is None or layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers)


def cache_bytes(cfg, batch: int, slots: int) -> int:
    """Bytes of a bf16 decode cache (``init_cache``'s default)."""
    per = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attn == "mla"
           else 2 * cfg.n_kv_heads * cfg.head_dim)
    return cfg.n_layers * batch * slots * per * 2


def lm_tokens(torch, cfg, batch: int, seq: int, step: int = 0):
    from repro_torch.data.lm import LMConfig as DataConfig
    from repro_torch.data.lm import LMSynth
    toks = LMSynth(DataConfig(vocab=cfg.vocab, seq_len=seq)).batch(
        batch, step)["tokens"]
    return torch.from_numpy(toks).to("cuda")


def lm_train(torch, arch, cfg, reduced: list) -> dict:
    """Phase 21 (b) ``train_4k`` for smollm-135m: generic steps with the
    hook on ``embed``, Adam at the arch's lr, ``remat="full"``."""
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import steps as steps_lib

    run_start(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, dev)
    optimizer = opt_lib.adam(arch.lr)
    hook = arch._fquant_hook()
    step = steps_lib.make_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"]), optimizer, hook)
    state = steps_lib.init_state(params, optimizer, hook)
    del params
    seq = LM_SHAPES["train_4k"]["seq"]
    losses, step_ms = [], []
    for i in range(LM_TRAIN_STEPS):
        batch = {"tokens": lm_tokens(torch, cfg, LM_TRAIN_BATCH, seq, i)}
        (state, m), ms = timed(torch, step, state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(ms)
    rec = family_run(torch, f"{arch.name} train_4k", reduced,
                     batch=LM_TRAIN_BATCH, seq=seq, remat=cfg.remat,
                     loss_first=losses[0], loss_last=losses[-1],
                     step_ms=step_ms, tokens_per_s=LM_TRAIN_BATCH * seq
                     / (min(step_ms) / 1e3))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"phase 21 {arch.name} train_4k: {rec}")
    del state
    torch.cuda.empty_cache()
    return rec


def lm_prefill(torch, name: str, params, cfg, batch: int, seq: int,
               reduced: list) -> dict:
    from repro_torch.models import transformer as T
    run_start(torch)
    toks = lm_tokens(torch, cfg, batch, seq)
    with torch.no_grad():
        (logits, caches), ms = timed(torch, T.prefill, params, cfg, toks)
    ok = _finite(torch, logits) and tuple(logits.shape) == (batch, 1,
                                                            cfg.vocab)
    rec = family_run(torch, f"{name} prefill_32k", reduced, batch=batch,
                     seq=seq, layers=cfg.n_layers, prefill_ms=ms,
                     tokens_per_s=batch * seq / (ms / 1e3))
    if not ok:
        raise SystemExit(f"phase 21 {name} prefill: {rec}")
    del logits, caches, toks
    torch.cuda.empty_cache()
    return rec


def lm_decode(torch, name: str, cell: str, params, cfg, batch: int,
              slots: int, start: int, steps: int, rolling: bool,
              reduced: list) -> dict:
    """``steps`` decode steps from position ``start`` over a cache of
    ``slots`` slots (filled with N(0, 0.1^2) bf16 as if prefilled)."""
    from repro_torch.models import transformer as T
    run_start(torch)
    cache = T.init_cache(cfg, batch, slots, rolling=rolling, device="cuda")
    for k, v in cache.items():
        if k != "pos":
            v.normal_(0.0, 0.1)
    if rolling:        # every slot written once: the window before start
        pos = torch.arange(start - slots, start, device="cuda",
                           dtype=torch.int32)
        cache["pos"].copy_(pos.roll(start % slots))
    toks = lm_tokens(torch, cfg, batch, steps)
    step_ms = []
    with torch.no_grad():
        for i in range(steps):
            (logits, cache), ms = timed(torch, T.decode_step, params, cfg,
                                        toks[:, i:i + 1], cache, start + i)
            step_ms.append(ms)
    ok = _finite(torch, logits) and tuple(logits.shape) == (batch, 1,
                                                            cfg.vocab)
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    rec = family_run(torch, f"{name} {cell}", reduced, batch=batch,
                     cache_slots=slots, rolling=rolling,
                     positions=[start, start + steps - 1],
                     layers=cfg.n_layers, cache_bytes=cache_bytes,
                     step_ms=step_ms,
                     tokens_per_s=batch / (min(step_ms) / 1e3))
    if not ok:
        raise SystemExit(f"phase 21 {name} {cell}: {rec}")
    del cache, logits
    torch.cuda.empty_cache()
    return rec


def decode_agrees_with_prefill(torch, name: str, params, cfg) -> dict:
    """Phase 21 (c): at fp32 compute and an fp32 cache, prefill
    ``AGREE_PREFIX`` tokens, copy the caches into slots [0, prefix) of
    ``init_cache``, decode ``AGREE_STEPS`` tokens; each decode step's
    logits against the last logits of a prefill over the longer prefix,
    within 1e-3 * max(1, max|ref|).  MoE configs at capacity factor
    num_experts / top_k (no prefill token dropped at capacity)."""
    import dataclasses

    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    n = AGREE_PREFIX
    toks = lm_tokens(torch, cfg, 1, n + AGREE_STEPS, step=7)
    diffs, tols = [], []
    with torch.no_grad():
        _, (dense, (k, v)) = T.prefill(params, cfg, toks[:, :n])
        cache = T.init_cache(cfg, 1, n + AGREE_STEPS, dtype=torch.float32,
                             device="cuda")
        cache["k"][:, :, :n] = k
        cache["v"][:, :, :n] = v
        for i, (dk, dv) in enumerate(dense):
            cache["dense_k"][i, :, :n] = dk
            cache["dense_v"][i, :, :n] = dv
        del dense, k, v
        for i in range(AGREE_STEPS):
            tok = toks[:, n + i:n + i + 1]
            logits, cache = T.decode_step(params, cfg, tok, cache, n + i)
            ref, _ = T.prefill(params, cfg, toks[:, :n + i + 1])
            diffs.append(float((logits - ref).abs().max()))
            tols.append(1e-3 * max(1.0, float(ref.abs().max())))
    rec = {"model": name, "layers": cfg.n_layers, "prefix": n,
           "steps": AGREE_STEPS, "max_abs_diff": diffs, "tolerance": tols}
    print(json.dumps({"decode_vs_prefill": rec}), flush=True)
    if not all(d <= t for d, t in zip(diffs, tols)):
        raise SystemExit(f"phase 21(c) {name}: decode disagrees with "
                         f"prefill: {rec}")
    del cache
    torch.cuda.empty_cache()
    return rec


def lm_model_phase(torch, name: str) -> list:
    """Phase 21 (b) and (c) for one LM: its params once, at the depth
    that fits; prefill_32k, decode_32k (and long_500k), then (c)."""
    from repro_torch import configs
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.models import transformer as T

    arch = configs.get(name)
    full = arch.lm_cfg
    layers = LM_DEPTH.get(name)
    cfg = lm_depth_cut(full, layers)
    depth = ([f"depth {cfg.n_layers} of {full.n_layers} layers: the "
              f"whole model is {T.param_count(full) * 4 / 1e9:.1f} GB in "
              "fp32; these layers leave room on the 80 GB card for the "
              "prefill's and the decode caches' working memory"]
             if cfg.n_layers < full.n_layers else [])
    recs = []
    if name == "smollm-135m":
        recs.append(lm_train(torch, arch, cfg, depth + [
            f"batch {LM_TRAIN_BATCH} of 256: the (B, 4095, 49152) fp32 "
            "logits and their softmax are 6.4 GB a copy at 8",
            f"{LM_TRAIN_STEPS} train steps"]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(gen, cfg, dev)
    torch.cuda.synchronize()
    log(f"phase 21(b): {name} params at {cfg.n_layers} layers "
        f"({T.param_count(cfg):,}) in {time.perf_counter() - t0:.1f}s")
    full_seq = LM_SHAPES["prefill_32k"]["seq"]
    seq = LM_PREFILL_TOKENS.get(name, full_seq)
    recs.append(lm_prefill(torch, name, params, cfg, 1, seq, depth + [
        "batch 1 of 32"] + ([f"{seq:,} of {full_seq:,} tokens: the whole "
                             "smoke's headroom under its 1,200 s on a slow "
                             "host (LM_PREFILL_TOKENS)"]
                            if seq < full_seq else [])))
    batch = LM_DECODE_BATCH[name]
    slots = LM_SHAPES["decode_32k"]["seq"]
    recs.append(lm_decode(
        torch, name, "decode_32k", params, cfg, batch, slots,
        slots - LM_DECODE_STEPS, LM_DECODE_STEPS, False,
        depth + [f"batch {batch} of 128: the bf16 cache at 128 is "
                 f"{cache_bytes(cfg, 128, slots) / 1e9:.1f} GB, at "
                 f"{batch} {cache_bytes(cfg, batch, slots) / 1e9:.1f} GB"
                 + ("; MLA re-expands every cached latent a step (1.27 s a "
                    "step at batch 16 and 14 layers on an H100)"
                    if cfg.attn == "mla" else ""),
                 f"{LM_DECODE_STEPS} decode steps at the cache's last "
                 "positions, the cache filled with random values"]))
    if arch.supports_long:
        seq = LM_SHAPES["long_500k"]["seq"]
        slots = arch.rolling_window or seq
        recs.append(lm_decode(
            torch, name, "long_500k", params, cfg, 1, slots,
            seq - LM_LONG_STEPS, LM_LONG_STEPS,
            arch.rolling_window is not None,
            depth + [f"{LM_LONG_STEPS} decode steps at positions near "
                     f"{seq - 1:,}, the cache filled with random values"]))
    recs.append(decode_agrees_with_prefill(torch, name, params, cfg))
    del params
    torch.cuda.empty_cache()
    return recs


def families_phase(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 21, (a) to (d); returns each path's launches (none of the
    eight kernels runs on these paths: all zeros)."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    by_path = {}
    kernels_mod.reset_launches()
    pna_small(torch)
    by_path["family_pna"] = path_counts(kernels_mod, kernel, hg_kernel)
    for name in LM_ARCHS:
        t1 = time.perf_counter()
        kernels_mod.reset_launches()
        lm_model_phase(torch, name)
        by_path[f"family_{name}"] = path_counts(kernels_mod, kernel,
                                                hg_kernel)
        log(f"phase 21(b, c): {name} {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    kernels_mod.reset_launches()
    pna_large(torch)
    by_path["family_pna_minibatch_lg"] = path_counts(kernels_mod, kernel,
                                                     hg_kernel)
    log(f"phase 21(a): minibatch_lg {time.perf_counter() - t1:.1f}s")
    # (d) the six family smokes through the train CLI's run
    for name in ("pna",) + LM_ARCHS:
        kernels_mod.reset_launches()
        m = train.run(train.parse_args(["--arch", name, "--smoke"]))
        by_path[f"smoke_{name}"] = path_counts(kernels_mod, kernel,
                                               hg_kernel)
        if not (m["finite"] and m["loss_last"] <= 1.05 * m["loss_first"]):
            raise SystemExit(f"phase 21(d) smoke {name}: {m}")
    log(f"phase 21(d): the family smoke finite on pna and "
        f"{', '.join(LM_ARCHS)}")
    launched = {path: {k: v for k, v in counts.items()
                       if isinstance(v, int) and v}
                for path, counts in by_path.items()}
    launched = {p: c for p, c in launched.items() if c}
    print(json.dumps({"family_launches": {
        path: {k: v for k, v in counts.items() if isinstance(v, int)}
        for path, counts in by_path.items()}}), flush=True)
    if launched:
        raise SystemExit(f"phase 21 launched a kernel: {launched}")
    log(f"phase 21: {time.perf_counter() - t0:.1f}s")
    return by_path


# ---- phase 22: the SPMD layer (dist.collectives, optim.grad_compress,
# launch.dryrun) ------------------------------------------------------------

def grad_exchange(torch, kernels_mod, kernel, hg_kernel, rq_kernel, rq_ref,
                  smi: str) -> tuple[dict, dict, dict]:
    """Phase 22 (a): ``optim.error_feedback_allreduce`` over 4 logical
    shards of the card, each a seeded gradient of smollm-135m's parameter
    count, 3 steps carrying the residual.  Every quantisation launch is
    held bit for bit to the plain quantizer (``reciprocal=True``, as the
    exchange calls it), every shard's mean to the fp32 mean of the
    corrected gradients within the half-step bound, and every new residual
    to ``corrected - q * s`` exactly (the fused form, in float64).
    Returns (the phase's summary, the quantizer's D = 256 timing, the
    main path's launch counts)."""
    from repro_torch import configs
    from repro_torch.dist import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import grad_compress as gc

    n = T.param_count(configs.get("smollm-135m").lm_cfg)
    w = SPMD_SHARDS
    mesh = make_mesh(w, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    # the D = 256 launch timed at the exchange's block shape (a comparison
    # launch, before the counts are reset)
    x = torch.randn((-(-n // 256), 256), generator=gen, device="cuda") * 1e-3
    v, d = x.shape
    ms = time_launches(torch, lambda a: rq_kernel.quantize_rowwise_cuda(
        a, None, "narrow", reciprocal=True), [(x,)] * 10, flush)
    plain_ms = time_launches(torch, lambda a: rq_ref.quantize_rowwise_ref(
        a, None, "narrow", reciprocal=True), [(x,)] * 2, flush)
    nbytes = v * d * 5 + v * 4
    bound_ms, bound_by = _bound(nbytes, 5 * v * d)
    d256 = {"shape": {"V": v, "D": d}, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "gb_per_s": nbytes / ms / 1e6,
            "per": "launch (one shard's gradient of smollm-135m's "
                   f"{n:,} parameters in 256-element blocks)"}
    del x, flush
    log(f"phase 22(a) quantize_rowwise at D = 256 (V={v:,}, reciprocal): "
        f"{ms:.4f} ms, {d256['gb_per_s']:.0f} GB/s (bound {bound_ms:.4f}, "
        f"{bound_ms / ms:.1%} of it; plain {plain_ms:.4f}) [{smi}]")

    launches_seen = []
    real = gc.quantize_rowwise

    def recorded(blocks, *a, **k):
        q, s = real(blocks, *a, **k)
        launches_seen.append((blocks, q, s, k.get("reciprocal", False)))
        return q, s

    res = [torch.zeros(n, device="cuda") for _ in range(w)]
    step_ms, worst_mean, fused_only = [], 0.0, 0
    gc.quantize_rowwise = recorded
    kernels_mod.reset_launches()
    try:
        for _ in range(SPMD_STEPS):
            grads = [torch.randn(n, generator=gen, device="cuda") * 1e-2
                     for _ in range(w)]
            corrected = [g + r for g, r in zip(grads, res)]
            launches_seen.clear()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            means, res = gc.error_feedback_allreduce(grads, res, mesh)
            e1.record()
            torch.cuda.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            if len(launches_seen) != w:
                raise SystemExit(f"phase 22(a): {len(launches_seen)} "
                                 f"quantisation launches, want {w}")
            half = torch.zeros(n, dtype=torch.float64, device="cuda")
            for (blocks, q, s, recip), c, r in zip(launches_seen, corrected,
                                                   res):
                wq, ws = rq_ref.quantize_rowwise_ref(blocks, None, "narrow",
                                                     reciprocal=recip)
                if not (recip and torch.equal(q, wq) and bits_equal(s, ws)):
                    raise SystemExit("phase 22(a): a quantisation launch != "
                                     "the plain quantizer")
                prod = (q.double() * s.double()).reshape(-1)[:n]
                if not torch.equal(r, (c.double() - prod).float()):
                    raise SystemExit("phase 22(a): residual != corrected - "
                                     "dequant")
                fused_only += int((r != c - prod.float()).sum())
                half += (s.double() / 2).expand(-1, 256).reshape(-1)[:n]
            exact = sum(c.double() for c in corrected) / w
            gap = (means[0].double() - exact).abs()
            # half a step a shard; the fp32 quotient x / s may sit 127 ulp
            # off (1.5e-5 of a step) and the fp32 sum rounds (2^-22 of it)
            bound = half / w * (1 + 1e-4) + exact.abs() * 2.0 ** -22 + 1e-12
            if not (bool((gap <= bound).all())
                    and all(m is means[0] for m in means)):
                raise SystemExit("phase 22(a): the mean is outside the "
                                 "half-step bound of the fp32 mean")
            worst_mean = max(worst_mean, float((gap / bound).max()))
            del grads, corrected, half, exact, gap, bound, prod
    finally:
        gc.quantize_rowwise = real
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    if counts["quantize_rowwise"] != w * SPMD_STEPS:
        raise SystemExit(f"phase 22(a): {counts['quantize_rowwise']} "
                         f"quantize_rowwise launches, want {w * SPMD_STEPS}")
    q, s = launches_seen[0][1], launches_seen[0][2]
    wire = q.numel() * q.element_size() + s.numel() * s.element_size()
    summary = {"shards": w, "steps": SPMD_STEPS, "elements": n,
               "step_ms": step_ms, "quantize_ms": ms,
               "wire_bytes_per_shard": wire, "fp32_bytes_per_shard": 4 * n,
               "wire_ratio": wire / (4 * n),
               "mean_gap_over_half_step_max": worst_mean,
               "residual_differs_from_unfused": fused_only,
               "quantize_launches": counts["quantize_rowwise"]}
    log(f"phase 22(a) error_feedback_allreduce: {w} shards x {n:,} "
        f"elements, {SPMD_STEPS} steps {', '.join(f'{t:.2f}' for t in step_ms)}"
        f" ms; wire {wire:,} B a shard against {4 * n:,} fp32 "
        f"({wire / (4 * n):.4f}x); every launch bit-equal to plain, the "
        f"mean within {worst_mean:.3f} of its half-step bound, residuals "
        f"exact ({fused_only:,} elements differ from the unfused "
        f"difference) [{smi}]")
    del means, res, launches_seen, q, s
    torch.cuda.empty_cache()
    return summary, d256, counts


def split_kv_phase(torch, smi: str) -> dict:
    """Phase 22 (b): ``dist.collectives.split_kv_decode_attention`` at
    qwen3-8b's decode width over 4 views of one fp32 cache, held to the
    full softmax over the valid prefix within 2e-5."""
    from repro_torch.dist import make_mesh
    from repro_torch.dist.collectives import split_kv_decode_attention

    b, h, dh, s = (SPLIT_KV[k] for k in ("batch", "heads", "head_dim",
                                         "slots"))
    cache_len = s // 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    q = torch.randn((b, h, dh), generator=gen, device="cuda")
    k = torch.randn((b, s, h, dh), generator=gen, device="cuda")
    v = torch.randn((b, s, h, dh), generator=gen, device="cuda")
    mesh = make_mesh(SPMD_SHARDS, device="cuda")
    scale = dh ** -0.5
    out = split_kv_decode_attention(mesh, q, k, v, cache_len, scale)
    ms = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        split_kv_decode_attention(mesh, q, k, v, cache_len, scale)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    valid = slice(0, cache_len + 1)
    sc = torch.einsum("bhd,bkhd->bhk", q.double(),
                      k[:, valid].double()) * scale
    ref = torch.einsum("bhk,bkhd->bhd", torch.softmax(sc, dim=-1),
                       v[:, valid].double())
    err = float((out.double() - ref).abs().max())
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    if not (out.shape == (b, h, dh) and err <= tol):
        raise SystemExit(f"phase 22(b): split-KV off the full softmax by "
                         f"{err} (tolerance {tol})")
    rec = {"batch": b, "heads": h, "head_dim": dh, "slots": s,
           "cache_len": cache_len, "shards": SPMD_SHARDS, "ms": ms,
           "max_abs_err": err, "tolerance": tol}
    log(f"phase 22(b) split-KV decode ({b} x {h} heads x {dh}, {s:,} fp32 "
        f"slots, position {cache_len:,}, {SPMD_SHARDS} shards): "
        f"{min(ms):.3f} ms (of {', '.join(f'{t:.3f}' for t in ms)}), "
        f"{err:.2e} from the full softmax [{smi}]")
    del q, k, v, out, sc, ref
    torch.cuda.empty_cache()
    return rec


def dryrun_phase(torch, kernels_mod, kernel, hg_kernel) -> dict:
    """Phase 22 (c): ``python -m repro_torch.launch.dryrun`` through
    ``run``, one cheap cell a family, into a temporary directory; the
    roofline's rows of the records printed.  Nothing runs on the card."""
    from repro_torch.benchmarks import roofline
    from repro_torch.launch import dryrun

    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recs = []
        for name, shape in DRYRUN_CELLS:
            got, failed = dryrun.run(dryrun.parse_args(
                ["--arch", name, "--shape", shape, "--results", tmp]))
            if failed or len(got) != 1:
                raise SystemExit(f"phase 22(c): dry run of {name} x {shape} "
                                 f"failed: {failed}")
            recs += got
        rows = roofline.table("single", results=tmp)
        print(roofline.markdown("single", results=tmp), flush=True)
    secs = time.perf_counter() - t0
    if len(rows) != len(DRYRUN_CELLS):
        raise SystemExit(f"phase 22(c): the roofline read {len(rows)} rows")
    counts = path_counts(kernels_mod, kernel, hg_kernel)
    launched = {k: n for k, n in counts.items() if isinstance(n, int) and n}
    if launched:
        raise SystemExit(f"phase 22(c): the dry run launched {launched}")
    log(f"phase 22(c) dry run of {len(recs)} cells: {secs:.1f}s, "
        f"{[(r['arch'], r['shape'], r['lower_s']) for r in recs]}")
    return {"cells": [{k: r[k] for k in ("arch", "shape", "kind", "flops",
                                         "hbm_bytes", "lower_s",
                                         "kernel_calls")}
                      | {"memory": r["memory"]} for r in recs],
            "seconds": secs, "launches": counts}


def spmd_phase(torch, kernels_mod, kernel, hg_kernel, rq_kernel, rq_ref,
               smi: str) -> tuple[dict, dict, dict]:
    """Phase 22, (a) to (c); returns (the summary, the quantizer's D = 256
    timing, each path's launches)."""
    t0 = time.perf_counter()
    exchange, d256, counts = grad_exchange(torch, kernels_mod, kernel,
                                           hg_kernel, rq_kernel, rq_ref, smi)
    by_path = {"spmd_grad_exchange": counts}
    split_kv = split_kv_phase(torch, smi)
    dry = dryrun_phase(torch, kernels_mod, kernel, hg_kernel)
    by_path["spmd_dryrun"] = dry.pop("launches")
    summary = {"grad_exchange": exchange, "split_kv": split_kv,
               "dryrun": dry, "device": smi}
    print(json.dumps({"spmd": summary}), flush=True)
    log(f"phase 22: {time.perf_counter() - t0:.1f}s")
    return summary, d256, by_path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", metavar="PATH",
                    help="also profile 8 served dlrm requests and 6 more "
                         "online requests of each fused arch and of each "
                         "hashed pool; the kernel tables go to PATH")
    ap.add_argument("--hier-only", action="store_true",
                    help="build the kernels and run phase 17 alone (a "
                         "quick check of the hier store; prints no kernels "
                         "line and no ok line)")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build the kernels and run phase 18 alone (a "
                         "quick check of the serving fleet; prints no "
                         "kernels line and no ok line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run phase 19 alone, with "
                         "its mesh-1 references and phase 2's window "
                         "cases (a quick check of the mesh; prints no "
                         "kernels line and no ok line)")
    ap.add_argument("--families-only", action="store_true",
                    help="build the kernels and run phase 21 alone (a "
                         "quick check of the GNN and LM families; prints "
                         "no kernels line and no ok line)")
    ap.add_argument("--spmd-only", action="store_true",
                    help="build the kernels and run phase 22 alone (a "
                         "quick check of the SPMD layer; prints no kernels "
                         "line and no ok line)")
    ap.add_argument("--record-only", action="store_true",
                    help="build the kernels and run phase 20 alone, after "
                         "phase 8's wide&deep serve (its reference; prints "
                         "no kernels line and no ok line)")
    ap.add_argument("--rowgrid-only", action="store_true",
                    help="build the kernels and run phase 2's bag_grad "
                         "schedules and (B, K)-grid oracle checks and phase "
                         "6's timings at one training batch's slots (drawn "
                         "from the data stream, no train state; prints a "
                         "rowgrid line, no kernels line and no ok line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    from repro_torch import configs
    from repro_torch.core import packed_store as ps
    from repro_torch import kernels as kernels_mod
    from repro_torch.kernels import build, cases
    from repro_torch.kernels.bag_matmul import kernel as bm_kernel
    from repro_torch.kernels.bag_matmul import ops as bm_ops
    from repro_torch.kernels.bag_matmul import ref as bm_ref
    from repro_torch.kernels.cin import kernel as cin_kernel
    from repro_torch.kernels.cin import ops as cin_ops
    from repro_torch.kernels.cin import ref as cin_ref
    from repro_torch.kernels.dequant_bag import autodiff, kernel, ops, ref
    from repro_torch.kernels.hashed_gather import kernel as hg_kernel
    from repro_torch.kernels.hashed_gather import ops as hg_ops
    from repro_torch.kernels.hashed_gather import ref as hg_ref
    from repro_torch.kernels.rowwise_quant import kernel as rq_kernel
    from repro_torch.kernels.rowwise_quant import ops as rq_ops
    from repro_torch.kernels.rowwise_quant import ref as rq_ref
    from repro_torch.launch import pipeline, serve
    from repro_torch.store import hashed as H
    from repro_torch.train import setup as setup_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clock) * 1e6

    t0 = time.perf_counter()
    paths = build.build_all(list(SOURCES))
    log(f"built {[p.name for p in paths]} ({time.perf_counter() - t0:.1f}s)")
    for path in paths:
        report = path.with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())

    if args.families_only:
        by_path = families_phase(torch, kernels_mod, kernel, hg_kernel)
        log(f"phase 21 alone: {sorted(by_path)}")
        return 0
    if args.spmd_only:
        smi_line = smi.splitlines()[0]
        _, _, by_path = spmd_phase(torch, kernels_mod, kernel, hg_kernel,
                                   rq_kernel, rq_ref, smi_line)
        log(f"phase 22 alone: {sorted(by_path)}")
        return 0
    if args.hier_only:
        counters = (kernel.launches, kernel.bag_grad_launches,
                    bm_kernel.launches, cin_kernel.launches,
                    hg_kernel.launches, rq_kernel.launches)
        by_path = hier_phase(torch, serve, kernels_mod, counters)
        log(f"phase 17 alone: {sorted(by_path)}")
        return 0
    if args.fleet_only:
        counters = (kernel.launches, kernel.bag_grad_launches,
                    bm_kernel.launches, cin_kernel.launches,
                    hg_kernel.launches, rq_kernel.launches)
        by_path = fleet_phase(torch, kernels_mod, counters)
        log(f"phase 18 alone: {sorted(by_path)}")
        return 0
    if args.record_only:
        counters = (kernel.launches, kernel.bag_grad_launches,
                    bm_kernel.launches, cin_kernel.launches,
                    hg_kernel.launches, rq_kernel.launches)
        served, _, logits = serve_online(torch, serve, kernels_mod, counters,
                                         "wide-deep")
        rec = served.record
        del served
        torch.cuda.empty_cache()
        by_path = kernel_record_phase(torch, serve, kernels_mod, kernel,
                                      bm_kernel, hg_kernel, hg_ops, counters,
                                      logits, rec)
        log(f"phase 20 alone: {sorted(by_path)}")
        return 0
    if args.mesh_only:
        counters = (kernel.launches, kernel.bag_grad_launches,
                    bm_kernel.launches, cin_kernel.launches,
                    hg_kernel.launches, rq_kernel.launches)
        check_window_cases(torch, ops, ref, cases)
        served = serve.run(serve.parse_args(["--model", "full", "--batch",
                                             "512", "--requests", "2"]))
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        dlrm, by_path, _ = mesh_dlrm(torch, serve, served, kernels_mod,
                                     kernel, hg_kernel, ops, flush)
        del served, flush
        torch.cuda.empty_cache()
        rest, more = mesh_phase(torch, serve, pipeline, kernels_mod, kernel,
                                hg_kernel, setup_mod, counters, {}, None)
        print(json.dumps({"mesh": {"dlrm-rm2": dlrm, **rest}}), flush=True)
        log(f"phase 19 alone: {sorted({**by_path, **more})}")
        return 0

    if args.rowgrid_only:
        worst_grad = check_bag_grad_schedules(torch, kernel, ref)
        worst_rg, worst_grad_rg = check_rowgrid(torch, ops, ref)
        gidx, vocab = train_batch_ids(torch, configs.get("dlrm-rm2"))
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        fwd, fwd_rowgrid = measure_train_forward(torch, kernel, ref, gidx,
                                                 vocab, flush)
        torch.cuda.empty_cache()
        rowgrid_train, grad_entry = measure_bag_grad(
            torch, kernel, ref, gidx, vocab, flush, worst_grad)
        grad_rg_entry = measure_bag_grad_rowgrid(torch, kernel, ref, gidx,
                                                 flush, worst_grad_rg)
        grad_rg_entry["train_shape"] = rowgrid_train
        print(json.dumps({"rowgrid": {
            "dequant_bag_rowgrid[float32]": fwd_rowgrid,
            "dequant_bag[float32]": fwd, "bag_grad_rowgrid": grad_rg_entry,
            "bag_grad": grad_entry, "max_abs_err": [worst_rg,
                                                    worst_grad_rg]}}),
              flush=True)
        log("phases 2 and 6's rowgrid checks and timings alone")
        return 0

    worst = check_kernels(torch, ops, ref)
    worst_cases = max(check_gather_cases(torch, kernel, ops, ref, cases),
                      check_window_cases(torch, ops, ref, cases))
    worst_grad = max(check_bag_grad(torch, ops, ref),
                     check_bag_grad_schedules(torch, kernel, ref))
    worst_bm = check_bag_matmul(torch, bm_ops, bm_ref)
    worst_cin = check_cin(torch, cin_ops, cin_ref)
    worst_hg = check_hashed_gather(torch, hg_ops, hg_ref)
    worst_rq = check_rowwise_quant(torch, rq_ops, rq_ref)
    worst_rg, worst_grad_rg = check_rowgrid(torch, ops, ref)
    # the rowgrid oracles on each main path: no entry point runs them
    rowgrid_by_path = {}
    served, launches = serve_full(torch, serve, kernels_mod, kernel, ops, ps)
    rowgrid_by_path["serve"] = dict(kernel.rowgrid_launches)
    print(json.dumps(served.record), flush=True)
    kernels = measure(torch, served, kernel, ref, launches, worst)
    rowgrid_entries = measure_dequant_rowgrid(torch, served, kernel, ref,
                                              worst_rg)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernels.append(measure_tiered(torch, served, ops, ref,
                                  launches["tiered"], worst_cases, flush))
    quant_entry = measure_quantize(torch, served, rq_kernel, rq_ref, flush,
                                   worst_rq)
    quant_by_path = {"serve": launches["quantize_rowwise"], "train": 0}
    # phase 19(a) on this live pack: meshes 1, 2, 4 of row views
    mesh_dlrm_summary, mesh_dlrm_counts, mesh_timing = mesh_dlrm(
        torch, serve, served, kernels_mod, kernel, hg_kernel, ops, flush)
    next(k for k in kernels if k["name"] == "dequant_bag[tiered]")[
        "mesh_request"] = mesh_timing
    del flush
    if args.trace:
        trace(torch, serve, served, 8, args.trace)
    del served
    torch.cuda.empty_cache()

    train_rec, gidx, vocab = train_full(torch, kernel, autodiff, setup_mod,
                                        configs.get("dlrm-rm2"))
    if not torch.equal(train_batch_ids(torch, configs.get("dlrm-rm2"))[0],
                       gidx):
        raise SystemExit("the data stream's first batch != phase 5's")
    rowgrid_by_path["train"] = dict(kernel.rowgrid_launches)
    print(json.dumps(train_rec), flush=True)
    torch.cuda.empty_cache()
    train_launches = train_rec["train"]["kernel_launches"]
    for k in kernels:
        by_path = {"serve": k["launches"],
                   "train": (train_launches["dequant_bag"]
                             if k["name"] == "dequant_bag[float32]" else 0)}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd, fwd_rowgrid = measure_train_forward(torch, kernel, ref, gidx,
                                             vocab, flush)
    next(k for k in kernels if k["name"] == "dequant_bag[float32]")[
        "train_shape"] = fwd
    next(e for e in rowgrid_entries
         if e["name"] == "dequant_bag_rowgrid[float32]")[
        "train_shape"] = fwd_rowgrid
    torch.cuda.empty_cache()
    rowgrid_train, grad_entry = measure_bag_grad(torch, kernel, ref, gidx,
                                                 vocab, flush, worst_grad)
    grad_rg_entry = measure_bag_grad_rowgrid(torch, kernel, ref, gidx, flush,
                                             worst_grad_rg)
    grad_rg_entry["train_shape"] = rowgrid_train
    grad_entry["launches"] = train_launches["bag_grad"]
    grad_entry["launches_by_path"] = {"serve": 0,
                                      "train": train_launches["bag_grad"]}
    kernels.append(grad_entry)
    del flush, gidx
    torch.cuda.empty_cache()

    resume_smoke()

    counters = (kernel.launches, kernel.bag_grad_launches, bm_kernel.launches,
                cin_kernel.launches, hg_kernel.launches, rq_kernel.launches)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    online_dequant, online_logits, online_recs = {}, {}, {}
    for arch in ONLINE_ARCHS:
        served, launches, online_logits[arch] = serve_online(
            torch, serve, kernels_mod, counters, arch)
        online_recs[arch] = served.record
        rowgrid_by_path[f"online_{arch}"] = dict(kernel.rowgrid_launches)
        online_dequant[arch] = dict(kernel.launches)
        quant_by_path[f"online_{arch}"] = launches["quantize_rowwise"]
        print(json.dumps(served.record), flush=True)
        kernels.append(measure_bag_matmul(torch, served, arch,
                                          launches["bag_matmul"], flush,
                                          worst_bm))
        if arch == "xdeepfm":
            kernels.append(measure_cin(torch, served, launches["cin"], flush,
                                       worst_cin))
            quant_entry["xdeepfm_chunk"] = measure_quantize_tier(
                torch, served, rq_kernel, rq_ref, flush)
        if args.trace:
            trace_online(torch, served, arch, 6, args.trace)
        del served
        torch.cuda.empty_cache()
    for k in kernels:
        if k["name"].startswith("dequant_bag["):
            dtype = k["name"][len("dequant_bag["):-1]
            for arch, counts in online_dequant.items():
                k["launches_by_path"][f"online_{arch}"] = counts[dtype]
            k["launches"] = sum(k["launches_by_path"].values())

    table = None
    hashed_by_path, fit_fwd = {}, []
    for bits in HASH_BITS:
        served, launches, by_entry = serve_hashed(torch, serve, kernels_mod,
                                                  bits)
        rowgrid_by_path[f"online_hashed_{bits}b"] = dict(
            kernel.rowgrid_launches)
        if table is None:         # the fit's target: the snapped table
            model = served.model
            table = serve.online_store(model, model.spec,
                                       torch.device("cuda"))[1].table
        rec = served.record
        path = f"online_hashed_{bits}b"
        hashed_by_path[path] = by_entry
        fit_grad, fwd = check_hashed_build(torch, served, table, bits,
                                           counters, flush)
        grad_entry.setdefault("fit_shapes", []).append(fit_grad)
        fit_fwd.append(fwd)
        res = H.fit_residual(served.server.backend.hs,
                             served.server.backend.hcfg, table)
        if not 0.0 < res < 1.0:
            raise SystemExit(f"hashed {bits}b: fit residual {res} outside "
                             "(0, 1)")
        rec["fit_relative_residual"] = res
        print(json.dumps({"hashed_fit": {
            "hash_bits": rec["hash_bits"], "fit_s": rec["fit_s"],
            "relative_residual": rec["fit_relative_residual"],
            "pool_slots": rec["pool_slots"],
            "store_bytes": served.server.backend.nbytes(),
            "hash_ratio": rec["hash_ratio"],
            "packed_fp32_ratio": rec["packed_fp32_ratio"]}}), flush=True)
        print(json.dumps(rec), flush=True)
        for entry in measure_hashed_gather(torch, served, by_entry, flush,
                                           worst_hg):
            entry["launches_at_start"] = (
                rec["build_kernel_launches"]["hashed_gather"])
            entry["launches_in_requests"] = (
                rec["kernel_launches"]["hashed_gather"])
            kernels.append(entry)
        grad_entry["launches_by_path"][path] = launches["bag_grad"]
        if args.trace:
            trace_online(torch, served, f"wide-deep hashed {bits}b", 6,
                         args.trace, fuse_matmul=False)
        quant_by_path[path] = launches["quantize_rowwise"]
        del served
        torch.cuda.empty_cache()
    # the fit's pool is fp32 on both paths: its forward's launches and
    # times go to the float32 entries
    for k in kernels:
        if k.get("counter") is not None:
            k["launches_by_path"] = {path: counts[k["counter"]] for path,
                                     counts in hashed_by_path.items()}
            if k["name"].endswith("[float32]"):
                k["fit_shapes"] = [fwd["ids" if k["counter"].startswith(
                    "ids_") else "plan"] for fwd in fit_fwd]
    del table, flush
    torch.cuda.empty_cache()

    # the SHARK pipeline at full width (with its metrics stream, checked in
    # phase 13), then its hashed branch over the same 34,184,704 rows
    metrics_dir = tempfile.TemporaryDirectory()
    pipeline_metrics = os.path.join(metrics_dir.name, "pipeline.jsonl")
    pipeline_recs = {}
    for label, argv in (
            ("pipeline", ["--model", "full", "--max-ind-range",
                          str(PIPELINE_MAX_IND_RANGE), "--batch", "65536",
                          "--steps",
                          str(PIPELINE_STEPS), "--metrics-out",
                          pipeline_metrics]),
            ("pipeline_hashed", ["--model", "full", "--max-ind-range",
                                 str(PIPELINE_MAX_IND_RANGE),
                                 "--batch", "65536", "--steps",
                                 str(PIPELINE_STEPS), "--store-backend",
                                 "hashed"])):
        try:
            pipeline_recs[label], counts = pipeline_phase(
                torch, kernels_mod, kernel, pipeline, argv, label)
        finally:
            metrics_off()
        torch.cuda.empty_cache()
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts)

    # phase 13: the obs layer and the bench_qps/v1 record on the card
    _, counts = metrics_online(
        torch, serve, kernels_mod, counters, online_logits["wide-deep"],
        online_recs["wide-deep"],
        os.path.join(metrics_dir.name, "wide_deep.jsonl"))
    record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                "metrics_online_wide-deep", counts, arch="wide-deep")
    check_pipeline_metrics(pipeline_recs["pipeline"], pipeline_metrics,
                           pipeline.PipelineConfig().serve_requests)
    counts = bench_qps(torch, kernels_mod,
                       os.path.join(metrics_dir.name, "bench_qps.json"))
    record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                "bench_qps", counts)

    # phase 14: shadow re-tiers at full width, then their invariants on the
    # drained wide&deep server, then the async bench_qps/v1 record
    for arch in ONLINE_ARCHS:
        served, _, _ = serve_online(torch, serve, kernels_mod, counters,
                                    arch, shadow_rows=SHADOW_ROWS,
                                    requests=SHADOW_REQUESTS)
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    f"shadow_online_{arch}",
                    path_counts(kernels_mod, kernel, hg_kernel), arch=arch)
        print(json.dumps(served.record), flush=True)
        shadow_summary(served.record, online_recs[arch], served.server.stats)
        if arch == "wide-deep":
            shadow_invariants(torch, served)
        del served
        torch.cuda.empty_cache()
    counts = bench_qps(torch, kernels_mod,
                       os.path.join(metrics_dir.name, "bench_qps_async.json"),
                       retier_async=True)
    record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                "bench_qps_async", counts)
    metrics_dir.cleanup()

    # phase 15: the paper's tables and figures at full budgets; no kernel
    record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                "paper_tables", paper_tables(torch, kernels_mod))
    torch.cuda.empty_cache()

    # phase 16: bench_hash/v1 (the hashed train step), the offline QPS
    # proxy and the runner's --emit records
    with tempfile.TemporaryDirectory() as tmp:
        counts, train_shape = bench_hash(
            torch, kernels_mod, counters, os.path.join(tmp, "BENCH_hash.json"))
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    "bench_hash", counts)
        next(k for k in kernels if k["name"] == "hashed_gather[float32]")[
            "train_shape"] = train_shape
        torch.cuda.empty_cache()
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    "offline_qps", offline_qps(torch, kernels_mod))
        for label, counts in emit_records(torch, kernels_mod, tmp).items():
            record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                        label, counts)
    torch.cuda.empty_cache()

    # phase 17: the hierarchical store at full width, then bench_hier/v1
    for label, counts in hier_phase(torch, serve, kernels_mod,
                                    counters).items():
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts)
    torch.cuda.empty_cache()

    # phase 18: the serving fleet at full width, then its smoke record
    for label, counts in fleet_phase(torch, kernels_mod, counters).items():
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts,
                    arch=("xdeepfm" if "xdeepfm" in label else "wide-deep"
                          if "wide-deep" in label else "dlrm-rm2"))

    # phase 19: the mesh ((a) ran beside phase 4)
    mesh_summary, mesh_counts = mesh_phase(
        torch, serve, pipeline, kernels_mod, kernel, hg_kernel, setup_mod,
        counters, {arch: (online_logits[arch], online_recs[arch])
                   for arch in ONLINE_ARCHS}, train_rec["train"])
    print(json.dumps({"mesh": {"dlrm-rm2": mesh_dlrm_summary,
                               **mesh_summary}}), flush=True)
    for label, counts in {**mesh_dlrm_counts, **mesh_counts}.items():
        if label == f"mesh{MESH_N}_train":
            # the train step: the float32 forward and bag_grad only
            full = {k: 0 for k in mesh_dlrm_counts["mesh1_dlrm-rm2"]
                    if isinstance(mesh_dlrm_counts["mesh1_dlrm-rm2"][k],
                                  int)}
            full.update(counts)
            full["dequant_bag_by_dtype"] = {
                t: (counts["dequant_bag"] if t == "float32" else 0)
                for t in kernel.launches}
            full["hashed_gather_by_entry"] = {t: 0 for t in
                                              hg_kernel.launches}
            counts = full
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts,
                    arch=("xdeepfm" if "xdeepfm" in label else "wide-deep"
                          if "wide-deep" in label else "dlrm-rm2"))
    # phase 20: the kernel record, bag_matmul_train, the family smoke, the
    # examples
    for label, counts in kernel_record_phase(
            torch, serve, kernels_mod, kernel, bm_kernel, hg_kernel, hg_ops,
            counters, online_logits["wide-deep"],
            online_recs["wide-deep"]).items():
        # the record's bag_matmul launches go to the wide&deep entry
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts,
                    arch=("xdeepfm" if "xdeepfm" in label else "dlrm-rm2"
                          if label.startswith(("smoke_dlrm", "smoke_bert",
                                               "bert4rec", "example_",
                                               "autotune_dlrm"))
                          else "wide-deep"))
    # phase 21: the GNN and LM families at published widths (no kernel)
    for label, counts in families_phase(torch, kernels_mod, kernel,
                                        hg_kernel).items():
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts)
    # phase 22: the SPMD layer (the int8 gradient exchange's quantizer
    # launches go to quantize_rowwise)
    _, quant_entry["d256"], spmd_paths = spmd_phase(
        torch, kernels_mod, kernel, hg_kernel, rq_kernel, rq_ref,
        smi.splitlines()[0])
    for label, counts in spmd_paths.items():
        record_path(kernels, grad_entry, quant_by_path, rowgrid_by_path,
                    label, counts)
    for k in kernels:
        k["launches"] = sum(k["launches_by_path"].values())
    grad_entry["launches"] = sum(grad_entry["launches_by_path"].values())
    quant_entry["launches_by_path"] = quant_by_path
    quant_entry["launches"] = sum(quant_by_path.values())
    kernels.append(quant_entry)
    for entry, key in ([(e, "dequant_bag_rowgrid") for e in rowgrid_entries]
                       + [(grad_rg_entry, "bag_grad_rowgrid")]):
        # the oracles run on the kernel record's ladder only (phase 20(a):
        # dequant_bag_rowgrid at int8, counted under that entry)
        by_path = {path: counts[key] for path, counts
                   in rowgrid_by_path.items()}
        if key == "dequant_bag_rowgrid" and not entry["name"].endswith(
                "[int8]"):
            by_path["bench_kernel"] = 0
        entry["launches_by_path"] = by_path
        entry["launches"] = sum(by_path.values())
        elsewhere = {p: n for p, n in by_path.items()
                     if n and p != "bench_kernel"}
        if elsewhere or (key == "dequant_bag_rowgrid"
                         and entry["name"].endswith("[int8]")
                         and by_path["bench_kernel"] <= 0):
            raise SystemExit(f"{key} ran off the kernel record's path, or "
                             f"not on it: {by_path}")
        kernels.append(entry)
    # every kernel of a main path ran on it (the single-tier int8 / bf16
    # instances and the int8 plan entry run on none: the tiered and ids
    # entries took their places; the fp32 plan entry is the hashed train
    # step's forward)
    ran = {k["name"]: k["launches"] for k in kernels}
    for name in ("dequant_bag[tiered]", "dequant_bag[float32]", "bag_grad",
                 "bag_matmul[wide-deep]", "bag_matmul[xdeepfm]",
                 "cin[xdeepfm]", "hashed_gather[float32]",
                 "hashed_gather_ids[float32]",
                 "hashed_gather_ids[int8]", "quantize_rowwise"):
        if ran.get(name, 0) <= 0:
            raise SystemExit(f"{name} did not run on a main path: {ran}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
