#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpubloom_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

It builds the CUDA kernels from ``tpubloom_torch/csrc`` and drives the
port's three paths through the entry points a user calls: the main path, a
BlockedBloomFilter at m=2^32, k=7, block_bits=512 (512 MiB of state),
16-byte keys, batches of 2^23; the counting path, a
BlockedCountingBloomFilter at BASELINE config 4 (m=2^30 counters, k=7,
block_bits=512, 512 MiB of state, batches of 2^22, the parameters of
benchmarks/counting_rate.py); and the sharded path, a ShardedBloomFilter
at BASELINE config 5 (m=2^36, k=7, block_bits=512, 64 shards, 8 GiB of
state on one card, batches of 2^23, the parameters of
benchmarks/run.py:269-305) and its counting twin, configs 4 x 5 (m=2^30
counters over 64 shards, batches of 2^22); and the flat layout, each of
those filters in it (BloomFilter at BASELINE config 2, m=2^30 bits, k=10,
batches of 2^20; CountingBloomFilter at config 4; the flat sharded arrays
at configs 5 and 4 x 5, batches of 2^18 and 2^22); BASELINE config 3's
stream; a ScalableBloomFilter at RedisBloom's ``BF.RESERVE key 0.01
4194304 EXPANSION 2`` (blocked layers); and the sketch kinds at RedisBloom
deployments (a CuckooFilter of 2^24 slots, a CountMinSketch and a
TopKSketch at ``CMS.INITBYPROB key 0.000001 0.001``). Phases, one JSON
line each, with the seconds it took (``phase_seconds``):

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: ``nvcc`` seconds per kernel source, and ``g++`` seconds for the
   host library (``native/bloomhash.cpp``);
3. kernel vs plain: test-and-insert, insert and query at full width,
   through each CUDA kernel and through its plain PyTorch version on the
   same inputs; state and verdicts must be equal (tolerance 0); then
   again with ``block_hash="ap"`` at a smaller m; the test-and-insert also
   through the fused kernel (``blocked_test_insert.cu``) and through the
   two launches, each against the plain version, with the fused launch's
   keys a row tile against the plain partition's, on those batches and on
   two more above the crossover: one key over a quarter of a 2^23 batch
   at m=2^32, and 2^18 distinct keys on 128 rows (m=2^16, "ap");
4. main path: test-and-insert of Python ``bytes`` keys, within-batch
   duplicates, tail padding, ``insert_packed``/``include_packed`` at
   B=2^23, a replay that must report every key present, the FPR of fresh
   keys against ``params.blocked_fpr`` (the tolerance of
   tests/test_fpr_model.py), a test-and-insert of 2^23 fresh ``bytes``
   keys (its pre-batch hits held to the same FPR model; it takes the
   fused kernel where the crossover says so), and the staged API with
   ``InFlight`` over 4 batches — with every kernel's launch count read
   after it, and each operation's launches alone (``launches_per_op``);
5. times: CUDA events over warmed launches at B=2^23 for each kernel,
   its plain version and the nearest single PyTorch call, beside the
   least time the card could take for the same work (``bound_ms``: bytes
   over the memory rate, or 32-bit integer operations over the INT32
   rate, whichever is larger). The query's ``ms`` is on keys the filter
   does not hold, ``present_ms`` on keys it holds; its phase record (not
   the ``kernels`` line) adds ``floor_ms``, a second bound: the bytes of
   a query that reads every key's row once (no row shared).
   The insert's ``ms`` is a fresh insert: each launch has its own event
   pair, and before it, outside the pair, the state is restored from a
   snapshot and the L2 cache flushed, so every timed launch sets the
   bits of keys the filter does not hold yet, at the same fill;
   ``replay_ms`` re-inserts batches the filter already holds (no bit
   changes). Beside them, the distinct words and 32-byte sectors the
   launch's keys touch (summed a key) and their rates. The fused
   test-and-insert fresh and the two launches fresh, in turns, its
   replay, its plain version and its six kernels' own times; then
   ``test_insert_crossover``: both over B = 2^14 .. 2^23 fresh keys on the
   same state, in turns, and the keys a row from which the fused kernel
   is the faster (what ``sweep.BLOCKED_TEST_INSERT_CROSSOVER`` holds);
6. end to end: host-clock time of whole ``insert_packed`` /
   ``include_packed`` calls at B=2^23 and of a test-and-insert of 2^16
   Python ``bytes`` keys, split by the port's phase spans;
7. counting kernel vs plain: at config 4, an insert, a delete and a
   query of a batch of old keys, fresh keys, a quarter of the batch one
   repeated key and tail padding, through each counting kernel and its
   plain version from the same state (tolerance 0); again with the state
   as its logical ``[NB, W]`` view, and with ``block_hash="ap"`` at
   m=2^26 counters;
8. counting path: ``insert_packed`` / ``include_packed`` of 2^22 keys,
   ``delete_batch`` of 2^16 of them as ``bytes`` and ``include_batch``,
   and a fresh filter that returns to all-zero words after inserting and
   deleting the same 2^22 keys, with the launch counts after each step;
9. counting times: CUDA events around each of ≥ 40 warmed launches of
   the insert, the delete (alternating, on the same batches, as
   benchmarks/counting_rate.py does), the query, and the insert and
   delete of a skewed batch, beside the bound, the plain versions and
   the update's touched words and sectors;
10. counting end to end: as phase 6, for the counting path's
   ``insert_packed`` / ``include_packed`` at B=2^22 and a
   ``delete_batch`` of 2^16 Python ``bytes`` keys;
11. checkpoint round trip: ``snapshot_blob`` -> ``restore_blob`` of a
   counting filter at config 4's m=2^30 counters (512 MiB; the payload's
   CRC32C made and checked on the card);
12. sharded kernel vs plain: at config 5, on one slot of all 64 shards and
   on a slot of shards 16-31, an insert and a query of old keys, fresh
   keys, within-batch duplicates and tail padding through each routed
   kernel and its routed plain version from the same state (tolerance 0,
   ``torch.equal`` on the card); then the routed counting kernels at
   configs 4 x 5 for an insert, a delete and a query;
13. sharded path: ``insert_packed`` / ``include_packed`` of 2^23 keys,
   ``insert_batch`` / ``include_batch`` of Python ``bytes`` keys, a
   replay that must report every key present, the FPR of fresh keys at
   m=2^26 over 64 shards, the same batches through a 4-slot layout on the
   same card (16 shards a slot) whose words must equal the 1-slot run's
   shard for shard, and the counting twin with ``delete_batch`` — with the
   launch counts after each step;
14. sharded times: as phases 5 and 9 for the four routed kernels on the
   1-slot state, and the routed query on the 4-slot layout's slot of
   shards 16-31 (bound over the keys that slot owns);
15. sharded end to end: as phase 6 for the 1-slot and the 4-slot filters
   (the latter split into ``kernel_shard<i>`` phases);
16. flat kernel vs plain: each flat kernel and its routed twin against its
   plain version from the same state (tolerance 0): config 2, config 1's
   m=10,000,000 (the mod walk), config 4 flat, one slot of config 5 flat
   and its slot of shards 16-31, the same two slots at m=2^26 (a dense
   sharded shape, which takes the partitioned insert), configs 4 x 5 flat
   on one slot and on the slot of shards 48-63; batches with old keys,
   within-batch duplicates, one key over an eighth of the batch (past
   saturation), tail padding and, for counting, a delete of absent keys;
   the counting pair also at 2^16 keys; each insert and counting op
   through the kernel the wrapper takes (recorded) and through the other
   one on a copy of the state, where the partition holds the shape, so that
   both kernels of each wrapper meet every shape;
17. flat path: the four flat filters through their entry points at full
   size (packed and ``bytes`` keys, a replay, deletes; 1 and 4 slots whose
   words must agree), the FPR of fresh keys against
   ``params.theoretical_fpr`` at m=2^26, and the Redis bitmap and
   checkpoint round trips at m=2^26 bits or 2^24 counters, with the
   launch counts after each step (config 2's ``insert_packed`` of 2^20
   keys must take ``flat_insert_tiled``, its ``insert_batch`` of 10,002
   ``bytes`` keys the thread-a-key ``flat_insert``; each insert and
   counting wrapper must have launched both of its kernels);
18. flat times: as phases 5 and 9 for the eight flat kernels and the six
   partitioned ones, beside the bound (the launch's distinct 32-byte
   sectors read, and written back by updates) and, for the queries, the
   gather ``words[widx]`` of the launch's B k words; the insert on both
   of its kernels (fresh, replay, a crowd), the routed partitioned insert
   at config 2's shape over 64 shards, the bit query with each group size
   of loads in flight (1, 2, 4) on absent and held keys, and the bit pair
   on config 2's own traffic (benchmarks/run.py config2: 100,000,000 keys
   inserted in batches of 2^20, to a fill of ~0.606; then a held and an
   absent batch queried in turns; then a fresh insert into that state);
   the counting pair on both of its kernels at the path's batch and at
   2^16 keys, on a crowd batch, and its query on held keys, on config 4's
   own traffic (benchmarks/run.py config4: 10,000,000 keys inserted, half
   deleted, all queried in one launch) and on a filter half full, with the
   partition (tiles touched, scratch bytes, sweep CTAs); at 2^16 keys also
   the wrappers' host clock per call;
19. flat crossover: both kernels of the flat counting pair at config 4
   flat over B = 2^13 .. 2^22 (the query on half held, half absent keys,
   and on absent keys), both kernels of the flat insert at config 2 over
   B = 2^13 .. 2^20 (fresh inserts), and the batch (in positions per
   sector of the state) from which the partitioned one is the faster;
20. flat end to end: as phase 6 for the flat filters' packed calls;
21. checksum kernel vs plain: the checkpoint payload's kernel pair
   (``csrc/checksum.cu``: the payload's bytes, bit-reversed for the Redis
   bitmap or raw words, and their CRC32C) against its plain version on
   the same random words on the card, tolerance 0, at config 3's m=2^34
   (2 GiB) and config 1's m=10,000,000, both formats; both against the
   host CRC32C over the host's Redis bitmap on a 64 MiB slice; times at
   2 GiB beside the bound, the plain version's time and numpy's CRC32C on
   8 MiB (scaled to 2 GiB, and so labelled);
22. stream, BASELINE config 3 (benchmarks/run.py:203-230): a flat
   BloomFilter at m=2^34 bits, k=7, 28-byte keys, fed
   ``b"warc-record-%014d" % i`` by a ``StreamInserter`` in batches of 2^16
   with a FileSink checkpoint every n/10 keys (n cut from 10^9 to 2^25:
   ``reduced``); keys a second, the spans (``host_prep``, ``h2d``,
   ``kernel``), each checkpoint's duration and the triggers refused while
   one was in flight, against the same stream with no sink (the stall);
   ``close()`` must be durable, the restored words (on the card) equal
   the live ones, ``resume_offset`` n, 2^20 sampled stream keys present
   and 2^20 fresh keys within the FPR model; ``prefetch=4`` on 2^22 keys
   must leave the words of ``prefetch=0``; a short ``utils.tracing``
   window lists the top device ops. Its FileSink directory is
   ``.stream_sink/`` in the checkout, checked for room for five 2 GiB
   blobs first and removed at the end;
23. scalable path: a ScalableBloomFilter at ``BF.RESERVE key 0.01 4194304
   EXPANSION 2`` on blocked layers (block_bits 512, chunk hash, 16-byte
   keys), 2^25 ``bytes`` keys through ``insert_batch`` in calls of 2^20
   that straddle the growth boundaries, four layers (m = 2^26 .. 2^29, 120
   MiB); 2^20 held keys (all present) and 2^20 absent ones (FPR within
   the compound bound, with tests/test_fpr_model.py's tolerance); an
   ``AsyncCheckpointer`` + ``FileSink`` checkpoint restored on the card
   with every layer's words equal; a flat-layer stack at capacity 2^20;
   launch counts read after each stack;
24. sketch path: a CuckooFilter at m = 2^24 slots filled to 0.90 load in
   batches of 2^16, then 2^20 keys more (FULL keys and kicks, both > 0;
   accepted keys equal occupied slots), 2^20 held and absent keys queried,
   2^16 deleted (all found); a CountMinSketch at ``CMS.INITBYPROB key
   0.000001 0.001`` (width 2,718,304, depth 7) fed a Zipf(1.1) stream of
   2^24 unit increments and 2^12 weighted ones, every id's estimate at or
   above its exact count, with the share above e / width · N; a
   TopKSketch (top 100) on the same grid whose list the stream's heaviest
   key leads; launch counts read after the three (the stream's batches of
   2^20 take ``cms_update_tiled`` and the estimate check's
   ``cms_estimate_rows``, the weighted and top-k batches the thread-a-key
   ``cms_update`` and ``cms_estimate``);
25. sketch kernel vs plain: each sketch kernel against its plain version
   on a CPU copy of the same state and keys, tolerance 0: the cuckoo pair
   at 2^16 slots with an overfill batch, and a 2^12-key batch on a copy of
   the filled 2^24-slot table; the count-min pair at the path's width and
   batch (2^20) with duplicates and weights near 2^32, the update through
   each of its kernels (the thread-a-key one and the partitioned one, whose
   entries a tile are also held against the plain partition), the estimate
   through each of its kernels (a thread a key, row-phased);
26. sketch times: each sketch kernel's ms at the path's shapes (the
   cuckoo walks 2^16 keys on the filled table, the insert also at a
   quarter load, by CUDA events; the count-min update 2^20), its result
   held against its plain version run from the same state (tolerance 0),
   beside its bound (bytes: each distinct sector the plain walk reads and
   each the batch changes), the cuckoo walk's latency floor (a dependent
   read a key and a kick step, at the latency a one-thread pointer chase
   measures in an L2-resident buffer; also over 64 MiB after an L2
   flush), the walk with its prefetch lanes against one thread alone, in
   turns, its plain version's ms and, for the count-min update,
   ``index_add_`` on the same positions. The update's two kernels and
   ``index_add_`` are timed in turns on the path's Zipf batch and on a
   batch of 2^20 distinct ids, with what each batch puts in the tiles, and
   the thread-a-key kernel on a grid of 2^18 x 7 counters (7 MiB, held in
   L2) beside the path's. The two queries (``query_times``, also alone
   with ``--queries``) by the card's own time (the profiler's, ``ms``)
   beside their call time by CUDA events (``call_ms``) and the launch
   floor (an empty launch through the same ctypes path): the cuckoo query
   on 2^16 held and fresh keys; the estimate's two kernels and
   ``index_select`` + ``amin`` on the path's Zipf batch and 2^12, 2^16 and
   2^20 distinct ids in turns, on the 7 MiB grid, on a 761 MB grid
   (27,182,848 x 7, a row larger than the L2), and on batches an octave
   apart from 2^12 to 2^20 of both kinds: what ``sweep.CMS_ROWS_CROSSOVER``
   is set from;
27. count-min crossover: both update kernels over unit batches of the Zipf
   stream, half an octave apart, in turns, on four grids: ``CMS.INITBYDIM
   key 2000 5`` (2,016 x 5), ``CMS.INITBYPROB key 0.00001 0.001``
   (271,840 x 7), the path's and ``CMS.INITBYPROB key 0.0000001 0.001``
   (27,182,848 x 7); on each the batch (in positions, and positions a
   sector of the grid) from which the partitioned one is the faster, and
   whether ``sweep.cms_takes_tiles`` picks the faster kernel at each batch:
   what ``sweep.CMS_TILE_CROSSOVER`` (positions) is set from;
28. server path: the port's gRPC server (``tpubloom_torch.server``) on
   the card with the ingest coalescer at up to 2^19 keys a flush; the
   main path's filter created over gRPC; 2^23 keys inserted as 128
   ``InsertBatch`` requests of 2^16, fixed-width frames of the rows sent
   by 8 ``BloomClient`` threads in 4 client processes, then 2^20 held and
   2^20 fresh keys queried the same way, each part's keys/s on the host
   clock beside the card's own time in it (``torch.profiler``), the
   flushes and keys a flush, and the dispatcher's time in the flushes; a
   presence batch (and the kernels its flush launched), a ``Checkpoint``
   restored by a second service, and the CF / CMS verbs; every result
   held against a filter or sketch fed the same keys directly (words with
   tolerance 0);
29. durable path: the op log, replication and tenant residency
   (``tpubloom_torch.repl``, ``tpubloom_torch.storage``) on the card, in
   this process, with the client processes of phase 28's design. A: a
   primary with an op log and a sink fills 8 tenants of m=2^30 and a
   counting tenant of 2^28 counters (128 MiB each) with 2^19 keys each
   (``cnt`` 2^20; the tenants' fill cut from 2^20, ``DUR_CUTS``),
   and a read-only replica takes the full resync: its seconds and bytes,
   split into the primary's snapshot (the copy and ``payload_crc32c``, the
   D2H, the framing), the replica's install (``bytes_crc32c`` and the
   restore's H2D) and the rest (the transfer). B: the main path's filter
   created with the replica attached, 2^23 keys as 128 ``InsertBatch``
   requests of 2^16 under ``min_replicas=1`` with the stream killed once
   (``repl.stream_send``), one more counting batch; keys/s beside phase
   28's, the appends' seconds and their host CRC32C's share, the replica's
   lag, the partial resyncs; the main path's keys queried at the replica
   and at the primary. C: the primary stopped as a crash leaves it (no
   final checkpoints) and a fresh service replaying its log: seconds and
   records/s. D: 128 tenants of m=2^27 (2 GiB) on a 512 MiB budget with a
   512 MiB warm pool, 2^15 keys each (cut from 2^16), then 2^22 keys
   inserted and 2^21 queried in requests of 2^14 to tenants picked by
   Zipf(1.1), sheds retried after their hint; evictions, WARM and COLD
   hydrations with their p50 / p99 ms, ``memory_allocated`` after every
   eviction against the budget plus two tenants plus the coalescer's
   staging; then a restart over the same directories. The replica's words equal the
   primary's, the replayed words the stopped primary's, every tenant and
   verdict a direct filter's (tolerance 0); ``blocked_insert``,
   ``blocked_query``, ``blocked_counting_update`` and ``payload_crc32c``
   launched on both the primary's side and the replica's. D's peak
   ``memory_allocated`` over the traffic and over the restart are read
   too, each with the work in flight when it rose;
30. HA path: high availability (``tpubloom_torch.ha``, the sentinel) on
   the card, in this process, with the client processes of phase 28's
   design (``BloomClient(sentinels=...)``, a failed request re-driven
   with its own rid). A primary with an op log, a FileSink and the
   coalescer at 2^19 keys a flush; two chained replicas (each with its
   own op log and announced address); three sentinels at the CLI's
   defaults (poll 0.25 s, down after 1.5 s, quorum 2). With both
   replicas attached, a counting tenant ``cnt`` of 2^28 counters and the
   main path's filter "chunk" (m=2^32) are created; 2^23 keys go to
   "chunk" as 128 ``InsertBatch`` requests of 2^16 with a ``cnt`` batch
   of 2^12 after every fourth, and the primary is crashed as phase 29's C
   stops it after 64 acknowledged ones (the sentinels' Health probes of
   its address are recorded from then on). On the host clock: the crash
   to SDOWN, to ODOWN, to ``Promote`` answered and to the first write the
   new primary acknowledged; the ``Promote`` RPC's own ms; the winner
   and both cursors; the survivor's resync kind and records; the new
   primary's keys/s; the re-drives; launches of ``blocked_insert``,
   ``blocked_query`` and ``blocked_counting_update`` by node. Held with
   tolerance 0: every ``cnt`` batch re-driven with its rid (and each
   "chunk" request the old primary acknowledged that the new one lacks),
   then every key present and one delete a batch leaves every counter 0;
   the new primary's "chunk" equals a filter fed every key and the survivor's
   words the new primary's (and their verdicts a direct filter's); the
   crashed primary restarted from its log is fenced by the sentinels
   (a replica at the new epoch, writes READONLY), with its resync's kind:
   a partial one ends with words equal to the new primary's, a full one
   is refused by the 256 MiB message cap at "chunk"'s blob, the node stays
   fenced, and ``cnt``, which the resync carried, equals the new
   primary's.
31. cluster path: cluster mode (``tpubloom_torch.cluster``) on the card,
   in this process, with the client processes of phase 28's design, each
   thread a ``ClusterClient``. Three nodes N0-N2, each a
   ``BloomService(cluster=ClusterState(...))`` with an op log, a FileSink,
   the coalescer at 2^19 keys a flush and its ``/metrics``, seeded by
   ``python -m tpubloom_torch.cluster init``, and an empty N3. The main
   path's filter "chunk" (m=2^32); ``{t0}blk`` (m=2^30) and ``{t0}cnt``
   (2^28 counters) on one slot of a node that does not own "chunk"; four
   blocked tenants t1-t4 at m=2^30, so that every node holds a filter.
   Under 2^23 keys into "chunk" as 128 ``InsertBatch`` of 2^16, 24
   batches of 2^16 into ``{t0}blk`` and each of t1-t4, and a ``{t0}cnt``
   batch of 2^12 after every fourth chunk request, the CLI migrates
   ``{t0}``'s slot with ``cluster.migrate_send`` armed at ``nth:3`` (it
   fails after ``{t0}blk`` landed), again (``{t0}blk`` resumes by the
   op-log tail, ``{t0}cnt`` goes by snapshot), then t1's slot;
   ``rebalance --plan-only`` pushes the freshest map after each; then t2's
   slot on the quiet cluster, and ``rebalance --plan-only`` and ``info``
   over N0-N3. On the host clock: keys/s before, in and after each
   migration window beside phase 28's rate, each node's dispatcher busy
   share, each migration's seconds and the clean ones' split (snapshot:
   the copy, ``payload_crc32c``, D2H, framing; transfer; install: the CRC
   copy, H2D, the seeded checkpoint; finalize), tail records, forwards and
   ``IMPORT_NOT_READY`` answers, the writes' p50 / p99 latency outside and
   inside the windows, the clients' MOVED / ASK hops and re-drives,
   ``memory_allocated`` around each migration, launches by node, and the
   ``cluster_*`` counters of one merged scrape (``python -m
   tpubloom_torch.obs.aggregate --once`` over N0-N3 and a dead address,
   which must read up 0). Held with tolerance 0: every filter at its
   owner equals a filter fed every acknowledged key (and its verdicts a
   direct filter's), every ``{t0}cnt`` key present and one delete a batch
   empties it, each source answers MOVED and holds no copy, every node's
   view agrees, and no client request failed. Last, ``MigrateSlot`` of
   "chunk"'s slot, refused by the 256 MiB message cap: its answer, the
   slot's marks on both nodes, and what a query and an insert of "chunk"
   then answer.
32. distributed path: the sharded filter over processes
   (``tpubloom_torch.parallel.distributed``). A one-process
   ``ShardedBloomFilter`` at config 5 (64 shards, 8 GiB, one slot)
   inserts a seeded batch of 2^23 keys and queries them with 2^23 fresh
   ones; then two ranks, each a process joined by ``initialize_multihost``
   over gloo on localhost, each holding its 32 shards (4 GiB) on the one
   card, make the same calls with the verdicts all-reduced (``MAX`` over
   ``uint8``) through gloo on CUDA tensors; then one NCCL rank (world size
   1, ``env://``) holding all 64; with two cards or more, two NCCL ranks,
   one a card (else ``multi_card`` says unverified). Held with tolerance
   0: each rank's shard CRC32Cs (``payload_crc32c``) and popcounts, and
   its all-reduced verdicts, against the one-process filter's; each rank
   launched ``sharded_blocked_insert`` and ``sharded_blocked_query``. On
   the host clock: each rank's and the reference's insert and query
   keys/s, and the all-reduce alone at the query's length.
33. CPU driver path: the CPU driver (``tpubloom_torch.cpu_ref`` on the
   host C++ library, ``native/bloomhash.cpp``, built by ``g++`` in phase 2)
   held against the card's kernels with tolerance 0. The main path's
   filter (m=2^32, k=7, block_bits=512, 16-byte keys, ``block_hash``
   "auto") takes two batches of 2^23 keys through ``insert_batch(...,
   return_presence=True)`` (the second half keys of the first; the fused
   ``blocked_test_insert``), and ``CPUBlockedBloomFilter(use_native=True)``
   the same batches, its ``include_batch`` before each insert giving the
   pre-batch verdicts: the 512 MiB ``to_bytes()``, the presence verdicts
   and 2^20 fresh keys' verdicts (``blocked_query``) equal, the FPR drift
   vs the CPU driver 0 exactly, beside ``params.blocked_fpr``. BASELINE
   config 1 (m=10,000,000, k=7, 10^6 16-byte keys): the flat
   ``BloomFilter`` and ``CPUBloomFilter`` with the C++ and the numpy
   path, words and verdicts equal, each one's insert and query keys/s on
   the host clock. A flat ``CountingBloomFilter`` at 2^24 counters
   against ``CPUBloomFilter(counting)``: 2^20 inserts (16 keys 20 times
   each, past saturation), 2^18 deletes (those 18 times, and absent keys),
   counters and verdicts equal after each. ``ScalableBloomFilter``
   against ``CPUScalableBloomFilter`` at ``BF.RESERVE key 0.01 4194304
   EXPANSION 2`` with 2^23 keys: two layers, each layer's words and the
   verdicts equal. ``pack_keys``'s C++ and numpy scatters in turns, 5
   rounds each at 2^16 and 2^23 keys, host ms.

Then the ``nvidia-smi`` line, the ``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the run
exits non-zero without that line; it also fails when no CUDA device is
present. The full record is written to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --sketch`` runs the device, build and phases 24-27
only and writes ``chiprun_out/chip_smoke_sketch.json``; ``--server`` runs
the device, build and phase 28 only and writes
``chiprun_out/chip_smoke_server.json``; ``--durable`` the device, build
and phase 29 only, to ``chiprun_out/chip_smoke_durable.json``; ``--ha`` the
device, build and phase 30 only, to ``chiprun_out/chip_smoke_ha.json``; ``--cluster``
the device, build and phase 31 only, to ``chiprun_out/chip_smoke_cluster.json``;
``--distributed`` the device, build and phase 32 only, to
``chiprun_out/chip_smoke_distributed.json``; ``--cpu-ref`` the device,
build and phase 33 only, to ``chiprun_out/chip_smoke_cpu_ref.json``. Two other modes
compare kernel builds on one card:

    python3 chip_smoke.py --times         # device, build, phases 5, 9, 14, 18, 19
    python3 chip_smoke.py --host          # device, build, the flat counting wrappers' host clock
    python3 chip_smoke.py --ab DIR        # --times in DIR, here, here, DIR; --host in turns
    python3 chip_smoke.py --ab DIR --host # --host in DIR and here in turns only
    python3 chip_smoke.py --queries       # device, build, phase 24, the two query kernels' times
    python3 chip_smoke.py --ab DIR --queries  # --queries in DIR, here, here, DIR

``--queries`` runs phase 24 and the two queries' times (``query_times``)
and ends with one JSON line of them; ``--ab DIR --queries`` runs it in
DIR (with this script copied in), here, here and DIR, each in a process
of its own, to ``chiprun_out/ab_queries.json``.
``--times`` fills the filters as the full run does before its timing
phases and ends with one JSON line of the kernels' times. ``--ab`` copies
this script into DIR (another checkout of the repository, for example a
parent commit unpacked with ``git archive``), runs ``--times`` in DIR,
here, here and DIR in turn, and writes the four runs to
``chiprun_out/ab_times.json``; then ``--host`` (the flat counting
wrappers' host clock per call at 2^16 keys, each tree in fresh processes)
in DIR and here, three times in turns, to ``chiprun_out/ab_host.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpubloom_torch import BlockedBloomFilter, BlockedCountingBloomFilter, FilterConfig
from tpubloom_torch import ShardedBloomFilter, checkpoint
from tpubloom_torch.obs import context as obs
from tpubloom_torch.ops import _build, blocked, counting, sweep
from tpubloom_torch.ops.hashing import ShardRoute
from tpubloom_torch.params import blocked_fpr, theoretical_fpr

try:  # the flat layout; `--ab` runs this script in trees that predate it
    from tpubloom_torch import BloomFilter, CountingBloomFilter
    from tpubloom_torch.ops import bitops
except ImportError:
    BloomFilter = CountingBloomFilter = bitops = None
try:  # the stream path (BASELINE config 3); the same for trees that predate it
    from tpubloom_torch import StreamInserter, resume_offset
    from tpubloom_torch.ops import checksum
    from tpubloom_torch.utils import tracing
    from tpubloom_torch.utils.crc32c import crc32c
    from tpubloom_torch.utils.packing import words_to_redis_bitmap
except ImportError:
    StreamInserter = resume_offset = checksum = tracing = None
try:  # the scalable filter and the sketch kinds; the same for trees that predate them
    from tpubloom_torch import CountMinSketch, CuckooFilter, ScalableBloomFilter, TopKSketch
    from tpubloom_torch.obs import counters as obs_counters
    from tpubloom_torch.ops import cms as ops_cms
    from tpubloom_torch.ops import cuckoo as ops_cuckoo
except ImportError:
    CountMinSketch = CuckooFilter = ScalableBloomFilter = TopKSketch = None
try:  # the CPU driver and the host library; the same for trees that predate them
    from tpubloom_torch import CPUBlockedBloomFilter, CPUBloomFilter, CPUScalableBloomFilter
    from tpubloom_torch import native
    from tpubloom_torch.utils.packing import scatter_joined
except ImportError:
    CPUBlockedBloomFilter = CPUBloomFilter = CPUScalableBloomFilter = native = None

SEED = 20260
LOG2M, K, BLOCK_BITS, KEY_LEN = 32, 7, 512, 16
B = 1 << 23
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (HBM3) bandwidth
# H100 SXM 32-bit integer rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# clock (NVIDIA Hopper architecture white paper), an instruction an op
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations per key that each function needs (the same
# count whatever the kernel's design), at L=16, k=7: murmur3_32 over four
# words is 4 x 11 (mul, rotate as 3, mul, xor, rotate, mul-add as 2) plus
# 10 of finalisation, 54, three passes (h_a, h_b, g_b) 162; fnv1a over 16
# bytes, 4 a byte, 64; k chunk slices, 4 each, 28: hashing 254. Then a
# query's k bit tests (word index, shift, and, compare), 28; an insert's k
# bit sets into the row's mask (word index, shift, or), 21; a counting
# update's k saturating nibble adds (extract as 2, add, min, insert as 3),
# 49; a counting query's k nibble tests, 28. A routed kernel adds the
# routing pass, one murmur3 (54), for every valid key, and the rest only
# for the keys its slot owns.
OPS_HASH, OPS_ROUTE = 162 + 64 + 28, 54
OPS_QUERY, OPS_INSERT = OPS_HASH + 28, OPS_HASH + 21
OPS_TEST_INSERT = OPS_HASH + 28 + 21  # a test-and-insert: the tests and the sets
# The fused test-and-insert and the two launches are compared over these
# batches on the main path's filter (keys a row: B / 2^23).
LOG2B_TEST_INSERT = range(14, 24)
OPS_COUNT_UPDATE, OPS_COUNT_QUERY = OPS_HASH + 49, OPS_HASH + 28
# BASELINE config 4, as benchmarks/counting_rate.py:31-42 sets it; the
# `ap` comparison is cut (see its phase); the checkpoint round trip runs at
# config 4's 512 MiB since its payload's CRC32C is made on the card
LOG2M_COUNTING, B_COUNTING = 30, 1 << 22
LOG2M_COUNTING_AP, B_COUNTING_AP = 26, 1 << 20
LOG2M_CHECKPOINT, B_CHECKPOINT = 30, 1 << 20
# BASELINE config 5, as benchmarks/run.py:269-305 sets it (--layout
# blocked), and its counting twin, configs 4 x 5; nothing cut. The FPR
# check runs at m=2^26 (λ=64 keys a block), where the model predicts
# enough hits; the 4-slot layout lays 16 shards a slot on the same card.
LOG2M_SHARDED, SHARDS, B_SHARDED = 36, 64, 1 << 23
LOG2M_SHARDED_COUNTING, B_SHARDED_COUNTING = 30, 1 << 22
LOG2M_SHARDED_FPR, N_SLOTS = 26, 4
# The flat layout, each path at its benchmark settings (benchmarks/run.py,
# whose default --layout is flat for configs 2, 4 and 5), nothing cut:
# config 2 (run.py:69-93), m=2^30 bits, k=10, B=2^20 (run.py:93); config
# 1's shape (run.py:39-48), m=10,000,000, k=7, for the mod walk, kernel vs
# plain only; config 4 (run.py:233-266), m=2^30 counters, k=7, B=2^22 as
# the blocked counting path; config 5 (run.py:269-305), m=2^36 over 64
# shards, k=7, B=2^18 (run.py:289), one slot and the 4-slot layout; configs
# 4 x 5, m=2^30 counters over 64 shards, B=2^22. The FPR checks, the Redis
# bitmap and the checkpoint round trips run at m=2^26 bits or 2^24
# counters: a fuller filter for the FPR model, and numpy bit reversal and
# CRC32C loops over the host copy for the round trips.
LOG2M_FLAT, K_FLAT, B_FLAT = 30, 10, 1 << 20
M_FLAT_MOD, K_FLAT_MOD = 10_000_000, 7
LOG2M_FLAT_COUNTING, B_FLAT_COUNTING = 30, 1 << 22
LOG2M_FLAT_SHARDED, B_FLAT_SHARDED = 36, 1 << 18
LOG2M_FLAT_SMALL, LOG2M_FLAT_SMALL_COUNTING = 26, 24
N_FLAT_FPR, N_FLAT_ROUND_TRIP = 1 << 22, 1 << 18  # keys the cut filters take
# The flat counting pair has two kernels each, chosen by the batch's shape
# (sweep.flat_takes_tiles): the partitioned one at the counting paths' 2^22
# keys, the thread-a-key one at a delete_batch of 2^16 keys (PERF.md
# section 5). Both are held and timed at both sizes, and the crossover
# between them is measured over B = 2^13 .. 2^22 at config 4 flat.
B_FLAT_SPARSE = 1 << 16
LOG2B_CROSSOVER = range(13, 23)
# The query is also timed on config 4's own traffic (benchmarks/run.py
# config4, scale 1: insert n = 10,000,000 keys, delete the first half, query
# all n), each call one launch padded to 2^24 keys as the port pads it.
N_CONFIG4 = 10_000_000
# The flat bit insert's kernels are compared over B = 2^13 .. 2^20 at config 2
# (fresh inserts), and the bit pair is timed on config 2's own traffic
# (benchmarks/run.py config2, scale 1: 100,000,000 keys inserted in batches
# of 2^20, then queries of a held and an absent batch in turns). The query
# kernel's loads in flight a key are timed at each of QUERY_GROUPS.
LOG2B_BIT_CROSSOVER = range(13, 21)
N_CONFIG2 = 100_000_000
QUERY_GROUPS = (1, 2, 4)
# The wrappers' host clock at B_FLAT_SPARSE keys: calls a measurement, and
# rounds of measurements in a --host process.
N_HOST_CALLS, N_HOST_ROUNDS = 2000, 3
HOST_SCRATCH_BYTES = 1 << 28  # a device allocation the size of a partitioned update's scratch
# The query is also timed on the config 4 flat filter filled to about half
# of its counters non-zero (25 more batches of 2^22 keys made on the card):
# a filter near its capacity, where an absent key has fewer zero counters.
N_HALF_FULL_BATCHES = 25
# 32-bit integer operations a key of the flat kernels: the four base
# hashes (three murmur3 passes, 162, and fnv1a, 64), then a position's
# 64-bit walk step, mask, word index and bit (8), or nibble (11).
OPS_FLAT_HASH, OPS_FLAT_BIT, OPS_FLAT_COUNTER = 162 + 64, 8, 11
# BASELINE config 3 (benchmarks/run.py:203-230): the Common Crawl WARC
# record-ID stream, m=2^34 bits (2 GiB), k=7, 28-byte keys, batches of
# 2^16, a FileSink checkpoint every max(n / 10, 2^16) keys. The stream is cut
# from 10^9 keys to 2^25 by the run's time limit (the host makes and packs
# ~0.4 us a key); state, k, key width and batch stay as published. The
# prefetch run streams 2^22 keys; 2^20 stream keys are sampled back, and
# 2^20 fresh keys probe the FPR.
LOG2M_STREAM, K_STREAM, KEY_LEN_STREAM, B_STREAM = 34, 7, 28, 1 << 16
N_STREAM, N_STREAM_PUBLISHED = 1 << 25, 1_000_000_000
N_STREAM_PREFETCH, STREAM_PREFETCH, N_STREAM_PROBE = 1 << 22, 4, 1 << 20
TRACE_BATCHES = 8  # the batches of the stream's trace window
STREAM_DIR = Path(__file__).resolve().parent / ".stream_sink"  # git-ignored; removed at the end
# The checksum kernels at config 3's 2 GiB and config 1's m=10,000,000; the
# host CRC32C on a 64 MiB slice, numpy's rate on 8 MiB (a Python loop over
# 8-byte blocks). Their operations: a word's xor, four table lookups (shift,
# mask, address, load), and the lane's shift, 32 steps of 4 ops a 128 bytes.
CRC_SLICE_WORDS, NUMPY_CRC_BYTES = 1 << 24, 8 << 20
OPS_CRC_WORD = 1 + 4 * 4 + 32 * 4 // 32
# The scalable filter at RedisBloom's `BF.RESERVE key 0.01 4194304 EXPANSION
# 2` (the default expansion; tightening 0.5, as Almeida et al. 2007) on
# blocked layers at the main path's layout (block_bits 512, chunk hash,
# 16-byte keys): 2^25 keys in insert_batch calls of 2^20 bytes keys, the
# first half a call, push four layers (m = 2^26 .. 2^29, k = 7 .. 10, 120
# MiB); 2^20 held and 2^20 absent keys queried. A flat-layer stack is cut to
# a capacity of 2^20 (2^22 keys, 3 layers).
SCALABLE_CAPACITY, SCALABLE_ERROR, SCALABLE_GROWTH = 1 << 22, 0.01, 2
N_SCALABLE, B_SCALABLE, N_SCALABLE_PROBE = 1 << 25, 1 << 20, 1 << 20
SCALABLE_FLAT_CAPACITY, N_SCALABLE_FLAT = 1 << 20, 1 << 22
# The cuckoo filter at `CF.RESERVE key 16000000`: m = 2^24 slots (64 MiB), 4
# a bucket, 32 kicks, 16-byte keys, filled to 0.90 load in batches of 2^16,
# then 2^20 keys more (FULL keys and kicks); 2^20 held and absent keys
# queried, 2^16 deleted.
LOG2M_CUCKOO, B_CUCKOO, CUCKOO_FILL = 24, 1 << 16, 0.90
N_CUCKOO_OVERFILL, N_CUCKOO_PROBE, N_CUCKOO_DELETE = 1 << 20, 1 << 20, 1 << 16
# The count-min sketch at `CMS.INITBYPROB key 0.000001 0.001`: width
# ceil(e / 0.000001) = 2,718,282, rounded up to a whole number of u32 words
# as tpubloom's server rounds it (CMSInitByDim), 2,718,304 (not a power of
# two: the mod walk); depth ceil(ln(1 / 0.001)) = 7; 72.6 MiB. Fed 2^24 unit
# increments of a Zipf(1.1) stream over 2^24 ids in batches of 2^20, and
# 2^12 weighted increments; top-k (`TOPK.RESERVE key 100`) on the same grid,
# 4 batches of 2^16 of the stream.
CMS_WIDTH, CMS_DEPTH = 2_718_304, 7
N_CMS, B_CMS, CMS_ZIPF, CMS_DISTINCT = 1 << 24, 1 << 20, 1.1, 1 << 24
N_CMS_WEIGHTED, CMS_MAX_WEIGHT = 1 << 12, 1000
# The count-min update's kernels are timed in CMS_TURNS rounds of turns; the
# thread-a-key kernel also on a grid of 2^18 x 7 counters (7 MiB), which the
# 50 MB L2 holds. The crossover: grid name -> (width, depth, the unit
# batches' log2 range, in half octaves); the widths are tpubloom's, rounded
# up to 32.
CMS_TURNS, LOG2_CMS_L2_WIDTH = 3, 18
CMS_CROSSOVER_GRIDS = {
    "CMS.INITBYDIM key 2000 5": (2_016, 5, (8, 20)),
    "CMS.INITBYPROB key 0.00001 0.001": (271_840, 7, (10, 20)),
    "CMS.INITBYPROB key 0.000001 0.001": (CMS_WIDTH, CMS_DEPTH, (13, 20)),
    "CMS.INITBYPROB key 0.0000001 0.001": (27_182_848, 7, (14, 22)),
}
TOPK, B_TOPK, N_TOPK_BATCHES = 100, 1 << 16, 4
M32 = 0xFFFFFFFF
L2_FLUSH_BYTES = 128 << 20  # read between fresh launches: 2.5 x the H100's 50 MB L2
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
AB_HOST_TURNS = 3  # --ab: --host in the other tree and here, this many times in turns
RECORD: dict = {"profiler_misses": 0}
_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the previous line."""
    now = time.perf_counter()
    kw["phase_seconds"] = now - _LAST_EMIT[0]
    _LAST_EMIT[0] = now
    RECORD[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rows(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, KEY_LEN), dtype=np.uint8)


def max_abs_err(a: torch.Tensor, b: torch.Tensor, step: int = 1 << 26) -> int:
    """Largest |a - b| over two tensors of the same integer values
    (state words read as u32, verdicts as 0/1), in slices so that the
    int64 copies stay small on an 8 GiB state."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0
    for s in range(0, a.numel(), step):
        x, y = a[s : s + step].to(torch.int64), b[s : s + step].to(torch.int64)
        if a.dtype == torch.int32:
            x, y = x & M32, y & M32
        worst = max(worst, int((x - y).abs().max()))
    return worst


def clone_u32(t: torch.Tensor) -> torch.Tensor:
    """A copy of a uint32 tensor, made through its int32 view (uint32 has
    few kernels of its own in torch)."""
    return t.view(torch.int32).clone().view(torch.uint32)


def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean ms per call over ``n`` calls, by CUDA events, after ``warm``."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, n: int = 20, tries: int = 5) -> dict:
    """Mean ms a call of the card's own time in each kernel ``fn(i)``
    launches (by name, its argument list dropped), by ``torch.profiler``
    over ``n`` calls after one warm call: without the host's gaps, which
    the event pairs of a small launch include. Each kernel's time is its
    mean a launch times its launches a call (its events over ``n``,
    rounded), so that an event the window gains or loses at its edges does
    not count as a launch's worth of time. A window in which the profiler
    saw no device event is run again, after a pause, up to ``tries``
    times; then the result is empty."""
    fn(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        if attempt:
            time.sleep(0.2)
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        # device events only: a torch op's CPU event carries its kernels' time too
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        if seen:
            return {e.key.split("(")[0].removeprefix("void "):
                    e.self_device_time_total / e.count * max(1, round(e.count / n)) / 1e3
                    for e in seen}
    return {}


def device_ms(fn, n: int = 20):
    """Mean ms a call of the card's own time in the kernels ``fn(i)``
    launches (kernel_ms, summed), or None where the profiler saw no device
    event in any of its windows: that reading is unmeasured, and counted
    in ``RECORD["profiler_misses"]``. No other clock stands in for it."""
    ms = sum(kernel_ms(fn, n).values())
    if ms > 0:
        return ms
    RECORD["profiler_misses"] += 1
    return None


def fresh_ms(state: torch.Tensor, launch, n: int, warm: int = 2) -> float:
    """Mean ms of ``launch(i)`` over ``n`` launches (after ``warm``), each
    timed by its own CUDA event pair on the state as it is when called:
    before each launch, outside its pair, the state is restored from a
    snapshot and the L2 cache is flushed by a read, so every launch
    updates the same filter with keys it does not hold yet. The state is
    left as it was."""
    dst = state.view(torch.int32)
    snap = dst.clone()
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=state.device)
    pairs = []
    for i in range(warm + n):
        dst.copy_(snap)
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(i)
        end.record()
        if i >= warm:
            pairs.append((start, end))
    dst.copy_(snap)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def touched(rows: torch.Tensor, words: torch.Tensor, words_per_row: int,
            valid: torch.Tensor) -> dict:
    """Distinct words and distinct 32-byte sectors of each valid key's row
    update, summed over the keys: the atomics an update launch issues
    (one a word a key) and the L2 sector requests it needs when a key's
    atomics to one sector go out together. ``rows`` int64[B], each key's
    row in the state; ``words`` int64[B, k], the word of each of its k
    positions within that row; ``valid`` bool[B]."""
    g = (rows[:, None] * words_per_row + words)[valid]

    def distinct(x: torch.Tensor) -> int:
        x = x.sort(dim=1).values
        return x.shape[0] + int((x[:, 1:] != x[:, :-1]).sum())

    n = int(valid.sum())
    w, s = distinct(g), distinct(g >> 3)  # 8 u32 words a sector
    return {"keys": n, "words": w, "sectors": s,
            "words_per_key": w / max(n, 1), "sectors_per_key": s / max(n, 1)}


def rates(t: dict, ms: float) -> dict:
    return {"words_per_s": t["words"] / ms * 1e3, "sectors_per_s": t["sectors"] / ms * 1e3}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of bytes over the
    memory rate and 32-bit integer operations over the INT32 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def floor_ms(nbytes: float) -> float:
    """Bytes over the memory rate, in ms: with a query's bytes counting
    every valid key's row once (no two keys sharing a row read), the
    floor of a kernel that gets no reuse out of the L2."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    dev = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit("device", **dev)
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    logs = {n: (_build.BUILD_DIR / f"{n}.log").read_text() for n in built}
    emit("build", seconds=time.perf_counter() - t0, per_source=built,
         ptxas={n: ptxas_summary(log) for n, log in logs.items()})


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, shared memory and spills, from the
    ``-Xptxas -v`` lines of a build log, under its demangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = f"{out.get(name, '')} {ln.split(':', 1)[-1].strip()}".strip()
    return dict(zip(demangle(list(out)), out.values()))


def demangle(names: list[str]) -> list[str]:
    """``tpubloom::blocked_query_row_kernel<16>`` for each mangled kernel
    name (the argument list dropped), by ``c++filt`` or the toolkit's
    ``cu++filt``; the names as they are where neither runs."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not names or tool is None:
        return names
    try:
        got = subprocess.run([tool, *names], capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(got) != len(names):
        return names
    return [g.removeprefix("void ").split("(")[0] for g in got]


def fused_test_insert(state: torch.Tensor, keys, lengths, cfg: FilterConfig):
    """The fused test-and-insert kernel on ``state`` (whatever the
    crossover), and the largest difference between the keys its partition
    put in each row tile and the plain partition's."""
    batch = keys.shape[0]
    scratch = torch.empty(sweep.blocked_test_insert_scratch_bytes(cfg, batch), dtype=torch.uint8,
                          device=state.device)
    present = sweep._blocked_test_insert_on(True, state, keys, lengths, cfg, scratch=scratch)
    got = sweep.blocked_test_insert_tile_counts(scratch, cfg, batch)
    want = blocked.test_insert_tile_counts_plain(keys, lengths, cfg, sweep.flat_tile_geometry()[0])
    return present, max_abs_err(got, want)


def test_insert_vs_plain(f: BlockedBloomFilter, keys, lengths) -> dict:
    """One test-and-insert batch from ``f``'s state through the fused
    kernel, the two launches (blocked_query, blocked_insert) and the plain
    version: each state and each verdict against the plain one's."""
    cfg = f.config
    s_fused, s_two, s_plain = (clone_u32(f.words) for _ in range(3))
    p_fused, tiles_err = fused_test_insert(s_fused, keys, lengths, cfg)
    p_two = sweep._blocked_test_insert_on(False, s_two, keys, lengths, cfg)
    p_plain = blocked.blocked_test_insert_plain(s_plain, keys, lengths, cfg)
    torch.cuda.synchronize()
    out = {"fused_state_err": max_abs_err(s_fused, s_plain),
           "fused_presence_err": max_abs_err(p_fused, p_plain), "tile_counts_err": tiles_err,
           "two_launch_state_err": max_abs_err(s_two, s_plain),
           "two_launch_presence_err": max_abs_err(p_two, p_plain),
           "present": int(p_plain.sum())}
    check(torch.equal(s_fused.view(torch.int32), s_plain.view(torch.int32)), "fused test-insert state")
    check(torch.equal(p_fused, p_plain), "fused test-insert verdicts")
    check(tiles_err == 0, "fused test-insert partition")
    check(torch.equal(s_two.view(torch.int32), s_plain.view(torch.int32)), "two-launch test-insert state")
    check(torch.equal(p_two, p_plain), "two-launch test-insert verdicts")
    return out


def hot_vs_plain(cfg: FilterConfig, batch: int, rng: np.random.Generator, hot: int) -> dict:
    """A batch above the crossover with a hot row: ``hot`` copies of one
    key spread over it (the rest fresh, an eighth held, tail padding),
    from a filter filled with one batch, through the fused kernel, the two
    launches and the plain version."""
    dev = torch.device("cuda")
    f = BlockedBloomFilter(cfg, dev)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    held = torch.from_numpy(rows(rng, batch)).to(dev)
    sweep.blocked_insert(f.words, held, full, cfg)
    keys = torch.from_numpy(rows(rng, batch)).to(dev)
    keys[: batch // 8] = held[: batch // 8]
    at = torch.from_numpy(rng.choice(batch, hot, replace=False)).to(dev)
    keys[at] = keys[batch // 2].clone()
    lengths = full.clone()
    lengths[-batch // 1024:] = -1
    keys[-batch // 1024:] = 0
    out = {"log2m": cfg.m.bit_length() - 1, "block_hash": cfg.block_hash, "batch": batch,
           "hot_copies": hot, "keys_per_row": batch / cfg.n_blocks,
           "busiest_row_keys": int(torch.unique(touched_rows(f, keys, lengths.clamp(min=0))[1][lengths >= 0],
                                                return_counts=True)[1].max()),
           **test_insert_vs_plain(f, keys, lengths)}
    del f
    return out


def kernel_vs_plain(cfg: FilterConfig, batch: int, rng: np.random.Generator) -> dict:
    """Populate with kernel batches, then run the same test-and-insert,
    insert and query through the kernels and the plain versions; the
    test-and-insert through the wrapper, the fused kernel and the two
    launches."""
    dev = torch.device("cuda")
    f = BlockedBloomFilter(cfg, dev)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    prev = None
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        sweep.blocked_insert(f.words, prev, full, cfg)
    fresh = torch.from_numpy(rows(rng, batch // 2)).to(dev)
    # keys already in, fresh keys, a repeat of a quarter of the fresh
    # keys inside the batch, and tail padding
    keys = torch.cat([prev[: batch // 4], fresh, fresh[: batch // 4]]).contiguous()
    lengths = full.clone()
    n_pad = batch // 1024
    lengths[-n_pad:] = -1
    keys[-n_pad:] = 0
    s_kernel, s_plain, s_insert = (clone_u32(f.words) for _ in range(3))
    p_kernel = sweep.blocked_test_insert(s_kernel, keys, lengths, cfg)
    p_plain = blocked.blocked_test_insert_plain(s_plain, keys, lengths, cfg)
    sweep.blocked_insert(s_insert, keys, lengths, cfg)
    probe = torch.cat([keys[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    q_kernel = sweep.blocked_query(s_kernel, probe, lengths, cfg)
    q_plain = blocked.blocked_query_plain(s_kernel, probe, lengths, cfg)
    torch.cuda.synchronize()
    out = {
        "block_hash": cfg.block_hash, "log2m": cfg.m.bit_length() - 1, "batch": batch,
        "test_insert_state_err": max_abs_err(s_kernel, s_plain),
        "insert_state_err": max_abs_err(s_insert, s_plain),
        "presence_err": max_abs_err(p_kernel, p_plain),
        "query_err": max_abs_err(q_kernel, q_plain),
        "present_old": int(p_kernel[: batch // 4].sum()),
        "present_padding": int(p_kernel[-n_pad:].sum()),
        "query_hits": int(q_kernel.sum()),
    }
    check(torch.equal(s_kernel.view(torch.int32), s_plain.view(torch.int32)), "test-insert state")
    check(torch.equal(s_insert.view(torch.int32), s_plain.view(torch.int32)), "insert state")
    check(torch.equal(p_kernel, p_plain), "presence verdicts")
    check(torch.equal(q_kernel, q_plain), "query verdicts")
    check(out["present_old"] == batch // 4 and out["present_padding"] == 0, "presence contract")
    del s_kernel, s_plain, s_insert
    # the same batch from the same state through each test-and-insert path
    out["wrapper_took"] = ("blocked_test_insert" if sweep._takes_fused(cfg, batch)
                           else "blocked_query + blocked_insert")
    out["test_insert"] = test_insert_vs_plain(f, keys, lengths)
    return out


def phase_kernel_vs_plain(rng) -> dict:
    main = kernel_vs_plain(FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS), B, rng)
    ap = kernel_vs_plain(
        FilterConfig(m=1 << 28, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS, block_hash="ap"),
        1 << 20, rng,
    )
    # a hot row at the main path's shape (one key over a quarter of the
    # batch), and a crowded one: B = 2^18 distinct keys on 128 rows (m =
    # 2^16), ~2,048 a row
    hot = hot_vs_plain(FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS),
                       B, rng, B // 4)
    crowd = hot_vs_plain(FilterConfig(m=1 << 16, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS,
                                      block_hash="ap"), 1 << 18, rng, 0)
    runs = (main["test_insert"], ap["test_insert"], hot, crowd)
    errs = {"blocked_insert": max(main["test_insert_state_err"], main["insert_state_err"],
                                  ap["test_insert_state_err"], ap["insert_state_err"],
                                  *(r["two_launch_state_err"] for r in runs)),
            "blocked_query": max(main["presence_err"], main["query_err"],
                                 ap["presence_err"], ap["query_err"],
                                 *(r["two_launch_presence_err"] for r in runs)),
            "blocked_test_insert": max(max(r["fused_state_err"], r["fused_presence_err"],
                                           r["tile_counts_err"]) for r in runs)}
    emit("kernel_vs_plain", chunk=main, ap=ap, hot_row=hot, crowded_row=crowd, max_abs_err=errs,
         tolerance=0)
    torch.cuda.empty_cache()
    return errs


def fpr_bound(hits: int, probes: int, n_inserted: int, c: FilterConfig) -> dict:
    """Fresh keys' hits against the blocked FPR model, with the acceptance
    of tests/test_fpr_model.py: 6 sigma, 35% model tolerance, floor 8."""
    expect = probes * blocked_fpr(n_inserted, m=c.m, k=c.k, block_bits=c.block_bits,
                                  block_hash=c.block_hash)
    tol = max(6.0 * math.sqrt(max(expect, 1.0)), 0.35 * expect, 8.0)
    check(abs(hits - expect) <= tol, f"FPR {hits} hits vs model {expect:.1f} ± {tol:.1f}")
    return {"probes": probes, "hits": hits, "model_hits": expect, "tolerance": tol}


def fpr_check(f: BlockedBloomFilter, rng, n_probe: int) -> dict:
    """Fresh keys' hits against the blocked FPR model, with the acceptance
    of tests/test_fpr_model.py: 6 sigma, 35% model tolerance, floor 8."""
    hits = int(f.include_packed(rows(rng, n_probe)).sum())
    c = f.config
    return {"log2m": c.m.bit_length() - 1, "n_inserted": f.n_inserted,
            **fpr_bound(hits, n_probe, f.n_inserted, c)}


def phase_main_path(rng) -> tuple[dict, BlockedBloomFilter]:
    cfg = FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS)
    fresh_full, again_full = rows(rng, B), rows(rng, B)
    torch.cuda.reset_peak_memory_stats()
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    f = BlockedBloomFilter(cfg)  # no device: the card
    check(f.words.is_cuda, "default device is the card")
    lens = rng.integers(1, KEY_LEN + 1, 10_000)
    keys = [rng.bytes(int(n)) for n in lens]
    first = f.insert_batch(keys, return_presence=True)
    replay = f.insert_batch(keys, return_presence=True)
    check(not first.any(), "fresh keys absent from an empty filter")
    check(replay.all(), "replayed keys all present")
    new = [rng.bytes(KEY_LEN) for _ in range(1000)]
    dup = f.insert_batch(new + new + keys[:1000], return_presence=True)
    check((dup[:1000] == dup[1000:2000]).all() and not dup[:2000].any(),
          "within-batch duplicates report the pre-batch state")
    check(dup[2000:].all(), "old keys present")
    hits, n = f.launch_query(f.stage_batch(new + keys[:2000]))
    hits = hits.cpu().numpy()
    check(n == 3000 and hits.shape == (4096,) and hits[:n].all() and not hits[n:].any(),
          "padding reports False")
    big = rows(rng, B)
    check(f.insert_packed(big) == B, "insert_packed count")
    check(f.include_packed(big).all(), "packed replay all present")
    fpr_full = fpr_check(f, rng, B)
    # a test-and-insert at full width, B fresh Python bytes keys: their
    # pre-batch verdicts are false positives of the filter before the batch
    n_before = f.n_inserted
    present_full = f.insert_batch(key_list(fresh_full), return_presence=True)
    fpr_presence = fpr_bound(int(present_full.sum()), B, n_before, cfg)
    check(f.include_packed(fresh_full).all(), "full-width test-and-insert keys present")
    inflight = sweep.InFlight()
    staged_rows = [rows(rng, B) for _ in range(4)]
    acked = []
    for i, r in enumerate(staged_rows):
        payload, err = inflight.put(f.launch_insert(f.stage_batch(rows=r)), i)
        check(err is None, f"fence error {err}")
        if payload is not None:
            acked.append(payload)
    payload, err = inflight.take()
    check(err is None, f"fence error {err}")
    acked.append(payload)
    check(acked == [0, 1, 2, 3], "staged batches acked in order")
    for r in staged_rows:
        check(f.include_packed(r).all(), "staged batch present")
    torch.cuda.synchronize()
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # the full-width test-and-insert takes the fused kernel where the
    # crossover says it is the faster
    for name in ("blocked_insert", "blocked_query",
                 *(("blocked_test_insert",) if sweep._takes_fused(cfg, B) else ())):
        check(launches[name] > 0, f"{name} launched on the main path")
    # an FPR the model can be held to needs a fuller filter: m=2^26 at 2^23 keys
    small = BlockedBloomFilter(FilterConfig(m=1 << 26, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS))
    small.insert_packed(rows(rng, B))
    fpr_small = fpr_check(small, rng, B)
    del small
    per_op = {}
    again_keys = key_list(again_full)
    for op, fn in (
        ("test_and_insert", lambda: f.insert_batch(keys, return_presence=True)),
        ("test_and_insert_2^23", lambda: f.insert_batch(again_keys, return_presence=True)),
        ("insert", lambda: f.insert_packed(big)),
        ("query", lambda: f.include_packed(big)),
    ):
        sweep.reset_launch_counts()
        fn()
        per_op[op] = sweep.launch_counts()
    stats = f.stats()
    emit("main_path", launches=launches, launches_per_op=per_op, seconds=seconds,
         peak_bytes=peak, fpr=fpr_full, fpr_fuller=fpr_small, fpr_test_and_insert=fpr_presence,
         n_inserted=f.n_inserted, fill_ratio=stats["fill_ratio"])
    return launches, f


def touched_rows(f: BlockedBloomFilter, keys: torch.Tensor, lengths: torch.Tensor):
    c = f.config
    blk, pos = blocked.block_positions(keys, lengths, n_blocks=c.n_blocks, block_bits=c.block_bits,
                                       k=c.k, seed=c.seed, block_hash=c.block_hash)
    return int(torch.unique(blk).numel()), blk, pos


def phase_times(f: BlockedBloomFilter, rng) -> dict:
    cfg, dev = f.config, f.device
    batches = [torch.from_numpy(rows(rng, B)).to(dev) for _ in range(8)]
    old, fresh = batches[:4], batches[4:]
    lengths = torch.full((B,), KEY_LEN, dtype=torch.int32, device=dev)
    state = f.words
    # `ms` queries keys the filter does not hold (the `old` batches before
    # they are inserted), `present_ms` the same batches once it holds them
    q_ms = cuda_ms(lambda i: sweep.blocked_query(state, old[i % 4], lengths, cfg), 40, warm=4)
    # re-inserts the four batches its warm-up launches inserted
    replay_ms = cuda_ms(lambda i: sweep.blocked_insert(state, old[i % 4], lengths, cfg), 40, warm=4)
    qpres_ms = cuda_ms(lambda i: sweep.blocked_query(state, old[i % 4], lengths, cfg), 40, warm=4)
    i_ms = fresh_ms(state, lambda i: sweep.blocked_insert(state, fresh[i % 4], lengths, cfg), 40)
    qp_ms = cuda_ms(lambda i: blocked.blocked_query_plain(state, old[i % 4], lengths, cfg), 5, warm=1)
    ip_ms = cuda_ms(lambda i: blocked.blocked_insert_plain(state, old[i % 4], lengths, cfg), 5, warm=1)
    # test-and-insert: the fused kernel and the two launches, fresh, in turns
    # (`--ab` runs this in trees that predate the fused kernel: two launches only)
    ti = {"fused": [], "two_launch": []}
    for kernel in ("fused", "two_launch", "two_launch", "fused") if FUSED else ():
        ti[kernel].append(fresh_ms(state, lambda i: sweep._blocked_test_insert_on(
            kernel == "fused", state, fresh[i % 4], lengths, cfg), 20))
    if FUSED:
        ti_replay_ms = cuda_ms(lambda i: sweep._blocked_test_insert_on(True, state, old[i % 4], lengths,
                                                                       cfg), 20, warm=2)
        tip_ms = cuda_ms(lambda i: blocked.blocked_test_insert_plain(state, old[i % 4], lengths, cfg), 5,
                         warm=1)
        ti_kernels = kernel_ms(lambda i: sweep._blocked_test_insert_on(True, state, old[i % 4], lengths,
                                                                       cfg), 10)
    rows_touched, blk, _ = touched_rows(f, old[0], lengths)
    _, fresh_blk, fresh_pos = touched_rows(f, fresh[0], lengths)
    t = touched(fresh_blk, fresh_pos >> 5, cfg.words_per_block, lengths >= 0)
    table = state.view(torch.int32).reshape(cfg.n_blocks, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, blk), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B * KEY_LEN + B * 4
    q_bytes = in_bytes + B + rows_touched * row_bytes
    i_bytes = in_bytes + 2 * rows_touched * row_bytes
    qb, qby = bound(q_bytes, OPS_QUERY * B)
    ib, iby = bound(i_bytes, OPS_INSERT * B)
    fresh_rows = int(torch.unique(fresh_blk).numel())
    ti_bytes = in_bytes + B + 2 * fresh_rows * row_bytes
    tib, tiby = bound(ti_bytes, OPS_TEST_INSERT * B)
    ti_ms, two_ms = (sum(v) / len(v) for v in (ti["fused"], ti["two_launch"])) if FUSED else (0, 0)
    q_floor = floor_ms(in_bytes + B + B * row_bytes)
    out = {
        "batch": B, "rows_touched": rows_touched, "touched": t,
        "blocked_query": {"ms": q_ms, "present_ms": qpres_ms, "keys_per_s": B / q_ms * 1e3,
                          "plain_ms": qp_ms, "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby,
                          "bytes": q_bytes, "share_of_bound": qb / q_ms,
                          "floor_ms": q_floor, "share_of_floor": q_floor / q_ms},
        "blocked_insert": {"ms": i_ms, "replay_ms": replay_ms, "keys_per_s": B / i_ms * 1e3,
                           "plain_ms": ip_ms, "library_ms": None, "bound_ms": ib, "bound_by": iby,
                           "bytes": i_bytes, "share_of_bound": ib / i_ms, **rates(t, i_ms)},
        **({} if not FUSED else {"blocked_test_insert": {"ms": ti_ms, "replay_ms": ti_replay_ms, "keys_per_s": B / ti_ms * 1e3,
                                "two_launch_ms": two_ms, "turns_ms": ti, "plain_ms": tip_ms,
                                "library_ms": None, "library": "none: no test-and-insert call",
                                "bound_ms": tib, "bound_by": tiby, "bytes": ti_bytes,
                                "rows_touched": fresh_rows, "share_of_bound": tib / ti_ms,
                                "two_launch_share_of_bound": tib / two_ms,
                                "kernels_ms": ti_kernels}}),
        "test_and_insert_ms": q_ms + i_ms,
    }
    emit("times", **out)
    return out


def phase_test_insert_crossover(f: BlockedBloomFilter, rng) -> dict:
    """The fused test-and-insert and the two launches (blocked_query, then
    blocked_insert) on the main path's filter over B = 2^14 .. 2^23 fresh
    keys, each launch fresh (the state restored and the L2 flushed before
    it), in turns (fused, two, two, fused). The crossover is the fewest
    keys a row from which the fused kernel is the faster at every larger
    batch: what sweep.BLOCKED_TEST_INSERT_CROSSOVER holds."""
    cfg, state = f.config, f.words
    top = 1 << max(LOG2B_TEST_INSERT)
    fresh = [torch.from_numpy(rows(rng, top)).to(state.device) for _ in range(2)]
    full = torch.full((top,), KEY_LEN, dtype=torch.int32, device=state.device)
    runs = []
    for lb in LOG2B_TEST_INSERT:
        n = 1 << lb
        row = {"batch": n, "keys_per_row": n / cfg.n_blocks, "fused_turns_ms": [],
               "two_launch_turns_ms": []}
        for kernel in ("fused", "two_launch", "two_launch", "fused"):
            row[f"{kernel}_turns_ms"].append(fresh_ms(state, lambda i: sweep._blocked_test_insert_on(
                kernel == "fused", state, fresh[i % 2][:n], full[:n], cfg), 10))
        for kernel in ("fused", "two_launch"):
            row[f"{kernel}_ms"] = sum(row[f"{kernel}_turns_ms"]) / 2
        row["picked"] = "fused" if sweep._takes_fused(cfg, n) else "two_launch"
        row["picked_is_faster"] = row[f"{row['picked']}_ms"] <= min(row["fused_ms"], row["two_launch_ms"])
        runs.append(row)
    at = None
    for r in reversed(runs):
        if r["fused_ms"] >= r["two_launch_ms"]:
            break
        at = r["keys_per_row"]
    del fresh
    out = {"runs": runs, "crossover_keys_per_row": at,
           "crossover_in_use": sweep.BLOCKED_TEST_INSERT_CROSSOVER}
    emit("test_insert_crossover", **out)
    return out


def time_calls(calls) -> dict:
    """Host-clock time of whole entry-point calls, split by the port's
    own phase spans (host_prep / h2d / kernel / kernel_query / d2h, each
    fenced inside an active request context), and the share of it the
    kernels keep the card busy (kernel ms from the CUDA-event times).
    ``calls``: (name, keys, fn, kernel ms or None)."""
    out = {}
    for name, n, fn, kernel_ms in calls:
        fn()  # warm
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            with obs.request(name) as ctx:
                fn()
            total_ms = (time.perf_counter() - t0) * 1e3
            runs.append({"total_ms": total_ms, "keys_per_s": n / total_ms * 1e3,
                         **{f"{k}_ms": v * 1e3 for k, v in ctx.phases.items()}})
        best = min(r["total_ms"] for r in runs)
        out[name] = {"keys": n, "runs": runs,
                     "device_busy_share": None if kernel_ms is None else kernel_ms / best}
    return out


def phase_end_to_end(f: BlockedBloomFilter, rng, times: dict) -> None:
    big = rows(rng, B)
    small = [bytes(r) for r in rows(rng, 1 << 16)]
    emit("end_to_end", **time_calls((
        ("insert_packed", B, lambda: f.insert_packed(big), times["blocked_insert"]["ms"]),
        ("include_packed", B, lambda: f.include_packed(big), times["blocked_query"]["ms"]),
        ("test_and_insert_bytes_keys", len(small),
         lambda: f.insert_batch(small, return_presence=True), None),
    )))


def phase_counting_end_to_end(f: BlockedCountingBloomFilter, rng, times: dict) -> None:
    """The counting path's whole calls: packed insert and query at
    B=2^22, and a delete of 2^16 Python ``bytes`` keys (the counting
    filter deletes only through ``delete_batch``)."""
    big = rows(rng, B_COUNTING)
    small = [bytes(r) for r in rows(rng, 1 << 16)]
    emit("counting_end_to_end", **time_calls((
        ("insert_packed", B_COUNTING, lambda: f.insert_packed(big),
         times["blocked_counting_update"]["ms"]),
        ("include_packed", B_COUNTING, lambda: f.include_packed(big),
         times["blocked_counting_query"]["ms"]),
        ("delete_bytes_keys", len(small), lambda: f.delete_batch(small), None),
    )))


def counting_config(log2m: int, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=K, key_len=KEY_LEN, counting=True,
                        block_bits=BLOCK_BITS, **kw)


def equal_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def skewed_batch(rng, old: torch.Tensor, batch: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Keys already counted (the first quarter), one key repeated over
    the second quarter, fresh keys, and tail padding; returns (keys,
    lengths, padded entries)."""
    dev = old.device
    keys = torch.from_numpy(rows(rng, batch)).to(dev)
    keys[: batch // 4] = old[: batch // 4]
    keys[batch // 4 : batch // 2] = keys[batch // 4].clone()
    lengths = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    n_pad = max(1, batch // 1024)
    lengths[-n_pad:] = -1
    keys[-n_pad:] = 0
    return keys, lengths, n_pad


def counting_vs_plain(cfg: FilterConfig, batch: int, rng, view: str) -> dict:
    """Populate with kernel batches, then insert, delete and query the
    same skewed batch through the counting kernels and their plain
    versions, from the same state; ``view`` "storage" passes the filter's
    own (fat) storage, "logical" its [NB, W] view of the same words."""
    dev = torch.device("cuda")
    f = BlockedCountingBloomFilter(cfg, dev)
    state = f.words if view == "storage" else f.words.view(cfg.n_blocks, cfg.words_per_block)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        sweep.blocked_counting_update(state, prev, full, cfg, increment=True)
    keys, lengths, n_pad = skewed_batch(rng, prev, batch)
    s_kernel, s_plain = clone_u32(state), clone_u32(state)
    errs = {}
    for op, increment in (("insert", True), ("delete", False)):
        sweep.blocked_counting_update(s_kernel, keys, lengths, cfg, increment=increment)
        counting.blocked_counting_update_plain(s_plain, keys, lengths, cfg, increment=increment)
        torch.cuda.synchronize()
        errs[f"{op}_state_err"] = max_abs_err(s_kernel, s_plain)
        check(equal_words(s_kernel, s_plain), f"counting {op} state ({view}, {cfg.block_hash})")
        if increment:
            hot = sweep.blocked_counting_query(s_kernel, keys[batch // 4 : batch // 4 + 1], full[:1], cfg)
            errs["hot_key_present_after_insert"] = bool(hot[0])
    probe = torch.cat([prev[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    q_kernel = sweep.blocked_counting_query(s_kernel, probe, lengths, cfg)
    q_plain = counting.blocked_counting_query_plain(s_kernel, probe, lengths, cfg)
    torch.cuda.synchronize()
    check(torch.equal(q_kernel, q_plain), f"counting query verdicts ({view}, {cfg.block_hash})")
    check(errs["hot_key_present_after_insert"], "the repeated key is present after its insert")
    out = {
        "view": view, "state_shape": list(state.shape), "block_hash": cfg.block_hash,
        "log2m": cfg.m.bit_length() - 1, "batch": batch, "padded": n_pad, **errs,
        "query_err": max_abs_err(q_kernel, q_plain),
        "query_hits_old_half": int(q_kernel[: batch // 2].sum()),
        "query_hits_fresh_half": int(q_kernel[batch // 2 :].sum()),
    }
    del f, state, s_kernel, s_plain
    torch.cuda.empty_cache()
    return out


def phase_counting_kernel_vs_plain(rng) -> dict:
    runs = [
        counting_vs_plain(counting_config(LOG2M_COUNTING), B_COUNTING, rng, "storage"),
        counting_vs_plain(counting_config(LOG2M_COUNTING), B_COUNTING, rng, "logical"),
        counting_vs_plain(counting_config(LOG2M_COUNTING_AP, block_hash="ap"), B_COUNTING_AP,
                          rng, "storage"),
    ]
    errs = {"blocked_counting_update": max(max(r["insert_state_err"], r["delete_state_err"]) for r in runs),
            "blocked_counting_query": max(r["query_err"] for r in runs)}
    emit("counting_kernel_vs_plain", runs=runs, max_abs_err=errs, tolerance=0,
         cut=f"ap run at m=2^{LOG2M_COUNTING_AP} counters, B={B_COUNTING_AP}: "
             "for the plain version's time only")
    return errs


def phase_counting_path(rng) -> tuple[dict, BlockedCountingBloomFilter]:
    cfg = counting_config(LOG2M_COUNTING)
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    steps = {}
    f = BlockedCountingBloomFilter(cfg)  # no device: the card
    check(f.words.is_cuda, "default device is the card")
    big = rows(rng, B_COUNTING)
    check(f.insert_packed(big) == B_COUNTING, "insert_packed count")
    steps["insert_packed"] = sweep.launch_counts()
    check(f.include_packed(big).all(), "inserted keys all present")
    steps["include_packed"] = sweep.launch_counts()
    n_gone = B_COUNTING // 64  # 2^16 at config 4
    gone = [bytes(r) for r in big[:n_gone]]
    f.delete_batch(gone)
    steps["delete_batch"] = sweep.launch_counts()
    kept = [bytes(r) for r in big[n_gone : 2 * n_gone]]
    after = f.include_batch(gone + kept)
    steps["include_batch"] = sweep.launch_counts()
    check(not after[:n_gone].any(), "deleted keys absent")
    check(after[n_gone:].all() and f.include_packed(big[n_gone:]).all(), "the other keys still present")
    check(f.n_inserted == B_COUNTING - n_gone, "n_inserted after the delete")
    # a fresh filter that inserts and deletes the same keys is empty again
    # (at λ = 0.5 keys a block no counter comes near 15)
    g = BlockedCountingBloomFilter(cfg)
    again = rows(rng, B_COUNTING)
    g.insert_packed(again)
    g.delete_batch([bytes(r) for r in again])
    torch.cuda.synchronize()
    check(not bool(g.words.view(torch.int32).any()), "insert then delete returns to all-zero words")
    check(g.n_inserted == 0, "n_inserted back to 0")
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    for name in ("blocked_counting_update", "blocked_counting_query"):
        check(launches[name] > 0, f"{name} launched on the counting path")
    del g
    torch.cuda.empty_cache()
    emit("counting_path", launches=launches, launches_after_step=steps, seconds=seconds,
         n_inserted=f.n_inserted, deleted=n_gone, stats=f.stats())
    return launches, f


def event_pairs_ms(ops: list, n: int, warm: int = 4) -> list[float]:
    """Mean ms per launch of each op, timed by its own CUDA event pair,
    over ``n`` rounds that run the ops in turn (after ``warm`` rounds)."""
    for i in range(warm):
        for op in ops:
            op(i)
    torch.cuda.synchronize()
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(len(ops) + 1)] for _ in range(n)]
    for i in range(n):
        evs[i][0].record()
        for j, op in enumerate(ops):
            op(i)
            evs[i][j + 1].record()
    torch.cuda.synchronize()
    return [sum(evs[i][j].elapsed_time(evs[i][j + 1]) for i in range(n)) / n for j in range(len(ops))]


def phase_counting_times(f: BlockedCountingBloomFilter, rng) -> dict:
    cfg, dev, state = f.config, f.device, f.words
    batches = [torch.from_numpy(rows(rng, B_COUNTING)).to(dev) for _ in range(4)]
    lengths = torch.full((B_COUNTING,), KEY_LEN, dtype=torch.int32, device=dev)
    skew, skew_len, _ = skewed_batch(rng, batches[0], B_COUNTING)

    def upd(keys, lens, increment, st=state):
        return lambda i: sweep.blocked_counting_update(st, keys(i), lens, cfg, increment=increment)

    def plain(keys, lens, increment):
        return lambda i: counting.blocked_counting_update_plain(state, keys(i), lens, cfg, increment=increment)

    def batch(i):
        return batches[i % 4]

    # insert then delete the same batch, as benchmarks/counting_rate.py
    # does: the state stays at its populated level
    i_ms, d_ms = event_pairs_ms([upd(batch, lengths, True), upd(batch, lengths, False)], 40)
    si_ms, sd_ms = event_pairs_ms([upd(lambda i: skew, skew_len, True),
                                   upd(lambda i: skew, skew_len, False)], 40)
    # the same kernel handed the logical [NB, W] view (K2's layout)
    logical = state.view(cfg.n_blocks, cfg.words_per_block)
    li_ms, ld_ms = event_pairs_ms([upd(batch, lengths, True, logical),
                                   upd(batch, lengths, False, logical)], 40)
    q_ms = cuda_ms(lambda i: sweep.blocked_counting_query(state, batches[i % 4], lengths, cfg), 40, warm=4)
    ip_ms, dp_ms = event_pairs_ms([plain(batch, lengths, True), plain(batch, lengths, False)], 3, warm=1)
    qp_ms = cuda_ms(lambda i: counting.blocked_counting_query_plain(state, batches[i % 4], lengths, cfg), 3, warm=1)
    blk, cpos = blocked.block_positions(batches[0], lengths, n_blocks=cfg.n_blocks,
                                        block_bits=cfg.counters_per_block, k=cfg.k, seed=cfg.seed,
                                        block_hash=cfg.block_hash)
    rows_touched = int(torch.unique(blk).numel())
    t = touched(blk, cpos >> 3, cfg.words_per_block, lengths >= 0)
    table = state.view(torch.int32).reshape(cfg.n_blocks, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, blk), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B_COUNTING * (KEY_LEN + 4)
    u_bytes = in_bytes + 2 * rows_touched * row_bytes
    q_bytes = in_bytes + B_COUNTING + rows_touched * row_bytes
    ub, uby = bound(u_bytes, OPS_COUNT_UPDATE * B_COUNTING)
    qb, qby = bound(q_bytes, OPS_COUNT_QUERY * B_COUNTING)
    out = {
        "batch": B_COUNTING, "rows_touched": rows_touched, "touched": t,
        "blocked_counting_update": {
            "ms": i_ms, "delete_ms": d_ms, "skewed_insert_ms": si_ms, "skewed_delete_ms": sd_ms,
            "logical_view_ms": li_ms, "logical_view_delete_ms": ld_ms,
            "keys_per_s": B_COUNTING / i_ms * 1e3, "plain_ms": ip_ms, "plain_delete_ms": dp_ms,
            "library_ms": None, "bound_ms": ub, "bound_by": uby, "bytes": u_bytes,
            "share_of_bound": ub / i_ms, **rates(t, i_ms),
        },
        "blocked_counting_query": {
            "ms": q_ms, "keys_per_s": B_COUNTING / q_ms * 1e3, "plain_ms": qp_ms,
            "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby, "bytes": q_bytes,
            "share_of_bound": qb / q_ms,
        },
    }
    emit("counting_times", **out)
    return out


def phase_checkpoint_roundtrip(rng) -> None:
    cfg = counting_config(LOG2M_CHECKPOINT)
    f = BlockedCountingBloomFilter(cfg)
    keys = rows(rng, B_CHECKPOINT)
    f.insert_packed(keys)
    f.delete_batch([bytes(r) for r in keys[: 1 << 12]])
    t0 = time.perf_counter()
    key_name, seq, blob = checkpoint.snapshot_blob(f)
    t1 = time.perf_counter()
    g = checkpoint.restore_blob(blob)
    t2 = time.perf_counter()
    check(isinstance(g, BlockedCountingBloomFilter) and g.words.is_cuda, "restored on the card")
    check(equal_words(f.words, g.words), "restored words equal")
    probe = np.concatenate([keys[: 1 << 16], rows(rng, 1 << 16)])
    check(np.array_equal(f.include_packed(probe), g.include_packed(probe)), "restored verdicts equal")
    check(g.n_inserted == f.n_inserted and g._restored_seq == seq, "restored usage counters and seq")
    emit("checkpoint_roundtrip", log2m=cfg.m.bit_length() - 1, key_name=key_name,
         blob_bytes=len(blob), snapshot_s=t1 - t0, restore_s=t2 - t1)


def sharded_config(log2m: int, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS,
                        shards=SHARDS, **kw)


def slot_state(cfg: FilterConfig, route: ShardRoute) -> torch.Tensor:
    n = route.shards_per_dev * cfg.n_blocks_per_shard * cfg.words_per_block
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda")).view(torch.uint32)


def sharded_vs_plain(cfg: FilterConfig, route: ShardRoute, batch: int, rng) -> dict:
    """Populate one slot's state with routed kernel inserts, then run the
    same update(s) and query through the routed kernels and their routed
    plain versions from the same state: the bit filter's insert, or the
    counting filter's insert and delete (with a quarter of the batch one
    repeated key)."""
    dev = torch.device("cuda")
    state = slot_state(cfg, route)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    counting_cfg = bool(cfg.counting)
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        if counting_cfg:
            sweep.blocked_counting_update(state, prev, full, cfg, increment=True, route=route)
        else:
            sweep.blocked_insert(state, prev, full, cfg, route=route)
    if counting_cfg:
        keys, lengths, n_pad = skewed_batch(rng, prev, batch)
    else:
        fresh = torch.from_numpy(rows(rng, batch // 2)).to(dev)
        keys = torch.cat([prev[: batch // 4], fresh, fresh[: batch // 4]]).contiguous()
        lengths, n_pad = full.clone(), batch // 1024
        lengths[-n_pad:] = -1
        keys[-n_pad:] = 0
    s_plain = clone_u32(state)  # the kernel updates `state` itself
    owned = blocked.routed_blocks(keys, lengths, cfg, route,
                                  block_bits=cfg.counters_per_block if counting_cfg
                                  else cfg.block_bits)[0]
    out = {"route": [route.n_shards, route.shard_lo, route.shards_per_dev],
           "log2m": cfg.m.bit_length() - 1, "batch": batch, "padded": n_pad,
           "owned": int(owned.sum()), "state_bytes": state.numel() * 4}
    ops = (("insert", True), ("delete", False)) if counting_cfg else (("insert", True),)
    for op, increment in ops:
        if counting_cfg:
            sweep.blocked_counting_update(state, keys, lengths, cfg, increment=increment, route=route)
            counting.blocked_counting_update_plain(s_plain, keys, lengths, cfg,
                                                   increment=increment, route=route)
        else:
            sweep.blocked_insert(state, keys, lengths, cfg, route=route)
            blocked.blocked_insert_plain(s_plain, keys, lengths, cfg, route)
        torch.cuda.synchronize()
        out[f"{op}_state_err"] = max_abs_err(state, s_plain)
        check(equal_words(state, s_plain), f"sharded {op} state {out['route']}")
    del s_plain
    probe = torch.cat([prev[: batch // 2], torch.from_numpy(rows(rng, batch // 2)).to(dev)])
    if counting_cfg:
        q_kernel = sweep.blocked_counting_query(state, probe, lengths, cfg, route=route)
        q_plain = counting.blocked_counting_query_plain(state, probe, lengths, cfg, route)
    else:
        q_kernel = sweep.blocked_query(state, probe, lengths, cfg, route=route)
        q_plain = blocked.blocked_query_plain(state, probe, lengths, cfg, route)
    torch.cuda.synchronize()
    check(torch.equal(q_kernel, q_plain), f"sharded query verdicts {out['route']}")
    p_owned = blocked.routed_blocks(probe, lengths, cfg, route,
                                    block_bits=cfg.counters_per_block if counting_cfg
                                    else cfg.block_bits)[0]
    check(not bool(q_kernel[~p_owned].any()), "keys the slot does not own answer False")
    out.update(query_err=max_abs_err(q_kernel, q_plain),
               query_hits_old_half=int(q_kernel[: batch // 2].sum()),
               owned_old_half=int(p_owned[: batch // 2].sum()),
               query_hits_fresh_half=int(q_kernel[batch // 2 :].sum()))
    if not counting_cfg:
        check(out["query_hits_old_half"] == out["owned_old_half"], "owned old keys present")
    del state
    torch.cuda.empty_cache()
    return out


def phase_sharded_kernel_vs_plain(rng) -> dict:
    cfg5 = sharded_config(LOG2M_SHARDED)
    cfg45 = sharded_config(LOG2M_SHARDED_COUNTING, counting=True)
    one, quarter = ShardRoute(SHARDS, 0, SHARDS), ShardRoute(SHARDS, 16, SHARDS // N_SLOTS)
    bits = [sharded_vs_plain(cfg5, r, B_SHARDED, rng) for r in (one, quarter)]
    counts = [sharded_vs_plain(cfg45, r, B_SHARDED_COUNTING, rng)
              for r in (one, ShardRoute(SHARDS, 48, SHARDS // N_SLOTS))]
    errs = {
        "sharded_blocked_insert": max(r["insert_state_err"] for r in bits),
        "sharded_blocked_query": max(r["query_err"] for r in bits),
        "sharded_blocked_counting_update": max(max(r["insert_state_err"], r["delete_state_err"])
                                               for r in counts),
        "sharded_blocked_counting_query": max(r["query_err"] for r in counts),
    }
    emit("sharded_kernel_vs_plain", config5=bits, configs4x5=counts, max_abs_err=errs, tolerance=0)
    return errs


def same_slots(one: ShardedBloomFilter, many: ShardedBloomFilter) -> bool:
    """The many-slot filter's words equal the one-slot filter's, shard for
    shard (compared on the card)."""
    whole, spd = one.slot_words[0], many.shards_per_dev
    return all(equal_words(whole[i * spd : (i + 1) * spd], w) for i, w in enumerate(many.slot_words))


def phase_sharded_path(rng) -> tuple[dict, ShardedBloomFilter, ShardedBloomFilter, ShardedBloomFilter]:
    cfg5 = sharded_config(LOG2M_SHARDED)
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    steps = {}
    f = ShardedBloomFilter(cfg5)  # no devices: one slot on the one card
    check(len(f.slot_words) == 1 and f.slot_words[0].is_cuda, "default slots are the card")
    big = rows(rng, B_SHARDED)
    check(f.insert_packed(big) == B_SHARDED, "insert_packed count")
    steps["insert_packed"] = sweep.launch_counts()
    check(f.include_packed(big).all(), "packed replay all present")
    steps["include_packed"] = sweep.launch_counts()
    lens = rng.integers(0, KEY_LEN + 1, 10_000)
    keys = [rng.bytes(int(n)) for n in lens] + [b"", b"a"]
    f.insert_batch(keys)
    steps["insert_batch"] = sweep.launch_counts()
    check(f.include_batch(keys).all(), "bytes keys all present")
    steps["include_batch"] = sweep.launch_counts()
    fresh = rows(rng, B_SHARDED // 2)
    probe = np.concatenate([big[: B_SHARDED // 2], fresh])
    verdicts = f.include_packed(probe)
    check(verdicts[: B_SHARDED // 2].all(), "old half of the probe present")
    fpr_full = {"probes": len(fresh), "hits": int(verdicts[B_SHARDED // 2 :].sum())}
    # the same batches through 4 slots on the same card: the same words
    g = ShardedBloomFilter(cfg5, devices=["cuda"] * N_SLOTS)
    g.insert_packed(big)
    g.insert_batch(keys)
    torch.cuda.synchronize()
    check(same_slots(f, g), "4-slot words equal the 1-slot words shard for shard")
    check(np.array_equal(g.include_packed(probe), verdicts), "4-slot verdicts equal")
    check(g.include_batch(keys).all(), "4-slot bytes keys present")
    steps["four_slots"] = sweep.launch_counts()
    check((f.n_inserted, g.n_inserted) == (B_SHARDED + len(keys),) * 2, "n_inserted")
    # an FPR the model can be held to needs a fuller filter
    small = ShardedBloomFilter(sharded_config(LOG2M_SHARDED_FPR))
    small.insert_packed(rows(rng, B_SHARDED))
    fpr_small = fpr_check(small, rng, B_SHARDED)
    del small
    # the counting twin, configs 4 x 5, with a delete
    cfg45 = sharded_config(LOG2M_SHARDED_COUNTING, counting=True)
    fc, gc = ShardedBloomFilter(cfg45), ShardedBloomFilter(cfg45, devices=["cuda"] * N_SLOTS)
    bigc = rows(rng, B_SHARDED_COUNTING)
    n_gone = B_SHARDED_COUNTING // 64
    gone = [bytes(r) for r in bigc[:n_gone]]
    for c in (fc, gc):
        c.insert_packed(bigc)
        c.delete_batch(gone)
    steps["counting"] = sweep.launch_counts()
    torch.cuda.synchronize()
    check(same_slots(fc, gc), "4-slot counters equal the 1-slot counters shard for shard")
    probe_c = np.concatenate([bigc[: 2 * n_gone], rows(rng, n_gone)])
    hits_c = fc.include_packed(probe_c)
    check(np.array_equal(gc.include_packed(probe_c), hits_c), "4-slot counting verdicts equal")
    check(not hits_c[:n_gone].any() and hits_c[n_gone : 2 * n_gone].all(),
          "deleted keys absent, the others present")
    check(fc.n_inserted == gc.n_inserted == B_SHARDED_COUNTING - n_gone, "counting n_inserted")
    del gc
    torch.cuda.synchronize()
    launches = sweep.launch_counts()
    seconds = time.perf_counter() - t0
    for name in ("sharded_blocked_insert", "sharded_blocked_query",
                 "sharded_blocked_counting_update", "sharded_blocked_counting_query"):
        check(launches[name] > 0, f"{name} launched on the sharded path")
    torch.cuda.empty_cache()
    emit("sharded_path", launches=launches, launches_after_step=steps, seconds=seconds,
         n_inserted=f.n_inserted, state_bytes=f.slot_words[0].numel() * 4,
         fresh_hits_at_2_36=fpr_full, fpr_fuller=fpr_small,
         counting={"n_inserted": fc.n_inserted, "deleted": n_gone,
                   "probe_hits_fresh": int(hits_c[2 * n_gone :].sum())})
    return launches, f, g, fc


def sharded_rows(cfg: FilterConfig, route: ShardRoute, keys, lengths, domain: int):
    """(distinct rows of the owned keys, each key's row, positions, owned)."""
    owned, row, pos = blocked.routed_blocks(keys, lengths, cfg, route, block_bits=domain)
    return int(torch.unique(row[owned]).numel()), row, pos, owned


def slot_query_times(g: ShardedBloomFilter, batches: list, lengths: torch.Tensor) -> dict:
    """The routed query on the 4-slot layout's slot of shards 16-31 (a
    quarter of the batch owned), on keys the filter does not hold, with
    its bound over the owned keys' rows: every key is read and routed,
    only the owned keys are hashed and gathered."""
    cfg, state, route = g.config, g.slot_words[1], g.routes[1]
    check((route.shard_lo, route.shards_per_dev) == (16, 16), "slot 1 holds shards 16-31")
    n_rows, _, _, owned = sharded_rows(cfg, route, batches[0], lengths, cfg.block_bits)
    n_owned = int(owned.sum())
    ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route), 40, warm=4)
    n = lengths.numel()
    row_bytes = cfg.words_per_block * 4
    q_bytes = n * (KEY_LEN + 4) + n + n_rows * row_bytes
    qb, qby = bound(q_bytes, OPS_ROUTE * n + OPS_QUERY * n_owned)
    q_floor = floor_ms(n * (KEY_LEN + 4) + n + n_owned * row_bytes)
    return {"ms": ms, "keys_per_s": n / ms * 1e3, "route": [route.n_shards, route.shard_lo,
            route.shards_per_dev], "owned": n_owned, "rows_touched": n_rows, "bound_ms": qb,
            "bound_by": qby, "bytes": q_bytes, "share_of_bound": qb / ms,
            "floor_ms": q_floor, "share_of_floor": q_floor / ms}


def phase_sharded_times(f: ShardedBloomFilter, g: ShardedBloomFilter, fc: ShardedBloomFilter,
                        rng) -> dict:
    cfg, state, route = f.config, f.slot_words[0], f.routes[0]
    dev = state.device
    batches = [torch.from_numpy(rows(rng, B_SHARDED)).to(dev) for _ in range(4)]
    lengths = torch.full((B_SHARDED,), KEY_LEN, dtype=torch.int32, device=dev)
    fresh = [torch.from_numpy(rows(rng, B_SHARDED)).to(dev) for _ in range(4)]
    rows_touched, row, _, _ = sharded_rows(cfg, route, batches[0], lengths, cfg.block_bits)
    _, fresh_row, fresh_pos, fresh_owned = sharded_rows(cfg, route, fresh[0], lengths, cfg.block_bits)
    t = touched(fresh_row, fresh_pos >> 5, cfg.words_per_block, fresh_owned)
    # absent keys (`ms`: the batches before they are inserted), then present
    q_ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route), 40, warm=4)
    slot = slot_query_times(g, batches, lengths)
    replay_ms = cuda_ms(lambda i: sweep.blocked_insert(state, batches[i % 4], lengths, cfg, route=route),
                        40, warm=4)
    qpres_ms = cuda_ms(lambda i: sweep.blocked_query(state, batches[i % 4], lengths, cfg, route=route),
                       40, warm=4)
    i_ms = fresh_ms(state, lambda i: sweep.blocked_insert(state, fresh[i % 4], lengths, cfg, route=route), 40)
    qp_ms = cuda_ms(lambda i: blocked.blocked_query_plain(state, batches[i % 4], lengths, cfg, route), 3, warm=1)
    ip_ms = cuda_ms(lambda i: blocked.blocked_insert_plain(state, batches[i % 4], lengths, cfg, route), 3, warm=1)
    table = state.view(torch.int32).reshape(-1, cfg.words_per_block)
    lib_ms = cuda_ms(lambda i: torch.index_select(table, 0, row), 40, warm=4)
    row_bytes = cfg.words_per_block * 4
    in_bytes = B_SHARDED * (KEY_LEN + 4)
    q_bytes = in_bytes + B_SHARDED + rows_touched * row_bytes
    i_bytes = in_bytes + 2 * rows_touched * row_bytes
    # one slot owns every key here: the routing pass, then the rest
    qb, qby = bound(q_bytes, (OPS_ROUTE + OPS_QUERY) * B_SHARDED)
    ib, iby = bound(i_bytes, (OPS_ROUTE + OPS_INSERT) * B_SHARDED)
    q_floor = floor_ms(in_bytes + B_SHARDED + B_SHARDED * row_bytes)
    del batches, fresh
    # configs 4 x 5
    ccfg, cstate, croute = fc.config, fc.slot_words[0], fc.routes[0]
    cb = [torch.from_numpy(rows(rng, B_SHARDED_COUNTING)).to(dev) for _ in range(4)]
    clen = torch.full((B_SHARDED_COUNTING,), KEY_LEN, dtype=torch.int32, device=dev)

    def upd(increment):
        return lambda i: sweep.blocked_counting_update(cstate, cb[i % 4], clen, ccfg,
                                                       increment=increment, route=croute)

    def plain(increment):
        return lambda i: counting.blocked_counting_update_plain(cstate, cb[i % 4], clen, ccfg,
                                                                increment=increment, route=croute)

    ci_ms, cd_ms = event_pairs_ms([upd(True), upd(False)], 40)
    cq_ms = cuda_ms(lambda i: sweep.blocked_counting_query(cstate, cb[i % 4], clen, ccfg, route=croute),
                    40, warm=4)
    cip_ms, cdp_ms = event_pairs_ms([plain(True), plain(False)], 3, warm=1)
    cqp_ms = cuda_ms(lambda i: counting.blocked_counting_query_plain(cstate, cb[i % 4], clen, ccfg, croute),
                     3, warm=1)
    c_rows, c_row, cpos, c_owned = sharded_rows(ccfg, croute, cb[0], clen, ccfg.counters_per_block)
    ct = touched(c_row, cpos >> 3, ccfg.words_per_block, c_owned)
    ctable = cstate.view(torch.int32).reshape(-1, ccfg.words_per_block)
    clib_ms = cuda_ms(lambda i: torch.index_select(ctable, 0, c_row), 40, warm=4)
    c_in = B_SHARDED_COUNTING * (KEY_LEN + 4)
    cu_bytes = c_in + 2 * c_rows * row_bytes
    cq_bytes = c_in + B_SHARDED_COUNTING + c_rows * row_bytes
    cub, cuby = bound(cu_bytes, (OPS_ROUTE + OPS_COUNT_UPDATE) * B_SHARDED_COUNTING)
    cqb, cqby = bound(cq_bytes, (OPS_ROUTE + OPS_COUNT_QUERY) * B_SHARDED_COUNTING)
    out = {
        "batch": B_SHARDED, "rows_touched": rows_touched, "state_bytes": state.numel() * 4,
        "touched": t,
        "sharded_blocked_query": {
            "ms": q_ms, "present_ms": qpres_ms, "keys_per_s": B_SHARDED / q_ms * 1e3,
            "plain_ms": qp_ms, "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby,
            "bytes": q_bytes, "share_of_bound": qb / q_ms,
            "floor_ms": q_floor, "share_of_floor": q_floor / q_ms},
        "sharded_blocked_query_4_slots": slot,
        "sharded_blocked_insert": {
            "ms": i_ms, "replay_ms": replay_ms, "keys_per_s": B_SHARDED / i_ms * 1e3,
            "plain_ms": ip_ms, "library_ms": None, "bound_ms": ib, "bound_by": iby,
            "bytes": i_bytes, "share_of_bound": ib / i_ms, **rates(t, i_ms)},
        "counting_batch": B_SHARDED_COUNTING, "counting_rows_touched": c_rows,
        "counting_touched": ct,
        "sharded_blocked_counting_update": {
            "ms": ci_ms, "delete_ms": cd_ms, "keys_per_s": B_SHARDED_COUNTING / ci_ms * 1e3,
            "plain_ms": cip_ms, "plain_delete_ms": cdp_ms, "library_ms": None,
            "bound_ms": cub, "bound_by": cuby, "bytes": cu_bytes, "share_of_bound": cub / ci_ms,
            **rates(ct, ci_ms)},
        "sharded_blocked_counting_query": {
            "ms": cq_ms, "keys_per_s": B_SHARDED_COUNTING / cq_ms * 1e3, "plain_ms": cqp_ms,
            "library_ms": clib_ms, "bound_ms": cqb, "bound_by": cqby, "bytes": cq_bytes,
            "share_of_bound": cqb / cq_ms},
    }
    emit("sharded_times", **out)
    return out


def phase_sharded_end_to_end(f: ShardedBloomFilter, g: ShardedBloomFilter, rng, times: dict) -> None:
    big = rows(rng, B_SHARDED)
    ins, qry = times["sharded_blocked_insert"]["ms"], times["sharded_blocked_query"]["ms"]
    emit("sharded_end_to_end", **time_calls((
        ("insert_packed_1_slot", B_SHARDED, lambda: f.insert_packed(big), ins),
        ("include_packed_1_slot", B_SHARDED, lambda: f.include_packed(big), qry),
        # four launches a call, each routing the whole batch: not timed alone
        ("insert_packed_4_slots", B_SHARDED, lambda: g.insert_packed(big), None),
        ("include_packed_4_slots", B_SHARDED, lambda: g.include_packed(big), None),
    )))


# -- the flat layout -------------------------------------------------------------


FLAT_KERNELS = ("flat_insert", "flat_query", "flat_counting_update", "flat_counting_query",
                "sharded_flat_insert", "sharded_flat_query", "sharded_flat_counting_update",
                "sharded_flat_counting_query")


# The partitioned kernels, under their own launch counters; a tree without
# them (``--ab`` against a parent) times the flat counting pair, or the flat
# insert, as it is.
TILED = hasattr(sweep, "_flat_counting_update_on")
FUSED = hasattr(sweep, "_blocked_test_insert_on")  # the fused test-and-insert
BIT_TILED = hasattr(sweep, "_flat_insert_on")
FLAT_TILED = (("flat_counting_update_tiled", "flat_counting_query_tiled",
               "sharded_flat_counting_update_tiled", "sharded_flat_counting_query_tiled") if TILED else ()
              ) + (("flat_insert_tiled", "sharded_flat_insert_tiled") if BIT_TILED else ())
# The kernels of the flat counting pair and of the flat insert: the wrapper's
# own choice (None), or one held whatever the shape through sweep's private
# entries.
COUNTING_KERNELS = ("thread_a_key", "tiled") if TILED else (None,)
INSERT_KERNELS = ("thread_a_key", "tiled") if BIT_TILED else (None,)


OTHER_KERNEL = {"tiled": "thread_a_key", "thread_a_key": "tiled"}


def tiled_launches() -> int:
    """Partitioned launches so far (all four names)."""
    return sum(sweep.LAUNCHES[n] for n in FLAT_TILED)


def flat_config(log2m: int = LOG2M_FLAT, k: int = K_FLAT, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=k, key_len=KEY_LEN, **kw)


def flat_sharded_config(log2m: int, **kw) -> FilterConfig:
    return FilterConfig(m=1 << log2m, k=K, key_len=KEY_LEN, shards=SHARDS, **kw)


def flat_update(state, keys, lengths, cfg, *, increment=True, route=None, plain=False,
                kernel=None) -> None:
    """The flat insert (bit config) or counting update, kernel or plain; a
    ``kernel`` ("tiled" or "thread_a_key") holds that kernel."""
    if cfg.counting and kernel is not None and not plain:
        sweep._flat_counting_update_on(kernel == "tiled", state, keys, lengths, cfg,
                                       increment=increment, route=route)
    elif kernel is not None and not plain:
        sweep._flat_insert_on(kernel == "tiled", state, keys, lengths, cfg, route=route)
    elif cfg.counting:
        fn = counting.flat_counting_update_plain if plain else sweep.flat_counting_update
        fn(state, keys, lengths, cfg, increment=increment, route=route)
    elif plain:
        bitops.flat_insert_plain(state, keys, lengths, cfg, route)
    else:
        sweep.flat_insert(state, keys, lengths, cfg, route=route)


def flat_query(state, keys, lengths, cfg, *, route=None, plain=False, kernel=None) -> torch.Tensor:
    """The flat query (bit config) or counting query, kernel or plain; a
    counting ``kernel`` holds that kernel."""
    if plain:
        fn = counting.flat_counting_query_plain if cfg.counting else bitops.flat_query_plain
        return fn(state, keys, lengths, cfg, route)
    if cfg.counting and kernel is not None:
        return sweep._flat_counting_query_on(kernel == "tiled", state, keys, lengths, cfg, route=route)
    fn = sweep.flat_counting_query if cfg.counting else sweep.flat_query
    return fn(state, keys, lengths, cfg, route=route)


def other_kernel(cfg, variant: str, n: int, route, query: bool):
    """The kernel a wrapper did not take for a launch of ``n`` keys, where
    this tree has one that can hold the shape: None for the bit query (one
    kernel), in a tree without the partitioned kernels, or where the
    partition's plan refuses the shape."""
    if (query and not cfg.counting) or not (TILED if cfg.counting else BIT_TILED):
        return None
    other = OTHER_KERNEL[variant]
    if other == "tiled" and sweep.flat_tiled_scratch_bytes(cfg, n, route, query=query) < 0:
        return None
    return other


def flat_batch(rng, prev: torch.Tensor, batch: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Keys already in (a quarter of ``prev``), fresh keys with a repeat of
    a quarter of the batch inside it, a crowd of one key over an eighth of
    the batch (past saturation for counters), and tail padding; returns
    (keys, lengths, padded entries)."""
    dev = prev.device
    keys = torch.from_numpy(rows(rng, batch)).to(dev)
    q = batch // 4
    keys[:q] = prev[:q]
    keys[q : 2 * q] = keys[2 * q : 3 * q]
    keys[3 * q : 3 * q + batch // 8] = keys[3 * q].clone()
    lengths = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    n_pad = max(1, batch // 1024)
    lengths[-n_pad:] = -1
    keys[-n_pad:] = 0
    return keys, lengths, n_pad


def flat_vs_plain(cfg: FilterConfig, batch: int, rng, route=None) -> dict:
    """Populate a flat state (a slot's, with a route) with kernel batches,
    then run the same update(s) and query through the kernels and their
    plain versions from the same state: the bit filter's insert, or the
    counting filter's insert and a delete of half the batch and as many
    absent keys, then the same at B_FLAT_SPARSE keys, which the wrappers
    give the other kernel of the counting pair. ``ops`` records each op's
    kernel (``variant``) and its ``max_abs_err`` against the plain version;
    for the insert and the counting pair also (``other``) the same op
    through the kernel the wrapper did not take, where the partition holds
    the shape."""
    dev = torch.device("cuda")
    state = torch.zeros(sweep._state_words(cfg, route), dtype=torch.int32, device=dev).view(torch.uint32)
    full = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
    for _ in range(3):
        prev = torch.from_numpy(rows(rng, batch)).to(dev)
        flat_update(state, prev, full, cfg, route=route)
    keys, lengths, n_pad = flat_batch(rng, prev, batch)
    ops = [("insert", keys, lengths, True)]
    probes = [("query", torch.cat([prev[: batch // 2],
                                   torch.from_numpy(rows(rng, batch - batch // 2)).to(dev)]), lengths)]
    if cfg.counting:
        absent = torch.from_numpy(rows(rng, batch - batch // 2)).to(dev)
        ops.append(("delete", torch.cat([keys[: batch // 2], absent]).contiguous(), lengths, False))
        n = B_FLAT_SPARSE
        s_keys, s_lengths, _ = flat_batch(rng, prev, n)
        s_absent = torch.from_numpy(rows(rng, n - n // 2)).to(dev)
        ops += [("sparse_insert", s_keys, s_lengths, True),
                ("sparse_delete", torch.cat([s_keys[: n // 2], s_absent]).contiguous(), s_lengths, False)]
        probes.append(("sparse_query", torch.cat([prev[: n // 2], s_absent]).contiguous(), s_lengths))
    owned, _ = bitops.routed_positions(keys, lengths, cfg, route)
    out = {"m": cfg.m, "k": cfg.k, "batch": batch, "padded": n_pad, "owned": int(owned.sum()),
           "state_bytes": state.numel() * 4, "ops": {},
           "route": None if route is None else [route.n_shards, route.shard_lo, route.shards_per_dev]}
    # each op also through the kernel the wrapper did not take, on a copy of
    # the state, so both kernels meet every shape the partition holds
    s_plain = clone_u32(state)
    s_other = clone_u32(state)
    for op, k_, l_, increment in ops:
        before = tiled_launches()
        flat_update(state, k_, l_, cfg, increment=increment, route=route)
        variant = "tiled" if tiled_launches() > before else "thread_a_key"
        flat_update(s_plain, k_, l_, cfg, increment=increment, route=route, plain=True)
        torch.cuda.synchronize()
        out["ops"][op] = {"variant": variant, "keys": k_.shape[0], "max_abs_err": max_abs_err(state, s_plain)}
        check(equal_words(state, s_plain), f"flat {op} state m={cfg.m} {out['route']} ({variant})")
        other = other_kernel(cfg, variant, k_.shape[0], route, False)
        if other is None:  # the other kernel's state would drift from here
            s_other = None
        if s_other is not None:
            flat_update(s_other, k_, l_, cfg, increment=increment, route=route, kernel=other)
            torch.cuda.synchronize()
            out["ops"][op]["other"] = {"variant": other, "max_abs_err": max_abs_err(s_other, s_plain)}
            check(equal_words(s_other, s_plain), f"flat {op} state m={cfg.m} {out['route']} ({other})")
        if increment:
            n = k_.shape[0]
            crowd = k_[3 * (n // 4) : 3 * (n // 4) + 1]
            hot = flat_query(state, crowd, full[:1], cfg, route=route)
            hot_owned = bitops.routed_positions(crowd, full[:1], cfg, route)[0]
            check(bool(hot[0]) == bool(hot_owned[0]), "the crowded key is present after its insert")
    del s_plain, s_other
    for op, probe, l_ in probes:
        n = probe.shape[0]
        before = tiled_launches()
        q_k = flat_query(state, probe, l_, cfg, route=route)
        variant = "tiled" if tiled_launches() > before else "thread_a_key"
        q_p = flat_query(state, probe, l_, cfg, route=route, plain=True)
        torch.cuda.synchronize()
        check(torch.equal(q_k, q_p), f"flat {op} verdicts m={cfg.m} {out['route']} ({variant})")
        p_owned, _ = bitops.routed_positions(probe, l_, cfg, route)
        check(not bool(q_k[~p_owned].any()), "padding and keys the slot does not own answer False")
        out["ops"][op] = {"variant": variant, "keys": n, "max_abs_err": max_abs_err(q_k, q_p),
                          "hits_old_half": int(q_k[: n // 2].sum()),
                          "owned_old_half": int(p_owned[: n // 2].sum()),
                          "hits_fresh_half": int(q_k[n // 2 :].sum())}
        other = other_kernel(cfg, variant, n, route, True)
        if other is not None:
            q_o = flat_query(state, probe, l_, cfg, route=route, kernel=other)
            torch.cuda.synchronize()
            check(torch.equal(q_o, q_p), f"flat {op} verdicts m={cfg.m} {out['route']} ({other})")
            out["ops"][op]["other"] = {"variant": other, "max_abs_err": max_abs_err(q_o, q_p)}
    if not cfg.counting:
        q = out["ops"]["query"]
        check(q["hits_old_half"] == q["owned_old_half"], "owned old keys present")
    del state
    torch.cuda.empty_cache()
    return out


def phase_flat_kernel_vs_plain(rng) -> dict:
    one, quarter = ShardRoute(SHARDS, 0, SHARDS), ShardRoute(SHARDS, 16, SHARDS // N_SLOTS)
    cfg5 = flat_sharded_config(LOG2M_FLAT_SHARDED)
    cfg5_dense = flat_sharded_config(LOG2M_FLAT_SMALL)  # the FPR check's state: the partitioned insert
    cfg45 = flat_sharded_config(LOG2M_FLAT_COUNTING, counting=True)
    runs = {
        "config2": flat_vs_plain(flat_config(), B_FLAT, rng),
        "config1_mod": flat_vs_plain(FilterConfig(m=M_FLAT_MOD, k=K_FLAT_MOD, key_len=KEY_LEN), B_FLAT, rng),
        "config4": flat_vs_plain(flat_config(LOG2M_FLAT_COUNTING, K, counting=True), B_FLAT_COUNTING, rng),
        "config5_1_slot": flat_vs_plain(cfg5, B_FLAT_SHARDED, rng, one),
        "config5_slot_16_31": flat_vs_plain(cfg5, B_FLAT_SHARDED, rng, quarter),
        "config5_m2_26_1_slot": flat_vs_plain(cfg5_dense, B_FLAT_SHARDED, rng, one),
        "config5_m2_26_slot_16_31": flat_vs_plain(cfg5_dense, B_FLAT_SHARDED, rng, quarter),
        "configs4x5_1_slot": flat_vs_plain(cfg45, B_FLAT_COUNTING, rng, one),
        "configs4x5_slot_48_63": flat_vs_plain(cfg45, B_FLAT_COUNTING, rng, ShardRoute(SHARDS, 48, 16)),
    }

    def worst(names, query: bool, variant="thread_a_key"):
        errs = [x["max_abs_err"] for n in names for op, r in runs[n]["ops"].items()
                for x in (r, r.get("other")) if x and ("query" in op) == query and x["variant"] == variant]
        check(bool(errs), f"{names} ran the {variant} kernel")
        return max(errs)

    bits, counts = ("config2", "config1_mod"), ("config4",)
    sbits = ("config5_1_slot", "config5_slot_16_31", "config5_m2_26_1_slot", "config5_m2_26_slot_16_31")
    scounts = ("configs4x5_1_slot", "configs4x5_slot_48_63")
    errs = {
        "flat_insert": worst(bits, False), "flat_query": worst(bits, True),
        "flat_counting_update": worst(counts, False), "flat_counting_query": worst(counts, True),
        "sharded_flat_insert": worst(sbits, False), "sharded_flat_query": worst(sbits, True),
        "sharded_flat_counting_update": worst(scounts, False),
        "sharded_flat_counting_query": worst(scounts, True),
    }
    for name in FLAT_TILED:
        sharded = name.startswith("sharded")
        names = (sbits if sharded else bits) if "insert" in name else (scounts if sharded else counts)
        errs[name] = worst(names, "query" in name, "tiled")
    emit("flat_kernel_vs_plain", runs=runs, max_abs_err=errs, tolerance=0)
    return errs


def flat_fpr_check(f, rng, n_insert: int, n_probe: int) -> dict:
    """Fresh keys' hits against the flat model ``params.theoretical_fpr``,
    with the acceptance of tests/test_fpr_model.py."""
    f.insert_packed(rows(rng, n_insert))
    hits = int(f.include_packed(rows(rng, n_probe)).sum())
    c = f.config
    expect = n_probe * theoretical_fpr(c.m, c.k, f.n_inserted)
    tol = max(6.0 * math.sqrt(max(expect, 1.0)), 0.35 * expect, 8.0)
    check(abs(hits - expect) <= tol, f"flat FPR {hits} hits vs model {expect:.1f} ± {tol:.1f}")
    return {"m": c.m, "k": c.k, "shards": c.shards, "n_inserted": f.n_inserted, "probes": n_probe,
            "hits": hits, "model_hits": expect, "tolerance": tol}


def flat_round_trips(f, rng) -> dict:
    """The Redis bitmap (bit filters) and a checkpoint round trip of a
    filter at the cut size: equal words, verdicts and usage counters."""
    cls, cfg = type(f), f.config
    keys = rows(rng, N_FLAT_ROUND_TRIP)
    f.insert_packed(keys)
    probe = np.concatenate([keys[: N_FLAT_ROUND_TRIP // 4], rows(rng, N_FLAT_ROUND_TRIP // 4)])
    out = {"m": cfg.m, "counting": cfg.counting, "shards": cfg.shards}
    if not cfg.counting:
        t0 = time.perf_counter()
        bitmap = f.to_redis_bitmap()
        g = cls.from_redis_bitmap(cfg, bitmap)
        out["redis_bitmap_s"] = time.perf_counter() - t0
        check(len(bitmap) == cfg.m // 8, "Redis bitmap of ceil(m/8) bytes")
        check(np.array_equal(f._host_words(), g._host_words()), "Redis bitmap round trip words")
    t0 = time.perf_counter()
    _, seq, blob = checkpoint.snapshot_blob(f)
    g = checkpoint.restore_blob(blob)
    out["checkpoint_s"] = time.perf_counter() - t0
    header, _ = checkpoint._deserialize(blob)
    out.update(format=header["format"], blob_bytes=len(blob))
    check(header["format"] == ("counting_le_words" if cfg.counting else "redis_bitmap"), "blob format")
    check(type(g) is cls and all(t.is_cuda for t in g._state_tensors()), "restored on the card")
    check(np.array_equal(f._host_words(), g._host_words()), "restored words equal")
    check(np.array_equal(f.include_packed(probe), g.include_packed(probe)), "restored verdicts equal")
    check(g.n_inserted == f.n_inserted and g._restored_seq == seq, "restored usage counters and seq")
    return out


def phase_flat_path(rng):
    """The four flat filters through the entry points, at full size."""
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    steps, out = {}, {}
    # BASELINE config 2 (flat)
    f = BloomFilter(flat_config())  # no device: the card
    check(f.words.is_cuda and f.words.numel() == 1 << (LOG2M_FLAT - 5), "config 2 on the card, 128 MiB")
    big = rows(rng, B_FLAT)
    check(f.insert_packed(big) == B_FLAT, "insert_packed count")
    steps["insert_packed"] = sweep.launch_counts()
    if BIT_TILED:
        check(steps["insert_packed"]["flat_insert_tiled"] == 1 == steps["insert_packed"]["flat_insert"],
              "config 2's insert_packed of 2^20 keys took flat_insert_tiled")
    check(f.include_packed(big).all(), "packed replay all present")
    steps["include_packed"] = sweep.launch_counts()
    lens = rng.integers(0, KEY_LEN + 1, 10_000)
    keys = [rng.bytes(int(n)) for n in lens] + [b"", b"a"]
    f.insert_batch(keys)
    steps["insert_batch"] = sweep.launch_counts()
    if BIT_TILED:
        check(steps["insert_batch"]["flat_insert"] == 2 and steps["insert_batch"]["flat_insert_tiled"] == 1,
              "insert_batch of 10,002 bytes keys took the thread-a-key flat_insert")
    check(f.include_batch(keys).all(), "bytes keys all present")
    steps["include_batch"] = sweep.launch_counts()
    out["config2"] = {"n_inserted": f.n_inserted, "stats": f.stats(),
                      "fresh_hits": int(f.include_packed(rows(rng, B_FLAT)).sum()),
                      "fpr_fuller": flat_fpr_check(BloomFilter(flat_config(LOG2M_FLAT_SMALL)), rng,
                                                   N_FLAT_FPR, B_FLAT),
                      "round_trips": flat_round_trips(BloomFilter(flat_config(LOG2M_FLAT_SMALL)), rng)}
    steps["config2_checks"] = sweep.launch_counts()
    # BASELINE config 4 (flat counting)
    ccfg = flat_config(LOG2M_FLAT_COUNTING, K, counting=True)
    c = CountingBloomFilter(ccfg)
    bigc = rows(rng, B_FLAT_COUNTING)
    check(c.insert_packed(bigc) == B_FLAT_COUNTING, "counting insert_packed count")
    check(c.include_packed(bigc).all(), "counted keys all present")
    n_gone = B_FLAT_COUNTING // 64
    gone = [bytes(r) for r in bigc[:n_gone]]
    c.delete_batch(gone)
    after = c.include_batch(gone + [bytes(r) for r in bigc[n_gone : 2 * n_gone]])
    check(not after[:n_gone].any() and after[n_gone:].all(), "deleted keys absent, the others present")
    check(c.n_inserted == B_FLAT_COUNTING - n_gone, "n_inserted after the delete")
    g = CountingBloomFilter(ccfg)
    again = rows(rng, B_FLAT_COUNTING)
    g.insert_packed(again)
    g.delete_batch([bytes(r) for r in again])
    torch.cuda.synchronize()
    check(not bool(g.words.view(torch.int32).any()), "insert then delete returns to all-zero words")
    del g
    out["config4"] = {"n_inserted": c.n_inserted, "deleted": n_gone,
                      "round_trips": flat_round_trips(
                          CountingBloomFilter(flat_config(LOG2M_FLAT_SMALL_COUNTING, K, counting=True)), rng)}
    steps["counting"] = sweep.launch_counts()
    # BASELINE config 5 (flat) on one slot and on 4 slots of the card
    cfg5 = flat_sharded_config(LOG2M_FLAT_SHARDED)
    s1, s4 = ShardedBloomFilter(cfg5), ShardedBloomFilter(cfg5, devices=["cuda"] * N_SLOTS)
    check(len(s1.slot_words) == 1 and s1.slot_words[0].numel() * 4 == 1 << 33, "config 5: 8 GiB in one slot")
    bigs = rows(rng, B_FLAT_SHARDED)
    for s in (s1, s4):
        check(s.insert_packed(bigs) == B_FLAT_SHARDED, "sharded insert_packed count")
        s.insert_batch(keys)
    torch.cuda.synchronize()
    check(same_slots(s1, s4), "4-slot words equal the 1-slot words shard for shard")
    probe = np.concatenate([bigs, rows(rng, B_FLAT_SHARDED)])
    verdicts = s1.include_packed(probe)
    check(verdicts[:B_FLAT_SHARDED].all(), "sharded packed replay all present")
    check(np.array_equal(s4.include_packed(probe), verdicts), "4-slot verdicts equal")
    check(s1.include_batch(keys).all() and s4.include_batch(keys).all(), "sharded bytes keys present")
    out["config5"] = {"n_inserted": s1.n_inserted, "fresh_hits": int(verdicts[B_FLAT_SHARDED:].sum()),
                      "fpr_fuller": flat_fpr_check(
                          ShardedBloomFilter(flat_sharded_config(LOG2M_FLAT_SMALL)), rng, N_FLAT_FPR,
                          B_FLAT),
                      "round_trips": flat_round_trips(
                          ShardedBloomFilter(flat_sharded_config(LOG2M_FLAT_SMALL)), rng)}
    steps["sharded"] = sweep.launch_counts()
    # configs 4 x 5 (flat counting, 64 shards) on one slot and on 4 slots
    cfg45 = flat_sharded_config(LOG2M_FLAT_COUNTING, counting=True)
    sc1, sc4 = ShardedBloomFilter(cfg45), ShardedBloomFilter(cfg45, devices=["cuda"] * N_SLOTS)
    for s in (sc1, sc4):
        s.insert_packed(bigc)
        s.delete_batch(gone)
    torch.cuda.synchronize()
    check(same_slots(sc1, sc4), "4-slot counters equal the 1-slot counters shard for shard")
    probe_c = np.concatenate([bigc[: 2 * n_gone], rows(rng, n_gone)])
    hits_c = sc1.include_packed(probe_c)
    check(np.array_equal(sc4.include_packed(probe_c), hits_c), "4-slot counting verdicts equal")
    check(not hits_c[:n_gone].any() and hits_c[n_gone : 2 * n_gone].all(),
          "sharded: deleted keys absent, the others present")
    check(not sc1.include_batch(gone).any(), "sharded: deleted bytes keys absent")
    hits_full = sc1.include_packed(bigc)  # the whole batch: the partitioned query
    check(np.array_equal(sc4.include_packed(bigc), hits_full), "4-slot full-batch verdicts equal")
    check(not hits_full[:n_gone].any() and hits_full[n_gone:].all(),
          "sharded full batch: deleted keys absent, the others present")
    out["configs4x5"] = {"n_inserted": sc1.n_inserted, "deleted": n_gone,
                         "probe_hits_fresh": int(hits_c[2 * n_gone :].sum()),
                         "round_trips": flat_round_trips(ShardedBloomFilter(
                             flat_sharded_config(LOG2M_FLAT_SMALL_COUNTING, counting=True)), rng)}
    del sc4
    torch.cuda.synchronize()
    steps["sharded_counting"] = sweep.launch_counts()
    launches = sweep.launch_counts()
    for name in FLAT_KERNELS:
        check(launches[name] > 0, f"{name} launched on the flat path")
    for name in FLAT_TILED:  # both kernels of each insert and counting wrapper
        base = name.removesuffix("_tiled")
        check(launches[name] > 0 and launches[base] > launches[name],
              f"{name} and the thread-a-key {base} launched on the flat path")
    torch.cuda.empty_cache()
    emit("flat_path", launches=launches, launches_after_step=steps, seconds=time.perf_counter() - t0,
         **out)
    return launches, f, c, s1, s4, sc1


def flat_footprint(cfg: FilterConfig, keys, lengths, route=None):
    """What one launch's keys touch: the distinct words and 32-byte
    sectors of each valid key's positions, summed over the keys (one L2
    request a position in a thread-a-key kernel), and the sectors distinct
    over the whole launch (the bytes a bound counts). Returns (footprint,
    word index of each position int64[B, k], valid bool[B])."""
    valid, pos = bitops.routed_positions(keys, lengths, cfg, route)
    widx = pos // (8 if cfg.counting else 32)
    t = touched(torch.zeros_like(widx[:, 0]), widx, 1, valid)
    return {**t, "distinct_sectors": int(torch.unique(widx[valid] >> 3).numel())}, widx, valid


def query_reads(state, cfg: FilterConfig, keys, lengths, route=None) -> dict:
    """What the bit query, which stops a key at its first zero bit, needs to
    read of this state for these keys: each valid (owned) key's positions up
    to and including its first zero bit (all k of a held key), and the
    distinct 32-byte sectors of those reads over the launch (what its bound
    counts)."""
    valid, pos = bitops.routed_positions(keys, lengths, cfg, route)
    words = state.view(torch.int32).reshape(-1)
    zero = ((words[pos >> 5].to(torch.int64) >> (pos & 31)) & 1) == 0
    k = pos.shape[1]
    first = torch.where(zero.any(dim=1), zero.to(torch.int32).argmax(dim=1), k - 1)
    read = (torch.arange(k, device=pos.device)[None, :] <= first[:, None]) & valid[:, None]
    return {"keys": int(valid.sum()), "positions_read": int(read.sum()),
            "distinct_sectors": int(torch.unique(pos[read] >> 8).numel())}


def flat_bound(cfg: FilterConfig, n_keys: int, fp: dict, *, update: bool, routed: bool):
    """(bound ms, by, bytes): keys x 20 B in, the launch's distinct sectors
    x 32 B (read, and for an update written back), a verdict byte a key
    out of a query; the flat hash a valid key and a step a position (k a
    key, or the ``positions_read`` of a query that stops early), and the
    routing hash a key, routed, at the INT32 rate."""
    nbytes = n_keys * (KEY_LEN + 4) + fp["distinct_sectors"] * 32 * (2 if update else 1)
    nbytes += 0 if update else n_keys
    step = OPS_FLAT_COUNTER if cfg.counting else OPS_FLAT_BIT
    positions = fp.get("positions_read", fp["keys"] * cfg.k)
    ops = (OPS_ROUTE * n_keys if routed else 0) + fp["keys"] * OPS_FLAT_HASH + positions * step
    return (*bound(nbytes, ops), nbytes)


def query_group_ms(state, cfg, batches, lengths) -> dict | None:
    """The bit query's ms a launch with each key's loads issued G at a time,
    for G in QUERY_GROUPS (flat_bloom.cu ``tpb_flat_query_group``; the
    kernel ships kFlatQueryGroup), cycling through ``batches``, each G timed
    twice in turns (1, 2, 4, 4, 2, 1) and averaged; its verdicts are first
    held against the wrapper's. None in a tree without the entry."""
    lib = sweep._flat_library()
    if not hasattr(lib, "tpb_flat_query_group"):
        return None
    out = torch.empty(lengths.numel(), dtype=torch.uint8, device=state.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(g):
        def run(i):
            keys = batches[i % len(batches)]
            err = lib.tpb_flat_query_group(state.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
                                           out.data_ptr(), keys.shape[0], keys.shape[1], cfg.m, cfg.k,
                                           cfg.seed, g, stream)
            check(err == 0, f"tpb_flat_query_group({g}) launch")
        return run

    for g in QUERY_GROUPS:
        launch(g)(0)
        check(torch.equal(out.view(torch.bool), flat_query(state, batches[0], lengths, cfg)),
              f"query group {g} verdicts")
    ms = {g: [] for g in QUERY_GROUPS}
    for g in (*QUERY_GROUPS, *reversed(QUERY_GROUPS)):
        ms[g].append(cuda_ms(launch(g), 40, warm=4))
    return {str(g): sum(v) / len(v) for g, v in ms.items()}


def bits_set(state: torch.Tensor) -> int:
    """The set bits of a flat bit state, counted on the card."""
    table = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.uint8, device=state.device)
    return int(table[state.view(torch.uint8).reshape(-1).to(torch.int64)].sum(dtype=torch.int64))


def config2_traffic(cfg, fresh) -> dict:
    """Config 2's own traffic (benchmarks/run.py config2 at scale 1): on a
    fresh state, the insert of N_CONFIG2 keys made on the card from SEED in
    launches of B_FLAT (95, then a tail of 385,280 valid keys, padded), and
    the fill it reaches (run.py's ~0.606); the query of the first batch
    inserted (held) and of a fresh batch (absent) in turns, as run.py's query
    loop alternates seed 0 and seed 10^6, each held against the plain
    version, and each alone; the query group sizes on that traffic; then the
    insert of ``fresh`` batches into the full state on each insert kernel."""
    dev = torch.device("cuda")
    n = B_FLAT
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def batch():
        return torch.randint(0, 256, (n, KEY_LEN), dtype=torch.uint8, device=dev, generator=gen)

    full = torch.full((n,), KEY_LEN, dtype=torch.int32, device=dev)
    steps, tail = divmod(N_CONFIG2, n)
    state = torch.zeros(cfg.n_words, dtype=torch.int32, device=dev).view(torch.uint32)
    held = batch()
    flat_update(state, held, full, cfg)
    for _ in range(steps - 1):
        flat_update(state, batch(), full, cfg)
    t_len = full.clone()
    t_len[tail:] = -1
    flat_update(state, batch(), t_len, cfg)
    absent = batch()
    out = {"keys": N_CONFIG2, "launches": steps + 1, "fill": bits_set(state) / cfg.m,
           "model_fill": 1 - math.exp(-cfg.k * N_CONFIG2 / cfg.m)}
    for label, keys in (("held", held), ("absent", absent)):
        got = flat_query(state, keys, full, cfg)
        check(torch.equal(got, flat_query(state, keys, full, cfg, plain=True)),
              f"config 2 traffic: {label} verdicts")
        out[f"{label}_hits"] = int(got.sum())
        out[f"{label}_reads"] = query_reads(state, cfg, keys, full)
        out[f"{label}_bound_ms"] = flat_bound(cfg, n, out[f"{label}_reads"], update=False, routed=False)[0]
    out["query_bound_ms"] = (out["held_bound_ms"] + out["absent_bound_ms"]) / 2  # a launch, in turns
    check(out["held_hits"] == n, "config 2 traffic: the held batch present")
    pair = [held, absent]
    out["query_ms"] = cuda_ms(lambda i: flat_query(state, pair[i % 2], full, cfg), 40, warm=4)
    out["query_held_ms"] = cuda_ms(lambda i: flat_query(state, held, full, cfg), 40, warm=4)
    out["query_absent_ms"] = cuda_ms(lambda i: flat_query(state, absent, full, cfg), 40, warm=4)
    out["query_group_ms"] = query_group_ms(state, cfg, pair, full)
    for kernel in INSERT_KERNELS:
        out[f"insert_{kernel or 'wrapper'}_ms"] = fresh_ms(
            state, lambda i: flat_update(state, fresh[i % len(fresh)], full, cfg, kernel=kernel), 20)
    del state
    torch.cuda.empty_cache()
    return out


def flat_pair_times(name: str, state, cfg, batches, lengths, fresh, crowd, route=None) -> dict:
    """The times of the flat insert on each of its kernels that can take the
    shape (in a tree without the partitioned insert, the wrapper's) and of
    its query, each beside its bound, its plain version and, for the query,
    the gather ``words[widx]`` of the launch's B k words. The insert's
    ``ms`` is fresh (``fresh`` batches), ``replay_ms`` a re-insert of
    ``batches``, ``crowd_ms`` a fresh insert of ``crowd`` (an eighth of it
    one key). The query's ``ms`` is on ``batches`` before they are
    inserted (absent keys), ``present_ms`` after; unrouted, also with each
    group size of loads in flight (``group_ms``, ``present_group_ms``)."""
    n = lengths.numel()
    routed = route is not None
    qname = name.replace("insert", "query")
    c_keys, c_len = crowd

    def upd(keys, lens=lengths, plain=False, kernel=None):
        return lambda i: flat_update(state, keys(i), lens, cfg, route=route, plain=plain, kernel=kernel)

    def qry(plain=False):
        return lambda i: flat_query(state, batches[i % 4], lengths, cfg, route=route, plain=plain)

    q_ms = cuda_ms(qry(), 40, warm=4)  # the batches before they are inserted
    q_groups = None if routed else query_group_ms(state, cfg, batches, lengths)
    reads = query_reads(state, cfg, batches[0], lengths, route)
    fp_u, _, _ = flat_footprint(cfg, fresh[0], lengths, route)
    ub, uby, u_bytes = flat_bound(cfg, n, fp_u, update=True, routed=routed)
    kernels = [k for k in INSERT_KERNELS
               if k != "tiled" or sweep.flat_tiled_scratch_bytes(cfg, n, route, query=False) >= 0]
    out = {}
    for kernel in kernels:
        u = {"replay_ms": cuda_ms(upd(lambda i: batches[i % 4], kernel=kernel), 40, warm=4)}
        u["ms"] = fresh_ms(state, upd(lambda i: fresh[i % 4], kernel=kernel), 40)
        u["crowd_ms"] = fresh_ms(state, upd(lambda i: c_keys, c_len, kernel=kernel), 20)
        out[name + ("_tiled" if kernel == "tiled" else "")] = {
            **u, "keys_per_s": n / u["ms"] * 1e3, "library_ms": None, "bound_ms": ub, "bound_by": uby,
            "bytes": u_bytes, "share_of_bound": ub / u["ms"], "touched": fp_u, **rates(fp_u, u["ms"])}
    u_plain = cuda_ms(upd(lambda i: batches[i % 4], plain=True), 3, warm=1)
    for v in out.values():
        v["plain_ms"] = u_plain
    if "tiled" in kernels:  # its six launches, on re-inserts of the fresh batches
        out[name + "_tiled"]["by_kernel_ms"] = kernel_ms(upd(lambda i: fresh[i % 4], kernel="tiled"))
        out[name + "_tiled"]["partition"] = flat_partition(cfg, fresh[0], lengths, route)
        out[name + "_tiled"]["crowd_partition"] = flat_partition(cfg, c_keys, c_len, route)
    qpres_ms = cuda_ms(qry(), 40, warm=4)
    p_groups = None if routed else query_group_ms(state, cfg, batches, lengths)
    p_reads = query_reads(state, cfg, batches[0], lengths, route)
    qp_ms = cuda_ms(qry(plain=True), 3, warm=1)
    fp_q, widx, _ = flat_footprint(cfg, batches[0], lengths, route)
    words, flat_idx = state.view(torch.int32).reshape(-1), widx.reshape(-1)
    lib_ms = cuda_ms(lambda i: torch.index_select(words, 0, flat_idx), 40, warm=4)
    qb, qby, q_bytes = flat_bound(cfg, n, reads, update=False, routed=routed)
    pb = flat_bound(cfg, n, p_reads, update=False, routed=routed)[0]
    out[qname] = {"ms": q_ms, "present_ms": qpres_ms, "keys_per_s": n / q_ms * 1e3, "plain_ms": qp_ms,
                  "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby, "bytes": q_bytes,
                  "share_of_bound": qb / q_ms, "present_bound_ms": pb, "present_share_of_bound": pb / qpres_ms,
                  "reads": reads, "present_reads": p_reads, "touched": fp_q, "group_ms": q_groups,
                  "present_group_ms": p_groups}
    return out


def flat_partition(cfg, keys, lengths, route=None) -> dict:
    """What a partitioned launch of these keys puts in flat_partition.cuh's
    tiles (its tile and piece read back from the library): tiles touched,
    the fullest tile's entries, sweep CTAs, and the scratch it plans."""
    n = keys.shape[0]
    tile_log2, piece = sweep.flat_tile_geometry()
    # a tree before the bit insert's partition counts only counters, in counting
    tile_counts = getattr(bitops, "flat_tile_counts_plain", None) or counting.flat_tile_counts_plain
    per_tile = tile_counts(keys, lengths, cfg, tile_log2, route)
    pieces = (per_tile + piece - 1) // piece
    share = 1.0 if route is None else route.shards_per_dev / route.n_shards
    if cfg.counting:
        plan = {"crossover": sweep.FLAT_TILE_CROSSOVER, "query_crossover": sweep.FLAT_TILE_QUERY_CROSSOVER,
                "update_scratch_bytes": sweep.flat_tiled_scratch_bytes(cfg, n, route, query=False),
                "query_scratch_bytes": sweep.flat_tiled_scratch_bytes(cfg, n, route, query=True)}
    else:
        plan = {"crossover": sweep.FLAT_BIT_TILE_CROSSOVER,
                "insert_scratch_bytes": sweep.flat_tiled_scratch_bytes(cfg, n, route, query=False)}
    return {**plan, "expected_per_sector": n * cfg.k * share / (sweep._state_words(cfg, route) / 8),
            "tile_log2": tile_log2, "piece": piece, "n_tiles": int(per_tile.numel()),
            "tiles_touched": int((per_tile > 0).sum()), "max_tile_entries": int(per_tile.max()),
            "sweep_ctas": int(pieces.sum())}


def nonzero_share(state: torch.Tensor) -> float:
    """The share of a flat counting state's counters that are non-zero."""
    words = state.view(torch.int32).reshape(-1)
    return sum(int((((words >> (4 * j)) & 15) != 0).sum()) for j in range(8)) / (words.numel() * 8)


def half_full_query(state, cfg, batches, lengths, route=None) -> dict:
    """Each query kernel's time on absent keys (``batches``) in a copy of
    the state filled with N_HALF_FULL_BATCHES more batches of keys made on
    the card from SEED, and the share of its counters that are non-zero."""
    full = clone_u32(state)
    gen = torch.Generator(device=state.device).manual_seed(SEED)
    n = lengths.numel()
    for _ in range(N_HALF_FULL_BATCHES):
        keys = torch.randint(0, 256, (n, KEY_LEN), dtype=torch.uint8, device=state.device, generator=gen)
        flat_update(full, keys, lengths, cfg, route=route)
    out = {"nonzero_share": nonzero_share(full)}
    for kernel in COUNTING_KERNELS:
        out[kernel] = cuda_ms(lambda i: flat_query(full, batches[i % 4], lengths, cfg, route=route,
                                                   kernel=kernel), 40, warm=4)
    del full
    torch.cuda.empty_cache()
    return out


def config4_mix(cfg, route=None) -> dict:
    """Config 4's own traffic (benchmarks/run.py config4 at scale 1): on a
    fresh state (a slot's, with a route), the insert of N_CONFIG4 keys made
    on the card from SEED, the delete of the first half, then the query of
    all N_CONFIG4, half held and half absent, each call one launch padded
    to a power of two as the port's filters pad it. Each query kernel's time
    on that launch, its verdicts held against the plain version."""
    dev = torch.device("cuda")
    n = N_CONFIG4
    bp = 1 << (n - 1).bit_length()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.zeros((bp, KEY_LEN), dtype=torch.uint8, device=dev)
    keys[:n] = torch.randint(0, 256, (n, KEY_LEN), dtype=torch.uint8, device=dev, generator=gen)
    lengths = torch.full((bp,), KEY_LEN, dtype=torch.int32, device=dev)
    lengths[n:] = -1
    d_lengths = lengths[: bp // 2].clone()
    d_lengths[n // 2 :] = -1
    state = torch.zeros(sweep._state_words(cfg, route), dtype=torch.int32, device=dev).view(torch.uint32)
    flat_update(state, keys, lengths, cfg, route=route)
    flat_update(state, keys[: bp // 2], d_lengths, cfg, increment=False, route=route)
    want = flat_query(state, keys, lengths, cfg, route=route, plain=True)
    owned = bitops.routed_positions(keys[n // 2 : n], lengths[n // 2 : n], cfg, route)[0]
    check(bool(want[n // 2 : n][owned].all()), "config 4 mix: the held half present")
    out = {"keys": n, "launch_keys": bp, "nonzero_share": nonzero_share(state),
           "hits": int(want.sum())}
    for kernel in COUNTING_KERNELS:
        got = flat_query(state, keys, lengths, cfg, route=route, kernel=kernel)
        check(torch.equal(got, want), f"config 4 mix verdicts ({kernel})")
        out[kernel] = cuda_ms(lambda i: flat_query(state, keys, lengths, cfg, route=route, kernel=kernel),
                              20, warm=2)
    del state, keys, want
    torch.cuda.empty_cache()
    return out


def host_us(fn, n: int = N_HOST_CALLS) -> float:
    """Mean microseconds of host clock a call of ``fn(i)`` takes, issued
    back to back (one synchronise after the last): what the host spends to
    issue it, which bounds a stream of small calls."""
    fn(0)
    fn(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def call_us(fn, n: int = N_HOST_CALLS // 4) -> float:
    """Median microseconds of host clock of one call of ``fn(i)`` and a
    synchronise after it: the latency a caller that waits for each call
    sees."""
    fn(0)
    fn(1)
    torch.cuda.synchronize()
    spans = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
    return float(np.median(spans)) * 1e6


def sparse_host(state, cfg, keys, lengths, route=None) -> dict:
    """The flat counting wrappers at B_FLAT_SPARSE keys on the host clock,
    as a user calls them (the thread-a-key kernel at this size): a call
    issued back to back and a call waited for, the update alternating an
    insert and a delete of the batch; and the query's parts, its argument
    checks and its bare launch (``sweep._launch_query``), to place a
    difference between two trees."""
    spec = sweep._flat_args(cfg, route)
    lib = sweep._flat_library()

    def qry(i):
        return sweep.flat_counting_query(state, keys, lengths, cfg, route=route)

    def upd(i):
        sweep.flat_counting_update(state, keys, lengths, cfg, increment=i % 2 == 0, route=route)

    out = {"query_us": host_us(qry), "query_sync_us": call_us(qry),
           "update_us": host_us(upd), "update_sync_us": call_us(upd),
           "query_check_us": host_us(lambda i: sweep._check(state, keys, lengths, cfg, route,
                                                            counters=True, flat=True)),
           "query_launch_us": host_us(lambda i: sweep._launch_query(
               lib, "flat_counting_query", state, keys, lengths, spec, route))}
    if TILED:  # the wrapper's choice of kernel, which the parent does not make
        out["query_choice_us"] = host_us(lambda i: sweep._takes_tiles(cfg, keys.shape[0], route, True))
    torch.cuda.synchronize()
    return out


def host_only() -> dict:
    """sparse_host alone in a fresh process, N_HOST_ROUNDS rounds each on
    config 4 flat and one slot of configs 4 x 5 flat, with the card's own
    time of the query (``query_device_us``), at four points of the
    process's life: on states filled by 2^16-key batches (the thread-a-key
    kernels in any tree, so that two trees' processes have done the same
    work); after a scratch-sized device allocation, freed; after an update
    of B_FLAT_COUNTING keys held on the thread-a-key kernel (a tree with
    both kernels); after one through the wrapper (the partitioned kernel
    where a tree has it). It places a difference of the small calls
    between two trees in the wrapper or in what a large launch leaves."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    c = CountingBloomFilter(flat_config(LOG2M_FLAT_COUNTING, K, counting=True))
    sc = ShardedBloomFilter(flat_sharded_config(LOG2M_FLAT_COUNTING, counting=True))
    keys = torch.from_numpy(rows(rng, B_FLAT_SPARSE)).to(dev)
    lengths = torch.full((B_FLAT_SPARSE,), KEY_LEN, dtype=torch.int32, device=dev)
    cases = (("flat_counting", c.words, c.config, None),
             ("sharded_flat_counting", sc.slot_words[0], sc.config, sc.routes[0]))
    for _, state, cfg, route in cases:
        for _ in range(B_FLAT_COUNTING // B_FLAT_SPARSE):
            sweep.flat_counting_update(state, torch.from_numpy(rows(rng, B_FLAT_SPARSE)).to(dev), lengths,
                                       cfg, increment=True, route=route)
    out = {}

    def measure(stage):
        for name, state, cfg, route in cases:
            rs = [sparse_host(state, cfg, keys, lengths, route) for _ in range(N_HOST_ROUNDS)]
            dev_ms = device_ms(lambda i: sweep.flat_counting_query(state, keys, lengths, cfg, route=route))
            dev_us = None if dev_ms is None else dev_ms * 1e3
            out[f"{name}{stage}"] = [{**r, "query_device_us": dev_us} for r in rs]

    measure("")
    scratch = torch.empty(HOST_SCRATCH_BYTES, dtype=torch.uint8, device=dev)
    del scratch
    measure("_after_alloc")
    big = [torch.from_numpy(rows(rng, B_FLAT_COUNTING)).to(dev) for _ in range(2)]
    big_len = torch.full((B_FLAT_COUNTING,), KEY_LEN, dtype=torch.int32, device=dev)
    if TILED:
        for _, state, cfg, route in cases:
            flat_update(state, big[0], big_len, cfg, route=route, kernel="thread_a_key")
        measure("_after_thread_big")
    for _, state, cfg, route in cases:
        sweep.flat_counting_update(state, big[1], big_len, cfg, increment=True, route=route)
    measure("_after_big")
    return out


def flat_counting_times(name: str, state, cfg, batches, lengths, crowd, route=None) -> dict:
    """The flat counting pair (``name`` is the update's) on each of its
    kernels (only the one a tree has without the partitioned kernels), at
    the path's batch and at B_FLAT_SPARSE keys: an insert then a delete of
    the same batch (as benchmarks/counting_rate.py), the same for ``crowd``
    (an eighth of it one key), and the query of absent keys (``ms``), of
    held ones (``present_ms``), on config 4's own traffic (``mix_ms``,
    config4_mix) and in a filter half full; beside the bound, the plain
    versions and, for the query, the gather ``words[widx]`` of the launch's
    B k words. At B_FLAT_SPARSE keys also the wrappers' host clock
    (sparse_host)."""
    n = lengths.numel()
    routed = route is not None
    qname = name.replace("update", "query")
    sparse, s_len = [b[:B_FLAT_SPARSE] for b in batches], lengths[:B_FLAT_SPARSE]
    c_keys, c_len = crowd

    def upd(bs, lens, increment=True, plain=False, kernel=None):
        return lambda i: flat_update(state, bs[i % len(bs)], lens, cfg, increment=increment, route=route,
                                     plain=plain, kernel=kernel)

    def qry(bs, lens, plain=False, kernel=None):
        return lambda i: flat_query(state, bs[i % len(bs)], lens, cfg, route=route, plain=plain,
                                    kernel=kernel)

    fp, widx, _ = flat_footprint(cfg, batches[0], lengths, route)
    fp_s, _, _ = flat_footprint(cfg, sparse[0], s_len, route)
    ub, uby, u_bytes = flat_bound(cfg, n, fp, update=True, routed=routed)
    qb, qby, q_bytes = flat_bound(cfg, n, fp, update=False, routed=routed)
    s_ub = flat_bound(cfg, B_FLAT_SPARSE, fp_s, update=True, routed=routed)[0]
    s_qb = flat_bound(cfg, B_FLAT_SPARSE, fp_s, update=False, routed=routed)[0]
    p_ms, pd_ms = event_pairs_ms([upd(batches, lengths, plain=True), upd(batches, lengths, False, True)],
                                 3, warm=1)
    qp_ms = cuda_ms(qry(batches, lengths, plain=True), 3, warm=1)
    words, flat_idx = state.view(torch.int32).reshape(-1), widx.reshape(-1)
    lib_ms = cuda_ms(lambda i: torch.index_select(words, 0, flat_idx), 40, warm=4)
    half = half_full_query(state, cfg, batches, lengths, route)
    mix = config4_mix(cfg, route)
    host = sparse_host(state, cfg, sparse[0], s_len, route)
    out = {}
    for kernel in COUNTING_KERNELS:
        suffix = "_tiled" if kernel == "tiled" else ""
        i_ms, d_ms = event_pairs_ms([upd(batches, lengths, kernel=kernel),
                                     upd(batches, lengths, False, kernel=kernel)], 40)
        si_ms, sd_ms = event_pairs_ms([upd(sparse, s_len, kernel=kernel),
                                       upd(sparse, s_len, False, kernel=kernel)], 40)
        s_dev = device_ms(lambda i: (upd(sparse, s_len, kernel=kernel)(i),
                                     upd(sparse, s_len, False, kernel=kernel)(i)))
        s_dev = None if s_dev is None else s_dev / 2
        sq_dev = device_ms(qry(sparse, s_len, kernel=kernel))
        ci_ms, cd_ms = event_pairs_ms([upd([c_keys], c_len, kernel=kernel),
                                       upd([c_keys], c_len, False, kernel=kernel)], 20)
        q_ms = cuda_ms(qry(batches, lengths, kernel=kernel), 40, warm=4)
        sq_ms = cuda_ms(qry(sparse, s_len, kernel=kernel), 40, warm=4)
        upd(batches, lengths, kernel=kernel)(0)
        pres_ms = cuda_ms(qry(batches[:1], lengths, kernel=kernel), 40, warm=4)
        upd(batches, lengths, False, kernel=kernel)(0)
        out[name + suffix] = {
            "ms": i_ms, "delete_ms": d_ms, "keys_per_s": n / i_ms * 1e3,
            "sparse_ms": si_ms, "sparse_delete_ms": sd_ms, "sparse_device_ms": s_dev,
            "crowd_ms": ci_ms, "crowd_delete_ms": cd_ms,
            "plain_ms": p_ms, "plain_delete_ms": pd_ms, "library_ms": None, "bound_ms": ub,
            "bound_by": uby, "bytes": u_bytes, "share_of_bound": ub / i_ms, "sparse_bound_ms": s_ub,
            "touched": fp, "sparse_touched": fp_s, **rates(fp, i_ms)}
        out[qname + suffix] = {
            "ms": q_ms, "present_ms": pres_ms, "mix_ms": mix[kernel], "sparse_ms": sq_ms,
            "sparse_device_ms": sq_dev, "keys_per_s": n / q_ms * 1e3,
            "plain_ms": qp_ms, "library_ms": lib_ms, "bound_ms": qb, "bound_by": qby, "bytes": q_bytes,
            "share_of_bound": qb / q_ms, "sparse_bound_ms": s_qb, "touched": fp,
            "half_full_ms": half[kernel], "half_full_nonzero_share": half["nonzero_share"],
            "mix": {k: v for k, v in mix.items() if k not in COUNTING_KERNELS}}
        if kernel != "tiled":
            out[name + suffix]["sparse_host"] = out[qname + suffix]["sparse_host"] = host
        else:
            out[name + suffix]["partition"] = flat_partition(cfg, batches[0], lengths, route)
            out[name + suffix]["crowd_partition"] = flat_partition(cfg, c_keys, c_len, route)
    return out


def dense_routed_insert(rng) -> dict:
    """The routed partitioned insert at a dense sharded shape, config 2's
    m=2^30 bits and k=10 over 64 shards on one slot (config 5 flat's own
    2^18-key batch on 2^36 bits stays on the thread-a-key kernel, whose
    plan its 2^17 tiles would exceed too), at config 2's batch: its times
    as flat_pair_times gives them, and the thread-a-key kernel's
    (``thread_a_key_ms``) on the same state."""
    g = ShardedBloomFilter(FilterConfig(m=1 << LOG2M_FLAT, k=K_FLAT, key_len=KEY_LEN, shards=SHARDS))
    state, route = g.slot_words[0], g.routes[0]
    dev = state.device
    flat_update(state, torch.from_numpy(rows(rng, B_FLAT)).to(dev),
                torch.full((B_FLAT,), KEY_LEN, dtype=torch.int32, device=dev), g.config, route=route)
    batches = [torch.from_numpy(rows(rng, B_FLAT)).to(dev) for _ in range(4)]
    fresh = [torch.from_numpy(rows(rng, B_FLAT)).to(dev) for _ in range(4)]
    lengths = torch.full((B_FLAT,), KEY_LEN, dtype=torch.int32, device=dev)
    crowd = flat_batch(rng, batches[0], B_FLAT)[:2]
    t = flat_pair_times("sharded_flat_insert", state, g.config, batches, lengths, fresh, crowd, route)
    out = t["sharded_flat_insert_tiled"]
    out.update(shape={"m": g.config.m, "k": g.config.k, "shards": SHARDS, "batch": B_FLAT},
               thread_a_key_ms=t["sharded_flat_insert"]["ms"], query_ms=t["sharded_flat_query"]["ms"])
    del g, state, batches, fresh, crowd
    torch.cuda.empty_cache()
    return out


def phase_flat_times(f, c, s1, sc1, rng) -> dict:
    out = {}
    for name, state, cfg, route, batch in (
        ("flat_insert", f.words, f.config, None, B_FLAT),
        ("flat_counting_update", c.words, c.config, None, B_FLAT_COUNTING),
        ("sharded_flat_insert", s1.slot_words[0], s1.config, s1.routes[0], B_FLAT_SHARDED),
        ("sharded_flat_counting_update", sc1.slot_words[0], sc1.config, sc1.routes[0], B_FLAT_COUNTING),
    ):
        dev = state.device
        batches = [torch.from_numpy(rows(rng, batch)).to(dev) for _ in range(4)]
        lengths = torch.full((batch,), KEY_LEN, dtype=torch.int32, device=dev)
        crowd = flat_batch(rng, batches[0], batch)[:2]
        if cfg.counting:
            out.update(flat_counting_times(name, state, cfg, batches, lengths, crowd, route))
        else:
            fresh = [torch.from_numpy(rows(rng, batch)).to(dev) for _ in range(4)]
            out.update(flat_pair_times(name, state, cfg, batches, lengths, fresh, crowd, route))
            if route is None:  # config 2's own traffic, on its insert kernels and query
                traffic = config2_traffic(cfg, fresh)
                out["flat_query"]["config2_traffic"] = traffic
                out["flat_query"]["config2_ms"] = traffic["query_ms"]
                for kernel in INSERT_KERNELS:
                    suffix = "_tiled" if kernel == "tiled" else ""
                    out[name + suffix]["config2_ms"] = traffic[f"insert_{kernel or 'wrapper'}_ms"]
            del fresh
        del batches, crowd
    if BIT_TILED:
        out["sharded_flat_insert_tiled"] = dense_routed_insert(rng)
    emit("flat_times", **out)
    return out


def crossover_at(runs: list, op: str):
    """The smallest positions a sector from which the partitioned kernel is
    the faster at every larger batch of ``runs``, or None."""
    at = None
    for r in reversed(runs):
        if r[f"tiled_{op}_ms"] >= r[f"thread_a_key_{op}_ms"]:
            break
        at = r["positions_per_sector"]
    return at


def phase_flat_crossover(f, c, rng) -> dict:
    """Both kernels of the flat counting pair on config 4 flat's state over
    B = 2^13 .. 2^22: an insert then a delete of the same batch, and the
    query on config 4's own traffic (the batch's first half inserted
    before it and deleted after it, so half held and half absent) and on
    absent keys; and both kernels of the flat insert on config 2's state
    over B = 2^13 .. 2^20, fresh inserts (the state restored and the L2
    flushed before each). The crossover of each is the smallest B from
    which the partitioned kernel is the faster at every larger B (the
    counting query's, on config 4's traffic), given as positions per
    32-byte sector of the state (what sweep.FLAT_TILE_CROSSOVER,
    FLAT_TILE_QUERY_CROSSOVER and FLAT_BIT_TILE_CROSSOVER hold)."""
    cfg, state = c.config, c.words
    sectors = sweep._state_words(cfg) / 8
    top = 1 << max(LOG2B_CROSSOVER)
    big = [torch.from_numpy(rows(rng, top)).to(state.device) for _ in range(2)]
    full = torch.full((top,), KEY_LEN, dtype=torch.int32, device=state.device)
    runs = []
    for lb in LOG2B_CROSSOVER:
        n = 1 << lb
        bs, lens = [b[:n] for b in big], full[:n]
        row = {"batch": n, "positions_per_sector": n * cfg.k / sectors}
        for kernel in ("thread_a_key", "tiled"):
            i_ms, d_ms = event_pairs_ms(
                [lambda i: flat_update(state, bs[i % 2], lens, cfg, kernel=kernel),
                 lambda i: flat_update(state, bs[i % 2], lens, cfg, increment=False, kernel=kernel)], 20)
            qa_ms = cuda_ms(lambda i: flat_query(state, bs[i % 2], lens, cfg, kernel=kernel), 20, warm=2)
            flat_update(state, bs[0][: n // 2], lens[: n // 2], cfg)
            q_ms = cuda_ms(lambda i: flat_query(state, bs[0], lens, cfg, kernel=kernel), 20, warm=2)
            flat_update(state, bs[0][: n // 2], lens[: n // 2], cfg, increment=False)
            row.update({f"{kernel}_update_ms": (i_ms + d_ms) / 2, f"{kernel}_query_ms": q_ms,
                        f"{kernel}_query_absent_ms": qa_ms})
        runs.append(row)
    out = {"runs": runs, "update_crossover": crossover_at(runs, "update"),
           "query_crossover": crossover_at(runs, "query"),
           "query_absent_crossover": crossover_at(runs, "query_absent"),
           "crossover_in_use": sweep.FLAT_TILE_CROSSOVER,
           "query_crossover_in_use": sweep.FLAT_TILE_QUERY_CROSSOVER}
    del big
    if BIT_TILED:
        cfg, state = f.config, f.words
        sectors = cfg.n_words / 8
        fresh = [torch.from_numpy(rows(rng, 1 << max(LOG2B_BIT_CROSSOVER))).to(state.device)
                 for _ in range(2)]
        bit_runs = []
        for lb in LOG2B_BIT_CROSSOVER:
            n = 1 << lb
            row = {"batch": n, "positions_per_sector": n * cfg.k / sectors}
            for kernel in ("thread_a_key", "tiled"):
                row[f"{kernel}_insert_ms"] = fresh_ms(
                    state, lambda i: flat_update(state, fresh[i % 2][:n], full[:n], cfg, kernel=kernel), 20)
            bit_runs.append(row)
        out.update(insert_runs=bit_runs, insert_crossover=crossover_at(bit_runs, "insert"),
                   insert_crossover_in_use=sweep.FLAT_BIT_TILE_CROSSOVER)
        del fresh
    emit("flat_crossover", **out)
    return out


def phase_flat_end_to_end(f, c, s1, s4, rng, times: dict) -> None:
    big, bigc, bigs = rows(rng, B_FLAT), rows(rng, B_FLAT_COUNTING), rows(rng, B_FLAT_SHARDED)
    small = [bytes(r) for r in rows(rng, 1 << 16)]
    emit("flat_end_to_end", **time_calls((
        ("insert_packed", B_FLAT, lambda: f.insert_packed(big),
         times["flat_insert_tiled" if BIT_TILED else "flat_insert"]["ms"]),
        ("include_packed", B_FLAT, lambda: f.include_packed(big), times["flat_query"]["ms"]),
        ("counting_insert_packed", B_FLAT_COUNTING, lambda: c.insert_packed(bigc),
         times["flat_counting_update_tiled"]["ms"]),
        ("counting_include_packed", B_FLAT_COUNTING, lambda: c.include_packed(bigc),
         times["flat_counting_query_tiled"]["ms"]),
        ("counting_delete_bytes_keys", len(small), lambda: c.delete_batch(small), None),
        ("sharded_insert_packed_1_slot", B_FLAT_SHARDED, lambda: s1.insert_packed(bigs),
         times["sharded_flat_insert"]["ms"]),
        ("sharded_include_packed_1_slot", B_FLAT_SHARDED, lambda: s1.include_packed(bigs),
         times["sharded_flat_query"]["ms"]),
        # four launches a call, each routing the whole batch: not timed alone
        ("sharded_insert_packed_4_slots", B_FLAT_SHARDED, lambda: s4.insert_packed(bigs), None),
        ("sharded_include_packed_4_slots", B_FLAT_SHARDED, lambda: s4.include_packed(bigs), None),
    )))


def warc_keys(lo: int, hi: int):
    """Config 3's keys, as benchmarks/run.py makes them."""
    return (b"warc-record-%014d" % i for i in range(lo, hi))


def phase_checksum_kernel_vs_plain() -> tuple[dict, dict]:
    """The checksum pair (payload bytes and CRC32C) against its plain
    version on the same words on the card, tolerance 0, at config 3's
    m=2^34 and config 1's m=10,000,000, both payload formats; both against
    the host CRC32C over the host's Redis bitmap on a 64 MiB slice; times
    at 2 GiB."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    runs, worst = {}, 0
    for name, m in (("config3", 1 << LOG2M_STREAM), ("config1", M_FLAT_MOD)):
        words = torch.randint(-(1 << 31), 1 << 31, (-(-m // 32),), dtype=torch.int32, device="cuda",
                              generator=gen)
        nbytes = (m + 7) // 8
        for rev in (True, False):
            kp, kc = checksum.payload_crc32c(words, nbytes, rev)
            pp, pc = checksum.payload_crc32c_plain(words, nbytes, rev)
            err = max(max_abs_err(kp, pp), abs(kc - pc))
            runs[f"{name}_{'redis_bitmap' if rev else 'le_words'}"] = {
                "m": m, "nbytes": nbytes, "crc": kc, "plain_crc": pc, "max_abs_err": err}
            worst = max(worst, err)
            del kp, pp
        if name == "config3":
            big = words
        else:
            del words
    torch.cuda.empty_cache()
    # both against the host path on a 64 MiB slice
    sl = big[:CRC_SLICE_WORDS]
    host_words = sl.cpu().numpy().view(np.uint32)
    host_bitmap = words_to_redis_bitmap(host_words, 32 * CRC_SLICE_WORDS)
    host_crc = crc32c(host_bitmap)
    kp, kc = checksum.payload_crc32c(sl, 4 * CRC_SLICE_WORDS, True)
    pp, pc = checksum.payload_crc32c_plain(sl, 4 * CRC_SLICE_WORDS, True)
    slice_ok = kc == pc == host_crc and kp.cpu().numpy().tobytes() == host_bitmap == \
        pp.cpu().numpy().tobytes()
    check(slice_ok, "checksum kernel and plain version equal the host CRC32C on 64 MiB")
    check(worst == 0, f"checksum kernel equals its plain version (max_abs_err {worst})")
    del kp, pp
    # times at config 3's 2 GiB
    nbytes = (1 << LOG2M_STREAM) // 8
    ms = cuda_ms(lambda i: checksum.launch_payload_crc32c(big, nbytes, True), n=20)
    by_kernel = kernel_ms(lambda i: checksum.launch_payload_crc32c(big, nbytes, True), n=10)
    t1 = time.perf_counter()
    checksum.payload_crc32c_plain(big, nbytes, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    data = host_bitmap[:NUMPY_CRC_BYTES]
    t1 = time.perf_counter()
    crc32c(data)
    numpy_s = time.perf_counter() - t1
    words_bytes = 4 * big.numel()
    bound_ms, bound_by = bound(words_bytes + nbytes, big.numel() * OPS_CRC_WORD)
    del big, sl
    torch.cuda.empty_cache()
    times = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None, "share_of_bound": bound_ms / ms, "kernels_ms": by_kernel,
             "bytes": words_bytes + nbytes, "gb_per_s": (words_bytes + nbytes) / ms / 1e6,
             "numpy_crc32c_s_8MiB": numpy_s,
             "numpy_crc32c_s_scaled_to_2GiB": numpy_s * nbytes / NUMPY_CRC_BYTES}
    emit("checksum_kernel_vs_plain", runs=runs, max_abs_err=worst, tolerance=0,
         host_slice={"bytes": 4 * CRC_SLICE_WORDS, "crc": host_crc, "equal": slice_ok},
         seconds=time.perf_counter() - t0, **times)
    return {"payload_crc32c": worst}, times


def top_device_ops(log_dir: Path, n: int = 8) -> list:
    """The trace's device kernels and copies by total time (ms), from the
    Chrome trace ``tracing.trace`` writes."""
    files = sorted(log_dir.glob("*.pt.trace.json"))
    check(bool(files), f"a trace in {log_dir}")
    events = json.loads(files[-1].read_text())["traceEvents"]
    total: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            name = e["name"].split("(")[0].removeprefix("void ")
            total[name] = total.get(name, 0.0) + e["dur"] / 1e3
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


class TimedSink(checkpoint.FileSink):
    """The FileSink config 3 writes to, timing each ``put`` (write, fsync,
    rename), and reading each landed checkpoint's ``last_duration_seconds``
    off ``checkpointer`` (set before its count moves) at the next put."""

    def __init__(self, directory: str):
        super().__init__(directory)
        self.put_s: list = []
        self.durations: list = []
        self.checkpointer = None

    def landed(self) -> None:
        cp = self.checkpointer
        if cp is not None and cp.checkpoints_written > len(self.durations):
            self.durations.append(cp.last_checkpoint_duration_s)

    def put(self, key_name, seq, blob):
        self.landed()
        t0 = time.perf_counter()
        super().put(key_name, seq, blob)
        self.put_s.append(time.perf_counter() - t0)


def timed_stream(f, lo: int, hi: int, **kw) -> tuple[StreamInserter, dict]:
    """A ``StreamInserter`` run over warc keys [lo, hi) inside a request
    context: host seconds, keys a second and the phase spans."""
    ins = StreamInserter(f, batch_size=B_STREAM, **kw)
    t0 = time.perf_counter()
    with obs.request("stream") as ctx:
        stats = ins.run(warc_keys(lo, hi))
    total = time.perf_counter() - t0
    check(stats["inserted"] == hi - lo and stats["stream_offset"] == hi, "stream counts")
    spans = {f"{k}_s": v for k, v in ctx.phases.items()}
    rest = total - sum(ctx.phases.values())
    return ins, {"keys": hi - lo, "seconds": total, "stream_keys_per_sec": (hi - lo) / total,
                 **spans, "other_s (key source, loop, checkpoint triggers)": rest}


def phase_stream_config3() -> dict:
    """BASELINE config 3 through the port's entry points on one card: a
    flat BloomFilter at m=2^34 fed by a StreamInserter with a FileSink
    checkpoint every n/10 keys, then the checks; a prefetch run first, the
    same stream with no sink before and after (the stall), and a short
    trace window."""
    t0 = time.perf_counter()
    cfg = FilterConfig(m=1 << LOG2M_STREAM, k=K_STREAM, key_len=KEY_LEN_STREAM, key_name="stream-bench")
    payload = (cfg.m + 7) // 8
    if STREAM_DIR.exists():
        shutil.rmtree(STREAM_DIR)
    STREAM_DIR.mkdir()
    need = (checkpoint.DEFAULT_RETAIN + 1) * (payload + (1 << 20))
    free = shutil.disk_usage(STREAM_DIR).free
    check(free >= need, f"{STREAM_DIR} has {free} bytes free, config 3's checkpoints need {need} "
                        f"({checkpoint.DEFAULT_RETAIN} + 1 blobs of {payload} bytes)")
    out = {"config": {"m": cfg.m, "k": cfg.k, "key_len": cfg.key_len, "batch": B_STREAM,
                      "checkpoint_every": max(N_STREAM // 10, 1 << 16), "sink": "FileSink"},
           "n": N_STREAM, "disk_free_bytes": free, "disk_needed_bytes": need,
           "reduced": {"stream_keys": [N_STREAM_PUBLISHED, N_STREAM],
                       "why": "the run's time limit: the host makes and packs ~0.4 us a key; "
                              "m, k, key width and batch as published"}}
    # prefetch first (it also warms the process up): the page-locked ring
    # and the copy stream, against prefetch=0
    p0, p4 = BloomFilter(cfg), BloomFilter(cfg)
    _, out["prefetch_0"] = timed_stream(p0, 0, N_STREAM_PREFETCH)
    _, out[f"prefetch_{STREAM_PREFETCH}"] = timed_stream(p4, 0, N_STREAM_PREFETCH,
                                                         prefetch=STREAM_PREFETCH)
    check(max_abs_err(p0.words, p4.words) == 0, "prefetch=4 leaves the words of prefetch=0")
    del p0
    torch.cuda.empty_cache()
    # the same stream with no sink, before and after the checkpointed one:
    # the insert loop's own time
    g = BloomFilter(cfg)
    _, out["no_sink_before"] = timed_stream(g, 0, N_STREAM)
    # config 3: a checkpoint every n/10 keys, each trigger's outcome and
    # each landed checkpoint's duration recorded
    f = BloomFilter(cfg)
    sink = TimedSink(str(STREAM_DIR))
    sweep.reset_launch_counts()
    checksum.reset_launch_counts()
    ins = StreamInserter(f, batch_size=B_STREAM, sink=sink,
                         checkpoint_every=max(N_STREAM // 10, 1 << 16))
    cp = sink.checkpointer = ins.checkpointer
    fired, refused = [], []
    trigger = cp.trigger

    def counted_trigger():
        t = time.perf_counter()
        ok = trigger()
        (fired if ok else refused).append(time.perf_counter() - t)
        return ok

    cp.trigger = counted_trigger
    t1 = time.perf_counter()
    with obs.request("stream") as ctx:
        stats = ins.run(warc_keys(0, N_STREAM))
    run_s = time.perf_counter() - t1
    ok = ins.close(final_checkpoint=True)
    close_s = time.perf_counter() - t1 - run_s
    sink.landed()  # the final one, landed in close()
    launches = {**sweep.launch_counts(), **checksum.launch_counts()}
    check(ok and cp.last_error is None, f"close() durable, last_error {cp.last_error!r}")
    check(stats["inserted"] == N_STREAM == f.n_inserted, "config 3 stream counts")
    check(launches["flat_insert"] == N_STREAM // B_STREAM, "one flat insert a batch")
    check(launches["payload_crc32c"] == len(fired) == cp.checkpoints_written,
          "one checksum pair a landed checkpoint")
    spans = {f"{k}_s": v for k, v in ctx.phases.items()}
    out["with_sink"] = {
        "keys": N_STREAM, "seconds": run_s, "stream_keys_per_sec": N_STREAM / run_s,
        **spans, "other_s (key source, loop, checkpoint triggers)": run_s - sum(ctx.phases.values()),
        "close_s": close_s, "checkpoints_written": cp.checkpoints_written,
        "triggers_fired": len(fired),
        # a trigger refused while a write is in flight is retried at every
        # later batch: attempts, and the n/10 intervals that got no
        # checkpoint of their own (the final one, from close(), aside)
        "trigger_attempts_refused_while_busy": len(refused),
        "intervals_deferred": N_STREAM // max(N_STREAM // 10, 1 << 16) - (len(fired) - 1),
        "trigger_s": fired, "last_duration_seconds": sink.durations, "sink_put_s": sink.put_s,
        "obs_stats": cp.obs_stats(), "launches": launches}
    g.clear()
    _, out["no_sink_after"] = timed_stream(g, 0, N_STREAM)
    base_s = (out["no_sink_before"]["seconds"] + out["no_sink_after"]["seconds"]) / 2
    out["stall"] = run_s / base_s - 1.0
    out["stall_target (benchmarks/streaming.py, not a gate)"] = 0.05
    # the checks: restore on the card, resume offset, sampled keys, FPR
    t1 = time.perf_counter()
    r = checkpoint.restore(cfg, checkpoint.FileSink(str(STREAM_DIR)))
    restore_s = time.perf_counter() - t1
    err = max_abs_err(r.words, f.words)
    check(r.words.is_cuda, "config 3 restored on the card")
    check(err == 0, f"restored words equal the live filter's (max_abs_err {err})")
    check(resume_offset(r) == N_STREAM, f"resume_offset {resume_offset(r)} == {N_STREAM}")
    check(max_abs_err(g.words, f.words) == 0, "the stream with and without a sink: equal words")
    del r, g
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 3)
    sample = rng.choice(N_STREAM, N_STREAM_PROBE, replace=False)
    held = f.include_batch([b"warc-record-%014d" % int(i) for i in sample])
    check(bool(held.all()), f"every sampled stream key present ({int(held.sum())} of {held.size})")
    probe = rng.integers(0, 256, (N_STREAM_PROBE, KEY_LEN_STREAM), dtype=np.uint8)
    hits = int(f.include_packed(probe).sum())
    expect = N_STREAM_PROBE * theoretical_fpr(cfg.m, cfg.k, f.n_inserted)
    tol = max(6.0 * math.sqrt(max(expect, 1.0)), 0.35 * expect, 8.0)
    check(abs(hits - expect) <= tol, f"config 3 FPR {hits} hits vs model {expect:.3g} ± {tol:.1f}")
    out["checks"] = {"close_ok": ok, "last_error": None, "restore_s": restore_s,
                     "restore_max_abs_err": err, "resume_offset": N_STREAM,
                     "sampled_keys": N_STREAM_PROBE, "sampled_held": int(held.sum()),
                     "fpr_probes": N_STREAM_PROBE, "fpr_hits": hits, "fpr_model_hits": expect,
                     "fpr_tolerance": tol}
    # framing a 2 GiB payload: the one copy out of the host buffer
    host = np.empty(payload, dtype=np.uint8)
    t1 = time.perf_counter()
    blob = checkpoint._frame({"seq": 0}, host, 0)
    out["frame_2GiB_s"] = time.perf_counter() - t1
    del blob, host
    for fn in STREAM_DIR.glob("*.ckpt"):
        fn.unlink()
    # a short trace window: a few stream batches and one checkpoint
    trace_dir = OUT_DIR / "stream_trace"
    if trace_dir.exists():
        shutil.rmtree(trace_dir)
    tcp = checkpoint.AsyncCheckpointer(p4, checkpoint.FileSink(str(STREAM_DIR)))
    with tracing.trace(str(trace_dir)):
        with tracing.annotate("stream_batches", batch=B_STREAM):
            StreamInserter(p4, batch_size=B_STREAM).run(
                warc_keys(N_STREAM_PREFETCH, N_STREAM_PREFETCH + TRACE_BATCHES * B_STREAM))
        with tracing.annotate("checkpoint_trigger"):
            check(tcp.trigger(), "trace window trigger")
    check(tcp.flush(timeout=300) and tcp.last_error is None, "trace window checkpoint landed")
    tcp.close(final_checkpoint=False)
    out["trace_top_device_ms"] = top_device_ops(trace_dir)
    shutil.rmtree(trace_dir)
    del p4, f
    torch.cuda.empty_cache()
    shutil.rmtree(STREAM_DIR)
    emit("stream_config3", seconds=time.perf_counter() - t0, **out)
    return out


# -- the scalable filter and the sketch kinds --------------------------------------


def nonzero_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random 16-byte keys whose last byte is not zero (so that
    :func:`bytes_keys` keeps all 16 bytes)."""
    r = rows(rng, n)
    r[:, -1] |= 1
    return r


def bytes_keys(r: np.ndarray) -> list:
    """Each row of a ``uint8[n, W]`` array as a ``bytes`` key, the way a
    user passes keys (numpy's fixed-width bytes drop trailing zero bytes,
    which rows of :func:`nonzero_rows` and :func:`id_rows` do not have)."""
    return np.ascontiguousarray(r).view(f"S{r.shape[1]}").ravel().tolist()


def id_rows(ids: np.ndarray) -> np.ndarray:
    """The 16-byte key of each id: its 8 little-endian bytes, then
    ``b"cms-key!"``."""
    out = np.empty((ids.shape[0], KEY_LEN), dtype=np.uint8)
    out[:, :8] = ids.astype("<u8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = np.frombuffer(b"cms-key!", dtype=np.uint8)
    return out


def zipf_ids(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` draws of a Zipf(CMS_ZIPF) stream over CMS_DISTINCT ids (ranks
    past CMS_DISTINCT are drawn again), int64 in [0, CMS_DISTINCT)."""
    out = []
    while sum(x.size for x in out) < n:
        z = rng.zipf(CMS_ZIPF, n)
        out.append(z[z <= CMS_DISTINCT] - 1)
    return np.concatenate(out)[:n].astype(np.int64)


def fpr_bound_check(hits: int, probes: int, bound: float) -> dict:
    """Absent keys' hits against a design FPR bound, with the acceptance
    of tests/test_fpr_model.py above it: 6 sigma, 35 %, floor 8."""
    expect = probes * bound
    tol = max(6.0 * math.sqrt(max(expect, 1.0)), 0.35 * expect, 8.0)
    check(hits <= expect + tol, f"FPR {hits} hits over the bound's {expect:.1f} + {tol:.1f}")
    return {"probes": probes, "hits": hits, "fpr": hits / probes, "bound": bound,
            "bound_hits": expect, "tolerance": tol}


def scalable_run(cfg: FilterConfig, capacity: int, n: int, rng) -> tuple:
    """A ScalableBloomFilter on the card (no device given) fed ``n`` keys
    through ``insert_batch`` in calls of B_SCALABLE ``bytes`` keys, the
    first half a call, so that every growth boundary falls inside a call;
    then its held keys (a 32nd of them, at most N_SCALABLE_PROBE) and as
    many absent keys through ``include_batch``. Returns the filter and
    its record."""
    f = ScalableBloomFilter(capacity, SCALABLE_ERROR, config=cfg, growth=SCALABLE_GROWTH)
    check(f.layers[0].words.is_cuda, "the scalable filter's default device is the card")
    starts = [0, *range(B_SCALABLE // 2, n, B_SCALABLE)]
    held, straddled, host_s = [], 0, 0.0
    t0 = time.perf_counter()
    for lo, hi in zip(starts, [*starts[1:], n]):
        t = time.perf_counter()
        r = nonzero_rows(rng, hi - lo)
        keys = bytes_keys(r)
        host_s += time.perf_counter() - t
        before = f.snapshot_meta()["layer_counts"]
        f.insert_batch(keys)
        after = f.snapshot_meta()["layer_counts"]
        straddled += len(after) > len(before) and after[len(before) - 1] > before[-1]
        held.append(r[::32])
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    held = np.concatenate(held)[:N_SCALABLE_PROBE]
    t = time.perf_counter()
    got = f.include_batch(bytes_keys(held))
    held_s = time.perf_counter() - t
    check(bool(got.all()), f"no false negatives ({int(got.sum())} of {got.size} held keys)")
    absent = f.include_batch(bytes_keys(nonzero_rows(rng, held.shape[0])))
    meta = f.snapshot_meta()
    rec = {"base": {"block_bits": cfg.block_bits, "block_hash": cfg.block_hash,
                    "key_len": cfg.key_len},
           "capacity": capacity, "error_rate": SCALABLE_ERROR, "growth": SCALABLE_GROWTH,
           "tightening": f.tightening, "keys": n, "calls": len(starts),
           "calls_straddling_a_growth_boundary": int(straddled),
           "layers": [{"m": c["m"], "k": c["k"], "keys": k}
                      for c, k in zip(meta["layer_configs"], meta["layer_counts"])],
           "state_bytes": sum(c["m"] for c in meta["layer_configs"]) // 8,
           "insert_s": insert_s, "host_key_making_s": host_s,
           "keys_per_s": n / insert_s, "held_probes": int(got.size), "held_query_s": held_s,
           "fpr": fpr_bound_check(int(absent.sum()), int(absent.size), f.compound_fpr_bound()),
           "stats": f.stats()}
    return f, rec


def phase_scalable_path(rng) -> None:
    """BF.RESERVE key 0.01 4194304 EXPANSION 2 on blocked layers (the main
    path's layout): 2^25 keys push four layers (m = 2^26 .. 2^29, 120 MiB);
    then an async checkpoint of the stack to a FileSink, restored on the
    card with every layer's words equal; and a flat-layer stack at a cut
    size. The launch counts are read after each stack's run."""
    t0 = time.perf_counter()
    sweep.reset_launch_counts()
    checksum.reset_launch_counts()
    cfg = FilterConfig(m=BLOCK_BITS, k=1, key_len=KEY_LEN, block_bits=BLOCK_BITS,
                       block_hash="chunk", key_name="scalable")
    f, blocked_rec = scalable_run(cfg, SCALABLE_CAPACITY, N_SCALABLE, rng)
    check(f.n_layers == 4, f"2^25 keys push 4 layers ({f.n_layers})")
    check(blocked_rec["calls_straddling_a_growth_boundary"] >= 3, "calls straddle the boundaries")
    if STREAM_DIR.exists():
        shutil.rmtree(STREAM_DIR)
    STREAM_DIR.mkdir()
    sink = checkpoint.FileSink(str(STREAM_DIR))
    cp = checkpoint.AsyncCheckpointer(f, sink)
    t = time.perf_counter()
    check(cp.trigger(), "scalable checkpoint triggered")
    check(cp.flush(timeout=300) and cp.last_error is None, f"checkpoint landed ({cp.last_error!r})")
    cp.close(final_checkpoint=False)
    ckpt_s = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = {**sweep.launch_counts(), **checksum.launch_counts()}
    t = time.perf_counter()
    r = checkpoint.restore(cfg, sink, expect_scalable=True,
                           scalable_expect={"capacity": SCALABLE_CAPACITY,
                                            "error_rate": SCALABLE_ERROR,
                                            "growth": SCALABLE_GROWTH})
    restore_s = time.perf_counter() - t
    errs = [max_abs_err(a.words, b.words) for a, b in zip(r.layers, f.layers, strict=True)]
    check(r.layers[0].words.is_cuda, "the stack restored on the card")
    check(max(errs) == 0, f"the restored stack's words equal the live one's ({errs})")
    shutil.rmtree(STREAM_DIR)
    for name in ("blocked_insert", "blocked_query", "payload_crc32c"):
        check(launches[name] > 0, f"{name} launched on the scalable path")
    blocked_rec.update(checkpoint_s=ckpt_s, restore_s=restore_s, restore_max_abs_err=max(errs),
                       checkpoint_bytes=4 * sum(a.words.numel() for a in f.layers),
                       launches=launches)
    del f, r
    torch.cuda.empty_cache()
    # flat layers, cut to a capacity of 2^20 (3 layers, 2^22 keys)
    sweep.reset_launch_counts()
    flat_cfg = FilterConfig(m=64, k=1, key_len=KEY_LEN, key_name="scalable-flat")
    g, flat_rec = scalable_run(flat_cfg, SCALABLE_FLAT_CAPACITY, N_SCALABLE_FLAT, rng)
    torch.cuda.synchronize()
    flat_rec["launches"] = sweep.launch_counts()
    check(g.n_layers == 3, f"2^22 keys push 3 flat layers ({g.n_layers})")
    for name in ("flat_insert", "flat_query"):
        check(flat_rec["launches"][name] > 0, f"{name} launched on the flat stack")
    del g
    torch.cuda.empty_cache()
    emit("scalable_path", blocked=blocked_rec, flat=flat_rec,
         reduced={"flat_stack": "capacity 2^20, 2^22 keys: it covers the flat kernels under "
                                "the scalable filter; the blocked stack runs at full size"},
         seconds=time.perf_counter() - t0)


def phase_sketch_path(rng) -> tuple:
    """The sketch kinds through their entry points on the card:
    CF.RESERVE for ~16 M items (m = 2^24 slots) filled to 0.90 load in
    batches of 2^16, then pushed 2^20 keys further (FULL keys and kicks),
    queried and deleted from; CMS.INITBYPROB key 0.000001 0.001 fed a
    Zipf(1.1) stream of 2^24 unit increments and weighted increments, every
    id's estimate held to its exact count; TOPK.RESERVE key 100 on the same
    grid. Launch counts are read after the three."""
    t0 = time.perf_counter()
    sweep.reset_launch_counts()
    kicks0 = obs_counters.get("cuckoo_kicks_total")
    cfg = FilterConfig(m=1 << LOG2M_CUCKOO, k=2, kind="cuckoo", key_len=KEY_LEN, key_name="cf")
    cf = CuckooFilter(cfg)
    check(cf.words.is_cuda, "the cuckoo filter's default device is the card")
    target = math.ceil(CUCKOO_FILL * cfg.m)
    sample, stored, fill_full, fill_batches = [], 0, 0, 0
    t = time.perf_counter()
    while stored < target:
        r = nonzero_rows(rng, B_CUCKOO)
        cf.insert_packed(r)
        flags = cf.take_insert_flags()
        stored += int(flags.sum())
        fill_full += int((~flags).sum())
        fill_batches += 1
        sample.append(r[flags][::8])
    fill_s = time.perf_counter() - t
    fill_kicks = obs_counters.get("cuckoo_kicks_total") - kicks0
    load = cf.fill_ratio()
    check(load >= CUCKOO_FILL, f"the fill reached {load:.4f}")
    over_full = 0
    t = time.perf_counter()
    for _ in range(N_CUCKOO_OVERFILL // B_CUCKOO):
        r = rows(rng, B_CUCKOO)
        cf.insert_packed(r)
        flags = cf.take_insert_flags()
        stored += int(flags.sum())
        over_full += int((~flags).sum())
    over_s = time.perf_counter() - t
    over_kicks = obs_counters.get("cuckoo_kicks_total") - kicks0 - fill_kicks
    check(over_full > 0 and over_kicks > 0, f"the overfill rejects ({over_full}) and kicks")
    occupied = cf.stats()["occupied_slots"]
    check(occupied == stored, f"honest FULL: {stored} keys accepted, {occupied} slots occupied")
    held = np.concatenate(sample)[:N_CUCKOO_PROBE]
    check(bool(cf.include_packed(held).all()), "no false negatives on held keys")
    absent = int(cf.include_packed(rows(rng, N_CUCKOO_PROBE)).sum())
    t = time.perf_counter()
    deleted = cf.delete_batch(bytes_keys(held[:N_CUCKOO_DELETE]))
    delete_s = time.perf_counter() - t
    check(bool(deleted.all()), f"every held key deleted ({int(deleted.sum())})")
    check(cf.stats()["occupied_slots"] == stored - N_CUCKOO_DELETE, "a delete frees one slot")
    cuckoo = {"m": cfg.m, "bytes": 4 * cfg.m, "batch": B_CUCKOO, "max_kicks": ops_cuckoo.MAX_KICKS,
              "fill": {"batches": fill_batches, "keys": fill_batches * B_CUCKOO, "seconds": fill_s,
                       "keys_per_s": fill_batches * B_CUCKOO / fill_s, "load": load,
                       "full": fill_full, "kicks": fill_kicks},
              "overfill": {"keys": N_CUCKOO_OVERFILL, "seconds": over_s,
                           "keys_per_s": N_CUCKOO_OVERFILL / over_s, "full": over_full,
                           "kicks": over_kicks, "load": cf.fill_ratio()},
              "held_probes": int(held.shape[0]), "absent_probes": N_CUCKOO_PROBE,
              "fpr": absent / N_CUCKOO_PROBE, "deleted": int(deleted.sum()), "delete_s": delete_s}
    # count-min: the Zipf stream, then weighted increments, then every id
    ccfg = FilterConfig(m=CMS_WIDTH, k=CMS_DEPTH, kind="cms", key_len=KEY_LEN, key_name="cms")
    cms = CountMinSketch(ccfg)
    ids = zipf_ids(rng, N_CMS)
    call_s = []
    t = time.perf_counter()
    for lo in range(0, N_CMS, B_CMS):
        c0 = time.perf_counter()
        cms.insert_packed(id_rows(ids[lo : lo + B_CMS]))
        call_s.append(time.perf_counter() - c0)
    torch.cuda.synchronize()
    cms_s = time.perf_counter() - t
    exact = np.bincount(ids, minlength=CMS_DISTINCT).astype(np.int64)
    wid = rng.integers(0, CMS_DISTINCT, N_CMS_WEIGHTED)
    w = rng.integers(1, CMS_MAX_WEIGHT, N_CMS_WEIGHTED)
    after = cms.increment_batch(bytes_keys(id_rows(wid)), w.tolist())
    np.add.at(exact, wid, w)
    check(bool((after >= exact[wid]).all()), "increment_batch's estimates >= the exact counts")
    total = N_CMS + int(w.sum())
    eps_n = math.e / CMS_WIDTH * total
    below = above = above_seen = seen = 0
    t = time.perf_counter()
    for lo in range(0, CMS_DISTINCT, B_CMS):
        est = cms.estimate_batch(bytes_keys(id_rows(np.arange(lo, lo + B_CMS)))).astype(np.int64)
        ex = exact[lo : lo + B_CMS]
        below += int((est < ex).sum())
        over = est - ex > eps_n
        above += int(over.sum())
        above_seen += int((over & (ex > 0)).sum())
        seen += int((ex > 0).sum())
    est_s = time.perf_counter() - t
    check(below == 0, f"no estimate below its exact count ({below})")
    cms_rec = {"width": CMS_WIDTH, "depth": CMS_DEPTH, "bytes": 4 * CMS_WIDTH * CMS_DEPTH,
               "zipf": CMS_ZIPF, "distinct_ids": CMS_DISTINCT, "unit_increments": N_CMS,
               "batch": B_CMS, "update_s": cms_s, "update_call_s": call_s,
               "weighted_keys": N_CMS_WEIGHTED,
               "weighted_total": int(w.sum()), "increments_total": total,
               "ids_seen": seen, "estimates": CMS_DISTINCT, "estimate_s": est_s,
               "below_exact": below, "e_over_width_times_n": eps_n,
               "share_above_e_over_width_n": above / CMS_DISTINCT,
               "share_above_e_over_width_n_of_seen": above_seen / max(seen, 1),
               "fill_ratio": cms.fill_ratio()}
    # top-k on the same grid: the stream's first batches
    tk = TopKSketch(FilterConfig(m=CMS_WIDTH, k=CMS_DEPTH, kind="topk", topk=TOPK,
                                 key_len=KEY_LEN, key_name="topk"))
    stream = ids[: N_TOPK_BATCHES * B_TOPK]
    t = time.perf_counter()
    for lo in range(0, stream.size, B_TOPK):
        tk.insert_packed(id_rows(stream[lo : lo + B_TOPK]))
    topk_s = time.perf_counter() - t
    counts = np.bincount(stream)
    heaviest = int(counts.argmax())
    top = tk.topk_list()
    check(top[0][0] == id_rows(np.array([heaviest]))[0].tobytes(),
          f"the heaviest key (id {heaviest}, {int(counts[heaviest])}) leads topk_list")
    topk_rec = {"topk": TOPK, "batches": N_TOPK_BATCHES, "batch": B_TOPK, "seconds": topk_s,
                "heaviest_id": heaviest, "heaviest_count": int(counts[heaviest]),
                "leader_estimate": top[0][1], "listed": len(top)}
    torch.cuda.synchronize()
    launches = sweep.launch_counts()
    for name in SKETCH_KERNELS:  # (`--ab` runs this in trees that predate a kernel)
        check(launches.get(name, 0) > 0 or name not in launches,
              f"{name} launched on the sketch path")
    for name, other in COUNTED_WITH.items():
        check(launches[name] > launches.get(other, 0),
              f"the thread-a-key {name} launched on the sketch path")
    del tk
    torch.cuda.empty_cache()
    emit("sketch_path", cuckoo=cuckoo, cms=cms_rec, topk=topk_rec, launches=launches,
         seconds=time.perf_counter() - t0)
    return launches, cf, cms, held, ids


def key_batch(r: np.ndarray, pad: int = 0, dup: int = 0):
    """Keys and lengths of rows ``r`` (16 bytes each) on the card: ``dup``
    copies of row 0 at the end, then ``pad`` padding rows."""
    r = r.copy()
    if dup:
        r[-dup:] = r[0]
    keys = np.concatenate([r, np.zeros((pad, r.shape[1]), np.uint8)])
    lens = np.concatenate([np.full(r.shape[0], r.shape[1], np.int32), np.full(pad, -1, np.int32)])
    return torch.from_numpy(keys).to("cuda"), torch.from_numpy(lens).to("cuda")


def i32(t: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor's bits on the host, as int32."""
    return t.view(torch.int32).cpu()


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of a uint32 tensor on the host (a copy even of a CPU one)."""
    return t.view(torch.int32).to("cpu", copy=True).view(torch.uint32)


def rounds_vs_model(pre, keys, lens, cfg, insert: bool, got, window: int = 0) -> dict:
    """The round walk's (rounds, keys re-walked) on a copy ``pre`` of a
    state as it was before the insert or delete of ``keys``, against the
    plain model's (``ops_cuckoo.cuckoo_walk_rounds``) at the same window on
    a host copy; and the worst difference of that launch's and the model's
    state, flags and kicks from ``got`` (the plain walk's state, flags and,
    for an insert, kicks)."""
    W = window or sweep.cuckoo_window()
    host = host_copy(pre)
    fp, i1 = ops_cuckoo.derive(keys.cpu(), lens.cpu(), n_buckets=cfg.m // ops_cuckoo.BUCKET_SIZE,
                               seed=cfg.seed)
    t = time.perf_counter()
    mflags, _, rounds, rewalked = ops_cuckoo.cuckoo_walk_rounds(host, fp, i1, lens.cpu() >= 0,
                                                                window=W, insert=insert)
    model_s = time.perf_counter() - t
    flags, kicks, stats = sweep._cuckoo_walk_on("rounds", insert, pre, keys, lens, cfg, window)
    kernel = stats.cpu().tolist()
    err = max(max_abs_err(i32(pre), i32(got[0])), max_abs_err(flags.cpu(), got[1].cpu()),
              max_abs_err(i32(host), i32(got[0])), max_abs_err(mflags, got[1].cpu()),
              0 if kicks is None else max_abs_err(kicks.cpu(), got[2].cpu()))
    check(kernel == [rounds, rewalked],
          f"the round walk's (rounds, re-walked) {kernel} equal the model's {[rounds, rewalked]}")
    return {"window": W, "rounds": kernel[0], "rewalked": kernel[1], "model": [rounds, rewalked],
            "keys": int(keys.shape[0]), "keys_per_round": keys.shape[0] / kernel[0],
            "max_abs_err": err, "model_s": model_s}


def cuckoo_vs_plain(state, cfg, batches, deletes) -> dict:
    """Each batch inserted (then queried) through the cuckoo kernels on
    ``state`` and through the plain versions on a CPU copy, then the
    deletes: the worst difference of slots and flags, FULL keys, kicks;
    and each launch's (rounds, re-walked) against the plain model's."""
    host = host_copy(state)
    err = {"cuckoo_insert": 0, "cuckoo_query": 0, "cuckoo_delete": 0}
    full = kicks = 0
    rounds = []
    for keys, lens in batches:
        pre = clone_u32(state)
        ok, k = sweep.cuckoo_insert(state, keys, lens, cfg)
        pok, pk = sweep.cuckoo_insert(host, keys.cpu(), lens.cpu(), cfg)
        err["cuckoo_insert"] = max(err["cuckoo_insert"], max_abs_err(i32(state), i32(host)),
                                   max_abs_err(ok.cpu(), pok), max_abs_err(k.cpu(), pk))
        rounds.append({"insert": True, **rounds_vs_model(pre, keys, lens, cfg, True, (host, pok, pk))})
        err["cuckoo_insert"] = max(err["cuckoo_insert"], rounds[-1]["max_abs_err"])
        full += int(((lens.cpu() >= 0) & ~pok).sum())
        kicks += int(pk.sum())
        q = sweep.cuckoo_query(state, keys, lens, cfg)
        err["cuckoo_query"] = max(err["cuckoo_query"],
                                  max_abs_err(q.cpu(), sweep.cuckoo_query(host, keys.cpu(), lens.cpu(), cfg)))
    for keys, lens in deletes:
        pre = clone_u32(state)
        d = sweep.cuckoo_delete(state, keys, lens, cfg)
        pd = sweep.cuckoo_delete(host, keys.cpu(), lens.cpu(), cfg)
        err["cuckoo_delete"] = max(err["cuckoo_delete"], max_abs_err(d.cpu(), pd),
                                   max_abs_err(i32(state), i32(host)))
        rounds.append({"insert": False, **rounds_vs_model(pre, keys, lens, cfg, False, (host, pd))})
        err["cuckoo_delete"] = max(err["cuckoo_delete"], rounds[-1]["max_abs_err"])
    return {"max_abs_err": err, "full": full, "kicks": kicks, "rounds": rounds}


def cms_vs_plain(cms, rng) -> dict:
    """A weighted update (weights near 2^32 that wrap) then a unit one of a
    Zipf batch of the path's size with a crowd and padding, through each
    update kernel on a copy of the sketch path's grid, and the estimate
    through each of its kernels, against the plain versions on a host copy:
    the worst difference of
    each. The partitioned kernel's entries a tile, read from its scratch
    after each launch, are held against the plain partition
    (``ops_cms.cms_tile_counts_plain``) and count in its difference."""
    host = host_copy(cms.words)
    keys, lens = key_batch(id_rows(zipf_ids(rng, B_CMS - 256)), pad=256, dup=1 << 12)
    incs = rng.integers(0, 1 << 32, keys.shape[0], dtype=np.uint64).astype(np.uint32)
    incs[: 1 << 10] = M32 - rng.integers(0, 4, 1 << 10).astype(np.uint32)
    incs = torch.from_numpy(incs.view(np.int32))  # moved as int32, viewed as uint32
    d_incs = incs.to(cms.words.device).view(torch.uint32)
    sweep.cms_update(host, keys.cpu(), lens.cpu(), cms.config, incs.view(torch.uint32))
    sweep.cms_update(host, keys.cpu(), lens.cpu(), cms.config)
    c, B = cms.config, keys.shape[0]
    want = ops_cms.cms_tile_counts_plain(
        ops_cms.cms_positions(keys, lens, width=c.m, depth=c.k, seed=c.seed), c.m,
        sweep.flat_tile_geometry()[0], lens >= 0)
    cms_err = {}
    for name, tiled in CMS_UPDATES.items():
        grid = clone_u32(cms.words)
        err = 0
        for weights in (d_incs, None):
            scratch = (sweep.cms_tiled_scratch(c, B, grid.device, weighted=weights is not None)
                       if tiled else None)
            sweep._cms_update_on(tiled, grid, keys, lens, c, weights, scratch=scratch)
            if tiled:
                got = sweep.cms_tile_counts(scratch, c, B, weighted=weights is not None)
                err = max(err, max_abs_err(got, want))
        cms_err[name] = max(err, max_abs_err(i32(grid), i32(host)))
    want = i32(sweep.cms_estimate(host, keys.cpu(), lens.cpu(), c))
    for name, kernel in (("cms_estimate", "thread_a_key"), ("cms_estimate_rows", "rows")):
        cms_err[name] = max_abs_err(i32(sweep._cms_estimate_on(kernel, grid, keys, lens, c)), want)
    del grid, host
    torch.cuda.empty_cache()
    return cms_err


def phase_sketch_kernel_vs_plain(rng, cf, cms) -> dict:
    """Each sketch kernel against its plain version on a CPU copy of the
    same state and keys, tolerance 0: the cuckoo pair at 2^16 slots with
    an overfill batch (FULL keys and unwound chains), duplicates and
    padding, and one 2^12-key batch on a copy of the sketch path's filled
    2^24-slot table; the count-min pair at the path's width and batch with
    duplicates and weights near 2^32 (the counters wrap). The cuckoo pair at
    the path's batch of 2^16 on the filled table is held in
    :func:`phase_sketch_times`."""
    t0 = time.perf_counter()
    small = FilterConfig(m=1 << 16, k=2, kind="cuckoo", key_len=KEY_LEN, seed=SEED)
    st = torch.zeros(small.m, dtype=torch.int32, device="cuda").view(torch.uint32)
    first = key_batch(rows(rng, 1 << 15), pad=64, dup=16)
    over = key_batch(rows(rng, 1 << 16), pad=64, dup=16)
    run16 = cuckoo_vs_plain(st, small, [first, over], [first])
    check(run16["full"] > 0 and run16["kicks"] > 0, "the 2^16-slot overfill rejects and kicks")
    big = clone_u32(cf.words)
    batch = key_batch(rows(rng, 1 << 12), pad=64, dup=8)
    run24 = cuckoo_vs_plain(big, cf.config, [batch], [batch])
    del big, st
    cms_err = cms_vs_plain(cms, rng)
    errs = {name: max(run16["max_abs_err"].get(name, 0), run24["max_abs_err"].get(name, 0),
                      cms_err.get(name, 0)) for name in SKETCH_KERNELS}
    check(max(errs.values()) == 0, f"sketch kernels equal their plain versions ({errs})")
    emit("sketch_kernel_vs_plain", max_abs_err=errs, tolerance=0,
         cuckoo_2_16_slots=run16, cuckoo_filled_2_24_slots={**run24, "load": cf.fill_ratio()},
         cms={"width": CMS_WIDTH, "depth": CMS_DEPTH, "keys": B_CMS,
              "weights_near_2_32": 1 << 10, "max_abs_err": cms_err},
         seconds=time.perf_counter() - t0)
    return errs


# The count-min update's kernels as chip_smoke.py holds them: name -> the
# partitioned kernel.
CMS_UPDATES = {"cms_update_tiled": True, "cms_update": False}


# 32-bit integer operations a key of the sketch kernels: the cuckoo hash is
# two murmur3 passes (108) and the fingerprint's mod and add (4); a bucket
# probe is 4 compares (4); the count-min mod walk is a murmur3 and fnv1a
# (118), then each row's step, mod, index and add (8).
OPS_CUCKOO_HASH, OPS_CUCKOO_PROBE = 112, 4
OPS_CMS_HASH, OPS_CMS_ROW = 118, 8


CHASE_STEPS = 1 << 16  # dependent reads a latency chase times
# the cuckoo table's size (above the 50 MB L2), and a buffer the L2 holds
CHASE_TABLE_BYTES, CHASE_L2_BYTES = 64 << 20, 4 << 20


def host_ms(fn) -> tuple[float, object]:
    """Host-clock ms of one call of ``fn`` (a plain version on the CPU),
    and what it returned."""
    t = time.perf_counter()
    got = fn()
    return (time.perf_counter() - t) * 1e3, got


def changed_sectors(pre: torch.Tensor, post: torch.Tensor) -> int:
    """32-byte sectors (8 words) in which two host copies of a state differ."""
    return int((pre.view(torch.int32).reshape(-1, 8) != post.view(torch.int32).reshape(-1, 8))
               .any(1).sum())


def chase_us(nbytes: int, warm: bool) -> dict:
    """µs of one dependent 16-byte row read on one thread, the walk's kick
    step without its compares and stores: a chase of CHASE_STEPS links of a
    random cycle through every row of a buffer of ``nbytes``, timed by a
    CUDA event pair, three times. Before each, the L2 is flushed by a read
    (``warm`` False: the reads go to device memory), or the whole cycle is
    walked once (``warm``: the buffer is in L2). ``us`` is the least."""
    n_rows = nbytes // 16
    order = torch.randperm(n_rows, device="cuda")
    buf = torch.zeros(n_rows * 4, dtype=torch.int32, device="cuda")
    buf[order * 4] = order.roll(-1).to(torch.int32)
    start, end = int(order[0]), int(order[CHASE_STEPS % n_rows])
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(3):
        if warm:
            sweep._cuckoo_chase(buf, start, n_rows)
        else:
            flush.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = sweep._cuckoo_chase(buf, start, CHASE_STEPS)
        b.record()
        torch.cuda.synchronize()
        check(int(got[0]) == end, "the chase followed its links")
        runs.append(a.elapsed_time(b) * 1e3 / CHASE_STEPS)
    del order, buf, flush
    return {"bytes": nbytes, "steps": CHASE_STEPS, "in_l2": warm, "us": min(runs), "runs_us": runs}


WALK_WINDOWS = (128, 256, 512, 1024)  # the round walk's windows timed against each other


def walk_ab(state, keys, lens, cfg, insert: bool, plain) -> tuple[dict, int]:
    """The insert or delete's second launches on ``state`` (restored and
    the L2 flushed before each launch: fresh_ms, 5 launches): the round
    walk, the warp walk and one thread, in turns rounds, warp, thread,
    thread, warp, rounds; then the round walk at each of WALK_WINDOWS, in
    turns up and down, with its (rounds, keys re-walked) against the plain
    model's. Returns the times and the worst difference of any variant's
    state, flags and kicks from ``plain`` (the plain walk's)."""
    runs = {name: [] for name in sweep.CUCKOO_WALKS}
    for name in (*sweep.CUCKOO_WALKS, *reversed(sweep.CUCKOO_WALKS)):
        runs[name].append(fresh_ms(state, lambda i: sweep._cuckoo_walk_on(
            name, insert, state, keys, lens, cfg), n=5, warm=1))
    err = 0
    for name in sweep.CUCKOO_WALKS:
        c = clone_u32(state)
        flags, kicks, _ = sweep._cuckoo_walk_on(name, insert, c, keys, lens, cfg)
        err = max(err, max_abs_err(i32(c), i32(plain[0])), max_abs_err(flags.cpu(), plain[1]),
                  0 if kicks is None else max_abs_err(kicks.cpu(), plain[2]))
        del c
    windows = {w: {"ms": []} for w in WALK_WINDOWS}
    for w in (*WALK_WINDOWS, *reversed(WALK_WINDOWS)):
        windows[w]["ms"].append(fresh_ms(state, lambda i: sweep._cuckoo_walk_on(
            "rounds", insert, state, keys, lens, cfg, w), n=5, warm=1))
    for w in WALK_WINDOWS:
        r = rounds_vs_model(clone_u32(state), keys, lens, cfg, insert, plain, w)
        err = max(err, r.pop("max_abs_err"))
        ms = sum(windows[w]["ms"]) / len(windows[w]["ms"])
        windows[w].update(r, ms_per_round=ms / r["rounds"])
    ab = {**{f"{k}_ms": v for k, v in runs.items()}, "window": sweep.cuckoo_window(),
          "warp_over_rounds": sum(runs["warp"]) / sum(runs["rounds"]),
          "thread_over_rounds": sum(runs["thread"]) / sum(runs["rounds"]),
          "noise": max(abs(a - b) / min(a, b) for a, b in runs.values()),
          "windows": windows}
    return ab, err


def walk_record(ms: float, B: int, ab: dict, lat: dict, dep: int) -> dict:
    """The round walk's rounds and keys a round at the main path's window,
    and the sequential latency floor of the warp walk (``dep`` dependent
    reads at the L2-resident chase's latency, and at the device memory's)
    beside the warp walk's time."""
    main = ab["windows"][ab["window"]]
    warp_ms = sum(ab["warp_ms"]) / len(ab["warp_ms"])
    floor = dep * lat["l2"]["us"] / 1e3
    return {"rounds": main["rounds"], "rewalked": main["rewalked"],
            "keys_per_round": B / main["rounds"], "ms_per_round": ms / main["rounds"],
            "us_per_key": ms * 1e3 / B, "dependent_reads": dep,
            "warp_latency_floor_ms": floor, "warp_latency_floor_by": "latency",
            "warp_share_of_latency_floor": floor / warp_ms,
            "warp_latency_at_device_memory_ms": dep * lat["device_memory"]["us"] / 1e3,
            "walk_ab": ab}


def cuckoo_insert_times(state, keys, lens, cfg, lat: dict) -> dict:
    """The cuckoo insert of one batch on ``state``: the wrapper's ms (the
    round walk), the plain version's ms on a host copy of the same state,
    the three second launches held against it and timed in turns, the byte
    bound (keys, lengths and flags once, each distinct bucket sector the
    plain walk reads, and each sector the batch changes), and beside it the
    warp walk's sequential latency floor (a dependent read a key and a kick
    step, each at the L2-resident chase's latency)."""
    B = keys.shape[0]
    host = host_copy(state)
    p_ms, (pok, pk) = host_ms(lambda: sweep.cuckoo_insert(host, keys.cpu(), lens.cpu(), cfg))
    reads: set = set()
    ops_cuckoo.cuckoo_insert_plain(host_copy(state), keys.cpu(), lens.cpu(), cfg, reads)
    read_sectors = len({b >> 1 for b in reads})  # two 16-byte buckets a sector
    written_sectors = changed_sectors(host_copy(state), host)
    ab, err = walk_ab(state, keys, lens, cfg, True, (host, pok, pk))
    del host
    ms = fresh_ms(state, lambda i: sweep.cuckoo_insert(state, keys, lens, cfg), n=5, warm=1)
    n_kicks, n_full = int(pk.sum()), int((~pok).sum())
    nbytes = B * (KEY_LEN + 4 + 1 + 4) + 32 * (read_sectors + written_sectors)
    b_ms, b_by = bound(nbytes, B * (OPS_CUCKOO_HASH + 2 * OPS_CUCKOO_PROBE) + n_kicks * 12)
    return {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "keys": B, "kicks": n_kicks, "full": n_full, "load": occupied(state) / cfg.m,
            "read_sectors": read_sectors, "written_sectors": written_sectors, "bytes": nbytes,
            "share_of_bound": b_ms / ms, **walk_record(ms, B, ab, lat, B + n_kicks)}


def turns(ops: dict, rounds: int = CMS_TURNS, n: int = 20) -> dict:
    """Each op's mean ms a call over ``n`` calls (:func:`cuda_ms`), the ops
    taken in turns, ``rounds`` times: the median round as ``ms``, and every
    round."""
    runs = {name: [] for name in ops}
    for _ in range(rounds):
        for name, fn in ops.items():
            runs[name].append(cuda_ms(fn, n))
    return {name: {"ms": sorted(r)[len(r) // 2], "rounds": r} for name, r in runs.items()}


def cms_update_vs_plain(grid, keys, lens, c) -> tuple[float, dict]:
    """The plain update's ms on a host copy of ``grid``, and the worst
    difference from it of each update of CMS_UPDATES, one launch on a copy
    of ``grid``."""
    host = host_copy(grid)
    p_ms, _ = host_ms(lambda: sweep.cms_update(host, keys.cpu(), lens.cpu(), c))
    err = {}
    for name, tiled in CMS_UPDATES.items():
        g = clone_u32(grid)
        sweep._cms_update_on(tiled, g, keys, lens, c)
        err[name] = max_abs_err(i32(g), i32(host))
    return p_ms, err


def index_select_amin(grid, flat, c) -> torch.Tensor:
    return grid.view(torch.int32).index_select(0, flat).view(-1, c.k).amin(1)


def cms_flat(keys, lens, c) -> torch.Tensor:
    """The batch's counters as flat indices into the grid (int64, row-major)."""
    return ops_cms.flat_indices(ops_cms.cms_positions(keys, lens, width=c.m, depth=c.k,
                                                      seed=c.seed), c.m).reshape(-1)


def cms_turns(grid, keys, lens, c) -> dict:
    """The count-min update's two kernels and ``index_add_`` on ``keys``, in
    turns on ``grid`` (:func:`turns`); and the distinct 32-byte sectors of
    the batch's counters."""
    flat = cms_flat(keys, lens, c)
    ones = torch.ones(flat.numel(), dtype=torch.int32, device=grid.device)
    g32 = grid.view(torch.int32)
    out = turns({
        "tiled": lambda i: sweep._cms_update_on(True, grid, keys, lens, c),
        "per_key": lambda i: sweep._cms_update_on(False, grid, keys, lens, c),
        "index_add": lambda i: g32.index_add_(0, flat, ones),
    })
    out["sectors"] = int(torch.unique(flat >> 3).numel())
    return out


def cms_partition(keys, lens, c) -> dict:
    """What a batch puts in the partitioned update's tiles
    (ops_cms.cms_tile_counts_plain at the kernel's tile): tiles touched,
    tiles that take more than one piece, sweep pieces, the fullest tile, and
    the plan's scratch."""
    log2, piece = sweep.flat_tile_geometry()
    pos = ops_cms.cms_positions(keys, lens, width=c.m, depth=c.k, seed=c.seed)
    n = ops_cms.cms_tile_counts_plain(pos, c.m, log2, lens >= 0)
    pieces = (n + piece - 1) // piece
    return {"tile_counters": 1 << log2, "piece": piece, "tiles": int(n.numel()),
            "tiles_touched": int((n > 0).sum()), "shared_tiles": int((pieces > 1).sum()),
            "pieces": int(pieces.sum()), "max_tile_entries": int(n.max()),
            "scratch_bytes": sweep.cms_tiled_scratch(c, int(keys.shape[0]), keys.device,
                                                     weighted=False).numel()}


def cms_crossover_grid(width: int, depth: int, log2b: tuple, ids: np.ndarray, seed: int,
                       device) -> dict:
    """Both count-min update kernels on unit batches of the Zipf stream,
    half an octave apart over ``log2b``, in turns on a zeroed grid of
    ``width`` x ``depth``; the smallest batch from which the partitioned
    one is the faster at every larger batch; and, at each batch, whether
    ``sweep.cms_takes_tiles`` picks the faster kernel and by how much its
    pick is slower than the faster one."""
    c = FilterConfig(m=width, k=depth, kind="cms", key_len=KEY_LEN, seed=seed)
    grid = torch.zeros(width * depth, dtype=torch.int32, device=device).view(torch.uint32)
    sectors = depth * width / 8
    runs = []
    for b in sorted({round(2 ** (h / 2)) for h in range(2 * log2b[0], 2 * log2b[1] + 1)}):
        keys, lens = key_batch(id_rows(ids[:b]))
        t = turns({"tiled": lambda i: sweep._cms_update_on(True, grid, keys, lens, c),
                   "per_key": lambda i: sweep._cms_update_on(False, grid, keys, lens, c)})
        tiled, per_key = t["tiled"]["ms"], t["per_key"]["ms"]
        takes = sweep.cms_takes_tiles(c, b)
        runs.append({"keys": b, "positions": b * depth, "positions_per_sector": b * depth / sectors,
                     "tiled_update_ms": tiled, "thread_a_key_update_ms": per_key,
                     "takes_tiles": takes, "picks_the_faster": takes == (tiled < per_key),
                     "pick_over_faster": (tiled if takes else per_key) / min(tiled, per_key),
                     "rounds": t})
    del grid
    torch.cuda.empty_cache()
    at = crossover_at(runs, "update")
    return {"width": width, "depth": depth, "bytes": 4 * width * depth, "runs": runs,
            "crossover_positions_per_sector": at,
            "crossover_positions": None if at is None else at * sectors,
            "worst_pick_over_faster": max(r["pick_over_faster"] for r in runs)}


def phase_cms_crossover(cms, ids: np.ndarray) -> dict:
    """Both count-min update kernels on each grid of CMS_CROSSOVER_GRIDS
    (:func:`cms_crossover_grid`): what sweep.CMS_TILE_CROSSOVER (the
    batch's positions, B depth) is set from."""
    t0 = time.perf_counter()
    grids = {name: cms_crossover_grid(w, d, r, ids, cms.config.seed, cms.words.device)
             for name, (w, d, r) in CMS_CROSSOVER_GRIDS.items()}
    emit("cms_crossover", grids=grids, constant=sweep.CMS_TILE_CROSSOVER,
         seconds=time.perf_counter() - t0)
    return grids


def occupied(state: torch.Tensor) -> int:
    return int((state.view(torch.int32) != 0).sum())


def cms_times(cms, ids: np.ndarray, rng) -> dict:
    """The count-min update's records for phase_sketch_times: a batch of
    2^20 of the Zipf stream, and 2^20 distinct ids, on a copy of the path's
    grid; each update kernel held against the plain version; the kernels
    and the library call in turns (:func:`cms_turns`); the thread-a-key
    kernel on a grid the L2 holds; the partition of both batches."""
    out = {}
    c = cms.config
    grid = clone_u32(cms.words)
    zipf = key_batch(id_rows(ids[:B_CMS]))
    uniform = key_batch(id_rows(rng.permutation(CMS_DISTINCT)[:B_CMS]))
    p_ms, err = cms_update_vs_plain(grid, *zipf, c)
    z, u = cms_turns(grid, *zipf, c), cms_turns(grid, *uniform, c)
    nbytes = B_CMS * (KEY_LEN + 4) + z["sectors"] * 32 * 2
    b_ms, b_by = bound(nbytes, B_CMS * (OPS_CMS_HASH + c.k * OPS_CMS_ROW))
    u_bytes = B_CMS * (KEY_LEN + 4) + u["sectors"] * 32 * 2
    u_b_ms, _ = bound(u_bytes, B_CMS * (OPS_CMS_HASH + c.k * OPS_CMS_ROW))
    # the thread-a-key kernel on a grid the L2 holds: its atomics' rate
    # without misses to device memory
    small = FilterConfig(m=1 << LOG2_CMS_L2_WIDTH, k=c.k, kind="cms", key_len=KEY_LEN, seed=c.seed)
    sgrid = torch.zeros(small.m * small.k, dtype=torch.int32, device=grid.device).view(torch.uint32)
    l2 = {"width": small.m, "bytes": 4 * small.m * small.k}
    for label, (keys, lens) in (("zipf", zipf), ("uniform", uniform)):
        runs = turns({"per_key": lambda i: sweep._cms_update_on(False, sgrid, keys, lens, small),
                      "path_grid": lambda i: sweep._cms_update_on(False, grid, keys, lens, c)})
        l2[label] = {"ms": runs["per_key"]["ms"], "path_grid_ms": runs["path_grid"]["ms"],
                     "atomics_per_s": B_CMS * c.k / runs["per_key"]["ms"] * 1e3, "runs": runs}
    del sgrid
    common = {"plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": z["index_add"]["ms"],
              "library": "index_add_ on the int32 view, positions precomputed",
              "keys": B_CMS, "sectors": z["sectors"], "bytes": nbytes}
    for name, key in (("cms_update", "per_key"), ("cms_update_tiled", "tiled")):
        out[name] = {"ms": z[key]["ms"], "max_abs_err": err[name], **common,
                     "share_of_bound": b_ms / z[key]["ms"], "uniform_ms": u[key]["ms"],
                     "uniform_bound_ms": u_b_ms, "uniform_sectors": u["sectors"],
                     "uniform_library_ms": u["index_add"]["ms"]}
    out["cms_update"]["l2_resident"] = l2
    out["cms_update_tiled"].update(
        partition=cms_partition(*zipf, c), uniform_partition=cms_partition(*uniform, c),
        turns={"zipf": z, "uniform": u},
        kernels_ms=kernel_ms(lambda i: sweep._cms_update_on(True, grid, *zipf, c), n=10))
    del grid
    torch.cuda.empty_cache()
    return out


def device_turns(ops: dict, rounds: int = CMS_TURNS, n: int = 20) -> dict:
    """As :func:`turns`, by the card's own time in each op's kernels
    (:func:`device_ms`): without the host's gaps between short launches. A
    round in which the profiler saw none of an op's kernels is unmeasured
    (``misses``) and is run again, up to ``rounds`` more times in all;
    then the run fails."""
    runs = {name: [] for name in ops}
    misses = {name: 0 for name in ops}
    for _ in range(rounds):
        for name, fn in ops.items():
            ms = device_ms(fn, n)
            while ms is None and misses[name] < rounds:
                misses[name] += 1
                ms = device_ms(fn, n)
            check(ms is not None, f"the profiler saw {name}'s kernels")
            runs[name].append(ms)
    return {name: {"ms": sorted(r)[len(r) // 2], "rounds": r, "misses": misses[name]}
            for name, r in runs.items()}


def launch_floor() -> dict:
    """The card's own ms of an empty launch through the kernels' ctypes path
    (a chase of no links, ``sweep._cuckoo_chase(rows, 0, 0)``: one thread
    that loads nothing), by the profiler, and the ms a call of it costs by
    CUDA events (the wrapper's one-word ``torch.zeros`` included)."""
    buf = torch.zeros(4, dtype=torch.int32, device="cuda")

    def empty(i):
        return sweep._cuckoo_chase(buf, 0, 0)

    chase = [v for k, v in kernel_ms(empty, n=50).items() if "cuckoo_chase" in k]
    check(len(chase) == 1, "the profiler saw the empty launch")
    return {"launch_floor_ms": chase[0], "launch_floor_call_ms": cuda_ms(empty, 50)}


def cuckoo_query_times(cf, held: tuple, absent: tuple, floor: dict, lat: dict) -> dict:
    """The cuckoo query of 2^16 held and 2^16 absent keys on the filled
    table: held against the plain version on a host copy (tolerance 0);
    the card's own ms (``ms``, ``absent_ms``, :func:`device_turns`) beside
    the ms a call costs by CUDA events (``call_ms``, ``absent_call_ms``),
    both in turns, the launch floor, one dependent device-memory read, and
    the byte bound (keys, lengths and verdicts once, two bucket sectors a
    key), whose share is taken of the device time."""
    cfg = cf.config
    host = host_copy(cf.words)
    p_ms, want = host_ms(lambda: sweep.cuckoo_query(host, held[0].cpu(), held[1].cpu(), cfg))
    err = max_abs_err(sweep.cuckoo_query(cf.words, *held, cfg).cpu(), want)
    want = sweep.cuckoo_query(host, absent[0].cpu(), absent[1].cpu(), cfg)
    err = max(err, max_abs_err(sweep.cuckoo_query(cf.words, *absent, cfg).cpu(), want))
    del host
    ops = {"held": lambda i: sweep.cuckoo_query(cf.words, *held, cfg),
           "absent": lambda i: sweep.cuckoo_query(cf.words, *absent, cfg)}
    calls, dev = turns(ops), device_turns(ops)
    B = held[0].shape[0]
    nbytes = B * (KEY_LEN + 4 + 1) + B * 2 * 32
    b_ms, b_by = bound(nbytes, B * (OPS_CUCKOO_HASH + 2 * OPS_CUCKOO_PROBE))
    ms = dev["held"]["ms"]
    return {"ms": ms, "absent_ms": dev["absent"]["ms"], "call_ms": calls["held"]["ms"],
            "absent_call_ms": calls["absent"]["ms"], **floor,
            "over_launch_floor": ms / floor["launch_floor_ms"],
            "device_memory_read_ms": lat["device_memory"]["us"] / 1e3,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: a gather and compare is several calls", "max_abs_err": err,
            "keys": B, "bytes": nbytes, "share_of_bound": b_ms / ms,
            "call_share_of_bound": b_ms / calls["held"]["ms"],
            "turns": {"call": calls, "device": dev}}


# The estimate's batches on the sketch path: the weighted increments' 2^12
# keys, a top-k batch of 2^16 and the estimate check's 2^20 (distinct ids),
# the ends of its crossover's range; and a grid whose row (108 MB) the L2
# cannot hold, CMS.INITBYPROB key 0.0000001 0.001 (761 MB).
EST_LOG2B = (12, 16, 20)
CMS_ROW_OVER_L2_WIDTH = 27_182_848


def estimate_ops(grid, keys, lens, c) -> dict:
    """The count-min estimate of ``keys`` on ``grid`` as ops of
    :func:`turns`: each of its kernels (``sweep.CMS_ESTIMATES``), or in a
    tree with one kernel its wrapper (``estimate``)."""
    if not hasattr(sweep, "CMS_ESTIMATES"):
        return {"estimate": lambda i: sweep.cms_estimate(grid, keys, lens, c)}
    return {k: lambda i, k=k: sweep._cms_estimate_on(k, grid, keys, lens, c)
            for k in sweep.CMS_ESTIMATES}


def picked(batch: int) -> str:
    """The op of :func:`estimate_ops` that the wrapper runs at ``batch``."""
    if not hasattr(sweep, "CMS_ESTIMATES"):
        return "estimate"
    return "rows" if sweep.cms_takes_rows(batch) else "thread_a_key"


def estimate_crossover(grid, zipf: np.ndarray, distinct: np.ndarray, c) -> dict:
    """Each estimate kernel on batches of the Zipf stream and of distinct
    ids, an octave apart from 2^EST_LOG2B[0] to 2^EST_LOG2B[-1], by the
    card's own time (:func:`device_turns`, one round); at each batch the
    faster kernel and whether the wrapper's pick (``sweep.cms_takes_rows``)
    is it, and by how much it is slower; and the smallest batch from which
    the row-phased kernel is the faster at every larger one: what
    ``sweep.CMS_ROWS_CROSSOVER`` is set from."""
    out = {}
    for label, ids in (("zipf", zipf), ("distinct", distinct)):
        runs = []
        for b in range(EST_LOG2B[0], EST_LOG2B[-1] + 1):
            keys, lens = key_batch(id_rows(ids[: 1 << b]))
            t = device_turns(estimate_ops(grid, keys, lens, c), rounds=1)
            ms = {k: v["ms"] for k, v in t.items()}
            pick = "rows" if sweep.cms_takes_rows(1 << b) else "thread_a_key"
            runs.append({"keys": 1 << b, **{f"{k}_ms": v for k, v in ms.items()},
                         "faster": min(ms, key=ms.get), "pick": pick,
                         "pick_over_faster": ms[pick] / min(ms.values())})
        rows_from = None
        for r in reversed(runs):
            if r["rows_ms"] >= r["thread_a_key_ms"]:
                break
            rows_from = r["keys"]
        out[label] = {"runs": runs, "rows_faster_from": rows_from,
                      "worst_pick_over_faster": max(r["pick_over_faster"] for r in runs)}
    return {**out, "constant": sweep.CMS_ROWS_CROSSOVER}


def estimate_record(batch: dict, op: str) -> dict:
    """One estimate kernel's record at one batch of :func:`cms_estimate_times`."""
    d, c = batch["turns"]["device"], batch["turns"]["call"]
    ms = d[op]["ms"]
    return {"keys": batch["keys"], "ms": ms, "call_ms": c[op]["ms"], "plain_ms": batch["plain_ms"],
            "bound_ms": batch["bound_ms"], "bound_by": batch["bound_by"],
            "share_of_bound": batch["bound_ms"] / ms, "library_ms": batch["library_ms"],
            "library_call_ms": batch["library_call_ms"],
            "library": "index_select + amin, positions precomputed",
            "max_abs_err": batch["max_abs_err"], "sectors": batch["sectors"],
            "bytes": batch["bytes"]}


def cms_estimate_times(cms, ids: np.ndarray, rng) -> dict:
    """The count-min estimate on the sketch path's grid: the Zipf batch of
    2^20 (``zipf_2^20``) and 2^12, 2^16 and 2^20 distinct ids; each kernel
    held against the plain version on a host copy (tolerance 0), then the
    kernels and ``index_select`` + ``amin`` on the same positions in turns,
    by the card's own time (``ms``) and by CUDA events a call
    (``call_ms``), beside the byte bound (keys and lengths read, estimates
    written, each distinct 32-byte sector of the batch's counters read
    once), whose share is taken of the device time. Then the 2^20 batches
    on a grid the L2 holds (2^18 x 7, 7 MiB: the floor of the same gathers
    without misses to device memory), 2^20 distinct ids on a grid whose row
    the L2 cannot hold (27,182,848 x 7), and in a tree with both kernels
    :func:`estimate_crossover`. Returns a record for each kernel: the
    thread-a-key ``cms_estimate`` at the top-k batch's 2^16 keys, the
    row-phased ``cms_estimate_rows`` at the estimate check's 2^20 distinct
    ids, each with its Zipf 2^20 time (``zipf_ms``)."""
    c = cms.config
    grid = cms.words
    perm = rng.permutation(CMS_DISTINCT)
    distinct = id_rows(perm[:B_CMS])
    batches = {"zipf_2^20": key_batch(id_rows(ids[:B_CMS])),
               **{f"distinct_2^{b}": key_batch(distinct[: 1 << b]) for b in EST_LOG2B}}
    host = host_copy(grid)
    out = {}
    for label, (keys, lens) in batches.items():
        p_ms, want = host_ms(lambda: sweep.cms_estimate(host, keys.cpu(), lens.cpu(), c))
        ops = estimate_ops(grid, keys, lens, c)
        err = max(max_abs_err(i32(op(0)), i32(want)) for op in ops.values())
        flat = cms_flat(keys, lens, c)
        ops["index_select_amin"] = lambda i, flat=flat: index_select_amin(grid, flat, c)
        calls, dev = turns(ops), device_turns(ops)
        B = keys.shape[0]
        sectors = int(torch.unique(flat >> 3).numel())
        nbytes = B * (KEY_LEN + 4 + 4) + sectors * 32
        b_ms, b_by = bound(nbytes, B * (OPS_CMS_HASH + c.k * OPS_CMS_ROW))
        op = picked(B)
        out[label] = {"keys": B, "sectors": sectors, "bytes": nbytes, "kernel": op,
                      "ms": dev[op]["ms"], "call_ms": calls[op]["ms"],
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "share_of_bound": b_ms / dev[op]["ms"],
                      "library_ms": dev["index_select_amin"]["ms"],
                      "library_call_ms": calls["index_select_amin"]["ms"], "max_abs_err": err,
                      "turns": {"call": calls, "device": dev}}
    del host
    small = FilterConfig(m=1 << LOG2_CMS_L2_WIDTH, k=c.k, kind="cms", key_len=KEY_LEN, seed=c.seed)
    sgrid = torch.zeros(small.m * small.k, dtype=torch.int32, device=grid.device).view(torch.uint32)
    l2 = {"width": small.m, "bytes": 4 * small.m * small.k}
    for label in ("zipf_2^20", f"distinct_2^{EST_LOG2B[-1]}"):
        runs = device_turns(estimate_ops(sgrid, *batches[label], small), rounds=1)
        floor = runs[picked(1)]["ms"]  # a thread a key
        l2[label] = {"ms": floor, "path_over_floor": out[label]["ms"] / floor, "runs": runs}
    del sgrid
    big = FilterConfig(m=CMS_ROW_OVER_L2_WIDTH, k=c.k, kind="cms", key_len=KEY_LEN, seed=c.seed)
    bgrid = torch.zeros(big.m * big.k, dtype=torch.int32, device=grid.device).view(torch.uint32)
    keys, lens = batches[f"distinct_2^{EST_LOG2B[-1]}"]
    flat = cms_flat(keys, lens, big)
    ops = {**estimate_ops(bgrid, keys, lens, big),
           "index_select_amin": lambda i: index_select_amin(bgrid, flat, big)}
    runs = device_turns(ops, rounds=1)
    sectors = int(torch.unique(flat >> 3).numel())
    nbytes = B_CMS * (KEY_LEN + 4 + 4) + sectors * 32
    row_over_l2 = {"width": big.m, "bytes": 4 * big.m * big.k, "keys": B_CMS, "sectors": sectors,
                   "ms": runs[picked(B_CMS)]["ms"], "bound_ms": bound(nbytes, 0)[0],
                   "library_ms": runs["index_select_amin"]["ms"], "runs": runs}
    del bgrid, flat
    torch.cuda.empty_cache()
    common = {"batches": out, "l2_resident": l2, "row_over_l2": row_over_l2}
    z, small_b, big_b = (out["zipf_2^20"], out[f"distinct_2^{EST_LOG2B[1]}"],
                         out[f"distinct_2^{EST_LOG2B[-1]}"])
    if not hasattr(sweep, "CMS_ESTIMATES"):  # a tree with the thread-a-key kernel alone
        return {"cms_estimate": {**estimate_record(big_b, "estimate"),
                                 "zipf_ms": z["turns"]["device"]["estimate"]["ms"], **common}}
    common["crossover"] = estimate_crossover(grid, ids, perm, c)
    return {"cms_estimate": {**estimate_record(small_b, "thread_a_key"),
                             "zipf_ms": z["turns"]["device"]["thread_a_key"]["ms"],
                             "path_2^20_ms": big_b["turns"]["device"]["thread_a_key"]["ms"]},
            "cms_estimate_rows": {**estimate_record(big_b, "rows"),
                                  "zipf_ms": z["turns"]["device"]["rows"]["ms"], **common}}


def phase_query_times(cf, cms, held: np.ndarray, ids: np.ndarray, rng) -> dict:
    """The two query kernels' records (:func:`cuckoo_query_times` on 2^16
    held keys and 2^16 fresh ones, :func:`cms_estimate_times`), with the
    launch floor and the latency of one dependent device-memory read."""
    t0 = time.perf_counter()
    lat = {"device_memory": chase_us(CHASE_TABLE_BYTES, warm=False)}
    floor = launch_floor()
    held_keys = key_batch(held[N_CUCKOO_DELETE : N_CUCKOO_DELETE + B_CUCKOO])
    out = {"cuckoo_query": cuckoo_query_times(cf, held_keys, key_batch(rows(rng, B_CUCKOO)),
                                              floor, lat),
           **cms_estimate_times(cms, ids, rng)}
    emit("query_times", latency=lat, **out, seconds=time.perf_counter() - t0)
    return out


def phase_sketch_times(cf, cms, held: np.ndarray, ids: np.ndarray, rng) -> dict:
    """Each sketch kernel's ms by CUDA events at the sketch path's shapes
    (the cuckoo walks a batch of 2^16 on the filled table, restored from a
    snapshot before each launch, and the insert again at a quarter load;
    the count-min update a batch of 2^20 on its grid), beside its bound,
    its plain version's ms on a host copy of the same state, with which its
    result must agree (tolerance 0), and for the count-min update one
    PyTorch call on the same positions. The cuckoo pair's round walk is
    timed against the warp walk and one thread alone, and at each of
    WALK_WINDOWS; the latency of one dependent read, by a pointer chase,
    gives the warp walk's sequential latency floor. The two queries
    (:func:`cuckoo_query_times`, :func:`cms_estimate_times`) by the card's
    own time beside their call time and the launch floor."""
    t0 = time.perf_counter()
    lat = {"l2": chase_us(CHASE_L2_BYTES, warm=True),
           "device_memory": chase_us(CHASE_TABLE_BYTES, warm=False)}
    out = {}
    cfg = cf.config
    B = B_CUCKOO
    keys, lens = key_batch(rows(rng, B))
    out["cuckoo_insert"] = cuckoo_insert_times(cf.words, keys, lens, cfg, lat)
    clones = [clone_u32(cf.words) for _ in range(4)]
    out["cuckoo_insert"]["kernels_ms"] = kernel_ms(  # a fresh table a call: no second window
        lambda i: sweep.cuckoo_insert(clones.pop(), keys, lens, cfg), n=3, tries=1)
    del clones
    out["cuckoo_insert"].update(library_ms=None, library="none: torch has no ordered cuckoo walk")
    # the same batch on a table at a quarter load: keys placed at once, no kicks
    quarter = torch.zeros(cfg.m, dtype=torch.int32, device="cuda").view(torch.uint32)
    for _ in range(cfg.m // 4 // B):
        sweep.cuckoo_insert(quarter, *key_batch(rows(rng, B)), cfg)
    out["cuckoo_insert"]["quarter_load"] = cuckoo_insert_times(quarter, keys, lens, cfg, lat)
    del quarter
    # delete: held keys of the filled table
    dkeys, dlens = key_batch(held[N_CUCKOO_DELETE : N_CUCKOO_DELETE + B])
    host = host_copy(cf.words)
    p_ms, pd = host_ms(lambda: sweep.cuckoo_delete(host, dkeys.cpu(), dlens.cpu(), cfg))
    reads: set = set()
    ops_cuckoo.cuckoo_delete_plain(host_copy(cf.words), dkeys.cpu(), dlens.cpu(), cfg, reads)
    read_sectors = len({b >> 1 for b in reads})
    written_sectors = changed_sectors(host_copy(cf.words), host)
    ab, err = walk_ab(cf.words, dkeys, dlens, cfg, False, (host, pd))
    del host
    ms = fresh_ms(cf.words, lambda i: sweep.cuckoo_delete(cf.words, dkeys, dlens, cfg), n=5, warm=1)
    nbytes = B * (KEY_LEN + 4 + 1) + 32 * (read_sectors + written_sectors)
    b_ms, b_by = bound(nbytes, B * (OPS_CUCKOO_HASH + 2 * OPS_CUCKOO_PROBE))
    out["cuckoo_delete"] = {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "library": "none: torch has no ordered cuckoo walk",
                            "max_abs_err": err, "keys": B, "read_sectors": read_sectors,
                            "written_sectors": written_sectors, "bytes": nbytes,
                            "share_of_bound": b_ms / ms, **walk_record(ms, B, ab, lat, B)}
    floor = launch_floor()
    out["cuckoo_query"] = cuckoo_query_times(cf, (dkeys, dlens), (keys, lens), floor, lat)
    out.update(cms_times(cms, ids, rng))
    out.update(cms_estimate_times(cms, ids, rng))
    errs = {name: out[name]["max_abs_err"] for name in SKETCH_KERNELS}
    errs["cuckoo_insert_quarter_load"] = out["cuckoo_insert"]["quarter_load"]["max_abs_err"]
    check(max(errs.values()) == 0, f"sketch kernels equal their plain versions at the path's "
                                   f"batches ({errs})")
    emit("sketch_times", latency=lat, **out, seconds=time.perf_counter() - t0)
    return out


# The update kernels and the bit filter's query kernels move a key's row
# with a group of lanes; the counting query kernels keep a thread a key.
GROUP_DESIGN = ("blocked_insert", "blocked_counting_update", "blocked_query",
                "sharded_blocked_insert", "sharded_blocked_counting_update",
                "sharded_blocked_query")
DESIGN = {"blocked_test_insert": "partitioned by 64 KiB row tile (flat_partition.cuh, a key an "
                                  "entry), a CTA a tile: its rows tested, then set, in shared memory"}
EXTRA_TIMES = ("replay_ms", "present_ms", "delete_ms", "sparse_ms", "mix_ms", "crowd_ms", "config2_ms")
# The flat kernels' sources and designs.
FLAT_SOURCE = {"flat_insert_tiled": "flat_bits.cu", "sharded_flat_insert_tiled": "flat_bits.cu"}
FLAT_DESIGN = {"flat_query": "thread a key, stops at its first zero bit",
               "sharded_flat_query": "thread a key, stops at its first zero bit"}


ROUND_DESIGN = ("a thread a key hashes; then one CTA walks a window of keys at once against "
                "the table (private logs), checks them in batch order by bucket owners and "
                "commits the valid prefix, round after round")
# The sketch kernels have no Pallas counterpart either: each replaces the
# XLA ops of a tpubloom function. name -> (source, replaces, design).
SKETCH_KERNELS = {
    "cuckoo_insert": ("cuckoo.cu", "tpubloom/ops/cuckoo.py:101 (cuckoo_insert, a lax.scan over "
                      "the batch with a fixed-trip kick chain and unwind)", ROUND_DESIGN),
    "cuckoo_delete": ("cuckoo.cu", "tpubloom/ops/cuckoo.py:184 (cuckoo_delete, a lax.scan)",
                      ROUND_DESIGN),
    "cuckoo_query": ("cuckoo.cu", "tpubloom/ops/cuckoo.py:172 (cuckoo_query)",
                     "thread a key: length and key words in one trip, then both 16-byte bucket "
                     "rows in flight"),
    "cms_update": ("cms.cu", "tpubloom/ops/cms.py:53 (cms_update, words.at[flat].add)",
                   "thread a key: depth atomicAdd (batches sweep.cms_takes_tiles leaves it)"),
    "cms_update_tiled": ("cms.cu", "tpubloom/ops/cms.py:53 (cms_update, words.at[flat].add)",
                         "partitioned by 64 KiB tile of the grid (flat_partition.cuh, u32 "
                         "counters, row-major), each tile added in shared memory"),
    "cms_estimate": ("cms.cu", "tpubloom/ops/cms.py:71 (cms_estimate, a gather and row minimum)",
                     "thread a key: depth gathers in flight, then their minimum (batches "
                     "sweep.cms_takes_rows leaves it)"),
    "cms_estimate_rows": ("cms.cu", "tpubloom/ops/cms.py:71 (cms_estimate, a gather and row "
                          "minimum)", "row-phased: one resident launch, up to 8 keys a thread "
                          "loaded with their lengths in one trip and hashed once, then the rows "
                          "in order, a row's gathers issued together with the next row in flight"),
}
# A count-min wrapper counts each call under its name, and under its other
# kernel's name too when that one ran.
COUNTED_WITH = {"cms_update": "cms_update_tiled", "cms_estimate": "cms_estimate_rows"}


# The flat kernels have no Pallas counterpart: each replaces the XLA ops of
# a tpubloom function (its sort + segmented scan + scatter, or its gather).
FLAT_REPLACES = {
    "flat_insert": "tpubloom/filter.py:51 (make_insert_fn + ops/bitops.py:75 scatter_or)",
    "flat_query": "tpubloom/filter.py:72 (make_query_fn + ops/bitops.py:107 query_membership)",
    "flat_counting_update": "tpubloom/filter.py:86 (make_counter_fn + ops/counting.py:36 counter_update)",
    "flat_counting_query": "tpubloom/filter.py:104 (make_counting_query_fn + ops/counting.py:92 "
                           "counting_membership)",
    "sharded_flat_insert": "tpubloom/parallel/sharded.py:139 (make_sharded_insert_fn)",
    "sharded_flat_query": "tpubloom/parallel/sharded.py:164 (make_sharded_query_fn)",
    "sharded_flat_counting_update": "tpubloom/parallel/sharded.py:394 (make_sharded_counter_fn)",
    "sharded_flat_counting_query": "tpubloom/parallel/sharded.py:420 (make_sharded_counting_query_fn)",
}


SERVER_DIR = Path(__file__).resolve().parent / ".server_sink"  # git-ignored; removed at the end
SERVER_KEYS = 1 << 23  # the insert traffic: 128 InsertBatch requests of 2^16 keys
SERVER_REQUEST = 1 << 16
SERVER_THREADS = 8  # BloomClient threads in all
SERVER_CLIENT_PROCS = 4  # client processes, SERVER_THREADS // SERVER_CLIENT_PROCS threads each
SERVER_PROBES = 1 << 20  # held keys queried, and as many fresh ones
SERVER_COALESCE_KEYS = 1 << 19  # up to eight 2^16-key requests a flush (8 MiB max_bytes)
SERVER_SKETCH_KEYS = 1 << 16
SERVER_KERNELS = ("blocked_insert", "blocked_query", "cuckoo_insert", "cuckoo_query",
                  "cms_update", "cms_estimate", "payload_crc32c")


def key_list(r: np.ndarray) -> list:
    """Fixed-width ``uint8[n, 16]`` rows as the list of 16-byte ``bytes``
    a client passes (one C-level conversion, no per-key Python loop)."""
    return np.ascontiguousarray(r).view(f"V{r.shape[1]}").ravel().tolist()


class FlushClock:
    """The dispatcher's time in the coalescer's flushes, timed from
    outside: each flush's wall time and keys by flush kind; inside a flush,
    the seconds of its merge of the parked requests' keys (``_merge``) and
    of the served filter's ``stage_batch`` (padding and the pageable H2D
    copy), ``launch_insert`` and ``launch_query`` calls; and the time the
    dispatcher waits on the previous insert's completion fence
    (``InFlight.take``). It opens no request context, so every flush runs
    as it does in production."""

    def __init__(self, coalescer, filt):
        self.spans: dict = {}
        self.fence_s = 0.0
        self._acc = None
        inner = coalescer._flush_inner

        def timed(name, kind, entries, ftrace):
            acc = self._acc = self.spans.setdefault(kind, {"flushes": 0, "keys": 0, "wall_s": 0.0})
            t0 = time.perf_counter()
            try:
                return inner(name, kind, entries, ftrace)
            finally:
                acc["flushes"] += 1
                acc["keys"] += sum(e.nkeys for e in entries)
                acc["wall_s"] += time.perf_counter() - t0
                self._acc = None

        coalescer._flush_inner = timed
        coalescer._inflight.take = self._timed(coalescer._inflight.take, None)
        coalescer._merge = self._timed(coalescer._merge, "merge_s")
        for attr in ("stage_batch", "launch_insert", "launch_query"):
            setattr(filt, attr, self._timed(getattr(filt, attr), f"{attr}_s"))

    def _timed(self, fn, bucket):
        """``fn`` adding its seconds to the fence, or to ``bucket`` of the
        flush it runs in."""
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                if bucket is None:
                    self.fence_s += dt
                elif self._acc is not None:
                    self._acc[bucket] = self._acc.get(bucket, 0.0) + dt
        return call

    def report(self) -> dict:
        out = {kind: {**acc, "keys_per_flush": acc["keys"] / acc["flushes"]}
               for kind, acc in self.spans.items()}
        out["insert_fence_s"] = self.fence_s
        return out


def device_split(prof) -> dict:
    """The card's own ms in each kernel or copy of a profiler window (its
    device events, by name without the argument list)."""
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            key = e.key.split("(")[0].removeprefix("void ").strip()
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3
    return out


def client_parts(p: int, jobs, barrier, results, connect, call) -> None:
    """The loop of client process ``p``: it stays up across parts, taking
    ``(address, requests)`` parts from the queue ``jobs`` until None. Each
    part runs on ``SERVER_THREADS // SERVER_CLIENT_PROCS`` threads, each
    with its own ``connect(address)`` client (Health-probed first), thread
    ``t`` taking requests ``t, t + threads, ...`` through ``call(client,
    request, tally, rid)``, whose result is the request's output and which
    adds its sheds and re-drives to ``tally``. The process meets the
    server's process at ``barrier`` twice before a part and once after,
    and puts ``(p, outputs, (sheds, re-drives), error)`` on ``results``."""
    import threading

    n_threads = SERVER_THREADS // SERVER_CLIENT_PROCS
    part_no = 0
    while True:
        part = jobs.get()
        if part is None:
            return
        addr, reqs = part
        part_no += 1
        clients = []
        try:
            clients = [connect(addr) for _ in range(n_threads)]
            for cl in clients:
                cl.health()
            out, errors = [None] * len(reqs), []
            tallies = [[0, 0] for _ in range(n_threads)]

            def worker(t):
                try:
                    for i in range(t, len(reqs), n_threads):
                        out[i] = call(clients[t], reqs[i], tallies[t], f"{p}-{part_no}-{i}")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            barrier.wait()
            barrier.wait()
            threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise errors[0]
            barrier.wait()
            results.put((p, out, tuple(map(sum, zip(*tallies))), None))
        except BaseException as e:  # noqa: BLE001 — reported to the server's process
            barrier.abort()
            results.put((p, None, (0, 0), repr(e)))
            return
        finally:
            for cl in clients:
                cl.close()


def pool_client(p: int, jobs, barrier, results) -> None:
    """Client process ``p`` of the server and durable paths
    (:func:`client_parts`; each request one ``keys_fixed`` frame of the
    rows, as a client holding ``uint8[n, 16]`` keys sends it, ``(method,
    name, rows, extra fields)``). A request shed with
    ``RESOURCE_EXHAUSTED`` goes again after its ``retry_after_ms``; one
    applied but short of its quorum (the replica's stream reconnecting)
    goes again with its rid. Its output is the verdicts (None for an
    insert)."""
    from tpubloom_torch.server.client import BloomClient
    from tpubloom_torch.server.protocol import BloomServiceError

    def call(cl, job, tally, rid):
        method, name, r, extra = job
        req = {"name": name, "keys_fixed": {"data": r.tobytes(), "width": r.shape[1], "n": len(r)},
               "rid": f"pool-{rid}", **extra}
        while True:
            try:
                resp = cl._call_once(method, req, timeout=600)
                break
            except BloomServiceError as e:
                if e.code == "NOT_ENOUGH_REPLICAS" and e.details.get("applied"):
                    # applied and logged, but the replica was not connected
                    # (its stream reconnecting): the same rid again waits on
                    # the quorum once more
                    tally[1] += 1
                    time.sleep(0.02)
                    continue
                if e.code != "RESOURCE_EXHAUSTED":
                    raise
                tally[0] += 1
                time.sleep(float(e.details.get("retry_after_ms") or 50) / 1e3)
        if method == "QueryBatch":
            return BloomClient._unpack_bool(resp, "hits")
        check(resp["n"] == len(r), f"{method} count")
        return None

    client_parts(p, jobs, barrier, results, BloomClient, call)


class ClientPool:
    """``SERVER_CLIENT_PROCS`` spawned :func:`pool_client` processes (or
    ``target``'s, with ``args`` after the queues), started once for every
    part of a phase; a part's requests go on queues once every process
    runs (as spawn arguments they would be written to one process before
    the next starts)."""

    def __init__(self, target=None, args=()):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.n = SERVER_CLIENT_PROCS
        self.barrier = ctx.Barrier(self.n + 1, timeout=900)
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(self.n)]
        self.procs = [ctx.Process(target=target or pool_client, daemon=True,
                                  args=(p, self.jobs[p], self.barrier, self.results, *args))
                      for p in range(self.n)]
        for pr in self.procs:
            pr.start()

    def run(self, addr: str, reqs: list, window=None) -> dict:
        """One part: the requests dealt round robin to the processes, run
        together from one start; its seconds (from the start to the last
        reply; ``window()``, when given, runs right after, inside the
        caller's profiler window), the verdicts in request order, the sheds
        retried, and the seconds the processes took to connect."""
        import threading

        for p, q in enumerate(self.jobs):
            q.put((addr, reqs[p::self.n]))
        t_ready = time.perf_counter()
        seconds = None
        try:
            self.barrier.wait()
            ready = time.perf_counter() - t_ready
            self.barrier.wait()
            t0 = time.perf_counter()
            self.barrier.wait()
            seconds = time.perf_counter() - t0
            if window is not None:
                window()
        except threading.BrokenBarrierError:
            pass  # a client failed: its error is on the queue
        got = {}
        for _ in range(self.n):
            p, out, sheds, err = self.results.get(timeout=900)
            check(err is None, f"client process {p} failed: {err}")
            got[p] = (out, sheds)
        check(seconds is not None, "the client processes ran the part")
        return {"seconds": seconds, "ready_s": ready,
                "out": [got[i % self.n][0][i // self.n] for i in range(len(reqs))],
                "sheds": sum(s[0] for _, s in got.values()),
                "quorum_redrives": sum(s[1] for _, s in got.values())}

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for pr in self.procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.terminate()
                pr.join()


def server_traffic(addr: str, inserts: list, queries: list) -> dict:
    """The server path's traffic from a :class:`ClientPool`, so that no
    client shares the server's GIL: every insert job, then every query job
    (``uint8[n, 16]`` rows of the filter "main"), each part timed on the
    host clock from the moment the processes start it together to the last
    reply, under a ``torch.profiler`` window that reads the card's own
    time. Returns each part's seconds and device split (and the seconds its
    profiler window held), the seconds the processes took to connect, and
    the verdicts in job order."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    pool = ClientPool()
    try:
        for part, method, jobs in (("insert", "InsertBatch", inserts),
                                   ("query", "QueryBatch", queries)):
            t_prof = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                run = pool.run(addr, [(method, "main", r, {}) for r in jobs],
                               window=torch.cuda.synchronize)
            device = device_split(prof)
            out.setdefault("clients_ready_s", run["ready_s"])
            out[part] = {"seconds": run["seconds"], "device_ms": device,
                         "device_busy_share": sum(device.values()) / 1e3 / run["seconds"],
                         "profiled_s": time.perf_counter() - t_prof}
    finally:
        pool.close()
    out["hits"] = np.concatenate(run["out"])
    return out


def phase_server_path(rng, dev: dict) -> dict:
    """The port's gRPC server on the card (``tpubloom_torch.server``), the
    coalescer on at up to 2^19 keys a flush: the main path's filter
    (m=2^32, k=7, block_bits=512, 16-byte keys) created over gRPC, 2^23
    keys inserted as 128 ``InsertBatch`` requests of 2^16 from 8
    ``BloomClient`` threads in 4 client processes (fixed-width frames of
    the rows), 2^20 held and 2^20 fresh keys queried the same way, one
    ``InsertBatch(return_presence)`` of 2^16 keys half held, a
    ``Checkpoint`` restored by a second service, and CF / CMS verbs at 2^16
    keys; every result held against a filter or sketch fed the same keys
    directly (words with tolerance 0)."""
    from tpubloom_torch.server import ingest, service
    from tpubloom_torch.server.client import BloomClient

    t_phase = time.perf_counter()
    if SERVER_DIR.exists():
        shutil.rmtree(SERVER_DIR)
    SERVER_DIR.mkdir()

    def sink(config):
        return checkpoint.FileSink(str(SERVER_DIR))

    svc = service.BloomService(
        sink_factory=sink, coalesce=ingest.CoalesceConfig(max_keys=SERVER_COALESCE_KEYS))
    srv, port = service.build_server(svc, "127.0.0.1:0")
    srv.start()
    addr = f"127.0.0.1:{port}"
    # block_hash named: a config dict without it restores as "ap", the
    # legacy wire default, while the main path's filter hashes "chunk"
    cfg = {"m": 1 << LOG2M, "k": K, "block_bits": BLOCK_BITS, "key_len": KEY_LEN,
           "block_hash": "chunk"}
    keys = rows(rng, SERVER_KEYS)
    inserts = [keys[i:i + SERVER_REQUEST] for i in range(0, SERVER_KEYS, SERVER_REQUEST)]
    held = keys[rng.choice(SERVER_KEYS, SERVER_PROBES, replace=False)]
    fresh = rows(rng, SERVER_PROBES)
    queries = [r[i:i + SERVER_REQUEST] for r in (held, fresh)
               for i in range(0, SERVER_PROBES, SERVER_REQUEST)]
    pres = np.concatenate([keys[: SERVER_REQUEST // 2], rows(rng, SERVER_REQUEST // 2)])
    sk_keys, sk_fresh = rows(rng, SERVER_SKETCH_KEYS), rows(rng, SERVER_SKETCH_KEYS)
    weights = rng.integers(1, 1000, SERVER_SKETCH_KEYS // 16)
    try:
        with BloomClient(addr) as c:
            health = c.health()
            check(health["backend"] == "cuda", f"Health backend {health['backend']}")
            check(health["devices"][0] == torch.cuda.get_device_name(0), "Health names the card")
            c.create_filter("main", config=cfg)
        served = svc._filters["main"].filter
        check(served.words.is_cuda, "the served filter lives on the card")
        clock = FlushClock(svc._coalescer, served)
        metrics0 = svc.metrics.snapshot()["counters"]
        sweep.reset_launch_counts()
        checksum.reset_launch_counts()

        t0 = time.perf_counter()
        traffic = server_traffic(addr, inserts, queries)
        traffic_s = time.perf_counter() - t0
        hits = traffic.pop("hits")
        after_traffic = svc.metrics.snapshot()["counters"]
        pre = served.words.clone()  # the state the direct filter must reach
        flush_wall = clock.report()
        with BloomClient(addr) as c:
            before = sweep.launch_counts()
            presence = c.insert_batch("main", key_list(pres), return_presence=True)
            torch.cuda.synchronize()
            presence_kernels = {k: v - before[k] for k, v in sweep.launch_counts().items()
                                if v != before[k]}
            t0 = time.perf_counter()
            c.checkpoint("main")
            checkpoint_s = time.perf_counter() - t0
            cf_cfg = c.cf_reserve("cf", SERVER_SKETCH_KEYS, key_len=KEY_LEN)["config"]
            cf_added = c.cf_add("cf", key_list(sk_keys))
            cf_hits = c.cf_exists("cf", key_list(np.concatenate([sk_keys, sk_fresh])))
            cms_cfg = c.cms_init_by_dim("cms", SERVER_SKETCH_KEYS, 5, key_len=KEY_LEN)["config"]
            c.cms_incrby("cms", key_list(sk_keys))
            w_counts = c.cms_incrby("cms", key_list(sk_keys[: len(weights)]), weights.tolist())
            cms_counts = c.cms_query("cms", key_list(np.concatenate([sk_keys, sk_fresh])))
        torch.cuda.synchronize()
        launches = {**sweep.launch_counts(), **checksum.launch_counts()}
        for name in SERVER_KERNELS:
            check(launches[name] > 0, f"{name} launched on the server path")
        counters_ = svc.metrics.snapshot()["counters"]
        rpc = svc.metrics.snapshot()
        # a second service on the card restores the checkpoint
        svc2 = service.BloomService(sink_factory=sink)
        t0 = time.perf_counter()
        restored = svc2.CreateFilter({"name": "main", "config": cfg})
        restore_s = time.perf_counter() - t0
        check(restored["restored_seq"] is not None, "the second service restored the checkpoint")
        restored_err = max_abs_err(svc2._filters["main"].filter.words, served.words)
        check(restored_err == 0, "restored words equal the served words")
        svc2.DropFilter({"name": "main", "final_checkpoint": False})

        # the same keys fed directly to the port's filter and sketches
        direct = BlockedBloomFilter(FilterConfig(key_name="main", **cfg))
        direct.insert_packed(keys)
        insert_err = max_abs_err(pre, direct.words)
        check(insert_err == 0, "served words equal the direct filter's")
        n_held = SERVER_PROBES
        check(hits[:n_held].all(), "every held key hits over gRPC")
        want_fresh = direct.include_packed(fresh)
        check(np.array_equal(hits[n_held:], want_fresh), "fresh verdicts equal the direct filter's")
        fpr = fpr_bound(int(hits[n_held:].sum()), SERVER_PROBES, SERVER_KEYS, direct.config)
        want_pres = direct.insert_batch(key_list(pres), return_presence=True)
        check(np.array_equal(presence, want_pres), "presence equals the direct test-and-insert")
        check(presence[: SERVER_REQUEST // 2].all(), "held half of the presence batch present")
        presence_err = max_abs_err(served.words, direct.words)
        check(presence_err == 0, "words after the presence batch equal the direct filter's")
        del pre, direct

        cf = CuckooFilter(FilterConfig.from_dict(cf_cfg))
        cf.insert_batch(key_list(sk_keys))
        check(np.array_equal(cf_added, cf.take_insert_flags()), "CFAdd verdicts equal the direct filter's")
        check(np.array_equal(cf_hits, cf.include_batch(key_list(np.concatenate([sk_keys, sk_fresh])))),
              "CFExists equals the direct filter's")
        cf_err = max_abs_err(svc._filters["cf"].filter.words, cf.words)
        cms = CountMinSketch(FilterConfig.from_dict(cms_cfg))
        cms.insert_batch(key_list(sk_keys))
        want_w = cms.increment_batch(key_list(sk_keys[: len(weights)]), weights.tolist())
        check(w_counts == [int(x) for x in want_w], "weighted CMSIncrBy equals the direct sketch's")
        check(np.array_equal(cms_counts, cms.estimate_batch(key_list(np.concatenate([sk_keys, sk_fresh])))),
              "CMSQuery equals the direct sketch's")
        cms_err = max_abs_err(svc._filters["cms"].filter.words, cms.words)
        check(cf_err == 0 and cms_err == 0, "served sketches' words equal the direct ones'")
        del cf, cms
    finally:
        srv.stop(grace=None)
        for name in list(svc._filters):
            svc.DropFilter({"name": name, "final_checkpoint": False})
        svc.shutdown()
        shutil.rmtree(SERVER_DIR, ignore_errors=True)
    names = ("ingest_flushes", "ingest_query_flushes", "ingest_requests_coalesced",
             "ingest_keys_coalesced")

    def delta(after, before):
        return {k: after.get(k, 0) - before.get(k, 0) for k in names}

    flushes = {"traffic": delta(after_traffic, metrics0), "phase": delta(counters_, metrics0)}
    for kind in ("insert", "query"):
        if kind in flush_wall:
            flush_wall[kind]["dispatcher_busy_share"] = flush_wall[kind]["wall_s"] / traffic[kind]["seconds"]
    del served
    torch.cuda.empty_cache()
    out = {
        "config": cfg, "coalesce_max_keys": SERVER_COALESCE_KEYS, "threads": SERVER_THREADS,
        "client_processes": SERVER_CLIENT_PROCS, "request_keys": SERVER_REQUEST,
        "encoding": "keys_fixed, width 16, rows.tobytes()",
        "insert": {"keys": SERVER_KEYS, "requests": len(inserts), **traffic["insert"],
                   "keys_per_s": SERVER_KEYS / traffic["insert"]["seconds"]},
        "query": {"keys": 2 * SERVER_PROBES, "requests": len(queries), **traffic["query"],
                  "keys_per_s": 2 * SERVER_PROBES / traffic["query"]["seconds"]},
        "traffic_s": traffic_s, "clients_ready_s": traffic["clients_ready_s"],
        "flushes": flushes, "flush_wall": flush_wall,
        "rpc_mean_us": {m: h.get("mean_us") for m, h in rpc["latency"].items()},
        "rpc_phase_mean_us": {p: h.get("mean_us") for p, h in rpc["phases"].items()},
        "launches": launches,
        "max_abs_err": {"insert": insert_err, "presence": presence_err, "restored": restored_err,
                        "cuckoo": cf_err, "cms": cms_err},
        "tolerance": 0, "fpr": fpr, "presence_held_present": True,
        # the launches of the InsertBatch(return_presence) flush (2^16 keys
        # on 2^23 rows): the fused kernel from the crossover, else the two
        "presence_flush_kernels": presence_kernels,
        "checkpoint_s": checkpoint_s, "restore_s": restore_s,
        "health": {"backend": health["backend"], "devices": health["devices"]},
        "nvidia_smi": dev["nvidia_smi"],
    }
    emit("server_path", **out, seconds=time.perf_counter() - t_phase)
    return out


# -- the durable planes: the op log, replication under a sync quorum, residency --

DURABLE_DIR = Path(__file__).resolve().parent / ".durable_state"  # git-ignored; removed at the end
DUR_TENANTS, DUR_TENANT_LOG2M, DUR_TENANT_KEYS = 8, 30, 1 << 19  # A: 8 x 128 MiB, under the 256 MiB cap
DUR_CNT_LOG2M, DUR_CNT_KEYS = 28, 1 << 20  # A: the counting tenant, 2^28 4-bit counters (128 MiB)
DUR_MAIN_KEYS = SERVER_KEYS  # B: 128 InsertBatch requests of 2^16 into the main path's filter
DUR_QUORUM_TIMEOUT_MS = 120_000
DUR_RES_TENANTS, DUR_RES_LOG2M, DUR_RES_FILL = 128, 27, 1 << 15  # D: 128 x 16 MiB, 4x the budget
DUR_RES_INSERTS, DUR_RES_QUERIES, DUR_RES_REQUEST = 1 << 22, 1 << 21, 1 << 14
DUR_RES_BUDGET = DUR_RES_WARM = 512 << 20
DUR_ZIPF = 1.1
DUR_KERNELS = ("blocked_insert", "blocked_query", "blocked_counting_update", "payload_crc32c")
# fills cut to keep the phase near 150 s (widths never): the host CRC32C
# of the op log (16 MiB/s on the card's host) sets the phase's time
DUR_CUTS = ["A: each of the 8 tenants filled with 2^19 keys, not 2^20 (the log's host CRC32C)",
            "D: each of the 128 tenants filled with 2^15 keys, not 2^16 (the same)"]


def dur_config(log2m: int, counting: bool = False) -> dict:
    """A CreateFilter config of the main path's shape (k=7, block_bits=512,
    "chunk", 16-byte keys) at m = 2^log2m, a counting one if asked."""
    cfg = {"m": 1 << log2m, "k": K, "block_bits": BLOCK_BITS, "key_len": KEY_LEN,
           "block_hash": "chunk"}
    return {**cfg, "counting": True} if counting else cfg


class Clocks:
    """Host seconds and calls of wrapped functions, by name (a wrapper on
    the replica's applier thread counts under ``replica_<name>``); every
    wrapper comes off again in :meth:`undo`."""

    def __init__(self):
        self.s: dict = {}
        self.n: dict = {}
        self._undo: list = []

    def add(self, name: str, dt: float) -> None:
        self.s[name] = self.s.get(name, 0.0) + dt
        self.n[name] = self.n.get(name, 0) + 1

    def wrap(self, obj, attr: str, name: str, sync: bool = False, size=None) -> None:
        """Time ``obj.attr`` under ``name``; ``sync`` waits for the card
        inside the timed call; ``size(result)`` adds bytes under
        ``<name>_bytes``."""
        import threading

        orig = getattr(obj, attr)

        def timed(*a, **kw):
            side = "replica_" if threading.current_thread().name == "tpubloom-replica" else ""
            t0 = time.perf_counter()
            try:
                res = orig(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                if size is not None:
                    self.s[side + name + "_bytes"] = self.s.get(side + name + "_bytes", 0) + size(res)
                return res
            finally:
                self.add(side + name, time.perf_counter() - t0)

        self._undo.append((obj, attr, orig, attr in vars(obj)))
        setattr(obj, attr, timed)

    def undo(self) -> None:
        for obj, attr, orig, own in reversed(self._undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def take(self) -> dict:
        """The seconds and calls so far, then zero."""
        out = {k: ({"s": v, "calls": self.n[k]} if k in self.n else v) for k, v in sorted(self.s.items())}
        self.s, self.n = {}, {}
        return out


def replica_or_primary() -> str:
    """The durable phase's side of a launch: the replica's when the
    replica's applier thread made it, or when a window names the replica;
    the primary's otherwise."""
    import threading

    return SidedLaunches.window or (
        "replica" if threading.current_thread().name == "tpubloom-replica" else "primary")


class SidedLaunches(dict):
    """A kernel wrapper's launch counter (it stands in for ``sweep.LAUNCHES``
    and ``checksum.LAUNCHES`` in the durable and HA phases) that also
    counts each launch under the side ``side()`` names as it is made
    (:func:`replica_or_primary` unless given)."""

    window = None

    def __init__(self, base: dict, side=None):
        super().__init__(base)
        self.side = side or replica_or_primary
        self.sides: dict = {}

    def __setitem__(self, key, value):
        d = value - self.get(key, 0)
        super().__setitem__(key, value)
        if d > 0:
            side = self.sides.setdefault(self.side(), {})
            side[key] = side.get(key, 0) + d


def crc_clock(clocks: Clocks) -> None:
    """Time each op-log record's CRC32C (on the host) apart from the rest
    of its framing: under ``crc_encode`` in an append, ``crc_decode`` in a
    read of the log (the primary's stream to a replica, a replay), with
    the MiB it covered."""
    import threading

    from tpubloom_torch.repl import record as rec

    mode = threading.local()
    crc = rec.crc32c

    def timed_crc(data, *a):
        m = getattr(mode, "m", "other")
        t0 = time.perf_counter()
        try:
            return crc(data, *a)
        finally:
            clocks.add(f"crc_{m}", time.perf_counter() - t0)
            clocks.s[f"crc_{m}_mib"] = clocks.s.get(f"crc_{m}_mib", 0.0) + len(data) / 2**20

    def framed(fn, m):
        def call(*a, **kw):
            mode.m = m
            try:
                return fn(*a, **kw)
            finally:
                mode.m = "other"
        return call

    for attr, m in (("encode_record", "encode"), ("decode_record", "decode")):
        clocks._undo.append((rec, attr, getattr(rec, attr), True))
        setattr(rec, attr, framed(getattr(rec, attr), m))
    clocks._undo.append((rec, "crc32c", crc, True))
    rec.crc32c = timed_crc


def crash_stop(svc, srv) -> None:
    """Stop a service as a crash leaves its disk: the gRPC server stopped,
    parked requests flushed, checkpointers closed without a final
    checkpoint (a restart then replays the log), the op log closed. Its
    filters stay in memory for the comparison."""
    srv.stop(grace=None)
    svc.begin_drain()
    if svc._coalescer is not None:
        svc._coalescer.close()
    release(svc, keep=True)
    if svc.oplog is not None:
        svc.oplog.close()


def release(svc, keep: bool = False) -> None:
    """Close every checkpointer of a stopped service without a checkpoint,
    and drop its filters unless ``keep``."""
    for mf in list(svc._filters.values()):
        if mf.checkpointer is not None:
            mf.checkpointer.close(final_checkpoint=False)
    if not keep:
        svc._filters.clear()


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def filter_errs(a, b, names) -> dict:
    """``max_abs_err`` of each named filter's words, service ``a`` against
    service ``b`` (both on the card)."""
    errs = {}
    for name in names:
        wa, wb = a._filters[name].filter.words, b._filters[name].filter.words
        check(on_card(wa) and on_card(wb), f"{name} on the card in both")
        errs[name] = max_abs_err(wa, wb)
    return errs


def host_crc() -> dict:
    """The host CRC32C that frames op-log records: which path runs, and
    its rate on 16 MiB."""
    from tpubloom_torch.utils import crc32c as crc_mod

    data = np.random.default_rng(1).integers(0, 256, 16 << 20, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    crc_mod.crc32c(data)
    return {"path": "crc32c wheel" if crc_mod._crc32c_accel is not None else "numpy slicing-by-8",
            "mib_per_s": 16 / (time.perf_counter() - t0)}


def log_share(clk: dict) -> dict:
    """The appends' seconds and the CRC's share of them, from a
    :class:`Clocks` reading."""
    append = clk.get("append", {}).get("s", 0.0)
    enc = clk.get("crc_encode", {}).get("s", 0.0)
    return {"append_s": append, "appends": clk.get("append", {}).get("calls", 0),
            "append_crc_s": enc, "append_crc_mib": clk.get("crc_encode_mib", 0.0),
            "crc_share_of_append": enc / append if append else None,
            "read_crc_s": clk.get("crc_decode", {}).get("s", 0.0),
            "read_crc_mib": clk.get("crc_decode_mib", 0.0)}


def zipf_tenants(rng, n: int, tenants: int) -> np.ndarray:
    """``n`` tenant indices by Zipf(``DUR_ZIPF``) over ``tenants`` (index 0
    the hottest)."""
    p = 1.0 / np.arange(1, tenants + 1) ** DUR_ZIPF
    return rng.choice(tenants, size=n, p=p / p.sum())


def percentiles_ms(xs: list) -> dict:
    if not xs:
        return {"n": 0, "p50_ms": None, "p99_ms": None}
    a = np.asarray(xs) * 1e3
    return {"n": len(xs), "p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99))}


def phase_durable_path(rng, dev: dict) -> dict:
    """The port's durable planes on the card, all in this process
    (``durable_path``; ``--durable`` alone): A, a full resync of 8 tenants
    of m=2^30 and a counting tenant of 2^28 counters to a replica; B, the
    main path's filter (m=2^32) filled with 2^23 keys under
    ``min_replicas=1`` while the stream is killed once; C, a restart that
    replays the log; D, 128 tenants of m=2^27 paged through a 512 MiB
    budget under Zipf(1.1) traffic, then restarted. Every filter is held
    against the primary, the stopped primary or a direct filter fed the
    same keys (tolerance 0)."""
    import threading

    from tpubloom_torch import faults
    from tpubloom_torch.filter import _FilterBase
    from tpubloom_torch.repl import OpLog, ReplicaApplier
    from tpubloom_torch.server import ingest, service
    from tpubloom_torch.server.client import BloomClient

    t_phase = time.perf_counter()
    if DURABLE_DIR.exists():
        shutil.rmtree(DURABLE_DIR)
    DURABLE_DIR.mkdir()
    saved = (sweep.LAUNCHES, checksum.LAUNCHES)
    sided = (SidedLaunches(sweep.LAUNCHES), SidedLaunches(checksum.LAUNCHES))
    sweep.LAUNCHES, checksum.LAUNCHES = sided
    out: dict = {"host_crc": host_crc(), "cuts": DUR_CUTS, "tolerance": 0,
                 "server_path_insert_keys_per_s":
                     RECORD.get("server_path", {}).get("insert", {}).get("keys_per_s")}
    clocks = Clocks()
    pool = ClientPool()
    stopped: list = []  # (service, server) pairs to stop at the end

    def sink_at(d):
        return lambda config: checkpoint.FileSink(str(DURABLE_DIR / d))

    def sides() -> dict:
        return {s: {**sided[0].sides.get(s, {}), **sided[1].sides.get(s, {})}
                for s in ("primary", "replica")}

    def serve(svc):
        srv, port = service.build_server(svc, "127.0.0.1:0")
        srv.start()
        svc.listen_address = f"127.0.0.1:{port}"
        stopped.append((svc, srv))
        return srv, svc.listen_address

    try:
        # -- A: a full resync at tenant scale ------------------------------------
        t_a = time.perf_counter()
        plog = OpLog(str(DURABLE_DIR / "log"))
        psvc = service.BloomService(sink_factory=sink_at("ckpt"), oplog=plog,
                                    coalesce=ingest.CoalesceConfig(max_keys=SERVER_COALESCE_KEYS))
        psrv, paddr = serve(psvc)
        clocks.wrap(plog, "append", "append")
        crc_clock(clocks)
        tenants = [f"t{i}" for i in range(DUR_TENANTS)]
        with BloomClient(paddr) as c:
            for name in tenants:
                c.create_filter(name, config=dur_config(DUR_TENANT_LOG2M))
            c.create_filter("cnt", config=dur_config(DUR_CNT_LOG2M, counting=True))
        keys = {name: rows(rng, DUR_TENANT_KEYS) for name in tenants}
        keys["cnt"] = rows(rng, DUR_CNT_KEYS)
        reqs = [("InsertBatch", name, r[i:i + SERVER_REQUEST], {})
                for name, r in keys.items() for i in range(0, len(r), SERVER_REQUEST)]
        fill = pool.run(paddr, reqs)
        n_fill = sum(len(r) for r in keys.values())
        out["A_fill"] = {"keys": n_fill, "requests": len(reqs), "seconds": fill["seconds"],
                         "keys_per_s": n_fill / fill["seconds"], "clients_ready_s": fill["ready_s"],
                         "records": plog.last_seq, **log_share(clocks.take())}
        # the replica: read-only, its applier on this card, no coalescer
        for obj, attr, name, sync, size in (
                (checkpoint, "snapshot_blob", "snapshot", False, lambda r: len(r[2])),
                (checkpoint, "_serialize", "serialize", False, None),
                (checksum, "payload_crc32c", "payload_crc32c", False, None),
                (checkpoint, "_frame", "frame", False, None),
                (checksum, "bytes_crc32c", "bytes_crc32c", False, None),
                (checkpoint, "payload_to_words", "payload_to_words", False, None),
                (_FilterBase, "_set_words", "set_words", True, None)):
            clocks.wrap(obj, attr, name, sync=sync, size=size)
        rsvc = service.BloomService(read_only=True)
        rsrv, raddr = serve(rsvc)
        clocks.wrap(rsvc, "install_snapshot", "install", sync=True)
        t0 = time.perf_counter()
        applier = ReplicaApplier(rsvc, paddr, reconnect_base=0.05, listen_address=raddr).start()
        check(applier.wait_for_seq(plog.last_seq, 600), f"the replica caught up: {applier.status()}")
        resync_s = time.perf_counter() - t0
        check(applier.full_syncs == 1, "one full resync")
        clk = clocks.take()
        snap_s = clk.get("snapshot", {}).get("s", 0.0)
        install_s = clk.get("replica_install", {}).get("s", 0.0)
        tail_crc = clk.get("crc_decode", {}).get("s", 0.0)
        crc_p = clk.get("payload_crc32c", {}).get("s", 0.0)
        frame_s = clk.get("frame", {}).get("s", 0.0)
        out["A_resync"] = {
            "seconds": resync_s, "blobs": clk.get("snapshot", {}).get("calls", 0),
            "bytes": clk.get("snapshot_bytes", 0),
            "primary_snapshot_s": snap_s,
            "primary_copy_and_payload_crc32c_s": crc_p,
            "primary_d2h_s": clk.get("serialize", {}).get("s", 0.0) - crc_p - frame_s,
            "primary_frame_s": frame_s,
            "replica_install_s": install_s,
            "replica_bytes_crc32c_s": clk.get("replica_bytes_crc32c", {}).get("s", 0.0),
            "replica_payload_to_words_s": clk.get("replica_payload_to_words", {}).get("s", 0.0),
            "replica_set_words_s": clk.get("replica_set_words", {}).get("s", 0.0),
            "primary_tail_read_crc_s": tail_crc,
            "primary_tail_read_mib": clk.get("crc_decode_mib", 0.0),
            "transfer_and_overlap_s": resync_s - snap_s - install_s - tail_crc,
            "gbytes_per_s": clk.get("snapshot_bytes", 0) / resync_s / 1e9,
            "host_clock": clk,
        }
        errs = filter_errs(psvc, rsvc, [*tenants, "cnt"])
        check(max(errs.values()) == 0, f"replica words equal the primary's after the resync: {errs}")
        out["A_resync"]["max_abs_err"] = errs
        out["A_seconds"] = time.perf_counter() - t_a
        emit("durable_path_A", **{k: out[k] for k in ("host_crc", "A_fill", "A_resync", "A_seconds")})

        # -- B: the log's tail at full width, under a sync quorum -------------------
        t_b = time.perf_counter()
        with BloomClient(paddr) as c:
            c.create_filter("main", config=dur_config(LOG2M))
        main_keys = rows(rng, DUR_MAIN_KEYS)
        quorum = {"min_replicas": 1, "min_replicas_timeout_ms": DUR_QUORUM_TIMEOUT_MS}
        reqs = [("InsertBatch", "main", main_keys[i:i + SERVER_REQUEST], quorum)
                for i in range(0, DUR_MAIN_KEYS, SERVER_REQUEST)]
        seq0, partial0 = plog.last_seq, applier.partial_syncs
        lag, stop = [], threading.Event()

        def watch():
            while not stop.is_set():
                lag.append(plog.last_seq - (applier.cursor or 0))
                time.sleep(0.01)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        # the stream dies at the first record it sends after this: the
        # traffic's first flush (heartbeats do not fire the point)
        faults.arm("repl.stream_send", "once")
        tail = pool.run(paddr, reqs)
        stop.set()
        watcher.join()
        faults.reset()
        cnt_more = rows(rng, SERVER_REQUEST)
        keys["cnt"] = np.concatenate([keys["cnt"], cnt_more])
        with BloomClient(paddr) as c:
            r = c._rpc("InsertBatch", {"name": "cnt", "keys_fixed": {
                "data": cnt_more.tobytes(), "width": KEY_LEN, "n": len(cnt_more)}, **quorum})
            check(r.get("acked_replicas") == 1, "the cnt batch acked by the replica")
        check(applier.wait_for_seq(plog.last_seq, 600), f"the replica caught up: {applier.status()}")
        torch.cuda.synchronize()
        clk = clocks.take()
        partials = applier.partial_syncs - partial0
        check(partials >= 1, "at least one partial resync after the stream was killed")
        check(applier.full_syncs == 1, "no second full resync")
        out["B_tail"] = {
            "keys": DUR_MAIN_KEYS, "requests": len(reqs), "seconds": tail["seconds"],
            "keys_per_s": DUR_MAIN_KEYS / tail["seconds"], "records": plog.last_seq - seq0,
            "replica_lag_records": {"max": int(max(lag)) if lag else 0,
                                    "mean": float(np.mean(lag)) if lag else 0.0},
            "partial_resyncs": partials, "quorum": quorum,
            "quorum_redrives": tail["quorum_redrives"], **log_share(clk), "host_clock": clk,
        }
        # held and fresh keys of main, queried at the replica, then at the primary
        held = main_keys[rng.choice(DUR_MAIN_KEYS, SERVER_PROBES, replace=False)]
        fresh = rows(rng, SERVER_PROBES)
        probes = [("QueryBatch", "main", r[i:i + SERVER_REQUEST], {})
                  for r in (held, fresh) for i in range(0, SERVER_PROBES, SERVER_REQUEST)]
        verdicts = {}
        for side, addr in (("replica", raddr), ("primary", paddr)):
            SidedLaunches.window = side
            try:
                q = pool.run(addr, probes)
            finally:
                SidedLaunches.window = None
            verdicts[side] = np.concatenate(q["out"])
            out["B_tail"][f"{side}_query_keys_per_s"] = 2 * SERVER_PROBES / q["seconds"]
        errs = filter_errs(psvc, rsvc, [*tenants, "cnt", "main"])
        check(max(errs.values()) == 0, f"replica words equal the primary's: {errs}")
        direct = BlockedBloomFilter(FilterConfig(key_name="main", **dur_config(LOG2M)))
        direct.insert_packed(main_keys)
        errs["main_vs_direct"] = max_abs_err(psvc._filters["main"].filter.words, direct.words)
        check(errs["main_vs_direct"] == 0, "main equals a filter fed the same keys directly")
        want = np.concatenate([np.ones(SERVER_PROBES, bool), direct.include_packed(fresh)])
        check(np.array_equal(verdicts["replica"], want) and np.array_equal(verdicts["primary"], want),
              "the replica's and the primary's verdicts equal the direct filter's")
        del direct
        out["B_tail"]["max_abs_err"] = errs
        out["B_seconds"] = time.perf_counter() - t_b
        out["launches_A_B"] = sides()
        emit("durable_path_B", **{k: out[k] for k in ("B_tail", "B_seconds", "launches_A_B")})
        for side in ("primary", "replica"):
            for name in DUR_KERNELS:
                check(out["launches_A_B"][side].get(name, 0) > 0, f"{name} launched on the {side}'s side")

        # -- C: a restart from the log -------------------------------------------------
        t_c = time.perf_counter()
        applier.stop()
        rsrv.stop(grace=None)
        release(rsvc)
        crash_stop(psvc, psrv)
        clocks.take()
        t0 = time.perf_counter()
        clog = OpLog(str(DURABLE_DIR / "log"))  # its recovery scan reads every record
        open_s = time.perf_counter() - t0
        open_clk = clocks.take()
        csvc = service.BloomService(sink_factory=sink_at("ckpt"), oplog=clog)
        stopped.append((csvc, None))
        before = {**sided[0], **sided[1]}
        t0 = time.perf_counter()
        stats = csvc.replay_oplog()
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        clk = clocks.take()
        check(stats["failed"] == 0, f"replay failed records: {stats}")
        errs = filter_errs(psvc, csvc, [*tenants, "cnt", "main"])
        check(max(errs.values()) == 0, f"replayed words equal the stopped primary's: {errs}")
        n_rec = stats["applied"] + stats["skipped"]
        out["C_replay"] = {"log_open_s": open_s,
                           "log_open_read_crc_s": open_clk.get("crc_decode", {}).get("s", 0.0),
                           "recover_s": open_s + replay_s,
                           "seconds": replay_s, "records": n_rec, "records_per_s": n_rec / replay_s,
                           "stats": stats, "log_mib": clk.get("crc_decode_mib", 0.0),
                           "read_crc_s": clk.get("crc_decode", {}).get("s", 0.0),
                           "launches": {k: v - before.get(k, 0) for k, v in {**sided[0], **sided[1]}.items()
                                        if v - before.get(k, 0)},
                           "max_abs_err": errs}
        release(csvc)
        release(psvc)
        clog.close()
        del applier, rsvc, psvc, csvc
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        out["C_seconds"] = time.perf_counter() - t_c
        emit("durable_path_C", **{k: out[k] for k in ("C_replay", "C_seconds")})

        # -- D: residency ------------------------------------------------------------------
        t_d = time.perf_counter()
        out["D_residency"] = phase_residency(rng, pool, clocks, serve, sink_at)
        out["D_seconds"] = time.perf_counter() - t_d
    finally:
        clocks.undo()
        faults.reset()
        SidedLaunches.window = None
        sweep.LAUNCHES, checksum.LAUNCHES = saved
        for d, s in zip(saved, sided):
            d.update(s)
        pool.close()
        for svc, srv in stopped:
            if srv is not None:
                srv.stop(grace=None)
            if svc.replica_applier is not None:
                svc.replica_applier.stop()
            release(svc)
            if svc._coalescer is not None:
                svc._coalescer.close()
            if svc.oplog is not None:
                svc.oplog.close()
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("durable_path", **out, nvidia_smi=dev["nvidia_smi"], seconds=time.perf_counter() - t_phase)
    return out


class PeakWatch:
    """What the card held when its peak ``memory_allocated`` rose: each
    watched call reads ``max_memory_allocated`` as it ends, and a new high
    is filed with the calls in flight at that moment (the ending one
    included), the store's resident bytes, the bytes its hydrations have
    reserved, and how many hydrate. Resetting the peak and reading it over
    a span is how the span's peak is found; this says whose work it was."""

    def __init__(self, base: int, store):
        import threading

        self.base, self.store = base, store
        self.lock = threading.Lock()
        self.inflight: dict = {}
        self.high: dict = {"bytes": 0}

    def wrap(self, obj, attr: str, name: str, undo: list) -> None:
        fn = getattr(obj, attr)

        def call(*a, **kw):
            with self.lock:
                self.inflight[name] = self.inflight.get(name, 0) + 1
            try:
                return fn(*a, **kw)
            finally:
                peak = torch.cuda.max_memory_allocated() - self.base
                with self.lock:
                    if peak > self.high["bytes"]:
                        st = self.store
                        self.high = {
                            "bytes": peak, "ended": name,
                            "in_flight": {k: v for k, v in self.inflight.items() if v},
                            "resident_bytes": st._resident_bytes,
                            "reserved_bytes": sum(e.reserved for e in list(st._entries.values())),
                            "hydrating": st._hydrating}
                    self.inflight[name] -= 1

        undo.append((obj, attr, fn, attr in vars(obj)))
        setattr(obj, attr, call)


def phase_residency(rng, pool, clocks, serve, sink_at) -> dict:
    """D of :func:`phase_durable_path`: ``DUR_RES_TENANTS`` tenants of
    m=2^27 with a 512 MiB budget and a 512 MiB warm pool, an op log and a
    sink; traffic by Zipf(1.1) over the tenants; every tenant and verdict
    against a direct filter fed its keys; ``memory_allocated`` sampled
    after every eviction, and the peak over the traffic and over the
    restart, each with the work in flight when it rose
    (:class:`PeakWatch`: evictions, hydrations, their snapshots and
    restores, the coalescer's flushes); then a restart over the same
    directories."""
    from tpubloom_torch.repl import OpLog
    from tpubloom_torch.server import ingest, service
    from tpubloom_torch.server.client import BloomClient
    from tpubloom_torch.storage import StorageConfig

    import gc

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tenant_bytes = (1 << DUR_RES_LOG2M) // 8
    staging = 2 * SERVER_COALESCE_KEYS * (KEY_LEN + 4 + 1)
    bound = DUR_RES_BUDGET + 2 * tenant_bytes + staging
    storage = dict(max_resident_bytes=DUR_RES_BUDGET, warm_pool_bytes=DUR_RES_WARM)
    dlog = OpLog(str(DURABLE_DIR / "dlog"))
    dsvc = service.BloomService(sink_factory=sink_at("dckpt"), oplog=dlog,
                                storage=StorageConfig(**storage),
                                coalesce=ingest.CoalesceConfig(max_keys=SERVER_COALESCE_KEYS))
    dsrv, daddr = serve(dsvc)
    store = dsvc.storage
    samples, detail, evict_s, hyd = [], [], [], {"warm": [], "cold": []}
    evict, hydrate = store._evict, store._hydrate

    def sampled_evict(name):
        t0 = time.perf_counter()
        evict(name)
        evict_s.append(time.perf_counter() - t0)
        evicting = sum(1 for e in list(store._entries.values()) if e.state == "evicting")
        samples.append(torch.cuda.memory_allocated() - base)
        detail.append((samples[-1], store._resident_bytes, store._hydrating, evicting))

    def timed_hydrate(name):
        e = store._entries.get(name)
        tier = "warm" if e is not None and e.blob is not None else "cold"
        t0 = time.perf_counter()
        try:
            return hydrate(name)
        finally:
            hyd[tier].append(time.perf_counter() - t0)

    store._evict, store._hydrate = sampled_evict, timed_hydrate
    watch, undo = PeakWatch(base, store), clocks._undo
    for obj, attr, name in ((store, "_evict", "evict"), (store, "_hydrate", "hydrate"),
                            (checkpoint, "snapshot_blob", "snapshot"),
                            (dsvc, "_managed_from_blob", "restore"),
                            (dsvc._coalescer, "_flush_inner", "flush")):
        watch.wrap(obj, attr, name, undo)
    names = [f"r{i:03d}" for i in range(DUR_RES_TENANTS)]
    cfg = dur_config(DUR_RES_LOG2M)
    t0 = time.perf_counter()
    with BloomClient(daddr) as c:
        for name in names:
            c.create_filter(name, config=cfg)
    create_s = time.perf_counter() - t0
    held = {name: rows(rng, DUR_RES_FILL) for name in names}
    keys = {name: [held[name]] for name in names}
    fill = pool.run(daddr, [("InsertBatch", n, held[n], {}) for n in names])
    who = zipf_tenants(rng, DUR_RES_INSERTS // DUR_RES_REQUEST, DUR_RES_TENANTS)
    inserts = []
    for t in who:
        r = rows(rng, DUR_RES_REQUEST)
        keys[names[t]].append(r)
        inserts.append(("InsertBatch", names[t], r, {}))
    qwho = zipf_tenants(rng, DUR_RES_QUERIES // DUR_RES_REQUEST, DUR_RES_TENANTS)
    half = DUR_RES_REQUEST // 2
    queries = [("QueryBatch", names[t],
                np.concatenate([held[names[t]][rng.choice(DUR_RES_FILL, half, replace=False)],
                                rows(rng, half)]), {}) for t in qwho]
    n0 = (len(samples), len(hyd["warm"]), len(hyd["cold"]))
    ins = pool.run(daddr, inserts)
    qry = pool.run(daddr, queries)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with watch.lock:
        rose = dict(watch.high)  # the traffic's; the restart below resets the peak
    clk = clocks.take()
    summary = store.summary()
    # every tenant and every verdict against a direct filter fed its keys
    direct, errs = {}, {}
    for name in names:
        f = BlockedBloomFilter(FilterConfig(key_name=name, **cfg))
        f.insert_packed(np.concatenate(keys[name]))
        direct[name] = f
    for (_, name, r, _), got in zip(queries, qry["out"]):
        check(got[:half].all(), f"{name}: held keys hit")
        check(np.array_equal(got, direct[name].include_packed(r)), f"{name}: verdicts equal the direct filter's")

    def tenant_errs(svc) -> dict:
        out = {}
        for name in names:
            blob, _ = svc.storage.peek_blob(name)
            f = checkpoint.restore_blob(blob)
            out[name] = max_abs_err(f.words, direct[name].words)
            del f
        return out

    errs["served"] = max(tenant_errs(dsvc).values())
    check(errs["served"] == 0, "every tenant equals its direct filter")
    worst = detail[int(np.argmax(samples))]
    check(max(samples) <= bound, f"memory_allocated after an eviction {max(samples)} over {bound}: "
          f"(allocated, resident bytes, hydrating, evicting) {worst}")
    # a restart over the same directories
    dsrv.stop(grace=None)
    dsvc.shutdown()
    dlog.close()
    t0 = time.perf_counter()
    d2log = OpLog(str(DURABLE_DIR / "dlog"))
    open_s = time.perf_counter() - t0
    d2svc = service.BloomService(sink_factory=sink_at("dckpt"), oplog=d2log,
                                 storage=StorageConfig(**storage))
    serve(d2svc)
    gc.collect()
    torch.cuda.synchronize()
    restart_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = d2svc.replay_oplog()
    restart_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    restart_peak = torch.cuda.max_memory_allocated() - restart_base
    check(sorted(d2svc.storage.names()) == names, "every tenant came back")
    errs["restarted"] = max(tenant_errs(d2svc).values())
    check(errs["restarted"] == 0, "every restarted tenant equals its direct filter")
    del direct
    return {
        "tenants": DUR_RES_TENANTS, "tenant_bytes": tenant_bytes, "budget_bytes": DUR_RES_BUDGET,
        "warm_pool_bytes": DUR_RES_WARM, "create_s": create_s,
        "fill": {"keys": DUR_RES_TENANTS * DUR_RES_FILL, "seconds": fill["seconds"], "sheds": fill["sheds"]},
        "insert": {"keys": DUR_RES_INSERTS, "requests": len(inserts), "seconds": ins["seconds"],
                   "keys_per_s": DUR_RES_INSERTS / ins["seconds"], "sheds": ins["sheds"]},
        "query": {"keys": DUR_RES_QUERIES, "requests": len(queries), "seconds": qry["seconds"],
                  "keys_per_s": DUR_RES_QUERIES / qry["seconds"], "sheds": qry["sheds"]},
        "evictions": len(samples), "evictions_in_traffic": len(samples) - n0[0],
        "hydrations": {tier: percentiles_ms(v) for tier, v in hyd.items()},
        "hydrations_in_traffic": {"warm": len(hyd["warm"]) - n0[1], "cold": len(hyd["cold"]) - n0[2]},
        "memory_allocated_after_eviction": {
            "max": max(samples), "bound": bound, "baseline": base, "staging_bound": staging,
            "at_max": dict(zip(("allocated", "resident_bytes", "hydrating", "evicting"), worst))},
        "max_memory_allocated": peak, "peak_over_bound": peak - bound,
        "peak_rose_during": rose, "summary": summary,
        "restart": {"log_open_s": open_s, "seconds": restart_s, "stats": stats,
                    "max_memory_allocated": restart_peak},
        "evict_ms": percentiles_ms(evict_s), "max_abs_err": errs,
        **log_share(clk),
    }


HA_DIR = Path(__file__).resolve().parent / ".ha_state"  # git-ignored; removed at the end
HA_KEYS = SERVER_KEYS  # 128 InsertBatch requests of 2^16 into the main path's filter "chunk"
HA_CNT_LOG2M, HA_CNT_BATCH, HA_CNT_EVERY = 28, 1 << 12, 4  # a cnt batch after every 4th chunk request
HA_CRASH_AFTER = 64  # acknowledged chunk requests before the primary crashes: half of them
HA_SENTINEL = {"poll_s": 0.25, "down_after_s": 1.5}  # the sentinel CLI's defaults; quorum 2 of 3
HA_REDRIVE_S = 300.0  # how long a client re-drives one request before it gives up
HA_KERNELS = ("blocked_insert", "blocked_query", "blocked_counting_update")
# cuts of the key count that keep the phase near 90 s (the filter's m never)
HA_CUTS: list = []
NODE = None  # the thread-local node label HA launches are counted under (set in phase_ha_path)


def ha_client(p: int, jobs, barrier, results, sentinels, acked) -> None:
    """Client process ``p`` of the HA path (:func:`client_parts`), with
    ``BloomClient(sentinels=...)`` clients, or clients of one address when
    a part names one. A request that fails (the primary gone, a replica's
    READONLY, a stale view) is re-driven with its own rid after
    ``refresh_topology``, for up to ``HA_REDRIVE_S``; each acknowledged
    "chunk" insert adds one to the shared ``acked``. A request is
    ``(method, name, rows, rid or None)``; its output is ``(host clock at
    the ack, the address that acked it, re-drives, the first error codes,
    verdicts or None)``."""
    import grpc

    from tpubloom_torch.server.client import BloomClient
    from tpubloom_torch.server.protocol import BloomServiceError

    def connect(addr):
        return BloomClient(addr) if addr else BloomClient(sentinels=sentinels, max_retries=0)

    def call(cl, job, tally, rid):
        method, name, r, own_rid = job
        req = {"name": name, "keys_fixed": {"data": r.tobytes(), "width": r.shape[1], "n": len(r)},
               "rid": own_rid or f"ha-{rid}"}
        redrives, codes, deadline = 0, [], time.monotonic() + HA_REDRIVE_S
        while True:
            addr = cl.address
            try:
                resp = cl._call_once(method, req, timeout=600)
                break
            except BloomServiceError as e:
                if e.code == "RESOURCE_EXHAUSTED":
                    tally[0] += 1
                    time.sleep(float(e.details.get("retry_after_ms") or 50) / 1e3)
                    continue
                code = e.code
            except grpc.RpcError as e:
                code = str(e.code())
            check(time.monotonic() < deadline, f"{method} {req['rid']} acknowledged: {codes[-3:]}")
            redrives += 1
            codes.append(code)
            time.sleep(0.05)
            try:
                cl.refresh_topology()
            except Exception:  # noqa: BLE001 — no sentinel answered: try again
                pass
        t_ack = time.monotonic()
        tally[1] += redrives
        if method == "InsertBatch" and name == "chunk":
            with acked.get_lock():
                acked.value += 1
        hits = BloomClient._unpack_bool(resp, "hits") if method == "QueryBatch" else None
        check(resp["n"] == len(r), f"{method} count")
        return t_ack, addr, redrives, codes[:4], hits

    client_parts(p, jobs, barrier, results, connect, call)


def tag_node(svc, label: str, undo: list, attrs=("apply_record", "install_snapshot"),
             busy=None) -> None:
    """Count the launches of ``svc``'s ``attrs`` (by default its record
    applies and snapshot installs) and coalescer flushes under ``label``
    (the thread-local ``NODE``'s name while they run: nodes in one
    process share thread names), adding each flush's wall seconds to
    ``busy[label]`` when ``busy`` is given. RPC handlers among ``attrs``
    are bound by ``build_server``, so tag before it."""
    def tagged(fn, timed):
        def call(*a, **kw):
            prev = getattr(NODE, "name", None)
            NODE.name = label
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                NODE.name = prev
                if timed:
                    busy[label] = busy.get(label, 0.0) + time.perf_counter() - t0
        return call

    targets = [(svc, attr, False) for attr in attrs]
    if svc._coalescer is not None:
        targets.append((svc._coalescer, "_flush_inner", busy is not None))
    for obj, attr, timed in targets:
        undo.append((obj, attr, getattr(obj, attr), attr in vars(obj)))
        setattr(obj, attr, tagged(getattr(obj, attr), timed))


def phase_ha_path(rng, dev: dict) -> dict:
    """High availability on the card (``ha_path``; ``--ha`` alone), in
    this process with the client processes of the server path's design:
    a primary with an op log, a FileSink and the coalescer, two chained
    replicas and three sentinels at the CLI's defaults; the main path's
    filter "chunk" (m=2^32) and a counting tenant ``cnt`` (2^28 counters)
    created with the replicas attached; 2^23 keys as 128 ``InsertBatch``
    requests of 2^16 with ``cnt`` batches between them, the primary
    crashed after 64 acknowledged ones. Times from the crash to SDOWN,
    ODOWN, ``Promote`` answered and the first write the new primary
    acknowledged; the ``Promote`` RPC's own ms; the pick and the cursors;
    the survivor's resync; the new primary's keys/s; the re-drives; the
    launches by node. Held with tolerance 0: exactly once (every ``cnt``
    batch re-driven with its rid, then one delete a batch leaves every
    counter 0), the words ("chunk" equals a filter fed every key, the
    survivor's the new primary's) and fencing (the crashed primary,
    restarted from its log, demoted at the new epoch, its writes
    READONLY; its resync's kind, and the 256 MiB message cap's refusal of
    "chunk" if it is a full one)."""
    global NODE
    import gc
    import logging
    import multiprocessing
    import threading

    from tpubloom_torch.ha import promotion
    from tpubloom_torch.ha.sentinel import Sentinel
    from tpubloom_torch.repl import OpLog, ReplicaApplier
    from tpubloom_torch.server import ingest, protocol, service
    from tpubloom_torch.server.client import BloomClient, fetch_topology

    t_phase = time.perf_counter()
    if HA_DIR.exists():
        shutil.rmtree(HA_DIR)
    HA_DIR.mkdir()
    NODE = threading.local()
    saved = sweep.LAUNCHES
    sided = sweep.LAUNCHES = SidedLaunches(sweep.LAUNCHES, lambda: getattr(NODE, "name", None) or "other")
    wraps = Clocks()  # for its undo of every wrapper below
    undo = wraps._undo
    nodes: dict = {}  # label -> (service, server or None)
    sents: list = []
    pool = None
    marks: dict = {"promote_rpc": [], "replicaof_rpc": [], "promote_handler_s": [], "cursors": {}}
    stop = threading.Event()
    coalesce = ingest.CoalesceConfig(max_keys=SERVER_COALESCE_KEYS)
    out: dict = {"cuts": HA_CUTS, "tolerance": 0, "sentinels": {**HA_SENTINEL, "quorum": 2, "n": 3},
                 "keys": HA_KEYS, "crash_after_acked": HA_CRASH_AFTER}
    refusals: list = []

    class Capture(logging.Handler):
        def emit(self, record):
            refusals.append((record.thread, record.getMessage()))

    capture = Capture(level=logging.WARNING)
    repl_log = logging.getLogger("tpubloom.repl")
    repl_log.addHandler(capture)

    def serve(label, svc, address="127.0.0.1:0"):
        srv, port = service.build_server(svc, address)
        srv.start()
        svc.listen_address = f"127.0.0.1:{port}"
        nodes[label] = (svc, srv)
        tag_node(svc, label, undo)
        return svc.listen_address

    def sink(d):
        return lambda config: checkpoint.FileSink(str(HA_DIR / d))

    try:
        # -- set-up: the primary, two chained replicas, three sentinels ----------------
        plog = OpLog(str(HA_DIR / "plog"))
        psvc = service.BloomService(sink_factory=sink("pckpt"), oplog=plog, coalesce=coalesce)
        paddr = serve("P", psvc)
        for label in ("R1", "R2"):
            rsvc = service.BloomService(oplog=OpLog(str(HA_DIR / f"{label}log")), read_only=True,
                                        coalesce=coalesce)
            raddr = serve(label, rsvc)
            ReplicaApplier(rsvc, paddr, listen_address=raddr).start()
        label_of = {svc.listen_address: label for label, (svc, _) in nodes.items()}
        sents = [Sentinel(paddr, peers=[], **HA_SENTINEL) for _ in range(3)]
        for s in sents:
            s.peers.extend(x.address for x in sents if x is not s)
            s.quorum = 2

            def do_failover(epoch, old, rid=None, _f=s._do_failover, _s=s):
                marks.setdefault("odown", time.monotonic())
                marks.setdefault("leader", _s.sentinel_id)
                return _f(epoch, old, rid=rid)

            def node_rpc(addr, method, req, timeout=None, _f=s._node):
                t0 = time.monotonic()
                ok = False
                try:
                    resp = _f(addr, method, req, timeout=timeout)
                    ok = bool(resp.get("ok", True))
                    return resp
                finally:
                    if method == "Health" and addr == paddr and "crash" in marks:
                        marks.setdefault("old_address_health", []).append((t0, time.monotonic(), ok))
                    if method in ("Promote", "ReplicaOf"):
                        marks[f"{method.lower()}_rpc"].append(
                            {"node": label_of.get(addr, addr), "t0": t0, "t1": time.monotonic(),
                             "ok": ok, "req": req})

            def cursor(addr, _f=s._replica_cursor):
                c = _f(addr)
                marks["cursors"][label_of.get(addr, addr)] = c
                return c

            s._do_failover, s._node, s._replica_cursor = do_failover, node_rpc, cursor
        for s in sents:
            s.start()
        sent_addrs = [s.address for s in sents]
        deadline = time.monotonic() + 60
        while not all(len(s.topology.replicas) == 2 for s in sents):
            check(time.monotonic() < deadline, "the sentinels discovered both replicas")
            time.sleep(0.05)
        orig_promote = promotion.promote_to_primary

        def timed_promote(svc, **kw):
            t0 = time.perf_counter()
            try:
                return orig_promote(svc, **kw)
            finally:
                marks["promote_handler_s"].append(time.perf_counter() - t0)

        undo.append((promotion, "promote_to_primary", orig_promote, True))
        promotion.promote_to_primary = timed_promote
        with BloomClient(paddr) as c:  # cnt first: a full resync sends its blob before chunk's
            c.create_filter("cnt", config=dur_config(HA_CNT_LOG2M, counting=True))
            c.create_filter("chunk", config=dur_config(LOG2M))
        for label in ("R1", "R2"):
            app = nodes[label][0].replica_applier
            check(app.wait_for_seq(plog.last_seq, 120), f"{label} has both creates: {app.status()}")

        # -- the traffic, and the crash after HA_CRASH_AFTER acknowledged requests ------
        chunk_keys = rows(rng, HA_KEYS)
        reqs, cnt_batches = [], []
        for j, i in enumerate(range(0, HA_KEYS, SERVER_REQUEST)):
            reqs.append(("InsertBatch", "chunk", chunk_keys[i:i + SERVER_REQUEST], f"ha-chunk-{j}"))
            if j % HA_CNT_EVERY == HA_CNT_EVERY - 1:
                cnt_batches.append((rows(rng, HA_CNT_BATCH), f"ha-cnt-{len(cnt_batches)}"))
                reqs.append(("InsertBatch", "cnt", *cnt_batches[-1]))
        ctx = multiprocessing.get_context("spawn")
        acked = ctx.Value("i", 0)
        pool = ClientPool(ha_client, (sent_addrs, acked))

        def crash_at():
            while acked.value < HA_CRASH_AFTER and not stop.is_set():
                time.sleep(0.001)
            if stop.is_set():
                return
            marks["crash"] = time.monotonic()
            marks["acked_at_crash"] = acked.value
            crash_stop(psvc, nodes["P"][1])
            marks["crash_stop_s"] = time.monotonic() - marks["crash"]

        def watch_sentinels():
            while not stop.is_set() and "sdown" not in marks:
                if "crash" in marks and any(s._sdown for s in sents):
                    marks["sdown"] = time.monotonic()
                time.sleep(0.002)

        watchers = [threading.Thread(target=crash_at, daemon=True),
                    threading.Thread(target=watch_sentinels, daemon=True)]
        for th in watchers:
            th.start()
        run = pool.run(None, reqs)
        stop.set()
        for th in watchers:
            th.join(timeout=30)
        check("crash" in marks, "the primary crashed under load")
        check(marks.get("odown", marks["crash"]) >= marks["crash"], "no failover before the crash")
        topo = fetch_topology(sent_addrs)
        check(topo is not None and topo["primary"] in (nodes["R1"][0].listen_address,
                                                       nodes["R2"][0].listen_address),
              f"a replica is the primary: {topo}")
        win = label_of[topo["primary"]]
        lose = "R2" if win == "R1" else "R1"
        wsvc, ssvc = nodes[win][0], nodes[lose][0]
        waddr = wsvc.listen_address
        check(not wsvc.read_only and wsvc.epoch == topo["epoch"], "the winner serves writes at the epoch")
        t_crash = marks["crash"]
        promoted = [r for r in marks["promote_rpc"] if r["ok"]]
        check(len(promoted) == 1 and promoted[0]["node"] == win, f"one Promote answered: {promoted}")
        results = run["out"]
        at_winner = [(o[0], req) for o, req in zip(results, reqs) if o[1] == waddr]
        at_old = [(o[0], req) for o, req in zip(results, reqs) if o[1] == paddr]
        check(at_winner, "the new primary acknowledged writes")
        first_new = min(t for t, _ in at_winner)
        last_new = max(t for t, _ in at_winner)
        new_keys = sum(len(req[2]) for _, req in at_winner)
        redriven = [(req[1], o[3]) for o, req in zip(results, reqs) if o[2]]
        out["traffic"] = {
            "requests": len(reqs), "chunk_requests": HA_KEYS // SERVER_REQUEST,
            "cnt_batches": len(cnt_batches), "seconds": run["seconds"],
            "clients_ready_s": run["ready_s"], "acked_by_old_primary": len(at_old),
            "acked_by_new_primary": len(at_winner), "acked_at_crash": marks["acked_at_crash"],
            "requests_redriven": len(redriven), "redrives": run["quorum_redrives"],
            "redrive_codes": sorted({c for _, cs in redriven for c in cs}),
            "new_primary_keys": new_keys,
            "new_primary_keys_per_s": new_keys / max(last_new - promoted[0]["t1"], 1e-9),
        }
        out["failover"] = {
            "crash_stop_s": marks["crash_stop_s"],
            "crash_to_sdown_s": marks["sdown"] - t_crash,
            "crash_to_odown_s": marks["odown"] - t_crash,
            "crash_to_promote_answered_s": promoted[0]["t1"] - t_crash,
            "crash_to_first_new_ack_s": first_new - t_crash,
            "promote_rpc_ms": (promoted[0]["t1"] - promoted[0]["t0"]) * 1e3,
            "promote_handler_ms": [x * 1e3 for x in marks["promote_handler_s"]],
            "epoch": topo["epoch"], "winner": win, "cursors": marks["cursors"],
            "old_primary_log_head": plog.last_seq,
            "winner_adopted_seq": wsvc.oplog.alias_upto,
            "records_only_the_old_primary_logged": plog.last_seq - (wsvc.oplog.alias_upto or 0),
            "failovers": sum(s.failovers for s in sents),
        }
        check(out["failover"]["failovers"] == 1, "one failover")
        emit("ha_path_failover", **{k: out[k] for k in ("traffic", "failover")})
        release(psvc)  # the crashed primary is abandoned
        nodes["P"] = (psvc, None)
        gc.collect()

        # -- exactly once, and the words --------------------------------------------
        deadline = time.monotonic() + 60
        while ssvc.replica_applier is None or ssvc.replica_applier.primary_address != waddr:
            check(time.monotonic() < deadline, "the survivor was re-pointed at the new primary")
            time.sleep(0.01)
        surv = ssvc.replica_applier
        check(surv.wait_for_seq(wsvc.oplog.last_seq, 300), f"the survivor caught up: {surv.status()}")
        repoint = [r for r in marks["replicaof_rpc"] if r["node"] == lose and r["ok"]]
        out["survivor"] = {"node": lose, "kind": surv.last_sync_kind, "partial_syncs": surv.partial_syncs,
                           "full_syncs": surv.full_syncs, "records_applied": surv.records_applied,
                           "records_skipped": surv.records_skipped,
                           "repointed_after_crash_s": repoint[0]["t1"] - t_crash if repoint else None}
        check(surv.full_syncs == 0 and surv.partial_syncs >= 1,
              f"the survivor resumed by a partial resync: {surv.status()}")
        # every cnt batch re-driven with its own rid at the new primary, and each
        # chunk request the old primary acknowledged that the new one lacks (not
        # every key held: absent keys cannot all be false positives)
        wchunk = wsvc._filters["chunk"].filter
        lacked = [req for _, req in at_old
                  if req[1] == "chunk" and not np.asarray(wchunk.include_packed(req[2])).all()]
        again = pool.run(None, [r for r in reqs if r[1] == "cnt"] + lacked)
        out["redrive_after"] = {"requests": len(again["out"]), "seconds": again["seconds"],
                                "chunk_requests_the_new_primary_lacked": len(lacked),
                                "all_at_new_primary": all(o[1] == waddr for o in again["out"])}
        check(out["redrive_after"]["all_at_new_primary"], "the re-drives reached the new primary")
        wcnt = wsvc._filters["cnt"].filter
        all_cnt = np.concatenate([b for b, _ in cnt_batches])
        present = wcnt.include_packed(all_cnt)
        errs = {"cnt_missing": int((~np.asarray(present)).sum())}
        with BloomClient(waddr) as c:
            for b, rid in cnt_batches:
                c._call_once("DeleteBatch", {"name": "cnt", "rid": rid + "-delete", "keys_fixed": {
                    "data": b.tobytes(), "width": KEY_LEN, "n": len(b)}})
        torch.cuda.synchronize()
        errs["cnt_nonzero_after_deletes"] = int(torch.count_nonzero(wcnt.words.view(torch.int32)))
        check(errs["cnt_missing"] == 0, "every acknowledged cnt key is present (zero lost)")
        check(errs["cnt_nonzero_after_deletes"] == 0,
              "one delete a batch empties cnt (zero doubled)")
        direct = BlockedBloomFilter(FilterConfig(key_name="chunk", **dur_config(LOG2M)))
        direct.insert_packed(chunk_keys)
        errs["chunk_vs_direct"] = max_abs_err(wsvc._filters["chunk"].filter.words, direct.words)
        check(errs["chunk_vs_direct"] == 0, "the new primary's chunk equals a filter fed every key")
        check(surv.wait_for_seq(wsvc.oplog.last_seq, 300), f"the survivor caught up: {surv.status()}")
        errs["survivor"] = filter_errs(wsvc, ssvc, ["chunk", "cnt"])
        check(max(errs["survivor"].values()) == 0, f"the survivor's words equal the new primary's: {errs}")
        # held and fresh keys of chunk queried at the new primary and at the survivor
        held = chunk_keys[rng.choice(HA_KEYS, SERVER_PROBES, replace=False)]
        fresh = rows(rng, SERVER_PROBES)
        probes = [("QueryBatch", "chunk", r[i:i + SERVER_REQUEST], None)
                  for r in (held, fresh) for i in range(0, SERVER_PROBES, SERVER_REQUEST)]
        want = np.concatenate([np.ones(SERVER_PROBES, bool), direct.include_packed(fresh)])
        for side, addr in (("new_primary", waddr), ("survivor", ssvc.listen_address)):
            q = pool.run(addr, probes)
            got = np.concatenate([o[4] for o in q["out"]])
            check(np.array_equal(got, want), f"the {side}'s verdicts equal the direct filter's")
            out[f"{side}_query_keys_per_s"] = 2 * SERVER_PROBES / q["seconds"]
        del direct
        out["max_abs_err"] = errs
        emit("ha_path_exactly_once", **{k: out[k] for k in ("survivor", "redrive_after", "max_abs_err")})

        # -- fencing: the crashed primary restarted from its log -----------------------------
        t0 = time.monotonic()
        p2log = OpLog(str(HA_DIR / "plog"))
        p2svc = service.BloomService(sink_factory=sink("pckpt"), oplog=p2log, coalesce=coalesce)
        tag_node(p2svc, "P_restarted", undo)
        stats = p2svc.replay_oplog()
        torch.cuda.synchronize()
        check(stats["failed"] == 0, f"the restart replayed its log: {stats}")
        replay_s = time.monotonic() - t0
        srv, _ = service.build_server(p2svc, paddr)
        srv.start()
        p2svc.listen_address = paddr
        nodes["P_restarted"] = (p2svc, srv)
        t_up = time.monotonic()
        deadline = t_up + 60
        while not p2svc.read_only:
            check(time.monotonic() < deadline, "the sentinels fenced the restarted primary")
            time.sleep(0.01)
        t_fenced = time.monotonic()
        with BloomClient(paddr, max_retries=0) as c:
            h = c.health()
            check(h["role"] == "replica" and h["epoch"] == topo["epoch"],
                  f"the restarted primary is a replica at epoch {topo['epoch']}: {h['role']}, {h['epoch']}")
            try:
                c._call_once("InsertBatch", {"name": "cnt", "keys_fixed": {
                    "data": bytes(KEY_LEN), "width": KEY_LEN, "n": 1}})
                code = "OK"
            except protocol.BloomServiceError as e:
                code = e.code
            check(code == "READONLY", f"the fenced node's writes answer READONLY: {code}")
        app = p2svc.replica_applier

        def refused():
            return [m for t, m in list(refusals) if t == app._thread.ident]

        deadline = time.monotonic() + 120
        while app.last_sync_kind is None or (app.last_sync_kind == "full" and app.link != "connected"
                                             and not refused()):
            check(time.monotonic() < deadline, f"the fenced node's resync ended: {app.status()}")
            time.sleep(0.02)
        probes_up = [(a, b, ok) for a, b, ok in marks.get("old_address_health", []) if a >= t_up]
        first_ok = next((a for a, _, ok in probes_up if ok), None)
        fence = {"replay_s": replay_s, "replay": stats, "serving_to_fenced_s": t_fenced - t_up,
                 "serving_to_first_health_s": None if first_ok is None else first_ok - t_up,
                 "health_failed_while_serving": sum(1 for a, _, ok in probes_up
                                                     if not ok and (first_ok is None or a < first_ok)),
                 "health_failed_ms_max": max([(b - a) * 1e3 for a, b, ok in probes_up if not ok],
                                             default=None),
                 "down_s": t_up - t_crash,
                 "epoch": h["epoch"], "writes": code, "resync": app.last_sync_kind,
                 "fence_rpc": [{"node": r["node"], "ms": (r["t1"] - r["t0"]) * 1e3}
                               for r in marks["replicaof_rpc"] if r["node"] == "P"]}
        if app.last_sync_kind == "partial":
            check(app.wait_for_seq(wsvc.oplog.last_seq, 300), f"the fenced node caught up: {app.status()}")
            fence["max_abs_err"] = filter_errs(wsvc, p2svc, ["chunk", "cnt"])
            check(max(fence["max_abs_err"].values()) == 0, "the fenced node's words equal the new primary's")
        else:
            fence["refusal"] = (refused() or [None])[0]
            fence["refused_by_the_cap"] = bool(fence["refusal"]) and "RESOURCE_EXHAUSTED" in fence["refusal"]
            check(fence["refused_by_the_cap"], f"the cap refused chunk's blob: {fence['refusal']}")
            check(p2svc.read_only and app.link != "connected", "the node stays fenced")
            fence["max_abs_err"] = filter_errs(wsvc, p2svc, ["cnt"])
            check(fence["max_abs_err"]["cnt"] == 0, "cnt, which the resync carried, equals the new primary's")
        app.stop()
        out["fencing"] = fence
        out["launches"] = {role: {k: sided.sides.get(label, {}).get(k, 0) for k in HA_KERNELS}
                           for role, label in (("old_primary", "P"), ("new_primary", win),
                                               ("survivor", lose), ("restarted", "P_restarted"))}
        for role in ("old_primary", "new_primary", "survivor"):
            for name in ("blocked_insert", "blocked_counting_update"):
                check(out["launches"][role][name] > 0, f"{name} launched on the {role}'s side")
        for role in ("new_primary", "survivor"):
            check(out["launches"][role]["blocked_query"] > 0, f"blocked_query launched on the {role}'s side")
    finally:
        stop.set()
        repl_log.removeHandler(capture)
        wraps.undo()
        sweep.LAUNCHES = saved
        saved.update(sided)
        for s in sents:
            s.stop()
        if pool is not None:
            pool.close()
        for svc, srv in nodes.values():
            if srv is not None:
                srv.stop(grace=None)
            if svc.replica_applier is not None:
                svc.replica_applier.stop()
            release(svc)
            if svc._coalescer is not None:
                svc._coalescer.close()
            if svc.oplog is not None:
                svc.oplog.close()
        nodes.clear()
        shutil.rmtree(HA_DIR, ignore_errors=True)
        gc.collect()
    torch.cuda.empty_cache()
    emit("ha_path", **out, nvidia_smi=dev["nvidia_smi"], seconds=time.perf_counter() - t_phase)
    return out


# -- cluster mode: hash slots, MOVED/ASK routing, live slot migration under load ---------

CLUSTER_DIR = Path(__file__).resolve().parent / ".cluster_state"  # git-ignored; removed at the end
CL_KEYS = SERVER_KEYS  # 128 InsertBatch requests of 2^16 into the main path's filter "chunk"
CL_TENANT_LOG2M = 30  # {t0}blk and t1-t4: blocked, 128 MiB each, under the 256 MiB message cap
CL_TENANT_BATCHES = 24  # InsertBatch requests of 2^16 into each of {t0}blk and t1-t4
CL_CNT_LOG2M, CL_CNT_BATCH, CL_CNT_EVERY = 28, 1 << 12, 4  # {t0}cnt: a batch after every 4th chunk request
CL_MIGRATE_AFTER = 24  # acknowledged writes before the first migration starts
CL_TENANT_PROBES = 1 << 16  # held and fresh keys queried in each migrated tenant at its new owner
CL_KERNELS = ("blocked_insert", "blocked_query", "blocked_counting_update", "payload_crc32c")
# cuts of the key counts that keep the phase near 90 s (a filter's m never)
CL_CUTS: list = []


def cluster_client(p: int, jobs, barrier, results, startup, acked) -> None:
    """Client process ``p`` of the cluster path (:func:`client_parts`), a
    ``ClusterClient`` a thread over the ``startup`` nodes (or one node, when
    a part names it). A request ``(method, name, rows, rid or None)`` goes
    through ``_keyed`` as one ``keys_fixed`` frame under its rid, which
    heals MOVED and ASK and re-drives a write whose migration forward
    failed; each acknowledged write adds one to ``acked``. Its output is
    ``(host clock sent, host clock answered, error or None, verdicts or
    None, this process's MOVED hops, ASK hops and re-drives so far)``."""
    import threading

    from tpubloom_torch.cluster.client import ClusterClient
    from tpubloom_torch.obs import counters
    from tpubloom_torch.server.client import BloomClient

    redrives, lock = [0], threading.Lock()
    redrive = ClusterClient._redrive

    def counted(self, *a, **kw):
        with lock:
            redrives[0] += 1
        return redrive(self, *a, **kw)

    ClusterClient._redrive = counted

    def connect(addr):
        return ClusterClient(startup_nodes=[addr] if addr else startup, max_retries=3,
                             backoff_base=0.05, backoff_max=0.5)

    def call(cl, job, tally, rid):
        method, name, r, own_rid = job
        req = {"name": name, "keys_fixed": {"data": r.tobytes(), "width": r.shape[1], "n": len(r)}}
        t0, err, hits = time.monotonic(), None, None
        try:
            resp = cl._keyed(method, req, rid=own_rid or f"cl-{rid}")
            if method == "QueryBatch":
                hits = BloomClient._unpack_bool(resp, "hits")
            elif resp.get("n") != len(r):
                err = f"{method} count {resp.get('n')} of {len(r)}"
        except Exception as e:  # noqa: BLE001 — reported to the server's process
            err = f"{type(e).__name__}: {e}"[:400]
        t1 = time.monotonic()
        if err is None and method != "QueryBatch":
            with acked.get_lock():
                acked.value += 1
        return (t0, t1, err, hits, counters.get("client_moved_redirects"),
                counters.get("client_ask_redirects"), redrives[0])

    client_parts(p, jobs, barrier, results, connect, call)


def cluster_cli(module: str, *args: str, timeout: float = 600) -> dict:
    """``python -m <module> <args>`` from this checkout: its exit code,
    stdout, the end of its stderr and its seconds."""
    import os

    t0 = time.perf_counter()
    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=here, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": str(here)})
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr[-1500:],
            "seconds": time.perf_counter() - t0}


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def windowed(reqs: list, outs: list, windows: dict) -> dict:
    """Keys a second of the acknowledged writes by their ack time before,
    in, between and after the migration windows (``{name: (start, end)}``,
    host clock), and the writes' p50 / p99 latency outside and inside
    them."""
    acks = sorted((o[1], len(req[2])) for o, req in zip(outs, reqs)
                  if req[0] == "InsertBatch" and o[2] is None)
    t_start = min(o[0] for o in outs)
    t_end = max(t for t, _ in acks)
    edges = [("before", t_start)]
    for name, (a, b) in sorted(windows.items(), key=lambda kv: kv[1][0]):
        edges += [(name, a), (f"after_{name}", b)]
    edges.append(("end", t_end))
    rates = {}
    for (name, a), (_, b) in zip(edges, edges[1:]):
        keys = sum(n for t, n in acks if a <= t < b or (b == t_end and t == b))
        rates[name] = {"seconds": max(b - a, 0.0), "keys": keys,
                       "keys_per_s": keys / (b - a) if b > a else None}
    inside, outside = [], []
    for o, req in zip(outs, reqs):
        if req[0] != "InsertBatch" or o[2] is not None:
            continue
        hit = any(o[0] < b and o[1] > a for a, b in windows.values())
        (inside if hit else outside).append(o[1] - o[0])
    return {"rates": rates, "latency_outside_windows": percentiles_ms(outside),
            "latency_inside_windows": percentiles_ms(inside), "traffic_s": t_end - t_start}


def phase_cluster_path(rng, dev: dict) -> dict:
    """Cluster mode on the card (``cluster_path``; ``--cluster`` alone), in
    this process with the client processes of the server path's design,
    each thread a ``ClusterClient``: three nodes N0-N2 (each a
    ``BloomService(cluster=ClusterState(...))`` with an op log, a FileSink,
    the coalescer at 2^19 keys a flush and its ``/metrics``) seeded by
    ``python -m tpubloom_torch.cluster init``, and an empty N3. The main
    path's filter "chunk" (m=2^32), two tenants on one hash tag's slot of a
    node that does not own it, ``{t0}blk`` (m=2^30) and ``{t0}cnt`` (2^28
    counters), and four blocked tenants t1-t4 (m=2^30) spread so that every
    node holds one. Under the traffic (2^23 keys into "chunk" as 128
    ``InsertBatch`` of 2^16, 2^16-key batches into ``{t0}blk`` and t1-t4, a
    ``{t0}cnt`` batch of 2^12 after every fourth chunk request), the CLI
    migrates ``{t0}``'s slot with ``cluster.migrate_send`` armed at
    ``nth:3`` (it fails after ``{t0}blk`` landed), then again (``{t0}blk``
    resumes by the op-log tail, ``{t0}cnt`` goes by snapshot), then t1's
    slot cleanly; ``rebalance --plan-only`` pushes the freshest map after
    each and plans over N0-N3. Measured on the host clock: keys/s before
    and during each migration, each node's dispatcher busy share, the clean
    migration's split (snapshot: copy, ``payload_crc32c``, D2H, framing;
    transfer; install: the CRC copy, H2D, the seeded checkpoint;
    finalize), the resumed one's tail records and snapshots, forwards and
    the writes' latency outside and inside the dual-write windows, MOVED /
    ASK hops and re-drives (``IMPORT_NOT_READY`` among them),
    ``memory_allocated`` around each migration, launches by node, and the
    ``cluster_*`` counters of one merged scrape (``python -m
    tpubloom_torch.obs.aggregate --once``, a dead address among the
    nodes). Held with tolerance 0: the words of "chunk", ``{t0}blk`` and
    t1-t4 at their owners equal filters fed every acknowledged key;
    every ``{t0}cnt`` key present and one delete a batch empties it;
    sources answer MOVED and hold no copy, every node's view agrees, no
    request failed. Last, ``MigrateSlot`` of "chunk"'s slot: its refusal
    by the 256 MiB message cap and the slot's state after it."""
    global NODE
    import gc
    import multiprocessing
    import threading

    from tpubloom_torch import faults
    from tpubloom_torch.cluster import migrate as cluster_migrate
    from tpubloom_torch.cluster import slots as cluster_slots
    from tpubloom_torch.cluster.client import ClusterClient
    from tpubloom_torch.cluster.node import ClusterState
    from tpubloom_torch.filter import _FilterBase
    from tpubloom_torch.obs.exposition import parse_families
    from tpubloom_torch.obs.httpd import start_metrics_server
    from tpubloom_torch.repl import OpLog
    from tpubloom_torch.server import ingest, protocol, service
    from tpubloom_torch.server.client import BloomClient

    t_phase = time.perf_counter()
    if CLUSTER_DIR.exists():
        shutil.rmtree(CLUSTER_DIR)
    CLUSTER_DIR.mkdir()
    NODE = threading.local()
    MIG = threading.local()  # which migration part a thread is in ("snapshot", "install")
    saved = (sweep.LAUNCHES, checksum.LAUNCHES)
    # a launch outside every node's handlers is the phase's own direct filters'
    side = lambda: getattr(NODE, "name", None) or "direct_filters"  # noqa: E731
    sided = (SidedLaunches(sweep.LAUNCHES, side), SidedLaunches(checksum.LAUNCHES, side))
    sweep.LAUNCHES, checksum.LAUNCHES = sided
    wraps = Clocks()  # for its undo of every wrapper below
    undo = wraps._undo
    nodes: dict = {}  # label -> (service, server, metrics server)
    busy: dict = {}
    split: dict = {}
    marks: dict = {"migrate_slot": [], "forwards": [], "memory": {}}
    pool = None
    stop = threading.Event()
    coalesce = ingest.CoalesceConfig(max_keys=SERVER_COALESCE_KEYS)
    out: dict = {"cuts": CL_CUTS, "tolerance": 0, "keys": CL_KEYS, "tenant_batches": CL_TENANT_BATCHES,
                 "coalesce_max_keys": SERVER_COALESCE_KEYS, "cap_bytes": 256 << 20}

    def start_node(label):
        addr = f"127.0.0.1:{free_port()}"
        d = CLUSTER_DIR / label
        svc = service.BloomService(
            sink_factory=lambda config, d=d: checkpoint.FileSink(str(d / "ckpt")),
            oplog=OpLog(str(d / "log")), coalesce=coalesce, listen_address=addr,
            cluster=ClusterState(addr, state_dir=str(d / "log")))
        tag_node(svc, label, undo, busy=busy, attrs=("InsertBatch", "QueryBatch", "DeleteBatch",
                                                      "CreateFilter", "MigrateSlot", "MigrateInstall"))
        for attr in ("install_migrated",):
            install = getattr(svc, attr)

            def tagged_install(*a, _f=install, **kw):
                MIG.tag = "install"
                try:
                    return _f(*a, **kw)
                finally:
                    MIG.tag = None

            undo.append((svc, attr, install, False))
            setattr(svc, attr, tagged_install)
        call = svc.cluster.call

        def timed_call(addr_, method, req, timeout=30.0, _f=call):
            t0 = time.perf_counter()
            try:
                return _f(addr_, method, req, timeout=timeout)
            finally:
                tag = getattr(MIG, "tag", None)
                if tag:
                    key = f"{tag}_call_{'probe' if req.get('probe') else method}_s"
                    split[key] = split.get(key, 0.0) + time.perf_counter() - t0

        svc.cluster.call = timed_call
        srv, _ = service.build_server(svc, addr)
        srv.start()
        ms = start_metrics_server(svc, port=0, host="127.0.0.1")
        nodes[label] = (svc, srv, ms)
        return addr

    def part(obj, attr, name, sync=False):
        """Time ``obj.attr`` under ``<part>_<name>`` while a migration part
        runs on the calling thread."""
        orig = getattr(obj, attr)

        def timed(*a, **kw):
            tag = getattr(MIG, "tag", None)
            t0 = time.perf_counter()
            try:
                res = orig(*a, **kw)
                if sync and tag:
                    torch.cuda.synchronize()
                return res
            finally:
                if tag:
                    key = f"{tag}_{name}_s"
                    split[key] = split.get(key, 0.0) + time.perf_counter() - t0

        undo.append((obj, attr, orig, attr in vars(obj)))
        setattr(obj, attr, timed)

    try:
        # -- set-up: four nodes, the slots assigned over three by the CLI ----------------
        labels = ("N0", "N1", "N2", "N3")
        addrs = [start_node(label) for label in labels]
        label_of = dict(zip(addrs, labels))
        svc_of = {a: nodes[label_of[a]][0] for a in addrs}
        three = ",".join(addrs[:3])
        init = cluster_cli("tpubloom_torch.cluster", "init", "--nodes", three)
        check(init["rc"] == 0, f"cluster init: {init['err']}")
        owners = cluster_slots.expand_ranges(json.loads(init["out"])["assigned"])
        x = owners[cluster_slots.key_slot("chunk")]
        tag = next(t for t in ["t0"] + [f"t0-{i}" for i in range(64)]
                   if owners[cluster_slots.key_slot(t)] != x)
        y = owners[cluster_slots.key_slot(tag)]
        z = next(a for a in addrs[:3] if a not in (x, y))
        blk, cnt = f"{{{tag}}}blk", f"{{{tag}}}cnt"

        def tenant(i, at):
            return next(f"t{i}-{j}" for j in range(4096)
                        if owners[cluster_slots.key_slot(f"t{i}-{j}")] == at
                        and cluster_slots.key_slot(f"t{i}-{j}") not in (
                            cluster_slots.key_slot(tag), cluster_slots.key_slot("chunk")))

        tenants = [tenant(1, z), tenant(2, x), tenant(3, y), tenant(4, z)]
        t1 = tenants[0]
        cc = ClusterClient(startup_nodes=addrs[:3])
        cc.create_filter("chunk", config=dur_config(LOG2M))
        for name in [blk, *tenants]:
            cc.create_filter(name, config=dur_config(CL_TENANT_LOG2M))
        cc.create_filter(cnt, config=dur_config(CL_CNT_LOG2M, counting=True))
        cc.close()
        where = {name: label_of[owners[cluster_slots.key_slot(name)]]
                 for name in ["chunk", blk, cnt, *tenants]}
        check(len(set(where.values())) == 3, f"every node of N0-N2 holds a filter: {where}")
        out["setup"] = {"nodes": dict(zip(labels, addrs)), "init": json.loads(init["out"]),
                        "init_s": init["seconds"], "tag": tag, "tenants": tenants, "where": where,
                        "memory_allocated": torch.cuda.memory_allocated()}
        for obj, attr, name, sync in (
                (checkpoint, "_device_snapshot", "device_copy", True),
                (checksum, "payload_crc32c", "payload_crc32c", False),
                (checkpoint, "_serialize", "serialize", False),
                (checkpoint, "_frame", "frame", False),
                (checkpoint, "snapshot_blob", "snapshot_blob", False),
                (checksum, "bytes_crc32c", "bytes_crc32c", False),
                (checkpoint, "payload_to_words", "payload_to_words", False),
                (_FilterBase, "_set_words", "set_words", True),
                (checkpoint.AsyncCheckpointer, "trigger", "seeded_checkpoint_trigger", True)):
            part(obj, attr, name, sync)
        migrate_filter = cluster_migrate._migrate_filter

        def tagged_migrate_filter(service_, name, target, stats):
            MIG.tag = "snapshot"
            t0 = time.monotonic()
            try:
                return migrate_filter(service_, name, target, stats)
            finally:
                MIG.tag = None
                marks["migrate_slot"][-1]["filters"].append((name, t0, time.monotonic()))

        migrate_slot = cluster_migrate.migrate_slot

        def timed_migrate_slot(service_, slot, target):
            entry = {"slot": slot, "source": label_of[service_.listen_address],
                     "target": label_of.get(target, target), "t0": time.monotonic(), "filters": []}
            marks["migrate_slot"].append(entry)
            try:
                resp = migrate_slot(service_, slot, target)
                entry["resp"] = resp
                return resp
            except BaseException as e:
                entry["error"] = repr(e)[:300]
                raise
            finally:
                entry["t1"] = time.monotonic()

        forward_op = cluster_migrate.forward_op

        def counted_forward(service_, method, req, resp):
            armed = service_.cluster is not None and isinstance(req.get("name"), str) and \
                service_.cluster.forward_target(req["name"]) is not None
            try:
                res = forward_op(service_, method, req, resp)
                if armed:
                    marks["forwards"].append((time.monotonic(), req["name"], "ok"))
                return res
            except protocol.BloomServiceError as e:
                kind = "import_not_ready" if "IMPORT_NOT_READY" in e.message else "failed"
                marks["forwards"].append((time.monotonic(), req["name"], kind))
                raise

        for attr, fn in (("_migrate_filter", tagged_migrate_filter),
                         ("migrate_slot", timed_migrate_slot), ("forward_op", counted_forward)):
            undo.append((cluster_migrate, attr, getattr(cluster_migrate, attr), True))
            setattr(cluster_migrate, attr, fn)

        # -- the traffic, and the migrations it runs under ----------------------------------
        chunk_keys = rows(rng, CL_KEYS)
        tkeys = {name: rows(rng, CL_TENANT_BATCHES * SERVER_REQUEST) for name in [blk, *tenants]}
        cnt_batches: list = []
        treqs = [("InsertBatch", name, r[i * SERVER_REQUEST:(i + 1) * SERVER_REQUEST], None)
                 for i in range(CL_TENANT_BATCHES) for name, r in tkeys.items()]
        reqs, n_chunk = [], CL_KEYS // SERVER_REQUEST
        for j in range(n_chunk):
            reqs.append(("InsertBatch", "chunk", chunk_keys[j * SERVER_REQUEST:(j + 1) * SERVER_REQUEST],
                         None))
            if j % CL_CNT_EVERY == CL_CNT_EVERY - 1:
                cnt_batches.append((rows(rng, CL_CNT_BATCH), f"cl-cnt-{len(cnt_batches)}"))
                reqs.append(("InsertBatch", cnt, *cnt_batches[-1]))
            while len(reqs) - (j + 1) - len(cnt_batches) < len(treqs) * (j + 1) // n_chunk:
                reqs.append(treqs[len(reqs) - (j + 1) - len(cnt_batches)])
        ctx = multiprocessing.get_context("spawn")
        acked = ctx.Value("i", 0)
        pool = ClientPool(cluster_client, (addrs[:3], acked))
        runs: dict = {}

        def migrate(label, slot, to, arm=None):
            marks["memory"][f"{label}_before"] = torch.cuda.memory_allocated()
            if arm:
                faults.arm("cluster.migrate_send", arm, times=1)
            try:
                runs[label] = r = cluster_cli("tpubloom_torch.cluster", "migrate", "--nodes", three,
                                              "--slot", str(slot), "--to", to)
            finally:
                if arm:
                    faults.disarm("cluster.migrate_send")
            torch.cuda.synchronize()
            marks["memory"][f"{label}_after"] = torch.cuda.memory_allocated()
            time.sleep(1.0)  # a flush in flight at the handoff may hold the source's copy
            marks["memory"][f"{label}_after_1s"] = torch.cuda.memory_allocated()
            return r

        def sync_map(label):
            runs[label] = cluster_cli("tpubloom_torch.cluster", "rebalance", "--nodes", three,
                                      "--plan-only")

        def migrations():
            try:
                while acked.value < CL_MIGRATE_AFTER and not stop.is_set():
                    time.sleep(0.002)
                slot0 = cluster_slots.key_slot(blk)
                migrate("m1_interrupted", slot0, x, arm="nth:3")
                migrate("m1_resumed", slot0, x)
                sync_map("sync_after_m1")
                before = dict(split)
                migrate("m2_clean", cluster_slots.key_slot(t1), y)
                marks["m2_split"] = {k: v - before.get(k, 0.0) for k, v in split.items()
                                     if v != before.get(k, 0.0)}
                sync_map("sync_after_m2")
                marks["acked_at_m2_end"] = acked.value
            except BaseException as e:  # noqa: BLE001 — checked below
                marks["migrations_error"] = repr(e)

        drv = threading.Thread(target=migrations, daemon=True)
        drv.start()
        busy.clear()
        run = pool.run(None, reqs)
        drv.join(timeout=600)
        stop.set()
        check("migrations_error" not in marks, f"the migrations ran: {marks.get('migrations_error')}")
        errors = [(req[1], o[2]) for o, req in zip(run["out"], reqs) if o[2] is not None]
        check(not errors, f"no client request failed across a handoff: {errors[:3]}")
        m1a, m1r, m2 = runs["m1_interrupted"], runs["m1_resumed"], runs["m2_clean"]
        check(m1a["rc"] != 0 and "cluster.migrate_send" in m1a["err"] + m1a["out"],
              f"the armed migration failed at its third send: {m1a['rc']} {m1a['err'][-300:]}")
        check(m1r["rc"] == 0 and m2["rc"] == 0, f"the migrations ended: {m1r['err']} {m2['err']}")
        r1, r2 = json.loads(m1r["out"]), json.loads(m2["out"])
        check(r1["ok"] and r1["filters_moved"] == 2 and r1["snapshots"] == 1,
              f"{blk} resumed by the tail (no blob re-sent), {cnt} by snapshot: {r1}")
        check(r2["ok"] and r2["filters_moved"] == 1 and r2["snapshots"] == 1, f"t1 moved: {r2}")
        mig = marks["migrate_slot"]  # the attempt, the resume and the clean one, as the source ran them
        check(len(mig) == 3, f"three MigrateSlot calls reached the sources: {len(mig)}")
        windows = {"m1": (mig[0]["t0"], mig[1]["t1"]), "m2": (mig[2]["t0"], mig[2]["t1"])}
        traffic = windowed(reqs, run["out"], windows)
        by_proc = {}
        for i, o in enumerate(run["out"]):
            p = i % SERVER_CLIENT_PROCS
            by_proc[p] = [max(a, b) for a, b in zip(by_proc.get(p, (0, 0, 0)), o[4:7])]
        hops = dict(zip(("moved", "ask", "redrives"), map(sum, zip(*by_proc.values()))))
        fwd = marks["forwards"]
        per_window = {}
        for w, (a, b) in windows.items():
            inw = [f for f in fwd if a <= f[0] <= b]
            per_window[w] = {k: sum(1 for f in inw if f[2] == k) for k in ("ok", "import_not_ready", "failed")}
        per_window["outside"] = {k: sum(1 for f in fwd if f[2] == k and not any(
            a <= f[0] <= b for a, b in windows.values())) for k in ("ok", "import_not_ready", "failed")}
        server_rate = RECORD.get("server_path", {}).get("insert", {}).get("keys_per_s")
        out["traffic"] = {
            "requests": len(reqs), "writes": sum(1 for r in reqs if r[0] == "InsertBatch"),
            "keys": sum(len(r[2]) for r in reqs), "seconds": run["seconds"],
            "clients_ready_s": run["ready_s"], **traffic,
            "keys_per_s": sum(len(r[2]) for r in reqs) / run["seconds"],
            "server_path_keys_per_s_same_run": server_rate,
            "one_process_note": "the four nodes share this process, its GIL and the card: not a "
                                "measure of horizontal scaling",
            "dispatcher_busy_share": {label: busy.get(label, 0.0) / run["seconds"] for label in labels},
            "client_hops": hops, "forwards": per_window,
        }
        migs = {}
        for entry in marks["migrate_slot"]:
            label = ("m1_interrupted" if "error" in entry else
                     "m1_resumed" if entry["slot"] == cluster_slots.key_slot(blk) else "m2_clean")
            migs[label] = entry
        clean = migs["m2_clean"]
        _, f0, f1 = clean["filters"][0]
        out["migrations"] = {
            label: {"source": e["source"], "target": e["target"], "seconds": e["t1"] - e["t0"],
                    "resp": e.get("resp"), "error": e.get("error"),
                    "cli_s": runs[label]["seconds"],
                    "memory_before": marks["memory"][f"{label}_before"],
                    "memory_after": marks["memory"][f"{label}_after"],
                    "memory_after_1s": marks["memory"][f"{label}_after_1s"]}
            for label, e in migs.items()}
        # the clean migration's parts under load (the counters of every part add
        # over the migrations, so they are read as a difference around it)
        out["migrations"]["m2_clean"].update(
            filter_s=f1 - f0, marks_s=f0 - clean["t0"], finalize_s=clean["t1"] - f1,
            parts_s=dict(sorted(marks["m2_split"].items())))
        out["sync_map"] = {k: {"rc": runs[k]["rc"], "seconds": runs[k]["seconds"],
                               "plan": json.loads(runs[k]["out"].splitlines()[0])}
                           for k in ("sync_after_m1", "sync_after_m2")}
        emit("cluster_path_traffic", **{k: out[k] for k in ("setup", "traffic", "migrations")})

        # -- the clean migration alone, split, on a quiet cluster: t2 from x to z -------------
        split.clear()
        t2 = tenants[1]
        slot2 = cluster_slots.key_slot(t2)
        m3 = migrate("m3_split", slot2, z)
        check(m3["rc"] == 0, f"t2 moved: {m3['err']}")
        e3 = marks["migrate_slot"][-1]
        _, g0, g1 = e3["filters"][0]
        svc_z = svc_of[z]
        ck_stats = svc_z._filters[t2].checkpointer
        check(ck_stats.flush(120), "the seeded checkpoint landed")
        snap_s = split.get("snapshot_snapshot_blob_s", 0.0)
        install_call = split.get("snapshot_call_MigrateInstall_s", 0.0)
        install_s = sum(split.get(k, 0.0) for k in (
            "install_bytes_crc32c_s", "install_payload_to_words_s", "install_set_words_s",
            "install_seeded_checkpoint_trigger_s"))
        out["clean_split"] = {
            "tenant": t2, "source": label_of[x], "target": label_of[z], "bytes": 1 << (CL_TENANT_LOG2M - 3),
            "seconds": e3["t1"] - e3["t0"], "cli_s": m3["seconds"],
            "snapshot_s": snap_s, "snapshot_device_copy_s": split.get("snapshot_device_copy_s", 0.0),
            "snapshot_payload_crc32c_s": split.get("snapshot_payload_crc32c_s", 0.0),
            "snapshot_d2h_s": split.get("snapshot_serialize_s", 0.0)
            - split.get("snapshot_payload_crc32c_s", 0.0) - split.get("snapshot_frame_s", 0.0),
            "snapshot_frame_s": split.get("snapshot_frame_s", 0.0),
            "probe_s": split.get("snapshot_call_probe_s", 0.0),
            "install_call_s": install_call,
            "install_s": install_s,
            "install_bytes_crc32c_s": split.get("install_bytes_crc32c_s", 0.0),
            "install_h2d_s": split.get("install_payload_to_words_s", 0.0) + split.get("install_set_words_s", 0.0),
            "install_seeded_checkpoint_trigger_s": split.get("install_seeded_checkpoint_trigger_s", 0.0),
            "seeded_checkpoint_worker_s": ck_stats.obs_stats()["last_duration_seconds"],
            "transfer_s": install_call - install_s,
            "finalize_s": e3["t1"] - g1, "marks_s": g0 - e3["t0"],
            "memory_before": marks["memory"]["m3_split_before"],
            "memory_after": marks["memory"]["m3_split_after"], "parts_s": dict(sorted(split.items()))}
        sync_map("sync_after_m3")

        # -- views, queries, the words, exactly once, ownership ---------------------------------
        plan = cluster_cli("tpubloom_torch.cluster", "rebalance", "--nodes", ",".join(addrs), "--plan-only")
        info = cluster_cli("tpubloom_torch.cluster", "info", "--nodes", ",".join(addrs))
        check(plan["rc"] == 0 and info["rc"] == 0, f"rebalance --plan-only and info: {plan['err']} {info['err']}")
        views = json.loads(info["out"])
        out["views"] = {"plan": json.loads(plan["out"].splitlines()[0]), "plan_s": plan["seconds"],
                        "info": {label_of[a]: {"epoch": v["epoch"], "ranges": v["ranges"],
                                               "migrating": v["migrating"], "importing": v["importing"]}
                                 for a, v in views.items()}}
        check(len({(v["epoch"], json.dumps(v["ranges"])) for v in views.values()}) == 1,
              "every node's info view agrees on the epoch and the owners")
        final = cluster_slots.expand_ranges(views[addrs[0]]["ranges"])
        owner_of = {name: final[cluster_slots.key_slot(name)] for name in ["chunk", blk, cnt, *tenants]}
        check(owner_of[blk] == owner_of[cnt] == x and owner_of[t1] == y and owner_of[t2] == z,
              f"the migrated slots' owners: {owner_of}")
        errs: dict = {}
        held = chunk_keys[rng.choice(CL_KEYS, SERVER_PROBES, replace=False)]
        fresh = rows(rng, SERVER_PROBES)
        qreqs = [("QueryBatch", "chunk", r[i:i + SERVER_REQUEST], None)
                 for r in (held, fresh) for i in range(0, SERVER_PROBES, SERVER_REQUEST)]
        for name in (blk, t1, t2):
            for r in (tkeys[name][:CL_TENANT_PROBES], rows(rng, CL_TENANT_PROBES)):
                qreqs.append(("QueryBatch", name, r, None))
        q = pool.run(None, qreqs)
        check(all(o[2] is None for o in q["out"]), "every query answered")
        out["query"] = {"requests": len(qreqs), "seconds": q["seconds"],
                        "keys_per_s": sum(len(r[2]) for r in qreqs) / q["seconds"]}
        verdicts: dict = {}
        for o, req in zip(q["out"], qreqs):
            verdicts.setdefault(req[1], []).append((req[2], o[3]))
        for name, log2m in [("chunk", LOG2M), *[(n, CL_TENANT_LOG2M) for n in (blk, *tenants)]]:
            direct = BlockedBloomFilter(FilterConfig(key_name=name, **dur_config(log2m)))
            direct.insert_packed(chunk_keys if name == "chunk" else tkeys[name])
            words = svc_of[owner_of[name]]._filters[name].filter.words
            check(on_card(words), f"{name} on the card")
            errs[name] = max_abs_err(words, direct.words)
            for r, got in verdicts.get(name, ()):
                check(np.array_equal(got, np.asarray(direct.include_packed(r))),
                      f"{name}'s verdicts at its owner equal the direct filter's")
            del direct
        check(max(errs.values()) == 0, f"every filter at its owner equals one fed every key: {errs}")
        wcnt = svc_of[x]._filters[cnt].filter
        all_cnt = np.concatenate([b for b, _ in cnt_batches])
        errs["cnt_missing"] = int((~np.asarray(wcnt.include_packed(all_cnt))).sum())
        with BloomClient(x) as c:
            for b, rid in cnt_batches:
                c._call_once("DeleteBatch", {"name": cnt, "rid": rid + "-delete", "keys_fixed": {
                    "data": b.tobytes(), "width": KEY_LEN, "n": len(b)}})
        torch.cuda.synchronize()
        errs["cnt_nonzero_after_deletes"] = int(torch.count_nonzero(wcnt.words.view(torch.int32)))
        check(errs["cnt_missing"] == 0, "every acknowledged {t0}cnt key is present at its new owner")
        check(errs["cnt_nonzero_after_deletes"] == 0, "one delete a batch empties {t0}cnt (zero doubled)")
        moved = {}
        for name, src, dst in ((blk, y, x), (cnt, y, x), (t1, z, y), (t2, x, z)):
            check(name not in svc_of[src]._filters, f"{name}'s copy is gone from its source")
            with BloomClient(src, max_retries=0) as c:
                try:
                    c._call_once("QueryBatch", {"name": name, "keys_fixed": {
                        "data": bytes(KEY_LEN), "width": KEY_LEN, "n": 1}})
                    code = addr = "OK"
                except protocol.BloomServiceError as e:
                    code, addr = e.code, e.details.get("addr")
            moved[name] = {"source": label_of[src], "answer": code, "redirect_to": label_of.get(addr, addr)}
            check(code == "MOVED" and addr == dst, f"{name}'s source answers MOVED to {dst}: {code} {addr}")
        out["ownership"] = moved
        out["max_abs_err"] = errs
        out["launches"] = {label: {k: sum(s.sides.get(label, {}).get(k, 0) for s in sided)
                                   for k in CL_KERNELS} for label in (*labels, "direct_filters")}
        for label in labels[:3]:
            check(out["launches"][label]["blocked_insert"] > 0, f"blocked_insert launched on {label}")
        for label, name in ((label_of[x], "blocked_counting_update"), (label_of[y], "blocked_counting_update"),
                            (label_of[x], "blocked_query"), (label_of[y], "blocked_query"),
                            (label_of[y], "payload_crc32c"), (label_of[x], "payload_crc32c")):
            check(out["launches"][label][name] > 0, f"{name} launched on {label}")
        emit("cluster_path_checks", **{k: out[k] for k in ("clean_split", "views", "query", "ownership",
                                                            "max_abs_err", "launches")})

        # -- one merged scrape of N0-N3 and a dead address -------------------------------------
        dead = f"127.0.0.1:{free_port()}"
        mnodes = [f"127.0.0.1:{nodes[label][2].port}" for label in labels] + [dead]
        scrape = cluster_cli("tpubloom_torch.obs.aggregate", "--nodes", ",".join(mnodes), "--once",
                             "--timeout", "5")
        check(scrape["rc"] == 0, f"the merged scrape: {scrape['err']}")
        fams = parse_families(scrape["out"])
        up = {dict(k)["node"]: v for k, v in fams["tpubloom_aggregate_node_up"].items()}
        check(up.get(dead) == 0.0 and all(up.get(n) == 1.0 for n in mnodes[:4]),
              f"node_up is 1 for N0-N3 and 0 for the dead address: {up}")
        out["scrape"] = {"seconds": scrape["seconds"], "node_up": up, "bytes": len(scrape["out"]),
                         "shared_registry_note": "the nodes share this process's counters",
                         "cluster": {f: {dict(k).get("node"): v for k, v in fams[f].items()
                                         if dict(k).get("node") == mnodes[0]}
                                     for f in sorted(fams) if f.startswith("tpubloom_cluster_")
                                     and not f.startswith("tpubloom_cluster_slot_keys_total_")},
                         "client_counters_note": "MOVED / ASK hops are counted in the client processes"}

        # -- last: the 256 MiB message cap on "chunk"'s slot ------------------------------------
        slot_c = cluster_slots.key_slot("chunk")
        t0 = time.perf_counter()
        try:
            with BloomClient(x, timeout=600, max_retries=0) as c:
                cap = {"answer": "OK", "resp": c.migrate_slot(slot_c, y)}
        except protocol.BloomServiceError as e:
            cap = {"answer": e.code, "message": e.message[:400],
                   "resource_exhausted": "RESOURCE_EXHAUSTED" in e.message}
        cap["seconds"] = time.perf_counter() - t0
        cap["source_marks"] = {"migrating": svc_of[x].cluster.slots.migrating.get(slot_c),
                               "owner": label_of.get(svc_of[x].cluster.owner(slot_c))}
        cap["target_marks"] = {"importing": svc_of[y].cluster.slots.importing.get(slot_c),
                               "owner": label_of.get(svc_of[y].cluster.owner(slot_c)),
                               "holds_chunk": "chunk" in svc_of[y]._filters}
        for method in ("QueryBatch", "InsertBatch"):
            with BloomClient(x, max_retries=0) as c:
                try:
                    resp = c._call_once(method, {"name": "chunk", "keys_fixed": {
                        "data": chunk_keys[:1].tobytes(), "width": KEY_LEN, "n": 1}})
                    cap[method] = {"answer": "OK", "n": resp.get("n")}
                except protocol.BloomServiceError as e:
                    cap[method] = {"answer": e.code, "message": e.message[:300],
                                   "details": {k: v for k, v in e.details.items() if k != "target"}}
        cap["memory_allocated"] = torch.cuda.memory_allocated()
        out["cap"] = cap
        check(cap["answer"] == "RESOURCE_EXHAUSTED" or cap.get("resource_exhausted", False),
              f"the cap refused chunk's blob: {cap}")
    finally:
        stop.set()
        wraps.undo()
        sweep.LAUNCHES, checksum.LAUNCHES = saved
        for s, base in zip(sided, saved):
            base.update(s)
        if pool is not None:
            pool.close()
        for svc, srv, ms in nodes.values():
            ms.close()
            srv.stop(grace=None)
            release(svc)
            if svc._coalescer is not None:
                svc._coalescer.close()
            svc.oplog.close()
            svc.cluster.close()
        nodes.clear()
        faults.reset()
        shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
        gc.collect()
    torch.cuda.empty_cache()
    emit("cluster_path", **out, nvidia_smi=dev["nvidia_smi"], seconds=time.perf_counter() - t_phase)
    return out


# -- phase 32: the distributed path -------------------------------------------------

# config 5 (LOG2M_SHARDED, SHARDS) split over two ranks on the one card,
# 4 GiB each, gloo between them; the batch the sharded path inserts (2^23)
# and as many fresh keys queried beside the held ones
DIST_KEYS = B_SHARDED
DIST_RANKS = 2
DIST_TIMEOUT_S = 180.0  # a rank's join, and each collective after it, raises past this
DIST_WAIT_S = 420.0  # how long the phase waits for a set of ranks to answer
DIST_REDUCE_TURNS = 5  # the all-reduce alone, timed this many times


def dist_keys(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The held and the fresh rows, the same in every process."""
    rng = np.random.default_rng(seed)
    return rows(rng, n), rows(rng, n)


def dist_sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_digest(f: ShardedBloomFilter) -> tuple[list, list]:
    """``(CRC32C, popcount)`` of each shard the filter holds, in shard
    order, made where the words lie (``payload_crc32c`` of the shard's raw
    words; ``shard_popcounts``)."""
    from tpubloom_torch.parallel.sharded import shard_popcounts

    crcs, pops = [], []
    for w in f.slot_words:
        crcs += [checksum.payload_crc32c(w[s], 4 * w[s].numel(), False)[1]
                 for s in range(w.shape[0])]
        pops += shard_popcounts(w).cpu().tolist()
    return crcs, pops


def dist_drive(f: ShardedBloomFilter, held: np.ndarray, fresh: np.ndarray, barrier) -> dict:
    """The path's two calls, each on the host clock between synchronized
    points (and, across ranks, ``barrier()``s), with the launch counts set
    to 0 before the insert and read after the query."""
    dev = f.device
    dist_sync(dev)
    barrier()
    sweep.reset_launch_counts()
    t0 = time.perf_counter()
    check(f.insert_packed(held) == len(held), "insert_packed count")
    dist_sync(dev)
    insert_s = time.perf_counter() - t0
    barrier()
    t0 = time.perf_counter()
    verdicts = f.include_packed(np.concatenate([held, fresh]))
    query_s = time.perf_counter() - t0
    launches = sweep.launch_counts()
    return {"verdicts": verdicts, "launches": launches, "insert_s": insert_s, "query_s": query_s,
            "insert_keys_per_s": len(held) / insert_s,
            "query_keys_per_s": len(verdicts) / query_s}


def dist_rank(spec: dict, results) -> None:
    """One rank of the distributed path, in a process of its own: it joins
    through ``initialize_multihost`` (``tcp://`` with ``spec["coord"]``, or
    ``env://`` as torchrun starts a rank), holds its share of config 5's
    shards, inserts the seeded batch, queries held and fresh keys (the
    verdicts all-reduced over the group), times the all-reduce alone at the
    query's length, and puts what it saw on ``results``. A failure puts its
    traceback there and exits non-zero."""
    import os
    import traceback

    import torch.distributed as dist

    from tpubloom_torch.parallel import distributed

    try:
        os.environ.update(spec.get("env", {}))
        if spec["coord"] is None:
            topo = distributed.initialize_multihost(
                auto_detect=True, backend=spec["backend"], timeout_s=DIST_TIMEOUT_S)
        else:
            topo = distributed.initialize_multihost(
                spec["coord"], spec["world"], spec["rank"], backend=spec["backend"],
                timeout_s=DIST_TIMEOUT_S)
        check(topo["process_index"] == spec["rank"] and topo["process_count"] == spec["world"],
              f"rank {spec['rank']} topology {topo}")
        held, fresh = dist_keys(spec["seed"], spec["keys"])
        f = ShardedBloomFilter(sharded_config(spec["log2m"]), devices=spec["devices"])
        run = dist_drive(f, held, fresh, dist.barrier)
        verdicts = run.pop("verdicts")
        votes = torch.zeros(len(verdicts), dtype=torch.bool, device=f.device)
        reduce_ms = []
        for _ in range(DIST_REDUCE_TURNS):
            dist.barrier()
            dist_sync(f.device)
            t0 = time.perf_counter()
            f._combine_ranks(votes)
            dist_sync(f.device)
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        crcs, pops = shard_digest(f)
        results.put({
            "rank": spec["rank"], "backend": dist.get_backend(), "topology": topo,
            "device": str(f.device), "shard_base": f.shard_base, "shards_local": f.shards_local,
            **run, "allreduce_ms": reduce_ms, "allreduce_bytes": len(verdicts),
            "crc": crcs, "popcount": pops, "verdicts": np.packbits(verdicts).tobytes(),
            "n_verdicts": len(verdicts),
            "memory_allocated": (torch.cuda.memory_allocated(f.device)
                                 if f.device.type == "cuda" else 0),
        })
        distributed.shutdown()
    except BaseException:
        results.put({"rank": spec["rank"], "error": traceback.format_exc()})
        raise


def run_ranks(specs: list, wait_s: float = DIST_WAIT_S) -> list:
    """Start a process a spec (spawn), collect each rank's answer, and wait
    for every process to exit 0; a rank's failure, or no answer in
    ``wait_s``, raises and kills the others."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(s, results)) for s in specs]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + wait_s
    try:
        while len(out) < len(specs):
            left = deadline - time.monotonic()
            check(left > 0, f"{len(specs) - len(out)} rank(s) answered within {wait_s} s")
            try:
                r = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                check(not dead, f"a rank process exited {dead} without answering")
                continue
            check("error" not in r, f"rank {r['rank']} failed:\n{r.get('error', '')[-3000:]}")
            out[r["rank"]] = r
        for p in procs:
            p.join(timeout=120)
            check(p.exitcode == 0, f"a rank process exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[i] for i in sorted(out)]


def rank_summary(r: dict) -> dict:
    return {k: r[k] for k in ("rank", "backend", "device", "topology", "shard_base", "shards_local",
                              "launches", "insert_s", "query_s", "insert_keys_per_s",
                              "query_keys_per_s", "allreduce_ms", "allreduce_bytes",
                              "memory_allocated")}


def hold_ranks(ranks: list, ref: dict, what: str) -> dict:
    """Each rank's shard CRCs and popcounts against the one-process
    filter's for the same shards, its verdicts against the one-process
    verdicts (tolerance 0), and its launches of the sharded pair."""
    worst = {"crc_mismatches": 0, "popcount": 0, "verdicts": 0}
    for r in ranks:
        lo, hi = r["shard_base"], r["shard_base"] + r["shards_local"]
        worst["crc_mismatches"] += sum(a != b for a, b in zip(r["crc"], ref["crc"][lo:hi]))
        worst["popcount"] = max(worst["popcount"], max(
            abs(a - b) for a, b in zip(r["popcount"], ref["popcount"][lo:hi])))
        got = np.unpackbits(np.frombuffer(r["verdicts"], np.uint8))[: r["n_verdicts"]]
        worst["verdicts"] = max(worst["verdicts"],
                                int(np.abs(got.astype(np.int64) - ref["verdicts"]).max()))
        check(len(r["crc"]) == hi - lo == len(r["popcount"]), f"{what}: a digest a shard")
        for name in ("sharded_blocked_insert", "sharded_blocked_query"):
            check(r["launches"][name] > 0, f"{what}: rank {r['rank']} launched {name}")
    check(sum(r["shards_local"] for r in ranks) == len(ref["crc"]), f"{what}: every shard held")
    check(worst == {"crc_mismatches": 0, "popcount": 0, "verdicts": 0},
          f"{what}: words and verdicts equal the one-process filter's ({worst})")
    return {**worst, "max_abs_err": max(worst["popcount"], worst["verdicts"])}


def phase_distributed_path(dev: dict, log2m: int = LOG2M_SHARDED, n_keys: int = DIST_KEYS,
                           device: str = "cuda") -> dict:
    """The sharded filter over processes (``distributed_path``;
    ``--distributed`` alone). First the one-process reference: a
    ``ShardedBloomFilter`` of config 5 in this process (one slot, 64
    shards, 8 GiB) inserts a seeded batch of 2^23 keys and queries them
    with 2^23 fresh ones; each shard's CRC32C and popcount are read on the
    card. Then two ranks in processes of their own, joined by
    ``initialize_multihost(..., backend="gloo")`` over localhost, each
    holding its 32 shards (4 GiB) on the one card: the same calls, the
    verdicts all-reduced through gloo on CUDA tensors. Then one NCCL rank
    (world size 1, joined through ``env://``) holding all 64, so that the
    NCCL op and dtype run on the card; with two cards or more, two NCCL
    ranks, one a card. Held with tolerance 0: every rank's shard CRCs,
    popcounts and all-reduced verdicts against the reference's; each rank
    launched the sharded insert and query (counts set to 0 before its
    insert, read after its query). On the host clock: each rank's and the
    reference's insert and query keys/s, and the all-reduce alone at the
    query's length."""
    t_phase = time.perf_counter()
    held, fresh = dist_keys(SEED + 32, n_keys)
    cfg = sharded_config(log2m)
    devices = None if device == "cuda" else [device]
    f = ShardedBloomFilter(cfg, devices=devices)
    check(len(f.slot_words) == 1 and f.shards_local == SHARDS, "the reference holds every shard")
    run = dist_drive(f, held, fresh, lambda: None)
    check(run["verdicts"][:n_keys].all(), "every held key present")
    crcs, pops = shard_digest(f)
    ref = {"crc": crcs, "popcount": pops, "verdicts": run.pop("verdicts").astype(np.int64)}
    reference = {**run, "fresh_hits": int(ref["verdicts"][n_keys:].sum())}
    del f
    if device == "cuda":
        torch.cuda.empty_cache()
    base = {"keys": n_keys, "seed": SEED + 32, "log2m": log2m}
    port = free_port()
    gloo = run_ranks([{**base, "rank": r, "world": DIST_RANKS, "backend": "gloo",
                       "coord": f"127.0.0.1:{port}", "devices": devices}
                      for r in range(DIST_RANKS)])
    for r in gloo:
        check(r["shards_local"] == SHARDS // DIST_RANKS and r["shard_base"] == r["rank"] * 32,
              f"rank {r['rank']} holds shards {r['rank'] * 32}-{r['rank'] * 32 + 31}")
    gloo_err = hold_ranks(gloo, ref, "two gloo ranks")
    out = {"card": dev["nvidia_smi"], "config": {"m": cfg.m, "k": cfg.k, "shards": cfg.shards,
                                                 "block_bits": cfg.block_bits, "keys": n_keys},
           "reference": reference, "gloo_two_ranks": [rank_summary(r) for r in gloo],
           "gloo_two_ranks_errors": gloo_err}
    if device == "cuda":
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
               "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
        nccl = run_ranks([{**base, "rank": 0, "world": 1, "backend": "nccl", "coord": None,
                           "devices": None, "env": env}])
        check(nccl[0]["backend"] == "nccl", "the one rank joined over nccl")
        out["nccl_one_rank"] = rank_summary(nccl[0])
        out["nccl_one_rank_errors"] = hold_ranks(nccl, ref, "one nccl rank")
        if dev["count"] >= 2:
            port = free_port()
            multi = run_ranks([{**base, "rank": r, "world": 2, "backend": "nccl",
                                "coord": f"127.0.0.1:{port}", "devices": None}
                               for r in range(2)])
            check({r["device"] for r in multi} == {"cuda:0", "cuda:1"}, "one rank a card")
            out["nccl_two_cards"] = [rank_summary(r) for r in multi]
            out["nccl_two_cards_errors"] = hold_ranks(multi, ref, "two nccl ranks, two cards")
            out["multi_card"] = "verified"
        else:
            out["multi_card"] = f"unverified ({dev['count']} card)"
    out["max_abs_err"] = max(v["max_abs_err"] for k, v in out.items() if k.endswith("_errors"))
    out["seconds"] = time.perf_counter() - t_phase
    emit("distributed_path", **out)
    return out


# The CPU driver (tpubloom_torch.cpu_ref on the host C++ library) against
# the card's kernels (cpu_ref_path; --cpu-ref alone). The main path's filter
# at full width: two batches of B through test-and-insert, the second half
# keys of the first; 2^20 fresh keys queried. BASELINE config 1
# (benchmarks/run.py:39-48: m=10,000,000, k=7, 10^6 16-byte keys) on the
# flat filter. The flat counting filter at 2^24 counters (the cut the flat
# path's round trips use): 2^20 inserts, 16 of them keys repeated 20 times
# (past saturation), then 2^18 deletes, those keys 18 times among them. The
# scalable stack at BF.RESERVE key 0.01 4194304 EXPANSION 2 with 2^23 keys
# (two layers). pack_keys's two scatters at 2^16 and 2^23 keys, PACK_ROUNDS
# rounds each, in turns.
N_CONFIG1, N_CPU_FRESH = 1_000_000, 1 << 20
LOG2M_CPU_COUNTING, N_CPU_COUNTING, N_CPU_DELETES = 24, 1 << 20, 1 << 18
CPU_HOT_KEYS, CPU_HOT_INSERTS, CPU_HOT_DELETES = 16, 20, 18
N_CPU_SCALABLE = 1 << 23
PACK_SIZES, PACK_ROUNDS = (1 << 16, 1 << 23), 5


def pack_turns(keys: list, sizes, rounds: int) -> dict:
    """``pack_keys``'s fast path on the first ``n`` keys for each ``n`` in
    ``sizes``: the lengths and the join it runs whatever the scatter (host
    ms, once), then each scatter, the C++ one (``native.pack_joined``) and
    the numpy one (``scatter_joined``), ``rounds`` rounds, the two in turns
    (the first of a round alternating), host ms; the two outputs held
    equal. A whole pack is the join's ms plus a scatter's."""
    out = {}
    for n in sizes:
        batch = keys[:n]
        t0 = time.perf_counter()
        lens = np.fromiter((len(k) for k in batch), dtype=np.int32, count=n)
        joined = b"".join(batch)
        join_ms = (time.perf_counter() - t0) * 1e3
        runs, made = {"cpp": [], "numpy": []}, {}
        order = (("cpp", native.pack_joined), ("numpy", scatter_joined))
        for r in range(rounds):
            for name, scatter in order if r % 2 == 0 else order[::-1]:
                t0 = time.perf_counter()
                made[name] = scatter(joined, lens, KEY_LEN)
                runs[name].append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(made["cpp"], made["numpy"]), f"the two scatters agree at {n} keys")
        out[str(n)] = {"join_and_lengths_ms": join_ms,
                       **{name: {"scatter_ms": ms, "scatter_median_ms": float(np.median(ms)),
                                 "pack_median_ms": join_ms + float(np.median(ms))}
                          for name, ms in runs.items()}}
    return out


def phase_cpu_ref_path(dev: dict, device: str = "cuda", shrink: int = 0) -> dict:
    """The CPU driver held against the card's kernels (``cpu_ref_path``;
    ``--cpu-ref`` alone), with tolerance 0: the main path's 512 MiB state,
    its presence verdicts and 2^20 fresh keys' verdicts (``blocked_query``)
    between a card ``BlockedBloomFilter`` (the 2^23-key test-and-insert on
    ``blocked_test_insert``) and ``CPUBlockedBloomFilter(use_native=True)``,
    whose ``include_batch`` before each insert gives the pre-batch verdicts;
    the FPR drift between them on the fresh keys (0 exactly) beside
    ``params.blocked_fpr``; BASELINE config 1's words and verdicts between
    the flat ``BloomFilter`` and ``CPUBloomFilter`` (C++ and numpy), with
    each one's insert and query keys/s on the host clock; the flat counting
    filter's counters and verdicts against ``CPUBloomFilter(counting)``;
    the scalable stack's layers, words and verdicts against
    ``CPUScalableBloomFilter``; ``pack_keys``'s two scatters in turns.
    ``device`` and ``shrink`` (every count and m divided by ``2**shrink``)
    serve a rehearsal on the CPU."""
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    where = None if on_card else device  # the card is the filters' default
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(SEED + 33)
    b = B >> shrink
    out = {"card": dev["nvidia_smi"]}

    def launched(names, what):
        counts = {name: n for name, n in sweep.launch_counts().items() if n}
        if on_card:
            for name in names:
                check(counts.get(name, 0) > 0, f"{name} launched on the {what}")
        return counts

    # the main path at full width
    t0 = time.perf_counter()
    cfg = FilterConfig(m=1 << (LOG2M - shrink), k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS)
    first = rows(rng, b)
    second = np.concatenate([first[rng.permutation(b)[: b // 2]], rows(rng, b - b // 2)])
    second = second[rng.permutation(b)]
    batches = [key_list(first), key_list(second)]
    fresh = key_list(rows(rng, N_CPU_FRESH >> shrink))
    keys_s = time.perf_counter() - t0
    sweep.reset_launch_counts()
    f = BlockedBloomFilter(cfg, where)
    t0 = time.perf_counter()
    presence = [f.insert_batch(keys, return_presence=True) for keys in batches]
    sync()
    card_s = time.perf_counter() - t0
    card_fresh = f.include_batch(fresh)
    launches = launched(["blocked_query", *(["blocked_test_insert"]
                                            if on_card and sweep._takes_fused(cfg, b) else [])],
                        "main path's filter")
    c = CPUBlockedBloomFilter(cfg, use_native=True)
    t0 = time.perf_counter()
    cpu_presence = []
    for keys in batches:
        cpu_presence.append(c.include_batch(keys))
        c.insert_batch(keys)
    cpu_s = time.perf_counter() - t0
    cpu_fresh = c.include_batch(fresh)
    for i, (got, want) in enumerate(zip(presence, cpu_presence)):
        check(np.array_equal(got, want), f"batch {i}'s presence verdicts equal the CPU driver's")
    check(not presence[0].any(), "an empty filter holds no key")
    check(f.to_bytes() == c.to_bytes(), "the main path's state equals the CPU driver's")
    check(np.array_equal(card_fresh, cpu_fresh), "the fresh keys' verdicts equal the CPU driver's")
    distinct = b + (b - b // 2)
    drift = float(card_fresh.mean()) - float(cpu_fresh.mean())
    check(drift == 0.0, f"FPR drift vs the CPU driver {drift}")
    out["main_path"] = {
        "config": {"m": cfg.m, "k": cfg.k, "block_bits": cfg.block_bits,
                   "block_hash": cfg.block_hash, "key_len": cfg.key_len},
        "batches": [len(k) for k in batches], "held_in_second": b // 2,
        "state_bytes": cfg.m // 8, "max_abs_err": 0,
        "present_second": int(presence[1].sum()), "fresh_probes": len(fresh),
        "fpr_card": float(card_fresh.mean()), "fpr_cpu_ref": float(cpu_fresh.mean()),
        "fpr_drift_vs_cpu_ref": drift, "distinct_keys": distinct,
        "blocked_fpr_model": blocked_fpr(distinct, m=cfg.m, k=cfg.k, block_bits=cfg.block_bits,
                                         block_hash=cfg.block_hash),
        "card_test_and_insert_s": card_s, "cpu_ref_include_and_insert_s": cpu_s,
        "key_making_s": keys_s, "launches": launches,
        "seconds": time.perf_counter() - t_phase,
    }
    packers = pack_turns(batches[0], [n >> shrink for n in PACK_SIZES], PACK_ROUNDS)
    del f, c, presence, cpu_presence, first, second
    if on_card:
        torch.cuda.empty_cache()

    # BASELINE config 1: the flat filter against the CPU driver, C++ and numpy
    t0 = time.perf_counter()
    cfg1 = FilterConfig(m=M_FLAT_MOD, k=K_FLAT_MOD, key_len=KEY_LEN)
    n1 = N_CONFIG1 >> shrink
    held, probe = key_list(rows(rng, n1)), key_list(rows(rng, n1))
    BloomFilter(cfg1, where).include_batch(held[:64])  # the kernels loaded before the clock
    sweep.reset_launch_counts()
    g = BloomFilter(cfg1, where)
    rec = {}
    t = time.perf_counter()
    g.insert_batch(held)
    sync()
    rec["card"] = {"insert_keys_per_s": n1 / (time.perf_counter() - t)}
    t = time.perf_counter()
    verdicts = {"card": (g.include_batch(held), g.include_batch(probe))}
    rec["card"]["query_keys_per_s"] = 2 * n1 / (time.perf_counter() - t)
    launches1 = launched(["flat_insert", "flat_query"], "config 1 filter")
    words = {"card": g.to_bytes()}
    for name, use_native in (("cpu_ref_cpp", True), ("cpu_ref_numpy", False)):
        h = CPUBloomFilter(cfg1, use_native=use_native)
        t = time.perf_counter()
        h.insert_batch(held)
        rec[name] = {"insert_keys_per_s": n1 / (time.perf_counter() - t)}
        t = time.perf_counter()
        verdicts[name] = (h.include_batch(held), h.include_batch(probe))
        rec[name]["query_keys_per_s"] = 2 * n1 / (time.perf_counter() - t)
        words[name] = h.to_bytes()
        check(words[name] == words["card"], f"config 1's words: {name} equals the card's")
        for got, want in zip(verdicts[name], verdicts["card"]):
            check(np.array_equal(got, want), f"config 1's verdicts: {name} equals the card's")
    check(verdicts["card"][0].all(), "config 1: every held key present")
    out["config1"] = {"m": cfg1.m, "k": cfg1.k, "keys": n1, "max_abs_err": 0,
                      "fresh_hits": int(verdicts["card"][1].sum()),
                      "theoretical_fpr": theoretical_fpr(cfg1.m, cfg1.k, n1),
                      "keys_per_s": rec, "launches": launches1,
                      "seconds": time.perf_counter() - t0}
    del g, held, probe, verdicts, words

    # the flat counting filter: saturation at 15, the floor at 0
    t0 = time.perf_counter()
    cfgc = FilterConfig(m=1 << (LOG2M_CPU_COUNTING - shrink), k=K, key_len=KEY_LEN, counting=True)
    hot = key_list(rows(rng, CPU_HOT_KEYS))
    n_ins, n_del = N_CPU_COUNTING >> shrink, N_CPU_DELETES >> shrink
    held = key_list(rows(rng, n_ins - CPU_HOT_KEYS * CPU_HOT_INSERTS))
    absent = key_list(rows(rng, 4096 >> shrink))
    inserts = held + hot * CPU_HOT_INSERTS
    deletes = held[: n_del - len(absent) - CPU_HOT_KEYS * CPU_HOT_DELETES] + absent \
        + hot * CPU_HOT_DELETES
    sweep.reset_launch_counts()
    cc = CountingBloomFilter(cfgc, where)
    cr = CPUBloomFilter(cfgc)
    steps = {}
    for op, keys in (("insert_batch", inserts), ("delete_batch", deletes)):
        getattr(cc, op)(keys)
        getattr(cr, op)(keys)
        check(cc.to_bytes() == cr.to_bytes(), f"counters after {op} equal the CPU driver's")
        nib = (cr.words[:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
        steps[op] = {"keys": len(keys), "max_counter": int(nib.max()),
                     "saturated_counters": int((nib == 15).sum())}
        for what, probe in (("held", held), ("hot", hot), ("absent", absent)):
            check(np.array_equal(cc.include_batch(probe), cr.include_batch(probe)),
                  f"{what} keys' verdicts after {op} equal the CPU driver's")
    check(steps["insert_batch"]["max_counter"] == 15, "saturation showed")
    launchesc = launched(["flat_counting_update", "flat_counting_query"], "counting filter")
    out["counting"] = {"m": cfgc.m, "k": cfgc.k, "hot_keys": CPU_HOT_KEYS,
                       "hot_inserts": CPU_HOT_INSERTS, "hot_deletes": CPU_HOT_DELETES,
                       "absent_deleted": len(absent), "steps": steps, "max_abs_err": 0,
                       "launches": launchesc, "seconds": time.perf_counter() - t0}
    del cc, cr, held, hot, absent, inserts, deletes

    # the scalable stack at BF.RESERVE key 0.01 4194304 EXPANSION 2
    t0 = time.perf_counter()
    cfgs = FilterConfig(m=BLOCK_BITS, k=1, key_len=KEY_LEN, block_bits=BLOCK_BITS,
                        block_hash="chunk", key_name="scalable")
    cap = SCALABLE_CAPACITY >> shrink
    held = batches[0][: N_CPU_SCALABLE >> shrink]  # the main path's keys and fresh keys again
    sweep.reset_launch_counts()
    sc = ScalableBloomFilter(cap, SCALABLE_ERROR, config=cfgs, growth=SCALABLE_GROWTH, device=where)
    sr = CPUScalableBloomFilter(cap, SCALABLE_ERROR, config=cfgs, growth=SCALABLE_GROWTH,
                                use_native=True)
    sc.insert_batch(held)
    sr.insert_batch(held)
    check(sc.snapshot_meta() == sr.snapshot_meta(), "the stacks' layers equal")
    check(sc.n_layers == 2, f"2^23 keys push two layers ({sc.n_layers})")
    for i, (a, z) in enumerate(zip(sc.layers, sr.layers, strict=True)):
        check(a.to_bytes() == z.to_bytes(), f"layer {i}'s words equal the CPU driver's")
    sample = held[::8]
    verdicts = {}
    for what, probe in (("held", sample), ("fresh", fresh)):
        verdicts[what] = sc.include_batch(probe)
        check(np.array_equal(verdicts[what], sr.include_batch(probe)),
              f"{what} keys' verdicts equal the CPU driver's")
    check(verdicts["held"].all(), "every held key present")
    launchess = launched(["blocked_insert", "blocked_query"], "scalable stack")
    meta = sc.snapshot_meta()
    out["scalable"] = {"capacity": cap, "error_rate": SCALABLE_ERROR, "growth": SCALABLE_GROWTH,
                       "keys": len(held), "layers": [{"m": c["m"], "k": c["k"], "keys": k} for c, k in
                                                     zip(meta["layer_configs"], meta["layer_counts"])],
                       "held_probes": len(sample), "fresh_hits": int(verdicts["fresh"].sum()),
                       "compound_fpr_bound": sc.compound_fpr_bound(), "max_abs_err": 0,
                       "launches": launchess, "seconds": time.perf_counter() - t0}
    del sc, sr, held, fresh, sample, batches
    if on_card:
        torch.cuda.empty_cache()
    out["packers"] = packers
    out["seconds"] = time.perf_counter() - t_phase
    emit("cpu_ref_path", **out)
    return out


def kernels_line(launches, errs, times, c_launches, c_errs, c_times,
                 s_launches, s_errs, s_times, f_launches, f_errs, f_times,
                 k_launches, k_errs, k_times, sk_launches, sk_errs, sk_times) -> list[dict]:
    kernels = []
    for name, src, replaces, lau, err, t in (
        ("blocked_insert", "blocked_bloom.cu", "tpubloom/ops/sweep.py:1463", launches, errs, times),
        ("blocked_query", "blocked_bloom.cu", "tpubloom/ops/sweep.py:2437", launches, errs, times),
        # PRES of K1 (:554) and K3 (`_fat_kernel`, :1463, pallas_call :1723)
        ("blocked_test_insert", "blocked_test_insert.cu", "tpubloom/ops/sweep.py:241", launches, errs,
         times),
        # K4 (fat storage) and K2 (sweep.py:582, logical view): one kernel
        ("blocked_counting_update", "blocked_counting.cu", "tpubloom/ops/sweep.py:1976",
         c_launches, c_errs, c_times),
        # no Pallas counterpart: the XLA gather fat_blocked_counting_membership
        ("blocked_counting_query", "blocked_counting.cu", "tpubloom/ops/counting.py:115",
         c_launches, c_errs, c_times),
        # K1, the sharded per-device insert (tpubloom/parallel/sharded.py:282,292)
        ("sharded_blocked_insert", "blocked_bloom.cu", "tpubloom/ops/sweep.py:241",
         s_launches, s_errs, s_times),
        # K5 inside shard_map (sharded.py:348), the row gather otherwise
        ("sharded_blocked_query", "blocked_bloom.cu", "tpubloom/ops/sweep.py:2437",
         s_launches, s_errs, s_times),
        # K2 (sharded.py:507,525) and K4 (:500) in the sharded counting loop
        ("sharded_blocked_counting_update", "blocked_counting.cu", "tpubloom/ops/sweep.py:582",
         s_launches, s_errs, s_times),
        # the gathers fat_blocked_counting_membership / blocked_counting_membership in shard_map
        ("sharded_blocked_counting_query", "blocked_counting.cu", "tpubloom/ops/counting.py:115",
         s_launches, s_errs, s_times),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpubloom_torch/csrc/{src}",
            "replaces": replaces, "launches": lau[name], "max_abs_err": err[name],
            "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
            "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"],
            "design": DESIGN.get(name, "lane group a key" if name in GROUP_DESIGN else "thread a key"),
            **{k: t[name][k] for k in EXTRA_TIMES if k in t[name]},
        })
    kernels[2]["also_replaces"] = "tpubloom/ops/sweep.py:1463 (`_fat_kernel` with PRES, pallas_call :1723)"
    kernels[2]["two_launch_ms"] = times["blocked_test_insert"]["two_launch_ms"]
    kernels[3]["also_replaces"] = "tpubloom/ops/sweep.py:582"
    kernels[5]["also_replaces"] = "tpubloom/ops/sweep.py:1463 (K3 at tpubloom/parallel/sharded.py:274)"
    kernels[7]["also_replaces"] = "tpubloom/ops/sweep.py:1976 (K4 at tpubloom/parallel/sharded.py:500)"
    for name in (*FLAT_KERNELS, *FLAT_TILED):
        t = f_times[name]
        tiled = name.endswith("_tiled")
        # a counting wrapper's count is its calls; those on the partitioned
        # kernel also count under <name>_tiled
        launches = f_launches[name] - f_launches.get(f"{name}_tiled", 0)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpubloom_torch/csrc/" + FLAT_SOURCE.get(name, "flat_counting.cu" if tiled
                                                               else "flat_bloom.cu"),
            "replaces": FLAT_REPLACES[name.removesuffix("_tiled")], "launches": launches,
            "max_abs_err": f_errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "design": "partitioned by tile" if tiled else FLAT_DESIGN.get(name, "thread a key"),
            **{k: t[k] for k in EXTRA_TIMES if k in t},
        })
    # no Pallas counterpart: numpy on the host in tpubloom (bit reversal and CRC32C)
    kernels.append({
        "name": "payload_crc32c", "route": "cuda", "source": "tpubloom_torch/csrc/checksum.cu",
        "replaces": "tpubloom/utils/crc32c.py:47 (_crc32c_numpy, via tpubloom/checkpoint.py:165 "
                    "_frame) + tpubloom/utils/packing.py:93 (words_to_redis_bitmap)",
        "launches": k_launches["payload_crc32c"], "max_abs_err": k_errs["payload_crc32c"],
        "ms": k_times["ms"], "plain_ms": k_times["plain_ms"], "bound_ms": k_times["bound_ms"],
        "bound_by": k_times["bound_by"], "library_ms": None,
        "library": "none: torch has no CRC32C",
        "design": "a warp a run of 4 KiB chunks (slicing-by-4 in shared memory), one CTA combining",
        "kernels_ms": k_times["kernels_ms"],
    })
    for name, (src, replaces, design) in SKETCH_KERNELS.items():
        t = sk_times[name]
        # a count-min call counts under its name, those on the partitioned
        # update or the row-phased estimate also under that kernel's
        launches = sk_launches[name] - sk_launches.get(COUNTED_WITH.get(name), 0)
        kernels.append({
            "name": name, "route": "cuda", "source": f"tpubloom_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": sk_errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "library": t["library"],
            "design": design,
            **{k: t[k] for k in ("absent_ms", "call_ms", "absent_call_ms", "launch_floor_ms",
                                 "us_per_key", "rounds", "keys_per_round", "ms_per_round",
                                 "warp_latency_floor_ms", "warp_share_of_latency_floor",
                                 "uniform_ms", "uniform_call_ms") if k in t},
            **({"quarter_load_ms": t["quarter_load"]["ms"]} if "quarter_load" in t else {}),
        })
    return kernels


def times_only() -> dict:
    """Phases 5, 9, 14 and (in a tree with the flat layout) 18 and 19 alone, on
    filters filled as the full run fills them before those phases: five
    batches of B in the main filter, one batch in each of the others."""
    rng = np.random.default_rng(SEED)
    f = BlockedBloomFilter(FilterConfig(m=1 << LOG2M, k=K, key_len=KEY_LEN, block_bits=BLOCK_BITS))
    for _ in range(5):
        f.insert_packed(rows(rng, B))
    times = phase_times(f, rng)
    del f
    torch.cuda.empty_cache()
    cf = BlockedCountingBloomFilter(counting_config(LOG2M_COUNTING))
    cf.insert_packed(rows(rng, B_COUNTING))
    c_times = phase_counting_times(cf, rng)
    del cf
    torch.cuda.empty_cache()
    sf = ShardedBloomFilter(sharded_config(LOG2M_SHARDED))
    sg = ShardedBloomFilter(sharded_config(LOG2M_SHARDED), devices=["cuda"] * N_SLOTS)
    first = rows(rng, B_SHARDED)
    sf.insert_packed(first)
    sg.insert_packed(first)
    sfc = ShardedBloomFilter(sharded_config(LOG2M_SHARDED_COUNTING, counting=True))
    sfc.insert_packed(rows(rng, B_SHARDED_COUNTING))
    s_times = phase_sharded_times(sf, sg, sfc, rng)
    out = {"times": times, "counting_times": c_times, "sharded_times": s_times}
    del sf, sg, sfc
    torch.cuda.empty_cache()
    if bitops is not None:
        f = BloomFilter(flat_config())
        f.insert_packed(rows(rng, B_FLAT))
        c = CountingBloomFilter(flat_config(LOG2M_FLAT_COUNTING, K, counting=True))
        c.insert_packed(rows(rng, B_FLAT_COUNTING))
        s1 = ShardedBloomFilter(flat_sharded_config(LOG2M_FLAT_SHARDED))
        s1.insert_packed(rows(rng, B_FLAT_SHARDED))
        sc1 = ShardedBloomFilter(flat_sharded_config(LOG2M_FLAT_COUNTING, counting=True))
        sc1.insert_packed(rows(rng, B_FLAT_COUNTING))
        out["flat_times"] = phase_flat_times(f, c, s1, sc1, rng)
        if TILED:
            out["flat_crossover"] = phase_flat_crossover(f, c, rng)
    return out


def queries_only() -> dict:
    """The sketch path (phase 24), which fills the cuckoo table and the
    count-min grid, then :func:`phase_query_times`."""
    rng = np.random.default_rng(SEED)
    _, cf, cms, held, ids = phase_sketch_path(rng)
    return phase_query_times(cf, cms, held, ids, rng)


AB_TURNS = ("other", "this", "this", "other")


def ab_queries(other: Path) -> None:
    """``--queries`` in ``other`` (with this script copied in), here, here
    and ``other``, each in a process of its own on the same card; the four
    runs to ``chiprun_out/ab_queries.json``, and a line of each run's
    times."""
    here = Path(__file__).resolve()
    shutil.copy(here, other / here.name)
    runs = []
    for label in AB_TURNS:
        tree = other if label == "other" else here.parent
        proc = subprocess.run([sys.executable, here.name, "--queries"], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"--queries in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])["queries"]
        runs.append({"tree": label, "path": str(tree), **run})
        q, e = run["cuckoo_query"], run.get("cms_estimate_rows", run["cms_estimate"])
        emit("ab_queries", tree=label,
             cuckoo_query={k: q[k] for k in ("ms", "absent_ms", "call_ms", "absent_call_ms",
                                             "launch_floor_ms", "share_of_bound")},
             cms_estimate={b: {op: {"ms": r["turns"]["device"][op]["ms"],
                                    "call_ms": r["turns"]["call"][op]["ms"]}
                               for op in r["turns"]["device"]}
                           for b, r in e["batches"].items()},
             l2_resident={b: r["runs"] for b, r in e["l2_resident"].items() if isinstance(r, dict)},
             row_over_l2=e["row_over_l2"]["runs"],
             crossover={d: [{k: v for k, v in r.items() if k.endswith("ms") or k == "keys"}
                            for r in x["runs"]]
                        for d, x in e.get("crossover", {}).items() if isinstance(x, dict)})
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ab_queries.json").write_text(json.dumps(runs, indent=1))


def phase_ab(other: Path, times: bool = True) -> None:
    """``--times`` in ``other`` (with this script copied in), here, here
    and ``other``, each in a process of its own on the same card, unless
    ``times`` is False; the four runs' kernel times, touched counts and
    ptxas lines. Then ``--host`` in ``other`` and here in turns."""
    here = Path(__file__).resolve()
    shutil.copy(here, other / here.name)
    runs = []
    turns = (("other", other), ("this", here.parent), ("this", here.parent), ("other", other))
    for label, tree in turns if times else ():
        proc = subprocess.run([sys.executable, here.name, "--times"], cwd=tree,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode:
            raise RuntimeError(f"--times in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])["times_only"]
        runs.append({"tree": label, "path": str(tree), **run})
        summary = {name: {k: v for k, v in run[phase][name].items()
                          if k in ("ms", "present_ms", "replay_ms", "delete_ms", "sparse_ms", "config2_ms",
                                   "two_launch_ms",
                                   "group_ms", "present_group_ms",
                                   "sparse_delete_ms", "sparse_device_ms", "crowd_ms", "half_full_ms",
                                   "mix_ms", "sparse_host", "share_of_bound")}
                   for phase, name in (("times", "blocked_insert"), ("times", "blocked_query"),
                                       ("times", "blocked_test_insert"),
                                       ("counting_times", "blocked_counting_update"),
                                       ("counting_times", "blocked_counting_query"),
                                       ("sharded_times", "sharded_blocked_insert"),
                                       ("sharded_times", "sharded_blocked_query"),
                                       ("sharded_times", "sharded_blocked_query_4_slots"),
                                       ("sharded_times", "sharded_blocked_counting_update"),
                                       *(("flat_times", n) for n in (*FLAT_KERNELS, *FLAT_TILED)))
                   if name in run.get(phase, {})}
        emit("ab_run", tree=label, kernels=summary)
    hosts = []
    for label, tree in (("other", other), ("this", here.parent)) * AB_HOST_TURNS:
        proc = subprocess.run([sys.executable, here.name, "--host"], cwd=tree,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"--host in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])["host_only"]
        hosts.append({"tree": label, **run})
        emit("ab_host", tree=label, **{name: [{k: v if v is None else round(v, 2) for k, v in r.items()}
                                             for r in rs]
                                       for name, rs in run.items()})
    OUT_DIR.mkdir(exist_ok=True)
    if times:
        (OUT_DIR / "ab_times.json").write_text(json.dumps(runs, indent=1))
    (OUT_DIR / "ab_host.json").write_text(json.dumps(hosts, indent=1))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", action="store_true", help="device, build and the timing phases only")
    ap.add_argument("--ab", type=Path, metavar="DIR",
                    help="--times in DIR, here, here and DIR, then --host in DIR and here in turns; "
                         "writes chiprun_out/ab_times.json and ab_host.json")
    ap.add_argument("--host", action="store_true",
                    help="device, build and the flat counting wrappers' host clock at 2^16 keys only")
    ap.add_argument("--sketch", action="store_true",
                    help="device, build and the sketch phases only; writes "
                         "chiprun_out/chip_smoke_sketch.json")
    ap.add_argument("--server", action="store_true",
                    help="device, build and the gRPC server phase (server_path) only")
    ap.add_argument("--durable", action="store_true",
                    help="device, build and the durable planes' phase (durable_path) only")
    ap.add_argument("--ha", action="store_true",
                    help="device, build and the high-availability phase (ha_path) only")
    ap.add_argument("--cluster", action="store_true",
                    help="device, build and the cluster phase (cluster_path) only")
    ap.add_argument("--distributed", action="store_true",
                    help="device, build and the multi-process phase (distributed_path) only")
    ap.add_argument("--cpu-ref", action="store_true",
                    help="device, build and the CPU driver's phase (cpu_ref_path) only")
    ap.add_argument("--queries", action="store_true",
                    help="device, build, the sketch path and the two query kernels' times only; "
                         "with --ab DIR, those in DIR, here, here and DIR")
    args = ap.parse_args(argv)
    dev = phase_device()
    if args.ab and args.queries:
        ab_queries(args.ab.resolve())
        return 0
    if args.ab:
        phase_ab(args.ab.resolve(), times=not args.host)
        return 0
    phase_build()
    if args.queries:
        print(json.dumps({"queries": queries_only()}), flush=True)
        return 0
    if args.host:
        print(json.dumps({"host_only": host_only()}), flush=True)
        return 0
    if args.server or args.durable or args.ha or args.cluster or args.distributed or args.cpu_ref:
        rng = np.random.default_rng(SEED)
        if args.server:
            phase_server_path(rng, dev)
        if args.durable:
            phase_durable_path(rng, dev)
        if args.ha:
            phase_ha_path(rng, dev)
        if args.cluster:
            phase_cluster_path(rng, dev)
        if args.distributed:
            phase_distributed_path(dev)
        if args.cpu_ref:
            phase_cpu_ref_path(dev)
        OUT_DIR.mkdir(exist_ok=True)
        name = ("chip_smoke_server.json" if args.server else
                "chip_smoke_durable.json" if args.durable else
                "chip_smoke_ha.json" if args.ha else
                "chip_smoke_cluster.json" if args.cluster else
                "chip_smoke_distributed.json" if args.distributed else "chip_smoke_cpu_ref.json")
        (OUT_DIR / name).write_text(json.dumps(RECORD, indent=1))
        print(dev["nvidia_smi"], flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                                  "count": dev["count"]}}), flush=True)
        return 0
    if args.times:
        print(json.dumps({"times_only": {**times_only(), "build": RECORD["build"]}}), flush=True)
        return 0
    if args.sketch:
        rng = np.random.default_rng(SEED)
        _, cf, cms, held, ids = phase_sketch_path(rng)
        phase_sketch_kernel_vs_plain(rng, cf, cms)
        phase_sketch_times(cf, cms, held, ids, rng)
        phase_cms_crossover(cms, ids)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_sketch.json").write_text(json.dumps(RECORD, indent=1))
        return 0
    rng = np.random.default_rng(SEED)
    errs = phase_kernel_vs_plain(rng)
    launches, f = phase_main_path(rng)
    times = phase_times(f, rng)
    phase_test_insert_crossover(f, rng)
    phase_end_to_end(f, rng, times)
    del f
    torch.cuda.empty_cache()
    c_errs = phase_counting_kernel_vs_plain(rng)
    c_launches, cf = phase_counting_path(rng)
    c_times = phase_counting_times(cf, rng)
    phase_counting_end_to_end(cf, rng, c_times)
    del cf
    torch.cuda.empty_cache()
    phase_checkpoint_roundtrip(rng)
    torch.cuda.empty_cache()
    s_errs = phase_sharded_kernel_vs_plain(rng)
    s_launches, sf, sg, sfc = phase_sharded_path(rng)
    s_times = phase_sharded_times(sf, sg, sfc, rng)
    phase_sharded_end_to_end(sf, sg, rng, s_times)
    del sf, sg, sfc
    torch.cuda.empty_cache()
    check(bitops is not None, "tpubloom_torch has the flat layout")
    f_errs = phase_flat_kernel_vs_plain(rng)
    f_launches, ff, fc, fs1, fs4, fsc1 = phase_flat_path(rng)
    f_times = phase_flat_times(ff, fc, fs1, fsc1, rng)
    phase_flat_crossover(ff, fc, rng)
    phase_flat_end_to_end(ff, fc, fs1, fs4, rng, f_times)
    del ff, fc, fs1, fs4, fsc1
    torch.cuda.empty_cache()
    check(checksum is not None, "tpubloom_torch has the stream path")
    k_errs, k_times = phase_checksum_kernel_vs_plain()
    stream = phase_stream_config3()
    check(ScalableBloomFilter is not None, "tpubloom_torch has the scalable filter and sketches")
    phase_scalable_path(rng)
    sk_launches, cf, cms, held, ids = phase_sketch_path(rng)
    sk_errs = phase_sketch_kernel_vs_plain(rng, cf, cms)
    sk_times = phase_sketch_times(cf, cms, held, ids, rng)
    phase_cms_crossover(cms, ids)
    sk_errs = {name: max(err, sk_times[name]["max_abs_err"]) for name, err in sk_errs.items()}
    del cf, cms
    torch.cuda.empty_cache()
    phase_server_path(rng, dev)
    phase_durable_path(rng, dev)
    phase_ha_path(rng, dev)
    phase_cluster_path(rng, dev)
    phase_distributed_path(dev)
    check(native is not None, "tpubloom_torch has the CPU driver")
    phase_cpu_ref_path(dev)
    kernels = kernels_line(launches, errs, times, c_launches, c_errs, c_times,
                           s_launches, s_errs, s_times, f_launches, f_errs, f_times,
                           stream["with_sink"]["launches"], k_errs, k_times,
                           sk_launches, sk_errs, sk_times)
    RECORD["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                              "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
