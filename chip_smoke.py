#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Environment: torch, CUDA, nvcc, Triton and the card (nvidia-smi); then
   the four CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one nvcc each, started together).
2. Kernel vs plain version on the card, bit for bit: ``recovery_scan`` on
   random legal stages at N = 2^21, 2^23, 2^21 + 3, 8 (a padded delta)
   and 2^16 (the queue's ring), then its wrapper's host cost by part; the
   bucket lookup at NB = 2^19, W = 8 over a table that ``build_buckets``
   filled from a real pool, B = 1024 and 65536, and at one shard's
   (2^18 slots, B = 256), half present keys and half absent:
   ``hp_lookup`` whole (one launch, the kernel hashing each key), the
   kernel hashing and the kernel reading given buckets.  Each kernel's
   median time (L2 flushed between launches), its plain version's time,
   the timing floor (an empty launch) and its bound from bytes moved at
   3.35 TB/s; the lookup's device and back-to-back wall ms, and its host
   cost by part.  Then the hashed entry's edges, the card tests whose
   names hold "hashed_probe" (NB 24, 64 and 1000; W 1, 3, 8 and 16; B 1,
   7 and 257; unaligned tables; the map's table at B 65536).  Then both
   kernels again at the shapes the serving registry gives them:
   ``recovery_scan`` over its pool of 1024 slots, ``hash_probe`` at the
   bucket geometry of its SOFT 1024-slot spec (NB 256, W 8) with B = 8,
   half present and half absent, over a table holding 8 keys (the served
   requests) and one holding 1024 (a full registry).
   ``python3 chip_smoke.py --bucket-scan`` runs phase 1 and the
   ``recovery_scan`` and bucket parts alone, to time two trees of these
   kernels in turns (``tools/bucket_scan_tuning.py`` times the bucket
   kernel's block sizes and reads both kernels' loads in flight from
   their SASS).
   Then ``hash_probe``'s probe-window entry (``table_probe``, the probe
   backend's lookup) against its plain version, integers equal: on the
   table of a 2^21-slot probe map (T = 2^23, 2^19 members, built by
   recovery's ``table_build``, timed) at B = 1024 and 65536, where it also
   equals the first-match lookup; on small arbitrary tables whose windows
   wrap past T - 1 and with TOMBs and full 128-slot chains, at B = 1, 7
   and 8 and max_probe 5, 128 and 200; untimed, at the kernel's edges
   (T 4, 8, 256 and 1024; B 1, 3, 5 and 257; max_probe 1, 3, 5, 127, 128,
   129 and 200; every window offset mod 4); at the serving registry's
   shape (1024 slots, B = 8); and at one shard's (T 2^20, B = 256).  Each
   at max_probe 128 timed beside its plain version, the TPU route carried
   over literally (window gather + ``hash_probe`` at W = 128) and the
   timing floor (an empty spin).  Then the wrapper's host cost by part.
   ``python3 chip_smoke.py --probe-window`` runs phase 1 and this part of
   phase 2 alone (to time two trees of the kernel in turns).
3. Main path: the paper's hash-set experiment (key range 2^20, 90% reads)
   on a bucket-backend ``DurableMap`` of 2^21 slots in SOFT mode.  Prefill
   2^19 keys, 200 mixed batches of 1024 lanes, crash, recover, 20 more
   batches; every result, the size, the psync and op counters, the recovery
   histogram and the full key range's membership are held against a host
   reference that follows the same linearization; a profiled window of 10
   batches and 10 more counting host syncs.  The kernels' launch
   counts are zeroed before this phase and must both be > 0 after it.
   Then a shorter run at 2^16 slots in the link-free and log-free modes.
   Then the same on the probe backend, the paper's own index for this
   experiment (``configs/paper.py`` ``HASH_1M``), where the probe-window
   kernel and ``recovery_scan`` must be launched, and the recovery's table
   rebuild is timed alone; link-free and log-free at 2^16 slots.  Then
   the paper's list experiment (``LIST_LONG``: 2048 slots, key range 1024,
   64 lanes, 90% reads) on the scan backend in all three modes.
3b. Snapshot + delta-log hybrid recovery: ``recovery_scan`` against its
   plain version at the padded delta lengths 8, 64, 4096 and 2^16; then
   the hash-1M bucket map (2^21 slots, SOFT, NB 2^19, W 8, stash 128):
   prefill 2^19 keys, a snapshot through ``Snapshotter`` into a temporary
   directory (its capture timed on the hot path, 20 batches timed while
   its build and save run in the background), 200 mixed batches in all,
   a crash, and ``Snapshotter.recover``, held leaf for leaf and by
   histogram against ``crash_and_recover`` of a copy of the same
   pre-crash state, the whole key range against the host reference, and
   20 more batches; host syncs by site in the recovery; recovery psyncs
   0; ``recovery_scan`` launched once by the recovery; then each piece
   of the recovery timed alone (store read, H2D of the planes, delta
   discovery, ``recovery_scan`` on the delta, ``hybrid_recover``, the
   bucket patch, the histogram).  The same with the snapshot taken
   before the prefill (the delta most of the pool, the patch's
   whole-pool branch), and the list-1024 scan map once.  Then the
   port's serve CLI on the card with ``--backend bucket --snapshot-every
   1 --crash`` at qwen3-32b-smoke.  The kernels' launch counts are
   zeroed before the hash-1M hybrid run and read after it
   (``launches_hybrid`` in the JSON record).
3c. The sharded map, ``ShardedDurableMap`` with 8 shards at the hash-1M
   geometry (2^21 slots in all, 2^18 per shard; key range 2^20, 2^19 keys
   prefilled in batches of 8192, 50 mixed batches of 1024 lanes, a crash
   under a seeded per-shard adversary, recovery, 20 more batches), on the
   bucket backend (snapshotted through ``Snapshotter`` after the prefill
   and recovered through it, every leaf held against the full recovery of
   a copy of the same pre-crash state) and on the probe backend: every
   result, the size, the psyncs and ops, the summed and per-shard
   histograms and the whole key range against the host reference, no lane
   dropped, ``recovery_scan`` once per shard per recovery, the lookup
   kernel's launches per batch printed.  Before them the three kernels
   against their plain versions at one shard's shapes (N = 2^18; NB 2^16,
   W 8; T 2^20; B 256, the lane budget a 1024-lane batch routes to each
   shard), timed (``shard_shape`` in the JSON record).  Then the same
   traffic at equal total capacity (15 batches) on the flat bucket map,
   one shard and 8 shards: ops/s, device operations per batch and busy
   share (profiled), host syncs per batch by site, the v2 router's
   stage-1 host ms per batch, recovery ms.
   Then a capped v2 router (``max_lane_budget`` 64, strided, 2 groups) and
   the v1 router over 10 batches each: drop masks equal to the host rule,
   psyncs equal to the successful updates.  Then the serve CLI with
   ``--shards 8 --crash``, and again with ``--backend bucket
   --snapshot-every 1``; then the card tests of
   ``tests/test_torch_cuda.py`` whose names hold "sharded", in a child
   process.  Launch counts are zeroed before each sharded run and read
   after it (``launches_sharded`` in the JSON record).
3c2. The sharded map over several processes (``use_shard_map`` in a
   ``torch.distributed`` group, ``repro_torch.launch.mesh``): 4 ``gloo``
   ranks started by ``mesh.spawn`` share the card, each holding 2 of the 8
   shards.  At phase 3c's geometry (8 shards of 2^18 slots, key range
   2^20, 2^19 keys prefilled in batches of 8192, 50 mixed batches of 1024
   lanes at 90% reads, a crash under a seeded adversary and recovery, 10
   more batches), on the bucket backend (a ``Snapshotter`` snapshot after
   the prefill, recovered through it) and on the probe backend: every
   result, the psyncs, ops, size and per-shard recovery histogram of each
   rank, and each rank's rows of every state leaf, held bit for bit
   against a one-process ``ShardedDurableMap`` of the same spec fed the
   same batches on the card; each rank's launches of its path's kernels
   (zeroed in the rank before the run) > 0 (``launches_mesh`` in the JSON
   record); ops/s of the 50 batches for both, the 4 processes sharing
   one card (not a scaling figure).
3d. The durable queue (``DurableQueue``): ``recovery_scan`` against its
   plain version at N = 2^16 and 2^21, timed; ``bench_queue.py``'s steady
   state, a 65536-slot ring with 1024-lane batches in each of SOFT,
   link-free and log-free: 50 rounds of one enqueue and one dequeue
   through the facade (ops/s, every dequeued value against a host
   ``collections.deque``, psyncs per successful op exactly 1, 1 and 2),
   the same rounds through the functional ops with no host read (ops/s),
   host syncs per round by site and device operations per round from a
   profiled window; ``bench_queue.py``'s failed-op probe (0 psyncs).
   Then a backlog of 2^21 slots (8192-lane batches: the ring filled,
   half drained, enqueued past N, drained again), a crash under a
   seeded float32 adversary and recovery: every leaf against the plain
   path's recovery of the same planes, the histogram, head and tail,
   recovery psyncs 0, ``recovery_scan`` launched once, recovery ms (first
   call and warm repeats); a snapshot through ``Snapshotter``, more
   traffic, a crash and ``Snapshotter.recover`` against the full recovery
   of a copy of the same state (``recovery_scan`` once, on the delta;
   the delta's size and both recoveries' ms); every surviving value
   drained and checked.  Then the serve CLI's spine at qwen3-32b-smoke:
   ``--queue --crash``, ``--queue --backend bucket --snapshot-every 1
   --crash`` and ``--shards 8 --pipeline 2 --queue --crash``, each with 3
   spine psyncs per request plus the registry's 1 and ``recovery_scan``
   once per recovered structure (and per snapshot build); then the card
   tests whose names hold "queue", in a child process.  Launch counts are
   zeroed before each queue run and read after it (``launches_queue`` in
   the JSON record).
3e. Online resize (``ElasticShardedMap``) at the hash-1M geometry: 4
   bucket shards of 2^18 slots (SOFT, router v2), 2^19 keys prefilled in
   batches of 8192 (fill 0.5), ``migrate_chunk`` 4096.  10 mixed batches
   of 1024 lanes (90/5/5, key range 2^20), then an online split to 8
   shards (phase 3c's 2^21 slots) with one ``step()`` per batch: 4 units
   of 64 chunks and a commit, 260 batches, every result, the size and the
   counters against the host reference, hot psyncs equal to the
   successful updates, migration psyncs exactly 1 + 4*64 + 4*2 + 1 = 266,
   each commit's moved nodes equal to its parent's live keys; 10 batches
   after; ops/s before, during and after.  The 8-shard map snapshotted
   through ``Snapshotter`` and loaded by ``load_resharded`` at 4 and 16
   shards: every leaf equal to a full recovery at 8 resharded offline
   (``reshard_planes`` + ``shard.recover``), the whole key range, recovery
   psyncs 0, ``recovery_scan`` once per new shard, ms.  A blocking merge
   back to 4 (content kept, ms), a blocking split of the filled map
   against the offline ``split_planes`` + ``shard.recover`` leaf for
   leaf (ms, migration psyncs per node), a merge, and crash drills in a
   stepped split (right after ``begin_split``, mid-copy of unit 0, right
   after unit 1's commit, after the finalize): recovery psyncs 0, the
   whole key range, ``recovery_scan`` once per shard of both maps; host
   syncs per chunk step and per commit step by site.  The probe backend:
   a blocking split of the same filled map and 20 batches, the children's
   table rebuild timed alone.  ``begin_merge`` refusing a pair that does
   not fit.  The serve CLI with ``--shards 2 --autosplit 0.001 --crash``
   (and with ``--queue``): the split fires and completes, every
   completion survives the crash, recovery psyncs 0.  Then the card tests
   whose names hold "resize" or "elastic".  Launch counts are zeroed
   before each run and read after it (``launches_resize`` in the JSON
   record).
3e2. Online resize over several processes: ``ElasticShardedMap(...,
   use_shard_map=True)`` in 4 ``gloo`` ranks sharing the card, against
   one process running the same calls.  2 shards (bucket: 2^18 slots a
   shard, 2^18 keys prefilled from hash-1M's key range 2^20; probe:
   2^16 and 2^16, its children rebuild their tables at each commit)
   split online to 4 (D 2 -> 4: rows move between ranks) and to 8, one
   ``step()`` per 1024-lane 90/5/5 batch, ``migrate_chunk`` 16384; merged
   to 4 and 2 by steps; a crash mid-split 2 -> 4 and the split finished;
   on bucket, ``load_resharded`` of a snapshot of the 4-shard map at 2
   and 16 shards.  Every result, the counters and each leaf row (by
   digest) at every checkpoint, the crash's histogram and each load,
   on every rank against one process; each rank's launches, zeroed in
   the rank before its run, > 0 (``launches_mesh_resize`` in the JSON
   record); each rank's median ms per copy step and per commit step and
   the part of it in the ``gloo`` collectives.

4. Attention kernels against their plain versions on the card, in f32 and
   bf16 at the JAX tests' tolerances: ``gqa_decode`` at qwen3-32b's decode
   shape (B 8, H 64, KV 8, D 128, S 544, random lengths in [1, 544]; in
   bf16 also lengths 544 and 1) and at B 2, H 32, KV 8, D 120, S 300;
   ``flash_prefill`` at qwen3-32b's prefill shape (B 8, S 512, H 64, KV 8,
   D 128, causal) and at B 2, S 300, H 32, KV 8, D 120 with window 128.
   Each with its time, its plain version's,
   ``scaled_dot_product_attention``'s (the yardstick, which the port never
   calls) and its bound from bytes at 3.35 TB/s or operations at the
   card's peak for the type, whichever is larger; in bf16 the library
   call's own error against the plain version is printed beside the
   kernel's, and the kernel's may not exceed it.  ``gqa_decode`` also
   prints its split plan and its wrapper's time per call back to back.
   Then ``gqa_decode`` over edge shapes in both types (lengths 0, 1, S-1,
   S, S+5 and random; S 1 to 4096; G 1, 8 and 16; D 8 to 256;
   h2o-danube-3-4b's H 32, KV 8, D 120, S 4096; and the model families'
   G 6, 7 and 10 with one KV head at D 128 and 256, and D 96 at G 1), and
   ``flash_prefill`` in bf16 over a grid of edge shapes (D 8, 16, 64, 120,
   128, 256; S 1, 63, 65, 129, 300; window 0, 5, 16, 100; G 1 and 8) and
   at h2o-danube-3-4b's own shape (S 512, H 32, KV 8, D 120, window
   4096), then in f32 and bf16 at the families' head shapes (the same G
   and D, windows 0 and 100, and recurrentgemma-2b's window 2048 over S
   2304).
   Both serving-shape times are printed beside the designs they replaced.
5. Decode agrees with prefill at qwen3-32b's full width, 2 layers, f32:
   the logits of one decode step at position 511 equal the last-position
   logits of a prefill over 512 tokens.
5b. Decode over a sequence-sharded KV cache (``run_mesh_decode_phase``):
   4 ``gloo`` ranks sharing the card on (data, model) grids (1, 4) and
   (2, 2), each rank holding its block of decode_32k's 32768-slot cache
   (``make_shard_ctx``, ``init_cache(..., ctx=)``) and its rows of B 4,
   with whole bf16 weights from the seed: qwen3-32b at full width, 2
   layers, an 8180-token prompt and 16 greedy decode steps across slot
   8192; h2o-danube-3-4b at full width, 2 layers, its 4096-slot window
   ring wrapped by a 4090-token prompt and 16 steps.  The ranks decode
   one process's greedy tokens; each step's logits against that
   process's ``decode_step`` on the same seed (within 3e-2 of the
   largest logit), each rank's greedy token the process's wherever the
   process's top-2 margin exceeds twice the step's largest difference
   (its bf16 logits hold exact ties), each rank's KV bytes the one
   process's over the ranks sharing them, ``flash_prefill`` launched
   once a layer in each rank's prefill and ``gqa_decode`` never in its
   decode (the combine is plain PyTorch); ms a decode step by rank, the
   part of it in ``gloo`` collectives, cache MiB by rank.  Then
   ``compressed_psum`` over the 4 ranks on card tensors against CPU
   tensors, 8 steps of error feedback, bit for bit.  The recurrent
   kinds too, on both grids: recurrentgemma-2b at published width, one
   period of 3 layers (rglru, rglru, attn), its RG-LRU state split over
   its 2560 channels and its 2048-slot local window on the sequence
   split, wrapped by a 2090-token prompt; xlstm-350m, one period of 2
   layers (mlstm, slstm), its sLSTM ``h`` split over the 1024 units, a
   1024-token prompt; 16 steps each, held as above, with each rank's
   state blocks gathered after the last step against one process's
   states (within 3e-2 of each leaf's largest magnitude) and
   ``flash_prefill`` launched once per attention layer in prefill.
6. The serving path: ``repro_torch.launch.serve.run`` with qwen3-32b at
   full width and depth (64 layers, bf16, random weights from a seed), 8
   requests of 512 prompt tokens and 32 generated, then a crash of the
   registry and its recovery.  Every completion registered at one psync
   each and still registered after recovery at zero recovery psyncs;
   every launch count of the path checked (``flash_prefill`` once per
   layer, ``gqa_decode`` once per layer and decode step, the registry's
   probe-window lookup and ``recovery_scan`` at least once); prefill ms,
   decode ms per step, tok/s, peak memory, the device's busy share of a
   warm profiled prefill with ``flash_prefill``'s share of it, and the
   busy share over a profiled window of decode steps with
   ``gqa_decode``'s microseconds per step.  Then the same model with the
   durable request/completion spine (``serve.run(..., queue=True)``, the
   first run's weights, ``--crash``): 4 psyncs per completion (ack,
   response, registry, commit), the late acks redelivered and committed
   after the crash, recovery psyncs 0 in all three structures,
   ``recovery_scan`` once per recovered structure, and the spine's ack,
   record and commit host ms beside generation; and once more in 4
   pipelined waves over an 8-shard registry (``shards=8, pipeline=2``),
   printing whether each wave's ack finished while the previous wave
   still generated (``launches_serving_spine`` in the JSON record).
7. The open-loop serving harness (``repro_torch.launch.bench_serve``) at
   the JAX package's default geometry (``ServeConfig``): a 2^20-slot SOFT
   probe registry over 8 shards, Zipf(1.1) keys over 4,000,000, a
   50/25/25 read/update/delete mix, 1024-lane batches, two 4096-slot
   queues.  (a) ``bench_serve.main`` at those defaults with ``--duration
   30 --utilization 0.6`` (the one cut: 30 s for the default 60) and its
   ``--out`` in a temporary directory: no ack rejected, no short commit,
   no drop, no overflow latch, exactly one psync per queue op, the
   registry's psyncs per op within the update share, the payload's meta
   naming this card and its power limit; offered rate, ops/s, latency
   p50/p99/p999, the spans and the backlog printed.  (b) ``--quick
   --backend bucket --duration 5 --utilization 0.5,0.9``: the sweep and
   its knee, ``hash_probe`` launched.  (c) A crash drill: the spine built
   by ``_build_spine`` at the defaults, 20 rounds of the arrival stream
   (some padded with OP_NOP) through ``_spine_round``, every registry lane
   against the host reference, then 4 rounds counting host syncs by site
   and 4 under the profiler (the device's busy share); a crash and
   recovery of the registry and both queues: the whole key range against
   the reference, recovery psyncs 0, both queues empty with their cursors
   at the acked count, ``recovery_scan`` launched 10 times.  Then the card
   tests whose names hold "open_loop" or "bench_serve".  Launch counts
   are zeroed before each run and read after it (``launches_open_loop``
   in the JSON record).
8. The model families at their published widths, bf16, random weights
   from a seed.  First both attention kernels against their plain
   versions at each family's serving shape (B 8, S 512: mixtral-8x22b H
   48 / KV 8 / D 128, window 4096; arctic-480b H 56 / KV 8; qwen1.5-110b
   H 64 / KV 8; minicpm3-4b's MLA prefill H 40 / KV 40 / D 96;
   recurrentgemma-2b H 10 / KV 1 / D 256, window 2048), each timed beside
   its plain version and ``scaled_dot_product_attention``.  Then
   ``serve.run`` with 8 requests of 512 prompt tokens and a crash of the
   registry for each family: mixtral-8x22b (MoE, 12 of 56 layers, 56.7
   GiB, 32 generated tokens, its warm prefill and 4 decode steps
   profiled: decode ms per step against the weight-stream bound, the
   busy share, device operations per layer), arctic-480b (MoE with 128
   experts and a dense residual FFN, 2 of 35 layers), qwen1.5-110b (QKV
   bias, 20 of 80 layers), and minicpm3-4b (MLA), xlstm-350m (mLSTM and
   sLSTM) and recurrentgemma-2b (RG-LRU and local attention) at full
   depth, 16 generated tokens each.  Each: tokens in range, finite
   logits, 1 psync per request and 0 in recovery, ``flash_prefill``
   launched once per attention or MoE layer (MLA included), ``gqa_decode``
   once per GQA layer and decode step (none for MLA and xlstm).  Then
   decode against prefill at each family's full width in f32 (2 layers;
   arctic-480b 1, recurrentgemma-2b one 3-layer period; xlstm-350m at S
   255, one mLSTM chunk), and the card tests whose names hold "family".
   Launch counts are zeroed before each run and read after it
   (``launches_families`` in the JSON record, the kernels' rows at the
   families' shapes under ``family_shapes``).
9. The vlm and audio front ends (``run_frontends_phase``), bf16, random
   weights from the seed.  First the kernels at the shapes they give,
   each against its plain version and timed beside
   ``scaled_dot_product_attention`` with the boolean mask of the same
   positions: ``flash_prefill`` by positions at qwen2-vl-2b's (8, 512,
   12/2, 128) with the image layout's temporal positions, at whisper-base's
   encoder (8, 1500, 8/8, 64, every pair live) and cross-attention (Sq
   64, Sk 1500); ``gqa_decode`` at G 1, D 64 over 96 and 1500 slots; the
   index path at whisper's decoder shape; then 240 edge shapes by
   positions in f32 and bf16 (random positions with rows that have no
   live key, repeats, Sq != Sk, windows).  Then qwen2-vl-2b at all 28
   layers: ``serve.run`` of 8 x (512 + 16) token prompts at the default
   M-RoPE positions with a crash of the registry; a model-level prefill
   of 8 rows of 512 embeddings at Qwen2-VL's M-RoPE positions of 64 text
   tokens, a 16 x 16 image and 192 text tokens (the positions path), and
   16 decode steps.  Then whisper-base (6 + 6 layers) over 8 x 1500 frame
   embeddings, a 64-token prompt and 32 generated, through
   ``make_serve_steps``, twice.  Each run: tokens in range, finite
   logits, ``flash_prefill`` launched ``attention_layers`` times in
   prefill (28; whisper 18: 6 encoder, 6 self, 6 cross) and
   ``gqa_decode`` ``decode_attention_layers`` times per decode step (28;
   whisper 12), counted apart for prefill and decode; prefill and decode
   ms against the weight-stream bound, profiled busy shares.  Then
   decode against prefill in f32 at 2 layers of each (whisper on the
   same frames), and the card tests whose names hold "frontend"
   (``launches_frontends`` and ``frontend_shapes`` in the JSON record).

10. Training (``run_training_phase``): ``launch/train.py``'s train step
   at h2o-danube-3-4b's full width and depth (24 layers, d_model 3840,
   bf16 params, f32 AdamW, remat "full", random weights from the seed)
   on one fixed ``SyntheticTokens`` batch of 4 x 2048 tokens, AdamW at lr
   3e-4 (warmup 1, cosine over 10): 2 warm steps and 8 timed, each
   synchronized; the loss finite and ending below its first value, the
   grad norm > 0, the params changed, ``flash_prefill`` and
   ``gqa_decode`` launched 0 times (training attention is
   ``attention_dense``, plain PyTorch under autograd); ms a step,
   tokens/s, peak memory against the state's bytes, ``train_mfu`` (6 x
   params x tokens over the step at the bf16 dense peak) and the busy
   share of one profiled step.  Then ``launch/train.py``'s main at the
   same width for 2 steps (a finite loss printed).  Then
   ``launch/train.py`` on the card at
   h2o-danube-3-4b-smoke, 20 steps saved every 5, crashed at 10 and
   resumed: the final checkpoint within 1e-5 of each leaf's largest
   magnitude of an uninterrupted run's; then the card tests whose names
   hold "train" (``launches_training`` in the JSON record, the step's
   numbers on the ``training`` line before it).
10b. The sharded train step (``run_mesh_train_phase``): phase 10's model
   at full width, 2 of its 24 layers, the same 4 x 2048 batch (seeded),
   2 steps.  One process runs them first, after step 1's gradients; then
   4 ``gloo`` ranks sharing the card run the same on (data, model) grids
   (2, 2) and (4, 1), each rank holding its blocks of the params, m and v
   by ``param_pspecs`` (``shard_train_state``) and its rows of the batch
   by ``batch_pspecs``.  Against one process's: each rank's losses and
   grad norms (1e-3 relative), step 1's gradients gathered (each leaf
   within 5e-2 of its largest magnitude), and its blocks gathered after
   the steps (at most a tenth of the elements moved by more than lr / 10;
   each element p within the sanity bound 2 x steps x lr x (1 + wd |p|)
   plus steps x 2^-7 |p|, which any gradient passes); ``wq`` a different
   1/4 of the leaf on each rank; ``flash_prefill`` and ``gqa_decode``
   never launched; ms a step by rank and the ms of each step in the
   mesh's ``gloo`` collectives, the collectives a step, peak device
   memory and params + m + v bytes by rank against one process's.
   ``python3 chip_smoke.py --mesh-train-control`` runs this phase alone
   on (2, 2) (then phase 10c's mixtral), clean and then with two planted
   faults (``planted``: the gradients' sum over the batch's rows left
   out; the norms' gradients summed over model), each of which must fail
   a check besides the sanity bound on every rank.
10c. The sharded train step of the moe kind and MLA
   (``run_mesh_tp_phase``): mixtral-8x22b at published width, 1 of 56
   layers (its 8 experts split on their width over model), and
   minicpm3-4b, 2 of 62 layers (MLA's heads over model), phase 10b's 4 x
   2048 batch, 2 steps, on 4 ``gloo`` ranks sharing the card as (2, 2),
   against one process.  The param figures first, from the defs
   (``reckoning``: the params a layer and the rest, params + m + v whole
   and a rank's, a layer gathered whole on data).  One process runs the
   2 steps, its gradients of step 1 watched at ``adamw.update``
   (``step_grads``) and its routing tapped (``routed``); the ranks map
   its params and gradients (CUDA IPC through the spawn) and read their
   blocks there.  Each rank: its blocks of the seed's params (m and v
   zeros), the routing of step 1's forward counted against one
   process's (assignments and kept lanes differing), then one process's
   routing fed to every call (a flip from the bf16 rounding of the
   row-parallel sums changes a token's whole expert output), 2 steps:
   step 1's gradients, its blocks, within 5e-2 of each leaf's largest;
   step 1's loss and grad norm within 1e-3 of one process's; step 2's
   within 1e-3 of one process's rerun from the params the ranks copy out
   after step 1 (``rerun_steps``; AdamW's first steps turn the ranks'
   rounding into moves of up to lr); the params after the steps at most
   a tenth of the elements moved by more than lr / 10 (and the sanity
   bound); every leaf of params, m and v the rank's block by
   ``param_pspecs``, ``moe/wi`` (``attn/wq_b``) a different block on
   every rank that splits it; ``flash_prefill`` and ``gqa_decode`` never
   launched.  Printed: ms a step by rank and its part in ``gloo``, the
   collectives a step, each step's gradient norm by leaf against one
   process's, peak device memory and params + m + v by rank, the phase's
   seconds by part.  ``--mesh-train-control`` also runs mixtral alone
   with the MoE router's gradient summed over model (planted "router"),
   which must fail a check besides the sanity bound on every rank.
10d. The same for the recurrent kinds (``run_mesh_tp_phase`` with
   ``MESH_REC``): xlstm-350m, 2 of 24 layers (mLSTM's 4 heads, 2 a rank;
   sLSTM whole on every rank from its gathered weights, its widths of
   1365 whole on model), on 4 x 1024 tokens (its serial loop is slow:
   the printed reason), twice: in its bf16, where one process first
   measures how far its own step-1 gradient moves when the 4 rows are
   summed in 2 and in 4 pieces (``split_spread``: sLSTM's recurrence
   sums ``w_h``'s gradient over the time steps in bf16) and the ranks'
   gradient limit on a leaf is twice that where it passes 5e-2, and in
   f32, every leaf held to 5e-2; and recurrentgemma-2b, 3 of 26 layers
   (RG-LRU's 2560 channels, 1280 a rank; 10 query heads, 5 a rank; its
   one KV head split mid-head, 128 columns a rank), bf16 on phase 10c's
   4 x 2048 batch, all at published width on (2, 2), 2 steps, phase
   10c's checks and prints (``mix/w_x`` a different quarter on each
   rank).  ``--mesh-train-control`` also runs xlstm-350m's f32 run and
   recurrentgemma-2b with a planted fault each: "mlstm_gates" (mLSTM's
   copy moved from the gates' logits onto z) and "rglru_gate" (the copy
   taken off RG-LRU's gathered gate input), each of which must fail a
   check besides the sanity bound on every rank.
   The line before the card's name gives the whole run's seconds.

The last two lines are the per-kernel JSON record (``hash_probe``'s entry
carries its probe-window route under ``probe_window``) and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import paper  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import (DurableMap, SetSpec, OP_CONTAINS,  # noqa: E402
                              OP_INSERT, OP_NOP, OP_REMOVE, VALID, EMPTY,
                              TOMB, DurableQueue, QueueSpec,
                              ElasticShardedMap, ResizeCapacityError,
                              ShardedDurableMap, hash32, reshard_planes,
                              split_planes)
from repro_torch.core import durable_set as DS  # noqa: E402
from repro_torch.core import queue as TQ  # noqa: E402
from repro_torch.core import router as RT  # noqa: E402
from repro_torch.core import shard as SH  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.nvm import np_hash32  # noqa: E402
from repro_torch.core.resize import PLANES  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_prefill.kernel import (  # noqa: E402
    flash_prefill_cuda)
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_prefill_ref)
from repro_torch.kernels.gqa_decode.kernel import (  # noqa: E402
    gqa_decode_cuda, split_plan)
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import (  # noqa: E402
    _lib, probe_cuda, table_probe_cuda)
from repro_torch.kernels.hash_probe.ops import (bucket_of,  # noqa: E402
                                                build_buckets)
from repro_torch.kernels.hash_probe.ops import (  # noqa: E402
    lookup as hp_lookup)
from repro_torch.kernels.hash_probe.ref import (  # noqa: E402
    table_lookup_ref, window_rows)
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import bench_serve, mesh, serve  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import (attention_layers,  # noqa: E402
                                       decode_attention_layers)
from repro_torch.models.moe import capacity as moe_capacity  # noqa: E402
from repro_torch.models.params import (param_count,  # noqa: E402
                                       tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.store.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.store.snapshot import (Snapshotter,  # noqa: E402
                                        SnapshotPolicy, load_resharded)
from repro_torch.train import steps as TS  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# dense peaks of the H100 SXM: bf16 on the tensor cores, f32 on the CUDA
# cores (the attention kernels compute f32 inputs on the CUDA cores)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0
KERNELS = ("recovery_scan", "hash_probe", "gqa_decode", "flash_prefill")
SPIN_CYCLES = 2_000_000            # ~1 ms of device spin ahead of a timed call
N_INFLIGHT = 20                    # batches timed while a snapshot builds


def expect(ok, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# 1. environment and build
# ---------------------------------------------------------------------------

def environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print("nvcc: " + sh([_build.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(fn, dev, reps: int = 50) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` calls.  On the
    card each call is bracketed by CUDA events, with the 50 MB L2 flushed
    before it (the callers read state written long before) and the stream
    held busy by a spin kernel while the host enqueues the call, so the
    events see the device work and not the host's enqueue; on the CPU the
    host clock."""
    fn()
    times = []
    if dev.type == "cuda":
        flush = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def wall_ms(fn, dev, reps: int = 50) -> float:
    """Host milliseconds per call of ``reps`` back-to-back calls and one
    synchronization: what a caller pays, enqueue included."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def timing_floor(dev) -> float:
    """Device ms of an empty launch (a one-cycle spin), timed as
    ``time_ms`` times a kernel: the least time a launch shows."""
    return time_ms(lambda: torch.cuda._sleep(1), dev)


def check_scan(dev, sizes):
    """recovery_scan kernel vs plain at each N; returns the JSON fields
    measured at the first (main-path) size, with the timing floor and,
    given several sizes, each size's kernel ms."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, row, by_n = 0, None, {}
    floor = timing_floor(dev)
    for n in sizes:
        stages = torch.randint(0, 5, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        mask, hist = scan_cuda(stages)
        mask_p, hist_p = scan_ref(stages)
        e = max(int((mask.int() - mask_p.int()).abs().max()),
                int((hist - hist_p).abs().max()))
        expect(e == 0, f"recovery_scan differs from plain at N={n}")
        expect(int(hist.sum()) == n, f"recovery_scan histogram sum at N={n}")
        err = max(err, e)
        ms = time_ms(lambda: scan_cuda(stages), dev)
        plain = time_ms(lambda: scan_ref(stages), dev)
        wall = wall_ms(lambda: scan_cuda(stages), dev)
        bound = bytes_ms(5 * n + 4 * 5)      # stages in, mask + hist out
        print(f"recovery_scan N={n}: equal; kernel {ms:.6f} ms, plain "
              f"{plain:.6f} ms, floor {floor:.6f} ms, bound "
              f"{bound * 1e3:.3f} us (bytes); wrapper {wall:.6f} ms per "
              "call back to back")
        by_n[n] = ms
        if row is None:
            row = dict(ms=ms, plain_ms=plain, bound_ms=bound, floor_ms=floor)
    row["max_abs_err"] = err
    if len(sizes) > 1:
        row["ms_by_n"] = by_n
    return row


def bucket_table(dev, capacity, key_range, live, nb, w):
    """A (NB, W) table that build_buckets filled from a pool of
    ``capacity`` slots holding ``live`` keys of ``key_range``: (pool keys
    on the card, bkeys, bids, overflow count, the live keys)."""
    rng = np.random.default_rng([SEED, capacity, nb])
    keys = np.zeros(capacity, np.int32)
    cur = np.zeros(capacity, np.int32)
    slots = rng.choice(capacity, live, replace=False)
    live_keys = rng.choice(key_range, live, replace=False).astype(np.int32)
    keys[slots] = live_keys
    cur[slots] = VALID
    dkeys = torch.from_numpy(keys).to(dev)
    bkeys, bids, ovf = build_buckets(dkeys, torch.from_numpy(cur).to(dev),
                                     nb=nb, w=w)
    return dkeys, bkeys, bids, int(ovf), live_keys


def check_probe(dev, capacity, key_range, live, nb, w, batches):
    """The bucket lookup vs plain over a table that build_buckets filled
    from a pool of ``capacity`` slots holding ``live`` keys, at each batch
    (half present keys, half absent): ``hp_lookup`` whole, the kernel with
    the buckets read (``bucket_of`` computed first) and with the kernel
    hashing each key; each timed beside the plain lookup and the timing
    floor.  Returns the first batch's row, with each later
    batch's times beside it."""
    rng = np.random.default_rng(SEED)
    dkeys, bkeys, bids, ovf, live_keys = bucket_table(
        dev, capacity, key_range, live, nb, w)
    print(f"hash_probe table: NB={nb} W={w}, {live} live keys, "
          f"{ovf} overflowed their bucket")
    err, rows = 0, {}
    floor = timing_floor(dev)
    for b in batches:
        qk = _queries(rng, live_keys, key_range, b, dev)
        qb = bucket_of(qk, nb)
        want = hp_lookup(bkeys, bids, qk, use_kernels=False)
        outs = {"lookup": hp_lookup(bkeys, bids, qk),
                "read": probe_cuda(bkeys, bids, qb, qk),
                "hashed": probe_cuda(bkeys, bids, None, qk)}
        for name, got in outs.items():
            e = int((got - want).abs().max())
            expect(e == 0, f"hash_probe ({name}) differs from plain at "
                   f"B={b}")
            err = max(err, e)
        got = outs["lookup"]
        hit = got >= 0
        expect(bool((dkeys[got[hit].long()] == qk[hit]).all()),
               "hash_probe returned a node that holds another key")
        # a present key is missed only if it overflowed its bucket
        hits = int(hit.sum())
        expect(hits == b // 2 or (ovf > 0 and hits < b // 2),
               f"hash_probe found {hits} of {b // 2} present keys")
        r = dict(
            ms=time_ms(lambda: probe_cuda(bkeys, bids, None, qk), dev),
            read_ms=time_ms(lambda: probe_cuda(bkeys, bids, qb, qk), dev),
            plain_ms=time_ms(lambda: hp_lookup(bkeys, bids, qk,
                                               use_kernels=False), dev),
            lookup_ms=time_ms(lambda: hp_lookup(bkeys, bids, qk), dev),
            lookup_wall_ms=wall_ms(lambda: hp_lookup(bkeys, bids, qk), dev),
            read_wall_ms=wall_ms(lambda: probe_cuda(bkeys, bids, qb, qk),
                                 dev),
            floor_ms=floor)
        touched = int(torch.unique(qb).numel())
        # the hashed entry: each key in and id out, and each touched row's
        # W keys and W ids read once; the read entry also reads the bucket
        r["bound_ms"] = bytes_ms(8 * b + touched * w * 8)
        r["read_bound_ms"] = bytes_ms(12 * b + touched * w * 8)
        print(f"hash_probe B={b} ({touched} distinct rows): equal; "
              f"kernel hashing {r['ms']:.6f} ms, "
              f"kernel reading buckets {r['read_ms']:.6f} ms, "
              f"hp_lookup {r['lookup_ms']:.6f} ms, plain lookup "
              f"{r['plain_ms']:.6f} ms, floor {floor:.6f} ms, bound "
              f"{r['bound_ms'] * 1e3:.3f} us (bytes; reading "
              f"{r['read_bound_ms'] * 1e3:.3f}); hp_lookup "
              f"{r['lookup_wall_ms']:.6f} ms and the reading wrapper "
              f"{r['read_wall_ms']:.6f} ms per call back to back")
        rows[b] = r
    row = dict(rows[batches[0]], max_abs_err=err)
    for b in batches[1:]:
        row.update({f"{k}_b{b}": v for k, v in rows[b].items()
                    if k != "floor_ms"})
    return row


def probe_pool(dev, capacity, key_range, live, seed=SEED):
    """A pool of ``capacity`` slots holding ``live`` distinct keys at
    random slots: (keys i32[N], member bool[N], the live keys)."""
    rng = np.random.default_rng([seed, capacity, live])
    keys = np.zeros(capacity, np.int32)
    member = np.zeros(capacity, bool)
    slots = rng.choice(capacity, live, replace=False)
    live_keys = rng.choice(key_range, live, replace=False).astype(np.int32)
    keys[slots] = live_keys
    member[slots] = True
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(member).to(dev),
            live_keys)


def build_probe_table(dev, keys, member, table_factor=4, max_probe=128):
    """Recovery's bulk build of the probe table over ``member``, timed
    between synchronizations: (table, overflow, ms)."""
    t = 1 << max(3, (keys.shape[0] * table_factor - 1).bit_length())
    empty = torch.full((t,), EMPTY, dtype=torch.int32, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    table, ovf = DS.table_build(empty, keys, member, max_probe)
    sync(dev)
    return table, bool(ovf), (time.perf_counter() - t0) * 1e3


def window_bytes(table, q, max_probe):
    """Bytes the probe-window lookup must move for these queries: each
    query key in and id out, each slot of the windows they touch, and the
    pool key of each distinct live id in those slots."""
    t = table.shape[0]
    d = torch.arange(max_probe, dtype=torch.int64, device=q.device)
    slots = torch.unique(((hash32(q) & (t - 1))[:, None] + d) & (t - 1))
    ids = table[slots]
    live = int(torch.unique(ids[ids >= 0]).numel())
    return 8 * q.shape[0] + 4 * slots.numel() + 4 * live


def composition(table, pool, q, max_probe):
    """The TPU route carried over literally: the window rows gathered into
    two (B, max_probe) planes, then the bucket kernel at W = max_probe."""
    wkeys, wids, rows = window_rows(table, pool, q, max_probe)
    return probe_cuda(wkeys, wids, rows, q)


def check_table_probe(dev, label, table, pool, q, max_probe=128,
                      timed=True, pool_member=None):
    """The probe-window kernel against its plain version on one table and
    query batch (and against the windowed first-match lookup where the
    table was built by the ops); timed beside the plain version, the
    composition and the timing floor.  Returns the row's fields."""
    got = table_probe_cuda(table, pool, q, max_probe)
    ref = table_lookup_ref(table, pool, q, max_probe)
    e = int((got - ref).abs().max()) if q.numel() else 0
    expect(e == 0, f"table_probe differs from plain: {label}")
    hits = int((got >= 0).sum())
    if pool_member is not None:
        st = DS.make_state(pool.shape[0], device=dev)._replace(
            table=table, keys=pool)
        expect(bool((DS._lookup_probe(st, q, max_probe) == got).all()),
               f"table_probe differs from the first-match lookup: {label}")
        expect(bool((pool_member[got[got >= 0].long()]).all()),
               f"table_probe returned a node that is not live: {label}")
    if not timed:
        return dict(max_abs_err=e)
    ms = time_ms(lambda: table_probe_cuda(table, pool, q, max_probe), dev)
    plain = time_ms(lambda: table_lookup_ref(table, pool, q, max_probe), dev)
    comp = time_ms(lambda: composition(table, pool, q, max_probe), dev)
    floor = time_ms(lambda: torch.cuda._sleep(1), dev)
    wall = wall_ms(lambda: table_probe_cuda(table, pool, q, max_probe), dev)
    bound = bytes_ms(window_bytes(table, q, max_probe))
    print(f"table_probe {label}: equal ({hits} hits); kernel {ms:.6f} ms, "
          f"plain {plain:.6f} ms, composition (window gather + hash_probe "
          f"at W={max_probe}) {comp:.6f} ms, floor {floor:.6f} ms, bound "
          f"{bound * 1e3:.3f} us (bytes); wrapper {wall:.6f} ms per call "
          "back to back")
    return dict(ms=ms, plain_ms=plain, composition_ms=comp, floor_ms=floor,
                bound_ms=bound, max_abs_err=e)


def _queries(rng, live_keys, key_range, b, dev):
    """b queries, half present keys and half absent, shuffled."""
    absent = rng.integers(key_range, 2 * key_range, b - b // 2)
    q = np.concatenate([rng.choice(live_keys, b // 2), absent])
    return torch.from_numpy(rng.permutation(q).astype(np.int32)).to(dev)


def _arbitrary_table(rng, dev, t, n, fill, tomb, dense=0):
    """A table no op sequence builds: random ids (past the pool too) in a
    ``fill`` share of slots, a ``tomb`` share of TOMBs, and ``dense`` slots
    from 0 with no EMPTY (chains that reach max_probe)."""
    table = np.full(t, EMPTY, np.int32)
    slots = rng.choice(t, int(t * fill), replace=False)
    table[slots] = rng.integers(0, n + 4, slots.size)
    table[:dense] = rng.integers(0, n, dense)
    table[rng.random(t) < tomb] = TOMB
    return torch.from_numpy(table).to(dev)


def _offset_queries(rng, pool, t, b):
    """b queries over a T-slot table, drawn from the pool keys and 64
    absent keys, whose home slots take every offset mod 4 in turn (the
    kernel reads aligned 4-slot groups, so the offset sets how many the
    window touches)."""
    cand = np.concatenate([pool, rng.integers(2 * 10 ** 8, 3 * 10 ** 8,
                                              64)]).astype(np.int32)
    home = np_hash32(cand) & np.uint32(t - 1)
    by_off = [cand[home % 4 == o] for o in range(4)]
    q = [by_off[j % 4][rng.integers(by_off[j % 4].size)] for j in range(b)]
    return np.asarray(q, np.int32)


def check_table_probe_edges(dev, rng):
    """The probe-window kernel against its plain version, untimed, at the
    edges of its design: every window offset mod 4, max_probe from 1 to
    200 (one pass of the kernel covers 160 slots), B not a multiple of the
    queries a warp or a block serves, and tables of 4 and 8 slots whose
    windows wrap many times.  Returns the number of cases."""
    tables = {4: (0.75, 0.25, 0), 8: (0.5, 0.25, 0), 256: (0.5, 0.1, 0),
              1024: (0.3, 0.3, 512)}
    cases = 0
    for t, (fill, tomb, dense) in tables.items():
        n = max(4, t // 4)
        tb = _arbitrary_table(rng, dev, t, n, fill, tomb, dense)
        pool = rng.choice(10 ** 8, n, replace=False).astype(np.int32)
        pk = torch.from_numpy(pool).to(dev)
        for b in (1, 3, 5, 257):
            q = torch.from_numpy(_offset_queries(rng, pool, t, b)).to(dev)
            for mp in (1, 3, 5, 127, 128, 129, 200):
                check_table_probe(dev, f"edge T={t} B={b} max_probe={mp}",
                                  tb, pk, q, mp, timed=False)
                cases += 1
    print(f"table_probe edges: {cases} cases equal to plain (T 4, 8, 256, "
          "1024; B 1, 3, 5, 257; max_probe 1, 3, 5, 127, 128, 129, 200; "
          "every window offset mod 4)")
    return cases


def host_us(fn, dev, reps=200, repeats=7) -> float:
    """Host microseconds per call of ``fn``: the median over ``repeats``
    loops of ``reps`` calls, each loop timed without its closing
    synchronization (a launch is measured as the host's enqueue; 200 stay
    within the card's launch queue)."""
    times = []
    for _ in range(repeats):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / reps)
        sync(dev)
    return float(np.median(times))


def host_parts(dev, label, parts, whole):
    """Host microseconds per call of each part (``host_us``) and the
    back-to-back ms per call of each ``whole`` part as phase 2 prints it,
    median of 11; printed on one line and returned."""
    us = {k: host_us(fn, dev) for k, fn in parts.items()}
    walls = {k: float(np.median([wall_ms(parts[k], dev) for _ in range(11)]))
             for k in whole}
    print(f"{label} host us per call: " + "; ".join(
        f"{k} {v:.3f}" for k, v in us.items()) + "".join(
        f"; {k} ms per call back to back (median of 11) {v:.6f}"
        for k, v in walls.items()))
    return {"host_us": us, "wrapper_ms": walls}


def _guards(idx):
    """The device guard in the form the wrappers take (only for another
    card) and in the per-call form they replaced."""
    same = contextlib.nullcontext()

    def guard_once():
        with (same if idx == torch.cuda.current_device()
              else torch.cuda.device(idx)):
            pass

    def guard_always():
        with torch.cuda.device(idx):
            pass

    return {"device guard if another card": guard_once,
            "device guard (per-call form)": guard_always,
            "raw current stream":
                lambda: torch._C._cuda_getCurrentRawStream(idx),
            "current_stream().cuda_stream (per-call form)":
                lambda: torch.cuda.current_stream().cuda_stream}


def table_probe_host_parts(dev, table, pool, q, max_probe=128):
    """The host's cost of one ``table_probe_cuda`` call, by part, in
    microseconds: the whole wrapper back to back, the wrapper at B = 0
    (its argument checks and ``torch.empty``), and each later step in the
    form the wrapper takes and in the per-call form it replaced; the
    back-to-back ms per call of the whole wrapper."""
    lib = _lib()
    out = torch.empty_like(q)
    args = (table, pool, q)
    b, t, n = q.shape[0], table.shape[0], pool.shape[0]
    fast = torch.cuda.current_stream().cuda_stream

    def launch():
        return lib.table_probe(table.data_ptr(), pool.data_ptr(),
                               q.data_ptr(), out.data_ptr(), b, t, n,
                               max_probe, fast)

    q0 = q[:0]
    parts = {
        "wrapper": lambda: table_probe_cuda(table, pool, q, max_probe),
        "wrapper at B=0 (checks + torch.empty)":
            lambda: table_probe_cuda(table, pool, q0, max_probe),
        "torch.empty": lambda: torch.empty((b,), dtype=torch.int32,
                                           device=dev),
        "contiguous() x3": lambda: [x.contiguous() for x in args],
        **_guards(table.device.index),
        "ctypes launch (4 data_ptr + call)": launch,
        "_build.check": lambda: _build.check(lib, 0, "table_probe"),
    }
    r = host_parts(dev, "table_probe", parts, ["wrapper"])
    return {"host_us": r["host_us"], "wrapper_ms": r["wrapper_ms"]["wrapper"]}


def bucket_host_parts(dev, bkeys, bids, q):
    """The host's cost of one bucket lookup, by part, in microseconds:
    ``hp_lookup`` whole, the wrapper with the buckets read and with none,
    the wrapper at B = 0 (its checks and ``torch.empty``), the hash in
    PyTorch (``bucket_of``, which the hashed entry drops), and each
    later step in the wrapper's form and in the per-call form it replaced;
    the back-to-back ms per call of the lookup and the wrappers."""
    lib = _lib()
    out = torch.empty_like(q)
    nb, w = bkeys.shape
    b = q.shape[0]
    qb = bucket_of(q, nb)
    fast = torch.cuda.current_stream().cuda_stream

    def launch():
        return lib.hash_probe(bkeys.data_ptr(), bids.data_ptr(),
                              qb.data_ptr(), q.data_ptr(), out.data_ptr(), b,
                              nb, w, fast)

    parts = {
        "hp_lookup": lambda: hp_lookup(bkeys, bids, q),
        "wrapper reading buckets": lambda: probe_cuda(bkeys, bids, qb, q),
        "wrapper hashing": lambda: probe_cuda(bkeys, bids, None, q),
        "wrapper at B=0 (checks + torch.empty)":
            lambda: probe_cuda(bkeys, bids, qb[:0], q[:0]),
        "bucket_of (the hash in PyTorch)": lambda: bucket_of(q, nb),
        "torch.empty": lambda: torch.empty((b,), dtype=torch.int32,
                                           device=dev),
        "contiguous() x4": lambda: [x.contiguous()
                                    for x in (bkeys, bids, qb, q)],
        **_guards(bkeys.device.index),
        "ctypes launch (5 data_ptr + call)": launch,
        "_build.check": lambda: _build.check(lib, 0, "hash_probe"),
    }
    return host_parts(dev, "hash_probe", parts,
                      [k for k in parts if k.startswith(("hp_", "wrapper "))
                       and "B=0" not in k])


def scan_host_parts(dev, stages):
    """The host's cost of one ``scan_cuda`` call, by part, in
    microseconds: the whole wrapper, its two ``torch.empty`` outputs, the
    ``torch.zeros`` histogram it no longer launches, and each later step
    in the wrapper's form and the per-call form it replaced; the
    back-to-back ms per call of the wrapper."""
    from repro_torch.kernels.recovery_scan.kernel import _lib as scan_lib
    lib = scan_lib()
    n = stages.shape[0]
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    hist = torch.empty((5,), dtype=torch.int32, device=dev)
    bins = torch.zeros((5,), dtype=torch.int64, device=dev)  # its bin words
    fast = torch.cuda.current_stream().cuda_stream

    def launch():
        return lib.recovery_scan(stages.data_ptr(), mask.data_ptr(),
                                 hist.data_ptr(), bins.data_ptr(), n, fast)

    parts = {
        "wrapper": lambda: scan_cuda(stages),
        "torch.empty x2": lambda: (
            torch.empty((n,), dtype=torch.bool, device=dev),
            torch.empty((5,), dtype=torch.int32, device=dev)),
        "torch.zeros (the histogram's former fill)":
            lambda: torch.zeros((5,), dtype=torch.int32, device=dev),
        "contiguous()": stages.contiguous,
        **_guards(stages.device.index),
        "ctypes launch (3 data_ptr + call)": launch,
        "_build.check": lambda: _build.check(lib, 0, "recovery_scan"),
    }
    return host_parts(dev, "recovery_scan", parts, ["wrapper"])


def check_shard_table_probe(dev, cap, key_range, b):
    """The probe-window kernel at one shard's shapes: a shard's pool of
    cap / S slots holding a quarter of a key range of key_range / S, its
    table, and the lanes a ``b``-lane batch routes to the shard (the next
    power of two above b / S, here 2b / S).  Returns the row's fields."""
    per, per_range = cap // N_SHARDS, key_range // N_SHARDS
    lanes = 2 * b // N_SHARDS
    keys, member, live_keys = probe_pool(dev, per, per_range, per // 4)
    table, ovf, _ = build_probe_table(dev, keys, member)
    expect(not ovf, "a shard's probe table overflowed")
    q = _queries(np.random.default_rng(SEED), live_keys, per_range, lanes,
                 dev)
    return check_table_probe(dev, f"shard T={table.shape[0]} B={lanes}",
                             table, keys, q, pool_member=member)


def check_table_probes(dev, cap=1 << 21, batches=(1024, 65536)):
    """Phase 2b: the probe-window kernel at every shape of the probe
    backend's paths: the table of a ``cap``-slot map holding cap / 4 of a
    key range of cap / 2 at each batch, small and registry tables, the
    kernel's edge shapes, and one shard's table (cap / 8 slots, a quarter
    live, T 2^20) at the 256 lanes a 1024-lane batch routes to it; then
    the wrapper's host cost by part.  Returns the first batch's row with
    the second batch's and the shard's times beside it, and the map
    table's build time."""
    rng = np.random.default_rng(SEED)
    key_range, live = cap // 2, cap // 4
    keys, member, live_keys = probe_pool(dev, cap, key_range, live)
    table, ovf, build_ms = build_probe_table(dev, keys, member)
    expect(not ovf, "probe table build at 2^21 slots overflowed")
    print(f"probe table: {cap} slots, T={table.shape[0]}, {live} members; "
          f"built by table_build (claims of {DS.REBUILD_CHUNK} ids) in "
          f"{build_ms:.3f} ms")
    rows = {}
    for b in batches:
        q = _queries(rng, live_keys, key_range, b, dev)
        rows[b] = check_table_probe(dev, f"map B={b}", table, keys, q,
                                    pool_member=member)
        expect(int((table_probe_cuda(table, keys, q) >= 0).sum()) == b // 2,
               f"table_probe missed present keys at B={b}")
    host = table_probe_host_parts(
        dev, table, keys, _queries(rng, live_keys, key_range, batches[0],
                                   dev))
    # windows that wrap past T - 1; TOMBs and full 128-slot chains; B 1,
    # 7, 8; max_probe below and above a warp's sweep (arbitrary tables)
    pool = torch.from_numpy(rng.choice(10 ** 8, 1024, replace=False)
                            .astype(np.int32)).to(dev)
    small = {"wrap": _arbitrary_table(rng, dev, 256, 64, 0.5, 0.1),
             "tombs+full chains": _arbitrary_table(rng, dev, 1024, 256, 0.3,
                                                   0.3, dense=512)}
    for name, tb in small.items():
        t = tb.shape[0]
        pk = pool[: (64 if t == 256 else 256)]
        home = hash32(pk) & (t - 1)
        late = pk[home >= t - 16]                       # windows that wrap
        for b in (1, 7, 8):
            q = torch.cat([late, pk, pk + 10 ** 8])[:b] if name == "wrap" \
                else torch.cat([pk[:b // 2 + 1], pk[:b] + 10 ** 8])[:b]
            for mp in (5, 128, 200):
                check_table_probe(dev, f"{name} T={t} B={b} max_probe={mp}",
                                  tb, pk, q, mp, timed=(mp == 128))
    edges = check_table_probe_edges(dev, rng)
    # the serving registry's shape: 1024 slots, B = 8, a table holding the
    # 8 served requests and a full one
    reg = serve.REGISTRY_CAPACITY
    for n_live in (8, reg):
        keys_r, member_r, live_r = probe_pool(dev, reg, 4 * reg, n_live)
        tb, _, _ = build_probe_table(dev, keys_r, member_r)
        check_table_probe(dev, f"registry T={tb.shape[0]} {n_live} live "
                          "B=8", tb, keys_r,
                          _queries(rng, live_r, 4 * reg, 8, dev),
                          pool_member=member_r)
    shard = check_shard_table_probe(dev, cap, key_range, batches[0])
    lanes = 2 * batches[0] // N_SHARDS
    big = rows[batches[1]]
    row = dict(rows[batches[0]], **{f"{k}_b{batches[1]}": big[k] for k in
                                    ("ms", "plain_ms", "composition_ms",
                                     "bound_ms")},
               **{f"{k}_shard_b{lanes}": shard[k] for k in
                  ("ms", "plain_ms", "bound_ms", "floor_ms")},
               **host, edge_cases=edges)
    return row, build_ms


def probe_window_main() -> int:
    """``--probe-window``: phase 1's build and phase 2b alone, for timing
    two trees of the probe-window kernel in turns on one card."""
    dev = torch.device("cuda")
    smi = environment()
    window, build_ms = check_table_probes(dev)
    print(smi)
    print(json.dumps({"probe_window": window, "table_build_ms": build_ms,
                      "card": smi}))
    return 0


def check_bucket_scan(dev):
    """Phase 2's ``recovery_scan`` and bucket parts at the main path's
    shapes, each timed with the floor: the scan at the padded delta's N 8,
    the queue's ring 2^16, the map's 2^21 and 2^23 (and 2^21 + 3, the
    scalar tail), then its host cost by part; the bucket lookup on the
    2^21-slot map's table (NB 2^19, W 8) at B 1024 and 65536 and on one
    shard's (2^18 slots, B 256), then its host cost by part.  Returns
    (scan row, bucket row)."""
    scan = check_scan(dev, [1 << 21, 1 << 23, (1 << 21) + 3, 8, 1 << 16])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scan.update(scan_host_parts(dev, torch.randint(
        0, 5, (1 << 16,), generator=gen, device=dev, dtype=torch.int32)))
    probe = check_probe(dev, capacity=1 << 21, key_range=1 << 20,
                        live=1 << 19, nb=1 << 19, w=8, batches=[1024, 65536])
    per = (1 << 21) // N_SHARDS
    nb_s, w_s = SetSpec(capacity=per, backend="bucket").bucket_geometry()
    lanes = 2 * 1024 // N_SHARDS
    shard = check_probe(dev, capacity=per, key_range=per // 2, live=per // 4,
                        nb=nb_s, w=w_s, batches=[lanes])
    probe.update({f"{k}_shard_b{lanes}": v for k, v in shard.items()
                  if k != "max_abs_err"})
    _, bk, bi, _, live_keys = bucket_table(dev, 1 << 21, 1 << 20, 1 << 19,
                                           1 << 19, 8)
    q = _queries(np.random.default_rng(SEED), live_keys, 1 << 20, 1024, dev)
    probe.update(bucket_host_parts(dev, bk, bi, q))
    return scan, probe


def bucket_scan_main() -> int:
    """``--bucket-scan``: phase 1's build and phase 2's ``recovery_scan``
    and bucket parts alone (``check_bucket_scan``), for timing two trees
    of these kernels in turns on one card."""
    dev = torch.device("cuda")
    smi = environment()
    scan, probe = check_bucket_scan(dev)
    print(smi)
    print(json.dumps({"recovery_scan": scan, "hash_probe": probe,
                      "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# 3. the main path against a host reference
# ---------------------------------------------------------------------------

class Reference:
    """Plain host model of one map under apply's linearization: contains
    see the pre-batch set, then inserts in lane order (first lane wins),
    then removes in lane order.  Tracks the psyncs each mode must pay."""

    def __init__(self, key_range: int, mode: str):
        self.present = np.zeros(key_range, bool)
        self.value = np.zeros(key_range, np.int32)
        self.mode = mode
        self.psyncs = 0
        self.ops = 0

    def apply(self, ops, keys, values):
        res = np.zeros(ops.size, bool)
        c = ops == OP_CONTAINS
        res[c] = self.present[keys[c]]
        wins = lose = 0
        added = set()
        for i in np.flatnonzero(ops == OP_INSERT):
            k = keys[i]
            if not self.present[k]:
                self.present[k] = True
                self.value[k] = values[i]
                added.add(k)
                res[i] = True
                wins += 1
            elif k in added:
                lose += 1
        removed = set()
        for i in np.flatnonzero(ops == OP_REMOVE):
            k = keys[i]
            if self.present[k]:
                self.present[k] = False
                removed.add(k)
                res[i] = True
                wins += 1
            elif k in removed:
                lose += 1
        self.psyncs += {"soft": wins, "linkfree": wins + lose,
                        "logfree": 2 * (wins + lose)}[self.mode]
        self.ops += ops.size
        return res


def traffic(rng, n_batches, b, key_range):
    """Mixed batches: 90% contains, 5% insert, 5% remove, keys uniform."""
    ops = rng.choice(np.array([OP_CONTAINS, OP_INSERT, OP_REMOVE], np.int32),
                     size=(n_batches, b), p=[0.9, 0.05, 0.05])
    keys = rng.integers(0, key_range, (n_batches, b), dtype=np.int32)
    vals = rng.integers(0, 1 << 31, (n_batches, b), dtype=np.int32)
    return ops, keys, vals


def lanes(m, dev, batches):
    """The batches as ``m`` takes them: device tensors for a
    ``DurableMap``; host arrays for a ``ShardedDurableMap`` or an
    ``ElasticShardedMap``, whose stage-1 router runs on the host."""
    if isinstance(m, (ShardedDurableMap, ElasticShardedMap)):
        return batches
    return tuple(torch.from_numpy(a).to(dev) for a in batches)


def results(out) -> np.ndarray:
    """Per-lane results of a run of batches as one host array (the flat
    map's stay on the device until here; the sharded map's are host
    arrays already)."""
    if isinstance(out[0], torch.Tensor):
        return torch.stack(out).cpu().numpy()
    return np.stack([np.asarray(o) for o in out])


def drive(m, ref, dev, ops, keys, vals, label):
    """Apply the batches, timed between synchronizations, then check every
    lane against the reference.  Returns ops/s."""
    dops, dkeys, dvals = lanes(m, dev, (ops, keys, vals))
    sync(dev)
    t0 = time.perf_counter()
    out = [m.apply(dops[i], dkeys[i], dvals[i]) for i in range(len(ops))]
    sync(dev)
    dt = time.perf_counter() - t0
    got = results(out)
    for i in range(len(ops)):
        exp = ref.apply(ops[i], keys[i], vals[i])
        expect((got[i] == exp).all(),
               f"{label}: batch {i} results differ from the reference")
    expect(len(m) == int(ref.present.sum()), f"{label}: size")
    expect(m.psyncs == ref.psyncs,
           f"{label}: psyncs {m.psyncs} != reference {ref.psyncs}")
    expect(m.ops == ref.ops, f"{label}: ops {m.ops} != {ref.ops}")
    return ops.size / dt


def check_membership(m, ref, dev, chunk: int, label: str):
    """Every key of the range through contains (batches of ``chunk`` lanes:
    the op bodies build B x B matrices) and a sample through get."""
    n = ref.present.size
    got = np.concatenate([
        results([m.contains(lanes(m, dev, (np.arange(
            s, min(s + chunk, n), dtype=np.int32),))[0])])[0]
        for s in range(0, n, chunk)])
    expect((got == ref.present).all(),
           f"{label}: membership differs for {(got != ref.present).sum()} "
           "keys")
    sample = np.flatnonzero(ref.present)[:chunk].astype(np.int32)
    vals = results([m.get(lanes(m, dev, (sample,))[0])])[0]
    expect((vals == ref.value[sample]).all(), f"{label}: get values")
    ref.ops += n + sample.size
    expect(m.ops == ref.ops and m.psyncs == ref.psyncs,
           f"{label}: reads changed the counters unexpectedly")


def device_rows(prof):
    """(device us, count, name) of each device-side event of a profile,
    largest first, and their sum: only kernels, copies and fills, since
    the host operators that launched them report the same time again."""
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return rows, sum(r[0] for r in rows)


def profile(m, ref, dev, batches, label):
    """Mixed batches under torch.profiler: the device's busy share of the
    window and the kernels that take its time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(m, ref, dev, *batches, f"{label} profiled")
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy = device_rows(prof)
    n_batches = len(batches[0])
    share = 100 * busy / wall_us
    per_batch = sum(r[1] for r in rows) / n_batches
    print(f"{label} profile: {n_batches} batches, wall {wall_us:.1f} us, "
          f"device busy {busy:.1f} us ({share:.2f}%), "
          f"{per_batch:.1f} device ops per batch")
    for us, n, key in rows[:10]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    return share, per_batch


@contextlib.contextmanager
def sync_sites():
    """Host synchronizations inside the block, read from
    ``torch.cuda.set_sync_debug_mode``'s warnings: yields two dicts,
    filled on exit, of ``file:line -> count`` for the sites in the port's
    code (under ``repro_torch/``) and for the other sites."""
    sites, other = {}, {}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites, other
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in rec:
        if "synchroniz" in str(w.message):
            path = Path(w.filename)
            into = sites if "repro_torch" in path.parts else other
            site = f"{path.name}:{w.lineno}"
            into[site] = into.get(site, 0) + 1


def print_sites(label, over, sites, other):
    for name, found in (("the port's", sites), ("other", other)):
        print(f"{label}: host syncs by site over {over}, {name} code: "
              + (", ".join(f"{k} x{v}" for k, v in
                           sorted(found.items(), key=lambda kv: -kv[1]))
                 or "none"))


def count_syncs(m, ref, dev, batches, label):
    """Host synchronizations per ``m.apply`` call made by the port's code
    over ``batches`` (``sync_sites``); sites outside the port are printed
    apart and not counted.  The results are checked against the reference
    after the count."""
    ops, keys, vals = batches
    d_ops, d_keys, d_vals = lanes(m, dev, batches)
    sync(dev)
    with sync_sites() as (sites, other):
        out = [m.apply(d_ops[i], d_keys[i], d_vals[i])
               for i in range(len(ops))]
    got = results(out)
    for i in range(len(ops)):
        expect((got[i] == ref.apply(ops[i], keys[i], vals[i])).all(),
               f"{label} sync count: batch {i} differs from the reference")
    print_sites(label, f"{len(ops)} batches", sites, other)
    return sum(sites.values()) / len(ops)


def run_map(dev, mode, capacity, key_range, prefill, n_batches, n_after, b,
            chunk, label, n_profiled=0, backend="bucket"):
    """One map through prefill, mixed traffic, crash + recovery and more
    traffic, checked at every step; then ``n_profiled`` batches under the
    profiler and as many counting host syncs.  On the probe backend the
    table rebuild of the recovery is timed again on its own.  Returns
    (ops/s, recovery ms)."""
    rng = np.random.default_rng([SEED, capacity])
    m = DurableMap(SetSpec(capacity=capacity, mode=mode, backend=backend),
                   device=dev)
    ref = Reference(key_range, mode)
    pre = rng.choice(key_range, prefill, replace=False).astype(np.int32)
    pre = pre.reshape(-1, b)
    drive(m, ref, dev, np.full(pre.shape, OP_INSERT, np.int32), pre,
          rng.integers(0, 1 << 31, pre.shape, dtype=np.int32),
          f"{label} prefill")
    ops_s = drive(m, ref, dev, *traffic(rng, n_batches, b, key_range),
                  f"{label} traffic")
    expect(not m.overflowed, f"{label}: overflow latched")

    u = rng.random(capacity, dtype=np.float32)
    m.crash_and_recover(torch.from_numpy(u).to(dev))
    hist = m.last_recovery_hist
    expect(int(hist.sum()) == capacity, f"{label}: histogram sum")
    expect(int(hist[VALID]) == int(ref.present.sum()),
           f"{label}: VALID bin {int(hist[VALID])} != reference size")
    expect(m.psyncs == 0 and m.ops == 0, f"{label}: counters after recovery")
    rec_ms = m.last_recovery_seconds * 1e3
    rebuild = ""
    if backend == "probe":
        # the same bulk build the recovery ran, timed alone
        table, ovf, build_ms = build_probe_table(
            dev, m.state.keys, m.state.cur == VALID, m.spec.table_factor,
            m.spec.max_probe)
        expect(torch.equal(table, m.state.table) and not ovf,
               f"{label}: the rebuilt table differs from a fresh build")
        rebuild = (f" (its probe-table rebuild alone {build_ms:.3f} ms, "
                   f"{100 * build_ms / rec_ms:.1f}%)")
    ref.psyncs = ref.ops = 0
    check_membership(m, ref, dev, chunk, f"{label} after recovery")
    drive(m, ref, dev, *traffic(rng, n_after, b, key_range),
          f"{label} after recovery")
    check_membership(m, ref, dev, chunk, f"{label} end")
    if n_profiled:
        profile(m, ref, dev, traffic(rng, n_profiled, b, key_range), label)
        syncs = count_syncs(m, ref, dev, traffic(rng, n_profiled, b,
                                                 key_range), label)
        print(f"{label}: {syncs:.2f} host syncs per batch in the port's "
              f"code over {n_profiled} batches")
    print(f"{label}: {backend}, {mode}, {capacity} slots, {len(m)} live; "
          f"mixed batches {ops_s:.1f} ops/s; recovery {rec_ms:.3f} ms"
          f"{rebuild}; histogram {hist.tolist()}")
    return ops_s, rec_ms


# ---------------------------------------------------------------------------
# 3b. snapshot + delta-log hybrid recovery
# ---------------------------------------------------------------------------

def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def wall(fn, dev, reps: int = 3):
    """(result, median host ms) of ``reps`` calls, each between
    synchronizations."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def run_hybrid(dev, label, capacity, key_range, prefill, n_batches, n_after,
               b, chunk, backend="bucket", snapshot_first=False):
    """One SOFT map through prefill, a snapshot through the Snapshotter
    into a temporary directory (before the prefill with
    ``snapshot_first``, so that the delta is most of the pool), mixed
    batches (the first ``N_INFLIGHT`` while the snapshot's build and save
    run in the background), a crash under a seeded adversary, and recovery
    through ``Snapshotter.recover``: the snapshot plus the stamp delta.
    A copy of the pre-crash state goes through the full
    ``crash_and_recover``; every leaf but the counters and the histogram
    must be equal, the whole key range equal to the host reference after
    recovery, and ``n_after`` more batches too.  Then the recovery's
    pieces are timed one by one on the same planes.  Returns the numbers
    and the kernels' launches on the path (the full recovery and the
    timed pieces not counted)."""
    rng = np.random.default_rng([SEED, capacity, int(snapshot_first)])
    spec = SetSpec(capacity=capacity, mode="soft", backend=backend)
    m = DurableMap(spec, device=dev)
    ref = Reference(key_range, "soft")
    pre = rng.choice(key_range, prefill, replace=False).astype(np.int32)
    pre = pre.reshape(-1, b)
    pre_vals = rng.integers(0, 1 << 31, pre.shape, dtype=np.int32)
    ops, keys, vals = traffic(rng, n_batches, b, key_range)
    u = torch.from_numpy(rng.random(capacity, dtype=np.float32)).to(dev)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        scan_cuda.launches = probe_cuda.launches = 0
        sn = Snapshotter(m, tmp)
        if not snapshot_first:
            drive(m, ref, dev, np.full(pre.shape, OP_INSERT, np.int32), pre,
                  pre_vals, f"{label} prefill")
        sync(dev)
        t0 = time.perf_counter()
        build = sn.snapshot()
        out["capture_ms"] = (time.perf_counter() - t0) * 1e3
        k = N_INFLIGHT
        out["inflight_ops_s"] = drive(m, ref, dev, ops[:k], keys[:k],
                                      vals[:k], f"{label} build in flight")
        out["overlapped"] = not build.done()
        sn.wait()
        out["build_save_ms"] = sn.last_duration * 1e3
        out["bytes_written"] = sn.store.bytes_written
        if snapshot_first:
            drive(m, ref, dev, np.full(pre.shape, OP_INSERT, np.int32), pre,
                  pre_vals, f"{label} prefill")
        out["ops_s"] = drive(m, ref, dev, ops[k:], keys[k:], vals[k:],
                             f"{label} traffic")
        expect(not m.overflowed, f"{label}: overflow latched")
        w = int(sn.store.extra()["watermark"])
        pre_crash = clone_state(m.state)

        n_scan = scan_cuda.launches
        sync(dev)
        with sync_sites() as (sites, other):
            t0 = time.perf_counter()
            sn.recover(u)
            sync(dev)
            out["snapshotter_recover_ms"] = (time.perf_counter() - t0) * 1e3
        expect(scan_cuda.launches == n_scan + 1,
               f"{label}: the hybrid recovery launched recovery_scan "
               f"{scan_cuda.launches - n_scan} times, expected 1")
        out["hybrid_ms"] = m.last_recovery_seconds * 1e3
        out["syncs"] = sum(sites.values())
        print_sites(f"{label} hybrid recovery", "Snapshotter.recover",
                    sites, other)
        recovered = clone_state(m.state)
        recovered_hist = m.last_recovery_hist.copy()
        out["recovery_psyncs"] = m.psyncs
        expect(m.psyncs == 0 and m.ops == 0,
               f"{label}: recovery paid psyncs")
        ref.psyncs = ref.ops = 0
        check_membership(m, ref, dev, chunk, f"{label} after recovery")
        drive(m, ref, dev, *traffic(rng, n_after, b, key_range),
              f"{label} after recovery")
        launches = {"recovery_scan": scan_cuda.launches,
                    "hash_probe": probe_cuda.launches}

        # the full rebuild of the same pre-crash state, after the counted
        # run: a comparison
        full = DurableMap(spec, device=dev)
        full.state = clone_state(pre_crash)
        full.crash_and_recover(u)
        out["full_ms"] = full.last_recovery_seconds * 1e3
        for f in recovered._fields:
            if f in ("n_psync", "n_ops"):
                continue
            expect(torch.equal(getattr(recovered, f),
                               getattr(full.state, f)),
                   f"{label}: leaf {f} differs between hybrid and full "
                   "recovery")
        expect((recovered_hist == full.last_recovery_hist).all(),
               f"{label}: histogram {recovered_hist.tolist()} != full "
               f"{full.last_recovery_hist.tolist()}")

        # the pieces, each timed alone on the same planes
        step = sn.store.latest_step()
        (planes, meta), out["read_ms"] = wall(
            lambda: (sn.store.restore(step), sn.store.extra(step)), dev)
        snap, out["h2d_ms"] = wall(lambda: m._snapshot_state(planes), dev)
        crashed = DS.crash(pre_crash, u)
        (delta_idx, slots, stages), out["find_delta_ms"] = wall(
            lambda: TE.find_delta(crashed[0], crashed[3], w), dev)
        out["delta"], out["padded"] = int(slots.size), delta_idx.numel()
        valid = delta_idx < capacity
        gi = torch.where(valid, delta_idx, 0).long()
        gathered = torch.where(valid, crashed[0][gi], 0)
        member_d, hist_d = scan_cuda(gathered)
        member_p, hist_p = scan_ref(gathered)
        expect(torch.equal(member_d, member_p) and torch.equal(hist_d, hist_p),
               f"{label}: recovery_scan differs from plain on the delta")
        out["scan_ms"] = time_ms(lambda: scan_cuda(gathered), dev)
        st, out["hybrid_recover_ms"] = wall(
            lambda: TE.hybrid_recover(snap, *crashed, delta_idx, spec=spec),
            dev)
        expect(all(torch.equal(a, b) for a, b in zip(st, full.state)),
               f"{label}: hybrid_recover alone differs from full recovery")
        out["patch_ms"] = None
        if backend == "bucket":
            _, out["patch_ms"] = wall(lambda: TE._delta_bucket_patch(
                snap, st.keys, st.cur, delta_idx, gi, valid,
                member_d & valid, spec=spec), dev)
        _, out["hist_ms"] = wall(lambda: TE.hybrid_hist(
            meta, planes["raw_stage"], slots, stages), dev)
        sn.close()
        # both recoveries again on copies of the same pre-crash state, in
        # turns (the planes held in memory: no store read)
        samples = {"full": [], "hybrid": []}
        for kind in ("full", "hybrid", "hybrid", "full", "full", "hybrid"):
            x = DurableMap(spec, device=dev)
            x.state = clone_state(pre_crash)
            if kind == "full":
                x.crash_and_recover(u)
            else:
                x.hybrid_crash_and_recover(planes, meta, u)
            samples[kind].append(round(x.last_recovery_seconds * 1e3, 3))
            del x
    print(f"{label}: {backend}, SOFT, {capacity} slots, {len(m)} live; "
          f"snapshot capture {out['capture_ms']:.3f} ms on the hot path, "
          f"build + save {out['build_save_ms']:.3f} ms in the background "
          f"({out['bytes_written']} bytes written); {N_INFLIGHT} batches "
          f"with the build in flight {out['inflight_ops_s']:.1f} ops/s "
          f"(still in flight after them: {out['overlapped']}), the rest "
          f"{out['ops_s']:.1f} ops/s")
    print(f"{label}: delta {out['delta']} slots, padded {out['padded']}; "
          f"hybrid recovery {out['hybrid_ms']:.3f} ms, full recovery of "
          f"the same planes {out['full_ms']:.3f} ms, Snapshotter.recover "
          f"(store read included) {out['snapshotter_recover_ms']:.3f} ms; "
          f"{out['syncs']} host syncs in the port's code; recovery psyncs "
          f"{out['recovery_psyncs']}; again in turns on the same planes "
          f"(in memory): full {samples['full']} ms, hybrid "
          f"{samples['hybrid']} ms")
    patch = ("n/a (scan backend)" if out["patch_ms"] is None
             else f"{out['patch_ms']:.3f} ms")
    print(f"{label}: split, each alone (median of 3): store read "
          f"{out['read_ms']:.3f} "
          f"ms, H2D of the planes {out['h2d_ms']:.3f} ms, delta discovery "
          f"{out['find_delta_ms']:.3f} ms, recovery_scan on the delta "
          f"{out['scan_ms']:.6f} ms (device), hybrid_recover "
          f"{out['hybrid_recover_ms']:.3f} ms, of it the bucket patch "
          f"{patch}, histogram {out['hist_ms']:.3f} ms")
    print(f"{label}: launches {launches}")
    return out, launches


def check_serve_snapshots(dev):
    """The port's serve CLI on the card with the bucket registry
    snapshotted every step: the snapshotter line, every completion after
    the crash, recovered through the snapshot (zero delta)."""
    scan_cuda.launches = probe_cuda.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--device", str(dev), "--arch",
                             "qwen3-32b-smoke", "--backend",
                             "bucket", "--snapshot-every", "1", "--crash",
                             "--requests", "4", "--prompt-len", "8",
                             "--gen", "4", "--snapshot-dir", tmp])
        text = buf.getvalue()
        print(text, end="")
        expect(rc == 0
               and f"snapshotter: every 1 step(s) -> {tmp}" in text
               and "after crash+recovery: all 4 completions still "
                   "registered" in text
               and "hybrid recovery: 0 delta slot(s) re-scanned, 1024 "
                   "restored from the snapshot" in text,
               "serve --snapshot-every 1 --crash did not print its lines")
    launches = {"recovery_scan": scan_cuda.launches,
                "hash_probe": probe_cuda.launches}
    print(f"serve --snapshot-every 1 launches: {launches}")
    expect(launches["recovery_scan"] == 2 and launches["hash_probe"] > 0,
           "serve with snapshots: expected recovery_scan twice (the "
           "snapshot's build, the hybrid recovery) and hash_probe")


# ---------------------------------------------------------------------------
# 3c. the sharded map on one card
# ---------------------------------------------------------------------------

N_SHARDS = 8
PREFILL_BATCH = 8192               # lanes per prefill batch, sharded runs
MEMBER_CHUNK = 65536               # lanes per membership read of those runs


def lookup_kernel(backend):
    """The wrapper of the backend's lookup kernel, and its JSON name."""
    return ((probe_cuda, "hash_probe") if backend == "bucket"
            else (table_probe_cuda, "table_probe"))


def prefill(m, ref, dev, rng, key_range, n, b, label):
    pre = rng.choice(key_range, n, replace=False).astype(np.int32)
    pre = pre.reshape(-1, b)
    drive(m, ref, dev, np.full(pre.shape, OP_INSERT, np.int32), pre,
          rng.integers(0, 1 << 31, pre.shape, dtype=np.int32),
          f"{label} prefill")


def check_recovery_hist(m, ref, label):
    hist = np.asarray(m.last_recovery_hist)
    expect(int(hist.sum()) == m.n_shards * m.spec.capacity,
           f"{label}: histogram sum")
    expect(int(hist[VALID]) == int(ref.present.sum()),
           f"{label}: VALID bin {int(hist[VALID])} != reference size")
    shards = m.last_recovery_hist_shards
    expect(shards.shape == (m.n_shards, 5)
           and (shards.sum(axis=0) == hist).all()
           and (shards.sum(axis=1) == m.spec.capacity).all(),
           f"{label}: per-shard histograms")
    live = np.bincount(SH.np_shard_of(np.flatnonzero(ref.present),
                                      m.n_shards), minlength=m.n_shards)
    expect((shards[:, VALID] == live).all(),
           f"{label}: per-shard VALID bins {shards[:, VALID].tolist()} != "
           f"the reference's {live.tolist()}")


def run_sharded(dev, backend, capacity, key_range, prefill_keys, n_batches,
                n_after, b, snapshot=False, label="sharded"):
    """A SOFT ``ShardedDurableMap`` of ``N_SHARDS`` shards through prefill,
    mixed traffic, crash + recovery and more traffic, every step against
    the host reference, the whole key range read back after the recovery
    and at the end.  With ``snapshot``, a ``Snapshotter`` snapshots the
    map after the prefill and the crash recovers through it (hybrid),
    every leaf held against the full ``crash_and_recover`` of a copy of
    the same pre-crash state under the same per-shard adversary.  Returns
    the numbers and the kernels' launches on the path."""
    rng = np.random.default_rng([SEED, capacity, N_SHARDS])
    spec = SetSpec(capacity=capacity, mode="soft", backend=backend)
    m = ShardedDurableMap(spec, n_shards=N_SHARDS, device=dev)
    ref = Reference(key_range, "soft")
    lookup, lname = lookup_kernel(backend)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        scan_cuda.launches = lookup.launches = 0
        prefill(m, ref, dev, rng, key_range, prefill_keys,
                min(PREFILL_BATCH, prefill_keys), label)
        sn = None
        if snapshot:
            sn = Snapshotter(m, tmp)
            sn.snapshot()
            sn.wait()
        n0 = lookup.launches
        out["ops_s"] = drive(m, ref, dev, *traffic(rng, n_batches, b,
                                                   key_range),
                             f"{label} traffic")
        out["lookups_per_batch"] = (lookup.launches - n0) / n_batches
        expect(not m.overflowed, f"{label}: overflow latched")
        expect(m.router_dropped == 0, f"{label}: v2 uncapped dropped lanes")
        u = np.random.default_rng([SEED, 7]).random(
            tuple(m.state.cur.shape)).astype(np.float32)
        pre_crash = clone_state(m.state) if snapshot else None
        n_scan = scan_cuda.launches
        if snapshot:
            sn.recover(u)
            sn.close()
        else:
            m.crash_and_recover(u)
        out["scans_per_recovery"] = scan_cuda.launches - n_scan
        out["recovery_ms"] = m.last_recovery_seconds * 1e3
        check_recovery_hist(m, ref, label)
        expect(m.psyncs == 0 and m.ops == 0,
               f"{label}: counters after recovery (recovery psyncs)")
        recovered = clone_state(m.state)
        ref.psyncs = ref.ops = 0
        check_membership(m, ref, dev, MEMBER_CHUNK, f"{label} after recovery")
        drive(m, ref, dev, *traffic(rng, n_after, b, key_range),
              f"{label} after recovery")
        check_membership(m, ref, dev, MEMBER_CHUNK, f"{label} end")
        launches = {"recovery_scan": scan_cuda.launches,
                    lname: lookup.launches}
        if snapshot:
            # the full rebuild of the same pre-crash state: a comparison
            full = ShardedDurableMap(spec, n_shards=N_SHARDS, device=dev)
            full.state = pre_crash
            full.crash_and_recover(u)
            out["full_ms"] = full.last_recovery_seconds * 1e3
            for f in recovered._fields:
                if f in ("n_psync", "n_ops"):
                    continue
                expect(torch.equal(getattr(recovered, f),
                                   getattr(full.state, f)),
                       f"{label}: leaf {f} differs between hybrid and full "
                       "recovery")
            del full
    print(f"{label}: {backend}, SOFT, {N_SHARDS} shards x "
          f"{m.spec.capacity} slots, {len(m)} live; mixed batches "
          f"{out['ops_s']:.1f} ops/s; {out['lookups_per_batch']:.2f} "
          f"{lname} launches per batch "
          f"({out['lookups_per_batch'] / N_SHARDS:.2f} per shard); "
          f"recovery {out['recovery_ms']:.3f} ms"
          + (f" through the snapshot (full rebuild of the same planes "
             f"{out['full_ms']:.3f} ms, every leaf equal)" if snapshot
             else "")
          + f", recovery_scan {out['scans_per_recovery']} launches; "
          f"histogram {m.last_recovery_hist.tolist()}")
    print(f"{label}: launches {launches}")
    expect(out["scans_per_recovery"] == N_SHARDS,
           f"{label}: recovery_scan launched {out['scans_per_recovery']} "
           f"times by the recovery, expected {N_SHARDS} (one per shard)")
    expect(all(v > 0 for v in launches.values()),
           f"{label}: a kernel of the sharded path was never launched")
    return out, launches


def stage1_ms(sspec, batches):
    """Host milliseconds per batch of the v2 router's stage 1 alone."""
    ops, keys, vals = batches
    t0 = time.perf_counter()
    for i in range(len(ops)):
        RT.release_plan(RT.host_route(sspec, ops[i], keys[i], vals[i]))
    return (time.perf_counter() - t0) * 1e3 / len(ops)


def compare_sharding(dev, capacity, key_range, prefill_keys, n_batches, b,
                     n_profiled):
    """The same traffic at equal total capacity on the flat bucket
    ``DurableMap``, a ``ShardedDurableMap`` of one shard and one of
    ``N_SHARDS``: ops/s, device operations per batch and the device's busy
    share (profiled batches), host syncs per batch by site, stage-1 router
    ms per batch, recovery ms."""
    rows = {}
    for name, n_shards in (("flat", 0), ("s1", 1), (f"s{N_SHARDS}",
                                                    N_SHARDS)):
        rng = np.random.default_rng([SEED, capacity, 3])
        spec = SetSpec(capacity=capacity, mode="soft", backend="bucket")
        m = (DurableMap(spec, device=dev) if not n_shards else
             ShardedDurableMap(spec, n_shards=n_shards, device=dev))
        ref = Reference(key_range, "soft")
        label = f"compare {name}"
        prefill(m, ref, dev, rng, key_range, prefill_keys,
                min(PREFILL_BATCH if n_shards else b, prefill_keys), label)
        batches = traffic(rng, n_batches, b, key_range)
        ops_s = drive(m, ref, dev, *batches, label)
        busy, dev_ops = profile(m, ref, dev, traffic(rng, n_profiled, b,
                                                     key_range), label)
        syncs = count_syncs(m, ref, dev, traffic(rng, n_profiled, b,
                                                 key_range), label)
        s1 = stage1_ms(m.sspec, batches) if n_shards else None
        m.crash_and_recover(np.random.default_rng([SEED, 7]).random(
            tuple(m.state.cur.shape)).astype(np.float32))
        if n_shards:
            check_recovery_hist(m, ref, label)
        rows[name] = dict(ops_s=ops_s, dev_ops=dev_ops, busy=busy,
                          syncs=syncs, stage1_ms=s1,
                          recovery_ms=m.last_recovery_seconds * 1e3)
        print(f"{label}: {ops_s:.1f} ops/s, {dev_ops:.1f} device ops per "
              f"batch, device busy {busy:.2f}%, {syncs:.2f} host syncs per "
              f"batch in the port's code, recovery "
              f"{rows[name]['recovery_ms']:.3f} ms"
              + (f"; stage-1 router {s1:.3f} ms per batch on the host"
                 if s1 is not None else ""))
        del m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def host_kept(sspec, ops, keys):
    """The v2 drop rule on the host (tests/test_durability_property.py):
    per storage row, the first L real lanes in batch order are kept, L the
    adaptive budget of the batch's realized occupancy."""
    d = RT.resolve_groups(sspec)
    rows = RT._np_row_of(keys, sspec, d)
    real = ops != OP_NOP
    budget = RT.adaptive_lane_budget(
        sspec, keys.size, int(np.bincount(rows[real],
                                          minlength=sspec.n_shards).max()))
    kept = np.ones(keys.size, bool)
    taken = np.zeros(sspec.n_shards, np.int64)
    for j in np.flatnonzero(real):
        taken[rows[j]] += 1
        kept[j] = taken[rows[j]] <= budget
    return kept


def run_routed(dev, capacity, key_range, n_batches, b, label, **kw):
    """A SOFT sharded map under a router setting that drops lanes: every
    drop mask equal to the host rule (v2) or ``np_v1_drop_mask`` (v1),
    every kept lane's result equal to the reference fed the kept lanes
    only, and psyncs equal to the successful updates exactly."""
    rng = np.random.default_rng([SEED, capacity, 11])
    m = ShardedDurableMap(SetSpec(capacity=capacity, mode="soft",
                                  backend="bucket"),
                          n_shards=N_SHARDS, device=dev, **kw)
    ref = Reference(key_range, "soft")
    ops, keys, vals = traffic(rng, n_batches, b, key_range)
    dropped = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(n_batches):
            got = m.apply(ops[i], keys[i], vals[i])
            if m.sspec.router == "v1":
                kept = ~SH.np_v1_drop_mask(
                    keys[i], n_shards=N_SHARDS,
                    lane_budget=m.sspec.lane_budget(b))
            else:
                kept = host_kept(m.sspec, ops[i], keys[i])
            expect((m.last_drop_mask == ~kept).all(),
                   f"{label}: batch {i} drop mask differs from the host rule")
            ops_k = np.where(kept, ops[i], OP_NOP).astype(np.int32)
            exp = ref.apply(ops_k, keys[i], vals[i])
            ref.ops -= int((~kept).sum())
            expect((got == exp).all(), f"{label}: batch {i} results")
            dropped += int((~kept).sum())
    expect(m.router_dropped == dropped and dropped > 0,
           f"{label}: {m.router_dropped} lanes dropped, host rule "
           f"{dropped}")
    expect(m.psyncs == ref.psyncs and m.ops == ref.ops,
           f"{label}: psyncs {m.psyncs} (reference {ref.psyncs}), ops "
           f"{m.ops} ({ref.ops})")
    print(f"{label}: {n_batches} batches of {b}, {dropped} lanes dropped "
          f"as the host rule says, psyncs {m.psyncs} == successful updates")


def check_serve_shards(dev):
    """The port's serve CLI on the card with an 8-shard registry, plain and
    with the bucket registry snapshotted every step."""
    for extra in ([], ["--backend", "bucket", "--snapshot-every", "1"]):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(["--device", str(dev), "--arch",
                                 "qwen3-32b-smoke", "--shards",
                                 str(N_SHARDS), "--crash", "--requests", "4",
                                 "--prompt-len", "8", "--gen", "4",
                                 "--snapshot-dir", tmp, *extra])
            text = buf.getvalue()
        print(text, end="")
        backend = "bucket" if extra else "probe"
        expect(rc == 0
               and f"registry[{backend} x{N_SHARDS} shards]: 4 completed, "
                   "psyncs=4 (== #requests)" in text
               and "after crash+recovery: all 4 completions still "
                   "registered" in text
               and (not extra or "hybrid recovery: 0 delta slot(s) "
                    "re-scanned, 1024 restored from the snapshot" in text),
               f"serve --shards {N_SHARDS} {' '.join(extra)} did not print "
               "its lines")


def run_card_tests(label, select):
    """The card tests of tests/test_torch_cuda.py that ``select`` picks,
    in a child process (waited for)."""
    test = ROOT / "tests" / "test_torch_cuda.py"
    if not test.exists():
        expect(False, f"{label}: {test} is missing")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "-k", select, str(test)],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"{label}: {tail[0]} ({time.perf_counter() - t0:.1f} s)")
    expect(proc.returncode == 0,
           f"{label}: card tests failed:\n{proc.stdout[-4000:]}")


def check_shard_kernels(dev, cap, key_range, b):
    """The three kernels against their plain versions at the shapes one
    shard gives them: ``recovery_scan`` over a shard's pool, the bucket
    ``hash_probe`` and ``table_probe`` over a shard's index holding its
    share of the prefill, at the lane budget a ``b``-lane batch routes to
    each shard (the next power of two above ``b / S``, here 2b/S).
    Returns their JSON fields."""
    per, per_range = cap // N_SHARDS, key_range // N_SHARDS
    lanes_per_shard = 2 * b // N_SHARDS
    rows = {"recovery_scan": check_scan(dev, [per])}
    nb, w = SetSpec(capacity=per, backend="bucket").bucket_geometry()
    rows["hash_probe"] = check_probe(dev, capacity=per, key_range=per_range,
                                     live=per // 4, nb=nb, w=w,
                                     batches=[lanes_per_shard])
    rows["table_probe"] = check_shard_table_probe(dev, cap, key_range, b)
    return {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms")}
            for k, v in rows.items()}


def run_sharded_phase(dev):
    """Phase 3c.  Returns the sharded launches and the kernels' times at
    a shard's shapes for the JSON record."""
    t0 = time.perf_counter()
    cap, kr = 1 << 21, 1 << 20
    print(f"phase 3c: ShardedDurableMap, {N_SHARDS} shards of "
          f"{cap // N_SHARDS} slots (hash-1M geometry), key range 2^20")
    shapes = check_shard_kernels(dev, cap, kr, 1024)
    # 50 + 20 batches a backend and 15 compared: the depth cut to leave
    # room in the script's time
    _, bucket = run_sharded(dev, "bucket", cap, kr, 1 << 19, 50, 20, 1024,
                            snapshot=True, label="sharded bucket")
    _, probe = run_sharded(dev, "probe", cap, kr, 1 << 19, 50, 20, 1024,
                           label="sharded probe")
    rows = compare_sharding(dev, cap, kr, 1 << 19, 15, 1024, 10)
    flat, s8 = rows["flat"], rows[f"s{N_SHARDS}"]
    print(f"sharding at equal total capacity (bucket, SOFT): ops/s flat "
          f"{flat['ops_s']:.1f}, s1 {rows['s1']['ops_s']:.1f}, s{N_SHARDS} "
          f"{s8['ops_s']:.1f} ({s8['ops_s'] / flat['ops_s']:.3f}x flat); "
          f"device ops per batch {flat['dev_ops']:.1f} / "
          f"{rows['s1']['dev_ops']:.1f} / {s8['dev_ops']:.1f}; host syncs "
          f"per batch {flat['syncs']:.2f} / {rows['s1']['syncs']:.2f} / "
          f"{s8['syncs']:.2f}; recovery ms {flat['recovery_ms']:.3f} / "
          f"{rows['s1']['recovery_ms']:.3f} / {s8['recovery_ms']:.3f}")
    run_routed(dev, cap, kr, 10, 1024, "capped v2 (max_lane_budget 64, "
               "strided, 2 groups)", max_lane_budget=64,
               placement="strided", n_device_groups=2)
    run_routed(dev, cap, kr, 10, 1024, "v1 router", router="v1",
               lane_factor=1)
    check_serve_shards(dev)
    run_card_tests("sharded card tests", "sharded")
    print(f"phase 3c: {time.perf_counter() - t0:.1f} s")
    return {"recovery_scan": bucket["recovery_scan"],
            "hash_probe": bucket["hash_probe"],
            "table_probe": probe["table_probe"], "shapes": shapes}


# ---------------------------------------------------------------------------
# 3c2. the sharded map over 4 processes sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# phase 3c's geometry; a rehearsal on the CPU passes a smaller one
MESH_GEOMETRY = dict(capacity=1 << 21, key_range=1 << 20, prefill=1 << 19,
                     prefill_batch=PREFILL_BATCH, batches=50, after=10,
                     lanes=1024)


def timed_collectives():
    """Seconds and calls spent in this process's host-side collectives of
    ``launch/mesh.py`` (``all_gather``, ``all_reduce``, ``broadcast``),
    each one's wait for the other ranks included, while the block runs."""
    return timed_calls(mesh.dist, ("all_gather", "all_reduce", "broadcast"))


@contextlib.contextmanager
def timed_calls(owner, names):
    """Seconds and calls spent in ``owner``'s functions ``names``, from any
    thread, while the block runs."""
    spent = {"s": 0.0, "n": 0}
    real = {n: getattr(owner, n) for n in names}

    def timed(f):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent["s"] += time.perf_counter() - t
                spent["n"] += 1
        return call
    for n, f in real.items():
        setattr(owner, n, timed(f))
    try:
        yield spent
    finally:
        for n, f in real.items():
            setattr(owner, n, f)


def mesh_run(backend, snap_dir, device="cuda", geo=None):
    """One run of phase 3c2 on a ``use_shard_map`` map: on the mesh's rows
    inside a rank of a process group, on all 8 shards in a process without
    one.  The same seeded batches either way.  Returns every result, the
    counters, the per-shard recovery histogram, the rows held and their
    leaves, the ops/s of the mixed batches, the time and calls of the
    collectives in them, and this process's launches of the path's
    kernels."""
    g = geo or MESH_GEOMETRY
    lookup, lname = lookup_kernel(backend)
    scan_cuda.launches = lookup.launches = 0
    rng = np.random.default_rng([SEED, g["capacity"], 5])
    m = ShardedDurableMap(SetSpec(capacity=g["capacity"], mode="soft",
                                  backend=backend),
                          n_shards=N_SHARDS, device=device,
                          use_shard_map=True)
    pre = rng.choice(g["key_range"], g["prefill"], replace=False).astype(
        np.int32).reshape(-1, g["prefill_batch"])
    res = [m.insert(k, k * 7 + 1) for k in pre]
    sn, snap = None, None
    if backend == "bucket":
        sn = Snapshotter(m, snap_dir)
        snap = snapshot_cost(m, sn)
    n, lanes = g["batches"], g["lanes"]
    ops, keys, vals = traffic(rng, n + g["after"], lanes, g["key_range"])
    if m.mesh is not None:
        m.mesh.barrier()
    sync(m.device)
    with timed_collectives() as coll:
        t0 = time.perf_counter()
        res += [m.apply(ops[i], keys[i], vals[i]) for i in range(n)]
        sync(m.device)
        ops_s = n * lanes / (time.perf_counter() - t0)
    u = np.random.default_rng([SEED, 7]).random(
        (N_SHARDS, g["capacity"] // N_SHARDS)).astype(np.float32)
    if sn is not None:
        sn.recover(u)
        sn.close()
    else:
        m.crash_and_recover(u)
    hist = m.last_recovery_hist_shards
    res += [m.apply(ops[i], keys[i], vals[i]) for i in range(n, len(ops))]
    return {"results": np.stack(res[len(pre):]),
            "prefill": np.concatenate(res[:len(pre)]),
            "counters": (m.psyncs, m.ops, len(m)), "hist": hist,
            "rows": (m.rows.start, m.rows.stop),
            "leaves": {f: TE._host(getattr(m.state, f))
                       for f in m.state._fields},
            "ops_s": ops_s, "device": str(m.device),
            "coll_ms": 1e3 * coll["s"] / n, "coll_calls": coll["n"] / n,
            "snapshot": snap,
            "launches": {"recovery_scan": scan_cuda.launches,
                         lname: lookup.launches}}


def snapshot_cost(m, sn):
    """One snapshot of ``m`` through ``sn``, captured and waited for: the
    ``recovery_scan`` launches of its build in this process, the device
    memory its capture and build added to this process's peak (MiB), the
    ms of the capture on the main thread (``snapshot()``) and of
    ``wait()``, and the step."""
    cuda = m.device.type == "cuda"
    sync(m.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(m.device)
        base = torch.cuda.memory_allocated(m.device)
    scans = scan_cuda.launches
    t0 = time.perf_counter()
    sn.snapshot()
    t1 = time.perf_counter()
    step = sn.wait()
    t2 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(m.device) - base) / 2 ** 20 \
        if cuda else float("nan")
    return {"build_launches": scan_cuda.launches - scans, "peak_mib": peak,
            "capture_ms": 1e3 * (t1 - t0), "wait_ms": 1e3 * (t2 - t1),
            "step": step, "rows": (m.rows.start, m.rows.stop)}


def mesh_one_writer(snap_dir, device="cuda", geo=None):
    """Phase 3c2's map at one shard under ``use_shard_map`` (every rank
    holds the one row, D = 1): the prefill, three snapshots through the
    cadence and recovery through the last, more batches.  Returns the
    step each ``wait()`` gave, the results, counters and leaves."""
    g = geo or MESH_GEOMETRY
    cap = g["capacity"] // N_SHARDS
    rng = np.random.default_rng([SEED, cap, 6])
    m = ShardedDurableMap(SetSpec(capacity=cap, backend="bucket"),
                          n_shards=1, device=device, use_shard_map=True)
    pre = rng.choice(g["key_range"], cap // 4, replace=False).astype(
        np.int32).reshape(-1, g["prefill_batch"] // 4)
    res = [m.insert(k, k * 7 + 1) for k in pre]
    sn = Snapshotter(m, snap_dir, SnapshotPolicy(every_steps=1))
    ops, keys, vals = traffic(rng, 6, g["lanes"], g["key_range"])
    waits = []
    for i in range(3):
        res.append(m.apply(ops[i], keys[i], vals[i]))
        sn.maybe_snapshot()
        waits.append(sn.wait())
    u = np.random.default_rng([SEED, 8]).random((1, cap)).astype(np.float32)
    sn.recover(u)
    sn.close()
    res += [m.apply(ops[i], keys[i], vals[i]) for i in range(3, 6)]
    return {"waits": waits, "results": np.concatenate(res),
            "counters": (m.psyncs, m.ops, len(m)),
            "hist": m.last_recovery_hist_shards,
            "leaves": {f: TE._host(getattr(m.state, f))
                       for f in m.state._fields}}


def mesh_rank(rank, snap_dir, device, geo):
    """A rank of phase 3c2: both backends on the mesh, then one shard held
    by every rank."""
    out = {b: mesh_run(b, os.path.join(snap_dir, f"{b}_mesh"), device, geo)
           for b in ("bucket", "probe")}
    out["one_writer"] = mesh_one_writer(os.path.join(snap_dir, "d1_mesh"),
                                        device, geo)
    return out


def same_files(a, b) -> list:
    """The files of two snapshot step directories that differ, byte for
    byte (a file missing on either side differs)."""
    names = set(os.listdir(a)) | set(os.listdir(b))
    bad = []
    for n in sorted(names):
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            bad.append(n)
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                bad.append(n)
    return bad


def check_mesh(label, want, got, device):
    """Every rank against the one-process run: results, counters,
    histograms, its rows of every leaf, launches > 0."""
    expect(len(got) == MESH_RANKS, f"{label}: {len(got)} ranks answered")
    per = N_SHARDS // MESH_RANKS
    for r, g in enumerate(got):
        expect(g["rows"] == (r * per, (r + 1) * per),
               f"{label}: rank {r} holds rows {g['rows']}")
        on = str(mesh.ShardMesh(r, MESH_RANKS, None).device(device))
        expect(g["device"] == on, f"{label}: rank {r} on {g['device']}")
        for k in ("results", "prefill", "hist"):
            expect(np.array_equal(g[k], want[k]),
                   f"{label}: rank {r} {k} differ from one process")
        expect(tuple(g["counters"]) == tuple(want["counters"]),
               f"{label}: rank {r} psyncs/ops/len {g['counters']} != "
               f"{want['counters']}")
        lo, hi = g["rows"]
        for f, leaf in g["leaves"].items():
            w = want["leaves"][f][lo:hi]
            expect(leaf.dtype == w.dtype and np.array_equal(leaf, w),
                   f"{label}: rank {r} leaf {f} differs from one process")
        expect(all(v > 0 for v in g["launches"].values()),
               f"{label}: rank {r} launched {g['launches']}")
        if g["snapshot"] is not None:
            sn = g["snapshot"]
            expect(sn["step"] == want["snapshot"]["step"],
                   f"{label}: rank {r} waited for step {sn['step']}")
            # each rank builds its rows alone: one recovery_scan a row
            expect(sn["build_launches"] == hi - lo,
                   f"{label}: rank {r} launched recovery_scan "
                   f"{sn['build_launches']} times for the snapshot's build "
                   f"of its {hi - lo} rows")


def check_one_writer(want, got, dirs):
    """The one-shard map on every rank (D = 1) against one process: every
    rank waited for the same steps, and its results, counters, histogram
    and leaves equal; the store kept the same steps."""
    expect(dirs[0] == dirs[1], f"mesh one shard: stored {dirs[1]}, one "
           f"process {dirs[0]}")
    for r, g in enumerate(got):
        expect(g["waits"] == want["waits"] == [1, 2, 3],
               f"mesh one shard: rank {r} waited for {g['waits']}")
        for k in ("results", "hist"):
            expect(np.array_equal(g[k], want[k]),
                   f"mesh one shard: rank {r} {k} differ from one process")
        expect(tuple(g["counters"]) == tuple(want["counters"]),
               f"mesh one shard: rank {r} counters {g['counters']}")
        for f, leaf in g["leaves"].items():
            expect(np.array_equal(leaf, want["leaves"][f]),
                   f"mesh one shard: rank {r} leaf {f} differs")
    print(f"mesh one shard (D = 1, rank 0 the one writer): {len(got)} ranks "
          f"snapshotted steps {want['waits']} and recovered equal to one "
          f"process (store {dirs[1]})")


def run_mesh_phase(dev, smi, geo=None):
    """Phase 3c2.  Returns each backend's per-rank launches."""
    g = geo or MESH_GEOMETRY
    t0 = time.perf_counter()
    print(f"phase 3c2: ShardedDurableMap(use_shard_map=True) over "
          f"{MESH_RANKS} gloo ranks sharing one card, {N_SHARDS} shards of "
          f"{g['capacity'] // N_SHARDS} slots, key range {g['key_range']}, "
          f"{g['prefill']} keys prefilled, {g['batches']} + {g['after']} "
          f"mixed batches of {g['lanes']} lanes around a crash")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        one = {}
        for b in ("bucket", "probe"):
            one[b] = mesh_run(b, os.path.join(tmp, f"{b}_one"), str(dev),
                              geo)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        d1 = mesh_one_writer(os.path.join(tmp, "d1_one"), str(dev), geo)
        t1 = time.perf_counter()
        ranks = mesh.spawn(mesh_rank, MESH_RANKS, tmp, str(dev), geo)
        spawn_s = time.perf_counter() - t1
        step = f"step_{one['bucket']['snapshot']['step']:012d}"
        differ = same_files(os.path.join(tmp, "bucket_one", step),
                            os.path.join(tmp, "bucket_mesh", step))
        expect(not differ, f"mesh bucket: the stored files {differ} differ "
               "from the one-process snapshot's")
        d1_dirs = [sorted(os.listdir(os.path.join(tmp, d)))
                   for d in ("d1_one", "d1_mesh")]
    expect(one["bucket"]["snapshot"]["build_launches"] == N_SHARDS,
           f"one process: {one['bucket']['snapshot']['build_launches']} "
           f"recovery_scan launches for the build of {N_SHARDS} shards")
    check_one_writer(d1, [r["one_writer"] for r in ranks], d1_dirs)
    out = {}
    for b in ("bucket", "probe"):
        got = [r[b] for r in ranks]
        check_mesh(f"mesh {b}", one[b], got, str(dev))
        out[b] = [g["launches"] for g in got]
        print(f"mesh {b}: {MESH_RANKS} ranks equal to one process (results, "
              f"psyncs/ops/len {one[b]['counters']}, histograms, every "
              f"rank's rows of every leaf); ops/s of the {g['batches']} "
              f"batches: one process {one[b]['ops_s']:.1f}, {MESH_RANKS} "
              f"processes sharing one card (not a scaling figure) "
              f"{got[0]['ops_s']:.1f}; launches by rank {out[b]} ({smi})")
        print(f"mesh {b}: per batch of {g['lanes']} lanes, ms by rank "
              f"{[round(1e3 * g['lanes'] / x['ops_s'], 4) for x in got]}, "
              f"of which in gloo collectives (their wait for the other "
              f"ranks included) {[round(x['coll_ms'], 4) for x in got]} in "
              f"{got[0]['coll_calls']:.2f} calls; one process: "
              f"{1e3 * g['lanes'] / one[b]['ops_s']:.4f} ms, "
              f"{one[b]['coll_calls']:.2f} calls")
    snaps = [r["bucket"]["snapshot"] for r in ranks]
    mine = one["bucket"]["snapshot"]
    print(f"mesh bucket snapshot: each rank captures, builds and writes its "
          f"rows; stored files equal to one process's byte for byte; "
          f"recovery_scan launches for the build by rank "
          f"{[x['build_launches'] for x in snaps]} (one process "
          f"{mine['build_launches']}); device memory added to the peak by "
          f"the capture and build, MiB by rank "
          f"{[round(x['peak_mib'], 3) for x in snaps]} (one process "
          f"{mine['peak_mib']:.3f}); capture ms on the main thread by rank "
          f"{[round(x['capture_ms'], 3) for x in snaps]} (one process "
          f"{mine['capture_ms']:.3f}); wait ms by rank "
          f"{[round(x['wait_ms'], 3) for x in snaps]} (one process "
          f"{mine['wait_ms']:.3f}) ({smi})")
    print(f"phase 3c2: {time.perf_counter() - t0:.1f} s (the spawn and the "
          f"ranks' runs {spawn_s:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# 3d. the durable queue
# ---------------------------------------------------------------------------

QUEUE_MODES = ("soft", "linkfree", "logfree")
BACKLOG_BATCH = 8192               # lanes per batch of the 2^21 backlog


def queue_rounds(q, vals, b):
    """One enqueue of each row of ``vals`` and one ``b``-lane dequeue after
    it: the per-round enqueue oks (on the device) and the dequeues' host
    (values, ok)."""
    out = []
    for row in vals:
        out.append((q.enqueue(row), q.dequeue(b)))
    return out


def check_rounds(out, vals, ref, label):
    """Every enqueue succeeded and every dequeued value equals the host
    reference (a ``collections.deque``) in FIFO order."""
    oks = torch.stack([o[0] for o in out]).cpu().numpy()
    expect(oks.all(), f"{label}: an enqueue failed")
    for row, (_, (got, ok)) in zip(vals.cpu().numpy(), out):
        ref.extend(row.tolist())
        want = [ref.popleft() for _ in range(int(ok.sum()))]
        expect(ok.all() and got.tolist() == want,
               f"{label}: dequeued values differ from the host reference")


def run_queue(dev, mode, capacity=1 << 16, b=1024, rounds=50, n_probe=10):
    """bench_queue.py's steady state through the facade: ``rounds`` of one
    ``b``-lane enqueue and one ``b``-lane dequeue, every value against a
    host deque; psyncs per successful op exact; then the same rounds
    through the functional API with no host read (bench_queue's own
    loop), host syncs by site and a profiled window of ``n_probe``
    rounds each.  Returns (facade ops/s, functional ops/s, syncs per
    round, device ops per round)."""
    rng = np.random.default_rng([SEED, capacity, QUEUE_MODES.index(mode)])
    spec = QueueSpec(capacity=capacity, mode=mode)
    q = DurableQueue(spec, device=dev)
    ref = collections.deque()
    label = f"queue {mode}"

    def batches(n):
        return torch.from_numpy(rng.integers(0, 1 << 30, (n, b),
                                             dtype=np.int32)).to(dev)

    warm = batches(1)
    check_rounds(queue_rounds(q, warm, b), warm, ref, f"{label} warm-up")
    vals = batches(rounds)
    p0, o0 = q.psyncs, q.ops
    sync(dev)
    t0 = time.perf_counter()
    out = queue_rounds(q, vals, b)
    sync(dev)
    ops_s = 2 * b * rounds / (time.perf_counter() - t0)
    check_rounds(out, vals, ref, label)
    d_ops, d_psync = q.ops - o0, q.psyncs - p0
    per_op = d_psync / d_ops
    expect(d_ops == 2 * b * rounds and per_op == spec.psync_per_success(),
           f"{label}: {per_op} psyncs per successful op, expected "
           f"{spec.psync_per_success()}")
    expect(not q.overflowed and len(q) == len(ref) == 0,
           f"{label}: the ring is not empty at the end")

    # bench_queue's loop: the functional ops, no host read inside
    state = q.state
    want = torch.ones((b,), dtype=torch.bool, device=dev)
    vals = batches(rounds)
    sync(dev)
    t0 = time.perf_counter()
    got = []
    for row in vals:
        state, _, _ = TQ.enqueue(state, row, spec=spec)
        state, v, _, _ = TQ.dequeue(state, want, spec=spec)
        got.append(v)
    sync(dev)
    fn_ops_s = 2 * b * rounds / (time.perf_counter() - t0)
    expect(torch.equal(torch.stack(got), vals),
           f"{label}: the functional rounds dequeued other values")
    q.state = state

    probe = batches(n_probe)
    sync(dev)
    with sync_sites() as (sites, other):
        out = queue_rounds(q, probe, b)
    check_rounds(out, probe, ref, f"{label} sync count")
    print_sites(label, f"{n_probe} rounds", sites, other)
    syncs = sum(sites.values()) / n_probe

    from torch.profiler import ProfilerActivity, profile as torch_profile
    probe = batches(n_probe)
    sync(dev)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = queue_rounds(q, probe, b)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    check_rounds(out, probe, ref, f"{label} profiled")
    rows, busy = device_rows(prof)
    dev_ops = sum(r[1] for r in rows) / n_probe
    print(f"{label}: {capacity} slots, {b}-lane batches, {rounds} rounds; "
          f"facade {ops_s:.1f} ops/s, functional (no host read) "
          f"{fn_ops_s:.1f} ops/s; psyncs per successful op {per_op:.3f}; "
          f"{syncs:.2f} host syncs per round in the port's code; profile "
          f"of {n_probe} rounds: {dev_ops:.1f} device ops per round, busy "
          f"{busy:.1f} of {wall_us:.1f} us ({100 * busy / wall_us:.2f}%)")
    for us, n, key in rows[:6]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    return ops_s, fn_ops_s, syncs, dev_ops


def failed_op_psyncs(dev, b=1024):
    """bench_queue.py's probe: psyncs charged to FAILED lanes (a 2b-lane
    enqueue into a b-slot ring, a 2b-lane dequeue, a dequeue on empty)."""
    spec = QueueSpec(capacity=b)
    state = TQ.make_state(spec, device=dev)
    state, ok, _ = TQ.enqueue(state, torch.arange(2 * b, dtype=torch.int32,
                                                  device=dev), spec=spec)
    extra = int(state.n_psync) - int(ok.sum())
    want = torch.ones((2 * b,), dtype=torch.bool, device=dev)
    p0 = int(state.n_psync)
    state, _, ok, _ = TQ.dequeue(state, want, spec=spec)
    extra += int(state.n_psync) - p0 - int(ok.sum())
    p0 = int(state.n_psync)
    state, _, ok, _ = TQ.dequeue(state, want, spec=spec)
    expect(not bool(ok.any()), "failed-op probe: a dequeue on empty won")
    return extra + int(state.n_psync) - p0


def backlog_traffic(q, rng, dev, ref, enq, deq):
    """``enq`` values in, then ``deq`` out, in batches of BACKLOG_BATCH,
    tracked in ``ref`` (a numpy list of every value and the head index)."""
    for s in range(0, enq, BACKLOG_BATCH):
        v = rng.integers(0, 1 << 30, min(BACKLOG_BATCH, enq - s),
                         dtype=np.int32)
        ref["vals"].append(v)
        expect(bool(q.enqueue(torch.from_numpy(v).to(dev)).all()),
               "backlog: an enqueue failed")
    for s in range(0, deq, BACKLOG_BATCH):
        _, ok = q.dequeue(min(BACKLOG_BATCH, deq - s))
        expect(ok.all(), "backlog: a dequeue failed")
    ref["head"] += deq


def check_backlog(q, ref, label):
    """Drain ``q`` and hold every value against the reference."""
    want = np.concatenate(ref["vals"])[ref["head"]:]
    got = []
    while len(q):
        v, ok = q.dequeue(BACKLOG_BATCH)
        got.append(v[ok])
    got = np.concatenate(got) if got else np.zeros(0, np.int32)
    expect(np.array_equal(got, want),
           f"{label}: {got.size} values drained, {want.size} expected, or "
           "they differ")


def run_queue_backlog(dev, n=1 << 21):
    """The 2^21-slot backlog: fill the ring, drain half, enqueue past N
    (the ring wraps), drain some more; crash under a seeded float32
    adversary and recover (every leaf against the plain path, the
    histogram, head and tail; recovery psyncs 0; recovery_scan once).
    Then a snapshot through the Snapshotter, more traffic, a crash and
    ``Snapshotter.recover`` against the full recovery of a copy of the
    same state (recovery_scan once, on the delta).  Returns the numbers."""
    rng = np.random.default_rng([SEED, n])
    spec = QueueSpec(capacity=n)
    q = DurableQueue(spec, device=dev)
    ref = {"vals": [], "head": 0}
    out = {}
    sync(dev)
    t0 = time.perf_counter()
    backlog_traffic(q, rng, dev, ref, n, n // 2)
    backlog_traffic(q, rng, dev, ref, n // 4, n // 8)
    sync(dev)
    out["fill_s"] = time.perf_counter() - t0
    tail, head = n + n // 4, n // 2 + n // 8
    expect((int(q.state.head), int(q.state.tail)) == (head, tail)
           and tail > n, "backlog: the cursors before the crash")
    u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    pre = clone_state(q.state)
    scan_cuda.launches = 0
    sync(dev)
    with sync_sites() as (sites, other):
        q.crash_and_recover(u)
    print_sites("queue backlog recovery", "crash_and_recover", sites, other)
    out["launches_full"] = scan_cuda.launches
    expect(scan_cuda.launches == 1,
           f"backlog: recovery launched recovery_scan {scan_cuda.launches} "
           "times, expected 1")
    out["full_ms_first"] = q.last_recovery_seconds * 1e3
    plain, plain_hist = TQ.crash_and_recover(
        clone_state(pre), u, spec=QueueSpec(capacity=n, use_kernels=False))
    expect(all(torch.equal(a, b) for a, b in zip(q.state, plain)),
           "backlog: a leaf differs from the plain path's recovery")
    hist = q.last_recovery_hist
    expect((hist == plain_hist.cpu().numpy()).all()
           and int(hist.sum()) == n and int(hist[VALID]) == tail - head,
           f"backlog: histogram {hist.tolist()}")
    expect((int(q.state.head), int(q.state.tail)) == (head, tail)
           and q.psyncs == 0 and not q.overflowed,
           "backlog: cursors, psyncs or latch after recovery")
    warm = []
    for _ in range(3):
        x = DurableQueue(spec, device=dev)
        x.state = clone_state(pre)
        x.crash_and_recover(u)
        warm.append(round(x.last_recovery_seconds * 1e3, 3))
        del x
    out["full_ms_warm"] = warm

    with tempfile.TemporaryDirectory(prefix="chip_smoke_queue_") as tmp:
        sn = Snapshotter(q, tmp)
        sync(dev)
        t0 = time.perf_counter()
        sn.snapshot()
        out["capture_ms"] = (time.perf_counter() - t0) * 1e3
        sn.wait()
        out["build_save_ms"] = sn.last_duration * 1e3
        w = int(sn.store.extra()["watermark"])
        backlog_traffic(q, rng, dev, ref, n // 16, n // 32)
        pre = clone_state(q.state)
        out["delta"] = int((pre.stamp > w).sum())
        scan_cuda.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        sn.recover(u)
        sync(dev)
        out["snapshotter_recover_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches_hybrid"] = scan_cuda.launches
        expect(scan_cuda.launches == 1,
               f"queue hybrid: recovery_scan launched {scan_cuda.launches} "
               "times, expected 1 (on the delta)")
        out["hybrid_ms"] = q.last_recovery_seconds * 1e3
        full = DurableQueue(spec, device=dev)
        full.state = clone_state(pre)
        full.crash_and_recover(u)
        out["hybrid_full_ms"] = full.last_recovery_seconds * 1e3
        for f in q.state._fields:
            if f not in ("n_psync", "n_ops"):
                expect(torch.equal(getattr(q.state, f),
                                   getattr(full.state, f)),
                       f"queue hybrid: leaf {f} differs from full recovery")
        expect((q.last_recovery_hist == full.last_recovery_hist).all()
               and q.psyncs == 0,
               "queue hybrid: histogram or recovery psyncs")
        sn.close()
        del full
    check_backlog(q, ref, "backlog after both recoveries")
    print(f"queue backlog: {n} slots, tickets to {tail} (wrapped), "
          f"{tail - head} live at the crash, filled in {out['fill_s']:.3f} s "
          f"({BACKLOG_BATCH}-lane batches); full recovery "
          f"{out['full_ms_first']:.3f} ms (first call), warm repeats "
          f"{out['full_ms_warm']} ms; histogram {hist.tolist()}; recovery "
          f"psyncs 0")
    print(f"queue hybrid: capture {out['capture_ms']:.3f} ms, build + save "
          f"{out['build_save_ms']:.3f} ms; delta {out['delta']} slots; "
          f"hybrid recovery {out['hybrid_ms']:.3f} ms, Snapshotter.recover "
          f"(store read included) {out['snapshotter_recover_ms']:.3f} ms, "
          f"full recovery of the same planes {out['hybrid_full_ms']:.3f} ms")
    return out


QUEUE_SERVE_RUNS = (
    ["--queue", "--crash"],
    ["--queue", "--backend", "bucket", "--snapshot-every", "1", "--crash"],
    ["--shards", str(N_SHARDS), "--pipeline", "2", "--queue", "--crash"])


def check_serve_queue(dev):
    """The serve CLI's spine on the card at smoke size: its spine lines,
    3 spine psyncs per request plus the registry's 1, the late acks
    redelivered, zero recovery psyncs.  Returns the launches."""
    launches = {}
    for extra in QUEUE_SERVE_RUNS:
        for fn in (scan_cuda, probe_cuda, table_probe_cuda):
            fn.launches = 0
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(["--device", str(dev), "--arch",
                                 "qwen3-32b-smoke", "--requests", "4",
                                 "--prompt-len", "8", "--gen", "4",
                                 "--snapshot-dir", tmp, *extra])
            text = buf.getvalue()
        print(text, end="")
        tag = " ".join(extra)
        shards = N_SHARDS if "--shards" in extra else 1
        backend = "bucket" if "bucket" in extra else "probe"
        reg = (f"registry[{backend}{f' x{shards} shards' if shards > 1 else ''}"
               "]: 4 completed, psyncs=4 (== #requests)")
        expect(rc == 0 and "total spine psyncs=12" in text and reg in text
               and "spine after crash+recovery: 4 acked requests "
                   "redelivered and committed, 8 completions survive, "
                   "request queue drained (len=0); recovery psyncs: "
                   "registry=0 req_queue=0 resp_queue=0" in text,
               f"serve {tag} did not print its spine lines")
        launches[tag] = {"recovery_scan": scan_cuda.launches,
                         "hash_probe": probe_cuda.launches,
                         "table_probe": table_probe_cuda.launches}
        # the registry once per shard (hybrid: its snapshot's build too),
        # each queue once (hybrid: its snapshot's build too)
        n_scan = (2 * 3 if "--snapshot-every" in extra else shards + 2)
        expect(launches[tag]["recovery_scan"] == n_scan,
               f"serve {tag}: recovery_scan launched "
               f"{launches[tag]['recovery_scan']} times, expected {n_scan}")
        print(f"serve {tag} launches: {launches[tag]}")
    return launches


def run_queue_phase(dev):
    """Phase 3d.  Returns the queue's launches and recovery_scan's times at
    the queue's shapes for the JSON record."""
    t0 = time.perf_counter()
    print("phase 3d: DurableQueue, a 65536-slot ring with 1024-lane batches "
          "in each mode, a 2^21-slot backlog, the serve spine")
    shapes = {f"N={n}": {k: v for k, v in check_scan(dev, [n]).items()
                         if k != "max_abs_err"}
              for n in (1 << 16, 1 << 21)}
    rows = {mode: run_queue(dev, mode) for mode in QUEUE_MODES}
    failed = failed_op_psyncs(dev)
    expect(failed == 0, f"failed-op probe paid {failed} psyncs")
    print("queue summary (65536 slots, 1024 lanes): facade ops/s "
          + " / ".join(f"{rows[m][0]:.1f}" for m in QUEUE_MODES)
          + ", functional ops/s "
          + " / ".join(f"{rows[m][1]:.1f}" for m in QUEUE_MODES)
          + f" (soft / linkfree / logfree); failed-op psyncs {failed}")
    backlog = run_queue_backlog(dev)
    serve_launches = check_serve_queue(dev)
    run_card_tests("queue card tests", "queue")
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s")
    return {"recovery_scan": {"backlog_recovery": backlog["launches_full"],
                              "hybrid_recovery": backlog["launches_hybrid"],
                              "serve": {k: v["recovery_scan"] for k, v in
                                        serve_launches.items()}},
            "hash_probe": {k: v["hash_probe"]
                           for k, v in serve_launches.items()},
            "table_probe": {k: v["table_probe"]
                            for k, v in serve_launches.items()},
            "shapes": shapes}


# ---------------------------------------------------------------------------
# 3e. online resize
# ---------------------------------------------------------------------------

RESIZE_SHARDS = 4                  # before the split; 2x after it
RESIZE_CHUNK = 4096                # migrate_chunk, the JAX default


def live_per_shard(ref, n_shards):
    """The reference's live keys per shard at ``n_shards``."""
    live = np.flatnonzero(ref.present).astype(np.int32)
    return np.bincount(SH.np_shard_of(live, n_shards), minlength=n_shards)


def elastic_map(dev, backend, per_shard, key_range, rng, ref, label):
    """A SOFT ``ElasticShardedMap`` of ``RESIZE_SHARDS`` shards of
    ``per_shard`` slots, prefilled to half its capacity in
    ``PREFILL_BATCH``-lane batches against ``ref``."""
    m = ElasticShardedMap(SetSpec(capacity=per_shard * RESIZE_SHARDS,
                                  mode="soft", backend=backend),
                          n_shards=RESIZE_SHARDS, migrate_chunk=RESIZE_CHUNK,
                          device=dev)
    n = per_shard * RESIZE_SHARDS // 2
    prefill(m, ref, dev, rng, key_range, n, min(PREFILL_BATCH, n), label)
    return m


def split_steps(m) -> int:
    """Steps of an S -> 2S split: per parent, its chunks and a commit."""
    per = m.sspec.per_shard_capacity
    return m.n_shards * (-(-per // m.migrate_chunk) + 1)


def live_split(m, ref, dev, rng, key_range, b, label):
    """An online split with one ``step()`` per ``b``-lane batch of mixed
    traffic, timed from ``begin_split`` to the finalize: every result, the
    size and the counters against the reference, the nodes each commit
    moved against the parent's live keys at that point, and the migration
    psyncs against 1 + S * chunks + 2 S + 1.  Returns ops/s."""
    s0, n = m.n_shards, split_steps(m)
    ops, keys, vals = traffic(rng, n, b, key_range)
    mp0, moved = m.migration_psyncs, {}
    sync(dev)
    t0 = time.perf_counter()
    m.begin_split()
    out = []
    for i in range(n):
        out.append(m.apply(ops[i], keys[i], vals[i]))
        f0, n0 = m.frontier.committed, m.migrated_nodes
        done = m.step()
        if m.migrated_nodes != n0:
            moved[i] = (f0, m.migrated_nodes - n0)
        expect(done == (i == n - 1),
               f"{label}: the split finished at step {i + 1} of {n}")
    sync(dev)
    dt = time.perf_counter() - t0
    got = results(out)
    for i in range(n):
        expect((got[i] == ref.apply(ops[i], keys[i], vals[i])).all(),
               f"{label}: batch {i} results differ from the reference")
        if i in moved:
            unit, nodes = moved[i]
            live = int(live_per_shard(ref, s0)[unit])
            expect(nodes == live, f"{label}: commit of unit {unit} moved "
                   f"{nodes} nodes, the parent held {live}")
    expect(sorted(u for u, _ in moved.values()) == list(range(s0)),
           f"{label}: units committed {sorted(moved.values())}")
    want = 1 + s0 * (-(-m.sspec.per_shard_capacity // m.migrate_chunk)) \
        + 2 * s0 + 1
    expect(m.migration_psyncs - mp0 == want,
           f"{label}: {m.migration_psyncs - mp0} migration psyncs, "
           f"expected {want}")
    expect(m.n_shards == 2 * s0 and not m.migrating and m.splits >= 1,
           f"{label}: geometry after the split")
    expect(len(m) == int(ref.present.sum()), f"{label}: size")
    expect(m.psyncs == ref.psyncs and m.ops == ref.ops,
           f"{label}: hot psyncs {m.psyncs} (successful updates "
           f"{ref.psyncs}), ops {m.ops} ({ref.ops})")
    print(f"{label}: {n} batches of {b} with one step() each, "
          f"{want} migration psyncs, {sum(v for _, v in moved.values())} "
          f"nodes moved in {len(moved)} commits, each the parent's live "
          f"count; hot psyncs == successful updates ({ref.psyncs})")
    return ops.size / dt


def resize_drill(m, ref, dev, label, n_scans):
    """Crash the elastic map and recover it: recovery psyncs 0,
    ``recovery_scan`` once per recovered shard of both maps, the whole key
    range against the reference.  Returns the launches read."""
    u = np.random.default_rng([SEED, 31, len(label)]).random(
        tuple(m.map.state.cur.shape)).astype(np.float32)
    scan_cuda.launches = 0
    m.crash_and_recover(u, seed=SEED)
    scans = scan_cuda.launches
    print(f"{label}: frontier {m.frontier}, recovery "
          f"{m.last_recovery_seconds * 1e3:.3f} ms, psyncs after it "
          f"{m.psyncs}, recovery_scan launched {scans} times (expected "
          f"{n_scans}: one per shard of both maps)")
    expect(m.psyncs == 0 and m.ops == 0,
           f"{label}: counters after recovery (recovery psyncs)")
    expect(scans == n_scans, f"{label}: recovery_scan launched {scans} "
           f"times, expected {n_scans}")
    ref.psyncs = ref.ops = 0
    check_membership(m, ref, dev, MEMBER_CHUNK, label)
    return scans


def step_until(m, stop, sites):
    """Step the migration until ``stop(steps taken)`` holds, the host syncs
    of each step added to ``sites["chunk"]`` or ``sites["commit"]`` by
    site."""
    n = 0
    while not stop(n):
        n += 1
        n0 = m.migrated_nodes
        with sync_sites() as (port, _):
            m.step()
        into = sites["commit" if m.migrated_nodes != n0 else "chunk"]
        into["steps"] = into.get("steps", 0) + 1
        for k, v in port.items():
            into[k] = into.get(k, 0) + v


def check_load_resharded(dev, m, ref, tmp, label):
    """Snapshot the 8-shard map through ``Snapshotter`` and load it at half
    and at twice the shard count with ``load_resharded``: each load equal,
    leaf for leaf, to a full recovery at 8 followed by ``reshard_planes``
    and ``shard.recover``, the whole key range against the reference,
    recovery psyncs 0, ``recovery_scan`` once per new shard.  Returns
    ``{new S: (ms, launches)}``."""
    inner = m.map
    w = int(inner.state.epoch.max())
    sn = Snapshotter(inner, tmp)
    sn.snapshot()
    sn.wait()
    sn.close()
    pool = TE.export_pool(inner.state)         # no traffic since the capture
    full, _ = SH.recover(*(TE._on_device(pool[f], dev, np.int32)
                           for f in PLANES), sspec=inner.sspec)
    canon = {"stage": TE._host(full.cur), "keys": TE._host(full.keys),
             "values": TE._host(full.values), "stamp": TE._host(full.stamp)}
    del full
    per, s = inner.sspec.per_shard_capacity, inner.n_shards
    out = {}
    for new_s in (s // 2, 2 * s):
        spec = SetSpec(capacity=per * new_s, mode="soft", backend="bucket")
        scan_cuda.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        lm = load_resharded(tmp, spec, new_s, device=dev)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        scans = scan_cuda.launches
        planes = reshard_planes(canon, s, new_s)
        off, _ = SH.recover(*(TE._on_device(planes[f], dev, np.int32)
                              for f in PLANES), sspec=lm.sspec)
        for f in off._fields:
            if f != "epoch":
                expect(torch.equal(getattr(lm.map.state, f),
                                   getattr(off, f)),
                       f"{label} at {new_s}: leaf {f} differs from the "
                       "offline reshard of a full recovery")
        expect(bool((lm.map.state.epoch > w).all()),
               f"{label} at {new_s}: epoch not above the watermark {w}")
        expect(lm.psyncs == 0 and len(lm) == int(ref.present.sum()),
               f"{label} at {new_s}: psyncs {lm.psyncs}, size {len(lm)}")
        expect(scans == new_s, f"{label} at {new_s}: recovery_scan "
               f"launched {scans} times, expected {new_s}")
        lref = Reference(ref.present.size, "soft")
        lref.present, lref.value = ref.present.copy(), ref.value.copy()
        check_membership(lm, lref, dev, MEMBER_CHUNK, f"{label} at {new_s}")
        print(f"{label}: {s} -> {new_s} shards in {ms:.3f} ms, "
              f"recovery_scan {scans} launches, every leaf equal to the "
              "offline reshard, recovery psyncs 0")
        out[str(new_s)] = (ms, scans)
        del lm, off
        torch.cuda.empty_cache()
    return out


def probe_split(dev, per_shard, key_range, b):
    """The probe backend: a blocking split of a filled 4-shard map, then
    20 batches; ``table_probe`` and ``recovery_scan`` must launch, and the
    children's probe-table rebuild is timed alone.  Returns the numbers
    and the launches."""
    rng = np.random.default_rng([SEED, 41])
    ref = Reference(key_range, "soft")
    m = elastic_map(dev, "probe", per_shard, key_range, rng, ref,
                    "resize probe")
    scan_cuda.launches = table_probe_cuda.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    m.split()
    sync(dev)
    split_ms = (time.perf_counter() - t0) * 1e3
    rebuild_ms = 0.0
    st = m.map.state
    for r in range(m.n_shards):
        table, ovf, ms = build_probe_table(
            dev, st.keys[r], st.cur[r] == VALID, m.spec.table_factor,
            m.spec.max_probe)
        expect(torch.equal(table, st.table[r]) and not ovf,
               f"resize probe: child {r}'s table differs from a fresh build")
        rebuild_ms += ms
    ops_s = drive(m, ref, dev, *traffic(rng, 20, b, key_range),
                  "resize probe after the split")
    launches = {"recovery_scan": scan_cuda.launches,
                "table_probe": table_probe_cuda.launches}
    print(f"resize probe: blocking split {RESIZE_SHARDS} -> {m.n_shards} "
          f"shards of a filled map ({len(m)} live) {split_ms:.3f} ms, the "
          f"children's table rebuild alone {rebuild_ms:.3f} ms "
          f"({100 * rebuild_ms / split_ms:.1f}%); 20 batches after it "
          f"{ops_s:.1f} ops/s; launches {launches}")
    expect(launches["recovery_scan"] == m.n_shards
           and launches["table_probe"] > 0,
           "resize probe: a kernel of the probe resize path was not "
           "launched as expected")
    return {"split_ms": split_ms, "rebuild_ms": rebuild_ms,
            "ops_s": ops_s}, launches


def check_merge_refusal(dev):
    """``begin_merge`` refuses a pair that does not fit, and leaves the map
    as it was."""
    m = ElasticShardedMap(SetSpec(capacity=1024, mode="soft",
                                  backend="bucket"), n_shards=2, device=dev)
    keys = np.arange(1, 601, dtype=np.int32)
    expect(m.insert(keys).all(), "refusal map: prefill")
    try:
        m.begin_merge()
        refused = False
    except ResizeCapacityError as e:
        refused = True
        print(f"merge refusal: {e}")
    expect(refused and not m.migrating and m.n_shards == 2 and len(m) == 600
           and m.migration_psyncs == 0,
           "begin_merge did not refuse a pair past the per-shard capacity")


RESIZE_SERVE_RUNS = (
    ["--shards", "2", "--autosplit", "0.001", "--crash"],
    ["--shards", "2", "--autosplit", "0.001", "--queue", "--crash"])


def check_serve_autosplit(dev):
    """The serve CLI with ``--autosplit`` on the card at smoke size: the
    split fires after the first serving step and completes (2 -> 4
    shards), every completion registered before and after the crash, the
    registry's recovery psyncs 0 (printed by the spine's line), and
    ``recovery_scan`` once per rebuilt child and per recovered shard.
    Returns the launches."""
    launches = {}
    for extra in RESIZE_SERVE_RUNS:
        for fn in (scan_cuda, probe_cuda, table_probe_cuda):
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--device", str(dev), "--arch",
                             "qwen3-32b-smoke", "--requests", "4",
                             "--prompt-len", "8", "--gen", "4", *extra])
        text = buf.getvalue()
        print(text, end="")
        tag = " ".join(extra)
        queue = "--queue" in extra
        expect(rc == 0
               and "autosplit: fill 0.004 >= 0.001 -> online split S=2 -> 4"
               in text
               and "registry[probe x2 shards]: 4 completed, psyncs=4 "
                   "(== #requests)" in text
               and "elastic registry: n_shards=4 (splits=1)" in text
               and "hot-path psyncs=4 (== #requests, unchanged)" in text
               and "after crash+recovery: all 4 completions still "
                   "registered" in text
               and (not queue or "recovery psyncs: registry=0 req_queue=0 "
                    "resp_queue=0" in text),
               f"serve {tag} did not print its lines")
        launches[tag] = {"recovery_scan": scan_cuda.launches,
                         "table_probe": table_probe_cuda.launches}
        # 2 children per unit of the split, then every shard of the 4-shard
        # registry at the crash, and each queue
        n_scan = 2 * 2 + 4 + (2 if queue else 0)
        print(f"serve {tag}: registry n_shards 4, launches {launches[tag]} "
              f"(recovery_scan expected {n_scan})")
        expect(launches[tag]["recovery_scan"] == n_scan
               and launches[tag]["table_probe"] > 0,
               f"serve {tag}: launches {launches[tag]}")
    return launches


def run_resize_phase(dev, per=1 << 18, kr=1 << 20, b=1024):
    """Phase 3e: ``RESIZE_SHARDS`` shards of ``per`` slots, key range
    ``kr``, ``b``-lane batches.  Returns the launches on the resize path
    for the JSON record."""
    t0 = time.perf_counter()
    print(f"phase 3e: ElasticShardedMap, {RESIZE_SHARDS} shards of {per} "
          f"slots split online to {2 * RESIZE_SHARDS}, key range {kr}, "
          f"{b}-lane batches, migrate_chunk {RESIZE_CHUNK}")
    rng = np.random.default_rng([SEED, 40])
    ref = Reference(kr, "soft")
    m = elastic_map(dev, "bucket", per, kr, rng, ref, "resize bucket")
    # 10 batches before and after the split: the depth cut to leave room
    # in the script's time
    before = drive(m, ref, dev, *traffic(rng, 10, b, kr),
                   "resize before the split")
    scan_cuda.launches = probe_cuda.launches = 0
    during = live_split(m, ref, dev, rng, kr, b, "resize live split")
    live = {"recovery_scan": scan_cuda.launches,
            "hash_probe": probe_cuda.launches}
    print(f"resize live split launches: {live}")
    expect(live["recovery_scan"] == 2 * RESIZE_SHARDS
           and live["hash_probe"] > 0,
           "resize live split: recovery_scan not once per child, or no "
           "lookup launched")
    after = drive(m, ref, dev, *traffic(rng, 10, b, kr),
                  "resize after the split")
    check_membership(m, ref, dev, MEMBER_CHUNK, "resize after the split")
    print(f"resize ops/s (bucket, SOFT, {b} lanes): before the split "
          f"{before:.1f} ({RESIZE_SHARDS} shards), during it {during:.1f}, "
          f"after it {after:.1f} ({m.n_shards} shards); "
          f"{m.migration_psyncs / m.migrated_nodes:.6f} migration psyncs "
          "per migrated node")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resize_") as tmp:
        loads = check_load_resharded(dev, m, ref, tmp, "load_resharded")

    # blocking merge 8 -> 4, then a quiescent split against the offline
    # rebuild, both timed on the filled map
    sync(dev)
    t1 = time.perf_counter()
    m.merge()
    sync(dev)
    merge_ms = (time.perf_counter() - t1) * 1e3
    expect(m.n_shards == RESIZE_SHARDS, "resize: merge geometry")
    check_membership(m, ref, dev, MEMBER_CHUNK, "resize after the merge")
    planes = TE.export_pool(m.map.state)
    mp0, mn0 = m.migration_psyncs, m.migrated_nodes
    sync(dev)
    t1 = time.perf_counter()
    m.split()
    sync(dev)
    split_ms = (time.perf_counter() - t1) * 1e3
    per_node = (m.migration_psyncs - mp0) / (m.migrated_nodes - mn0)
    split = split_planes(planes, RESIZE_SHARDS)
    off, _ = SH.recover(*(TE._on_device(split[f], dev, np.int32)
                          for f in PLANES), sspec=m.sspec)
    for f in off._fields:
        if f not in ("n_psync", "n_ops"):
            expect(torch.equal(getattr(m.map.state, f), getattr(off, f)),
                   f"resize: quiescent split leaf {f} differs from the "
                   "offline split_planes + shard.recover")
    del off
    print(f"resize blocking merge {2 * RESIZE_SHARDS} -> {RESIZE_SHARDS} "
          f"{merge_ms:.3f} ms (content kept); blocking split of the filled "
          f"map ({len(m)} live) {split_ms:.3f} ms, every leaf equal to the "
          f"offline rebuild, {per_node:.6f} migration psyncs per node")

    # crash drills during a stepped split, with host syncs per step
    m.merge()
    sites = {"chunk": {}, "commit": {}}
    drills = []
    m.begin_split()
    both = RESIZE_SHARDS + 2 * RESIZE_SHARDS
    drills.append(resize_drill(m, ref, dev, "drill after begin_split", both))
    step_until(m, lambda n: n >= 4, sites)         # 4 of unit 0's chunks
    drills.append(resize_drill(m, ref, dev, "drill mid-copy of unit 0", both))
    step_until(m, lambda n: m.frontier.committed >= 2, sites)
    drills.append(resize_drill(m, ref, dev, "drill after unit 1's commit",
                               both))
    step_until(m, lambda n: not m.migrating, sites)
    drills.append(resize_drill(m, ref, dev, "drill after the finalize",
                               2 * RESIZE_SHARDS))
    drive(m, ref, dev, *traffic(rng, 5, b, kr), "resize after the drills")
    for kind, found in sites.items():
        n = found.pop("steps")
        print(f"resize host syncs per {kind} step in the port's code over "
              f"{n} steps: {sum(found.values()) / n:.2f} ("
              + ", ".join(f"{k} x{v}" for k, v in sorted(found.items()))
              + ")")
    del m
    torch.cuda.empty_cache()

    probe, probe_launches = probe_split(dev, per, kr, b)
    torch.cuda.empty_cache()
    check_merge_refusal(dev)
    serve_launches = check_serve_autosplit(dev)
    run_card_tests("resize card tests", "resize or elastic")
    print(f"resize summary (bucket, SOFT, {RESIZE_SHARDS} -> "
          f"{2 * RESIZE_SHARDS} shards of {per} slots): ops/s before "
          f"{before:.1f}, during {during:.1f}, after {after:.1f}; blocking "
          f"split {split_ms:.3f} ms, merge {merge_ms:.3f} ms; probe split "
          f"{probe['split_ms']:.3f} ms (table rebuild "
          f"{probe['rebuild_ms']:.3f} ms); load_resharded "
          + ", ".join(f"to {k} shards {v[0]:.3f} ms"
                      for k, v in loads.items()))
    print(f"phase 3e: {time.perf_counter() - t0:.1f} s")
    return {"recovery_scan": {
                "live_split": live["recovery_scan"], "crash_drills": drills,
                "load_resharded": {k: v[1] for k, v in loads.items()},
                "probe_split": probe_launches["recovery_scan"],
                "serve": {k: v["recovery_scan"]
                          for k, v in serve_launches.items()}},
            "hash_probe": {"live_split": live["hash_probe"]},
            "table_probe": {"probe_split": probe_launches["table_probe"],
                            "serve": {k: v["table_probe"]
                                      for k, v in serve_launches.items()}}}


# ---------------------------------------------------------------------------
# 3e2. online resize over 4 processes sharing the card
# ---------------------------------------------------------------------------

MESH_RESIZE_CHUNK = 16384          # migrate_chunk of phase 3e2
# per backend: slots a shard and keys prefilled into the first 2 shards
# (the probe backend's children rebuild their tables at each commit, 488
# ms per 4 -> 8 split at 2^18 a shard: it runs at 2^16); a rehearsal on
# the CPU passes smaller ones
MESH_RESIZE_GEOMETRY = {"bucket": dict(per=1 << 18, prefill=1 << 18),
                        "probe": dict(per=1 << 16, prefill=1 << 16)}


def row_digests(m) -> dict:
    """A digest of each storage row this process holds of every leaf of
    ``m``, by global row: ranks compare with one process without moving
    the rows."""
    out = {}
    for f in m.state._fields:
        leaf = TE._host(getattr(m.state, f))
        out[f] = {m.rows.start + i: (str(leaf.dtype),
                                     hashlib.sha1(leaf[i].tobytes())
                                     .hexdigest())
                  for i in range(leaf.shape[0])}
    return out


def elastic_counters(m) -> tuple:
    f = m.frontier
    return (m.n_shards, m.psyncs, m.ops, len(m), bool(m.overflowed),
            m.migration_psyncs, m.migrated_nodes, m.splits, m.merges,
            f.phase, f.committed, f.units)


def mesh_resize_run(backend, snap_dir, device="cuda", geo=None):
    """One run of phase 3e2 on an ``ElasticShardedMap(use_shard_map=True)``
    (on this rank's rows inside a process group, on every row in a process
    without one): 2 shards prefilled, split online to 4 and to 8 with one
    ``step()`` per mixed batch, merged back to 4 and 2 by steps without
    traffic, a crash mid-split 2 -> 4 and the split finished, and (bucket)
    ``load_resharded`` of a snapshot of the 4-shard map at 2 and 16 shards.
    Returns every result, the counters and each leaf row's digest at every
    checkpoint, the recovery histogram, the ms of each copy step and each
    commit step with the part in the collectives, and this process's
    launches of the path's kernels."""
    g = {**MESH_RESIZE_GEOMETRY[backend], "key_range": 1 << 20,
         "lanes": 1024, "prefill_batch": PREFILL_BATCH,
         "chunk": MESH_RESIZE_CHUNK, **(geo or {}).get(backend, {})}
    lookup, lname = lookup_kernel(backend)
    scan_cuda.launches = lookup.launches = 0
    rng = np.random.default_rng([SEED, g["per"], 9])
    m = ElasticShardedMap(SetSpec(capacity=2 * g["per"], mode="soft",
                                  backend=backend),
                          n_shards=2, migrate_chunk=g["chunk"],
                          device=device, use_shard_map=True)
    pre = rng.choice(g["key_range"], g["prefill"], replace=False).astype(
        np.int32).reshape(-1, g["prefill_batch"])
    res = [m.insert(k, k * 7 + 1) for k in pre]
    checks, steps = [], {"copy": [], "commit": []}

    def checkpoint(tag):
        maps = {"map": m.map}
        if m.target is not None:
            maps["target"] = m.target
        checks.append((tag, elastic_counters(m),
                       {k: row_digests(x) for k, x in maps.items()}))

    def step(coll):
        """One migration step, timed (device synced) with the part in the
        collectives; returns whether the migration finished."""
        f0, c0 = m.frontier.committed, coll["s"]
        sync(m.device)
        t0 = time.perf_counter()
        done = m.step()
        sync(m.device)
        dt = time.perf_counter() - t0
        kind = "commit" if (done or m.frontier.committed != f0) else "copy"
        steps[kind].append((1e3 * dt, 1e3 * (coll["s"] - c0)))
        return done

    def migrate(kind, coll, with_traffic):
        getattr(m, f"begin_{kind}")()
        while True:
            if with_traffic:
                ops, keys, vals = traffic(rng, 1, g["lanes"], g["key_range"])
                res.append(m.apply(ops[0], keys[0], vals[0]))
            if step(coll):
                break
        checkpoint(f"{kind} to {m.n_shards}")

    hist = None
    with timed_collectives() as coll:
        for _ in range(2):                    # 2 -> 4 -> 8 under traffic
            migrate("split", coll, True)
        for _ in range(2):                    # 8 -> 4 -> 2
            migrate("merge", coll, False)
        m.begin_split()                       # the crash drill, 2 -> 4
        for _ in range(3):
            step(coll)
        checkpoint("before the crash")
        m.crash_and_recover(seed=SEED + 5)
        hist = m.last_recovery_hist
        checkpoint("after the crash")
        while not step(coll):
            pass
        checkpoint("crash drill finished")
    loads = {}
    if backend == "bucket":
        inner = m.map
        sn = Snapshotter(inner, snap_dir)
        sn.snapshot()
        sn.wait()
        sn.close()
        for s in (2, 16):
            sync(m.device)
            t0 = time.perf_counter()
            lm = load_resharded(snap_dir, SetSpec(capacity=g["per"] * s,
                                                  mode="soft",
                                                  backend=backend), s,
                                device=device, use_shard_map=True)
            sync(m.device)
            loads[s] = {"ms": 1e3 * (time.perf_counter() - t0),
                        "counters": (len(lm), lm.psyncs, lm.n_shards),
                        "hist": lm.map.last_recovery_hist_shards,
                        "digests": row_digests(lm.map)}
            del lm
    return {"results": np.concatenate([np.asarray(r).reshape(-1)
                                       for r in res]),
            "checks": checks, "hist": hist, "steps": steps, "loads": loads,
            "device": str(m.device),
            "launches": {"recovery_scan": scan_cuda.launches,
                         lname: lookup.launches}}


def mesh_resize_rank(rank, snap_dir, device, geo):
    """A rank of phase 3e2: both backends on the mesh."""
    return {b: mesh_resize_run(b, os.path.join(snap_dir, f"{b}_mesh"),
                               device, geo)
            for b in ("bucket", "probe")}


def mesh_rows(s, rank):
    """The rows a rank of ``MESH_RANKS`` holds of an S-shard mesh map:
    all of them at S = 1, else its block of S / D, D = min(S, ranks)."""
    d = min(s, MESH_RANKS)
    if d == 1:
        return set(range(s))
    per = s // d
    return set(range(rank * per, (rank + 1) * per)) if rank < d else set()


def check_digests(label, want, got, n_shards, rank):
    for f, rows in got.items():
        expect(set(rows) == mesh_rows(n_shards, rank),
               f"{label}: rank {rank} holds rows {sorted(rows)} of {f}")
        for r, d in rows.items():
            expect(d == want[f][r], f"{label}: rank {rank} row {r} of leaf "
                   f"{f} differs from one process")


def check_mesh_resize(label, want, got):
    """Every rank against the one-process run: results, counters and every
    leaf row at every checkpoint, the histogram, each load; launches > 0
    on every rank (each holds rows at 4 and 8 shards)."""
    expect(len(got) == MESH_RANKS, f"{label}: {len(got)} ranks answered")
    for r, g in enumerate(got):
        expect(np.array_equal(g["results"], want["results"]),
               f"{label}: rank {r} results differ from one process")
        expect(np.array_equal(g["hist"], want["hist"]),
               f"{label}: rank {r} recovery histogram differs")
        expect([c[0] for c in g["checks"]] == [c[0] for c in want["checks"]],
               f"{label}: rank {r} checkpoints differ")
        for (tag, ctr, maps), (_, wctr, wmaps) in zip(g["checks"],
                                                      want["checks"]):
            expect(ctr == wctr, f"{label} {tag}: rank {r} counters {ctr} "
                   f"!= {wctr}")
            expect(set(maps) == set(wmaps), f"{label} {tag}: maps")
            for k in maps:
                s = ctr[0] if k == "map" else (
                    2 * ctr[0] if ctr[9] == "split" else ctr[0] // 2)
                check_digests(f"{label} {tag} {k}", wmaps[k], maps[k], s, r)
        for s, ld in g["loads"].items():
            w = want["loads"][s]
            expect(ld["counters"] == w["counters"] and
                   np.array_equal(ld["hist"], w["hist"]),
                   f"{label} load at {s}: rank {r} counters/histogram")
            check_digests(f"{label} load at {s}", w["digests"], ld["digests"],
                          s, r)
        expect(all(v > 0 for v in g["launches"].values()),
               f"{label}: rank {r} launched {g['launches']}")


def step_ms(steps, kind):
    """Median ms of a kind of step and of its part in the collectives."""
    xs = steps[kind]
    if not xs:
        return (0.0, 0.0, 0)
    return (float(np.median([a for a, _ in xs])),
            float(np.median([b for _, b in xs])), len(xs))


def run_mesh_resize_phase(dev, smi, geo=None):
    """Phase 3e2.  Returns each backend's per-rank launches."""
    t0 = time.perf_counter()
    print(f"phase 3e2: ElasticShardedMap(use_shard_map=True) over "
          f"{MESH_RANKS} gloo ranks sharing one card: 2 shards (bucket "
          f"{MESH_RESIZE_GEOMETRY['bucket']['per']} slots a shard, probe "
          f"{MESH_RESIZE_GEOMETRY['probe']['per']}), split online to 4 and "
          f"8 with one step() per 1024-lane 90/5/5 batch, migrate_chunk "
          f"{MESH_RESIZE_CHUNK}, merged to 4 and 2, a crash mid-split, "
          "load_resharded at 2 and 16 (bucket); against one process")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mresize_") as tmp:
        one = {}
        for b in ("bucket", "probe"):
            one[b] = mesh_resize_run(b, os.path.join(tmp, f"{b}_one"),
                                     str(dev), geo)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = mesh.spawn(mesh_resize_rank, MESH_RANKS, tmp, str(dev), geo)
        spawn_s = time.perf_counter() - t1
    out = {}
    for b in ("bucket", "probe"):
        got = [r[b] for r in ranks]
        check_mesh_resize(f"mesh resize {b}", one[b], got)
        out[b] = [g["launches"] for g in got]
        print(f"mesh resize {b}: {MESH_RANKS} ranks equal to one process "
              f"(results, counters and every leaf row at "
              f"{len(one[b]['checks'])} checkpoints: "
              f"{[c[0] for c in one[b]['checks']]}; the crash's histogram; "
              f"loads at {sorted(one[b]['loads'])}); launches by rank "
              f"{out[b]} ({smi})")
        for kind in ("copy", "commit"):
            per_rank = [step_ms(x["steps"], kind) for x in got]
            o = step_ms(one[b]["steps"], kind)
            print(f"mesh resize {b}: {kind} step, median ms by rank "
                  f"{[round(x[0], 4) for x in per_rank]}, of which in gloo "
                  f"collectives (their wait for the other ranks included) "
                  f"{[round(x[1], 4) for x in per_rank]}, over {o[2]} "
                  f"steps; one process {o[0]:.4f} ms ({smi})")
        for s, ld in one[b]["loads"].items():
            print(f"mesh resize {b}: load_resharded at {s} shards, ms by "
                  f"rank {[round(x['loads'][s]['ms'], 3) for x in got]}, "
                  f"one process {ld['ms']:.3f} ({smi})")
    print(f"phase 3e2: {time.perf_counter() - t0:.1f} s (the spawn and the "
          f"ranks' runs {spawn_s:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# 4. attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATOL = {  # the JAX tests' tolerances (test_kernels.py:53-54,
    #       test_seqmix_reference.py:78-79)
    "gqa_decode": {torch.float32: 2e-5, torch.bfloat16: 3e-2},
    "flash_prefill": {torch.float32: 3e-5, torch.bfloat16: 4e-2}}


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """The least time for the work: bytes at the memory rate or operations
    at the type's peak, whichever is larger, and which one it is."""
    t_bytes = bytes_ms(nbytes)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _decode_inputs(dev, b, h, kv, d, s, dtype, length, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(gen, (b, h, d), dtype, dev)
    k = _randn(gen, (b, s, kv, d), dtype, dev)
    v = _randn(gen, (b, s, kv, d), dtype, dev)
    if length is None:              # random lengths in [1, S]
        length = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
    return q, k, v, torch.as_tensor(length, dtype=torch.int32, device=dev)


def _decode_library(q, k, v, length):
    """scaled_dot_product_attention on pre-transposed inputs, masked to
    each row's length: the yardstick, never called by the port.  Returns
    the call and its output as [B, H, D]."""
    s = k.shape[1]
    qt, kt, vt = (t.contiguous() for t in (q[:, :, None], k.transpose(1, 2),
                                           v.transpose(1, 2)))
    mask = (torch.arange(s, device=q.device)[None, :] < length[:, None]
            )[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return call, call()[:, :, 0]


def check_decode(dev, b, h, kv, d, s, dtype, fill=None):
    """gqa_decode kernel vs plain at one shape and type, every row's length
    ``fill`` (random in [1, S] if None); returns the row's fields (time,
    plain time, library time, bound, error) and prints the wrapper's time
    per call back to back."""
    q, k, v, length = _decode_inputs(dev, b, h, kv, d, s, dtype,
                                     None if fill is None else [fill] * b,
                                     SEED + s)
    got = gqa_decode_cuda(q, k, v, length)
    want = gqa_decode_ref(q, k, v, length)
    sync(dev)
    err = float((got.float() - want.float()).abs().max())
    expect(bool(torch.isfinite(got).all()), "gqa_decode: non-finite output")
    atol = ATOL["gqa_decode"][dtype]
    tag = (f"gqa_decode B={b} H={h} KV={kv} D={d} S={s} {str(dtype)[6:]} "
           f"lengths {'random' if fill is None else fill}")
    expect(err <= atol, f"{tag}: max |kernel - plain| {err} > {atol}")
    lib_call, lib = _decode_library(q, k, v, length)
    lib_err = float((lib.float() - want.float()).abs().max())
    expect(lib_err <= atol,
           f"{tag}: scaled_dot_product_attention disagrees with plain")
    if dtype == torch.bfloat16:
        expect(err <= lib_err, f"{tag}: kernel error {err} above the "
               f"library's {lib_err}")
    ms = time_ms(lambda: gqa_decode_cuda(q, k, v, length), dev)
    plain = time_ms(lambda: gqa_decode_ref(q, k, v, length), dev)
    lib_ms = time_ms(lib_call, dev)
    wall = wall_ms(lambda: gqa_decode_cuda(q, k, v, length), dev, reps=200)
    # the kernel reads the K and V prefix of each row's length, q and the
    # lengths, and writes out; 4 flops per (head, slot, dim)
    live = int(torch.clamp(length, 1, s).sum())
    elt = q.element_size()
    nbytes = 2 * live * kv * d * elt + 2 * b * h * d * elt + 4 * b
    bound, by = bound_ms(nbytes, 4.0 * live * (h // kv) * kv * d, dtype)
    chunk_len, chunks = split_plan(
        b, kv, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"{tag}: max err {err:.3g}, library's {lib_err:.3g} (tolerance "
          f"{atol}); kernel {ms:.6f} ms, plain {plain:.6f} ms, library "
          f"{lib_ms:.6f} ms, bound {bound * 1e3:.3f} us ({by}); "
          f"{b * kv * -(-h // kv // 8)} clusters x {chunks} blocks of "
          f"{chunk_len} slots; wrapper {wall:.6f} ms per call back to back")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err)


def _live_pairs(s: int, window: int) -> int:
    """(query, key) pairs of a causal, optionally windowed, S x S mask."""
    i = np.arange(s)
    return int((np.minimum(i + 1, window) if window else i + 1).sum())


def check_prefill(dev, b, s, h, kv, d, window, dtype):
    """flash_prefill kernel vs plain at one shape and type; returns the
    row's fields."""
    gen = torch.Generator(device=dev).manual_seed(SEED + s + window)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    k = _randn(gen, (b, s, kv, d), dtype, dev)
    v = _randn(gen, (b, s, kv, d), dtype, dev)
    got = flash_prefill_cuda(q, k, v, window)
    want = flash_prefill_ref(q, k, v, window)
    sync(dev)
    err = float((got.float() - want.float()).abs().max())
    expect(bool(torch.isfinite(got).all()), "flash_prefill: non-finite "
           "output")
    atol = ATOL["flash_prefill"][dtype]
    tag = (f"flash_prefill B={b} S={s} H={h} KV={kv} D={d} window={window} "
           f"{str(dtype)[6:]}")
    expect(err <= atol, f"{tag}: max |kernel - plain| {err} > {atol}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def lib_call():
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        def lib_call():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((lib_call().transpose(1, 2).float()
                     - want.float()).abs().max())
    expect(lib_err <= atol, f"{tag}: scaled_dot_product_attention "
           f"disagrees with plain ({lib_err})")
    ms = time_ms(lambda: flash_prefill_cuda(q, k, v, window), dev, reps=20)
    plain = time_ms(lambda: flash_prefill_ref(q, k, v, window), dev,
                    reps=20)
    lib_ms = time_ms(lib_call, dev, reps=20)
    elt = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
    flops = 4.0 * b * h * d * _live_pairs(s, window)
    bound, by = bound_ms(nbytes, flops, dtype)
    print(f"{tag}: max err {err:.3g}, library's {lib_err:.3g} (tolerance "
          f"{atol}); kernel {ms:.6f} ms, plain {plain:.6f} ms, library "
          f"{lib_ms:.6f} ms, bound {bound * 1e3:.3f} us ({by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    if dtype == torch.bfloat16:
        expect(err <= lib_err, f"{tag}: kernel error {err} above the "
               f"library's {lib_err}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err)


# flash_prefill's CUDA-core design (f32 products from shared memory for
# both types) at the serving shape in bf16, on an H100 80GB HBM3 at 700 W
# (PERF.md): printed beside the tensor-core kernel's time
CUDA_CORE_PREFILL_MS = 2.258016
# gqa_decode's one-block-per-(batch row, KV head) design at the serving
# shape in bf16, random and full lengths, on an H100 80GB HBM3 at 700 W
# (PERF.md): printed beside the split design's times
ONE_BLOCK_PER_HEAD_DECODE_MS = {"random": 0.158736, "full": 0.202272}


# the head shapes the model families give the kernels (phase 8): G 6 and 7
# (mixtral-8x22b, arctic-480b), 10 with one KV head (recurrentgemma-2b's
# MQA), at D 128 and 256; D 96 at G 1 (minicpm3-4b's MLA prefill, V padded)
FAMILY_DECODE_EDGES = ([(2 * g, 2, d, s) for g in (6, 7) for d in (128, 256)
                        for s in (63, 300, 544)]
                       + [(10, 1, d, s) for d in (128, 256)
                          for s in (63, 300, 528)]
                       + [(2, 2, 96, s) for s in (7, 300, 544)])
FAMILY_PREFILL_EDGES = ([(2, s, 2 * g, 2, d, w) for g in (6, 7)
                         for d in (128, 256) for s in (63, 300)
                         for w in (0, 100)]
                        + [(2, s, 10, 1, d, w) for d in (128, 256)
                           for s in (63, 300) for w in (0, 100)]
                        + [(2, s, 4, 4, 96, w) for s in (1, 63, 300)
                           for w in (0, 100)]
                        + [(1, 2304, 10, 1, 256, 2048)])


def check_decode_edges(dev):
    """gqa_decode against its plain version at lengths 0, 1, S - 1, S and
    S + 5 (one batch row each) and at random lengths in [1, S], over S
    below, at and above one chunk, G 1, 8 and 16, head dims 8 to 256, in
    both types, and at h2o-danube-3-4b's shape.  In bf16 a batch whose rows
    are all live is also held to the library's own error (the library
    returns NaN for a row with no live slot)."""
    shapes = [(2 * g, 2, d, s) for g in (1, 8, 16)
              for d in (8, 16, 64, 120, 128, 256)
              for s in (1, 7, 63, 64, 65, 300, 1000, 4096)
              if g < 16 or d in (8, 120, 256)]
    shapes.append((32, 8, 120, 4096))           # h2o-danube-3-4b
    shapes += FAMILY_DECODE_EDGES
    count, worst, worst_lib = 0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        atol = ATOL["gqa_decode"][dtype]
        for h, kv, d, s in shapes:
            for edge in (True, False):
                ln = [0, 1, s - 1, s, s + 5] if edge else None
                q, k, v, length = _decode_inputs(dev, 5, h, kv, d, s, dtype,
                                                 ln, SEED + h + d + s)
                got = gqa_decode_cuda(q, k, v, length)
                want = gqa_decode_ref(q, k, v, length).float()
                err = float((got.float() - want).abs().max())
                tag = (f"gqa_decode H={h} KV={kv} D={d} S={s} "
                       f"{str(dtype)[6:]} lengths {length.tolist()}")
                expect(bool(torch.isfinite(got).all()),
                       f"{tag}: non-finite output")
                expect(err <= atol, f"{tag}: max |kernel - plain| {err} > "
                       f"{atol}")
                if dtype == torch.bfloat16 and bool((length > 0).all()):
                    lib_err = float((_decode_library(q, k, v, length)[1]
                                     .float() - want).abs().max())
                    expect(err <= lib_err, f"{tag}: kernel error {err} "
                           f"above the library's {lib_err}")
                    worst_lib = max(worst_lib, lib_err)
                worst = max(worst, err)
                count += 1
    print(f"gqa_decode edge shapes: {count} held against plain (f32 and "
          f"bf16; lengths 0, 1, S-1, S, S+5 and random; S 1-4096; G 1, 8, "
          f"16; D 8-256; h2o-danube-3-4b's H 32, KV 8, D 120, S 4096; the "
          f"model families' G 6, 7 and 10 (KV 1) at D 128 and 256 and D 96 "
          f"at G 1), max err {worst:.3g}; bf16 with every row live no "
          f"worse than the library (worst library error {worst_lib:.3g})")


def check_prefill_edges(dev):
    """flash_prefill in bf16 against its plain version over ragged S, head
    dims that are not multiples of 16 or 64, windows shorter and longer
    than a tile, G = 1 and 8, and h2o-danube-3-4b's own shape; then the
    model families' head shapes in f32 and bf16."""
    shapes = [(2, s, h, 2, d, w) for d in (8, 16, 64, 120, 128, 256)
              for s in (1, 63, 65, 129, 300) for w in (0, 5, 16, 100)
              for h in (2, 16)]
    shapes.append((1, 512, 32, 8, 120, 4096))
    worst = {}
    for dtype, grid in ((torch.bfloat16, shapes),
                        (torch.float32, FAMILY_PREFILL_EDGES),
                        (torch.bfloat16, FAMILY_PREFILL_EDGES)):
        atol = ATOL["flash_prefill"][dtype]
        for b, s, h, kv, d, w in grid:
            gen = torch.Generator(device=dev).manual_seed(SEED + s + d + w
                                                          + h)
            q = _randn(gen, (b, s, h, d), dtype, dev)
            k = _randn(gen, (b, s, kv, d), dtype, dev)
            v = _randn(gen, (b, s, kv, d), dtype, dev)
            got = flash_prefill_cuda(q, k, v, w)
            err = float((got.float() - flash_prefill_ref(q, k, v, w).float()
                         ).abs().max())
            expect(err <= atol, f"flash_prefill B={b} S={s} H={h} KV={kv} "
                   f"D={d} window={w} {str(dtype)[6:]}: max |kernel - "
                   f"plain| {err} > {atol}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"flash_prefill edge shapes: {len(shapes)} in bf16 (the last "
          f"h2o-danube-3-4b's: S 512, H 32, KV 8, D 120, window 4096), and "
          f"the model families' {len(FAMILY_PREFILL_EDGES)} (G 6, 7 and 10 "
          f"with KV 1 at D 128 and 256, D 96 at G 1, recurrentgemma's "
          f"window 2048 over S 2304) in f32 and bf16, held against plain; "
          f"max err bf16 {worst[torch.bfloat16]:.3g} (tolerance "
          f"{ATOL['flash_prefill'][torch.bfloat16]}), "
          f"f32 {worst[torch.float32]:.3g} (tolerance "
          f"{ATOL['flash_prefill'][torch.float32]})")


def check_attention_kernels(dev):
    """Both attention kernels at every stated shape, f32 and bf16.
    Returns each kernel's row at the serving shape in bf16."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = check_decode(dev, 8, 64, 8, 128, 544, dtype)
        if dtype == torch.bfloat16:
            rows["gqa_decode"] = r
        check_decode(dev, 2, 32, 8, 120, 300, dtype)
        r = check_prefill(dev, 8, 512, 64, 8, 128, 0, dtype)
        if dtype == torch.bfloat16:
            rows["flash_prefill"] = r
        check_prefill(dev, 2, 300, 32, 8, 120, 128, dtype)
    # the serving path's decode reads nearly the whole cache; one live slot
    # a row shows the kernel's fixed cost
    full = check_decode(dev, 8, 64, 8, 128, 544, torch.bfloat16, fill=544)
    check_decode(dev, 8, 64, 8, 128, 544, torch.bfloat16, fill=1)
    check_decode_edges(dev)
    check_prefill_edges(dev)
    for label, r in (("random", rows["gqa_decode"]), ("full", full)):
        old = ONE_BLOCK_PER_HEAD_DECODE_MS[label]
        print(f"gqa_decode bf16 at the serving shape, {label} lengths: "
              f"{r['ms']:.6f} ms, {r['ms'] / r['library_ms']:.3f}x the "
              f"library's {r['library_ms']:.6f} ms, "
              f"{r['ms'] / r['bound_ms']:.3f}x the bound "
              f"{r['bound_ms']:.6f} ms; the one-block-per-head design took "
              f"{old:.6f} ms ({old / r['ms']:.2f}x this)")
    r = rows["flash_prefill"]
    print(f"flash_prefill bf16 at the serving shape: {r['ms']:.6f} ms, "
          f"{r['ms'] / r['library_ms']:.3f}x the library's "
          f"{r['library_ms']:.6f} ms, {r['ms'] / r['bound_ms']:.3f}x the "
          f"bound {r['bound_ms']:.6f} ms; the CUDA-core design took "
          f"{CUDA_CORE_PREFILL_MS:.6f} ms "
          f"({CUDA_CORE_PREFILL_MS / r['ms']:.2f}x this)")
    return rows


# ---------------------------------------------------------------------------
# 5. decode agrees with prefill at full width
# ---------------------------------------------------------------------------

# f32 throughout, but the two sides sum in other orders: cuBLAS picks other
# kernels for 1-row and 512-row products, and the attention runs through
# gqa_decode on one side and flash_prefill on the other.  Set from the
# reading: max |diff| 1.69e-5 over logits up to 4.8 on an H100 80GB HBM3 at
# 700 W; the limit leaves about 12x of that for other cuBLAS kernel choices.
DECODE_PREFILL_ATOL = 2e-4


def check_decode_matches_prefill(dev, arch="qwen3-32b", s=511, b=2,
                                 layers=2):
    """One decode step at position S against the last-position logits of
    a prefill over S + 1 tokens, f32, within DECODE_PREFILL_ATOL.

    MoE: decode routes the batch's b tokens as one group, whose capacity
    (8) drops nothing, and prefill routes each row's S + 1 tokens, whose
    capacity at the published factor does drop assignments when the
    routing is skewed; a dropped expert output is a different function,
    not rounding.  So the decode is held against a prefill at capacity
    factor E / k (capacity S + 1 or more: nothing dropped)."""
    cfg = get_config(arch).with_layers(layers).replace(
        param_dtype="float32", compute_dtype="float32")
    note = ""
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        note = f" (capacity factor {cfg.capacity_factor:g}, nothing dropped)"
        expect(moe_capacity(s + 1, cfg) >= s + 1,
               f"{arch}: the no-drop capacity is below S + 1")
    params = M.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (b, s + 1), device=dev, generator=gen,
                        dtype=torch.int32)
    frames = {}
    if cfg.family == "audio":       # the encoder's frames, both prefills
        frames["embeds"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                       generator=gen, device=dev)
    cache = M.init_cache(cfg, b, s + 1, device=dev)
    cache, _ = M.prefill(params, {"tokens": tok[:, :s], **frames}, cache,
                         cfg)
    _, lg_dec = M.decode_step(params, cache, tok[:, s:], cfg)
    del cache
    c2 = M.init_cache(cfg, b, s + 1, device=dev)
    _, lg_ref = M.prefill(params, {"tokens": tok, **frames}, c2, cfg)
    sync(dev)
    expect(tuple(lg_dec.shape) == (b, cfg.vocab)
           and bool(torch.isfinite(lg_dec).all()),
           "decode logits: wrong shape or non-finite")
    err = float((lg_dec - lg_ref).abs().max())
    scale = float(lg_ref.abs().max())
    del c2
    print(f"decode vs prefill, {arch} width, {layers} layers, f32, S={s}: "
          f"max |diff| {err:.3g} over logits up to {scale:.3g} (tolerance "
          f"{DECODE_PREFILL_ATOL}); argmax equal "
          f"{bool((lg_dec.argmax(-1) == lg_ref.argmax(-1)).all())}{note}")
    del params
    expect(err <= DECODE_PREFILL_ATOL,
           f"{arch}: decode logits differ from prefill's")


# ---------------------------------------------------------------------------
# 5b. decode over a sequence-sharded cache on 4 ranks sharing the card
# ---------------------------------------------------------------------------

MESH_DECODE_RANKS = 4
# (arch, layers, prompt, decode steps): qwen3-32b's prompt ends 12 slots
# before slot 8192, the first rank boundary on (1, 4); h2o-danube-3-4b's
# 4090 tokens and 16 steps wrap its 4096-slot window ring;
# recurrentgemma-2b's one period (rglru, rglru, attn) at published width,
# its RG-LRU state split over its 2560 channels and its local attention's
# 2048-slot window on the sequence split, wrapped by 2090 tokens;
# xlstm-350m's (mlstm, slstm), its sLSTM h split over its 1024 units, a
# 1024-token prompt (mLSTM's chunks of 256)
MESH_DECODE = dict(grids=((1, 4), (2, 2)), batch=4, seq=32768,
                   runs=(("qwen3-32b", 2, 8180, 16),
                         ("h2o-danube-3-4b", 2, 4090, 16),
                         ("recurrentgemma-2b", 3, 2090, 16),
                         ("xlstm-350m", 2, 1024, 16)))
# logits: max |diff| over the reference's largest |logit| (gqa_decode's
# bf16 tolerance, 3e-2, taken relative to the logits' scale).  The
# logits are bf16 values (an ulp of 1/32 between 4 and 8), and one
# process's greedy stream holds exact ties (a top-2 margin of 0): a
# combine over 4 ranks, or over one rank in f32 where the kernel rounds
# its probabilities to bf16, moves a logit by that ulp and may take the
# other token of a tie.  So the ranks decode the reference's tokens, and
# a rank's greedy token must be the reference's wherever the reference's
# margin exceeds twice the step's largest difference (a token within
# that of the reference's best elsewhere; the phase prints the
# reference's margin where a token differs)
MESH_DECODE_REL = 3e-2


def mesh_decode_tokens(cfg, plan, prompt):
    gen = torch.Generator().manual_seed(SEED + 5)
    return torch.randint(0, cfg.vocab, (plan["batch"], prompt),
                         generator=gen, dtype=torch.int32)


def kv_bytes(cache) -> int:
    return sum(a.numel() * a.element_size() for k, a in tree_leaves(cache)
               if k.endswith(("/k", "/v")))


def recurrent_states(tree) -> dict:
    """The recurrent state leaves of a cache (or of its spec tree), by
    path: every leaf but the KV caches and ``pos``."""
    return {k: a for k, a in tree_leaves(tree)
            if not k.endswith(("/k", "/v")) and k != "pos"}


def mesh_decode_run(cfg, params, plan, prompt, steps, dev, ctx=None,
                    feed=None):
    """A prefill and ``steps`` decode steps at ``plan``'s batch and cache
    length (this rank's rows and cache block with an enabled ``ctx``,
    under the current mesh), each step fed its greedy token, or the rows
    of ``feed`` ((steps + 1, B, 1) tokens) where given: logits and greedy
    tokens of each step on the host, the KV leaves' bytes, the cache (on
    the device) after the last step, ms per decode step (each
    synchronized), the ms and calls in ``gloo`` collectives over the
    steps, and the attention kernels' launches in prefill and decode."""
    from repro_torch.launch.specs import local_rows
    rows = local_rows(ctx, plan["batch"])
    pre, dec = TS.make_serve_steps(cfg, ctx)
    cache = M.init_cache(cfg, plan["batch"], plan["seq"], device=dev,
                         ctx=ctx)
    toks = mesh_decode_tokens(cfg, plan, prompt)[rows].to(dev)
    flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
    cache, logits = pre(params, {"tokens": toks}, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    launches = {"prefill": (flash_prefill_cuda.launches,
                            gqa_decode_cuda.launches)}
    flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
    out, ms = [(logits.float().cpu(), nxt.cpu())], []
    with timed_calls(mesh.ModelMesh, ("all_reduce", "all_gather",
                                      "reduce_scatter")) as coll:
        for i in range(steps):
            if feed is not None:
                nxt = feed[i][rows].to(dev)
            sync(dev)
            t = time.perf_counter()
            cache, nxt, logits = dec(params, cache, nxt)
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
            out.append((logits.float().cpu(), nxt.cpu()))
    launches["decode"] = (flash_prefill_cuda.launches,
                          gqa_decode_cuda.launches)
    return dict(logits=torch.stack([o[0] for o in out]),
                tokens=torch.stack([o[1] for o in out]),
                kv_bytes=kv_bytes(cache), cache=cache, rows=rows,
                ms=float(np.median(ms)), coll_ms=1e3 * coll["s"] / steps,
                coll_calls=coll["n"] / steps, launches=launches)


def mesh_decode_compress(rank, dev, steps=8):
    """``compressed_psum`` over the group on the card's tensors and on the
    CPU's, 8 steps of error feedback each: True where the means and the
    residuals agree bit for bit at every step."""
    from repro_torch.optim.compress import compressed_psum
    gen = torch.Generator().manual_seed(SEED + 50 + rank)
    grads = [{"w": torch.randn((1024, 64), generator=gen),
              "b": torch.randn((4096,), generator=gen).to(torch.bfloat16)}
             for _ in range(steps)]
    outs = []
    for where in (dev, torch.device("cpu")):
        res = {k: torch.zeros(a.shape, device=where)
               for k, a in grads[0].items()}
        got = []
        for g in grads:
            mean, res = compressed_psum(
                {k: a.to(where) for k, a in g.items()}, res)
            got.append({k: (mean[k].cpu(), res[k].cpu()) for k in mean})
        outs.append(got)
    return all(torch.equal(a[k][i], b[k][i]) for a, b in zip(*outs)
               for k in a for i in (0, 1))


def collective_floor_ms(dev, shapes, reps=20) -> list:
    """Median ms of one ``gloo`` all-reduce of a card tensor of each
    shape over the whole group, every rank entering it together (a
    synchronize and a barrier before each): the transport alone, without
    the wait for the other ranks' device work."""
    out = []
    for shp in shapes:
        t = torch.zeros(shp, device=dev)
        ms = []
        for _ in range(reps):
            sync(dev)
            mesh.dist.barrier()
            t0 = time.perf_counter()
            mesh.dist.all_reduce(t)
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        out.append(float(np.median(ms)))
    return out


def mesh_decode_rank(rank, ref_dir, device, plan):
    """A rank of phase 5b: each run on each grid, held to the one-process
    run saved in ``ref_dir`` (its logits, and the recurrent states after
    the last step, the ranks' blocks gathered), then ``compressed_psum``
    on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.meshctx import mesh_context
    from repro_torch.launch.specs import cache_specs, gather, make_shard_ctx
    dev = mesh.rank_device(rank, device)
    out = {}
    for arch, layers, prompt, steps in plan["runs"]:
        cfg = get_config(arch).with_layers(layers)
        params = M.init_params(cfg, seed=SEED, device=dev)
        ref = torch.load(os.path.join(ref_dir, f"{arch}.pt"))
        for grid in plan["grids"]:
            mm = mesh.make_model_mesh(grid)
            shape = ShapeConfig("decode_32k", plan["seq"], plan["batch"],
                                "decode")
            ctx = make_shard_ctx(cfg, shape, mm)
            with mesh_context(mm):
                r = mesh_decode_run(cfg, params, plan, prompt, steps, dev,
                                    ctx, feed=ref["tokens"])
                specs = recurrent_states(cache_specs(cfg, shape, ctx, mm))
                whole = gather(recurrent_states(r.pop("cache")), specs, mm)
            # each state leaf's largest |diff| over its largest magnitude;
            # the leaves the ranks split
            r["state_err"] = max([float((a.cpu() - ref["states"][k]).abs()
                                        .max() / ref["states"][k].abs().max()
                                        .clamp(min=1e-30))
                                  for k, a in whole.items()], default=0.0)
            r["state_split"] = sorted(k.rsplit("/", 2)[-2] + "/" +
                                      k.rsplit("/", 1)[-1]
                                      for k, spec in specs.items()
                                      if "model" in spec)
            del whole
            want = ref["logits"][:, r["rows"]]
            diff = (r.pop("logits") - want).abs().amax(-1)    # (step, row)
            r["err"], r["scale"] = float(diff.max()), float(want.abs().max())
            tok = r.pop("tokens")[..., 0].long()
            best = want.amax(-1)
            r["tokens_equal"] = int((tok == ref["tokens"][:, r["rows"], 0]
                                     ).sum())
            r["tokens"] = tok.numel()
            # a greedy token of the reference's logits within twice the
            # step's largest difference: the reference's own where its
            # margin is wider
            at = want.gather(-1, tok[..., None])[..., 0]
            r["tokens_ok"] = bool((at >= best - 2 * diff).all())
            r["margins"] = [round(float(x), 5) for x in (best - at)[
                tok != ref["tokens"][:, r["rows"], 0]]]
            r["ctx"] = (ctx.seq_shard_cache, ctx.batch_shardable)
            out[(arch, grid)] = r
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["compress"] = mesh_decode_compress(rank, dev)
    # the decode's two reductions at the first run's shapes on (1, 4): the
    # row max (B, KV, G, 1) and the denominators with the weighted values
    cfg = get_config(plan["runs"][0][0])
    g = cfg.n_heads // cfg.n_kv_heads
    out["floor_ms"] = collective_floor_ms(dev, [
        (plan["batch"], cfg.n_kv_heads, g, 1),
        (plan["batch"], cfg.n_kv_heads, g, cfg.head_dim + 1)])
    return out


def run_mesh_decode_phase(dev, smi, plan=None):
    """Phase 5b.  Returns the per-rank launches of each run and grid."""
    plan = plan or MESH_DECODE
    t0 = time.perf_counter()
    print(f"phase 5b: decode over a sequence-sharded KV cache on "
          f"{MESH_DECODE_RANKS} gloo ranks sharing one card, grids "
          f"{list(plan['grids'])} (data, model), B {plan['batch']}, "
          f"{plan['seq']} cache slots")
    one = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
        for arch, layers, prompt, steps in plan["runs"]:
            cfg = get_config(arch).with_layers(layers)
            params = M.init_params(cfg, seed=SEED, device=dev)
            r = mesh_decode_run(cfg, params, plan, prompt, steps, dev)
            torch.save({"logits": r.pop("logits"),
                        "tokens": r.pop("tokens"),
                        "states": {k: a.cpu() for k, a in recurrent_states(
                            r.pop("cache")).items()}},
                       os.path.join(tmp, f"{arch}.pt"))
            one[arch] = r
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = mesh.spawn(mesh_decode_rank, MESH_DECODE_RANKS, tmp,
                           str(dev), plan)
        spawn_s = time.perf_counter() - t1
    launches = {}
    for arch, layers, prompt, steps in plan["runs"]:
        ref = one[arch]
        cfg = get_config(arch).with_layers(layers)
        n_pre = attention_layers(cfg)
        expect(ref["launches"] == {
            "prefill": (n_pre, 0),
            "decode": (0, decode_attention_layers(cfg) * steps)},
               f"one process {arch}: launches {ref['launches']}")
        print(f"mesh decode {arch} ({layers} layers, {prompt}-token prompt, "
              f"{steps} steps): one process {ref['ms']:.3f} ms a step "
              f"(gqa_decode), KV cache {ref['kv_bytes'] / 2**20:.3f} MiB, "
              f"launches {ref['launches']} ({smi})")
        for grid in plan["grids"]:
            got = [r[(arch, grid)] for r in ranks]
            seq_split, batch_split = got[0]["ctx"]
            split = (grid[1] if seq_split else 1) * \
                (grid[0] if batch_split else 1)
            for rank, g in enumerate(got):
                what = f"mesh decode {arch} {grid} rank {rank}"
                expect(g["tokens_ok"], f"{what}: a greedy token is not "
                       "one process's where its margin is wider than the "
                       "logits' difference")
                expect(g["err"] <= MESH_DECODE_REL * max(g["scale"], 1.0),
                       f"{what}: logits off by {g['err']} (largest "
                       f"{g['scale']})")
                expect(g["kv_bytes"] * split == ref["kv_bytes"],
                       f"{what}: {g['kv_bytes']} KV bytes, one process "
                       f"{ref['kv_bytes']} over {split}")
                expect(g["launches"]["prefill"] == (n_pre, 0)
                       and g["launches"]["decode"] == (0, 0),
                       f"{what}: launches {g['launches']}; expected "
                       f"flash_prefill {n_pre} in prefill, nothing else")
                expect(g["state_err"] <= MESH_DECODE_REL,
                       f"{what}: recurrent state off by {g['state_err']} of"
                       " its largest magnitude")
            launches[(arch, grid)] = [g["launches"] for g in got]
            print(f"mesh decode {arch} {grid}: sequence split {seq_split}, "
                  f"rows split {batch_split}; greedy tokens equal to one "
                  f"process's by rank {[g['tokens_equal'] for g in got]} of "
                  f"{got[0]['tokens']}, the reference's margin where they "
                  f"differ {[g['margins'] for g in got]}; max |logit diff| "
                  f"by rank "
                  f"{[round(g['err'], 5) for g in got]} (largest |logit| "
                  f"{got[0]['scale']:.3f}, tolerance {MESH_DECODE_REL} of "
                  f"it); ms a decode step by rank "
                  f"{[round(g['ms'], 3) for g in got]}, of which in gloo "
                  f"collectives {[round(g['coll_ms'], 3) for g in got]} in "
                  f"{got[0]['coll_calls']:.1f} calls; KV cache MiB by rank "
                  f"{[round(g['kv_bytes'] / 2**20, 3) for g in got]} "
                  f"(1/{split} of one process's); recurrent states split "
                  f"over model {got[0]['state_split']}, gathered, against "
                  f"one process's: largest |diff| over the leaf's largest "
                  f"by rank {[round(g['state_err'], 6) for g in got]}; "
                  f"launches by rank {[g['launches'] for g in got]} "
                  f"({smi})")
    print(f"gloo all-reduce of card tensors over the {MESH_DECODE_RANKS} "
          f"ranks entering together, the row max and the sums at "
          f"{plan['runs'][0][0]}'s (1, 4) shapes: ms by rank "
          f"{[[round(x, 3) for x in r['floor_ms']] for r in ranks]} ({smi})")
    expect(all(r["compress"] for r in ranks),
           "compressed_psum on the card differs from the CPU's")
    print(f"compressed_psum: {MESH_DECODE_RANKS} ranks, 8 steps of error "
          f"feedback, card tensors bit for bit equal to CPU tensors")
    print(f"phase 5b: {time.perf_counter() - t0:.1f} s (the spawn and the "
          f"ranks' runs {spawn_s:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# 6. the serving path
# ---------------------------------------------------------------------------

def profile_decode(dev, cfg, params, b, prompt_len, steps):
    """A few decode steps of the serving path under torch.profiler: the
    device's busy share of the window and the kernels that take its
    time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    _, decode_step = TS.make_serve_steps(cfg)
    caches = M.init_cache(cfg, b, prompt_len + steps + 1, device=dev)
    caches["pos"].fill_(prompt_len)
    nxt = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    caches, nxt, _ = decode_step(params, caches, nxt)       # warm
    sync(dev)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            caches, nxt, _ = decode_step(params, caches, nxt)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy = device_rows(prof)
    dec = sum(r[0] for r in rows if "gqa_decode" in r[2])
    dec_n = sum(r[1] for r in rows if "gqa_decode" in r[2])
    ops = sum(r[1] for r in rows) / steps
    print(f"decode profile: {steps} steps, wall {wall_us:.1f} us, device "
          f"busy {busy:.1f} us ({100 * busy / wall_us:.2f}%), "
          f"{ops:.1f} device ops per step; "
          f"gqa_decode {dec / steps:.1f} us per step in "
          f"{dec_n / steps:.1f} launches ({100 * dec / max(busy, 1e-9):.2f}% "
          "of busy)")
    for us, n, key in rows[:10]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    return dict(busy_share=100 * busy / wall_us, ops_per_step=ops,
                wall_ms_per_step=wall_us / steps / 1e3)


def profile_prefill(dev, cfg, params, b, prompt_len, batch=None):
    """One warm prefill of the serving path under torch.profiler: the
    device's busy share and flash_prefill's share of the busy time.  The
    batch is ``prompt_len`` zero tokens unless ``batch`` is given."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    prefill_step, _ = TS.make_serve_steps(cfg)
    if batch is None:
        batch = {"tokens": torch.zeros((b, prompt_len), dtype=torch.int32,
                                       device=dev)}
    caches = M.init_cache(cfg, b, prompt_len + 1, device=dev)
    prefill_step(params, batch, caches)                          # warm
    sync(dev)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_step(params, batch, caches)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy = device_rows(prof)
    fp = sum(r[0] for r in rows if "flash_prefill" in r[2])
    fp_n = sum(r[1] for r in rows if "flash_prefill" in r[2])
    print(f"prefill profile (warm, profiler on): wall {wall_us:.1f} us, "
          f"device busy {busy:.1f} us ({100 * busy / wall_us:.2f}%), "
          f"flash_prefill {fp:.1f} us in {fp_n} launches "
          f"({100 * fp / max(busy, 1e-9):.2f}% of busy)")
    for us, n, key in rows[:8]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    return dict(busy_share=100 * busy / wall_us, wall_ms=wall_us / 1e3)


def run_serving(dev, arch="qwen3-32b", requests=8, prompt_len=512, gen=32):
    """The serving path at qwen3-32b's full width and depth; returns its
    launch counts."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in (scan_cuda, table_probe_cuda, gqa_decode_cuda,
               flash_prefill_cuda):
        fn.launches = 0
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device=dev)
    launches = {"recovery_scan": scan_cuda.launches,
                "table_probe": table_probe_cuda.launches,
                "gqa_decode": gqa_decode_cuda.launches,
                "flash_prefill": flash_prefill_cuda.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"serving-path launches: {launches}")
    tokens = res["tokens"]
    expect(tuple(tokens.shape) == (requests, gen)
           and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
           and bool(torch.isfinite(res["logits"]).all()),
           "serve: generated tokens or logits out of range")
    expect(res["registered"] == requests and res["psyncs"] == requests,
           f"serve: {res['registered']} registered at {res['psyncs']} "
           f"psyncs, expected {requests} and {requests}")
    expect(res["registered_after_recovery"] == requests
           and res["recovery_psyncs"] == 0
           and res["psyncs_after_recovery"] == 0,
           "serve: the registry lost completions or paid psyncs in recovery")
    layers = cfg.n_layers
    expect(launches["flash_prefill"] == layers,
           f"flash_prefill launched {launches['flash_prefill']} times, "
           f"expected {layers}")
    expect(launches["gqa_decode"] == layers * (gen - 1),
           f"gqa_decode launched {launches['gqa_decode']} times, expected "
           f"{layers * (gen - 1)}")
    expect(launches["table_probe"] > 0 and launches["recovery_scan"] > 0,
           "the registry's kernels were not launched")
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(res["params"]))
    print(f"serve qwen3-32b ({layers} layers, bf16, {wbytes / 2**30:.2f} "
          f"GiB of weights): {requests} requests x {prompt_len} + {gen} "
          f"tokens; prefill {res['prefill_ms']:.3f} ms; decode "
          f"{res['decode_ms_per_step']:.3f} ms per step (weight-stream "
          f"bound {bytes_ms(wbytes):.3f} ms); {res['tok_per_s']:.1f} tok/s "
          f"over {res['seconds']:.3f} s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    params = res["params"]
    del res, tokens
    torch.cuda.empty_cache()
    profile_prefill(dev, cfg, params, requests, prompt_len)
    torch.cuda.empty_cache()
    profile_decode(dev, cfg, params, requests, prompt_len, steps=4)
    return launches, params


def run_serving_spine(dev, params, arch="qwen3-32b", requests=8,
                      prompt_len=512, gen=32, **kw):
    """The serving path with the durable request/completion spine
    (``queue=True``) at full width, on the first run's weights, with a
    crash: 4 psyncs per completion, the late acks redelivered and
    committed, zero recovery psyncs in all three structures,
    recovery_scan once per recovered structure (the registry once per
    shard).  Returns the launches and the result."""
    cfg = get_config(arch)
    fns = {"recovery_scan": scan_cuda, "table_probe": table_probe_cuda,
           "gqa_decode": gqa_decode_cuda, "flash_prefill": flash_prefill_cuda}
    for fn in fns.values():
        fn.launches = 0
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device=dev, params=params, queue=True, **kw)
    launches = {k: fn.launches for k, fn in fns.items()}
    shards = kw.get("shards", 1)
    label = f"serve spine{' ' + str(kw) if kw else ''}"
    print(f"{label} launches: {launches}")
    expect(tuple(res["tokens"].shape) == (requests, gen)
           and bool(torch.isfinite(res["logits"]).all()),
           f"{label}: tokens or logits out of range")
    expect(res["spine_psyncs"] == 3 * requests
           and res["psyncs"] == requests
           and res["phase_psyncs"] == {
               "ack": requests,
               **({"generate": 0} if kw.get("pipeline", 1) == 1 else {}),
               "record": requests, "commit": requests},
           f"{label}: spine psyncs {res['spine_psyncs']} by phase "
           f"{res['phase_psyncs']} and registry psyncs {res['psyncs']}, "
           f"expected 3 and 1 per request")
    expect(res["redelivered"] == requests and res["req_queue_len"] == 0
           and res["completions_after_recovery"] == 2 * requests,
           f"{label}: the late acks were not redelivered and committed")
    expect(res["recovery_psyncs"] == 0
           and res["queue_recovery_psyncs"] == {"req_queue": 0,
                                                "resp_queue": 0},
           f"{label}: recovery paid psyncs")
    expect(launches["recovery_scan"] == shards + 2,
           f"{label}: recovery_scan launched {launches['recovery_scan']} "
           f"times, expected {shards + 2} (once per recovered structure)")
    layers = cfg.n_layers
    depth = kw.get("pipeline", 1)
    waves = 1 if depth == 1 else min(requests, 2 * depth)
    expect(launches["flash_prefill"] == layers * waves
           and launches["gqa_decode"] == layers * waves * (gen - 1)
           and launches["table_probe"] > 0,
           f"{label}: the attention or lookup kernels' launches")
    ms = res["phase_ms"]
    gen_ms = ms.get("generate")
    print(f"{label}: {arch} {layers} layers, {requests} requests x "
          f"{prompt_len} + {gen} tokens; spine psyncs {res['spine_psyncs']} "
          f"+ registry {res['psyncs']} = "
          f"{(res['spine_psyncs'] + res['psyncs']) / requests:.3f} per "
          f"request; host ms by phase: ack {ms['ack']:.3f}, record "
          f"{ms['record']:.3f}, commit {ms['commit']:.3f}"
          + (f", generate {gen_ms:.3f}" if gen_ms is not None else "")
          + f"; {res['tok_per_s']:.1f} tok/s over {res['seconds']:.3f} s"
          + (f"; wave k+1's ack finished while wave k still generated: "
             f"{res['ack_overlapped']}" if res["ack_overlapped"] else ""))
    return launches, res


# ---------------------------------------------------------------------------
# 7. the open-loop serving harness (bench_serve)
# ---------------------------------------------------------------------------

OPEN_LOOP_SECONDS = 30.0           # bench_serve's default 60 s, cut to 30
DRILL_ROUNDS = 20                  # checked rounds before the crash
DRILL_EXTRA = 4                    # then as many counting syncs, profiled
OPEN_LOOP_KERNELS = {"recovery_scan": scan_cuda, "hash_probe": probe_cuda,
                     "table_probe": table_probe_cuda}


def open_loop_launches() -> dict:
    return {k: fn.launches for k, fn in OPEN_LOOP_KERNELS.items()}


def run_bench_serve(dev, argv, label):
    """``bench_serve.main`` on the card with ``argv`` and its ``--out`` in a
    temporary directory, the launch counts zeroed just before it.  Prints
    its lines; returns (payload, launches)."""
    for fn in OPEN_LOOP_KERNELS.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_open_loop_") as tmp:
        out = Path(tmp) / "BENCH_torch_serve.json"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench_serve.main(["--device", str(dev), *argv,
                                   "--out", str(out)])
        seconds = time.perf_counter() - t0
        payload = json.loads(out.read_text())
    launches = open_loop_launches()
    print(buf.getvalue(), end="")
    expect(rc == 0, f"{label}: bench_serve exited {rc}")
    print(f"{label}: {seconds:.1f} s of command time; launches {launches}")
    return payload, launches


def check_open_loop(p, smi, label):
    """The spine's invariants on one payload: no ack rejected, no short
    commit, no drop, no overflow latch; exactly one psync per queue op
    (SOFT: one per acked enqueue, one per dequeue; the CPU parity test
    pins the same value for both packages); the registry's psyncs per op
    within the update share; and the payload's meta names this card and
    its power limit."""
    c, ppo, cfg = p["counters"], p["psync_per_op"], p["config"]
    expect(c["ack_rejected"] == 0 and c["commit_short"] == 0,
           f"{label}: ack_rejected {c['ack_rejected']}, commit_short "
           f"{c['commit_short']}")
    expect(c["router_dropped"] == 0 and c["pipeline_abandoned"] == 0,
           f"{label}: router_dropped {c['router_dropped']}")
    expect(not c["registry_overflowed"] and not c["queue_overflowed"],
           f"{label}: an overflow latch fired")
    expect(ppo["req_queue"] == 1.0 and ppo["resp_queue"] == 1.0,
           f"{label}: queue psyncs per op {ppo}, expected exactly 1.0")
    update_share = 1.0 - cfg["read_pct"] / 100.0
    expect(ppo["registry"] is not None
           and 0 < ppo["registry"] <= update_share,
           f"{label}: registry psyncs per op {ppo['registry']} above the "
           f"update share {update_share}")
    lat = p["latency"]
    expect(p["requests_completed"] > 0
           and lat["count"] == p["requests_completed"]
           and all(np.isfinite(lat[k]) for k in ("p50_ms", "p99_ms",
                                                 "p999_ms")),
           f"{label}: latency samples")
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    meta = p["meta"]
    expect(meta["device_name"] == name == torch.cuda.get_device_name(0)
           and meta["power_limit"] == limit,
           f"{label}: meta names {meta['device_name']!r} at "
           f"{meta['power_limit']!r}, the card is {smi!r}")
    spans = ", ".join(
        f"{k} mean {v['mean_ms']:.3f} p50 {v['p50_ms']:.3f} p99 "
        f"{v['p99_ms']:.3f}" for k, v in p["spans_ms"].items())
    print(f"{label}: offered {p['offered_rate']:.1f}/s, served "
          f"{p['ops_per_sec']:.1f} ops/s ({p['requests_completed']} "
          f"requests in {p['duration_sec']:.3f} s); latency ms p50 "
          f"{lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} p999 "
          f"{lat['p999_ms']:.3f} (exact={lat['exact']}); span ms: {spans}; "
          f"backlog peak {c['backlog_peak']}, end {c['backlog_end']}; "
          f"psyncs per op {ppo}; meta {meta['device_name']}, "
          f"{meta['power_limit']}")


class RecordingRegistry:
    """Passes ``apply`` through to the registry and keeps each batch's
    results, so the drill can check every lane that ``_spine_round``
    served."""

    def __init__(self, registry):
        self.registry = registry
        self.results = []

    def apply(self, ops, keys, values):
        res = self.registry.apply(ops, keys, values)
        self.results.append(res)
        return res


def drill_rounds(dev, spine, m, ref, gen, batch, fills, label, recorder,
                 window=None):
    """``_spine_round`` once per fill (real lanes; the rest of the
    ``batch`` are OP_NOP), every served lane then checked against the
    reference.  ``window``, a context manager, encloses the rounds alone
    (not the checks).  Returns the host wall seconds of the rounds and
    what ``window`` yielded."""
    registry, req_q, resp_q = spine
    rounds = []
    for n in fills:
        _, k, o = gen.take(1e9, n)
        keys = np.zeros((batch,), np.int32)
        ops = np.full((batch,), OP_NOP, np.int32)
        keys[:n], ops[:n] = k, o
        rounds.append((ops, keys))
    recorder.results.clear()
    sync(dev)
    with (window or contextlib.nullcontext()) as held:
        t0 = time.perf_counter()
        for ops, keys in rounds:
            bench_serve._spine_round(m, recorder, req_q, resp_q,
                                     req_q.spec, keys, ops)
        sync(dev)
        seconds = time.perf_counter() - t0
    got = results(recorder.results)
    for i, (ops, keys) in enumerate(rounds):
        exp = ref.apply(ops, keys, keys)
        ref.ops -= int((ops == OP_NOP).sum())    # padding is no op
        expect((got[i] == exp).all(),
               f"{label}: round {i} differs from the reference")
    expect(len(registry) == int(ref.present.sum()), f"{label}: size")
    expect(registry.psyncs == ref.psyncs and registry.ops == ref.ops,
           f"{label}: registry psyncs {registry.psyncs} / ops "
           f"{registry.ops} != reference {ref.psyncs} / {ref.ops}")
    expect(len(req_q) == 0 and len(resp_q) == 0,
           f"{label}: a queue kept requests after a full round")
    return seconds, held


def open_loop_drill(dev, cfg=None):
    """Phase 7c: the spine at bench_serve's default geometry (or ``cfg``),
    built by ``_build_spine``; 20 rounds of its arrival stream (some padded with
    OP_NOP) through ``_spine_round``, every registry lane against the host
    reference; 4 more counting host syncs by site and 4 under the
    profiler; then a crash and recovery of the registry and both queues.
    Returns the launches."""
    cfg = cfg or bench_serve.ServeConfig(device=str(dev))
    m = MetricsRegistry()
    spine = bench_serve._build_spine(cfg, m)
    registry, req_q, resp_q = spine
    recorder = RecordingRegistry(registry)
    ref = Reference(cfg.key_range, cfg.mode)
    gen = bench_serve._ArrivalGen(cfg, 1e6)
    label = "open-loop drill"
    for fn in OPEN_LOOP_KERNELS.values():
        fn.launches = 0
    fills = [cfg.batch if i % 4 else cfg.batch - 300 - 7 * i
             for i in range(DRILL_ROUNDS)]
    seconds, _ = drill_rounds(dev, spine, m, ref, gen, cfg.batch, fills,
                              label, recorder)
    lookups = table_probe_cuda.launches
    print(f"{label}: {DRILL_ROUNDS} rounds ({sum(fills)} requests, "
          f"{DRILL_ROUNDS * cfg.batch - sum(fills)} OP_NOP lanes) in "
          f"{seconds * 1e3:.3f} ms ({seconds * 1e3 / DRILL_ROUNDS:.3f} ms "
          f"per round), every lane against the reference; table_probe "
          f"{lookups / DRILL_ROUNDS:.2f} launches per round; {len(registry)} "
          f"live keys")
    _, (sites, other) = drill_rounds(
        dev, spine, m, ref, gen, cfg.batch, [cfg.batch] * DRILL_EXTRA,
        f"{label} sync count", recorder, window=sync_sites())
    print_sites(label, f"{DRILL_EXTRA} rounds", sites, other)
    print(f"{label}: {sum(sites.values()) / DRILL_EXTRA:.2f} host syncs per "
          "round in the port's code")
    from torch.profiler import ProfilerActivity, profile as torch_profile
    wall, prof = drill_rounds(
        dev, spine, m, ref, gen, cfg.batch, [cfg.batch] * DRILL_EXTRA,
        f"{label} profiled", recorder,
        window=torch_profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]))
    rows, busy = device_rows(prof)
    print(f"{label} profile: {DRILL_EXTRA} rounds, wall {wall * 1e6:.1f} "
          f"us, device busy {busy:.1f} us ({100 * busy / (wall * 1e6):.2f}%),"
          f" {sum(r[1] for r in rows) / DRILL_EXTRA:.1f} device ops per "
          "round")
    for us, n, key in rows[:8]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    spans = m.snapshot()["histograms"]
    print(f"{label}: span ms (mean over {len(fills) + 2 * DRILL_EXTRA} "
          "rounds): " + ", ".join(
              f"{k[5:]} {v['mean'] * 1e3:.3f}" for k, v in spans.items()
              if k.startswith("span.")))
    counters = m.snapshot()["counters"]
    expect(counters.get("spine.ack_rejected", 0) == 0
           and counters.get("spine.commit_short", 0) == 0,
           f"{label}: spine counters {counters}")

    # crash the registry (a seeded adversary per shard) and both queues
    acked = (int(req_q.state.tail), int(resp_q.state.tail))
    n_scan = scan_cuda.launches
    registry.crash_and_recover(seed=SEED)
    u = np.random.default_rng([SEED, 7]).random(
        cfg.queue_capacity).astype(np.float32)
    req_q.crash_and_recover(u)
    resp_q.crash_and_recover(u)
    scans = scan_cuda.launches - n_scan
    check_recovery_hist(registry, ref, label)
    coll = m.snapshot()["collected"]
    expect(all(coll[k]["recovery_psyncs"] == 0
               for k in ("registry", "req_queue", "resp_queue"))
           and registry.psyncs == 0 and req_q.psyncs == resp_q.psyncs == 0,
           f"{label}: recovery paid psyncs")
    expect(len(req_q) == 0 and len(resp_q) == 0,
           f"{label}: a queue holds requests after recovery")
    expect((int(req_q.state.tail), int(resp_q.state.tail)) == acked
           and int(req_q.state.head) == acked[0]
           and int(resp_q.state.head) == acked[1],
           f"{label}: the queues' cursors after recovery")
    ref.psyncs = ref.ops = 0
    check_membership(registry, ref, dev, MEMBER_CHUNK,
                     f"{label} after recovery")
    expect(scans == cfg.shards + 2,
           f"{label}: recovery_scan launched {scans} times, expected "
           f"{cfg.shards + 2} (once per shard and per queue)")
    launches = open_loop_launches()
    print(f"{label}: recovery ms registry "
          f"{registry.last_recovery_seconds * 1e3:.3f}, queues "
          f"{req_q.last_recovery_seconds * 1e3:.3f} and "
          f"{resp_q.last_recovery_seconds * 1e3:.3f}; recovery psyncs 0; "
          f"{acked[0]} acked requests all committed before the crash, both "
          f"queues empty after it; the whole key range of "
          f"{cfg.key_range} against the reference; launches {launches}")
    return launches


def run_open_loop_phase(dev, smi):
    """Phase 7.  Returns the open-loop launches for the JSON record."""
    t0 = time.perf_counter()
    cfg = bench_serve.ServeConfig()
    print(f"phase 7: the open-loop serving harness at bench_serve's default "
          f"geometry: a {cfg.capacity}-slot {cfg.mode.upper()} "
          f"{cfg.backend} registry over {cfg.shards} shards, Zipf("
          f"{cfg.zipf_s}) over {cfg.key_range} keys, {cfg.read_pct}/"
          f"{(100 - cfg.read_pct) // 2}/{(100 - cfg.read_pct) // 2} read/"
          f"update/delete, {cfg.batch}-lane batches, two "
          f"{cfg.queue_capacity}-slot queues; the one cut: "
          f"--duration {OPEN_LOOP_SECONDS:g} s (default {cfg.duration:g})")
    full, full_l = run_bench_serve(
        dev, ["--duration", str(OPEN_LOOP_SECONDS), "--utilization", "0.6"],
        "open loop")
    check_open_loop(full, smi, "open loop")
    expect(full_l["table_probe"] > 0,
           "open loop: the probe-window kernel was never launched")
    print(f"open loop: table_probe {full_l['table_probe']} launches")
    sweep, sweep_l = run_bench_serve(
        dev, ["--quick", "--backend", "bucket", "--duration", "5",
              "--utilization", "0.5,0.9"], "bucket sweep")
    check_open_loop(sweep, smi, "bucket sweep")
    expect("utilization_sweep" in sweep and "knee" in sweep
           and len(sweep["utilization_sweep"]) == 2,
           "bucket sweep: no utilization_sweep or knee in the payload")
    expect(sweep_l["hash_probe"] > 0,
           "bucket sweep: hash_probe was never launched")
    print(f"bucket sweep: knee {sweep['knee']}")
    drill = open_loop_drill(dev)
    run_card_tests("open-loop card tests", "open_loop or bench_serve")
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    return {k: {"full": full_l[k], "sweep": sweep_l[k], "drill": drill[k]}
            for k in OPEN_LOOP_KERNELS}


# ---------------------------------------------------------------------------
# 8. the model families
# ---------------------------------------------------------------------------

# (arch, layers kept or None for all, generated tokens) of the serving
# runs: every published width, bf16, the depth cut only where the weights
# would not fit on the card beside the run (about 56.7, 51.6 and 55 GiB)
FAMILY_RUNS = (("mixtral-8x22b", 12, 32), ("arctic-480b", 2, 16),
               ("qwen1.5-110b", 20, 16), ("minicpm3-4b", None, 16),
               ("xlstm-350m", None, 16), ("recurrentgemma-2b", None, 16))
# (arch, layers, S) of decode against prefill at full width in f32 (MoE
# at a capacity factor that drops nothing: check_decode_matches_prefill).
# arctic-480b keeps 1 layer, as the 2 that the others keep would be 102
# GiB in f32; recurrentgemma-2b keeps 3, one (rglru, rglru, attn) period;
# xlstm-350m takes S = 255, so that both prefills are one mLSTM chunk
# (S = 511 would fail the chunk check, as JAX's assert).
FAMILY_DECODE_PREFILL = (("mixtral-8x22b", 2, 511), ("arctic-480b", 1, 511),
                         ("qwen1.5-110b", 2, 511), ("minicpm3-4b", 2, 511),
                         ("xlstm-350m", 2, 255),
                         ("recurrentgemma-2b", 3, 511))


def check_family_attention(dev):
    """Both attention kernels against their plain versions at the serving
    shapes of the families (B 8, S 512, bf16), timed beside the library
    call; returns the rows by arch."""
    rows = {}
    for arch, _, gen in FAMILY_RUNS:
        cfg = get_config(arch)
        if not attention_layers(cfg):
            continue
        window = cfg.window if (cfg.attn_kind == "swa"
                                or cfg.family == "hybrid") else 0
        d = cfg.head_dim + (cfg.rope_dim if cfg.mla else 0)
        kv = cfg.n_heads if cfg.mla else cfg.n_kv_heads
        row = {"prefill": check_prefill(dev, 8, 512, cfg.n_heads, kv, d,
                                        window, torch.bfloat16)}
        if not cfg.mla:
            s = 512 + gen
            if cfg.family == "hybrid":
                s = min(s, cfg.window)
            row["decode"] = check_decode(dev, 8, cfg.n_heads, kv, d, s,
                                         torch.bfloat16)
        rows[arch] = row
    return rows


def run_family(dev, smi, arch, layers, gen, requests=8, prompt_len=512):
    """serve.run at the arch's full width, bf16, random weights from the
    seed, with a crash of the registry; checks its results and launch
    counts and returns the launches."""
    cfg = get_config(arch)
    cut = "" if layers is None else \
        f" (depth cut: {layers} of {cfg.n_layers} layers)"
    if layers is not None:
        cfg = cfg.with_layers(layers)
    fns = {"recovery_scan": scan_cuda, "table_probe": table_probe_cuda,
           "gqa_decode": gqa_decode_cuda, "flash_prefill": flash_prefill_cuda}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device=dev)
    launches = {k: fn.launches for k, fn in fns.items()}
    tokens = res["tokens"]
    expect(tuple(tokens.shape) == (requests, gen)
           and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
           and bool(torch.isfinite(res["logits"]).all()),
           f"serve {arch}: generated tokens or logits out of range")
    expect(res["registered"] == requests and res["psyncs"] == requests
           and res["registered_after_recovery"] == requests
           and res["recovery_psyncs"] == 0
           and res["psyncs_after_recovery"] == 0,
           f"serve {arch}: {res['psyncs']} psyncs for {requests} requests, "
           f"{res['recovery_psyncs']} in recovery")
    attn, gqa = attention_layers(cfg), decode_attention_layers(cfg)
    expect(launches["flash_prefill"] == attn
           and launches["gqa_decode"] == gqa * (gen - 1),
           f"serve {arch}: flash_prefill {launches['flash_prefill']} and "
           f"gqa_decode {launches['gqa_decode']} launches, expected {attn} "
           f"and {gqa * (gen - 1)}")
    expect(launches["table_probe"] > 0 and launches["recovery_scan"] > 0,
           f"serve {arch}: the registry's kernels were not launched")
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(res["params"]))
    print(f"serve {arch}{cut}: {cfg.n_layers} layers ({attn} attention, "
          f"{gqa} through gqa_decode), {cfg.compute_dtype}, "
          f"{wbytes / 2**30:.2f} GiB of "
          f"weights; {requests} requests x {prompt_len} + {gen} tokens; "
          f"prefill {res['prefill_ms']:.3f} ms; decode "
          f"{res['decode_ms_per_step']:.3f} ms per step (weight-stream "
          f"bound {bytes_ms(wbytes):.3f} ms); {res['tok_per_s']:.1f} tok/s; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    params = res["params"]
    del res, tokens
    if arch == "mixtral-8x22b":
        torch.cuda.empty_cache()
        pre = profile_prefill(dev, cfg, params, requests, prompt_len)
        torch.cuda.empty_cache()
        dec = profile_decode(dev, cfg, params, requests, prompt_len, steps=4)
        print(f"mixtral-8x22b ({layers} of 56 layers) decode on {smi}: "
              f"{dec['wall_ms_per_step']:.3f} ms per step profiled against "
              f"the weight-stream bound {bytes_ms(wbytes):.3f} ms; device "
              f"busy {dec['busy_share']:.2f}% of decode, "
              f"{pre['busy_share']:.2f}% of a warm prefill; "
              f"{dec['ops_per_step'] / cfg.n_layers:.1f} device ops per "
              f"layer per step")
    del params
    torch.cuda.empty_cache()
    return launches


def run_families_phase(dev, smi):
    """Phase 8.  Returns the launches by arch and the kernels' rows at the
    families' shapes."""
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated(dev)
    print(f"phase 8: {held / 2**30:.2f} GiB still allocated from earlier "
          f"phases")
    shapes = check_family_attention(dev)
    torch.cuda.empty_cache()
    launches = {}
    for arch, layers, gen in FAMILY_RUNS:
        launches[arch] = run_family(dev, smi, arch, layers, gen)
    for arch, layers, s in FAMILY_DECODE_PREFILL:
        check_decode_matches_prefill(dev, arch, s=s, layers=layers)
        torch.cuda.empty_cache()
    run_card_tests("model-family card tests", "family")
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return launches, shapes


# ---------------------------------------------------------------------------
# 9. the vlm and audio front ends
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-2b"
AUDIO_ARCH = "whisper-base"
# qwen2-vl-2b's prompt rows: 64 text tokens, one image of 16 x 16 merged
# patches, 192 text tokens (512 in all); whisper-base's decoder prompt and
# generation
VLM_LAYOUT = (64, 16, 192)
AUDIO_PROMPT, AUDIO_GEN = 64, 32


def vlm_positions(b, dev, text0=64, grid=16, text1=192):
    """Qwen2-VL's M-RoPE positions (arXiv:2409.12191 section 2.1;
    ``get_rope_index`` of transformers' Qwen2VLForConditionalGeneration) of
    rows laid out as ``text0`` text tokens (t = h = w = 0 .. text0 - 1),
    one image of grid x grid merged patches (t = text0, h = text0 + row,
    w = text0 + col), then ``text1`` text tokens from the image's greatest
    position + 1: (3, B, S) int32 (temporal, height, width)."""
    t = torch.arange(text0)
    rows = torch.arange(grid).repeat_interleave(grid)
    cols = torch.arange(grid).repeat(grid)
    img = torch.stack([torch.full((grid * grid,), text0), text0 + rows,
                       text0 + cols])
    start = text0 + grid
    post = torch.arange(start, start + text1)
    pos = torch.cat([t.expand(3, -1), img, post.expand(3, -1)], 1)
    return pos.to(torch.int32)[:, None].expand(3, b, -1).contiguous().to(dev)


def _pos_mask(q_pos, k_pos, window):
    """(B, Sq, Sk) live pairs of a position mask, as attention_dense."""
    live = k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        live &= k_pos[:, None, :] > q_pos[:, :, None] - window
    return live


def check_prefill_positions(dev, label, b, sq, sk, h, kv, d, q_pos, k_pos,
                            window=0, dtype=torch.bfloat16):
    """flash_prefill by positions against its plain version at one shape,
    timed beside ``scaled_dot_product_attention`` with the boolean mask of
    the same positions.  Returns the row's fields."""
    gen = torch.Generator(device=dev).manual_seed(SEED + sq + sk + d)
    q = _randn(gen, (b, sq, h, d), dtype, dev)
    k = _randn(gen, (b, sk, kv, d), dtype, dev)
    v = _randn(gen, (b, sk, kv, d), dtype, dev)

    def kernel():
        return flash_prefill_cuda(q, k, v, window, q_pos=q_pos, k_pos=k_pos)
    got = kernel()
    want = flash_prefill_ref(q, k, v, window, q_pos=q_pos, k_pos=k_pos)
    sync(dev)
    err = float((got.float() - want.float()).abs().max())
    atol = ATOL["flash_prefill"][dtype]
    tag = (f"flash_prefill by positions, {label}: B={b} Sq={sq} Sk={sk} "
           f"H={h} KV={kv} D={d} window={window} {str(dtype)[6:]}")
    expect(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    expect(err <= atol, f"{tag}: max |kernel - plain| {err} > {atol}")
    mask = _pos_mask(q_pos, k_pos, window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_call():
        return sdpa(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
    lib_err = float((lib_call().transpose(1, 2).float()
                     - want.float()).abs().max())
    expect(lib_err <= atol, f"{tag}: scaled_dot_product_attention "
           f"disagrees with plain ({lib_err})")
    if dtype == torch.bfloat16:
        expect(err <= lib_err, f"{tag}: kernel error {err} above the "
               f"library's {lib_err}")
    ms = time_ms(kernel, dev, reps=20)
    plain = time_ms(lambda: flash_prefill_ref(q, k, v, window, q_pos=q_pos,
                                              k_pos=k_pos), dev, reps=5)
    lib_ms = time_ms(lib_call, dev, reps=20)
    live = int(mask.sum())
    elt = q.element_size()
    nbytes = ((2 * q.numel() + k.numel() + v.numel()) * elt
              + 4 * (q_pos.numel() + k_pos.numel()))
    flops = 4.0 * live * (h // kv) * kv * d
    bound, by = bound_ms(nbytes, flops, dtype)
    print(f"{tag}: max err {err:.3g}, library's {lib_err:.3g} (tolerance "
          f"{atol}); kernel {ms:.6f} ms, plain {plain:.6f} ms, library "
          f"{lib_ms:.6f} ms, bound {bound * 1e3:.3f} us ({by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, {live} live "
          f"pairs)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err)


def _edge_positions(kind, rng, b, sq, sk):
    """Positions for the edge sweep: all zero; random in [0, 24) (repeats,
    and rows before every key); sorted with repeats (an image's patches
    sharing one temporal position); queries that continue the keys (a
    chunk after a cached prefix)."""
    if kind == "zeros":
        qp, kp = np.zeros((b, sq)), np.zeros((b, sk))
    elif kind == "random":
        qp, kp = rng.integers(0, 24, (b, sq)), rng.integers(0, 24, (b, sk))
    elif kind == "sorted":
        top = max(sk // 2, 1)
        qp = np.sort(rng.integers(0, top, (b, sq)), 1)
        kp = np.sort(rng.integers(0, top, (b, sk)), 1)
    else:
        qp = np.broadcast_to(np.arange(sq) + sk - sq, (b, sq))
        kp = np.broadcast_to(np.arange(sk), (b, sk))
    return (torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (qp, kp))


def check_position_edges(dev):
    """flash_prefill by positions against its plain version over Sq != Sk,
    ragged Sq and Sk, head dims 8 to 256, G 1, 6 and 8, windows 0, 5 and
    50, and positions all zero, random (rows with no live key), sorted
    with repeats and continuing the keys, in f32 and bf16."""
    rng = np.random.default_rng(SEED)
    grid = [(2, sq, sk, kv * g, kv, d, w)
            for d in (8, 64, 120, 128, 256) for sq, sk in
            ((1, 1), (63, 100), (65, 300), (130, 64), (200, 200))
            for g, kv in ((1, 2), (6, 2), (8, 1)) for w in (0, 5, 50)
            if d in (64, 128) or (g == 6 and w != 5)]
    kinds = ("zeros", "random", "sorted", "offset")
    count, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        atol = ATOL["flash_prefill"][dtype]
        for i, (b, sq, sk, h, kv, d, w) in enumerate(grid):
            kind = kinds[i % len(kinds)]
            qp, kp = (t.to(dev) for t in _edge_positions(kind, rng, b, sq,
                                                         sk))
            gen = torch.Generator(device=dev).manual_seed(SEED + i)
            q = _randn(gen, (b, sq, h, d), dtype, dev)
            k = _randn(gen, (b, sk, kv, d), dtype, dev)
            v = _randn(gen, (b, sk, kv, d), dtype, dev)
            got = flash_prefill_cuda(q, k, v, w, q_pos=qp, k_pos=kp)
            want = flash_prefill_ref(q, k, v, w, q_pos=qp, k_pos=kp)
            err = float((got.float() - want.float()).abs().max())
            expect(bool(torch.isfinite(got).all()) and err <= atol,
                   f"flash_prefill by positions ({kind}) B={b} Sq={sq} "
                   f"Sk={sk} H={h} KV={kv} D={d} window={w} "
                   f"{str(dtype)[6:]}: max |kernel - plain| {err} > {atol}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            count += 1
    print(f"flash_prefill by positions, edge shapes: {count} held against "
          f"plain (Sq 1-200, Sk 1-300, D 8-256, G 1, 6, 8, windows 0, 5, "
          f"50; positions zero, random, sorted with repeats, continuing the "
          f"keys); max err f32 {worst[torch.float32]:.3g}, bf16 "
          f"{worst[torch.bfloat16]:.3g}")
    return count


def check_frontend_kernels(dev):
    """Both attention kernels at the shapes the two front ends give them,
    bf16: the vlm's positions path with the image mask, whisper's encoder
    (every pair live) and cross-attention prefill, gqa_decode at G 1, D 64
    over the decoder's 96 slots and the 1500 frames, and the index path at
    whisper's decoder shape.  Returns the rows."""
    vcfg, acfg = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    b, s = 8, VLM_LAYOUT[0] + VLM_LAYOUT[1] ** 2 + VLM_LAYOUT[2]
    tpos = vlm_positions(b, dev, *VLM_LAYOUT)[0]
    se, hd, ha = acfg.enc_seq, acfg.head_dim, acfg.n_heads
    zeros = torch.zeros((b, se), dtype=torch.int32, device=dev)
    rows = {
        "vlm_positions": check_prefill_positions(
            dev, "qwen2-vl image layout", b, s, s, vcfg.n_heads,
            vcfg.n_kv_heads, vcfg.head_dim, tpos, tpos),
        "whisper_encoder": check_prefill_positions(
            dev, "whisper encoder, all live", b, se, se, ha,
            acfg.n_kv_heads, hd, zeros, zeros),
        "whisper_cross": check_prefill_positions(
            dev, "whisper cross-attention", b, AUDIO_PROMPT, se, ha,
            acfg.n_kv_heads, hd, torch.zeros_like(zeros[:, :1]).expand(
                b, AUDIO_PROMPT), zeros),
        "whisper_decoder_index": check_prefill(
            dev, b, AUDIO_PROMPT, ha, acfg.n_kv_heads, hd, 0,
            torch.bfloat16)}
    for name, s_dec in (("whisper_self_decode", AUDIO_PROMPT + AUDIO_GEN),
                        ("whisper_cross_decode", se)):
        rows[name] = check_decode(dev, b, ha, acfg.n_kv_heads, hd, s_dec,
                                  torch.bfloat16, fill=s_dec)
    edges = check_position_edges(dev)
    return rows, edges


ATTENTION_KERNELS = {"flash_prefill": flash_prefill_cuda,
                     "gqa_decode": gqa_decode_cuda}


def _zero_launches():
    for fn in (scan_cuda, table_probe_cuda, gqa_decode_cuda,
               flash_prefill_cuda):
        fn.launches = 0


def _attention_launches():
    return {k: fn.launches for k, fn in ATTENTION_KERNELS.items()}


def generate_timed(dev, cfg, params, batch, max_seq, gen):
    """prefill + (gen - 1) greedy decode steps through the serve steps,
    with the attention kernels' launches counted separately for each
    (counts zeroed just before, read just after) and the device
    synchronized around each.  Returns the tokens, the last logits, the
    launches and the host ms."""
    prefill_step, decode_step = TS.make_serve_steps(cfg)
    b = next(iter(batch.values())).shape[0]
    caches = M.init_cache(cfg, b, max_seq, device=dev)
    sync(dev)
    _zero_launches()
    t0 = time.perf_counter()
    caches, logits = prefill_step(params, batch, caches)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    sync(dev)
    t1 = time.perf_counter()
    pre = _attention_launches()
    _zero_launches()
    out = [nxt]
    for _ in range(gen - 1):
        caches, nxt, logits = decode_step(params, caches, nxt)
        out.append(nxt)
    sync(dev)
    t2 = time.perf_counter()
    dec = _attention_launches()
    tokens = torch.cat(out, 1)
    expect(tuple(tokens.shape) == (b, gen)
           and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
           and bool(torch.isfinite(logits).all()),
           f"{cfg.name}: generated tokens or logits out of range")
    return tokens, logits, {"prefill": pre, "decode": dec}, dict(
        prefill_ms=(t1 - t0) * 1e3,
        decode_ms_per_step=(t2 - t1) * 1e3 / max(gen - 1, 1))


def _expect_launches(label, got, prefill, decode):
    expect(got["prefill"] == {"flash_prefill": prefill, "gqa_decode": 0}
           and got["decode"] == {"flash_prefill": 0, "gqa_decode": decode},
           f"{label}: launches {got}, expected flash_prefill {prefill} in "
           f"prefill and gqa_decode {decode} in decode")


def run_vlm(dev, smi, requests=8, prompt_len=512, gen=16):
    """qwen2-vl-2b at full width and depth, bf16, random weights from the
    seed: serve.run of token prompts at the default M-RoPE positions with
    a crash of the registry, then a model-level prefill of embedding rows
    at Qwen2-VL's M-RoPE positions of text, an image and text (the
    positions path) and 16 decode steps.  Returns the launches."""
    cfg = get_config(VLM_ARCH)
    attn, dec_attn = attention_layers(cfg), decode_attention_layers(cfg)
    _zero_launches()
    t0 = time.perf_counter()
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device=dev)
    served = {"recovery_scan": scan_cuda.launches,
              "table_probe": table_probe_cuda.launches,
              **_attention_launches()}
    tokens = res["tokens"]
    expect(tuple(tokens.shape) == (requests, gen)
           and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
           and bool(torch.isfinite(res["logits"]).all()),
           f"serve {VLM_ARCH}: generated tokens or logits out of range")
    expect(res["registered"] == requests and res["psyncs"] == requests
           and res["registered_after_recovery"] == requests
           and res["recovery_psyncs"] == 0,
           f"serve {VLM_ARCH}: {res['psyncs']} psyncs for {requests} "
           f"requests, {res['recovery_psyncs']} in recovery")
    expect(served["flash_prefill"] == attn
           and served["gqa_decode"] == dec_attn * (gen - 1)
           and served["table_probe"] > 0 and served["recovery_scan"] > 0,
           f"serve {VLM_ARCH}: launches {served}, expected flash_prefill "
           f"{attn}, gqa_decode {dec_attn * (gen - 1)} and the registry's")
    params = res["params"]
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(params))
    print(f"serve {VLM_ARCH}: {cfg.n_layers} layers, {cfg.compute_dtype}, "
          f"{M.param_count(cfg)} parameters, {wbytes / 2**30:.2f} GiB of "
          f"weights; {requests} requests x {prompt_len} + {gen} tokens at "
          f"the default M-RoPE positions; prefill {res['prefill_ms']:.3f} "
          f"ms; decode {res['decode_ms_per_step']:.3f} ms per step "
          f"(weight-stream bound {bytes_ms(wbytes):.3f} ms); "
          f"{res['tok_per_s']:.1f} tok/s; launches {served}; "
          f"{time.perf_counter() - t0:.1f} s")
    del res, tokens

    # embedding rows at M-RoPE positions: token embeddings for the text,
    # N(0, 0.02^2) for the image's merged patches
    text0, grid, text1 = VLM_LAYOUT
    s = text0 + grid * grid + text1
    gen_ = torch.Generator(device=dev).manual_seed(SEED + 9)
    tok = torch.randint(0, cfg.vocab, (requests, s), generator=gen_,
                        device=dev)
    embeds = params["embed"]["w"][tok].clone()
    embeds[:, text0:text0 + grid * grid] = 0.02 * torch.randn(
        (requests, grid * grid, cfg.d_model), generator=gen_, device=dev)
    batch = {"embeds": embeds, "positions": vlm_positions(requests, dev,
                                                           *VLM_LAYOUT)}
    dgen = 17
    _, _, launches, ms = generate_timed(dev, cfg, params, batch, s + dgen,
                                        dgen)
    _expect_launches(f"{VLM_ARCH} embeds at M-RoPE positions", launches,
                     attn, dec_attn * (dgen - 1))
    torch.cuda.empty_cache()
    pre = profile_prefill(dev, cfg, params, requests, s, batch)
    dec = profile_decode(dev, cfg, params, requests, s, steps=4)
    print(f"{VLM_ARCH} on {smi}: {requests} rows of {s} embeddings ({text0} "
          f"text, a {grid} x {grid} image, {text1} text) through the "
          f"positions path: prefill {ms['prefill_ms']:.3f} ms, "
          f"{dgen - 1} decode steps {ms['decode_ms_per_step']:.3f} ms per "
          f"step (weight-stream bound {bytes_ms(wbytes):.3f} ms); "
          f"profiled: prefill busy {pre['busy_share']:.2f}%, decode "
          f"{dec['wall_ms_per_step']:.3f} ms per step, busy "
          f"{dec['busy_share']:.2f}%, {dec['ops_per_step'] / cfg.n_layers:.1f}"
          f" device ops per layer per step; launches {launches}")
    del params, embeds, batch
    torch.cuda.empty_cache()
    return {"serve": served, "embeds": launches}


def run_whisper(dev, smi, requests=8):
    """whisper-base at full width and depth (6 + 6 layers), bf16, random
    weights from the seed: the encoder over 1500 frame embeddings (its
    30 s window), a 64-token decoder prompt and 32 generated tokens
    through ``make_serve_steps``.  Returns the launches."""
    cfg = get_config(AUDIO_ARCH)
    params = M.init_params(cfg, seed=SEED, device=dev)
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in tree_leaves(params))
    gen_ = torch.Generator(device=dev).manual_seed(SEED + 10)
    batch = {"embeds": torch.randn((requests, cfg.enc_seq, cfg.d_model),
                                   generator=gen_, device=dev).to(
                                       torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (requests, AUDIO_PROMPT),
                                     generator=gen_, device=dev,
                                     dtype=torch.int32)}
    runs = []
    for _ in range(2):      # the first also pays cuBLAS's first calls
        runs.append(generate_timed(dev, cfg, params, batch,
                                   AUDIO_PROMPT + AUDIO_GEN, AUDIO_GEN))
    launches = runs[-1][2]
    _expect_launches(AUDIO_ARCH, launches, attention_layers(cfg),
                     decode_attention_layers(cfg) * (AUDIO_GEN - 1))
    expect(torch.equal(runs[0][0], runs[1][0]),
           f"{AUDIO_ARCH}: two runs on the same inputs differ")
    pre = profile_prefill(dev, cfg, params, requests, AUDIO_PROMPT, batch)
    dec = profile_decode(dev, cfg, params, requests, AUDIO_PROMPT, steps=4)
    pre_ms = ", ".join("%.3f" % r[3]["prefill_ms"] for r in runs)
    dec_ms = ", ".join("%.3f" % r[3]["decode_ms_per_step"] for r in runs)
    print(f"{AUDIO_ARCH} on {smi}: {cfg.enc_layers} + {cfg.n_layers} layers, "
          f"{cfg.compute_dtype}, {wbytes / 2**20:.1f} MiB of weights; "
          f"{requests} x {cfg.enc_seq} frames, a {AUDIO_PROMPT}-token prompt, "
          f"{AUDIO_GEN} generated; prefill {pre_ms} ms; decode {dec_ms} ms "
          f"per step (weight-stream bound {bytes_ms(wbytes):.3f} ms); "
          f"profiled: prefill busy {pre['busy_share']:.2f}%, decode "
          f"{dec['wall_ms_per_step']:.3f} ms per step, busy "
          f"{dec['busy_share']:.2f}%; launches {launches}")
    del params, batch
    torch.cuda.empty_cache()
    return launches


def run_frontends_phase(dev, smi):
    """Phase 9.  Returns the launches by arch and the kernels' rows at the
    front ends' shapes."""
    t0 = time.perf_counter()
    rows, edges = check_frontend_kernels(dev)
    torch.cuda.empty_cache()
    launches = {VLM_ARCH: run_vlm(dev, smi), AUDIO_ARCH: run_whisper(dev, smi)}
    check_decode_matches_prefill(dev, VLM_ARCH, s=511, layers=2)
    torch.cuda.empty_cache()
    check_decode_matches_prefill(dev, AUDIO_ARCH, s=63, layers=2)
    torch.cuda.empty_cache()
    run_card_tests("front-end card tests", "frontend")
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return launches, rows, edges


# ---------------------------------------------------------------------------
# 10. training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube-3-4b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048       # 8192 tokens a step
TRAIN_WARM, TRAIN_TIMED = 2, 8
TRAIN_LR = 3e-4                        # AdamW, warmup 1, cosine over 10
TRAIN_DRILL_ARCH = "h2o-danube-3-4b-smoke"
TRAIN_DRILL_RTOL = 1e-5                # of each leaf's largest magnitude


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def run_train_steps(dev, smi, arch=TRAIN_ARCH, b=TRAIN_BATCH, s=TRAIN_SEQ,
                    warm=TRAIN_WARM, timed=TRAIN_TIMED):
    """``launch/train.py``'s train step at full width and depth: bf16
    params, f32 AdamW, the config's remat, one fixed ``SyntheticTokens``
    batch of b x s.  ``warm`` + ``timed`` steps, each synchronized; then
    one more under the profiler.  The loss is finite and ends below its
    first value, the grad norm is > 0, the params change, and neither
    attention kernel is launched.  Returns the numbers printed."""
    cfg = get_config(arch)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup=1,
                                total_steps=warm + timed,
                                state_dtype=cfg.opt_dtype)
    torch.cuda.reset_peak_memory_stats(dev)
    state = TS.init_train_state(cfg, SEED, opt_cfg, device=dev)
    n_params = param_count(cfg)
    step_fn = TS.make_train_step(cfg, opt_cfg)
    data = SyntheticTokens(cfg.vocab, s, b, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(iter(data)).items()}
    probe = state.params["stack_0"]["b0_attn"]["mlp"]["wi"][0, :4, :64]
    before = probe.clone()
    sync(dev)
    _zero_launches()
    metrics, times = [], []
    for _ in range(warm + timed):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = _attention_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    changed = float((probe.float() - before.float()).abs().max())
    print(f"train {arch}: losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(x, 4) for x in gnorms]}")
    expect(launches == {"flash_prefill": 0, "gqa_decode": 0},
           f"train {arch}: attention kernels launched {launches}, "
           "expected none (training attention is attention_dense)")
    expect(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"train {arch}: the loss did not fall: {losses}")
    expect(all(g > 0 and np.isfinite(g) for g in gnorms),
           f"train {arch}: grad norms {gnorms}")
    expect(changed > 0, f"train {arch}: the params did not change")

    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy = device_rows(prof)
    del prof

    step_s = float(np.mean(times[warm:]))
    tokens = b * s
    flops = 6 * n_params * tokens
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    res = dict(
        ms_per_step=step_s * 1e3, ms_steps=[t * 1e3 for t in times[warm:]],
        tokens_per_s=tokens / step_s, peak_gib=peak / 2**30,
        state_gib=sum(_tree_bytes(t) for t in (
            state.params, state.opt.m, state.opt.v)) / 2**30,
        grads_gib=_tree_bytes(state.params) / 2**30,
        busy_share=100 * busy / wall_us, profiled_ms=wall_us / 1e3,
        device_ops=sum(r[1] for r in rows),
        train_mfu=flops / step_s / peak_flops,
        bound_ms=flops / peak_flops * 1e3, loss_first=losses[0],
        loss_last=losses[-1], params=n_params)
    print(f"train {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} params, {cfg.param_dtype} params, "
          f"{cfg.opt_dtype} AdamW, remat {cfg.remat}), {b} x {s} tokens "
          f"a step, lr {TRAIN_LR}, {smi}: {res['ms_per_step']:.3f} ms a "
          f"step over {timed} (each {[round(t, 3) for t in res['ms_steps']]}"
          f"), {res['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{res['peak_gib']:.2f} GiB against "
          f"{res['state_gib']:.2f} GiB of params, m and v plus "
          f"{res['grads_gib']:.2f} GiB of gradients; "
          f"train_mfu {res['train_mfu']:.4f} (6 x params x tokens = "
          f"{flops:.4e} FLOPs, {res['bound_ms']:.3f} ms at the bf16 peak)")
    print(f"train profile (one step, profiler on): wall "
          f"{res['profiled_ms']:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({res['busy_share']:.2f}%), {res['device_ops']} device "
          f"operations")
    for us, n, key in rows[:10]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")
    del state, batch, metrics, probe, before
    torch.cuda.empty_cache()
    return res, launches


def train_driver_full_width(dev, arch=TRAIN_ARCH, steps=2):
    """``launch/train.py``'s own main at full width and depth for a few
    steps (its data pipeline, a fresh batch a step, no checkpoint): return
    code 0 and a finite loss on its printed line.  Returns its seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_driver.main(["--arch", arch, "--batch", str(TRAIN_BATCH),
                                "--seq", str(TRAIN_SEQ), "--steps",
                                str(steps), "--lr", str(TRAIN_LR),
                                "--device", str(dev)])
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("step ")]
    loss = float(lines[0].split("loss=")[1].split()[0]) if lines else None
    expect(rc == 0 and loss is not None and np.isfinite(loss),
           f"train driver at {arch}: rc {rc}:\n{out.getvalue()}")
    print(f"train driver ({arch}, launch/train.py --batch {TRAIN_BATCH} "
          f"--seq {TRAIN_SEQ} --steps {steps}): {lines[0]}; "
          f"{seconds:.1f} s with the init")
    torch.cuda.empty_cache()
    return seconds


def _checkpoint_arrays(path):
    mgr = CheckpointManager(path)
    try:
        return mgr.latest_step(), mgr.restore()
    finally:
        mgr.close()


def train_drill(dev, arch=TRAIN_DRILL_ARCH):
    """``launch/train.py`` on the card: 20 steps saved every 5, once
    uninterrupted and once with ``--crash-at 10`` then resumed; the two
    final checkpoints within TRAIN_DRILL_RTOL of each leaf's largest
    magnitude (the embedding's gradient sums by index on the card, in no
    fixed order), ``step`` equal."""
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--arch", arch, "--steps", "20", "--batch", "4", "--seq",
                  "64", "--save-every", "5", "--device", str(dev)]
        a, b = os.path.join(tmp, "clean"), os.path.join(tmp, "crashed")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = (train_driver.main(common + ["--ckpt", a]),
                  train_driver.main(common + ["--ckpt", b, "--crash-at",
                                              "10"]),
                  train_driver.main(common + ["--ckpt", b]))
        text = out.getvalue()
        expect(rc == (0, 1, 0) and "[restore] resumed from step 10" in text,
               f"train drill: return codes {rc}:\n{text}")
        (sa, want), (sb, got) = _checkpoint_arrays(a), _checkpoint_arrays(b)
        expect(sa == sb == 20 and sorted(got) == sorted(want),
               f"train drill: final steps {sa}, {sb}")
        worst = 0.0
        for k, w in want.items():
            w = np.asarray(w, np.float64)
            d = float(np.abs(np.asarray(got[k], np.float64) - w).max())
            rel = d / max(float(np.abs(w).max()), 1e-30)
            worst = max(worst, rel)
            expect(rel <= TRAIN_DRILL_RTOL if k != ".opt/.step" else d == 0,
                   f"train drill: {k} differs by {d} ({rel:.3e} of its "
                   "largest)")
    last = [ln for ln in text.splitlines() if ln.startswith("step ")][-1]
    print(f"train drill ({arch}, launch/train.py --crash-at 10, resumed): "
          f"final state within {worst:.3e} of the uninterrupted run's "
          f"(each leaf against its largest); {last}")
    return worst


def run_training_phase(dev, smi):
    """Phase 10.  Returns the full-width step's numbers and its launches."""
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated(dev)
    print(f"phase 10: {held / 2**30:.2f} GiB still allocated from earlier "
          f"phases")
    res, launches = run_train_steps(dev, smi)
    res["driver_s"] = train_driver_full_width(dev)
    res["drill_rel_err"] = train_drill(dev)
    torch.cuda.empty_cache()
    run_card_tests("training card tests", "train")
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return res, launches


# ---------------------------------------------------------------------------
# 10b. the sharded train step on a (data, model) grid of ranks
# ---------------------------------------------------------------------------

MESH_TRAIN_RANKS = 4
# phase 10's model and batch, depth cut to 2 of 24 layers; ``faults`` are
# the planted faults run after the clean run (``--mesh-train-control``)
MESH_TRAIN = dict(arch=TRAIN_ARCH, layers=2, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, steps=2, grids=((2, 2), (4, 1)),
                  faults=(None,))
# The ranks against one process, bf16 params and activations: the sums run
# in other orders (a row-parallel product's partial sums rounded to bf16
# before their sum over model, the gradients summed over data in bf16).
# The loss within 1e-3 relative and the grad norm within 1e-3; step 1's
# gradients, gathered, each leaf within MESH_TRAIN_GRAD_RTOL of its
# largest magnitude (the check that sees a gradient's scale); after the
# steps at most a tenth of the param elements moved by more than lr / 10.
# Each param element within 2 x steps x lr x (1 + wd |p|) plus steps x
# 2^-7 |p| is a sanity bound only: an AdamW update moves an element by at
# most lr (1 + wd |p|) a step in the first steps (its m-hat / sqrt(v-hat)
# is at most 1), so any gradient, even a wrong one, passes it.
MESH_TRAIN_LOSS_RTOL = 1e-3
MESH_TRAIN_GNORM_RTOL = 1e-3
MESH_TRAIN_GRAD_RTOL = 5e-2
MESH_TRAIN_MOVED_SHARE = 0.1


def mesh_train_setup(plan):
    """The config (cut to ``plan["layers"]``; in ``plan["dtype"]`` where
    the plan names one), AdamW's config and the seeded batch of a mesh
    train phase's plan."""
    cfg = get_config(plan["arch"]).with_layers(plan["layers"])
    if plan.get("dtype"):
        cfg = cfg.replace(param_dtype=plan["dtype"],
                          compute_dtype=plan["dtype"])
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup=1, total_steps=10,
                                state_dtype=cfg.opt_dtype)
    gen = torch.Generator().manual_seed(SEED + 7)
    tok = torch.randint(0, cfg.vocab, (plan["batch"], plan["seq"] + 1),
                        generator=gen, dtype=torch.int32)
    return cfg, opt_cfg, {"tokens": tok[:, :-1].contiguous(),
                          "labels": tok[:, 1:].contiguous()}


def mesh_train_steps(step, state, batch, steps, dev, coll=None):
    """``steps`` train steps, each synchronized: (state, metrics on the
    host, ms of each step, ms of each step spent in the calls that
    ``coll`` (a ``timed_calls`` record) times, empty without one,
    attention kernel launches in all)."""
    sync(dev)
    flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
    metrics, ms, coll_ms = [], [], []
    for _ in range(steps):
        c = coll["s"] if coll is not None else 0.0
        t = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t))
        if coll is not None:
            coll_ms.append(1e3 * (coll["s"] - c))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, ms, coll_ms, (flash_prefill_cuda.launches,
                                         gqa_decode_cuda.launches)


def _param_errors(got, ref, opt_cfg, steps):
    """The gathered params against one process's: the largest |diff|, the
    largest |diff| over its element's sanity bound (2 x steps x lr x (1 +
    wd |ref|) + steps x 2^-7 |ref|), and the share of elements moved by
    more than lr / 10."""
    lr, wd = opt_cfg.lr, opt_cfg.weight_decay
    worst = ratio = 0.0
    moved = total = 0
    for (key, a), (_, b) in zip(tree_leaves(got), tree_leaves(ref)):
        a, b = a.float(), b.to(a.device).float()
        d = (a - b).abs()
        tol = 2 * steps * lr * (1 + wd * b.abs()) + \
            steps * 2.0 ** -7 * b.abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / tol).max()))
        moved += int((d > lr / 10).sum())
        total += d.numel()
    return worst, ratio, moved / total


def _grad_error(got, ref):
    """(leaf, largest |diff| over the leaf's largest magnitude) of the
    gathered gradients against one process's, for the leaf that is off
    most."""
    worst = ("", 0.0)
    for (key, a), (_, b) in zip(tree_leaves(got), tree_leaves(ref)):
        b = b.to(a.device).float()
        err = float((a.float() - b).abs().max()) / \
            max(float(b.abs().max()), 1e-30)
        worst = max(worst, (key, err), key=lambda kv: kv[1])
    return worst


@contextlib.contextmanager
def planted(fault):
    """A fault planted in the sharded step's gradients while the block
    runs (``--mesh-train-control``): "dp" leaves out their sum over the
    batch's dp line (each rank keeps its own rows' gradient), "model"
    sums every leaf whole on data over model (ln1, ln2 and final_norm
    doubled), "router" sums the MoE router's gradient over model (a copy
    onto the model line in front of it: counted twice on (2, 2)),
    "mlstm_gates" moves mLSTM's copy onto the line from the gates'
    logits onto z (``w_if``'s gradient then the rank's heads' part),
    "rglru_gate" takes the copy off RG-LRU's gathered gate input (the
    conv's gradient then the rank's own gate columns' part); None plants
    nothing."""
    from repro_torch.models import blocks as B
    from repro_torch.models import seqmix as SM
    from repro_torch.models import tp as TP
    real_gatherer, real_layout, real_moe = TP.Gatherer, TP.layout, B.moe_ffn
    real_gates, real_gin = SM._mlstm_gate_logits, SM._rglru_gate_input
    if fault == "dp":
        TP.Gatherer = lambda fsdp, dp, tp: real_gatherer(
            fsdp, TP.Line(dp.mesh, None), tp)
    elif fault == "model":
        TP.layout = lambda specs, axis, partial: real_layout(
            specs, axis, [True] * len(partial))
    elif fault == "router":
        def moe_ffn(p, x, cfg, dp=None, tp=None):
            if tp is not None:
                p = dict(p, router=tp.copy_to(p["router"]))
            return real_moe(p, x, cfg, dp, tp)
        B.moe_ffn = moe_ffn
    elif fault == "mlstm_gates":
        SM._mlstm_gate_logits = lambda up, zc, w_if, tp: zc @ w_if
    elif fault == "rglru_gate":
        SM._rglru_gate_input = lambda xw, tp: tp.all_gather(xw, -1)
    try:
        yield
    finally:
        TP.Gatherer, TP.layout, B.moe_ffn = real_gatherer, real_layout, \
            real_moe
        SM._mlstm_gate_logits, SM._rglru_gate_input = real_gates, real_gin


def mesh_train_rank(rank, ref_path, device, plan):
    """A rank of phase 10b: on each grid and for each of ``plan["faults"]``,
    the seed's state cut to this rank's blocks, step 1's gradients
    gathered and held to one process's, then ``plan["steps"]`` sharded
    train steps on its rows of the batch, then its blocks gathered and
    held to one process's params (both saved at ``ref_path``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.meshctx import mesh_context
    from repro_torch.launch.specs import (batch_pspecs, gather,
                                          make_shard_ctx, put)
    from repro_torch.models.params import param_pspecs
    dev = mesh.rank_device(rank, device)
    cfg, opt_cfg, batch = mesh_train_setup(plan)
    # on the host, so that the rank's peak device memory is its own
    ref = torch.load(ref_path, map_location="cpu")
    shape = ShapeConfig("train", plan["seq"], plan["batch"], "train")
    out = {}
    for grid in plan["grids"]:
        mm = mesh.make_model_mesh(grid)
        ctx = make_shard_ctx(cfg, shape, mm)
        specs = param_pspecs(cfg, ctx, mesh=mm)
        for fault in plan["faults"]:
            state = TS.shard_train_state(
                TS.init_train_state(cfg, SEED, opt_cfg, device=dev), cfg,
                ctx, mm)
            rows = put({k: v.to(dev) for k, v in batch.items()},
                       batch_pspecs(cfg, shape, ctx), mm)
            with mesh_context(mm), planted(fault):
                grads = gather(TS.loss_and_grads(cfg, state.params, rows,
                                                 ctx)[2], specs, mm)
                grad_err = _grad_error(grads, ref["grads"])
                del grads
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            # the model mesh's collectives, the backward's (run on the
            # autograd engine's thread) included
            with mesh_context(mm), planted(fault), timed_calls(
                    mesh.ModelMesh, ("all_reduce", "all_gather",
                                     "reduce_scatter")) as coll:
                state, metrics, ms, coll_ms, launches = mesh_train_steps(
                    TS.make_train_step(cfg, opt_cfg, 1, ctx), state, rows,
                    plan["steps"], dev, coll)
            r = dict(metrics=metrics, ms=ms, launches=launches,
                     coll_ms=coll_ms, grad_err=grad_err,
                     coll_calls=coll["n"] / plan["steps"],
                     peak=torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0,
                     state_bytes=sum(_tree_bytes(t) for t in (
                         state.params, state.opt.m, state.opt.v)))
            wq = state.params["stack_0"]["b0_attn"]["attn"]["wq"]
            r["wq"] = (wq.numel(), hashlib.sha1(
                wq.float().cpu().numpy().tobytes()).hexdigest())
            with mesh_context(mm):
                whole = gather(state.params, specs, mm)
                r["errors"] = _param_errors(whole, ref["params"], opt_cfg,
                                            plan["steps"])
                del whole
            out[(grid, fault)] = r
            del state, rows
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def _mesh_train_failures(g, one, grad_rtol=None):
    """(check, what) of each check of phase 10b that one rank's run fails
    against one process's ``one``; ``grad_rtol`` maps a leaf to its
    gradient limit where it is not ``MESH_TRAIN_GRAD_RTOL``."""
    fails = []
    for k, (m, w) in enumerate(zip(g["metrics"], one)):
        for key, rtol in (("loss", MESH_TRAIN_LOSS_RTOL),
                          ("grad_norm", MESH_TRAIN_GNORM_RTOL)):
            if abs(m[key] - w[key]) > rtol * abs(w[key]):
                fails.append((key, f"step {k} {key} {m[key]}, one process "
                                   f"{w[key]}"))
    leaf, err = g["grad_err"]
    if err > (grad_rtol or {}).get(leaf, MESH_TRAIN_GRAD_RTOL):
        fails.append(("grads", f"step 1 gradient {leaf} off by {err:.4g} "
                               "of its largest magnitude"))
    worst, ratio, moved = g["errors"]
    if moved > MESH_TRAIN_MOVED_SHARE:
        fails.append(("moved", f"{moved:.4f} of the param elements moved "
                               "by more than lr / 10"))
    if ratio > 1.0:
        fails.append(("params", f"params off by {worst} ({ratio:.3f} of "
                                "the sanity bound)"))
    return fails


def run_mesh_train_phase(dev, smi, plan=None):
    """Phase 10b.  Returns the ranks' attention kernel launches a step by
    grid.  A run with a planted fault (``plan["faults"]``) must fail a
    check besides the params' sanity bound."""
    plan = plan or MESH_TRAIN
    t0 = time.perf_counter()
    cfg, opt_cfg, batch = mesh_train_setup(plan)
    print(f"phase 10b: the sharded train step on {MESH_TRAIN_RANKS} gloo "
          f"ranks sharing one card, grids {list(plan['grids'])} (data, "
          f"model): {plan['arch']}, {plan['layers']} layers, "
          f"{plan['batch']} x {plan['seq']} tokens, {plan['steps']} steps, "
          f"remat {cfg.remat}")
    state = TS.init_train_state(cfg, SEED, opt_cfg, device=dev)
    state_bytes = sum(_tree_bytes(t) for t in (state.params, state.opt.m,
                                              state.opt.v))
    batch = {k: v.to(dev) for k, v in batch.items()}
    grads = tree_map(lambda a: a.cpu(), TS.loss_and_grads(
        cfg, state.params, batch)[2])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state, one, one_ms, _, one_launches = mesh_train_steps(
        TS.make_train_step(cfg, opt_cfg), state, batch, plan["steps"], dev)
    one_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    expect(one_launches == (0, 0),
           f"one process: attention kernels launched {one_launches}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"params": tree_map(lambda a: a.cpu(), state.params),
                    "grads": grads}, ref_path)
        del state, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = mesh.spawn(mesh_train_rank, MESH_TRAIN_RANKS, ref_path,
                           str(dev), plan)
        spawn_s = time.perf_counter() - t1
    print(f"mesh train one process: ms a step {[round(x, 3) for x in one_ms]}"
          f", losses {[round(m['loss'], 5) for m in one]}, grad norms "
          f"{[round(m['grad_norm'], 5) for m in one]}, peak device memory "
          f"{one_peak / 2**30:.3f} GiB, params + m + v "
          f"{state_bytes / 2**30:.3f} GiB ({smi})")
    launches = {}
    for grid in plan["grids"]:
        for fault in plan["faults"]:
            got = [r[(grid, fault)] for r in ranks]
            fails = [_mesh_train_failures(g, one) for g in got]
            if fault is not None:
                caught = [sorted({c for c, _ in f if c != "params"})
                          for f in fails]
                print(f"mesh train control {grid}, fault {fault!r} planted:"
                      f" checks failed by rank {caught}; step 1 gradient "
                      f"off by {[(g['grad_err'][0], round(g['grad_err'][1], 5)) for g in got]}"
                      f" of its largest; grad norms by rank "
                      f"{[[round(m['grad_norm'], 5) for m in g['metrics']] for g in got]}"
                      f"; share moved by more than lr / 10 "
                      f"{[round(g['errors'][2], 5) for g in got]}; params "
                      f"{[round(g['errors'][1], 4) for g in got]} of the "
                      f"sanity bound ({smi})")
                expect(all(caught), f"mesh train {grid}: the planted fault "
                       f"{fault!r} passed every check but the sanity bound "
                       f"on a rank: {fails}")
                continue
            for rank, (g, f) in enumerate(zip(got, fails)):
                what = f"mesh train {grid} rank {rank}"
                expect(not f, f"{what}: {[w for _, w in f]}")
                expect(g["launches"] == (0, 0),
                       f"{what}: attention kernels launched {g['launches']}")
            wq_whole = cfg.d_model * cfg.q_dim * cfg.n_layers
            split = grid[0] * grid[1]
            expect(all(g["wq"][0] * split == wq_whole for g in got)
                   and len({g["wq"][1] for g in got}) == split,
                   f"mesh train {grid}: wq blocks {[g['wq'] for g in got]} "
                   f"are not 1/{split} of the leaf each, all different")
            launches[grid] = [g["launches"] for g in got]
            print(f"mesh train {grid}: ms a step by rank "
                  f"{[[round(x, 3) for x in g['ms']] for g in got]}, of "
                  f"which in gloo collectives "
                  f"{[[round(x, 3) for x in g['coll_ms']] for g in got]} "
                  f"({got[0]['coll_calls']:.1f} collectives a step; the "
                  f"last step's share in gloo by rank "
                  f"{[round(g['coll_ms'][-1] / g['ms'][-1], 4) for g in got]}"
                  f"); losses "
                  f"{[round(m['loss'], 5) for m in got[0]['metrics']]}, grad"
                  f" norms "
                  f"{[round(m['grad_norm'], 5) for m in got[0]['metrics']]}"
                  f"; step 1 gradients against one process's: the leaf off "
                  f"most by rank "
                  f"{[(g['grad_err'][0], round(g['grad_err'][1], 5)) for g in got]}"
                  f" of its largest; params against one process's: largest "
                  f"|diff| by rank {[g['errors'][0] for g in got]} "
                  f"({[round(g['errors'][1], 4) for g in got]} of the sanity"
                  f" bound), share moved by more than lr / 10 "
                  f"{[round(g['errors'][2], 5) for g in got]}; wq 1/{split} "
                  f"of the leaf on each rank, {split} different blocks; peak"
                  f" device memory GiB by rank "
                  f"{[round(g['peak'] / 2**30, 3) for g in got]} against one"
                  f" process's {one_peak / 2**30:.3f}; params + m + v GiB by"
                  f" rank {[round(g['state_bytes'] / 2**30, 3) for g in got]}"
                  f" against {state_bytes / 2**30:.3f}; flash_prefill and "
                  f"gqa_decode launches a step by rank "
                  f"{[tuple(x // plan['steps'] for x in g['launches']) for g in got]}"
                  f" ({smi})")
    print(f"phase 10b: {time.perf_counter() - t0:.1f} s (the spawn and the "
          f"ranks' runs {spawn_s:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# 10c. the sharded train step of the moe kind and MLA on (2, 2)
# ---------------------------------------------------------------------------

# mixtral-8x22b (8 experts: each expert's width split over model) and
# minicpm3-4b (MLA's heads split over model) at their published widths,
# depth cut to 1 of 56 and 2 of 62 layers; phase 10b's batch, steps and
# tolerances, grad_accum 1 (mixtral's registered 2 would leave a rank one
# row a microbatch).  ``faults`` maps an arch to the planted faults run
# after its clean run (``--mesh-train-control``)
MESH_TP = dict(runs=(("mixtral-8x22b", 1), ("minicpm3-4b", 2)),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=2, grid=(2, 2),
               faults={}, phase="10c", what="the moe kind and MLA")
# 10d: the recurrent kinds at their published widths, depth cut to one
# period: xlstm-350m's (mlstm, slstm), 2 of 24 layers (4 mLSTM heads of
# 256, 2 a rank; sLSTM whole from its gathered weights, its width 1365
# whole on model), recurrentgemma-2b's (rglru, rglru, attn), 3 of 26 (10
# query heads, 5 a rank; its one KV head of 256 columns split mid-head,
# 128 a rank; RG-LRU's 2560 channels, 1280 a rank); phase 10c's batch,
# steps and checks.  Trap: sLSTM's serial bf16 recurrence sums ``w_h``'s
# gradient over its time steps in bf16, so rounding alone moves it: its
# step-1 gradient sat 0.05 to 0.17 of its largest off one process's on
# (2, 2) and 0.11 to 0.13 on (4, 1), where no tensor parallelism runs, at
# 512 to 2048 tokens alike, and within 1e-5 in f32.  So xlstm-350m runs
# twice: in its bf16, each leaf's gradient held within twice what one
# process's own gradient of it moves when its rows are summed in other
# pieces (``split_spread``), and in f32, every leaf held to the phase's
# 5e-2 (the tight check, and the one the planted fault runs on).  Both on
# 1024 tokens: the serial loop's 2048 steps (about 1.4 s a forward) kept
# the phase past 90 s.  A run is named by its arch and the dtype it sets.
# recurrentgemma-2b runs first: one process's step holds the f32 logits of
# 4 x 2048 x 256000 (7.81 GiB) and their gradient beside 14.5 GiB of
# params, m and v, and behind the xlstm runs' references and freed
# segments it ran out of the card's memory
MESH_REC = dict(MESH_TP, runs=(
    ("recurrentgemma-2b", 3),
    ("xlstm-350m", 2, {"seq": 1024, "spread": True, "why": (
        "sLSTM's 2048 serial steps keep the phase past 90 s")}),
    ("xlstm-350m", 2, {"seq": 1024, "dtype": "float32", "why": (
        "the tight check: in bf16 sLSTM's recurrence turns rounding into "
        "gradients of w_h up to 0.17 of its largest off one process's")})),
    phase="10d", what="the recurrent kinds")
# a bf16 run's gradient limit on a leaf, over what one process's own
# gradient of it moves when the rows are summed in other pieces: the
# ranks' sums differ from one process's in as many roundings as such a
# split, and sum over data in bf16 besides; a fault (a sum left out or
# doubled) moves a leaf by half its largest or more
MESH_SPREAD_FACTOR = 2.0
# the leaf of each arch whose blocks must differ on every rank that splits
# it (an expert leaf on the width route: a quarter on each rank of (2, 2);
# mix/w_x a different half of the columns on each model rank, of the rows
# on each data rank)
MESH_TP_LEAF = {"mixtral-8x22b": "stack_0/b0_moe/moe/wi",
                "minicpm3-4b": "stack_0/b0_attn/attn/wq_b",
                "xlstm-350m": "stack_0/b1_slstm/mix/w_x",
                "recurrentgemma-2b": "stack_0/b0_rglru/mix/w_x"}


@contextlib.contextmanager
def routed(ref=None, rows=None):
    """``moe.route`` watched while the block runs.  Without ``ref``: each
    call's top-k experts kept (on the host), in call order (a layer's
    forward, then its recomputation under remat).  With ``ref`` (those of
    one process) and this rank's ``rows``: call i's experts counted
    against ``ref[i]``'s rows, then replaced by them, with the gates at
    them renormalized as ``route`` does (the same bits where they agree).
    Trap: routing is discrete.  The ranks' bf16 residual differs from one
    process's by the rounding of the row-parallel sums, a near tie of two
    gates flips, and a flipped token's whole expert output changes: its
    gradient is another number, not a rounding of it.  So the phase
    counts the flips, then feeds the ranks one process's routing, and
    holds everything else to the tolerances of phase 10b."""
    from repro_torch.models import moe as MOE
    real = MOE.route
    rec = {"topi": [], "diff": [], "keep": None}

    def route(x, router, cfg):
        gates, topv, topi = real(x, router, cfg)
        if ref is None:
            rec["topi"].append(topi.detach().cpu())
            return gates, topv, topi
        want = ref[len(rec["diff"])][rows].to(topi.device)
        rec["diff"].append((int((topi != want).sum()), topi.numel()))
        if rec["keep"] is None:      # the first call's kept lanes
            with torch.no_grad():    # nothing saved: remat recomputes
                mine = MOE.plan(topi, topv, cfg).keep
                kept = MOE.plan(want, topv, cfg).keep
            rec["keep"] = (int((mine != kept).sum()), mine.numel())
        topv = torch.gather(gates, -1, want)
        return gates, topv / topv.sum(-1, keepdim=True), want
    MOE.route = route
    try:
        yield rec
    finally:
        MOE.route = real


@contextlib.contextmanager
def step_grads(check, replicas):
    """The gradients each train step of the block applies, watched at
    ``adamw.update`` before it runs: ``check(grads)`` on the first step's,
    and every step's sum of squares by leaf, each divided by
    ``replicas[leaf]`` (the ranks holding the same block: summed over the
    ranks, the whole leaf's).  The seconds each step spent here are kept,
    to take out of its time."""
    real = adamw.update
    rec = {"s": [], "out": None, "sumsq": []}

    def update(grads, *a, **k):
        t = time.perf_counter()
        if not rec["sumsq"]:
            rec["out"] = check(grads)
        rec["sumsq"].append({key: float(g.float().square().sum())
                             / replicas.get(key, 1)
                             for key, g in tree_leaves(grads)})
        rec["s"].append(time.perf_counter() - t)
        return real(grads, *a, **k)
    adamw.update = update
    try:
        yield rec
    finally:
        adamw.update = real


def reckoning(cfg, specs, grid) -> dict:
    """The param figures of ``cfg`` from its defs: the whole count, the
    stacked layers' and the rest's, params + m + v bytes whole and on a
    rank of ``grid`` by ``specs``, and a layer's leaves whole on data and
    still split on model (what a rank's gather makes) in bytes."""
    from repro_torch.launch.specs import local_shape
    from repro_torch.models.params import param_defs
    pbytes = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    obytes = torch.finfo(getattr(torch, cfg.opt_dtype)).bits // 8
    flat = dict(tree_leaves(specs))
    per_rank = [0] * (grid[0] * grid[1])
    total = stacked = layer_gather = 0
    for key, pd in tree_leaves(param_defs(cfg)):
        n = int(np.prod(pd.shape, dtype=np.int64))
        total += n
        if key.startswith("stack_"):
            stacked += n
            model = "model" in flat[key]
            layer_gather += n // pd.shape[0] // (grid[1] if model else 1)
        for r in range(len(per_rank)):
            blk = local_shape(pd.shape, flat[key],
                              mesh.ModelMesh(("data", "model"), grid, r))
            per_rank[r] += int(np.prod(blk, dtype=np.int64))
    return dict(params=total, stacked=stacked, other=total - stacked,
                state=total * (pbytes + 2 * obytes),
                rank_state=[n * (pbytes + 2 * obytes) for n in per_rank],
                layer_gather=layer_gather * pbytes)


def _block_errors(got, ref, specs, mm, gmax=None, opt_cfg=None,
                  steps=None):
    """This rank's blocks against the same blocks of one process's whole
    leaves ``ref``.  With ``gmax`` (each leaf's largest |gradient|):
    (leaf, largest |diff| over it) of every leaf, the worst first.  Else
    the params' figures of ``_param_errors``: the largest |diff|, over the
    sanity bound, and the (count moved by more than lr / 10, count)."""
    from repro_torch.launch.specs import local_slices
    flat = dict(tree_leaves(specs))
    worst, diff, ratio, moved, total = [], 0.0, 0.0, 0, 0
    for key, a in tree_leaves(got):
        b = ref[key]
        b = b[local_slices(tuple(b.shape), flat[key], mm)].to(a.device)
        d = (a.float() - b.float()).abs()
        if gmax is not None:
            worst.append((key, float(d.max()) / max(gmax[key], 1e-30)))
            continue
        lr, wd = opt_cfg.lr, opt_cfg.weight_decay
        b = b.float().abs()
        tol = 2 * steps * lr * (1 + wd * b) + steps * 2.0 ** -7 * b
        diff = max(diff, float(d.max()))
        ratio = max(ratio, float((d / tol).max()))
        moved += int((d > lr / 10).sum())
        total += d.numel()
    if gmax is not None:
        return sorted(worst, key=lambda kv: -kv[1])
    return diff, ratio, (moved, total)


def _norm_diffs(got, one) -> list:
    """Per step, the three leaves whose gradient norm (the ranks' blocks
    summed) differs most from one process's (its rerun from the ranks'
    params after step 1), relative, with the sign."""
    out = []
    for k, ref in enumerate(one["sumsq"][:1] +
                            [n["sumsq"] for n in one["next"]]):
        rel = [(key, round(math.sqrt(sum(g["sumsq"][k][key] for g in got)
                                     / max(w, 1e-60)) - 1.0, 5))
               for key, w in ref.items()]
        out.append(sorted(rel, key=lambda kv: -abs(kv[1]))[:3])
    return out


def _copy_out(params, whole, specs, mm) -> None:
    """This rank's blocks of ``params`` written into ``whole`` (each leaf
    whole, one process's tensors mapped here) where ``specs`` places
    them; the ranks holding one block write the same bits."""
    from repro_torch.launch.specs import local_slices
    flat = dict(tree_leaves(specs))
    for key, a in tree_leaves(params):
        w = whole[key]
        w[local_slices(tuple(w.shape), flat[key], mm)] = a.to(w.device)


def mesh_tp_rank(rank, device, plan, refs):
    """A rank of phase 10c: for each run and each of its faults, the
    seed's params cut to this rank's blocks (the whole made once on the
    device and freed; m and v zeros of the blocks' shapes), then
    ``plan["steps"]`` sharded train steps on one process's routing
    (``routed``), the gradients the first applies held to one process's
    (``refs``: its leaves on the card, mapped here, this rank's blocks
    read from them), then the blocks held to one process's params.  After
    each step but the last the clean run copies its blocks out into
    ``refs[name]["after"]`` (the run's name), from which one process
    reruns the next step's loss and gradients."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.meshctx import mesh_context
    from repro_torch.launch.specs import (batch_pspecs, local_rows,
                                          local_shape, make_shard_ctx, put,
                                          split_axes)
    from repro_torch.models.params import param_defs, param_pspecs
    dev = mesh.rank_device(rank, device)
    mm = mesh.make_model_mesh(plan["grid"])
    out = {}
    for run in tp_runs(plan):
        arch, name = run["arch"], run["name"]
        cfg, opt_cfg, batch = mesh_train_setup(run)
        shape = ShapeConfig("train", run["seq"], run["batch"], "train")
        ctx = make_shard_ctx(cfg, shape, mm)
        specs = param_pspecs(cfg, ctx, mesh=mm)
        ref = refs[name]
        with mesh_context(mm):
            rows_of = local_rows(ctx, plan["batch"])
        replicas = {k: mm.world // int(np.prod(
            [mm.shape[a] for a in split_axes(spec, mm)]))
            for k, spec in tree_leaves(specs)}
        # the clean run last: it copies its params out into the buffer of
        # step 1's gradients, which the planted runs read
        for fault in tuple(plan["faults"].get(name, ())) + (None,):
            t0 = time.perf_counter()
            params = put(M.init_params(cfg, SEED, dev), specs, mm)
            state = TS.TrainState(params, adamw.init(params, opt_cfg))
            del params
            rows = put({k: v.to(dev) for k, v in batch.items()},
                       batch_pspecs(cfg, shape, ctx), mm)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            # the model mesh's collectives, the backward's (run on the
            # autograd engine's thread) included
            with mesh_context(mm), planted(fault), \
                    routed(ref["routing"], rows_of) as rt, \
                    step_grads(lambda g: _block_errors(
                        g, ref["grads"], specs, mm, gmax=ref["gmax"]),
                        replicas) as sg, \
                    timed_calls(mesh.ModelMesh, (
                        "all_reduce", "all_gather",
                        "reduce_scatter")) as coll:
                step = TS.make_train_step(cfg, opt_cfg, 1, ctx)
                metrics, ms, coll_ms, launches = [], [], [], (0, 0)
                for k in range(plan["steps"]):
                    state, m1, ms1, coll1, l1 = mesh_train_steps(
                        step, state, rows, 1, dev, coll)
                    metrics += m1
                    ms += ms1
                    coll_ms += coll1
                    launches = tuple(a + b for a, b in zip(launches, l1))
                    if fault is None and k < plan["steps"] - 1:
                        _copy_out(state.params, ref["after"][k], specs, mm)
            ms = [x - 1e3 * t for x, t in zip(ms, sg["s"])]
            r = dict(metrics=metrics, ms=ms, launches=launches,
                     coll_ms=coll_ms, grad_err=sg["out"],
                     sumsq=sg["sumsq"],
                     routing=((rt["diff"] or [(0, 0)])[0],
                              rt["keep"] or (0, 0),
                              [d for d, _ in rt["diff"]]),
                     coll_calls=coll["n"] / plan["steps"],
                     peak=torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0,
                     state_bytes=sum(_tree_bytes(t) for t in (
                         state.params, state.opt.m, state.opt.v)))
            r["errors"] = _block_errors(state.params, ref["params"], specs,
                                        mm, opt_cfg=opt_cfg,
                                        steps=plan["steps"])
            whole = dict(tree_leaves(param_defs(cfg)))
            flat = dict(tree_leaves(specs))
            r["held"] = all(
                tuple(a.shape) == local_shape(whole[k].shape, flat[k], mm)
                for part in (state.params, state.opt.m, state.opt.v)
                for k, a in tree_leaves(part))
            key = MESH_TP_LEAF[arch.removesuffix("-smoke")]
            leaf = dict(tree_leaves(state.params))[key]
            r["leaf"] = (key, leaf.numel(), int(np.prod(
                whole[key].shape, dtype=np.int64)), int(np.prod(
                    [mm.shape[a] for a in split_axes(flat[key], mm)])),
                hashlib.sha1(leaf.view(torch.int16).cpu().numpy()
                             .tobytes()).hexdigest())
            r["parts"] = (t1 - t0, sum(ms) / 1e3,
                          time.perf_counter() - t1 - sum(ms) / 1e3)
            out[(name, fault)] = r
            del state, rows
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def tp_runs(plan) -> list:
    """Each run of a phase 10c or 10d plan as a plan of its own: ``plan``
    with the run's arch, layers and name (the arch, and the dtype its
    third entry sets), and the fields its optional third entry replaces
    ("seq" with the reason "why"; "dtype"; "spread", which holds a bf16
    run's gradients to ``split_spread``)."""
    out = []
    for r in plan["runs"]:
        opts = r[2] if len(r) > 2 else {}
        name = r[0] + (f" {opts['dtype']}" if opts.get("dtype") else "")
        out.append(dict(plan, arch=r[0], layers=r[1], name=name, **opts))
    return out


def split_spread(cfg, params, batch, pieces) -> dict:
    """How far rounding alone moves one process's step-1 gradient: each
    leaf's largest |diff| over its largest |gradient| between the whole
    batch's gradient and the sum of its ``n`` equal pieces' gradients
    (``steps.microbatch``; each piece's weighted by 1 / n, summed in f32),
    the most over each n of ``pieces``.  The ranks of a grid sum their
    rows' gradients in such pieces."""
    from repro_torch.train.steps import microbatch
    _, _, whole = TS.loss_and_grads(cfg, params, batch)
    whole = dict(tree_leaves(whole))
    out = dict.fromkeys(whole, 0.0)
    for n in pieces:
        acc = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for k, g in whole.items()}
        for i in range(n):
            _, _, g = TS.loss_and_grads(cfg, params, microbatch(batch, i, n))
            for k, a in tree_leaves(g):
                acc[k].add_(a.float(), alpha=1.0 / n)
            del g
        for k, g in whole.items():
            d = float((acc[k] - g.float()).abs().max())
            out[k] = max(out[k], d / max(float(g.abs().max()), 1e-30))
        del acc
    return out


def rerun_steps(dev, plan, ref) -> list:
    """Each later step's metrics and gradient sums of squares by leaf, one
    process's, from the params the ranks copied out after the step before
    (``ref["after"]``) on the routing the ranks were fed.  Trap: AdamW's
    first steps divide each gradient by its own magnitude, so the ranks'
    rounding moves some elements by up to lr and step 2 starts from other
    params than one process's step 2: its loss and grad norm are held to
    one process's at the ranks' own params."""
    from repro_torch.models.params import param_defs
    cfg, _, batch = mesh_train_setup(plan)
    batch = {k: v.to(dev) for k, v in batch.items()}
    per = len(ref["routing"]) // plan["steps"]
    out = []
    for k, after in enumerate(ref["after"], 1):
        defs = param_defs(cfg)
        params = tree_unflatten(defs, [after[key].to(dev)
                                       for key, _ in tree_leaves(defs)])
        with routed(ref["routing"][k * per:(k + 1) * per], slice(None)):
            loss, met, grads = TS.loss_and_grads(cfg, params, batch)
        out.append(dict(metrics=dict(
            {n: float(v) for n, v in met.items()}, loss=float(loss),
            grad_norm=float(adamw.global_norm(grads))), sumsq={
                key: float(g.float().square().sum())
                for key, g in tree_leaves(grads)}))
        del params, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_mesh_tp_phase(dev, smi, plan=None):
    """Phase 10c: the sharded train step of the moe kind (width route)
    and MLA on (2, 2), at published width, against one process (phase
    10d: the recurrent kinds, ``MESH_REC``).  A run with a planted fault
    must fail a check besides the params' sanity bound on every rank.
    Returns the ranks' attention kernel launches by run name."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import make_shard_ctx
    from repro_torch.models.params import param_defs, param_pspecs
    plan = plan or MESH_TP
    t0 = time.perf_counter()
    grid = plan["grid"]
    print(f"phase {plan['phase']}: the sharded train step of "
          f"{plan['what']} on "
          f"{grid[0] * grid[1]} gloo ranks sharing one card, grid {grid} "
          f"(data, model): "
          + ", ".join(f"{r['arch']} ({r['layers']} layers, {r['batch']} x "
                      f"{r['seq']} tokens"
                      + (f", {r['dtype']}" if r.get("dtype") else "") + ")"
                      for r in tp_runs(plan))
          + f" at published width, {plan['steps']} steps")
    for r in tp_runs(plan):
        if r["seq"] != plan["seq"] or r.get("dtype"):
            print(f"mesh tp {r['name']}: {r['batch']} x {r['seq']} tokens "
                  f"(the phase's {plan['seq']}), "
                  f"{r.get('dtype') or 'the config dtype'}: {r['why']}")
    refs, one, held = {}, {}, 0
    for run in tp_runs(plan):
        name, layers = run["name"], run["layers"]
        t1 = time.perf_counter()
        cfg, opt_cfg, batch = mesh_train_setup(run)
        shape = ShapeConfig("train", run["seq"], run["batch"], "train")
        grid_mesh = mesh.ModelMesh(("data", "model"), grid)
        rk = reckoning(cfg, param_pspecs(cfg, make_shard_ctx(
            cfg, shape, grid_mesh), mesh=grid_mesh), grid)
        print(f"mesh tp {name}: {rk['params'] / 1e9:.4f}B params "
              f"({rk['stacked'] / 1e9 / layers:.4f}B a layer x {layers}, "
              f"{rk['other'] / 1e9:.4f}B embedding, unembedding and final "
              f"norm), {cfg.param_dtype} params and {cfg.opt_dtype} m and "
              f"v: params + m + v {rk['state'] / 2**30:.3f} GiB, a rank's "
              f"blocks {[round(b / 2**30, 3) for b in rk['rank_state']]} "
              f"GiB; a layer gathered whole on data and split on model "
              f"{rk['layer_gather'] / 2**30:.3f} GiB a rank; remat "
              f"{cfg.remat}")
        # The reference stays on the card: the spawn hands each rank a
        # handle to these tensors (CUDA IPC), whose blocks it reads there.
        # Made first, on an emptied allocator, so that each has segments
        # of its own: a tensor kept in a segment that the steps' freed
        # activations share would keep the whole segment reserved.  The
        # gradients' buffer then takes the params the ranks copy out
        # after step 1 (they have all read step 1's gradients by then:
        # each rank's check runs before the step's grad norm, a
        # collective of the grid)
        defs = [(k, pd.shape) for k, pd in tree_leaves(param_defs(cfg))]
        pdt = getattr(torch, cfg.param_dtype)
        ref = {part: {k: torch.empty(shp, dtype=pdt, device=dev)
                      for k, shp in defs} for part in ("params", "grads")}
        held += 2 * _tree_bytes(ref["params"])
        state = TS.init_train_state(cfg, SEED, opt_cfg, device=dev)
        state_bytes = sum(_tree_bytes(t) for t in (
            state.params, state.opt.m, state.opt.v))
        batch = {k: v.to(dev) for k, v in batch.items()}
        rtol = {}
        if run.get("spread"):
            t = time.perf_counter()
            spread = split_spread(cfg, state.params, batch,
                                  (grid[0], run["batch"]))
            rtol = {k: MESH_SPREAD_FACTOR * e for k, e in spread.items()
                    if MESH_SPREAD_FACTOR * e > MESH_TRAIN_GRAD_RTOL}
            worst = sorted(spread.items(), key=lambda kv: -kv[1])[:3]
            print(f"mesh tp {name} one process against itself: step 1 "
                  f"gradients of the {run['batch']} rows summed in "
                  f"{grid[0]} and in {run['batch']} pieces against the "
                  f"whole batch's, the leaves off most "
                  f"{[(k, round(e, 5)) for k, e in worst]} of their "
                  f"largest; the ranks' limits "
                  f"{MESH_SPREAD_FACTOR} x that where above "
                  f"{MESH_TRAIN_GRAD_RTOL}: "
                  f"{[(k, round(v, 5)) for k, v in rtol.items()]} "
                  f"({time.perf_counter() - t:.1f} s; {smi})")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        sync(dev)
        t2 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def keep(grads):
            for k, g in tree_leaves(grads):
                ref["grads"][k].copy_(g)
            return {k: float(a.abs().max()) for k, a in tree_leaves(grads)}
        with routed() as rt, step_grads(keep, {}) as sg:
            state, metrics, ms, _, launches = mesh_train_steps(
                TS.make_train_step(cfg, opt_cfg), state, batch,
                plan["steps"], dev)
        t3 = time.perf_counter()
        ms = [x - 1e3 * t for x, t in zip(ms, sg["s"])]
        # the step's own peak: the references held on the card taken out
        peak = torch.cuda.max_memory_allocated(dev) - held \
            if dev.type == "cuda" else 0
        expect(launches == (0, 0), f"mesh tp {name} one process: attention "
               f"kernels launched {launches}")
        for k, a in tree_leaves(state.params):
            ref["params"][k].copy_(a)
        after = ([ref["grads"]] + [
            {k: torch.empty_like(a) for k, a in ref["params"].items()}
            for _ in range(plan["steps"] - 2)])[:plan["steps"] - 1]
        refs[name] = dict(params=ref["params"], grads=ref["grads"],
                          gmax=sg["out"], routing=rt["topi"], after=after)
        t4 = time.perf_counter()
        one[name] = dict(metrics=metrics, ms=ms, peak=peak, rtol=rtol,
                         state_bytes=state_bytes, sumsq=sg["sumsq"],
                         s=t4 - t1, parts=(t2 - t1, t3 - t2 - sum(sg["s"]),
                                           t4 - t3 + sum(sg["s"])))
        del state, batch, sg, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # the ranks' allocators grow by extending their segments: 4 ranks'
    # fragments beside the reference (one process's params and gradients:
    # 10.8 GiB for mixtral) would not fit the card
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = mesh.spawn(mesh_tp_rank, grid[0] * grid[1], str(dev), plan,
                           refs)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    spawn_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for run in tp_runs(plan):
        one[run["name"]]["next"] = rerun_steps(dev, run, refs[run["name"]])
    rerun_s = time.perf_counter() - t1
    del refs
    launches = {}
    for run in tp_runs(plan):
        arch, name = run["arch"], run["name"]
        o = one[name]
        print(f"mesh tp {name} one process: ms a step "
              f"{[round(x, 3) for x in o['ms']]}, losses "
              f"{[round(m['loss'], 5) for m in o['metrics']]}, grad norms "
              f"{[round(m['grad_norm'], 5) for m in o['metrics']]}, peak "
              f"device memory {o['peak'] / 2**30:.3f} GiB, params + m + v "
              f"{o['state_bytes'] / 2**30:.3f} GiB ({smi})")
        for fault in (None,) + tuple(plan["faults"].get(name, ())):
            got = [r[(name, fault)] for r in ranks]
            # step 1 against one process's; each later step against one
            # process's rerun from the ranks' params (``rerun_steps``)
            held = o["metrics"][:1] + [n["metrics"] for n in o["next"]]
            # each rank's leaf off most against its limit
            fails = [_mesh_train_failures(
                dict(g, grad_err=max(g["grad_err"], key=lambda kv: kv[1] / (
                    o["rtol"].get(kv[0], MESH_TRAIN_GRAD_RTOL))),
                     errors=(g["errors"][0], g["errors"][1],
                             g["errors"][2][0] / g["errors"][2][1])),
                held, o["rtol"]) for g in got]
            grad_err = [[(k, round(e, 5)) for k, e in g["grad_err"][:3]]
                        for g in got]
            if fault is not None:
                caught = [sorted({c for c, _ in f if c != "params"})
                          for f in fails]
                print(f"mesh train control {name} {grid}, fault {fault!r} "
                      f"planted: checks failed by rank {caught}; step 1 "
                      f"gradients off most by rank {grad_err} of their "
                      f"largest; grad norms by rank "
                      f"{[[round(m['grad_norm'], 5) for m in g['metrics']] for g in got]}"
                      f" ({smi})")
                expect(all(caught), f"mesh tp {name}: the planted fault "
                       f"{fault!r} passed every check but the sanity bound "
                       f"on a rank: {fails}")
                continue
            launches[name] = [g["launches"] for g in got]
            key, _, whole, split, _ = got[0]["leaf"]
            routing = "" if not get_config(arch).n_experts else (
                f"routing of step 1's forward against one process's "
                f"(top-k assignments differing, of; kept lanes differing, "
                f"of) by rank "
                f"{[g['routing'][0] + g['routing'][1] for g in got]}, "
                f"assignments differing in each route call by rank "
                f"{[g['routing'][2] for g in got]}, then one process's "
                f"routing fed to the ranks; ")
            print(f"mesh tp {name} {grid}: ms a step by rank "
                  f"{[[round(x, 3) for x in g['ms']] for g in got]}, of "
                  f"which in gloo collectives "
                  f"{[[round(x, 3) for x in g['coll_ms']] for g in got]} "
                  f"({got[0]['coll_calls']:.1f} collectives a step; the "
                  f"last step's share in gloo by rank "
                  f"{[round(g['coll_ms'][-1] / g['ms'][-1], 4) for g in got]}"
                  f"); {routing}losses "
                  f"{[round(m['loss'], 5) for m in got[0]['metrics']]}, grad"
                  f" norms "
                  f"{[round(m['grad_norm'], 5) for m in got[0]['metrics']]}"
                  f" (one process "
                  f"{[round(m['loss'], 5) for m in o['metrics']]}, "
                  f"{[round(m['grad_norm'], 5) for m in o['metrics']]}; "
                  f"one process's from the ranks' params after each step "
                  f"before the last "
                  f"{[round(n['metrics']['loss'], 5) for n in o['next']]}, "
                  f"{[round(n['metrics']['grad_norm'], 5) for n in o['next']]}"
                  f"); "
                  f"step 1 gradients against one process's, each rank's "
                  f"blocks: the leaves off most by rank {grad_err} of their "
                  f"largest; params against one process's: largest |diff| "
                  f"by rank {[g['errors'][0] for g in got]} "
                  f"({[round(g['errors'][1], 4) for g in got]} of the sanity"
                  f" bound), share moved by more than lr / 10 "
                  f"{[round(g['errors'][2][0] / g['errors'][2][1], 5) for g in got]}"
                  f"; each step's gradient norm by leaf against one "
                  f"process's, the three leaves off most (relative) "
                  f"{_norm_diffs(got, o)}"
                  f"; every leaf of params, m and v the rank's block, {key} "
                  f"1/{split} of the leaf on each rank, {split} different "
                  f"blocks; peak device memory GiB by rank "
                  f"{[round(g['peak'] / 2**30, 3) for g in got]} against one"
                  f" process's {o['peak'] / 2**30:.3f}; params + m + v GiB "
                  f"by rank "
                  f"{[round(g['state_bytes'] / 2**30, 3) for g in got]} "
                  f"against {o['state_bytes'] / 2**30:.3f}; flash_prefill "
                  f"and gqa_decode launches a step by rank "
                  f"{[tuple(x // plan['steps'] for x in g['launches']) for g in got]}"
                  f" ({smi})")
            for rank, (g, f) in enumerate(zip(got, fails)):
                what = f"mesh tp {name} {grid} rank {rank}"
                expect(not f, f"{what}: {[w for _, w in f]}")
                expect(g["launches"] == (0, 0),
                       f"{what}: attention kernels launched {g['launches']}")
                expect(g["held"], f"{what}: a leaf of params, m or v is not "
                       "the rank's block by param_pspecs")
            expect(all(g["leaf"][1] * split == whole for g in got)
                   and len({g["leaf"][4] for g in got}) == split,
                   f"mesh tp {name}: {key} blocks "
                   f"{[g['leaf'][1] for g in got]} are not 1/{split} of "
                   f"the leaf each, {split} different")
    print(f"phase {plan['phase']}: {time.perf_counter() - t0:.1f} s (one "
          f"process "
          + ", ".join(f"{a} {one[a]['s']:.1f} s (set-up {one[a]['parts'][0]:.1f}"
                      f", steps {one[a]["parts"][1]:.1f}, the reference "
                      f"kept {one[a]['parts'][2]:.1f})"
                      for a in one)
          + f"; the spawn and the ranks' runs {spawn_s:.1f} s, rank 0's "
          f"set-up, steps and checks by run "
          + ", ".join(f"{a} {[round(x, 1) for x in ranks[0][(a, None)]['parts']]}"
                      for a in one)
          + f"; the reruns {rerun_s:.1f} s)")
    return launches


def mesh_train_control_main() -> int:
    """``--mesh-train-control``: phase 10b on the (2, 2) grid alone, clean
    and then with each planted fault (``planted``): the clean run passes
    every check, and each fault fails one besides the params' sanity
    bound on every rank."""
    dev = torch.device("cuda")
    smi = environment()
    run_mesh_train_phase(dev, smi, dict(MESH_TRAIN, grids=((2, 2),),
                                        faults=(None, "dp", "model")))
    run_mesh_tp_phase(dev, smi, dict(MESH_TP, runs=MESH_TP["runs"][:1],
                                     faults={"mixtral-8x22b": ("router",)}))
    # recurrentgemma-2b and xlstm-350m's f32 run, the one held to the
    # tight gradient limit
    run_mesh_tp_phase(dev, smi, dict(
        MESH_REC, runs=(MESH_REC["runs"][0], MESH_REC["runs"][2]),
        faults={"xlstm-350m float32": ("mlstm_gates",),
                "recurrentgemma-2b": ("rglru_gate",)}))
    print(smi)
    print(json.dumps({"mesh_train_control": "ok", "card": smi}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--probe-window"]:
        return probe_window_main()
    if sys.argv[1:] == ["--bucket-scan"]:
        return bucket_scan_main()
    if sys.argv[1:] == ["--mesh-train-control"]:
        return mesh_train_control_main()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = environment()

    scan, probe = check_bucket_scan(dev)
    run_card_tests("hash_probe hashed-entry edge card tests", "hashed_probe")
    # the serving registry's shapes (phase 6 drives them)
    reg = serve.REGISTRY_CAPACITY
    nb, w = SetSpec(capacity=reg, mode="soft",
                    backend="bucket").bucket_geometry()
    check_scan(dev, [reg])
    for live in (8, reg):
        check_probe(dev, capacity=reg, key_range=4 * reg, live=live, nb=nb,
                    w=w, batches=[8])
    window, probe_build_ms = check_table_probes(dev)
    print("library_ms: no single PyTorch call computes any of these "
          "functions")

    scan_cuda.launches = probe_cuda.launches = 0
    run_map(dev, "soft", capacity=1 << 21, key_range=1 << 20,
            prefill=1 << 19, n_batches=200, n_after=20, b=1024, chunk=4096,
            label="main path", n_profiled=10)
    launches = {"recovery_scan": scan_cuda.launches,
                "hash_probe": probe_cuda.launches}
    print(f"main-path launches: {launches}")
    expect(all(v > 0 for v in launches.values()),
           "a kernel of the main path was never launched")

    for mode in ("linkfree", "logfree"):
        run_map(dev, mode, capacity=1 << 16, key_range=1 << 15,
                prefill=1 << 14, n_batches=20, n_after=5, b=1024,
                chunk=4096, label=f"{mode} run")
    torch.cuda.empty_cache()

    # the paper's hash experiment (Figure 1, "hash 1M keys") on the probe
    # backend, at its 2^20 key range (PERF.md section 4)
    hp = paper.HASH_1M
    print(f"paper workload {hp.name}: index {hp.index}, {hp.read_pct}% "
          f"reads, at key range 2^20 (the config's {hp.key_range} is cut to "
          f"CPU size), pool 2^21, 1024 lanes")
    scan_cuda.launches = table_probe_cuda.launches = 0
    run_map(dev, "soft", capacity=1 << 21, key_range=1 << 20,
            prefill=1 << 19, n_batches=200, n_after=20, b=1024, chunk=4096,
            label="probe main path", n_profiled=10, backend=hp.index)
    probe_launches = {"recovery_scan": scan_cuda.launches,
                      "table_probe": table_probe_cuda.launches}
    print(f"probe main-path launches: {probe_launches}")
    expect(all(v > 0 for v in probe_launches.values()),
           "a kernel of the probe main path was never launched")
    for mode in ("linkfree", "logfree"):
        run_map(dev, mode, capacity=1 << 16, key_range=1 << 15,
                prefill=1 << 14, n_batches=20, n_after=5, b=1024,
                chunk=4096, label=f"probe {mode} run", backend="probe")
    # the paper's list experiment (Figure 1, list-1024) on the scan
    # backend, as configured
    lc = paper.LIST_LONG
    for mode in ("soft", "linkfree", "logfree"):
        scan_cuda.launches = 0
        run_map(dev, mode, capacity=lc.capacity, key_range=lc.key_range,
                prefill=lc.key_range // 2, n_batches=100, n_after=20,
                b=lc.batch, chunk=lc.key_range,
                label=f"paper {lc.name} {mode}", backend=lc.index)
        expect(scan_cuda.launches > 0, "the scan backend's recovery did not "
               "launch recovery_scan")
    torch.cuda.empty_cache()

    # 3b. snapshot + delta-log hybrid recovery: recovery_scan at the padded
    # delta lengths, then the hash-1M bucket map through the Snapshotter
    check_scan(dev, [8, 64, 4096, 1 << 16])
    _, hybrid_launches = run_hybrid(
        dev, "hybrid hash-1M", capacity=1 << 21, key_range=1 << 20,
        prefill=1 << 19, n_batches=200, n_after=20, b=1024, chunk=4096)
    expect(all(v > 0 for v in hybrid_launches.values()),
           "a kernel of the hybrid path was never launched")
    large, _ = run_hybrid(
        dev, "hybrid hash-1M large delta", capacity=1 << 21,
        key_range=1 << 20, prefill=1 << 19, n_batches=200, n_after=20,
        b=1024, chunk=4096, snapshot_first=True)
    spec = SetSpec(capacity=1 << 21, backend="bucket")
    nb, w = spec.bucket_geometry()
    d = large["padded"]
    expect(2 * d * w + spec.stash_size + d >= spec.capacity,
           "the large delta did not reach the whole-pool candidate bound")
    run_hybrid(dev, f"hybrid {lc.name}", capacity=lc.capacity,
               key_range=lc.key_range, prefill=lc.key_range // 2,
               n_batches=100, n_after=20, b=lc.batch, chunk=lc.key_range,
               backend=lc.index)
    check_serve_snapshots(dev)
    torch.cuda.empty_cache()

    # 3c. the sharded map: 8 shards at the hash-1M geometry
    sharded = run_sharded_phase(dev)
    torch.cuda.empty_cache()

    # 3c2. the same map over 4 processes sharing the card
    meshed = run_mesh_phase(dev, smi)
    torch.cuda.empty_cache()

    # 3d. the durable queue and the serve spine at smoke size
    queue = run_queue_phase(dev)
    torch.cuda.empty_cache()

    # 3e. online resize at the hash-1M geometry
    resize = run_resize_phase(dev)
    torch.cuda.empty_cache()

    # 3e2. online resize over 4 processes sharing the card
    mesh_resized = run_mesh_resize_phase(dev, smi)
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    attn = check_attention_kernels(dev)
    torch.cuda.empty_cache()
    check_decode_matches_prefill(dev)
    torch.cuda.empty_cache()
    # 5b. decode over a sequence-sharded cache on 4 ranks
    mesh_decoded = run_mesh_decode_phase(dev, smi)
    torch.cuda.empty_cache()
    serving, params = run_serving(dev)
    for name in ("recovery_scan", "table_probe"):
        print(f"{name}: {serving[name]} launches on the serving path "
              f"(registry inserts, contains and recovery)")
    torch.cuda.empty_cache()
    # each result holds the weights too: keep only the launches
    spine = run_serving_spine(dev, params)[0]
    torch.cuda.empty_cache()
    waves = run_serving_spine(dev, params, shards=N_SHARDS, pipeline=2)[0]
    del params
    torch.cuda.empty_cache()

    # 7. the open-loop serving harness at bench_serve's default geometry
    open_loop = run_open_loop_phase(dev, smi)
    torch.cuda.empty_cache()

    # 8. the model families at their published widths
    families, family_shapes = run_families_phase(dev, smi)
    torch.cuda.empty_cache()

    # 9. the vlm and audio front ends at their published widths
    frontends, frontend_shapes, position_edges = run_frontends_phase(dev, smi)
    torch.cuda.empty_cache()

    # 10. training at h2o-danube-3-4b's full width and depth
    training, train_launches = run_training_phase(dev, smi)
    torch.cuda.empty_cache()

    # 10b. the sharded train step on 4 ranks sharing the card
    run_mesh_train_phase(dev, smi)
    torch.cuda.empty_cache()

    # 10c. the same for the moe kind and MLA at published width
    run_mesh_tp_phase(dev, smi)
    torch.cuda.empty_cache()

    # 10d. the same for the recurrent kinds at published width
    run_mesh_tp_phase(dev, smi, MESH_REC)

    record = {"kernels": [
        {"name": "recovery_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/recovery_scan.cu",
         "replaces": "src/repro/kernels/recovery_scan/kernel.py:42",
         "launches": launches["recovery_scan"], **scan,
         "bound_by": "bytes", "library_ms": None,
         "launches_hybrid": hybrid_launches["recovery_scan"],
         "launches_sharded": sharded["recovery_scan"],
         "launches_mesh": {b: [r["recovery_scan"] for r in meshed[b]]
                           for b in meshed},
         "shard_shape": sharded["shapes"]["recovery_scan"],
         "launches_queue": queue["recovery_scan"],
         "launches_resize": resize["recovery_scan"],
         "launches_mesh_resize": {
             b: [r["recovery_scan"] for r in mesh_resized[b]]
             for b in mesh_resized},
         "launches_serving_spine": {"one_wave": spine["recovery_scan"],
                                    "waves": waves["recovery_scan"]},
         "launches_open_loop": open_loop["recovery_scan"],
         "launches_families": {a: n["recovery_scan"]
                               for a, n in families.items()},
         "launches_frontends": {
             VLM_ARCH: frontends[VLM_ARCH]["serve"]["recovery_scan"]},
         "queue_shape": queue["shapes"]},
        {"name": "hash_probe", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_probe.cu",
         "replaces": "src/repro/kernels/hash_probe/kernel.py:64",
         "launches": launches["hash_probe"], **probe,
         "bound_by": "bytes", "library_ms": None,
         "launches_hybrid": hybrid_launches["hash_probe"],
         "launches_sharded": sharded["hash_probe"],
         "launches_mesh": [r["hash_probe"] for r in meshed["bucket"]],
         "shard_shape": sharded["shapes"]["hash_probe"],
         "launches_queue": queue["hash_probe"],
         "launches_resize": resize["hash_probe"],
         "launches_mesh_resize": [r["hash_probe"]
                                  for r in mesh_resized["bucket"]],
         "launches_open_loop": open_loop["hash_probe"],
         # the second route of probe_pallas (the probe backend's
         # table_lookup), the entry table_probe of the same source
         "probe_window": {
             "entry": "table_probe",
             "replaces": "src/repro/kernels/hash_probe/ops.py:157",
             "launches": probe_launches["table_probe"],
             "launches_serving": serving["table_probe"],
             "launches_sharded": sharded["table_probe"],
             "launches_mesh": [r["table_probe"] for r in meshed["probe"]],
             "launches_queue": queue["table_probe"],
             "launches_resize": resize["table_probe"],
             "launches_mesh_resize": [r["table_probe"]
                                      for r in mesh_resized["probe"]],
             "launches_serving_spine": {"one_wave": spine["table_probe"],
                                        "waves": waves["table_probe"]},
             "launches_open_loop": open_loop["table_probe"],
             "launches_families": {a: n["table_probe"]
                                   for a, n in families.items()},
             "launches_frontends": {
                 VLM_ARCH: frontends[VLM_ARCH]["serve"]["table_probe"]},
             "shard_shape": sharded["shapes"]["table_probe"], **window,
             "bound_by": "bytes", "library_ms": None,
             "table_build_ms_2e21": probe_build_ms}},
        {"name": "gqa_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
         "replaces": "src/repro/kernels/gqa_decode/kernel.py:62",
         "launches": serving["gqa_decode"], **attn["gqa_decode"],
         "launches_serving_spine": {"one_wave": spine["gqa_decode"],
                                    "waves": waves["gqa_decode"]},
         "launches_families": {a: n["gqa_decode"]
                               for a, n in families.items()},
         "family_shapes": {a: r["decode"] for a, r in family_shapes.items()
                           if "decode" in r},
         "launches_frontends": {
             VLM_ARCH: {"serve": frontends[VLM_ARCH]["serve"]["gqa_decode"],
                        "embeds": frontends[VLM_ARCH]["embeds"]["decode"][
                            "gqa_decode"]},
             AUDIO_ARCH: frontends[AUDIO_ARCH]["decode"]["gqa_decode"]},
         "frontend_shapes": {k: r for k, r in frontend_shapes.items()
                             if k.endswith("_decode")},
         "launches_training": train_launches["gqa_decode"],
         # the sequence-sharded decode attends in PyTorch on every rank
         "launches_mesh_decode": {
             f"{a} {g}": [n["decode"][1] for n in v]
             for (a, g), v in mesh_decoded.items()}},
        {"name": "flash_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
         "replaces": "src/repro/kernels/flash_prefill/kernel.py:81",
         "launches": serving["flash_prefill"], **attn["flash_prefill"],
         "launches_serving_spine": {"one_wave": spine["flash_prefill"],
                                    "waves": waves["flash_prefill"]},
         "launches_families": {a: n["flash_prefill"]
                               for a, n in families.items()},
         "family_shapes": {a: r["prefill"]
                           for a, r in family_shapes.items()},
         "launches_frontends": {
             VLM_ARCH: {
                 "serve": frontends[VLM_ARCH]["serve"]["flash_prefill"],
                 "embeds": frontends[VLM_ARCH]["embeds"]["prefill"][
                     "flash_prefill"]},
             AUDIO_ARCH: frontends[AUDIO_ARCH]["prefill"]["flash_prefill"]},
         "frontend_shapes": {k: r for k, r in frontend_shapes.items()
                             if not k.endswith("_decode")},
         "position_edge_shapes": position_edges,
         "launches_training": train_launches["flash_prefill"],
         "launches_mesh_decode": {
             f"{a} {g}": [n["prefill"][0] for n in v]
             for (a, g), v in mesh_decoded.items()}},
    ]}
    print("training " + json.dumps({"arch": TRAIN_ARCH, "card": smi,
                                    **training}))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
