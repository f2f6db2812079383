#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 42] [--shards 477] [--procs-only]

The data has the shapes of a 1B-column index, 954 shards of 2^20
columns (``FULL_SHARDS``).  By default the run serves 477 of them (5.0e8
columns), printed as a CUT line: at 954 shards the run took 935 s of its
1200 s limit on one card machine and ran past it on another: most of
the run is host work (numpy, file reads and writes), whose speed varies
between card machines.
Sizes below that scale with the shards are quoted at 954 shards and
halve at the default (f's plane 2.0 GB, amount's 1.4 GB, the time plane
8.0 GB).

Eighteen numbered phases and phases mesh and procs between 2 and 3; any
failure raises and the exit code is non-zero:

1. Build the hand kernels of ``pilosa_tpu_torch/engine/csrc`` with nvcc
   (printing ptxas register and shared-memory use), hold each against
   its plain PyTorch version on the card, bit for bit, at the main-path
   shapes and at ragged ones (``row_counts`` also at the BSI shapes: the
   [954, 22, 32768] bit plane with a filter and a [2048, 22, 1] overlay
   mini plane), and time both with CUDA events; then hold each again at
   the ragged and main-path shapes on every other visible card, and
   print the max abs error per card.
2. Serve the index (954 shards x 32 rows x 32768 words, ~25%
   dense, generated from --seed) written as real fragment snapshots:
   fresh Holder -> Executor (its defaults: the adaptive cross-request
   batcher, whole-tree compilation, the plan cache) -> API, in process
   and over REST, every answer checked against a numpy oracle, with the
   kernels' launch counters reset before and read after; these
   sequential requests must take the batcher's solo fast lane.  A
   ``Set`` then reads that must show it: absorbed into the plane's delta
   overlay, no rebuild.
   Phase mesh, on a holder of its own of that index's first 239 shards
   (a CUT, hard-linked snapshots): an executor over
   ``MeshPlacement([cuda:(i % n) for i in range(4)])`` with ``n`` the
   visible cards up to four (``f``, ``g`` and ``amount`` in four shard
   blocks over those cards, four blocks of the one card on a one-card
   machine, padded to a multiple of four, each block launching on its
   own stream; the cards, each block's device and the peer access
   between the cards are logged) behind its own REST server,
   beside an unmeshed executor of its own: the per-shard oracle's
   requests (the 32-Count, the 4-Count, the TopNs, the compound Counts)
   and fourteen more (the tree Counts, six BSI requests, Xor,
   Difference, tanimoto TopN, Min over an empty filter, filtered Max,
   two GroupBys) equal through both, two Row reads equal word for word,
   a Set and a value written and cleared (absorbed, no rebuild), an
   8-thread burst whose windows hold more than one item, ``/status``'s
   ``mesh`` block, and ``parallel.spmd``'s two intersect counts of f row
   1 and g row 0 against the oracle; then phase 7's ten time-range
   requests over all of ``events`` in four blocks against its oracle,
   a ``Limit`` window from the third block as a Count, a bitmap and an
   Extract, and a 2x2 ``MeshPlacement2D`` over the same devices'
   Min/Max, GroupBy Max, a Shift across word blocks and that Limit, as
   the unmeshed executor answers; every kernel must launch on this path
   and every card must launch (launch counters reset first; the launches
   per card logged); device ms per card per request meshed beside
   unmeshed, with the copies' ms per card; peak device memory per card;
   with several cards, a server booted with ``mesh = true`` spans every
   card by ``/status`` and answers the phase's requests exactly; every
   executor closed after its part (device memory before and after).
   Phase procs, on the same 239 shards padded to 240: with two or more
   cards two processes of one NCCL group, each with its own
   ``CUDA_VISIBLE_DEVICES`` (the two halves of the first four cards),
   one process (a world of 1, a CUT line) on a one-card machine.  Each
   is a server booted with ``jax_coordinator`` / ``jax_num_processes``
   / ``jax_process_id``, ``mesh = false`` and ``cluster_enabled``, holds
   hard links to its own contiguous shard range of ``f``, ``g`` and
   ``amount`` only, reads its rows through an executor's planes, and
   runs every ``parallel.spmd`` program over a ``ProcessPlacement`` of
   four blocks in all (f row 1 & g row 0 in 1-D, psum and 2-D, the union,
   the g-filtered TopN of f, amount's bit counts, an ingest step and the
   count after it), traces three of them (the NCCL entries' device ms
   beside the per-block kernels'), asks its own executor two Counts and
   joins the HTTP cluster over the group (shard-routed Sets through
   process 0, ``Count(Row(f=1))`` = 4 through each node, an exit
   barrier).  Every child must exit 0 with answers equal to each other's
   and the per-shard oracle's, and launch ``intersect_count``,
   ``row_counts`` and ``count``; the kernels line gets path ``procs``
   (the children's launches summed) and their launches per card.
3. Concurrent serving on the same index, its overlay folded first (a
   clean plane): 32 client threads, 6 passes
   each over a mix of the 32-Count, the 4-Count, a filtered TopN and a
   request of three compound Counts, every answer checked; first through
   the default executor, then through
   ``Executor(count_batch_window="off", tree_fusion=False)`` sharing its
   plane cache.  Prints, per configuration, requests/s and Count
   queries/s, p50/p90/p99 latency per request kind, the batcher's windows,
   items per window and fast-lane hits, launches per request, the device
   busy share of one burst under ``torch.profiler`` and peak device
   memory; and the device time of the compound Counts' plain PyTorch
   fold beside the ``count`` kernel's, solo and in one window.  The
   three path kernels must launch and windows must coalesce.
4. Ingest while serving, on the same holder: twelve REST ``/import``
   batches of 4096 (row, column) pairs (ten sets, two clears of bits the
   sets wrote), each followed by a 32-Count, a 4-Count and a filtered
   TopN checked against the oracle, over the unchanged resident plane
   plus its overlay; after the first batch one concurrent burst runs
   over the live overlay.  The background compactor folds the overlay
   at a quarter fill.  Then one 100,000-pair batch, past what the
   overlay and a fold cover: the next 32-Count rebuilds the plane.
   Launch counters are reset before and read after this phase too.
5. BSI, on the same holder and index: an int field ``amount`` (min
   -1,000,000, max 1,000,000: base 0, bit depth 20) with about half the
   1.0e9 columns holding a value, written as 954 fragment snapshots (a
   2.75 GB bit plane on the card).  Ten requests (Sum, filtered Sum, Min,
   filtered Max, two range Counts, a compound Count with a BSI leaf, a
   TopN with a BSI filter, Percentile, Distinct) through the default
   executor, each on the fast lane, then through the "off" one, every
   answer checked against the numpy oracle; each request's device ms
   under the profiler beside its bound (one read of the plane, two for
   Sum); a concurrent burst of 32 clients x 6 passes over Sum, filtered
   Sum, Min, filtered Max and the two range Counts, whose ``sum``,
   ``minmax`` and ``bsirange`` windows must coalesce; then six REST
   ``importValue`` batches of 1024 values (half overwriting, half into
   empty columns), each followed by Sum, Min, Max and a range Count,
   absorbed into the BSI overlay with no rebuild and folded at a quarter
   fill, and one 50,000-value batch whose next read rebuilds.
6. GroupBy, on the same holder after phase 5: five requests (the
   reference benches' 4x4 of ``f`` rows, ``g`` x ``f``, Sum of ``amount``
   by ``f`` row, Max of ``amount`` by ``g`` row filtered by ``f`` row 1,
   and ``g`` x ``f`` with ``having=``, ``limit=`` and ``previous=``)
   through the default executor (fast lane) and the "off" one, every
   answer checked against a numpy oracle; each request's device ms beside
   one read of the planes it needs; a burst of 32 clients x 4 passes over
   the first four whose ``groupby`` windows must coalesce and dedupe; a
   4096-pair REST ``/import`` into ``f`` (rows planes refresh from the
   journals, no rebuild) and a 1024-value ``importValue`` (Sum over the
   BSI overlay), each followed by requests checked against the updated
   oracle.  Launch counters are reset at the start and read at the end.
7. Time views, on the same holder: index ``events``, a time field ``ev``
   (quantum YMD, rows 0-3, a day bucket for each of the 28 days of
   February 2021, each (row, column, day) bit set with probability 1/64),
   written as 31 views x 954 fragment snapshots with a numpy oracle; its
   time plane is int32[954, 128, 32768] (16.0 GB).  Ten requests
   (recency, a retention intersection, four sliding windows, the whole
   month, time-filtered ``Rows`` and GroupBy, ``Shift``, ``Limit``,
   ``ConstRow``, a TopN filtered by a time range) through the default
   executor and the "off" one, requests 1-4 again through an executor
   whose 8 GiB budget the plane exceeds (the span path: each executor's
   counters must show the path it should have taken), each request's
   device ms beside one read of its lanes, a burst of 32 clients x 4
   passes, a 4096-pair timestamped ``/import`` into existing buckets
   (absorbed, no build) and one stamped 2021-03-01 (a new bucket: the
   plane rebuilds), each followed by requests checked against the
   oracle.  Launch counters are reset at the start and read at the end.
8. Mutex and bool fields and the rest of the unkeyed PQL surface, on the
   ``bench`` index: a mutex field ``m`` (16 rows, each column in one row
   with probability 15/16: an int32[954, 16, 32768] plane, 2.00 GB) and a
   bool field ``b`` (true for about half the columns, false for a
   quarter), written as 2 x 954 fragment snapshots with a numpy oracle.
   Eight requests (a Count per mutex row, two selected rows, m x b x f,
   a TopN filtered by ``b``, GroupBy m x b, ``Extract`` of f, m, b and
   ``amount`` over the first 1000 columns of f row 0, ``IncludesColumn``
   and ``Options(shards=)`` / ``Options(excludeColumns=)``) through the
   default executor (fast lane) and the "off" one, every answer checked;
   the device ms of requests 1, 5 and 6 beside one read of the planes
   each needs; a REST ``/import`` that moves 4096 columns to other
   mutex rows (absorbed into the overlay, no build), a bool ``Set``, a
   ``Store`` into a new row of f (the plane rebuilds) and its
   ``ClearRow`` (a fold), each followed by checked reads, with their
   latencies beside phase 4's import.  Launch counters are reset at the
   start and read at the end.
9. Keys and attributes: (a) a keyed set field ``seg`` on ``bench`` whose
   31 row keys ``seg-01`` .. ``seg-31`` (ids 1-31) hold f's rows 1-31,
   written as 954 fragment snapshots and a key store (an
   int32[954, 32, 32768] plane, 4.0 GB): keyed Counts, a keyed Count x g,
   a filtered keyed TopN, ``Rows(like=)``, a keyed GroupBy and an unknown
   key through the default executor (fast lane) and the "off" one, then
   ``SetRowAttrs``, a row result's ``rowAttrs`` (and
   ``excludeRowAttrs=``) and TopN ``attrName=``; each device request's
   device ms beside one read of what it needs; a burst of 32 clients x 4
   passes before the phase's profiles and one after them.
   (b) ``bench/config15_keyed.py``'s end-to-end shape, not cut: keyed
   index ``k`` with 1,000,000 column keys and 10,000 row keys imported
   over REST ``/import`` in 10 batches of 100,000 pairs (an
   int32[1, 16384, 32768] plane), a keyed Count, TopN (10,000 tied rows),
   ``Rows(like=)``, Extract and IncludesColumn through both
   configurations with their device ms, a keyed ``Set`` creating a
   column key and a row key, ``SetColumnAttrs`` and
   ``Options(columnAttrs=)``, and a 100,000-value keyed ``importValue``
   followed by a Sum.  The phase must launch ``count``, ``row_counts``
   and ``selected_row_counts``.  Launch counters are reset at the start
   and read at the end.
10. Fields past the plane budget, on ``bench``: (a)
   ``bench/config10_product_families.py``'s sparse field, not cut: ``tags``,
   20,000,000 (row, column) draws over 5,000,000 rows and every column,
   deduplicated, written as 954 fragment snapshots (its dense plane would
   be ~1.05 PB; its CSR residency is ~302 MB).  ``TopN(tags, Row(f=0),
   n=5)`` (the sparse top-k on the card), ``TopN(tags, n=5)`` (host row
   cardinalities, no launch) and a tanimoto TopN filtered by a tags row
   (sparse full counts) through the default executor and the "off" one,
   checked against a numpy oracle, with the first request's time (it
   builds the residency) and the sparse counts' device ms beside one read
   of the CSR arrays and the gathered filter words.  (b) ``f`` through
   two executors (default and "off") with a 2 GiB budget: the 32-Count and
   the 4-Count in 64 MiB pages, ``TopN(f, Row(g=0), n=5)``, a tanimoto TopN
   whose threshold keeps half the rows and its ``_rowCounts=1`` form
   streamed in row blocks; then a 32-Count under a 128 MiB tenant byte
   quota (two pages leased, the rest from the host's row cardinalities).
   (c) Serve-while-build: a fresh executor answers a filtered TopN by
   streaming while f's 4.0 GB plane builds on a thread, then over the
   plane.  (d) A tenant slot quota of 1 behind the REST server, 8 clients
   x 4 Counts: sheds answer 503 with ``Retry-After`` and a
   ``tenantThrottled`` body, ``/status`` counts them.  The phase must
   launch ``row_counts``, ``count`` and ``selected_row_counts``.  Launch
   counters are reset at the start and read at the end.
11. Robustness, protobuf bodies and the ``distinct`` kind, on ``bench``
   as phase 10 leaves it: (a) the 32-Count, the 4-Count and a filtered
   TopN as protobuf ``/query`` beside JSON, a 4096-pair protobuf
   ``/import`` into ``f`` carrying ``X-Pilosa-Op-Id`` (absorbed, no
   build), a 1024-value protobuf ``importValue`` into ``amount`` and a
   Sum, and Extract asked for in protobuf (its protobuf 400); (b) 32
   clients x 2 passes of ``Distinct(field=amount)`` and a filtered
   Distinct, whose identical items must share presence scans; (c)
   ``?timeout=`` 504s on a double Percentile (at the call boundary) and a
   GroupBy Max (in a batcher stage) through an executor without the fast
   lane, and a Count burst where half the clients carry a 1 ms deadline:
   the others answer exactly and no slot stays taken; (d) a watchdog
   bound below the GroupBy Max window's device time: the 500
   ``pipelineStall`` body, ``deviceHealth`` degraded, requests served one
   at a time through the hand kernels with the fast lane off, the bound
   restored and one probe window back to healthy, the live threads back
   to their count; (e) a fresh executor with ``f`` and ``amount``
   resident, a ballast sized from ``torch.cuda.mem_get_info()`` so that
   ``m``'s 2.00 GB plane cannot fit: the 16-Count over ``m`` raises a
   real ``torch.cuda.OutOfMemoryError``, stage 1 evicts the unleased
   planes and the retry answers exactly.  Every answer is checked against
   the numpy oracle; the phase must launch ``count``, ``row_counts`` and
   ``selected_row_counts``.  Launch counters are reset at the start and
   read at the end.
12. The host storage path, on ``bench`` as phase 11 leaves it: (a)
   2,048 single-pair REST imports into shard 0 of ``f`` push its op-log
   past ``MAX_OP_N``; the holder's ``SnapshotQueue`` compacts it off the
   write path (its seconds, the import p50/p99 before and while it runs,
   the op-log bytes before and after, an exact 32-Count).  (b) The
   builder pool: a fresh executor builds ``f``'s 4.0 GB plane through the
   32-Count with no ``.dense`` images on disk (cold: build seconds, warm
   hits and misses summing to the shards, the image bytes the writer
   thread wrote and its seconds), then again after an eviction (warm:
   every fragment a hit), the two planes ``torch.equal`` on the card; the
   same for ``amount``'s 2.75 GB plane through Sum.  (c) Phase 10 (b)'s
   2 GiB-budget 32-Count and 4-Count in 64 MiB pages and the filtered
   TopN streamed, over warm images, beside phase 10's times.  (d) A
   cProfile of a sample of fragment opens; a fresh executor whose first
   32-Count builds ``f`` all warm; then, with ``f``'s and ``m``'s op-logs
   fsyncing as ``Holder(fsync=True)`` makes them, a 4096-pair ``/import``
   into ``f`` and 4096 mutex moves into ``m``, each with its latency, the
   fsyncs ``SyncBatch`` issued (one per touched op-log) and the records
   appended; reads after each exact.  The crash restart (reopening the
   unclosed directory) runs in ``tests/test_torch_gpu.py`` at 32 shards:
   beside the serving process (~62 GB) a second opened tree of this size
   passes the card machine's 96 GiB.
   (e) One inline compaction each of an ``f`` and an ``amount``
   fragment, and the close reckoned from them and the dirty op-logs on
   disk (not run).  (f) The native codec against the numpy one on this
   host at ``f``'s and an events day view's fragment shapes (serialize,
   decode, expand; bytes and bits checked equal).  The images' bytes on
   disk and the free disk at the end.  The phase must launch ``count``, ``row_counts`` and
   ``selected_row_counts``; launch counters are reset at the start and
   read at the end.  Phases 2-11 run with ``plane_sidecars=False``
   (``_executor``): a card machine takes about 45 GiB of disk writes per
   call, and at the reference's default their builds would write ~60 GB
   of images.
13. The single-node API, the HTTP client and the CLI, on the holder
   and REST server phase 12 leaves serving, through the port's
   ``api.client.Client``: (a) ``/info``, ``/version`` and the schema
   routes against the entries the run expects; ``/export`` of ``k``'s
   keyed set field (about 1M lines) and keyed BSI field against phase 9's
   oracle, with their seconds and bytes; ``DELETE /index/k`` (``/status``
   plane bytes and ``torch.cuda.memory_allocated()`` drop by k's resident
   bytes, the directory and key stores are gone, a query answers 404;
   ``k`` recreated keyed, 100,000 keyed pairs imported, ids from 1, a
   keyed Count exact); ``DELETE /index/bench/field/seg`` (every plane of
   ``bench`` leaves the cache, the next 32-Count rebuilds ``f`` exact,
   ``seg`` recreated answers 0).  (b) A second process: ``python -m
   pilosa_tpu_torch.cli server --config <toml>`` (a free port, a fresh
   data directory, a 1 GiB plane budget, ``fsync = true``) on the card;
   ``cli import --create`` of 1,000,000 pairs from --seed (16 rows over
   the first 64 shards); the 16-Count, ``TopN(f, n=5)`` and a compound
   Count through the client against a numpy oracle; ``cli export``
   byte for byte against the oracle's CSV; SIGTERM (exit 0 within 30 s);
   ``cli check`` ("all fragments ok") and ``cli config``.  The phase must
   launch ``count``, ``row_counts`` and ``selected_row_counts`` in this
   process (the second process's launches are not counted; its answers
   are checked).  gRPC and TLS are not driven: the card machine has no
   grpcio, and nothing there may be relied on to make certificates.
14. Observability and storage integrity, on ``bench`` as phase 13
   leaves it, through an executor with a metrics registry
   (``pilosa_tpu_torch.obs.Stats``) sharing the plane cache, behind its
   own REST server, with the reference's 1% trace sample and 1 s slow
   log: (a) a burst of 32 clients x 3 passes of phase 2's mix (the
   32-Count, the 4-Count, the filtered TopN and a compound Count), its
   requests/s beside phase 3's (no registry), then a ``/metrics``
   scrape: every expected family present, ``kernel_dispatch_seconds``
   counts by kind equal to the batcher's groups,
   ``kernel_bytes_scanned_total`` equal to the cost ledger's bytes, the
   window and item counters equal to the batcher's, and every value the
   ``kernel_bandwidth_gbps`` gauge took in (0, 3350] GB/s; (b)
   ``?profile`` on sequential requests (the 32-Count, a compound Count,
   the filtered TopN, a GroupBy): each request's kernels timed with CUDA
   events (``cuda_kernels.EVENTS``) <= its root's ledger
   ``deviceSeconds`` <= its wall; (c) a burst over ``bench`` and ``k``:
   every window's apportioned shares sum exactly to its seconds and the
   tenants' seconds to the ledger's total, then a
   ``tenant_device_seconds_quota`` below ``k``'s recent seconds sheds it
   with a 503 ``tenantThrottled{kind: device-seconds}``; (d) a 50 ms
   watchdog on a windowed GroupBy Max queued behind a ~0.2 s device
   sleep, after one windowed run of it: a 500, the ``/debug/flight``
   ring holding the run-up (enqueue, dispatch, readback) and the trip
   (watchdog_trip, quarantine, incident, governor), an incident file under
   ``_flight``, a probe back to healthy; (e) one byte of one ``f``
   snapshot flipped in place (after an inline compaction of that
   fragment): the scrubber at 1 GiB/s over ``f``'s last 32 fragments (a
   cut: all 477 took 14.9 s at the card machine's disk speed)
   quarantines it, the next 32-Count equals the oracle with that shard's rows empty,
   a write to the shard answers 503 ``storageFault``, and ``cli check``
   of a copy of the fragment prints BAD; (f) last (a profiler session
   slows what follows it), ``POST /debug/profile?seconds=1`` while
   requests run: its Chrome trace names every hand kernel launched
   meanwhile.  The phase must launch ``count``, ``row_counts`` and
   ``selected_row_counts``; launch counters are reset at the start and
   read at the end.
15. The cluster: three nodes in this process with ``replicas = 2`` (the
   layout of ``bench/config22_availability.py``), each its own executor
   on the card with a 4 GiB plane budget, the periodic anti-entropy off.
   (b) ``f``'s and ``g``'s snapshot blobs as data generation wrote them
   (kept as hard links: later phases replace those files), over the first
   64 shards (a CUT line: 128 before phase 16 shared the cluster's
   time), to any node by ``/import-roaring``, each
   routed to both owners (its seconds and bytes; every owner holds each
   shard's bits, no other node does).  (a) The 32-Count, the 4-Count, a
   compound Count, the filtered TopN and a GroupBy g x f asked of every
   node, a
   keyed Count after keys created through a non-coordinator replicate to
   every node, all against the numpy oracle; the sequential p50 and a
   32-client burst through one node beside phases 2 and 3; the path
   kernels must launch.  (b) A PQL ``Set`` / ``Clear`` and a 4096-pair
   ``/import`` sent through the node that does not own shard 0, read back
   from each replica's holder.  (c) One node closed while a reader
   thread asks the 32-Count through the coordinator: no read fails;
   Sets to its shards are hinted; it reopens, the hints replay (seconds
   to converge); one diverged fragment is repaired by an AAE round
   triggered over it alone; a quarantined fragment is rebuilt from its
   replica through ``repair_quarantined``.  (d) ``/metrics/cluster`` and
   ``/status/cluster`` with three nodes up; the placement loaded is the
   placement at the end (no resize moved it).  The one diverged fragment
   is repaired by ``Cluster.sync_once`` scoped to it (the REST route runs
   a full round, as the reference's).
16. Backup and restore, on phase 15's live cluster before its nodes
   close: (a) an online backup of ``cb`` (``BackupDriver``, 8 workers)
   while a thread writes ``Set``s through a node that does not own their
   four shards (fragments, bytes, seconds, MB/s, replica fallbacks), then a
   quiesced incremental pass; (b) ``Set``s to three known shards, then
   an incremental pass that must transfer exactly their fragments and
   skip the rest; (c) an elastic restore (``RestoreDriver``) into a
   fresh 2-node cluster with ``replicas = 1`` on the card, each node its
   own executor and a 4 GiB plane budget: every node's 32-Count, 4-Count,
   filtered TopN, compound (tree) Count, keyed Count and the written
   row's Count equal the oracle plus the acked writes (the restore's
   seconds and MB/s, each node's first 32-Count); launch counters reset
   before these reads and read after (path ``backup``): ``row_counts``,
   ``count`` and ``selected_row_counts`` must launch; (d) one flipped
   byte in a copy of one archive file: the restore raises ``DigestError``
   before the fresh target holds an index; (e) ``GET /internal/backup``
   of one restored node and ``POST /internal/restore`` into that fresh
   single node on the card: its 32-Count over its shards exact, the
   device memory and resident plane bytes before and after logged (0
   before: a restore takes only an empty holder, so this drops no plane
   that was on the card).  The
   nodes then close without compacting (the tree is removed).
17. Chaos on the card: ``hung_dispatch_serving`` and
   ``flaky_device_governor`` of ``pilosa_tpu_torch.fault.chaos``, each
   on its own 1-node process cluster serving on the card, the two side by
   side, and ``corrupt_fragment_scrub_repair`` (2 nodes) when the two
   took less than a third of the phase's 40 s (else a CUT line); each
   scenario's seconds.
18. Print the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.  Each phase's wall
   seconds are printed on a line of their own with the disk bytes this
   process wrote in it and so far (``write_bytes`` of ``/proc/self/io``;
   the child processes of phases 13 and 17 write beside it), and the free
   disk before phase 2.

``--procs-only`` runs phase 1, the data, phase 2's one write and phase
procs alone: the run that needs several cards, where no other phase
needs them.

It needs one CUDA device and exits non-zero without one.  It imports
nothing of JAX or of ``pilosa_tpu``.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside the tensor cores
T_START = time.monotonic()
RUN_LIMIT_S = 1200             # the run's time limit, kernel builds included
FULL_SHARDS = 954              # 1.0e9 columns: the full configuration
ROWS = 32                      # the bench field's rows (bench.py N_ROWS)
WORDS = 32768                  # words per shard
SELECTED = (0, 5, 9, 17)       # the 4-Count request's rows
BATCH = 4096                   # pairs per ingest batch
SET_BATCHES, CLEAR_BATCHES = 10, 2
OVER_CAP = 100_000             # pairs of the batch past the overlay's reach
COMPACT_FRACTION = 0.25        # overlay fill that starts the compactor
CLIENTS, PASSES = 32, 6        # concurrent clients (bench.py) and passes
# the BSI phase: int field ``amount`` over the same shards (amounts in
# cents up to +-$10,000: base 0, bit depth 20), about half the columns
# holding a value
BSI_MIN, BSI_MAX, BSI_DEPTH = -1_000_000, 1_000_000, 20
BSI_ROWS = BSI_DEPTH + 2       # exists, sign, 20 magnitude bits
BSI_FILL = 0.5
VALUE_BATCH, VALUE_BATCHES = 1024, 6   # importValue batches while serving
VALUE_OVER_CAP = 50_000        # values of the batch past the BSI overlay
MINI_COLUMNS = 2048            # mini-plane lanes timed in phase 1
GB_VALUES = 1024               # phase 6's importValue batch
GB_PASSES = 4                  # passes of phase 6's concurrent burst
REPLACES = {
    "row_counts": "pilosa_tpu/engine/pallas_kernels.py:111",
    "selected_row_counts": "pilosa_tpu/engine/pallas_kernels.py:207",
    "count": "pilosa_tpu/engine/pallas_kernels.py:167",
    "intersect_count": "pilosa_tpu/engine/pallas_kernels.py:64",
}
SOURCE = "pilosa_tpu_torch/engine/csrc/popcount.cu"


def log(msg: str) -> None:
    print(msg, flush=True)
    if msg.startswith(("== ", "CUT")):
        # phase headers on stderr too, with the run's seconds: the end of
        # stderr then says where a run that was cut had got to
        print(f"[{time.monotonic() - T_START:.0f} s] {msg}", file=sys.stderr,
              flush=True)


_WRITES = [(0, 0)]  # _write_bytes() at the last phase's end


def _write_bytes() -> tuple[int, int]:
    """(``write_bytes``, ``wchar``) of ``/proc/self/io``: the bytes this
    process caused to be written to storage, and the bytes it passed to
    write calls (files, pipes and terminals; the card machine's sandbox
    reports ``write_bytes`` as 0).  Zeros where the file cannot be read."""
    got = {}
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                got[key] = int(val)
    except (OSError, ValueError):
        pass
    return got.get("write_bytes", 0), got.get("wchar", 0)


def phase_done(n, t0: float) -> float:
    """Log phase ``n``'s wall seconds and its disk writes beside the total
    so far (a card machine takes about 45 GiB per call: the next phase is
    sized against what is left); returns the time the next phase starts
    from."""
    now = time.perf_counter()
    (wb, wc), (wb0, wc0) = _write_bytes(), _WRITES[0]
    name = f"phase {n}" if isinstance(n, int) else n
    log(f"{name} wall: {now - t0:.1f}s; this process's writes: "
        f"write_bytes {(wb - wb0) / 1e9:.2f} GB in it, {wb / 1e9:.2f} GB "
        f"so far; wchar {(wc - wc0) / 1e9:.2f} GB in it, {wc / 1e9:.2f} GB "
        "so far")
    _WRITES[0] = (wb, wc)
    return now


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA
    events around the whole run, after a warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs integer
    operations over the 32-bit rate, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: build + kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand_words(gen, shape, device):
    """~25% dense int32 words with the sign-bit and all-ones words that
    trap an arithmetic-shift popcount planted along the last axis."""
    import torch
    hi = 1 << 31
    a = torch.randint(-hi, hi, shape, dtype=torch.int32, device=device,
                      generator=gen)
    b = torch.randint(-hi, hi, shape, dtype=torch.int32, device=device,
                      generator=gen)
    w = a & b
    w[..., 0] = -(1 << 31)      # 0x80000000
    w[..., -1] = -1             # 0xFFFFFFFF
    return w


def kernel_phase(shards: int, seed: int) -> dict:
    import torch
    from pilosa_tpu_torch.engine import cuda_kernels, kernels

    t0 = time.perf_counter()
    lib = cuda_kernels.build()
    log(f"build: {lib} in {time.perf_counter() - t0:.1f}s")
    for line in cuda_kernels.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def check(name, got, want):
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}, max abs err {err})")
        return err

    def ragged(dev, gen) -> dict:
        """The four kernels against their plain versions at ragged shapes
        on ``dev``: {kernel: max abs err}."""
        errs = dict.fromkeys(REPLACES, 0)
        for s, r, w in ((13, 5, 1000), (13, 5, 1001), (3, 1, 3),
                        (2, 1, 32768)):
            p = _rand_words(gen, (s, r, w), dev)
            f = _rand_words(gen, (s, w), dev)
            idx = torch.tensor([r - 1, 0, r - 1], dtype=torch.int32)
            col = p[:, 0].contiguous()
            for name, tag, got, want in (
                    ("row_counts", f"{s}x{r}x{w}",
                     cuda_kernels.row_counts(p), kernels.row_counts_plain(p)),
                    ("row_counts", f"+filter {s}x{r}x{w}",
                     cuda_kernels.row_counts(p, f),
                     kernels.row_counts_plain(p, f)),
                    ("selected_row_counts", f"{s}x{r}x{w} N=3",
                     cuda_kernels.selected_row_counts(p, idx),
                     kernels.selected_row_counts_plain(p, idx)),
                    ("count", f"{s}x{w}", cuda_kernels.count(f),
                     kernels.count_plain(f)),
                    ("intersect_count", f"{s}x{w}",
                     cuda_kernels.intersect_count(f, col),
                     kernels.intersect_count_plain(f, col))):
                errs[name] = max(errs[name],
                                 check(f"{name} {tag} on {dev}", got, want))
        return errs

    def main_cases(plane, filt, other, idx) -> dict:
        """{kernel: (kernel call, plain call)} at the main-path shapes."""
        return {
            "row_counts": (lambda: cuda_kernels.row_counts(plane),
                           lambda: kernels.row_counts_plain(plane)),
            "selected_row_counts": (
                lambda: cuda_kernels.selected_row_counts(plane, idx),
                lambda: kernels.selected_row_counts_plain(plane, idx)),
            "count": (lambda: cuda_kernels.count(filt),
                      lambda: kernels.count_plain(filt)),
            "intersect_count": (
                lambda: cuda_kernels.intersect_count(filt, other),
                lambda: kernels.intersect_count_plain(filt, other)),
        }

    # ragged shapes first: a wrong kernel fails fast and small
    card_errs = {0: ragged(dev, gen)}
    log("ragged shapes: all four kernels equal their plain versions")

    s, r, w = shards, ROWS, WORDS
    plane = _rand_words(gen, (s, r, w), dev)
    filt = _rand_words(gen, (s, w), dev)
    other = _rand_words(gen, (s, w), dev)
    idx = torch.tensor(SELECTED, dtype=torch.int32)
    sizes = {
        "row_counts": (s * r * w * 4 + s * r * 4, 2 * s * r * w, 20),
        "selected_row_counts": (
            s * len(SELECTED) * w * 4 + s * len(SELECTED) * 4,
            2 * s * len(SELECTED) * w, 50),
        "count": (s * w * 4 + s * 4, 2 * s * w, 100),
        "intersect_count": (2 * s * w * 4 + s * 4, 3 * s * w, 100),
    }
    out = {}
    for name, (kern, plain) in main_cases(plane, filt, other, idx).items():
        nbytes, ops, iters = sizes[name]
        err = check(f"{name} main path", kern(), plain())
        card_errs[0][name] = max(card_errs[0][name], err)
        blocks = None
        if name == "count":
            # this shape's time has varied between runs (52% to 85% of
            # its bound): the median of three blocks of 200 after 20
            # warm-ups, with their spread
            blocks = [time_ms(kern, 200, warmup=20 if i == 0 else 0)
                      for i in range(3)]
            ms = sorted(blocks)[1]
            log(f"count blocks of 200: {', '.join(f'{b:.4f}' for b in blocks)}"
                f" ms; median {ms:.4f} ms, spread (max - min) "
                f"{max(blocks) - min(blocks):.4f} ms = "
                f"{(max(blocks) - min(blocks)) / ms:.1%} of the median")
        else:
            ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, 3, warmup=1)
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "bytes": nbytes}
        if blocks is not None:
            out[name]["blocks_ms"] = blocks
        log(f"{name}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), bound "
            f"{b_ms:.4f} ms by {b_by} (at {b_ms / ms:.1%} of the bound rate), "
            f"plain "
            f"{plain_ms:.3f} ms, library call: none (torch has no popcount "
            "operator)")
    # the filtered row_counts TopN takes, for the record
    ms = time_ms(lambda: cuda_kernels.row_counts(plane, filt), 20)
    check("row_counts+filter main path", cuda_kernels.row_counts(plane, filt),
          kernels.row_counts_plain(plane, filt))
    fb = s * r * w * 4 + s * w * 4 + s * r * 4
    log(f"row_counts+filter: {ms:.4f} ms ({fb / ms / 1e6:.1f} GB/s), bound "
        f"{bound(fb, 3 * s * r * w)[0]:.4f} ms")
    del plane, filt, other
    # the BSI path's shapes: Sum's filtered pass over the [S, 22, W] bit
    # plane, and the overlay's [K, 22, 1] mini plane with its filter
    shapes = {}
    for tag, (ps, pw), iters in (("plane", (s, w), 20),
                                 ("mini", (MINI_COLUMNS, 1), 200)):
        bp = _rand_words(gen, (ps, BSI_ROWS, pw), dev)
        bf = _rand_words(gen, (ps, pw), dev)
        err = check(f"row_counts+filter BSI {tag} {ps}x{BSI_ROWS}x{pw}",
                    cuda_kernels.row_counts(bp, bf),
                    kernels.row_counts_plain(bp, bf))
        nbytes = (ps * BSI_ROWS * pw + ps * pw + ps * BSI_ROWS) * 4
        b_ms, b_by = bound(nbytes, 3 * ps * BSI_ROWS * pw)
        k_ms = time_ms(lambda: cuda_kernels.row_counts(bp, bf), iters)
        p_ms = time_ms(lambda: kernels.row_counts_plain(bp, bf), 3,
                       warmup=1)
        shapes[tag] = {"shape": [ps, BSI_ROWS, pw], "max_abs_err": err,
                       "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
        log(f"row_counts+filter BSI {tag} {ps}x{BSI_ROWS}x{pw}: "
            f"{k_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (at "
            f"{b_ms / k_ms:.1%} of the bound rate), plain {p_ms:.3f} ms")
        del bp, bf
    out["row_counts"]["bsi_shapes"] = shapes
    torch.cuda.empty_cache()
    # every other visible card: the ragged shapes and the main-path ones
    for i in range(1, torch.cuda.device_count()):
        d = torch.device("cuda", i)
        g = torch.Generator(device=d)
        g.manual_seed(seed + i)
        card_errs[i] = ragged(d, g)
        plane = _rand_words(g, (s, r, w), d)
        filt = _rand_words(g, (s, w), d)
        other = _rand_words(g, (s, w), d)
        for name, (kern, plain) in main_cases(plane, filt, other,
                                              idx).items():
            card_errs[i][name] = max(
                card_errs[i][name],
                check(f"{name} main path on {d}", kern(), plain()))
        del plane, filt, other
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    by_card = {f"cuda:{i}": e for i, e in card_errs.items()}
    log(f"phase 1 max abs err per card ({len(by_card)} visible): "
        f"{json.dumps(by_card)}")
    for name in out:
        out[name]["max_abs_err"] = max(e[name] for e in card_errs.values())
        out[name]["max_abs_err_by_card"] = {c: e[name]
                                            for c, e in by_card.items()}
    return out


# ---------------------------------------------------------------------------
# phase 2: the serving path
# ---------------------------------------------------------------------------


def _popcounts(words: np.ndarray) -> np.ndarray:
    """Set bits over the last axis, int64 (numpy oracle)."""
    return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)


def _create_fields(data_dir: str, index: str, fields: dict,
                   new_index: bool = False) -> None:
    """Write the schema of ``fields`` (name -> FieldOptions) into
    ``index``, created first (no existence field) when ``new_index``.  An
    unopened Holder and Index write the same ``.meta`` files as opened
    ones, without reading the snapshots already on disk: at full size an
    opened Holder reads every fragment written so far."""
    from pilosa_tpu_torch.store import Holder
    from pilosa_tpu_torch.store.index import Index

    h = Holder(data_dir)
    if new_index:
        idx = h.create_index(index, track_existence=False)
    else:
        idx = Index(os.path.join(data_dir, index), index,
                    track_existence=False)
    for name, opts in fields.items():
        idx.create_field(name, opts)
    h.close()


def make_index(data_dir: str, shards: int, seed: int):
    """Generate the bench data and write it as real fragment snapshots
    (index ``bench``: field ``f`` 32 rows ~25% dense, field ``g`` 4
    filter rows ~50% dense).  Returns the numpy oracle's answers."""
    from pilosa_tpu_torch.store import FieldOptions, Holder, roaring

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 1 << 32, size=(shards, ROWS, WORDS), dtype=np.uint32)
    f &= rng.integers(0, 1 << 32, size=f.shape, dtype=np.uint32)
    g = rng.integers(0, 1 << 32, size=(shards, 4, WORDS), dtype=np.uint32)
    log(f"data: f {f.nbytes / 1e9:.2f} GB + g {g.nbytes / 1e9:.2f} GB "
        f"generated in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    h = Holder(data_dir).open()
    idx = h.create_index("bench", track_existence=False)
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("amount", FieldOptions(type="int", min=BSI_MIN,
                                            max=BSI_MAX))
    idx.create_field("tags")  # phase 10's sparse field
    if idx.field("amount").options.bit_depth != BSI_DEPTH:
        raise AssertionError("amount's bit depth is not 20")
    h.close()
    total = 0
    for name, arr in (("f", f), ("g", g)):
        frag_dir = os.path.join(data_dir, "bench", name, "views",
                                "standard", "fragments")
        os.makedirs(frag_dir, exist_ok=True)
        for s in range(shards):
            blob = roaring.serialize_dense(arr[s])
            total += len(blob)
            with open(os.path.join(frag_dir, str(s)), "wb") as fh:
                fh.write(blob)
    log(f"index written: {2 * shards} fragment snapshots, "
        f"{total / 1e9:.2f} GB in {time.perf_counter() - t0:.1f}s")
    # phase 15 imports these blobs into its cluster; later phases compact
    # and damage some snapshot files (each a new file: tmp + rename), so
    # the originals are kept as hard links (no bytes copied)
    for name in ("f", "g"):
        src = os.path.join(CLUSTER_DIR, "src", name)
        os.makedirs(src, exist_ok=True)
        for s in range(shards):
            os.link(os.path.join(data_dir, "bench", name, "views",
                                 "standard", "fragments", str(s)),
                    os.path.join(src, str(s)))
    # phase 10's sparse field, written beside f's snapshots
    tags = make_tags(data_dir, shards, seed)
    # phase 9's keyed field holds f's rows as written here (phase 4 and
    # 6's imports reach f only); written while the page cache is clean
    seg_oracle = make_keys(data_dir, f, g, shards)

    t0 = time.perf_counter()
    # per shard, for phase 15's prefix of the shards
    ps = {"counts": np.zeros((shards, ROWS), np.int64),
          "filtered": np.zeros((shards, ROWS), np.int64),
          "inter": np.zeros(shards, np.int64),
          "union": np.zeros(shards, np.int64)}
    for s0 in range(0, shards, 64):
        fc, g0 = f[s0:s0 + 64], g[s0:s0 + 64, 0]
        ps["counts"][s0:s0 + 64] = _popcounts(fc)
        ps["filtered"][s0:s0 + 64] = _popcounts(fc & g0[:, None, :])
        ps["inter"][s0:s0 + 64] = _popcounts(fc[:, 1] & g0)
        ps["union"][s0:s0 + 64] = _popcounts(fc[:, 1] | g0)
    counts = ps["counts"].sum(axis=0)
    filtered = ps["filtered"].sum(axis=0)
    inter, union = int(ps["inter"].sum()), int(ps["union"].sum())
    # a column of row 3 that is still clear, for the write check
    zero = np.nonzero(np.unpackbits(f[0, 3].view(np.uint8),
                                    bitorder="little") == 0)[0]
    free_col = int(zero[0])
    oracle = {"counts": counts, "filtered": filtered, "inter": inter,
              "union": union, "free_col": free_col, "per_shard": ps}
    # the write check sets that bit; the concurrent phase serves that
    # state, and the ingest batches follow it
    state = {"counts": counts.copy(), "filtered": filtered.copy()}
    _apply_pairs(f, g[:, 0], state, np.array([3]), np.array([free_col]),
                 clear=False)
    oracle["served"] = {"counts": state["counts"].copy(),
                        "filtered": state["filtered"].copy(),
                        "trees": _tree_counts(f, g[:, 0])}
    oracle["ingest"] = _ingest_batches(f, g[:, 0], state, shards, seed)
    log(f"numpy oracle and {len(oracle['ingest']['batches']) + 1} import "
        f"batches in {time.perf_counter() - t0:.1f}s")
    # f now holds its state after the ingest phase, which the BSI phase
    # serves
    oracle["bsi"] = make_bsi(data_dir, f, g, shards, seed)
    # and phase 6 serves f and amount as phases 4 and 5 left them
    oracle["groupby"] = make_groupby(f, g, shards, seed, oracle["bsi"])
    # phase 8's mutex and bool fields, over f and amount as phases 4-6
    # left them
    oracle["mutex"] = make_mutex(data_dir, f, shards, seed, oracle["bsi"])
    # phase 10 serves f as phase 8 leaves it, and tags
    oracle["budget"] = make_budget_oracle(f, g, tags,
                                          oracle["mutex"]["f_counts"])
    del tags
    # phase 11 serves f as phase 10 leaves it and amount as phase 6 did
    oracle["robust"] = make_robust(f, g, shards, seed, oracle)
    # phase 12 writes f and m as phase 11 leaves them
    oracle["storage"] = make_storage(f, g, shards, seed, oracle)
    # phase 7's index of timestamped events
    oracle["events"] = make_events(data_dir, shards, seed)
    oracle["keys"] = seg_oracle
    return oracle


def _tree_counts(f: np.ndarray, g0: np.ndarray) -> list[int]:
    """The three compound Counts of ``QT`` over field ``f`` and ``g`` row
    0 (numpy oracle)."""
    out = [0, 0, 0]
    for s0 in range(0, f.shape[0], 64):
        fc, g = f[s0:s0 + 64], g0[s0:s0 + 64]
        out[0] += int(_popcounts(fc[:, 1] & (fc[:, 2] | fc[:, 5]) & g).sum())
        out[1] += int(_popcounts((fc[:, 1] | fc[:, 2]) & ~fc[:, 3]).sum())
        out[2] += int(_popcounts(fc[:, 4] ^ fc[:, 7]).sum())
    return out


def _apply_pairs(f: np.ndarray, g0: np.ndarray, state: dict,
                 rows: np.ndarray, cols: np.ndarray, clear: bool):
    """Apply distinct (row, column) pairs to the oracle's copy of field
    ``f`` and its per-row counts (plain and filtered by ``g`` row 0);
    returns the mask of pairs whose bit changed."""
    s, off = cols >> 20, cols & ((1 << 20) - 1)
    w, b = off >> 5, (off & 31).astype(np.uint32)
    bit = np.uint32(1) << b
    flat = f.reshape(-1)
    at = (s * ROWS + rows) * WORDS + w
    was = (flat[at] & bit) != 0
    changed = was if clear else ~was
    if clear:
        np.bitwise_and.at(flat, at, ~bit)
    else:
        np.bitwise_or.at(flat, at, bit)
    sign = -1 if clear else 1
    in_g = (g0[s, w] & bit) != 0
    np.add.at(state["counts"], rows[changed], sign)
    np.add.at(state["filtered"], rows[changed & in_g], sign)
    return changed


def _distinct_pairs(rng, n: int, shards: int):
    """``n`` distinct (row, column) pairs, rows 0..31, columns uniform
    over the index."""
    keys = np.empty(0, np.int64)
    while len(keys) < n:
        more = (rng.integers(0, shards << 20, 2 * n) * ROWS
                + rng.integers(0, ROWS, 2 * n))
        keys = np.concatenate([keys, np.setdiff1d(more, keys)])
        keys = np.unique(keys)
    keys = rng.permutation(keys)[:n]
    return keys % ROWS, keys // ROWS


def _ingest_batches(f, g0, state, shards: int, seed: int) -> dict:
    """The ingest phase's import batches and the answers expected after
    each: SET_BATCHES set batches, CLEAR_BATCHES batches clearing bits
    the sets wrote, and the over-cap batch."""
    rng = np.random.default_rng(seed + 1)
    batches, written = [], []
    first_trees = None
    for _ in range(SET_BATCHES):
        rows, cols = _distinct_pairs(rng, BATCH, shards)
        hit = _apply_pairs(f, g0, state, rows, cols, clear=False)
        written.append((rows[hit], cols[hit]))
        batches.append((rows, cols, False, int(hit.sum()),
                        state["counts"].copy(), state["filtered"].copy()))
        if first_trees is None:  # the overlay burst's compound answers
            first_trees = _tree_counts(f, g0)
    per = SET_BATCHES // CLEAR_BATCHES
    for k in range(CLEAR_BATCHES):
        rows = np.concatenate([r for r, _ in written[k * per:(k + 1) * per]])
        cols = np.concatenate([c for _, c in written[k * per:(k + 1) * per]])
        pick = rng.choice(len(rows), BATCH, replace=False)
        rows, cols = rows[pick], cols[pick]
        hit = _apply_pairs(f, g0, state, rows, cols, clear=True)
        batches.append((rows, cols, True, int(hit.sum()),
                        state["counts"].copy(), state["filtered"].copy()))
    rows, cols = _distinct_pairs(rng, OVER_CAP, shards)
    hit = _apply_pairs(f, g0, state, rows, cols, clear=False)
    over = (rows, cols, False, int(hit.sum()), state["counts"].copy(),
            state["filtered"].copy())
    return {"batches": batches, "over_cap": over, "first_trees": first_trees}


# ---------------------------------------------------------------------------
# the BSI field: data, oracle and the value batches
# ---------------------------------------------------------------------------


def _bits(words: np.ndarray) -> np.ndarray:
    """uint32[W] -> bool[W * 32], column order LSB first."""
    return np.unpackbits(words.view(np.uint8), bitorder="little").astype(
        bool)


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _bsi_values(seed: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    """Shard ``s`` of ``amount`` as generated from (seed, s): (exists
    bool[2^20], values int32[2^20], 0 where empty)."""
    rng = np.random.default_rng([seed, 7, s])
    exists = rng.random(1 << 20, dtype=np.float32) < BSI_FILL
    vals = np.where(exists, rng.integers(BSI_MIN, BSI_MAX + 1, 1 << 20,
                                         dtype=np.int32), 0)
    return exists, vals


def _bsi_shard(data_dir: str, s: int, seed: int, f: np.ndarray,
               g: np.ndarray, picks: np.ndarray) -> dict:
    """Generate shard ``s`` of ``amount`` from (seed, s), write its
    fragment snapshot with the port's writer, and return its part of the
    oracle (and the values at the candidate offsets ``picks``)."""
    from pilosa_tpu_torch.store import roaring
    exists, vals = _bsi_values(seed, s)
    mag = np.abs(vals)
    rows = np.empty((BSI_ROWS, WORDS), np.uint32)
    rows[0] = _pack(exists)
    rows[1] = _pack(vals < 0)
    for b in range(BSI_DEPTH):
        rows[2 + b] = _pack((mag & (1 << b)) != 0)
    frag_dir = os.path.join(data_dir, "bench", "amount", "views",
                            "bsi_amount", "fragments")
    with open(os.path.join(frag_dir, str(s)), "wb") as fh:
        fh.write(roaring.serialize_dense(rows))
    g0, g1 = _bits(g[s, 0]) & exists, _bits(g[s, 1]) & exists
    top = exists & (vals > 900_000)
    return {
        "sum": int(vals.sum(dtype=np.int64)), "cnt": int(exists.sum()),
        "hist": np.bincount(vals[exists] - BSI_MIN,
                            minlength=BSI_MAX - BSI_MIN + 1),
        "sum_g0": int(vals[g0].sum(dtype=np.int64)), "cnt_g0": int(g0.sum()),
        "max_g1": int(vals[g1].max()) if g1.any() else None,
        "cnt_max_g1": int((vals[g1] == vals[g1].max()).sum())
        if g1.any() else 0,
        "inter": int((_bits(f[s, 1]) & exists & (vals >= 0)).sum()),
        "topn": _popcounts(f[s] & _pack(top)[None, :]),
        "picks": (exists[picks], vals[picks])}


class _Hist:
    """The oracle's value histogram of ``amount`` and what it answers."""

    def __init__(self, hist: np.ndarray):
        self.h = hist.astype(np.int64)

    def move(self, old: np.ndarray, new: np.ndarray) -> None:
        """Columns whose value goes from ``old`` (None = empty) to
        ``new``."""
        np.add.at(self.h, old[old != _EMPTY] - BSI_MIN, -1)
        np.add.at(self.h, new - BSI_MIN, 1)

    def at(self, v: int) -> int:
        return int(self.h[v - BSI_MIN])

    def count_in(self, lo: int, hi: int) -> int:
        """Columns with lo <= value <= hi."""
        return int(self.h[lo - BSI_MIN:hi - BSI_MIN + 1].sum())

    def sum_count(self) -> tuple[int, int]:
        v = np.arange(BSI_MIN, BSI_MAX + 1, dtype=np.int64)
        return int((self.h * v).sum()), int(self.h.sum())

    def nonzero(self) -> np.ndarray:
        return np.nonzero(self.h)[0] + BSI_MIN


_EMPTY = np.iinfo(np.int64).min   # an empty column's "old value"


def _vc(value: int, count: int) -> list:
    return [{"value": int(value), "count": int(count)}]


BSI_SEQ = ("Sum(field=amount)", "Sum(Row(g=0), field=amount)",
           "Min(field=amount)", "Max(Row(g=1), field=amount)",
           "Count(Row(amount > 250000))", "Count(Row(-1000 < amount < 1000))",
           "Count(Intersect(Row(f=1), Row(amount >= 0)))",
           "TopN(f, Row(amount > 900000), n=5)",
           "Percentile(field=amount, nth=99)",
           "Distinct(Row(amount > 999000), field=amount)")
BSI_MIX = BSI_SEQ[:6]            # the concurrent burst's requests
BSI_NAMES = dict(zip(BSI_SEQ, ("Sum", "filtered Sum", "Min",
                               "filtered Max", "Count(amount > 250000)",
                               "Count(-1000 < amount < 1000)",
                               "Count(f1 & amount >= 0)", "filtered TopN",
                               "Percentile 99", "filtered Distinct")))
BSI_INGEST = ("Sum(field=amount)", "Min(field=amount)", "Max(field=amount)",
              "Count(Row(amount > 250000))")


def _bsi_ingest_expect(hist: _Hist) -> dict:
    vals = hist.nonzero()
    total, cnt = hist.sum_count()
    lo, hi = int(vals[0]), int(vals[-1])
    return {BSI_INGEST[0]: _vc(total, cnt),
            BSI_INGEST[1]: _vc(lo, hist.at(lo)),
            BSI_INGEST[2]: _vc(hi, hist.at(hi)),
            BSI_INGEST[3]: [hist.count_in(250_001, BSI_MAX)]}


def _changed_bits(old: np.ndarray, new: np.ndarray) -> int:
    """Bits a value import changes: the symmetric difference of the old
    and new encodings (exists, sign, magnitude bits)."""
    was = old != _EMPTY
    o = np.where(was, old, 0)
    flips = np.bitwise_count(np.abs(o) ^ np.abs(new)).astype(np.int64)
    return int(np.where(was, ((o < 0) != (new < 0)) + flips,
                        1 + (new < 0) + flips).sum())


def make_bsi(data_dir: str, f: np.ndarray, g: np.ndarray, shards: int,
             seed: int) -> dict:
    """Write ``amount``'s fragment snapshots (view ``bsi_amount``, rows
    0..21) and return the BSI oracle: the sequential requests' answers,
    and the value batches with the answers expected after each.  ``f``
    must hold field f's final state (after the ingest phase)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    os.makedirs(os.path.join(data_dir, "bench", "amount", "views",
                             "bsi_amount", "fragments"), exist_ok=True)
    rng = np.random.default_rng(seed + 2)
    n_cand = 3 * VALUE_BATCH * VALUE_BATCHES + VALUE_OVER_CAP
    cand = np.sort(rng.choice(shards << 20, n_cand, replace=False))
    bounds = np.searchsorted(cand, np.arange(shards + 1) << 20)
    hist = np.zeros(BSI_MAX - BSI_MIN + 1, np.int64)
    sum_g0 = cnt_g0 = inter = 0
    max_g1: list = []
    topn = np.zeros(ROWS, np.int64)
    per_shard = {"sum": np.zeros(shards, np.int64),
                 "cnt": np.zeros(shards, np.int64)}
    c_exists = np.zeros(n_cand, bool)
    c_vals = np.zeros(n_cand, np.int64)
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(_bsi_shard, data_dir, s, seed, f, g,
                            cand[bounds[s]:bounds[s + 1]] & ((1 << 20) - 1))
                for s in range(shards)]
        for s, fut in enumerate(futs):
            r = fut.result()
            per_shard["sum"][s], per_shard["cnt"][s] = r["sum"], r["cnt"]
            hist += r["hist"]
            sum_g0 += r["sum_g0"]
            cnt_g0 += r["cnt_g0"]
            inter += r["inter"]
            topn += r["topn"]
            if r["max_g1"] is not None:
                max_g1.append((r["max_g1"], r["cnt_max_g1"]))
            c_exists[bounds[s]:bounds[s + 1]] = r["picks"][0]
            c_vals[bounds[s]:bounds[s + 1]] = r["picks"][1]
    hist = _Hist(hist)
    vals = hist.nonzero()
    total, cnt = hist.sum_count()
    best = max(v for v, _ in max_g1)
    pct_target = min(cnt, max(1, math.ceil(99 / 100.0 * cnt)))
    pct = int(np.searchsorted(np.cumsum(hist.h), pct_target)) + BSI_MIN
    expect = {
        BSI_SEQ[0]: _vc(total, cnt),
        BSI_SEQ[1]: _vc(sum_g0, cnt_g0),
        BSI_SEQ[2]: _vc(vals[0], hist.at(int(vals[0]))),
        BSI_SEQ[3]: _vc(best, sum(c for v, c in max_g1 if v == best)),
        BSI_SEQ[4]: [hist.count_in(250_001, BSI_MAX)],
        BSI_SEQ[5]: [hist.count_in(-999, 999)],
        BSI_SEQ[6]: [inter],
        BSI_SEQ[7]: [_topn(topn, 5)],
        BSI_SEQ[8]: _vc(pct, hist.at(pct)),
        BSI_SEQ[9]: [{"values": [int(v) for v in vals[vals > 999_000]]}],
    }
    log(f"BSI data: amount over {shards} shards, {cnt} values "
        f"({cnt / (shards << 20):.1%} of columns), {shards} fragment "
        f"snapshots and the oracle in {time.perf_counter() - t0:.1f}s")

    # the value batches: each half overwrites, half fills empty columns;
    # every column is written once across the phase
    old = np.where(c_exists, c_vals, _EMPTY)
    full, empty = np.nonzero(c_exists)[0], np.nonzero(~c_exists)[0]
    half = VALUE_BATCH // 2
    batches = []
    used = np.zeros(n_cand, bool)
    for k in range(VALUE_BATCHES):
        pick = np.concatenate([full[k * half:(k + 1) * half],
                               empty[k * half:(k + 1) * half]])
        used[pick] = True
        batches.append(pick)
    perm = rng.permutation(np.nonzero(~used)[0])
    batches.append(perm[:VALUE_OVER_CAP])
    out = []
    final = old.copy()   # every candidate's value after phase 5
    for pick in batches:
        new = rng.integers(BSI_MIN, BSI_MAX + 1, len(pick))
        changed = _changed_bits(old[pick], new)
        hist.move(old[pick], new)
        final[pick] = new
        out.append((cand[pick], new, changed, _bsi_ingest_expect(hist)))
    # phase 6's value batch: candidates no phase-5 batch wrote
    pick = np.sort(perm[VALUE_OVER_CAP:VALUE_OVER_CAP + GB_VALUES])
    new = rng.integers(BSI_MIN, BSI_MAX + 1, len(pick))
    return {"expect": expect, "batches": out[:-1], "over_cap": out[-1],
            "final": (cand, final), "hist": hist, "per_shard": per_shard,
            "gb_values": (cand[pick], new, final[pick],
                          _changed_bits(final[pick], new))}


def sync_all() -> None:
    """Wait for every visible card (``torch.cuda.synchronize()`` waits for
    the current one only)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def device_times(run, warmup: int = 0, by_card: dict | None = None
                 ) -> tuple[list, float]:
    """([(kernel or copy, device ms)], wall ms) over one ``run()``, from a
    torch.profiler trace of the cards, largest first (summed over the
    cards).  With ``warmup``, ``run()`` first runs that many times as the
    profiler's warm-up steps, whose events are discarded, and only the
    last run is read: the device activity of a session's first moments
    can go missing (phases 8 and 9 at 954 shards).  ``by_card``, when
    given, is filled with ``{"cuda:i": {"ms": device ms, "copy_ms": the
    memory copies' ms}}`` per card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    sync_all()
    steps = (schedule(wait=0, warmup=warmup, active=1, repeat=1)
             if warmup else None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=steps) as prof:
        for _ in range(warmup):
            run()
            prof.step()
        sync_all()
        t = time.perf_counter()
        run()
        sync_all()
        wall = (time.perf_counter() - t) * 1e3
        if warmup:
            prof.step()
    if by_card is not None:
        for e in prof.events():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0
                    or e.key.startswith("ProfilerStep")):
                continue
            card = by_card.setdefault(f"cuda:{e.device_index}",
                                      {"ms": 0.0, "copy_ms": 0.0})
            ms = e.self_device_time_total / 1e3
            card["ms"] += ms
            if "memcpy" in e.key.lower():
                card["copy_ms"] += ms
    # device-side entries only (kernels, copies): the CPU ops that
    # launched them report the same time again, and so do the schedule's
    # ProfilerStep ranges
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda kv: -kv[1])
    return rows, wall


def _short(name: str) -> str:
    """A profiler kernel name cut to what tells kernels apart: the torch
    functor or bitwise op of an elementwise kernel, else the bare
    function name."""
    hit = re.search(r"(\w+Functor|bitwise_\w+|\w+_kernel_cuda)", name)
    if hit and "elementwise" in name:
        return hit.group(1)
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name[:40]


def device_busy_share(run, warmup: int = 0, by_card: dict | None = None
                      ) -> tuple[float, float, str]:
    """(device ms, wall ms, top device consumers) over one ``run()``; the
    device ms sum over every card (one card's unless ``run()`` spans
    several: then read ``by_card``, :func:`device_times`)."""
    rows, wall = device_times(run, warmup, by_card)
    top = ", ".join(f"{_short(k)} {v:.3f} ms" for k, v in rows[:6])
    return sum(v for _, v in rows), wall, top


TRACE_WARMUP = 2    # profiler warm-up runs before the one that is read


def traced(run, what: str, by_card: dict | None = None
           ) -> tuple[float, float, str]:
    """:func:`device_busy_share` of ``run()`` after ``TRACE_WARMUP``
    warm-up runs in the same profiler session.  At 954 shards a plain
    trace of a few ~3 ms requests in phases 8 and 9 came back without
    device entries in most runs, or with only part of them; the warm-up
    steps are the profiler's own remedy.  A trace that still holds no
    device entries is taken again, and a second empty one fails."""
    for attempt in range(2):
        if by_card is not None:
            by_card.clear()
        dev_ms, wall_ms, top = device_busy_share(run, TRACE_WARMUP, by_card)
        if dev_ms > 0:
            return dev_ms, wall_ms, top
        log(f"{what}: the trace held no device entries; tracing again")
    raise AssertionError(f"{what}: two traces held no device entries; its "
                         "device time was not measured")


def _topn(totals: np.ndarray, n: int) -> list:
    order = np.argsort(-totals, kind="stable")[:n]
    return [{"id": int(r), "count": int(totals[r])} for r in order
            if totals[r] > 0]


Q32 = "".join(f"Count(Row(f={r}))" for r in range(ROWS))
Q4 = "".join(f"Count(Row(f={r}))" for r in SELECTED)
TOPN_G = "TopN(f, Row(g=0), n=5)"
TREES = ("Count(Intersect(Row(f=1), Union(Row(f=2), Row(f=5)), Row(g=0)))",
         "Count(Difference(Union(Row(f=1), Row(f=2)), Row(f=3)))",
         "Count(Xor(Row(f=4), Row(f=7)))")
QT = "".join(TREES)
MIX = (Q32, Q4, TOPN_G, QT)    # the concurrent clients' request mix
MIX_COUNTS = {Q32: ROWS, Q4: len(SELECTED), TOPN_G: 0, QT: len(TREES)}
MIX_NAMES = {Q32: "32-Count", Q4: "4-Count", TOPN_G: "filtered TopN",
             QT: "3-tree"}


def _mix_expect(counts, filtered, trees) -> dict:
    return {Q32: [int(c) for c in counts],
            Q4: [int(counts[r]) for r in SELECTED],
            TOPN_G: [_topn(filtered, 5)], QT: [int(t) for t in trees]}


def _median_ms(ts: list) -> float:
    ms = sorted(t * 1e3 for t in ts)
    return ms[len(ms) // 2]


class _Client:
    """The API in process (timed, answers checked) and over REST."""

    def __init__(self, api, cuda: bool):
        self.api = api
        self.cuda = cuda
        self.base = None
        self.lat: dict[str, list] = {}

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def ask(self, pql: str, want, reps: int = 1, tag: str | None = None,
            index: str = "bench"):
        for _ in range(reps):
            t = time.perf_counter()
            got = self.api.query(index, pql)["results"]
            self.sync()
            self.lat.setdefault(tag or pql, []).append(
                time.perf_counter() - t)
            if got != want:
                raise AssertionError(f"{pql[:60]}: got {str(got)[:300]}, "
                                     f"want {str(want)[:300]}")

    def post(self, path: str, body: bytes, tag: str):
        t = time.perf_counter()
        req = urllib.request.Request(self.base + path, data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            got = json.loads(resp.read())
        self.lat.setdefault(tag, []).append(time.perf_counter() - t)
        return got


def _pct_ms(ts: list, q: float) -> float:
    ms = sorted(t * 1e3 for t in ts)
    return ms[min(len(ms) - 1, int(q * len(ms)))]


def burst(api, expect: dict, clients: int = CLIENTS,
          passes: int = PASSES, mix: tuple = MIX,
          names: dict = MIX_NAMES, index: str = "bench") -> dict:
    """``clients`` threads, each making ``passes`` passes over ``mix``
    (each client starts at another request, so kinds mix in a window);
    every answer is checked.  Returns the wall seconds, the request
    count and the latencies by request."""
    lat: dict = {q: [] for q in mix}
    errors: list = []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1, timeout=600)

    def client(k: int) -> None:
        mine: dict = {q: [] for q in mix}
        try:
            start.wait()
            for _ in range(passes):
                for i in range(len(mix)):
                    q = mix[(k + i) % len(mix)]
                    t = time.perf_counter()
                    got = api.query(index, q)["results"]
                    mine[q].append(time.perf_counter() - t)
                    if got != expect[q]:
                        raise AssertionError(
                            f"{names[q]}: got {str(got)[:200]}, want "
                            f"{str(expect[q])[:200]}")
        except Exception as e:  # noqa: BLE001 — reported below
            with lock:
                errors.append(repr(e)[:400])
        finally:
            with lock:
                for q, ts in mine.items():
                    lat[q].extend(ts)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client of the concurrent burst hung")
    if errors:
        raise AssertionError(f"{len(errors)} client(s) failed: {errors[:3]}")
    return {"wall": wall, "lat": lat,
            "requests": clients * passes * len(mix),
            "counts": clients * passes * sum(MIX_COUNTS.get(q, 0)
                                             for q in mix)}


# requests/s of each configuration's first timed burst (phase 3's), which
# phase 14's instrumented burst is printed beside
BURST_RATES: dict = {}


def concurrent_phase(apis: dict, expect: dict, cuda: bool,
                     clients: int = CLIENTS, passes: int = PASSES,
                     profile: bool = True) -> dict:
    """Phase 3: one timed burst per configuration (``apis``: name ->
    API), its launch counters reset just before and read just after;
    with ``profile``, one more burst under the profiler each and the
    fold-vs-count profile of the compound Counts on the first
    configuration.  Returns the launch counts of each timed burst."""
    import torch
    from pilosa_tpu_torch.engine import cuda_kernels

    launches = {}
    for name, api in apis.items():
        ex = api.executor
        for q in MIX:  # plans built, every operand resident
            got = api.query("bench", q)["results"]
            if got != expect[q]:
                raise AssertionError(f"{name} {MIX_NAMES[q]}: got {got}")
        b0 = ex.serving_stats()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launches()
        run = burst(api, expect, clients, passes)
        launched = dict(cuda_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        b1 = ex.serving_stats()
        launches[name] = launched
        reqs = run["requests"]
        BURST_RATES.setdefault(name, reqs / run["wall"])
        log(f"[{name}] {clients} clients x {passes} passes: {reqs} "
            f"requests in {run['wall']:.3f} s = {reqs / run['wall']:.1f} "
            f"requests/s, {run['counts'] / run['wall']:.1f} Count "
            f"queries/s; peak device memory {peak / 1e9:.2f} GB")
        for q in MIX:
            ts = run["lat"][q]
            log(f"[{name}]   {MIX_NAMES[q]}: p50 {_pct_ms(ts, 0.5):.2f} ms, "
                f"p90 {_pct_ms(ts, 0.9):.2f} ms, p99 "
                f"{_pct_ms(ts, 0.99):.2f} ms, max {max(ts) * 1e3:.2f} ms, "
                f"mean {sum(ts) / len(ts) * 1e3:.2f} ms over {len(ts)}")
        windows = b1.get("windows", 0) - b0.get("windows", 0)
        items = b1.get("items", 0) - b0.get("items", 0)
        hits = b1.get("fastLaneHits", 0) - b0.get("fastLaneHits", 0)
        log(f"[{name}]   batcher: {windows} windows, {items} items "
            f"({items / max(1, windows):.2f} per window, largest "
            f"{b1.get('maxWindowItems', 0)}), {hits} fast-lane hits; "
            f"plan cache +{b1['planCacheHits'] - b0['planCacheHits']} hits"
            f", +{b1['planCacheMisses'] - b0['planCacheMisses']} misses")
        log(f"[{name}]   launches per request: " + json.dumps(
            {k: round(v / reqs, 4) for k, v in launched.items() if v}))
        if cuda and profile:
            dev_ms, wall_ms, top = device_busy_share(
                lambda: burst(api, expect, clients, max(1, passes // 3)))
            log(f"[{name}]   one burst of {clients} x {max(1, passes // 3)}"
                f" under the profiler: device busy {dev_ms:.3f} ms of "
                f"{wall_ms:.3f} ms wall = {dev_ms / wall_ms:.1%}; by "
                f"kernel: {top}")
        if ex.batcher is not None:
            for k in ("row_counts", "selected_row_counts", "count"):
                if cuda and launched[k] < 1:
                    raise AssertionError(f"[{name}] the concurrent burst "
                                         f"never launched {k}")
            if not 0 < windows < reqs:
                raise AssertionError(f"[{name}] {windows} windows for "
                                     f"{reqs} requests: no coalescing")
            if b1["maxWindowItems"] < 2:
                raise AssertionError(f"[{name}] no window held two items")
    if cuda and profile:
        fold_vs_count(next(iter(apis.values())), expect)
    return launches


def fold_vs_count(api, expect: dict, reps: int = 5) -> None:
    """Device time of the compound Counts' plain PyTorch fold (the torch
    bitwise kernels) beside the ``count`` kernel's: solo (each tree of
    ``QT`` as its own request: the fast lane's program reads its rows
    off the plane) and windowed (the 3-tree request: one gather of the
    rows, three folds)."""
    def ask(q, want):
        got = api.query("bench", q)["results"]
        if got != want:
            raise AssertionError(f"{q[:60]}: got {got}, want {want}")

    for tag, run in (
            ("solo", lambda: [ask(t, [w]) for _ in range(reps)
                              for t, w in zip(TREES, expect[QT])]),
            ("windowed", lambda: [ask(QT, expect[QT])
                                  for _ in range(reps)])):
        rows, wall = device_times(run)
        fold = sum(v for k, v in rows if re.search(r"(?i)bitwise", k))
        cnt = sum(v for k, v in rows
                  if re.search(r"(^|::|\s)count_kernel\b", k))
        gather = sum(v for k, v in rows if re.search(r"(?i)index", k))
        other = sum(v for _, v in rows) - fold - cnt - gather
        log(f"3-tree {tag}, {reps} x 3 trees under the profiler: fold "
            f"(torch bitwise ops) {fold:.3f} ms, count kernel {cnt:.3f} ms "
            f"(fold / count = {fold / max(cnt, 1e-9):.2f}), gather "
            f"{gather:.3f} ms, other {other:.3f} ms, of {wall:.3f} ms wall;"
            " by kernel: " + ", ".join(f"{_short(k)} {v:.3f} ms"
                                       for k, v in rows[:8]))


def _executor(holder, **kw):
    """An executor of phases 2-11: the reference's serving defaults but for
    the ``.dense`` images.  A card machine's disk takes about 45 GiB of
    writes per call, and the data already is 29.3 GB; at the reference's
    default every build past 256 MiB would write its images (~60 GB over
    phases 2-11), so they are written and read in phase 12 only."""
    from pilosa_tpu_torch.exec import Executor
    return Executor(holder, plane_sidecars=False, **kw)


def serve_phase(data_dir: str, oracle: dict, device=None,
                clients: int = CLIENTS, passes: int = PASSES,
                seed: int = 42, **api_kw) -> dict:
    """Phases 2 to 15 over one holder (phase 15's cluster beside it);
    returns the launch counts of each path's run, keyed "serve", "mesh",
    "procs", "concurrent", "concurrent_off", "concurrent_overlay",
    "ingest", "bsi",
    "bsi_concurrent", "bsi_ingest", "groupby", "events", "mutex", "keys",
    "budget", "robust", "storage", "api", "obs", "cluster" and "backup"
    (``api_kw``
    sizes phase 13:
    phase 9's ``k`` and the CLI's pairs)."""
    import torch
    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store import Holder

    cuda = device is None
    counts = oracle["counts"]
    qc = ("Count(Intersect(Row(f=1), Row(g=0)))"
          "Count(Union(Row(f=1), Row(g=0)))")
    expect = {
        Q32: [int(c) for c in counts],
        Q4: [int(counts[r]) for r in SELECTED],
        qc: [oracle["inter"], oracle["union"]],
        "TopN(f, n=5)": [_topn(counts, 5)],
        TOPN_G: [_topn(oracle["filtered"], 5)],
    }

    t0 = t_phase = time.perf_counter()
    holder = Holder(data_dir).open()
    log(f"holder opened in {time.perf_counter() - t0:.2f}s")
    # the overlay keeps the reference's 65536 cells, but folds at a
    # quarter of them, not half: a cell is journaled only for a bit that
    # changed, so at 25% density ten 4096-pair set batches write ~30700
    # cells, under half of the cap, and the fold would never run here
    executor = _executor(holder, device=device, plane_budget=32 << 30,
                         delta_compact_fraction=COMPACT_FRACTION)
    api = API(holder, executor)
    planes = executor.planes
    client = _Client(api, cuda)
    ask = client.ask

    # The holder is not closed: closing compacts every fragment phases
    # 4-12 wrote (about 954 of f and 954 of amount, besides m, b, the
    # events views and k); phase 12 (e) times single compactions and
    # reckons the close from them instead of running it.
    server = None
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launches()
        per_request = {}
        for pql, reps in ((Q32, 5), (Q4, 5), (qc, 5), ("TopN(f, n=5)", 3),
                          (TOPN_G, 3)):
            before = dict(cuda_kernels.LAUNCHES)
            ask(pql, expect[pql], reps)
            per_request[pql[:40]] = {
                k: (v - before[k]) // reps
                for k, v in cuda_kernels.LAUNCHES.items() if v - before[k]}
        # the plane of f built in the background (past SYNC_BUILD_MAX)
        # while the first requests answered another way
        planes.wait_builds()
        build_s = planes.stats()["lastBuildSeconds"]

        busy = device_busy_share(lambda: ask(Q32, expect[Q32], 10)) \
            if cuda else None

        server = Server(api, "127.0.0.1", 0).start()
        client.base = "http://%s:%d" % server.address
        for pql in (Q32, TOPN_G):
            for _ in range(5):
                got = client.post("/index/bench/query", pql.encode(),
                                  "REST " + pql)["results"]
                if got != expect[pql]:
                    raise AssertionError(f"REST {pql[:60]}: got {got}")
        with urllib.request.urlopen(client.base + "/status",
                                    timeout=60) as resp:
            log(f"REST /status: {resp.read().decode()[:200]}")

        # a write, then reads that must show it: the plane absorbs the
        # cell into its overlay (the plan cache serves the single-row
        # Count from the plane)
        col = oracle["free_col"]
        bumped = [int(c) for c in counts]
        ask("Count(Row(f=3))", [bumped[3]])
        builds, absorbs = planes.builds, planes.delta_absorbs
        refreshed = planes.incremental_applied
        ask(f"Set({col}, f=3)", [True])
        bumped[3] += 1
        ask("Count(Row(f=3))", [bumped[3]], tag="Count(Row(f=3)) after Set")
        ask(Q32, bumped, tag="32-Count after Set")
        if planes.builds != builds or planes.delta_absorbs != absorbs + 1:
            raise AssertionError(
                f"the Set was not absorbed: builds {builds} -> "
                f"{planes.builds}, absorbs {absorbs} -> "
                f"{planes.delta_absorbs}")
        refreshed = planes.incremental_applied - refreshed
        launches = dict(cuda_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        serve_lat = {k: list(v) for k, v in client.lat.items()}
        serving = executor.serving_stats()
        log(f"batcher after phase 2: {json.dumps(serving)}")
        if serving["fastLaneHits"] < 1:
            raise AssertionError("phase 2's sequential requests never took "
                                 "the solo fast lane")

        t_phase = phase_done(2, t_phase)
        log("== phase mesh: multi-device serving ==")
        mesh = mesh_phase(holder, oracle, cuda, device, data_dir)
        t_phase = phase_done("phase mesh", t_phase)
        log("== phase procs: serving across processes ==")
        procs = procs_phase(data_dir, oracle, device)
        t_phase = phase_done("phase procs", t_phase)
        log("== phase 3: concurrent serving ==")
        # fold the Set's one-cell overlay first: this phase serves a
        # clean plane (phase 4 serves over a live overlay)
        index = holder.index("bench")
        shards = tuple(index.available_shards())
        planes.field_plane("bench", index.field("f"), "standard", shards)
        if planes.field_plane_nowait("bench", index.field("f"), "standard",
                                    shards).delta is not None:
            raise AssertionError("the plane still carries an overlay")
        served = oracle["served"]
        # the PR 2 configuration shares the default executor's plane
        # cache: one plane build, one resident plane
        off = _executor(holder, device=device, plane_budget=32 << 30,
                        delta_compact_fraction=COMPACT_FRACTION,
                        count_batch_window="off", tree_fusion=False)
        off.planes = planes
        conc = concurrent_phase(
            {"default": api, "off": API(holder, off)},
            _mix_expect(served["counts"], served["filtered"],
                        served["trees"]), cuda, clients, passes)

        t_phase = phase_done(3, t_phase)
        log("== phase 4: ingest while serving ==")
        ingest, overlay = ingest_phase(client, planes, oracle["ingest"],
                                       cuda, api, clients, passes)
        t_phase = phase_done(4, t_phase)
        planes.wait_builds()
        log("== phase 5: BSI ==")
        bsi = bsi_phase(client, holder, planes, oracle["bsi"], cuda,
                        device, clients, passes)
        t_phase = phase_done(5, t_phase)
        planes.wait_builds()
        log("== phase 6: GroupBy ==")
        gb = groupby_phase(client, holder, planes, oracle["groupby"], cuda,
                           device, clients)
        t_phase = phase_done(6, t_phase)
        planes.wait_builds()
        log("== phase 7: time views ==")
        ev = events_phase(client, holder, planes, oracle["events"], cuda,
                          device, clients)
        t_phase = phase_done(7, t_phase)
        planes.wait_builds()
        log("== phase 8: mutex and bool fields, Extract, Store ==")
        mx = mutex_phase(client, holder, planes, oracle["mutex"], cuda,
                         device, (_median_ms(client.lat["REST import"])
                                  if "REST import" in client.lat else None))
        t_phase = phase_done(8, t_phase)
        planes.wait_builds()
        log("== phase 9: keys and attributes ==")
        kp = keys_phase(client, holder, planes, oracle["keys"], cuda, device,
                        clients)
        t_phase = phase_done(9, t_phase)
        planes.wait_builds()
        log("== phase 10: fields past the plane budget ==")
        bp = budget_phase(client, holder, planes, oracle["budget"], cuda,
                          device)
        t_phase = phase_done(10, t_phase)
        planes.wait_builds()
        log("== phase 11: protobuf, distinct, deadlines, watchdog, OOM ==")
        rb = robust_phase(client, holder, planes, oracle["robust"], cuda,
                          device)
        t_phase = phase_done(11, t_phase)
        planes.wait_builds()
        log("== phase 12: the host storage path ==")
        sp = storage_phase(client, holder, planes, oracle["storage"], cuda,
                           device, data_dir)
        t_phase = phase_done(12, t_phase)
        planes.wait_builds()
        log("== phase 13: the single-node API, client and CLI ==")
        ap = api_phase(client, executor, oracle["storage"], cuda, device,
                       data_dir, seed, **api_kw)
        t_phase = phase_done(13, t_phase)
        planes.wait_builds()
        log("== phase 14: observability and storage integrity ==")
        op = obs_phase(client, holder, planes, oracle["storage"], cuda,
                       device, data_dir)
        t_phase = phase_done(14, t_phase)
        planes.wait_builds()
        log("== phase 15: the cluster ==")
        cl = cluster_phase(
            oracle, cuda, device, len(oracle["per_shard"]["inter"]),
            {"p50_ms": _median_ms(client.lat["REST " + Q32])}, t_phase)
    finally:
        if server is not None:
            server.close()
        planes.wait_compactions(300)

    for pql, ts in serve_lat.items():
        log(f"latency {pql[:48]!r}: first {ts[0] * 1e3:.2f} ms, "
            f"median {_median_ms(ts):.2f} ms over {len(ts)}")
    log(f"plane build {build_s:.2f}s; the Set absorbed into the overlay "
        f"(builds stayed {builds}, absorbs +1, row refreshes +{refreshed}); "
        f"peak device memory {peak / 1e9:.2f} GB")
    log(f"launches per request: {json.dumps(per_request)}")
    if busy is not None:
        log(f"32-Count x10 under the profiler: device busy {busy[0]:.3f} ms "
            f"of {busy[1]:.3f} ms wall = {busy[0] / busy[1]:.1%} busy; by "
            f"kernel: {busy[2]}")
    log(f"launches in the serving phase: {json.dumps(launches)}")
    for k in ("row_counts", "selected_row_counts", "count"):
        if cuda and launches[k] < 1:
            raise AssertionError(f"serving never launched the {k} kernel")
    return {"serve": launches, **mesh, **procs,
            "concurrent": conc["default"],
            "concurrent_off": conc["off"], "concurrent_overlay": overlay,
            "ingest": ingest, **bsi, **gb, **ev, **mx, **kp, **bp, **rb,
            **sp, **ap, **op, "cluster": cl["launches"],
            "backup": cl["backup"]}


# ---------------------------------------------------------------------------
# phase mesh: multi-device serving over a four-block placement
# ---------------------------------------------------------------------------

MESH_BLOCKS = 4                # blocks of the virtual placement on one card
MESH_SHARDS = 239              # CUT: bench's first 239 shards in a holder of
#                                phase mesh's own (padded to 240: the phase
#                                checks padding), since a run passed 1000 s
MESH_PARITY = (
    QT, *BSI_SEQ[:6],                        # no per-shard oracle
    "Count(Xor(Row(f=1), Row(g=0)))",
    "Count(Difference(Row(f=2), Row(g=0)))",
    "TopN(f, Row(g=0), n=5, tanimoto=30)",
    "Min(Row(f=99), field=amount)",          # an empty filter
    "Max(Row(g=2), field=amount)",
    "GroupBy(Rows(g), Rows(f))",
    "GroupBy(Rows(g), aggregate=Sum(field=amount))",
)
MESH_ROWS = ("Row(f=3)", "Row(amount > 900000)")   # compared as words
MESH_TIMED = (Q32, TOPN_G, BSI_SEQ[0])
MESH_LIMIT = 1000              # (c)'s window, starting in the third block
# phase mesh's launches per card and kernel, for the kernels line
MESH_CARD_LAUNCHES: dict = {}
MESH_2D = (2, 2)               # (d)'s shard blocks x word blocks
MESH_2D_CALLS = (
    "Min(field=amount)",
    "Max(Row(g=1), field=amount)",
    "Min(Row(f=99), field=amount)",          # an empty filter
    "GroupBy(Rows(g), aggregate=Max(field=amount))",
    "Count(Shift(Row(f=1), n=524283))",      # across word 16384
)


def _mesh_limits(oracle: dict, n_shards: int) -> tuple[str, ...]:
    """(c)'s Limit as a Count, a bitmap and an Extract: a window of
    ``MESH_LIMIT`` of f row 1's bits whose offset passes the rows of the
    first two of the four blocks' ``n_shards // 4`` shards each."""
    per = n_shards // MESH_BLOCKS
    k = int(oracle["per_shard"]["counts"][:2 * per, 1].sum()) + 12345
    lim = f"Limit(Row(f=1), limit={MESH_LIMIT}, offset={k})"
    return (f"Count({lim})", lim,
            f"Extract({lim}, Rows(g), Rows(amount))")


def _mesh_holder_dir(data_dir: str, n: int, name: str = "mesh",
                     lo: int = 0) -> str:
    """A holder directory of phase mesh's own, ``CLUSTER_DIR/<name>``:
    ``bench``'s ``f``, ``g`` and ``amount`` over shards ``[lo, n)`` as
    phase 2 leaves them.  Snapshots are hard links (a holder replaces a
    snapshot by a new file, never in place); op-logs, which a holder
    appends to, and the metadata are copied."""
    import shutil
    src = os.path.join(data_dir, "bench")
    dst = os.path.join(CLUSTER_DIR, name, "bench")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    os.makedirs(dst)
    shutil.copy(os.path.join(src, ".meta"), dst)
    for field in ("f", "g", "amount"):
        shutil.copytree(os.path.join(src, field), os.path.join(dst, field),
                        ignore=lambda d, names: [
                            x for x in names if x.split(".")[0].isdigit()
                            and not lo <= int(x.split(".")[0]) < n])
    for d, _, files in os.walk(dst):
        for name in files:
            if name.isdigit():   # a snapshot: a link instead of the copy
                os.remove(os.path.join(d, name))
                os.link(os.path.join(src, os.path.relpath(d, dst), name),
                        os.path.join(d, name))
    return os.path.dirname(dst)


def _mesh_devices(device) -> tuple[list, int]:
    """Phase mesh's block devices and the number of cards among them: the
    ``MESH_BLOCKS`` blocks over ``n = min(cards, MESH_BLOCKS)`` cards in
    turn (``cuda:(i % n)``; four blocks of the one card on a one-card
    machine), or all on the CPU when ``device`` is the CPU."""
    import torch
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * MESH_BLOCKS, 0
    n = min(torch.cuda.device_count(), MESH_BLOCKS)
    return [torch.device("cuda", i % n) for i in range(MESH_BLOCKS)], n


def _per_card(by_card: dict, key: str = "ms") -> str:
    return ", ".join(f"{c} {v[key]:.3f}" for c, v in sorted(by_card.items()))


def mesh_phase(holder, oracle: dict, cuda: bool, device,
               data_dir: str) -> dict:
    """Phase mesh: an executor over four blocks on the visible cards
    (:func:`_mesh_devices`; every plane of ``f``, ``g`` and ``amount`` in
    four shard blocks, each block launching on its own stream) behind its
    own REST server, beside
    an unmeshed executor of its own, both over a holder of the phase's
    own of bench's first ``MESH_SHARDS`` shards as phase 2 leaves them
    (a CUT, padded to 240).  Every parity request answers as the
    unmeshed executor does and, where the per-shard oracle knows the
    answer, as the oracle; two Row reads compare their words on the card; a Set
    and a value written then cleared are absorbed into the blocked
    overlays with no rebuild; an 8-thread burst fills a window above one;
    ``/status`` shows the mesh block; ``spmd.intersect_count`` and
    ``make_intersect_count_psum`` count f row 1 and g row 0 against the
    oracle.  Then (b) an executor over the same placement answers
    phase 7's ten time-range requests on all of ``events`` (phase 2's
    holder) against its oracle (read-only: phase 7 writes after it) over
    a blocked time plane; (c)
    ``Limit`` as a Count, a bitmap and an Extract, its window starting in
    the third block, against the unmeshed executor; (d) an executor over
    a 2x2 ``MeshPlacement2D`` over the same devices (two shard blocks, two
    word blocks) answers
    Min/Max, GroupBy Max, a Shift across its word blocks and (c)'s
    requests as the unmeshed one does.  The unmeshed answers are taken
    first; then the launch counters are reset, only the meshed executors
    and the spmd programs run until they are read, and every kernel must
    launch on this path, on every card.  Prints device ms per card per
    request, meshed beside unmeshed (the 2-D filtered Max among them; the
    recency range meshed, whose unmeshed figure is phase 7's), the
    copies' ms per card and peak memory per card; (e) with several cards
    a ``mesh = true`` server (:func:`_mesh_server`); closes each executor
    after its part, logging device memory.  Returns {"mesh": launches}
    (per card in ``MESH_CARD_LAUNCHES``)."""
    import torch
    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec.executor import _Ctx
    from pilosa_tpu_torch.obs import Stats
    from pilosa_tpu_torch.parallel import (MeshPlacement, MeshPlacement2D,
                                           local_placement, spmd)
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.store import Holder

    def memory(what: str) -> None:
        if cuda:
            log(f"mesh {what}: device memory allocated "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    t0 = time.perf_counter()
    n = min(MESH_SHARDS, len(oracle["per_shard"]["inter"]))
    log(f"CUT: phase mesh serves bench's first {n} shards in a holder of "
        "its own (a run passed 1000 s); (b) serves all of events")
    mholder = Holder(_mesh_holder_dir(data_dir, n)).open()
    # the per-shard oracle over those shards, with phase 2's Set (shard 0)
    ps, served = oracle["per_shard"], oracle["served"]
    counts = ps["counts"][:n].sum(0) + served["counts"] - oracle["counts"]
    filtered = (ps["filtered"][:n].sum(0) + served["filtered"]
                - oracle["filtered"])
    inter, union = int(ps["inter"][:n].sum()), int(ps["union"][:n].sum())
    expect = {Q32: [int(c) for c in counts],
              Q4: [int(counts[r]) for r in SELECTED],
              "TopN(f, n=5)": [_topn(counts, 5)],
              TOPN_G: [_topn(filtered, 5)],
              "Count(Intersect(Row(f=1), Row(g=0)))"
              "Count(Union(Row(f=1), Row(g=0)))": [inter, union]}
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    devs, n_cards = _mesh_devices(device)
    log(f"mesh: {n_cards} card(s) of {torch.cuda.device_count() if cuda else 0}"
        f" visible; the {MESH_BLOCKS} blocks on "
        f"{', '.join(str(d) for d in devs)}")
    if cuda:
        if n_cards > 1:
            peer = {f"cuda:{i}": [j for j in range(n_cards) if j != i
                                  and torch.cuda.can_device_access_peer(i, j)]
                    for i in range(n_cards)}
            log(f"mesh peer access (card -> peers it can read): "
                f"{json.dumps(peer)}")
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
    place = MeshPlacement(devs)
    stats = Stats()
    mex = _executor(mholder, placement=place, plane_budget=32 << 30,
                    max_concurrent=32, stats=stats)
    plain = _executor(mholder, device=device, plane_budget=32 << 30)
    mapi, papi = API(mholder, mex), API(mholder, plain)
    mclient, pclient = _Client(mapi, cuda), _Client(papi, cuda)
    server = Server(mapi, "127.0.0.1", 0).start()
    mclient.base = "http://%s:%d" % server.address
    index = mholder.index("bench")
    tex = dex = tclient = dclient = None
    try:
        # the unmeshed executor's answers first, so that the launches
        # counted below are the meshed path's alone
        for q, want in expect.items():
            pclient.ask(q, want, tag="plain " + q[:40])
        parity = {q: papi.query("bench", q)["results"] for q in MESH_PARITY}
        answers = {**expect, **parity}
        shards = mex._shards_for(index, None)
        n_real = len(index.available_shards())
        row_words = {q: plain._fused_bitmap(
            _Ctx(index, tuple(index.available_shards())), parse(q).calls[0])
            for q in MESH_ROWS}
        col = _clear_column(papi, "Row(f=5)")
        vcol = _clear_column(papi, f"Row(amount >= {BSI_MIN})")
        limits = _mesh_limits(oracle, len(shards))
        more = {q: papi.query("bench", q)["results"]
                for q in limits + MESH_2D_CALLS}
        if more[limits[0]] != [MESH_LIMIT]:
            raise AssertionError(f"unmeshed {limits[0]}: {more[limits[0]]}")

        cuda_kernels.reset_launches()
        # the oracle's requests (the first builds the planes: its seconds
        # are logged), then the parity requests against the unmeshed
        # answers
        for q, want in expect.items():
            t = time.perf_counter()
            mclient.ask(q, want, tag="mesh first " + q[:40])
            first_ms = (time.perf_counter() - t) * 1e3
            if first_ms > 1000:
                log(f"mesh first {q[:48]!r}: {first_ms:.0f} ms (builds)")
        for q, want in parity.items():
            mclient.ask(q, want, tag="mesh " + q[:40])
        got = mclient.post("/index/bench/query", Q4.encode(), "mesh REST")
        if got["results"] != expect[Q4]:
            raise AssertionError(f"mesh REST 4-Count: got {got}")
        for q, want in row_words.items():
            words = mex._fused_bitmap(_Ctx(index, shards),
                                      parse(q).calls[0]).full()
            if not (torch.equal(words[:n_real], want)
                    and not bool(words[n_real:].any())):
                raise AssertionError(f"mesh {q}: the blocked words differ")
        log(f"mesh parity: {len(expect)} oracle requests and "
            f"{len(MESH_PARITY)} more equal through both executors; "
            f"{len(MESH_ROWS)} Row reads equal word for word; "
            f"{len(shards)} shards ({len(shards) - n_real} padding) in "
            f"{MESH_BLOCKS} blocks")

        # a Set and a value, written and cleared: absorbed, no rebuild
        planes = mex.planes
        builds, absorbs = planes.builds, planes.delta_absorbs
        c5 = expect[Q32][5]
        total, cnt = (answers[BSI_SEQ[0]][0][k] for k in ("value", "count"))
        for q, want in ((f"Set({col}, f=5)", [True]),
                        ("Count(Row(f=5))", [c5 + 1]),
                        (f"Set({vcol}, amount=777)", [True]),
                        (BSI_SEQ[0], _vc(total + 777, cnt + 1)),
                        (f"Clear({col}, f=5)", [True]),
                        (f"Clear({vcol}, amount=0)", [True]),
                        ("Count(Row(f=5))", [c5]),
                        (BSI_SEQ[0], answers[BSI_SEQ[0]]),
                        (TOPN_G, expect[TOPN_G])):
            mclient.ask(q, want, tag="mesh write " + q[:30])
        if planes.builds != builds or planes.delta_absorbs < absorbs + 2:
            raise AssertionError(
                f"the mesh writes were not absorbed: builds {builds} -> "
                f"{planes.builds}, absorbs {absorbs} -> "
                f"{planes.delta_absorbs}")

        # an 8-thread burst: windows must hold more than one item
        b0 = mex.serving_stats()
        run = burst(mapi, answers, 8, 4)
        b1 = mex.serving_stats()
        windows = b1["windows"] - b0["windows"]
        items = b1["items"] - b0["items"]
        coll = stats.histogram_summary("mesh_collective_seconds")
        log(f"mesh burst 8 x 4: {run['requests']} requests in "
            f"{run['wall']:.3f} s = {run['requests'] / run['wall']:.1f} "
            f"requests/s; {windows} windows, {items} items "
            f"({items / max(1, windows):.2f} per window); "
            f"mesh_collective_seconds {json.dumps(coll)}")
        if items <= windows or not coll:
            raise AssertionError("the mesh burst's windows never held more "
                                 "than one item")
        with urllib.request.urlopen(mclient.base + "/status",
                                    timeout=60) as resp:
            mesh = json.loads(resp.read())["mesh"]
        log(f"mesh /status: {json.dumps(mesh)}")
        pads = len(shards) - n_real
        if (mesh["devices"] != MESH_BLOCKS or not pads
                or mesh["paddedShards"] % pads or not mesh["paddedShards"]
                or sorted(mesh["perDeviceBytes"])
                != sorted({str(d) for d in devs})):
            raise AssertionError(f"the /status mesh block: {mesh}")

        # (c) Limit ranked over the four blocks, as a Count, a bitmap and
        # an Extract
        for q in limits:
            mclient.ask(q, more[q], tag="mesh limit " + q[:30])
        log(f"mesh (c): {limits[1]} as a Count, a bitmap and an Extract "
            "equal to the unmeshed answers")

        # (b) time ranges over a blocked time plane, read-only
        memory("(b) before")
        tex = _executor(holder, placement=place, plane_budget=32 << 30)
        tclient = _Client(API(holder, tex), cuda)
        ev_expect = oracle["events"]["expect"]
        t = time.perf_counter()
        tclient.ask(EV_SEQ[0], ev_expect[EV_SEQ[0]], tag="mesh time first",
                    index="events")
        first_ms = (time.perf_counter() - t) * 1e3
        for q in EV_SEQ:
            tclient.ask(q, ev_expect[q], tag="mesh time " + EV_NAMES[q],
                        index="events")
        status = tex.time_status()
        (tp,) = status["planes"]
        if (status["rangesServed"]["span"]
                or not status["rangesServed"]["plane"]
                or sum(tp["perDeviceBytes"].values()) != tp["bytes"]):
            raise AssertionError(f"mesh time status: {json.dumps(status)}")
        log(f"mesh (b): the {len(EV_SEQ)} time-view requests equal the "
            f"oracle over a blocked time plane of {tp['bytes'] / 1e9:.2f} GB "
            f"({tp['shards']} shards x {tp['buckets']} buckets x "
            f"{tp['rows']} rows in {MESH_BLOCKS} blocks, "
            f"{tp['bytes'] / MESH_BLOCKS / 1e9:.2f} GB each; per device "
            f"{json.dumps(tp['perDeviceBytes'])}), built in the first "
            f"request: {first_ms:.0f} ms; ranges served "
            f"{json.dumps(status['rangesServed'])}")
        memory("(b) time plane resident")
        if cuda:
            q = EV_SEQ[0]
            cards: dict = {}
            dev_ms, _, top = traced(
                lambda: tclient.ask(q, ev_expect[q], tag="traced",
                                    index="events"), "mesh recency", cards)
            log(f"mesh device ms {EV_NAMES[q]!r}: per card "
                f"{_per_card(cards)} ms meshed ({MESH_BLOCKS} blocks on "
                f"{n_cards} card(s); copies {_per_card(cards, 'copy_ms')} "
                f"ms; phase 7's 'events device ms' line is the unmeshed "
                f"executor's); by kernel, all cards: {top}")
        tex.close()
        tex.planes.invalidate()
        tex = None
        memory("(b) closed")

        # (d) a 2x2 (shard, words) placement: the descent steps sum over
        # each shard's two word blocks, the Shift carries across them
        memory("(d) before")
        place2 = MeshPlacement2D(devs, shard_size=MESH_2D[0],
                                 words_size=MESH_2D[1])
        dex = _executor(mholder, placement=place2, plane_budget=32 << 30)
        dclient = _Client(API(mholder, dex), cuda)
        for q in MESH_2D_CALLS + limits:
            t = time.perf_counter()
            dclient.ask(q, more[q], tag="mesh 2d " + q[:30])
            log(f"mesh 2d {q[:56]!r}: {(time.perf_counter() - t) * 1e3:.1f} "
                "ms (first)")
        log(f"mesh (d): {len(MESH_2D_CALLS) + len(limits)} requests over "
            f"{MESH_2D[0]}x{MESH_2D[1]} blocks "
            f"({len(dex._shards_for(index, None))} shards) equal to the "
            "unmeshed answers")
        memory("(d) planes resident")

        # the spmd programs over two resident rows, against the oracle
        a = planes.row_words("bench", index.field("f"), "standard", 1,
                             shards)
        b = planes.row_words("bench", index.field("g"), "standard", 0,
                             shards)
        got = (int(spmd.intersect_count(a, b)),
               int(spmd.make_intersect_count_psum(place)(a, b)))
        if got != (inter,) * 2:
            raise AssertionError(f"spmd intersect counts {got}, want "
                                 f"{inter}")
        launched = dict(cuda_kernels.LAUNCHES)
        by_card = {f"cuda:{i}": k for i, k in
                   cuda_kernels.launches_by_device().items()}
        del a, b, words, want, row_words
        log(f"mesh launches: {json.dumps(launched)}; per card "
            f"{json.dumps(by_card)}; spmd intersect counts equal to the "
            f"oracle ({inter})")
        if cuda:
            for k, v in launched.items():
                if v < 1:
                    raise AssertionError(f"the mesh path never launched {k}")
            for i in range(n_cards):
                if not any(by_card.get(f"cuda:{i}", {}).values()):
                    raise AssertionError(f"no block launched on cuda:{i}")
            log("mesh peak device memory per card: " + ", ".join(
                f"cuda:{i} {torch.cuda.max_memory_allocated(i) / 1e9:.2f} GB"
                for i in range(n_cards)))
            # device ms per request, meshed beside unmeshed (a finding:
            # four blocks on one card, the same bytes read)
            # (per card: a sum over cards is no share of one card's time)
            for c2, q, want, name in (
                    *((mclient, q, answers[q], f"{MESH_BLOCKS} blocks")
                      for q in MESH_TIMED),
                    (dclient, MESH_2D_CALLS[1], more[MESH_2D_CALLS[1]],
                     f"{MESH_2D[0]}x{MESH_2D[1]} blocks")):
                cards, plain_cards = {}, {}
                ms = [traced(lambda: c.ask(q, want, tag="traced"),
                             f"mesh {q[:30]}", by)[::2]
                      for c, by in ((c2, cards), (pclient, plain_cards))]
                log(f"mesh device ms {q[:40]!r}: per card "
                    f"{_per_card(cards)} ms over {name} on {n_cards} "
                    f"card(s) (copies {_per_card(cards, 'copy_ms')} ms) "
                    f"beside {_per_card(plain_cards)} ms unmeshed; by "
                    f"kernel, meshed (all cards): {ms[0][1]}; unmeshed: "
                    f"{ms[1][1]}")
        memory("(d) and the 4-block executor resident")
        if cuda:
            _mesh_server(data_dir, n, answers, n_cards)
    finally:
        server.close()
        for ex in (mex, plain, tex, dex):
            if ex is not None:
                ex.close()
                ex.planes.invalidate()  # their planes go now, whoever holds
        mholder.close()
        import shutil
        for name in ("mesh", "mesh_server"):
            shutil.rmtree(os.path.join(CLUSTER_DIR, name), ignore_errors=True)
    del server, mex, plain, mapi, papi, mclient, pclient, tclient, dclient
    if cuda:
        import gc
        gc.collect()
        log(f"mesh executors closed: device memory allocated "
            f"{mem0 / 1e9:.2f} GB before the phase, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after")
    log(f"phase mesh: {time.perf_counter() - t0:.1f}s")
    MESH_CARD_LAUNCHES.update(by_card)
    return {"mesh": launched}


def _mesh_server(data_dir: str, n: int, answers: dict, n_cards: int) -> None:
    """(e) A server booted as an operator boots one, with ``mesh = true``:
    on several cards ``local_placement()`` spans every one of them, and
    the phase's oracle and parity requests answer exactly through it, in
    process and over REST; on one card it serves unmeshed, as the
    reference's does."""
    import torch
    from pilosa_tpu_torch.cli.config import Config
    from pilosa_tpu_torch.parallel import local_placement
    from pilosa_tpu_torch.server import PilosaTPUServer
    cards = torch.cuda.device_count()
    if cards < 2:
        if local_placement() is not None:
            raise AssertionError("local_placement() meshed one card")
        log("mesh (e): one card: local_placement() is None, so a server "
            "booted with mesh = true serves unmeshed, as the reference's")
        return
    t = time.perf_counter()
    srv = PilosaTPUServer(Config(
        bind="127.0.0.1:0", data_dir=_mesh_holder_dir(data_dir, n,
                                                      "mesh_server"),
        plane_budget_bytes=32 << 30, plane_sidecars=False,
        scrub_bytes_per_second=0, mesh=True)).open()
    try:
        boot_s = time.perf_counter() - t
        client = _Client(srv.api, True)
        client.base = f"http://127.0.0.1:{srv.port}"
        for q, want in answers.items():
            client.ask(q, want, tag="mesh server " + q[:30])
        got = client.post("/index/bench/query", Q4.encode(),
                          "mesh server REST")
        if got["results"] != answers[Q4]:
            raise AssertionError(f"mesh server REST 4-Count: got {got}")
        with urllib.request.urlopen(client.base + "/status",
                                    timeout=60) as resp:
            mesh = json.loads(resp.read())["mesh"]
        want_cards = sorted(f"cuda:{i}" for i in range(cards))
        if (mesh["devices"] != cards
                or sorted(mesh["perDeviceBytes"]) != want_cards):
            raise AssertionError(f"the mesh = true server's /status mesh "
                                 f"block: {mesh}")
        log(f"mesh (e): a server booted with mesh = true spans {cards} "
            f"cards (of them {n_cards} in the phase's placements): "
            f"{len(answers)} requests equal in process and the 4-Count over "
            f"REST; booted in {boot_s:.1f} s, requests "
            f"{time.perf_counter() - t - boot_s:.1f} s; /status mesh "
            f"{json.dumps(mesh)}")
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# phase procs: serving across processes
# ---------------------------------------------------------------------------

PROCS_TIMEOUT_S = 300          # each child's limit: boot, builds, cluster
PROCS_TOPN = 5
# the requests whose device ms the children trace: program -> collective
PROCS_TRACED = ("intersect psum (all-reduce)", "topn (all-gather)",
                "bsi sum psum (3 all-reduces)")
PROCS_CARD_LAUNCHES: dict = {}   # "p<rank> cuda:<card>" -> launches


def _procs_layout(device) -> tuple[int, list[list[int]]]:
    """Phase procs' process count and each process's cards: two processes
    over the two halves of the first ``min(cards, 4)`` cards when there
    are two or more (2 + 2 on a four-card host), one over the one card
    otherwise (NCCL refuses two ranks on one card); two CPU processes
    (gloo) when ``device`` is the CPU."""
    import torch
    if device is not None and torch.device(device).type == "cpu":
        return 2, [[], []]
    use = min(torch.cuda.device_count(), MESH_BLOCKS)
    if use < 2:
        return 1, [[0]]
    half = use // 2
    return 2, [list(range(half)), list(range(half, 2 * half))]


def procs_phase(data_dir: str, oracle: dict, device=None) -> dict:
    """Phase procs: ``P`` port processes (:func:`_procs_layout`) in one
    ``torch.distributed`` group, each its own server booted with the
    coordinator keys (``mesh = false``, ``cluster_enabled``, anti-entropy
    off).  Phase mesh's ``MESH_SHARDS`` shards of ``bench``, padded to a
    multiple of ``MESH_BLOCKS``, split into ``P`` contiguous ranges;
    each process holds hard links to its own range's ``f``, ``g`` and
    ``amount`` snapshots only, reads its rows through an executor of its
    own and runs every ``parallel.spmd`` program over a
    :class:`~pilosa_tpu_torch.parallel.multiproc.ProcessPlacement` of
    ``MESH_BLOCKS / P`` local blocks on its cards (:func:`procs_child`).
    The children's answers must be equal to each other and to the
    per-shard oracle; ``intersect_count``, ``row_counts`` and ``count``
    must launch in every child on a card.  Returns {"procs": the
    children's launches summed}."""
    from pilosa_tpu_torch.parallel.mesh import PAD_SHARD
    from pilosa_tpu_torch.testing import free_ports, run_processes

    t0 = time.perf_counter()
    cuda = device is None
    n = min(MESH_SHARDS, len(oracle["per_shard"]["inter"]))
    P, cards = _procs_layout(device)
    if P == 1:
        log("CUT: phase procs runs one process (a world of 1 over NCCL) on "
            "this one-card machine: no traffic ran between processes "
            "(NCCL refuses two ranks on one card)")
    padded = list(range(n)) + [PAD_SHARD] * (-n % MESH_BLOCKS)
    per = len(padded) // P
    owns = [padded[p * per:(p + 1) * per] for p in range(P)]
    ps, served = oracle["per_shard"], oracle["served"]
    counts = ps["counts"][:n].sum(0) + served["counts"] - oracle["counts"]
    filtered = (ps["filtered"][:n].sum(0) + served["filtered"]
                - oracle["filtered"])
    bsi_ps = oracle["bsi"]["per_shard"]
    want = {"intersect": int(ps["inter"][:n].sum()),
            "union": int(ps["union"][:n].sum()),
            "topn": _topn(filtered, PROCS_TOPN),
            "bsi": [int(bsi_ps["sum"][:n].sum()),
                    int(bsi_ps["cnt"][:n].sum())],
            "cluster": [4]}
    cport, *ports = free_ports(P + 1)
    base = os.path.join(CLUSTER_DIR, "procs")
    argv, env = [], []
    for p, own in enumerate(owns):
        real = [s for s in own if s != PAD_SHARD]
        hdir = _mesh_holder_dir(data_dir, real[-1] + 1, f"procs/h{p}",
                                lo=real[0])
        cdir = os.path.join(base, f"c{p}")
        os.makedirs(cdir)
        argv.append([json.dumps({
            "rank": p, "size": P, "coord": f"127.0.0.1:{cport}",
            "ports": ports, "holder": hdir, "data": cdir, "barrier": base,
            "shards": own, "blocks": MESH_BLOCKS // P,
            "device": "cpu" if not cuda else ""})])
        env.append({"CUDA_VISIBLE_DEVICES": ",".join(map(str, cards[p]))}
                   if cuda else {})
    log(f"procs: {P} process(es), cards {cards if cuda else 'none (gloo)'}, "
        f"{MESH_BLOCKS // P} local blocks each; shards {len(padded)} "
        f"({len(padded) - n} padding), {per} per process")
    try:
        outs = run_processes(
            "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.procs_child(sys.argv[2]))",
            [[REPO, *a] for a in argv], PROCS_TIMEOUT_S, env)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    results = []
    for p, (out, _) in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("PROCS "):
                results.append(json.loads(line[6:]))
            else:
                log(f"procs p{p}: {line}")
    if len(results) != P:
        raise AssertionError(f"procs: {len(results)} of {P} children "
                             "printed their answers")
    answers = [r["answers"] for r in results]
    if any(a != answers[0] for a in answers):
        raise AssertionError(f"procs: the children's answers differ: "
                             f"{answers}")
    got = answers[0]
    delta = sum(r["ingest_delta"] for r in results)
    checks = {
        "intersect_count": want["intersect"],
        "intersect_psum": want["intersect"],
        "intersect_psum2d": want["intersect"],
        "union_count": want["union"],
        "topn": want["topn"], "topn_psum": want["topn"],
        "topn_psum2d": want["topn"],
        "bsi_bit_counts": want["bsi"], "bsi_sum_psum": want["bsi"],
        "ingest_count": int(counts[1]) + delta, "cluster": want["cluster"]}
    for k, w in checks.items():
        if got[k] != w:
            raise AssertionError(f"procs {k}: got {got[k]}, want {w}")
    for p, r in enumerate(results):
        real = [s for s in owns[p] if s != PAD_SHARD]
        local = [int(ps["counts"][real, 1].sum()),
                 int(ps["inter"][real].sum())]
        if r["local"] != local:
            raise AssertionError(f"procs p{p}: its own Counts {r['local']}, "
                                 f"want {local}")
    launched: dict = {}
    for p, r in enumerate(results):
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
        for card, by in r["by_card"].items():
            PROCS_CARD_LAUNCHES[f"p{p} {card}"] = by
        if cuda:
            for k in ("intersect_count", "row_counts", "count"):
                if r["launches"].get(k, 0) < 1:
                    raise AssertionError(f"procs p{p} never launched {k}")
    log(f"procs: every answer of the {P} process(es) equal to each other "
        f"and to the oracle: intersect {got['intersect_count']} (1-D, "
        f"psum, 2-D), union {got['union_count']}, filtered TopN "
        f"{json.dumps(got['topn'])}, amount's sum and count "
        f"{got['bsi_sum_psum']}, {got['ingest_count']} bits after the "
        f"ingest step (+{delta}), the cluster's Count(Row(f=1)) "
        f"{got['cluster']} through every node; launches summed "
        f"{json.dumps(launched)}")
    log(f"phase procs: {time.perf_counter() - t0:.1f}s")
    return {"procs": launched}


def procs_only(data_dir: str, oracle: dict) -> dict:
    """Phase 2's write (``Set(free_col, f=3)``, which the oracle's served
    state holds) through an executor of its own, then phase procs."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.store import Holder
    holder = Holder(data_dir).open()
    executor = _executor(holder, plane_budget=32 << 30)
    try:
        got = API(holder, executor).query(
            "bench", f"Set({oracle['free_col']}, f=3)")["results"]
        if got != [True]:
            raise AssertionError(f"phase 2's Set answered {got}")
    finally:
        executor.close()
    t = time.perf_counter()
    log("== phase procs: serving across processes ==")
    launches = procs_phase(data_dir, oracle)
    phase_done("phase procs", t)
    return launches


def procs_child(arg: str) -> int:
    """One process of phase procs (``arg``: its JSON from
    :func:`procs_phase`).  Boots the port's server with the coordinator
    keys, runs one collective first, opens its own shard range of
    ``bench`` in a holder and executor of its own (the server's holder
    stays apart: a cluster join's resize would move half of each
    process's fragments to the other), reads f row 1, g row 0, f's plane
    and amount's bit plane through the executor's planes, and runs every
    ``parallel.spmd`` program over its ``ProcessPlacement``; on a card
    traces three of them, then asks its own executor two Counts and runs
    the HTTP cluster over the group (``testing.cluster_over_group``).
    Prints its lines, then ``PROCS <JSON>``."""
    import torch
    from pilosa_tpu_torch import testing
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.cli.config import Config
    from pilosa_tpu_torch.engine import bsi as bsik
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.parallel import (MeshPlacement, MeshPlacement2D,
                                           multiproc, spmd)
    from pilosa_tpu_torch.parallel.mesh import PAD_SHARD
    from pilosa_tpu_torch.server import PilosaTPUServer
    from pilosa_tpu_torch.store import Holder

    a = json.loads(arg)
    rank, size, ports = a["rank"], a["size"], a["ports"]
    t0 = time.perf_counter()
    srv = PilosaTPUServer(Config(
        bind=f"127.0.0.1:{ports[rank]}", data_dir=a["data"],
        jax_coordinator=a["coord"], jax_num_processes=size,
        jax_process_id=rank, mesh=False, cluster_enabled=True,
        seeds=[f"127.0.0.1:{ports[0]}"] if rank else [],
        heartbeat_interval=1.0, anti_entropy_interval=0.0,
        plane_sidecars=False, scrub_bytes_per_second=0,
        device=a["device"])).open()
    holder = ex = None
    try:
        group = srv.group
        cuda = group.device.type == "cuda"
        # the collective first, while every process stands at the same
        # point (the reference's order)
        one = group.sum(torch.ones(1, dtype=torch.int32,
                                   device=group.device))
        if int(one) != size:
            raise AssertionError(f"the first all-reduce gave {int(one)}")
        print(f"booted in {time.perf_counter() - t0:.1f} s: "
              f"{group}", flush=True)
        n_cards = torch.cuda.device_count() if cuda else 0
        devs = ([torch.device("cuda", i % n_cards)
                 for i in range(a["blocks"])] if cuda
                else [torch.device("cpu")] * a["blocks"])
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
        place = multiproc.ProcessPlacement(MeshPlacement(devs), group)
        place2 = multiproc.ProcessPlacement(
            MeshPlacement2D(devs, len(devs) // 2, 2), group)
        own = tuple(a["shards"])
        holder = Holder(a["holder"]).open()
        ex = _executor(holder, device=a["device"] or None,
                       plane_budget=32 << 30)
        index = holder.index("bench")
        t = time.perf_counter()
        f1 = ex.planes.row_words("bench", index.field("f"), "standard", 1,
                                 own)
        g0 = ex.planes.row_words("bench", index.field("g"), "standard", 0,
                                 own)
        fps = ex.planes.field_plane("bench", index.field("f"), "standard",
                                    own)
        amount = ex.planes.bsi_plane("bench", index.field("amount"),
                                     own).plane
        print(f"process-local rows of {len(own)} shards read in "
              f"{time.perf_counter() - t:.1f} s (f's plane "
              f"{fps.plane.nbytes / 1e9:.2f} GB, amount's "
              f"{amount.nbytes / 1e9:.2f} GB)", flush=True)
        cuda_kernels.reset_launches()
        ta, tb = place.place_local(f1), place.place_local(g0)
        plane, bsi = place.place_local(fps.plane), place.place_local(amount)
        row_ids = [int(r) for r in fps.row_ids]

        def top(vs):
            vals, slots = (x.cpu().tolist() for x in vs)
            return [{"id": row_ids[s], "count": v}
                    for v, s in zip(vals, slots) if v > 0]

        def bsi_sum(counts):
            return list(bsik.combine_sum(*(x.cpu() for x in counts)))

        W = f1.shape[-1]
        idx = np.full((len(own), 1), W, np.int64)
        mask = np.zeros((len(own), 1), np.uint32)
        host = f1.cpu().numpy().view(np.uint32)
        delta = 0
        for i, s in enumerate(own):
            if s != PAD_SHARD:
                idx[i, 0] = s % W
                mask[i, 0] = 0xFFFFFFFF
                delta += 32 - int(np.unpackbits(
                    host[i, s % W:s % W + 1].view(np.uint8)).sum())
        words = spmd.make_ingest_step(place)(ta, idx, mask)
        answers = {
            "intersect_count": int(spmd.intersect_count(ta, tb)),
            "intersect_psum": int(spmd.make_intersect_count_psum(place)(
                ta, tb)),
            "intersect_psum2d": int(spmd.make_intersect_count_psum2d(
                place2)(f1, g0)),
            "union_count": int(spmd.union_count(ta, tb)),
            "topn": top(spmd.topn(plane, tb, PROCS_TOPN)),
            "topn_psum": top(spmd.make_topn_psum(place, PROCS_TOPN)(
                plane, tb)),
            "topn_psum2d": top(spmd.make_topn_psum2d(place2, PROCS_TOPN)(
                fps.plane, g0)),
            "bsi_bit_counts": bsi_sum(spmd.bsi_bit_counts(bsi, None)),
            "bsi_sum_psum": bsi_sum(spmd.make_bsi_sum_psum(place)(bsi,
                                                                  None)),
            "ingest_count": int(spmd.intersect_count(words, words)),
        }
        del words
        if cuda:
            for name, run in zip(PROCS_TRACED, (
                    lambda: spmd.make_intersect_count_psum(place)(ta, tb),
                    lambda: spmd.topn(plane, tb, PROCS_TOPN),
                    lambda: spmd.make_bsi_sum_psum(place)(bsi, None))):
                # one trace each, never retaken: every process must run
                # the same collectives
                rows, wall = device_times(run, TRACE_WARMUP)
                # the NCCL kernels (their "nccl:<op>" ranges repeat them)
                coll = sum(v for k, v in rows if k.startswith("ncclDev")
                           or k.startswith("ncclKernel"))
                kern = sum(v for k, v in rows if "nccl" not in k.lower())
                print(f"device ms {name}: collective {coll:.4f} ms, the "
                      f"rest {kern:.4f} ms ({len(devs)} local blocks), wall "
                      f"{wall:.3f} ms; by kernel: " + ", ".join(
                          f"{_short(k)} {v:.4f}" for k, v in rows[:5]),
                      flush=True)
        api = API(holder, ex)
        local = [api.query("bench", "Count(Row(f=1))")["results"][0],
                 api.query("bench", "Count(Intersect(Row(f=1), Row(g=0)))")
                 ["results"][0]]
        answers["cluster"] = testing.cluster_over_group(
            srv, size, a["barrier"])
        launches = dict(cuda_kernels.LAUNCHES)
        by_card = {f"cuda:{i}": k for i, k in
                   cuda_kernels.launches_by_device().items()}
        if cuda:
            print("peak device memory per card: " + ", ".join(
                f"cuda:{i} {torch.cuda.max_memory_allocated(i) / 1e9:.2f} GB"
                for i in range(n_cards)), flush=True)
        print(f"launches {json.dumps(launches)}; per card "
              f"{json.dumps(by_card)}; {time.perf_counter() - t0:.1f} s in "
              "all", flush=True)
        print("PROCS " + json.dumps({
            "answers": answers, "ingest_delta": delta, "local": local,
            "launches": launches, "by_card": by_card}), flush=True)
    finally:
        if ex is not None:
            ex.close()
        if holder is not None:
            holder.close()
        srv.close()
    return 0


def _clear_column(api, row: str) -> int:
    """A column of shard 0 outside ``row`` (asked through ``api``)."""
    for c in range(7, 1 << 20, 7919):
        got = api.query("bench", f"IncludesColumn({row}, column={c})")
        if got["results"] == [False]:
            return c
    raise AssertionError(f"no column of shard 0 outside {row}")


def ingest_phase(client, planes, batches: dict, cuda: bool, api,
                 clients: int = CLIENTS, passes: int = PASSES):
    """Phase 4; returns the kernel launches of its run and of the
    concurrent burst over the live overlay after the first batch."""
    import torch
    from pilosa_tpu_torch.engine import cuda_kernels

    def expect(counts, filtered):
        return {Q32: [int(c) for c in counts],
                Q4: [int(counts[r]) for r in SELECTED],
                TOPN_G: [_topn(filtered, 5)]}

    def import_batch(rows, cols, clear, want_changed, tag):
        body = json.dumps({"rowIDs": rows.tolist(),
                           "columnIDs": cols.tolist(),
                           "clear": clear}).encode()
        got = client.post("/index/bench/field/f/import", body, tag)
        if got != {"changed": want_changed}:
            raise AssertionError(f"import: got {got}, want "
                                 f"{{'changed': {want_changed}}}")

    lat0 = set(client.lat)
    builds0, absorbs0 = planes.builds, planes.delta_absorbs
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    adjust = None
    for k, (rows, cols, clear, changed, counts, filtered) in \
            enumerate(batches["batches"]):
        import_batch(rows, cols, clear, changed, "REST import")
        want = expect(counts, filtered)
        for pql, name in ((Q32, "32-Count"), (Q4, "4-Count"),
                          (TOPN_G, "filtered TopN")):
            client.ask(pql, want[pql], tag=f"{name}, first after import")
            client.ask(pql, want[pql], reps=3, tag=f"{name}, overlay")
        if k == 0:
            # one concurrent burst over the live overlay (base+delta in
            # rowcounts-delta, selcounts and the tree gather)
            part = dict(cuda_kernels.LAUNCHES)
            overlay = concurrent_phase(
                {"overlay": api},
                _mix_expect(counts, filtered, batches["first_trees"]),
                cuda, clients, passes, profile=False)["overlay"]
            cuda_kernels.reset_launches()
        if cuda and adjust is None and planes.delta_stats()["deltaCells"]:
            # the merge's device time beside the base scan, over a live
            # overlay
            rows_ms, wall = device_times(
                lambda: client.ask(Q32, want[Q32], reps=5,
                                   tag="32-Count, profiled"))
            cells = planes.delta_stats()["deltaCells"]
            adjust = (rows_ms, wall, cells)
    if planes.builds != builds0:
        raise AssertionError(f"an import batch rebuilt the plane: builds "
                             f"{builds0} -> {planes.builds}")
    absorbs = planes.delta_absorbs - absorbs0
    if absorbs < len(batches["batches"]):
        raise AssertionError(f"{absorbs} absorbs for "
                             f"{len(batches['batches'])} batches")
    if not planes.wait_compactions(300):
        raise AssertionError("the compactor did not finish")
    stats = planes.delta_stats()
    if stats["compactions"] < 1:
        raise AssertionError(f"no compaction completed: {stats}")
    fold_s = stats["lastCompactionSeconds"]
    for pql, ans in want.items():
        client.ask(pql, ans, tag="after the fold")
    log(f"after {len(batches['batches'])} batches: builds stayed "
        f"{planes.builds}, absorbs +{absorbs}, delta {json.dumps(stats)}")

    rows, cols, clear, changed, counts, filtered = batches["over_cap"]
    import_batch(rows, cols, clear, changed, "REST import, over cap")
    want = expect(counts, filtered)
    client.ask(Q32, want[Q32], tag="32-Count after the over-cap batch")
    planes.wait_builds()   # the rebuild runs beside the request
    if planes.builds != builds0 + 1:
        raise AssertionError(f"the over-cap batch did not rebuild once: "
                             f"builds {builds0} -> {planes.builds}")
    rebuild_s = planes.last_build_seconds
    for pql, ans in want.items():
        client.ask(pql, ans, tag="after the rebuild")
    launches = {k: v + part[k] for k, v in cuda_kernels.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    for tag in sorted(set(client.lat) - lat0):
        ts = client.lat[tag]
        log(f"latency {tag!r}: median {_median_ms(ts):.2f} ms over "
            f"{len(ts)} (first {ts[0] * 1e3:.2f} ms)")
    log(f"fold (compaction) {fold_s:.6f} s; rebuild after the over-cap "
        f"batch {rebuild_s:.2f} s; peak device memory in the phase "
        f"{peak / 1e9:.2f} GB")
    if adjust is not None:
        rows_ms, wall, cells = adjust
        scan = sum(v for k, v in rows_ms
                   if re.search(r"(^|::)row_counts_kernel", k))
        copies = sum(v for k, v in rows_ms if k.startswith("Memcpy"))
        other = sum(v for _, v in rows_ms) - scan - copies
        log(f"32-Count x5 over a {cells}-cell overlay under the profiler: "
            f"row_counts {scan:.3f} ms, merge adjustment {other:.3f} ms, "
            f"copies {copies:.3f} ms of {wall:.3f} ms wall; by kernel: "
            + ", ".join(f"{_short(k)} {v:.3f} ms" for k, v in rows_ms[:6]))
    log(f"launches in the ingest phase: {json.dumps(launches)}")
    for k in ("row_counts", "selected_row_counts"):
        if cuda and launches[k] < 1:
            raise AssertionError(f"ingest never launched the {k} kernel")
    return launches, overlay


# ---------------------------------------------------------------------------
# phase 5: BSI
# ---------------------------------------------------------------------------


def _kind_stats(b0: dict, b1: dict, kind: str) -> tuple[int, int, int]:
    """(family calls, items, largest group) of one batcher kind between
    two ``serving_stats()`` snapshots."""
    k0 = b0.get("kinds", {}).get(kind, {})
    k1 = b1.get("kinds", {}).get(kind, {})
    return (k1.get("groups", 0) - k0.get("groups", 0),
            k1.get("items", 0) - k0.get("items", 0), k1.get("maxItems", 0))


def bsi_phase(client, holder, planes, bsi: dict, cuda: bool, device,
              clients: int = CLIENTS, passes: int = PASSES) -> dict:
    """Phase 5 over ``amount``: the sequential requests through the
    default executor (each on the fast lane) and the "off" one, the
    device ms of each request beside its bound, a concurrent burst, and
    value imports over REST absorbed into the BSI overlay.  Returns the
    kernel launches of the sequential, concurrent and ingest runs."""
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    api = client.api
    ex = api.executor
    expect = bsi["expect"]
    index = holder.index("bench")
    field = index.field("amount")
    shards = tuple(index.available_shards())
    plane_bytes = len(shards) * BSI_ROWS * WORDS * 4
    out = {}

    t0 = time.perf_counter()
    builds = planes.builds
    client.ask(BSI_SEQ[0], expect[BSI_SEQ[0]], tag="BSI Sum, first")
    if planes.builds != builds + 1:
        raise AssertionError("the first Sum did not build the BSI plane")
    shape = list(planes.bsi_plane("bench", field, shards).plane.shape)
    log(f"BSI plane int32{shape} ({plane_bytes / 1e9:.2f} GB) built in "
        f"{planes.last_build_seconds:.2f}s ({time.perf_counter() - t0:.2f}s "
        "with the first Sum)")
    b0 = ex.serving_stats()
    cuda_kernels.reset_launches()
    for q in BSI_SEQ:
        client.ask(q, expect[q], reps=3, tag=f"BSI {BSI_NAMES[q]}")
    b1 = ex.serving_stats()
    hits = b1["fastLaneHits"] - b0["fastLaneHits"]
    if hits < 3 * 8:   # every request but Percentile and Distinct
        raise AssertionError(f"{hits} fast-lane hits for the 24 BSI "
                             "requests that go through the batcher")
    off = _executor(holder, device=device, plane_budget=32 << 30,
                    delta_compact_fraction=COMPACT_FRACTION,
                    count_batch_window="off", tree_fusion=False)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    for q in BSI_SEQ:
        offc.ask(q, expect[q], reps=2, tag=f"BSI off {BSI_NAMES[q]}")
    out["bsi"] = dict(cuda_kernels.LAUNCHES)
    log(f"BSI sequential: every answer equal to the oracle through both "
        f"configurations; {hits} fast-lane hits; launches "
        f"{json.dumps(out['bsi'])}")
    for q in BSI_SEQ:
        for c, cfg in ((client, "default"), (offc, "off")):
            ts = c.lat[f"BSI {'off ' if cfg == 'off' else ''}{BSI_NAMES[q]}"]
            log(f"latency BSI {BSI_NAMES[q]} [{cfg}]: median "
                f"{_median_ms(ts):.2f} ms over {len(ts)}")
    if cuda:
        for q in BSI_SEQ:
            reads = 2 if q.startswith("Sum") else 1
            b_ms = bound(reads * plane_bytes, 0)[0]
            dev_ms, wall_ms, top = device_busy_share(
                lambda: client.ask(q, expect[q], reps=3, tag="profiled"))
            log(f"BSI device ms {BSI_NAMES[q]}: {dev_ms / 3:.3f} ms per "
                f"request (bound {b_ms:.3f} ms = {reads} read(s) of the "
                f"plane; {dev_ms / 3 / b_ms:.1f}x), wall "
                f"{wall_ms / 3:.3f} ms; by kernel: {top}")
    log(f"phase 5 sequential wall: {time.perf_counter() - t0:.1f}s")

    t1 = time.perf_counter()
    b0 = ex.serving_stats()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    run = burst(api, expect, clients, passes, BSI_MIX, BSI_NAMES)
    out["bsi_concurrent"] = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    b1 = ex.serving_stats()
    reqs = run["requests"]
    log(f"[BSI] {clients} clients x {passes} passes: {reqs} requests in "
        f"{run['wall']:.3f} s = {reqs / run['wall']:.1f} requests/s; peak "
        f"device memory {peak / 1e9:.2f} GB")
    for q in BSI_MIX:
        ts = run["lat"][q]
        log(f"[BSI]   {BSI_NAMES[q]}: p50 {_pct_ms(ts, 0.5):.2f} ms, p90 "
            f"{_pct_ms(ts, 0.9):.2f} ms, p99 {_pct_ms(ts, 0.99):.2f} ms, "
            f"max {max(ts) * 1e3:.2f} ms over {len(ts)}")
    for kind in ("sum", "minmax", "bsirange"):
        groups, items, largest = _kind_stats(b0, b1, kind)
        log(f"[BSI]   {kind}: {groups} windows, {items} items "
            f"({items / max(1, groups):.2f} per window, largest {largest})")
        if largest < 2:
            raise AssertionError(f"the {kind} kind never coalesced")
    log(f"[BSI]   launches per request: " + json.dumps(
        {k: round(v / reqs, 4) for k, v in out["bsi_concurrent"].items()
         if v}))
    if cuda:
        dev_ms, wall_ms, top = device_busy_share(
            lambda: burst(api, expect, clients, max(1, passes // 3),
                          BSI_MIX, BSI_NAMES))
        log(f"[BSI]   one burst of {clients} x {max(1, passes // 3)} under "
            f"the profiler: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms "
            f"wall = {dev_ms / wall_ms:.1%}; by kernel: {top}")
    log(f"phase 5 concurrent wall: {time.perf_counter() - t1:.1f}s")

    t2 = time.perf_counter()
    builds0, absorbs0 = planes.builds, planes.delta_absorbs
    compactions0 = planes.delta_stats()["compactions"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()

    def import_values(cols, vals, want_changed, tag):
        body = json.dumps({"columnIDs": cols.tolist(),
                           "values": vals.tolist()}).encode()
        got = client.post("/index/bench/field/amount/importValue", body, tag)
        if got != {"changed": want_changed}:
            raise AssertionError(f"importValue: got {got}, want "
                                 f"{{'changed': {want_changed}}}")

    for cols, vals, changed, want in bsi["batches"]:
        import_values(cols, vals, changed, "REST importValue")
        for q in BSI_INGEST:
            client.ask(q, want[q], tag=f"BSI {q}, after importValue")
    if planes.builds != builds0:
        raise AssertionError(f"a value batch rebuilt the BSI plane: builds "
                             f"{builds0} -> {planes.builds}")
    absorbs = planes.delta_absorbs - absorbs0
    if absorbs < len(bsi["batches"]):
        raise AssertionError(f"{absorbs} absorbs for "
                             f"{len(bsi['batches'])} value batches")
    if not planes.wait_compactions(300):
        raise AssertionError("the compactor did not finish")
    stats = planes.delta_stats()
    if stats["compactions"] <= compactions0:
        raise AssertionError(f"no BSI overlay fold completed: {stats}")
    for q in BSI_INGEST:
        client.ask(q, want[q], tag="BSI after the fold")
    log(f"BSI ingest: {len(bsi['batches'])} batches of {VALUE_BATCH} "
        f"values, builds stayed {planes.builds}, absorbs +{absorbs}, folds "
        f"+{stats['compactions'] - compactions0}, last fold "
        f"{stats['lastCompactionSeconds']:.6f} s; delta {json.dumps(stats)}")
    cols, vals, changed, want = bsi["over_cap"]
    import_values(cols, vals, changed, "REST importValue, over cap")
    client.ask(BSI_INGEST[0], want[BSI_INGEST[0]],
               tag="BSI Sum after the over-cap batch")
    if planes.builds != builds0 + 1:
        raise AssertionError(f"the over-cap batch did not rebuild once: "
                             f"builds {builds0} -> {planes.builds}")
    log(f"BSI rebuild after the {VALUE_OVER_CAP}-value batch: "
        f"{planes.last_build_seconds:.2f} s")
    for q in BSI_INGEST:
        client.ask(q, want[q], tag="BSI after the rebuild")
    out["bsi_ingest"] = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for tag in ("REST importValue", "REST importValue, over cap"):
        ts = client.lat[tag]
        log(f"latency {tag!r}: median {_median_ms(ts):.2f} ms over {len(ts)}")
    for q in BSI_INGEST:
        ts = client.lat[f"BSI {q}, after importValue"]
        log(f"latency BSI {q} after importValue (absorbs, overlay): median "
            f"{_median_ms(ts):.2f} ms, first {ts[0] * 1e3:.2f} ms")
    log(f"BSI ingest launches {json.dumps(out['bsi_ingest'])}; peak device "
        f"memory in the phase {peak / 1e9:.2f} GB")
    log(f"phase 5 ingest wall: {time.perf_counter() - t2:.1f}s")
    if cuda:
        for path in ("bsi", "bsi_concurrent", "bsi_ingest"):
            for k in ("row_counts", "count"):
                if out[path][k] < 1:
                    raise AssertionError(f"the BSI path {path} never "
                                         f"launched {k}")
    return out


# ---------------------------------------------------------------------------
# phase 6: GroupBy
# ---------------------------------------------------------------------------

# the reference benches' GroupBy shapes (config10/14, config7's tree at
# two levels, config30/31, the Min/Max aggregate, the v2 paging surface)
GB_SEQ = ("GroupBy(Rows(f, limit=4), Rows(f, previous=3, limit=4))",
          "GroupBy(Rows(g), Rows(f))",
          "GroupBy(Rows(f), aggregate=Sum(field=amount))",
          "GroupBy(Rows(g), filter=Row(f=1), aggregate=Max(field=amount))")
GB_PAGED = ("GroupBy(Rows(g), Rows(f), having=Condition(count > {n}), "
            "limit=20, previous=[0, 3])")
GB_NAMES = dict(zip(GB_SEQ, ("4x4", "g x f", "Sum by f", "filtered Max by g")))
_MASK20 = (1 << 20) - 1


def _groupby_shard(s: int, seed: int, f: np.ndarray, g: np.ndarray,
                   c_off: np.ndarray, c_final: np.ndarray,
                   p_off: np.ndarray) -> dict:
    """Shard ``s``'s part of the GroupBy oracle over ``amount`` as phase 5
    left it (``c_final``: the values of the candidate offsets ``c_off``,
    ``_EMPTY`` = none), and the values at the offsets ``p_off``."""
    exists, vals = _bsi_values(seed, s)
    exists[c_off] = c_final != _EMPTY
    vals = vals.astype(np.int64)
    vals[c_off] = np.where(exists[c_off], c_final, 0)
    mag = np.abs(vals)
    mag_rows = np.stack([_pack((mag >> b) & 1 == 1)
                         for b in range(BSI_DEPTH)])            # [20, W]
    fs, gs = f[s], g[s]
    # Sum by f row from packed bit counts, as the BSI plane holds them
    weights = np.int64(1) << np.arange(BSI_DEPTH, dtype=np.int64)
    sums = np.zeros(ROWS, np.int64)
    for sign, cols in ((1, exists & (vals >= 0)), (-1, exists & (vals < 0))):
        part = fs & _pack(cols)
        sums += sign * (_popcounts(part[:, None, :] & mag_rows[None])
                        * weights).sum(-1)
    f1 = _bits(fs[1])
    maxes = []
    for k in range(4):
        m = _bits(gs[k]) & f1 & exists
        best = int(vals[m].max()) if m.any() else None
        maxes.append(None if best is None
                     else (best, int((vals[m] == best).sum())))
    return {"rows": _popcounts(fs), "sums": sums, "maxes": maxes,
            "f1_g": _popcounts(gs & fs[1]),
            "g_f": _popcounts(gs[:, None, :] & fs[None]),
            "f_f": _popcounts(fs[:4, None, :] & fs[None, 4:8]),
            "at": np.where(exists[p_off], vals[p_off], 0)}


def _gb_json(fields: tuple, combos, counts, aggs=None) -> list:
    """The GroupBy JSON of the combinations with a non-zero count."""
    out = []
    for i, combo in enumerate(combos):
        if counts[i] > 0:
            grp = {"group": [{"field": fl, "rowID": int(r)}
                             for fl, r in zip(fields, combo)],
                   "count": int(counts[i])}
            if aggs is not None and aggs[i] is not None:
                grp["agg"] = int(aggs[i])
            out.append(grp)
    return out


def _gb_expect(st: dict) -> dict:
    """The five requests' answers from the oracle state ``st``."""
    ff = [(a, b) for a in range(4) for b in range(4, 8)]
    gf = [(k, r) for k in range(4) for r in range(ROWS)]
    pairs = _gb_json(("g", "f"), gf, st["g_f"].reshape(-1))
    out = {GB_SEQ[0]: [_gb_json(("f", "f"), ff, st["f_f"].reshape(-1))],
           GB_SEQ[1]: [pairs],
           GB_SEQ[2]: [_gb_json(("f",), [(r,) for r in range(ROWS)],
                                st["rows"], st["sums"])],
           GB_SEQ[3]: [_gb_json(("g",), [(k,) for k in range(4)],
                                st["f1_g"], [m and m[0]
                                             for m in st["maxes"]])]}
    paged = [p for p in pairs if p["count"] > st["median"]
             and (p["group"][0]["rowID"], p["group"][1]["rowID"]) > (0, 3)]
    out[st["paged"]] = [paged[:20]]
    return out


def make_groupby(f: np.ndarray, g: np.ndarray, shards: int, seed: int,
                 bsi: dict) -> dict:
    """Phase 6's oracle over ``f`` as phase 4 left it and ``amount`` as
    phase 5 left it, its import batches and the answers after each."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    cand, final = bsi["final"]
    rng = np.random.default_rng(seed + 3)
    rows, cols = _distinct_pairs(rng, BATCH, shards)
    ucols = np.unique(cols)
    cb = np.searchsorted(cand, np.arange(shards + 1) << 20)
    pb = np.searchsorted(ucols, np.arange(shards + 1) << 20)
    st = {"rows": np.zeros(ROWS, np.int64), "sums": np.zeros(ROWS, np.int64),
          "f1_g": np.zeros(4, np.int64), "g_f": np.zeros((4, ROWS), np.int64),
          "f_f": np.zeros((4, 4), np.int64)}
    per_max: list = [[] for _ in range(4)]
    at = np.zeros(len(ucols), np.int64)
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(_groupby_shard, s, seed, f, g,
                            cand[cb[s]:cb[s + 1]] & _MASK20,
                            final[cb[s]:cb[s + 1]],
                            ucols[pb[s]:pb[s + 1]] & _MASK20)
                for s in range(shards)]
        for s, fut in enumerate(futs):
            r = fut.result()
            for key in ("rows", "sums", "f1_g", "g_f", "f_f"):
                st[key] += r[key]
            for k, m in enumerate(r["maxes"]):
                if m is not None:
                    per_max[k].append(m)
            at[pb[s]:pb[s + 1]] = r["at"]
    st["maxes"] = []
    for ms in per_max:
        best = max((v for v, _ in ms), default=None)
        st["maxes"].append(None if best is None else
                           (best, sum(c for v, c in ms if v == best)))
    st["median"] = int(np.median(st["g_f"]))
    st["paged"] = GB_PAGED.format(n=st["median"])
    before = _gb_expect(st)

    def f_bits(c: np.ndarray) -> np.ndarray:
        """f's bits at columns ``c``: int64[len(c), ROWS]."""
        sh, w = c >> 20, (c & _MASK20) >> 5
        bit = np.uint32(1) << (c & 31).astype(np.uint32)
        return ((f[sh, :, w] & bit[:, None]) != 0).astype(np.int64)

    # the set batch: its touched columns before and after
    fb = f_bits(ucols)
    sh, off = cols >> 20, cols & _MASK20
    np.bitwise_or.at(f, (sh, rows, off >> 5),
                     np.uint32(1) << (off & 31).astype(np.uint32))
    fa = f_bits(ucols)
    d = fa - fb
    gbit = np.uint32(1) << (ucols & 31).astype(np.uint32)
    gu = ((g[ucols >> 20, :, (ucols & _MASK20) >> 5] & gbit[:, None])
          != 0).astype(np.int64)
    st["g_f"] = st["g_f"] + gu.T @ d
    st["f_f"] = st["f_f"] + (fa[:, :4, None] * fa[:, None, 4:8]
                             - fb[:, :4, None] * fb[:, None, 4:8]).sum(0)
    st["rows"] = st["rows"] + d.sum(0)
    st["sums"] = st["sums"] + (d * at[:, None]).sum(0)
    after_set = _gb_expect(st)
    # the value batch, into candidate columns phase 5 never wrote
    vcols, new, old, vchanged = bsi["gb_values"]
    st["sums"] = st["sums"] + (f_bits(vcols)
                               * (new - np.where(old == _EMPTY, 0,
                                                 old))[:, None]).sum(0)
    after_values = _gb_expect(st)
    log(f"GroupBy oracle over {shards} shards and its two import batches "
        f"in {time.perf_counter() - t0:.1f}s")
    return {"paged": st["paged"], "expect": before,
            "set_batch": (rows, cols, int(d.sum()), after_set),
            "value_batch": (vcols, new, vchanged, after_values)}


def groupby_phase(client, holder, planes, gbo: dict, cuda: bool, device,
                  clients: int = CLIENTS, passes: int = GB_PASSES) -> dict:
    """Phase 6: the five GroupBy requests through the default executor
    (fast lane) and the "off" one, their device ms beside the one-read
    bound, a concurrent burst whose ``groupby`` windows must coalesce and
    dedupe, then a set import (rows planes refresh, no rebuild) and a
    value import (Sum over the BSI overlay).  The launch counters are
    reset when the phase starts and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    api = client.api
    ex = api.executor
    expect = gbo["expect"]
    reqs = GB_SEQ + (gbo["paged"],)
    names = dict(GB_NAMES, **{gbo["paged"]: "paged g x f"})
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()

    builds = planes.builds
    for q in reqs:
        t = time.perf_counter()
        client.ask(q, expect[q], tag=f"GroupBy {names[q]}, first")
        log(f"GroupBy {names[q]} first request (builds its planes): "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    log(f"rows planes built: {planes.builds - builds} "
        f"(last {planes.last_build_seconds:.2f} s, "
        f"{planes.last_build_bytes / 1e9:.2f} GB)")
    # one read of each plane a request needs: rows planes of 4 and 32
    # rows, the bit plane, f's row 1
    row_b = len(shards) * WORDS * 4
    nbytes = {GB_SEQ[0]: 8 * row_b, GB_SEQ[1]: (4 + ROWS) * row_b,
              GB_SEQ[2]: (ROWS + BSI_ROWS) * row_b,
              GB_SEQ[3]: (4 + BSI_ROWS + 1) * row_b,
              gbo["paged"]: (4 + ROWS) * row_b}

    b0 = ex.serving_stats()
    for q in reqs:
        client.ask(q, expect[q], reps=3, tag=f"GroupBy {names[q]}")
    b1 = ex.serving_stats()
    hits = b1["fastLaneHits"] - b0["fastLaneHits"]
    if hits < 3 * len(reqs):
        raise AssertionError(f"{hits} fast-lane hits for the "
                             f"{3 * len(reqs)} sequential GroupBys")
    off = _executor(holder, device=device, plane_budget=32 << 30,
                    delta_compact_fraction=COMPACT_FRACTION,
                    count_batch_window="off", tree_fusion=False)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    for q in reqs:
        offc.ask(q, expect[q], reps=2, tag=f"GroupBy off {names[q]}")
    log("GroupBy sequential: every answer equal to the oracle through both "
        f"configurations; {hits} fast-lane hits")
    for q in reqs:
        log(f"latency GroupBy {names[q]}: median "
            f"{_median_ms(client.lat[f'GroupBy {names[q]}']):.2f} ms "
            f"[default], "
            f"{_median_ms(offc.lat[f'GroupBy off {names[q]}']):.2f} ms "
            f"[off]")
    if cuda:
        for q in reqs:
            b_ms = bound(nbytes[q], 0)[0]
            dev_ms, wall_ms, top = device_busy_share(
                lambda: client.ask(q, expect[q], reps=3, tag="profiled"))
            log(f"GroupBy device ms {names[q]}: {dev_ms / 3:.3f} ms per "
                f"request (bound {b_ms:.3f} ms = one read of "
                f"{nbytes[q] / 1e9:.3f} GB; {dev_ms / 3 / b_ms:.1f}x), wall "
                f"{wall_ms / 3:.3f} ms; by kernel: {top}")

    t1 = time.perf_counter()
    b0 = ex.serving_stats()
    run = burst(api, expect, clients, passes, GB_SEQ, GB_NAMES)
    b1 = ex.serving_stats()
    reqs_n = run["requests"]
    windows = b1["windows"] - b0["windows"]
    items = b1["items"] - b0["items"]
    groups, gitems, largest = _kind_stats(b0, b1, "groupby")
    log(f"[GroupBy] {clients} clients x {passes} passes: {reqs_n} requests "
        f"in {run['wall']:.3f} s = {reqs_n / run['wall']:.1f} requests/s; "
        f"{windows} windows, {items} items ({items / max(1, windows):.2f} "
        f"per window); groupby: {groups} calls for {gitems} items "
        f"(dedupe hits {gitems - groups}, largest group {largest})")
    for q in GB_SEQ:
        ts = run["lat"][q]
        log(f"[GroupBy]   {names[q]}: p50 {_pct_ms(ts, 0.5):.2f} ms, p90 "
            f"{_pct_ms(ts, 0.9):.2f} ms, p99 {_pct_ms(ts, 0.99):.2f} ms, "
            f"max {max(ts) * 1e3:.2f} ms over {len(ts)}")
    if items <= windows or gitems <= groups:
        raise AssertionError("the groupby windows never coalesced or "
                             "deduped")
    if cuda:
        dev_ms, wall_ms, top = device_busy_share(
            lambda: burst(api, expect, clients, 1, GB_SEQ, GB_NAMES))
        log(f"[GroupBy]   one burst of {clients} x 1 under the profiler: "
            f"device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall = "
            f"{dev_ms / wall_ms:.1%}; by kernel: {top}")
    log(f"phase 6 concurrent wall: {time.perf_counter() - t1:.1f}s")

    builds, refreshed = planes.builds, planes.incremental_applied
    absorbs = planes.delta_absorbs
    rows_, cols, changed, want = gbo["set_batch"]
    got = client.post("/index/bench/field/f/import", json.dumps(
        {"rowIDs": rows_.tolist(), "columnIDs": cols.tolist()}).encode(),
        "REST import, GroupBy")
    if got != {"changed": changed}:
        raise AssertionError(f"import: got {got}, want {changed}")
    for q in GB_SEQ[:2]:
        client.ask(q, want[q], tag=f"GroupBy {names[q]} after import")
    if planes.builds != builds or planes.incremental_applied <= refreshed:
        raise AssertionError(
            f"the rows planes did not refresh without a rebuild: builds "
            f"{builds} -> {planes.builds}, refreshes {refreshed} -> "
            f"{planes.incremental_applied}")
    vcols, new, vchanged, want = gbo["value_batch"]
    got = client.post("/index/bench/field/amount/importValue", json.dumps(
        {"columnIDs": vcols.tolist(), "values": new.tolist()}).encode(),
        "REST importValue, GroupBy")
    if got != {"changed": vchanged}:
        raise AssertionError(f"importValue: got {got}, want {vchanged}")
    client.ask(GB_SEQ[2], want[GB_SEQ[2]], tag="GroupBy Sum over overlay")
    if planes.builds != builds or planes.delta_absorbs <= absorbs:
        raise AssertionError(
            f"the value batch was not absorbed: builds {builds} -> "
            f"{planes.builds}, absorbs {absorbs} -> {planes.delta_absorbs}")
    for tag in ("REST import, GroupBy", "GroupBy 4x4 after import",
                "GroupBy g x f after import", "REST importValue, GroupBy",
                "GroupBy Sum over overlay"):
        log(f"latency {tag!r}: {client.lat[tag][0] * 1e3:.2f} ms")
    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        # the innermost pass of "g x f" timed with CUDA events on the
        # resident rows plane and a g row, beside phase 1's random plane
        # (after the path's counts are read: these launches are not its)
        fplane = planes.rows_plane("bench", index.field("f"), "standard",
                                   np.arange(ROWS, dtype=np.uint64),
                                   shards).plane
        filt = planes.rows_plane("bench", index.field("g"), "standard",
                                 np.arange(4, dtype=np.uint64),
                                 shards).plane[:, 0].contiguous()
        ms = time_ms(lambda: cuda_kernels.row_counts(fplane, filt), 20)
        nb = (fplane.numel() + filt.numel()) * 4
        log(f"row_counts+filter on the f rows plane int32"
            f"{list(fplane.shape)} (CUDA events): {ms:.4f} ms "
            f"({nb / ms / 1e6:.1f} GB/s)")
        del fplane, filt
    log(f"GroupBy ingest: the set batch refreshed the rows planes "
        f"(refreshes +{planes.incremental_applied - refreshed}, builds "
        f"stayed {planes.builds}), the value batch absorbed (absorbs "
        f"+{planes.delta_absorbs - absorbs}); launches {json.dumps(launched)}"
        f"; peak device memory in the phase {peak / 1e9:.2f} GB; phase 6 "
        f"GroupBy wall {time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("row_counts", "count"):
            if launched[k] < 1:
                raise AssertionError(f"the GroupBy path never launched {k}")
    return {"groupby": launched}


# ---------------------------------------------------------------------------
# phase 7: time views
# ---------------------------------------------------------------------------

# index ``events``, one time field ``ev`` (quantum YMD): event rows 0-3,
# daily buckets over the 28 days of February 2021, each (row, column,
# day) bit set with probability 1/64 (the AND of six random words)
EV_ROWS, EV_DAYS, EV_AND = 4, 28, 6
EV_BATCH = 4096                # pairs of each timestamped import
EV_PASSES = 4                  # passes of phase 7's concurrent burst
EV_SPAN_BUDGET = 8 << 30       # below the 16.0 GB time plane: span path
#                                (half the plane at a cut shard count)


def _ev_day(day: int, hour: int = 0) -> str:
    """PQL timestamp of 2021-02-01 plus ``day`` days (day 28 is March 1)."""
    t = datetime.datetime(2021, 2, 1) + datetime.timedelta(days=day,
                                                           hours=hour)
    return t.strftime("%Y-%m-%dT%H:%M")


def _ev_range(row: int, d0: int, d1: int) -> str:
    return f"Row(ev={row}, from={_ev_day(d0)}, to={_ev_day(d1)})"


# the requests of bench/config33_event_analytics.py, dated into February
EV_SEQ = (
    f"Count({_ev_range(1, 21, 28)})",                         # 1 recency
    f"Count(Intersect({_ev_range(1, 0, 7)}, {_ev_range(1, 21, 28)}))",
    "".join(f"Count({_ev_range(2, d, d + 7)})" for d in (0, 7, 14, 21)),
    f"Count({_ev_range(1, 0, 28)})",                          # 4 month
    f"Rows(ev, from={_ev_day(0)}, to={_ev_day(14)})",
    f"GroupBy(Rows(ev, from={_ev_day(0)}, to={_ev_day(14)}))",
    f"Count(Shift({_ev_range(1, 0, 28)}, n=1))",              # 7
    "Count(Limit(Row(ev=0), limit=8, offset=2))",
    "Count(Intersect(Row(ev=0), ConstRow(columns=[0, 1, 2])))",
    f"TopN(ev, {_ev_range(1, 21, 28)}, n=3)",                 # 10
)
EV_NAMES = dict(zip(EV_SEQ, (
    "1 recency", "2 retention", "3 sliding x4", "4 whole month",
    "5 Rows in range", "6 GroupBy Rows in range", "7 Shift", "8 Limit",
    "9 ConstRow", "10 filtered TopN")))
EV_MIX = (EV_SEQ[0], EV_SEQ[1], EV_SEQ[2], EV_SEQ[6])
EV_LANES = {EV_SEQ[0]: 7, EV_SEQ[1]: 14, EV_SEQ[3]: 28, EV_SEQ[6]: 28,
            EV_SEQ[9]: 7}
EV_MARCH = f"Count({_ev_range(1, 21, 35)})"   # Feb 22 .. Mar 8


def _events_shard(data_dir: str, s: int, seed: int, rec1: np.ndarray,
                  early1: np.ndarray) -> dict:
    """Shard ``s`` of ``ev``: its 28 day views, the month, year and
    standard views (the OR of the days) as fragment snapshots, and its
    part of the numpy oracle.  Row 1's Feb 22-28 and Feb 1-7 unions go
    into ``rec1`` / ``early1`` (the ingest checks update them)."""
    from pilosa_tpu_torch.store import roaring

    rng = np.random.default_rng((seed, s))
    bits = rng.integers(0, 1 << 32, (EV_ROWS, EV_DAYS, WORDS),
                        dtype=np.uint32)
    for _ in range(EV_AND - 1):
        bits &= rng.integers(0, 1 << 32, bits.shape, dtype=np.uint32)
    root = os.path.join(data_dir, "events", "ev", "views")
    for d in range(EV_DAYS):
        with open(os.path.join(root, f"standard_202102{d + 1:02d}",
                               "fragments", str(s)), "wb") as fh:
            fh.write(roaring.serialize_dense(bits[:, d]))
    month = np.bitwise_or.reduce(bits, axis=1)                  # [4, W]
    blob = roaring.serialize_dense(month)
    for v in ("standard", "standard_2021", "standard_202102"):
        with open(os.path.join(root, v, "fragments", str(s)), "wb") as fh:
            fh.write(blob)
    rec1[s] = np.bitwise_or.reduce(bits[1, 21:28], axis=0)
    early1[s] = np.bitwise_or.reduce(bits[1, 0:7], axis=0)
    return {
        "std": _popcounts(month),
        "slide": [int(_popcounts(np.bitwise_or.reduce(
            bits[2, d:d + 7], axis=0))) for d in (0, 7, 14, 21)],
        # Shift drops the bit at the shard's last column
        "shift": int(_popcounts(month[1])) - int(month[1, -1] >> 31),
        "topn": _popcounts(month & rec1[s][None, :]),
        "seen": bits[:, :14].any(axis=(1, 2)),
        "const": (sum(int(month[0, 0] >> c) & 1 for c in range(3))
                  if s == 0 else 0),
    }


def _ev_pairs(rng, shards: int, day0: int, days: int):
    """EV_BATCH distinct (row, column) pairs over the index with a day in
    ``[day0, day0 + days)`` and an hour each."""
    keys = rng.choice(shards * (1 << 20) * EV_ROWS, EV_BATCH, replace=False)
    rows, cols = keys % EV_ROWS, keys // EV_ROWS
    return (rows, cols, rng.integers(day0, day0 + days, EV_BATCH),
            rng.integers(0, 24, EV_BATCH))


def _ev_counts(rec1: np.ndarray, early1: np.ndarray) -> tuple[int, int]:
    rec = ret = 0
    for s0 in range(0, rec1.shape[0], 64):
        r = rec1[s0:s0 + 64]
        rec += int(_popcounts(r).sum())
        ret += int(_popcounts(r & early1[s0:s0 + 64]).sum())
    return rec, ret


def _set_pair_bits(words: np.ndarray, cols: np.ndarray) -> None:
    off = cols & ((1 << 20) - 1)
    np.bitwise_or.at(words, (cols >> 20, off >> 5),
                     np.uint32(1) << (off & 31).astype(np.uint32))


def make_events(data_dir: str, shards: int, seed: int) -> dict:
    """Write ``events``/``ev`` (31 views x ``shards`` snapshots, one shard
    per task on a thread pool) and the numpy oracle of phase 7's
    requests and imports."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.store import FieldOptions

    t0 = time.perf_counter()
    _create_fields(data_dir, "events", {"ev": FieldOptions(
        type="time", time_quantum="YMD")}, new_index=True)
    views = ["standard", "standard_2021", "standard_202102"] + \
        [f"standard_202102{d + 1:02d}" for d in range(EV_DAYS)]
    for v in views:
        os.makedirs(os.path.join(data_dir, "events", "ev", "views", v,
                                 "fragments"), exist_ok=True)
    rec1 = np.zeros((shards, WORDS), np.uint32)
    early1 = np.zeros((shards, WORDS), np.uint32)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        parts = list(pool.map(
            lambda s: _events_shard(data_dir, s, seed, rec1, early1),
            range(shards)))
    std = sum(p["std"] for p in parts)
    topn = sum(p["topn"] for p in parts)
    rec, ret = _ev_counts(rec1, early1)
    seen = np.any([p["seen"] for p in parts], axis=0)
    expect = {
        EV_SEQ[0]: [rec], EV_SEQ[1]: [ret],
        EV_SEQ[2]: [int(sum(p["slide"][k] for p in parts))
                    for k in range(4)],
        EV_SEQ[3]: [int(std[1])],
        EV_SEQ[4]: [{"rows": [int(r) for r in np.flatnonzero(seen)]}],
        EV_SEQ[5]: [[{"group": [{"field": "ev", "rowID": int(r)}],
                      "count": int(std[r])}
                     for r in np.flatnonzero(seen) if std[r] > 0]],
        EV_SEQ[6]: [int(sum(p["shift"] for p in parts))],
        EV_SEQ[7]: [min(8, max(0, int(std[0]) - 2))],
        EV_SEQ[8]: [int(sum(p["const"] for p in parts))],
        EV_SEQ[9]: [_topn(topn, 3)],
    }
    log(f"events: {shards} shards x {len(views)} views written (4 rows x "
        f"{EV_DAYS} days, p = 1/64) with the numpy oracle in "
        f"{time.perf_counter() - t0:.1f}s")
    # the imports: one into existing February buckets of existing rows
    # (absorbed), one stamped 2021-03-01 (a new bucket: rebuilds)
    rng = np.random.default_rng(seed + 7)
    feb = _ev_pairs(rng, shards, 0, EV_DAYS)
    one = feb[0] == 1
    for lo, hi, words in ((21, 28, rec1), (0, 7, early1)):
        hit = one & (feb[2] >= lo) & (feb[2] < hi)
        _set_pair_bits(words, feb[1][hit])
    rec, ret = _ev_counts(rec1, early1)
    march = _ev_pairs(rng, shards, EV_DAYS, 1)
    _set_pair_bits(rec1, march[1][march[0] == 1])
    return {"expect": expect, "feb": feb, "march": march,
            "after_feb": {EV_SEQ[0]: [rec], EV_SEQ[1]: [ret]},
            "after_march": {EV_MARCH: [_ev_counts(rec1, early1)[0]]},
            "month_row1": int(std[1])}


def _ev_import_body(pairs) -> bytes:
    rows, cols, days, hours = pairs
    return json.dumps({
        "rowIDs": rows.tolist(), "columnIDs": cols.tolist(),
        "timestamps": [_ev_day(int(d), int(h))
                       for d, h in zip(days, hours)]}).encode()


def events_phase(client, holder, planes, evo: dict, cuda: bool, device,
                 clients: int = CLIENTS, passes: int = EV_PASSES) -> dict:
    """Phase 7: the ten time-view requests through the default executor
    (over the 16.0 GB time plane) and the "off" one sharing its plane
    cache, and requests 1-4 through an executor whose budget the plane
    exceeds (the span path); their device ms beside the one-read bound; a
    concurrent burst; a timestamped import into existing buckets
    (absorbed) and one into a new day (rebuilds).  The launch counters
    are reset when the phase starts and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    api = client.api
    ex = api.executor
    expect = evo["expect"]
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()

    builds = planes.builds
    t = time.perf_counter()
    client.ask(EV_SEQ[0], expect[EV_SEQ[0]], tag="events first",
               index="events")
    status = ex.time_status()
    if planes.builds != builds + 1 or len(status["planes"]) != 1:
        raise AssertionError(f"the time plane did not build: {status}")
    tp = status["planes"][0]
    rb_pad = tp["bytes"] // (tp["shards"] * WORDS * 4)
    log(f"time plane built in the first request: {tp['buckets']} buckets x "
        f"{tp['rows']} rows in {planes.last_build_seconds:.2f} s, "
        f"{tp['bytes'] / 1e9:.2f} GB (int32[{tp['shards']}, {rb_pad}, "
        f"{WORDS}]); first request {(time.perf_counter() - t) * 1e3:.1f} ms")
    if (tp["buckets"], tp["rows"]) != (EV_DAYS, EV_ROWS):
        raise AssertionError(f"time plane geometry {tp}")

    off = _executor(holder, device=device, plane_budget=32 << 30,
                    delta_compact_fraction=COMPACT_FRACTION,
                    count_batch_window="off", tree_fusion=False)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    for q in EV_SEQ:
        t = time.perf_counter()
        client.ask(q, expect[q], tag=f"events {EV_NAMES[q]}, first",
                   index="events")
        log(f"events {EV_NAMES[q]} first request: "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    planes.wait_builds()   # ev's standard plane builds in the background
    for q in EV_SEQ:
        client.ask(q, expect[q], reps=3, tag=f"events {EV_NAMES[q]}",
                   index="events")
        offc.ask(q, expect[q], reps=2, tag=f"events off {EV_NAMES[q]}",
                 index="events")
    client.ask("Count(Row(ev=1))", [evo["month_row1"]], index="events")
    for q in EV_SEQ:
        log(f"latency events {EV_NAMES[q]}: median "
            f"{_median_ms(client.lat[f'events {EV_NAMES[q]}']):.2f} ms "
            f"[default], "
            f"{_median_ms(offc.lat[f'events off {EV_NAMES[q]}']):.2f} ms "
            f"[off]")

    # both time paths at scale: an executor whose budget the plane
    # exceeds unions the cover views' rows (request 4: the month view)
    span = _executor(holder, device=device,
                     plane_budget=min(EV_SPAN_BUDGET, tp["bytes"] // 2))
    spanc = _Client(API(holder, span), cuda)
    try:
        for q in EV_SEQ[:4]:
            spanc.ask(q, expect[q], tag=f"events span {EV_NAMES[q]}",
                      index="events")
        served = {name: e.time_status()["rangesServed"]
                  for name, e in (("default", ex), ("off", off),
                                  ("span", span))}
    finally:
        span.close()
    log(f"time ranges served: {json.dumps(served)}")
    if (served["default"]["span"] or served["off"]["span"]
            or served["span"]["plane"] or not served["span"]["span"]
            or not served["default"]["plane"] or not served["off"]["plane"]):
        raise AssertionError(f"a time path served where it should not: "
                             f"{served}")
    for q in EV_SEQ[:4]:
        log(f"latency events span {EV_NAMES[q]}: "
            f"{spanc.lat[f'events span {EV_NAMES[q]}'][0] * 1e3:.2f} ms "
            "(first, builds its cover rows)")
    del span, spanc

    if cuda:
        lane = tp["shards"] * WORDS * 4
        std_plane = EV_ROWS * lane
        for q, lanes in EV_LANES.items():
            nbytes = lanes * lane + (std_plane if q == EV_SEQ[9] else 0)
            b_ms = bound(nbytes, 0)[0]
            dev_ms, wall_ms, top = device_busy_share(
                lambda: client.ask(q, expect[q], reps=3, tag="profiled",
                                   index="events"))
            log(f"events device ms {EV_NAMES[q]}: {dev_ms / 3:.3f} ms per "
                f"request (bound {b_ms:.3f} ms = one read of "
                f"{nbytes / 1e9:.3f} GB; {dev_ms / 3 / b_ms:.1f}x), wall "
                f"{wall_ms / 3:.3f} ms; by kernel: {top}")

    t1 = time.perf_counter()
    names = {q: EV_NAMES[q] for q in EV_MIX}
    b0 = ex.serving_stats()
    run = burst(api, expect, clients, passes, EV_MIX, names, "events")
    b1 = ex.serving_stats()
    reqs_n = run["requests"]
    windows = b1["windows"] - b0["windows"]
    items = b1["items"] - b0["items"]
    log(f"[events] {clients} clients x {passes} passes: {reqs_n} requests "
        f"in {run['wall']:.3f} s = {reqs_n / run['wall']:.1f} requests/s; "
        f"{windows} windows, {items} items ({items / max(1, windows):.2f} "
        f"per window)")
    for kind in sorted(b1.get("kinds", {})):
        groups, kitems, largest = _kind_stats(b0, b1, kind)
        if kitems:
            log(f"[events]   kind {kind}: {groups} calls for {kitems} items "
                f"({kitems / max(1, groups):.2f} per call, largest "
                f"{largest})")
    for q in EV_MIX:
        ts = run["lat"][q]
        log(f"[events]   {names[q]}: p50 {_pct_ms(ts, 0.5):.2f} ms, p90 "
            f"{_pct_ms(ts, 0.9):.2f} ms, p99 {_pct_ms(ts, 0.99):.2f} ms, "
            f"max {max(ts) * 1e3:.2f} ms over {len(ts)}")
    if cuda:
        dev_ms, wall_ms, top = device_busy_share(
            lambda: burst(api, expect, clients, 1, EV_MIX, names, "events"))
        log(f"[events]   one burst of {clients} x 1 under the profiler: "
            f"device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall = "
            f"{dev_ms / wall_ms:.1%}; by kernel: {top}")
    log(f"phase 7 concurrent wall: {time.perf_counter() - t1:.1f}s")

    # a timestamped import into existing buckets of existing rows is
    # absorbed into the time plane's overlay
    builds, absorbs = planes.builds, planes.delta_absorbs
    got = client.post("/index/events/field/ev/import",
                      _ev_import_body(evo["feb"]), "REST import, February")
    if not got.get("changed"):
        raise AssertionError(f"the February import changed nothing: {got}")
    for q in EV_SEQ[:2]:
        client.ask(q, evo["after_feb"][q], index="events",
                   tag=f"events {EV_NAMES[q]} after import")
    if planes.builds != builds or planes.delta_absorbs != absorbs + 1:
        raise AssertionError(
            f"the February import was not absorbed: builds {builds} -> "
            f"{planes.builds}, absorbs {absorbs} -> {planes.delta_absorbs}")
    # one stamped March 1 makes a new bucket: the plane rebuilds
    got = client.post("/index/events/field/ev/import",
                      _ev_import_body(evo["march"]), "REST import, March")
    client.ask(EV_MARCH, evo["after_march"][EV_MARCH], index="events",
               tag="events Feb 22 - Mar 8 after the March import")
    tp = ex.time_status()["planes"][0]
    if planes.builds != builds + 1 or tp["buckets"] != EV_DAYS + 1:
        raise AssertionError(f"the March import did not rebuild the time "
                             f"plane: builds {builds} -> {planes.builds}, "
                             f"{tp}")
    log(f"time plane rebuilt after the March import: {tp['buckets']} "
        f"buckets, {tp['bytes'] / 1e9:.2f} GB in "
        f"{planes.last_build_seconds:.2f} s")
    for tag in ("REST import, February", "events 1 recency after import",
                "events 2 retention after import", "REST import, March",
                "events Feb 22 - Mar 8 after the March import"):
        log(f"latency {tag!r}: {client.lat[tag][0] * 1e3:.2f} ms")
    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"events ingest: the February import absorbed (absorbs "
        f"+{planes.delta_absorbs - absorbs}, no build), the March import "
        f"rebuilt; launches {json.dumps(launched)}; peak device memory in "
        f"the phase {peak / 1e9:.2f} GB; phase 7 events wall "
        f"{time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("row_counts", "count"):
            if launched[k] < 1:
                raise AssertionError(f"the events path never launched {k}")
    return {"events": launched}


# ---------------------------------------------------------------------------
# phase 8: mutex and bool fields, Extract, IncludesColumn, Options, Store
# and ClearRow
# ---------------------------------------------------------------------------

MX_ROWS = 16                   # the mutex field's rows
MX_MOVES = 4096                # columns the REST import moves to a new row
MX_SUBSET = 100                # shards of the Options(shards=) request
MX_STORE_ROW = 40              # the Store's target row of f
MX_EXTRACT = 1000              # the Extract's Limit
MQ16 = "".join(f"Count(Row(m={r}))" for r in range(MX_ROWS))
MQ2 = "Count(Row(m=1))Count(Row(m=6))"
MQ3 = "Count(Intersect(Row(m=3), Row(b=true), Row(f=1)))"
MQ_TOPN = "TopN(m, Row(b=true), n=5)"
MQ_GB = "GroupBy(Rows(m), Rows(b))"
MQ_EXTRACT = (f"Extract(Limit(Row(f=0), limit={MX_EXTRACT}), Rows(f), "
              "Rows(m), Rows(b), Rows(amount))")
MQ_STORE = f"Store(Intersect(Row(f=1), Row(f=2), Row(f=3)), f={MX_STORE_ROW})"


def _mutex_shard(data_dir: str, s: int, seed: int, f: np.ndarray,
                 n_moves: int) -> dict:
    """Shard ``s`` of ``m`` (each column in one of 16 rows with
    probability 15/16) and ``b`` (true 1/2, false 1/4, unset 1/4) from
    (seed, s), written as fragment snapshots, its part of the numpy
    oracle, and ``n_moves`` of the import's pairs: columns that hold a
    row, each moved to another row."""
    from pilosa_tpu_torch.store import roaring
    rng = np.random.default_rng([seed, 8, s])
    mrow = rng.integers(0, MX_ROWS, 1 << 20, dtype=np.int8)
    has = rng.integers(0, 16, 1 << 20, dtype=np.int8) != 0
    bval = rng.integers(0, 4, 1 << 20, dtype=np.int8)
    m = np.stack([_pack(has & (mrow == r)) for r in range(MX_ROWS)])
    b = np.stack([_pack(bval == 2), _pack(bval < 2)])   # false, true
    for name, words in (("m", m), ("b", b)):
        with open(os.path.join(data_dir, "bench", name, "views", "standard",
                               "fragments", str(s)), "wb") as fh:
            fh.write(roaring.serialize_dense(words))
    fs = f[s]
    tri = m[3] & b[1] & fs[1]
    offs = rng.choice(np.flatnonzero(has), n_moves, replace=False)
    old = mrow[offs].astype(np.int64)
    new = (old + rng.integers(1, MX_ROWS, n_moves)) % MX_ROWS
    in_tri = _bits(b[1] & fs[1])[offs]
    out = {"m": _popcounts(m), "b": _popcounts(b),
           "tri": int(_popcounts(tri)),
           "topn": _popcounts(m & b[1][None, :]),
           "gb": _popcounts(m[:, None, :] & b[None, :, :]),
           "f": _popcounts(fs),
           "store": int(_popcounts(fs[1] & fs[2] & fs[3])),
           "moves": (offs + (s << 20), new),
           "move_m": (np.bincount(new, minlength=MX_ROWS)
                      - np.bincount(old, minlength=MX_ROWS)),
           "move_tri": int(in_tri[new == 3].sum() - in_tri[old == 3].sum())}
    if s == 0:
        true = np.flatnonzero(bval < 2)
        out["b_true_col"] = int(true[0])
        out["cells"] = (mrow, has, bval)
    if s == min(5, f.shape[0] - 1):
        three = np.flatnonzero(has & (mrow == 3))
        other = np.flatnonzero(has & (mrow != 3))
        out["incl"] = (int(three[0]) + (s << 20), int(other[0]) + (s << 20))
    return out


def _extract_expect(f: np.ndarray, cells, amount) -> list:
    """The Extract request's table: the first ``MX_EXTRACT`` columns of
    f row 0 (all in shard 0), each with its f rows, m row, b flag and
    amount (None where it holds none)."""
    mrow, has, bval = cells
    exists, vals = amount
    cols = np.flatnonzero(_bits(f[0, 0]))[:MX_EXTRACT]
    fbits = (f[0][:, cols >> 5] >> (cols & 31).astype(np.uint32)) & 1
    rows = []
    for j, c in enumerate(cols.tolist()):
        rows.append({"column": c, "rows": [
            [int(r) for r in np.flatnonzero(fbits[:, j])],
            int(mrow[c]) if has[c] else None,
            None if bval[c] == 3 else bool(bval[c] < 2),
            int(vals[c]) if exists[c] else None]})
    return [{"fields": [{"name": "f", "type": "set"},
                        {"name": "m", "type": "mutex"},
                        {"name": "b", "type": "bool"},
                        {"name": "amount", "type": "int"}],
             "columns": rows}]


def make_mutex(data_dir: str, f: np.ndarray, shards: int, seed: int,
               bsi: dict) -> dict:
    """Write the mutex field ``m`` and the bool field ``b`` of ``bench``
    (2 x ``shards`` fragment snapshots) and return phase 8's oracle over
    them, ``f`` as phases 4 and 6 left it and ``amount`` as phases 5 and
    6 left it: the requests' answers, the mutex import and the answers
    after each write."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.store import FieldOptions

    t0 = time.perf_counter()
    _create_fields(data_dir, "bench", {"m": FieldOptions(type="mutex"),
                                       "b": FieldOptions(type="bool")})
    for name in ("m", "b"):
        os.makedirs(os.path.join(data_dir, "bench", name, "views",
                                 "standard", "fragments"), exist_ok=True)
    rng = np.random.default_rng(seed + 8)
    n_moves = np.bincount(rng.integers(0, shards, MX_MOVES),
                          minlength=shards)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        parts = list(pool.map(
            lambda s: _mutex_shard(data_dir, s, seed, f, int(n_moves[s])),
            range(shards)))
    total = {k: sum(p[k] for p in parts)
             for k in ("m", "b", "tri", "topn", "gb", "f", "store",
                       "move_m", "move_tri")}
    subset = min(MX_SUBSET, shards)
    q_opts = ("Options(Count(Row(f=1)), shards=[" + ", ".join(
        str(s) for s in range(subset)) + "])"
        "Options(Row(m=3), excludeColumns=true)")
    c_in, c_out = next(p["incl"] for p in parts if "incl" in p)
    q_incl = (f"IncludesColumn(Row(m=3), column={c_in})"
              f"IncludesColumn(Row(m=3), column={c_out})")
    # amount in shard 0 as phases 5 and 6 left it
    exists, vals = _bsi_values(seed, 0)
    vals = vals.astype(np.int64)
    cand, final = bsi["final"]
    c0 = cand < (1 << 20)
    exists[cand[c0]] = final[c0] != _EMPTY
    vals[cand[c0]] = np.where(final[c0] != _EMPTY, final[c0], 0)
    vcols, new = bsi["gb_values"][:2]
    v0 = vcols < (1 << 20)
    exists[vcols[v0]] = True
    vals[vcols[v0]] = new[v0]
    gb = total["gb"]
    expect = {
        MQ16: [int(c) for c in total["m"]],
        MQ2: [int(total["m"][1]), int(total["m"][6])],
        MQ3: [total["tri"]],
        MQ_TOPN: [_topn(total["topn"], 5)],
        MQ_GB: [[{"group": [{"field": "m", "rowID": r},
                            {"field": "b", "rowID": v}],
                  "count": int(gb[r, v])}
                 for r in range(MX_ROWS) for v in (0, 1) if gb[r, v]]],
        MQ_EXTRACT: _extract_expect(f, parts[0]["cells"], (exists, vals)),
        q_incl: [True, False],
        q_opts: [int(sum(p["f"][1] for p in parts[:subset])),
                 {"columns": []}],
    }
    moves = np.concatenate([p["moves"][0] for p in parts])
    new_rows = np.concatenate([p["moves"][1] for p in parts])
    after = total["m"] + total["move_m"]
    bt = parts[0]["b_true_col"]
    log(f"mutex data: m (16 rows) and b over {shards} shards, "
        f"{2 * shards} fragment snapshots and the oracle in "
        f"{time.perf_counter() - t0:.1f}s")
    return {
        "seq": (MQ16, MQ2, MQ3, MQ_TOPN, MQ_GB, MQ_EXTRACT, q_incl, q_opts),
        "expect": expect,
        "import": (moves, new_rows),
        "after_import": {MQ16: [int(c) for c in after],
                         MQ3: [total["tri"] + total["move_tri"]]},
        "b_col": bt,
        "b_counts": [int(total["b"][1]), int(total["b"][0])],
        "store": total["store"],
        "f_counts": [int(c) for c in total["f"]],
    }


def mutex_phase(client, holder, planes, mxo: dict, cuda: bool, device,
                ingest_ms: float | None) -> dict:
    """Phase 8: the eight requests over the mutex and bool fields through
    the default executor (fast lane) and the "off" one, every answer
    against the oracle; the device ms of requests 1, 5 and 6 beside one
    read of the planes each needs; a REST import that moves 4096 columns
    to other mutex rows (absorbed into the overlay: the old rows'
    Counts drop), a ``Set`` of a bool column, a ``Store`` into a new row
    of f and its ``ClearRow``, each followed by checked reads.  The
    launch counters are reset when the phase starts and read when it
    ends."""
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    t0 = time.perf_counter()
    if cuda:
        log(f"phase 8 on {card_line()}")
    expect = mxo["expect"]
    seq = mxo["seq"]
    names = dict(zip(seq, ("1 16-Count", "2 two Counts", "3 m x b x f",
                           "4 filtered TopN", "5 GroupBy m x b",
                           "6 Extract", "7 IncludesColumn",
                           "8 Options")))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    built = {}
    for name in ("m", "b"):
        b0 = planes.builds
        planes.field_plane("bench", index.field(name), "standard", shards)
        if planes.builds != b0 + 1:
            raise AssertionError(f"the {name} plane did not build")
        built[name] = (planes.last_build_seconds, planes.last_build_bytes)
    log("mutex planes: " + ", ".join(
        f"{n} {b / 1e9:.3f} GB built in {s:.2f} s"
        for n, (s, b) in built.items()))

    off = _executor(holder, device=device, plane_budget=32 << 30,
                    delta_compact_fraction=COMPACT_FRACTION,
                    count_batch_window="off", tree_fusion=False)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    for q in seq:
        t = time.perf_counter()
        client.ask(q, expect[q], tag=f"mutex {names[q]}, first")
        log(f"mutex {names[q]} first request: "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    hits0 = client.api.executor.serving_stats()["fastLaneHits"]
    for q in seq:
        client.ask(q, expect[q], reps=3, tag=f"mutex {names[q]}")
        offc.ask(q, expect[q], reps=2, tag=f"mutex off {names[q]}")
    if client.api.executor.serving_stats()["fastLaneHits"] <= hits0:
        raise AssertionError("phase 8's requests never took the fast lane")
    for q in seq:
        log(f"latency mutex {names[q]}: median "
            f"{_median_ms(client.lat[f'mutex {names[q]}']):.2f} ms "
            f"[default], "
            f"{_median_ms(offc.lat[f'mutex off {names[q]}']):.2f} ms [off]")
    off.close()

    if cuda:
        lane = len(shards) * WORDS * 4
        for q, nbytes, what in (
                (seq[0], MX_ROWS * lane, "the m plane"),
                (seq[4], (MX_ROWS + 2) * lane,
                 "the m and b rows planes"),
                (seq[5], 2 * lane, "f row 0 and the Limit's bitmap")):
            b_ms = bound(nbytes, 0)[0]
            dev_ms, wall_ms, top = traced(
                lambda: client.ask(q, expect[q], reps=3, tag="profiled"),
                f"mutex {names[q]}")
            log(f"mutex device ms {names[q]}: {dev_ms / 3:.3f} ms per "
                f"request (bound {b_ms:.3f} ms = one read of {what}, "
                f"{nbytes / 1e9:.3f} GB; {dev_ms / 3 / b_ms:.1f}x), wall "
                f"{wall_ms / 3:.3f} ms; by kernel: {top}")

    def moved(write, reads):
        """(builds, absorbs, folds and row refreshes) a write and the
        reads after it took."""
        b0, a0, r0 = (planes.builds, planes.delta_absorbs,
                      planes.incremental_applied)
        write()
        for q, want, tag in reads:
            client.ask(q, want, tag=tag)
        return (planes.builds - b0, planes.delta_absorbs - a0,
                planes.incremental_applied - r0)

    # the mutex import: every column leaves its old row
    cols, rows = mxo["import"]
    body = json.dumps({"rowIDs": rows.tolist(),
                       "columnIDs": cols.tolist()}).encode()
    after = mxo["after_import"]
    def import_m():
        got = client.post("/index/bench/field/m/import", body,
                          "REST import m")
        if got != {"changed": 2 * len(cols)}:
            raise AssertionError(f"the mutex import: got {got}, want "
                                 f"{{'changed': {2 * len(cols)}}}")

    took = moved(import_m, [(q, after[q], f"mutex {q[:20]} after the import")
                            for q in (MQ16, MQ3)])
    log(f"mutex import of {MX_MOVES} moves: builds +{took[0]}, absorbs "
        f"+{took[1]}, folds +{took[2]}: "
        + ("absorbed into the overlay" if took[:2] == (0, 1)
           else "NOT absorbed"))
    if took[:2] != (0, 1):
        raise AssertionError(f"the mutex import was not absorbed: {took}")
    # a bool column set false
    col = mxo["b_col"]
    bt, bf = mxo["b_counts"]
    took_b = moved(lambda: client.ask(f"Set({col}, b=false)", [True],
                                      tag="Set b=false"),
                   [("Count(Row(b=true))Count(Row(b=false))",
                     [bt - 1, bf + 1], "b counts after the Set"),
                    (f"IncludesColumn(Row(b=false), column={col})", [True],
                     "IncludesColumn after the Set")])
    # Store into a row f lacks (the plane rebuilds), then ClearRow (a fold)
    took_s = moved(lambda: client.ask(MQ_STORE, [True], tag="Store"),
                   [(f"Count(Row(f={MX_STORE_ROW}))", [mxo["store"]],
                     "Count after the Store")])
    store_build = planes.last_build_seconds
    q32 = "".join(f"Count(Row(f={r}))" for r in range(ROWS))
    took_c = moved(lambda: client.ask(f"ClearRow(f={MX_STORE_ROW})", [True],
                                      tag="ClearRow"),
                   [(f"Count(Row(f={MX_STORE_ROW}))", [0],
                     "Count after the ClearRow"),
                    (q32, mxo["f_counts"], "32-Count after the ClearRow")])
    log(f"writes (builds, absorbs, folds and row refreshes): Set b "
        f"{took_b}, Store {took_s} (rebuild {store_build:.2f} s), ClearRow "
        f"{took_c}")
    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    m_ms = client.lat["REST import m"][0] * 1e3
    log(f"latency REST import m ({MX_MOVES} moves): {m_ms:.2f} ms; phase "
        "4's 4096-pair set import: "
        + (f"median {ingest_ms:.2f} ms" if ingest_ms is not None
           else "not run"))
    for tag in ("Set b=false", "Store", "Count after the Store",
                "ClearRow", "Count after the ClearRow",
                "32-Count after the ClearRow"):
        log(f"latency {tag!r}: {client.lat[tag][0] * 1e3:.2f} ms")
    log(f"launches in phase 8: {json.dumps(launched)}; peak device memory "
        f"in the phase {peak / 1e9:.2f} GB; phase 8 wall "
        f"{time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("count", "row_counts", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 8 never launched {k}")
    return {"mutex": launched}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9: keys and attributes
# ---------------------------------------------------------------------------

# (a) keyed row field ``seg`` on ``bench``: named segments over integer
# entity ids.  Keys are created in order, so seg-01 .. seg-31 are ids 1-31
# (id 0 never maps to a key) and id j holds f's row j.
SEG_KEYS = [f"seg-{r:02d}" for r in range(1, ROWS)]
KQ_COUNT = 'Count(Row(seg="seg-05"))'
KQ_INTER = 'Count(Intersect(Row(seg="seg-05"), Row(g=1)))'
KQ_TOPN = "TopN(seg, Row(g=0), n=5)"
KQ_LIKE = 'Rows(seg, like="seg-0%")'
KQ_GB = "GroupBy(Rows(seg, limit=4), Rows(g))"
KQ_MISS = 'Count(Row(seg="seg-99"))'
KQ_SETATTR = 'SetRowAttrs(seg, "seg-07", tier="gold")'
KQ_ROW = 'Options(Row(seg="seg-07"), excludeColumns=true)'
KQ_ROW_X = ('Options(Row(seg="seg-07", excludeRowAttrs=true), '
            "excludeColumns=true)")
KQ_ATTR_TOPN = 'TopN(seg, n=5, attrName="tier", attrValue="gold")'
KQ_SEQ = (KQ_COUNT, KQ_INTER, KQ_TOPN, KQ_LIKE, KQ_GB, KQ_MISS)
KQ_MIX = (KQ_COUNT, KQ_INTER, KQ_TOPN, KQ_GB)   # the burst's requests
KQ_NAMES = dict(zip(KQ_SEQ, ("keyed Count", "keyed Count x g",
                             "keyed filtered TopN", "Rows like",
                             "keyed GroupBy", "unknown key")))
KEYS_PASSES = 4
# (b) bench/config15_keyed.py's end-to-end shape, not cut: keyed index
# ``k``, keyed field ``f``, column i has key user-%09d and row key
# seg-%05d of i % 10,000, imported over REST in 10 batches of 100,000
K_COLS, K_ROWS, K_BATCH = 1_000_000, 10_000, 100_000
K_VALUES = 100_000             # the keyed importValue into ``spend``
K_ROW = 42                     # the row the requests read
KC_COUNT = f'Count(Row(f="seg-{K_ROW:05d}"))'
KC_TOPN = "TopN(f, n=5)"
KC_LIKE = 'Rows(f, like="seg-0000%")'
KC_EXTRACT = f'Extract(Limit(Row(f="seg-{K_ROW:05d}"), limit=100), Rows(f))'
KC_INCL = (f'IncludesColumn(Row(f="seg-{K_ROW:05d}"), '
           f'column="user-{K_ROW:09d}")')
KC_SEQ = (KC_COUNT, KC_TOPN, KC_LIKE, KC_EXTRACT, KC_INCL)
KC_NAMES = dict(zip(KC_SEQ, ("k Count", "k TopN", "k Rows like",
                             "k Extract", "k IncludesColumn")))


def _seg_shard(data_dir: str, s: int, f: np.ndarray, g: np.ndarray) -> dict:
    """Shard ``s`` of ``seg`` (f's rows 1-31 under ids 1-31) written as a
    fragment snapshot, and its part of the oracle."""
    from pilosa_tpu_torch.store import roaring
    fs, gs = f[s], g[s]
    with open(os.path.join(data_dir, "bench", "seg", "views", "standard",
                           "fragments", str(s)), "wb") as fh:
        fh.write(roaring.serialize_dense(
            fs[1:], np.arange(1, ROWS, dtype=np.uint64)))
    return {"counts": _popcounts(fs[1:]),
            "inter": int(_popcounts(fs[5] & gs[1])),
            "topn": _popcounts(fs[1:] & gs[0][None, :]),
            "gb": _popcounts(fs[1:5, None, :] & gs[None, :, :])}


def make_keys(data_dir: str, f: np.ndarray, g: np.ndarray,
              shards: int) -> dict:
    """Write the keyed field ``seg`` of ``bench`` (``shards`` fragment
    snapshots and its key store) from ``f`` as written, and return phase
    9's oracle."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.store import FieldOptions
    from pilosa_tpu_torch.store.translate import TranslateStore

    t0 = time.perf_counter()
    _create_fields(data_dir, "bench", {"seg": FieldOptions(keys=True)})
    ts = TranslateStore(data_dir)
    ids = ts.rows("bench", "seg").translate(SEG_KEYS, create=True)
    ts.close()
    if ids != list(range(1, ROWS)):
        raise AssertionError(f"seg's keys got ids {ids}")
    os.makedirs(os.path.join(data_dir, "bench", "seg", "views", "standard",
                             "fragments"), exist_ok=True)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
        parts = list(pool.map(lambda s: _seg_shard(data_dir, s, f, g),
                              range(shards)))
    total = {k: sum(p[k] for p in parts)
             for k in ("counts", "inter", "topn", "gb")}
    counts, top, gbc = total["counts"], total["topn"], total["gb"]
    order = np.argsort(-top, kind="stable")[:5]
    expect = {
        KQ_COUNT: [int(counts[4])],
        KQ_INTER: [total["inter"]],
        KQ_TOPN: [[{"key": SEG_KEYS[i], "count": int(top[i])}
                   for i in order if top[i] > 0]],
        KQ_LIKE: [{"keys": SEG_KEYS[:9]}],
        KQ_GB: [[{"group": [{"field": "seg", "rowKey": SEG_KEYS[i]},
                            {"field": "g", "rowID": r}],
                  "count": int(gbc[i, r])}
                 for i in range(4) for r in range(4) if gbc[i, r]]],
        KQ_MISS: [0],
        KQ_SETATTR: [None],
        KQ_ROW: [{"columns": [], "rowAttrs": {"tier": "gold"}}],
        KQ_ROW_X: [{"columns": []}],
        KQ_ATTR_TOPN: [[{"key": "seg-07", "count": int(counts[6])}]],
    }
    log(f"keyed field seg: 31 keys, {shards} fragment snapshots and the "
        f"oracle in {time.perf_counter() - t0:.1f}s")
    return {"expect": expect}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, files in os.walk(path) for n in files)


def _keyed_device_ms(client, reqs, expect: dict, names: dict, nbytes: dict,
                     index: str) -> None:
    """Each request's device ms under the profiler (three requests per
    trace) beside one read of what it needs at the HBM rate."""
    for q in reqs:
        b_ms = bound(nbytes[q], 0)[0]
        dev_ms, wall_ms, top = traced(
            lambda: client.ask(q, expect[q], reps=3, tag="profiled",
                               index=index), names[q])
        log(f"keys device ms {names[q]}: {dev_ms / 3:.4f} ms per request "
            f"(bound {b_ms:.4f} ms = one read of {nbytes[q] / 1e9:.4f} GB; "
            f"{dev_ms / 3 / b_ms:.1f}x), wall {wall_ms / 3:.3f} ms; by "
            f"kernel: {top}")


def keys_phase(client, holder, planes, keyo: dict, cuda: bool, device,
               clients: int = CLIENTS, passes: int = KEYS_PASSES,
               k_cols: int = K_COLS, k_rows: int = K_ROWS,
               k_batch: int = K_BATCH, k_values: int = K_VALUES) -> dict:
    """Phase 9: (a) the keyed field ``seg`` over the ``bench`` index
    through the default executor (fast lane) and the "off" one, every
    answer against the oracle, with row attributes and an unknown key; the
    device ms of the device requests beside one read of what each needs;
    a burst of ``clients`` x ``passes`` before the profiles and (on the
    card) one after them.  (b) config15's keyed index
    ``k``: ``k_cols`` column keys and ``k_rows`` row keys imported over
    REST in batches of ``k_batch``, its requests through both
    configurations, a keyed ``Set``, column attributes and a keyed
    ``importValue``.  The launch counters are reset when the phase starts
    and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    t0 = time.perf_counter()
    if cuda:
        log(f"phase 9 on {card_line()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    api = client.api
    ex = api.executor
    expect = dict(keyo["expect"])
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    seg = index.field("seg")
    keys = ex.translate.rows("bench", "seg")
    b0 = planes.builds
    ps = planes.field_plane("bench", seg, "standard", shards)
    if planes.builds != b0 + 1:
        raise AssertionError("the seg plane did not build")
    RECORD["seg_build_s"] = planes.last_build_seconds
    log(f"seg plane int32{list(ps.plane.shape)} "
        f"({planes.last_build_bytes / 1e9:.3f} GB) built in "
        f"{planes.last_build_seconds:.2f} s")

    # the "off" configuration shares the plane cache and the key stores
    off = _executor(holder, device=device, plane_budget=32 << 30,
                    delta_compact_fraction=COMPACT_FRACTION,
                    count_batch_window="off", tree_fusion=False,
                    translate=ex.translate)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    # each configuration's first request is timed apart from its median:
    # it may build what the request needs (the plane, the "off" path's
    # rows from every fragment)
    for q in KQ_SEQ:
        client.ask(q, expect[q], tag=f"keys {KQ_NAMES[q]}, first")
        offc.ask(q, expect[q], tag=f"keys off {KQ_NAMES[q]}, first")
        log(f"keys {KQ_NAMES[q]} first request: "
            f"{client.lat[f'keys {KQ_NAMES[q]}, first'][0] * 1e3:.1f} ms "
            f"[default], "
            f"{offc.lat[f'keys off {KQ_NAMES[q]}, first'][0] * 1e3:.1f} ms "
            f"[off]")
    hits0 = ex.serving_stats()["fastLaneHits"]
    for q in KQ_SEQ:
        client.ask(q, expect[q], reps=3, tag=f"keys {KQ_NAMES[q]}")
        offc.ask(q, expect[q], reps=2, tag=f"keys off {KQ_NAMES[q]}")
    if ex.serving_stats()["fastLaneHits"] <= hits0:
        raise AssertionError("phase 9's requests never took the fast lane")
    if len(keys) != len(SEG_KEYS):
        raise AssertionError(f"a read created a key: seg holds {len(keys)}")
    for q in (KQ_SETATTR, KQ_ROW, KQ_ROW_X, KQ_ATTR_TOPN):
        client.ask(q, expect[q], tag=f"keys {q[:30]}")
    for q in (KQ_ROW, KQ_ROW_X, KQ_ATTR_TOPN):
        offc.ask(q, expect[q], tag=f"keys off {q[:30]}")
    for q in KQ_SEQ:
        log(f"latency keys {KQ_NAMES[q]}: median "
            f"{_median_ms(client.lat[f'keys {KQ_NAMES[q]}']):.2f} ms "
            f"[default], "
            f"{_median_ms(offc.lat[f'keys off {KQ_NAMES[q]}']):.2f} ms "
            f"[off]")

    def keyed_burst(when: str) -> None:
        b0 = ex.serving_stats()
        run = burst(api, expect, clients, passes, KQ_MIX, KQ_NAMES)
        b1 = ex.serving_stats()
        n = run["requests"]
        windows = b1["windows"] - b0["windows"]
        items = b1["items"] - b0["items"]
        log(f"[keys] {clients} clients x {passes} passes {when}: {n} "
            f"requests in {run['wall']:.3f} s = {n / run['wall']:.1f} "
            f"requests/s; {windows} windows, {items} items "
            f"({items / max(1, windows):.2f} per window)")
        for q in KQ_MIX:
            ts = run["lat"][q]
            log(f"[keys]   {KQ_NAMES[q]}: p50 {_pct_ms(ts, 0.5):.2f} ms, "
                f"p90 {_pct_ms(ts, 0.9):.2f} ms, p99 "
                f"{_pct_ms(ts, 0.99):.2f} ms, max {max(ts) * 1e3:.2f} ms "
                f"over {len(ts)}")

    # the burst runs before phase 9's profiles and again after them, so
    # that the profiler's sessions and the batcher's window are told apart
    t1 = time.perf_counter()
    keyed_burst("before the phase's profiles")
    t_burst = time.perf_counter() - t1
    if cuda:
        lane = len(shards) * WORDS * 4
        _keyed_device_ms(client, (KQ_COUNT, KQ_INTER, KQ_TOPN, KQ_GB),
                         expect, KQ_NAMES,
                         {KQ_COUNT: lane, KQ_INTER: 2 * lane,
                          KQ_TOPN: ROWS * lane + lane, KQ_GB: 8 * lane},
                         "bench")
        keyed_burst("after them")
        dev_ms, wall_ms, top = traced(
            lambda: burst(api, expect, clients, 1, KQ_MIX, KQ_NAMES),
            "the keyed burst")
        log(f"[keys]   one burst of {clients} x 1 under the profiler: "
            f"device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall = "
            f"{dev_ms / wall_ms:.1%}; by kernel: {top}")
    log(f"phase 9 (a) wall {time.perf_counter() - t0:.1f}s (the first "
        f"burst {t_burst:.1f}s)")

    # (b) config15's keyed index over REST
    t2 = time.perf_counter()
    client.post("/index/k", json.dumps({"options": {"keys": True}}).encode(),
                "create k")
    client.post("/index/k/field/f",
                json.dumps({"options": {"keys": True}}).encode(), "create f")
    client.post("/index/k/field/spend", json.dumps({"options": {
        "type": "int", "min": 0, "max": 1000}}).encode(), "create spend")
    batch_s = []
    for lo in range(0, k_cols, k_batch):
        hi = min(k_cols, lo + k_batch)
        body = json.dumps({
            "rowKeys": [f"seg-{i % k_rows:05d}" for i in range(lo, hi)],
            "columnKeys": [f"user-{i:09d}" for i in range(lo, hi)]}).encode()
        t = time.perf_counter()
        got = client.post("/index/k/field/f/import", body, "REST keyed import")
        batch_s.append(time.perf_counter() - t)
        if got != {"changed": hi - lo}:
            raise AssertionError(f"keyed import: got {got}, want "
                                 f"{hi - lo} changed")
    cols_store = ex.translate.columns("k")
    rows_store = ex.translate.rows("k", "f")
    kdir = os.path.join(holder.path, "k", "_keys")
    log(f"keyed import: {k_cols} pairs in {len(batch_s)} REST batches of "
        f"{k_batch}: per batch first {batch_s[0] * 1e3:.1f} ms, median "
        f"{_median_ms(batch_s):.1f} ms, max {max(batch_s) * 1e3:.1f} ms, "
        f"total {sum(batch_s):.2f} s = {k_cols / sum(batch_s):.0f} pairs/s; "
        f"key stores: {len(cols_store)} column keys, {len(rows_store)} row "
        f"keys, {_dir_bytes(kdir) / 1e6:.1f} MB in k/_keys")
    if (len(cols_store), len(rows_store)) != (k_cols, k_rows):
        raise AssertionError("the key stores hold "
                             f"{len(cols_store)} / {len(rows_store)} keys")
    per_row = k_cols // k_rows
    sel = [f"user-{i:09d}" for i in range(K_ROW, k_cols, k_rows)][:100]
    kexp = {
        KC_COUNT: [per_row],
        KC_TOPN: [[{"key": f"seg-{i:05d}", "count": per_row}
                   for i in range(5)]],
        KC_LIKE: [{"keys": [f"seg-{i:05d}" for i in range(min(10, k_rows))]}],
        KC_EXTRACT: [{"fields": [{"name": "f", "type": "set"}],
                      "columns": [{"key": c, "rows": [[f"seg-{K_ROW:05d}"]]}
                                  for c in sel]}],
        KC_INCL: [True],
    }
    for q in KC_SEQ:
        client.ask(q, kexp[q], tag=f"{KC_NAMES[q]}, first", index="k")
        offc.ask(q, kexp[q], tag=f"off {KC_NAMES[q]}, first", index="k")
        log(f"{KC_NAMES[q]} first request: "
            f"{client.lat[f'{KC_NAMES[q]}, first'][0] * 1e3:.1f} ms "
            f"[default], "
            f"{offc.lat[f'off {KC_NAMES[q]}, first'][0] * 1e3:.1f} ms [off]")
    # k's 2.15 GB plane built in the background while the first requests
    # answered another way
    planes.wait_builds()
    kps = planes.field_plane_nowait("k", holder.index("k").field("f"),
                                   "standard", (0,))
    log(f"k plane int32{list(kps.plane.shape)} "
        f"({kps.plane.numel() * 4 / 1e9:.3f} GB, {kps.n_rows} live rows)")
    for q in KC_SEQ:
        client.ask(q, kexp[q], reps=3, tag=KC_NAMES[q], index="k")
        offc.ask(q, kexp[q], reps=2, tag=f"off {KC_NAMES[q]}", index="k")
    for q in KC_SEQ:
        log(f"latency {KC_NAMES[q]}: median "
            f"{_median_ms(client.lat[KC_NAMES[q]]):.2f} ms [default], "
            f"{_median_ms(offc.lat[f'off {KC_NAMES[q]}']):.2f} ms [off]")
    if cuda:
        klane = WORDS * 4
        _keyed_device_ms(client, (KC_COUNT, KC_TOPN, KC_EXTRACT), kexp,
                         KC_NAMES,
                         {KC_COUNT: klane, KC_TOPN: k_rows * klane,
                          KC_EXTRACT: klane + k_rows * 100 * 4}, "k")
    # a keyed Set that creates a column key and a row key, column
    # attributes, and a keyed importValue
    writes = [
        ('Set("user-new", f="seg-new")', [True]),
        ('Count(Row(f="seg-new"))', [1]),
        (KC_COUNT, [per_row]),
        (f'SetColumnAttrs("user-{K_ROW:09d}", vip=true)', [None]),
        # the reference attaches column attributes by column id, and a
        # keyed index's row result holds keys: the map is empty
        (f'Options(Row(f="seg-{K_ROW:05d}"), columnAttrs=true)',
         [{"keys": sel, "attrs": {}}]),
    ]
    for i, (q, want) in enumerate(writes):
        client.ask(q, want, tag=f"k write {i + 1}", index="k")
    if (len(cols_store), len(rows_store)) != (k_cols + 1, k_rows + 1):
        raise AssertionError("the keyed Set did not create its two keys")
    vals = np.arange(k_values) % 1001
    changed = int(k_values + np.bitwise_count(vals).sum())
    got = client.post("/index/k/field/spend/importValue", json.dumps({
        "columnKeys": [f"user-{i:09d}" for i in range(k_values)],
        "values": vals.tolist()}).encode(), "REST keyed importValue")
    if got != {"changed": changed}:
        raise AssertionError(f"keyed importValue: got {got}, want "
                             f"{changed}")
    client.ask("Sum(field=spend)", [{"value": int(vals.sum()),
                                     "count": k_values}],
               tag="k Sum", index="k")
    offc.ask("Sum(field=spend)", [{"value": int(vals.sum()),
                                   "count": k_values}],
             tag="off k Sum", index="k")
    if (len(cols_store), len(rows_store)) != (k_cols + 1, k_rows + 1):
        raise AssertionError("the keyed importValue created keys")
    for tag in ("k write 1", "k write 2", "REST keyed importValue",
                "k Sum"):
        log(f"latency {tag!r}: {client.lat[tag][0] * 1e3:.2f} ms")
    off.close()   # the key stores stay open: the default executor owns them
    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"phase 9 (b) wall {time.perf_counter() - t2:.1f}s; launches in "
        f"phase 9: {json.dumps(launched)}; peak device memory in the phase "
        f"{peak / 1e9:.2f} GB; phase 9 wall {time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("count", "row_counts", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 9 never launched {k}")
    return {"keys": launched}


# ---------------------------------------------------------------------------
# phase 10: fields past the plane budget
# ---------------------------------------------------------------------------

TAG_ROWS = 5_000_000           # config10's sparse field (SPARSE_ROWS)
TAG_BITS = 20_000_000          # expected bits (one probability per cell)
SMALL_BUDGET = 2 << 30         # below f's 4.0 GB plane: paging, streaming
TENANT_QUOTA = 128 << 20       # two 64 MiB pages of f
QOS_CLIENTS, QOS_COUNTS = 8, 4
SW_MASK = (1 << 20) - 1        # a column's offset in its shard
BT_TOPN = "TopN(tags, Row(f=0), n=5)"
BT_HOST = "TopN(tags, n=5)"
RECORD: dict = {}              # numbers one phase passes to a later one


def make_tags(data_dir: str, shards: int, seed: int) -> dict:
    """``bench/config10_product_families.py``'s sparse field, not cut:
    field ``tags`` of ``bench`` (created with the index), about TAG_BITS
    bits, each (row, column) cell of TAG_ROWS rows over every column of
    ``shards`` shards set with one probability, written as one fragment
    snapshot per shard.  Returns the bits' rows and columns, sorted by
    row."""
    from pilosa_tpu_torch.store import roaring

    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 10])
    # each (row, column) cell set with probability TAG_BITS / cells: the
    # set cells in row-major order are a cumulative sum of geometric gaps,
    # sorted and distinct as drawn (no sort of 20M keys: the card
    # machine's host sorts slowly)
    width = shards << 20
    cells = TAG_ROWS * width
    pos = np.cumsum(rng.geometric(TAG_BITS / cells, TAG_BITS)) - 1
    pos = pos[pos < cells].astype(np.uint64)
    rows = pos // np.uint64(width)
    cols = pos % np.uint64(width)
    del pos
    shard = (cols >> np.uint64(20)).astype(np.uint16)
    order = np.argsort(shard, kind="stable")  # a radix sort on 16 bits
    srows, scols = rows[order], cols[order]
    bounds = np.searchsorted(shard[order], np.arange(shards + 1))
    del shard, order
    tdir = os.path.join(data_dir, "bench", "tags", "views", "standard",
                        "fragments")
    os.makedirs(tdir, exist_ok=True)
    nbytes = 0
    for s in range(shards):
        a, b = bounds[s], bounds[s + 1]
        if a == b:
            continue
        blob = roaring.serialize((srows[a:b] << np.uint64(20))
                                 | (scols[a:b] & np.uint64(SW_MASK)))
        nbytes += len(blob)
        with open(os.path.join(tdir, str(s)), "wb") as fh:
            fh.write(blob)
    log(f"tags: {len(rows)} bits (about {TAG_BITS}) over {TAG_ROWS} "
        f"rows, {shards} fragment snapshots, {nbytes / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.1f}s")
    return {"rows": rows, "cols": cols}


def _pairs(totals: np.ndarray, n: int) -> list:
    """TopN pairs: count descending, ties by row id, zeros dropped."""
    order = np.argsort(-totals, kind="stable")[:n]
    return [{"id": int(r), "count": int(totals[r])} for r in order
            if totals[r] > 0]


def _tanimoto(t: np.ndarray, rc: np.ndarray, src: int, thr: float,
              n: int) -> list:
    keep = (t > 0) & (100.0 * t >= thr * (src + rc - t))
    return _pairs(np.where(keep, t, 0), n)


def make_budget_oracle(f: np.ndarray, g: np.ndarray, tags: dict,
                       f_counts: list) -> dict:
    """Phase 10's answers over ``f`` and ``g`` as phases 4-8 leave them and
    over ``tags``."""
    t0 = time.perf_counter()
    shards = f.shape[0]
    filtered = np.zeros(ROWS, np.int64)
    src = 0
    for s0 in range(0, shards, 64):
        g0 = g[s0:s0 + 64, 0]
        filtered += _popcounts(f[s0:s0 + 64] & g0[:, None, :]).sum(axis=0)
        src += int(_popcounts(g0).sum())
    rc = np.asarray(f_counts, np.int64)
    # a threshold between the two middle coefficients: half the rows pass
    coef = np.sort(100.0 * filtered / (src + rc - filtered))
    thr_s = f"{(coef[ROWS // 2 - 1] + coef[ROWS // 2]) / 2:.9f}"
    thr = float(thr_s)
    kept = (100.0 * filtered >= thr * (src + rc - filtered)).sum()
    f_tan = f"TopN(f, Row(g=0), tanimoto={thr_s}, n=5)"
    f_part = "TopN(f, Row(g=0), _rowCounts=1)"
    # tags: the filter f row 0, the hosts' cards, and a tanimoto source row
    rows, cols = tags["rows"], tags["cols"]
    shard = (cols >> np.uint64(20)).astype(np.int64)
    off = (cols & np.uint64(SW_MASK)).astype(np.int64)
    hit = ((f[shard, 0, off >> 5] >> (off & 31).astype(np.uint32)) & 1) == 1
    del shard, off
    t_f0 = np.bincount(rows[hit].astype(np.int64), minlength=TAG_ROWS)
    t_rc = np.bincount(rows.astype(np.int64), minlength=TAG_ROWS)
    # a source row sharing columns with other rows, so that tanimoto=50
    # keeps some of them and drops others (the bits come sorted by row)
    rrow, rcol = rows, cols
    by_col = np.argsort(cols, kind="stable")
    scol, srow = cols[by_col], rows[by_col]
    del by_col
    dup = np.flatnonzero(scol[1:] == scol[:-1])
    pick = None
    for r in dict.fromkeys(srow[dup[:4000]].tolist()):
        # a uint64 needle: a Python int would cast all of rrow per search
        r64 = np.uint64(r)
        cs = rcol[np.searchsorted(rrow, r64):
                  np.searchsorted(rrow, r64, "right")]
        lo = np.searchsorted(scol, cs)
        hi = np.searchsorted(scol, cs, "right")
        share, t = np.unique(np.concatenate(
            [srow[a_:b_] for a_, b_ in zip(lo, hi)]), return_counts=True)
        other = share != r
        share, t = share[other].astype(np.int64), t[other]
        ok = 100.0 * t >= 50.0 * (len(cs) + t_rc[share] - t)
        if (~ok).any() and (ok.any() or pick is None):
            pick = (int(r), share, t, len(cs))
            if ok.any():
                break
    r, share, t, tsrc = pick
    t_r = np.zeros(TAG_ROWS, np.int64)
    t_r[share] = t
    t_r[r] = tsrc
    tag_tan = f"TopN(tags, Row(tags={r}), tanimoto=50, n=5)"
    out = {
        "seq": (BT_TOPN, BT_HOST, tag_tan),
        "expect": {BT_TOPN: [_pairs(t_f0, 5)], BT_HOST: [_pairs(t_rc, 5)],
                   tag_tan: [_tanimoto(t_r, t_rc, tsrc, 50.0, 5)],
                   Q32: [int(c) for c in rc],
                   Q4: [int(rc[r_]) for r_ in SELECTED],
                   TOPN_G: [_pairs(filtered, 5)],
                   f_tan: [_tanimoto(filtered, rc, src, thr, 5)],
                   f_part: [{"pairs": [
                       {"id": r_, "count": int(filtered[r_]),
                        "rowCount": int(rc[r_])}
                       for r_ in range(ROWS) if rc[r_] > 0],
                       "srcCount": src}]},
        "f_seq": (Q32, Q4, TOPN_G, f_tan, f_part),
        "tags_bits": len(rows), "tags_rows": int((t_rc > 0).sum()),
        "tanimoto_row": r, "filtered": filtered}
    log(f"phase 10 oracle in {time.perf_counter() - t0:.1f}s: tanimoto "
        f"{thr_s} over f keeps {kept} of {ROWS} rows; tags source row {r} "
        f"({tsrc} bits) keeps "
        f"{len(out['expect'][tag_tan][0])} pairs at 50")
    return out


def _sparse_device_ms(planes, holder, shards, cuda: bool) -> list:
    """Device ms of the sparse counts and top-k over ``tags`` filtered by
    f row 0, beside one read of the CSR arrays, the gathered filter words
    and the counts."""
    from pilosa_tpu_torch.engine import sparse as sparsek
    idx = holder.index("bench")
    ss = planes.sparse_plane("bench", idx.field("tags"), "standard", shards)
    fw = planes.row_words("bench", idx.field("f"), "standard", 0, shards)
    n = int(ss.row_ptr[-1])
    r = ss.n_rows
    csr = 8 * n + 4 * (r + 1)
    out = []
    for name, fn, nbytes in (
            ("sparse_row_counts", lambda: sparsek.sparse_row_counts(
                fw, ss.word_idx, ss.mask, ss.row_ptr),
             csr + 4 * n + 4 * r),
            ("topn_sparse k=8", lambda: sparsek.topn_sparse(
                fw, ss.word_idx, ss.mask, ss.row_ptr, 8),
             csr + 4 * n + 8 * 8)):
        ms = time_ms(fn, 5) if cuda else float("nan")
        b_ms, b_by = bound(nbytes, 0)
        out.append({"name": name, "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, "bits": n, "rows": r,
                    "n_pad": int(ss.word_idx.numel()),
                    "r_pad": ss.n_rows_pad, "nbytes": ss.nbytes})
        log(f"[budget] {name} over {n} bits / {r} rows (N_pad "
            f"{ss.word_idx.numel()}, R_pad {ss.n_rows_pad}, "
            f"{ss.nbytes / 1e6:.1f} MB resident): {ms:.3f} ms, bound "
            f"{b_ms:.3f} ms by {b_by} ({b_ms / ms:.1%} of the bound rate)")
    return out


def budget_phase(client, holder, planes, bo: dict, cuda: bool,
                 device) -> dict:
    """Phase 10: (a) config10's sparse field through the default executor
    and the "off" one (sparse top-k, host cards, sparse tanimoto); (b) f
    past a 2 GiB budget in both configurations (paged Counts, streamed
    TopN, tanimoto and _rowCounts) and under a 128 MiB tenant quota; (c)
    serve-while-build; (d) a tenant slot quota over REST.  The launch
    counters are reset when the phase starts and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    t0 = time.perf_counter()
    if cuda:
        log(f"phase 10 on {card_line()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    ex = client.api.executor
    expect = bo["expect"]
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    tags = index.field("tags")

    # (a) the sparse field through both configurations
    off = _executor(holder, device=device, plane_budget=32 << 30,
                    count_batch_window="off", tree_fusion=False,
                    translate=ex.translate)
    off.planes = planes
    offc = _Client(API(holder, off), cuda)
    est = planes.plane_bytes(tags, "standard", shards)
    sb = planes.sparse_bytes(tags, "standard", shards)
    log(f"[budget] tags: dense plane estimate {est / 1e15:.3f} PB, sparse "
        f"residency {sb / 1e6:.1f} MB ({bo['tags_bits']} bits, "
        f"{bo['tags_rows']} rows); estimates in "
        f"{time.perf_counter() - t0:.1f}s")
    for q in bo["seq"]:
        t = time.perf_counter()
        client.ask(q, expect[q], tag=f"budget {q[:28]}, first")
        first = time.perf_counter() - t
        t = time.perf_counter()
        offc.ask(q, expect[q], tag=f"budget off {q[:28]}, first")
        log(f"[budget] {q}: first {first * 1e3:.1f} ms [default], "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms [off]")
    for q in bo["seq"]:
        client.ask(q, expect[q], reps=2, tag=f"budget {q[:28]}")
        log(f"[budget] {q}: median "
            f"{_median_ms(client.lat[f'budget {q[:28]}']):.2f} ms")
    served = {"default": ex.serving_stats()["topnServed"],
              "off": off.serving_stats()["topnServed"]}
    log(f"[budget] TopNs served over tags: {json.dumps(served)}")
    for cfg, by in served.items():
        if by["sparse"] < 2 or by["host"] < 1:
            raise AssertionError(f"the sparse and host paths were not "
                                 f"taken [{cfg}]: {by}")
    sparse_ms = _sparse_device_ms(planes, holder, shards, cuda)
    off.close()
    t_a = time.perf_counter() - t0

    # (b) f past a 2 GiB budget, both configurations (with fewer
    # --shards, half f's plane, and the quota an eighth)
    t1 = time.perf_counter()
    f_plane = len(shards) * ROWS * WORDS * 4
    small_budget = SMALL_BUDGET if f_plane > SMALL_BUDGET else f_plane // 2
    quota = TENANT_QUOTA if f_plane > 8 * TENANT_QUOTA else f_plane // 8
    small = {}
    for cfg, kw in (("default", {}),
                    ("off", {"count_batch_window": "off",
                             "tree_fusion": False})):
        e = _executor(holder, device=device, plane_budget=small_budget,
                      translate=ex.translate, **kw)
        c = _Client(API(holder, e), cuda)
        for q in bo["f_seq"]:
            c.ask(q, expect[q], tag=f"{cfg} {q[:30]}")
        ten = e.tenancy_status()
        small[cfg] = (e, c, ten)
        log(f"[budget] f past {small_budget / 2**30:.2f} GiB [{cfg}]: "
            f"{ten['pageIns']} page-ins in {ten['pageInSeconds']:.2f} s, "
            f"{ten['residentPages']} resident pages, evictions "
            f"{json.dumps(ten['evictionsByReason'])}, TopNs "
            f"{json.dumps(e.serving_stats()['topnServed'])}; latency "
            + ", ".join(f"{n} {c.lat[f'{cfg} {q[:30]}'][0] * 1e3:.1f} ms"
                        for n, q in zip(("32-Count", "4-Count", "TopN",
                                         "tanimoto", "_rowCounts"),
                                        bo["f_seq"])))
        if (ten["pageIns"] < 2 or e.planes.builds
                or e.serving_stats()["topnServed"]["streamed"] != 3):
            raise AssertionError(f"f was not paged and streamed [{cfg}]")
    dc, dten = small["default"][1], small["default"][2]
    RECORD["budget_f"] = {
        "lat": {q: dc.lat[f"default {q[:30]}"][0] for q in bo["f_seq"][:3]},
        "pageIns": dten["pageIns"], "pageInSeconds": dten["pageInSeconds"]}
    pages = small["default"][0].pager.partition(index.field("f"),
                                                 "standard", shards)
    log(f"[budget] f in {len(pages)} pages of {len(pages[0])} shards "
        f"({len(pages[0]) * ROWS * WORDS * 4 / 2**20:.0f} MiB)")
    # a tenant byte quota of two pages: the query leases two, the rest
    # answer from the host's row cardinalities
    qe = _executor(holder, device=device, plane_budget=32 << 30,
                   tenant_byte_quota=quota, translate=ex.translate)
    qc = _Client(API(holder, qe), cuda)
    qc.ask(Q32, expect[Q32], tag="quota 32-Count")
    qten = qe.tenancy_status()
    log(f"[budget] 32-Count under a {quota >> 20} MiB quota: "
        f"{qc.lat['quota 32-Count'][0] * 1e3:.1f} ms, page-ins "
        f"{qten['pageIns']}, quota denials {qten['quotaDenials']}, oracle "
        f"serves {qten['oracleServes']}, resident "
        f"{qten['tenants']['bench']['residentBytes'] / 2**20:.0f} MiB")
    if qten["quotaDenials"] < 1 or qten["oracleServes"] < 1:
        raise AssertionError(f"the quota denied nothing: {qten}")
    for e, _, _ in small.values():
        e.planes.evict_unpinned(reason="phase end")
        e.close()
    qe.planes.evict_unpinned(reason="phase end")
    qe.close()
    small_lat = {cfg: dict(c.lat) for cfg, (_, c, _) in small.items()}
    del small, qe, qc
    if cuda:
        torch.cuda.empty_cache()
    t_b = time.perf_counter() - t1

    # (c) serve-while-build: a fresh executor, f's plane not yet resident
    t2 = time.perf_counter()
    be = _executor(holder, device=device, plane_budget=32 << 30,
                   translate=ex.translate)
    if f_plane <= be.planes.SYNC_BUILD_MAX:
        be.planes.SYNC_BUILD_MAX = f_plane // 2
        log(f"CUT: SYNC_BUILD_MAX {f_plane // 2} bytes, below f's plane")
    bc = _Client(API(holder, be), cuda)
    bc.ask(TOPN_G, expect[TOPN_G], tag="build first")
    st = be.planes.stats()
    # one build: in flight, publishing (counted, not yet cleared) or done
    started = (st["builds"] <= 1 and st["building"] <= 1
               and st["builds"] + st["building"] >= 1)
    log(f"[budget] first filtered TopN while the plane builds: "
        f"{bc.lat['build first'][0] * 1e3:.1f} ms, TopNs "
        f"{json.dumps(be.serving_stats()['topnServed'])}, building "
        f"{st['building']}, built {st['builds']}")
    if be.serving_stats()["topnServed"]["streamed"] != 1 or not started:
        raise AssertionError("the first TopN did not stream beside one "
                             "background build")
    be.planes.wait_builds()
    st = be.planes.stats()
    bc.ask(TOPN_G, expect[TOPN_G], reps=3, tag="build after")
    if (st["buildFailures"] or st["builds"] != 1
            or be.serving_stats()["topnServed"]["dense"] != 3):
        raise AssertionError(f"the background build did not serve: {st}")
    log(f"[budget] background build {st['lastBuildSeconds']:.2f} s "
        f"({st['lastBuildBytes'] / 1e9:.2f} GB); then the TopN over the "
        f"plane: median {_median_ms(bc.lat['build after']):.2f} ms; the "
        f"synchronous seg build in phase 9: "
        f"{RECORD.get('seg_build_s', float('nan')):.2f} s")
    t_c = time.perf_counter() - t2

    # (d) a tenant slot quota over REST: 8 clients x 4 Counts
    t3 = time.perf_counter()
    qx = _executor(holder, device=device, plane_budget=32 << 30,
                   tenant_slot_quota=1, translate=ex.translate)
    qx.planes = be.planes
    server = Server(API(holder, qx), "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address
    want = expect[Q32][1]
    codes: list = []
    lock = threading.Lock()

    def count_client() -> None:
        for _ in range(QOS_COUNTS):
            req = urllib.request.Request(base + "/index/bench/query",
                                         data=b"Count(Row(f=1))",
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    got = (resp.status, None,
                           json.loads(resp.read())["results"])
            except urllib.error.HTTPError as err:
                got = (err.code, err.headers.get("Retry-After"),
                       json.loads(err.read()))
            with lock:
                codes.append(got)

    try:
        threads = [threading.Thread(target=count_client)
                   for _ in range(QOS_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        shed = [c for c in codes if c[0] == 503]
        if not shed:
            # the burst never overlapped: hold the tenant's slot
            qx.qos.admit("bench")
            try:
                count_client()
            finally:
                qx.qos.release("bench")
            shed = [c for c in codes if c[0] == 503]
        with urllib.request.urlopen(base + "/status", timeout=60) as resp:
            tstat = json.loads(resp.read())["tenancy"]
    finally:
        server.close()
    ok = [c for c in codes if c[0] == 200]
    bad = [c for c in ok if c[2] != [want]]
    tt = shed[0][2].get("tenantThrottled") if shed else None
    log(f"[budget] QoS over REST ({QOS_CLIENTS} clients x {QOS_COUNTS} "
        f"Counts, slot quota 1): {len(ok)} answered, {len(shed)} shed with "
        f"503 (Retry-After {shed[0][1] if shed else None}, body "
        f"{json.dumps(tt)}); /status sheds {json.dumps(tstat['qos'])}")
    if (bad or not shed or any(c[1] is None for c in shed)
            or tt != {"tenant": "bench", "quota": 1, "kind": "slots"}
            or tstat["qos"]["sheds"].get("bench") != len(shed)
            or len(ok) + len(shed) != len(codes)):
        raise AssertionError(f"QoS over REST: {codes[:5]} {tstat}")
    qx.close()
    be.planes.evict_unpinned(reason="phase end")
    be.close()
    t_d = time.perf_counter() - t3

    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"launches in phase 10: {json.dumps(launched)}; peak device memory "
        f"in the phase {peak / 1e9:.2f} GB; phase 10 walls (a) {t_a:.1f}s "
        f"(b) {t_b:.1f}s (c) {t_c:.1f}s (d) {t_d:.1f}s, total "
        f"{time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("row_counts", "count", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 10 never launched {k}")
    return {"budget": launched}


# ---------------------------------------------------------------------------
# phase 11: protobuf bodies, the distinct kind, deadlines, the watchdog and
# the health governor, device-OOM recovery
# ---------------------------------------------------------------------------

RB_VALUES = 1024               # the protobuf importValue batch
RB_VALUE_SHARDS = 4            # shards its columns come from
RB_PASSES = 2                  # passes of the distinct burst
RB_DOOMED_REQS = 4             # requests per client of the deadline burst
RB_WATCHDOG_S = 0.01           # below a GroupBy Max window's device time
OB_WATCHDOG_S = 0.05           # phase 14: above a GroupBy Max window's
#                                dispatch (host launches, ~14 ms), below the
#                                ~0.2 s device sleep queued ahead of it
RQ_PCT = "Percentile(field=amount, nth=99)"
RQ_PCT2 = RQ_PCT + RQ_PCT      # a deadline expires between the two
RQ_DISTINCT = "Distinct(field=amount)"
RQ_DISTINCT_F = "Distinct(Row(g=0), field=amount)"  # a shared filter
RQ_SUM = "Sum(field=amount)"
RQ_EXTRACT = "Extract(Limit(Row(f=0), limit=10), Rows(f))"
PROTO = "application/x-protobuf"


def _pct_expect(hist: "_Hist", nth: float) -> list:
    total, cnt = hist.sum_count()
    target = min(cnt, max(1, math.ceil(nth / 100.0 * cnt)))
    v = int(np.searchsorted(np.cumsum(hist.h), target)) + BSI_MIN
    return _vc(v, hist.at(v))


def _amount_shard(s: int, seed: int, f1: np.ndarray, g: np.ndarray,
                  offs: np.ndarray, vals_at: np.ndarray,
                  present: np.ndarray) -> list:
    """Shard ``s`` of ``amount`` as generated, overwritten at ``offs`` by
    ``vals_at`` (``_EMPTY`` = none): per ``g`` row, the count of ``f`` row
    1 (``f1``) in it and the (max, its count) of the values there; the
    values in ``g`` row 0 are marked in ``present`` (shared: every writer
    only sets)."""
    exists, vals = _bsi_values(seed, s)
    vals = vals.astype(np.int64)
    exists[offs] = vals_at != _EMPTY
    vals[offs] = np.where(exists[offs], vals_at, 0)
    f1b = _bits(f1)
    gb = []
    for k in range(4):
        m = _bits(g[k]) & f1b & exists
        best = int(vals[m].max()) if m.any() else None
        gb.append((int(_popcounts(g[k] & f1)),
                   None if best is None
                   else (best, int((vals[m] == best).sum()))))
    present[vals[_bits(g[0]) & exists] - BSI_MIN] = True
    return gb


def _amount_expect(f: np.ndarray, g: np.ndarray, shards: int, seed: int,
                   writes: list) -> tuple:
    """Over ``f`` as it stands and ``amount`` after ``writes`` ((columns,
    values) in write order): ``GroupBy(Rows(g), filter=Row(f=1),
    aggregate=Max(field=amount))`` and the distinct values in ``g`` row 0
    (phase 6's set batch changes ``f`` row 1, so phase 6's own answer for
    that GroupBy holds only before it)."""
    from concurrent.futures import ThreadPoolExecutor
    cols = np.concatenate([c for c, _ in writes])
    vals = np.concatenate([v for _, v in writes]).astype(np.int64)
    order = np.argsort(cols, kind="stable")
    cols, vals = cols[order], vals[order]
    last = np.r_[cols[1:] != cols[:-1], True]   # the last write wins
    cols, vals = cols[last], vals[last]
    b = np.searchsorted(cols, np.arange(shards + 1) << 20)
    present = np.zeros(BSI_MAX - BSI_MIN + 1, bool)
    with ThreadPoolExecutor(max_workers=8) as pool:
        parts = list(pool.map(
            lambda s: _amount_shard(s, seed, f[s, 1], g[s],
                                    cols[b[s]:b[s + 1]] & _MASK20,
                                    vals[b[s]:b[s + 1]], present),
            range(shards)))
    counts = [sum(p[k][0] for p in parts) for k in range(4)]
    maxes = []
    for k in range(4):
        ms = [p[k][1] for p in parts if p[k][1] is not None]
        best = max((v for v, _ in ms), default=None)
        maxes.append(None if best is None
                     else (best, sum(c for v, c in ms if v == best)))
    return ([_gb_json(("g",), [(k,) for k in range(4)], counts,
                      [m and m[0] for m in maxes])],
            [{"values": [int(v) for v in np.flatnonzero(present)
                         + BSI_MIN]}])


def make_robust(f: np.ndarray, g: np.ndarray, shards: int, seed: int,
                oracle: dict) -> dict:
    """Phase 11's oracle over ``f`` as phase 10 leaves it and ``amount``
    as phase 6 leaves it: the protobuf pair batch into ``f`` (rows 2..31,
    so GroupBy's ``Row(f=1)`` filter keeps its columns), the protobuf
    value batch into ``amount`` (columns no earlier batch wrote, outside
    ``f`` row 1), and the answers before and after each."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    bo, bsi = oracle["budget"], oracle["bsi"]
    state = {"counts": np.asarray(oracle["mutex"]["f_counts"], np.int64),
             "filtered": bo["filtered"].copy()}

    def f_answers() -> dict:
        c = state["counts"]
        return {Q32: [int(x) for x in c], Q4: [int(c[r]) for r in SELECTED],
                TOPN_G: [_pairs(state["filtered"], 5)]}

    before = f_answers()
    rows = rng.integers(2, ROWS, BATCH)
    cols = np.sort(rng.choice(shards << 20, BATCH, replace=False))
    hit = _apply_pairs(f, g[:, 0], state, rows, cols, clear=False)
    after = f_answers()
    # amount: phase 5's histogram plus phase 6's value batch
    hist = _Hist(bsi["hist"].h.copy())
    vc6, new6, old6, _ = bsi["gb_values"]
    hist.move(old6, new6)
    cand, final = bsi["final"]
    written = np.union1d(cand, vc6)
    vcols, olds = [], []
    per = RB_VALUES // RB_VALUE_SHARDS
    for s in range(min(RB_VALUE_SHARDS, shards)):
        exists, vals = _bsi_values(seed, s)
        free = np.ones(1 << 20, bool)
        free[written[(written >> 20) == s] & _MASK20] = False
        free &= ~_bits(f[s, 1])
        offs = np.sort(rng.choice(np.flatnonzero(free), per, replace=False))
        vcols.append((s << 20) + offs)
        olds.append(np.where(exists[offs], vals[offs].astype(np.int64),
                             _EMPTY))
    vcols, old = np.concatenate(vcols), np.concatenate(olds)
    new = rng.integers(BSI_MIN, BSI_MAX + 1, len(vcols))
    new[:8] = BSI_MIN
    vchanged = _changed_bits(old, new)
    sum_before = _vc(*hist.sum_count())
    hist.move(old, new)
    vals = hist.nonzero()
    gb_max, distinct_g0 = _amount_expect(
        f, g, shards, seed, [(cand, final), (vc6, new6), (vcols, new)])
    bsi_after = {
        RQ_SUM: _vc(*hist.sum_count()),
        RQ_PCT: _pct_expect(hist, 99),
        RQ_DISTINCT: [{"values": [int(v) for v in vals]}],
        RQ_DISTINCT_F: distinct_g0,
        GB_SEQ[3]: gb_max,
    }
    log(f"phase 11 oracle in {time.perf_counter() - t0:.1f}s: the pair "
        f"batch sets {int(hit.sum())} bits, the value batch changes "
        f"{vchanged} bits; amount holds {len(vals)} distinct values, "
        f"{len(distinct_g0[0]['values'])} in g row 0")
    return {"before": before, "after": after,
            "state": {k: v.copy() for k, v in state.items()},
            "pairs": (rows, cols, int(hit.sum())),
            "values": (vcols, new, vchanged), "sum_before": sum_before,
            "bsi": bsi_after,
            "m16": oracle["mutex"]["after_import"][MQ16]}


def _http(base: str, path: str, body: bytes | None = None,
          headers: dict | None = None, method: str = "POST"):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(base + path, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _ballast(need: int) -> list:
    """Device tensors that leave less than ``need / 2`` allocatable: the
    card's free memory after ``empty_cache()`` (sized from
    ``torch.cuda.mem_get_info()``) less ``need / 2`` in one piece, then
    pieces of ``need / 2`` until one fails, which also takes every block
    of that size the caching allocator keeps in partly used segments."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step = max(need // 2, 2 << 20)
    free = torch.cuda.mem_get_info()[0]
    pieces = []
    if free > 2 * step:
        pieces.append(torch.empty(free - step, dtype=torch.uint8,
                                  device="cuda"))
    while True:
        try:
            pieces.append(torch.empty(step, dtype=torch.uint8,
                                      device="cuda"))
        except torch.OutOfMemoryError:
            break
    torch.cuda.empty_cache()
    return pieces


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def robust_phase(client, holder, planes, ro: dict, cuda: bool,
                 device) -> dict:
    """Phase 11: (a) protobuf ``/query``, ``/import`` (with an
    ``X-Pilosa-Op-Id``) and ``importValue`` over REST; (b) the
    ``distinct`` kind under a burst; (c) ``?timeout=`` 504s and a Count
    burst with tight deadlines; (d) a watchdog trip on a real window,
    degraded serving and a probe back to healthy; (e) a real device OOM
    recovered by stage 1.  The launch counters are reset when the phase
    starts and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API, ApiError, Server, proto
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor

    t0 = time.perf_counter()
    if cuda:
        log(f"phase 11 on {card_line()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    api = client.api
    ex = api.executor
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    f_field = index.field("f")

    # (a) protobuf over REST, on the default executor
    server = Server(api, "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address
    both = {"Content-Type": PROTO, "Accept": PROTO}
    try:
        lat: dict = {}
        for pql in (Q32, Q4, TOPN_G):
            want = ro["before"][pql]
            for _ in range(6):
                (st, _, raw), ms_j = _timed(lambda: _http(
                    base, "/index/bench/query", pql.encode()))
                if st != 200 or json.loads(raw)["results"] != want:
                    raise AssertionError(f"JSON {pql[:40]}: {st} "
                                         f"{raw[:200]!r}")
                (st, ct, raw), ms_p = _timed(lambda: _http(
                    base, "/index/bench/query",
                    proto.encode_query_request(pql), both))
                got = proto.decode_query_response(raw)
                if st != 200 or ct != PROTO or got["results"] != want:
                    raise AssertionError(f"protobuf {pql[:40]}: {st} {got}")
                lat.setdefault(pql, ([], []))
                lat[pql][0].append(ms_j)
                lat[pql][1].append(ms_p)
        planes.wait_builds()
        for pql, (js, ps) in lat.items():
            log(f"[robust] REST {MIX_NAMES[pql]}: JSON median "
                f"{sorted(js)[len(js) // 2]:.2f} ms, protobuf median "
                f"{sorted(ps)[len(ps) // 2]:.2f} ms over {len(js)} "
                f"(first JSON {js[0]:.2f} ms)")
        # a 4096-pair protobuf import into f with an op id: absorbed into
        # the resident plane's overlay, no build
        rows, cols, changed = ro["pairs"]
        if not planes.has_plane("bench", f_field, "standard", shards):
            raise AssertionError("f's plane is not resident before the "
                                 "protobuf import")
        builds, absorbs = planes.builds, planes.delta_absorbs
        body = proto.encode_import_request(row_ids=rows, col_ids=cols)
        (st, ct, raw), ms_i = _timed(lambda: _http(
            base, "/index/bench/field/f/import", body,
            {"Content-Type": PROTO, "Accept": PROTO,
             "X-Pilosa-Op-Id": "phase11-pairs"}))
        got = proto.decode_import_response(raw)
        if st != 200 or ct != PROTO or got["changed"] != changed:
            raise AssertionError(f"protobuf import: {st} {got}, want "
                                 f"{changed}")
        for pql in (Q32, Q4, TOPN_G):
            client.ask(pql, ro["after"][pql], tag="robust " + pql)
        if planes.builds != builds or planes.delta_absorbs <= absorbs:
            raise AssertionError(
                f"the protobuf import was not absorbed: builds {builds} -> "
                f"{planes.builds}, absorbs {absorbs} -> "
                f"{planes.delta_absorbs}")
        log(f"[robust] protobuf /import of {len(rows)} pairs with "
            f"X-Pilosa-Op-Id: {ms_i:.2f} ms, changed {changed}, absorbed "
            f"(absorbs +{planes.delta_absorbs - absorbs}, builds +0)")
        # a 1024-value protobuf importValue into amount, then Sum
        client.ask(RQ_SUM, ro["sum_before"], tag="robust Sum before")
        vcols, vals, vchanged = ro["values"]
        body = proto.encode_import_value_request(
            col_ids=vcols, values=[int(v) for v in vals])
        (st, _, raw), ms_v = _timed(lambda: _http(
            base, "/index/bench/field/amount/importValue", body,
            {"Content-Type": PROTO}))
        if st != 200 or json.loads(raw)["changed"] != vchanged:
            raise AssertionError(f"protobuf importValue: {st} {raw!r}, "
                                 f"want {vchanged}")
        client.ask(RQ_SUM, ro["bsi"][RQ_SUM], tag="robust Sum after")
        log(f"[robust] protobuf importValue of {len(vcols)} values "
            f"(from {vals.min()}): {ms_v:.2f} ms, changed {vchanged}; Sum "
            f"after {ro['bsi'][RQ_SUM]}")
        # Extract asked for in protobuf: answered with the protobuf error
        st, ct, raw = _http(base, "/index/bench/query",
                            proto.encode_query_request(RQ_EXTRACT), both)
        err = proto.decode_query_response(raw).get("error", "")
        if st != 400 or ct != PROTO or "Extract" not in err:
            raise AssertionError(f"protobuf Extract: {st} {ct} {err!r}")
        log(f"[robust] protobuf Extract: {st}, error {err!r}")
    finally:
        server.close()
    t_a = time.perf_counter() - t0

    # (b) the distinct kind: identical concurrent Distincts share a scan
    t1 = time.perf_counter()
    dexpect = {q: ro["bsi"][q] for q in (RQ_DISTINCT, RQ_DISTINCT_F)}
    for q in dexpect:
        client.ask(q, dexpect[q], tag="robust " + q)
    b0 = ex.serving_stats()
    run = burst(api, dexpect, CLIENTS, RB_PASSES,
                mix=(RQ_DISTINCT, RQ_DISTINCT_F),
                names={RQ_DISTINCT: "Distinct",
                       RQ_DISTINCT_F: "filtered Distinct"})
    b1 = ex.serving_stats()
    scans = b1["distinctScans"] - b0["distinctScans"]
    dwin = b1["distinctWindows"] - b0["distinctWindows"]
    reqs = run["requests"]
    log(f"[robust] distinct burst {CLIENTS} x {RB_PASSES} x 2: {reqs} "
        f"requests in {run['wall']:.3f} s ({reqs / run['wall']:.1f}/s), "
        f"{dwin} windows, {scans} presence scans ({scans / max(1, dwin):.2f} "
        f"per window, {reqs / max(1, scans):.2f} requests per scan); p50 "
        + ", ".join(f"{n} {_pct_ms(run['lat'][q], 0.5):.1f} ms"
                    for q, n in ((RQ_DISTINCT, "Distinct"),
                                 (RQ_DISTINCT_F, "filtered"))))
    if not 0 < scans < reqs:
        raise AssertionError(f"{scans} distinct scans for {reqs} requests: "
                             "no dedupe")
    t_b = time.perf_counter() - t1

    # (c) deadlines: an executor without the fast lane behind REST, so
    # requests wait in the batcher, sharing the plane cache
    t2 = time.perf_counter()
    nofl = _executor(holder, device=device, plane_budget=32 << 30,
                     solo_fastlane=False, translate=ex.translate)
    nofl.planes = planes
    napi = API(holder, nofl)
    nclient = _Client(napi, cuda)
    server = Server(napi, "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address
    gbq, gb_want = GB_SEQ[3], ro["bsi"][GB_SEQ[3]]
    try:
        _, pct_ms = _timed(lambda: nclient.ask(RQ_PCT, ro["bsi"][RQ_PCT]))
        _, pct_ms = _timed(lambda: nclient.ask(RQ_PCT, ro["bsi"][RQ_PCT]))
        _, gb_ms = _timed(lambda: nclient.ask(gbq, gb_want))
        _, gb_ms = _timed(lambda: nclient.ask(gbq, gb_want))
        timeouts = {}
        for tag, pql, budget in (
                ("Percentile x2", RQ_PCT2, round(0.6 * pct_ms / 1e3, 4)),
                ("GroupBy Max", gbq, round(min(0.03, 0.3 * gb_ms / 1e3), 4))):
            (st, _, raw), ms = _timed(lambda: _http(
                base, f"/index/bench/query?timeout={budget}", pql.encode()))
            body = json.loads(raw)
            tb = body.get("timeout")
            if st != 504 or tb is None or sorted(tb) != [
                    "deadlineSeconds", "elapsedSeconds",
                    "shardsOutstanding", "stage"] \
                    or tb["deadlineSeconds"] != budget:
                raise AssertionError(f"{tag} with ?timeout={budget}: {st} "
                                     f"{body}")
            timeouts[tag] = (budget, ms, tb)
            log(f"[robust] {tag} (warm {pct_ms if 'Perc' in tag else gb_ms:.1f}"
                f" ms) with ?timeout={budget}: 504 after {ms:.1f} ms, "
                f"timeout block {json.dumps(tb)}")
        if timeouts["GroupBy Max"][2]["stage"] not in ("dispatch",
                                                       "readback"):
            raise AssertionError("the GroupBy Max 504 names no batcher stage")
        nclient.ask(gbq, gb_want, tag="GroupBy Max after its 504")
        # a Count burst: half the clients carry a 1 ms deadline
        mix = (Q32, Q4)
        want = {q: ro["after"][q] for q in mix}
        errors, doomed = [], {"timeout": 0, "exact": 0}
        lock = threading.Lock()
        start = threading.Barrier(CLIENTS + 1, timeout=600)

        def cclient(k: int) -> None:
            try:
                start.wait()
                for i in range(RB_DOOMED_REQS):
                    q = mix[(k + i) % 2]
                    if k % 2:
                        got = api.query("bench", q)["results"]
                        if got != want[q]:
                            raise AssertionError(f"{q[:30]}: {got}")
                        continue
                    try:
                        got = api.query("bench", q, timeout=0.001)
                    except ApiError as e:
                        if e.status != 504:
                            raise
                        with lock:
                            doomed["timeout"] += 1
                        continue
                    if got["results"] != want[q]:
                        raise AssertionError(f"doomed {q[:30]}: {got}")
                    with lock:
                        doomed["exact"] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(e)[:300])

        threads = [threading.Thread(target=cclient, args=(k,), daemon=True)
                   for k in range(CLIENTS)]
        for th in threads:
            th.start()
        start.wait()
        _, burst_ms = _timed(lambda: [th.join(600) for th in threads])
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"deadline burst: {errors[:3]}")
        if ex.slots_in_use or nofl.slots_in_use:
            raise AssertionError("slots still in use after the burst")
        client.ask(Q32, ro["after"][Q32], tag="Q32 after the deadline burst")
        log(f"[robust] Count burst, {CLIENTS // 2} clients with a 1 ms "
            f"deadline and {CLIENTS // 2} with none, {RB_DOOMED_REQS} "
            f"requests each: {burst_ms:.1f} ms; doomed requests "
            f"{doomed['timeout']} timed out (504), {doomed['exact']} answered "
            f"exactly; the others all exact; slots in use 0")
        t_c = time.perf_counter() - t2

        # (d) the watchdog on a real window: a bound below the GroupBy
        # Max window's device time trips in the readback stage
        t3 = time.perf_counter()
        b = nofl.batcher
        base_threads = threading.active_count()
        b.watchdog_s = RB_WATCHDOG_S
        time.sleep(1.2)  # the monitor's last long tick ends
        if cuda and len(shards) < FULL_SHARDS:
            # a cut index's window is shorter than a watchdog tick: the
            # stream sleeps ~0.2 s ahead of it
            log("CUT: a device sleep of ~0.2 s ahead of the GroupBy Max "
                f"window (fewer shards than {FULL_SHARDS})")
            torch.cuda._sleep(400_000_000)
        (st, _, raw), stall_ms = _timed(lambda: _http(
            base, "/index/bench/query", gbq.encode()))
        body = json.loads(raw)
        if st != 500 or "pipelineStall" not in body:
            raise AssertionError(f"watchdog trip: {st} {body}")
        t_trip = time.monotonic()
        _, _, raw = _http(base, "/status", method="GET")
        dh = json.loads(raw)["deviceHealth"]
        if dh["state"] != "degraded" or dh["watchdogTrips"] < 1:
            raise AssertionError(f"deviceHealth after the trip: {dh}")
        log(f"[robust] watchdog {RB_WATCHDOG_S} s: GroupBy Max answered 500 "
            f"after {stall_ms:.1f} ms, body pipelineStall "
            f"{json.dumps(body['pipelineStall'])}; deviceHealth "
            f"{json.dumps(dh)}")
        # degraded: each item alone through the hand kernels; the
        # governor (not the knob) keeps the fast lane off
        b.governor.probe_after_s = 60.0
        b.solo_fastlane = True
        hits = nofl.serving_stats()["fastLaneHits"]
        before = dict(cuda_kernels.LAUNCHES)
        deg = {}
        for pql, want_ in ((Q32, ro["after"][Q32]), (Q4, ro["after"][Q4]),
                           (TOPN_G, ro["after"][TOPN_G]), (gbq, gb_want),
                           (RQ_SUM, ro["bsi"][RQ_SUM])):
            _, deg[pql] = _timed(lambda: nclient.ask(pql, want_,
                                                     tag="degraded " + pql))
        launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items()}
        if nofl.serving_stats()["fastLaneHits"] != hits \
                or b.governor.state != "degraded":
            raise AssertionError("degraded serving took the fast lane or "
                                 "left degraded")
        if cuda and any(launched[k] < 1 for k in
                        ("count", "row_counts", "selected_row_counts")):
            raise AssertionError(f"degraded serving launched {launched}")
        log("[robust] degraded, one item at a time, fast lane off: "
            + ", ".join(f"{(MIX_NAMES.get(q) or q[:24])} {ms:.1f} ms"
                        for q, ms in deg.items())
            + f"; launches {json.dumps(launched)}")
        # the bound restored: one probe window returns it to healthy
        b.watchdog_s = 30.0
        b.governor.probe_after_s = 0.2
        time.sleep(0.25)
        t_probe = time.monotonic()
        nclient.ask(Q4, ro["after"][Q4], tag="probe")
        if b.governor.state != "healthy":
            raise AssertionError(f"the probe left {b.governor.state}")
        healthy_after = time.monotonic() - t_trip
        for _ in range(5):  # once the adaptive window is back at 0
            nclient.ask(Q4, ro["after"][Q4], tag="fast lane back")
        if nofl.serving_stats()["fastLaneHits"] <= hits:
            raise AssertionError("the fast lane did not come back")
        end = time.monotonic() + 20
        while threading.active_count() > base_threads \
                and time.monotonic() < end:
            time.sleep(0.1)
        if threading.active_count() > base_threads:
            raise AssertionError(f"{threading.active_count()} threads after "
                                 f"the trip, {base_threads} before")
        log(f"[robust] probe window: healthy {(time.monotonic() - t_probe) * 1e3:.1f}"
            f" ms after the probe began, {healthy_after:.3f} s after the trip"
            f" (degraded serving included); live threads back to "
            f"{threading.active_count()} ({base_threads} before)")
        t_d = time.perf_counter() - t3
    finally:
        server.close()
        nofl.close()

    # (e) a real device OOM, recovered by stage 1
    t4 = time.perf_counter()
    oe = _executor(holder, device=device, plane_budget=32 << 30,
                   translate=ex.translate)
    oe.planes.SYNC_BUILD_MAX = 1 << 40  # planes build on the request
    oc = _Client(API(holder, oe), cuda)
    oom = {}
    try:
        oc.ask(Q32, ro["after"][Q32], tag="oom Q32")
        oc.ask(RQ_SUM, ro["bsi"][RQ_SUM], tag="oom Sum")
        resident = oe.planes.stats()["bytes"]
        m_bytes = oe.planes.plane_bytes(index.field("m"), "standard",
                                        shards)
        ballast = None
        planes.wait_compactions(300)  # no fold allocates beside the ballast
        if cuda:
            free0 = torch.cuda.mem_get_info()[0]
            ballast = _ballast(m_bytes)
            size = sum(t.numel() for t in ballast)
            oom["before"] = (torch.cuda.memory_allocated(),
                             torch.cuda.memory_reserved(),
                             torch.cuda.mem_get_info()[0])
            log(f"[robust] OOM: f and amount resident in a fresh executor "
                f"({resident / 1e9:.2f} GB); ballast {size / 1e9:.2f} GB in "
                f"{len(ballast)} tensors ({free0 / 1e9:.2f} GB was free) "
                f"leaves {oom['before'][2] / 1e9:.3f} GB free on the card "
                f"for m's {m_bytes / 1e9:.2f} GB plane; allocated "
                f"{oom['before'][0] / 1e9:.2f} GB, reserved "
                f"{oom['before'][1] / 1e9:.2f} GB")
        _, oom_ms = _timed(lambda: oc.ask(MQ16, ro["m16"], tag="oom m16"))
        st = oe.serving_stats()
        last = st["lastDeviceOom"]
        if cuda and (st["deviceOomRetries"] != 1 or last is None
                     or "out of memory" not in last["error"].lower()):
            raise AssertionError(f"no device OOM recovered: {st}")
        _, m_ms = _timed(lambda: oc.ask(MQ16, ro["m16"], tag="m16 again"))
        if cuda:
            oom["after"] = (torch.cuda.memory_allocated(),
                            torch.cuda.memory_reserved())
            log(f"[robust] OOM: the 16-Count over m raised "
                f"{last['error'][:120]!r}; stage 1 evicted "
                f"{last.get('evictedBytes', 0) / 1e9:.2f} GB and answered "
                f"exactly in {oom_ms:.1f} ms (the next one {m_ms:.1f} ms); "
                f"deviceOomRetries {st['deviceOomRetries']}, exclusive "
                f"{st['deviceOomExclusiveRetries']}; allocated/reserved "
                f"before {oom['before'][0] / 1e9:.2f}/"
                f"{oom['before'][1] / 1e9:.2f} GB, at the OOM "
                f"{last['allocated'] / 1e9:.2f}/{last['reserved'] / 1e9:.2f}"
                f" GB, after {oom['after'][0] / 1e9:.2f}/"
                f"{oom['after'][1] / 1e9:.2f} GB")
        del ballast
    finally:
        oe.planes.evict_unpinned(reason="phase end")
        oe.close()
        if cuda:
            torch.cuda.empty_cache()
    t_e = time.perf_counter() - t4

    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"launches in phase 11: {json.dumps(launched)}; peak device memory "
        f"in the phase {peak / 1e9:.2f} GB; phase 11 walls (a) {t_a:.1f}s "
        f"(b) {t_b:.1f}s (c) {t_c:.1f}s (d) {t_d:.1f}s (e) {t_e:.1f}s, "
        f"total {time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("row_counts", "count", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 11 never launched {k}")
    return {"robust": launched}

# ---------------------------------------------------------------------------
# phase 12: the host storage path: background compaction, the builder pool
# and the .dense sidecars, pages over warm images, a crash restart with
# durable batched writes, and the close reckoned
# ---------------------------------------------------------------------------

ST_PAIRS = 2048                # single-pair imports into shard 0 of f
QC12 = "Count(Intersect(Row(f=1), Row(g=0)))"   # a tree: the count kernel
ST_PROFILE_FRAGS = 80          # fragments of each index opened under cProfile


def make_storage(f: np.ndarray, g: np.ndarray, shards: int, seed: int,
                 oracle: dict) -> dict:
    """Phase 12's oracle over ``f`` as phase 11 leaves it and ``m`` as
    phase 8 leaves it: (a)'s single pairs into shard 0 of f, (d)'s
    4096-pair batch into f and its 4096 mutex moves (phase 8's moved
    columns, each to another row), with the answers after each."""
    rng = np.random.default_rng(seed + 12)
    st = oracle["robust"]["state"]
    state = {k: v.copy() for k, v in st.items()}

    def answers() -> dict:
        c, fl = state["counts"], state["filtered"]
        return {Q32: [int(x) for x in c], Q4: [int(c[r]) for r in SELECTED],
                TOPN_G: [_pairs(fl, 5)], QC12: [int(fl[1])]}

    # bits still clear, so every import appends one op-log record
    cols = rng.choice(1 << 20, 4 * ST_PAIRS, replace=False)
    rows = rng.integers(0, ROWS, len(cols))
    clear = (f[0, rows, cols >> 5] >> (cols & 31).astype(np.uint32)) & 1 == 0
    cols, rows = cols[clear][:ST_PAIRS], rows[clear][:ST_PAIRS]
    hit_a = _apply_pairs(f, g[:, 0], state, rows, cols, clear=False)
    if not hit_a.all() or len(cols) < ST_PAIRS:
        raise AssertionError("phase 12's single pairs are not all new bits")
    after_a = answers()
    rows_d, cols_d = _distinct_pairs(rng, BATCH, shards)
    hit_d = _apply_pairs(f, g[:, 0], state, rows_d, cols_d, clear=False)
    mx = oracle["mutex"]
    mcols, mrows = mx["import"]
    new = (mrows + 1 + rng.integers(0, MX_ROWS - 1, len(mrows))) % MX_ROWS
    m_after = (np.asarray(mx["after_import"][MQ16], np.int64)
               - np.bincount(mrows, minlength=MX_ROWS)
               + np.bincount(new, minlength=MX_ROWS))
    return {"a": (rows, cols, hit_a), "after_a": after_a,
            "d": (rows_d, cols_d, int(hit_d.sum())), "after_d": answers(),
            "m": (mcols, new), "m_after": [int(x) for x in m_after],
            "sum": oracle["robust"]["bsi"][RQ_SUM],
            # f's words after (d): phase 14's oracle for a poisoned shard
            "f": f}


def _frags(field, view: str = "standard") -> list:
    v = field.view(view)
    return [] if v is None else list(v.fragments.values())


def _remove_sidecars(field, view: str = "standard") -> int:
    n = 0
    for frag in _frags(field, view):
        try:
            os.unlink(frag.dense_path)
            n += 1
        except FileNotFoundError:
            pass
    return n


def _pct(ts: list, q: float) -> float:
    return _pct_ms(ts, q) if ts else float("nan")


def _profile_opens(holder) -> str:
    """The top of a cProfile of opening a sample of the holder's
    fragments again, one by one (``ST_PROFILE_FRAGS`` spread over each
    index's views; the holder opens indexes on a thread pool, where this
    thread's profiler sees nothing)."""
    import cProfile
    import io
    import pstats

    from pilosa_tpu_torch.store.fragment import Fragment
    paths = []
    for idx in holder.indexes.values():
        mine = [(fr.path, fr.shard) for field in idx.fields.values()
                for v in field.views.values() for fr in v.fragments.values()]
        step = max(1, len(mine) // ST_PROFILE_FRAGS)
        paths += mine[::step][:ST_PROFILE_FRAGS]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for path, shard in paths:
        Fragment(path, shard).open()._drop_snapshot()
    prof.disable()
    dt = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
    lines = [ln.replace(REPO + os.sep, "") for ln in
             out.getvalue().splitlines()
             if ln.strip() and not ln.startswith(("   Ordered", "   List"))]
    return (f"{len(paths)} fragments in {dt:.2f}s under cProfile; by own "
            "time:\n  " + "\n  ".join(lines[-12:]))


def _best_s(fn, reps: int = 2) -> float:
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def codec_table(frags: dict) -> dict:
    """The native codec against the numpy one on this host, per fragment
    shape (``name -> Fragment``): serialize its positions, decode its
    snapshot blob, expand its rows into a zeroed slab; bytes and bits
    checked equal.  Returns seconds by shape and operation."""
    from pilosa_tpu_torch.store import native, roaring
    out = {}
    for name, frag in frags.items():
        pos = frag.positions()
        blob = native.serialize(pos)
        if blob != roaring._serialize_plain(pos):
            raise AssertionError(f"codec bytes differ on {name}")
        rows = np.unique(pos >> np.uint64(20))
        slots = np.arange(len(rows), dtype=np.uint64)
        a = np.zeros((len(rows), WORDS), np.uint32)
        b = np.zeros_like(a)
        native.expand_rows_into(blob, 1 << 20, rows, slots, a)
        d = roaring.Directory(memoryview(blob))
        for i, r in enumerate(rows.tolist()):
            d.row_words(r, b[i])
        if not np.array_equal(a, b) or not np.array_equal(
                native.deserialize(blob), roaring._deserialize_plain(blob)):
            raise AssertionError(f"codec decode differs on {name}")
        t = {
            "serialize": (_best_s(lambda: native.serialize(pos)),
                          _best_s(lambda: roaring._serialize_plain(pos))),
            "deserialize": (_best_s(lambda: native.deserialize(blob)),
                            _best_s(lambda: roaring._deserialize_plain(
                                blob))),
            "expand": (_best_s(lambda: native.expand_rows_into(
                blob, 1 << 20, rows, slots, np.zeros_like(a))),
                _best_s(lambda: [d.row_words(r, b[i]) for i, r in
                                 enumerate(rows.tolist())])),
        }
        out[name] = t
        log(f"[storage] (f) host codec, {name} ({len(rows)} rows, "
            f"{len(pos)} bits, {len(blob) / 1e6:.2f} MB): native / numpy "
            + ", ".join(f"{k} {v[0] * 1e3:.2f} / {v[1] * 1e3:.2f} ms "
                        f"({v[1] / max(v[0], 1e-9):.1f}x)"
                        for k, v in t.items()))
    return out


def storage_phase(client, holder, planes, so: dict, cuda: bool, device,
                  data_dir: str) -> dict:
    """Phase 12: (a) background compaction under single-pair imports; (b)
    the builder pool: f's and amount's planes cold (images removed) and
    warm, bit-equal on the card; (c) pages and a streamed TopN over warm
    images; (d) a profile of fragment opens, a fresh executor's warm
    build, and durable imports into f and m (their op-logs fsync) with
    their fsyncs and records; (e) single compactions of an f and an
    amount fragment and the reckoned close; (f) the host codec table.  The launch counters are
    reset when the phase starts and read when it ends."""
    import torch
    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.store.fragment import MAX_OP_N

    t0 = time.perf_counter()
    if cuda:
        log(f"phase 12 on {card_line()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launches()
    api = client.api
    ex = api.executor
    index = holder.index("bench")
    shards = tuple(index.available_shards())
    f_field, amount = index.field("f"), index.field("amount")
    queue = holder.snapshot_queue
    after_a = so["after_a"]

    # (a) background compaction: single-pair imports past MAX_OP_N
    frag0 = f_field.standard_view().fragment(0)
    log_before, op_before, done0 = (frag0._oplog.size(), frag0.op_n,
                                    queue.compactions)
    rows, cols, hit = so["a"]
    spans, log_peak = [], log_before
    for r, c, h in zip(rows.tolist(), cols.tolist(), hit.tolist()):
        body = json.dumps({"rowIDs": [r], "columnIDs": [c]}).encode()
        t = time.perf_counter()
        got = client.post("/index/bench/field/f/import", body,
                          "storage single pair")
        spans.append((t, time.perf_counter()))
        if got != {"changed": int(h)}:
            raise AssertionError(f"single-pair import ({r}, {c}): {got}")
        log_peak = max(log_peak, frag0._oplog.size())
    if not queue.wait_idle(600):
        raise AssertionError("the background compaction never finished")
    if queue.compactions <= done0 or queue.last_compaction_span is None:
        raise AssertionError(f"no background compaction: op_n "
                             f"{frag0.op_n}, max {MAX_OP_N}")
    c_start, c_end = queue.last_compaction_span
    before = [e - s for s, e in spans if e <= c_start]
    during = [e - s for s, e in spans if s < c_end and e > c_start]
    after = [e - s for s, e in spans if s >= c_end]
    client.ask(Q32, after_a[Q32], tag="storage 32-Count after compaction")
    log(f"[storage] (a) {ST_PAIRS} single-pair REST imports into shard 0 "
        f"of f (op_n {op_before} before, MAX_OP_N {MAX_OP_N}): background "
        f"compaction {queue.last_compaction_seconds:.3f} s; import latency "
        f"p50/p99 before it {_pct(before, 0.5):.2f}/{_pct(before, 0.99):.2f}"
        f" ms over {len(before)}, while it runs {_pct(during, 0.5):.2f}/"
        f"{_pct(during, 0.99):.2f} ms over {len(during)}, after "
        f"{_pct(after, 0.5):.2f}/{_pct(after, 0.99):.2f} ms over "
        f"{len(after)}; op-log {log_before} B before, {log_peak} B at its "
        f"peak, {frag0._oplog.size()} B after (op_n {frag0.op_n}); the "
        f"32-Count after it exact")
    t_a = time.perf_counter() - t0

    # (b) the builder pool, cold then warm, on a fresh executor
    t1 = time.perf_counter()
    planes.evict_unpinned(reason="phase 12")
    if cuda:
        torch.cuda.empty_cache()
    be = Executor(holder, device=device, plane_budget=32 << 30,
                  translate=ex.translate)
    bp = be.planes
    bc = _Client(API(holder, be), cuda)
    fkey = ("plane", "bench", "f", "standard", shards)
    f_plane = len(shards) * ROWS * WORDS * 4
    if f_plane <= bp.SYNC_BUILD_MAX:
        bp.SYNC_BUILD_MAX = f_plane // 2
        log(f"CUT: SYNC_BUILD_MAX {f_plane // 2} bytes, below f's plane "
            "(builds past it write images)")

    def build(name, ask, plane_of, removed):
        w0 = (bp.warm_hits, bp.warm_misses, bp.sidecar_bytes_written,
              bp.sidecar_write_seconds, bp.builds)
        t = time.perf_counter()
        ask()
        bp.wait_builds()
        wall = time.perf_counter() - t
        st = bp.stats()
        got = {"build_s": st["lastBuildSeconds"], "wall_s": wall,
               "hits": bp.warm_hits - w0[0],
               "misses": bp.warm_misses - w0[1],
               "written": bp.sidecar_bytes_written - w0[2],
               "writer_s": bp.sidecar_write_seconds - w0[3],
               "builds": bp.builds - w0[4], "plane": plane_of()}
        log(f"[storage] (b) {name}: build {got['build_s']:.2f} s (request "
            f"to built {wall:.2f} s, {st['lastBuildBytes'] / 1e9:.2f} GB), "
            f"warm hits {got['hits']}, misses {got['misses']}, sidecars "
            f"written {got['written'] / 1e9:.2f} GB by the writer thread in "
            f"{got['writer_s']:.2f} s" + (f" ({removed} images removed "
                                          "first)" if removed else ""))
        if got["builds"] != 1 or got["hits"] + got["misses"] != len(shards):
            raise AssertionError(f"{name}: {got['builds']} builds, "
                                 f"{got['hits']} + {got['misses']} "
                                 f"fragments, want 1 and {len(shards)}")
        return got

    removed = _remove_sidecars(f_field)
    cold = build("f cold", lambda: bc.ask(Q32, after_a[Q32],
                                          tag="storage f cold"),
                 lambda: bp._entries[fkey][1].plane, removed)
    bc.ask(Q32, after_a[Q32], reps=3, tag="storage 32-Count, cold plane")
    bp.evict_unpinned(reason="warm rebuild")
    warm = build("f warm", lambda: bc.ask(Q32, after_a[Q32],
                                          tag="storage f warm"),
                 lambda: bp._entries[fkey][1].plane, 0)
    bc.ask(Q32, after_a[Q32], reps=3, tag="storage 32-Count, warm plane")
    f_equal = bool(torch.equal(cold["plane"], warm["plane"]))
    if warm["hits"] != len(shards) or not f_equal:
        raise AssertionError(f"f's warm build: {warm['hits']} hits, "
                             f"bit-equal {f_equal}")
    cold["plane"] = warm["plane"] = None
    bp.evict_unpinned(reason="phase 12")
    removed = _remove_sidecars(amount, amount.bsi_view_name)
    a_plane = lambda: bp.bsi_plane("bench", amount, shards).plane  # noqa
    acold = build("amount cold", lambda: bc.ask(RQ_SUM, so["sum"],
                                                tag="storage Sum cold"),
                  a_plane, removed)
    bp.evict_unpinned(reason="warm rebuild")
    awarm = build("amount warm", lambda: bc.ask(RQ_SUM, so["sum"],
                                                tag="storage Sum warm"),
                  a_plane, 0)
    a_equal = bool(torch.equal(acold["plane"], awarm["plane"]))
    if awarm["hits"] != len(shards) or not a_equal:
        raise AssertionError(f"amount's warm build: {awarm['hits']} hits, "
                             f"bit-equal {a_equal}")
    acold["plane"] = awarm["plane"] = None
    log(f"[storage] (b) warm planes bit-equal to the cold ones on the card "
        f"(torch.equal): f {f_equal}, amount {a_equal}")
    bp.evict_unpinned(reason="phase end")
    be.close()
    if cuda:
        torch.cuda.empty_cache()
    t_b = time.perf_counter() - t1

    # (c) pages and a streamed TopN over warm images (phase 10 (b)'s)
    t2 = time.perf_counter()
    small_budget = SMALL_BUDGET if f_plane > SMALL_BUDGET else f_plane // 2
    pe = Executor(holder, device=device, plane_budget=small_budget,
                  translate=ex.translate)
    pc = _Client(API(holder, pe), cuda)
    h0 = (pe.planes.warm_hits, pe.planes.warm_misses)
    for q in (Q32, Q4, TOPN_G):
        pc.ask(q, after_a[q], tag=f"pages {q[:30]}")
    ten = pe.tenancy_status()
    prev = RECORD.get("budget_f", {})
    names = {Q32: "32-Count", Q4: "4-Count", TOPN_G: "filtered TopN"}
    log(f"[storage] (c) f past a {small_budget / 2**30:.2f} GiB budget over "
        f"warm images: {ten['pageIns']} page-ins in "
        f"{ten['pageInSeconds']:.2f} s (phase 10: "
        f"{prev.get('pageIns')} in {prev.get('pageInSeconds', 0):.2f} s), "
        f"warm hits {pe.planes.warm_hits - h0[0]}, misses "
        f"{pe.planes.warm_misses - h0[1]}, TopNs "
        f"{json.dumps(pe.serving_stats()['topnServed'])}; "
        + ", ".join(f"{n} {pc.lat[f'pages {q[:30]}'][0] * 1e3:.1f} ms "
                    f"(phase 10 {prev.get('lat', {}).get(q, 0) * 1e3:.1f} ms)"
                    for q, n in names.items()))
    if (ten["pageIns"] < 2 or pe.planes.builds
            or pe.serving_stats()["topnServed"]["streamed"] != 1
            or pe.planes.warm_hits - h0[0] < len(shards)):
        raise AssertionError(f"f was not paged and streamed from warm "
                             f"images: {ten}")
    pe.planes.evict_unpinned(reason="phase end")
    pe.close()
    if cuda:
        torch.cuda.empty_cache()
    t_c = time.perf_counter() - t2

    # (d) durable imports over a fresh executor: its first build of f
    # reads the images (b) wrote, then f's and m's op-logs fsync as
    # Holder(fsync=True) makes them.  The crash restart itself (reopening
    # the unclosed directory) runs in tests/test_torch_gpu.py at 32
    # shards: a second opened tree of this size does not fit beside the
    # first in the card machine's 96 GiB
    t3 = time.perf_counter()
    planes.evict_unpinned(reason="phase 12")
    log(f"[storage] (d) open profile: {_profile_opens(holder)}")
    h2 = holder
    for name in ("f", "m"):
        for frag in _frags(index.field(name)):
            frag._oplog.fsync = True
    ex2 = Executor(h2, device=device, plane_budget=32 << 30)
    ex2.planes.SYNC_BUILD_MAX = bp.SYNC_BUILD_MAX
    api2 = API(h2, ex2)
    server2 = Server(api2, "127.0.0.1", 0).start()
    c2 = _Client(api2, cuda)
    c2.base = "http://%s:%d" % server2.address
    try:
        f2, m2 = h2.index("bench").field("f"), h2.index("bench").field("m")
        c2.ask(Q32, after_a[Q32], tag="restart 32-Count, first")
        ex2.planes.wait_builds()
        st = ex2.planes.stats()
        c2.ask(Q32, after_a[Q32], reps=3, tag="restart 32-Count")
        c2.ask(QC12, after_a[QC12], tag="restart compound Count")
        log(f"[storage] (d) a fresh executor's first 32-Count "
            f"{c2.lat['restart 32-Count, first'][0] * 1e3:.1f} ms; f's "
            f"plane built in {st['lastBuildSeconds']:.2f} s, warm hits "
            f"{st['warmHits']}, misses {st['warmMisses']}")
        if st["warmHits"] != len(shards) or st["builds"] != 1:
            raise AssertionError(f"f was not built warm: {st}")

        def durable(field, path, body, want_changed, what):
            ops0 = {id(fr): fr.op_n for fr in _frags(field)}
            t = time.perf_counter()
            got = c2.post(path, body, what)
            ms = (time.perf_counter() - t) * 1e3
            if got != {"changed": want_changed}:
                raise AssertionError(f"{what}: {got}, want {want_changed}")
            grown = [fr.op_n - ops0.get(id(fr), 0) for fr in _frags(field)
                     if fr.op_n != ops0.get(id(fr), 0)]
            fsyncs = api2.last_import_fsyncs
            records = sum(grown)
            log(f"[storage] (d) {what}: {ms:.1f} ms, {fsyncs} fsyncs by "
                f"SyncBatch.flush for {records} op-log records in "
                f"{len(grown)} logs ({records / max(1, fsyncs):.2f} records "
                "per fsync)")
            if fsyncs != len(grown) or min(grown, default=1) < 1:
                raise AssertionError(f"{what}: {fsyncs} fsyncs for "
                                     f"{len(grown)} touched logs")
            return ms, fsyncs, records

        rows_d, cols_d, changed_d = so["d"]
        imp_f = durable(f2, "/index/bench/field/f/import",
                        json.dumps({"rowIDs": rows_d.tolist(),
                                    "columnIDs": cols_d.tolist()}).encode(),
                        changed_d, "durable /import of 4096 pairs into f")
        for q in (Q32, Q4, TOPN_G, QC12):
            c2.ask(q, so["after_d"][q], tag=f"restart {q[:30]} after")
        mcols, mrows = so["m"]
        imp_m = durable(m2, "/index/bench/field/m/import",
                        json.dumps({"rowIDs": mrows.tolist(),
                                    "columnIDs": mcols.tolist()}).encode(),
                        2 * len(mcols),
                        f"durable mutex /import of {len(mcols)} moves into m")
        if imp_m[2] <= imp_m[1]:
            raise AssertionError("the mutex import took an fsync per record")
        c2.ask(MQ16, so["m_after"], tag="restart 16-Count after")
        c2.ask(RQ_SUM, so["sum"], tag="restart Sum")
        t_d = time.perf_counter() - t3

        # (e) the close, reckoned: one inline compaction each of an f and
        # an amount fragment, times the dirty fragments on disk
        t4 = time.perf_counter()
        dirty: dict = {}
        for iname, idx in h2.indexes.items():
            for fname, fld in idx.fields.items():
                n = sum(1 for v in fld.views.values()
                        for fr in v.fragments.values()
                        if fr._oplog.size() > 0)
                if n:
                    dirty[(iname, fname, fld.options.type)] = n
        per = {}
        for fld, view in ((f2, "standard"),
                          (h2.index("bench").field("amount"),
                           h2.index("bench").field("amount").bsi_view_name)):
            frag = next(fr for fr in _frags(fld, view)
                        if fr._oplog.size() > 0)
            t = time.perf_counter()
            frag.snapshot()
            per[fld.name] = time.perf_counter() - t
        reckoned = sum(n * per["amount" if kind == "int" else "f"]
                       for (_, _, kind), n in dirty.items())
        log(f"[storage] (e) an inline compaction: f fragment "
            f"{per['f']:.3f} s, amount fragment {per['amount']:.3f} s; "
            f"dirty fragments on disk "
            + ", ".join(f"{i}/{fn} {n}" for (i, fn, _), n in dirty.items())
            + f" ({sum(dirty.values())}); the close reckoned at "
            f"{reckoned:.0f} s, not run")
        c2.ask(Q32, so["after_d"][Q32], tag="restart 32-Count after (e)")
        t_e = time.perf_counter() - t4
        ev = h2.index("events").field("ev") if h2.index("events") else None
        shapes = {"f": f2.standard_view().fragment(1)}
        if ev is not None:
            day = sorted(n for n in ev.views if len(n) == len(
                "standard_20210201"))[0]
            shapes["events day view"] = ev.view(day).fragment(1)
        codec_table({k: v for k, v in shapes.items() if v is not None})
    finally:
        server2.close()
        ex2.close()
    sidecars = [(d, n) for d, _, files in os.walk(data_dir) for n in files
                if n.endswith(".dense")]
    side_bytes = sum(os.path.getsize(os.path.join(d, n)) for d, n in sidecars)
    du = shutil.disk_usage(data_dir)
    log(f"[storage] sidecars on disk at the end: {len(sidecars)} images, "
        f"{side_bytes / 1e9:.2f} GB; disk free {du.free / 1e9:.1f} GB")
    launched = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"launches in phase 12: {json.dumps(launched)}; peak device memory "
        f"in the phase {peak / 1e9:.2f} GB; phase 12 walls (a) {t_a:.1f}s "
        f"(b) {t_b:.1f}s (c) {t_c:.1f}s (d) {t_d:.1f}s (e) {t_e:.1f}s, "
        f"total {time.perf_counter() - t0:.1f}s")
    if cuda:
        for k in ("row_counts", "count", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 12 never launched {k}")
    return {"storage": launched}



# ---------------------------------------------------------------------------
# phase 13: the single-node API, the HTTP client and the CLI

CLI_PAIRS = 1_000_000          # (b)'s CSV: pairs over CLI_ROWS x CLI_SHARDS
CLI_ROWS, CLI_SHARDS = 16, 64
K_RECREATE = 100_000           # keyed pairs imported into the recreated k
SEG_RECREATE = "seg-05"


def _opts_json(o) -> dict:
    """A field's options as the schema routes answer them."""
    return {"type": o.type, "keys": o.keys, "cacheType": o.cache_type,
            "cacheSize": o.cache_size, "timeQuantum": o.time_quantum,
            "min": o.min, "max": o.max, "base": o.base,
            "bitDepth": o.bit_depth, "scale": o.scale, "epoch": o.epoch,
            "timeUnit": o.time_unit}


def _mem_total() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


def _cli_csv_oracle(rows: np.ndarray, cols: np.ndarray) -> tuple:
    """(the export's bytes, per-row counts, the row 1 x row 2
    intersection) of (row, col) pairs: the export writes shard by shard,
    rows ascending, columns ascending, each pair once."""
    pos = np.unique(rows.astype(np.uint64) * np.uint64(1 << 32)
                    + cols.astype(np.uint64))
    r = (pos >> np.uint64(32)).astype(np.int64)
    c = (pos & np.uint64(0xFFFFFFFF)).astype(np.int64)
    order = np.lexsort((c, r, c >> 20))
    r, c = r[order], c[order]
    text = "".join(f"{a},{b}\n" for a, b in zip(r.tolist(), c.tolist()))
    counts = np.bincount(r, minlength=CLI_ROWS)
    inter = len(np.intersect1d(c[r == 1], c[r == 2]))
    return text.encode(), counts, inter


def _run_cli(argv: list) -> tuple[int, str]:
    """``python -m pilosa_tpu_torch.cli`` in this process: (exit code,
    what it printed)."""
    import contextlib
    import io

    from pilosa_tpu_torch.cli.main import main as cli_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def api_phase(client, executor, so: dict, cuda: bool, device,
              data_dir: str, seed: int, k_cols: int = K_COLS,
              k_rows: int = K_ROWS, k_values: int = K_VALUES,
              cli_pairs: int = CLI_PAIRS) -> dict:
    """Phase 13: (a) the serving process's REST server through the port's
    ``api.client.Client``: ``/info``, ``/version``, the schema routes,
    ``/export`` of ``k``'s keyed set and BSI fields against phase 9's
    oracle, ``DELETE /index/k`` (the planes' and the card's bytes freed,
    the directory and key stores gone, the reference's 404, ``k``
    recreated with ids from 1), ``DELETE /index/bench/field/seg`` (every
    plane of ``bench`` dropped, ``f`` rebuilt exact, ``seg`` recreated
    empty).  (b) A second process, ``python -m pilosa_tpu_torch.cli
    server --config <toml>`` on the card, loaded by ``cli import`` with
    ``cli_pairs`` pairs from the seed, read through the client against a
    numpy oracle, exported by ``cli export`` byte for byte, stopped by
    SIGTERM (exit 0 within 30 s), then ``cli check`` and ``cli config``.
    Launch counters are reset at the start and read at the end (the
    second process's launches are not counted; its answers are
    checked).  gRPC and TLS are not driven: the card machine has no
    grpcio, and nothing there may be relied on to make certificates."""
    import gc
    import signal
    import socket
    import tempfile
    import weakref

    import torch

    import pilosa_tpu_torch
    from pilosa_tpu_torch.api.client import Client, ClientError
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.store import FieldOptions

    if cuda:
        log(f"phase 13 on {card_line()}")
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    planes = executor.planes
    host, port = client.base.rsplit("//", 1)[1].rsplit(":", 1)
    c = Client(host, int(port), timeout=600)
    nums: dict = {}

    # (a) the schema routes, /info and /version
    schema = {i["name"]: i for i in c.schema()}
    info = c.info()
    if info != {"shardWidth": 1 << 20, "cpuPhysicalCores": os.cpu_count(),
                "memory": _mem_total()}:
        raise AssertionError(f"/info: {info}")
    if c.version() != pilosa_tpu_torch.__version__:
        raise AssertionError("/version")
    bench = c._json("GET", "/index/bench")
    kidx = c._json("GET", "/index/k")
    fjson = c._json("GET", "/index/bench/field/f")
    want_f = _opts_json(FieldOptions())
    want_k = {"f": _opts_json(FieldOptions(keys=True)),
              "spend": _opts_json(FieldOptions(type="int", min=0,
                                               max=1000))}
    if (bench != schema["bench"] or kidx != schema["k"]
            or bench["options"] != {"keys": False, "trackExistence": False}
            or kidx["options"] != {"keys": True, "trackExistence": True}
            or fjson["name"] != "f" or fjson["options"] != want_f
            or {f["name"]: f["options"] for f in kidx["fields"]} != want_k
            or fjson not in bench["fields"]):
        raise AssertionError(f"schema routes: {bench}, {kidx}, {fjson}")
    log(f"[api] /info {info}; /version {pilosa_tpu_torch.__version__}; "
        f"/index/bench ({len(bench['fields'])} fields), /index/k and "
        "/index/bench/field/f equal their /schema entries")

    # /export of k: phase 9's pairs and values, keys as the stores hold
    # them (ids in the order the keys were created)
    ex_cols = executor.translate.columns("k")
    ex_rows = executor.translate.rows("k", "f")
    if (ex_cols.translate([f"user-{0:09d}", f"user-{k_cols - 1:09d}",
                           "user-new"]) != [1, k_cols, k_cols + 1]
            or ex_rows.translate([f"seg-{0:05d}", f"seg-{k_rows - 1:05d}",
                                  "seg-new"]) != [1, k_rows, k_rows + 1]):
        raise AssertionError("k's key ids are not phase 9's")
    t = time.perf_counter()
    got = c.export_csv("k", "f")
    nums["export_f_s"] = time.perf_counter() - t
    cid = np.arange(1, k_cols + 2, dtype=np.int64)
    rid = np.append(np.arange(k_cols) % k_rows + 1, k_rows + 1)
    order = np.lexsort((cid, rid, cid >> 20))
    rkey = [f"seg-{r:05d}" for r in range(k_rows)] + ["seg-new"]
    want = "".join(
        f"{rkey[r - 1]},"
        f"{'user-new' if cc > k_cols else f'user-{cc - 1:09d}'}\n"
        for r, cc in zip(rid[order].tolist(), cid[order].tolist()))
    if got != want:
        raise AssertionError(f"/export k f: {len(got)} bytes, want "
                             f"{len(want)}")
    nums["export_f_bytes"] = len(got.encode())
    t = time.perf_counter()
    got = c.export_csv("k", "spend")
    nums["export_spend_s"] = time.perf_counter() - t
    want = "".join(f"user-{i:09d},{i % 1001}\n" for i in range(k_values))
    if got != want:
        raise AssertionError("/export k spend")
    nums["export_spend_bytes"] = len(got.encode())
    log(f"[api] /export k/f: {k_cols + 1} lines, "
        f"{nums['export_f_bytes']} bytes in {nums['export_f_s']:.2f} s; "
        f"k/spend: {k_values} lines, {nums['export_spend_bytes']} bytes in "
        f"{nums['export_spend_s']:.2f} s; both equal the oracle")

    # bench's planes, then k's, resident (phase 12 evicted the cache)
    after = so["after_d"]
    for q in (Q32, Q4, QC12, TOPN_G):
        client.ask(q, after[q], tag=f"phase 13 {q[:20]}")
    planes.wait_builds()
    per_row = k_cols // k_rows
    ktop = [[{"key": f"seg-{i:05d}", "count": per_row} for i in range(5)]]
    for _ in range(2):  # k's plane builds in the background, then serves
        if (c.query("k", KC_COUNT) != [per_row]
                or c.query("k", KC_TOPN) != ktop):
            raise AssertionError("k's keyed Count or TopN before the "
                                 "delete")
        planes.wait_builds()
    kplane = next(v[1].plane for key, v in planes._entries.items()
                  if key[0] == "plane" and key[1] == "k")
    kref = weakref.ref(kplane)
    kshape = list(kplane.shape)
    del kplane
    for q in (Q32, Q4):  # the batcher's threads move past k's window
        client.ask(q, after[q], tag=f"phase 13 {q[:20]}")

    # DELETE /index/k
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    kbytes = planes.tenant_bytes("k")
    st0 = c.status()["planes"]["bytes"]
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    t = time.perf_counter()
    c.delete_index("k")
    nums["delete_k_s"] = time.perf_counter() - t
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    st1 = c.status()["planes"]["bytes"]
    mem1 = torch.cuda.memory_allocated() if cuda else 0
    nums["delete_k_freed"] = mem0 - mem1
    if (st0 - st1 != kbytes or kbytes < 4 * np.prod(kshape)
            or kref() is not None or (cuda and mem0 - mem1 < kbytes)):
        raise AssertionError(
            f"DELETE k: /status planes {st0} -> {st1}, k resident {kbytes}, "
            f"device {mem0} -> {mem1}, plane alive {kref() is not None}")
    if (os.path.exists(os.path.join(data_dir, "k"))
            or [key for key in executor.translate._logs if key[0] == "k"]
            or [key for key in planes._entries if key[1] == "k"]):
        raise AssertionError("DELETE k left its directory, key stores or "
                             "planes")
    try:
        c.query("k", KC_COUNT)
        raise AssertionError("a query on the deleted k answered")
    except ClientError as e:
        if (e.status, str(e)) != (404, "index 'k' not found"):
            raise
    log(f"[api] DELETE /index/k in {nums['delete_k_s']:.3f} s: /status "
        f"planes {st0} -> {st1} bytes (k's int32{kshape} plane and the "
        f"rest of k: {kbytes} bytes); device memory allocated {mem0} -> "
        f"{mem1} ({(mem0 - mem1) / 1e9:.3f} GB freed); directory and key "
        "stores gone; a query answers 404")

    # k recreated: keys from id 1, a keyed Count exact
    c.create_index("k", {"keys": True})
    c.create_field("k", "f", {"keys": True})
    n_rows = 100
    t = time.perf_counter()
    changed = c.import_bits("k", "f", rowKeys=[
        f"seg-{i % n_rows:03d}" for i in range(K_RECREATE)],
        columnKeys=[f"user-{i:09d}" for i in range(K_RECREATE)])
    nums["recreate_import_s"] = time.perf_counter() - t
    if (changed != K_RECREATE
            or ex_cols is executor.translate.columns("k")
            or executor.translate.columns("k").translate(
                [f"user-{0:09d}"]) != [1]
            or executor.translate.rows("k", "f").translate(["seg-000"])
            != [1]):
        raise AssertionError("k recreated: changed or ids")
    for _ in range(2):
        if c.query("k", 'Count(Row(f="seg-007"))') != [K_RECREATE // n_rows]:
            raise AssertionError("k recreated: keyed Count")
        planes.wait_builds()
    log(f"[api] k recreated: {K_RECREATE} keyed pairs in "
        f"{nums['recreate_import_s']:.2f} s, ids from 1, keyed Count exact")

    # DELETE /index/bench/field/seg: every plane of bench leaves the cache
    before = planes.tenant_bytes("bench")
    t = time.perf_counter()
    c.delete_field("bench", "seg")
    nums["delete_seg_s"] = time.perf_counter() - t
    if (planes.tenant_bytes("bench") != 0 or before == 0
            or os.path.exists(os.path.join(data_dir, "bench", "seg"))):
        raise AssertionError(f"DELETE seg: bench planes {before} -> "
                             f"{planes.tenant_bytes('bench')}")
    builds = planes.builds
    t = time.perf_counter()
    client.ask(Q32, after[Q32], tag="phase 13 32-Count after the delete")
    planes.wait_builds()
    nums["rebuild_s"] = time.perf_counter() - t
    if planes.builds != builds + 1:
        raise AssertionError("f was not rebuilt once")
    nums["rebuild_build_s"] = planes.stats()["lastBuildSeconds"]
    for q in (Q32, Q4, QC12, TOPN_G):
        client.ask(q, after[q], tag=f"phase 13 {q[:20]} rebuilt")
    c.create_field("bench", "seg", {"keys": True})
    if c.query("bench", f'Count(Row(seg="{SEG_RECREATE}"))') != [0]:
        raise AssertionError("seg recreated is not empty")
    log(f"[api] DELETE /index/bench/field/seg in {nums['delete_seg_s']:.3f}"
        f" s: bench's {before} resident bytes dropped; the next 32-Count "
        f"rebuilt f in {nums['rebuild_build_s']:.2f} s "
        f"({nums['rebuild_s']:.2f} s to the plane), every answer exact; seg "
        "recreated empty")
    t_a = time.perf_counter() - t0

    # (b) the CLI: a server process from a TOML, import, reads, export,
    # SIGTERM, check, config
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    proc = None
    try:
        cdir = os.path.join(tmp, "data")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            cport = sk.getsockname()[1]
        toml = os.path.join(tmp, "server.toml")
        with open(toml, "w") as f:
            f.write(f'bind = "127.0.0.1:{cport}"\ndata-dir = "{cdir}"\n'
                    f"plane-budget-bytes = {1 << 30}\nfsync = true\n"
                    + (f'device = "{device}"\n' if device else ""))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PILOSA_")}
        t_boot = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "--config", toml], cwd=REPO, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        lines: list = []
        up = threading.Event()

        def drain():
            for line in proc.stderr:
                lines.append(line.rstrip())
                if "listening on" in line:
                    up.set()

        drainer = threading.Thread(target=drain, daemon=True)
        drainer.start()
        if not up.wait(300):
            raise AssertionError("the CLI server did not start: "
                                 + " | ".join(lines[-5:]))
        listening = next(ln for ln in lines if "listening on" in ln)
        log(f"[cli] server log: {listening.split(': ', 1)[-1]}")
        if cuda and "device=cuda" not in listening:
            raise AssertionError("the CLI server is not on the card")
        cc = Client("127.0.0.1", cport, timeout=600)
        cc.version()
        nums["boot_s"] = time.perf_counter() - t_boot

        rng = np.random.default_rng(seed + 13)
        rows = rng.integers(0, CLI_ROWS, cli_pairs)
        cols = rng.integers(0, CLI_SHARDS << 20, cli_pairs)
        csv = os.path.join(tmp, "pairs.csv")
        with open(csv, "w") as f:
            f.write("".join(f"{r},{cc_}\n" for r, cc_ in
                            zip(rows.tolist(), cols.tolist())))
        want_csv, counts, inter = _cli_csv_oracle(rows, cols)
        t = time.perf_counter()
        imp = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "import",
             "--bind", f"127.0.0.1:{cport}", "--create", "-i", "cli", "-f",
             "f", csv], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        nums["import_s"] = time.perf_counter() - t
        if imp.returncode != 0:
            raise AssertionError(f"cli import: {imp.stderr[-2000:]}")
        log(f"[cli] cli import: {cli_pairs} pairs ({len(want_csv)} CSV "
            f"bytes of unique pairs) in {nums['import_s']:.2f} s = "
            f"{cli_pairs / nums['import_s']:.0f} pairs/s (process start "
            f"included); {imp.stderr.strip().splitlines()[-1]}")
        q16 = "".join(f"Count(Row(f={r}))" for r in range(CLI_ROWS))
        for q, w in ((q16, [int(x) for x in counts]),
                     ("TopN(f, n=5)", [_topn(counts, 5)]),
                     ("Count(Intersect(Row(f=1), Row(f=2)))", [inter])):
            for _ in range(2):
                got = cc.query("cli", q)
                if got != w:
                    raise AssertionError(f"cli {q[:40]}: {got}, want {w}")
        out = os.path.join(tmp, "export.csv")
        t = time.perf_counter()
        rc, _ = _run_cli(["export", "--bind", f"127.0.0.1:{cport}", "-i",
                          "cli", "-f", "f", "-o", out])
        nums["cli_export_s"] = time.perf_counter() - t
        with open(out, "rb") as f:
            exported = f.read()
        if rc != 0 or exported != want_csv:
            raise AssertionError(f"cli export: rc {rc}, {len(exported)} "
                                 f"bytes, want {len(want_csv)}")
        log(f"[cli] the 16-Count, TopN(f, n=5) and a compound Count exact; "
            f"cli export {len(exported)} bytes in {nums['cli_export_s']:.2f}"
            " s, equal to the oracle's CSV")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(30)
        nums["close_s"] = time.perf_counter() - t
        drainer.join(10)
        if rc != 0:
            raise AssertionError(f"the CLI server exited {rc}: "
                                 + " | ".join(lines[-5:]))
        rc, text = _run_cli(["check", "--data-dir", cdir])
        oks = sum(ln.startswith("ok ") for ln in text.splitlines())
        if rc != 0 or not text.endswith("all fragments ok\n") \
                or oks != 2 * CLI_SHARDS:
            raise AssertionError(f"cli check: rc {rc}, {text[-300:]}")
        saved = os.environ.pop("PILOSA_DEVICE", None)
        try:
            rc, text = _run_cli(["config", "--config", toml])
        finally:
            if saved is not None:
                os.environ["PILOSA_DEVICE"] = saved
        eff = json.loads(text)
        if (rc != 0 or eff["bind"] != f"127.0.0.1:{cport}" or not eff["fsync"]
                or eff["device"] != (device or "")):
            raise AssertionError(f"cli config: {text[:300]}")
        log(f"[cli] SIGTERM: exit 0 in {nums['close_s']:.2f} s; cli check: "
            f"{oks} fragments ok; cli config: "
            + json.dumps({k: eff[k] for k in (
                "bind", "data_dir", "device", "fsync", "plane_budget_bytes",
                "count_batch_window", "mesh")}))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    t_b = time.perf_counter() - t1
    launched = dict(cuda_kernels.LAUNCHES)
    log(f"launches in phase 13: {json.dumps(launched)}; phase 13 walls (a) "
        f"{t_a:.1f}s (b) {t_b:.1f}s (boot to first answer "
        f"{nums['boot_s']:.2f} s), total {time.perf_counter() - t0:.1f}s")
    log(f"phase 13 numbers: {json.dumps(nums)}")
    if cuda:
        for k in ("row_counts", "count", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 13 never launched {k}")
    return {"api": launched}


OB_PEAK_GBPS = 3350.0          # H100 SXM HBM3 peak (HBM_BYTES_PER_S)
OB_SCRUB_RATE = 1 << 30        # (e)'s scrubber budget, bytes per second
# (e) scrubs f's last fragments, the corrupt one among them: all 477 (4.0
# GB with their images) took 14.92 s at the card machine's disk speed,
# and the run passed 720 s by its clock
OB_SCRUB_FRAGS = 32
OB_PASSES = 3                  # passes of (a)'s and (c)'s bursts
OB_K_COUNT = 'Count(Row(f="seg-007"))'   # phase 13's recreated k: 1000
OB_K_WANT = [K_RECREATE // 100]
OB_GB = "GroupBy(Rows(f, limit=4))"    # its oracle: f's first 4 counts
OB_PROFILED = (Q32, QC12, TOPN_G, OB_GB)
# families (a)'s scrape must carry: the batcher's, the kernels', the
# pipeline's, the fast lane's, the ledger's, the plane cache's, the
# executor's and the storage governor's
OB_FAMILIES = (
    "batcher_batches", "batcher_items", "batcher_window_seconds",
    "batcher_window_items", "batcher_window_fill_ratio",
    "kernel_dispatch_seconds", "kernel_bytes_scanned_total",
    "kernel_window_bytes", "kernel_bandwidth_gbps", "pipeline_window_fill",
    "readback_overlap_ratio", "dispatch_pipeline_depth",
    "solo_fastlane_hits_total", "tenant_device_seconds_total",
    "tenant_device_bytes_total", "shape_device_seconds_total",
    "plane_device_seconds_total", "query_device_seconds", "query_seconds",
    "query_stage_seconds", "query_queue_wait_seconds", "plan_cache_hits",
    "flight_events_total", "plane_cache_bytes", "plane_cache_hit_ratio",
    "plane_cache_entries", "plan_cache_entries", "device_health_state",
    "query_slots_in_use", "fragment_count", "disk_health_state",
    "storage_fragment_quarantined", "http_requests_total",
    "http_request_seconds")


def _families(text: str) -> dict:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _series(text: str, name: str) -> dict:
    """label text -> value of one family's plain samples."""
    out = {}
    for m in re.finditer(rf"^{name}(\{{[^}}]*\}})? (\S+)$", text, re.M):
        out[m.group(1) or ""] = float(m.group(2))
    return out


def _kind_of(labels: str) -> str:
    return re.search(r'kind="([^"]+)"', labels).group(1)


def obs_phase(client, holder, planes, so: dict, cuda: bool, device,
              data_dir: str) -> dict:
    """Phase 14: observability and storage integrity, on ``bench`` as
    phase 13 leaves it, through an executor with a metrics registry
    sharing the plane cache, behind its own REST server.  (a) A burst of
    phase 2's mix with the default 1% trace sample, then a ``/metrics``
    scrape: the families, the dispatch and byte counters against the
    batcher's and the ledger's own, the bandwidth gauge's every value in
    (0, peak].  (b) ``?profile`` on sequential requests: their kernels'
    CUDA-event ms <= the root's ledger ``deviceSeconds`` <= the wall.
    (c) A burst over ``bench`` and ``k``: every window's shares sum
    exactly to its seconds, the tenants' rollups to the total; a
    device-seconds quota sheds ``k``.  (d) A 50 ms watchdog on a windowed
    GroupBy Max behind a device sleep: the flight ring holds the run-up
    and the trip, and an incident file exists.  (e) One ``f`` snapshot flipped in place:
    the scrubber (paced) quarantines it, the next 32-Count leaves that
    shard out, a write to it answers 503, ``cli check`` prints BAD.  (f)
    Last, ``POST /debug/profile?seconds=1``: its Chrome trace names the
    kernels launched meanwhile.  Launch counters are reset at the start
    and read at the end."""
    import fractions
    import glob

    import torch
    from pilosa_tpu_torch.api import API, Server
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.obs import Stats
    from pilosa_tpu_torch.obs.ledger import apportion
    from pilosa_tpu_torch.store.scrub import Scrubber

    class PeakStats(Stats):
        """The registry, keeping each gauge's largest value too."""

        def __init__(self):
            super().__init__()
            self.peak: dict = {}

        def gauge(self, name, value, **labels):
            super().gauge(name, value, **labels)
            if value > self.peak.get(name, float("-inf")):
                self.peak[name] = value

    if cuda:
        log(f"phase 14 on {card_line()}")
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    st = PeakStats()
    base_ex = client.api.executor
    ex = _executor(holder, device=device, plane_budget=32 << 30, stats=st,
                   translate=base_ex.translate)
    ex.planes = planes
    # the shared cache and the holder's disk governor report here too
    planes._stats, planes.flight = st, ex.flight
    holder.storage_health.configure(stats=st)
    api = API(holder, ex)  # the reference's 1% trace sample, 1 s slow log
    c14 = _Client(api, cuda)
    server = Server(api, "127.0.0.1", 0).start()
    base = "http://%s:%d" % server.address
    after = so["after_d"]
    mix = (Q32, Q4, TOPN_G, QC12)
    names = {**MIX_NAMES, QC12: "compound Count"}
    nums: dict = {}
    try:
        # (a) a burst with a scrape
        for q in mix:
            c14.ask(q, after[q], tag=f"phase 14 {names[q]}")
        run = burst(api, after, CLIENTS, OB_PASSES, mix=mix, names=names)
        rate = run["requests"] / run["wall"]
        nums["burst_rps"] = rate
        nums["phase3_rps"] = BURST_RATES.get("default")
        st_code, _, raw = _http(base, "/status", method="GET")
        if st_code != 200 or "costs" not in json.loads(raw):
            raise AssertionError(f"/status {st_code}")
        st_code, _, raw = _http(base, "/metrics", method="GET")
        text = raw.decode()
        fams = _families(text)
        missing = [f for f in OB_FAMILIES if f not in fams]
        if st_code != 200 or missing:
            raise AssertionError(f"/metrics {st_code}: missing {missing}")
        b = ex.batcher
        disp = {_kind_of(k): int(v) for k, v in
                _series(text, "kernel_dispatch_seconds_count").items()}
        groups = {k: g for k, (g, _, _) in b.kinds.items()}
        scanned = sum(_series(text, "kernel_bytes_scanned_total").values())
        solo = sum(_series(text, "solo_fastlane_hits_total").values())
        led = ex.ledger.payload()
        # the ledger books each item's share of its group's bytes as an
        # int (the reference's): under the scanned bytes by < 1 per item
        short = scanned - led["bytesScannedTotal"]
        if (disp != groups or not 0 <= short < b.items + b.fastlane_hits
                or _series(text, "batcher_batches")[""] != b.windows
                or _series(text, "batcher_items")[""] != b.items
                or solo != b.fastlane_hits):
            raise AssertionError(
                f"/metrics against the batcher: dispatches {disp} vs "
                f"groups {groups}; bytes {scanned} vs ledger "
                f"{led['bytesScannedTotal']}; windows "
                f"{_series(text, 'batcher_batches')} vs {b.windows}; "
                f"items {b.items}; fast lane {solo} vs {b.fastlane_hits}")
        bw_peak = st.peak.get("kernel_bandwidth_gbps", 0.0)
        bw_last = _series(text, "kernel_bandwidth_gbps")[""]
        if not 0 < bw_peak <= OB_PEAK_GBPS:
            raise AssertionError(f"kernel_bandwidth_gbps peaked at "
                                 f"{bw_peak} GB/s (0, {OB_PEAK_GBPS}]")
        nums.update(bandwidth_peak_gbps=bw_peak, bandwidth_last_gbps=bw_last,
                    windows=b.windows, items=b.items,
                    fastlane=b.fastlane_hits, scrape_bytes=len(raw),
                    families=len(fams))
        log(f"[obs] (a) {CLIENTS} x {OB_PASSES} burst with the 1% trace "
            f"sample and the registry: {rate:.1f} requests/s (phase 3's, no "
            f"registry: {nums['phase3_rps'] or 0:.1f}); /metrics {len(raw)} "
            f"bytes, {len(fams)} families; {b.windows} windows, {b.items} "
            f"items, {b.fastlane_hits} fast-lane hits; dispatch counts by "
            f"kind {json.dumps(disp)} = the batcher's groups; "
            f"{scanned:.0f} B scanned, the ledger's {short:.0f} B short "
            f"(whole bytes per item); "
            f"kernel_bandwidth_gbps peak {bw_peak} GB/s, last {bw_last}")

        # (b) ?profile on sequential requests
        want_b = {**after, OB_GB: [[
            {"group": [{"field": "f", "rowID": r}], "count": c}
            for r, c in enumerate(after[Q32][:4]) if c]]}
        for q in OB_PROFILED:  # plans built, rows planes resident
            c14.ask(q, want_b[q], tag=f"phase 14 (b) {q[:20]}")
        prof: dict = {}
        for q in OB_PROFILED:
            rows = []
            for _ in range(3):
                cuda_kernels.EVENTS = []
                if cuda:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = api.query("bench", q, profile=True)
                wall = time.perf_counter() - t
                events, cuda_kernels.EVENTS = cuda_kernels.EVENTS, None
                if cuda:
                    torch.cuda.synchronize()
                kms = sum(a.elapsed_time(e) for _, a, e in events)
                root = out["profile"][0]
                dev_s = root["tags"].get("deviceSeconds", 0.0)
                if out["results"] != want_b[q]:
                    raise AssertionError(f"(b) profiled {q[:40]}")
                if not (kms / 1e3 <= dev_s <= wall and dev_s > 0):
                    raise AssertionError(
                        f"(b) {q[:40]}: kernels {kms:.4f} ms, ledger "
                        f"{dev_s * 1e3:.4f} ms, wall {wall * 1e3:.4f} ms")
                rows.append((kms, dev_s * 1e3, wall * 1e3, len(events),
                             [c["name"] for c in root["children"]]))
            prof[names.get(q, q[:24])] = rows
        for q, rows in prof.items():
            kms, dms, wms, n, kids = rows[-1]
            log(f"[obs] (b) {q}: kernels {kms:.4f} ms ({n} launches) <= "
                f"ledger {dms:.4f} ms <= wall {wms:.4f} ms (the last of "
                f"{len(rows)}; all hold); spans {kids}")
        nums["profiled"] = {q: rows[-1][:3] for q, rows in prof.items()}

        # (c) the ledger over two tenants
        windows: list = []
        charge_window = ex.ledger.charge_window

        def checked(wall, entries):
            entries = list(entries)
            shares = apportion(float(wall), [e[3] for e in entries])
            acc = 0.0
            for x in shares:
                acc += x
            windows.append((acc == float(wall), len(entries)))
            return charge_window(wall, entries)

        ex.ledger.charge_window = checked
        tenants0 = {k: list(v) for k, v in ex.ledger._tenants.items()}
        total0 = ex.ledger.total_seconds
        mix2 = (Q32, Q4, OB_K_COUNT)
        exp2 = {**after, OB_K_COUNT: OB_K_WANT}
        lat2: dict = {q: [] for q in mix2}
        errs: list = []
        start = threading.Barrier(CLIENTS + 1, timeout=600)

        def two(k: int) -> None:
            try:
                start.wait()
                for i in range(OB_PASSES * len(mix2)):
                    q = mix2[(k + i) % len(mix2)]
                    index = "k" if q == OB_K_COUNT else "bench"
                    t = time.perf_counter()
                    got = api.query(index, q)["results"]
                    lat2[q].append(time.perf_counter() - t)
                    if got != exp2[q]:
                        raise AssertionError(f"{q[:30]}: {got}")
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(repr(e)[:300])

        ths = [threading.Thread(target=two, args=(k,), daemon=True)
               for k in range(CLIENTS)]
        for th in ths:
            th.start()
        start.wait()
        for th in ths:
            th.join(600)
        ex.ledger.charge_window = charge_window
        if errs or any(th.is_alive() for th in ths):
            raise AssertionError(f"(c) burst: {errs[:3]}")
        if not windows or not all(ok for ok, _ in windows):
            raise AssertionError(f"(c) {sum(not ok for ok, _ in windows)} "
                                 f"of {len(windows)} windows' shares did "
                                 "not sum to their seconds")
        spent = {k: fractions.Fraction(v[0]) - fractions.Fraction(
            tenants0.get(k, [0.0])[0]) for k, v in ex.ledger._tenants.items()}
        total = (fractions.Fraction(ex.ledger.total_seconds)
                 - fractions.Fraction(total0))
        drift = float(abs(sum(spent.values()) - total))
        if set(k for k, v in spent.items() if v) != {"bench", "k"} \
                or drift > 1e-12 * max(1.0, float(total)):
            raise AssertionError(f"(c) tenants {spent} vs total {total}")
        ksec = ex.ledger.recent_seconds("k")
        ex.qos.device_seconds_quota = ksec / 2
        st_code, _, raw = _http(base, "/index/k/query", OB_K_COUNT.encode())
        shed = json.loads(raw)
        ex.qos.device_seconds_quota = 0.0
        if st_code != 503 or shed.get("tenantThrottled", {}).get(
                "kind") != "device-seconds":
            raise AssertionError(f"(c) quota: {st_code} {shed}")
        c14.ask(OB_K_COUNT, OB_K_WANT, index="k", tag="k after the quota")
        nums.update(c_windows=len(windows), c_tenants={
            k: float(v) for k, v in spent.items()}, c_total=float(total))
        log(f"[obs] (c) burst over bench and k, {CLIENTS} clients x "
            f"{OB_PASSES * len(mix2)}: "
            f"{len(windows)} windows, every one's shares summing exactly to "
            f"its seconds; tenant seconds "
            f"{json.dumps({k: float(v) for k, v in spent.items()})} sum to "
            f"{float(total):.6f} s (exact sum off by {drift:.3g} s); a "
            f"device-seconds quota of {ksec / 2:.6f} s shed k: 503 "
            f"{json.dumps(shed['tenantThrottled'])}")

        # (d) the watchdog trip in the flight ring
        gbq = GB_SEQ[3]
        # one windowed run first, with the bound still long: its planes
        # resident, and the device and pinned host blocks of this window's
        # sizes cached (an allocation anew could wait in the dispatch for
        # the device sleep queued below).  Its dispatch-to-readback span
        # is logged: on an H100 host it took ~14 ms, past phase 11's
        # 10 ms bound, so the trip here uses OB_WATCHDOG_S
        b.solo_fastlane = False
        seq_w = ex.flight.snapshot()["lastSeq"]
        api.query("bench", gbq)
        warm = {e["kind"]: e["ts"] for e in ex.flight.snapshot()["events"]
                if e["seq"] > seq_w and e["kind"] in ("dispatch",
                                                      "readback")}
        warm_disp_ms = ((warm["readback"] - warm["dispatch"]) * 1e3
                        if len(warm) == 2 else float("nan"))
        seq0 = ex.flight.snapshot()["lastSeq"]
        bound = OB_WATCHDOG_S if cuda else RB_WATCHDOG_S
        b.watchdog_s = bound
        time.sleep(1.2)  # the monitor's last long tick ends
        if cuda:
            # the stream sleeps ~0.2 s ahead of the window, so that its
            # readback outlasts the bound whatever the shard count, while
            # its dispatch (host work only) stays far below it
            torch.cuda._sleep(400_000_000)
        st_code, _, raw = _http(base, "/index/bench/query", gbq.encode())
        if st_code != 500 or "pipelineStall" not in json.loads(raw):
            raise AssertionError(f"(d) watchdog trip: {st_code} {raw[:200]}")
        _, _, raw = _http(base, "/debug/flight", method="GET")
        ring = json.loads(raw)
        mine = [e for e in ring["events"] if e["seq"] > seq0]
        kinds = [e["kind"] for e in mine]
        # on the card a launch returns at once and the window ages in its
        # readback; on the CPU the launch itself computes, and trips
        for k in ("enqueue", "dispatch", "watchdog_trip", "quarantine",
                  "incident", "governor") + (("readback",) if cuda else ()):
            if k not in kinds:
                raise AssertionError(f"(d) the ring lacks {k}: {kinds}")
        if kinds.index("enqueue") > kinds.index("watchdog_trip"):
            raise AssertionError("(d) no run-up before the trip")
        dumps = sorted(glob.glob(os.path.join(data_dir, "_flight",
                                              "flight-*.json")))
        if not dumps or not ring["dumps"]:
            raise AssertionError("(d) no incident file")
        dumped = json.load(open(ring["dumps"][-1]))
        b.watchdog_s = 30.0
        b.governor.probe_after_s = 0.2
        time.sleep(0.25)
        c14.ask(Q4, after[Q4], tag="probe after phase 14's trip")
        if b.governor.state != "healthy":
            raise AssertionError(f"(d) the probe left {b.governor.state}")
        b.solo_fastlane = True
        trip = next(e for e in mine if e["kind"] == "watchdog_trip")
        log(f"[obs] (d) watchdog {bound} s tripped on the GroupBy "
            f"Max window: 500 pipelineStall; the ring holds {len(mine)} "
            f"events since (kinds {sorted(set(kinds))}), the trip "
            f"{json.dumps(trip)}; incident files {len(dumps)}, the last "
            f"{os.path.basename(ring['dumps'][-1])} with "
            f"{len(dumped['events'])} events (reason {dumped['reason']}); "
            "a probe window back to healthy; the windowed run before it "
            f"spent {warm_disp_ms:.2f} ms from its dispatch to its "
            "readback")

        # (e) a corrupt snapshot found by the scrubber
        f_field = holder.index("bench").field("f")
        view = f_field.view("standard")
        shard = max(s for s in view.fragments if s != 0)
        frag = view.fragment(shard)
        frag.snapshot()  # a clean fragment: every row in its snapshot
        fw = so["f"][shard]
        rows_s = np.bitwise_count(fw).sum(axis=1).astype(np.int64)
        if [int(x) for x in frag.row_cardinalities()[1]] != \
                [int(x) for x in rows_s if x]:
            raise AssertionError("(e) the fragment differs from the oracle")
        want_e = [int(c - r) for c, r in zip(after[Q32], rows_s)]
        size = os.path.getsize(frag.path)
        with open(frag.path, "r+b") as fh:  # one byte, in place
            fh.seek(size // 2)
            byte = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0xFF]))

        from types import SimpleNamespace as NS
        frags = {sh: view.fragments[sh]
                 for sh in sorted(view.fragments)[-OB_SCRUB_FRAGS:]}
        log(f"CUT: the scrub reads f's last {len(frags)} fragments of "
            f"{len(view.fragments)}")
        scope = NS(path=holder.path, storage_health=holder.storage_health,
                   indexes={"bench": NS(fields={"f": NS(views={
                       "standard": NS(fragments=frags)})})})
        f_bytes = sum(os.path.getsize(fr.path) + fr._oplog.size()
                      + (os.path.getsize(fr.dense_path)
                         if os.path.exists(fr.dense_path) else 0)
                      for fr in frags.values())
        scrub = Scrubber(scope, interval=600.0,
                         bytes_per_second=OB_SCRUB_RATE, stats=st)
        t = time.perf_counter()
        res = scrub.run_once()
        scrub_s = time.perf_counter() - t
        entries = holder.storage_health.quarantined_entries()
        if (res["corrupt"] != 1 or [e["key"] for e in entries]
                != [("bench", "f", "standard", shard)]):
            raise AssertionError(f"(e) scrub {res}, quarantined {entries}")
        if scrub_s < res["bytes"] / OB_SCRUB_RATE - 1.1:
            raise AssertionError(f"(e) the scrub ran past its budget: "
                                 f"{res['bytes']} bytes in {scrub_s:.2f} s")
        builds = planes.builds
        c14.ask(Q32, want_e, tag="32-Count with a quarantined shard")
        planes.wait_builds()
        c14.ask(Q32, want_e, tag="32-Count with a quarantined shard")
        col = shard * (1 << 20) + 11
        st_code, _, raw = _http(base, "/index/bench/field/f/import",
                                json.dumps({"rowIDs": [1],
                                            "columnIDs": [col]}).encode())
        fault = json.loads(raw)
        if st_code != 503 or fault.get("storageFault", {}).get(
                "kind") != "snapshot":
            raise AssertionError(f"(e) write: {st_code} {fault}")
        _, _, raw = _http(base, "/status", method="GET")
        sh = json.loads(raw)["storageHealth"]
        tmp = os.path.join(data_dir, "_check")
        for rel in (".meta", os.path.join("f", ".meta")):
            os.makedirs(os.path.dirname(os.path.join(tmp, "bench", rel)),
                        exist_ok=True)
            shutil.copy(os.path.join(data_dir, "bench", rel),
                        os.path.join(tmp, "bench", rel))
        fdir = os.path.join(tmp, "bench", "f", "views", "standard",
                            "fragments")
        os.makedirs(fdir)
        shutil.copy(frag.path, fdir)
        rc, out = _run_cli(["check", "--data-dir", tmp])
        shutil.rmtree(tmp, ignore_errors=True)
        if rc != 1 or "BAD " not in out or "quarantined (snapshot)" not in out:
            raise AssertionError(f"(e) cli check: {rc} {out[-300:]}")
        nums.update(scrub=res, scrub_s=scrub_s, f_bytes=f_bytes)
        log(f"[obs] (e) shard {shard}'s f snapshot flipped at byte "
            f"{size // 2} of {size}: the scrubber at "
            f"{OB_SCRUB_RATE / 2 ** 20:.0f} MiB/s over f's last "
            f"{len(frags)} fragments read {res['bytes']} bytes in "
            f"{scrub_s:.2f} s and quarantined it; the 32-Count left the "
            f"shard out (plane builds {builds} -> {planes.builds}), exact; "
            f"a write answered 503 {json.dumps(fault['storageFault'])}; "
            f"storageHealth {json.dumps(sh)[:300]}; cli check: "
            f"{[ln for ln in out.splitlines() if ln.startswith('BAD')]}")

        # (f) last: a profiler capture names the hand kernels
        stop = threading.Event()

        def load() -> None:
            while not stop.is_set():
                for q in (Q32, Q4, QC12):
                    api.query("bench", q)

        before = dict(cuda_kernels.LAUNCHES)
        th = threading.Thread(target=load, daemon=True)
        th.start()
        try:
            st_code, _, raw = _http(base, "/debug/profile?seconds=1&dir="
                                    + os.path.join(data_dir, "_profiles"))
        finally:
            stop.set()
            th.join(60)
        cap = json.loads(raw)
        launched_f = {k for k, v in cuda_kernels.LAUNCHES.items()
                      if v > before[k]}
        trace = open(cap["traceFile"]).read() if st_code == 200 else ""
        named = {k for k in launched_f
                 if re.search(rf"(?<![A-Za-z_]){k}_kernel", trace)}
        if st_code != 200 or (cuda and named != launched_f) or not named \
                and cuda:
            raise AssertionError(f"(f) profile {st_code} {cap}: launched "
                                 f"{launched_f}, named {named}")
        log(f"[obs] (f) POST /debug/profile?seconds=1: {st_code}, "
            f"{len(trace)} bytes of Chrome trace naming "
            f"{sorted(k + '_kernel' for k in named)}")
    finally:
        cuda_kernels.EVENTS = None
        server.close()
        ex.close()
    launched = dict(cuda_kernels.LAUNCHES)
    log(f"launches in phase 14: {json.dumps(launched)}; wall "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"phase 14 numbers: {json.dumps(nums, default=str)}")
    if cuda:
        for k in ("row_counts", "count", "selected_row_counts"):
            if launched[k] < 1:
                raise AssertionError(f"phase 14 never launched {k}")
    return {"obs": launched}


# -- phase 15: the cluster ----------------------------------------------------

CLUSTER_DIR = os.path.join(REPO, "chip_smoke_cluster")
CL_NODES = 3                   # bench/config22_availability.py's layout:
CL_REPLICAS = 2                # 3 nodes, replicas = 2
CL_SHARDS = 64                 # phases 15-16's depth (a CUT line below the run's)
CL_BUDGET = 4 << 30            # each node's plane budget: 12 GiB for three
# seconds, the reference's default; a node is suspect after three.  A
# shorter interval lets a node whose heartbeat thread waits on the
# interpreter lock (three nodes and 32 clients in one process) take its
# peers for suspect: a shard universe read then holds only its own
# shards, and the reference's semantics serve that as complete
CL_HEARTBEAT = 2.0
CL_THREADS = 8                 # import-roaring requests in flight
CL_SEQ = 20                    # sequential 32-Counts timed through one node
CL_PASSES = 2                  # passes of the 32-client burst
CL_KEY_PAIRS = 4096            # keyed pairs over 8 row keys
CL_NEW_ROW = 40                # the 4096-pair /import writes rows 40-47
CL_LOSS_ROW = 50               # the Sets made while a node is down
CL_QC = ("Count(Intersect(Row(f=1), Row(g=0)))"
         "Count(Union(Row(f=1), Row(g=0)))")
CL_GB = "GroupBy(Rows(g, limit=1), Rows(f, limit=4))"
CL_KEYQ = 'Count(Row(kseg="seg-05"))'
CL_READS = (Q32, Q4, CL_QC, TOPN_G, CL_GB)
CL_NAMES = {Q32: "32-Count", Q4: "4-Count", CL_QC: "compound Count",
            TOPN_G: "filtered TopN", CL_GB: "GroupBy g x f"}


class _RestApi:
    """``api.query`` through one node's REST endpoint (a burst's client)."""

    def __init__(self, port: int):
        from pilosa_tpu_torch.api.client import Client
        self.client = Client("127.0.0.1", port, timeout=600)

    def query(self, index: str, pql: str) -> dict:
        return {"results": self.client.query(index, pql)}


def _cl_expect(ps: dict, n: int) -> dict:
    """The numpy oracle of phase 15's reads over the first ``n`` shards."""
    counts = ps["counts"][:n].sum(axis=0)
    filtered = ps["filtered"][:n].sum(axis=0)
    groups = [{"group": [{"field": "g", "rowID": 0},
                         {"field": "f", "rowID": r}],
               "count": int(filtered[r])} for r in range(4) if filtered[r]]
    return {Q32: [int(c) for c in counts],
            Q4: [int(counts[r]) for r in SELECTED],
            CL_QC: [int(ps["inter"][:n].sum()), int(ps["union"][:n].sum())],
            TOPN_G: [_topn(filtered, 5)], CL_GB: [groups]}


def _cl_frag(srv, field: str, shard: int):
    idx = srv.holder.index("cb")
    f = idx.field(field) if idx is not None else None
    v = f.standard_view() if f is not None else None
    return v.fragment(shard) if v is not None else None


def _cl_drop(srv) -> None:
    """Close a node without compacting its fragments (the tree is removed
    after the run): the cluster, REST server and executor stop, and the
    holder's in-memory rows are dropped."""
    srv.diagnostics.close()
    srv.scrubber.close()
    if srv.cluster is not None:
        srv.cluster.close()
    srv.http.close()
    srv.executor.close()
    for idx in list(srv.holder.indexes.values()):
        for f in list(idx.fields.values()):
            for v in list(f.views.values()):
                for frag in list(v.fragments.values()):
                    frag.discard()
    srv.holder.close()


def _cl_await(pred, what: str, timeout: float = 120.0) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pred():
            return time.perf_counter() - t0
        time.sleep(0.02)
    raise AssertionError(f"phase 15: timed out waiting for {what}")


# -- phase 16: backup and restore --------------------------------------------

BK_ROW = 60                    # the Sets written while the backup runs
BK_WORKERS = 8                 # parallel fragment pulls and pushes
BK_NODES = 2                   # the restore target: 2 nodes, replicas = 1
BK_INCR_SHARDS = 3             # shards written before the incremental pass
BK_WRITER_SHARDS = 4           # shards the writer of (a) writes to
BK_DIR = os.path.join(CLUSTER_DIR, "backup")


def backup_phase(servers: list, clients: list, n: int, expect: dict,
                 oracle: dict, cuda: bool, device) -> dict:
    """Phase 16 on phase 15's live cluster (index ``cb``: ``f``, ``g`` and
    ``kseg`` over the first ``n`` shards): (a) an online backup with a
    writer in flight, then a quiesced incremental pass; (b) an
    incremental pass after writes to known shards; (c) an elastic restore
    into a fresh 2-node cluster with ``replicas = 1``, every node's reads
    exact; (d) a flipped byte refused before the target holds an index;
    (e) the legacy tar of one restored node into a fresh single node.
    Returns the launch counts of (c)'s reads."""
    import torch
    from pilosa_tpu_torch.api.client import Client
    from pilosa_tpu_torch.backup import (BackupDriver, DigestError,
                                         Manifest, RestoreDriver)
    from pilosa_tpu_torch.cli.config import Config
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.server import PilosaTPUServer
    from pilosa_tpu_torch.testing import TestCluster, free_ports, node_config

    arch = os.path.join(BK_DIR, "archive")
    os.makedirs(BK_DIR, exist_ok=True)
    nums: dict = {}
    per_shard = oracle["per_shard"]

    # (a) the online backup, one thread writing Sets through a node that
    # does not own their shards
    via = 1
    vid = servers[via].cluster.node_id
    # a few shards: each write makes its fragment's capture retry and
    # the quiesced pass take it again
    foreign = [sh for sh in range(n)
               if vid not in servers[0].cluster.shard_owners("cb", sh)
               ][:BK_WRITER_SHARDS]
    acked: list[int] = []
    stop = threading.Event()
    errors: list = []

    def writer():
        c = Client("127.0.0.1", servers[via].port, timeout=600)
        k = 0
        while not stop.is_set():
            col = foreign[k % len(foreign)] * (1 << 20) + 1000 + k
            try:
                if c.query("cb", f"Set({col}, f={BK_ROW})") == [True]:
                    acked.append(col)
            except Exception as e:  # noqa: BLE001 — fails the phase
                errors.append(repr(e)[:200])
                return
            k += 1
        c.close()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        _cl_await(lambda: len(acked) >= 5, "the backup's writer")
        port = servers[0].port
        full = BackupDriver("127.0.0.1", port, arch,
                            workers=BK_WORKERS).run()
    finally:
        stop.set()
        wt.join(timeout=120)
    if errors:
        raise AssertionError(f"a write during the backup failed: {errors}")
    mbps = full["bytes"] / full["seconds"] / 1e6
    log(f"(a) online backup: {full['fragments']} fragments, "
        f"{full['bytes'] / 1e9:.3f} GB in {full['seconds']:.2f}s = "
        f"{mbps:.1f} MB/s with {BK_WORKERS} workers, {full['fallbacks']} "
        f"replica fallbacks; {len(acked)} Sets acked through node {via} "
        "meanwhile")
    tail = BackupDriver("127.0.0.1", port, arch, workers=BK_WORKERS,
                        incremental=True).run()
    log(f"quiesced incremental pass: {len(tail['transferred'])} "
        f"transferred (the writer's tail), {len(tail['skipped'])} skipped "
        f"in {tail['seconds']:.2f}s")
    nums["full"] = {k: full[k] for k in ("fragments", "bytes", "seconds",
                                         "fallbacks")}
    nums["full"]["mbps"] = mbps

    # (b) writes to known shards, then an incremental pass that moves
    # exactly their fragments
    known = list(range(BK_INCR_SHARDS))
    for sh in known:
        col = sh * (1 << 20) + 7
        if clients[0].query("cb", f"Set({col}, f={BK_ROW})") != [True]:
            raise AssertionError("a Set before the incremental pass")
        acked.append(col)
    incr = BackupDriver("127.0.0.1", port, arch, workers=BK_WORKERS,
                        incremental=True).run()
    want = {f"cb/f/standard/{sh}" for sh in known}
    if set(incr["transferred"]) != want or len(incr["skipped"]) != \
            full["fragments"] - len(want):
        raise AssertionError(f"the incremental pass moved "
                             f"{incr['transferred']}, want {sorted(want)}")
    log(f"(b) incremental: {len(incr['transferred'])} fragments "
        f"transferred (exactly the written ones), {len(incr['skipped'])} "
        f"skipped, {incr['bytes'] / 1e6:.1f} MB in {incr['seconds']:.2f}s")
    nums["incremental"] = {k: incr[k] for k in ("bytes", "seconds")}
    man = Manifest.load(arch)

    # (c) an elastic restore into a fresh 2-node cluster, replicas = 1
    rports = free_ports(BK_NODES)
    rbase = os.path.join(BK_DIR, "restored")
    targets: list = []
    single = None
    try:
        seed = None
        for i in range(BK_NODES):
            cfg = node_config(i, rbase, seed, port=rports[i], replicas=1,
                              heartbeat=CL_HEARTBEAT, device=device or "",
                              plane_budget_bytes=CL_BUDGET,
                              plane_sidecars=False,
                              scrub_bytes_per_second=0)
            targets.append(PilosaTPUServer(cfg).open())
            seed = seed or targets[0].cluster.node_id
        tc = TestCluster(targets)
        tc.await_membership(BK_NODES, 60)
        tc.await_state("NORMAL", 60)
        t0 = time.perf_counter()
        res = RestoreDriver("127.0.0.1", targets[0].port, arch,
                            workers=BK_WORKERS).run()
        restore_s = time.perf_counter() - t0
        log(f"(c) restore into {BK_NODES} nodes (replicas = 1): "
            f"{res['fragments']} fragments, {res['pushes']} pushes, "
            f"{res['bytes'] / 1e9:.3f} GB in {restore_s:.2f}s = "
            f"{res['bytes'] / restore_s / 1e6:.1f} MB/s, AAE repaired "
            f"{res['aaeRepaired']}")
        nums["restore"] = {"seconds": restore_s, "bytes": res["bytes"],
                           "mbps": res["bytes"] / restore_s / 1e6}
        rclients = [Client("127.0.0.1", t.port, timeout=600)
                    for t in targets]
        reads = {Q32: expect[Q32], Q4: expect[Q4], TOPN_G: expect[TOPN_G],
                 CL_QC: expect[CL_QC],
                 f"Count(Row(f={BK_ROW}))": [len(set(acked))]}
        cuda_kernels.reset_launches()
        firsts = []
        for i, c in enumerate(rclients):
            for pql, want_ans in reads.items():
                t = time.perf_counter()
                got = c.query("cb", pql)
                if pql == Q32:
                    firsts.append(round((time.perf_counter() - t) * 1e3, 2))
                if got != want_ans:
                    raise AssertionError(f"restored node {i} {pql[:40]}: "
                                         f"got {str(got)[:200]}")
            if c.query("cb", CL_KEYQ) != clients[0].query("cb", CL_KEYQ):
                raise AssertionError(f"restored node {i}: keyed Count")
        launches = dict(cuda_kernels.LAUNCHES)
        log(f"restored reads exact on both nodes (the oracle plus "
            f"{len(set(acked))} acked Sets); first 32-Count ms by node "
            f"(planes built on first use): {firsts}; launches "
            f"{json.dumps(launches)}")
        nums["first_q32_ms"] = firsts
        if cuda:
            for k in ("row_counts", "count", "selected_row_counts"):
                if launches[k] < 1:
                    raise AssertionError(f"phase 16 never launched {k}")

        # (d) one flipped byte: refused before the target holds an index
        bad = os.path.join(BK_DIR, "corrupt")
        ent = man.fragments[sorted(man.fragments)[0]]
        for root, _, names in os.walk(arch):
            for name in names:
                rel = os.path.relpath(os.path.join(root, name), arch)
                dst = os.path.join(bad, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                if rel == ent["file"]:
                    shutil.copyfile(os.path.join(arch, rel), dst)
                else:
                    os.link(os.path.join(arch, rel), dst)
        with open(os.path.join(bad, ent["file"]), "r+b") as fh:
            fh.seek(ent["bytes"] // 2)
            byte = fh.read(1)
            fh.seek(ent["bytes"] // 2)
            fh.write(bytes([byte[0] ^ 0x01]))
        # an un-clustered node on the card: no scrubber, no .dense images
        single = PilosaTPUServer(Config(
            bind="127.0.0.1:0", data_dir=os.path.join(BK_DIR, "single"),
            device=device or "", plane_budget_bytes=CL_BUDGET,
            plane_sidecars=False, scrub_bytes_per_second=0,
            mesh=False)).open()
        try:
            RestoreDriver("127.0.0.1", single.port, bad).run()
        except DigestError as e:
            if single.holder.indexes:
                raise AssertionError("the corrupt archive touched its "
                                     "target")
            log(f"(d) corrupt archive refused before the target was "
                f"touched: {e}")
        else:
            raise AssertionError("a flipped byte restored")

        # (e) the legacy tar: one restored node's data directory into the
        # fresh single node
        src_i = 0
        held = sorted(targets[src_i].holder.index("cb").available_shards())
        t0 = time.perf_counter()
        blob = rclients[src_i]._do("GET", "/internal/backup")
        tar_s = time.perf_counter() - t0
        before = (torch.cuda.memory_allocated() if cuda else 0,
                  single.executor.planes.stats()["bytes"])
        t0 = time.perf_counter()
        sc = Client("127.0.0.1", single.port, timeout=600)
        sc._do("POST", "/internal/restore", blob,
               content_type="application/x-tar")
        untar_s = time.perf_counter() - t0
        after = (torch.cuda.memory_allocated() if cuda else 0,
                 single.executor.planes.stats()["bytes"])
        want32 = [int(v) for v in
                  per_shard["counts"][held].sum(axis=0)]
        if sc.query("cb", Q32) != want32:
            raise AssertionError("the tar-restored node's 32-Count")
        log(f"(e) legacy tar of restored node {src_i} ({len(held)} shards): "
            f"{len(blob) / 1e9:.3f} GB written in {tar_s:.2f}s, restored "
            f"into a fresh node in {untar_s:.2f}s; its 32-Count exact; "
            f"device memory {before[0] / 1e9:.3f} -> {after[0] / 1e9:.3f} "
            f"GB, resident plane bytes {before[1]} -> {after[1]} (a "
            "restore takes only an empty holder, so there was no old "
            "plane to drop)")
        nums["tar"] = {"bytes": len(blob), "seconds": tar_s,
                       "restore_seconds": untar_s}
        sc.close()
        for c in rclients:
            c.close()
    finally:
        for srv in targets + ([single] if single is not None else []):
            try:
                _cl_drop(srv)
            except Exception as e:  # noqa: BLE001 — the phase's own error
                log(f"closing a restore node: {e!r}")
    log(f"phase 16 numbers: {json.dumps(nums, default=str)}")
    return launches


# -- phase 17: chaos on the card ----------------------------------------------

CHAOS_SCENARIOS = ("hung_dispatch_serving", "flaky_device_governor")
CHAOS_EXTRA = "corrupt_fragment_scrub_repair"   # 2 nodes, when time allows
CHAOS_BUDGET_S = 40.0          # the phase's seconds, the optional one too


def chaos_phase(seed: int, device=None) -> dict:
    """Phase 17: the port's chaos scenarios on process clusters whose
    nodes serve on the card (each its own CUDA context, the kernels
    loaded from ``pilosa_tpu_torch/_build``): the hung dispatch and the
    flaky device, each on a 1-node cluster, side by side; the 2-node
    scrub-and-repair drill too when the two left room under the phase's
    budget.  A scenario that fails raises.  Returns each scenario's
    seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.fault import chaos

    # the nodes are ``python -m pilosa_tpu_torch.cli`` children
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    base = os.path.join(CLUSTER_DIR, "chaos")
    secs: dict = {}
    t_all = time.perf_counter()

    def one(name: str) -> None:
        t0 = time.perf_counter()
        chaos.run_scenario(name, seed, os.path.join(base, name),
                           device=device or "")
        secs[name] = round(time.perf_counter() - t0, 2)
        log(f"chaos {name}: invariants held in {secs[name]:.2f}s")

    # the two 1-node clusters are separate processes: they boot and run
    # side by side
    with ThreadPoolExecutor(len(CHAOS_SCENARIOS)) as pool:
        for fut in [pool.submit(one, name) for name in CHAOS_SCENARIOS]:
            fut.result()
    spent = time.perf_counter() - t_all
    # the two-node drill took about as long as the two one-node ones
    # one after the other on the CPU
    if spent * 3 < CHAOS_BUDGET_S:
        t0 = time.perf_counter()
        chaos.run_scenario(CHAOS_EXTRA, seed,
                           os.path.join(base, CHAOS_EXTRA),
                           device=device or "")
        secs[CHAOS_EXTRA] = round(time.perf_counter() - t0, 2)
        log(f"chaos {CHAOS_EXTRA}: invariants held in "
            f"{secs[CHAOS_EXTRA]:.2f}s")
    else:
        log(f"CUT: chaos {CHAOS_EXTRA} left out: the two device scenarios "
            f"took {spent:.1f}s of the phase's {CHAOS_BUDGET_S:.0f}s")
    return secs


def cluster_phase(oracle: dict, cuda: bool, device, shards: int,
                  single: dict, t_start: float) -> dict:
    """Phase 15: a 3-node cluster with ``replicas = 2`` in this process,
    each node its own executor on the card; then phase 16 on the same
    live cluster before its nodes close.  Returns phase 15's launch
    counts under "launches" and phase 16's under "backup"."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from pilosa_tpu_torch.api.client import Client
    from pilosa_tpu_torch.engine import cuda_kernels
    from pilosa_tpu_torch.server import PilosaTPUServer
    from pilosa_tpu_torch.testing import TestCluster, free_ports, node_config

    n = min(shards, CL_SHARDS)
    if n < shards:
        log(f"CUT: phases 15-16's cluster serves the first {n} of the "
            f"run's {shards} shards: every node imports and applies each "
            f"of its fragments on the host, about {2 * 4.2:.1f} MB of bits "
            "per shard per replica, and phase 16 backs them up and "
            "restores them twice, within phase 15's 90 s and phases "
            "16-17's 80 s on the slower card machines (128 shards took "
            "39.2 s and 61.5 + 22.9 s on one, 96 took 31.2 s and 55.8 + "
            "25.9 s on a slower one)")
    expect = _cl_expect(oracle["per_shard"], n)
    ports = free_ports(CL_NODES)
    base = os.path.join(CLUSTER_DIR, "nodes")

    def config(i: int, seed):
        # no scrubber and no .dense images (the disk-write cap); AAE only
        # when triggered
        return node_config(i, base, seed, port=ports[i],
                           replicas=CL_REPLICAS, heartbeat=CL_HEARTBEAT,
                           device=device or "", plane_budget_bytes=CL_BUDGET,
                           plane_sidecars=False, scrub_bytes_per_second=0)

    out: dict = {}
    servers: list = []
    try:
        t0 = time.perf_counter()
        seed = None
        for i in range(CL_NODES):
            srv = PilosaTPUServer(config(i, seed)).open()
            servers.append(srv)
            seed = seed or srv.cluster.node_id
        tc = TestCluster(servers)
        tc.await_membership(CL_NODES, 60)
        tc.await_state("NORMAL", 60)
        coord = servers[0].cluster.coordinator_id()
        log(f"cluster up in {time.perf_counter() - t0:.2f}s: "
            f"{[s.cluster.node_id for s in servers]}, coordinator {coord}, "
            f"{CL_NODES} x {CL_BUDGET >> 30} GiB plane budgets on one card")
        pos = {s.cluster.node_id: i for i, s in enumerate(servers)}
        clients = [Client("127.0.0.1", s.port, timeout=600)
                   for s in servers]
        c0 = clients[0]
        c0.create_index("cb", {"trackExistence": False})
        c0.create_field("cb", "f")
        c0.create_field("cb", "g")
        c0.create_field("cb", "kseg", {"keys": True})
        placement = [list(s.cluster.placement_ids) for s in servers]

        # (b) the bulk import: every shard's f and g blobs, as data
        # generation wrote them, to any node; routed to both owners
        def one(job):
            name, sh = job
            with open(os.path.join(CLUSTER_DIR, "src", name, str(sh)),
                      "rb") as fh:
                blob = fh.read()
            c = Client("127.0.0.1", servers[sh % CL_NODES].port,
                       timeout=600)
            try:
                return name, sh, len(blob), c.import_roaring(
                    "cb", name, sh, blob)
            finally:
                c.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(CL_THREADS) as pool:
            imported = list(pool.map(
                one, [(name, sh) for sh in range(n) for name in ("f", "g")]))
        import_s = time.perf_counter() - t0
        sent = sum(b for _, _, b, _ in imported)
        for name, sh, _, changed in imported:
            if name == "f" and changed != int(
                    oracle["per_shard"]["counts"][sh].sum()):
                raise AssertionError(f"import of f shard {sh} changed "
                                     f"{changed} bits")
        log(f"bulk import: {2 * n} roaring blobs, {sent / 1e9:.3f} GB sent "
            f"(x{CL_REPLICAS} replicas applied) in {import_s:.2f}s = "
            f"{sent / import_s / 1e6:.1f} MB/s sent")
        out["import_s"], out["import_bytes"] = import_s, sent
        for sh in range(n):
            owners = servers[0].cluster.shard_owners("cb", sh)
            for s in servers:
                frag = _cl_frag(s, "f", sh)
                held = 0 if frag is None else int(
                    frag.row_cardinalities()[1].sum())
                want = (int(oracle["per_shard"]["counts"][sh].sum())
                        if s.cluster.node_id in owners else 0)
                if held != want:
                    raise AssertionError(
                        f"shard {sh} on node {pos[s.cluster.node_id]}: "
                        f"{held} bits, want {want}")

        # (a) reads on all three nodes, each answer held to the oracle
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        first = {}
        for i, c in enumerate(clients):
            for pql in CL_READS:
                t = time.perf_counter()
                got = c.query("cb", pql)
                first.setdefault(CL_NAMES[pql], []).append(
                    round((time.perf_counter() - t) * 1e3, 2))
                if got != expect[pql]:
                    raise AssertionError(f"node {i} {CL_NAMES[pql]}: got "
                                         f"{str(got)[:200]}")
        log(f"reads on 3 nodes exact in {time.perf_counter() - t0:.2f}s; "
            f"first answers ms by node (planes built on first use): "
            f"{json.dumps(first)}")
        # keys: created by the coordinator for an import through another
        # node, replicated to every node's key store
        rng = np.random.default_rng(15)
        cols = rng.choice(n * (1 << 20), CL_KEY_PAIRS, replace=False)
        keys = [f"seg-{k:02d}" for k in rng.integers(1, 9, CL_KEY_PAIRS)]
        via = next(i for i, s in enumerate(servers)
                   if s.cluster.node_id != coord)
        clients[via].import_bits("cb", "kseg", rowKeys=keys,
                                 columnIDs=[int(c) for c in cols])
        want_key = [sum(k == "seg-05" for k in keys)]
        for i, c in enumerate(clients):
            got = c.query("cb", CL_KEYQ)
            if got != want_key:
                raise AssertionError(f"node {i} keyed Count: got {got}, "
                                     f"want {want_key}")
            if len(servers[i].executor.translate.rows("cb", "kseg")) != 8:
                raise AssertionError(f"node {i} lacks the replicated keys")
        seq = []
        for _ in range(CL_SEQ):
            t = time.perf_counter()
            if c0.query("cb", Q32) != expect[Q32]:
                raise AssertionError("sequential 32-Count")
            seq.append(time.perf_counter() - t)
        rest = _RestApi(servers[0].port)
        run = burst(rest, {Q32: expect[Q32]}, clients=32,
                    passes=CL_PASSES, mix=(Q32,), names=CL_NAMES,
                    index="cb")
        rps = run["requests"] / run["wall"]
        out["p50_ms"], out["rps"] = _median_ms(seq), rps
        log(f"32-Count through node 0: sequential p50 {_median_ms(seq):.2f} "
            f"ms (phase 2, one node: {single.get('p50_ms', 0.0):.2f} ms); "
            f"32 clients x {CL_PASSES}: {rps:.1f} requests/s, p50 "
            f"{_pct_ms(run['lat'][Q32], 0.5):.2f} ms, p99 "
            f"{_pct_ms(run['lat'][Q32], 0.99):.2f} ms (phase 3, one node: "
            f"{BURST_RATES.get('default', 0.0):.1f} requests/s)")
        launches = dict(cuda_kernels.LAUNCHES)
        log(f"launches during the cluster's reads: {json.dumps(launches)}")
        for k in ("row_counts", "selected_row_counts", "count"):
            if cuda and launches[k] < 1:
                raise AssertionError(f"phase 15 never launched {k}")

        # (b) writes through the node that does not own the shard
        owners = servers[0].cluster.shard_owners("cb", 0)
        via = next(i for i, s in enumerate(servers)
                   if s.cluster.node_id not in owners)
        col = oracle["free_col"]
        holders = [tc.server_for(o) for o in owners]

        def bit(srv, row, column) -> bool:
            frag = _cl_frag(srv, "f", 0)
            return bool(frag.rows_contain([row], [column])[0, 0])

        if clients[via].query("cb", f"Set({col}, f=3)") != [True]:
            raise AssertionError("Set through a non-owner")
        if not all(bit(h, 3, col) for h in holders):
            raise AssertionError("the Set is not on both replicas")
        if _cl_frag(servers[via], "f", 0) is not None:
            raise AssertionError("the non-owner holds shard 0")
        if clients[via].query("cb", f"Clear({col}, f=3)") != [True]:
            raise AssertionError("Clear through a non-owner")
        if any(bit(h, 3, col) for h in holders):
            raise AssertionError("the Clear is not on both replicas")
        pcols = rng.choice(1 << 20, 4096, replace=False)
        prows = CL_NEW_ROW + rng.integers(0, 8, 4096)
        t = time.perf_counter()
        changed = clients[via].import_bits(
            "cb", "f", rowIDs=[int(r) for r in prows],
            columnIDs=[int(c) for c in pcols])
        imp_ms = (time.perf_counter() - t) * 1e3
        for h in holders:
            got = _cl_frag(h, "f", 0).rows_contain(
                np.arange(CL_NEW_ROW, CL_NEW_ROW + 8), pcols)
            if changed != 4096 or int(got[prows - CL_NEW_ROW,
                                          np.arange(4096)].sum()) != 4096:
                raise AssertionError("the 4096-pair import is not on "
                                     "both replicas")
        log(f"Set / Clear / 4096-pair import through node {via} (not an "
            f"owner of shard 0) on both replicas; the import "
            f"{imp_ms:.1f} ms")
        c0.import_bits("cb", "f", rowIDs=[int(r) for r in prows],
                       columnIDs=[int(c) for c in pcols], clear=True)

        # (c) node loss: reads stay exact, writes are hinted and replay
        victim_i = next(i for i, s in enumerate(servers)
                        if s.cluster.node_id != coord and i != via)
        reader_i = next(i for i in range(CL_NODES)
                        if i not in (victim_i,) and
                        servers[i].cluster.node_id == coord)
        victim = servers[victim_i]
        vid, vcfg = victim.cluster.node_id, victim.cfg
        answers, failures = [], []
        stop = threading.Event()

        def reader():
            c = Client("127.0.0.1", servers[reader_i].port, timeout=600)
            while not stop.is_set():
                try:
                    got = c.query("cb", Q32)
                    answers.append(got == expect[Q32])
                except Exception as e:  # noqa: BLE001 — counted
                    failures.append(repr(e)[:200])
            c.close()

        rt = threading.Thread(target=reader, daemon=True)
        rt.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        victim.close()
        close_s = time.perf_counter() - t0
        alive = [s for s in servers if s is not victim]
        _cl_await(lambda: all(vid not in s.cluster.alive_ids()
                              for s in alive), "the victim to be suspect")
        time.sleep(1.0)
        stop.set()
        rt.join(timeout=120)
        if failures or not all(answers):
            raise AssertionError(f"reads failed through the node loss: "
                                 f"{len(failures)} errors {failures[:2]}, "
                                 f"{answers.count(False)} wrong")
        vshards = [sh for sh in range(n)
                   if vid in alive[0].cluster.shard_owners("cb", sh)]
        wcols = [sh * (1 << 20) + col for sh in vshards[:8]]
        for wc in wcols:
            if clients[reader_i].query(
                    "cb", f"Set({wc}, f={CL_LOSS_ROW})") != [True]:
                raise AssertionError("a write through the node loss")
        hinted = sum(s.cluster.hints.pending_ops() for s in alive)
        log(f"node {victim_i} closed in {close_s:.2f}s: {len(answers)} reads "
            f"through it, {len(failures)} failed, all exact; "
            f"{len(wcols)} Sets to its shards hinted as {hinted} op(s)")
        if hinted < len(wcols):
            raise AssertionError("the writes were not hinted")
        t0 = time.perf_counter()
        back = PilosaTPUServer(vcfg).open()
        servers[victim_i] = back
        clients[victim_i].close()  # its pooled sockets died with the node
        clients[victim_i] = Client("127.0.0.1", back.port, timeout=600)
        for s in alive:
            s.cluster._drain_hints(vid)
        converge_s = time.perf_counter() - t0 + _cl_await(
            lambda: all(s.cluster.hints.pending_ops() == 0 for s in alive)
            and all(_cl_frag(back, "f", wc >> 20).rows_contain(
                [CL_LOSS_ROW], [col])[0, 0] for wc in wcols),
            "the hints to replay")
        tc.await_state("NORMAL", 60)
        log(f"node {victim_i} reopened, its {hinted} hint(s) replayed: "
            f"converged in {converge_s:.2f}s")
        # every node learns of the drained backlog from the next
        # heartbeats; until then AAE defers syncs with the node
        _cl_await(lambda: not any(s.cluster.hinted_peers()
                                  for s in servers), "the hinted peers")
        out["converge_s"] = converge_s
        loss_q = f"Count(Row(f={CL_LOSS_ROW}))"
        for i, c in enumerate(clients):
            if c.query("cb", loss_q) != [len(wcols)] or c.query(
                    "cb", Q32) != expect[Q32]:
                raise AssertionError(f"node {i} after the replay")
        # one diverged fragment, repaired by a triggered AAE round
        sh = vshards[0]
        o1, o2 = (tc.server_for(o)
                  for o in servers[0].cluster.shard_owners("cb", sh))
        _cl_frag(o1, "f", sh).set_bits(np.array([CL_NEW_ROW], np.uint64),
                                       np.array([7, 8, 9], np.uint64))
        t0 = time.perf_counter()
        # scoped in-process (the REST route runs the reference's full
        # round)
        repaired = o1.cluster.sync_once(("cb", "f", None, sh))
        aae_s = time.perf_counter() - t0
        if repaired < 1 or not _cl_frag(o2, "f", sh).rows_contain(
                [CL_NEW_ROW], [7, 8, 9]).all():
            raise AssertionError("AAE did not repair the diverged replica")
        log(f"AAE: {repaired} block(s) of the diverged fragment repaired in "
            f"{aae_s:.3f}s by a round over it alone (the periodic sweep "
            "off)")
        out["aae_s"] = aae_s
        # a quarantined fragment rebuilt from its replica
        frag = _cl_frag(o2, "f", sh)
        sh_health = o2.holder.storage_health
        entry = sh_health.quarantine(frag.path, "snapshot",
                                     "quarantined by phase 15")
        t0 = time.perf_counter()
        if not o2.cluster.repair_quarantined(entry):
            raise AssertionError("repair_quarantined failed")
        repair_s = time.perf_counter() - t0
        if sh_health.is_quarantined(frag.path) or int(
                frag.row_cardinalities()[1].sum()) != int(
                _cl_frag(o1, "f", sh).row_cardinalities()[1].sum()):
            raise AssertionError("the rebuilt fragment differs")
        log(f"quarantined fragment rebuilt from its replica in "
            f"{repair_s:.2f}s")
        for i, c in enumerate(clients):
            if c.query("cb", Q32) != expect[Q32] or c.query(
                    "cb", loss_q) != [len(wcols)]:
                raise AssertionError(f"node {i} after the repair")

        # (d) the cluster's observability routes
        with urllib.request.urlopen(
                f"http://127.0.0.1:{servers[0].port}/metrics/cluster",
                timeout=60) as resp:
            text = resp.read().decode()
        up = re.findall(r'^cluster_metrics_node_up\{node="[^"]+"\} (\d)',
                        text, re.M)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{servers[0].port}/status/cluster",
                timeout=60) as resp:
            status = json.loads(resp.read())
        if up != ["1"] * CL_NODES or status["staleNodes"] or len(
                status["nodes"]) != CL_NODES:
            raise AssertionError(f"/metrics/cluster node_up {up}, "
                                 f"/status/cluster {status['staleNodes']}")
        log(f"/metrics/cluster: {len(text)} bytes, {CL_NODES} nodes up; "
            f"/status/cluster: {CL_NODES} nodes, coordinator "
            f"{status['coordinator']}")
        # the reopened node's join ran a resize over the same members: it
        # may bump the placement's version, never its owners
        if [list(s.cluster.placement_ids) for s in servers] != placement:
            raise AssertionError("a resize moved the loaded placement")
        out["launches"] = launches
        if cuda:
            log(f"device memory after phase 15: "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        t_phase = phase_done(15, t_start)
        log("== phase 16: backup and restore ==")
        out["backup"] = backup_phase(servers, clients, n, expect, oracle,
                                     cuda, device)
        phase_done(16, t_phase)
    finally:
        for srv in servers:
            try:
                _cl_drop(srv)
            except Exception as e:  # noqa: BLE001 — the phase's own error
                log(f"closing a cluster node: {e!r}")
    return out



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--shards", type=int, default=477,
                    help=f"shards of 2^20 columns ({FULL_SHARDS} = 1.0e9 "
                         "columns, the full configuration)")
    ap.add_argument("--procs-only", action="store_true",
                    help="phase 1 and phase procs alone (after phase 2's "
                         "write): the run that needs several cards")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pilosa_tpu_torch  # noqa: F401 — fails outside the repo

    # a minute before the limit, every thread's stack goes to stderr
    faulthandler.dump_traceback_later(RUN_LIMIT_S - 60, exit=False)
    # slow queries (the reference's 1 s threshold) stay counted and kept
    # in /debug/slow; a warning line each would bury the phase headers
    import logging
    logging.getLogger("pilosa_tpu_torch.api").setLevel(logging.ERROR)

    smi = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {smi}")
    if args.shards != FULL_SHARDS:
        log(f"CUT: {args.shards} shards instead of {FULL_SHARDS} "
            f"({args.shards * 2 ** 20:.3g} columns)")

    t_all = time.perf_counter()
    log("== phase 1: build and kernels ==")
    kres = kernel_phase(args.shards, args.seed)
    phase_done(1, t_all)

    data_dir = os.path.join(REPO, "chip_smoke_data")
    shutil.rmtree(data_dir, ignore_errors=True)
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        oracle = make_index(data_dir, args.shards, args.seed)
        phase_done("data and oracle", t0)
        du = shutil.disk_usage(data_dir)
        log(f"disk before phase 2: {du.free / 1e9:.1f} GB free of "
            f"{du.total / 1e9:.1f} GB; the data "
            f"{_dir_bytes(data_dir) / 1e9:.2f} GB")
        if args.procs_only:
            log("CUT: --procs-only: phase procs alone, after phase 2's "
                "write")
            launches = procs_only(data_dir, oracle)
        else:
            log("== phase 2: serving ==")
            launches = serve_phase(data_dir, oracle, seed=args.seed)
            t_phase = time.perf_counter()
            log("== phase 17: chaos on the card ==")
            chaos_secs = chaos_phase(args.seed)
            log(f"phase 17 scenarios' seconds: {json.dumps(chaos_secs)}")
            phase_done(17, t_phase)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(CLUSTER_DIR, ignore_errors=True)

    log("== phase 18: output ==")
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name],
         "launches": sum(by[name] for by in launches.values()),
         "launches_by_path": {p: by[name] for p, by in launches.items()},
         "mesh_launches_by_card": {c: by[name] for c, by
                                   in MESH_CARD_LAUNCHES.items()},
         "procs_launches_by_card": {c: by.get(name, 0) for c, by
                                    in PROCS_CARD_LAUNCHES.items()},
         "max_abs_err_by_card": r["max_abs_err_by_card"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "checked": "equal to plain at main-path and ragged shapes",
         **({"bsi_shapes": r["bsi_shapes"]} if "bsi_shapes" in r else {}),
         **({"blocks_ms": r["blocks_ms"]} if "blocks_ms" in r else {})}
        for name, r in kres.items()]}
    log(f"total {time.perf_counter() - t_all:.1f}s")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
