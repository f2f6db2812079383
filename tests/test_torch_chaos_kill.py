"""The port's chaos scenarios that kill and restart a member, each on its
own 3-node process cluster on the CPU (``replicas = 2``), booted by
``chaos.run_scenario`` as ``main`` boots it, so the shared trio of
``tests/test_torch_chaos.py`` stays whole:

- node kill failover (hinted handoff off): no failed read through a
  SIGKILL, the breaker opens, strict writes refuse 503, the rejoin
  closes it;
- clear during kill handoff: Set, Clear and ClearRow keep serving, the
  rejoin drains the hints, forced AAE resurrects nothing;
- bulk import kill handoff: import batches keep acking as hinted import
  records, the drain replays them, op-id dedup no-ops a redelivery;
- coordinator crash mid-hint-append: the torn op never applies, the
  clean prefix replays;
- straggler hedged read (hedging on): a delayed leg is hedged to a
  replica within the bound, the answer exact, the ``hedged`` tag kept.
"""

import os

from pilosa_tpu_torch.fault import chaos
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SEED = int(os.environ.get("PILOSA_CHAOS_SEED", "42"))


def _run(name, tmp_path):
    # the cluster that ``main`` boots: replicas = 2, a 1 s sweep unless
    # the scenario's entry in ``SCENARIOS`` says otherwise
    chaos.run_scenario(name, SEED, str(tmp_path), device="cpu")


def test_node_kill_failover(tmp_path):
    _run("node_kill_failover", tmp_path)


def test_clear_during_kill_handoff(tmp_path):
    _run("clear_during_kill_handoff", tmp_path)


def test_bulk_import_kill_handoff(tmp_path):
    _run("bulk_import_kill_handoff", tmp_path)


def test_coordinator_crash_hint_log(tmp_path):
    _run("coordinator_crash_hint_log", tmp_path)


def test_straggler_hedged_read(tmp_path):
    _run("straggler_hedged_read", tmp_path)
