"""The port's 1- and 2-node chaos scenarios, each on its own process
cluster on the CPU, booted by ``chaos.run_scenario`` as ``main`` and the
card's smoke run boot it:

- crash mid-oplog-append (1 node): a torn op-log tail and a SIGKILL,
  then replay recovers the clean prefix;
- hung dispatch serving (1 node, a 0.4 s watchdog): other queries stay
  exact, the wedged caller gets a structured 504/500 naming the stage,
  the governor probes back, no pipeline thread leaks;
- flaky device governor (1 node): the governor degrades under
  consecutive dispatch faults and probes back; at most one 500 naming
  the fault per injected fault (the port raises where the reference
  falls back), every other answer exact;
- corrupt fragment scrub repair (2 nodes, a 0.4 s scrubber): detection,
  reads exact through replica failover, repair from the replica, no
  divergence left for AAE;
- disk full during ingest (2 nodes): ENOSPC turns the node read-only
  with 507s while imports ack through hints; freed space restores it and
  the drain lands exact.

Also the ``main`` runbook with ``--device cpu``.
"""

import os

from pilosa_tpu_torch.fault import chaos
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SEED = int(os.environ.get("PILOSA_CHAOS_SEED", "42"))


def _run(name, tmp_path):
    # the cluster that ``main`` and the card's phase 17 boot
    chaos.run_scenario(name, SEED, str(tmp_path), device="cpu")


def test_crash_mid_oplog_append(tmp_path):
    _run("crash_mid_oplog_append", tmp_path)


def test_hung_dispatch_serving(tmp_path):
    _run("hung_dispatch_serving", tmp_path)


def test_flaky_device_governor(tmp_path):
    _run("flaky_device_governor", tmp_path)


def test_corrupt_fragment_scrub_repair(tmp_path):
    _run("corrupt_fragment_scrub_repair", tmp_path)


def test_disk_full_during_ingest(tmp_path):
    _run("disk_full_during_ingest", tmp_path)


def test_main_runs_a_scenario_on_the_cpu(capsys):
    assert chaos.main(["--device", "cpu", "--scenario",
                       "flaky_device_governor", "--seed", "7"]) == 0
    assert "[chaos] flaky_device_governor: OK (seed=7)" \
        in capsys.readouterr().out
