"""The port's chaos harness (``pilosa_tpu_torch.fault.chaos``) on one
shared 3-node process cluster on the CPU (``replicas = 2``, a 1 s
anti-entropy sweep), as the reference's ``tests/test_chaos.py`` runs its
trio: each scenario writes its own index and clears its faults, so the
boot is paid once.

- partition during resize: no acked write lost, AAE re-converges;
- duplicate delivery: dropped internal responses are redelivered, bits
  never double-count, replicas converge;
- dropped placement broadcast: the heartbeat's placement version pulls
  every node onto the new placement;
- dropped internal response: the redelivered fan-out leg carries a
  ``retried`` tag in the profile tree;
- breaker lifecycle: open, half_open and closed through a partition and
  its heal.

The kill-and-restart scenarios are in ``tests/test_torch_chaos_kill.py``,
the 1- and 2-node ones in ``tests/test_torch_chaos_small.py``.  Every
schedule reproduces from the printed seed (``PILOSA_CHAOS_SEED``).
"""

import os

import pytest

from pilosa_tpu_torch.fault import chaos
from pilosa_tpu_torch.testing import run_process_cluster
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

SEED = int(os.environ.get("PILOSA_CHAOS_SEED", "42"))


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    base = tmp_path_factory.mktemp("chaos_trio")
    with run_process_cluster(3, str(base), replicas=2, anti_entropy=1.0,
                             device="cpu") as cluster:
        yield cluster


def test_partition_during_resize(trio):
    chaos.scenario_partition_during_resize(trio, SEED)


def test_duplicate_delivery_on_internal_posts(trio):
    chaos.scenario_duplicate_delivery(trio, SEED)


def test_dropped_placement_broadcast(trio):
    chaos.scenario_dropped_placement_broadcast(trio, SEED)


def test_dropped_internal_response_trace(trio):
    chaos.scenario_dropped_internal_response_trace(trio, SEED)


def test_breaker_lifecycle(trio):
    chaos.scenario_breaker_lifecycle(trio, SEED)
