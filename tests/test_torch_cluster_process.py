"""A port cluster of three OS processes (``python -m pilosa_tpu_torch.cli
server`` with ``PILOSA_SEEDS`` / ``PILOSA_REPLICAS=2`` /
``PILOSA_CLUSTER_ENABLED``, on the CPU): a node booted from that config
joins, and reads keep answering exactly, with no failed read, while a
replica is killed with SIGKILL mid-stream; a write to the dead replica's
shard is hinted."""

import threading
import time

import numpy as np

from pilosa_tpu_torch.testing import run_process_cluster

SW = 1 << 20


def test_kill9_of_a_replica_fails_no_read(tmp_path):
    rng = np.random.default_rng(9)
    cols = np.concatenate([s * SW + rng.choice(5000, 60, replace=False)
                           for s in range(6)])
    rows = rng.integers(1, 4, len(cols))
    want = int((rows == 1).sum())
    with run_process_cluster(3, str(tmp_path), replicas=2, heartbeat=0.2,
                             device="cpu") as pc:
        cl = pc.client(0)
        st = cl.status()
        assert st["state"] == "NORMAL" and len(st["nodes"]) == 3
        cl.create_index("i")
        cl.create_field("i", "f")
        cl.import_bits("i", "f", rowIDs=rows.tolist(),
                       columnIDs=cols.tolist())
        assert cl.query("i", "Count(Row(f=1))") == [want]
        answers, failures = [], []
        stop = threading.Event()

        def reader():
            c = pc.client(1)
            while not stop.is_set():
                try:
                    answers.append(c.query("i", "Count(Row(f=1))")[0])
                except Exception as e:  # noqa: BLE001 — counted
                    failures.append(repr(e))

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        time.sleep(0.5)
        n_before = len(answers)
        pc.nodes[2].kill9()
        time.sleep(2.0)  # through the suspect horizon (3 heartbeats)
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        assert failures == []
        assert len(answers) > n_before > 0
        assert set(answers) == {want}
        # a write owned by the dead replica is applied live and hinted
        dead = f"127.0.0.1:{pc.nodes[2].port}"
        assert pc.client(0).query("i", "Set(3, f=1)") == [True]
        for s in range(6):
            assert cl.query("i", f"Set({s * SW + 7777}, f=2)") == [True]
        wh = cl.write_health()
        assert wh["hintedHandoff"] is True
        assert {p["id"] for p in wh["peers"]} <= {dead}
        assert cl.query("i", "Count(Row(f=2))") == [
            int((rows == 2).sum()) + 6]
