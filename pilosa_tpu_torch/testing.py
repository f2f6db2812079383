"""Multi-node cluster harnesses for tests and the card run
(``pilosa_tpu.testing``'s).

:func:`run_cluster` boots n real servers in one process (real holders and
executors, loopback HTTP between them; heartbeats cranked down so
liveness converges inside a test's time).  Every node runs its own
executor on ``device`` (``""``: the CUDA device), so n in-process nodes
share one card, each with its own plane budget.

:func:`run_process_cluster` is the OS-process variant: each node is a
``python -m pilosa_tpu_torch.cli server`` process, so node work overlaps
(no shared GIL) and :meth:`ProcessNode.kill9` is a real crash.

Placement hashes over the sorted node ids (``host:port``); ``ports``
(ascending as strings) pins them, so two clusters on equally ordered
ports place every shard on the same node position.

Several processes of one ``torch.distributed`` group
(:mod:`pilosa_tpu_torch.parallel.multiproc`): :func:`run_spmd_processes`
starts :func:`spmd_child` processes that run every ``parallel.spmd``
program over their own rows of :func:`spmd_inputs` (numpy's answers:
:func:`spmd_expect`); :func:`cluster_over_group` drives the HTTP cluster
of servers booted into one group; :func:`run_processes` runs any
``python -c`` children and collects their output.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from contextlib import contextmanager

from pilosa_tpu_torch.api.client import Client
from pilosa_tpu_torch.cli.config import Config, client_ssl_of
from pilosa_tpu_torch.server import PilosaTPUServer


class TestCluster:
    __test__ = False  # not a pytest collectable

    def __init__(self, servers: list[PilosaTPUServer]):
        self.servers = servers
        self._ssl_by_server: dict[PilosaTPUServer, object] = {}

    @property
    def clients(self) -> list[Client]:
        return [Client("127.0.0.1", s.http.address[1],
                       ssl_context=self._client_ssl(s))
                for s in self.servers]

    def _client_ssl(self, s: PilosaTPUServer):
        # one context per server: tests poll .clients in loops
        if s not in self._ssl_by_server:
            self._ssl_by_server[s] = client_ssl_of(s.cfg)
        return self._ssl_by_server[s]

    def client(self, i: int = 0) -> Client:
        return self.clients[i]

    def node_ids(self) -> list[str]:
        return [s.cluster.node_id for s in self.servers]

    def server_for(self, node_id: str) -> PilosaTPUServer:
        for s in self.servers:
            if s.cluster.node_id == node_id:
                return s
        raise KeyError(node_id)

    def await_membership(self, n: int, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(len(s.cluster.alive_ids()) == n for s in self.servers):
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"cluster did not reach {n} members: "
            f"{[s.cluster.alive_ids() for s in self.servers]}")

    def await_state(self, state: str, timeout: float = 10.0,
                    stable_for: float = 0.3) -> None:
        """Wait until every node reports ``state`` and keeps it for
        ``stable_for`` seconds: a join-triggered resize may start a beat
        after the first NORMAL reading."""
        deadline = time.monotonic() + timeout
        stable_since = None
        while time.monotonic() < deadline:
            if all(s.cluster.state == state for s in self.servers):
                if stable_since is None:
                    stable_since = time.monotonic()
                elif time.monotonic() - stable_since >= stable_for:
                    return
            else:
                stable_since = None
            time.sleep(0.05)
        raise TimeoutError(
            f"cluster states {[s.cluster.state for s in self.servers]}")

    def close(self) -> None:
        for s in self.servers:
            s.close()


def node_config(i: int, base_dir: str, seed: str | None, *,
                port: int = 0, replicas: int = 1, heartbeat: float = 0.2,
                anti_entropy: float = 0.0, mesh: bool = False,
                device: str = "", **cfg_kwargs) -> Config:
    """Node ``i``'s config in a harness cluster: data under
    ``<base_dir>/node<i>``, joining through ``seed``."""
    return Config(
        bind=f"127.0.0.1:{port}",
        data_dir=f"{base_dir}/node{i}",
        seeds=[seed] if seed else [],
        replicas=replicas,
        cluster_enabled=True,
        heartbeat_interval=heartbeat,
        anti_entropy_interval=anti_entropy,
        mesh=mesh,
        device=device,
        **cfg_kwargs,
    )


@contextmanager
def run_cluster(n: int, base_dir: str, replicas: int = 1,
                heartbeat: float = 0.2, anti_entropy: float = 0.0,
                mesh: bool = False, device: str = "",
                ports: list[int] | None = None, **cfg_kwargs):
    """Boot an n-node in-process cluster; yields a :class:`TestCluster`
    once every node is a member and NORMAL.  ``ports`` pins the nodes'
    ports (else ephemeral); extra ``cfg_kwargs`` apply to every node."""
    servers: list[PilosaTPUServer] = []
    try:
        seed_bind = None
        for i in range(n):
            cfg = node_config(i, base_dir, seed_bind,
                              port=ports[i] if ports else 0,
                              replicas=replicas, heartbeat=heartbeat,
                              anti_entropy=anti_entropy, mesh=mesh,
                              device=device, **cfg_kwargs)
            srv = PilosaTPUServer(cfg).open()
            servers.append(srv)
            if seed_bind is None:
                seed_bind = srv.cluster.node_id
        cluster = TestCluster(servers)
        cluster.await_membership(n)
        cluster.await_state("NORMAL")  # join-triggered resizes settled
        yield cluster
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


def share_cpu_threads() -> int:
    """Bound torch's intra-op threads to this process's share of the CPU
    cores when it is one of ``PYTEST_XDIST_WORKER_COUNT`` test workers
    (all cores when it runs alone); returns the count set.  Each worker
    would otherwise open an OpenMP team as wide as the machine for every
    operation, and the many small operations of the plain kernels' loops
    then spend their time in the teams' barriers."""
    import torch
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    n = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(n)
    return n


def rss_mb() -> float:
    """This process's resident set in MB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def free_ports(n: int) -> list[int]:
    """``n`` free loopback ports, ascending as ``127.0.0.1:<port>``
    strings sort (the order placement sees)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return sorted(ports, key=str)


class ProcessNode:
    """One cluster node as an OS process."""

    def __init__(self, port: int, data_dir: str, seed_port: int | None,
                 replicas: int, heartbeat: float, anti_entropy: float,
                 device: str = "", extra_env: dict[str, str] | None = None):
        self.port = port
        self.data_dir = data_dir
        self.seed_port = seed_port
        self.replicas = replicas
        self.heartbeat = heartbeat
        self.anti_entropy = anti_entropy
        self.device = device
        # e.g. PILOSA_FAULTS to arm boot-time failpoints
        self.extra_env = dict(extra_env or {})
        self.proc: subprocess.Popen | None = None
        self._log = None

    def start(self) -> "ProcessNode":
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PILOSA_")}
        env.update(
            PILOSA_CLUSTER_ENABLED="1",
            PILOSA_REPLICAS=str(self.replicas),
            PILOSA_HEARTBEAT_INTERVAL=str(self.heartbeat),
            PILOSA_ANTI_ENTROPY_INTERVAL=str(self.anti_entropy),
            PILOSA_MESH="0",
        )
        if self.seed_port is not None:
            env["PILOSA_SEEDS"] = f"127.0.0.1:{self.seed_port}"
        env.update(self.extra_env)
        self._log = open(self.data_dir + ".log", "ab")
        argv = [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
                "--bind", f"127.0.0.1:{self.port}",
                "--data-dir", self.data_dir, "--verbose"]
        if self.device:
            argv += ["--device", self.device]
        self.proc = subprocess.Popen(argv, env=env, stdout=self._log,
                                     stderr=self._log)
        return self

    def await_up(self, timeout: float = 60.0) -> "ProcessNode":
        client = Client("127.0.0.1", self.port, timeout=5.0)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"node :{self.port} exited "
                        f"rc={self.proc.returncode}")
                try:
                    client._do("GET", "/status")
                    return self
                except Exception:  # noqa: BLE001 — still booting
                    time.sleep(0.1)
        finally:
            client.close()
        raise TimeoutError(f"node :{self.port} never served /status")

    def kill9(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._log is not None:
            self._log.close()
            self._log = None


class ProcessCluster:
    __test__ = False

    def __init__(self, nodes: list[ProcessNode]):
        self.nodes = nodes
        self._clients: dict[int, Client] = {}

    def client(self, i: int = 0) -> Client:
        if i not in self._clients:
            self._clients[i] = Client("127.0.0.1", self.nodes[i].port,
                                      timeout=60.0)
        return self._clients[i]

    def await_membership(self, n: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            dead = [node for node in self.nodes
                    if node.proc.poll() is not None]
            if dead:
                raise RuntimeError(
                    "node(s) died awaiting membership: " + ", ".join(
                        f":{d.port} rc={d.proc.returncode} "
                        f"(log {d.data_dir}.log)" for d in dead))
            try:
                states = [self.client(i)._do("GET", "/status")
                          for i in range(len(self.nodes))]
                if all(s["state"] == "NORMAL"
                       and len([nd for nd in s["nodes"]
                                if nd["state"] == "NORMAL"]) == n
                       for s in states):
                    return
            except Exception:  # noqa: BLE001 — a node still joining
                pass
            time.sleep(0.1)
        raise TimeoutError(f"cluster never reached {n} NORMAL members")

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        for node in self.nodes:
            node.stop()


@contextmanager
def run_process_cluster(n: int, base_dir: str, replicas: int = 1,
                        heartbeat: float = 0.3, anti_entropy: float = 0.0,
                        device: str = "",
                        extra_env: dict[str, str] | None = None):
    """Boot an n-node cluster of OS processes; yields a
    :class:`ProcessCluster` once one round of ``/status`` reads found
    every node NORMAL with n NORMAL members.  That is membership, not a
    settled cluster: a join's resize may start a beat later, so a caller
    that needs NORMAL waits for it (as
    :meth:`~pilosa_tpu_torch.fault.chaos.ChaosHarness.await_all_normal`
    does).  ``device`` is every node's ``--device`` (``""``: the CUDA
    device); ``extra_env`` applies to every node (e.g. ``PILOSA_FAULTS``)."""
    nodes: list[ProcessNode] = []
    cluster = None
    try:
        for attempt in (0, 1):
            ports = free_ports(n)
            nodes = []
            try:
                for i, port in enumerate(ports):
                    node = ProcessNode(port, f"{base_dir}/node{i}",
                                       seed_port=ports[0] if i else None,
                                       replicas=replicas,
                                       heartbeat=heartbeat,
                                       anti_entropy=anti_entropy,
                                       device=device, extra_env=extra_env)
                    nodes.append(node.start())
                    node.await_up()
                break
            except RuntimeError:
                # another process took a probed port before the node
                # bound it: one re-roll
                for node in nodes:
                    node.stop()
                if attempt:
                    raise
        cluster = ProcessCluster(nodes)
        cluster.await_membership(n)
        yield cluster
    finally:
        if cluster is not None:
            try:
                cluster.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        else:
            for node in nodes:
                try:
                    node.stop()
                except Exception:  # noqa: BLE001
                    pass


# -- several processes in one process group (parallel.multiproc) ----------

SPMD_SHARDS = 8     # the reference's multi-host test: 2 processes x 4 rows
SPMD_BLOCKS = 4     # local blocks per process of the spmd children


def spmd_inputs(seed: int = 0, width: int = 256) -> dict:
    """The seeded host arrays of a spmd run, ``SPMD_SHARDS`` shards of
    ``width`` words, drawn alike in every process: ``a`` and ``b`` as the
    reference's multi-host test draws them, a 16-row plane (~25% dense,
    rows 3 and 4 tied) and a filter, a 3-bit BSI plane (exists, sign and
    magnitudes within exists) and per-shard ``(word_idx, mask)``
    updates (indices ``>= width`` pad)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s, u32 = SPMD_SHARDS, np.uint32
    a = rng.integers(0, 1 << 32, size=(s, width), dtype=u32)
    b = rng.integers(0, 1 << 32, size=(s, width), dtype=u32)
    plane = (rng.integers(0, 1 << 32, size=(s, 16, width), dtype=u32)
             & rng.integers(0, 1 << 32, size=(s, 16, width), dtype=u32))
    plane[:, 3] = plane[:, 4]
    filt = rng.integers(0, 1 << 32, size=(s, width), dtype=u32)
    bsi = rng.integers(0, 1 << 32, size=(s, 5, width), dtype=u32)
    bsi[:, 1:] &= bsi[:, :1]
    idx = np.full((s, 16), width, np.int64)
    mask = np.zeros((s, 16), u32)
    for i in range(s):
        k = int(rng.integers(1, 16))
        idx[i, :k] = np.sort(rng.choice(width, k, replace=False))
        mask[i, :k] = rng.integers(1, 1 << 32, size=k, dtype=u32)
    return {"a": a, "b": b, "plane": plane, "filt": filt, "bsi": bsi,
            "idx": idx, "mask": mask}


def spmd_answers(place, place2, rows: dict) -> dict:
    """Every program of ``parallel.spmd`` over ``place`` (the ``*2d`` ones
    over ``place2``) on ``rows`` (this process's rows of
    :func:`spmd_inputs`), as JSON values: counts as ints, TopNs as
    ``[values, slots]``, per-shard BSI counts and the ingest step's words
    (read back whole) as nested lists."""
    from pilosa_tpu_torch.parallel import spmd

    def ints(t):
        return t.cpu().tolist()

    a, b = place.place(rows["a"]), place.place(rows["b"])
    plane, filt = place.place(rows["plane"]), place.place(rows["filt"])
    bsi = place.place(rows["bsi"])
    words = spmd.make_ingest_step(place)(rows["a"], rows["idx"],
                                         rows["mask"])
    return {
        "intersect_count": int(spmd.intersect_count(a, b)),
        "union_count": int(spmd.union_count(a, b)),
        "intersect_psum": int(spmd.make_intersect_count_psum(place)(a, b)),
        "topn": [ints(x) for x in spmd.topn(plane, filt, 5)],
        "topn_psum": [ints(x) for x in
                      spmd.make_topn_psum(place, n=5)(plane, filt)],
        "bsi_bit_counts": [ints(x) for x in spmd.bsi_bit_counts(bsi, filt)],
        "bsi_sum_psum": [ints(x) for x in
                         spmd.make_bsi_sum_psum(place)(bsi, filt)],
        "intersect_psum2d": int(spmd.make_intersect_count_psum2d(place2)(
            rows["a"], rows["b"])),
        "topn_psum2d": [ints(x) for x in spmd.make_topn_psum2d(
            place2, n=5)(rows["plane"], rows["filt"])],
        "ingest": ints(words.full()),
        "ingest_count": int(spmd.intersect_count(words, words)),
    }


def spmd_expect(inputs: dict) -> dict:
    """:func:`spmd_answers` over all of ``inputs`` by numpy alone."""
    import numpy as np

    def pc(x, axis=-1):
        return np.unpackbits(np.ascontiguousarray(x).view(np.uint8),
                             axis=-1).sum(axis=axis, dtype=np.int64)

    def top(counts):
        order = np.argsort(-counts, kind="stable")[:5]
        return [[int(counts[r]) for r in order], [int(r) for r in order]]

    a, b, plane, filt = (inputs[k] for k in ("a", "b", "plane", "filt"))
    bsi, idx, mask = inputs["bsi"], inputs["idx"], inputs["mask"]
    words = a.copy()
    for s in range(len(a)):
        live = idx[s] < a.shape[1]
        np.bitwise_or.at(words[s], idx[s][live], mask[s][live])
    inter = int(pc(a & b).sum())
    rows = pc(plane & filt[:, None, :]).sum(0)
    exists = bsi[:, 0] & filt
    neg, nonneg = exists & bsi[:, 1], exists & ~bsi[:, 1]
    pos_c, neg_c = (pc(bsi[:, 2:] & m[:, None, :]) for m in (nonneg, neg))
    cnt = pc(exists)
    return {
        "intersect_count": inter, "union_count": int(pc(a | b).sum()),
        "intersect_psum": inter, "topn": top(rows), "topn_psum": top(rows),
        "bsi_bit_counts": [pos_c.tolist(), neg_c.tolist(), cnt.tolist()],
        "bsi_sum_psum": [pos_c.sum(0).tolist(), neg_c.sum(0).tolist(),
                         int(cnt.sum())],
        "intersect_psum2d": inter, "topn_psum2d": top(rows),
        "ingest": words.view(np.int32).tolist(),
        "ingest_count": int(pc(words).sum()),
    }


def spmd_child() -> None:
    """A spmd process (``argv[1]``: JSON of ``coord``, ``size``,
    ``rank``, ``device``, ``seed``, ``width``): joins the group, places
    its rows of :func:`spmd_inputs` over ``SPMD_BLOCKS`` local blocks
    (on the visible cards in turn, or the CPU) and a 2x2 placement of
    the same devices, and prints ``SPMD <answers JSON>``."""
    import json

    from pilosa_tpu_torch.parallel import (MeshPlacement, MeshPlacement2D,
                                           multiproc)
    args = json.loads(sys.argv[1])
    share_cpu_threads()
    group = multiproc.join(args["coord"], args["size"], args["rank"],
                           device=args["device"])
    try:
        if args["device"] == "cpu":
            devs = ["cpu"] * SPMD_BLOCKS
        else:
            import torch
            n = torch.cuda.device_count()
            devs = [f"cuda:{i % n}" for i in range(SPMD_BLOCKS)]
        place = multiproc.ProcessPlacement(MeshPlacement(devs), group)
        place2 = multiproc.ProcessPlacement(MeshPlacement2D(devs, 2, 2),
                                            group)
        per = SPMD_SHARDS // group.size
        lo = group.rank * per
        rows = {k: v[lo:lo + per] for k, v in
                spmd_inputs(args["seed"], args["width"]).items()}
        print("SPMD " + json.dumps(spmd_answers(place, place2, rows)),
              flush=True)
    finally:
        group.leave()


def run_processes(script: str, argv: list[list[str]], timeout: float,
                  env: list[dict] | None = None) -> list[tuple[str, str]]:
    """Start ``python -c script`` once per entry of ``argv`` (each with
    its ``env`` entry over this environment), wait for all of them and
    return their ``(stdout, stderr)``; raises naming any that failed or
    outlived ``timeout`` seconds (all are killed by then).  Output goes
    to files, not pipes: a child blocked on a full pipe while its peers
    wait on it in a collective would never finish."""
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, files = [], []
    try:
        for i, args in enumerate(argv):
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, *args], cwd=root,
                env={**os.environ, "PYTHONPATH": root,
                     **(env[i] if env else {})},
                stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        killed = set()
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                killed.add(i)
        outs, failed = [], []
        for i, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            if p.returncode:
                why = "timed out" if i in killed else f"rc={p.returncode}"
                failed.append(f"{why}\n{outs[-1][0][-4000:]}\n"
                              f"{outs[-1][1][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    if failed:
        raise RuntimeError("process(es) failed:\n" + "\n---\n".join(failed))
    return outs


def run_spmd_processes(n: int, device: str = "cpu", seed: int = 0,
                       width: int = 256, timeout: float = 240.0,
                       cards: list[list[int]] | None = None) -> list[dict]:
    """``n`` :func:`spmd_child` processes in one group on ``device``
    (``cards[p]``: process ``p``'s ``CUDA_VISIBLE_DEVICES``); each one's
    answers, in rank order."""
    import json
    coord = f"127.0.0.1:{free_ports(1)[0]}"
    argv = [[json.dumps({"coord": coord, "size": n, "rank": p,
                         "device": device, "seed": seed, "width": width})]
            for p in range(n)]
    env = ([{"CUDA_VISIBLE_DEVICES": ",".join(map(str, c))} for c in cards]
           if cards else None)
    outs = run_processes(
        "from pilosa_tpu_torch.testing import spmd_child; spmd_child()",
        argv, timeout, env)
    return [json.loads(next(line for line in out.splitlines()
                            if line.startswith("SPMD "))[5:])
            for out, _ in outs]


def cluster_over_group(srv: PilosaTPUServer, n: int, barrier_dir: str,
                       timeout: float = 60.0) -> list:
    """The HTTP cluster on top of a process group (``srv`` booted with
    the coordinator keys and ``cluster_enabled``; ``srv.group`` its
    rank): membership converges to ``n`` NORMAL nodes; rank 0 creates
    index ``mi`` and sets ``f`` row 1 in four shards, routed by shard
    to their owners; ``Count(Row(f=1))`` through this node until it
    answers ``[4]``; then this process waits at a file barrier under
    ``barrier_dir`` until every rank got there (its server must serve
    until the peers' reads are done).  Returns the count's results."""
    me = Client("127.0.0.1", srv.port)
    try:
        return _cluster_reads(me, srv.group.rank, n, barrier_dir, timeout)
    finally:
        me.close()


def _cluster_reads(me: Client, rank: int, n: int, barrier_dir: str,
                   timeout: float) -> list:
    from pilosa_tpu_torch.engine.words import SHARD_WIDTH
    deadline = time.monotonic() + timeout
    nodes: list = []
    while time.monotonic() < deadline:
        nodes = me.status()["nodes"]
        if len([x for x in nodes if x["state"] == "NORMAL"]) == n:
            break
        time.sleep(0.1)
    else:
        raise TimeoutError(f"membership never converged: {nodes}")
    cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 3 * SHARD_WIDTH + 4]
    if rank == 0:
        me.create_index("mi")
        me.create_field("mi", "f")
        me.query("mi", "".join(f"Set({c}, f=1)" for c in cols))
    got, last_err = None, None
    while time.monotonic() < deadline:
        try:
            got = me.query("mi", "Count(Row(f=1))")
            if got == [len(cols)]:
                break
        except Exception as e:  # noqa: BLE001 — the schema not here yet
            last_err = e
        time.sleep(0.2)
    if got != [len(cols)]:
        raise AssertionError(f"Count(Row(f=1)) through rank {rank}: {got} "
                             f"({last_err!r})")
    open(os.path.join(barrier_dir, f"done-{rank}"), "w").close()
    end = time.monotonic() + 2 * timeout
    while not all(os.path.exists(os.path.join(barrier_dir, f"done-{p}"))
                  for p in range(n)):
        if time.monotonic() > end:
            raise TimeoutError("a peer never reached the exit barrier")
        time.sleep(0.1)
    return got
