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
    :class:`ProcessCluster` once every member is NORMAL.  ``extra_env``
    applies to every node (e.g. ``PILOSA_FAULTS``)."""
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
