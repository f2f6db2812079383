"""Composition root: the metrics registry (with ``stats_backend =
"statsd"`` also a UDP sink), holder, executor, API, the REST server (HTTPS
with a tls block), with ``grpc_bind`` the gRPC server, the background
scrubber and the diagnostics reporter, opened and closed in
``pilosa_tpu.server``'s order from one :class:`~pilosa_tpu_torch.cli.
config.Config`.  The disk governor is configured before the holder opens,
so a corrupt snapshot found at boot is counted in the same registry.

With ``seeds``, ``replicas`` > 1 or ``cluster_enabled`` the server is a
cluster node: a :class:`~pilosa_tpu_torch.cluster.Cluster` attaches to
the API after the REST server binds (its node id is the bound
``host:port``), joins through the seeds once the server serves, and is
closed before the server; the scrubber hands a corrupt fragment to
``cluster.repair_quarantined``.  Every node runs its own executor on the
card, with its own plane budget (``plane_budget_bytes``), device-health
governor and device-OOM recovery.  With ``mesh`` on (the default) and
several CUDA devices, the executor shards its planes over all of them
(:func:`~pilosa_tpu_torch.parallel.local_placement`) and the boot logs
``mesh: sharding over N devices``.  With ``jax_coordinator`` set the
process first joins a ``torch.distributed`` process group
(:func:`~pilosa_tpu_torch.parallel.multiproc.join`: NCCL on a card, gloo
with ``device = "cpu"``), as the reference joins its multi-process JAX
runtime, and logs ``torch.distributed: process p of n (backend)``;
:attr:`PilosaTPUServer.group` is then the group the ``parallel.spmd``
programs reduce over, and :meth:`close` leaves it last.
:func:`~pilosa_tpu_torch.cli.config.check_served` refuses what the port
does not serve (``mesh = true`` beside a coordinator among it) before
anything opens.

Also a thin entry point over the same config::

    python -m pilosa_tpu_torch.server --data-dir D --bind H:P [--device cpu]
        [--query-timeout SECONDS] [--fsync]

Without ``--device`` the server runs on the CUDA device and refuses to
start when there is none.  ``--query-timeout`` caps every query's
``?timeout=`` (0, the default: no cap).  ``--fsync`` makes every
acknowledged write durable: each import batch fsyncs every op-log it
touched once before it answers.  ``python -m pilosa_tpu_torch.cli
server`` takes the whole config.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

import torch

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.api import API, Server as HttpServer
from pilosa_tpu_torch.api import tls as tlsmod
from pilosa_tpu_torch.cli import config as cfgmod
from pilosa_tpu_torch.cli.config import Config
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.obs import Stats, StatsdStats, get_logger
from pilosa_tpu_torch.obs.diagnostics import Diagnostics
from pilosa_tpu_torch.parallel import local_placement
from pilosa_tpu_torch.store import Holder, syswrap
from pilosa_tpu_torch.store.scrub import Scrubber


class PilosaTPUServer:
    def __init__(self, cfg: Config, placement=None):
        """``placement``: a mesh placement to serve over (one on the CPU
        is built by the caller); None builds ``local_placement()`` when
        ``mesh`` is on and ``device`` is the CUDA default, which shards
        over every CUDA device when there are several."""
        cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cfgmod.check_served(cfg, cuda_devices=cuda)
        self.cfg = cfg
        self.logger = get_logger("pilosa_tpu_torch", verbose=cfg.verbose,
                                 fmt=cfg.log_format or None)
        if cfg.stats_backend == "statsd":
            # the in-process registry stays authoritative (/metrics);
            # every observation also goes out as a statsd packet
            host, _, port = cfg.statsd_address.rpartition(":")
            self.stats = StatsdStats(host or "127.0.0.1", int(port or 8125))
            self.logger.info("stats: statsd emission to %s",
                             cfg.statsd_address)
        elif cfg.stats_backend not in ("", "prometheus"):
            raise ValueError(
                f"unknown stats_backend {cfg.stats_backend!r} "
                "(expected '', 'prometheus' or 'statsd')")
        else:
            self.stats = Stats()
        self.holder = Holder(cfg.data_dir, fsync=cfg.fsync)
        self.placement = placement
        self.executor: Executor | None = None
        self.api: API | None = None
        self.http: HttpServer | None = None
        self.grpc = None
        self.cluster = None
        self.scrubber: Scrubber | None = None
        self.diagnostics: Diagnostics | None = None
        self.group = None   # parallel.multiproc.Group with a coordinator

    def open(self) -> "PilosaTPUServer":
        cfg = self.cfg
        if cfg.faults:
            # armed before anything opens, so boot-time seams fire too
            fault.configure(cfg.faults)
        if cfg.jax_coordinator:
            # before any device use, as the reference joins its runtime
            from pilosa_tpu_torch.parallel import multiproc
            self.group = multiproc.join(
                cfg.jax_coordinator, cfg.jax_num_processes,
                cfg.jax_process_id, device=cfg.device or None)
            self.logger.info("torch.distributed: process %d of %d (%s)",
                             self.group.rank, self.group.size,
                             self.group.backend)
        syswrap.GLOBAL.set_max(cfg.max_map_count)
        self.holder.storage_health.configure(
            base=cfg.data_dir, stats=self.stats, logger=self.logger,
            min_free_bytes=cfg.disk_min_free_bytes,
            probe_seconds=cfg.disk_probe_seconds)
        self.holder.open()
        placement = self.placement
        if placement is None and cfg.mesh and not cfg.device:
            placement = local_placement()
        if placement is not None:
            self.logger.info("mesh: sharding over %d devices",
                             placement.n_devices * placement.words_size)
        self.executor = Executor(
            self.holder, device=cfg.device or None, placement=placement,
            plane_budget=cfg.plane_budget_bytes,
            count_batch_window=cfg.count_batch_window,
            max_concurrent=cfg.max_concurrent_queries,
            plane_sidecars=cfg.plane_sidecars,
            delta_cells=cfg.delta_buffer_cells,
            delta_compact_fraction=cfg.delta_compact_fraction,
            tree_fusion=cfg.tree_fusion,
            dispatch_pipeline_depth=cfg.dispatch_pipeline_depth,
            solo_fastlane=cfg.solo_fastlane,
            dispatch_watchdog_seconds=cfg.dispatch_watchdog_seconds,
            device_health_probe_seconds=cfg.device_health_probe_seconds,
            plane_paging=cfg.plane_paging,
            plane_page_bytes=cfg.plane_page_bytes,
            tenant_byte_quota=cfg.tenant_byte_quota,
            tenant_qps_quota=cfg.tenant_qps_quota,
            tenant_slot_quota=cfg.tenant_slot_quota,
            stats=self.stats)
        self.api = API(self.holder, self.executor,
                       query_timeout=cfg.query_timeout,
                       trace_sample_rate=cfg.trace_sample_rate,
                       slow_query_threshold=cfg.slow_query_threshold)
        tls_cfg = cfgmod.tls_of(cfg)
        ssl_ctx = tlsmod.server_context(tls_cfg)
        if ssl_ctx is not None:
            self.logger.info("tls: serving HTTPS%s",
                             " with required client certs"
                             if tls_cfg.enable_client_auth else "")
        # bound before the cluster needs its advertised address (a port
        # of 0 resolves here), served after the cluster attaches
        self.http = HttpServer(self.api, cfg.host, cfg.port,
                               ssl_context=ssl_ctx, stats=self.stats)
        if cfg.seeds or cfg.replicas > 1 or cfg.cluster_enabled:
            from pilosa_tpu_torch.cluster import Cluster
            self.cluster = Cluster(cfg, self.api, stats=self.stats,
                                   logger=self.logger,
                                   port=self.http.address[1])
            self.api.cluster = self.cluster
        self.http.start()
        if cfg.grpc_bind:
            from pilosa_tpu_torch.api.grpc import GrpcServer
            ghost, _, gport = cfg.grpc_bind.rpartition(":")
            self.grpc = GrpcServer(
                self.api, ghost or "127.0.0.1", int(gport),
                credentials=tlsmod.grpc_server_credentials(tls_cfg),
            ).start()
            self.logger.info("grpc: listening on %s:%d",
                             ghost or "127.0.0.1", self.grpc.port)
        if self.cluster is not None:
            self.cluster.open()
        # re-verifies every on-disk checksum at the configured byte rate
        # (0 bytes/s: no thread); a corrupt fragment quarantines
        self.scrubber = Scrubber(
            self.holder, interval=cfg.scrub_interval_seconds,
            bytes_per_second=cfg.scrub_bytes_per_second, stats=self.stats,
            logger=self.logger,
            on_corrupt=(self.cluster.repair_quarantined
                        if self.cluster is not None else None)).start()
        self.api.scrubber = self.scrubber
        self.diagnostics = Diagnostics(
            self.holder, interval=cfg.diagnostics_interval,
            logger=self.logger, stats=self.stats,
            slow_log=self.api.slow_log, executor=self.executor,
            cluster=self.cluster).start()
        return self

    def close(self) -> None:
        if self.diagnostics is not None:
            self.diagnostics.close()
        if self.scrubber is not None:
            self.scrubber.close()
        if self.cluster is not None:
            self.cluster.close()
        if self.grpc is not None:
            self.grpc.close()
        if self.http is not None:
            self.http.close()
        if self.executor is not None:
            self.executor.close()
        self.holder.close()
        if isinstance(self.stats, StatsdStats):
            self.stats.close()
        if self.group is not None:
            self.group.leave()
            self.group = None

    @property
    def port(self) -> int:
        return self.http.address[1]

    @property
    def device(self) -> str:
        """The serving device and, on a card, its name."""
        dev = self.executor.device
        if dev.type == "cuda":
            return f"{dev} ({torch.cuda.get_device_name(dev)})"
        return str(dev)


def serve_until_signalled(srv: PilosaTPUServer) -> None:
    """Serve until SIGINT or SIGTERM, then close the server."""
    stop: list = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            signal.pause()
    finally:
        srv.logger.info("shutting down")
        srv.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch.server")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--bind", default="127.0.0.1:10101")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    p.add_argument("--query-timeout", type=float, default=None,
                   help="cap on a query's timeout in seconds (0: none)")
    p.add_argument("--fsync", action="store_true", default=None,
                   help="fsync op-log appends (once per import batch)")
    args = p.parse_args(argv)
    cfg = cfgmod.load(overrides={
        "data_dir": args.data_dir, "bind": args.bind, "device": args.device,
        "query_timeout": args.query_timeout, "fsync": args.fsync})
    srv = PilosaTPUServer(cfg).open()
    host, port = srv.http.address
    print(f"pilosa_tpu_torch serving {cfg.data_dir} on {host}:{port} "
          f"({srv.executor.device})", flush=True)
    srv.logger.debug("effective config: %s", json.dumps(cfg.effective()))
    serve_until_signalled(srv)


if __name__ == "__main__":
    main(sys.argv[1:])
