"""Layered configuration: TOML file ⊕ ``PILOSA_*`` env vars ⊕ CLI flags
(``pilosa_tpu.cli.config``'s).

Flags override env, env overrides the file, the file overrides the
defaults.  :class:`Config` has the reference's keys in the reference's
order, then the one key the port adds, ``device`` (``--device``,
``PILOSA_DEVICE``): the torch device to serve on, ``""`` meaning the CUDA
device (with no card the server refuses to start).  An unknown key in the
file is an error, as in the reference.

What the port does with each key (:func:`check_served` applies it when a
server boots):

========================================  ==================================
key                                       verdict
========================================  ==================================
bind, data_dir, verbose, log_format,      served
fsync, faults, query_timeout, grpc_bind,
tls_*, count_batch_window,
plane_budget_bytes, delta_buffer_cells,
delta_compact_fraction, tree_fusion,
dispatch_pipeline_depth, solo_fastlane,
dispatch_watchdog_seconds,
device_health_probe_seconds,
plane_paging, plane_page_bytes,
tenant_byte_quota, tenant_qps_quota,
tenant_slot_quota, plane_sidecars,
max_concurrent_queries, max_map_count,
stats_backend, statsd_address,
diagnostics_interval,
trace_sample_rate, slow_query_threshold,
scrub_interval_seconds,
scrub_bytes_per_second,
disk_min_free_bytes, disk_probe_seconds,
device, name, seeds, replicas,
cluster_enabled, anti_entropy_interval,
heartbeat_interval, failover_max_depth,
hedge_after, breaker_threshold,
hint_max_age, hint_replay_batch
mesh                                      served: true shards the planes
                                          over every CUDA device when
                                          there are several
                                          (``parallel.local_placement``);
                                          one device serves unmeshed
jax_coordinator, jax_num_processes,       served: the process joins a
jax_process_id                            ``torch.distributed`` group
                                          (``parallel.multiproc.join``:
                                          NCCL on a card, gloo with
                                          ``device = "cpu"``); 0 and -1
                                          read torchrun's ``WORLD_SIZE``
                                          and ``RANK``; refused together
                                          with ``mesh = true``
kernel_tier ("xla"),                      refused unless at the default
dispatch_loop_fusion, fused_warmup,       (ROADMAP: not to port): they
compilation_cache_dir                     steer XLA's compilation and
                                          dispatch, and the port compiles
                                          no XLA program: its kernels are
                                          the hand-written ones
========================================  ==================================

Every default is the reference's (:data:`CHANGED_DEFAULTS` is empty).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field as dc_field

ENV_PREFIX = "PILOSA_"


@dataclass
class Config:
    bind: str = "127.0.0.1:10101"
    data_dir: str = "~/.pilosa_tpu"
    verbose: bool = False
    log_format: str = "text"
    fsync: bool = False
    # cluster (served: membership, placement, replication)
    name: str = ""
    seeds: list[str] = dc_field(default_factory=list)
    replicas: int = 1
    cluster_enabled: bool = False
    anti_entropy_interval: float = 600.0
    heartbeat_interval: float = 2.0
    failover_max_depth: int = 2
    hedge_after: float = 0.0
    breaker_threshold: int = 3
    hint_max_age: float = 300.0
    hint_replay_batch: int = 256
    diagnostics_interval: float = 0.0   # opt-in usage snapshot; 0 = off
    # observability: "" = the in-process registry behind /metrics;
    # "statsd" also emits every observation as a UDP packet
    stats_backend: str = ""
    statsd_address: str = "127.0.0.1:8125"
    # the fraction of queries whose traces are kept without ?profile
    trace_sample_rate: float = 0.01
    # seconds; slower queries land in /debug/slow (0 disables)
    slow_query_threshold: float = 1.0
    # fault injection: a JSON list of failpoint specs armed at boot
    faults: str = ""
    # serving
    count_batch_window: str = "adaptive"
    query_timeout: float = 0.0         # seconds per query; 0 = unlimited
    plane_budget_bytes: int = 4 << 30
    delta_buffer_cells: int = 65536
    delta_compact_fraction: float = 0.5
    tree_fusion: bool = True
    dispatch_pipeline_depth: int = 2
    solo_fastlane: bool = True
    dispatch_watchdog_seconds: float = 30.0
    device_health_probe_seconds: float = 5.0
    kernel_tier: str = "xla"
    dispatch_loop_fusion: bool = False
    fused_warmup: bool = False
    # storage integrity: the background scrubber (0 bytes/s: off) and the
    # disk governor's free-space floor and probe period
    scrub_interval_seconds: float = 600.0
    scrub_bytes_per_second: int = 32 << 20
    disk_min_free_bytes: int = 64 << 20
    disk_probe_seconds: float = 5.0
    # tenancy
    plane_paging: bool = True
    plane_page_bytes: int = 64 << 20
    tenant_byte_quota: int = 0
    tenant_qps_quota: float = 0.0
    tenant_slot_quota: int = 0
    plane_sidecars: bool = True
    compilation_cache_dir: str = ""
    max_concurrent_queries: int = 8
    max_map_count: int = 32768          # live snapshot maps (also bounded
                                        # by half the descriptor limit)
    grpc_bind: str = ""                 # host:port; "" disables gRPC
    mesh: bool = True
    # tls: one block turns on HTTPS and gRPC TLS together
    tls_certificate: str = ""           # PEM cert path; "" = plaintext
    tls_key: str = ""                   # PEM private key path
    tls_ca_certificate: str = ""        # CA bundle for verifying peers
    tls_skip_verify: bool = False       # outbound: skip server-cert check
    tls_enable_client_auth: bool = False  # inbound: require client certs
    jax_coordinator: str = ""
    jax_num_processes: int = 0
    jax_process_id: int = -1
    # the port's one added key: the torch device ("" = the CUDA device)
    device: str = ""

    @property
    def host(self) -> str:
        return self.bind.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        return int(self.bind.rsplit(":", 1)[1])

    def effective(self) -> dict:
        return dataclasses.asdict(self)


# the defaults that differ from the reference's: key -> (reference's,
# port's); none do
CHANGED_DEFAULTS: dict = {}

_XLA = ("ROADMAP: not to port (an XLA compilation or dispatch knob; the "
        "port compiles no XLA program, its kernels are the hand-written "
        "ones)")

# refused keys: set to anything but the default, the server refuses to
# boot, naming the key and the roadmap item that would serve it
REFUSED = dict.fromkeys(("kernel_tier", "dispatch_loop_fusion",
                         "fused_warmup", "compilation_cache_dir"), _XLA)


def check_served(cfg: Config, cuda_devices: int = 1) -> None:
    """Refuse a config that asks for what the port does not serve:
    ``ValueError`` naming the first such key.  ``cuda_devices`` is the
    number of CUDA devices the server would see; every count is served
    (``mesh`` shards over several).  The XLA knobs refuse, and so does
    ``mesh = true`` beside a coordinator: the reference boots that pair
    over a mesh spanning every process, and then a query through one
    process waits on peers that never enter its program and fails after
    30 s; the port asks for ``mesh = false`` instead (each process serves
    on its own device; ``parallel.multiproc`` reduces across them)."""
    defaults = Config()
    for key, item in REFUSED.items():
        value = getattr(cfg, key)
        if value == getattr(defaults, key):
            continue
        raise ValueError(f"config key {key} = {value!r} is not supported "
                         f"by this port ({item})")
    if cfg.mesh and cfg.jax_coordinator:
        raise ValueError(
            f"config keys mesh = true and jax_coordinator = "
            f"{cfg.jax_coordinator!r} together are not supported by this "
            "port: a query through one process would wait on peers that "
            "never run it; set mesh = false")


_BOOL_TRUE = {"1", "true", "yes", "on"}


def _coerce(value: str, typ):
    if typ is bool:
        return value.lower() in _BOOL_TRUE
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ == list[str]:
        return [s.strip() for s in value.split(",") if s.strip()]
    return value


def load(path: str | None = None, env: dict | None = None,
         overrides: dict | None = None) -> Config:
    """defaults ← TOML file ← PILOSA_* env ← explicit overrides."""
    cfg = Config()
    fields = {f.name: f.type for f in dataclasses.fields(Config)}

    if path:
        import tomllib
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for k, v in data.items():
            k = k.replace("-", "_")
            if k == "tls" and isinstance(v, dict):
                # [tls] table: certificate = "...", key = "...", ...
                for tk, tv in v.items():
                    tk = "tls_" + tk.replace("-", "_")
                    if tk not in fields:
                        raise ValueError(
                            f"unknown [tls] key {tk[4:]!r} in {path}")
                    setattr(cfg, tk, tv)
                continue
            if k not in fields:
                raise ValueError(f"unknown config key {k!r} in {path}")
            setattr(cfg, k, v)

    env = env if env is not None else os.environ
    for k in fields:
        ev = env.get(ENV_PREFIX + k.upper())
        if ev is not None:
            setattr(cfg, k, _coerce(ev, _resolve_type(fields[k])))

    for k, v in (overrides or {}).items():
        if v is not None:
            setattr(cfg, k, v)

    cfg.data_dir = os.path.expanduser(cfg.data_dir)
    for k in ("tls_certificate", "tls_key", "tls_ca_certificate"):
        v = getattr(cfg, k)
        if v:
            setattr(cfg, k, os.path.expanduser(v))
    if not cfg.name:
        cfg.name = cfg.bind
    return cfg


def tls_of(cfg: Config):
    """The resolved tls block as a :class:`pilosa_tpu_torch.api.tls.
    TLSConfig`."""
    from pilosa_tpu_torch.api.tls import TLSConfig
    return TLSConfig(
        certificate=cfg.tls_certificate, key=cfg.tls_key,
        ca_certificate=cfg.tls_ca_certificate,
        skip_verify=cfg.tls_skip_verify,
        enable_client_auth=cfg.tls_enable_client_auth)


def client_ssl_of(cfg: Config):
    """Outbound TLS context for this config (the CLI's client), or None
    when the tls block is off."""
    from pilosa_tpu_torch.api.tls import client_context
    return client_context(tls_of(cfg))


def _resolve_type(t):
    # dataclass field types are strings under future annotations
    if t in ("bool", bool):
        return bool
    if t in ("int", int):
        return int
    if t in ("float", float):
        return float
    if t in ("list[str]",) or t == list[str]:
        return list[str]
    return str
