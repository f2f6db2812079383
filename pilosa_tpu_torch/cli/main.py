"""Command line: ``python -m pilosa_tpu_torch.cli <command>``
(``pilosa_tpu.cli.main``'s commands).

- ``server``: run a node (:class:`pilosa_tpu_torch.server.PilosaTPUServer`)
  on the CUDA device, or on ``--device``; SIGINT or SIGTERM closes it.
- ``import``: bulk-load a CSV of ``row,col`` (or ``col,value`` with
  ``--value``) pairs through the HTTP client, ``--batch-size`` pairs per
  request with ``--workers`` requests in flight.
- ``export``: a field as CSV.
- ``check``: an offline check of a closed data directory: every fragment
  expands fully, and every fragment the open quarantined (a snapshot
  whose frame fails its check) prints ``BAD <path>: quarantined``; any
  problem exits 1.
- ``config`` (the effective config as JSON), ``generate-config`` (the
  defaults as TOML) and ``version``.
- ``backup`` and ``restore`` are not supported by this port and exit 1.

Client commands talk HTTP(S) to a running server at ``--bind``.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cli import config as cfgmod


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="TOML config file")
    p.add_argument("--bind", help="host:port to serve on / connect to")
    p.add_argument("--data-dir", dest="data_dir", help="storage directory")
    p.add_argument("--device", help="torch device to serve on; default: "
                   "the CUDA device")
    p.add_argument("--grpc-bind", dest="grpc_bind",
                   help="host:port for the gRPC surface (default off)")
    p.add_argument("--verbose", action="store_true", default=None)
    p.add_argument("--tls-certificate", dest="tls_certificate",
                   help="PEM certificate; enables TLS on every surface")
    p.add_argument("--tls-key", dest="tls_key", help="PEM private key")
    p.add_argument("--tls-ca-certificate", dest="tls_ca_certificate",
                   help="CA bundle for verifying peers")
    p.add_argument("--tls-skip-verify", dest="tls_skip_verify",
                   action="store_true", default=None,
                   help="outbound: accept any server certificate")
    p.add_argument("--tls-enable-client-auth",
                   dest="tls_enable_client_auth", action="store_true",
                   default=None, help="inbound: require client certs")


_CLI_KEYS = ("bind", "data_dir", "device", "verbose", "grpc_bind",
             "tls_certificate", "tls_key", "tls_ca_certificate",
             "tls_skip_verify", "tls_enable_client_auth")


def _load_cfg(args) -> cfgmod.Config:
    overrides = {k: getattr(args, k, None) for k in _CLI_KEYS}
    return cfgmod.load(args.config, overrides=overrides)


def _client(cfg: cfgmod.Config):
    from pilosa_tpu_torch.api.client import Client
    return Client(cfg.host, cfg.port,
                  ssl_context=cfgmod.client_ssl_of(cfg))


# -- commands ---------------------------------------------------------------


def cmd_server(args) -> int:
    cfg = _load_cfg(args)
    from pilosa_tpu_torch.obs import get_logger
    from pilosa_tpu_torch.server import (PilosaTPUServer,
                                         serve_until_signalled)
    log = get_logger("pilosa_tpu_torch", verbose=cfg.verbose,
                     fmt=cfg.log_format or None)
    log.info("effective config: %s", json.dumps(cfg.effective()))
    srv = PilosaTPUServer(cfg).open()
    scheme = "https" if cfg.tls_certificate else "http"
    host, port = srv.http.address
    log.info("listening on %s://%s:%d data=%s device=%s", scheme, host,
             port, cfg.data_dir, srv.device)
    serve_until_signalled(srv)
    return 0


def cmd_import(args) -> int:
    """CSV import: ``row,col`` lines (or ``col,value`` with ``--value``);
    keys where the target index or field is keyed."""
    cfg = _load_cfg(args)
    client = _client(cfg)
    if args.create:
        try:
            client.create_index(args.index, {"keys": args.keys})
        except Exception:  # noqa: BLE001 — it may exist already
            pass
        try:
            opts = ({"type": "int"} if args.value else
                    {"keys": args.keys and not args.id_rows})
            client.create_field(args.index, args.field, opts)
        except Exception:  # noqa: BLE001 — it may exist already
            pass

    schema = {i["name"]: i for i in client.schema()}
    if args.index not in schema:
        print(f"index {args.index!r} not found (use --create)",
              file=sys.stderr)
        return 1
    idx_keyed = schema[args.index]["options"]["keys"]
    fld = next((f for f in schema[args.index]["fields"]
                if f["name"] == args.field), None)
    if fld is None:
        print(f"field {args.field!r} not found (use --create)",
              file=sys.stderr)
        return 1
    fld_keyed = fld["options"]["keys"]

    def submit(rows, cols, vals):
        ckey = "columnKeys" if idx_keyed else "columnIDs"
        if args.value:
            return client.import_values(
                args.index, args.field, **{ckey: cols, "values": vals})
        rkey = "rowKeys" if fld_keyed else "rowIDs"
        return client.import_bits(
            args.index, args.field, **{rkey: rows, ckey: cols})

    batch_rows: list = []
    batch_cols: list = []
    batch_vals: list = []
    futures = []
    src = open(args.file) if args.file != "-" else sys.stdin
    # batches in flight at once; the server's locks order their writes
    with ThreadPoolExecutor(max_workers=max(1, args.workers)) as pool:
        def flush():
            if not batch_cols:
                return
            futures.append(pool.submit(submit, list(batch_rows),
                                       list(batch_cols), list(batch_vals)))
            batch_rows.clear(), batch_cols.clear(), batch_vals.clear()

        try:
            for line in src:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(",", 1)
                if args.value:
                    batch_cols.append(a if idx_keyed else int(a))
                    batch_vals.append(int(b))
                else:
                    batch_rows.append(a if fld_keyed else int(a))
                    batch_cols.append(b if idx_keyed else int(b))
                if len(batch_cols) >= args.batch_size:
                    flush()
            flush()
        finally:
            if src is not sys.stdin:
                src.close()
        totals = [f.result() for f in futures]
    print(f"imported (changed {sum(totals)} bits/values)", file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    cfg = _load_cfg(args)
    out = _client(cfg).export_csv(args.index, args.field)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def cmd_unsupported(args) -> int:
    print(f"{args.command} is not supported by this port (ROADMAP Queue 1 "
          "item 11b: backup/ and /internal/backup)", file=sys.stderr)
    return 1


def cmd_check(args) -> int:
    """Offline integrity check of a data directory: every fragment file
    parses, op-logs replay, and every fragment expands fully."""
    cfg = _load_cfg(args)
    from pilosa_tpu_torch.store import Holder
    problems = 0
    h = Holder(cfg.data_dir)
    try:
        h.open()
    except Exception as e:  # noqa: BLE001 — report, not crash
        print(f"FATAL: holder open failed: {e}")
        return 1
    for iname, idx in h.indexes.items():
        for fname, f in idx.fields.items():
            for vname, v in f.views.items():
                for shard, frag in v.fragments.items():
                    try:
                        # positions() expands every container, not just
                        # the directory the lazy open parses
                        n = len(frag.positions())
                        print(f"ok {iname}/{fname}/{vname}/{shard}: "
                              f"{n} bits, {len(frag.row_ids())} rows, "
                              f"op_n={frag.op_n}")
                    except Exception as e:  # noqa: BLE001
                        problems += 1
                        print(f"BAD {iname}/{fname}/{vname}/{shard}: {e}")
    # a corrupt snapshot quarantines its fragment at open instead of
    # failing it, so the check reads the registry too
    for entry in h.storage_health.quarantined_entries():
        problems += 1
        print(f"BAD {entry['path']}: quarantined "
              f"({entry['kind']}) {entry['detail']}")
    h.close()
    print(f"{problems} problems" if problems else "all fragments ok")
    return 1 if problems else 0


def cmd_config(args) -> int:
    print(json.dumps(_load_cfg(args).effective(), indent=2))
    return 0


def cmd_generate_config(args) -> int:
    cfg = cfgmod.Config()
    for f, v in cfg.effective().items():
        key = f.replace("_", "-")
        if isinstance(v, str):
            print(f'{key} = "{v}"')
        elif isinstance(v, bool):
            print(f"{key} = {str(v).lower()}")
        elif isinstance(v, list):
            print(f"{key} = {v!r}")
        else:
            print(f"{key} = {v}")
    return 0


def cmd_version(args) -> int:
    print(__version__)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa-tpu-torch",
                                description="bitmap index on the H100")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("server", help="run a node")
    _add_common(sp)
    sp.set_defaults(fn=cmd_server)

    sp = sub.add_parser("import", help="bulk import CSV")
    _add_common(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("file", help="CSV path or - for stdin")
    sp.add_argument("--create", action="store_true",
                    help="create index/field if missing")
    sp.add_argument("--keys", action="store_true",
                    help="with --create: keyed index/field")
    sp.add_argument("--id-rows", action="store_true",
                    help="with --create --keys: rows stay integer ids")
    sp.add_argument("--value", action="store_true",
                    help="CSV is col,value for an int field")
    sp.add_argument("--batch-size", type=int, default=100_000)
    sp.add_argument("--workers", type=int, default=4,
                    help="concurrent import batches in flight")
    sp.set_defaults(fn=cmd_import)

    sp = sub.add_parser("export", help="export field as CSV")
    _add_common(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("-o", "--output")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("backup", help="not supported by this port")
    _add_common(sp)
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--workers", type=int, default=4)
    sp.add_argument("--incremental", action="store_true")
    sp.set_defaults(fn=cmd_unsupported)

    sp = sub.add_parser("restore", help="not supported by this port")
    _add_common(sp)
    sp.add_argument("input")
    sp.add_argument("--workers", type=int, default=4)
    sp.set_defaults(fn=cmd_unsupported)

    sp = sub.add_parser("check", help="offline data-dir integrity check")
    _add_common(sp)
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("config", help="print effective config")
    _add_common(sp)
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("generate-config", help="print default TOML")
    sp.set_defaults(fn=cmd_generate_config)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
