"""Serve an index directory over REST on the torch device:

    python -m pilosa_tpu_torch.server --data-dir D --bind H:P [--device cpu]
        [--query-timeout SECONDS] [--fsync]

Without ``--device`` the server runs on the CUDA device and refuses to
start when there is none.  ``--query-timeout`` caps every query's
``?timeout=`` (0, the default: no cap).  ``--fsync`` (the reference's
``fsync`` config key) makes every acknowledged write durable: each
import batch fsyncs every op-log it touched once before it answers.
"""

from __future__ import annotations

import argparse

from pilosa_tpu_torch.api import API, Server
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.store import Holder


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch.server")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--bind", default="127.0.0.1:10101")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    p.add_argument("--query-timeout", type=float, default=0.0,
                   help="cap on a query's timeout in seconds (0: none)")
    p.add_argument("--fsync", action="store_true",
                   help="fsync op-log appends (once per import batch)")
    args = p.parse_args(argv)
    host, _, port = args.bind.rpartition(":")
    holder = Holder(args.data_dir, fsync=args.fsync).open()
    executor = Executor(holder, device=args.device)
    server = Server(API(holder, executor, query_timeout=args.query_timeout),
                    host or "127.0.0.1", int(port))
    print(f"pilosa_tpu_torch serving {args.data_dir} on "
          f"{server.address[0]}:{server.address[1]} ({executor.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        executor.close()
        holder.close()


if __name__ == "__main__":
    main()
