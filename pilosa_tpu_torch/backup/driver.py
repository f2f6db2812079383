"""Backup and restore drivers (``pilosa_tpu.backup.driver``'s): consistent
online cluster backup, elastic restore.

A client-side driver walks the cluster and pulls every fragment over
HTTP, then pushes an archive into a fresh cluster, possibly of another
size.

**Backup** (:class:`BackupDriver`): read the target's cluster state (an
un-clustered node is a one-node walk), union the nodes' fragment
inventories, and pull every ``(index, field, view, shard)`` from a live
owner (placement order first, then any other node that reports it, the
replica fallback) with ``workers`` parallel streams.  Each image is
generation-bracketed by the server and its digest checked while it
streams to disk (the client's download never holds a whole body).
``incremental=True`` diffs the inventory's checksums against the prior
``manifest.json`` and transfers only fragments whose positions changed;
the rewritten manifest keeps pointing at the untouched files, so the
directory always holds one consistent latest image.

**Restore** (:class:`RestoreDriver`): digests are checked first (a
corrupt archive fails before the target is touched), then schema,
translate key logs, attribute stores and fragments.  Fragments are routed
by the target's placement (the node count may differ from the source's:
the elastic part) and union-merged into every owner through
``/internal/fragment/merge``; then one anti-entropy round is forced, so a
replica the push missed converges at once.  A restore is idempotent:
pushing the same archive again is a union of identical bits.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from pilosa_tpu_torch.api.client import Client, ClientError
from pilosa_tpu_torch.backup.manifest import (FORMAT_VERSION, Manifest,
                                              frag_key, frag_relpath,
                                              sha256_file)
from pilosa_tpu_torch.obs import get_logger
from pilosa_tpu_torch.parallel.placement import shard_nodes

TRANSLATE_PAGE = 100_000


class BackupError(RuntimeError):
    """A backup/restore run could not complete."""


def _run_all(fn, items, workers: int):
    """Run ``fn(item)`` over ``items`` with ``workers`` threads,
    yielding results on the CALLER thread (so callers aggregate
    without locks).  Fails fast: the first exception cancels every
    not-yet-started item instead of letting a doomed run transfer
    everything else first."""
    if workers == 1 or len(items) <= 1:
        for item in items:
            yield fn(item)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(fn, item) for item in items]
        try:
            for fut in as_completed(futs):
                yield fut.result()
        except BaseException:
            for f in futs:
                f.cancel()
            raise


class _HashingSink:
    """File sink that sha256-hashes every chunk as it lands (digest
    verification without a second pass or a full in-memory body)."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()
        self.size = 0

    def write(self, chunk: bytes) -> int:
        self._h.update(chunk)
        self.size += len(chunk)
        return self._f.write(chunk)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


class _ClusterView:
    """Target topology as seen from one entry node: node ids, active
    placement, replica count.  Un-clustered nodes (503 from the
    cluster surface) degrade to a single-node view."""

    def __init__(self, entry_id: str, entry_client: Client,
                 ssl_context=None, timeout: float = 120.0):
        self._ssl = ssl_context
        self._timeout = timeout
        self._clients: dict[str, Client] = {entry_id: entry_client}
        try:
            st = entry_client._json("GET", "/internal/cluster/state")
        except ClientError as e:
            if e.status != 503:
                raise
            self.clustered = False
            self.node_ids = [entry_id]
            self.placement = [entry_id]
            self.placement_version = 0.0
            self.replicas = 1
            return
        self.clustered = True
        self.node_ids = sorted(n["id"] for n in st["nodes"])
        self.placement = sorted(st.get("placement") or self.node_ids)
        self.placement_version = float(st.get("placementVersion", 0.0))
        self.replicas = int(st.get("replicas", 1))

    def client(self, node_id: str) -> Client:
        c = self._clients.get(node_id)
        if c is None:
            host, port = node_id.rsplit(":", 1)
            c = self._clients[node_id] = Client(
                host, int(port), timeout=self._timeout,
                ssl_context=self._ssl)
        return c

    def owners(self, index: str, shard: int) -> list[str]:
        return shard_nodes(index, shard, self.placement, self.replicas)

    def close(self) -> None:
        for c in self._clients.values():
            c.close()


class BackupDriver:
    def __init__(self, host: str, port: int, out_dir: str, *,
                 workers: int = 4, incremental: bool = False,
                 ssl_context=None, logger=None, on_fragment=None):
        self.out_dir = out_dir
        self.workers = max(1, workers)
        self.incremental = incremental
        self.logger = logger or get_logger("pilosa_tpu_torch.backup")
        self.entry_id = f"{host}:{port}"
        self.entry = Client(host, port, timeout=120.0,
                            ssl_context=ssl_context)
        self._ssl = ssl_context
        # test seam: called after every fragment transfer/skip
        self.on_fragment = on_fragment

    def run(self) -> dict:
        t0 = time.perf_counter()
        os.makedirs(self.out_dir, exist_ok=True)
        prior = Manifest.maybe_load(self.out_dir) if self.incremental \
            else None
        view = _ClusterView(self.entry_id, self.entry, self._ssl)
        try:
            schema = self.entry._json(
                "GET", "/internal/backup/schema")["schema"]
            inv, holders = self._inventory(view)
            man = Manifest()
            man.created_at = time.time()
            man.placement_version = view.placement_version
            man.replicas = view.replicas
            man.nodes = list(view.node_ids)
            man.incremental_of = prior.created_at if prior else None
            man.schema = schema

            transferred, skipped = [], []

            def pull(key: str) -> tuple[str, dict, int, int]:
                """Returns (key, entry, bytes transferred, fallbacks)
                — aggregation happens on the caller thread so no
                counter update races under concurrent workers."""
                fr = inv[key]
                old = prior.fragments.get(key) if prior else None
                if (old is not None
                        and self._unchanged(key, fr, old, holders)
                        and os.path.exists(
                            os.path.join(self.out_dir, old["file"]))):
                    out = (key, old, -1, 0)  # -1 = skipped, not pulled
                else:
                    ent, fell = self._pull_fragment(view, fr, holders[key])
                    out = (key, ent, ent["bytes"], fell)
                if self.on_fragment is not None:
                    self.on_fragment(key)
                return out

            fallbacks = 0
            total_bytes = 0
            for key, ent, nbytes, fell in _run_all(
                    pull, sorted(inv), self.workers):
                man.fragments[key] = ent
                if nbytes < 0:
                    skipped.append(key)
                else:
                    transferred.append(key)
                    total_bytes += nbytes
                    fallbacks += fell

            total_bytes += self._backup_translate(man)
            total_bytes += self._backup_attrs(man)
            path = man.save(self.out_dir)
        finally:
            view.close()
        dt = time.perf_counter() - t0
        result = {"manifest": path, "fragments": len(man.fragments),
                  "transferred": sorted(transferred),
                  "skipped": sorted(skipped),
                  "fallbacks": fallbacks, "bytes": total_bytes,
                  "seconds": round(dt, 3),
                  "incremental": prior is not None}
        self.logger.info(
            "backup complete: %d fragments (%d transferred, %d skipped, "
            "%d replica fallbacks), %d bytes in %.2fs -> %s",
            result["fragments"], len(transferred), len(skipped),
            result["fallbacks"], result["bytes"], dt, self.out_dir)
        return result

    # -- walk ----------------------------------------------------------------

    def _inventory(self, view: _ClusterView):
        """Union of per-node fragment inventories.  An unreachable node
        only degrades the walk if NO other node reports (a replica of)
        its fragments — exactly the failure replica fallback covers."""
        inv: dict[str, dict] = {}
        holders: dict[str, list[str]] = {}
        reachable = 0
        for nid in view.node_ids:
            try:
                frags = view.client(nid)._json(
                    "GET", "/internal/backup/inventory?checksums=1"
                )["fragments"]
            except (ClientError, OSError) as e:
                self.logger.warning(
                    "inventory from %s failed (%s); relying on replicas",
                    nid, e)
                continue
            reachable += 1
            for fr in frags:
                key = frag_key(fr["index"], fr["field"], fr["view"],
                               fr["shard"])
                ent = inv.setdefault(key, dict(fr))
                holders.setdefault(key, []).append(nid)
                # every reporting holder's checksum, for the skip
                # decision (replicas mid-repair disagree)
                ent.setdefault("_checksums", set()).add(
                    fr.get("checksum"))
        if reachable == 0:
            raise BackupError("no node's fragment inventory is readable")
        return inv, holders

    @staticmethod
    def _unchanged(key: str, fr: dict, old: dict,
                   holders: dict[str, list[str]]) -> bool:
        """Incremental skip decision: only when EVERY reporting
        holder's checksum matches the prior archived one — replicas
        mid-repair (disagreeing checksums) re-transfer rather than
        risk keeping a stale image."""
        prior = old.get("checksum")
        sums = fr.get("_checksums") or {fr.get("checksum")}
        return prior is not None and sums == {prior}

    def _candidates(self, view: _ClusterView, fr: dict,
                    holder_ids: list[str]) -> list[str]:
        """Source order: placement owners that actually hold the
        fragment (primary first), then any other reporting holder
        (orphans mid-resize still back up)."""
        owners = view.owners(fr["index"], fr["shard"])
        ordered = [n for n in owners if n in holder_ids]
        ordered += [n for n in holder_ids if n not in ordered]
        return ordered

    def _pull_fragment(self, view: _ClusterView, fr: dict,
                       holder_ids: list[str]) -> tuple[dict, int]:
        rel = frag_relpath(fr["index"], fr["field"], fr["view"],
                           fr["shard"])
        dest = os.path.join(self.out_dir, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        path = (f"/internal/backup/fragment/{fr['index']}/{fr['field']}"
                f"/{fr['view']}/{fr['shard']}")
        last: Exception | None = None
        for i, nid in enumerate(self._candidates(view, fr, holder_ids)):
            tmp = dest + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    sink = _HashingSink(f)
                    headers = view.client(nid).download(path, sink)
                want = headers.get("X-Content-SHA256")
                if want and want != sink.hexdigest():
                    raise BackupError(
                        f"transfer digest mismatch from {nid} for {rel}")
                os.replace(tmp, dest)
                ent = {"index": fr["index"], "field": fr["field"],
                       "view": fr["view"], "shard": fr["shard"],
                       "generation": int(
                           headers.get("X-Pilosa-Generation", -1)),
                       "checksum": headers.get("X-Pilosa-Checksum"),
                       "sha256": sink.hexdigest(), "bytes": sink.size,
                       "file": rel}
                return ent, (1 if i > 0 else 0)
            except (ClientError, OSError, BackupError) as e:
                last = e
                self.logger.warning(
                    "fragment pull %s from %s failed (%s); trying a "
                    "replica", rel, nid, e)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        raise BackupError(
            f"no live replica could serve fragment {rel}: {last}")

    # -- sidecars ------------------------------------------------------------

    def _backup_translate(self, man: Manifest) -> int:
        try:
            logs = self.entry._json(
                "GET", "/internal/translate/logs")["logs"]
        except ClientError as e:
            raise BackupError(f"translate log listing failed: {e}") from e
        total = 0
        for ent in logs:
            index, field = ent["index"], ent["field"]
            keys: list[str] = []
            while True:
                resp = self.entry._json(
                    "GET", f"/internal/translate/tail?index={index}"
                    f"&field={field or ''}&after={len(keys)}"
                    f"&limit={TRANSLATE_PAGE}")
                if not resp["keys"]:
                    break
                keys.extend(resp["keys"])
                if len(keys) >= resp.get("len", 0):
                    break
            rel = os.path.join("translate", index,
                               f"{field}.json" if field
                               else "_columns.json")
            total += self._write_sidecar(
                rel, {"index": index, "field": field, "keys": keys})
            name = f"{index}/{field}" if field else index
            man.translate[name] = {
                "file": rel,
                "sha256": sha256_file(os.path.join(self.out_dir, rel)),
                "entries": len(keys)}
        return total

    def _backup_attrs(self, man: Manifest) -> int:
        stores = self.entry._json(
            "GET", "/internal/backup/attrs")["stores"]
        total = 0
        for st in stores:
            index, field = st["index"], st["field"]
            qs = f"?field={field}" if field else ""
            items = self.entry._json(
                "GET", f"/internal/backup/attrs/{index}{qs}")["items"]
            rel = os.path.join("attrs", index,
                               f"{field}.json" if field
                               else "_columns.json")
            total += self._write_sidecar(
                rel, {"index": index, "field": field, "items": items})
            name = f"{index}/{field}" if field else index
            man.attrs[name] = {
                "file": rel,
                "sha256": sha256_file(os.path.join(self.out_dir, rel)),
                "entries": len(items)}
        return total

    def _write_sidecar(self, rel: str, obj: dict) -> int:
        dest = os.path.join(self.out_dir, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        body = json.dumps(obj).encode()
        tmp = dest + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
        os.replace(tmp, dest)
        return len(body)


class RestoreDriver:
    def __init__(self, host: str, port: int, from_dir: str, *,
                 workers: int = 4, ssl_context=None, logger=None):
        self.from_dir = from_dir
        self.workers = max(1, workers)
        self.logger = logger or get_logger("pilosa_tpu_torch.backup")
        self.entry_id = f"{host}:{port}"
        self.entry = Client(host, port, timeout=120.0,
                            ssl_context=ssl_context)
        self._ssl = ssl_context

    def run(self) -> dict:
        t0 = time.perf_counter()
        man = Manifest.load(self.from_dir)
        if man.format_version != FORMAT_VERSION:
            raise BackupError(
                f"manifest format {man.format_version} unsupported")
        # fail BEFORE touching the target: a corrupt archive must not
        # leave a half-restored cluster behind
        man.verify_files(self.from_dir)
        view = _ClusterView(self.entry_id, self.entry, self._ssl)
        try:
            self._check_fresh(man)
            nodes = self._reachable_nodes(view)
            for nid in nodes:
                view.client(nid)._json("POST", "/internal/schema",
                                       {"schema": man.schema})
            self._restore_translate(view, man, nodes)
            self._restore_attrs(view, man, nodes)
            total_bytes, pushes = self._restore_fragments(view, man)
            repaired = self._force_aae(view, nodes)
        finally:
            view.close()
        dt = time.perf_counter() - t0
        result = {"fragments": len(man.fragments), "pushes": pushes,
                  "bytes": total_bytes, "nodes": len(nodes),
                  "aaeRepaired": repaired, "seconds": round(dt, 3)}
        self.logger.info(
            "restore complete: %d fragments (%d pushes) onto %d nodes, "
            "%d bytes in %.2fs (aae repaired %d blocks)",
            result["fragments"], pushes, len(nodes), total_bytes, dt,
            repaired)
        return result

    def _check_fresh(self, man: Manifest) -> None:
        """Elastic restore targets a FRESH cluster (upstream restore's
        rule): refuse when any archived index already exists."""
        existing = {i["name"] for i in self.entry.schema()}
        overlap = sorted(existing
                         & {i["name"] for i in man.schema})
        if overlap:
            raise BackupError(
                f"restore target already has index(es) {overlap}; "
                "restore requires a fresh cluster")

    def _reachable_nodes(self, view: _ClusterView) -> list[str]:
        nodes = []
        for nid in view.node_ids:
            try:
                view.client(nid)._json("GET", "/status")
                nodes.append(nid)
            except (ClientError, OSError) as e:
                self.logger.warning("restore: node %s unreachable (%s)",
                                    nid, e)
        if not nodes:
            raise BackupError("no restore target node is reachable")
        return nodes

    def _restore_translate(self, view: _ClusterView, man: Manifest,
                           nodes: list[str]) -> None:
        """Key logs restored FIRST (before fragment bits) so keyed
        lookups resolve the moment data lands — and to every node,
        matching the fully-replicated translate-log design."""
        for name, ent in sorted(man.translate.items()):
            with open(os.path.join(self.from_dir, ent["file"])) as f:
                data = json.load(f)
            index, field, keys = data["index"], data["field"], data["keys"]
            for nid in nodes:
                for off in range(0, len(keys), TRANSLATE_PAGE):
                    page = keys[off:off + TRANSLATE_PAGE]
                    view.client(nid)._json(
                        "POST", f"/internal/backup/translate/{index}",
                        {"field": field, "start_id": off + 1,
                         "keys": page})
            self.logger.info("restored translate log %s (%d keys)",
                             name, len(keys))

    def _restore_attrs(self, view: _ClusterView, man: Manifest,
                       nodes: list[str]) -> None:
        for name, ent in sorted(man.attrs.items()):
            with open(os.path.join(self.from_dir, ent["file"])) as f:
                data = json.load(f)
            qs = (f"index={data['index']}"
                  f"&field={data['field'] or ''}")
            for nid in nodes:
                view.client(nid)._json(
                    "POST", f"/internal/attrs/merge?{qs}",
                    {"items": data["items"]})

    def _restore_fragments(self, view: _ClusterView,
                           man: Manifest) -> tuple[int, int]:
        def push(key: str) -> tuple[int, int]:
            """Returns (bytes pushed, pushes) for caller-side
            aggregation.  Bodies are STREAMED from the archive file
            (explicit Content-Length; http.client sends file objects
            in small blocks) — a multi-GB fragment never materializes
            in restore-host memory, matching the backup side's
            bounded-memory download."""
            ent = man.fragments[key]
            path = os.path.join(self.from_dir, ent["file"])
            size = os.path.getsize(path)
            qs = (f"index={ent['index']}&field={ent['field']}"
                  f"&view={ent['view']}&shard={ent['shard']}")
            owners = view.owners(ent["index"], ent["shard"])
            landed = 0
            last: Exception | None = None
            for owner in owners:
                try:
                    with open(path, "rb") as f:
                        view.client(owner)._do(
                            "POST", f"/internal/fragment/merge?{qs}", f,
                            content_type="application/octet-stream",
                            headers={"X-Pilosa-Restore": "1",
                                     "Content-Length": str(size)})
                    landed += 1
                except (ClientError, OSError) as e:
                    last = e
                    self.logger.warning(
                        "restore push %s to %s failed: %s", key, owner, e)
            if landed == 0:
                raise BackupError(
                    f"no owner accepted fragment {key}: {last}")
            # a partially-landed fragment converges via the forced AAE
            # round below (union-merge between the owners that took it)
            return size * landed, landed

        total = pushes = 0
        for nbytes, landed in _run_all(push, sorted(man.fragments),
                                       self.workers):
            total += nbytes
            pushes += landed
        return total, pushes

    def _force_aae(self, view: _ClusterView, nodes: list[str]) -> int:
        """One forced anti-entropy round so replicas a push missed
        converge NOW.  Un-clustered targets (503) have no replicas to
        converge — skipped."""
        repaired = 0
        for nid in nodes:
            try:
                repaired += view.client(nid)._json(
                    "POST", "/internal/aae/run", {})["repaired"]
            except (ClientError, OSError) as e:
                if getattr(e, "status", 0) != 503:
                    self.logger.warning("forced AAE on %s failed: %s",
                                        nid, e)
        return repaired
