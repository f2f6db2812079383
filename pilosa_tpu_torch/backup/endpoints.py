"""HTTP surface of the backup subsystem (``pilosa_tpu.backup.endpoints``'s).

These routes serve consistent per-fragment images to the backup driver
and take the restore driver's translate pushes.  Unlike the cluster's
``/internal/*`` surface they serve a single un-clustered node too.

Consistency: a fragment image is **generation-bracketed**: read the
generation, serialize, read it again, and serve only when both agree.  A
fragment under concurrent writes retries a bounded number of times, then
takes the fragment lock for one capture.  The served generation header is
therefore always the generation of the blob.

Every payload carries ``Content-Length`` and ``X-Content-SHA256`` (the
driver checks it while streaming to disk); a fragment also carries
``X-Pilosa-Generation`` and ``X-Pilosa-Checksum`` (the restart-stable
position checksum incremental mode diffs on).  For the same fragment the
body and these headers equal the reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

from pilosa_tpu_torch.api.api import ApiError

if TYPE_CHECKING:
    from pilosa_tpu_torch.api.server import Handler

# bracketing retries before one capture under the fragment lock (writes
# in flight keep moving the generation)
BRACKET_RETRIES = 4
# threads computing an inventory's checksums
INVENTORY_WORKERS = 8


def fragment_checksum(frag) -> str:
    """Restart-stable content checksum: crc32 over the fragment's sorted
    AAE block checksums.  ``Fragment.blocks()`` is cached per
    generation, so an unchanged fragment answers from the cache."""
    items = sorted(frag.blocks().items())
    buf = b"".join(struct.pack("<qI", b, c & 0xFFFFFFFF)
                   for b, c in items)
    return format(zlib.crc32(buf), "08x")


def _blob(frag) -> bytes:
    # serialize(positions()), built straight from the words when every
    # row is held dense (Fragment._snapshot_blob); under the lock so the
    # word path reads no row mid-write
    with frag.lock:
        return frag._snapshot_blob()


def capture_fragment(frag) -> tuple[bytes, int, str]:
    """(roaring blob, generation, checksum), generation-bracketed."""
    for _ in range(BRACKET_RETRIES):
        gen = frag.generation
        blob = _blob(frag)
        checksum = fragment_checksum(frag)
        if frag.generation == gen:
            return blob, gen, checksum
    # a hot fragment: one capture under its lock
    with frag.lock:
        gen = frag.generation
        blob = _blob(frag)
        checksum = fragment_checksum(frag)
    return blob, gen, checksum


def _find_fragment(handler: Handler, index: str, field: str, view: str,
                   shard: str):
    idx = handler.server.api.holder.index(index)
    if idx is None:
        raise ApiError(f"index {index!r} not found", 404)
    f = idx.field(field)
    if f is None:
        raise ApiError(f"field {field!r} not found", 404)
    v = f.view(view)
    if v is None:
        raise ApiError(f"view {view!r} not found", 404)
    frag = v.fragment(int(shard))
    if frag is None:
        raise ApiError(f"fragment {shard} not found", 404)
    return frag


# -- handlers ----------------------------------------------------------------


def h_backup_inventory(self: Handler) -> None:
    """Every local fragment holding data, with its generation and checksum
    under ``?checksums=1`` (incremental mode's skip detector).  Walks the
    holder, clustered or not.  The checksums of fragments not cached for
    their generation are computed on ``INVENTORY_WORKERS`` threads (the
    native decode and crc32 release the interpreter lock)."""
    want_sums = "checksums" in self.query
    out, frags = [], []
    holder = self.server.api.holder
    for iname, idx in list(holder.indexes.items()):
        for fname, f in list(idx.fields.items()):
            for vname, v in list(f.views.items()):
                for shard, frag in list(v.fragments.items()):
                    if not frag.present:
                        continue
                    out.append({"index": iname, "field": fname,
                                "view": vname, "shard": shard})
                    frags.append(frag)
    if want_sums and frags:
        def sums(frag):
            gen = frag.generation
            return gen, fragment_checksum(frag)

        with ThreadPoolExecutor(
                max_workers=min(INVENTORY_WORKERS, len(frags))) as pool:
            for ent, (gen, checksum) in zip(out, pool.map(sums, frags)):
                ent["generation"] = gen
                ent["checksum"] = checksum
    self._reply({"fragments": out})


def h_backup_fragment(self: Handler, index: str, field: str, view: str,
                      shard: str) -> None:
    t0 = time.perf_counter()
    frag = _find_fragment(self, index, field, view, shard)
    # an archive never captures a corrupt copy: the 503 sends the driver
    # to a replica, as a dead node mid-backup does
    if self.server.api.holder.storage_health.is_quarantined(frag.path):
        raise ApiError(
            f"fragment quarantined (storage corruption): {frag.path} "
            "— back up from a replica", 503, retry_after=2.0)
    blob, gen, checksum = capture_fragment(frag)
    digest = hashlib.sha256(blob).hexdigest()
    stats = self.server.stats
    stats.count("backup_bytes_total", len(blob))
    stats.observe("backup_fragment_seconds", time.perf_counter() - t0)
    self._reply(blob, content_type="application/octet-stream",
                headers={"X-Content-SHA256": digest,
                         "X-Pilosa-Generation": str(gen),
                         "X-Pilosa-Checksum": checksum})


def h_backup_schema(self: Handler) -> None:
    body = json.dumps({"schema": self.server.api.schema()}).encode()
    self._reply(body, headers={
        "X-Content-SHA256": hashlib.sha256(body).hexdigest()})


def h_backup_attrs_list(self: Handler) -> None:
    """The attribute stores on disk: ``[{index, field | null}]``.  Judged
    by the ``_attrs.db`` file, so listing creates no empty store."""
    holder = self.server.api.holder
    out = []
    for iname, idx in list(holder.indexes.items()):
        if os.path.exists(os.path.join(idx.path, "_attrs.db")):
            out.append({"index": iname, "field": None})
        for fname, f in list(idx.fields.items()):
            if os.path.exists(os.path.join(f.path, "_attrs.db")):
                out.append({"index": iname, "field": fname})
    self._reply({"stores": out})


def h_backup_attrs(self: Handler, index: str) -> None:
    """Every item of one attribute store."""
    idx = self.server.api.holder.index(index)
    if idx is None:
        raise ApiError(f"index {index!r} not found", 404)
    field = self.query.get("field", [""])[0]
    if field:
        f = idx.field(field)
        if f is None:
            raise ApiError(f"field {field!r} not found", 404)
        store = f.row_attrs
    else:
        store = idx.column_attrs
    items: dict[str, dict] = {}
    for block in sorted(store.blocks()):
        items.update({str(k): v
                      for k, v in store.block_items(block).items()})
    body = json.dumps({"items": items}).encode()
    self._reply(body, headers={
        "X-Content-SHA256": hashlib.sha256(body).hexdigest()})


def h_restore_translate(self: Handler, index: str) -> None:
    """Restore's translate append: ``/internal/translate/replicate``'s
    semantics (append-only, deduped by offset) on un-clustered nodes
    too, so a keyed index restores without a cluster."""
    b = self._json_body()
    translate = self.server.api.executor.translate
    log = (translate.columns(index) if not b.get("field")
           else translate.rows(index, b["field"]))
    try:
        log.append_replicated(int(b["start_id"]), b["keys"])
    except KeyError as e:
        raise ApiError(str(e), 409)
    self.server.stats.count("restore_keys_total", len(b["keys"]))
    self._reply({"len": len(log)})


def register_backup_routes(routes: list) -> None:
    """Append the backup routes to ``routes`` (the REST server's
    ``(method, compiled pattern, handler)`` list)."""
    from pilosa_tpu_torch.api.server import _route
    for method, pattern, fn in (
            ("GET", "/internal/backup/inventory", h_backup_inventory),
            ("GET", "/internal/backup/fragment/{index}/{field}/{view}/"
                    "{shard}", h_backup_fragment),
            ("GET", "/internal/backup/schema", h_backup_schema),
            ("GET", "/internal/backup/attrs", h_backup_attrs_list),
            ("GET", "/internal/backup/attrs/{index}", h_backup_attrs),
            ("POST", "/internal/backup/translate/{index}",
             h_restore_translate),
    ):
        routes.append(_route(method, pattern, fn))
