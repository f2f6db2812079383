"""Backup manifest: the archive's self-describing table of contents
(``pilosa_tpu.backup.manifest``'s; the same ``manifest.json`` bytes for
the same archive, the times aside).

An archive directory holds per-fragment files, schema and translate data
and an explicit ``manifest.json``, so restore and incremental backup
never have to guess what a directory contains:

- ``formatVersion`` gates forward compatibility (restore refuses
  manifests it does not understand);
- ``placementVersion``/``replicas``/``nodes`` record the SOURCE
  topology (informational — restore re-routes by the TARGET placement,
  that is what makes the restore elastic);
- one entry per fragment with its archive-relative file, size, sha256
  (transport/at-rest integrity), the source fragment's ``generation``
  at capture time (the bracketing label) and its position ``checksum``
  (crc32 over the fragment's AAE block checksums — stable across
  restarts, unlike the in-memory generation counter, so incremental
  diffs survive a source-node reboot);
- translate key logs and attribute stores as sidecar JSON files, also
  digest-pinned.

Archive layout under the output directory::

    manifest.json
    fragments/<index>/<field>/<view>/<shard>      roaring blob
    translate/<index>/_columns.json               {"keys": [...]}
    translate/<index>/<field>.json
    attrs/<index>/_columns.json                   {"items": {...}}
    attrs/<index>/<field>.json

Incremental runs rewrite ``manifest.json`` but keep unchanged fragment
files in place (entries point at the existing file), so one directory
accumulates a consistent latest image.
"""

from __future__ import annotations

import hashlib
import json
import os

FORMAT_VERSION = 1


def frag_key(index: str, field: str, view: str, shard: int) -> str:
    return f"{index}/{field}/{view}/{shard}"


def frag_relpath(index: str, field: str, view: str, shard: int) -> str:
    # mirrors the data-dir layout: unambiguous even though index/field
    # names may themselves contain the separator characters
    return os.path.join("fragments", index, field, view, str(shard))


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class ManifestError(ValueError):
    """Malformed, missing, or version-incompatible manifest."""


class Manifest:
    def __init__(self, data: dict | None = None):
        d = data or {}
        self.format_version = d.get("formatVersion", FORMAT_VERSION)
        self.created_at = d.get("createdAt", 0.0)
        self.placement_version = d.get("placementVersion", 0.0)
        self.replicas = d.get("replicas", 1)
        self.nodes = d.get("nodes", [])
        self.incremental_of = d.get("incrementalOf")
        self.schema = d.get("schema", [])
        # frag_key -> {index, field, view, shard, generation, checksum,
        #              sha256, bytes, file}
        self.fragments: dict[str, dict] = d.get("fragments", {})
        # "<index>" / "<index>/<field>" -> {file, sha256, entries}
        self.translate: dict[str, dict] = d.get("translate", {})
        self.attrs: dict[str, dict] = d.get("attrs", {})

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> dict:
        return {"formatVersion": self.format_version,
                "createdAt": self.created_at,
                "placementVersion": self.placement_version,
                "replicas": self.replicas,
                "nodes": self.nodes,
                "incrementalOf": self.incremental_of,
                "schema": self.schema,
                "fragments": self.fragments,
                "translate": self.translate,
                "attrs": self.attrs}

    def save(self, out_dir: str) -> str:
        """Atomic write (tmp+rename): a crashed backup never leaves a
        half-written manifest shadowing a good prior one."""
        path = os.path.join(out_dir, "manifest.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, out_dir: str) -> "Manifest":
        path = os.path.join(out_dir, "manifest.json")
        try:
            with open(path) as f:
                data = json.load(f)
        except OSError as e:
            raise ManifestError(f"no manifest at {path}: {e}") from e
        except ValueError as e:
            raise ManifestError(f"malformed manifest {path}: {e}") from e
        if data.get("formatVersion") != FORMAT_VERSION:
            raise ManifestError(
                f"manifest format {data.get('formatVersion')!r} not "
                f"supported (this build reads {FORMAT_VERSION})")
        return cls(data)

    @classmethod
    def maybe_load(cls, out_dir: str) -> "Manifest | None":
        """Prior manifest if one exists (the incremental base), else
        None.  A malformed prior manifest raises — silently falling
        back to a full transfer would hide archive corruption."""
        if not os.path.exists(os.path.join(out_dir, "manifest.json")):
            return None
        return cls.load(out_dir)

    # -- incremental diff ----------------------------------------------------

    def diff(self, prior: "Manifest | None") -> dict:
        """Classify this manifest's fragments against a prior one:
        ``{"changed": [keys...], "unchanged": [...], "removed": [...]}``
        — ``changed`` includes fragments absent from the prior archive.
        The change detector is the position checksum (restart-stable);
        generation equality alone is NOT trusted (counters reset to 0
        on fragment reopen)."""
        if prior is None:
            return {"changed": sorted(self.fragments), "unchanged": [],
                    "removed": []}
        changed, unchanged = [], []
        for key, ent in self.fragments.items():
            old = prior.fragments.get(key)
            if old is not None and old.get("checksum") == ent.get("checksum"):
                unchanged.append(key)
            else:
                changed.append(key)
        removed = [k for k in prior.fragments if k not in self.fragments]
        return {"changed": sorted(changed), "unchanged": sorted(unchanged),
                "removed": sorted(removed)}

    # -- integrity -----------------------------------------------------------

    def verify_files(self, out_dir: str) -> None:
        """Recompute every archived file's sha256 against the manifest;
        raises :class:`DigestError` naming the first corrupt file."""
        for key, ent in sorted(self.fragments.items()):
            self._verify_one(out_dir, ent, f"fragment {key}")
        for name, ent in sorted(self.translate.items()):
            self._verify_one(out_dir, ent, f"translate log {name}")
        for name, ent in sorted(self.attrs.items()):
            self._verify_one(out_dir, ent, f"attr store {name}")

    @staticmethod
    def _verify_one(out_dir: str, ent: dict, what: str) -> None:
        path = os.path.join(out_dir, ent["file"])
        try:
            got = sha256_file(path)
        except OSError as e:
            raise DigestError(f"{what}: archive file {ent['file']!r} "
                              f"unreadable: {e}") from e
        if got != ent["sha256"]:
            raise DigestError(
                f"{what}: sha256 mismatch for {ent['file']!r} "
                f"(manifest {ent['sha256'][:12]}…, file {got[:12]}…) — "
                "archive is corrupt; refusing to restore")


class DigestError(ValueError):
    """An archived file does not match its manifest digest."""
