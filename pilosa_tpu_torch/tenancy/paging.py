"""Paged plane residency (``pilosa_tpu.tenancy.paging``).

A plane past the device budget (or its tenant's byte quota) never
materializes whole.  Its shard axis splits into *pages*, runs of shards
sized so one page stays under ``page_bytes``, and each page is an ordinary
plane-cache entry (key ``("page", index, field, view, page_shards)``) with
its own row union and slot map, leased, evicted and delta-overlaid like a
whole plane.  A Count answers resident pages on the card and the rest from
the host's row cardinalities (container-header sums, no bit expanded),
summed per row across pages: exact whatever the residency.

A page-in goes through the plane build's bulk path
(:meth:`~pilosa_tpu_torch.exec.planes.PlaneCache.assemble`): each fragment
of the page expands once, on the builder threads, against the page's full
row union, so a fresh ``.dense`` sidecar is read warm and a cold
expansion writes one.  Page-ins count warm hits and misses but not plane
builds.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pilosa_tpu_torch.engine.words import WORDS_PER_SHARD, pow2_bucket
from pilosa_tpu_torch.exec.planes import union_row_ids
from pilosa_tpu_torch.obs import NULL_FLIGHT, NopStats


class PlanePager:
    """Page partition, page residency and the host oracle for pages that
    are not resident.  The eviction order and the byte quota are the
    :class:`~pilosa_tpu_torch.tenancy.governor.ResidencyGovernor`'s,
    shared with the cache."""

    def __init__(self, cache, governor=None, page_bytes: int = 64 << 20,
                 stats=None, flight=None):
        self.cache = cache
        self._stats = stats or NopStats()
        self.flight = flight or NULL_FLIGHT
        self.governor = governor
        self.page_bytes = max(1 << 20, int(page_bytes))
        self._lock = threading.Lock()
        self.page_ins = 0
        self.page_in_seconds_total = 0.0
        self.oracle_serves = 0
        self.quota_denials = 0
        # per tenant: pages answered from residency (hits), pages paged in
        # or answered by the oracle (misses), page-ins
        self._t_hits: dict[str, int] = {}
        self._t_misses: dict[str, int] = {}
        self._t_page_ins: dict[str, int] = {}

    # -- partition ----------------------------------------------------------

    def partition(self, field, view_name: str,
                  shards: tuple[int, ...]) -> list[tuple[int, ...]] | None:
        """``shards`` as consecutive pages of at most ``page_bytes``, a page
        also at most half the budget (and half the tenant quota) so two fit
        at once; None when the plane fits one page."""
        if len(shards) < 2:
            return None
        est = self.cache.plane_bytes(field, view_name, shards)
        slab = max(1, est // len(shards))
        eff = self.page_bytes
        if self.cache.budget > 0:
            eff = min(eff, max(slab, self.cache.budget // 2))
        g = self.governor
        if g is not None and g.byte_quota > 0:
            eff = min(eff, max(slab, g.byte_quota // 2))
        per = max(1, eff // slab)
        if per >= len(shards):
            return None
        return [tuple(shards[i:i + per])
                for i in range(0, len(shards), per)]

    @staticmethod
    def page_key(index: str, field, view_name: str,
                 page_shards: tuple[int, ...]) -> tuple:
        return ("page", index, field.name, view_name, page_shards)

    # -- residency ----------------------------------------------------------

    def resident_page(self, index: str, field, view_name: str,
                      page_shards: tuple[int, ...]):
        """The page's PlaneSet when it can serve from residency: fresh, or
        stale with its write gap absorbed into its overlay or folded (the
        whole planes' machinery).  None when it is not resident, or its row
        set changed under it (the entry is dropped and the caller pages it
        in again)."""
        cache = self.cache
        key = self.page_key(index, field, view_name, page_shards)
        gens = cache._gens(field, view_name, page_shards)
        with cache._lock:
            hit = cache._entries.get(key)
            if hit is not None and hit[0] == gens:
                cache._touch(key)
                cache._lease(key)
                self._note(self._t_hits, index)
                return hit[1]
        if hit is None:
            return None
        ps = cache._delta_update(key, field, view_name, page_shards, hit)
        if ps is not None:
            cache._lease(key)
            self._note(self._t_hits, index)
            return ps
        with cache._lock:
            if key in cache._entries and key not in cache._pinned():
                cache._evict_entry(key, "stale")
        return None

    def page_in(self, index: str, field, view_name: str,
                page_shards: tuple[int, ...]):
        """Expand one page onto the card and cache it, leased to the
        calling query.  The tenant's byte quota is checked first, evicting
        the tenant's own coldest unleased entries to make room; None when
        the quota still cannot take the page (the caller asks the oracle)."""
        cache = self.cache
        key = self.page_key(index, field, view_name, page_shards)
        gens = cache._gens(field, view_name, page_shards)
        row_ids = union_row_ids(field, view_name, page_shards)
        r_pad = pow2_bucket(len(row_ids))
        want = len(page_shards) * r_pad * WORDS_PER_SHARD * 4
        g = self.governor
        if g is not None and g.byte_quota > 0:
            resident = cache.tenant_bytes(index)
            if not g.admit_bytes(resident, want):
                cache.evict_tenant(index, resident + want - g.byte_quota,
                                   reason="quota")
                if not g.admit_bytes(cache.tenant_bytes(index), want):
                    with self._lock:
                        self.quota_denials += 1
                    self._note(self._t_misses, index)
                    return None
        t0 = time.perf_counter()
        ps = cache.build_rows_plane(field, view_name, page_shards, row_ids,
                                    r_pad, tally=False, sidecar_write=True)
        dt = time.perf_counter() - t0
        cache._insert_entry(key, gens, ps, ps.plane.numel() * 4, field,
                            lease=True)
        if g is not None:
            g.note_build(key, dt)
        self._stats.observe("plane_page_in_seconds", dt)
        self.flight.record("pagein", f"{index}/{field.name}",
                           f"{len(page_shards)} shards", dt)
        with self._lock:
            self.page_ins += 1
            self.page_in_seconds_total += dt
        self._note(self._t_page_ins, index)
        self._note(self._t_misses, index)
        return ps

    # -- the oracle for pages that are not resident -------------------------

    def oracle_counts(self, field, view_name: str,
                      page_shards: tuple[int, ...], row_ids: list) -> list:
        """Per-row totals over a page from the host's row cardinalities;
        a None row (an unknown key) counts 0."""
        totals = [0] * len(row_ids)
        view = field.view(view_name)
        if view is None:
            return totals
        want = [(i, int(r)) for i, r in enumerate(row_ids) if r is not None]
        if not want:
            return totals
        want_arr = np.asarray([r for _, r in want], np.uint64)
        for s in page_shards:
            frag = view.fragment(s)
            if frag is None:
                continue
            ids, cards = frag.row_cardinalities()
            if not len(ids):
                continue
            pos = np.searchsorted(ids, want_arr)
            ok = pos < len(ids)
            pos = np.where(ok, pos, 0)
            match = ok & (ids[pos] == want_arr)
            for j, (i, _r) in enumerate(want):
                if match[j]:
                    totals[i] += int(cards[pos[j]])
        with self._lock:
            self.oracle_serves += 1
        return totals

    # -- telemetry ----------------------------------------------------------

    def forget(self, tenant: str) -> None:
        """Drop a deleted tenant's page hits, misses and page-ins."""
        with self._lock:
            for d in (self._t_hits, self._t_misses, self._t_page_ins):
                d.pop(tenant, None)

    def _note(self, d: dict, tenant: str) -> None:
        with self._lock:
            d[tenant] = d.get(tenant, 0) + 1

    def tenant_breakdown(self) -> dict:
        """Per tenant: resident bytes, entries and page entries."""
        cache = self.cache
        with cache._lock:
            items = [(k, v[2]) for k, v in cache._entries.items()]
        per: dict[str, dict] = {}
        for k, nb in items:
            d = per.setdefault(k[1], {"residentBytes": 0,
                                      "residentPages": 0,
                                      "residentEntries": 0})
            d["residentBytes"] += nb
            d["residentEntries"] += 1
            if k[0] == "page":
                d["residentPages"] += 1
        return per

    def payload(self) -> dict:
        """The ``/status`` tenancy block's paging half."""
        per = self.tenant_breakdown()
        with self._lock:
            hits, misses = dict(self._t_hits), dict(self._t_misses)
            page_ins = dict(self._t_page_ins)
            totals = {"pageIns": self.page_ins,
                      "pageInSeconds": round(self.page_in_seconds_total, 6),
                      "oracleServes": self.oracle_serves,
                      "quotaDenials": self.quota_denials}
        n_pages = sum(d["residentPages"] for d in per.values())
        self._stats.gauge("plane_resident_pages", n_pages)
        for t in set(hits) | set(misses) | set(page_ins):
            d = per.setdefault(t, {"residentBytes": 0, "residentPages": 0,
                                   "residentEntries": 0})
            h, m = hits.get(t, 0), misses.get(t, 0)
            d["pageHits"] = h
            d["pageMisses"] = m
            d["hitRatio"] = round(h / (h + m), 4) if h + m else 0.0
            d["pageIns"] = page_ins.get(t, 0)
        return {"pageBytes": self.page_bytes, "residentPages": n_pages,
                "tenants": per, **totals}
