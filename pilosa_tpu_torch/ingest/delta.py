"""Device delta overlays: bounded write overlays merged at dispatch.

The counterpart of ``pilosa_tpu.ingest.delta`` for set-field planes:

- the **mirror** (:class:`DeltaMirror`) is the host truth of one resident
  plane's overlay: an insertion-ordered ``(flat_row, word) -> current
  word value`` map absorbed from fragment journals
  (``Fragment.changed_cells_since``).  A cell holds the word's CURRENT
  contents, so sets and clears are both "overwrite this word";
- the **overlay** (:class:`DeltaOverlay`) is the mirror's device form:
  three pow2-padded int32 tensors (flat row, word, value bits).  Pad lanes
  carry the out-of-range flat row ``S * R_pad``;
- the **merge** (:func:`adjusted_row_counts`,
  :func:`adjusted_selected_counts`) answers base+delta: the unchanged base
  plane is scanned by the same hand kernels as the clean path
  (``engine.kernels.row_counts`` / ``selected_row_counts``), then each
  touched (shard, row) count moves by ``popcount(new) - popcount(old)``;
- the **word overlays** (:func:`overlay_gathered_rows`,
  :func:`overlay_row`) hand the tree fold base+delta WORDS: gathered
  rows, or one row, with the overlay's cells written over them;
  :func:`overlay_time_range` does the same for the OR of a run of a time
  plane's bucket lanes;
- the **BSI overlay** (:class:`BsiOverlay`) groups a bit-sliced plane's
  cells by touched (shard, word) COLUMN, and the BSI aggregates split
  base+delta into the base plane with those word columns masked out of
  the filter (:func:`bsi_excl_filter`) and a tiny standalone plane of the
  merged touched columns (:func:`bsi_mini_plane`), both through the same
  functions and kernels.

The reference's adjustment is XLA-fused ``jnp`` (no Pallas), so it is
plain PyTorch here.  JAX drops out-of-range scatter lanes and clamps
gathers; torch indexing raises instead, so pad lanes are clamped for the
gathers and their diffs zeroed before any scatter.  Values are int32
carrying uint32 bits, so cell popcounts use the split-16 SWAR of
:func:`pilosa_tpu_torch.engine.kernels.popcount` (``>>`` on int32 is
arithmetic).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.engine.words import pow2_bucket
from pilosa_tpu_torch.parallel.mesh import PerBlock


@dataclass
class DeltaOverlay:
    """Device form of one plane's pending write cells.

    ``rows`` are FLAT row indices (``shard_axis * R_pad + row_slot``) into
    ``plane.reshape(S * R_pad, W)``; pad lanes carry ``rows == S * R_pad``.
    ``vals`` are the cells' current words (uint32 bits in int32)."""

    rows: torch.Tensor   # int32[C_pad]
    words: torch.Tensor  # int32[C_pad]
    vals: torch.Tensor   # int32[C_pad]
    n: int               # live cells (<= C_pad)
    bits: int            # set bits carried by the live cells

    @property
    def nbytes(self) -> int:
        """Device bytes a scan of the overlay reads: three int32 per
        lane."""
        return int(self.rows.numel()) * 12


@dataclass
class BsiOverlay:
    """Device form of a BIT-SLICED plane's pending write cells, one lane
    per touched (shard, word) column.

    A BSI write changes several rows of one 32-column word at once (the
    exists row, maybe the sign row, the changed magnitude bits), and the
    aggregates read whole columns, so the unit is the word column.  Every
    column is counted on exactly one side: the base plane with the
    touched columns excluded, or the mini plane of the merged touched
    columns.  ``n`` live lanes come first; pad lanes carry
    ``col_shard == S`` and an all-zero mini filter."""

    col_shard: torch.Tensor  # int32[K_pad] (pad lanes = S)
    col_word: torch.Tensor   # int32[K_pad]
    col_vals: torch.Tensor   # int32[K_pad, rows] new word values
    col_mask: torch.Tensor   # int32[K_pad, rows] -1 = row touched
    n: int                   # live columns (<= K_pad)
    bits: int                # set bits carried by the live cells

    @property
    def nbytes(self) -> int:
        """Device bytes a scan of the overlay reads: the value and mask
        words of every lane plus its shard and word indices."""
        return int(self.col_vals.numel()) * 8 + int(self.col_shard.numel()) * 8


class BlockedOverlay(PerBlock):
    """A blocked plane's overlay (a :class:`DeltaOverlay` or
    :class:`BsiOverlay` per block): each block's part holds the cells that
    fall in the block, re-indexed to it, on the block's device, so the
    merge functions run per block as they run over a whole plane."""

    def __init__(self, parts, n: int, bits: int):
        super().__init__(parts)
        self.n = n
        self.bits = bits

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)


def _bits_of(vals: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(
        vals, np.uint32).view(np.uint8)).sum())


class DeltaMirror:
    """Host mirror of one resident plane's overlay cells.

    Mutated only under the owning ``PlaneCache``'s lock; the overlays it
    builds are immutable, so a serving thread reads a whole one or none.
    ``cap`` bounds cells: callers check :meth:`would_fit` and fold or
    rebuild instead of absorbing past it.  Backed by three parallel numpy
    arrays plus a cell -> slot index, so an absorb costs one write per
    batch cell and :meth:`build_overlay` is one padded copy."""

    _GROW = 1024

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._index: dict[tuple[int, int], int] = {}
        size = min(self._GROW, max(1, self.cap))
        self._rows = np.empty(size, np.int64)
        self._words = np.empty(size, np.int64)
        self._vals = np.empty(size, np.uint32)
        self.bits = 0  # set bits over the live cell values

    def __len__(self) -> int:
        return len(self._index)

    def would_fit(self, new_cells) -> bool:
        """Whether absorbing ``new_cells`` keeps the mirror at or under
        cap (overwrites of cells it holds don't grow it)."""
        grow = sum(1 for k in new_cells if k not in self._index)
        return len(self._index) + grow <= self.cap

    def absorb(self, new_cells: dict[tuple[int, int], int]) -> None:
        """Overwrite-merge journal cells: a later absorb supersedes an
        earlier one per word."""
        for key, val in new_cells.items():
            slot = self._index.get(key)
            if slot is None:
                slot = len(self._index)
                if slot >= len(self._rows):
                    grow = min(max(len(self._rows) * 2, self._GROW),
                               max(self.cap, slot + 1))
                    for name in ("_rows", "_words", "_vals"):
                        arr = getattr(self, name)
                        new = np.empty(grow, arr.dtype)
                        new[:len(arr)] = arr
                        setattr(self, name, new)
                self._index[key] = slot
                self._rows[slot], self._words[slot] = key
            else:
                self.bits -= int(self._vals[slot]).bit_count()
            self._vals[slot] = val
            self.bits += int(val).bit_count()

    def snapshot(self) -> dict:
        """``{(flat_row, word): value}`` copy (the fold's input)."""
        n = len(self._index)
        return dict(zip(zip(self._rows[:n].tolist(),
                            self._words[:n].tolist()),
                        self._vals[:n].tolist()))

    def _cells(self):
        n = len(self._index)
        return self._rows[:n], self._words[:n], self._vals[:n]

    def build_overlay(self, device, flat_total: int) -> DeltaOverlay:
        """The device overlay on ``device``, padded to a power of two;
        pad lanes carry flat row ``flat_total`` (= S * R_pad)."""
        return _delta_overlay(*self._cells(), device, flat_total, self.bits)

    def build_bsi_overlay(self, device, n_rows: int,
                          n_shards: int) -> BsiOverlay:
        """The word-column-grouped device overlay of a BSI plane of
        ``n_rows`` rows (depth + 2) over ``n_shards`` shards: live cells
        regroup by (shard, word), each column carrying its new row words
        and touched-row mask in one lane; lanes pad to a power of two with
        ``col_shard == n_shards``.  One ``np.unique`` and two fancy
        scatters: this runs under the cache lock on every absorb."""
        return _bsi_overlay(*self._cells(), device, n_rows, n_shards,
                            self.bits)

    def build_blocked(self, layout: tuple, devices: list, n_rows: int,
                      bsi: bool) -> BlockedOverlay:
        """The overlay of a blocked plane of ``n_rows`` rows per shard: per
        block of ``layout`` (``(s0, s1, w0, w1)``) the cells in its shards
        (and words), flat rows and words re-indexed to the block, on its
        device."""
        rows, words, vals = self._cells()
        parts = []
        for (s0, s1, w0, w1), dev in zip(layout, devices):
            sel = (rows >= s0 * n_rows) & (rows < s1 * n_rows)
            if w0 is not None:
                sel &= (words >= w0) & (words < w1)
            b_rows = rows[sel] - s0 * n_rows
            b_words = words[sel] - (w0 or 0)
            b_vals = vals[sel]
            bits = _bits_of(b_vals)
            parts.append(
                _bsi_overlay(b_rows, b_words, b_vals, dev, n_rows, s1 - s0,
                             bits) if bsi
                else _delta_overlay(b_rows, b_words, b_vals, dev,
                                    (s1 - s0) * n_rows, bits))
        return BlockedOverlay(parts, n=len(rows), bits=self.bits)


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).to(device)


def _delta_overlay(rows, words, vals, device, flat_total: int,
                   bits: int) -> DeltaOverlay:
    n = len(rows)
    c_pad = pow2_bucket(n)
    out_rows = np.full(c_pad, flat_total, np.int32)
    out_words = np.zeros(c_pad, np.int32)
    out_vals = np.zeros(c_pad, np.uint32)
    out_rows[:n] = rows
    out_words[:n] = words
    out_vals[:n] = vals
    return DeltaOverlay(_put(out_rows, device), _put(out_words, device),
                        _put(out_vals, device), n=n, bits=bits)


def _bsi_overlay(flat, word, vals, device, n_rows: int, n_shards: int,
                 bits: int) -> BsiOverlay:
    key = (flat // n_rows).astype(np.int64) * (1 << 32) + word
    uniq, inv = np.unique(key, return_inverse=True)
    k = len(uniq)
    k_pad = pow2_bucket(k)
    col_shard = np.full(k_pad, n_shards, np.int32)
    col_word = np.zeros(k_pad, np.int32)
    col_vals = np.zeros((k_pad, n_rows), np.uint32)
    col_mask = np.zeros((k_pad, n_rows), np.uint32)
    col_shard[:k] = (uniq >> 32).astype(np.int32)
    col_word[:k] = (uniq & 0xFFFFFFFF).astype(np.int32)
    rows_in_col = (flat % n_rows).astype(np.int64)
    col_vals[inv, rows_in_col] = vals
    col_mask[inv, rows_in_col] = 0xFFFFFFFF
    return BsiOverlay(_put(col_shard, device), _put(col_word, device),
                      _put(col_vals, device), _put(col_mask, device), n=k,
                      bits=bits)


# ---------------------------------------------------------------------------
# Merge (plain PyTorch: the reference's is XLA-fused jnp, not Pallas)
# ---------------------------------------------------------------------------


def _cell_diffs(plane: torch.Tensor, d_rows: torch.Tensor,
                d_words: torch.Tensor, d_vals: torch.Tensor,
                filter_words: torch.Tensor | None):
    """Per-cell popcount deltas against the base plane, int32[C_pad] (0 on
    pad lanes), and each cell's row slot (``R`` on pad lanes)."""
    s, r, w = plane.shape
    total = s * r
    valid = (d_rows >= 0) & (d_rows < total)
    rc = d_rows.clamp(0, max(total - 1, 0)).long()
    wd = d_words.long()
    base = plane.reshape(total, w)[rc, wd]
    val = d_vals
    if filter_words is not None:
        fi = ((rc // r) * w + wd).clamp(0, s * w - 1)
        f = filter_words.reshape(s * w)[fi]
        base = base & f
        val = val & f
    diff = kernels.popcount(val) - kernels.popcount(base)
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    diff = torch.where(valid, diff, zero)
    slot = torch.where(valid, rc % r, torch.full_like(rc, r))
    return diff, slot


def adjusted_row_counts(plane: torch.Tensor, d_rows: torch.Tensor,
                        d_words: torch.Tensor, d_vals: torch.Tensor,
                        filter_words: torch.Tensor | None = None,
                        reduce_shards: bool = True) -> torch.Tensor:
    """Whole-plane per-row popcounts of base+delta: int32[S, R_pad, W]
    plane (& int32[S, W] filter) and overlay tensors -> int32[R_pad]
    (``reduce_shards``; callers gate on the int32-exact shard bound) or
    int32[S, R_pad].  The base scan is the clean path's ``row_counts``;
    cells only adjust the (shard, row) entries they touch."""
    s, r, _ = plane.shape
    counts = kernels.row_counts(plane, filter_words)  # int32[S, R]
    diff, _slot = _cell_diffs(plane, d_rows, d_words, d_vals, filter_words)
    # pad lanes carry diff 0: clamped to entry 0 they add nothing
    idx = d_rows.long().clamp(0, max(s * r - 1, 0))
    flat = counts.reshape(s * r)
    flat.index_add_(0, idx, diff)
    if reduce_shards:
        return flat.reshape(s, r).sum(0, dtype=torch.int32)
    return flat.reshape(s, r)


def _set_cells(target: torch.Tensor, index: tuple, match: torch.Tensor,
               d_vals: torch.Tensor) -> torch.Tensor:
    """``target[index][match] = d_vals[match]`` without a host sync and
    without an out-of-range index: every lane writes, and each lane that
    does not match writes the value the FIRST matching lane writes, to
    that lane's place (or, when no lane matches, lane 0's current value
    back to its clamped place), so the duplicate writes agree and the
    result does not depend on their order.  ``index`` entries are
    clamped int64 lane indices; live cells are unique, so matching lanes
    never share a place."""
    if not match.numel():
        return target
    first = torch.argmax(match.to(torch.int32))      # 0 when none match
    anchor = tuple(i[first] for i in index)
    keep = torch.where(match[first], d_vals[first], target[anchor])
    idx = tuple(torch.where(match, i, a) for i, a in zip(index, anchor))
    target.index_put_(idx, torch.where(match, d_vals, keep))
    return target


def overlay_gathered_rows(sel: torch.Tensor, row_idx: torch.Tensor,
                          d_rows: torch.Tensor, d_words: torch.Tensor,
                          d_vals: torch.Tensor, r_pad: int) -> torch.Tensor:
    """Apply the overlay's word overwrites to a row GATHER, IN PLACE:
    ``sel`` int32[S, G, W] is ``plane.index_select(1, row_idx)``, and each
    cell whose (shard, row slot) lands in the gathered set overwrites its
    word with the cell's current value — the base+delta words the tree
    fold reads.  ``row_idx`` lanes may repeat a slot (padding); a cell
    matches its FIRST lane only.  Pad cells (``d_rows >= S * r_pad``)
    drop.  Writes into ``sel`` (a fresh gather: no copy of up to the
    whole plane) and returns it."""
    s, g, w = sel.shape
    total = s * r_pad
    d_rows = d_rows.long()
    valid = (d_rows >= 0) & (d_rows < total)
    idx = row_idx.to(device=sel.device, dtype=torch.int64)
    match = ((d_rows % r_pad)[:, None] == idx[None, :]) & valid[:, None]
    hit = match.any(dim=1)
    lane = torch.argmax(match.to(torch.int32), dim=1)   # first matching
    cell_s = (d_rows // r_pad).clamp(0, max(s - 1, 0))
    word = d_words.long().clamp(0, max(w - 1, 0))
    return _set_cells(sel, (cell_s, lane, word), hit, d_vals)


def overlay_row(val: torch.Tensor, slot: int, d_rows: torch.Tensor,
                d_words: torch.Tensor, d_vals: torch.Tensor,
                r_pad: int) -> torch.Tensor:
    """Apply the overlay's word overwrites to ONE plane row: ``val``
    int32[S, W] is ``plane[:, slot, :]``; every cell whose row slot is
    ``slot`` overwrites its word.  Returns a new tensor (``val`` is a
    view of the resident plane)."""
    s, w = val.shape
    total = s * r_pad
    d_rows = d_rows.long()
    match = ((d_rows >= 0) & (d_rows < total)
             & (d_rows % r_pad == int(slot)))
    cell_s = (d_rows // r_pad).clamp(0, max(s - 1, 0))
    word = d_words.long().clamp(0, max(w - 1, 0))
    return _set_cells(val.clone(), (cell_s, word), match, d_vals)


# lanes of a time range gathered at once per touched column: bounds the
# [cells, lanes] temporary of a long range of fine buckets
TIME_LANE_BLOCK = 32


def _or_lanes(g: torch.Tensor) -> torch.Tensor:
    """OR over the last axis of int32[C, L] by halving (log2 L ops)."""
    width = pow2_bucket(g.shape[1])
    if width != g.shape[1]:
        g = torch.cat([g, g.new_zeros(g.shape[0], width - g.shape[1])], 1)
    while g.shape[1] > 1:
        h = g.shape[1] // 2
        g = g[:, :h] | g[:, h:]
    return g[:, 0]


def overlay_time_range(acc: torch.Tensor, plane: torch.Tensor, start: int,
                       length: int, d_rows: torch.Tensor,
                       d_words: torch.Tensor,
                       d_vals: torch.Tensor) -> torch.Tensor:
    """Make ``acc`` int32[S, W], the OR of the base plane's lanes ``[start,
    start + length)``, the OR of base+delta, IN PLACE.  A cell REPLACES
    its base word, so a cleared bit must drop out unless another lane in
    range holds it: only the (shard, word) columns that an in-range cell
    touches are recomputed, from their words over the range's lanes with
    the cells written over them.  No host sync: the columns group by a
    device sort of their keys, and every scatter has unique live targets
    (the rest write to a dummy row, or agree, as in :func:`_set_cells`)."""
    s, rb, w = plane.shape
    c = d_rows.numel()
    if not c or not length:
        return acc
    dev = plane.device
    rows = d_rows.long()
    slot = rows % rb
    live = ((rows >= 0) & (rows < s * rb)
            & (slot >= start) & (slot < start + length))
    cell_s = (rows // rb).clamp(0, s - 1)
    key = torch.where(live, cell_s * w + d_words.long().clamp(0, w - 1),
                      torch.full_like(rows, s * w))
    skey, order = torch.sort(key)
    lead = torch.ones_like(skey, dtype=torch.bool)
    lead[1:] = skey[1:] != skey[:-1]
    lead &= skey < s * w
    gid = torch.empty_like(skey)
    gid[order] = torch.cumsum(lead.long(), 0) - 1    # column group per cell
    dummy = torch.full_like(gid, c)
    gkey = torch.zeros(c + 1, dtype=torch.long, device=dev)
    gkey.index_put_((torch.where(live, gid, dummy),), key)
    real = torch.arange(c, device=dev) < lead.sum()
    gkey = torch.where(real, gkey[:c], 0)
    gs, gw = gkey // w, gkey % w
    res = torch.zeros(c, dtype=acc.dtype, device=dev)
    for b0 in range(0, length, TIME_LANE_BLOCK):
        bl = min(TIME_LANE_BLOCK, length - b0)
        lanes = start + b0 + torch.arange(bl, device=dev)
        g = torch.cat([plane[gs[:, None], lanes[None, :], gw[:, None]],
                       plane.new_zeros(1, bl)])           # [C + 1, bl]
        lo = start + b0
        blk = live & (slot >= lo) & (slot < lo + bl)
        g.index_put_((torch.where(blk, gid, dummy),
                      (slot - lo).clamp(0, bl - 1)), d_vals)
        res |= _or_lanes(g[:c])
    return _set_cells(acc, (gs, gw), real, res)


def adjusted_selected_counts(plane: torch.Tensor, row_idx: torch.Tensor,
                             d_rows: torch.Tensor, d_words: torch.Tensor,
                             d_vals: torch.Tensor) -> torch.Tensor:
    """Selected-row popcounts of base+delta, shard axis reduced in int32:
    int32[N] for the plane row slots ``row_idx`` (a CPU int32[N] tensor,
    as ``selected_row_counts`` takes it).  Each cell adds its diff to
    EVERY output lane of its slot, so repeated slots answer alike."""
    sel = kernels.selected_row_counts(plane, row_idx).sum(
        0, dtype=torch.int32)                               # int32[N]
    diff, slot = _cell_diffs(plane, d_rows, d_words, d_vals, None)
    idx = row_idx.to(device=plane.device, dtype=slot.dtype,
                     non_blocking=True)
    match = slot[:, None] == idx[None, :]                   # [C_pad, N]
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    add = torch.where(match, diff[:, None], zero).sum(0, dtype=torch.int32)
    return sel + add


# ---------------------------------------------------------------------------
# BSI split: base with the touched columns excluded + merged mini plane
# ---------------------------------------------------------------------------


def bsi_sides(plane: torch.Tensor, filter_words, overlay):
    """base+delta as ``[(plane, filter), ...]`` sides: the clean plane
    alone without an overlay, else the base with the touched word
    columns excluded plus the merged mini plane."""
    if overlay is None:
        return [(plane, filter_words)]
    return [
        (plane, bsi_excl_filter(plane, overlay.col_shard, overlay.col_word,
                                filter_words, overlay.n)),
        (bsi_mini_plane(plane, overlay.col_shard, overlay.col_word,
                        overlay.col_vals, overlay.col_mask),
         bsi_mini_filter(plane, overlay.col_shard, overlay.col_word,
                         filter_words))]


def bsi_excl_filter(plane: torch.Tensor, col_shard: torch.Tensor,
                    col_word: torch.Tensor, filter_words, n: int):
    """The base side's filter int32[S, W]: ``filter_words`` (all-ones when
    absent) with every touched word column zeroed; the mini plane answers
    those.  Only the ``n`` live lanes scatter: a pad lane's shard index
    ``S`` is out of range, a device-side assert on the card, where JAX
    dropped it."""
    s, _, w = plane.shape
    out = (torch.full((s, w), -1, dtype=torch.int32, device=plane.device)
           if filter_words is None else filter_words.clone())
    out[col_shard[:n].long(), col_word[:n].long()] = 0
    return out


def bsi_mini_plane(plane: torch.Tensor, col_shard: torch.Tensor,
                   col_word: torch.Tensor, col_vals: torch.Tensor,
                   col_mask: torch.Tensor) -> torch.Tensor:
    """The mini side: each touched word column as a one-word shard of a
    standalone BSI plane int32[K, rows, 1], overlay words where touched
    and base words elsewhere.  Pad lanes read shard 0 (clamped); the mini
    filter zeroes them."""
    cs = col_shard.long().clamp(0, plane.shape[0] - 1)
    base_cols = plane[cs, :, col_word.long()]              # [K, rows]
    return torch.where(col_mask != 0, col_vals, base_cols)[..., None]


def bsi_mini_filter(plane: torch.Tensor, col_shard: torch.Tensor,
                    col_word: torch.Tensor, filter_words) -> torch.Tensor:
    """The mini side's filter int32[K, 1]: the caller's filter word at each
    touched column (all-ones when absent), zero on pad lanes."""
    s = plane.shape[0]
    valid = torch.where(col_shard < s, -1, 0).to(torch.int32)
    if filter_words is not None:
        cs = col_shard.long().clamp(0, s - 1)
        valid = valid & filter_words[cs, col_word.long()]
    return valid[:, None]
