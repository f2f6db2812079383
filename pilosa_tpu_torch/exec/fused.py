"""Planned call trees and the serving families over the hand kernels.

The counterpart of ``pilosa_tpu.exec.fused``: the executor plans a
bitmap call tree into a hashable node structure plus a list of leaf
tensors, and one family call answers a whole batch.  PyTorch runs
eagerly, so there is no program cache: each family folds the tree with
torch bitwise ops and calls the popcount kernels of
:mod:`pilosa_tpu_torch.engine.kernels` directly.

Node encodings (nested tuples):

    ("leaf", i)                                   leaf i: int32[S, W] words
    ("and"|"or"|"andnot"|"xor", (child, ...))     fold left
    ("not", child, i_exists)                      exists & ~child
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.engine.words import pow2_bucket
from pilosa_tpu_torch.ingest.delta import (adjusted_row_counts,
                                           adjusted_selected_counts)

_BINARY = {"and": kernels.intersect, "or": kernels.union,
           "andnot": kernels.difference, "xor": kernels.xor}


def _build(node, leaves):
    kind = node[0]
    if kind == "leaf":
        return leaves[node[1]]
    if kind in _BINARY:
        op = _BINARY[kind]
        acc = _build(node[1][0], leaves)
        for child in node[1][1:]:
            acc = op(acc, _build(child, leaves))
        return acc
    if kind == "not":
        return kernels.complement(_build(node[1], leaves), leaves[node[2]])
    raise AssertionError(f"bad node {node!r}")


def shift_leaves(node, offset: int):
    """Re-index a plan tree's leaf references by ``offset`` (to
    concatenate several plans' leaf lists into one batch)."""
    kind = node[0]
    if kind == "leaf":
        return ("leaf", node[1] + offset)
    if kind in _BINARY:
        return (kind, tuple(shift_leaves(c, offset) for c in node[1]))
    if kind == "not":
        return ("not", shift_leaves(node[1], offset), node[2] + offset)
    raise AssertionError(f"bad node {node!r}")


class FusedCache:
    """The serving families of one executor (stateless: PyTorch runs
    eagerly, so there are no programs to cache)."""

    def run(self, node, leaves, want: str):
        """Evaluate a planned tree: ``want`` is "words" (int32[S, W]) or
        "count" (per-shard int32[S])."""
        words = _build(node, leaves)
        return kernels.count(words) if want == "count" else words

    def run_count_batch(self, nodes: tuple, leaves) -> torch.Tensor:
        """K Count trees -> int32[K, n_shards], one count launch each."""
        return torch.stack([kernels.count(_build(n, leaves))
                            for n in nodes])

    def run_rowcounts_batch(self, flags: tuple, leaves) -> torch.Tensor:
        """K whole-plane row-count items -> int32[K, R_pad]: per item,
        ``row_counts`` over the plane (ANDed with a filter when
        ``flags[k]``), reduced over the shard axis in int32 — exact while
        n_shards * 2^20 < 2^31; callers gate on that.  Leaves alternate
        plane[, filter] per item."""
        rows = []
        i = 0
        for has_filter in flags:
            plane = leaves[i]
            flt = leaves[i + 1] if has_filter else None
            i += 2 if has_filter else 1
            rows.append(kernels.row_counts(plane, flt)
                        .sum(0, dtype=torch.int32))
        return torch.stack(rows)

    def run_selected_counts(self, plane: torch.Tensor, slots: tuple,
                            delta=None) -> torch.Tensor:
        """N selected-row Counts over one plane -> int32[bucket]: the
        width pads to a pow2 bucket by repeating the LAST slot (a sorted
        slot list stays non-decreasing), the shard axis reduces in int32
        (callers gate on the int32-exact shard bound) and callers slice
        the pad off.  ``delta`` (an ``ingest.delta.DeltaOverlay``) merges
        the plane's pending write cells: base+delta."""
        bucket = pow2_bucket(len(slots))
        padded = tuple(slots) + (slots[-1],) * (bucket - len(slots))
        idx = torch.tensor(padded, dtype=torch.int32)  # host slot list
        if delta is not None:
            return adjusted_selected_counts(plane, idx, delta.rows,
                                            delta.words, delta.vals)
        return kernels.selected_row_counts(plane, idx).sum(
            0, dtype=torch.int32)

    def run_rowcounts_delta(self, plane: torch.Tensor, delta,
                            filter_words: torch.Tensor | None = None,
                            reduce: bool = True) -> torch.Tensor:
        """Whole-plane per-row counts of base+delta: the clean
        ``row_counts`` scan of the unchanged base plus the overlay's
        per-cell adjustment -> int32[R_pad] (``reduce``; callers gate on
        the int32-exact shard bound) or int32[S, R_pad]."""
        return adjusted_row_counts(plane, delta.rows, delta.words,
                                   delta.vals, filter_words,
                                   reduce_shards=reduce)
