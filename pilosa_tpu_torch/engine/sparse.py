"""Per-row counts over a sparse (CSR) residency
(``pilosa_tpu.engine.sparse``), in plain PyTorch.

A field with millions of sparse rows cannot live as a dense plane (5M
rows x 128 KiB per shard); :class:`~pilosa_tpu_torch.exec.planes.SparseSet`
keeps its set bits instead, sorted by row::

    word_idx int32[N_pad]    flat index of each bit's word in the
                             flattened (n_shards * W) filter
    mask     int32[N_pad]    the bit's uint32 lane mask (0 for padding)
    row_ptr  int32[R_pad+1]  row boundaries (pad rows repeat N)

``TopN(filter)`` gathers the filter word of every bit, tests the bit, and
sums each row's segment as a cumulative sum and a boundary difference (the
reference's form: a scatter-add serializes on the TPU).  The reference
computes this in XLA, not Pallas: it is no TPU kernel, and runs here as
torch operations on the card.
"""

from __future__ import annotations

import torch


def _counts(filter_words: torch.Tensor, word_idx: torch.Tensor,
            mask: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """int32[R_pad]: each row's |row & filter|.  The masks carry uint32
    bits in int32, so lane 31 is negative: a hit is ``!= 0``."""
    flat = filter_words.reshape(-1)
    hits = ((torch.index_select(flat, 0, word_idx) & mask) != 0).to(
        torch.int32)
    cum = torch.zeros(hits.numel() + 1, dtype=torch.int32,
                      device=hits.device)
    torch.cumsum(hits, 0, dtype=torch.int32, out=cum[1:])
    ptr = row_ptr.long()
    return cum[ptr[1:]] - cum[ptr[:-1]]


def sparse_row_counts(filter_words: torch.Tensor, word_idx: torch.Tensor,
                      mask: torch.Tensor,
                      row_ptr: torch.Tensor) -> torch.Tensor:
    """Every row's count, int32[R_pad] (tanimoto, ``ids=``, ``attrName=``)."""
    return _counts(filter_words, word_idx, mask, row_ptr)


def topn_sparse(filter_words: torch.Tensor, word_idx: torch.Tensor,
                mask: torch.Tensor, row_ptr: torch.Tensor, k: int):
    """``(values int32[k], slots int64[k])``: the k largest counts, ties in
    ascending slot order as ``lax.top_k`` gives them (``torch.topk`` sets
    no order among equal values, so the values are ranked as unique int64
    keys ``count * R_pad + (R_pad - 1 - slot)``)."""
    counts = _counts(filter_words, word_idx, mask, row_ptr)
    r_pad = counts.numel()
    slot = torch.arange(r_pad, dtype=torch.int64, device=counts.device)
    key = counts.to(torch.int64) * r_pad + (r_pad - 1 - slot)
    top = torch.topk(key, k, sorted=True).values
    return (top // r_pad).to(torch.int32), r_pad - 1 - top % r_pad
