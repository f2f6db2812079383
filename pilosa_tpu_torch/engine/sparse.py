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

Under a placement the CSR arrays are built per block
(``PlaneCache._build_sparse``): word indices local to the block's filter
words, so each block's gather stays on its device; the blocks' partial
counts sum on the first device (the reference's ``psum``) and the top k
runs there.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.engine.kernels import top_n


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
    ascending slot order as ``lax.top_k`` gives them
    (:func:`~pilosa_tpu_torch.engine.kernels.top_n`)."""
    return top_n(_counts(filter_words, word_idx, mask, row_ptr), k)


def sparse_row_counts_meshed(filter_words, word_idx, mask,
                             row_ptr) -> torch.Tensor:
    """Exact int32[R_pad] counts on the first device from per-block
    partials: ``filter_words`` a blocked int32[S, W] bitmap, the CSR
    arrays one per block (``PerBlock`` ``word_idx`` / ``mask`` [N_pad],
    ``row_ptr`` [R_pad + 1], every block's padded alike)."""
    parts = filter_words.map(_counts, filter_words, word_idx, mask, row_ptr)
    return filter_words.total(parts)


def topn_sparse_meshed(filter_words, word_idx, mask, row_ptr, k: int):
    """:func:`topn_sparse` over per-block CSR arrays: the partial counts
    summed on the first device, then the same stable top k."""
    return top_n(sparse_row_counts_meshed(filter_words, word_idx, mask,
                                          row_ptr), k)
