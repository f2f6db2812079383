"""Ingest while serving: device delta overlays over resident planes."""

from pilosa_tpu_torch.ingest.delta import (DeltaMirror, DeltaOverlay,
                                           adjusted_row_counts,
                                           adjusted_selected_counts)

__all__ = ["DeltaMirror", "DeltaOverlay", "adjusted_row_counts",
           "adjusted_selected_counts"]
