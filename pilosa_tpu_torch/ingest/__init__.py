"""Ingest while serving: device delta overlays over resident planes."""

from pilosa_tpu_torch.ingest.delta import (BsiOverlay, DeltaMirror,
                                           DeltaOverlay,
                                           adjusted_row_counts,
                                           adjusted_selected_counts)

__all__ = ["BsiOverlay", "DeltaMirror", "DeltaOverlay",
           "adjusted_row_counts", "adjusted_selected_counts"]
