"""Ingest while serving: device delta overlays over resident planes, and
the cluster's replicated bulk import (:mod:`.bulk`)."""

from pilosa_tpu_torch.ingest.bulk import BulkImporter, apply_import_hint
from pilosa_tpu_torch.ingest.delta import (BsiOverlay, DeltaMirror,
                                           DeltaOverlay,
                                           adjusted_row_counts,
                                           adjusted_selected_counts)

__all__ = ["BsiOverlay", "BulkImporter", "DeltaMirror", "DeltaOverlay",
           "adjusted_row_counts", "adjusted_selected_counts",
           "apply_import_hint"]
