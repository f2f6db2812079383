"""Consistent online backup and elastic restore (``pilosa_tpu.backup``'s).

- :mod:`pilosa_tpu_torch.backup.endpoints`: the ``/internal/backup/*``
  HTTP surface (generation-bracketed fragment images with digests);
- :mod:`pilosa_tpu_torch.backup.manifest`: the archive's
  ``manifest.json``, incremental diffs, digest checks;
- :mod:`pilosa_tpu_torch.backup.driver`: the client-side
  :class:`BackupDriver` (parallel pull, replica fallback, incremental)
  and :class:`RestoreDriver` (routing by the target's placement, a forced
  anti-entropy round).

CLI: ``python -m pilosa_tpu_torch.cli backup --output DIR`` and
``... restore DIR`` (see the README).
"""

from pilosa_tpu_torch.backup.driver import (BackupDriver, BackupError,
                                            RestoreDriver)
from pilosa_tpu_torch.backup.manifest import (DigestError, Manifest,
                                              ManifestError)

__all__ = ["BackupDriver", "RestoreDriver", "BackupError",
           "Manifest", "ManifestError", "DigestError"]
