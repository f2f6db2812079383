"""Query execution: PQL AST -> hand-written kernels over resident planes."""

from pilosa_tpu_torch.exec.executor import ExecutionError, Executor
from pilosa_tpu_torch.exec.result import (FieldRow, GroupCount,
                                          GroupCountsResult, RowIdsResult,
                                          result_to_json)

__all__ = ["ExecutionError", "Executor", "FieldRow", "GroupCount",
           "GroupCountsResult", "RowIdsResult", "result_to_json"]
