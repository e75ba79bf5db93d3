"""Fixture: a per-shard row sum in a fixed-order module (T8); the test
lints it as one (``ast_lint.FIXED_ORDER_FILES``).

``bad_gain`` sums each shard's masked row with ``torch.sum``, whose order
on CUDA follows the shape of the whole tensor (so m stacked shards and the
m / world of a rank would part in their last bits); ``good_gain`` is the
twin routed through ``_row_sum``, whose order depends on the row alone.
"""
import torch


def _row_sum(x: torch.Tensor) -> torch.Tensor:
  return torch.sum(x, dim=-1)  # the fixed-order helper itself is allowed


def bad_gain(new_cov, cov, mask):
  return torch.sum((new_cov - cov) * mask, dim=-1)  # BUG: shape-dependent


def good_gain(new_cov, cov, mask):
  return _row_sum((new_cov - cov) * mask)
