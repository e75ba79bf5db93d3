"""Fixture: a host read-back inside a hot-path loop (T5); the test lints
it as a hot-path module (``ast_lint.HOT_PATH_FILES``).

``pick_bad`` reads the running best back every iteration; ``pick_good`` is
the twin that keeps it on the device and reads it once after the loop.
"""
import torch


def pick_bad(gains: torch.Tensor, steps: int) -> list:
  out = []
  for _ in range(steps):
    j = gains.argmax()
    out.append(j.item())  # BUG: one host sync an iteration
    gains = gains.index_fill(0, j, float("-inf"))
  return out


def pick_good(gains: torch.Tensor, steps: int) -> list:
  picks = []
  for _ in range(steps):
    j = gains.argmax()
    picks.append(j)
    gains = gains.index_fill(0, j, float("-inf"))
  return torch.stack(picks).tolist()  # one read-back after the loop
