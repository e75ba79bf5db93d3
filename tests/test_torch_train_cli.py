"""The port's training entry points on the CPU: ``launch/train.py`` with
``--select-coreset`` (the reference's selection sizes: 4096 documents of
width 64, m = 8, kappa = 256, k_final = 1024), run twice so the second run
resumes, and the two examples at their smallest flags.  The checks are the
entry points' own contracts (the resume step, the checkpoints kept, the
coreset carried across the restart, finite losses, the shard that dies);
the numbers against the reference are tests/test_torch_train.py's.
"""
import math
import os
import runpy

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _losses(out: str) -> list[float]:
  return [float(line.split("loss")[1].split()[0])
          for line in out.splitlines() if line.startswith("[train] step")]


def test_launcher_selects_a_coreset_and_resumes(tmp_path, capsys):
  ck = str(tmp_path / "ck")
  argv = ["--reduced", "--device", "cpu", "--select-coreset", "--seq-len",
          "32", "--ckpt-every", "3", "--ckpt-dir", ck]
  launch_train.main(argv + ["--steps", "6"])
  first = capsys.readouterr().out
  assert "[train] GreeDi selected 1024 / 4096 docs" in first
  assert "resumed" not in first
  assert CheckpointManager(ck).all_steps() == [3, 6]
  launch_train.main(argv + ["--steps", "9"])
  second = capsys.readouterr().out
  assert "[train] resumed from step 6" in second
  # the coreset rides in the checkpoint: the restart does not select again
  assert "GreeDi selected" not in second
  assert "[train] done: steps 6..9 on cpu" in second
  assert CheckpointManager(ck).all_steps() == [3, 6, 9]
  _, meta = CheckpointManager(ck).restore({}, step=9)
  assert meta["step"] == 9 and len(set(meta["coreset"])) == 1024
  losses = _losses(first) + _losses(second)
  assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
  # the mesh runs under torchrun only (tests/test_torch_train_dist.py)
  with pytest.raises(SystemExit, match="torchrun"):
    launch_train.main(argv + ["--mesh", "2x2"])


def test_train_with_selection_example(capsys):
  ns = runpy.run_path(os.path.join(EXAMPLES, "train_with_selection_torch.py"),
                      run_name="example")
  ev_core, ev_rand = ns["main"](["--device", "cpu", "--steps", "2",
                                 "--coreset", "16"])
  out = capsys.readouterr().out
  assert "GreeDi selected 16 docs" in out
  assert "coverage = " in out and "eval loss: greedi-coreset" in out
  assert math.isfinite(ev_core) and math.isfinite(ev_rand)


def test_selection_service_example(capsys):
  """Two shards, two epochs: the corpus grows after epoch 0 and a shard
  dies before the last epoch; the run finishes on the survivor."""
  ns = runpy.run_path(os.path.join(EXAMPLES, "selection_service_torch.py"),
                      run_name="example")
  losses, alive = ns["main"](["--device", "cpu", "--mesh", "2", "--epochs",
                              "2", "--steps-per-epoch", "2", "--coreset",
                              "16"])
  out = capsys.readouterr().out
  assert "[service] appended 1024 docs" in out
  assert "alive=2/2" in out and "alive=1/2" in out
  assert alive == [2, 1]
  assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
  assert "[done] 2 epochs, 4 steps, 2048 docs" in out
