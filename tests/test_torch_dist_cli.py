"""``python -m repro_torch.launch.select`` under torchrun on the CPU.

At world 2, ``--mesh 4 --dist-backend gloo --device cpu`` must write the
ids that the single-process ``--mesh 4`` run writes, for the fast and the
``--no-fast`` engines, ``--merge-tree 2`` and the service mode
(``--epochs 2`` with a held-back append, queries and the ``--query-batch``
parity); rank 0 alone prints the ``[select]`` lines, and its ``done`` line
names the world and the collectives.  The four launches run side by side,
each on its own free port (``--standalone``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --n-docs / --dim, the spellings torchrun's parser leaves to the script
BASE = ["--device", "cpu", "--n-docs", "2000", "--dim", "16", "--k", "8",
        "--mesh", "4", "--no-coverage"]
FLAGS = {"fast": [], "generic": ["--no-fast"], "tree2": ["--merge-tree", "2"],
         # the service mode: a held-back append queried in blocks, the
         # query_batch parity on every rank
         "service": ["--epochs", "2", "--append-frac", "0.25",
                     "--query-every", "250", "--query-batch", "4"]}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
  """{name: (exit code, stdout, stderr, ids written, stats records)} of
  the three torchrun runs."""
  tmp = tmp_path_factory.mktemp("dist_cli")
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1")
  procs = {}
  for name, flags in FLAGS.items():
    out = tmp / f"{name}.npy"
    procs[name] = (out, subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.select", *BASE,
         *flags, "--dist-backend", "gloo", "--out", str(out),
         "--stats-json", str(tmp / f"{name}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
  done = {}
  for name, (out, proc) in procs.items():
    stdout, stderr = proc.communicate(timeout=300)
    stats = tmp / f"{name}.json"
    done[name] = (proc.returncode, stdout, stderr,
                  np.load(out) if out.exists() else None,
                  json.loads(stats.read_text())["stats"]
                  if stats.exists() else None)
  return done


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_torchrun_writes_the_single_process_ids(launches, name, tmp_path,
                                                capsys):
  from repro_torch import obs
  from repro_torch.launch import select as cli
  rc, stdout, stderr, ids, stats = launches[name]
  assert rc == 0, stderr
  want = tmp_path / "single.npy"
  cli.main([*BASE, *FLAGS[name], "--out", str(want), "--stats-json",
            str(tmp_path / "single.json")])
  assert not obs.enabled()   # the run turned obs on for its stats, then off
  np.testing.assert_array_equal(ids, np.load(want))
  assert len(set(ids.tolist())) == 8
  done = [ln for ln in stdout.splitlines() if ln.startswith("[select] done")]
  assert len(done) == 1, stdout   # rank 0 alone prints
  assert "world=2" in done[0] and "backend=gloo" in done[0], done[0]
  assert "rank_peak_gib=not measured" in done[0], done[0]
  gathers = int(done[0].split("gathers=")[1].split()[0])
  assert gathers > 0, done[0]
  record = [r for r in stats if r["event"] == "done"]
  assert len(record) == 1 and record[0]["world"] == 2
  assert record[0]["gathers"] == gathers
  if name == "service":
    # growth and every epoch move rows between the ranks
    assert record[0]["exchanges"] > 0 and record[0]["exchange_bytes"] > 0
    assert record[0]["mode"] == "service"
    events = [r["event"] for r in stats]
    assert events.count("epoch") == 2 and events.count("query") == 2
    assert events.count("query_batch") == 2
  single = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[select] done")]
  assert "world=" not in single[0]
