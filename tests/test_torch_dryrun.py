"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``launch/dryrun.py``, on the CPU.

The reference module sets ``XLA_FLAGS`` (512 host devices) when it is
imported, so every value of it comes from one ``subrun`` that imports it
in a fresh process: ``parallelism_for`` for the 10 archs x {16x16,
2x16x16} x {train, prefill, decode}, ``all_cells()``, ``cache_specs`` for
every arch x mesh x ``batch_shardable``, and the unrolled cost pass's
FLOPs of a reduced train cell on a 4x2 mesh (its ``flops_global_exact``).

  * the layout rules and the cell list equal the reference's;
  * ``cache_specs`` equals the reference's leaf for leaf;
  * a reduced train cell's FLOPs are within the band [0.5, 1.1] of the
    reference's: FlopCounterMode counts matrix products and the kernels'
    formulas only, XLA every elementwise op as well (norms, softmax,
    rope, the optimizer), which would put the port below; the port's
    chunked attention and loss chunks run their products on whole
    chunks where XLA's lowering trims some, which puts it a little above
    (1.002 at this cell);
  * the counting mesh's collective bytes of a reduced 4x1 FSDP train step
    equal a formula over its specs and leaves;
  * the flash and ``pairwise`` meta routes count 4 B H dh L (L + 1) / 2
    and 2 nx ny d, launch nothing, and the pointwise shortcut of the cost
    mode gives the meta kernels' shapes and dtypes on a whole cell;
  * ``run_cell`` for one cell of each kind (train, prefill, decode,
    long_500k, both selects) at reduced size carries every field of the
    reference's record, and the CLI writes them as JSONL;
  * the depth cut: a cell counted from one and two periods equals the
    cell run at full depth.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.registry import (Model, cache_specs,  # noqa: E402
                                         param_specs)
from repro_torch.train import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("arch", "shape", "mesh", "chips", "compile_s", "flops_per_device",
          "bytes_per_device", "flops_global_exact", "bytes_global_exact",
          "cost_pass_error", "collective_bytes_per_device", "mem")
MEM = ("argument_gb", "output_gb", "temp_gb", "alias_gb")
SMALL = dict(kind="train", seq=64, batch=16, microbatches=2)

REFERENCE = r"""
import json
import numpy as np
import repro.launch.dryrun as D     # sets XLA_FLAGS before jax starts
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, get_config, reduced
from repro.launch.mesh import make_production_mesh
from repro.models.registry import build_model
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.train_step import make_train_step
from repro.util import unroll_scans

def spec(s):
  return [list(e) if isinstance(e, tuple) else e for e in s]

out = {"par": {}, "cache": {}, "cells": [list(c) for c in D.all_cells()]}
for multi in (False, True):
  mesh = make_production_mesh(multi_pod=multi)
  for arch in ARCHS:
    cfg = get_config(arch)
    for kind in ("train", "prefill", "decode"):
      par = D.parallelism_for(cfg, mesh, kind)
      out["par"][f"{arch}/{multi}/{kind}"] = {
          k: (list(v) if isinstance(v, tuple) else v)
          for k, v in vars(par).items()}
    model = build_model(cfg)
    par = D.parallelism_for(cfg, mesh, "decode")
    for bs in (True, False):
      tree = model.cache_specs(par, batch_shardable=bs)
      flat = jax.tree_util.tree_flatten_with_path(
          tree, is_leaf=lambda x: isinstance(x, P))[0]
      out["cache"][f"{arch}/{multi}/{bs}"] = {
          "/".join(str(getattr(k, "key", k)) for k in path): spec(s)
          for path, s in flat}

# the unrolled cost pass of a reduced train cell on a 4x2 mesh
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
cfg = reduced(get_config("qwen3-4b"))
model = build_model(cfg, remat="full")
par = D.parallelism_for(cfg, mesh, "train")
params_s = jax.eval_shape(model.init, jax.random.PRNGKey(0))
pspecs = model.param_specs(par)
opt_s = jax.eval_shape(init_opt_state, params_s)
ospecs = type(opt_s)(P(), pspecs, pspecs)
mb, b, s = SMALL["microbatches"], SMALL["batch"], SMALL["seq"]
SDS = jax.ShapeDtypeStruct
batch_s = {k: SDS((mb, b // mb, s), np.int32 if k != "mask" else np.float32)
           for k in ("tokens", "labels", "mask")}
bspecs = {k: P(None, ("data",), None) for k in batch_s}
sh = lambda t: jax.tree.map(lambda x: NamedSharding(mesh, x), t,
                            is_leaf=lambda x: isinstance(x, P))
step = make_train_step(model, OptConfig(), par, microbatches=mb)
with unroll_scans(), mesh:
  lo = jax.jit(lambda *a: step(*a), in_shardings=(sh(pspecs), sh(ospecs),
               sh(bspecs))).lower(params_s, opt_s, batch_s)
out["flops_global_exact"] = float(lo.cost_analysis()["flops"])
print("REF" + json.dumps(out))
""".replace("SMALL", repr(SMALL))


@pytest.fixture(scope="module")
def ref():
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  env.pop("XLA_FLAGS", None)
  out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
  line = [ln for ln in out.stdout.splitlines() if ln.startswith("REF")][-1]
  return json.loads(line[3:])


def _plain(v):
  if isinstance(v, (tuple, list)):
    return [_plain(x) for x in v]
  return v


def _mesh(multi: bool):
  return D.counting_mesh(D.mesh_shape(multi), {})


def test_parallelism_for_equals_the_reference(ref):
  seen = 0
  for multi in (False, True):
    mesh = _mesh(multi)
    for arch in ARCHS:
      for kind in ("train", "prefill", "decode"):
        par = D.parallelism_for(get_config(arch), mesh, kind)
        got = {k: _plain(v) for k, v in dataclasses.asdict(par).items()}
        assert got == ref["par"][f"{arch}/{multi}/{kind}"], (arch, multi,
                                                             kind)
        seen += 1
  assert seen == 60


def test_all_cells_equal_the_reference(ref):
  assert [list(c) for c in D.all_cells()] == ref["cells"]
  assert len(D.all_cells()) == 34


def _entry(e):
  """A spec entry with a one-axis tuple spelled as its axis (("data",) and
  "data" are one layout; the reference's PartitionSpecs carry either)."""
  if isinstance(e, (tuple, list)):
    e = list(e)
    return e[0] if len(e) == 1 else e
  return e


def _flat(tree, prefix=""):
  out = {}
  if tree is None:
    return out
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f"{prefix}{k}/"))
    elif v is not None:
      out[prefix + k] = [_entry(e) for e in v]
  return out


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("batch_shardable", [True, False])
def test_cache_specs_equal_the_reference(ref, multi, batch_shardable):
  mesh = _mesh(multi)
  for arch in ARCHS:
    cfg = get_config(arch)
    par = D.parallelism_for(cfg, mesh, "decode")
    got = _flat(cache_specs(cfg, par, batch_shardable=batch_shardable))
    want = {k: [_entry(e) for e in v] for k, v in
            ref["cache"][f"{arch}/{multi}/{batch_shardable}"].items()}
    assert got == want, arch


def test_train_cell_flops_against_the_reference(ref):
  """Reduced qwen3-4b, a 4x2 mesh, 16 x 64 tokens in 2 microbatches: the
  port's count times the 8 ranks within [0.5, 1.1] of XLA's unrolled
  count (see the module docstring)."""
  cfg = reduced(get_config("qwen3-4b"))
  got = D.model_counts(cfg, SMALL, (4, 2))["flops"] * 8
  ratio = got / ref["flops_global_exact"]
  assert 0.5 <= ratio <= 1.1, ratio


def test_collective_bytes_follow_the_specs():
  """A 4x1 FSDP train step (reduced qwen3-4b, every leaf FSDP, remat off,
  one microbatch) receives: each leaf gathered once in the forward pass
  ((D - 1) shards) and its whole float32 gradient reduce-scattered
  ((D - 1) / D of it); the grad norm's float64 partial sum and the three
  metrics gathered."""
  cfg = reduced(get_config("qwen3-4b"))
  log = {}
  mesh = D.counting_mesh((4, 1), log)
  par = D.parallelism_for(cfg, mesh, "train")
  par = dataclasses.replace(par, min_fsdp_size=1, seq_shard=False)
  model = Model(cfg, device="meta", mesh=mesh, par=par, remat=None)
  assert sorted(model.fsdp) == sorted(model.specs)
  opt = init_opt_state(model)
  step = make_train_step(model, OptConfig())
  batch = D._batch(cfg, 2, 16)
  log.clear()
  with D.Cost():
    step(opt, batch)
  d = 4
  shards = sum(p.numel() * p.element_size() for p in model.parameters())
  wholes = sum(p.numel() * 4 for p in model.parameters()) * d
  assert log["all-gather"] == (d - 1) * (shards + 8 + 3 * 4)
  assert log["reduce-scatter"] == (d - 1) * wholes // d
  assert set(log) == {"all-gather", "reduce-scatter"}


def test_meta_routes_count_the_bound_formulas_and_launch_nothing():
  ops.reset_launch_counts()
  b, h, hkv, length, dh = 2, 8, 2, 1000, 64
  q = torch.empty((b, h, length, dh), dtype=torch.bfloat16, device="meta")
  k = torch.empty((b, hkv, length, dh), dtype=torch.bfloat16, device="meta")
  cost = D.Cost()
  with cost:
    out = ops.flash_attention(q, k, k, causal=True)
  assert out.shape == q.shape and out.dtype == q.dtype
  assert cost.flops == 4 * b * h * dh * length * (length + 1) // 2
  x = torch.empty((300, 48), device="meta")
  y = torch.empty((5, 700, 48), device="meta")
  cost = D.Cost()
  with cost:
    s = ops.pairwise(x, y, kernel="linear")
  assert s.shape == (5, 300, 700) and s.dtype == torch.float32
  assert cost.flops == 2 * 5 * 300 * 700 * 48
  assert all(v == 0 for v in ops.launch_counts().values())


def test_pointwise_shortcut_matches_the_meta_kernels():
  """Every pointwise op of a reduced MoE train cell and a hybrid prefill,
  its shape and dtype from ``_pointwise`` checked against the op's own
  meta kernel (``Cost(check=True)`` raises on a difference)."""
  for arch, sh in (("deepseek-moe-16b", dict(SMALL, seq=256)),
                   ("recurrentgemma-2b", dict(kind="prefill", seq=64,
                                              batch=4))):
    cfg = reduced(get_config(arch))
    mesh = D.counting_mesh((2, 2), {})
    par = D.parallelism_for(cfg, mesh, sh["kind"])
    args, fn = D._model_cell(cfg, sh, mesh, par, cfg.n_periods)
    with D.Cost(check=True):
      fn()


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", "train_4k"), ("llama-3.2-vision-90b", "prefill_32k"),
    ("whisper-tiny", "decode_32k"), ("mamba2-2.7b", "long_500k"),
    ("greedi-select", "select_1m"), ("greedi-select", "select_1m_fast")])
def test_run_cell_fields_at_reduced_size(arch, shape):
  for multi in (False, True):
    rec = D.run_cell(arch, shape, multi_pod=multi, verbose=False, small=True)
    assert tuple(rec) == FIELDS
    assert tuple(rec["mem"]) == MEM
    assert rec["mesh"] == ("2x2x2" if multi else "2x2")
    assert rec["chips"] == (8 if multi else 4)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["flops_global_exact"] == rec["flops_per_device"] * rec[
        "chips"]
    assert rec["mem"]["argument_gb"] > 0 and rec["mem"]["alias_gb"] == 0
    assert rec["collective_bytes_per_device"]
    assert rec["cost_pass_error"] is None


def test_depth_cut_equals_the_full_depth():
  """Reduced llama-3.2-vision-90b with three periods of its five-block
  pattern: the counts from one and two periods equal the run at three."""
  cfg = dataclasses.replace(reduced(get_config("llama-3.2-vision-90b")),
                            n_layers=15)
  sh = dict(kind="prefill", seq=32, batch=4)
  got = D.model_counts(cfg, sh, (2, 2))
  log = {}
  mesh = D.counting_mesh((2, 2), log)
  par = D.parallelism_for(cfg, mesh, "prefill")
  want = D._measure(*D._model_cell(cfg, sh, mesh, par, cfg.n_periods), log)
  for key in ("flops", "bytes", "args"):
    assert got[key] == want[key], key
  for key in want:
    if key.startswith("coll/"):
      assert got[key] == want[key], key


def test_cli_writes_the_records(tmp_path, capsys):
  out = tmp_path / "cells.jsonl"
  D.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh", "both",
          "--reduced", "--out", str(out)])
  recs = [json.loads(line) for line in out.read_text().splitlines()]
  assert [r["mesh"] for r in recs] == ["2x2", "2x2x2"]
  assert "all 2 records OK" in capsys.readouterr().out


def test_param_specs_of_a_cut_model_are_the_whole_models():
  """``Model(periods=)``: a model cut to one period is laid out as the
  whole model (the FSDP threshold sees every period)."""
  cfg = get_config("deepseek-moe-16b")
  mesh = D.counting_mesh((16, 16), {})
  par = D.parallelism_for(cfg, mesh, "train")
  cut = dataclasses.replace(cfg, n_layers=1)
  whole = param_specs(cfg, par)
  got = param_specs(cut, par, periods=cfg.n_periods)
  assert got == {n: s for n, s in whole.items() if n in got}
  assert param_specs(cut, par) != got   # the router crosses the threshold
