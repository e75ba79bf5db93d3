"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs`` on the CPU: the same update sequence gives byte-equal
Prometheus text, stats lines and ``--stats-json`` payloads; spans emit
JSONL only while enabled (inside a ``torch.profiler`` record of the same
name) and measure their wall clock always; the sidecar answers every
request with the reference sidecar's status and body; a stacked
four-shard service with obs fully on carries the series and spans of the
reference's acceptance test (``tests/test_obs.py``); the batcher's
counters reconcile with its stats.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs.metrics import Registry as JRegistry  # noqa: E402
from repro.service.heartbeat import HeartbeatBoard as JBoard  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs.metrics import Registry as TRegistry  # noqa: E402
from repro_torch.service import (QueryBatcher, QueryRequest,  # noqa: E402
                                 SelectionService)
from repro_torch.service.heartbeat import HeartbeatBoard as TBoard  # noqa: E402,E501

D = 16


def _feed(reg):
  """One update sequence: labels, several kinds, float and int values,
  a histogram with default and custom buckets, an infinite gauge."""
  c = reg.counter("repro_queries_total", "queries answered, by tier")
  c.inc(tier="sieve")
  c.inc(3, tier="exact")
  c.inc(0.5, tier="sieve")
  reg.counter("plain_total").inc(7)
  g = reg.gauge("repro_epoch_eval_mass", "per-shard live rows")
  for i, v in enumerate((252, 250.5, 0, 1e-9)):
    g.set(v, shard=i)
  reg.gauge("inf_gauge").set(float("inf"))
  h = reg.histogram("repro_epoch_wall_seconds", "epoch wall")
  for v in (5e-5, 0.002, 0.7, 12.0, 100.0):
    h.observe(v)
  h2 = reg.histogram("lat", "", buckets=(0.1, 1.0))
  h2.observe(0.05, path="single")
  h2.observe(3.0, path="batch")


def test_registry_and_exports_are_byte_equal(tmp_path, monkeypatch):
  jr, tr = JRegistry(), TRegistry()
  _feed(jr)
  _feed(tr)
  assert tr.snapshot() == jr.snapshot()
  assert obs.prometheus_text(tr) == jobs.prometheus_text(jr)
  fields = dict(epoch=3, wall_s=0.12345, warm=True, mode="service",
                tiny=1.5e-7, big=123456.0, zero=0.0, neg=-2.5, n=None)
  assert obs.stats_line("epoch", **fields) == jobs.stats_line("epoch",
                                                              **fields)
  monkeypatch.setattr(jexport, "REGISTRY", jr)
  monkeypatch.setattr(texport, "REGISTRY", tr)
  records = [{"event": "epoch", "f": 0.25}, {"event": "done", "docs": 8}]
  jexport.write_stats_json(str(tmp_path / "j.json"), records, tool="t", n=4)
  texport.write_stats_json(str(tmp_path / "t.json"), records, tool="t", n=4)
  assert (tmp_path / "t.json").read_bytes() == (
      tmp_path / "j.json").read_bytes()
  # kind checks and the counter's monotonicity, as the reference's
  with pytest.raises(TypeError):
    tr.gauge("plain_total")
  with pytest.raises(ValueError):
    tr.counter("plain_total").inc(-1)
  tr.reset()
  assert tr.snapshot() == {}


def test_spans_emit_only_when_enabled_and_time_always(tmp_path):
  trace = tmp_path / "trace.jsonl"
  assert not obs.enabled()
  with obs.span("unit.before") as sp:
    time.sleep(0.01)
  assert sp.wall_s >= 0.01
  obs.enable(trace_out=str(trace))
  try:
    assert obs.enabled() and obs.trace_out_path() == str(trace)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
      with obs.span("unit.during", k=2) as sp:
        sp.add(extra="yes")
        torch.ones(4).sum()
  finally:
    obs.disable()
  assert not obs.enabled() and obs.trace_out_path() is None
  with obs.span("unit.after") as sp_after:
    pass
  assert sp_after.wall_s >= 0.0
  recs = [json.loads(line) for line in trace.read_text().splitlines()]
  assert [r["name"] for r in recs] == ["unit.during"]
  (r,) = recs
  assert set(r) == {"name", "ts", "dur_s", "pid", "tid", "attrs"}
  assert r["attrs"] == {"k": 2, "extra": "yes"} and r["dur_s"] >= 0
  # the annotation: the span is a profiler record of its own name
  assert "unit.during" in {e.key for e in prof.key_averages()}


def _http(url, data=None):
  try:
    with urllib.request.urlopen(url, data=data, timeout=10) as r:
      return r.status, r.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode()


def test_sidecar_answers_like_the_reference():
  """GET /metrics and /healthz, POST beats by query and by JSON body into
  the board, 404s, a 400 for a bad shard and the reference's 503 for a
  beat without a board: the same status and body from both sidecars, on
  127.0.0.1 at a free port."""
  t = [100.0]
  clock = lambda: t[0]  # noqa: E731
  boards = (JBoard(4, clock=clock), TBoard(4, clock=clock))
  regs = (JRegistry(), TRegistry())
  for reg in regs:
    reg.counter("demo_total").inc(7)
  with jobs.Sidecar(board=boards[0], registry=regs[0]) as js, \
      obs.Sidecar(board=boards[1], registry=regs[1]) as ts:
    assert ts.url.startswith("http://127.0.0.1:") and ts.port > 0
    for b in boards:
      b.fail(2)
    t[0] += 2.0
    steps = [("/metrics", None), ("/metrics", None), ("/healthz", None),
             ("/healthz?shard=2", b""), ("/healthz", None),
             ("/healthz", json.dumps({}).encode()), ("/healthz", None),
             ("/healthz?shard=bogus", b""), ("/nope", None),
             ("/nope", b""), ("/metrics", None)]
    for path, data in steps:
      jcode, jbody = _http(js.url + path, data)
      tcode, tbody = _http(ts.url + path, data)
      assert tcode == jcode, (path, tcode, jcode)
      assert tbody == jbody, (path, tbody, jbody)
      np.testing.assert_array_equal(boards[1].ages(), boards[0].ages())
  with jobs.Sidecar(board=None) as js, obs.Sidecar(board=None) as ts:
    for path, data in (("/healthz", b""), ("/healthz", None)):
      jcode, jbody = _http(js.url + path, data)
      tcode, tbody = _http(ts.url + path, data)
      assert (tcode, tbody) == (jcode, jbody)
    assert _http(ts.url + "/healthz", b"")[0] == 503
    assert "shards" not in json.loads(_http(ts.url + "/healthz")[1])


def _unit(seed, n):
  r = np.random.default_rng(seed)
  x = r.normal(size=(n, D))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_service_with_obs_on_carries_the_series_and_spans(tmp_path):
  """The reference's acceptance run (tests/test_obs.py), four stacked
  shards on the CPU with obs fully on: one eval-mass gauge a shard,
  admissions > 0, three epochs, the merge-peak gauges, lazy rescans;
  spans service.epoch x3 (epochs 0, 1, 2), service.query x3,
  service.query_batch x4, each record with the reference's keys."""
  trace = tmp_path / "svc_trace.jsonl"
  obs.REGISTRY.reset()
  obs.enable(trace_out=str(trace))
  try:
    svc = SelectionService(m=4, d=D, kappa=8, k_final=8, capacity=1024,
                           append_block=128, seed=0, device="cpu")
    svc.append(_unit(0, 256))
    b0 = svc.query_batch([QueryRequest(k=2 + j) for j in range(5)])
    assert all(r.source == "sieve" for r in b0)
    for i in range(3):
      svc.epoch()
      svc.query(k=4, seed=i)
      svc.query_batch([QueryRequest(k=2 + j) for j in range(5)])
      svc.append(_unit(1 + i, 64))
    snap = obs.REGISTRY.snapshot()
  finally:
    obs.disable()
  mass = snap["repro_epoch_eval_mass"]["series"]
  assert len(mass) == 4 and sum(s["value"] for s in mass) > 0
  assert sorted(s["labels"]["shard"] for s in mass) == ["0", "1", "2", "3"]
  rows = snap["repro_merge_peak_rows"]["series"]
  assert [s["value"] for s in rows] == [4 * 8] * 4
  assert snap["repro_merge_peak_bytes"]["series"][0]["value"] == 4 * 8 * D * 4
  assert snap["repro_lazy_tile_rescans_total"]["series"][0]["value"] > 0
  adm = snap["repro_sieve_admissions_total"]["series"]
  assert adm and adm[0]["value"] > 0
  assert "repro_sieve_rejections_total" in snap
  assert "repro_sieve_grid_level" in snap
  assert snap["repro_epochs_total"]["series"][0]["value"] == 3
  assert "repro_epoch_retraces" not in snap
  chunks = snap["repro_append_chunks_total"]["series"][0]["value"]
  assert chunks == 2 + 3 and snap["repro_append_rows_total"][
      "series"][0]["value"] == 256 + 3 * 64
  tiers = {s["labels"]["tier"]: s["value"]
           for s in snap["repro_queries_total"]["series"]}
  # the first batch and the seeded queries (seeds 1, 2) take the sieve;
  # seed 0 and the default requests after each epoch take the epoch's
  assert tiers == {"sieve": 5 + 2, "epoch": 1 + 3 * 5}
  assert snap["repro_alive_shards"]["series"][0]["value"] == 4
  recs = [json.loads(line) for line in trace.read_text().splitlines()]
  names = [r["name"] for r in recs]
  assert names.count("service.epoch") == 3
  assert names.count("service.query") == 3
  assert names.count("service.query_batch") == 4
  for r in recs:
    assert set(r) == {"name", "ts", "dur_s", "pid", "tid", "attrs"}
  epochs = [r for r in recs if r["name"] == "service.epoch"]
  assert [e["attrs"]["epoch"] for e in epochs] == [0, 1, 2]
  assert all(e["attrs"]["warm"] in (True, False) for e in epochs)
  q = [r for r in recs if r["name"] == "service.query"]
  assert [r["attrs"]["tier"] for r in q] == ["epoch", "sieve", "sieve"]
  assert all(r["attrs"]["k"] == 4 and "stale" in r["attrs"] for r in q)


def test_service_with_obs_off_reads_no_device_series():
  """With obs off the host series are fed and the device-fed ones are
  not (nothing was read back for them)."""
  obs.REGISTRY.reset()
  assert not obs.enabled()
  svc = SelectionService(m=2, d=D, kappa=4, k_final=4, capacity=256,
                         append_block=64, seed=0, device="cpu")
  svc.append(_unit(5, 200))
  r = svc.epoch()
  svc.query()
  snap = obs.REGISTRY.snapshot()
  assert snap["repro_epochs_total"]["series"][0]["value"] == 1
  assert snap["repro_append_chunks_total"]["series"][0]["value"] == 4
  assert snap["repro_epoch_wall_seconds"]["series"][0]["count"] == 1
  assert snap["repro_epoch_value"]["series"][0]["value"] == pytest.approx(
      r.stats.value)
  for name in ("repro_epoch_eval_mass", "repro_merge_peak_rows",
               "repro_sieve_admissions_total",
               "repro_lazy_tile_rescans_total"):
    assert name not in snap, name


def test_heartbeats_and_batcher_feed_the_registry(tmp_path):
  """Beats count by source and shard; the batcher's registry counters move
  with its own stats, and every drain is a batcher.drain span."""
  reg = obs.REGISTRY
  beats = reg.counter("repro_heartbeats_total")
  b0 = beats.get(source="sidecar", shard=1)
  board = TBoard(3)
  board.beat(1, source="sidecar")
  board.beat()
  board.fail(2)
  assert beats.get(source="sidecar", shard=1) == b0 + 1
  assert beats.get(source="inproc", shard="all") >= 1
  assert reg.counter("repro_heartbeat_failures_total").get(shard=2) >= 1
  svc = SelectionService(m=1, d=D, kappa=8, k_final=8, capacity=512,
                         append_block=128, seed=0, device="cpu")
  svc.append(_unit(7, 256))
  svc.query_batch([QueryRequest()])
  req0 = reg.counter("repro_batcher_requests_total").get()
  bat0 = reg.counter("repro_batcher_batches_total").get()
  trace = tmp_path / "drain.jsonl"
  obs.enable(trace_out=str(trace))
  try:
    with QueryBatcher(svc, max_batch=4, max_delay_s=0.02) as qb:
      futs = [qb.submit(QueryRequest(k=1 + i % 8)) for i in range(10)]
      for f in futs:
        f.result(timeout=60)
  finally:
    obs.disable()
  st = qb.stats
  drains = [json.loads(line) for line in trace.read_text().splitlines()
            if json.loads(line)["name"] == "batcher.drain"]
  assert len(drains) == st.batches
  assert sum(d["attrs"]["occupancy"] for d in drains) == 10
  assert all(d["attrs"]["tier"] == "sieve" for d in drains)
  assert st.submitted == st.served == 10 and st.batches >= 3
  assert st.mean_occupancy * st.batches == pytest.approx(st.served)
  assert reg.counter("repro_batcher_requests_total").get() - req0 == 10
  assert reg.counter("repro_batcher_batches_total").get() - bat0 == \
      st.batches
  occ = reg.gauge("repro_batcher_occupancy").get()
  assert 1 <= occ <= 4
  wall = reg.histogram("repro_batcher_drain_wall_seconds").get()
  assert wall["count"] >= st.batches
