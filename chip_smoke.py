#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, with nothing built: it builds the CUDA kernels
from ``src/repro_torch/kernels/csrc``; checks their edge cases (ragged
sizes, nothing feasible, exact ties, a shared candidate block, a selection
buffer past the shared-memory cross tile) against the plain PyTorch
versions; and drives its paths end to end through the entry points a user
calls, counting each kernel's launches around each path:

  * the coreset path (facility location: ``repro_torch.data.selection`` and
    the ``repro_torch.launch.select`` CLI) at the CLI's default size and at
    full size (n = 262144 embeddings of width 64, k = kappa = 64, m = 16
    stacked shards); at full size also the fast engine's lazy round 1
    against its standard one (the same bits), the accumulation-tree merge
    (tree_branch 16, which must give the flat merge's bits, and 4, in the
    fast and the generic engine) and ``greedi_hierarchical`` over 4 pods x
    4; and the ``torch.distributed`` backend (phase ``e2e dist``): the
    CLI under ``torch.distributed.run`` with 4 gloo ranks on the card (4
    shards a rank; the fast engine flat and at tree b = 4, the generic
    engine flat), each run's ids equal to the stacked run's and each
    rank's peak within a quarter of the stacked peak plus 0.5 GiB, nccl
    with one rank a card where there are 4 cards, and one library run with
    rank 1's shards past the liveness deadline (this script's
    ``--dist-liveness DIR`` mode, one rank of it);
  * the remaining objectives at the coreset path's full size:
    ``FacilityLocationPre`` through ``greedi_reference`` (the cached
    (16, 16384, 16384) block, one ``relu_colsum`` launch a step, 128 in
    all) against the reference path and the fast engine on the same
    partition; the k-medoid surrogate of Eq. (6) (``neg_sq_dist``,
    baseline -1, the generic path: cuBLAS blocks of at most 1 GiB through
    ``relu_colsum``) through ``greedi_reference`` and the generic
    ``greedi_sharded``, and at the CLI's size against the centralized
    greedy (at or above the Thm-4 floor); ``Modular`` through GreeDi and
    the centralized greedy (equal ids);
  * the GP active-set path (information gain, Sec. 6.2 of the paper:
    ``greedi_reference``, the generic ``greedi_sharded`` and
    ``centralized_greedy``) at the data size of the paper's Yahoo! Webscope
    experiment (45,811,883 unit rows of width 6, m = 32, k = kappa = k_max
    = 128, rbf h = 0.75, sigma = 1) and at the Fig. 6 settings (n = 65536
    rows of width 22, m = 10, k = 50, k_max = 80), where the kernels are
    held against the plain versions end to end;
  * saturated coverage (Lin & Bilmes) through ``greedi_reference`` (the
    fused ``coverage_select`` steps) at full size, and at the CLI's size
    beside the centralized greedy and the plain versions;
  * the selection service (``repro_torch.service``) at full size: a
    store growing from capacity 65536 while 75 % of the corpus is
    ingested, three epochs around the last 25 %, warm-started and cold, for
    saturated coverage and facility location (the ``coverage_gain`` lazy
    rescans), and the CLI's service mode once;
  * the service's query path at the same size: the facility service
    ingesting the corpus in 16 appends with its standing sieves (the
    ``csrc/sieve.cu`` admission scan) and without, a ``query()`` after
    each append, 64-request ``query_batch`` calls against the requests
    alone before and after an epoch, the merge through the kernels
    against the plain route, host syncs per append chunk and per query
    tile; the exact tier (a batched greedy over the block) on its own
    store of 16,384 rows, 64 tenants, against the plain route; the same
    ingest with obs off and with obs on (``repro_torch.obs``: spans,
    device-fed series, a ``/metrics`` scrape and a ``POST /healthz`` beat
    through the sidecar, host syncs each way), and the CLI's service mode
    with ``--trace-out`` / ``--stats-json`` in a process of its own;
  * the selection service over processes (phase ``e2e service dist``):
    the CLI's service mode under ``torch.distributed.run`` with 4 gloo
    ranks on the card (4 of the 16 shards a rank, capacity 65536 doubling
    twice, queries after appends, 64-request batches whose parity every
    rank checks, 3 warm epochs), for facility location and saturated
    coverage, against the same command in this process (ids, every
    epoch's f(S), alive, warm and rescans and every query's value
    estimate bit for bit; each rank's peak within a quarter of the
    stacked peak plus 0.5 GiB; nccl with one rank a card where there are
    4 cards), and a library run (this script's ``--dist-service DIR``
    mode, one rank of it) of the service-queries schedule with rank 1's
    shards failed through the heartbeat board before a last epoch, every
    answer equal to the stacked service's (the launches of this phase,
    and the CLI runs and library run of ``e2e dist``, side by side);
  * the graph-cut path of Sec. 5 / 6.3 (non-monotone max-cut, RandomGreedy
    through ``greedi_reference`` with local evaluation, Alg. 3 under a
    partition matroid as ``examples/maxcut_constrained_torch.py`` runs it,
    and ``centralized_greedy`` with the fused node-space select) at the
    Fig. 9 settings on the paper's 1,899-node graph, kernels against the
    plain versions under the same draws, and at n = 36692 nodes and
    183,831 edges (the SNAP email-Enron graph's counts, drawn on the card);
  * the LM serving path (``repro_torch.serve.generate`` over
    ``repro_torch.models.Model``) on qwen3-4b at its published width and
    depth (36 layers, d 2560, 32 query / 8 KV heads, d_ff 9728, vocab
    151936; 4.41 B random parameters from a seed): a float32 prefill with
    the flash-attention kernel against the plain version, then bf16
    serving of 8 prompts of 2048 tokens (64 new each) and one of 6000 (16
    new), greedy, with and without the kernel, and decode against teacher
    forcing;
  * the other model families through the same ``generate`` (phase ``e2e
    families``), one at a time in bf16 from a seed: deepseek-moe-16b (28
    layers, 4 x 2048 -> 16 tokens), grok-1-314b (2 of its 64 layers at
    full width, 4 x 2048 -> 16), mamba2-2.7b (64 layers, 8 x 2048 -> 16),
    recurrentgemma-2b (26 layers, 1 x 4096 -> 16: past its 2048 window, so
    the ring buffer wraps), llama-3.2-vision-90b (10 of its 100 layers, 2
    x 2048 -> 16 over 1601 image tokens) and whisper-tiny (4 + 4 layers, 8
    x 432 -> 16 over 1500 frames): time to first token, ms a token, peak
    memory, the flash launches a prefill (28, 2, 0, 0, 10, 4), greedy
    tokens against the plain version at 2 x 512 -> 8, and decode against
    teacher forcing at the reduced size in float32;
  * the model axis of every family (phase ``e2e families tp``): 4 gloo
    ranks on the card in one torchrun launch (this script's
    ``--families-tp DIR`` mode, one rank of it) serve and train each
    family at full width over a ``--mesh``, beside one-process runs of
    the same depths, seeds and inputs, 4 new tokens a request:
    deepseek-moe-16b over 1x4 with its experts split by width (TP) and
    dealt whole (ep; 28 layers, 2 x 512; trains 4 layers), grok-1-314b
    over 1x4 under ep (2 layers, 2 x 1024; trains at the reduced width),
    mamba2-2.7b over 1x4 (64 layers, 1 x 1024; trains 8),
    llama-3.2-vision-90b over 1x4 (10 layers, 1 x 1024; trains 3),
    recurrentgemma-2b over 2x2 (26 layers, 2 x 3072, past its window;
    trains 3) and whisper-tiny over 2x2 (4 + 4 layers, 8 x 432): greedy
    tokens against one process's up to a bf16 near-tie (the MoE routing
    replayed), every flash launch at the rank's heads against the plain
    version, deepseek's TP and ep logits against each other, the
    replicated leaves bit for bit after each train step and the losses
    within 2e-2 of one process's;
  * the layouts of the reference's dry run (phase ``e2e layouts``, its
    runs inside the ranks of ``e2e train dist`` and ``e2e families tp``):
    qwen3-4b at full width (2 layers) over 2x2 with FSDP and sequence
    sharding for two steps against ``e2e train dist``'s 2x2 run, each FSDP
    leaf's parameter and moments half of that rank's, and the reckoning
    of a 4x1 FSDP rank at full depth; deepseek-moe-16b's 2 layers over pod
    2 x data 1 x model 2 with its experts dealt over the pods (ep_pod),
    and recurrentgemma-2b at batch 1 with its cache split by length over
    2 data ranks, past its window, each against one process; and the dry
    run (``python -m repro_torch.launch.dryrun --mesh both``, 68 records)
    on the host from the build's end, stopped while a phase runs ranks;
  * the training path (``repro_torch.train``, ``launch/train.py
    --select-coreset``): the launcher's coreset step (4096 documents of
    width 64, m = 8, kappa = 256, k_final = 1024) on the facility-select
    kernel against the plain run, then qwen3-4b at full width and depth
    (bf16, 4.41 B random parameters, remat "dots", the AdamW state beside
    them) trained 4 steps at batch 8 x 256 on the coreset's batches (no
    flash launch in a grad step, 36 in an eval step whose loss must be
    within 2e-2 of the first step's), a profile of one step (GEMMs,
    chunked attention, the xent chunks, the optimizer), and the launcher
    at ``--reduced`` run to step 6 and resumed to 9 in processes of its
    own;
  * the port's hazard analyzer (phase ``analysis``,
    ``python -m repro_torch.analysis --ranks 2`` in a process of its own
    from the build's end, beside the edge phases): every
    registered entry point (the 16 oracle entries, the GreeDi engines and
    the service's append / epoch / query calls) run on the CUDA routes
    under its dispatch mode, host syncs counted by dispatch and by the
    card's sync debug mode against each entry's budget (T1), no build in
    a warm call (T4), no float32 matmul under TF32 (T6), the two rank
    entries over 2 gloo ranks on the card (T2, T7), and the AST layer over
    the tree: no new finding.

It holds every kernel against its plain version at the shapes those paths
launch (the flash kernel also at its edges: ragged lengths, every head
width, MHA and GQA, strided inputs, a grid past 65535 rows; bf16 on the
tensor-core kernel, f32 on the FFMA kernel; the pairwise kernel at ragged
nx / ny, d of 6, 17, 22, 36, 64, 128 and 130, a shared x or y block (2-D
or expanded), bf16, misaligned bases and column slices (padded copies),
rows not 16-byte aligned and a batch past one wave of its persistent
blocks, in both ring modes (``ring.plan``: resident to 2 boxes of 128
bytes of d, streamed past them), timed at s11's shape at d of 22, 64, 128,
768 and (16 x 4096 rows) 3072 beside cuBLAS; the facility / coverage
kernel in both ring modes, the mode the rule names required at every
shape and its ``path`` in each row, its round-1 selects also at d of 22,
128, 768 and 3072; the info-gain kernels with
the objectives' selection counts (``live``: count-aware, the live triangle
of linv) and without (dense), at counts 0, partial and full, partitions of
different counts in one launch, a linv with junk past its live triangle,
and shapes past shared memory (d 64 at k 512, d 768 at k 64, k 2100 and
k 5000); the relu column-sum kernel of the fast engine at the round-1
block in a full pass and a 256-column gathered tile (a lazy rescan), at
the round-2 block and at a ragged nl over pitched rows, bit for bit
against its plain version; the sieve admission scan over 4 chunks from
the full-size ingest's state, linear and rbf, bit for bit), counts the CUDA kernels of a graph-cut call
(one a call) and of a relu column-sum call with the profiler, and
profiles the paths.
The generic engine also runs facility location once, through the CLI's
``--no-fast``.  Phase ``e2e wide`` runs the coreset main path at d = 768
(a sentence-embedding width): the reference protocol's fused select path
and the fast engine through the CLI (``--d 768``), every facility and
pairwise launch on the streamed ring.

Output: one line per phase; the card's name and power limit
(``nvidia-smi``); a ``{"kernels": [...]}`` JSON line with each kernel's
launches on its main path (``MAIN_PATH``: one full-size run, its counts set
to 0 just before it) beside its launches on every path of that phase, its
error against the plain version, its time, the plain version's time, the
least time the card could take (``bound_ms``; for the info-gain kernels
the count-aware work at the state's selection count, with the dense
``bound_dense_ms`` and the dense call's ``dense_ms`` beside it; for flash
attention also its TFLOP/s and share of the bound), and
the time of one PyTorch library call computing the same function where
there is one; the run's total seconds; and, last, ``{"ok": true,
"device": {...}}``.
Any failed check, build or launch ends the run with a non-zero exit and no
result line.  It refuses to run without CUDA, and outside a checkout.
Timing: CUDA events around repeated launches after a warm-up; whole-path
wall times end in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its bytes over the memory rate and its operations
# over the peak rate for its input type.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"f32": 67e12, "bf16": 989e12}
TOL = {"f32": 2e-5, "bf16": 3e-2}
TOL_LONG_SUM = 1e-4   # f32 gain sums over more than 16k eval rows

TOL_DPP = 2e-5        # DPP conds: absolute, times k_vv (cancellation)
TOL_GAP = 1e-4        # a top-2 gap below this is a near-tie
# LM serving: last-token logits of the f32 model, kernel against the plain
# version, relative to the largest |logit| (f32 sums in another order)
TOL_SERVE_F32 = 1e-4
# bf16 logits (kernel vs plain, decode vs teacher forcing), relative to the
# largest |logit|: the bf16 rule of tests/test_kernels.py
TOL_SERVE_BF16 = 3e-2
# a bf16 top-2 logit gap below this is a near-tie: 8 ulps of a bf16 logit
# in [4, 8), where the largest logits of the random model lie.  The argmax
# is stable where the gap exceeds twice the largest logit difference of the
# two runs, which the phase checks is below TOL_SERVE_GAP / 2
TOL_SERVE_GAP = 0.25

REPLACES = {
    "pairwise": "src/repro/kernels/pairwise.py:33",
    "facility_select": "src/repro/kernels/select_top1.py:105",
    "facility_gain": "src/repro/kernels/facility_gain.py:55",
    "info_gain_cond": "src/repro/kernels/info_gain.py:51",
    "info_select": "src/repro/kernels/select_top1.py:255",
    "coverage_gain": "src/repro/kernels/coverage_gain.py:53",
    "coverage_select": "src/repro/kernels/select_top1.py:186",
    "graph_cut_gain": "src/repro/kernels/graph_cut_gain.py:36",
    "graph_cut_select": "src/repro/kernels/select_top1.py:323",
    "flash_attention": "src/repro/kernels/flash_attention.py:78",
    # no TPU kernel: the reference computes the relu column sums inline
    "relu_colsum": "src/repro/core/greedi.py:964",
    # no TPU kernel: the reference's lax.scan over an append chunk's rows
    "sieve_admit": "src/repro/kernels/ops.py:365",
}
# the path whose launch count each kernel reports in the kernels line (one
# run, its counts set to 0 just before it); every path's count rides along
MAIN_PATH = {
    "pairwise": "fast",                        # coreset, e2e full-size
    "facility_select": "reference",
    "facility_gain": "reference_two_pass",
    "info_gain_cond": "generic",               # GP, e2e gp full-size
    "info_select": "generic",
    "coverage_gain": "service_satcov_warm",    # e2e service
    "coverage_select": "satcov_reference",     # e2e satcov, full size
    "graph_cut_gain": "cut_greedi",            # e2e cut, full size
    "graph_cut_select": "cut_node_order",
    "flash_attention": "serve",                # e2e serve, set 1
    "relu_colsum": "fast",                     # coreset, e2e full-size
    "sieve_admit": "query_ingest",             # e2e query, full size
}
# the training paths' launches, reported beside each kernel's main path
TRAIN_PATHS = {"facility_select": ("train_coreset",),
               "flash_attention": ("train_grad_step", "train_eval",
                                   "train_dist_eval_1x4")}
GP_KERNELS = ("info_gain_cond", "info_select")
COV_KERNELS = ("coverage_gain", "coverage_select")
CUT_KERNELS = ("graph_cut_gain", "graph_cut_select")
SERVE_KERNELS = ("flash_attention",)
QUERY_KERNELS = ("sieve_admit",)
SOURCES = {
    "pairwise": "src/repro_torch/kernels/csrc/pairwise.cu",
    "facility_select": "src/repro_torch/kernels/csrc/facility.cu",
    "facility_gain": "src/repro_torch/kernels/csrc/facility.cu",
    "info_gain_cond": "src/repro_torch/kernels/csrc/info_gain.cu",
    "info_select": "src/repro_torch/kernels/csrc/info_gain.cu",
    "coverage_gain": "src/repro_torch/kernels/csrc/facility.cu",
    "coverage_select": "src/repro_torch/kernels/csrc/facility.cu",
    "graph_cut_gain": "src/repro_torch/kernels/csrc/graph_cut.cu",
    "graph_cut_select": "src/repro_torch/kernels/csrc/graph_cut.cu",
    # the main path (bf16 serving) runs the tensor-core kernel; float32
    # operands take csrc/flash_attention.cu (its row in flash_kernel_phase)
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
    "relu_colsum": "src/repro_torch/kernels/csrc/colsum.cu",
    "sieve_admit": "src/repro_torch/kernels/csrc/sieve.cu",
}


@dataclasses.dataclass(frozen=True)
class Sizes:
  n: int = 262144        # full-size ground set
  d: int = 64
  k: int = 64            # k_final = kappa
  m: int = 16            # stacked logical shards / partitions
  tile: int = 256        # a lazy rescan's columns a shard (lazy_tile)
  tree_b: int = 4        # the two-level tree (16 = 4 x 4) ...
  pods: int = 4          # ... and greedi_hierarchical's 4 pods x 4
  ragged_nl: int = 16307  # the relu column sums at a ragged nl ...
  ragged_nc: int = 1000   # ... over rows of 1000 in a pitch of 1024
  n_cli: int = 65536     # the CLI's default size
  m_cli: int = 8
  # widths off the main path: rows of 88 bytes (a padded copy), a band past
  # the resident ring, a sentence-embedding width (also e2e wide's); the
  # Tiny Images width (32 x 32 x 3 pixels) at n = 65536, 4096 rows a shard
  wide_widths: tuple = (22, 128, 768)
  wide_d: int = 768
  tiny_d: int = 3072
  tiny_rows: int = 4096
  plain_chunk: int = 4   # partitions per plain-version call at full size
  # GP active-set path: the Yahoo! Webscope data size of Sec. 6.2
  gp_n: int = 45811883
  gp_d: int = 6
  gp_m: int = 32
  gp_k: int = 128        # k_final = kappa = k_max
  gp_h: float = 0.75
  gp_sigma: float = 1.0
  gp_count: int = 64     # selection count of the kernel phase's state
  # ... and the settings of benchmarks/fig6_active_set.py at a larger n
  f6_n: int = 65536
  f6_d: int = 22
  f6_m: int = 10
  f6_k: int = 50
  f6_k_max: int = 80
  # saturated coverage (Lin & Bilmes) and the selection service, at the
  # coreset path's full size
  cov_alpha: float = 0.25
  svc_cap0: int = 65536  # the store grows twice while ingesting 75 %
  append_block: int = 1024
  append_frac: float = 0.25
  # graph cut (Sec. 6.3): the Fig. 9 settings on the paper's 1,899-node
  # graph, and a graph of the SNAP email-Enron graph's node and edge counts
  cut_paper_n: int = 1899
  cut_paper_m: int = 10
  cut_paper_k: int = 20   # k = kappa
  cut_paper_seeds: int = 2
  cut_n: int = 36692
  cut_edges: int = 183831
  cut_m: int = 16
  cut_k: int = 64         # k = kappa
  cut_comm: int = 32      # Alg. 3: partition-matroid communities ...
  cut_cap: int = 2        # ... with this cap each (rho = 64)
  # LM serving: qwen3-4b at its published width and depth, random weights
  serve_arch: str = "qwen3-4b"
  serve_seed: int = 0
  serve_f32_batch: int = 2     # (a): the float32 model's prefill
  serve_f32_prompt: int = 2048
  # (batch, prompt, new tokens): chat-sized requests; one long document
  # whose length is not a multiple of 128
  serve_sets: tuple = ((8, 2048, 64), (1, 6000, 16))
  serve_tf_steps: int = 4      # (d): decode steps held to teacher forcing
  # the service's query path: the facility service at full size ingested
  # in 16 appends of 16384 rows (a query after each), 64-request batches;
  # the exact tier on its own store of benchmarks/query_serving.py's size
  query_appends: int = 16
  query_b: int = 64
  sieve_chunks: int = 4   # chunks the admission scan runs against its plain
  exact_n: int = 16384
  exact_b: int = 64
  exact_plain_tile: int = 4  # lanes a plain-version call (memory: B n^2)
  obs_turns: int = 3      # epochs with obs off and on, in turns
  # training: qwen3-4b at full width and depth (bf16, remat "dots"), the
  # launcher's global batch x sequence, on the launcher's coreset
  # (launch/train.py CORESET: 4096 docs of width 64, m 8, kappa 256,
  # k_final 1024); the CLI at --reduced, checkpoints every 3 steps, run to
  # 6 and resumed to 9
  train_arch: str = "qwen3-4b"
  train_batch: int = 8
  train_seq: int = 256
  train_steps: int = 4
  train_cli_steps: tuple = (6, 9)
  train_ckpt_every: int = 3


class SmokeFailure(Exception):
  pass


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise SmokeFailure(msg)


STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
  """A phase's line; ``at_s`` is the seconds since the script started, so
  the gaps between lines say where the time limit goes."""
  fields["at_s"] = time.perf_counter() - STARTED
  print(f"[smoke] {phase} " + json.dumps(fields, sort_keys=False),
        flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def sync():
  import torch
  torch.cuda.synchronize()


def time_ms(fn, reps: int = 3) -> float:
  """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
  import torch
  fn()
  sync()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  sync()
  return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, flops: float, dtype: str):
  t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
  t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def errors(got, want):
  """(max abs error, max error relative to the largest |want|)."""
  diff = float((got.float() - want.float()).abs().max())
  scale = float(want.float().abs().max())
  return diff, diff / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phase 1: every kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------


def unit_rows(g, *shape, dtype=None):
  import torch
  x = torch.randn(*shape, generator=g, device=DEVICE)
  x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
  return x if dtype is None else x.to(dtype)


def pairwise_phase(label, x, y, kernel, dtype, chunk, launches):
  """Kernel vs plain on (B, nx, d) x (ny, d) or (B, ny, d); the plain
  version runs ``chunk`` batch entries at a time where the full block
  would not fit beside the kernel's output.  ``launches`` is the kernel's
  count on the full-size main path, reported beside the phase; the ring
  mode must be the one ``ring.plan`` names, and a padded copy (rows TMA
  does not read as they are; one when ``y is x``, as the wrapper makes)
  is timed alone as ``copy_ms``."""
  import torch

  from repro_torch.kernels import ops, ref, ring
  from repro_torch.kernels import pairwise as pw
  o = pw.operands(x, y)
  rule = ring.plan("pairwise", x.shape[-1], x.element_size())
  check(o.ring == rule, f"pairwise {label} {kernel} {dtype}: ring "
        f"{o.ring}, the rule names {rule}")
  copy_ms = None
  if o.copies:
    copy_ms = time_ms(lambda: [ring.features("pairwise", t) for t in
                               ((x, y) if y is not x else (x,))])
  del o
  out = ops.pairwise(x, y, kernel=kernel)
  sync()
  b = x.shape[0]
  y_at = (lambda s: y) if y.dim() == 2 else (lambda s: y[s])
  worst_abs = worst_rel = 0.0
  for c0 in range(0, b, chunk):
    s = slice(c0, c0 + chunk)
    want = ref.pairwise_ref(x[s], y_at(s), kernel=kernel)
    ea, er = errors(out[s], want)
    worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
    del want
  del out
  tol = TOL[dtype]
  check(worst_rel <= tol, f"pairwise {label} {kernel} {dtype}: relative "
        f"error {worst_rel:.3e} > {tol:.0e}")
  k_ms = time_ms(lambda: ops.pairwise(x, y, kernel=kernel))

  def plain():
    for c0 in range(0, b, chunk):
      s = slice(c0, c0 + chunk)
      ref.pairwise_ref(x[s], y_at(s), kernel=kernel)

  p_ms = time_ms(plain, reps=1)
  lib_ms = None
  if kernel == "linear" and dtype == "f32":  # bf16 matmul returns bf16
    lib_ms = time_ms(lambda: torch.matmul(x, y.mT))
  nx, d = x.shape[1:]
  ny = y.shape[-2]
  esz = x.element_size()
  moved = (x.numel() + y.numel()) * esz + b * nx * ny * 4
  flops = 2.0 * b * nx * ny * d
  if kernel == "rbf":  # norms, then x2 - 2 dot + y2, clamp, divide, exp
    flops += 2.0 * (b * nx + y.shape[0] * ny) * d + 6.0 * b * nx * ny
  bms, by = bound_ms(moved, flops, dtype)
  row = dict(shape=[b, nx, ny, d], kernel=kernel, dtype=dtype,
             mode=rule.mode, copy_ms=copy_ms,
             max_abs_err=worst_abs, max_rel_err=worst_rel, tol=tol,
             kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
             bound_ms=bms, bound_by=by, launches=launches)
  emit(f"kernel pairwise {label}", **row)
  return row


def fl_state(g, n_part, ne, nc, d, dtype):
  """A greedy-like facility state: eval rows, candidates, a cov between 0
  and the similarity scale, a mask with some dead rows, ok with some
  selected candidates."""
  import torch
  lead = (n_part,)
  ev = unit_rows(g, *lead, ne, d, dtype=dtype)
  cd = unit_rows(g, *lead, nc, d, dtype=dtype)
  cov = 0.1 * torch.rand(*lead, ne, generator=g, device=DEVICE)
  mask = (torch.rand(*lead, ne, generator=g, device=DEVICE) > 0.05).float()
  ok = torch.rand(*lead, nc, generator=g, device=DEVICE) > 0.02
  return ev, cd, cov, mask, ok


def fl_path(label, ev, cd, cov, mask, ok, cap=None):
  """The ring mode, padded copies and work plan of a facility-family call
  (``facility_gain.operands``); fails unless the mode is the one
  ``ring.plan`` names for its width."""
  from repro_torch.kernels import facility_gain as fg
  from repro_torch.kernels import ring
  o = fg.operands(label, ev, cd, cov, mask, ok, cap=cap)
  want = ring.plan("facility", o.d, ev.element_size(),
                   2 if cap is None else 3)
  check(o.ring == want, f"{label}: ring {o.ring}, want {want}")
  return dict(path=o.path, copies=list(o.copies),
              eval_chunks=o.plan.chunks, units=o.plan.units)


def facility_phase(label, ev, cd, cov, mask, ok, kernel, dtype, chunk,
                   counts):
  """facility_gain and facility_select vs the plain version; the plain
  side runs ``chunk`` partitions at a time.  ``counts`` are the kernels'
  launches on the full-size main path; the ring mode must be the rule's."""
  from repro_torch.kernels import ops, ref
  plan = fl_path(f"facility {label} {kernel} {dtype}", ev, cd, cov, mask, ok)
  gains = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
  best, idx = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
  sync()
  n_part, nc = gains.shape
  ne = cov.shape[-1]

  def plain_chunks():
    for c0 in range(0, n_part, chunk):
      s = slice(c0, c0 + chunk)
      yield s, ref.facility_gain_ref(ev[s], cd[s], cov[s], mask[s],
                                     kernel=kernel)

  tol = TOL[dtype] if ne <= 16384 or dtype != "f32" else TOL_LONG_SUM
  g_abs = g_rel = b_abs = b_rel = 0.0
  idx_equal = near_ties = 0
  for s, want in plain_chunks():
    ea, er = errors(gains[s], want)
    g_abs, g_rel = max(g_abs, ea), max(g_rel, er)
    wb, wi = ref.masked_top1(want, ok[s])
    same = idx[s] == wi
    idx_equal += int(same.sum())
    # a different index is a near-tie only if its plain gain is within the
    # tolerance of the plain best
    picked = want.gather(1, idx[s].unsqueeze(1)).squeeze(1)
    gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
    tie = (~same) & (gap <= tol) & ok[s].gather(1, idx[s].unsqueeze(1))[:, 0]
    near_ties += int(tie.sum())
    check(bool((same | tie).all()), f"facility_select {label} {kernel} "
          f"{dtype}: index differs beyond a near-tie")
    ea, er = errors(best[s], wb)
    b_abs, b_rel = max(b_abs, ea), max(b_rel, er)
    check(er <= tol, f"facility_select {label}: best error {er:.3e}")
  check(g_rel <= tol, f"facility_gain {label} {kernel} {dtype}: relative "
        f"error {g_rel:.3e} > {tol:.0e}")
  gain_ms = time_ms(lambda: ops.facility_gain(ev, cd, cov, mask,
                                              kernel=kernel))
  sel_ms = time_ms(lambda: ops.facility_select(ev, cd, cov, mask, ok,
                                               kernel=kernel))

  def plain_gain():
    for _ in plain_chunks():
      pass

  def plain_select():
    for s, want in plain_chunks():
      ref.masked_top1(want, ok[s])

  pg_ms = time_ms(plain_gain, reps=1)
  ps_ms = time_ms(plain_select, reps=1)
  d = cd.shape[-1]
  esz = cd.element_size()
  read = (ev.numel() + cd.numel()) * esz + (cov.numel() + mask.numel()) * 4
  flops = (2.0 * d + 3.0) * n_part * ne * nc
  if kernel == "rbf":
    flops += 6.0 * n_part * ne * nc + 2.0 * n_part * (ne + nc) * d
  peak = dtype
  g_bound = bound_ms(read + n_part * nc * 4, flops, peak)
  s_bound = bound_ms(read + ok.numel() + n_part * 8, flops, peak)
  common = dict(shape=[n_part, ne, nc, d], kernel=kernel, dtype=dtype,
                tol=tol, **plan)
  g_row = dict(common, max_abs_err=g_abs, max_rel_err=g_rel,
               kernel_ms=gain_ms, plain_ms=pg_ms, library_ms=None,
               bound_ms=g_bound[0], bound_by=g_bound[1],
               launches=counts["facility_gain"])
  s_row = dict(common, max_abs_err=b_abs, max_rel_err=b_rel,
               idx_equal=idx_equal, idx_total=n_part, near_ties=near_ties,
               kernel_ms=sel_ms, plain_ms=ps_ms, library_ms=None,
               bound_ms=s_bound[0], bound_by=s_bound[1],
               launches=counts["facility_select"])
  emit(f"kernel facility_gain {label}", **g_row)
  emit(f"kernel facility_select {label}", **s_row)
  return g_row, s_row


EDGE_WIDTHS = (22, 40, 130)  # the facility edge phases' widths


def edge_phase():
  """Ragged sizes in both ring modes of the facility kernels (d 22: rows of
  88 bytes, a padded copy; d 40: resident; d 130: streamed and padded; two
  calls give the same bits), an all-infeasible ok, and exact ties from
  duplicated candidate rows, on the card."""
  import torch

  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(11)
  paths = []
  for kernel in ("linear", "rbf"):
    for d in EDGE_WIDTHS:
      ev, cd, cov, mask, ok = fl_state(g, 3, 1000, 1037, d, None)
      plan = fl_path(f"ragged d{d}", ev, cd, cov, mask, ok)
      paths.append([d, plan["path"], plan["copies"]])
      gains = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
      again = ops.facility_gain(ev, cd, cov, mask, kernel=kernel)
      best, idx = ops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
      want = ref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel)
      wb, wi = ref.masked_top1(want, ok)
      sync()
      _, er = errors(gains, want)
      check(er <= TOL["f32"] and torch.equal(idx, wi),
            f"ragged d{d} {kernel}: err {er:.3e}, idx {idx.tolist()} vs "
            f"{wi.tolist()}")
      check(torch.equal(gains, again), f"ragged d{d} {kernel}: two calls "
            "differ")
    s = ops.pairwise(ev, cd[0], kernel=kernel)
    _, es = errors(s, ref.pairwise_ref(ev, cd[0], kernel=kernel))
    check(es <= TOL["f32"], f"ragged pairwise {kernel}: err {es:.3e}")
    none = torch.zeros_like(ok)
    best, idx = ops.facility_select(ev, cd, cov, mask, none, kernel=kernel)
    sync()
    check(bool((best == ref.NEG).all()) and bool((idx == 0).all()),
          f"all-infeasible {kernel}: {best.tolist()} {idx.tolist()}")
    # exact ties: +-10 sign rows make every similarity and gain exact
    signs = torch.where(torch.rand(2, 300, 8, generator=g, device=DEVICE)
                        > 0.5, 10.0, -10.0)
    e_t = signs[:, torch.randint(0, 300, (700,), generator=g,
                                 device=DEVICE)]
    cand = signs.clone()
    want = ref.facility_gain_ref(e_t, cand, torch.zeros(2, 700,
                                                        device=DEVICE),
                                 torch.ones(2, 700, device=DEVICE),
                                 kernel=kernel)
    top = want.argmax(dim=1)
    for p in range(2):  # the best row again at a higher and a lower index
      j = int(top[p])
      cand[p, (j + 211) % 300] = cand[p, j]
      cand[p, (j + 97) % 300] = cand[p, j]
    zeros = torch.zeros(2, 700, device=DEVICE)
    ones = torch.ones(2, 700, device=DEVICE)
    allok = torch.ones(2, 300, dtype=torch.bool, device=DEVICE)
    best, idx = ops.facility_select(e_t, cand, zeros, ones, allok,
                                    kernel=kernel)
    want = ref.facility_gain_ref(e_t, cand, zeros, ones, kernel=kernel)
    wb, wi = ref.masked_top1(want, allok)
    sync()
    check(torch.equal(idx, wi) and torch.equal(best, wb),
          f"ties {kernel}: {idx.tolist()} vs {wi.tolist()}")
  emit("kernel edges", ragged=[[3, 1000, 1037, d] for d in EDGE_WIDTHS],
       paths=paths, repeat="identical bits", all_infeasible="(NEG, 0)",
       ties="lowest index", result="pass")


def pairwise_edge_phase():
  """The pairwise kernel against its plain version at its edges: ragged nx
  and ny, d of 6, 17, 22, 36, 64, 128 and 130 (both ring modes; rows that
  are not a multiple of 16 bytes go over as a padded copy), a shared y
  block (2-D, and expanded with stride 0) and a shared x block, bf16,
  misaligned bases and a column slice, ny not a multiple of 4 (plain
  stores), a batch past one wave of persistent blocks; linear and rbf.
  Two launches give the same bytes."""
  import torch

  from repro_torch.kernels import ops, ref
  from repro_torch.kernels import pairwise as pw
  g = torch.Generator(device=DEVICE).manual_seed(13)
  cases = (((2, 1000, 64), (2, 1037, 64)), ((3, 200, 6), (3, 130, 6)),
           ((2, 300, 22), (300, 22)), ((2, 257, 130), (2, 129, 130)),
           ((1, 129, 36), (1, 131, 36)), ((300, 130, 64), (300, 64, 64)),
           ((100, 64), (4, 77, 64)), ((5, 128, 64), (128, 64)),
           ((1, 4096, 64), (1, 1023, 64)), ((2, 300, 128), (2, 257, 128)),
           ((2, 131, 17), (2, 70, 17)), ("offset", (2, 200, 64), (2, 90, 64)),
           ("slice", (3, 301, 130), (3, 129, 130)))
  worst = {"f32": 0.0, "bf16": 0.0}
  paths = {}
  for case in cases:
    xs, ys = case[-2:]
    for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      x, y = unit_rows(g, *xs, dtype=td), unit_rows(g, *ys, dtype=td)
      if case[0] == "offset":  # bases one element past 16-byte alignment
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(xs)
        y = torch.cat([y.new_zeros(1), y.flatten()])[1:].view(ys)
      if case[0] == "slice":  # a column slice of x, y expanded (stride 0)
        d = xs[-1]
        x = unit_rows(g, *xs[:-1], d + 8, dtype=td)[..., 1:d + 1]
        y = y[0].expand(ys)
      o = pw.operands(x, y)
      key = o.ring.mode + (" padded" if o.copies else "")
      paths[key] = paths.get(key, 0) + 1
      for kernel in ("linear", "rbf"):
        got = ops.pairwise(x, y, kernel=kernel)
        again = ops.pairwise(x, y, kernel=kernel)
        sync()
        _, er = errors(got, ref.pairwise_ref(x, y, kernel=kernel))
        check(er <= TOL[dtype], f"pairwise edge {xs} x {ys} {kernel} "
              f"{dtype}: err {er:.3e}")
        check(torch.equal(got, again), f"pairwise edge {xs} x {ys} {kernel} "
              f"{dtype}: two launches differ")
        worst[dtype] = max(worst[dtype], er)
  emit("kernel pairwise edges", cases=[[*c[:-2], list(c[-2]), list(c[-1])]
                                       for c in cases],
       max_rel_err=worst, tol=TOL, operand_paths=paths,
       repeat="identical bytes", result="pass")


def kernel_phases(sz: Sizes, counts: dict):
  import torch
  g = torch.Generator(device=DEVICE).manual_seed(0)
  nl = sz.n // sz.m
  rows = {}
  for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    local = unit_rows(g, sz.m, nl, sz.d, dtype=td)
    merged = unit_rows(g, sz.m * sz.k, sz.d, dtype=td)
    for kernel in ("linear", "rbf"):
      r = pairwise_phase("s11", local, local, kernel, dtype, sz.plain_chunk,
                         counts["pairwise"])
      rows[("pairwise", "s11", kernel, dtype)] = r
      torch.cuda.empty_cache()
      r = pairwise_phase("s2", local, merged, kernel, dtype, sz.m,
                         counts["pairwise"])
      rows[("pairwise", "s2", kernel, dtype)] = r
    del local, merged
    torch.cuda.empty_cache()
  # the other widths at s11's shape, linear f32 beside cuBLAS: rows of 88
  # bytes (a padded copy), d past the resident band (streamed), a
  # sentence-embedding width, and the Tiny Images width at 4096 rows a
  # shard
  for d, rows_ in wide_shapes(sz):
    local = unit_rows(g, sz.m, rows_, d)
    rows[("pairwise", f"s11 d{d}", "linear", "f32")] = pairwise_phase(
        f"s11 d{d}", local, local, "linear", "f32", sz.plain_chunk, 0)
    del local
    torch.cuda.empty_cache()
  for kernel in ("linear", "rbf"):
    for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      if kernel == "rbf" and dtype == "bf16":
        continue
      st = fl_state(g, sz.m, nl, nl, sz.d, td)
      gr, sr = facility_phase("round1", *st, kernel, dtype, sz.plain_chunk,
                              counts)
      rows[("facility_gain", "round1", kernel, dtype)] = gr
      rows[("facility_select", "round1", kernel, dtype)] = sr
      del st
    st = fl_state(g, 1, sz.n, sz.m * sz.k, sz.d, torch.float32)
    gr, sr = facility_phase("round2", *st, kernel, "f32", 1, counts)
    rows[("facility_gain", "round2", kernel, "f32")] = gr
    rows[("facility_select", "round2", kernel, "f32")] = sr
    del st
    torch.cuda.empty_cache()
  return rows


def wide_shapes(sz: Sizes):
  """(d, rows a shard) of the kernel phases off the main path's d = 64."""
  return [(d, sz.n // sz.m) for d in sz.wide_widths] + [
      (sz.tiny_d, sz.tiny_rows)]


def top1_agreement(what, best, idx, want, ok, tol):
  """(max abs error, max relative error, equal indices, near-ties) of a
  select's (best, idx) against the plain gains ``want``; an index that
  differs must be a near-tie (its plain gain within ``tol`` of the plain
  best, and feasible)."""
  from repro_torch.kernels import ref
  wb, wi = ref.masked_top1(want, ok)
  same = idx == wi
  picked = want.gather(-1, idx.unsqueeze(-1))[..., 0]
  gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
  tie = (~same) & (gap <= tol) & ok.gather(-1, idx.unsqueeze(-1))[..., 0]
  check(bool((same | tie).all()), f"{what}: index differs beyond a "
        "near-tie")
  ea, er = errors(best, wb)
  check(er <= tol, f"{what}: best error {er:.3e} > {tol:.0e}")
  return ea, er, int(same.sum()), int(tie.sum())


def wide_select_phase(sz: Sizes):
  """facility_select and coverage_select at round 1's shape (16
  partitions of 16384 eval rows and candidates) at the widths off the main
  path's d = 64, f32 and bf16, and facility_select at the Tiny Images width
  (16 x 4096 x 4096, d 3072): each against the plain gains' top-1 (a
  differing index must be a near-tie), the ring mode the rule names, the
  padded copy timed alone where the rows need one."""
  import torch

  from repro_torch.kernels import ops, ref, ring
  g = torch.Generator(device=DEVICE).manual_seed(23)
  rows = {}
  for d, n in wide_shapes(sz):
    for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      for name in ("facility_select", "coverage_select"):
        if d == sz.tiny_d and (dtype, name) != ("f32", "facility_select"):
          continue
        coverage = name == "coverage_select"
        if coverage:
          ev, cd, cov, cap, mask, ok = cov_state(g, (sz.m,), n, n, d, td)
          vecs = (cov, cap)
        else:
          ev, cd, cov, mask, ok = fl_state(g, sz.m, n, n, d, td)
          cap, vecs = None, (cov,)
        label = f"{name} round1 d{d} {dtype}"
        plan = fl_path(label, ev, cd, cov, mask, ok, cap=cap)
        select = getattr(ops, name)
        best, idx = select(ev, cd, *vecs, mask, ok)
        sync()

        def plain():
          if coverage:
            return cov_plain(ev, cd, cov, cap, mask, "linear",
                             sz.plain_chunk)
          return torch.cat([ref.facility_gain_ref(
              ev[s], cd[s], cov[s], mask[s], kernel="linear")
              for s in (slice(p0, p0 + sz.plain_chunk)
                        for p0 in range(0, sz.m, sz.plain_chunk))])

        tol = TOL[dtype] if n <= 16384 or dtype != "f32" else TOL_LONG_SUM
        b_abs, b_rel, same, ties = top1_agreement(label, best, idx, plain(),
                                                  ok, tol)
        k_ms = time_ms(lambda: select(ev, cd, *vecs, mask, ok))
        p_ms = time_ms(lambda: ref.masked_top1(plain(), ok), reps=1)
        copy_ms = None
        if plan["copies"]:
          copy_ms = time_ms(lambda: (ring.features(name, ev),
                                     ring.features(name, cd)))
        esz = cd.element_size()
        if coverage:
          bms, by = cov_bound(sz.m, n, n, d, esz, False, False, False,
                              "linear", True)
        else:
          read = (ev.numel() + cd.numel()) * esz + 2 * cov.numel() * 4
          bms, by = bound_ms(read + ok.numel() + sz.m * 8,
                             (2.0 * d + 3.0) * sz.m * n * n, dtype)
        row = dict(shape=[sz.m, n, n, d], kernel="linear", dtype=dtype,
                   tol=tol, **plan, max_abs_err=b_abs, max_rel_err=b_rel,
                   idx_equal=same, idx_total=sz.m, near_ties=ties,
                   kernel_ms=k_ms, plain_ms=p_ms, copy_ms=copy_ms,
                   library_ms=None, bound_ms=bms, bound_by=by, launches=0)
        rows[(name, f"round1 d{d}", "linear", dtype)] = row
        emit(f"kernel {name} round1 d{d}", **row)
        del ev, cd, cov, cap, mask, ok, vecs
        torch.cuda.empty_cache()
  return rows


# ---------------------------------------------------------------------------
# phase 2: the coreset path end to end
# ---------------------------------------------------------------------------


def value_of(feats, sel, obj=None):
  """f(S) of a selection under the full-set facility objective (``obj``,
  by default linear facility location)."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  obj = O.FacilityLocation() if obj is None else obj
  sf = feats[torch.as_tensor(sel, device=feats.device)]
  st = GD.set_value_feats(obj, obj.init(feats), sf,
                          torch.ones(sf.shape[:1], dtype=torch.bool,
                                     device=feats.device))
  return float(obj.value(st))


def agree(feats, a, b, what, obj=None):
  """Equal selections, or the near-tie rule: at the first position where
  they differ both picks' marginal gains (after the common prefix, under
  the full-set objective ``obj``, by default linear facility location)
  agree within the f32 tolerance, and the two f(S) agree within 1e-5
  relative."""
  import numpy as np
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  if np.array_equal(a, b):
    return "equal"
  t = int(np.flatnonzero(a[:min(len(a), len(b))] !=
                         b[:min(len(a), len(b))])[0])
  obj = O.FacilityLocation() if obj is None else obj
  prefix = feats[torch.as_tensor(a[:t], device=feats.device)]
  st = GD.set_value_feats(obj, obj.init(feats), prefix,
                          torch.ones((t,), dtype=torch.bool,
                                     device=feats.device))
  pair = feats[torch.as_tensor([a[t], b[t]], device=feats.device)]
  g = obj.gains(st, pair)
  gap = float((g[0] - g[1]).abs() / g.abs().max())
  va, vb = value_of(feats, a, obj), value_of(feats, b, obj)
  rel = abs(va - vb) / max(abs(va), 1e-30)
  check(gap <= TOL_LONG_SUM and rel <= 1e-5,
        f"{what}: selections differ at step {t} (gain gap {gap:.3e}, "
        f"f(S) {va!r} vs {vb!r})")
  return f"near-tie at step {t} (gain gap {gap:.2e}, f rel {rel:.2e})"


def e2e_cli_size(sz: Sizes):
  """(a) the CLI's default size: reference and stacked fast path, each with
  backend "auto" (the kernels) and "ref" (the plain versions on the card),
  and the generic engine through the CLI (``--no-fast``), all five
  selections agreeing; the coverage ratio."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (coverage_ratio,
                                          greedi_select_indices,
                                          greedi_select_indices_sharded)
  from repro_torch.kernels import ops
  from repro_torch.launch import select as cli
  feats = EmbeddedCorpus(n_docs=sz.n_cli, feat_dim=sz.d, seed=0).features()
  sels, walls, peaks = {}, {}, {}
  for path in ("reference", "fast"):
    for backend in ("auto", "ref"):
      rng = torch.Generator().manual_seed(0)
      torch.cuda.empty_cache()
      torch.cuda.reset_peak_memory_stats()
      sync()
      t0 = time.perf_counter()
      if path == "reference":
        sel = greedi_select_indices(rng, feats, m=sz.m_cli, kappa=sz.k,
                                    k_final=sz.k, backend=backend)
      else:
        sel = greedi_select_indices_sharded(rng, feats, m=sz.m_cli,
                                            kappa=sz.k, k_final=sz.k,
                                            backend=backend)
      sync()
      walls[(path, backend)] = time.perf_counter() - t0
      peaks[(path, backend)] = torch.cuda.max_memory_allocated() / 2**30
      check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k and
            sel.min() >= 0 and sel.max() < sz.n_cli,
            f"{path}/{backend}: not k unique in-range ids")
      sels[(path, backend)] = sel
  verdicts = {
      "reference auto vs ref": agree(feats, sels[("reference", "auto")],
                                     sels[("reference", "ref")], "ref a/r"),
      "fast auto vs ref": agree(feats, sels[("fast", "auto")],
                                sels[("fast", "ref")], "fast a/r"),
      "reference vs fast": agree(feats, sels[("reference", "auto")],
                                 sels[("fast", "auto")], "ref/fast"),
  }
  # the generic engine through the CLI (--no-fast), same seed and partition
  (REPO / "build").mkdir(exist_ok=True)
  ops.reset_launch_counts()
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    path = os.path.join(tmp, "sel.npy")
    sync()
    t0 = time.perf_counter()
    cli.main(["--n", str(sz.n_cli), "--d", str(sz.d), "--k", str(sz.k),
              "--mesh", str(sz.m_cli), "--no-fast", "--no-coverage", "--out",
              path])
    sync()
    walls[("generic", "auto")] = time.perf_counter() - t0
    sels[("generic", "auto")] = np.load(path)
  generic_launches = ops.launch_counts()
  for name in ("facility_select", "facility_gain"):
    check(generic_launches[name] > 0, f"the generic engine did not launch "
          f"{name}")
  verdicts["generic vs fast"] = agree(feats, sels[("generic", "auto")],
                                      sels[("fast", "auto")], "generic/fast")
  sync()
  t0 = time.perf_counter()
  cov = coverage_ratio(feats, sels[("fast", "auto")], sz.k)
  sync()
  t_cov = time.perf_counter() - t0
  check(0.5 < cov <= 1.0 + 1e-6, f"coverage ratio {cov} out of range")
  emit("e2e cli-size", n=sz.n_cli, d=sz.d, k=sz.k, m=sz.m_cli,
       wall_s={f"{p}/{b}": w for (p, b), w in walls.items()},
       peak_gib={f"{p}/{b}": v for (p, b), v in peaks.items()},
       agreement=verdicts, generic_launches=generic_launches, coverage=cov,
       coverage_wall_s=t_cov)


def e2e_full(sz: Sizes):
  """(b) the main path at full size, launch counts read around it: the
  reference protocol (fused select step, and the two-pass gains step) and
  the stacked fast engine through the CLI, each with the launch counts set
  to 0 before it and read after it.  Returns the counts by path."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.kernels import ops
  from repro_torch.launch import select as cli
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  sync()
  torch.cuda.empty_cache()
  out, counts = {}, {}
  for name, use_select in (("reference", True), ("reference_two_pass",
                                                 False)):
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    sel = greedi_select_indices(torch.Generator().manual_seed(0), feats,
                                m=sz.m, kappa=sz.k, k_final=sz.k,
                                use_select=use_select)
    sync()
    out[name] = dict(sel=sel, wall_s=time.perf_counter() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    counts[name] = ops.launch_counts()
  ops.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    path = os.path.join(tmp, "sel.npy")
    sync()
    t0 = time.perf_counter()
    cli.main(["--n", str(sz.n), "--d", str(sz.d), "--k", str(sz.k),
              "--mesh", str(sz.m), "--no-coverage", "--out", path])
    sync()
    out["fast"] = dict(sel=np.load(path), wall_s=time.perf_counter() - t0,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  counts["fast"] = ops.launch_counts()
  for name, r in out.items():
    sel = r["sel"]
    check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k and
          sel.min() >= 0 and sel.max() < sz.n, f"{name}: bad selection")
  for name in ("pairwise", "facility_select", "facility_gain"):
    check(counts[MAIN_PATH[name]][name] > 0, f"kernel {name} was not "
          f"launched on the coreset {MAIN_PATH[name]} path")
  value = value_of(feats, out["fast"]["sel"])
  check(0.0 < value < float("inf"), f"f(coreset) = {value!r}")
  verdicts = {
      "select vs two-pass": agree(feats, out["reference"]["sel"],
                                  out["reference_two_pass"]["sel"],
                                  "select/two-pass"),
      "reference vs fast": agree(feats, out["reference"]["sel"],
                                 out["fast"]["sel"], "ref/fast full"),
  }
  emit("e2e full-size", n=sz.n, d=sz.d, k=sz.k, m=sz.m,
       s11_gib=sz.m * (sz.n // sz.m) ** 2 * 4 / 2**30,
       wall_s={k: v["wall_s"] for k, v in out.items()},
       peak_gib={k: v["peak_gib"] for k, v in out.items()},
       launches=counts, agreement=verdicts, value=value)
  return (counts, out["reference"]["sel"], out["fast"]["sel"],
          {"fast": (out["fast"]["sel"], out["fast"]["peak_gib"])})


def fast_layout(feats, m):
  """The shard-contiguous layout and gids the sharded selection path gives
  the engines (``greedi_select_indices_sharded``, generator seed 0, as the
  CLI draws it)."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core.partition import partition_gids, random_partition
  r_part = GD.greedi_keys(torch.Generator().manual_seed(0))[0]
  parts, _, perm = random_partition(r_part, feats, m)
  return parts.reshape(-1, feats.shape[1]), partition_gids(perm)


def timed_run(fn):
  """One run of ``fn``: its result, wall time, peak memory, launch counts
  and lazy host syncs, the counts and the peak reset just before it."""
  import torch

  from repro_torch.core import greedy
  from repro_torch.kernels import ops
  torch.cuda.empty_cache()
  ops.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  syncs = greedy.lazy_syncs
  sync()
  t0 = time.perf_counter()
  r = fn()
  sync()
  return dict(result=r, wall_s=time.perf_counter() - t0,
              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
              launches=ops.launch_counts(),
              syncs=greedy.lazy_syncs - syncs)


def selected(r, n, k, what):
  """The valid ids of a GreediResult, checked: k unique ids in [0, n)."""
  sel = r.sel_gids[r.sel_valid].cpu().numpy()
  check(len(sel) == k and len(set(sel.tolist())) == k and sel.min() >= 0
        and sel.max() < n, f"{what}: not k unique in-range ids")
  return sel


def e2e_fast_lazy(sz: Sizes, ref_sel):
  """The fast engine at full size, round 1 standard and lazy
  (``mode="lazy"``: bound-sorted column tiles of s11 through the relu
  column-sum kernel's gathered calls): equal ``sel_gids``, ``value`` and
  ``stage1_values`` bits, the lazy tiles rescanned per shard and the host
  syncs, wall time and peak memory of both, and the selection against the
  reference path's (``ref_sel``; equal, or a recorded near-tie).  Returns
  the standard run's result and the counts by path."""
  import numpy as np

  from repro_torch.core import greedi as GD
  from repro_torch.data.pipeline import EmbeddedCorpus
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  fsh, gids = fast_layout(feats, sz.m)
  runs = {mode: timed_run(lambda mode=mode: GD.greedi_sharded_fast(
      fsh, m=sz.m, kappa=sz.k, k_final=sz.k, gids=gids, mode=mode))
          for mode in ("standard", "lazy")}
  std, lz = runs["standard"]["result"], runs["lazy"]["result"]
  for name in ("sel_gids", "value", "stage1_values"):
    check(bool((getattr(std, name) == getattr(lz, name)).all()),
          f"e2e fast lazy: {name} differs from the standard round 1")
  for mode, run in runs.items():
    check(run["launches"]["relu_colsum"] > 0 and
          run["launches"]["pairwise"] > 0, f"e2e fast lazy: {mode} did not "
          f"launch the kernels ({run['launches']})")
  sel = selected(lz, sz.n, sz.k, "e2e fast lazy")
  rescans = lz.r1_rescans.cpu().numpy()
  check(bool((rescans > 0).all()), "e2e fast lazy: a shard never rescanned")
  emit("e2e fast lazy", n=sz.n, d=sz.d, k=sz.k, m=sz.m,
       tile=sz.tile, bits_equal=True,
       wall_s={k: v["wall_s"] for k, v in runs.items()},
       peak_gib={k: v["peak_gib"] for k, v in runs.items()},
       rescans_per_shard=rescans.tolist(),
       tiles_per_step=float(np.mean(rescans)) / (sz.k - 1),
       host_syncs=runs["lazy"]["syncs"],
       launches={k: v["launches"] for k, v in runs.items()},
       agreement={"reference vs lazy": agree(feats, ref_sel, sel,
                                             "reference/lazy")},
       value=float(lz.value))
  return std, {f"fast_{k}": v["launches"] for k, v in runs.items()}


def e2e_tree(sz: Sizes, flat, stacked: dict):
  """The accumulation-tree merge and the hierarchical variant at full size
  (the same layout as ``e2e_fast_lazy``; ``flat`` its standard flat run):
  the fast engine with tree_branch = 16 (one level: flat's bits), = 4 (two
  levels), the generic engine with tree_branch = 4, and
  ``greedi_hierarchical`` over 4 pods x 4.  Each: wall time, peak memory,
  ``merge_peak_rows``, f / f(flat) under the full-set objective, held at
  or above the Thm-4 floor, and the launches of the kernels on its path.
  The generic and the fast tree4 share a partition, so they must select
  the same coreset (``agree``).  Then the CLI with ``--merge-tree 4`` (the
  same partition: the fast tree's coreset).  Returns the counts by path;
  adds the CLI's ids and peak to ``stacked`` (``e2e dist`` holds its
  ranks to them)."""
  import numpy as np

  from repro_torch.core import bounds
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.launch import select as cli
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  fsh, gids = fast_layout(feats, sz.m)
  obj = O.FacilityLocation()
  kw = dict(kappa=sz.k, k_final=sz.k, gids=gids)
  b, m = sz.tree_b, sz.m
  paths = {
      f"fast tree{m}": (lambda: GD.greedi_sharded_fast(
          fsh, m=m, merge="tree", tree_branch=m, **kw),
                        GD.merge_peak_rows(m, sz.k, merge="tree",
                                           tree_branch=m), "fast"),
      f"fast tree{b}": (lambda: GD.greedi_sharded_fast(
          fsh, m=m, merge="tree", tree_branch=b, **kw),
                        GD.merge_peak_rows(m, sz.k, merge="tree",
                                           tree_branch=b), "fast"),
      f"generic tree{b}": (lambda: GD.greedi_sharded(
          fsh, m=m, objective=obj, merge="tree", tree_branch=b, **kw),
                           GD.merge_peak_rows(m, sz.k, merge="tree",
                                              tree_branch=b), "generic"),
      f"hierarchical {sz.pods}x{m // sz.pods}": (
          lambda: GD.greedi_hierarchical(fsh, pods=sz.pods,
                                         per_pod=m // sz.pods,
                                         objective=obj, **kw),
          max(sz.pods, m // sz.pods) * sz.k, "generic"),
  }
  v_flat = value_of(feats, selected(flat, sz.n, sz.k, "flat"))
  floor = bounds.thm4_bound(m, sz.k, sz.k)
  rows, counts, sels = {}, {}, {}
  for name, (run, peak_rows, engine) in paths.items():
    res = timed_run(run)
    r = res["result"]
    sel = selected(r, sz.n, sz.k, f"e2e tree {name}")
    ratio = value_of(feats, sel) / v_flat
    check(ratio >= floor, f"e2e tree {name}: f / f(flat) {ratio} below the "
          f"Thm-4 floor {floor}")
    kernels = (("pairwise", "relu_colsum") if engine == "fast" else
               ("facility_select", "facility_gain"))
    for kname in kernels:
      check(res["launches"][kname] > 0, f"e2e tree {name}: {kname} was not "
            f"launched ({res['launches']})")
    if name == f"fast tree{m}":
      for field in ("sel_gids", "value", "stage1_values"):
        check(bool((getattr(r, field) == getattr(flat, field)).all()),
              f"e2e tree: tree_branch = {m} differs from flat in {field}")
    rows[name] = dict(wall_s=res["wall_s"], peak_gib=res["peak_gib"],
                      merge_peak_rows=peak_rows, ratio_to_flat=ratio,
                      stage1_values=len(r.stage1_values),
                      launches={k: v for k, v in res["launches"].items()
                                if v})
    counts[name] = res["launches"]
    sels[name] = sel
  # one partition, two engines: the same coreset, or a recorded near-tie
  engines_agree = agree(feats, sels[f"fast tree{b}"],
                        sels[f"generic tree{b}"],
                        f"e2e tree: generic tree{b} against fast tree{b}")
  tree_sel = sels[f"fast tree{b}"]
  # the same tree through the CLI (--merge-tree): the same coreset
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    path = os.path.join(tmp, "sel.npy")
    res = timed_run(lambda: cli.main([
        "--n", str(sz.n), "--d", str(sz.d), "--k", str(sz.k), "--mesh",
        str(m), "--merge-tree", str(b), "--no-coverage", "--out", path]))
    cli_sel = np.load(path)
  check(np.array_equal(np.sort(cli_sel), np.sort(tree_sel)) and
        res["launches"]["relu_colsum"] > 0, f"e2e tree: --merge-tree {b} "
        "through the CLI selected another coreset or missed the kernel")
  rows[f"cli --merge-tree {b}"] = dict(
      wall_s=res["wall_s"], peak_gib=res["peak_gib"],
      launches={k: v for k, v in res["launches"].items() if v})
  counts[f"cli tree{b}"] = res["launches"]
  stacked[f"fast tree{b}"] = (cli_sel, res["peak_gib"])
  emit("e2e tree", n=sz.n, d=sz.d, k=sz.k, m=m, flat_merge_peak_rows=m *
       sz.k, thm4_floor=floor, tree16_bits_equal_flat=True,
       generic_vs_fast_tree=engines_agree, paths=rows)
  return counts


DIST_RANKS = 4
DIST_DEADLINE = 1.0   # e2e dist's liveness run: rank 1's shards miss it


def dist_ages(sz: Sizes):
  """(m,) heartbeat ages of e2e dist's liveness run: rank 1's shards are
  past ``DIST_DEADLINE``."""
  import torch
  per = sz.m // DIST_RANKS
  return torch.tensor([5.0 if per <= s < 2 * per else 0.0
                       for s in range(sz.m)])


def torchrun(args, timeout: int = 600):
  """``python -m torch.distributed.run --standalone --nproc-per-node 4
  ARGS`` from the checkout in a process group of its own (killed whole on
  a timeout): (wall seconds, stdout).  A failed rank fails the smoke."""
  env = dict(os.environ, PYTHONPATH=str(SRC))
  t0 = time.perf_counter()
  proc = subprocess.Popen(
      [sys.executable, "-m", "torch.distributed.run", "--standalone",
       "--nproc-per-node", str(DIST_RANKS), *args], cwd=REPO, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
      process_group=0)
  try:
    out, err = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    proc.terminate()   # torchrun stops its ranks on SIGTERM
    try:
      proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
      os.killpg(proc.pid, 9)
      proc.wait()
    raise SmokeFailure(f"torchrun {' '.join(args)}: no end in {timeout} s")
  if proc.returncode != 0:   # the ranks' tracebacks come before the summary
    tb = [i for i, line in enumerate(err.splitlines())
          if line.startswith(("Traceback", "[rank"))]
    first = "\n".join(err.splitlines()[tb[0]:tb[0] + 40]) if tb else ""
    raise SmokeFailure(f"torchrun {' '.join(args)} exited "
                       f"{proc.returncode}:\n{out[-3000:]}\n{first}\n"
                       f"{err[-3000:]}")
  return time.perf_counter() - t0, out


_LAUNCHES = None


def wait_for(path: str, timeout: float) -> None:
  """Poll until ``path`` exists (a torchrun rank waiting for the smoke's
  process); a SmokeFailure past ``timeout`` seconds."""
  t0 = time.perf_counter()
  while not os.path.exists(path):
    check(time.perf_counter() - t0 < timeout, f"no {path} in {timeout} s")
    time.sleep(0.2)


def torchrun_async(args, timeout: int = 600):
  """``torchrun(args)`` in a thread of its own: a future of its (wall
  seconds, stdout).  A phase starts the launches that share no state and
  fit on the card together side by side, so their ranks' start-up
  overlaps; each wall then includes the host and the card shared with
  the others."""
  global _LAUNCHES
  if _LAUNCHES is None:
    from concurrent.futures import ThreadPoolExecutor
    _LAUNCHES = ThreadPoolExecutor(max_workers=8)
  return _LAUNCHES.submit(torchrun, args, timeout)


def dist_liveness_rank(out_dir: str) -> None:
  """One rank of e2e dist's library run (``chip_smoke.py --dist-liveness
  DIR`` under torchrun): the fast engine over a gloo mesh of 4 ranks on the
  card, each rank passing its own shards' heartbeat ages (``dist_ages``),
  twice (the first run also sets the collectives up); writes the second
  run's result, both wall times, the peak and one run's collectives to
  DIR."""
  sys.path.insert(0, str(SRC))
  import numpy as np
  import torch

  from repro_torch import no_tf32
  from repro_torch.core import greedi as GD
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.launch.mesh import ProcessMesh
  no_tf32()
  sz = Sizes()
  mesh = ProcessMesh.from_env(sz.m, "gloo", DEVICE)
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0,
                         device=str(mesh.device)).features()
  fsh, gids = fast_layout(feats, sz.m)

  def own(x):
    return x.reshape(sz.m, -1, *x.shape[1:])[mesh.shards].reshape(
        -1, *x.shape[1:])

  torch.cuda.reset_peak_memory_stats()
  walls = []
  for _ in range(2):
    mesh.gathers = mesh.gather_bytes = 0
    sync()
    t0 = time.perf_counter()
    r = GD.greedi_sharded_fast(
        own(fsh), m=sz.m, kappa=sz.k, k_final=sz.k, gids=own(gids),
        liveness_age=own(dist_ages(sz)), liveness_deadline=DIST_DEADLINE,
        mesh=mesh)
    sync()
    walls.append(time.perf_counter() - t0)
  np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
           **{f: getattr(r, f).cpu().numpy() for f in (
               "sel_gids", "sel_valid", "alive", "value", "stage1_values")},
           wall_s=walls, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
           gathers=mesh.gathers, gather_bytes=mesh.gather_bytes)
  mesh.close()


def e2e_dist(sz: Sizes, stacked: dict):
  """The selection CLI under ``torch.distributed.run`` with 4 ranks (gloo,
  every rank on this card) at full size (n = 262144, d = 64, m = 16, k =
  kappa = 64): the fast engine flat and at tree b = 4, the generic engine
  flat.  Each run's ids must equal the stacked in-process run's bit for
  bit (``stacked``: e2e full-size's and e2e tree's CLI runs; the generic
  engine's flat run here) and each rank's peak must stay within a quarter
  of the stacked peak plus 0.5 GiB; a failed rank fails the smoke.  With
  4 or more cards the same runs go over nccl, one rank a card.  Beside
  them one library run, ``greedi_sharded_fast(mesh=)`` with rank 1's
  shards past the liveness deadline, against the stacked run with the
  same ages.  The gloo launches run side by side (``torchrun_async``), so
  each wall includes the host and the card shared with the others.
  Prints each run's wall time, its collectives and their bytes."""
  import numpy as np
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.launch import select as cli
  # --n-docs / --dim: torchrun's parser takes --n and --d for its own
  base = ["-m", "repro_torch.launch.select", "--n-docs", str(sz.n), "--dim",
          str(sz.d), "--k", str(sz.k), "--mesh", str(sz.m), "--no-coverage"]
  runs = {"fast": [], f"fast tree{sz.tree_b}": ["--merge-tree",
                                                str(sz.tree_b)],
          "generic": ["--no-fast"]}
  kernels = {"fast": ("pairwise", "relu_colsum"),
             "generic": ("facility_select", "facility_gain")}
  cards = torch.cuda.device_count()
  backends = ["gloo"] + (["nccl"] if cards >= DIST_RANKS else [])
  rows = {}
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    path = os.path.join(tmp, "generic.npy")
    res = timed_run(lambda: cli.main([*base[2:], "--no-fast", "--out",
                                      path]))
    stacked["generic"] = (np.load(path), res["peak_gib"])
    rows["stacked generic"] = dict(wall_s=res["wall_s"],
                                   peak_gib=res["peak_gib"])
    torch.cuda.empty_cache()
    # each backend's runs side by side (the gloo ones with the library
    # run): their rank peaks sum to about 52 GiB on the card
    live_dir = os.path.join(tmp, "liveness")
    os.mkdir(live_dir)
    live = None
    for backend in backends:
      started = {}
      for name, flags in runs.items():
        out, stats = (os.path.join(tmp, f"{backend}{len(started)}.{ext}")
                      for ext in ("npy", "json"))
        started[name] = (out, stats, torchrun_async(
            [*base, *flags, "--dist-backend", backend, "--out", out,
             "--stats-json", stats]))
      if live is None:
        live = torchrun_async([str(REPO / "chip_smoke.py"),
                               "--dist-liveness", live_dir])
      for name, (out, stats, launch) in started.items():
        wall, _ = launch.result()
        ids = np.load(out)
        with open(stats) as f:
          done = [r for r in json.load(f)["stats"] if r["event"] == "done"]
        check(len(done) == 1 and done[0]["world"] == DIST_RANKS,
              f"e2e dist {backend} {name}: done records {done}")
        done = done[0]
        want, peak = stacked[name]
        check(np.array_equal(ids, want), f"e2e dist {backend} {name}: ids "
              f"{ids.tolist()} differ from the stacked run's "
              f"{want.tolist()}")
        peaks = [float(p) for p in done["rank_peak_gib"].split(",")]
        limit = peak / DIST_RANKS + 0.5
        check(len(peaks) == DIST_RANKS and max(peaks) <= limit,
              f"e2e dist {backend} {name}: rank peaks {peaks} GiB over "
              f"{limit} (stacked {peak})")
        launched = dict(kv.split(":") for kv in done["launches"].split(",")
                        if ":" in kv)
        for kname in kernels[name.split()[0]]:
          check(int(launched.get(kname, 0)) > 0, f"e2e dist {backend} "
                f"{name}: rank 0 did not launch {kname} ({launched})")
        rows[f"{backend} {name}"] = dict(
            launch_wall_s=wall, select_wall_s=done["wall_s"],
            stacked_peak_gib=peak, rank_peak_gib=peaks, limit_gib=limit,
            gathers=done["gathers"], gather_bytes=done["gather_bytes"],
            launches=launched, ids_equal=True)
    # the library run: rank 1's shards dead through liveness
    wall, _ = live.result()
    ranks = [dict(np.load(os.path.join(live_dir, f"rank{r}.npz")))
             for r in range(DIST_RANKS)]
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  fsh, gids = fast_layout(feats, sz.m)
  ages = dist_ages(sz)
  res = timed_run(lambda: GD.greedi_sharded_fast(
      fsh, m=sz.m, kappa=sz.k, k_final=sz.k, gids=gids, liveness_age=ages,
      liveness_deadline=DIST_DEADLINE))
  want = res["result"]
  dead = (ages > DIST_DEADLINE).numpy()
  check(want.alive.cpu().numpy().tolist() == (~dead).tolist(),
        f"e2e dist liveness: stacked alive {want.alive.tolist()}")
  sel = selected(want, sz.n, sz.k, "e2e dist liveness")
  dead_rows = set(gids.reshape(sz.m, -1).cpu()[torch.as_tensor(dead)]
                  .reshape(-1).tolist())
  check(not dead_rows & set(sel.tolist()), "e2e dist liveness: a dead "
        "shard's row was selected")
  rel = 0.0
  for r, got in enumerate(ranks):
    for f in ("sel_gids", "sel_valid", "alive"):
      check(np.array_equal(got[f], getattr(want, f).cpu().numpy()),
            f"e2e dist liveness: rank {r} {f} differs from the stacked run")
    for f in ("value", "stage1_values"):
      w = getattr(want, f).cpu().numpy()
      ok = np.isfinite(w)
      check(np.array_equal(np.isfinite(got[f]), ok), f"e2e dist liveness: "
            f"rank {r} {f} {got[f]} against {w}")
      rel = max(rel, float(np.max(np.abs(got[f][ok] - w[ok]) /
                                  np.abs(w[ok]))))
  check(rel <= 1e-5, f"e2e dist liveness: values differ by {rel} relative")
  peaks = [float(g["peak_gib"]) for g in ranks]
  limit = res["peak_gib"] / DIST_RANKS + 0.5
  check(max(peaks) <= limit, f"e2e dist liveness: rank peaks {peaks} over "
        f"{limit}")
  rows["gloo liveness"] = dict(
      launch_wall_s=wall,
      select_wall_s_first_second=[g["wall_s"].tolist() for g in ranks],
      stacked_wall_s=res["wall_s"], stacked_peak_gib=res["peak_gib"],
      rank_peak_gib=peaks, limit_gib=limit,
      gathers=int(ranks[0]["gathers"]),
      gather_bytes=int(ranks[0]["gather_bytes"]), ids_equal=True,
      alive=int((~dead).sum()), values_max_rel=rel)
  nccl = ("run, one rank a card" if "nccl" in backends else
          f"not run: {cards} card(s) here and nccl puts one rank on each "
          f"of {DIST_RANKS} cards")
  emit("e2e dist", n=sz.n, d=sz.d, k=sz.k, m=sz.m, ranks=DIST_RANKS,
       shards_a_rank=sz.m // DIST_RANKS, nccl=nccl,
       launches_side_by_side=len(runs) + 1, runs=rows)


def e2e_pre(sz: Sizes, ref_sel, fast_sel):
  """FacilityLocationPre (linear) through ``greedi_reference`` at full size
  (n = 262144, m = 16, k = kappa = 64, local evaluation), the same rows and
  partition as ``e2e full-size``: round 1 caches the (16, 16384, 16384)
  block (16 GiB) through one ``pairwise`` launch, round 2 the (262144,
  1024) block (1 GiB), and every step is one ``relu_colsum`` launch (128
  in all).  Held against the FacilityLocation reference path and the fast
  engine (which caches the same ``pairwise`` bits) under the ``agree``
  rule.  Returns the launch counts by path."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  pre = O.FacilityLocationPre(kernel="linear")
  # twice: the first run in a process once stalled 3.6 s (section 7 of
  # PERF.md), so the second, the same selection, is reported beside it
  runs = [timed_run(lambda: GD.greedi_reference(
      torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
      k_final=sz.k, objective=pre, local_eval=True,
      init_for=lambda ef, em, cf: pre.init(ef, em, cf))) for _ in range(2)]
  run = runs[0]
  sel = selected(run["result"], sz.n, sz.k, "e2e pre")
  check(bool((runs[1]["result"].sel_gids == run["result"].sel_gids).all()),
        "e2e pre: the second run selected another coreset")
  n_colsum = run["launches"]["relu_colsum"]
  check(n_colsum == 2 * sz.k, f"e2e pre: {n_colsum} relu_colsum launches, "
        f"expected {2 * sz.k} (one a step)")
  check(run["launches"]["pairwise"] == 2 and not any(
      run["launches"][k] for k in ("facility_select", "facility_gain")),
        f"e2e pre: launches {run['launches']}")
  verdicts = {"pre vs reference": agree(feats, sel, ref_sel,
                                        "e2e pre/reference"),
              "pre vs fast": agree(feats, sel, fast_sel, "e2e pre/fast")}
  emit("e2e pre full-size", n=sz.n, d=sz.d, k=sz.k, m=sz.m,
       cache_gib={"round1": sz.m * (sz.n // sz.m) ** 2 * 4 / 2**30,
                  "round2": sz.n * sz.m * sz.k * 4 / 2**30},
       wall_s=[r["wall_s"] for r in runs],
       peak_gib=[r["peak_gib"] for r in runs],
       launches={k: v for k, v in run["launches"].items() if v},
       agreement=verdicts, value=float(run["result"].value))
  return {"pre": run["launches"]}


def e2e_exemplar(sz: Sizes):
  """The k-medoid surrogate of Eq. (6): FacilityLocation(kernel =
  "neg_sq_dist", baseline = -1) on unit rows (the phantom exemplar at the
  origin), the generic path (cuBLAS blocks of at most
  ``objectives._GENERIC_BLOCK_BYTES``, each through the ``relu_colsum``
  kernel).  At full size ``greedi_reference`` (local evaluation) and the
  generic ``greedi_sharded`` on one partition must agree; at the CLI size
  GreeDi against ``centralized_greedy``, f(GreeDi) / f(central) at or
  above the Thm-4 floor.  Returns the launch counts by path."""
  import torch

  from repro_torch.core import bounds
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  obj = O.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0)
  init = obj.init
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  fsh, gids = fast_layout(feats, sz.m)
  npp = sz.n // sz.m
  runs = {
      "exemplar_reference": timed_run(lambda: GD.greedi_reference(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k, objective=obj, init_for=init, local_eval=True)),
      "exemplar_generic": timed_run(lambda: GD.greedi_sharded(
          fsh, m=sz.m, kappa=sz.k, k_final=sz.k, objective=obj,
          gids=gids)),
  }
  sels = {k: selected(v["result"], sz.n, sz.k, f"e2e exemplar {k}")
          for k, v in runs.items()}
  engines = agree(feats, sels["exemplar_reference"],
                  sels["exemplar_generic"], "e2e exemplar reference/generic",
                  obj)
  for name, run in runs.items():
    check(run["launches"]["relu_colsum"] > 0 and not any(
        run["launches"][k] for k in ("facility_select", "facility_gain",
                                     "pairwise")),
          f"e2e exemplar {name}: launches {run['launches']}")
  # round 1's step: candidate chunks of the byte budget over the stacked
  # (m, npp, npp) block, a cuBLAS product and a relu_colsum launch each
  chunk = O._chunk_cols(sz.m, npp)
  per_step = -(-npp // chunk)
  check(runs["exemplar_reference"]["launches"]["relu_colsum"] ==
        sz.k * per_step + sz.k * -(-sz.m * sz.k // O._chunk_cols(1, sz.n)),
        "e2e exemplar: relu_colsum launches a step")
  # the CLI size: GreeDi against the centralized greedy
  cli = EmbeddedCorpus(n_docs=sz.n_cli, feat_dim=sz.d, seed=0).features()
  small = {
      "exemplar_cli_greedi": timed_run(lambda: GD.greedi_reference(
          torch.Generator().manual_seed(0), cli, m=sz.m_cli, kappa=sz.k,
          k_final=sz.k, objective=obj, init_for=init, local_eval=True)),
      "exemplar_cli_central": timed_run(lambda: GD.centralized_greedy(
          cli, sz.k, objective=obj, init_for=init)),
  }
  v_g = float(small["exemplar_cli_greedi"]["result"].value)
  v_c = float(small["exemplar_cli_central"]["result"][1])
  floor = bounds.thm4_bound(sz.m_cli, sz.k, sz.k)
  check(v_g / v_c >= floor, f"e2e exemplar: f(GreeDi) / f(central) "
        f"{v_g / v_c} below the Thm-4 floor {floor}")
  runs.update(small)
  budget = O._GENERIC_BLOCK_BYTES / 2**30
  emit("e2e exemplar", n=sz.n, d=sz.d, k=sz.k, m=sz.m, baseline=-1.0,
       block_budget_gib=budget, round1_chunks_a_step=per_step,
       round1_cublas_a_step=per_step, round1_relu_colsum_a_step=per_step,
       wall_s={k: v["wall_s"] for k, v in runs.items()},
       peak_gib={k: v["peak_gib"] for k, v in runs.items()},
       relu_colsum_launches={k: v["launches"]["relu_colsum"]
                             for k, v in runs.items()},
       agreement={"reference vs generic": engines},
       cli_ratio=v_g / v_c, thm4_floor=floor,
       value=float(runs["exemplar_reference"]["result"].value))
  return {k: v["launches"] for k, v in runs.items()}


def e2e_modular(sz: Sizes):
  """``Modular`` (f(S) = sum relu(w . x)) through ``greedi_reference`` and
  ``centralized_greedy`` at n = 262144: GreeDi is exact for a modular f,
  so the ids must be equal (both the top k by weight)."""
  import numpy as np
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  w = torch.randn((sz.d,), generator=torch.Generator(device=DEVICE)
                  .manual_seed(7), device=DEVICE)
  obj = O.Modular()
  init = lambda ef, em: obj.init_w(w)  # noqa: E731
  g = timed_run(lambda: GD.greedi_reference(
      torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
      k_final=sz.k, objective=obj, init_for=init))
  c = timed_run(lambda: GD.centralized_greedy(feats, sz.k, objective=obj,
                                              init_for=init))
  gs = selected(g["result"], sz.n, sz.k, "e2e modular")
  cs = c["result"][0].idx.cpu().numpy()
  top = torch.topk(torch.clamp_min(feats @ w, 0.0), sz.k).indices
  check(np.array_equal(gs, cs) and set(cs.tolist()) == set(
      top.cpu().tolist()), f"e2e modular: GreeDi {gs} and centralized "
        f"{cs} differ (or miss the top k)")
  emit("e2e modular", n=sz.n, d=sz.d, k=sz.k, m=sz.m, ids_equal=True,
       wall_s={"greedi": g["wall_s"], "central": c["wall_s"]},
       value=float(g["result"].value),
       value_central=float(c["result"][1]))


def parse_prometheus(text: str) -> dict:
  """{series: value} of a Prometheus text exposition (``name{labels}``
  keys), checking every line is a comment or a sample."""
  out = {}
  for line in text.splitlines():
    if not line or line.startswith("#"):
      continue
    key, _, val = line.rpartition(" ")
    check(bool(key) and (key.split("{")[0].replace("_", "").isalnum()),
          f"/metrics: bad line {line!r}")
    out[key] = float(val.replace("+Inf", "inf"))
  return out


def e2e_obs(sz: Sizes):
  """The e2e query facility service (16 appends of 16,384 rows, a
  ``query()`` after each, one 64-request batch, two epochs) with obs off
  and with ``obs.enable(trace_out=...)`` and a ``Sidecar`` on port 0: the
  spans by name against the calls made; the device-fed series (eval mass a
  shard, merge peak rows, admissions) and ``repro_epochs_total``; a
  ``/metrics`` scrape over 127.0.0.1, parsed; a ``POST /healthz`` beat
  moving the board's age; host syncs of an append chunk and of a query
  tile (0 and 1 with obs off); the epoch wall and the ingest rows/s each
  way, and then epochs of the same service with obs off and on in turns
  (``obs_turns`` of each: epoch walls spread by tens of percent from one
  service to the next)."""
  import json
  import urllib.request

  import torch

  from repro_torch import obs
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.service import SelectionService
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  step = sz.n // sz.query_appends
  chunks = step // sz.append_block
  report = {}
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    trace = os.path.join(tmp, "trace.jsonl")
    for on in (False, True):
      torch.cuda.empty_cache()
      obs.REGISTRY.reset()
      side = None
      if on:
        obs.enable(trace_out=trace)
      try:
        svc = SelectionService(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k,
                               capacity=sz.svc_cap0,
                               append_block=sz.append_block, seed=0)
        if on:
          side = obs.Sidecar(board=svc.board, port=0)
        wall, ids = 0.0, 0
        for a in range(sz.query_appends):
          part = feats[a * step:(a + 1) * step]
          sync()
          t0 = time.perf_counter()
          if a == sz.query_appends - 1:
            _, n_sync = count_syncs(lambda p=part: svc.append(p))
          else:
            svc.append(part)
          sync()
          wall += time.perf_counter() - t0
          if a == sz.query_appends - 1:
            q, q_sync = count_syncs(svc.query)
          else:
            q = svc.query()
          ids += len(q.sel_gids)
        reqs = query_requests(q.sel_gids, sz.query_b, sz.k,
                              svc.store.query_mask_cap)
        svc.query_batch(reqs)
        epochs = [svc.epoch().stats.wall_s for _ in range(2)]
        snap = obs.REGISTRY.snapshot()
        row = dict(rows_per_s=sz.n / wall, append_s=wall,
                   syncs_per_chunk=n_sync / chunks, query_syncs=q_sync,
                   epoch_wall_s=epochs)
        if on:
          body = urllib.request.urlopen(side.url + "/metrics",
                                        timeout=30).read().decode()
          scraped = parse_prometheus(body)
          before = svc.board.ages()
          time.sleep(0.05)
          req = urllib.request.Request(side.url + "/healthz?shard=3",
                                       data=b"", method="POST")
          beat = json.loads(urllib.request.urlopen(req, timeout=30).read())
          after = svc.board.ages()
          check(beat == {"ok": True, "shard": 3} and after[3] < before[3]
                and after[3] < after[2], f"e2e obs: POST /healthz did not "
                f"move shard 3's age ({before} -> {after})")
          row.update(scraped_series=len(scraped), beat_age_s=[
              float(before[3]), float(after[3])])
      finally:
        if side is not None:
          side.close()
        obs.disable()
      if not on:
        check(n_sync == 0 and q_sync == 1, f"e2e obs: with obs off an "
              f"append chunk made {n_sync / chunks} host syncs and a query "
              f"{q_sync}, expected 0 and 1")
        for name in ("repro_epoch_eval_mass", "repro_sieve_admissions_total"):
          check(name not in snap, f"e2e obs: {name} read with obs off")
      else:
        recs = [json.loads(line) for line in open(trace)]
        names = {}
        for r in recs:
          check(set(r) == {"name", "ts", "dur_s", "pid", "tid", "attrs"},
                f"e2e obs: span record keys {sorted(r)}")
          names[r["name"]] = names.get(r["name"], 0) + 1
        want = {"service.query": sz.query_appends, "service.query_batch": 1,
                "service.epoch": 2}
        check(names == want, f"e2e obs: spans {names}, expected {want}")
        mass = snap["repro_epoch_eval_mass"]["series"]
        rows = snap["repro_merge_peak_rows"]["series"]
        adm = snap["repro_sieve_admissions_total"]["series"][0]["value"]
        check(len(mass) == sz.m and all(s["value"] > 0 for s in mass) and
              len(rows) == sz.m and all(s["value"] == sz.m * sz.k
                                        for s in rows) and adm > 0 and
              snap["repro_epochs_total"]["series"][0]["value"] == 2,
              "e2e obs: device-fed series missing or zero")
        check(scraped.get("repro_epochs_total") == 2.0 and
              scraped.get('repro_epoch_eval_mass{shard="0"}') ==
              mass[0]["value"], "e2e obs: /metrics does not carry the "
              "registry's series")
        row.update(spans=names, admissions=adm,
                   eval_mass=[s["value"] for s in mass])
      report["on" if on else "off"] = row
    # the epoch's obs overhead on one service, in turns: off, on, ...
    alt = {"off": [], "on": []}
    for _ in range(sz.obs_turns):
      for mode in ("off", "on"):
        if mode == "on":
          obs.enable(trace_out=os.path.join(tmp, "turns.jsonl"))
        try:
          alt[mode].append(svc.epoch().stats.wall_s)
        finally:
          obs.disable()
    report["epoch_wall_s_in_turns"] = alt
    del svc
  emit("e2e obs", n=sz.n, d=sz.d, m=sz.m, k=sz.k, appends=sz.query_appends,
       **report)


def cli_obs_run(sz: Sizes):
  """``python -m repro_torch.launch.select`` in service mode at the CLI
  size with ``--trace-out``, ``--stats-json`` and ``--metrics-port 0``:
  its files parsed (a span an epoch, a record a stats line, the registry
  snapshot).  Returns the phase's fields."""
  import json
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    trace, stats = os.path.join(tmp, "t.jsonl"), os.path.join(tmp, "s.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.select", "--n",
           str(sz.n_cli), "--d", str(sz.d), "--k", str(sz.k), "--mesh",
           str(sz.m_cli), "--epochs", "2", "--append-frac", "0.25",
           "--no-coverage", "--trace-out", trace, "--stats-json", stats,
           "--metrics-port", "0", "--device", DEVICE]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(
                             SRC)))
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"CLI obs run failed: {out.stderr[-2000:]}")
    recs = [json.loads(line) for line in open(trace)]
    payload = json.load(open(stats))
  epochs = [r for r in recs if r["name"] == "service.epoch"]
  events = [r["event"] for r in payload["stats"]]
  check(len(epochs) == 2 and events.count("epoch") == 2 and "done" in events
        and "sidecar" in events and payload["metrics"]["repro_epochs_total"][
            "series"][0]["value"] == 2 and len(payload["metrics"][
                "repro_epoch_eval_mass"]["series"]) == sz.m_cli,
        f"CLI obs run: spans {len(epochs)}, events {events}")
  return dict(n=sz.n_cli, m=sz.m_cli, wall_s=wall, spans=len(recs),
              events=events, metrics=len(payload["metrics"]),
              epoch_wall_s=[r["dur_s"] for r in epochs])


def colsum_phase(label, s, cov, cols, launches, full=None):
  """The relu column-sum kernel against its plain version on one call
  (``cols`` None: a full pass), within 1e-5 relative and reported bit for
  bit; a gathered call's columns must have the full pass's bits
  (``full``).  Bound: the bytes of the values summed, cov, the ids and the
  output at 3.35 TB/s; a gathered call reads a 32-byte sector for each
  4-byte value, 8 x its useful bytes, given as ``sector_bound_ms``."""
  import torch

  from repro_torch.kernels import ops, ref
  m, nl = cov.shape
  out = ops.relu_colsum(s, cov, cols)
  sync()
  want = ref.relu_colsum_ref(s, cov, cols)
  ea, er = errors(out, want)
  check(er <= 1e-5, f"relu_colsum {label}: relative error {er:.3e} > 1e-5")
  if full is not None:
    check(torch.equal(out, torch.gather(full, 1, cols)), f"relu_colsum "
          f"{label}: a gathered column's bits differ from the full pass's")
  t = out.shape[1]
  k_ms = time_ms(lambda: ops.relu_colsum(s, cov, cols), reps=5)
  p_ms = time_ms(lambda: ref.relu_colsum_ref(s, cov, cols), reps=1)
  ids = 0 if cols is None else m * t * 8
  moved = m * nl * t * 4 + m * nl * 4 + m * t * 4 + ids
  bms, by = bound_ms(moved, 3.0 * m * nl * t, "f32")
  row = dict(shape=[m, nl, s.shape[2], t], gathered=cols is not None,
             pitch=s.stride(1), max_abs_err=ea, max_rel_err=er,
             bits_equal_plain=bool(torch.equal(out, want)), tol=1e-5,
             kernel_ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=bms,
             bound_by=by, launches=launches)
  if cols is not None:
    row["sector_bound_ms"] = (m * nl * t * 32 + moved - m * nl * t * 4) / (
        PEAK_BYTES_S) * 1e3
  emit(f"kernel relu_colsum {label}", **row)
  return row


def colsum_kernel_phase(sz: Sizes, launches: int):
  """The relu column-sum kernel at the shapes the fast engine gives it:
  the round-1 block (16 x 16384 x 16384, 16 GiB) in a full pass and in a
  256-column gathered tile (a lazy rescan), the round-2 block (16 x 16384
  x 1024), and a ragged nl over pitched rows (1000 of 1024).  The blocks
  are real similarity blocks (``pairwise`` of unit rows), cov the
  coverage after 8 picks."""
  import torch

  from repro_torch.kernels import ops
  g = torch.Generator(device=DEVICE).manual_seed(1)
  nl = sz.n // sz.m
  rows = {}
  local = unit_rows(g, sz.m, nl, sz.d)
  s11 = ops.pairwise(local, local, kernel="linear")
  cov = s11[:, :, :8].amax(dim=2).clamp_min(0.0)
  rows[("relu_colsum", "full")] = colsum_phase("full", s11, cov, None,
                                               launches)
  full = ops.relu_colsum(s11, cov)
  cols = torch.argsort(torch.rand(sz.m, nl, generator=g, device=DEVICE),
                       dim=1)[:, :sz.tile]
  rows[("relu_colsum", "gathered")] = colsum_phase(
      f"gathered {sz.tile}", s11, cov, cols, launches, full=full)
  del s11, full
  torch.cuda.empty_cache()
  merged = unit_rows(g, sz.m * sz.k, sz.d)
  s2 = ops.pairwise(local, merged, kernel="linear")
  cov = s2[:, :, :8].amax(dim=2).clamp_min(0.0)
  rows[("relu_colsum", "round2")] = colsum_phase("round2", s2, cov, None,
                                                 launches)
  del s2, local, merged
  ev = unit_rows(g, sz.m, sz.ragged_nl, sz.d)
  y = unit_rows(g, sz.ragged_nc, sz.d)
  buf = torch.empty((sz.m, sz.ragged_nl, 1024), device=DEVICE)
  s = buf[..., :sz.ragged_nc]
  s.copy_(ops.pairwise(ev, y, kernel="linear"))
  cov = s[:, :, :8].amax(dim=2).clamp_min(0.0)
  rows[("relu_colsum", "ragged")] = colsum_phase("ragged pitched", s, cov,
                                                 None, launches)
  del buf, s, ev, y
  torch.cuda.empty_cache()
  return rows


def colsum_kernels_per_call(sz: Sizes, row: dict) -> None:
  """CUDA kernels a relu column-sum call runs at the round-2 shape (2: the
  chunk sums and their fold), counted by the profiler into ``row`` (the
  kernels line's)."""
  import torch

  from repro_torch.kernels import ops
  g = torch.Generator(device=DEVICE).manual_seed(2)
  s = unit_rows(g, sz.m, sz.n // sz.m, sz.m * sz.k)  # round 2's nl and nc
  cov = s[:, :, :8].amax(dim=2).clamp_min(0.0)
  per_call, records, names = kernels_per_call(
      lambda: ops.relu_colsum(s, cov))
  check(all(c == 2 for c in per_call), f"relu_colsum: {per_call} kernel "
        f"launches a call in the profiled windows ({names}), expected 2 in "
        "each")
  row["kernels_per_call"] = per_call[0]
  emit("kernel relu_colsum kernels per call", kernels_per_call=per_call,
       device_records_per_call=records, kernel_names=names)


def e2e_wide(sz: Sizes):
  """The coreset main path at a sentence-embedding width (n = 262144, d =
  ``sz.wide_d``, k = kappa = 64, m = 16, f32): the reference protocol's
  fused select path and the fast engine through the CLI (``--d``), each
  with the launch counts set to 0 before it and read after it, by kernel
  and by ring mode.  Every pairwise and facility-family launch must be on
  the ring the rule names at this width (streamed), and the two paths
  must select the same ids or meet the near-tie rule.  Returns the counts
  by path."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.kernels import ops, ring
  from repro_torch.launch import select as cli
  d = sz.wide_d
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=d, seed=0).features()
  sync()
  torch.cuda.empty_cache()
  out, counts, modes = {}, {}, {}
  (REPO / "build").mkdir(exist_ok=True)
  for name in ("reference", "fast"):
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    if name == "reference":
      sel = greedi_select_indices(torch.Generator().manual_seed(0), feats,
                                  m=sz.m, kappa=sz.k, k_final=sz.k)
    else:
      with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "sel.npy")
        cli.main(["--n", str(sz.n), "--d", str(d), "--k", str(sz.k),
                  "--mesh", str(sz.m), "--no-coverage", "--out", path])
        sel = np.load(path)
    sync()
    out[name] = dict(sel=sel, wall_s=time.perf_counter() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    counts[name] = ops.launch_counts()
    modes[name] = {f"{k} {m}": c for (k, m), c in
                   sorted(ring.mode_launches.items())}
    check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k and
          sel.min() >= 0 and sel.max() < sz.n, f"e2e wide {name}: bad "
          "selection")
    for (kernel, mode), c in ring.mode_launches.items():
      want = ring.plan("pairwise" if kernel == "pairwise" else "facility",
                       d, 4).mode
      check(mode == want, f"e2e wide {name}: {c} {kernel} launches on the "
            f"{mode} ring, the rule names {want}")
  check(counts["reference"]["facility_select"] > 0 and
        counts["fast"]["pairwise"] > 0, f"e2e wide: kernels not launched "
        f"({counts})")
  verdict = agree(feats, out["reference"]["sel"], out["fast"]["sel"],
                  "e2e wide reference/fast")
  emit("e2e wide", n=sz.n, d=d, k=sz.k, m=sz.m, dtype="f32",
       wall_s={k: v["wall_s"] for k, v in out.items()},
       peak_gib={k: v["peak_gib"] for k, v in out.items()},
       launches=counts, ring_launches=modes,
       agreement={"reference vs fast": verdict},
       value=value_of(feats, out["reference"]["sel"]))
  return counts


def profiled(label: str, run, groups: dict | None = None) -> None:
  """Run ``run`` once under torch.profiler (CPU and CUDA activity) and
  report device time by kernel name, summed over the run, the number of
  kernel launches, and the device busy share (kernel time over the
  profiled wall time, which the profiler itself lengthens, so the share is
  a lower bound).  ``groups`` (name ->
  substrings of kernel names) adds the device time of each group and of
  the rest.  Only the CUDA activity is recorded (the kernels and the
  runtime calls that launch them): the host's operator events, several a
  kernel, made the profiler's own processing the larger part of a
  profile's time."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.empty_cache()
  sync()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    sync()
    wall = time.perf_counter() - t0
  kern = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
  top = sorted(kern, key=lambda e: e.self_device_time_total,
               reverse=True)[:6]
  by_group = None
  if groups and kern:
    by_group = dict.fromkeys([*groups, "rest"], 0.0)
    for e in kern:
      name = e.key.lower()
      hit = next((gname for gname, keys in groups.items()
                  if any(key in name for key in keys)), "rest")
      by_group[hit] += e.self_device_time_total / 1e3
  emit(label, wall_s=wall,
       device_ms=busy_ms if kern else "not measured",
       busy_share=busy_ms / 1e3 / wall if kern else "not measured",
       kernel_launches=sum(e.count for e in kern),
       **({"by_group_ms": by_group} if groups else {}),
       top=[dict(kernel=e.key[:70], calls=e.count,
                 ms=e.self_device_time_total / 1e3) for e in top])


# torch.profiler can drop a window's first device records, more of them the
# longer the process has profiled, while the launch calls it records on the
# host are complete (``python -m repro_torch.kernels.diagnose profiler
# --gap-s 240``, PERF.md section 7).  So a call's kernels are counted by its
# launch calls, each count in three windows, and the device records are
# reported beside them.
COUNT_WINDOWS = 3
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")  # cudart and cu* launch calls


def kernels_per_call(fn):
  """Kernel launches a call of ``fn`` makes, read by torch.profiler in each
  of ``COUNT_WINDOWS`` windows of 3 calls after a warm-up call: (launch
  calls a call in each window, device records a call in each window, the
  kernels' names)."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  fn()
  sync()
  launches, records, names = [], [], set()
  for _ in range(COUNT_WINDOWS):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
      for _ in range(3):
        fn()
      sync()
    evs = prof.events()
    launches.append(sum(e.device_type == DeviceType.CPU and
                        e.name.startswith(LAUNCH_CALLS) for e in evs) / 3)
    kern = [e for e in evs if e.device_type == DeviceType.CUDA]
    records.append(len(kern) / 3)
    names |= {e.name.split("(")[0][-60:] for e in kern}
  return launches, records, sorted(names)


def profile_phase(sz: Sizes):
  """Where the full-size coreset time goes: each path once under
  ``profiled``.  Runs after the main path's launch counts were read."""
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (greedi_select_indices,
                                          greedi_select_indices_sharded)
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  paths = {
      "reference": lambda: greedi_select_indices(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k),
      "fast": lambda: greedi_select_indices_sharded(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k),
      "fast lazy": lambda: greedi_select_indices_sharded(
          torch.Generator().manual_seed(0), feats, m=sz.m, kappa=sz.k,
          k_final=sz.k, mode="lazy"),
  }
  groups = {"relu_colsum": ("colsum",), "pairwise": ("pairwise",)}
  for name, run in paths.items():
    profiled(f"profile {name}", run,
             groups=None if name == "reference" else groups)


# ---------------------------------------------------------------------------
# the GP active-set path: information gain through the info-gain kernels
# ---------------------------------------------------------------------------


def parkinsons_like(n, d, seed):
  """Rows of width d, correlated and centered, normalized to unit norm the
  way benchmarks/common.py ``parkinsons_like`` normalizes them (Sec. 6.2),
  drawn on the card from a seeded generator."""
  import torch
  g = torch.Generator(device=DEVICE).manual_seed(seed)
  f = torch.randn((n, d), generator=g, device=DEVICE)
  corr = torch.randn((d, d), generator=g, device=DEVICE) * 0.4 + torch.eye(
      d, device=DEVICE)
  f = f @ corr
  f -= f.mean(dim=0)
  return f / torch.linalg.norm(f, dim=1, keepdim=True)


def ig_operands(g, P, k_max, count, nc, d, kernel, td, ridge=1.0,
                h=0.75, shared=False):
  """Selections of ``count`` unit rows, the masked inverse Cholesky factor
  of K_SS + ridge I (float64, then float32, as the objective feeds the
  kernels) and unit candidates; P = None for unbatched operands."""
  import torch
  lead = () if P is None else (P,)
  sel = unit_rows(g, *lead, k_max, d)
  live = torch.arange(k_max, device=DEVICE) < count
  sel = torch.where(live[:, None], sel, 0.0)
  s = sel.double()
  if kernel == "rbf":
    d2 = ((s * s).sum(-1, keepdim=True) - 2 * s @ s.mT
          + (s * s).sum(-1)[..., None, :])
    kss = torch.exp(-d2.clamp_min(0) / (h * h))
  else:
    kss = s @ s.mT
  both = live[:, None] & live[None, :]
  eye = torch.eye(k_max, device=DEVICE, dtype=torch.float64)
  kss = torch.where(both, kss + ridge * eye, eye)
  linv = torch.linalg.solve_triangular(torch.linalg.cholesky(kss),
                                       eye.expand_as(kss), upper=False)
  linv = torch.where(live, linv, 0.0).float().contiguous()
  cand = unit_rows(g, *(() if shared else lead), nc, d)
  return sel.to(td).contiguous(), linv, cand.to(td)


def ig_compare(label, got, best, idx, want, ok, dtype, abs_tol=None):
  """The info-gain kernels' outputs (cond ``got``, top-1 ``best``/``idx``)
  against the plain conds ``want`` of the same inputs: conds within the
  tolerance (relative, or ``abs_tol`` absolute), the top-1 index equal or a
  near-tie at a feasible candidate, the best cond within the tolerance.
  Returns (cond abs error, cond rel error, best abs error, near-ties)."""
  from repro_torch.kernels import ref
  ea, er = errors(got, want)
  if abs_tol is not None:
    check(ea <= abs_tol, f"{label}: cond error {ea:.3e} > {abs_tol:.1e}")
  else:
    check(er <= TOL[dtype], f"{label}: cond error {er:.3e} > {TOL[dtype]}")
  wb, wi = ref.masked_top1(want, ok, floor=0.0)
  same = idx == wi
  picked = want.gather(-1, idx.unsqueeze(-1))[..., 0]
  gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
  okp = ok.gather(-1, idx.unsqueeze(-1))[..., 0]
  tie = (~same) & (gap <= TOL[dtype]) & okp
  check(bool((same | tie).all()), f"{label}: index {idx.tolist()} vs "
        f"{wi.tolist()} beyond a near-tie")
  eb, _ = errors(best, wb)
  check(eb <= TOL[dtype] * max(float(wb.abs().max()), 1.0),
        f"{label}: best error {eb:.3e}")
  return ea, er, eb, int(tie.sum())


def ig_check(label, sel, linv, cand, ok, kernel, dtype, ridge=1.0,
             h=0.75, live=None):
  """Both info-gain kernels against the plain version on one operand set
  (``ig_compare``; a DPP ridge holds conds to TOL_DPP times k_vv,
  absolute), with the selection-count contract ``live`` or dense.
  Returns (max abs error, near-ties)."""
  from repro_torch.kernels import ops, ref
  kw = dict(kernel=kernel, h=h, ridge=ridge, live=live)
  got = ops.info_gain_cond(sel, linv, cand, **kw)
  best, idx = ops.info_select(sel, linv, cand, ok, **kw)
  sync()
  want = ref.info_gain_cond_ref(sel, linv, cand, **kw)
  abs_tol = None
  if ridge < 1e-3:  # DPP: cond is a difference of nearly equal numbers
    c = cand.float()
    kvv = 1.0 if kernel == "rbf" else float((c * c).sum(-1).max())
    abs_tol = TOL_DPP * kvv
  ea, _, _, ties = ig_compare(label, got, best, idx, want, ok, dtype,
                              abs_tol)
  return ea, ties


def with_junk(g, linv, count):
  """``linv`` with random values in its upper triangle and in the rows and
  columns at or past ``count``: what the live contract masks."""
  import torch
  k = linv.shape[-1]
  ar = torch.arange(k, device=DEVICE)
  live = ar < count
  keep = live[:, None] & live[None, :] & (ar[:, None] >= ar[None, :])
  junk = torch.randn(linv.shape, generator=g, device=DEVICE)
  return torch.where(keep, linv, junk).contiguous()


def ig_edge_phase():
  """The info-gain kernels against their plain versions at the edges, each
  case dense and with the selection counts (``live``, on a linv carrying
  junk past its live triangle): ragged nc, k_max of 1, 7, 80, 128 and 400
  (past the shared-memory panels of linv), counts 0 / partial / k_max,
  shapes past the staged modes' shared memory ((k, d) of (512, 64),
  (64, 768), (2100, 6) and (5000, 6), the last with X in device scratch),
  partitions of different counts in one launch, linear and rbf, f32 and
  bf16, a DPP ridge, a zero candidate row, nothing feasible, identical
  rows, and a shared candidate block equal to per-partition calls."""
  import torch

  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(12)
  worst = {"dense": 0.0, "live": 0.0}
  n_cases = 0
  for k_max in (1, 7, 80, 128, 400):
    for count in sorted({0, k_max // 2, k_max}):
      for kernel in ("linear", "rbf"):
        for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
          sel, linv, cand = ig_operands(g, 3, k_max, count, 1037, 22, kernel,
                                        td)
          cand[1, 5] = 0.0  # a zero candidate row
          ok = torch.rand(3, 1037, generator=g, device=DEVICE) > 0.3
          label = f"edge k={k_max} count={count} {kernel} {dtype}"
          ea, _ = ig_check(label, sel, linv, cand, ok, kernel, dtype)
          worst["dense"] = max(worst["dense"], ea)
          live = torch.full((3,), count, device=DEVICE)
          el, _ = ig_check(label + " live", sel, with_junk(g, linv, count),
                           cand, ok, kernel, dtype, live=live)
          worst["live"] = max(worst["live"], el)
          n_cases += 2
  # partitions of different counts in one launch, each against its own
  # dense call on the masked factor
  for k_max, counts in ((128, (0, 37, 128)), (400, (5, 200, 400))):
    parts = [ig_operands(g, None, k_max, c, 1500, 6, "rbf", torch.float32)
             for c in counts]
    sel = torch.stack([o[0] for o in parts])
    linv = torch.stack([with_junk(g, o[1], c) for o, c in zip(parts,
                                                                counts)])
    cand = torch.stack([o[2] for o in parts])
    ok = torch.rand(3, 1500, generator=g, device=DEVICE) > 0.2
    live = torch.tensor(counts, device=DEVICE)
    ea, _ = ig_check(f"edge mixed counts {counts}", sel, linv, cand, ok,
                     "rbf", "f32", live=live)
    worst["live"] = max(worst["live"], ea)
    for p, o in enumerate(parts):
      _, er = errors(ops.info_gain_cond(sel, linv, cand, live=live)[p],
                     ops.info_gain_cond(o[0], o[1], o[2]))
      check(er <= TOL["f32"], f"mixed counts {counts}, partition {p}: "
            f"{er:.3e} against its dense call")
    n_cases += 1
  # shapes past the staged modes' shared memory (the GENERIC mode): X in
  # shared memory at d 64 / k 512, d 768 / k 64 and k 2100 (past 256
  # slots), in the per-block device scratch at k 5000
  for k_max, counts, nc, d, dtypes in (
      (512, (300, 512), 700, 64, ("f32", "bf16")),
      (64, (10, 64), 500, 768, ("f32", "bf16")),
      (2100, (2100,), 300, 6, ("f32",)), (5000, (4000, 5000), 200, 6, ("f32",))):
    for kernel in ("linear", "rbf"):
      for dtype in dtypes:
        td = torch.float32 if dtype == "f32" else torch.bfloat16
        parts = [ig_operands(g, None, k_max, c, nc, d, kernel, td)
                 for c in counts]
        sel = torch.stack([o[0] for o in parts])
        clean = torch.stack([o[1] for o in parts])
        cand = torch.stack([o[2] for o in parts])
        ok = torch.rand(len(counts), nc, generator=g, device=DEVICE) > 0.2
        label = f"edge past smem k={k_max} d={d} {kernel} {dtype}"
        ea, _ = ig_check(label, sel, clean, cand, ok, kernel, dtype)
        worst["dense"] = max(worst["dense"], ea)
        junk = torch.stack([with_junk(g, o[1], c)
                            for o, c in zip(parts, counts)])
        el, _ = ig_check(label + " live", sel, junk, cand, ok, kernel, dtype,
                         live=torch.tensor(counts, device=DEVICE))
        worst["live"] = max(worst["live"], el)
        n_cases += 2
        del parts, sel, clean, cand, junk
  # a DPP ridge: cond = k_vv + 1e-6 - |L^-1 k|^2 cancels
  sel, linv, cand = ig_operands(g, 2, 64, 40, 700, 6, "rbf", torch.float32,
                                ridge=1e-6, h=0.3)
  allok = torch.ones(2, 700, dtype=torch.bool, device=DEVICE)
  live40 = torch.full((2,), 40, device=DEVICE)
  for live in (None, live40):
    ig_check(f"edge dpp live={live is not None}", sel, linv, cand, allok,
             "rbf", "f32", ridge=1e-6, h=0.3, live=live)
  # nothing feasible -> (0.0, 0)
  none = torch.zeros(2, 700, dtype=torch.bool, device=DEVICE)
  for live in (None, live40):
    best, idx = ops.info_select(sel, linv, cand, none, h=0.3, ridge=1e-6,
                                live=live)
    sync()
    check(bool((best == 0.0).all()) and bool((idx == 0).all()),
          f"info_select nothing feasible: {best.tolist()} {idx.tolist()}")
  # exact ties: with nothing selected every rbf cond is 1 + ridge, so the
  # lowest feasible index wins; identical rows tie exactly in the kernel
  for kernel in ("linear", "rbf"):
    sel, linv, cand = ig_operands(g, 2, 128, 0, 3000, 6, kernel,
                                  torch.float32)
    cand *= torch.rand(2, 3000, 1, generator=g, device=DEVICE) + 0.5
    ok = torch.ones(2, 3000, dtype=torch.bool, device=DEVICE)
    ok[:, :3] = False
    top = (cand * cand).sum(-1).argmax(dim=1)
    for p in range(2):  # the longest row again at a lower and higher index
      j = int(top[p])
      cand[p, (j + 1711) % 3000] = cand[p, j]
      cand[p, (j + 977) % 3000] = cand[p, j]
    for live in (None, torch.zeros((2,), dtype=torch.int64, device=DEVICE)):
      best, idx = ops.info_select(sel, linv, cand, ok, kernel=kernel,
                                  live=live)
      sync()
      for p in range(2):
        j = int(top[p])
        want = (3 if kernel == "rbf" else
                min({j, (j + 1711) % 3000, (j + 977) % 3000} - {0, 1, 2}))
        check(int(idx[p]) == want, f"ties {kernel}: index {int(idx[p])}, "
              f"want {want}")
  # a stride-0 shared candidate block equals per-partition calls
  sel, linv, cand = ig_operands(g, 4, 128, 64, 2000, 6, "rbf", torch.float32,
                                shared=True)
  ok = torch.rand(4, 2000, generator=g, device=DEVICE) > 0.1
  live64 = torch.full((4,), 64, device=DEVICE)
  for live in (None, live64):
    cond = ops.info_gain_cond(sel, linv, cand, live=live)
    best, idx = ops.info_select(sel, linv, cand, ok, live=live)
    for p in range(4):
      one = None if live is None else live[p]
      c1 = ops.info_gain_cond(sel[p], linv[p], cand, live=one)
      b1, i1 = ops.info_select(sel[p], linv[p], cand, ok[p], live=one)
      check(torch.equal(cond[p], c1) and int(idx[p]) == int(i1) and
            float(best[p]) == float(b1), f"shared block, partition {p}, "
            f"live={live is not None}")
  # with the counts, the masked factor gives the dense answer
  _, er = errors(ops.info_gain_cond(sel, linv, cand, live=live64),
                 ref.info_gain_cond_ref(sel, linv, cand))
  check(er <= TOL["f32"], f"live vs dense on a masked factor: {er:.3e}")
  sync()
  emit("kernel info edges", cases=n_cases, k_max=[1, 7, 80, 128, 400],
       past_smem=[[512, 64], [64, 768], [2100, 6], [5000, 6]],
       max_abs_err=worst, dpp_ridge=1e-6, nothing_feasible="(0.0, 0)",
       ties="lowest index", shared_block="equal to per-partition calls",
       mixed_counts=[[0, 37, 128], [5, 200, 400]],
       junk_past_live="masked as the plain version masks", result="pass")


def ig_bound(P, nc, k, d, kernel, esz, shared, select, count=None):
  """The least time of one info-gain call: every input read once, the
  output written once; the dense work the TPU kernel does per candidate
  (the (k x d) cross column, the (k x k) product with linv, the sum of
  squares; for rbf the norms and the exp epilogue).  With ``count`` the
  work an exact kernel needs that skips the dead selection rows and the
  zeros of linv: ``count`` live rows and the count (count + 1) / 2 entries
  of linv's live lower triangle.  P = None: unbatched operands."""
  n_p = 1 if P is None else P
  c = k if count is None else count
  lin = k * k if count is None else c * (c + 1) // 2
  moved = (n_p * c * d * esz + n_p * lin * 4
           + (1 if shared else n_p) * nc * d * esz)
  moved += n_p * nc + n_p * 8 if select else n_p * nc * 4
  per = 2.0 * c * d + 2.0 * lin + 2.0 * c + 3.0
  if kernel == "rbf":
    per += 6.0 * c + 2.0 * d
  return bound_ms(moved, n_p * nc * per, "f32")


# the info-gain kernel phase's cases: label, batched over the partitions,
# candidates (as a function of the sizes), shared candidate block, and the
# GP paths that launch each kernel at that shape
IG_CASES = (
    ("round1", True, lambda sz: -(-sz.gp_n // sz.gp_m), False,
     {"info_gain_cond": [], "info_select": ["reference", "generic"]}),
    ("round2 generic", True, lambda sz: sz.gp_m * sz.gp_k, True,
     {"info_gain_cond": ["generic"], "info_select": []}),
    ("round2 reference", False, lambda sz: sz.gp_m * sz.gp_k, False,
     {"info_gain_cond": [], "info_select": ["reference"]}),
    ("centralized", False, lambda sz: sz.gp_n, False,
     {"info_gain_cond": [], "info_select": ["centralized"]}),
)


IG_COUNTS = (1, 32, 64, 96, 128)  # round-1 selection counts timed


def ig_kernel_phase(sz: Sizes, path_counts: dict):
  """Both info-gain kernels against their plain versions at each shape the
  GP path gives them (``IG_CASES``): round 1 (P = 32 partitions of
  1,431,622 candidates, k_max = 128, d = 6), the generic engine's round 2
  (P = 32 states over one shared block of 32 x 128 merged candidates), the
  reference's round 2 (one state over those 4096 candidates) and the
  centralized greedy (one state over all 45,811,883 rows), with a real
  selection of ``gp_count`` rows, each timed with the selection counts
  (``live``, as the objectives call them; ``bound_ms`` is that count-aware
  work) and dense (``dense_ms`` against ``bound_dense_ms``).  Then the
  round-1 select at the counts ``IG_COUNTS`` of one incremental Cholesky.
  The plain version runs a few partitions, or one partition's worth of
  candidates, at a time: one unchunked round-1 temporary is (32, 128,
  1.43 M) floats, 23 GiB.  Each row carries the launches of every path
  that gives the kernel that shape (``path_counts``: the e2e phase's counts
  by path)."""
  import torch

  from repro_torch.core import objectives as O
  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(5)
  P, k, d = sz.gp_m, sz.gp_k, sz.gp_d
  nl = -(-sz.gp_n // P)
  obj = O.InformationGain(k_max=k, kernel="rbf",
                          kernel_kwargs=(("h", sz.gp_h),), sigma=sz.gp_sigma)
  st = obj.init_d(d, device=DEVICE, batch=(P,))
  states = {}
  for step in range(1, max(IG_COUNTS) + 1):  # a real incremental Cholesky
    st = obj.update(st, unit_rows(g, P, d))
    if step in IG_COUNTS or step == sz.gp_count:
      states[step] = (st.sel_feats, O._masked_linv(st.chol, st.count),
                      st.count)
  sel_b, linv_b, live_b = states[sz.gp_count]
  ridge = sz.gp_sigma ** 2
  rows = {}
  for label, batched, nc_of, shared, on_paths in IG_CASES:
    nc = nc_of(sz)
    sel, linv, live = ((sel_b, linv_b, live_b) if batched else
                       (sel_b[0], linv_b[0], live_b[0]))
    lead = (P,) if batched else ()
    cand = unit_rows(g, *(() if shared else lead), nc, d)
    ok = torch.rand(*lead, nc, generator=g, device=DEVICE) > 0.01

    def plain():
      if batched:
        return torch.cat([
            ref.info_gain_cond_ref(sel[c0:c0 + sz.plain_chunk],
                                   linv[c0:c0 + sz.plain_chunk],
                                   cand if shared else
                                   cand[c0:c0 + sz.plain_chunk], ridge=ridge)
            for c0 in range(0, P, sz.plain_chunk)])
      return torch.cat([ref.info_gain_cond_ref(sel, linv, cand[c0:c0 + nl],
                                               ridge=ridge)
                        for c0 in range(0, nc, nl)])

    want = plain()
    res = {}
    for mode, lv in (("live", live), ("dense", None)):
      cond = ops.info_gain_cond(sel, linv, cand, ridge=ridge, live=lv)
      best, idx = ops.info_select(sel, linv, cand, ok, ridge=ridge, live=lv)
      sync()
      res[mode] = ig_compare(f"info kernels {label} {mode}", cond, best, idx,
                             want, ok, "f32")
      del cond
    del want
    ms = {(mode, sel_): time_ms(
        (lambda lv=lv: ops.info_select(sel, linv, cand, ok, ridge=ridge,
                                       live=lv)) if sel_ else
        (lambda lv=lv: ops.info_gain_cond(sel, linv, cand, ridge=ridge,
                                          live=lv)))
          for mode, lv in (("live", live), ("dense", None))
          for sel_ in (False, True)}
    pc_ms = time_ms(plain, reps=1)
    ps_ms = time_ms(lambda: ref.masked_top1(plain(), ok, floor=0.0), reps=1)
    n_p = P if batched else None
    common = dict(shape=[n_p, k, nc, d], kernel="rbf", dtype="f32",
                  count=sz.gp_count, shared_candidates=shared,
                  tol=TOL["f32"], library_ms=None)
    for name, select, p_ms in (("info_gain_cond", False, pc_ms),
                               ("info_select", True, ps_ms)):
      c_abs, c_rel, b_abs, near = res["live"]
      err = (dict(max_abs_err=b_abs, near_ties=near) if select else
             dict(max_abs_err=c_abs, max_rel_err=c_rel))
      dense = ig_bound(n_p, nc, k, d, "rbf", 4, shared, select)
      lbound = ig_bound(n_p, nc, k, d, "rbf", 4, shared, select,
                        count=sz.gp_count)
      rows[(name, label)] = dict(
          common, **err, kernel_ms=ms[("live", select)], plain_ms=p_ms,
          bound_ms=lbound[0], bound_by=lbound[1],
          dense_ms=ms[("dense", select)],
          dense_max_abs_err=res["dense"][2 if select else 0],
          bound_dense_ms=dense[0], on_paths=on_paths[name],
          launches={p: path_counts[p][name] for p in on_paths[name]})
      emit(f"kernel {name} {label}", **rows[(name, label)])
    del cand, ok
    torch.cuda.empty_cache()
  # the round-1 select at the counts of a run
  cand = unit_rows(g, P, nl, d)
  ok = torch.rand(P, nl, generator=g, device=DEVICE) > 0.01
  for count in IG_COUNTS:
    sel, linv, live = states[count]
    want = torch.cat([
        ref.info_gain_cond_ref(sel[c0:c0 + sz.plain_chunk],
                               linv[c0:c0 + sz.plain_chunk],
                               cand[c0:c0 + sz.plain_chunk], ridge=ridge)
        for c0 in range(0, P, sz.plain_chunk)])
    best, idx = ops.info_select(sel, linv, cand, ok, ridge=ridge, live=live)
    cond = ops.info_gain_cond(sel, linv, cand, ridge=ridge, live=live)
    sync()
    c_abs, _, b_abs, near = ig_compare(f"info round1 count {count}", cond,
                                       best, idx, want, ok, "f32")
    del want, cond
    k_ms = time_ms(lambda: ops.info_select(sel, linv, cand, ok, ridge=ridge,
                                           live=live))
    lb = ig_bound(P, nl, k, d, "rbf", 4, False, True, count=count)
    row = dict(shape=[P, k, nl, d], count=count, kernel_ms=k_ms,
               bound_live_ms=lb[0], bound_live_by=lb[1],
               share_of_bound=lb[0] / k_ms, max_abs_err=b_abs,
               cond_max_abs_err=c_abs, near_ties=near)
    rows[("info_select", f"round1 count {count}")] = row
    emit(f"kernel info_select round1 count {count}", **row)
  del cand, ok, states
  torch.cuda.empty_cache()
  return rows


def replay_value(obj, feats, ids, st0=None):
  """f(S) of the rows ``ids``, replayed from ``st0`` (by default the
  information gain's empty selection)."""
  import torch

  from repro_torch.core import greedi as GD
  if st0 is None:
    st0 = obj.init_d(feats.shape[1], device=DEVICE)
  sf = feats[torch.as_tensor(ids, device=feats.device)]
  st = GD.set_value_feats(obj, st0, sf, torch.ones(
      sf.shape[:1], dtype=torch.bool, device=DEVICE))
  return float(obj.value(st))


def replay_agree(obj, feats, a, b, what, st0=None):
  """Equal selections, or the near-tie rule: where the greedy orders first
  differ both picks' gains after the common prefix agree within TOL_GAP,
  and the two f(S) agree within 1e-5 relative (replayed from ``st0`` as in
  ``replay_value``)."""
  import numpy as np
  import torch

  from repro_torch.core import greedi as GD
  if np.array_equal(a, b):
    return "equal"
  if st0 is None:
    st0 = obj.init_d(feats.shape[1], device=DEVICE)
  n = min(len(a), len(b))
  t = int(np.flatnonzero(a[:n] != b[:n])[0]) if (a[:n] != b[:n]).any() else n
  va = replay_value(obj, feats, a, st0)
  vb = replay_value(obj, feats, b, st0)
  rel = abs(va - vb) / max(abs(va), 1e-30)
  gap = 0.0
  if t < n:
    prefix = feats[torch.as_tensor(a[:t], device=DEVICE)]
    st = GD.set_value_feats(obj, st0, prefix, torch.ones(
        (t,), dtype=torch.bool, device=DEVICE))
    pair = feats[torch.as_tensor([a[t], b[t]], device=DEVICE)]
    gg = obj.gains(st, pair)
    gap = float((gg[0] - gg[1]).abs() / gg.abs().max())
  check(gap <= TOL_GAP and rel <= 1e-5, f"{what}: selections differ at "
        f"step {t} (gain gap {gap:.3e}, f(S) {va!r} vs {vb!r})")
  return f"near-tie at step {t} (gain gap {gap:.2e}, f rel {rel:.2e})"


def e2e_gp_full(sz: Sizes):
  """The GP active-set path at the Yahoo! Webscope data size: the
  reference protocol with the fused step, the generic sharded engine on
  the same partition, and the centralized greedy, each with the launch
  counts set to 0 before it and read after it.  Every path's f(S) is
  replayed from its ids.  Returns the counts by path."""
  import numpy as np
  import torch

  from repro_torch.core import bounds
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.core.partition import partition_gids, random_partition
  from repro_torch.kernels import ops
  t0 = time.perf_counter()
  feats = parkinsons_like(sz.gp_n, sz.gp_d, seed=0)
  sync()
  t_data = time.perf_counter() - t0
  m, k, d = sz.gp_m, sz.gp_k, sz.gp_d
  obj = O.InformationGain(k_max=k, kernel="rbf",
                          kernel_kwargs=(("h", sz.gp_h),), sigma=sz.gp_sigma)

  def init(ef, em):
    return obj.init_d(d, device=ef.device)

  def gen():  # the partition of 45.8 M rows is drawn on the card
    return torch.Generator(device=DEVICE).manual_seed(0)

  def reference():
    return GD.greedi_reference(gen(), feats, m=m, kappa=k, k_final=k,
                               objective=obj, init_for=init)

  def generic():
    parts, _, perm = random_partition(GD.greedi_keys(gen())[0], feats, m)
    npp = parts.shape[1]
    return GD.greedi_sharded(parts.reshape(m * npp, d), m=m, kappa=k,
                             k_final=k, objective=obj,
                             gids=partition_gids(perm))

  def central():
    return GD.centralized_greedy(feats, k, objective=obj, init_for=init)

  out, counts = {}, {}
  for name, run in (("reference", reference), ("generic", generic),
                    ("centralized", central)):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    wall = time.perf_counter() - t0
    counts[name] = ops.launch_counts()
    if name == "centralized":
      r, v = res
      ids = r.idx.cpu().numpy()
      value = float(v)
    else:
      ids = res.sel_gids.cpu().numpy()
      value = float(res.value)
    out[name] = dict(ids=ids, value=value, wall_s=wall,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  for name, r in out.items():
    ids = r["ids"]
    check(len(ids) == k and len(set(ids.tolist())) == k and ids.min() >= 0
          and ids.max() < sz.gp_n, f"gp {name}: not k unique in-range ids")
    check(np.isfinite(r["value"]) and r["value"] > 0.0,
          f"gp {name}: f(S) = {r['value']!r}")
  for kname in ("info_select", "info_gain_cond"):
    check(counts[MAIN_PATH[kname]][kname] > 0, f"kernel {kname} was not "
          f"launched on the GP {MAIN_PATH[kname]} path")
  check(counts["reference"]["info_select"] > 0 and
        counts["centralized"]["info_select"] > 0,
        "the reference or centralized greedy did not launch info_select")
  # each path's f(S) agrees with a replay of its ids; the centralized value
  # is the ratio's denominator
  for name in ("reference", "generic", "centralized"):
    rv = replay_value(obj, feats, out[name]["ids"])
    check(abs(rv - out[name]["value"]) <= 1e-5 * out[name]["value"],
          f"gp {name}: reported f(S) {out[name]['value']!r}, replay {rv!r}")
  verdict = replay_agree(obj, feats, out["reference"]["ids"],
                         out["generic"]["ids"], "gp reference/generic")
  v_c = out["centralized"]["value"]
  floor = bounds.thm4_bound(m, k, k)
  ratios = {name: out[name]["value"] / v_c
            for name in ("reference", "generic")}
  for name, ratio in ratios.items():
    check(ratio >= floor, f"gp {name}: ratio {ratio} below the Thm-4 "
          f"floor {floor}")
  emit("e2e gp full-size", n=sz.gp_n, d=d, m=m, k=k, kappa=k, k_max=k,
       h=sz.gp_h, sigma=sz.gp_sigma, rows_per_partition=-(-sz.gp_n // m),
       holes=m * -(-sz.gp_n // m) - sz.gp_n, data_s=t_data,
       wall_s={n_: r["wall_s"] for n_, r in out.items()},
       peak_gib={n_: r["peak_gib"] for n_, r in out.items()},
       launches=counts, value={n_: r["value"] for n_, r in out.items()},
       ratio_to_centralized=ratios, thm4_floor=floor,
       agreement={"reference vs generic": verdict})
  return counts


def e2e_gp_fig6(sz: Sizes):
  """The Fig. 6 settings at n = 65536: greedi_reference with the kernels
  (backend "auto") and with the plain versions on the card ("ref"), equal
  selections or a near-tie; the ratio to the centralized greedy."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  feats = parkinsons_like(sz.f6_n, sz.f6_d, seed=1)
  obj = O.InformationGain(k_max=sz.f6_k_max, kernel="rbf",
                          kernel_kwargs=(("h", 0.75),), sigma=1.0)

  def init(ef, em):
    return obj.init_d(sz.f6_d, device=ef.device)

  sels, walls, values = {}, {}, {}
  for backend in ("auto", "ref"):
    sync()
    t0 = time.perf_counter()
    rng = torch.Generator(device=DEVICE).manual_seed(3)
    r = GD.greedi_reference(rng, feats, m=sz.f6_m, kappa=sz.f6_k,
                            k_final=sz.f6_k, objective=obj, init_for=init,
                            backend=backend)
    sync()
    walls[backend] = time.perf_counter() - t0
    sels[backend] = r.sel_gids[r.sel_valid].cpu().numpy()
    values[backend] = float(r.value)
    check(len(set(sels[backend].tolist())) == sz.f6_k,
          f"fig6 {backend}: not k unique ids")
  verdict = replay_agree(obj, feats, sels["auto"], sels["ref"],
                         "fig6 auto/ref")
  _, v_c = GD.centralized_greedy(feats, sz.f6_k, objective=obj,
                                 init_for=init)
  ratio = values["auto"] / float(v_c)
  check(0.5 < ratio <= 1.0 + 1e-5, f"fig6 ratio {ratio}")
  emit("e2e gp fig6", n=sz.f6_n, d=sz.f6_d, m=sz.f6_m, k=sz.f6_k,
       k_max=sz.f6_k_max, holes=sz.f6_m * -(-sz.f6_n // sz.f6_m) - sz.f6_n,
       wall_s=walls, value=values, ratio_to_centralized=ratio,
       agreement={"auto vs ref": verdict})


def profile_gp(sz: Sizes):
  """Where the GP reference path's time goes at full size: device time by
  kernel name and the busy share, as ``profile_phase`` reports them."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  feats = parkinsons_like(sz.gp_n, sz.gp_d, seed=0)
  obj = O.InformationGain(k_max=sz.gp_k, kernel="rbf",
                          kernel_kwargs=(("h", sz.gp_h),), sigma=sz.gp_sigma)
  profiled("profile gp reference", lambda: GD.greedi_reference(
      torch.Generator(device=DEVICE).manual_seed(0), feats, m=sz.gp_m,
      kappa=sz.gp_k, k_final=sz.gp_k, objective=obj,
      init_for=lambda ef, em: obj.init_d(sz.gp_d, device=ef.device)))


# ---------------------------------------------------------------------------
# saturated coverage: kernels 4-5, the reference protocol and the service
# ---------------------------------------------------------------------------


def abs_rows(g, *shape, dtype=None):
  """Nonnegative unit rows (coverage mass): ``unit_rows`` folded into the
  positive orthant, as the CLI's saturated-coverage mode does."""
  x = unit_rows(g, *shape).abs()
  return x if dtype is None else x.to(dtype)


def cov_state(g, lead, ne, nc, d, dtype, shared_ev=False,
              shared_cands=False, shared_cap=False, alpha=0.25):
  """A greedy-like saturated-coverage state: eval rows, candidates, caps
  at alpha times a total of the scale abs unit rows give (mean relu
  similarity near 2/pi), a cover from 0 to past the cap (some rows
  saturated), a mask with a few dead rows, ok with a few selected
  candidates.  ``lead`` is () or (P,); a shared operand has no P axis."""
  import torch
  ev = abs_rows(g, *(() if shared_ev else lead), ne, d, dtype=dtype)
  cd = abs_rows(g, *(() if shared_cands else lead), nc, d, dtype=dtype)
  cap = alpha * 0.64 * ne * (0.8 + 0.4 * torch.rand(
      *(() if shared_cap else lead), ne, generator=g, device=DEVICE))
  cover = cap * 1.2 * torch.rand(*lead, ne, generator=g, device=DEVICE)
  mask = (torch.rand(*lead, ne, generator=g, device=DEVICE) > 0.05).float()
  ok = torch.rand(*lead, nc, generator=g, device=DEVICE) > 0.02
  return ev, cd, cover, cap, mask, ok


def cov_plain(ev, cd, cover, cap, mask, kernel, chunk):
  """The plain coverage gains of the kernel's output shape, a few
  partitions (batched operands) or candidates (unbatched) at a time."""
  import torch

  from repro_torch.kernels import ref
  batched = any(t.dim() == r + 1 for t, r in ((ev, 2), (cd, 2), (cover, 1),
                                               (cap, 1), (mask, 1)))
  if not batched:
    step = max(1, (1 << 29) // ev.shape[0])   # 2 GiB of (ne, step) floats
    return torch.cat([ref.coverage_gain_ref(ev, cd[c0:c0 + step], cover,
                                            cap, mask, kernel=kernel)
                      for c0 in range(0, cd.shape[0], step)])
  P = max(t.shape[0] for t, r in ((ev, 2), (cd, 2), (cover, 1), (cap, 1),
                                  (mask, 1)) if t.dim() == r + 1)

  def take(t, rank, s):
    return t[s] if t.dim() == rank + 1 else t

  out = []
  for p0 in range(0, P, chunk):
    s = slice(p0, p0 + chunk)
    out.append(ref.coverage_gain_ref(take(ev, 2, s), take(cd, 2, s),
                                     take(cover, 1, s), take(cap, 1, s),
                                     take(mask, 1, s), kernel=kernel))
  return torch.cat(out)


def cov_bound(P, ne, nc, d, esz, shared_ev, shared_cd, shared_cap, kernel,
              select):
  """The least time of one coverage call: every input read once, the
  output written once, 2 d + 5 operations per (eval, candidate) pair (the
  product, then relu, add, min, subtract, masked accumulate); rbf adds the
  norms and its 6-operation epilogue.  P = None: unbatched."""
  n_p = 1 if P is None else P
  moved = ((1 if shared_ev else n_p) * ne * d * esz
           + (1 if shared_cd else n_p) * nc * d * esz
           + (2 * n_p + (1 if shared_cap else n_p)) * ne * 4)
  moved += n_p * nc + n_p * 8 if select else n_p * nc * 4
  flops = (2.0 * d + 5.0) * n_p * ne * nc
  if kernel == "rbf":
    flops += 6.0 * n_p * ne * nc + 2.0 * n_p * (ne + nc) * d
  return bound_ms(moved, flops, "f32" if esz == 4 else "bf16")


# the coverage kernel phase's cases: label, partitions (None = unbatched),
# eval rows, candidates, shared eval block / candidates / cap, the
# variants run, and the paths that launch each kernel at that shape
COV_CASES = (
    ("round1", 16, 16384, 16384, False, False, False,
     (("linear", "f32"), ("linear", "bf16"), ("rbf", "f32")),
     {"coverage_gain": ["service_satcov_warm", "service_satcov_cold",
                        "service_satcov_standard"],
      "coverage_select": ["satcov_reference", "service_satcov_standard"]}),
    ("round2 service", 16, 16384, 1024, False, True, False,
     (("linear", "f32"),),
     {"coverage_gain": ["service_satcov_warm", "service_satcov_cold",
                        "service_satcov_standard"],
      "coverage_select": []}),
    ("lazy rescan", 16, 16384, 256, False, False, False,
     (("linear", "f32"),),
     {"coverage_gain": ["service_satcov_warm", "service_satcov_cold"],
      "coverage_select": []}),
    ("total pass", None, 262144, 16384, False, False, False,
     (("linear", "f32"),),
     {"coverage_gain": ["satcov_reference"], "coverage_select": []}),
    ("round2 reference", None, 262144, 1024, False, False, False,
     (("linear", "f32"),),
     {"coverage_gain": [], "coverage_select": ["satcov_reference"]}),
    ("centralized cli", None, 65536, 65536, False, False, False,
     (("linear", "f32"),),
     {"coverage_gain": [], "coverage_select": ["satcov_centralized"]}),
    ("batched queries", 64, 8192, 8192, True, True, True,
     (("linear", "f32"),),
     {"coverage_gain": [], "coverage_select": []}),
)


def cov_kernel_phase(sz, path_counts: dict):
  """coverage_gain and coverage_select against their plain versions at
  every shape the satcov paths launch (``COV_CASES``): round 1 at full size
  (P = 16 partitions of 16384 rows, also bf16 and rbf), the service's
  round 2 (16 eval partitions over one shared block of m kappa = 1024
  candidates), a lazy rescan (16 gathered tiles of ``lazy_tile``), one
  chunk of the ``total`` pass over all 262144 rows (``SaturatedCoverage``
  at init, the reference's final evaluation), the reference's round 2
  (all 262144 rows over the 1024), the centralized
  greedy at the CLI size (65536 x 65536, the plain side in candidate
  chunks), and the batched query form (64 per-query covers, masks and oks
  over one shared block and cap).  Each row carries the launches of the
  paths that give the kernel that shape (``path_counts``)."""
  import torch

  from repro_torch.kernels import autotune, ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(21)
  check(autotune.lazy_tile(sz.n // sz.m, sz.d) == 256,
        "the lazy rescan case assumes a 256-row rescore tile")
  rows = {}
  for (label, P, ne, nc, sh_ev, sh_cd, sh_cap, variants,
       on_paths) in COV_CASES:
    lead = () if P is None else (P,)
    for kernel, dtype in variants:
      td = torch.float32 if dtype == "f32" else torch.bfloat16
      ev, cd, cover, cap, mask, ok = cov_state(
          g, lead, ne, nc, sz.d, td, shared_ev=sh_ev, shared_cands=sh_cd,
          shared_cap=sh_cap)
      kw = dict(kernel=kernel)
      plan = fl_path(f"coverage {label} {kernel} {dtype}", ev, cd, cover,
                     mask, ok, cap=cap)
      gains = ops.coverage_gain(ev, cd, cover, cap, mask, **kw)
      best, idx = ops.coverage_select(ev, cd, cover, cap, mask, ok, **kw)
      sync()
      want = cov_plain(ev, cd, cover, cap, mask, kernel, sz.plain_chunk)
      tol = (TOL[dtype] if ne <= 16384 or dtype != "f32" else TOL_LONG_SUM)
      g_abs, g_rel = errors(gains, want)
      check(g_rel <= tol, f"coverage_gain {label} {kernel} {dtype}: "
            f"relative error {g_rel:.3e} > {tol:.0e}")
      wb, wi = ref.masked_top1(want, ok)
      same = idx == wi
      picked = want.gather(-1, idx.unsqueeze(-1))[..., 0]
      gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
      okp = ok.gather(-1, idx.unsqueeze(-1))[..., 0]
      tie = (~same) & (gap <= tol) & okp
      check(bool((same | tie).all()), f"coverage_select {label} {kernel} "
            f"{dtype}: index differs beyond a near-tie")
      b_abs, b_rel = errors(best, wb)
      check(b_rel <= tol, f"coverage_select {label}: best error "
            f"{b_rel:.3e}")
      gain_ms = time_ms(lambda: ops.coverage_gain(ev, cd, cover, cap, mask,
                                                  **kw))
      sel_ms = time_ms(lambda: ops.coverage_select(ev, cd, cover, cap, mask,
                                                   ok, **kw))
      pg_ms = time_ms(lambda: cov_plain(ev, cd, cover, cap, mask, kernel,
                                        sz.plain_chunk), reps=1)
      ps_ms = time_ms(lambda: ref.masked_top1(cov_plain(
          ev, cd, cover, cap, mask, kernel, sz.plain_chunk), ok), reps=1)
      esz = cd.element_size()
      common = dict(shape=[P, ne, nc, sz.d], kernel=kernel, dtype=dtype,
                    shared=dict(eval=sh_ev, candidates=sh_cd, cap=sh_cap),
                    tol=tol, **plan, library_ms=None)
      for name, err, ms, p_ms, select in (
          ("coverage_gain", dict(max_abs_err=g_abs, max_rel_err=g_rel),
           gain_ms, pg_ms, False),
          ("coverage_select", dict(max_abs_err=b_abs, max_rel_err=b_rel,
                                   idx_equal=int(same.sum()),
                                   near_ties=int(tie.sum())),
           sel_ms, ps_ms, True)):
        bms, by = cov_bound(P, ne, nc, sz.d, esz, sh_ev, sh_cd, sh_cap,
                            kernel, select)
        rows[(name, label, kernel, dtype)] = dict(
            common, **err, kernel_ms=ms, plain_ms=p_ms, bound_ms=bms,
            bound_by=by, on_paths=on_paths[name],
            launches={p: path_counts[p][name] for p in on_paths[name]})
        emit(f"kernel {name} {label}", **rows[(name, label, kernel, dtype)])
      del ev, cd, cover, cap, mask, ok, want, gains
      torch.cuda.empty_cache()
  # facility location at the service's lazy-rescan shape as well
  st = fl_state(g, sz.m, sz.n // sz.m, 256, sz.d, torch.float32)
  fl_counts = {"facility_gain": path_counts["service_facility_warm"][
      "facility_gain"], "facility_select": 0}
  facility_phase("lazy rescan", *st, "linear", "f32", sz.plain_chunk,
                 fl_counts)
  return rows


def cov_edge_phase():
  """The coverage kernels at the edges, against the plain versions: ragged
  ne and nc at d of 22, 40 and 130 (both ring modes, padded copies),
  linear and rbf, f32 and bf16, rows with cover >= cap (which add 0),
  nothing feasible, exact ties, and cap = +inf with cover = 0, which is
  the facility gain at cov = 0."""
  import torch

  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(13)
  worst = 0.0
  for kernel, d in ((k, d) for k in ("linear", "rbf") for d in EDGE_WIDTHS):
    for dtype, td in (("f32", torch.float32), ("bf16", torch.bfloat16)):
      ev, cd, cover, cap, mask, ok = cov_state(g, (3,), 1000, 1037, d, td)
      sat = torch.rand(3, 1000, generator=g, device=DEVICE) > 0.7
      cover = torch.where(sat, cap * 1.5, cover)
      gains = ops.coverage_gain(ev, cd, cover, cap, mask, kernel=kernel)
      best, idx = ops.coverage_select(ev, cd, cover, cap, mask, ok,
                                      kernel=kernel)
      want = ref.coverage_gain_ref(ev, cd, cover, cap, mask, kernel=kernel)
      wb, wi = ref.masked_top1(want, ok)
      # saturated rows add nothing: the same gains with them masked out
      unsat = ops.coverage_gain(ev, cd, cover, cap,
                                torch.where(sat, 0.0, mask), kernel=kernel)
      sync()
      ea, er = errors(gains, want)
      _, eu = errors(gains, unsat)
      worst = max(worst, ea)
      check(er <= TOL[dtype] and eu <= TOL[dtype] and torch.equal(idx, wi),
            f"coverage ragged d{d} {kernel} {dtype}: err {er:.3e}, saturated "
            f"{eu:.3e}, idx {idx.tolist()} vs {wi.tolist()}")
      none = torch.zeros_like(ok)
      best, idx = ops.coverage_select(ev, cd, cover, cap, mask, none,
                                      kernel=kernel)
      sync()
      check(bool((best == ref.NEG).all()) and bool((idx == 0).all()),
            f"coverage all-infeasible {kernel}: {best.tolist()}")
      # cap = +inf, cover = 0: relu(sim) summed, the facility gain at 0
      zero = torch.zeros_like(cover)
      inf = torch.full_like(cap, float("inf"))
      a = ops.coverage_gain(ev, cd, zero, inf, mask, kernel=kernel)
      b = ops.facility_gain(ev, cd, zero, mask, kernel=kernel)
      sync()
      check(torch.equal(a, b), f"coverage cap=inf vs facility {kernel} "
            f"{dtype}: {errors(a, b)}")
    # exact ties: +-10 sign rows, the best candidate again twice
    signs = torch.where(torch.rand(2, 300, 8, generator=g, device=DEVICE)
                        > 0.5, 10.0, -10.0)
    e_t = signs[:, torch.randint(0, 300, (700,), generator=g,
                                 device=DEVICE)]
    cand = signs.clone()
    zero = torch.zeros(2, 700, device=DEVICE)
    big = torch.full((2, 700), 1e4, device=DEVICE)
    ones = torch.ones(2, 700, device=DEVICE)
    top = ref.coverage_gain_ref(e_t, cand, zero, big, ones,
                                kernel=kernel).argmax(dim=1)
    for p in range(2):
      j = int(top[p])
      cand[p, (j + 211) % 300] = cand[p, j]
      cand[p, (j + 97) % 300] = cand[p, j]
    allok = torch.ones(2, 300, dtype=torch.bool, device=DEVICE)
    best, idx = ops.coverage_select(e_t, cand, zero, big, ones, allok,
                                    kernel=kernel)
    wb, wi = ref.coverage_select_ref(e_t, cand, zero, big, ones, allok,
                                     kernel=kernel)
    sync()
    check(torch.equal(idx, wi) and torch.equal(best, wb),
          f"coverage ties {kernel}: {idx.tolist()} vs {wi.tolist()}")
  emit("kernel coverage edges", ragged=[[3, 1000, 1037, d]
                                       for d in EDGE_WIDTHS],
       max_abs_err=worst, saturated_rows="add 0",
       all_infeasible="(NEG, 0)", ties="lowest index",
       cap_inf_cover_0="equals facility_gain at cov 0", result="pass")


def e2e_satcov(sz):
  """Saturated coverage through the reference protocol (the fused
  ``coverage_select`` steps): at full size (the kernels line's main path),
  and at the CLI size with the centralized greedy (the ratio against the
  Thm-4 floor) and with backend "ref" (the plain versions on the card, the
  same ids or a near-tie).  Local evaluation in round 1, as the CLI's
  reference path; each path's f(S) is replayed from its ids.  Returns the
  launch counts by path."""
  import dataclasses

  import numpy as np
  import torch

  from repro_torch.core import bounds
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops
  obj = O.SaturatedCoverage(alpha=sz.cov_alpha)
  counts, out = {}, {}

  def run(name, fn, feats):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    wall = time.perf_counter() - t0
    counts[name] = ops.launch_counts()
    if isinstance(res, GD.GreediResult):
      ids, value = res.sel_gids.cpu().numpy(), float(res.value)
    else:   # centralized: (GreedyResult, f(S))
      ids, value = res[0].idx.cpu().numpy(), float(res[1])
    check(len(ids) == sz.k and len(set(ids.tolist())) == sz.k and
          ids.min() >= 0 and ids.max() < feats.shape[0],
          f"satcov {name}: not k unique in-range ids")
    replay = replay_value(obj, feats, ids, obj.init(feats))
    check(abs(replay - value) <= 1e-5 * abs(value), f"satcov {name}: "
          f"reported f(S) {value!r}, replay {replay!r}")
    out[name] = dict(ids=ids, value=value, wall_s=wall,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)

  def reference(feats, m, o=obj):
    return lambda: GD.greedi_reference(
        torch.Generator().manual_seed(0), feats, m=m, kappa=sz.k,
        k_final=sz.k, objective=o, init_for=o.init, local_eval=True)

  full = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features().abs()
  run("satcov_reference", reference(full, sz.m), full)
  check(counts["satcov_reference"]["coverage_select"] > 0,
        "coverage_select was not launched on the satcov reference path")
  del full
  cli = EmbeddedCorpus(n_docs=sz.n_cli, feat_dim=sz.d,
                       seed=0).features().abs()
  run("satcov_reference_cli", reference(cli, sz.m_cli), cli)
  plain = dataclasses.replace(obj, backend="ref")
  run("satcov_reference_cli_ref", reference(cli, sz.m_cli, plain), cli)
  run("satcov_centralized", lambda: GD.centralized_greedy(
      cli, sz.k, objective=obj, init_for=obj.init), cli)
  check(counts["satcov_reference_cli_ref"]["coverage_select"] == 0,
        "the plain backend launched a coverage kernel")
  verdict = replay_agree(obj, cli, out["satcov_reference_cli"]["ids"],
                         out["satcov_reference_cli_ref"]["ids"],
                         "satcov cli auto/ref", obj.init(cli))
  floor = bounds.thm4_bound(sz.m_cli, sz.k, sz.k)
  ratio = out["satcov_reference_cli"]["value"] / out[
      "satcov_centralized"]["value"]
  check(ratio >= floor, f"satcov ratio {ratio} below the Thm-4 floor "
        f"{floor}")
  emit("e2e satcov", n=sz.n, n_cli=sz.n_cli, d=sz.d, k=sz.k, kappa=sz.k,
       m=sz.m, m_cli=sz.m_cli, alpha=sz.cov_alpha,
       wall_s={k: v["wall_s"] for k, v in out.items()},
       peak_gib={k: v["peak_gib"] for k, v in out.items()},
       value={k: v["value"] for k, v in out.items()},
       launches=counts, ratio_to_centralized=ratio, thm4_floor=floor,
       agreement={"cli auto vs ref": verdict})
  return {k: v for k, v in counts.items()
          if k in ("satcov_reference", "satcov_centralized")}


def sharded_value(obj, store, perm, m, ids):
  """f(S) as a service epoch computes it: the block partitioned by the
  epoch's ``perm``, every shard's evaluation (its own saturation levels
  under saturated coverage), the shards' means weighted by their live
  rows."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.core.partition import partition_gids, repartition
  parts, _, p = repartition(None, store.feats, m, perm=perm)
  valid = (partition_gids(p, store.gids) >= 0).reshape(m, -1)
  st = obj.init(parts, valid.float())
  # auto gids are the block rows they were appended to
  sf = store.feats[torch.as_tensor(ids, device=DEVICE)]
  st = GD.set_value_feats(obj, st, sf.expand(m, -1, -1),
                          torch.ones((m, len(ids)), dtype=torch.bool,
                                     device=DEVICE))
  n_live = valid.sum(dim=1).float()
  return float((obj.value(st) * n_live).sum() / n_live.sum())


def e2e_service(sz):
  """The selection service at full size: 262,144 EmbeddedCorpus rows of
  width 64 (abs'd for saturated coverage), m = 16 stacked shards, k = kappa
  = 64, append_block = 1024, the store starting at capacity 65536 (so it
  grows twice during ingest).  Append 75 %, epoch 0, append the rest,
  epochs 1-2; for saturated coverage and facility location, each warm and
  cold on the same partitions (the service's own generator, one seed),
  and saturated coverage once more with a standard round 1 (the fused
  ``coverage_select`` step).  Per epoch: warm == cold == standard ids (or
  f(S) within 1e-5), f(S) replayed from the ids, warm reported only with
  a populated table.  Then the CLI once in service mode.  Returns the
  launch counts by path."""
  import numpy as np
  import torch

  from repro_torch.core import greedy as GR
  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops
  from repro_torch.launch import select as cli
  from repro_torch.service import SelectionService
  base = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  n0 = sz.n - int(sz.n * sz.append_frac)
  counts, report, sels = {}, {}, {}
  runs = (("satcov", True, "lazy"), ("satcov", False, "lazy"),
          ("satcov", False, "standard"), ("facility", True, "lazy"),
          ("facility", False, "lazy"))
  for name, warm, mode in runs:
    feats = base.abs() if name == "satcov" else base
    obj = (O.SaturatedCoverage(alpha=sz.cov_alpha) if name == "satcov"
           else O.FacilityLocation())
    path = f"service_{name}_" + (mode if mode == "standard" else
                                  "warm" if warm else "cold")
    torch.cuda.empty_cache()
    svc = SelectionService(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k,
                           capacity=sz.svc_cap0,
                           append_block=sz.append_block, warm_start=warm,
                           mode=mode, objective=obj, seed=0)
    check(not svc.store.bounds_populated, "a new store reports bounds")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    GR.lazy_syncs = 0
    acc = {}

    def bank():
      # the path's launches so far; the replays between epochs (which
      # launch kernels of their own) are not the path's
      for kname, c in ops.launch_counts().items():
        acc[kname] = acc.get(kname, 0) + c
      ops.reset_launch_counts()

    ingest, epochs = [], []
    for part in (feats[:n0], feats[n0:]):
      sync()
      t0 = time.perf_counter()
      svc.append(part)
      sync()
      ingest.append(part.shape[0] / (time.perf_counter() - t0))
      for _ in range(1 if not epochs else 2):
        e = svc.epoch()
        bank()
        t = e.stats.epoch
        ids = e.sel_gids
        check(len(ids) == sz.k and len(set(ids.tolist())) == sz.k and
              ids.min() >= 0 and ids.max() < svc.n_docs,
              f"{path} epoch {t}: ids")
        check(e.stats.warm == (warm and mode == "lazy"),
              f"{path} epoch {t}: warm reported {e.stats.warm}")
        replay = sharded_value(obj, svc.store, svc.epoch_perm(t), sz.m,
                               ids)
        ops.reset_launch_counts()
        check(abs(replay - e.stats.value) <= 1e-5 * abs(e.stats.value),
              f"{path} epoch {t}: f(S) {e.stats.value!r}, replay "
              f"{replay!r}")
        epochs.append(e)
    counts[path] = acc
    syncs = GR.lazy_syncs
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(svc.growths == 2 and svc.capacity == sz.n,
          f"{path}: growths {svc.growths}, capacity {svc.capacity}")
    sels[path] = [e.sel_gids for e in epochs]
    report[path] = dict(
        ingest_rows_per_s=ingest, epoch_wall_s=[e.stats.wall_s
                                                for e in epochs],
        rescans=[int(e.stats.rescans.sum()) for e in epochs],
        rescan_syncs=syncs, value=[e.stats.value for e in epochs],
        warm=[e.stats.warm for e in epochs], peak_gib=peak,
        growths=svc.growths, launches=counts[path])
    del svc
  agreement = {}
  for p1, p2 in (("satcov_warm", "satcov_cold"),
                 ("satcov_warm", "satcov_standard"),
                 ("facility_warm", "facility_cold")):
    verdicts = []
    for t, (a, b) in enumerate(zip(sels[f"service_{p1}"],
                                   sels[f"service_{p2}"])):
      if np.array_equal(a, b):
        verdicts.append("equal")
      else:
        va = report[f"service_{p1}"]["value"][t]
        vb = report[f"service_{p2}"]["value"][t]
        rel = abs(va - vb) / max(abs(va), 1e-30)
        check(rel <= 1e-5, f"service {p1}/{p2} epoch {t}: selections "
              f"differ, f(S) {va!r} vs {vb!r}")
        verdicts.append(f"near-tie (f rel {rel:.2e})")
    agreement[f"{p1} vs {p2}"] = verdicts
  check(counts["service_satcov_warm"]["coverage_gain"] > 0,
        "coverage_gain was not launched on the service path")
  emit("e2e service", n=sz.n, d=sz.d, m=sz.m, k=sz.k, kappa=sz.k,
       append_block=sz.append_block, capacity0=sz.svc_cap0,
       append_frac=sz.append_frac, paths=report, agreement=agreement)
  # the CLI's service mode once
  ops.reset_launch_counts()
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    out = os.path.join(tmp, "sel.npy")
    sync()
    t0 = time.perf_counter()
    cli.main(["--mesh", str(sz.m), "--n", str(sz.n), "--d", str(sz.d),
              "--k", str(sz.k), "--epochs", "3", "--append-frac",
              str(sz.append_frac), "--objective", "saturated_coverage",
              "--no-coverage", "--out", out])
    sync()
    wall = time.perf_counter() - t0
    sel = np.load(out)
  counts["service_cli"] = ops.launch_counts()
  check(len(sel) == sz.k and len(set(sel.tolist())) == sz.k,
        "service CLI: not k unique ids")
  check(counts["service_cli"]["coverage_gain"] > 0,
        "the service CLI did not launch coverage_gain")
  emit("e2e service cli", wall_s=wall, launches=counts["service_cli"])
  return counts


def profile_service(sz):
  """Where a warm saturated-coverage service epoch's time goes at full
  size: the table built by an ingest of the whole corpus, then one epoch
  under ``profiled``."""
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.service import SelectionService
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features().abs()
  svc = SelectionService(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k,
                         capacity=sz.n, append_block=sz.append_block,
                         objective="saturated_coverage", seed=0)
  svc.append(feats)
  svc.epoch()  # warm-up
  profiled("profile service satcov epoch", svc.epoch)


# ---------------------------------------------------------------------------
# the service's query path: the standing sieves (csrc/sieve.cu), the sieve
# and exact query tiers, query_batch
# ---------------------------------------------------------------------------

# an L2 hit on an H100 (about 260 cycles at the 1.98 GHz boost clock): the
# assumed length of one dependent step of the admission scan, which reads
# the row's similarities from L2 before the warp's max and the compare
L2_HIT_S = 260 / 1.98e9


def count_syncs(fn):
  """(fn's result, the synchronizing CUDA operations it ran: a blocking
  copy either way, a ``.cpu()``, an ``.item()``), counted through
  ``torch.cuda.set_sync_debug_mode("warn")``."""
  import warnings

  import torch
  torch.cuda.set_sync_debug_mode("warn")
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      out = fn()
  finally:
    torch.cuda.set_sync_debug_mode("default")
  return out, sum("synchroniz" in str(w.message) for w in caught)


def query_requests(base_ids, b, k, mc):
  """b heterogeneous tenant requests: k over 1..k, seeds 0..6 (0: none),
  exclusion lists of 0..mc ids of a live answer."""
  from repro_torch.service import QueryRequest
  return [QueryRequest(k=1 + (i * 7) % k, seed=i % 7, exclude_gids=tuple(
      int(g) for g in base_ids[:min(i % (mc + 1), len(base_ids))]))
          for i in range(b)]


def batch_vs_sequential(svc, reqs, what):
  """One ``query_batch`` against every request alone through ``query()``:
  the same source and ids for every lane, values within 1e-6 (and how
  many with the same bits).  Returns the two wall times and the
  sources."""
  import numpy as np
  sync()
  t0 = time.perf_counter()
  batched = svc.query_batch(reqs)
  t_batch = time.perf_counter() - t0
  t0 = time.perf_counter()
  seq = [svc.query(r.k, seed=r.seed, exclude_gids=r.exclude_gids or None)
         for r in reqs]
  t_seq = time.perf_counter() - t0
  same_bits = 0
  for i, (rb, rs) in enumerate(zip(batched, seq)):
    check(rb.source == rs.source and np.array_equal(rb.sel_gids, rs.sel_gids)
          and abs(rb.value_estimate - rs.value_estimate) <= 1e-6 * abs(
              rs.value_estimate), f"{what} request {i}: batched "
          f"{rb.source} {rb.sel_gids} ({rb.value_estimate!r}), alone "
          f"{rs.source} {rs.sel_gids} ({rs.value_estimate!r})")
    same_bits += rb.value_estimate == rs.value_estimate
    check(len(set(rb.sel_gids.tolist())) == len(rb.sel_gids) and not
          set(reqs[i].exclude_gids) & set(rb.sel_gids.tolist()),
          f"{what} request {i}: repeated or excluded ids")
  sources = {}
  for r in batched:
    sources[r.source] = sources.get(r.source, 0) + 1
  return dict(requests=len(reqs), batch_ms=t_batch * 1e3,
              seq_ms=t_seq * 1e3, batch_qps=len(reqs) / t_batch,
              seq_qps=len(reqs) / t_seq, sources=sources,
              values_same_bits=same_bits)


def merge_routes(svc, feats, what):
  """The sieve merge from one state through the kernel route (the
  service's store: the ``pairwise`` kernel) and the plain route (a store
  of backend "ref" holding the same state): equal ids, or a near-tie
  whose f(S) agree within 1e-5; a default merge, then a seeded one that
  excludes the default answer's first four ids."""
  import numpy as np

  from repro_torch.service import CorpusStore
  st = svc.store
  plain = CorpusStore(m=st._m, d=feats.shape[1], capacity=1024,
                      append_block=1024, maintainer=st._maintainer,
                      sieve_k=st.sieve_k, backend="ref")
  plain.set_sieve_state(st.sieve_state)
  excl = np.full((st.query_mask_cap,), -1, np.int64)
  out = []
  for kw in (dict(), dict(seed=5, exclude_gids=excl)):
    a = st.query_sieves(**kw)[0]
    b = plain.query_sieves(**kw)[0]
    excl[:4] = a[:4]
    a, b = a[a >= 0], b[b >= 0]
    if np.array_equal(a, b):
      out.append("equal")
      continue
    va, vb = value_of(feats, a), value_of(feats, b)
    rel = abs(va - vb) / max(abs(va), 1e-30)
    check(rel <= 1e-5, f"{what}: kernel and plain merges differ, f(S) "
          f"{va!r} vs {vb!r}")
    out.append(f"near-tie (f rel {rel:.2e})")
  return out


def e2e_query(sz):
  """The facility service's query path at full size: 262,144 EmbeddedCorpus
  rows of width 64, m = 16, k_final = kappa = sieve_k = 64 (T = 13 buckets
  a shard, 13,312 pooled members), append_block 1024, the store growing
  twice from capacity 65536.  The corpus is ingested in 16 appends of
  16,384 rows by a service with the sieve and by one without (ingest
  rows/s of each, the appends alone), a ``query()`` after each append of
  the first; a 64-request batch against the requests alone before and
  after an epoch; the merge through the kernels against the plain route;
  after the epoch a default query answers from it and a seeded one from
  the reset grid (a subset of its picks); f(sieve answer) / f(epoch
  answer) replayed under the epoch's partition; host syncs per append
  chunk and per query tile.  Returns (launch counts by path, the
  service)."""
  import numpy as np
  import torch

  from repro_torch.core import objectives as O
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops
  from repro_torch.service import SelectionService
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
  step = sz.n // sz.query_appends
  chunks = step // sz.append_block
  counts, ingest, report = {}, {}, {}
  svc = None
  for sieve_on in (False, True):
    torch.cuda.empty_cache()
    svc = SelectionService(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k,
                           capacity=sz.svc_cap0, append_block=sz.append_block,
                           seed=0, sieve=sieve_on)
    check(svc.sieve_enabled == sieve_on, "the sieve switch")
    acc_in, acc_q, wall, lat, answers = {}, {}, 0.0, [], []
    ops.reset_launch_counts()
    for a in range(sz.query_appends):
      part = feats[a * step:(a + 1) * step]
      sync()
      t0 = time.perf_counter()
      if a == sz.query_appends - 1:
        _, syncs = count_syncs(lambda p=part: svc.append(p))
      else:
        svc.append(part)
      sync()
      wall += time.perf_counter() - t0
      for kname, c in ops.launch_counts().items():
        acc_in[kname] = acc_in.get(kname, 0) + c
      ops.reset_launch_counts()
      if sieve_on:
        if a == sz.query_appends - 1:
          q, q_syncs = count_syncs(svc.query)
        else:
          q = svc.query()
        ids = q.sel_gids
        check(q.source == "sieve" and 0 < len(ids) <= sz.k and
              len(set(ids.tolist())) == len(ids) and ids.min() >= 0 and
              ids.max() < svc.n_docs, f"query after append {a}: {q}")
        lat.append(q.wall_s * 1e3)
        answers.append(len(ids))
        for kname, c in ops.launch_counts().items():
          acc_q[kname] = acc_q.get(kname, 0) + c
        ops.reset_launch_counts()
    check(svc.growths == 2 and svc.n_docs == sz.n, "query ingest: growths")
    name = "sieve" if sieve_on else "no_sieve"
    ingest[name] = dict(rows_per_s=sz.n / wall, append_s=wall,
                        syncs_per_chunk=syncs / chunks)
    counts["query_ingest" if sieve_on else "query_ingest_no_sieve"] = acc_in
    if sieve_on:
      counts["query_merge"] = acc_q
    else:
      check(acc_in["sieve_admit"] == 0, "sieve_admit ran with the sieve off")
      del svc
  check(counts["query_ingest"]["sieve_admit"] > 0,
        "sieve_admit was not launched on the ingest path")
  st = svc.store
  report.update(ingest=ingest, query_ms=lat, ids_per_query=answers,
                query_syncs=q_syncs, sieve_thresholds=st.sieve_thresholds,
                pooled=st.sieve_state.gid.numel(),
                sieve_state_mib=st.sieve_state_bytes / 2**20,
                admitted=int(st.sieve_state.count.sum()),
                launches_per_chunk=counts["query_ingest"]["sieve_admit"] / (
                    sz.n // sz.append_block))
  sieve_ids = q.sel_gids
  reqs = query_requests(sieve_ids, sz.query_b, sz.k, st.query_mask_cap)
  report["batch_pre_epoch"] = batch_vs_sequential(svc, reqs, "pre-epoch")
  _, report["batch_syncs"] = count_syncs(lambda: svc.query_batch(reqs))
  report["merge_routes"] = merge_routes(svc, feats, "sieve merge")
  e = svc.epoch()
  qe = svc.query()
  check(qe.source == "epoch" and np.array_equal(qe.sel_gids, e.sel_gids),
        "after the epoch a default query does not answer from it")
  qs = svc.query(seed=3)
  check(qs.source == "sieve" and set(qs.sel_gids.tolist()) <= set(
      e.sel_gids.tolist()) and len(qs.sel_gids) > 0,
        f"the reset grid's answer {qs.sel_gids} is not the epoch's picks")
  reqs = query_requests(e.sel_gids, sz.query_b, sz.k, st.query_mask_cap)
  report["batch_post_epoch"] = batch_vs_sequential(svc, reqs, "post-epoch")
  obj = O.FacilityLocation()
  perm = svc.epoch_perm(e.stats.epoch)
  f_sieve = sharded_value(obj, st, perm, sz.m, sieve_ids)
  f_epoch = sharded_value(obj, st, perm, sz.m, e.sel_gids)
  check(f_sieve >= 0.5 * f_epoch, f"f(sieve) {f_sieve!r} < 0.5 f(epoch) "
        f"{f_epoch!r}")
  report.update(f_sieve=f_sieve, f_epoch=f_epoch,
                f_ratio=f_sieve / f_epoch, epoch_wall_s=e.stats.wall_s,
                reset_answer=len(qs.sel_gids))
  emit("e2e query", n=sz.n, d=sz.d, m=sz.m, k=sz.k,
       append_block=sz.append_block, appends=sz.query_appends,
       launches=counts, **report)
  return counts, svc


def sieve_work(gains, rgids, active, tau, cnt0, src, cnt1, *,
               linear: bool) -> dict:
  """What one chunk's admission scan had to do, read from its inputs and
  its result: ``steps``, the most candidate rows one (shard, bucket) weighs
  in order (active, a real gid, gain at or above the bucket's threshold:
  no other row can be admitted) up to the row that fills it, none for a
  bucket full on entry; ``bytes``, what the scan must read and write once:
  for each weighed row the similarities of the bucket's live members (a
  standing member's from s_pre, one admitted earlier in the chunk from
  s_intra, each (row, member) pair of s_intra once over all buckets), the
  row tests up to the last weighed row, the thresholds, the admitted
  slots' gid and gain, src, the counts, and for the linear kernel the
  weighed rows' and the standing members' norms."""
  import torch
  n_sh, t, k = src.shape
  ab = gains.shape[0]
  dev = gains.device
  rows = torch.arange(ab, device=dev)
  ok = (rgids >= 0)[None, None, :] & active[:, None, :]
  cand = ok & ((tau <= 0)[None, :, None] | (gains[None, None, :] >=
                                            tau[None, :, None]))
  full = cnt1 == k
  last = torch.where(full & (cnt0 < k), src.amax(-1),
                     torch.where(cnt0 >= k, -1, ab - 1))
  weighed = cand & (rows <= last[..., None])               # (S, T, ab)
  steps = int(weighed.sum(-1).max())
  adm = torch.zeros((n_sh, t, ab + 1), dtype=torch.bool, device=dev)
  adm.scatter_(2, torch.where(src >= 0, src, ab), True)
  adm = adm[..., :ab]                                      # admitted rows
  pairs = (weighed.reshape(-1, ab).T.float() @ adm.reshape(-1, ab).float()
           > 0) & (rows[:, None] > rows[None, :])
  n_weighed = weighed.sum(-1)
  pre = int((n_weighed * cnt0).sum())
  seen = int(last.max()) + 1
  shard_seen = int((last.amax(-1) + 1).sum())
  new = int((cnt1 - cnt0).sum())
  moved = (pre * 4 + int(pairs.sum()) * 4 + seen * (4 + 8) + shard_seen +
           t * 4 + new * (8 + 4) + src.numel() * 8 + cnt0.numel() * 8 * 2)
  if linear:
    moved += int(weighed.any(0).any(0).sum()) * 4 + int(cnt0.sum()) * 4
  return dict(steps=steps, bytes=moved)


def sieve_kernel_phase(sz, state, launches: int):
  """The admission-scan kernel against its plain version (``ref.
  sieve_scan_ref``) on the card: the sieve state the full-size facility
  ingest left, shards 0 and 1 (a chunk that straddles a shard boundary:
  its first half lands on shard 0, the rest on shard 1), shard 0's four
  lowest buckets emptied so they fill, 4 chunks of 1024 new rows whose
  gains span the grid (duplicated rows among them, the last 8 rows gid
  -1 padding), linear and rbf, the same sweeps (``pairwise`` kernel) into
  both.  Every state must be equal bit for bit.  Both bounds count the
  work this run's data needs (``sieve_work``): ``bound_ms`` the bytes the
  scan must read and write at 3.35 TB/s, ``latency_bound_ms`` the longest
  chain of dependent steps a (shard, bucket) takes, each one L2 hit
  (``L2_HIT_S``); both are means over the chunks, as ``kernel_ms`` is."""
  import math

  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops, ref
  from repro_torch.kernels import sieve as SV
  m, k, d, ab = sz.m, sz.k, sz.d, sz.append_block
  t = state.count.numel() // m
  n_sh = 2
  g = torch.Generator(device=DEVICE).manual_seed(7)
  rows_all = EmbeddedCorpus(n_docs=sz.sieve_chunks * ab, feat_dim=d,
                            seed=1).features()
  delta = float(state.delta[0])
  jtop = int(state.jtop[0])
  tau = torch.exp((jtop - (t - 1) + torch.arange(t, device=DEVICE)).to(
      torch.float32) * math.log1p(0.5))
  rgids = torch.arange(ab, device=DEVICE) + 10**7
  rgids[-8:] = -1
  active = torch.zeros((n_sh, ab), dtype=torch.bool, device=DEVICE)
  active[0, :ab // 2] = True
  active[1, ab // 2:] = True
  rows = {}
  for kernel, h in (("linear", 0.75), ("rbf", 0.75)):
    gid = state.gid[:n_sh * t].view(n_sh, t, k).clone()
    gain = state.gain[:n_sh * t].view(n_sh, t, k).clone()
    feat = state.feat[:n_sh * t].view(n_sh, t, k, d).clone()
    cnt = state.count[:n_sh * t].view(n_sh, t).clone()
    cnt[0, :4] = 0
    gid[0, :4] = -1
    mine = (gid, gain, cnt)
    plain = tuple(x.clone() for x in mine)
    k_ms, admitted, intra, filled = [], 0, False, False
    p_ms, err, work = None, 0.0, []
    for c in range(sz.sieve_chunks):
      x = rows_all[c * ab:(c + 1) * ab].clone()
      x[1:4] = x[0]
      gains = delta * (0.02 + torch.rand(ab, generator=g, device=DEVICE))
      s_pre = ops.pairwise(x, feat.view(n_sh, t * k, d), kernel=kernel, h=h)
      s_intra = ops.pairwise(x, x, kernel=kernel, h=h)
      rsq, msq = (ref.sieve_norms(x, feat) if kernel == "linear"
                  else (None, None))
      args = (s_pre, s_intra, rsq, msq, gains, rgids, active, tau)
      got = SV.sieve_scan(*args, *mine)
      sync()
      want = ref.sieve_scan_ref(*args, *plain)
      for a, b in zip(got, want):
        check(torch.equal(a, b), f"sieve_admit {kernel} chunk {c}: the "
              "state differs from the plain version's")
        err = max(err, float(torch.where(
            a == b, 0.0, (a.double() - b.double()).abs()).max()))
      work.append(sieve_work(gains, rgids, active, tau, mine[2], got[2],
                             got[3], linear=kernel == "linear"))
      k_ms.append(time_ms(lambda: SV.sieve_scan(*args, *mine), reps=5))
      if p_ms is None:
        p_ms = time_ms(lambda: ref.sieve_scan_ref(*args, *plain), reps=1)
      src = got[2]
      admitted += int((got[3] - mine[2]).sum())
      intra |= bool(((src >= 0).sum(-1) >= 2).any())
      filled |= bool(((got[3] == k) & (mine[2] < k)).any())
      feat = torch.where((src >= 0)[..., None], x[src.clamp_min(0)], feat)
      mine = (got[0], got[1], got[3])
      plain = (want[0], want[1], want[3])
    check(admitted > 0 and intra and filled, f"sieve_admit {kernel}: "
          f"admitted {admitted}, intra-chunk {intra}, a bucket filled "
          f"{filled}")
    b_ms = [bound_ms(w["bytes"], 0.0, "f32")[0] for w in work]
    lat_ms = [w["steps"] * L2_HIT_S * 1e3 for w in work]
    row = dict(shape=[n_sh, ab, t, k], kernel=kernel, max_abs_err=err,
               bits_equal_plain=True, kernel_ms=sum(k_ms) / len(k_ms),
               kernel_ms_by_chunk=k_ms, plain_ms=p_ms, library_ms=None,
               bound_ms=sum(b_ms) / len(b_ms), bound_by="bytes",
               bound_ms_by_chunk=b_ms,
               latency_bound_ms=sum(lat_ms) / len(lat_ms),
               latency_bound_ms_by_chunk=lat_ms,
               steps_by_chunk=[w["steps"] for w in work],
               bytes_by_chunk=[w["bytes"] for w in work],
               admitted=admitted, intra_chunk=intra, bucket_filled=filled,
               launches=launches)
    emit(f"kernel sieve_admit {kernel}", **row)
    rows[("sieve_admit", kernel)] = row
  return rows


# ---------------------------------------------------------------------------
# the service over processes: CorpusStore / SelectionService on a mesh
# ---------------------------------------------------------------------------

SVC_DIST_DEADLINE = 30.0   # e2e service dist: beaten shards stay alive


def service_schedule(svc, feats, sz) -> dict:
  """The service-queries cell's schedule on ``svc`` (stacked, or one rank's
  of a mesh): 16 appends of 16,384 rows with a ``query()`` after each, a
  64-request ``query_batch``, epochs 0-2 (every shard beaten just before),
  a ``query()`` and another 64-request batch after them, then rank 1's
  shards failed through the board and one more epoch.  Returns host
  arrays of every answer and, under ``timing/``, the walls."""
  import numpy as np

  def ids_of(results):
    out = np.full((len(results), sz.k), -1, np.int64)
    for i, r in enumerate(results):
      out[i, :len(r.sel_gids)] = r.sel_gids
    return out

  rec, lat, ingest = {}, [], 0.0
  step = sz.n // sz.query_appends
  for a in range(sz.query_appends):
    sync()
    t0 = time.perf_counter()
    svc.append(feats[a * step:(a + 1) * step])
    sync()
    ingest += time.perf_counter() - t0
    q = svc.query()
    lat.append(q.wall_s * 1e3)
    rec[f"q{a}/ids"] = q.sel_gids
    rec[f"q{a}/est"] = np.array(q.value_estimate)
  base = q.sel_gids
  walls, batch_ms = [], []
  per = sz.m // DIST_RANKS
  for stage in ("pre", "post", "dead"):
    if stage == "post":
      for t in range(3):
        svc.board.beat()
        e = svc.epoch()
        walls.append(e.stats.wall_s)
        for f, v in (("ids", e.sel_gids), ("value", e.stats.value),
                     ("alive", e.stats.alive), ("warm", e.stats.warm),
                     ("rescans", e.stats.rescans)):
          rec[f"e{t}/{f}"] = np.asarray(v)
      q = svc.query(seed=3)
      rec["after/ids"], rec["after/est"] = q.sel_gids, np.array(
          q.value_estimate)
      base = e.sel_gids
    if stage == "dead":
      svc.board.beat()
      for s in range(per, 2 * per):
        if s in svc.board.shards:
          svc.board.fail(s)
      e = svc.epoch()
      walls.append(e.stats.wall_s)
      rec["e3/ids"], rec["e3/alive"] = e.sel_gids, e.stats.alive
      rec["e3/value"] = np.array(e.stats.value)
      break
    reqs = query_requests(base, sz.query_b, sz.k, svc.store.query_mask_cap)
    sync()
    t0 = time.perf_counter()
    res = svc.query_batch(reqs)
    batch_ms.append((time.perf_counter() - t0) * 1e3)
    rec[f"batch_{stage}/ids"] = ids_of(res)
    rec[f"batch_{stage}/est"] = np.array([r.value_estimate for r in res])
  rec["timing/ingest_rows_per_s"] = np.array(sz.n / ingest)
  rec["timing/query_ms"] = np.array(lat)
  rec["timing/batch_ms"] = np.array(batch_ms)
  rec["timing/epoch_wall_s"] = np.array(walls)
  rec["growths"] = np.array(svc.growths)
  return rec


def service_for(sz, mesh=None):
  from repro_torch.service import SelectionService
  return SelectionService(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k,
                          capacity=sz.svc_cap0, append_block=sz.append_block,
                          seed=0, deadline=SVC_DIST_DEADLINE, device=DEVICE,
                          mesh=mesh)


def dist_service_rank(out_dir: str) -> None:
  """One rank of e2e service dist's library run (``chip_smoke.py
  --dist-service DIR`` under torchrun): the facility service over a gloo
  mesh of 4 ranks on the card, ``service_schedule``; writes its answers,
  walls, peak, collectives and launch counts to DIR."""
  sys.path.insert(0, str(SRC))
  import numpy as np
  import torch

  from repro_torch import no_tf32
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops
  from repro_torch.launch.mesh import ProcessMesh
  no_tf32()
  sz = Sizes()
  mesh = ProcessMesh.from_env(sz.m, "gloo", DEVICE)
  feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0,
                         device=str(mesh.device)).features()
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launch_counts()
  rec = service_schedule(service_for(sz, mesh), feats, sz)
  launches = ops.launch_counts()
  np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **rec,
           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
           collectives=[mesh.gathers, mesh.gather_bytes, mesh.exchanges,
                        mesh.exchange_bytes],
           launch_names=list(launches), launch_counts=list(launches.values()))
  mesh.close()


def e2e_service_dist(sz: Sizes):
  """The selection service over processes at the service cells' size
  (n = 262144, d = 64, m = 16 over 4 gloo ranks on this card, 4 shards a
  rank, k = kappa = 64, append_block 1024, capacity 65536 doubling twice).

  The CLI's service mode under ``torch.distributed.run`` (75 % ingested,
  a 64-request ``query_batch`` whose parity every rank checks, epoch 0,
  the rest in 4 appends of 16,384 with a ``query()`` after each, epochs 1
  and 2, another batch), once for facility location and once for
  saturated coverage, against the same command in this process: equal
  ids, every epoch's f(S), alive, warm and rescans and every query's value
  estimate bit for bit, each rank's peak within a quarter of the stacked
  peak plus 0.5 GiB, and ``pairwise``, ``sieve_admit`` and the facility /
  coverage gains launched in the ranks.  With 4 or more cards the same
  over nccl, one rank a card.  Then the library run (``service_schedule``
  on the facility service, rank 1's shards failed through the board before
  a last epoch) against the stacked service: every answer bit for bit on
  every rank.  The gloo launches and the library run go side by side
  while this process makes the stacked answers, so every wall, stacked
  or not, includes the host and the card shared with the others.  Prints
  ingest rows/s, epoch walls, query latency, the collectives and their
  bytes beside the stacked run's."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.launch import select as cli
  common = ["-m", "repro_torch.launch.select", "--n-docs", str(sz.n),
            "--dim", str(sz.d), "--k", str(sz.k), "--mesh", str(sz.m),
            "--epochs", "3", "--append-frac", str(sz.append_frac),
            "--capacity", str(sz.svc_cap0), "--no-coverage"]
  queries = ["--query-every", str(sz.n // sz.query_appends), "--query-batch",
             str(sz.query_b)]
  # the kernels a rank must launch; information gain keeps no standing
  # sieve, so its runs ask no query and append the last 25 % at once
  gains = {"facility": ("pairwise", "sieve_admit", "facility_gain"),
           "saturated_coverage": ("pairwise", "sieve_admit",
                                  "coverage_gain"),
           "info_gain": ("info_gain_cond",)}
  cards = torch.cuda.device_count()
  backends = ["gloo"] + (["nccl"] if cards >= DIST_RANKS else [])
  rows = {}

  def records(path):
    with open(path) as f:
      return json.load(f)["stats"]

  def base_of(obj):
    return common + (queries if obj != "info_gain" else [])

  def start(backend):
    """Every objective's CLI run over ``backend``, side by side."""
    started = {}
    for obj in gains:
      out, stats = (os.path.join(tmp, f"{obj}_{backend}.{x}")
                    for x in ("npy", "json"))
      started[obj] = (out, stats, torchrun_async(
          [*base_of(obj), "--objective", obj, "--dist-backend", backend,
           "--out", out, "--stats-json", stats]))
    return started

  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    # the gloo runs and the library run side by side (a rank's peak is
    # under 0.6 GiB), while this process makes the stacked answers
    by_backend = {"gloo": start("gloo")}
    lib_dir = os.path.join(tmp, "library")
    os.mkdir(lib_dir)
    lib_launch = torchrun_async([str(REPO / "chip_smoke.py"),
                                 "--dist-service", lib_dir])
    stacked = {}
    for obj in gains:
      out, stats = (os.path.join(tmp, f"{obj}.{x}") for x in ("npy", "json"))
      res = timed_run(lambda: cli.main([*base_of(obj)[2:], "--objective",
                                        obj, "--out", out, "--stats-json",
                                        stats]))
      stacked[obj] = (res, np.load(out), records(stats))
    feats = EmbeddedCorpus(n_docs=sz.n, feat_dim=sz.d, seed=0).features()
    lib_res = timed_run(lambda: service_schedule(service_for(sz), feats, sz))
    del feats
    torch.cuda.empty_cache()
    for backend in backends:
      if backend not in by_backend:
        by_backend[backend] = start(backend)
    for obj, kernels in gains.items():
      events = {"epoch": ("f", "alive", "warm", "rescans", "docs", "live",
                          "cap"), "append": ("docs", "growths")}
      if obj != "info_gain":
        events.update(query=("est", "ids", "source"),
                      query_batch=("parity", "requests"))
      res, want_ids, want = stacked[obj]
      for backend in backends:
        out, stats, launch = by_backend[backend][obj]
        wall, _ = launch.result()
        ids, got = np.load(out), records(stats)
        what = f"e2e service dist {backend} {obj}"
        check(np.array_equal(ids, want_ids), f"{what}: ids {ids.tolist()} "
              f"differ from the stacked run's {want_ids.tolist()}")
        for event, keys in events.items():
          a = [{k: r[k] for k in keys} for r in got if r["event"] == event]
          b = [{k: r[k] for k in keys} for r in want if r["event"] == event]
          check(a == b and a, f"{what}: {event} records {a} against the "
                f"stacked run's {b}")
        done = [r for r in got if r["event"] == "done"]
        check(len(done) == 1 and done[0]["world"] == DIST_RANKS,
              f"{what}: done records {done}")
        done = done[0]
        peaks = [float(p) for p in done["rank_peak_gib"].split(",")]
        limit = res["peak_gib"] / DIST_RANKS + 0.5
        check(len(peaks) == DIST_RANKS and max(peaks) <= limit,
              f"{what}: rank peaks {peaks} GiB over {limit} (stacked "
              f"{res['peak_gib']})")
        launched = dict(kv.split(":") for kv in done["launches"].split(",")
                        if ":" in kv)
        for kname in kernels:
          check(int(launched.get(kname, 0)) > 0, f"{what}: rank 0 did not "
                f"launch {kname} ({launched})")
        check(done["exchanges"] > 0, f"{what}: no row moved between ranks")
        pick = {e: [r for r in got if r["event"] == e]
                for e in ("epoch", "query", "query_batch", "append")}
        ref = {e: [r for r in want if r["event"] == e]
               for e in ("epoch", "query", "query_batch", "append")}
        rows[f"cli {backend} {obj}"] = dict(
            ids_equal=True, launch_wall_s=wall, wall_s=done["wall_s"],
            stacked_wall_s=[r for r in want if r["event"] == "done"][0][
                "wall_s"],
            epoch_wall_s=[r["wall_s"] for r in pick["epoch"]],
            stacked_epoch_wall_s=[r["wall_s"] for r in ref["epoch"]],
            ingest_rows_per_s=[r["rows_per_s"] for r in pick["append"]],
            stacked_ingest_rows_per_s=[r["rows_per_s"]
                                       for r in ref["append"]],
            query_ms=[r["wall_ms"] for r in pick["query"]],
            stacked_query_ms=[r["wall_ms"] for r in ref["query"]],
            batch_ms=[r["batch_ms"] for r in pick["query_batch"]],
            stacked_batch_ms=[r["batch_ms"] for r in ref["query_batch"]],
            rank_peak_gib=peaks, stacked_peak_gib=res["peak_gib"],
            limit_gib=limit, gathers=done["gathers"],
            gather_bytes=done["gather_bytes"],
            exchanges=done["exchanges"],
            exchange_bytes=done["exchange_bytes"], launches=launched)
    # the library run: every answer of the schedule, rank 1's shards dead
    wall, _ = lib_launch.result()
    ranks = [dict(np.load(os.path.join(lib_dir, f"rank{r}.npz")))
             for r in range(DIST_RANKS)]
  res = lib_res
  want = res["result"]
  per = sz.m // DIST_RANKS
  alive = [not per <= s < 2 * per for s in range(sz.m)]
  check(want["e3/alive"].tolist() == alive and want["e2/alive"].all(),
        f"e2e service dist: stacked alive {want['e3/alive'].tolist()}")
  check(int(want["growths"]) == 2, "e2e service dist: growths")
  for r, got in enumerate(ranks):
    for key, w in want.items():
      if key.startswith("timing/"):
        continue
      g = got[key]
      check(g.dtype == w.dtype and g.shape == w.shape and
            np.array_equal(g, w), f"e2e service dist library: rank {r} "
            f"{key} {g} differs from the stacked service's {w}")
    counts = dict(zip(got["launch_names"].tolist(),
                      got["launch_counts"].tolist()))
    for kname in ("pairwise", "sieve_admit", "facility_gain"):
      check(counts[kname] > 0, f"e2e service dist library: rank {r} did "
            f"not launch {kname} ({counts})")
  peaks = [float(g["peak_gib"]) for g in ranks]
  limit = res["peak_gib"] / DIST_RANKS + 0.5
  check(max(peaks) <= limit, f"e2e service dist library: rank peaks "
        f"{peaks} over {limit}")
  col = ranks[0]["collectives"].tolist()
  rows["library gloo facility"] = dict(
      answers_equal=len([k for k in want if not k.startswith("timing/")]),
      launch_wall_s=wall, alive_last=int(sum(alive)),
      ingest_rows_per_s=[float(g["timing/ingest_rows_per_s"])
                         for g in ranks],
      stacked_ingest_rows_per_s=float(want["timing/ingest_rows_per_s"]),
      epoch_wall_s=ranks[0]["timing/epoch_wall_s"].tolist(),
      stacked_epoch_wall_s=want["timing/epoch_wall_s"].tolist(),
      query_ms_median=float(np.median(ranks[0]["timing/query_ms"])),
      query_ms=ranks[0]["timing/query_ms"].tolist(),
      stacked_query_ms_median=float(np.median(want["timing/query_ms"])),
      batch_ms=ranks[0]["timing/batch_ms"].tolist(),
      stacked_batch_ms=want["timing/batch_ms"].tolist(),
      rank_peak_gib=peaks, stacked_peak_gib=res["peak_gib"],
      limit_gib=limit, gathers=col[0], gather_bytes=col[1],
      exchanges=col[2], exchange_bytes=col[3],
      launches=dict(zip(ranks[0]["launch_names"].tolist(),
                        ranks[0]["launch_counts"].tolist())))
  nccl = ("run, one rank a card" if "nccl" in backends else
          f"not run: {cards} card(s) here and nccl puts one rank on each "
          f"of {DIST_RANKS} cards")
  emit("e2e service dist", n=sz.n, d=sz.d, k=sz.k, m=sz.m,
       ranks=DIST_RANKS, shards_a_rank=sz.m // DIST_RANKS,
       launches_side_by_side=len(gains) + 1,
       stacked_beside_launches=True,
       append_block=sz.append_block, capacity0=sz.svc_cap0, nccl=nccl,
       runs=rows)


def e2e_query_exact(sz):
  """The exact tier on its own store of 16,384 rows (the size of
  benchmarks/query_serving.py), m = 16, k_cap = 64: 64 tenant requests
  (k over 1..64, exclusion lists of up to 16 ids) through
  ``query_batch(tier="exact")``, one batched ``facility_select`` a pick,
  against the plain route (a store of backend "ref", 4 lanes a call):
  ids equal, or a near-tie whose values agree within 1e-5.  Reports the
  visible counts and both wall times."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.kernels import ops
  from repro_torch.service import SelectionService
  feats = EmbeddedCorpus(n_docs=sz.exact_n, feat_dim=sz.d, seed=2).features()
  kw = dict(m=sz.m, d=sz.d, kappa=sz.k, k_final=sz.k, capacity=sz.exact_n,
            append_block=sz.append_block, seed=0)
  svc = SelectionService(**kw)
  plain = SelectionService(backend="ref", sieve=False,
                           query_batch_tile=sz.exact_plain_tile, **kw)
  svc.append(feats)
  plain.append(feats)
  reqs = query_requests(svc.query().sel_gids, sz.exact_b, sz.k,
                        svc.store.query_mask_cap)
  torch.cuda.empty_cache()
  ops.reset_launch_counts()
  sync()
  t0 = time.perf_counter()
  got = svc.query_batch(reqs, tier="exact")
  wall = time.perf_counter() - t0
  launches = ops.launch_counts()
  check(launches["facility_select"] == sz.k,
        f"exact tier: {launches['facility_select']} facility_select "
        f"launches, expected one a pick ({sz.k})")
  ks = np.array([r.k for r in reqs])
  excl = np.full((len(reqs), svc.store.query_mask_cap), -1, np.int64)
  for i, r in enumerate(reqs):
    excl[i, :len(r.exclude_gids)] = r.exclude_gids
  sync()
  t0 = time.perf_counter()
  g, s, nvis = plain.store.query_exact_batch(ks, excl, k_cap=sz.k)
  wall_plain = time.perf_counter() - t0
  verdicts = []
  for i, r in enumerate(got):
    want = g[i][g[i] >= 0]
    check(r.source == "exact" and len(r.sel_gids) == reqs[i].k and
          len(set(r.sel_gids.tolist())) == reqs[i].k and not
          set(reqs[i].exclude_gids) & set(r.sel_gids.tolist()),
          f"exact request {i}: ids {r.sel_gids}")
    v_plain = float(s[i][g[i] >= 0].sum()) / float(nvis[i])
    rel = abs(r.value_estimate - v_plain) / max(abs(v_plain), 1e-30)
    if np.array_equal(r.sel_gids, want):
      verdicts.append("equal")
    else:
      check(rel <= 1e-5, f"exact request {i}: kernel {r.sel_gids} "
            f"({r.value_estimate!r}) vs plain {want} ({v_plain!r})")
      verdicts.append(f"near-tie (f rel {rel:.2e})")
  n_equal = sum(v == "equal" for v in verdicts)
  emit("e2e query exact", n=sz.exact_n, d=sz.d, requests=sz.exact_b,
       k_cap=sz.k, wall_s=wall, plain_wall_s=wall_plain,
       nvis=sorted(set(nvis.astype(int).tolist())), equal=n_equal,
       near_ties=[v for v in verdicts if v != "equal"], launches=launches)


def profile_query(svc, sz):
  """Where a 64-request query tile's time goes: one ``query_batch`` over
  the full-size sieve under ``profiled``."""
  reqs = query_requests(svc.query(seed=1).sel_gids, sz.query_b, sz.k,
                        svc.store.query_mask_cap)
  svc.query_batch(reqs)  # warm-up
  profiled("profile query batch", lambda: svc.query_batch(reqs))


# ---------------------------------------------------------------------------
# graph cut (Sec. 5 / 6.3): kernels 8-9, GreeDi with RandomGreedy, Alg. 3
# ---------------------------------------------------------------------------


def cut_tol_ok(got, want, w, cols):
  """Gains within rtol 1e-5 plus 1e-5 of each row's absolute sum
  sum_u |W_vu c_u| (the f32 sum's own scale; bf16 W is exact in f32, so
  one tolerance serves both).  Returns (ok, max abs error, max error over
  its tolerance)."""
  scale = cols.abs() @ w.float().abs().T
  err = (got.float() - want.float()).abs()
  tol = 1e-5 * want.float().abs() + 1e-5 * scale
  return (bool((err <= tol).all()), float(err.max()),
          float((err / tol.clamp_min(1e-30)).max()))


def cut_weights_small(g, n, dtype):
  """A ragged test graph on the card: exponential weights on 5 % of the
  pairs, symmetric, zero diagonal."""
  import torch
  w = torch.rand(n, n, generator=g, device=DEVICE)
  e = -torch.log(torch.rand(n, n, generator=g, device=DEVICE))
  w = torch.where(w < 0.05, e, 0.0)
  w = 0.5 * (w + w.T)
  w.fill_diagonal_(0.0)
  return w.to(dtype).contiguous()


def cut_edge_phase():
  """Both graph-cut kernels against the plain versions at the edges:
  ragged n (narrow loads) and n % 8 == 0 (16-byte loads), P = 1, 10, 16
  and 37 (more than one pass of 16) with partition indicators, f32 and
  bf16 W, nothing feasible, and exact ties (binary weights, the empty
  selection: every gain is a degree)."""
  import torch

  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(14)
  worst = 0.0
  for n in (100, 513, 1899, 4096):
    for dtype in (torch.float32, torch.bfloat16):
      w = cut_weights_small(g, n, dtype)
      for P in (None, 1, 10, 16, 37):
        lead = () if P is None else (P,)
        x = (torch.rand(*lead, n, generator=g, device=DEVICE) < 0.3).float()
        ind = None if P is None else (torch.rand(
            P, n, generator=g, device=DEVICE) < 0.5).float()
        ok = torch.rand(*lead, n, generator=g, device=DEVICE) < 0.7
        got = ops.graph_cut_gain(w, x, ind)
        best, idx = ops.graph_cut_select(w, x, ok, ind)
        want = ref.graph_cut_gain_ref(w, x, ind)
        wb, wi = ref.masked_top1(want, ok)
        sync()
        good, _, rel = cut_tol_ok(got, want, w, ref.graph_cut_cols(x, ind))
        worst = max(worst, rel)
        check(good, f"graph_cut_gain edge n={n} {dtype} P={P}: error "
              f"{rel:.3f} of its tolerance")
        check(torch.equal(idx, wi), f"graph_cut_select edge n={n} {dtype} "
              f"P={P}: {idx.tolist()} vs {wi.tolist()}")
        none = torch.zeros_like(ok)
        best, idx = ops.graph_cut_select(w, x, none, ind)
        sync()
        check(bool((best == ref.NEG).all()) and bool((idx == 0).all()),
              f"graph_cut_select all-infeasible n={n}: {best.tolist()}")
  # exact ties: a ring with binary weights, every degree (the gain at the
  # empty selection) 2; each row's answer is its first feasible node
  n = 1000
  ring = torch.zeros(n, n, device=DEVICE)
  i = torch.arange(n, device=DEVICE)
  ring[i, (i + 1) % n] = 1.0
  ring[(i + 1) % n, i] = 1.0
  zeros = torch.zeros(4, n, device=DEVICE)
  ok = torch.rand(4, n, generator=g, device=DEVICE) < 0.1
  first = torch.where(ok, i, n).min(dim=1).values
  for dtype in (torch.float32, torch.bfloat16):
    best, idx = ops.graph_cut_select(ring.to(dtype), zeros, ok)
    wb, wi = ref.graph_cut_select_ref(ring.to(dtype), zeros, ok)
    sync()
    check(torch.equal(idx, wi) and torch.equal(idx, first) and
          bool((best == 2.0).all()), f"graph_cut_select ties: "
          f"{idx.tolist()} vs {wi.tolist()}")
  emit("kernel graph cut edges", n=[100, 513, 1899, 4096],
       P=[None, 1, 10, 16, 37], dtypes=["f32", "bf16"],
       worst_err_over_tol=worst, all_infeasible="(NEG, 0)",
       ties="lowest index (a ring: every gain 2)", result="pass")


def cut_value(w, nodes):
  """f(S) = sum_{i in S, j not in S} w_ij of the node set ``nodes``,
  replayed on the whole graph independently of ``GraphCut``: one
  PyTorch GEMV, the sum in float64."""
  import torch
  x = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
  x[torch.as_tensor(nodes, device=w.device).long()] = 1.0
  return float((x.double() * torch.mv(w.float(), 1.0 - x).double()).sum())


def cut_min_gap(w, cand_nodes, cand_ok, idx, kk, ind=None):
  """The smallest relative gap between adjacent distinct entries of a
  RandomGreedy run's ranked top-kk lists, replayed in float64 on the host
  (the near-tie test: below TOL_GAP two summation orders may swap a rank).
  ``idx`` are the run's candidate rows (-1 = no-op)."""
  import numpy as np
  w64 = w.double().cpu().numpy()
  x = np.zeros(w64.shape[0])
  sel = np.zeros(len(cand_nodes), bool)
  gap = np.inf
  for i in idx:
    c = 1.0 - 2.0 * x
    if ind is not None:
      c = c * ind
    gains = np.where(cand_nodes >= 0,
                     (w64 @ c)[np.maximum(cand_nodes, 0)], 0.0)
    top = np.sort(gains[cand_ok & ~sel])[::-1][:kk]
    for a, b in zip(top[:-1], top[1:]):
      if a != b:
        gap = min(gap, (a - b) / max(abs(a), abs(b), 1e-30))
    if i >= 0:
      x[cand_nodes[i]] = 1.0
      sel[i] = True
  return float(gap)


def cut_objective(w):
  """GraphCut over W (made symmetric with a zero diagonal in place) and
  the init_for callables of the Fig. 9 protocol: round 1 on each
  partition's induced subgraph (the node indicator of its one-hot rows),
  the final evaluation on the whole graph."""
  from repro_torch.core import objectives as O
  obj = O.GraphCut()
  obj.init_w(w)

  def init_local(ef, em):
    return obj.init_induced(w, (em.unsqueeze(-2) @ ef).squeeze(-2))

  def init_global(ef, em):
    return obj.init_induced(w)

  return obj, init_local, init_global


def e2e_cut_paper(sz):
  """The Fig. 9 settings: the 1,899-node Facebook-like graph of Sec. 6.3
  (``social_graph``, the reference's generator), m = 10, k = kappa = 20,
  local evaluation, RandomGreedy with stop_nonpositive, 2 seeds.  Each
  seed's draws are drawn once and given to the kernels (backend "auto")
  and to the plain versions on the card ("ref"): both rounds pick the same
  ids, or the float64 replay finds a near-tie in a ranked list.  GreeDi /
  centralized against the Thm-12 floor; every f(S) replayed on the whole
  graph.  W is 14.4 MB here, so the launches are host-bound."""
  import numpy as np
  import torch

  from repro_torch.core import bounds
  from repro_torch.core import greedi as GD
  from repro_torch.core.greedy import draw_table, greedy
  from repro_torch.core.partition import random_partition
  from repro_torch.data.graphs import social_graph
  from repro_torch.kernels import ops
  n, m, k = sz.cut_paper_n, sz.cut_paper_m, sz.cut_paper_k
  t0 = time.perf_counter()
  w = torch.as_tensor(social_graph(n, seed=0), device=DEVICE)
  t_graph = time.perf_counter() - t0
  obj, init_local, init_global = cut_objective(w)
  eye = torch.eye(n, device=DEVICE)
  npp = -(-n // m)
  rows, counts = [], {}
  gen = torch.Generator(device=DEVICE)
  rc, v_c = GD.centralized_greedy(eye, k, objective=obj,
                                  init_for=init_global, mode="random",
                                  rng=gen.manual_seed(7),
                                  stop_nonpositive=True)
  c_ids = rc.idx[rc.idx >= 0].cpu().numpy()
  v_c = float(v_c)
  check(abs(cut_value(w, c_ids) - v_c) <= 1e-5 * v_c,
        f"cut paper centralized: f(S) {v_c} vs replay")
  floor = bounds.thm12_bound(m, k, bounds.random_greedy_bound())
  for seed in range(sz.cut_paper_seeds):
    perm = random_partition(gen.manual_seed(100 + seed), eye, m)[2]
    parts, pmask, _ = random_partition(None, eye, m, perm=perm)
    t1 = draw_table("random", gen.manual_seed(200 + seed), (m,), k, npp,
                    device=DEVICE)
    t2 = draw_table("random", gen.manual_seed(300 + seed), (), k, m * k,
                    device=DEVICE)
    # both rounds, kernels against the plain versions, the same draws
    r1, r2, gids = {}, {}, {}
    for backend in ("auto", "ref"):
      st = init_local(parts, pmask.float())
      r1[backend] = greedy(obj, st, parts, k, cand_mask=pmask, mode="random",
                           draws=t1, stop_nonpositive=True, backend=backend)
      gids[backend] = torch.where(r1[backend].idx >= 0, torch.gather(
          perm, 1, r1[backend].idx.clamp_min(0)), -1).reshape(-1)
      b = gids[backend]
      r2[backend] = greedy(obj, init_global(None, None),
                           eye[b.clamp_min(0)], k, cand_mask=b >= 0,
                           mode="random", draws=t2, stop_nonpositive=True,
                           backend=backend)
    same1 = torch.equal(r1["auto"].idx, r1["ref"].idx)
    same2 = same1 and torch.equal(r2["auto"].idx, r2["ref"].idx)
    pm = perm.cpu().numpy()
    gap1 = min(cut_min_gap(w, pm[i], pm[i] >= 0,
                           r1["ref"].idx[i].cpu().numpy(), min(k, npp),
                           ind=np.isin(np.arange(n), pm[i]).astype(float))
               for i in range(m))
    bn = gids["ref"].cpu().numpy()
    gap2 = cut_min_gap(w, bn, bn >= 0, r2["ref"].idx.cpu().numpy(), k)
    check(same1 or gap1 < TOL_GAP, f"cut paper seed {seed}: round 1 differs "
          f"without a near-tie (gap {gap1:.2e})")
    check(same2 or not same1 or gap2 < TOL_GAP, f"cut paper seed {seed}: "
          f"round 2 differs without a near-tie (gap {gap2:.2e})")
    # the protocol end to end, same partition and draws, kernels and plain
    res = {}
    for backend in ("auto", "ref"):
      ops.reset_launch_counts()
      sync()
      t0 = time.perf_counter()
      res[backend] = GD.greedi_reference(
          None, eye, m=m, kappa=k, k_final=k, objective=obj,
          init_for=init_local, local_eval=True, mode="random",
          stop_nonpositive=True, backend=backend, perm=perm, r1_draws=t1,
          r2_draws=t2)
      sync()
      wall = time.perf_counter() - t0
      counts[f"paper_seed{seed}_{backend}"] = ops.launch_counts()
      r = res[backend]
      ids = r.sel_gids[r.sel_valid].cpu().numpy()
      check(len(set(ids.tolist())) == len(ids) and len(ids) > 0,
            f"cut paper {backend}: bad ids")
      check(abs(cut_value(w, ids) - float(r.value)) <= 1e-5 * float(r.value),
            f"cut paper {backend}: f(S) {float(r.value)} vs replay")
      rows.append(dict(seed=seed, backend=backend, wall_s=wall,
                       value=float(r.value), ratio=float(r.value) / v_c,
                       same_ids_as_plain_rounds=[same1, same2],
                       min_ranked_gap=[gap1, gap2]))
    a, b = res["auto"], res["ref"]
    check(not same2 or torch.equal(a.sel_gids, b.sel_gids),
          f"cut paper seed {seed}: protocol ids differ, rounds equal")
    check(float(a.value) / v_c >= floor, f"cut paper seed {seed}: ratio "
          f"{float(a.value) / v_c} below the Thm-12 floor {floor}")
  check(counts["paper_seed0_auto"]["graph_cut_gain"] > 0 and
        counts["paper_seed0_ref"]["graph_cut_gain"] == 0,
        "the paper-size kernels ran on the wrong backend")
  emit("e2e cut paper", n=n, edges=int((w > 0).sum()) // 2, m=m, k=k,
       kappa=k, seeds=sz.cut_paper_seeds, graph_s=t_graph, v_centralized=v_c,
       runs=rows, thm12_floor=floor,
       mean_ratio=float(np.mean([r_["ratio"] for r_ in rows
                                 if r_["backend"] == "auto"])),
       launches=counts)
  return counts["paper_seed0_auto"]


def e2e_cut_full(sz):
  """The graph-cut path at a real social graph's size: n = 36692 nodes and
  183,831 edges (the node and edge counts of the SNAP email-Enron graph),
  a Chung-Lu graph with power-law degrees drawn on the card, exponential
  weights; W and the one-hot candidate block 5.39 GB each in f32; m = 16
  ragged partitions of 2,294 rows with 12 holes; k = kappa = 64.  Paths:
  ``greedi_reference`` (local evaluation, RandomGreedy: kernel 8's main
  path), Alg. 3 under a partition matroid of 32 communities with cap 2
  (the example's flow: the matroid caps hold), ``centralized_greedy`` in
  mode "random", and ``centralized_greedy`` with
  ``GraphCut(assume_node_order=True)`` in mode "standard" (kernel 9's main
  path), which must pick what kernel 8 + masked_top1 pick.  Each path's
  launch counts are set to 0 before it and read after it, with its wall
  time and peak memory; every f(S) is replayed on the whole graph.  No
  (m, n, n) tensor exists: one W serves every partition."""
  import runpy

  import torch

  from repro_torch.core import bounds
  from repro_torch.core import constraints as C
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  from repro_torch.data.graphs import chung_lu_graph
  from repro_torch.kernels import ops
  n, m, k = sz.cut_n, sz.cut_m, sz.cut_k
  sync()
  t0 = time.perf_counter()
  w = chung_lu_graph(n, sz.cut_edges, seed=0, device=DEVICE)
  obj, init_local, init_global = cut_objective(w)
  eye = torch.eye(n, device=DEVICE)
  sync()
  t_setup = time.perf_counter() - t0
  deg = (w > 0).sum(1)
  alg3 = runpy.run_path(str(REPO / "examples" / "maxcut_constrained_torch.py"),
                        run_name="smoke")["alg3"]
  comm = torch.arange(n, device=DEVICE) % sz.cut_comm
  matroid = C.PartitionMatroid(num_parts=sz.cut_comm,
                               caps=(sz.cut_cap,) * sz.cut_comm)
  fused = O.GraphCut(assume_node_order=True)

  def gen(s):
    return torch.Generator(device=DEVICE).manual_seed(s)

  paths = {
      "cut_greedi": lambda: GD.greedi_reference(
          gen(0), eye, m=m, kappa=k, k_final=k, objective=obj,
          init_for=init_local, local_eval=True, mode="random",
          stop_nonpositive=True),
      "cut_alg3": lambda: alg3(w, comm, matroid, m,
                               sz.cut_cap * sz.cut_comm, seed=0, obj=obj),
      "cut_centralized": lambda: GD.centralized_greedy(
          eye, k, objective=obj, init_for=init_global, mode="random",
          rng=gen(1), stop_nonpositive=True),
      "cut_node_order": lambda: GD.centralized_greedy(
          eye, k, objective=fused, init_for=init_global,
          stop_nonpositive=True),
      "cut_two_pass": lambda: GD.centralized_greedy(
          eye, k, objective=fused, init_for=init_global,
          stop_nonpositive=True, use_select=False),
  }
  out, counts = {}, {}
  for name, run in paths.items():
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    wall = time.perf_counter() - t0
    counts[name] = ops.launch_counts()
    if name == "cut_greedi":
      ids, value = res.sel_gids[res.sel_valid], float(res.value)
      extra = dict(v_merged=float(res.value_merged),
                   v_best_single=float(res.value_best_single))
    elif name == "cut_alg3":
      ids, value = res["ids"], res["v_greedi"]
      extra = dict(v_centralized_matroid=res["v_centralized"],
                   ratio=res["ratio"], thm12_floor=res["thm12_floor"])
      per_comm = torch.bincount(comm[ids], minlength=sz.cut_comm)
      check(bool((per_comm <= sz.cut_cap).all()),
            f"alg3: a community holds {int(per_comm.max())} seeds")
      check(res["ratio"] >= res["thm12_floor"], f"alg3: ratio "
            f"{res['ratio']} below the Thm-12 floor {res['thm12_floor']}")
      cids = res["centralized_ids"].cpu().numpy()
      check(abs(cut_value(w, cids) - res["v_centralized"])
            <= 1e-5 * res["v_centralized"], "alg3: centralized f(S) replay")
      per_c = torch.bincount(comm[res["centralized_ids"]],
                             minlength=sz.cut_comm)
      check(bool((per_c <= sz.cut_cap).all()), "alg3 centralized: caps")
      extra["seeds_per_community_max"] = int(per_comm.max())
    else:
      r, v = res
      ids, value = r.idx[r.idx >= 0], float(v)
      extra = {}
    ids = ids.cpu().numpy()
    check(len(ids) > 0 and len(set(ids.tolist())) == len(ids)
          and ids.min() >= 0 and ids.max() < n, f"{name}: bad ids")
    replay = cut_value(w, ids)
    check(abs(replay - value) <= 1e-5 * abs(value), f"{name}: reported "
          f"f(S) {value!r}, replay {replay!r}")
    out[name] = dict(ids=ids, value=value, wall_s=wall,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     selected=len(ids), **extra)
  check(counts["cut_greedi"]["graph_cut_gain"] > 0,
        "graph_cut_gain was not launched on the GreeDi path")
  check(counts["cut_node_order"]["graph_cut_select"] == k,
        "graph_cut_select did not run every step of the node-order path")
  check(counts["cut_two_pass"]["graph_cut_select"] == 0,
        "the two-pass path launched the select kernel")
  agree = np_equal(out["cut_node_order"]["ids"], out["cut_two_pass"]["ids"])
  check(agree, "assume_node_order picked other nodes than kernel 8 + "
        "masked_top1")
  v_c = out["cut_centralized"]["value"]
  floor = bounds.thm12_bound(m, k, bounds.random_greedy_bound())
  ratio = out["cut_greedi"]["value"] / v_c
  check(ratio >= floor, f"cut greedi: ratio {ratio} below the Thm-12 floor "
        f"{floor}")
  emit("e2e cut full-size", n=n, edges=int(deg.sum()) // 2,
       max_degree=int(deg.max()), mean_degree=float(deg.float().mean()),
       m=m, k=k, kappa=k, rows_per_partition=-(-n // m),
       holes=m * -(-n // m) - n, w_gb=n * n * 4 / 1e9, setup_s=t_setup,
       communities=sz.cut_comm, cap=sz.cut_cap,
       wall_s={p: r["wall_s"] for p, r in out.items()},
       peak_gib={p: r["peak_gib"] for p, r in out.items()},
       value={p: r["value"] for p, r in out.items()},
       selected={p: r["selected"] for p, r in out.items()},
       extra={p: {k_: v for k_, v in r.items() if k_ not in (
           "ids", "value", "wall_s", "peak_gib", "selected")}
              for p, r in out.items()},
       ratio_to_centralized=ratio, thm12_floor=floor,
       node_order_equals_two_pass=agree, launches=counts)
  del w, eye
  return counts


def np_equal(a, b):
  import numpy as np
  return bool(np.array_equal(np.asarray(a), np.asarray(b)))


# the graph-cut kernel phase's cases: label, n, P (None = unbatched),
# partition indicators, W dtype, and the paths that launch the kernels at
# that shape
CUT_CASES = (
    ("round1 local", "full", 16, True, "f32",
     ["cut_greedi", "cut_alg3"]),
    ("replay", "full", 16, False, "f32", ["cut_greedi", "cut_alg3"]),
    ("unbatched", "full", None, False, "f32",
     ["cut_greedi", "cut_alg3", "cut_centralized", "cut_node_order",
      "cut_two_pass"]),
    ("unbatched bf16", "full", None, False, "bf16", []),
    ("round1 local bf16", "full", 16, True, "bf16", []),
    ("paper round1 local", "paper", 10, True, "f32", ["paper"]),
    ("paper unbatched", "paper", None, False, "f32", ["paper"]),
)


def cut_kernel_phase(sz, path_counts: dict):
  """graph_cut_gain and graph_cut_select against their plain versions at
  every shape the graph-cut paths launch (``CUT_CASES``: P = 1, 10 and 16,
  n = 1899 and 36692), each call one CUDA kernel (a torch.profiler count),
  with each one's time beside its bound, the plain version's time and, for
  the gains, ``library_ms``: one cuBLAS product of W with the same column
  vectors (``torch.mv`` / ``torch.mm``), which the port never calls.
  Greedy-like states: about 0.2 % of the nodes selected, a few
  infeasible."""
  import torch

  from repro_torch.data.graphs import chung_lu_graph, social_graph
  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(15)
  rows = {}
  graphs = {}
  for label, size, P, with_ind, dtype, on_paths in CUT_CASES:
    if size not in graphs:
      graphs.clear()
      torch.cuda.empty_cache()
      if size == "full":
        w32 = chung_lu_graph(sz.cut_n, sz.cut_edges, seed=0, device=DEVICE)
      else:
        w32 = torch.as_tensor(social_graph(sz.cut_paper_n, seed=0),
                              device=DEVICE)
      graphs[size] = {"f32": w32}
    if dtype not in graphs[size]:
      graphs[size][dtype] = graphs[size]["f32"].to(torch.bfloat16)
    w = graphs[size][dtype]
    n = w.shape[0]
    lead = () if P is None else (P,)
    x = (torch.rand(*lead, n, generator=g, device=DEVICE) < 0.002).float()
    ind = None
    if with_ind:
      part = torch.randint(0, P, (n,), generator=g, device=DEVICE)
      ind = (part == torch.arange(P, device=DEVICE)[:, None]).float()
      x = x * ind
    ok = (torch.rand(*lead, n, generator=g, device=DEVICE) < 0.98) & (x == 0)
    got = ops.graph_cut_gain(w, x, ind)
    best, idx = ops.graph_cut_select(w, x, ok, ind)
    want = ref.graph_cut_gain_ref(w, x, ind)
    wb, wi = ref.masked_top1(want, ok)
    sync()
    cols = ref.graph_cut_cols(x, ind)
    good, g_abs, g_rel = cut_tol_ok(got, want, w, cols)
    check(good, f"graph_cut_gain {label}: error {g_rel:.3f} of its "
          f"tolerance")
    same = idx == wi
    picked = want.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    gap = (wb - picked).abs() / wb.abs().clamp_min(1e-30)
    okp = ok.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    tie = (~same) & (gap <= TOL_GAP) & okp
    check(bool((same | tie).all()), f"graph_cut_select {label}: index "
          f"differs beyond a near-tie")
    b_abs = float((best - wb).abs().max())
    per_call = {}
    for name, call in (
        ("graph_cut_gain", lambda: ops.graph_cut_gain(w, x, ind)),
        ("graph_cut_select", lambda: ops.graph_cut_select(w, x, ok, ind))):
      per_call[name] = kernels_per_call(call)
      check(all(c == 1 for c in per_call[name][0]), f"{name} {label}: "
            f"{per_call[name][0]} kernel launches a call in the profiled "
            f"windows ({per_call[name][2]}), expected 1 in each")
    # 20 launches a timing: a paper-size call is tens of microseconds
    k_ms = time_ms(lambda: ops.graph_cut_gain(w, x, ind), reps=20)
    s_ms = time_ms(lambda: ops.graph_cut_select(w, x, ok, ind), reps=20)
    p_ms = time_ms(lambda: ref.graph_cut_gain_ref(w, x, ind), reps=5)
    ps_ms = time_ms(lambda: ref.graph_cut_select_ref(w, x, ok, ind), reps=5)
    lib_ms = None
    if dtype == "f32":  # a bf16 product would return bf16
      if P is None:
        lib_ms = time_ms(lambda: torch.mv(w, cols), reps=20)
      else:
        lib_ms = time_ms(lambda: torch.mm(cols, w.T), reps=20)
    esz = w.element_size()
    n_p = 1 if P is None else P
    vec_bytes = n_p * n * 4 * (2 if with_ind else 1)   # x (and ind)
    flops = 2.0 * n * n * n_p
    gb = bound_ms(n * n * esz + vec_bytes + n_p * n * 4, flops, dtype)
    sb = bound_ms(n * n * esz + vec_bytes + n_p * n + n_p * 8, flops, dtype)
    common = dict(shape=[P, n], ind=with_ind, dtype=dtype, on_paths=on_paths)
    rows[("graph_cut_gain", label)] = dict(
        common, max_abs_err=g_abs, err_over_tol=g_rel, kernel_ms=k_ms,
        plain_ms=p_ms, library_ms=lib_ms, bound_ms=gb[0], bound_by=gb[1])
    rows[("graph_cut_select", label)] = dict(
        common, max_abs_err=b_abs, idx_equal=int(same.sum()),
        near_ties=int(tie.sum()), kernel_ms=s_ms, plain_ms=ps_ms,
        library_ms=None, bound_ms=sb[0], bound_by=sb[1])
    for name in ("graph_cut_gain", "graph_cut_select"):
      r_ = rows[(name, label)]
      r_["cuda_kernels_per_call"] = per_call[name][0]
      r_["device_records_per_call"] = per_call[name][1]
      r_["kernel_names"] = per_call[name][2]
      r_["launches"] = {p: c.get(name, 0) for p, c in
                        ((p, path_counts.get(p, {})) for p in on_paths)}
      emit(f"kernel {name} {label}", **r_)
    del x, ok, got, want, cols
  graphs.clear()
  torch.cuda.empty_cache()
  return rows


def profile_cut(sz):
  """Where the full-size GreeDi graph-cut path's time goes: device time by
  kernel name and the busy share, as ``profile_phase`` reports them."""
  import torch

  from repro_torch.core import greedi as GD
  from repro_torch.data.graphs import chung_lu_graph
  w = chung_lu_graph(sz.cut_n, sz.cut_edges, seed=0, device=DEVICE)
  obj, init_local, _ = cut_objective(w)
  eye = torch.eye(sz.cut_n, device=DEVICE)
  profiled("profile cut greedi", lambda: GD.greedi_reference(
      torch.Generator(device=DEVICE).manual_seed(0), eye, m=sz.cut_m,
      kappa=sz.cut_k, k_final=sz.cut_k, objective=obj, init_for=init_local,
      local_eval=True, mode="random", stop_nonpositive=True))


# ---------------------------------------------------------------------------
# the LM serving path: qwen3-4b at full width through generate, with the
# flash-attention kernel in every prefill layer
# ---------------------------------------------------------------------------


def flash_bound(b, h, hkv, length, dh, causal, dtype):
  """(bound_ms, bound_by, flops) of one attention call: 4 B H dh
  live_pairs operations (the pairs under the mask, not the tiles visited)
  against q, k, v and o moved once, at the peak rate of the input type
  (bf16 tensor cores, or FP32 FFMA, which the float32 kernel uses)."""
  pairs = length * (length + 1) // 2 if causal else length * length
  flops = 4.0 * b * h * dh * pairs
  esz = 2 if dtype == "bf16" else 4
  moved = (2 * b * h + 2 * b * hkv) * length * dh * esz
  t, by = bound_ms(moved, flops, dtype)
  return t, by, flops


def sdpa_operands(q, k, v):
  """The library yardstick's operands (PyTorch's fused attention, never
  called by the port): (k, v, keyword arguments, description), with
  enable_gqa where the installed torch has it (2.5 on), else K/V repeated
  to the query heads here, outside the timed call."""
  import torch
  if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
    return (k, v, {"is_causal": True, "enable_gqa": True},
            "scaled_dot_product_attention(is_causal=True, enable_gqa=True)")
  group = q.shape[1] // k.shape[1]
  return (k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
          {"is_causal": True}, "scaled_dot_product_attention(is_causal="
          "True) on K/V repeated beforehand (this torch has no enable_gqa)")


def qkv_on_card(g, b, h, hkv, length, dh, dtype, strided=False):
  """Random q (B, H, L, dh) and k, v (B, Hkv, L, dh) on the card; with
  ``strided`` each is the (B, L, heads, dh) layout transposed, as the
  model's projections hand them over (the kernel takes strides)."""
  import torch

  def one(heads):
    if strided:
      x = torch.randn(b, length, heads, dh, generator=g, device=DEVICE)
      return x.to(dtype).transpose(1, 2)
    return torch.randn(b, heads, length, dh, generator=g,
                       device=DEVICE).to(dtype)
  return one(h), one(hkv), one(hkv)


def flash_edge_phase():
  """The flash-attention kernels against ``mha_ref`` at the edges: L in
  {1, 63, 127, 200, 2049} (one row, ragged, below a tile, one past one),
  dh in {32, 64, 128}, group 1 (MHA), 4 and 8 (GQA), f32 (the FFMA kernel)
  and bf16 (the tensor-core kernel: every bf16 case must launch it), causal
  and not; transposed (strided) inputs, a non-default scale, B H past the
  65535 rows of a grid in both dtypes; two launches on the same bf16 inputs
  giving identical bytes; the cuda backend refusing CPU tensors, an
  unsupported dh and a bf16 stride aligned to 4 but not 8 elements (the
  tensor maps need 16 bytes) raising.  Tolerance 1e-4 in f32, 3e-2 in bf16
  (rtol and atol, tests/test_kernels.py)."""
  import torch

  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(16)
  worst = {"f32": 0.0, "bf16": 0.0}
  n = 0
  cases = [(1, 2 * grp, 2, length, dh, dt, causal, length == 200, None)
           for length in (1, 63, 127, 200, 2049) for dh in (32, 64, 128)
           for grp in (1, 4, 8) for dt in ("f32", "bf16")
           for causal in (True, False)]
  cases += [(2, 8, 2, 200, 64, "f32", True, False, 0.3),
            (2, 8, 2, 200, 64, "bf16", False, True, 0.3),
            (257, 256, 32, 9, 32, "f32", True, False, None),   # B H = 65792
            (257, 256, 32, 9, 32, "bf16", True, False, None)]
  ops.reset_launch_counts()
  for b, h, hkv, length, dh, dt, causal, strided, scale in cases:
    td = torch.float32 if dt == "f32" else torch.bfloat16
    q, k, v = qkv_on_card(g, b, h, hkv, length, dh, td, strided)
    got = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    want = ref.mha_ref(q, k, v, causal=causal, scale=scale)
    sync()
    tol = 1e-4 if dt == "f32" else 3e-2
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    check(got.dtype == td and got.shape == q.shape and not bool(bad.any()),
          f"flash_attention edge B={b} H={h} Hkv={hkv} L={length} dh={dh} "
          f"{dt} causal={causal} strided={strided} scale={scale}: max "
          f"error {float(err.max())}")
    worst[dt] = max(worst[dt], float(err.max()))
    n += 1
  n_bf16 = sum(c[5] == "bf16" for c in cases)
  check(fa.tc_launches == n_bf16 and fa.launches == n,
        f"flash edge: {fa.tc_launches} tensor-core launches of {fa.launches}"
        f", expected {n_bf16} of {n}")
  q, k, v = qkv_on_card(g, 2, 8, 2, 300, 128, torch.bfloat16, True)
  first = ops.flash_attention(q, k, v)
  again = ops.flash_attention(q, k, v)
  sync()
  check(torch.equal(first.view(torch.int16), again.view(torch.int16)),
        "flash_attention bf16: two launches on the same inputs differ")
  q, k, v = qkv_on_card(g, 1, 4, 2, 16, 32, torch.float32)
  # bf16 rows of 36 elements: strides multiples of 4, not of 8
  wide = torch.zeros(1, 4, 16, 36, dtype=torch.bfloat16, device=DEVICE)
  raised = []
  for what, call in (
      ("cpu tensors", lambda: ops.flash_attention(
          q.cpu(), k.cpu(), v.cpu(), backend="cuda")),
      ("dh 48", lambda: ops.flash_attention(q[..., :24].repeat(1, 1, 1, 2),
                                            k[..., :24].repeat(1, 1, 1, 2),
                                            v[..., :24].repeat(1, 1, 1, 2))),
      ("bf16 stride of 36 elements", lambda: ops.flash_attention(
          wide[..., :32], wide[:, :2, :, :32], wide[:, :2, :, :32]))):
    try:
      call()
    except ValueError as e:
      raised.append(f"{what}: {e}")
    else:
      raise SmokeFailure(f"flash_attention accepted {what}")
  emit("flash edge", cases=n, bf16_cases_on_tensor_cores=n_bf16,
       lengths=[1, 63, 127, 200, 2049], head_dims=[32, 64, 128],
       groups=[1, 4, 8], max_abs_err=worst,
       tol={"f32": 1e-4, "bf16": 3e-2}, repeat="identical bytes",
       raised=raised, result="pass")


FLASH_CASES = (   # label, its e2e path, (B, H, Hkv, L, dh), dtype; causal
    ("serve", "serve", (8, 32, 8, 2048, 128), "bf16"),    # set 1's prefill
    ("long", "serve_long", (1, 32, 8, 6000, 128), "bf16"),  # set 2's
    ("serve f32", None, (8, 32, 8, 2048, 128), "f32"),    # FFMA either way
    ("train eval", "train_eval", (8, 32, 8, 256, 128), "bf16"),  # e2e train
    # a rank's local heads in e2e train dist's 1x4 eval step
    ("train dist eval", "train_dist_eval_1x4", (8, 8, 2, 256, 128), "bf16"),
    # e2e families' prefills: deepseek-moe-16b (MHA), grok-1-314b (48 / 8
    # heads), llama-3.2-vision-90b (64 / 8: its self and cross blocks'
    # self-attention) and whisper's decoder (dh 64)
    ("family moe", "family_deepseek-moe-16b", (4, 16, 16, 2048, 128),
     "bf16"),
    ("family grok", "family_grok-1-314b", (4, 48, 8, 2048, 128), "bf16"),
    ("family vlm", "family_llama-3.2-vision-90b", (2, 64, 8, 2048, 128),
     "bf16"),
    ("family whisper", "family_whisper-tiny", (8, 6, 6, 432, 64), "bf16"),
    # e2e families tp's prefills at a rank's heads: deepseek-moe-16b and
    # grok-1-314b (ep) and the VLM over 1x4, whisper's decoder over 2x2
    # (half the rows a data replica)
    ("family tp moe", "families_tp_deepseek-moe-16b_tp",
     (2, 4, 4, 512, 128), "bf16"),
    ("family tp grok", "families_tp_grok-1-314b_ep", (2, 12, 2, 1024, 128),
     "bf16"),
    ("family tp vlm", "families_tp_llama-3.2-vision-90b_tp",
     (1, 16, 2, 1024, 128), "bf16"),
    ("family tp whisper", "families_tp_whisper-tiny_tp", (4, 3, 3, 432, 64),
     "bf16"),
)


def flash_kernel_phase(path_counts: dict):
  """The kernels at the serving shapes of set 1 and set 2 (bf16, causal, v
  the projections' transposed view: the tensor-core kernel), and at set 1's
  in float32 (the FFMA kernel): time beside the plain version's, SDPA's
  (``library_ms``) and ``bound_ms`` (bf16 tensor cores, or FP32 FFMA),
  with the achieved TFLOP/s and the share of the bound, and the error
  against the plain version (3e-2 in bf16, 1e-4 in f32, rtol and atol)."""
  import torch

  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops, ref
  g = torch.Generator(device=DEVICE).manual_seed(17)
  rows = {}
  for label, path, (b, h, hkv, length, dh), dtype in FLASH_CASES:
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = 3e-2 if dtype == "bf16" else 1e-4
    q, k, _ = qkv_on_card(g, b, h, hkv, length, dh, td)
    _, _, v = qkv_on_card(g, b, h, hkv, length, dh, td, True)
    tc0 = fa.tc_launches
    got = ops.flash_attention(q, k, v)
    check(fa.tc_launches - tc0 == (dtype == "bf16"),
          f"flash_attention {label}: {dtype} did not take its kernel")
    want = ref.mha_ref(q, k, v)
    sync()
    err = float((got.float() - want.float()).abs().max())
    bad = (got.float() - want.float()).abs() > tol * (
        1 + want.float().abs())
    check(not bool(bad.any()), f"flash_attention {label}: error {err}")
    del got, want
    k_ms = time_ms(lambda: ops.flash_attention(q, k, v), reps=10)
    p_ms = time_ms(lambda: ref.mha_ref(q, k, v), reps=1)
    lk, lv, kw, lib_call = sdpa_operands(q, k, v)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, lk, lv, **kw), reps=10)
    del lk, lv
    bnd, by, flops = flash_bound(b, h, hkv, length, dh, True, dtype)
    rows[("flash_attention", label)] = dict(
        shape=[b, h, hkv, length, dh], dtype=dtype, causal=True,
        kernel="flash_fwd_tc (wgmma, TMA)" if dtype == "bf16"
        else "flash_fwd (FP32 FFMA)",
        source=SOURCES["flash_attention"] if dtype == "bf16"
        else "src/repro_torch/kernels/csrc/flash_attention.cu",
        max_abs_err=err, tol=tol, kernel_ms=k_ms, plain_ms=p_ms,
        library_ms=lib_ms, library_call=lib_call, bound_ms=bnd, bound_by=by,
        tflops=flops / k_ms / 1e9, bound_share=bnd / k_ms,
        over_library=k_ms / lib_ms, on_paths=[path] if path else [],
        launches={path: path_counts.get(path, {}).get("flash_attention", 0)}
        if path else {})
    emit(f"kernel flash_attention {label}", **rows[("flash_attention",
                                                     label)])
    del q, k, v
    torch.cuda.empty_cache()
  return rows


def serve_models(sz):
  """qwen3-4b at full width: the float32 model, its weights drawn once
  from a seeded generator on the card, and a bfloat16 copy of the same
  weights (norm gains stay float32, as in the reference)."""
  import dataclasses as dc

  import torch

  from repro_torch.configs import get_config
  from repro_torch.models import Model
  cfg = get_config(sz.serve_arch)
  g = torch.Generator(device=DEVICE).manual_seed(sz.serve_seed)
  m32 = Model(dc.replace(cfg, dtype="float32"), device=DEVICE, generator=g)
  m16 = Model(cfg, device=DEVICE,
              generator=torch.Generator(device=DEVICE).manual_seed(0))
  with torch.no_grad():
    for (n16, p16), (n32, p32) in zip(m16.named_parameters(),
                                      m32.named_parameters()):
      check(n16 == n32 and p16.shape == p32.shape, f"{n16} vs {n32}")
      p16.copy_(p32)
  return m32, m16


def greedy_trace(model, batch, steps):
  """The greedy loop of ``generate`` through its own serve fns (the same
  cache length, so the same launches), keeping every step's logits
  (float32, on the card) beside the tokens."""
  import torch

  from repro_torch.serve import make_serve_fns
  tokens = batch["tokens"]
  b, s = tokens.shape
  prefill_fn, decode_fn = make_serve_fns(model)
  with torch.no_grad():
    memory = model.memory(batch)
  caches = model.init_cache(b, s + steps, memory=memory)
  logits, caches = prefill_fn(batch, caches, memory)
  toks, all_logits = [], []
  for t in range(steps):
    all_logits.append(logits.float())
    tok = torch.argmax(logits, dim=-1)
    toks.append(tok)
    if t + 1 < steps:
      logits, caches = decode_fn(tok[:, None], s + t, caches)
  return torch.stack(toks, 1), torch.stack(all_logits, 1)


def top2_gap(logits):
  top = logits.float().topk(2, dim=-1).values
  return top[..., 0] - top[..., 1]


class PinnedRouting:
  """The MoE routing of one run replayed in the next: in ``record`` every
  ``models.moe.route`` call keeps its experts; in ``replay`` each call
  takes the experts the recorded run chose at the same call (their gates
  from its own router probabilities, through ``moe.assign``), so two runs
  differ only by what else differs between them.  A bf16 model's routing
  is discontinuous: an ulp in a hidden state can swap a token's k-th
  expert for the (k+1)-th when their probabilities nearly tie, and 28
  MoE layers amplify that to other logits.  ``flips`` counts the replayed
  calls' tokens whose own choice of experts differed from the pinned one,
  out of ``routed``; ``margin`` is the largest router probability mass
  the pinned experts gave up against the free choice at a flip."""

  def __init__(self):
    self.calls, self.i = [], 0
    self.flips = self.routed = 0
    self.margin = 0.0

  @contextlib.contextmanager
  def record(self):
    from repro_torch.models import moe
    real = moe.route

    def rec(xg, valid, router, cfg):
      r = real(xg, valid, router, cfg)
      self.calls.append(r.top_e)
      return r

    moe.route = rec
    try:
      yield self
    finally:
      moe.route = real

  @contextlib.contextmanager
  def replay(self):
    import torch

    from repro_torch.models import moe
    real = moe.route

    def rep(xg, valid, router, cfg):
      free = real(xg, valid, router, cfg)
      check(self.i < len(self.calls), "pinned routing: more MoE calls "
            "than the recorded run made")
      top_e = self.calls[self.i]
      self.i += 1
      check(top_e.shape == free.top_e.shape, "pinned routing: a call of "
            "another shape")
      diff = (torch.sort(free.top_e, -1).values
              != torch.sort(top_e, -1).values).any(-1) & valid
      self.flips += int(diff.sum())
      self.routed += int(valid.sum())
      if bool(diff.any()):
        gave = (torch.gather(free.probs, -1, free.top_e).sum(-1)
                - torch.gather(free.probs, -1, top_e).sum(-1))
        self.margin = max(self.margin, float(gave[diff].max()))
      return moe.assign(free.probs, top_e, valid, cfg)

    moe.route = rep
    try:
      yield self
    finally:
      moe.route = real


class LayerAttention:
  """Every ``ops.flash_attention`` call of a run held against ``mha_ref``
  on the call's own inputs (the model's activations at that layer): the
  largest error over the plain output's scale, checked against the
  kernel phases' tolerance (3e-2 in bf16, 1e-4 in f32, rtol and atol)."""

  def __init__(self):
    self.calls, self.worst = 0, 0.0

  @contextlib.contextmanager
  def watch(self):
    from repro_torch.kernels import ops, ref
    real = ops.flash_attention

    def held(q, k, v, **kw):
      out = real(q, k, v, **kw)
      want = ref.mha_ref(q, k, v, causal=kw.get("causal", True),
                         scale=kw.get("scale"))
      tol = 3e-2 if q.dtype.itemsize == 2 else 1e-4
      err = (out.float() - want.float()).abs()
      check(not bool((err > tol * (1 + want.float().abs())).any()),
            f"flash_attention at a model layer {tuple(q.shape)}: error "
            f"{float(err.max())}")
      self.calls += 1
      self.worst = max(self.worst, float(err.max()) /
                       max(float(want.float().abs().max()), 1e-30))
      return out

    ops.flash_attention = held
    try:
      yield self
    finally:
      ops.flash_attention = real


def route_agreement(model, batch, steps, label, pin=None, logits=True):
  """The greedy loop with the kernel (``backend="auto"``) and with the
  plain version (``"ref"``) on the same weights, through ``generate``'s
  own serve fns (``greedy_trace``): logits within ``TOL_SERVE_BF16`` of
  their scale at every step whose token history the two runs share, and
  every row's greedy tokens equal up to the first step whose top-2 gap in
  the plain run is below ``TOL_SERVE_GAP`` (a bf16 near-tie; the rule of
  ROADMAP.md section 3), valid after it.  Each kernel launch of the
  kernel run is also held against the plain version on its own inputs
  (``LayerAttention``).  With ``pin`` (a ``PinnedRouting``) the plain run
  replays the kernel run's MoE routing.  ``logits=False`` records the
  logits' error without holding it to the tolerance (a model whose depth
  amplifies bf16 rounding past it; its caller holds the same comparison in
  float32).  Returns (fields, the kernel run's tokens and logits)."""
  import torch
  model.backend = "auto"
  layers = LayerAttention()
  with pin.record() if pin else contextlib.nullcontext(), layers.watch():
    k_toks, k_logits = greedy_trace(model, batch, steps)
  model.backend = "ref"
  with pin.replay() if pin else contextlib.nullcontext():
    r_toks, r_logits = greedy_trace(model, batch, steps)
  model.backend = "auto"
  sync()
  bsz = k_toks.shape[0]
  r_scale = float(r_logits[:, 0].abs().max())
  same = k_toks == r_toks
  history = torch.cat([torch.ones_like(same[:, :1]),
                       same[:, :-1].int().cumprod(1).bool()], dim=1)
  diff = (k_logits - r_logits).abs().amax(-1)        # (bsz, steps)
  shared_err = float(diff[history].max())
  check(bool(torch.isfinite(k_logits).all()) and (not logits or (
        shared_err <= TOL_SERVE_BF16 * r_scale and
        shared_err <= TOL_SERVE_GAP / 2)), f"{label}: logits kernel vs "
        f"plain {shared_err} at scale {r_scale} over shared histories")
  gaps = top2_gap(r_logits)                          # (bsz, steps)
  near = gaps < TOL_SERVE_GAP
  first_tie = torch.where(near.any(1), near.float().argmax(1),
                          torch.full((bsz,), steps, device=DEVICE))
  upto = torch.arange(steps, device=DEVICE)[None, :] < first_tie[:, None]
  check(bool((same | ~upto).all()), f"{label}: greedy tokens differ "
        "before the first near-tie")
  fields = dict(prefill_max_abs_err=float(diff[:, 0].max()),
                logit_scale=r_scale,
                shared_history_steps=int(history.sum()),
                shared_history_max_abs_err=shared_err,
                steps_before_near_tie=first_tie.tolist(),
                tokens_equal=int(same.sum()), tokens_total=same.numel(),
                logits_held=logits, layer_attention_calls=layers.calls,
                layer_attention_max_err_over_scale=layers.worst)
  if pin:
    check(pin.i == len(pin.calls), f"{label}: the plain run made {pin.i} "
          f"MoE calls, the kernel run {len(pin.calls)}")
    fields.update(pinned_moe_calls=pin.i, routing_flips=pin.flips,
                  routed_tokens=pin.routed, flip_margin_max=pin.margin)
  del r_logits
  return fields, k_toks, k_logits


def e2e_serve(sz):
  """The serving path at full width (qwen3-4b: 36 layers, d 2560, 32 / 8
  heads, d_ff 9728, vocab 151936), through ``generate``:

  (a) f32 agreement: the float32 model's prefill (batch 2 x 2048) with the
      kernel and with the plain version, last-token logits within
      ``TOL_SERVE_F32`` of their scale;
  (b) bf16 serving of set 1 (batch 8 x 2048 -> 64 tokens) and set 2 (batch
      1 x 6000 -> 16 tokens), greedy: time to first token (``generate``
      with one step), decode ms a token, tokens/s, peak memory, and the
      flash launches counted around the timed run (36 a prefill, every one
      of the tensor-core kernel, by its own counter);
  (c) the same sets with ``backend="ref"``, through ``generate``'s own
      serve fns (``greedy_trace``, which must reproduce the kernel run's
      tokens exactly): logits within ``TOL_SERVE_BF16`` of their scale at
      every step whose token history the two runs share, and every row's
      greedy tokens equal to the kernel run's up to the first step whose
      top-2 gap in the plain run is below ``TOL_SERVE_GAP`` (a bf16
      near-tie; the rule of ROADMAP.md section 3), valid after it;
  (d) decode logits against a teacher-forcing ``apply_train`` at the same
      positions (the first ``serve_tf_steps`` decode steps of set 1),
      within ``TOL_SERVE_BF16`` of their scale.
  Returns the launch counts by path."""
  import torch

  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.serve import generate
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  m32, m16 = serve_models(sz)
  sync()
  init_s = time.perf_counter() - t0
  cfg = m16.cfg
  n_layers = cfg.n_layers
  g = torch.Generator(device=DEVICE).manual_seed(sz.serve_seed + 1)
  counts = {}

  # (a) float32: kernel against the plain version
  toks = torch.randint(0, cfg.vocab, (sz.serve_f32_batch,
                                      sz.serve_f32_prompt), generator=g,
                       device=DEVICE)
  last = {}
  for backend in ("auto", "ref"):
    m32.backend = backend
    ops.reset_launch_counts()
    last[backend], _ = m32.prefill({"tokens": toks}, m32.init_cache(
        *toks.shape))
    sync()
    launched = ops.launch_counts()["flash_attention"]
    check(launched == (n_layers if backend == "auto" else 0) and
          fa.tc_launches == 0, f"f32 prefill backend {backend}: {launched} "
          f"flash launches, {fa.tc_launches} of the bf16 kernel")
  scale = float(last["ref"].abs().max())
  f32_err = float((last["auto"] - last["ref"]).abs().max())
  check(torch.isfinite(last["auto"]).all() and
        f32_err <= TOL_SERVE_F32 * scale,
        f"f32 prefill: kernel vs plain {f32_err} at logit scale {scale}")
  emit("e2e serve f32", arch=cfg.name, batch=sz.serve_f32_batch,
       prompt=sz.serve_f32_prompt, init_s=init_s,
       params=sum(p.numel() for p in m16.parameters()),
       max_abs_err=f32_err, logit_scale=scale, err_over_scale=f32_err / scale,
       tol=TOL_SERVE_F32)
  del m32, last
  torch.cuda.empty_cache()

  # (b) - (d) bfloat16
  sets = {}
  for name, (bsz, plen, steps) in zip(("set1", "set2"), sz.serve_sets):
    prompt = torch.randint(0, cfg.vocab, (bsz, plen), generator=g,
                           device=DEVICE)
    batch = {"tokens": prompt}
    path = "serve" if name == "set1" else "serve_long"
    m16.backend = "auto"
    generate(m16, batch, steps=1)                 # warm-up (cuBLAS plans)
    sync()
    t0 = time.perf_counter()
    first = generate(m16, batch, steps=1)
    sync()
    ttft = time.perf_counter() - t0
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    out = generate(m16, batch, steps=steps)
    sync()
    wall = time.perf_counter() - t0
    counts[path] = ops.launch_counts()
    tc = fa.tc_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(counts[path]["flash_attention"] == n_layers and tc == n_layers,
          f"{name}: {counts[path]['flash_attention']} flash launches in one "
          f"generate, {tc} of the tensor-core kernel, expected {n_layers} "
          "(one a prefill layer)")
    check(out.shape == (bsz, steps) and int(out.min()) >= 0 and
          int(out.max()) < cfg.vocab and torch.equal(out[:, :1], first),
          f"{name}: bad tokens")
    # (c) the plain version through the same serve fns
    agree, k_toks, k_logits = route_agreement(m16, batch, steps, name)
    check(torch.equal(k_toks, out), f"{name}: generate and its serve fns "
          "disagree on the kernel path")
    sets[name] = dict(
        batch=bsz, prompt=plen, new_tokens=steps, ttft_s=ttft,
        decode_ms_per_token=(wall - ttft) / (steps - 1) * 1e3,
        tokens_per_s=bsz * steps / wall, wall_s=wall, peak_gib=peak,
        flash_launches=counts[path]["flash_attention"],
        tensor_core_flash_launches=tc, **agree)
    if name == "set1":
      # (d) teacher forcing over the prompt and the first decoded tokens
      tf = sz.serve_tf_steps
      full = torch.cat([prompt, k_toks[:, :tf]], dim=1)
      with torch.no_grad():   # the forward alone: attention on the kernel
        train = m16.apply_train({"tokens": full})[0][:, plen - 1:]
      tf_err = float((train.float() - k_logits[:, :tf + 1]).abs().max())
      tf_scale = float(train.float().abs().max())
      check(tf_err <= TOL_SERVE_BF16 * tf_scale, f"teacher forcing: decode "
            f"logits {tf_err} from apply_train at scale {tf_scale}")
      sets[name].update(teacher_forcing_max_abs_err=tf_err,
                        teacher_forcing_positions=train.shape[1])
      del train, full
    del k_logits
    torch.cuda.empty_cache()
  emit("e2e serve", arch=cfg.name, dtype="bf16", sets=sets,
       tol=dict(bf16=TOL_SERVE_BF16, gap=TOL_SERVE_GAP))
  del m16
  torch.cuda.empty_cache()
  return counts


# the other model families through the serving path: (arch, layers kept or
# None for the config's depth, (batch, prompt, new tokens)), bf16 random
# weights from a seed; the flash launches a prefill makes (every causal,
# unwindowed attention layer: MoE and VLM layers, whisper's decoder)
FAMILY_RUNS = (
    ("deepseek-moe-16b", None, (4, 2048, 16)),
    ("grok-1-314b", 2, (4, 2048, 16)),
    ("mamba2-2.7b", None, (8, 2048, 16)),
    ("recurrentgemma-2b", None, (1, 4096, 16)),   # past the 2048 window
    ("llama-3.2-vision-90b", 10, (2, 2048, 16)),  # two periods of 5
    ("whisper-tiny", None, (8, 432, 16)),         # 448: whisper's limit
)
FAMILY_REF = (2, 512, 8)   # the kernel-vs-plain greedy check's requests
# archs whose bf16 logits the depth takes past TOL_SERVE_BF16 whatever the
# attention route: 28 MoE layers with the reference's expert scale (E^-0.5
# at fan-in d) amplify bf16 rounding (measured: the kernel against the
# plain route 0.547 at a logit scale of 4.59 with the routing pinned; 2
# layers of grok-1 stay at 1 %).  Their bf16 routes are each held against
# one float32 reference of the same weights (``family_f32_agreement``):
# the kernel route may be no further from it than TOL_F32_RATIO times the
# plain route; the bf16 run's kernel-vs-plain error is recorded, its tokens
# still held by the near-tie rule.
FAMILY_F32 = ("deepseek-moe-16b",)
TOL_F32_RATIO = 1.5
FAMILY_TF = (2, 32, 4)     # decode vs teacher forcing at the reduced size
TOL_FAMILY_TF = 2e-3       # tests/test_models.py's tolerance


def family_inputs(cfg, g, bsz, plen):
  """Prompt tokens (B, plen) and the family's memory input on the card:
  whisper's frames (B, n_frames, d) or the VLM's image embeddings (B,
  n_img_tokens, d), N(0, 1)."""
  import torch
  batch = {"tokens": torch.randint(0, cfg.vocab, (bsz, plen), generator=g,
                                   device=DEVICE)}
  if cfg.family == "encdec":
    batch["frames"] = torch.randn(bsz, cfg.encoder.n_frames, cfg.d_model,
                                  generator=g, device=DEVICE)
  if cfg.family == "vlm":
    batch["img_embeds"] = torch.randn(bsz, cfg.n_img_tokens, cfg.d_model,
                                      generator=g, device=DEVICE)
  return batch


def flash_layers(cfg) -> int:
  """Flash launches a prefill makes: one a causal, unwindowed attention
  layer (an "attn" or "cross" block's self-attention)."""
  if cfg.sliding_window:
    return 0
  return sum(bt in ("attn", "cross") for bt in cfg.full_pattern)


def family_teacher_forcing(arch, seed):
  """The reduced config in float32 on the card: prefill + decode logits
  against a teacher-forcing ``apply_train`` (no_grad: the kernel route)
  position by position, within ``TOL_FAMILY_TF`` (rtol, and atol times the
  largest |want|).  Returns the largest error over the scale."""
  import torch

  from repro_torch.configs import get_config, reduced
  from repro_torch.models import Model
  cfg = reduced(get_config(arch))
  model = Model(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
  bsz, plen, steps = FAMILY_TF
  g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
  batch = family_inputs(cfg, g, bsz, plen + steps)
  prompt = dict(batch, tokens=batch["tokens"][:, :plen])
  with torch.no_grad():
    train, _ = model.apply_train(batch)
    memory = model.memory(prompt)
  caches = model.init_cache(bsz, plen + steps, memory=memory)
  got, caches = model.prefill(prompt, caches, memory)
  worst = 0.0
  for t in range(plen - 1, plen + steps):
    if t >= plen:
      got, caches = model.decode_step(batch["tokens"][:, t:t + 1], t, caches)
    want = train[:, t]
    err = (got - want).abs()
    scale = float(want.abs().max())
    check(bool((err <= TOL_FAMILY_TF * (want.abs() + scale)).all()),
          f"{arch} reduced: decode vs teacher forcing at {t}: "
          f"{float(err.max())} at scale {scale}")
    worst = max(worst, float(err.max()) / scale)
  del model
  return worst


def family_bf16_prefills(model, batch):
  """The bf16 model's prefill of ``batch`` with the kernel (its MoE
  routing recorded) and with the plain version (the routing replayed):
  the last-token logits in float32, the recorded routing, and each leaf's
  dtype and float64 sum (``family_f32_agreement`` holds its float32 model
  to the same weights by them)."""
  import torch
  pin = PinnedRouting()
  logits = {}
  for backend, ctx in (("auto", pin.record), ("ref", pin.replay)):
    model.backend = backend
    memory = model.memory(batch)
    with ctx():
      last, _ = model.prefill(batch, model.init_cache(
          *batch["tokens"].shape, memory=memory), memory)
    logits[backend] = last.float()
  model.backend = "auto"
  check(pin.i == len(pin.calls), f"{model.cfg.name} bf16 prefill: the "
        f"plain run made {pin.i} MoE calls, the kernel run {len(pin.calls)}")
  with torch.no_grad():
    leaves = {n: (p.dtype, float(p.double().sum()))
              for n, p in model.named_parameters()}
  return dict(logits=logits, calls=pin.calls, leaves=leaves)


def family_f32_agreement(cfg, seed, batch, bf16):
  """The float32 model of ``cfg`` holding the bf16 model's weights (drawn
  from its seed, each bf16 leaf rounded as the bf16 model rounds it; every
  leaf's float64 sum equal to the bf16 model's): the prefill of ``batch``
  with the FFMA flash kernel and with the plain version, both replaying the
  bf16 kernel run's MoE routing.  Held: the float32 kernel against the
  plain version within ``TOL_SERVE_F32`` of the scale, each of its
  launches against the plain version on its own inputs
  (``LayerAttention``, 1e-4), and the bf16 kernel route no further from
  the float32 plain logits than ``TOL_F32_RATIO`` times the bf16 plain
  route (``family_bf16_prefills``)."""
  import dataclasses as dc

  import torch

  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.models import Model
  cfg32 = dc.replace(cfg, dtype="float32")
  torch.cuda.reset_peak_memory_stats()
  model = Model(cfg32, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
  with torch.no_grad():
    for n, p in model.named_parameters():
      dtype, total = bf16["leaves"][n]
      if dtype != p.dtype:
        p.copy_(p.to(dtype))
      check(float(p.double().sum()) == total, f"{cfg.name}: the float32 "
            f"model's {n} does not hold the bf16 model's values")
  rb, rp = batch["tokens"].shape
  last, flips, routed = {}, 0, 0
  layers = LayerAttention()
  for backend in ("auto", "ref"):
    pin = PinnedRouting()
    pin.calls = list(bf16["calls"])
    model.backend = backend
    ops.reset_launch_counts()
    tc0 = fa.tc_launches
    memory = model.memory(batch)
    with pin.replay(), (layers.watch() if backend == "auto"
                        else contextlib.nullcontext()):
      last[backend], _ = model.prefill(batch, model.init_cache(
          rb, rp, memory=memory), memory)
    sync()
    launched = ops.launch_counts()["flash_attention"]
    check(launched == (flash_layers(cfg32) if backend == "auto" else 0)
          and fa.tc_launches == tc0, f"{cfg.name} f32: {launched} flash "
          f"launches, {fa.tc_launches - tc0} of the bf16 kernel")
    check(pin.i == len(pin.calls), f"{cfg.name} f32: {pin.i} MoE calls, "
          f"the bf16 prefill made {len(pin.calls)}")
    flips, routed = flips + pin.flips, routed + pin.routed
  scale = float(last["ref"].abs().max())
  err = float((last["auto"] - last["ref"]).abs().max())
  check(bool(torch.isfinite(last["auto"]).all()) and
        err <= TOL_SERVE_F32 * scale, f"{cfg.name} f32 prefill: kernel vs "
        f"plain {err} at logit scale {scale}")
  kern = float((bf16["logits"]["auto"] - last["ref"]).abs().max())
  plain = float((bf16["logits"]["ref"] - last["ref"]).abs().max())
  check(kern <= TOL_F32_RATIO * plain, f"{cfg.name}: the bf16 kernel route "
        f"is {kern} from the float32 logits, the plain route {plain}")
  out = dict(batch=rb, prompt=rp, max_abs_err=err, logit_scale=scale,
             err_over_scale=err / scale, tol=TOL_SERVE_F32,
             layer_attention_calls=layers.calls,
             layer_attention_max_err_over_scale=layers.worst,
             bf16_kernel_vs_f32=kern, bf16_plain_vs_f32=plain,
             bf16_kernel_over_plain=kern / max(plain, 1e-30),
             ratio_tol=TOL_F32_RATIO,
             bf16_kernel_vs_plain=float((bf16["logits"]["auto"]
                                         - bf16["logits"]["ref"]).abs().max()),
             routing_flips=flips, routed_tokens=routed,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  del model
  return out


def e2e_families(sz):
  """The other model families through ``generate`` (``FAMILY_RUNS``), one
  architecture at a time: bf16 random weights from a seed (freed before
  the next), the memory built from frames or image embeddings where the
  family has one.  For each: the kernel-vs-plain greedy check
  (``route_agreement`` at ``FAMILY_REF``'s requests), the time to first
  token (``generate`` with one step),
  ms a further token, tokens/s and peak memory of the full requests, the
  flash launches of that run (``flash_layers``: one a causal, unwindowed
  attention layer, every one on the tensor-core kernel), and decode
  against teacher forcing at the reduced size in float32
  (``family_teacher_forcing``).  In the greedy check every kernel launch
  is also held against the plain version on its own inputs, and the MoE
  families' plain run replays the kernel run's routing
  (``PinnedRouting``); ``FAMILY_F32``'s archs hold both bf16 routes'
  logits against one float32 reference (``family_f32_agreement``).  The
  timed runs follow an untimed one-token ``generate`` at their own size.
  Returns the launch counts by path."""
  import dataclasses as dc

  import torch

  from repro_torch.configs import get_config
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.models import Model
  from repro_torch.serve import generate
  counts = {}
  for i, (arch, layers, (bsz, plen, steps)) in enumerate(FAMILY_RUNS):
    full = get_config(arch)
    cfg = full if layers is None else dc.replace(full, n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(sz.serve_seed + i))
    sync()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=DEVICE).manual_seed(sz.serve_seed + 100 + i)
    rb, rp, rs = FAMILY_REF
    ref_batch = family_inputs(cfg, g, min(rb, bsz), min(rp, plen))
    agree, _, _ = route_agreement(
        model, ref_batch, rs, arch,
        pin=PinnedRouting() if cfg.moe.num_experts else None,
        logits=arch not in FAMILY_F32)
    bf16 = (family_bf16_prefills(model, ref_batch) if arch in FAMILY_F32
            else None)
    batch = family_inputs(cfg, g, bsz, plen)
    generate(model, batch, steps=1)   # warm-up: allocator, cuBLAS plans
    sync()
    t0 = time.perf_counter()
    first = generate(model, batch, steps=1)
    sync()
    ttft = time.perf_counter() - t0
    path = f"family_{arch}"
    ops.reset_launch_counts()
    tc0 = fa.tc_launches
    sync()
    t0 = time.perf_counter()
    out = generate(model, batch, steps=steps)
    sync()
    wall = time.perf_counter() - t0
    counts[path] = ops.launch_counts()
    tc = fa.tc_launches - tc0
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = flash_layers(cfg)
    check(counts[path]["flash_attention"] == want and tc == want,
          f"{arch}: {counts[path]['flash_attention']} flash launches in one "
          f"generate, {tc} of the tensor-core kernel, expected {want}")
    check(out.shape == (bsz, steps) and int(out.min()) >= 0 and
          int(out.max()) < cfg.vocab and torch.equal(out[:, :1], first),
          f"{arch}: bad tokens")
    check(peak < 80, f"{arch}: peak {peak} GiB")
    del model, batch
    torch.cuda.empty_cache()
    if arch in FAMILY_F32:
      agree["float32"] = family_f32_agreement(cfg, sz.serve_seed + i,
                                              ref_batch, bf16)
      torch.cuda.empty_cache()
    del ref_batch, bf16
    tf_err = family_teacher_forcing(arch, sz.serve_seed + 200 + i)
    torch.cuda.empty_cache()
    memory = ({"frames": cfg.encoder.n_frames} if cfg.family == "encdec"
              else {"img_embeds": cfg.n_img_tokens}
              if cfg.family == "vlm" else {})
    emit(f"e2e families {arch}", arch=arch, family=cfg.family,
         n_layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
         params=params, init_s=init_s, batch=bsz, prompt=plen,
         new_tokens=steps, memory_tokens=memory, ttft_s=ttft,
         decode_ms_per_token=(wall - ttft) / (steps - 1) * 1e3,
         tokens_per_s=bsz * steps / wall, wall_s=wall, peak_gib=peak,
         flash_launches=counts[path]["flash_attention"],
         tensor_core_flash_launches=tc,
         kernel_vs_plain=dict(batch=min(rb, bsz), prompt=min(rp, plen),
                              new_tokens=rs, **agree),
         teacher_forcing_reduced_f32=dict(
             batch=FAMILY_TF[0], prompt=FAMILY_TF[1], steps=FAMILY_TF[2],
             max_err_over_scale=tf_err, tol=TOL_FAMILY_TF),
         tol=dict(bf16=TOL_SERVE_BF16, gap=TOL_SERVE_GAP),
         reduced=[] if layers is None else [
             f"n_layers {full.n_layers} -> {layers} (one card's 80 GB: "
             f"{full.param_count() / 1e9:.1f} B parameters in all)"])
  return counts


def profile_serve(sz):
  """Where one set-1 prefill's time goes, and three of its decode steps':
  device time of the flash kernel, the cuBLAS GEMMs and the rest, and the
  busy share."""
  import torch

  from repro_torch.configs import get_config
  from repro_torch.models import Model
  cfg = get_config(sz.serve_arch)
  model = Model(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(0))
  bsz, plen, _ = sz.serve_sets[0]
  g = torch.Generator(device=DEVICE).manual_seed(sz.serve_seed + 1)
  batch = {"tokens": torch.randint(0, cfg.vocab, (bsz, plen), generator=g,
                                   device=DEVICE)}
  groups = {"flash_attention": ("flash_fwd_tc", "flash_fwd"),
            "gemm": ("gemm", "cutlass", "xmma", "nvjet", "cublas")}
  model.prefill(batch, model.init_cache(bsz, plen))     # warm-up
  profiled("profile serve prefill",
           lambda: model.prefill(batch, model.init_cache(bsz, plen)),
           groups=groups)
  caches = model.init_cache(bsz, plen + 4)
  logits, caches = model.prefill(batch, caches)
  tok = logits.argmax(-1)[:, None]
  model.decode_step(tok, plen, caches)                  # warm-up
  profiled("profile serve decode (3 steps)", lambda: [
      model.decode_step(tok, plen + 1 + i, caches) for i in range(3)],
           groups=groups)
  del model, caches
  torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the training path: the coreset step, the train / eval steps, the CLI
# ---------------------------------------------------------------------------

# the eval loss (flash kernel, bf16) against the first train step's loss
# (chunked attention) on the same parameters and batch, absolute
TOL_TRAIN_EVAL = 2e-2


def train_coreset(sz, corpus_kw):
  """The launcher's coreset step (``launch.train.CORESET``) with the
  kernels, with ``backend="ref"`` and with the kernels again (its launch
  counts read around it): the kernel runs' ids equal, and equal to the
  plain run's or a near-tie.  Returns (corpus, ids, counts, fields)."""
  import numpy as np
  import torch

  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import greedi_select_indices
  from repro_torch.kernels import ops
  from repro_torch.launch.train import CORESET
  corpus = EmbeddedCorpus(n_docs=CORESET["n_docs"],
                          feat_dim=CORESET["feat_dim"], **corpus_kw)
  feats = corpus.features()
  kw = dict(m=CORESET["m"], kappa=CORESET["kappa"],
            k_final=CORESET["k_final"])
  sels, walls = {}, {"auto": [], "ref": []}
  # the kernels, the plain versions, the kernels again (its counts kept)
  for backend in ("auto", "ref", "auto"):
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    sel = greedi_select_indices(torch.Generator().manual_seed(0), feats,
                                backend=backend, **kw)
    sync()
    walls[backend].append(time.perf_counter() - t0)
    check(backend not in sels or np.array_equal(sels[backend], sel),
          f"train coreset: two {backend} runs differ")
    sels[backend] = sel
  counts = ops.launch_counts()
  sel = sels["auto"]
  check(len(sel) == kw["k_final"] and len(set(sel.tolist())) == len(sel) and
        sel.min() >= 0 and sel.max() < corpus.n_docs, "train coreset: not "
        "k_final unique in-range ids")
  check(counts["facility_select"] > 0, "train coreset: facility_select was "
        "not launched")
  verdict = agree(feats, sel, sels["ref"], "train coreset kernel/plain")
  return corpus, sel, counts, dict(wall_s=walls, agreement=verdict,
                                   facility_select=counts["facility_select"])


def train_kernel_phase(counts: dict):
  """facility_gain / facility_select at the coreset step's shapes (round
  1: 8 partitions of 512 x 512 at d 64; round 2: 4096 eval rows x 2048
  merged candidates), linear f32, against the plain versions."""
  import torch

  from repro_torch.launch.train import CORESET
  g = torch.Generator(device=DEVICE).manual_seed(23)
  m, n, d = CORESET["m"], CORESET["n_docs"], CORESET["feat_dim"]
  rows = {}
  for label, shape in (("train round1", (m, n // m, n // m)),
                       ("train round2", (1, n, m * CORESET["kappa"]))):
    st = fl_state(g, *shape, d, torch.float32)
    gr, sr = facility_phase(label, *st, "linear", "f32", m, counts)
    rows[("facility_gain", label)] = gr
    rows[("facility_select", label)] = sr
  return rows


def train_cli(sz):
  """``python -m repro_torch.launch.train --reduced --select-coreset`` in
  a process of its own: ``train_cli_steps[0]`` steps with a checkpoint
  every ``train_ckpt_every``, then ``--steps train_cli_steps[1]``, which
  must resume from the first run's last step."""
  first, last = sz.train_cli_steps
  (REPO / "build").mkdir(exist_ok=True)
  outs, walls = [], []
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    for steps in (first, last):
      cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--select-coreset", "--steps", str(steps), "--ckpt-every",
             str(sz.train_ckpt_every), "--ckpt-dir", os.path.join(tmp, "ck"),
             "--device", DEVICE]
      t0 = time.perf_counter()
      out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=600, env=dict(os.environ,
                                                 PYTHONPATH=str(SRC)))
      walls.append(time.perf_counter() - t0)
      check(out.returncode == 0, f"train CLI --steps {steps} failed: "
            f"{out.stderr[-2000:]}")
      outs.append(out.stdout)
    kept = sorted(os.listdir(os.path.join(tmp, "ck")))
  check("resumed" not in outs[0] and "GreeDi selected 1024" in outs[0],
        f"train CLI first run: {outs[0][-1000:]}")
  check(f"[train] resumed from step {first}" in outs[1] and
        f"[train] done: steps {first}..{last}" in outs[1],
        f"train CLI second run did not resume from step {first}: "
        f"{outs[1][-1000:]}")
  losses = [float(line.split("loss")[1].split()[0])
            for out in outs for line in out.splitlines()
            if line.startswith("[train] step")]
  check(len(losses) >= 2 and all(x == x and abs(x) < 1e4 for x in losses),
        f"train CLI losses {losses}")
  return dict(steps=[first, last], wall_s=walls, resumed_from=first,
              losses=losses, checkpoints=kept)


def e2e_train(sz):
  """The training path through the entry points a user calls:

  (a) the coreset step at the launcher's sizes (``launch.train.CORESET``)
      with the facility-select kernel, its ids held to the plain run's
      (equal or a near-tie);
  (b) qwen3-4b at full width and depth (36 layers, d 2560, vocab 151936;
      4.41 B random bf16 parameters from a seed, remat "dots"), the
      optimizer state beside it: the eval step (``make_eval_step``, the
      flash kernel, 36 launches) on the first coreset batch, then
      ``train_steps`` of ``make_train_step`` (chunked attention, 0 flash
      launches) on the coreset's batches: ms a step (the median after the
      first), tokens/s, peak memory, loss and grad norm each step (all
      finite), and the eval loss within ``TOL_TRAIN_EVAL`` of the first
      step's loss (the same parameters and batch);
  (c) the CLI, ``train_cli``, runs later in ``e2e_launchers``.
  Returns (launch counts by path, the model and optimizer state and a
  batch for ``profile_train``, the single-process run's numbers and the
  coreset's ids for ``e2e_train_dist``)."""
  import statistics

  import torch

  from repro_torch.configs import get_config
  from repro_torch.data.pipeline import batches_from_indices
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.models import Model
  from repro_torch.train import (OptConfig, init_opt_state, make_eval_step,
                                 make_train_step)
  cfg = get_config(sz.train_arch)
  torch.cuda.empty_cache()
  corpus, sel, coreset_counts, coreset = train_coreset(
      sz, dict(vocab=cfg.vocab, seq_len=sz.train_seq, device=DEVICE))
  counts = {"train_coreset": coreset_counts}
  batches = list(batches_from_indices(corpus, sel, sz.train_batch,
                                      sz.train_steps))
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = Model(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(42))
  opt = init_opt_state(model)
  sync()
  init_s = time.perf_counter() - t0
  state_gib = torch.cuda.memory_allocated() / 2**30
  opt_cfg = OptConfig(lr=3e-4, total_steps=200, warmup_steps=10)
  step = make_train_step(model, opt_cfg)
  eval_step = make_eval_step(model)

  ops.reset_launch_counts()
  tc0 = fa.tc_launches
  ev = eval_step(batches[0])
  sync()
  counts["train_eval"] = ops.launch_counts()
  eval_loss = float(ev["loss"])
  check(counts["train_eval"]["flash_attention"] == cfg.n_layers and
        fa.tc_launches - tc0 == cfg.n_layers, f"eval step: "
        f"{counts['train_eval']['flash_attention']} flash launches "
        f"({fa.tc_launches - tc0} tensor-core), expected {cfg.n_layers}")
  walls, losses, norms, lrs = [], [], [], []
  for i, batch in enumerate(batches):
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    m = step(opt, batch)
    sync()
    walls.append(time.perf_counter() - t0)
    launched = ops.launch_counts()
    if i == 0:
      counts["train_grad_step"] = launched
    check(launched["flash_attention"] == 0, f"train step {i}: "
          f"{launched['flash_attention']} flash launches under autograd")
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    lrs.append(float(m["lr"]))
  peak = torch.cuda.max_memory_allocated() / 2**30
  check(all(x == x and abs(x) < 1e4 for x in losses + norms), f"train "
        f"steps: loss {losses}, grad norm {norms}")
  check(abs(eval_loss - losses[0]) <= TOL_TRAIN_EVAL, f"eval loss "
        f"{eval_loss} (kernel) vs the first step's {losses[0]} (chunked "
        f"attention)")
  ms = statistics.median(walls[1:]) * 1e3
  tokens = sz.train_batch * sz.train_seq
  emit("e2e train", arch=cfg.name, n_layers=cfg.n_layers, reduced=[],
       d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype, remat="dots",
       params=sum(p.numel() for p in model.parameters()),
       batch=sz.train_batch, seq=sz.train_seq, coreset=coreset,
       init_s=init_s, state_gib=state_gib, peak_gib=peak,
       step_wall_s=walls, ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
       loss=losses, grad_norm=norms, lr=lrs, eval_loss=eval_loss,
       eval_minus_first_loss=eval_loss - losses[0], tol=TOL_TRAIN_EVAL,
       flash_launches={"grad step": counts["train_grad_step"][
           "flash_attention"], "eval step": counts["train_eval"][
               "flash_attention"]})
  single = dict(sel=sel, losses=losses, grad_norms=norms, eval_loss=eval_loss,
                ms_per_step=ms, peak_gib=peak)
  return counts, (model, opt, step, batches[0]), single


def scope_of(events, scopes):
  """A function from a profiled CPU op to its scope in a train step: an op
  inside a ``record_function`` scope named in ``scopes`` (its forward, and
  its recomputation under a checkpoint) belongs to it, and so does an op
  of the backward of a node that a forward op of the scope created
  (``autograd::engine::evaluate_function`` with that op's sequence
  number); any other op is "rest"."""
  from torch.autograd import DeviceType

  def ancestors(e):
    while e is not None:
      yield e
      e = e.cpu_parent

  def backward(a):
    return a.name.startswith("autograd::engine::evaluate_function")

  seq_scope = {}
  for e in events:
    if (e.device_type == DeviceType.CPU and e.sequence_nr >= 0
        and not any(backward(a) for a in ancestors(e))):
      hit = next((a.name for a in ancestors(e) if a.name in scopes), None)
      if hit:
        seq_scope[e.sequence_nr] = hit

  def scope(e):
    for a in ancestors(e):
      if a.name in scopes:
        return a.name
      if backward(a) and a.sequence_nr in seq_scope:
        return seq_scope[a.sequence_nr]
    return "rest"

  return scope


TRAIN_SCOPES = ("train.chunked_attention", "train.xent_chunk",
                "train.adamw_update")
GEMM_KEYS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def scoped_train_step(step, opt, batch):
  """Run ``step(opt, batch)`` with ``chunked_attention``,
  ``Model._xent_chunk`` and the step's ``adamw_update`` each inside a
  ``record_function`` scope of ``TRAIN_SCOPES`` (restored after)."""
  import torch

  from repro_torch.models import attention, registry
  from repro_torch.train import train_step

  def scoped(name, fn):
    def run(*a, **kw):
      with torch.profiler.record_function(name):
        return fn(*a, **kw)
    return run

  saved = (attention.chunked_attention, registry.Model._xent_chunk,
           train_step.adamw_update)
  attention.chunked_attention = scoped(TRAIN_SCOPES[0], saved[0])
  registry.Model._xent_chunk = scoped(TRAIN_SCOPES[1], saved[1])
  train_step.adamw_update = scoped(TRAIN_SCOPES[2], saved[2])
  try:
    return step(opt, batch)
  finally:
    (attention.chunked_attention, registry.Model._xent_chunk,
     train_step.adamw_update) = saved


def profile_train(handles):
  """Where one full-width train step's device time goes: the GEMMs (every
  cuBLAS / CUTLASS kernel, and those outside attention and the xent
  chunks: the projections and the MLP), chunked attention (forward,
  recomputation and backward), the xent chunks (final norm, head,
  logsumexp: forward, recomputation, backward) and the optimizer's
  elementwise passes, as shares of the device time; and the busy share
  (device time over the profiled wall, a lower bound)."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  model, opt, step, batch = handles
  scoped_train_step(step, opt, batch)                   # warm-up
  torch.cuda.empty_cache()
  sync()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    scoped_train_step(step, opt, batch)
    sync()
    wall = time.perf_counter() - t0
  events = prof.events()
  scope = scope_of(events, TRAIN_SCOPES)

  def dur_ms(e):
    return (e.time_range.end - e.time_range.start) / 1e3

  # the device records less the scopes' own spans on the device timeline
  # (user annotations), which are not device time
  kern = [e for e in events if e.device_type == DeviceType.CUDA
          and e.name not in TRAIN_SCOPES
          and not getattr(e, "is_user_annotation", False)]
  device_ms = sum(dur_ms(e) for e in kern)
  if not device_ms:
    emit("profile train step", wall_s=wall, device_ms="not measured",
         busy_share="not measured", kernel_records=len(kern))
    return
  # each kernel counts for the scope of the launch call (its CUDA
  # correlation id) and so of the op that made it; "unlinked" if none
  launches = {e.id: e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cuLaunch", "cuMem"))}
  groups = [*TRAIN_SCOPES, "rest", "unlinked"]
  by_scope, gemm = dict.fromkeys(groups, 0.0), dict.fromkeys(groups, 0.0)
  for k in kern:
    call = launches.get(k.id)
    hit = "unlinked" if call is None else scope(call)
    by_scope[hit] += dur_ms(k)
    if any(key in k.name.lower() for key in GEMM_KEYS):
      gemm[hit] += dur_ms(k)
  top = {}
  for e in kern:
    top[e.name[:60]] = top.get(e.name[:60], 0.0) + dur_ms(e)
  emit("profile train step", wall_s=wall, device_ms=device_ms,
       busy_share=device_ms / 1e3 / wall, kernel_launches=len(kern),
       by_scope_ms=by_scope,
       by_scope_share={k: v / device_ms for k, v in by_scope.items()},
       gemm_ms=sum(gemm.values()), gemm_share=sum(gemm.values()) / device_ms,
       gemm_outside_attention_xent_share=gemm["rest"] / device_ms,
       gemm_by_scope_ms=gemm,
       top=sorted(top.items(), key=lambda kv: -kv[1])[:6])
  # a scope that read nothing lost its wrapper (the function was renamed or
  # is reached another way): its time would hide in "rest"
  dark = [name for name in TRAIN_SCOPES if not by_scope[name] > 0]
  check(not dark, f"profile train step: no device time under {dark}")


# ---------------------------------------------------------------------------
# training over processes: the training mesh, the compressed all-reduce, the
# elastic reshard
# ---------------------------------------------------------------------------

TRAIN_DIST_RANKS = 4
TRAIN_DIST_STEPS = 2   # batches drawn (ms a step: the one after the first)
# (label, (data, model), layers, steps)
# the 4x1 ranks each hold a whole replica: at 4 layers (1.18 B parameters)
# AdamW's float32 temporaries of the 389 M-element embedding took four ranks
# past 80 GB, so run b has 2 (0.98 B a replica); run a fitted at full depth
# (14.13 GiB a rank) and runs 2 of the 36 layers to leave the time limit
# room for the other model families and their model axis; the 4x1 run
# takes one step (its ms a step is that step's), a step being 12-15 s of
# the whole replica's gradient crossing gloo
TRAIN_DIST_RUNS = (("a 1x4", (1, 4), 2, 2), ("b 2x2", (2, 2), 2, 2),
                   ("b 4x1", (4, 1), 2, 1))
TRAIN_DIST_CKPT_FROM = "b 2x2"         # the elastic save's layout ...
TRAIN_DIST_RESTORE = ((1, 4), (4, 1))  # ... restored onto these and 1 process
TOL_COMPRESS_BOUND = 1.001   # the mean's error over sum(scale) / D (fp slack)
TOL_COMPRESS_EF = 0.02       # tests/test_train.py's error-feedback oracle
COMPRESS_EF_ELEMS = 1 << 24  # the error-feedback steps' slice of a gradient
COMPRESS_CHUNK = 1 << 24     # elements the host-side checks take at once


def fingerprint(t):
  """(2,) int64 on t's device: the sum of t's bits and their sum weighted
  by position (mod 65521, plus 1), both wrapping; equal tensors give
  equal fingerprints, and a flipped bit changes them."""
  import torch
  bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
  x = t.detach().contiguous().reshape(-1).view(bits[t.element_size()])
  out = torch.zeros(2, dtype=torch.int64, device=t.device)
  for s0 in range(0, x.numel(), COMPRESS_CHUNK):
    c = x[s0:s0 + COMPRESS_CHUNK].to(torch.int64)
    w = torch.arange(s0, s0 + c.numel(), device=t.device) % 65521 + 1
    out[0] += c.sum()
    out[1] += (c * w).sum()
  return out


def part_fingerprint(x, full, offsets):
  """``fingerprint`` of the part ``x`` of a leaf of shape ``full`` that
  starts at ``offsets``, each element weighted by its position in the
  whole leaf: the parts' fingerprints add up (int64, wrapping) to the
  whole leaf's, so a split leaf needs no gather of its whole."""
  import torch
  bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
  x = x.detach().contiguous()
  if x.dim() == 0:
    x, full, offsets = x.reshape(1), (1,), (0,)
  full = tuple(full)
  strides = [math.prod(full[d + 1:]) for d in range(len(full))]
  rest = math.prod(x.shape[1:])
  per = max(1, COMPRESS_CHUNK // max(rest, 1))
  out = torch.zeros(2, dtype=torch.int64, device=x.device)
  inner = torch.zeros((), dtype=torch.int64, device=x.device)
  for d in range(1, x.dim()):
    shape = [1] * (x.dim() - 1)
    shape[d - 1] = x.shape[d]
    inner = inner + ((offsets[d] + torch.arange(
        x.shape[d], device=x.device)) * strides[d]).reshape(shape)
  flat = x.view(bits[x.element_size()])
  for r0 in range(0, x.shape[0], per):
    c = flat[r0:r0 + per].to(torch.int64)
    rows = (offsets[0] + r0 + torch.arange(c.shape[0], device=x.device)
            ) * strides[0]
    w = (rows.reshape(-1, *[1] * (x.dim() - 1)) + inner) % 65521 + 1
    out[0] += c.sum()
    out[1] += (c * w).sum()
  return out


def _tree_leaves(tree, prefix: str = "", out=None) -> dict:
  """The tensors of a tree of dicts and NamedTuples by their path (a
  module-level recursion: a nested one is a reference cycle, and would
  keep the tensors it collects alive until the garbage collector runs)."""
  out = {} if out is None else out
  if isinstance(tree, dict):
    for k, v in tree.items():
      _tree_leaves(v, f"{prefix}{k}/", out)
  elif hasattr(tree, "_fields"):
    for k, v in zip(tree._fields, tree):
      _tree_leaves(v, f"{prefix}{k}/", out)
  else:
    out[prefix.rstrip("/")] = tree
  return out


def whole_prints(tree, mesh, specs):
  """Every leaf of ``tree`` (dicts and NamedTuples of tensors, this rank's
  parts under ``mesh`` by ``specs``; None: one process, whole leaves) ->
  its whole leaf's ``fingerprint``, on the host: each rank's
  ``part_fingerprint`` summed over the groups of the axes the leaf is
  split on (a few gathers of (n, 2) int64 tables, no leaf gathered)."""
  import torch
  leaves = _tree_leaves(tree)
  by = {}
  for key, x in leaves.items():
    splits = [] if mesh is None else mesh.splits(specs.get(key, ()), x.dim())
    full, offsets = list(x.shape), [0] * x.dim()
    for dim, axes in splits:
      size = math.prod(mesh.shape[a] for a in axes)
      index = 0
      for a in axes:
        index = index * mesh.shape[a] + mesh.coords[a]
      full[dim], offsets[dim] = x.shape[dim] * size, x.shape[dim] * index
    names, fps = by.setdefault(tuple(a for _, a in splits), ([], []))
    names.append(key)
    fps.append(part_fingerprint(x, full, offsets))
  out = {}
  for axes, (names, fps) in by.items():
    table = torch.stack(fps)
    for a in axes:
      parts = mesh.group(a).gather_parts(table)
      table = parts[0].clone()
      for p in parts[1:]:
        table += p
    out.update(zip(names, table.cpu()))
  return out


def quantize_np(x, noise):
  """The plain quantization (numpy float32 on the host): the reference's
  ``_quantize`` formula."""
  import numpy as np
  xb = x.reshape(-1, 256)
  scale = np.maximum(np.abs(xb).max(axis=1) / np.float32(127.0),
                     np.float32(1e-12))
  q = np.clip(np.round(xb / scale[:, None] + noise.reshape(-1, 256)), -127,
              127).astype(np.int8)
  return q.reshape(-1), scale


def _note(base, what):
  """A progress line of a torchrun rank of this script on its standard
  error (the launch's log): the step it reached and its device memory."""
  import torch
  print(f"[smoke rank {base.rank}] {what} at "
        f"{time.perf_counter() - STARTED:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} peak",
        file=sys.stderr, flush=True)


def _same_rows(parts, what):
  """Every gathered fingerprint table equal to the first."""
  for r, p in enumerate(parts[1:], 1):
    check(bool((p == parts[0]).all()), f"{what}: member {r} differs from "
          "member 0")


class GatherClock:
  """Times every ``ProcessMesh.gather_parts`` of the train steps it is on
  for: a device sync, then the host's wall through the gather (the copy
  to the host, gloo's collective with its wait for the other ranks, the
  copies back queued), so the compute the gather would wait for is not
  counted in it."""

  def __init__(self):
    from repro_torch.launch.mesh import ProcessMesh
    self.cls, self.real, self.walls = ProcessMesh, None, []

  def __enter__(self):
    real = self.real = self.cls.gather_parts
    walls = self.walls

    def timed(mesh, x):
      if mesh.world == 1:
        return real(mesh, x)
      sync()
      t0 = time.perf_counter()
      out = real(mesh, x)
      walls.append(time.perf_counter() - t0)
      return out

    self.cls.gather_parts = timed
    return self

  def __exit__(self, *exc):
    self.cls.gather_parts = self.real


def train_dist_run(label, shape, layers, base, batches, opt_cfg, keep=False):
  """One mesh run on this rank: the eval step, then the train steps on its
  data shard; after each step every data replica's parameters and every
  model group's replicated leaves equal bit for bit (fingerprints gathered
  over the group).  Returns (fields, the model, optimizer state and mesh
  when ``keep``)."""
  import dataclasses as dc
  import statistics

  import torch

  from repro_torch.configs import get_config
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.models import Model
  from repro_torch.train import init_opt_state, make_eval_step, make_train_step
  cfg = get_config(Sizes().train_arch)
  if layers:
    cfg = dc.replace(cfg, n_layers=layers)
  dev = base.device
  mesh = TrainMesh.over(*shape, base.rank, dev, base.backend)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  model = Model(cfg, device=dev, mesh=mesh,
                generator=torch.Generator(device=dev).manual_seed(42))
  opt = init_opt_state(model)
  sync()
  state_gib = torch.cuda.memory_allocated() / 2**30
  _note(base, f"{label} built")
  step, ev = make_train_step(model, opt_cfg), make_eval_step(model)
  d, rows = mesh.coords["data"], batches[0]["tokens"].shape[0] // mesh.data

  def mine(b):
    return {k: v[d * rows:(d + 1) * rows] for k, v in b.items()}

  ops.reset_launch_counts()
  tc0 = fa.tc_launches
  eval_loss = float(ev(mine(batches[0]))["loss"])
  sync()
  eval_counts = ops.launch_counts()
  check(eval_counts["flash_attention"] == cfg.n_layers and
        fa.tc_launches - tc0 == cfg.n_layers, f"train dist {label}: eval "
        f"step {eval_counts['flash_attention']} flash launches "
        f"({fa.tc_launches - tc0} tensor-core), expected {cfg.n_layers}")
  names = list(model.state_dict())
  replicated = [i for i, n in enumerate(names) if n not in model.sharded]
  walls, losses, norms, gathers, gbytes = [], [], [], 0, 0
  gather_s = []
  for i, b in enumerate(batches):
    ops.reset_launch_counts()
    g0, b0 = mesh.gathers, mesh.gather_bytes
    sync()
    with GatherClock() as clock:
      t0 = time.perf_counter()
      m = step(opt, mine(b))
      sync()
      walls.append(time.perf_counter() - t0)
    gather_s.append(clock.walls)
    gathers += mesh.gathers - g0
    gbytes += mesh.gather_bytes - b0
    check(ops.launch_counts()["flash_attention"] == 0, f"train dist "
          f"{label} step {i}: flash launched under autograd")
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    _note(base, f"{label} step {i} {walls[-1]:.3f} s")
    fp = torch.stack([fingerprint(p) for p in model.state_dict().values()])
    _same_rows(mesh.dp.gather_parts(fp), f"train dist {label} step {i}: "
               "data replicas' parameters")
    _same_rows(mesh.tp.gather_parts(fp[replicated]), f"train dist {label} "
               f"step {i}: the model group's replicated leaves")
  fields = dict(mesh=f"{shape[0]}x{shape[1]}", n_layers=cfg.n_layers,
                params_a_rank=sum(p.numel() for p in model.parameters()),
                state_gib=state_gib, eval_loss=eval_loss,
                eval_flash_launches=eval_counts["flash_attention"],
                loss=losses, grad_norm=norms, step_wall_s=walls,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                step_gathers=gathers, step_gather_bytes=gbytes,
                step_gather_s=[sum(w) for w in gather_s],
                gather_ms_median=1e3 * statistics.median(
                    w for ws in gather_s[1 if len(gather_s) > 1 else 0:]
                    for w in ws),
                replicated_leaves=len(replicated), leaves=len(names))
  if keep:
    return fields, (model, opt, mesh)
  del model, opt, step, ev
  torch.cuda.empty_cache()
  return fields, None


def _restore_like(cfg, mesh, dtypes):
  """A ``{"params", "opt"}`` tree of meta tensors with a rank's shapes
  under ``mesh`` (None: one process) and the saved dtypes, and its specs:
  a restore allocates only what it returns."""
  import torch

  from repro_torch.models.registry import (mesh_parallelism, param_shapes,
                                           param_specs)
  from repro_torch.train import OptState, tree_specs
  specs = param_specs(cfg, mesh_parallelism(cfg, mesh))
  meta = {}
  for name, shape in param_shapes(cfg).items():
    meta[name] = shape if mesh is None else mesh.local_shape(shape,
                                                             specs[name])

  def empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")

  like = {"params": {n: empty(sh, dtypes[n]) for n, sh in meta.items()},
          "opt": OptState(empty((), torch.int64),
                          {n: empty(sh, torch.float32)
                           for n, sh in meta.items()},
                          {n: empty(sh, torch.float32)
                           for n, sh in meta.items()})}
  return like, ({} if mesh is None else tree_specs(specs))


def train_dist_elastic(kept, base, ckpt_dir, batch):
  """Save the kept run's state (gathered, rank 0 writes) and restore it
  onto ``TRAIN_DIST_RESTORE`` and one process: every restored leaf's
  whole equals the saved whole bit for bit (``whole_prints``: each
  whole leaf's fingerprint from its parts, no leaf gathered).  Returns
  (fields, this rank's flat float32 gradient of one more step, on its
  data shard of ``batch``, for the compression check); ``kept`` holds the
  run's (model, optimizer state, mesh) and is emptied, so they are freed
  here."""
  import torch

  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.train import CheckpointManager, tree_specs
  model, opt, mesh = kept.pop()
  specs = tree_specs(model.specs)
  dtypes = {n: p.dtype for n, p in model.state_dict().items()}
  ck = CheckpointManager(ckpt_dir, keep_last=1)
  tree = {"params": model.state_dict(), "opt": opt}
  prints = whole_prints
  want = prints(tree, mesh, specs)
  sync()
  t0 = time.perf_counter()
  ck.save(1, tree, mesh=mesh, specs=specs)
  save_s = time.perf_counter() - t0
  path = ck._path(1)
  size = os.path.getsize(os.path.join(path, "arrays.npz"))
  # one more step's gradient, flattened, for the compression check
  cfg = model.cfg
  for p in model.parameters():
    p.grad = None
  d, rows = mesh.coords["data"], batch["tokens"].shape[0] // mesh.data
  loss, _ = model.loss_fn({k: v[d * rows:(d + 1) * rows]
                           for k, v in batch.items()})
  loss.backward()
  grad = torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])
  grad = torch.nn.functional.pad(grad, (0, (-grad.numel()) % 256))
  del model, opt, tree, loss
  torch.cuda.empty_cache()
  restores = {}
  for shape in TRAIN_DIST_RESTORE:
    m2 = TrainMesh.over(*shape, base.rank, base.device, base.backend)
    like, sp = _restore_like(cfg, m2, dtypes)
    sync()
    t0 = time.perf_counter()
    got, meta = ck.restore(like, device=base.device, mesh=m2, specs=sp)
    sync()
    wall = time.perf_counter() - t0
    have = prints(got, m2, sp)
    bad = [k for k in want if not torch.equal(have.get(k, torch.zeros(2,
                                                       dtype=torch.int64)),
                                              want[k])]
    check(not bad and sorted(have) == sorted(want), f"train dist elastic: "
          f"{shape[0]}x{shape[1]} restored leaves differ: {bad[:5]}")
    restores[f"{shape[0]}x{shape[1]}"] = wall
    del got
    torch.cuda.empty_cache()
  if base.rank == 0:
    like, _ = _restore_like(cfg, None, dtypes)
    t0 = time.perf_counter()
    got, _ = ck.restore(like, device=base.device)
    sync()
    restores["one process"] = time.perf_counter() - t0
    have = prints(got, None, {})
    bad = [k for k in want if not torch.equal(have[k], want[k])]
    check(not bad, f"train dist elastic: one-process restore differs: "
          f"{bad[:5]}")
    del got
    torch.cuda.empty_cache()
  base.world.all_gather(torch.zeros(1, device=base.device))  # rank 0 done
  return dict(saved_from=TRAIN_DIST_CKPT_FROM, leaves=len(want),
              npz_bytes=size, save_s=save_s, restore_s=restores), grad


def train_dist_compression(grad, base):
  """The compressed all-reduce over the 4 ranks (a 4x1 mesh's data group)
  on this rank's flat gradient, the whole of it; on its first and its
  last ``COMPRESS_CHUNK`` (the host-side checks of every chunk took 31 s:
  tests/test_torch_train_dist.py holds every code on the CPU): codes and
  scales against the plain (numpy) quantization bit for bit, the mean
  within its quantization bound of the rank-ordered float32 mean; error
  feedback over 10 steps on the first COMPRESS_EF_ELEMS elements within
  TOL_COMPRESS_EF."""
  import numpy as np
  import torch

  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.train import compression as C
  from repro_torch.train import make_compressed_allreduce
  mesh = TrainMesh.over(TRAIN_DIST_RANKS, 1, base.rank, base.device,
                        base.backend)
  group = mesh.dp
  n = grad.numel()
  gen = torch.Generator(device=base.device).manual_seed(100 + base.rank)
  noise = C.draw_noise(n, gen, device=base.device)
  fn = make_compressed_allreduce(mesh, ("data",), {"g": (None,)})
  g0, b0 = mesh.gathers, mesh.gather_bytes
  sync()
  t0 = time.perf_counter()
  mean, new_err = fn({"g": grad}, None, noise)
  sync()
  wall = time.perf_counter() - t0
  wire = dict(gathers=mesh.gathers - g0, bytes=mesh.gather_bytes - b0)
  worst, codes_equal = 0.0, 0
  for s0 in sorted({0, (n - 1) // COMPRESS_CHUNK * COMPRESS_CHUNK}):
    part = slice(s0, s0 + COMPRESS_CHUNK)
    q, sc = C.quantize(grad[part], noise[part])
    qn, scn = quantize_np(grad[part].cpu().numpy(), noise[part].cpu().numpy())
    check(np.array_equal(q.cpu().numpy(), qn) and np.array_equal(
        sc.cpu().numpy(), scn), f"train dist compression: codes or scales "
        f"differ from the plain quantization at {s0}")
    codes_equal += qn.size
    exact = group.sum(grad[part], div=group.world)
    scales = torch.stack(group.gather_parts(sc))     # (D, blocks)
    bound = (scales.sum(0) / group.world * TOL_COMPRESS_BOUND
             ).repeat_interleave(C.BLOCK)
    err = (mean["g"][part] - exact).abs()
    check(bool((err <= bound).all()), f"train dist compression: the mean "
          f"is off by {float((err - bound).max())} past its bound at {s0}")
    worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
    check(torch.equal(new_err["g"][part], grad[part] - C.dequantize(q, sc)),
          f"train dist compression: the residual at {s0}")
  del mean, new_err, noise
  # the error-feedback oracle on a slice
  g = grad[:COMPRESS_EF_ELEMS].clone()
  del grad
  torch.cuda.empty_cache()
  err = None
  acc, exact = torch.zeros_like(g), torch.zeros_like(g)
  for t in range(10):
    gt = g * (1.0 + 0.1 * t)
    avg, err = C.compressed_psum([gt], err, C.draw_noise(g.numel(), gen,
                                                         device=g.device),
                                 group)
    acc += avg[0]
    exact += group.sum(gt, div=group.world)
  rel = float((acc - exact).abs().max() / exact.abs().max())
  check(rel < TOL_COMPRESS_EF, f"train dist compression: error feedback "
        f"{rel} relative after 10 steps")
  return dict(elements=n, wall_s=wall, wire_gathers=wire["gathers"],
              wire_bytes=wire["bytes"], f32_bytes_each=4 * n,
              codes_compared=codes_equal, checked="first and last chunk",
              worst_err_over_bound=worst,
              ef_elements=g.numel(), ef_rel=rel, ef_tol=TOL_COMPRESS_EF)


def train_dist_rank(out_dir: str) -> None:
  """One rank of e2e train dist's library run (``chip_smoke.py
  --train-dist DIR`` under torchrun, 4 gloo ranks on the card): the mesh
  runs of ``TRAIN_DIST_RUNS`` on the coreset batches DIR/inputs.npz
  names, the elastic save and restores, the compressed all-reduce; writes
  DIR/rank<r>.json."""
  sys.path.insert(0, str(SRC))
  import repro_torch.models  # noqa: F401  (torch._dynamo, off model frames)
  import numpy as np
  import torch

  from repro_torch import no_tf32
  from repro_torch.configs import get_config
  from repro_torch.data.pipeline import EmbeddedCorpus, batches_from_indices
  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.launch.train import CORESET
  from repro_torch.train import OptConfig
  no_tf32()
  sz = Sizes()
  base = TrainMesh.from_env((TRAIN_DIST_RANKS, 1), "gloo", DEVICE)
  cfg = get_config(sz.train_arch)
  sel = np.load(os.path.join(out_dir, "coreset.npy"))
  corpus = EmbeddedCorpus(n_docs=CORESET["n_docs"],
                          feat_dim=CORESET["feat_dim"], vocab=cfg.vocab,
                          seq_len=sz.train_seq, device=str(base.device))
  batches = list(batches_from_indices(corpus, sel, sz.train_batch,
                                      TRAIN_DIST_STEPS))
  opt_cfg = OptConfig(lr=3e-4, total_steps=200, warmup_steps=10)
  res = {"runs": {}}
  for label, shape, layers, steps in TRAIN_DIST_RUNS:
    keep = label == TRAIN_DIST_CKPT_FROM
    fields, handles = train_dist_run(label, shape, layers, base,
                                     batches[:steps], opt_cfg, keep=keep)
    res["runs"][label] = fields
    if keep:
      t0 = time.perf_counter()
      res["layouts"] = layouts_train(base, handles, fields, batches[:steps],
                                     opt_cfg)
      res["layouts"]["phase_s"] = time.perf_counter() - t0
      kept = [handles]
      del handles
      t0 = time.perf_counter()
      res["elastic"], grad = train_dist_elastic(
          kept, base, os.path.join(out_dir, "ck"), batches[0])
      res["elastic"]["phase_s"] = time.perf_counter() - t0
      t0 = time.perf_counter()
      res["compression"] = train_dist_compression(grad, base)
      res["compression"]["phase_s"] = time.perf_counter() - t0
      del grad
      torch.cuda.empty_cache()
  with open(os.path.join(out_dir, f"rank{base.rank}.json"), "w") as f:
    json.dump(res, f)
  base.close()


def train_single(cfg, batches, opt_cfg):
  """The one-process run of ``cfg`` from the same seed and batches: the
  eval loss, then the steps' losses and walls."""
  import torch

  from repro_torch.models import Model
  from repro_torch.train import init_opt_state, make_eval_step, make_train_step
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  model = Model(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(42))
  opt = init_opt_state(model)
  step = make_train_step(model, opt_cfg)
  eval_loss = float(make_eval_step(model)(batches[0])["loss"])
  walls, losses = [], []
  for b in batches:
    sync()
    t0 = time.perf_counter()
    losses.append(float(step(opt, b)["loss"]))
    sync()
    walls.append(time.perf_counter() - t0)
  peak = torch.cuda.max_memory_allocated() / 2**30
  del model, opt, step
  torch.cuda.empty_cache()
  return dict(eval_loss=eval_loss, loss=losses, step_wall_s=walls,
              peak_gib=peak)


def train_dist_cli(sz):
  """The launcher under torchrun, 4 gloo ranks on the card, ``--reduced``:
  ``--mesh 2x2`` to step 2 (a checkpoint every 2), then ``--mesh 4x1`` to
  step 4, which must resume from step 2; the 2x2 run's losses against the
  one-process launcher's, which runs beside the 2x2 launch."""
  first, last = 2, 4
  (REPO / "build").mkdir(exist_ok=True)
  outs, walls = [], []
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    ck = os.path.join(tmp, "ck")
    common = ["-m", "repro_torch.launch.train", "--reduced", "--device",
              DEVICE, "--ckpt-every", "2", "--ckpt-dir", ck]
    # the one-process run beside the 2x2 launch
    one = subprocess.Popen([sys.executable, *common[:-1],
                            os.path.join(tmp, "one"), "--steps", str(first)],
                           cwd=REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, PYTHONPATH=str(SRC)))
    try:
      for mesh, steps in (("2x2", first), ("4x1", last)):
        wall, out = torchrun([*common, "--mesh", mesh, "--dist-backend",
                              "gloo", "--steps", str(steps)])
        walls.append(wall)
        outs.append(out)
      one_out, one_err = one.communicate(timeout=600)
    finally:
      if one.poll() is None:
        one.kill()
        one.wait()
    check(one.returncode == 0, f"train dist CLI one process: "
          f"{one_err[-2000:]}")
    kept = sorted(os.listdir(ck))
  check("resumed" not in outs[0] and f"[train] done: steps 0..{first}" in
        outs[0] and "mesh 2x2 backend gloo" in outs[0], f"train dist CLI "
        f"2x2: {outs[0][-1500:]}")
  check(f"[train] resumed from step {first}" in outs[1] and
        f"[train] done: steps {first}..{last}" in outs[1] and "mesh 4x1" in
        outs[1], f"train dist CLI 4x1 did not resume from {first}: "
        f"{outs[1][-1500:]}")

  def losses(out):
    return [float(line.split("loss")[1].split()[0])
            for line in out.splitlines() if line.startswith("[train] step")]

  got, want = losses(outs[0]), losses(one_out)
  check(len(got) == len(want) == 2 and all(
      abs(a - b) <= TOL_TRAIN_EVAL for a, b in zip(got, want)),
      f"train dist CLI: 2x2 losses {got}, one process {want}")
  done = [line for line in outs[0].splitlines() if "[train] done" in line]
  return dict(meshes=["2x2", "4x1"], steps=[first, last], wall_s=walls,
              one_process_beside_2x2=True,
              losses_2x2=got, losses_one=want, resumed_from=first,
              checkpoints=kept, done_2x2=done[0] if done else None)


def e2e_launchers(sz):
  """The phases that run a launcher in processes of its own, side by
  side (each in a thread of this process, which waits): ``train_cli``,
  ``train_dist_cli`` and ``cli_obs_run``.  Their checks are as when each
  ran alone; each wall includes the host and the card shared with the
  others."""
  from concurrent.futures import ThreadPoolExecutor
  phases = {"e2e train cli": train_cli, "e2e train dist cli": train_dist_cli,
            "cli obs": cli_obs_run}
  with ThreadPoolExecutor(max_workers=len(phases)) as pool:
    running = {name: pool.submit(fn, sz) for name, fn in phases.items()}
    for name, fut in running.items():
      emit(name, side_by_side=list(phases), **fut.result())


def e2e_train_dist(sz, single: dict):
  """Training over processes: qwen3-4b at full width under
  ``torch.distributed.run``, 4 gloo ranks on this card
  (``chip_smoke.py --train-dist DIR``).

  (a) ``--mesh 1x4`` at 2 layers (the model axis: heads, MLP columns
      and the vocabulary split over 4 ranks), (b) 2x2 and 4x1 at 2 layers,
      on the coreset batches of ``e2e train``: the eval step on the local
      heads (the flash kernel, one launch a layer), then the train steps;
      every data replica's parameters and every model group's replicated
      leaves equal bit for bit after each step, every loss within
      ``TOL_TRAIN_EVAL`` of the one-process run of the same depth, seed and
      batches (``train_single``); ms a
      step (the median after the first; the 4x1 run takes one step, and
      its ms a step is that step's), tokens/s, each rank's peak, the
      gathers and their bytes.  The 2x2 state is saved (the elastic
      checkpoint) and restored onto 1x4, 4x1 and one process, bit for bit;
      one more step's gradient, flattened, goes through the compressed
      all-reduce (``train_dist_compression``).  The launcher,
      ``train_dist_cli``, runs in ``e2e_launchers``.  Returns rank 0's
      launch counts of (a)'s eval step for the kernels line."""
  import dataclasses as dc
  import statistics

  import numpy as np
  import torch

  from repro_torch.configs import get_config
  from repro_torch.data.pipeline import EmbeddedCorpus, batches_from_indices
  from repro_torch.launch.train import CORESET
  from repro_torch.train import OptConfig
  cfg = get_config(sz.train_arch)
  opt_cfg = OptConfig(lr=3e-4, total_steps=200, warmup_steps=10)
  corpus = EmbeddedCorpus(n_docs=CORESET["n_docs"],
                          feat_dim=CORESET["feat_dim"], vocab=cfg.vocab,
                          seq_len=sz.train_seq, device=DEVICE)
  batches = list(batches_from_indices(corpus, single["sel"], sz.train_batch,
                                      TRAIN_DIST_STEPS))
  (REPO / "build").mkdir(exist_ok=True)
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    np.save(os.path.join(tmp, "coreset.npy"), np.asarray(single["sel"]))
    launch = torchrun_async([str(REPO / "chip_smoke.py"), "--train-dist",
                             tmp], timeout=900)
    # the one-process runs while the ranks start (a few seconds of the
    # card, before the ranks' first step)
    singles = {}
    for layers in {lay for _, _, lay, _ in TRAIN_DIST_RUNS}:
      r = train_single(dc.replace(cfg, n_layers=layers), batches, opt_cfg)
      r["ms_per_step"] = statistics.median(r["step_wall_s"][1:]) * 1e3
      singles[layers] = r
    del batches
    torch.cuda.empty_cache()
    wall, _ = launch.result()
    ranks = []
    for r in range(TRAIN_DIST_RANKS):
      with open(os.path.join(tmp, f"rank{r}.json")) as f:
        ranks.append(json.load(f))
  tokens = sz.train_batch * sz.train_seq
  runs = {}
  for label, shape, layers, _ in TRAIN_DIST_RUNS:
    one = singles[layers]
    per = [rk["runs"][label] for rk in ranks]
    for r, got in enumerate(per):
      vals = got["loss"] + got["grad_norm"] + [got["eval_loss"]]
      check(all(x == x and abs(x) < 1e4 for x in vals), f"train dist "
            f"{label} rank {r}: loss {got['loss']}, grad norm "
            f"{got['grad_norm']}")
      gap = max(abs(a - b) for a, b in zip(got["loss"], one["loss"]))
      check(gap <= TOL_TRAIN_EVAL and abs(got["eval_loss"] - one[
          "eval_loss"]) <= TOL_TRAIN_EVAL, f"train dist {label} rank {r}: "
            f"losses {got['loss']} (eval {got['eval_loss']}) against one "
            f"process's {one['loss']} (eval {one['eval_loss']})")
    after = 1 if len(per[0]["step_wall_s"]) > 1 else 0  # the first's wall
    ms = statistics.median(max(p["step_wall_s"][i] for p in per)
                           for i in range(after, len(per[0]["step_wall_s"])))
    ms *= 1e3
    runs[label] = dict(
        per[0], rank_peak_gib=[p["peak_gib"] for p in per],
        ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
        one_process=dict(loss=one["loss"], eval_loss=one["eval_loss"],
                         ms_per_step=one["ms_per_step"],
                         peak_gib=one["peak_gib"]),
        max_loss_gap=max(abs(a - b) for p in per
                         for a, b in zip(p["loss"], one["loss"])),
        reduced=[f"n_layers {cfg.n_layers} -> {layers} (" + (
            "the time limit: 36 layers fitted at 14.13 GiB a rank"
            if shape == (1, 4) else "four ranks of the replicated or "
            "half-split model in 80 GB") + ")"])
    # the host's wall inside the gathers (after a device sync each), the
    # median step's after the first, and a gather's median, by rank
    runs[label].update(
        rank_gather_s_a_step=[statistics.median(p["step_gather_s"][after:])
                              for p in per],
        rank_gather_ms_median=[p["gather_ms_median"] for p in per])
    del runs[label]["peak_gib"]
  single["layouts_train"] = [rk["layouts"] for rk in ranks]
  emit("e2e train dist", arch=cfg.name, d_model=cfg.d_model,
       vocab=cfg.vocab, dtype=cfg.dtype, remat="dots", ranks=TRAIN_DIST_RANKS,
       backend="gloo, one card", batch=sz.train_batch, seq=sz.train_seq,
       tol=TOL_TRAIN_EVAL, launch_wall_s=wall, runs=runs,
       elastic=ranks[0]["elastic"], compression=[rk["compression"]
                                                 for rk in ranks])
  return {"train_dist_eval_1x4": {
      "flash_attention": ranks[0]["runs"]["a 1x4"]["eval_flash_launches"]}}


# ---------------------------------------------------------------------------
# the model axis of every family: e2e families tp
# ---------------------------------------------------------------------------

FAMILY_TP_RANKS = 4
# (arch, (data, model), serve layers (None: the config's depth), (batch,
# prompt, new tokens), the MoE layouts ("tp": each expert's width split;
# "ep": whole experts dealt), train layers (None: the config's depth;
# "reduced": the reduced width, grok-1's AdamW state exceeds the card at
# full width even at one layer; the VLM's 2.1 B embedding and head and
# 0.88 B a layer take 12 bytes a parameter in training, in one process as
# over the four ranks, so it trains 3 layers, no cross block: whisper's
# decoder trains those)); a 2x2 mesh serves half the rows a replica
# The requests are smaller than e2e families' (a rank's activations cross
# gloo on the host in every layer: 8.6 GB a rank for a 4 x 2048 deepseek
# prefill; mamba's 194 gathers a decode step, about 1 s) so that the
# phase keeps to its 150 s
FAMILY_TP_RUNS = (
    ("deepseek-moe-16b", (1, 4), None, (2, 512, 4), ("tp", "ep"), 4),
    ("grok-1-314b", (1, 4), 2, (2, 1024, 4), ("ep",), "reduced"),
    ("mamba2-2.7b", (1, 4), None, (1, 1024, 4), ("tp",), 8),
    ("llama-3.2-vision-90b", (1, 4), 10, (1, 1024, 4), ("tp",), 3),
    ("recurrentgemma-2b", (2, 2), None, (2, 3072, 4), ("tp",), 3),
    ("whisper-tiny", (2, 2), None, (8, 432, 4), ("tp",), None),
)
FAMILY_TP_TRAIN = (2, 256, 1)   # rows, sequence, steps of a train run
FAMILY_TP_SEED = 900
# deepseek-moe-16b's TP and ep prefills are held within TOL_SERVE_BF16 at
# this depth; at 28 layers the depth amplifies any bf16 rounding past it
# (the kernel and plain routes 12 % apart, routing pinned: FAMILY_F32), so
# there the layouts may be no further apart than TOL_F32_RATIO times one
# process's kernel and plain routes on the same request
FAMILY_TP_SHALLOW = 2


def family_tp_cfgs(arch, serve_layers, train_layers):
  """(serve config, train config) of a ``FAMILY_TP_RUNS`` row."""
  import dataclasses as dc

  from repro_torch.configs import get_config, reduced
  full = get_config(arch)
  serve = full if serve_layers is None else dc.replace(
      full, n_layers=serve_layers)
  train = (reduced(full) if train_layers == "reduced" else full
           if train_layers is None else dc.replace(full,
                                                   n_layers=train_layers))
  return serve, train


def family_tp_batches(cfg, seed):
  """The train run's batches on the card (tokens, labels, mask and the
  family's memory input), drawn from ``seed``: every process draws the
  same."""
  import torch
  g = torch.Generator(device=DEVICE).manual_seed(seed)
  rows, seq, steps = FAMILY_TP_TRAIN
  out = []
  for _ in range(steps):
    b = family_inputs(cfg, g, rows, seq + 1)
    toks = b.pop("tokens")
    out.append(dict(b, tokens=toks[:, :-1], labels=toks[:, 1:],
                    mask=torch.ones(rows, seq, device=DEVICE)))
  return out


def family_tp_serve_batch(cfg, seed, req):
  import torch
  bsz, plen, _ = req
  return family_inputs(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                       bsz, plen)


def family_tp_one(out_dir, i, row):
  """The one-process runs of a ``FAMILY_TP_RUNS`` row at the same depths,
  seeds and inputs: the greedy trace of the serve request (tokens, every
  step's top-2 gap, the prefill's logits; the MoE routing recorded), and
  the train run's losses.  Written to OUT_DIR/one<i>.npz."""
  import numpy as np
  import torch

  from repro_torch.models import Model
  from repro_torch.train import OptConfig, init_opt_state, make_train_step
  arch, _, sl, req, _, tl = row
  scfg, tcfg = family_tp_cfgs(arch, sl, tl)
  seed = FAMILY_TP_SEED + 10 * i
  out = {}
  model = Model(scfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
  pin = PinnedRouting() if scfg.moe.num_experts else None
  with pin.record() if pin else contextlib.nullcontext():
    toks, logits = greedy_trace(model, family_tp_serve_batch(
        scfg, seed + 1, req), req[2])
  out.update(tokens=toks.cpu().numpy(), gaps=top2_gap(logits).cpu().numpy(),
             prefill=logits[:, 0].cpu().numpy())
  for j, t in enumerate(pin.calls if pin else ()):
    out[f"route{j}"] = t.cpu().numpy()
  if len(row[4]) == 2:   # the two routes' spread: the plain version's prefill
    plain = PinnedRouting()
    plain.calls = pin.calls[:scfg.n_layers]
    batch = family_tp_serve_batch(scfg, seed + 1, req)
    memory = model.memory(batch)
    model.backend = "ref"
    with plain.replay():
      last, _ = model.prefill(batch, model.init_cache(
          req[0], req[1], memory=memory), memory)
    model.backend = "auto"
    out["prefill_plain"] = last.float().cpu().numpy()
    del batch, memory, last
  del model, logits, pin
  torch.cuda.empty_cache()
  model = Model(tcfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed + 2))
  opt = init_opt_state(model)
  step = make_train_step(model, OptConfig(lr=3e-4, total_steps=200,
                                          warmup_steps=10))
  pin = PinnedRouting() if tcfg.moe.num_experts else None
  with pin.record() if pin else contextlib.nullcontext():
    out["loss"] = np.array([float(step(opt, b)["loss"]) for b in
                            family_tp_batches(tcfg, seed + 3)])
  for j, t in enumerate(pin.calls if pin else ()):
    out[f"train_route{j}"] = t.cpu().numpy()
  del model, opt, step, pin
  torch.cuda.empty_cache()
  np.savez(os.path.join(out_dir, f"one{i}.npz"), **out)


def family_tp_shallow(mesh, scfg, seed, req, layouts):
  """The two MoE layouts' prefills at ``FAMILY_TP_SHALLOW`` layers, the
  second replaying the first's routing: (max abs error, error over the
  scale) of their last-token logits."""
  import dataclasses as dc

  import torch

  from repro_torch.models import Model, Parallelism
  cfg = dc.replace(scfg, n_layers=FAMILY_TP_SHALLOW)
  pin, last = PinnedRouting(), []
  for j, layout in enumerate(layouts):
    par = Parallelism(dp_axes=("data",), dp_size=mesh.data,
                      model_size=mesh.model, ep=layout == "ep")
    model = built(mesh, cfg, lambda: Model(
        cfg, device=mesh.device, mesh=mesh, par=par,
        generator=torch.Generator(device=DEVICE).manual_seed(seed)))
    batch = family_tp_serve_batch(cfg, seed + 1, req)
    with pin.record() if j == 0 else pin.replay():
      got, _ = model.prefill(batch, model.init_cache(req[0], req[1]))
    last.append(got.float())
    del model, batch
  check(pin.i == len(pin.calls), f"families tp {scfg.name} shallow: "
        f"{pin.i} MoE calls replayed of {len(pin.calls)}")
  torch.cuda.empty_cache()
  return errors(last[1], last[0])


TURNS_LEAF_BYTES = 1 << 31   # float32 draws past this: build in turns


def built(mesh, cfg, build):
  """``build()`` of a model of ``cfg`` on every rank of ``mesh``, its
  allocator's free blocks released after.  Every rank draws each leaf
  whole before it keeps its slice, and four ranks' transient float32
  leaves at once (grok-1's experts: 6 GiB each) would not fit the card
  beside the kept weights: where a leaf's draw passes
  ``TURNS_LEAF_BYTES`` the ranks build in turn (the others wait at a
  barrier)."""
  import torch
  import torch.distributed as dist

  from repro_torch.models.registry import param_shapes
  largest = max(4 * math.prod(s) for s in param_shapes(cfg).values())
  turns = range(mesh.world.world) if largest > TURNS_LEAF_BYTES else [None]
  out = None
  for r in turns:
    if r in (None, mesh.rank):
      out = build()
      sync()
      torch.cuda.empty_cache()
    dist.barrier()
  return out


def family_tp_serve(mesh, scfg, layout, seed, req, one):
  """One rank's serving of a ``FAMILY_TP_RUNS`` row over ``mesh``: where
  the family has flash launches or MoE layers, a greedy trace first, the
  one-process run's MoE routing replayed and every flash launch held
  against the plain version on its own inputs (``LayerAttention``), on
  the rank's rows; then one timed ``generate`` of the whole request, which
  splits its rows over the data axis (the time to its prefill's end is the
  first token's, the rest a decode step's; its flash launches counted),
  whose tokens for the rank's rows are the trace's where no routing was
  pinned.  Returns (fields,
  the prefill's logits: the trace's, else the timed run's)."""
  import torch

  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import ops
  from repro_torch.models import Model, Parallelism
  from repro_torch.serve import generate
  par = Parallelism(dp_axes=("data",), dp_size=mesh.data,
                    model_size=mesh.model, ep=layout == "ep")
  model = built(mesh, scfg, lambda: Model(
      scfg, device=mesh.device, mesh=mesh, par=par,
      generator=torch.Generator(device=DEVICE).manual_seed(seed)))
  d = mesh.coords["data"]
  rows = req[0] // mesh.data
  whole = family_tp_serve_batch(scfg, seed + 1, req)
  batch = {k: v[d * rows:(d + 1) * rows] for k, v in whole.items()}
  pin = pinned(one, "route")
  layers = LayerAttention()
  trace = None
  if pin or flash_layers(scfg):
    with pin.replay() if pin else contextlib.nullcontext(), layers.watch():
      trace = greedy_trace(model, batch, req[2])
    if pin:
      check(pin.i == len(pin.calls), f"families tp {scfg.name}: {pin.i} "
            f"MoE calls, the one-process run {len(pin.calls)}")
  # the timed run: one generate, its prefill's end marked (a device sync,
  # then the host clock and the gather counts) by a hook on the model
  marks, real = [], model.prefill

  def marked(*args, **kw):
    got = real(*args, **kw)
    sync()
    marks.append((time.perf_counter(), mesh.gathers, mesh.gather_bytes,
                  got[0]))
    return got

  model.prefill = marked
  ops.reset_launch_counts()
  tc0 = fa.tc_launches
  g0, b0 = mesh.gathers, mesh.gather_bytes
  sync()
  t0 = time.perf_counter()
  # generate splits the request's rows over the data axis itself
  out = generate(model, whole, steps=req[2])[d * rows:(d + 1) * rows]
  sync()
  wall = time.perf_counter() - t0
  del model.prefill
  flash, tc = ops.launch_counts()["flash_attention"], fa.tc_launches - tc0
  check(flash == flash_layers(scfg) and tc == flash, f"families tp "
        f"{scfg.name} {layout}: {flash} flash launches a prefill ({tc} on "
        f"tensor cores), expected {flash_layers(scfg)}")
  (t1, g1, b1, prefill), steps = marks[0], req[2] - 1
  toks = out if trace is None else trace[0]
  if trace is not None:
    prefill = trace[1][:, 0]
    # a trace with the one-process routing pinned may pick other tokens
    check(pin is not None or torch.equal(out, toks), f"families tp "
          f"{scfg.name} {layout}: the timed run's tokens are not the "
          "trace's")
  check(bool(torch.isfinite(prefill).all()), f"families tp {scfg.name}: "
        "logits not finite")
  fields = dict(
      layout=layout, ttft_s=t1 - t0,
      decode_ms_per_token=(t0 + wall - t1) / steps * 1e3,
      tokens_per_s=req[0] * req[2] / wall, wall_s=wall,
      flash_launches_a_prefill=flash, layer_attention_calls=layers.calls,
      layer_attention_max_err_over_scale=layers.worst,
      prefill_gathers=g1 - g0, prefill_gather_bytes=b1 - b0,
      decode_step_gathers=(mesh.gathers - g1) / steps,
      decode_step_gather_bytes=(mesh.gather_bytes - b1) / steps,
      tokens=toks.cpu().tolist(),
      params_a_rank=sum(p.numel() for p in model.parameters()))
  if pin:
    fields.update(routing_flips=pin.flips, routed_tokens=pin.routed,
                  free_routing_tokens_equal=int((out == toks).sum()))
  prefill = prefill.float().clone()
  del model, out, trace, marks
  torch.cuda.empty_cache()
  return fields, prefill


def pinned(one, prefix):
  """A ``PinnedRouting`` replaying the calls ``one`` recorded under
  ``prefix`` (None where there are none: no MoE)."""
  import torch
  n = sum(k.startswith(prefix) and k[len(prefix):].isdigit() for k in one)
  if not n:
    return None
  pin = PinnedRouting()
  pin.calls = [torch.as_tensor(one[f"{prefix}{j}"], device=DEVICE)
               for j in range(n)]
  return pin


def family_tp_train(mesh, tcfg, seed, one):
  """One rank's train run over ``mesh`` on its data shard of the
  batches (an MoE replaying the one-process run's routing, its forward
  and its recomputed forward alike): after each step every data
  replica's parameters and every model group's replicated leaves equal
  bit for bit (fingerprints gathered over the groups)."""
  import statistics

  import torch

  from repro_torch.models import Model
  from repro_torch.train import OptConfig, init_opt_state, make_train_step
  model = built(mesh, tcfg, lambda: Model(
      tcfg, device=mesh.device, mesh=mesh,
      generator=torch.Generator(device=DEVICE).manual_seed(seed)))
  opt = init_opt_state(model)
  step = make_train_step(model, OptConfig(lr=3e-4, total_steps=200,
                                          warmup_steps=10))
  d = mesh.coords["data"]
  names = list(model.state_dict())
  replicated = [i for i, n in enumerate(names) if n not in model.sharded]
  losses, walls, gathers, gbytes = [], [], [], []
  pin = pinned(one, "train_route")
  for i, b in enumerate(family_tp_batches(tcfg, seed + 1)):
    rows = b["tokens"].shape[0] // mesh.data
    g0, b0 = mesh.gathers, mesh.gather_bytes
    sync()
    t0 = time.perf_counter()
    with pin.replay() if pin else contextlib.nullcontext():
      m = step(opt, {k: v[d * rows:(d + 1) * rows] for k, v in b.items()})
    sync()
    walls.append(time.perf_counter() - t0)
    gathers.append(mesh.gathers - g0)
    gbytes.append(mesh.gather_bytes - b0)
    losses.append(float(m["loss"]))
    fp = torch.stack([fingerprint(p) for p in model.state_dict().values()])
    _same_rows(mesh.dp.gather_parts(fp), f"families tp {tcfg.name} step "
               f"{i}: data replicas' parameters")
    _same_rows(mesh.tp.gather_parts(fp[replicated]), f"families tp "
               f"{tcfg.name} step {i}: the model group's replicated leaves")
  if pin:
    check(pin.i == len(pin.calls), f"families tp {tcfg.name} train: "
          f"{pin.i} MoE calls, the one-process run {len(pin.calls)}")
  fields = dict(n_layers=tcfg.n_layers, d_model=tcfg.d_model,
                dtype=tcfg.dtype, loss=losses, step_wall_s=walls,
                ms_per_step=statistics.median(walls) * 1e3,
                step_gathers=gathers, step_gather_bytes=gbytes,
                params_a_rank=sum(p.numel() for p in model.parameters()),
                replicated_leaves=len(replicated), leaves=len(names),
                **(dict(routing_flips=pin.flips, routed_tokens=pin.routed)
                   if pin else {}))
  del model, opt, step
  torch.cuda.empty_cache()
  return fields


def families_tp_rank(out_dir: str) -> None:
  """One rank of e2e families tp (``chip_smoke.py --families-tp DIR``
  under torchrun, 4 gloo ranks on the card): every ``FAMILY_TP_RUNS`` row
  over its mesh, serving then training, against the one-process runs in
  DIR/one<i>.npz; writes DIR/rank<r>.json."""
  sys.path.insert(0, str(SRC))
  import repro_torch.models  # noqa: F401  (torch._dynamo, off model frames)
  import numpy as np
  import torch

  from repro_torch import no_tf32
  from repro_torch.launch.mesh import TrainMesh
  no_tf32()
  base = TrainMesh.from_env((FAMILY_TP_RANKS, 1), "gloo", DEVICE)
  wait_for(os.path.join(out_dir, "one.ready"), 900)
  res = {}
  for i, row in enumerate(FAMILY_TP_RUNS):
    arch, shape, sl, req, layouts, tl = row
    scfg, tcfg = family_tp_cfgs(arch, sl, tl)
    seed = FAMILY_TP_SEED + 10 * i
    one = dict(np.load(os.path.join(out_dir, f"one{i}.npz")))
    mesh = TrainMesh.over(*shape, base.rank, base.device, "gloo")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve, prefills, t1 = [], {}, time.perf_counter()
    for layout in layouts:
      fields, prefills[layout] = family_tp_serve(mesh, scfg, layout, seed,
                                                 req, one)
      _note(base, f"{arch} {layout} served")
      d, rows = mesh.coords["data"], req[0] // mesh.data
      want = torch.as_tensor(one["prefill"][d * rows:(d + 1) * rows],
                             device=DEVICE)
      fields.update(errors=dict(zip(("prefill_vs_one_max_abs_err",
                                     "prefill_vs_one_err_over_scale"),
                                    errors(prefills[layout], want))))
      serve.append(fields)
    if len(layouts) == 2:
      layout_err = errors(prefills[layouts[1]], prefills[layouts[0]])
      shallow_err = family_tp_shallow(mesh, scfg, seed, req, layouts)
      serve[0]["layouts"] = dict(zip((
          "prefill_max_abs_err", "prefill_err_over_scale",
          "shallow_prefill_max_abs_err", "shallow_prefill_err_over_scale"),
          layout_err + shallow_err), shallow_layers=FAMILY_TP_SHALLOW)
    del prefills
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    serve_s, t1 = time.perf_counter() - t1, time.perf_counter()
    train = family_tp_train(mesh, tcfg, seed + 2, one)
    _note(base, f"{arch} trained")
    res[arch] = dict(mesh=f"{shape[0]}x{shape[1]}", serve=serve, train=train,
                     serve_s=serve_s, train_s=time.perf_counter() - t1,
                     serve_peak_gib=serve_peak,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     wall_s=time.perf_counter() - t0)
    print(f"[families tp rank {base.rank}] {arch} done "
          f"{res[arch]['wall_s']:.1f} s, peak {res[arch]['peak_gib']:.2f} "
          "GiB", file=sys.stderr, flush=True)
  # (b) of e2e layouts: the data axes' serving layouts
  t0 = time.perf_counter()
  arch, shape, layers, req = LAYOUTS_MOE
  moe = layouts_serve(base, arch, shape, layers, req, LAYOUTS_SEED,
                      ep_pod=True)
  arch, shape, req = LAYOUTS_LONG
  long = layouts_serve(base, arch, shape, None, req, LAYOUTS_SEED + 10)
  res["layouts"] = dict(moe=moe, long=long,
                        serve_s=time.perf_counter() - t0)
  with open(os.path.join(out_dir, f"rank{base.rank}.json"), "w") as f:
    json.dump(res, f)
  base.close()


def e2e_families_tp(sz):
  """The model axis of every family (``FAMILY_TP_RUNS``) at full width
  over 4 gloo ranks on this card, in one torchrun launch
  (``chip_smoke.py --families-tp DIR``), beside one-process runs of the
  same depths, seeds and inputs made here first (``family_tp_one``).

  Serving, each layout: greedy tokens equal the one-process run's up to
  the first bf16 near-tie (a top-2 gap below ``TOL_SERVE_GAP`` in the
  one-process run; the MoE routing replayed from it), every flash launch
  within 3e-2 of its plain version on its own inputs at the rank's heads,
  one launch a causal, unwindowed layer a prefill; deepseek-moe-16b's TP
  and ep prefill logits within ``TOL_SERVE_BF16`` of their scale at
  ``FAMILY_TP_SHALLOW`` layers, and at 28 no further apart than
  ``TOL_F32_RATIO`` times one process's kernel and plain routes.
  Training (an MoE replaying the one-process run's routing): after each
  step every data replica's parameters and every model group's replicated
  leaves equal bit for bit, each loss within ``TOL_TRAIN_EVAL`` of the
  one-process run's.  One line an arch: first
  token, ms a token, ms a step, each rank's peak, the all-gathers and
  their bytes (a prefill, a decode step, a train step), the flash
  launches a prefill.  Returns rank 0's flash launches by path."""
  import statistics

  import numpy as np
  import torch
  (REPO / "build").mkdir(exist_ok=True)
  t_phase = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
    # the ranks start up (processes, CUDA, the group) while the
    # one-process runs go; they wait for DIR/one.ready before a model
    launch = torchrun_async([str(REPO / "chip_smoke.py"), "--families-tp",
                             tmp], timeout=900)
    one_s = []
    for i, row in enumerate(FAMILY_TP_RUNS):
      t0 = time.perf_counter()
      family_tp_one(tmp, i, row)
      one_s.append(time.perf_counter() - t0)
      print(f"[smoke] families tp one process {row[0]}: {one_s[-1]:.1f} s",
            file=sys.stderr, flush=True)
    Path(tmp, "one.ready").touch()
    wall, _ = launch.result()
    ones = [dict(np.load(os.path.join(tmp, f"one{i}.npz")))
            for i in range(len(FAMILY_TP_RUNS))]
    ranks = []
    for r in range(FAMILY_TP_RANKS):
      with open(os.path.join(tmp, f"rank{r}.json")) as f:
        ranks.append(json.load(f))
  counts = {}
  for i, (arch, shape, sl, req, layouts, tl) in enumerate(FAMILY_TP_RUNS):
    one = ones[i]
    scfg, tcfg = family_tp_cfgs(arch, sl, tl)
    per = [rk[arch] for rk in ranks]
    rows = req[0] // shape[0]
    agree = []
    for j, layout in enumerate(layouts):
      equal, first = 0, []
      for r, p in enumerate(per):
        mine = slice(r // shape[1] * rows, (r // shape[1] + 1) * rows)
        got, want = np.asarray(p["serve"][j]["tokens"]), one["tokens"][mine]
        near = one["gaps"][mine] < TOL_SERVE_GAP
        tie = np.where(near.any(1), near.argmax(1), req[2])
        upto = np.arange(req[2])[None, :] < tie[:, None]
        check(got.shape == want.shape and bool(((got == want) | ~upto).all()),
              f"families tp {arch} {layout} rank {r}: greedy tokens differ "
              "from one process's before the first near-tie")
        check(int(got.min()) >= 0 and int(got.max()) < scfg.vocab,
              f"families tp {arch} {layout} rank {r}: bad tokens")
        equal += int((got == want).sum())
        first.append(tie.tolist())
      agree.append(dict(rank_steps_before_near_tie=first,
                        tokens_equal=equal,
                        tokens_total=int(one["tokens"].size * shape[1])))
      counts[f"families_tp_{arch}_{layout}"] = {
          "flash_attention": per[0]["serve"][j]["flash_launches_a_prefill"]}
    if len(layouts) == 2:   # the layouts against the two routes' spread
      spread = errors(*(torch.as_tensor(one[k]) for k in (
          "prefill", "prefill_plain")))[1]
      for r, p in enumerate(per):
        lay = p["serve"][0]["layouts"]
        check(lay["shallow_prefill_err_over_scale"] <= TOL_SERVE_BF16,
              f"families tp {arch} rank {r}: the {layouts} prefill logits at "
              f"{FAMILY_TP_SHALLOW} layers {lay} apart")
        check(lay["prefill_err_over_scale"] <= TOL_F32_RATIO * spread,
              f"families tp {arch} rank {r}: the {layouts} prefill logits "
              f"{lay['prefill_err_over_scale']} of their scale apart, one "
              f"process's kernel and plain routes {spread}")
      per[0]["serve"][0]["layouts"]["one_process_routes_err_over_scale"] = \
          spread
    for r, p in enumerate(per):
      gap = max(abs(a - b) for a, b in zip(p["train"]["loss"], one["loss"]))
      check(all(x == x for x in p["train"]["loss"]) and
            gap <= TOL_TRAIN_EVAL, f"families tp {arch} train rank {r}: "
            f"losses {p['train']['loss']}, one process {one['loss'].tolist()}")
    serve = [dict({k: v for k, v in per[0]["serve"][j].items()
                   if k != "tokens"},
                  ttft_s=max(p["serve"][j]["ttft_s"] for p in per),
                  decode_ms_per_token=max(p["serve"][j]["decode_ms_per_token"]
                                          for p in per),
                  **agree[j]) for j in range(len(layouts))]
    train = dict(per[0]["train"], ms_per_step=statistics.median(
        max(p["train"]["step_wall_s"][s] for p in per)
        for s in range(FAMILY_TP_TRAIN[2])) * 1e3, one_process_loss=one[
            "loss"].tolist(), max_loss_gap=max(
                abs(a - b) for p in per for a, b in zip(p["train"]["loss"],
                                                        one["loss"])))
    emit(f"e2e families tp {arch}", arch=arch, mesh=per[0]["mesh"],
         ranks=FAMILY_TP_RANKS, backend="gloo, one card",
         d_model=scfg.d_model, serve_layers=scfg.n_layers, dtype=scfg.dtype,
         batch=req[0], prompt=req[1], new_tokens=req[2], serve=serve,
         train=dict(train, batch=FAMILY_TP_TRAIN[0], seq=FAMILY_TP_TRAIN[1]),
         rank_peak_gib=[p["peak_gib"] for p in per],
         rank_serve_peak_gib=[p["serve_peak_gib"] for p in per],
         rank_wall_s=[p["wall_s"] for p in per],
         rank_serve_s=[p["serve_s"] for p in per],
         rank_train_s=[p["train_s"] for p in per], one_process_s=one_s[i],
         tol=dict(bf16=TOL_SERVE_BF16, gap=TOL_SERVE_GAP,
                  loss=TOL_TRAIN_EVAL),
         reduced=[r for r in (
             None if sl is None else f"serve n_layers {scfg.n_layers} of "
             f"{family_tp_cfgs(arch, None, None)[0].n_layers}",
             "train at the reduced width" if tl == "reduced" else None
             if tl is None else f"train n_layers {tl}") if r])
  emit("e2e families tp", one_process_s=sum(one_s), launch_wall_s=wall,
       phase_s=time.perf_counter() - t_phase,
       layouts_serve_s=[rk["layouts"]["serve_s"] for rk in ranks])
  return counts, [rk["layouts"] for rk in ranks]


# ---------------------------------------------------------------------------
# the layouts of the dry run: e2e layouts
# ---------------------------------------------------------------------------

# (a) rides in e2e train dist's ranks, (b) in e2e families tp's
LAYOUTS_RANKS = 4
# (b): deepseek-moe-16b's 2 layers over pod 2 x data 1 x model 2 under
# ep_pod, a row a pod; the prompt a whole MoE group a row (group_size 512),
# so a pod routes its row's groups as one process routes the batch's
LAYOUTS_MOE = ("deepseek-moe-16b", (2, 1, 2), 2, (2, 512, 8))
# recurrentgemma-2b at batch 1 over 2x2, its cache split by length over
# the 2 data ranks: a prompt of 2048 (its local attention takes whole
# 1024-query chunks) filling the 2048-row window, then 16 new tokens past it
LAYOUTS_LONG = ("recurrentgemma-2b", (2, 2), (1, 2048, 16))
LAYOUTS_SEED = 1300
DRYRUN_JOBS = 5        # the dry run's processes, beside the smoke's phases
_DRYRUN = {}


_ANALYSIS = {}


def analysis_start() -> None:
  """``python -m repro_torch.analysis --ranks 2`` in a process group of its
  own from the build's end, beside the edge phases (which time nothing):
  its sync debug mode and its two gloo ranks stay apart from this
  process's."""
  out = REPO / "build" / "smoke_analysis.json"
  if out.exists():
    out.unlink()
  log = open(REPO / "build" / "smoke_analysis.log", "w")
  _ANALYSIS.update(out=out, log=log, t0=time.perf_counter(),
                   at_s=time.perf_counter() - STARTED, proc=subprocess.Popen(
      [sys.executable, "-m", "repro_torch.analysis", str(SRC / "repro_torch"),
       "--repo-root", str(REPO), "--baseline",
       str(REPO / "analysis_baseline_torch.json"), "--ranks", "2", "--json",
       str(out)], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(SRC)),
      stdout=log, stderr=subprocess.STDOUT, process_group=0))


def analysis_stop() -> None:
  """Stop the analyzer's process group if it still runs (a failed smoke)."""
  proc = _ANALYSIS.get("proc")
  if proc is not None and proc.poll() is None:
    os.killpg(proc.pid, 9)
    proc.wait()


def analysis_phase(timeout: float = 300) -> None:
  """Wait for the analyzer (phase ``analysis``): every registered entry
  on the CUDA routes, no new finding; one line with the entries run, the
  findings, the analyzer's seconds (beside the edge phases, from
  ``at_s``) and each entry's host syncs a call ([dispatch count, sync
  debug mode, budget])."""
  proc = _ANALYSIS["proc"]
  try:
    proc.wait(timeout=timeout)
  except subprocess.TimeoutExpired:
    analysis_stop()
    raise SmokeFailure(f"analysis: no end in {timeout} s more")
  _ANALYSIS["log"].close()
  wall = time.perf_counter() - _ANALYSIS["t0"]
  text = (REPO / "build" / "smoke_analysis.log").read_text()
  check(proc.returncode == 0,
        f"analysis: exit {proc.returncode}:\n{text[-4000:]}")
  report = json.loads(_ANALYSIS["out"].read_text())
  check(not report["new"] and not report["skipped"],
        f"analysis: {report['new']} {report['skipped']}")
  entries = report["entries"]
  check(len(entries) == 31, f"analysis: {len(entries)} entries run")
  emit("analysis", entries=len(entries), findings=len(report["new"]),
       suppressed=report["suppressed"], seconds=report["seconds"],
       wall_s=wall, started_at_s=_ANALYSIS["at_s"],
       syncs={name: [e["syncs"], e["debug_syncs"], e["budget"]]
              for name, e in entries.items()},
       summary=[ln for ln in text.splitlines() if "new finding" in ln][-1])


def dryrun_start() -> None:
  """``python -m repro_torch.launch.dryrun --mesh both`` in the background
  (the host only, ``DRYRUN_JOBS`` processes in the idle scheduling class)
  from the build's end;
  it is stopped while a phase runs ranks of its own, and while the
  one-process training and serving phases are timed (``dryrun_paused``),
  and ``e2e layouts`` collects it."""
  (REPO / "build").mkdir(exist_ok=True)
  out = REPO / "build" / "smoke_dryrun.jsonl"
  if out.exists():
    out.unlink()
  log = open(REPO / "build" / "smoke_dryrun.log", "w")
  _DRYRUN.update(out=out, log=log, t0=time.perf_counter(), paused=0.0,
                 t0_wall=time.time(), at_s=time.perf_counter() - STARTED,
                 proc=subprocess.Popen(
      [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
       "--jobs", str(DRYRUN_JOBS), "--out", str(out)], cwd=REPO,
      env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""),
      stdout=log, stderr=subprocess.STDOUT, preexec_fn=_idle,
      process_group=0))


def _idle() -> None:
  """The dry run's scheduling: the idle class (its processes run only on
  cores nothing else wants), the lowest priority where that is refused."""
  os.nice(19)
  try:
    os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
  except (AttributeError, OSError):
    pass


@contextlib.contextmanager
def dryrun_paused():
  """The dry run's processes stopped (SIGSTOP to its process group) for
  the span of a phase whose ranks need the host's cores, then continued."""
  import signal
  proc = _DRYRUN.get("proc")
  live = proc is not None and proc.poll() is None
  if live:
    os.killpg(proc.pid, signal.SIGSTOP)
  t0 = time.perf_counter()
  try:
    yield
  finally:
    if live and proc.poll() is None:
      os.killpg(proc.pid, signal.SIGCONT)
      _DRYRUN["paused"] += time.perf_counter() - t0


def dryrun_stop() -> None:
  """Stop the dry run's process group if it is still running (a failed
  smoke)."""
  proc = _DRYRUN.get("proc")
  if proc is not None and proc.poll() is None:
    os.killpg(proc.pid, 9)
    proc.wait()


def dryrun_collect(timeout: float = 600) -> dict:
  """Wait for the dry run; every record written, none failed."""
  proc = _DRYRUN["proc"]
  try:
    proc.wait(timeout=timeout)
  except subprocess.TimeoutExpired:
    dryrun_stop()
    raise SmokeFailure(f"dryrun: no end in {timeout} s more")
  _DRYRUN["log"].close()
  wall = time.perf_counter() - _DRYRUN["t0"]
  # when its last record was written, on the smoke's clock (at_s)
  ended = _DRYRUN["at_s"] + os.path.getmtime(_DRYRUN["out"]) - _DRYRUN[
      "t0_wall"]
  text = (REPO / "build" / "smoke_dryrun.log").read_text()
  check(proc.returncode == 0 and "records OK" in text,
        f"dryrun exited {proc.returncode}: {text[-3000:]}")
  recs = [json.loads(line) for line in
          _DRYRUN["out"].read_text().splitlines()]
  check(len(recs) == 68, f"dryrun: {len(recs)} records, expected 68")
  fields = ("arch", "shape", "mesh", "chips", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "mem")
  for r in recs:
    check(all(f in r for f in fields) and r["flops_per_device"] > 0,
          f"dryrun record {r.get('arch')} {r.get('shape')}: {r}")
  grok = [r for r in recs if r["arch"] == "grok-1-314b" and
          r["shape"] == "train_4k" and r["mesh"] == "2x16x16"]
  check(len(grok) == 1, "dryrun: no grok-1-314b train_4k 2x16x16 record")
  return dict(records=len(recs), wall_s=wall, paused_s=_DRYRUN["paused"],
              started_at_s=_DRYRUN["at_s"], ended_at_s=ended,
              jobs=DRYRUN_JOBS, summary=text.strip().splitlines()[-1],
              grok=grok[0])


def layouts_reckoning() -> dict:
  """Per-rank bytes of qwen3-4b at full depth on a 4x1 mesh, FSDP against
  none: parameters (bf16) and AdamW's two float32 moments, from the leaf
  shapes and specs alone (nothing runs: a gloo gather moves about 200
  MB/s, so a deep FSDP step would take the phase's budget)."""
  import torch

  from repro_torch.configs import get_config
  from repro_torch.launch.mesh import ProcessMesh, TrainMesh
  from repro_torch.models.registry import (mesh_parallelism, param_shapes,
                                           param_specs)
  cfg = get_config("qwen3-4b")
  cpu = torch.device("cpu")
  one = ProcessMesh(1, 0, 1, cpu, "gloo")
  mesh = TrainMesh(4, 1, 0, cpu, "gloo", one, one, one)
  out = {}
  for tag, kw in (("plain", {}), ("fsdp", dict(fsdp=True))):
    specs = param_specs(cfg, mesh_parallelism(cfg, mesh, **kw))
    n = sum(math.prod(mesh.local_shape(sh, specs[k]))
            for k, sh in param_shapes(cfg).items())
    out[tag] = dict(params_a_rank=n, param_gib=n * 2 / 2**30,
                    opt_gib=n * 8 / 2**30, total_gib=n * 10 / 2**30)
  out["ratio"] = out["fsdp"]["total_gib"] / out["plain"]["total_gib"]
  return dict(arch=cfg.name, n_layers=cfg.n_layers, mesh="4x1", **out)


def layouts_train(base, plain, twin, batches, opt_cfg):
  """(a) of e2e layouts, in a train dist rank beside the 2x2 run
  (``TRAIN_DIST_CKPT_FROM``: ``plain`` its (model, optimizer state, mesh)
  after its steps, ``twin`` its fields): qwen3-4b at full width, the same
  depth over 2x2 with fsdp and seq_shard, the same steps on the same
  batches from the same seed.  Each leaf's shard, and its shard of both
  AdamW moments (float32: what carries the gradient, where a bf16 update
  below half an ulp leaves the weight as it was), against the same part
  of the 2x2 run's, and each step's loss and grad norm against its; the
  parameter and optimizer bytes of every FSDP leaf, which must be half
  the 2x2 rank's."""
  import torch

  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.models import Model
  from repro_torch.models.registry import (mesh_parallelism, param_shapes,
                                           param_specs)
  from repro_torch.train import init_opt_state, make_train_step
  pmodel, popt, _ = plain
  cfg = pmodel.cfg
  dev = base.device
  mesh = TrainMesh.over(2, 2, base.rank, dev, base.backend)
  par = mesh_parallelism(cfg, mesh, fsdp=True, seq_shard=True)
  model = Model(cfg, device=dev, mesh=mesh, par=par,
                generator=torch.Generator(device=dev).manual_seed(42))
  opt = init_opt_state(model)
  step = make_train_step(model, opt_cfg)
  d, rows = mesh.coords["data"], batches[0]["tokens"].shape[0] // mesh.data
  losses, norms, walls, gathers = [], [], [], []
  for b in batches:
    g0 = mesh.gathers
    sync()
    t0 = time.perf_counter()
    m = step(opt, {k: v[d * rows:(d + 1) * rows] for k, v in b.items()})
    sync()
    walls.append(time.perf_counter() - t0)
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    gathers.append(mesh.gathers - g0)
  want_leaves = pmodel.state_dict()
  differ = {"params": [], "mu": [], "nu": []}
  worst = dict.fromkeys(differ, 0.0)
  for n, p in model.state_dict().items():
    spec = tuple(e if any(dd == i for dd, _ in model.fsdp.get(n, ()))
                 else None for i, e in enumerate(model.specs[n]))
    for what, got, want in (("params", p, want_leaves[n]),
                            ("mu", opt.mu[n], popt.mu[n]),
                            ("nu", opt.nu[n], popt.nu[n])):
      want = mesh.local(want, spec)
      if not torch.equal(got, want):
        differ[what].append(n)
        worst[what] = max(worst[what], float(
            (got.float() - want.float()).abs().max()))
  plain_specs = param_specs(cfg, mesh_parallelism(cfg, mesh))
  shapes = param_shapes(cfg)
  halves = [2 * p.numel() == math.prod(mesh.local_shape(
      shapes[n], plain_specs[n])) and opt.mu[n].numel() == p.numel()
            for n, p in model.named_parameters() if n in model.fsdp]
  res = dict(mesh="2x2", n_layers=cfg.n_layers, fsdp_leaves=len(model.fsdp),
             leaves=len(model.specs), loss=losses, grad_norm=norms,
             plain_loss=twin["loss"], plain_grad_norm=twin["grad_norm"],
             step_wall_s=walls, step_gathers=gathers,
             leaves_differing=differ, max_abs_diff=worst,
             fsdp_leaves_halved=bool(halves) and all(halves),
             fsdp_leaf_bytes_a_rank=sum(
                 p.numel() * (p.element_size() + 8)
                 for n, p in model.named_parameters() if n in model.fsdp))
  del model, opt, step, want_leaves
  torch.cuda.empty_cache()
  return res


def layouts_serve(base, arch, shape, layers, req, seed, **chosen):
  """One layout's greedy run over a mesh of ``shape`` through
  ``generate`` (a batch of rows split by rows over the data axes, a batch
  of one by cache length), every flash launch held against its plain
  version on its own inputs; rank 0 also runs one process on the same
  seed and request (its tokens and top-2 gaps).  Returns the fields."""
  import dataclasses as dc

  import torch

  from repro_torch.configs import get_config
  from repro_torch.kernels import ops
  from repro_torch.launch.mesh import TrainMesh
  from repro_torch.models import Model
  from repro_torch.models.registry import mesh_parallelism
  from repro_torch.models.transformer import KVSplit, cache_len
  from repro_torch.serve import generate
  cfg = get_config(arch)
  if layers:
    cfg = dc.replace(cfg, n_layers=layers)
  *pod, data, model_ax = shape
  mesh = TrainMesh.over(data, model_ax, base.rank, base.device, "gloo",
                        pod=pod[0] if pod else None)
  par = mesh_parallelism(cfg, mesh, **chosen)
  model = built(mesh, cfg, lambda: Model(
      cfg, device=mesh.device, mesh=mesh, par=par,
      generator=torch.Generator(device=DEVICE).manual_seed(seed)))
  batch = family_tp_serve_batch(cfg, seed + 1, req)
  layers_att = LayerAttention()
  # the logits of each step generate takes, the rank's rows
  logits, real = [], (model.prefill, model.decode_step)

  def kept(fn):
    def call(*args, **kw):
      out = fn(*args, **kw)
      logits.append(out[0].float())
      return out
    return call

  model.prefill, model.decode_step = kept(real[0]), kept(real[1])
  ops.reset_launch_counts()
  g0, b0 = mesh.gathers, mesh.gather_bytes
  sync()
  t0 = time.perf_counter()
  with layers_att.watch():
    toks = generate(model, batch, steps=req[2])
  sync()
  wall = time.perf_counter() - t0
  del model.prefill, model.decode_step
  mine = torch.stack(logits, dim=1)   # (rows, steps, V)
  split = None
  if req[0] == 1 and mesh.dp_size > 1:   # the length split's slots
    c = model.init_cache(1, req[1] + req[2], kv_split=KVSplit(mesh.dp))
    split = dict(rank_rows=next(x["k"].shape[2] for x in c if "k" in x),
                 rows=cache_len(cfg, req[1] + req[2]))
    del c
    # the same mesh with every data rank holding the whole cache: the
    # length split's own effect on the logits, apart from the model axis's
    with torch.no_grad():
      wtoks, wlogits = greedy_trace(model, batch, req[2])
    split["logits_err_over_scale"] = _errs_while_same(mine, toks, wlogits,
                                                      wtoks)
    del wlogits
  flash = ops.launch_counts()["flash_attention"]
  res = dict(arch=arch, mesh="x".join(map(str, shape)), layers=cfg.n_layers,
             layout=sorted(k for k, v in chosen.items() if v),
             batch=req[0], prompt=req[1], new_tokens=req[2], wall_s=wall,
             tokens=toks.cpu().tolist(), flash_launches=flash,
             layer_attention_calls=layers_att.calls,
             layer_attention_max_err_over_scale=layers_att.worst,
             gathers=mesh.gathers - g0, gather_bytes=mesh.gather_bytes - b0,
             cache_split=split, moe_pod_exchange=model.pod is not None)
  del model
  torch.cuda.empty_cache()
  if base.rank == 0:
    one = Model(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
    with torch.no_grad():
      otoks, ologits = greedy_trace(one, batch, req[2])
    res["one"] = dict(tokens=otoks.cpu().tolist(),
                      gaps=top2_gap(ologits).cpu().tolist(),
                      logits_err_over_scale=_errs_while_same(
                          mine, toks, ologits, otoks))
    if split is not None:
      res["one"]["f32"] = layouts_f32_witness(one, batch, mine[:, 0],
                                              ologits[:, 0])
    del one, ologits
    torch.cuda.empty_cache()
  return res


def layouts_f32_witness(one, batch, mesh_first, one_first) -> dict:
  """The prefill of ``batch`` by a float32 model holding the bf16
  one-process model ``one``'s values: the mesh's bf16 prefill logits
  (``mesh_first``) against it, and one process's (``one_first``).  The
  mesh's distance from one process is then bf16 rounding, not the
  layout, if the mesh is no further from the float32 logits than
  ``TOL_F32_RATIO`` times one process is (measured at the reduced size on
  the CPU: 0.70-1.15 over 8 draws)."""
  import dataclasses as dc

  import torch

  from repro_torch.models import Model
  m32 = Model(dc.replace(one.cfg, dtype="float32"), device=DEVICE,
              generator=torch.Generator(device=DEVICE).manual_seed(0))
  with torch.no_grad():
    for (n, p), (n1, q) in zip(m32.named_parameters(),
                               one.named_parameters()):
      check(n == n1 and p.shape == q.shape, f"f32 witness: {n} / {n1}")
      p.copy_(q)
    _, ref = greedy_trace(m32, batch, 1)
  del m32
  torch.cuda.empty_cache()
  mesh_err = errors(mesh_first, ref[:, 0])[1]
  one_err = errors(one_first, ref[:, 0])[1]
  return dict(mesh_vs_f32=mesh_err, one_vs_f32=one_err,
              ratio=mesh_err / max(one_err, 1e-30), ratio_tol=TOL_F32_RATIO)


def _errs_while_same(mine, toks, ref, ref_toks):
  """Each step's logits of ``mine`` (a rank's first rows, (rows, steps,
  V)) against ``ref``'s same rows, error over their scale, for the steps
  whose tokens fed so far are the same in both runs (the prefill's
  always)."""
  rows = mine.shape[0]
  same = (toks[:rows].to(ref_toks.device) == ref_toks[:rows]).all(0).tolist()
  upto = same.index(False) + 1 if False in same else len(same)
  return [errors(mine[:, t], ref[:rows, t])[1] for t in range(upto)]


def _agree_upto_tie(got, one, what):
  """Greedy tokens equal one process's up to each row's first bf16
  near-tie (a top-2 gap below ``TOL_SERVE_GAP`` in the one-process run);
  returns each row's steps before it."""
  import numpy as np
  got, want = np.asarray(got), np.asarray(one["tokens"])
  gaps = np.asarray(one["gaps"])
  near = gaps < TOL_SERVE_GAP
  tie = np.where(near.any(1), near.argmax(1), want.shape[1])
  upto = np.arange(want.shape[1])[None, :] < tie[:, None]
  check(got.shape == want.shape and bool(((got == want) | ~upto).all()),
        f"{what}: greedy tokens differ from one process's before the first "
        "near-tie")
  return tie.tolist()


def e2e_layouts(train: list, serve_ranks: list):
  """The layouts of the dry run on the card, 4 gloo ranks, bf16, flash at
  the rank's heads; their runs ride in the launches of ``e2e train dist``
  ((a), ``train``: each rank's ``layouts_train``) and ``e2e families tp``
  ((b), ``serve_ranks``: each rank's ``layouts_serve`` results), which
  saves a launch's start-up; the dry run ran on the host beside the
  smoke.

  (a) qwen3-4b at full width, 2 layers, 2x2 with fsdp and seq_shard, two
      steps: every leaf's shard and its shards of both float32 AdamW
      moments equal the same part of e2e train dist's 2x2 run from the
      same seed and batches bit for bit, and so do each step's loss and
      grad norm (the FSDP reduce-scatter folds in the sum's rank order;
      sequence sharding reduce-scatters the same sums, and in bf16
      autograd adds each activation's gradient contributions in the same
      order in both runs: ``tests/test_torch_layouts.py`` holds the same
      check on the CPU, and a gradient from half the batch fails it);
      every FSDP leaf's parameter and moments half of the 2x2 rank's; and
      the reckoning of a 4x1 FSDP rank at full depth (printed, not run).
  (b) deepseek-moe-16b's 2 layers over pod 2 x data 1 x model 2 with
      ep_pod (set, not chosen: at M = 2 the reference picks ep), a row a
      pod; recurrentgemma-2b at batch 1 over 2x2, its cache split by length
      over the 2 data ranks and decoding past its window: greedy tokens
      equal one process's up to the first bf16 near-tie; the logits of
      every step whose tokens so far agree (the prefill's always) within
      ``TOL_SERVE_BF16`` of their scale: the MoE's (rank 0's rows) of one
      process's, the length split's (every rank) of the same mesh's with
      the whole cache on every data rank; the length split's prefill no
      further from a float32 model of the same weights than
      ``TOL_F32_RATIO`` times one process's (``layouts_f32_witness``);
      every flash launch within 3e-2 of its plain version on its own
      inputs.
  (c) ``launch/dryrun.py --mesh both``: 68 records, no failure; its wall
      and grok-1-314b's train_4k 2x16x16 record on an earlier line.

  Returns rank 0's flash launches of (b)'s MoE run (its prefill's; the
  decode steps' none)."""
  t_phase = time.perf_counter()
  reckon = layouts_reckoning()
  print("[smoke] e2e layouts reckoning " + json.dumps(reckon), flush=True)
  dry = dryrun_collect()
  print("[smoke] e2e layouts dryrun " + json.dumps(dry), flush=True)
  for r, t in enumerate(train):
    for what, names in t["leaves_differing"].items():
      check(not names, f"layouts train rank {r}: {what} of {len(names)} "
            f"leaves differ from the 2x2 run's (max abs "
            f"{t['max_abs_diff'][what]}): {names[:5]}")
    check(t["loss"] == t["plain_loss"] and
          t["grad_norm"] == t["plain_grad_norm"], f"layouts train rank {r}: "
          f"losses {t['loss']} and norms {t['grad_norm']} against the 2x2 "
          f"run's {t['plain_loss']} and {t['plain_grad_norm']}")
    check(t["fsdp_leaves_halved"] and t["fsdp_leaves"] > 0, f"layouts "
          f"train rank {r}: an FSDP leaf is not half the 2x2 rank's")
  serve = {}
  for key in ("moe", "long"):
    per = [rk[key] for rk in serve_ranks]
    one = per[0]["one"]
    ties = [_agree_upto_tie(p["tokens"], one, f"layouts {key} rank {r}")
            for r, p in enumerate(per)]
    for r, p in enumerate(per):
      check(p["flash_launches"] == p["layer_attention_calls"],
            f"layouts {key} rank {r}: {p['flash_launches']} flash launches, "
            f"{p['layer_attention_calls']} held against the plain version")
    if per[0]["cache_split"]:
      sp = per[0]["cache_split"]
      check(sp["rank_rows"] * 2 == sp["rows"], f"layouts {key}: a rank "
            f"holds {sp['rank_rows']} of {sp['rows']} cache rows")
    # the rows split against one process; the length split against the
    # same mesh holding the whole cache on every data rank, and the mesh
    # against one process through a float32 witness (the model axis's
    # bf16 partial sums move recurrentgemma-2b's 26 layers' logits a few
    # % of their scale from one process's)
    if per[0]["cache_split"]:
      errs = [p["cache_split"]["logits_err_over_scale"] for p in per]
      against = "the mesh without the length split, every rank"
      f32 = one["f32"]
      check(f32["ratio"] <= TOL_F32_RATIO, f"layouts {key}: the mesh's "
            f"prefill is {f32['mesh_vs_f32']} of the scale from a float32 "
            f"model of the same weights, one process {f32['one_vs_f32']} "
            f"(ratio tol {TOL_F32_RATIO})")
    else:
      errs = [one["logits_err_over_scale"]]
      against = "one process, rank 0"
    check(all(e and max(e) <= TOL_SERVE_BF16 for e in errs), f"layouts "
          f"{key}: logits {errs} of their scale from {against}'s (tol "
          f"{TOL_SERVE_BF16})")
    serve[key] = dict({k: v for k, v in per[0].items()
                       if k not in ("tokens", "one")},
                      rank_steps_before_near_tie=ties,
                      logits_err_over_scale=errs, logits_against=against,
                      one_process_logits_err_over_scale=one[
                          "logits_err_over_scale"],
                      f32_witness=one.get("f32"),
                      rank_wall_s=[p["wall_s"] for p in per])
  check(serve["moe"]["moe_pod_exchange"], "layouts moe: no pod exchange")
  check(serve["moe"]["flash_launches"] == LAYOUTS_MOE[2], f"layouts moe: "
        f"{serve['moe']['flash_launches']} flash launches, expected "
        f"{LAYOUTS_MOE[2]} (a prefill)")
  emit("e2e layouts", ranks=LAYOUTS_RANKS, backend="gloo, one card",
       train=dict(train[0], rank_loss=[t["loss"] for t in train],
                  rank_leaves_differing=[
                      {k: len(v) for k, v in t["leaves_differing"].items()}
                      for t in train],
                  rank_phase_s=[t["phase_s"] for t in train]),
       serve=serve, rank_serve_s=[rk["serve_s"] for rk in serve_ranks],
       dryrun={k: dry[k] for k in ("records", "wall_s", "paused_s",
                                   "started_at_s", "ended_at_s")},
       phase_s=time.perf_counter() - t_phase)
  return {"layouts_ep_pod": {"flash_attention": serve["moe"][
      "flash_launches"]}}


# ---------------------------------------------------------------------------


def gpu_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
  return out.stdout.strip().splitlines()[0]


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available; this check runs only on a GPU",
          file=sys.stderr)
    return 2
  if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
    print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
          "the root of a checkout", file=sys.stderr)
    return 2
  t_start = time.perf_counter()
  sys.path.insert(0, str(SRC))
  # first here: it imports torch._dynamo, whose import keeps the frames on
  # the stack alive (models/registry.py); no phase's frame is on it now
  import repro_torch.models  # noqa: F401
  from repro_torch import no_tf32
  from repro_torch.kernels import build
  no_tf32()
  sz = Sizes()
  gpu = gpu_line()
  print(gpu, flush=True)
  emit("setup", torch=torch.__version__, cuda=torch.version.cuda,
       device=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), python=sys.version.split()[0])
  t0 = time.perf_counter()
  build.build()
  emit("build", seconds=time.perf_counter() - t0,
       nvcc_seconds=build.build_seconds)
  dryrun_start()
  analysis_start()
  for line in build.ptxas_report().splitlines():
    print(f"[smoke] ptxas {line}", flush=True)

  edge_phase()
  pairwise_edge_phase()
  ig_edge_phase()
  cov_edge_phase()
  cut_edge_phase()
  flash_edge_phase()
  analysis_phase()
  e2e_cli_size(sz)
  torch.cuda.empty_cache()
  fl_counts, ref_sel, fast_sel, stacked = e2e_full(sz)
  torch.cuda.empty_cache()
  flat, lazy_counts = e2e_fast_lazy(sz, ref_sel)
  fl_counts.update(lazy_counts)
  torch.cuda.empty_cache()
  fl_counts.update(e2e_tree(sz, flat, stacked))
  del flat
  torch.cuda.empty_cache()
  with dryrun_paused():
    e2e_dist(sz, stacked)
  torch.cuda.empty_cache()
  fl_counts.update(e2e_pre(sz, ref_sel, fast_sel))
  torch.cuda.empty_cache()
  fl_counts.update(e2e_exemplar(sz))
  torch.cuda.empty_cache()
  e2e_modular(sz)
  torch.cuda.empty_cache()
  e2e_wide(sz)
  torch.cuda.empty_cache()
  gp_counts = e2e_gp_full(sz)
  torch.cuda.empty_cache()
  cov_counts = e2e_satcov(sz)
  torch.cuda.empty_cache()
  cov_counts.update(e2e_service(sz))
  torch.cuda.empty_cache()
  query_counts, qsvc = e2e_query(sz)
  query_rows = sieve_kernel_phase(
      sz, qsvc.store.sieve_state,
      query_counts[MAIN_PATH["sieve_admit"]]["sieve_admit"])
  profile_query(qsvc, sz)
  del qsvc
  torch.cuda.empty_cache()
  with dryrun_paused():
    e2e_service_dist(sz)
  torch.cuda.empty_cache()
  e2e_obs(sz)
  torch.cuda.empty_cache()
  e2e_query_exact(sz)
  torch.cuda.empty_cache()
  cut_counts = {"paper": e2e_cut_paper(sz)}
  torch.cuda.empty_cache()
  cut_counts.update(e2e_cut_full(sz))
  torch.cuda.empty_cache()
  with dryrun_paused():
    train_counts, handles, single = e2e_train(sz)
    profile_train(handles)
  del handles
  torch.cuda.empty_cache()
  with dryrun_paused():
    train_counts.update(e2e_train_dist(sz, single))
    torch.cuda.empty_cache()
    e2e_launchers(sz)
  with dryrun_paused():
    serve_counts = e2e_serve(sz)
    torch.cuda.empty_cache()
    serve_counts.update(e2e_families(sz))
  torch.cuda.empty_cache()
  with dryrun_paused():
    ftp_counts, layouts_serve = e2e_families_tp(sz)
  serve_counts.update(ftp_counts)
  serve_counts.update(e2e_layouts(single["layouts_train"], layouts_serve))
  # kernel -> {path: launches} over the paths of its e2e phase; the train
  # paths ride along for the two kernels they launch
  by_path = {name: {p: c[name] for p, c in (
      gp_counts if name in GP_KERNELS else
      cov_counts if name in COV_KERNELS else
      cut_counts if name in CUT_KERNELS else
      serve_counts if name in SERVE_KERNELS else
      query_counts if name in QUERY_KERNELS else fl_counts).items()}
             for name in MAIN_PATH}
  for name, paths in TRAIN_PATHS.items():
    by_path[name].update({p: train_counts[p][name] for p in paths})
  launches = {name: by_path[name][path] for name, path in MAIN_PATH.items()}
  e2e_gp_fig6(sz)
  torch.cuda.empty_cache()
  rows = kernel_phases(sz, launches)
  torch.cuda.empty_cache()
  rows.update(colsum_kernel_phase(sz, launches["relu_colsum"]))
  torch.cuda.empty_cache()
  colsum_kernels_per_call(sz, rows[("relu_colsum", "full")])
  rows.update(wide_select_phase(sz))
  torch.cuda.empty_cache()
  rows.update(ig_kernel_phase(sz, gp_counts))
  torch.cuda.empty_cache()
  rows.update(cov_kernel_phase(sz, cov_counts))
  torch.cuda.empty_cache()
  rows.update(cut_kernel_phase(sz, cut_counts))
  torch.cuda.empty_cache()
  rows.update(flash_kernel_phase({**serve_counts, **train_counts}))
  rows.update(train_kernel_phase(train_counts["train_coreset"]))
  torch.cuda.empty_cache()
  rows.update(query_rows)
  profile_phase(sz)
  profile_gp(sz)
  profile_service(sz)
  profile_cut(sz)
  profile_serve(sz)

  main_shape = {"pairwise": ("pairwise", "s11", "linear", "f32"),
                "facility_select": ("facility_select", "round1", "linear",
                                    "f32"),
                "facility_gain": ("facility_gain", "round1", "linear",
                                  "f32"),
                "info_gain_cond": ("info_gain_cond", "round2 generic"),
                "info_select": ("info_select", "round1"),
                "coverage_gain": ("coverage_gain", "round1", "linear",
                                  "f32"),
                "coverage_select": ("coverage_select", "round1", "linear",
                                    "f32"),
                "graph_cut_gain": ("graph_cut_gain", "round1 local"),
                "graph_cut_select": ("graph_cut_select", "unbatched"),
                "flash_attention": ("flash_attention", "serve"),
                "relu_colsum": ("relu_colsum", "full"),
                "sieve_admit": ("sieve_admit", "linear")}
  kernels = []
  for name, key in main_shape.items():
    r = rows[key]
    kernels.append(dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=launches[name],
        launches_path=MAIN_PATH[name], launches_by_path=by_path[name],
        max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=r["shape"],
        **{extra: r[extra] for extra in ("bound_dense_ms", "dense_ms",
                                         "mode", "path", "tflops",
                                         "bound_share", "kernels_per_call",
                                         "latency_bound_ms")
           if extra in r}))
  emit("total", seconds=time.perf_counter() - t_start)
  print(gpu, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  try:
    if sys.argv[1:2] == ["--dist-liveness"]:
      dist_liveness_rank(sys.argv[2])
      sys.exit(0)
    if sys.argv[1:2] == ["--dist-service"]:
      dist_service_rank(sys.argv[2])
      sys.exit(0)
    if sys.argv[1:2] == ["--train-dist"]:
      train_dist_rank(sys.argv[2])
      sys.exit(0)
    if sys.argv[1:2] == ["--families-tp"]:
      families_tp_rank(sys.argv[2])
      sys.exit(0)
    code = main()
  except SmokeFailure as e:
    print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
    code = 1
  finally:
    dryrun_stop()
    analysis_stop()
  sys.exit(code)
