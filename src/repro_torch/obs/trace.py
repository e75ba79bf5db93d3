"""Structured trace spans: the timing source of the service layer (the port
of ``src/repro/obs/trace.py``).

``span("service.epoch", epoch=3)`` is a context manager that always
measures its wall clock (``Span.wall_s`` after exit; the service's stats
read it, with obs on or off).  Only while observability is enabled does a
span also

  * append one JSONL record to the configured trace sink, ``{"name", "ts",
    "dur_s", "pid", "tid", "attrs"}`` (``ts`` the monotonic clock at entry,
    so records order and subtract cleanly), and
  * wrap its body in ``torch.profiler.record_function(name)`` (the
    reference's ``jax.profiler.TraceAnnotation``), so the span lands in a
    ``torch.profiler`` trace beside the kernels it encloses, and, where
    CUDA is present, in an NVTX range of the same name.

Enable / disable is process-global::

    obs.enable(trace_out="/tmp/trace.jsonl")   # or enable(): metrics only
    with obs.span("service.epoch", epoch=i) as sp:
        ...
    stats.wall_s = sp.wall_s

Disabled, a span costs two ``perf_counter()`` calls and a few attribute
reads: no file IO, no profiler hook, no device access.  A span never
synchronizes the device either: a caller that wants device-synced timing
synchronizes inside the span, as the service epoch does.

``add(**attrs)`` attaches attributes found mid-span (the occupancy a drain
knows only after collecting); they merge into the record at exit.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import IO

import torch

_STATE_LOCK = threading.Lock()
_ENABLED = False
_TRACE_PATH: str | None = None
_TRACE_FILE: IO | None = None
_TRACE_WRITE_LOCK = threading.Lock()


def enable(trace_out: str | None = None) -> None:
  """Turn observability on (idempotent).  ``trace_out`` adds a JSONL span
  sink (opened lazily, appended, one record per line)."""
  global _ENABLED, _TRACE_PATH, _TRACE_FILE
  with _STATE_LOCK:
    _ENABLED = True
    if trace_out is not None and trace_out != _TRACE_PATH:
      if _TRACE_FILE is not None:
        _TRACE_FILE.close()
      _TRACE_PATH = trace_out
      _TRACE_FILE = None


def disable() -> None:
  """Turn observability off and close any open trace sink."""
  global _ENABLED, _TRACE_PATH, _TRACE_FILE
  with _STATE_LOCK:
    _ENABLED = False
    if _TRACE_FILE is not None:
      _TRACE_FILE.close()
    _TRACE_FILE = None
    _TRACE_PATH = None


def enabled() -> bool:
  return _ENABLED


def trace_out_path() -> str | None:
  return _TRACE_PATH


def _emit(record: dict) -> None:
  global _TRACE_FILE
  with _TRACE_WRITE_LOCK:
    if _TRACE_PATH is None:
      return
    if _TRACE_FILE is None:
      _TRACE_FILE = open(_TRACE_PATH, "a", buffering=1)
    _TRACE_FILE.write(json.dumps(record, sort_keys=True) + "\n")


class Span:
  """One timed region; see the module docstring.  Not reentrant."""

  __slots__ = ("name", "attrs", "wall_s", "_t0", "_ann", "_nvtx",
               "_emitting")

  def __init__(self, name: str, attrs: dict):
    self.name = name
    self.attrs = attrs
    self.wall_s = 0.0
    self._t0 = 0.0
    self._ann = None
    self._nvtx = False
    self._emitting = False

  def add(self, **attrs) -> None:
    """Attach attributes found mid-span (merged into the record)."""
    self.attrs.update(attrs)

  def __enter__(self) -> "Span":
    self._emitting = _ENABLED  # latched: enabling mid-span emits nothing
    if self._emitting:
      self._ann = torch.profiler.record_function(self.name)
      self._ann.__enter__()
      self._nvtx = torch.cuda.is_available()
      if self._nvtx:
        torch.cuda.nvtx.range_push(self.name)
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc) -> None:
    self.wall_s = time.perf_counter() - self._t0
    if self._nvtx:
      torch.cuda.nvtx.range_pop()
      self._nvtx = False
    if self._ann is not None:
      self._ann.__exit__(*exc)
      self._ann = None
    if self._emitting:
      _emit({"name": self.name, "ts": self._t0, "dur_s": self.wall_s,
             "pid": os.getpid(), "tid": threading.get_ident(),
             "attrs": self.attrs})


def span(name: str, **attrs) -> Span:
  """Open a timed span: ``with obs.span("service.query", tier="sieve"):``."""
  return Span(name, attrs)
