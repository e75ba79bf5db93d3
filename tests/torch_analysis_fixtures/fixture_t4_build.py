"""Fixture: a library load per call (T4).

``handle_request`` loads a shared library on every call; ``_compile_lib``
(the sanctioned one-time hoist point), ``main`` and the module-level load
are allowed.  ``clean_request`` is the twin that uses the hoisted handle.
"""
import ctypes

_LIB = ctypes.CDLL(None)  # module level: loaded once


def _compile_lib():
  return ctypes.CDLL(None)  # allowed: called once by its owner


def handle_request(x):
  lib = ctypes.CDLL(None)  # BUG: a library load every call
  return x + 0 * lib.abs(1)


def clean_request(x):
  return x + 0 * _LIB.abs(1)


def main():
  return ctypes.CDLL(None)  # allowed: once a process
