import os
import subprocess
import sys
import textwrap

import pytest

# NOTE: no XLA_FLAGS here on purpose -- unit tests and benches must see the
# single real device.  Multi-device tests spawn subprocesses (run_devices).

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_with_devices(script: str, n_devices: int, timeout: int = 600) -> str:
  """Run a python snippet in a subprocess with n forced host devices."""
  env = dict(os.environ)
  env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
  env["PYTHONPATH"] = os.path.join(REPO, "src")
  out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
  if out.returncode != 0:
    raise AssertionError(f"subprocess failed:\n{out.stdout}\n{out.stderr}")
  return out.stdout


@pytest.fixture
def subrun():
  return run_with_devices


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "cuda: needs a CUDA device (skips where there is none)")
