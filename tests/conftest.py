import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.core import RING32, Parties


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips at run time without one")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Per-test timeout fallback so a hung mesh collective fails the run
    instead of wedging it.  CI installs pytest-timeout (--timeout flag,
    requirements-dev.txt) and that plugin takes precedence; environments
    without it can export REPRO_TEST_TIMEOUT=<seconds> to get a SIGALRM
    backstop (POSIX only, whole seconds)."""
    limit = int(os.environ.get("REPRO_TEST_TIMEOUT", "0") or 0)
    if (limit <= 0 or item.config.pluginmanager.hasplugin("timeout")
            or not hasattr(signal, "SIGALRM")):
        return (yield)

    def on_alarm(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded REPRO_TEST_TIMEOUT={limit}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def ring():
    return RING32


@pytest.fixture
def parties():
    return Parties.setup(jax.random.PRNGKey(42))


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def run_party_subprocess(script_text: str, tmp_path, name: str):
    """Run a mesh-backend test script in a subprocess with 8 fake host
    devices (the fake-device XLA flag must be set before jax initializes,
    and the main test session must keep seeing 1 device).  Shared by the
    transport/preprocessing/OT mesh tests."""
    script = tmp_path / name
    script.write_text(script_text)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=900, env=env, cwd=str(repo))
    assert r.returncode == 0 and "OK" in r.stdout, \
        f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
