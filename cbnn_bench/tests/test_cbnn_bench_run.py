"""The command: no card, no result; no JAX loaded; and a run whose timed
path is broken underneath comes out not correct, once for each fault a
classifier cell can have."""
import os
import subprocess
import sys
import time

import pytest
import torch

from cbnn_bench import run
from cbnn_bench.harness import manifest

SMALL = {"batch": 2, "profile_after_share": 0.0}


def _measure(workload="cifarnet2-inline-b256", trace=False, **kw):
    return run.measure(workload, (1 << 31) + 77, 30.0, trace, "cpu",
                       time.perf_counter(), overrides=SMALL, max_queries=4,
                       **kw)


def test_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(manifest.ROOT / "cbnn_bench" / "run.py"),
         "--workload", "cifarnet2-inline-b256", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=manifest.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_imports_no_jax():
    """The command's module tree, and a whole run of it, load no module
    whose top-level name is JAX's or the JAX package's."""
    code = ("import sys, time; sys.path[:0] = [%r, %r]; "
            "from cbnn_bench import run; run._paths(); "
            "import cbnn_bench.harness.serve, cbnn_bench.harness.trace; "
            "run.measure('cifarnet2-inline-b256', 3, 30.0, False, 'cpu', "
            "time.perf_counter(), overrides={'batch': 1}, max_queries=1); "
            "print(run.forbidden_modules())"
            % (str(manifest.ROOT / "src"), str(manifest.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sound_run_is_correct():
    res = _measure(trace=True)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["logit_gap"] == {"value": 0.0, "limit": 0.0}
    assert res["metrics"]["comm_kb_per_image"]["value"] == 8193.264
    assert res["metrics"]["online_rounds"]["value"] == 33
    assert list(res)[-1] == "checks"


def _altered(runner):
    def run_(keys, x, slabs):
        out = runner(keys, x, slabs).clone()
        out[0, 3] += 0.25
        return out
    return run_


def _half_batch(runner):
    def run_(keys, x, slabs):
        out = runner(keys, x, slabs).clone()
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(0)
        return out
    return run_


def _stale(runner):
    """Every query after the first answers with the first's logits."""
    first = []

    def run_(keys, x, slabs):
        out = runner(keys, x, slabs)
        if not first:
            first.append(out)
        return first[0]
    return run_


def _dropped_exchange(runner):
    """The opening leaves out the third party's message."""
    from repro_torch.core import transport

    def run_(keys, x, slabs):
        real = transport.LocalTransport.open_parts
        transport.LocalTransport.open_parts = \
            lambda self, parts: parts[0] + parts[1]
        try:
            return runner(keys, x, slabs)
        finally:
            transport.LocalTransport.open_parts = real
    return run_


@pytest.mark.parametrize("fault", [_altered, _half_batch, _stale,
                                   _dropped_exchange])
def test_fault_is_not_correct(fault):
    res = _measure(wrap_runner=fault)
    assert not res["correct"] and res["failed"] > 0
