"""Run the examples (reference CI runs all examples, rust.yml:75-84)."""
import os
import subprocess
import sys

import pytest

EXAMPLES = [
    "simple_usage.py",
    "single_threaded.py",
    "custom_tuner.py",
    "composite_keys.py",
    "impl_radix_key.py",
    "distributed_pipeline.py",
    "batched_rows.py",
]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = root
    r = subprocess.run(
        [sys.executable, os.path.join(root, "examples", name)],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=root,
    )
    assert r.returncode == 0, r.stderr[-2000:]
