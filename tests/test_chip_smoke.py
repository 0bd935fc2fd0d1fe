"""chip_smoke.py: refuses a machine without a GPU, picks its phases, and
runs every case end to end at a tiny size on the CPU (the rehearsal of a
chip run; the timings it prints here mean nothing)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _env(devices=8):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_refuses_without_gpu(args):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_four_cards_selects_only_the_mesh_phase():
    assert chip_smoke.select_phases(True) == ["mesh4"]
    assert chip_smoke.select_phases("all") == ["mesh4"]
    assert chip_smoke.select_phases("sorts") == ["mesh4:sorts"]
    assert chip_smoke.select_phases("tables") == ["mesh4:tables"]
    one = chip_smoke.select_phases(None)
    assert "mesh4" not in one and "cases" in one and "gpu_tests" in one


@pytest.mark.parametrize("part,want", [
    ("sorts", ["distributed_sort u64+u32", "zipf", "2x2 mesh"]),
    ("tables", ["filter", "group_aggregate orderkey range",
                "join orders range", "group_aggregate orderkey hash",
                "join orders hash"]),
])
def test_four_card_parts_split_the_cases(part, want):
    """The two halves of the mesh phase hold every case between them, and
    each half only its own (the inputs are made lazily, so listing the
    names runs nothing)."""
    import numpy as np

    names = []
    cases = chip_smoke.four_card_cases(np.random.default_rng(0),
                                       chip_smoke.Sizes(shift=20), part)
    for case in cases:
        names.append(case.name)
    assert len(names) == len(want)
    for w, name in zip(want, names):
        assert w in name


REHEARSAL = """
import sys
import numpy as np
import chip_smoke
from rdst_tpu import config
config.host_sort_max = 0  # every case takes the device plans
ok = chip_smoke.run_phases({phases!r}, np.random.default_rng(3),
                           chip_smoke.Sizes(shift=16))
sys.exit(0 if ok else 1)
"""


@pytest.mark.parametrize("phases", [["dense_sort", "cases"], ["mesh4"]])
def test_cases_tiny_on_cpu(phases):
    """Every case at a tiny size, without x64 as on the chip; the mesh
    phase on four of the virtual CPU devices."""
    r = subprocess.run(
        [sys.executable, "-c", REHEARSAL.format(phases=phases)],
        capture_output=True, text=True, timeout=900, env=_env(), cwd=ROOT,
    )
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-3000:])
    assert "FAIL" not in r.stdout
    assert r.stdout.count(" PASS ") >= (4 if phases == ["mesh4"] else 20)
