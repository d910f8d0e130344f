"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the system under test. Top-level module
names are compared whole: ``clid_slam_torch`` begins with
``clid_slam_t`` but is not ``clid_slam_tpu``."""

import os
import re
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
IMPORT = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][\w.]*)", re.M)


def _sources(sub):
    out = []
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, BENCH)
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["clid_slam_tpu_extra"] = object()
        sys.modules["jaxtyping"] = object()
        assert "clid_slam_tpu_extra" not in run.forbidden_modules()
        assert "jaxtyping" not in run.forbidden_modules()
        sys.modules["clid_slam_tpu.config"] = object()
        assert "clid_slam_tpu.config" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.parametrize("path", _sources("plainref"), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    with open(path) as f:
        tops = {m.split(".")[0] for m in IMPORT.findall(f.read())}
    assert not tops & {"clid_slam_torch", "clid_slam_tpu", "jax", "jaxlib", "flax"}, tops


def test_a_run_leaves_jax_out_of_sys_modules():
    # a fresh process: this one may hold anything the test run loaded
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]\n"
        "import run\n"
        "from tiny import run_tiny\n"
        "res = run_tiny('quad.walk')\n"
        "assert res['correct'], res['checks']\n"
        "import plainref.driver, harness.cell, harness.trace\n"
        "bad = run.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'clid_slam_torch' in sys.modules\n"
        "ref = [m for m in sys.modules if m.startswith('plainref')]\n"
        "assert ref, 'the reference did not run'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
