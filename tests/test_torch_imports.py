"""The port imports neither JAX nor clid_slam_tpu, and its entry points run
on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|clid_slam_tpu)\b", re.M)


def _port_sources():
    root = os.path.join(REPO, "clid_slam_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("build", "__pycache__")]  # build output
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_out_of_sys_modules():
    # a subprocess: tests/conftest.py itself imports jax in this process
    code = (
        "import importlib, pkgutil, sys\n"
        "import clid_slam_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "clid_slam_torch.__path__, 'clid_slam_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'clid_slam_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        src = f.read()
    assert not _IMPORT.search(src), path


def test_entry_points_default_to_cuda():
    from clid_slam_torch import resolve_device
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from torch_parity import port_config, tiny_config

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamingSlam(port_config(tiny_config()), total_frames=4)


@pytest.mark.parametrize(
    "option, value, named",
    [
        ("dynamic_filter_on", True, "dynamic_filter_on"),
        ("color_on", True, "color_on"),
        ("semantic_on", True, "semantic_on"),
        ("mlp_bf16", True, "mlp_bf16"),
        ("weighted_first", False, "weighted_first=False"),
        ("ba_freq_frame", 5, "ba_freq_frame>0"),
    ],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_unported_options_raise(option, value, named):
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from torch_parity import port_config, tiny_config

    cfg = port_config(tiny_config(**{option: value}))
    with pytest.raises(NotImplementedError, match=named):
        StreamingSlam(cfg, total_frames=4, device="cpu")


@pytest.mark.parametrize(
    "overrides",
    [dict(prune_map_on=True), dict(mlp_leaky_relu=True), dict(map_dup_independent=False),
     dict(main_loss_type="sdf_l2")],
    ids=lambda d: next(iter(d)),
)
def test_ported_options_construct(overrides):
    """The prune cadence and the configs the fused kernel does not take
    (they run the mapper's autograd loop) build a StreamingSlam."""
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from torch_parity import port_config, tiny_config

    StreamingSlam(port_config(tiny_config(**overrides)), total_frames=4, device="cpu")


def test_large_bench_config_is_supported():
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.pipeline.streaming import check_supported

    cfg = bc.build_config(large=True)
    assert cfg.prune_map_on
    check_supported(cfg)
