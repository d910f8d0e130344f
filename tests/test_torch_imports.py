"""The port imports neither JAX nor clid_slam_tpu, and its entry points run
on the card unless the caller asks for the CPU."""

import glob
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
    "overrides",
    [dict(prune_map_on=True), dict(mlp_leaky_relu=True), dict(map_dup_independent=False),
     dict(main_loss_type="sdf_l2"), dict(dynamic_filter_on=True), dict(ba_freq_frame=5),
     dict(track_cached=False), dict(feature_dim=6), dict(color_on=True, color_channel=1),
     dict(semantic_on=True), dict(mlp_bf16=True), dict(weighted_first=False),
     dict(weighted_first=False, mlp_bf16=True, color_on=True, color_channel=1,
          semantic_on=True)],
    ids=lambda d: "all_four" if len(d) > 2 else next(iter(d)),
)
def test_ported_options_construct(overrides):
    """The prune cadence, the dynamic filter, BA, the re-querying tracker,
    the color and semantic heads, bf16 decoding, decode-then-weight (each
    alone and the last four together) and the other configs the fused
    kernel does not take (they run the mapper's autograd loop) build a
    StreamingSlam."""
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from torch_parity import port_config, tiny_config

    StreamingSlam(port_config(tiny_config(**overrides)), total_frames=4, device="cpu")


def _frame_steps(cfg):
    """``make_frame_step`` for ``cfg`` (no state is allocated)."""
    from clid_slam_torch.ops.encoding import make_encoder
    from clid_slam_torch.ops.voxel import neighbor_offsets
    from clid_slam_torch.pipeline.streaming import make_frame_step

    enc, _ = make_encoder(num_bands=cfg.pos_encoding_band, freq=cfg.pos_encoding_freq,
                          base=cfg.pos_encoding_base, use_gaussian=cfg.use_gaussian_pe,
                          input_dim=cfg.pos_input_dim, seed=cfg.seed)
    steps = make_frame_step(cfg, neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha), enc)
    assert sorted(steps) == [(False, False), (False, True), (True, False), (True, True)]


def test_large_bench_config_is_supported():
    from clid_slam_torch.pipeline import bench_cases as bc

    cfg = bc.build_config(large=True)
    assert cfg.prune_map_on
    _frame_steps(cfg)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
    ids=os.path.basename,
)
def test_repo_configs_are_supported(path):
    """Every config of the repo, run_quad.yaml's dynamic filter included,
    builds the port's frame step (without a system at these configs' map
    sizes)."""
    from clid_slam_torch.config import Config

    _frame_steps(Config.load(path))
