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
    # chip_smoke.py and the modules the sharded tests' spawned ranks import
    out = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", f)
        for f in ("torch_dist.py", "torch_sharded_ranks.py", "torch_driver_ranks.py")]
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
        "assert {'clid_slam_torch.parallel.collectives', 'clid_slam_torch.parallel.spatial', "
        "'clid_slam_torch.parallel.data_parallel', 'clid_slam_torch.parallel.slam_sharded', "
        "'clid_slam_torch.parallel.distributed', 'clid_slam_torch.pipeline.streaming_sharded', "
        "'clid_slam_torch.tools.run_multiprocess'} <= set(mods), mods\n"
        "import chip_smoke\n"
        "import torch_dist, torch_sharded_ranks, torch_driver_ranks  # the spawned ranks'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'clid_slam_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
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


def test_classic_driver_modules_are_the_ports_own():
    """The modules of the classic driver are files of the port (own copies
    of the JAX package's numpy-only modules, the C++ reader included), and
    the CLI and the synthetic writer are in the source scan above."""
    root = os.path.join(REPO, "clid_slam_torch")
    for rel in ("pipeline/slam.py", "pipeline/dataset.py", "pipeline/dataset_indexing.py",
                "pipeline/control.py", "pipeline/liveview.py", "utils/io.py", "utils/plots.py",
                "utils/observability.py", "native/__init__.py", "native/clid_native.cpp"):
        assert os.path.isfile(os.path.join(root, rel)), rel
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"clid_slam_torch/pipeline/slam.py", "clid_slam_torch/pipeline/synthetic.py",
            "clid_slam_torch/native/__init__.py"} <= scanned
    with open(os.path.join(root, "native", "clid_native.cpp")) as f:
        assert "clid_slam_tpu" not in f.read()


def test_mesh_and_tool_modules_are_the_ports_own():
    """Meshing (the mesher, marching tetrahedra) and the host tools are
    files of the port, in the source scan above, and name no module of the
    JAX package (their own copies of ``_weld_mesh``, the palette and the
    tools)."""
    rels = ("clid_slam_torch/mesher.py", "clid_slam_torch/ops/marching.py",
            "clid_slam_torch/tools/inspect_map.py", "clid_slam_torch/tools/convert.py",
            "clid_slam_torch/tools/live_viewer.py", "clid_slam_torch/tools/rosbag_converter.py")
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in rels:
        assert rel in scanned, rel
        with open(os.path.join(REPO, rel)) as f:
            assert not re.search(r"\bclid_slam_tpu\.", f.read()), rel


def test_sharded_runtime_modules_are_the_ports_own():
    """The sharded runtime (collectives, the data-parallel mapper, the
    sharded map, the sharded drivers and the multi-process runtime with its
    two-process check) is files of the port, in the source scan above,
    naming no module of the JAX package."""
    rels = ("clid_slam_torch/parallel/__init__.py", "clid_slam_torch/parallel/collectives.py",
            "clid_slam_torch/parallel/data_parallel.py", "clid_slam_torch/parallel/spatial.py",
            "clid_slam_torch/parallel/slam_sharded.py", "clid_slam_torch/parallel/distributed.py",
            "clid_slam_torch/pipeline/streaming_sharded.py",
            "clid_slam_torch/tools/run_multiprocess.py")
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in rels:
        assert rel in scanned, rel
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        assert not re.search(r"\bclid_slam_tpu\.", src), rel
        # float sums across ranks keep rank order: the one all-reduce is pmax's
        assert "torch.distributed.nn" not in src, rel
        calls = re.findall(r"dist\.all_reduce\(([^)]*)\)", src)
        assert all("ReduceOp.MAX" in c for c in calls), (rel, calls)


# the frame step's packages (tools/ keeps its own measurement code)
FRAME_STEP_PACKAGES = ("odometry", "mapping", "models", "ops", "parallel", "pipeline")
# what only clid_slam_torch/graphs.py names: the capture of a stage as CUDA graphs
CAPTURE_NAMES = ("_cuda_clearCublasWorkspaces", "torch.cuda.CUDAGraph", "capture_begin",
                 "graph_pool_handle")


def test_graph_capture_and_kernel_binding_live_in_one_place():
    """One module captures the frame step's stages as CUDA graphs
    (``clid_slam_torch/graphs.py``): no other module of the frame step's
    packages names its capture calls. One route binds the hand kernels
    (``ops/_build.py:load_module``, the extension module a ``csrc/*.cu``
    defines): no module under ``ops/`` imports ``ctypes``."""
    root = os.path.join(REPO, "clid_slam_torch")
    with open(os.path.join(root, "graphs.py")) as f:
        src = f.read()
    assert all(name in src for name in CAPTURE_NAMES)
    named = []
    for pkg in FRAME_STEP_PACKAGES:
        for d, _, files in os.walk(os.path.join(root, pkg)):
            for fn in files:
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(d, fn)
                with open(path) as f:
                    src = f.read()
                rel = os.path.relpath(path, REPO)
                named += [(rel, name) for name in CAPTURE_NAMES if name in src]
                if pkg == "ops" and re.search(r"^\s*(import|from)\s+ctypes\b", src, re.M):
                    named.append((rel, "ctypes"))
    assert not named, named


def test_entry_points_default_to_cuda(tmp_path):
    from clid_slam_torch import resolve_device
    from clid_slam_torch.parallel.distributed import initialize, run_sharded_slam
    from clid_slam_torch.parallel.slam_sharded import ShardedSlamSystem
    from clid_slam_torch.parallel.spatial import init_sharded_map
    from clid_slam_torch.pipeline.slam import SlamSystem, main, run_slam
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from clid_slam_torch.pipeline.streaming_sharded import StreamingShardedSlam
    from clid_slam_torch.pipeline.synthetic import generate_sequence, write_sequence_dataset
    from torch_parity import port_config, tiny_config

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        cfg_path = write_sequence_dataset(
            generate_sequence(n_frames=2, n_azimuth=64, n_elev=8, seed=3), str(tmp_path),
            {"eval.save_mesh": False})
        for make in (
            lambda: resolve_device(None),
            lambda: StreamingSlam(port_config(tiny_config()), total_frames=4),
            lambda: SlamSystem(port_config(tiny_config()), total_frames=4),
            lambda: run_slam(cfg_path),
            lambda: main([cfg_path]),
            lambda: init_sharded_map(None, 16, 64, 8),
            lambda: initialize(),
            lambda: ShardedSlamSystem(port_config(tiny_config()), total_frames=4),
            lambda: StreamingShardedSlam(port_config(tiny_config()), total_frames=4),
            lambda: run_sharded_slam(port_config(tiny_config()), [], []),
        ):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


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
