"""The port covers the JAX package's whole surface, name by name.

Each module of ``clid_slam_tpu/`` is parsed with ``ast`` (its text only:
nothing is imported) beside its counterpart in ``clid_slam_torch/``. Every
top-level function and class of the JAX module, and every method,
property and field of each of its classes, must exist under the same name
in the port's module, or stand in ``RENAMED`` with its port counterpart or
the reason it has none. Private names are held to it too, so an entry of
``RENAMED`` is the only way a name of the JAX package goes without a
counterpart. The test also keeps ``RENAMED`` true: every entry names a
JAX name that exists and lacks a same-named counterpart, and every
counterpart it names exists in the port.
"""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_PKG = os.path.join(ROOT, "clid_slam_tpu")
PORT_PKG = os.path.join(ROOT, "clid_slam_torch")

# JAX modules whose port lives under another path
MODULES = {"ops/pallas_mapping.py": "ops/map_loop.py"}

# "module:name" (or "module:Class.member") of the JAX package -> (its port
# counterpart as "module:name", or None, and a one-line reason)
RENAMED = {
    "ops/pallas_mapping.py:make_pallas_map_loop": (
        "ops/map_loop.py:map_loop", "K1, the fused mapping loop, as a CUDA kernel"),
    "ops/pallas_mapping.py:_round_up": (
        "ops/map_loop.py:plan", "the kernel's plan sizes its blocks; no TPU lane padding"),
    "mapping/mapper.py:AdamState": (
        "mapping/mapper.py:_adam_update", "Adam's moments are plain tensors it returns"),
    "mapping/mapper.py:_slab_gather_sorted": (
        "mapping/mapper.py:_SlabGatherSorted", "one autograd Function for jax.custom_vjp"),
    "mapping/mapper.py:_slab_gather_sorted_fwd": (
        "mapping/mapper.py:_SlabGatherSorted", "its forward"),
    "mapping/mapper.py:_slab_gather_sorted_bwd": (
        "mapping/mapper.py:_SlabGatherSorted", "its backward"),
    "mapping/mapper.py:_quat_conj_rotate": (
        "models/neural_map.py:conj_rotate", "one copy shared with the map query"),
    "mapping/mapper.py:_idw": (
        "models/neural_map.py:idw_weights", "one copy shared with the map query"),
    "mapping/mapper.py:_make_cached_mapping_fn": (
        "mapping/mapper.py:make_mapping_fn", "its single-batch body (max_outer=1)"),
    "mapping/mapper.py:_color_head": (
        "models/decoder.py:regress_color", "the mapper calls the decoder's head directly"),
    "parallel/spatial.py:_local": (
        None, "JAX-only: unboxes shard_map's per-shard leading axis; a rank holds one shard"),
    "parallel/spatial.py:_boxed": (
        None, "JAX-only: boxes a shard for shard_map; a rank holds one shard"),
    "pipeline/streaming_sharded.py:_unjit": (
        None, "JAX-only: peels a jax.jit wrapper; the port's steps are not jitted"),
}


def _modules(pkg):
    out = []
    for d, _, files in os.walk(pkg):
        out += [os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def surface(path) -> dict:
    """{name: None for a function, the set of member names for a class}
    of the module's top level."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            members = set()
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(m.name)
                elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
                    members.add(m.target.id)
            out[node.name] = members
    return out


def _port_path(mod):
    return os.path.join(PORT_PKG, MODULES.get(mod, mod))


def _has(key) -> bool:
    """Whether "module:name" or "module:Class.member" exists in the port."""
    mod, name = key.split(":")
    path = os.path.join(PORT_PKG, mod)
    if not os.path.exists(path):
        return False
    top, _, member = name.partition(".")
    s = surface(path)
    return top in s and (not member or member in (s[top] or ()))


def missing(mod) -> list:
    """The JAX module's names with no same-named counterpart in the port's."""
    want = surface(os.path.join(JAX_PKG, mod))
    path = _port_path(mod)
    have = surface(path) if os.path.exists(path) else {}
    out = []
    for name, members in want.items():
        if name not in have:
            out.append(name)
        elif members is not None:
            out += [f"{name}.{m}" for m in sorted(members - (have[name] or set()))]
    return [f"{mod}:{x}" for x in out]


JAX_MODULES = _modules(JAX_PKG)


def test_every_module_has_a_counterpart():
    assert JAX_MODULES
    absent = [m for m in JAX_MODULES if not os.path.exists(_port_path(m))]
    assert absent == []


@pytest.mark.parametrize("mod", JAX_MODULES)
def test_every_name_has_a_counterpart(mod):
    unaccounted = [k for k in missing(mod) if k not in RENAMED]
    assert unaccounted == [], (
        f"{unaccounted}: port them under the same name, or add each to RENAMED with its "
        "counterpart or the reason it has none")


def test_renamed_entries_are_true():
    all_missing = {k for m in JAX_MODULES for k in missing(m)}
    for key, (port, reason) in RENAMED.items():
        assert key in all_missing, f"{key}: not a JAX name without a same-named counterpart"
        assert reason.strip(), key
        if port is not None:
            assert _has(port), f"{key}: its counterpart {port} is not in the port"
