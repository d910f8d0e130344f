"""Local label map parity: plane fits, update_local_map (append and crop
paths; integer state bit-exact) and region_specific_sdf (labels atol
1e-5, masks exact, normals of successful fits within 1e-3 rad up to
sign)."""

import numpy as np
import jax.numpy as jnp
import pytest

from clid_slam_torch.convert import local_map_from_numpy
from clid_slam_torch.models import local_map as tlm
from clid_slam_torch.ops import plane_fit as tpf
from clid_slam_tpu.models import local_map as jlm
from clid_slam_tpu.ops import plane_fit as jpf
from torch_parity import n, t

RES = 0.15


def _planar_patches(rng, m=600):
    """Noisy planar patches [m, 7, 3] spread evenly in their plane, so the
    two large eigenvalues stay comparable and the normal is well
    conditioned in f32 (its rounding error grows like λ1/(λ2-λ3))."""
    normal = rng.normal(size=(m, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    u = np.cross(normal, rng.normal(size=(m, 3)))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(normal, u)
    ang = np.linspace(0, 2 * np.pi, 7, endpoint=False)[None] + rng.uniform(0, 1, (m, 1))
    r = 0.3 * rng.uniform(0.7, 1.0, (m, 7))
    pts = (r * np.cos(ang))[..., None] * u[:, None] + (r * np.sin(ang))[..., None] * v[:, None]
    pts += rng.normal(0, 0.01, (m, 7, 3)) * rng.uniform(0.2, 8.0, (m, 1, 1))
    return (pts + rng.normal(0, 5.0, (m, 1, 3))).astype(np.float32)


def test_plane_fit_matches_jax():
    rng = np.random.default_rng(0)
    pts = _planar_patches(rng)
    sel = np.ones(pts.shape[:2], bool)
    sel[:, 5:] = rng.uniform(size=(len(pts), 2)) < 0.5
    c = pts - pts.mean(1, keepdims=True)
    A = np.einsum("mki,mkj->mij", c, c).astype(np.float32)
    ej = np.asarray(jpf.sym3x3_eigvals(jnp.asarray(A)))
    np.testing.assert_allclose(n(tpf.sym3x3_eigvals(t(A))), ej, atol=1e-5, rtol=1e-5)
    # eigenvectors and normals agree up to sign (every use is sign-free)
    np.testing.assert_allclose(
        np.abs(n(tpf.sym3x3_min_eigvec(t(A), t(ej)))),
        np.abs(np.asarray(jpf.sym3x3_min_eigvec(jnp.asarray(A), jnp.asarray(ej)))),
        atol=1e-5,
    )
    for tf, jf, args in (
        (tpf.fit_plane_knn, jpf.fit_plane_knn, (pts[:, :4],)),
        (tpf.fit_plane_masked, jpf.fit_plane_masked, (pts, sel)),
    ):
        nt, ct, st = tf(*[t(a) for a in args])
        nj, cj, sj = jf(*[jnp.asarray(a) for a in args])
        ok = np.asarray(sj)
        np.testing.assert_array_equal(n(st), ok)
        # normals and constants are read only where the fit succeeded
        np.testing.assert_allclose(np.abs(n(nt))[ok], np.abs(np.asarray(nj))[ok], atol=1e-5)
        np.testing.assert_allclose(  # |c| ~ 8 m: f32 resolution ~1e-6 relative
            np.abs(n(ct))[ok], np.abs(np.asarray(cj))[ok], atol=1e-5, rtol=1e-5
        )
        assert 0.3 < ok.mean() < 0.95


def _scan(rng, m, origin):
    """Points on a floor and two walls around ``origin`` (world frame)."""
    k = m // 3
    floor = np.c_[rng.uniform(-3, 3, (k, 2)), np.full(k, -1.5)]
    wall1 = np.c_[np.full(k, 2.5), rng.uniform(-3, 3, k), rng.uniform(-1.5, 1, k)]
    wall2 = np.c_[rng.uniform(-3, 3, k), np.full(k, -2.0), rng.uniform(-1.5, 1, k)]
    pts = np.r_[floor, wall1, wall2] + rng.normal(0, 0.01, (3 * k, 3)) + origin
    return pts.astype(np.float32)


def _both_maps(crop_pattern):
    rng = np.random.default_rng(1)
    js = jlm.init_local_map(1 << 13, 1 << 14)
    ts = tlm.init_local_map(1 << 13, 1 << 14, device="cpu")
    for f, crop in enumerate(crop_pattern):
        origin = np.array([0.4 * f, 0.0, 0.0], np.float32)
        pts = _scan(rng, 6000, origin)
        mask = rng.uniform(size=len(pts)) < 0.95
        js = jlm.update_local_map(js, jnp.asarray(origin), jnp.asarray(pts), jnp.asarray(mask), RES, 6.0, crop_now=crop)
        ts = tlm.update_local_map(ts, t(origin), t(pts), t(mask), RES, 6.0, crop_now=crop)
    return js, ts, rng


@pytest.mark.parametrize("crop_pattern", [(False, False, False), (False, True, False, True)])
def test_update_local_map_bit_exact(crop_pattern):
    js, ts, _ = _both_maps(crop_pattern)
    for name, a in zip(("positions", "count", "hash_table", "hash_mirror"), js):
        np.testing.assert_array_equal(n(getattr(ts, name)), np.asarray(a), err_msg=name)
    assert int(ts.count) > 1000


def test_region_specific_sdf_matches_jax():
    js, ts, rng = _both_maps((False, True, False))
    q = _scan(rng, 3000, np.array([0.8, 0, 0], np.float32))
    q += rng.normal(0, 0.05, q.shape).astype(np.float32)
    dj, vj, nj, fj = jlm.region_specific_sdf(js, jnp.asarray(q), RES, with_normal=True)
    ts2 = local_map_from_numpy([np.asarray(x) for x in js], device="cpu")
    dt, vt, nt, ft = tlm.region_specific_sdf(ts2, t(q), RES, with_normal=True)
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_array_equal(n(ft), np.asarray(fj))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5, rtol=0)
    # normals of successful fits (the only ones read, by the sign-free
    # incidence factor |d·n|) agree within 1e-3 rad up to sign: a 4-point
    # fit's normal has f32 rounding error ~ 1e-7 * λ1/(λ2-λ3), up to ~1e-4
    ok = np.asarray(fj)
    cos = np.abs(np.sum(n(nt)[ok] * np.asarray(nj)[ok], -1))
    assert cos.min() > np.cos(1e-3), cos.min()
    assert ok.mean() > 0.3


def test_region_specific_sdf_gathers_the_mirror_through_gather_rows(monkeypatch):
    """The labels' one probe gather reads the local map's mirror through
    ``gather_rows`` ([N, 7] buckets; the kernel on the card, its plain
    version here), and those rows are JAX's ``mirror[h]`` bit for bit."""
    from clid_slam_tpu.ops.voxel import grid_coords, voxel_hash

    calls = []
    real = tlm.gather_rows_nd
    monkeypatch.setattr(tlm, "gather_rows_nd",
                        lambda table, idx: calls.append((idx, real(table, idx))) or calls[-1][1])
    js, ts, rng = _both_maps((False, True, False))
    q = _scan(rng, 3000, np.array([0.8, 0, 0], np.float32))
    tlm.region_specific_sdf(ts, t(q), RES)
    (idx, rows), = calls
    assert idx.shape == (q.shape[0], 7)
    cells = grid_coords(jnp.asarray(q), RES)[:, None, :] + jnp.asarray(tlm.LOCAL_NB_OFFSETS.numpy())
    h = voxel_hash(cells, js.hash_table.shape[0])
    np.testing.assert_array_equal(n(idx), np.asarray(h))
    np.testing.assert_array_equal(n(rows), np.asarray(js.hash_mirror[h]))
