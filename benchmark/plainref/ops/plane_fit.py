"""Batched least-squares plane fitting via the closed-form 3x3 symmetric
eigendecomposition (port of clid_slam_tpu/ops/plane_fit.py).

Validity tests mirror the reference: eta = λ_min / (λ_mid + 1e-6) on
singular values, and the max point-to-plane residual.
"""

from __future__ import annotations

import math

import torch


def sym3x3_eigvals(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [...,3,3], descending (trigonometric form)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01**2 + a02**2 + a12**2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    Bm = (A - q[..., None, None] * I) / p[..., None, None]
    detB = (
        Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 1])
        - Bm[..., 0, 1] * (Bm[..., 1, 0] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 0])
        + Bm[..., 0, 2] * (Bm[..., 1, 0] * Bm[..., 2, 1] - Bm[..., 1, 1] * Bm[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    iso = p2 < 1e-20  # nearly isotropic: all eigenvalues -> q
    e1 = torch.where(iso, q, e1)
    e2 = torch.where(iso, q, e2)
    e3 = torch.where(iso, q, e3)
    return torch.stack([e1, e2, e3], dim=-1)


def sym3x3_min_eigvec(A: torch.Tensor, eigvals: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue: the largest-norm column
    of (A-λ1 I)(A-λ2 I); +z where degenerate."""
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - eigvals[..., 0, None, None] * I) @ (
        A - eigvals[..., 1, None, None] * I
    )
    norms = torch.linalg.norm(M, dim=-2)  # [...,3] column norms
    best = torch.argmax(norms, dim=-1)
    onehot = best[..., None] == torch.arange(3, device=A.device)
    v = torch.sum(M * onehot[..., None, :], dim=-1)
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(
        n > 1e-12, v / torch.clamp(n, min=1e-12), fallback.expand(v.shape)
    )


def _scatter3(centered: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ki,...kj->...ij", centered, centered)


def fit_plane_knn(
    knn_points: torch.Tensor,  # [..., K, 3]
    eta_threshold: float = 0.2,
    residual_threshold: float = 0.1,
):
    """(normal [...,3], plane_constant [...], fit_success [...]); failed
    eta tests return a zero normal."""
    centroid = torch.mean(knn_points, dim=-2, keepdim=True)
    scatter = _scatter3(knn_points - centroid)
    eig = sym3x3_eigvals(scatter)
    svals = torch.sqrt(torch.clamp(eig, min=0.0))
    eta_ok = svals[..., 2] / (svals[..., 1] + 1e-6) <= eta_threshold
    normal = sym3x3_min_eigvec(scatter, eig)
    normal = torch.where(eta_ok[..., None], normal, torch.zeros_like(normal))
    constant = -torch.sum(normal * centroid[..., 0, :], dim=-1)
    dists = torch.abs(
        torch.einsum("...ki,...i->...k", knn_points, normal) + constant[..., None]
    )
    resid_ok = torch.amax(dists, dim=-1) <= residual_threshold
    return normal, constant, eta_ok & resid_ok


def fit_plane_masked(
    points: torch.Tensor,  # [..., C, 3] candidate neighbors
    sel: torch.Tensor,  # [..., C] bool
    eta_threshold: float = 0.2,
    residual_threshold: float = 0.1,
):
    """``fit_plane_knn`` on the candidates selected by a mask."""
    m = sel.to(points.dtype)[..., None]
    cnt = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
    centroid = torch.sum(points * m, dim=-2, keepdim=True) / cnt
    scatter = _scatter3((points - centroid) * m)
    eig = sym3x3_eigvals(scatter)
    svals = torch.sqrt(torch.clamp(eig, min=0.0))
    eta_ok = svals[..., 2] / (svals[..., 1] + 1e-6) <= eta_threshold
    normal = sym3x3_min_eigvec(scatter, eig)
    normal = torch.where(eta_ok[..., None], normal, torch.zeros_like(normal))
    constant = -torch.sum(normal * centroid[..., 0, :], dim=-1)
    dists = torch.abs(
        torch.einsum("...ki,...i->...k", points, normal) + constant[..., None]
    )
    dists = torch.where(sel, dists, torch.zeros_like(dists))
    resid_ok = torch.amax(dists, dim=-1) <= residual_threshold
    return normal, constant, eta_ok & resid_ok
