"""Map-based dynamic-object filter (port of
clid_slam_tpu/mapping/dynamic_filter.py).

A measurement is dynamic when it lands in confidently observed free space:
map certainty above a threshold while the predicted SDF is well positive
(strategy 1). A point in certain space also needs an SDF gradient norm
above ``MIN_GRAD_NORM`` to stay (strategy 2, on in the JAX frame step).

The query runs through ``models/neural_map.py:query_feature`` (the probe's
hash-mirror gather on ``gather_rows``, the kNN selection on
``gather_lanes``), and the gradient wrt the points through autograd.
"""

from __future__ import annotations

import torch

from ..device import on_device
from ..models import decoder as dec
from ..models import neural_map as nm

MIN_GRAD_NORM = 0.1  # the JAX filter's default, which its frame step keeps


def make_dynamic_filter_fn(
    *,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    certainty_thre: float,
    sdf_ratio_thre: float,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    rotate_vecs: bool = False,
    encode_vecs=None,
):
    """Returns ``static_mask(map_state, mlp, points_world[N,3], mask[N],
    travel_dist, cur_ts, window) -> [N] bool``, detached. The query takes
    no ``layer_norm``, as the JAX filter's does not."""
    offs_t = on_device(torch.as_tensor(nb_offs))

    def static_mask(map_state, mlp, points_world, mask, travel_dist, cur_ts, window):
        with torch.enable_grad():
            pts = points_world.detach().requires_grad_(True)
            q = nm.query_feature(
                map_state, pts, offs_t(pts.device), resolution, max_valid_dist2,
                knn_k, travel_dist, cur_ts, window, True, rotate_vecs=rotate_vecs,
                encode_vecs=encode_vecs,
            )
            pred = dec.sdf(mlp, q.feature, sdf_scale, leaky=mlp_leaky, bf16=mlp_bf16)
            (grad,) = torch.autograd.grad(pred.sum(), pts)
        pred = pred.detach()
        uncertain = q.certainty < certainty_thre
        # strategy 1 (utils/mapper.py:122-126): certain free space -> dynamic
        static = uncertain | (pred < sdf_ratio_thre * resolution)
        # strategy 2 (:129-134): unstable gradient in certain space
        grad_norm = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-20)
        static = static & ((grad_norm > MIN_GRAD_NORM) | uncertain)
        return static & mask

    return static_mask
