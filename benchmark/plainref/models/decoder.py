"""Shared decoder MLP and its heads (port of clid_slam_tpu/models/decoder.py):
the scaled SDF, occupancy, semantic log-probabilities and color.

The parameters are a plain dataclass of tensors with the JAX layout
(weights [in, out]), because the mapping kernel updates them in place
through its own Adam step rather than through ``torch.optim``.

``bf16=True`` is the JAX package's bfloat16 decoding: activations and
weights are rounded to bf16 before each product, the product accumulates
in f32 (JAX's ``preferred_element_type=jnp.float32``), and the bias and the
activation apply in f32. The rounded operands are multiplied as f32
tensors: a product of two bf16 values is exact in f32, so this is JAX's
arithmetic up to the order of the sum, where a bf16 ``torch.matmul`` would
round each product's output to bf16 before the bias.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch


@dataclass
class MLPParams:
    weights: List[torch.Tensor]  # hidden layer weights [in, out]
    biases: List[torch.Tensor]  # [out]
    w_out: torch.Tensor  # [hidden, out_dim]
    b_out: torch.Tensor  # [out_dim]

    def tensors(self) -> List[torch.Tensor]:
        """Leaves in the JAX tree order (weights, biases, w_out, b_out)."""
        return [*self.weights, *self.biases, self.w_out, self.b_out]

    def clone(self) -> "MLPParams":
        return MLPParams(
            [w.clone() for w in self.weights],
            [b.clone() for b in self.biases],
            self.w_out.clone(),
            self.b_out.clone(),
        )


def init_mlp(
    generator: torch.Generator,
    input_dim: int,
    hidden_dim: int,
    hidden_level: int,
    out_dim: int = 1,
    bias_on: bool = True,
    device=None,
) -> MLPParams:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) init (torch Linear's
    default, what the reference decoder trains from)."""
    dev = generator.device if device is None else device

    def uni(shape, bound):
        u = torch.rand(shape, generator=generator, device=dev)
        return (u * 2.0 - 1.0) * bound

    weights, biases = [], []
    dim = input_dim
    for _ in range(hidden_level):
        bound = 1.0 / math.sqrt(dim)
        weights.append(uni((dim, hidden_dim), bound))
        biases.append(
            uni((hidden_dim,), bound)
            if bias_on
            else torch.zeros(hidden_dim, device=dev)
        )
        dim = hidden_dim
    bound = 1.0 / math.sqrt(dim)
    w_out = uni((dim, out_dim), bound)
    b_out = uni((out_dim,), bound) if bias_on else torch.zeros(out_dim, device=dev)
    return MLPParams(weights, biases, w_out, b_out)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and held as float32 (so is its gradient)."""
    return x.to(torch.bfloat16).to(torch.float32)


def mlp_forward(
    params: MLPParams, x: torch.Tensor, leaky: bool = False, bf16: bool = False
) -> torch.Tensor:
    """[..., D] -> [..., out_dim]: full f32, or bf16 operands with f32
    accumulation and an f32 output (``bf16``)."""
    if not bf16:
        h = x
        for w, b in zip(params.weights, params.biases):
            h = h @ w + b
            h = torch.nn.functional.leaky_relu(h) if leaky else torch.relu(h)
        return h @ params.w_out + params.b_out
    h = _bf16(x)
    for w, b in zip(params.weights, params.biases):
        h = h @ _bf16(w) + _bf16(b)
        h = _bf16(torch.nn.functional.leaky_relu(h) if leaky else torch.relu(h))
    return h @ _bf16(params.w_out) + params.b_out


def sdf(params: MLPParams, feature: torch.Tensor, sdf_scale, **kw) -> torch.Tensor:
    """Scaled SDF prediction: [..., D] -> [...]."""
    return mlp_forward(params, feature, **kw)[..., 0] * sdf_scale


def occupancy(params: MLPParams, feature: torch.Tensor, sdf_scale, **kw) -> torch.Tensor:
    """Occupancy probability: sigmoid(-sdf / sdf_scale)."""
    return torch.sigmoid(sdf(params, feature, sdf_scale, **kw) / -sdf_scale)


def sem_label_prob(params: MLPParams, feature: torch.Tensor, **kw) -> torch.Tensor:
    """Semantic class log-probabilities: [..., D] -> [..., classes]."""
    return torch.log_softmax(mlp_forward(params, feature, **kw), dim=-1)


def regress_color(params: MLPParams, feature: torch.Tensor, **kw) -> torch.Tensor:
    """Color or intensity in [0, 1]: [..., D] -> [..., channels]."""
    return torch.sigmoid(mlp_forward(params, feature, **kw))
