"""Initializers matching the reference's torch-default statistics.

Counterpart: `map_tpu/nn/init.py:20-50`. nn.Linear weight and bias are
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the embedding table is
normal(std = sqrt(2 / (num_fields + embed_size))). Every draw takes an
explicit `torch.Generator` (a CPU one: initialise on the CPU, then move).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def linear_(weight: torch.Tensor, bias, generator: torch.Generator) -> None:
    """torch layout: weight (out, in), so fan_in = weight.shape[1]."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.uniform_(-bound, bound, generator=generator)
    if bias is not None:
        bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def embedding_(weight: torch.Tensor, num_fields: int, embed_size: int,
               generator: torch.Generator) -> None:
    std = math.sqrt(2.0 / float(num_fields + embed_size))
    weight.normal_(0.0, std, generator=generator)
