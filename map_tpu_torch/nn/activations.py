"""Activation zoo. Counterpart: `map_tpu/nn/activations.py:42-55`
(relu / tanh / sigmoid / none / elu / leu / gelu / gelu_new / swish / mish).
`gelu` is the exact-erf form (map_tpu `gelu_erf`, :23)."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def leu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    # alpha*log(x+1) for x>0 else alpha*(exp(x)-1)
    return torch.where(x > 0, alpha * torch.log1p(torch.clamp(x, min=0)),
                       alpha * torch.expm1(torch.clamp(x, max=0)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


_ACTS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    "elu": F.elu,
    "leu": leu,
    "gelu": gelu_erf,
    "gelu_new": gelu_new,
    "swish": swish,
    "mish": mish,
}


def get_act(act) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(act):
        return act
    try:
        return _ACTS[act.lower()]
    except KeyError:
        raise NotImplementedError(f"activation {act!r}") from None


class Activation(torch.nn.Module):
    """A zoo activation as a module, so it can sit in an `nn.Sequential`."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name
