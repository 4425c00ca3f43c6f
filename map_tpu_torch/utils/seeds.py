"""The seeds of a run's generators, each derived from the run seed.

A run draws from four streams: the initial weights, dropout, the train
steps' masks and noise, and the eval passes' masks and noise. map_tpu
splits one key three ways (`map_tpu/train/trainer.py:158-159`); the port
derives one 63-bit seed a stream by `np.random.SeedSequence([seed, stream,
index])`, so no two streams meet, within a run or across run seeds s and
s + 1 (seeding them `seed`, `seed + 1`, `seed + 2` made seed s's step draws
seed s + 1's initial weights). `index` tells apart the dropout streams of
data ranks; ranks of one model group share theirs.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("init", "dropout", "step", "eval")


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    """The 63-bit seed of `stream` (one of STREAMS) in the run of `seed`."""
    entropy = [int(seed) % 2 ** 64, STREAMS.index(stream), int(index)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def stream_generator(seed: int, stream: str, index: int = 0,
                     device=None) -> torch.Generator:
    """A generator on `device` (None: the CPU) seeded `stream_seed(...)`."""
    gen = torch.Generator() if device is None else torch.Generator(device=device)
    return gen.manual_seed(stream_seed(seed, stream, index))
