"""MFP input corruption. Counterpart: `map_tpu/objectives/corruption.py:35-83`
(`mask_num_of`, `sample_masked_index`, `mfp_corrupt`).

The masked positions are drawn on the ids' device from an explicit
`torch.Generator`, or handed in (the tests give the port map_tpu's own
draws). `mfp_corrupt` takes them as an argument: labels are the original ids
at the masked positions (an integer gather; map_tpu's one-hot dot gives the
same values while ids stay below 2**24), and every masked position becomes
the literal `<mask>` id 3 (the reference's trainer.py:229-232). Duplicate
positions (randint sampling) write the same id, so the result does not
depend on the order of the writes.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK_ID = 3


def mask_num_of(num_fields: int, mask_ratio: float) -> int:
    return int(num_fields * mask_ratio)  # the reference's trainer.py:220


def sample_masked_index(generator: torch.Generator, batch_size: int,
                        num_fields: int, mask_num: int, sampling_method: str,
                        device: torch.device) -> torch.Tensor:
    """(B, mask_num) int64 field positions. 'normal': a random subset of
    each row without repeats (top-k of uniforms, as map_tpu); 'randint':
    with repeats."""
    if sampling_method == "normal":
        u = torch.rand(batch_size, num_fields, generator=generator, device=device)
        return torch.topk(u, mask_num, dim=1).indices
    if sampling_method == "randint":
        return torch.randint(0, num_fields, (batch_size, mask_num),
                             generator=generator, device=device)
    raise NotImplementedError(sampling_method)


def mfp_corrupt(input_ids: torch.Tensor, masked_index: torch.Tensor,
                mask_id: int = MASK_ID) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F) ids, (B, M) positions -> (corrupted (B, F), labels (B, M)),
    both in the ids' dtype."""
    masked_index = masked_index.long()
    labels = torch.gather(input_ids, 1, masked_index)
    corrupted = input_ids.scatter(1, masked_index, mask_id)
    return corrupted, labels
