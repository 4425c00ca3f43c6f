"""MFP and RFD input corruption. Counterpart:
`map_tpu/objectives/corruption.py:35-175` (`mask_num_of`,
`sample_masked_index`, `mfp_corrupt`, `rfd_corrupt`).

The masked positions are drawn on the ids' device from an explicit
`torch.Generator`, or handed in (the tests give the port map_tpu's own
draws). `mfp_corrupt` takes them as an argument: labels are the original ids
at the masked positions (an integer gather; map_tpu's one-hot dot gives the
same values while ids stay below 2**24), and every masked position becomes
the literal `<mask>` id 3 (the reference's trainer.py:229-232). Duplicate
positions (randint sampling) write the same id, so the result does not
depend on the order of the writes.

`rfd_corrupt` replaces the masked positions' ids with one of four
generators (the reference's trainer.py:234-260): `Unigram`, the same field
of a random train row (the batch's `noise_rows`, one a masked position);
`Uniform`, uniform within the field's id block; `Whole-Uniform`, uniform
over [10, V); `Whole-Unigram`, a random field of a random train row. Its
random numbers are an `RFDDraws`, drawn by `draw_rfd` or handed in (the
tests give the port map_tpu's own). A position masked twice (randint
sampling) takes its last draw, map_tpu's deterministic last-wins rule; the
labels are 1.0 where the corrupted id differs from the original.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from map_tpu_torch.data.dataset import NUM_RESERVED

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


class RFDDraws(NamedTuple):
    """One batch's RFD draws: masked positions (B, M), and the generator's
    own: the uniforms (B * M,) float32 of `Uniform`, the ids (B, M) of
    `Whole-Uniform`, the fields (B * M,) of `Whole-Unigram`; None for
    `Unigram`, which reads the batch's noise rows."""

    masked_index: torch.Tensor
    replace: Optional[torch.Tensor] = None


def draw_rfd(generator: torch.Generator, batch_size: int, num_fields: int,
             mask_num: int, sampling_method: str, rfd_replace: str,
             input_size: int, device: torch.device) -> RFDDraws:
    masked_index = sample_masked_index(generator, batch_size, num_fields, mask_num,
                                       sampling_method, device)
    n = batch_size * mask_num
    if rfd_replace == "Unigram":
        replace = None
    elif rfd_replace == "Uniform":
        replace = torch.rand(n, generator=generator, device=device)
    elif rfd_replace == "Whole-Uniform":
        replace = torch.randint(NUM_RESERVED, input_size, (batch_size, mask_num),
                                generator=generator, device=device, dtype=torch.int32)
    elif rfd_replace == "Whole-Unigram":
        replace = torch.randint(0, num_fields, (n,), generator=generator, device=device)
    else:
        raise NotImplementedError(rfd_replace)
    return RFDDraws(masked_index, replace)


def rfd_corrupt(input_ids: torch.Tensor, draws: RFDDraws, rfd_replace: str,
                idx_low: Optional[torch.Tensor] = None,
                idx_high: Optional[torch.Tensor] = None,
                noise_rows: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F) ids -> (corrupted (B, F) in the ids' dtype, labels (B, F)
    float32, 1.0 where replaced). idx_low / idx_high (F,) for `Uniform`;
    noise_rows (B * M, F) for the Unigram generators."""
    b, f = input_ids.shape
    mi = draws.masked_index.long()
    m = mi.shape[1]
    flat_pos = mi.reshape(-1)
    rows = torch.arange(b * m, device=input_ids.device)
    if rfd_replace == "Unigram":
        if noise_rows is None or noise_rows.shape[0] != b * m:
            raise ValueError(f"Unigram RFD needs ({b * m}, {f}) noise rows")
        replace = noise_rows[rows, flat_pos]
    elif rfd_replace == "Uniform":
        if idx_low is None or idx_high is None:
            raise ValueError("Uniform RFD needs the fields' id ranges")
        lo, hi = idx_low[flat_pos], idx_high[flat_pos]
        replace = lo + torch.floor(draws.replace * (hi - lo).float()).to(lo.dtype)
    elif rfd_replace == "Whole-Uniform":
        replace = draws.replace.reshape(-1)
    elif rfd_replace == "Whole-Unigram":
        if noise_rows is None or noise_rows.shape[0] != b * m:
            raise ValueError(f"Whole-Unigram RFD needs ({b * m}, {f}) noise rows")
        replace = noise_rows[rows, draws.replace.long()]
    else:
        raise NotImplementedError(rfd_replace)
    replace = replace.to(input_ids.dtype).reshape(b, m)
    # the last occurrence of each masked field writes it (integer sums of one
    # nonzero term: exact at any id width)
    onehot = mi[:, :, None] == torch.arange(f, device=mi.device)          # (B, M, F)
    later = torch.triu(torch.ones(m, m, dtype=torch.bool, device=mi.device), 1)
    is_last = onehot & ~((onehot[:, None, :, :] & later[None, :, :, None]).any(2))
    vals = torch.where(is_last, replace.long()[:, :, None], 0).sum(1)
    corrupted = torch.where(onehot.any(1), vals.to(input_ids.dtype), input_ids)
    return corrupted, (input_ids != corrupted).float()
