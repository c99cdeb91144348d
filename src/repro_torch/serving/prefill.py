"""Block-demand arithmetic of the up-front paged mode — the part of
``repro.serving.prefill`` that the up-front path reads.  Chunked prefill
(the chunk plan and the Banker order) is ported in a later slice."""

from __future__ import annotations

import torch


def cdiv(a, b: int):
    return (a + b - 1) // b


def total_block_demand(prompt_len, max_new, block_size: int):
    """Worst-case whole-lifetime block demand of a sequence (every token
    it can ever hold): ``max(⌈(plen + max_new)/BS⌉, 1)``, int32."""
    return torch.clamp(cdiv(prompt_len.to(torch.int32)
                            + max_new.to(torch.int32), block_size), min=1)


def pending_prompt_tokens(pos: torch.Tensor, plen: torch.Tensor,
                          busy: torch.Tensor) -> torch.Tensor:
    """Prompt tokens still waiting to be prefilled across the busy slots
    (identically 0 in the up-front modes).  i32 scalar."""
    return torch.where(busy, torch.clamp(plen - pos, min=0), 0).sum(
        dtype=torch.int32)
