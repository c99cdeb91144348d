"""The bf16 flash wrapper's route by shape, on the CPU (no card needed:
the predicate reads shapes, the dtype and addresses only), and the launch
counters' keys.

`kernels.flash_attention.wgmma_route` sends bf16 q (B, Sq, H, hd), k/v
(B, Sk, KV, hd) to the wgmma kernel where hd is 64, 128 or 256, 1 <= H /
KV <= 128, no dimension is empty and every tensor is 16-byte aligned;
everything else bf16 takes the mma.sync instantiation.  Both routes count
as ``flash_attention_bf16`` launches; `ops.flash_routes` counts them
apart, and `ops.reset_launch_counts` zeroes both."""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops


def _qkv(B=1, Sq=40, Sk=40, H=14, KV=2, hd=64, dtype=torch.bfloat16,
         offset=0):
    n = B * Sq * H * hd
    q = torch.zeros(n + offset, dtype=dtype)[offset:].view(B, Sq, H, hd)
    k = torch.zeros((B, Sk, KV, hd), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("kw,want", [
    ({}, True), ({"hd": 128, "H": 16, "KV": 16}, True),
    ({"hd": 256, "H": 16, "KV": 1}, True), ({"H": 128, "KV": 1}, True),
    ({"Sq": 300, "Sk": 7, "B": 3}, True),
    ({"hd": 16}, False), ({"hd": 40}, False), ({"hd": 96}, False),
    ({"H": 256, "KV": 1}, False), ({"Sk": 0}, False), ({"Sq": 0}, False),
    ({"dtype": torch.float32}, False), ({"offset": 1}, False),
    ({"offset": 8}, True)])
def test_wgmma_route_predicate(kw, want):
    q, k, v = _qkv(**kw)
    if "offset" in kw:
        assert q.is_contiguous()
        assert (q.data_ptr() % 16 == 0) == (kw["offset"] % 8 == 0)
    assert fa.wgmma_route(q, k, v) is want


def test_launch_counts_keep_their_keys_and_routes_reset():
    """`ops.launch_counts` keeps exactly its eight keys; the routes are
    two, and a reset zeroes them."""
    assert set(ops.launch_counts()) == {
        "qos_round_fused", "paged_decode", "paged_prefill", "sema_batch",
        "decode_attention", "flash_attention", "decode_attention_bf16",
        "flash_attention_bf16"}
    fa.ROUTES["wgmma"] += 3
    assert ops.flash_routes()["wgmma"] >= 3
    ops.reset_launch_counts()
    assert ops.flash_routes() == {"wgmma": 0, "mma_sync": 0}
    assert not any(ops.launch_counts().values())
