"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  A CUDA kernel has no CPU mode, so these tests are marked
``gpu`` and skip where no card is present; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.admission import functional_qos as fq
from repro_torch.core import u32
from repro_torch.kernels import ops, qos_admission, ref
from repro_torch.kernels.paged_decode import paged_decode

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("S,wrap,density", [(3, False, 0.8), (7, True, 0.9),
                                            (2, False, 0.0)])
def test_qos_kernel_bit_exact(cuda, S, wrap, density):
    rng = np.random.default_rng(S)
    N, T = 300, 64
    st = fq.make_qos(rng.uniform(0.5, 3, S), table_size=T, device=cuda)
    b = u32.u32(np.full(S, (1 << 32) - 40 if wrap else 5), device=cuda)
    st = st._replace(ticket=b, grant=b, consumed=b)
    ids = torch.as_tensor(rng.integers(0, S, N).astype(np.int32), device=cuda)
    st, tks, _, _ = fq.qos_take(st, ids, torch.ones(N, dtype=torch.bool,
                                                    device=cuda))
    alive = torch.as_tensor(rng.random(N) < density, device=cuda)
    dls = torch.as_tensor(np.where(rng.random(N) < 0.3, rng.uniform(-1, 1, N),
                                   np.inf).astype(np.float32), device=cuda)
    want = fq.qos_round(st, ids, tks, alive, dls, 0.0, 40, 32)
    got = qos_admission.qos_round_fused(st, ids, tks, alive, dls, 0.0, 40,
                                        max_units=32)
    for g, w in zip(got[0], want[0]):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("H,KV,hd", [(1, 1, 96), (4, 2, 64), (14, 2, 64)])
def test_paged_decode_kernel_close(cuda, H, KV, hd):
    rng = np.random.default_rng(hd)
    S, NB, BS, MB = 9, 64, 8, 6
    lens = rng.integers(0, MB * BS + 1, S).astype(np.int32)
    lens[0] = 0
    tbl = np.full((S, MB), -1, np.int32)
    ids, p = rng.permutation(NB), 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((S, H, hd), generator=g, device=cuda)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    args = (q, kp, vp, torch.as_tensor(tbl, device=cuda),
            torch.as_tensor(lens, device=cuda))
    ops.reset_launch_counts()
    got = ops.paged_decode(*args)
    assert ops.launch_counts()["paged_decode"] == 1
    torch.testing.assert_close(got, ref.paged_decode_ref(*args), atol=2e-5,
                               rtol=2e-5)
    assert not got[0].any()
    assert torch.equal(got, paged_decode(*args))
