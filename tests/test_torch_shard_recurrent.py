"""The recurrent blocks on each rank's shard under a mesh
(`repro_torch.parallel.shard_recurrent`).

Four gloo ranks on the CPU (`_torch_ranks.recurrent_local`, a subprocess
with its own timeout) run recurrentgemma-9b's and xlstm-350m's smoke
configs on (data 2, model 2) and (data 1, model 4): one train step
(B = 4 × S = 16), a prefill of 16 tokens into 32-slot caches and two
decode steps, with every call of `models.rglru._rglru_coeffs` and of the
mLSTM / sLSTM time step watched by a dispatch mode.  Under a mesh no
product of the RG-LRU's gates takes a DTensor operand — in particular
none split along the dimension it contracts, which torch 2.11's DTensor
cannot lower ("redistribute from S(0) to P(sum)") — and no op inside a
time step takes a DTensor, so a loop over a long sequence dispatches
plain ops.  The meshed train step still equals the single-device step
within 1e-5.  (`test_torch_mesh_train.py` and `test_torch_mesh_serve.py`
hold the same paths to JAX's meshed steps.)"""

from __future__ import annotations

import numpy as np
import pytest

import _torch_ranks as ranks

CASES = (("recurrentgemma-9b", (2, 2)), ("recurrentgemma-9b", (1, 4)),
         ("xlstm-350m", (2, 2)), ("xlstm-350m", (1, 4)))
PHASES = ("train", "prefill", "decode0", "decode1")
B, S, C, N_DECODE = 4, 16, 32, 2
TOL = 1e-5


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return ranks.launch("recurrent_local", 4,
                        tmp_path_factory.mktemp("shard_recurrent"), 300,
                        cases=CASES, B=B, S=S, C=C, n_decode=N_DECODE)


def _id(case):
    arch, dims = case
    return f"{arch}-{dims[0]}x{dims[1]}"


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_recurrent_blocks_run_on_local_shards(res, case, phase):
    """Every product of the RG-LRU's gates runs on local tensors (none on
    a DTensor, so none on one split along its contracted dimension), and
    every op of an mLSTM / sLSTM time step too, in training, in the
    prefill and in each decode step."""
    arch, dims = case
    seen = res[f"{arch}/{dims[0]}x{dims[1]}/{phase}/seen"]
    what = "coeffs" if arch == "recurrentgemma-9b" else "loop"
    assert seen[what + "_calls"] > 0 and seen[what + "_local"] > 0, seen
    assert seen[what + "_split"] == 0, seen
    assert seen[what + "_dtensor"] == 0, seen


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_meshed_recurrent_train_step_matches_single_device(res, case):
    """The meshed train step with the recurrent blocks on local shards
    equals the single-device step: the gradients reach the DTensor
    parameters (a gathered ``u`` and the weights used on batch rows pass
    ``Partial`` gradients back)."""
    arch, dims = case
    key = f"{arch}/{dims[0]}x{dims[1]}"
    for k, v in res[key + "/single"].items():
        np.testing.assert_allclose(res[key + "/mesh"][k], v, rtol=TOL,
                                   atol=1e-6, err_msg=f"{key}: {k}")
