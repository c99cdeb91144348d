"""The bf16 residual sum before an ``rms_norm``, against JAX on the CPU.

XLA takes a bf16 residual sum ``x + d`` in f32 and rounds it for the
stream, but a norm that reads the sum in the same straight-line region of
the program gets the f32 value unrounded; a loop boundary (the
reference's scan over units) rounds it.  So inside a block (``x +
attn_out`` → ``ln2``, the RG-LRU's ``x + out`` → ``ln2``, the sLSTM's ``x
+ out`` → ``ffn_ln``), from one block to the next inside a unit, and
from the last suffix block to the final norm, the norm reads the
unrounded sum; from the prefix into the units, from unit to unit and
from the units out, it reads the rounded stream (`models.transformer`'s
`_block`).

Each case runs the port as it is and the port with every residual sum
rounded before its norm (`layers.residual` patched to round), against
JAX's jitted function on the same bf16 parameters and inputs, and holds
the share of outputs bit-equal to JAX to rise to at least the floor the
case states."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.models import layers as tl
from repro_torch.models import rglru as tr
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as tx


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)


def _rounded(x, d):
    """The residual sum rounded to the stream's dtype first: the port
    before the repair."""
    return (x + d).float()


def _shares(monkeypatch, port_fn, want) -> tuple:
    """(bit-equal share of the port's output as it is, the same with
    every residual sum rounded before its norm)."""
    with torch.no_grad():
        now = port_fn()
        with monkeypatch.context() as m:
            for mod in (tl, tx, tr, tt):
                m.setattr(mod, "residual", _rounded)
            before = port_fn()
    w = _f32(want)
    assert now.dtype == before.dtype == torch.bfloat16
    return float(np.mean(_f32(now) == w)), float(np.mean(_f32(before) == w))


def _slstm_case():
    p = jx.init_slstm(jax.random.PRNGKey(1), 64, 4, jnp.bfloat16)
    jxv, txv = _x((2, 16, 64), 0)
    want, _ = jax.jit(lambda p, x: jx.slstm_forward(p, x, 4))(p, jxv)
    tp = convert.params_from_jax(p, device="cpu")
    return lambda: tx.slstm_forward(tp, txv, 4)[0], want


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The smoke config's bf16 parameters from JAX's jitted init."""
    jc = j_smoke(arch)
    return jax.jit(lambda k: jt.init_params(k, jc, jnp.bfloat16))(
        jax.random.PRNGKey(3))


def _stack_case(arch):
    """The whole stack of the smoke config at B=2, S=16 (train mode, no
    remat): the sums from block to block inside each unit and from the
    suffix to the final norm."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    params = _params(arch)
    jxv, txv = _x((2, 16, jc.d_model), 5)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    want, _, _ = jax.jit(lambda p, x, q: jt.forward_hidden(
        p, jc, x, q, None, "train", remat="none"))(params, jxv,
                                                   jnp.asarray(pos))
    tp = convert.params_from_jax(params, device="cpu")
    return (lambda: tt.forward_hidden(tp, tc, txv, torch.as_tensor(pos), None,
                                      "train", remat="none")[0]), want


# case → (its builder, the floor its bit-equal share must reach).  The
# floors are this repair's readings, rounded down: the stacks of the
# other kinds keep gaps that come from elsewhere (MoE near-ties, f32
# transcendentals), which the other bf16 tests hold within their limits
CASES = {
    "slstm block (x + out -> ffn_ln)": (_slstm_case, 1.0),
    "qwen2-0.5b stack (x + attn_out -> ln2)":
        (lambda: _stack_case("qwen2-0.5b"), 1.0),
    "recurrentgemma-9b stack (rglru x + out -> ln2, in-unit, suffix -> "
    "final_ln)": (lambda: _stack_case("recurrentgemma-9b"), 0.7),
    "xlstm-350m stack (mlstm -> slstm, slstm x + out -> ffn_ln)":
        (lambda: _stack_case("xlstm-350m"), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_residual_sum_reaches_norm_unrounded(case, monkeypatch):
    build, floor = CASES[case]
    port_fn, want = build()
    now, before = _shares(monkeypatch, port_fn, want)
    print(f"{case}: bit-equal {before:.4f} -> {now:.4f}")
    assert now > before
    assert now >= floor


def test_residual_is_the_stream_unrounded():
    """`layers.residual` rounded is the stream's own sum, at bf16 and f32,
    and at f32 it is the sum itself."""
    _, a = _x((4, 64), 0)
    _, b = _x((4, 64), 1)
    assert torch.equal(tl.residual(a, b).to(torch.bfloat16), a + b)
    assert tl.residual(a, b).dtype == torch.float32
    a32, b32 = a.float() * 1.1, b.float() * 0.9
    assert torch.equal(tl.residual(a32, b32), a32 + b32)
