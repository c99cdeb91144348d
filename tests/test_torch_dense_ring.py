"""The dense-ring demo model (`make_paged_attn_model`,
`paged_attn_admit_fn`, `paged_attn_token_fn`) in the port's QoS
``megastep(K)`` against the same model in the JAX engine, on one trace:
three tenants at 4:2:1, deadlines that expire backlog rows and preempt
running slots, rings of 10 rows that the longer requests wrap (masking by
the stored positions).

Bit-equal: token streams, admit/expire rounds, every drained telemetry
sample with its event rows, ``host_syncs``, and the model's rings (K, V
and positions); attention on the CPU runs the decode kernel's plain
version (`ref.single_query_attention`) — the argmax streams
must agree, so its f32 differences from JAX's oracle stay below any
logit gap of the trace."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.serving import engine_state as jes
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.serving import engine_state as tes
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

DT = 0.25
WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
S, C, K = 3, 10, 8


def _trace(seed: int, n_req: int = 14):
    rng = np.random.default_rng(seed)
    names = list(WEIGHTS)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, 50, int(rng.integers(1, 7)))],
        max_new_tokens=int(rng.integers(1, 11)),
        tenant_id=names[int(rng.integers(0, 3))],
        deadline=(DT * int(rng.integers(2, 20)) if rng.random() < 0.6
                  else None))
        for i in range(n_req)]


@pytest.mark.parametrize("seed,use_kernel", [(41, True), (43, False)])
def test_dense_ring_megastep_matches_jax(seed, use_kernel):
    clk = [0.0]
    kw = dict(tenants=dict(WEIGHTS), use_kernel=use_kernel,
              clock=lambda: clk[0], prompt_cap=8)
    je = JEngine(lambda a: None, lambda r: None, S, **kw)
    te = TEngine(lambda a: None, lambda r: None, S, device="cpu", **kw)
    te.qos = convert.qos_from_jax(je.qos, device="cpu")
    jm = jes.make_paged_attn_model(jax.random.PRNGKey(0), vocab=50, d=16,
                                   n_slots=S, capacity=C)
    je.megastep_model = jm
    te.megastep_model = convert.tree_from_jax(
        {k: np.asarray(v) for k, v in jm.items()}, device="cpu")
    jkw = dict(token_fn=jes.paged_attn_token_fn,
               admit_fn=jes.paged_attn_admit_fn)
    tkw = dict(token_fn=tes.paged_attn_token_fn,
               admit_fn=tes.paged_attn_admit_fn)
    if use_kernel:  # "auto" picks the Pallas kernel only on a TPU
        jkw["admit_impl"] = jes.fused_round_impl
    trace = _trace(seed)
    jr = [JRequest(**t) for t in trace]
    tr = [TRequest(**t) for t in trace]
    je.submit_batch(jr)
    te.submit_batch(tr)
    nows = [k * DT for k in range(K)]
    for launch in range(8):
        je.megastep(K, nows=nows, **jkw)
        te.megastep(K, nows=nows, **tkw)
        js, ts = (e.telemetry()["last_samples"] for e in (je, te))
        assert ts == js, f"launch {launch}: telemetry samples differ"
        clk[0] += K * DT
        if all(r.done_event.is_set() for r in jr):
            break
    assert all(r.done_event.is_set() for r in tr)
    for a, b in zip(jr, tr):
        assert (b.out_tokens, b.admit_round, b.expire_round, b.preempted,
                b.expired) == (a.out_tokens, a.admit_round, a.expire_round,
                               a.preempted, a.expired), a.rid
    assert te.stats.__dict__ == je.stats.__dict__
    assert te.stats.host_syncs == launch + 1
    for k in ("k", "v", "pos", "emb", "wo"):
        np.testing.assert_array_equal(te.megastep_model[k].numpy(),
                                      np.asarray(je.megastep_model[k]),
                                      err_msg=k)
    # the trace reaches preemption and the ring wrap
    assert any(r.preempted for r in tr)
    assert any(len(r.prompt) + len(r.out_tokens) > C for r in tr)


def test_dense_ring_model_defaults_to_the_card():
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tes.make_paged_attn_model(torch.Generator(), 8, 4, 2, 4)
    m = tes.make_paged_attn_model(torch.Generator().manual_seed(0), 8, 4, 2,
                                  4, device="cpu")
    assert m["pos"].dtype == torch.int32 and bool((m["pos"] == -1).all())
