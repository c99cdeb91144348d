"""The port's engine (`repro_torch.serving.scheduler.
ContinuousBatchingEngine.megastep`) against the JAX engine on one request
trace: three tenants at weights 4:2:1, deadlines that expire rows in the
backlog and preempt running slots, the block-paged pool in up-front mode.

Bit-equal: token streams, admit/expire rounds, every drained telemetry
sample (health, ``kv_wait_hist`` and the event rows included),
``host_syncs``, the final QoS state, block tables, the pool's counters and
free queue, and the model's ``kp``/``vp`` pools."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import engine_state as jes
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.serving import engine_state as tes
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

DT = 0.25  # f32-exact virtual-time grid
WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
NB, BS, MB = 8, 4, 4
K = 8


def _trace(seed: int, n_req: int = 14):
    rng = np.random.default_rng(seed)
    names = list(WEIGHTS)
    out = []
    for i in range(n_req):
        dl = DT * int(rng.integers(2, 20)) if rng.random() < 0.6 else None
        out.append(dict(rid=i, prompt=[int(x) for x in
                                       rng.integers(1, 50,
                                                    int(rng.integers(1, 7)))],
                        max_new_tokens=int(rng.integers(1, 11)),
                        tenant_id=names[int(rng.integers(0, 3))],
                        deadline=dl))
    return out


def _engines(clk, *, use_kernel, paged, wrap):
    kw = dict(tenants=dict(WEIGHTS), use_kernel=use_kernel,
              clock=lambda: clk[0], prompt_cap=8,
              kv_pool=(NB, BS, MB) if paged else None)
    je = JEngine(lambda a: None, lambda r: None, 3, **kw)
    if wrap:  # per-tenant ticket sequences straddle 2³² during the run
        base = jnp.uint32((1 << 32) - 7)
        S = len(WEIGHTS)
        je.qos = je.qos._replace(ticket=jnp.full((S,), base),
                                 grant=jnp.full((S,), base),
                                 consumed=jnp.full((S,), base))
    te = TEngine(lambda a: None, lambda r: None, 3, device="cpu", **kw)
    te.qos = convert.qos_from_jax(je.qos)
    return je, te


def _run(seed, *, use_kernel=False, paged=True, wrap=False, model=False):
    clk = [0.0]
    je, te = _engines(clk, use_kernel=use_kernel, paged=paged, wrap=wrap)
    jkw, tkw = {}, {}
    if model:
        jm = jes.make_paged_pool_model(jax.random.PRNGKey(0), vocab=50, d=16,
                                       num_blocks=NB, block_size=BS)
        je.megastep_model = jm
        te.megastep_model = convert.model_from_jax(
            {k: np.asarray(v) for k, v in jm.items()})
        jkw = dict(token_fn=jes.paged_pool_token_fn,
                   admit_fn=jes.paged_pool_admit_fn)
        tkw = dict(token_fn=tes.paged_pool_token_fn,
                   admit_fn=tes.paged_pool_admit_fn)
    else:
        jkw = dict(token_fn=jes.rid_token_fn)
        tkw = dict(token_fn=tes.rid_token_fn)
    if use_kernel:  # "auto" picks the Pallas kernel only on a TPU
        jkw["admit_impl"] = jes.fused_round_impl
    trace = _trace(seed)
    jr = [JRequest(**t) for t in trace]
    tr = [TRequest(**t) for t in trace]
    je.submit_batch(jr)
    te.submit_batch(tr)
    nows = [k * DT for k in range(K)]
    stalls = 0
    for launch in range(6):
        je.megastep(K, nows=nows, **jkw)
        te.megastep(K, nows=nows, **tkw)
        js, ts = (e.telemetry()["last_samples"] for e in (je, te))
        assert ts == js, f"launch {launch}: telemetry samples differ"
        assert all(s["health"] == 0 for s in ts)
        stalls += sum(s["gate_stalls"] for s in ts)
        clk[0] += K * DT
        if all(r.done_event.is_set() for r in jr):
            break
    assert all(r.done_event.is_set() for r in tr)
    return je, te, jr, tr, stalls


def _check(je, te, jr, tr, model):
    for a, b in zip(jr, tr):
        assert (b.out_tokens, b.admit_round, b.expire_round, b.preempted,
                b.expired) == (a.out_tokens, a.admit_round, a.expire_round,
                               a.preempted, a.expired), a.rid
    assert te.stats.host_syncs == je.stats.host_syncs
    assert te.stats.__dict__ == {k: v for k, v in je.stats.__dict__.items()}
    assert te._qos_free == je._qos_free
    tq = convert.to_numpy(te.qos)
    for f in je.qos._fields:
        np.testing.assert_array_equal(tq[f], np.asarray(getattr(je.qos, f)),
                                      err_msg=f)
    tel_t, tel_j = te.telemetry(), je.telemetry()
    for key in tel_t:
        assert tel_t[key] == tel_j[key], key
    if je._kv_pool is None:
        return
    jkv, tkv = je._kv_state, te._kv_state
    np.testing.assert_array_equal(tkv.tbl.numpy(), np.asarray(jkv.tbl))
    tp = convert.to_numpy(tkv.pool)
    for f in ("sema.ticket", "sema.grant", "sema.bucket_seq", "free_q",
              "refcnt", "gen"):
        ref = jkv.pool
        for part in f.split("."):
            ref = getattr(ref, part)
        np.testing.assert_array_equal(tp[f], np.asarray(ref), err_msg=f)
    if model:
        for k in ("kp", "vp", "emb", "wo"):
            np.testing.assert_array_equal(
                te.megastep_model[k].numpy(),
                np.asarray(je.megastep_model[k]), err_msg=k)


RUNS = {
    # name: (seed, use_kernel, paged, wrap, model)
    "rid-functional-paged": (24, False, True, False, False),
    "rid-kernel-paged": (26, True, True, False, False),
    "rid-kernel-unpaged": (30, True, False, False, False),
    "pool-model-kernel": (33, True, True, False, True),
    "rid-kernel-paged-wrap": (38, True, True, True, False),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_megastep_matches_jax_engine(name):
    seed, use_kernel, paged, wrap, model = RUNS[name]
    je, te, jr, tr, stalls = _run(seed, use_kernel=use_kernel, paged=paged,
                                  wrap=wrap, model=model)
    # the trace must reach every path: backlog expiry, decode preemption,
    # and (paged) block-gate stalls
    assert any(r.preempted for r in jr)
    assert any(r.expired and not r.preempted for r in jr)
    assert stalls > 0 or not paged
    _check(je, te, jr, tr, model)
