"""The port's engine with continuous chunked prefill, alone and with the
prefix cache (`repro_torch.serving.scheduler.ContinuousBatchingEngine
(..., chunked_prefill=..., prefix_cache=...).megastep`), against the JAX
engine on one request trace: two tenants at weights 2:1, a 16-block pool
that the lifetime demand oversubscribes, deadlines, and prompts that
repeat an 8-token system prompt (and, often, a recent request's whole
prompt).  The traces reach parks and resumes, preemption of a slot in
mid-prefill, backlog expiry and, with the cache, prefix attaches, fully
covered admits and copy-on-write copies — each asserted.

Bit-equal: token streams, admit/expire rounds, every drained telemetry
sample (events included), ``host_syncs`` and the stats, ``telemetry()``,
the block tables, the pool's free queue, refcounts, generations and
semaphore, the prefix cache, and the model's ``kp``/``vp`` pools.  Runs
with ``rid_token_fn`` and with the paged-pool model through
``make_chunked_prefill_token_fn`` and ``chunked_prefill_token_fn`` (the
chunk write through `kernels.ops.paged_prefill`'s plain version here).  Then the submit-time
rejections: over ``prompt_cap``, over capacity, and the post-divergence
demand that a cached prefix makes servable."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.serving import engine_state as jes
from repro.serving.events import (EV_COW, EV_PARK, EV_PREEMPT,
                                  EV_PREFILL_CHUNK, EV_PREFIX_ATTACH,
                                  EV_RESUME)
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.serving import engine_state as tes
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

DT = 0.25  # f32-exact virtual-time grid
WEIGHTS = {"gold": 2.0, "bronze": 1.0}
NB, BS, MB = 16, 4, 8
CHUNK = (5, 9, 16)
K = 8


def _trace(seed: int, n_req: int = 16):
    """A system prompt of 8 tokens plus a tail of 0–10 tokens; from the
    fifth request on, 40% repeat one of the four previous prompts token
    for token (full covers while the holder still lives)."""
    rng = np.random.default_rng(seed)
    names = list(WEIGHTS)
    out = []
    for i in range(n_req):
        dl = DT * int(rng.integers(1, 24)) if rng.random() < 0.35 else None
        if i >= 4 and rng.random() < 0.4:
            prompt = list(out[int(rng.integers(i - 4, i))]["prompt"])
        else:
            prompt = [7] * 8 + [1 + int(x) for x in
                                rng.integers(1, 6, int(rng.integers(0, 11)))]
        out.append(dict(rid=i, prompt=prompt,
                        max_new_tokens=1 + int(rng.integers(0, 12)),
                        tenant_id=names[int(rng.integers(0, 2))],
                        deadline=dl))
    return out


def _engines(clk, *, share, **over):
    kw = dict(tenants=dict(WEIGHTS), use_kernel=True, clock=lambda: clk[0],
              prompt_cap=32, kv_pool=(NB, BS, MB), chunked_prefill=CHUNK,
              prefix_cache=8 if share else 0)
    kw.update(over)
    je = JEngine(lambda a: None, lambda r: None, 4, **kw)
    te = TEngine(lambda a: None, lambda r: None, 4, device="cpu", **kw)
    te.qos = convert.qos_from_jax(je.qos, device="cpu")
    return je, te


def _run(seed, *, share, model):
    clk = [0.0]
    je, te = _engines(clk, share=share)
    if model:
        jm = jes.make_paged_pool_model(jax.random.PRNGKey(0), vocab=50, d=16,
                                       num_blocks=NB, block_size=BS)
        je.megastep_model = jm
        te.megastep_model = convert.model_from_jax(
            {k: np.asarray(v) for k, v in jm.items()}, device="cpu")
        if model == "full":   # the chunk window is the prompt width
            jkw = dict(token_fn=jes.chunked_prefill_token_fn)
            tkw = dict(token_fn=tes.chunked_prefill_token_fn)
        else:
            jkw = dict(token_fn=jes.make_chunked_prefill_token_fn(CHUNK[0]))
            tkw = dict(token_fn=tes.make_chunked_prefill_token_fn(CHUNK[0]))
    else:
        jkw = dict(token_fn=jes.rid_token_fn)
        tkw = dict(token_fn=tes.rid_token_fn)
    trace = _trace(seed)
    jr = [JRequest(**t) for t in trace]
    tr = [TRequest(**t) for t in trace]
    je.submit_batch(jr)
    te.submit_batch(tr)
    nows = [k * DT for k in range(K)]
    samples = []
    for launch in range(14):
        je.megastep(K, nows=nows, **jkw)
        te.megastep(K, nows=nows, **tkw)
        js, ts = (e.telemetry()["last_samples"] for e in (je, te))
        assert ts == js, f"launch {launch}: telemetry samples differ"
        samples += ts
        clk[0] += K * DT
        if all(r.done_event.is_set() for r in jr):
            break
    assert all(r.done_event.is_set() for r in jr + tr)
    assert all(s["health"] == 0 for s in samples)
    return je, te, jr, tr, samples


def _paths(samples, reqs) -> dict:
    """How often the trace reached each path, from the event rows."""
    ev = [e for s in samples for e in s["events"]]
    kinds = [e[0] for e in ev]
    written = {}   # prompt tokens in the pool per request: chunks + cover
    for kind, uid, _, arg in ev:
        if kind in (EV_PREFILL_CHUNK, EV_PREFIX_ATTACH):
            written[uid] = written.get(uid, 0) + arg
    return {
        "park": kinds.count(EV_PARK), "resume": kinds.count(EV_RESUME),
        "attach": kinds.count(EV_PREFIX_ATTACH), "cow": kinds.count(EV_COW),
        "full_cover": sum(s["prefix_hits"] for s in samples),
        "mid_prefill_preempt": sum(
            1 for kind, uid, _, _ in ev if kind == EV_PREEMPT
            and 0 < written.get(uid, 0) < len(reqs[uid].prompt)),
        "backlog_expiry": sum(r.expired and not r.preempted for r in reqs),
    }


def _check(je, te, jr, tr, *, share, model):
    for a, b in zip(jr, tr):
        assert (b.out_tokens, b.admit_round, b.expire_round, b.preempted,
                b.expired) == (a.out_tokens, a.admit_round, a.expire_round,
                               a.preempted, a.expired), a.rid
    assert te.stats.host_syncs == je.stats.host_syncs
    assert te.stats.__dict__ == je.stats.__dict__
    assert te._qos_free == je._qos_free
    tel_t, tel_j = te.telemetry(), je.telemetry()
    for key in tel_t:
        assert tel_t[key] == tel_j[key], key
    jkv, tkv = je._kv_state, te._kv_state
    np.testing.assert_array_equal(tkv.tbl.numpy(), np.asarray(jkv.tbl))
    tp = convert.to_numpy(tkv.pool)
    for f in ("sema.ticket", "sema.grant", "sema.bucket_seq", "free_q",
              "refcnt", "gen"):
        ref = jkv.pool
        for part in f.split("."):
            ref = getattr(ref, part)
        np.testing.assert_array_equal(tp[f], np.asarray(ref), err_msg=f)
    if share:
        tc = convert.to_numpy(tkv.cache)
        for f in jkv.cache._fields:
            np.testing.assert_array_equal(tc[f],
                                          np.asarray(getattr(jkv.cache, f)),
                                          err_msg=f"cache.{f}")
    else:
        assert tkv.cache is None and jkv.cache is None
    # the whole KV state carried across by `convert` equals the port's
    carried = convert.to_numpy(convert.kv_pool_from_jax(jkv, device="cpu"))
    mine = convert.to_numpy(tkv)
    assert carried.keys() == mine.keys()
    for f in mine:
        np.testing.assert_array_equal(mine[f], carried[f], err_msg=f)
    if model:
        for k in ("kp", "vp", "emb", "wo"):
            np.testing.assert_array_equal(
                te.megastep_model[k].numpy(),
                np.asarray(je.megastep_model[k]), err_msg=k)


RUNS = {
    # name: (seed, prefix cache, paged-pool model: False, True (chunk
    # window = the engine's chunk) or "full" (window = the prompt width))
    "chunked-rid": (13, False, False),
    "chunked-pool-model": (20, False, True),
    "sharing-rid": (13, True, False),
    "sharing-pool-model-full-window": (24, True, "full"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_chunked_megastep_matches_jax_engine(name):
    seed, share, model = RUNS[name]
    je, te, jr, tr, samples = _run(seed, share=share, model=model)
    paths = _paths(samples, jr)
    need = ["park", "resume", "mid_prefill_preempt", "backlog_expiry"]
    if share:
        need += ["attach", "full_cover", "cow"]
    assert all(paths[p] > 0 for p in need), paths
    _check(je, te, jr, tr, share=share, model=model)


def test_submit_rejections_match_jax():
    """Over ``prompt_cap`` and over the pool's capacity both engines
    refuse at submit; a lifetime demand beyond the pool that a cached
    prefix covers (post-divergence demand within the pool) both accept,
    reading the cache the last launch left; an over-capacity prompt with
    no cached prefix both refuse.  A chunk window below the engine's chunk
    is refused at launch."""
    clk = [0.0]
    je, te = _engines(clk, share=True, kv_pool=(8, 4, 16),
                      chunked_prefill=(5, 9, 8), prefix_cache=64)
    for Req, eng in ((JRequest, je), (TRequest, te)):
        with pytest.raises(ValueError, match="prompt_cap"):
            eng.submit(Req(rid=0, prompt=[1] * 33, max_new_tokens=1,
                           tenant_id="gold"))
        with pytest.raises(ValueError, match="stall forever"):
            eng.submit(Req(rid=0, prompt=[3] * 20, max_new_tokens=20,
                           tenant_id="gold"))
    wp = [(3 + 7 * i) % 31 + 1 for i in range(24)]   # 6 full blocks
    warm = {"j": JRequest(rid=1, prompt=list(wp), max_new_tokens=6,
                          tenant_id="gold"),
            "t": TRequest(rid=1, prompt=list(wp), max_new_tokens=6,
                          tenant_id="gold")}
    je.submit_batch([warm["j"]])
    te.submit_batch([warm["t"]])
    for _ in range(12):   # until the warm prompt registers its blocks
        je.megastep(1, token_fn=jes.rid_token_fn)
        te.megastep(1, token_fn=tes.rid_token_fn)
        assert te.telemetry()["last_samples"] == \
            je.telemetry()["last_samples"]
        if warm["j"].prefill_pos >= len(wp):
            break
    assert warm["t"].prefill_pos == warm["j"].prefill_pos >= len(wp)
    assert not warm["j"].done_event.is_set()   # its blocks are still live
    for Req, eng in ((JRequest, je), (TRequest, te)):
        # cdiv(28 + 8, 4) = 9 > 8 blocks, but 6 are cached: 3 ≤ 8
        eng.submit(Req(rid=2, prompt=wp + [9, 8, 7, 6], max_new_tokens=8,
                       tenant_id="gold"))
        with pytest.raises(ValueError):
            eng.submit(Req(rid=3, prompt=[6] * 28, max_new_tokens=8,
                           tenant_id="gold"))
        with pytest.raises(ValueError, match="chunk window"):
            eng.megastep(1, token_fn=(
                jes if Req is JRequest else tes
            ).make_chunked_prefill_token_fn(2))
