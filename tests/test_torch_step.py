"""The port's multi-tenant host ``step()`` (`repro_torch.serving.scheduler.
ContinuousBatchingEngine.step`) in every QoS mode — no pool, the up-front
pool, chunked prefill, chunked prefill with prefix sharing — and both
admission kinds (the kernel round through `kernels.ops.qos_round`, and the
TWA queue walk with the deadline heap):

* against the JAX engine's ``step()`` on one trace and one virtual clock
  (JAX's Pallas QoS kernel in interpret mode, as its own tests run it):
  every sample with its events bit-equal round by round, then the
  streams, rounds, the QoS state, ``_qos_free``, the block-semaphore
  mirror, the sharing replica (tables, refcounts, generations, free
  queue, prefix cache), the stats and ``telemetry()``;
* against the port's own ``megastep(K)`` on the same trace
  (``megastep(K) ≡ K·step()``, with and without the 2³² wrap; the
  reference's properties of `test_megastep.py`, `test_paged_pool.py`,
  `test_chunked_prefill.py` and `test_prefix_cache.py`);
* the reference's ``step()`` scenarios: the strict-FCFS gate, mixed
  step/megastep refused, FCFS re-grant after preemption, the deadline
  heap drained by megastep, a fully covered admit, headroom and the
  watermark, no deadlock under saturation;
* the card kernel's row limit refused at submit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro.core.functional import make_block_pool as j_make_block_pool
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.core.functional import make_block_pool, pool_free_count
from repro_torch.kernels import qos_admission
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.engine_state import rid_token_fn
from repro_torch.serving.events import (
    EV_COW,
    EV_PARK,
    EV_PREFILL_CHUNK,
    EV_PREFIX_ATTACH,
    EV_RESUME,
)
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

DT = 0.25  # f32-exact virtual-time grid: host f64 and device f32 deadline
#            compares can never disagree at the boundary
WRAP = (1 << 32) - 7

# mode: (engine keyword arguments, slots, tenants)
MODES = {
    "qos": (dict(), 4, {"gold": 4.0, "silver": 2.0, "bronze": 1.0}),
    "paged": (dict(kv_pool=(16, 4)), 4, {"gold": 2.0, "bronze": 1.0}),
    "chunked": (dict(kv_pool=(16, 4), chunked_prefill=(5, 9, 16),
                     prompt_cap=32), 4, {"gold": 2.0, "bronze": 1.0}),
    "sharing": (dict(kv_pool=(16, 4, 8), chunked_prefill=(5, 9, 16),
                     prompt_cap=32, prefix_cache=8), 4,
                {"gold": 2.0, "bronze": 1.0}),
}


def _rid_step_fn(active):
    """Host counterpart of `engine_state.rid_token_fn`: the logits ARE
    the request-identity token (sampled by identity)."""
    return np.array([r.rid * 1000 + len(r.out_tokens) for r in active],
                    np.int64)


def _ident(lg):
    return lg.astype(np.int64)


def _trace(mode: str, seed: int, n_req: int, deadline_frac: float):
    """The reference tests' workloads as keyword dicts: one-token prompts
    of three tenants (qos), 1–6-token prompts against a 16×4 pool (paged),
    prompts up to 18 tokens (chunked) and a shared 8-token prefix plus a
    random tail (sharing)."""
    rng = np.random.default_rng(seed)
    names = list(MODES[mode][2])
    out = []
    for i in range(n_req):
        if mode == "qos":
            dl = (DT * int(rng.integers(0, 16))
                  if rng.random() < deadline_frac else None)
            prompt = [1 + int(rng.integers(0, 9))]
            mx = 1 + int(rng.integers(0, 3))
        elif mode == "paged":
            dl = (DT * int(rng.integers(0, 16))
                  if rng.random() < deadline_frac else None)
            prompt = [1] * int(rng.integers(1, 7))
            mx = 1 + int(rng.integers(0, 12))
        elif mode == "chunked":
            dl = (DT * int(rng.integers(0, 20))
                  if rng.random() < deadline_frac else None)
            prompt = [1 + i % 7] * int(rng.integers(1, 19))
            mx = 1 + int(rng.integers(0, 10))
        else:
            dl = (DT * int(rng.integers(0, 20))
                  if rng.random() < deadline_frac else None)
            prompt = [7] * 8 + [1 + int(x) for x in
                                rng.integers(1, 4, int(rng.integers(0, 5)))]
            mx = 1 + int(rng.integers(0, 6))
        out.append(dict(rid=i, prompt=prompt, max_new_tokens=mx,
                        tenant_id=names[int(rng.integers(0, len(names)))],
                        deadline=dl))
    return out


def _port(mode, clk, *, use_kernel=True, wrap=False, **over):
    kw, S, weights = MODES[mode]
    eng = TEngine(_rid_step_fn, lambda r: None, S, tenants=dict(weights),
                  use_kernel=use_kernel, clock=lambda: clk[0], device="cpu",
                  **{**kw, **over})
    if wrap:  # the ticket sequences (and the replica's block counters)
        #       straddle 2³² during the run
        T = len(weights)
        base = torch.full((T,), WRAP, dtype=torch.int64)
        eng.qos = eng.qos._replace(ticket=base.clone(), grant=base.clone(),
                                   consumed=base.clone())
        if eng._kv_share:
            eng._kv_hpool = make_block_pool(eng._kv_blocks, table_size=64,
                                            start=(1 << 32) - 5,
                                            device="cpu")
            eng._kv_sema = eng._kv_hpool.sema
    return eng


def _jax(mode, clk, *, use_kernel=True, wrap=False):
    kw, S, weights = MODES[mode]
    eng = JEngine(_rid_step_fn, lambda r: None, S, tenants=dict(weights),
                  use_kernel=use_kernel, clock=lambda: clk[0], **kw)
    if wrap:
        T = len(weights)
        base = jnp.uint32(WRAP)
        eng.qos = eng.qos._replace(ticket=jnp.full((T,), base),
                                   grant=jnp.full((T,), base),
                                   consumed=jnp.full((T,), base))
        if eng._kv_share:
            eng._kv_hpool = j_make_block_pool(eng._kv_blocks, table_size=64,
                                              start=(1 << 32) - 5)
            eng._kv_sema = eng._kv_hpool.sema
    return eng


def _u32(x) -> np.ndarray:
    """A JAX array or a port tensor as uint32 numpy (u32 carriers)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def _same_requests(ra, rb, tag=""):
    for a, b in zip(ra, rb):
        for f in ("out_tokens", "admit_round", "expire_round", "expired",
                  "preempted", "slot", "submit_clock", "first_tok_clock",
                  "last_tok_clock", "finish_clock"):
            assert getattr(a, f) == getattr(b, f), (tag, a.rid, f)


def _same_state(ea, eb, tag=""):
    """The QoS state, the free pool, the block-semaphore mirror and, under
    sharing, the replica of engines ``ea`` and ``eb`` (either package)."""
    for f in ea.qos._fields:
        conv = np.asarray if f in ("weight", "vpass") else _u32
        np.testing.assert_array_equal(conv(getattr(ea.qos, f)),
                                      conv(getattr(eb.qos, f)),
                                      err_msg=f"{tag} qos.{f}")
    assert ea._qos_free == eb._qos_free, tag
    if ea._kv_pool is None:
        return
    assert ea._kv_free_blocks == eb._kv_free_blocks, tag
    for f in ("ticket", "grant", "bucket_seq"):
        np.testing.assert_array_equal(_u32(getattr(ea._kv_sema, f)),
                                      _u32(getattr(eb._kv_sema, f)),
                                      err_msg=f"{tag} kv_sema.{f}")
    if not ea._kv_share:
        return
    np.testing.assert_array_equal(np.asarray(ea._kv_htbl),
                                  np.asarray(eb._kv_htbl),
                                  err_msg=f"{tag} table")
    for f in ("refcnt", "gen", "free_q"):
        np.testing.assert_array_equal(
            _u32(getattr(ea._kv_hpool, f)), _u32(getattr(eb._kv_hpool, f)),
            err_msg=f"{tag} pool.{f}")
    for f in ea._kv_cache._fields:
        np.testing.assert_array_equal(
            _u32(getattr(ea._kv_cache, f)), _u32(getattr(eb._kv_cache, f)),
            err_msg=f"{tag} cache.{f}")
    np.testing.assert_array_equal(ea._kv_refcnt_h, eb._kv_refcnt_h)


# ------------------------------------------- port K·step() ≡ JAX K·step() ---

STEP_RUNS = {
    # name: (mode, use_kernel, seed, requests, deadline fraction, wrap)
    "qos-kernel": ("qos", True, 5, 14, 0.5, True),
    "qos-walk": ("qos", False, 7, 14, 0.5, False),
    "paged-kernel": ("paged", True, 3, 12, 0.5, True),
    "paged-walk": ("paged", False, 4, 12, 0.5, False),
    "chunked-kernel": ("chunked", True, 7, 12, 0.4, True),
    "chunked-walk": ("chunked", False, 8, 12, 0.4, False),
    "sharing-kernel": ("sharing", True, 18, 12, 0.4, True),
    "sharing-walk": ("sharing", False, 25, 12, 0.4, False),
}


@pytest.mark.parametrize("name", sorted(STEP_RUNS))
def test_step_matches_jax_step(name):
    """The port's host loop against the JAX engine's on one trace: every
    round's sample (events, health, credit, kv probes) bit-equal, then
    the requests, the QoS and pool state, the stats and ``telemetry()``
    — ``trace`` (the span summary) included."""
    mode, use_kernel, seed, n_req, frac, wrap = STEP_RUNS[name]
    clk = [0.0]
    je = _jax(mode, clk, use_kernel=use_kernel, wrap=wrap)
    te = _port(mode, clk, use_kernel=use_kernel, wrap=wrap)
    te.qos = convert.qos_from_jax(je.qos, device="cpu")
    trace = _trace(mode, seed, n_req, frac)
    jr = [JRequest(**t) for t in trace]
    tr = [TRequest(**t) for t in trace]
    je.submit_batch(jr)
    te.submit_batch(tr)
    events = set()
    for k in range(60):
        clk[0] = k * DT
        je.step(_ident)
        te.step(_ident)
        js, ts = je._last_samples, te._last_samples
        assert ts == js, (name, k)
        events |= {e[0] for e in ts[0]["events"]}
        if all(r.done_event.is_set() for r in jr):
            break
    assert all(r.done_event.is_set() for r in jr + tr), name
    _same_requests(jr, tr, name)
    _same_state(je, te, name)
    assert te.stats.__dict__ == je.stats.__dict__
    tj, tt = je.telemetry(), te.telemetry()
    assert tt.keys() == tj.keys()
    for key in tt:
        assert tt[key] == tj[key], (name, key)
    # the trace reaches expiry, and each mode's own paths
    assert any(r.expired for r in jr), name
    need = {"chunked": {EV_PARK, EV_RESUME, EV_PREFILL_CHUNK},
            "sharing": {EV_PREFIX_ATTACH, EV_COW, EV_PREFILL_CHUNK}}
    assert need.get(mode, set()) <= events, (name, events)


# -------------------------------------------- megastep(K) ≡ K·step() --------


def _step_vs_megastep(mode, seed, frac, wrap, *, K, n_req):
    clk = [0.0]
    eh = _port(mode, clk, wrap=wrap)
    em = _port(mode, clk, wrap=wrap)
    trace = _trace(mode, seed, n_req, frac)
    rh = [TRequest(**t) for t in trace]
    rm = [TRequest(**t) for t in trace]
    eh.submit_batch(rh)
    em.submit_batch(rm)
    times = [k * DT for k in range(K)]
    hs = []
    for t in times:
        clk[0] = t
        eh.step(_ident)
        hs += eh._last_samples
    clk[0] = 0.0
    em.megastep(K, token_fn=rid_token_fn, nows=np.asarray(times, np.float32))
    assert em._last_samples == hs, (mode, seed)
    tag = f"{mode} seed={seed}"
    for a, b in zip(rh, rm):
        for f in ("out_tokens", "admit_round", "expire_round", "expired",
                  "preempted", "first_tok_clock", "last_tok_clock",
                  "finish_clock"):
            assert getattr(a, f) == getattr(b, f), (tag, a.rid, f)
        if a in eh.active.values():
            # the cursor encodings differ past plen (the host pins at
            # plen, the device reports plen + emitted): both re-seed alike
            pl = len(a.prompt) or 1
            assert min(a.prefill_pos, pl) == min(b.prefill_pos, pl), tag
            assert (a.parked, a.kv_blocks) == (b.parked, b.kv_blocks), tag
    for f in ("admitted", "finished", "expired", "preempted",
              "kv_block_stalls", "prefill_chunks", "prefix_hits",
              "cow_copies"):
        assert getattr(eh.stats, f) == getattr(em.stats, f), (tag, f)
    assert eh.stats.host_syncs == K and em.stats.host_syncs == 1
    _same_state(eh, em, tag)
    if mode in ("chunked", "sharing"):
        # the mirror equals the device pool's semaphore; under sharing the
        # megastep wrote its pool back to the replica, which equals the
        # host's replica (compared above)
        dev = em._kv_state.pool.sema
        for f in ("ticket", "grant", "bucket_seq"):
            np.testing.assert_array_equal(_u32(getattr(eh._kv_sema, f)),
                                          _u32(getattr(dev, f)))


@pytest.mark.parametrize("mode", sorted(MODES))
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([0.0, 0.4]),
       st.booleans())
def test_megastep_equals_host_loop_property(mode, seed, frac, wrap):
    """megastep(K) ≡ K step() calls inside the port, kernel admission:
    streams, rounds, expiry and preemption, every sample with its events,
    the QoS state, the free pool, the block-semaphore mirror against the
    device pool and the sharing replica — with and without the 2³² wrap
    of the tickets (and, under sharing, of the block counters)."""
    K = {"qos": 12, "paged": 14, "chunked": 18, "sharing": 20}[mode]
    _step_vs_megastep(mode, seed, frac, wrap, K=K, n_req=12)


def test_first_sharing_launch_adopts_the_replica():
    """A sharing engine's first megastep starts from the host replica (a
    block pool whose counters start 5 below 2³² here), not a fresh pool,
    and writes the scanned pool back to it: replica and device pool are
    one state after the launch."""
    pools = []
    for wrap in (False, True):
        eng = _port("sharing", [0.0])
        if wrap:
            eng._kv_hpool = make_block_pool(eng._kv_blocks, table_size=64,
                                            start=(1 << 32) - 5,
                                            device="cpu")
            eng._kv_sema = eng._kv_hpool.sema
        eng.submit_batch([TRequest(**t)
                          for t in _trace("sharing", 2, 8, 0.0)])
        eng.megastep(6, token_fn=rid_token_fn)
        kv = eng._kv_state
        assert eng._kv_hpool is kv.pool and eng._kv_cache is kv.cache
        assert eng._kv_htbl is kv.tbl
        np.testing.assert_array_equal(eng._kv_refcnt_h,
                                      kv.pool.refcnt.numpy())
        assert eng._kv_free_blocks == int(pool_free_count(kv.pool))
        pools.append(kv.pool.sema)
    for f in ("ticket", "grant"):  # the same moves from the offset start
        d = (int(getattr(pools[1], f)) - int(getattr(pools[0], f))) \
            & 0xFFFFFFFF
        assert d == (1 << 32) - 5, f


# ------------------------------------------------ the reference scenarios ---


@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_gate_strict_fcfs_no_bypass(use_kernel):
    """An oversized head-of-line request stalls at the block gate and a
    later small one stalls behind it (no bypass); both admit in ticket
    order once running sequences post their blocks back."""
    clk = [0.0]
    eng = TEngine(_rid_step_fn, lambda r: None, 4, tenants={"a": 1.0},
                  use_kernel=use_kernel, clock=lambda: clk[0],
                  kv_pool=(8, 4), device="cpu")
    eng.submit_batch([TRequest(rid=i, prompt=[1], max_new_tokens=5,
                               tenant_id="a") for i in range(2)])
    eng.step(_ident)
    assert eng.telemetry()["kv_blocks_live"] == 4
    big = TRequest(rid=10, prompt=[1], max_new_tokens=18, tenant_id="a")
    small = TRequest(rid=11, prompt=[1], max_new_tokens=2, tenant_id="a")
    eng.submit_batch([big, small])
    eng.step(_ident)
    assert eng.telemetry()["kv_blocks_free"] >= 1
    assert big.slot is None and small.slot is None  # both block-stalled
    for _ in range(10):
        eng.step(_ident)
    assert 0 <= big.admit_round <= small.admit_round
    while eng.stats.finished < 4:
        eng.step(_ident)
    assert eng.telemetry()["kv_blocks_free"] == 8


def test_paged_engine_rejects_mixed_step_and_megastep():
    """A paged engine serves through ONE path: a megastep after host
    admissions, and a step() after a megastep, both raise."""
    def mk():
        eng = TEngine(_rid_step_fn, lambda r: None, 2, tenants={"a": 1.0},
                      use_kernel=True, clock=lambda: 0.0, kv_pool=(8, 4),
                      device="cpu")
        eng.submit_batch([TRequest(rid=0, prompt=[1], max_new_tokens=6,
                                   tenant_id="a")])
        return eng

    eng = mk()
    eng.step(_ident)
    with pytest.raises(RuntimeError, match="host-admitted"):
        eng.megastep(2, token_fn=rid_token_fn)
    eng2 = mk()
    eng2.megastep(2, token_fn=rid_token_fn)
    with pytest.raises(RuntimeError, match="megastep"):
        eng2.step(_ident)


@pytest.mark.parametrize("path", ["walk", "kernel", "megastep"])
def test_preempted_slot_regranted_fcfs(path):
    """A running request whose deadline passes mid-decode is tombstoned;
    its slot goes to the earliest live ticket, on each serving path."""
    clk = [0.0]
    eng = TEngine(_rid_step_fn, lambda r: None, 1, tenants={"a": 1.0},
                  use_kernel=path == "kernel", clock=lambda: clk[0],
                  device="cpu")
    hog = TRequest(rid=0, prompt=[1], max_new_tokens=100, tenant_id="a",
                   deadline=2.0)
    nxt = TRequest(rid=1, prompt=[1], max_new_tokens=2, tenant_id="a")
    later = TRequest(rid=2, prompt=[1], max_new_tokens=2, tenant_id="a")
    eng.submit_batch([hog, nxt, later])

    def drive():
        if path == "megastep":
            eng.megastep(1, token_fn=rid_token_fn, nows=[clk[0]])
        else:
            eng.step(_ident)

    for _ in range(3):
        drive()
        clk[0] += DT
    assert hog.slot == 0 and len(hog.out_tokens) == 3 and not hog.expired
    clk[0] = 2.5
    for _ in range(4):
        drive()
        clk[0] += DT
    assert hog.preempted and hog.expired and hog.done_event.is_set()
    assert len(hog.out_tokens) == 3
    assert eng.stats.preempted == 1 and eng.stats.expired == 1
    assert nxt.out_tokens == [1000, 1001]
    assert nxt.admit_round < later.admit_round or later.admit_round == -1
    assert eng.tenant_expired["a"] == 1


def test_megastep_drains_deadline_heap():
    """A queue-walk engine served only by megastep keeps no resolved
    request in the host expiry heap (only step() pops it)."""
    eng = TEngine(_rid_step_fn, lambda r: None, 4, tenants={"a": 1.0},
                  use_kernel=False, clock=lambda: 0.0, device="cpu")
    eng.submit_batch([TRequest(rid=i, prompt=[1], max_new_tokens=2,
                               tenant_id="a", deadline=100.0)
                      for i in range(20)])
    assert len(eng._deadline_heap) == 20
    while eng.stats.finished < 20:
        eng.megastep(4, token_fn=rid_token_fn)
    assert len(eng._deadline_heap) == 0


def test_fully_covered_admit_skips_prefill():
    """A request whose whole prompt is cache-resident admits by incref
    only: its KV cursor starts at plen, no chunk is ever scheduled for it
    (zero prefill tokens), ``prefix_hits`` counts it and its first decode
    write copies the shared tail block."""
    clk = [0.0]
    eng = TEngine(_rid_step_fn, lambda r: None, 2,
                  tenants={"gold": 2.0, "bronze": 1.0}, use_kernel=True,
                  clock=lambda: clk[0], device="cpu", **MODES["sharing"][0])
    # a long-decoding holder keeps its registered blocks live
    first = TRequest(rid=0, prompt=[5] * 10, max_new_tokens=12,
                     tenant_id="gold")
    eng.submit_batch([first])
    k = 0
    while first.prefill_pos < 10:
        clk[0] = k * DT
        eng.step(_ident)
        k += 1
    assert eng.stats.prefix_hits == 0
    chunks = eng.stats.prefill_chunks
    twin = TRequest(rid=1, prompt=[5] * 10, max_new_tokens=2,
                    tenant_id="gold")
    eng.submit_batch([twin])
    tokens, events = [], []
    for k in range(k, k + 12):
        clk[0] = k * DT
        eng.step(_ident)
        tokens.append(eng._last_samples[0]["prefill_tokens"])
        events += eng._last_samples[0]["events"]
        if twin.finish_t:
            break
    assert twin.out_tokens == [1000, 1001] and twin.prefill_pos >= 10
    assert [EV_PREFIX_ATTACH, 1, twin.slot, 10] in events
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefill_chunks == chunks and sum(tokens) == 0
    assert eng.stats.cow_copies >= 1


def test_headroom_and_watermark_pipeline_admission():
    """A newcomer is held out of a long runner's reserve until the
    runner's remaining demand drains below the watermark, then pipelines
    in mid-flight; both finish."""
    eng = TEngine(_rid_step_fn, lambda r: None, 2, tenants={"a": 1.0},
                  use_kernel=True, clock=lambda: 0.0, kv_pool=(8, 4),
                  chunked_prefill=(4, 4), prompt_cap=32, device="cpu")
    big = TRequest(rid=0, prompt=[1] * 8, max_new_tokens=20, tenant_id="a")
    eng.submit_batch([big])
    eng.step(_ident)
    assert big.slot is not None  # over the watermark, admitted alone
    late = TRequest(rid=1, prompt=[1] * 4, max_new_tokens=4, tenant_id="a")
    eng.submit_batch([late])
    eng.step(_ident)
    assert late.slot is None
    mid_flight = False
    for _ in range(200):
        eng.step(_ident)
        if late.slot is not None and big.finish_t == 0.0:
            mid_flight = True
        if eng.stats.finished == 2:
            break
    assert eng.stats.finished == 2 and mid_flight
    assert big.admit_round < late.admit_round
    assert all(len(r.out_tokens) == r.max_new_tokens for r in (big, late))
    assert eng.telemetry()["kv_blocks_free"] == 8


@pytest.mark.parametrize("use_kernel", [True, False])
def test_no_deadlock_under_saturation(use_kernel):
    """Six requests of 6 blocks each against an 8-block pool: every one
    finishes, parks occur, and completion follows ticket order."""
    eng = TEngine(_rid_step_fn, lambda r: None, 4, tenants={"a": 1.0},
                  use_kernel=use_kernel, clock=lambda: 0.0, kv_pool=(8, 4),
                  chunked_prefill=(4, 8, 8), prompt_cap=32, device="cpu")
    reqs = [TRequest(rid=i, prompt=[1] * 14, max_new_tokens=10,
                     tenant_id="a") for i in range(6)]
    eng.submit_batch(reqs)
    for _ in range(400):
        eng.step(_ident)
        if eng.stats.finished == len(reqs):
            break
    assert eng.stats.finished == len(reqs)
    assert eng.stats.kv_block_stalls > 0
    assert eng.telemetry()["kv_blocks_free"] == 8
    assert all(len(r.out_tokens) == 10 for r in reqs)
    assert [r.rid for r in sorted(reqs, key=lambda r: r.finish_t)] == \
        sorted(r.rid for r in reqs)


def test_walk_and_kernel_drive_the_same_streams():
    """The queue walk co-schedules the same chunk phase as the kernel
    round: identical streams and a drained pool (admission rounds may
    differ: the walk re-examines only poked queues)."""
    out = []
    for use_kernel in (False, True):
        clk = [0.0]
        eng = _port("chunked", clk, use_kernel=use_kernel)
        reqs = [TRequest(**t) for t in _trace("chunked", 11, 12, 0.0)]
        eng.submit_batch(reqs)
        for k in range(80):
            clk[0] = k * DT
            eng.step(_ident)
        assert eng.stats.finished == len(reqs)
        assert eng._kv_free_blocks == 16 and eng.stats.kv_block_stalls > 0
        out.append([r.out_tokens for r in reqs])
    assert out[0] == out[1]


# ------------------------------------------------ the card's row limit ------


def test_card_kernel_row_limit_refused_at_submit(monkeypatch):
    """The host step()'s kernel round passes every live row, which
    ``backlog_cap`` does not bound: on a CUDA engine with ``use_kernel``,
    arrivals that would take the live backlog past `MAX_ROWS` are
    refused at submit, naming the limit, before any ticket is taken; the
    CPU path and the card without the kernel take any size."""
    check = qos_admission.check_backlog_rows
    cuda = torch.device("cuda")
    M = qos_admission.MAX_ROWS
    check(cuda, True, M)
    with pytest.raises(ValueError, match="MAX_ROWS"):
        check(cuda, True, M + 1)
    check(cuda, False, M + 1)
    check(torch.device("cpu"), True, M + 1)

    seen = []

    def fake(device, use_kernel, rows):
        seen.append((device.type, use_kernel, rows))
        return check(cuda, use_kernel, rows)  # as if on the card

    monkeypatch.setattr(tsched, "check_backlog_rows", fake)
    eng = TEngine(None, None, 2, tenants={"a": 1.0}, use_kernel=True,
                  clock=lambda: 0.0, device="cpu")
    eng.submit_batch([TRequest(rid=i, prompt=[1], max_new_tokens=1,
                               tenant_id="a") for i in range(3)])
    ticket = eng.qos.ticket.clone()
    big = [TRequest(rid=10 + i, prompt=[1], max_new_tokens=1,
                    tenant_id="a") for i in range(M - 2)]
    with pytest.raises(ValueError, match="MAX_ROWS"):
        eng.submit_batch(big)
    assert torch.equal(eng.qos.ticket, ticket)  # nothing was taken
    assert seen == [("cpu", True, 3), ("cpu", True, M + 1)]
    eng.submit_batch(big[:-1])   # exactly at the limit
    assert int(eng._tenant_live.sum()) == M


@pytest.mark.parametrize("mode", ["paged", "chunked"])
def test_phase_release_beyond_the_waiting_array(mode):
    """A phase that frees more blocks than the block semaphore's waiting
    array has entries (64): the port's host step posts them in ONE batched
    release, as the device round does, so its block-semaphore mirror and
    every sample (``kv_pokes``, and parks in chunked mode) stay equal to
    the megastep's.  The reference's host step posts slot by slot and
    pokes other buckets there (ROADMAP queue 3); its own megastep is the
    port's."""
    kw = dict(kv_pool=(256, 1, 64), prompt_cap=32)
    if mode == "chunked":
        kw["chunked_prefill"] = (4, 64, 256)
    trace = [dict(rid=i, prompt=[1 + i] * 2, max_new_tokens=30,
                  tenant_id="a") for i in range(4)]
    K = 40
    times = [k * DT for k in range(K)]
    clk = [0.0]
    out = {}
    for pkg, Eng, Req, fn in (("port", TEngine, TRequest, rid_token_fn),
                              ("jax", JEngine, JRequest, None)):
        extra = {"device": "cpu"} if pkg == "port" else {}
        eh = Eng(_rid_step_fn, lambda r: None, 4, tenants={"a": 1.0},
                 use_kernel=True, clock=lambda: clk[0], **kw, **extra)
        em = Eng(_rid_step_fn, lambda r: None, 4, tenants={"a": 1.0},
                 use_kernel=True, clock=lambda: clk[0], **kw, **extra)
        eh.submit_batch([Req(**t) for t in trace])
        em.submit_batch([Req(**t) for t in trace])
        hs = []
        for t in times:
            clk[0] = t
            eh.step(_ident)
            hs += eh._last_samples
        clk[0] = 0.0
        if fn is None:
            from repro.serving.engine_state import rid_token_fn as fn
        em.megastep(K, token_fn=fn, nows=np.asarray(times, np.float32))
        out[pkg] = (hs, em._last_samples, _u32(eh._kv_sema.bucket_seq),
                    _u32(em._kv_sema.bucket_seq))
    hs, ms, hseq, mseq = out["port"]
    assert hs == ms and (hseq == mseq).all()
    assert max(s["kv_free"] - p["kv_free"] for p, s in zip(hs, hs[1:])) > 64
    jhs, jms, jhseq, jmseq = out["jax"]
    assert ms == jms and (mseq == jmseq).all()  # the device rounds agree
    assert not (jhseq == jmseq).all()  # the reference's host mirror not
