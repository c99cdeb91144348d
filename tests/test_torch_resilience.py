"""The port's resilience layer (`repro_torch.resilience`, the engine's
``quarantine`` / ``audit_kv`` rungs, the sticky NaN input) against the JAX
package's, at `tests/test_resilience.py`'s sizes: the chunked block-paged
engine with 4 slots, ``kv_pool=(16, 4)``, ``chunked_prefill=(5, 9, 16)``
and 2 tenants (plus the up-front and prefix-sharing modes of
`tests/test_torch_step.py`).  The port runs on the CPU, where its kernels
take their plain versions; the JAX side runs as its own tests run it.
Integer and control-plane state is held bit-equal.

* fault plans: the same seed draws the same events in both packages;
* each fault: every `apply_fault` kind, on the same engine state (host
  loop and megastep-persistent pool), leaves the same host mirrors,
  device pool, tables and model — and the rounds after it the same
  samples (health bits included);
* rungs 1 and 2: ``audit_kv`` (its report) and ``quarantine`` in each
  pool case — host up-front, host chunked, host sharing replica, device
  pool, device pool with sharing — after the same corruption;
* ``exit_audit`` on clean and corrupted engines;
* the equivalence property: a host-loop ``ResilientEngine`` equals a
  megastep one, and each equals its JAX counterpart, under one seeded
  plan (2³² wrap included); with prefix sharing at a small size; the
  reference's pinned red seed, and a reference fault under sharing;
* rung 4: crash replay, crash on the host loop, NaN → restore, bit flip
  → audit, torn shard → older snapshot, each with the ladder's events
  equal to JAX's;
* snapshot aliasing: a restore brings back the state at snapshot time,
  in fresh storage, though the rounds after the snapshot wrote the live
  model's pools in place.
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

import test_torch_step as tts

from repro import resilience as jres
from repro.checkpoint.manager import CheckpointManager as JCheckpoint
from repro.serving.engine_state import rid_token_fn as j_rid
from repro_torch import resilience as tres
from repro_torch.checkpoint.manager import CheckpointManager as TCheckpoint
from repro_torch.serving import engine_state as es
from repro_torch.serving import sentinels as sn
from repro_torch.serving.engine_state import rid_token_fn as t_rid

DT = tts.DT
# package: (engine class, request class, resilience module, megastep
# token function, checkpoint manager)
PKG = {
    "jax": (tts.JEngine, tts.JRequest, jres, j_rid, JCheckpoint),
    "port": (tts.TEngine, tts.TRequest, tres, t_rid, TCheckpoint),
}
_STATS = ("finished", "expired", "preempted", "admitted", "quarantined",
          "requeued", "kv_audits", "kernel_fallbacks", "snapshots",
          "restores")
_REQ = ("out_tokens", "admit_round", "expire_round", "expired",
        "preempted", "retries")
# requests of a trace per mode: 8 sharing requests keep every megastep
# of that mode at one backlog and prompt width (fewer JAX compilations)
N_REQ = {"paged": 12, "chunked": 12, "sharing": 8}


def _engine(pkg, mode, clk, *, watchdog=0, wrap=False):
    """The mode's engine of `tests/test_torch_step.py` (``chunked`` is
    `tests/test_resilience.py`'s ``_mk_eng``) with a watchdog."""
    kw, S, weights = tts.MODES[mode]
    Eng = PKG[pkg][0]
    extra = {"device": "cpu"} if pkg == "port" else {}
    eng = Eng(tts._rid_step_fn, lambda r: None, S, tenants=dict(weights),
              use_kernel=True, clock=lambda: clk[0], watchdog=watchdog,
              **kw, **extra)
    if wrap:
        T = len(weights)
        if pkg == "jax":
            base = jnp.full((T,), jnp.uint32(tts.WRAP))
        else:
            base = torch.full((T,), tts.WRAP, dtype=torch.int64)
        eng.qos = eng.qos._replace(ticket=base, grant=base, consumed=base)
    return eng


def _requests(pkg, mode, seed, n_req, frac):
    Req = PKG[pkg][1]
    return [Req(**t) for t in tts._trace(mode, seed, n_req, frac)]


def _drive(pkg, eng, rounds, *, mega, start=0):
    """``rounds`` bare engine rounds from round ``start`` on the virtual
    clock (round k at k·DT); a megastep engine in launches of 4 rounds
    (one shape for JAX to compile)."""
    if mega:
        out = []
        for b in range(start, start + rounds, 4):
            eng.megastep(4, token_fn=PKG[pkg][3], nows=np.asarray(
                [(b + k) * DT for k in range(4)], np.float32))
            out += eng._last_samples
        return out
    out = []
    for k in range(start, start + rounds):
        eng._clock_box[0] = k * DT
        eng.step(tts._ident)
        out += eng._last_samples
    return out


def _n(x) -> np.ndarray:
    """A JAX array or a port tensor as numpy, u32 carriers as uint32."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a
    return np.asarray(x)


def _same_tree(a, b, tag):
    """Two NamedTuple states (either package) leaf for leaf."""
    if a is None or b is None:
        assert a is None and b is None, tag
        return
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple) or x is None:
            _same_tree(x, y, f"{tag}.{f}")
        else:
            np.testing.assert_array_equal(_n(x), _n(y), err_msg=f"{tag}.{f}")


def _same_engine(je, te, tag):
    """QoS state, free pool, block-semaphore mirror, sharing replica
    (`test_torch_step._same_state`), plus the device pool and tables, the
    sticky flag, the slots and each active request's park state."""
    tts._same_state(je, te, tag)
    assert sorted(je.active) == sorted(te.active), tag
    assert sorted(je.free_slots) == sorted(te.free_slots), tag
    for s in je.active:
        a, b = je.active[s], te.active[s]
        for f in ("rid", "parked", "park_bucket", "park_seq", "kv_blocks",
                  "prefill_pos", "out_tokens", "retries"):
            assert getattr(a, f) == getattr(b, f), (tag, s, f)
    assert je._nonfinite_sticky == te._nonfinite_sticky, tag
    if je._kv_pool is not None:
        _same_tree(getattr(je, "_kv_state", None), te._kv_state, f"{tag} kv")
    if je.megastep_model is not None:
        for k in je.megastep_model:
            np.testing.assert_array_equal(
                np.asarray(je.megastep_model[k]),
                te.megastep_model[k].numpy(), err_msg=f"{tag} model.{k}")


def _events(rz):
    """The ladder's log, the exception's class name dropped (a torn npz
    and a torn ``.pt`` raise different ones)."""
    return [{k: v for k, v in e.items() if k != "error"} for e in rz.events]


def _diff(a, b, *, paths_differ):
    """The observables in which two resilient runs ``(rz, eng, reqs)``
    differ: streams, rounds and retries; every sample (health under
    ``HEALTH_MIRRORED_MASK`` between the two serving paths); the stats; the
    QoS state, ``_qos_free`` and ``_kv_free_blocks``; the ladder's
    ``(round, action)`` list between paths, its whole log within one."""
    (ra, ea, qa), (rb, eb, qb) = a, b
    out = []
    for x, y in zip(qa, qb):
        out += [f"req{x.rid}.{f}" for f in _REQ
                if getattr(x, f) != getattr(y, f)]
    mask = sn.HEALTH_MIRRORED_MASK if paths_differ else -1
    sa = [dict(s, health=s["health"] & mask) for s in ra.samples]
    sb = [dict(s, health=s["health"] & mask) for s in rb.samples]
    if sa != sb:
        out.append("samples")
    out += [f"stats.{f}" for f in _STATS
            if getattr(ea.stats, f) != getattr(eb.stats, f)]
    out += [f"qos.{f}" for f in ea.qos._fields
            if not (_n(getattr(ea.qos, f)) == _n(getattr(eb.qos, f))).all()]
    if ea._qos_free != eb._qos_free:
        out.append("qos_free")
    if ea._kv_free_blocks != eb._kv_free_blocks:
        out.append("kv_free")
    if paths_differ:
        if [(e["round"], e["action"]) for e in ra.events] != \
                [(e["round"], e["action"]) for e in rb.events]:
            out.append("ladder")
    elif _events(ra) != _events(rb):
        out.append("ladder")
    return out


# ---------------------------------------------------------- fault plans ---


@pytest.mark.parametrize("seed", [0, 7, 123, 2**31 - 1])
def test_fault_plans_match_jax(seed):
    """`FaultPlan.random` (every kind set), `.cluster` and `.with_crash`
    draw the same events from the same seed in both packages."""
    for kinds in ("CAPACITY_KINDS", "CORRUPTION_KINDS", "ALL_KINDS"):
        for kw in (dict(rounds=24, n_faults=4), dict(rounds=1, n_faults=2),
                   dict(rounds=40, n_faults=6, max_delta=9,
                        first_round=5)):
            a = jres.faults.FaultPlan.random(
                seed, kinds=getattr(jres.faults, kinds), **kw)
            b = tres.faults.FaultPlan.random(
                seed, kinds=getattr(tres.faults, kinds), **kw)
            assert [e.__dict__ for e in a.events] == \
                [e.__dict__ for e in b.events], (seed, kinds, kw)
            assert a.with_crash(3).rounds() == b.with_crash(3).rounds()
    for n in (3, 5, 8):
        a = jres.FaultPlan.cluster(seed, rounds=30, n_replicas=n, n_leaks=2)
        b = tres.FaultPlan.cluster(seed, rounds=30, n_replicas=n, n_leaks=2)
        assert [e.__dict__ for e in a.events] == \
            [e.__dict__ for e in b.events]
    with pytest.raises(ValueError, match="3 replicas"):
        tres.FaultPlan.cluster(seed, rounds=30, n_replicas=2)


# ---------------------------------------------------------- each fault ---

# name: (kind, delta, arg, mode, megastep, seed, rounds before the fault)
FAULTS = {
    "drop_poke-host": ("drop_poke", 0, 0, "chunked", False, 1, 8),
    "drop_poke-mega": ("drop_poke", 0, 0, "chunked", True, 1, 8),
    "leak-host": ("kv_counter", -2, 0, "chunked", False, 2, 4),
    "leak-mega": ("kv_counter", -2, 0, "chunked", True, 2, 4),
    "leak-paged-host": ("kv_counter", -3, 0, "paged", False, 3, 4),
    "phantom-mega": ("kv_counter", 2, 0, "chunked", True, 2, 4),
    "double_release-host": ("double_release", 0, 0, "paged", False, 3, 4),
    "double_release-mega": ("double_release", 0, 0, "chunked", True, 2, 4),
    "nan-host": ("nan_logit", 0, 0, "chunked", False, 2, 4),
    "nan-mega": ("nan_logit", 0, 0, "chunked", True, 2, 4),
    "stuck-host": ("stuck_slot", 0, 37, "chunked", False, 2, 4),
    "stuck-mega": ("stuck_slot", 0, 37, "chunked", True, 2, 4),
    "bit_flip-host": ("bit_flip", 1, 2, "chunked", False, 2, 4),
    "bit_flip-mega": ("bit_flip", 1, 2, "chunked", True, 2, 4),
    "bit_flip-sharing-mega": ("bit_flip", 3, 1, "sharing", True, 4, 4),
}
# faults that must find a target in these states
_APPLIED = {"drop_poke-host", "drop_poke-mega", "leak-host", "leak-mega",
            "leak-paged-host", "phantom-mega", "double_release-host",
            "double_release-mega", "nan-host", "nan-mega", "stuck-host",
            "stuck-mega", "bit_flip-mega", "bit_flip-sharing-mega"}


def _model(pkg):
    """A model dict whose first float leaf in JAX's flatten order
    (sorted keys) is ``emb`` — an int leaf sorts before it."""
    rng = np.random.default_rng(0)
    leaves = {"a_ids": np.arange(6, dtype=np.int32),
              "wo": rng.standard_normal((3, 3)).astype(np.float32),
              "emb": rng.standard_normal((5, 3)).astype(np.float32)}
    if pkg == "jax":
        return {k: jnp.asarray(v) for k, v in leaves.items()}
    return {k: torch.as_tensor(v) for k, v in leaves.items()}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_each_fault_matches_jax(name):
    """One `apply_fault` on the same engine state in both packages: the
    same target, host mirrors, device pool, tables, park state and model;
    then the same samples (every health bit) and `exit_audit` for the
    rounds after it."""
    kind, delta, arg, mode, mega, seed, R = FAULTS[name]
    ev = dict(round=R, kind=kind, delta=delta, arg=arg)
    out = {}
    for pkg in ("jax", "port"):
        clk = [0.0]
        eng = _engine(pkg, mode, clk, watchdog=3)
        eng._clock_box = clk
        eng.submit_batch(_requests(pkg, mode, seed, N_REQ[mode], 0.0))
        _drive(pkg, eng, R, mega=mega)
        eng.megastep_model = _model(pkg) if mega else None
        res = PKG[pkg][2]
        applied = res.apply_fault(eng, res.FaultEvent(**ev))
        out[pkg] = (eng, applied)
    (je, ja), (te, ta) = out["jax"], out["port"]
    assert ja == ta and ja == (name in _APPLIED), name
    _same_engine(je, te, name)
    assert tres.exit_audit(te) == jres.exit_audit(je), name
    if mega:
        # the poison reached the model's first float leaf only
        nan = {k: bool(torch.isnan(v).any()) for k, v in
               te.megastep_model.items() if v.is_floating_point()}
        assert nan == {"emb": kind == "nan_logit", "wo": False}, nan
    samples = [_drive(p, e, 4, mega=mega, start=R)
               for p, e in (("jax", je), ("port", te))]
    assert samples[0] == samples[1], name
    _same_engine(je, te, name)
    assert tres.exit_audit(te) == jres.exit_audit(je), name
    if kind in ("kv_counter", "double_release", "bit_flip") and ta:
        assert any(s["health"] for s in samples[1]), name  # detected


def test_bit_flip_and_drop_poke_need_a_target():
    """Without a persistent device pool BIT_FLIP finds no cell, and
    DROP_POKE with nothing parked finds no park; the kinds the ladder or a
    router applies are refused, CRASH raises."""
    eng = _engine("port", "chunked", [0.0])
    for kind in ("bit_flip", "drop_poke"):
        assert not tres.apply_fault(eng, tres.FaultEvent(round=0,
                                                          kind=kind))
    for kind in ("torn_shard", "replica_kill"):
        with pytest.raises(ValueError, match="not an engine-state mutation"):
            tres.apply_fault(eng, tres.FaultEvent(round=0, kind=kind))
    with pytest.raises(tres.InjectedCrash):
        tres.apply_fault(eng, tres.FaultEvent(round=0, kind="crash"))


# --------------------------------------------------- rungs 1 and 2 -------

# name: (mode, megastep, seed, corruption events (kind, delta, arg))
RUNGS = {
    "host-upfront": ("paged", False, 3, [("kv_counter", -2, 0),
                                         ("double_release", 0, 0)]),
    "host-chunked": ("chunked", False, 2, [("kv_counter", -2, 0)]),
    "host-sharing": ("sharing", False, 4, [("kv_counter", -1, 0)]),
    "device": ("chunked", True, 2, [("double_release", 0, 0),
                                    ("kv_counter", -2, 0)]),
    "device-sharing": ("sharing", True, 4, [("bit_flip", 3, 1),
                                            ("kv_counter", 2, 0)]),
}


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_rungs_match_jax(name):
    """After the same corruption, ``audit_kv`` returns the same report
    and leaves the same pool (ticket, grant, free queue, refcounts), table
    and mirrors as JAX's; ``quarantine`` of each aliasing victim (or of
    the first active slot) the same; `exit_audit` agrees before and
    after, and the rounds after the repair give the same samples."""
    mode, mega, seed, corrupt = RUNGS[name]
    R = 4
    out = {}
    for pkg in ("jax", "port"):
        clk = [0.0]
        eng = _engine(pkg, mode, clk, watchdog=3)
        eng._clock_box = clk
        reqs = _requests(pkg, mode, seed, N_REQ[mode], 0.0)
        eng.submit_batch(reqs)
        _drive(pkg, eng, R, mega=mega)
        res = PKG[pkg][2]
        for kind, delta, arg in corrupt:
            res.apply_fault(eng, res.FaultEvent(round=R, kind=kind,
                                                delta=delta, arg=arg))
        audit0 = res.exit_audit(eng)
        rep = eng.audit_kv()
        audit1 = res.exit_audit(eng)
        victims = [s for s in rep["victims"] if s in eng.active] or \
            sorted(eng.active)[:1]
        quarantined = [eng.quarantine(s) for s in victims]
        audit2 = res.exit_audit(eng)
        out[pkg] = (eng, reqs, audit0, rep, audit1, audit2,
                    [q.rid for q in quarantined])
    je, jr, ja0, jrep, ja1, ja2, jq = out["jax"]
    te, tr, ta0, trep, ta1, ta2, tq = out["port"]
    assert trep == jrep, (name, trep, jrep)
    assert (ta0, ta1, ta2) == (ja0, ja1, ja2), name
    assert not ta0["ok"] and ta2["ok"], (name, ta0, ta2)  # broken, healed
    assert tq == jq and tq, name
    for a, b in zip(jr, tr):
        for f in ("slot", "out_tokens", "prefill_pos", "kv_blocks",
                  "admit_round", "last_adv_round", "first_tok_clock",
                  "fast", "done_event"):
            va, vb = getattr(a, f), getattr(b, f)
            if f == "done_event":
                va, vb = va.is_set(), vb.is_set()
            assert va == vb, (name, a.rid, f)
    _same_engine(je, te, name)
    assert te.stats.__dict__ == je.stats.__dict__, name
    assert te._trace.summary() == je._trace.summary(), name
    samples = [_drive(p, e, 4, mega=mega, start=R)
               for p, e in (("jax", je), ("port", te))]
    assert samples[0] == samples[1], name
    assert all(s["health"] & sn.HEALTH_MIRRORED_MASK == 0
               for s in samples[1]), name
    _same_engine(je, te, name)


def test_audit_rebuilds_refcounts_beyond_the_reference():
    """A repair beyond the reference (ROADMAP queue 3).  A bit flip and a
    double release on the device pool without sharing, then rounds in
    which the aliased blocks are handed out again: both packages' audits
    report the same, clear the same cells and rebuild the same free queue
    and ticket, but JAX's keeps the refcounts, so the block still counted
    twice keeps the partition sentinel set, and it leaks when its owner
    retires (the exit audit fails).  The port rebuilds the refcounts from
    the table: its health is 0 after the repair and it exits clean."""
    out = {}
    for pkg in ("jax", "port"):
        clk = [0.0]
        eng = _engine(pkg, "chunked", clk, watchdog=3)
        eng.submit_batch(_requests(pkg, "chunked", 2, 12, 0.0))
        _drive(pkg, eng, 4, mega=True)
        res = PKG[pkg][2]
        for kind, delta, arg in (("bit_flip", 1, 2), ("double_release", 0,
                                                      0)):
            res.apply_fault(eng, res.FaultEvent(round=4, kind=kind,
                                                delta=delta, arg=arg))
        before = _drive(pkg, eng, 4, mega=True, start=4)
        rep = eng.audit_kv()
        kv = eng._kv_state
        tbl = _n(kv.tbl).astype(np.int64)
        refs = np.bincount(tbl[tbl >= 0], minlength=16)
        pool = (_n(kv.pool.sema.ticket), _n(kv.pool.sema.grant),
                _n(kv.pool.free_q), tbl)
        counted = (_n(kv.pool.refcnt) == refs).all()
        for s in rep["victims"]:
            eng.quarantine(s)
        after = _drive(pkg, eng, 12, mega=True, start=8)
        out[pkg] = (before, rep, pool, counted, after, res.exit_audit(eng))
    (jb, jrep, jpool, jcount, ja, jexit) = out["jax"]
    (tb, trep, tpool, tcount, ta, texit) = out["port"]
    assert tb == jb and any(s["health"] & sn.H_KV_PARTITION for s in tb)
    assert trep == jrep and trep["aliased"] >= 1
    for a, b in zip(tpool, jpool):
        np.testing.assert_array_equal(a, b)
    assert tcount and not jcount
    assert all(s["health"] == 0 for s in ta) and texit["ok"]
    assert all(s["health"] & sn.H_KV_PARTITION for s in ja)
    assert not jexit["ok"]


def test_audit_kv_needs_a_pool():
    eng = _engine("port", "qos", [0.0])
    with pytest.raises(RuntimeError, match="block-paged pool"):
        eng.audit_kv()


def test_audit_table_later_owner_loses():
    """The vectorised table audit clears cells exactly as the reference's
    row-major loop does: out-of-range ids always, a repeated id in every
    cell after its first (without sharing)."""
    from repro_torch.serving.scheduler import _audit_table

    rng = np.random.default_rng(3)
    for sharing in (False, True):
        for _ in range(20):
            NB = 16
            tbl = rng.integers(-1, NB + 3, (5, 6)).astype(np.int32)
            want, refs, victims, lost = tbl.copy(), np.zeros(NB, int), [], 0
            owner = np.full(NB, -1)
            for s in range(5):
                for j in range(6):
                    b = want[s, j]
                    if b < 0:
                        continue
                    if b >= NB or (not sharing and owner[b] >= 0):
                        want[s, j] = -1
                        lost += 1
                        if s not in victims:
                            victims.append(s)
                    else:
                        owner[b] = s
                        refs[b] += 1
            got = tbl.copy()
            r, n, v = _audit_table(got, NB, sharing)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(r, refs)
            assert (n, v) == (lost, victims)


# --------------------------------------------- the equivalence property ---


def _resilient_run(pkg, mode, seed, frac, wrap, *, mega, plan=None, K=16,
                   n_req=12):
    """`tests/test_resilience.py::_compare_resilient`'s drive of one side:
    the plan (capacity kinds, 3 events in K rounds unless given), react
    every 4 rounds, K host steps or one K-round megastep."""
    clk = [0.0]
    eng = _engine(pkg, mode, clk, watchdog=3, wrap=wrap)
    eng._clock_box = clk
    reqs = _requests(pkg, mode, seed, n_req, frac)
    res = PKG[pkg][2]
    if plan is None:
        plan = res.FaultPlan.random(seed, rounds=K, n_faults=3,
                                    kinds=res.CAPACITY_KINDS)
    else:
        plan = res.FaultPlan(seed=seed, events=tuple(
            res.FaultEvent(**e) for e in plan))
    rz = res.ResilientEngine(eng, plan=plan, react_every=4, seed=seed)
    eng.submit_batch(reqs)
    times = [k * DT for k in range(K)]
    if mega:
        rz.megastep(K, token_fn=PKG[pkg][3],
                    nows=np.asarray(times, np.float32))
    else:
        for t in times:
            clk[0] = t
            rz.step(tts._ident)
    assert len(rz.samples) == K
    return rz, eng, reqs


def _four_runs(mode, seed, frac, wrap, runs=None, **kw):
    """Host and megastep runs of both packages (``runs``: those already
    made); each port path is held bit-equal to its JAX path.  Returns the
    port's and JAX's host-vs-megastep differences and the runs."""
    runs = dict(runs or {})
    for p in ("jax", "port"):
        for m in (False, True):
            if (p, m) not in runs:
                runs[p, m] = _resilient_run(p, mode, seed, frac, wrap,
                                            mega=m, **kw)
    tag = f"{mode} seed={seed} frac={frac} wrap={wrap}"
    for m in (False, True):
        assert _diff(runs["port", m], runs["jax", m],
                     paths_differ=False) == [], (tag, m)
        assert tres.exit_audit(runs["port", m][1]) == \
            jres.exit_audit(runs["jax", m][1]), (tag, m)
    return (_diff(runs["port", False], runs["port", True], paths_differ=True),
            _diff(runs["jax", False], runs["jax", True], paths_differ=True),
            runs)


@settings(max_examples=2, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([0.0, 0.4]),
       st.booleans())
def test_resilient_megastep_equals_host_loop_property(seed, frac, wrap):
    """``megastep(K) ≡ K·step()`` survives fault injection and recovery in
    the port: the host-loop and megastep ResilientEngines agree in
    streams, rounds, retries, every sample, the stats, the QoS state and
    the ladder's actions, with and without the 2³² ticket wrap.  Where
    they differ, the reference's own two paths must differ in exactly the
    same observables (after rung 3 the host admits by the queue walk, the
    megastep by the functional round: ROADMAP queue 3), and each port path
    must equal its JAX path bit for bit."""
    runs = {("port", m): _resilient_run("port", "chunked", seed, frac, wrap,
                                        mega=m) for m in (False, True)}
    port_d = _diff(runs["port", False], runs["port", True],
                   paths_differ=True)
    if port_d:
        _, jax_d, _ = _four_runs("chunked", seed, frac, wrap, runs=runs)
        assert port_d == jax_d, (seed, frac, wrap, port_d, jax_d)


@pytest.mark.parametrize("wrap", [False, True])
def test_pinned_reference_red_seed(wrap):
    """`tests/test_resilience.py`'s pinned red (seed 1_037_520_247,
    deadline_frac 0.4, no wrap; and the same seed across the 2³² ticket
    wrap): rung 2 audits at round 4, rung 3 falls back to the functional
    QoS round at round 8.  Each port path equals its JAX path bit for bit
    — streams, samples with every health bit, stats, QoS state and the
    ladder's whole log.  The port's two paths then differ as JAX's do,
    in ``qos.bucket_seq`` only (the host's queue walk and the megastep's
    functional round poke different waiting-array buckets; streams,
    samples, stats and the ladder agree): without the wrap, 6 of 256
    entries, by at most 4 — the same entries and values as the
    reference's."""
    port_d, jax_d, runs = _four_runs("chunked", 1_037_520_247, 0.4, wrap)
    assert port_d == jax_d == ["qos.bucket_seq"]
    acts = [(e["round"], e["action"]) for e in runs["port", True][0].events]
    assert (4, "audit_kv") in acts and (8, "kernel_fallback") in acts
    if wrap:
        return
    bh = _n(runs["port", False][1].qos.bucket_seq).astype(np.int64)
    bm = _n(runs["port", True][1].qos.bucket_seq).astype(np.int64)
    jh = _n(runs["jax", False][1].qos.bucket_seq).astype(np.int64)
    jm = _n(runs["jax", True][1].qos.bucket_seq).astype(np.int64)
    assert (bh != bm).sum() == 6 and np.abs(bh - bm).max() == 4
    np.testing.assert_array_equal(bh, jh)
    np.testing.assert_array_equal(bm, jm)


def test_sharing_megastep_equals_host_loop():
    """With prefix sharing (`tests/test_torch_step.py`'s sharing mode) the
    two port drives agree in every observable under a plan of a stuck
    slot and a dropped poke, and each equals its JAX path."""
    plan = [dict(round=3, kind="stuck_slot", arg=9),
            dict(round=9, kind="drop_poke")]
    port_d, jax_d, runs = _four_runs("sharing", 5, 0.0, False, plan=plan,
                                         n_req=N_REQ["sharing"])
    assert port_d == jax_d == [], (port_d, jax_d)
    assert runs["port", True][1].stats.quarantined  # the watchdog fired


def test_sharing_kv_counter_is_invisible_to_the_host_replica():
    """A fault of the reference (ROADMAP queue 3): under sharing a
    ``KV_COUNTER`` leak patches the host loop's block-semaphore mirror,
    which the next step resyncs from the replica pool (`_hshare_sync`), so
    the host loop never sees the leak, while the megastep's persistent pool
    keeps it and audits.  Each port path equals its JAX path; the two
    drives differ in both packages alike."""
    plan = [dict(round=2, kind="kv_counter", delta=-2)]
    port_d, jax_d, runs = _four_runs("sharing", 5, 0.0, False, plan=plan,
                                         n_req=N_REQ["sharing"])
    assert port_d == jax_d and "stats.kv_audits" in port_d
    assert runs["port", False][1].stats.kv_audits == 0
    assert runs["port", True][1].stats.kv_audits == 1


# -------------------------------------------------------------- rung 4 ---


def _ladder_run(pkg, tmp_path, *, seed, n_req, events, mega, K=8,
                snapshot_every=4, watchdog=3, react_every=2, base=None,
                max_rounds=240):
    """`tests/test_resilience.py`'s rung-4 drive (its watchdog of 4 here
    3, the other tests' value, so JAX compiles one megastep family): the
    chunked engine, a plan, a checkpoint manager in ``tmp_path/pkg``,
    drained to the end."""
    clk = [0.0]
    eng = _engine(pkg, "chunked", clk, watchdog=watchdog)
    eng._clock_box = clk
    reqs = _requests(pkg, "chunked", seed, n_req, 0.0)
    res = PKG[pkg][2]
    if base is not None:
        plan = res.FaultPlan.random(base, rounds=20, n_faults=2,
                                    kinds=res.CAPACITY_KINDS)
        for e in events:
            plan = plan.with_crash(e["round"])
    else:
        plan = res.FaultPlan(seed=0, events=tuple(
            res.FaultEvent(**e) for e in events))
    ck = None
    if tmp_path is not None:
        ck = PKG[pkg][4](str(tmp_path / pkg), keep=8)
    rz = res.ResilientEngine(eng, plan=plan, react_every=react_every,
                             seed=seed, ckpt=ck,
                             snapshot_every=snapshot_every)
    eng.submit_batch(reqs)
    spent = 0
    while spent < max_rounds:
        if (all(q.done_event.is_set() for q in reqs) and not rz._retryq
                and not eng.active):
            break
        if mega:
            b = eng._round_no
            rz.megastep(K, token_fn=PKG[pkg][3], nows=np.asarray(
                [(b + k) * DT for k in range(K)], np.float32))
            spent += K
        else:
            clk[0] = eng._round_no * DT
            rz.step(tts._ident)
            spent += 1
    return rz, eng, reqs


def _ladder_both(tmp_path, drained=True, **kw):
    """The rung-4 drive in both packages: the port's ladder log, samples,
    streams, stats and exit audit equal JAX's."""
    runs = {p: _ladder_run(p, tmp_path, **kw) for p in ("jax", "port")}
    (jz, je, jr), (tz, te, tr) = runs["jax"], runs["port"]
    assert _events(tz) == _events(jz)
    assert tz.samples == jz.samples
    for a, b in zip(jr, tr):
        for f in _REQ:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert te.stats.__dict__ == je.stats.__dict__
    assert all(r.done_event.is_set() for r in tr) or not drained
    assert tz.audit() == jres.exit_audit(je) and tz.audit()["ok"]
    return tz, te, tr


def test_crash_restore_replays_to_identical_state(tmp_path):
    """A mid-run CRASH (snapshot → restore → replay) converges to the
    final state of the uncrashed run; the crashed run's ladder log,
    samples and streams equal JAX's."""
    outs = []
    for crash in (None, 9):
        kw = dict(seed=5, n_req=10, mega=True, K=20, base=5, max_rounds=20,
                  events=[dict(round=crash, kind="crash")] if crash else [])
        if crash:
            tz, te, tr = _ladder_both(tmp_path / "crash", drained=False,
                                      **kw)
        else:
            tz, te, tr = _ladder_run("port", tmp_path / "clean", **kw)
        outs.append((tz, te, [list(r.out_tokens) for r in tr],
                     [(r.expired, r.admit_round) for r in tr]))
    (z0, e0, tok0, m0), (z1, e1, tok1, m1) = outs
    assert tok1 == tok0 and m1 == m0
    assert e1.stats.restores >= 1 and e1.stats.snapshots >= 1
    assert e0.stats.restores == 0
    assert any(e["action"] == "crash" for e in z1.events)
    assert e1.stats.finished == e0.stats.finished
    assert torch.equal(e0.qos.grant, e1.qos.grant)


def test_crash_on_host_loop_restores_and_drains(tmp_path):
    tz, te, _ = _ladder_both(tmp_path, seed=17, n_req=8, mega=False,
                             events=[dict(round=6, kind="crash")])
    assert te.stats.restores == 1


def test_nan_escalates_to_rung4_restore(tmp_path):
    """NaN health skips the lower rungs: the restore clears the sticky
    flag and the run finishes clean."""
    tz, te, _ = _ladder_both(tmp_path, seed=13, n_req=8, mega=False,
                             watchdog=0,
                             events=[dict(round=5, kind="nan_logit")])
    assert te.stats.restores >= 1 and not te._nonfinite_sticky
    assert tz.samples[-1]["health"] == 0
    assert any(s["health"] & sn.H_NAN for s in tz.samples)


def test_bit_flip_trips_audit_and_drains():
    """BIT_FLIP on the device table: the deep sentinels see it, rung 2's
    audit rebuilds the pool, the run drains and audits clean, in both
    packages, with the same streams.  The ladders differ after the audit
    (`test_audit_rebuilds_refcounts_beyond_the_reference`): JAX's
    refcounts stay stale, so its partition bit stays set and its ladder
    climbs to rung 3 and (without a checkpoint) logs ``unrecoverable``;
    the port's pool is whole after the audit and its ladder stops there."""
    kw = dict(seed=5, n_req=8, mega=True, snapshot_every=0,
              events=[dict(round=6, kind="bit_flip", arg=2, delta=1)])
    (jz, je, jr), (tz, te, tr) = [_ladder_run(p, None, **kw)
                                  for p in ("jax", "port")]
    for z, e, r in ((jz, je, jr), (tz, te, tr)):
        assert all(q.done_event.is_set() for q in r)
        assert e.stats.kv_audits >= 1 and z.audit()["ok"]
    assert [q.out_tokens for q in tr] == [q.out_tokens for q in jr]
    acts = [(e["round"], e["action"]) for e in tz.events]
    assert acts == [(6, "inject"), (8, "health"), (8, "audit_kv")]
    assert _events(tz) == _events(jz)[:3]
    assert te.stats.kernel_fallbacks == 0 and je.stats.kernel_fallbacks == 1
    assert any(e["action"] == "unrecoverable" for e in jz.events)
    assert all(s["health"] == 0 for s in tz.samples[8:])


def test_torn_shard_restore_falls_back_to_older_snapshot(tmp_path):
    """TORN_SHARD truncates the newest checkpoint's shard; the crash's
    restore finds it unloadable, logs the fallback, restores the snapshot
    before it and replays — one megastep over the whole run, so the
    restore never rewinds past its launch."""
    tz, te, _ = _ladder_both(tmp_path, seed=19, n_req=8, mega=True, K=24,
                             events=[dict(round=9, kind="torn_shard"),
                                     dict(round=10, kind="crash")])
    falls = [e for e in tz.events if e["action"] == "torn_shard_fallback"]
    assert falls and falls[0]["step"] == 8
    assert [e["step"] for e in tz.events if e["action"] == "restore"] == [4]


# ---------------------------------------------------- snapshot aliasing ---


def test_restore_brings_back_the_snapshot_state(tmp_path):
    """The port writes tensors in place (the model's pools by
    ``put_rows_``).  A snapshot taken at round 4 of a megastep engine over
    the paged-pool model, rounds that write the pools, then a restore:
    every device leaf and the host-captured semaphores equal their values
    at snapshot time, in storage of their own."""
    clk = [0.0]
    eng = _engine("port", "chunked", clk, watchdog=3)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator().manual_seed(0), 64, 8, 16, 4, device="cpu")
    eng.submit_batch(_requests("port", "chunked", 2, 12, 0.0))
    fn = es.make_chunked_prefill_token_fn(5)
    eng.megastep(4, token_fn=fn)
    rz = tres.ResilientEngine(eng, ckpt=TCheckpoint(str(tmp_path)))

    def state():
        return ([t.clone() for _, t in _leaves(rz._device_tree())],
                [t.clone() for t in (*eng.sema, *eng._kv_sema)])

    want = state()
    rz._snapshot(4)
    eng.megastep(4, token_fn=fn)
    moved = state()
    assert not all(torch.equal(a, b) for a, b in zip(want[0], moved[0]))
    live = {t.data_ptr() for _, t in _leaves(rz._device_tree())}
    assert rz._restore(8) == 4 and eng._round_no == 4
    got = state()
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not live & {t.data_ptr() for _, t in _leaves(rz._device_tree())}
    # a second restore of the same snapshot starts from the same state
    eng.megastep(4, token_fn=fn)
    rz._restore(8)
    for a, b in zip(want[0] + want[1], sum(state(), [])):
        assert torch.equal(a, b)


def _leaves(tree):
    from repro_torch.checkpoint.manager import path_leaves

    return path_leaves(tree)


def _chaos_run(pkg, seed):
    """`tests/test_resilience.py::test_chaos_property_drains_and_audits_clean`
    at one draw, host loop (``mega=False``), without hypothesis: the
    chunked engine with a watchdog of 4, 10 requests, 4 capacity faults
    in 24 rounds, react every 2 rounds, a retry budget of 2, drained on
    the round-indexed clock."""
    res = PKG[pkg][2]
    clk = [0.0]
    eng = _engine(pkg, "chunked", clk, watchdog=4)
    eng._clock_box = clk
    reqs = _requests(pkg, "chunked", seed, 10, 0.0)
    plan = res.FaultPlan.random(seed, rounds=24, n_faults=4,
                                kinds=res.CAPACITY_KINDS)
    rz = res.ResilientEngine(eng, plan=plan, react_every=2, retry_budget=2,
                             seed=seed)
    eng.submit_batch(reqs)
    for _ in range(240):
        if (all(q.done_event.is_set() for q in reqs) and not rz._retryq
                and not eng.active):
            break
        clk[0] = eng._round_no * DT
        rz.step(tts._ident)
    return (all(q.done_event.is_set() for q in reqs), rz.audit(),
            [(e.get("round"), e["action"], e.get("kind"))
             for e in rz.events])


@pytest.mark.parametrize("seed,free,last", [(67, 13, "kernel_fallback"),
                                            (653314427, 15, "inject")])
def test_chaos_failing_seeds_leak_on_both_sides(seed, free, last):
    """The chaos property's failing draws (seeds 67 and 653314427, host
    loop): a KV_COUNTER fault the ladder never audits leaves the exit
    audit's "kv counter: free F + held 0 != 16" — at 67 the third fault's
    health event escalates to the kernel fallback (rung 3), which does
    not rebuild the counter; at 653314427 the last fault lands in round
    22 and the drain ends before the next reaction.  Every request still
    drains.  A reference red the port reproduces: the port's run equals
    JAX's in the audit and the ladder's events."""
    port, ref = _chaos_run("port", seed), _chaos_run("jax", seed)
    assert port == ref
    done, audit, events = port
    assert done
    assert audit == {"ok": False, "violations": [
        f"kv counter: free {free} + held 0 != 16"]}
    assert events[-1][1] == last
