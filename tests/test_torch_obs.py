"""The port's observability layer (`repro_torch.obs`, a copy of
`repro.obs`) and the engine's obs/trace wiring:

* each obs module against `repro.obs` on the same inputs: the log
  histogram and its merge, the rolling median, the per-tenant SLO and its
  merge, the sinks with the smoothed companion trace, the flight
  recorder, the health flags, the fleet aggregate, span building
  (park/resume, deadline preemption, prefix attach, ticket wrap) and the
  Perfetto export;
* the port engine's per-round samples, trace spans and ``slo`` summary:
  the host ``step()`` against ``megastep(K)``, and against the JAX engine
  on the same trace;
* the sync accounting: a megastep stays one host sync with the ring and
  the trace, ``telemetry()`` adds none.

The reference's ``test_trace_cluster_migration_and_flight`` needs the
router (ROADMAP queue 1 item 7, the fabric) and waits for it.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro import obs as jobs
from repro.serving.engine_state import rid_token_fn as j_rid_token_fn
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.serving.engine_state import rid_token_fn
from repro_torch.serving.events import (
    EV_PARK,
    EV_PREFIX_ATTACH,
    EV_RESUME,
    TERMINAL_EVENTS,
)
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

import test_torch_step as tts

DT = tts.DT


# ------------------------------------------------ obs units vs repro.obs ----


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([0.05, 0.01]))
def test_log_histogram_and_merge_match_reference(seed, res):
    """Quantiles, count, sum, mean, min and max of a heavy-tailed stream,
    and of two histograms merged, equal the reference's; the merge equals
    one histogram fed the concatenated stream."""
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(0.0, 2.0, int(rng.integers(1, 400)))
    ys = rng.lognormal(1.0, 1.0, int(rng.integers(1, 200)))
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0)
    out = []
    for mod in (tobs, jobs):
        a, b, c = (mod.LogHistogram(resolution=res) for _ in range(3))
        for x in xs:
            a.add(float(x))
            c.add(float(x))
        for y in ys:
            b.add(float(y))
            c.add(float(y))
        one = [a.quantile(q) for q in qs] + [a.count, a.sum, a.mean, a.min,
                                              a.max, a.percentiles()]
        a.merge(b)
        two = [a.quantile(q) for q in qs] + [a.count, a.sum, a.min, a.max]
        assert two[:len(qs)] == [c.quantile(q) for q in qs]
        out.append((one, two))
    assert out[0] == out[1]


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 12))
def test_rolling_median_matches_reference(seed, window):
    xs = np.random.default_rng(seed).normal(size=60)
    rt, rj = tobs.RollingMedian(window), jobs.RollingMedian(window)
    for x in xs:
        assert rt.push(float(x)) == rj.push(float(x))
    assert rt.value == rj.value
    rt.reset()
    assert math.isnan(rt.value)


def _slo_records():
    return [dict(n_tokens=3, expired=False, preempted=False,
                 submit_clock=0.0, first_tok_clock=1.0, last_tok_clock=2.0),
            dict(n_tokens=2, expired=False, preempted=False,
                 submit_clock=0.5, first_tok_clock=9.0, last_tok_clock=9.5),
            dict(n_tokens=0, expired=True, preempted=False,
                 submit_clock=0.0, first_tok_clock=None,
                 last_tok_clock=None),
            dict(n_tokens=1, expired=True, preempted=True,
                 submit_clock=1.0, first_tok_clock=2.0, last_tok_clock=2.0)]


def test_tenant_slo_and_merge_match_reference():
    out = []
    for mod in (tobs, jobs):
        a = mod.TenantSLO(ttft_target=5.0, tpot_target=1.0)
        b = mod.TenantSLO(ttft_target=5.0, tpot_target=1.0)
        recs = _slo_records()
        for r in recs[:2]:
            a.record(**r)
        for r in recs[2:]:
            b.record(**r)
        a.merge(b)
        with pytest.raises(ValueError):
            a.merge(mod.TenantSLO(ttft_target=1.0))
        out.append(a.summary())
    assert out[0] == out[1]
    assert out[0]["submitted"] == 4 and out[0]["expired"] == 2


def test_sinks_and_engine_obs_match_reference(tmp_path):
    """The same rounds and resolved requests through an ``EngineObs``
    with a JSONL, a callback and a stdout sink (smoothed companion trace,
    health flags): the records, the summaries and the table agree."""
    class R:
        tenant_id = "gold"
        out_tokens = [1, 2, 3, 4, 5]
        expired = False
        preempted = False
        submit_clock = 1.0
        first_tok_clock = 3.0
        last_tok_clock = 5.0

    out = []
    for name, mod in (("t", tobs), ("j", jobs)):
        path = tmp_path / f"{name}.jsonl"
        got = []
        o = mod.EngineObs([mod.JsonlSink(str(path)),
                           mod.CallbackSink(got.append,
                                            filter=lambda r: r["round"] > 0),
                           mod.StdoutSink(prefix="# ")],
                          ttft_target=2.5, smooth_window=3,
                          flight=mod.FlightRecorder(capacity=2))
        for k in range(5):
            o.record_round({"round": k, "clock": k * 0.5, "tokens": k % 2,
                            "active": 1, "kv_free": 10 - k,
                            "prefill_tokens": 0, "blocks_shared": k,
                            "health": 1 if k == 3 else 0})
        o.record_request(R())
        o.close()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        out.append((lines, got, o.summary(), o.render_table(),
                    o.flight.summary()))
    assert out[0] == out[1]
    lines, got = out[0][0], out[0][1]
    assert len(lines) == 5 and len(got) == 4
    assert lines[-1]["smoothed"]["kv_free"] == 7  # median(8, 7, 6)
    assert lines[3]["health_flags"] == ["slot_conserve"]


def test_flight_recorder_matches_reference():
    """One bundle per newly tripped sentinel bit, a bounded window, and
    explicit dumps — with the trace tail frozen into each bundle."""
    out = []
    for mod in (tobs, jobs):
        buf = mod.TraceBuffer(capacity=8)
        fr = mod.FlightRecorder(capacity=4, trace=buf, trace_tail=3)
        for k, h in enumerate((0, 1, 1, 3, 3, 0)):
            buf.add(1, k, 0, 0, k * 0.5, k)
            fr.observe_round({"round": k, "clock": k * 0.5, "health": h})
        fr.dump("manual", extra={"k": 1})
        out.append((fr.bundles, fr.summary()))
    assert out[0] == out[1]
    assert [b["reason"] for b in out[0][0]] == ["sentinel", "sentinel",
                                                "manual"]


def test_fleet_aggregate_matches_reference():
    """The cross-replica reduction (bucket-wise histogram merge, health
    union) of two recorders, with router sections, equals the
    reference's."""
    recs = _slo_records()
    out = []
    for mod in (tobs, jobs):
        reps = []
        for i in range(2):
            o = mod.EngineObs(ttft_target=3.0)
            for k in range(3):
                o.record_round({"round": k, "clock": float(k),
                                "health": 4 if (i, k) == (1, 2) else 0})
            for r in recs[i::2]:
                req = type("R", (), dict(
                    tenant_id=("gold", "bronze")[i],
                    out_tokens=[0] * r["n_tokens"], expired=r["expired"],
                    preempted=r["preempted"],
                    submit_clock=r["submit_clock"],
                    first_tok_clock=r["first_tok_clock"],
                    last_tok_clock=r["last_tok_clock"]))
                o.record_request(req)
            reps.append(o)
        fleet = mod.aggregate(reps, router={"migrations": 2, "shed": 1})
        out.append((fleet, mod.render_cluster_table(fleet)))
    assert out[0] == out[1]


# ------------------------------------------------ engine traces and spans ---


def _drain(eng, *, K=12, max_megasteps=20, mega_token_fn=rid_token_fn):
    """Megasteps until every submitted request resolves."""
    total = (eng.stats.finished + eng.stats.expired
             + sum(len(q) for q in eng._tenant_queues) + len(eng.active))
    rounds = 0
    for _ in range(max_megasteps):
        eng.megastep(K, token_fn=mega_token_fn,
                     nows=np.asarray([(rounds + k) * DT for k in range(K)],
                                     np.float32))
        rounds += K
        if eng.stats.finished + eng.stats.expired >= total:
            return
    raise AssertionError("did not drain")


def _assert_wellformed(spans, rids, tag=""):
    """One closed span per request, exactly one terminal event, and
    non-negative critical-path parts within the total."""
    assert set(spans) == set(rids), tag
    for rid, sp in spans.items():
        assert sp["terminal"] is not None, (tag, rid)
        assert len([e for e in sp["events"]
                    if e["kind"] in TERMINAL_EVENTS]) == 1, (tag, rid)
        bd = sp["breakdown"]
        for k in ("queue", "prefill", "park", "decode", "migration"):
            assert 0 <= bd[k] <= bd["total"] + 1e-6, (tag, rid, k)


def _spans_pair(mode, trace, *, wrap=False):
    """The port engine and the JAX engine drained by megastep on one
    trace: each trace buffer built into spans by its own package."""
    clk = [0.0]
    te = tts._port(mode, clk, wrap=wrap)
    je = tts._jax(mode, clk, wrap=wrap)
    te.qos = convert.qos_from_jax(je.qos, device="cpu")
    te.submit_batch([TRequest(**t) for t in trace])
    je.submit_batch([JRequest(**t) for t in trace])
    _drain(te)
    _drain(je, mega_token_fn=j_rid_token_fn)
    return tobs.build_spans(te._trace), jobs.build_spans(je._trace), te


SPAN_RUNS = {
    # name: (mode, trace, wrap, event kinds that must appear)
    "park_resume": ("chunked", [dict(rid=i, prompt=[2] * 17,
                                     max_new_tokens=4,
                                     tenant_id=("gold", "bronze")[i % 2])
                                for i in range(8)], False,
                    {EV_PARK, EV_RESUME}),
    "deadline_preemption": ("qos", tts._trace("qos", 11, 18, 0.8), False,
                            set()),
    "prefix_attach": ("sharing", tts._trace("sharing", 5, 14, 0.0), False,
                      {EV_PREFIX_ATTACH}),
    "ticket_wrap": ("chunked", tts._trace("chunked", 3, 10, 0.0), True,
                    set()),
}


@pytest.mark.parametrize("name", sorted(SPAN_RUNS))
def test_trace_spans_match_reference(name):
    """Span trees of a drained engine: well formed, carrying the path's
    events, and equal to the JAX engine's on the same trace (segments,
    breakdowns, terminals, raw events)."""
    mode, trace, wrap, kinds = SPAN_RUNS[name]
    spt, spj, te = _spans_pair(mode, trace, wrap=wrap)
    assert spt == spj, name
    _assert_wellformed(spt, [t["rid"] for t in trace], name)
    seen = {e["kind"] for sp in spt.values() for e in sp["events"]}
    assert kinds <= seen, (name, seen)
    terms = {sp["terminal"] for sp in spt.values()}
    if name == "deadline_preemption":
        assert "FINISH" in terms and terms & {"PREEMPT", "EXPIRE"}
    if name == "park_resume":
        assert any(sp["breakdown"]["park"] > 0 for sp in spt.values())
    if name == "prefix_attach":
        assert all(e["arg"] > 0 for sp in spt.values() for e in sp["events"]
                   if e["kind"] == EV_PREFIX_ATTACH)
    assert te.telemetry()["trace"]["complete"] == len(trace)


def test_perfetto_export_matches_reference():
    """The Chrome-trace export of the same spans equals the reference's
    and round-trips through JSON as complete slices."""
    spt, spj, _ = _spans_pair("chunked", tts._trace("chunked", 2, 8, 0.3))
    doc = tobs.to_perfetto(spt)
    assert doc == jobs.to_perfetto(spj)
    evs = json.loads(json.dumps(doc))["traceEvents"]
    assert evs
    for e in evs:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
    assert {e["name"] for e in evs if e["ph"] == "X"} <= {
        "queue", "prefill", "park", "decode", "migration"}


# --------------------------------- engine samples: host ≡ megastep ≡ JAX ----


def _host_mega_jax(mode, seed, frac, K, n_req, *, obs=False):
    """K host steps of the port, one port megastep(K) and K host steps of
    the JAX engine on one trace; each engine with an ``EngineObs`` of its
    own package when ``obs``."""
    trace = tts._trace(mode, seed, n_req, frac)
    times = [k * DT for k in range(K)]
    runs = {}
    for kind in ("host", "mega", "jax"):
        clk = [0.0]
        if kind == "jax":
            eng = tts._jax(mode, clk)
            reqs = [JRequest(**t) for t in trace]
            if obs:
                eng._obs = jobs.EngineObs(ttft_target=2.0)
        else:
            eng = tts._port(mode, clk,
                            obs=tobs.EngineObs(ttft_target=2.0)
                            if obs else None)
            reqs = [TRequest(**t) for t in trace]
        eng.submit_batch(reqs)
        samples = []
        if kind == "mega":
            eng.megastep(K, token_fn=rid_token_fn,
                         nows=np.asarray(times, np.float32))
            samples = eng.telemetry()["last_samples"]
        else:
            for t in times:
                clk[0] = t
                eng.step(tts._ident)
                samples += eng.telemetry()["last_samples"]
        runs[kind] = (eng, reqs, samples)
    return runs


@pytest.mark.parametrize("mode", ["qos", "paged", "chunked", "sharing"])
def test_samples_host_equal_megastep_and_jax(mode):
    """Every round's sample (all keys, events included) of K host steps
    equals the megastep's ring drain and the JAX engine's host samples;
    the lifecycle clocks agree; the megastep is one host sync and the
    host loop K."""
    K = {"qos": 12, "paged": 14, "chunked": 18, "sharing": 20}[mode]
    runs = _host_mega_jax(mode, 5, 0.5, K, 14)
    hs, ms, js = (runs[k][2] for k in ("host", "mega", "jax"))
    assert len(hs) == K and hs == ms == js, mode
    for a, b in zip(runs["host"][1], runs["mega"][1]):
        for f in ("submit_clock", "first_tok_clock", "last_tok_clock",
                  "finish_clock"):
            assert getattr(a, f) == getattr(b, f), (mode, a.rid, f)
    assert runs["host"][0].stats.host_syncs == K
    assert runs["mega"][0].stats.host_syncs == 1
    if mode == "chunked" and any(s["parked"] for s in hs):
        assert any(sum(s["kv_wait_hist"]) > 0 for s in hs)


def test_slo_summary_host_megastep_and_jax():
    """``telemetry()["slo"]``: identical sample streams and lifecycle
    clocks give identical per-tenant SLO summaries on the port's two
    paths, and the JAX engine's for the tenants each saw."""
    runs = _host_mega_jax("qos", 5, 0.5, 12, 18, obs=True)
    sh, sm, sj = (runs[k][0].telemetry()["slo"]
                  for k in ("host", "mega", "jax"))
    assert sh["rounds"] == sm["rounds"] == sj["rounds"] == 12
    assert sh == sj
    for t in set(sh["tenants"]) & set(sm["tenants"]):
        assert sh["tenants"][t] == sm["tenants"][t], t


def test_trace_host_step_equals_megastep_spans():
    """The host loop's trace and the megastep's ring-drain trace build the
    same spans: terminals, event kinds and breakdowns per request."""
    runs = _host_mega_jax("chunked", 9, 0.5, 24, 12)
    sph = tobs.build_spans(runs["host"][0]._trace)
    spm = tobs.build_spans(runs["mega"][0]._trace)
    assert set(sph) == set(spm)
    for rid in sph:
        a, b = sph[rid], spm[rid]
        assert a["terminal"] == b["terminal"], rid
        assert [e["kind"] for e in a["events"]] == \
            [e["kind"] for e in b["events"]], rid
        assert a["breakdown"] == b["breakdown"], rid
    assert sph == jobs.build_spans(runs["jax"][0]._trace)


def test_engine_telemetry_trace_key():
    """``telemetry()["trace"]`` on the host path: every request's span
    closes and the critical path has its five parts."""
    clk = [0.0]
    eng = tts._port("chunked", clk)
    eng.submit_batch([TRequest(**t) for t in tts._trace("chunked", 4, 6,
                                                         0.0)])
    k = 0
    while eng.stats.finished + eng.stats.expired < 6 and k < 200:
        clk[0] = k * DT
        eng.step(tts._ident)
        k += 1
    tr = eng.telemetry()["trace"]
    assert tr["spans"] == 6 and tr["complete"] == 6
    assert set(tr["critical_path"]) == {"queue", "prefill", "park",
                                        "decode", "migration"}
    assert tr["events"] > 0 and tr["dropped"] == 0


def test_megastep_with_ring_is_one_host_sync():
    """A megastep with the ring and the trace stays one host sync, and
    ``telemetry()`` (host reads only) adds none; a host step records one
    sample per round."""
    clk = [0.0]
    eng = tts._port("qos", clk, obs=tobs.EngineObs())
    eng.submit_batch([TRequest(**t) for t in tts._trace("qos", 3, 12,
                                                         0.0)])
    eng.megastep(10, token_fn=rid_token_fn,
                 nows=np.asarray([k * DT for k in range(10)], np.float32))
    tel = eng.telemetry()
    assert eng.stats.host_syncs == tel["stats"]["host_syncs"] == 1
    assert len(tel["last_samples"]) == 10
    assert tel["slo"]["rounds"] == 10
    for k in range(4):
        clk[0] = (10 + k) * DT
        eng.step(tts._ident)
        samples = eng.telemetry()["last_samples"]
        assert len(samples) == 1 and samples[0]["round"] == 10 + k
    assert eng.stats.host_syncs == 5


def test_engine_obs_health_flags_surfaced():
    """The health bitmask decodes to named flags (the port's single table
    in `serving.sentinels`), on sink records, in the summary and in the
    flight recorder's bundles."""
    from repro_torch.serving.sentinels import HEALTH_BITS

    got = []
    obs = tobs.EngineObs([tobs.CallbackSink(got.append)],
                         flight=tobs.FlightRecorder(capacity=2))
    bit = HEALTH_BITS["slot_conserve"] | HEALTH_BITS["nan"]
    obs.record_round({"round": 0, "clock": 0.0, "health": bit})
    assert obs.summary()["health"]["flags"] == ["slot_conserve", "nan"]
    assert got[0]["health_flags"] == ["slot_conserve", "nan"]
    assert obs.flight.bundles[0]["health"]["flags"] == ["slot_conserve",
                                                        "nan"]


def test_engine_accepts_obs_in_every_mode():
    """``obs=`` builds in every QoS mode and in the single-tenant engine,
    and ``telemetry()`` carries its summary."""
    for mode in tts.MODES:
        eng = tts._port(mode, [0.0], obs=tobs.EngineObs())
        assert eng.step(tts._ident) == 0
        assert eng.telemetry()["slo"]["rounds"] == 1
    eng = TEngine(None, None, 2, obs=tobs.EngineObs(), device="cpu")
    assert eng.step(lambda x: x) == 0
    assert eng.telemetry()["slo"]["rounds"] == 1
