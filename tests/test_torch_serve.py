"""The port's single-tenant engine and serving driver against the JAX
package's on the same traces and weights:

* ``repro_torch.launch.serve.main`` against ``repro.launch.serve.main``
  with the arguments of `tests/test_e2e_train.py`'s serve test and JAX's
  parameters carried across (`convert.params_from_jax`): equal token
  streams per request, tickets, buckets, observed sequences, the
  scan/skip counters and every stat, ``queue_depth == 0``, and equal
  per-step telemetry samples with their event rows;
* a two-wave ``submit_batch`` trace on a toy model, with ``use_kernel``
  on (the ``sema_batch`` pass; its plain version on the CPU) and off:
  bit-equal to each other and to the JAX engine;
* a trace with deadlines, so that running requests are preempted;
* the serving driver over the granite-moe smoke config (semaphore-
  admitted experts: every decode's slots compete for expert capacity)
  and the xlstm smoke config (recurrent states advanced in place): equal
  token streams, request fields and engine state.

Both engines run on a virtual clock (0.0 for the drivers), so the
samples compare with ``==``.  No trace here reaches the 2³² ticket wrap,
where the reference's admit test refuses tickets (ROADMAP queue 3).

The reference's ``ModelServer`` hands its numpy token and position
buffers to an asynchronous jitted call (``jnp.asarray`` may alias host
memory on the CPU) and writes the next token into them before that call
has read them, so its own streams vary from run to run (ROADMAP queue 3).
The test blocks each JAX decode until it is done, which makes the
reference compute what its code says; nothing in the reference changes.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro.serving.scheduler import ContinuousBatchingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.serving.scheduler import ContinuousBatchingEngine as TEngine
from repro_torch.serving.scheduler import Request as TRequest

SERVE_ARGS = ["--arch", "qwen2-0.5b", "--requests", "10", "--slots", "3",
              "--prompt-len", "4", "--max-new", "5"]
REQ_FIELDS = ("rid", "out_tokens", "ticket", "bucket", "observed_seq",
              "fast", "slot", "admit_round", "expire_round", "expired",
              "preempted", "submit_clock", "first_tok_clock",
              "last_tok_clock", "finish_clock", "prio_key")


def _instrument(monkeypatch, cls, log):
    """Give every engine of ``cls`` a clock stuck at 0.0 and record its
    requests and each step's samples in ``log``."""
    init, step, submit_batch = cls.__init__, cls.step, cls.submit_batch

    def init2(self, *a, **kw):
        kw["clock"] = lambda: 0.0
        init(self, *a, **kw)
        log.update(engine=self, reqs=[], samples=[])

    def step2(self, sample_fn):
        n = step(self, sample_fn)
        log["samples"].append(copy.deepcopy(self.telemetry()["last_samples"]))
        return n

    def submit_batch2(self, reqs):
        log["reqs"].extend(reqs)
        return submit_batch(self, reqs)

    monkeypatch.setattr(cls, "__init__", init2)
    monkeypatch.setattr(cls, "step", step2)
    monkeypatch.setattr(cls, "submit_batch", submit_batch2)


def _req_view(r):
    return tuple(getattr(r, f) for f in REQ_FIELDS)


def _same_requests(treqs, jreqs):
    assert len(treqs) == len(jreqs)
    for a, b in zip(treqs, jreqs):
        assert _req_view(a) == _req_view(b), a.rid


def _same_engines(te, je):
    assert te.stats.__dict__ == je.stats.__dict__
    for f in ("ticket", "grant", "bucket_seq", "salt"):
        np.testing.assert_array_equal(
            convert.to_numpy(te.sema)[f], np.asarray(getattr(je.sema, f)),
            err_msg=f)
    tt, jt = te.telemetry(), je.telemetry()
    for k in ("backlog", "active", "free_slots", "queue_depth", "stats",
              "pool_utilization", "last_samples", "recovery"):
        assert tt[k] == jt[k], k


def _synchronous_jax_server(monkeypatch):
    """Each JAX ``ModelServer`` decode returns only once it has run (see
    the module docstring)."""
    init = jserve.ModelServer.__init__

    def init2(self, *a, **kw):
        init(self, *a, **kw)
        decode = self._decode
        self._decode = lambda *x: jax.block_until_ready(decode(*x))

    monkeypatch.setattr(jserve.ModelServer, "__init__", init2)


def test_serve_main_matches_jax(monkeypatch):
    _synchronous_jax_server(monkeypatch)
    jlog, tlog = {}, {}
    _instrument(monkeypatch, JEngine, jlog)
    _instrument(monkeypatch, TEngine, tlog)
    je = jserve.main(SERVE_ARGS)
    params = convert.params_from_jax(je.step_fn.__self__.params,
                                     device="cpu")
    te = tserve.main(SERVE_ARGS + ["--device", "cpu"], params=params)
    assert te is tlog["engine"] and te.device.type == "cpu"
    assert te.stats.finished == 10
    assert te.telemetry()["queue_depth"] == 0
    assert te.stats.backlog_skipped > 0 and te.stats.backlog_scans > 0
    _same_requests(tlog["reqs"], jlog["reqs"])
    assert all(len(r.out_tokens) == 5 for r in tlog["reqs"])
    assert tlog["samples"] == jlog["samples"]
    assert sum(len(s[0]["events"]) for s in tlog["samples"]) == 20
    _same_engines(te, je)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "xlstm-350m"])
def test_serve_main_other_block_kinds_match_jax(monkeypatch, arch):
    """``ModelServer`` streams over a MoE and an xLSTM config equal the
    reference's (JAX's initialiser jitted: the same parameters, sooner)."""
    _synchronous_jax_server(monkeypatch)
    monkeypatch.setattr(jserve, "init_params",
                        jax.jit(jt.init_params, static_argnums=1))
    jlog, tlog = {}, {}
    _instrument(monkeypatch, JEngine, jlog)
    _instrument(monkeypatch, TEngine, tlog)
    args = ["--arch", arch, "--requests", "6", "--slots", "3",
            "--prompt-len", "4", "--max-new", "4"]
    je = jserve.main(args)
    params = convert.params_from_jax(je.step_fn.__self__.params,
                                     device="cpu")
    te = tserve.main(args + ["--device", "cpu"], params=params)
    assert te.step_fn.__self__.cfg.name == f"{arch}-smoke"
    assert te.stats.finished == 6
    _same_requests(tlog["reqs"], jlog["reqs"])
    assert all(len(r.out_tokens) == 4 for r in tlog["reqs"])
    assert len({tuple(r.out_tokens) for r in tlog["reqs"]}) > 1
    assert tlog["samples"] == jlog["samples"]
    _same_engines(te, je)


V = 37


def _toy_step_fn(reqs):
    """Deterministic logits: row r peaks at (7·rid + 3·emitted) mod V."""
    logits = np.zeros((len(reqs), V), np.float32)
    for i, r in enumerate(reqs):
        logits[i, (7 * r.rid + 3 * len(r.out_tokens)) % V] = 1.0
    return logits


def _trace(seed, n, rid0=0, deadlines=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dl = (float(rng.integers(2, 14)) if deadlines and rng.random() < 0.5
              else None)
        out.append(dict(rid=rid0 + i, prompt=[int(x) for x in rng.integers(
            1, 50, int(rng.integers(1, 6)))],
            max_new_tokens=int(rng.integers(1, 7)), deadline=dl))
    return out


def _serve_waves(cls, req_cls, waves, *, use_kernel, submit_one=False,
                 **kw):
    """An engine of ``cls`` on a virtual clock (+1.0 a step): each wave
    ``(at_step, trace)`` is submitted at its step, then steps run until
    every request is done.  Returns the engine, its requests and each
    step's samples."""
    clk = [0.0]
    eng = cls(_toy_step_fn, lambda r: None, 3, use_kernel=use_kernel,
              clock=lambda: clk[0], table_size=64, **kw)
    reqs, samples = [], []
    pending = sorted(waves, key=lambda w: w[0])
    for step in range(200):
        while pending and pending[0][0] == step:
            batch = [req_cls(**t) for t in pending.pop(0)[1]]
            reqs += batch
            if submit_one:
                for r in batch:
                    eng.submit(r)
            else:
                eng.submit_batch(batch)
        if not pending and all(r.done_event.is_set() for r in reqs):
            break
        eng.step(lambda lg: lg.argmax(-1))
        samples.append(copy.deepcopy(eng.telemetry()["last_samples"]))
        clk[0] += 1.0
    assert all(r.done_event.is_set() for r in reqs)
    return eng, reqs, samples


@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_wave_submit_batch_matches_jax(use_kernel):
    """Wave 1 (14 requests) at step 0, wave 2 (10) after 8 steps: the
    second wave's tickets start past the first's, its waiters observe
    buckets the first wave's finishes poke."""
    waves = [(0, _trace(5, 14)), (8, _trace(6, 10, rid0=100))]
    te, tr, ts = _serve_waves(TEngine, TRequest, waves, use_kernel=use_kernel,
                              device="cpu")
    je, jr, js = _serve_waves(JEngine, JRequest, waves, use_kernel=use_kernel)
    assert ts == js
    _same_requests(tr, jr)
    _same_engines(te, je)
    assert te.stats.backlog_skipped > 0
    if use_kernel:  # the kernel path and take_batch give the same engine
        te2, tr2, ts2 = _serve_waves(TEngine, TRequest, waves,
                                     use_kernel=False, device="cpu")
        assert ts2 == ts
        _same_requests(tr2, tr)


def test_deadlines_preempt_like_jax():
    """Running requests whose deadline passes are preempted (PREEMPT
    events, freed slots re-granted in FCFS order); ``submit`` one at a
    time for the second wave."""
    waves = [(0, _trace(9, 12, deadlines=True)),
             (3, _trace(10, 6, rid0=50, deadlines=True))]
    te, tr, ts = _serve_waves(TEngine, TRequest, waves, use_kernel=False,
                              submit_one=True, device="cpu")
    je, jr, js = _serve_waves(JEngine, JRequest, waves, use_kernel=False,
                              submit_one=True)
    assert ts == js
    _same_requests(tr, jr)
    _same_engines(te, je)
    assert te.stats.preempted > 0 and any(r.preempted for r in tr)


def test_single_tenant_engine_rules():
    """The single-tenant engine builds on the CPU when asked; a block pool
    without tenants raises as in JAX; it has no megastep."""
    eng = TEngine(_toy_step_fn, lambda r: None, 2, device="cpu")
    assert eng.device.type == "cpu" and eng.sema.grant.item() == 2
    with pytest.raises(ValueError, match="QoS mode"):
        TEngine(None, None, 2, kv_pool=(8, 4), device="cpu")
    with pytest.raises(ValueError, match="QoS mode"):
        eng.megastep(1)
    assert torch.equal(eng.sema.bucket_seq, torch.zeros(256,
                                                         dtype=torch.int64))
