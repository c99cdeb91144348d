"""Trace-event kinds for the per-round in-scan event table.

Pure Python on purpose — the ``obs`` package (span builder, flight
recorder, exporters) imports these constants without pulling in jax, and
`serving.engine_state` uses the same values inside the scanned round, so
the device table and every host consumer agree on the encoding.

Two families share one namespace:

* **engine events** (``EV_ADMIT`` … ``EV_QUARANTINE``) are emitted by the
  engine round — on device via the fixed-shape event table riding the
  :class:`~repro.serving.engine_state.TelemetryRing` (drained in the
  megastep's ONE host sync), and bit-identically by the host ``step()``
  bookkeeping (tests/test_obs.py);
* **fabric events** (``EV_SUBMIT`` … ``EV_EXPIRE``) only ever exist on
  the host — enqueue, routing, migration, and load-shed decisions the
  device never sees — and are appended straight to the host
  :class:`~repro.obs.trace.TraceBuffer` so spans stitch across replicas.

Each event is ``(kind, uid, slot, arg)``; the virtual clock is the
enclosing round's ``now`` (every event in a round shares it).  ``uid`` is
the request id (cluster-level rid across the router), ``slot`` the engine
slot (the admission lane index for ADMIT/PREFIX_ATTACH, the replica index
for fabric events, −1 when not applicable), and ``arg`` the per-kind
payload listed below.
"""

EV_NONE = 0           # padding in the fixed-shape table
EV_ADMIT = 1          # backlog row granted a slot      arg = prompt_len
EV_PREFILL_CHUNK = 2  # prompt chunk landed             arg = chunk tokens
EV_PARK = 3           # slot parked on the block TWA    arg = block deficit
EV_RESUME = 4         # parked slot woken + granted     arg = 0
EV_PREFIX_ATTACH = 5  # cache-covered prefix attached   arg = covered tokens
EV_COW = 6            # copy-on-write take              arg = replaced block id
EV_PREEMPT = 7        # running slot deadline-preempted arg = tokens emitted
EV_FINISH = 8         # slot completed (hit max_new)    arg = tokens emitted
EV_QUARANTINE = 9     # recovery rung 1 evicted a slot  arg = blocks released
EV_SUBMIT = 10        # request entered a queue         arg = 0
EV_ROUTE = 11         # router bound request → replica  arg = lease ticket
EV_MIGRATE = 12       # request requeued off a dead replica  arg = attempt #
EV_SHED = 13          # router dropped the request      arg = 0
EV_EXPIRE = 14        # backlog deadline tombstone      arg = 0

EVENT_NAMES = {
    EV_NONE: "NONE",
    EV_ADMIT: "ADMIT",
    EV_PREFILL_CHUNK: "PREFILL_CHUNK",
    EV_PARK: "PARK",
    EV_RESUME: "RESUME",
    EV_PREFIX_ATTACH: "PREFIX_ATTACH",
    EV_COW: "COW",
    EV_PREEMPT: "PREEMPT",
    EV_FINISH: "FINISH",
    EV_QUARANTINE: "QUARANTINE",
    EV_SUBMIT: "SUBMIT",
    EV_ROUTE: "ROUTE",
    EV_MIGRATE: "MIGRATE",
    EV_SHED: "SHED",
    EV_EXPIRE: "EXPIRE",
}

# The fixed per-round table is 8 lane-major segments of S entries each, in
# phase order (matching the engine round's phase numbering) — compaction
# in `engine_state.engine_round` preserves this order, and the host
# `step()` appends its per-kind event lists in the same order, so the two
# drained streams compare with ``==``.
SCAN_SEGMENTS = (EV_PREEMPT, EV_ADMIT, EV_PREFIX_ATTACH, EV_PARK,
                 EV_RESUME, EV_PREFILL_CHUNK, EV_COW, EV_FINISH)

# Terminal kinds: a well-formed span ends with exactly one of these.
TERMINAL_EVENTS = (EV_FINISH, EV_PREEMPT, EV_SHED, EV_EXPIRE)
