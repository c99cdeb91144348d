"""Serving driver: continuous batching with TWA-semaphore FCFS admission
over a real model — the port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 24 --slots 4
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
    python -m repro_torch.launch.serve --device cpu     # without a card

``--arch`` takes any architecture of the reference (attention, MoE,
RG-LRU, mLSTM and sLSTM blocks; the audio and vision configurations
decode through their token embeddings, as the reference's server does),
at its smoke config; ``ModelServer(config=...)`` serves a
full one.  The single-tenant engine
(`serving.scheduler.ContinuousBatchingEngine`, ``tenants=None``) admits
through its TWA semaphore and serves through the host ``step()``; the
model (`models.transformer`) decodes through the port's decode-attention
kernel on the card, a MoE block admitting each decode's expert
assignments through its multi-semaphore.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import get_smoke_config
from ..device import resolve_device
from ..models.transformer import decode_step, init_caches, init_params
from ..serving.scheduler import ContinuousBatchingEngine, Request


class ModelServer:
    """Slot-synchronous batched decode over a config (the smoke config of
    ``arch`` unless ``config`` names another).  ``params``: a parameter
    dict to serve (e.g. carried from JAX by `convert.params_from_jax`);
    by default random from ``seed``.  Runs on the card unless ``device``
    asks for the CPU."""

    def __init__(self, arch: str, n_slots: int, max_len: int = 128,
                 seed: int = 0, *, config=None, params=None, device=None):
        self.device = resolve_device(device, "ModelServer")
        self.cfg = config if config is not None else get_smoke_config(arch)
        self.n_slots = n_slots
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, device=self.device)
        self.params = params
        self.caches = init_caches(self.cfg, n_slots, max_len, torch.float32,
                                  device=self.device)
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.positions = np.zeros((n_slots, 1), np.int32)
        self.row_pos = np.zeros((n_slots,), np.int32)

    def _decode(self):
        dev = self.device
        logits, self.caches = decode_step(
            self.params, self.cfg, torch.as_tensor(self.tokens, device=dev),
            torch.as_tensor(self.positions, device=dev), self.caches)
        return logits

    def prefill_request(self, req: Request):
        """Row prefill: replay the prompt through full-batch decode steps,
        as the reference does (row-isolated caches make per-row prefill
        exact; batching prefills is a feature the reference's server
        lacks)."""
        slot = req.slot
        for i, tok in enumerate(req.prompt):
            self.tokens[slot, 0] = tok
            self.positions[slot, 0] = i
            logits = self._decode()
        self.row_pos[slot] = len(req.prompt)
        req._last_logits = logits[slot].cpu().numpy()

    def step_fn(self, active_reqs):
        for r in active_reqs:
            slot = r.slot
            self.tokens[slot, 0] = (r.out_tokens[-1] if r.out_tokens
                                    else r.prompt[-1])
            self.positions[slot, 0] = self.row_pos[slot]
            self.row_pos[slot] += 1
        logits = self._decode().cpu().numpy()
        return logits[[r.slot for r in active_reqs]]


def main(argv=None, *, params=None):
    """The reference's driver, plus ``--device`` (default: the card).
    ``params``: serve these parameters instead of random ones (a test
    carries JAX's across).  Returns the engine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)

    server = ModelServer(args.arch, args.slots, params=params,
                         device=args.device)
    engine = ContinuousBatchingEngine(
        server.step_fn, server.prefill_request, args.slots,
        device=server.device)

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i, prompt=list(rng.integers(1, server.cfg.vocab,
                                                args.prompt_len)),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    engine.submit_batch(reqs)
    print(f"[serve] {args.requests} requests, {args.slots} slots, "
          f"queue_depth={engine.telemetry()['queue_depth']}")

    t0 = time.time()
    steps = 0
    while engine.stats.finished < args.requests and steps < 10_000:
        engine.step(lambda lg: lg.argmax(-1))
        steps += 1
    dt = time.time() - t0
    tel = engine.telemetry()
    tok = sum(len(r.out_tokens) for r in reqs)
    order_ok = all(
        reqs[i].admit_t <= reqs[j].admit_t + 1e-6
        for i in range(len(reqs)) for j in range(i + 1, len(reqs))
    )
    st = tel["stats"]
    seen = st["backlog_skipped"] + st["backlog_scans"]
    print(f"[serve] finished={engine.stats.finished} steps={steps} "
          f"tokens={tok} ({tok / dt:.1f} tok/s) fcfs={order_ok}")
    print(f"[serve] TWA scheduler: re-examined={st['backlog_scans']} "
          f"skipped={st['backlog_skipped']} "
          f"(skip ratio {st['backlog_skipped'] / max(1, seen):.2f})")
    return engine


if __name__ == "__main__":
    main()
