"""End-to-end training driver — the port of ``repro.launch.train`` on one
device:

    data: SyntheticLM → DataLoader (TWA bounded buffer, FIFO, deterministic)
    model: any --arch config (--smoke for the reduced one)
    step: parallel.steps.make_train_step (accumulation, remat)
    checkpointing: async sharded writes, TWA writer-slot admission,
        atomic publish, resume
    control plane: Coordinator heartbeats + loader telemetry + a SIGTERM
        emergency checkpoint at the end of the step it lands in
        (preemption-safe)

Usage:
    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
    python -m repro_torch.launch.train --smoke --device cpu --steps 14
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \\
        --steps 20 --resume --ckpt-dir /tmp/ck

It takes the reference's flags, plus ``--device`` (the card unless it
says otherwise; without CUDA and without ``--device cpu`` it raises) and
``--total-steps`` (the learning-rate schedule's horizon, ``--steps`` by
default: a run cut at step n and resumed to N with ``--total-steps N``
follows one straight run to N).  Weights are random from ``--seed``
(torch's generator, not JAX's).  ``main`` returns the losses of the steps
it ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import ShapeSpec, get_config, get_smoke_config
from ..data.pipeline import DataLoader, SyntheticLM
from ..device import resolve_device
from ..optim.adamw import AdamWConfig
from ..parallel import steps as steps_lib
from ..runtime.coordinator import Coordinator


def frontend_batch(cfg, batch: dict) -> dict:
    """The loader's token batch as the config's frontend takes it (the
    reference's stubs): zero patch embeddings before the tokens, their
    labels 0, for vision; token-valued frames in channel 0 for audio."""
    B, S = batch["tokens"].shape
    if cfg.frontend == "vision":
        batch["patch_embeds"] = np.zeros((B, cfg.n_patches, cfg.d_model),
                                         np.float32)
        batch["labels"] = np.concatenate(
            [np.zeros((B, cfg.n_patches), np.int32), batch["labels"]], axis=1)
    elif cfg.frontend == "audio":
        emb = np.zeros((B, S, cfg.d_model), np.float32)
        emb[..., 0] = batch["tokens"]  # token-dependent frames (stub)
        batch = {"frame_embeds": emb, "labels": batch["labels"]}
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="the schedule's horizon (default: --steps)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--units", type=int, default=0,
                    help="keep this many of the config's repeated units "
                         "(a depth cut; 0 keeps them all)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "launch.train")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.units:
        cfg = dataclasses.replace(cfg, num_units=args.units)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    sc = steps_lib.default_step_config(cfg, shape, dp=1,
                                       param_dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.total_steps or args.steps)

    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params≈{cfg.param_count() / 1e6:.1f}M accum={sc.accum_steps} "
          f"device={device}")

    coord = Coordinator()
    coord.join(0)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = steps_lib.make_train_state(gen, cfg, sc, device)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            state, start_step = ckpt.restore(state)
            print(f"[train] resumed from step {start_step}")

    # preemption safety: SIGTERM → synchronous emergency checkpoint.  The
    # update writes the parameters and moments in place, so the handler
    # only raises a flag and the save happens between steps, where the
    # state is one whole step's (the reference's immutable state can be
    # saved at any instant).
    term = []
    if ckpt is not None:
        def _on_term(signum, frame):
            print("[train] SIGTERM — emergency checkpoint at the step's end")
            term.append(signum)

        prev_term = signal.signal(signal.SIGTERM, _on_term)

    def _exit_if_terminated(step, state):
        if term:
            ckpt.save_sync(step, state)
            raise SystemExit(143)

    source = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed)
    loader = DataLoader(source, args.batch, n_workers=2, depth=4,
                        start_step=start_step)
    step_fn = steps_lib.make_train_step(cfg, shape, sc, opt_cfg)

    losses = []
    it = iter(loader)
    try:
        for step in range(start_step, args.steps):
            _exit_if_terminated(step, state)
            t0 = time.time()
            batch = frontend_batch(cfg, next(it))
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            dt = time.time() - t0
            coord.heartbeat(0, step, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                tel = loader.telemetry()
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={dt:.2f}s input_ready={tel['items_ready']}")
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
        if ckpt is not None:
            _exit_if_terminated(max(start_step, args.steps), state)
            ckpt.save(args.steps, state, blocking=True)
            ckpt.wait()
    finally:
        loader.stop()
        if ckpt is not None:  # the handler must not outlive this run
            signal.signal(signal.SIGTERM, prev_term or signal.SIG_DFL)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"[train] done. loss {first:.3f} → {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
