#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env           the card, its power limit, torch / CUDA / nvcc versions;
  build         the kernels' seven sources compiled from
                ``src/repro_torch/csrc`` by one ``nvcc`` each, started
                together, into ``build/kernels/``;
  flash_sm90_ptxas  the bf16 flash wgmma kernel's ``ptxas`` report
                (registers a thread, spills, shared memory) per head
                width;
  kernel_check  each kernel against its plain PyTorch version on the card:
                ``qos_round_fused`` bit-exact (T=256, max_units=256; N=4096
                rows with 3 and 16 tenants, and 3 tenants at each backlog
                length the serve phase gives the kernel; general, 2³²
                wrap, all-dead and zero-free cases; each also through
                ``ops.qos_round`` with device scalars at N−3 rows; as
                the host ``step()`` calls it, an all-alive live backlog of
                1000 and 37 rows with ``now`` and ``free`` as Python
                numbers; the K=32 scan);
                ``paged_decode`` within atol = rtol = 2e-5 in f32, each
                call twice, at the up-front path's shape, at qwen2-0.5b's
                attention shape, at the chunked path's (the 4096-block
                pool all live), at G=16 with hd=1024 and at hd=18, BS=4;
                ``paged_prefill`` at the chunked slice's shape (S=256,
                CT=64, H=KV=1, hd=896, BS=16, MB=72) and at qwen2-0.5b's
                attention shape (H=14, KV=2, hd=64), with ragged mid-block
                offsets and idle slots (4 key runs of 288, the split-K
                merge): pools bit-equal (int32 views),
                blocks off the chunk rows untouched, outputs within 2e-5;
                ``sema_batch`` bit-exact at N=1000 and 4096 (T=256,
                tickets across 2³², post_n 0, 3 and T+5; the scalars as
                device carriers, and as submit_batch passes them: ticket
                and grant carriers, post_n and salt ints);
                ``decode_attention`` within 2e-5 at every shape a main
                path gives it: serve_model's (B=8, C=256, H=14, KV=2,
                hd=64; full, windowed, a rolling ring), prefill_model's
                (B=4, C=259: a ragged last split) and the dense-ring
                demo's (B=64, C=256, H=KV=1, hd=896, a rolling ring),
                and over a long cache (C=2048: B=8 with a window, 8
                splits; B=1, 64 splits), where whole splits are masked;
                ``flash_attention`` (causal) within 2e-5 at B=4, H=14,
                KV=2, hd=64: S=512 with and without a window, and
                prefill_model's S=256 and S=259 (a ragged last tile);
                and at hd=256, G=4 (H=4, KV=1; S=512, with and without a
                window); at the other block kinds' heads (granite-moe
                H=24, KV=8, hd=64 and deepseek-moe 16, 16, 128 at B=4,
                S=256 and 259; recurrentgemma 16, 1, 256 at B=1, S=2304
                and 2307 with its 2048 window), and ``decode_attention``
                at the same heads over serve_model's 256-row cache and a
                2048-row ring with a binding 2048 window (B=8; B=1 for
                recurrentgemma's prefill phase);
  two_streams   the three split-K kernels (decode attention, paged
                prefill, paged decode) launched 8 times on each of two
                streams in turns, on different inputs: every output within
                2e-5 of the plain version, each stream with its own
                arrival counters;
  qos_large     the QoS kernel's large path (past one CTA's 16384 rows
                or 256 tenants: the rows presorted by torch, then the
                large kernel) bit-exact to the plain round at 65536 rows ×
                1024 tenants (T=256, max_units=256) and at 16385 × 3 and
                4096 × 257, in the general, 2³²-wrap, all-dead and
                zero-free cases, through ``ops.qos_round`` with device
                scalars and over the K=32 scan; its wrapper and kernel ms,
                launches a call, host µs and bound at the big shape; then
                an engine past both limits (1024 tenants 4:2:1 in turn,
                ``backlog_cap`` 32768, 256 slots, the rid step function)
                takes a burst of 20000 requests through 4 ``megastep(32)``
                and 32 host ``step()``s, every call's QoS state, free
                units, stats and request rounds bit-equal to the same
                engine on the CPU (run meanwhile in a process of its own,
                ``--qos-large-cpu``), one large-path launch a round;
  serve_small   the up-front engine on the card against the same engine on
                the CPU (plain versions) on a small trace: streams and
                samples equal;
  serve_small_chunked  the same for the chunked engine with the prefix
                cache and the paged-pool model;
  serve_model_small  the single-tenant serving driver
                (`repro_torch.launch.serve.main`, qwen2-0.5b smoke config)
                on the card against the same driver and weights on the
                CPU: token streams, tickets and samples equal;
  serve         the up-front path: `ContinuousBatchingEngine.megastep(32)`
                at qwen2-0.5b's full width (d=896, vocab=151936), 256
                slots, a 2048×16 block pool that the worst-case demand
                oversubscribes (the block gate must stall), ~1000 requests
                of three tenants, until every request is finished or
                expired;
  serve_chunked the chunked path at the same width: 256 slots,
                ``kv_pool=(4096, 16, 72)``, ``prompt_cap=1024``,
                ``chunked_prefill=(64, 1024, 6144)``, ``prefix_cache=8192``,
                400 requests (a tenant system prompt of 256 tokens plus a
                16–768-token suffix, ~5% exact repeats), megastep(32) with
                `make_chunked_prefill_token_fn(64)`, until every request
                is resolved; slots must park, prefixes hit in full, blocks
                copy on write;
                each round of both serve phases runs under
                ``torch.cuda.set_sync_debug_mode("error")``;
  serve_model   the single-tenant path: `launch.serve.ModelServer` over the
                full qwen2-0.5b config (24 layers, d=896, 14/2 heads,
                hd=64, d_ff=4864, vocab=151936, f32, random weights from
                the seed), 8 slots, max_len=256, the engine with
                ``use_kernel=True``; 32 requests (prompts 16–64 tokens,
                max_new 16–64) in two ``submit_batch`` waves, the second
                after 8 steps, served by ``step()`` to completion;
  prefill_model the full config's ``prefill`` (flash kernel) on B=4 × S=256,
                then 3 ``decode_step``s (decode kernel), each held to a
                fresh prefill over the longer prefix (2e-3);
  serve_dense_ring  the dense-ring demo model (per-slot ring caches at
                qwen2-0.5b width, hd=896) in a QoS ``megastep(32)`` until
                every request resolves: one host sync per megastep;
  serve_step    the multi-tenant host ``step()`` at the serve phase's
                configuration (256 slots, the 2048×16 pool, tenants 4:2:1,
                1000 requests, a quarter with deadlines on the 0.25 grid,
                ``use_kernel=True``) with the rid step function, against
                ``megastep(32)`` of a second engine over the paged-pool
                model emitting the rid tokens, on one virtual clock until
                every request resolves: streams, rounds, the QoS state,
                the free pool, the block-semaphore mirror, every sample
                with its events and the trace spans bit-equal; host syncs
                one a step and one a megastep; the QoS kernel launched
                exactly once by every step with a live backlog;
  serve_step_chunked  the same at the serve_chunked configuration (chunked
                prefill, prefix sharing, its 400-request trace): slots
                park, prefixes hit, blocks copy on write, and the host
                replica equals the device pool after the run (refcounts,
                table, free queue);
  serve_model_qos  the host ``step()`` of a QoS engine (tenants 4:2:1,
                ``use_kernel=True``) over `launch.serve.ModelServer` at the
                full qwen2-0.5b config, 8 slots, 16 requests (a quarter
                with deadlines), against the same trace through a CPU
                engine with the rid step function: admission and finish
                rounds, slots and samples equal, every logit finite;
  serve_resilient  the serve_step_chunked configuration without the
                prefix cache (under sharing the reference's two drives
                disagree on a counter leak: ROADMAP queue 3), a watchdog,
                one seeded `FaultPlan` of 8 capacity faults (dropped pokes,
                counter leaks, stuck slots) in the first 200 rounds, the
                ladder reacting every 4 rounds: a host-``step()``
                `ResilientEngine` with the rid step function against a
                megastep one (a call a reaction window) over the
                paged-pool model emitting the rid tokens, on one virtual
                clock, until both drain: the
                streams, retries and rounds, every sample (health under
                the mirrored mask), the stats, the QoS state, the free
                pool and the ladder's (round, action) list bit-equal; both
                exit audits clean; at least one quarantine and one
                ``audit_kv``; no kernel fallback; one QoS launch a host
                step with a live backlog;
  recover_megastep  rung 4 at the serve_step configuration by megastep
                over the paged-pool model, snapshots of the ~0.8 GB device
                tree every 64 rounds into a temporary directory (removed
                at the end): a capacity plan plus a CRASH converges to the
                uncrashed run (streams, admit and expiry rounds,
                ``qos.grant``, finished); DOUBLE_RELEASE, BIT_FLIP and
                KV_COUNTER(+) audited, then NAN_LOGIT restored, drain
                with a clean exit audit and health 0 at the end; a torn
                newest snapshot and a CRASH fall back to the snapshot
                before it in one megastep over the run; save and restore
                ms, rounds and the ladder's counts per run;
  cluster_parity  the router's chaos scenario of the CPU tests (4 toy
                replicas under ``FaultPlan.cluster(seed, rounds=8)``,
                standby and snapshots, 10 requests) at seeds 0, 5 and 866,
                every replica engine on the card (the QoS kernel each
                round) and on the CPU: streams, shed reasons, stats,
                events, the reaper's actions, lease and engine audits and
                spans per request bit-equal; at 866 both deliver rid 5
                with the reference's 3 tokens (ROADMAP queue 3);
  serve_cluster  four replicas on one card behind `ReplicaRouter`, each
                serve_resilient's configuration (chunked prefill, tenants
                4:2:1, ``use_kernel=True``) cut to 64 slots and a
                1024×16 pool at qwen2-0.5b's width, sharing one set of
                weights and the rid-emitting paged token function; 150
                requests of the serve_chunked trace, fault-free and then
                under one seeded cluster plan (a replica killed
                mid-megastep, a straggler, a KV partition, a leaked lease
                ticket) with a standby factory and snapshots every 96
                rounds, each replica its own checkpoint directory and a
                lease of 32, reactions once a router round: exactly
                once (done ∪ shed = every rid, reasons ``deadline`` or
                ``retry_budget``), the leak reaped, clean lease and engine
                audits, one host sync a replica megastep, the three
                kernels launched, every delivered stream equal to the
                fault-free run's except requests a successor adopted from
                a replica still running (each printed on a line of its
                own); ms a router round and a replica megastep, wrapper
                launches a router round, snapshot save and takeover
                restore ms, rounds from kill to detection, the migration
                latency's p50 and p99, delivered requests a wall second
                and the device's busy share over one profiled replica
                megastep;
  serve_model_moe, serve_model_moe_shared, serve_model_hybrid,
  serve_model_xlstm  serve_model's driver and traffic (8 slots,
                ``max_len`` 256, two ``submit_batch`` waves; its first 16
                requests of 32) over the other block kinds at full width, random
                weights from the seed: granite-moe-3b-a800m cut to 8 of
                its 32 MoE layers (40 experts padded to 48, top-8); deepseek-
                moe-16b cut to its dense prefix block and 2 of its 27 MoE
                units (shared experts); recurrentgemma-9b (RG-LRU units
                with a 2048-window MQA block, hd=256, and 2 RG-LRU suffix
                blocks); xlstm-350m cut to 2 of its 12 (mLSTM, sLSTM)
                units (no attention).  Each prints layers, parameters,
                peak memory,
                tokens/s, ms a decode call, launches a decode step with
                its top kernels, the kernels' launches and, for MoE,
                ``overflow_frac`` per decode call; one decode step runs
                under ``set_sync_debug_mode("error")``;
  prefill_moe, prefill_moe_shared, prefill_hybrid, prefill_xlstm
                prefill_model's check on the same four configurations
                (MoE at ``capacity_factor=16``: capacity depends on the
                batch by design): B=4 × S=256, recurrentgemma B=1 ×
                S=2304 (its window binds in the flash kernel, in the ring
                write and in decode over a full ring); each configuration
                is freed before the next;
  train_model   the port's trainer (`repro_torch.launch.train.main`) over
                qwen2-0.5b at full width cut to 2 of its 24 layers
                (``--units 2``), f32, B=8 × S=128 (the
                trainer's defaults), random weights and `SyntheticLM`
                data from the seed: 12 steps checkpointing every 6 into a
                temporary directory, a resume to step 16 and a straight
                run to 16 (the schedule's horizon 16 in all three); the
                losses finite, the step-0 loss within 0.5 of ln 151936,
                the resume running only its 4 steps, the resumed and the
                first run's losses within 1e-4 of the straight run's, no
                kernel of the port launched (training uses the plain
                attention, as the reference does); then 2 + 6 timed
                steps of the same train step and one profiled: ms a step
                (median), tokens/s, peak memory, launches a step, the
                device's busy share, ``grad_norm``, beside the step's
                bound (its f32 operations, recomputation not counted);
                the step's parts timed alone (the loss forward, forward
                and backward under the trainer's remat policy and under
                ``none``, the AdamW update); and the peak memory of one
                forward and backward over a B=1 × S=4096 sequence with
                KV blocks of 1024 (each checkpointed) and with one block
                of 4096, the first required to be the smaller;
  train_moe     the train step over granite-moe-3b-a800m at full width cut
                to 8 of its 32 MoE layers, B=4 × S=128 from the
                TWA-buffered loader, 4 steps: ms a step, peak memory,
                ``lb_loss``, ``router_z`` and ``overflow_frac`` a step,
                every number finite;
  train_parity  one train step of eight smoke configs (qwen2-0.5b,
                gemma3-1b, granite-moe-3b-a800m, deepseek-moe-16b,
                recurrentgemma-9b, xlstm-350m, internvl2-1b,
                musicgen-medium) on the card against the CPU from the same
                parameters and batch, TF32 off: loss and ``grad_norm``
                within 1e-4 relative, the gradients within 1e-4 of each
                leaf's largest magnitude, every updated weight as
                `train_parity` states;
  collective_probe  which collectives gloo runs on CUDA tensors with four
                ranks on the card (all_reduce SUM, MAX and int32,
                broadcast, all_gather_into_tensor, reduce_scatter_tensor,
                all_to_all_single, and DTensor's Shard→Replicate,
                Partial→Replicate and Partial→Shard), a CPU all-reduce as
                the control, and NCCL's answer to two ranks on one card;
  train_mesh    the meshed trainer (`parallel.steps` under a DeviceMesh)
                rehearsed by four ranks on the one card over gloo, every
                time a one-card rehearsal and not a multi-card speed:
                qwen2-0.5b at full width, f32, TF32 off, B=8 × S=128,
                A=2 — 3 steps on (data 2, model 2) with FSDP held to the
                single-device step from the same state (loss and
                ``grad_norm`` within 1e-4 relative), 2 compressed steps on
                (pod 2, data 1, model 2) (the first loss within 1e-4, the
                second within 1e-3), and an elastic dp 4 → 2 → 4 resize
                (model 1; the model cut to 2 of its 24 layers) through
                checkpoints in a temporary directory (a restore onto the
                same mesh bit-equal, the resized steps within 1e-5); ms a
                step per mesh, the bytes a rank receives a step in the
                FSDP all-gather, the gradient reduce-scatter and the
                all-reduce of unsharded leaves (from the specs), peak
                memory per rank and the port's kernel
                launches a step (none: training takes the plain
                attention).  Where gloo lacks what DTensor needs on CUDA
                tensors (branch (c)) it runs the meshed step on a one-rank
                CUDA mesh (the model cut to 2 of its 24 layers) against
                the single-device step and
                ``compress_psum`` on CUDA tensors against the CPU's, bit
                for bit;
  serve_mesh    the meshed serve steps' kernels on the card, qwen2-0.5b
                as published (24 layers, d=896, H=14, KV=2, hd=64,
                vocab=151936, f32, TF32 off, random weights from the
                seed): ``decode_attention``'s log-sum-exp output
                (``return_lse``) within 2e-5 of the plain version at
                serve_model's shape, over a 2048-row cache in 8 and in 64
                splits, and on a shard that sees no key (lse −inf, out
                0), its output bit-equal to the default call's; decode
                over decode_32k's context — a 32768-slot ring for B=16
                rows (the reference cell's batch 128 cut) filled from the
                seed, every position valid, ~12.9 GB — layer 0's
                attention whole, in 4 sequence runs merged by
                ``lse_merge`` and plain within 2e-5, then 8 decode steps
                and one profiled run twice, on the whole cache and on the
                cache split into the 4 runs the ranks of model = 4 hold
                (`models.cache.split_cache`): logits within 2e-3, ms a
                step, launches a step and ``decode_attention`` launches
                (one a layer whole, four split); prefill at prefill_32k's
                length (B=1 × S=32768): the flash kernel on four runs of
                the heads (4, 4, 3, 3, each with the KV heads it uses),
                concatenated, and the plain version within 2e-5 of the
                whole call, and the prefill's write into a 32768-slot ring
                in 4 runs bit-equal to the single-device write; and
                ``make_prefill_step`` / ``make_decode_step`` on a
                one-rank CUDA mesh (DTensor parameters and caches)
                against the same steps on one device (B=2, a prefill of
                1024 into 2048-slot rings, 8 decode steps) within 2e-5,
                the same kernel launches.  The main path's launches: the
                decode steps' and the meshed steps';
  serve_bf16    the reference's production dtype: qwen2-0.5b as published
                at the default ``StepConfig`` (bf16 parameters from
                ``init_params(gen, cfg, StepConfig().param_dtype)``, bf16
                caches, TF32 off, random weights from the seed), after
                serve_mesh's memory is freed: the bf16 flash and decode
                kernels against their plain versions in bf16 at every
                shape of kernel_check and block_kind_kernel_check, with
                their windows, decode also with ``return_lse`` (f32
                partials and log-sum-exps), within 2 bf16 ulps of each
                output row's largest magnitude and 2⁻⁷ (atol = rtol),
                the log-sum-exp within 1e-5, with the share of outputs
                bit-equal and the error in row ulps; decode_32k at its
                published batch — a bf16 ring of C=32768 slots for B=128
                rows filled from the seed, every position valid, 51.5 GB
                — layer 0's attention whole, in 4 sequence runs merged
                by ``lse_merge`` and plain (each within those limits),
                then 8
                steps of ``make_decode_step(cfg, SHAPES["decode_32k"])``:
                ms a step beside its bound (the KV bytes at 3.35 TB/s),
                launches a step, one bf16 decode launch a layer, the
                layer's kernel ms beside its bound and stacked bf16
                SDPA's; flash at B=1 × S=32768 against its plain version,
                its ms beside its bf16 bound (989 TFLOP/s) and causal
                bf16 SDPA's, then ``make_prefill_step`` at B=1 × S=32768
                (prefill_32k's batch 32 cut to 1) into an empty
                32768-slot bf16 ring, twice; prefill_model's check in
                bf16 (B=4 × S=256, 3 decode steps, each within 5e-2 ×
                max |logit| of a fresh prefill); every bf16 flash call
                of these on the wgmma route (``flash_routes``, asserted);
                then the flash kernel's sweep at qwen2-0.5b's heads, B=1
                × S ∈ {4096, 8192, 16384, 32768} causal: its ms beside
                the bound, causal bf16 SDPA's and the mma.sync kernel's
                it replaced, the two kernels within 2 bf16 ulps of each
                other and, up to S=16384, of the plain version.  The
                main path's launches: the decode steps', the prefill
                steps' and the check's, each counted from 0;
  serve_bf16_kinds  the other block kinds at the default ``StepConfig``:
                granite-moe-3b-a800m (8 of 32 layers), deepseek-moe-16b
                (its dense block and 2 of 27 MoE units), recurrentgemma-9b
                (all 12 units and its 2 RG-LRU suffix blocks) and
                xlstm-350m (2 of 12 units) at full width — the f32
                block-kind phases' cuts — with bf16 parameters from
                ``init_params(gen, cfg, StepConfig().param_dtype)`` and
                bf16 caches, each freed before the next: prefill_model's
                check in bf16 (B=4 × S=256; recurrentgemma B=1 × S=2304,
                so its 2048 window binds; MoE at capacity factor 16), 3
                decode steps each within 5e-2 × max |logit| of a fresh
                prefill, a MoE model's fresh prefills routed as its
                prefill and decode steps routed (the expert picks that
                flip at near-ties of the f32 router counted, with their
                margins beside the typical one); ms a decode step,
                launches and device ms of one more profiled step, the
                bf16 kernels' launches (a kind with attention that
                launches neither, or an f32 one, fails; a bf16 flash
                call off the wgmma route fails); then both bf16
                kernels at those kinds' attention shapes (recurrentgemma's
                decode at hd 256, G=16 on the CUDA-core form) against
                their plain versions, their ms beside the bound at the
                bf16 rates and bf16 SDPA's (flash also beside the mma.sync
                kernel's, its route asserted), and each bf16 wrapper's
                host µs a call.  The main path's launches: each kind's check,
                counted from 0;
  train_bf16    the mixed-precision train step at ``default_step_config``'s
                bf16 (bf16 working parameters, the f32 master and moments
                in ``OptState``): train_model's configuration (qwen2-0.5b
                at full width cut to 2 of 24 layers, B=8 × S=128), 6
                steps (the last 4 timed) and one profiled: ms a step
                beside train_model's f32 step and the bf16 bound (989
                TFLOP/s), launches, peak memory, busy share; then one bf16
                step of each of train_parity's eight smoke configs on the
                card against the CPU (loss within 3.7e-3 and
                ``grad_norm`` within 3e-2 relative, the first moment
                within 0.34 relative L2, every master element within 2 lr,
                at most 2.7% of them more than lr/2 apart: twice JAX's own
                bf16-against-f32 gaps on those configs);
  dryrun        the port's dry run (`repro_torch.launch.dryrun`) of
                qwen2-0.5b's train_4k, prefill_32k and decode_32k cells on
                the production pod mesh (a fake process group of 256
                ranks, fake tensors, the script's own torch) in both modes,
                and of recurrentgemma-9b's train_4k analysis cell (its
                RG-LRU gate products on local shards), one line a cell
                (per-device FLOPs and projected bytes, T_comp, T_mem,
                T_coll by axis, the bottleneck, the seconds); the cells
                are made on the CPU by a process
                started after the build (``--dryrun-cells PATH``) that
                runs beside the card's phases, and collected here: a cell
                that failed fails the run.  Then the same tools' count of
                two one-card cells, f32 priced at the f32 rate, against
                this run's own measurements — serve_mesh's whole decode
                step (B=16, C=32768) and train_model's step (B=8 × S=128)
                — each ratio printed, none a gate; and a bf16 matmul of
                8192³ and a 4 GB device-to-device copy timed with CUDA
                events beside the datasheet rates the roofline prices
                with (library calls that check the constants).  The dry
                run launches no kernel;
  profile, profile_chunked  one megastep of each path under
                ``torch.profiler``: device busy share, launches per round,
                the top kernels (and the chunk plan's launches, and the
                live tokens of the chunked round's paged decode calls);
  kernels       per kernel: launches on the main paths, max error against
                the plain version on the timed inputs, time at the main
                path's shapes beside the plain version's, the bound and a
                library call's time, and the wrapper's host time per call
                (200 calls enqueued, no synchronise) split into checks,
                allocation, stream lookup and the ``ctypes`` call; the
                QoS row times ``ops.qos_round`` as the engine calls it
                and counts its CUDA launches a call, as the ``sema_batch``
                row does; the paged-decode row is timed at the up-front
                and (``at_chunked_shape``) the chunked paths' shapes;
                the flash and decode rows add their times, bounds and
                SDPA's at the other block kinds' shapes
                (``at_block_kind_shapes``), and at the meshed steps' long
                shapes (``at_decode_32k``: SDPA with each KV head's query
                heads stacked as rows; ``at_prefill_32k``: causal SDPA);
                the bf16 rows (``flash_attention_bf16``,
                ``decode_attention_bf16``) come from serve_bf16's
                measurements at its main path's shapes, with
                serve_bf16_kinds' at the block kinds' shapes and their
                host µs a call;
  total         the run's seconds (every phase line above carries its
                own).

Then the ``nvidia-smi`` name and power-limit line, the ``kernels`` JSON
line, and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA (or without the repository beside
this file) it exits non-zero and prints no result.

    python3 chip_smoke.py --ab-attention PARENT

times the six redesigned kernels (paged decode at both megastep paths'
shapes, ``sema_batch``, the QoS round and paged prefill as their
wrappers are called on the main paths, flash and decode attention) and
the rounds of the three megastep paths, of the source tree at PARENT
(for example ``git archive`` of an earlier commit unpacked under
``build/``) and of this tree in turns on the card (parent, this, this,
parent), and prints one JSON line.

    python3 chip_smoke.py --train-remat

times train_model's step parts under all four remat policies (none,
full, dots, 2level) and prints them as one JSON line.

    python3 chip_smoke.py --train-mesh

runs the train_mesh phase (with its probe) alone.

    python3 chip_smoke.py --train-mesh-cards

runs the meshed trainer on a machine with four cards, one rank a card
over NCCL (train_mesh's ranks and checks; the time of a step is then a
four-card one), then trains recurrentgemma-9b at full width cut to one
unit (rglru, rglru, attention window 2048) and xlstm-350m whole, 2
steps each on (data 2, model 2) with FSDP (B=8 × S=128, A=2, f32, TF32
off), each loss and ``grad_norm`` within 1e-5 relative of rank 0's
single-device steps; and qwen2-0.5b's (data 2, model 2) FSDP steps at
``StepConfig``'s bf16 (bf16 parameters, the f32 master) against rank 0's
single-device bf16 steps, at train_parity's bf16 limits.

    python3 chip_smoke.py --serve-mesh

builds the kernels and runs the serve_mesh phase alone.

    python3 chip_smoke.py --serve-bf16
    python3 chip_smoke.py --serve-bf16-kinds
    python3 chip_smoke.py --train-bf16

build the kernels and run the serve_bf16, serve_bf16_kinds or
train_bf16 phase alone (train_bf16 then has no f32 step beside it).

    python3 chip_smoke.py --flash-sweep

builds the two flash sources only and runs the bf16 flash kernel's sweep
and its rows at the block kinds' shapes (serve_bf16_kinds' last part).

    python3 chip_smoke.py --serve-mesh-cards

runs the meshed serve steps on a machine with four cards, one rank a
card over NCCL: the full qwen2-0.5b on (data 2, model 2) at B=4 (the
sequence over model) and on (data 1, model 4) at B=1, a prefill of 1024
tokens into 2048-slot rings and 8 decode steps, every rank's logits
within 2e-3 of rank 0's single-device steps; then the same at
``StepConfig``'s bf16 (bf16 parameters and caches), within 5e-2 × max
|logit|, the bf16 kernels launched on each rank's shard and no f32
one; ms a step per rank.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense
SEED = 0
TENANTS = ("gold", "silver", "bronze")
# the serve phase: slots, requests, kv pool (NB, BS, MB), longest request
# (prompt_cap 128 + max_new 128 tokens); 256 slots × 16 blocks worst case
# against 2048 blocks, so the block gate binds
SERVE_SLOTS, SERVE_REQUESTS = 256, 1000
SERVE_POOL = (2048, 16, 32)
SERVE_MAX_LEN = 256
# the serve_chunked phase: continuous chunked prefill with prefix sharing.
# Each prompt is its tenant's 256-token system prompt plus a 16–768-token
# suffix (prompt_cap 1024 = 64 blocks; + max_new 128 → the 72-block
# table); ~5% repeat an earlier prompt of the same tenant token for token.
# The commitment watermark (6144 blocks) sits above the 4096-block pool,
# so admission oversubscribes it and slots park.
CHUNK_SLOTS, CHUNK_REQUESTS = 256, 400
CHUNK_POOL = (4096, 16, 72)
CHUNK_PROMPT_CAP = 1024
CHUNKED = (64, 1024, 6144)        # chunk tokens, token budget, commit
PREFIX_ENTRIES = 8192
SYSTEM_PROMPT = 256
WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
# the serve_model phase: the single-tenant driver over the full config
MODEL_SLOTS, MODEL_MAX_LEN, MODEL_REQUESTS = 8, 256, 32
MODEL_PROMPT, MODEL_NEW = (16, 65), (16, 65)
MODEL_WAVE2_AT = 8              # steps before the second submit_batch
# the serve_model_qos phase: the multi-tenant host step() over the full
# config (MODEL_SLOTS slots, the serve_model prompt and max_new ranges)
QOS_MODEL_REQUESTS = 16
# the prefill_model phase
PREFILL_B, PREFILL_S, PREFILL_EXTRA = 4, 256, 3
# the other block kinds' phases (serve_model's traffic; prefill_model's
# check at PREFILL_B × PREFILL_S, recurrentgemma at B=1 × S=2304 so that
# its 2048 window binds); MoE capacity depends on the batch by design, so
# the prefill checks give every expert headroom (capacity_factor 16)
DEEPSEEK_UNITS = 2             # MoE units kept of deepseek-moe-16b's 27
GRANITE_UNITS = 8              # MoE layers kept of granite-moe's 32: its
# serve phase, the run's slowest with layers, took 112–154 s whole
# serve_model's first 16 requests (of 32): a granite-moe decode call took
# 85–126 ms on an H100 (4685 launches, host-bound), so 32 requests' 1661
# calls would take 140–210 s of the run's 1200
BLOCK_KIND_REQUESTS = 16
HYBRID_UNITS = 12              # recurrentgemma-9b's units (all of them)
XLSTM_UNITS = 2                # xlstm-350m's units kept of 12 (4 layers)
HYBRID_PREFILL_B, HYBRID_PREFILL_S = 1, 2304
PREFILL_CAPACITY_FACTOR = 16.0
# the serve_dense_ring phase: per-slot ring caches at qwen2-0.5b width
RING_SLOTS, RING_CAP, RING_REQUESTS = 64, 256, 300
# the resilience phases: serve_resilient's capacity plan (seeded events in
# the first RESILIENT_FAULT_ROUNDS rounds), its watchdog and the ladder's
# reaction stride; recover_megastep's snapshot stride, its capacity plan's
# window, the crash round, and the rounds of the torn-shard run's one call
RESILIENT_SEED, RESILIENT_FAULTS, RESILIENT_FAULT_ROUNDS = 4, 8, 200
RESILIENT_WATCHDOG, REACT_EVERY = 192, 4
RECOVER_SEED, RECOVER_SNAPSHOT_EVERY, RECOVER_FAULT_ROUNDS = 6, 64, 200
RECOVER_CRASH_ROUND, RECOVER_ONE_CALL = 100, 480
# the serving fabric.  cluster_parity: the chaos seeds of the CPU tests
# (tests/test_torch_router.py CHAOS_SEEDS; 866 is the reference's red).
# serve_cluster: CLUSTER_REPLICAS replicas of serve_resilient's
# configuration cut from 256 slots to CLUSTER_SLOTS and from the 4096-block
# pool to CLUSTER_POOL (the width kept), a lease of CLUSTER_LEASE units
# each,
# CLUSTER_INNER_K engine rounds a router round of CLUSTER_DT virtual
# seconds each, reactions once a router round, a heartbeat TTL of
# CLUSTER_TTL_ROUNDS router rounds; CLUSTER_REQUESTS requests of the
# serve_chunked trace; the faulted run's plan (its kill lands before the
# first snapshot that holds device state, so the takeover fails and the
# work migrates; its partition lands after it, so a successor adopts the
# snapshot's requests), its snapshot stride, and the fault-free router
# round whose first replica megastep is profiled
CLUSTER_SEEDS = (0, 5, 866)
CLUSTER_REPLICAS, CLUSTER_SLOTS, CLUSTER_POOL = 4, 64, (1024, 16, 72)
CLUSTER_LEASE = 32
CLUSTER_REQUESTS, CLUSTER_INNER_K, CLUSTER_DT = 150, 8, 1.0
CLUSTER_TTL_ROUNDS, CLUSTER_MAX_ROUNDS = 2.5, 400
CLUSTER_PLAN_SEED, CLUSTER_PLAN_ROUNDS = 45, 32
CLUSTER_SNAPSHOT_EVERY, CLUSTER_PROFILE_AT = 96, 3
# the attention heads of the other block kinds' configurations, with
# the window and the prefill_<name> batch and length they run at
BLOCK_KIND_FLASH = (
    ("granite-moe", dict(H=24, KV=8, hd=64), 0, PREFILL_B, PREFILL_S),
    ("deepseek-moe", dict(H=16, KV=16, hd=128), 0, PREFILL_B, PREFILL_S),
    ("recurrentgemma", dict(H=16, KV=1, hd=256), 2048, HYBRID_PREFILL_B,
     HYBRID_PREFILL_S),
)
# the training phases.  train_model: qwen2-0.5b at full width with the
# trainer's default batch and sequence; a run of TRAIN_STEPS steps
# checkpointing every TRAIN_CKPT_EVERY, its resume to TRAIN_RESUME_TO and a
# straight run to TRAIN_RESUME_TO, all three with the schedule's horizon at
# TRAIN_RESUME_TO, so the resumed losses must follow the straight run's
# (within TRAIN_RESUME_TOL: the card's reductions need not repeat their
# order between processes' runs); then TRAIN_WARMUP + TRAIN_TIMED steps
# timed and one profiled.  train_moe: granite-moe-3b-a800m cut in depth to
# MOE_TRAIN_UNITS of its 32 MoE layers.  train_parity: one step of each
# smoke config on the card against the CPU.
TRAIN_B, TRAIN_S = 8, 128
TRAIN_UNITS = 2  # train_model's depth: 2 of qwen2-0.5b's 24 layers
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME_TO = 12, 6, 16
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
TRAIN_RESUME_TOL = 1e-4
LONG_S = 4096  # train_model's memory check: one B=1 sequence of 4 KV blocks
MOE_TRAIN_UNITS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 8, 4, 128, 4
PARITY_ARCHS = ("qwen2-0.5b", "gemma3-1b", "granite-moe-3b-a800m",
                "deepseek-moe-16b", "recurrentgemma-9b", "xlstm-350m",
                "internvl2-1b", "musicgen-medium")
PARITY_B, PARITY_S, PARITY_TOL = 2, 32, 1e-4
QOS_CASES = (
    ("general", dict(wrap=False, alive_density=0.8, free=200)),
    ("wrap", dict(wrap=True, alive_density=0.8, free=200)),
    ("all-dead", dict(wrap=False, alive_density=0.0, free=200)),
    ("zero-free", dict(wrap=True, alive_density=0.9, free=0)),
)
# qos_large: the QoS kernel's large path (past one CTA's 16384 rows or 256
# tenants) at its checked shapes, (tenants, rows); and the engine past both
QOS_LARGE_SHAPES = ((1024, 65536), (3, 16385), (257, 4096))
QOS_LARGE_TENANTS, QOS_LARGE_CAP, QOS_LARGE_SLOTS = 1024, 32768, 256
QOS_LARGE_REQUESTS, QOS_LARGE_MEGASTEPS, QOS_LARGE_STEPS = 20000, 4, 32


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA
    events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_split(torch, fn, calls: int = 200) -> dict:
    """Host µs per call of a kernel wrapper ``fn``: ``calls`` calls timed
    with ``time.perf_counter()`` and no synchronise inside (the enqueue),
    then the same calls again with the allocations (``torch.empty``,
    ``torch.empty_like``), the stream lookup and the ``ctypes`` launch
    call timed apart; ``checks_us`` is the rest of the instrumented call
    (the wrapper's checks and, where it has any, its torch data
    preparation).  The instrumentation adds ~0.2 µs to each timed part."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import qos_admission as qa
    from repro_torch.kernels import sema_batch as sb

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    total = time.perf_counter() - t0
    torch.cuda.synchronize()

    acc = {"alloc": 0.0, "stream": 0.0, "ctypes": 0.0}

    def timed(f, part):
        def call(*a, **kw):
            t = time.perf_counter()
            r = f(*a, **kw)
            acc[part] += time.perf_counter() - t
            return r
        return call

    class Lib:  # a loaded library whose entry points are timed
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return timed(getattr(self._lib, name), "ctypes")

    patched = [(torch, "empty", "alloc"), (torch, "empty_like", "alloc"),
               (torch.cuda, "current_stream", "stream"),
               (torch._C, "_cuda_getCurrentRawStream", "stream"),
               *((m, "_launch", "ctypes") for m in (fa, da, pd, pp, qa, sb)
                 if hasattr(m, "_launch"))]
    bound = [m for m in (pp, qa) if getattr(m, "_lib", None) is not None]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    saved += [(m, "_lib", m._lib) for m in bound]
    libs = dict(build._libs)
    try:
        for obj, name, part in patched:
            val = getattr(obj, name)
            if isinstance(val, dict):  # a wrapper's entries by dtype
                setattr(obj, name, {k: timed(f, part)
                                    for k, f in val.items()})
            elif val is not None:
                setattr(obj, name, timed(val, part))
        for m in bound:          # a wrapper that keeps its library bound
            m._lib = Lib(m._lib)
        for name, lib in libs.items():
            build._libs[name] = Lib(lib)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        inst = time.perf_counter() - t0
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)
        build._libs.update(libs)
    torch.cuda.synchronize()
    us = 1e6 / calls
    return {"host_us": total * us, "instrumented_us": inst * us,
            "checks_us": (inst - sum(acc.values())) * us,
            **{f"{k}_us": v * us for k, v in acc.items()}}


# ----------------------------------------------------------------- inputs ---


def qos_case(torch, dev, *, seed, S, N, T, wrap, alive_density, free):
    """A QoS round's inputs on the card: per-tenant consecutive tickets
    (issued by `qos_take`, optionally straddling 2³²), random dead slack,
    virtual passes, deadlines (a fifth expire), shuffled rows."""
    import numpy as np

    from repro_torch.admission import functional_qos as fq
    from repro_torch.core import u32

    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.5, 4.0, S).astype(np.float32)
    st = fq.make_qos(weights, table_size=T, device=dev)
    base = (1 << 32) - N // (2 * S) if wrap else int(rng.integers(0, 1000))
    b = u32.u32(np.full(S, base, np.int64), device=dev)
    st = st._replace(ticket=b, grant=b, consumed=b,
                     dead=torch.as_tensor(rng.integers(0, 4, S), device=dev),
                     vpass=torch.as_tensor(rng.uniform(0, 3, S)
                                           .astype(np.float32), device=dev))
    ids = torch.as_tensor(rng.integers(0, S, N).astype(np.int32), device=dev)
    st, tickets, _, _ = fq.qos_take(st, ids,
                                    torch.ones(N, dtype=torch.bool,
                                               device=dev))
    perm = torch.as_tensor(rng.permutation(N), device=dev)
    alive = torch.as_tensor(rng.random(N) < alive_density, device=dev)
    dls = np.where(rng.random(N) < 0.2, rng.uniform(-1, 1, N), np.inf)
    dls = torch.as_tensor(dls.astype(np.float32), device=dev)
    return st, ids[perm], tickets[perm], alive, dls, free


def paged_case(torch, dev, *, seed, S, H, KV, hd, NB, BS, MB, max_len=None):
    """Paged-decode inputs on the card: ragged lens up to ``max_len``
    (the full table by default; zeros included, one slot at the maximum),
    permuted pool ids, -1 past each slot's blocks."""
    import numpy as np

    max_len = MB * BS if max_len is None else max_len
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, S).astype(np.int32)
    lens[:4] = 0
    lens[-1] = max_len
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        if p + nb > NB:
            nb = NB - p
            lens[s] = nb * BS
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, H, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(lens, device=dev))


def chunked_decode_case(torch, dev, *, seed):
    """Paged-decode inputs at the chunked path's shape (S=256, H=KV=1,
    hd=896, the 4096×16 pool, 72-block tables) with the pool's blocks all
    live, as a chunked round holds them: lengths drawn exponential (mean
    256 tokens, up to the table's 1152), ~10% idle, the last slot at the
    full table, halved at random until the blocks fit the pool."""
    import numpy as np

    S, hd = CHUNK_SLOTS, 896
    NB, BS, MB = CHUNK_POOL
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.exponential(256, S), MB * BS).astype(np.int64)
    lens[rng.random(S) < 0.1] = 0
    lens[-1] = MB * BS
    while (-(-lens // BS)).sum() > NB:
        i = int(rng.integers(0, S - 1))
        lens[i] //= 2
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, 1, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, 1, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, 1, hd), generator=g, device=dev)
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(lens.astype(np.int32), device=dev))


def prefill_case(torch, dev, *, seed, S, CT, H, KV, hd, NB, BS, MB,
                 active=None, max_off=None):
    """Paged-prefill inputs on the card: chunk lengths 0..CT (a quarter of
    the slots idle, or only ``active`` slots with a token), offsets mostly
    off the block boundary up to ``max_off``, each slot's blocks
    [0, off+len) from a permutation of the pool, -1 past them.  Returns
    the kernel's arguments and the (block, row) pairs the chunk writes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    max_off = MB * BS - CT if max_off is None else max_off
    lens = rng.integers(1, CT + 1, S)
    lens[rng.random(S) < 0.25] = 0
    if active is not None:   # only the first slots carry a chunk
        lens[active:] = 0
    offs = rng.integers(0, max_off + 1, S)
    offs[::7] = (offs[::7] // BS) * BS          # some block-aligned starts
    if active is not None:
        offs[active:] = 0
    lens[0], lens[1] = 0, CT
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(offs[s] + lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    assert p <= NB, "pool too small for the case"
    rows = np.asarray([(tbl[s, (offs[s] + j) // BS], (offs[s] + j) % BS)
                       for s in range(S) for j in range(lens[s])],
                      np.int64).reshape(-1, 2)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, CT, H, hd), generator=g, device=dev)
    kc = torch.randn((S, CT, KV, hd), generator=g, device=dev)
    vc = torch.randn((S, CT, KV, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    args = (q, kc, vc, kp, vp, *(torch.as_tensor(x.astype(np.int32),
                                                 device=dev)
                                 for x in (tbl, offs, lens)))
    return args, rows


def prefill_check(torch, args, rows, name) -> float:
    """The kernel against its plain version on ``args``: pools bit-equal
    (int32 views), every pool row off the chunk rows untouched, outputs
    within 2e-5.  Returns the outputs' max |error|."""
    from repro_torch.kernels import paged_prefill as pp

    q, kc, vc, kp, vp, tbl, off, lens = args
    want, kw, vw = pp.paged_prefill_plain(*args)
    kp0, vp0 = kp.clone(), vp.clone()
    got, kg, vg = pp.paged_prefill(*args)
    torch.cuda.synchronize()
    written = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    written[torch.as_tensor(rows[:, 0], device=kp.device),
            torch.as_tensor(rows[:, 1], device=kp.device)] = True
    for a, b, old in ((kg, kw, kp0), (vg, vw, vp0)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"paged_prefill pools != plain at {name}")
        if not torch.equal(a[~written].view(torch.int32),
                           old[~written].view(torch.int32)):
            raise AssertionError(f"paged_prefill wrote off its rows: {name}")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"paged_prefill != plain at {name}: {err}")
    return err


def decode_paged_check(torch, args, name) -> float:
    """The paged-decode kernel against its plain version within 2e-5,
    twice (the second call equal to the first).  Returns the max
    |error|."""
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain

    got = paged_decode(*args)
    again = paged_decode(*args)
    want = paged_decode_plain(*args)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"paged_decode != plain at {name}: {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"paged_decode differs call to call: {name}")
    return err


def sema_case(torch, dev, *, seed, N, T, post_n):
    """``sema_batch`` inputs on the card: tickets starting 300 below 2³²
    (an N ≥ 300 batch crosses the wrap), the grant 40 ahead, random
    waiting-array sequences, ~70% requesting rows."""
    import numpy as np

    from repro_torch.core import u32

    rng = np.random.default_rng(seed)
    base = (1 << 32) - 300
    return (u32.u32(base, device=dev), u32.u32(base + 40, device=dev),
            u32.u32(rng.integers(0, 1 << 32, T), device=dev),
            torch.as_tensor(rng.random(N) < 0.7, device=dev),
            u32.u32(post_n, device=dev), u32.u32(0x9E3779B9, device=dev))


def sema_check(torch, args, name) -> float:
    """The kernel against its plain version: every output bit-equal.
    Returns the max |difference| (0)."""
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    got, want = sema_batch(*args), sema_batch_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g.reshape(-1), w.reshape(-1)):
            raise AssertionError(f"sema_batch != plain at {name}")
    return 0.0


def decode_case(torch, dev, *, seed, B, C, H, KV, hd, window=0,
                rolling=False, q_shift=0, dtype=None):
    """Decode-attention inputs on the card: positions 0..C−1 (or a ring
    rotated by 37 that holds them out of order), one row half empty,
    queries at random positions (the last one at C−1), each moved on by
    ``q_shift`` (so that a window of C masks the oldest keys); q, k and v
    drawn in f32 and cast to ``dtype`` where one is given."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    if rolling:
        pos = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
    pos[0, C // 2:] = -1
    q_pos = rng.integers(0, C, B).astype(np.int32)
    q_pos[-1] = C - 1
    q_pos += q_shift
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev)
    k = torch.randn((B, C, KV, hd), generator=g, device=dev)
    v = torch.randn((B, C, KV, hd), generator=g, device=dev)
    if dtype is not None:
        q, k, v = (t.to(dtype) for t in (q, k, v))
    return (q, k, v, torch.as_tensor(pos, device=dev),
            torch.as_tensor(q_pos, device=dev)), window


def decode_check(torch, args, window, name) -> float:
    """The kernel against its plain version within 2e-5.  Returns the max
    |error|."""
    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain

    got = decode_attention(*args, window=window)
    want = decode_attention_plain(*args, window=window)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"decode_attention != plain at {name}: {err}")
    return err


def flash_case(torch, dev, *, seed, B, S, H, KV, hd, dtype=None):
    """Flash-attention q, k, v drawn in f32 (cast to ``dtype`` where one
    is given)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(
        dtype or torch.float32) for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def flash_check(torch, args, window, name) -> float:
    """The kernel against its plain version (causal) within 2e-5.
    Returns the max |error|."""
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain

    got = flash_attention(*args, window=window)
    want = flash_attention_plain(*args, window=window)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"flash_attention != plain at {name}: {err}")
    return err


def states_equal(torch, a, b) -> bool:
    """Field-wise bit equality of two NamedTuples of tensors."""
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def qos_max_err(torch, got, want) -> float:
    """Largest |difference| over every field of two QoS round results
    ``(state', admitted, expired, leftover)``; masks count as 0/1, u32
    carriers exactly; equal infinities differ by 0, any other non-finite
    difference is inf."""
    err = 0.0
    for x, y in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        x, y = x.double(), y.double()
        d = torch.where((x == y) | (x.isnan() & y.isnan()), 0.0,
                        (x - y).abs())
        if d.numel():
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return err


def qos_exact(torch, got, want) -> bool:
    """Bit equality of two QoS round results."""
    return (states_equal(torch, got[0], want[0])
            and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])))


def chunked_requests(n_req: int, vocab: int, seed: int = SEED) -> list:
    """The serve_chunked trace as ``Request`` keyword dicts: tenant
    uniform, its system prompt plus a 16–768-token suffix, ``max_new``
    16–128, a quarter with deadlines; about 5% repeat, token for token,
    the prompt of a request of the same tenant at least 64 requests
    earlier (full covers and copy-on-write)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = {t: [int(x) for x in rng.integers(1, vocab, SYSTEM_PROMPT)]
              for t in WEIGHTS}
    out = []
    for i in range(n_req):
        tenant = TENANTS[int(rng.integers(0, 3))]
        earlier = [r for r in out[:max(i - 63, 0)]
                   if r["tenant_id"] == tenant]
        if earlier and rng.random() < 0.05:
            prompt = list(earlier[int(rng.integers(0, len(earlier)))][
                "prompt"])
        else:
            prompt = system[tenant] + [int(x) for x in rng.integers(
                1, vocab, int(rng.integers(16, 769)))]
        out.append(dict(
            rid=i, prompt=prompt, max_new_tokens=int(rng.integers(16, 129)),
            tenant_id=tenant,
            deadline=(float(rng.integers(40, 320)) if rng.random() < 0.25
                      else None)))
    return out


def backlog_rows(n_req: int, S: int, block_n: int = 256) -> list:
    """The backlog lengths the serve phase hands the QoS kernel as it
    drains: the engine's power-of-two backlog for ``max(n, S)`` rows,
    halving down to the ops wrapper's floor of ``block_n`` rows."""
    n = max(1 << (max(n_req, S) - 1).bit_length(), 8, block_n)
    rows = []
    while n >= block_n:
        rows.append(n)
        n //= 2
    return rows


# ----------------------------------------------------------------- phases ---


def kernel_check(torch, dev) -> dict:
    from repro_torch.kernels import ops, qos_admission, ref

    out = {}
    # backlog_cap rows with 3 and 16 tenants, then every backlog length the
    # serve phase gives the kernel, with its 3 tenants
    shapes = [(S, 4096) for S in (3, 16)] + [
        (3, N) for N in backlog_rows(SERVE_REQUESTS, SERVE_SLOTS)]
    for S, N in shapes:
        for case, kw in QOS_CASES:
            st, ids, tks, alive, dls, free = qos_case(
                torch, dev, seed=S + N, S=S, N=N, T=256, **kw)
            want = qos_admission.qos_round_plain(st, ids, tks, alive, dls,
                                                 0.0, free, 256)
            got = qos_admission.qos_round_fused(st, ids, tks, alive, dls,
                                                0.0, free, max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"qos_round_fused != plain: S={S} N={N} {case}")
            # as the engine calls it: device scalars, N not a power of two
            n = N - 3
            now = torch.zeros((), device=dev)
            free_t = torch.full((), free, dtype=torch.int32, device=dev)
            rows = (ids[:n], tks[:n], alive[:n], dls[:n])
            want = qos_admission.qos_round_plain(st, *rows, now, free_t,
                                                 256)
            got = ops.qos_round(st, *rows, now, free_t, max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"ops.qos_round != plain: S={S} N={n} {case}")
            out[f"qos S={S} N={N} and N={n} {case}"] = "bit-exact"
    # as the host step() calls it: the live backlog as it stands (any
    # length, all alive), `now` and `free_units` as Python numbers
    for N in (1000, 37):
        for case, kw in QOS_CASES[:2]:
            st, ids, tks, _, dls, free = qos_case(
                torch, dev, seed=N + 7, S=3, N=N, T=256, **kw)
            alive = torch.ones(N, dtype=torch.bool, device=dev)
            want = qos_admission.qos_round_plain(st, ids, tks, alive, dls,
                                                 0.0, free, 256)
            got = ops.qos_round(st, ids, tks, alive, dls, 0.0, free,
                                max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"ops.qos_round != plain as step() calls it: N={N} "
                    f"{case}")
            out[f"qos step() S=3 N={N} {case}"] = "bit-exact"
    for S in (3, 16):
        st, ids, tks, alive, dls, _ = qos_case(
            torch, dev, seed=S + 100, S=S, N=4096, T=256, wrap=True,
            alive_density=0.9, free=0)
        g = torch.Generator(device=dev).manual_seed(S)
        nows = torch.linspace(-0.5, 1.0, 32, device=dev)
        released = torch.randint(0, 9, (32,), generator=g, device=dev,
                                  dtype=torch.int32)
        free0 = torch.full((), 64, dtype=torch.int32, device=dev)
        want = ref.qos_round_scan_ref(st, ids, tks, alive, dls, nows, free0,
                                      released, 256)
        got = ops.qos_round_scan(st, ids, tks, alive, dls, nows, free0,
                                 released, max_units=256)
        if not (states_equal(torch, got[0], want["state"])
                and torch.equal(got[1], want["admit_round"])
                and torch.equal(got[2], want["expire_round"])
                and torch.equal(got[3], want["free"])):
            raise AssertionError(f"qos_round_scan != plain scan: S={S}")
        out[f"qos_scan S={S} K=32"] = "bit-exact"

    # the up-front path's shape and qwen2-0.5b's heads (32-block tables),
    # the chunked path's (the 4096-block pool all live, 72-block tables),
    # the widest group and head (G=16, hd=1024: KT=8 tiles, one CTA an
    # SM) and a head off the 16-byte copy (hd=18, BS=4); each call twice
    # (the counters left at zero give the same result)
    for name, args in (
            ("slice", paged_case(torch, dev, seed=7, S=256, NB=4096, BS=16,
                                 MB=32, H=1, KV=1, hd=896)),
            ("qwen2-0.5b-attn", paged_case(torch, dev, seed=7, S=256,
                                           NB=4096, BS=16, MB=32, H=14,
                                           KV=2, hd=64)),
            ("chunked", chunked_decode_case(torch, dev, seed=7)),
            ("G=16 hd=1024", paged_case(torch, dev, seed=8, S=40, NB=512,
                                        BS=16, MB=12, H=16, KV=1,
                                        hd=1024)),
            ("hd=18 BS=4", paged_case(torch, dev, seed=9, S=30, NB=512,
                                      BS=4, MB=20, H=3, KV=1, hd=18))):
        err = decode_paged_check(torch, args, name)
        out[f"paged_decode {name}"] = f"max_abs_err {err:.3e}"

    for name, shape in (("slice", dict(H=1, KV=1, hd=896)),
                        ("qwen2-0.5b-attn", dict(H=14, KV=2, hd=64))):
        args, rows = prefill_case(torch, dev, seed=9, S=256, CT=64, NB=16384,
                                  BS=16, MB=72, **shape)
        out[f"paged_prefill {name}"] = (
            f"max_abs_err {prefill_check(torch, args, rows, name):.3e}")

    for N in (1000, 4096):
        for post_n in (0, 3, 256 + 5):
            args = sema_case(torch, dev, seed=N + post_n, N=N, T=256,
                             post_n=post_n)
            sema_check(torch, args, f"N={N} post_n={post_n}")
            # ticket and grant carriers, post_n and salt ints
            mixed = (args[0], args[1], args[2], args[3], post_n,
                     int(args[5]))
            sema_check(torch, mixed, f"N={N} post_n={post_n} mixed")
            out[f"sema_batch N={N} post_n={post_n}"] = "bit-exact"

    for kind, name, seed, kw, window in ATTENTION_SHAPES:
        if kind == "decode":
            args, window = decode_case(torch, dev, seed=seed, **kw)
            err = decode_check(torch, args, window, name)
            out[f"decode_attention {name}"] = f"max_abs_err {err:.3e}"
        else:
            args = flash_case(torch, dev, seed=seed, **kw)
            err = flash_check(torch, args, window, name)
            out[f"flash_attention {name}"] = f"max_abs_err {err:.3e}"
    out.update(block_kind_kernel_check(torch, dev))
    return out


def qos_large_check(torch, dev) -> dict:
    """The large path against the plain round, bit-exact: T=256,
    max_units=256, at 65536 rows × 1024 tenants and at the boundaries
    16385 × 3 and 4096 × 257, in the general, 2³²-wrap, all-dead and
    zero-free cases; at the big shape also through `ops.qos_round` as the
    engine calls it (device scalars, N−3 rows) and the K=32 scan."""
    from repro_torch.kernels import ops, qos_admission, ref

    out = {}
    for S, N in QOS_LARGE_SHAPES:
        if not qos_admission.large_path(N, S):
            raise AssertionError(f"S={S} N={N} is not past one CTA")
        for case, kw in QOS_CASES:
            st, ids, tks, alive, dls, free = qos_case(
                torch, dev, seed=S + N, S=S, N=N, T=256, **kw)
            want = qos_admission.qos_round_plain(st, ids, tks, alive, dls,
                                                 0.0, free, 256)
            got = qos_admission.qos_round_fused(st, ids, tks, alive, dls,
                                                0.0, free, max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(f"large path != plain: S={S} N={N} "
                                     f"{case}")
            out[f"qos_large S={S} N={N} {case}"] = "bit-exact"
    S, N = QOS_LARGE_SHAPES[0]
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=5, S=S, N=N, T=256, wrap=True, alive_density=0.9,
        free=200)
    n = N - 3
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)
    rows = (ids[:n], tks[:n], alive[:n], dls[:n])
    if not qos_exact(torch, ops.qos_round(st, *rows, now, free_t,
                                          max_units=256),
                     qos_admission.qos_round_plain(st, *rows, now, free_t,
                                                   256)):
        raise AssertionError(f"ops.qos_round != plain: S={S} N={n}")
    out[f"qos_large ops S={S} N={n}"] = "bit-exact"
    g = torch.Generator(device=dev).manual_seed(S)
    nows = torch.linspace(-0.5, 1.0, 32, device=dev)
    released = torch.randint(0, 9, (32,), generator=g, device=dev,
                             dtype=torch.int32)
    free0 = torch.full((), 64, dtype=torch.int32, device=dev)
    want = ref.qos_round_scan_ref(st, ids, tks, alive, dls, nows, free0,
                                  released, 256)
    got = ops.qos_round_scan(st, ids, tks, alive, dls, nows, free0,
                             released, max_units=256)
    if not (states_equal(torch, got[0], want["state"])
            and torch.equal(got[1], want["admit_round"])
            and torch.equal(got[2], want["expire_round"])
            and torch.equal(got[3], want["free"])):
        raise AssertionError(f"large qos_round_scan != plain scan: S={S}")
    out[f"qos_large scan S={S} N={N} K=32"] = "bit-exact"
    return out


def qos_large_times(torch, dev) -> dict:
    """The large path at 65536 rows × 1024 tenants (T=256, max_units=256)
    through `ops.qos_round` as the engine calls it: the wrapper's time
    (its torch presort and the kernel), the kernel's device time, the
    CUDA kernels and wrapper launches a call, the host µs, the plain
    round's time and the bound."""
    from repro_torch.kernels import ops, qos_admission

    S, N = QOS_LARGE_SHAPES[0]
    T = U = 256
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=S, N=N, T=T, wrap=False, alive_density=0.9,
        free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)

    def kernel():
        return ops.qos_round(st, ids, tks, alive, dls, now, free_t,
                             max_units=U)

    def plain():
        return qos_admission.qos_round_plain(st, ids, tks, alive, dls, now,
                                             free_t, U)

    got, want = kernel(), plain()
    err = qos_max_err(torch, got, want)
    if not qos_exact(torch, got, want):
        raise AssertionError(f"large path != plain at N={N}: {err}")
    prof = device_profile(torch, kernel, calls=20)
    nbytes = (N * (4 + 8 + 1 + 4) + S * (4 * 8 + 2 * 4) + T * 8 + 16
              + N * 2 + S * (3 * 8 + 4) + T * 8 + 4)
    bound, by = _bound(nbytes, 2 * S * U)
    return {"ms": time_ms(kernel), "kernel_device_ms": kernel_device_ms(
                torch, kernel, "qos_round_large_kernel"),
            "cuda_events_per_call": prof["launches"],
            "cuda_kernels_seen": sorted(k[:60] for k in prof["ms_by_kernel"]),
            "wrapper_launches_per_call": launches_per_call(
                torch, kernel, "qos_round_fused"),
            "max_abs_err": err, "plain_ms": time_ms(plain), "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "host_us": host_split(torch, kernel),
            "shape": {"N": N, "tenants": S, "T": T, "max_units": U}}


def qos_large_trace(seed: int = SEED) -> list:
    """The qos_large engine's burst as ``Request`` keyword dicts: tenants
    uniform over all of them, ``max_new`` 1–4 (slots churn), a quarter
    with deadlines on the 0.25 grid (2–100 virtual seconds)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[1], max_new_tokens=int(rng.integers(1, 5)),
                 tenant_id=f"t{int(rng.integers(0, QOS_LARGE_TENANTS))}",
                 deadline=(0.25 * float(rng.integers(8, 401))
                           if rng.random() < 0.25 else None))
            for i in range(QOS_LARGE_REQUESTS)]


def qos_large_engine(torch, dev) -> dict:
    """The engine past both of one CTA's limits on ``dev``: 1024 tenants
    (weights 4 : 2 : 1 in turn), ``backlog_cap`` 32768, 256 slots, the
    rid step function, ``use_kernel=True``; the burst of
    `qos_large_trace`, then `QOS_LARGE_MEGASTEPS` × ``megastep(32)`` (the
    rid token function) and `QOS_LARGE_STEPS` host ``step()``s on one
    virtual clock (1.0 a round).  After each call a digest of the QoS
    state (tickets, grants, consumed, dead, passes, ``bucket_seq``), the
    free units, the stats and every request's ticket, admit and expiry
    rounds and tokens; at the end the requests' view in full."""
    import hashlib

    from repro_torch.kernels import ops
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K = 32
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        rid_step_fn, lambda r: None, QOS_LARGE_SLOTS,
        tenants={f"t{i}": (4.0, 2.0, 1.0)[i % 3]
                 for i in range(QOS_LARGE_TENANTS)},
        use_kernel=True, backlog_cap=QOS_LARGE_CAP, clock=lambda: clk[0],
        device=dev)
    reqs = [Request(**t) for t in qos_large_trace()]

    def view():
        return [[r.ticket, r.admit_round, r.expire_round, r.expired,
                 r.preempted, len(r.out_tokens)] for r in reqs]

    def digest(x) -> str:
        return hashlib.sha256(json.dumps(x).encode()).hexdigest()[:16]

    calls = []

    def snap(what, ms):
        st = es.drain(eng.qos)
        calls.append({
            "call": what, "ms": ms,
            "qos": {f: digest(getattr(st, f).tolist()) for f in st._fields},
            "qos_free": int(eng._qos_free),
            "stats": [eng.stats.admitted, eng.stats.finished,
                      eng.stats.expired, eng.stats.preempted],
            "backlog": int(eng._tenant_live.sum()),
            "requests": digest(view())})

    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.submit_batch(reqs)
    snap("submit", 1e3 * (time.perf_counter() - t0))
    backlog_steps = 0
    for m in range(QOS_LARGE_MEGASTEPS):
        t0 = time.perf_counter()
        eng.megastep(K, token_fn=es.rid_token_fn,
                     nows=[k * 1.0 for k in range(K)])
        clk[0] += K
        snap(f"megastep {m}", 1e3 * (time.perf_counter() - t0))
    for j in range(QOS_LARGE_STEPS):
        backlog_steps += int(eng._tenant_live.sum() > 0)
        t0 = time.perf_counter()
        eng.step(_ident)
        clk[0] += 1.0
        snap(f"step {j}", 1e3 * (time.perf_counter() - t0))
    return {"calls": calls, "view": view(), "launches": ops.launch_counts(),
            "backlog_steps": backlog_steps,
            "host_syncs": eng.stats.host_syncs,
            "tenant_admitted": sum(1 for v in eng.tenant_admitted.values()
                                   if v)}


def qos_large_cpu(path: str) -> int:
    """``--qos-large-cpu PATH``: `qos_large_engine` on the CPU (the plain
    rounds), written to PATH as JSON for the qos_large phase."""
    import torch

    out = qos_large_engine(torch, torch.device("cpu"))
    Path(path).write_text(json.dumps(out))
    return 0


def qos_large(torch, dev) -> tuple:
    """The qos_large phase: the CPU engine starts in a process of its own
    (`qos_large_cpu`, no card), the large path is checked and timed on
    the card meanwhile, then the card engine runs; every call's digest
    and the final requests' view must equal the CPU engine's, every QoS
    round of the card engine must have gone through the kernel's large
    path (1024 tenants) once: one launch a round of each megastep and of
    each host step with a live backlog."""
    from repro_torch.kernels import qos_admission

    tmp = tempfile.mkdtemp(prefix="qos_large_")
    path = str(Path(tmp) / "cpu.json")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    t_cpu = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--qos-large-cpu", path], env=env)
    try:
        t0 = time.perf_counter()
        checks = qos_large_check(torch, dev)
        check_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        times = qos_large_times(torch, dev)
        times_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card = qos_large_engine(torch, dev)
        engine_s = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
        cpu_s = time.perf_counter() - t_cpu
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the CPU qos_large engine exited {rc}")
    cpu = json.loads(Path(path).read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    strip = [{k: v for k, v in c.items() if k != "ms"} for c in card["calls"]]
    cpu_strip = [{k: v for k, v in c.items() if k != "ms"}
                 for c in cpu["calls"]]
    diff = next((i for i, (a, b) in enumerate(zip(strip, cpu_strip))
                 if a != b), None)
    rounds = QOS_LARGE_MEGASTEPS * 32
    qos_launches = card["launches"]["qos_round_fused"]
    ok = {
        "calls_equal_cpu": strip == cpu_strip,
        "requests_equal_cpu": card["view"] == cpu["view"],
        "large_path_only": qos_admission.large_path(0, QOS_LARGE_TENANTS),
        "one_qos_launch_a_round": (
            qos_launches == rounds + card["backlog_steps"]
            and card["backlog_steps"] > 0),
        "admitted_and_expired": (card["calls"][-1]["stats"][0] > 0
                                 and card["calls"][-1]["stats"][2] > 0),
    }
    if not all(ok.values()):
        raise AssertionError(
            f"qos_large checks failed: {ok}; first differing call: "
            f"{diff} card {strip[diff] if diff is not None else None} cpu "
            f"{cpu_strip[diff] if diff is not None else None}")
    mega = [c["ms"] for c in card["calls"] if c["call"].startswith("mega")]
    steps = [c["ms"] for c in card["calls"] if c["call"].startswith("step ")]
    last = card["calls"][-1]
    return {"checks": checks, "engine_checks": ok, "times": times,
            "tenants": QOS_LARGE_TENANTS, "backlog_cap": QOS_LARGE_CAP,
            "slots": QOS_LARGE_SLOTS, "requests": QOS_LARGE_REQUESTS,
            "admitted": last["stats"][0], "finished": last["stats"][1],
            "expired": last["stats"][2], "backlog_left": last["backlog"],
            "tenants_admitted": card["tenant_admitted"],
            "megastep_ms": mega, "ms_per_megastep_round": sum(mega) / rounds,
            "step_ms_median": sorted(steps)[len(steps) // 2],
            "cpu_megastep_ms": [c["ms"] for c in cpu["calls"]
                                if c["call"].startswith("mega")],
            "launches": card["launches"],
            "qos_launches_per_megastep_round": qos_launches / (
                rounds + card["backlog_steps"]),
            "host_syncs": card["host_syncs"], "check_s": check_s,
            "times_s": times_s, "engine_s": engine_s, "cpu_engine_s": cpu_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def block_kind_kernel_check(torch, dev) -> dict:
    """The attention kernels at the other block kinds' heads
    (`BLOCK_KIND_SHAPES`), each against its plain version within 2e-5."""
    out = {}
    for kind, name, seed, kw, window in BLOCK_KIND_SHAPES:
        if kind == "decode":
            args, window = decode_case(torch, dev, seed=seed, **kw)
            err = decode_check(torch, args, window, name)
        else:
            args = flash_case(torch, dev, seed=seed, **kw)
            err = flash_check(torch, args, window, name)
        out[f"{kind}_attention {name}"] = f"max_abs_err {err:.3e}"
    return out


def _attention_shapes() -> tuple:
    """The shapes kernel_check holds the attention kernels to, and those
    of block_kind_kernel_check: ``(kernel, name, seed, case kwargs,
    window)``; a decode case carries its window in its kwargs."""
    qwen = dict(H=14, KV=2, hd=64)
    # serve_model's shape (B = slots, C = max_len) with a window and a
    # rolling ring; prefill_model's (a cache of S + 3 rows, its last tile
    # part empty); serve_dense_ring's (B = slots, C = ring); long caches
    main = [("decode", name, 21, kw, 0) for name, kw in (
        ("qwen2-0.5b", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN, **qwen)),
        ("qwen2-0.5b window=64", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN,
                                      window=64, **qwen)),
        ("qwen2-0.5b rolling", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN,
                                    rolling=True, **qwen)),
        ("qwen2-0.5b prefill_model", dict(
            B=PREFILL_B, C=PREFILL_S + PREFILL_EXTRA, **qwen)),
        ("dense-ring hd=896", dict(B=RING_SLOTS, C=RING_CAP, H=1, KV=1,
                                   hd=896, rolling=True)),
        ("long cache B=8 C=2048 window=300", dict(
            B=MODEL_SLOTS, C=2048, window=300, **qwen)),
        ("long cache B=1 C=2048", dict(B=1, C=2048, **qwen)),
        ("long cache B=8 C=2048 rolling", dict(
            B=MODEL_SLOTS, C=2048, rolling=True, **qwen)))]
    # S=512 causal and windowed; prefill_model's prefill (S) and its
    # longest fresh prefill (S + 3, a ragged last tile)
    main += [("flash", f"S={S} window={window}", 23,
              dict(B=PREFILL_B, S=S, **qwen), window)
             for S, window in ((512, 0), (512, 128), (PREFILL_S, 0),
                               (PREFILL_S + PREFILL_EXTRA, 0))]
    # gemma3-1b's attention width: hd=256, G=4 (two output slices a warp)
    main += [("flash", f"hd=256 G=4 S=512 window={window}", 25,
              dict(B=2, S=512, H=4, KV=1, hd=256), window)
             for window in (0, 100)]
    # the other block kinds' attention heads: granite-moe (H=24, KV=8,
    # hd=64), deepseek-moe (16, 16, 128) at prefill_<name>'s B × S and
    # its longest fresh prefill; recurrentgemma (16, 1, 256: G=16, one
    # query position a tile) at B=1 × S=2304 and S+3 with its 2048 window
    kinds = [("flash", f"{name} B={B} S={s_} window={window}", 27,
              dict(B=B, S=s_, **heads), window)
             for name, heads, window, B, S in BLOCK_KIND_FLASH
             for s_ in (S, S + PREFILL_EXTRA)]
    # their decode: serve_model's (8 slots, a 256-row cache) and a
    # 2048-row ring whose queries lie up to 2048 positions past it, so
    # that a 2048 window masks its oldest keys; recurrentgemma's prefill
    # phase at B=1
    kinds += [("decode", f"{name} {tag}", 29,
               dict(B=MODEL_SLOTS, **heads, **kw), 0)
              for name, heads, _, _, _ in BLOCK_KIND_FLASH
              for tag, kw in (("serve", dict(C=MODEL_MAX_LEN)),
                              ("C=2048 window=2048", dict(
                                  C=2048, window=2048, rolling=True,
                                  q_shift=1024)))]
    kinds.append(("decode", "recurrentgemma B=1 C=2048 window=2048", 31,
                  dict(B=HYBRID_PREFILL_B, C=2048, window=2048, rolling=True,
                       q_shift=HYBRID_PREFILL_S - 2048,
                       **BLOCK_KIND_FLASH[2][1]), 0))
    return tuple(main), tuple(kinds)


ATTENTION_SHAPES, BLOCK_KIND_SHAPES = _attention_shapes()


def two_streams(torch, dev, rounds: int = 8) -> dict:
    """The three split-K kernels (decode attention, paged prefill, paged
    decode), each launched ``rounds`` times on two streams in turns with
    no sync between, on different inputs: every output within 2e-5 of the
    plain version (the prefill's pools bit-equal), and each stream with
    arrival counters of its own."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain
    from repro_torch.kernels.paged_prefill import paged_prefill, \
        paged_prefill_plain

    NB, BS, MB = CHUNK_POOL
    qwen = dict(H=14, KV=2, hd=64)

    def dec(seed):
        (q, k, v, kpos, qpos), _ = decode_case(
            torch, dev, seed=seed, B=MODEL_SLOTS, C=2048, **qwen)
        return (q, k, v, kpos, qpos)

    def pre(seed):
        args, _ = prefill_case(torch, dev, seed=seed, S=CHUNK_SLOTS,
                               CT=CHUNKED[0], H=1, KV=1, hd=896, NB=NB,
                               BS=BS, MB=MB, active=32, max_off=960)
        return args

    cases = {
        "decode_attention": (decode_attention, decode_attention_plain,
                             dec(41), dec(42)),
        "paged_prefill": (lambda *a: paged_prefill(*a)[0],
                          lambda *a: paged_prefill_plain(*a)[0],
                          pre(43), pre(44)),
        "paged_decode": (paged_decode, paged_decode_plain,
                         chunked_decode_case(torch, dev, seed=45),
                         paged_case(torch, dev, seed=46, S=SERVE_SLOTS, H=1,
                                    KV=1, hd=896, NB=SERVE_POOL[0],
                                    BS=SERVE_POOL[1], MB=SERVE_POOL[2],
                                    max_len=SERVE_MAX_LEN))}
    out = {}
    for name, (kernel, plain, a, b) in cases.items():
        want = [plain(*x) for x in (a, b)]
        pools = [tuple(t.clone() for t in x) for x in (a, b)] \
            if name == "paged_prefill" else None
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
        got = [[], []]
        for _ in range(rounds):
            for i, (st, x) in enumerate(zip(streams, (a, b))):
                with torch.cuda.stream(st):
                    got[i].append(kernel(*x))
        torch.cuda.synchronize()
        err = 0.0
        for i in range(2):
            for g in got[i]:
                err = max(err, float((g - want[i]).abs().max()))
                if not torch.allclose(g, want[i], atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} on two streams != plain: {err}")
        if pools is not None:   # the prefill's pools as the plain writes
            for x, p0 in zip((a, b), pools):
                _, kw, vw = paged_prefill_plain(*p0)
                if not (torch.equal(x[3].view(torch.int32),
                                    kw.view(torch.int32))
                        and torch.equal(x[4].view(torch.int32),
                                        vw.view(torch.int32))):
                    raise AssertionError(f"{name} pools on two streams")
        own = {k[2] for k in build._arrivals if k[0] == name
               and k[2] in {st.cuda_stream for st in streams}}
        if len(own) != 2:
            raise AssertionError(f"{name}: the two streams share counters")
        out[name] = {"launches_per_stream": rounds, "max_abs_err": err,
                     "counter_arrays": len(own)}
    return out


def small_engine(torch, dev, trace, model_cpu, megastep_kw, **engine_kw):
    """A four-slot engine on ``dev`` with a copy of ``model_cpu``, served
    in ``megastep(8)`` calls until ``trace`` resolves.  Returns each
    request's (stream, admit round, expire round) and every sample."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    clk = [0.0]
    eng = ContinuousBatchingEngine(None, None, 4, use_kernel=True,
                                   clock=lambda: clk[0], device=dev,
                                   **engine_kw)
    eng.megastep_model = {k: v.clone().to(dev) for k, v in model_cpu.items()}
    reqs = [Request(**t) for t in trace]
    eng.submit_batch(reqs)
    samples = []
    for _ in range(20):
        eng.megastep(8, nows=[k * 0.25 for k in range(8)], **megastep_kw)
        samples += eng.telemetry()["last_samples"]
        clk[0] += 2.0
        if all(r.done_event.is_set() for r in reqs):
            break
    return [(r.out_tokens, r.admit_round, r.expire_round) for r in reqs], \
        samples


def serve_small(torch, dev) -> dict:
    """The engine on the card (both kernels) against the engine on the CPU
    (plain versions) on one small trace."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import make_paged_pool_model

    rng = np.random.default_rng(SEED)
    names = ["gold", "silver", "bronze"]
    trace = [dict(rid=i, prompt=[int(x) for x in rng.integers(1, 50, int(
        rng.integers(1, 8)))], max_new_tokens=int(rng.integers(1, 16)),
        tenant_id=names[i % 3],
        deadline=(float(rng.integers(2, 12)) if i % 4 == 0 else None))
        for i in range(24)]
    model = make_paged_pool_model(torch.Generator().manual_seed(SEED), 50, 16,
                                  32, 4, device="cpu")
    kw = dict(tenants=dict(WEIGHTS), prompt_cap=8, kv_pool=(32, 4, 8))
    fns = dict(token_fn=es.paged_pool_token_fn,
               admit_fn=es.paged_pool_admit_fn)
    gpu = small_engine(torch, dev, trace, model, fns, **kw)
    cpu = small_engine(torch, torch.device("cpu"), trace, model, fns, **kw)
    if gpu != cpu:
        raise AssertionError("engine on the card != engine on the CPU")
    return {"requests": len(trace), "rounds": len(gpu[1]),
            "tokens": sum(len(t[0]) for t in gpu[0]),
            "equal_to_cpu": True}


def serve_small_chunked(torch, dev) -> dict:
    """The chunked engine with the prefix cache and the paged-pool model
    on the card (all three kernels) against the same engine on the CPU
    (plain versions): a 16-block pool, prompts repeating an 8-token
    system prompt and, often, a recent whole prompt."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import make_paged_pool_model

    rng = np.random.default_rng(24)
    trace = []
    for i in range(16):
        dl = 0.25 * int(rng.integers(1, 24)) if rng.random() < 0.35 else None
        if i >= 4 and rng.random() < 0.4:
            prompt = list(trace[int(rng.integers(i - 4, i))]["prompt"])
        else:
            prompt = [7] * 8 + [1 + int(x) for x in
                                rng.integers(1, 6, int(rng.integers(0, 11)))]
        mx = 1 + int(rng.integers(0, 12))
        tenant = ("gold", "bronze")[int(rng.integers(0, 2))]
        trace.append(dict(rid=i, prompt=prompt, max_new_tokens=mx,
                          tenant_id=tenant, deadline=dl))
    model = make_paged_pool_model(torch.Generator().manual_seed(SEED), 50, 16,
                                  16, 4, device="cpu")
    kw = dict(tenants={"gold": 2.0, "bronze": 1.0}, prompt_cap=32,
              kv_pool=(16, 4, 8), chunked_prefill=(5, 9, 16), prefix_cache=8)
    fns = dict(token_fn=es.make_chunked_prefill_token_fn(5))
    gpu = small_engine(torch, dev, trace, model, fns, **kw)
    cpu = small_engine(torch, torch.device("cpu"), trace, model, fns, **kw)
    if gpu != cpu:
        raise AssertionError("chunked engine on the card != on the CPU")
    samples = gpu[1]
    return {"requests": len(trace), "rounds": len(samples),
            "tokens": sum(len(t[0]) for t in gpu[0]),
            "prefix_hits": sum(x["prefix_hits"] for x in samples),
            "cow_copies": sum(x["cow_copies"] for x in samples),
            "parked": sum(x["parked"] for x in samples),
            "equal_to_cpu": True}


def serve_engine(torch, dev, *, S=SERVE_SLOTS, pool=SERVE_POOL,
                 vocab=151936, d=896, n_req=SERVE_REQUESTS, prompt=(16, 129),
                 new=(16, 129)):
    """The serve configuration, by default at qwen2-0.5b's full width:
    the engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    NB, BS, _ = pool
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, S, tenants={"gold": 4.0, "silver": 2.0, "bronze": 1.0},
        use_kernel=True, clock=lambda: clk[0], backlog_cap=4096,
        prompt_cap=128, kv_pool=pool, device=dev)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*prompt)))],
        max_new_tokens=int(rng.integers(*new)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(DT * float(rng.integers(40, 320))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]
    eng.submit_batch(reqs)

    def megastep():
        eng.megastep(K, token_fn=es.paged_pool_token_fn,
                     admit_fn=es.paged_pool_admit_fn,
                     nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def drive(torch, dev, eng, reqs, megastep, limit: int):
    """Run ``megastep`` until every request is resolved (at most ``limit``
    megasteps), with the launch counts set to 0 just before and read just
    after.  Returns the samples, each megastep's wall ms, the total wall
    seconds, the launch counts and the checks every path must pass."""
    from repro_torch.kernels import ops

    vocab = eng.megastep_model["emb"].shape[0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    samples, step_ms = [], []
    while not all(r.done_event.is_set() for r in reqs):
        if len(step_ms) == limit:
            raise AssertionError("the serve loop did not resolve every "
                                 "request")
        t1 = time.perf_counter()
        samples += megastep()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    finished = [r for r in reqs if not r.expired]
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in reqs),
        "health_zero": all(s["health"] == 0 for s in samples),
        "one_sync_per_megastep": eng.stats.host_syncs == len(step_ms),
        "finished_full_length": all(len(r.out_tokens) == r.max_new_tokens
                                    for r in finished),
        "tokens_in_vocab": all(0 <= t < vocab for r in reqs
                               for t in r.out_tokens),
        "pool_drained": (eng._kv_pool is None or eng.telemetry()[
            "kv_blocks_free"] == eng._kv_blocks),
    }
    return samples, step_ms, wall, launches, checks


def serve(torch, dev, **sizes) -> dict:
    """The up-front path: serve until every request is finished or
    expired."""
    eng, reqs, megastep = serve_engine(torch, dev, **sizes)
    S, K = eng.n_slots, 32
    n_req = len(reqs)
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=64)
    megasteps = len(step_ms)
    tokens = sum(len(r.out_tokens) for r in reqs)
    gate_stalls = sum(s["gate_stalls"] for s in samples)
    checks.update({
        "kernels_launched": (launches["qos_round_fused"] > 0
                             and launches["paged_decode"] > 0),
        "block_gate_stalled": gate_stalls > 0,
    })
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    return {
        "requests": n_req, "finished": eng.stats.finished,
        "expired": eng.stats.expired, "preempted": eng.stats.preempted,
        "megasteps": megasteps, "rounds": megasteps * K,
        "busy_rounds": eng.stats.steps, "tokens": tokens,
        "gate_stalls": gate_stalls,
        "admits_per_tenant": dict(eng.tenant_admitted),
        "megastep_ms": step_ms,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ms_per_round": 1e3 * wall / (megasteps * K),
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "sync_debug_mode": "error", "checks": checks,
        "backlog_rows": backlog_rows(n_req, S),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None),
    }


def chunked_engine(torch, dev, *, n_req=CHUNK_REQUESTS, vocab=151936, d=896):
    """The serve_chunked configuration at qwen2-0.5b's full width: the
    engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    NB, BS, _ = CHUNK_POOL
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, CHUNK_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
        clock=lambda: clk[0], backlog_cap=4096, prompt_cap=CHUNK_PROMPT_CAP,
        kv_pool=CHUNK_POOL, chunked_prefill=CHUNKED,
        prefix_cache=PREFIX_ENTRIES, device=dev)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    reqs = [Request(**t) for t in chunked_requests(n_req, vocab)]
    eng.submit_batch(reqs)
    token_fn = es.make_chunked_prefill_token_fn(CHUNKED[0])

    def megastep():
        eng.megastep(K, token_fn=token_fn, nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def serve_chunked(torch, dev) -> dict:
    """The chunked path with prefix sharing: serve until every request is
    resolved."""
    eng, reqs, megastep = chunked_engine(torch, dev)
    K = 32
    repeats = sum(1 for i, r in enumerate(reqs)
                  if any(r.prompt == x.prompt for x in reqs[:i]))
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=40)
    megasteps = len(step_ms)
    tokens = sum(len(r.out_tokens) for r in reqs)
    tot = {k: sum(x[k] for x in samples) for k in (
        "parked", "prefix_hits", "cow_copies", "prefill_chunks",
        "prefill_tokens", "gate_stalls", "tokens")}
    checks.update({
        "kernels_launched": all(launches[k] > 0 for k in (
            "qos_round_fused", "paged_decode", "paged_prefill")),
        "parked": tot["parked"] > 0,
        "prefix_hits": tot["prefix_hits"] > 0,
        "cow_copies": tot["cow_copies"] > 0,
        "prefill_chunks": tot["prefill_chunks"] > 0,
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_chunked checks failed: {checks}")
    return {
        "requests": len(reqs), "exact_repeats": repeats,
        "finished": eng.stats.finished, "expired": eng.stats.expired,
        "preempted": eng.stats.preempted, "megasteps": megasteps,
        "rounds": megasteps * K, "busy_rounds": eng.stats.steps,
        "decode_tokens": tokens, **{f"sum_{k}": v for k, v in tot.items()},
        "admits_per_tenant": dict(eng.tenant_admitted),
        "megastep_ms": step_ms, "wall_s": wall,
        "decode_tokens_per_s": tokens / wall,
        "prompt_tokens_per_s": tot["prefill_tokens"] / wall,
        "ms_per_round": 1e3 * wall / (megasteps * K),
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "sync_debug_mode": "error", "checks": checks,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def serve_model_small(torch, dev) -> dict:
    """The single-tenant serving driver on the card (sema_batch pass in
    ``submit_batch`` with ``use_kernel``, decode kernel) against the same
    driver, trace and weights on the CPU (plain versions): the
    qwen2-0.5b smoke config, 10 requests over 3 slots."""
    import numpy as np

    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cpu = torch.device("cpu")
    base = ModelServer("qwen2-0.5b", 3, device=cpu)
    rng = np.random.default_rng(SEED)
    trace = [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, base.cfg.vocab, int(rng.integers(2, 9)))],
        max_new_tokens=int(rng.integers(2, 9))) for i in range(10)]
    runs = {}
    for d in (dev, cpu):
        params = _tree_to(base.params, d)
        server = ModelServer("qwen2-0.5b", 3, params=params, device=d)
        eng = ContinuousBatchingEngine(
            server.step_fn, server.prefill_request, 3, use_kernel=True,
            clock=lambda: 0.0, device=d)
        reqs = [Request(**t) for t in trace]
        eng.submit_batch(reqs[:6])
        samples = []
        for step in range(200):
            if step == 3:
                eng.submit_batch(reqs[6:])
            if step > 3 and eng.stats.finished == len(reqs):
                break
            eng.step(lambda lg: lg.argmax(-1))
            samples += eng.telemetry()["last_samples"]
        runs[d.type] = ([(r.out_tokens, r.ticket, r.bucket, r.observed_seq)
                         for r in reqs], samples, eng.stats.__dict__.copy())
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("single-tenant serve on the card != on the CPU")
    return {"requests": len(trace), "steps": len(runs["cuda"][1]),
            "tokens": sum(len(t[0]) for t in runs["cuda"][0]),
            "equal_to_cpu": True}


def _tree_to(tree, dev):
    """A nested dict/list of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def model_requests(vocab: int, seed: int = SEED,
                   n: int = MODEL_REQUESTS) -> list:
    """The serve_model trace (its first ``n`` requests) as ``Request``
    keyword dicts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*MODEL_PROMPT)))],
        max_new_tokens=int(rng.integers(*MODEL_NEW)))
        for i in range(n)]


def device_profile(torch, fn, calls: int = 1) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: kernel launches and
    device time per call (device-side kernel events only) and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"launches": sum(e.count for e in kernels) / calls,
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3 / calls,
            "top": [{"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3 / calls,
                     "count": e.count / calls} for e in top],
            "ms_by_kernel": {e.key: e.self_device_time_total / 1e3 / calls
                             for e in kernels},
            "per_launch": {e.key: (e.self_device_time_total / 1e3 / e.count,
                                   e.count) for e in kernels}}


def launches_per_call(torch, fn, name: str, calls: int = 20) -> float:
    """Kernel launches a call of ``fn`` by the wrapper's own counter
    (`build.LAUNCHES`), which counts each launch it makes."""
    from repro_torch.kernels import build

    before = build.LAUNCHES[name]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (build.LAUNCHES[name] - before) / calls


def kernel_device_ms(torch, fn, name: str, calls: int = 200,
                     tries: int = 10) -> float:
    """Device time of one launch of the kernel ``name`` (``fn`` launches
    it once), the mean over the launches that ``calls`` calls under the
    profiler recorded: divided by the events seen, not by the calls made,
    since the profiler keeps fewer events than were launched (0.1–0.3 a
    call for the kernels launched through `ctypes`, none of 20 calls at
    times: then the calls are profiled again, up to ``tries`` times)."""
    for _ in range(tries):
        prof = device_profile(torch, fn, calls=calls)
        hits = [v for key, v in prof["per_launch"].items() if name in key]
        if hits:
            return sum(ms * n for ms, n in hits) / sum(n for _, n in hits)
    raise AssertionError(f"{name} not among the profiled kernels in "
                         f"{tries} profiles of {calls} calls")


def has_attention(cfg) -> bool:
    return any(b.kind in ("attn", "moe") for b in cfg.blocks)


def n_moe_blocks(cfg) -> int:
    return sum(b.kind == "moe" for b in cfg.blocks)


class MoeAuxLog:
    """While open, every MoE block's aux dict is kept (device tensors, no
    read): ``overflow()`` then gives each model call's mean
    ``overflow_frac`` over its MoE blocks, read once."""

    def __init__(self, torch, cfg):
        from repro_torch.models import transformer as tt

        self.torch, self.tt, self.n = torch, tt, n_moe_blocks(cfg)
        self.log = []

    def __enter__(self):
        orig = self.orig = self.tt.moe_forward

        def logged(*a, **kw):
            out, aux = orig(*a, **kw)
            self.log.append(aux["overflow_frac"])
            return out, aux

        self.tt.moe_forward = logged
        return self

    def __exit__(self, *exc):
        self.tt.moe_forward = self.orig

    def overflow(self) -> list:
        if not self.log:
            return []
        per_block = self.torch.stack(self.log).reshape(-1, self.n)
        return per_block.mean(1).cpu().tolist()


class MoeRoutes:
    """While open, `models.moe.route` keeps each call's expert picks
    (``log``, in call order), or, with ``force`` a list of picks in call
    order, imposes them: the gates become the call's own probabilities at
    the forced experts, renormalised as `route` does, and each call
    counts the tokens whose own top-k set differs from the forced one
    (``flips``) with the f32 margin between their k-th and (k+1)-th
    probabilities (``margins``), beside every token's (``all_margins``):
    a flip at a near-tie shows as a margin far below the typical one.
    Nothing is read from the device until ``summary()``."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe = torch, moe
        self.log, self.force, self.calls = [], None, 0
        self.flips, self.margins, self.all_margins = [], [], []

    def __enter__(self):
        orig = self.orig = self.moe.route
        torch = self.torch

        def route(p, xt, top_k):
            logits, probs, gv, gi = orig(p, xt, top_k)
            if self.force is None:
                self.log.append(gi)
                return logits, probs, gv, gi
            want = self.force[self.calls]
            self.calls += 1
            top = torch.topk(probs, top_k + 1, dim=-1).values
            margin = top[:, top_k - 1] - top[:, top_k]
            flip = (gi.sort(-1).values != want.sort(-1).values).any(-1)
            self.flips.append(flip.sum())
            self.margins.append(torch.where(flip, margin, torch.nan))
            self.all_margins.append(margin)
            gv = probs.gather(1, want)
            gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
            return logits, probs, gv, want

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def forced(self, n_calls: int, B: int) -> list:
        """The picks a fresh prefill over every position seen so far must
        make: ``log`` holds one forward's ``n_calls`` MoE calls after
        another (the prefill over S tokens, then each decode step's one
        token a row); each MoE block's picks of those forwards joined
        along the sequence, row by row."""
        fwds = [self.log[i:i + n_calls]
                for i in range(0, len(self.log), n_calls)]
        return [self.torch.cat([f[b].reshape(B, -1, f[b].shape[-1])
                                for f in fwds], 1).reshape(
                                    -1, fwds[0][b].shape[-1])
                for b in range(n_calls)]

    def summary(self) -> dict:
        torch = self.torch
        if not self.flips:
            return {}
        allm = torch.cat(self.all_margins)
        flipm = torch.cat(self.margins)
        flipm = flipm[~torch.isnan(flipm)]
        return {"picks_checked": int(allm.numel()),
                "flipped": int(torch.stack(self.flips).sum()),
                "flipped_margin_max": (float(flipm.max()) if flipm.numel()
                                       else None),
                "margin_median": float(allm.median()),
                "margin_p01": float(allm.quantile(0.01))}


def sync_free_decode(torch, dev, server) -> bool:
    """One ``decode_step`` of the server's model on tokens and positions
    already on the card, under ``set_sync_debug_mode("error")``: raises
    if the step reads the device from the host."""
    from repro_torch.models.transformer import decode_step

    toks = torch.as_tensor(server.tokens, device=dev)
    pos = torch.as_tensor(server.positions, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_step(server.params, server.cfg, toks, pos, server.caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return True


def serve_model(torch, dev, cfg=None, n_requests=MODEL_REQUESTS) -> dict:
    """The single-tenant path, by default at the full qwen2-0.5b config: two
    ``submit_batch`` waves (the sema_batch kernel), ``step()`` to
    completion (every decode through the decode-attention kernel where
    the model has attention; each prompt replayed through full-batch
    decode steps, as the reference's server does).  A MoE model's
    ``overflow_frac`` is kept per decode call; one decode step at the end
    runs under the sync-debug mode "error"."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cfg = cfg or get_config("qwen2-0.5b")
    server = ModelServer(cfg.name, MODEL_SLOTS, max_len=MODEL_MAX_LEN,
                         seed=SEED, config=cfg, device=dev)
    n_params = sum(t.numel() for t in _leaves(server.params))
    eng = ContinuousBatchingEngine(server.step_fn, server.prefill_request,
                                   MODEL_SLOTS, use_kernel=True, device=dev)
    reqs = [Request(**t) for t in model_requests(cfg.vocab, n=n_requests)]
    half = len(reqs) // 2
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with MoeAuxLog(torch, cfg) as aux:
        eng.submit_batch(reqs[:half])
        step_ms, steps = [], 0
        while eng.stats.finished < len(reqs):
            if steps == MODEL_WAVE2_AT:
                eng.submit_batch(reqs[half:])
            if steps == 5000:
                raise AssertionError(
                    f"serve_model {cfg.name} did not finish every request")
            t1 = time.perf_counter()
            eng.step(lambda lg: lg.argmax(-1))
            step_ms.append(1e3 * (time.perf_counter() - t1))
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    overflow = aux.overflow()
    tel = eng.telemetry()
    tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_calls = prompt_tokens + eng.stats.steps
    # launches of one full-batch decode step (one replayed prompt token
    # or one engine step), its device time and top kernels
    step_prof = device_profile(torch, server._decode)
    by_kernel = step_prof.pop("ms_by_kernel")
    step_prof.pop("per_launch")
    decode_kernel_ms = sum(ms for key, ms in by_kernel.items()
                           if "decode_attention_kernel" in key)
    attn = has_attention(cfg)
    checks = {
        "all_finished": eng.stats.finished == len(reqs),
        "full_length": all(len(r.out_tokens) == r.max_new_tokens
                           for r in reqs),
        "queue_depth_zero": tel["queue_depth"] == 0,
        "tokens_in_vocab": all(0 <= t < cfg.vocab for r in reqs
                               for t in r.out_tokens),
        "sema_batch_launched": launches["sema_batch"] > 0,
        "decode_attention_launched": (launches["decode_attention"] > 0
                                      if attn else
                                      launches["decode_attention"] == 0),
        "one_sync_per_step": eng.stats.host_syncs == steps,
        "overflow_per_decode_call": len(overflow) == (
            decode_calls if n_moe_blocks(cfg) else 0),
        "decode_step_sync_free": sync_free_decode(torch, dev, server),
    }
    if not all(checks.values()):
        raise AssertionError(f"serve_model {cfg.name} checks failed: "
                             f"{checks}")
    out = {
        "config": cfg.name, "layers": cfg.n_layers, "parameters": n_params,
        "slots": MODEL_SLOTS,
        "max_len": MODEL_MAX_LEN, "requests": len(reqs), "steps": steps,
        "busy_steps": eng.stats.steps, "tokens": tokens,
        "prompt_tokens": prompt_tokens, "decode_calls": decode_calls,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ms_per_step": 1e3 * wall / steps,
        "ms_per_decode_call": 1e3 * wall / decode_calls,
        "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
        "backlog_scans": eng.stats.backlog_scans,
        "backlog_skipped": eng.stats.backlog_skipped,
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "launches_per_decode_step": step_prof["launches"],
        "device_ms_per_decode_step": step_prof["device_ms"],
        "decode_step_top_kernels": step_prof["top"],
        "decode_attention_kernel_ms_per_decode_step": decode_kernel_ms,
        "checks": checks,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if overflow:
        out["overflow_frac_per_decode_call"] = {
            "mean": sum(overflow) / len(overflow), "max": max(overflow),
            "calls_with_overflow": sum(o > 0 for o in overflow),
            "calls": len(overflow)}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def prefill_model(torch, dev, cfg=None, B=PREFILL_B, S=PREFILL_S,
                  dtype=None, profile_decode: bool = False) -> dict:
    """The full config's (by default) prefill (flash kernel where the
    model has attention) on B × S tokens, then decode steps (decode
    kernel), each held to a fresh prefill over the longer prefix within
    2e-3 — in f32, or with ``dtype=torch.bfloat16`` bf16 parameters and
    caches (the bf16 kernels, and no f32 one) within `BF16_LOGIT_TOL` ×
    max |logit|.  ``profile_decode`` profiles one more decode step after
    the checks (its CUDA launches and device ms).  A MoE model at bf16
    routes its fresh prefills as the prefill and decode steps before them
    routed (`MoeRoutes`): a bf16 hidden state that rounds apart between
    the two paths can flip an expert at a near-tie of the f32 router,
    which moves the token's output by a whole expert; the flips are
    counted with their margins, and the rest of the step is held to the
    tolerance."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tt

    cfg = cfg or get_config("qwen2-0.5b")
    dtype = dtype or torch.float32
    extra = PREFILL_EXTRA
    params = tt.init_params(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (B, S + extra), generator=g,
                         device=dev)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""

    def close(got, want):
        if not suffix:
            return torch.allclose(got, want, atol=2e-3, rtol=2e-3)
        return bool((got - want).abs().max()
                    <= BF16_LOGIT_TOL * want.abs().max())

    def fresh():
        return tt.init_caches(cfg, B, S + extra, dtype, device=dev)

    caches = fresh()
    routes = MoeRoutes(torch)
    n_moe = n_moe_blocks(cfg) if suffix else 0
    with routes if n_moe else contextlib.nullcontext():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = tt.prefill(params, cfg, {"tokens": toks[:, :S]},
                                    caches)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        errs, scale, decode_ms = [], [], []
        for t in range(extra):
            pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
            t1 = time.perf_counter()
            got, caches = tt.decode_step(params, cfg,
                                         toks[:, S + t:S + t + 1], pos,
                                         caches)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t1))
            if n_moe:
                routes.force, routes.calls = routes.forced(n_moe, B), 0
            want, _ = tt.prefill(params, cfg,
                                 {"tokens": toks[:, :S + t + 1]}, fresh())
            routes.force = None
            errs.append(float((got - want).abs().max()))
            scale.append(float(want.abs().max()))
            if not close(got, want):
                raise AssertionError(f"{cfg.name}: decode step {t} != "
                                     f"prefill over the longer prefix: "
                                     f"{errs[-1]}")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        flash_routes = ops.flash_routes()
    attn = has_attention(cfg)
    flash, dec = f"flash_attention{suffix}", f"decode_attention{suffix}"
    checks = {
        "finite": bool(torch.isfinite(logits).all()),
        "shape": tuple(logits.shape) == (B, cfg.vocab),
        "flash_attention_launched": (launches[flash] > 0 if attn else
                                     launches[flash] == 0),
        "decode_attention_launched": (launches[dec] > 0 if attn else
                                      launches[dec] == 0),
    }
    if suffix:
        checks["no_f32_attention"] = (launches["flash_attention"]
                                      == launches["decode_attention"] == 0)
    if suffix and attn and cfg.hd in WGMMA_HD:  # every call on wgmma
        checks["flash_wgmma_route"] = flash_routes == {
            "wgmma": launches[flash], "mma_sync": 0}
    prof = None
    if profile_decode:
        pos = torch.full((B, 1), S + extra, dtype=torch.int32, device=dev)
        prof = device_profile(torch, lambda: tt.decode_step(
            params, cfg, toks[:, -1:], pos, caches))
    if not all(checks.values()):
        raise AssertionError(f"prefill_model {cfg.name} checks failed: "
                             f"{checks}")
    return {"config": cfg.name, "layers": cfg.n_layers, "dtype": str(dtype),
            "parameters": sum(t.numel() for t in _leaves(params)),
            "capacity_factor": cfg.capacity_factor, "B": B, "S": S,
            "decode_steps": extra,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_vs_prefill_max_abs_err": errs,
            "decode_vs_prefill_rel_gap": [e / m for e, m in zip(errs, scale)],
            "tolerance": (f"{BF16_LOGIT_TOL} x max |logit|" if suffix
                          else 2e-3),
            "launches": launches, "checks": checks,
            **({"flash_routes": flash_routes} if suffix else {}),
            **({"decode_launches_a_step": prof["launches"],
                "decode_device_ms_a_step": prof["device_ms"]}
               if prof else {}),
            **({"moe_routes": routes.summary()} if n_moe else {}),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def moe_step_breakdown(torch, dev, cfg, calls: int = 50) -> dict:
    """Where one MoE block's decode step goes, at ``cfg``'s width and
    serve_model's batch (8 slots, one token each, a 256-row cache): ms a
    call of each stage of `models.moe.moe_forward` (routing, the
    semaphore admission, dispatch, the experts, the combine, the shared
    experts, the aux) and of the attention half, each run ``calls`` times
    back to back and synchronised once (so a stage bound by its host
    work shows that), beside the whole block."""
    from repro_torch.configs.base import Block
    from repro_torch.models import moe
    from repro_torch.models import transformer as tt

    spec = Block("moe")
    g = torch.Generator(device=dev).manual_seed(SEED)
    p = tt.init_block(g, spec, cfg, torch.float32, device=dev)
    cache = tt.init_block_cache(spec, cfg, MODEL_SLOTS, MODEL_MAX_LEN,
                                torch.float32, device=dev)
    x = torch.randn((MODEL_SLOTS, 1, cfg.d_model), generator=g, device=dev)
    pos = torch.full((MODEL_SLOTS, 1), 7, dtype=torch.int32, device=dev)
    pm, k = p["moe"], cfg.top_k
    xt = x.reshape(MODEL_SLOTS, cfg.d_model)
    E, E_pad = cfg.n_experts, pm["wi"].shape[0]
    cap = moe.capacity_of(MODEL_SLOTS, k, E, cfg.capacity_factor)
    logits, probs, gv, gi = moe.route(pm, xt, k)
    flat_e = gi.reshape(1, -1)
    tks, adm = moe.admit(flat_e, E, cap)
    buf, dest = moe.dispatch(xt, flat_e, tks, adm, E_pad, cap, k)
    ob = moe.experts(pm, buf)
    stages = {
        "attention_half": lambda: tt._attention(spec, cfg, p, x, pos, cache,
                                                "decode"),
        "route": lambda: moe.route(pm, xt, k),
        "admit": lambda: moe.admit(flat_e, E, cap),
        "dispatch": lambda: moe.dispatch(xt, flat_e, tks, adm, E_pad, cap,
                                         k),
        "experts": lambda: moe.experts(pm, buf),
        "combine": lambda: moe.combine(ob, dest, gv, adm, k),
        "aux": lambda: moe.aux_losses(logits, probs, gi, adm, k, 1e-3),
        "moe_forward": lambda: moe.moe_forward(
            pm, x, top_k=k, capacity_factor=cfg.capacity_factor),
        "block": lambda: tt.block_forward(spec, cfg, p, x, pos, cache,
                                          "decode"),
    }
    if "shared" in pm:
        stages["shared_experts"] = lambda: moe.shared_experts(pm, xt)
    out = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / calls
    out["launches_per_moe_forward"] = device_profile(
        torch, stages["moe_forward"], calls=5)["launches"]
    return {"capacity": cap, "ms_per_call": out}


def block_kind_configs() -> dict:
    """The other block kinds' configurations at full width: granite-moe
    (``GRANITE_UNITS`` of its 32 MoE layers), deepseek-moe (the dense
    prefix block and
    ``DEEPSEEK_UNITS`` of its 27 MoE units), recurrentgemma
    (``HYBRID_UNITS`` of its 12 units and the 2 RG-LRU suffix blocks)
    and xlstm (``XLSTM_UNITS`` of its 12 (mLSTM, sLSTM) units)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    return {
        "moe": dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                   num_units=GRANITE_UNITS),
        "moe_shared": dataclasses.replace(get_config("deepseek-moe-16b"),
                                          num_units=DEEPSEEK_UNITS),
        "hybrid": dataclasses.replace(get_config("recurrentgemma-9b"),
                                      num_units=HYBRID_UNITS),
        "xlstm": dataclasses.replace(get_config("xlstm-350m"),
                                     num_units=XLSTM_UNITS),
    }


def block_kind_phases(torch, dev) -> dict:
    """``serve_model_<name>`` then ``prefill_<name>`` for each of the four
    configurations, each phase from zeroed launch counts, the
    configuration's tensors freed before the next.  Returns each phase's
    launch counts."""
    import dataclasses
    import gc

    by_path = {}
    for name, cfg in block_kind_configs().items():
        for phase in (f"serve_model_{name}", f"prefill_{name}"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if phase.startswith("serve"):
                res = serve_model(torch, dev, cfg,
                                  n_requests=BLOCK_KIND_REQUESTS)
            else:
                kw = (dict(B=HYBRID_PREFILL_B, S=HYBRID_PREFILL_S)
                      if name == "hybrid" else {})
                pcfg = (dataclasses.replace(
                    cfg, capacity_factor=PREFILL_CAPACITY_FACTOR)
                        if cfg.n_experts else cfg)
                res = prefill_model(torch, dev, pcfg, **kw)
            if phase.startswith("serve") and cfg.n_experts:
                res["moe_block_decode_breakdown"] = moe_step_breakdown(
                    torch, dev, cfg)
            emit(phase, seconds=time.perf_counter() - t0, **res)
            by_path[phase] = res["launches"]
            gc.collect()
            torch.cuda.empty_cache()
    return by_path


# ------------------------------------------------------------- training ----


def train_step_flops(cfg, B: int, S: int) -> float:
    """The operations one train step of a dense attention model needs on
    B × S tokens: 3 × the forward's (forward, then the gradients of the
    activations and of the weights), the forward's being the q/k/v/o and
    SwiGLU products, the causal attention's QKᵀ and PV over (S+1)/2 keys a
    token on average, and the LM head — recomputation under remat not
    counted."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = (2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
                 + 2 * 3 * D * cfg.d_ff + 2 * 2 * H * hd * (S + 1) / 2)
    return 3.0 * B * S * (cfg.n_layers * per_layer + 2 * D * cfg.vocab)


def _state_to(torch, state, dev):
    """A `TrainState` copied to ``dev`` (a train step updates its
    parameters in place)."""
    from repro_torch.optim.adamw import tree_map

    cp = lambda t: t.detach().to(dev, copy=True)  # noqa: E731
    opt = state.opt
    return type(state)(tree_map(cp, state.params),
                       type(opt)(cp(opt.step), tree_map(cp, opt.mu),
                                 tree_map(cp, opt.nu),
                                 tree_map(cp, opt.master)), {})


def _fwd_bwd(torch, cfg, params, batch, remat, kv_block=1024):
    """The loss and its gradients w.r.t. every parameter leaf."""
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw

    req = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = tt.train_loss(req, cfg, batch, remat=remat, kv_block=kv_block)
    return torch.autograd.grad(loss, adamw.leaves(req), allow_unused=True,
                               materialize_grads=True)


def train_breakdown(torch, cfg, state, batch, remats,
                    calls: int = 3) -> dict:
    """Where a train step's time goes, each part timed alone on
    ``state`` and ``batch`` (one warm-up, then ``calls`` calls, host clock
    around a synchronise): the loss forward without autograd, forward and
    backward under each remat policy of ``remats``, and the AdamW update
    over gradients of ones (it rewrites ``state`` in place)."""
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw

    def loss_only():
        with torch.no_grad():
            tt.train_loss(state.params, cfg, batch, remat="none")

    grads = adamw.tree_map(torch.ones_like, state.params)
    parts = {"forward_no_grad": loss_only,
             **{f"forward_backward_{r}":
                (lambda r=r: _fwd_bwd(torch, cfg, state.params, batch, r))
                for r in dict.fromkeys(remats)},
             "adamw_update": lambda: adamw.adamw_update(
                 adamw.AdamWConfig(), grads, state.opt)}
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / calls
    return out


def train_inputs(torch, dev, param_dtype=None):
    """train_model's step over qwen2-0.5b at full width cut to TRAIN_UNITS
    layers: ``(cfg, step_config, train_step, batch, state)``, the batch
    the loader's first (rows 0..TRAIN_B−1 of `SyntheticLM`), the state
    from SEED; f32 unless ``param_dtype`` says otherwise."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import steps

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              num_units=TRAIN_UNITS)
    shape = ShapeSpec("cli", TRAIN_S, TRAIN_B, "train")
    sc = steps.default_step_config(cfg, shape,
                                   param_dtype=param_dtype or torch.float32)
    step = steps.make_train_step(cfg, shape, sc, AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=TRAIN_RESUME_TO))
    src = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S, seed=SEED)
    rows = [src.sample(i) for i in range(TRAIN_B)]
    batch = {k: torch.as_tensor(np.stack([r[k] for r in rows]), device=dev)
             for k in ("tokens", "labels")}
    state = steps.make_train_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg, sc, dev)
    return cfg, sc, step, batch, state


def train_remat_breakdown(torch, dev) -> dict:
    """``--train-remat``: train_model's step parts under all four remat
    policies (none, full, dots, 2level), each timed alone."""
    cfg, _, _, batch, state = train_inputs(torch, dev)
    return train_breakdown(torch, cfg, state, batch,
                           ("none", "full", "dots", "2level"))


def long_sequence_memory(torch, cfg, params, dev) -> dict:
    """Peak device memory of one forward and backward over a B=1,
    S=LONG_S sequence, above what was allocated before it, under the
    remat policy `default_step_config` picks for that shape: with KV
    blocks of 1024 (each checkpointed, O(S) attention activations) and
    with one block of LONG_S (its (S, S) scores kept).  The gradients
    (4 bytes a parameter) are in both."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.parallel import steps

    sc = steps.default_step_config(cfg, ShapeSpec("long", LONG_S, 1,
                                                  "train"),
                                   param_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(SEED)
    batch = {k: torch.randint(0, cfg.vocab, (1, LONG_S), generator=g,
                              device=dev) for k in ("tokens", "labels")}
    out = {"S": LONG_S, "remat": sc.remat,
           "est_train_act_gb": steps.est_train_act_bytes(cfg, LONG_S) / 1e9,
           "grads_gb": 4 * cfg.param_count() / 1e9}
    for name, kv_block in (("blocks_1024", 1024), ("one_block", LONG_S)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = _fwd_bwd(torch, cfg, params, batch, sc.remat, kv_block)
        torch.cuda.synchronize()
        out[f"peak_gb_{name}"] = (torch.cuda.max_memory_allocated()
                                  - base) / 1e9
        del grads
    if not out["peak_gb_blocks_1024"] < out["peak_gb_one_block"]:
        raise AssertionError(f"long_sequence_memory: {out}")
    return out


def train_model(torch, dev) -> dict:
    """`repro_torch.launch.train.main` over qwen2-0.5b at full width cut
    to TRAIN_UNITS layers (``--units``), f32, TRAIN_B × TRAIN_S:
    TRAIN_STEPS steps with checkpoints into a
    temporary directory, a resume to TRAIN_RESUME_TO and a straight run
    to it; then timed steps and one profiled step of the same train
    step."""
    import math
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main

    common = ["--arch", "qwen2-0.5b", "--units", str(TRAIN_UNITS),
              "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
              "--total-steps", str(TRAIN_RESUME_TO), "--seed", str(SEED),
              "--log-every", "4"]
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's log lines
        with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ck:
            disk_free_gb = shutil.disk_usage(ck).free / 1e9
            t0 = time.perf_counter()
            first = train_main(common + [
                "--steps", str(TRAIN_STEPS), "--ckpt-dir", ck,
                "--ckpt-every", str(TRAIN_CKPT_EVERY)])
            seconds["first"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = train_main(common + [
                "--steps", str(TRAIN_RESUME_TO), "--ckpt-dir", ck,
                "--resume"])
            seconds["resume"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        straight = train_main(common + ["--steps", str(TRAIN_RESUME_TO)])
        seconds["straight"] = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_runs = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cfg, sc, step, batch, state = train_inputs(torch, dev)
    box = {"state": state}
    del state

    def one():
        box["state"], box["metrics"] = step(box["state"], batch)

    times = []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times[TRAIN_WARMUP:])
    peak_step = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(torch, one, calls=1)
    grad_norm = float(box["metrics"]["grad_norm"])
    parts_ms = train_breakdown(torch, cfg, box["state"], batch,
                               (sc.remat, "none"))
    long_mem = long_sequence_memory(torch, cfg, box["state"].params, dev)
    del box
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    # bytes: the parameters (their f32 master) and both moments read and
    # written once
    state_bytes = 6 * 4 * cfg.param_count()
    bound_ms, bound_by = _bound(state_bytes, flops)
    tail = straight[TRAIN_STEPS:]
    resume_err = max(abs(a - b) for a, b in zip(resumed, tail))
    replay_err = max(abs(a - b) for a, b in zip(first, straight))
    checks = {
        "finite": bool(np.isfinite(first + resumed + straight).all()),
        "step0_near_ln_vocab": abs(first[0] - math.log(cfg.vocab)) < 0.5,
        "resume_ran_only_new_steps": (
            len(first) == TRAIN_STEPS
            and len(resumed) == TRAIN_RESUME_TO - TRAIN_STEPS),
        "resume_follows_straight_run": resume_err <= TRAIN_RESUME_TOL,
        "first_run_follows_straight_run": replay_err <= TRAIN_RESUME_TOL,
        "no_port_kernel_launched": not any(launches.values()),
    }
    if not all(checks.values()):
        raise AssertionError(f"train_model checks failed: {checks} "
                             f"{first} {resumed} {straight}")
    return {"config": cfg.name, "layers": cfg.n_layers,
            "parameters": cfg.param_count(), "B": TRAIN_B, "S": TRAIN_S,
            "accum_steps": sc.accum_steps, "remat": sc.remat,
            "steps": {"first": TRAIN_STEPS, "ckpt_every": TRAIN_CKPT_EVERY,
                      "resume_to": TRAIN_RESUME_TO},
            "run_seconds": seconds, "disk_free_gb": disk_free_gb,
            "loss_first_step": first[0], "loss_last_step": straight[-1],
            "losses_straight": straight, "losses_resumed": resumed,
            "resume_max_abs_diff": resume_err,
            "first_run_max_abs_diff": replay_err,
            "tolerance": TRAIN_RESUME_TOL,
            "ms_per_step": ms, "step_ms_all": times,
            "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
            "grad_norm": grad_norm,
            "peak_mem_gb_runs": peak_runs, "peak_mem_gb_step": peak_step,
            "launches_per_step": prof["launches"],
            "device_ms_per_step": prof["device_ms"],
            "device_busy": prof["device_ms"] / ms,
            "top_kernels": prof["top"][:6], "parts_ms": parts_ms,
            "long_sequence_memory": long_mem,
            "step_flops": flops, "step_state_bytes": state_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "port_kernel_launches": launches, "checks": checks}


def train_moe(torch, dev) -> dict:
    """The train step over granite-moe-3b-a800m at full width cut to
    MOE_TRAIN_UNITS of its MoE layers, MOE_TRAIN_B × MOE_TRAIN_S batches
    from the TWA-buffered loader, MOE_TRAIN_STEPS steps."""
    import dataclasses
    import statistics

    import numpy as np

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import steps

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_units=MOE_TRAIN_UNITS)
    shape = ShapeSpec("cli", MOE_TRAIN_S, MOE_TRAIN_B, "train")
    sc = steps.default_step_config(cfg, shape, param_dtype=torch.float32)
    step = steps.make_train_step(cfg, shape, sc, AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=MOE_TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    state = steps.make_train_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg, sc, dev)
    loader = DataLoader(SyntheticLM(vocab=cfg.vocab, seq_len=MOE_TRAIN_S,
                                    seed=SEED), MOE_TRAIN_B)
    it = iter(loader)
    times, per_step = [], []
    try:
        for _ in range(MOE_TRAIN_STEPS):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(it).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            per_step.append({k: float(m[k]) for k in (
                "loss", "ce", "lb_loss", "router_z", "overflow_frac",
                "grad_norm")})
    finally:
        loader.stop()
    losses = [r["loss"] for r in per_step]
    checks = {"finite": bool(np.isfinite(
        [v for r in per_step for v in r.values()]).all()),
        "lb_loss_positive": all(r["lb_loss"] > 0 for r in per_step)}
    if not all(checks.values()):
        raise AssertionError(f"train_moe checks failed: {checks} "
                             f"{per_step}")
    return {"config": cfg.name, "layers": cfg.n_layers,
            "parameters": cfg.param_count(), "B": MOE_TRAIN_B,
            "S": MOE_TRAIN_S, "accum_steps": sc.accum_steps,
            "remat": sc.remat, "ms_per_step": statistics.median(times[1:]),
            "step_ms_all": times,
            "tokens_per_s": MOE_TRAIN_B * MOE_TRAIN_S
            / (statistics.median(times[1:]) / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, "per_step": per_step, "checks": checks}


def train_parity(torch, dev, dtype=None) -> dict:
    """One train step of each smoke config in PARITY_ARCHS on the card
    against the same step on the CPU from the same parameters (one seed)
    and batch, TF32 off: loss and ``grad_norm`` within PARITY_TOL
    relative; the gradient (Adam's first moment) within PARITY_TOL of each
    leaf's largest magnitude; every updated parameter within 1e-5 relative
    plus 0.01·lr where its gradient element exceeds 1e3·eps, and within
    one step (lr) elsewhere — Adam's first step moves a weight by
    lr·g/(|g| + eps), so where |g| is near eps both sides' rounding
    reaches the weight at full scale.  With ``dtype=torch.bfloat16`` the
    step is `default_step_config`'s bf16 (bf16 parameters, the f32
    master), held at the `PARITY_BF16_*` limits: both sides round to bf16
    where their sums differ in order (cuBLAS against the CPU's GEMMs)."""
    import numpy as np

    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import frontend_batch
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.parallel import steps

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    bf16 = dtype == torch.bfloat16
    out = {}
    for arch in PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        shape = ShapeSpec("p", PARITY_S, PARITY_B, "train")
        sc = steps.default_step_config(cfg, shape,
                                       param_dtype=dtype or torch.float32)
        state = steps.make_train_state(torch.Generator().manual_seed(SEED),
                                       cfg, sc, device="cpu")
        src = SyntheticLM(vocab=cfg.vocab, seq_len=PARITY_S, seed=SEED)
        rows = [src.sample(i) for i in range(PARITY_B)]
        batch = frontend_batch(cfg, {k: np.stack([r[k] for r in rows])
                                     for k in ("tokens", "labels")})
        if bf16:  # float inputs in the parameters' dtype, as the
            # reference's input_specs give the frontends' embeddings
            batch = {k: torch.as_tensor(v).to(dtype)
                     if torch.as_tensor(v).is_floating_point() else v
                     for k, v in batch.items()}
        res = {}
        for d in ("cpu", dev):
            st, m = steps.make_train_step(cfg, shape, sc, opt)(
                _state_to(torch, state, d),
                {k: torch.as_tensor(v, device=d) for k, v in batch.items()})
            res[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                           [t.cpu() for t in leaves(st.params)],
                           [t.cpu() for t in leaves(st.opt.mu)],
                           [t.cpu() for t in leaves(st.opt.master)])
        (l0, g0, p0, m0, w0), (l1, g1, p1, m1, w1) = (res["cpu"],
                                                       res[str(dev)])
        if bf16:
            out[arch] = _parity_bf16(torch, (l0, g0, p1, m0, w0),
                                     (l1, g1, m1, w1), opt.lr)
            continue
        mu_err = max(float((b - a).abs().max()
                           / a.abs().max().clamp(min=1e-30))
                     for a, b in zip(m0, m1))
        p_err, p_ill_err, n_ill = 0.0, 0.0, 0
        for a, b, mu in zip(p0, p1, m0):
            well = mu.abs() > 1e3 * opt.eps * (1 - opt.beta1)
            err = (b - a).abs() - 1e-5 * a.abs()
            p_err = max(p_err, float(err[well].max()) if well.any() else 0.0)
            if (~well).any():
                p_ill_err = max(p_ill_err, float(err[~well].max()))
                n_ill += int((~well).sum())
        checks = {"loss": abs(l1 - l0) <= PARITY_TOL * abs(l0),
                  "grad_norm": abs(g1 - g0) <= PARITY_TOL * abs(g0),
                  "grads": mu_err <= PARITY_TOL,
                  "params": p_err <= 0.01 * opt.lr,
                  "params_near_zero_grad": p_ill_err <= opt.lr}
        out[arch] = {"loss_cpu": l0, "loss_card": l1, "grad_norm_cpu": g0,
                     "grad_norm_card": g1, "grad_max_rel_err": mu_err,
                     "param_max_err": p_err,
                     "param_near_zero_grad_max_err": p_ill_err,
                     "near_zero_grad_elements": n_ill, "checks": checks}
        if not all(checks.values()):
            raise AssertionError(f"train_parity {arch}: {out[arch]}")
    tol = ({"loss": PARITY_BF16_LOSS_TOL, "grad_norm": PARITY_BF16_GNORM_TOL,
            "mu_l2": PARITY_BF16_MU_L2_TOL,
            "flip_share": PARITY_BF16_FLIP_SHARE, "master": "2 lr"}
           if bf16 else PARITY_TOL)
    return {"B": PARITY_B, "S": PARITY_S, "lr": opt.lr,
            "dtype": str(dtype or torch.float32), "tolerance": tol,
            "configs": out}


def _parity_bf16(torch, cpu, card, lr: float) -> dict:
    """train_parity's bf16 checks of one config: ``cpu`` (loss, grad_norm,
    the card's updated parameters, mu, master) and ``card`` (loss,
    grad_norm, mu, master).  The working parameters bf16 and equal to the
    master rounded; raises when a check fails."""
    (l0, g0, p1, m0, w0), (l1, g1, m1, w1) = cpu, card
    num = sum(float(((b - a).double() ** 2).sum()) for a, b in zip(m0, m1))
    den = sum(float((a.double() ** 2).sum()) for a in m0)
    mu_l2 = (num / max(den, 1e-300)) ** 0.5
    gaps = [(b - a).abs() for a, b in zip(w0, w1)]
    n = sum(g.numel() for g in gaps)
    flips = sum(int((g > lr / 2).sum()) for g in gaps) / max(n, 1)
    worst = max(float(g.max()) for g in gaps if g.numel())
    checks = {
        "loss": abs(l1 - l0) <= PARITY_BF16_LOSS_TOL * abs(l0),
        "grad_norm": abs(g1 - g0) <= PARITY_BF16_GNORM_TOL * abs(g0),
        "mu_l2": mu_l2 <= PARITY_BF16_MU_L2_TOL,
        "master_within_2lr": worst <= 2 * lr * (1 + 1e-3),
        "flip_share": flips <= PARITY_BF16_FLIP_SHARE,
        "bf16_params": all(
            p.dtype == torch.bfloat16 and torch.equal(p, w.to(p.dtype))
            for p, w in zip(p1, w1) if p.dtype != torch.float32),
        "f32_master": all(w.dtype == torch.float32 for w in w1),
    }
    res = {"loss_cpu": l0, "loss_card": l1, "grad_norm_cpu": g0,
           "grad_norm_card": g1, "mu_rel_l2": mu_l2, "flip_share": flips,
           "master_max_gap": worst, "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"train_parity bf16: {res}")
    return res


def dense_ring_engine(torch, dev, *, vocab=151936, d=896,
                      n_req=RING_REQUESTS):
    """The dense-ring configuration, by default at qwen2-0.5b width: the
    engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, RING_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
        clock=lambda: clk[0], backlog_cap=4096, prompt_cap=128, device=dev)
    eng.megastep_model = es.make_paged_attn_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, RING_SLOTS,
        RING_CAP, device=dev)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(16, 129)))],
        max_new_tokens=int(rng.integers(16, 129)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(DT * float(rng.integers(40, 320))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]
    eng.submit_batch(reqs)

    def megastep():
        eng.megastep(K, token_fn=es.paged_attn_token_fn,
                     admit_fn=es.paged_attn_admit_fn,
                     nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def serve_dense_ring(torch, dev) -> dict:
    """The dense-ring demo model in the QoS megastep at qwen2-0.5b width:
    one ring of 256 rows per slot, every decode through the
    decode-attention kernel (H = KV = 1, hd = 896), admission through
    the QoS kernel; served until every request resolves."""
    K = 32
    eng, reqs, megastep = dense_ring_engine(torch, dev)
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=40)
    checks["kernels_launched"] = (launches["qos_round_fused"] > 0
                                  and launches["decode_attention"] > 0)
    if not all(checks.values()):
        raise AssertionError(f"serve_dense_ring checks failed: {checks}")
    tokens = sum(len(r.out_tokens) for r in reqs)
    return {"requests": len(reqs), "slots": RING_SLOTS, "ring": RING_CAP,
            "finished": eng.stats.finished, "expired": eng.stats.expired,
            "megasteps": len(step_ms), "rounds": len(step_ms) * K,
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ms_per_round": 1e3 * wall / (len(step_ms) * K),
            "host_syncs": eng.stats.host_syncs, "launches": launches,
            "sync_debug_mode": "error", "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ------------------------------------------ the host step() twin phases ---


def rid_step_fn(active):
    """The host counterpart of `engine_state.rid_token_fn`: logits that
    ARE the request-identity token (rid·1000 + tokens emitted)."""
    import numpy as np

    return np.array([r.rid * 1000 + len(r.out_tokens) for r in active],
                    np.int64)


def _ident(logits):
    return logits.astype("int64")


def rid_through(token_fn, vocab: int):
    """A megastep token function that runs ``token_fn``'s model round (its
    paged kernels write and read the pool; the rid tokens it is fed are
    taken modulo ``vocab``) and emits the rid tokens, so the megastep's
    streams are the host ``step()``'s rid streams."""
    from repro_torch.serving import engine_state as es

    def fn(model, state):
        sl = state.slots
        _, model = token_fn(model, state._replace(
            slots=sl._replace(token=sl.token % vocab)))
        return es.rid_token_fn(model, state)

    fn._chunk_window = getattr(token_fn, "_chunk_window", None)
    return fn


def step_requests(n_req: int, vocab: int, seed: int = SEED) -> list:
    """The serve trace (prompts and ``max_new`` 16–128, three tenants)
    with a quarter of the requests given deadlines on the 0.25 grid
    (10–320 virtual seconds), where the host's f64 and the card's f32
    deadline compares cannot disagree."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(16, 129)))],
        max_new_tokens=int(rng.integers(16, 129)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(0.25 * float(rng.integers(40, 1281))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]


def spans_view(spans: dict) -> dict:
    """Per request: the span's terminal, its event kinds in order and its
    critical-path breakdown (what the two serving paths must share; the
    buffers' insertion sequence numbers differ, since a megastep adds its
    expiries before the rounds' events)."""
    return {uid: (sp["terminal"], [e["kind"] for e in sp["events"]],
                  sp["breakdown"]) for uid, sp in spans.items()}


def _qos_state(eng) -> dict:
    from repro_torch.serving.engine_state import drain

    st = drain(eng.qos)
    return {f: getattr(st, f).tolist() for f in st._fields}


def _kv_sema(eng):
    from repro_torch.serving.engine_state import drain

    s = drain(eng._kv_sema)
    return (int(s.ticket), int(s.grant), s.bucket_seq.tolist())


def step_vs_megastep(torch, dev, *, S, trace, engine_kw, token_fn,
                     admit_fn=None, model=None, K=32, limit=64) -> dict:
    """The host ``step()`` and ``megastep(K)`` of two engines on one trace
    and one virtual clock (1.0 a round), each driven with the launch
    counts set to 0 just before and read just after: the megastep until
    every request resolves, then as many host steps as it ran rounds.
    Checks that the two paths are bit-identical (streams, rounds, the QoS
    state, the free pool, the block-semaphore mirror, every sample with
    its events, the trace spans) and that each host step with a live
    backlog launched the QoS kernel exactly once."""
    from repro_torch.kernels import ops
    from repro_torch.obs import build_spans
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    DT = 1.0
    clk_h, clk_m = [0.0], [0.0]
    eh = ContinuousBatchingEngine(rid_step_fn, lambda r: None, S,
                                  tenants=dict(WEIGHTS), use_kernel=True,
                                  clock=lambda: clk_h[0], device=dev,
                                  **engine_kw)
    em = ContinuousBatchingEngine(None, None, S, tenants=dict(WEIGHTS),
                                  use_kernel=True, clock=lambda: clk_m[0],
                                  device=dev, **engine_kw)
    em.megastep_model = model
    rh = [Request(**t) for t in trace]
    rm = [Request(**t) for t in trace]
    eh.submit_batch(rh)
    em.submit_batch(rm)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ms, mega_ms = [], []
    while not all(r.done_event.is_set() for r in rm):
        if len(mega_ms) == limit:
            raise AssertionError("the megastep did not resolve every "
                                 "request")
        t1 = time.perf_counter()
        em.megastep(K, token_fn=token_fn, admit_fn=admit_fn,
                    nows=[k * DT for k in range(K)])
        clk_m[0] += K * DT
        ms += em._last_samples
        mega_ms.append(1e3 * (time.perf_counter() - t1))
    torch.cuda.synchronize()
    mega_wall = time.perf_counter() - t0
    mega_launches = ops.launch_counts()

    rounds = len(mega_ms) * K
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hs, step_ms, backlog_steps = [], [], 0
    for j in range(rounds):
        clk_h[0] = j * DT
        backlog_steps += int(eh._tenant_live.sum() > 0)
        t1 = time.perf_counter()
        eh.step(_ident)
        step_ms.append(1e3 * (time.perf_counter() - t1))
        hs += eh._last_samples
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    step_launches = ops.launch_counts()

    fields = ("out_tokens", "admit_round", "expire_round", "preempted",
              "expired", "first_tok_clock", "last_tok_clock", "finish_clock")
    diff = [r.rid for r, q in zip(rh, rm)
            if any(getattr(r, f) != getattr(q, f) for f in fields)]
    qos_h, qos_m = _qos_state(eh), _qos_state(em)
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in rh + rm),
        "requests_equal": not diff,
        "qos_equal": qos_h == qos_m,
        "qos_free_equal": eh._qos_free == em._qos_free,
        "kv_free_equal": eh._kv_free_blocks == em._kv_free_blocks,
        "kv_sema_equal": _kv_sema(eh) == _kv_sema(em),
        "samples_equal": hs == ms,
        "spans_equal": spans_view(build_spans(eh._trace))
        == spans_view(build_spans(em._trace)),
        "health_zero": all(s["health"] == 0 for s in hs),
        "host_syncs": (eh.stats.host_syncs == rounds
                       and em.stats.host_syncs == len(mega_ms)),
        "one_qos_launch_per_step": (step_launches["qos_round_fused"]
                                    == backlog_steps > 0),
        "pool_drained": eh._kv_free_blocks == eh._kv_blocks,
        "finished_full_length": all(
            len(r.out_tokens) == r.max_new_tokens for r in rh
            if not r.expired),
    }
    out = {
        "requests": len(trace), "slots": S, "rounds": rounds,
        "megasteps": len(mega_ms), "finished": eh.stats.finished,
        "expired": eh.stats.expired, "preempted": eh.stats.preempted,
        "tokens": sum(len(r.out_tokens) for r in rh),
        "first_request_diff": diff[:5],
        "first_sample_diff": next(
            ([k, sorted(f for f in a if a[f] != b.get(f))]
             for k, (a, b) in enumerate(zip(hs, ms)) if a != b), None),
        "step_wall_s": step_wall, "ms_per_step": 1e3 * step_wall / rounds,
        "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
        "max_step_ms": max(step_ms),
        "megastep_wall_s": mega_wall,
        "megastep_ms_per_round": 1e3 * mega_wall / rounds,
        "steps_with_backlog": backlog_steps,
        "qos_launches_per_step_with_backlog": (
            step_launches["qos_round_fused"] / max(backlog_steps, 1)),
        "qos_launches_per_step": step_launches["qos_round_fused"] / rounds,
        "launches_step": step_launches, "launches_megastep": mega_launches,
        "launches": {k: step_launches[k] + mega_launches[k]
                     for k in step_launches},
        "host_syncs_step": eh.stats.host_syncs,
        "host_syncs_megastep": em.stats.host_syncs,
        "gate_stalls": sum(s["gate_stalls"] for s in hs),
        "parked": sum(s["parked"] for s in hs),
        "prefix_hits": eh.stats.prefix_hits,
        "cow_copies": eh.stats.cow_copies,
        "admits_per_tenant": dict(eh.tenant_admitted),
    }
    return eh, em, out, checks


def serve_step(torch, dev, *, vocab=151936, d=896) -> dict:
    """The up-front configuration at full size on the card: 256 slots,
    ``kv_pool=(2048, 16, 32)``, ``prompt_cap=128``, tenants 4:2:1, ~1000
    requests, ``use_kernel=True``; the host ``step()`` with the rid step
    function against ``megastep(32)`` over the paged-pool model at
    qwen2-0.5b's width (its paged-decode kernel runs; the rid tokens are
    emitted)."""
    from repro_torch.serving import engine_state as es

    NB, BS, _ = SERVE_POOL
    model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    eh, em, out, checks = step_vs_megastep(
        torch, dev, S=SERVE_SLOTS, trace=step_requests(SERVE_REQUESTS,
                                                       vocab),
        engine_kw=dict(backlog_cap=4096, prompt_cap=128, kv_pool=SERVE_POOL),
        token_fn=rid_through(es.paged_pool_token_fn, vocab),
        admit_fn=es.paged_pool_admit_fn, model=model)
    launches = out["launches"]
    checks.update({
        "block_gate_stalled": out["gate_stalls"] > 0,
        "deadlines_hit": out["expired"] > 0,
        "kernels_launched": (launches["qos_round_fused"] > 0
                             and launches["paged_decode"] > 0),
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_step checks failed: {checks} {out}")
    return {**out, "checks": checks, "sync_debug_mode": "error (megastep)",
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_step_chunked(torch, dev, *, vocab=151936, d=896) -> dict:
    """The chunked configuration with prefix sharing at full size: 256
    slots, ``kv_pool=(4096, 16, 72)``, ``prompt_cap=1024``,
    ``chunked_prefill=(64, 1024, 6144)``, ``prefix_cache=8192``, the
    serve_chunked trace; the host ``step()`` with the rid step function
    against ``megastep(32)`` over the paged-pool model (its paged-prefill
    and paged-decode kernels run; the rid tokens are emitted).  Slots
    must park, prefixes hit and blocks copy on write; after the run the
    host replica must equal the device pool (refcounts, table, free
    queue)."""
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import drain

    NB, BS, _ = CHUNK_POOL
    model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    eh, em, out, checks = step_vs_megastep(
        torch, dev, S=CHUNK_SLOTS, trace=chunked_requests(CHUNK_REQUESTS,
                                                          vocab),
        engine_kw=dict(backlog_cap=4096, prompt_cap=CHUNK_PROMPT_CAP,
                       kv_pool=CHUNK_POOL, chunked_prefill=CHUNKED,
                       prefix_cache=PREFIX_ENTRIES),
        token_fn=rid_through(es.make_chunked_prefill_token_fn(CHUNKED[0]),
                             vocab),
        model=model, limit=40)
    rep = drain((eh._kv_hpool.refcnt, eh._kv_htbl, eh._kv_hpool.free_q,
                 eh._kv_hpool.gen))
    dev_pool = drain((em._kv_state.pool.refcnt, em._kv_state.tbl,
                      em._kv_state.pool.free_q, em._kv_state.pool.gen))
    launches = out["launches"]
    checks.update({
        "parked": out["parked"] > 0,
        "prefix_hits": out["prefix_hits"] > 0,
        "cow_copies": out["cow_copies"] > 0,
        "replica_equals_device_pool": all(
            (a == b).all() for a, b in zip(rep, dev_pool)),
        "kernels_launched": all(launches[k] > 0 for k in (
            "qos_round_fused", "paged_decode", "paged_prefill")),
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_step_chunked checks failed: {checks} "
                             f"{out}")
    return {**out, "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def qos_model_requests(vocab: int, seed: int = SEED) -> list:
    """The serve_model_qos trace as ``Request`` keyword dicts: prompts and
    ``max_new`` 16–64 tokens, three tenants, a quarter with deadlines on
    the 0.25 grid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*MODEL_PROMPT)))],
        max_new_tokens=int(rng.integers(*MODEL_NEW)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(0.25 * float(rng.integers(40, 401))
                  if rng.random() < 0.25 else None))
        for i in range(QOS_MODEL_REQUESTS)]


def serve_model_qos(torch, dev, cfg=None) -> dict:
    """The multi-tenant host ``step()`` at full model width:
    `launch.serve.ModelServer` over the full qwen2-0.5b config (by
    default; random weights from the seed), 8 slots, tenants 4:2:1,
    ``use_kernel=True``, 16 requests, against the same trace through a CPU
    engine with the rid step function: admission does not depend on the
    logits (requests finish at ``max_new``), so the admission and finish
    rounds, slots and every sample with its events must be equal; every
    logit must be finite."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cfg = cfg or get_config("qwen2-0.5b")
    trace = qos_model_requests(cfg.vocab)
    server = ModelServer("qwen2-0.5b", MODEL_SLOTS, max_len=MODEL_MAX_LEN,
                         seed=SEED, config=cfg, device=dev)
    finite = []

    def step_fn(reqs):
        logits = server.step_fn(reqs)
        finite.append(bool(np.isfinite(logits).all()))
        return logits

    def prefill_fn(req):
        server.prefill_request(req)
        finite.append(bool(np.isfinite(req._last_logits).all()))

    runs = {}
    for kind in ("model", "rid"):
        d = dev if kind == "model" else torch.device("cpu")
        clk = [0.0]
        eng = ContinuousBatchingEngine(
            step_fn if kind == "model" else rid_step_fn,
            prefill_fn if kind == "model" else (lambda r: None),
            MODEL_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
            clock=lambda: clk[0], device=d)
        reqs = [Request(**t) for t in trace]
        if kind == "model":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.submit_batch(reqs)
        samples, steps, backlog_steps = [], 0, 0
        while not all(r.done_event.is_set() for r in reqs):
            if steps == 5000:
                raise AssertionError("serve_model_qos did not resolve "
                                     "every request")
            clk[0] = float(steps)
            backlog_steps += int(eng._tenant_live.sum() > 0)
            eng.step(lambda lg: lg.argmax(-1) if kind == "model"
                     else _ident(lg))
            samples += eng._last_samples
            steps += 1
        if kind == "model":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        runs[kind] = (eng, reqs, samples, time.perf_counter() - t0,
                      backlog_steps)
    (em, rm, sm, wall, backlog_steps), (ec, rc, sc, _, _) = \
        runs["model"], runs["rid"]
    view = [(r.admit_round, r.expire_round, r.slot, r.preempted, r.expired,
             len(r.out_tokens)) for r in rm]
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in rm),
        "rounds_slots_equal": view == [
            (r.admit_round, r.expire_round, r.slot, r.preempted, r.expired,
             len(r.out_tokens)) for r in rc],
        "samples_equal": sm == sc,
        "stats_equal": all(getattr(em.stats, f) == getattr(ec.stats, f)
                           for f in ("admitted", "finished", "expired",
                                     "preempted", "steps", "host_syncs")),
        "logits_finite": all(finite) and bool(finite),
        "health_zero": all(s["health"] == 0 for s in sm),
        "finished_full_length": all(len(r.out_tokens) == r.max_new_tokens
                                    for r in rm if not r.expired),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for r in rm
                               for t in r.out_tokens),
        "one_qos_launch_per_step": (launches["qos_round_fused"]
                                    == backlog_steps > 0),
        "decode_attention_launched": launches["decode_attention"] > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"serve_model_qos checks failed: {checks}")
    steps = len(sm)
    tokens = sum(len(r.out_tokens) for r in rm)
    return {"config": cfg.name, "layers": cfg.n_layers, "slots": MODEL_SLOTS,
            "requests": len(trace), "steps": steps,
            "finished": em.stats.finished, "expired": em.stats.expired,
            "preempted": em.stats.preempted, "tokens": tokens,
            "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
            "tokens_per_s": tokens / wall,
            "steps_with_backlog": backlog_steps,
            "qos_launches_per_step_with_backlog": (
                launches["qos_round_fused"] / max(backlog_steps, 1)),
            "qos_launches_per_step": launches["qos_round_fused"] / steps,
            "host_syncs": em.stats.host_syncs, "launches": launches,
            "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ------------------------------------------------- the resilience phases ---


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_checkpoint(torch, directory: str, keep: int = 3):
    """A `CheckpointManager` (``keep`` steps) that records each
    ``save_sync`` and ``restore`` in ms, the device synchronised before
    and after."""
    from repro_torch.checkpoint.manager import CheckpointManager

    class Timed(CheckpointManager):
        def __init__(self):
            super().__init__(directory, keep=keep)
            self.save_ms, self.restore_ms = [], []

        def save_sync(self, step, tree):
            _sync(torch)
            t0 = time.perf_counter()
            super().save_sync(step, tree)
            self.save_ms.append(1e3 * (time.perf_counter() - t0))

        def restore(self, proto, step=None):
            _sync(torch)
            t0 = time.perf_counter()
            try:
                return super().restore(proto, step)
            finally:
                _sync(torch)
                self.restore_ms.append(1e3 * (time.perf_counter() - t0))

    return Timed()


def ladder_counts(rz) -> dict:
    """How often the ladder took each action (injections by kind)."""
    out: dict = {}
    for e in rz.events:
        key = e["action"] if e["action"] != "inject" else \
            f"inject:{e['kind']}" + ("" if e["applied"] else " (no target)")
        out[key] = out.get(key, 0) + 1
    return out


def serve_resilient(torch, dev, *, S=CHUNK_SLOTS, n_req=CHUNK_REQUESTS,
                    pool=CHUNK_POOL, prompt_cap=CHUNK_PROMPT_CAP,
                    chunked=CHUNKED, vocab=151936, d=896) -> tuple:
    """The serve_step_chunked configuration without the prefix cache (a
    reference fault under sharing, ROADMAP queue 3) under one seeded
    `FaultPlan` of capacity faults (dropped pokes, counter leaks, stuck
    slots) in the first half of the run, a watchdog, reactions every 4
    rounds: a host-``step()`` `ResilientEngine` with the rid step function
    and a megastep one (a call a reaction window) over the paged-pool model
    emitting the rid tokens, on one virtual clock (1.0 a round), each
    driven with the launch counts set to 0 just before and read just
    after.  Returns ``(out, checks)``."""

    from repro_torch.kernels import ops
    from repro_torch.resilience import (CAPACITY_KINDS, FaultPlan,
                                        ResilientEngine, exit_audit)
    from repro_torch.serving import engine_state as es
    from repro_torch.serving import sentinels as sn
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    DT = 1.0
    plan = FaultPlan.random(RESILIENT_SEED, rounds=RESILIENT_FAULT_ROUNDS,
                            n_faults=RESILIENT_FAULTS, kinds=CAPACITY_KINDS)
    trace = chunked_requests(n_req, vocab)
    kw = dict(tenants=dict(WEIGHTS), use_kernel=True, device=dev,
              backlog_cap=4096, prompt_cap=prompt_cap, kv_pool=pool,
              chunked_prefill=chunked, watchdog=RESILIENT_WATCHDOG)
    clk, clk_m = [0.0], [0.0]
    eh = ContinuousBatchingEngine(rid_step_fn, lambda r: None, S,
                                  clock=lambda: clk[0], **kw)
    em = ContinuousBatchingEngine(None, None, S, clock=lambda: clk_m[0],
                                  **kw)
    NB, BS, _ = pool
    em.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    token_fn = rid_through(es.make_chunked_prefill_token_fn(chunked[0]),
                           vocab)
    rzh = ResilientEngine(eh, plan=plan, react_every=REACT_EVERY, seed=SEED)
    rzm = ResilientEngine(em, plan=plan, react_every=REACT_EVERY, seed=SEED)
    rh = [Request(**t) for t in trace]
    rm = [Request(**t) for t in trace]
    eh.submit_batch(rh)
    em.submit_batch(rm)

    def drained(rz, reqs):
        return (all(r.done_event.is_set() for r in reqs) and not rz._retryq
                and not rz.engine.active)

    _sync(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    while not drained(rzm, rm):
        if em._round_no >= 1600:
            raise AssertionError("serve_resilient: the megastep did not "
                                 "drain")
        # one call a reaction window, the engine's clock at its first
        # round: a requeue at the boundary then reads the clock the host
        # step reads (a request whose deadline passed is dead on arrival
        # on both paths)
        clk_m[0] = em._round_no * DT
        rzm.megastep(REACT_EVERY, token_fn=token_fn,
                     nows=[k * DT for k in range(REACT_EVERY)])
    _sync(torch)
    mega_wall = time.perf_counter() - t0
    mega_launches = ops.launch_counts()
    rounds = em._round_no

    # the host drive: as many rounds; each engine step() with a live
    # backlog must launch the QoS kernel exactly once
    backlog_steps = [0]
    inner = eh.step

    def step(fn):
        backlog_steps[0] += int(eh._tenant_live.sum() > 0)
        return inner(fn)

    eh.step = step
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stall = 0  # the longest a busy slot went without progress
    for j in range(rounds):
        clk[0] = j * DT
        rzh.step(_ident)
        stall = max([stall] + [eh._round_no - 1 - r.last_adv_round
                               for r in eh.active.values()])
    _sync(torch)
    step_wall = time.perf_counter() - t0
    step_launches = ops.launch_counts()

    mask = sn.HEALTH_MIRRORED_MASK
    stats = ("admitted", "finished", "expired", "preempted", "quarantined",
             "requeued", "kv_audits", "kernel_fallbacks", "kv_block_stalls",
             "prefill_chunks")
    fields = ("out_tokens", "retries", "admit_round", "expire_round",
              "expired", "preempted")
    diff = [r.rid for r, q in zip(rh, rm)
            if any(getattr(r, f) != getattr(q, f) for f in fields)]
    sh = [dict(s, health=s["health"] & mask) for s in rzh.samples]
    sm = [dict(s, health=s["health"] & mask) for s in rzm.samples]
    acts_h = [(e["round"], e["action"]) for e in rzh.events]
    acts_m = [(e["round"], e["action"]) for e in rzm.events]
    audit_h, audit_m = exit_audit(eh), exit_audit(em)
    checks = {
        "both_drained": drained(rzh, rh) and drained(rzm, rm),
        "requests_equal": not diff,
        "samples_equal": sh == sm,
        "stats_equal": all(getattr(eh.stats, f) == getattr(em.stats, f)
                           for f in stats),
        "qos_equal": _qos_state(eh) == _qos_state(em),
        "qos_free_equal": eh._qos_free == em._qos_free,
        "kv_free_equal": eh._kv_free_blocks == em._kv_free_blocks,
        "ladder_equal": acts_h == acts_m,
        "exit_audit_ok": audit_h["ok"] and audit_m["ok"],
        "quarantined": any(a == "quarantine" for _, a in acts_m),
        "audited": any(a == "audit_kv" for _, a in acts_m),
        "no_kernel_fallback": (eh.stats.kernel_fallbacks
                               == em.stats.kernel_fallbacks == 0),
        "one_qos_launch_per_step": (step_launches["qos_round_fused"]
                                    == backlog_steps[0] > 0),
    }
    out = {
        "requests": n_req, "slots": S, "rounds": rounds,
        "plan": [[e.round, e.kind, e.delta, e.arg] for e in plan.events],
        "watchdog": RESILIENT_WATCHDOG, "react_every": REACT_EVERY,
        "longest_stall_rounds": stall,
        "ladder": ladder_counts(rzm),
        "ladder_host": ladder_counts(rzh),
        "stats": {f: getattr(em.stats, f) for f in stats},
        "first_request_diff": diff[:5],
        "first_sample_diff": next(
            ([k, sorted(f for f in a if a[f] != b.get(f))]
             for k, (a, b) in enumerate(zip(sh, sm)) if a != b), None),
        "exit_audit": [audit_h, audit_m],
        "ms_per_step": 1e3 * step_wall / rounds,
        "megastep_ms_per_round": 1e3 * mega_wall / rounds,
        "step_wall_s": step_wall, "megastep_wall_s": mega_wall,
        "host_syncs_step": eh.stats.host_syncs,
        "host_syncs_megastep": em.stats.host_syncs,
        "steps_with_backlog": backlog_steps[0],
        "qos_launches_per_step_with_backlog": (
            step_launches["qos_round_fused"] / max(backlog_steps[0], 1)),
        "launches_step": step_launches, "launches_megastep": mega_launches,
        "launches": {k: step_launches[k] + mega_launches[k]
                     for k in step_launches},
    }
    return out, checks


def _upfront_run(torch, dev, plan, *, trace, ckpt=None, snapshot_every=0,
                 first_k=None, vocab=151936, d=896, S=SERVE_SLOTS,
                 pool=SERVE_POOL):
    """The up-front configuration (`serve_step`'s: 256 slots, the 2048×16
    pool, tenants 4:2:1, ``use_kernel=True``) served by megastep over the
    paged-pool model emitting the rid tokens, as a `ResilientEngine` under
    ``plan`` (reactions every 4 rounds) until every request resolves, in
    calls of one snapshot stride (a restore then never rewinds past the
    call's first round).  ``first_k``: the rounds of the first call (one
    call over the whole run lets a restore rewind to any snapshot).  Returns ``(rz, eng, reqs,
    wall seconds)``."""
    from repro_torch.resilience import ResilientEngine
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    NB, BS, _ = pool
    eng = ContinuousBatchingEngine(
        None, None, S, tenants=dict(WEIGHTS), use_kernel=True,
        clock=lambda: 0.0, device=dev, backlog_cap=4096, prompt_cap=128,
        kv_pool=pool)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    rz = ResilientEngine(eng, plan=plan, react_every=REACT_EVERY, seed=SEED,
                         ckpt=ckpt, snapshot_every=snapshot_every)
    reqs = [Request(**t) for t in trace]
    eng.submit_batch(reqs)
    token_fn = rid_through(es.paged_pool_token_fn, vocab)
    t0 = time.perf_counter()
    k = first_k or RECOVER_SNAPSHOT_EVERY
    while not (all(r.done_event.is_set() for r in reqs) and not rz._retryq
               and not eng.active):
        if eng._round_no >= 1600:
            raise AssertionError("recover_megastep: a run did not drain")
        b = eng._round_no
        rz.megastep(k, token_fn=token_fn, admit_fn=es.paged_pool_admit_fn,
                    nows=[float(b + j) for j in range(k)])
        k = RECOVER_SNAPSHOT_EVERY
    _sync(torch)
    wall = time.perf_counter() - t0
    eng.megastep_model = None  # free the model before the next run
    return rz, eng, reqs, wall


def recover_megastep(torch, dev, *, vocab=151936, d=896, S=SERVE_SLOTS,
                     pool=SERVE_POOL, n_req=SERVE_REQUESTS) -> tuple:
    """Rung 4 at the up-front configuration's full width, by megastep,
    with a `CheckpointManager` (keep=3) in a temporary directory that is
    removed at the end: (1) crash replay — the capacity plan plus one
    CRASH converges to the uncrashed run of the same plan; (2) corruption
    — DOUBLE_RELEASE, BIT_FLIP and KV_COUNTER(+) (audited) then NAN_LOGIT
    (restored) drain with a clean exit audit; (3) a torn shard — the
    newest snapshot torn, then a CRASH, so the restore falls back to the
    one before it, in one megastep over the whole run.  The launch counts
    are set to 0 just before the runs and read just after.  Returns
    ``(out, checks)``."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.resilience import (CAPACITY_KINDS, BIT_FLIP, CRASH,
                                        DOUBLE_RELEASE, KV_COUNTER,
                                        NAN_LOGIT, TORN_SHARD, FaultEvent,
                                        FaultPlan, exit_audit)

    trace = step_requests(n_req, vocab)
    capacity = FaultPlan.random(RECOVER_SEED, rounds=RECOVER_FAULT_ROUNDS,
                                n_faults=4, kinds=CAPACITY_KINDS)
    corrupt = FaultPlan(seed=0, events=tuple(
        FaultEvent(round=r, kind=k, delta=dl, arg=a)
        for r, k, dl, a in ((20, DOUBLE_RELEASE, 0, 0),
                            (36, BIT_FLIP, 2, 5),
                            (52, KV_COUNTER, 3, 0),
                            (150, NAN_LOGIT, 0, 0))))
    torn = FaultPlan(seed=0, events=(FaultEvent(round=140, kind=TORN_SHARD),
                                     FaultEvent(round=150, kind=CRASH)))
    root = Path(tempfile.mkdtemp(prefix="recover_megastep_"))
    runs, ckpts, walls = {}, {}, {}
    try:
        _sync(torch)
        ops.reset_launch_counts()
        for name, plan, ck, first_k in (
                ("clean", capacity, False, None),
                ("crash", capacity.with_crash(RECOVER_CRASH_ROUND), True,
                 None),
                ("corrupt", corrupt, True, None),
                ("torn", torn, True, RECOVER_ONE_CALL)):
            ckpts[name] = (timed_checkpoint(torch, str(root / name))
                           if ck else None)
            rz, eng, reqs, walls[name] = _upfront_run(
                torch, dev, plan, trace=trace, ckpt=ckpts[name],
                snapshot_every=RECOVER_SNAPSHOT_EVERY if ck else 0,
                first_k=first_k, vocab=vocab, d=d, S=S, pool=pool)
            runs[name] = (rz, eng, reqs)
            if ck:  # each run's snapshots go once the run is checked
                shutil.rmtree(root / name, ignore_errors=True)
        _sync(torch)
        launches = ops.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def view(reqs):
        return [(r.out_tokens, r.admit_round, r.expire_round, r.expired)
                for r in reqs]

    def drained(name):
        rz, eng, reqs = runs[name]
        return all(r.done_event.is_set() for r in reqs) and not eng.active

    (z0, e0, r0), (z1, e1, r1) = runs["clean"], runs["crash"]
    zc, ec, _ = runs["corrupt"]
    zt, et, _ = runs["torn"]
    audits = {n: exit_audit(runs[n][1]) for n in runs}
    checks = {
        "all_drained": all(drained(n) for n in runs),
        "exit_audits_ok": all(a["ok"] for a in audits.values()),
        "crash_streams_rounds_equal": view(r1) == view(r0),
        "crash_qos_grant_equal": _qos_state(e1)["grant"]
        == _qos_state(e0)["grant"],
        "crash_finished_equal": e1.stats.finished == e0.stats.finished,
        "crash_restored": e1.stats.restores >= 1 and e0.stats.restores == 0,
        "corrupt_audited": ec.stats.kv_audits >= 1,
        "corrupt_restored": ec.stats.restores >= 1,
        "corrupt_nan_cleared": (not ec._nonfinite_sticky
                                and zc.samples[-1]["health"] == 0),
        "corrupt_nan_seen": any(s["health"] & (1 << 17)
                                for s in zc.samples),
        "torn_fallback": any(e["action"] == "torn_shard_fallback"
                             for e in zt.events),
        "torn_restored": et.stats.restores >= 1,
        "kernels_launched": (launches["qos_round_fused"] > 0
                             and launches["paged_decode"] > 0),
    }
    out = {
        "requests": len(trace), "slots": S,
        "snapshot_every": RECOVER_SNAPSHOT_EVERY, "react_every": REACT_EVERY,
        "crash_round": RECOVER_CRASH_ROUND,
        "plans": {"capacity": [[e.round, e.kind, e.delta]
                               for e in capacity.events],
                  "corrupt": [[e.round, e.kind, e.delta]
                              for e in corrupt.events],
                  "torn": [[e.round, e.kind] for e in torn.events]},
        "runs": {n: {"rounds": runs[n][1]._round_no,
                     "rounds_executed": len(runs[n][0].samples),
                     "wall_s": walls[n],
                     "ms_per_round": 1e3 * walls[n]
                     / max(len(runs[n][0].samples), 1),
                     "host_syncs": runs[n][1].stats.host_syncs,
                     "ladder": ladder_counts(runs[n][0]),
                     "restores": runs[n][1].stats.restores,
                     "snapshots": runs[n][1].stats.snapshots,
                     "kv_audits": runs[n][1].stats.kv_audits,
                     "quarantined": runs[n][1].stats.quarantined,
                     "kernel_fallbacks": runs[n][1].stats.kernel_fallbacks,
                     "snapshot_save_ms": (ckpts[n].save_ms
                                          if ckpts[n] else []),
                     "restore_ms": ckpts[n].restore_ms if ckpts[n] else [],
                     "exit_audit": audits[n]}
                 for n in runs},
        "launches": launches,
    }
    return out, checks



# ------------------------------------------------------- serving fabric ---


def cluster_view(r, rep) -> dict:
    """What a router run must repeat on another device: completed streams,
    ``shed`` with reasons, the report (`RouterStats`, lease and engine
    audits, the reaper's telemetry), the router's events, the reaper's
    actions, each replica's liveness and breaker, each request's record
    and its cluster span (terminal, segment kinds with the replica that
    ran them, replicas visited, migrations, suppressed duplicates)."""
    spans = r.cluster_spans()
    return {
        "report": rep, "completed": dict(r.completed), "shed": dict(r.shed),
        "events": list(r.events),
        "reaper": [(a.lease, a.ticket, a.action, a.age)
                   for a in r.reaper.actions],
        "replicas": [(x.idx, x.alive, x.process_alive, x.dead_round,
                      x.dead_reason, x.breaker.state, x.breaker.trips,
                      x.driven_rounds, x.lease.headroom())
                     for x in r.replicas],
        "requests": {rid: (cr.state, cr.tokens, cr.shed_reason, cr.retries,
                           cr.attempts, cr.completed_by, cr.finish_clock)
                     for rid, cr in r.requests.items()},
        "spans": {rid: (sp["terminal"],
                        [(g["name"], g["replica"]) for g in sp["segments"]],
                        sp["replicas"], sp["migrations"],
                        sp["duplicates_suppressed"])
                  for rid, sp in spans.items()},
    }


def cluster_parity(torch, dev) -> tuple:
    """The CPU tests' chaos scenario (`tests/test_torch_router.py`,
    ``CHAOS_SEEDS``): ``toy_cluster(4, plan=FaultPlan.cluster(seed,
    rounds=8, n_replicas=4), standby=True, snapshot_every=4)`` over
    ``toy_workload(10, seed + 1)`` on the card and on the CPU, the launch
    counts set to 0 just before the card's runs and read just after.
    Returns ``(out, checks)``; the card's `cluster_view` must equal the
    CPU's at every seed, and at seed 866 both deliver rid 5 with the
    reference's 3 tokens (ROADMAP queue 3)."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultPlan
    from repro_torch.serving.router import toy_cluster, toy_workload

    def run(seed, where):
        r = toy_cluster(4, seed=seed, device=where, standby=True,
                        snapshot_every=4,
                        plan=FaultPlan.cluster(seed, rounds=8, n_replicas=4))
        r.submit_batch(toy_workload(10, seed=seed + 1))
        t0 = time.perf_counter()
        try:
            rep = r.run(max_rounds=150)
        finally:  # toy_cluster's checkpoint directories
            for x in r.replicas:
                shutil.rmtree(x.rz.ckpt.dir, ignore_errors=True)
        return r, cluster_view(r, rep), time.perf_counter() - t0

    cpu = {seed: run(seed, "cpu") for seed in CLUSTER_SEEDS}
    _sync(torch)
    ops.reset_launch_counts()
    card = {seed: run(seed, dev) for seed in CLUSTER_SEEDS}
    _sync(torch)
    launches = ops.launch_counts()
    equal = {seed: card[seed][1] == cpu[seed][1] for seed in CLUSTER_SEEDS}
    diff = {seed: sorted(k for k in card[seed][1]
                         if card[seed][1][k] != cpu[seed][1][k])
            for seed in CLUSTER_SEEDS if not equal[seed]}
    checks = {
        "card_equals_cpu": all(equal.values()),
        "seed_866_three_tokens": (
            866 not in CLUSTER_SEEDS
            or card[866][0].completed.get(5) == [5000, 5001, 5002]
            == cpu[866][0].completed.get(5)),
        "qos_kernel_launched": launches["qos_round_fused"] > 0,
    }
    out = {
        "seeds": list(CLUSTER_SEEDS), "first_diff": diff,
        "per_seed": {seed: {
            "stats": card[seed][1]["report"]["stats"],
            "shed": card[seed][1]["shed"],
            "rounds": card[seed][1]["report"]["rounds"],
            "card_s": card[seed][2], "cpu_s": cpu[seed][2]}
            for seed in CLUSTER_SEEDS},
        "launches": launches,
    }
    return out, checks


def cluster_router(torch, dev, *, trace, emb_wo, root, plan=None,
                   standby=False, snapshot_every=0, vocab=151936):
    """`serve_cluster`'s router: CLUSTER_REPLICAS replicas of the
    serve_resilient configuration (chunked prefill, no prefix cache,
    tenants 4:2:1, ``use_kernel=True``, its watchdog; reactions once a
    router round) cut to CLUSTER_SLOTS slots and the CLUSTER_POOL pool at
    qwen2-0.5b's width, sharing the weights ``emb_wo`` (each its own
    pools), one virtual clock and one KV store, driven through the paged
    kernels by the shared rid-emitting token function.  With ``snapshot_every`` each
    replica (and each successor ``standby`` builds) has its own timed
    `CheckpointManager` under ``root``.  Every engine megastep is timed
    and its host syncs counted; the first one after ``prof["want"]`` is
    set runs under ``torch.profiler`` (device kernels only) instead of
    being timed.  Returns ``(router, ckpts, calls, prof)``."""
    import tempfile

    from repro_torch.resilience import ResilientEngine
    from repro_torch.runtime.coordinator import KVStore
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.router import ClusterRequest, ReplicaRouter
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    NB, BS, _ = CLUSTER_POOL
    clk = [0.0]
    ckpts, calls = [], []  # calls: (K, wall s, host syncs it added)
    prof = {"want": False}

    def build_rz():
        eng = ContinuousBatchingEngine(
            None, None, CLUSTER_SLOTS, tenants=dict(WEIGHTS),
            use_kernel=True, device=dev, clock=lambda: clk[0],
            backlog_cap=4096, prompt_cap=CHUNK_PROMPT_CAP,
            kv_pool=CLUSTER_POOL, chunked_prefill=CHUNKED,
            watchdog=RESILIENT_WATCHDOG)
        pool = dict(dtype=torch.float32, device=dev)
        eng.megastep_model = {
            **emb_wo, "kp": torch.zeros((NB, BS, 1, emb_wo["emb"].shape[1]),
                                        **pool),
            "vp": torch.zeros((NB, BS, 1, emb_wo["emb"].shape[1]), **pool)}
        inner = eng.megastep

        def megastep(K, **kw):
            h0 = eng.stats.host_syncs
            if prof["want"]:  # one call under the profiler, not timed
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                prof["want"] = False
                _sync(torch)
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    n = inner(K, **kw)
                    _sync(torch)
                kernels = [e for e in p.key_averages()
                           if e.device_type == DeviceType.CUDA]
                prof.update(K=K, wall_s=time.perf_counter() - t0,
                            syncs=eng.stats.host_syncs - h0,
                            device_s=sum(e.self_device_time_total
                                         for e in kernels) / 1e6,
                            kernel_events=sum(e.count for e in kernels))
                return n
            t0 = time.perf_counter()
            n = inner(K, **kw)
            calls.append((K, time.perf_counter() - t0,
                          eng.stats.host_syncs - h0))
            return n

        eng.megastep = megastep
        ck = None
        if snapshot_every:
            ck = timed_checkpoint(torch, tempfile.mkdtemp(dir=root), keep=2)
            ckpts.append(ck)
        return ResilientEngine(eng, plan=None, react_every=CLUSTER_INNER_K,
                               retry_budget=2, seed=SEED, ckpt=ck,
                               snapshot_every=snapshot_every)

    token_fn = rid_through(es.make_chunked_prefill_token_fn(CHUNKED[0]),
                           vocab)
    router = ReplicaRouter(
        [build_rz() for _ in range(CLUSTER_REPLICAS)], kv=KVStore(),
        clk=clk, token_fn=token_fn, capacity=CLUSTER_LEASE,
        ttl=CLUSTER_TTL_ROUNDS * CLUSTER_INNER_K * CLUSTER_DT,
        dt=CLUSTER_DT, inner_k=CLUSTER_INNER_K, plan=plan, seed=SEED,
        standby_factory=build_rz if standby else None)
    router.submit_batch([ClusterRequest(**t) for t in trace])
    return router, ckpts, calls, prof


def serve_cluster(torch, dev, *, vocab=151936, d=896) -> tuple:
    """Four full-width replicas failing over on one card: `cluster_router`
    over CLUSTER_REQUESTS requests of the serve_chunked trace, first
    fault-free, then under one ``FaultPlan.cluster`` (a replica killed
    mid-megastep, a straggler, a KV partition, a leaked lease ticket) with
    a standby factory and snapshots; each run with the launch counts set
    to 0 just before and read just after.  One router round of the
    fault-free run has its first replica megastep profiled (the device's
    busy share: its kernel time over the mean wall of the unprofiled
    megasteps of as many rounds).  Returns ``(out, checks)``."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultPlan, exit_audit

    trace = [{k: t[k] for k in ("rid", "prompt", "max_new_tokens",
                                "tenant_id", "deadline")}
             for t in chunked_requests(CLUSTER_REQUESTS, vocab)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    emb_wo = {"emb": torch.randn((vocab, d), generator=g, device=dev) * 0.05,
              "wo": torch.randn((d, d), generator=g, device=dev) * 0.05}
    plan = FaultPlan.cluster(CLUSTER_PLAN_SEED, rounds=CLUSTER_PLAN_ROUNDS,
                             n_replicas=CLUSTER_REPLICAS)
    root = Path(tempfile.mkdtemp(prefix="serve_cluster_"))
    runs = {}
    try:
        for name, kw in (("fault_free", {}),
                         ("faults", dict(plan=plan, standby=True,
                                         snapshot_every=
                                         CLUSTER_SNAPSHOT_EVERY))):
            r, ckpts, calls, prof = cluster_router(
                torch, dev, trace=trace, emb_wo=emb_wo, root=root,
                vocab=vocab, **kw)
            round_s = []
            inner = r.round

            def timed_round(r=r, inner=inner, round_s=round_s, prof=prof,
                            name=name):
                profiled = (name == "fault_free"
                            and r.round_no == CLUSTER_PROFILE_AT)
                prof["want"] = profiled
                _sync(torch)
                t0 = time.perf_counter()
                inner()
                _sync(torch)
                if not profiled:  # the profiled round is left out
                    round_s.append(time.perf_counter() - t0)

            r.round = timed_round
            _sync(torch)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = r.run(max_rounds=CLUSTER_MAX_ROUNDS)
            _sync(torch)
            wall = time.perf_counter() - t0
            runs[name] = dict(router=r, report=rep, ckpts=ckpts, calls=calls,
                              round_s=round_s, prof=prof, wall=wall,
                              launches=ops.launch_counts())
    finally:
        shutil.rmtree(root, ignore_errors=True)

    base, run = runs["fault_free"]["router"], runs["faults"]["router"]
    rep = runs["faults"]["report"]
    rids = {t["rid"] for t in trace}
    done, shed = set(run.completed), set(rep["shed"])
    # the reference's fault (ROADMAP queue 3): rids a successor adopted
    # from a replica that was still running (fenced later) — two engines
    # append to one attempt's stream
    fenced = {e["replica"] for e in run.events if e["action"] == "fenced"}
    touched = sorted({rid for e in run.events
                      if e["action"] == "warm_takeover"
                      and e["dead"] in fenced for rid in e["adopted"]})
    both = done & set(base.completed)
    differ = sorted(rid for rid in both
                    if run.completed[rid] != base.completed[rid])
    def fate(r, rid):
        if rid in r.completed:
            return f"{len(r.completed[rid])} tokens"
        return f"shed ({r.shed.get(rid)})"

    for rid in touched:  # each listed and counted, none dropped silently
        print(f"serve_cluster: rid {rid} adopted from a replica still "
              f"driven: {fate(run, rid)}, fault-free {fate(base, rid)}",
              flush=True)
    kills = {e["replica"]: e["round"] for e in run.events
             if e["action"] == "replica_killed"}
    dead_at = {e["replica"]: e["round"] for e in run.events
               if e["action"] == "replica_dead"}
    audits = {i: exit_audit(x.eng) for i, x in enumerate(run.replicas)
              if x.process_alive}
    launches = {k: sum(runs[n]["launches"][k] for n in runs)
                for k in runs["faults"]["launches"]}
    calls = runs["fault_free"]["calls"] + runs["faults"]["calls"]
    prof = runs["fault_free"]["prof"]
    same_k = [w for k, w, _ in calls if k == prof.get("K")]
    saves = [ms for ck in runs["faults"]["ckpts"] for ms in ck.save_ms]
    restores = [ms for ck in runs["faults"]["ckpts"] for ms in ck.restore_ms]
    st = rep["stats"]
    checks = {
        "exactly_once": done | shed == rids and not done & shed,
        "shed_reasons": all(v in ("deadline", "retry_budget")
                            for v in rep["shed"].values()),
        "fault_free_exactly_once": (
            set(base.completed) | set(base.shed) == rids),
        "reaped": rep["reaper"]["reaped"] >= 1,
        "lease_audit_ok": rep["lease_audit"]["ok"],
        "engine_audits_ok": all(a["ok"] for a in audits.values()),
        "streams_equal_but_touched": set(differ) <= set(touched),
        "failover": st["adopted"] + st["migrated"] >= 1,
        "killed_and_detected": bool(kills) and set(kills) <= set(dead_at),
        "one_host_sync_a_megastep": (all(h == 1 for _, _, h in calls)
                                     and prof.get("syncs", 1) == 1),
        "kernels_launched": all(runs[n]["launches"][k] > 0 for n in runs
                                for k in ("qos_round_fused", "paged_decode",
                                          "paged_prefill")),
    }
    n_rounds = {n: runs[n]["report"]["rounds"] for n in runs}
    out = {
        "replicas": CLUSTER_REPLICAS, "slots": CLUSTER_SLOTS,
        "lease": CLUSTER_LEASE,
        "pool": list(CLUSTER_POOL), "requests": len(trace),
        "inner_k": CLUSTER_INNER_K,
        "snapshot_every": CLUSTER_SNAPSHOT_EVERY,
        "plan": [[e.round, e.kind, e.delta, e.arg] for e in plan.events],
        "rounds": n_rounds,
        "wall_s": {n: runs[n]["wall"] for n in runs},
        "ms_per_router_round": {
            n: 1e3 * sum(runs[n]["round_s"]) / max(len(runs[n]["round_s"]),
                                                   1) for n in runs},
        "ms_per_replica_megastep": 1e3 * sum(w for _, w, _ in calls)
        / max(len(calls), 1),
        "ms_per_engine_round": 1e3 * sum(w for _, w, _ in calls)
        / max(sum(k for k, _, _ in calls), 1),
        "replica_megasteps": len(calls) + 1,
        "launches_per_router_round": {
            n: sum(runs[n]["launches"].values()) / max(n_rounds[n], 1)
            for n in runs},
        "launches_by_run": {n: runs[n]["launches"] for n in runs},
        "snapshot_save_ms": saves, "takeover_restore_ms": restores,
        "kill_to_reap_rounds": {i: dead_at.get(i, -1) - k
                                for i, k in kills.items()},
        "migration_latency_s": {  # None: no migration (NaN is not JSON)
            k: (None if v != v else v)
            for k, v in run.migration_hist.percentiles().items()},
        "delivered_per_wall_s": {
            n: len(runs[n]["router"].completed) / runs[n]["wall"]
            for n in runs},
        "profiled_megastep": {k: v for k, v in prof.items() if k != "want"},
        "device_busy_share": (prof["device_s"] * len(same_k) / sum(same_k)
                              if same_k else None),
        "device_busy_share_of_profiled_wall": (
            prof["device_s"] / prof["wall_s"] if "wall_s" in prof else None),
        "profiled_round": CLUSTER_PROFILE_AT,
        "stats": st, "shed": rep["shed"], "fault_free_shed": base.shed,
        "touched_by_reference_fault": touched, "streams_differ": differ,
        "events_by_action": {a: sum(e["action"] == a for e in run.events)
                             for a in sorted({e["action"]
                                              for e in run.events})},
        "fault_events": [e for e in run.events if e["action"] not in
                         ("bind", "requeue", "shed",
                          "duplicate_suppressed")],
        "reaper": rep["reaper"], "lease_audit": rep["lease_audit"],
        "engine_audits": audits, "launches": launches,
    }
    return out, checks


def profile_rounds(torch, megastep, ours) -> dict:
    """One warm megastep timed without the profiler, one under
    torch.profiler, its CUDA activity only (nothing here reads CPU op
    events, and with them a chunked megastep's ~210000 launches made its
    phase more than twice as long): device busy time (the sum of kernel
    times) over each wall time, launches, the top kernels and the ported
    ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    megastep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megastep()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        megastep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    mine = {name: {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
                   "launches": e.count,
                   "share_of_busy": e.self_device_time_total / busy_us}
            for e in kernels for name in ours if name in e.key}
    launches = sum(e.count for e in kernels)
    return {"rounds": 32,
            "wall_ms_unprofiled": 1e3 * plain_wall,
            "wall_ms_profiled": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "busy_share_of_unprofiled_wall": busy_us / 1e6 / plain_wall,
            "busy_share_of_profiled_wall": busy_us / 1e6 / wall,
            "kernel_launches": launches, "launches_per_round": launches / 32,
            "ported_kernels": mine,
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def chunk_plan_launches(torch, dev) -> int:
    """Kernel launches of one `chunk_plan` call at S = 256 (the loop's
    count does not depend on the data)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.prefill import banker_order, chunk_plan

    S = CHUNK_SLOTS
    g = torch.Generator(device=dev).manual_seed(SEED)

    def ints(lo, hi):
        return torch.randint(lo, hi, (S,), generator=g, device=dev,
                             dtype=torch.int32)

    busy = ints(0, 2) > 0
    pos, plen, mx, held = ints(0, 1024), ints(1, 1024), ints(16, 129), \
        ints(0, 72)
    zb = torch.zeros(S, dtype=torch.bool, device=dev)
    order = banker_order(held, ints(0, 8), ints(0, 99), busy)
    args = (order, busy, zb, zb, pos, plen, mx, held, 100, zb, held)
    kw = dict(chunk=CHUNKED[0], budget=CHUNKED[1], block_size=CHUNK_POOL[1])
    chunk_plan(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk_plan(*args, **kw)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def profile_megastep(torch, dev) -> dict:
    """Where one up-front megastep's time goes: the serve configuration
    with 400 requests (`profile_rounds`)."""
    _, _, megastep = serve_engine(torch, dev, n_req=400)
    return {"requests": 400, **profile_rounds(
        torch, megastep, ("qos_round_kernel", "paged_decode_kernel"))}


def profile_chunked(torch, dev) -> dict:
    """Where one chunked megastep's time goes: the serve_chunked
    configuration after two warm megasteps (prefill, sharing and parks
    under way), and the launches of the chunk plan's loop.  The paged
    decode calls of the timed megasteps are recorded (their ``lens`` and
    block tables, which the engine replaces rather than writes, read
    after the run) for the live tokens a launch serves and its bound: the
    bytes count each live pool block once, however many slots share it
    (`unique_live_tokens`), the operations each slot's tokens."""
    from repro_torch.kernels import ops

    _, _, megastep = chunked_engine(torch, dev)
    megastep()
    seen = []
    inner = ops._paged_decode.paged_decode

    def recorded(q, k_pool, v_pool, block_tbl, lens):
        seen.append((lens, block_tbl, k_pool.shape[0], k_pool.shape[1]))
        return inner(q, k_pool, v_pool, block_tbl, lens)

    ops._paged_decode.paged_decode = recorded
    try:
        res = profile_rounds(torch, megastep, ("qos_round_kernel",
                                               "paged_decode_kernel",
                                               "paged_prefill_kernel"))
    finally:
        ops._paged_decode.paged_decode = inner
    live = [int(ln.clamp(max=t.shape[1] * bs).sum())
            for ln, t, _, bs in seen]
    uniq = [unique_live_tokens(torch, ln, t, nb, bs)
            for ln, t, nb, bs in seen]
    hd, n = 896, max(len(live), 1)
    bounds = [_bound(2 * u * hd * 4 + 2 * CHUNK_SLOTS * hd * 4
                     + t.numel() * 4 + CHUNK_SLOTS * 4, 4 * v * hd)[0]
              for u, v, (_, t, _, _) in zip(uniq, live, seen)]
    plan = chunk_plan_launches(torch, dev)
    return {"requests": CHUNK_REQUESTS, **res,
            "paged_decode_live_tokens": {"calls": len(live),
                                         "mean": sum(live) / n,
                                         "max": max(live, default=0),
                                         "unique_mean": sum(uniq) / n},
            "paged_decode_bound_ms_mean": sum(bounds) / n,
            "chunk_plan_launches_per_round": plan,
            "chunk_plan_share_of_launches": plan / res["launches_per_round"]}


def unique_live_tokens(torch, lens, tbl, n_blocks: int, bs: int) -> int:
    """The pool tokens a paged-decode call must read at least once: for
    each pool block, the most live tokens any slot reads from it (a block
    shared by a prefix counts once)."""
    mb = tbl.shape[1]
    j = torch.arange(mb, device=tbl.device)
    n = (lens[:, None].clamp(max=mb * bs) - j[None] * bs).clamp(0, bs)
    ok = (tbl >= 0) & (n > 0)
    most = torch.zeros(n_blocks, dtype=torch.int64, device=tbl.device)
    most.scatter_reduce_(0, tbl[ok].long(), n[ok].long(), "amax")
    return int(most.sum())


def kernel_times(torch, dev, by_path, first_backlog_rows) -> list:
    """Each kernel against its plain version on the timed inputs (the max
    error goes into the row), then the times of the kernel, the plain
    version and a library call at the main path's shapes; the bound from
    these inputs.  ``by_path``: each main path's launch counts; a row's
    ``launches`` is their sum."""
    from repro_torch.kernels import ops, qos_admission

    rows = []
    launches = {k: sum(p[k] for p in by_path.values())
                for k in next(iter(by_path.values()))}

    def per_path(name):
        return {path: counts[name] for path, counts in by_path.items()}

    # QoS round: the serve path's first backlog (pow2 rows), 3 tenants,
    # T=256, max_units = 256 slots, through `ops.qos_round` as the engine
    # calls it (`now` and `free_units` as device scalars)
    N, S, T, U = first_backlog_rows, 3, 256, 256
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=S, N=N, T=T, wrap=False, alive_density=0.9,
        free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)

    def kernel():
        return ops.qos_round(st, ids, tks, alive, dls, now, free_t,
                             max_units=U)

    def plain():
        return qos_admission.qos_round_plain(st, ids, tks, alive, dls, now,
                                             free_t, U)

    got, want = kernel(), plain()
    q_err = qos_max_err(torch, got, want)
    if not qos_exact(torch, got, want):
        raise AssertionError(f"qos_round_fused != plain at N={N}: max "
                             f"|err| {q_err}")
    k_ms, p_ms = time_ms(kernel), time_ms(plain)
    # CUDA kernels a call issues: 20 calls under the profiler.  It keeps
    # fewer events than were launched, so the events a call are a lower
    # bound; the names say that no kernel but the round's ran
    prof = device_profile(torch, kernel, calls=20)
    q_bytes = (N * (4 + 8 + 1 + 4)          # rows: tenant, ticket, alive, dl
               + S * (4 * 8 + 2 * 4) + T * 8 + 16  # state, array, scalars
               + N * 2 + S * (3 * 8 + 4) + T * 8 + 4)  # masks, state',
    q_ops = 2 * S * U                        # array', left; a div + add
    q_bound = max(q_bytes / HBM_BYTES_PER_S, q_ops / F32_FLOPS) * 1e3
    rows.append({
        "name": "qos_round_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/qos_admission.cu",
        "replaces": "src/repro/kernels/qos_admission.py:249",
        "launches": launches["qos_round_fused"], "max_abs_err": q_err,
        "ms": k_ms, "kernel_device_ms": kernel_device_ms(
            torch, kernel, "qos_round_kernel"),
        "cuda_events_per_call": prof["launches"],
        "cuda_kernels_seen": sorted(k[:60] for k in prof["ms_by_kernel"]),
        "wrapper_launches_per_call": launches_per_call(torch, kernel,
                                                       "qos_round_fused"),
        "plain_ms": p_ms, "bound_ms": q_bound,
        "bound_by": ("bytes" if q_bytes / HBM_BYTES_PER_S
                     >= q_ops / F32_FLOPS else "operations"),
        "library_ms": None, "launches_by_path": per_path("qos_round_fused"),
        "host_us": host_split(torch, kernel),
        "shape": {"N": N, "tenants": S, "T": T, "max_units": U}})

    # paged decode at the serve path's shape (256 slots, H=KV=1, hd=896,
    # its pool, lens up to its longest request) and at the chunked path's
    # (the 4096-block pool all live, 72-block tables)
    NB, BS, MB = SERVE_POOL
    serve_args = paged_case(torch, dev, seed=11, S=SERVE_SLOTS, H=1, KV=1,
                            hd=896, NB=NB, BS=BS, MB=MB,
                            max_len=SERVE_MAX_LEN)
    row = paged_decode_times(torch, dev, serve_args)
    rows.append({
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:119",
        "launches": launches["paged_decode"], **row,
        "launches_by_path": per_path("paged_decode"),
        "at_chunked_shape": paged_decode_times(
            torch, dev, chunked_decode_case(torch, dev, seed=12))})
    rows.append(prefill_row(torch, dev, launches, per_path))
    rows += model_kernel_rows(torch, dev, launches, per_path)
    return rows


def paged_decode_times(torch, dev, args) -> dict:
    """The paged-decode kernel on ``args`` against its plain version (the
    max error), its wrapper's ms, one launch's device ms, the plain
    version's ms, the bound from the live tokens, SDPA's ms over the
    gathered cache, the wrapper's host µs a call and the cut."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref

    q, kp, vp, tbl, lens = args
    S, H, hd = q.shape
    KV = kp.shape[2]
    MB = tbl.shape[1]
    err = decode_paged_check(torch, args, "the timed inputs")
    k_ms = time_ms(lambda: pd.paged_decode(*args))
    kd_ms = kernel_device_ms(torch, lambda: pd.paged_decode(*args),
                             "paged_decode_kernel")
    p_ms = time_ms(lambda: pd.paged_decode_plain(*args), iters=5, warmup=1)
    kd, kpos = ref.paged_gather_kv(kp, tbl, lens)
    vd, _ = ref.paged_gather_kv(vp, tbl, lens)
    qh = q[:, :, None, :]                                   # (S, H, 1, hd)
    kh = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = (kpos >= 0)[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    del kd, vd, kh, vh
    live = int(lens.clamp(max=MB * kp.shape[1]).sum())
    nbytes = (2 * live * KV * hd * 4          # live K and V rows, once
              + 2 * S * H * hd * 4            # q in, out
              + S * MB * 4 + S * 4)           # table, lens
    bound, by = _bound(nbytes, 4 * live * H * hd)  # q·k and p·v, 2 each
    kt, grid = pd._plans[(dev.index or 0, H, KV, hd, kp.shape[1], MB)]
    pieces = pd.split_plan(lens.tolist(), KV, kp.shape[1], MB, grid)
    return {"max_abs_err": err, "ms": k_ms, "kernel_device_ms": kd_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms,
            "host_us": host_split(torch, lambda: pd.paged_decode(*args)),
            "cut": {"grid": grid, "key_rows": kt,
                    "blocks": sum(pd.block_costs(lens.tolist(), KV,
                                                 kp.shape[1], MB)),
                    "pieces": len(pieces),
                    "slots_cut": len({p[0] for p in pieces
                                      if p[4] is not None})},
            "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "NB": kp.shape[0],
                      "BS": kp.shape[1], "MB": MB, "live_tokens": live}}


def prefill_row(torch, dev, launches, per_path) -> dict:
    """Paged prefill at the chunked path's shapes: S=256 slots, a 64-token
    chunk window, H=KV=1, hd=896, its 4096×16 pool and 72-block tables;
    32 slots carry a chunk (~1k tokens, the round's budget) at offsets up
    to 960, the rest are idle.  The library call is SDPA over the dense
    gathered cache (the pools after the chunk write) with each row's
    causal mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    S, CT, H, KV, hd = CHUNK_SLOTS, CHUNKED[0], 1, 1, 896
    NB, BS, MB = CHUNK_POOL
    args, rows = prefill_case(torch, dev, seed=13, S=S, CT=CT, H=H, KV=KV,
                              hd=hd, NB=NB, BS=BS, MB=MB, active=32,
                              max_off=960)
    q, kc, vc, kp, vp, tbl, off, lens = args
    err = prefill_check(torch, args, rows, "the timed inputs")
    k_ms = time_ms(lambda: pp.paged_prefill(*args))
    kd_ms = kernel_device_ms(torch, lambda: pp.paged_prefill(*args),
                             "paged_prefill_kernel")
    # the cut of this round's key tiles among the launch's one wave
    costs, _ = pp.tile_costs(off.tolist(), lens.tolist(), CT, H, KV, BS, MB)
    grid = pp._grids[(dev.index or 0, S, hd, MB)]
    pieces = pp.split_plan(costs, grid)
    cut = {"grid": grid, "key_tiles": sum(costs),
           "active_tiles": sum(c > 0 for c in costs),
           "pieces": len(pieces),
           "tiles_cut": len({p[0] for p in pieces if p[4] is not None})}
    p_ms = time_ms(lambda: pp.paged_prefill_plain(*args), iters=3, warmup=1)
    # SDPA: q (S, H, CT, hd) over the gathered (S, KV, MB·BS, hd) cache,
    # key t visible to row j iff t <= off + j and j < len
    kd, _ = ref.paged_gather_kv(kp, tbl, off + lens)
    vd, _ = ref.paged_gather_kv(vp, tbl, off + lens)
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    j = torch.arange(CT, device=dev)[None, :, None]
    t = torch.arange(MB * BS, device=dev)[None, None, :]
    mask = ((t <= off[:, None, None] + j)
            & (j < lens[:, None, None]))[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    o64, l64 = off.double(), lens.double()
    rows_tok = float(lens.sum())
    b_bytes = (2 * float((o64 * (l64 > 0)).sum()) * KV * hd * 4  # prior K/V
               + 2 * rows_tok * KV * hd * 4      # chunk K/V read
               + rows_tok * H * hd * 4           # chunk q read
               + 2 * rows_tok * KV * hd * 4      # chunk K/V written
               + S * CT * H * hd * 4             # out written (zeros too)
               + S * MB * 4 + 2 * S * 4)         # table, off, lens
    b_ops = 4 * float((l64 * (o64 + (l64 + 1) / 2)).sum()) * H * hd
    bound = max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_FLOPS) * 1e3
    return {
        "name": "paged_prefill", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_prefill.cu",
        "replaces": "src/repro/kernels/paged_prefill.py:166",
        "launches": launches["paged_prefill"], "max_abs_err": err,
        "ms": k_ms, "kernel_device_ms": kd_ms, "plain_ms": p_ms,
        "bound_ms": bound, "cut": cut,
        "bound_by": ("bytes" if b_bytes / HBM_BYTES_PER_S
                     >= b_ops / F32_FLOPS else "operations"),
        "library_ms": lib_ms, "launches_by_path": per_path("paged_prefill"),
        "host_us": host_split(torch, lambda: pp.paged_prefill(*args)),
        "shape": {"S": S, "CT": CT, "H": H, "KV": KV, "hd": hd, "NB": NB,
                  "BS": BS, "MB": MB, "chunk_tokens": int(rows_tok),
                  "active_slots": int((lens > 0).sum())}}


def _bound(nbytes: float, ops: float, flops: float = F32_FLOPS) -> tuple:
    """(bound ms, what bounds it) of work moving ``nbytes`` and doing
    ``ops`` operations at ``flops`` a second (f32 outside the tensor
    cores by default) on one H100."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def model_kernel_rows(torch, dev, launches, per_path) -> list:
    """The single-tenant path's kernels at its shapes: ``sema_batch`` at
    serve_model's waves (N=16 requests, T=256); ``decode_attention`` at
    serve_model's decode (B=8 slots, a full 256-row ring, H=14, KV=2,
    hd=64); ``flash_attention`` at prefill_model's (B=4, S=256, causal).
    The library calls: none for ``sema_batch``; SDPA over the
    head-repeated cache with the visibility mask for decode; causal SDPA
    over head-repeated K/V for flash."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    rows = []
    N, T = MODEL_REQUESTS // 2, 256
    args = sema_case(torch, dev, seed=31, N=N, T=T, post_n=0)
    err = sema_check(torch, args, "the timed inputs")
    s_bytes = (N * 1 + 4 * 4 + T * 4            # requests, scalars, array
               + N * (4 + 1 + 4 + 1) + 2 * 4 + T * 4)  # rows out, scalars,
    s_ops = 12 * N + 6 * T                       # array out; integer ops
    bound, by = _bound(s_bytes, s_ops)
    prof = device_profile(torch, lambda: sema_batch(*args), calls=20)
    rows.append({
        "name": "sema_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/sema_batch.cu",
        "replaces": "src/repro/kernels/sema_batch.py:118",
        "launches": launches["sema_batch"], "max_abs_err": err,
        "ms": time_ms(lambda: sema_batch(*args)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: sema_batch(*args), "sema_batch_kernel"),
        "cuda_events_per_call": prof["launches"],
        "cuda_kernels_seen": sorted(k[:60] for k in prof["ms_by_kernel"]),
        "wrapper_launches_per_call": launches_per_call(
            torch, lambda: sema_batch(*args), "sema_batch"),
        "plain_ms": time_ms(lambda: sema_batch_plain(*args)),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "launches_by_path": per_path("sema_batch"),
        "host_us": host_split(torch, lambda: sema_batch(*args)),
        "shape": {"N": N, "T": T, "post_n": 0}})

    B, C, H, KV, hd = MODEL_SLOTS, MODEL_MAX_LEN, 14, 2, 64
    (q, k, v, kpos, qpos), _ = decode_case(torch, dev, seed=33, B=B, C=C,
                                           H=H, KV=KV, hd=hd)
    kpos = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C) \
        .contiguous()
    qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
    err = decode_check(torch, (q, k, v, kpos, qpos), 0, "the timed inputs")
    vis = (kpos >= 0) & (qpos[:, None] - kpos >= 0)
    n_vis = float(vis.sum())                    # visible (row, key) pairs
    qh = q[:, :, None, :]
    kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = vis[:, None, None, :]
    d_bytes = (2 * n_vis * KV * hd * 4 + 2 * B * H * hd * 4
               + B * C * 4 + B * 4)
    bound, by = _bound(d_bytes, 4 * n_vis * H * hd)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:102",
        "launches": launches["decode_attention"], "max_abs_err": err,
        "ms": time_ms(lambda: decode_attention(q, k, v, kpos, qpos)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: decode_attention(q, k, v, kpos, qpos),
            "decode_attention_kernel"),
        "plain_ms": time_ms(lambda: decode_attention_plain(q, k, v, kpos,
                                                           qpos)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)),
        "launches_by_path": per_path("decode_attention"),
        "host_us": host_split(torch, lambda: decode_attention(q, k, v, kpos,
                                                              qpos)),
        "shape": {"B": B, "C": C, "H": H, "KV": KV, "hd": hd,
                  "visible_keys": int(n_vis)}})

    B, S = PREFILL_B, PREFILL_S
    args = flash_case(torch, dev, seed=35, B=B, S=S, H=H, KV=KV, hd=hd)
    err = flash_check(torch, args, 0, "the timed inputs")
    q, k, v = args
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    pairs = B * H * S * (S + 1) / 2             # causal (query, key) pairs
    f_bytes = (B * S * (2 * H + 2 * KV) * hd * 4)  # q, k, v in; out
    f_ops = 4 * pairs * hd
    # the kernel takes every product as 3xTF32 on the tensor cores; the
    # f32 pipe's bound beside it
    bound_f32, _ = _bound(f_bytes, f_ops)
    tb, to = f_bytes / HBM_BYTES_PER_S, 3 * f_ops / TF32_FLOPS
    bound, by = max(tb, to) * 1e3, ("bytes" if tb >= to
                                    else "operations (3xTF32)")
    # what one TF32 product per term would give: the plain version with
    # TF32 matmuls against itself in f32
    want = flash_attention_plain(q, k, v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = float((flash_attention_plain(q, k, v) - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:149",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: flash_attention(q, k, v),
            "flash_attention_kernel"),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v)),
        "bound_ms": bound, "bound_by": by, "bound_ms_f32": bound_f32,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)),
        "launches_by_path": per_path("flash_attention"),
        "host_us": host_split(torch, lambda: flash_attention(q, k, v)),
        "one_tf32_product_max_abs_err": tf32_err,
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                  "causal": True}})
    return rows


def block_kind_attention_rows(torch, dev) -> dict:
    """``flash_attention`` and ``decode_attention`` at the other block
    kinds' heads (`BLOCK_KIND_FLASH`), as their phases call them: flash at
    prefill_<name>'s B × S (recurrentgemma B=1 × S=2304 with its 2048
    window), decode at serve_model's 8 slots over a full 256-row cache,
    and recurrentgemma's decode over a full 2048-row ring (prefill_hybrid).
    Each against its plain version (max error), the wrapper's ms, the
    plain version's, the bound from these inputs and SDPA's ms."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain

    out = {"flash_attention": [], "decode_attention": []}
    for name, heads, window, B, S in BLOCK_KIND_FLASH:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        args = flash_case(torch, dev, seed=37, B=B, S=S, **heads)
        err = flash_check(torch, args, window, f"{name} timed inputs")
        q, k, v = args
        qh = q.permute(0, 2, 1, 3).contiguous()
        kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        i = torch.arange(S, device=dev)
        vis = (i[:, None] >= i[None, :])
        if window:
            vis &= (i[:, None] - i[None, :]) < window
        pairs = B * H * float(vis.sum())         # visible (query, key) pairs
        f_bytes = B * S * (2 * H + 2 * KV) * hd * 4
        tb, to = f_bytes / HBM_BYTES_PER_S, 3 * 4 * pairs * hd / TF32_FLOPS
        out["flash_attention"].append({
            "config": name, "shape": {"B": B, "S": S, **heads,
                                      "window": window},
            "max_abs_err": err,
            "ms": time_ms(lambda: flash_attention(q, k, v, window=window)),
            "plain_ms": time_ms(lambda: flash_attention_plain(
                q, k, v, window=window), iters=5),
            "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations (3xTF32)",
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=vis)),
        })
    dec = [(name, heads, 0, MODEL_SLOTS, MODEL_MAX_LEN)
           for name, heads, _, _, _ in BLOCK_KIND_FLASH]
    dec.append(("recurrentgemma prefill_hybrid", BLOCK_KIND_FLASH[2][1],
                2048, HYBRID_PREFILL_B, 2048))
    for name, heads, window, B, C in dec:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        (q, k, v, _, _), _ = decode_case(torch, dev, seed=39, B=B, C=C,
                                         **heads)
        kpos = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C) \
            .contiguous()
        qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
        args = (q, k, v, kpos, qpos)
        err = decode_check(torch, args, window, f"{name} timed inputs")
        vis = (kpos >= 0) & (qpos[:, None] - kpos >= 0)
        if window:
            vis &= (qpos[:, None] - kpos) < window
        n_vis = float(vis.sum())
        qh = q[:, :, None, :]
        kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
        mask = vis[:, None, None, :]
        d_bytes = (2 * n_vis * KV * hd * 4 + 2 * B * H * hd * 4
                   + B * C * 4 + B * 4)
        bound, by = _bound(d_bytes, 4 * n_vis * H * hd)
        out["decode_attention"].append({
            "config": name, "shape": {"B": B, "C": C, **heads,
                                      "window": window,
                                      "visible_keys": int(n_vis)},
            "max_abs_err": err,
            "ms": time_ms(lambda: decode_attention(*args, window=window)),
            "plain_ms": time_ms(lambda: decode_attention_plain(
                *args, window=window)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)),
        })
    return out


def ab_times(tree: Path) -> dict:
    """The six redesigned kernels of the source tree ``tree`` (its
    ``src/repro_torch``, built into its own ``build/kernels``) at the main
    paths' shapes: paged decode at the up-front path's (S=256, hd=896,
    MB=32, ~31k live tokens) and the chunked path's (the 4096-block pool
    all live, MB=72); ``sema_batch`` at serve_model's waves (N=16,
    T=256); the QoS round through ``ops.qos_round`` at the serve path's
    first backlog (N=1024, 3 tenants, T=256, device scalars); paged
    prefill at the chunked path's (S=256, CT=64, hd=896, MB=72, 32 active
    slots); flash at prefill_model's (B=4, S=256, H=14, KV=2, hd=64,
    causal); decode at serve_model's (B=8, C=256, every key visible).
    Per kernel: the wrapper's ms (CUDA events over 20 calls), one
    launch's device ms (torch.profiler, divided by the launches it
    recorded) and the wrapper's host µs a call (200 calls enqueued).  And
    the ms a round of the up-front path (400 requests), the dense ring
    and the chunked path (400 requests), over megasteps 2–4.  Run in a
    process of its own, so that two trees' packages do not meet."""
    import os

    os.environ["REPRO_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.sema_batch import sema_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=3, N=backlog_rows(SERVE_REQUESTS,
                                                SERVE_SLOTS)[0],
        T=256, wrap=False, alive_density=0.9, free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)
    NB, BS, MB = CHUNK_POOL
    pargs, _ = prefill_case(torch, dev, seed=13, S=CHUNK_SLOTS,
                            CT=CHUNKED[0], H=1, KV=1, hd=896, NB=NB, BS=BS,
                            MB=MB, active=32, max_off=960)
    H, KV, hd = 14, 2, 64
    q, k, v = flash_case(torch, dev, seed=35, B=PREFILL_B, S=PREFILL_S, H=H,
                         KV=KV, hd=hd)
    (dq, dk, dv, _, _), _ = decode_case(torch, dev, seed=33, B=MODEL_SLOTS,
                                       C=MODEL_MAX_LEN, H=H, KV=KV, hd=hd)
    kpos = torch.arange(MODEL_MAX_LEN, dtype=torch.int32, device=dev) \
        .expand(MODEL_SLOTS, MODEL_MAX_LEN).contiguous()
    qpos = torch.full((MODEL_SLOTS,), MODEL_MAX_LEN - 1, dtype=torch.int32,
                      device=dev)
    NB, BS, MB = SERVE_POOL
    dserve = paged_case(torch, dev, seed=11, S=SERVE_SLOTS, H=1, KV=1,
                        hd=896, NB=NB, BS=BS, MB=MB, max_len=SERVE_MAX_LEN)
    dchunk = chunked_decode_case(torch, dev, seed=12)
    sargs = sema_case(torch, dev, seed=31, N=MODEL_REQUESTS // 2, T=256,
                      post_n=0)
    out = {}
    for name, kname, fn in (
            ("paged_decode_serve", "paged_decode_kernel",
             lambda: paged_decode(*dserve)),
            ("paged_decode_chunked", "paged_decode_kernel",
             lambda: paged_decode(*dchunk)),
            ("sema_batch", "sema_batch_kernel", lambda: sema_batch(*sargs)),
            ("qos_round_fused", "qos_round_kernel",
             lambda: ops.qos_round(st, ids, tks, alive, dls, now, free_t,
                                   max_units=256)),
            ("paged_prefill", "paged_prefill_kernel",
             lambda: pp.paged_prefill(*pargs)),
            ("flash_attention", "flash_attention_kernel",
             lambda: flash_attention(q, k, v)),
            ("decode_attention", "decode_attention_kernel",
             lambda: decode_attention(dq, dk, dv, kpos, qpos))):
        out[name] = {"ms": time_ms(fn),
                     "kernel_device_ms": kernel_device_ms(torch, fn, kname),
                     "host_us": host_split(torch, fn)["host_us"]}
    # ms a round of the three megastep paths: the same trace in both
    # trees, megasteps 2-4 (after one warm-up)
    for name, make in (("upfront_round_ms", lambda: serve_engine(
            torch, dev, n_req=400)), ("dense_ring_round_ms",
                                      lambda: dense_ring_engine(torch, dev)),
            ("chunked_round_ms", lambda: chunked_engine(torch, dev))):
        _, _, megastep = make()
        megastep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            megastep()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / (3 * 32)
    return out


def kernels_ab(parent: Path) -> int:
    """``--ab-attention PARENT``: the six redesigned kernels (`ab_times`)
    of the source tree at PARENT (a ``git archive`` of an earlier commit)
    and of this tree, timed in turns on the one card (parent, this, this,
    parent), each in a process of its own; prints one JSON line."""
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        r = subprocess.run([sys.executable, __file__, "--ab-times",
                            str(tree)], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        runs.append({"tree": str(tree),
                     **json.loads(r.stdout.strip().splitlines()[-1])})
    print(smi_line(), flush=True)
    print(json.dumps({"ab": runs}), flush=True)
    return 0


# ---------------------------------------------------------------- train_mesh
# The collectives the meshed train step needs, probed on CUDA tensors over
# gloo (four ranks on the one card) and NCCL (two ranks on the one card).
PROBE_COLLECTIVES = ("cpu_all_reduce", "all_reduce", "all_reduce_max", "all_reduce_int32",
                     "broadcast", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "all_to_all_single",
                     "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
                     "dtensor_partial_to_shard")


def _probe_one(torch, dist, name: str, rank: int, world: int, dev) -> None:
    """One collective on CUDA tensors of ``dev``, its result checked."""
    n = 8
    x = torch.arange(n, dtype=torch.float32, device=dev) + rank
    full = sum(torch.arange(n, dtype=torch.float32) + r for r in range(world))
    if name == "cpu_all_reduce":  # the control: a CPU tensor
        xc = x.cpu()
        dist.all_reduce(xc)
        ok = torch.equal(xc, full)
    elif name == "all_reduce":
        dist.all_reduce(x)
        ok = torch.equal(x.cpu(), full)
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        ok = torch.equal(x.cpu(), torch.arange(n, dtype=torch.float32)
                         + world - 1)
    elif name == "all_reduce_int32":
        xi = x.to(torch.int32)
        dist.all_reduce(xi)
        ok = torch.equal(xi.cpu(), full.to(torch.int32))
    elif name == "broadcast":
        dist.broadcast(x, src=0)
        ok = torch.equal(x.cpu(), torch.arange(n, dtype=torch.float32))
    elif name == "all_gather_into_tensor":
        out = torch.empty(world * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = torch.equal(out.cpu(), torch.cat(
            [torch.arange(n, dtype=torch.float32) + r for r in range(world)]))
    elif name == "reduce_scatter_tensor":
        src = torch.arange(world * n, dtype=torch.float32, device=dev) + rank
        out = torch.empty(n, device=dev)
        dist.reduce_scatter_tensor(out, src)
        want = sum(torch.arange(world * n, dtype=torch.float32) + r
                   for r in range(world))[rank * n:(rank + 1) * n]
        ok = torch.equal(out.cpu(), want)
    elif name == "all_to_all_single":
        src = torch.arange(world * n, dtype=torch.float32, device=dev) \
            + 1000 * rank
        out = torch.empty(world * n, device=dev)
        dist.all_to_all_single(out, src)
        want = torch.cat([torch.arange(rank * n, (rank + 1) * n,
                                       dtype=torch.float32) + 1000 * r
                          for r in range(world)])
        ok = torch.equal(out.cpu(), want)
    else:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = DeviceMesh("cuda", list(range(world)))
        t = torch.arange(world * n, dtype=torch.float32).reshape(world, n)
        if name == "dtensor_shard_to_replicate":
            d = DTensor.from_local(t[rank:rank + 1].to(dev), mesh, [Shard(0)],
                                   run_check=False)
            ok = torch.equal(d.redistribute(mesh, [Replicate()]).to_local()
                             .cpu(), t)
        elif name == "dtensor_partial_to_replicate":
            d = DTensor.from_local((t + rank).to(dev), mesh, [Partial()],
                                   run_check=False)
            ok = torch.equal(d.redistribute(mesh, [Replicate()]).to_local()
                             .cpu(), sum(t + r for r in range(world)))
        else:
            d = DTensor.from_local((t + rank).to(dev), mesh, [Partial()],
                                   run_check=False)
            ok = torch.equal(d.redistribute(mesh, [Shard(0)]).to_local()
                             .cpu(), sum(t + r for r in range(world))
                             [rank:rank + 1])
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{name}: wrong result")


def _probe_rank(rank: int, world: int, backend: str, init_file: str,
                out_dir: str) -> None:
    """A rank of the collective probe: every ``PROBE_COLLECTIVES`` entry
    on ``cuda:0`` tensors, each outcome (ok, or the error's first line)
    and its seconds written to ``out_dir/rank.json`` as it comes; gloo
    runs them all, NCCL stops at the first error (its communicator is then
    unusable).  gloo meets its peers on the loopback interface."""
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import faulthandler

    err = open(Path(out_dir, f"{rank}.err"), "w")
    os.dup2(err.fileno(), 2)
    faulthandler.enable(file=err)
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {}
    path = Path(out_dir, f"{rank}.json")

    def note(name, t0, err=None):
        res[name] = {"s": round(time.perf_counter() - t0, 3), "ok": err is None}
        if err is not None:
            res[name]["error"] = f"{type(err).__name__}: " + (
                str(err).strip().splitlines() or [""])[0][:300]
        path.write_text(json.dumps(res))
        return err is None

    t0 = time.perf_counter()
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=20))
        note("init", t0)
    except Exception as e:  # noqa: BLE001 — the probe's finding
        note("init", t0, e)
        return
    for name in PROBE_COLLECTIVES:
        if backend == "nccl" and name == "cpu_all_reduce":
            continue  # NCCL has no CPU tensors
        t0 = time.perf_counter()
        try:
            _probe_one(torch, dist, name, rank, world, dev)
            note(name, t0)
        except Exception as e:  # noqa: BLE001
            note(name, t0, e)
            if backend == "nccl":
                break
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def run_ranks(target, world: int, args: tuple, timeout: float) -> bool:
    """``target(rank, world, *args)`` in ``world`` spawned processes;
    every process still alive after ``timeout`` seconds is killed.
    Returns whether all exited with 0."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    ok = True
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            ok = False
        ok = ok and p.exitcode == 0
    run_ranks.exitcodes = [p.exitcode for p in procs]
    return ok


def collective_probe() -> dict:
    """gloo's collectives on CUDA tensors with four ranks on ``cuda:0``,
    and NCCL's answer to two ranks on one card."""
    out = {}
    for backend, world in (("gloo", 4), ("nccl", 2)):
        with tempfile.TemporaryDirectory() as d:
            clean = run_ranks(_probe_rank, world,
                              (backend, str(Path(d, "init")), d), 240)
            ranks = [json.loads(Path(d, f"{r}.json").read_text())
                     if Path(d, f"{r}.json").exists() else {"lost": True}
                     for r in range(world)]
            errs = [Path(d, f"{r}.err").read_text()[-1500:]
                    if Path(d, f"{r}.err").exists() else ""
                    for r in range(world)]
        oks = [{k: v.get("ok") for k, v in r.items() if isinstance(v, dict)}
               for r in ranks]
        out[backend] = {"world": world, "exited_cleanly": clean,
                        "rank0": ranks[0],
                        "ranks_agree": all(o == oks[0] for o in oks)}
        codes = run_ranks.exitcodes
        if any(c is not None and c < 0 for c in codes):
            # the first collective a rank never finished: where it died
            done = set(ranks[0])
            out[backend]["crashed_at"] = next(
                (n for n in PROBE_COLLECTIVES if n not in done), None)
            out[backend]["signals"] = [-c if c and c < 0 else 0
                                       for c in codes]
        if not (clean and out[backend]["ranks_agree"]):
            out[backend]["exitcodes"] = codes
            out[backend]["ranks"] = ranks
            out[backend]["stderr_tails"] = errs
    return out


# train_mesh: the meshed train step rehearsed by four ranks on the one
# card over gloo — qwen2-0.5b at full width, f32, train_model's batch
MESH_ARCH, MESH_B, MESH_S, MESH_A = "qwen2-0.5b", 8, 128, 2
MESH_STEPS, MESH_COMPRESS_STEPS = 3, 2
MESH_ELASTIC_UNITS = 2      # the elastic resize: 2 of the 24 layers
MESH_ONE_RANK_UNITS = 2     # branch (c)'s one-rank mesh: 2 of the 24 layers
MESH_TOL = 1e-4             # meshed vs single-device, relative
# --train-mesh-cards also trains the recurrent families on (data 2,
# model 2): recurrentgemma-9b at full width cut to one unit (rglru,
# rglru, attn window 2048; no suffix) and xlstm-350m whole, each
# MESH_MORE_STEPS steps held to rank 0's single-device step
MESH_MORE = (("recurrentgemma-9b", 1), ("xlstm-350m", None))
MESH_MORE_STEPS = 2
MESH_MORE_TOL = 1e-5
MESH_COMPRESS_TOL = 1e-3    # the compressed step's second loss, relative
MESH_LR = 1e-4
# what DTensor and the step need of gloo on CUDA tensors (branch (a));
# without all of these the phase runs what one rank can (branch (c))
MESH_NEEDS = ("all_reduce", "all_reduce_max", "all_reduce_int32",
              "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
              "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
              "dtensor_partial_to_shard")


def _mesh_batch(torch, vocab: int, t: int, dev) -> dict:
    import numpy as np

    rng = np.random.default_rng(SEED + t)
    return {k: torch.as_tensor(rng.integers(0, vocab, (MESH_B, MESH_S))
                               .astype(np.int32), device=dev)
            for k in ("tokens", "labels")}


def _spec_bytes(specs, params, axes) -> dict:
    """Bytes a rank receives a step in each collective class the specs
    imply (f32, ring algorithms): the FSDP all-gather of the parameters
    to their tensor-parallel shards and the reduce-scatter of their
    gradients back to the FSDP shards, (n−1)/n of a tensor-parallel
    shard each over ``data``'s n ranks; a leaf FSDP leaves whole is
    all-reduced, 2·(n−1)/n.  The tensor-parallel activation sums over
    ``model`` are not counted."""
    from repro_torch.checkpoint.manager import path_leaves

    n = axes.get("data", 1)
    tp_div = lambda spec: _axes_prod(spec, axes, skip="data")  # noqa: E731
    fs = dict((tuple(p), s) for p, s in _spec_paths(specs))
    gather = scatter = reduce = 0.0
    for path, leaf in path_leaves(params):
        spec = fs[tuple(path)]
        tp_bytes = leaf.numel() * 4 / tp_div(spec)
        if any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for e in spec):
            gather += tp_bytes * (n - 1) / n
            scatter += tp_bytes * (n - 1) / n
        else:
            reduce += tp_bytes * 2 * (n - 1) / n
    return {"fsdp_all_gather": gather, "grad_reduce_scatter": scatter,
            "grad_all_reduce": reduce}


def _spec_paths(specs, path=()):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_paths(specs[k],
                                                              path + (k,))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _spec_paths(v, path + (i,))]
    return [(path, specs)]


def _axes_prod(spec, axes, skip=None) -> int:
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            if a != skip:
                n *= axes[a]
    return n


def _timed_steps(torch, step, state, batches) -> tuple:
    """``step`` over ``batches``: the state, each step's (loss,
    grad_norm) and ms (CUDA-synchronised wall time)."""
    out, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out, ms


def _mesh_rank(rank: int, world: int, init_file: str, out_dir: str,
               backend: str = "gloo") -> None:
    """A rank of train_mesh: on ``cuda:0`` with three others over gloo,
    or on ``cuda:rank`` over NCCL (one rank a card): rank 0's
    single-device reference; the (data 2, model 2) FSDP step; the
    compressed (pod 2, data 1, model 2) step; the elastic dp 4 → 2 → 4
    resize (model 1) through checkpoints in ``out_dir``; over NCCL also
    `MESH_MORE`'s models, each on (data 2, model 2) beside rank 0's
    single-device steps.  Writes ``out_dir/rank.json``."""
    import dataclasses
    import logging

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    card = rank if backend == "nccl" else 0
    os.environ["LOCAL_RANK"] = str(card)  # `launch.mesh.local_device`
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_rank, make_dev_mesh
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.parallel import sharding, steps
    from repro_torch.runtime import elastic

    dev = torch.device("cuda", card)
    init_rank(rank, world, init_file, backend, timeout_s=600)
    cfg = get_config(MESH_ARCH)
    shape = ShapeSpec("mesh", MESH_S, MESH_B, "train")
    opt = AdamWConfig(lr=MESH_LR, warmup_steps=1, total_steps=10)
    batches = [_mesh_batch(torch, cfg.vocab, t, dev)
               for t in range(MESH_STEPS)]
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
    res = {"rank": rank}

    def sc_for(axes, c=cfg, param_dtype=torch.float32, **kw):
        return steps.default_step_config(c, shape, dp=steps.dp_size(axes),
                                         axes=axes, accum_steps=MESH_A,
                                         param_dtype=param_dtype, **kw)

    def run_single(c, bs, **kw) -> dict:
        # rank 0: the single-device steps from the same state and batches
        sc = sc_for({}, c, **kw)
        torch.cuda.reset_peak_memory_stats()
        st = steps.make_train_state(gen(), c, sc, device=dev)
        st, hist, ms = _timed_steps(
            torch, steps.make_train_step(c, shape, sc, opt), st, bs)
        out = {"losses": [h[0] for h in hist],
               "grad_norms": [h[1] for h in hist], "ms": ms,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del st
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def run_mesh(name, dims, n_steps, c=cfg, bs=batches, into=res, **kw):
        axes = dict(zip(("pod", "data", "model")[3 - len(dims):], dims))
        sc = sc_for(axes, c, **kw)
        mesh = (make_dev_mesh(dims[1], dims[2], dims[0], device=dev)
                if len(dims) == 3 else make_dev_mesh(*dims, device=dev))
        with sharding.use_mesh(mesh):
            st = steps.make_train_state(gen(), c, sc, mesh=mesh)
            step = steps.make_train_step(c, shape, sc, opt)
            specs = steps.train_state_pspecs(st, sc).params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st, hist, ms = _timed_steps(torch, step, st, bs[:n_steps])
        launches = ops.launch_counts()
        out = {"mesh": dict(axes), "losses": [h[0] for h in hist],
               "grad_norms": [h[1] for h in hist], "ms": ms,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "port_kernel_launches": launches,
               "port_kernel_launches_a_step": sum(launches.values())
               / n_steps,
               "bytes_a_step": _spec_bytes(specs, st.params, axes)}
        if kw.get("compress_pods"):
            out["residual_absmax"] = max(
                float(r.to_local().abs().max()) for r in leaves(st.residuals))
        into[name] = out
        del st, step
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

    # the single-device reference: rank 0, the same state and batches
    if rank == 0:
        res["single"] = run_single(cfg, batches)
    dist.barrier()
    run_mesh("fsdp_tp", (2, 2), MESH_STEPS, fsdp=True)
    run_mesh("compressed", (2, 1, 2), MESH_COMPRESS_STEPS, fsdp=True,
             compress_pods=True)

    # elastic: the depth cut, model 1, dp 4 → 2 → 4 through checkpoints
    ecfg = dataclasses.replace(cfg, num_units=MESH_ELASTIC_UNITS)
    esc = steps.default_step_config(ecfg, shape, dp=4, axes={"data": 4},
                                    accum_steps=1, param_dtype=torch.float32)
    ck = CheckpointManager(str(Path(out_dir, "ckpt")))

    def estep(mesh):
        with sharding.use_mesh(mesh):
            return steps.make_train_step(ecfg, shape, esc, opt)

    mesh4 = make_dev_mesh(4, 1, device=dev)
    with sharding.use_mesh(mesh4):
        st = steps.make_train_state(gen(), ecfg, esc, mesh=mesh4)
    st, _ = estep(mesh4)(st, batches[0])
    t0 = time.perf_counter()
    ck.save(1, st, blocking=True)
    dist.barrier()
    save_s = time.perf_counter() - t0
    plan4 = elastic.plan_for_membership(4, 1, 1, MESH_B, epoch=1)
    plan2 = elastic.plan_for_membership(2, 1, 1, MESH_B, epoch=2)
    t0 = time.perf_counter()
    r4, _, m4 = elastic.resume_elastic(ck, st, esc, plan4, device=dev)
    restore_s = time.perf_counter() - t0
    _, m = estep(m4)(r4, batches[1])
    same = float(m["loss"])
    del r4
    straight = []
    for t in (1, 2):
        st, m = estep(mesh4)(st, batches[t])
        straight.append(float(m["loss"]))
    r2, _, m2 = elastic.resume_elastic(ck, st, esc, plan2, device=dev)
    resized = []
    if elastic.in_mesh(m2):
        r2, m = estep(m2)(r2, batches[1])
        resized.append(float(m["loss"]))
        ck.save(2, r2, blocking=True)
    dist.barrier()
    del r2
    r4, _, m4 = elastic.resume_elastic(ck, st, esc, plan4, device=dev)
    _, m = estep(m4)(r4, batches[2])
    resized.append(float(m["loss"]))
    res["elastic"] = {"units": MESH_ELASTIC_UNITS, "straight": straight,
                      "same_mesh": same, "resized": resized,
                      "plans": [plan4.n_data, plan2.n_data, plan4.n_data],
                      "save_s": save_s, "restore_s": restore_s}
    del st, r4
    gc.collect()
    torch.cuda.empty_cache()

    if backend == "nccl":  # StepConfig()'s bf16: bf16 parameters, f32 master
        bf16 = torch.bfloat16
        if rank == 0:
            res["single_bf16"] = run_single(cfg, batches, param_dtype=bf16)
        dist.barrier()
        run_mesh("fsdp_tp_bf16", (2, 2), MESH_STEPS, fsdp=True,
                 param_dtype=bf16)

    if backend == "nccl":  # the recurrent families, one rank a card
        res["more"] = {}
        for arch, units in MESH_MORE:
            c = get_config(arch)
            if units is not None:
                c = dataclasses.replace(c, num_units=units, suffix=())
            bs = [_mesh_batch(torch, c.vocab, t, dev)
                  for t in range(MESH_MORE_STEPS)]
            got = res["more"][arch] = {"units": c.num_units,
                                       "layers": len(c.blocks)}
            if rank == 0:
                got["single"] = run_single(c, bs)
            dist.barrier()
            run_mesh("fsdp_tp", (2, 2), MESH_MORE_STEPS, c=c, bs=bs,
                     into=got, fsdp=True)
    Path(out_dir, f"{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def train_mesh(torch, dev) -> tuple:
    """The collective probe, then the meshed trainer on the card: four
    ranks on ``cuda:0`` over gloo where gloo carries all that the step
    and DTensor need on CUDA tensors (branch (a)); else branch (c): the
    meshed step on a one-rank CUDA mesh against the single-device step,
    and `compress_psum`'s arithmetic on CUDA tensors against the CPU's.
    Every time here is a one-card rehearsal, not a multi-card speed."""
    probe = collective_probe()
    g = probe["gloo"]["rank0"]
    ok = lambda n: isinstance(g.get(n), dict) and g[n]["ok"]  # noqa: E731
    if not (probe["gloo"]["ranks_agree"] and all(ok(n) for n in MESH_NEEDS)):
        missing = [n for n in MESH_NEEDS if not ok(n)]
        return probe, "c", _mesh_one_rank(torch, dev, {
            "gloo_lacks": missing,
            "crashed_at": probe["gloo"].get("crashed_at"),
            "signals": probe["gloo"].get("signals")})
    branch = "a"
    with tempfile.TemporaryDirectory() as d:
        clean = run_ranks(_mesh_rank, 4, (str(Path(d, "init")), d), 900)
        ranks = [json.loads(Path(d, f"{r}.json").read_text())
                 if Path(d, f"{r}.json").exists() else None
                 for r in range(4)]
    return probe, branch, _mesh_result(clean, ranks, branch,
                                       "four ranks on one card over gloo; "
                                       "not a multi-card speed")


def _mesh_result(clean: bool, ranks: list, branch: str, label: str) -> dict:
    """train_mesh's checks over its ranks' results (rank 0 holds the
    single-device reference); raises when one fails."""
    if not clean or any(r is None for r in ranks):
        raise AssertionError(f"train_mesh: a rank failed ({ranks})")
    r0 = ranks[0]
    one, mesh, comp, el = (r0["single"], r0["fsdp_tp"], r0["compressed"],
                           r0["elastic"])
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    checks = {
        "ranks_agree": all(r[k]["losses"] == r0[k]["losses"]
                           for r in ranks for k in ("fsdp_tp", "compressed")),
        "losses": all(rel(a, b) <= MESH_TOL for a, b in
                      zip(mesh["losses"], one["losses"])),
        "grad_norms": all(rel(a, b) <= MESH_TOL for a, b in
                          zip(mesh["grad_norms"], one["grad_norms"])),
        "compressed_first_loss": rel(comp["losses"][0],
                                     one["losses"][0]) <= MESH_TOL,
        "compressed_second_loss": rel(comp["losses"][1],
                                      one["losses"][1]) <= MESH_COMPRESS_TOL,
        "compressed_residual": 0 < comp["residual_absmax"] < float("inf"),
        "elastic_same_mesh": el["same_mesh"] == el["straight"][0],
        "elastic_resized": all(rel(a, b) <= 1e-5 for a, b in
                               zip(el["resized"], el["straight"])),
        "no_port_kernel": mesh["port_kernel_launches_a_step"] == 0,
    }
    if "fsdp_tp_bf16" in r0:  # at train_parity's bf16 limits
        b16, s16 = r0["fsdp_tp_bf16"], r0["single_bf16"]
        checks.update({
            "bf16_ranks_agree": all(r["fsdp_tp_bf16"]["losses"]
                                    == b16["losses"] for r in ranks),
            "bf16_losses": all(rel(a, b) <= PARITY_BF16_LOSS_TOL for a, b in
                               zip(b16["losses"], s16["losses"])),
            "bf16_grad_norms": all(
                rel(a, b) <= PARITY_BF16_GNORM_TOL for a, b in
                zip(b16["grad_norms"], s16["grad_norms"])),
            "bf16_no_port_kernel":
                b16["port_kernel_launches_a_step"] == 0})
    for arch, m in r0.get("more", {}).items():
        checks.update({
            f"{arch}_ranks_agree": all(
                r["more"][arch]["fsdp_tp"]["losses"] == m["fsdp_tp"]["losses"]
                for r in ranks),
            **{f"{arch}_{k}": all(rel(a, b) <= MESH_MORE_TOL for a, b in zip(
                m["fsdp_tp"][k], m["single"][k]))
               for k in ("losses", "grad_norms")},
            f"{arch}_no_port_kernel":
                m["fsdp_tp"]["port_kernel_launches_a_step"] == 0})
    out = {"branch": branch, "rehearsal": label,
           "arch": MESH_ARCH, "B": MESH_B, "S": MESH_S, "A": MESH_A,
           "tolerance": MESH_TOL, "single": one, "fsdp_tp": mesh,
           "compressed": comp, "elastic": el,
           "bf16": ({"single": r0["single_bf16"],
                     "fsdp_tp": r0["fsdp_tp_bf16"],
                     "tolerance": {"loss": PARITY_BF16_LOSS_TOL,
                                   "grad_norm": PARITY_BF16_GNORM_TOL},
                     "peak_mem_gb_per_rank": [
                         r["fsdp_tp_bf16"]["peak_mem_gb"] for r in ranks]}
                    if "fsdp_tp_bf16" in r0 else None),
           "peak_mem_gb_per_rank": {k: [r[k]["peak_mem_gb"] for r in ranks]
                                    for k in ("fsdp_tp", "compressed")},
           "more": {arch: {**m, "tolerance": MESH_MORE_TOL,
                           "peak_mem_gb_per_rank": [
                               r["more"][arch]["fsdp_tp"]["peak_mem_gb"]
                               for r in ranks]}
                    for arch, m in r0.get("more", {}).items()},
           "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"train_mesh checks failed: {checks} {out}")
    return out


def train_mesh_cards(torch) -> dict:
    """The meshed trainer over NCCL, one rank on each of four cards (the
    ranks and checks of train_mesh's branch (a)): run by
    ``--train-mesh-cards`` on a four-card machine."""
    if torch.cuda.device_count() < 4:
        raise RuntimeError("--train-mesh-cards needs four cards")
    with tempfile.TemporaryDirectory() as d:
        clean = run_ranks(_mesh_rank, 4, (str(Path(d, "init")), d, "nccl"),
                          1500)
        ranks = [json.loads(Path(d, f"{r}.json").read_text())
                 if Path(d, f"{r}.json").exists() else None
                 for r in range(4)]
    return _mesh_result(clean, ranks, "cards",
                        "four ranks on four cards over NCCL")


def _mesh_one_rank(torch, dev, why: dict) -> dict:
    """Branch (c): the meshed step on a one-rank CUDA mesh (a world of one
    gloo rank in this process) against the single-device step, and
    `compress_psum` on CUDA tensors bit-equal to the CPU's.  The model is
    qwen2-0.5b at full width cut to MESH_ONE_RANK_UNITS layers."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import compress_psum
    from repro_torch.parallel import sharding, steps

    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(str(Path(d, "store")), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            cfg = dataclasses.replace(get_config(MESH_ARCH),
                                      num_units=MESH_ONE_RANK_UNITS)
            shape = ShapeSpec("mesh", MESH_S, MESH_B, "train")
            opt = AdamWConfig(lr=MESH_LR, warmup_steps=1, total_steps=10)
            batches = [_mesh_batch(torch, cfg.vocab, t, dev)
                       for t in range(MESH_STEPS)]
            gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
            sc = steps.default_step_config(cfg, shape, accum_steps=MESH_A,
                                           param_dtype=torch.float32)
            st = steps.make_train_state(gen(), cfg, sc, device=dev)
            _, one, one_ms = _timed_steps(
                torch, steps.make_train_step(cfg, shape, sc, opt), st,
                batches)
            del st
            gc.collect()
            torch.cuda.empty_cache()
            mesh = make_dev_mesh(1, 1, device=dev)
            with sharding.use_mesh(mesh):
                st = steps.make_train_state(gen(), cfg, sc, mesh=mesh)
                step = steps.make_train_step(cfg, shape, sc, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            _, got, ms = _timed_steps(torch, step, st, batches)
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            del st
            g = torch.randn(3 * 256 + 7, generator=torch.Generator()
                            .manual_seed(SEED))
            r = torch.randn(g.shape, generator=torch.Generator()
                            .manual_seed(SEED + 1)) * 0.01
            a = compress_psum(g, r, dist.group.WORLD, 1)
            b = compress_psum(g.to(dev), r.to(dev), dist.group.WORLD, 1)
            bit_equal = all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
        finally:
            dist.destroy_process_group()
    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-30)  # noqa: E731
    checks = {"losses": all(rel(x[0], y[0]) <= MESH_TOL
                            for x, y in zip(got, one)),
              "grad_norms": all(rel(x[1], y[1]) <= MESH_TOL
                                for x, y in zip(got, one)),
              "compress_bit_equal": bit_equal}
    out = {"branch": "c", "why": why,
           "rehearsal": "one rank on one card; the four-rank run waits for "
           "a machine with more cards (--train-mesh-cards)",
           "arch": MESH_ARCH, "units": MESH_ONE_RANK_UNITS, "B": MESH_B,
           "S": MESH_S, "A": MESH_A,
           "tolerance": MESH_TOL, "single": one, "single_ms": one_ms,
           "one_rank_mesh": got, "one_rank_mesh_ms": ms,
           "one_rank_mesh_peak_mem_gb": peak,
           "port_kernel_launches_a_step": sum(launches.values())
           / MESH_STEPS,
           "bytes_a_step": "none: one rank moves nothing", "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"train_mesh (c) checks failed: {out}")
    return out


# serve_mesh: the meshed serve steps' kernel arithmetic at the context of
# the reference's serve cells, qwen2-0.5b as published (f32, TF32 off)
SERVE_MESH_ARCH = "qwen2-0.5b"
SERVE_MESH_B, SERVE_MESH_C = 16, 32768  # decode_32k's context; batch 128 cut
SERVE_MESH_STEPS = 8
SERVE_MESH_SHARDS = 4                   # the sequence shards of model = 4
SERVE_MESH_PREFILL_S = 32768            # prefill_32k's length, at B = 1
SERVE_MESH_HEAD_CUT = (4, 4, 3, 3)      # qwen2's 14 query heads in 4 runs
SERVE_MESH_TOL = 2e-5                   # shards vs whole kernel calls
SERVE_MESH_LOGIT_TOL = 2e-3             # logits, as prefill_model's
# the one-rank mesh and the four-card run: a prefill, then decode steps
SERVE_MESH_SMALL = {"S": 1024, "C": 2048, "steps": 8}


def lse_check(torch, args, name) -> dict:
    """``decode_attention`` with ``return_lse`` against its plain version:
    the output and the log-sum-exp within 2e-5 (−inf at the same
    places), the output bit-equal to the default call's.  Returns the
    max |errors| and the rows that saw no key."""
    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain

    got, lse = decode_attention(*args, return_lse=True)
    want, want_lse = decode_attention_plain(*args, return_lse=True)
    inf = torch.isneginf(want_lse)
    fin = ~inf
    out = {"out": float((got - want).abs().max()),
           "lse": float((lse[fin] - want_lse[fin]).abs().max())
           if bool(fin.any()) else 0.0,
           "rows_without_key": int(inf.all(-1).sum())}
    ok = (torch.allclose(got, want, atol=SERVE_MESH_TOL, rtol=SERVE_MESH_TOL)
          and torch.equal(torch.isneginf(lse), inf)
          and torch.allclose(lse[fin], want_lse[fin], atol=SERVE_MESH_TOL,
                             rtol=SERVE_MESH_TOL)
          and torch.equal(got, decode_attention(*args)))
    if not ok:
        raise AssertionError(f"decode_attention lse != plain at {name}: "
                             f"{out}")
    return out


def serve_mesh_lse(torch, dev) -> dict:
    """The decode kernel's log-sum-exp output at serve_model's shape (B=8,
    C=256, H=14, KV=2, hd=64, one row half empty), over a 2048-row cache
    in 8 splits (B=8) and in 64 (B=1), and on a shard that sees no key
    (every key past the query: lse −inf, out 0)."""
    from repro_torch.kernels.decode_attention import split_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    args, _ = decode_case(torch, dev, seed=41, B=MODEL_SLOTS, C=MODEL_MAX_LEN,
                          H=14, KV=2, hd=64)
    out["serve_model_shape"] = lse_check(torch, args, "serve_model's shape")
    for B, nsplit in ((8, 8), (1, 64)):
        args, _ = decode_case(torch, dev, seed=42 + B, B=B, C=2048, H=14,
                              KV=2, hd=64)
        if split_plan(B, 2048, 2, sms)[0] != nsplit:
            raise AssertionError(f"split_plan({B}, 2048) is not {nsplit} "
                                 f"splits on {sms} SMs")
        out[f"C2048_{nsplit}_splits"] = lse_check(
            torch, args, f"C=2048 in {nsplit} splits")
    (q, k, v, pos, _), _ = decode_case(torch, dev, seed=45, B=8, C=2048,
                                       H=14, KV=2, hd=64)
    pos = pos.clamp(min=0) + 2048      # every key lies past the query
    qpos = torch.full((8,), 2047, dtype=torch.int32, device=dev)
    r = lse_check(torch, (q, k, v, pos, qpos), "a shard with no key")
    from repro_torch.kernels import ops

    if r["rows_without_key"] != 8 or ops.decode_attention(
            q, k, v, pos, qpos).abs().max() != 0:
        raise AssertionError(f"a shard with no key: {r}")
    out["shard_without_key"] = r
    return out


def _joined(x, d):
    """A split cache's runs (…, M, B, n, …; M at ``d``) back in one
    sequence axis (…, B, M·n, …)."""
    return x.movedim(d, d + 1).flatten(d + 1, d + 2)


def serve_mesh_decode(torch, dev) -> dict:
    """Decode over decode_32k's context: the full model, a ring of
    C = 32768 slots for B = 16 rows filled from the seed (every position
    valid, ~12.9 GB), 8 decode steps (and one profiled) run twice — the
    whole cache through the kernel, and the same cache split into 4
    sequence runs as the ranks of model = 4 hold them, each run through
    the kernel with its log-sum-exp and the runs merged by `lse_merge`.
    Before the steps, layer 0's attention at full context three ways:
    whole, 4 runs merged, plain."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.models import transformer as tt
    from repro_torch.models.cache import split_cache
    from repro_torch.parallel.shard_attention import sharded_decode_attention

    cfg = get_config(SERVE_MESH_ARCH)
    B, C, M, T = (SERVE_MESH_B, SERVE_MESH_C, SERVE_MESH_SHARDS,
                  SERVE_MESH_STEPS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tt.init_params(gen, cfg, torch.float32, dev)
    caches = tt.init_caches(cfg, B, C, torch.float32, device=dev)
    ring = caches["units"]["b0"]
    ring["k"].normal_(generator=gen)
    ring["v"].normal_(generator=gen)
    ring["pos"].copy_(torch.arange(C, dtype=torch.int32, device=dev)
                      .expand_as(ring["pos"]))
    ring["ptr"].fill_(C)
    split = split_cache(caches, M)
    sring = split["units"]["b0"]
    kv_bytes = 2 * ring["k"].numel() * 4

    # layer 0's attention at full context
    H, hd = cfg.n_heads, cfg.hd
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
    whole_args = (q, ring["k"][0], ring["v"][0], ring["pos"][0], qpos)
    run_args = (q, sring["k"][0], sring["v"][0], sring["pos"][0], qpos)
    whole = ops.decode_attention(*whole_args)
    merged = sharded_decode_attention(*run_args)
    plain = decode_attention_plain(*whole_args)
    attn = {"runs_vs_whole": float((merged - whole).abs().max()),
            "runs_vs_plain": float((merged - plain).abs().max()),
            "whole_vs_plain": float((whole - plain).abs().max()),
            "ms_whole": time_ms(lambda: ops.decode_attention(*whole_args)),
            "ms_runs_merged": time_ms(
                lambda: sharded_decode_attention(*run_args)),
            "ms_plain": time_ms(lambda: decode_attention_plain(*whole_args),
                                iters=5, warmup=1),
            "bound_ms_layer": kv_bytes / cfg.num_units / HBM_BYTES_PER_S
            * 1e3,
            "library_ms": stacked_sdpa_ms(torch, q, ring["k"][0],
                                          ring["v"][0], ring["pos"][0],
                                          qpos)}
    del plain
    if not all(attn[k] <= SERVE_MESH_TOL for k in
               ("runs_vs_whole", "runs_vs_plain", "whole_vs_plain")):
        raise AssertionError(f"serve_mesh: attention at C={C}: {attn}")

    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (T + 1, B, 1)),
                           device=dev)

    def run(cc):
        logits, ms = [], []
        before = ops.launch_counts()
        for t in range(T):
            pos = torch.full((B, 1), C + t, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = tt.decode_step(params, cfg, toks[t], pos, cc)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
        after = ops.launch_counts()
        pos = torch.full((B, 1), C + T, dtype=torch.int32, device=dev)
        prof = device_profile(torch, lambda: logits.append(tt.decode_step(
            params, cfg, toks[T], pos, cc)[0]))
        return logits, {
            "ms_a_step": ms, "ms_median": sorted(ms)[len(ms) // 2],
            "decode_attention_launches_a_step":
                (after["decode_attention"] - before["decode_attention"]) / T,
            "launches_a_step": prof["launches"],
            "device_ms_a_step": prof["device_ms"],
            "top": prof["top"][:5]}

    ops.reset_launch_counts()  # the main path: the two runs of the steps
    whole_logits, whole_run = run(caches)
    split_logits, split_run = run(split)
    launches = ops.launch_counts()
    logit_err = [float((a - b).abs().max())
                 for a, b in zip(split_logits, whole_logits)]
    cache_equal = (torch.equal(_joined(sring["pos"], 1), ring["pos"])
                   and torch.equal(sring["ptr"], ring["ptr"]))
    checks = {
        "attention_within_tol": True,
        "logits_within_tol": max(logit_err) <= SERVE_MESH_LOGIT_TOL,
        "finite": all(bool(torch.isfinite(x).all()) for x in split_logits),
        "pos_and_ptr_equal": cache_equal,
        "whole_one_launch_a_layer":
            whole_run["decode_attention_launches_a_step"] == cfg.n_layers,
        "runs_four_launches_a_layer":
            split_run["decode_attention_launches_a_step"]
            == M * cfg.n_layers,
    }
    out = {"config": cfg.name, "layers": cfg.n_layers, "B": B, "C": C,
           "shards": M, "steps": T, "kv_cache_gb": kv_bytes / 1e9,
           "attention_layer0": attn, "whole": whole_run, "runs": split_run,
           "logits_max_abs_err": logit_err,
           "logit_tolerance": SERVE_MESH_LOGIT_TOL,
           "attention_tolerance": SERVE_MESH_TOL, "launches": launches,
           "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_mesh decode checks failed: {out}")
    return out


def stacked_sdpa_ms(torch, q, k, v, kpos, qpos) -> float:
    """``scaled_dot_product_attention`` of one decode query a row, q (B,
    H, hd), over a ring's rows k / v (B, C, KV, hd): the G = H / KV query
    heads of each KV head stacked as G query rows, (B, KV, G, hd) over
    (B, KV, C, hd) keys, masked to the visible positions — the cache is
    not expanded to H heads.  Its ms (CUDA events)."""
    import torch.nn.functional as F

    B, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    mask = ((kpos >= 0) & (kpos <= qpos[:, None]))[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qg, kh, vh, attn_mask=mask), iters=5, warmup=1)


def causal_sdpa_ms(torch, q, k, v) -> float:
    """Causal ``scaled_dot_product_attention`` on q (B, S, H, hd) and k / v
    (B, S, KV, hd) with the KV heads repeated to H, through the
    memory-efficient backend (the math one would hold the S × S scores),
    or for bf16 the flash backend where it takes the inputs.  Its ms
    (CUDA events)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H, KV = q.shape[2], k.shape[2]
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1)
              .contiguous() for t in (k, v))
    backends = [SDPBackend.EFFICIENT_ATTENTION]
    if q.dtype == torch.bfloat16:
        backends.insert(0, SDPBackend.FLASH_ATTENTION)
    with sdpa_kernel(backends):
        return time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=3, warmup=1)


def serve_mesh_prefill(torch, dev) -> dict:
    """Prefill at prefill_32k's length (B = 1 × S = 32768, H=14, KV=2,
    hd=64, causal): the flash kernel on four runs of the query heads
    (`SERVE_MESH_HEAD_CUT`, each with the KV heads it uses, as
    `shard_attention.mesh_prefill_attention` takes them) concatenated,
    against the whole call and the plain version; then the prefill's
    write into a 32768-slot ring split into 4 sequence runs
    (`prefill_shard` per run) against the single-device write."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.cache import (kv_cache_write_prefill,
                                          make_kv_cache, split_cache)
    from repro_torch.parallel.shard_attention import _kv_heads_for

    S, H, KV, hd, M = SERVE_MESH_PREFILL_S, 14, 2, 64, SERVE_MESH_SHARDS
    q, k, v = flash_case(torch, dev, seed=47, B=1, S=S, H=H, KV=KV, hd=hd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    parts, h0 = [], 0
    t0 = time.perf_counter()
    for n in SERVE_MESH_HEAD_CUT:
        kl, vl = (_kv_heads_for(t, h0, n, H // KV) for t in (k, v))
        parts.append(ops.flash_attention(q[:, :, h0:h0 + n].contiguous(),
                                         kl.contiguous(), vl.contiguous()))
        h0 += n
    cut = torch.cat(parts, 2)
    torch.cuda.synchronize()
    cut_ms = (time.perf_counter() - t0) * 1e3
    plain = flash_attention_plain(q, k, v)
    errs = {"runs_vs_whole": float((cut - whole).abs().max()),
            "whole_vs_plain": float((whole - plain).abs().max())}
    del plain, parts, cut
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
    one = kv_cache_write_prefill(make_kv_cache(1, S, KV, hd, torch.float32,
                                               dev), k, v, positions)
    runs = kv_cache_write_prefill(split_cache(
        make_kv_cache(1, S, KV, hd, torch.float32, dev), M), k, v, positions)
    write_equal = (all(torch.equal(_joined(runs[n], 0), one[n])
                       for n in ("k", "v", "pos"))
                   and torch.equal(runs["ptr"], one["ptr"]))
    checks = {"runs_within_tol": errs["runs_vs_whole"] <= SERVE_MESH_TOL,
              "plain_within_tol": errs["whole_vs_plain"] <= SERVE_MESH_TOL,
              "sequence_write_bit_equal": write_equal}
    out = {"B": 1, "S": S, "H": H, "KV": KV, "hd": hd,
           "head_runs": list(SERVE_MESH_HEAD_CUT), "max_abs_err": errs,
           "ms_whole_first_call": whole_ms, "ms_head_runs_first_call": cut_ms,
           "ms_whole": time_ms(lambda: ops.flash_attention(q, k, v), iters=3,
                               warmup=1),
           "bound_ms": 3 * 4 * H * S * (S + 1) / 2 * hd / TF32_FLOPS * 1e3,
           "bound_by": "operations (3xTF32)",
           "library_ms": causal_sdpa_ms(torch, q, k, v), "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_mesh prefill checks failed: {out}")
    return out


def _serve_steps(torch, cfg, params, B, dev, mesh=None,
                 dtype=None) -> tuple:
    """`make_prefill_step` / `make_decode_step` (under ``mesh`` when given)
    over `SERVE_MESH_SMALL`: a prefill of S tokens into rings of C (f32,
    or ``dtype``), then the decode steps.  Returns every step's whole
    logits and ms."""
    import numpy as np

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.models.transformer import init_caches
    from repro_torch.parallel import sharding, steps

    S, C, T = (SERVE_MESH_SMALL[k] for k in ("S", "C", "steps"))
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (T, B, 1)), device=dev)
    with sharding.use_mesh(mesh):
        prefill = steps.make_prefill_step(cfg, ShapeSpec("p", S, B, "prefill"))
        decode = steps.make_decode_step(cfg, ShapeSpec("d", C, B, "decode"))
    caches = init_caches(cfg, B, C, dtype or torch.float32, device=dev)
    logits, ms = [], []
    for t in range(T + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == 0:
            lg, caches = prefill(params, {"tokens": prompt}, caches)
        else:
            pos = torch.full((B, 1), S + t - 1, dtype=torch.int32, device=dev)
            lg, caches = decode(params, toks[t - 1], pos, caches)
        if hasattr(lg, "full_tensor"):  # a DTensor: the whole logits
            lg = lg.full_tensor()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return logits, ms


def serve_mesh_one_rank(torch, dev) -> dict:
    """`make_prefill_step` / `make_decode_step` on a one-rank CUDA mesh (a
    world of one gloo rank in this process; its caches and parameters
    DTensors) against the same steps on one device: a prefill of 1024
    tokens at B = 2 into 2048-slot rings, then 8 decode steps."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import steps

    cfg = get_config(SERVE_MESH_ARCH)
    B = 2
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         torch.float32, dev)
    ops.reset_launch_counts()
    one, one_ms = _serve_steps(torch, cfg, params, B, dev)
    one_launches = ops.launch_counts()
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(str(Path(d, "store")), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            mesh = make_dev_mesh(1, 1, device=dev)
            mparams = steps.serve_params(params, mesh)
            ops.reset_launch_counts()  # the main path: the meshed steps
            got, ms = _serve_steps(torch, cfg, mparams, B, dev, mesh)
            launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    err = [float((a - b).abs().max()) for a, b in zip(got, one)]
    checks = {"logits_within_tol": max(err) <= SERVE_MESH_TOL,
              "same_kernel_launches": launches == one_launches}
    out = {"config": cfg.name, "B": B, **SERVE_MESH_SMALL,
           "single_ms": one_ms, "one_rank_mesh_ms": ms,
           "logits_max_abs_err": err, "tolerance": SERVE_MESH_TOL,
           "launches": launches, "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_mesh one-rank checks failed: {out}")
    return out


def serve_mesh(torch, dev) -> tuple:
    """The phase: the lse kernel checks; decode over decode_32k's context,
    whole and in 4 sequence runs; prefill at prefill_32k's length; the
    serve steps on a one-rank CUDA mesh.  Its main path is the model's
    decode steps (both runs) and the meshed steps, each with the kernels'
    launch counts set to 0 just before it and read just after.  Returns
    (the phase's line, its main path's launches)."""
    from repro_torch.kernels import ops

    out = {"lse": serve_mesh_lse(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["decode_32k"] = serve_mesh_decode(torch, dev)
    out["decode_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill_32k"] = serve_mesh_prefill(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["one_rank_mesh"] = serve_mesh_one_rank(torch, dev)
    a, b = out["decode_32k"]["launches"], out["one_rank_mesh"]["launches"]
    launches = {k: a[k] + b[k] for k in a}
    out["launches"] = launches
    if not (launches["decode_attention"] and launches["flash_attention"]):
        raise AssertionError(f"serve_mesh: a kernel was not launched: "
                             f"{launches}")
    return out, launches


def _serve_mesh_rank(rank: int, world: int, init_file: str,
                     out_dir: str) -> None:
    """A rank of ``--serve-mesh-cards``: on ``cuda:rank`` over NCCL, the
    full qwen2-0.5b's serve steps on (data 2, model 2) at B = 4 and on
    (data 1, model 4) at B = 1 (the sequence over ``model``), and rank
    0's single-device steps at each batch; in f32, then at `StepConfig`'s
    bf16 (bf16 parameters and caches).  Writes ``out_dir/rank.json``."""
    sys.path.insert(0, str(SRC))
    import torch

    torch.cuda.set_device(rank)
    os.environ["LOCAL_RANK"] = str(rank)  # `launch.mesh.local_device`
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_rank, make_dev_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import steps

    dev = torch.device("cuda", rank)
    init_rank(rank, world, init_file, "nccl", timeout_s=600)
    cfg = get_config(SERVE_MESH_ARCH)
    res = {"rank": rank}
    for dtype, tag in ((torch.float32, ""),
                       (steps.StepConfig().param_dtype, "_bf16")):
        params = init_params(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, dtype, dev)
        for dims, B in (((2, 2), 4), ((1, 4), 1)):
            key = f"{dims[0]}x{dims[1]}_b{B}{tag}"
            if rank == 0:
                one, one_ms = _serve_steps(torch, cfg, params, B, dev,
                                           dtype=dtype)
            mesh = make_dev_mesh(*dims, device=dev)
            ops.reset_launch_counts()
            got, ms = _serve_steps(torch, cfg,
                                   steps.serve_params(params, mesh), B, dev,
                                   mesh, dtype=dtype)
            res[key] = {"ms": ms, "launches": ops.launch_counts()}
            if rank == 0:
                res[key].update(single_ms=one_ms, logits_max_abs_err=[
                    float((a - b).abs().max()) for a, b in zip(got, one)],
                    logits_rel_gap=[float((a - b).abs().max()
                                          / b.abs().max())
                                    for a, b in zip(got, one)])
            torch.distributed.barrier()
        del params
    Path(out_dir, f"{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


def serve_mesh_cards(torch) -> dict:
    """``--serve-mesh-cards``: the meshed serve steps over NCCL, one rank
    on each of four cards; every rank's logits are held to rank 0's
    single-device steps within `SERVE_MESH_LOGIT_TOL` in f32, within
    `BF16_LOGIT_TOL` × max |logit| at bf16 (the shards' partial sums
    round to bf16 at other points), the bf16 kernels launched and no f32
    one."""
    if torch.cuda.device_count() < 4:
        raise RuntimeError("--serve-mesh-cards needs four cards")
    with tempfile.TemporaryDirectory() as d:
        clean = run_ranks(_serve_mesh_rank, 4, (str(Path(d, "init")), d),
                          900)
        ranks = [json.loads(Path(d, f"{r}.json").read_text())
                 if Path(d, f"{r}.json").exists() else None
                 for r in range(4)]
    if not clean or any(r is None for r in ranks):
        raise AssertionError(f"serve_mesh_cards: a rank failed "
                             f"({run_ranks.exitcodes}, {ranks})")
    r0 = ranks[0]
    checks = {}
    for k in r0:
        if k.endswith("_bf16"):
            n = r0[k]["launches"]
            checks[k] = (max(r0[k]["logits_rel_gap"]) <= BF16_LOGIT_TOL
                         and n["decode_attention_bf16"] > 0
                         and n["flash_attention_bf16"] > 0
                         and n["decode_attention"] == 0
                         and n["flash_attention"] == 0)
        elif k != "rank":
            checks[k] = (max(r0[k]["logits_max_abs_err"])
                         <= SERVE_MESH_LOGIT_TOL)
    out = {"config": SERVE_MESH_ARCH, **SERVE_MESH_SMALL,
           "tolerance": {"f32": SERVE_MESH_LOGIT_TOL,
                         "bf16": f"{BF16_LOGIT_TOL} x max |logit|"},
           "rank0": r0,
           "ms_by_rank": {k: [r[k]["ms"] for r in ranks]
                          for k in r0 if k != "rank"},
           "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_mesh_cards checks failed: {out}")
    return out


# ------------------------------------------------------------ serve_bf16 ----

# serve_bf16: the reference's production dtype on the card — the serve
# steps at the default StepConfig (bf16 parameters, bf16 caches),
# qwen2-0.5b as published, TF32 off
# a bf16 kernel against its plain version: within BF16_ULPS bf16 ulps of
# each output row's largest magnitude (rows along hd; both round P to bf16,
# against running maxima taken at different points), and within the
# outer BF16_TOL (atol = rtol); the log-sum-exp (f32 from exact bf16
# products) within BF16_LSE_TOL.  Readings on an H100: at most 1.06 ulps
# and 9.5e-7 over every shape checked
BF16_ULPS = 2.0
BF16_TOL = 2.0 ** -7
BF16_LSE_TOL = 1e-5
BF16_FLOPS = 989e12                  # H100 SXM bf16 tensor cores, dense
BF16_B, BF16_C = 128, 32768          # decode_32k as published
BF16_STEPS = 8
BF16_RUNS = 4                        # layer 0's sequence runs, merged
BF16_PREFILL_S = 32768               # prefill_32k's length; batch 32 cut to 1
BF16_LOGIT_TOL = 5e-2                # decode vs fresh prefill, × max |logit|
# the bf16 flash kernel's head widths on the wgmma route
# (csrc/flash_attention_sm90.cu), and serve_bf16's sweep of it at
# qwen2-0.5b's heads (B=1, causal) against SDPA and the mma.sync kernel
WGMMA_HD = (64, 128, 256)
FLASH_SWEEP_S = (4096, 8192, 16384, 32768)
FLASH_SWEEP_PLAIN_MAX_S = 16384      # the plain version's check, up to here
WGMMA_KERNEL = "flash_attention_wgmma_kernel"


def bf16_close(torch, got, want, what: str) -> dict:
    """``got`` of ``want``'s dtype within `BF16_ULPS` bf16 ulps of each
    output row's largest |want| and within `BF16_TOL` (atol = rtol): the
    max |error|, the max error in those ulps and the share of outputs
    bit-equal."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    top = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulps = err / torch.exp2(torch.floor(torch.log2(top)) - 7)
    out = {"max_abs_err": float(err.max()),
           "max_row_ulps": float(ulps.max()),
           "bit_equal": float((g == w).float().mean())}
    if (got.dtype != want.dtype or not bool((ulps <= BF16_ULPS).all())
            or not torch.allclose(g, w, atol=BF16_TOL, rtol=BF16_TOL)):
        raise AssertionError(f"{what}: {got.dtype} vs {want.dtype}, {out}")
    return out


def bf16_kernel_check(torch, dev) -> dict:
    """Both attention kernels' bf16 instantiations against their plain
    versions on bf16 inputs at every shape of kernel_check and
    block_kind_kernel_check (windows, rolling rings, hd 18–896), within
    `bf16_close`'s limits, with the share bit-equal; decode also with
    ``return_lse`` (the f32 partial, and its log-sum-exp within
    `BF16_LSE_TOL`, −inf at the same places).  Every shape is checked
    before a failure is raised, with each shape's readings."""
    from repro_torch.kernels.decode_attention import (decode_attention_bf16,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_bf16,
                                                     flash_attention_plain)

    bf16 = torch.bfloat16
    out, failed = {}, []
    for kind, name, seed, kw, window in ATTENTION_SHAPES + BLOCK_KIND_SHAPES:
        key = f"{kind}_attention {name}"
        try:
            if kind == "flash":
                args = flash_case(torch, dev, seed=seed, dtype=bf16, **kw)
                out[key] = bf16_close(
                    torch, flash_attention_bf16(*args, window=window),
                    flash_attention_plain(*args, window=window), key)
                continue
            args, window = decode_case(torch, dev, seed=seed, dtype=bf16,
                                       **kw)
            r = out[key] = bf16_close(
                torch, decode_attention_bf16(*args, window=window),
                decode_attention_plain(*args, window=window), key)
            got, lse = decode_attention_bf16(*args, window=window,
                                             return_lse=True)
            want, want_lse = decode_attention_plain(*args, window=window,
                                                    return_lse=True)
            fin = torch.isfinite(want_lse)
            r["lse_max_abs_err"] = float(
                (lse[fin] - want_lse[fin]).abs().max())
            if not (torch.equal(torch.isneginf(lse),
                                torch.isneginf(want_lse))
                    and torch.allclose(lse[fin], want_lse[fin],
                                       atol=BF16_LSE_TOL, rtol=0.0)):
                raise AssertionError(f"{key}: log-sum-exp != plain, {r}")
            r["lse_out"] = bf16_close(torch, got, want, f"{key} lse out")
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError(f"bf16 kernel checks failed: {failed}; {out}")
    return out


def _bf16_model(torch, dev):
    """qwen2-0.5b as published with `StepConfig`'s parameter dtype (bf16),
    random weights from the seed; the default StepConfig."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.steps import StepConfig

    cfg, sc = get_config(SERVE_MESH_ARCH), StepConfig()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         sc.param_dtype, dev)
    if params["embed"].dtype != torch.bfloat16:
        raise AssertionError(f"StepConfig's param dtype is {sc.param_dtype}")
    return cfg, sc, params


def serve_bf16_decode(torch, dev) -> tuple:
    """decode_32k as published: a bf16 ring of C = 32768 slots for B = 128
    rows filled from the seed (every position valid, 51.5 GB), layer 0's
    attention three ways (the bf16 kernel whole, `BF16_RUNS` sequence runs
    through it merged by `lse_merge`, the plain version), then
    `BF16_STEPS` steps of `make_decode_step(cfg, SHAPES["decode_32k"])`
    (the main path, its launch counts set to 0 just before) and one
    profiled.  Returns (the line's part, the main path's launches)."""
    import numpy as np

    from repro_torch.configs.registry import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (decode_attention_bf16,
                                                      decode_attention_plain)
    from repro_torch.models.cache import split_cache
    from repro_torch.models.transformer import init_caches
    from repro_torch.parallel.shard_attention import sharded_decode_attention
    from repro_torch.parallel.steps import make_decode_step

    cfg, sc, params = _bf16_model(torch, dev)
    B, C, T = BF16_B, BF16_C, BF16_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    caches = init_caches(cfg, B, C, torch.bfloat16, device=dev)
    ring = caches["units"]["b0"]
    ring["k"].normal_(generator=gen)
    ring["v"].normal_(generator=gen)
    ring["pos"].copy_(torch.arange(C, dtype=torch.int32, device=dev)
                      .expand_as(ring["pos"]))
    ring["ptr"].fill_(C)
    kv_bytes = 2 * ring["k"].numel() * ring["k"].element_size()
    layer_bytes = kv_bytes / cfg.num_units

    # layer 0's attention at full context, three ways
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
    whole_args = (q, ring["k"][0], ring["v"][0], ring["pos"][0], qpos)
    whole = ops.decode_attention(*whole_args)
    plain = decode_attention_plain(*whole_args)
    attn = {"whole_vs_plain": bf16_close(torch, whole, plain,
                                         "decode_32k layer 0 whole")}
    del plain
    runs = split_cache({n: ring[n][0] for n in ("k", "v", "pos")} | {
        "ptr": ring["ptr"]}, BF16_RUNS)
    run_args = (q, runs["k"], runs["v"], runs["pos"], qpos)
    attn["runs_vs_whole"] = bf16_close(
        torch, sharded_decode_attention(*run_args), whole,
        f"decode_32k layer 0 in {BF16_RUNS} runs")
    n_bytes = layer_bytes + 2 * B * H * hd * 2 + B * C * 4 + B * 4
    n_ops = 4 * B * C * H * hd
    attn.update({
        "ms_whole": time_ms(lambda: decode_attention_bf16(*whole_args),
                            iters=10),
        "kernel_device_ms": kernel_device_ms(   # hd = 64: the tensor cores
            torch, lambda: decode_attention_bf16(*whole_args),
            "decode_tc_kernel", calls=20),
        "ms_runs_merged": time_ms(
            lambda: sharded_decode_attention(*run_args), iters=5),
        "plain_ms": time_ms(lambda: decode_attention_plain(*whole_args),
                            iters=3, warmup=1),
        "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                        n_ops / BF16_FLOPS) * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / BF16_FLOPS else "operations"),
        "library_ms": stacked_sdpa_ms(torch, *whole_args)})
    del runs, run_args, whole

    step = make_decode_step(cfg, SHAPES["decode_32k"], sc)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (T + 1, B, 1)), device=dev)
    logits, ms = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path: the decode steps
    for t in range(T):
        pos = torch.full((B, 1), C + t, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        lg, caches = step(params, toks[t], pos, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    launches = ops.launch_counts()
    pos = torch.full((B, 1), C + T, dtype=torch.int32, device=dev)
    prof = device_profile(torch, lambda: step(params, toks[T], pos, caches))
    checks = {
        "attention_within_tol": True,
        "logits_f32_finite": all(
            x.dtype == torch.float32 and x.shape == (B, cfg.vocab)
            and bool(torch.isfinite(x).all()) for x in logits),
        "caches_bf16": ring["k"].dtype == torch.bfloat16,
        "bf16_kernel_a_layer":
            launches["decode_attention_bf16"] == T * cfg.n_layers,
        "no_f32_attention": launches["decode_attention"] == 0,
        "pos_advanced": bool((ring["pos"][:, :, :T] == C + torch.arange(
            T, device=dev, dtype=torch.int32)).all()),
    }
    out = {"config": cfg.name, "layers": cfg.n_layers, "B": B, "C": C,
           "steps": T, "param_dtype": str(sc.param_dtype),
           "kv_cache_gb": kv_bytes / 1e9,
           "attention_layer0": attn, "ms_a_step": ms,
           "ms_median": sorted(ms)[len(ms) // 2],
           "bound_ms_a_step": kv_bytes / HBM_BYTES_PER_S * 1e3,
           "launches_a_step": prof["launches"],
           "device_ms_a_step": prof["device_ms"], "top": prof["top"][:5],
           "decode_attention_bf16_launches_a_step":
               launches["decode_attention_bf16"] / T,
           "launches": launches, "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_bf16 decode_32k checks failed: {out}")
    return out, launches


def serve_bf16_prefill(torch, dev) -> tuple:
    """prefill_32k's length in bf16: the flash kernel at B = 1 × S = 32768
    (H=14, KV=2, hd=64, causal) against its plain version, its ms beside
    the bound and causal bf16 SDPA's; then `make_prefill_step` at B = 1 ×
    S = 32768 into a 32768-slot bf16 ring, twice (the main path, its
    launch counts set to 0 just before).  Returns (the line's part, the
    main path's launches)."""
    import dataclasses

    from repro_torch.configs.registry import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_bf16,
                                                     flash_attention_plain)
    from repro_torch.models.transformer import init_caches
    from repro_torch.parallel.steps import make_prefill_step

    S, H, KV, hd = BF16_PREFILL_S, 14, 2, 64
    q, k, v = flash_case(torch, dev, seed=49, B=1, S=S, H=H, KV=KV, hd=hd,
                         dtype=torch.bfloat16)
    ops.reset_launch_counts()
    err = bf16_close(torch, flash_attention_bf16(q, k, v),
                     flash_attention_plain(q, k, v), "flash at S=32768")
    route = ops.flash_routes()
    n_ops = 4 * H * S * (S + 1) / 2 * hd
    n_bytes = S * (2 * H + 2 * KV) * hd * 2
    flash = {
        "B": 1, "S": S, "H": H, "KV": KV, "hd": hd, **err,
        "ms": time_ms(lambda: flash_attention_bf16(q, k, v), iters=5),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: flash_attention_bf16(q, k, v), WGMMA_KERNEL,
            calls=20),
        "route": route,
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), iters=1,
                            warmup=1),
        "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS) * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / BF16_FLOPS else "operations"),
        "library_ms": causal_sdpa_ms(torch, q, k, v)}
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()

    cfg, sc, params = _bf16_model(torch, dev)
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=1)
    step = make_prefill_step(cfg, shape, sc)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=g, device=dev)
    ms = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path: the prefill steps
    for _ in range(2):          # each into an empty ring
        caches = init_caches(cfg, 1, S, torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": toks}, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    routes = ops.flash_routes()
    ring = caches["units"]["b0"]
    checks = {
        "flash_within_tol": True,
        "flash_wgmma_route": route == {"wgmma": 1, "mma_sync": 0},
        "step_flash_wgmma_route": routes == {
            "wgmma": launches["flash_attention_bf16"], "mma_sync": 0},
        "logits_f32_finite": (logits.dtype == torch.float32
                              and tuple(logits.shape) == (1, cfg.vocab)
                              and bool(torch.isfinite(logits).all())),
        "ring_written": (ring["k"].dtype == torch.bfloat16
                         and bool((ring["ptr"] == S).all())),
        "bf16_kernel_a_layer":
            launches["flash_attention_bf16"] == 2 * cfg.n_layers,
        "no_f32_attention": launches["flash_attention"] == 0,
    }
    out = {"flash": flash, "step": {
        "B": 1, "S": S, "cut": "batch 32 → 1", "ms_a_step": ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
        "launches": launches, "flash_routes": routes, "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"serve_bf16 prefill_32k checks failed: {out}")
    return out, launches


def mma_sync_flash(torch):
    """The bf16 flash kernel's mma.sync instantiation
    (csrc/flash_attention.cu) called through its own entry, whatever the
    shape: the kernel the wgmma route replaced at hd 64, 128 and 256,
    timed beside it."""
    import math

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    entry = getattr(build.load("flash_attention", fa._SIG["flash_attention"]),
                    "flash_attention_bf16_launch")

    def call(q, k, v, window=0):
        out = torch.empty_like(q)
        B, Sq, H, hd = q.shape
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, k.shape[1], H, k.shape[2], hd, window,
                   1.0 / math.sqrt(hd),
                   torch._C._cuda_getCurrentRawStream(q.device.index))
        build.check(rc, "flash_attention_bf16 (mma_sync)")
        return out
    return call


def flash_sweep(torch, dev) -> dict:
    """The bf16 flash kernel at qwen2-0.5b's heads (B=1, H 14, KV 2, hd
    64, causal) over S in `FLASH_SWEEP_S`: its route (`ops.flash_routes`),
    ms (CUDA events) beside the bound (bf16 at 989 TFLOP/s) and causal
    bf16 SDPA's ms, the mma.sync instantiation's ms on the same inputs,
    and up to `FLASH_SWEEP_PLAIN_MAX_S` its agreement with the plain
    version (`bf16_close`); the two kernels against each other at every
    S.  Checks the route only: the times are reported."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_bf16,
                                                     flash_attention_plain)

    H, KV, hd = 14, 2, 64
    old = mma_sync_flash(torch)
    rows = []
    for S in FLASH_SWEEP_S:
        q, k, v = flash_case(torch, dev, seed=53, B=1, S=S, H=H, KV=KV,
                             hd=hd, dtype=torch.bfloat16)
        ops.reset_launch_counts()
        got = flash_attention_bf16(q, k, v)
        row = {"S": S, "route": ops.flash_routes()}
        n_ops = 4 * H * S * (S + 1) / 2 * hd
        row.update(
            ms=time_ms(lambda: flash_attention_bf16(q, k, v),
                       iters=10 if S > 8192 else 20),
            mma_sync_ms=time_ms(lambda: old(q, k, v), iters=3, warmup=1),
            library_ms=causal_sdpa_ms(torch, q, k, v),
            bound_ms=n_ops / BF16_FLOPS * 1e3, bound_by="operations",
            vs_mma_sync=bf16_close(torch, got, old(q, k, v),
                                   f"sweep S={S}: wgmma vs mma.sync"))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if S <= FLASH_SWEEP_PLAIN_MAX_S:
            row["vs_plain"] = bf16_close(torch, got,
                                         flash_attention_plain(q, k, v),
                                         f"sweep S={S}")
        rows.append(row)
        del q, k, v, got
    gc.collect()
    torch.cuda.empty_cache()
    if not all(r["route"] == {"wgmma": 1, "mma_sync": 0} for r in rows):
        raise AssertionError(f"flash sweep: not on the wgmma route: {rows}")
    return {"shape": {"B": 1, "H": H, "KV": KV, "hd": hd, "causal": True},
            "rows": rows}


def bf16_rows(by_path, res, at_kinds, routes=None) -> list:
    """The `kernels` line's rows of the two bf16 instantiations, from
    serve_bf16's measurements at its main path's shapes (decode: layer 0
    of decode_32k, B=128 × C=32768; flash: B=1 × S=32768): launches on
    the main paths (``by_path``: each path's launch counts), ms, kernel
    alone, bound at the bf16 rates, plain ms, SDPA ms and max error; and
    from serve_bf16_kinds (``at_kinds``) the same at the block kinds'
    shapes and the host µs a call.  The flash row's source is the wgmma
    kernel, the route of every main-path call at hd 64, 128 and 256;
    ``routes`` ({path: launches by route}) says so, and its
    ``mma_sync_ms`` is the kernel it replaced, timed in this run."""
    dec = res["decode_32k"]["attention_layer0"]
    fl = res["prefill_32k"]["flash"]
    out = []
    for name, r, err, shape in (
            ("decode_attention", dec, dec["whole_vs_plain"],
             {"B": BF16_B, "C": BF16_C, "H": 14, "KV": 2, "hd": 64}),
            ("flash_attention", fl, fl,
             {"B": 1, "S": BF16_PREFILL_S, "H": 14, "KV": 2, "hd": 64,
              "causal": True})):
        out.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": ("src/repro_torch/csrc/flash_attention_sm90.cu"
                       if name == "flash_attention"
                       else f"src/repro_torch/csrc/{name}.cu"),
            "replaces": {"decode_attention":
                         "src/repro/kernels/decode_attention.py:102",
                         "flash_attention":
                         "src/repro/kernels/flash_attention.py:149"}[name],
            "launches": sum(p[f"{name}_bf16"] for p in by_path.values()),
            "launches_by_path": {k: p[f"{name}_bf16"]
                                 for k, p in by_path.items()
                                 if p[f"{name}_bf16"]},
            "max_abs_err": err["max_abs_err"],
            "max_row_ulps": err["max_row_ulps"],
            "ms": r["ms_whole"] if name == "decode_attention" else r["ms"],
            "kernel_device_ms": r["kernel_device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "host_us": at_kinds["host_us"][f"{name}_bf16"],
            "at_block_kind_shapes": at_kinds[f"{name}_bf16"],
            "dtype": "bf16", "shape": shape})
    flash = out[1]
    sweep = {r["S"]: r for r in res["flash_sweep"]["rows"]}
    flash["mma_sync_ms"] = sweep[BF16_PREFILL_S]["mma_sync_ms"]
    flash["mma_sync_source"] = "src/repro_torch/csrc/flash_attention.cu"
    flash["routes_by_path"] = routes or {}
    return out


def serve_bf16(torch, dev) -> tuple:
    """The phase: the bf16 kernel checks; decode_32k at its published
    batch; prefill_32k's length; prefill_model's self-consistency check
    at bf16; the flash kernel's sweep over S (`flash_sweep`).  Its main
    path is the decode steps, the prefill steps and the self-consistency
    run, each with the launch counts set to 0 just before it and read
    just after; ``flash_routes`` sums their bf16 flash launches by
    route.  Returns (the phase's line, its main path's launches)."""
    out = {"kernel_check": bf16_kernel_check(torch, dev)}
    eq = [r["bit_equal"] for r in out["kernel_check"].values()]
    out["kernel_check_bit_equal_min"] = min(eq)
    out["kernel_check_row_ulps_max"] = max(
        r["max_row_ulps"] for r in out["kernel_check"].values())
    for name, fn in (("decode_32k", serve_bf16_decode),
                     ("prefill_32k", serve_bf16_prefill)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[name], _ = fn(torch, dev)
        out[name]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
    out["self_consistency"] = prefill_model(torch, dev,
                                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    out["flash_sweep"] = flash_sweep(torch, dev)
    out["flash_sweep"]["seconds"] = time.perf_counter() - t0
    out["flash_routes"] = {r: out["prefill_32k"]["flash_routes"][r]
                           + out["self_consistency"]["flash_routes"][r]
                           for r in ("wgmma", "mma_sync")}
    parts = [out[n]["launches"] for n in ("decode_32k", "prefill_32k",
                                          "self_consistency")]
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    out["launches"] = launches
    if not (launches["decode_attention_bf16"]
            and launches["flash_attention_bf16"]):
        raise AssertionError(f"serve_bf16: a bf16 kernel was not launched: "
                             f"{launches}")
    return out, launches


# ------------------------------------------------------ serve_bf16_kinds ----

# serve_bf16_kinds: the other block kinds' serve steps at StepConfig()'s
# bf16 — granite-moe-3b-a800m, deepseek-moe-16b, recurrentgemma-9b and
# xlstm-350m at full width with the f32 block-kind phases' depth cuts
# (block_kind_configs), bf16 parameters from init_params and bf16 caches,
# prefill_model's check (MoE at PREFILL_CAPACITY_FACTOR, recurrentgemma at
# B=1 × S=2304 so that its 2048 window binds); then both bf16 kernels at
# those kinds' attention shapes, beside their bounds at the bf16 rates and
# bf16 SDPA, and their host µs a call at the f32 rows' shapes


def serve_bf16_kinds(torch, dev) -> tuple:
    """The phase: prefill_model at bf16 for each block kind, one profiled
    decode step each, every configuration freed before the next.  Its
    main path is each kind's prefill, decode steps and fresh prefills
    (prefill_model sets the launch counts to 0 just before and reads them
    just after).  Returns (the phase's line, its main path's launches)."""
    import dataclasses
    import statistics

    from repro_torch.parallel.steps import StepConfig

    dtype = StepConfig().param_dtype
    out, parts = {}, []
    for name, cfg in block_kind_configs().items():
        kw = (dict(B=HYBRID_PREFILL_B, S=HYBRID_PREFILL_S)
              if name == "hybrid" else {})
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=PREFILL_CAPACITY_FACTOR)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = prefill_model(torch, dev, cfg, dtype=dtype, profile_decode=True,
                            **kw)
        res["seconds"] = time.perf_counter() - t0
        res["decode_ms_median"] = statistics.median(res["decode_ms"])
        res["attention_bf16_launches"] = {
            k: res["launches"][k] for k in ("flash_attention_bf16",
                                            "decode_attention_bf16")}
        out[name] = res
        parts.append(res["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    out["launches"] = launches
    out["flash_routes"] = {r: sum(out[n]["flash_routes"][r] for n in out
                                  if "flash_routes" in out[n])
                           for r in ("wgmma", "mma_sync")}
    if out["flash_routes"] != {"wgmma": launches["flash_attention_bf16"],
                               "mma_sync": 0}:
        raise AssertionError(f"serve_bf16_kinds: a bf16 flash call off the "
                             f"wgmma route: {out['flash_routes']}")
    out["kernels_at_kinds"] = bf16_kind_attention_rows(torch, dev)
    return out, launches


def bf16_kind_attention_rows(torch, dev) -> dict:
    """Both bf16 kernels at the block kinds' attention shapes, as their
    paths call them (`BLOCK_KIND_FLASH`; decode at serve_model's 8 slots
    over a full 256-row cache and recurrentgemma's full 2048-row ring at
    B=1: hd 256, G=16, the CUDA-core form): each against its plain
    version (`bf16_close`), the wrapper's ms, the bound from these inputs
    at the bf16 rates (2-byte elements; 989 TFLOP/s), the plain version's
    ms and bf16 SDPA's (flash: causal over the repeated KV heads with the
    window as a mask; decode: each KV head's G query heads stacked as
    rows, `stacked_sdpa_ms`).  Then each wrapper's host µs a call
    (`host_split`) at the f32 rows' shapes (decode: serve_model's; flash:
    prefill_model's)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention_bf16,
                                                      decode_attention_plain)
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_bf16,
                                                     flash_attention_plain)

    bf16 = torch.bfloat16
    old = mma_sync_flash(torch)
    out = {"flash_attention_bf16": [], "decode_attention_bf16": []}
    for name, heads, window, B, S in BLOCK_KIND_FLASH:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        q, k, v = flash_case(torch, dev, seed=37, B=B, S=S, dtype=bf16,
                             **heads)
        ops.reset_launch_counts()
        err = bf16_close(torch, flash_attention_bf16(q, k, v, window=window),
                         flash_attention_plain(q, k, v, window=window),
                         f"flash bf16 {name}")
        route = ops.flash_routes()
        if route != {"wgmma": 1, "mma_sync": 0}:
            raise AssertionError(f"flash bf16 {name}: route {route}")
        qh = q.permute(0, 2, 1, 3).contiguous()
        kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1)
                  .contiguous() for t in (k, v))
        i = torch.arange(S, device=dev)
        vis = i[:, None] >= i[None, :]
        if window:
            vis &= (i[:, None] - i[None, :]) < window
        pairs = B * H * float(vis.sum())
        bound, by = _bound(B * S * (2 * H + 2 * KV) * hd * 2,
                           4 * pairs * hd, BF16_FLOPS)
        out["flash_attention_bf16"].append({
            "config": name, "shape": {"B": B, "S": S, **heads,
                                      "window": window}, **err,
            "route": route,
            "ms": time_ms(lambda: flash_attention_bf16(q, k, v,
                                                       window=window)),
            "mma_sync_ms": time_ms(lambda: old(q, k, v, window)),
            "plain_ms": time_ms(lambda: flash_attention_plain(
                q, k, v, window=window), iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=vis))})
    dec = [(name, heads, 0, MODEL_SLOTS, MODEL_MAX_LEN)
           for name, heads, _, _, _ in BLOCK_KIND_FLASH]
    dec.append(("recurrentgemma prefill_hybrid", BLOCK_KIND_FLASH[2][1],
                2048, HYBRID_PREFILL_B, 2048))
    for name, heads, window, B, C in dec:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        (q, k, v, _, _), _ = decode_case(torch, dev, seed=39, B=B, C=C,
                                         dtype=bf16, **heads)
        kpos = torch.arange(C, dtype=torch.int32, device=dev).expand(
            B, C).contiguous()
        qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
        args = (q, k, v, kpos, qpos)
        err = bf16_close(torch, decode_attention_bf16(*args, window=window),
                         decode_attention_plain(*args, window=window),
                         f"decode bf16 {name}")
        n_vis = float(B * min(C, window or C))
        bound, by = _bound(2 * n_vis * KV * hd * 2 + 2 * B * H * hd * 2
                           + B * C * 4 + B * 4, 4 * n_vis * H * hd,
                           BF16_FLOPS)
        out["decode_attention_bf16"].append({
            "config": name, "shape": {"B": B, "C": C, **heads,
                                      "window": window,
                                      "visible_keys": int(n_vis)},
            "form": ("tensor cores" if hd % 16 == 0 and hd <= 128
                     else "CUDA cores"), **err,
            "ms": time_ms(lambda: decode_attention_bf16(*args,
                                                        window=window)),
            "plain_ms": time_ms(lambda: decode_attention_plain(
                *args, window=window)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": stacked_sdpa_ms(torch, *args)})
    # host µs a call, at the f32 rows' shapes (model_kernel_rows)
    qwen = dict(H=14, KV=2, hd=64)
    (q, k, v, kpos, qpos), _ = decode_case(
        torch, dev, seed=41, B=MODEL_SLOTS, C=MODEL_MAX_LEN, dtype=bf16,
        **qwen)
    out["host_us"] = {"decode_attention_bf16": host_split(
        torch, lambda: decode_attention_bf16(q, k, v, kpos, qpos))}
    q, k, v = flash_case(torch, dev, seed=35, B=PREFILL_B, S=PREFILL_S,
                         dtype=bf16, **qwen)
    out["host_us"]["flash_attention_bf16"] = host_split(
        torch, lambda: flash_attention_bf16(q, k, v))
    return out


# ------------------------------------------------------------- train_bf16 ----

# train_bf16: the mixed-precision train step at default_step_config's bf16
# (bf16 working parameters, the f32 master and moments): train_model's
# configuration (qwen2-0.5b at full width cut to TRAIN_UNITS layers, B=8 ×
# S=128), TRAIN_BF16_STEPS steps timed and one profiled; then one bf16
# step of each of train_parity's smoke configs, card against CPU.  The
# parity limits are twice the largest gap JAX's own bf16 step opened from
# its f32 step on the same parameters over those eight configs at B=2 ×
# S=32 (JAX on the CPU): the loss 1.83e-3 and the gradient norm 1.48e-2
# (granite-moe), the first moment 0.168 (relative L2 over the tree,
# granite-moe), 1.33% of the master's elements moved more than lr/2 apart
# (xlstm); every master element within 2 lr (a flipped Adam step)
TRAIN_BF16_WARMUP, TRAIN_BF16_TIMED = 2, 4
PARITY_BF16_LOSS_TOL = 3.7e-3
PARITY_BF16_GNORM_TOL = 3.0e-2
PARITY_BF16_MU_L2_TOL = 0.34
PARITY_BF16_FLIP_SHARE = 0.027


def train_bf16(torch, dev, f32_ms=None) -> dict:
    """The phase: train_model's step at bf16 (``f32_ms`` train_model's f32
    step for comparison), then `train_parity` at bf16."""
    import math
    import statistics

    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    cfg, sc, step, batch, state = train_inputs(torch, dev,
                                               param_dtype=torch.bfloat16)
    box = {"state": state}
    del state

    def one():
        box["state"], box["metrics"] = step(box["state"], batch)

    times, losses = [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_BF16_WARMUP + TRAIN_BF16_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(box["metrics"]["loss"]))
    launches = ops.launch_counts()
    ms = statistics.median(times[TRAIN_BF16_WARMUP:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(torch, one, calls=1)
    st = box["state"]
    dtypes = {"params": sorted({str(t.dtype) for t in _leaves(st.params)}),
              "master": sorted({str(t.dtype) for t in _leaves(st.opt.master)}),
              "mu": sorted({str(t.dtype) for t in _leaves(st.opt.mu)})}
    del box, st
    gc.collect()
    torch.cuda.empty_cache()
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    # bytes: the bf16 parameters, their f32 master and both f32 moments
    # read and written once
    state_bytes = 2 * (2 + 3 * 4) * cfg.param_count()
    bound_ms, bound_by = _bound(state_bytes, flops, BF16_FLOPS)
    checks = {
        "finite": all(map(math.isfinite, losses)),
        "bf16_params": dtypes["params"] == ["torch.bfloat16"],
        "f32_master": dtypes["master"] == dtypes["mu"] == ["torch.float32"],
        "no_port_kernel_launched": not any(launches.values()),
    }
    if not all(checks.values()):
        raise AssertionError(f"train_bf16 checks failed: {checks} {losses}")
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "parameters": cfg.param_count(), "B": TRAIN_B, "S": TRAIN_S,
           "param_dtype": str(sc.param_dtype), "accum_steps": sc.accum_steps,
           "remat": sc.remat, "ms_per_step": ms, "step_ms_all": times,
           "f32_ms_per_step": f32_ms,
           "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3), "losses": losses,
           "peak_mem_gb": peak, "launches_per_step": prof["launches"],
           "device_ms_per_step": prof["device_ms"],
           "device_busy": prof["device_ms"] / ms,
           "top_kernels": prof["top"][:6], "step_flops": flops,
           "step_state_bytes": state_bytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "dtypes": dtypes,
           "port_kernel_launches": launches, "checks": checks}
    out["parity"] = train_parity(torch, dev, dtype=torch.bfloat16)
    return out


# ---------------------------------------------------------------- dryrun ----

# the port's dry run (`repro_torch.launch.dryrun`) of qwen2-0.5b's three
# cells on the production pod mesh, in both modes, and recurrentgemma-9b's
# train_4k analysis cell; the two one-card cells
# it predicts (serve_mesh's whole decode step and train_model's step, f32,
# priced at the f32 rate); the GEMM and copy that check the roofline's
# constants
DRYRUN_ARCH = "qwen2-0.5b"
DRYRUN_CELLS = tuple((DRYRUN_ARCH, shape, "pod", mode)
                     for shape in ("train_4k", "prefill_32k", "decode_32k")
                     for mode in ("production", "analysis")) + (
    # the meshed RG-LRU's gate products, which torch 2.11's DTensor could
    # not lower on the batch-sharded, W-sharded activations
    ("recurrentgemma-9b", "train_4k", "pod", "analysis"),)
DRYRUN_TIMEOUT = 240
GEMM_N, COPY_BYTES = 8192, 4e9


def dryrun_cells(path: str) -> int:
    """``--dryrun-cells PATH``: the dry run's records of `DRYRUN_CELLS`
    (each in its own fake process group of 256 ranks) and its counts of
    the two one-card cells, as JSON into PATH.  Runs on the CPU: the dry
    run launches no kernel."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import roofline_terms

    out = {"torch": torch.__version__, "cells": []}
    for arch, shape, mesh, mode in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, mesh, mode)
        rec["seconds"] = time.perf_counter() - t0
        out["cells"].append(rec)
    cfg = get_config(DRYRUN_ARCH)
    one_card = {  # each cell's config as the phase that measures it runs
        "decode_step": (cfg, ShapeSpec("serve_mesh", SERVE_MESH_C,
                                       SERVE_MESH_B, "decode")),
        "train_step": (dataclasses.replace(cfg, num_units=TRAIN_UNITS),
                       ShapeSpec("train_model", TRAIN_S, TRAIN_B, "train"))}
    out["one_card"] = {}
    for name, (c, shape) in one_card.items():
        t0 = time.perf_counter()
        meas, how = dryrun.count_step(c, shape,
                                      sc_over={"param_dtype": torch.float32})
        terms = roofline_terms(meas["flops"], meas["bytes_accessed"], {},
                               "f32")
        out["one_card"][name] = {
            "B": shape.global_batch, "S_or_C": shape.seq_len,
            "flops": meas["flops"], "eager_bytes": meas["bytes_accessed"],
            "T_comp_ms": terms["T_comp"] * 1e3,
            "T_mem_ms": terms["T_mem"] * 1e3,
            "predicted_ms": max(terms["T_comp"], terms["T_mem"]) * 1e3,
            "bound_by": "operations" if terms["T_comp"] >= terms["T_mem"]
            else "bytes", "reconstruction": how,
            "seconds": time.perf_counter() - t0}
    Path(path).write_text(json.dumps(out))
    return 0


def start_dryrun():
    """The dry run's CPU process (`dryrun_cells`), started early so that
    it runs beside the card's phases; `dryrun` collects it.  Should the
    run end before, the process is killed and its directory removed at
    exit.  Returns (the process, its JSON's path)."""
    import atexit

    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    path = str(Path(out_dir, "dryrun.json"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    with open(Path(out_dir, "dryrun.log"), "w") as log:  # not a pipe: it
        # could fill while nobody reads it
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
             path], env=env, stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return proc, path


def _cell_line(rec: dict) -> dict:
    """A dry-run record's line: per-device FLOPs and projected bytes, the
    roofline terms with T_coll by axis, the bottleneck, the seconds."""
    line = {"cell": f"{rec['arch']}/{rec['shape']}/{rec['mesh']}",
            "mode": rec["mode"], "chips": rec["chips"],
            "projected_bytes": rec["memory"]["projected_bytes"],
            "step_config": rec["step_config"], "seconds": rec["seconds"]}
    if "roofline" in rec:
        r = rec["roofline"]
        line.update(
            flops_per_device=rec["cost"]["flops"],
            T_comp_ms=r["T_comp"] * 1e3, T_mem_ms=r["T_mem"] * 1e3,
            T_coll_ms=r["T_coll"] * 1e3,
            T_coll_ms_by_axis={a: t * 1e3 for a, t in
                               r["T_coll_by_axis"].items()},
            T_mem_eager_upper_ms=r["T_mem_eager_upper"] * 1e3,
            bottleneck=r["bottleneck"],
            roofline_fraction=r["roofline_fraction"],
            useful_ratio=r["useful_ratio"],
            collectives_by_kind=rec["collectives"]["by_kind"])
    return line


def gemm_and_copy(torch, dev) -> dict:
    """A bf16 ``torch.matmul`` of GEMM_N³ and a COPY_BYTES device-to-device
    copy timed with CUDA events, beside the datasheet constants the
    roofline prices with (library calls that check the constants; no
    kernel of the port)."""
    from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS

    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev,
                    dtype=torch.bfloat16)
    b = torch.randn((GEMM_N, GEMM_N), generator=g, device=dev,
                    dtype=torch.bfloat16)
    gemm_ms = time_ms(lambda: torch.matmul(a, b), iters=20, warmup=3)
    del a, b
    n = int(COPY_BYTES) // 4
    src = torch.empty(n, dtype=torch.float32, device=dev).fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), iters=10, warmup=2)
    del src, dst
    gemm_rate = 2 * GEMM_N ** 3 / (gemm_ms / 1e3)
    copy_rate = 2 * n * 4 / (copy_ms / 1e3)  # read + write
    return {"gemm_bf16": {"n": GEMM_N, "ms": gemm_ms,
                          "tflops": gemm_rate / 1e12,
                          "datasheet_tflops": PEAK_FLOPS["bf16"] / 1e12,
                          "share": gemm_rate / PEAK_FLOPS["bf16"]},
            "copy": {"bytes": n * 4, "ms": copy_ms,
                     "tb_per_s": copy_rate / 1e12,
                     "datasheet_tb_per_s": HBM_BW / 1e12,
                     "share": copy_rate / HBM_BW}}


def dryrun(torch, dev, proc, path: str, measured: dict) -> dict:
    """The phase: the dry run's records of `DRYRUN_CELLS` (made by the CPU
    process `start_dryrun` began, on the script's own torch) one line each;
    the two one-card cells' predictions against ``measured`` (this run's
    serve_mesh whole decode step and train_model step); the GEMM and copy
    rates.  A cell that failed fails the run."""
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log = Path(path).with_name("dryrun.log").read_text()
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: the dry run failed:\n{log[-6000:]}")
    got = json.loads(Path(path).read_text())
    for rec in got["cells"]:
        if not rec.get("ok"):
            raise AssertionError(f"dryrun: a cell failed: {rec}")
        emit("dryrun_cell", **_cell_line(rec))
    predicted = {}
    for name, p in got["one_card"].items():
        m = measured[name]
        predicted[name] = {**p, **m,
                           "measured_over_predicted":
                               m["ms"] / p["predicted_ms"],
                           "device_ms_over_predicted":
                               m["device_ms"] / p["predicted_ms"]}
    return {"torch": got["torch"], "cells": len(got["cells"]),
            "cell_seconds": sum(r["seconds"] for r in got["cells"]),
            "one_card": predicted, **gemm_and_copy(torch, dev)}


def main() -> int:
    started = time.perf_counter()
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-times":
        print(json.dumps(ab_times(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-attention":
        return kernels_ab(Path(sys.argv[2]).resolve())
    train_remat = sys.argv[1:] == ["--train-remat"]
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if len(sys.argv) == 3 and sys.argv[1] == "--qos-large-cpu":
        return qos_large_cpu(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-cells":
        return dryrun_cells(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = smi_line()
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    emit("env", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_v.splitlines()[-1], python=sys.version.split()[0])
    if train_remat:  # train_model's step parts under every remat policy
        emit("train_remat", ms=train_remat_breakdown(torch, dev))
        return 0
    if sys.argv[1:] == ["--train-mesh-cards"]:  # four cards, NCCL
        t0 = time.perf_counter()
        out = train_mesh_cards(torch)
        emit("train_mesh_cards", seconds=time.perf_counter() - t0,
             nvidia_smi_all=subprocess.run(
                 ["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"], capture_output=True, text=True,
                 check=True).stdout.strip().splitlines(), **out)
        return 0
    if sys.argv[1:] == ["--serve-mesh-cards"]:  # four cards, NCCL
        t0 = time.perf_counter()
        out = serve_mesh_cards(torch)
        emit("serve_mesh_cards", seconds=time.perf_counter() - t0,
             nvidia_smi_all=subprocess.run(
                 ["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"], capture_output=True, text=True,
                 check=True).stdout.strip().splitlines(), **out)
        return 0
    if sys.argv[1:] == ["--train-mesh"]:  # the meshed trainer alone
        t0 = time.perf_counter()
        probe, branch, out = train_mesh(torch, dev)
        emit("collective_probe", **probe)
        emit("train_mesh", seconds=time.perf_counter() - t0, **out)
        return 0

    flash_only = sys.argv[1:] == ["--flash-sweep"]
    t0 = time.perf_counter()
    built = build.build(("flash_attention", "flash_attention_sm90")
                        if flash_only else build.SOURCES, force=True)
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: {"seconds": v["seconds"],
                         "ptxas": [ln for ln in v["ptxas"].splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "Function properties" in ln]}
                     for n, v in built.items()})
    emit("flash_sm90_ptxas", report=[
        ln.strip() for ln in built["flash_attention_sm90"]["ptxas"]
        .splitlines() if "ptxas" in ln or "spill" in ln
        or "registers" in ln or "Function properties" in ln])

    if flash_only:  # the bf16 flash kernels alone: sweep, 32k, the kinds
        for name, fn in (("flash_sweep", flash_sweep),
                         ("flash_kinds", bf16_kind_attention_rows)):
            t0 = time.perf_counter()
            out = fn(torch, dev)
            emit(name, seconds=time.perf_counter() - t0, **out)
        return 0

    if sys.argv[1:] == ["--serve-mesh"]:  # the meshed serve phase alone
        t0 = time.perf_counter()
        out, _ = serve_mesh(torch, dev)
        emit("serve_mesh", seconds=time.perf_counter() - t0, **out)
        return 0
    if sys.argv[1:] == ["--serve-bf16"]:  # the bf16 serve phase alone
        t0 = time.perf_counter()
        out, _ = serve_bf16(torch, dev)
        emit("serve_bf16", seconds=time.perf_counter() - t0, **out)
        return 0
    if sys.argv[1:] == ["--serve-bf16-kinds"]:  # the block kinds at bf16
        t0 = time.perf_counter()
        out, _ = serve_bf16_kinds(torch, dev)
        emit("serve_bf16_kinds", seconds=time.perf_counter() - t0, **out)
        return 0
    if sys.argv[1:] == ["--train-bf16"]:  # the bf16 train step alone
        t0 = time.perf_counter()
        out = train_bf16(torch, dev)
        emit("train_bf16", seconds=time.perf_counter() - t0, **out)
        return 0

    dry_proc, dry_path = start_dryrun()

    t0 = time.perf_counter()
    checks = kernel_check(torch, dev)
    emit("kernel_check", seconds=time.perf_counter() - t0, results=checks)

    t0 = time.perf_counter()
    res2 = two_streams(torch, dev)
    emit("two_streams", seconds=time.perf_counter() - t0, kernels=res2)

    t0 = time.perf_counter()
    resq = qos_large(torch, dev)
    emit("qos_large", seconds=time.perf_counter() - t0, **resq)

    t0 = time.perf_counter()
    small = serve_small(torch, dev)
    emit("serve_small", seconds=time.perf_counter() - t0, **small)

    t0 = time.perf_counter()
    small = serve_small_chunked(torch, dev)
    emit("serve_small_chunked", seconds=time.perf_counter() - t0, **small)

    t0 = time.perf_counter()
    small = serve_model_small(torch, dev)
    emit("serve_model_small", seconds=time.perf_counter() - t0, **small)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve(torch, dev)
    emit("serve", seconds=time.perf_counter() - t0, **res)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resc = serve_chunked(torch, dev)
    emit("serve_chunked", seconds=time.perf_counter() - t0, **resc)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resm = serve_model(torch, dev)
    emit("serve_model", seconds=time.perf_counter() - t0, **resm)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resp = prefill_model(torch, dev)
    emit("prefill_model", seconds=time.perf_counter() - t0, **resp)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resr = serve_dense_ring(torch, dev)
    emit("serve_dense_ring", seconds=time.perf_counter() - t0, **resr)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ress = serve_step(torch, dev)
    emit("serve_step", seconds=time.perf_counter() - t0, **ress)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ressc = serve_step_chunked(torch, dev)
    emit("serve_step_chunked", seconds=time.perf_counter() - t0, **ressc)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resmq = serve_model_qos(torch, dev)
    emit("serve_model_qos", seconds=time.perf_counter() - t0, **resmq)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resl, checks = serve_resilient(torch, dev)
    if not all(checks.values()):
        raise AssertionError(f"serve_resilient checks failed: {checks} "
                             f"{resl}")
    emit("serve_resilient", seconds=time.perf_counter() - t0, **resl,
         checks=checks, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resv, checks = recover_megastep(torch, dev)
    if not all(checks.values()):
        raise AssertionError(f"recover_megastep checks failed: {checks} "
                             f"{resv}")
    emit("recover_megastep", seconds=time.perf_counter() - t0, **resv,
         checks=checks, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    fabric = {}  # the serving fabric's launches of the port's kernels
    for name, phase in (("cluster_parity", cluster_parity),
                        ("serve_cluster", serve_cluster)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, checks = phase(torch, dev)
        if not all(checks.values()):
            raise AssertionError(f"{name} checks failed: {checks} {out}")
        emit(name, seconds=time.perf_counter() - t0, **out, checks=checks,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        fabric[name] = out["launches"]

    gc.collect()
    torch.cuda.empty_cache()
    block_kinds = block_kind_phases(torch, dev)

    from repro_torch.kernels import ops

    trained = {}  # each training phase's launches of the port's kernels
    for name, phase in (("train_model", train_model), ("train_moe", train_moe),
                        ("train_parity", train_parity)):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = phase(torch, dev)
        trained[name] = ops.launch_counts()
        emit(name, seconds=time.perf_counter() - t0, **out)
        if name == "train_model":
            train_out = out
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    probe, branch, mesh_out = train_mesh(torch, dev)
    emit("collective_probe", **probe)
    emit("train_mesh", seconds=time.perf_counter() - t0, **mesh_out)
    if branch != "c":  # the ranks' own counts: no kernel of the port
        trained["train_mesh"] = mesh_out["fsdp_tp"]["port_kernel_launches"]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resmesh, mesh_launches = serve_mesh(torch, dev)
    emit("serve_mesh", seconds=time.perf_counter() - t0, **resmesh)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resbf, bf16_launches = serve_bf16(torch, dev)
    emit("serve_bf16", seconds=time.perf_counter() - t0, **resbf)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reskinds, kinds_launches = serve_bf16_kinds(torch, dev)
    emit("serve_bf16_kinds", seconds=time.perf_counter() - t0, **reskinds)
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    restb = train_bf16(torch, dev, f32_ms=train_out["ms_per_step"])
    trained["train_bf16"] = ops.launch_counts()
    emit("train_bf16", seconds=time.perf_counter() - t0, **restb)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    whole = resmesh["decode_32k"]["whole"]
    resdry = dryrun(torch, dev, dry_proc, dry_path, {
        "decode_step": {"ms": whole["ms_median"],
                        "device_ms": whole["device_ms_a_step"]},
        "train_step": {"ms": train_out["ms_per_step"],
                       "device_ms": train_out["device_ms_per_step"]}})
    emit("dryrun", seconds=time.perf_counter() - t0, **resdry)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    prof = profile_megastep(torch, dev)
    emit("profile", seconds=time.perf_counter() - t0, **prof)

    t0 = time.perf_counter()
    prof = profile_chunked(torch, dev)
    emit("profile_chunked", seconds=time.perf_counter() - t0, **prof)

    t0 = time.perf_counter()
    by_path = {"serve": res["launches"],
               "serve_chunked": resc["launches"],
               "serve_model": resm["launches"],
               "prefill_model": resp["launches"],
               "serve_dense_ring": resr["launches"],
               "serve_step": ress["launches"],
               "serve_step_chunked": ressc["launches"],
               "serve_model_qos": resmq["launches"],
               "serve_resilient": resl["launches"],
               "recover_megastep": resv["launches"],
               "qos_large": resq["launches"],
               **fabric,
               **block_kinds, **trained,
               "serve_mesh": mesh_launches,
               "serve_bf16": bf16_launches,
               "serve_bf16_kinds": kinds_launches}
    rows = kernel_times(torch, dev, by_path, res["backlog_rows"][0])
    rows += bf16_rows(by_path, resbf, reskinds["kernels_at_kinds"],
                      routes={"serve_bf16": resbf["flash_routes"],
                              "serve_bf16_kinds": reskinds["flash_routes"]})
    at_kinds = block_kind_attention_rows(torch, dev)
    for row in rows:
        if row["name"] in at_kinds:
            row["at_block_kind_shapes"] = at_kinds[row["name"]]
        if row["name"] == "decode_attention":
            row["at_decode_32k"] = resmesh["decode_32k"]["attention_layer0"]
        if row["name"] == "flash_attention":
            row["at_prefill_32k"] = {
                k: resmesh["prefill_32k"][k] for k in
                ("ms_whole", "bound_ms", "max_abs_err", "head_runs",
                 "library_ms")}
        if row["name"] == "qos_round_fused":
            row["large_path"] = {**resq["times"], "launches": resq[
                "launches"]["qos_round_fused"]}
    emit("kernels", seconds=time.perf_counter() - t0, kernels=rows)
    emit("total", seconds=time.perf_counter() - started)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
