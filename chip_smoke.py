#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): the quickest
proof that the port builds, launches, serves and trains on an NVIDIA
Hopper card.

Run it from the root of a checkout, with no arguments, on a machine with one
CUDA device, ``nvcc`` and PyTorch built for CUDA::

    python3 chip_smoke.py

It imports ``repro_torch`` only (never JAX, never the JAX package) and needs
no network. Phases, each printing one JSON object on a line of its own:

1. ``env``      torch / CUDA / nvcc versions, card name and power limit.
2. ``build``    compiles ``src/repro_torch/csrc/*.cu`` (eight sources) for
                sm_90a (one ``nvcc`` per source, in parallel) and reports the
                seconds and each kernel's registers and spills (ptxas), and
                the constants the host plans share with the kernels
                (``plan_constants``). Nothing else is built: the earlier
                designs each kernel replaced are no longer timed here (their
                last times are in ``PERF.md``). While ``nvcc`` runs, the
                inputs are made (their line, ``inputs``, comes first).
3. ``check``    (after ``build_tuner()``, its seconds as ``tuner_seconds``)
                every hand-written kernel against its plain PyTorch version
                and a float64 host product on the card, over six schedules,
                at the shapes the served path gives it; a disagreement beyond
                the stated tolerance raises. Also times kernel, plain version
                and the library's CSR product of the same matrix
                (``torch.sparse_csr_tensor(A) @ x``). The CSR kernel B1
                (a warp per row, hub rows split across chunk CTAs) is held
                so at ``human_gene2`` and at
                ``webgraph@14011`` (hub rows), twice per schedule (bit for
                bit: no atomics), and at the served schedule reports its
                plan (rows per row CTA, the hub threshold and chunk, chunk
                and row CTAs, the hub rows and the carries of those that
                cross chunks), a sweep of launches (rows per CTA x
                unroll, then the hub threshold and the chunk; checked, twice,
                timed) and the bf16 error on webgraph's hub row and over all
                rows for 16 x vectors (``hub_row_bf16``: beyond 3e-2 at a
                bf16 schedule fails the run). The fused kernel B5 runs on the stream ``lower_fused``
                makes from a forced four-block plan of ``hetero``, twice per
                schedule (bit for bit: no atomics on y), with its plan
                (pieces, one CTA each; the largest row window; rows shared by
                several pieces) and the global stores a counting launch makes
                against the plan's count (``fused_launch``); the BCSR
                kernel on ``pkustk04`` at n = 8,000, the SpMSpV kernel B6 on
                the ``CscEll`` of ``webgraph`` at n = 14,011 for six
                frontiers (its largest column, 1 %, 10 % and 50 % of the
                columns, all of them, its 16 longest columns), twice each
                (float atomics: each within tolerance), each beside the
                library's CSR product and the
                CSR kernel on the same matrix and x, with its plan (lanes and
                slots per piece, further pieces, warps, CTAs), its read
                counts against the host twin, a sweep of launches (lanes per
                piece, piece size; checked twice, timed) and the zeroing of y alone (``memset_ms``). The ELL
                kernel B2 runs twice per schedule (bit for bit), reports the launch
                its plan chose (lanes per row, CTAs, the plane slots its
                padding stop reads) and runs at every other lane count
                (checked, twice, timed, read counts against the host twin).
                The SELL kernel B3 runs
                twice per schedule (bit for bit: no atomics), reports the
                launch its plan chose (threads per row P, slices per CTA,
                CTAs, the elements its padding stop reads against the
                nonzeros and the stored slots) and runs at every other P
                (the C entry point called directly; checked, twice, timed).
                The block kernels B4 (BELL)
                and B7 (BCSR) also run twice per schedule and must agree bit
                for bit (no atomics), run at every segment count S of their
                design (1, 2, 4, 8; the C entry point called directly)
                against the plain version (timed), and report their launch: S, the
                ring's stages and chunk bytes, dynamic shared memory per CTA,
                clusters resident at once, the blocks read, max / mean blocks
                per block row and the rate reached on the bytes the product
                needs (TB/s); beside B7 three yardsticks: its launch over
                empty block rows, a ``zero_`` of its output and
                ``torch.sum`` over the same stored blocks.
4. ``serve``    ``SpmvServer.run`` (tuner from ``build_tuner()``) on 8 requests with
                repeats over six full-width matrices (``human_gene2`` at its
                published 14,340 x 14,340 with ~9.0 M nonzeros, five more
                scaled to n ~ 14,000). Every ``y`` is held against a float64
                host product.
5. ``runtime_mode``  ``session.run_time_optimize`` for every pool matrix and
                the four objectives, then ``compile_spmv`` for ELL, SELL and
                BELL (BELL on the largest block matrix its storage guard
                admits, n = 8,000), each checked against the host product.
6. ``partitioned``  6 requests with repeats over ``human_gene2`` (14,340^2),
                ``rim``, ``amazon0601`` and ``hetero`` (n = 14,000: a dense
                band stacked on a power-law half) through
                ``SpmvServer(partition=True)``, then 6 through
                ``SpmvServer(partition=True, fused=True)``; per request the
                block count, formats, modeled gain, cache hit and span
                seconds. Then a forced four-block plan of ``hetero`` through
                both executors. Block-kernel launches must add up to the
                blocks served, fused launches to the fused requests plus the
                forced run. Then ``composites``: every served composite and
                the forced one through B5 as in phase 3 (plan, counted
                writes, bit for bit, against the plain version), timed
                beside the fused executor's
                call, the sequential executor, the library's CSR product and
                the bound over what B5 reads (``stream_bound_ms``: over the
                stream's own arrays), and at plans of other piece lengths
                (``by_piece``). Then ``block_case``: B4 and B7 on the largest
                BELL row block the served plans launch (or the forced plan's),
                at its plan's schedule, checked and timed as in phase 3, with
                the fill of the blocks read.
7. ``plugin``   registers BCSR (``repro_torch.sparse.bcsr``), runs run-time
                mode over the pool x 4 objectives, ``compile_spmv(.., "bcsr")``
                on ``pkustk04`` at n = 8,000 (and reports the storage guard's
                refusal at n ~ 14,000), and a forced plan with a BCSR block
                through both executors (the fused lowering's ``to_dense``
                route); unregisters BCSR at the end.
8. ``solve``    the iterative solvers on a fresh session: PageRank on
                ``webgraph`` (n = 14,011) with the uniform teleport, held
                against a float64 oracle of the same recurrence; personalised
                PageRank and power iteration (30 iterations from one seed
                vertex) under ``AdaptiveSpmvPolicy``, whose sparse frontiers
                run the SpMSpV kernel and flip one way to SpMV; CG on the SPD
                operator of ``rim`` (n ~ 14,000) to a relative residual of
                1e-6, checked in float64; and ``repro_torch.launch.solve``'s
                ``main`` in-process (power, ``--adaptive-spmspv``). SpMSpV
                launches must equal the solves' SpMSpV matvecs, CSR launches
                their SpMV matvecs. Then a host-clock breakdown of one
                iteration (copies, plan, kernel, numpy step, the SpMSpV
                wrapper at three frontiers).
9. ``lm``       ``qwen3-0.6b`` at its published width (28 layers, d 1,024,
                d_ff 3,072, vocabulary 151,936; fp32 params, bf16 compute),
                random weights from a seeded generator on the card, the
                serve CLI's tuner, every FFN matrix magnitude-pruned to 5 %
                into a ``SparseInferenceEngine`` and planned (84 plans).
                (a) One decode step of four tokens with the engine against
                the same step without it: scaled logits error <= 1e-4 and
                the same argmax in float32 compute (TF32 off), <= 3e-2 in
                bf16. The engine's planned CSR kernels (fp32 schedule) on
                that step's token vectors at ``w_up`` and ``w_down``
                against their plain version and a float64 host product,
                twice (bit for bit), timed at both, with the plan and the
                sweep of CTA shapes. (b) ``BatchedServer`` (4 slots,
                ``max_len`` 256, 16 new tokens) on 8 requests of 4-16
                prompt tokens: every tick must
                launch the CSR kernel 84 x 4 = 336 times and nothing else.
                (c) ``repro_torch.launch.serve.main`` in LM mode in-process
                (``--lm-sparse``, reduced config, as the CLI runs). Then a
                host-clock split of one tick (SpMVs, logits, the rest).
10. ``spmm``    the ELL SpMM kernel: ``rim`` (n = 13,999) at k = 1, 4, 16,
                64 and the LM's own pruned ``g0x0.mlp.w_up`` / ``w_down`` at
                k = 4 (the tick's four token vectors, also held against the
                engine's four per-token SpMVs) and k = 16, over the six
                schedules against the plain version and a float64 host
                product, twice (bit for bit), at k = 1 against the ELL SpMV
                kernel; at the default schedule the launch its plan chose
                (lanes per slot, columns per lane, warps per row, rows per
                warp, CTAs, plane slots read against live and stored) and
                the plan's alternatives (checked, twice, timed); times
                beside the byte bound, the library's CSR SpMM and k
                separate CSR SpMVs. Then ``ops.spmm`` once per case: its
                main path.
11. ``observed`` the telemetry and observability layer on phase 4's tuner
                and pool. (a) 16 requests with repeats over the pool
                (each matrix's SLO class fixed, the four classes mixed)
                through ``SpmvServer`` over a session with a
                ``TelemetryRecorder`` (JSONL log), an
                ``AdaptiveFormatSelector``, ``FeedbackLoop(refit_every=8)``,
                ``calibrate_every=8``, an ``SloTracker``, ``anomaly=True``
                and a ``FleetSync``, in batches of 8; every ``y`` against a
                float64 host product; each format's launches must equal the
                recorder's observations of it (host wall time per request:
                launch, kernel and the copy of ``y``, as the reference
                measures). (b) 8 requests over ``PART_POOL`` through
                ``SpmvServer(partition=True)`` with the bandit on, over
                phase 6's plan cache (its composites, not re-planned): per
                request the block formats, whether each explored, and each
                block's time; block-kernel launches must equal the blocks
                timed plus each new composite's warm-up. (c)
                ``calibrate()`` on both sessions: the fitted corrections per
                format; the ``part:*`` plans evicted; a fresh session over
                each cache path loads the file, on ``h100_sxm``. (d) A
                second recorder over (a)'s log replays every observation.
                (e) ``/metrics`` and ``/slo`` from ``start_metrics_server(0)``
                on 127.0.0.1. (f) ``repro_torch.launch.serve.main`` twice
                with every telemetry and observability flag (the second run
                warm-starts from the log), sharing (a)'s fleet directory,
                then LM mode with ``--slo-config``; a last fleet sync of (a)
                absorbs the CLI instance's shard.
12. ``zoo``     every family of the predictor zoo on the card. The port's
                dataset (``collect_dataset``: the suite's first 8 matrices
                and 40 random ones, labelled by the H100_SXM cost model);
                per family ``core.hpo.tune_model`` (TPE, 2 trials, 2-fold)
                and a held-out score on its task (classifiers: features ->
                the latency-best format, accuracy on 12 matrices;
                regressors: (features, config) -> log latency, fit on 200
                records and R^2 on 1,000 others), tune and fit seconds on the
                host clock; then an ``AutoSpmvPredictor`` per pair
                (classifier, regressor), Table 4 defaults, the MLPs trained
                on the card, served through an ``AutoSpmvSession`` in
                compile-time mode and in run-time mode (four objectives)
                over the pool: every ``y`` against the float64 host product,
                launches per format equal to the kernels served, and the
                picks' agreement with the ``decision_tree`` predictor's.
13. ``moe``     ``deepseek-moe-16b`` at its published width (d 2,048, 16
                heads, vocabulary 102,400, 64 routed experts of 1,408 with
                top-6 and 2 shared, a dense FFN of 10,944 in layer 0; bf16
                params, float32 router), the depth cut to 2 layers (layer 0
                attention + dense FFN, layer 1 MoE), random weights from a
                seeded generator on the card, the serve CLI's tuner, every
                FFN matrix and expert slice pruned to 5 % (3 + 195 matrices)
                and planned. The engine's decode step (every expert slice a
                planned B1 SpMV weighted by the gate) against the dense
                dispatch on the same pruned weights (<= 1e-4 and the same
                argmax in float32, <= 3e-2 in bf16) and the device's busy
                share of one such step (``torch.profiler``); B1 at the dense-FFN,
                expert and shared-expert shapes against its plain version
                and float64, twice (bit for bit), timed; one prefill of 4 x
                64 tokens through the ``dense``, ``ell`` and ``sell``
                dispatch and ``select_dispatch_format``'s pick on its
                routing histogram; ``BatchedServer`` with 2 and with 4 slots
                on 8 requests of 4-16 prompt tokens, 16 new tokens each,
                each tick timed (p50 over all ticks and over each half of
                them): B1 must be the only kernel and its launches must
                equal the engine's SpMVs (ticks x slots x 198); then the
                serve CLI's LM mode with ``--arch deepseek-moe-16b``
                in-process (reduced config, as the CLI runs).
14. ``recurrent`` the recurrent blocks at full width. (a)
                ``recurrentgemma-2b`` as published (d 2,560, 10 heads, MQA
                of head_dim 256, GeGLU d_ff 7,680, vocabulary 256,000,
                RG-LRU width 2,560, conv 4, window 2,048, tied embeddings;
                fp32 params, bf16 compute), depth cut 26 -> 8 ((rec, rec,
                local) x 2 + the (rec, rec) tail), seeded weights on the
                card, the serve CLI's tuner, its 24 FFN matrices pruned to
                5 % and planned; the engine's decode step against the dense
                one on the same pruned weights (<= 1e-4 and the same argmax
                in float32; in bf16 each FFN product <= 3e-2, and the
                logits <= 3e-2 where nudges of the FFN outputs as large as
                the engine's own distance from the dense products move them
                less than that) with the device's busy share of one
                step; B1 at ``w_up`` (7,680 x 2,560) and ``w_down``
                (2,560 x 7,680) against its plain version and float64,
                twice (bit for bit), timed beside its bound and the
                library; ``BatchedServer`` with 2 and with 4 slots on 8
                requests of 4-16 prompt tokens, 16 new tokens each, each
                tick timed: B1 launches must equal the engine's SpMVs
                (ticks x slots x 24). (b) ``xlstm-1.3b`` as published (d
                2,048, 4 heads, m 4,096, vocabulary 50,304, chunk 64),
                depth cut 48 -> 16 ((7 mLSTM + 1 sLSTM) x 2), served dense
                over 2 slots (4 requests x 16 new tokens; no kernel: its
                blocks have no FFN for the engine), with its state bytes
                per slot. (c) In float32 compute: prefill + one decode step
                against ``forward`` for both models, block by block and
                whole (allclose 5e-3; the whole model asserted where a 1e-6
                nudge of its embeddings moves its logits less than that),
                and
                one RG-LRU and one mLSTM block over 256 steps (the doubling
                scan; four chunks) against the block stepped through its
                decode path and against a float64 sequential recurrence
                (scaled 2e-3). Then the serve CLI's LM mode for both archs
                in-process (reduced; recurrentgemma with ``--lm-sparse``).
15. ``train``   training on the card (one JSON line per part, each with the
                card's name and power limit; no kernel: the training path
                is ``forward`` without an engine, as the reference's
                reaches no Pallas kernel, and the launch counters must read
                0 over the phase). (a) ``qwen3-0.6b`` as published (28
                layers, d 1,024, 16 heads / 8 KV heads x 128, d_ff 3,072,
                vocabulary 151,936, tied; fp32 params, bf16 compute, fp32
                moments, remat on) through the training CLI in-process:
                20 steps of 8 x 256 tokens with a checkpoint at the end
                (the loss must fall), then a second run to 24 steps that
                must resume at step 20; step time p50 over steps 2-19,
                tokens/s, ``mfu`` against the dense bf16 peak, the peak
                memory, the checkpoint's bytes and save / restore seconds,
                the device's busy share of one step (``torch.profiler``).
                (b) One float32 step at full width, B 2 x T 64, on the card
                and on the CPU from the same parameters: loss 1e-5
                relative, ``grad_norm`` 1e-4, every gradient leaf 1e-4
                scaled, AdamW from the same gradients 1e-4, updated
                parameters beyond 1e-4 only where the gradient is within
                1e-4 of 0 (AdamW's first step is about lr * sign(g)); remat
                on against off 1e-6. (c) (a)'s config with top-k
                compression at 0.1: ``compress_density`` >= 0.1 and the
                threshold at the embedding's gradient three ways (unsorted
                ``topk`` + min, sorted ``topk``, ``kthvalue``; one value),
                timed. (d) ``deepseek-moe-16b`` at its published width cut
                to 2 layers (bf16 params and moments): a calibration
                forward, ``select_dispatch_format`` on its routing
                histogram, five ``Trainer`` steps under the pick (the loss
                must fall, the moments stay bf16), one step under each
                other format. (e) ``recurrentgemma-2b`` at its published
                width cut to 8 layers: three steps of 4 x 256 tokens, loss
                and ``grad_norm`` finite, step time and peak memory.
16. ``dist``    multi-device (one JSON line per part, each with the card's
                name and power limit). (a) The sharded partitioned executor
                at full size on ``rim`` and ``hetero`` (n = 14,000):
                ``shard_partitioned`` of a 4-block partition, which must log
                its re-cut to ``torch.cuda.device_count()`` blocks, and of
                the composite plan a session's predictor makes; each runs
                its ELL carrier through B2 on every mesh device (``y``
                against a float64 host product: 1e-4 scaled at fp32, 3e-2
                at bf16; B2's counter must move by the mesh extent on every
                call; every ``sharded_call`` output on its device), then
                timed by CUDA events (L2 flushed) in turns with the
                sequential and fused executors of the same plan, for the
                record. (b) One ``make_train_step`` step of ``qwen3-0.6b``
                at full width inside ``sharding_context(make_host_mesh())``
                gives the same bits as outside it; ``launch.train
                --production-mesh`` must raise the mesh's error on one
                card. (c) ``CheckpointManager.restore(shardings=)`` places
                a saved tree on the card bit for bit. (d) The dry run
                (``repro_torch.launch.dryrun``) in three subprocesses at
                once, started before (a) so that they count on the host's
                cores while (a)-(c) use the card, each on a ``cuda`` mesh
                of a fake process group:
                ``qwen3-0.6b`` ``train_4k`` on 16 x 16 and 2 x 16 x 16 and
                ``deepseek-moe-16b`` ``decode_32k`` on 16 x 16; per cell its
                wall seconds, memory per device against 80 GB, the
                extrapolated FLOPs and bytes, collectives by kind and the
                roofline terms (counted from fake tensors and data-sheet
                constants, not timed). A cell that fails fails the run.
17. ``tuner``   the tuner learns the card. (a) B1's ``x_residency`` is the
                SM's L1 / shared-memory split: "vmem" (the least shared
                memory that keeps B1's CTAs per SM), "stream" (the most),
                forced to the least shared memory and to the driver's own
                choice, in turns at ``human_gene2`` and ``webgraph`` (CUDA
                events, L2 flushed; the same bits in all four), with the
                carveout each launch asked for. (b) The card's dataset
                (``collect_dataset(measure=True)`` over ``CardSpace``: one
                point per distinct launch): the whole card space, every
                format, on the pool's six matrices, the card's 112 CSR
                points on the paper's next presets cut to n ~ 14,000;
                every point timed through its kernel (CUDA events, L2
                flushed), the storage converted once per geometry (BELL
                admitted by its true storage), each point's ``y`` held
                against its kernel's plain version (beyond 1e-4 in fp32 or
                3e-2 in bf16 fails the run), then each matrix's candidates
                (within 5 % of their format's best) timed again in turns,
                A B B A; launches equal to the timed calls, B4's counted;
                the points, conversions, spread, re-timing, the §5.3
                overhead at the served size (feature pass, the default
                geometry's conversions) and wall seconds. The dataset is
                saved and loaded back. ``measure_formats`` on ``rim``
                launches each admitted format's kernel warmup + reps times
                (no plain version on the card). (c) The card cost model's
                constants fitted on the dataset (``fit_card_profile``) and
                their fit; per matrix the default schedule's time, the
                measured best (the re-timed label), a ``decision_tree``
                predictor's pick fitted leaving the matrix out, the
                reference-equal cost-model tuner's pick, the card cost
                model's pick with its constants fitted leaving the matrix
                out, and the picks of ``build_tuner()`` on the card (which
                learns its eight training matrices at the served size too);
                per-knob accuracy and the ratios, ``build_tuner()``'s over
                all 16 matrices, over its eight (in sample) and over the
                other eight (held out). (d)
                A tuner fitted on the dataset (``AutoSpmvPredictor.fit``,
                ``CardOverheadPredictor`` fitted on ``build_tuner()``'s
                samples at its scale and the served-size samples, the card
                model fitted on the dataset -> ``AutoSpMV`` ->
                ``AutoSpmvSession``) serves
                ``human_gene2`` and ``webgraph`` in compile-time mode: B1
                launches equal the requests, y against float64; B1 at its
                schedule against phase 1's, in turns. (e) Run-time mode over
                the pool with it: formats against the reference-equal
                tuner's, each §5.3 decision with its gain and overhead in
                seconds, and every pool conversion's (and feature pass's)
                predicted seconds against the measured, by
                ``CardOverheadPredictor`` and by the reference's
                ``OverheadPredictor``, each in sample and with the matrix
                left out. (f) B3 at fp32 and bf16 at the default on
                ``rim`` and at C 512, unroll 1 on ``human_gene2`` and
                ``amazon0601`` (a thread sums ~300 of a row's products):
                y against the plain version (bf16 within 3e-2), two launches
                bit for bit, timed.
18. ``examples`` the port's examples (``examples/torch_*.py``) through
                their ``main(argv)`` on the card, at their defaults
                (``torch_serve_lm`` with ``--sparse``, 2 requests, 1 slot,
                2 new tokens; ``torch_train_lm`` 20 steps, its checkpoints
                in a temporary directory): per example its seconds, its
                launches per kernel and every correctness figure it prints
                against its tolerance (a kernel's y 1e-4 / 3e-2 scaled,
                the sparse-served decode logits 1e-4 / 3e-2 of the largest
                logit); the SpMV and LM-serving examples must launch at
                least one of B1-B8, training none.

Byte bounds count what the product needs: for padded formats (ELL, SELL,
ELL SpMM) each nonzero's value and column plus one padding slot per padded
row to find its end, for BELL the nonzero blocks; the bound over every
stored slot stands beside it as ``padded_bound_ms``.

Launch counters are set to 0 just before phases 4-18 (each path of phases
11-18 on its own; phase 17's dataset timing is checked against its calls
and, as measurement, not added to the kernels line) and read just after
each:
a kernel of the path that was launched no time fails the run (phase 15's
path launches none, and any launch there fails it). Then come the
``kernels`` line (phase 3's numbers with the main path's launch counts; the
CSR kernel's entry also carries its numbers at the LM's FFN shapes, at an
expert slice of the MoE and at recurrentgemma's FFN shapes), the
``nvidia-smi`` name/power-limit line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase raises and the exit code
is not 0; without a CUDA device the script exits at once with code 2 and
prints no result.

Tolerances (scaled by max |reference|, as the package's tests do): 1e-4 for
float32 accumulation (summation order differs; the SpMSpV kernel adds with
float atomics, so its low bits also vary from run to run), 3e-2
for bfloat16 accumulation (every product and running sum is rounded to 8
significand bits; B1 and B3 keep each bf16 running sum within 128 of a
row's products and carry in float32; the plain version rounds products the
same way but sums in float32).

Every phase line carries ``parts``: the host seconds and calls of each of
this script's functions since the previous line (inclusive of the parts
each calls), so a phase's time can be split without a profiler.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import importlib.util
import inspect
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings
import weakref
from pathlib import Path
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA "
          "device", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.features import (  # noqa: E402
    extract_features,
    features_from_assignment_histogram,
)
from repro_torch.core.autotuner import AutoSpMV  # noqa: E402
from repro_torch.core.cache import CacheEntry  # noqa: E402
from repro_torch.core.dataset import (  # noqa: E402
    TuningDataset,
    collect_dataset,
    config_of,
    is_measured,
)
from repro_torch.core.hpo import tune_model  # noqa: E402
from repro_torch.core.objectives import (  # noqa: E402
    CARD_TERMS,
    CalibratedCostModel,
    CardCostModel,
    CostModel,
    ObjectiveValues,
    fit_card_profile,
    measure_formats,
)
from repro_torch.core.overhead import (  # noqa: E402
    CardOverheadPredictor,
    OverheadPredictor,
    measure_overheads,
    overhead_samples,
)
from repro_torch.core.predictor import AutoSpmvPredictor, PredictorConfig, _config_row  # noqa: E402
from repro_torch.core.session import (  # noqa: E402
    SERVED_ROWS,
    AutoSpmvSession,
    build_tuner,
    served_matrix,
)
from repro_torch.core.tuning_space import (  # noqa: E402
    ALL_KNOBS,
    CARD_KNOBS,
    KNOBS,
    CardSpace,
    TuningConfig,
    card_compile_time_space,
    space_size,
    tie_order,
)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.bcsr import bcsr_spmv, bcsr_spmv_plain  # noqa: E402
from repro_torch.kernels.bell import (  # noqa: E402
    bell_live_blocks,
    bell_spmv,
    bell_spmv_plain,
    block_launch_plan,
)
from repro_torch.kernels.common import (  # noqa: E402
    BLOCK_SEGMENT_CHOICES,
    DEFAULT_SCHEDULE,
    InfeasibleConfig,
    KernelSchedule,
    block_segments,
    ceil_to,
    sm_count,
)
from repro_torch.kernels.csr import (  # noqa: E402
    CSR_CARRY_PRODUCTS,
    CSR_MAX_HUBS,
    CSR_MAX_THREADS,
    CSR_ROUND,
    _csr_launch,
    csr_hub_pieces,
    csr_launch_plan,
    csr_spmv,
    csr_spmv_plain,
)
from repro_torch.kernels.ell import (  # noqa: E402
    ELL_WARPS_PER_CTA,
    SPMM_CHUNK,
    SPMM_WARPS_PER_CTA,
    _ell_launch,
    _spmm_launch,
    ell_launch_plan,
    ell_live_width,
    ell_plan_choices,
    ell_slots_read,
    ell_spmm,
    ell_spmm_plain,
    ell_spmv,
    ell_spmv_plain,
    spmm_launch_plan,
    spmm_plan_choices,
    spmm_slots_read,
)
from repro_torch.kernels.fused import (  # noqa: E402
    FUSED_ALIGN,
    FUSED_CTAS_PER_SM,
    FUSED_GROUP_INTS,
    FUSED_PAD_ROW,
    FUSED_PIECE_INTS,
    FUSED_STEPS,
    FUSED_THREADS,
    FUSED_WINDOW,
    _fused_launch,
    fused_launch_plan,
    fused_plan_summary,
    fused_spmv,
    fused_spmv_plain,
    lower_fused,
    plan_buffers,
)
from repro_torch.kernels.ops import (  # noqa: E402
    compile_spmv,
    matrix_fingerprint,
    prepare,
    spmm,
)
from repro_torch.kernels.sell import (  # noqa: E402
    SELL_CARRY_PRODUCTS,
    SELL_MAX_THREADS,
    _sell_launch,
    sell_launch_plan,
    sell_live_width,
    sell_plan_choices,
    sell_slots_read,
    sell_spmv,
    sell_spmv_plain,
)
from repro_torch.kernels.spmspv import (  # noqa: E402
    SPMSPV_CTA_WARPS,
    SPMSPV_SLOTS,
    _spmspv_launch,
    col_nnz,
    csc_from_dense,
    csc_spmspv,
    csc_spmspv_kernel,
    csc_spmspv_plain,
    served_plan,
    spmspv_grid,
    spmspv_launch_plan,
    spmspv_pieces,
    spmspv_slots_read,
)
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.ml import accuracy_score, r2_score, train_test_split  # noqa: E402
from repro_torch.ml.model_zoo import CLASSIFIER_ZOO, REGRESSOR_ZOO  # noqa: E402
from repro_torch.ml.model_zoo import build as build_estimator  # noqa: E402
from repro_torch.launch import solve as launch_solve  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    forward,
    init_cache,
    init_params,
    model_specs,
    param_count,
    prefill,
)
from repro_torch.models.layers import attention, mlp  # noqa: E402
from repro_torch.models.model import _embed, _logits, apply_block  # noqa: E402
from repro_torch.models.moe import _capacity as moe_capacity  # noqa: E402
from repro_torch.models.moe import select_dispatch_format  # noqa: E402
from repro_torch.models.param import torch_dtype, tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.obs.trace import tracing  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    apply_adamw,
    constant,
    cosine_schedule,
    init_opt_state,
)
from repro_torch.optim.compress import _kth_largest  # noqa: E402
from repro_torch.models.recurrent import (  # noqa: E402
    _mlstm_core,
    _rglru_in,
    linear_scan,
    mlstm_block,
    mlstm_cache_spec,
    mlstm_specs,
    rglru,
    rglru_cache_spec,
    rglru_specs,
)
from repro_torch.models.sparse_linear import SparseInferenceEngine, prune_model_ffns  # noqa: E402
from repro_torch.obs import FleetSync, SloTracker  # noqa: E402
from repro_torch.obs.slo import SLO_CLASSES  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    BlockPlan,
    CompositePlan,
    PartitionedSpmv,
    compile_fused_partitioned,
    compile_partitioned,
    partition_rows,
    shard_partitioned,
)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.dist import sharding_context  # noqa: E402
from repro_torch.dist.sharding import NamedSharding, PartitionSpec  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.solvers import AdaptiveSpmvPolicy, cg, pagerank, power_iteration  # noqa: E402
from repro_torch.sparse.generate import (  # noqa: E402
    MATRIX_NAMES,
    SUITE,
    generate_by_name,
    random_matrix,
)
from repro_torch.sparse.registry import format_names, unregister_format  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    AdaptiveFormatSelector,
    FeedbackConfig,
    FeedbackLoop,
    TelemetryRecorder,
)
from repro_torch.train.serve import (  # noqa: E402
    BatchedServer,
    Request,
    ServeConfig,
    SpmvRequest,
    SpmvServer,
)
from repro_torch.train import TrainConfig, Trainer, make_loss_fn, make_train_step  # noqa: E402
from repro_torch.train.trainer import init_train_state  # noqa: E402
from repro_torch.utils.timing import cuda_time_ms  # noqa: E402

DEVICE = torch.device("cuda", 0)
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
# BELL's checks and B4's numbers in the kernel table run at n = 8,000, the
# size at which the reference's storage guard (its occupancy bound) admits
# BELL at the default block height; the port's guard charges the true
# storage and admits pkustk04 at n ~ 14,000 up to br = 32 (phase 17)
BELL_MATRIX, BELL_N = "pkustk04@8000", 8_000
N_REQUESTS = 8
OBJECTIVES = ("latency", "energy", "power", "efficiency")
POOL = ("human_gene2", "rim", "bcsstk32", "viscorocks", "pkustk04", "amazon0601")

# the six schedules of the package's kernel tests
SCHEDULES = [
    DEFAULT_SCHEDULE,
    KernelSchedule(rows_per_block=8, nnz_tile=128, unroll=1),
    KernelSchedule(rows_per_block=32, nnz_tile=256, unroll=2),
    KernelSchedule(rows_per_block=128, nnz_tile=512, unroll=4),
    KernelSchedule(rows_per_block=16, nnz_tile=128, unroll=1, accum_dtype="bfloat16"),
    KernelSchedule(rows_per_block=64, nnz_tile=128, dimension_semantics="parallel"),
]

WRAPPERS = {"csr": csr_spmv, "ell": ell_spmv, "sell": sell_spmv, "bell": bell_spmv,
            "fused": fused_spmv, "bcsr": bcsr_spmv, "spmspv": csc_spmspv, "spmm": ell_spmm}
BLOCK_FORMATS = ("csr", "ell", "sell", "bell", "bcsr")  # one wrapper each
KERNEL_ORDER = ("csr", "ell", "sell", "bell", "fused", "bcsr", "spmspv", "spmm")
# the CUDA source (csrc/<name>.cu) of each kernel
SOURCE = {**{k: f"spmv_{k}" for k in KERNEL_ORDER}, "spmspv": "spmspv_csc",
          "spmm": "spmm_ell"}
KERNEL_NAME = {**{k: f"{k}_spmv" for k in KERNEL_ORDER}, "spmspv": "csc_spmspv",
               "spmm": "ell_spmm"}
REPLACES = {
    "csr": "src/repro/kernels/csr.py:48",
    "ell": "src/repro/kernels/ell.py:45",
    "sell": "src/repro/kernels/sell.py:54",
    "bell": "src/repro/kernels/bell.py:40",
    "fused": "src/repro/kernels/fused.py:154",
    "bcsr": "src/repro/sparse/bcsr.py:208",
    "spmspv": "src/repro/kernels/spmspv.py:145",
    "spmm": "src/repro/kernels/ell.py:98",
}
# matrix each kernel is checked and timed on: one the served path gives it
CHECK_MATRIX = {"csr": "human_gene2", "ell": "rim", "sell": "rim", "bell": BELL_MATRIX,
                "fused": "hetero", "bcsr": BELL_MATRIX}

# partitioned phase: three pool matrices and the heterogeneous one
PART_POOL = ("human_gene2", "rim", "amazon0601", "hetero")
N_PART_REQUESTS = 6  # per executor
MAX_BLOCKS = 8
# The forced heterogeneous plan: hetero at k = 4 with the reference test's
# four formats round-robin, rotated so BELL lands on a dense-band block. The
# nnz balance puts the whole power-law half (~8,500 rows) into the last
# block, and BELL's storage guard (~8 bytes per element of rows x columns)
# refuses any block above ~4,800 rows at 14,000 columns.
FORCED_FORMATS = ("ell", "sell", "bell", "csr")
# The card cost model plans one block on every matrix of PART_POOL (each
# launch pays its floor), so the served partitioned paths would run neither
# B3 nor B4: hetero's plan is pinned in the partitioned session's cache,
# the forced plan above, and served through the cache's replay as a warm
# plan cache is (phase 6, both executors, and observed (b))
PINNED_MATRIX = "hetero"
PLUGIN_FORMATS = ("bcsr", "ell", "bell", "csr")  # a BCSR block: the to_dense route

# solve phase: webgraph at the scale that gives n = 14,011 (its CscEll pads
# every column to the hub column's 3,322 nonzeros: W = 3,328 at nnz_tile 128)
WEB_SCALE = 0.016
SOLVE_TOL = {"pagerank": 1e-7, "cg": 1e-6}
POWER_ITERS = 30
CLI_SCALE = WEB_SCALE  # launch.solve builds its own tuner at this scale
_ZERO = ObjectiveValues(0.0, 0.0, 0.0, 0.0)

# B1: the launches its sweep runs at each matrix beside the plan (rows per
# row CTA, whose warps are min(rows, 8), x accumulators per lane; then the
# hub threshold and the chunk at the plan's rows and unroll)
B1_ROWS = (2, 4, 8, 16, 64)
B1_UNROLLS = (1, 2, 4, 8)
B1_HUB_ROWS = (256, 4096)
B1_CHUNKS = (4096, 65536)
# B6: the launches its sweep runs beside the plan's, (lanes per piece, piece
# slots): one trip at every lane count, then pieces of two and four trips
B6_LAUNCHES = ((4, 32), (8, 64), (16, 128), (32, 256), (32, 512), (32, 1024))

# B5: the piece lengths its sweep runs at each composite beside the plan's
B5_PIECES = (512, 2048, 8192)

# lm phase: qwen3-0.6b as published (28 layers, d 1,024, d_ff 3,072, vocab
# 151,936; fp32 params, bf16 compute), FFNs pruned to 5 % and served sparse
LM_ARCH = "qwen3-0.6b"
LM_DENSITY = 0.05
LM_SLOTS, LM_MAX_LEN, LM_NEW_TOKENS, LM_REQUESTS = 4, 256, 16, 8
# spmm phase: B8 on rim at these numbers of right-hand sides, and on two of
# the LM's own pruned FFN matrices at the decode tick's k = 4 and at k = 16
SPMM_KS = (1, 4, 16, 64)
FFN_KS = (4, 16)
FFN_CHECK = ("g0x0.mlp.w_up", "g0x0.mlp.w_down")
# zoo phase: each classifier family beside one regressor family (six pairs:
# every family of both zoos once), the dataset they learn from (the suite's
# first 8 matrices and 40 random ones, labelled by the H100 cost model), the
# TPE trials and folds per family, the records each predictor's regressor fits on and
# the regression task's (fit, held-out) records
ZOO_PAIRS = (("nearest_centroid", "bayesian_ridge"), ("decision_tree", "lasso"),
             ("svm", "lars"), ("gradient_boosting", "decision_tree"),
             ("random_forest", "random_forest"), ("mlp", "mlp"))
ZOO_DATA = {"scale": 0.0015, "names": MATRIX_NAMES[:8], "n_extra": 40}
ZOO_TRIALS, ZOO_FOLDS, ZOO_REG_SAMPLES, ZOO_REG_SPLIT = 2, 2, 300, (200, 1000)
# moe phase: deepseek-moe-16b as published (d 2,048, 16 heads, vocabulary
# 102,400, 64 routed experts of 1,408 with top-6 and 2 shared, a dense FFN of
# 10,944 in layer 0; bf16 params, float32 router) with the depth cut to 2
# layers; every FFN matrix and expert slice pruned to 5 % (3 + 195 matrices)
MOE_ARCH, MOE_LAYERS, MOE_DENSITY = "deepseek-moe-16b", 2, 0.05
MOE_SLOTS, MOE_REQUESTS, MOE_NEW_TOKENS, MOE_MAX_LEN = (2, 4), 8, 16, 64
MOE_CHECK_SLOTS = 4
MOE_DISPATCH_BATCH = (4, 64)  # (prompts, tokens) of the dispatch-format prefill
MOE_B1_CHECK = ("head0.mlp.w_up", "head0.mlp.w_down", "g0x0.moe.w_up.0", "g0x0.moe.w_down.0",
                "g0x0.moe.shared.w_up")
# recurrent phase: recurrentgemma-2b as published (d 2,560, 10 heads, MQA
# of head_dim 256, GeGLU d_ff 7,680, vocabulary 256,000, RG-LRU width 2,560,
# conv 4, window 2,048, tied embeddings; fp32 params, bf16 compute) with the
# depth cut 26 -> 8: (rec, rec, local) x 2 + the (rec, rec) tail; its 24
# FFN matrices pruned to 5 % and served through B1. xlstm-1.3b as published
# (d 2,048, 4 heads, m 4,096, head_dim 1,024, vocabulary 50,304, chunk 64)
# with the depth cut 48 -> 16: (7 mLSTM + 1 sLSTM) x 2, served dense (its
# blocks have no FFN for the engine, as in the reference)
RG_ARCH, RG_LAYERS, RG_DENSITY = "recurrentgemma-2b", 8, 0.05
RG_SLOTS, RG_REQUESTS, RG_NEW_TOKENS, RG_MAX_LEN = (2, 4), 8, 16, 64
RG_CHECK_SLOTS = 4
RG_PROBES = 4  # draws of the sensitivity probe that decides whether bf16 logits are held
RG_B1_CHECK = ("g0x0.mlp.w_up", "g0x0.mlp.w_down")
XL_ARCH, XL_LAYERS = "xlstm-1.3b", 16
XL_SLOTS, XL_REQUESTS, XL_NEW_TOKENS, XL_MAX_LEN = 2, 4, 16, 64
SCAN_T = 256  # RG-LRU's doubling scan and four mLSTM chunks against a recurrence
TEACHER_TOL, SCAN_TOL = 5e-3, 2e-3  # the reference tests' bounds (test_models.py)
# train phase: qwen3-0.6b as published (28 layers, d 1,024, 16 heads / 8 KV
# heads x 128, d_ff 3,072, vocabulary 151,936, tied; fp32 params, bf16
# compute, fp32 moments, remat on) trained through the CLI at full depth;
# deepseek-moe-16b cut to MOE_LAYERS and recurrentgemma-2b to RG_LAYERS at
# their published widths
TRAIN_ARCH, TRAIN_STEPS, TRAIN_RESUME_STEPS = "qwen3-0.6b", 20, 24
TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_LR = 256, 8, 5, 1e-3  # 2,048 tokens a step
TRAIN_PARITY_BATCH = (2, 64)  # (B, T) of the card-against-CPU float32 step
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4, "remat": 1e-6}
# phase 16 (dist): sharded executor calls per matrix and executor; the dry
# run's cells (arch, shape, mesh), run at once in subprocesses
DIST_POOL = ("rim", "hetero")
DIST_CALLS = 8
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "pod1"), ("qwen3-0.6b", "train_4k", "pod2"),
                ("deepseek-moe-16b", "decode_32k", "pod1"))
DRYRUN_TIMEOUT_S = 600
COMPRESS_FRAC, COMPRESS_STEPS = 0.1, 3
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_LR = 5, (4, 256), 3e-3
RG_TRAIN_STEPS, RG_TRAIN_BATCH = 3, (4, 256)
H100_BF16_FLOPS = 989e12  # dense bf16 peak, H100 SXM data sheet (at 700 W)
# phase 17 (tuner): the card's dataset. The whole card space (every format)
# on the pool, the card's CSR space on the presets below (the paper's
# first presets beside the pool, cut to SERVED_ROWS rows); CUDA-event
# repetitions per point; requests per matrix served with the card-fitted
# tuner; regressor records of each leave-one-out predictor
TUNER_CSR_PRESETS = tuple(n for n in MATRIX_NAMES if n not in POOL)[:10]
TUNER_REPS, TUNER_SERVE, TUNER_LOO_SAMPLES = 6, 4, 150
# build_tuner()'s arguments; its names are in sample at the served size,
# phase 17's other matrices held out
TUNER_SCALE, TUNER_NAMES = 0.0015, MATRIX_NAMES[:8]
TUNER_CARVE_ROUNDS = 2  # in-turns rounds of B1's carveout arms
# 17(f): B3 at the default on rim, and where one thread of a row sums ~300
# products (C = 512, unroll 1: P <= 2)
TUNER_B3_CASES = (("rim", DEFAULT_SCHEDULE),
                  ("human_gene2", KernelSchedule(rows_per_block=512, unroll=1)),
                  ("amazon0601", KernelSchedule(rows_per_block=512, unroll=1)))
# phase 18 (examples): the port's examples in-process on the card, at their
# defaults; the serving and training runs cut as the examples' tests cut
# them (a checkpoint directory under a temporary directory is added)
EXAMPLE_ARGS = {
    "torch_quickstart": [],
    "torch_autotune_formats": [],
    "torch_serve_lm": ["--sparse", "--requests", "2", "--slots", "1", "--max-new-tokens", "2"],
    "torch_train_lm": ["--steps", "20"],
}
# observed phase: run-time requests with repeats over the pool, served in
# batches (calibration, the watchdog, SLO evaluation and fleet sync run once
# per batch), and partitioned requests over PART_POOL with the bandit on
N_OBSERVED, OBSERVED_BATCH, N_OBSERVED_PART = 16, 8, 8


# Per-part host seconds: every function of this script is timed (inclusive
# of the parts it calls) and its seconds and calls since the last phase line
# are printed on the next one as ``parts``: {name: [seconds, calls]}.
PARTS: dict[str, list] = {}
PART_FLOOR_S = 0.01  # parts below this many seconds are left off the line


def timed_part(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            entry = PARTS.setdefault(fn.__name__, [0.0, 0])
            entry[0] += time.perf_counter() - t0
            entry[1] += 1
    return wrapper


def take_parts() -> dict:
    parts = {k: [round(v[0], 3), v[1]] for k, v in
             sorted(PARTS.items(), key=lambda kv: -kv[1][0]) if v[0] >= PART_FLOOR_S}
    PARTS.clear()
    return parts


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload, "parts": take_parts()}, default=float),
          flush=True)


def tol_of(schedule: KernelSchedule) -> float:
    return 3e-2 if schedule.accum_dtype == "bfloat16" else 1e-4


def scaled_err(y: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))


def sched_tag(s: KernelSchedule) -> str:
    return (f"rpb{s.rows_per_block}_nt{s.nnz_tile}_u{s.unroll}_"
            f"{'bf16' if s.accum_dtype == 'bfloat16' else 'f32'}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# ------------------------------------------------------------------ inputs
def make_pool() -> dict[str, np.ndarray]:
    """The pool at the served size; ``human_gene2`` (14,340 rows) at its
    published size."""
    pool = {}
    for name in POOL:
        if name == "human_gene2":
            pool[name] = generate_by_name(name, scale=1.0, max_elems=SUITE[name].n ** 2)
        else:
            pool[name] = served_matrix(name)
    return pool


def make_bell_matrix() -> np.ndarray:
    return generate_by_name("pkustk04", scale=BELL_N / SUITE["pkustk04"].n)


def make_hetero() -> np.ndarray:
    """n = 14,000: the top half of a 64-wide dense band stacked on the bottom
    half of a power-law matrix (the shape of the reference tests'
    ``hetero_matrix``, with a band narrow enough to hold dense on the host)."""
    top = random_matrix(SERVED_ROWS, 64, "denseband", seed=1)[: SERVED_ROWS // 2]
    bot = random_matrix(SERVED_ROWS, 3.0, "powerlaw", seed=2)[SERVED_ROWS // 2 :]
    return np.vstack([top, bot]).astype(np.float32)


def forced_plan(dense: np.ndarray, fmts, k: int, schedule: KernelSchedule) -> CompositePlan:
    """A CompositePlan with formats assigned round-robin over ``k`` blocks,
    as the reference's fused tests force it: exercises lowering, not planning."""
    part = partition_rows(dense, k)
    blocks = tuple(
        BlockPlan(b, fmts[i % len(fmts)], schedule, _ZERO, fmts[i % len(fmts)])
        for i, b in enumerate(part.blocks)
    )
    return CompositePlan("latency", part, blocks, _ZERO, _ZERO, fmts[0], schedule)


# matrix -> its CSR on the card (no schedule field shapes CSR storage), made
# once per matrix object and dropped with it
CSR_ON_CARD: dict[int, object] = {}


def prepared(fmt: str, dense: np.ndarray, schedule: KernelSchedule):
    """The storage a kernel is checked on, as the served path prepares it."""
    if fmt == "csr":
        mat = CSR_ON_CARD.get(id(dense))
        if mat is None:
            mat = CSR_ON_CARD[id(dense)] = prepare(dense, fmt, schedule, device=DEVICE)
            weakref.finalize(dense, CSR_ON_CARD.pop, id(dense), None)
        return mat
    if fmt == "fused":
        plan = forced_plan(dense, FORCED_FORMATS, 4, schedule)
        return lower_fused(dense, plan, device=DEVICE)
    if fmt == "bcsr":
        from repro_torch.sparse.bcsr import BCSR_SPEC

        return BCSR_SPEC.prepare(dense, schedule, device=DEVICE)
    return prepare(dense, fmt, schedule, device=DEVICE)


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict[str, int]:
    return {k: w.launches for k, w in WRAPPERS.items()}


# matrix -> its float64 CSR, made once per matrix object (a float64 copy of
# human_gene2's dense array is 1.6 GB for every product) and dropped with it
HOST64: dict[int, object] = {}


def host_product(dense: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The float64 host product ``dense @ x``."""
    a64 = HOST64.get(id(dense))
    if a64 is None:
        import scipy.sparse

        a64 = HOST64[id(dense)] = scipy.sparse.csr_matrix(dense, dtype=np.float64)
        weakref.finalize(dense, HOST64.pop, id(dense), None)
    return a64 @ x.astype(np.float64)


# ------------------------------------------------- per-kernel call closures
def padded_needs(fmt: str, mat) -> tuple[int, int, int]:
    """(bytes of a padded container the product needs, bytes it stores,
    real entries). The product needs each nonzero's value and column (ELL,
    SELL) or each nonzero block's values and block column (BELL); to find
    where a padded row ends, one padding slot of each row that has padding
    (ELL, SELL). The rest of the padding, and the rows added to align the
    planes, are not needed: a kernel can stop at a row's tail."""
    n_rows = mat.shape[0]
    cols = mat.block_cols if fmt == "bell" else mat.cols
    stored = (mat.data.numel() + cols.numel()) * 4
    if fmt == "bell":
        nb = int((mat.data != 0).flatten(2).any(-1).sum())
        return nb * (mat.br * mat.bc * 4 + 4), stored, nb
    if fmt == "ell":
        counts, width = (mat.data[:n_rows] != 0).sum(dim=1), mat.data.shape[1]
    else:  # sell: slices of C consecutive rows, each padded to its slice's width
        real = mat.data != 0
        counts = torch.bincount(mat.row_ids[real].long(), minlength=n_rows + 1)[:n_rows]
        width = mat.slice_width.long().repeat_interleave(mat.C)[:n_rows]
    nnz, tails = int(counts.sum()), int((counts < width).sum())
    return 8 * (nnz + tails), stored, nnz


def kernel_calls(fmt: str, mat, x: torch.Tensor, schedule: KernelSchedule):
    """(kernel call, plain call, inputs the product needs (tensors or byte
    counts), output elements, flops, bytes of the padded planes or None) for
    one prepared matrix, at exactly the arguments the registry's spmv hands
    the wrapper."""
    if fmt == "csr":
        args = (mat.data, mat.indices, mat.indptr, x, schedule)
        ins, fl = (mat.data, mat.indices, mat.indptr, x), 2 * mat.data.shape[0]
        out_elems = mat.shape[0]
        return (lambda: csr_spmv(*args)), (lambda: csr_spmv_plain(*args)), ins, out_elems, fl, None
    if fmt == "ell":
        args = (mat.data, mat.cols, x, schedule)
        need, stored, nnz = padded_needs(fmt, mat)
        return ((lambda: ell_spmv(*args)), (lambda: ell_spmv_plain(*args)), (need, x),
                mat.shape[0], 2 * nnz, stored)
    if fmt == "sell":
        args = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x, mat.C, schedule)
        need, stored, nnz = padded_needs(fmt, mat)
        ins = (need, mat.slice_ptr, mat.slice_width, x)
        return ((lambda: sell_spmv(*args)), (lambda: sell_spmv_plain(*args)), ins,
                mat.shape[0], 2 * nnz, stored)
    if fmt == "bell":
        n_cols = mat.shape[1]
        xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
        xp[:n_cols] = x
        panels = xp.reshape(-1, mat.bc)
        args = (mat.data, mat.block_cols, panels, schedule)
        need, stored, nb = padded_needs(fmt, mat)
        return ((lambda: bell_spmv(*args)), (lambda: bell_spmv_plain(*args)), (need, panels),
                mat.shape[0], 2 * nb * mat.br * mat.bc, stored)
    if fmt == "bcsr":
        n_cols = mat.shape[1]
        xp = torch.zeros(ceil_to(n_cols, mat.bc), dtype=x.dtype, device=x.device)
        xp[:n_cols] = x
        panels = xp.reshape(-1, mat.bc)
        args = (mat.data, mat.block_cols, mat.block_rows, mat.block_ptr, panels, schedule)
        nb = mat.n_blocks  # the kernel reads the real blocks only
        ins = (mat.data[:nb], mat.block_cols[:nb], mat.block_ptr, panels)
        fl = 2 * nb * mat.br * mat.bc
        return ((lambda: bcsr_spmv(*args)), (lambda: bcsr_spmv_plain(*args)), ins,
                mat.shape[0], fl, None)
    if fmt == "fused":
        args = (mat.data, mat.cols, mat.rows, mat.tile_map, x, mat.n_rows, mat.tile)
        kw = dict(unroll=mat.unroll, accum_dtype=mat.accum_dtype)
        fl = 2 * int((mat.rows < mat.n_rows).sum())  # real entries, not padding
        return ((lambda: fused_spmv(*args, **kw, plan=mat.launch_plan)),
                (lambda: fused_spmv_plain(*args, **kw)), b5_inputs(mat, x), mat.n_rows + 1, fl,
                None)
    raise ValueError(fmt)


def bound(ins, out_elems: int, flops: int) -> tuple[float, str, int]:
    """Least time the card could take: each input (a tensor or a byte
    count) read once, the output written once, against the HBM rate; the
    operations against the fp32 rate. Returns (ms, which bound, bytes)."""
    nbytes = sum(t if isinstance(t, int) else t.numel() * t.element_size() for t in ins)
    nbytes += 4 * out_elems
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


# what the timer saw over the run: timings, repetitions, late ones (the host
# enqueue outlasted the flush; left out), timings whose every repetition was
# late (kept), where the late ones were timed ("function:line": [late,
# reps]), and each timing's median flush ms
TIMER = {"timings": 0, "reps": 0, "late": 0, "all_late": 0, "late_at": {}, "flush_ms": []}


def timing(fn, reps: int = 20) -> dict:
    """``cuda_time_ms`` of ``fn`` (CUDA events, the L2 flushed before every
    repetition, as a served request finds it), its flush and late
    repetitions added to ``TIMER``."""
    t = cuda_time_ms(fn, warmup=3, reps=reps)
    late = int(t["late"])
    TIMER["timings"] += 1
    TIMER["reps"] += reps
    TIMER["late"] += late
    TIMER["all_late"] += late == reps
    TIMER["flush_ms"].append(t["flush_ms"])
    if late:
        f = sys._getframe(1)
        if f.f_code.co_name == "timed":
            f = f.f_back
        at = TIMER["late_at"].setdefault(f"{f.f_code.co_name}:{f.f_lineno}", [0, 0])
        at[0] += late
        at[1] += reps
    return t


def timed(fn, reps: int = 20) -> float:
    """Median ms of ``timing``."""
    return timing(fn, reps)["median_ms"]


def timer_summary() -> dict:
    f = sorted(TIMER["flush_ms"])
    return {**{k: v for k, v in TIMER.items() if k != "flush_ms"},
            "flush_ms": [f[0], f[len(f) // 2], f[-1]] if f else None}


def host_us(fn, calls: int = 50) -> float:
    """Mean host microseconds to enqueue one call of ``fn`` (no synchronise
    between calls): the wrapper's own cost, which ``timed`` hides behind its
    L2 flush."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_kernel(fmt: str, name: str, dense: np.ndarray, time_schedule: KernelSchedule) -> dict:
    """Hold one kernel against its plain version over the six schedules and
    time it at ``time_schedule`` (the one the served path uses for it)."""
    rng = np.random.default_rng(SEED + 7)
    x_host = rng.normal(size=dense.shape[1]).astype(np.float32)
    x = torch.as_tensor(x_host, device=DEVICE)
    ref64 = host_product(dense, x_host)
    n_rows = dense.shape[0]
    worst, per_schedule = 0.0, {}
    schedules = list(SCHEDULES)
    if time_schedule not in schedules:
        schedules.append(time_schedule)
    entry, launch = None, {}
    for sched in schedules:
        mat = prepared(fmt, dense, sched)
        kern, plain, ins, out_elems, flops, stored = kernel_calls(fmt, mat, x, sched)
        y_k = kern()
        torch.cuda.synchronize()  # a fault during the run surfaces here
        y_p = plain()
        if fmt in TWICE:  # no atomics: a second launch gives the same bits
            if not torch.equal(y_k, kern()):
                raise AssertionError(f"{fmt} kernel: two launches differ at {sched}")
        yk = y_k.reshape(-1)[:n_rows].cpu().numpy()
        yp = y_p.reshape(-1)[:n_rows].cpu().numpy()
        err = scaled_err(yk, yp)
        err_host = scaled_err(yk, ref64)
        tol = 3e-2 if getattr(mat, "accum_dtype", sched.accum_dtype) == "bfloat16" else tol_of(sched)
        if not (np.isfinite(yk).all() and err <= tol and err_host <= tol):
            raise AssertionError(
                f"{fmt} kernel disagrees on {name} at {sched}: vs plain {err:.3e}, "
                f"vs host float64 {err_host:.3e}, tolerance {tol:.0e}"
            )
        worst = max(worst, err)
        ms = timed(kern)
        per_schedule[sched_tag(sched)] = {"ms": ms, "err_vs_plain": err, "err_vs_host": err_host}
        if fmt in BLOCK_KERNELS:
            per_schedule[sched_tag(sched)].update(
                bit_identical=True, **block_design(fmt, mat, sched),
                by_segments=segment_sweep(fmt, mat, ins[-1], sched, y_p, tol))
        if fmt == "sell":
            per_schedule[sched_tag(sched)]["bit_identical"] = True
            launch[sched_tag(sched)] = {**sell_design(mat),
                                        "by_plan": sell_sweep(mat, x, sched, y_p, tol)}
        if fmt == "ell":
            per_schedule[sched_tag(sched)]["bit_identical"] = True
            launch[sched_tag(sched)] = {**ell_design(mat, sched),
                                        "by_plan": ell_sweep(mat, x, sched, y_p, y_k, tol)}
        if fmt == "csr":
            per_schedule[sched_tag(sched)]["bit_identical"] = True
            launch[sched_tag(sched)] = b1_design(mat, sched)
        if fmt == "fused":
            launch[sched_tag(sched)] = b5_design(mat, x, y_k, y_p, tol)
        if sched == time_schedule:
            bound_ms, bound_by, nbytes = bound(ins, out_elems, flops)
            entry = {
                "matrix": name,
                "shape": list(dense.shape),
                "nnz": int((dense != 0).sum()),
                "schedule": sched_tag(sched),
                "ms": ms,
                "plain_ms": timed(plain, reps=5),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bytes": nbytes,
                "library_ms": None,
            }
            if stored is not None:  # beside it, the bound over every padded slot
                entry["padded_bytes"] = nbytes - ins[0] + stored  # ins[0]: the needed planes
                entry["padded_bound_ms"] = 1e3 * entry["padded_bytes"] / HBM_BYTES_PER_S
            library_call(fmt, dense, mat, x, ref64, entry)
            if fmt in BLOCK_KERNELS:
                entry.update(block_design(fmt, mat, sched, ms=ms, nbytes=nbytes))
            if fmt == "bcsr":
                entry["yardsticks"] = block_yardsticks(mat, entry["segments"])
            if fmt == "csr":
                launch["by_shape"] = b1_sweep(mat, x, sched, y_p, tol)
            if fmt == "fused":
                entry["stream_bound_ms"] = bound(
                    (mat.data, mat.cols, mat.rows, mat.tile_map, x), out_elems, flops)[0]
        del mat
    entry["max_abs_err"] = worst
    entry["tolerance"] = {"float32": 1e-4, "bfloat16": 3e-2}
    if fmt in TWICE:
        entry["bit_identical"] = True  # every schedule: two launches, same bits
    entry["by_schedule"] = per_schedule
    if launch:
        entry["launch"] = launch  # printed in the check line, not the kernels line
    return entry


# ------------------------------------------------------------ B3 (SELL) design
def sell_design(mat) -> dict:
    """The launch B3's plan chose for a prepared SELL matrix: threads per row
    P, slices per CTA, threads per CTA, CTAs; beside it the live and the
    stored elements."""
    n_slices = mat.slice_width.shape[0]
    plan = sell_launch_plan(n_slices, mat.C, mat.data.shape[0] / (n_slices * mat.C),
                            sm_count(DEVICE))
    live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, mat.C)
    return {"C": mat.C, "slices": n_slices, **plan, "slots_live": int(live.sum()),
            "slots_stored": int(mat.data.shape[0])}


def sell_sweep(mat, x: torch.Tensor, sched: KernelSchedule, y_plain: torch.Tensor,
               tol: float) -> dict:
    """B3 at its plan and at every other P that fits a CTA, through the
    launch helper (the wrapper's launch counter does not move): against the
    plain version, twice (same bits), timed, and once more with the
    kernel's read counts on, whose sum (``slots_read``) must equal the stop
    rule's host twin (``slots_read_modelled``, ``sell_slots_read``)."""
    n_slices = mat.slice_width.shape[0]
    args = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x, mat.C)
    ref = y_plain.reshape(-1).cpu().numpy()
    live = sell_live_width(mat.data, mat.slice_ptr, mat.slice_width, mat.C).cpu()
    out = {}
    for plan in sell_plan_choices(n_slices, mat.C, mat.data.shape[0] / (n_slices * mat.C),
                                  sm_count(DEVICE)):
        tag = f"P{plan['row_threads']}"
        first = _sell_launch(*args, plan, sched)
        y = _sell_launch(*args, plan, sched)
        reads = torch.zeros(plan["ctas"] * plan["threads"], dtype=torch.int32, device=DEVICE)
        y_counted = _sell_launch(*args, plan, sched, reads)
        torch.cuda.synchronize()
        err = scaled_err(y.reshape(-1).cpu().numpy(), ref)
        if not (err <= tol and torch.equal(first, y) and torch.equal(y, y_counted)):
            raise AssertionError(f"sell kernel at {tag}: vs plain {err:.3e}, "
                                 f"same bits {torch.equal(first, y)}, "
                                 f"with counts {torch.equal(y, y_counted)}")
        read = int(reads.sum())
        modelled = sell_slots_read(live, mat.slice_width.cpu(), mat.C, plan, sched.unroll)
        if read != modelled:
            raise AssertionError(f"sell kernel at {tag} read {read} elements, "
                                 f"its host twin says {modelled}")
        out[tag] = {"slices_per_cta": plan["slices_per_cta"], "ctas": plan["ctas"],
                    "err_vs_plain": err, "slots_read": read, "slots_read_modelled": modelled,
                    "ms": timed(lambda: _sell_launch(*args, plan, sched))}
    return out


# ------------------------------------------------------------ B2 (ELL) design
def ell_design(mat, sched: KernelSchedule) -> dict:
    """The launch B2's plan chose for prepared ELL planes: lanes per row,
    rows per warp and per CTA, CTAs; beside it the live and the stored plane
    slots and the slots its padding stop reads (host twin)."""
    R, W = mat.data.shape
    plan = ell_launch_plan(R, W, sm_count(DEVICE))
    live = ell_live_width(mat.data).cpu()
    return {**plan, "slots_live": int(live.sum()), "slots_stored": R * W,
            "slots_read_modelled": ell_slots_read(live, W, plan, sched.unroll)}


def ell_sweep(mat, x: torch.Tensor, sched: KernelSchedule, y_plain: torch.Tensor,
              y_kernel: torch.Tensor, tol: float) -> dict:
    """B2 at its plan and at every other lane count through the launch
    helper (the wrapper's launch counter does not move): against the plain
    version, twice (same bits, and the wrapper's bits at the plan's lane
    count), timed, and once more with the kernel's read counts on, whose
    sum (``slots_read``) must equal the stop rule's host twin
    (``slots_read_modelled``, ``ell_slots_read``)."""
    R, W = mat.data.shape
    ref = y_plain.reshape(-1).cpu().numpy()
    live = ell_live_width(mat.data).cpu()
    plan0 = ell_launch_plan(R, W, sm_count(DEVICE))
    out = {}
    for plan in ell_plan_choices(R, W, sm_count(DEVICE)):
        tag = f"G{plan['lanes']}"
        first = _ell_launch(mat.data, mat.cols, x, plan, sched)
        y = _ell_launch(mat.data, mat.cols, x, plan, sched)
        reads = torch.zeros(plan["warps"], dtype=torch.int32, device=DEVICE)
        y_counted = _ell_launch(mat.data, mat.cols, x, plan, sched, reads)
        torch.cuda.synchronize()
        err = scaled_err(y.cpu().numpy(), ref)
        same = torch.equal(first, y) and torch.equal(y, y_counted)
        if plan == plan0:
            same = same and torch.equal(y, y_kernel)
        if not (err <= tol and same):
            raise AssertionError(f"ell kernel at {tag}: vs plain {err:.3e}, same bits {same}")
        read = int(reads.sum())
        modelled = ell_slots_read(live, W, plan, sched.unroll)
        if read != modelled:
            raise AssertionError(f"ell kernel at {tag} read {read} plane slots, "
                                 f"its host twin says {modelled}")
        out[tag] = {"ctas": plan["ctas"], "warps": plan["warps"], "err_vs_plain": err,
                    "slots_read": read, "slots_read_modelled": modelled,
                    "ms": timed(lambda: _ell_launch(mat.data, mat.cols, x, plan, sched))}
    return out


# ------------------------------------------------------- B1 (CSR) design
def b1_design(mat, sched: KernelSchedule) -> dict:
    """The launch B1's plan chose for a prepared CSR matrix: threads per CTA,
    rows per row CTA, the hub threshold, the chunk, chunk and row CTAs; the
    hub rows, their nonzeros, those that cross chunks and the pieces
    (carries) stored for them."""
    plan = csr_launch_plan(mat.shape[0], mat.data.shape[0], sched.rows_per_block,
                           sched.unroll, sm_count(DEVICE), n_cols=mat.shape[1])
    return {**plan, **csr_hub_pieces(mat.indptr, plan)}


def b1_sweep(mat, x: torch.Tensor, sched: KernelSchedule, y_plain: torch.Tensor,
             tol: float) -> dict:
    """B1 at every launch of ``B1_ROWS`` x ``B1_UNROLLS``, and at the plan's
    rows and unroll with each hub threshold of ``B1_HUB_ROWS`` and chunk of
    ``B1_CHUNKS``, through the launch helper (the wrapper's launch counter
    does not move): against the plain version, twice (same bits), timed."""
    n, nnz = mat.shape[0], mat.data.shape[0]
    rpb, unroll = sched.rows_per_block, sched.unroll
    sms, cols = sm_count(DEVICE), mat.shape[1]
    plans = [csr_launch_plan(n, nnz, r, u, sms, n_cols=cols) for r in B1_ROWS for u in B1_UNROLLS]
    plans += [csr_launch_plan(n, nnz, rpb, unroll, sms, hub_row=h, n_cols=cols)
              for h in B1_HUB_ROWS]
    plans += [csr_launch_plan(n, nnz, rpb, unroll, sms, chunk=c, n_cols=cols) for c in B1_CHUNKS]
    ref = y_plain.reshape(-1).cpu().numpy()
    args = (mat.data, mat.indices, mat.indptr, x)
    out = {}
    base = csr_launch_plan(n, nnz, rpb, unroll, sms, n_cols=cols)
    for plan in plans:
        tag = f"rows{plan['rows_per_cta']}_u{plan['unroll']}"
        for key in ("hub_row", "chunk"):
            if plan[key] != base[key]:
                tag += f"_{key}{plan[key]}"
        first = _csr_launch(*args, plan, sched)
        y = _csr_launch(*args, plan, sched)
        torch.cuda.synchronize()
        err = scaled_err(y.cpu().numpy(), ref)
        if not (err <= tol and torch.equal(first, y)):
            raise AssertionError(f"csr kernel at {tag}: vs plain {err:.3e}, "
                                 f"same bits {torch.equal(first, y)}")
        out[tag] = {"ctas": plan["ctas"], "err_vs_plain": err,
                    "carries": csr_hub_pieces(mat.indptr, plan)["pieces"],
                    "ms": timed(lambda: _csr_launch(*args, plan, sched))}
    return out


def b1_hub_bf16(web: np.ndarray, draws: int = 16) -> dict:
    """bf16 error of B1 on ``webgraph``'s longest (hub) row and over all rows
    against the float64 host product, scaled by max |y| as the tolerances
    are, at the bf16 schedules of the six and the served one: mean and max
    over ``draws`` x vectors (one draw's error is mostly chance). A draw
    beyond the bf16 tolerance (3e-2) on the hub row or any row fails."""
    rng = np.random.default_rng(SEED + 17)
    hub = int(np.argmax((web != 0).sum(axis=1)))
    out = {"row": hub, "row_nnz": int((web[hub] != 0).sum()), "draws": draws, "tol": 3e-2}
    scheds = [s for s in SCHEDULES if s.accum_dtype == "bfloat16"]
    scheds.append(KernelSchedule(rows_per_block=8, nnz_tile=1024, unroll=8,
                                 accum_dtype="bfloat16"))
    xs = [rng.normal(size=web.shape[1]).astype(np.float32) for _ in range(draws)]
    refs = [host_product(web, x) for x in xs]
    for sched in scheds:
        mat = prepare(web, "csr", sched, device=DEVICE)
        errs = {"b1": [], "b1_all_rows": []}
        for x_host, ref in zip(xs, refs):
            x = torch.as_tensor(x_host, device=DEVICE)
            y = csr_spmv(mat.data, mat.indices, mat.indptr, x, sched).cpu().numpy()
            errs["b1"].append(abs(float(y[hub]) - ref[hub]) / float(np.abs(ref).max()))
            errs["b1_all_rows"].append(scaled_err(y, ref))
        row = {k: {"mean": float(np.mean(v)), "max": float(np.max(v))} for k, v in errs.items()}
        out[sched_tag(sched)] = row
        if not max(row["b1"]["max"], row["b1_all_rows"]["max"]) <= out["tol"]:
            raise AssertionError(f"B1 in bf16 on webgraph's hub row at {sched}: {row}")
    return out


# ------------------------------------------------------- B5 (fused) design
def b5_inputs(f, x: torch.Tensor) -> tuple:
    """What B5 reads of a lowered stream: values and columns, the plan's
    16-bit window rows (in place of the 4-byte row ids) and packed array,
    and x."""
    packed, window_rows = plan_buffers(f.launch_plan, x.device)
    return (f.data, f.cols, window_rows, packed, x)


def b5_design(f, x: torch.Tensor, y_kernel: torch.Tensor, y_plain: torch.Tensor,
              tol: float) -> dict:
    """B5's plan for a lowered stream and what the card shows of it, through
    the launch helper (the wrapper's counter does not move): the plan's
    pieces (one CTA each), piece length, largest window, shared rows and
    groups; the global stores a counting launch makes (``writes_counted``)
    against the plan's count; a second launch's bits; the spill slot 0; the
    kernel against the plain version."""
    plan = f.launch_plan
    kw = dict(unroll=f.unroll, accum_dtype=f.accum_dtype)
    counts = torch.zeros(plan["ctas"], dtype=torch.int32, device=DEVICE)
    y_counted = _fused_launch(f.data, f.cols, x, plan, writes=counts, **kw)
    y_again = _fused_launch(f.data, f.cols, x, plan, **kw)
    torch.cuda.synchronize()
    writes = int(counts.sum())
    same = torch.equal(y_kernel, y_again) and torch.equal(y_kernel, y_counted)
    err = scaled_err(y_kernel[:-1].cpu().numpy(), y_plain.reshape(-1)[:-1].cpu().numpy())
    spill = float(y_kernel[-1])
    if writes != plan["writes"] or not same or not err <= tol or spill != 0.0:
        raise AssertionError(f"fused kernel: writes {writes} (plan {plan['writes']}), same bits "
                             f"{same}, vs plain {err:.3e}, spill slot {spill}")
    return {**fused_plan_summary(plan), "tiles": f.n_tiles, "tile": f.tile,
            "writes_counted": writes, "bit_identical": same, "err_vs_plain": err}


def check_constants() -> dict:
    """The constants B8's, B3's, B1's, B6's, B2's and B5's host plans share with
    their kernels, as the built kernels export them; raises where Python's
    differ."""
    got = {}
    for source, n in (("spmm_ell", 2), ("spmv_sell", 2), ("spmv_csr", 4), ("spmspv_csc", 2),
                      ("spmv_ell", 1), ("spmv_fused", 8)):
        out = (ctypes.c_int * n)()
        fn = getattr(kbuild.load_library(source), f"{source}_constants")
        fn.restype = None
        fn(out)
        got[source] = list(out)
    want = {"spmm_ell": [SPMM_CHUNK, SPMM_WARPS_PER_CTA],
            "spmv_sell": [SELL_MAX_THREADS, SELL_CARRY_PRODUCTS],
            "spmv_csr": [CSR_MAX_THREADS, CSR_MAX_HUBS, CSR_ROUND, CSR_CARRY_PRODUCTS],
            "spmspv_csc": [SPMSPV_SLOTS, SPMSPV_CTA_WARPS[-1]],
            "spmv_ell": [ELL_WARPS_PER_CTA],
            "spmv_fused": [FUSED_THREADS, FUSED_WINDOW, FUSED_STEPS, FUSED_PIECE_INTS,
                           FUSED_GROUP_INTS, FUSED_CTAS_PER_SM, FUSED_PAD_ROW, FUSED_ALIGN]}
    if got != want:
        raise AssertionError(f"kernel constants {got} differ from the host plans' {want}")
    return got


def kernel_registers(logs: dict, source: str, pattern: str) -> dict:
    """Registers and spill bytes of each template instance of one source's
    kernel, from its ``-Xptxas=-v`` build log: {instance: [regs, spill
    bytes]}, the instance named by ``pattern``'s groups joined by ``_``."""
    out = {}
    for k in kbuild.ptxas_usage(logs.get(source, "")):
        m = re.search(pattern, k["function"])
        if m:
            out["_".join(g.lower() for g in m.groups())] = [k["registers"], k["spill_bytes"]]
    return out


# template instances named by their parameters: B4/B7 accumulator and br;
# B3 accumulator and unroll; B8 accumulator, lanes per slot, columns per lane
# (the served instances, without the read count); B1 kernel (rows: the row
# path alone; spmv: rows and chunks), accumulator and unroll; B2 accumulator,
# lanes per row and unroll, B6 accumulator and lanes per piece (served
# instances); B5 accumulator and the write count (0: the served instance)
INSTANCE = {
    "csr": r"csr_(rows|spmv)_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)E",
    "bell": r"_spmv_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)E",
    "bcsr": r"_spmv_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)E",
    "sell": r"sell_spmv_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)E",
    "spmm": r"ell_spmm_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)ELi(\d+)ELb0E",
    "ell": r"ell_spmv_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)ELi(\d+)ELb0E",
    "spmspv": r"csc_spmspv_kernelIN4spmv\d+Acc(F32|BF16)ELi(\d+)ELb0E",
    "fused": r"fused_spmv_kernelIN4spmv\d+Acc(F32|BF16)ELb([01])E",
}
# kernels whose two launches must give the same bits
TWICE = ("csr", "ell", "sell", "bell", "bcsr", "fused")


# ----------------------------------------------- block kernels B4 / B7 design
BLOCK_KERNELS = ("bell", "bcsr")


def block_rows_of(fmt: str, mat) -> tuple[int, int, torch.Tensor]:
    """(block rows, the blocks per row the segment rule is given, blocks the
    kernel reads in each block row) of a prepared BELL or BCSR matrix."""
    if fmt == "bell":
        nbr, mb = mat.block_cols.shape
        return nbr, mb, bell_live_blocks(mat.block_cols)
    nbr = mat.n_block_rows
    return nbr, -(-mat.data.shape[0] // max(nbr, 1)), (mat.block_ptr[1:] - mat.block_ptr[:-1])


def block_design(fmt: str, mat, sched: KernelSchedule, ms=None, nbytes=None) -> dict:
    """What the block kernel's launch looks like on this card: segments S,
    the ring (stages x chunk bytes), dynamic shared memory per CTA, clusters
    resident at once (cudaOccupancyMaxActiveClusters), the blocks it reads
    and how ragged its block rows are; with a time, the rate it reached on
    the bytes the product needs."""
    nbr, per_row, live = block_rows_of(fmt, mat)
    segments = block_segments(nbr, per_row, sm_count(DEVICE))
    with torch.cuda.device(DEVICE):
        plan = block_launch_plan(SOURCE[fmt], mat.br, segments,
                                 sched.accum_dtype == "bfloat16")
    live = live.float()
    out = {"br": mat.br, "block_rows": nbr, "segments": segments, "ctas": nbr * segments,
           "stages": plan["stages"], "stage_bytes": plan["chunk_bytes"],
           "smem_bytes_per_cta": plan["smem_bytes"], "threads_per_cta": plan["threads"],
           "active_clusters": plan["active_clusters"], "blocks_read": int(live.sum()),
           "max_over_mean_blocks": float(live.max() / live.mean().clamp(min=1e-9))}
    if ms is not None:
        out["tb_per_s"] = nbytes / ms / 1e9
    return out


def segment_sweep(fmt: str, mat, panels: torch.Tensor, sched: KernelSchedule,
                  y_plain: torch.Tensor, tol: float) -> dict:
    """The kernel at every S of the design, whatever the segment rule would
    pick here, against the plain version, timed, with the clusters of S
    CTAs the card holds at once: the C entry point called directly (the
    wrapper's launch counter does not move)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(DEVICE).cuda_stream
    bf16 = int(sched.accum_dtype == "bfloat16")
    ref = y_plain.reshape(-1).cpu().numpy()
    out = {}
    for segments in BLOCK_SEGMENT_CHOICES:
        y = torch.empty_like(y_plain)
        if fmt == "bell":
            fn = kbuild.bind("spmv_bell", "spmv_bell_launch", [vp] * 4 + [ci] * 6 + [vp])
            nbr, mb = mat.block_cols.shape
            args = (mat.data.data_ptr(), mat.block_cols.data_ptr(), panels.data_ptr(),
                    y.data_ptr(), nbr, mb, mat.br, mat.bc, bf16, segments, stream)
        else:
            fn = kbuild.bind("spmv_bcsr", "spmv_bcsr_launch", [vp] * 5 + [ci] * 5 + [vp])
            args = (mat.data.data_ptr(), mat.block_cols.data_ptr(), mat.block_ptr.data_ptr(),
                    panels.data_ptr(), y.data_ptr(), mat.n_block_rows, mat.br, mat.bc,
                    bf16, segments, stream)
        kbuild.check_launch(fn(*args), f"{fmt} kernel at S = {segments}")
        torch.cuda.synchronize()
        err = scaled_err(y.reshape(-1).cpu().numpy(), ref)
        if not err <= tol:
            raise AssertionError(f"{fmt} kernel at S = {segments}: vs plain {err:.3e}")
        with torch.cuda.device(DEVICE):
            plan = block_launch_plan(SOURCE[fmt], mat.br, segments, bool(bf16))
        out[segments] = {"err_vs_plain": err, "ms": timed(lambda: fn(*args)),
                         "active_clusters": plan["active_clusters"]}
    return out


def block_yardsticks(mat, segments: int) -> dict:
    """Yardsticks for the BCSR kernel's time, timed here and used nowhere in
    the port: the same launch over empty block rows (block_ptr all zero:
    launch, set-up and combine, no block streamed); one ``zero_`` of its
    output (the least any launch costs under this timing); and one
    ``torch.sum`` over the stored blocks it streams (the card's read rate on
    the same bytes through a PyTorch reduction)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = kbuild.bind("spmv_bcsr", "spmv_bcsr_launch", [vp] * 5 + [ci] * 5 + [vp])
    zero_ptr = torch.zeros_like(mat.block_ptr)
    y = torch.empty((mat.n_block_rows, mat.br), dtype=torch.float32, device=DEVICE)
    panels = torch.zeros((1, mat.bc), dtype=torch.float32, device=DEVICE)
    args = (mat.data.data_ptr(), mat.block_cols.data_ptr(), zero_ptr.data_ptr(),
            panels.data_ptr(), y.data_ptr(), mat.n_block_rows, mat.br, mat.bc, 0, segments,
            torch.cuda.current_stream(DEVICE).cuda_stream)
    kbuild.check_launch(fn(*args), "bcsr kernel over empty block rows")
    blocks = mat.data[: mat.n_blocks]
    sum_ms = timed(lambda: blocks.sum())
    return {"empty_launch_ms": timed(lambda: fn(*args)), "zero_output_ms": timed(y.zero_),
            "torch_sum_ms": sum_ms, "torch_sum_tb_per_s": blocks.numel() * 4 / sum_ms / 1e9}


def library_call(fmt: str, dense: np.ndarray, mat, x: torch.Tensor, ref64, entry: dict) -> None:
    """Time one PyTorch call that computes the same y = A x: the library's
    CSR product of the same matrix, whatever storage the kernel reads (the
    fused stream's function is the whole matrix's product too)."""
    csr = mat if fmt == "csr" else prepare(dense, "csr", device=DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR is beta" notices
        a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                    size=csr.shape, device=DEVICE)
        y_l = (a @ x).cpu().numpy()
        entry["library_err"] = scaled_err(y_l, ref64)
        entry["library_ms"] = timed(lambda: a @ x)
    entry["library"] = "torch.sparse_csr_tensor(A) @ x"


# ------------------------------------------------------------ partitioned
def cache_entry(session, dense, objective="latency"):
    """The session's cached partitioned plan for ``dense`` (bucket level)."""
    bucket = session.cache.bucket_of(extract_features(dense))
    return session.cache.peek(bucket, objective, f"part:max{MAX_BLOCKS}")


def span_totals(spans: list[dict]) -> dict:
    """Count and seconds of the spans, by name."""
    out: dict[str, dict] = {}
    for s in spans:
        cell = out.setdefault(s["name"], {"count": 0, "total_s": 0.0})
        cell["count"] += 1
        cell["total_s"] += s["dur_s"]
    return out


def serve_partitioned_requests(session, server, part_pool, names, xs, fused: bool):
    """One request per ``server.run`` call, traced, so each request's span
    seconds are read off the tracer emptied before its call."""
    rows, blocks_served = [], {f: 0 for f in BLOCK_FORMATS}
    for rid, (n, x) in enumerate(zip(names, xs)):
        dense = part_pool[n]
        with tracing() as tracer:
            tracer.clear()
            t0 = time.perf_counter()
            (req,) = server.run([SpmvRequest(rid=rid, dense=dense, x=x, objective="latency")])
            wall = time.perf_counter() - t0
            spans = {k: v["total_s"] for k, v in span_totals(tracer.spans()).items()
                     if v["total_s"] > 0}
        entry = cache_entry(session, dense)
        bf16 = [b["schedule"]["accum_dtype"] == "bfloat16" for b in entry.blocks]
        # fused: bf16 only when every block asked for it; sequential: any block
        tol = 3e-2 if (all(bf16) if fused else any(bf16)) else 1e-4
        ref = host_product(dense, x)
        err = scaled_err(req.y, ref)
        formats = req.fmt.split("+")
        mono = entry.predicted.get("monolithic_latency", 0.0)
        gain = (mono - entry.predicted["latency"]) / mono if mono else 0.0
        bell_blocks = [(b["row_start"], b["row_end"]) for b in entry.blocks if b["fmt"] == "bell"]
        for f in formats:
            blocks_served[f] += 1
        rows.append({"rid": rid, "matrix": n, "k": len(formats), "formats": formats,
                     "modeled_gain": gain, "hit": req.cache_hit, "err": err, "tol": tol,
                     "wall_s": wall, "request_s": req.latency_s, "spans": spans,
                     "bell_blocks": bell_blocks})
        if not (req.y.shape == ref.shape and np.isfinite(req.y).all() and err <= tol):
            raise AssertionError(f"partitioned request {rid} ({n}, fused={fused}) wrong: "
                                 f"err {err:.3e} > {tol:.0e}")
    return rows, blocks_served


def served_bell_block(session, results: list[dict], part_pool, forced: dict):
    """The largest BELL block the partitioned path served (the rows
    ``partitioned.bell_blocks`` reports) with the schedule its plan gave it;
    without one, the forced hetero plan's BELL block at the default schedule.
    Returns (matrix name, (row_start, row_end), schedule, where it came from)."""
    best = None
    for r in results:
        for r0, r1 in r["bell_blocks"]:
            if best is None or r1 - r0 > best[1][1] - best[1][0]:
                best = (r["matrix"], (r0, r1))
    if best is None:
        rows = forced["blocks"][forced["formats"].index("bell")]
        return "hetero", tuple(rows), DEFAULT_SCHEDULE, "forced plan"
    name, rows = best
    entry = cache_entry(session, part_pool[name])
    sched = next(KernelSchedule(**b["schedule"]) for b in entry.blocks
                 if b["fmt"] == "bell" and (b["row_start"], b["row_end"]) == rows)
    return name, rows, sched, "served plan"


def check_block_case(name: str, rows, dense: np.ndarray, sched: KernelSchedule,
                     source: str) -> dict:
    """B4 and B7 on one row block at the shape the partitioned path launches
    B4 with: against plain and float64, two launches bit for bit, times
    beside the byte bound, the fill of the blocks read and the launch's
    design fields. These launches are checks, not the main path."""
    block = np.ascontiguousarray(dense[rows[0]:rows[1]])
    rng = np.random.default_rng(SEED + 11)
    x_host = rng.normal(size=block.shape[1]).astype(np.float32)
    x = torch.as_tensor(x_host, device=DEVICE)
    ref64 = host_product(block, x_host)
    nnz = int((block != 0).sum())
    out = {"matrix": name, "rows": list(rows), "source": source, "shape": list(block.shape),
           "nnz": nnz, "schedule": sched_tag(sched)}
    for fmt in BLOCK_KERNELS:
        mat = prepared(fmt, block, sched)
        kern, plain, ins, out_elems, flops, _ = kernel_calls(fmt, mat, x, sched)
        y_k = kern()
        torch.cuda.synchronize()
        y_p = plain()
        yk = y_k.reshape(-1)[: block.shape[0]].cpu().numpy()
        err = scaled_err(yk, y_p.reshape(-1)[: block.shape[0]].cpu().numpy())
        err_host, tol = scaled_err(yk, ref64), tol_of(sched)
        identical = torch.equal(y_k, kern())
        if not (np.isfinite(yk).all() and err <= tol and err_host <= tol and identical):
            raise AssertionError(f"{fmt} kernel on the {source}'s BELL block {rows} of {name}: "
                                 f"vs plain {err:.3e}, vs float64 {err_host:.3e}, "
                                 f"bit-identical {identical}")
        ms = timed(kern)
        bound_ms, bound_by, nbytes = bound(ins, out_elems, flops)
        design = block_design(fmt, mat, sched, ms=ms, nbytes=nbytes)
        out[fmt] = {"ms": ms, "plain_ms": timed(plain, reps=5), "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "err_vs_plain": err,
                    "err_vs_host": err_host, "bit_identical": identical,
                    "block_fill": nnz / max(design["blocks_read"] * mat.br * mat.bc, 1),
                    **design}
        del mat
    return out


def pin_partitioned(session, dense: np.ndarray, fmts) -> dict:
    """Put the forced plan of ``dense`` (``fmts`` round-robin over their
    count of blocks, the default schedule) into ``session``'s plan cache at
    the key ``partitioned_optimize`` looks up, so requests for it replay the
    plan: the cache hit path a restarted server takes. Its blocks carry no
    modelled latency (no prior for the bandit's arms)."""
    plan = forced_plan(dense, fmts, len(fmts), DEFAULT_SCHEDULE)
    entry = CacheEntry(
        bucket=session.cache.bucket_of(extract_features(dense)), objective="latency",
        mode=f"part:max{MAX_BLOCKS}", fmt="+".join(plan.formats),
        schedule=DEFAULT_SCHEDULE.as_dict(),
        predicted={"latency": 0.0, "monolithic_latency": 0.0}, n_blocks=plan.n_blocks,
        blocks=[bp.as_dict() for bp in plan.blocks], monolithic_fmt=plan.monolithic_fmt)
    session.cache.put(entry)
    return {"matrix": PINNED_MATRIX, "formats": list(plan.formats),
            "blocks": [(bp.block.row_start, bp.block.row_end) for bp in plan.blocks]}


def run_forced(dense: np.ndarray, fmts, x: np.ndarray) -> dict:
    """A forced four-block plan through both executors: fused against
    sequential against the float64 host product."""
    plan = forced_plan(dense, fmts, 4, DEFAULT_SCHEDULE)
    seq = compile_partitioned(dense, plan, device=DEVICE)
    fused = compile_fused_partitioned(dense, plan, device=DEVICE)
    y_seq = seq(x).cpu().numpy()
    y_fused = fused(x).cpu().numpy()
    ref = host_product(dense, x)
    out = {"formats": list(plan.formats),
           "blocks": [(bp.block.row_start, bp.block.row_end) for bp in plan.blocks],
           "tiles": fused.n_tiles, "tile": fused.kernel.tile,
           "err_sequential": scaled_err(y_seq, ref), "err_fused": scaled_err(y_fused, ref),
           "fused_vs_sequential": scaled_err(y_fused, y_seq)}
    if not (np.isfinite(y_fused).all() and max(out["err_sequential"], out["err_fused"],
                                               out["fused_vs_sequential"]) <= 1e-4):
        raise AssertionError(f"forced plan {fmts} wrong: {out}")
    return out


def composite_row(seq, fused, formats, dense: np.ndarray, x: torch.Tensor,
                  registers: dict) -> dict:
    """One composite on the card: B5 (through the launch helper) against the
    plain version, its plan and counted writes, two launches bit for bit;
    then, by CUDA events with the L2 flushed, B5, the fused executor's call, the
    sequential executor (k launches and the concatenation) and the
    library's CSR product of the whole matrix, beside the bound over what
    B5 reads and over the stream's own arrays. These launches are checks and
    timings, not the main path, and are not counted."""
    f = fused.kernel  # the executor's FusedSpmv
    kw = dict(unroll=f.unroll, accum_dtype=f.accum_dtype)
    kern = lambda: _fused_launch(f.data, f.cols, x, f.launch_plan, **kw)  # noqa: E731
    y_k = kern()
    y_p = fused_spmv_plain(f.data, f.cols, f.rows, f.tile_map, x, f.n_rows, f.tile, **kw)
    tol = 3e-2 if f.accum_dtype == "bfloat16" else 1e-4
    design = b5_design(f, x, y_k, y_p, tol)
    nnz = int((f.rows < f.n_rows).sum())
    bound_ms, bound_by, nbytes = bound(b5_inputs(f, x), f.n_rows + 1, 2 * nnz)
    row = {"k": len(formats), "formats": list(formats), "nnz": nnz,
           "stream_entries": int(f.data.shape[0]),
           "unroll": f.unroll, "accum": f.accum_dtype, **design, "ms": timed(kern),
           "fused_ms": timed(lambda: fused(x)), "sequential_ms": timed(lambda: seq(x)),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "stream_bound_ms": bound((f.data, f.cols, f.rows, f.tile_map, x), f.n_rows + 1,
                                    2 * nnz)[0],
           "registers": registers.get("bf16_0" if f.accum_dtype == "bfloat16" else "f32_0")}
    row["by_piece"] = b5_sweep(f, x, y_p, tol)
    library_call("fused", dense, None, x, host_product(dense, x.cpu().numpy()), row)
    return row


def b5_sweep(f, x: torch.Tensor, y_plain: torch.Tensor, tol: float) -> dict:
    """B5 over plans of other piece lengths (``B5_PIECES``) for the same
    stream, through the launch helper: CTAs, largest window, shared rows,
    against the plain version (another order of sums: within tolerance),
    timed."""
    rows, tmap = f.rows.cpu().numpy(), f.tile_map.cpu().numpy()
    kw = dict(unroll=f.unroll, accum_dtype=f.accum_dtype)
    ref = y_plain[:-1].cpu().numpy()
    out = {}
    for piece in B5_PIECES:
        plan = fused_launch_plan(rows, tmap, f.tile, f.n_rows, sm_count(DEVICE), piece=piece)
        plan_buffers(plan, DEVICE)
        y = _fused_launch(f.data, f.cols, x, plan, **kw)
        torch.cuda.synchronize()
        err = scaled_err(y[:-1].cpu().numpy(), ref)
        if not err <= tol:
            raise AssertionError(f"fused kernel at pieces of {piece}: vs plain {err:.3e}")
        out[piece] = {"ctas": plan["ctas"], "max_window": plan["max_window"],
                      "shared_rows": plan["shared_rows"], "err_vs_plain": err,
                      "ms": timed(lambda: _fused_launch(f.data, f.cols, x, plan, **kw))}
    return out


def time_composites(session, part_pool, fps, x_of, registers: dict) -> dict:
    """Per served matrix, its served composite (plans and kernels from the
    session's caches: hits) through ``composite_row``; then the forced
    four-block plan of ``hetero``."""
    out = {}
    for n, dense in part_pool.items():
        x = torch.as_tensor(x_of[n], device=DEVICE)
        seq, fused = (session.partitioned_optimize(dense, max_blocks=MAX_BLOCKS, fused=f,
                                                   fingerprint=fps[n]) for f in (False, True))
        out[n] = composite_row(seq.kernel, fused.kernel, fused.plan.formats, dense, x,
                               registers)
    dense = part_pool["hetero"]
    plan = forced_plan(dense, FORCED_FORMATS, 4, DEFAULT_SCHEDULE)
    x = torch.as_tensor(x_of["hetero"], device=DEVICE)
    out["hetero_forced"] = composite_row(compile_partitioned(dense, plan, device=DEVICE),
                                         compile_fused_partitioned(dense, plan, device=DEVICE),
                                         plan.formats, dense, x, registers)
    return out


# ------------------------------------------------------------------ spmspv
def frontiers_of(counts: np.ndarray, rng) -> list[tuple[str, np.ndarray]]:
    """The check's frontiers (sorted column indices, as a solver's
    ``flatnonzero`` gives them): the single largest column; 1 %, 10 % (the
    policy's threshold) and 50 % of the columns drawn at random; all of
    them; the 16 longest columns."""
    n_cols = counts.size
    out = [("largest_column", np.array([int(np.argmax(counts))], np.int32))]
    for pct in (1, 10, 50):
        pick = rng.choice(n_cols, size=n_cols * pct // 100, replace=False)
        out.append((f"{pct}%", np.sort(pick).astype(np.int32)))
    out.append(("full", np.arange(n_cols, dtype=np.int32)))
    out.append(("hubs", np.sort(np.argsort(counts, kind="stable")[-16:]).astype(np.int32)))
    return out


def staged_of(act: torch.Tensor, xv: torch.Tensor, plan: dict) -> torch.Tensor:
    """B6's staged frontier (``[active | bits of xvals | pieces]``) on the
    card, in a tensor of its own."""
    pieces = torch.from_numpy(plan["pieces"].reshape(-1)).to(DEVICE)
    return torch.cat([act, xv.view(torch.int32), pieces])


def b6_plan_checks(mat, f: dict, n_rows: int, sched: KernelSchedule, y_plain: np.ndarray,
                   tol: float) -> dict:
    """At the served schedule, for one frontier: B6's plan (lanes per piece,
    piece size, further pieces, warps, warps per CTA, CTAs), its read counts
    (one launch with the kernel's own counts on: each warp's must equal the
    host twin's pieces of that warp, their sum ``spmspv_slots_read``) and
    every launch of ``B6_LAUNCHES`` through the launch helper (the wrapper's counter does not move): twice against
    the plain version, timed."""
    lens = mat.col_len_host[f["active"]]
    act = torch.as_tensor(f["active"], device=DEVICE)
    xv = torch.as_tensor(f["xvals"], device=DEVICE)
    sms = sm_count(DEVICE)
    plan = spmspv_launch_plan(lens, sms)
    reads = torch.zeros(plan["warps"], dtype=torch.int32, device=DEVICE)
    _spmspv_launch(mat.data, mat.rows, mat.col_len, staged_of(act, xv, plan), plan, n_rows,
                   sched, reads)
    per_warp = reads.cpu().numpy()
    groups = 32 // plan["lanes"]
    lengths = spmspv_pieces(lens, plan)[:, 2]
    want = np.zeros(plan["warps"] * groups, np.int64)
    want[: lengths.size] = lengths
    want = want.reshape(plan["warps"], groups).sum(axis=1)
    read, modelled = int(per_warp.sum()), spmspv_slots_read(lens, plan)
    if not (np.array_equal(per_warp, want) and read == modelled == int(lens.sum())):
        raise AssertionError(f"spmspv kernel read {read} slots at frontier {f['name']}, "
                             f"its host twin says {modelled} (warps equal: "
                             f"{np.array_equal(per_warp, want)})")
    by_launch = {}
    for lanes, piece in B6_LAUNCHES:
        tag = f"G{lanes}_H{piece}"
        p = spmspv_launch_plan(lens, sms, lanes, piece)
        staged = staged_of(act, xv, p)
        errs = []
        for _ in range(2):
            y = _spmspv_launch(mat.data, mat.rows, mat.col_len, staged, p, n_rows, sched)
            errs.append(scaled_err(y[:n_rows].cpu().numpy(), y_plain))
        if max(errs) > tol:
            raise AssertionError(f"spmspv kernel at {tag}, frontier {f['name']}: "
                                 f"vs plain {errs}")
        by_launch[tag] = {
            "extra": p["extra"], "warps": p["warps"], "ctas": p["ctas"], "err_vs_plain": errs,
            "ms": timed(lambda: _spmspv_launch(mat.data, mat.rows, mat.col_len, staged, p,
                                               n_rows, sched))}
    return {"plan": {k: plan[k] for k in ("lanes", "piece", "extra", "warps", "warps_per_cta",
                                          "ctas")},
            "longest_column": int(lens.max(initial=0)), "slots_read": read,
            "slots_read_modelled": modelled, "by_launch": by_launch}


def check_spmspv(web: np.ndarray, time_schedule: KernelSchedule) -> dict:
    """Hold the SpMSpV kernel against its plain version and a float64 host
    product over the six schedules and six frontiers of ``webgraph``, two
    launches each (float atomics: each within tolerance, not the same
    bits). At 10 % time every schedule;
    at ``time_schedule`` (the one the solver's SpMSpV twin runs) time every
    frontier, its byte bound, the plain version,
    the library's CSR product of the same x and the CSR kernel on the same
    matrix and x, with B6's plan, read counts and launch sweep; and the
    zeroing of y alone. B6 is timed through its launch helper on a staged
    frontier: the zeroing of y and the kernel."""
    import scipy.sparse

    rng = np.random.default_rng(SEED + 13)
    n_rows, n_cols = web.shape
    counts = col_nnz(web)
    a64 = scipy.sparse.csr_matrix(web).astype(np.float64)
    fronts = []
    for name, active in frontiers_of(counts, rng):
        xvals = rng.normal(size=active.size).astype(np.float32)
        x = np.zeros(n_cols, np.float32)
        x[active] = xvals
        fronts.append({"name": name, "active": active, "xvals": xvals, "x": x,
                       "ref64": a64 @ x.astype(np.float64)})
    csr = prepare(web, "csr", device=DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR is beta" notice
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape,
                                      device=DEVICE)
    schedules = list(SCHEDULES)
    if time_schedule not in schedules:
        schedules.append(time_schedule)
    mats, worst, per_schedule, timed_rows = {}, 0.0, {}, []
    t_conv = memset_ms = None
    sms = sm_count(DEVICE)
    for sched in schedules:
        if sched.nnz_tile not in mats:  # the storage depends on nnz_tile only
            t0 = time.perf_counter()
            mats[sched.nnz_tile] = csc_from_dense(web, sched, device=DEVICE)
            torch.cuda.synchronize()
            if sched.nnz_tile == time_schedule.nnz_tile:
                t_conv = time.perf_counter() - t0
        mat = mats[sched.nnz_tile]
        tol = tol_of(sched)
        for f in fronts:
            act = torch.as_tensor(f["active"], device=DEVICE)
            xv = torch.as_tensor(f["xvals"], device=DEVICE)
            plain_args = (mat.data, mat.rows, act, xv, n_rows, sched)
            runs = [csc_spmspv_kernel(mat.data, mat.rows, mat.col_len, act, xv, n_rows, sched)
                    for _ in range(2)]
            torch.cuda.synchronize()  # a fault during the run surfaces here
            yp = csc_spmspv_plain(*plain_args)[:n_rows].cpu().numpy()
            errs = []
            for y_k in runs:
                yk = y_k[:n_rows].cpu().numpy()
                err, err_host = scaled_err(yk, yp), scaled_err(yk, f["ref64"])
                if not (np.isfinite(yk).all() and err <= tol and err_host <= tol):
                    raise AssertionError(
                        f"spmspv kernel disagrees on webgraph, frontier {f['name']}, {sched}: "
                        f"vs plain {err:.3e}, vs host float64 {err_host:.3e}, "
                        f"tolerance {tol:.0e}")
                errs.append((err, err_host))
            err, err_host = max(e[0] for e in errs), max(e[1] for e in errs)
            worst = max(worst, err)
            plan = spmspv_launch_plan(mat.col_len_host[f["active"]], sms)
            staged = staged_of(act, xv, plan)

            def kern():
                return _spmspv_launch(mat.data, mat.rows, mat.col_len, staged, plan, n_rows,
                                      sched)
            if f["name"] == "10%":
                tag = sched_tag(sched) + ("_par" if sched.dimension_semantics == "parallel" else "")
                per_schedule[tag] = {"ms": timed(kern), "err_vs_plain": err,
                                     "err_vs_host": err_host}
            if sched != time_schedule:
                continue
            if memset_ms is None:  # the zeroing of y alone: a launch with no warp
                empty = torch.zeros(0, dtype=torch.int32, device=DEVICE)
                memset_ms = timed(lambda: _spmspv_launch(
                    mat.data, mat.rows, mat.col_len, empty, spmspv_grid(0, 0, 32, 32 * SPMSPV_SLOTS, sms),
                    n_rows, sched))
            k, touched = int(f["active"].size), int(counts[f["active"]].sum())
            nbytes = touched * 8 + k * 8 + (n_rows + 1) * 4  # what skipping padding must move
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * touched / FP32_FLOPS
            x_dev = torch.as_tensor(f["x"], device=DEVICE)
            y_lib = (lib @ x_dev).cpu().numpy()
            y_b1 = csr_spmv(csr.data, csr.indices, csr.indptr, x_dev, sched).cpu().numpy()
            row = {"frontier": f["name"], "k": k, "density": k / n_cols,
                   "nnz_touched": touched, "padded_slots_of_frontier": k * mat.width,
                   "ms": timed(kern),
                   "plain_ms": timed(lambda: csc_spmspv_plain(*plain_args), reps=5),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                   "library_ms": timed(lambda: lib @ x_dev),
                   "library_err": scaled_err(y_lib, f["ref64"]),
                   "b1_ms": timed(lambda: csr_spmv(csr.data, csr.indices, csr.indptr, x_dev,
                                                   sched)),
                   "b1_plain_ms": timed(lambda: csr_spmv_plain(
                       csr.data, csr.indices, csr.indptr, x_dev, sched), reps=5),
                   "b1_err": scaled_err(y_b1, f["ref64"]),
                   "err_vs_plain": err, "err_vs_host": err_host,
                   **b6_plan_checks(mat, f, n_rows, sched, yp, tol)}
            if max(row["library_err"], row["b1_err"]) > 1e-4:
                raise AssertionError(f"library or CSR product wrong on webgraph: {row}")
            timed_rows.append(row)
    head = next(r for r in timed_rows if r["frontier"] == "10%")
    mat = mats[time_schedule.nnz_tile]
    entry = {
        "matrix": f"webgraph@{n_rows}",
        "shape": [n_rows, n_cols],
        "nnz": int(counts.sum()),
        "schedule": sched_tag(time_schedule),
        "frontier": "10%",
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                                "library_ms", "b1_ms", "b1_plain_ms", "plan")},
        "memset_ms": memset_ms,
        "library": "torch.sparse_csr_tensor(A) @ x (x dense, the frontier's values)",
        "cscell": {"width": mat.width, "nbytes": mat.nbytes, "max_col_nnz": int(counts.max()),
                   "dangling_columns": int((counts == 0).sum()),
                   "conversion_and_copy_s": t_conv},
        "frontiers": timed_rows,
        "max_abs_err": worst,
        "tolerance": {"float32": 1e-4, "bfloat16": 3e-2},
        "by_schedule": per_schedule,
    }
    del mats, lib, csr
    return entry


# ------------------------------------------------------------------- solve
def pagerank_oracle(web: np.ndarray, v: np.ndarray, damping: float = 0.85,
                    tol: float = 1e-13, max_iters: int = 2000) -> np.ndarray:
    """The solvers' PageRank recurrence in float64 on the host, with
    ``scipy.sparse`` (the dense float64 operator would take 1.6 GB)."""
    import scipy.sparse

    a = scipy.sparse.csr_matrix(web).astype(np.float64)
    sums = np.asarray(a.sum(axis=0)).ravel()
    p = (a @ scipy.sparse.diags(np.where(sums > 0, 1.0 / np.where(sums > 0, sums, 1.0), 0.0)))
    p = p.tocsr()
    dangling = sums == 0
    v = v.astype(np.float64) / v.sum()
    r = v.copy()
    for _ in range(max_iters):
        r_next = damping * (p @ r + r[dangling].sum() * v) + (1.0 - damping) * v
        if np.abs(r_next - r).sum() <= tol:
            return r_next
        r = r_next
    return r


def solve_row(res, policy=None) -> dict:
    """What the solve phase prints per solve."""
    kinds = np.array(res.matvec_kinds)
    secs = np.array(res.matvec_seconds)
    p50 = {k: 1e3 * float(np.median(secs[kinds == k])) for k in ("spmv", "spmspv")
           if (kinds == k).any()}
    row = {"solver": res.solver, "iterations": res.iterations, "converged": res.converged,
           "residual": res.residual, "spmv_calls": res.spmv_calls,
           "spmspv_calls": res.spmspv_calls, "matvec_p50_ms": p50,
           "iter_p50_ms": 1e3 * res.iter_p50_s(), "modeled_work": res.modeled_work,
           "spmv_work_equiv": res.spmv_work_equiv,
           "work_ratio": res.modeled_work / max(res.spmv_work_equiv, 1),
           "plan_id": res.plan_id, "fmt": res.fmt, "cache_hit": res.cache_hit,
           "kinds": "".join("S" if k == "spmspv" else "." for k in res.matvec_kinds)}
    if policy is not None:
        row["densities"] = [d.density for d in policy.decisions]
    return row


def span_seconds(spans: list[dict]) -> dict:
    """Seconds by span name, ``kernel.compile`` split by its fmt."""
    out: dict[str, float] = {}
    for s in spans:
        name = s["name"]
        if name == "kernel.compile":
            name += ":" + str(s["attrs"].get("fmt", s["attrs"].get("formats", "?")))
        out[name] = out.get(name, 0.0) + s["dur_s"]
    return out


def one_flip(kinds: list[str]) -> bool:
    """SpMSpV first, then SpMV for good."""
    if not kinds or kinds[0] != "spmspv" or "spmv" not in kinds:
        return False
    flip = kinds.index("spmv")
    return all(k == "spmspv" for k in kinds[:flip]) and all(k == "spmv" for k in kinds[flip:])


def host_ms(fn, reps: int = 30) -> float:
    """Median host-clock ms of ``fn`` followed by a device synchronise."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(out))


def host_only_ms(fn, reps: int = 300) -> float:
    """Median host-clock ms of ``fn``, a host function (no device work)."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(out))


def iteration_breakdown(session, web: np.ndarray, power_res, policy) -> dict:
    """Host-clock split of one power-iteration step on ``webgraph``: the
    numpy step, the copies and the kernel call (launch + wait), for an SpMV
    iteration and for an SpMSpV one at the 10 % frontier; for the latter
    also the launch plan, the launch with and without its copy of the
    frontier. Then B6's wrapper at frontiers of 1, 5 and 10 % of the
    columns and the plan's two ways of listing pieces (a loop, numpy) at
    frontiers of 1 % to all columns. Kernels and plans come from the
    session's memo (hits).
    Run after the solve phase's launches are read: these launches are
    timing, not the main path."""
    import repro_torch.kernels.spmspv as spmspv_mod
    from repro_torch.solvers.iterate import IterativeSolver

    solver = IterativeSolver(session, web, name="breakdown", policy=policy)
    solver.setup()
    spmv_k, spmspv_k = solver._spmv_kernel, solver._ensure_spmspv()
    n = web.shape[1]
    rng = np.random.default_rng(SEED + 21)
    x = rng.normal(size=n).astype(np.float32)
    fronts = {f"{pct}%": np.sort(rng.choice(n, size=n * pct // 100, replace=False)).astype(
        np.int32) for pct in (1, 5, 10, 50, 100)}
    act = fronts["10%"]
    xv = x[act]
    x_dev = torch.as_tensor(x, device=DEVICE)
    y_dev = spmv_k(x_dev)
    mat = spmspv_k.mat
    sched = spmspv_k.schedule
    sms = sm_count(DEVICE)
    plan = spmspv_launch_plan(mat.col_len_host[act], sms)
    staged = staged_of(torch.as_tensor(act, device=DEVICE), torch.as_tensor(xv, device=DEVICE),
                       plan)
    frontier = np.concatenate([act, xv.view(np.int32), plan["pieces"].reshape(-1)])
    y = y_dev.cpu().numpy().astype(np.float64)
    xs = x.astype(np.float64)

    def numpy_step():  # power iteration's host work on one y
        lam = float(xs @ y)
        nv = float(np.linalg.norm(y))
        xn = y / nv
        xn = np.where(np.abs(xn) >= 1e-7, xn, 0.0)
        xn = xn / (float(np.linalg.norm(xn)) or 1.0)
        float(np.linalg.norm(y - lam * xs))
        np.flatnonzero(xn.astype(np.float32))

    wrapper = {}
    for name in ("1%", "5%", "10%"):
        a = fronts[name]
        v = x[a]
        wrapper[name] = {"k": int(a.size), "extra": served_plan(mat, a, sms)["extra"],
                         "wrapper_ms": host_ms(lambda: spmspv_k.call_frontier(a, v), 200)}
    few = spmspv_mod.SPMSPV_FEW_LONG
    plan_paths = {}
    for name, a in fronts.items():
        lens = mat.col_len_host[a]
        p = spmspv_launch_plan(lens, sms)
        row = {"k": int(a.size), "long_entries": int((lens > p["piece"]).sum()),
               "extra": p["extra"]}
        for path, limit in (("loop", 1 << 30), ("numpy", -1)):
            spmspv_mod.SPMSPV_FEW_LONG = limit
            try:
                row[f"{path}_ms"] = host_only_ms(lambda: spmspv_launch_plan(lens, sms))
            finally:
                spmspv_mod.SPMSPV_FEW_LONG = few
        plan_paths[name] = row
    return {
        "spmv": {"h2d_x_ms": host_ms(lambda: torch.as_tensor(x, device=DEVICE)),
                 "kernel_call_ms": host_ms(lambda: spmv_k(x_dev)),
                 "d2h_y_ms": host_ms(lambda: y_dev.cpu()),
                 "matvec_ms": host_ms(lambda: solver.matvec(x))},
        "spmspv_10pct": {
            "plan_ms": host_only_ms(lambda: served_plan(mat, act, sms)),
            "kernel_call_ms": host_ms(lambda: _spmspv_launch(
                mat.data, mat.rows, mat.col_len, staged, plan, mat.shape[0], sched)),
            "kernel_call_with_copy_ms": host_ms(lambda: _spmspv_launch(
                mat.data, mat.rows, mat.col_len, frontier, plan, mat.shape[0], sched)),
            "wrapper_ms": wrapper["10%"]["wrapper_ms"],
        },
        "wrapper": wrapper,
        "plan_paths_ms": plan_paths,
        "numpy_step_ms": host_only_ms(numpy_step, reps=30),
        "power_matvec_p50_ms": solve_row(power_res)["matvec_p50_ms"],
        "power_iter_p50_ms": 1e3 * power_res.iter_p50_s(),
    }


def run_solve_phase(tuner, web: np.ndarray, rim: np.ndarray) -> tuple[dict, dict]:
    """The solvers through the public entry points, traced (the caller
    switches the tracer on); returns (payload, launches)."""
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    tracer.clear()
    session = AutoSpmvSession(tuner)
    n = web.shape[0]
    rows, oracle = {}, {}
    reset_launches()

    def traced(name, fn, policy=None):
        before = len(tracer.spans())
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        row = solve_row(res, policy)
        row["wall_s"] = time.perf_counter() - t0
        row["spans"] = span_seconds(tracer.spans()[before:])
        row["session"] = session.stats.as_dict()
        rows[name] = row
        return res

    uniform = traced("pagerank", lambda: pagerank(
        session, web, tol=SOLVE_TOL["pagerank"], max_iters=200))
    r64 = pagerank_oracle(web, np.full(n, 1.0 / n))
    oracle["pagerank"] = float(np.abs(uniform.value - r64).max())
    seed = int(np.flatnonzero(col_nnz(web) > 0)[0])
    pers = np.zeros(n, np.float32)
    pers[seed] = 1.0
    pol_pr = AdaptiveSpmvPolicy()
    personal = traced("pagerank_personalised", lambda: pagerank(
        session, web, tol=SOLVE_TOL["pagerank"], max_iters=200, policy=pol_pr,
        personalization=pers), pol_pr)
    oracle["pagerank_personalised"] = float(
        np.abs(personal.value - pagerank_oracle(web, pers.astype(np.float64))).max())
    pol_pw = AdaptiveSpmvPolicy()
    power = traced("power", lambda: power_iteration(
        session, web, tol=0.0, max_iters=POWER_ITERS, policy=pol_pw), pol_pw)
    spd = launch_solve.spd_operator(rim)
    b = np.random.default_rng(SEED + 5).standard_normal(spd.shape[0]).astype(np.float32)
    cg_res = traced("cg", lambda: cg(session, spd, b, tol=SOLVE_TOL["cg"], max_iters=200))
    import scipy.sparse

    s64 = scipy.sparse.csr_matrix(spd).astype(np.float64)
    cg_rel = float(np.linalg.norm(b - s64 @ cg_res.value) / np.linalg.norm(b))
    del spd, s64

    # the CLI, in-process, with its own tuner (timed around its build_tuner)
    tuner_s = []
    build = launch_solve.build_tuner

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        tuner_s.append(time.perf_counter() - t0)
        return out

    launch_solve.build_tuner = timed_build
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "solve.json")
            t0 = time.perf_counter()
            cli_res = launch_solve.main(["--solver", "power", "--matrix", "webgraph",
                                      "--scale", str(CLI_SCALE), "--adaptive-spmspv",
                                      "--max-iters", str(POWER_ITERS), "--tol", "0",
                                      "--json-out", out])
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t0
            with open(out) as fh:
                cli_json = json.load(fh)
    finally:
        launch_solve.build_tuner = build
    launches = read_launches()

    results = [uniform, personal, power, cg_res, cli_res]
    want_spmspv = sum(r.spmspv_calls for r in results)
    want_spmv = sum(r.spmv_calls for r in results)
    checks = {
        "pagerank_oracle_max_abs": oracle,
        "pagerank_rank_sum": [uniform.extras["rank_sum"], personal.extras["rank_sum"]],
        "power_one_way_flip": one_flip(power.matvec_kinds),
        "power_spmspv_calls": power.spmspv_calls,
        "cg_relative_residual_float64": cg_rel,
        "cli_spmspv_calls": cli_json["spmspv_calls"], "cli_spmv_calls": cli_json["spmv_calls"],
        "spmspv_launches": launches["spmspv"], "want_spmspv": want_spmspv,
        "csr_launches": launches["csr"], "want_csr": want_spmv,
    }
    payload = {"solves": rows, "checks": checks,
               "cli": {"wall_s": cli_wall, "tuner_s": tuner_s, "scale": CLI_SCALE,
                       "n": cli_json["n"], "iterations": cli_json["iterations"],
                       "spmv_calls": cli_json["spmv_calls"],
                       "spmspv_calls": cli_json["spmspv_calls"],
                       "iter_p50_ms": 1e3 * cli_json["iter_p50_s"],
                       "kinds": solve_row(cli_res)["kinds"], "session": cli_json["session"]},
               "session": session.stats.as_dict(), "launches": launches}
    bad = []
    if max(oracle.values()) > 1e-5:
        bad.append("pagerank differs from its float64 oracle")
    if max(abs(s - 1.0) for s in checks["pagerank_rank_sum"]) > 1e-5:
        bad.append("rank sum off 1")
    if not (uniform.converged and personal.converged and cg_res.converged):
        bad.append("a solve did not converge")
    if personal.spmspv_calls < 1 or not checks["power_one_way_flip"]:
        bad.append("the adaptive solves did not route SpMSpV then SpMV one way")
    if not power.modeled_work < power.spmv_work_equiv:
        bad.append("power iteration touched no less work than SpMV")
    if cg_rel > 1e-5:
        bad.append("CG relative residual above 1e-5")
    if not (cli_json["spmspv_calls"] > 0 and cli_json["spmv_calls"] > 0):
        bad.append("the CLI did not use both paths")
    if launches["spmspv"] != want_spmspv or launches["csr"] != want_spmv:
        bad.append("launches differ from the solves' matvecs")
    if session.stats.plans_computed > 3 or session.stats.plans_computed < 1:
        bad.append("more than one plan per unique matrix")  # P of web, web, spd(rim)
    if any(np.isnan(r.residual) for r in results):
        bad.append("a NaN residual")
    if bad:
        raise AssertionError(f"solve phase: {bad}: {checks}")
    payload["breakdown"] = iteration_breakdown(session, web, power, AdaptiveSpmvPolicy())
    return payload, launches


# ---------------------------------------------------------------------- lm
class CaptureHandle:
    """An engine handle that records the token vectors one decode step feeds
    the named FFN matmuls, and otherwise hands every call to the engine."""

    def __init__(self, handle, names):
        self.handle, self.names, self.seen = handle, names, {}

    def matmul(self, name, x, w):
        if name in self.names:
            self.seen[name] = x.detach().reshape(-1, x.shape[-1]).float().clone()
        return self.handle.matmul(name, x, w)


def lm_requests(cfg, n: int) -> list:
    """``launch.serve.serve_lm``'s synthetic traffic: prompts of 4-16 tokens
    from a numpy generator seeded with the run's seed."""
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, max_new_tokens=LM_NEW_TOKENS, slo="latency-critical",
                    prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 17))).tolist())
            for i in range(n)]


def lm_decode_check(pruned, cfg, engine, prompt_len: int = 8) -> tuple[dict, dict]:
    """One decode step of a batch of ``LM_SLOTS`` with the engine against the
    same step without it, on the same pruned params: in float32 compute
    (scaled logits error <= 1e-4, equal argmax) and in the config's bf16
    (<= 3e-2). Returns (checks, the bf16 step's token vectors at FFN_CHECK)."""
    rng = np.random.default_rng(SEED + 31)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_SLOTS, prompt_len)),
                             dtype=torch.int32, device=DEVICE)
    out, seen = {}, {}
    for compute, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        c = cfg.replace(compute_dtype=compute)
        logits, cache, _ = prefill(pruned, c, init_cache(c, LM_SLOTS, LM_MAX_LEN, DEVICE),
                                   tokens=tokens)
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((LM_SLOTS, 1), prompt_len, dtype=torch.int32, device=DEVICE)
        dense, _ = decode_step(pruned, c, cache, nxt, pos)
        handle = CaptureHandle(engine.bind("latency"), FFN_CHECK)
        sparse, _ = decode_step(pruned, c, cache, nxt, pos, unroll_layers=True, engine=handle)
        d, s = dense.cpu().numpy(), sparse.cpu().numpy()
        row = {"err": scaled_err(s, d), "tol": tol,
               "argmax_equal": bool((d.argmax(-1) == s.argmax(-1)).all()),
               "max_abs_logit": float(np.abs(d).max()), "shape": list(s.shape)}
        out[compute] = row
        if not (np.isfinite(s).all() and s.shape == (LM_SLOTS, 1, cfg.vocab_size)
                and row["err"] <= tol and (compute != "float32" or row["argmax_equal"])):
            raise AssertionError(f"sparse decode differs from dense in {compute}: {row}")
        if compute == cfg.compute_dtype:
            seen = handle.seen
    return out, seen


def check_b1_served(engine, seen: dict, names) -> list[tuple[dict, tuple]]:
    """Hold the engine's planned B1 kernels, at the schedules the decode path
    serves them with, against their plain version and a float64 host
    product on the decode tick's token vectors, for each of ``names``;
    time each beside its bound, plain version and library call.
    Comparison launches only. Returns each row with (kernel call, plain
    call, planned kernel, x, y) of its last token vector."""
    rows = []
    for n in names:
        kernel = engine.plan(n, "latency")[1]
        if type(kernel.mat).__name__ != "CSR" or kernel.schedule.accum_dtype != "float32":
            raise AssertionError(f"{n} is not served by B1 in float32: {kernel.schedule}")
        A = engine.layer(n).weight_t
        X = seen[n]  # (tokens, d_in)
        ref64 = A.astype(np.float64) @ X.cpu().numpy().astype(np.float64).T
        row = {"matrix": n, "shape": list(A.shape), "nnz": int((A != 0).sum()),
               "schedule": sched_tag(kernel.schedule), "x": "the decode tick's token vectors",
               "err_vs_plain": 0.0, "err_vs_host": 0.0}
        for i in range(X.shape[0]):
            x = X[i].contiguous()
            kern, plain, ins, out_elems, flops, _ = kernel_calls("csr", kernel.mat, x,
                                                                 kernel.schedule)
            yk = kern().cpu().numpy()
            row["err_vs_plain"] = max(row["err_vs_plain"], scaled_err(yk, plain().cpu().numpy()))
            row["err_vs_host"] = max(row["err_vs_host"], scaled_err(yk, ref64[:, i]))
        if max(row["err_vs_plain"], row["err_vs_host"]) > 1e-4:
            raise AssertionError(f"B1 disagrees at the FFN shape: {row}")
        y_k = kern()
        if not torch.equal(y_k, kern()):
            raise AssertionError(f"B1 at {n}: two launches differ")
        bound_ms, bound_by, nbytes = bound(ins, out_elems, flops)
        row.update(bit_identical=True, ms=timed(kern), plain_ms=timed(plain, reps=5),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   launch=b1_design(kernel.mat, kernel.schedule))
        library_call("csr", A, kernel.mat, x, ref64[:, -1], row)
        rows.append((row, (kern, plain, kernel, x, y_k)))
    return rows


def check_b1_ffn(engine, seen: dict) -> list[dict]:
    """``check_b1_served`` at the LM's FFN shapes, each row beside the
    sweep of CTA shapes."""
    rows = []
    for row, (kern, plain, kernel, x, y_k) in check_b1_served(engine, seen, FFN_CHECK):
        row["launch"]["by_shape"] = b1_sweep(kernel.mat, x, kernel.schedule, plain(), 1e-4)
        rows.append(row)
    return rows


def lm_breakdown(pruned, cfg, engine, names) -> dict:
    """Host-clock split of one decode tick of ``LM_SLOTS`` tokens: the whole
    sparse step against the dense one, the SpMVs alone (every planned kernel
    on ``LM_SLOTS`` vectors), the logits, and one prompt's prefill; beside
    them the device time of one B1 SpMV per FFN shape (CUDA events). Plans
    are the engine's (all hits); these launches are timing, not the main
    path."""
    rng = np.random.default_rng(SEED + 41)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 16)),
                             dtype=torch.int32, device=DEVICE)
    _, cache, _ = prefill(pruned, cfg, init_cache(cfg, LM_SLOTS, LM_MAX_LEN, DEVICE),
                          tokens=tokens)
    nxt = tokens[:, -1:]
    pos = torch.full((LM_SLOTS, 1), 16, dtype=torch.int32, device=DEVICE)
    handle = engine.bind("latency")
    kernels = [(engine.plan(n, "latency")[1], engine.layer(n).d_in) for n in names]
    xs = {d: [torch.randn(d, device=DEVICE) for _ in range(LM_SLOTS)]
          for d in {d for _, d in kernels}}
    h = torch.randn((LM_SLOTS, 1, cfg.d_model), device=DEVICE).to(torch.bfloat16)
    one_prompt = tokens[:1]
    device_ms = {}
    for n in FFN_CHECK + ("g0x0.mlp.w_gate",):
        kern = engine.plan(n, "latency")[1]
        x = xs[engine.layer(n).d_in][0]
        device_ms[n.split(".")[-1]] = timed(lambda: kern(x))
    # one layer's parts, each run once per layer (layer 0's params and cache)
    p0 = tree_map(lambda a: a[0], pruned["groups"][0])
    c0 = tree_map(lambda a: a[0], cache["groups"][0])
    L = cfg.n_layers
    sparse_step = lambda: decode_step(pruned, cfg, cache, nxt, pos,  # noqa: E731
                                      unroll_layers=True, engine=handle)
    return {
        "sparse_tick_ms": host_ms(sparse_step, reps=10),
        "dense_tick_ms": host_ms(lambda: decode_step(pruned, cfg, cache, nxt, pos), reps=10),
        "spmvs_ms": host_ms(lambda: [k(x) for k, d in kernels for x in xs[d]], reps=10),
        "attention_all_layers_ms": host_ms(lambda: [attention(
            p0["attn"], h, cfg, positions=pos, cache=c0) for _ in range(L)], reps=10),
        "dense_ffn_all_layers_ms": host_ms(lambda: [mlp(p0["mlp"], h, cfg)
                                                    for _ in range(L)], reps=10),
        "cache_restack_ms": host_ms(lambda: tree_map(lambda *a: torch.stack(a),
                                                     *([c0] * L)), reps=10),
        "logits_ms": host_ms(lambda: _logits(pruned, cfg, h), reps=10),
        "prefill_16_tokens_ms": host_ms(lambda: prefill(
            pruned, cfg, init_cache(cfg, 1, LM_MAX_LEN, DEVICE), tokens=one_prompt), reps=5),
        "b1_device_ms": device_ms,
        "spmvs_per_tick": len(kernels) * LM_SLOTS,
        "profile": profile_tick(sparse_step),
    }


def profile_tick(step) -> dict:
    """One sparse tick under ``torch.profiler``: the device's busy time (sum
    of kernel times) against the tick's wall time, and the kernels that
    take most of it. Where the profiler records no device activity the
    share is reported as not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms if kernels else None,
            "busy_share": busy_ms / wall_ms if kernels else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


def run_lm_phase(cfg) -> tuple[dict, dict, dict]:
    """The sparse LM serving path at ``cfg``'s width through the public
    entry points: params on the card from a seeded generator, the CLI's
    tuner, FFNs pruned into a ``SparseInferenceEngine``, every matrix
    planned; (a) sparse vs dense decode; (b) ``BatchedServer`` on
    ``LM_REQUESTS`` requests, B1 launches counted; (c) the CLI's LM mode
    in-process at the reduced config. Returns (payload, launches of (b) and
    (c), the spmm phase's FFN inputs)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    times = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(model_specs(cfg), gen, cfg.param_dtype, device=DEVICE)
    torch.cuda.synchronize()
    times["init_params_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuner = launch_serve.build_tuner(scale=0.0008, names=MATRIX_NAMES[:4], n_extra=0,
                                     fit_overhead=False, device=DEVICE)
    times["tuner_s"] = time.perf_counter() - t0
    session = AutoSpmvSession(tuner)
    engine = SparseInferenceEngine(session)
    t0 = time.perf_counter()
    pruned = prune_model_ffns(params, cfg, engine, density=LM_DENSITY)
    torch.cuda.synchronize()
    times["prune_s"] = time.perf_counter() - t0
    del params
    names = [n for n in engine._by_name if engine.layer(n).spmv_eligible]
    t0 = time.perf_counter()
    n_planned = engine.plan_all("latency")
    torch.cuda.synchronize()
    times["plan_all_s"] = time.perf_counter() - t0
    want_plans = 3 * cfg.n_layers
    if not (engine.stats.registered == engine.stats.spmv_layers == n_planned == want_plans):
        raise AssertionError(f"expected {want_plans} SpMV-eligible FFN matrices: {engine.stats}")

    t0 = time.perf_counter()
    checks, seen = lm_decode_check(pruned, cfg, engine)
    checks["b1_ffn"] = check_b1_ffn(engine, seen)
    times["check_s"] = time.perf_counter() - t0
    # the engine's own per-token SpMVs (its planned B1 kernels) on the
    # captured tick: the spmm phase's yardstick
    tick = {}
    for n in FFN_CHECK:
        _, kernel = engine.plan(n, "latency")
        x = seen[n]
        tick[n] = {"A": engine.layer(n).weight_t, "X": x.t().contiguous(),
                   "Y": torch.stack([kernel(x[i]) for i in range(x.shape[0])], dim=1)}

    # (b) serve: the counted main path
    server = BatchedServer(pruned, cfg, ServeConfig(batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                                                    max_new_tokens=LM_NEW_TOKENS), engine=engine)
    reqs = lm_requests(cfg, LM_REQUESTS)
    first_token_s, admit = {}, server._admit
    t_run = time.perf_counter()

    def timed_admit(req, slot):  # the first token comes out of the prefill
        admit(req, slot)
        torch.cuda.synchronize()
        first_token_s[req.rid] = time.perf_counter() - t_run

    server._admit = timed_admit
    reset_launches()
    t_run = time.perf_counter()
    server.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_run
    launches = read_launches()
    summary = server.summary()
    n_tokens = sum(len(r.generated) for r in reqs)
    per_tick = LM_SLOTS * want_plans
    serve = {"wall_s": serve_s, "requests": len(reqs), "ticks": server.ticks,
             "tokens": n_tokens, "tokens_per_s": n_tokens / serve_s,
             "first_token_s": first_token_s,
             "tick_ms": {k: 1e3 * v for k, v in summary["tick_latency"]["latency"].items()
                         if k.startswith("p") or k == "mean"},
             "prompt_lens": [len(r.prompt) for r in reqs],
             "generated": [r.generated for r in reqs],
             "b1_launches": launches["csr"],
             "b1_launches_per_tick": launches["csr"] / max(server.ticks, 1),
             "engine": engine.summary(), "session": session.stats.as_dict(),
             "energy": summary.get("energy")}
    bad = []
    if not all(len(r.generated) == LM_NEW_TOKENS and r.done for r in reqs):
        bad.append("a request did not get its tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        bad.append("a token outside the vocabulary")
    if summary["requests"] != LM_REQUESTS:
        bad.append("requests served")
    if launches["csr"] != per_tick * server.ticks:
        bad.append(f"B1 launches {launches['csr']} != {per_tick} x {server.ticks} ticks")
    if launches["spmm"] != 0 or sum(launches.values()) != launches["csr"]:
        bad.append("a kernel other than B1 ran in the decode path")
    if engine.summary()["objectives"]["latency"]["plans"] != want_plans:
        bad.append("plans per objective")
    if session.stats.requests != want_plans:
        bad.append("serve_optimize ran more than once per matrix")
    if bad:
        raise AssertionError(f"lm serve: {bad}: {serve}")

    # (c) the CLI's LM mode, in-process, reduced config, on the card
    reset_launches()
    t0 = time.perf_counter()
    cli_done = launch_serve.main(["--arch", LM_ARCH, "--lm-sparse", "--requests", "4",
                                  "--slots", "2", "--max-new-tokens", "4", "--max-len", "64"])
    torch.cuda.synchronize()
    cli_launches = read_launches()
    cli = {"wall_s": time.perf_counter() - t0, "requests": len(cli_done),
           "generated": [r.generated for r in cli_done], "b1_launches": cli_launches["csr"]}
    reduced = get_config(LM_ARCH, reduced_config=True)
    if not (len(cli_done) == 4 and all(len(r.generated) == 4 for r in cli_done)
            and cli_launches["csr"] > 0 and cli_launches["csr"] % (3 * reduced.n_layers * 2) == 0):
        raise AssertionError(f"lm CLI: {cli}")
    for k in launches:
        launches[k] += cli_launches[k]

    breakdown = lm_breakdown(pruned, cfg, engine, names)
    payload = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                          "compute": cfg.compute_dtype, "params": cfg.param_dtype},
               "density": LM_DENSITY, "times": times, "checks": checks, "serve": serve,
               "cli": cli, "breakdown": breakdown,
               "served_schedules": sorted({str(p.schedule) for p in engine.plans_for("latency")}),
               "fp32_recompiles": engine.stats.fp32_recompiles,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return payload, launches, tick


# --------------------------------------------------------------------- zoo
def zoo_tasks(ds) -> dict:
    """The two learning tasks of the paper's §5.4 on the dataset, each split
    for a held-out score: features -> the latency-best format (what
    run-time mode's classifier learns; one row per matrix, 75/25) and
    (features, config) -> log latency (what the regressors learn;
    ``ZOO_REG_SPLIT`` records to fit and to score, drawn without
    replacement)."""
    mats = ds.matrices
    X = np.stack([ds.for_matrix(m)[0].features.log_vector() for m in mats])
    y = np.array([ds.best_record(m, "latency").config.fmt for m in mats])
    Xtr, Xte, ytr, yte = train_test_split(X, y, 0.25, seed=SEED)
    recs = ds.feasible()
    sel = np.random.default_rng(SEED).choice(len(recs), sum(ZOO_REG_SPLIT), replace=False)
    names = format_names()
    Xr = np.stack([np.concatenate([recs[i].features.log_vector(),
                                   _config_row(recs[i].config, names)]) for i in sel])
    yr = np.log(np.maximum([recs[i].latency for i in sel], 1e-30))
    k = ZOO_REG_SPLIT[0]
    return {"clf": (Xtr, Xte, ytr, yte), "reg": (Xr[:k], Xr[k:], yr[:k], yr[k:]),
            "sizes": {"matrices": len(mats), "records": len(ds), "clf_train": len(ytr),
                      "clf_test": len(yte), "reg_train": k, "reg_test": len(yr) - k,
                      "formats": sorted(set(y.tolist()))}}


def tune_and_score(entry, task, metric) -> dict:
    """``core.hpo.tune_model`` (TPE, ``ZOO_FOLDS``-fold) on the task's training part,
    then the tuned model fit there and scored on the held-out part; the MLP
    trains on the card."""
    Xtr, Xte, ytr, yte = task
    t0 = time.perf_counter()
    res = tune_model(entry, Xtr, ytr, metric, n_trials=ZOO_TRIALS, cv=ZOO_FOLDS, seed=SEED,
                     device=DEVICE)
    tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = build_estimator(entry, DEVICE, **res.best_params).fit(Xtr, ytr)
    fit_s = time.perf_counter() - t0
    return {"best_params": res.best_params, "cv_score": res.best_value,
            "held_out": float(metric(yte, model.predict(Xte))), "tune_s": tune_s,
            "fit_s": fit_s, "trials": res.n_trials}


def serve_with(session, pool, fps, xs, ref64s) -> tuple[dict, dict, dict]:
    """Both Auto-SpMV modes over the pool through ``session``: compile-time
    mode (latency) and run-time mode for the four objectives per matrix,
    every converted kernel run once on the matrix's x and held against the
    float64 host product. Returns (rows, picks, kernel calls per format)."""
    rows, picks, calls = [], {}, {f: 0 for f in BLOCK_FORMATS}
    for n, dense in pool.items():
        ct = session.compile_time_optimize(dense, "latency", fingerprint=fps[n])
        picks[f"{n}/compile"] = sched_tag(ct.schedule)
        runs = [("compile", "latency", ct.kernel)]
        for obj in OBJECTIVES:
            try:
                rt = session.run_time_optimize(dense, obj, n_iterations=10_000,
                                               fingerprint=fps[n])
            except InfeasibleConfig as exc:  # the picked format's storage guard refused
                picks[f"{n}/{obj}"] = "infeasible"
                rows.append({"matrix": n, "mode": "run", "objective": obj,
                             "infeasible": str(exc)[:120]})
                continue
            picks[f"{n}/{obj}"] = rt.best_format
            if rt.kernel is not None:
                runs.append(("run", obj, rt.kernel))
        for mode, obj, kernel in runs:
            fmt = type(kernel.mat).__name__.lower()
            y = kernel(torch.as_tensor(xs[n], device=DEVICE)).cpu().numpy()
            calls[fmt] += 1
            err, tol = scaled_err(y, ref64s[n]), tol_of(kernel.schedule)
            row = {"matrix": n, "mode": mode, "objective": obj, "format": fmt,
                   "schedule": sched_tag(kernel.schedule), "err": err, "tol": tol}
            rows.append(row)
            if not (y.shape == ref64s[n].shape and np.isfinite(y).all() and err <= tol):
                raise AssertionError(f"zoo: served y wrong: {row}")
    return rows, picks, calls


def run_zoo_phase(tuner, pool, fps) -> tuple[dict, dict]:
    """Every classifier and regressor family of the zoo on the card: the
    port's dataset (``collect_dataset``, labelled by the H100_SXM cost
    model); per family ``tune_model`` and a held-out score on its task; an
    ``AutoSpmvPredictor`` of each pair (classifier, regressor) fit with the
    Table 4 defaults (the MLPs train on the card) and served in both modes
    over the pool through an ``AutoSpmvSession``: launches per format, each
    ``y`` against float64, and the picks' agreement with the
    ``decision_tree`` predictor's. Returns (payload, launches)."""
    t0 = time.perf_counter()
    ds = collect_dataset(**ZOO_DATA)
    tasks = zoo_tasks(ds)
    data_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 71)
    xs = {n: rng.normal(size=d.shape[1]).astype(np.float32) for n, d in pool.items()}
    ref64s = {n: host_product(d, xs[n]) for n, d in pool.items()}
    families, launches, all_picks = [], {k: 0 for k in WRAPPERS}, {}
    for clf, reg in ZOO_PAIRS:
        row = {"classifier": clf, "regressor": reg,
               "classifier_tuned": tune_and_score(CLASSIFIER_ZOO[clf], tasks["clf"],
                                                  accuracy_score),
               "regressor_tuned": tune_and_score(REGRESSOR_ZOO[reg], tasks["reg"], r2_score)}
        t0 = time.perf_counter()
        pred = AutoSpmvPredictor(PredictorConfig(
            model_name=clf, regressor_name=reg, max_regressor_samples=ZOO_REG_SAMPLES,
            device=DEVICE)).fit(ds)
        torch.cuda.synchronize()
        row["predictor_fit_s"] = time.perf_counter() - t0
        session = AutoSpmvSession(AutoSpMV(pred, tuner.overhead, device=DEVICE))
        reset_launches()
        t0 = time.perf_counter()
        served, picks, calls = serve_with(session, pool, fps, xs, ref64s)
        torch.cuda.synchronize()
        row["serve_s"] = time.perf_counter() - t0
        got = read_launches()
        check_launches(f"zoo({clf}, {reg})", got, {**{k: 0 for k in WRAPPERS}, **calls})
        row.update(launches={f: got[f] for f in BLOCK_FORMATS if got[f]}, served=served,
                   picks=picks, session=session.stats.as_dict())
        all_picks[clf] = picks
        for k in launches:
            launches[k] += got[k]
        families.append(row)
    base = all_picks["decision_tree"]
    for row in families:
        p = all_picks[row["classifier"]]
        row["agreement_with_decision_tree"] = {
            "compile": float(np.mean([p[k] == base[k] for k in p if k.endswith("/compile")])),
            "run": float(np.mean([p[k] == base[k] for k in p if not k.endswith("/compile")]))}
    return {"data": {**ZOO_DATA, "names": list(ZOO_DATA["names"]), "seconds": data_s,
                     "hw": ds.meta["hw"], **tasks["sizes"]},
            "families": families}, launches


# --------------------------------------------------------------------- moe
def moe_config():
    """``deepseek-moe-16b`` at its published width with the depth cut to
    ``MOE_LAYERS``: layer 0 attention + the dense FFN, layer 1 MoE, served
    with the dense dispatch (the engine path's, as the serve CLI forces)."""
    return get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS, dispatch_format="dense")


def moe_logits_check(pruned, cfg, engine) -> tuple[dict, dict]:
    """One decode step of ``MOE_CHECK_SLOTS`` tokens with the engine (every
    expert slice a planned B1 SpMV, weighted by the gate) against the same
    step through the dense dispatch, on the same pruned weights: float32
    compute (TF32 off; scaled logits error <= 1e-4, same argmax) and the
    config's bf16 (<= 3e-2). Returns (checks, the bf16 step's token vectors
    at MOE_B1_CHECK)."""
    rng = np.random.default_rng(SEED + 51)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (MOE_CHECK_SLOTS, 8)),
                             dtype=torch.int32, device=DEVICE)
    out, seen = {}, {}
    for compute, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        c = cfg.replace(compute_dtype=compute)
        logits, cache, aux = prefill(pruned, c, init_cache(c, MOE_CHECK_SLOTS, 64, DEVICE),
                                     tokens=tokens)
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((MOE_CHECK_SLOTS, 1), 8, dtype=torch.int32, device=DEVICE)
        dense, _ = decode_step(pruned, c, cache, nxt, pos)
        handle = CaptureHandle(engine.bind("latency"), MOE_B1_CHECK)
        before = engine.stats.spmv_matmuls
        sparse, _ = decode_step(pruned, c, cache, nxt, pos, unroll_layers=True, engine=handle)
        d, sp = dense.cpu().numpy(), sparse.cpu().numpy()
        row = {"err": scaled_err(sp, d), "tol": tol,
               "argmax_equal": bool((d.argmax(-1) == sp.argmax(-1)).all()),
               "max_abs_logit": float(np.abs(d).max()), "shape": list(sp.shape),
               "engine_matmuls": engine.stats.spmv_matmuls - before,
               "prefill_tokens_per_expert": aux["tokens_per_expert"].cpu().tolist(),
               "prefill_moe_aux": float(aux["moe_aux"])}
        out[compute] = row
        if not (np.isfinite(sp).all() and sp.shape == (MOE_CHECK_SLOTS, 1, cfg.vocab_size)
                and row["err"] <= tol and (compute != "float32" or row["argmax_equal"])
                and row["engine_matmuls"] == engine.stats.spmv_layers):
            raise AssertionError(f"MoE sparse decode differs from dense in {compute}: {row}")
        if compute == cfg.compute_dtype:
            seen = handle.seen
            # the device's busy share of one sparse decode step (timing
            # launches, not the counted main path)
            row["profile"] = profile_tick(lambda: decode_step(
                pruned, c, cache, nxt, pos, unroll_layers=True, engine=engine.bind("latency")))
    return out, seen


def moe_dispatch_runs(pruned, cfg) -> dict:
    """One prefill of a batch of prompts through each dispatch format (no
    engine): finite logits, the routing histogram, the distance from the
    dense dispatch (``ell`` / ``sell`` drop capacity overflow), and
    ``select_dispatch_format``'s pick on the histogram."""
    rng = np.random.default_rng(SEED + 61)
    B, T = MOE_DISPATCH_BATCH
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32,
                             device=DEVICE)
    runs, dense_logits = {}, None
    for d in ("dense", "ell", "sell"):
        c = cfg.replace(dispatch_format=d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, aux = prefill(pruned, c, init_cache(c, B, T, DEVICE), tokens=tokens)
        torch.cuda.synchronize()
        tpe = aux["tokens_per_expert"].cpu().numpy()
        lg = logits.float().cpu().numpy()
        if dense_logits is None:
            dense_logits = lg
        runs[d] = {"host_ms": 1e3 * (time.perf_counter() - t0),
                   "finite": bool(np.isfinite(lg).all()), "shape": list(lg.shape),
                   "err_vs_dense": scaled_err(lg, dense_logits),
                   "argmax_equal_dense": float((lg.argmax(-1) == dense_logits.argmax(-1)).mean()),
                   "moe_aux": float(aux["moe_aux"])}
        if not (runs[d]["finite"] and lg.shape == (B, T, cfg.vocab_size)
                and int(tpe.sum()) == B * T * cfg.top_k):
            raise AssertionError(f"MoE prefill through {d} dispatch: {runs[d]}")
    feats = features_from_assignment_histogram(tpe.astype(np.int64))
    return {"batch": [B, T], "capacity": moe_capacity(T, cfg), "runs": runs,
            "tokens_per_expert": tpe.tolist(),
            "histogram": {"avg": feats.avg_nnz, "std": feats.std_nnz, "max": float(tpe.max()),
                          "ell_ratio": feats.ell_ratio},
            "select_dispatch_format": select_dispatch_format(tpe)}


def serve_timed(pruned, cfg, engine, slots: int, n_requests: int, new_tokens: int,
                max_len: int, seed: int, what: str) -> tuple[dict, dict]:
    """``n_requests`` requests of 4-16 prompt tokens (numpy, ``seed``) through
    ``BatchedServer`` over ``slots`` slots, ``new_tokens`` each, every tick
    timed on the host clock. With ``engine``, B1 must be the only kernel,
    launched once per slot per registered matrix per tick: the engine's SpMV
    count; without one (dense serving) no kernel may launch."""
    server = BatchedServer(pruned, cfg, ServeConfig(batch_slots=slots, max_len=max_len,
                                                    max_new_tokens=new_tokens),
                           engine=engine)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, max_new_tokens=new_tokens, slo="latency-critical",
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(4, 17))).tolist())
            for i in range(n_requests)]
    ticks, tick = [], server._decode_tick

    def timed_tick():
        t0 = time.perf_counter()
        tick()  # ends with the tick's tokens on the host
        ticks.append(time.perf_counter() - t0)

    server._decode_tick = timed_tick
    matmuls = engine.stats.spmv_matmuls if engine is not None else 0
    reset_launches()
    t0 = time.perf_counter()
    server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_tokens = sum(len(r.generated) for r in reqs)
    # one SpMV per slot per engine call
    spmvs = (engine.stats.spmv_matmuls - matmuls) * slots if engine is not None else 0
    layers = engine.stats.spmv_layers if engine is not None else 0
    tk = 1e3 * np.asarray(ticks)
    row = {"slots": slots, "requests": len(reqs), "ticks": server.ticks, "wall_s": wall,
           "tokens": n_tokens, "tokens_per_s": n_tokens / wall,
           "tick_ms": {"p50": float(np.median(tk)), "p90": float(np.percentile(tk, 90)),
                       "mean": float(tk.mean()), "max": float(tk.max()),
                       "p50_by_half": [float(np.median(h)) for h in np.array_split(tk, 2)]},
           "prompt_lens": [len(r.prompt) for r in reqs],
           "generated": [r.generated for r in reqs],
           "engine_spmvs": spmvs, "b1_launches": launches["csr"],
           "b1_launches_per_tick": launches["csr"] / max(server.ticks, 1)}
    bad = []
    if not all(len(r.generated) == new_tokens and r.done for r in reqs):
        bad.append("a request did not get its tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        bad.append("a token outside the vocabulary")
    if launches["csr"] != spmvs or spmvs != server.ticks * slots * layers:
        bad.append(f"B1 launches {launches['csr']} != the engine's {spmvs} SpMVs "
                   f"({server.ticks} ticks x {slots} slots x {layers})")
    if sum(launches.values()) != launches["csr"]:
        bad.append(f"a kernel other than B1 ran in the {what} decode path: {launches}")
    if bad:
        raise AssertionError(f"{what} serve: {bad}: {row}")
    return row, launches


def run_moe_phase() -> tuple[dict, dict]:
    """MoE LM serving of ``deepseek-moe-16b`` at its published width (depth
    cut to ``MOE_LAYERS``) through the public entry points: params on the
    card from a seeded generator (bf16, float32 router), the CLI's tuner,
    every FFN matrix and expert slice pruned to ``MOE_DENSITY`` into a
    ``SparseInferenceEngine`` and planned; sparse vs dense-dispatch logits;
    B1 at the expert, shared-expert and dense-FFN shapes against its plain
    version and float64; one prefill through each dispatch format;
    ``BatchedServer`` over each of ``MOE_SLOTS`` (the counted main path);
    the serve CLI in LM mode with a MoE config (reduced, as the CLI runs).
    Returns (payload, launches of the served runs and the CLI)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config()
    times = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(model_specs(cfg), gen, cfg.param_dtype, device=DEVICE)
    torch.cuda.synchronize()
    times["init_params_s"] = time.perf_counter() - t0
    expert_bytes = sum(params["groups"][0]["moe"][k].numel() * params["groups"][0]["moe"][k]
                       .element_size() for k in ("w_gate", "w_up", "w_down"))
    t0 = time.perf_counter()
    tuner = launch_serve.build_tuner(scale=0.0008, names=MATRIX_NAMES[:4], n_extra=0,
                                     fit_overhead=False, device=DEVICE)
    times["tuner_s"] = time.perf_counter() - t0
    session = AutoSpmvSession(tuner)
    engine = SparseInferenceEngine(session)
    t0 = time.perf_counter()
    pruned = prune_model_ffns(params, cfg, engine, density=MOE_DENSITY)
    torch.cuda.synchronize()
    times["prune_s"] = time.perf_counter() - t0
    del params
    t0 = time.perf_counter()
    n_planned = engine.plan_all("latency")
    torch.cuda.synchronize()
    times["plan_all_s"] = time.perf_counter() - t0
    per_moe = 3 * cfg.n_experts + 3 * (cfg.n_shared_experts > 0)
    want = 3 * len(cfg.first_blocks) + per_moe * cfg.n_groups
    if not (engine.stats.registered == engine.stats.spmv_layers == n_planned == want):
        raise AssertionError(f"expected {want} SpMV-eligible MoE matrices: {engine.stats}")
    entries = sum(int(np.prod(engine.layer(n).weight_t.shape)) for n in engine._by_name)

    t0 = time.perf_counter()
    checks, seen = moe_logits_check(pruned, cfg, engine)
    checks["b1"] = [row for row, _ in check_b1_served(engine, seen, MOE_B1_CHECK)]
    checks["dispatch"] = moe_dispatch_runs(pruned, cfg)
    times["check_s"] = time.perf_counter() - t0

    serve, launches = [], {k: 0 for k in WRAPPERS}
    for slots in MOE_SLOTS:
        row, got = serve_timed(pruned, cfg, engine, slots, MOE_REQUESTS, MOE_NEW_TOKENS,
                               MOE_MAX_LEN, SEED + slots, "MoE")
        serve.append(row)
        for k in launches:
            launches[k] += got[k]

    # the CLI's LM mode with a MoE config, in-process, reduced, on the card
    reset_launches()
    t0 = time.perf_counter()
    cli_done = launch_serve.main(["--arch", MOE_ARCH, "--lm-sparse", "--requests", "2",
                                  "--slots", "2", "--max-new-tokens", "3", "--max-len", "64"])
    torch.cuda.synchronize()
    cli_launches = read_launches()
    reduced = get_config(MOE_ARCH, reduced_config=True)
    per_token = 3 * len(reduced.first_blocks) + (3 * reduced.n_experts + 3) * reduced.n_groups
    cli = {"wall_s": time.perf_counter() - t0, "requests": len(cli_done),
           "generated": [r.generated for r in cli_done], "b1_launches": cli_launches["csr"],
           "matrices": per_token}
    if not (len(cli_done) == 2 and all(len(r.generated) == 3 for r in cli_done)
            and cli_launches["csr"] > 0 and cli_launches["csr"] % (per_token * 2) == 0):
        raise AssertionError(f"moe CLI: {cli}")
    for k in launches:
        launches[k] += cli_launches[k]
    payload = {
        "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                   "blocks": list(cfg.first_blocks) + list(cfg.pattern) * cfg.n_groups,
                   "d_model": cfg.d_model, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                   "vocab": cfg.vocab_size, "experts": cfg.n_experts, "top_k": cfg.top_k,
                   "shared": cfg.n_shared_experts, "d_ff_expert": cfg.d_ff_expert,
                   "params": cfg.param_dtype, "compute": cfg.compute_dtype,
                   "dispatch": cfg.dispatch_format},
        "reduced": [f"depth: {get_config(MOE_ARCH).n_layers} -> {cfg.n_layers} layers "
                    "(layer 0 attention + dense FFN, layer 1 MoE); widths as published"],
        "density": MOE_DENSITY, "matrices": want, "pruned_entries": entries,
        "expert_bytes_on_device": expert_bytes, "times": times, "checks": checks,
        "serve": serve, "cli": cli, "engine": engine.summary(),
        "session": session.stats.as_dict(),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return payload, launches


# --------------------------------------------------------------- recurrent
def rec_configs():
    """``recurrentgemma-2b`` and ``xlstm-1.3b`` at their published widths
    with the depth cut to ``RG_LAYERS`` (two groups of (rec, rec, local) and
    the (rec, rec) tail) and ``XL_LAYERS`` (two groups of 7 mLSTM + 1
    sLSTM)."""
    return (get_config(RG_ARCH).replace(n_layers=RG_LAYERS),
            get_config(XL_ARCH).replace(n_layers=XL_LAYERS))


def ffn_leaf(params, name: str) -> torch.Tensor:
    """The pruned FFN weight leaf that ``{block}.mlp.{w}`` names
    (``g{p}x{g}``, ``tail{i}``, ``head{i}``)."""
    block, _, w = name.split(".")
    if block.startswith("g"):
        p, g = (int(v) for v in block[1:].split("x"))
        return params["groups"][p]["mlp"][w][g]
    part = "tail" if block.startswith("tail") else "head"
    return params[part][int(block[len(part):])]["mlp"][w]


class PerturbedHandle:
    """The dense FFN contractions (float32 sums of the compute-dtype
    operands) with every output scaled by (1 + eps z) before its rounding
    to the compute dtype, z ~ N(0, 1) from a seeded generator: how far a
    relative change of eps in the FFN outputs moves the logits (the model's
    own sensitivity)."""

    def __init__(self, eps: float, seed: int):
        self.eps = eps
        self.gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def matmul(self, name, x, w):
        y = torch.einsum("...d,df->...f", x.float(), w.float())
        z = torch.randn(y.shape, generator=self.gen, device=y.device)
        return (y * (1.0 + self.eps * z)).to(x.dtype)


def rg_logits_check(pruned, cfg, engine) -> tuple[dict, dict]:
    """One decode step of ``RG_CHECK_SLOTS`` tokens with the engine (every
    FFN matrix a planned B1 SpMV per token) against the same step without
    it on the same pruned weights. float32 compute (TF32 off): scaled
    logits error <= 1e-4 and the same argmax. bf16 (the config's): every
    one of the 24 FFN products of the step, the engine's route against the
    dense bf16 contraction on the same token vectors, <= 3e-2; and the
    logits against the dense path's <= 3e-2 where the model is conditioned
    for it: the distance a relative change of the FFN outputs alone, as
    large as the engine's own measured distance from the dense contraction
    (``ffn_err_max``), makes to the dense logits (``sensitivity``, the worst
    of ``RG_PROBES`` draws) must itself be within the bound, else the logits
    bound nothing and are reported (at this model's random initialisation a
    one-ulp bf16 change can move its near one-hot local attention: on an
    H100 two fp32 summation orders of B1, each within 1e-4 of float64, gave
    logits 5.1e-3 and 0.234 from the dense path's). With the device's busy
    share of one engine step. Returns (checks, the bf16 step's token vectors at
    RG_B1_CHECK)."""
    rng = np.random.default_rng(SEED + 71)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (RG_CHECK_SLOTS, 8)),
                             dtype=torch.int32, device=DEVICE)
    names = tuple(engine._by_name)
    out, seen = {}, {}
    for compute, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        c = cfg.replace(compute_dtype=compute)
        logits, cache, _ = prefill(pruned, c, init_cache(c, RG_CHECK_SLOTS, RG_MAX_LEN, DEVICE),
                                   tokens=tokens)
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((RG_CHECK_SLOTS, 1), 8, dtype=torch.int32, device=DEVICE)
        dense, _ = decode_step(pruned, c, cache, nxt, pos)
        handle = CaptureHandle(engine.bind("latency"), names)
        before = engine.stats.spmv_matmuls
        sparse, _ = decode_step(pruned, c, cache, nxt, pos, unroll_layers=True, engine=handle)
        matmuls = engine.stats.spmv_matmuls - before
        d, sp = dense.cpu().numpy(), sparse.cpu().numpy()
        row = {"err": scaled_err(sp, d), "tol": tol,
               "argmax_equal": bool((d.argmax(-1) == sp.argmax(-1)).all()),
               "max_abs_logit": float(np.abs(d).max()), "shape": list(sp.shape),
               "engine_matmuls": matmuls}
        ok = (np.isfinite(sp).all() and sp.shape == (RG_CHECK_SLOTS, 1, cfg.vocab_size)
              and matmuls == engine.stats.spmv_layers)
        if compute == "float32":
            ok = ok and row["err"] <= tol and row["argmax_equal"]
        else:
            cd = torch_dtype(compute)
            bound = engine.bind("latency")
            ffn = {}
            for n in names:
                x, w = handle.seen[n].to(cd), ffn_leaf(pruned, n).to(cd)
                ffn[n] = scaled_err(bound.matmul(n, x, w).float().cpu().numpy(),
                                    torch.einsum("td,df->tf", x, w).float().cpu().numpy())
            row["ffn_err_max"] = max(ffn.values())
            row["ffn_err_by_matrix"] = ffn
            eps, draws = row["ffn_err_max"], []
            for k in range(RG_PROBES):
                perturbed, _ = decode_step(pruned, c, cache, nxt, pos, unroll_layers=True,
                                           engine=PerturbedHandle(eps, SEED + 72 + k))
                draws.append(scaled_err(perturbed.cpu().numpy(), d))
            row["sensitivity"] = {"eps": eps, "err": max(draws), "draws": draws}
            row["logits_asserted"] = row["sensitivity"]["err"] <= tol
            ok = (ok and row["ffn_err_max"] <= tol
                  and (row["err"] <= tol or not row["logits_asserted"]))
        out[compute] = row
        if not ok:
            raise AssertionError(f"recurrentgemma sparse decode differs from dense in "
                                 f"{compute}: {row}")
        if compute == cfg.compute_dtype:
            seen = {n: handle.seen[n] for n in RG_B1_CHECK}
            # timing launches, not the counted main path
            row["profile"] = profile_tick(lambda: decode_step(
                pruned, c, cache, nxt, pos, unroll_layers=True, engine=engine.bind("latency")))
    return out, seen


def model_blocks(params, cache, cfg):
    """(name, kind, block params, block cache) in ``_run_blocks``' order."""
    for i, kind in enumerate(cfg.first_blocks):
        yield f"head{i}", kind, params["head"][i], cache["head"][i]
    for pi, kind in enumerate(cfg.pattern if cfg.n_groups else ()):
        for g in range(cfg.n_groups):
            yield (f"g{pi}x{g}", kind, tree_map(lambda a: a[g], params["groups"][pi]),
                   tree_map(lambda a: a[g], cache["groups"][pi]))
    for i, kind in enumerate(cfg.tail_blocks):
        yield f"tail{i}", kind, params["tail"][i], cache["tail"][i]


def teacher_forcing(params, cfg, T: int = 12) -> dict:
    """The reference's decode-consistency check at full width in float32
    compute. Per block: each block's prefill over T tokens and one decode
    step against the block over T + 1 at the same positions, on the input
    ``forward`` gives that block (allclose, rtol = atol = 5e-3, the
    reference test's). Whole model: prefill + decode against ``forward``,
    asserted where the model is conditioned for it: the distance a relative
    change of 1e-6 in the embeddings alone makes to ``forward``'s logits
    (``sensitivity``) must itself be within 5e-3, else the whole-model
    logits bound nothing about the two paths and are reported."""
    c = cfg.replace(compute_dtype="float32")
    rng = np.random.default_rng(SEED + 81)
    tokens = torch.as_tensor(rng.integers(0, c.vocab_size, (1, T + 1)), dtype=torch.int32,
                             device=DEVICE)
    pos = torch.arange(T + 1, dtype=torch.int32, device=DEVICE)[None]
    x = _embed(params, c, tokens)
    blocks, worst = {}, 0.0
    for name, kind, p, cache in model_blocks(params, init_cache(c, 1, RG_MAX_LEN, DEVICE), c):
        full, _, _ = apply_block(kind, p, x, c, positions=pos, cache=None)
        pre, cache, _ = apply_block(kind, p, x[:, :T], c, positions=pos[:, :T], cache=cache)
        step, _, _ = apply_block(kind, p, x[:, T:], c, positions=pos[:, T:], cache=cache)
        got = torch.cat([pre, step], dim=1).cpu().numpy()
        want = full.cpu().numpy()
        blocks[name] = {"kind": kind, "scaled_err": scaled_err(got, want),
                        "ok": bool(np.allclose(got, want, rtol=TEACHER_TOL, atol=TEACHER_TOL))}
        worst = max(worst, blocks[name]["scaled_err"])
        if not (np.isfinite(got).all() and blocks[name]["ok"]):
            raise AssertionError(f"{cfg.name}: block {name} prefill + decode != forward: "
                                 f"{blocks[name]}")
        x = full
    full, _ = forward(params, c, tokens=tokens)
    pre, cache, _ = prefill(params, c, init_cache(c, 1, RG_MAX_LEN, DEVICE), tokens=tokens[:, :T])
    step, _ = decode_step(params, c, cache, tokens[:, T:], pos[:, T:])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 82)
    emb = _embed(params, c, tokens)
    nudged, _ = forward(params, c, embeds=emb * (1.0 + 1e-6 * torch.randn(
        emb.shape, generator=gen, device=DEVICE)))
    full = full.cpu().numpy()
    model = {}
    for key, got, want in (("decode", step[:, 0].cpu().numpy(), full[:, T]),
                           ("prefill_last", pre[:, -1].cpu().numpy(), full[:, T - 1])):
        model[key] = {"max_abs_diff": float(np.abs(got - want).max()),
                      "scaled_err": scaled_err(got, want),
                      "within_5e-3": bool(np.allclose(got, want, rtol=TEACHER_TOL,
                                                      atol=TEACHER_TOL))}
    model["sensitivity"] = {"eps": 1e-6, "max_abs_diff": float(np.abs(
        nudged.cpu().numpy() - full).max()), "scaled_err": scaled_err(nudged.cpu().numpy(), full)}
    model["asserted"] = model["sensitivity"]["max_abs_diff"] <= TEACHER_TOL
    if model["asserted"] and not (model["decode"]["within_5e-3"]
                                  and model["prefill_last"]["within_5e-3"]):
        raise AssertionError(f"{cfg.name}: prefill + decode != forward: {model}")
    return {"T": T, "blocks_worst_scaled_err": worst, "blocks": blocks, "model": model}


def scan_checks(rg_cfg, xl_cfg) -> dict:
    """One RG-LRU and one mLSTM block at full width over ``SCAN_T`` steps in
    float32 compute: the parallel form (RG-LRU's doubling scan; mLSTM's
    chunkwise form, SCAN_T / 64 chunks) against the block stepped one token
    at a time through its decode path, and the recurrence alone against a
    float64 sequential loop (the reference test's ``_mlstm_sequential``;
    h = a h + b on the block's own gates). Scaled error <= SCAN_TOL."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 91)
    out = {}

    def stepped(block, p, x, cfg, cache):
        ys = []
        for t in range(x.shape[1]):
            y, cache = block(p, x[:, t:t + 1], cfg, cache=cache)
            ys.append(y)
        return torch.cat(ys, dim=1)

    c = rg_cfg.replace(compute_dtype="float32")
    p = init_params(rglru_specs(c), gen, "float32", device=DEVICE)
    x = 0.3 * torch.randn((1, SCAN_T, c.d_model), generator=gen, device=DEVICE)
    y_scan, _ = rglru(p, x, c)
    y_step = stepped(rglru, p, x, c, init_params(rglru_cache_spec(c, 1), None, "float32", DEVICE))
    a, b, _, _ = _rglru_in(p, x, c, None)
    h = linear_scan(a, b)
    h64, seq = torch.zeros_like(b[:, 0], dtype=torch.float64), []
    for t in range(SCAN_T):
        h64 = a[:, t].double() * h64 + b[:, t].double()
        seq.append(h64)
    out["rglru"] = {"width": c.rnn_dim, "T": SCAN_T,
                    "scan_vs_steps": scaled_err(y_scan.cpu().numpy(), y_step.cpu().numpy()),
                    "scan_vs_float64": scaled_err(h.cpu().numpy(),
                                                  torch.stack(seq, 1).cpu().numpy()),
                    "min_prod_a": float(torch.prod(a.double(), dim=1).min())}
    del p

    c = xl_cfg.replace(compute_dtype="float32")
    p = init_params(mlstm_specs(c), gen, "float32", device=DEVICE)
    x = torch.randn((1, SCAN_T, c.d_model), generator=gen, device=DEVICE)
    y_chunk, _ = mlstm_block(p, x, c)
    y_step = stepped(mlstm_block, p, x, c,
                     init_params(mlstm_cache_spec(c, 1), None, "float32", DEVICE))
    H, dh = c.n_heads, 2 * c.d_model // c.n_heads
    q, k, v = (torch.randn((1, SCAN_T, H, dh), generator=gen, device=DEVICE) for _ in range(3))
    i_g = 0.2 + 0.8 * torch.rand((1, SCAN_T, H), generator=gen, device=DEVICE)
    f_g = 0.8 + 0.199 * torch.rand((1, SCAN_T, H), generator=gen, device=DEVICE)
    got, _ = _mlstm_core(q, k, v, i_g, f_g, c.mlstm_chunk)
    q64, k64, v64, i64, f64 = (t.double() for t in (q, k, v, i_g, f_g))
    C = torch.zeros((1, H, dh, dh), dtype=torch.float64, device=DEVICE)
    n = torch.zeros((1, H, dh), dtype=torch.float64, device=DEVICE)
    seq = []
    for t in range(SCAN_T):
        ki = k64[:, t] * i64[:, t, :, None]
        C = f64[:, t, :, None, None] * C + torch.einsum("bhk,bhv->bhkv", ki, v64[:, t])
        n = f64[:, t, :, None] * n + ki
        qt = q64[:, t] * dh ** -0.5
        den = torch.clamp(torch.einsum("bhk,bhk->bh", qt, n).abs()[..., None], min=1.0)
        seq.append(torch.einsum("bhk,bhkv->bhv", qt, C) / den)
    out["mlstm"] = {"heads": H, "head_dim": dh, "T": SCAN_T, "chunks": -(-SCAN_T // c.mlstm_chunk),
                    "chunked_vs_steps": scaled_err(y_chunk.cpu().numpy(), y_step.cpu().numpy()),
                    "chunked_vs_float64": scaled_err(got.cpu().numpy(),
                                                     torch.stack(seq, 1).cpu().numpy())}
    for name, row in out.items():
        errs = [v for k, v in row.items() if k.endswith(("_steps", "_float64"))]
        if not all(np.isfinite(e) and e <= SCAN_TOL for e in errs):
            raise AssertionError(f"{name} at T = {SCAN_T} disagrees with its recurrence: {row}")
    out["tol"] = SCAN_TOL
    return out


def state_bytes(cfg, max_len: int) -> dict:
    """Bytes of one slot's serving cache, by leaf (group leaves hold every
    group's)."""
    cache = init_cache(cfg, 1, max_len, DEVICE)
    by_leaf: dict[str, int] = {}

    for part in ("head", "groups", "tail"):
        for i, c in enumerate(cache[part]):
            for key, t in c.items():
                by_leaf[f"{part}{i}.{key}"] = t.numel() * t.element_size()
    return {"per_slot": sum(by_leaf.values()), "by_leaf": by_leaf}


def run_recurrent_phase() -> tuple[dict, dict]:
    """The recurrent blocks at full width through the public entry points.
    (a) ``recurrentgemma-2b`` (depth ``RG_LAYERS``): params on the card from
    a seeded generator (fp32), the CLI's tuner, the 24 GeGLU matrices of the
    ``rec`` and ``local`` blocks pruned to ``RG_DENSITY`` into a
    ``SparseInferenceEngine`` and planned; sparse vs dense logits and the
    busy share of one engine step; B1 at ``w_up`` / ``w_down`` against its
    plain version and float64, timed beside its bound and the library;
    ``BatchedServer`` over each of ``RG_SLOTS`` (the counted main path: B1
    launches = ticks x slots x 24). (b) ``xlstm-1.3b`` (depth ``XL_LAYERS``),
    served dense over ``XL_SLOTS`` (no FFN for the engine: no kernel). (c)
    Teacher forcing for both, and the T = ``SCAN_T`` scan checks, in fp32
    compute. Then the serve CLI's LM mode for both archs (reduced, as the
    CLI runs). Returns (payload, launches of the served runs and the CLI)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rg_cfg, xl_cfg = rec_configs()
    times, launches = {}, {k: 0 for k in WRAPPERS}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    # ---- (a) recurrentgemma-2b, sparse through B1
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(model_specs(rg_cfg), gen, rg_cfg.param_dtype, device=DEVICE)
    torch.cuda.synchronize()
    times["rg_init_params_s"] = time.perf_counter() - t0
    rg_params = param_count(params)
    t0 = time.perf_counter()
    tuner = launch_serve.build_tuner(scale=0.0008, names=MATRIX_NAMES[:4], n_extra=0,
                                     fit_overhead=False, device=DEVICE)
    times["tuner_s"] = time.perf_counter() - t0
    session = AutoSpmvSession(tuner)
    engine = SparseInferenceEngine(session)
    t0 = time.perf_counter()
    pruned = prune_model_ffns(params, rg_cfg, engine, density=RG_DENSITY)
    torch.cuda.synchronize()
    times["rg_prune_s"] = time.perf_counter() - t0
    del params
    t0 = time.perf_counter()
    n_planned = engine.plan_all("latency")
    torch.cuda.synchronize()
    times["rg_plan_all_s"] = time.perf_counter() - t0
    want = 3 * RG_LAYERS  # every block of recurrentgemma carries a GeGLU FFN
    if not (engine.stats.registered == engine.stats.spmv_layers == n_planned == want):
        raise AssertionError(f"expected {want} SpMV-eligible FFN matrices: {engine.stats}")
    entries = sum(int(np.prod(engine.layer(n).weight_t.shape)) for n in engine._by_name)
    nnz = {n: int((engine.layer(n).weight_t != 0).sum()) for n in RG_B1_CHECK}

    t0 = time.perf_counter()
    checks, seen = rg_logits_check(pruned, rg_cfg, engine)
    checks["b1"] = [row for row, _ in check_b1_served(engine, seen, RG_B1_CHECK)]
    times["rg_check_s"] = time.perf_counter() - t0
    serve = []
    for slots in RG_SLOTS:
        row, got = serve_timed(pruned, rg_cfg, engine, slots, RG_REQUESTS, RG_NEW_TOKENS,
                               RG_MAX_LEN, SEED + 100 + slots, "recurrentgemma")
        serve.append(row)
        add(got)
    t0 = time.perf_counter()
    scans = scan_checks(rg_cfg, xl_cfg)
    teacher = {RG_ARCH: teacher_forcing(pruned, rg_cfg)}
    times["checks_s"] = time.perf_counter() - t0
    rg_state = state_bytes(rg_cfg, RG_MAX_LEN)
    rg_engine, rg_session = engine.summary(), session.stats.as_dict()
    del pruned, engine, session
    torch.cuda.empty_cache()

    # ---- (b) xlstm-1.3b, dense
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = init_params(model_specs(xl_cfg), gen, xl_cfg.param_dtype, device=DEVICE)
    torch.cuda.synchronize()
    times["xl_init_params_s"] = time.perf_counter() - t0
    xl_params = param_count(params)
    xl_engine = SparseInferenceEngine(AutoSpmvSession(tuner))
    prune_model_ffns(params, xl_cfg, xl_engine, density=RG_DENSITY)
    if xl_engine.stats.registered:
        raise AssertionError(f"xLSTM blocks have no FFN, yet: {xl_engine.stats}")
    row, got = serve_timed(params, xl_cfg, None, XL_SLOTS, XL_REQUESTS, XL_NEW_TOKENS,
                           XL_MAX_LEN, SEED + 200, "xlstm")
    add(got)
    xl_serve = row
    t0 = time.perf_counter()
    teacher[XL_ARCH] = teacher_forcing(params, xl_cfg)
    times["xl_teacher_s"] = time.perf_counter() - t0
    xl_state = state_bytes(xl_cfg, XL_MAX_LEN)
    c_bytes = xl_state["by_leaf"]["groups0.C"] // xl_cfg.n_groups
    if c_bytes != 16 * 2 ** 20:
        raise AssertionError(f"an mLSTM block's C is {c_bytes} bytes per slot, not 16 MiB")
    del params
    torch.cuda.empty_cache()

    # ---- the serve CLI's LM mode for both archs, in-process, reduced
    cli = {}
    for arch, flags in ((RG_ARCH, ["--lm-sparse"]), (XL_ARCH, [])):
        reset_launches()
        t0 = time.perf_counter()
        done = launch_serve.main(["--arch", arch, *flags, "--requests", "2", "--slots", "2",
                                  "--max-new-tokens", "3", "--max-len", "64"])
        torch.cuda.synchronize()
        got = read_launches()
        red = get_config(arch, reduced_config=True)
        per_token = 3 * red.n_layers if flags else 0
        cli[arch] = {"wall_s": time.perf_counter() - t0, "generated": [r.generated for r in done],
                     "b1_launches": got["csr"], "matrices": per_token}
        if not (len(done) == 2 and all(len(r.generated) == 3 for r in done)
                and sum(got.values()) == got["csr"]
                and (got["csr"] > 0 and got["csr"] % (per_token * 2) == 0 if flags
                     else got["csr"] == 0)):
            raise AssertionError(f"{arch} CLI: {cli[arch]}")
        add(got)

    def described(cfg, n_params, cut):
        return {"name": cfg.name, "n_layers": cfg.n_layers,
                "blocks": list(cfg.pattern) * cfg.n_groups + list(cfg.tail_blocks),
                "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                "rnn_width": cfg.rnn_dim, "window": cfg.window, "mlstm_chunk": cfg.mlstm_chunk,
                "tied": cfg.tie_embeddings, "params": n_params, "param_dtype": cfg.param_dtype,
                "compute": cfg.compute_dtype, "cut": cut}

    payload = {
        "config": {
            RG_ARCH: described(rg_cfg, rg_params, f"depth {get_config(RG_ARCH).n_layers} -> "
                               f"{RG_LAYERS}: (rec, rec, local) x 2 + (rec, rec)"),
            XL_ARCH: described(xl_cfg, xl_params, f"depth {get_config(XL_ARCH).n_layers} -> "
                               f"{XL_LAYERS}: (7 mLSTM + 1 sLSTM) x 2")},
        "reduced": [f"{RG_ARCH} depth {get_config(RG_ARCH).n_layers} -> {RG_LAYERS} layers",
                    f"{XL_ARCH} depth {get_config(XL_ARCH).n_layers} -> {XL_LAYERS} layers",
                    "widths as published",
                    "checks (c) and the fp32 logits check override compute_dtype to float32"],
        "density": RG_DENSITY, "matrices": want, "pruned_entries": entries, "b1_nnz": nnz,
        "times": times, "checks": checks, "serve": serve, "xlstm_serve": xl_serve,
        "teacher_forcing": teacher, "scans": scans, "cli": cli,
        "state_bytes_per_slot": {RG_ARCH: rg_state, XL_ARCH: xl_state},
        "engine": rg_engine, "session": rg_session,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return payload, launches


# ------------------------------------------------------------------- train
class LogRecords(logging.Handler):
    """The records of the port's loggers while attached: the trainer's
    resume line, the checkpoint's save and restore seconds."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)

    def args_of(self, prefix: str) -> list[tuple]:
        return [r.args for r in self.records if str(r.msg).startswith(prefix)]


def p50(xs) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def leaf_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| of one leaf, in float32 on the card (the same
    bits as on the CPU: subtraction, abs and max round alike)."""
    a, b = a.detach().to(DEVICE, torch.float32), b.detach().to(DEVICE, torch.float32)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_cli(tmp: str, steps: int) -> Trainer:
    """The training CLI in-process on the card: qwen3-0.6b as published."""
    return launch_train.main([
        "--arch", TRAIN_ARCH, "--full", "--steps", str(steps), "--seq-len", str(TRAIN_SEQ),
        "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
        "--ckpt-every", str(TRAIN_STEPS), "--ckpt-dir", tmp, "--seed", str(SEED)])


def train_opt(cfg, lr=TRAIN_LR) -> AdamWConfig:
    """The CLI's optimizer: cosine schedule, the config's moment dtype."""
    return AdamWConfig(learning_rate=cosine_schedule(lr, TRAIN_WARMUP, TRAIN_STEPS),
                       state_dtype=cfg.opt_state_dtype)


def lm_batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    """The data pipeline's batch ``step`` on the card, as the CLI moves it."""
    b = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=SEED)).batch_at(step)
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}


def loss_and_grads(cfg, params, batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = make_loss_fn(cfg)(tree_unflatten(params, leaves), batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def timed_steps(step_fn, state: list, batches: list) -> tuple[list, list]:
    """Steps on the card, each timed on the host clock between two
    synchronises. Returns (seconds, metrics as floats)."""
    secs, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return secs, metrics


def model_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """6 N per token plus attention's 12 L T d_attn per token, without
    remat's recompute."""
    return tokens * (6.0 * n_params + 12.0 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim)


def train_run(records: LogRecords, tmp: str) -> dict:
    """(a) qwen3-0.6b at full width and depth through the training CLI:
    ``TRAIN_STEPS`` steps with a checkpoint at the end, a second run to
    ``TRAIN_RESUME_STEPS`` that resumes from it, one step under the
    profiler."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cli(tmp, TRAIN_STEPS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses}")
    # the trainer's step clock ends at float(loss), a wait for the whole stream
    step_s = [h["time_s"] for h in trainer.history]
    ck_bytes = sum(f.stat().st_size for f in (Path(tmp) / f"step_{TRAIN_STEPS:08d}").iterdir())
    n_saves = len(records.args_of("saved step"))

    t0 = time.perf_counter()
    resumed = train_cli(tmp, TRAIN_RESUME_STEPS)
    resume_wall = time.perf_counter() - t0
    resume_steps = [h["step"] for h in resumed.history]
    if resume_steps != list(range(TRAIN_STEPS, TRAIN_RESUME_STEPS)):
        raise AssertionError(f"resume ran steps {resume_steps}")
    resumed_at = records.args_of("resumed from checkpoint at step")
    if resumed_at != [(TRAIN_STEPS,)]:
        raise AssertionError(f"the resumed run logged {resumed_at}")
    resume_losses = [h["loss"] for h in resumed.history]
    del trainer, resumed
    torch.cuda.empty_cache()

    # one step under the profiler: the device's busy share
    opt_cfg = train_opt(cfg)
    state = list(init_train_state(cfg, opt_cfg, seed=SEED, device=DEVICE))
    n_params = param_count(state[0])
    step_fn = make_train_step(cfg, opt_cfg)
    batch = lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)

    def one_step():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        float(m["loss"])

    profile = profile_tick(one_step)
    del state
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, n_params, tokens, TRAIN_SEQ)
    steady = step_s[2:]
    step_p50 = p50(steady)
    half = len(steady) // 2
    return {
        "config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], "d_ff": cfg.d_ff,
                   "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings, "params": n_params,
                   "param_dtype": cfg.param_dtype, "compute": cfg.compute_dtype,
                   "moments": cfg.opt_state_dtype, "remat": cfg.remat},
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "tokens_per_step": tokens, "wall_s": wall,
        "losses": losses, "step_s": step_s, "step_p50_ms": 1e3 * step_p50,
        "step_halves_p50_ms": [1e3 * p50(steady[:half]), 1e3 * p50(steady[half:])],
        "tokens_per_s": tokens / step_p50,
        "mfu": flops / step_p50 / H100_BF16_FLOPS, "model_flops_per_step": flops,
        "peak_flops": H100_BF16_FLOPS, "peak_is": "dense bf16, H100 SXM data sheet, 700 W",
        "peak_memory_gb": peak / 1e9, "profile": profile,
        "checkpoint": {"bytes": ck_bytes, "saves": n_saves,
                       "save_s": [a[2] for a in records.args_of("saved step")],
                       "restore_s": [a[2] for a in records.args_of("restored step")]},
        "resume": {"steps": resume_steps, "losses": resume_losses, "wall_s": resume_wall},
    }


def train_parity() -> dict:
    """(b) One float32 train step of qwen3-0.6b at full width from the same
    parameters on the card and on the CPU; remat on against off on the
    card.

    AdamW's first step moves a parameter by about lr * sign(g). Where a
    gradient is within rounding of 0 its sign, and so the updated
    parameter, may differ between the devices by up to 2 lr: the updated
    parameters are held where that is not so, every element apart from
    them must have such a gradient (``sign_unstable``), and AdamW alone is
    held to the bound from the same (the CPU's) gradients on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = TRAIN_TOL["leaf"]
    cfg = get_config(TRAIN_ARCH).replace(compute_dtype="float32")
    B, T = TRAIN_PARITY_BATCH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    params = init_params(model_specs(cfg), gen, cfg.param_dtype, device=DEVICE)
    host = tree_map(lambda t: t.cpu(), params)
    batch = lm_batch(cfg, B, T)
    host_batch = {k: v.cpu() for k, v in batch.items()}
    loss, grads = loss_and_grads(cfg, params, batch)
    _, grads_off = loss_and_grads(cfg.replace(remat=False), params, batch)
    t0 = time.perf_counter()
    host_loss, host_grads = loss_and_grads(cfg, host, host_batch)
    cpu_grad_s = time.perf_counter() - t0
    remat = max(leaf_err(a, b) for a, b in zip(grads, grads_off))
    del grads_off
    grad_errs = [leaf_err(a, b) for a, b in zip(grads, host_grads)]
    del grads
    opt_cfg = AdamWConfig(learning_rate=constant(TRAIN_LR), state_dtype=cfg.opt_state_dtype)
    new, _, m = make_train_step(cfg, opt_cfg)(params, init_opt_state(params, opt_cfg), batch)
    # the CPU's step: AdamW over the CPU's gradients (its step function
    # would recompute the same gradients)
    t0 = time.perf_counter()
    host_new, _, host_m = apply_adamw(host, tree_unflatten(host, host_grads),
                                      init_opt_state(host, opt_cfg), opt_cfg)
    cpu_step_s = time.perf_counter() - t0
    param_errs, unstable, unexplained = [], 0, 0
    for a, b, g in zip(tree_leaves(new), tree_leaves(host_new), host_grads):
        param_errs.append(leaf_err(a, b))
        moved = (a.cpu() - b).abs() > tol * b.abs().max()
        unstable += int(moved.sum())
        unexplained += int((g[moved].abs() > tol * g.abs().max()).sum())
    del new
    # AdamW alone, from the same (the CPU's) gradients on both devices
    same = apply_adamw(params, tree_unflatten(params, [g.to(DEVICE) for g in host_grads]),
                       init_opt_state(params, opt_cfg), opt_cfg)[0]
    adamw_errs = [leaf_err(a, b) for a, b in zip(tree_leaves(same), tree_leaves(host_new))]
    out = {
        "batch": [B, T], "compute": "float32", "tf32": False,
        "loss": [float(loss), float(host_loss)],
        "loss_rel": abs(float(loss) - float(host_loss)) / abs(float(host_loss)),
        "step_loss": float(m["loss"]),
        "grad_norm": [float(m["grad_norm"]), float(host_m["grad_norm"])],
        "grad_norm_rel": abs(float(m["grad_norm"]) - float(host_m["grad_norm"]))
        / float(host_m["grad_norm"]),
        "grad_leaf_max": max(grad_errs), "param_leaf_max": max(param_errs),
        "sign_unstable": {"elements": unstable, "with_gradient_above_tol": unexplained,
                          "of": sum(t.numel() for t in host_grads)},
        "adamw_same_grads_leaf_max": max(adamw_errs),
        "remat_on_vs_off": remat, "leaves": len(grad_errs),
        "cpu_s": {"loss_and_grads": cpu_grad_s, "adamw": cpu_step_s}, "tol": TRAIN_TOL,
    }
    if not (out["loss_rel"] <= TRAIN_TOL["loss"] and out["grad_norm_rel"] <= TRAIN_TOL["grad_norm"]
            and out["grad_leaf_max"] <= tol and unexplained == 0
            and out["adamw_same_grads_leaf_max"] <= tol and remat <= TRAIN_TOL["remat"]):
        raise AssertionError(f"train parity: {out}")
    return out


def train_compress() -> dict:
    """(c) (a)'s config with top-k compression at ``COMPRESS_FRAC``; the
    threshold's selection at the embedding, three ways (the same value)."""
    cfg = get_config(TRAIN_ARCH)
    opt_cfg = train_opt(cfg)
    state = list(init_train_state(cfg, opt_cfg, seed=SEED, compress_frac=COMPRESS_FRAC,
                                  device=DEVICE))
    step_fn = make_train_step(cfg, opt_cfg, compress_frac=COMPRESS_FRAC)
    batches = [lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i) for i in range(COMPRESS_STEPS)]
    secs, metrics = timed_steps(step_fn, state, batches)
    density = [m["compress_density"] for m in metrics]
    if not all(d >= COMPRESS_FRAC for d in density):
        raise AssertionError(f"compress_density {density}")
    # the threshold at the embedding's gradient (k = 10 % of 155.6 M)
    _, grads = loss_and_grads(cfg, state[0], batches[0])
    a = grads[0].abs().reshape(-1)
    del grads, state
    n = a.numel()
    k = max(int(n * COMPRESS_FRAC), 1)
    ways = {"topk_unsorted_min": lambda: _kth_largest(a, k),
            "topk_sorted_last": lambda: torch.topk(a, k).values[-1],
            "kthvalue": lambda: torch.kthvalue(a, n - k + 1).values}
    vals = {w: float(f()) for w, f in ways.items()}
    if len(set(vals.values())) != 1:
        raise AssertionError(f"threshold ways disagree: {vals}")
    ms = {w: cuda_time_ms(f, warmup=1, reps=3)["median_ms"] for w, f in ways.items()}
    torch.cuda.empty_cache()
    return {"frac": COMPRESS_FRAC, "losses": [m["loss"] for m in metrics],
            "density": density, "step_s": secs, "step_p50_ms": 1e3 * p50(secs),
            "threshold": {"entries": n, "k": k, "value": vals["kthvalue"], "ms": ms,
                          "used": "topk_unsorted_min"}}


def train_moe(tmp: str) -> dict:
    """(d) deepseek-moe-16b at its published width, ``MOE_LAYERS`` deep:
    a calibration forward picks the dispatch format from the routing
    histogram, ``Trainer`` runs ``MOE_TRAIN_STEPS`` under the pick, then one
    step under each other format."""
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    B, T = MOE_TRAIN_BATCH
    opt_cfg = AdamWConfig(learning_rate=MOE_TRAIN_LR, weight_decay=0.0,
                          state_dtype=cfg.opt_state_dtype)
    params, _ = init_train_state(cfg, opt_cfg, seed=SEED, device=DEVICE)
    n_params = param_count(params)
    with torch.no_grad():
        _, aux = make_loss_fn(cfg)(params, lm_batch(cfg, B, T))
    pick = select_dispatch_format(aux["tokens_per_expert"])
    del params
    cfg = cfg.replace(dispatch_format=pick)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B, seed=SEED)
    tc = TrainConfig(steps=MOE_TRAIN_STEPS, log_every=1, ckpt_every=MOE_TRAIN_STEPS,
                     ckpt_dir=tmp)
    trainer = Trainer(cfg, dc, opt_cfg, tc, device=DEVICE)
    params, opt = init_train_state(cfg, opt_cfg, seed=SEED, device=DEVICE)
    params, opt = trainer.run(params, opt)
    losses = [h["loss"] for h in trainer.history]
    moments = sorted({str(t.dtype) for t in tree_leaves(opt["m"]) + tree_leaves(opt["v"])})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and moments == ["torch.bfloat16"]):
        raise AssertionError(f"moe train: losses {losses}, moments {moments}")
    others = {}
    state = [params, opt]
    for fmt in ("dense", "ell", "sell"):
        if fmt == pick:
            continue
        secs, metrics = timed_steps(make_train_step(cfg.replace(dispatch_format=fmt), opt_cfg),
                                    state, [lm_batch(cfg, B, T, MOE_TRAIN_STEPS)])
        others[fmt] = {"loss": metrics[0]["loss"], "step_s": secs[0]}
        if not np.isfinite(metrics[0]["loss"]):
            raise AssertionError(f"moe step under {fmt}: {metrics}")
    del params, opt, state
    torch.cuda.empty_cache()
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
                       "param_dtype": cfg.param_dtype, "moments": cfg.opt_state_dtype,
                       "experts": cfg.n_experts, "top_k": cfg.top_k},
            "reduced": [f"depth: {get_config(MOE_ARCH).n_layers} -> {MOE_LAYERS} layers"],
            "batch": [B, T], "histogram": aux["tokens_per_expert"].tolist(), "pick": pick,
            "losses": losses, "step_s": [h["time_s"] for h in trainer.history],
            "moments": moments, "other_formats": others}


def train_recurrent() -> dict:
    """(e) recurrentgemma-2b at its published width, ``RG_LAYERS`` deep:
    ``RG_TRAIN_STEPS`` steps through the doubling scan and local
    attention."""
    cfg = get_config(RG_ARCH).replace(n_layers=RG_LAYERS)
    B, T = RG_TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = train_opt(cfg)
    state = list(init_train_state(cfg, opt_cfg, seed=SEED, device=DEVICE))
    n_params = param_count(state[0])
    secs, metrics = timed_steps(make_train_step(cfg, opt_cfg), state,
                                [lm_batch(cfg, B, T, i) for i in range(RG_TRAIN_STEPS)])
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"recurrent train: {metrics}")
    del state
    torch.cuda.empty_cache()
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
                       "blocks": list(cfg.pattern) * cfg.n_groups + list(cfg.tail_blocks)},
            "reduced": [f"depth: {get_config(RG_ARCH).n_layers} -> {RG_LAYERS} layers"],
            "batch": [B, T], "losses": [m["loss"] for m in metrics],
            "grad_norms": [m["grad_norm"] for m in metrics], "step_s": secs,
            "step_p50_ms": 1e3 * p50(secs[1:]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def run_train_phase() -> tuple[dict, dict]:
    """Phase 15: training at full width on the card, parts (a)-(e), each
    emitted on a line of its own with the card's name and power limit. The
    training path is ``forward`` without an engine: it launches none of
    B1-B8, as the reference's reaches no Pallas kernel, and the counters
    must read 0 over the phase. Returns (summary, launches)."""
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    records = LogRecords()
    logging.getLogger("repro_torch").addHandler(records)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train-", dir=os.path.join(HERE, "build"))
    reset_launches()
    seconds = {}
    try:
        for part, fn in (("a", lambda: train_run(records, os.path.join(tmp, "qwen3"))),
                         ("b", train_parity), ("c", train_compress),
                         ("d", lambda: train_moe(os.path.join(tmp, "moe"))),
                         ("e", train_recurrent)):
            t0 = time.perf_counter()
            out = fn()
            seconds[part] = time.perf_counter() - t0
            emit(f"train_{part}", card=card, seconds=seconds[part], **out)
    finally:
        logging.getLogger("repro_torch").removeHandler(records)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    got = read_launches()
    check_launches("train", got, {k: 0 for k in got})
    return {"card": card, "part_seconds": seconds}, got


# -------------------------------------------------------------------- dist
def sharded_row(name: str, how: str, dense: np.ndarray, sharded, x: np.ndarray) -> dict:
    """``DIST_CALLS`` calls of a sharded executor (its B2 launches counted
    by the caller), each ``y`` against the float64 host product and against
    B2's plain version on the same planes, every ``sharded_call`` output on
    its own mesh device."""
    tol = tol_of(sharded.schedule)
    ref = host_product(dense, x)

    def rows(parts):
        return np.concatenate([parts[b.index][0, : b.n_rows].cpu().numpy()
                               for b in sharded.partition.blocks])

    plain = rows([ell_spmv_plain(d, c, torch.as_tensor(x, device=dev), sharded.schedule)[None]
                  for d, c, dev in zip(sharded.data, sharded.cols, sharded.devices)])
    errs, plain_errs = [], []
    for _ in range(DIST_CALLS):
        parts = sharded.sharded_call(x)
        if [t.device for t in parts] != list(sharded.mesh.devices):
            raise AssertionError(f"{name} ({how}): outputs on {[t.device for t in parts]}")
        y = rows(parts)
        errs.append(scaled_err(y, ref))
        plain_errs.append(scaled_err(y, plain))
    if not (np.isfinite(errs).all() and max(errs) <= tol and max(plain_errs) <= tol):
        raise AssertionError(f"sharded executor on {name} ({how}) wrong: {max(errs):.3e} "
                             f"(host), {max(plain_errs):.3e} (plain) > {tol}")
    return {"matrix": name, "from": how, "blocks": sharded.n_blocks,
            "extent": sharded.mesh.shape["data"], "padded_rows": sharded.padded_rows,
            "width": int(sharded.data[0].shape[1]), "schedule": sched_tag(sharded.schedule),
            "calls": DIST_CALLS, "max_err": max(errs), "max_err_vs_plain": max(plain_errs),
            "tol": tol}


def dist_sharded(tuner, pool: dict) -> dict:
    """Phase 16(a): the sharded executor at full size, from a 4-block
    partition (re-cut to the card count, logged) and from the composite
    plan a session's predictor makes; B2 launches = calls x extent. Then,
    for the record, ``sharded_call`` timed in turns with the sequential and
    fused executors of the plan (launches not counted)."""
    session = AutoSpmvSession(tuner)
    records = LogRecords()
    logging.getLogger("repro_torch").addHandler(records)
    rows, timings, launches, refused = [], {}, 0, {}
    n_dev = torch.cuda.device_count()
    try:
        for name in DIST_POOL:
            dense = pool[name]
            x = np.random.default_rng(SEED + 16).normal(size=dense.shape[1]).astype(np.float32)
            seq, fused = (session.partitioned_optimize(dense, max_blocks=MAX_BLOCKS, fused=f)
                          for f in (False, True))
            built = {}
            for how, src in (("partition_rows(4)", partition_rows(dense, 4)),
                             ("predictor_plan", seq.plan)):
                records.records.clear()
                try:
                    built[how] = shard_partitioned(dense, src)
                except InfeasibleConfig as exc:
                    # the carrier's ELL storage guard: reported, not hidden
                    refused[f"{name}:{how}"] = str(exc)
                    continue
                recut = records.args_of("re-partitioning")
                n_src = src.partition.n_blocks if how == "predictor_plan" else src.n_blocks
                if recut != ([(n_src, n_dev)] if n_src != n_dev else []):
                    raise AssertionError(f"{name} ({how}): re-cut to {n_dev} logged as {recut}")
                reset_launches()
                rows.append({**sharded_row(name, how, dense, built[how], x), "recut": recut})
                torch.cuda.synchronize()
                got = read_launches()
                want = {**{k: 0 for k in got}, "ell": DIST_CALLS * built[how].mesh.shape["data"]}
                check_launches(f"dist({name}, {how})", got, want)
                launches += got["ell"]
            if not built:
                continue
            sharded = next(iter(built.values()))
            xt = torch.as_tensor(x, device=DEVICE)
            nnz = int((dense != 0).sum())
            slots = sum(int(d.numel()) for d in sharded.data)
            calls = {"sharded": lambda: sharded.sharded_call(xt),
                     "sequential": lambda: seq.kernel(xt), "fused": lambda: fused.kernel(xt)}
            order = ["sharded", "sequential", "fused", "fused", "sequential", "sharded"]
            ms = {k: [] for k in calls}
            for k in order:
                ms[k].append(timed(calls[k]))
            plain = [(d, c, xt.to(dev)) for d, c, dev in
                     zip(sharded.data, sharded.cols, sharded.devices)]
            timings[name] = {
                "in_turns_ms": ms, "plan_formats": list(seq.plan.formats),
                "plan_blocks": seq.plan.partition.n_blocks,
                "sharded_from": next(iter(built)),
                "plain_ms": timed(lambda: [ell_spmv_plain(d, c, v, sharded.schedule)
                                           for d, c, v in plain]),
                "bound_ms": bound((8 * nnz, 4 * dense.shape[1]), dense.shape[0], 2 * nnz)[0],
                # the carrier's padded slots, each read (value and column) and
                # multiplied: what B2 must do on these planes
                "padded_slots": slots,
                "padded_bound_ms": bound((8 * slots, 4 * dense.shape[1]), dense.shape[0],
                                         2 * slots)[0]}
            library_call("sharded", dense, None, xt, host_product(dense, x), timings[name])
    finally:
        logging.getLogger("repro_torch").removeHandler(records)
    return {"devices": n_dev, "runs": rows, "refused_by_storage_guard": refused,
            "timings": timings, "ell_launches": launches}


def dist_train_step() -> dict:
    """Phase 16(b): one full-width qwen3-0.6b step inside
    ``sharding_context(make_host_mesh())`` gives the bits of the same step
    outside it (every ``hint`` is the identity on plain tensors); the
    training CLI's ``--production-mesh`` raises the mesh's error here."""
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    params, state = init_train_state(cfg, opt, seed=SEED, device=DEVICE)
    batch = lm_batch(cfg, *TRAIN_PARITY_BATCH)
    step = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    plain = step(params, state, batch)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    with sharding_context(make_host_mesh()):
        inside = step(params, state, batch)
    torch.cuda.synchronize()
    t_inside = time.perf_counter() - t0
    loss = float(plain[2]["loss"])
    a, b = tree_leaves(plain), tree_leaves(inside)
    differ = [i for i, (u, v) in enumerate(zip(a, b)) if not torch.equal(u, v)]
    if len(a) != len(b) or differ:
        raise AssertionError(f"the step inside the host mesh's context differs at leaves {differ}")
    del plain, inside, params, state
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dist-", dir=os.path.join(HERE, "build"))
    try:
        launch_train.main(["--arch", TRAIN_ARCH, "--production-mesh", "--steps", "1",
                           "--ckpt-dir", tmp])
    except RuntimeError as exc:
        refusal = str(exc)
    else:
        raise AssertionError("--production-mesh trained on one card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "needs 256 ranks" not in refusal:
        raise AssertionError(f"--production-mesh raised another error: {refusal}")
    return {"leaves": len(a), "same_bits": True, "loss": loss,
            "step_s": {"outside": t_plain, "inside": t_inside},
            "production_mesh_refused": refusal}


def dist_restore() -> dict:
    """Phase 16(c): a saved tree restored with ``shardings=`` lands on the
    card (a ``torch.device`` leaf, a host-mesh ``NamedSharding`` leaf), the
    same bits; a leaf without one follows ``target_like`` (the CPU)."""
    g = torch.Generator().manual_seed(SEED)
    tree = {"w": torch.randn(4096, 1024, generator=g),
            "h": [torch.randn(1024, generator=g).to(torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)],
            "cpu": torch.arange(10, dtype=torch.float32)}
    host = NamedSharding(make_host_mesh(), PartitionSpec())
    tmp = tempfile.mkdtemp(prefix="dist-ckpt-", dir=os.path.join(HERE, "build"))
    try:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(1, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = mgr.restore(tree, shardings={"w": DEVICE, "h": [host, host]})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pairs = [(tree["w"], out["w"]), (tree["h"][0], out["h"][0]), (tree["h"][1], out["h"][1]),
             (tree["cpu"], out["cpu"])]
    where = [str(b.device) for _, b in pairs]
    if where != [str(DEVICE)] * 3 + ["cpu"]:
        raise AssertionError(f"restore(shardings=) placed leaves on {where}")
    if not all(a.dtype == b.dtype and torch.equal(a, b.cpu()) for a, b in pairs):
        raise AssertionError("restore(shardings=) changed a leaf's bits")
    return {"leaves": where, "same_bits": True, "save_s": save_s, "restore_s": restore_s}


def start_dryruns() -> dict:
    """Phase 16(d), started: ``DRYRUN_CELLS`` through the dry-run CLI, one
    subprocess each, all at once, on a ``cuda`` mesh. ``main`` starts them
    before phase 13: they count on the host's cores while phases 13-16(c)
    run on the card."""
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun-", dir=os.path.join(HERE, "build"))
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh, "--device-type", "cuda", "--out", out_dir]
        log = Path(out_dir, f"{arch}__{shape}__{mesh}.log")
        with open(log, "w") as fh:  # a file, not a pipe: nothing reads it until (d)
            procs[(arch, shape, mesh)] = subprocess.Popen(
                cmd, stdout=fh, stderr=subprocess.STDOUT, text=True, env=env)
    return {"out_dir": out_dir, "procs": procs, "t0": time.perf_counter()}


def stop_dryruns(started: dict) -> None:
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(started["out_dir"], ignore_errors=True)


def finish_dryruns(started: dict) -> dict:
    """Phase 16(d): wait for every cell; one that fails or outlasts
    ``DRYRUN_TIMEOUT_S`` fails the phase. Per cell what its artifact says."""
    cells = []
    for (arch, shape, mesh), proc in started["procs"].items():
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - started["t0"])
        try:
            proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dry run {arch} {shape} {mesh}: over {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0:
            err = Path(started["out_dir"], f"{arch}__{shape}__{mesh}.log").read_text()
            raise AssertionError(f"dry run {arch} {shape} {mesh} failed "
                                 f"(exit {proc.returncode}):\n{err[-3000:]}")
        mesh_name = "pod2x16x16" if mesh == "pod2" else "pod16x16"
        art = json.loads(Path(started["out_dir"], f"{arch}__{shape}__{mesh_name}.json").read_text())
        if art.get("device_type") != "cuda" or "roofline" not in art:
            raise AssertionError(f"dry run {arch} {shape} {mesh}: artifact {art}")
        cells.append({
            "arch": arch, "shape": shape, "mesh": art["mesh"], "n_chips": art["n_chips"],
            "step_s_full": art["step_s_full"],
            "step_s_per_rep": {k: v["step_s"] for k, v in art["cost_pass"]["per_rep"].items()},
            "memory": art["memory"], "hbm_per_device_gb": art["hbm_per_device_gb"],
            "fits_80gb": art["fits_hbm"],
            "extrapolated_per_device": art["cost_pass"]["extrapolated_per_device"],
            "collectives_by_kind": art["cost_pass"]["collectives_by_kind_full"],
            "roofline": art["roofline"]})
    return {"cells": cells, "wall_s": time.perf_counter() - started["t0"],
            "hardware": "H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s, 80 GB; "
                        "collectives at 50 GB/s per GPU (NDR InfiniBand)"}


def run_dist_phase(tuner, pool: dict, started: dict | None = None) -> tuple[dict, dict]:
    """Phase 16: multi-device, parts (a)-(d), each emitted on a line of its
    own with the card's name and power limit. ``started``: (d)'s dry runs
    if they were started earlier (``start_dryruns``), else they start here.
    Returns (summary, the main path's launches: B2 from (a) only)."""
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    seconds = {}
    got = {k: 0 for k in WRAPPERS}
    started = started or start_dryruns()
    try:
        for part, fn in (("a", lambda: dist_sharded(tuner, pool)), ("b", dist_train_step),
                         ("c", dist_restore), ("d", lambda: finish_dryruns(started))):
            t0 = time.perf_counter()
            out = fn()
            seconds[part] = time.perf_counter() - t0
            if part == "a":
                got["ell"] = out["ell_launches"]
            emit(f"dist_{part}", card=card, seconds=seconds[part], **out)
    finally:
        stop_dryruns(started)
    return {"card": card, "part_seconds": seconds}, got


# -------------------------------------------------------------------- spmm
def check_spmm(cases: list[dict], time_schedule: KernelSchedule = DEFAULT_SCHEDULE) -> dict:
    """Hold B8 against its plain version and a float64 host product over the
    six schedules for every case (a matrix and its X); at k = 1 against B2 on
    the same ELL container; where the case carries the engine's per-token
    SpMV outputs (the decode tick's X), against those. At ``time_schedule``
    time kernel, plain version, the library's CSR SpMM and k per-vector B1
    launches, beside the byte bound. Comparison launches only."""
    import scipy.sparse

    worst, rows, mats = 0.0, [], {}
    for case in cases:
        A, X_host = case["A"], case["X"]
        n_rows, n_cols = A.shape
        k = X_host.shape[1]
        X = torch.as_tensor(X_host, device=DEVICE).contiguous()
        ref64 = scipy.sparse.csr_matrix(A).astype(np.float64) @ X_host.astype(np.float64)
        row = {"matrix": case["name"], "shape": [n_rows, n_cols], "nnz": int((A != 0).sum()),
               "k": k, "x": case["x_kind"], "by_schedule": {}}
        for sched in SCHEDULES:
            key = (case["name"], sched.rows_per_block, sched.nnz_tile)
            if key not in mats:  # the storage depends on (rpb, nnz_tile) only
                mats[key] = prepare(A, "ell", sched, device=DEVICE)
            mat = mats[key]
            y_k = ell_spmm(mat.data, mat.cols, X, sched)
            torch.cuda.synchronize()  # a fault during the run surfaces here
            if not torch.equal(y_k, ell_spmm(mat.data, mat.cols, X, sched)):  # no atomics
                raise AssertionError(f"spmm kernel: two launches differ on {case['name']} "
                                     f"k={k} at {sched}")
            yk = y_k[:n_rows].cpu().numpy()
            yp = ell_spmm_plain(mat.data, mat.cols, X, sched)[:n_rows].cpu().numpy()
            err, err_host, tol = scaled_err(yk, yp), scaled_err(yk, ref64), tol_of(sched)
            if not (yk.shape == (n_rows, k) and np.isfinite(yk).all()
                    and err <= tol and err_host <= tol):
                raise AssertionError(
                    f"spmm kernel disagrees on {case['name']} k={k} at {sched}: vs plain "
                    f"{err:.3e}, vs host float64 {err_host:.3e}, tolerance {tol:.0e}")
            worst = max(worst, err)
            tag = sched_tag(sched) + ("_par" if sched.dimension_semantics == "parallel" else "")
            cell = {"err_vs_plain": err, "err_vs_host": err_host, "bit_identical": True}
            if k == 1:  # B8 at one right-hand side is B2's product
                y2 = ell_spmv(mat.data, mat.cols, X[:, 0].contiguous(), sched)[:n_rows]
                y2 = y2.cpu().numpy()
                cell["err_vs_b2"] = scaled_err(yk[:, 0], y2)
                cell["equal_to_b2"] = bool(np.array_equal(yk[:, 0], y2))
                if cell["err_vs_b2"] > (1e-6 if sched.accum_dtype == "float32" else 3e-2):
                    raise AssertionError(f"B8 at k = 1 differs from B2: {cell} at {sched}")
            row["by_schedule"][tag] = cell
            if sched != time_schedule:
                continue
            if "Y_engine" in case:  # the engine's four per-token SpMVs
                row["err_vs_engine"] = scaled_err(yk, case["Y_engine"])
                if row["err_vs_engine"] > 1e-4:
                    raise AssertionError(f"B8 differs from the engine's SpMVs: {row}")
            R, W = mat.data.shape
            need, stored, _ = padded_needs("ell", mat)
            nbytes = need + n_cols * k * 4 + n_rows * k * 4
            padded = stored + n_cols * k * 4 + R * k * 4  # every slot of the planes
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * row["nnz"] * k / FP32_FLOPS
            t = timing(lambda: ell_spmm(mat.data, mat.cols, X, sched))
            row["ms"], row["ms_late_reps"] = t["median_ms"], int(t["late"])
            row["wrapper_host_us"] = host_us(lambda: ell_spmm(mat.data, mat.cols, X, sched))
            csr = prepare(A, "csr", device=DEVICE)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "sparse CSR is beta" notice
                lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                              size=csr.shape, device=DEVICE)
                row["library_err"] = scaled_err((lib @ X).cpu().numpy(), ref64)
                row["library_ms"] = timed(lambda: lib @ X)
            cols = [X[:, j].contiguous() for j in range(k)]
            row["launch"] = {**spmm_design(mat, k), "by_plan": spmm_sweep(mat, X, sched, y_k)}
            b1 = timing(lambda: [csr_spmv(csr.data, csr.indices, csr.indptr, c, sched)
                                 for c in cols])
            row.update({
                "schedule": sched_tag(sched), "width": W,
                "plain_ms": timed(lambda: ell_spmm_plain(mat.data, mat.cols, X, sched), reps=5),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                "padded_bytes": padded, "padded_bound_ms": 1e3 * padded / HBM_BYTES_PER_S,
                "b1_per_vector_ms": b1["median_ms"], "b1_per_vector_late_reps": int(b1["late"]),
                "library": "torch.sparse_csr_tensor(A) @ X"})
            if row["library_err"] > 1e-4:
                raise AssertionError(f"library SpMM wrong: {row}")
        rows.append(row)
    return {"rows": rows, "max_abs_err": worst, "mats": mats}


def spmm_design(mat, k: int) -> dict:
    """The launch B8's plan chose for ELL planes and k: lanes per slot,
    columns per lane, warps per row, rows per warp, CTAs; beside it the
    live and the stored plane slots."""
    R, W = mat.data.shape
    plan = spmm_launch_plan(R, W, k, sm_count(DEVICE))
    return {**plan, "slots_live": int(ell_live_width(mat.data).sum()), "slots_stored": R * W}


def spmm_sweep(mat, X: torch.Tensor, sched: KernelSchedule, y_kernel: torch.Tensor) -> dict:
    """B8 at its plan and the plan's alternatives (``spmm_plan_choices``)
    through the launch helper (the wrapper's counter does not move): each
    twice (the same bits, and the bits of the wrapper's launch where the
    split is the same, since then every launch adds in the same order),
    timed, and once more with the kernel's read counts on, whose sum
    (``slots_read``) must equal the stop rule's host twin
    (``slots_read_modelled``, ``spmm_slots_read``)."""
    R, W = mat.data.shape
    k = X.shape[1]
    bf16 = sched.accum_dtype == "bfloat16"
    live = ell_live_width(mat.data).cpu()
    plan0 = spmm_launch_plan(R, W, k, sm_count(DEVICE))
    out = {}
    for plan in spmm_plan_choices(R, W, k, sm_count(DEVICE)):
        tag = f"wpr{plan['warps_per_row']}_rpw{plan['rows_per_warp']}"
        first = _spmm_launch(mat.data, mat.cols, X, plan, bf16)
        Y = _spmm_launch(mat.data, mat.cols, X, plan, bf16)
        reads = torch.zeros(plan["warps"], dtype=torch.int32, device=DEVICE)
        Y_counted = _spmm_launch(mat.data, mat.cols, X, plan, bf16, reads)
        torch.cuda.synchronize()
        if not (torch.equal(first, Y) and torch.equal(Y, Y_counted)):
            raise AssertionError(f"spmm kernel at {tag}: two launches differ")
        # a split row adds its warps' partials in another order than one warp
        same = plan["warps_per_row"] == plan0["warps_per_row"]
        err = scaled_err(Y.cpu().numpy(), y_kernel.cpu().numpy())
        if (same and not torch.equal(Y, y_kernel)) or err > tol_of(sched):
            raise AssertionError(f"spmm kernel at {tag} differs from the plan's launch: {err:.3e}")
        read, modelled = int(reads.sum()), spmm_slots_read(live, W, plan)
        if read != modelled:
            raise AssertionError(f"spmm kernel at {tag} read {read} plane slots, "
                                 f"its host twin says {modelled}")
        out[tag] = {"ctas": plan["ctas"], "warps": plan["warps"], "err_vs_plan": err,
                    "slots_read": read, "slots_read_modelled": modelled,
                    "ms": timed(lambda: _spmm_launch(mat.data, mat.cols, X, plan, bf16))}
    return out


def spmm_cases(rim: np.ndarray, tick: dict) -> list[dict]:
    """rim at every k of SPMM_KS; each FFN_CHECK matrix (A = W.T) at k = 4
    with the decode tick's four token vectors, and at k = 16."""
    rng = np.random.default_rng(SEED + 51)
    cases = [{"name": "rim", "A": rim, "x_kind": "random",
              "X": rng.normal(size=(rim.shape[1], k)).astype(np.float32)} for k in SPMM_KS]
    for n, t in tick.items():
        A = np.ascontiguousarray(t["A"])
        for k in FFN_KS:
            case = {"name": n, "A": A}
            if k == t["X"].shape[1]:
                case.update(X=t["X"].cpu().numpy(), x_kind="decode tick",
                            Y_engine=t["Y"].cpu().numpy())
            else:
                case.update(X=rng.normal(size=(A.shape[1], k)).astype(np.float32),
                            x_kind="random")
            cases.append(case)
    return cases


def run_spmm_phase(cases: list[dict]) -> tuple[dict, dict]:
    """Check B8 (``check_spmm``), then drive the public entry point
    ``ops.spmm(prepare(A, "ell", schedule), X)`` once per case with the
    counters at 0: the main path of B8. Returns (entry, launches)."""
    checked = check_spmm(cases)
    mats = checked.pop("mats")
    reset_launches()
    for case in cases:
        mat = mats[(case["name"], DEFAULT_SCHEDULE.rows_per_block, DEFAULT_SCHEDULE.nnz_tile)]
        Y = spmm(mat, case["X"], DEFAULT_SCHEDULE).cpu().numpy()
        ref = case["A"].astype(np.float64) @ case["X"].astype(np.float64)
        if not (Y.shape == ref.shape and scaled_err(Y, ref) <= 1e-4):
            raise AssertionError(f"ops.spmm wrong on {case['name']} k={case['X'].shape[1]}")
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["spmm"] != len(cases) or sum(launches.values()) != len(cases):
        raise AssertionError(f"spmm main path launches: {launches}")
    rows = checked["rows"]
    head = next(r for r in rows if r["x"] == "decode tick" and r["matrix"] == FFN_CHECK[0])
    entry = {k: head[k] for k in ("matrix", "shape", "nnz", "k", "schedule", "width", "ms",
                                  "plain_ms", "bound_ms", "bound_by", "bytes", "padded_bytes",
                                  "padded_bound_ms", "library_ms", "library",
                                  "b1_per_vector_ms", "wrapper_host_us")}
    # the launch of each case goes to the spmm phase line, not the kernels line
    entry.update(x="the decode tick's four token vectors", max_abs_err=checked["max_abs_err"],
                 tolerance={"float32": 1e-4, "bfloat16": 3e-2}, bit_identical=True,
                 cases=[{k: v for k, v in r.items() if k != "launch"} for r in rows],
                 launch={f"{r['matrix']} k={r['k']}": r["launch"] for r in rows})
    return entry, launches


def check_launches(phase: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{phase}: launches (got, want) differ: {bad}")



# ---------------------------------------------------------------- observed
class KeepingRecorder(TelemetryRecorder):
    """The telemetry recorder, also keeping every record it folds, so the
    phase can print each request's served formats and block times."""

    def __init__(self, *args, **kw):
        self.kept = []
        super().__init__(*args, **kw)

    def record(self, rec) -> None:
        super().record(rec)
        self.kept.append(rec)


def per_format(fmts) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in fmts:
        out[f] = out.get(f, 0) + 1
    return dict(sorted(out.items()))


def disabled_arms(selector) -> list[list[str]]:
    """[bucket, objective, format] of every arm the bandit disabled (a pick
    whose conversion failed)."""
    return [[b, o, f] for (b, o), cell in sorted(selector.cells().items())
            for f, arm in sorted(cell.arms.items()) if arm.disabled]


def check_observed_launches(what: str, got: dict, want: dict) -> None:
    """Every block format's wrapper launched exactly as often as the path
    ran it; a format observed but never launched fails."""
    check_launches(what, got, {f: want.get(f, 0) for f in BLOCK_FORMATS})


def corrections_of(model) -> dict:
    return {f: c.as_dict() for f, c in sorted(model.corrections.items())}


def observed_runtime(tuner, pool, tmp: Path) -> tuple[dict, dict, tuple]:
    """(a) Observed run-time serving: recorder, bandit, feedback refits,
    calibration every 8 requests, SLO tracking, the watchdog and fleet sync,
    on N_OBSERVED requests with repeats over the pool; the SLO class of a
    request is its matrix's, so the four classes are mixed and each
    (matrix, class) cell is served several times."""
    rec = KeepingRecorder(tmp / "telemetry.jsonl", flush_every=OBSERVED_BATCH)
    session = AutoSpmvSession(tuner, cache_path=tmp / "runtime.json", telemetry=rec,
                              adaptive=AdaptiveFormatSelector())
    feedback = FeedbackLoop(rec, base_dataset=tuner.dataset,
                            config=FeedbackConfig(refit_every=8))
    tracker = SloTracker()
    fleet = FleetSync(session, tmp / "fleet", instance="smoke", sync_every=OBSERVED_BATCH)
    server = SpmvServer(session, feedback=feedback, calibrate_every=8, slo=tracker,
                        anomaly=True, fleet=fleet)
    rng = np.random.default_rng(SEED + 11)
    names = list(POOL) + [str(rng.choice(POOL)) for _ in range(N_OBSERVED - len(POOL))]
    cls_of = {n: SLO_CLASSES[i % len(SLO_CLASSES)] for i, n in enumerate(POOL)}
    reqs = [SpmvRequest(rid=i, dense=pool[n], slo=cls_of[n],
                        x=rng.normal(size=pool[n].shape[1]).astype(np.float32))
            for i, n in enumerate(names)]
    reset_launches()
    t0 = time.perf_counter()
    for b in range(0, N_OBSERVED, OBSERVED_BATCH):
        server.run(reqs[b:b + OBSERVED_BATCH])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_launches()
    observed = per_format(r.fmt for r in rec.kept)
    check_observed_launches("observed(runtime)", got, observed)
    rows = []
    for r, n in zip(reqs, names):
        ref = host_product(r.dense, r.x)
        err, tol = scaled_err(r.y, ref), tol_of(r.schedule)
        rows.append({"rid": r.rid, "matrix": n, "slo": r.slo, "objective": r.served_objective,
                     "fmt": r.fmt, "explore": r.exploratory, "hit": r.cache_hit,
                     "ms": r.latency_s * 1e3, "err": err, "tol": tol})
        if not (r.y.shape == ref.shape and np.isfinite(r.y).all() and err <= tol):
            raise AssertionError(f"observed request {r.rid} ({n}, {r.fmt}) wrong: "
                                 f"err {err:.3e} > {tol:.0e}")
    summary = server.summary()
    ms_by_fmt = {f: float(np.median([x["ms"] for x in rows if x["fmt"] == f]))
                 for f in observed}
    payload = {
        "seconds": seconds, "requests": rows, "observed": observed, "launches": got,
        "request_ms_p50": ms_by_fmt, "refits": feedback.refits,
        "calibrations": server.calibrations,
        "runtime_corrections": corrections_of(session.cost_model),
        "watchdog": {"fires": server.anomaly_fires, **summary["anomaly"]},
        "slo": {c: {k: v[k] for k in ("state", "samples", "alerts", "burn_rates")}
                for c, v in summary["slo"]["classes"].items()},
        "bandit": summary["adaptive"], "disabled": disabled_arms(session.adaptive),
        "session": summary["session"],
        "modeled_latency_s": {f: summary["energy"][f]["modeled_latency_s"]
                              for f in summary.get("energy", {})},
    }
    if payload["calibrations"] != N_OBSERVED // OBSERVED_BATCH:
        raise AssertionError(f"observed(runtime): calibrations {payload['calibrations']}")
    return payload, got, (server, session, rec, fleet)


def observed_partitioned(tuner, part_pool, tmp: Path, cache=None
                         ) -> tuple[dict, dict, AutoSpmvSession]:
    """(b) Observed partitioned serving: each block timed on its own
    (``PartitionedSpmv.timed_call``), every (block, format) pair its own
    bandit arm. Block-kernel launches must equal the blocks timed plus each
    new composite's untimed warm-up run. ``cache``: the plan cache of phase
    6's partitioned session, so the composites are the ones phase 6 served
    (a restart over a warm cache) and their planning is not paid again."""
    rec = KeepingRecorder()
    session = AutoSpmvSession(tuner, cache=cache, cache_path=tmp / "partitioned.json",
                              telemetry=rec, adaptive=AdaptiveFormatSelector())
    server = SpmvServer(session, partition=True, max_blocks=MAX_BLOCKS)
    rng = np.random.default_rng(SEED + 12)
    names = list(PART_POOL) + [str(rng.choice(PART_POOL))
                               for _ in range(N_OBSERVED_PART - len(PART_POOL))]
    warmups = []  # the formats of each composite whose first call warmed it
    timed_call = PartitionedSpmv.timed_call

    def counting_timed_call(self, x, **kw):
        if not self._warmed:
            warmups.extend(self.formats)
        return timed_call(self, x, **kw)

    rows = []
    reset_launches()
    t0 = time.perf_counter()
    PartitionedSpmv.timed_call = counting_timed_call
    try:
        for rid, n in enumerate(names):
            dense = part_pool[n]
            x = rng.normal(size=dense.shape[1]).astype(np.float32)
            before = len(rec.kept)
            (req,) = server.run([SpmvRequest(rid=rid, dense=dense, x=x, objective="latency")])
            blocks = rec.kept[before:]
            bf16 = any(b.schedule.get("accum_dtype") == "bfloat16" for b in blocks)
            tol = 3e-2 if bf16 else 1e-4
            ref = host_product(dense, x)
            err = scaled_err(req.y, ref)
            rows.append({"rid": rid, "matrix": n, "formats": [b.fmt for b in blocks],
                         "explored": [b.exploratory for b in blocks],
                         "block_ms": [b.measured_s * 1e3 for b in blocks],
                         "request_ms": req.latency_s * 1e3, "hit": req.cache_hit,
                         "err": err, "tol": tol})
            if not (req.y.shape == ref.shape and np.isfinite(req.y).all() and err <= tol
                    and req.fmt.split("+") == rows[-1]["formats"]):
                raise AssertionError(f"observed partitioned request {rid} ({n}): {rows[-1]}")
    finally:
        PartitionedSpmv.timed_call = timed_call
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_launches()
    timed = per_format(r.fmt for r in rec.kept)
    want = dict(timed)
    for f in warmups:
        want[f] = want.get(f, 0) + 1
    check_observed_launches("observed(partitioned)", got, want)
    if cache is not None and not (got["sell"] and got["bell"]):
        raise AssertionError(f"observed(partitioned): the pinned plan served no B3 or B4: {got}")
    payload = {"seconds": seconds, "requests": rows, "blocks_timed": timed,
               "warmup_blocks": per_format(warmups),
               "launches": got, "disabled": disabled_arms(session.adaptive),
               "explorations": session.stats.explorations,
               "cells": len([c for c in session.adaptive.cells() if "#blk" in c[0]])}
    return payload, got, session


def observed_calibration(tuner, runtime_session, part_session, tmp: Path) -> dict:
    """(c) ``calibrate()`` on both sessions: corrections per format, over
    the model that scored their plans (the card-labelled tuner's
    ``CardCostModel``); the partitioned session's ``part:*`` plans evicted;
    fresh sessions over the same cache paths load the files, on the H100
    profile and the same base."""
    out = {}
    for name, session in (("runtime", runtime_session), ("partitioned", part_session)):
        n_part = sum(e.mode.startswith("part:") for e in session.cache.entries())
        model = session.calibrate()
        left = sum(e.mode.startswith("part:") for e in session.cache.entries())
        fresh = AutoSpmvSession(tuner, cache_path=session.cache_path)
        loaded = fresh.cost_model
        if not (isinstance(loaded, CalibratedCostModel) and loaded.hw.name == "h100_sxm"
                and isinstance(model.base, CardCostModel)
                and isinstance(loaded.base, CardCostModel)
                and loaded.base.profile == model.base.profile
                and corrections_of(loaded) == corrections_of(model) and left == 0):
            raise AssertionError(f"calibration ({name}): loaded {loaded!r} over "
                                 f"{type(getattr(loaded, 'base', None)).__name__}, "
                                 f"part plans left {left}")
        out[name] = {"corrections": corrections_of(model), "hardware": loaded.hw.name,
                     "base": f"{type(loaded.base).__name__}({loaded.base.profile.name})",
                     "part_plans_evicted": n_part,
                     "file": os.path.relpath(str(session.cache_path), str(tmp))}
    if not out["partitioned"]["part_plans_evicted"]:
        raise AssertionError("calibration: the partitioned session had no part:* plan")
    return out


def observed_endpoint(server) -> dict:
    """(e) ``/metrics`` and ``/slo`` from the server's endpoint on 127.0.0.1."""
    http = server.start_metrics_server(0)
    try:
        with urllib.request.urlopen(f"{http.url}/metrics", timeout=30) as resp:
            metrics_body = resp.read().decode()
        with urllib.request.urlopen(f"{http.url}/slo", timeout=30) as resp:
            slo_body = json.loads(resp.read())
    finally:
        server.stop_metrics_server()
    if "spmv_request_latency_seconds" not in metrics_body or set(slo_body["classes"]) != set(
            SLO_CLASSES):
        raise AssertionError("metrics endpoint: /metrics or /slo incomplete")
    return {"metrics_lines": len(metrics_body.splitlines()),
            "slo_states": {c: v["state"] for c, v in slo_body["classes"].items()}}


def observed_cli(tmp: Path) -> tuple[dict, dict]:
    """(f) ``repro_torch.launch.serve.main`` in process with every telemetry
    and observability flag, twice (the second run warm-starts from the log,
    the plan cache and the calibration), sharing the fleet directory of (a);
    then LM mode with ``--slo-config``, at the reduced config."""
    cli = tmp / "cli"
    log = cli / "telemetry.jsonl"
    argv = ["--spmv", "--requests", "8", "--spmv-train-matrices", "4",
            "--spmv-cache", str(cli / "tuning.json"), "--telemetry-log", str(log),
            "--adaptive", "--refit-every", "4", "--calibrate-every", "4",
            "--spmv-slo", "mixed", "--anomaly", "--fleet-dir", str(tmp / "fleet"),
            "--sync-every", "4", "--metrics-port", "0", "--profile-dir", str(cli / "profile")]
    reset_launches()
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        done = launch_serve.main(argv)
        errs = [scaled_err(r.y, host_product(r.dense, r.x)) for r in done]
        if any(e > tol_of(r.schedule) for e, r in zip(errs, done)):
            raise AssertionError(f"serve CLI: errors {errs}")
        runs.append({"requests": len(done), "hits": sum(r.cache_hit for r in done),
                     "formats": [r.fmt for r in done], "slo": [r.slo for r in done],
                     "logged": TelemetryRecorder(log).total_observations()})
    spmv_s = time.perf_counter() - t0
    if not (runs[1]["hits"] == 8 and runs[0]["logged"] == 8 and runs[1]["logged"] == 16
            and (cli / "tuning.calibration.json").exists()
            and (cli / "profile" / "trace.json").exists()):
        raise AssertionError(f"serve CLI: no warm start or missing files: {runs}")
    slo_path, summary_path = cli / "slo.json", cli / "lm-summary.json"
    slo_path.write_text(json.dumps({"fast_window": 4, "min_samples": 2}))
    t0 = time.perf_counter()
    lm_done = launch_serve.main(["--arch", LM_ARCH, "--lm-sparse", "--requests", "4",
                                 "--slots", "2", "--max-new-tokens", "4", "--max-len", "64",
                                 "--slo", "mixed", "--slo-config", str(slo_path),
                                 "--summary-export", str(summary_path)])
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    got = read_launches()
    lm_slo = json.loads(summary_path.read_text())["slo"]
    if not (len(lm_done) == 4 and sum(c["samples"] for c in lm_slo["classes"].values()) > 0
            and got["csr"] > 0):
        raise AssertionError(f"LM CLI with --slo-config: {lm_slo}")
    return {"spmv_seconds": spmv_s, "runs": runs,
            "profile_bytes": (cli / "profile" / "trace.json").stat().st_size,
            "lm_seconds": lm_s, "lm_slo": {c: (v["state"], v["samples"])
                                           for c, v in lm_slo["classes"].items()},
            "launches": got}, got


def run_observed_phase(tuner, pool, part_pool, part_cache=None) -> tuple[dict, dict]:
    """Phase 11: the telemetry and observability layer on the card, over
    the kernels the served paths run (B1-B4). ``part_cache``: phase 6's
    partitioned plan cache, reused by (b). Returns (payload, launches)."""
    launches = {k: 0 for k in WRAPPERS}
    with tempfile.TemporaryDirectory(prefix="observed-") as tmp_dir:
        tmp = Path(tmp_dir)
        runtime, got, (server, session, rec, fleet) = observed_runtime(tuner, pool, tmp)
        for k in launches:
            launches[k] += got[k]
        partitioned, got, part_session = observed_partitioned(tuner, part_pool, tmp,
                                                              part_cache)
        for k in launches:
            launches[k] += got[k]
        calibration = observed_calibration(tuner, session, part_session, tmp)
        rec.flush()  # (d) a second recorder over the same log
        restarted = TelemetryRecorder(rec.log_path)
        restart = {"observations": rec.total_observations(),
                   "replayed": restarted.total_observations(),
                   "dropped": restarted.records_dropped}
        if restart["replayed"] != restart["observations"] or restart["dropped"]:
            raise AssertionError(f"restart: {restart}")
        endpoint = observed_endpoint(server)
        cli, got = observed_cli(tmp)
        for k in launches:
            launches[k] += got[k]
        fleet_final = fleet.sync()  # absorbs the CLI instance's shard
        if fleet_final["peers"] < 1:
            raise AssertionError(f"fleet: no peer shard absorbed: {fleet_final}")
        payload = {"runtime": runtime, "partitioned": partitioned,
                   "calibration": calibration, "restart": restart, "endpoint": endpoint,
                   "cli": cli,
                   "fleet": {"shard": os.path.relpath(str(fleet.shard_path), tmp_dir),
                             "syncs": fleet.syncs, "final": fleet_final,
                             "absorbed_pulls": session.adaptive.summary()["absorbed_pulls"]}}
    return payload, launches


# -------------------------------------------------------------------- main
# ------------------------------------------------------------------- tuner
def card_point_check(errs: dict):
    """``collect_dataset``'s ``on_point``: each timed point's ``y`` (its last
    call) against the kernel's plain version on the same storage, on the
    card; the worst scaled error per format and accumulator kept in
    ``errs``. A point beyond its tolerance (1e-4 in float32, 3e-2 in
    bfloat16), or any non-finite ``y``, fails the run: since B3 folds its
    bf16 sums into a float32 carry no point is refused for precision."""
    def check(name, cfg, kernel, x, y):
        ref = kernel_calls(cfg.fmt, kernel.mat, x, cfg.schedule)[1]()
        n = kernel.mat.shape[0]
        ref, got = ref.reshape(-1)[:n], y.reshape(-1)[:n]
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
        tol = tol_of(cfg.schedule)
        at = f"{name}/{sched_tag(cfg.schedule)}_{cfg.schedule.x_residency}"
        row = errs.setdefault(f"{cfg.fmt}_{cfg.schedule.accum_dtype}",
                              {"points": 0, "worst": 0.0, "worst_at": None, "tol": tol})
        row["points"] += 1
        if err >= row["worst"]:
            row.update(worst=err, worst_at=at)
        if not bool(torch.isfinite(got).all()) or err > tol:
            raise AssertionError(f"tuner: {at} ({cfg.fmt}) y off its plain version: "
                                 f"{err:.3e} > {tol:.0e}")
        return True
    return check


def tuner_presets(shapes: dict):
    """The paper's presets beside the pool, each cut to ``SERVED_ROWS`` rows,
    generated as the collection reads them; their shapes and nonzeros kept
    in ``shapes`` (B1's launch reads no more)."""
    for name in TUNER_CSR_PRESETS:
        dense = served_matrix(name)
        shapes[name] = SimpleNamespace(n_rows=dense.shape[0], n_cols=dense.shape[1],
                                       nnz=int(np.count_nonzero(dense)))
        yield name, dense


def measured_at(ds, matrix: str, cfg) -> float:
    """Measured seconds of the record of ``cfg`` (a point of the card's space)."""
    for r in ds.for_matrix(matrix):
        if is_measured(r) and r.config == cfg:
            return r.latency
    raise AssertionError(f"tuner: no measured record of {cfg} for {matrix}")


def in_turns_at(ds, matrix: str, cfg) -> float:
    """Seconds of ``cfg``: its in-turn median where it was a re-timed
    candidate, else its first pass's (it was then more than
    ``RETIME_WITHIN`` slower than its format's best)."""
    rt = ds.meta["retime"].get(matrix, {"candidates": [], "median_ms": []})
    for c, ms in zip(rt["candidates"], rt["median_ms"]):
        if config_of(c) == cfg:
            return 1e-3 * ms
    return measured_at(ds, matrix, cfg)


def fastest_in_turns(ds, matrix: str, fmt: str = "csr") -> float:
    """The least in-turn median of ``fmt``'s re-timed candidates (seconds):
    the label is the tie rule's pick within the in-turn spread of it."""
    rt = ds.meta["retime"][matrix]
    return 1e-3 * min(ms for c, ms in zip(rt["candidates"], rt["median_ms"])
                      if c["fmt"] == fmt)


def tuner_dataset(pool: dict, shapes: dict) -> tuple:
    """17(b): the card's dataset. The whole card space (every format) on the
    pool, the card's CSR space on ``TUNER_CSR_PRESETS``; every point timed
    through its kernel and its ``y`` held against its plain version.
    Launches must equal the timed calls; ``measure_formats`` on ``rim``
    must launch each admitted format's kernel warmup + reps times. Returns
    (dataset loaded back from its file, report)."""
    errs = {}
    n_sms = sm_count(DEVICE)
    common = dict(measure=True, measure_reps=TUNER_REPS, device=DEVICE,
                  on_point=card_point_check(errs))
    reset_launches()
    t0 = time.perf_counter()
    runtime = collect_dataset(matrices=pool, space=CardSpace(n_sms=n_sms), **common)
    csr_only = collect_dataset(matrices=tuner_presets(shapes),
                               space=card_compile_time_space(n_sms), **common)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = read_launches()
    calls = {k: runtime.meta["calls"].get(k, 0) + csr_only.meta["calls"].get(k, 0)
             for k in WRAPPERS}
    check_launches("tuner(dataset)", got, calls)
    for n, d in pool.items():
        shapes[n] = SimpleNamespace(n_rows=d.shape[0], n_cols=d.shape[1],
                                    nnz=int(np.count_nonzero(d)))
    ds = TuningDataset(runtime.records + csr_only.records, {
        **runtime.meta, **{k: {**runtime.meta[k], **csr_only.meta[k]}
                           for k in ("spread", "conversions", "retime", "overhead",
                                     "card_terms")}})
    path = Path(HERE) / "build" / "tuner" / "card_dataset.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    ds.save(path)
    ds = TuningDataset.load(path)
    # measure_formats, the reference's per-format protocol, times the kernels
    # on the card: warmup + reps launches per format its guard admits
    reset_launches()
    t0 = time.perf_counter()
    per_format = measure_formats(pool["rim"], reps=3, warmup=1, device=DEVICE)
    torch.cuda.synchronize()
    got_mf = read_launches()
    check_launches("tuner(measure_formats)", got_mf, {
        **{k: 0 for k in WRAPPERS},
        **{f: 4 for f, t in per_format.items() if np.isfinite(t)}})
    measured = [r for r in ds.records if is_measured(r)]
    secs = {k: runtime.meta["seconds"][k] + csr_only.meta["seconds"][k]
            for k in runtime.meta["seconds"]}
    per_fmt = {}
    for r in measured:
        per_fmt[r.config.fmt] = per_fmt.get(r.config.fmt, 0) + 1
    bell = {}  # block heights the true storage guard admits, per matrix
    for r in measured:
        if r.config.fmt == "bell":
            row = bell.setdefault(r.matrix, {"admitted": set(), "refused": set()})
            row["admitted" if r.feasible else "refused"].add(min(r.config.schedule.rows_per_block, 256))
    retimed = {}
    for m, rt in ds.meta["retime"].items():
        label = ds.best_record(m, "latency", formats=("csr",)).config
        first = TuningDataset(ds.for_matrix(m), {"spread": ds.meta["spread"]}).best_record(
            m, "latency", formats=("csr",)).config
        retimed[m] = {"candidates": len(rt["candidates"]), "calls": rt["calls"],
                      "seconds": rt["seconds"], "spread": rt["spread"],
                      "csr_label": sched_tag(label.schedule) + "_" + label.schedule.x_residency,
                      "first_pass_csr_label": sched_tag(first.schedule) + "_"
                      + first.schedule.x_residency}
    report = {
        "matrices": {"runtime_space": list(pool), "csr_space": list(TUNER_CSR_PRESETS)},
        "points": len(measured), "points_by_format": per_fmt,
        "distinct_launches": len({(r.matrix, r.config) for r in measured}),
        "infeasible_points": sum(not r.feasible for r in measured),
        "reference_space_points": space_size(),
        "csr_points_per_matrix": len(card_compile_time_space(n_sms).points(
            shapes[next(iter(pool))])),
        "conversions": {**runtime.meta["conversions"], **csr_only.meta["conversions"]},
        "reps": TUNER_REPS, "calls": calls, "launches": got, "seconds": secs, "wall_s": wall,
        "spread": ds.meta["spread"], "y_vs_plain": errs, "file_bytes": path.stat().st_size,
        "bell": {m: {k: sorted(v) for k, v in row.items()} for m, row in bell.items()},
        "bell_launches": calls["bell"], "retime": retimed, "overhead": ds.meta["overhead"],
        "measure_formats": {"matrix": "rim", "ms": {f: 1e3 * t for f, t in per_format.items()},
                            "launches": got_mf, "seconds": time.perf_counter() - t0}}
    return ds, report


def card_model_pick(ds, matrix: str, profile) -> TuningConfig:
    """The card cost model's pick among a matrix's CSR points: its least
    latency under ``profile`` from the launches' regressors the collection
    kept (``meta["card_terms"]``), ties by ``tie_order``."""
    terms = {config_of(json.loads(k)): x for k, x in ds.meta["card_terms"][matrix]}
    return min((c for c in terms if c.fmt == "csr"),
               key=lambda c: (profile.seconds("csr", terms[c]), tie_order(c)))


def profile_quality(ds, profile) -> dict:
    """Per format: points, and the median and 90th percentile of |modelled /
    measured - 1| over the measured points."""
    errs = {}
    for m, by_point in ds.meta["card_terms"].items():
        measured = {r.config: r.latency for r in ds.for_matrix(m) if is_measured(r) and r.feasible}
        for k, x in by_point:
            c = config_of(json.loads(k))
            if c in measured and profile.of(c.fmt) is not None:
                errs.setdefault(c.fmt, []).append(
                    abs(profile.seconds(c.fmt, x) / measured[c] - 1.0))
    return {f: {"points": len(v), "median": float(np.median(v)),
                "p90": float(np.percentile(v, 90))} for f, v in errs.items()}


def tuner_labels(ds, ref_tuner, card_tuner, shapes: dict) -> dict:
    """17(c): per matrix the default schedule's measured time, the measured
    best (the re-timed label), a ``decision_tree`` predictor's pick fitted
    leaving the matrix out, the reference-equal cost-model tuner's pick, the
    card cost model's pick (its constants fitted leaving the matrix out:
    ``fit_card_profile``), the card-labelled tuner's (``build_tuner()`` on
    the card, which learns its ``TUNER_NAMES`` at the served size too),
    each at its point of the card's CSR space; per-knob accuracy and the
    ratios between them, the built tuner's over all 16 matrices, over
    ``TUNER_NAMES`` (in sample) and over the rest (held out). The ratios
    ``*_over_best`` divide
    first-pass times by the label's, which the tie rule may pick up to the
    in-turn spread above the fastest point (so they can fall below 1);
    ``over_fastest_in_turns`` divides each pick's in-turn time (its
    first pass's where it was not re-timed) by the least in-turn median."""
    csr_space = card_compile_time_space(sm_count(DEVICE))
    default = TuningConfig("csr", DEFAULT_SCHEDULE)
    rows, hits = [], {k: 0 for k in ALL_KNOBS}
    tag = lambda c: sched_tag(c.schedule) + "_" + c.schedule.x_residency
    for m in ds.matrices:
        feats = ds.for_matrix(m)[0].features
        best = ds.best_record(m, "latency", formats=("csr",))
        t0 = time.perf_counter()
        held = TuningDataset([r for r in ds.records if r.matrix != m], ds.meta)
        pred = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=TUNER_LOO_SAMPLES,
                                                 device=DEVICE)).fit(held)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = card_model_pick(ds, m, fit_card_profile(ds, exclude=(m,)))
        card_fit_s = time.perf_counter() - t0
        picked = csr_space.point_of(shapes[m], TuningConfig(
            "csr", pred.predict_schedule(feats, "latency")))
        model = csr_space.point_of(shapes[m], TuningConfig(
            "csr", ref_tuner.plan_compile_time(feats, "latency").schedule))
        served = csr_space.point_of(shapes[m], TuningConfig(
            "csr", card_tuner.plan_compile_time(feats, "latency").schedule))
        t_def, t_best = measured_at(ds, m, default), best.latency
        turns = {k: 1e3 * in_turns_at(ds, m, c) for k, c in (
            ("default", default), ("best", best.config), ("loo", picked), ("model", model),
            ("card_model", card), ("card_tuner", served))}
        for knob in ALL_KNOBS:
            field_ = KNOBS[knob][0]
            hits[knob] += getattr(picked.schedule, field_) == getattr(best.config.schedule, field_)
        rows.append({"matrix": m, "default_ms": 1e3 * t_def, "best_ms": 1e3 * t_best,
                     "best": tag(best.config), "loo_ms": 1e3 * measured_at(ds, m, picked),
                     "loo": tag(picked), "model_ms": 1e3 * measured_at(ds, m, model),
                     "model": tag(model), "card_model_ms": 1e3 * measured_at(ds, m, card),
                     "card_model": tag(card),
                     "card_tuner_ms": 1e3 * measured_at(ds, m, served), "card_tuner": tag(served),
                     "in_sample": m in TUNER_NAMES,
                     "fastest_ms": 1e3 * fastest_in_turns(ds, m), "turns_ms": turns,
                     "spread": ds.meta["spread"][m],
                     "beyond_spread": t_def > t_best * (1.0 + ds.meta["spread"][m]),
                     "fit_s": fit_s, "card_fit_s": card_fit_s})
    def ratios(num, den, of=rows):
        r = np.array([row[num] / row[den] for row in of])
        return {"geomean": float(np.exp(np.log(r).mean())), "max": float(r.max())}

    def three_ways(num):  # all 16, build_tuner()'s names, the rest
        return {"all": ratios(num, "best_ms"),
                "in_sample": ratios(num, "best_ms", [r for r in rows if r["in_sample"]]),
                "held_out": ratios(num, "best_ms", [r for r in rows if not r["in_sample"]])}

    def over_fastest(key):  # in-turn times where there are any, over the fastest
        r = np.array([row["turns_ms"][key] / row["fastest_ms"] for row in rows])
        return {"geomean": float(np.exp(np.log(r).mean())), "min": float(r.min()),
                "max": float(r.max())}
    return {"matrices": rows, "knob_accuracy": {k: hits[k] / len(rows) for k in ALL_KNOBS},
            "card_knobs": list(CARD_KNOBS),
            "default_over_best": ratios("default_ms", "best_ms"),
            "default_over_loo": ratios("default_ms", "loo_ms"),
            "loo_over_best": ratios("loo_ms", "best_ms"),
            "model_over_best": ratios("model_ms", "best_ms"),
            "card_model_over_best": ratios("card_model_ms", "best_ms"),
            "card_tuner_over_best": three_ways("card_tuner_ms"),
            "in_sample": [r["matrix"] for r in rows if r["in_sample"]],
            "default_over_model": ratios("default_ms", "model_ms"),
            "over_fastest_in_turns": {k: over_fastest(k) for k in (
                "default", "best", "loo", "model", "card_model", "card_tuner")},
            "beyond_spread": sum(r["beyond_spread"] for r in rows),
            "best_bf16": sum(r["best"].endswith(("bf16_vmem", "bf16_stream")) for r in rows),
            "best_stream": sum(r["best"].endswith("_stream") for r in rows)}


def tuner_sell_bf16(pool: dict) -> dict:
    """17(f): B3 at fp32 and bf16 where one thread of a row sums ~300
    products, through the launch helper (the wrapper's counter does not
    move): y against the plain version, two launches bit for bit, and its
    time (CUDA events, L2 flushed). A y beyond its tolerance, or two
    launches that differ, fail."""
    rng = np.random.default_rng(SEED + 176)
    rows = []
    for name, base in TUNER_B3_CASES:
        dense = pool[name]
        n = dense.shape[0]
        x = torch.as_tensor(rng.normal(size=dense.shape[1]).astype(np.float32), device=DEVICE)
        mat = prepare(dense, "sell", base, device=DEVICE)  # the accumulator shapes no storage
        for acc in ("float32", "bfloat16"):
            sched = base.replace(accum_dtype=acc)
            n_slices = mat.slice_width.shape[0]
            plan = sell_launch_plan(n_slices, mat.C, mat.data.shape[0] / (n_slices * mat.C),
                                    sm_count(DEVICE))
            args = (mat.data, mat.cols, mat.slice_ptr, mat.slice_width, x)
            b3 = lambda: _sell_launch(*args, mat.C, plan, sched)  # noqa: E731
            plain = sell_spmv_plain(*args, mat.C, sched).reshape(-1)[:n]
            y, again = b3().reshape(-1)[:n], b3().reshape(-1)[:n]
            err = float((y - plain).abs().max() / (plain.abs().max() + 1e-9))
            row = {"matrix": name, "schedule": sched_tag(sched), "row_threads": plan["row_threads"],
                   "err_vs_plain": err, "tol": tol_of(sched),
                   "bit_identical": bool(torch.equal(y, again)), "ms": timed(b3)}
            rows.append(row)
            if not row["bit_identical"] or err > tol_of(sched):
                raise AssertionError(f"tuner: B3 where a thread sums a long row: {row}")
        del mat
    return {"cases": rows}


def b1_in_turns(mat, x: torch.Tensor, before: KernelSchedule, after: KernelSchedule,
                rounds: int = 2) -> dict:
    """B1 (the wrapper) at two schedules on one CSR, in turns (before,
    after, after, before), CUDA events, L2 flushed."""
    args = (mat.data, mat.indices, mat.indptr, x)
    got = {"before": [], "after": []}
    for _ in range(rounds):
        for which in ("before", "after", "after", "before"):
            s = before if which == "before" else after
            got[which].append(timed(lambda: csr_spmv(*args, s)))
    return {"before": sched_tag(before) + "_" + before.x_residency,
            "after": sched_tag(after) + "_" + after.x_residency,
            "before_ms": float(np.median(got["before"])),
            "after_ms": float(np.median(got["after"])), "runs_ms": got}


def b1_carveout() -> dict:
    """The carveout each B1 instance asked of the driver last (percent of the
    SM's shared memory; -1: the driver's own choice, or never launched):
    rows-only and chunk kernels, per accumulator and unroll."""
    out = {}
    fn = kbuild.bind("spmv_csr", "spmv_csr_carveout",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    for kind, kname in ((0, "rows"), (1, "chunk")):
        for acc in (0, 1):
            for u in B1_UNROLLS:
                v = ctypes.c_int(-1)
                kbuild.check_launch(fn(kind, acc, u, ctypes.byref(v)), "spmv_csr_carveout")
                out[f"{kname}_{'bf16' if acc else 'f32'}_{u}"] = v.value
    return out


def force_carveout(pct: int) -> None:
    """Make every B1 launch ask for carveout ``pct`` (-1: the driver's own
    choice; -2: the schedule's again), for measurement."""
    fn = kbuild.bind("spmv_csr", "spmv_csr_force_carveout", [ctypes.c_int])
    kbuild.check_launch(fn(pct), "spmv_csr_force_carveout")


def tuner_carveout(pool: dict, web: np.ndarray, csr_schedule, web_schedule) -> dict:
    """17(a): B1's x_residency, the SM's L1 / shared split, at
    ``human_gene2`` and ``webgraph`` at phase 1's schedules and at unroll
    8 / 1 in fp32: "vmem" (the least shared memory that keeps B1's CTAs
    per SM), "stream" (the most), and forced to the least shared memory
    (0 %) and to the driver's own choice (no preference, as B1 launched
    before the knob), in turns (CUDA events, L2 flushed); y the same bits
    in all four; the carveout each asked for."""
    rng = np.random.default_rng(SEED + 170)
    arms = (("driver", -1, "vmem"), ("vmem", -2, "vmem"), ("stream", -2, "stream"),
            ("least_shared", 0, "vmem"))
    rows = []
    for name, dense, scheds in (
            ("human_gene2", pool["human_gene2"],
             (csr_schedule, KernelSchedule(rows_per_block=8, unroll=8), DEFAULT_SCHEDULE)),
            (f"webgraph@{web.shape[0]}", web, (web_schedule, DEFAULT_SCHEDULE))):
        mat = prepare(dense, "csr", DEFAULT_SCHEDULE, device=DEVICE)
        x = torch.as_tensor(rng.normal(size=dense.shape[1]).astype(np.float32), device=DEVICE)
        args = (mat.data, mat.indices, mat.indptr, x)
        for s in scheds:
            plan = csr_launch_plan(dense.shape[0], mat.nnz, s.rows_per_block, s.unroll,
                                   sm_count(DEVICE), n_cols=dense.shape[1])
            instance = (f"{'chunk' if plan['hub_ctas'] else 'rows'}_"
                        f"{'bf16' if s.accum_dtype == 'bfloat16' else 'f32'}_{s.unroll}")
            ms, pct, ys = {a[0]: [] for a in arms}, {}, {}
            try:
                for rnd in range(TUNER_CARVE_ROUNDS):
                    for arm, force, xr in (arms if rnd % 2 == 0 else arms[::-1]):
                        force_carveout(force)
                        ms[arm].append(timed(lambda: csr_spmv(*args, s.replace(x_residency=xr))))
                        ys[arm] = csr_spmv(*args, s.replace(x_residency=xr))
                        torch.cuda.synchronize()
                        pct[arm] = b1_carveout()[instance]
            finally:
                force_carveout(-2)
            med = {a: float(np.median(v)) for a, v in ms.items()}
            rows.append({"matrix": name, "schedule": sched_tag(s), "instance": instance,
                         "median_ms": med, "runs_ms": ms, "carveout_pct": pct,
                         "stream_over_vmem": med["stream"] / med["vmem"],
                         "vmem_over_driver": med["vmem"] / med["driver"],
                         "least_shared_over_vmem": med["least_shared"] / med["vmem"],
                         "same_bits": all(torch.equal(ys[a], ys["vmem"]) for a in ys)})
            if not rows[-1]["same_bits"]:
                raise AssertionError(f"tuner: B1's carveout changed y: {rows[-1]}")
        del mat
    return {"rows": rows}


def tuner_serve(card_tuner, pool: dict, web: np.ndarray, fps: dict,
                csr_schedule, web_schedule) -> tuple[dict, dict]:
    """17(d): compile-time mode through ``AutoSpmvSession.serve_optimize``
    with the card-fitted tuner: ``TUNER_SERVE`` requests each of
    ``human_gene2`` and ``webgraph``, B1 launches = requests, y against
    float64; then B1 at the served schedule against phase 1's, in turns."""
    session = AutoSpmvSession(card_tuner)
    rng = np.random.default_rng(SEED + 171)
    cases = (("human_gene2", pool["human_gene2"], fps["human_gene2"], csr_schedule),
             (f"webgraph@{web.shape[0]}", web, matrix_fingerprint(web), web_schedule))
    reset_launches()
    served = []
    for name, dense, fp, _ in cases:
        for i in range(TUNER_SERVE):
            x = rng.normal(size=dense.shape[1]).astype(np.float32)
            plan = session.serve_optimize(dense, "latency", fingerprint=fp)
            y = plan.kernel(x).cpu().numpy()
            err, tol = scaled_err(y, host_product(dense, x)), tol_of(plan.schedule)
            served.append({"matrix": name, "request": i, "format": plan.fmt,
                           "schedule": sched_tag(plan.schedule) + "_" + plan.schedule.x_residency,
                           "hit": plan.cache_hit, "err": err, "tol": tol})
            if plan.fmt != "csr" or not (np.isfinite(y).all() and err <= tol):
                raise AssertionError(f"tuner: served request wrong: {served[-1]}")
    torch.cuda.synchronize()
    got = read_launches()
    check_launches("tuner(serve)", got, {**{k: 0 for k in WRAPPERS},
                                         "csr": TUNER_SERVE * len(cases)})
    timings = []
    for name, dense, fp, before in cases:
        after = session.tuner.plan_compile_time(extract_features(dense), "latency").schedule
        mat = prepare(dense, "csr", DEFAULT_SCHEDULE, device=DEVICE)
        x = torch.as_tensor(rng.normal(size=dense.shape[1]).astype(np.float32), device=DEVICE)
        row = b1_in_turns(mat, x, before, after)
        row["matrix"] = name
        timings.append(row)
        del mat
    return {"requests": served, "launches": got, "session": session.stats.as_dict(),
            "b1_in_turns": timings}, got


def tuner_runtime(card_tuner, ref_tuner, ds, pool: dict, fps: dict,
                  tiny: list) -> tuple[dict, dict]:
    """17(e): run-time mode over the pool with the card-fitted tuner, its
    format against the reference-equal tuner's, each §5.3 decision with its
    gain, its overhead in seconds and its conversion's predicted and
    measured seconds (measured: the collection's conversion of the default
    geometry at this size, ``meta["overhead"]``). Two predictors side by
    side, each in sample and fitted with the matrix's served-size sample
    left out (the graded figures): the card tuner's ``CardOverheadPredictor``
    (``build_tuner()``'s samples at its scale, ``tiny``, and every served-size
    sample of the collection) and the reference's ``OverheadPredictor`` on
    the served-size samples it can learn from (``tuner_overhead_samples``,
    the card tuner's predictor before ``CardOverheadPredictor``); the
    feature pass likewise. Converted
    kernels against float64."""
    session = AutoSpmvSession(card_tuner)
    rng = np.random.default_rng(SEED + 172)
    reset_launches()
    rows = []
    conversions, feature_pass = [], []
    samples, ref_samples = overhead_samples(ds), tuner_overhead_samples(ds)
    ref_in = OverheadPredictor().fit(ref_samples)
    for n, dense in pool.items():
        feats = extract_features(dense)
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        card_loo = CardOverheadPredictor().fit(tiny + [s_ for s_ in samples if s_.matrix != n])
        ref_loo = OverheadPredictor().fit([s_ for s_ in ref_samples if s_.matrix != n])
        by = {"card_s": card_tuner.overhead, "card_loo_s": card_loo, "ref_s": ref_in,
              "ref_loo_s": ref_loo}
        for fmt, secs in ds.meta["overhead"][n]["conversion_s"].items():
            if secs is not None:
                conversions.append({"matrix": n, "format": fmt, "measured_s": secs,
                                    **{k: p.predict_c(feats, fmt) for k, p in by.items()}})
        feature_pass.append({"matrix": n, "measured_s": ds.meta["overhead"][n]["features_s"],
                             **{k: p.predict_f(feats) for k, p in by.items()}})
        for obj in OBJECTIVES:
            theirs = ref_tuner.plan_run_time(feats, obj)
            ours = card_tuner.plan_run_time(feats, obj)
            row = {"matrix": n, "objective": obj, "format": ours.best_format,
                   "model_format": theirs.best_format, "agree": ours.best_format == theirs.best_format,
                   "latency_gain_s": ours.latency_gain_per_iter,
                   "model_latency_gain_s": theirs.latency_gain_per_iter,
                   "gain_10k_s": 10_000 * ours.latency_gain_per_iter,
                   "overhead_s": ours.overhead_s, "conversion_s": ours.convert_overhead_s,
                   "measured_conversion_s": ds.meta["overhead"][n]["conversion_s"].get(
                       ours.best_format)}
            try:
                res = session.run_time_optimize(dense, obj, n_iterations=10_000,
                                                fingerprint=fps[n])
            except InfeasibleConfig as exc:
                row["infeasible"] = str(exc)[:120]
                rows.append(row)
                continue
            row["convert"] = res.convert
            if res.kernel is not None:
                y = res.kernel(x).cpu().numpy()
                row["kernel"] = type(res.kernel.mat).__name__.lower()
                row["err"] = scaled_err(y, host_product(dense, x))
                if row["err"] > tol_of(res.kernel.schedule):
                    raise AssertionError(f"tuner: run-time kernel wrong: {row}")
            rows.append(row)
    torch.cuda.synchronize()
    got = read_launches()
    want = {k: 0 for k in WRAPPERS}
    for r in rows:
        if "kernel" in r:
            want[r["kernel"]] += 1
    check_launches("tuner(runtime)", got, want)

    def graded(key, of):  # predicted / measured; the left-out figures are the graded ones
        r = [c[key] / c["measured_s"] for c in of]
        worst = max(range(len(r)), key=lambda i: abs(np.log(max(r[i], 1e-12))))
        return {"median": float(np.median(r)), "worst": r[worst],
                "worst_at": [of[worst]["matrix"], of[worst].get("format", "features")],
                "within_2x": sum(0.5 <= v <= 2.0 for v in r),
                "within_4x": sum(0.25 <= v <= 4.0 for v in r), "of": len(r),
                "outside_4x": [[c["matrix"], c.get("format", "features"), v]
                               for c, v in zip(of, r) if not 0.25 <= v <= 4.0],
                "zero": sum(c[key] <= 0.0 for c in of)}
    keys = ("card_loo_s", "card_s", "ref_loo_s", "ref_s")
    return {"decisions": rows, "agree": sum(r["agree"] for r in rows), "of": len(rows),
            "converted": sum(bool(r.get("convert")) for r in rows), "launches": got,
            "conversions": conversions, "feature_pass": feature_pass,
            "predicted_over_measured": {k: graded(k, conversions) for k in keys},
            "feature_pass_predicted_over_measured": {k: graded(k, feature_pass) for k in keys},
            "overhead_samples": {"card": [s_.matrix for s_ in tiny + samples],
                                 "reference": [s_.matrix for s_ in ref_samples]}}, got


def tuner_overhead_samples(ds) -> list:
    """The collection's §5.3 samples at the served size that carry the
    conversions run-time mode weighs (CSR, ELL, SELL): a pool matrix whose
    default ELL the guard refuses, and the presets (CSR only), are left
    out, since ``OverheadPredictor.fit`` learns the formats every sample
    has; BELL, refused at its default block height on every pool matrix,
    takes the predictor's fallback (the dearest format's prediction)."""
    return [s_ for s_ in overhead_samples(ds) if {"csr", "ell", "sell"} <= set(s_.c_latency)]


def scale_overhead_samples() -> list:
    """``build_tuner()``'s §5.3 samples at its ``scale``: the tiny training
    matrices' feature passes and conversions, on the card."""
    return [measure_overheads(generate_by_name(n, scale=TUNER_SCALE), n, device=DEVICE)
            for n in TUNER_NAMES]


def run_tuner_phase(tuner, pool: dict, web: np.ndarray, fps: dict,
                    csr_schedule, web_schedule) -> tuple[dict, dict]:
    """Phase 17: the tuner learns the card. (a) B1's carveout knob, (b) the
    card's dataset (BELL by its true storage, the candidates re-timed in
    turns, the §5.3 overhead at the served size), (c) the labels against
    the default, the reference-equal and the card cost models and
    leave-one-out, (d) compile-time serving with the card-fitted tuner, (e)
    run-time mode with it, (f) B3's bf16 sums where a thread sums a long
    row. ``tuner`` is ``build_tuner()`` on the card (labelled by
    ``CardCostModel``, at its scale and at the served size). Returns
    (payload, launches of the served paths (d) and (e))."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["carveout"] = tuner_carveout(pool, web, csr_schedule, web_schedule)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shapes = {}
    ds, out["dataset"] = tuner_dataset(pool, shapes)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_tuner = build_tuner(model=CostModel())  # the reference-equal labels, on the card
    profile = fit_card_profile(ds, source="this run's phase 17(b)")
    out["card_profile"] = {"terms": list(CARD_TERMS), "coef": dict(profile.coef),
                           "fit_quality": profile_quality(ds, profile),
                           "committed_quality": profile_quality(ds, CardCostModel().profile)}
    out["labels"] = tuner_labels(ds, ref_tuner, tuner, shapes)
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = AutoSpmvPredictor(PredictorConfig(max_regressor_samples=1500, device=DEVICE)).fit(ds)
    tiny = scale_overhead_samples()
    overhead = CardOverheadPredictor().fit(tiny + overhead_samples(ds))
    card_tuner = AutoSpMV(pred, overhead, device=DEVICE, dataset=ds,
                          cost_model=CardCostModel(profile))
    out["fit_s"] = time.perf_counter() - t0
    out["serve"], got = tuner_serve(card_tuner, pool, web, fps, csr_schedule, web_schedule)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["runtime"], got_rt = tuner_runtime(card_tuner, ref_tuner, ds, pool, fps, tiny)
    secs["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sell_bf16"] = tuner_sell_bf16(pool)
    secs["f"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    return out, {k: got[k] + got_rt[k] for k in got}


# ---------------------------------------------------------------- examples
def load_example(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_figures(name: str, out) -> list[dict]:
    """The correctness figures an example prints, each with its tolerance:
    a kernel's y against the dense product (scaled by max |y|: 1e-4 at
    fp32, 3e-2 at bf16 accumulation), the sparse-served decode logits
    against the dense (scaled by max |logit|: 1e-4 in fp32 compute, 3e-2 in
    bf16), training's losses (finite)."""
    if name == "torch_quickstart":
        figs = [{"what": "compile-time csr", "err": out["kernel_err"],
                 "tol": tol_of(out["schedule"]), "schedule": sched_tag(out["schedule"])}]
        if out["converted"] is not None:
            c = out["converted"]
            figs.append({"what": f"converted {c['format']}", "err": c["err"],
                         "tol": tol_of(c["schedule"]), "schedule": sched_tag(c["schedule"])})
        return figs
    if name == "torch_autotune_formats":
        return [{"what": f"{row['matrix']} {c['format']}", "err": c["err"],
                 "tol": tol_of(c["schedule"]), "schedule": sched_tag(c["schedule"])}
                for row, c in zip(out["rows"], out["checks"])]
    if name == "torch_serve_lm":
        n = out["numerics"]
        return [{"what": "sparse vs dense decode logits", "compute": n["compute_dtype"],
                 "max_abs_diff": n["max_abs_diff"],
                 "err": n["max_abs_diff"] / (n["max_abs_logit"] + 1e-9),
                 "tol": 1e-4 if n["compute_dtype"] == "float32" else 3e-2}]
    losses = [h["loss"] for h in out.history]
    return [{"what": "training losses", "first": losses[0], "last": losses[-1],
             "err": 0.0 if np.isfinite(losses).all() else float("inf"), "tol": 0.0}]


def run_examples_phase() -> tuple[dict, dict]:
    """Phase 18: each of ``examples/torch_*.py`` through its ``main(argv)``
    on the card (``EXAMPLE_ARGS``), its printed lines captured: seconds,
    launches per kernel, the correctness figures it prints against their
    tolerances. The three SpMV and LM-serving examples must launch at least
    one of B1-B8; training launches none. Returns (payload, launches)."""
    out, total = {}, {k: 0 for k in WRAPPERS}
    with tempfile.TemporaryDirectory(prefix="examples-") as tmp:
        for name, argv in EXAMPLE_ARGS.items():
            if name == "torch_train_lm":
                argv = [*argv, "--ckpt-dir", os.path.join(tmp, "train_lm")]
            mod = load_example(name)
            printed = io.StringIO()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                res = mod.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = read_launches()
            figs = example_figures(name, res)
            row = {"argv": argv, "seconds": secs, "launches": got, "figures": figs,
                   "printed": printed.getvalue().splitlines()}
            out[name] = row
            if not all(np.isfinite(f["err"]) and f["err"] <= f["tol"] for f in figs):
                raise AssertionError(f"examples: {name} out of tolerance: {row}")
            if (sum(got.values()) == 0) != (name == "torch_train_lm"):
                raise AssertionError(f"examples: {name} launched {got}")
            for k in total:
                total[k] += got[k]
    return out, total


def main() -> None:
    t_all = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc_version = run([kbuild.find_nvcc(), "--version"]).splitlines()[-2:]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc_version, card=smi,
         device=torch.cuda.get_device_name(0))

    # nvcc runs in its own processes: the inputs are made while they build
    with concurrent.futures.ThreadPoolExecutor(1) as building:
        build_job = building.submit(kbuild.build_all)
        t0 = time.perf_counter()
        pool = make_pool()
        extra = {BELL_MATRIX: make_bell_matrix(), "hetero": make_hetero(),
                 "webgraph": generate_by_name("webgraph", scale=WEB_SCALE)}
        fps = {n: matrix_fingerprint(d) for n, d in pool.items()}
        emit("inputs", seconds=time.perf_counter() - t0, while_building=True,
             pool={n: {"shape": list(d.shape), "nnz": int((d != 0).sum())}
                   for n, d in {**pool, **extra}.items()})
        built = build_job.result()
    ptxas = {n: [{"kernel": k["function"][:60], "registers": k["registers"],
                  "spill_bytes": k["spill_bytes"]} for k in kbuild.ptxas_usage(log)]
             for n, log in built["log"].items()}
    emit("build", seconds=built["seconds"], built=built["built"],
         dir=os.path.relpath(str(kbuild.build_dir()), HERE), ptxas=ptxas,
         plan_constants=check_constants())
    registers = {n: sorted({k["registers"] for k in ks}) for n, ks in ptxas.items()}

    # ---- every kernel against its plain version, and its times ----------
    t0 = time.perf_counter()
    tuner = build_tuner()  # device=None: the card
    tuner_s = time.perf_counter() - t0
    # the schedule compile-time mode will serve human_gene2's CSR kernel with
    csr_schedule = tuner.plan_compile_time(
        extract_features(pool["human_gene2"]), "latency"
    ).schedule
    # ... and the one the solvers' iterations run on webgraph (fp32 forced)
    web_schedule = tuner.plan_compile_time(
        extract_features(extra["webgraph"]), "latency"
    ).schedule.replace(accum_dtype="float32")
    t0 = time.perf_counter()
    checked = {}
    # the BCSR storage is checked through its FormatSpec directly; the format
    # is registered only in phase 7, so phases 4-6 decide as before
    import repro_torch.sparse.bcsr as bcsr_plugin

    unregister_format("bcsr")
    for fmt in KERNEL_ORDER:
        if fmt == "spmm":
            continue  # checked in its own phase, on the LM's FFN matrices
        if fmt == "spmspv":
            checked[fmt] = check_spmspv(extra["webgraph"], web_schedule)
        else:
            name = CHECK_MATRIX[fmt]
            sched = csr_schedule if fmt == "csr" else DEFAULT_SCHEDULE
            checked[fmt] = check_kernel(fmt, name, {**pool, **extra}[name], sched)
        if fmt == "csr":  # the solve path's matrix too: hub rows
            web = extra["webgraph"]
            checked[fmt]["at_webgraph"] = check_kernel(fmt, f"webgraph@{web.shape[0]}", web,
                                                       web_schedule)
            checked[fmt]["hub_row_bf16"] = b1_hub_bf16(web)
        checked[fmt]["registers"] = registers.get(SOURCE[fmt])
        if fmt in INSTANCE:
            checked[fmt]["registers_by_instance"] = kernel_registers(
                built["log"], SOURCE[fmt], INSTANCE[fmt])
        if fmt == "csr":  # [registers, spill bytes] of the instances phase 4 serves
            served = (f"{'bf16' if csr_schedule.accum_dtype == 'bfloat16' else 'f32'}_"
                      f"{csr_schedule.unroll}")
            checked[fmt]["registers_served"] = {
                k: v for k, v in checked[fmt]["registers_by_instance"].items()
                if k.endswith(served)}
    torch.cuda.empty_cache()
    emit("check", seconds=time.perf_counter() - t0, tuner_seconds=tuner_s,
         tuner_served=tuner.dataset.meta["served"], tuner_overhead=type(tuner.overhead).__name__,
         kernels={f: {k: e[k] for k in ("matrix", "schedule", "max_abs_err", "ms")}
                  for f, e in checked.items()},
         sell_launch=checked["sell"].pop("launch"),
         ell_launch=checked["ell"].pop("launch"),
         fused_launch=checked["fused"].pop("launch"),
         csr_launch={checked["csr"]["matrix"]: checked["csr"].pop("launch"),
                     checked["csr"]["at_webgraph"]["matrix"]:
                         checked["csr"]["at_webgraph"].pop("launch")})

    # ---- serve: the main path, compile-time mode (CSR kernel) -----------
    session = AutoSpmvSession(tuner)
    server = SpmvServer(session)
    rng = np.random.default_rng(SEED)
    names = [str(rng.choice(POOL)) for _ in range(N_REQUESTS)]
    names[0] = "human_gene2"  # the published-size matrix is always served
    reqs = []
    for i, n in enumerate(names):
        x = rng.normal(size=pool[n].shape[1]).astype(np.float32)
        reqs.append(SpmvRequest(rid=i, dense=pool[n], x=x, objective="latency"))
    reset_launches()
    with tracing() as tracer:
        tracer.clear()
        t0 = time.perf_counter()
        server.run(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        by_name = span_totals(tracer.spans())
    launches = read_launches()
    served = []
    for r, n in zip(reqs, names):
        ref = host_product(r.dense, r.x)
        err, tol = scaled_err(r.y, ref), tol_of(r.schedule)
        ok = r.y.shape == ref.shape and bool(np.isfinite(r.y).all()) and err <= tol
        served.append({"rid": r.rid, "matrix": n, "hit": r.cache_hit, "err": err,
                       "tol": tol, "schedule": sched_tag(r.schedule)})
        if not ok:
            raise AssertionError(f"served request {r.rid} ({n}) wrong: err {err:.3e} > {tol:.0e}")
    stats = session.stats.as_dict()
    if launches["csr"] != N_REQUESTS:
        raise AssertionError(f"CSR kernel launched {launches['csr']} times for {N_REQUESTS} requests")
    if not (stats["plans_computed"] < N_REQUESTS and stats["kernel_compiles"] < N_REQUESTS):
        raise AssertionError(f"no amortisation: {stats}")
    spans = server.summary()
    emit("serve", seconds=serve_s, requests=served,
         session=stats, launches=launches, latency=spans.get("latency"),
         span_seconds={k: v["total_s"] for k, v in by_name.items()},
         span_counts={k: v["count"] for k, v in by_name.items()})
    if reqs[0].schedule != csr_schedule:
        raise AssertionError(
            f"human_gene2 was served with {reqs[0].schedule}, timed at {csr_schedule}"
        )

    # ---- run-time mode: format choice + ELL / SELL / BELL kernels --------
    reset_launches()
    t0 = time.perf_counter()
    decisions = []
    rng = np.random.default_rng(SEED + 1)
    for n, dense in pool.items():
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        ref = None
        for obj in OBJECTIVES:
            try:
                res = session.run_time_optimize(
                    dense, obj, n_iterations=10_000, fingerprint=fps[n]
                )
            except InfeasibleConfig as exc:
                # the chosen format's storage guard refused this matrix while
                # converting: the reference behaves the same; reported as is
                decisions.append({"matrix": n, "objective": obj, "infeasible": str(exc)})
                continue
            row = {"matrix": n, "objective": obj, "format": res.best_format,
                   "gain_per_iter": res.predicted_gain_per_iter,
                   "overhead_s": res.predicted_overhead, "convert": res.convert}
            if res.kernel is not None:
                ref = host_product(dense, x) if ref is None else ref
                y = res.kernel(x).cpu().numpy()
                row["err"] = scaled_err(y, ref)
                if row["err"] > tol_of(res.kernel.schedule):
                    raise AssertionError(f"run-time kernel wrong: {row}")
            decisions.append(row)
    direct = []
    infeasible_ok = {("bell", "pkustk04"), ("bell", "human_gene2")}
    for fmt, n in (("ell", "rim"), ("sell", "rim"), ("bell", BELL_MATRIX),
                   ("bell", "pkustk04"), ("bell", "human_gene2")):
        dense = {**pool, **extra}[n]
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        try:
            kernel = compile_spmv(dense, fmt, DEFAULT_SCHEDULE, device=DEVICE)
        except InfeasibleConfig as exc:
            if (fmt, n) not in infeasible_ok:
                raise
            # BELL's storage at the default block height (64) exceeds the
            # guard's 512 MiB at n ~ 14,000 for these two; reported, not hidden
            direct.append({"format": fmt, "matrix": n, "infeasible": str(exc)})
            continue
        y = kernel(x).cpu().numpy()
        err = scaled_err(y, host_product(dense, x))
        direct.append({"format": fmt, "matrix": n, "err": err})
        if not (np.isfinite(y).all() and err <= 1e-4):
            raise AssertionError(f"compile_spmv({fmt}) on {n} wrong: err {err:.3e}")
        del kernel
    torch.cuda.synchronize()
    rt_launches = read_launches()
    for k in launches:
        launches[k] += rt_launches[k]
    emit("runtime_mode", seconds=time.perf_counter() - t0, decisions=decisions,
         direct=direct, launches=rt_launches, session=session.stats.as_dict())

    # ---- partitioned: sequential and fused composite serving --------------
    t0 = time.perf_counter()
    part_pool = {n: extra[n] if n == "hetero" else pool[n] for n in PART_POOL}
    rng = np.random.default_rng(SEED + 2)
    # every matrix once, then repeats
    names = list(PART_POOL) + [str(rng.choice(PART_POOL))
                               for _ in range(N_PART_REQUESTS - len(PART_POOL))]
    xs = [rng.normal(size=part_pool[n].shape[1]).astype(np.float32) for n in names]
    x_of = dict(zip(names, xs))  # one vector per matrix for the forced runs and timings
    part_session = AutoSpmvSession(tuner)
    pinned = pin_partitioned(part_session, part_pool[PINNED_MATRIX], FORCED_FORMATS)
    phase_launches = {}
    results = {}
    for fused in (False, True):
        server = SpmvServer(part_session, partition=True, max_blocks=MAX_BLOCKS, fused=fused)
        reset_launches()
        rows, blocks_served = serve_partitioned_requests(
            part_session, server, part_pool, names, xs, fused)
        torch.cuda.synchronize()
        got = read_launches()
        want = ({**{f: 0 for f in BLOCK_FORMATS}, "fused": N_PART_REQUESTS} if fused
                else {**blocks_served, "fused": 0})
        check_launches(f"partitioned(fused={fused})", got, want)
        if not fused and not (got["sell"] and got["bell"]):
            raise AssertionError(f"partitioned: the pinned plan launched no B3 or B4: {got}")
        results["fused" if fused else "sequential"] = rows
        phase_launches["fused" if fused else "sequential"] = got
    reset_launches()
    forced = run_forced(part_pool["hetero"], FORCED_FORMATS, x_of["hetero"])
    torch.cuda.synchronize()
    got = read_launches()
    check_launches("partitioned(forced)", got, {
        "fused": 1, **{f: FORCED_FORMATS.count(f) for f in BLOCK_FORMATS}})
    phase_launches["forced"] = got
    for got in phase_launches.values():
        for k in launches:
            launches[k] += got[k]
    part_stats = part_session.stats.as_dict()
    fps["hetero"] = matrix_fingerprint(part_pool["hetero"])
    composites = time_composites(part_session, part_pool, fps, x_of,
                                 kernel_registers(built["log"], SOURCE["fused"], INSTANCE["fused"]))
    checked["fused"]["at_composites"] = composites
    bell_at_full_width = [
        {"rid": r["rid"], "matrix": r["matrix"], "rows": r["bell_blocks"]}
        for r in results["sequential"] if r["bell_blocks"]]
    emit("partitioned", seconds=time.perf_counter() - t0, requests=results,
         forced=forced, pinned=pinned, bell_blocks=bell_at_full_width, launches=phase_launches,
         session=part_stats, composites=composites)

    # ---- B4 and B7 at the BELL block shape the partitioned path launches ---
    t0 = time.perf_counter()
    name, rows, sched, source = served_bell_block(part_session, results["sequential"],
                                                  part_pool, forced)
    case = check_block_case(name, rows, part_pool[name], sched, source)
    for fmt in BLOCK_KERNELS:
        checked[fmt]["partitioned_block"] = {
            **{k: case[k] for k in ("matrix", "rows", "source", "shape", "nnz", "schedule")},
            **case[fmt]}
    emit("block_case", seconds=time.perf_counter() - t0, **case)

    # ---- plugin: BCSR registered, run-time mode, direct, forced plan ------
    t0 = time.perf_counter()
    bcsr_plugin.register()
    # importing the plugin is the whole integration: a tuner built now has
    # BCSR in its tuning space, dataset and format classifier
    plug_session = AutoSpmvSession(build_tuner())
    reset_launches()
    plug_decisions = []
    for n, dense in pool.items():
        for obj in OBJECTIVES:
            try:
                res = plug_session.run_time_optimize(dense, obj, n_iterations=10_000,
                                                     fingerprint=fps[n])
            except InfeasibleConfig as exc:
                plug_decisions.append({"matrix": n, "objective": obj, "infeasible": str(exc)})
                continue
            row = {"matrix": n, "objective": obj, "format": res.best_format,
                   "convert": res.convert}
            if res.kernel is not None:
                x = rng.normal(size=dense.shape[1]).astype(np.float32)
                row["err"] = scaled_err(res.kernel(x).cpu().numpy(), host_product(dense, x))
                if row["err"] > tol_of(res.kernel.schedule):
                    raise AssertionError(f"run-time kernel wrong with BCSR registered: {row}")
            plug_decisions.append(row)
    plug_direct = []
    for n in (BELL_MATRIX, "pkustk04", "human_gene2"):
        dense = {**pool, **extra}[n]
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        try:
            kernel = compile_spmv(dense, "bcsr", DEFAULT_SCHEDULE, device=DEVICE)
        except InfeasibleConfig as exc:
            if n == BELL_MATRIX:
                raise
            # like BELL, the guard refuses BCSR at n ~ 14,000: reported, not hidden
            plug_direct.append({"format": "bcsr", "matrix": n, "infeasible": str(exc)})
            continue
        err = scaled_err(kernel(x).cpu().numpy(), host_product(dense, x))
        plug_direct.append({"format": "bcsr", "matrix": n, "err": err})
        if err > 1e-4:
            raise AssertionError(f"compile_spmv(bcsr) on {n} wrong: err {err:.3e}")
        del kernel
    plug_forced = run_forced(extra["hetero"], PLUGIN_FORMATS, x_of["hetero"])
    torch.cuda.synchronize()
    got = read_launches()
    if got["fused"] != 1 or got["bcsr"] < 2:
        raise AssertionError(f"plugin: fused/bcsr launches {got}")
    for k in launches:
        launches[k] += got[k]
    registry = format_names()
    unregister_format("bcsr")
    emit("plugin", seconds=time.perf_counter() - t0, registry=list(registry),
         bcsr_wins=[d for d in plug_decisions if d.get("format") == "bcsr"],
         decisions=plug_decisions, direct=plug_direct, forced=plug_forced,
         launches=got)

    # ---- solve: the iterative solvers, SpMV <-> SpMSpV (B1 and B6) --------
    t0 = time.perf_counter()
    with tracing():
        solved, got = run_solve_phase(tuner, extra["webgraph"], pool["rim"])
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("solve", seconds=time.perf_counter() - t0, **solved)

    # ---- lm: sparse LM serving of qwen3-0.6b at its published width (B1) --
    t0 = time.perf_counter()
    lm, got, tick = run_lm_phase(get_config(LM_ARCH))
    for k in launches:
        launches[k] += got[k]
    # most of B1's launches are the decode's: its numbers at those shapes too
    for key, row in zip(("at_lm_ffn", "at_lm_ffn_down"), lm["checks"]["b1_ffn"]):
        checked["csr"][key] = {k: v for k, v in row.items() if k != "launch"}
    torch.cuda.empty_cache()
    emit("lm", seconds=time.perf_counter() - t0, **lm)

    # ---- spmm: kernel B8 through ops.spmm, on rim and the LM's own FFNs ---
    t0 = time.perf_counter()
    checked["spmm"], got = run_spmm_phase(spmm_cases(pool["rim"], tick))
    checked["spmm"]["registers"] = registers.get(SOURCE["spmm"])
    checked["spmm"]["registers_by_instance"] = kernel_registers(
        built["log"], SOURCE["spmm"], INSTANCE["spmm"])
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("spmm", seconds=time.perf_counter() - t0, launches=got,
         launch=checked["spmm"].pop("launch"), cases=checked["spmm"]["cases"])

    # ---- observed: telemetry, calibration, SLO, watchdog, fleet (B1-B4) --
    t0 = time.perf_counter()
    observed, got = run_observed_phase(tuner, pool, part_pool, part_session.cache)
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("observed", seconds=time.perf_counter() - t0, **observed)

    # ---- zoo: every predictor family serves both modes (B1-B4) ----------
    t0 = time.perf_counter()
    zoo, got = run_zoo_phase(tuner, pool, fps)
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("zoo", seconds=time.perf_counter() - t0, launches=got, **zoo)

    # phase 16(d)'s dry runs start here, in subprocesses: they count on the
    # host's cores while phases 13-16(c) use the card
    dryruns = start_dryruns()
    try:
        # ---- moe: deepseek-moe-16b at its published width through B1 ---------
        t0 = time.perf_counter()
        moe_run, got = run_moe_phase()
        for k in launches:
            launches[k] += got[k]
        # B1 at an expert slice's shape, where the MoE path launches it most
        checked["csr"]["at_moe_expert"] = {k: v for k, v in moe_run["checks"]["b1"][2].items()
                                           if k != "launch"}
        torch.cuda.empty_cache()
        emit("moe", seconds=time.perf_counter() - t0, launches=got, **moe_run)

        # ---- recurrent: recurrentgemma-2b through B1, xlstm-1.3b dense --------
        t0 = time.perf_counter()
        rec_run, got = run_recurrent_phase()
        for k in launches:
            launches[k] += got[k]
        # B1 at recurrentgemma's FFN shapes (7,680 x 2,560 and 2,560 x 7,680)
        for key, row in zip(("at_rg_ffn", "at_rg_ffn_down"), rec_run["checks"]["b1"]):
            checked["csr"][key] = {k: v for k, v in row.items() if k != "launch"}
        torch.cuda.empty_cache()
        emit("recurrent", seconds=time.perf_counter() - t0, launches=got, **rec_run)

        # ---- train: qwen3-0.6b trained at full width and depth (no kernel) ---
        t0 = time.perf_counter()
        train_run_, got = run_train_phase()
        torch.cuda.empty_cache()
        emit("train", seconds=time.perf_counter() - t0, launches=got, **train_run_)

        # ---- dist: the sharded executor (B2 per device), mesh, dry run -------
        t0 = time.perf_counter()
        dist_run, got = run_dist_phase(tuner, {**pool, "hetero": extra["hetero"]},
                                             dryruns)
        for k in launches:
            launches[k] += got[k]
        torch.cuda.empty_cache()
        emit("dist", seconds=time.perf_counter() - t0, launches=got, **dist_run)
    finally:
        stop_dryruns(dryruns)

    # ---- tuner: the card's dataset, both modes fitted on it and served ---
    t0 = time.perf_counter()
    tuner_run, got = run_tuner_phase(tuner, pool, extra["webgraph"], fps,
                                     csr_schedule, web_schedule)
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("tuner", seconds=time.perf_counter() - t0, launches=got, **tuner_run)

    # ---- examples: the port's four examples in-process (B1-B4; none in train)
    t0 = time.perf_counter()
    examples, got = run_examples_phase()
    for k in launches:
        launches[k] += got[k]
    torch.cuda.empty_cache()
    emit("examples", seconds=time.perf_counter() - t0, launches=got, examples=examples)

    missing = [k for k in KERNEL_ORDER if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    kernels = [
        {
            "name": KERNEL_NAME[fmt],
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCE[fmt]}.cu",
            "replaces": REPLACES[fmt],
            "launches": launches[fmt],
            **checked[fmt],
        }
        for fmt in KERNEL_ORDER
    ]
    emit("done", total_seconds=time.perf_counter() - t_all, timer=timer_summary())
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


for _name, _fn in list(globals().items()):  # the parts: every function but these
    if (inspect.isfunction(_fn) and _fn.__module__ == __name__ and not
            inspect.isgeneratorfunction(_fn) and _name not in ("main", "emit", "take_parts",
                                                                 "timed_part")):
        globals()[_name] = timed_part(_fn)

if __name__ == "__main__":
    main()
