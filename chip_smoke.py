#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

1. ``card``: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of every hand-written kernel from the sources
   in this checkout (one nvcc per source, all started together), with
   each kernel's registers and spills from ptxas; no tensor-core kernel
   (``wgmma`` in its name: the attention forward and the two attention
   backward kernels) may spill, and the backward's must be there.
2. ``main_path``: the port's FL round loop at the paper's default setup
   (``run_fl(FLConfig(n_rounds=3))``: MNIST CNN, 50 devices, 5 air
   nodes, H=5, batched on the card), with every kernel's launch count
   set to 0 just before and read just after: one ``fedavg_agg`` launch a
   round, every leaf of both size buckets.
2a. ``contracts``: the runtime contracts (``repro_torch.analysis.
   contracts``) on the card: ``FLConfig(guard_recompiles=True,
   execution="batched")`` at that setup for 4 rounds, every warm round
   under ``no_recompile`` with count 0 and enforced, one ``fedavg_agg``
   launch a round, params bit for bit equal to the same run unguarded;
   cold blocks (``fedavg_agg.cu`` built into a fresh build root, a
   ``torch.compile`` function at a new shape) raise with their labels;
   ``assert_donated`` over a 2-layer llama3.2-3b train step in place
   (passes) and out of place (raises); ``nan_tripwire`` names the op or
   the kernel (``flash_attention``, ``fedavg_agg``) of an injected NaN.
3. ``round_profile``: one steady round of that setup under
   ``torch.profiler``: the card's busy share and kernel time by name.
4. ``kernel``: the round aggregate as the main path issues it (every
   MNIST leaf over its two buckets, one launch), against its plain
   PyTorch version and beside one ``tensordot`` a leaf on the
   concatenated stack; the cross-region merge at ``multi_region`` (4
   region models, one at weight 0, one launch); then each leaf alone and
   VGG-11's flat buffer; float32 and bfloat16, with the error, the
   tolerance and CUDA-event times of the kernel, the plain version and
   the library call (on the card alone, from a replayed CUDA graph, and
   issued eagerly from Python), beside the least time the card could
   take (``bound_ms``).
5. ``card_vs_cpu``: two batched rounds of the same setup from the same
   initial params on the card and on the CPU, TF32 off for matmul and
   cuDNN, cuDNN deterministic: plan cases, latencies and wall clocks
   identical, accuracies within 4/eval_size, and params within 1e-4
   round by round (each card round from the CPU's params before it);
   beside them the free-running gap and the CPU's own spread from an
   init moved by one part in 1e7.
6. ``vgg11``: two rounds of ``dataset="cifar10"`` (VGG-11, lr 0.005),
   the largest aggregate the kernel sees.
7. ``propagation``: the coverage windows of ``paper`` (80 satellites,
   48 h at 10 s) and ``mega_constellation`` (1,080 satellites, 2
   regions, 6 h) with the torch backend on the card against NumPy:
   every interval identical; host times of both.
8. ``scenario_paper``: ``run_fl`` with ``scenario="paper"`` and with
   ``use_constellation=True``, 3 rounds at the paper's setup on the
   card: one ``fedavg_agg`` launch a round; plan cases, realized
   latencies and wall clocks identical to the same run on the CPU,
   accuracies within 4/eval_size (TF32 off).
9. ``engine_fl``: ``SAGINEngine("multi_region", fl=FLConfig(n_devices=20,
   n_air=2), backend="torch").run(4)``: 4 regions, propagation on the
   card, a ring merge every 2 rounds; ``fedavg_agg`` launches = one a
   region-round plus one a merge; event order and first merge identical
   to a 2-round CPU run; round and merge walls.
10. ``engine_chaos``: ``SAGINEngine("chaos", fl=FLConfig(n_devices=12,
    n_air=2)).run(6)``: every fault kind injected and recovered,
    quarantined updates counted, finite global params.
11. ``engine_resume``: phase 9's ``multi_region`` configuration, ``run(4)``
    against ``run(2, final_merge=False)`` + ``save_engine`` + a fresh
    engine's ``restore_engine`` + ``run(2)``, deterministic algorithms
    on: cases, latencies, clocks and merges identical, params identical
    or within 1e-4; save and restore walls, checkpoint bytes, launches.
12. ``serve_gateway``: ``ServeGateway`` sessions on the card, each beside
    the same session on the CPU with the card's params carried over:
    the resumed ``multi_region`` engine (default ``ServeConfig``), and
    ``flash_crowd`` (3 regions) and ``degraded_links`` (1 region), each
    trained 1 round, under ``min_rt`` and ``static_nearest``: identical
    routes and simulated latencies, served accuracy within 4/served,
    ``min_rt``'s p99 below ``static_nearest``'s under
    ``degraded_links``; ``qps_wall``, the median batch wall and the
    card's busy share of a session; ``python -m repro_torch.obs report``
    on the resumed engine's trace (serving and resilience sections).
12a. ``mesh_cohort``: the client-sharded cohort engine.  The paper setup
    with the Walker-Star windows (``FLConfig(use_constellation=True)``,
    batched) for 4 rounds under ``cohort_sharding="off"``, then under
    ``"mesh"`` in an NCCL group of one rank (the single-device path, bit
    for bit; deterministic algorithms on for both); then 2 ranks spawned
    on ``cuda:0`` over ``gloo`` (``repro_torch.launch.spawn``), 2 shards,
    each round from the "off" run's params before it: params within
    1e-5, losses within 1e-5, accuracies within 4/eval_size, the ranks
    equal, one ``fedavg_agg`` launch a round on each rank, rank 0 alone
    tracing; the steady round wall of each run, the shard imbalance.
12b. ``mesh_collectives``: an NCCL group of one rank: ``hierarchical_
    weighted_psum``, ``make_replica_agg_step`` and ``shard_weighted_
    aggregate`` (``fedavg_agg`` on CUDA tensors, one launch) at the MNIST
    round's leaves against their plain versions; the all-reduce of the
    round's flat buffer, timed; ``fedavg_agg`` at one shard's blocks of
    the round (weights summing to 1/2) against its plain version, timed as
    in phase 4.
12c. ``examples``: every example of ``repro_torch.examples`` through its
    ``main`` with a user's command line, one line a run with what it
    printed: ``sagin_fl_end2end`` at its defaults (200 rounds, adaptive
    then none: training time, best accuracy, time to 80 %; one
    ``fedavg_agg`` launch a round; the first 3 rounds' plan cases and
    training times equal to a CPU run's), ``--scenario multi_region
    --global-model --rounds 6`` under each of the four federation
    policies (one launch a region-round and one a merge), ``--scenario
    degraded_links --rounds 3``, ``quickstart``,
    ``offloading_walkthrough``, ``multiarch_demo`` over all ten configs
    and ``serve_demo`` for llama3.2-3b and internvl2-1b.
13. ``transformer_prefill``: full-width ``llama3.2-3b`` (random bf16
    weights from a seed), ``make_prefill_step`` on B = 4 sequences of
    2048 tokens: one ``flash_attention`` launch per layer (28), finite
    logits, wall time, peak memory and the kernel's share of the step
    under ``torch.profiler``.
14. ``transformer_decode``: the same model behind ``TransformerBackend``
    (seq_len 2048) answering batches of 8 requests: per-token latency.
15. ``decode_vs_prefill``: the same model in float32 (TF32 off), B = 1,
    cut to 8 layers: the prefill's logits at all 256 positions (through
    the kernel)
    against 256 plain ``serve_step``s; then full-width ``rwkv6-1.6b``
    the same way over 64 positions (prefill through ``wkv6``, decode
    through the plain ``wkv_step``).
16. ``rwkv6``: full-width ``rwkv6-1.6b`` in bf16, prefill of B = 4 x 2048
    tokens (one ``wkv6`` launch per layer, 24) and decode steps; the
    smallest decay ``w`` the prefill feeds the kernel, and each layer's
    0.1 % quantile of it.
16a. ``moe_prefill``: ``make_prefill_step`` on full-width
    ``deepseek-v2-lite-16b`` (MLA + MoE, full depth) and
    ``qwen3-moe-235b-a22b`` (GQA + MoE, 4 of 94 layers), B = 4 x 2048,
    random bf16 weights from seed 0: finite logits, ``flash_attention``
    launches 0 (MLA is plain torch) and 4; wall, tokens/s, peak memory,
    the busy share and the profile's groups (GEMMs, gather/scatter,
    sort/top-k, softmax, elementwise).
16b. ``moe_decode``: deepseek-v2-lite-16b behind ``TransformerBackend``
    (8 requests a step over a 2048 cache, MLA's latent cache, the flat
    MoE dispatch): per-token latency and the busy share.
16c. ``moe_decode_vs_prefill``: both MoE configs in float32 at 2 layers,
    B = 1, 64 positions, at the capacity factor n_experts /
    n_experts_active rounded up (11 and 16), where no token drops:
    decode within 1e-3 of prefill.
16d. ``hybrid_prefill``: ``make_prefill_step`` on one full-width block of
    ``jamba-1.5-large-398b`` (1 GQA + 7 Mamba layers, dense and MoE FFNs
    alternating; 4 of its 16 experts, ``CUTS``), B = 4 x 2048, random
    bf16 weights from seed 0: finite logits, one ``flash_attention``
    launch and no other; wall, tokens/s, peak memory, the busy share and
    the profile's groups; the dt each Mamba layer's scan sees; the scan
    alone at (4, 2048, 16384, 16), chunked (as the layers run it; eager
    and from a CUDA graph) and per step, its bound, 7 x its time as a
    share of the wall, and the two forms within 1e-5 of each other.
16e. ``hybrid_decode``: that block behind ``TransformerBackend`` (8
    requests a step over a 2048 cache): per-token latency, busy share.
16f. ``hybrid_decode_vs_prefill``: jamba cut to 2 layers (GQA + dense
    FFN, Mamba + MoE FFN) in float32, B = 1, 256 positions (four scan
    chunks), capacity factor 2: decode within 1e-3 of prefill.
16g. ``dense_prefill``: ``make_prefill_step`` on the five configs of
    ``DENSE`` at full width (random bf16 weights from seed 0): olmo-1b,
    internvl2-1b and musicgen-medium at full depth, qwen3-32b and
    deepseek-coder-33b at 8 layers (``CUTS``); B = 4 x 2048 tokens, or
    embeddings for internvl2-1b and musicgen-medium: one
    ``flash_attention`` launch a layer, finite logits, wall, tokens/s,
    peak memory, the busy share and the profile's groups.
16h. ``dense_decode``: each of them decoding 8 requests a step over a
    2048 cache: the token configs behind ``TransformerBackend``, the
    embeddings ones through ``serve_step`` on zero embeddings after a
    16-position prompt; per-token latency, busy share.
16i. ``dense_decode_vs_prefill``: each at 2 layers in float32 over 256
    positions, decode within 1e-3 of prefill; then
    ``window_decode_vs_prefill`` (``WINDOW_CHECK``): olmo-1b at 2 layers
    with its window set to 256, the windowed prefill through the kernel
    against 1024 decode steps over a 256-position ring.
17. ``flash_kernel`` / ``wkv_kernel``: each kernel against its plain
    version on the card at the shapes the main paths gave it (in their
    bf16 and in f32; for attention also qwen3-moe's q 4 x 64 x 2048 x
    128 over 4 KV heads and jamba's over 8, and ``DENSE_KERNEL_SHAPES``:
    deepseek-coder-33b's 56 over 8 and internvl2-1b's 14 over 2 at head
    dims 128 and 64 (GQA groups of 7), musicgen-medium's 24 and olmo-1b's
    16 heads (MHA) at 64 and 128, with the elements past
    tolerance of the kernel and of the library call) and over the
    reference's sweep, f32 and bf16, with
    decays from [0.7, 0.999] and (wkv) also from [0, 0.999] with exact
    zeros, timed as in phase 4 beside the library call
    (``scaled_dot_product_attention``; none for wkv) and ``bound_ms``;
    for flash also the achieved TFLOP/s and the share of the bound.

18. ``transformer_train``: full-width ``llama3.2-3b`` (random bf16
    weights from seed 0), 3 ``make_sharded_train_step`` steps (SGD,
    ``TRAIN_LR``, remat) on one fixed batch of 4 x 2048 tokens: losses
    finite, the last below the first; per step 2 ``flash_attention``
    launches a layer (forward and remat recompute) and 1
    ``flash_attention_backward``;
    step wall, tokens/s, peak memory, and one more step under the
    profiler (busy share, GEMMs, elementwise, attention forward and
    backward, the backward by kernel: delta, dK/dV, dQ); then at 2
    layers of full width one step's gradients through the kernels
    against the same step through the plain versions, in float32 (each leaf within ``TRAIN_GRAD_TOL`` of its
    norm) and in bf16 (no more than twice the plain bf16 step's own
    distance from the float32 one, plus 1e-2), and the float32 loss after
    one SGD step through each (within ``STEP_LOSS_TOL``).
19. ``rwkv6_train``: the same for full-width ``rwkv6-1.6b`` (24 layers,
    ``wkv6`` forward, remat and ``wkv6_backward``).
19a. ``moe_train``: the same for deepseek-v2-lite-16b (20 of 27 layers;
    no kernel on its path, every count 0, the aux loss finite) and
    qwen3-moe-235b-a22b at 4 layers (``flash_attention`` and its
    backward at a GQA group of 16).
19b. ``hybrid_train``: the same for jamba's block (``CUTS``) cut to its
    first 4 layers (``HYBRID_TRAIN_LAYERS``) at B = 1 x 2048
    (``HYBRID_TRAIN_BATCH``; no profiled step, ``PROFILE_SKIP``):
    the attention kernels at a GQA group
    of 8, the chunked scan's checkpoints inside the block's; at 2 layers
    the gradients and stepped loss against the plain versions.
19c. ``dense_train``: the same for each of ``DENSE``, qwen3-32b and
    deepseek-coder-33b at 4 layers (``DENSE_TRAIN_LAYERS``).
20. ``fl_train_step``: ``make_fl_train_step`` on full-width llama3.2-3b,
    2 replicas, ``h_local`` = 2, 2 x 2048 tokens a replica, 2 rounds:
    one ``fedavg_agg`` launch a round, the aggregate against
    ``ref.weighted_aggregate`` of the stacked replicas, every replica
    slot equal to the aggregate, the round wall.
20-mesh. ``mesh_fl_train_step``: ``make_fl_train_step(mesh=...)`` on
    llama3.2-3b at full width: in an NCCL group of one rank (a ``pod``
    mesh of 1 holding both replicas) at full depth, one launch a round,
    the slots equal, the round wall and peak memory, and at 2 layers in
    float32 against the one-device step within 1e-5 x (1 + |p|); then 2
    ranks spawned on ``cuda:0`` over ``gloo``, one replica each, cut to
    ``MESH_FL_LAYERS`` layers: the replicas equal across the ranks after
    each round; each rank's round wall and peak memory.
20a. ``moe_fl_train_step``: the same on deepseek-v2-lite-16b at full
    width cut to 2 layers (its expert leaves are 3-D stacks): one
    ``fedavg_agg`` launch a round, no attention launch.
20b. ``hybrid_fl_train_step``: the same on jamba cut to 2 layers: one
    ``fedavg_agg`` launch a round, 2 attention forward launches and 1
    backward a local step.
21. ``flash_backward_kernel`` / ``wkv_backward_kernel``: each backward
    kernel against autograd through its plain version (f32, on the same
    input values) at the training shapes (attention also at qwen3-moe's,
    jamba's and ``DENSE_KERNEL_SHAPES`` in bf16), bf16 and f32 (wkv with
    decays
    down to 0), with times beside the plain version's backward and, for
    attention, ``scaled_dot_product_attention``'s backward, and
    ``bound_ms``.  For attention also: the forward's log-sum-exp against
    ``ref.row_lse`` and its output bit for bit against the forward
    without it, the design each call ran on (bf16 the tensor cores, f32
    the CUDA cores), two calls bit-identical, the achieved TFLOP/s, the
    share of the bound (the function's five products) and of the
    design's own floor (nine products: S and dP in both kernels, dV's and
    dK's over bf16 high and low parts).  For
    wkv also: the design each call ran on (bf16 at D >= 16 the chunked
    form on the tensor cores, else the scan on the CUDA cores), two calls
    bit-identical, the share of the design's floor (chunked: the bound's
    bytes plus its two boundary buffers; scan: its f32 FLOPs), and bf16
    cases at T = 1, T = 63 and D = 16, 32.

21a. ``sharded_steps``: the DTensor steps (tensor and FSDP parallelism)
    in an NCCL group of one rank on a (1, 1) ``("data", "model")`` mesh:
    llama3.2-3b and rwkv6-1.6b at full width and depth, prefill and one
    train step (remat) on 4 x 2048 tokens, each against ``mesh=None``
    from the same params and batch (bit for bit), both walls, the
    kernels' launches, and each step's first attention and wkv call held,
    forward and backward, against the plain version on the local inputs
    it was given, in bf16 and in float32.  Then 8 ranks spawned on
    ``cuda:0`` over the ``hoststage`` backend (each collective staged
    through host memory over ``gloo``): llama3.2-3b and rwkv6-1.6b at
    full width cut to 2 layers on the (1, 2), (2, 1), (2, 2) and (4, 2)
    meshes (prefill and one train step on 8 x 512 tokens, 2 decode steps
    at batch 16), deepseek-v2-lite-16b on (2, 2) (prefill, train step)
    and the pod FL round of two llama3.2-3b replicas on (2, 1, 2), each
    within 1e-4 x (1 + |want|) of ``mesh=None`` on the card in float32;
    one line a mesh and config with the collectives' counts and bytes,
    the launches on rank 0 and both walls, and on (2, 2) each rank's
    first bf16 attention and wkv call against the plain version.
21b. ``dryrun_mesh``: ``python -m repro_torch.launch.dryrun`` at ``--mesh
    single`` (olmo-1b train_4k, a ``"fake"`` group of 256 ranks) and
    ``--mesh multi --fl-step`` (llama3.2-3b, 512), each in its own
    process: ``status: ok``, all-gather and all-reduce bytes, and
    olmo-1b's per-device FLOPs x 256 over its one-device count in
    [0.99, 2.0].  Both processes run beside ``roofline`` (22); the line
    follows it.
22. ``roofline``: every prefill and train step whose wall phases 13-19c
    measured (but those in ``ROOFLINE_SKIP``), counted on the ``meta``
    device by ``repro_torch.launch.dryrun.run_one`` at the same config,
    depth and shape: FLOPs, bytes, the bound (the larger of the compute
    and memory terms on the card's rates, ``repro_torch.launch.mesh``),
    the wall, ``bound / wall`` and ``model_flops / (wall x peak)`` (each
    at most ``ROOFLINE_SHARE_LIMIT``), and the host seconds of each
    count, one line a step with the card's name and power limit.

Every phase's line carries ``phase_s``, the host wall of the phase up to
that line.

Every path is driven with every kernel's launch count set to 0 just
before it and read just after; ``fedavg_agg``'s count in the kernel
line sums its paths (phases 2, 2a, 8, 9, 11, 12, 12a, 12b, 12c, 20,
20-mesh, 20a, 20b and 21a's pod FL round; the spawned ranks count their
own), the
attention and wkv counts theirs (prefill, training, the FL steps, the
sharded steps, the examples).  Then a
``{"kernels": [...]}`` line and, last, the device line.  Any failed phase, a missing CUDA
device, or a directory without the rest of the repository gives a
non-zero exit and no result line.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOLERANCE = {"float32": 1e-6, "bfloat16": 2e-2}
# f32: the reference's tolerances (tests/test_kernels.py).  bf16: kernel
# and plain version both sum in f32 from the same bf16 inputs and round
# the output once; the tensor-core flash kernel also rounds the
# probabilities to bf16 before P.V, so they differ by about two bf16
# roundings (2**-8 relative each); the limit leaves room over that and
# stays well below the outputs' own size (a causal row over n random keys
# is ~sqrt(e/n), 0.036 at n = 2048, so the reference's 5e-2 would pass a
# wrong kernel)
FLASH_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-2}
# wkv bf16: the tensor-core kernel multiplies the factored operands (r and
# k times their decays, the intra-chunk scores, the state) as bf16 high
# and low parts, ~2**-17 of each; one bf16 rounding of them instead would
# put ~2**-9 of the state's size (not the output's) on every output and
# miss the limit where outputs are small
WKV_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# The prefill and train steps whose walls the phases measure, for the
# roofline phase: {"config", "kind", "batch", "seq_len", "wall_s"}
MEASURED_STEPS = []
# A roofline share above this fails the roofline phase: the count or the
# wall would be wrong (the bound is the least time the card could take)
ROOFLINE_SHARE_LIMIT = 1.05
# Steps measured but not counted by the roofline phase, to keep the run
# inside its time: jamba's train step took 45.5 s of host time to count
# (its chunked scans dispatch tens of thousands of small ops), more than
# half the phase, and rwkv6-1.6b's 18.8-25.7 s (its time mix's many
# small ops; NVIDIA H100 80GB HBM3 at 700 W); their prefills are still
# counted
ROOFLINE_SKIP = {("jamba-1.5-large-398b", "train"), ("rwkv6-1.6b", "train")}
# Train steps measured without the profiled step: jamba's, tens of
# thousands of small kernels (its chunked scans), is slow to trace; its
# busy share (32 %) was measured before
PROFILE_SKIP = {"jamba-1.5-large-398b"}


# the host clock at the start of the running phase (``_run``)
_PHASE_START = {"t0": None}


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``phase_s``, the host wall
    of the phase so far."""
    if "phase" in obj and _PHASE_START["t0"] is not None:
        obj = dict(obj, phase_s=time.perf_counter() - _PHASE_START["t0"])
    print(json.dumps(obj), flush=True)


def _run(fn, /, *args, **kw):
    """``fn(*args, **kw)``, a phase, with its start noted for ``emit``."""
    _PHASE_START["t0"] = time.perf_counter()
    return fn(*args, **kw)


def _rates():
    """The card's HBM rate (bytes/s) and the peak rates of the operations
    these kernels do by input type (float32 outside the tensor cores, bf16
    dense): one source, ``repro_torch.launch.mesh`` (NVIDIA's data sheet
    of the H100 SXM)."""
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_F32)
    return HBM_BW, {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _event_ms(run, repeats: int) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``run()``."""
    import torch
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def set_counts(launchers: dict) -> None:
    """Every kernel wrapper's launch count to 0."""
    for fn in launchers.values():
        fn.launches = 0


def read_counts(launchers: dict) -> dict:
    return {name: fn.launches for name, fn in launchers.items()}


def time_ms(fn, reps: int = 20, repeats: int = 5) -> dict:
    """Per-call times of ``fn`` from CUDA events, warmed up first.

    ``device``: ``reps`` calls captured in one CUDA graph and replayed,
    so the host's per-call cost (Python, argument checks, the launch
    itself) drops out and what is left is the card's time.  ``eager``:
    ``reps`` calls issued back to back from Python, as the round loop
    issues them; where it exceeds ``device`` the card waits on the host.
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()

    out = {"device": _event_ms(graph.replay, repeats) / reps,
           "eager": _event_ms(eager, repeats) / reps}
    del graph
    return out


def phase_card(kernels):
    """``kernels``: (source, build) of every library, forward and
    backward."""
    import torch
    from repro_torch.kernels.build import compile_library
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        libs = list(pool.map(lambda k: compile_library(k[0]), kernels))
    for _, build in kernels:
        build()
    build_s = time.perf_counter() - t0
    reports = [ptxas_report((lib.parent / "build.log").read_text())
               for lib in libs]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "ptxas": {str(lib.relative_to(ROOT)): ptxas
                    for lib, ptxas in zip(libs, reports)},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    tensor_core = [(name, rec) for ptxas in reports
                   for name, rec in ptxas.items()
                   if "wgmma" in name and name != "notes"]
    spilled = [name for name, rec in tensor_core
               if rec["spill_stores"] or rec["spill_loads"]]
    if spilled:
        raise RuntimeError(f"the tensor-core kernel spills registers: "
                           f"{spilled}")
    missing = [kind for kind in ("flash_attention_wgmma", "dkdv_wgmma",
                                 "dq_wgmma")
               if not any(kind in name for name, _ in tensor_core)]
    if missing:
        raise RuntimeError(f"the spill check found no {missing} kernel in "
                           f"the builds")


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel in nvcc's ``-Xptxas -v``
    report (``build.log``), by mangled kernel name; ptxas's performance
    notes (wgmma serialized, setmaxnreg ignored) under ``notes``."""
    out, name = {"notes": []}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if "Performance Loss" in ln or "setmaxnreg" in ln:
            out["notes"].append(ln.strip()[:300])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_main_path(launchers):
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.obs import ObsConfig, Tracer
    cfg = FLConfig(n_rounds=3)
    tracer = Tracer(ObsConfig(path=None))
    set_counts(launchers)
    t0 = time.perf_counter()
    res = run_fl(cfg, tracer=tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(launchers)
    launches = counts["fedavg_agg"]
    # per-round wall seconds from the round spans' host clock (round 0
    # also holds the trainer's construction); clients aggregated per
    # round from the bucket dispatches
    round_ends = [s.t_wall + s.dur_wall for s in tracer.spans
                  if s.kind == "round"]
    per_round = [b - a for a, b in zip([0.0] + round_ends, round_ends)]
    clients = [sum(s.attrs["clients"] for s in tracer.spans
                   if s.kind == "bucket_dispatch" and s.round == r)
               for r in range(cfg.n_rounds)]
    buckets = sorted({s.name for s in tracer.spans
                      if s.kind == "bucket_dispatch"})
    split = [s.attrs["clients"] for s in tracer.spans
             if s.kind == "bucket_dispatch" and s.round == 0]
    # batched: one launch a round for every leaf of every bucket
    ok = (cfg.resolved_execution() == "batched"
          and launches == cfg.n_rounds
          and all(math.isfinite(a) for a in res.accuracies)
          and all(res.participated))
    emit({"phase": "main_path", "ok": ok, "config": "FLConfig(n_rounds=3)",
          "execution": cfg.resolved_execution(), "wall_s": wall,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "latencies": res.latencies,
          "cases": res.cases, "buckets": buckets,
          "clients_per_round": clients, "bucket_clients_round0": split,
          "fedavg_agg_launches": launches, "launches": counts})
    if not ok:
        raise RuntimeError("main path: not one fedavg_agg launch a round, "
                           "or non-finite accuracies")
    return launches, split


CONTRACT_ROUNDS = 4


def _violation(run):
    """``run()``'s ``ContractViolation`` message, or None if it passed."""
    from repro_torch.analysis.contracts import ContractViolation
    try:
        run()
    except ContractViolation as exc:
        return str(exc)
    return None


def _cold(label, run):
    """``run()`` under ``no_recompile(label=label)``."""
    import torch
    from repro_torch.analysis import contracts
    with contracts.no_recompile(label=label):
        run()
        torch.cuda.synchronize()


def _guarded_fl(cfg):
    """``RegionTrainer(cfg)`` stepped ``cfg.n_rounds`` rounds, every
    ``no_recompile`` block the cohort engine opens recorded as (round,
    label, count, enforced).  Returns the records and the final params."""
    import contextlib
    from repro_torch.fl import cohort_engine
    from repro_torch.fl.rounds import RegionTrainer
    from repro_torch.tree import tree_leaves
    seen = []
    real = cohort_engine.contracts.no_recompile
    rnd = [0]

    @contextlib.contextmanager
    def watched(*args, **kw):
        with real(*args, **kw) as rc:
            yield rc
        seen.append((rnd[0], kw.get("label"), rc.count, rc.enforced))

    cohort_engine.contracts.no_recompile = watched
    try:
        trainer = RegionTrainer(cfg)
        for rnd[0] in range(cfg.n_rounds):
            trainer.step(rnd[0])
    finally:
        cohort_engine.contracts.no_recompile = real
    return seen, tree_leaves(trainer.params)


def phase_contracts(launchers, agg_kernel, tmp):
    """The runtime contracts on the card (``repro_torch.analysis.
    contracts``).  ``FLConfig(guard_recompiles=True, execution="batched")``
    at the paper setup, ``CONTRACT_ROUNDS`` rounds: every warm round runs
    under ``no_recompile`` with count 0 and the contract enforced, one
    ``fedavg_agg`` launch a round, and the params equal, bit for bit, to
    the same run unguarded (deterministic algorithms on for both).  Cold
    blocks raise with their labels: ``fedavg_agg.cu`` built into a fresh
    build root, a ``torch.compile`` function at a new shape.
    ``assert_donated`` passes over a 2-layer llama3.2-3b train step that
    updates in place and raises over one that does not; ``nan_tripwire``
    names the op (``aten.log``) or the kernel (``flash_attention``,
    ``fedavg_agg``) that made an injected NaN.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.analysis import contracts
    from repro_torch.configs.shapes import InputShape
    from repro_torch.fl import FLConfig
    from repro_torch.kernels.build import compile_library
    from repro_torch.kernels.fedavg_agg import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.models import transformer as T
    cfg = FLConfig(n_rounds=CONTRACT_ROUNDS, guard_recompiles=True,
                   execution="batched")
    b = torch.backends.cudnn
    saved = (b.deterministic, b.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    b.deterministic, b.benchmark = True, False
    try:
        set_counts(launchers)
        t0 = time.perf_counter()
        guarded, params = _guarded_fl(cfg)
        torch.cuda.synchronize()
        guarded_s = time.perf_counter() - t0
        off, plain = _guarded_fl(dataclasses.replace(cfg,
                                                     guard_recompiles=False))
        counts = read_counts(launchers)
    finally:
        torch.use_deterministic_algorithms(False)
        b.deterministic, b.benchmark = saved
    bit_identical = (len(params) == len(plain) and all(
        torch.equal(x, y) for x, y in zip(params, plain)))
    warm_clean = bool(guarded) and all(
        (label, n, enforced) == ("CohortEngine.round", 0, True)
        for _, label, n, enforced in guarded)
    # cold blocks: a library built into a fresh root, a new compiled graph
    cold_build = _violation(lambda: _cold(
        "contracts.cold_build",
        lambda: compile_library(agg_kernel.SOURCE,
                                root=Path(tmp) / "cold_build")))
    doubled = torch.compile(lambda x: x * 2, backend="eager")
    doubled(torch.ones(3, device="cuda"))
    with contracts.no_recompile() as warm:
        doubled(torch.ones(3, device="cuda"))
    warm_compile = warm.count     # the view counts on after the block
    cold_compile = _violation(lambda: _cold(
        "contracts.cold_compile",
        lambda: doubled(torch.ones(17, device="cuda"))))
    # assert_donated over the port's in-place train step, and one that
    # writes new params instead
    llama = _config("llama3.2-3b", 2)
    shape = InputShape("contracts", 2048, 1, "train")
    weights = T.init_params(llama, seed=0, device="cuda")
    data = _train_batch(llama, (1,), 2048)
    in_place = make_sharded_train_step(llama, shape,
                                       lr=TRAIN_LR["llama3.2-3b"])
    out_of_place = make_sharded_train_step(llama, shape,
                                           lr=TRAIN_LR["llama3.2-3b"],
                                           donate=False)

    def donated(step, label):
        def run():
            with contracts.assert_donated(weights, label=label):
                step(weights, data)
            torch.cuda.synchronize()
        return run
    donated_ok = _violation(donated(in_place, "llama3.2-3b in place"))
    not_donated = _violation(donated(out_of_place,
                                     "llama3.2-3b out of place"))
    del weights, data
    _free()
    # nan_tripwire: an op, and two kernels written behind the dispatcher
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q[0, 0, 5, 3] = float("nan")
    stacked = torch.randn((4, 1000), generator=gen, device="cuda")
    stacked[2, 17] = float("nan")
    weights4 = torch.full((4,), 0.25, device="cuda")

    def tripped(run):
        def armed():
            with torch.no_grad(), contracts.nan_tripwire():
                run()
                torch.cuda.synchronize()
        return armed
    trips = {
        "aten.log": _violation(tripped(
            lambda: torch.log(torch.zeros(4, device="cuda") - 1.0))),
        "kernel flash_attention": _violation(tripped(
            lambda: fa_ops.attention(q, k, v))),
        "kernel fedavg_agg": _violation(tripped(
            lambda: agg_ops.weighted_aggregate(stacked, weights4))),
    }
    restored = not torch.is_anomaly_enabled()
    ok = (warm_clean and off == [] and bit_identical
          and counts["fedavg_agg"] == 2 * CONTRACT_ROUNDS
          and cold_build is not None and "contracts.cold_build" in cold_build
          and cold_compile is not None
          and "contracts.cold_compile" in cold_compile
          and warm_compile == 0 and donated_ok is None
          and not_donated is not None and "still live" in not_donated
          and all(m is not None and want in m for want, m in trips.items())
          and restored)
    emit({"phase": "contracts", "ok": ok,
          "config": f"FLConfig(n_rounds={CONTRACT_ROUNDS}, "
                    f"guard_recompiles=True, execution='batched')",
          "guarded_rounds": [{"round": r, "label": label, "count": n,
                              "enforced": enforced}
                             for r, label, n, enforced in guarded],
          "guarded_run_s": guarded_s, "unguarded_blocks": len(off),
          "bit_identical_to_unguarded": bit_identical, "launches": counts,
          "cold_build": cold_build, "cold_compile": cold_compile,
          "warm_compile_count": warm_compile,
          "donated_in_place": donated_ok, "donated_out_of_place": not_donated,
          "nan_tripwire": trips, "anomaly_mode_restored": restored})
    if not ok:
        raise RuntimeError("contracts: a warm round built a program, the "
                           "guarded run's params differ from the "
                           "unguarded run's, a cold block passed, or a "
                           "donation or tripwire check went wrong")
    return counts["fedavg_agg"]


def phase_round_profile():
    """One steady round of the main path under ``torch.profiler``: the
    card's busy share of the round's wall time and its kernel time by
    name, with ``fedavg_agg``'s own share."""
    import torch
    from repro_torch.fl import FLConfig, RegionTrainer
    tr = RegionTrainer(FLConfig(n_rounds=2))
    tr.step(0)
    torch.cuda.synchronize()
    wall_ms, by_name = _profile(lambda: tr.step(1))
    # "Cat": the concatenation kernels, which the round no longer runs on
    # the aggregate's way
    emit({"phase": "round_profile", "round_wall_ms": wall_ms,
          **_share(by_name, wall_ms, "fedavg_agg", "Cat")})


def _bound(nbytes, ops, dtype_name):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of ``dtype_name``, the larger."""
    hbm, peak = _rates()
    bytes_ms = nbytes / hbm * 1e3
    ops_ms = ops / peak[dtype_name] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _reps(fn, big: bool):
    """(reps, repeats) to time ``fn`` with: fewer calls for a case that
    moves many bytes (``big``) or whose one call takes over 2 ms of host
    time (a plain version that loops in Python, as the per-step wkv
    scan)."""
    import torch
    if big:
        return 4, 3
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (4, 3) if time.perf_counter() - t0 > 2e-3 else (20, 5)


def _times(fns: dict, big: bool) -> dict:
    """CUDA-graph (card) and eager times of each callable in ``fns``;
    fewer calls for a case that takes milliseconds (``_reps``)."""
    out = {}
    for key, fn in fns.items():
        if fn is None:
            out[f"{key}_ms"] = out[f"{key}_eager_ms"] = None
            continue
        reps, repeats = _reps(fn, big)
        t = time_ms(fn, reps=reps, repeats=repeats)
        out[f"{key}_ms"], out[f"{key}_eager_ms"] = t["device"], t["eager"]
    return out


def _agg_case(kernel, ref, shape, dtype_name, seed):
    """One kernel-vs-plain comparison with times, on the card."""
    import torch
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.rand(shape[0], generator=gen, device="cuda") + 0.1
    w = w / w.sum()
    w_lib = w.to(dtype)  # the library call takes one type throughout
    got = kernel.weighted_aggregate(x, w)
    want = ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    c, p = shape[0], x.numel() // shape[0]
    nbytes = c * p * x.element_size() + 4 * c + p * x.element_size()
    return {
        "shape": list(shape), "dtype": dtype_name,
        "max_abs_err": float(diff.max()), "tolerance": tol, "ok": ok,
        **_times({"kernel": lambda: kernel.weighted_aggregate(x, w),
                  "plain": lambda: ref.weighted_aggregate(x, w),
                  "library": lambda: torch.tensordot(w_lib, x, dims=1)},
                 big=False),
        **_bound(nbytes, 2 * c * p, dtype_name),
    }


def _round_case(kernel, ref, leaf_shapes, split, dtype_name, seed,
                zero=None, mass=1.0):
    """The round aggregate as the main path issues it: every leaf over the
    size buckets (clients ``split``), one launch, against the plain
    version (which concatenates the buckets), beside one ``tensordot`` a
    leaf on the concatenated stacks (the yardstick) and beside the same
    kernel launched once a leaf on them.  ``zero``: the client whose
    weight is 0 (a region that sits a merge out).  ``mass``: what the
    weights sum to (a shard's share of a round, below 1)."""
    import torch
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    parts = [[torch.randn((c,) + shape, generator=gen,
                          device="cuda").to(dtype) for shape in leaf_shapes]
             for c in split]
    w = torch.rand(sum(split), generator=gen, device="cuda") + 0.1
    if zero is not None:
        w[zero] = 0.0
    w = w / w.sum() * mass
    w_lib = w.to(dtype)  # the library call takes one type throughout
    stacks = [torch.cat(leaves) for leaves in zip(*parts)]
    got = kernel.aggregate(parts, w)
    want = ref.aggregate(parts, w)
    torch.cuda.synchronize()
    tol = TOLERANCE[dtype_name]
    diffs = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
    ok = all(bool((d <= tol * (1 + b.float().abs())).all())
             for d, b in zip(diffs, want))
    elt = stacks[0].element_size()
    nbytes = (sum(x.numel() + x[0].numel() for x in stacks) * elt
              + 4 * sum(split))
    return {
        "split": list(split), "leaves": len(leaf_shapes),
        "dtype": dtype_name, "weight_mass": mass,
        "max_abs_err": max(float(d.max()) for d in diffs), "tolerance": tol,
        "ok": ok,
        **_times({"kernel": lambda: kernel.aggregate(parts, w),
                  "plain": lambda: ref.aggregate(parts, w),
                  "library": lambda: [torch.tensordot(w_lib, x, dims=1)
                                      for x in stacks],
                  "per_leaf": lambda: [kernel.weighted_aggregate(x, w)
                                       for x in stacks]},
                 big=False),
        **_bound(nbytes, 2 * sum(x.numel() for x in stacks), dtype_name),
    }


def phase_kernel(agg_kernel, agg_ref, split):
    import torch
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    leaf_shapes = [tuple(t.shape) for t in tree_leaves(params)]
    clients = sum(split)
    rounds = {d: _round_case(agg_kernel, agg_ref, leaf_shapes, split, d, 7)
              for d in ("float32", "bfloat16")}
    for case in rounds.values():
        emit({"phase": "kernel", "kernel": "fedavg_agg",
              "model": "mnist round aggregate (every leaf, both buckets, "
                       "one launch)", **case})
    # the cross-region merge at multi_region: 4 region models stacked
    # (one bucket), every leaf in one launch, one region at weight 0
    merge = _round_case(agg_kernel, agg_ref, leaf_shapes, [4], "float32",
                        8, zero=2)
    emit({"phase": "kernel", "kernel": "fedavg_agg",
          "model": "multi_region merge (4 regions, one at weight 0, every "
                   "leaf, one launch)", **merge})
    rounds["merge"] = merge
    cases = {}
    for dtype_name in ("float32", "bfloat16"):
        for i, leaf in enumerate(leaf_shapes):
            cases[(dtype_name, "mnist", i)] = _agg_case(
                agg_kernel, agg_ref, (clients,) + leaf, dtype_name, i)
        cases[(dtype_name, "vgg11", 0)] = _agg_case(
            agg_kernel, agg_ref, (clients, 9_225_610), dtype_name, 99)
    for (dtype_name, model, _), case in cases.items():
        emit({"phase": "kernel", "kernel": "fedavg_agg", "model": model,
              **case})
    bad = ([k for k, v in cases.items() if not v["ok"]]
           + [k for k, v in rounds.items() if not v["ok"]])
    if bad:
        raise RuntimeError(f"fedavg_agg disagrees with its plain version: "
                           f"{bad}")
    return rounds["float32"]


def _steps(device, init, rounds, teacher=None):
    """Step a batched paper-setup trainer on ``device`` from ``init``.

    Returns the trainer, its params after each round (on the CPU) and
    the seconds it took.  With ``teacher`` (params before each round),
    every round starts from the teacher's params instead of its own.
    """
    import torch
    from repro_torch.fl import FLConfig, RegionTrainer
    from repro_torch.tree import tree_map
    # one execution mode on both devices, so that only the devices
    # differ ("auto" would pick sequential on the CPU)
    tr = RegionTrainer(FLConfig(n_rounds=rounds, device=device,
                                execution="batched"), params=init)
    after = []
    t0 = time.perf_counter()
    for r in range(rounds):
        if teacher is not None:
            tr.params = tree_map(lambda t: t.to(tr.device, copy=True),
                                 teacher[r])
        tr.step(r)
        after.append(tree_map(lambda t: t.detach().cpu().clone(),
                              tr.params))
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    return tr, after, time.perf_counter() - t0


def phase_card_vs_cpu(agg_kernel):
    """Two batched rounds on the card and on the CPU from one init.

    A float32 trajectory of this setup is itself sensitive: the CPU run
    from an init moved by one part in 1e7 (the size of a rounding
    difference) is reported beside the card's gap as the CPU's own
    spread.  So params are held to 1e-4 round by round, each round on
    the card starting from the CPU's params before it; the free-running
    trajectories are held to identical plan cases, latencies and wall
    clocks and to accuracies within 4/eval_size.
    """
    import torch
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves, tree_map
    rounds = 2
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32,
             backends.cudnn.deterministic)
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.allow_tf32 = False
    backends.cudnn.deterministic = True
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    agg_kernel.weighted_aggregate.launches = 0
    try:
        cpu, cpu_after, cpu_s = _steps("cpu", params, rounds)
        gpu, gpu_after, gpu_s = _steps("cuda", params, rounds)
        _, forced_after, _ = _steps("cuda", params, rounds,
                                    teacher=[params] + cpu_after[:-1])
        _, nudged_after, _ = _steps("cpu", nudged, rounds)
    finally:
        (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32,
         backends.cudnn.deterministic) = saved
    launches = agg_kernel.weighted_aggregate.launches

    def err(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    g, c = gpu.result, cpu.result
    per_round = [err(a, b) for a, b in zip(forced_after, cpu_after)]
    acc_err = max(abs(a - b) for a, b in zip(g.accuracies, c.accuracies))
    ok = (g.cases == c.cases and g.latencies == c.latencies
          and g.times == c.times and max(per_round) <= 1e-4
          and acc_err <= 4 / gpu.cfg.eval_size)
    emit({"phase": "card_vs_cpu", "ok": ok, "rounds": rounds,
          "tf32": {"matmul": False, "cudnn": False},
          "cudnn_deterministic": True,
          "execution": {"cuda": gpu.execution, "cpu": cpu.execution},
          "cases_equal": g.cases == c.cases,
          "latencies_equal": g.latencies == c.latencies,
          "times_equal": g.times == c.times,
          "param_abs_err_per_round": per_round, "param_tolerance": 1e-4,
          "trajectory_param_abs_err": [err(a, b) for a, b in
                                       zip(gpu_after, cpu_after)],
          "cpu_nudged_param_abs_err": [err(a, b) for a, b in
                                       zip(nudged_after, cpu_after)],
          "max_accuracy_err": acc_err,
          "accuracy_tolerance": 4 / gpu.cfg.eval_size,
          "accuracies": {"cuda": g.accuracies, "cpu": c.accuracies},
          "wall_s": {"cuda": gpu_s, "cpu": cpu_s},
          "fedavg_agg_launches": launches})
    if not ok:
        raise RuntimeError("card and CPU runs disagree")


def phase_vgg11(agg_kernel):
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.obs import ObsConfig, Tracer
    # at the default lr=0.05 VGG-11 (no normalization layers) diverges
    # to NaN in its first round, in the reference as in the port; 0.005
    # keeps it finite, so that the output can be checked
    cfg = FLConfig(dataset="cifar10", n_rounds=2, lr=0.005)
    tracer = Tracer(ObsConfig(path=None))
    agg_kernel.weighted_aggregate.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = run_fl(cfg, tracer=tracer)
    torch.cuda.synchronize()
    launches = agg_kernel.weighted_aggregate.launches
    round_ends = [s.t_wall + s.dur_wall for s in tracer.spans
                  if s.kind == "round"]
    per_round = [b - a for a, b in zip([0.0] + round_ends, round_ends)]
    ok = (launches == cfg.n_rounds
          and all(math.isfinite(v) for v in res.accuracies + res.losses))
    emit({"phase": "vgg11", "ok": ok, "config": cfg.dataset, "lr": cfg.lr,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "fedavg_agg_launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not ok:
        raise RuntimeError("VGG-11 rounds: not one launch a round, or "
                           "non-finite accuracies or losses")


def _wall(run):
    """``run()``'s result and its host seconds, ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_propagation():
    """Coverage windows of ``paper`` (80 satellites, 48 h at 10 s) and
    ``mega_constellation`` (1,080 satellites, 2 regions, 6 h) with the
    torch backend on the card against NumPy: every interval identical.
    Times on the host clock: the whole ``access_intervals_multi`` and
    ``visibility`` alone (the part that runs on the card), each the
    median of 5 calls after one that warms both backends up."""
    import numpy as np
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import propagation as P

    def median_wall(run):
        walls = [_wall(run) for _ in range(5)]
        return walls[0][0], statistics.median(w for _, w in walls)

    out, ok = {}, True
    for name in ("paper", "mega_constellation"):
        scn = get_scenario(name)
        ws = scn.build_constellation()
        t = np.arange(0.0, scn.horizon, scn.dt)
        for backend in ("torch", "numpy"):
            P.access_intervals_multi(ws, scn.regions, scn.horizon, scn.dt,
                                     backend=backend)
        got, torch_s = median_wall(lambda: P.access_intervals_multi(
            ws, scn.regions, scn.horizon, scn.dt, backend="torch"))
        want, numpy_s = median_wall(lambda: P.access_intervals_multi(
            ws, scn.regions, scn.horizon, scn.dt, backend="numpy"))
        vis_torch, vis_torch_s = median_wall(lambda: P.visibility(
            ws, scn.regions, t, backend="torch"))
        vis_numpy, vis_numpy_s = median_wall(lambda: P.visibility(
            ws, scn.regions, t, backend="numpy"))
        same = all([(i.sat, i.start, i.end) for i in got[r]]
                   == [(i.sat, i.start, i.end) for i in want[r]]
                   for r in want) and list(got) == list(want)
        same_mask = bool((vis_torch == vis_numpy).all())
        ok = ok and same and same_mask
        out[name] = {"shape": [len(scn.regions), len(t), ws.n_sats],
                     "intervals": {r: len(v) for r, v in want.items()},
                     "intervals_identical": same,
                     "mask_identical": same_mask,
                     "torch_s": torch_s, "numpy_s": numpy_s,
                     "visibility_torch_s": vis_torch_s,
                     "visibility_numpy_s": vis_numpy_s}
    emit({"phase": "propagation", "ok": ok, **out})
    if not ok:
        raise RuntimeError("propagation: the card's windows differ from "
                           "NumPy's")


def _tf32_off():
    """TF32 off for matmul and cuDNN, cuDNN deterministic; returns the
    settings to restore."""
    import torch
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    return saved


def _restore(saved):
    import torch
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
     b.cudnn.deterministic) = saved


def phase_scenario_paper(launchers):
    """``run_fl`` with the Walker-Star constellation setting each round's
    T_i — the paper preset (48 h of windows) and the bare constellation —
    at the paper's 50 devices, 5 air nodes and the MNIST CNN, 3 rounds on
    the card: one ``fedavg_agg`` launch a round.  The same run with
    ``device="cpu"`` gives identical plan cases, realized latencies and
    wall clocks, and accuracies within 4/eval_size (TF32 off on both)."""
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.models.cnn import build_model
    from repro_torch.obs import ObsConfig, Tracer
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    total, out, ok = 0, {}, True
    saved = _tf32_off()
    try:
        for label, kw in (("scenario=paper", dict(scenario="paper")),
                          ("use_constellation", dict(use_constellation=True))):
            cfg = FLConfig(n_rounds=3, **kw)
            tracer = Tracer(ObsConfig(path=None))
            set_counts(launchers)
            res, wall = _wall(lambda: run_fl(cfg, tracer, params=params))
            launches = read_counts(launchers)["fedavg_agg"]
            total += launches
            cpu = run_fl(FLConfig(n_rounds=3, device="cpu", **kw),
                         params=params)
            ends = [s.t_wall + s.dur_wall for s in tracer.spans
                    if s.kind == "round"]
            acc_err = max(abs(a - b) for a, b in zip(res.accuracies,
                                                     cpu.accuracies))
            good = (launches == cfg.n_rounds and res.cases == cpu.cases
                    and res.latencies == cpu.latencies
                    and res.times == cpu.times
                    and acc_err <= 4 / cfg.eval_size
                    and all(math.isfinite(a) for a in res.accuracies))
            ok = ok and good
            out[label] = {
                "ok": good, "execution": cfg.resolved_execution(),
                "fedavg_agg_launches": launches, "wall_s": wall,
                "round_wall_s": [b - a for a, b in zip(ends, ends[1:])],
                "cases": res.cases, "latencies": res.latencies,
                "times": res.times, "accuracies": res.accuracies,
                "cpu_accuracies": cpu.accuracies,
                "max_accuracy_err": acc_err,
                "accuracy_tolerance": 4 / cfg.eval_size,
                "cases_latencies_times_equal": (
                    res.cases == cpu.cases and res.latencies == cpu.latencies
                    and res.times == cpu.times)}
    finally:
        _restore(saved)
    emit({"phase": "scenario_paper", "ok": ok, "tf32": False, **out})
    if not ok:
        raise RuntimeError("scenario_paper: not one fedavg_agg launch a "
                           "round, or card and CPU runs disagree")
    return total


def _timed_engine(engine):
    """Wrap the engine's trainers' steps and its merge with host clocks
    that end in a synchronize; returns the lists they fill."""
    import torch
    steps, merges = [], []

    def timed(fn, sink):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        return run

    for t in engine.trainers:
        t.step = timed(t.step, steps)
    engine._policy_merge = timed(engine._policy_merge, merges)
    return steps, merges


def _merge_fields(ev):
    return [ev.barrier_round, ev.time, list(ev.staleness), list(ev.weights),
            list(ev.isl_costs), ev.policy, ev.hub, list(ev.participants),
            list(ev.recipients)]


def phase_engine_fl(launchers):
    """``SAGINEngine("multi_region", fl=FLConfig(n_devices=20, n_air=2),
    backend="torch").run(4)`` on the card: 4 regions x 20 devices x 2 air
    nodes, propagation on the card, a synchronous ring merge every 2
    rounds.  ``fedavg_agg`` launches = one a region-round plus one a
    merge; the event order and the first merge's weights, staleness, ISL
    costs and time are those of a 2-round run with ``device="cpu"``.
    Then one more round of every region and its merge under
    ``torch.profiler``: the card's busy share."""
    from repro_torch.fl import FLConfig
    from repro_torch.sim import SAGINEngine
    fl = FLConfig(n_devices=20, n_air=2)
    (eng, build_s) = _wall(lambda: SAGINEngine("multi_region", fl=fl,
                                               backend="torch"))
    steps, merges = _timed_engine(eng)
    set_counts(launchers)
    _, run_s = _wall(lambda: eng.run(4))
    launches = read_counts(launchers)["fedavg_agg"]
    trained = sum(sum(t.result.participated) for t in eng.trainers)
    merged = sum(len(m.participants) > 1 for m in eng.merges)
    cpu = SAGINEngine("multi_region", fl=FLConfig(n_devices=20, n_air=2,
                                                  device="cpu"))
    cpu.run(2)
    n_cpu = len(cpu.step_order)
    same = (eng.step_order[:n_cpu] == cpu.step_order
            and _merge_fields(eng.merges[0]) == _merge_fields(cpu.merges[0]))
    regions = len(eng.trainers)
    ok = (launches == trained + merged and len(eng.merges) == 2
          and trained == 16 and same
          and all(math.isfinite(a) for m in eng.merges
                  for a in m.accuracies))
    rec = {"phase": "engine_fl", "ok": ok, "scenario": "multi_region",
           "regions": regions, "n_devices": fl.n_devices, "n_air": fl.n_air,
           "execution": fl.resolved_execution(), "propagation": "torch",
           "build_s": build_s, "run_s": run_s, "round_wall_s": list(steps),
           # past each region's first round
           "steady_round_wall_s_median": statistics.median(steps[regions:]),
           "merge_wall_s": list(merges),
           "fedavg_agg_launches": launches, "region_rounds": trained,
           "merges": [_merge_fields(m) + [list(m.accuracies)]
                      for m in eng.merges],
           "cpu_first_merge": _merge_fields(cpu.merges[0]),
           "step_order_and_first_merge_equal_cpu": same,
           "summary": eng.summary()}
    prof_wall, by_name = _profile(lambda: eng.run(1))
    emit({**rec, "profiled_round_and_merge": _share(by_name, prof_wall,
                                                    "fedavg_agg")})
    if not ok:
        raise RuntimeError("engine_fl: fedavg_agg launches != region-rounds "
                           "+ merges, or the merges differ from the CPU's")
    return launches


def phase_engine_chaos(launchers):
    """``SAGINEngine("chaos", fl=FLConfig(n_devices=12, n_air=2)).run(6)``
    on the card (3 regions): every fault kind injected and recovered at
    least once, in-round faults always absorbed, quarantined updates
    counted, finite global params."""
    import torch
    from repro_torch.fl import FLConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.resilience import FAULT_KINDS
    from repro_torch.sim import SAGINEngine
    from repro_torch.tree import tree_leaves
    eng = SAGINEngine("chaos", fl=FLConfig(n_devices=12, n_air=2,
                                           obs=ObsConfig(path=None)))
    set_counts(launchers)
    _, run_s = _wall(lambda: eng.run(6))
    launches = read_counts(launchers)["fedavg_agg"]
    inj = eng.fault_injector
    quarantined = eng.tracer.metrics.counter("quarantine.updates").value
    finite = eng.global_params is not None and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(eng.global_params))
    ok = (all(inj.injected[k] > 0 and inj.recovered[k] > 0
              for k in FAULT_KINDS)
          and all(inj.recovered[k] >= inj.injected[k]
                  for k in ("sat_loss", "straggler", "nan_update",
                            "trainer_crash"))
          and quarantined > 0 and finite)
    emit({"phase": "engine_chaos", "ok": ok, "regions": len(eng.trainers),
          "execution": eng.trainers[0].execution, "run_s": run_s,
          "injected": dict(inj.injected), "recovered": dict(inj.recovered),
          "quarantined_updates": quarantined, "global_params_finite": finite,
          "merges": [_merge_fields(m) for m in eng.merges],
          "fedavg_agg_launches": launches})
    if not ok:
        raise RuntimeError("engine_chaos: a fault kind was not injected and "
                           "recovered, or the global params are not finite")


def _curves(eng):
    """Every region's result curves, NaN loss sentinels by repr."""
    return {name: [r.times, r.accuracies, [repr(x) for x in r.losses],
                   r.latencies, r.cases, r.participated]
            for name, r in eng.fl_results.items()}


def _max_param_err(a, b):
    """Largest difference between two engines' region and global params
    (on the host; 0.0 where every leaf is equal)."""
    from repro_torch.tree import tree_leaves
    trees = [(x.params, y.params) for x, y in zip(a.trainers, b.trainers)]
    trees.append((a.global_params, b.global_params))
    return max(float((x.cpu() - y.cpu()).abs().max())
               for p, q in trees
               for x, y in zip(tree_leaves(p), tree_leaves(q)))


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _engine_launches(*engines):
    """``fedavg_agg`` launches the runs of ``engines`` should have made:
    one a trained region-round and one a merge of more than one region."""
    return sum(sum(sum(t.result.participated) for t in e.trainers)
               + sum(len(m.participants) > 1 for m in e.merges)
               for e in engines)


def phase_engine_resume(launchers, tmp):
    """``SAGINEngine("multi_region", fl=FLConfig(n_devices=20, n_air=2),
    backend="torch")`` on the card: ``run(4)`` against ``run(2,
    final_merge=False)`` + ``save_engine`` + a fresh engine's
    ``restore_engine`` + ``run(2)``, with deterministic algorithms on
    for this phase.  Cases, latencies, wall clocks and merges must be
    identical; params identical, or (where the card is not
    deterministic) within 1e-4 with accuracies within 4/eval_size.
    Host walls of the save and the restore, the checkpoint's bytes, and
    the ``fedavg_agg`` launches of the three runs.  Returns the restored
    engine (its trace at ``tmp/serve.jsonl``) and the launches."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import restore_engine, save_engine
    from repro_torch.fl import FLConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.sim import SAGINEngine
    fl = FLConfig(n_devices=20, n_air=2)

    def build(**kw):
        return SAGINEngine("multi_region", fl=dataclasses.replace(fl, **kw),
                           backend="torch")

    ckpt = str(Path(tmp) / "ckpt")
    b = torch.backends.cudnn
    saved = (b.deterministic, b.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    b.deterministic, b.benchmark = True, False
    try:
        set_counts(launchers)
        full = build()
        full.run(4)
        seg = build()
        seg.run(2, final_merge=False)
        _, save_s = _wall(lambda: save_engine(seg, ckpt))
        res = build(obs=ObsConfig(path=str(Path(tmp) / "serve.jsonl")))
        _, restore_s = _wall(lambda: restore_engine(res, ckpt))
        res.run(2)
        torch.cuda.synchronize()
        launches = read_counts(launchers)["fedavg_agg"]
    finally:
        torch.use_deterministic_algorithms(False)
        b.deterministic, b.benchmark = saved
    # the resumed engine's curves and merges hold the segment's too
    expected = _engine_launches(full, res)
    err = _max_param_err(full, res)
    eval_size = fl.eval_size
    curves, rcurves = _curves(full), _curves(res)
    # cases, latencies, clocks and participation always; accuracies and
    # losses only where the params are equal
    plane = all(curves[n][i] == rcurves[n][i] for n in curves
                for i in (0, 3, 4, 5))
    acc_err = max(abs(x - y) for n in curves
                  for x, y in zip(curves[n][1], rcurves[n][1]))
    merges_equal = ([_merge_fields(m) for m in full.merges]
                    == [_merge_fields(m) for m in res.merges])
    identical = err == 0.0 and curves == rcurves and full.merges == res.merges
    ok = (plane and merges_equal and len(res.merges) == 2
          and launches == expected and err <= 1e-4
          and acc_err <= 4 / eval_size)
    emit({"phase": "engine_resume", "ok": ok, "scenario": "multi_region",
          "n_devices": fl.n_devices, "n_air": fl.n_air,
          "execution": fl.resolved_execution(),
          "deterministic_algorithms": True,
          "bit_identical": identical, "param_max_abs_err": err,
          "param_tolerance": 1e-4, "max_accuracy_err": acc_err,
          "cases_latencies_clocks_equal": plane,
          "merges_equal": merges_equal,
          "save_s": save_s, "restore_s": restore_s,
          "checkpoint_bytes": _dir_bytes(ckpt),
          "fedavg_agg_launches": launches, "expected_launches": expected,
          "merges": [_merge_fields(m) for m in res.merges]})
    if not ok:
        raise RuntimeError("engine_resume: the resumed run differs from the "
                           "uninterrupted one, or fedavg_agg launches != "
                           "region-rounds + merges")
    return res, launches


def _cpu_twin(engine, tmp, name):
    """A CPU engine of ``engine``'s scenario holding its state (params
    from the card), through a checkpoint.  The satellites of the last
    round (their CPU frequencies, which the gateway prices service times
    from) are not in a checkpoint, as in the reference's: each round
    draws them anew at its start.  So the twin copies them."""
    import copy
    import dataclasses
    from repro_torch.checkpoint import restore_engine, save_engine
    from repro_torch.sim import SAGINEngine
    path = str(Path(tmp) / name)
    save_engine(engine, path)
    cpu = SAGINEngine(engine.scenario.name, fl=dataclasses.replace(
        engine.fl_config, device="cpu", obs=None))
    restore_engine(cpu, path)
    for t, c in zip(engine.trainers, cpu.trainers):
        c.sagin.satellites = copy.deepcopy(t.sagin.satellites)
    return cpu


def _trained(launchers, name):
    """``name`` at its preset's population, trained 1 round on the card
    (propagation there too); its ``fedavg_agg`` launches and the count
    its region-rounds and merges call for."""
    from repro_torch.fl import FLConfig
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import SAGINEngine
    scn = get_scenario(name)
    eng = SAGINEngine(scn, fl=FLConfig(n_devices=scn.n_devices,
                                       n_air=scn.n_air), backend="torch")
    set_counts(launchers)
    eng.run(1)
    return eng, read_counts(launchers)["fedavg_agg"], _engine_launches(eng)


def _session(engine, cpu, serve, duration, t0):
    """One gateway session on the card and the same on the CPU: the
    card's report and gateway, and how far the two agree."""
    from repro_torch.serve import ServeGateway
    gw, gw_cpu = (ServeGateway(engine, serve=serve),
                  ServeGateway(cpu, serve=serve))
    rep, rep_cpu = gw.run(duration, t0=t0), gw_cpu.run(duration, t0=t0)
    same = (rep.requests == rep_cpu.requests
            and rep.count_by_target == rep_cpu.count_by_target
            and [(r.rid, r.target, r.latency, r.wait) for r in gw.completed]
            == [(r.rid, r.target, r.latency, r.wait)
                for r in gw_cpu.completed])
    acc_err = abs(rep.served_accuracy - rep_cpu.served_accuracy)
    ok = (same and rep.served == rep.requests > 0
          and acc_err <= 4 / rep.served)
    return rep, {"ok": ok, "router": rep.router, "requests": rep.requests,
                 "served": rep.served, "batches": rep.batches,
                 "qps_sim": rep.qps_sim, "qps_wall": rep.qps_wall,
                 "qps_wall_cpu": rep_cpu.qps_wall,
                 "latency_p50": rep.latency_p50,
                 "latency_p99": rep.latency_p99,
                 "wait_mean": rep.wait_mean,
                 "served_accuracy": rep.served_accuracy,
                 "served_accuracy_cpu": rep_cpu.served_accuracy,
                 "accuracy_tolerance": 4 / rep.served,
                 "count_by_target": rep.count_by_target,
                 "routes_latencies_equal_cpu": same}


def phase_serve_gateway(launchers, resumed, tmp):
    """``ServeGateway`` on the card, each session beside the same session
    on the CPU with the card's params carried over (through a
    checkpoint): identical requests, targets and simulated latencies,
    served accuracy within 4/served.  Sessions: the resumed
    ``multi_region`` engine under its default ``ServeConfig`` (600 s);
    ``flash_crowd`` (3 regions, 12 devices, 2 air nodes, trained 1
    round on the card) under ``min_rt`` and ``static_nearest`` from
    ``t0 = 0`` (600 s); ``degraded_links`` (the paper's population,
    trained 1 round) under both routers at 2 requests/s (900 s from
    ``t0 = 0``), where ``min_rt``'s p99 must beat ``static_nearest``'s:
    the setup of the reference's gate in ``benchmarks/serve.py``.  The
    resumed engine's trace (training, ``resume``, serving) through
    ``python -m repro_torch.obs report``: exit 0, serving and resilience
    sections.  ``qps_wall`` and each ``serve_batch``'s ``dur_wall`` are
    the gateway's host clocks around ``predict``, which ends in a copy
    to the host; one more ``flash_crowd`` session under
    ``torch.profiler`` gives the card's busy share."""
    import dataclasses
    import os
    from repro_torch.serve import ServeConfig, ServeGateway
    out = {}
    set_counts(launchers)
    _, out["multi_region"] = _session(resumed, _cpu_twin(resumed, tmp, "mr"),
                                      None, 600.0, None)
    serve_launches = read_counts(launchers)["fedavg_agg"]
    batch_walls = [s.dur_wall for s in resumed.tracer.spans
                   if s.kind == "serve_batch"]
    out["multi_region"]["serve_batch_dur_wall_ms_median"] = (
        statistics.median(batch_walls) * 1e3)
    out["multi_region"]["serve_batches_traced"] = len(batch_walls)

    launches, expected, p99 = 0, 0, {}
    for name, duration in (("flash_crowd", 600.0), ("degraded_links", 900.0)):
        eng, n, want = _trained(launchers, name)
        launches, expected = launches + n, expected + want
        twin = _cpu_twin(eng, tmp, name)
        base = eng.scenario.serve or ServeConfig(base_rate=2.0)
        for router in ("min_rt", "static_nearest"):
            rep, out[f"{name}/{router}"] = _session(
                eng, twin, dataclasses.replace(base, router=router),
                duration, 0.0)
            p99[name, router] = rep.latency_p99
        if name == "flash_crowd":
            gw = ServeGateway(eng, serve=base)
            prof_wall, by_name = _profile(lambda: gw.run(duration, t0=0.0))
    gate = (p99["degraded_links", "min_rt"]
            < p99["degraded_links", "static_nearest"])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report",
         str(Path(tmp) / "serve.jsonl")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    report_ok = (proc.returncode == 0 and "serving (" in proc.stdout
                 and "1 resume(s)" in proc.stdout)
    ok = (all(v["ok"] for v in out.values()) and report_ok and gate
          and launches == expected and serve_launches == 0)
    emit({"phase": "serve_gateway", "ok": ok, **out,
          "degraded_links_min_rt_p99_below_static_nearest": gate,
          "flash_crowd_min_rt_p99_below_static_nearest":
              p99["flash_crowd", "min_rt"]
              < p99["flash_crowd", "static_nearest"],
          "training_fedavg_agg_launches": launches,
          "training_expected_launches": expected,
          "serving_fedavg_agg_launches": serve_launches,
          "report_exit_code": proc.returncode, "report_sections_ok": report_ok,
          "report_tail": proc.stdout[-1200:],
          "profiled_flash_crowd_session": _share(by_name, prof_wall)})
    if not ok:
        raise RuntimeError("serve_gateway: card and CPU sessions differ, "
                           "min_rt's p99 is not below static_nearest's "
                           "under degraded_links, or the trace report "
                           "failed")
    return launches


def _free() -> None:
    """Return the cached blocks of the tensors dropped so far."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _profile(run):
    """``run()`` once under ``torch.profiler``: wall ms, and device ms
    and count by kernel name.  Device activity only, so that the host
    side runs at its own pace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            ms, n = by_name.get(ev.key, (0.0, 0))
            by_name[ev.key] = (ms + dev_us / 1e3, n + ev.count)
    return wall_ms, by_name


def _share(by_name, wall_ms, *needles):
    """The card's busy ms and share of the wall ms, the top kernels and,
    for each of ``needles``, the device ms of the kernels whose name
    holds it."""
    if not by_name:
        return {"profile": "not measured"}
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"profile_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms,
           "kernels": sum(n for _, n in by_name.values()),
           "top_kernels_ms": [[name[:80], ms, n] for name, (ms, n) in top]}
    for needle in needles:
        own = [(ms, n) for name, (ms, n) in by_name.items()
               if needle in name]
        out.update({f"{needle}_ms": sum(ms for ms, _ in own),
                    f"{needle}_kernels": sum(n for _, n in own),
                    f"{needle}_share_of_busy":
                        sum(ms for ms, _ in own) / busy})
    return out


# The profile's groups: a kernel counts in the first group one of whose
# needles its name holds (lower case); the top-k kernels' names hold
# "gather", so sort/top-k comes before gather/scatter, and the indexing
# kernels' names hold "elementwise", so gather/scatter comes before it
PROFILE_GROUPS = (
    ("attention_kernels", ("flash_attention", "fa_bwd", "dkdv_wgmma",
                           "dq_wgmma", "wkv6")),
    ("sort_topk", ("sort", "topk")),
    ("gather_scatter", ("index", "gather", "scatter")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax", ("softmax",)),
    ("elementwise_reduce", ("elementwise", "reduce")),
)


def _groups(by_name):
    """Device ms of each ``PROFILE_GROUPS`` group (and of the kernels in
    none, ``other``) and its share of the busy time."""
    if not by_name:
        return {"profile_groups": "not measured"}
    ms = {name: 0.0 for name, _ in PROFILE_GROUPS}
    ms["other"] = 0.0
    for kernel, (t, _) in by_name.items():
        low = kernel.lower()
        group = next((name for name, needles in PROFILE_GROUPS
                      if any(n in low for n in needles)), "other")
        ms[group] += t
    busy = sum(ms.values())
    return {"profile_groups": {name: {"ms": t, "share_of_busy": t / busy}
                               for name, t in ms.items()}}


def _model_inputs(cfg, lead, seq, gen):
    """Random inputs of ``lead`` + (seq,) positions on the card: tokens,
    or for an embeddings config (a modality frontend's output) unit
    normal embeddings of width d_model."""
    import torch
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab_size, (*lead, seq), generator=gen,
                             device="cuda")
    return torch.randn((*lead, seq, cfg.d_model), generator=gen,
                       device="cuda")


def _attention_shape(cfg, batch, seq):
    """The shape ``flash_attention`` gets from ``cfg`` at ``batch`` x
    ``seq``: q's, the KV heads and the window."""
    return {"q": (batch, cfg.n_heads, seq, cfg.head_dim),
            "kv_heads": cfg.n_kv_heads, "window": cfg.sliding_window}


def _prefill_run(launchers, cfg, batch, seq, needle):
    """Full-width prefill of ``cfg`` (random weights from seed 0) through
    ``make_prefill_step``: one warm-up call, then the counted call and a
    profiled one.  Returns the record and the counts."""
    import torch
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_in = {"inputs": _model_inputs(cfg, (batch,), seq, gen)}
    prefill(params, batch_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(launchers)
    t0 = time.perf_counter()
    logits = prefill(params, batch_in)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts(launchers)
    MEASURED_STEPS.append({"config": cfg, "kind": "prefill", "batch": batch,
                           "seq_len": seq, "wall_s": wall_s})
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == (batch, cfg.padded_vocab)
    prof_wall, by_name = _profile(lambda: prefill(params, batch_in))
    rec = {"config": cfg.name, "dtype": cfg.param_dtype, "batch": batch,
           "seq_len": seq,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "init_s": init_s, "wall_s": wall_s,
           "tokens_per_s": batch * seq / wall_s, "peak_memory_gib": peak,
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": counts, **_share(by_name, prof_wall, needle),
           **_groups(by_name)}
    del params, logits
    _free()
    return rec, counts, finite and shape_ok


def phase_transformer_prefill(launchers, batch=4, seq=2048):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b")
    rec, counts, ok = _prefill_run(launchers, cfg, batch, seq,
                                   "flash_attention")
    ok = ok and counts["flash_attention"] == cfg.n_layers
    emit({"phase": "transformer_prefill", "ok": ok, **rec})
    if not ok:
        raise RuntimeError("llama3.2-3b prefill: flash_attention launches "
                           "!= n_layers or non-finite logits")
    return counts["flash_attention"], _attention_shape(cfg, batch, seq)


# The MoE configs at full width, and the depth their prefill runs at
# (None: their own).  deepseek-v2-lite-16b (MLA + MoE, 16.2 B params,
# 32 GB in bf16) fits one card at full depth; qwen3-moe-235b-a22b (~2.5 B
# params a layer) runs 4 of its 94 layers (22 GB)
MOE_LAYERS = {"deepseek-v2-lite-16b": None, "qwen3-moe-235b-a22b": 4}
# Training adds the gradients (as many bytes again) and one block's
# recompute.  deepseek-v2-lite-16b at full depth peaks at 64.8 GiB
# allocated, but the allocator's cached blocks fill the card's 79.2 GiB
# (NVIDIA H100 80GB HBM3) and a step can run out of memory; 20 of its 27
# layers leave ~14 GiB of room
MOE_TRAIN_LAYERS = {"deepseek-v2-lite-16b": 20, "qwen3-moe-235b-a22b": 4}


# jamba-1.5-large-398b (hybrid: 1 GQA + 7 Mamba layers a block, dense and
# 16-expert MoE FFNs alternating, d 8192) at full width: one 8-layer block
# with its 16 experts holds 42.3 B params (78.8 GiB in bf16) and does not
# fit the card (NVIDIA H100 80GB HBM3); with 4 of the 16 (top-2 kept) it
# is 16.2 B.  Every phase runs that one block, or a cut of it to 2 layers
# (``attn_every`` 2: GQA with the dense FFN, then Mamba with the MoE FFN)
HYBRID = "jamba-1.5-large-398b"
CUTS = {HYBRID: {"n_layers": 8, "n_experts": 4}}


def _config(name, n_layers=None, **changes):
    """``name``'s config with its ``CUTS``, cut to ``n_layers`` if given
    (a hybrid's block then shrinks to ``n_layers``, attention first)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    changes = {**CUTS.get(name, {}), **changes}
    if n_layers is not None:
        changes["n_layers"] = n_layers
        if cfg.attn_every and n_layers < cfg.attn_every:
            changes["attn_every"] = n_layers
    return dataclasses.replace(cfg, **changes)


def _full_depth(cfg):
    from repro_torch.configs import get_config
    return cfg.n_layers == get_config(cfg.name).n_layers


def _mixer_layers(cfg, mixer):
    """The layers of ``cfg`` whose mixer is ``mixer``."""
    from repro_torch.models import transformer as T
    return T.n_blocks(cfg) * sum(s.mixer == mixer
                                 for s in T.block_template(cfg))


# The mixer that runs each forward kernel (its backward follows it)
KERNEL_MIXER = {"flash_attention": "gqa", "wkv6": "rwkv6"}


def _attention_layers(cfg):
    """The layers whose attention goes through ``flash_attention``: GQA
    ones (MLA is plain torch, as in the reference)."""
    return _mixer_layers(cfg, "gqa")


def phase_moe_prefill(launchers, batch=4, seq=2048):
    """``make_prefill_step`` on each MoE config of ``MOE_LAYERS`` at full
    width, B = 4 x 2048 tokens: finite logits, one ``flash_attention``
    launch a GQA layer (qwen3-moe) and none for MLA (deepseek), wall,
    tokens/s, peak memory, the busy share and the profile's groups.
    Returns the attention launches and qwen3-moe's attention shape."""
    launches, shape = 0, None
    for name, n_layers in MOE_LAYERS.items():
        cfg = _config(name, n_layers)
        rec, counts, ok = _prefill_run(launchers, cfg, batch, seq,
                                       "flash_attention")
        want = _attention_layers(cfg)
        ok = ok and counts["flash_attention"] == want and all(
            n == 0 for k, n in counts.items() if k != "flash_attention")
        emit({"phase": "moe_prefill", "ok": ok, "n_layers": cfg.n_layers,
              "full_depth": _full_depth(cfg), **rec})
        if not ok:
            raise RuntimeError(f"{name} prefill: non-finite logits, or "
                               f"flash_attention launches != {want}")
        launches += counts["flash_attention"]
        if want:
            shape = _attention_shape(cfg, batch, seq)
    return launches, shape


# The chunked scan against the per-step one on the card: the same
# per-step products, summed over the state in other orders
SCAN_TOL = 1e-5


def _prefill_dt(cfg, batch, seq):
    """The dt that one more prefill (the same weights and tokens as
    ``_prefill_run``'s) feeds each Mamba layer's scan, read by a tap on
    ``_mamba_ssm_scan``: its largest and mean value by layer, and the
    smallest one-step decay exp(dt a) it gives (a >= -d_state)."""
    import torch
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    real = layers._mamba_ssm_scan
    maxes, means = [], []

    def tap(u, dt, b_t, c_t, a, chunk=0):
        maxes.append(float(dt.max()))
        means.append(float(dt.mean()))
        return real(u, dt, b_t, c_t, a, chunk)

    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    layers._mamba_ssm_scan = tap
    try:
        make_prefill_step(cfg)(params, {"inputs": tokens})
        torch.cuda.synchronize()
    finally:
        layers._mamba_ssm_scan = real
    del params
    _free()
    return {"scan_dt_max_per_layer": maxes, "scan_dt_mean_per_layer": means,
            "scan_decay_min": math.exp(-cfg.d_state * max(maxes))}


def _scan_group(cfg, batch, seq, wall_s):
    """The Mamba layers' scan alone at the prefill's shape (B, S, di,
    st), from inputs like the layers' at init (dt ~ 0.01), under
    ``no_grad`` as in the prefill: CUDA-event times of the chunked form
    the layers run (issued from Python, and replayed from a CUDA graph:
    the card's own time) and of the per-step form over the whole
    sequence; the Mamba layers' count times the chunked time as a share
    of the prefill's wall; the chunked output against the per-step one
    (``SCAN_TOL``); and the bound of the scan's work (f32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    di, st = cfg.expand * cfg.d_model, cfg.d_state
    gen = torch.Generator(device="cuda").manual_seed(3)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, b_t, c_t = (normal(batch, seq, n) for n in (di, st, st))
    dt = F.softplus(normal(batch, seq, di) * 0.5 - 4.6)
    a = -torch.arange(1, st + 1, dtype=torch.float32,
                      device="cuda").repeat(di, 1)
    out, ms = {}, {}
    with torch.no_grad():
        for form, chunk in (("chunked", cfg.mamba_scan_chunk),
                            ("per_step", 0)):
            def run(chunk=chunk):
                return L._mamba_ssm_scan(u, dt, b_t, c_t, a, chunk=chunk)
            out[form] = run()
            torch.cuda.synchronize()
            ms[form] = _event_ms(run, 3)
            if form == "chunked":
                device_ms = time_ms(run, reps=1, repeats=3)["device"]
        want = out["per_step"]
        diff = (out["chunked"] - want).abs()
        ok = bool((diff <= SCAN_TOL * (1 + want.abs())).all())
        err = float(diff.max())
    del out, want, diff, u, dt, b_t, c_t
    _free()
    layers = _mixer_layers(cfg, "mamba")
    # u and dt read, y written (B, S, di), b and c read (B, S, st), a;
    # per element of the (B, S, di, st) state: dt a, exp, dt u b (two
    # products), the update (multiply-add) and y's multiply-add
    nbytes = 4 * (3 * batch * seq * di + 2 * batch * seq * st + di * st)
    ops = 8 * batch * seq * di * st
    return {"scan": {"shape": [batch, seq, di, st],
                     "chunk": cfg.mamba_scan_chunk,
                     "chunked_ms": ms["chunked"],
                     "chunked_device_ms": device_ms,
                     "per_step_ms": ms["per_step"],
                     **_bound(nbytes, ops, "float32"),
                     "mamba_layers": layers,
                     "share_of_wall": layers * ms["chunked"] / (wall_s * 1e3),
                     "forms_max_abs_err": err, "tolerance": SCAN_TOL,
                     "ok": ok}}


def phase_hybrid_prefill(launchers, batch=4, seq=2048):
    """``make_prefill_step`` on jamba's block at full width (``CUTS``),
    B = 4 x 2048 tokens: finite logits, one ``flash_attention`` launch
    (its one GQA layer) and no other kernel; wall, tokens/s, peak memory,
    the busy share and the profile's groups; the dt the scans see; and
    the scan group (``_scan_group``).  Returns the attention launches
    and jamba's attention shape."""
    cfg = _config(HYBRID)
    rec, counts, ok = _prefill_run(launchers, cfg, batch, seq,
                                   "flash_attention")
    want = _attention_layers(cfg)
    ok = ok and counts["flash_attention"] == want and all(
        n == 0 for k, n in counts.items() if k != "flash_attention")
    dt = _prefill_dt(cfg, batch, seq)
    scan = _scan_group(cfg, batch, seq, rec["wall_s"])
    ok = ok and scan["scan"]["ok"]
    emit({"phase": "hybrid_prefill", "ok": ok, "n_layers": cfg.n_layers,
          "n_experts": cfg.n_experts, "full_depth": _full_depth(cfg),
          **rec, **dt, **scan})
    if not ok:
        raise RuntimeError(f"{HYBRID} prefill: non-finite logits, "
                           f"flash_attention launches != {want} or others "
                           f"launched, or the chunked scan apart from the "
                           f"per-step one")
    return counts["flash_attention"], _attention_shape(cfg, batch, seq)


def phase_transformer_decode(launchers, name="llama3.2-3b",
                             phase="transformer_decode", batch=8,
                             steps=32):
    """``TransformerBackend`` on full-width ``name`` (with its ``CUTS``)
    answering ``steps`` batches of ``batch`` requests over a
    2048-position cache, after 3 that warm it up (the first allocates the
    cache).  ``predict`` ends in a synchronize, so the host clock around
    it is the request's latency."""
    import numpy as np
    import torch
    from repro_torch.serve import TransformerBackend
    from repro_torch.tree import tree_leaves
    cfg = _config(name)
    be = TransformerBackend(model_cfg=cfg, seq_len=2048)
    rng = np.random.default_rng(0)
    for _ in range(3):
        be.predict(0, None, rng.integers(0, 1 << 20, size=batch))
    set_counts(launchers)
    lat = []
    for _ in range(steps):
        samples = rng.integers(0, 1 << 20, size=batch)
        t0 = time.perf_counter()
        be.predict(0, None, samples)
        lat.append(time.perf_counter() - t0)
    counts = read_counts(launchers)
    finite = bool(torch.isfinite(be.last_logits).all())
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(be._caches[batch]))
    # one more step under the profiler: how long the card is busy
    samples = rng.integers(0, 1 << 20, size=batch)
    wall_ms, by_name = _profile(lambda: be.predict(0, None, samples))
    ok = finite and be._pos[batch] == steps + 4
    emit({"phase": phase, "ok": ok, "config": cfg.name,
          "n_layers": cfg.n_layers, "batch": batch, "seq_len": be.seq_len,
          "steps": steps,
          "per_token_ms_median": statistics.median(lat) * 1e3,
          "per_token_ms_mean": statistics.mean(lat) * 1e3,
          "per_token_ms_max": max(lat) * 1e3,
          "tokens_per_s": batch / statistics.median(lat),
          "cache_gib": cache_bytes / 2**30, "logits_finite": finite,
          "launches": counts,
          "profiled_step": _share(by_name, wall_ms)})
    del be
    _free()
    if not ok:
        raise RuntimeError(f"{name} decode: non-finite logits")


# float32 with TF32 off: prefill and decode take every product through
# other kernels (GEMM vs GEMV; flash_attention vs the decode softmax, or
# wkv6 vs the plain wkv_step), which sum in other orders; ~6e-8 relative
# per rounding over 24-28 layers of 2048-3072-wide sums leaves logits of
# magnitude ~1-5 (a normed hidden state times a 1/sqrt(d) unembedding)
# within ~1e-4, and 1e-3 keeps a decade of room
DECODE_VS_PREFILL_TOL = 1e-3


def _decode_vs_prefill(launchers, name, kernel, seq, n_layers=None,
                       phase="decode_vs_prefill", **changes):
    """Full-width ``name`` in float32, B = 1, at its own depth or cut to
    ``n_layers``: the prefill's logits at all ``seq`` positions (through
    ``kernel``, one launch a layer that runs it; ``None``: no kernel on
    the path)
    against ``seq`` plain ``serve_step``s.  An MoE config runs at the
    capacity factor n_experts / n_experts_active rounded up to an
    integer, where no token drops (``cap`` = S at prefill, = B = 1 at a
    decode step); at its shipping 1.25, decode's global capacity drops
    tokens by design and differs from prefill.  Returns the config."""
    import torch
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    cfg = _config(name, n_layers, param_dtype="float32", **changes)
    if cfg.n_experts:
        cfg = _config(name, n_layers, param_dtype="float32",
                      capacity_factor=float(-(-cfg.n_experts
                                              // cfg.n_experts_active)),
                      **changes)
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.allow_tf32 = False
    try:
        params = T.init_params(cfg, seed=1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = _model_inputs(cfg, (1,), seq, gen)
        set_counts(launchers)
        with torch.no_grad():
            full, _ = T.logits_fn(params, cfg, tokens)
        torch.cuda.synchronize()
        counts = read_counts(launchers)
        step = make_serve_step(cfg)
        cache = T.init_cache(cfg, 1, seq, device="cuda")
        diffs = []
        t0 = time.perf_counter()
        for pos in range(seq):
            logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
            diffs.append((logits[0] - full[0, pos]).abs().max())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        err = float(torch.stack(diffs).max())
        scale = float(full.abs().max())
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    launched = counts[kernel] if kernel else sum(counts.values())
    ok = (launched == (_mixer_layers(cfg, KERNEL_MIXER[kernel]) if kernel
                       else 0)
          and math.isfinite(err) and err <= DECODE_VS_PREFILL_TOL)
    emit({"phase": phase, "ok": ok, "config": cfg.name,
          "n_layers": cfg.n_layers, "dtype": "float32", "tf32": False,
          "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
          "sliding_window": cfg.sliding_window,
          "cache_positions": int(cache[0]["sub0"]["k"].shape[2])
          if "k" in cache[0]["sub0"] else None,
          "seq_len": seq,
          "max_abs_err": err, "tolerance": DECODE_VS_PREFILL_TOL,
          "max_abs_logit": scale, "decode_s": decode_s,
          "launches": counts})
    del params, full, cache
    _free()
    if not ok:
        raise RuntimeError(f"{name}: decode and prefill logits disagree, "
                           f"or launches other than one {kernel} a layer "
                           f"that runs it")
    return cfg


def phase_moe_decode_vs_prefill(launchers):
    """deepseek-v2-lite-16b (MLA: no kernel) and qwen3-moe-235b-a22b
    (flash_attention) at full width, cut to 2 layers, over 64
    positions."""
    _decode_vs_prefill(launchers, "deepseek-v2-lite-16b", None, 64,
                       n_layers=2, phase="moe_decode_vs_prefill")
    _decode_vs_prefill(launchers, "qwen3-moe-235b-a22b", "flash_attention",
                       64, n_layers=2, phase="moe_decode_vs_prefill")


def phase_hybrid_decode_vs_prefill(launchers):
    """jamba at full width, cut to 2 layers (GQA + dense FFN, Mamba + MoE
    FFN), over 256 positions: four chunks of the prefill's scan."""
    _decode_vs_prefill(launchers, HYBRID, "flash_attention", 256,
                       n_layers=2, phase="hybrid_decode_vs_prefill")


def phase_decode_vs_prefill(launchers):
    """llama3.2-3b at 8 layers over 256 positions (the decode steps,
    host-bound, took 23 s at all 28 on an NVIDIA H100 at 700 W), then
    rwkv6-1.6b over 64.

    rwkv6-1.6b runs 2 of its 24 layers: with random weights its layers
    amplify a rounding difference with depth (at all 24 layers decode
    and prefill differed by ~1e-2 in f32 on the card, and the plain path
    on the CPU, with no kernel, widens the same way), so a cut depth
    holds the kernel to a tolerance that a wrong kernel would miss."""
    cfg = _decode_vs_prefill(launchers, "llama3.2-3b", "flash_attention",
                             256, n_layers=8)
    _decode_vs_prefill(launchers, "rwkv6-1.6b", "wkv6", 64, n_layers=2)
    return _attention_shape(cfg, 1, 256)


def _prefill_decays(cfg, params, batch, seq):
    """The decays ``w`` that one more prefill (the same weights and
    tokens as ``_prefill_run``'s) feeds the ``wkv6`` kernel, read by a tap
    on the op's kernel module: their minimum, and each layer's 0.1 %
    quantile."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch.train import make_prefill_step
    real = wkv_ops.kernel
    mins, quantiles = [], []

    class Tap:
        def wkv(self, r, k, v, w, u):
            flat = w.flatten().float()
            mins.append(float(flat.min()))
            kth = max(1, int(flat.numel() * 1e-3))
            quantiles.append(float(torch.kthvalue(flat, kth).values))
            return real.wkv(r, k, v, w, u)

    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    wkv_ops.kernel = Tap()
    try:
        make_prefill_step(cfg)(params, {"inputs": tokens})
        torch.cuda.synchronize()
    finally:
        wkv_ops.kernel = real
    return {"w_min": min(mins), "w_q001_per_layer": quantiles,
            "w_q001_min": min(quantiles)}


def phase_rwkv6(launchers, batch=4, seq=2048, decode_steps=8):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    cfg = get_config("rwkv6-1.6b")
    rec, counts, ok = _prefill_run(launchers, cfg, batch, seq, "wkv6")
    ok = ok and counts["wkv6"] == cfg.n_layers
    params = T.init_params(cfg, seed=0, device="cuda")
    decays = _prefill_decays(cfg, params, batch, seq)
    # decode: a few steps from an empty state
    step = make_serve_step(cfg)
    cache = T.init_cache(cfg, batch, seq, device="cuda")
    tokens = torch.arange(batch, device="cuda")[:, None]
    lat = []
    for pos in range(decode_steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tokens + pos, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    ok = ok and finite
    emit({"phase": "rwkv6", "ok": ok, **rec, **decays,
          "decode_steps": decode_steps,
          "decode_per_token_ms_median": statistics.median(lat[1:]) * 1e3,
          "decode_logits_finite": finite})
    del params, cache, logits
    _free()
    if not ok:
        raise RuntimeError("rwkv6-1.6b: wkv6 launches != n_layers or "
                           "non-finite logits")
    h = cfg.d_model // 64
    return counts["wkv6"], (batch, h, seq, cfg.d_model // h)


def _flash_case(fa_kernel, fa_ref, q_shape, hkv, window, dtype_name, seed):
    """One kernel-vs-plain comparison of flash_attention, with times."""
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    b, hq, s, d = q_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    want = fa_ref.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = FLASH_TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    # the one PyTorch call that computes the same function (timed only)
    idx = torch.arange(s, device="cuda")
    if window is None or window >= s:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        pairs = s * (s + 1) // 2
    else:
        mask = ((idx[None, :] <= idx[:, None])
                & (idx[None, :] > idx[:, None] - window))

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        pairs = int(mask.sum())
    lib_diff = (library().float() - want.float()).abs()
    lib_err = float(lib_diff.max())
    # elements past the tolerance, the kernel's and (as a yardstick, not
    # checked) the library's
    limit = tol * (1 + want.float().abs())
    over, lib_over = int((diff > limit).sum()), int((lib_diff > limit).sum())
    del lib_diff, limit
    # q and out written/read once, k and v read once; 2 FLOP per
    # multiply-add of q.k and of p.v over the unmasked pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    ops = 4 * d * pairs * b * hq
    big = nbytes > 50e6
    times = _times({"kernel": lambda: fa_kernel.flash_attention(
                        q, k, v, causal=True, window=window),
                    "plain": lambda: fa_ref.attention(q, k, v, causal=True,
                                                      window=window),
                    "library": library}, big)
    bound = _bound(nbytes, ops, dtype_name)
    return {
        "q_shape": list(q_shape), "kv_heads": hkv, "window": window,
        "dtype": dtype_name, "max_abs_err": float(diff.max()),
        "tolerance": tol, "ok": ok, "library_max_abs_err": lib_err,
        "past_tolerance": over, "library_past_tolerance": lib_over,
        **times, **bound,
        # achieved rate and the share of the bound the kernel reaches
        "kernel_tflops": ops / times["kernel_ms"] / 1e9,
        "bound_share": bound["bound_ms"] / times["kernel_ms"],
    }


FLASH_SWEEP = [((1, 2, 128, 32), 2), ((2, 4, 256, 64), 2),
               ((1, 8, 128, 64), 1), ((2, 4, 512, 16), 4),
               ((2, 4, 200, 64), 2)]


def _dense_cases(case_fn, dense_shapes, seed):
    """``case_fn`` in bf16 at each of ``DENSE_KERNEL_SHAPES``'s attention
    shapes, by config name."""
    return {name: case_fn(dense_shapes[name]["q"],
                          dense_shapes[name]["kv_heads"],
                          dense_shapes[name]["window"], "bfloat16", seed + i)
            for i, name in enumerate(DENSE_KERNEL_SHAPES)}


def phase_flash_kernel(fa_kernel, fa_ref, prefill_shapes, f32_shapes,
                       moe_shapes, hybrid_shapes, dense_shapes):
    """The main path's shape in bf16 (as it runs) and in f32 (a tight
    check over its 32 KV tiles), the f32 ``decode_vs_prefill`` shape,
    qwen3-moe's and jamba's prefill shapes in bf16 (GQA groups of 16 and
    8 at head dim 128), ``DENSE_KERNEL_SHAPES`` in bf16 (groups of 7 and
    1 at head dims 64 and 128), and the reference's sweep; the plain
    version's f32 einsums with TF32 off."""
    import torch
    main = (prefill_shapes["q"], prefill_shapes["kv_heads"],
            prefill_shapes["window"])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = {"main": _flash_case(fa_kernel, fa_ref, *main, "bfloat16",
                                     0),
                 "main-float32": _flash_case(fa_kernel, fa_ref, *main,
                                             "float32", 0),
                 "decode_vs_prefill": _flash_case(
                     fa_kernel, fa_ref, f32_shapes["q"],
                     f32_shapes["kv_heads"], f32_shapes["window"],
                     "float32", 1),
                 "qwen3-moe": _flash_case(
                     fa_kernel, fa_ref, moe_shapes["q"],
                     moe_shapes["kv_heads"], moe_shapes["window"],
                     "bfloat16", 2),
                 "jamba": _flash_case(
                     fa_kernel, fa_ref, hybrid_shapes["q"],
                     hybrid_shapes["kv_heads"], hybrid_shapes["window"],
                     "bfloat16", 3),
                 **_dense_cases(lambda *a: _flash_case(fa_kernel, fa_ref,
                                                       *a),
                                dense_shapes, 4)}
        for i, (q_shape, hkv) in enumerate(FLASH_SWEEP):
            for window in (None, 64):
                for dtype_name in ("float32", "bfloat16"):
                    cases[f"sweep{i}-{window}-{dtype_name}"] = _flash_case(
                        fa_kernel, fa_ref, q_shape, hkv, window, dtype_name,
                        10 + i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for name, case in cases.items():
        emit({"phase": "flash_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention disagrees with its plain "
                           f"version: {bad}")
    return cases["main"]


def _wkv_case(wkv_kernel, wkv_ref, shape, dtype_name, seed, w_lo=0.7):
    """One kernel-vs-plain comparison of wkv6, with times.  ``w_lo`` = 0:
    decays from [0, 0.999] with exact zeros (every 5th step of every 3rd
    channel), where a chunk's decay product underflows."""
    import torch
    dtype = getattr(torch, dtype_name)
    b, h, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(sh, scale=1.0):
        return (torch.randn(sh, generator=gen, device="cuda")
                * scale).to(dtype)

    r, k, v = normal(shape), normal(shape, 0.3), normal(shape)
    w = w_lo + (0.999 - w_lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    if w_lo == 0.0:
        w[:, :, ::5, ::3] = 0.0
    w = w.to(dtype)
    u = normal((h, d), 0.1)
    got = wkv_kernel.wkv(r, k, v, w, u)
    want = wkv_ref.wkv(r, k, v, w, u)  # the step-by-step oracle
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = WKV_TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    if t % 64 == 0:  # the plain form the dispatcher takes off the card
        def plain():
            return wkv_ref.wkv_chunked(r, k, v, w, u, chunk=64)
    else:
        def plain():
            return wkv_ref.wkv(r, k, v, w, u)
    # r, k, v, w read and out written once, u read once
    nbytes = (5 * r.numel() + u.numel()) * r.element_size()
    if dtype_name == "bfloat16" and d >= 16:
        # the chunked form's tensor-core products as the kernel issues
        # them, per 16-step sub-chunk (T padded to 64-step chunks): the
        # cross term 3 x 2*16*d*d and the state update 2 x 2*16*d*d (hi
        # and lo parts), the intra term 2 x 2*16*16*d, at the bf16 rate
        subs = -(-t // 64) * 4
        bound = _bound(nbytes, b * h * subs * (160 * d * d + 1024 * d),
                       "bfloat16")
    else:
        # the recurrence on the CUDA cores, in f32: 2 FLOP per multiply-
        # add of the output's contraction with the state and of the
        # state's decay and update
        bound = _bound(nbytes, 4 * d * d * t * b * h, "float32")
    return {
        "shape": list(shape), "dtype": dtype_name, "w_lo": w_lo,
        "max_abs_err": float(diff.max()),
        "max_abs_out": float(want.float().abs().max()), "tolerance": tol,
        "ok": ok, "plain_form": "wkv_chunked" if t % 64 == 0 else "wkv",
        **_times({"kernel": lambda: wkv_kernel.wkv(r, k, v, w, u),
                  "plain": plain, "library": None}, nbytes > 50e6),
        **bound,
    }


WKV_SWEEP = [(1, 1, 32, 8), (2, 3, 64, 16), (1, 2, 128, 64), (2, 2, 96, 32),
             (2, 4, 200, 64)]


def phase_wkv_kernel(wkv_kernel, wkv_ref, main_shape):
    cases = {}
    for w_lo, tag in ((0.7, ""), (0.0, "-strong")):
        cases[f"main{tag}"] = _wkv_case(wkv_kernel, wkv_ref, main_shape,
                                        "bfloat16", 0, w_lo)
        cases[f"main{tag}-float32"] = _wkv_case(
            wkv_kernel, wkv_ref, main_shape, "float32", 0, w_lo)
        for i, shape in enumerate(WKV_SWEEP):
            for dtype_name in ("float32", "bfloat16"):
                cases[f"sweep{i}{tag}-{dtype_name}"] = _wkv_case(
                    wkv_kernel, wkv_ref, shape, dtype_name, 10 + i, w_lo)
    for name, case in cases.items():
        emit({"phase": "wkv_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"wkv6 disagrees with its plain version: {bad}")
    return cases["main"]


# ---------------------------------------------------------------------------
# Training: the backward kernels and the train steps
# ---------------------------------------------------------------------------
# The backward kernels against autograd through their plain versions in
# float32 on the same input values (tests/test_torch_kernels_cuda.py):
# f32 1e-4 x (1 + |grad|) (the same products summed in other orders);
# bf16 2e-2 x (1 + |grad|) (each gradient rounded to bf16 once; flash
# also rounds P and dZ to bf16 as operands of its tensor-core products
# and reads the forward's bf16-rounded output for delta)
GRAD_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# The forward's log-sum-exp against ref.row_lse: the same f32 sums of the
# same inputs in other orders
LSE_TOLERANCE = 1e-5
# The design each backward call runs on, by type
FLASH_BACKWARD_VARIANT = {"bfloat16": "tensor_cores",
                          "float32": "cuda_cores"}
# wkv f32 at T = 2048: each gradient sums up to ~1,000 decayed terms of
# size up to ~100 (decays near 1 keep long windows), so two f32 orders,
# the kernel's sequential scan and the plain version's chunked products,
# differ by up to ~1e-3 on elements near 0 (9.5e-4 at the main shape with
# decays down to 0 on an NVIDIA H100).  2e-3 holds that and fails a
# wrong kernel, whose errors are of the gradients' own size
WKV_GRAD_TOLERANCE = {"float32": 2e-3, "bfloat16": 2e-2}
# The design each wkv backward call runs on: the chunked form on the
# tensor cores for bf16 at D >= 16, the scan on the CUDA cores otherwise
def _wkv_backward_variant(dtype_name, d):
    return ("tensor_cores" if dtype_name == "bfloat16" and d >= 16
            else "cuda_cores")


# SGD step of the train phases, by config: with random bf16 weights and
# random labels an update has to clear bf16's resolution of the weights
# (2**-8 of them) to move the loss, and not overshoot.  llama3.2-3b falls
# step by step at 0.03.  rwkv6-1.6b at random init is stiffer: at 0.03
# its loss went 11.604, 11.587, 11.592 (this phase, NVIDIA H100 at 700 W);
# at 1e-4 it falls step by step
# jamba's block at B = 1 x 2048 overshoots at 0.03 and 0.01 (losses
# 11.629, 9.186, 10.719, 9.713 at 0.01) and falls step by step at 0.003
# (11.629, 11.039, 10.495, 10.007; NVIDIA H100 at 700 W)
TRAIN_LR = {"llama3.2-3b": 0.03, "rwkv6-1.6b": 1e-4,
            "deepseek-v2-lite-16b": 0.03, "qwen3-moe-235b-a22b": 0.03,
            "jamba-1.5-large-398b": 0.003, "olmo-1b": 0.03,
            "internvl2-1b": 0.03, "musicgen-medium": 0.03,
            "qwen3-32b": 0.03, "deepseek-coder-33b": 0.03}
# One train step's gradients at full width and 2 layers, through the
# kernels and through the plain versions (autograd through ref on the
# card), from the same params and batch.  float32 (TF32 off): each leaf
# within 1e-3 of its norm (the f32 kernels are held to 2e-5 and 1e-4 of
# their outputs).  bf16: both paths round every activation to bf16 in
# their own places, and a leaf whose gradient is a sum with much
# cancellation (rwkv's u, the mixes) moves by tens of percent between
# them; so each bf16 path is held against the float32 plain step, and the
# kernels' error may be at most twice the plain bf16 path's, plus 1e-2
TRAIN_GRAD_TOL = 1e-3
# The loss after one SGD step (at ``TRAIN_LR``) from the same float32
# params (TF32 off), its gradients through the kernels against through the
# plain versions, within 1e-4 x (1 + |loss|): the gradients agree to
# ~1e-5 of their size, and at qwen3-moe's 2 layers the two stepped losses
# differed by 5.9e-6 of the loss (NVIDIA H100, 700 W); a wrong backward
# moves it by about the step's own change of the loss (0.4 there)
STEP_LOSS_TOL = 1e-4


def _grad_check(got, want, tol):
    """Max abs error of ``got`` against ``want``, and whether every
    element is finite and within tol x (1 + |want|)."""
    import torch
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        ok = (ok and bool(torch.isfinite(g).all())
              and bool((d <= tol * (1 + w.abs())).all()))
    return worst, ok


def _past_tolerance(got, want, tol):
    """The number of elements of ``got`` beyond tol x (1 + |want|) of
    ``want``, by gradient, and the largest error."""
    counts, worst = [], 0.0
    for g, w in zip(got, want):
        d = (g.float() - w).abs()
        counts.append(int((d > tol * (1 + w.abs())).sum()))
        worst = max(worst, float(d.max()))
    return counts, worst


def _backward_times(kernel_fn, plain_fn, library_fn, big):
    """The kernel's times as ``_times`` takes them (a replayed CUDA graph
    and eager calls); the plain version's and the library call's
    backward (``torch.autograd.grad`` over a kept graph) as eager calls
    timed with CUDA events."""
    out = _times({"kernel": kernel_fn}, big)
    for key, fn in (("plain", plain_fn), ("library", library_fn)):
        if fn is None:
            out[f"{key}_ms"] = None
            continue
        reps, repeats = _reps(fn, big)

        def run(fn=fn, reps=reps):
            for _ in range(reps):
                fn()
        out[f"{key}_ms"] = _event_ms(run, repeats) / reps
    return out


def _kept_grad(fn, inputs, dout):
    """A callable that runs the backward of ``fn(*inputs)`` again on each
    call (the forward's graph is kept); at T = 1 wkv's decay never reaches
    the output, and its gradient is 0."""
    import torch
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)

    def grads():  # zeros for an input that does not reach the output
        got = torch.autograd.grad(out, leaves, dout, retain_graph=True,
                                  allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(got, leaves)]
    return grads


def _flash_backward_case(fa_kernel, fa_ref, q_shape, hkv, window,
                         dtype_name, seed):
    """The backward kernel against autograd through ``ref.attention``,
    with times beside the plain version's backward and
    ``scaled_dot_product_attention``'s."""
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    b, hq, s, d = q_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    dout = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    o, lse = fa_kernel.flash_attention(q, k, v, causal=True, window=window,
                                       return_lse=True)
    same_out = torch.equal(o, fa_kernel.flash_attention(
        q, k, v, causal=True, window=window))
    lse_err = float((lse - fa_ref.row_lse(q, k, causal=True, window=window))
                    .abs().max())
    before = fa_kernel.backward_variant_launches()
    got = fa_kernel.flash_attention_backward(q, k, v, o, lse, dout,
                                             causal=True, window=window)
    torch.cuda.synchronize()
    after = fa_kernel.backward_variant_launches()
    variants = {name: after[name] - before[name] for name in after}
    again = fa_kernel.flash_attention_backward(q, k, v, o, lse, dout,
                                               causal=True, window=window)
    bit_identical = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = _kept_grad(lambda *x: fa_ref.attention(*x, causal=True,
                                                  window=window),
                      [x.float() for x in (q, k, v)], dout.float())()
    tol = GRAD_TOLERANCE[dtype_name]
    err, ok = _grad_check(got, want, tol)
    scale = max(float(w.abs().max()) for w in want)
    idx = torch.arange(s, device="cuda")
    if window is None or window >= s:
        def sdpa(*x):
            return F.scaled_dot_product_attention(*x, is_causal=True,
                                                  enable_gqa=True)
        pairs = s * (s + 1) // 2
    else:
        mask = ((idx[None, :] <= idx[:, None])
                & (idx[None, :] > idx[:, None] - window))

        def sdpa(*x):
            return F.scaled_dot_product_attention(*x, attn_mask=mask,
                                                  enable_gqa=True)
        pairs = int(mask.sum())
    # the elements past the tolerance, the kernel's and (as a yardstick,
    # not checked) the library's backward's on the same inputs
    lib_over, lib_err = _past_tolerance(_kept_grad(sdpa, (q, k, v), dout)(),
                                        want, tol)
    over, _ = _past_tolerance(got, want, tol)
    del want, got
    _free()
    # q, o, do read and dq written; k, v read and dk, dv written; the
    # work 2.5x the forward's (2 FLOP per multiply-add of q.k and p.v
    # over the unmasked pairs: the five products q.k, do.v, P^T do,
    # dZ^T q, dZ k)
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
    ops = 2.5 * 4 * d * pairs * b * hq
    big = nbytes > 50e6
    times = _backward_times(
        lambda: fa_kernel.flash_attention_backward(q, k, v, o, lse, dout,
                                                   causal=True,
                                                   window=window),
        _kept_grad(lambda *x: fa_ref.attention(*x, causal=True,
                                               window=window),
                   (q, k, v), dout),
        _kept_grad(sdpa, (q, k, v), dout), big)
    bound = _bound(nbytes, ops, dtype_name)
    # the design's own floor: nine products (S and dP in both kernels,
    # dV's and dK's over bf16 high and low parts)
    floor_ms = 1.8 * ops / _rates()[1][dtype_name] * 1e3
    want_variant = FLASH_BACKWARD_VARIANT[dtype_name]
    right_variant = variants == {
        name: int(name == want_variant) for name in variants}
    rec = {"q_shape": list(q_shape), "kv_heads": hkv, "window": window,
           "dtype": dtype_name, "max_abs_err": err,
           "max_abs_grad": scale, "tolerance": tol,
           "past_tolerance": over, "library_past_tolerance": lib_over,
           "library_max_abs_err": lib_err,
           "lse_max_abs_err": lse_err, "lse_tolerance": LSE_TOLERANCE,
           "forward_with_lse_bit_identical": same_out,
           "variant_launches": variants, "bit_identical": bit_identical,
           "ok": (ok and right_variant and bit_identical and same_out
                  and lse_err <= LSE_TOLERANCE),
           **times, **bound,
           "kernel_tflops": ops / times["kernel_ms"] / 1e9,
           "bound_share": bound["bound_ms"] / times["kernel_ms"],
           "design_floor_ms": floor_ms,
           "design_floor_share": floor_ms / times["kernel_ms"]}
    _free()
    return rec


def phase_flash_backward_kernel(fa_kernel, fa_ref, train_shapes,
                                moe_shapes, hybrid_shapes, dense_shapes):
    """The llama3.2-3b training shape in bf16 (as it runs) and in f32,
    qwen3-moe's training shape and jamba's prefill shape in bf16 (GQA
    groups of 16 and 8 at head dim 128), ``DENSE_KERNEL_SHAPES`` in bf16
    (the five configs' training shapes: groups of 7 and 1 at head dims
    64 and 128), and a ragged windowed case; the plain version's f32
    einsums with TF32 off."""
    import torch
    main = (train_shapes["q"], train_shapes["kv_heads"],
            train_shapes["window"])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = {"main": _flash_backward_case(fa_kernel, fa_ref, *main,
                                              "bfloat16", 0),
                 "main-float32": _flash_backward_case(
                     fa_kernel, fa_ref, *main, "float32", 0),
                 "qwen3-moe": _flash_backward_case(
                     fa_kernel, fa_ref, moe_shapes["q"],
                     moe_shapes["kv_heads"], moe_shapes["window"],
                     "bfloat16", 2),
                 "jamba": _flash_backward_case(
                     fa_kernel, fa_ref, hybrid_shapes["q"],
                     hybrid_shapes["kv_heads"], hybrid_shapes["window"],
                     "bfloat16", 3),
                 **_dense_cases(
                     lambda *a: _flash_backward_case(fa_kernel, fa_ref, *a),
                     dense_shapes, 4)}
        for dtype_name in ("float32", "bfloat16"):
            cases[f"ragged-64-{dtype_name}"] = _flash_backward_case(
                fa_kernel, fa_ref, (2, 4, 200, 64), 2, 64, dtype_name, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for name, case in cases.items():
        emit({"phase": "flash_backward_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention backward disagrees with "
                           f"autograd through its plain version, ran on "
                           f"another design, differs between two calls, "
                           f"or the forward's log-sum-exp is off: {bad}")
    return cases["main"]


def _wkv_backward_case(wkv_kernel, wkv_ref, shape, dtype_name, seed, w_lo):
    """The backward kernel against autograd through ``ref.wkv_chunked``
    (``ref.wkv`` where T is no multiple of 64), with times, the design the
    call ran on and whether two calls agree bit for bit.  ``w_lo`` = 0:
    decays from [0, 0.999] with exact zeros, as ``_wkv_case``."""
    import torch
    dtype = getattr(torch, dtype_name)
    b, h, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(sh, scale=1.0):
        return (torch.randn(sh, generator=gen, device="cuda")
                * scale).to(dtype)

    r, k, v = normal(shape), normal(shape, 0.3), normal(shape)
    w = w_lo + (0.999 - w_lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    if w_lo == 0.0:
        w[:, :, ::5, ::3] = 0.0
    w = w.to(dtype)
    u = normal((h, d), 0.1)
    dout = normal(shape)
    inputs = (r, k, v, w, u)
    before = wkv_kernel.backward_variant_launches()
    got = wkv_kernel.wkv_backward(*inputs, dout)
    torch.cuda.synchronize()
    after = wkv_kernel.backward_variant_launches()
    variants = {name: after[name] - before[name] for name in after}
    again = wkv_kernel.wkv_backward(*inputs, dout)
    bit_identical = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    if t % 64 == 0:
        def plain(*x):
            return wkv_ref.wkv_chunked(*x, chunk=64)
    else:
        plain = wkv_ref.wkv
    want = _kept_grad(plain, [x.float() for x in inputs], dout.float())()
    tol = WKV_GRAD_TOLERANCE[dtype_name]
    err, ok = _grad_check(got, want, tol)
    scale = max(float(x.abs().max()) for x in want)
    del want
    _free()
    # r, k, v, w, do read and dr, dk, dv, dw written, u read and du
    # written; the recurrences' least work, 14 D^2 FLOP a step (one
    # forward pass of the state, the reverse scan with its row sums, dv),
    # at the inputs' rate
    nbytes = (9 * r.numel() + 2 * u.numel()) * r.element_size()
    ops = 14 * d * d * t * b * h
    times = _backward_times(
        lambda: wkv_kernel.wkv_backward(*inputs, dout),
        _kept_grad(plain, inputs, dout), None, nbytes > 50e6)
    bound = _bound(nbytes, ops, dtype_name)
    # the design's own floor.  Chunked: the bound's bytes plus its two
    # (B, H, n, D, D) f32 boundary buffers written and read once, against
    # its tensor-core products (per chunk 1792 D^2 + 6144 D FLOP, the
    # hi/lo splits included).  Scan: its 22 D^2 f32 FLOP a step
    want_variant = _wkv_backward_variant(dtype_name, d)
    n = -(-t // 64)
    hbm, peak = _rates()
    if want_variant == "tensor_cores":
        floor_ms = 1e3 * max(
            (nbytes + 4 * b * h * n * d * d * 4) / hbm,
            (1792 * d * d + 6144 * d) * b * h * n / peak["bfloat16"])
    else:
        floor_ms = 1e3 * 22 * d * d * t * b * h / peak["float32"]
    right_variant = variants == {
        name: int(name == want_variant) for name in variants}
    rec = {"shape": list(shape), "dtype": dtype_name, "w_lo": w_lo,
           "max_abs_err": err, "max_abs_grad": scale, "tolerance": tol,
           "design": want_variant, "variant_launches": variants,
           "bit_identical": bit_identical,
           "ok": ok and right_variant and bit_identical,
           "plain_form": "wkv_chunked" if t % 64 == 0 else "wkv",
           **times, **bound,
           "bound_share": bound["bound_ms"] / times["kernel_ms"],
           "design_floor_ms": floor_ms,
           "design_floor_share": floor_ms / times["kernel_ms"]}
    _free()
    return rec


def phase_wkv_backward_kernel(wkv_kernel, wkv_ref, main_shape):
    """rwkv6-1.6b's training shape in bf16, with mild decays and with
    decays down to 0, and in f32 down to 0; ragged lengths (T = 200, 63
    and 1) and the smaller head dims of the chunked form."""
    cases = {
        "main": _wkv_backward_case(wkv_kernel, wkv_ref, main_shape,
                                   "bfloat16", 0, 0.7),
        "main-strong": _wkv_backward_case(wkv_kernel, wkv_ref, main_shape,
                                          "bfloat16", 0, 0.0),
        "main-strong-float32": _wkv_backward_case(
            wkv_kernel, wkv_ref, main_shape, "float32", 0, 0.0)}
    for dtype_name in ("float32", "bfloat16"):
        cases[f"ragged-strong-{dtype_name}"] = _wkv_backward_case(
            wkv_kernel, wkv_ref, (2, 4, 200, 64), dtype_name, 1, 0.0)
    for name, shape, seed in (("t1", (2, 4, 1, 64), 2),
                              ("t63", (2, 4, 63, 64), 3),
                              ("d16", (2, 4, 200, 16), 4),
                              ("d32", (2, 4, 200, 32), 5)):
        cases[f"{name}-strong-bfloat16"] = _wkv_backward_case(
            wkv_kernel, wkv_ref, shape, "bfloat16", seed, 0.0)
    for name, case in cases.items():
        emit({"phase": "wkv_backward_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"wkv6 backward disagrees with autograd through "
                           f"its plain version, ran on another design or "
                           f"differs between two calls: {bad}")
    return cases["main"]


def _train_batch(cfg, lead, seq, seed=0):
    """Random next-token batch of ``lead`` + (seq,) tokens on the card;
    for an embeddings config, random embeddings and random labels."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.input_mode != "tokens":
        inputs = _model_inputs(cfg, lead, seq, gen)
        return {"inputs": inputs,
                "labels": torch.randint(0, cfg.vocab_size, (*lead, seq),
                                        generator=gen, device="cuda")}
    tokens = torch.randint(0, cfg.vocab_size, (*lead, seq + 1),
                           generator=gen, device="cuda")
    return {"inputs": tokens[..., :-1].contiguous(),
            "labels": tokens[..., 1:].contiguous()}


class _PlainOps:
    """The plain versions in place of the kernels in ``models.layers``
    while it is entered: attention through ``ref.attention``, the RWKV6
    recurrence through ``ref.wkv_chunked``, differentiated by autograd
    on the card."""

    def __enter__(self):
        from types import SimpleNamespace
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.wkv6 import ref as wkv_ref
        from repro_torch.models import layers
        self.layers = layers
        self.saved = (layers.fa, layers.wkv_ops)
        layers.fa = SimpleNamespace(attention=fa_ref.attention)
        layers.wkv_ops = SimpleNamespace(
            wkv=lambda *x: wkv_ref.wkv_chunked(*x, chunk=64),
            wkv_step=wkv_ref.wkv_step)
        return self

    def __exit__(self, *exc):
        self.layers.fa, self.layers.wkv_ops = self.saved


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{prefix}/{i}")]
    return [prefix]


def _grads_vs_plain(launchers, name, batch, seq, kernels):
    """One step's loss and gradients at full width and 2 layers, through
    the kernels and through the plain versions, in bf16 and in float32
    (the same values widened), from the same batch: each leaf's error
    relative to the norm of the float32 plain step's gradient; and the
    float32 loss after one SGD step at ``TRAIN_LR`` through each.

    Lean on memory, for qwen3-moe's 6.2 B params at 2 layers: the plain
    float32 gradients wait on the host, each other run's are compared
    leaf by leaf, and the bf16 params are made again from their seed
    rather than kept beside the float32 ones."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _config(name, 2)
    cfg32 = _config(name, 2, param_dtype="float32")
    lr = TRAIN_LR[name]
    data = _train_batch(cfg, (batch,), seq, seed=1)

    def params():
        return T.init_params(cfg, seed=1, device="cuda")

    def widened():
        p = params()
        return tree_map(lambda x: x.to(torch.float32), p)

    def grads(tree, c):
        g, metrics = T.loss_and_grads(tree, c, data)
        return tree_leaves(g), float(metrics["loss"])

    def stepped_loss(tree, g):
        """The loss after one SGD step of ``tree`` (in place)."""
        with torch.no_grad():
            for p, d in zip(tree_leaves(tree), g):
                p.copy_(T.sgd_leaf(p, d, lr))
            return float(T.loss_fn(tree, cfg32, data)[0])

    def rel(got, want_host):
        return [float((g.float() - w.to(g.device)).norm()
                      / max(float(w.norm()), 1e-30))
                for g, w in zip(got, want_host)]

    names = _leaf_paths(T.init_params(cfg, device="meta"))
    saved = _tf32_off()
    try:
        set_counts(launchers)
        with _PlainOps():
            tree = widened()
            g, plain32_loss = grads(tree, cfg32)
            plain32 = [x.cpu() for x in g]
            plain_step = stepped_loss(tree, g)
            del tree, g
            _free()
        plain_counts = read_counts(launchers)
        tree = widened()
        g, kern32_loss = grads(tree, cfg32)
        f32 = rel(g, plain32)
        kern_step = stepped_loss(tree, g)
        del tree, g
        _free()
        tree = params()
        g, kern_loss = grads(tree, cfg)
        bf16_kern = rel(g, plain32)
        del g
        _free()
        counts = read_counts(launchers)
        with _PlainOps():
            g, plain_loss = grads(tree, cfg)
            bf16_plain = rel(g, plain32)
        del tree, g
        torch.cuda.synchronize()
        after_plain = read_counts(launchers)
    finally:
        _restore(saved)
    del plain32
    _free()
    worst = max(range(len(names)), key=lambda i: bf16_kern[i]
                - 2 * bf16_plain[i])
    finite = all(math.isfinite(x) for x in
                 f32 + bf16_kern + [kern_step, plain_step])
    step_err = abs(kern_step - plain_step)
    ok = (finite and max(f32) <= TRAIN_GRAD_TOL
          and step_err <= STEP_LOSS_TOL * (1 + abs(plain_step))
          and all(a <= 2 * b + 1e-2 for a, b in zip(bf16_kern, bf16_plain))
          and all(counts[k] > 0 for k in kernels)
          and all(n == 0 for n in plain_counts.values())
          and after_plain == counts)
    rec = {"n_layers": cfg.n_layers, "batch": batch,
           "loss": {"kernels": kern_loss, "plain": plain_loss,
                    "kernels_f32": kern32_loss, "plain_f32": plain32_loss},
           "f32_loss_after_one_step": {"kernels": kern_step,
                                       "plain": plain_step, "lr": lr,
                                       "abs_err": step_err,
                                       "tolerance": STEP_LOSS_TOL},
           "f32_grad_rel_err_max": max(f32),
           "f32_worst_leaf": names[max(range(len(names)),
                                       key=f32.__getitem__)],
           "f32_tolerance": TRAIN_GRAD_TOL,
           "bf16_grad_rel_err_median": {
               "kernels": statistics.median(bf16_kern),
               "plain": statistics.median(bf16_plain)},
           "bf16_worst_leaf": {"leaf": names[worst],
                               "kernels": bf16_kern[worst],
                               "plain": bf16_plain[worst]},
           "launches": counts, "ok": ok}
    return rec


def _train_phase(launchers, phase, name, kernels, batch=4, seq=2048,
                 steps=3, n_layers=None):
    """Full-width ``name`` (random bf16 weights from seed 0), at its own
    depth or cut to ``n_layers``, through ``make_sharded_train_step``
    (SGD at ``TRAIN_LR``, params updated in place), ``steps`` steps on one
    fixed batch of ``batch`` x ``seq`` tokens, with every count set to 0
    just before: losses finite, the last below the first; one more step
    under the profiler; then at 2 layers the gradients and the loss after
    one step against the plain versions (``_grads_vs_plain``).
    ``kernels``: (forward, backward) wrapper names, each launched once
    per layer that runs it per step, the forward twice (remat); ``None``
    for a path with no kernel (MLA), where every count stays 0 and the
    plain versions are the path itself, so there is nothing to hold it
    against."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = _config(name, n_layers)
    params = T.init_params(cfg, seed=0, device="cuda")
    data = _train_batch(cfg, (batch,), seq)
    step = make_sharded_train_step(
        cfg, InputShape("train_smoke", seq, batch, "train"),
        lr=TRAIN_LR[name])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(launchers)
    losses, aux, walls = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, metrics = step(params, data)
        losses.append(float(metrics["loss"]))   # synchronizes
        walls.append(time.perf_counter() - t0)
        aux.append(float(metrics["aux"]))
    counts = read_counts(launchers)
    MEASURED_STEPS.append({"config": cfg, "kind": "train", "batch": batch,
                           "seq_len": seq,
                           "wall_s": statistics.median(walls[1:])})
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    prof_wall, by_name = ((0.0, {}) if name in PROFILE_SKIP
                          else _profile(lambda: step(params, data)))
    del params
    _free()
    ok = (all(math.isfinite(x) for x in losses + aux)
          and losses[-1] < losses[0])
    if kernels is None:
        ok = ok and all(n == 0 for n in counts.values())
        needles = ()
        versus = {"ok": True, "skipped": "no kernel on this path"}
    else:
        fwd, bwd = kernels
        layers = _mixer_layers(cfg, KERNEL_MIXER[fwd])
        ok = (ok and counts[fwd] == 2 * layers * steps
              and counts[bwd] == layers * steps)
        needles = {"flash_attention": ("flash_attention", "fa_bwd",
                                       "fa_bwd_prep", "dkdv_wgmma",
                                       "dq_wgmma"),
                   "wkv6": ("wkv6_chunked", "wkv6_bwd")}[fwd]
        versus = _grads_vs_plain(launchers, name, batch, seq, kernels)
    rec = {"config": cfg.name, "dtype": cfg.param_dtype, "params": n_params,
           "n_layers": cfg.n_layers, "full_depth": _full_depth(cfg),
           "batch": batch, "seq_len": seq, "lr": TRAIN_LR[name],
           "remat": cfg.remat,
           "losses": losses, "aux": aux, "step_wall_s": walls,
           "tokens_per_s": batch * seq / statistics.median(walls[1:]),
           "peak_memory_gib": peak, "launches": counts,
           "launches_per_step": {k: n / steps for k, n in counts.items()},
           **_share(by_name, prof_wall, "gemm", "nvjet", "elementwise",
                    "reduce", *needles),
           **_groups(by_name),
           "vs_plain_2_layers": versus, "ok": ok and versus["ok"]}
    emit({"phase": phase, **rec})
    if not rec["ok"]:
        raise RuntimeError(f"{name} training: losses not finite or the "
                           f"last not below the first, launches other "
                           f"than {kernels} expects, or gradients or the "
                           f"stepped loss apart from the plain versions'")
    return counts


def phase_transformer_train(launchers):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b")
    counts = _train_phase(launchers, "transformer_train", "llama3.2-3b",
                          ("flash_attention", "flash_attention_backward"))
    return counts, _attention_shape(cfg, 4, 2048)


def phase_rwkv6_train(launchers):
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-1.6b")
    counts = _train_phase(launchers, "rwkv6_train", "rwkv6-1.6b",
                          ("wkv6", "wkv6_backward"))
    h = cfg.d_model // 64
    return counts, (4, h, 2048, cfg.d_model // h)


def phase_moe_train(launchers):
    """``_train_phase`` on each MoE config at its ``MOE_TRAIN_LAYERS``
    depth: deepseek-v2-lite-16b (MLA, no kernel on its path) and
    qwen3-moe-235b-a22b (flash_attention forward and backward).  Returns
    the launches summed and qwen3-moe's attention shape."""
    total, shape = {}, None
    for name, n_layers in MOE_TRAIN_LAYERS.items():
        cfg = _config(name, n_layers)
        kernels = (("flash_attention", "flash_attention_backward")
                   if _attention_layers(cfg) else None)
        counts = _train_phase(launchers, "moe_train", name, kernels,
                              n_layers=n_layers)
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        if kernels:
            shape = _attention_shape(cfg, 4, 2048)
    return total, shape


# jamba's block trains at B = 1 x 2048: the whole block's bf16 params and
# their gradients take 60.5 GiB of the card's 79.2 before any activation.
# Its timed steps run half the block (its attention layer and 3 Mamba
# layers; the 2-layer checks as before): the 8-layer block's 6-8 s steps
# (NVIDIA H100 80GB HBM3, 700.00 W) put the script past its 900 s once
# the sharded steps ran on 8 ranks
HYBRID_TRAIN_BATCH = 1
HYBRID_TRAIN_LAYERS = 4


def phase_hybrid_train(launchers):
    """``_train_phase`` on jamba's block (``CUTS``) cut to
    ``HYBRID_TRAIN_LAYERS`` (the flash_attention forward and backward at
    a GQA group of 8, the Mamba layers' chunked scan through autograd and
    its checkpoints inside the block's)."""
    return _train_phase(launchers, "hybrid_train", HYBRID,
                        ("flash_attention", "flash_attention_backward"),
                        batch=HYBRID_TRAIN_BATCH, n_layers=HYBRID_TRAIN_LAYERS)


# ---------------------------------------------------------------------------
# The five dense and embeddings configs: olmo-1b, internvl2-1b,
# musicgen-medium at full depth, qwen3-32b and deepseek-coder-33b cut
# ---------------------------------------------------------------------------
# Each at full width with random bf16 weights from seed 0.  olmo-1b (16
# layers, MHA at head dim 128, non-parametric LayerNorm), internvl2-1b (24,
# GQA 14 / 2 at head dim 64, embeddings input) and musicgen-medium (48, MHA
# 24 / 24 at head dim 64, embeddings input) run at full depth.
# qwen3-32b (64 / 8 heads, qk-norm; ~0.49 B params a layer and 0.78 B in
# each of its embedding and head) and deepseek-coder-33b (56 / 8: a GQA
# group of 7; ~0.53 B a layer) run 8 layers for prefill and decode and 4
# for training (``DENSE_TRAIN_LAYERS``), which keeps the phases inside the
# script's time; the depth is a loop over identical blocks
DENSE = ("olmo-1b", "internvl2-1b", "musicgen-medium", "qwen3-32b",
         "deepseek-coder-33b")
CUTS.update({"qwen3-32b": {"n_layers": 8},
             "deepseek-coder-33b": {"n_layers": 8}})
DENSE_TRAIN_LAYERS = {"qwen3-32b": 4, "deepseek-coder-33b": 4}
# Each new attention shape the kernels get at full size: a GQA group of 7
# at head dim 128 and at 64, MHA at 64 and at 128 (qwen3-32b's 64 / 8 is
# jamba's, already held)
DENSE_KERNEL_SHAPES = ("deepseek-coder-33b", "internvl2-1b",
                       "musicgen-medium", "olmo-1b")
# A window the decode ring wraps: olmo-1b at 2 layers in float32, its
# 8192 window set to 256 over 1024 positions (a 2048 cache never wraps at
# the configs' own 8192)
WINDOW_CHECK = {"name": "olmo-1b", "n_layers": 2, "sliding_window": 256,
                "seq": 1024}


def phase_dense_prefill(launchers, batch=4, seq=2048):
    """``make_prefill_step`` on each of ``DENSE`` (with its ``CUTS``),
    B = 4 x 2048: finite logits, one ``flash_attention`` launch a layer
    and no other kernel; wall, tokens/s, peak memory, the busy share and
    the profile's groups.  Returns the launches and each config's
    attention shape."""
    launches, shapes = 0, {}
    for name in DENSE:
        cfg = _config(name)
        rec, counts, ok = _prefill_run(launchers, cfg, batch, seq,
                                       "flash_attention")
        want = _attention_layers(cfg)
        ok = ok and counts["flash_attention"] == want == cfg.n_layers and all(
            n == 0 for k, n in counts.items() if k != "flash_attention")
        emit({"phase": "dense_prefill", "ok": ok, "n_layers": cfg.n_layers,
              "full_depth": _full_depth(cfg), "input_mode": cfg.input_mode,
              "heads": [cfg.n_heads, cfg.n_kv_heads],
              "head_dim": cfg.head_dim, **rec})
        if not ok:
            raise RuntimeError(f"{name} prefill: non-finite logits, or "
                               f"flash_attention launches != {want}")
        launches += counts["flash_attention"]
        shapes[name] = _attention_shape(cfg, batch, seq)
    return launches, shapes


def _embeddings_decode(launchers, name, phase, batch=8, steps=32,
                       prompt=16, cache_len=2048):
    """``name`` (an embeddings config: no token ids to serve, so not
    behind ``TransformerBackend``) through ``make_serve_step`` over a
    ``cache_len`` cache: ``prompt`` random embeddings one step each, 3
    warm-up steps, then ``steps`` timed steps on zero embeddings, as
    ``examples/serve_demo.py`` generates; per-token latency."""
    import torch
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = _config(name)
    params = T.init_params(cfg, seed=0, device="cuda")
    step = make_serve_step(cfg)
    cache = T.init_cache(cfg, batch, cache_len, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _model_inputs(cfg, (batch,), prompt, gen)
    zeros = torch.zeros((batch, 1, cfg.d_model), device="cuda")
    pos = 0
    for pos in range(prompt):
        logits, cache = step(params, cache, x[:, pos:pos + 1], pos)
    for pos in range(prompt, prompt + 3):
        logits, cache = step(params, cache, zeros, pos)
    torch.cuda.synchronize()
    set_counts(launchers)
    lat = []
    for pos in range(prompt + 3, prompt + 3 + steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, zeros, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    counts = read_counts(launchers)
    finite = bool(torch.isfinite(logits).all())
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache))
    pos += 1

    def one():
        step(params, cache, zeros, pos)
    wall_ms, by_name = _profile(one)
    ok = finite and all(n == 0 for n in counts.values())
    emit({"phase": phase, "ok": ok, "config": cfg.name,
          "n_layers": cfg.n_layers, "batch": batch, "seq_len": cache_len,
          "prompt": prompt, "steps": steps, "input": "embeddings, zeros "
          "after the prompt",
          "per_token_ms_median": statistics.median(lat) * 1e3,
          "per_token_ms_mean": statistics.mean(lat) * 1e3,
          "per_token_ms_max": max(lat) * 1e3,
          "tokens_per_s": batch / statistics.median(lat),
          "cache_gib": cache_bytes / 2**30, "logits_finite": finite,
          "logits_shape": list(logits.shape), "launches": counts,
          "profiled_step": _share(by_name, wall_ms)})
    del params, cache, logits
    _free()
    if not ok:
        raise RuntimeError(f"{name} decode: non-finite logits or a kernel "
                           f"launched")


def phase_dense_decode(launchers):
    """Each of ``DENSE`` decoding 8 requests a step over a 2048 cache:
    the token configs behind ``TransformerBackend``, the embeddings ones
    through ``serve_step``."""
    for name in DENSE:
        if _config(name).input_mode == "tokens":
            phase_transformer_decode(launchers, name, "dense_decode")
        else:
            _embeddings_decode(launchers, name, "dense_decode")


def phase_dense_decode_vs_prefill(launchers):
    """Each of ``DENSE`` in float32 at 2 layers over 256 positions
    (embeddings configs fed embeddings at every position), then
    ``WINDOW_CHECK``: the windowed prefill through the kernel against
    1024 decode steps over a 256-position ring."""
    for name in DENSE:
        _decode_vs_prefill(launchers, name, "flash_attention", 256,
                           n_layers=2, phase="dense_decode_vs_prefill")
    w = WINDOW_CHECK
    _decode_vs_prefill(launchers, w["name"], "flash_attention", w["seq"],
                       n_layers=w["n_layers"],
                       phase="window_decode_vs_prefill",
                       sliding_window=w["sliding_window"])


def phase_dense_train(launchers):
    """``_train_phase`` on each of ``DENSE`` (full depth, or
    ``DENSE_TRAIN_LAYERS``): 3 SGD steps of 4 x 2048 with remat, two
    ``flash_attention`` launches and one backward a layer a step, and at
    2 layers the gradients and stepped loss against the plain versions.
    Returns the launches summed."""
    total = {}
    for name in DENSE:
        counts = _train_phase(launchers, "dense_train", name,
                              ("flash_attention", "flash_attention_backward"),
                              n_layers=DENSE_TRAIN_LAYERS.get(name))
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
    return total


def _row_slices(leaf, most=1 << 26):
    """Slices of ``leaf``'s first axis of at most ``most`` elements each
    (the whole leaf for a 0-d one): the aggregate's check runs on them,
    so that its temporaries stay small beside jamba's f32 stacks."""
    if leaf.ndim == 0:
        return [...]
    rows = max(1, most // max(1, leaf[0].numel()))
    return [slice(i, i + rows) for i in range(0, leaf.shape[0], rows)]


def phase_fl_train_step(launchers, agg_ref, name="llama3.2-3b",
                        n_layers=None, phase="fl_train_step", n_replicas=2,
                        per_replica=2, h_local=2, seq=2048, rounds=2):
    """``make_fl_train_step`` on full-width ``name`` (at its own depth or
    cut to ``n_layers``): ``n_replicas``
    replicas of one initial model, ``per_replica`` x ``seq`` tokens each,
    ``h_local`` local steps, ``rounds`` rounds.  A tap on the aggregation
    op holds each leaf of the aggregate the kernel returns against
    ``ref.weighted_aggregate`` of the same stacked replicas (float32,
    ``TOLERANCE``) and keeps its first elements; afterwards every replica
    slot must equal the aggregate."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.fl import aggregation
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _config(name, n_layers)
    base = T.init_params(cfg, seed=0, device="cuda")
    rep = tree_map(lambda x: torch.stack([x] * n_replicas), base)
    del base
    _free()
    data = _train_batch(cfg, (n_replicas, per_replica), seq, seed=2)
    step = make_fl_train_step(
        cfg, n_replicas,
        InputShape("fl_smoke", seq, n_replicas * per_replica, "train"),
        lr=TRAIN_LR[name], h_local=h_local)
    real = aggregation.agg_ops
    checks = {"err": 0.0, "ok": True, "calls": 0, "samples": []}

    class Tap:
        weighted_aggregate = staticmethod(real.weighted_aggregate)

        @staticmethod
        def aggregate(buckets, weights):
            outs = real.aggregate(buckets, weights)
            checks["calls"] += 1
            checks["samples"] = []
            tol = TOLERANCE[str(outs[0].dtype).split(".")[-1]]
            for stack, out in zip(buckets[0], outs):
                for sl in _row_slices(out):
                    want = agg_ref.weighted_aggregate(stack[:, sl], weights)
                    d = (out[sl].float() - want.float()).abs()
                    checks["err"] = max(checks["err"], float(d.max()))
                    checks["ok"] &= bool(
                        (d <= tol * (1 + want.float().abs())).all())
                checks["samples"].append(out.flatten()[:4096].clone())
            return outs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aggregation.agg_ops = Tap()
    set_counts(launchers)
    walls, losses, aux = [], [], []
    try:
        for _ in range(rounds):
            t0 = time.perf_counter()
            rep, metrics = step(rep, data)
            losses.append(float(metrics["loss"]))   # synchronizes
            walls.append(time.perf_counter() - t0)
            aux.append(float(metrics["aux"]))
    finally:
        aggregation.agg_ops = real
    counts = read_counts(launchers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(rep)
    slots_equal = all(torch.equal(x[0], x[r]) for x in leaves
                      for r in range(1, n_replicas))
    slots_are_aggregate = all(
        torch.equal(x[0].flatten()[:4096], s.to(x.dtype))
        for x, s in zip(leaves, checks["samples"]))
    steps = rounds * n_replicas * h_local
    attention = _attention_layers(cfg)
    ok = (counts["fedavg_agg"] == rounds and checks["calls"] == rounds
          and checks["ok"] and slots_equal and slots_are_aggregate
          and all(math.isfinite(x) for x in losses + aux)
          and counts["flash_attention"] == 2 * attention * steps
          and counts["flash_attention_backward"] == attention * steps)
    emit({"phase": phase, "ok": ok, "config": cfg.name,
          "n_layers": cfg.n_layers,
          "n_replicas": n_replicas, "tokens_per_replica": per_replica * seq,
          "h_local": h_local, "agg_dtype": "float32", "rounds": rounds,
          "round_wall_s": walls, "losses": losses, "aux": aux,
          "tokens_per_s": n_replicas * per_replica * seq * h_local
          / statistics.median(walls),
          "peak_memory_gib": peak, "aggregate_max_abs_err": checks["err"],
          "aggregate_tolerance": TOLERANCE["float32"],
          "slots_equal": slots_equal,
          "slots_are_aggregate": slots_are_aggregate, "launches": counts})
    del rep, leaves
    checks.clear()
    _free()
    if not ok:
        raise RuntimeError(f"{phase}: not one fedavg_agg launch a round, "
                           f"replica slots apart from the aggregate, the "
                           f"aggregate apart from its plain version, or "
                           f"attention launches off")
    return counts


# ---------------------------------------------------------------------------
# The mesh paths: NCCL at world 1, and 2 gloo ranks sharing cuda:0
# ---------------------------------------------------------------------------
MESH_ROUNDS = 4
# the sharded cohort against one process under "off", each round from the
# same params: the float32 aggregate summed in another order (each
# shard's partial sum, then the all-reduce), the rest the same code
MESH_PARAM_TOL = 1e-5
MESH_LOSS_TOL = 1e-5
# the 2-rank FL step on one card: llama3.2-3b at full width cut to this
# depth, so that two processes (each with its params, gradients, float32
# stack and all-reduce buffer) fit on the card beside each other
MESH_FL_LAYERS = 2


class _Exact:
    """TF32 off for matmul and cuDNN (a TF32 convolution is ~1e-3 off,
    and two algorithms for two batch sizes are ~1e-3 apart), cuDNN
    deterministic and not benchmarking, deterministic algorithms on;
    restored on exit."""

    def __enter__(self):
        import torch
        self.saved = (_tf32_off(), torch.backends.cudnn.benchmark)
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(False)
        _restore(self.saved[0])
        torch.backends.cudnn.benchmark = self.saved[1]
        return False


class _NcclWorldOne:
    """A process group of one rank over NCCL on ``cuda:0`` (a ``file://``
    store under ``tmp``), destroyed on exit."""

    def __init__(self, tmp, name):
        self.store = os.path.join(tmp, f"{name}_nccl")

    def __enter__(self):
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{self.store}",
                                rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False


def _leaf_arrays(tree):
    from repro_torch.tree import tree_leaves
    return [x.detach().float().cpu().numpy() for x in tree_leaves(tree)]


def _from_arrays(arrays, like):
    """``like``'s tree with its leaves from ``arrays``, on the card."""
    import torch
    from repro_torch.tree import tree_map
    it = iter(arrays)
    return tree_map(lambda x: torch.from_numpy(next(it)).to(
        device="cuda", dtype=x.dtype), like)


def _paper_trainer(sharding, params, install=None):
    """``RegionTrainer`` at the paper setup with the Walker-Star windows
    (``FLConfig(use_constellation=True)``, MNIST CNN, batched) under
    ``cohort_sharding=sharding``, traced in memory (a group's rank 0
    only), ``MESH_ROUNDS`` rounds from ``params``;
    ``install[r - 1]`` (leaf arrays), where given, replaces the params
    before round ``r``.  Returns (trainer, each round's params as leaf
    arrays, each round's wall to a synchronize)."""
    import torch
    from repro_torch.fl import FLConfig
    from repro_torch.fl.rounds import RegionTrainer
    from repro_torch.obs import ObsConfig
    cfg = FLConfig(n_rounds=MESH_ROUNDS, use_constellation=True,
                   execution="batched", cohort_sharding=sharding,
                   obs=ObsConfig(path=None))
    trainer = RegionTrainer(cfg, params=params)
    out, walls = [], []
    for r in range(MESH_ROUNDS):
        if install is not None and r:
            trainer.params = _from_arrays(install[r - 1], trainer.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        out.append(_leaf_arrays(trainer.params))
    return trainer, out, walls


def _mesh_cohort_rank(rank, world, init, install):
    """A rank of ``phase_mesh_cohort``: the paper setup under
    ``cohort_sharding="mesh"``, each round from ``install``'s params, and
    this rank's block of each bucket recorded (clients a bucket)."""
    import torch
    from repro_torch.fl import cohort_engine
    from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
    from repro_torch.models.cnn import build_model
    like, _ = build_model("mnist", 0, torch.device("cpu"))
    splits = []
    real = cohort_engine.CohortEngine._execute_sharded

    def recorded(self, params, cohort, lr):
        splits.append([cb.xs.shape[0] // self.shards
                       for cb in cohort.buckets])
        return real(self, params, cohort, lr)

    agg_kernel.weighted_aggregate.launches = 0
    cohort_engine.CohortEngine._execute_sharded = recorded
    try:
        with _Exact():
            trainer, params, walls = _paper_trainer(
                "mesh", _from_arrays(init, like), install=install)
    finally:
        cohort_engine.CohortEngine._execute_sharded = real
    st, res = trainer.cohort_engine.stats, trainer.result
    return {"shards": trainer.cohort_engine.shards, "params": params,
            "round_wall_s": walls, "losses": res.losses,
            "accuracies": res.accuracies, "cases": res.cases,
            "splits": splits, "writes_trace": trainer.tracer.enabled,
            "last_shard_imbalance": st.last_shard_imbalance,
            "max_shard_imbalance": st.max_shard_imbalance,
            "shard_pad_clients": st.shard_pad_clients,
            "sharded_dispatches": st.sharded_dispatches,
            "fedavg_agg_launches": agg_kernel.weighted_aggregate.launches,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def _max_err(rounds_a, rounds_b):
    return max(float(abs(a - b).max()) for ra, rb in zip(rounds_a, rounds_b)
               for a, b in zip(ra, rb))


def phase_mesh_cohort(launchers, tmp):
    """The client-sharded cohort engine on the card.  One process runs the
    paper setup with the Walker-Star windows for ``MESH_ROUNDS`` rounds
    under ``cohort_sharding="off"``, then under ``"mesh"`` in an NCCL
    group of one rank, which must take the single-device path and give
    the same params bit for bit (every run of the phase under
    ``_Exact``: TF32 off, deterministic algorithms).  Then 2 ranks
    spawned on ``cuda:0`` over ``gloo`` run it under ``"mesh"`` (2
    shards), each round from the "off" run's params before it: params
    within ``MESH_PARAM_TOL`` of that run's, losses within
    ``MESH_LOSS_TOL``, accuracies within 4/eval_size, plan cases equal,
    the two ranks' params equal, one ``fedavg_agg`` launch a round on each
    rank, and only rank 0 tracing.  The steady round wall of each run
    (median of rounds 1..), the shard imbalance, and each rank's block of
    the buckets (the sharded kernel shape, for ``phase_mesh_collectives``).
    Returns the launches of all three runs and rank 0's round-0 blocks."""
    import numpy as np
    import torch
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models.cnn import build_model
    p0, _ = build_model("mnist", 0, torch.device("cpu"))
    with _Exact():
        set_counts(launchers)
        off, off_params, off_walls = _paper_trainer("off", p0)
        off_launches = read_counts(launchers)["fedavg_agg"]
        with _NcclWorldOne(tmp, "mesh_cohort"):
            set_counts(launchers)
            one, one_params, one_walls = _paper_trainer("mesh", p0)
            one_launches = read_counts(launchers)["fedavg_agg"]
    want = off.result
    one_engine = one.cohort_engine
    bit_identical = _max_err(off_params, one_params) == 0.0
    del off, one
    _free()
    ranks = run_ranks(_mesh_cohort_rank, 2,
                      os.path.join(tmp, "mesh_cohort_gloo"),
                      (_leaf_arrays(p0), off_params), backend="gloo",
                      device="cuda", timeout=600)
    tol_acc = 4 / want.config.eval_size
    param_err = [_max_err(r["params"], off_params) for r in ranks]
    loss_err = [max(abs(a - c) for a, c in zip(r["losses"], want.losses))
                for r in ranks]
    acc_err = [max(abs(a - c) for a, c in zip(r["accuracies"],
                                              want.accuracies))
               for r in ranks]
    ranks_equal = _max_err(ranks[0]["params"], ranks[1]["params"]) == 0.0
    launches = off_launches + one_launches + sum(
        r["fedavg_agg_launches"] for r in ranks)
    ok = (bit_identical and one_engine.shards == 1
          and one_engine.mesh is not None
          and off_launches == one_launches == MESH_ROUNDS
          and all(r["shards"] == 2 for r in ranks)
          and all(r["fedavg_agg_launches"] == MESH_ROUNDS for r in ranks)
          and all(r["cases"] == want.cases for r in ranks)
          and max(param_err) <= MESH_PARAM_TOL
          and max(loss_err) <= MESH_LOSS_TOL and max(acc_err) <= tol_acc
          and ranks_equal
          and [r["writes_trace"] for r in ranks] == [True, False])
    steady = statistics.median
    emit({"phase": "mesh_cohort", "ok": ok, "card": nvidia_smi(),
          "config": "FLConfig(use_constellation=True, execution='batched')",
          "rounds": MESH_ROUNDS, "tf32": False, "deterministic": True,
          "off": {"round_wall_s": off_walls,
                  "steady_round_wall_s": steady(off_walls[1:]),
                  "fedavg_agg_launches": off_launches,
                  "accuracies": want.accuracies, "losses": want.losses},
          "nccl_world1_mesh": {
              "shards": one_engine.shards, "round_wall_s": one_walls,
              "steady_round_wall_s": steady(one_walls[1:]),
              "fedavg_agg_launches": one_launches,
              "bit_identical_to_off": bit_identical},
          "gloo_2_ranks_on_cuda0": [{
              "shards": r["shards"], "round_wall_s": r["round_wall_s"],
              "steady_round_wall_s": steady(r["round_wall_s"][1:]),
              "blocks_per_round": r["splits"],
              "last_shard_imbalance": r["last_shard_imbalance"],
              "max_shard_imbalance": r["max_shard_imbalance"],
              "shard_pad_clients": r["shard_pad_clients"],
              "fedavg_agg_launches": r["fedavg_agg_launches"],
              "peak_memory_gib": r["peak_memory_gib"],
              "writes_trace": r["writes_trace"],
              "max_param_err": e, "max_loss_err": le,
              "max_accuracy_err": ae}
              for r, e, le, ae in zip(ranks, param_err, loss_err, acc_err)],
          "param_tolerance": MESH_PARAM_TOL,
          "loss_tolerance": MESH_LOSS_TOL, "accuracy_tolerance": tol_acc,
          "ranks_equal": ranks_equal})
    if not ok:
        raise RuntimeError(f"mesh_cohort: the 1-rank mesh is not the "
                           f"single-device path bit for bit "
                           f"({bit_identical}), or the 2-rank sharded "
                           f"rounds disagree with one process (params "
                           f"{param_err}, losses {loss_err}, accuracies "
                           f"{acc_err})")
    return launches, ranks[0]["splits"][0]


def phase_mesh_collectives(launchers, agg_kernel, agg_ref, shard_split,
                           tmp):
    """The mesh aggregates on the card in an NCCL group of one rank, at
    the MNIST round's leaves: ``hierarchical_weighted_psum`` over (data,
    pod) of a (1, 1) mesh and ``make_replica_agg_step`` against ``lam x
    params`` (the all-reduce of one rank is the identity);
    ``shard_weighted_aggregate`` over the round's two buckets (one
    ``fedavg_agg`` launch on CUDA tensors) against ``ref.aggregate``, each
    within ``TOLERANCE``; the all-reduce of the round's flat buffer, timed;
    and the kernel at one shard's blocks of the round (``shard_split``,
    from ``phase_mesh_cohort``; weights summing to 1/2) against its plain
    version, timed from a replayed CUDA graph beside its bound."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.fl import aggregation as agg
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.launch.train import make_replica_agg_step
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves, tree_map
    params, _ = build_model("mnist", 0, torch.device("cuda"))
    leaves = tree_leaves(params)
    leaf_shapes = [tuple(t.shape) for t in leaves]
    tol = TOLERANCE["float32"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    split = [2 * c for c in shard_split]
    parts = [tree_map(lambda p: torch.randn((c,) + tuple(p.shape),
                                            generator=gen, device="cuda"),
                      params) for c in split]
    w = torch.rand(sum(split), generator=gen, device="cuda") + 0.1
    w = w / w.sum()

    def err(got, want):
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(tree_leaves(got), want))

    with _NcclWorldOne(tmp, "mesh_collectives"):
        data = make_cohort_mesh(device="cuda")
        grid = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("pod", "data"))
        lam = 0.375
        scaled = [lam * x for x in leaves]
        psum_err = err(agg.hierarchical_weighted_psum(
            params, lam, ("data", "pod"), grid), scaled)
        step_err = err(make_replica_agg_step(grid, ("data", "pod"))(
            params, torch.tensor(lam, device="cuda")), scaled)
        set_counts(launchers)
        shard = agg.shard_weighted_aggregate_multi(parts, w, ("data",),
                                                   data)
        torch.cuda.synchronize()
        launches = read_counts(launchers)["fedavg_agg"]
        shard_err = err(shard, agg_ref.aggregate(
            [tree_leaves(p) for p in parts], w))
        flat, _ = agg._flat_buffer(leaf_shapes, torch.device("cuda"))
        group = data.get_group("data")
        allreduce_ms = _event_ms(
            lambda: [dist.all_reduce(flat, group=group) for _ in range(20)],
            5) / 20
    case = _round_case(agg_kernel, agg_ref, leaf_shapes, shard_split,
                       "float32", 12, mass=0.5)
    emit({"phase": "kernel", "kernel": "fedavg_agg",
          "model": "mnist round aggregate, one shard of 2 (its blocks of "
                   "both buckets, weights summing to 1/2, one launch)",
          **case})
    ok = (psum_err <= tol and step_err <= tol and shard_err <= tol
          and launches == 1 and case["ok"])
    emit({"phase": "mesh_collectives", "ok": ok, "card": nvidia_smi(),
          "backend": "nccl", "world": 1, "leaves": len(leaves),
          "params": sum(x.numel() for x in leaves),
          "flat_buffer_bytes": flat.numel() * 4,
          "psum_max_abs_err": psum_err,
          "replica_agg_step_max_abs_err": step_err,
          "shard_aggregate_max_abs_err": shard_err, "tolerance": tol,
          "round_split": split, "fedavg_agg_launches": launches,
          "allreduce_world1_ms": allreduce_ms,
          "sharded_kernel": {k: case[k] for k in (
              "split", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by", "max_abs_err")}})
    if not ok:
        raise RuntimeError("mesh_collectives: a mesh aggregate disagrees "
                           "with its plain version, or fedavg_agg did not "
                           "launch once")
    return launches


def _mesh_fl_rank(rank, world, n_layers, rounds):
    """A rank of ``phase_mesh_fl_train_step``: one llama3.2-3b replica
    (full width, ``n_layers`` deep, bf16, seed 0) on a ``pod`` mesh of
    ``world`` ranks, its slice of the batch, ``rounds`` rounds of 2 local
    steps; walls, peak memory, launches and each leaf's first elements
    and float64 sum."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    name = "llama3.2-3b"
    cfg = _config(name, n_layers)
    pods = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    rep = tree_map(lambda x: x[None].clone(),
                   T.init_params(cfg, seed=0, device="cuda"))
    data = {k: v[rank:rank + 1].contiguous() for k, v in
            _train_batch(cfg, (world, 2), 2048, seed=2).items()}
    step = make_fl_train_step(cfg, world, InputShape(
        "fl_smoke", 2048, 2 * world, "train"), lr=TRAIN_LR[name],
        h_local=2, mesh=pods)
    agg_kernel.weighted_aggregate.launches = 0
    fa_kernel.flash_attention.launches = 0
    fa_kernel.flash_attention_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep, metrics = step(rep, data)
        losses.append(float(metrics["loss"]))   # synchronizes
        walls.append(time.perf_counter() - t0)
    leaves = tree_leaves(rep)
    return {"round_wall_s": walls, "losses": losses,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "fedavg_agg_launches": agg_kernel.weighted_aggregate.launches,
            "flash_attention_launches": fa_kernel.flash_attention.launches,
            "flash_attention_backward_launches":
                fa_kernel.flash_attention_backward.launches,
            "samples": [x.flatten()[:4096].float().cpu().numpy()
                        for x in leaves],
            "sums": [float(x.double().sum()) for x in leaves]}


def phase_mesh_fl_train_step(launchers, tmp, rounds=2):
    """``make_fl_train_step(mesh=...)`` on llama3.2-3b at full width.
    First in an NCCL group of one rank, a ``pod`` mesh of 1 holding both
    replicas, at full depth: ``rounds`` rounds of 2 local steps on 2 x
    2048 tokens a replica, one ``fedavg_agg`` launch a round, both slots
    equal, finite losses, the round wall and peak memory; and at 2 layers
    in float32 (TF32 off) one round against today's one-device step from
    the same params and batch, every param within 1e-5 x (1 + |p|).  Then
    2 ranks spawned on ``cuda:0`` over ``gloo``, one replica each, cut to
    ``MESH_FL_LAYERS`` layers: after each round the replicas equal across
    the ranks (each leaf's first elements and its sum), one launch a
    round on each rank; each rank's round wall and peak memory."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    name = "llama3.2-3b"
    shape = InputShape("fl_smoke", 2048, 4, "train")
    out = {}
    with _NcclWorldOne(tmp, "mesh_fl"):
        pods = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        cfg = _config(name)
        rep = tree_map(lambda x: torch.stack([x] * 2),
                       T.init_params(cfg, seed=0, device="cuda"))
        _free()
        data = _train_batch(cfg, (2, 2), 2048, seed=2)
        step = make_fl_train_step(cfg, 2, shape, lr=TRAIN_LR[name],
                                  h_local=2, mesh=pods)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        set_counts(launchers)
        walls, losses = [], []
        for _ in range(rounds):
            t0 = time.perf_counter()
            rep, metrics = step(rep, data)
            losses.append(float(metrics["loss"]))   # synchronizes
            walls.append(time.perf_counter() - t0)
        counts = read_counts(launchers)
        peak = torch.cuda.max_memory_allocated() / 2**30
        slots_equal = all(torch.equal(x[0], x[1]) for x in tree_leaves(rep))
        attention = _attention_layers(cfg)
        steps = rounds * 2 * 2
        full_ok = (counts["fedavg_agg"] == rounds and slots_equal
                   and all(math.isfinite(v) for v in losses)
                   and counts["flash_attention"] == 2 * attention * steps)
        out["nccl_world1_full_depth"] = {
            "n_layers": cfg.n_layers, "replicas": 2, "round_wall_s": walls,
            "losses": losses, "peak_memory_gib": peak,
            "slots_equal": slots_equal, "launches": counts, "ok": full_ok}
        del rep, data, step
        _free()
        # 2 layers in float32: the mesh step against today's
        saved = _tf32_off()
        try:
            cfg2 = _config(name, 2, param_dtype="float32")
            base = T.init_params(cfg2, seed=1, device="cuda")
            reps = [tree_map(lambda x: torch.stack([x] * 2), base)
                    for _ in range(2)]
            del base
            data = _train_batch(cfg2, (2, 2), 2048, seed=3)
            set_counts(launchers)
            got, _ = make_fl_train_step(cfg2, 2, shape, lr=TRAIN_LR[name],
                                        h_local=2, mesh=pods)(reps[0], data)
            want, _ = make_fl_train_step(cfg2, 2, shape, lr=TRAIN_LR[name],
                                         h_local=2)(reps[1], data)
            f32_launches = read_counts(launchers)["fedavg_agg"]
            rel = max(float(((a - b).abs() / (1 + b.abs())).max())
                      for a, b in zip(tree_leaves(got), tree_leaves(want)))
        finally:
            _restore(saved)
        del reps, got, want, data
        _free()
        out["f32_2_layers_vs_one_device"] = {
            "max_rel_err": rel, "tolerance": 1e-5,
            "fedavg_agg_launches": f32_launches,
            "ok": rel <= 1e-5 and f32_launches == 2}
    ranks = run_ranks(_mesh_fl_rank, 2, os.path.join(tmp, "mesh_fl_gloo"),
                      (MESH_FL_LAYERS, rounds), backend="gloo",
                      device="cuda", timeout=900)
    equal = (all(np.array_equal(a, b) for a, b in
                 zip(ranks[0]["samples"], ranks[1]["samples"]))
             and ranks[0]["sums"] == ranks[1]["sums"])
    gloo_ok = (equal and all(r["fedavg_agg_launches"] == rounds
                             for r in ranks)
               and all(math.isfinite(v) for r in ranks for v in r["losses"]))
    out["gloo_2_ranks_on_cuda0"] = {
        "n_layers": MESH_FL_LAYERS, "replicas_per_rank": 1,
        "ranks": [{k: r[k] for k in ("round_wall_s", "losses",
                                     "peak_memory_gib",
                                     "fedavg_agg_launches",
                                     "flash_attention_launches",
                                     "flash_attention_backward_launches")}
                  for r in ranks],
        "replicas_equal_across_ranks": equal, "ok": gloo_ok}
    ok = all(v["ok"] for v in out.values())
    emit({"phase": "mesh_fl_train_step", "ok": ok, "card": nvidia_smi(),
          "config": name, "h_local": 2, "tokens_per_replica": 2 * 2048,
          **out})
    if not ok:
        raise RuntimeError("mesh_fl_train_step: a replica apart, a launch "
                           "count off, or the mesh step apart from the "
                           "one-device step")
    counts = dict(counts)
    counts["fedavg_agg"] += f32_launches + sum(r["fedavg_agg_launches"]
                                               for r in ranks)
    for key in ("flash_attention", "flash_attention_backward"):
        counts[key] += sum(r[f"{key}_launches"] for r in ranks)
    return counts


def phase_roofline():
    """Every prefill and train step whose wall a phase measured
    (``MEASURED_STEPS``), counted by ``repro_torch.launch.dryrun.run_one``
    on the ``meta`` device at the same config, depth and shape: FLOPs and
    bytes as dispatched (the kernels as their plain versions' work), the
    bound (the larger of the compute and memory terms), the measured wall,
    ``bound / wall`` and ``model_flops / (wall x peak)``, and the host
    seconds of the count.  A share above ``ROOFLINE_SHARE_LIMIT`` fails:
    the count or the wall would be wrong."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    smi = nvidia_smi()
    rows, skipped = [], []
    for m in MEASURED_STEPS:
        cfg = m["config"]
        if (cfg.name, m["kind"]) in ROOFLINE_SKIP:
            skipped.append({"config": cfg.name, "kind": m["kind"],
                            "wall_s": m["wall_s"]})
            continue
        rec = dryrun.run_one(cfg, InputShape(f"{m['kind']}_smoke",
                                             m["seq_len"], m["batch"],
                                             m["kind"]))
        roof = rec["roofline"]
        wall = m["wall_s"]
        row = {"config": cfg.name, "kind": m["kind"], "n_layers":
               cfg.n_layers, "n_experts": cfg.n_experts,
               "batch": m["batch"], "seq_len": m["seq_len"],
               "dtype": cfg.param_dtype, "flops": rec["flops_per_dev"],
               "library_flops": rec["library_cost_flops_per_dev"],
               "bytes": rec["bytes_per_dev"],
               "t_compute_s": roof["t_compute_s"],
               "t_memory_s": roof["t_memory_s"], "bound_s": roof["bound_s"],
               "dominant": roof["dominant"], "wall_s": wall,
               "bound_over_wall": roof["bound_s"] / wall,
               "model_flops": roof["model_flops"],
               "model_flops_share": roof["model_flops"]
               / (wall * roof["peak_flops"]),
               "count_host_s": rec["count_s"]}
        row["ok"] = (rec["status"] == "ok"
                     and row["bound_over_wall"] <= ROOFLINE_SHARE_LIMIT
                     and row["model_flops_share"] <= ROOFLINE_SHARE_LIMIT)
        emit({"phase": "roofline_step", "card": smi, **row})
        rows.append(row)
    ok = (len(rows) + len(skipped) == len(MEASURED_STEPS) > 0
          and all(r["ok"] for r in rows))
    emit({"phase": "roofline", "ok": ok, "card": smi, "steps": len(rows),
          "not_counted": skipped, "limit": ROOFLINE_SHARE_LIMIT,
          "count_host_s": sum(r["count_host_s"] for r in rows)})
    if not ok:
        raise RuntimeError(f"roofline: a step's bound / wall or model "
                           f"FLOPs share is above {ROOFLINE_SHARE_LIMIT}")


# ---------------------------------------------------------------------------
# Tensor and FSDP parallelism on DTensor ---------------------------------------
# ---------------------------------------------------------------------------
def _rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|) over two tensors (in float32, on
    ``got``'s device)."""
    got, want = got.float(), want.to(got.device).float()
    return float(((got - want).abs() / (1 + want.abs())).max())


def _tree_rel_err(got, want) -> float:
    from repro_torch.sharding.activations import to_global
    from repro_torch.tree import tree_leaves
    return max(_rel_err(to_global(a), b)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _synced(fn, *args):
    """``fn(*args)`` and its host wall, the card synchronized on both
    sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _captured_kernels():
    """Wrap the layers' attention and wkv dispatchers to keep the first
    call's inputs (on a mesh: the local shards a rank hands the kernel);
    returns (records, restore)."""
    from types import SimpleNamespace
    from repro_torch.models import layers
    seen = {}
    saved = (layers.fa, layers.wkv_ops)

    def keep(name, fn):
        def call(*args, **kw):
            if name not in seen:
                seen[name] = ([a.detach().clone() for a in args], kw)
            return fn(*args, **kw)
        return call

    layers.fa = SimpleNamespace(attention=keep("flash_attention",
                                               saved[0].attention))
    layers.wkv_ops = SimpleNamespace(wkv=keep("wkv6", saved[1].wkv),
                                     wkv_step=saved[1].wkv_step)

    def restore():
        layers.fa, layers.wkv_ops = saved
    return seen, restore


def _kernel_vs_plain(kernel, plain, args, kw, tols):
    """``kernel`` on ``args`` (their own type) against autograd through
    ``plain`` in float32 on the same values, forward and backward (the
    output's gradient too is made in the inputs' type and widened for
    the plain version): the max abs errors and the elements beyond
    ``tols`` (forward, backward; x (1 + |want|))."""
    import torch
    xs = [a.clone().requires_grad_() for a in args]
    ys = [a.float().clone().requires_grad_() for a in args]
    got, want = kernel(*xs, **kw), plain(*ys, **kw)
    gen = torch.Generator(device="cuda").manual_seed(3)
    dout = torch.randn(got.shape, generator=gen, device="cuda").to(got.dtype)
    got.backward(dout)
    want.backward(dout.float())
    fwd_past, fwd = _past_tolerance([got.detach()], [want.detach()],
                                    tols[0])
    bwd_past, bwd = _past_tolerance([x.grad for x in xs],
                                    [y.grad for y in ys], tols[1])
    finite = bool(torch.isfinite(got).all()) and all(
        bool(torch.isfinite(x.grad).all()) for x in xs)
    return {"forward_max_abs_err": fwd, "forward_past_tolerance": fwd_past,
            "max_abs_out": float(want.detach().abs().max()),
            "backward_max_abs_err": bwd,
            "backward_past_tolerance": bwd_past,
            "tolerances": list(tols),
            "ok": finite and sum(fwd_past) + sum(bwd_past) == 0}


def _kernels_on_shards(seen):
    """Each captured kernel call, forward and backward, against autograd
    through its plain version on the same inputs, in their own type
    (bf16) and widened to float32 (a kernel's float32 design), each at
    the tolerances of phases 17 and 21 for its type; both must hold."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    out = {}
    for name, (args, kw) in seen.items():
        if name == "flash_attention":
            kernel, plain = fa_ops.attention, fa_ref.attention
            tols = (FLASH_TOLERANCE, GRAD_TOLERANCE)
        else:
            kernel = wkv_ops.wkv
            plain = lambda *x: wkv_ref.wkv_chunked(*x, chunk=64)  # noqa
            tols = (WKV_TOLERANCE, WKV_GRAD_TOLERANCE)
        dtype = str(args[0].dtype).split(".")[-1]
        rec = {"local_shapes": [list(a.shape) for a in args],
               "float32": _kernel_vs_plain(
                   kernel, plain, [a.float() for a in args], kw,
                   (tols[0]["float32"], tols[1]["float32"]))}
        if dtype != "float32":
            rec[dtype] = _kernel_vs_plain(kernel, plain, args, kw,
                                          (tols[0][dtype], tols[1][dtype]))
        rec["ok"] = all(rec[t]["ok"] for t in ("float32", dtype))
        out[name] = rec
        _free()
    return out


def _sharded_case(launchers, label, one_step, mesh_step, args_one,
                  args_mesh, compare):
    """One step at ``mesh=None`` and on the mesh from equal inputs: each
    warmed once, then timed; the mesh run's launches and the kernels'
    local inputs held against their plain versions; the largest
    difference by ``compare``, which must be 0: on a world of one rank
    the DTensor path runs the same local ops as the one-device path, so
    any difference (a dropped or mis-scaled update, say) is a fault."""
    _synced(one_step, *args_one())
    want, wall_one = _synced(one_step, *args_one())
    _synced(mesh_step, *args_mesh())
    set_counts(launchers)
    seen, restore = _captured_kernels()
    try:
        got, wall_mesh = _synced(mesh_step, *args_mesh())
    finally:
        restore()
    counts = read_counts(launchers)
    err = compare(got, want)
    del got, want
    _free()
    kernels = _kernels_on_shards(seen)
    return {"case": label, "wall_one_s": wall_one, "wall_mesh_s": wall_mesh,
            "dtensor_host_overhead_s": wall_mesh - wall_one,
            "max_rel_err": err, "bit_equal": err == 0.0,
            "launches": counts, "kernels_on_shards": kernels,
            "ok": (err == 0.0
                   and all(k["ok"] for k in kernels.values()))}


# The same steps on 2 to 8 ranks sharing cuda:0 (``hoststage``) ---------------
SHARDED_RANKS = 8
SHARDED_DENSE = ("llama3.2-3b", "rwkv6-1.6b")
SHARDED_MOE = "deepseek-v2-lite-16b"       # on (2, 2): prefill, train step
SHARDED_POD = (2, 1, 2)                    # ("pod", "data", "model")
POD_FL = "pod FL round"
BF16 = "bf16 kernels"
# the works whose mesh=None steps ranks 0, 1, 2 and 3 run, one each, at
# once (their walls beside each other's)
SHARDED_WANTS = SHARDED_DENSE + (SHARDED_MOE, POD_FL)
# The meshes in the order they run, each over the first ranks (mesh
# shape, what runs on it in order).  One at a time: the steps are bound
# by the host (the staging, DTensor's dispatch), so meshes run at once on
# disjoint ranks gain nothing and hold more host memory at once
SHARDED_MESHES = (((1, 2), SHARDED_DENSE), ((2, 1), SHARDED_DENSE),
                  ((2, 2), SHARDED_DENSE + (BF16, SHARDED_MOE)),
                  ((4, 2), SHARDED_DENSE), (SHARDED_POD, (POD_FL,)))
# every config at its published width, cut to 2 layers; prefill and the
# train step on 8 x 512 tokens; decode of 2 steps at batch 16 into a
# cache of 64 (its sequence splits over ``model``; on a ``data`` axis
# each step gathers every weight again, and 4 steps kept the script
# above its 900 s); the pod FL step: 2 replicas of llama3.2-3b, 4 x 512
# tokens each, 2 local steps
SHARDED_LAYERS = 2
SHARDED_SEQ, SHARDED_BATCH = 512, 8
SHARDED_DECODE_LEN, SHARDED_DECODE_BATCH, SHARDED_DECODE_STEPS = 64, 16, 2
SHARDED_H_LOCAL = 2
# tests/tensor_parallel_cases.py's TOL: x (1 + |want|), float32, TF32 off;
# the collectives reorder sums, so bit for bit is not expected
SHARDED_TOL = 1e-4
# rwkv6-1.6b's float32 decode at full width is conditioned near that
# bound: at mesh=None, its batch of 16 run as two halves of 8 moves the
# first position's logits by 5.7e-5 to 7.8e-5 x (1 + |want|) (one term
# in each head's state, then the head's RMS norm), and the meshes'
# decodes read up to 1.5e-4 (NVIDIA H100 80GB HBM3, 700.00 W); so a
# decode step is held to SHARDED_TOL or to this many times that run's
# own floor at its position, whichever is larger (llama3.2-3b's floor
# is ~5e-6, which leaves it at SHARDED_TOL)
DECODE_FLOOR_FACTOR = 4
SHARDED_CUTS = [f"n_layers {SHARDED_LAYERS} (published: llama3.2-3b 28, "
                f"rwkv6-1.6b 24, deepseek-v2-lite-16b 27)",
                f"train and prefill {SHARDED_BATCH} x {SHARDED_SEQ} tokens",
                f"decode batch {SHARDED_DECODE_BATCH}, cache "
                f"{SHARDED_DECODE_LEN}, {SHARDED_DECODE_STEPS} steps",
                f"pod FL step {SHARDED_BATCH // 2} x {SHARDED_SEQ} tokens a "
                f"replica, h_local {SHARDED_H_LOCAL}"]


def _launchers():
    """Every kernel wrapper whose launches the script counts."""
    from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    return {"fedavg_agg": agg_kernel.weighted_aggregate,
            "flash_attention": fa_kernel.flash_attention,
            "flash_attention_backward": fa_kernel.flash_attention_backward,
            "wkv6": wkv_kernel.wkv,
            "wkv6_backward": wkv_kernel.wkv_backward}


def _sharded_cfg(name, dtype="float32"):
    return _config(name, SHARDED_LAYERS, param_dtype=dtype)


def _sharded_inputs(cfg):
    """The train batch (its inputs are the prefill's) and the decode
    tokens, on the card, the same on every rank."""
    batch = _train_batch(cfg, (SHARDED_BATCH,), SHARDED_SEQ, seed=7)
    tokens = _train_batch(cfg, (SHARDED_DECODE_BATCH,),
                          SHARDED_DECODE_STEPS, seed=8)["inputs"]
    return batch, tokens


def _shapes(cfg):
    from repro_torch.configs.shapes import InputShape
    return (InputShape("sharded", SHARDED_SEQ, SHARDED_BATCH, "train"),
            InputShape("sharded_decode", SHARDED_DECODE_LEN,
                       SHARDED_DECODE_BATCH, "decode"))


def _host_leaves(tree):
    """Float32 host copies of every leaf (copies also of host leaves: the
    step that made them may run again in place)."""
    import torch
    from repro_torch.tree import tree_leaves
    return [x.detach().to("cpu", torch.float32, copy=True)
            for x in tree_leaves(tree)]


def _scalar_err(got: float, want: float) -> float:
    return abs(got - want) / (1 + abs(want))


class _Collectives:
    """The ``hoststage`` collectives this process dispatched while the
    steps ran (the checks' left out): {name: {"count", "bytes",
    "copy_s", "wire_s"}} (``hoststage.stats``)."""

    def __init__(self):
        self.total = {}

    def run(self, fn, *args):
        from repro_torch.launch import hoststage
        before = hoststage.stats()
        out = fn(*args)
        for k, v in hoststage.stats().items():
            was = before.get(k, dict.fromkeys(v, 0))
            if v["count"] == was["count"]:
                continue
            rec = self.total.setdefault(k, dict.fromkeys(v, 0))
            for f, x in v.items():
                rec[f] += x - was[f]
        return out


def _decode(step, params, cache, tokens):
    """``SHARDED_DECODE_STEPS`` decode steps from position 0: each step's
    logits."""
    out = []
    for pos in range(SHARDED_DECODE_STEPS):
        logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
        out.append(logits)
    return out


def _decode_halves(cfg, params, tokens):
    """The decode of :func:`_decode` at ``mesh=None`` on the batch's two
    halves, each its own call: the logits, as one batch."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    half = SHARDED_DECODE_BATCH // 2
    step = make_serve_step(cfg, shape=InputShape(
        "sharded_decode_half", SHARDED_DECODE_LEN, half, "decode"))
    parts = [_decode(step, params, T.init_cache(
        cfg, half, SHARDED_DECODE_LEN, device="cuda"), tokens[rows])
        for rows in (slice(0, half), slice(half, None))]
    return [torch.cat(pair) for pair in zip(*parts)]


def _sharded_want(name):
    """``name``'s steps at ``mesh=None`` on the card (on one of ranks
    0-3, before any mesh), from :func:`_sharded_config_on_mesh`'s params and inputs: the
    prefill logits, the decode logits (a dense config), the train step's
    loss and params, on the host (for :func:`_save_want`); each step's
    wall (the train step's from a second step).  A dense config's
    decode also runs on the batch's two halves: how far that moves the
    logits is the float32 floor of a batch split at ``mesh=None``."""
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.launch.train import (make_prefill_step,
                                          make_sharded_train_step)
    from repro_torch.models import transformer as T
    cfg = _sharded_cfg(name)
    train_shape, decode_shape = _shapes(cfg)
    params = T.init_params(cfg, seed=0, device="cuda")
    batch, tokens = _sharded_inputs(cfg)
    want, walls = {}, {}
    logits, walls["prefill"] = _synced(make_prefill_step(cfg), params,
                                       {"inputs": batch["inputs"]})
    want["prefill"] = logits.cpu()
    if name != SHARDED_MOE:
        cache = T.init_cache(cfg, SHARDED_DECODE_BATCH, SHARDED_DECODE_LEN,
                             device="cuda")
        steps, walls["decode"] = _synced(
            _decode, make_serve_step(cfg, shape=decode_shape), params,
            cache, tokens)
        want["decode"] = [s.cpu() for s in steps]
        want["decode_halves_rel_err"] = [
            _rel_err(a, b) for a, b in zip(
                _decode_halves(cfg, params, tokens), steps)]
        del cache, steps
    step = make_sharded_train_step(cfg, train_shape, lr=TRAIN_LR[name])
    new, metrics = step(params, batch)
    want["loss"] = float(metrics["loss"])
    want["params"] = _host_leaves(new)
    # the wall of a second step (the first allocates the step's memory)
    _, walls["train_step"] = _synced(step, new, batch)
    del params, new
    _free()
    return want, walls


def _save_want(want, root, name):
    """``mesh=None``'s results of ``name`` under ``root/name``, for every
    rank to read: each post-step param leaf an ``.npy`` (float32), the
    rest pickled.  Files, so that no rank holds the whole reference and
    none sends it: each reads its own shards (:func:`_params_err`)."""
    import pickle
    import numpy as np
    out = Path(root) / name
    out.mkdir(parents=True)
    for i, leaf in enumerate(want.pop("params")):
        np.save(out / f"{i}.npy", leaf.numpy())
    with open(out / "rest.pkl", "wb") as fh:
        pickle.dump(want, fh)


def _load_want(root, name):
    """What :func:`_save_want` wrote; ``params`` the directory of the
    leaves."""
    import pickle
    with open(Path(root) / name / "rest.pkl", "rb") as fh:
        want = pickle.load(fh)
    want["params"] = Path(root) / name
    return want


def _params_err(new, leaves_dir):
    """This rank's largest error over every post-step leaf of ``new``
    (DTensors) against its part of the leaf saved in ``leaves_dir``
    (mapped, so only this rank's shard is read; a leaf's leading replica
    axis of 1 added where it has one)."""
    import numpy as np
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.tree import tree_leaves
    err = 0.0
    for i, leaf in enumerate(tree_leaves(new)):
        full = np.load(leaves_dir / f"{i}.npy", mmap_mode="r").reshape(
            leaf.shape)
        shape, offset = compute_local_shape_and_global_offset(
            leaf.shape, leaf.device_mesh, leaf.placements)
        part = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        err = max(err, _rel_err(leaf.to_local(),
                                torch.from_numpy(np.ascontiguousarray(part))))
    return err


def _sharded_config_on_mesh(mesh, name, want, launchers):
    """``name``'s prefill, decode (a dense config) and one train step on
    ``mesh`` from :func:`_sharded_want`'s params and inputs, on every
    rank of the mesh, each result held against ``want``
    (:func:`_load_want`): the logits gathered whole on the mesh's first
    rank, every post-step param shard on its own rank (the largest error
    x (1 + |want|)).  Each
    step's wall, the host seconds of the checks, the collectives the
    steps dispatched and the kernels' launches on this rank."""
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.launch.train import (make_prefill_step,
                                          make_sharded_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.sharding.activations import to_global
    lead = not any(mesh.get_coordinate())
    cfg = _sharded_cfg(name)
    train_shape, decode_shape = _shapes(cfg)
    params = T.init_params(cfg, seed=0, device="cuda")
    batch, tokens = _sharded_inputs(cfg)
    pre = make_prefill_step(cfg, mesh=mesh)
    train = make_sharded_train_step(cfg, train_shape, lr=TRAIN_LR[name],
                                    mesh=mesh)
    sv = (None if name == SHARDED_MOE
          else make_serve_step(cfg, mesh=mesh, shape=decode_shape))
    assert pre.pspecs == train.pspecs and (sv is None
                                           or sv.pspecs == train.pspecs)
    # the three steps place params alike: one copy, the train step last
    # (it updates them in place)
    placed = train.place(params)
    del params
    _free()
    coll, walls, errs = _Collectives(), {}, {}
    set_counts(launchers)
    logits, walls["prefill"] = coll.run(
        _synced, pre, placed, {"inputs": batch["inputs"]})
    t0 = time.perf_counter()
    logits = to_global(logits)
    if lead:
        errs["prefill"] = _rel_err(logits, want["prefill"])
    check_s = time.perf_counter() - t0
    if sv is not None:
        cache = sv.place_cache(T.init_cache(
            cfg, SHARDED_DECODE_BATCH, SHARDED_DECODE_LEN, device="cuda"))
        steps, walls["decode"] = coll.run(_synced, _decode, sv, placed,
                                          cache, tokens)
        t0 = time.perf_counter()
        steps = [to_global(x) for x in steps]
        if lead:
            errs["decode_by_position"] = [
                _rel_err(x, w) for x, w in zip(steps, want["decode"])]
            errs["decode"] = max(errs["decode_by_position"])
        check_s += time.perf_counter() - t0
        del cache, steps
    (new, metrics), walls["train_step"] = coll.run(
        _synced, train, placed, batch)
    del placed
    launches = read_counts(launchers)
    t0 = time.perf_counter()
    errs["params"] = _params_err(new, want["params"])
    if lead:
        errs["loss"] = _scalar_err(float(metrics["loss"]), want["loss"])
    check_s += time.perf_counter() - t0
    del new
    _free()
    return {"walls_s": walls, "check_s": check_s, "max_rel_err": errs,
            "collectives": coll.total, "launches": launches,
            "decode_halves_rel_err": want.get("decode_halves_rel_err")}


def _pod_fl_inputs(cfg):
    """The two replicas' batches, (2, 4, 512) tokens, the same on every
    rank."""
    return _train_batch(cfg, (2, SHARDED_BATCH // 2), SHARDED_SEQ, seed=9)


def _pod_fl_want():
    """The pod FL step's round at ``mesh=None`` on the card (rank 3):
    both replicas stacked (seeds 10 and 11), one ``make_fl_train_step``
    round; replica 0's params on the host, the loss; a second round's
    wall."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    name = "llama3.2-3b"
    cfg = _sharded_cfg(name)
    reps = tree_map(lambda a, b: torch.stack([a, b]),
                    T.init_params(cfg, seed=10, device="cuda"),
                    T.init_params(cfg, seed=11, device="cuda"))
    step = make_fl_train_step(cfg, 2, InputShape(
        "sharded_fl", SHARDED_SEQ, SHARDED_BATCH, "train"),
        lr=TRAIN_LR[name], h_local=SHARDED_H_LOCAL)
    data = _pod_fl_inputs(cfg)
    new, metrics = step(reps, data)
    want = {"loss": float(metrics["loss"]),
            "params": _host_leaves(tree_map(lambda t: t[0], new))}
    _, wall = _synced(step, new, data)    # a second round's wall
    del reps, new
    _free()
    return want, {"fl_round": wall}


def _pod_fl_on_mesh(mesh, want, launchers):
    """The pod FL step on ``mesh`` (pod 2, data 1, model 2): each pod one
    replica, split over ``model``, its rows of the batch, one round
    through ``fedavg_agg`` on every shard; both pods' aggregates held
    against ``want`` (on each pod's first rank), shard by shard."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    name = "llama3.2-3b"
    cfg = _sharded_cfg(name)
    pod = mesh.get_coordinate()[0]
    rep = T.init_params(cfg, seed=10 + pod, device="cuda")
    data = {k: v[pod:pod + 1] for k, v in _pod_fl_inputs(cfg).items()}
    step = make_fl_train_step(cfg, 2, InputShape(
        "sharded_fl", SHARDED_SEQ, SHARDED_BATCH, "train"),
        lr=TRAIN_LR[name], h_local=SHARDED_H_LOCAL, mesh=mesh)
    mine = step.place(tree_map(lambda t: t[None].clone(), rep))
    del rep
    _free()
    coll = _Collectives()
    set_counts(launchers)
    (new, metrics), wall = coll.run(_synced, step, mine, data)
    launches = read_counts(launchers)
    t0 = time.perf_counter()
    errs = {"params": _params_err(new, want["params"])}
    if not any(mesh.get_coordinate()[1:]):     # each pod's first rank
        errs["loss"] = _scalar_err(float(metrics["loss"]), want["loss"])
    check_s = time.perf_counter() - t0
    del new, mine
    _free()
    return {"walls_s": {"fl_round": wall}, "check_s": check_s,
            "max_rel_err": errs, "collectives": coll.total,
            "launches": launches}


def _bf16_kernels_on_mesh(mesh, name):
    """``name`` in bf16 through a prefill on ``mesh``: this rank's first
    attention or wkv call, forward and backward, against the plain
    version on the local inputs it got (:func:`_kernels_on_shards`)."""
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = _sharded_cfg(name, "bfloat16")
    params = T.init_params(cfg, seed=0, device="cuda")
    batch, _ = _sharded_inputs(cfg)
    pre = make_prefill_step(cfg, mesh=mesh)
    placed = pre.place(params)
    del params
    seen, restore = _captured_kernels()
    try:
        _synced(pre, placed, {"inputs": batch["inputs"]})
    finally:
        restore()
    del placed
    _free()
    return _kernels_on_shards(seen)


def _warm_up():
    """This rank's first use of the card's libraries and kernels (the
    attention and wkv kernels forward and backward, in float32): a
    prefill and a train step of each dense config reduced.  Else the
    first full-width step pays it: a ``mesh=None`` wall, or a mesh step
    that every rank of its mesh waits on."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import (make_prefill_step,
                                          make_sharded_train_step)
    from repro_torch.models import transformer as T
    for name in SHARDED_DENSE:
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  param_dtype="float32")
        params = T.init_params(cfg, seed=0, device="cuda")
        data = _train_batch(cfg, (2,), 64)
        _synced(make_prefill_step(cfg), params, {"inputs": data["inputs"]})
        _synced(make_sharded_train_step(
            cfg, InputShape("warm", 64, 2, "train")), params, data)
    _free()


def _sharded_rank(rank, world, want_dir, go):
    """A rank of the multi-rank part of ``phase_sharded_steps`` (ranks on
    ``cuda:0`` over ``hoststage``): it waits for the file ``go`` (the
    parent's own use of the card ends) and warms up (:func:`_warm_up`),
    then ranks 0-3 each run one work's steps at ``mesh=None``
    (``SHARDED_WANTS``) and save the results under ``want_dir``
    (:func:`_save_want`); then every rank makes each mesh of
    ``SHARDED_MESHES`` in turn and its members run the work on it.  Returns this rank's record of each
    mesh it ran, and on (2, 2) its bf16 kernel checks."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    torch.set_num_threads(1)    # 8 ranks share the host's cores
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 600:
            raise TimeoutError(f"no {go} after 600 s")
        time.sleep(0.05)
    _tf32_off()
    launchers = _launchers()
    _warm_up()
    if rank < len(SHARDED_WANTS):
        name = SHARDED_WANTS[rank]
        want, walls = (_pod_fl_want() if name == POD_FL
                       else _sharded_want(name))
        _save_want(dict(want, walls=walls), want_dir, name)
        del want
    dist.barrier()
    records, kernels = [], {}
    for shape, work in SHARDED_MESHES:
        names = (("pod", "data", "model") if len(shape) == 3
                 else ("data", "model"))
        mesh = make_mesh(shape, names, device="cuda")
        if mesh.get_coordinate() is None:
            continue
        for name in work:
            if name == BF16:
                kernels = {n: _bf16_kernels_on_mesh(mesh, n)
                           for n in SHARDED_DENSE}
                continue
            want = _load_want(want_dir, name)
            rec = (_pod_fl_on_mesh(mesh, want, launchers) if name == POD_FL
                   else _sharded_config_on_mesh(mesh, name, want,
                                                launchers))
            records.append({
                "mesh": list(shape), "config": "llama3.2-3b"
                if name == POD_FL else name, "step": name
                if name == POD_FL else "prefill, decode, train step",
                "ranks": list(range(math.prod(shape))),
                "wall_one_s": want["walls"], **rec})
            if rank == 0:   # progress, for a run that fails later
                print(json.dumps({"sharded_steps_done": [
                    list(shape), name], "walls_s": rec["walls_s"],
                    "check_s": rec["check_s"],
                    "rank_s": time.perf_counter() - t0}),
                    file=sys.stderr, flush=True)
    torch.cuda.synchronize()
    return {"records": records, "bf16_kernels": kernels,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def _merged_records(ranks):
    """Rank 0's records (rank 0 is the first rank of every mesh), with
    every member's errors folded in (the largest of each)."""
    def key(rec):
        return tuple(rec["mesh"]), rec["config"], rec["step"]

    out = {key(rec): dict(rec, max_rel_err=dict(rec["max_rel_err"]))
           for rec in ranks[0]["records"]}
    for rank in ranks[1:]:
        for rec in rank["records"]:
            _fold(out[key(rec)]["max_rel_err"], rec["max_rel_err"])
    return list(out.values())


def _fold(into, errs):
    for k, v in errs.items():
        if not isinstance(v, list):
            into[k] = max(into.get(k, 0.0), v)


def _sharded_world_one(launchers, tmp):
    """``phase_sharded_steps``' (1, 1) mesh in an NCCL group of one rank
    (its docstring); returns the kernels' launches."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (make_prefill_step,
                                          make_sharded_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.sharding.activations import to_global
    cases, total = [], {k: 0 for k in launchers}
    shape = InputShape("sharded", 2048, 4, "train")
    with _NcclWorldOne(tmp, "sharded_steps"):
        mesh = make_host_mesh("cuda")
        for name in ("llama3.2-3b", "rwkv6-1.6b"):
            cfg = _config(name)
            params = T.init_params(cfg, seed=0, device="cuda")
            batch = _train_batch(cfg, (4,), 2048, seed=7)
            inputs = {"inputs": batch["inputs"]}
            one = make_prefill_step(cfg)
            on_mesh = make_prefill_step(cfg, mesh=mesh)
            placed = on_mesh.place(params)
            cases.append(_sharded_case(
                launchers, f"{name}_prefill", one, on_mesh,
                lambda: (params, inputs), lambda: (placed, inputs),
                lambda got, want: _rel_err(to_global(got), want)))
            lr = TRAIN_LR[name]
            one = make_sharded_train_step(cfg, shape, lr=lr, donate=False)
            on_mesh = make_sharded_train_step(cfg, shape, lr=lr,
                                              donate=False, mesh=mesh)
            placed = on_mesh.place(params)
            cases.append(_sharded_case(
                launchers, f"{name}_train_step", one, on_mesh,
                lambda: (params, batch), lambda: (placed, batch),
                lambda got, want: max(
                    _tree_rel_err(got[0], want[0]),
                    _rel_err(got[1]["loss"], want[1]["loss"]))))
            del params, placed, batch, one, on_mesh
            _free()
    for case in cases:
        for k, v in case["launches"].items():
            total[k] += v
    llama_pre, llama_train, rwkv_pre, rwkv_train = (c["launches"]
                                                    for c in cases)
    launches_ok = (llama_pre["flash_attention"] == 28
                   and llama_train["flash_attention"] == 2 * 28
                   and llama_train["flash_attention_backward"] == 28
                   and rwkv_pre["wkv6"] == 24
                   and rwkv_train["wkv6"] == 2 * 24
                   and rwkv_train["wkv6_backward"] == 24)
    ok = launches_ok and all(c["ok"] for c in cases)
    emit({"phase": "sharded_steps", "ok": ok, "card": nvidia_smi(),
          "mesh": "(1, 1) data x model, NCCL world 1",
          "launches_ok": launches_ok, "cases": cases})
    if not ok:
        raise RuntimeError("sharded_steps: a DTensor step not bit for bit "
                           "the one-device step, a kernel apart from its "
                           "plain version, or a launch count off")
    return total


def phase_sharded_steps(launchers, tmp):
    """The DTensor steps (tensor and FSDP parallelism), first in an NCCL
    group of one rank on a (1, 1) ``("data", "model")`` mesh
    (``make_host_mesh``), params placed by ``param_pspecs``: llama3.2-3b
    and rwkv6-1.6b at full width and depth, prefill of 4 x 2048 tokens
    and one train step (remat) on 4 x 2048, each against the same step
    at ``mesh=None`` from the same params and batch: the logits, the loss
    and the post-step params bit for bit equal (the largest difference
    printed); both walls (their difference is DTensor's host overhead);
    the kernels' launches on the mesh run, as many as the one-device
    step's; and the first attention and wkv call of each mesh step held,
    forward and backward, against the plain version on the local inputs
    it was given, in bf16 and in float32.

    Then the same steps at world > 1: ``SHARDED_RANKS`` ranks spawned on
    ``cuda:0`` over ``hoststage`` (``repro_torch.launch.hoststage``:
    each collective staged through host memory over ``gloo``; NCCL puts
    one rank on a card, and plain ``gloo``'s all-gather on CUDA tensors
    ends the rank), every config at its published width cut as
    ``SHARDED_CUTS`` says, in float32 (TF32 off): llama3.2-3b and
    rwkv6-1.6b on (1, 2), (2, 1), (2, 2) and (4, 2) (prefill, one train
    step with remat, 2 decode steps at batch 16), deepseek-v2-lite-16b on
    (2, 2) (prefill, train step), and the pod FL round of two llama3.2-3b
    replicas on (pod 2, data 1, model 2) through ``fedavg_agg`` on every
    shard, one mesh after another (``SHARDED_MESHES``).  Each is held
    against the same step at ``mesh=None`` on the card, which rank 0
    runs first while the others warm up:
    prefill logits, the loss and every post-step param within
    ``SHARDED_TOL`` x (1 + |want|), each decode step within that or
    ``DECODE_FLOOR_FACTOR`` times the float32 floor measured beside it
    (the ``mesh=None`` decode on the batch's two halves).  One line a
    mesh and config: those errors, the collectives the steps dispatched
    on rank 0 (count, bytes, host seconds: none fails the line), the
    kernels' launches there against the count the layers need, both walls and the checks' seconds; on (2, 2) each of the 4
    ranks' first attention and wkv call of a bf16 prefill held, forward
    and backward, against the plain version on its local inputs.  A
    backend that cannot be registered fails the phase: nothing drops to
    one rank or to ``mesh=None``."""
    from repro_torch.launch import hoststage
    from repro_torch.launch.spawn import run_ranks
    total = {k: 0 for k in launchers}
    go = os.path.join(tmp, "sharded_go")

    def world_one():
        for k, v in _sharded_world_one(launchers, tmp).items():
            total[k] += v
        _free()
        Path(go).touch()

    t0 = time.perf_counter()
    ranks = run_ranks(_sharded_rank, SHARDED_RANKS,
                      os.path.join(tmp, "sharded_hoststage"),
                      (os.path.join(tmp, "sharded_want"), go),
                      backend=hoststage.BACKEND, device="cuda", timeout=900,
                      while_running=world_one)
    wall = time.perf_counter() - t0
    card = nvidia_smi()
    lines = [_sharded_line(rec, ranks, card) for rec in _merged_records(ranks)]
    for line in lines:
        emit(line)
        for k, v in line["launches_rank0"].items():
            total[k] += v
    expected = sum(len([w for w in work if w != BF16])
                   for _, work in SHARDED_MESHES)
    ok = len(lines) == expected and all(line["ok"] for line in lines)
    emit({"phase": "sharded_steps", "ok": ok, "card": card,
          "route": f"{SHARDED_RANKS} ranks on cuda:0 over hoststage",
          "lines": len(lines), "ranks_wall_s": wall,
          "peak_memory_gib": [r["peak_memory_gib"] for r in ranks]})
    if not ok:
        raise RuntimeError("sharded_steps: a mesh step apart from mesh=None "
                           "beyond tolerance, no collective dispatched, a "
                           "launch count off or a bf16 kernel check failed")
    return total


def _sharded_expected(rec):
    """The kernels' launches rank 0 must count for a record, for each
    attention or wkv layer: a prefill's forward and a train step's (with
    remat a forward and its recompute) and backward; the pod FL round
    ``SHARDED_H_LOCAL`` train steps and one ``fedavg_agg`` launch.
    Decode runs no kernel."""
    cfg = _sharded_cfg(rec["config"])
    attn, wkv = _attention_layers(cfg), _mixer_layers(cfg, "rwkv6")
    train = 2 if cfg.remat else 1
    if rec["step"] == POD_FL:
        fwd, bwd, agg = train * SHARDED_H_LOCAL, SHARDED_H_LOCAL, 1
    else:
        fwd, bwd, agg = 1 + train, 1, 0
    return {"fedavg_agg": agg, "flash_attention": fwd * attn,
            "flash_attention_backward": bwd * attn, "wkv6": fwd * wkv,
            "wkv6_backward": bwd * wkv}


def _sharded_line(rec, ranks, card):
    """One mesh and config's line from rank 0's record (and, on (2, 2),
    every member's bf16 kernel checks), with its verdict."""
    mesh, name = tuple(rec["mesh"]), rec["config"]
    expected = _sharded_expected(rec)
    coll = rec["collectives"]
    need = ["all_gather_into_tensor"]
    if len(mesh) == 3:
        need.append("all_reduce")
    elif mesh[0] > 1:
        need.append("reduce_scatter_tensor")
    coll_ok = all(coll.get(k, {}).get("count", 0) > 0
                  and coll[k]["bytes"] > 0 for k in need)
    errs = rec["max_rel_err"]
    floor = rec.get("decode_halves_rel_err")
    decode_tol = [max(SHARDED_TOL, DECODE_FLOOR_FACTOR * f)
                  for f in floor or ()]
    errs_ok = all(v <= SHARDED_TOL for k, v in errs.items()
                  if k not in ("decode", "decode_by_position")) and all(
        e <= t for e, t in zip(errs.get("decode_by_position", ()),
                               decode_tol))
    line = {"phase": "sharded_steps", "mesh": list(mesh),
            "axes": (["pod", "data", "model"] if len(mesh) == 3
                     else ["data", "model"]),
            "config": name, "step": rec["step"], "ranks": rec["ranks"],
            "route": "hoststage", "cuts": SHARDED_CUTS,
            "tolerance": SHARDED_TOL, "max_rel_err": rec["max_rel_err"],
            "walls_mesh_s": rec["walls_s"], "walls_one_s": rec["wall_one_s"],
            "check_s": rec["check_s"],
            "decode_one_device_halves_rel_err": floor,
            "decode_tolerance_by_position": decode_tol,
            "collectives_rank0": coll, "collectives_needed": need,
            "launches_rank0": rec["launches"],
            "launches_expected": expected}
    ok = errs_ok and coll_ok and rec["launches"] == expected
    if name in SHARDED_DENSE and BF16 in dict(SHARDED_MESHES)[mesh]:
        members = [ranks[r]["bf16_kernels"][name] for r in rec["ranks"]]
        line["bf16_kernels_on_shards"] = members
        ok = ok and all(k["ok"] for m in members for k in m.values()) and all(
            len(m) == 1 for m in members)
    line["ok"], line["card"] = ok, card
    return line


class _DryRuns:
    """``python -m repro_torch.launch.dryrun`` for each argument list of
    ``DRYRUNS`` in a subprocess, all started on entry, so that they run
    beside the host-bound ``roofline`` phase; stopped on exit if still
    running; their output directories removed.  ``results()`` waits:
    each JSON record and host wall."""

    def __enter__(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.runs = []
        for key, args in DRYRUNS.items():
            out = tempfile.mkdtemp(prefix="dryrun_")
            log = open(os.path.join(out, "log"), "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", out], stdout=log, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=str(ROOT))
            self.runs.append((key, args, proc, out, log,
                              time.perf_counter()))
        return self

    def results(self, timeout=300):
        recs = {}
        for key, args, proc, out, log, t0 in self.runs:
            rc = proc.wait(timeout=timeout)
            wall = time.perf_counter() - t0
            log.close()
            if rc != 0:
                raise RuntimeError(
                    f"dryrun {' '.join(args)} failed:\n"
                    f"{Path(out, 'log').read_text()[-4000:]}")
            path = next(Path(out).glob("*.json"))
            recs[key] = (json.loads(path.read_text()), wall)
        return recs

    def __exit__(self, *exc):
        import shutil
        for _, _, proc, out, log, _ in self.runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            shutil.rmtree(out, ignore_errors=True)
        return False


DRYRUNS = {"olmo-1b_single": ("--arch", "olmo-1b", "--shape", "train_4k",
                              "--mesh", "single"),
           "llama3.2-3b_multi_fl": ("--arch", "llama3.2-3b", "--shape",
                                    "train_4k", "--mesh", "multi",
                                    "--fl-step")}


def phase_dryrun_mesh(dryruns):
    """The dry run on the production meshes, each in its own process on a
    ``"fake"`` group (``dryruns``, a :class:`_DryRuns`): olmo-1b
    train_4k at ``--mesh single`` (256 ranks) and llama3.2-3b train_4k at
    ``--mesh multi --fl-step`` (512), both ``status: ok`` with all-gather
    and all-reduce bytes; olmo-1b's per-device FLOPs x 256 over its
    ``--mesh one`` count (``run_one`` in this process; its 16 heads split
    over ``model`` 16: in [0.99, 2.0])."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    one = dryrun.run_one("olmo-1b", "train_4k", "one")
    wall_one = time.perf_counter() - t0
    recs = dryruns.results()
    ratio = (recs["olmo-1b_single"][0]["flops_per_dev"] * 256
             / one["flops_per_dev"])
    rows, ok = {}, 0.99 <= ratio <= 2.0
    for key, (rec, wall) in recs.items():
        coll = rec["collective_bytes_per_dev"]
        row_ok = (rec["status"] == "ok" and coll.get("all-gather", 0) > 0
                  and coll.get("all-reduce", 0) > 0)
        ok = ok and row_ok
        rows[key] = {"status": rec["status"], "n_chips": rec["n_chips"],
                     "flops_per_dev": rec["flops_per_dev"],
                     "bytes_per_dev": rec["bytes_per_dev"],
                     "collective_bytes_per_dev": coll,
                     "layouts": rec.get("layouts"),
                     "bound_s": rec["roofline"]["bound_s"],
                     "dominant": rec["roofline"]["dominant"],
                     "count_s": rec["count_s"], "process_wall_s": wall,
                     "ok": row_ok}
    emit({"phase": "dryrun_mesh", "ok": ok, "records": rows,
          "olmo_one_flops": one["flops_per_dev"],
          "olmo_one_count_wall_s": wall_one,
          "olmo_flops_x256_over_one": ratio})
    if not ok:
        raise RuntimeError("dryrun_mesh: a mesh record not ok, a "
                           "collective missing, or the FLOPs ratio out of "
                           "[0.99, 2.0]")


# ---------------------------------------------------------------------------
# The port's own entry points (repro_torch.examples), as a user runs them
# ---------------------------------------------------------------------------
EXAMPLE_POLICIES = ("synchronous", "elected_hub", "partial", "soft_async")


def _quiet(main, argv):
    """An example's ``main(argv)``, its printed lines kept out of this log
    (the result holds them)."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _example(launchers, main, argv):
    """An example's ``main(argv)`` with every count from 0: its result, the
    counts and the host wall."""
    import torch
    set_counts(launchers)
    t0 = time.perf_counter()
    out = _quiet(main, argv)
    torch.cuda.synchronize()
    return out, read_counts(launchers), time.perf_counter() - t0


def _finite(values):
    return len(values) > 0 and all(math.isfinite(v) for v in values)


def phase_examples(launchers):
    """Each example of ``repro_torch.examples`` on the card through its
    ``main`` with a user's command line: ``sagin_fl_end2end`` at its
    defaults (200 rounds, adaptive then none; one ``fedavg_agg`` launch a
    round; the first 3 rounds' plan cases and training times as a CPU
    run's), ``--scenario multi_region --global-model --rounds 6`` under
    each federation policy (one launch a region-round and one a merge),
    ``--scenario degraded_links --rounds 3``, ``quickstart``,
    ``offloading_walkthrough``, ``multiarch_demo`` over all ten configs
    and ``serve_demo`` for llama3.2-3b and internvl2-1b.  One line a run,
    with the lines the example printed.  Returns the launches summed."""
    from repro_torch.examples import (multiarch_demo, offloading_walkthrough,
                                      quickstart, sagin_fl_end2end,
                                      serve_demo)
    total = {k: 0 for k in launchers}
    bad = []

    def report(example, argv, out, counts, wall, ok, **extra):
        for k, n in counts.items():
            total[k] += n
        emit({"phase": "examples", "example": example, "argv": argv,
              "ok": ok, "wall_s": wall, "launches": counts, **extra,
              "lines": out["lines"]})
        if not ok:
            bad.append(f"{example} {' '.join(argv)}")

    def fl_summary(res):
        return {"rounds": len(res.accuracies),
                "training_time_s": res.times[-1],
                "best_acc": max(res.accuracies),
                "time_to_80_s": res.time_to_accuracy(0.8),
                "cases_used": sorted(set(res.cases))}

    # the paper's comparison at the example's defaults, then its first 3
    # rounds on the CPU: the plan is the control plane's, device-free
    argv = []
    out, counts, wall = _example(launchers, sagin_fl_end2end.main, argv)
    res = out["results"]
    cpu = _quiet(sagin_fl_end2end.main,
                 ["--rounds", "3", "--device", "cpu"])["results"]
    same_plan = all(cpu[s].cases == res[s].cases[:3]
                    and cpu[s].times == res[s].times[:3] for s in cpu)
    rounds = 200
    ok = (sorted(res) == ["adaptive", "none"]
          and all(len(r.accuracies) == rounds and _finite(r.accuracies)
                  for r in res.values())
          and counts["fedavg_agg"] == 2 * rounds and same_plan)
    report("sagin_fl_end2end", argv, out, counts, wall, ok,
           first_3_rounds_as_cpu=same_plan,
           **{s: fl_summary(r) for s, r in res.items()})
    for policy in EXAMPLE_POLICIES:
        argv = ["--scenario", "multi_region", "--global-model", "--rounds",
                "6", "--policy", policy]
        out, counts, wall = _example(launchers, sagin_fl_end2end.main, argv)
        res, merges = out["results"], out["merges"]
        region_rounds = sum(len(r.accuracies) for r in res.values())
        ok = (len(res) == 4 and region_rounds == 24
              and all(_finite(r.accuracies) for r in res.values())
              and len(merges) > 0 and all(m.policy == policy for m in merges)
              and counts["fedavg_agg"] == region_rounds + len(merges))
        report("sagin_fl_end2end", argv, out, counts, wall, ok,
               region_rounds=region_rounds, merges=len(merges),
               global_acc=[max(a for a in m.accuracies if not math.isnan(a))
                           for m in merges])
    argv = ["--scenario", "degraded_links", "--rounds", "3"]
    out, counts, wall = _example(launchers, sagin_fl_end2end.main, argv)
    res = out["results"]
    ok = (sorted(res) == ["adaptive", "none"]
          and all(_finite(r.accuracies) for r in res.values())
          and counts["fedavg_agg"] == 6)
    report("sagin_fl_end2end", argv, out, counts, wall, ok,
           **{s: fl_summary(r) for s, r in res.items()})
    out, counts, wall = _example(launchers, quickstart.main, [])
    res = out["result"]
    ok = (len(res.accuracies) == 4 and _finite(res.accuracies)
          and counts["fedavg_agg"] == 4)
    report("quickstart", [], out, counts, wall, ok, case=out["plan"].case,
           speedup=out["baseline"] / out["plan"].round_latency,
           **fl_summary(res))
    out, counts, wall = _example(launchers, offloading_walkthrough.main, [])
    ok = len(out["chain"]) > 0 and math.isfinite(out["plan"].round_latency)
    report("offloading_walkthrough", [], out, counts, wall, ok,
           windows=len(out["intervals"]))
    out, counts, wall = _example(launchers, multiarch_demo.main, [])
    runs = out["runs"]
    ok = (len(runs) == 10 and _finite([r["loss"] for r in runs])
          and counts["flash_attention"] > 0 and counts["wkv6"] > 0)
    report("multiarch_demo", [], out, counts, wall, ok,
           losses={r["arch"]: r["loss"] for r in runs},
           decoded={r["arch"]: r["decoded"] for r in runs})
    for arch in ("llama3.2-3b", "internvl2-1b"):
        argv = ["--arch", arch]
        out, counts, wall = _example(launchers, serve_demo.main, argv)
        seqs = out["sequences"]
        ok = len(seqs) == 4 and all(len(s) == 24 for s in seqs)
        report("serve_demo", argv, out, counts, wall, ok,
               tokens_per_s=out["tokens_per_s"], device=out["device"])
    _free()
    if bad:
        raise RuntimeError(f"examples: an example's run is off: {bad}")
    return total


def _kernel_line(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def main() -> int:
    # cuBLAS reads its workspace setting once, when it starts; a fixed
    # workspace is what deterministic algorithms need (engine_resume),
    # and 32 MiB is the size PyTorch picks on Hopper anyway
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
        from repro_torch.kernels.fedavg_agg import ref as agg_ref
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.wkv6 import kernel as wkv_kernel
        from repro_torch.kernels.wkv6 import ref as wkv_ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run it from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    launchers = _launchers()
    try:
        _run(phase_card, [(agg_kernel.SOURCE, agg_kernel.build),
                    (fa_kernel.SOURCE, fa_kernel.build),
                    (fa_kernel.SOURCE_BWD, fa_kernel.build_backward),
                    (wkv_kernel.SOURCE, wkv_kernel.build),
                    (wkv_kernel.SOURCE_BWD, wkv_kernel.build_backward)])
        launches, split = _run(phase_main_path, launchers)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            launches += _run(phase_contracts, launchers, agg_kernel, tmp)
        _run(phase_round_profile)
        summary = _run(phase_kernel, agg_kernel, agg_ref, split)
        _run(phase_card_vs_cpu, agg_kernel)
        _run(phase_vgg11, agg_kernel)
        _run(phase_propagation)
        launches += _run(phase_scenario_paper, launchers)
        launches += _run(phase_engine_fl, launchers)
        _run(phase_engine_chaos, launchers)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            resumed, resume_launches = _run(phase_engine_resume, launchers,
                                            tmp)
            launches += resume_launches
            launches += _run(phase_serve_gateway, launchers, resumed, tmp)
            del resumed
            _free()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            mesh_launches, shard_split = _run(phase_mesh_cohort, launchers,
                                              tmp)
            launches += mesh_launches
            launches += _run(phase_mesh_collectives, launchers, agg_kernel,
                                               agg_ref, shard_split, tmp)
        examples = _run(phase_examples, launchers)
        launches += examples["fedavg_agg"]
        fa_launches, prefill_shapes = _run(phase_transformer_prefill,
                                           launchers)
        _run(phase_transformer_decode, launchers)
        f32_shapes = _run(phase_decode_vs_prefill, launchers)
        wkv_launches, wkv_shape = _run(phase_rwkv6, launchers)
        moe_launches, moe_shapes = _run(phase_moe_prefill, launchers)
        fa_launches += moe_launches
        _run(phase_transformer_decode, launchers, "deepseek-v2-lite-16b",
                                 "moe_decode")
        _run(phase_moe_decode_vs_prefill, launchers)
        hybrid_launches, hybrid_shapes = _run(phase_hybrid_prefill,
                                              launchers)
        fa_launches += hybrid_launches
        _run(phase_transformer_decode, launchers, HYBRID, "hybrid_decode")
        _run(phase_hybrid_decode_vs_prefill, launchers)
        dense_launches, dense_shapes = _run(phase_dense_prefill, launchers)
        fa_launches += dense_launches
        _run(phase_dense_decode, launchers)
        _run(phase_dense_decode_vs_prefill, launchers)
        fa_case = _run(phase_flash_kernel, fa_kernel, fa_ref, prefill_shapes,
                                     f32_shapes, moe_shapes, hybrid_shapes,
                                     dense_shapes)
        wkv_case = _run(phase_wkv_kernel, wkv_kernel, wkv_ref, wkv_shape)
        train, train_shapes = _run(phase_transformer_train, launchers)
        rwkv_train, rwkv_train_shape = _run(phase_rwkv6_train, launchers)
        moe_train, moe_train_shapes = _run(phase_moe_train, launchers)
        fl_train = _run(phase_fl_train_step, launchers, agg_ref)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            mesh_fl = _run(phase_mesh_fl_train_step, launchers, tmp)
        moe_fl = _run(phase_fl_train_step, launchers, agg_ref,
                                     "deepseek-v2-lite-16b", n_layers=2,
                                     phase="moe_fl_train_step")
        hybrid_train = _run(phase_hybrid_train, launchers)
        hybrid_fl = _run(phase_fl_train_step, launchers, agg_ref, HYBRID,
                                        n_layers=2,
                                        phase="hybrid_fl_train_step")
        dense_train = _run(phase_dense_train, launchers)
        trained = (train, moe_train, fl_train, mesh_fl, moe_fl,
                   hybrid_train, hybrid_fl, dense_train, examples)
        launches += sum(c["fedavg_agg"] for c in trained[:-1])
        fa_launches += sum(c["flash_attention"] for c in trained)
        fa_bwd_launches = sum(c["flash_attention_backward"]
                              for c in trained)
        wkv_launches += rwkv_train["wkv6"] + examples["wkv6"]
        wkv_bwd_launches = (rwkv_train["wkv6_backward"]
                            + examples["wkv6_backward"])
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            sharded = _run(phase_sharded_steps, launchers, tmp)
        launches += sharded["fedavg_agg"]
        fa_launches += sharded["flash_attention"]
        fa_bwd_launches += sharded["flash_attention_backward"]
        wkv_launches += sharded["wkv6"]
        wkv_bwd_launches += sharded["wkv6_backward"]
        fa_bwd_case = _run(phase_flash_backward_kernel, fa_kernel, fa_ref,
                                                  train_shapes,
                                                  moe_train_shapes,
                                                  hybrid_shapes, dense_shapes)
        wkv_bwd_case = _run(phase_wkv_backward_kernel, wkv_kernel, wkv_ref,
                                                 rwkv_train_shape)
        # the dry runs' processes run beside roofline: both are the host's
        with _DryRuns() as dryruns:
            _run(phase_roofline)
            _run(phase_dryrun_mesh, dryruns)
    except Exception:  # report the failed phase, then fail the run
        traceback.print_exc()
        emit({"phase": "failed", "error": traceback.format_exc(limit=3)})
        return 1
    emit({"kernels": [
        _kernel_line("fedavg_agg", "src/repro_torch/kernels/fedavg_agg/"
                     "csrc/fedavg_agg.cu",
                     "src/repro/kernels/fedavg_agg/kernel.py:27", launches,
                     summary),
        _kernel_line("flash_attention", "src/repro_torch/kernels/"
                     "flash_attention/csrc/flash_attention_wgmma.cuh",
                     "src/repro/kernels/flash_attention/kernel.py:76",
                     fa_launches, fa_case),
        _kernel_line("flash_attention_backward", "src/repro_torch/kernels/"
                     "flash_attention/csrc/flash_attention_bwd_wgmma.cuh",
                     "src/repro/kernels/flash_attention/kernel.py:76",
                     fa_bwd_launches, fa_bwd_case),
        _kernel_line("wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6/kernel.py:53", wkv_launches,
                     wkv_case),
        _kernel_line("wkv6_backward", "src/repro_torch/kernels/wkv6/csrc/"
                     "wkv6_bwd.cu", "src/repro/kernels/wkv6/kernel.py:53",
                     wkv_bwd_launches, wkv_bwd_case)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
