#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It builds
the port's CUDA kernels from ``spark_ensemble_tpu_torch/csrc`` with nvcc,
holds every kernel against its plain PyTorch version at the main path's
shapes and beside them (the GBM path's C=2 statistics, and the forests'
at M=10 and M=1 with Poisson weights: the classifiers' C=27 on letter, the
regressors' C=2 on 8192x12 data; and the level histograms on 2.1M tall
rows of HIGGS's width, whose shallow levels split a tile's rows over
several clusters: ``tall_rows``), times each kernel
(``ms``: one call through its wrapper, host issue time included;
``device_ms``: the kernels' own time on the card from torch.profiler),
drives the GBM main path through the public estimators on three histogram
tiers, then the ported families: the random draws against the CPU's,
Bagging, Boosting and GBM with row and feature sampling, GBM's other seven
losses, the fast precisions "high" and "default", and Stacking over the
tree, linear and naive Bayes learners (on adult-shaped 32561x123 binary
data too, where the kernels tile 123 features in 31 packed words), then
the stream tier at bench.py's XL size (2,097,152 x 64, 8 classes: the
default tree's hist="auto" resolves to it there), GBM's GOSS/MVS row
compaction on the main path (the fused kernels at the 8192-row bucket),
linear-leaf GBM, the kernels at the megabatch sweep's M = 12 x 26 = 312
(each lane of the wide launch equal to its own launch), a CrossValidator
over the main path at megabatch "on" and "off" (equal bit for bit) and
the reference's CrossValidator over Bagging, the MLP and the ensembles over
non-tree members, and pipelines, then persistence and the round runtime:
the timed 100-round model saved and loaded (``persist``), fits preempted
by the chaos harness after a checkpoint and resumed (``checkpoint``),
shorter models continued with ``fit_resume``, a chaos NaN under each
recovery policy, pipeline depths 0, 1 and 2 and a torn checkpoint
(``robustness``), each held bit for bit to its uninterrupted fit, and the
fit rate with and without checkpoints (``checkpoint_timing``), then the
out-of-core data plane: bench.py's XL data sealed into a shard store and
fitted with ``fit_streaming`` beside the resident stream-tier fit, and
regressors on 8192x12 shards, each equal to its resident twin, a mid-shard
preemption resumed (``streaming``), and packed export: the timed model
packed, saved, loaded, sliced with ``take`` and continued with
``fit_resume``, each equal to its live twin (``export``), then the
telemetry core: the timed main path streaming its events to a JSONL sink
beside telemetry-off fits (``telemetry``: the same model bit for bit, the
same launches, the overhead), a ``profile_dir`` capture naming the three
kernels (``profile_dir``), and the serving engine over the timed model,
one CUDA graph per (method, bucket, tier), with its latency, rows/s and
drift sketches, a one-row request equal to the same row in a batch bit for
bit (``serving``), then the closed serving loop over the timed model: a
``ModelRegistry``, a ``FleetRouter`` of three replicas under four client
threads with a stalled replica, a killed one and deadline pressure,
torn-free swaps, the watchdog raising on shifted rows and the
``Autopilot`` refreshing the model in the background under traffic (equal
to an uninterrupted longer fit), a shadow scorer's rollback, a chaos
``refresh_crash``, and an eviction that frees device memory (``fleet``), then
the SPMD fits over ``torch.distributed`` (``distributed``): the main path
on a one-rank NCCL mesh, bit-identical to its unmeshed fit with the same
launches, then 2 and 4 ranks of this script on the one card over gloo,
every rank's fitted params bit-identical (the ranks' digests), the
accuracy within 0.02 of one rank, and a dyadic regressor's first round,
Bagging and SAMME on the same mesh, then the elastic plane (``elastic``):
2 ranks stream the XL store over a mesh, bit-identical to the
single-process streaming fit; 3 ranks run an ``ElasticCoordinator`` fit
that loses rank 1 mid-level and resumes on the 2 survivors, bit-identical
to the single-process fit, with the victim's flight dump on disk; and 2
ranks kill and resume checkpointed mesh fits of the main path and SAMME
(equal to the uninterrupted mesh fits), stack with each member on one
rank, sweep the tuning phase's 12 candidates with the lanes sharded over
the member axis (each lane held to the whole sweep's) and cross-validate
over the mesh, and the autotune plane (``autotune``, after the operator
plane): the smoke search published and hit, every candidate of the four
kernel plan knobs at the main path's shapes timed and held to the plain
version (each staged-row count bit for bit to the shipped one), the main
path with autotuning off equal to an empty cache's, under the winners and
under each staged-row count, mode ``search`` searching once, and the
kernels' build cache cold and warm, and last the analysis plane
(``analysis``): the port linting clean, the native libsvm parser built
and equal to the numpy parser on a generated letter-shaped file, and the
program contracts traced on the card (every family, the kernels' launches
a round, host reads and syncs a round, no nvcc build inside a fit, no
capture after warmup or in a swap, the distributed sweep on spawned gloo
ranks) held to the committed ``analysis/contracts.json``.  It checks the results; each phase prints one JSON line; any failed check raises,
and so does a retry that no chaos fault injected, and the script exits
non-zero.  Checkpoints and saves go to a scratch directory under
``build/``, removed at the end.
The last two lines are the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when CUDA is unavailable or when the
port's package is not beside it.  ``python3 chip_smoke.py --tall-rows``
(``--wide-rows``, ``--row-lists``) builds the kernels and runs the
``tall_rows`` (``wide_rows``, ``row_lists``) check alone.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_ROWS, N_FEATURES, N_CLASSES = 15000, 16, 26  # letter-shaped main path
DEPTH, MAX_BINS = 5, 64
PARITY_ROUNDS, TIMED_ROUNDS = 20, 100
KERNEL_RUNS, KERNEL_REPS = 5, 50  # each time: median, min and max of 5 runs of 50 launches
FP32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
ADULT_ROWS, ADULT_FEATURES = 32561, 123  # a9a's shape
XL_ROWS, XL_FEATURES, XL_CLASSES, XL_ROUNDS = 2_097_152, 64, 8, 10  # bench.py's XL leg
STREAM_CHECK_ROWS = 262_144  # the stream-vs-matmul one-round check
SWEEP_LANES = 12  # the tuning phase's candidates: 2 x 2 maps x 3 folds
STREAM_FIT_ROUNDS = 3  # the streaming phase's XL fits


def emit(obj):
    print(json.dumps(obj), flush=True)


def letter_data(seed=0):
    """Synthetic letter-shaped data, as bench.py builds it when the
    reference datasets are absent."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N_ROWS, N_FEATURES).astype(np.float32)
    centers = rng.randn(N_CLASSES, N_FEATURES).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.5 * rng.randn(N_ROWS, N_CLASSES), axis=1)
    return X, y.astype(np.float32)


def regression_data(n=8192, d=12, seed=0):
    """cpusmall-shaped synthetic regression data (the test fixture's recipe)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = 2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + X[:, 2] * X[:, 3] + 0.1 * rng.randn(n)
    return X, y.astype(np.float32)


def xl_data(seed=0):
    """bench.py's XL data (``_bench_xl_extras``): Gaussian features, the
    label the argmax of a noisy projection on 8 class centres."""
    rng = np.random.RandomState(seed)
    X = rng.randn(XL_ROWS, XL_FEATURES).astype(np.float32)
    centers = rng.randn(XL_CLASSES, XL_FEATURES).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.5 * rng.randn(XL_ROWS, XL_CLASSES), axis=1)
    return X, y.astype(np.float32)


def adult_data(seed=0):
    """Synthetic adult-shaped data, mimicking the reference's a9a: binary
    0/1 features at about 11% density, the label drawn from a logistic
    model over a few of them (the reference data is absent here)."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(ADULT_ROWS, ADULT_FEATURES) < 0.11).astype(np.float32)
    coef = np.zeros(ADULT_FEATURES)
    coef[rng.choice(ADULT_FEATURES, 10, replace=False)] = 2.0 * rng.randn(10)
    logit = X @ coef - 1.0
    y = rng.rand(ADULT_ROWS) < 1.0 / (1.0 + np.exp(-logit))
    return X, y.astype(np.float32)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name):
    """Device-memory rate of the card (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def largest_prime_at_most(n):
    def prime(k):
        return k > 1 and all(k % p for p in range(2, int(math.isqrt(k)) + 1))

    while not prime(n):
        n -= 1
    return n


class KernelRecord:
    """The per-kernel numbers of the final ``{"kernels": [...]}`` line.
    ``timing`` holds the main path's deepest shapes; ``spread`` the
    (median, min, max) of its kernel time; ``per_level`` one entry per level
    of the main path for the level histograms."""

    def __init__(self, name, replaces):
        self.name, self.replaces = name, replaces
        self.max_abs_err = 0.0
        self.timing = None  # (ms, plain_ms, bound_ms, bound_by, library_ms)
        self.spread = None
        self.device_ms = None  # (median, min, max) of the kernels' own time per call
        self.library_device_ms = None
        self.per_level = None
        self.shapes = []  # device time at the classifier forests' shapes
        self.launches = 0

    def json(self):
        ms, plain_ms, bound_ms, bound_by, library_ms = self.timing
        out = {
            "name": self.name, "route": "cuda",
            "source": "spark_ensemble_tpu_torch/csrc/hist.cu",
            "replaces": self.replaces, "launches": self.launches,
            "max_abs_err": self.max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "spread": self.spread, "device_ms": self.device_ms,
            "library_device_ms": self.library_device_ms,
        }
        if self.per_level is not None:
            out["per_level"] = self.per_level
        out["shapes"] = self.shapes
        return out


#: the fleet phase: replicas, client threads and requests of the load, new
#: rounds of a refresh, the pause between a client's requests while the
#: traffic runs beside a swap or a refresh (without it the clients' and
#: replicas' host threads starve the refresh fit's: the phase times one
#: refresh beside unpaced clients too), and the shadow rule's divergence
#: threshold (the candidate's probabilities moving by more than 1e-4 of
#: their mean breaches it: a refresh of 10 rounds moves them more, and on
#: the training rows it changes no predicted label)
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_REQUESTS = 3, 4, 200
REFRESH_ROUNDS = 10
FLEET_PAUSE_S = 0.02
SHADOW_THRESHOLD = 1e-4


#: the distributed phase: rounds of the mesh fits, and the time a rank group
#: may take before its processes are killed and the phase fails
DIST_ROUNDS, DIST_TIMEOUT_S = 20, 300

#: the tall-row level histograms: HIGGS's shape (28 features, 63 bins in
#: 8-bit lanes, one tree, C = 2) on fewer rows, depth 8, and the lanes of
#: the sweep check
TALL_ROWS, TALL_FEATURES, TALL_BINS, TALL_DEPTH, TALL_LANES = 2_100_000, 28, 63, 8, 4


def tall_rows_phase(torch, hk, binning, dev):
    """The level histograms where a tile's rows split over several clusters
    (``LevelPlan.clusters``): TALL_ROWS x 28 at M = 1, levels 0-7, both
    tiers (``level_hist<2>`` over i32 bins, ``level_hist<3>`` over 8-bit
    lanes).  Each launch is held against its plain version: on dyadic
    statistics (every sum exact in any order) to 1e-5, on random ones at
    rtol 1e-5 and 1e-6 of the largest cell (tests/test_torch_hist_kernels.py's
    tolerances), with the plain version taken over blocks of rows and the
    blocks added in order, so that its own f32 error stays far below them.
    Two launches must give the same bits; a wide launch of TALL_LANES
    one-member lanes must equal each lane's own launch bit for bit;
    ``LEVEL_SPLITS`` must count exactly the launches whose plan has more
    than one cluster, levels 0-5 of the packed tier among them.  Each
    launch is timed (CUDA events, median of 5 runs of 10 calls) beside its
    plan -> the phase's JSON row; raises on a failed check."""
    rng = np.random.RandomState(21)
    n, d, B = TALL_ROWS, TALL_FEATURES, TALL_BINS
    bits = binning.pack_width(B)
    ids = torch.as_tensor(rng.randint(0, B, size=(n, d)).astype(np.int32), device=dev)
    packed = binning.pack_bins(ids, B, bits).packed

    def values(M, dyadic):
        if dyadic:
            v = rng.randint(-8, 9, size=(n, M, 2)) / 4.0
        else:
            v = np.concatenate([rng.rand(n, M, 1), rng.randn(n, M, 1)], axis=2)
        v = v.astype(np.float32)
        v[: n // 8] = 0.0  # zero-weight rows
        return torch.as_tensor(v, device=dev)

    def plain_blocked(node, vals, n_nodes, nterms, block=1 << 17):
        """hist_plain over blocks of rows, the blocks' histograms added in
        order: one launch of index_add_ adds a cell's ~3e4 rows (level 0)
        one after another, which alone could drift past rtol 1e-5."""
        return sum(hk.hist_plain(ids[i:i + block], node[i:i + block], vals[i:i + block],
                                 n_nodes, B, nterms) for i in range(0, n, block))

    reps, runs = 10, 5  # a timing's calls: one warm, then runs of reps

    tiers = {
        "hist_i32": (2, 32, lambda node, vals, n_nodes, lanes=1: hk.hist_level_pallas(
            ids, node, vals, n_nodes=n_nodes, max_bins=B, lanes=lanes)),
        "hist_packed": (3, bits, lambda node, vals, n_nodes, lanes=1: hk.hist_level_packed(
            packed, node, vals, n_nodes=n_nodes, max_bins=B, bits=bits, num_features=d,
            lanes=lanes)),
    }
    shipped = (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES)  # the wrappers' knobs when given none
    rows, problems = [], []
    want_splits = {k: 0 for k in tiers}
    hk.reset_launch_counts()
    for lv in range(TALL_DEPTH):
        n_nodes = 2**lv
        node = torch.as_tensor(rng.randint(0, n_nodes, size=(n, 1)).astype(np.int32), device=dev)
        for kernel, (nterms, kbits, run) in tiers.items():
            plan = hk.level_plan(n, d, 1, 2, B, n_nodes, kbits, shipped)
            row = {"kernel": kernel, "level": lv, "plan": plan._asdict()}
            for dyadic in (True, False):
                vals = values(1, dyadic)
                got = run(node, vals, n_nodes)
                if dyadic:
                    ref = hk.hist_plain(ids, node, vals, n_nodes, B, nterms)
                    ok = torch.allclose(got, ref, rtol=0, atol=1e-5)
                else:
                    ref = plain_blocked(node, vals, n_nodes, nterms)
                    ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
                err = float((got - ref).abs().max())
                row["max_abs_err_dyadic" if dyadic else "max_abs_err"] = err
                if not ok:
                    problems.append(f"{kernel} level {lv} dyadic={dyadic}: max abs err {err}")
                if not torch.equal(got, run(node, vals, n_nodes)):
                    problems.append(f"{kernel} level {lv} dyadic={dyadic}: two launches differ")
                want_splits[kernel] += 2 * (plan.clusters > 1)
            row["ms"] = _events_ms(torch, lambda: run(node, vals, n_nodes), reps, runs)
            want_splits[kernel] += (1 + reps * runs) * (plan.clusters > 1)
            rows.append(row)
    # each one-member lane of a wide launch sums its rows as its own launch
    lanes_ok = {}
    for lv in (0, 4, 5):
        n_nodes = 2**lv
        node = torch.as_tensor(rng.randint(0, n_nodes, size=(n, TALL_LANES)).astype(np.int32),
                               device=dev)
        vals = values(TALL_LANES, False)
        for kernel, (nterms, kbits, run) in tiers.items():
            wide = run(node, vals, n_nodes, TALL_LANES)
            plan = hk.lane_level_plan(n, d, TALL_LANES, 2, B, n_nodes, kbits, TALL_LANES, shipped)
            same = all(torch.equal(wide[s], run(node[:, s:s + 1].contiguous(),
                                                vals[:, s:s + 1].contiguous(), n_nodes)[0])
                       for s in range(TALL_LANES))
            lanes_ok[f"{kernel}@{lv}"] = {"equal": same, "clusters": plan.clusters}
            want_splits[kernel] += (1 + TALL_LANES) * (plan.clusters > 1)
            if not same or plan.clusters < 2:
                problems.append(f"{kernel} level {lv}: lanes {lanes_ok[f'{kernel}@{lv}']}")
    torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- a check reads the counters after every launch ran
    splits = dict(hk.LEVEL_SPLITS)
    packed_split = [r["level"] for r in rows
                    if r["kernel"] == "hist_packed" and r["plan"]["clusters"] > 1]
    if splits != want_splits or packed_split != list(range(6)):
        problems.append(f"LEVEL_SPLITS {splits}, expected {want_splits}; "
                        f"packed levels split {packed_split}")
    out = {"phase": "tall_rows", "n": n, "d": d, "B": B, "bits": bits, "levels": rows,
           "lanes": lanes_ok, "level_splits": splits, "problems": problems}
    emit(out)
    if problems:
        raise AssertionError(f"tall_rows: {problems}")
    return out


#: the wide-row kernels: Epsilon's shape (2,000 features, 63 bins in 8-bit
#: lanes, so 500 words a row; one tree, C = 2, 256 leaves from 128
#: parents), and the leaf pass's other widths: 31 words (adult's) and
#: 112-113 (the widest rows the pass took while it staged whole rows, and
#: one word past them)
WIDE_ROWS, WIDE_FEATURES, WIDE_BINS, WIDE_LEAF_WORDS = 400_000, 2_000, 63, (31, 112, 113)


def wide_rows_phase(torch, hk, binning, dev):
    """The kernels on wide packed rows: the routed leaf pass at 500 words a
    row and at WIDE_LEAF_WORDS, ``route_packed`` and ``level_hist<3>``
    (levels 0 and 7) at WIDE_ROWS x WIDE_FEATURES.  Each launch is held
    against its plain version on the card: routes and leaf ids exactly;
    sums on dyadic statistics (exact in any order) to 1e-5, on random ones
    at rtol 1e-5 and 1e-5 (leaf) or 1e-6 (histogram) of the largest cell.
    Two launches must give the same bits, and ``LEAF_GATHERS`` must count
    exactly the routed leaf launches (each gathers one word a row).
    Each launch is timed (CUDA events, median of 5 runs of 10 calls)
    beside its plan -> the phase's JSON row; raises on a failed check."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    n, B, leaves = WIDE_ROWS, WIDE_BINS, 256
    half = leaves // 2
    bits = binning.pack_width(B)
    per_word = 32 // bits

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def values(dyadic):
        if dyadic:
            v = (torch.randint(-8, 9, (n, 1, 2), generator=gen, device=dev) / 4.0).float()
        else:
            v = torch.stack([torch.rand((n, 1), generator=gen, device=dev),
                             torch.randn((n, 1), generator=gen, device=dev)], dim=2)
        v[: n // 8] = 0.0  # zero-weight rows
        return v.contiguous()

    problems, rows = [], []
    gathered = 0
    hk.reset_launch_counts()

    def held(kernel, what, got, ref, rtol, exact=False):
        if exact:
            ok = torch.equal(got, ref)
            err = 0.0 if ok else float((got.long() - ref.long()).abs().max())
        else:
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, rtol=rtol, atol=rtol * float(ref.abs().max())))
        if not ok:
            problems.append(f"{kernel} {what}: max abs err {err}")
        return err

    def twice(kernel, what, fn):
        a, b = fn(), fn()
        pair = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(torch.equal(x, y) for x, y in pair):
            problems.append(f"{kernel} {what}: two launches differ")

    for W in (WIDE_FEATURES // per_word,) + WIDE_LEAF_WORDS:
        d = WIDE_FEATURES if W == WIDE_FEATURES // per_word else W * per_word
        ids = randint(B, (n, d))
        packed = binning.pack_bins(ids, B, bits).packed
        parent = randint(half, (n, 1))
        bf, bt = randint(d, (1, half)), randint(B, (1, half))
        ref_node = hk.route_plain(ids, parent, bf, bt)
        plan = hk.leaf_plan(n, 1, 2, leaves, half)
        row = {"kernel": "leaf_sums", "W": W, "d": d, "plan": plan._asdict()}
        for dyadic in (True, False):
            vals = values(dyadic)

            def leaf():
                return hk.fused_round_level(packed, parent, vals, bf, bt, n_nodes=leaves,
                                            max_bins=B, bits=bits, num_features=d, leaf=True)

            L, node_out = leaf()
            what = f"W={W} dyadic={dyadic}"
            held("leaf_sums", what, node_out, ref_node, 0, exact=True)
            row["max_abs_err_dyadic" if dyadic else "max_abs_err"] = held(
                "leaf_sums", what, L, hk.leaf_plain(ref_node, vals, leaves), 0 if dyadic else 1e-5)
            twice("leaf_sums", what, leaf)
            gathered += 3
        row["ms"] = _events_ms(torch, leaf)
        gathered += 1 + 10 * 5
        rows.append(row)
        if d != WIDE_FEATURES:
            continue

        def route():
            return hk.route_packed(packed, parent, bf, bt, bits=bits, num_features=d)

        held("route_packed", f"W={W}", route(), ref_node, 0, exact=True)
        twice("route_packed", f"W={W}", route)
        rows.append({"kernel": "route_packed", "W": W, "d": d,
                     "plan": hk.route_plan(n, 1, half, W)._asdict(), "ms": _events_ms(torch, route)})
        for lv in (0, 7):
            n_nodes = 2**lv
            node = randint(n_nodes, (n, 1))
            row = {"kernel": "hist_packed", "W": W, "d": d, "level": lv,
                   "plan": hk.level_plan(n, d, 1, 2, B, n_nodes, bits,
                                         (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES))._asdict()}
            for dyadic in (True, False):
                vals = values(dyadic)

                def hist():
                    return hk.hist_level_packed(packed, node, vals, n_nodes=n_nodes, max_bins=B,
                                                bits=bits, num_features=d)

                block = 1 << 14  # the plain version's index tensor: 0.5 GB a block
                ref = sum(hk.hist_plain(ids[i:i + block], node[i:i + block], vals[i:i + block],
                                        n_nodes, B, 3) for i in range(0, n, block))
                what = f"level {lv} dyadic={dyadic}"
                row["max_abs_err_dyadic" if dyadic else "max_abs_err"] = held(
                    "hist_packed", what, hist(), ref, 0 if dyadic else 1e-5)
                del ref
                twice("hist_packed", what, hist)
            row["ms"] = _events_ms(torch, hist)
            rows.append(row)
        del ids
    torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- a check reads the counters after every launch ran
    counted = dict(hk.LEAF_GATHERS)
    if counted != {"leaf_sums": gathered}:
        problems.append(f"LEAF_GATHERS {counted}, expected {gathered}")
    out = {"phase": "wide_rows", "n": n, "B": B, "bits": bits, "kernels": rows,
           "leaf_gathers": counted, "problems": problems}
    emit(out)
    if problems:
        raise AssertionError(f"wide_rows: {problems}")
    return out


#: the row-list check: HIGGS's and Epsilon's full tables at level 7 (128
#: nodes, four node tiles of 32, one member, 63 bins in 8-bit lanes, C = 2),
#: and a skewed level 6 on HIGGS's width (90% of the rows in one node tile,
#: 5% routed to -1)
LIST_CASES = {"higgs_l7": (10_500_000, 28, 7), "epsilon_l7": (400_000, 2_000, 7),
              "skewed_l6": (2_100_000, 28, 6)}
LIST_BINS = 63
#: the lanes of the row-list lane check, at level 7 on LIST_LANE_ROWS rows,
#: each member with 10% of its rows out of the bag (-1): 28 features, where
#: the wide launch holds one member a CTA anyway, and 4, where it would hold
#: two unless its lanes walk lists
LIST_LANES, LIST_LANE_ROWS, LIST_LANE_FEATURES = 4, 1_000_003, (28, 4)


def row_lists_phase(torch, hk, binning, dev):
    """The compact level histograms (``LevelPlan.compact``): each node tile
    walks a list of its own rows, made on the card (``level_rows``).  For
    each of LIST_CASES: the card's lists and offsets equal the plain
    version's exactly (stable: every list in ascending row order); the
    packed tier's launch (``level_hist<3>``, and ``level_hist<2>`` over
    i32 bins in the skewed case) is held against ``hist_plain``, on dyadic
    statistics (exact in any order) to 1e-5 and on random ones at rtol
    1e-5 and 1e-6 of the largest cell, the plain version taken over blocks
    of rows added in order, with -1 rows given zero statistics at node 0
    there; two launches give the same bits; ``LEVEL_COMPACT`` counts
    exactly the compact launches.  A wide launch of LIST_LANES one-member
    lanes with out-of-bag rows equals each lane's own launch bit for bit
    (and ``hist_plain`` to the random tolerance), at LIST_LANE_FEATURES.
    The lists' two launches and the whole level (lists and histogram) are
    timed (CUDA events, median of 5 runs of 10 calls) -> the phase's JSON
    row; raises on a failed check."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    B = LIST_BINS
    bits = binning.pack_width(B)
    problems, rows = [], []
    want = {"hist_i32": 0, "hist_packed": 0}
    hk.reset_launch_counts()
    reps, runs = 10, 5
    for case, (n, d, lv) in LIST_CASES.items():
        n_nodes = 2**lv
        ids = torch.randint(0, B, (n, d), generator=gen, device=dev, dtype=torch.int32)
        packed = binning.pack_bins(ids, B, bits).packed
        node = torch.randint(0, n_nodes, (n, 1), generator=gen, device=dev, dtype=torch.int32)
        if case.startswith("skewed"):
            u = torch.rand((n, 1), generator=gen, device=dev)
            node = torch.where(u < 0.9, node % 32 + 32, node)  # tile 1 of 2
            node = torch.where(u > 0.95, torch.full_like(node, -1), node).contiguous()
        tiers = {"hist_packed": (3, bits, lambda vals: hk.hist_level_packed(
            packed, node, vals, n_nodes=n_nodes, max_bins=B, bits=bits, num_features=d))}
        if case.startswith("skewed"):
            tiers["hist_i32"] = (2, 32, lambda vals: hk.hist_level_pallas(
                ids, node, vals, n_nodes=n_nodes, max_bins=B))
        plan = hk.level_plan(n, d, 1, 2, B, n_nodes, bits, (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES))
        row = {"case": case, "n": n, "d": d, "level": lv, "plan": plan._asdict()}
        if not plan.compact:
            problems.append(f"{case}: plan not compact")
        got_rows, got_offs = hk.level_rows(node, n_nodes=n_nodes, nodes_per_tile=plan.np)
        ref_rows, ref_offs = hk.level_rows_plain(node, n_nodes, plan.np)
        if not (torch.equal(got_rows, ref_rows) and torch.equal(got_offs, ref_offs)):
            problems.append(f"{case}: row lists differ from the plain version")
        row["list_counts"] = torch.diff(got_offs).tolist()
        row["lists_ms"] = _events_ms(torch, lambda: hk.level_rows(
            node, n_nodes=n_nodes, nodes_per_tile=plan.np), reps, runs)
        keep = (node >= 0)[:, :, None]  # the plain version takes nodes in range only
        ref_node = node.clamp(min=0)
        block = max(1 << 12, (1 << 24) // d)  # the plain version's index tensor, ~0.5 GB a block
        for kernel, (nterms, kbits, run) in tiers.items():
            kplan = hk.level_plan(n, d, 1, 2, B, n_nodes, kbits, (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES))
            for dyadic in (True, False):
                if dyadic:
                    v = (torch.randint(-8, 9, (n, 1, 2), generator=gen, device=dev) / 4.0).float()
                else:
                    v = torch.stack([torch.rand((n, 1), generator=gen, device=dev),
                                     torch.randn((n, 1), generator=gen, device=dev)], dim=2)
                v[: n // 8] = 0.0  # zero-weight rows
                vals = v.contiguous()
                got = run(vals)
                kept = vals * keep
                ref = sum(hk.hist_plain(ids[i:i + block], ref_node[i:i + block],
                                        kept[i:i + block], n_nodes, B, nterms)
                          for i in range(0, n, block))
                err = float((got - ref).abs().max())
                tol = dict(rtol=0, atol=1e-5) if dyadic else dict(
                    rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
                if not torch.allclose(got, ref, **tol):
                    problems.append(f"{case} {kernel} dyadic={dyadic}: max abs err {err}")
                row[f"{kernel}_max_abs_err" + ("_dyadic" if dyadic else "")] = err
                if not torch.equal(got, run(vals)):
                    problems.append(f"{case} {kernel} dyadic={dyadic}: two launches differ")
                want[kernel] += 2 * kplan.compact
                del ref, kept
            row[f"{kernel}_ms"] = _events_ms(torch, lambda: run(vals), reps, runs)
            want[kernel] += (1 + reps * runs) * kplan.compact
        rows.append(row)
        del ids, packed
    # one-member lanes with out-of-bag rows: a wide launch of the lanes
    # equals each lane's own launch bit for bit, both walking lists
    lanes_ok = {}
    n, n_nodes = LIST_LANE_ROWS, 128
    for d in LIST_LANE_FEATURES:
        ids = torch.randint(0, B, (n, d), generator=gen, device=dev, dtype=torch.int32)
        packed = binning.pack_bins(ids, B, bits).packed
        node = torch.randint(0, n_nodes, (n, LIST_LANES), generator=gen, device=dev,
                             dtype=torch.int32)
        out_of_bag = torch.rand((n, LIST_LANES), generator=gen, device=dev) < 0.1
        node = node.masked_fill(out_of_bag, -1).contiguous()
        vals = torch.randn((n, LIST_LANES, 2), generator=gen, device=dev)

        def hist(nd, v, lanes=1):
            return hk.hist_level_packed(packed, nd, v, n_nodes=n_nodes, max_bins=B, bits=bits,
                                        num_features=d, lanes=lanes)

        wide = hist(node, vals, LIST_LANES)
        plan = hk.lane_level_plan(n, d, LIST_LANES, 2, B, n_nodes, bits, LIST_LANES,
                                  (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES))
        same = all(torch.equal(wide[s], hist(node[:, s:s + 1].contiguous(),
                                             vals[:, s:s + 1].contiguous())[0])
                   for s in range(LIST_LANES))
        ref = hk.hist_plain(ids, node.clamp(min=0), vals * (node >= 0)[:, :, None], n_nodes, B, 3)
        err = float((wide - ref).abs().max())
        close = bool(torch.allclose(wide, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max())))
        lanes_ok[f"d={d}"] = {"equal": same, "max_abs_err": err, "compact": plan.compact,
                              "g": plan.g}
        want["hist_packed"] += (1 + LIST_LANES) * plan.compact
        if not (same and close and plan.compact):
            problems.append(f"lanes d={d}: {lanes_ok[f'd={d}']}")
        del ids, packed, ref
    torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- a check reads the counters after every launch ran
    counted = dict(hk.LEVEL_COMPACT)
    if counted != want:
        problems.append(f"LEVEL_COMPACT {counted}, expected {want}")
    out = {"phase": "row_lists", "B": B, "bits": bits, "cases": rows, "lanes": lanes_ok,
           "level_compact": counted, "problems": problems}
    emit(out)
    if problems:
        raise AssertionError(f"row_lists: {problems}")
    return out


def _events_ms(torch, fn, reps=10, runs=5):
    """``fn``'s time a call in ms: one warm call, then the median of
    ``runs`` runs of ``reps`` calls between CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- closes a CUDA-event run: elapsed_time needs the end event done
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dyadic_regression_data(n=8192, d=12, seed=0):
    """Targets k/64 in mirrored pairs: their mean is exactly 0, and every
    f32 sum of them, and of the residuals from it, is exact in any order
    (the fused tier's 3-term bf16 statistics hold them exactly too), so a
    mesh fit's first round at a fixed step equals the unsharded one."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    half = (rng.randint(-256, 256, n // 2) / 64.0).astype(np.float32)
    y = np.concatenate([half, -half])[rng.permutation(n)]
    return X, y.astype(np.float32)


def _main_path_gbm(st, rounds):
    return st.GBMClassifier(
        num_base_learners=rounds, loss="logloss", updates="newton",
        learning_rate=0.3, optimized_weights=True,
        base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, max_bins=MAX_BINS,
                                              hist="fused"),
    )


def _mesh_fit(torch, hk, coll, est, X_, y_, mesh, device):
    """One mesh fit with its launches and the collectives' counts and time
    -> (model, seconds, launches, collective stats)."""
    hk.reset_launch_counts()
    coll.reset_collective_stats()
    coll.set_collective_timing(True)
    torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
    t0 = time.perf_counter()
    model = est.fit(X_, y_, mesh=mesh, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    coll.set_collective_timing(False)
    return model, secs, dict(hk.LAUNCHES), coll.collective_stats()


def distributed_rank(cfg):
    """One rank of a gloo group on ``cuda:0`` (``python3 chip_smoke.py
    --distributed-rank '<json>'``, started by :func:`distributed_phase`):
    the main path on ``data_member_mesh(world, member)``, and with
    ``extras`` a dyadic regressor's first round against its unmeshed fit,
    a BaggingRegressor and a SAMME BoostingClassifier on the same mesh.
    Writes its results as JSON to ``cfg["out"]``."""
    import datetime

    import torch
    import torch.distributed as dist

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.ops import collective as coll, hist_kernels as hk
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh

    rank, world = cfg["rank"], cfg["world"]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S // 2))
    mesh = pmesh.data_member_mesh(world, member=cfg["member"], device="cuda:0")
    coll.preduce(torch.zeros(1, device="cuda:0"), mesh.row_axis)  # the groups' first use
    hk.build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank, "world": world, "member": cfg["member"]}
    X_np, y_np = letter_data()
    model, secs, launches, stats = _mesh_fit(torch, hk, coll, _main_path_gbm(st, DIST_ROUNDS),
                                             X_np, y_np, mesh, "cuda:0")
    out["gbm"] = {
        "digests": pmesh.replica_digests(model), "fit_s": secs,
        "iters_per_s": DIST_ROUNDS / secs, "launches": launches,
        "accuracy": float((model.predict(X_np).cpu().numpy() == y_np).mean()),  # graftlint: ignore[unfenced-blocking-read] -- accuracy readback after the timed fit, outside its window
        "gathers_per_round": stats["gathers"] / DIST_ROUNDS,
        "bytes_per_round": stats["bytes"] / DIST_ROUNDS,
        "gather_ms_per_round": stats["ms"] / DIST_ROUNDS,
    }
    if cfg["extras"]:
        Xd, yd = dyadic_regression_data()
        reg = st.GBMRegressor(num_base_learners=1, loss="squared", optimized_weights=False,
                              base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, hist="fused"))
        meshed = reg.fit(Xd, yd, mesh=mesh, device="cuda:0")
        single = reg.fit(Xd, yd, device="cuda:0")
        out["dyadic_round"] = {
            "params_equal": pmesh.params_digest(meshed.params["members"])
            == pmesh.params_digest(single.params["members"]),
            "predict_equal": bool(torch.equal(meshed.predict(Xd), single.predict(Xd))),
            "digests": pmesh.replica_digests(meshed),
        }
        Xr, yr = regression_data()
        bag = st.BaggingRegressor(num_base_learners=10, subspace_ratio=0.5,
                                  base_learner=st.DecisionTreeRegressor(
                                      max_depth=DEPTH, max_bins=MAX_BINS, hist="fused"))
        bag_model = bag.fit(Xr, yr, mesh=mesh, device="cuda:0")
        out["bagging"] = {"digests": pmesh.replica_digests(bag_model)}
        boost = st.BoostingClassifier(num_base_learners=10, algorithm="discrete",
                                      base_learner=st.DecisionTreeClassifier(
                                          max_depth=DEPTH, max_bins=MAX_BINS, hist="fused"))
        boost_model = boost.fit(X_np, y_np, mesh=mesh, device="cuda:0")
        out["boosting"] = {
            "digests": pmesh.replica_digests(boost_model),
            "members": boost_model.num_members,
            "accuracy": float((boost_model.predict(X_np).cpu().numpy() == y_np).mean()),  # graftlint: ignore[unfenced-blocking-read] -- accuracy readback after the fit, outside any timed window
        }
    with open(cfg["out"], "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _run_group(flag, cfgs, timeout):
    """Start one rank of this script per config (``python3 chip_smoke.py
    <flag> '<json>'``) and wait for all; a rank that fails or outlives
    ``timeout`` fails the phase (the others are killed) -> each rank's
    results, read from its ``cfg["out"]``."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, json.dumps(cfg)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cfg in cfgs]
    deadline = time.time() + timeout
    logs = [None] * len(procs)
    while any(log is None for log in logs):
        for r, p in enumerate(procs):
            if logs[r] is None and p.poll() is not None:
                logs[r] = p.stdout.read()
        if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
            break
        time.sleep(0.2)
    for r, p in enumerate(procs):
        if logs[r] is None:
            p.kill()
            logs[r] = (p.communicate()[0] or "") + "\n[killed]"
    if any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{log[-2000:]}"
                          for r, (p, log) in enumerate(zip(procs, logs)))
        raise AssertionError(f"{flag}: a rank of {len(procs)} failed\n{tails}")
    results = []
    for cfg in cfgs:
        with open(cfg["out"]) as f:
            results.append(json.load(f))
    return results


def _run_ranks(world, member, extras, scratch):
    """The distributed phase's ``world`` ranks on the card -> each rank's
    results."""
    port = _free_port()
    return _run_group("--distributed-rank", [
        {"rank": rank, "world": world, "member": member, "extras": extras, "port": port,
         "out": os.path.join(scratch, f"dist_w{world}_r{rank}.json")}
        for rank in range(world)], DIST_TIMEOUT_S)


def distributed_phase(st, hk, X_np, y_np, scratch, per_fit, card):
    """The SPMD fits over ``torch.distributed``.  W=1: this process joins a
    one-rank NCCL group; the main path on ``data_member_mesh(1)`` must equal
    its unmeshed fit bit for bit with the same launches.  W=2 and W=4: that
    many ranks of this script on ``cuda:0`` over gloo (NCCL refuses two
    ranks on one card), rows halved or quartered per rank, the W=4 mesh
    with 2 member blocks; every rank's params must be bit-identical and
    the accuracy within 0.02 of one rank's."""
    import torch
    import torch.distributed as dist

    from spark_ensemble_tpu_torch.ops import collective as coll
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh, multihost

    t_phase = time.perf_counter()
    failures = []
    R = DIST_ROUNDS
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = _main_path_gbm(st, R).fit(X_np, y_np, device="cuda")
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_launches = dict(hk.LAUNCHES)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh1 = pmesh.data_member_mesh(1)
        # the NCCL communicator starts at its first collective: not a fit's
        coll.preduce(torch.zeros(1, device="cuda"), mesh1.row_axis)
        model1, secs1, launches1, stats1 = _mesh_fit(torch, hk, coll, _main_path_gbm(st, R),
                                                     X_np, y_np, mesh1, "cuda")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    acc1 = float((model1.predict(X_np).cpu().numpy() == y_np).mean())
    same = pmesh.params_digest(model1.params) == pmesh.params_digest(single.params)
    if not same:
        failures.append("W=1 mesh fit differs from the unmeshed fit")
    if launches1 != per_fit(R) or single_launches != per_fit(R):
        failures.append(f"W=1 launches {launches1} / unmeshed {single_launches} != {per_fit(R)}")
    w1 = {"world": 1, "backend": backend, "bit_identical_to_unmeshed": same,
          "launches": launches1, "accuracy": acc1, "fit_s": secs1, "iters_per_s": R / secs1,
          "unmeshed_iters_per_s": R / single_s,
          "gathers_per_round": stats1["gathers"] / R, "bytes_per_round": stats1["bytes"] / R,
          "gather_ms_per_round": stats1["ms"] / R}
    emit({"phase": "distributed", **w1, **card})
    rows = {}
    for world, member, extras in ((2, 1, True), (4, 2, False)):
        res = _run_ranks(world, member, extras, scratch)
        g = [r["gbm"] for r in res]
        digests = {d for r in g for d in r["digests"]}
        accs = [r["accuracy"] for r in g]
        row = {"world": world, "member": member, "backend": "gloo",
               "digests_equal": len(digests) == 1, "accuracy": accs[0],
               "accuracy_gap_to_w1": accs[0] - acc1,
               "iters_per_s": [r["iters_per_s"] for r in g],
               "launches_rank0": g[0]["launches"],
               "gathers_per_round": g[0]["gathers_per_round"],
               "bytes_per_round": g[0]["bytes_per_round"],
               "gather_ms_per_round": [r["gather_ms_per_round"] for r in g]}
        if len(digests) != 1:
            failures.append(f"W={world}: the ranks' params differ")
        if abs(accs[0] - acc1) > 0.02:
            failures.append(f"W={world}: accuracy {accs[0]} vs {acc1} at W=1")
        if extras:
            dy = [r["dyadic_round"] for r in res]
            row["dyadic_round_bit_identical"] = all(d["params_equal"] and d["predict_equal"]
                                                    for d in dy)
            row["dyadic_digests_equal"] = len({x for d in dy for x in d["digests"]}) == 1
            row["bagging_digests_equal"] = len({x for r in res
                                                for x in r["bagging"]["digests"]}) == 1
            row["boosting_digests_equal"] = len({x for r in res
                                                 for x in r["boosting"]["digests"]}) == 1
            row["boosting_members"] = res[0]["boosting"]["members"]
            row["boosting_accuracy"] = res[0]["boosting"]["accuracy"]
            for k in ("dyadic_round_bit_identical", "dyadic_digests_equal",
                      "bagging_digests_equal", "boosting_digests_equal"):
                if not row[k]:
                    failures.append(f"W={world}: {k} is false")
        rows[world] = row
        emit({"phase": "distributed", **row, **card})
    emit({"phase": "distributed_summary", "failures": failures,
          "iters_per_s": {"unmeshed": R / single_s, "w1": R / secs1,
                          "w2": rows[2]["iters_per_s"], "w4": rows[4]["iters_per_s"]},
          "phase_s": time.perf_counter() - t_phase, **card})
    if failures:
        raise AssertionError(f"distributed: {failures}")


#: the elastic phase: the time a rank group may take, the host preemption
#: of its rewind (round 1, level 2, the second of 3 steps over 8 shards),
#: and the preemption after a checkpoint of its checkpointed mesh fits
ELASTIC_TIMEOUT_S = 240
ELASTIC_SITE = "GBMClassifier:stream_round:1:level:2:dist_step:1"
ELASTIC_VICTIM = 1


def _xl_stream_gbm(st, rounds, **kw):
    """The streaming phase's XL classifier: logloss, a depth-5, 64-bin
    ``hist="stream"`` base."""
    return st.GBMClassifier(num_base_learners=rounds, loss="logloss", updates="newton",
                            learning_rate=0.3,
                            base_learner=st.DecisionTreeRegressor(hist="stream"), **kw)


def _fault_at(chaos_mod, fault, site, victim=0):
    """A chaos controller that fires ``fault`` at ``site`` only, picking
    rank ``victim`` where the fault picks one (every other draw misses)."""
    class FaultAt(chaos_mod.ChaosController):
        def _draw(self, f, s):
            return 0.0 if (f, s) == (fault, site) else 1.0

        def pick(self, f, s, n):
            return victim % n

    return FaultAt(seed=0, rate=0.5, faults=(fault,))


def _counted(base, fits):
    """``base`` with its ``fit`` appending the learner's name to ``fits``."""
    real = base.fit

    def fit(*a, **k):
        fits.append(type(base).__name__)
        return real(*a, **k)

    object.__setattr__(base, "fit", fit)
    return base


def elastic_rank(cfg):
    """One rank of a gloo group on ``cuda:0`` for the elastic phase
    (``python3 chip_smoke.py --elastic-rank '<json>'``), by ``cfg["job"]``:
    ``sweep`` (the XL streaming fit over the mesh), ``rewind`` (an
    ElasticCoordinator fit that loses rank 1) or ``planes`` (checkpointed
    mesh fits, Stacking, the sharded sweep and a CrossValidator over the
    mesh).  Writes its results as JSON to ``cfg["out"]``."""
    import datetime

    import torch
    import torch.distributed as dist

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.data import ShardStore
    from spark_ensemble_tpu_torch.data import streaming as streaming_mod
    from spark_ensemble_tpu_torch.ops import collective as coll, hist_kernels as hk
    from spark_ensemble_tpu_torch.parallel import elastic, mesh as pmesh
    from spark_ensemble_tpu_torch.robustness import chaos as chaos_mod
    from spark_ensemble_tpu_torch.telemetry import global_metrics, record_fits

    rank, world, job = cfg["rank"], cfg["world"], cfg["job"]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=ELASTIC_TIMEOUT_S // 2))
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.data_member_mesh(world, device="cuda:0")
    coll.preduce(torch.zeros(1, device="cuda:0"), mesh.row_axis)  # the groups' first use
    digest = pmesh.params_digest
    R = STREAM_FIT_ROUNDS
    out = {"rank": rank, "world": world, "job": job}
    if job == "sweep":
        # manifest only: each rank hash-verifies just its own shards
        store = ShardStore.open(cfg["store"], shards=[])
        y = np.load(cfg["labels"])
        loads = global_metrics().counter("data/shard_loads")
        loads0 = loads.value
        hk.reset_launch_counts()
        coll.reset_collective_stats()
        coll.set_collective_timing(True)
        # the sweep's measure mode: a fence around every per-step reduce
        os.environ["SE_TPU_DIST_MEASURE"] = "1"
        # each rank's telemetry stream: the operator phase's skew report
        tel = os.path.join(cfg["scratch"], f"elastic_sweep_tel_r{rank}")
        os.makedirs(tel, exist_ok=True)
        est = _xl_stream_gbm(st, R, telemetry_path=os.path.join(tel, "t.jsonl"))
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
        t0 = time.perf_counter()
        model = est.fit_streaming(store, y, mesh=mesh, device="cuda:0")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del os.environ["SE_TPU_DIST_MEASURE"]
        coll.set_collective_timing(False)
        stats = coll.collective_stats()
        sweep = elastic.last_fit_stats()
        # a round's passes: one a level and the leaf pass, K steps each
        passes = R * (int(est.base_learner.max_depth) + 1)
        out.update(digest=digest(model.params), fit_s=secs, iters_per_s=R / secs,
                   gathers_per_round=stats["gathers"] / R, bytes_per_round=stats["bytes"] / R,
                   gather_ms_per_round=stats["ms"] / R, loads=loads.value - loads0,
                   launches=dict(hk.LAUNCHES), steps=sweep["steps"],
                   expected_steps=passes * -(-store.num_shards // world),
                   sweep_ms_per_pass=1e3 * sweep["sweep_s"] / passes,
                   reduce_ms_per_pass=1e3 * sweep["reduce_s"] / passes)
    elif job == "rewind":
        store = ShardStore.open(cfg["store"], shards=[])
        y = np.load(cfg["labels"])[:store.n]
        tel = os.path.join(cfg["scratch"], f"elastic_tel_r{rank}")
        os.makedirs(tel, exist_ok=True)
        ends = []
        real_end = streaming_mod._ShardTrees.end_round

        def end_round(self, r):
            ends.append(time.perf_counter())
            return real_end(self, r)

        streaming_mod._ShardTrees.end_round = end_round
        chaos_mod.install(_fault_at(chaos_mod, "host_preempt", ELASTIC_SITE, ELASTIC_VICTIM))
        coord = elastic.ElasticCoordinator(mesh)
        est = _xl_stream_gbm(st, R, checkpoint_interval=1,
                             checkpoint_dir=os.path.join(cfg["scratch"], f"elastic_ck_r{rank}"),
                             telemetry_path=os.path.join(tel, "t.jsonl"))
        try:
            model = coord.fit_streaming(est, store, y, device="cuda:0")
            verdict = coord.verdicts[0]
            out.update(victim=False, digest=digest(model.params), losses=coord.losses,
                       width=pmesh.mesh_sizes(coord.mesh)[0], attempts=coord.attempts,
                       resume_s=min(t for t in ends if t > verdict) - verdict)
        except chaos_mod.ChaosHostPreemption:
            out["victim"] = True
        finally:
            chaos_mod.install(None)
            streaming_mod._ShardTrees.end_round = real_end
        out["flight_dump"] = os.path.exists(os.path.join(tel, f"flight_p{os.getpid()}.json"))
        with open(cfg["out"], "w") as f:
            json.dump(out, f)
        # the survivors' groups exclude the victim: no collective on the
        # old group after the verdict, so no barrier here
        dist.destroy_process_group()
        return 0
    else:  # planes
        hk.build_kernels()
        X_np, y_np = letter_data()
        ck = lambda name: os.path.join(cfg["scratch"], f"elastic_{name}_r{rank}")

        def resumed_fit(family, make, X_, y_, at, rounds):
            """The uninterrupted mesh fit, then a checkpointed one killed
            after round ``at`` and refitted -> the check's line."""
            torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
            t0 = time.perf_counter()
            ref = make(rounds).fit(X_, y_, mesh=mesh, device="cuda:0")
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            est = make(rounds).copy(checkpoint_dir=ck(family), checkpoint_interval=5)
            # chunks of 2 rounds (clamped to the saves), so the kill after
            # round ``at`` lands between two checkpoints
            label = type(est).__name__
            chaos_mod.install(_fault_at(chaos_mod, "preempt", f"{label}:after_round:{at}"))
            try:
                est.fit(X_, y_, mesh=mesh, device="cuda:0")
                fired = False
            except chaos_mod.ChaosPreemption:
                fired = True
            finally:
                chaos_mod.install(None)
            hk.reset_launch_counts()
            with record_fits() as rec:
                resumed = est.fit(X_, y_, mesh=mesh, device="cuda:0")
            return {"fired": fired, "equal": digest(resumed.params) == digest(ref.params),
                    "digests": pmesh.replica_digests(resumed), "rounds": rounds,
                    "preempted_after_round": at, "uninterrupted_fit_s": ref_s,
                    "resumed_at": [e["round"] for e in rec.events
                                   if e["event"] == "resume_from_checkpoint"],
                    "resume_launches": dict(hk.LAUNCHES)}

        cls_tree = lambda: st.DecisionTreeClassifier(max_depth=DEPTH, max_bins=MAX_BINS,
                                                     hist="fused")
        out["gbm"] = resumed_fit("gbm", lambda r: _main_path_gbm(st, r).copy(scan_chunk=2),
                                 X_np, y_np, 12, DIST_ROUNDS)
        out["samme"] = resumed_fit(
            "samme", lambda r: st.BoostingClassifier(num_base_learners=r, algorithm="discrete",
                                                     base_learner=cls_tree(), scan_chunk=2),
            X_np, y_np, 7, 10)
        # Stacking: bench.py's members with the fused DT, member i on rank i mod W
        Xa, ya = adult_data()
        fits = []
        stack = lambda counted: st.StackingClassifier(
            base_learners=[_counted(b, fits) if counted else b for b in
                           (cls_tree(), st.LogisticRegression(), st.GaussianNaiveBayes())],
            stacker=st.LogisticRegression(), stack_method="proba")
        meshed = stack(True).fit(Xa, ya, mesh=mesh, device="cuda:0")
        single = stack(False).fit(Xa, ya, device="cuda:0")
        out["stacking"] = {
            "fits": fits,
            "digest": digest([m.params for m in meshed.base_models]
                             + [meshed.stack_model.params]),
            "proba_max_abs_diff_to_single": float(
                (meshed.predict_proba(Xa) - single.predict_proba(Xa)).abs().max()),
        }
        # the tuning phase's 12 candidates, swept with the lanes over
        # member=2 and whole, lane by lane
        from spark_ensemble_tpu_torch.models.gbm_sweep import fit_sweep
        from spark_ensemble_tpu_torch.tuning import _kfold_indices

        est = st.GBMClassifier(num_base_learners=PARITY_ROUNDS, loss="logloss",
                               updates="newton", learning_rate=0.3,
                               base_learner=st.DecisionTreeRegressor(
                                   max_depth=DEPTH, max_bins=MAX_BINS, hist="fused"))
        grid = (st.ParamGridBuilder().add_grid("learning_rate", [0.1, 0.3])
                .add_grid("subsample_ratio", [1.0, 0.8]).build())
        folds = _kfold_indices(len(y_np), 3, 0)
        lanes = [est.copy(**pmap) for _ in folds for pmap in grid]
        wts = [np.where(fold, 0.0, 1.0).astype(np.float32) for fold in folds for _ in grid]
        member_mesh = pmesh.data_member_mesh(world, member=world, device="cuda:0")
        times = {}
        for name, m in (("whole", None), ("sharded", member_mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw = {} if m is None else {"mesh": m}
            times[name] = (fit_sweep(lanes, X_np, y_np, sample_weights=wts, num_classes=N_CLASSES,
                                     device="cuda:0", **kw), time.perf_counter() - t0)
        whole, sharded = times["whole"][0], times["sharded"][0]
        equal = [digest(a.params) == digest(b.params) for a, b in zip(whole, sharded)]
        Xq = torch.as_tensor(X_np, device="cuda:0")
        gap = max(float((a.predict_proba(Xq) - b.predict_proba(Xq)).abs().max())
                  for a, b in zip(whole, sharded))
        out["sweep"] = {"lanes": len(lanes), "lanes_equal": equal, "proba_max_abs_diff": gap,
                        "whole_fit_s": times["whole"][1], "sharded_fit_s": times["sharded"][1]}
        # a 2-map x 2-fold CrossValidator over the mesh, 10 rounds a fit
        cv = st.CrossValidator(estimator=_main_path_gbm(st, 10),
                               estimator_param_maps=st.ParamGridBuilder().add_grid(
                                   "learning_rate", [0.1, 0.3]).build(),
                               evaluator=st.MulticlassClassificationEvaluator(), num_folds=2,
                               seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv_model = cv.fit(X_np, y_np, mesh=mesh, device="cuda:0")
        torch.cuda.synchronize()
        unmeshed = cv.fit(X_np, y_np, device="cuda:0")
        out["cross_validator"] = {"fit_s": time.perf_counter() - t0,
                                  "avg_metrics": cv_model.avg_metrics,
                                  "unmeshed_avg_metrics": unmeshed.avg_metrics,
                                  "best_index": cv_model.best_index,
                                  "unmeshed_best_index": unmeshed.best_index,
                                  "digests": pmesh.replica_digests(cv_model.best_model)}
    with open(cfg["out"], "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


#: the stitched rewind's clock offsets: its ranks share one host clock
POD_OFFSET_LIMIT_S = 0.010


def pod_stitch(scratch, card, failures):
    """The operator plane's pod view over the elastic phase's streams: the
    rewind's three per-rank streams stitched into one pod trace (the
    victim's ``host_preempt`` flow must resolve into both survivors'
    ``rewind``, every estimated clock offset must lie within
    ``POD_OFFSET_LIMIT_S`` of 0, no span may lose its parent, the manifest
    digests must agree), and a skew report over the XL sweep's two ranks."""
    from spark_ensemble_tpu_torch.telemetry import podview

    t0 = time.perf_counter()
    paths = [os.path.join(scratch, f"elastic_tel_r{r}", "t.jsonl") for r in range(3)]
    merged, info = podview.stitch_files(paths)
    spans = [e for e in merged if e.get("event") == "span"]
    ids = {s["span_id"] for s in spans}
    sources = {f for s in spans for f in (s.get("flow_out") or [])}
    pre = [s for s in spans if s.get("name") == "host_preempt"]
    rew = [s for s in spans if s.get("name") == "rewind"]
    alone = [e for e in podview.load_stream(paths[0]) if e.get("event") == "span"]
    alone_sources = {f for s in alone for f in (s.get("flow_out") or [])}
    skew = podview.skew_report([podview.load_stream(
        os.path.join(scratch, f"elastic_sweep_tel_r{r}", "t.jsonl")) for r in range(2)])
    row = {"check": "pod_stitch", "streams": info["streams"], "hosts": info["hosts"],
           "groups": info["groups"], "offsets_s": info["offsets"],
           "digest_mismatches": info["digest_mismatches"], "spans": len(spans),
           "preempt_hosts": [s["host"] for s in pre],
           "rewind_hosts_resolved": sorted(s["host"] for s in rew if s.get("flow_in") in sources),
           "resolved_in_one_stream": any(s.get("name") == "rewind" and s.get("flow_in") in alone_sources
                                         for s in alone),
           "orphans": [s["name"] for s in spans
                       if s.get("parent_id") and s["parent_id"] not in ids][:5],
           "sweep_skew": {k: skew[k] for k in ("hosts", "pod_skew_ratio", "persistent_offender",
                                               "per_host")},
           "sweep_skew_rounds": [{k: r[k] for k in ("round", "ratio", "offender")}
                                 for r in skew["rounds"]],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "operator", **row, **card})
    survivors = [r for r in range(3) if r != ELASTIC_VICTIM]
    if (row["preempt_hosts"] != [ELASTIC_VICTIM] or row["rewind_hosts_resolved"] != survivors
            or row["resolved_in_one_stream"] or row["orphans"] or row["digest_mismatches"]
            or info["hosts"] != [0, 1, 2]
            or any(abs(o) > POD_OFFSET_LIMIT_S for o in info["offsets"])
            or skew["hosts"] != [0, 1] or len(skew["rounds"]) != STREAM_FIT_ROUNDS):
        failures.append("pod_stitch: see the operator line above")


def elastic_phase(scratch, xl, card):
    """The elastic shard sweep and the rest of the mesh planes, each group
    of ranks of this script joining a gloo group on ``cuda:0`` (NCCL
    refuses two ranks on one card).  ``sweep``: 2 ranks stream the XL store
    over ``data_member_mesh(2)``; every rank's params must equal the
    single-process streaming fit's bit for bit.  ``rewind``: 3 ranks run an
    ElasticCoordinator fit over the first STREAM_CHECK_ROWS XL rows with a
    checkpoint a round; a host_preempt in round 1 takes rank 1, and the
    survivors' params must equal the single-process fit's, on a mesh 2
    wide, with the victim's flight dump on disk.  ``planes``: 2 ranks
    checkpoint, kill and resume the main path and SAMME (equal to the
    uninterrupted mesh fits), stack with each member on one rank (proba
    within 2e-3 of one process), sweep the tuning phase's 12 candidates
    with the lanes over member=2 (each lane equal to the whole sweep's)
    and cross-validate over the mesh (each candidate's mean score within
    0.01 of the unmeshed search's, and the same best candidate)."""
    t_phase = time.perf_counter()
    failures = []

    def group(job, world, **extra):
        port = _free_port()
        return _run_group("--elastic-rank", [
            {"rank": r, "world": world, "job": job, "port": port, "scratch": scratch,
             "out": os.path.join(scratch, f"elastic_{job}_r{r}.json"), **extra}
            for r in range(world)], ELASTIC_TIMEOUT_S)

    t0 = time.perf_counter()
    res = group("sweep", 2, store=xl["store"], labels=xl["labels"])
    row = {"check": "distributed_shard_sweep", "world": 2, "n": XL_ROWS, "d": XL_FEATURES,
           "classes": XL_CLASSES, "rounds": STREAM_FIT_ROUNDS,
           "bit_identical_to_single": [r["digest"] == xl["digest"] for r in res],
           "iters_per_s": [r["iters_per_s"] for r in res],
           "gathers_per_round": res[0]["gathers_per_round"],
           "bytes_per_round": res[0]["bytes_per_round"],
           "gather_ms_per_round": [r["gather_ms_per_round"] for r in res],
           "reduce_ms_per_pass": [r["reduce_ms_per_pass"] for r in res],
           "sweep_ms_per_pass": [r["sweep_ms_per_pass"] for r in res],
           "steps": [r["steps"] for r in res], "expected_steps": res[0]["expected_steps"],
           "loads": [r["loads"] for r in res], "launches_rank0": res[0]["launches"],
           "group_s": time.perf_counter() - t0}
    emit({"phase": "elastic", **row, **card})
    if not all(row["bit_identical_to_single"]):
        failures.append("sweep: a rank's params differ from the single-process fit")
    if (any(s != row["expected_steps"] for s in row["steps"])
            or not all(0 < r <= s for r, s in zip(row["reduce_ms_per_pass"],
                                                  row["sweep_ms_per_pass"]))):
        failures.append("sweep: the measure mode's steps or reduce times are off")
    t0 = time.perf_counter()
    res = group("rewind", 3, store=xl["rewind_store"], labels=xl["labels"])
    surv = [r for r in res if not r["victim"]]
    row = {"check": "elastic_rewind", "world": 3, "n": STREAM_CHECK_ROWS, "site": ELASTIC_SITE,
           "victims": [r["rank"] for r in res if r["victim"]],
           "losses": [r["losses"] for r in surv], "widths": [r["width"] for r in surv],
           "attempts": [r["attempts"] for r in surv],
           "bit_identical_to_single": [r["digest"] == xl["rewind_digest"] for r in surv],
           "victim_flight_dump": [r["flight_dump"] for r in res if r["victim"]],
           "verdict_to_resumed_round_s": [r["resume_s"] for r in surv],
           "group_s": time.perf_counter() - t0}
    emit({"phase": "elastic", **row, **card})
    if (row["victims"] != [ELASTIC_VICTIM] or len(surv) != 2
            or not all(row["bit_identical_to_single"]) or row["widths"] != [2, 2]
            or any(lo[0][0] != ELASTIC_VICTIM for lo in row["losses"])
            or row["victim_flight_dump"] != [True]):
        failures.append("rewind: see the line above")
    pod_stitch(scratch, card, failures)
    t0 = time.perf_counter()
    res = group("planes", 2)
    for key in ("gbm", "samme"):
        rows = [r[key] for r in res]
        line = {"check": f"checkpoint_resume_{key}", "world": 2,
                **{k: rows[0][k] for k in ("rounds", "preempted_after_round", "resumed_at",
                                           "uninterrupted_fit_s", "resume_launches")},
                "fired": [x["fired"] for x in rows],
                "bit_identical": [x["equal"] for x in rows],
                "digests_equal": len({d for x in rows for d in x["digests"]}) == 1}
        emit({"phase": "elastic", **line, **card})
        if not (all(line["fired"]) and all(line["bit_identical"]) and line["digests_equal"]
                and line["resumed_at"]):
            failures.append(f"{key}: the resumed mesh fit differs or did not resume")
    stk = [r["stacking"] for r in res]
    line = {"check": "stacking", "world": 2, "fits": [x["fits"] for x in stk],
            "digests_equal": len({x["digest"] for x in stk}) == 1,
            "proba_max_abs_diff_to_single": [x["proba_max_abs_diff_to_single"] for x in stk]}
    emit({"phase": "elastic", **line, **card})
    owners = sorted(f for x in stk for f in x["fits"])
    if (owners != sorted(["DecisionTreeClassifier", "LogisticRegression",
                          "GaussianNaiveBayes"]) or not line["digests_equal"]
            or max(line["proba_max_abs_diff_to_single"]) > 2e-3):
        failures.append("stacking: see the line above")
    sw = [r["sweep"] for r in res]
    identical = all(all(x["lanes_equal"]) for x in sw)
    line = {"check": "sharded_sweep", "world": 2, "member": 2, "lanes": sw[0]["lanes"],
            "held_to": "bit_identical" if identical else "proba_within_1e-5",
            "lanes_equal": [sum(x["lanes_equal"]) for x in sw],
            "proba_max_abs_diff": [x["proba_max_abs_diff"] for x in sw],
            "whole_fit_s": [x["whole_fit_s"] for x in sw],
            "sharded_fit_s": [x["sharded_fit_s"] for x in sw]}
    emit({"phase": "elastic", **line, **card})
    if not identical and max(line["proba_max_abs_diff"]) > 1e-5:
        failures.append("sharded sweep: a lane parts from the whole sweep's")
    cvs = [r["cross_validator"] for r in res]
    line = {"check": "cross_validator", "world": 2, "maps": 2, "folds": 2, "rounds": 10,
            "fit_s": [x["fit_s"] for x in cvs], "avg_metrics": cvs[0]["avg_metrics"],
            "unmeshed_avg_metrics": cvs[0]["unmeshed_avg_metrics"],
            "best_index": cvs[0]["best_index"],
            "unmeshed_best_index": cvs[0]["unmeshed_best_index"],
            "digests_equal": len({d for x in cvs for d in x["digests"]}) == 1,
            "group_s": time.perf_counter() - t0}
    emit({"phase": "elastic", **line, **card})
    if (not line["digests_equal"] or any(x["avg_metrics"] != cvs[0]["avg_metrics"] for x in cvs)
            or line["best_index"] != line["unmeshed_best_index"]
            or max(abs(a - b) for a, b in zip(line["avg_metrics"],
                                              line["unmeshed_avg_metrics"])) > 0.01):
        failures.append("cross_validator: see the line above")
    emit({"phase": "elastic_summary", "failures": failures,
          "phase_s": time.perf_counter() - t_phase, **card})
    if failures:
        raise AssertionError(f"elastic: {failures}")


def analysis_phase(scratch, card):
    """The analysis plane on the card: the port lints clean; the native
    libsvm parser builds and equals the numpy parser on a generated
    letter-shaped file; ``trace_contracts(device="cuda")`` (the
    distributed sweep on spawned gloo ranks on ``cuda:0``) passes
    ``check_contracts`` against the committed baseline, measuring every
    pinned budget: those the CPU counts equal there, the card-only ones
    (host syncs a round, nvcc builds in a fit) at their pins, and the
    kernels' ``LAUNCHES`` delta equal to the work hook's count a round.
    Any violation raises."""
    from spark_ensemble_tpu_torch.analysis import check_contracts, lint_paths, trace_contracts
    from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod
    from spark_ensemble_tpu_torch.utils import _libsvm_native, datasets

    t_phase = time.perf_counter()
    problems, line = [], {"phase": "analysis"}
    findings = lint_paths()
    loud = [f.to_record() for f in findings if not f.suppressed]
    line["lint"] = {"unsuppressed": len(loud), "suppressed": len(findings) - len(loud),
                    "unjustified": sum(1 for f in findings if f.suppressed and not f.justification)}
    if loud or line["lint"]["unjustified"]:
        problems.append(f"lint: {loud[:3]}")

    # a letter-shaped libsvm file (labels 1..26, 16 features, sparse rows)
    rng = np.random.default_rng(0)
    path = os.path.join(scratch, "letter_like.svm")
    with open(path, "w") as f:
        for _ in range(N_ROWS):
            idx = np.sort(rng.choice(np.arange(1, N_FEATURES + 1), 12, replace=False))
            f.write(f"{rng.integers(1, N_CLASSES + 1)} "
                    + " ".join(f"{j}:{v:.6g}" for j, v in zip(idx, rng.standard_normal(12)))
                    + "\n")
    t0 = time.perf_counter()
    _libsvm_native.parse_libsvm_native(path)  # raises unless the native path runs
    first_s = time.perf_counter() - t0  # g++'s build of the parser included
    t0 = time.perf_counter()
    native = _libsvm_native.parse_libsvm_native(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = datasets._parse_numpy(path, None)
    numpy_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(native, plain))
    line["parser"] = {"rows": int(native[0].shape[0]), "features": int(native[0].shape[1]),
                      "native_first_s": first_s, "native_s": native_s, "numpy_s": numpy_s,
                      "equal": equal,
                      "library": _libsvm_native.library_path().name}
    if not equal or native[0].shape != (N_ROWS, N_FEATURES):
        problems.append(f"parser: {line['parser']}")

    t0 = time.perf_counter()
    report = trace_contracts(device="cuda", spawn_ranks=True)
    line["trace_s"] = time.perf_counter() - t0
    # the host-reads trace's counts at 2 and 4 rounds, split at the step search
    line["host_calls"] = report.host_calls
    pinned = contracts_mod.load_baseline()["entry_points"]
    checked = check_contracts(report=report)
    line["budgets"] = report.budgets
    line["violations"] = [v.to_record() for v in checked.violations]
    line["skipped"] = report.skipped
    unmeasured = sorted(set(pinned) - set(report.budgets))
    line["unmeasured"] = unmeasured
    if checked.violations:
        problems.append(f"contracts: {line['violations'][:4]}")
    if unmeasured or set(report.skipped) != {"serving.donation"}:
        problems.append(f"contracts: unmeasured on the card {unmeasured}, skipped "
                        f"{sorted(report.skipped)}")
    line["phase_s"] = time.perf_counter() - t_phase
    emit({**line, **card})
    if problems:
        raise AssertionError(f"analysis: {problems[:4]}")


def _quantiles_ms(values):
    return {"p50_ms": float(np.percentile(values, 50)), "p99_ms": float(np.percentile(values, 99))}


def fleet_phase(st, hk, chaos_mod, timed_model, X_np, y_np, make_gbm, scratch, engine_alone,
                per_fit, card):
    """The closed serving loop over the timed model on its device: a
    ``ModelRegistry`` (capacity 2) holding it as ``prod`` and its 60-round
    prefix as ``v2``; a ``FleetRouter`` of three replicas under four client
    threads (every response equal to the model's own ``predict_proba`` of
    its rows, one-row requests included, no capture after warmup, latency
    per bucket and rows/s beside the engine alone); a stalled replica
    (hedges), a killed one (nothing lost or duplicated, counted by request
    id), deadline pressure (degraded responses equal to their ``take(k)``
    tier); torn-free swaps to ``v2`` and back; the shifted rows raising the
    watchdog's ``quality_psi_max``, and ``Autopilot.step()`` refreshing the
    model in the background under paced traffic (``fit_resume`` of
    ``REFRESH_ROUNDS``: the fused kernels' launches counted, the result
    equal to an uninterrupted longer fit), the same fit timed beside
    unpaced clients, a shadow scorer over the previous version (on a second
    router over the served entry) whose divergence rolls the fleet back, a
    chaos ``refresh_crash`` that leaves the served model untouched and a
    retry while another registry warms (captures) a model; and an
    eviction past capacity that takes the least recently used entry, whose
    re-activation predicts bit for bit and whose ``evict`` frees at least
    its packed bytes of device memory.  Any failed check raises."""
    import collections
    import threading

    import torch

    from spark_ensemble_tpu_torch.models.base import tree_leaves
    from spark_ensemble_tpu_torch.serving import Autopilot, FleetRouter, ModelRegistry, fit_resume, load_packed, pack
    from spark_ensemble_tpu_torch.telemetry import record_fits
    from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot
    from spark_ensemble_tpu_torch.telemetry.quality import ShadowScorer
    from spark_ensemble_tpu_torch.telemetry.watchdog import Watchdog, default_rules, sentinel_thresholds

    t_phase = time.perf_counter()
    dev = timed_model.device
    cuda = dev.type == "cuda"
    rounds = int(timed_model.num_members)
    v2_rounds, tiers = int(0.6 * rounds), (rounds // 4, rounds // 2)
    n_rows = X_np.shape[0]
    never = chaos_mod.ChaosController(seed=0, rate=0.0)
    chaos_mod.install(never)
    failures = []

    def check(name, ok):
        if not ok:
            failures.append(name)
        return bool(ok)

    def sync():
        if cuda:
            torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- the refresh check's own fence helper, around timed windows

    # the uninterrupted fit a refresh must equal, bit for bit
    sync()
    t0 = time.perf_counter()
    full = make_gbm(rounds + REFRESH_ROUNDS).fit(X_np, y_np, device=dev.type)
    sync()
    full_fit_s = time.perf_counter() - t0

    # the served versions by fleet version number, and their tiers
    takes = {}

    def ref_model(model, tier):
        if not tier:
            return model
        key = (id(model), tier)
        if key not in takes:
            takes[key] = model.take(tier)
        return takes[key]

    def exact(results, versions):
        """Responses whose value is not, bit for bit, their version's model
        (at their tier) on the same rows."""
        bad = []
        for lo, n, method, resp, _ in results:
            model = ref_model(versions[resp.version], resp.tier)
            want = getattr(model, method)(X_np[lo:lo + n]).cpu().numpy()
            if not np.array_equal(resp.value, want):
                bad.append({"lo": lo, "n": n, "version": resp.version, "tier": resp.tier,
                            "max_abs_diff": float(np.abs(resp.value - want).max())})
        return bad

    class Traffic:
        """Client threads, each sending requests (a fixed count back to
        back, or until joined with ``pause_s`` between them) of 1-4096 rows
        at random offsets, synchronously."""

        def __init__(self, fleet, clients, per_client=None, sizes=None, seed=0,
                     method="predict_proba", pause_s=FLEET_PAUSE_S):
            self.fleet, self.method, self.sizes, self.pause_s = fleet, method, sizes, pause_s
            self.results, self.errors = [], []
            self.lock, self.halt = threading.Lock(), threading.Event()
            self.threads = [threading.Thread(target=self._run, args=(seed + c, per_client), daemon=True)
                            for c in range(clients)]
            for th in self.threads:
                th.start()

        def _run(self, seed, count):
            rng = np.random.RandomState(seed)
            i = 0
            while (i < count) if count is not None else not self.halt.is_set():
                if self.sizes:
                    n = self.sizes[i % len(self.sizes)]
                else:  # log-uniform over 1-4096, every tenth request one row
                    n = 1 if i % 10 == 0 else int(np.exp(rng.uniform(0.0, np.log(4096.0))))
                lo = int(rng.randint(0, n_rows - n + 1))
                t0 = time.perf_counter()
                try:
                    resp = self.fleet.submit(X_np[lo:lo + n], method=self.method).result(timeout=120)
                except Exception as e:  # collected; the phase fails on any
                    with self.lock:
                        self.errors.append(repr(e))
                else:
                    with self.lock:
                        self.results.append((lo, n, self.method, resp, time.perf_counter() - t0))
                i += 1
                if count is None and self.pause_s:
                    self.halt.wait(self.pause_s)

        def join(self):
            self.halt.set()
            for th in self.threads:
                th.join(timeout=300)
            if any(th.is_alive() for th in self.threads):
                raise AssertionError("fleet: a client thread did not finish")
            return self.results

    class StallReplica(chaos_mod.ChaosController):
        """The chaos ``replica_stall`` on every request one replica serves,
        no other fault."""

        def __init__(self, replica, seconds):
            super().__init__(seed=0, rate=0.0)
            self.replica, self.seconds, self.stalls = replica, seconds, 0

        def stall_s(self, site, seconds=0.25):
            if f":{self.replica}:" not in site:
                return 0.0
            with self._lock:
                self.stalls += 1
            return self.seconds

    eng_opts = dict(methods=("predict", "predict_proba"), min_bucket=8, max_batch_size=4096,
                    prefix_tiers=tiers)
    art = os.path.join(scratch, "fleet_prod")
    pack(timed_model).save(art)
    prod = load_packed(art, device=dev.type)  # its own device copy, which eviction frees
    reg = ModelRegistry(capacity=2, **eng_opts)
    c_start = compile_snapshot()[0]
    t0 = time.perf_counter()
    reg.register("prod", prod, warm=True)
    warm_prod_s = time.perf_counter() - t0
    reg.register("v2", prod.take(v2_rounds), warm=True)
    graphs_per_engine = len(reg.engine("prod").stats()["compiled"])
    captures_at_warmup = compile_snapshot()[0] - c_start
    v2_model = timed_model.take(v2_rounds)
    versions = {0: timed_model}
    fleet = FleetRouter.from_registry(reg, "prod", replicas=FLEET_REPLICAS, deadline_ms=30_000.0,
                                      deadline_grace=1e5, degrade_depth=10_000, shed_depth=10_000)
    out = {"phase": "fleet", "rounds": rounds, "replicas": FLEET_REPLICAS,
           "graphs_per_engine": graphs_per_engine, "warmup_s_prod": warm_prod_s,
           "captures_at_registry_warmup": captures_at_warmup}
    with record_fits() as rec:
        # 1. load: four client threads, about 200 requests of 1-4096 rows
        c0 = compile_snapshot()[0]
        t0 = time.perf_counter()
        traffic = Traffic(fleet, FLEET_CLIENTS, per_client=FLEET_REQUESTS // FLEET_CLIENTS)
        load = traffic.join()
        load_s = time.perf_counter() - t0
        snap = fleet.slo_snapshot()
        per_bucket = collections.defaultdict(list)
        bucket_for = reg.engine("prod").bucket_for
        for lo, n, _, resp, lat in load:
            per_bucket[bucket_for(n)].append(1e3 * lat)
        bad = exact(load, versions)
        out["load"] = {
            "requests": len(load), "errors": traffic.errors[:3], "one_row_requests": sum(n == 1 for _, n, *_ in load),
            "rows": int(sum(n for _, n, *_ in load)), "seconds": load_s,
            "rows_per_s": sum(n for _, n, *_ in load) / load_s,
            "latency_ms": {b: dict(_quantiles_ms(v), requests=len(v)) for b, v in sorted(per_bucket.items())},
            "engine_alone_latency_ms": engine_alone["latency_ms"],
            "engine_alone_sync_rows_per_s": engine_alone["sync_rows_per_s"],
            "fleet_p50_ms": snap["p50_ms"], "fleet_p99_ms": snap["p99_ms"],
            "hedge_rate": snap["hedge_rate"], "degraded": snap["degraded"],
            "bit_identical": not bad, "mismatches": bad[:3],
            "compiles_since_warmup": snap["compiles_since_warmup"],
        }
        check("load: answered", not traffic.errors and len(load) == FLEET_REQUESTS)
        check("load: bit-identical", not bad)
        check("load: one-row requests", out["load"]["one_row_requests"] > 0)
        check("load: no capture", snap["compiles_since_warmup"] == 0 and compile_snapshot()[0] == c0)

        # 2. faults: a stalled replica, a killed one, deadline pressure
        h0, won0 = snap["hedges_fired"], snap["hedges_won"]
        # well past the live p99, where the hedge timer fires
        stall = StallReplica("fleet:r0", max(0.25, 3e-3 * snap["p99_ms"]))
        chaos_mod.install(stall)
        traffic = Traffic(fleet, 2, per_client=15, sizes=(8, 64, 512), seed=10)
        stalled = traffic.join()
        chaos_mod.install(never)
        snap = fleet.slo_snapshot()
        bad = exact(stalled, versions)
        out["stall"] = {"requests": len(stalled), "stalls": stall.stalls, "stall_s": stall.seconds,
                        "hedges_fired": snap["hedges_fired"] - h0, "hedges_won": snap["hedges_won"] - won0,
                        "bit_identical": not bad, "errors": traffic.errors[:3]}
        check("stall: hedges", stall.stalls > 0 and snap["hedges_fired"] > h0)
        check("stall: answered", not traffic.errors and len(stalled) == 30 and not bad)

        crashes0, replays0 = snap["crashes"], snap["replays"]
        rng = np.random.RandomState(40)
        futs = []
        for i in range(90):
            n = (1, 16, 256, 1024, 4096)[i % 5]
            lo = int(rng.randint(0, n_rows - n + 1))
            futs.append((lo, n, fleet.submit(X_np[lo:lo + n], method="predict_proba")))
            if i == 59:
                killed = fleet.kill_replica()
        killed_res = [(lo, n, "predict_proba", f.result(timeout=120), 0.0) for lo, n, f in futs]
        # the kill waits in the replica's queue behind the requests already
        # there, so it may land after every answer is in
        deadline = time.time() + 30.0
        while fleet.slo_snapshot()["crashes"] == crashes0 and time.time() < deadline:
            time.sleep(0.01)
        snap = fleet.slo_snapshot()
        bad = exact(killed_res, versions)
        out["kill"] = {"replica": killed, "requests": len(killed_res), "crashes": snap["crashes"] - crashes0,
                       "replays": snap["replays"] - replays0, "bit_identical": not bad,
                       "state": snap["replicas"][killed]["state"]}
        check("kill: nothing lost", len(killed_res) == 90 and not bad and snap["crashes"] - crashes0 == 1)
        time.sleep(0.6)  # past the breaker's backoff: the next requests probe it back in

        degraded = []
        for n in (1, 64, 4096, 300):
            lo = int(rng.randint(0, n_rows - n + 1))
            degraded.append((lo, n, "predict_proba",
                             fleet.predict(X_np[lo:lo + n], method="predict_proba", deadline_ms=0.25), 0.0))
        bad = exact(degraded, versions)
        out["degraded"] = {"requests": len(degraded), "tiers": [r[3].tier for r in degraded],
                           "all_degraded": all(r[3].degraded for r in degraded), "bit_identical_to_take": not bad}
        check("degraded: take(k) bits", not bad and all(r[3].degraded and r[3].tier in tiers for r in degraded))
        for _ in range(6):  # re-admit the killed replica
            fleet.predict(X_np[:8], method="predict_proba")
        out["kill"]["state_after"] = fleet.slo_snapshot()["replicas"][killed]["state"]

        # 3. torn-free swaps under traffic: to v2 and back
        c0 = compile_snapshot()[0]
        traffic = Traffic(fleet, FLEET_CLIENTS, sizes=(1, 64, 1000), seed=20)
        time.sleep(0.3)
        info_v2 = fleet.swap_model("v2")
        versions[info_v2["version"]] = v2_model
        time.sleep(0.3)
        info_back = fleet.swap_model("prod")
        versions[info_back["version"]] = timed_model
        time.sleep(0.3)
        swapped = traffic.join()
        bad = exact(swapped, versions)
        seen = collections.Counter(r[3].version for r in swapped)
        out["swap"] = {"requests": len(swapped), "per_version": dict(seen), "torn": bad[:3],
                       "swap_ms": [info_v2["swap_ms"], info_back["swap_ms"]],
                       "swap_compiles": [info_v2["swap_compiles"], info_back["swap_compiles"]],
                       "captures": compile_snapshot()[0] - c0, "errors": traffic.errors[:3]}
        check("swap: torn-free", not bad and not traffic.errors and len(seen) >= 2)
        check("swap: no capture", info_v2["swap_compiles"] == info_back["swap_compiles"] == 0
              and compile_snapshot()[0] == c0)

        # 4. the closed loop: drift raises the watchdog, the autopilot
        # refreshes in the background under traffic
        thresholds = dict(sentinel_thresholds(), shadow_divergence=("lower", SHADOW_THRESHOLD))
        dog = Watchdog(rules=default_rules(thresholds, breach_for=1, clear_for=1), interval_s=3600.0)
        pilot = Autopilot(fleet, dog, refresh_data=lambda: (X_np, y_np), refresh_rounds=REFRESH_ROUNDS,
                          min_replicas=FLEET_REPLICAS, max_replicas=FLEET_REPLICAS, interval_s=3600.0)
        fleet.predict(X_np[:4096] + 1.5, method="predict_proba")
        readings = dog.evaluate_once()
        psi = readings["quality_psi_max"]
        check("drift: quality_psi_max raised", psi["active"] and dog.verdict()["status"] == "degraded")
        n_ev = len(rec.events)
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        started = pilot.step()
        traffic = Traffic(fleet, FLEET_CLIENTS, sizes=(1, 64, 1000), seed=30)
        refreshed_in_time = pilot.join_refresh(timeout=600)
        refresh_wall_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        time.sleep(0.2)
        during = traffic.join()
        action = pilot.actions[-1] if pilot.actions else {}
        versions[action.get("swap_version", -1)] = full
        fits = [e for e in rec.events[n_ev:] if e.get("event") == "fit_end"]
        refresh_fit_s = fits[0]["wall_s"] if fits else None
        refreshed = reg.engine("prod@v1").packed.model() if "prod@v1" in reg else None
        same = refreshed is not None and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(refreshed.params), tree_leaves(full.params))
        ) and len(tree_leaves(refreshed.params)) == len(tree_leaves(full.params))
        del refreshed  # eviction frees an entry only once nothing else holds its tensors
        bad = exact(during, versions)
        out["refresh"] = {
            "psi_max": psi["value"], "step_actions": started, "status": action.get("status"),
            "error": action.get("error"), "model": action.get("model"), "members": action.get("members"),
            "swap_compiles": action.get("swap_compiles"), "wall_s": refresh_wall_s,
            "fit_s": refresh_fit_s, "fit_iters_per_s": REFRESH_ROUNDS / refresh_fit_s if refresh_fit_s else None,
            "uninterrupted_fit_s": full_fit_s, "uninterrupted_iters_per_s": (rounds + REFRESH_ROUNDS) / full_fit_s,
            "launches": launches, "bit_identical_to_uninterrupted": bool(same),
            "requests_during": len(during), "client_requests_per_s": len(during) / refresh_wall_s,
            "client_pause_s": FLEET_PAUSE_S,
            "versions_during": dict(collections.Counter(r[3].version for r in during)),
            "torn": bad[:3], "errors": traffic.errors[:3],
        }
        check("refresh: in the background", started == [] and refreshed_in_time)
        check("refresh: ok", action.get("action") == "refresh" and action.get("status") == "ok"
              and action.get("swap_compiles") == 0)
        check("refresh: launches", launches == per_fit(REFRESH_ROUNDS))
        check("refresh: bit-identical", same)
        check("refresh: traffic torn-free", not bad and not traffic.errors and len(during) > 0)

        # 4b. the same refresh fit, on the autopilot's refresh stream,
        # beside clients that do not pause between requests
        hk.reset_launch_counts()
        traffic = Traffic(fleet, FLEET_CLIENTS, sizes=(1, 64, 1000), seed=35, pause_s=0.0)
        time.sleep(0.2)
        stream, unpaced = pilot.refresh_stream(dev), {}

        def refit():
            with torch.cuda.stream(stream):
                t = time.perf_counter()
                unpaced["packed"] = fit_resume(timed_model, X_np, y_np, REFRESH_ROUNDS)
                if cuda:
                    stream.synchronize()
                unpaced["fit_s"] = time.perf_counter() - t

        t0 = time.perf_counter()
        fitter = threading.Thread(target=refit, daemon=True)
        fitter.start()
        fitter.join(timeout=600)
        unpaced_wall_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        beside = traffic.join()
        if fitter.is_alive() or "packed" not in unpaced:
            raise AssertionError("fleet: the unpaced refresh fit did not finish")
        refit_model = unpaced.pop("packed").model()
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(refit_model.params), tree_leaves(full.params)))
        del refit_model
        # one reference over every row, sliced: the thousands of responses
        # would take longer to check one call each than the fit takes
        want = full.predict_proba(X_np).cpu().numpy()
        bad = [(lo, n, resp.version) for lo, n, _, resp, _ in beside
               if resp.version != action.get("swap_version") or not np.array_equal(resp.value, want[lo:lo + n])]
        out["refresh_unpaced"] = {
            "fit_s": unpaced["fit_s"], "fit_iters_per_s": REFRESH_ROUNDS / unpaced["fit_s"],
            "paced_fit_s": refresh_fit_s, "requests_during": len(beside),
            "client_requests_per_s": len(beside) / unpaced_wall_s, "launches": launches,
            "bit_identical_to_uninterrupted": bool(same), "torn": bad[:3], "errors": traffic.errors[:3],
        }
        check("refresh unpaced: launches", launches == per_fit(REFRESH_ROUNDS))
        check("refresh unpaced: bit-identical", same)
        check("refresh unpaced: traffic answered", not bad and not traffic.errors and len(beside) > 0)

        # 5. a shadow scorer over the previous version, on a second router
        # over the served entry, scores the served probabilities; its
        # divergence rolls the fleet back.  The labels go in one-hot, so
        # the delta is the probabilities' mean absolute error's
        scorer = ShadowScorer(reg, "prod", fraction=0.25, method="predict_proba",
                              divergence_threshold=SHADOW_THRESHOLD, stream="chip_smoke_shadow")
        shadowed = FleetRouter.from_registry(reg, action.get("model"), replicas=1, shadow=scorer,
                                             deadline_ms=30_000.0, deadline_grace=1e5,
                                             degrade_depth=10_000, shed_depth=10_000)
        ids = []
        for i in range(40):
            lo = (i * 331) % (n_rows - 1024)
            shadowed.predict(X_np[lo:lo + 1024], method="predict_proba")
            ids.append((shadowed.slo_snapshot()["requests"], lo))  # the request's id: no other traffic
        deadline = time.time() + 30.0
        while scorer.snapshot()["evals"] < 10 and time.time() < deadline:
            time.sleep(0.01)
        n_cls = int(timed_model.num_classes)
        labeled = sum(scorer.record_label(seq, np.eye(n_cls, dtype=np.float32)[y_np[lo:lo + 1024].astype(int)])
                      for seq, lo in ids)
        shadow = scorer.snapshot()
        acts = pilot.step()
        shadowed.stop()
        scorer.close()
        if acts and acts[0].get("version") is not None:
            versions[acts[0]["version"]] = timed_model
        back = []
        for n in (1, 333, 4096):
            back.append((0, n, "predict_proba", fleet.predict(X_np[:n], method="predict_proba"), 0.0))
        bad = exact(back, versions)
        out["shadow"] = {"evals": shadow["evals"], "labeled": labeled,
                         "divergence": shadow.get("divergence"), "accuracy_delta": shadow.get("accuracy_delta"),
                         "threshold": SHADOW_THRESHOLD}
        out["rollback"] = {"actions": [(a["action"], a["status"], a.get("target")) for a in acts],
                           "swap_compiles": acts[0].get("swap_compiles") if acts else None,
                           "bit_identical_to_previous": bool(acts) and not bad and all(
                               r[3].version == acts[0].get("version") for r in back)}
        check("shadow: sampled and labeled", shadow["evals"] == 10 and labeled == 10)
        check("rollback", [a["action"] for a in acts] == ["rollback"] and acts[0]["status"] == "ok"
              and acts[0]["target"] == "prod" and out["rollback"]["bit_identical_to_previous"])

        # 6. a chaos refresh_crash: the served model untouched; the next
        # step retries from the same committed state
        fleet.predict(X_np[:4096] + 1.5, method="predict_proba")
        crash = chaos_mod.ChaosController(seed=0, rate=1.0, faults=("refresh_crash",))
        chaos_mod.install(crash)
        version0, names0 = fleet.slo_snapshot()["version"], sorted(reg.names())
        want0 = fleet.predict(X_np[:64], method="predict_proba").value
        first = pilot.step()
        pilot.join_refresh(timeout=600)
        crashed = pilot.actions[-1]
        untouched = (fleet.slo_snapshot()["version"] == version0 and sorted(reg.names()) == names0
                     and np.array_equal(fleet.predict(X_np[:64], method="predict_proba").value, want0))
        n_ev = len(rec.events)
        hk.reset_launch_counts()
        retry_started = pilot.step()
        # another registry warms (captures graphs for) one model after
        # another until the retry, fitting in the background, has rolled
        side = ModelRegistry(capacity=1, **eng_opts)
        warms, w0 = 0, time.time()
        while warms == 0 or not (pilot.join_refresh(timeout=0) or time.time() - w0 > 600):
            side.register(f"v2.{warms}", prod.take(v2_rounds), warm=True)
            warms += 1
        w1 = time.time()
        captured_beside = len(side.engine(f"v2.{warms - 1}").stats()["compiled"])
        pilot.join_refresh(timeout=600)
        retry_launches = dict(hk.LAUNCHES)
        retried = pilot.actions[-1]
        chaos_mod.install(never)
        fits = [e for e in rec.events[n_ev:] if e.get("event") == "fit_end"]
        overlap_s = (min(w1, fits[0]["ts"]) - max(w0, fits[0]["ts"] - fits[0]["wall_s"])) if fits else None
        side_bad = [n for n in (1, 8, 333, 4096) if not np.array_equal(
            side.predict(f"v2.{warms - 1}", X_np[:n], method="predict_proba"), v2_model.predict_proba(X_np[:n]).cpu().numpy())]
        side.close()
        versions[retried.get("swap_version", -1)] = full
        again = reg.engine("prod@v2").packed.model() if "prod@v2" in reg else None
        same = again is not None and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(again.params), tree_leaves(full.params)))
        del again
        after = [(0, n, "predict_proba", fleet.predict(X_np[:n], method="predict_proba"), 0.0) for n in (1, 100)]
        out["refresh_crash"] = {
            "fired": crash.fired, "crashed": (crashed.get("action"), crashed.get("status"), crashed.get("error")),
            "untouched": untouched, "retry": (retried.get("action"), retried.get("status"), retried.get("model")),
            "retry_bit_identical": bool(same), "step_actions": [first, retry_started],
            "retry_launches": retry_launches, "warms_beside_retry": warms,
            "captures_per_warm": captured_beside,
            "capture_overlap_s": overlap_s, "captured_model_bit_identical": not side_bad,
        }
        check("refresh_crash: fired and untouched", crash.fired and crash.fired[0][0] == "refresh_crash"
              and crashed.get("status") == "failed" and untouched)
        check("refresh_crash: retried", retried.get("status") == "ok" and same and not exact(after, versions))
        check("refresh_crash: retry beside captures", retry_launches == per_fit(REFRESH_ROUNDS)
              and captured_beside == graphs_per_engine and overlap_s is not None and overlap_s > 0
              and not side_bad)

        # 7. every request answered once, counted by request id
        snap, stream_id = fleet.slo_snapshot(), fleet.statusz()["stream"]
        served = collections.Counter(e["seq"] for e in rec.events
                                     if e.get("event") == "fleet_request" and e.get("fit_id") == stream_id)
        out["requests"] = {"submitted": snap["requests"], "answered_ids": len(served),
                           "duplicated": sum(c > 1 for c in served.values()),
                           "hedges_fired": snap["hedges_fired"], "hedges_won": snap["hedges_won"],
                           "crashes": snap["crashes"], "replays": snap["replays"], "version": snap["version"]}
        check("requests: none lost or duplicated",
              len(served) == snap["requests"] and max(served.values()) == 1 and snap["shed"] == 0)
        pilot.stop()
        fleet.stop()

    # 8. eviction: a third model past capacity 2 evicts the least recently
    # used entry (prod@v2, unpinned since the fleet stopped); it re-activates
    # bit for bit, and evicting it again frees its device memory
    rows = X_np[:777]
    before = reg.predict("prod@v2", rows, method="predict_proba")
    reg.predict("prod", rows, method="predict_proba")  # prod the most recently used
    reg.register("v3", load_packed(art, device=dev.type), warm=True)
    resident = sorted(k for k, v in reg.stats().items() if v["resident"])
    again = reg.predict("prod@v2", rows, method="predict_proba")
    sync()
    mem0, nbytes = (torch.cuda.memory_allocated() if cuda else 0), reg.stats()["prod@v2"]["bytes"]
    reg.evict("prod@v2")
    sync()
    freed = mem0 - (torch.cuda.memory_allocated() if cuda else 0)
    out["eviction"] = {"resident_after_register": resident, "packed_bytes": nbytes, "freed_bytes": freed,
                       "reactivated_bit_identical": bool(np.array_equal(before, again))}
    check("eviction: LRU", resident == ["prod", "v3"])
    if cuda:
        check("eviction: memory freed", freed >= nbytes)
    check("eviction: re-activation", np.array_equal(before, again)
          and np.array_equal(again, full.predict_proba(rows).cpu().numpy()))
    reg.close()
    chaos_mod.install(None)
    out.update({"failures": failures, "phase_s": time.perf_counter() - t_phase, **card})
    emit(out)
    if failures:
        raise AssertionError(f"fleet: {failures}")


# the build cache's probe: a fresh process builds (or finds) the kernels in
# SE_TPU_COMPILE_CACHE, launches one histogram and holds it to the plain
# version; compile_count is the telemetry ledger's nvcc builds
BUILD_PROBE = """
import json, time
t0 = time.perf_counter()
import torch
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.telemetry.events import global_metrics
so = hk.build_kernels()
hk._library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
ids = torch.randint(0, 16, (4096, 8), generator=g, dtype=torch.int32)
node = torch.randint(0, 4, (4096, 3), generator=g, dtype=torch.int32)
vals = torch.randn(4096, 3, 2, generator=g)
ref = hk.hist_plain(ids, node, vals, 4, 16, 2)
got = hk.hist_level_pallas(ids.cuda(), node.cuda(), vals.cuda(), n_nodes=4, max_bins=16).cpu()
ok = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max())))
print(json.dumps({"so": str(so), "build_dir": str(hk.build_dir()),
                  "compile_count": global_metrics().counter("jit/compile_count").value,
                  "build_s": build_s, "seconds": time.perf_counter() - t0,
                  "launch_ok": ok}))
"""

# the autotune phase's kernel timings: fewer repeats than the kernels line
AUTOTUNE_REPS, AUTOTUNE_RUNS = 20, 3


def autotune_phase(st, hk, binning, X_np, y_np, scratch, device_ms, card):
    """The autotune plane on the card.  (1) The smoke search, all five
    groups, publishes under ``cuda/<card>/n11`` and ``*``; then
    ``autotune_fit`` on the search's data must hit the cache with zero
    measurements.  (2) Every fitting candidate of the four kernel knobs at
    the main path's shapes (15000x16, M=26, C=2, B=64; levels 0 and 4; i32
    bins for the pallas knobs, 8-bit words for the fused ones), timed
    (``device_ms``), held to the plain version at the kernels' tolerance,
    and each ``R`` equal bit for bit to the shipped ``R``.  (3) The main
    path (fused, 20 rounds) with autotuning off and over an empty cache,
    equal bit for bit with equal launches; under the published winners,
    accuracy within 0.02; under each fitting ``fused_block_rows``, equal
    bit for bit.  (4) Mode ``search`` over a fresh cache searches once,
    on the first fit only.  (5) The build cache: a process with
    ``SE_TPU_COMPILE_CACHE`` set builds the kernels, a second loads them
    without nvcc.  The cache variables are pointed at scratch directories
    and restored; one line, and any missed check fails the run."""
    import torch

    from spark_ensemble_tpu_torch.autotune import (
        TUNABLES,
        TuningCache,
        autotune_fit,
        run_search,
    )
    from spark_ensemble_tpu_torch.autotune import search as search_mod
    from spark_ensemble_tpu_torch.autotune.cache import entry_key
    from spark_ensemble_tpu_torch.autotune.resolve import override, reset
    from spark_ensemble_tpu_torch.models.base import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    problems, line = [], {"phase": "autotune"}
    saved = {k: os.environ.get(k) for k in ("SE_TPU_AUTOTUNE_CACHE", "SE_TPU_AUTOTUNE")}

    def use_cache(name, mode=None):
        os.environ["SE_TPU_AUTOTUNE_CACHE"] = os.path.join(scratch, name)
        if mode is None:
            os.environ.pop("SE_TPU_AUTOTUNE", None)
        else:
            os.environ["SE_TPU_AUTOTUNE"] = mode
        reset()

    def fit(rounds):
        hk.reset_launch_counts()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
        t0 = time.perf_counter()
        model = _main_path_gbm(st, rounds).fit(X_np, y_np, device="cuda")
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0, dict(hk.LAUNCHES)

    def same(a, b):
        la, lb = tree_leaves(a.params), tree_leaves(b.params)
        return len(la) == len(lb) and all(torch.equal(x, z) for x, z in zip(la, lb))

    def accuracy(model):
        return float((model.predict(X_np).cpu().numpy() == y_np).mean())  # graftlint: ignore[unfenced-blocking-read] -- accuracy readback after the timed fit, outside its window

    try:
        # 1: the smoke search, then a cache hit
        use_cache("autotune_searched")
        t0 = time.perf_counter()
        res = run_search("smoke")
        search_s = time.perf_counter() - t0
        keys = [entry_key("cuda", kind, res["shape_class"]), entry_key("cuda", kind, "*")]
        entries = TuningCache.load(os.environ["SE_TPU_AUTOTUNE_CACHE"]).entries
        timed = ["hist_tier", "scan_chunk", "predict_fused_max_cells", "stream_chunk_rows",
                 "predict_bucket_pow2_exact", "predict_bucket_octave_steps",
                 "pallas_block_rows", "fused_block_rows"]
        if res["platform"] != "cuda" or list(res["timings"]) != timed:
            problems.append(f"search: platform {res['platform']}, timed {list(res['timings'])}")
        if not all(k in entries for k in keys):
            problems.append(f"search: entries {sorted(entries)} lack {keys}")
        cfg = search_mod.BUDGETS["smoke"]
        Xs, ys = search_mod._synth_classification(cfg["n"], cfg["d"], cfg["k"])
        measured = []
        t0 = time.perf_counter()
        hit = autotune_fit(_main_path_gbm(st, 3), Xs, ys, budget="smoke",
                           measure=lambda *a: measured.append(a) or 1.0)
        hit_s = time.perf_counter() - t0
        if not hit.get("cached") or measured or hit.get("params") != res["winners"]:
            problems.append(f"autotune_fit: {hit} after {len(measured)} measurements")
        line.update(search_s=search_s, timings_ms={k: {c: t * 1e3 for c, t in v.items()}
                                                   for k, v in res["timings"].items()},
                    winners=res["winners"], entry_keys=keys, shape_class=res["shape_class"],
                    autotune_fit_hit=bool(hit.get("cached")), autotune_fit_s=hit_s,
                    autotune_fit_measurements=len(measured))

        # 2: the kernel knobs at the main path's shapes
        M, C, n, d = N_CLASSES, 2, N_ROWS, N_FEATURES
        rng = np.random.RandomState(5)
        Xt = torch.as_tensor(X_np, device=dev)
        ids = binning.bin_features(Xt, binning.compute_bins(Xt, MAX_BINS))
        packed = binning.pack_bins(ids, MAX_BINS, 8).packed
        vals = torch.as_tensor(np.stack([rng.rand(n, M), rng.randn(n, M)], axis=2)
                               .astype(np.float32), device=dev)
        shipped = (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES)
        knob_rows = []
        for level in (0, 4):
            n_nodes = 2**level
            node = torch.as_tensor(rng.randint(0, n_nodes, (n, M)).astype(np.int32), device=dev)
            for kernel, nterms, bits in (("hist_i32", 2, 32), ("hist_packed", 3, 8)):
                if nterms == 2:
                    def run(kn, node=node, n_nodes=n_nodes):
                        return hk.hist_level_pallas(ids, node, vals, n_nodes=n_nodes,
                                                    max_bins=MAX_BINS, knobs=kn)
                else:
                    def run(kn, node=node, n_nodes=n_nodes):
                        return hk.hist_level_packed(packed, node, vals, n_nodes=n_nodes,
                                                    max_bins=MAX_BINS, bits=8, num_features=d,
                                                    knobs=kn)
                ref = hk.hist_plain(ids, node, vals, n_nodes, MAX_BINS, nterms)
                scale = float(ref.abs().max())
                base = run(shipped)
                rows_name, bytes_name = hk._LEVEL_KNOBS[nterms]
                cands = ([(rows_name, r, (r, shipped[1])) for r in TUNABLES[rows_name].candidates]
                         + [(bytes_name, b, (shipped[0], b)) for b in TUNABLES[bytes_name].candidates])
                for name, value, kn in cands:
                    fits = hk._fits(hk._level_tiling(n, d, M, C, MAX_BINS, n_nodes, bits, *kn))
                    plan = hk.level_plan(n, d, M, C, MAX_BINS, n_nodes, bits, kn)
                    row = {"kernel": kernel, "level": level, "tunable": name, "value": value,
                           "fits": fits, "plan": {k: getattr(plan, k) for k in (
                               "rows", "g", "nf", "cs", "rows_per_chunk", "grid", "smem")}}
                    if fits:
                        got = run(kn)
                        torch.cuda.synchronize()
                        err = float((got - ref).abs().max())
                        ok = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale))
                        row.update(max_abs_err=err, matches_plain=ok,
                                   device_ms=device_ms(lambda kn=kn: run(kn), reps=AUTOTUNE_REPS,
                                                       runs=AUTOTUNE_RUNS))
                        if not ok:
                            problems.append(f"{kernel} level {level} {name}={value}: err {err}")
                        if name == rows_name:
                            row["bit_identical_to_shipped"] = bool(torch.equal(got, base))
                            if not row["bit_identical_to_shipped"]:
                                problems.append(f"{kernel} level {level} {name}={value} != shipped R")
                    knob_rows.append(row)
        line["knobs"] = knob_rows

        # 3: the main path four ways
        os.environ["SE_TPU_AUTOTUNE"] = "off"
        reset()
        m_off, s_off, l_off = fit(PARITY_ROUNDS)
        use_cache("autotune_empty")
        m_cache, s_cache, l_cache = fit(PARITY_ROUNDS)
        if not same(m_off, m_cache) or l_off != l_cache:
            problems.append(f"off vs empty cache: launches {l_off} / {l_cache}")
        os.environ["SE_TPU_AUTOTUNE"] = "off"
        reset()
        _, s_off2, _ = fit(PARITY_ROUNDS)
        use_cache("autotune_empty")
        _, s_cache2, _ = fit(PARITY_ROUNDS)
        acc_default = accuracy(m_cache)
        use_cache("autotune_searched")
        m_win, s_win, l_win = fit(PARITY_ROUNDS)
        acc_win = accuracy(m_win)
        if abs(acc_win - acc_default) > 0.02:
            problems.append(f"winners: accuracy {acc_win} vs {acc_default}")
        use_cache("autotune_empty")
        r_fits = {}
        for R in TUNABLES["fused_block_rows"].candidates:
            if R == shipped[0] or not all(
                    hk._fits(hk._level_tiling(n, d, M, C, MAX_BINS, 2**lv, 8, R, shipped[1]))
                    for lv in range(DEPTH)):
                continue
            with override(fused_block_rows=R):
                m_r, s_r, l_r = fit(PARITY_ROUNDS)
            r_fits[str(R)] = {"bit_identical": same(m_r, m_cache), "launches_equal": l_r == l_cache,
                              "fit_s": s_r}
            if not (r_fits[str(R)]["bit_identical"] and l_r == l_cache):
                problems.append(f"main path at fused_block_rows={R} differs")
        line.update(main_path={
            "rounds": PARITY_ROUNDS, "off_vs_empty_bit_identical": same(m_off, m_cache),
            "launches": l_cache, "launches_equal": l_off == l_cache,
            "off_iters_per_s": [PARITY_ROUNDS / s_off, PARITY_ROUNDS / s_off2],
            "empty_cache_iters_per_s": [PARITY_ROUNDS / s_cache, PARITY_ROUNDS / s_cache2],
            "winners_accuracy": acc_win, "default_accuracy": acc_default,
            "winners_iters_per_s": PARITY_ROUNDS / s_win, "winners_launches": l_win,
            "fused_block_rows": r_fits})

        # 4: mode "search" over a fresh cache: one search, on the first fit
        use_cache("autotune_mode_search", mode="search")
        searches = []
        real_search = search_mod.run_search

        def counted(*a, **kw):
            searches.append(time.perf_counter())
            return real_search(*a, **kw)

        search_mod.run_search = counted
        try:
            _, first_s, _ = fit(3)
            first = len(searches)
            published = [k for k in TuningCache.load(os.environ["SE_TPU_AUTOTUNE_CACHE"]).entries
                         if k.startswith("cuda/")]
            _, second_s, _ = fit(3)
        finally:
            search_mod.run_search = real_search
        if first != 1 or len(searches) != 1 or not published:
            problems.append(f"mode search: {len(searches)} searches, published {published}")
        line.update(mode_search={"searches_first_fit": first, "searches_total": len(searches),
                                 "published": published, "first_fit_s": first_s,
                                 "second_fit_s": second_s})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset()

    # 5: the build cache, in two fresh processes
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "SE_TPU_COMPILE_CACHE": os.path.join(os.path.abspath(scratch), "kernel_cache")}
    builds = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", BUILD_PROBE], cwd=root, env=env,
                           capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            problems.append(f"build probe failed: {p.stderr[-400:]}")
            break
        builds.append(json.loads(p.stdout.strip().splitlines()[-1]))
    if ([b["compile_count"] for b in builds] != [1, 0] or not all(b["launch_ok"] for b in builds)
            or len({b["so"] for b in builds}) != 1
            or not all(b["build_dir"] == env["SE_TPU_COMPILE_CACHE"] for b in builds)):
        problems.append(f"build cache: {builds}")
    line.update(build_cache=builds, problems=problems[:8], phase_s=time.perf_counter() - t_phase,
                **card)
    emit(line)
    if problems:
        raise AssertionError(f"autotune: {problems[:5]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import spark_ensemble_tpu_torch as st
        from spark_ensemble_tpu_torch.ops import binning, hist_kernels as hk
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    # phase 1: the device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    bw = hbm_bytes_per_s(smi)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "hbm_bytes_per_s": bw})
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    so = hk.build_kernels()
    emit({"phase": "build", "library": so.name, "seconds": time.perf_counter() - t0})
    # every retry is counted from here on; one that no chaos fault injected
    # fails the run (a kernel fault must never be retried into silence)
    from spark_ensemble_tpu_torch.robustness import retry as retry_mod

    retry_mod.reset_retry_log()

    # phase 3: every kernel against its plain version at the main path's
    # shapes (synchronised, so a fault shows where it happened)
    def spread_ms(fn, reps=KERNEL_REPS, runs=KERNEL_RUNS):
        """(median, min, max) ms per call over `runs` runs of `reps` calls,
        each run timed with CUDA events, after one warm call."""
        fn()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the warm call before the CUDA-event runs
        times = []
        for _ in range(runs):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- closes a CUDA-event run: elapsed_time needs the end event done
            times.append(t0.elapsed_time(t1) / reps)
        times.sort()
        return times[len(times) // 2], times[0], times[-1]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    empty_traces = [0]

    def device_ms(fn, reps=KERNEL_REPS, runs=KERNEL_RUNS):
        """(median, min, max) ms of device time per call over `runs` runs
        of `reps` calls, from the kernel durations torch.profiler traces on
        the card, one trace per run; the host's issue time does not enter.
        A trace can drop kernel events (seen on the card), so a run's time
        is, for each kernel a call launches, its median traced duration
        times the launches per call (the most any run traced, over
        `reps`), summed over the kernels.  A trace can also come back with
        no kernel at all (seen on the card): that run is traced again, up
        to 4 tries, and the empty traces are counted."""
        fn()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the warm call before the traced runs
        traces = []
        for _ in range(runs):
            for _ in range(4):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- closes a traced run inside the profiler's window
                us = {}
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        us.setdefault(e.name, []).append(e.time_range.elapsed_us())
                if us:
                    break
                empty_traces[0] += 1
            if not us:
                raise AssertionError("the profiler traced no kernel on the card in 4 tries")
            traces.append(us)
        per_call = {}
        for us in traces:
            for k, v in us.items():
                per_call[k] = max(per_call.get(k, 0.0), len(v) / reps)
        times = sorted(sum(statistics.median(v) * per_call[k] for k, v in us.items()) / 1e3
                       for us in traces)
        return times[len(times) // 2], times[0], times[-1]

    def compare(rec, got, ref, what, exact=False):
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- the comparison reads both results: a check, not a timed path
        if exact:
            ok = torch.equal(got, ref)
            err = float((got.long() - ref.long()).abs().max()) if got.numel() else 0.0
        else:
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * scale))
        rec.max_abs_err = max(rec.max_abs_err, err)
        if not ok:
            raise AssertionError(f"{rec.name} disagrees with its plain version ({what}): max abs err {err}")
        return err

    def repeat_identical(rec, fn, what):
        a, b = fn(), fn()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- the comparison reads both results: a check, not a timed path
        pair = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(torch.equal(x, y) for x, y in pair):
            raise AssertionError(f"{rec.name}: two launches differ ({what})")

    def bound(kernel, **shapes):
        """The least time of one launch of ``kernel`` at ``shapes``: its
        bytes (``hk.kernel_work``, the program inventory's formula too)
        at the memory rate or its ops at the f32 rate, the larger."""
        nbytes, nops = hk.kernel_work(kernel, **shapes)
        t_bytes, t_ops = nbytes / bw * 1e3, nops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    rng = np.random.RandomState(1)
    X_np, _ = letter_data()
    X = torch.as_tensor(X_np, device=dev)
    M, C = N_CLASSES, 2
    recs = {
        "hist_i32": KernelRecord("hist_i32", "spark_ensemble_tpu/ops/pallas_hist.py:100 (_hist_kernel)"),
        "route_packed": KernelRecord("route_packed", "spark_ensemble_tpu/ops/pallas_hist.py:258 (_fused_kernel, routing)"),
        "hist_packed": KernelRecord("hist_packed", "spark_ensemble_tpu/ops/pallas_hist.py:258 (_fused_kernel, histogram)"),
        "leaf_sums": KernelRecord("leaf_sums", "spark_ensemble_tpu/ops/pallas_hist.py:258 (_fused_kernel, leaf mode)"),
    }

    def stats(n, zero_frac=0.0):
        vals = np.stack([rng.rand(n, M), rng.randn(n, M)], axis=2).astype(np.float32)
        vals[: int(n * zero_frac)] = 0.0
        return torch.as_tensor(vals, device=dev)

    def nodes(n, n_nodes):
        return torch.as_tensor(rng.randint(0, n_nodes, size=(n, M)).astype(np.int32), device=dev)

    def hist_index(ids, node, n_nodes, B):
        """Flat cell ids and values for the index_add_ yardstick."""
        n, d = ids.shape
        base = torch.arange(M, device=dev)[None, :] * n_nodes + node.long()
        return ((base[:, :, None, None] * C + torch.arange(C, device=dev)[None, None, :, None]) * d
                + torch.arange(d, device=dev)[None, None, None, :]) * B + ids.long()[:, None, None, :]

    checks = []
    bins64 = binning.compute_bins(X, MAX_BINS)
    Xb64 = binning.bin_features(X, bins64)
    bins16 = binning.compute_bins(X, 16)
    Xb16 = binning.bin_features(X, bins16)
    p = largest_prime_at_most(N_ROWS)

    def level_timing(name, run, plain, ids, node, vals, words, n_nodes, B, nterms):
        """One level histogram at the main path's shapes: its time with
        spread, its bound, its plain version's and one index_add_'s time."""
        n, d = ids.shape
        idx = hist_index(ids, node, n_nodes, B).reshape(-1)
        src = hk.split_terms(vals, nterms)[:, :, :, None].expand(n, M, C, d).reshape(-1)
        acc = torch.zeros(M * n_nodes * C * d * B, device=dev)
        b_ms, b_by = bound(name, n=n, d=d, W=words.shape[1], M=M, C=C, B=B, n_nodes=n_nodes)
        ms = spread_ms(run)
        lib = spread_ms(lambda: acc.index_add_(0, idx, src))
        dev_ms = device_ms(run)
        lib_dev = device_ms(lambda: acc.index_add_(0, idx, src))
        plan = hk.level_plan(n, d, M, C, B, n_nodes, 32 if words is ids else binning.pack_width(B))
        row = {"kernel": name, "n_nodes": n_nodes, "ms": ms[0], "spread": ms, "device_ms": dev_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib[0], "library_spread": lib,
               "library_device_ms": lib_dev,
               "plan": {k: getattr(plan, k) for k in ("g", "nf", "np", "cs", "rows", "grid", "threads", "smem")}}
        return row, (ms, spread_ms(plain, reps=10)[0], b_ms, b_by, lib[0]), (dev_ms, lib_dev)

    def check_level(rec, run, ref, what):
        err = compare(rec, run(), ref, what)
        repeat_identical(rec, run, what)
        return err

    # pallas tier: level histograms at n_nodes 1..16 (each timed), plus
    # prime n with 25% zero-weight rows
    rec = recs["hist_i32"]
    rec.per_level = []
    for n, n_nodes, zf in [(N_ROWS, 2**lv, 0.0) for lv in range(DEPTH)] + [(p, 16, 0.25)]:
        Xb, node, vals = Xb64[:n].contiguous(), nodes(n, n_nodes), stats(n, zf)
        run = lambda: hk.hist_level_pallas(Xb, node, vals, n_nodes=n_nodes, max_bins=MAX_BINS)
        plain = lambda: hk.hist_plain(Xb, node, vals, n_nodes, MAX_BINS, 2)
        err = check_level(rec, run, plain(), f"n={n} nodes={n_nodes}")
        row = {"kernel": rec.name, "n": n, "n_nodes": n_nodes, "zero_frac": zf, "max_abs_err": err}
        if n == N_ROWS:
            lvl, timing, dev_t = level_timing(rec.name, run, plain, Xb, node, vals, Xb, n_nodes, MAX_BINS, 2)
            rec.per_level.append(lvl)
            if n_nodes == 2 ** (DEPTH - 1):
                rec.timing = (timing[0][0],) + timing[1:]
                rec.spread = timing[0]
                rec.device_ms, rec.library_device_ms = dev_t
        checks.append(row)

    # fused tier at bits 8 (B=64) and bits 4 (B=16), all three modes
    for B, Xb_full in ((MAX_BINS, Xb64), (16, Xb16)):
        bits = binning.pack_width(B)
        for n, zf in ((N_ROWS, 0.0), (p, 0.25)):
            cb = binning.pack_bins(Xb_full[:n].contiguous(), B, bits)
            Xb, packed, vals = Xb_full[:n].contiguous(), cb.packed, stats(n, zf)
            kw = dict(bits=bits, num_features=N_FEATURES)
            node0 = torch.zeros((n, M), dtype=torch.int32, device=dev)
            # level 0, unrouted
            rec = recs["hist_packed"]
            run0 = lambda: hk.fused_round_level(packed, node0, vals, n_nodes=1, max_bins=B, **kw)
            H0, _ = run0()
            compare(rec, H0, hk.hist_plain(Xb, node0, vals, 1, B, 3), f"B={B} n={n} level 0")
            repeat_identical(rec, run0, f"B={B} level 0")
            if B == MAX_BINS and n == N_ROWS:
                # every level of the main path, timed: routed node ids as the
                # main path would give them stand in for a level's ids
                rec.per_level = []
                for lv in range(DEPTH):
                    n_nodes = 2**lv
                    node = nodes(n, n_nodes)
                    run = lambda: hk.hist_level_packed(packed, node, vals, n_nodes=n_nodes, max_bins=B, **kw)
                    plain = lambda: hk.hist_plain(binning.unpack_bins(cb), node, vals, n_nodes, B, 3)
                    check_level(rec, run, hk.hist_plain(Xb, node, vals, n_nodes, B, 3), f"B={B} nodes={n_nodes}")
                    lvl, _, _ = level_timing(rec.name, run, plain, Xb, node, vals, packed, n_nodes, B, 3)
                    rec.per_level.append(lvl)
            for half, leaf in ((8, False), (16, True)):
                n_nodes = 2 * half
                parent = nodes(n, half)
                bf = torch.as_tensor(rng.randint(0, N_FEATURES, size=(M, half)).astype(np.int32), device=dev)
                bt = torch.as_tensor(rng.randint(0, B, size=(M, half)).astype(np.int32), device=dev)
                run = lambda: hk.fused_round_level(packed, parent, vals, bf, bt, n_nodes=n_nodes,
                                                   max_bins=B, leaf=leaf, **kw)
                H, node_out = run()
                ref_node = hk.route_plain(Xb, parent, bf, bt)
                compare(recs["route_packed"], node_out, ref_node, f"B={B} n={n} half={half}", exact=True)
                ref = (hk.leaf_plain(ref_node, vals, n_nodes) if leaf
                       else hk.hist_plain(Xb, ref_node, vals, n_nodes, B, 3))
                lrec = recs["leaf_sums" if leaf else "hist_packed"]
                err = compare(lrec, H, ref, f"B={B} n={n} nodes={n_nodes}")
                repeat_identical(lrec, run, f"B={B} nodes={n_nodes}")
                checks.append({"kernel": "fused_round_level", "B": B, "bits": bits, "n": n,
                               "n_nodes": n_nodes, "leaf": leaf, "zero_frac": zf, "max_abs_err": err})
                if B != MAX_BINS or n != N_ROWS:
                    continue
                # time each launch of the main path's deepest level alone
                r_rec = recs["route_packed"]
                if not leaf:
                    r_ms, r_by = bound("route_packed", n=n, W=packed.shape[1], M=M, half=half)
                    r_spread = spread_ms(lambda: hk.route_packed(packed, parent, bf, bt, **kw))
                    r_rec.device_ms = device_ms(lambda: hk.route_packed(packed, parent, bf, bt, **kw))
                    r_rec.timing = (
                        r_spread[0],
                        spread_ms(lambda: hk.route_plain(binning.unpack_bins(cb), parent, bf, bt), reps=10)[0],
                        r_ms, r_by, None,
                    )
                    r_rec.spread = r_spread
                    run = lambda: hk.hist_level_packed(packed, node_out, vals, n_nodes=n_nodes, max_bins=B, **kw)
                    plain = lambda: hk.hist_plain(binning.unpack_bins(cb), node_out, vals, n_nodes, B, 3)
                    _, timing, dev_t = level_timing(lrec.name, run, plain, Xb, node_out, vals, packed, n_nodes, B, 3)
                    lrec.timing = (timing[0][0],) + timing[1:]
                    lrec.spread = timing[0]
                    lrec.device_ms, lrec.library_device_ms = dev_t
                else:
                    # the leaf pass as the main path makes it: one launch
                    # routes the parent ids and sums the leaves; its bound
                    # reads the packed words, parent ids, statistics and
                    # tables and writes the leaf ids and sums.  index_add_
                    # gets the routed cell ids for free
                    l_ms, l_by = bound("leaf_sums", n=n, M=M, C=C, leaves=n_nodes,
                                       W=packed.shape[1], half=half)
                    lidx = (torch.arange(M, device=dev)[None, :] * n_nodes + node_out.long()).reshape(-1)
                    lsrc = vals.reshape(-1, C)
                    lacc = torch.zeros(M * n_nodes, C, device=dev)
                    lib_add = lambda: lacc.index_add_(0, lidx, lsrc)
                    plain = lambda: hk.leaf_plain(hk.route_plain(binning.unpack_bins(cb), parent, bf, bt),
                                                  vals, n_nodes)
                    l_spread = spread_ms(run)
                    lrec.timing = (l_spread[0], spread_ms(plain, reps=10)[0], l_ms, l_by,
                                   spread_ms(lib_add)[0])
                    lrec.spread = l_spread
                    lrec.device_ms = device_ms(run)
                    lrec.library_device_ms = device_ms(lib_add)
    # the level histograms on shapes the main path does not reach: a
    # group of lanes on one cell in every step (every member's rows in one
    # node, one feature constant), 256 bins in 8-bit lanes, node tiling (32
    # and 64 nodes), one feature, and 33 features (a ragged feature tile)
    bins256 = binning.compute_bins(X, 256)
    Xb256 = binning.bin_features(X, bins256)
    one_cell = Xb64.clone()
    one_cell[:, 3] = 7
    X33 = torch.cat([Xb64, Xb64, Xb64[:, :1]], dim=1).contiguous()
    n = N_ROWS
    edge = [
        ("one_cell", one_cell, torch.full((n, M), 5, dtype=torch.int32, device=dev), 16, MAX_BINS),
        ("bins_256", Xb256, nodes(n, 16), 16, 256),
        ("nodes_32", Xb64, nodes(n, 32), 32, MAX_BINS),
        ("nodes_64", Xb64, nodes(n, 64), 64, MAX_BINS),
        ("d_1", Xb64[:, :1].contiguous(), nodes(n, 16), 16, MAX_BINS),
        ("d_33", X33, nodes(n, 16), 16, MAX_BINS),
    ]
    vals = stats(n)
    for what, ids, node, n_nodes, B in edge:
        d = ids.shape[1]
        bits = binning.pack_width(B)
        packed = binning.pack_bins(ids, B, bits).packed
        for rec, run, nterms in (
            (recs["hist_i32"], lambda: hk.hist_level_pallas(ids, node, vals, n_nodes=n_nodes, max_bins=B), 2),
            (recs["hist_packed"], lambda: hk.hist_level_packed(packed, node, vals, n_nodes=n_nodes, max_bins=B,
                                                               bits=bits, num_features=d), 3),
        ):
            err = check_level(rec, run, hk.hist_plain(ids, node, vals, n_nodes, B, nterms), what)
            checks.append({"kernel": rec.name, "shape": what, "n": n, "d": d, "B": B, "bits": bits,
                           "n_nodes": n_nodes, "max_abs_err": err})
    # the route and the leaf pass on shapes beside the main path's: one
    # member (the regressor), three channels, 256 bins, 64 and 256 leaves
    # (leaf tiles), more members than lanes and than one member tile holds,
    # a prime n with 25% zero-weight rows in 4-bit lanes, and no tables
    # (max_depth = 0, and leaf_sums alone on given ids)
    Xb_by_bins = {16: Xb16, MAX_BINS: Xb64, 256: Xb256}
    lr_edge = [
        ("M_1", N_ROWS, 1, 2, MAX_BINS, 16, 0.0),
        ("C_3", N_ROWS, M, 3, MAX_BINS, 16, 0.0),
        ("B_256", N_ROWS, M, 2, 256, 16, 0.0),
        ("leaves_64", N_ROWS, M, 2, MAX_BINS, 32, 0.0),
        ("leaves_256", N_ROWS, M, 2, MAX_BINS, 128, 0.0),
        ("M_40", N_ROWS, 40, 2, MAX_BINS, 16, 0.0),
        ("M_300", min(N_ROWS, 2000), 300, 2, MAX_BINS, 16, 0.0),
        ("prime_n_M_1_B_16", p, 1, 2, 16, 16, 0.25),
        ("max_depth_0", N_ROWS, M, 2, MAX_BINS, 0, 0.0),
        ("ids_given_32", N_ROWS, M, 2, MAX_BINS, 0, 0.0),
    ]
    for what, n, Mc, Cc, B, half, zf in lr_edge:
        ids = Xb_by_bins[B][:n].contiguous()
        bits = binning.pack_width(B)
        packed = binning.pack_bins(ids, B, bits).packed
        kw = dict(max_bins=B, bits=bits, num_features=N_FEATURES)
        v = rng.randn(n, Mc, Cc).astype(np.float32)
        v[: int(n * zf)] = 0.0
        vals = torch.as_tensor(v, device=dev)
        row = {"shape": what, "n": n, "M": Mc, "C": Cc, "B": B, "bits": bits}
        if half:
            parent = torch.as_tensor(rng.randint(0, half, size=(n, Mc)).astype(np.int32), device=dev)
            bf = torch.as_tensor(rng.randint(0, N_FEATURES, size=(Mc, half)).astype(np.int32), device=dev)
            bt = torch.as_tensor(rng.randint(0, B, size=(Mc, half)).astype(np.int32), device=dev)
            ref_node = hk.route_plain(ids, parent, bf, bt)
            run_r = lambda: hk.route_packed(packed, parent, bf, bt, bits=bits, num_features=N_FEATURES)
            compare(recs["route_packed"], run_r(), ref_node, what, exact=True)
            repeat_identical(recs["route_packed"], run_r, what)
            n_nodes = 2 * half
            run_l = lambda: hk.fused_round_level(packed, parent, vals, bf, bt, n_nodes=n_nodes, leaf=True, **kw)
        elif what == "max_depth_0":
            ref_node, n_nodes = torch.zeros((n, Mc), dtype=torch.int32, device=dev), 1
            run_l = lambda: hk.fused_round_level(packed, ref_node, vals, n_nodes=n_nodes, leaf=True, **kw)
        else:
            n_nodes = 32
            ref_node = torch.as_tensor(rng.randint(0, n_nodes, size=(n, Mc)).astype(np.int32), device=dev)
            run_l = lambda: (hk.leaf_sums(ref_node, vals, n_nodes=n_nodes), ref_node)
        L, leaf_ids = run_l()
        compare(recs["leaf_sums"], leaf_ids, ref_node, what, exact=True)
        err = compare(recs["leaf_sums"], L, hk.leaf_plain(ref_node, vals, n_nodes), what)
        repeat_identical(recs["leaf_sums"], run_l, what)
        plan = hk.leaf_plan(n, Mc, Cc, n_nodes, half)
        checks.append({"kernel": "leaf_sums", **row, "n_nodes": n_nodes, "routed": bool(half),
                       "max_abs_err": err, "plan": plan._asdict()})
    # the forests' shapes (Bagging, Boosting): the classifiers on letter,
    # C = 1 + 26 statistics, and the regressors on the cpusmall-shaped data
    # (8192 x 12, 3 packed words a row), C = 2; M=10 members with
    # Poisson-count weights (zero rows included) and per-member feature
    # masks, and M=1 (one boosting tree, a near-empty card).  The level
    # histograms at levels 0 and 4, the route into level 4 and the routed
    # leaf pass from 1 and from 16 parents, each held, repeated and timed
    # on the card beside its bound and one index_add_ over the same cell
    # ids (the route has no such call)
    from spark_ensemble_tpu_torch.utils import random as rnd

    bits8 = binning.pack_width(MAX_BINS)

    def forest_shapes(data, Xb, targets, members=(10, 1)):
        """Every kernel of a forest fit at ``Xb`` (binned at MAX_BINS) with
        ``targets [n, k]``: statistics [w, w * (target - member mean)], for
        each member count in ``members``."""
        n, d = Xb.shape
        packed = binning.pack_bins(Xb, MAX_BINS, bits8).packed
        kw = dict(bits=bits8, num_features=d)
        Cc = 1 + targets.shape[1]

        def tables(Mc, half, masks):
            """Split tables over each member's unmasked features."""
            allowed = masks.cpu().numpy()
            bf = np.stack([rng.choice(np.flatnonzero(allowed[m]), size=half) for m in range(Mc)])
            bt = rng.randint(0, MAX_BINS, size=(Mc, half))
            return (torch.as_tensor(bf.astype(np.int32), device=dev),
                    torch.as_tensor(bt.astype(np.int32), device=dev))

        def shape_row(rec, run, shapes, plan, library, **row):
            b_ms, b_by = bound(rec.name, **shapes)
            rec.shapes.append({**row, "device_ms": device_ms(run), "bound_ms": b_ms,
                               "bound_by": b_by,
                               "library_device_ms": device_ms(library) if library else None,
                               "grid": plan.grid, "plan": plan._asdict()})

        for Mc in members:
            keys = rnd.fold_in(rnd.PRNGKey(0, dev), torch.arange(Mc, device=dev))
            w = rnd.bootstrap_weights(rnd.fold_in(keys, 0), n, True, 1.0).T.contiguous()
            masks = rnd.subspace_mask(rnd.fold_in(keys, 1), d, 0.5)
            t_mean = (w.T @ targets) / w.sum(dim=0)[:, None]
            vals = torch.cat([w[:, :, None], w[:, :, None] * (targets[:, None, :] - t_mean[None])],
                             dim=2).contiguous()
            common = {"data": data, "n": n, "d": d, "W": packed.shape[1], "M": Mc, "C": Cc,
                      "zero_weight_rows": float((w == 0).float().mean())}
            for level in (0, DEPTH - 1):
                n_nodes = 2**level
                node = torch.as_tensor(rng.randint(0, n_nodes, size=(n, Mc)).astype(np.int32), device=dev)
                out_floats = Mc * n_nodes * Cc * d * MAX_BINS
                cells = (((torch.arange(Mc, device=dev)[None, :] * n_nodes + node.long())[:, :, None, None] * Cc
                          + torch.arange(Cc, device=dev)[None, None, :, None]) * d
                         + torch.arange(d, device=dev)[None, None, None, :]) * MAX_BINS \
                    + Xb.long()[:, None, None, :]
                cells = cells.reshape(-1)
                src = vals[:, :, :, None].expand(n, Mc, Cc, d).reshape(-1)
                acc = torch.zeros(out_floats, device=dev)
                lib = lambda: acc.index_add_(0, cells, src)
                for rec, run, words, nterms, bits in (
                    (recs["hist_packed"], lambda: hk.hist_level_packed(
                        packed, node, vals, n_nodes=n_nodes, max_bins=MAX_BINS, **kw), packed, 3, bits8),
                    (recs["hist_i32"], lambda: hk.hist_level_pallas(
                        Xb, node, vals, n_nodes=n_nodes, max_bins=MAX_BINS), Xb, 2, 32),
                ):
                    what = f"{data} M={Mc} C={Cc} level {level}"
                    err = check_level(rec, run, hk.hist_plain(Xb, node, vals, n_nodes, MAX_BINS, nterms), what)
                    plan = hk.level_plan(n, d, Mc, Cc, MAX_BINS, n_nodes, bits)
                    shape_row(rec, run, dict(n=n, d=d, W=words.shape[1], M=Mc, C=Cc, B=MAX_BINS,
                                             n_nodes=n_nodes),
                              plan, lib, **common, level=level, n_nodes=n_nodes)
                    checks.append({"kernel": rec.name, **common, "level": level, "n_nodes": n_nodes,
                                   "max_abs_err": err})
                del cells, src, acc
            # the route into level 4 (8 parents), tables over unmasked features
            parent = torch.as_tensor(rng.randint(0, 8, size=(n, Mc)).astype(np.int32), device=dev)
            bf, bt = tables(Mc, 8, masks)
            run_r = lambda: hk.route_packed(packed, parent, bf, bt, **kw)
            rrec = recs["route_packed"]
            what = f"{data} M={Mc} C={Cc}"
            compare(rrec, run_r(), hk.route_plain(Xb, parent, bf, bt), what, exact=True)
            repeat_identical(rrec, run_r, what)
            shape_row(rrec, run_r, dict(n=n, W=packed.shape[1], M=Mc, half=8),
                      hk.route_plan(n, Mc, 8, packed.shape[1]), None, **common, half=8)
            checks.append({"kernel": rrec.name, **common, "half": 8, "max_abs_err": 0.0})
            # the routed leaf pass of a depth-1 tree (1 parent) and of depth 5
            lrec = recs["leaf_sums"]
            for half in (1, 2 ** (DEPTH - 1)):
                parent = torch.as_tensor(rng.randint(0, half, size=(n, Mc)).astype(np.int32), device=dev)
                bf, bt = tables(Mc, half, masks)
                run_l = lambda: hk.fused_round_level(packed, parent, vals, bf, bt, n_nodes=2 * half,
                                                     max_bins=MAX_BINS, leaf=True, **kw)
                L, leaf_ids = run_l()
                ref_node = hk.route_plain(Xb, parent, bf, bt)
                what = f"{data} M={Mc} C={Cc} leaves={2 * half}"
                compare(lrec, leaf_ids, ref_node, what, exact=True)
                err = compare(lrec, L, hk.leaf_plain(ref_node, vals, 2 * half), what)
                repeat_identical(lrec, run_l, what)
                lidx = (torch.arange(Mc, device=dev)[None, :] * (2 * half) + ref_node.long()).reshape(-1)
                lsrc = vals.reshape(-1, Cc)
                lacc = torch.zeros(Mc * 2 * half, Cc, device=dev)
                shape_row(lrec, run_l, dict(n=n, M=Mc, C=Cc, leaves=2 * half, W=packed.shape[1],
                                            half=half),
                          hk.leaf_plan(n, Mc, Cc, 2 * half, half),
                          lambda: lacc.index_add_(0, lidx, lsrc), **common, leaves=2 * half)
                checks.append({"kernel": lrec.name, **common, "leaves": 2 * half, "routed": True,
                               "max_abs_err": err})

    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(letter_data()[1], device=dev).long(), N_CLASSES).to(torch.float32)
    forest_shapes("letter", Xb64, onehot)
    Xr_np, yr_np = regression_data()
    Xr_d = torch.as_tensor(Xr_np, device=dev)
    forest_shapes("cpusmall", binning.bin_features(Xr_d, binning.compute_bins(Xr_d, MAX_BINS)),
                  torch.as_tensor(yr_np, device=dev)[:, None])
    # adult's shapes: 123 features in 31 packed words a row, one tree (M=1)
    # at C=2 (a binary GBM round) and C=3 (a classifier tree on 2 classes)
    Xa_np, ya_np = adult_data()
    Xa_d = torch.as_tensor(Xa_np, device=dev)
    Xba = binning.bin_features(Xa_d, binning.compute_bins(Xa_d, MAX_BINS))
    ya_d = torch.as_tensor(ya_np, device=dev)
    forest_shapes("adult", Xba, ya_d[:, None], members=(1,))
    forest_shapes("adult", Xba, torch.nn.functional.one_hot(ya_d.long(), 2).to(torch.float32),
                  members=(1,))

    for row in checks:
        emit({"phase": "kernel_check", **row})
    # the level histograms on tall rows, where a tile's rows take several
    # clusters (tall_rows_phase)
    tall_rows_phase(torch, hk, binning, dev)
    # the kernels on Epsilon's 500-word rows, the leaf pass gathering
    # (wide_rows_phase)
    wide_rows_phase(torch, hk, binning, dev)
    # the compact level histograms over row lists (row_lists_phase)
    row_lists_phase(torch, hk, binning, dev)

    # phase 4: the main path through the public estimators
    def gbm(hist, hist_precision, rounds):
        return st.GBMClassifier(
            num_base_learners=rounds, loss="logloss", updates="newton",
            learning_rate=0.3, optimized_weights=True,
            base_learner=st.DecisionTreeRegressor(
                max_depth=DEPTH, max_bins=MAX_BINS, hist=hist,
                hist_precision=hist_precision,
            ),
        )

    def fit_counted(est, X_, y_):
        hk.reset_launch_counts()
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
        t0 = time.perf_counter()
        model = est.fit(X_, y_, device="cuda")
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0, dict(hk.LAUNCHES)

    def proba_gap(pa, pb):
        gap = (pa - pb).abs()
        return float(gap.max()), float((gap.max(dim=1).values > 1e-3).float().mean())

    tiers = (("matmul", "matmul", "highest"), ("pallas", "matmul", "pallas"),
             ("fused", "fused", "highest"))

    # 4a: the JAX package's pins on the card, with their data and config:
    # fused vs matmul probabilities within 1e-3 and accuracy within 0.02
    # (tests/test_pallas_hist.py::test_fused_gbm_letter_leg_parity); the
    # pallas tier's 2-term bf16 statistics can flip near-tie splits, so the
    # JAX package pins it on accuracy alone (test_gbm_with_pallas_tier_
    # metric_parity), and so does this check
    rng_pin = np.random.RandomState(15)
    Xp = rng_pin.randn(800, 8).astype(np.float32)
    yp = np.argmax(Xp @ rng_pin.randn(4, 8).astype(np.float32).T, axis=1).astype(np.float32)
    pin = {}
    for tier, hist, hp in tiers:
        m = st.GBMClassifier(
            num_base_learners=3, learning_rate=0.5, seed=0,
            base_learner=st.DecisionTreeRegressor(hist=hist, hist_precision=hp, max_bins=16),
        ).fit(Xp, yp, device="cuda")
        pin[tier] = (m.predict_proba(Xp), float((m.predict(Xp).cpu().numpy() == yp).mean()))
    for tier in ("pallas", "fused"):
        diff, _ = proba_gap(pin[tier][0], pin["matmul"][0])
        acc_diff = pin[tier][1] - pin["matmul"][1]
        emit({"phase": "parity_pin", "tier": tier, "vs": "matmul", "proba_max_abs_diff": diff,
              "accuracy_diff": acc_diff})
        if (tier == "fused" and diff > 1e-3) or abs(acc_diff) > 0.02:
            raise AssertionError(f"{tier} vs matmul on the pin: proba {diff}, accuracy {acc_diff}")

    # 4b: the main path at letter's full width, one round: a near-tie
    # split may flip between tiers, so the fused tier is held on the share
    # of rows whose probabilities move by more than 1e-3 (the pallas tier's
    # share is reported; its pin is accuracy, as above)
    X_np, y_np = letter_data()
    one = {tier: fit_counted(gbm(hist, hp, 1), X_np, y_np)[0].predict_proba(X_np)
           for tier, hist, hp in tiers}
    for tier in ("pallas", "fused"):
        diff, share = proba_gap(one[tier], one["matmul"])
        emit({"phase": "parity_one_round", "tier": tier, "vs": "matmul",
              "proba_max_abs_diff": diff, "rows_beyond_1e-3": share})
        if tier == "fused" and share > 0.01:
            raise AssertionError(f"{tier} vs matmul after one round: {share} of rows beyond 1e-3")

    # 4c: the main path, 20 rounds per tier, launches counted from 0 for
    # each run.  Boosting amplifies any split flip round after round, so
    # the tiers are held to the JAX package's accuracy pin; the scatter
    # tier (exact f32, another summation order) shows how far two exact
    # tiers drift apart on the same data
    runs = {}
    for tier, hist, hp in tiers + (("scatter", "scatter", "highest"),):
        model, secs, launches = fit_counted(gbm(hist, hp, PARITY_ROUNDS), X_np, y_np)
        proba = model.predict_proba(X_np)
        acc = float((model.predict(X_np).cpu().numpy() == y_np).mean())
        if not bool(torch.isfinite(proba).all()) or proba.shape != (N_ROWS, N_CLASSES):
            raise AssertionError(f"{tier}: predict_proba not finite of shape {(N_ROWS, N_CLASSES)}")
        runs[tier] = (proba, acc, launches)
        emit({"phase": "main_path", "tier": tier, "rounds": PARITY_ROUNDS, "fit_s": secs,
              "iters_per_s": PARITY_ROUNDS / secs, "train_accuracy": acc, "launches": launches})
    R = PARITY_ROUNDS
    expected = {
        "matmul": {k: 0 for k in hk.LAUNCHES},
        "pallas": {"hist_i32": DEPTH * R, "route_packed": 0, "hist_packed": 0, "leaf_sums": 0},
        "fused": {"hist_i32": 0, "route_packed": (DEPTH - 1) * R, "hist_packed": DEPTH * R, "leaf_sums": R},
    }
    for tier, want in expected.items():
        if runs[tier][2] != want:
            raise AssertionError(f"{tier} launches {runs[tier][2]} != expected {want}")
    recs["hist_i32"].launches = runs["pallas"][2]["hist_i32"]
    for k in ("route_packed", "hist_packed", "leaf_sums"):
        recs[k].launches = runs["fused"][2][k]
    p_ref, a_ref, _ = runs["matmul"]
    for tier in ("pallas", "fused", "scatter"):
        diff, share = proba_gap(runs[tier][0], p_ref)
        acc_diff = runs[tier][1] - a_ref
        emit({"phase": "parity", "tier": tier, "vs": "matmul", "rounds": R,
              "proba_max_abs_diff": diff, "rows_beyond_1e-3": share, "accuracy_diff": acc_diff})
        if abs(acc_diff) > 0.02:
            raise AssertionError(f"{tier} vs matmul: accuracy {runs[tier][1]} vs {a_ref}")

    # timed fused fit and predict: the fit rate follows the host, which
    # other work may share, so three fits are timed and the median reported
    timed = [fit_counted(gbm("fused", "highest", TIMED_ROUNDS), X_np, y_np) for _ in range(3)]
    rates = sorted(TIMED_ROUNDS / t[1] for t in timed)
    model = timed[-1][0]
    if any(t[2]["hist_packed"] != DEPTH * TIMED_ROUNDS for t in timed):
        raise AssertionError(f"timed fused fit launches {[t[2] for t in timed]}")
    Xd = torch.as_tensor(X_np, device=dev)
    model.predict(Xd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        pred = model.predict(Xd)
    torch.cuda.synchronize()
    pred_s = (time.perf_counter() - t0) / reps
    acc = float((pred.cpu().numpy() == y_np).mean())
    # the fused tier's kernels per round: the histogram at each level as
    # timed there, the routes and the leaf pass (their time hardly depends
    # on the level), each times its launches per round; on the card's own
    # time (device_ms) and through the wrappers (ms)
    per_round = {k: runs["fused"][2][k] / R for k in ("route_packed", "leaf_sums")}
    per_round_ms = (sum(lvl["device_ms"][0] for lvl in recs["hist_packed"].per_level)
                    + sum(n * recs[k].device_ms[0] for k, n in per_round.items()))
    per_round_wrapper_ms = (sum(lvl["ms"] for lvl in recs["hist_packed"].per_level)
                            + sum(n * recs[k].timing[0] for k, n in per_round.items()))
    emit({"phase": "timed_fit", "tier": "fused", "rounds": TIMED_ROUNDS, "fits": len(timed),
          "iters_per_s": rates[1], "iters_per_s_runs": rates, "round_ms": 1e3 / rates[1],
          "per_round_ms": per_round_ms, "per_round_wrapper_ms": per_round_wrapper_ms,
          "predict_rows_per_s": N_ROWS / pred_s, "predict_s": pred_s, "train_accuracy": acc})

    # gbm_members: member(i, dim) of the timed 26-class model.  A member's
    # predict takes the same leaf lookup (ops/tree.predict_forest) as the
    # model's stacked forest predict, so it must equal that tree's row bit
    # for bit.  Over every round, init_raw[0] + sum_i w[i, 0] * member(i, 0)
    # summed in f64 must match predict_raw's column 0 (an f32 pairwise sum
    # of the same rounded products) within 1e-6 of the row's sum of
    # |terms|: a pairwise f32 sum of 100 terms errs by at most about
    # 7 * 2^-24 of it.  Every member lives on the card.
    t0 = time.perf_counter()
    Xm = Xd[:4096]
    members, weights = model.params["members"], model.params["weights"]
    r, dim = weights.shape
    flat = type(members)(*(a.reshape((r * dim,) + a.shape[2:]) for a in members))
    forest = model._base().predict_many_fn(flat, Xm).reshape(r, dim, -1)
    exact = {}
    on_card = True
    for i, d in ((0, 0), (r - 1, dim - 1), (r // 2, 13)):
        m_ = model.member(i, dim=d)
        on_card &= all(t.is_cuda for t in m_.params)
        exact[f"{i},{d}"] = bool(torch.equal(m_.predict(Xm), forest[i, d]))
    terms = []
    for i in range(r):
        m_ = model.member(i, 0)
        on_card &= all(t.is_cuda for t in m_.params)
        terms.append(weights[i, 0] * m_.predict(Xm))
    # the f64 reference is summed on the host: the f32 policy (the lint's
    # f64-upcast rule) keeps float64 off the card
    terms = torch.stack(terms).cpu().numpy().astype(np.float64)
    init0 = float(model.params["init_raw"][0])
    ref = init0 + terms.sum(axis=0)
    scale = abs(init0) + np.abs(terms).sum(axis=0)
    raw0 = model.predict_raw(Xm)[:, 0].cpu().numpy().astype(np.float64)
    sum_err = float((np.abs(raw0 - ref) / scale).max())
    emit({"phase": "gbm_members", "rounds": r, "class_dims": dim, "rows": int(Xm.shape[0]),
          "member_equals_forest_row": exact, "sum_rel_err_d0": sum_err, "sum_tol": 1e-6,
          "members_on_cuda": on_card, "check_s": time.perf_counter() - t0, "card": smi})
    if not all(exact.values()) or sum_err > 1e-6 or not on_card:
        raise AssertionError(f"gbm_members: exact {exact}, sum {sum_err}, on card {on_card}")

    # where a fused fit's time goes: device time by kernel over a fit
    # (setup included), counting device-side events only (the CPU ops
    # that launched them carry the same time again)
    def profile_fit(est, X_, y_, store=None, **row):
        """``store``: trace ``est.fit_streaming(store, y_)`` instead."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if store is None:
                _, wall, _ = fit_counted(est, X_, y_)
            else:
                torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
                t0 = time.perf_counter()
                est.fit_streaming(store, y_, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        dev_us, host_calls, host_us = {}, {}, {}
        for e in prof.key_averages():
            # host-side scalar reads (each one waits for the device) and launches
            if e.key in ("aten::_local_scalar_dense", "cudaLaunchKernel",
                         "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaStreamSynchronize"):
                host_calls[e.key] = e.count
            if e.device_type != DeviceType.CUDA:
                host_us[e.key] = e.self_cpu_time_total
                continue
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            if t > 0:
                dev_us[e.key] = t
        ours = sum(t for k, t in dev_us.items()
                   if any(s in k for s in ("level_hist", "leaf_sums", "route_packed")))
        busy = sum(dev_us.values())
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        emit({"phase": "profile", **row, "wall_ms": wall * 1e3,
              "device_busy_ms": busy / 1e3 if busy else None,
              "port_kernels_ms": ours / 1e3 if busy else None,
              "idle_share": 1 - busy / 1e3 / (wall * 1e3) if busy else None,
              "host_calls": host_calls,
              "top_device_us": [[k[:60], t] for k, t in top],
              "top_host_self_us": [[k[:60], t] for k, t in
                                   sorted(host_us.items(), key=lambda kv: -kv[1])[:6]]})

    profile_fit(gbm("fused", "highest", 3), X_np, y_np, tier="fused", rounds=3)

    # GBMRegressor (squared loss) on the fused tier vs the matmul tier
    Xr, yr = regression_data()
    rmses = {}
    for hist in ("fused", "matmul"):
        reg = st.GBMRegressor(num_base_learners=PARITY_ROUNDS, learning_rate=0.3,
                              base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, hist=hist))
        model, secs, launches = fit_counted(reg, Xr, yr)
        rmse = float(torch.sqrt(torch.mean((model.predict(Xr) - torch.as_tensor(yr, device=dev)) ** 2)))
        rmses[hist] = rmse
        emit({"phase": "regressor", "tier": hist, "rounds": PARITY_ROUNDS, "fit_s": secs,
              "rmse": rmse, "launches": launches})
        if hist == "fused" and launches != expected["fused"]:
            raise AssertionError(f"regressor fused launches {launches}")
        if not math.isfinite(rmse) or rmse > float(np.std(yr)):
            raise AssertionError(f"regressor {hist}: rmse {rmse}")
    if abs(rmses["fused"] - rmses["matmul"]) > 0.02 * rmses["matmul"]:
        raise AssertionError(f"regressor fused vs matmul rmse: {rmses}")

    # phase 5: the random draws on the card against the same functions on
    # the CPU, bit for bit.  Keys, bits, uniforms, Bernoulli masks and
    # randint are integer or exactly rounded work; Poisson counts sum logs,
    # whose last bit differs between the devices (reported as the log's ulp
    # gap), so poisson() takes them on the CPU and its counts must agree too
    cpu = torch.device("cpu")
    draws = {}
    for name, fn in (
        ("keys", lambda d: torch.cat([rnd.split(rnd.PRNGKey(0, d), 7),
                                      rnd.fold_in(rnd.PRNGKey(42, d), torch.arange(10, device=d))])),
        ("bits", lambda d: rnd.random_bits(rnd.PRNGKey(1, d), (N_ROWS,))),
        ("uniform", lambda d: rnd.uniform(rnd.PRNGKey(2, d), (N_ROWS,))),
        ("bernoulli", lambda d: rnd.bernoulli(rnd.PRNGKey(3, d), 0.5, (N_ROWS,))),
        ("randint", lambda d: rnd.randint(rnd.PRNGKey(4, d), (N_ROWS,), 0, N_FEATURES)),
        ("bagging_plan_bernoulli", lambda d: st.BaggingClassifier(
            num_base_learners=10, subspace_ratio=0.5, replacement=False, subsample_ratio=0.8,
        )._member_plan(N_ROWS, N_FEATURES, torch.ones(N_ROWS, device=d))),
    ):
        got, want = fn(dev), fn(cpu)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        if not all(torch.equal(a.cpu(), b) for a, b in pairs):
            raise AssertionError(f"draws: {name} differs between the card and the CPU")
        draws[name] = "equal"
    plan_dev = st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5)._member_plan(
        N_ROWS, N_FEATURES, torch.ones(N_ROWS, device=dev))
    plan_cpu = st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5)._member_plan(
        N_ROWS, N_FEATURES, torch.ones(N_ROWS))
    poisson_diff = int((plan_dev[0].cpu() != plan_cpu[0]).sum())
    if not torch.equal(plan_dev[1].cpu(), plan_cpu[1]):
        raise AssertionError("draws: the Bagging plan's feature masks differ")
    if poisson_diff:
        raise AssertionError(f"draws: {poisson_diff} Poisson counts differ between the card and the CPU")
    u = rnd.uniform(rnd.PRNGKey(5, dev), (N_ROWS,))
    log_bits = torch.log(u).cpu().view(torch.int32).long() - torch.log(u.cpu()).view(torch.int32).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5)._member_plan(
        N_ROWS, N_FEATURES, torch.ones(N_ROWS, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "draws", **draws, "poisson_counts_differing": poisson_diff,
          "poisson_counts": int(plan_dev[0].numel()), "log_max_ulp_gap": int(log_bits.abs().max()),
          "log_values_differing": int((log_bits != 0).sum()),
          "bagging_plan_ms": (time.perf_counter() - t0) * 1e3})

    # phases 6-8: the families through their public estimators, each fit's
    # launches counted from 0 (fit_counted).  One forest fit for all Bagging
    # members, one tree a Boosting round: 5 histograms, 4 routes and 1 leaf
    # pass per fit or round on the fused tier, 5 hist_i32 on the pallas tier
    def per_fit(r):
        return {"hist_i32": 0, "route_packed": (DEPTH - 1) * r, "hist_packed": DEPTH * r, "leaf_sums": r}

    want_launches = {"matmul": lambda r: {k: 0 for k in hk.LAUNCHES}, "fused": per_fit,
                     "scatter": lambda r: {k: 0 for k in hk.LAUNCHES},
                     "pallas": lambda r: {"hist_i32": DEPTH * r, "route_packed": 0, "hist_packed": 0,
                                          "leaf_sums": 0}}

    def cls_tree(hist, hp="highest"):
        return st.DecisionTreeClassifier(max_depth=DEPTH, max_bins=MAX_BINS, hist=hist, hist_precision=hp)

    def reg_tree(hist):
        return st.DecisionTreeRegressor(max_depth=DEPTH, max_bins=MAX_BINS, hist=hist)

    def accuracy(model, X_, y_):
        pred = model.predict(X_)
        if not bool(torch.isfinite(pred).all()) or pred.shape != (len(y_),):
            raise AssertionError(f"{type(model).__name__}: predictions not finite of shape {(len(y_),)}")
        return float((pred.cpu().numpy() == y_).mean())

    def rmse(model, X_, y_):
        pred = model.predict(X_)
        out = float(torch.sqrt(torch.mean((pred - torch.as_tensor(y_, device=dev)) ** 2)))
        if not math.isfinite(out) or out > float(np.std(y_)):
            raise AssertionError(f"{type(model).__name__}: rmse {out}")
        return out

    def coverage(model, X_, y_):
        """The share of rows at or below the prediction (a quantile model's
        calibration: alpha when it fits)."""
        pred = model.predict(X_)
        if not bool(torch.isfinite(pred).all()) or pred.shape != (len(y_),):
            raise AssertionError(f"{type(model).__name__}: predictions not finite of shape {(len(y_),)}")
        return float((torch.as_tensor(y_, device=dev) <= pred).float().mean())

    def family_run(phase, family, tier, est, X_, y_, rounds_of, metric):
        model, secs, launches = fit_counted(est, X_, y_)
        r = rounds_of(model, launches)
        if launches != want_launches[tier](r):
            raise AssertionError(f"{family} {tier}: launches {launches} for {r} fits")
        value = metric(model, X_, y_)
        row = {"phase": phase, "family": family, "tier": tier, "fit_s": secs,
               "rows_per_s": len(y_) / secs, "fits": r, "launches": launches,
               metric.__name__: value}
        if hasattr(model, "num_members"):
            row["members_kept"] = model.num_members
        emit(row)
        return model, value

    def near(family, values, metric, tol):
        ref = values["matmul"]
        for tier, v in values.items():
            gap = abs(v - ref) if metric in ("accuracy", "coverage") else abs(v - ref) / ref
            if gap > tol:
                raise AssertionError(f"{family} {tier} vs matmul: {metric} {v} vs {ref}")

    # Bagging: ten members with Poisson weights and half the features, on
    # letter; the regressor on the cpusmall-shaped data
    bag_acc, fused_members = {}, {}  # the fused models, for the member sums
    for tier, hist, hp in tiers:
        est = st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5, base_learner=cls_tree(hist, hp))
        m_, bag_acc[tier] = family_run("bagging", "BaggingClassifier", tier, est, X_np, y_np,
                                       lambda m, launches: 1, accuracy)
        if tier == "fused":
            fused_members["BaggingClassifier[hard]"] = (m_, "predict_proba", X_np)
            fused_members["BaggingClassifier[soft]"] = (
                m_.copy(voting_strategy="soft"), "predict_proba", X_np)
    near("BaggingClassifier", bag_acc, "accuracy", 0.02)
    bag_rmse = {}
    for tier in ("matmul", "fused"):
        est = st.BaggingRegressor(num_base_learners=10, subspace_ratio=0.5, base_learner=reg_tree(tier))
        m_, bag_rmse[tier] = family_run("bagging", "BaggingRegressor", tier, est, Xr, yr,
                                        lambda m, launches: 1, rmse)
        if tier == "fused":
            fused_members["BaggingRegressor"] = (m_, "predict", Xr)
    near("BaggingRegressor", bag_rmse, "rmse", 0.02)

    # Boosting: 20 rounds, one tree a round; a dropped round (SAMME's
    # err >= 1 - 1/K, Drucker's estErr >= 0.5) was fitted too.  The first
    # round fits uniform weights, so class counts can make exact gain
    # ties, which the tiers' summation orders may break differently, and
    # each later round carries a flip on.  At this size none showed on
    # the card, so the first round is held to at most 1% of rows moved
    # (as the GBM path's one-round check) and the 20-round accuracy or
    # RMSE to matmul's within 0.02, with the kept rounds beside them
    def boost_rounds(model, launches):
        r = launches["leaf_sums"] if launches["leaf_sums"] else model.num_members
        if r not in (model.num_members, model.num_members + 1):
            raise AssertionError(f"{r} fused fits for {model.num_members} kept rounds")
        return r

    def first_round_moved(family, models, X_, differ):
        """The share of rows the two tiers' first rounds predict
        differently: at most 1%."""
        if min(m.num_members for m in models.values()) < 1:
            raise AssertionError(f"{family}: a tier kept no round")
        moved = float(differ(models["fused"].take(1).predict(X_),
                             models["matmul"].take(1).predict(X_)).float().mean())
        emit({"phase": "boosting_first_round", "family": family, "tier": "fused", "vs": "matmul",
              "rows_moved": moved,
              "members_kept": {t: m.num_members for t, m in models.items()}})
        if moved > 0.01:
            raise AssertionError(f"{family} fused vs matmul after one round: {moved} of rows moved")

    for algorithm in ("discrete", "real"):
        family = f"BoostingClassifier[{algorithm}]"
        models, accs = {}, {}
        for tier in ("matmul", "fused"):
            est = st.BoostingClassifier(num_base_learners=PARITY_ROUNDS, algorithm=algorithm,
                                        base_learner=cls_tree(tier))
            models[tier], accs[tier] = family_run("boosting", family, tier, est, X_np, y_np,
                                                  boost_rounds, accuracy)
        first_round_moved(family, models, X_np, torch.ne)
        near(family, accs, "accuracy", 0.02)
        fused_members[family] = (models["fused"], "predict_proba", X_np)
    models, rmses_b = {}, {}
    for tier in ("matmul", "fused"):
        est = st.BoostingRegressor(num_base_learners=PARITY_ROUNDS, voting_strategy="median",
                                   base_learner=reg_tree(tier))
        models[tier], rmses_b[tier] = family_run("boosting", "BoostingRegressor[median]", tier, est,
                                                 Xr, yr, boost_rounds, rmse)
    first_round_moved("BoostingRegressor[median]", models, Xr,
                      lambda a, b: (a - b).abs() > 1e-3 * float(np.std(yr)))
    near("BoostingRegressor[median]", rmses_b, "rmse", 0.02)
    fused_members["BoostingRegressor[median]"] = (models["fused"], "predict", Xr)
    fused_members["BoostingRegressor[mean]"] = (
        models["fused"].copy(voting_strategy="mean"), "predict", Xr)

    # member sums: Boosting's and Bagging's sums over their members run by
    # a fixed pairwise tree, so a row predicted alone equals the same row
    # in a 4096-row batch, bit for bit on the card
    sums = {}
    for family, (m_, method, X_) in fused_members.items():
        batch = getattr(m_, method)(X_[:4096])
        sums[family] = all(bool(torch.equal(getattr(m_, method)(X_[i:i + 1])[0], batch[i]))
                           for i in (0, 1, 4095))
    emit({"phase": "member_sums", "one_row_equals_batch_row": sums})
    if not all(sums.values()):
        raise AssertionError(f"member sums: a one-row predict parts from its batch row: {sums}")

    # GBM with row and feature sampling: the main path's classifier with
    # subsample_ratio and subspace_ratio 0.8
    sampled = {}
    for tier in ("matmul", "fused"):
        est = gbm(tier, "highest", PARITY_ROUNDS).set_params(subsample_ratio=0.8, subspace_ratio=0.8)
        _, sampled[tier] = family_run("gbm_sampled", "GBMClassifier[sampled]", tier, est, X_np, y_np,
                                      lambda m, launches: PARITY_ROUNDS, accuracy)
    near("GBMClassifier[sampled]", sampled, "accuracy", 0.02)

    # phase 9 (losses): GBM's other seven losses, 20 rounds each.  The
    # regressors on the 8192x12 data on the fused, scatter and matmul
    # tiers: fused held to scatter's RMSE within 2% (both sum a node's
    # statistics in an order fixed from run to run; on the CPU their
    # 20-round fits agree to 1e-5; with index_add_'s atomics the scatter
    # tier's huber fit took the other branch of the round-8 near tie in
    # one run of six, 0.527 against 0.625) and to matmul's within 10%,
    # since a near-tie split flip
    # compounds through the rounds (huber: one bin flips at round 8 with
    # gains 10.4060 against 10.4068, and the adaptive delta carries it to a
    # 9% RMSE gap, the same on the CPU); the 0.9-quantile model by its
    # coverage (the share of rows at or below it) within 0.02.  Brent's
    # step search is a host loop, so these fits are host-bound.  The
    # binary classifiers on adult-shaped data (one d=123 tree a round),
    # held to matmul's accuracy within 0.02
    def reg_gbm(loss, hist):
        return st.GBMRegressor(num_base_learners=PARITY_ROUNDS, learning_rate=0.3, loss=loss,
                               alpha=0.9, base_learner=reg_tree(hist))

    for loss in ("absolute", "huber", "quantile", "logcosh", "scaledlogcosh"):
        vals = {}
        metric = coverage if loss == "quantile" else rmse
        for tier in ("fused", "scatter", "matmul"):
            model, vals[tier] = family_run("losses", f"GBMRegressor[{loss}]", tier,
                                           reg_gbm(loss, tier), Xr, yr,
                                           lambda m, launches: PARITY_ROUNDS, metric)
            if tier == "scatter":
                # the scatter tier sums in a fixed order on the card, so a
                # second fit repeats the first bit for bit
                again = reg_gbm(loss, tier).fit(Xr, yr, device="cuda")
                if not torch.equal(again.predict(Xr), model.predict(Xr)):
                    raise AssertionError(f"GBMRegressor[{loss}] scatter: a second fit differs")
            if loss == "huber":
                delta = model.params["huber_delta"]
                emit({"phase": "losses", "family": "GBMRegressor[huber]", "tier": tier,
                      "huber_delta_first": float(delta[0]), "huber_delta_last": float(delta[-1]),
                      "rounds": int(delta.numel())})
        near(f"GBMRegressor[{loss}]", {"matmul": vals["scatter"], "fused": vals["fused"]},
             metric.__name__, 0.02)
        near(f"GBMRegressor[{loss}]", vals, metric.__name__, 0.02 if loss == "quantile" else 0.1)
    for loss in ("bernoulli", "exponential"):
        vals = {}
        for tier in ("fused", "matmul"):
            est = st.GBMClassifier(num_base_learners=PARITY_ROUNDS, learning_rate=0.3, loss=loss,
                                   updates="newton", base_learner=reg_tree(tier))
            model, vals[tier] = family_run("losses", f"GBMClassifier[{loss}]", tier, est,
                                           Xa_np, ya_np, lambda m, launches: PARITY_ROUNDS,
                                           accuracy)
            proba = model.predict_proba(Xa_np)
            if proba.shape != (ADULT_ROWS, 2) or not bool(torch.isfinite(proba).all()):
                raise AssertionError(f"GBMClassifier[{loss}] {tier}: probabilities")
        near(f"GBMClassifier[{loss}]", vals, "accuracy", 0.02)

    # phase 10 (fast_tiers): the main path on matmul at "high" (true f32)
    # and "default" (bf16-rounded statistics), held to "highest"'s accuracy
    # within 0.02; a single tree at "pallas" (the 'high' matmul path, no
    # kernel); and the 'default' rounding on letter's level-0 histogram
    # (M=1, C=27): nonzero and within 2^-8 of each cell's magnitude
    fast_acc = {"matmul": a_ref}
    for hp in ("high", "default"):
        fast_acc[hp] = family_run("fast_tiers", f"GBMClassifier[{hp}]", "matmul",
                                  gbm("matmul", hp, PARITY_ROUNDS), X_np, y_np,
                                  lambda m, launches: PARITY_ROUNDS, accuracy)[1]
    near("GBMClassifier[fast tiers]", fast_acc, "accuracy", 0.02)
    # where a fast tier's round goes, beside "highest"'s, traced in turns
    for hp in ("highest", "high", "default", "highest"):
        profile_fit(gbm("matmul", hp, 3), X_np, y_np, tier="matmul", hist_precision=hp, rounds=3)
    tree_acc = {}
    for hp in ("highest", "pallas"):
        tree_acc["matmul" if hp == "highest" else hp] = family_run(
            "fast_tiers", f"DecisionTreeClassifier[{hp}]", "matmul", cls_tree("matmul", hp),
            X_np, y_np, lambda m, launches: 1, accuracy)[1]
    near("DecisionTreeClassifier[pallas]", tree_acc, "accuracy", 0.02)
    from spark_ensemble_tpu_torch.ops import tree as tree_ops

    y_l = torch.as_tensor(y_np, device=dev)
    onehot_l = torch.nn.functional.one_hot(y_l.long(), N_CLASSES).to(torch.float32)
    vals_l = torch.cat([torch.ones(N_ROWS, 1, device=dev),
                        onehot_l - onehot_l.mean(dim=0, keepdim=True)], dim=1)[:, None, :]
    node0 = torch.zeros((N_ROWS, 1), dtype=torch.int32, device=dev)
    oh64 = tree_ops._bin_one_hot(Xb64, MAX_BINS)
    H_hi = tree_ops._level_hist("matmul", Xb64, oh64, node0, vals_l, 1, MAX_BINS)
    H_def = tree_ops._level_hist("matmul", Xb64, oh64, node0, tree_ops._bf16_round(vals_l), 1,
                                 MAX_BINS)
    H_abs = tree_ops._level_hist("matmul", Xb64, oh64, node0, vals_l.abs(), 1, MAX_BINS)
    gap = (H_def - H_hi).abs()
    rel_gap = float((gap / H_abs.clamp(min=1e-30)).max())
    del oh64
    forests = {}
    for hp in ("highest", "default"):
        forests[hp] = tree_ops.fit_forest(
            Xb64, onehot_l[:, None, :], torch.ones((N_ROWS, 1), device=dev), bins64.thresholds,
            max_depth=DEPTH, max_bins=MAX_BINS, hist="matmul", hist_precision=hp)
    same_splits = float((forests["default"].split_feature == forests["highest"].split_feature)
                        .float().mean())
    emit({"phase": "fast_tiers", "check": "default_level0_histogram", "data": "letter", "M": 1,
          "C": 1 + N_CLASSES, "max_abs_diff": float(gap.max()), "max_rel_diff": rel_gap,
          "bound_rel": 2.0**-8, "forest_split_features_equal_share": same_splits})
    if not 0.0 < float(gap.max()) or rel_gap > 2.0**-8:
        raise AssertionError(f"default rounding on letter's level 0: max {float(gap.max())}, "
                             f"relative {rel_gap}")

    # phase 11 (stacking): bench.py's config (DT + LR + GaussianNB, LR
    # stacker, stack_method="class") on adult-shaped data, as is (the DT on
    # the matmul tier) and with the DT on the fused tier (its kernels at
    # d=123: 5 histograms, 4 routes, 1 leaf pass), that one again at
    # parallelism=2 (the DT launches from a pool thread): its predictions
    # must equal parallelism=1's.  Then proba stacking on letter (the
    # stacker's (3*26+1)*26 = 2054 parameters run L-BFGS) and a default
    # StackingRegressor
    def bench_stack(dt_hist, parallelism=1, stack_method="class"):
        return st.StackingClassifier(
            base_learners=[cls_tree(dt_hist) if dt_hist else st.DecisionTreeClassifier(),
                           st.LogisticRegression(), st.GaussianNaiveBayes()],
            stacker=st.LogisticRegression(), stack_method=stack_method,
            parallelism=parallelism)

    stack_acc, stack_models = {}, {}
    for label, hist, par in (("matmul", None, 1), ("fused", "fused", 1),
                             ("fused_parallel_2", "fused", 2)):
        want_launches[label] = want_launches["fused" if hist else "matmul"]
        stack_models[label], stack_acc[label] = family_run(
            "stacking", f"StackingClassifier[class, parallelism={par}]", label,
            bench_stack(hist, par), Xa_np, ya_np, lambda m, launches: 1, accuracy)
    near("StackingClassifier[adult]", stack_acc, "accuracy", 0.02)
    if not torch.equal(stack_models["fused"].predict_proba(Xa_np),
                       stack_models["fused_parallel_2"].predict_proba(Xa_np)):
        raise AssertionError("StackingClassifier: parallelism=2 differs from parallelism=1")
    model, _ = family_run("stacking", "StackingClassifier[proba]", "matmul",
                          bench_stack(None, stack_method="proba"), X_np, y_np,
                          lambda m, launches: 1, accuracy)
    stacker = model.stack_model
    emit({"phase": "stacking", "family": "StackingClassifier[proba]", "stacker_params":
          int(stacker.params["coef"].numel() + stacker.params["intercept"].numel()),
          "stacker_solver": "lbfgs" if (3 * N_CLASSES + 1) * N_CLASSES > 1024 else "newton"})
    family_run("stacking", "StackingRegressor", "matmul", st.StackingRegressor(), Xr, yr,
               lambda m, launches: 1, rmse)

    # the new families' fits, traced the same way: one Bagging fit and a
    # 5-round SAMME fit on the fused tier
    profile_fit(st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5,
                                     base_learner=cls_tree("fused")),
                X_np, y_np, family="BaggingClassifier", tier="fused", members=10)
    profile_fit(st.BoostingClassifier(num_base_learners=5, base_learner=cls_tree("fused")),
                X_np, y_np, family="BoostingClassifier[discrete]", tier="fused", rounds=5)

    # phase 12 (stream): bench.py's XL leg (bench.py:499-563) through the
    # public estimator with the default tree: at 2,097,152 x 64 x 64 bins
    # the matmul tier's bin one-hot would take 34 GB, so hist="auto"
    # resolves to the row-chunked stream tier (plain torch matmuls per
    # chunk; no kernel of csrc/hist.cu runs there).  One warm round, then
    # 10 rounds at "highest" and at "high", each with its peak device
    # memory; then one round at 262,144 rows on the stream and matmul
    # tiers, held on the share of rows whose probabilities move by more
    # than 1e-3 (at most 1%) and on accuracy (within 0.02)
    card = {"card": smi}
    tier = tree_ops.resolve_forest_tier("auto", "highest", dev, XL_ROWS, XL_FEATURES, MAX_BINS)
    if tier != "stream":
        raise AssertionError(f"hist='auto' at the XL size resolved to {tier!r}, not 'stream'")
    X_xl_np, y_xl = xl_data()
    X_xl = torch.as_tensor(X_xl_np, device=dev)
    del X_xl_np
    streamed = [0]
    real_streamed = tree_ops._fit_forest_streamed

    def counted_streamed(*args, **kwargs):
        streamed[0] += 1
        return real_streamed(*args, **kwargs)

    def xl_gbm(rounds, hist="auto", hp="highest"):
        return st.GBMClassifier(num_base_learners=rounds, loss="logloss", updates="newton",
                                learning_rate=0.3,
                                base_learner=st.DecisionTreeRegressor(hist=hist, hist_precision=hp))

    one_hot_bytes = XL_ROWS * XL_FEATURES * MAX_BINS * 4
    tree_ops._fit_forest_streamed = counted_streamed
    try:
        fit_counted(xl_gbm(1), X_xl, y_xl)  # warm: allocator and cuBLAS plans
        xl_acc = {}
        for hp in ("highest", "high"):
            streamed[0] = 0
            torch.cuda.reset_peak_memory_stats()
            model, secs, launches = fit_counted(xl_gbm(XL_ROUNDS, hp=hp), X_xl, y_xl)
            peak = torch.cuda.max_memory_allocated()
            fits = streamed[0]
            proba = model.predict_proba(X_xl[:65536])
            if not bool(torch.isfinite(proba).all()) or proba.shape != (65536, XL_CLASSES):
                raise AssertionError(f"stream {hp}: probabilities not finite of shape {(65536, XL_CLASSES)}")
            xl_acc[hp] = accuracy(model, X_xl, y_xl)
            emit({"phase": "stream", "hist": "auto", "resolved_tier": tier, "hist_precision": hp,
                  "n": XL_ROWS, "d": XL_FEATURES, "classes": XL_CLASSES, "rounds": XL_ROUNDS,
                  "chunk_rows": tree_ops._STREAM_CHUNK_ROWS, "fit_s": secs,
                  "iters_per_s": XL_ROUNDS / secs, "rows_per_s": XL_ROWS * XL_ROUNDS / secs,
                  "train_accuracy": xl_acc[hp], "peak_memory_bytes": peak,
                  "matmul_one_hot_bytes": one_hot_bytes, "stream_forest_fits": fits,
                  "launches": launches, **card})
            if fits != XL_ROUNDS:
                raise AssertionError(f"stream {hp}: {fits} stream forest fits for {XL_ROUNDS} rounds")
            if launches != {k: 0 for k in hk.LAUNCHES}:
                raise AssertionError(f"stream {hp}: kernels launched {launches}")
            if peak >= one_hot_bytes:
                raise AssertionError(f"stream {hp}: peak memory {peak} >= the one-hot's {one_hot_bytes}")
            if xl_acc[hp] < 2.0 / XL_CLASSES:
                raise AssertionError(f"stream {hp}: accuracy {xl_acc[hp]}")
        if abs(xl_acc["high"] - xl_acc["highest"]) > 0.02:
            raise AssertionError(f"stream high vs highest accuracy: {xl_acc}")
        # where a stream round goes: one traced round
        profile_fit(xl_gbm(1), X_xl, y_xl, tier="stream", n=XL_ROWS, rounds=1, **card)
        Xs, ys = X_xl[:STREAM_CHECK_ROWS], y_xl[:STREAM_CHECK_ROWS]
        one_xl = {}
        for hist in ("stream", "matmul"):
            streamed[0] = 0
            model, secs, _ = fit_counted(xl_gbm(1, hist=hist), Xs, ys)
            if streamed[0] != (hist == "stream"):
                raise AssertionError(f"{hist}: {streamed[0]} stream forest fits")
            one_xl[hist] = (model.predict_proba(Xs), accuracy(model, Xs, ys), secs)
    finally:
        tree_ops._fit_forest_streamed = real_streamed
    diff, share = proba_gap(one_xl["stream"][0], one_xl["matmul"][0])
    acc_diff = one_xl["stream"][1] - one_xl["matmul"][1]
    emit({"phase": "stream", "check": "one_round_vs_matmul", "n": STREAM_CHECK_ROWS,
          "proba_max_abs_diff": diff, "rows_beyond_1e-3": share, "accuracy_diff": acc_diff,
          "stream_fit_s": one_xl["stream"][2], "matmul_fit_s": one_xl["matmul"][2], **card})
    if share > 0.01 or abs(acc_diff) > 0.02:
        raise AssertionError(f"stream vs matmul after one round: {share} of rows moved, "
                             f"accuracy {acc_diff}")
    del X_xl, Xs, one_xl, model
    torch.cuda.empty_cache()

    # phase 13 (sampled): the main path on the fused tier at bench.py's
    # sampling leg (bench.py:1586-1590): sampling="goss" (0.2/0.1) and
    # "mvs" gather 4500 survivors a round into an 8192-row bucket, the
    # legacy sample_method="goss" keeps all rows at GOSS weights; 20
    # rounds each beside sampling="none", every fit's launches counted
    # from 0 (5 histograms, 4 routes, 1 leaf pass a round).  Then the three
    # fused kernels at round 0's bucket of gathered letter rows, held
    # against their plain versions and timed (shapes rows "letter_sampled")
    from spark_ensemble_tpu_torch.models import gbm as gbm_mod

    samp_acc = {}
    for label, kw in (("none", {}), ("goss", dict(sampling="goss", top_rate=0.2, other_rate=0.1)),
                      ("mvs", dict(sampling="mvs")), ("legacy_goss", dict(sample_method="goss"))):
        est = gbm("fused", "highest", PARITY_ROUNDS).set_params(**kw)
        plan = est._resolved_sampling(N_ROWS)
        model, secs, launches = fit_counted(est, X_np, y_np)
        proba = model.predict_proba(X_np)
        if not bool(torch.isfinite(proba).all()) or proba.shape != (N_ROWS, N_CLASSES):
            raise AssertionError(f"sampled {label}: predict_proba not finite of shape {(N_ROWS, N_CLASSES)}")
        samp_acc[label] = accuracy(model, X_np, y_np)
        emit({"phase": "sampled", "method": label, "tier": "fused", "rounds": PARITY_ROUNDS,
              "bucket": plan["bucket"] if plan else None,
              "sampled_rows": plan["sampled_rows"] if plan else N_ROWS, "fit_s": secs,
              "iters_per_s": PARITY_ROUNDS / secs, "train_accuracy": samp_acc[label],
              "launches": launches, "launches_per_round": {k: v / PARITY_ROUNDS for k, v in launches.items()},
              **card})
        if launches != per_fit(PARITY_ROUNDS):
            raise AssertionError(f"sampled {label}: launches {launches}")
        if label in ("goss", "mvs") and plan["bucket"] != 8192:
            raise AssertionError(f"sampled {label}: bucket {plan['bucket']} != 8192")
        if samp_acc[label] < 0.5:
            raise AssertionError(f"sampled {label}: accuracy {samp_acc[label]}")
    for label in ("goss", "mvs"):
        profile_fit(gbm("fused", "highest", 3).set_params(sampling=label), X_np, y_np,
                    tier="fused", sampling=label, rounds=3, **card)
    # round 0's GOSS survivors: the prior's gradient norms, the round key
    est = gbm("fused", "highest", 1).set_params(sampling="goss")
    plan = est._resolved_sampling(N_ROWS)
    loss0 = st.GBMClassifier()._make_loss(N_CLASSES)
    prior = torch.bincount(y_l.long(), minlength=N_CLASSES).to(torch.float32) / N_ROWS
    score0 = loss0.sampling_scores(loss0.encode_label(y_l),
                                   torch.log(prior)[None, :].expand(N_ROWS, N_CLASSES))
    idx0, mult0 = gbm_mod._sample_compact(
        "goss", score0, torch.ones(N_ROWS, dtype=torch.bool, device=dev),
        est._round_keys(dev, plan)[1][0], plan["bucket"], plan["samp"])
    n_checks = len(checks)
    forest_shapes("letter_sampled", Xb64[idx0].contiguous(), onehot_l[idx0][:, :1],
                  members=(N_CLASSES,))
    for row in checks[n_checks:]:
        emit({"phase": "kernel_check", **row, **card})

    # phase 14 (linear_leaves): bench.py's gbmreg_cpusmall_lineartree10
    # (bench.py:387-391) on the 8192x12 data on the fused and matmul tiers,
    # beside the same 10 rounds with constant leaves; the tree of each
    # round launches 5/4/1 on the fused tier, the leaf solves are torch ops
    lin, const_rmse = {}, {}
    for tier in ("fused", "matmul"):
        est = st.GBMRegressor(base_learner=st.LinearTreeRegressor(max_depth=5, hist=tier),
                              num_base_learners=10, learning_rate=0.3)
        model, secs, launches = fit_counted(est, Xr, yr)
        if launches != want_launches[tier](10):
            raise AssertionError(f"linear leaves {tier}: launches {launches}")
        lin[tier] = rmse(model, Xr, yr)
        cmodel, csecs, _ = fit_counted(st.GBMRegressor(base_learner=reg_tree(tier),
                                                       num_base_learners=10, learning_rate=0.3), Xr, yr)
        const_rmse[tier] = rmse(cmodel, Xr, yr)
        emit({"phase": "linear_leaves", "tier": tier, "rounds": 10, "fit_s": secs, "rmse": lin[tier],
              "constant_leaf_fit_s": csecs, "constant_leaf_rmse": const_rmse[tier],
              "launches": launches, "launches_per_round": {k: v / 10 for k, v in launches.items()},
              **card})
        if lin[tier] >= const_rmse[tier]:
            raise AssertionError(f"linear leaves {tier}: rmse {lin[tier]} >= constant {const_rmse[tier]}")
    near("GBMRegressor[linear leaves]", lin, "rmse", 0.1)

    # phase 15 (kernel_check at the sweep's shape): the tuning phase's
    # megabatch sweep folds 12 candidates of 26 class dims into one forest
    # of M = 312 members on letter's 15000 rows.  Each kernel at M = 312
    # (levels 0 and 4, the route into level 4, the leaf pass from 16
    # parents) is held against its plain version and timed beside its bound
    # and one index_add_ over the same cells; and lane s of the wide launch
    # (lanes=12) must equal a launch of its own 26 members bit for bit
    lanes, Ml = SWEEP_LANES, SWEEP_LANES * N_CLASSES
    packed64 = binning.pack_bins(Xb64, MAX_BINS, bits8).packed
    kw8 = dict(bits=bits8, num_features=N_FEATURES)
    vals_w = torch.as_tensor(np.stack([rng.rand(N_ROWS, Ml), rng.randn(N_ROWS, Ml)], axis=2)
                             .astype(np.float32), device=dev)
    common = {"data": "letter_sweep", "n": N_ROWS, "d": N_FEATURES, "W": packed64.shape[1],
              "M": Ml, "lanes": lanes, "C": C, **card}
    sweep_checks = []

    def lane_cols(t, s):
        return t[:, s * N_CLASSES:(s + 1) * N_CLASSES].contiguous()

    def lanes_equal(rec, wide, narrow, what):
        """Every lane of the wide launch against its own 26-member launch."""
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- the comparison reads every lane: a check, not a timed path
        for s in range(lanes):
            got = wide(s)
            if not torch.equal(got, narrow(s)):
                raise AssertionError(f"{rec.name}: lane {s} of the M={Ml} launch differs from its "
                                     f"own M={N_CLASSES} launch ({what})")

    def sweep_row(rec, run, shapes, plan, library_device_ms, **row):
        b_ms, b_by = bound(rec.name, **shapes)
        rec.shapes.append({**common, **row, "device_ms": device_ms(run), "bound_ms": b_ms,
                           "bound_by": b_by, "library_device_ms": library_device_ms,
                           "grid": plan.grid, "plan": plan._asdict()})

    for level in (0, DEPTH - 1):
        n_nodes = 2**level
        node = torch.as_tensor(rng.randint(0, n_nodes, size=(N_ROWS, Ml)).astype(np.int32), device=dev)
        out_floats = Ml * n_nodes * C * N_FEATURES * MAX_BINS
        cells = (((torch.arange(Ml, device=dev)[None, :] * n_nodes + node.long())[:, :, None, None] * C
                  + torch.arange(C, device=dev)[None, None, :, None]) * N_FEATURES
                 + torch.arange(N_FEATURES, device=dev)[None, None, None, :]) * MAX_BINS \
            + Xb64.long()[:, None, None, :]
        cells = cells.reshape(-1)
        src = vals_w[:, :, :, None].expand(N_ROWS, Ml, C, N_FEATURES).reshape(-1)
        acc = torch.zeros(out_floats, device=dev)
        lib_dev = device_ms(lambda: acc.index_add_(0, cells, src))  # one yardstick for both
        for rec, fn, words, nterms, bits in (
            (recs["hist_packed"], lambda nd, vl, ln: hk.hist_level_packed(
                packed64, nd, vl, n_nodes=n_nodes, max_bins=MAX_BINS, lanes=ln, **kw8), packed64, 3, bits8),
            (recs["hist_i32"], lambda nd, vl, ln: hk.hist_level_pallas(
                Xb64, nd, vl, n_nodes=n_nodes, max_bins=MAX_BINS, lanes=ln), Xb64, 2, 32),
        ):
            what = f"sweep M={Ml} level {level}"
            run = lambda: fn(node, vals_w, lanes)
            err = check_level(rec, run, hk.hist_plain(Xb64, node, vals_w, n_nodes, MAX_BINS, nterms), what)
            H = run()
            lanes_equal(rec, lambda s: H[s * N_CLASSES:(s + 1) * N_CLASSES],
                        lambda s: fn(lane_cols(node, s), lane_cols(vals_w, s), 1), what)
            plan = hk.lane_level_plan(N_ROWS, N_FEATURES, Ml, C, MAX_BINS, n_nodes, bits, lanes)
            sweep_row(rec, run, dict(n=N_ROWS, d=N_FEATURES, W=words.shape[1], M=Ml, C=C, B=MAX_BINS,
                                     n_nodes=n_nodes),
                      plan, lib_dev, level=level, n_nodes=n_nodes)
            sweep_checks.append({"kernel": rec.name, **common, "level": level, "n_nodes": n_nodes,
                                 "max_abs_err": err, "lanes_equal_own_launch": True})
        del cells, src, acc
    half = 2 ** (DEPTH - 1)
    parent = torch.as_tensor(rng.randint(0, half, size=(N_ROWS, Ml)).astype(np.int32), device=dev)
    bf = torch.as_tensor(rng.randint(0, N_FEATURES, size=(Ml, half)).astype(np.int32), device=dev)
    bt = torch.as_tensor(rng.randint(0, MAX_BINS, size=(Ml, half)).astype(np.int32), device=dev)
    rrec, lrec = recs["route_packed"], recs["leaf_sums"]
    run_r = lambda: hk.route_packed(packed64, parent, bf, bt, **kw8)
    ref_node = hk.route_plain(Xb64, parent, bf, bt)
    compare(rrec, run_r(), ref_node, f"sweep M={Ml}", exact=True)
    repeat_identical(rrec, run_r, f"sweep M={Ml}")
    sweep_row(rrec, run_r, dict(n=N_ROWS, W=packed64.shape[1], M=Ml, half=half),
              hk.route_plan(N_ROWS, Ml, half, packed64.shape[1]), None, half=half)
    sweep_checks.append({"kernel": rrec.name, **common, "half": half, "max_abs_err": 0.0})
    run_l = lambda: hk.fused_round_level(packed64, parent, vals_w, bf, bt, n_nodes=2 * half,
                                         max_bins=MAX_BINS, leaf=True, lanes=lanes, **kw8)
    L, leaf_ids = run_l()
    compare(lrec, leaf_ids, ref_node, f"sweep M={Ml}", exact=True)
    err = compare(lrec, L, hk.leaf_plain(ref_node, vals_w, 2 * half), f"sweep M={Ml}")
    repeat_identical(lrec, run_l, f"sweep M={Ml}")
    lanes_equal(lrec, lambda s: L[s * N_CLASSES:(s + 1) * N_CLASSES],
                lambda s: hk.fused_round_level(
                    packed64, lane_cols(parent, s), lane_cols(vals_w, s),
                    bf[s * N_CLASSES:(s + 1) * N_CLASSES].contiguous(),
                    bt[s * N_CLASSES:(s + 1) * N_CLASSES].contiguous(), n_nodes=2 * half,
                    max_bins=MAX_BINS, leaf=True, **kw8)[0], "leaf pass")
    lidx = (torch.arange(Ml, device=dev)[None, :] * (2 * half) + ref_node.long()).reshape(-1)
    lsrc = vals_w.reshape(-1, C)
    lacc = torch.zeros(Ml * 2 * half, C, device=dev)
    sweep_row(lrec, run_l, dict(n=N_ROWS, M=Ml, C=C, leaves=2 * half, W=packed64.shape[1],
                                half=half),
              hk.lane_leaf_plan(N_ROWS, Ml, C, 2 * half, half, lanes),
              device_ms(lambda: lacc.index_add_(0, lidx, lsrc)), leaves=2 * half)
    sweep_checks.append({"kernel": lrec.name, **common, "leaves": 2 * half, "routed": True,
                         "max_abs_err": err, "lanes_equal_own_launch": True})
    # why the tree fit takes its prefix sums lane by lane (ops/tree.py
    # _prefix_sums): CUDA's cumsum along the bins of a 312-member view, held
    # against the same on each lane's 26-member slice (reported, not held)
    H_s = torch.randn(Ml, 2 ** (DEPTH - 1), C, N_FEATURES, MAX_BINS, device=dev)
    wide_cs = torch.cumsum(H_s[:, :, 0], dim=3)
    emit({"phase": "kernel_check", "check": "cumsum_view_lanes", **common,
          "lanes_equal_own_cumsum": all(
              bool(torch.equal(wide_cs[s * N_CLASSES:(s + 1) * N_CLASSES],
                               torch.cumsum(H_s[s * N_CLASSES:(s + 1) * N_CLASSES][:, :, 0], dim=3)))
              for s in range(lanes))})
    del H_s, wide_cs
    for row in sweep_checks:
        emit({"phase": "kernel_check", **row})
    del vals_w, parent, L, leaf_ids, lidx, lsrc, lacc
    torch.cuda.empty_cache()

    # phase 16 (tuning): a CrossValidator over the main path (the fused
    # tier; learning_rate in {0.1, 0.3} x subsample_ratio in {1.0, 0.8}, 3
    # folds, 20 rounds: 12 candidates in one sweep group, M = 12 x 26 = 312)
    # at megabatch "on" and "off": their avg_metrics and best_index must
    # be equal bit for bit (a swept candidate fits as it would alone).
    # Then the pair at hist="auto" (the matmul tier on the card, whose
    # sweep runs one product per lane, cuBLAS's own choice at each shape),
    # 5 rounds, held to an equal best_index, its largest avg_metrics gap
    # printed.
    # Then the reference's own example: a CrossValidator over
    # BaggingClassifier(DecisionTreeClassifier()) with a grid over
    # subspace_ratio
    from spark_ensemble_tpu_torch.models import gbm_sweep

    grid = (st.ParamGridBuilder().add_grid("learning_rate", [0.1, 0.3])
            .add_grid("subsample_ratio", [1.0, 0.8]).build())
    swept_rounds = []
    real_swept = gbm_sweep._swept_forest

    def counted_swept(*args, **kwargs):
        swept_rounds.append(len(args[2]))  # the lanes of this round's forest
        return real_swept(*args, **kwargs)

    def tune(hist, rounds, megabatch):
        est = st.GBMClassifier(num_base_learners=rounds, loss="logloss", updates="newton",
                               learning_rate=0.3,
                               base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, max_bins=MAX_BINS,
                                                                     hist=hist))
        cv = st.CrossValidator(estimator=est, estimator_param_maps=grid,
                               evaluator=st.MulticlassClassificationEvaluator(), num_folds=3,
                               seed=0, megabatch=megabatch)
        swept_rounds.clear()
        gbm_sweep._swept_forest = counted_swept
        try:
            model, secs, launches = fit_counted(cv, X_np, y_np)
        finally:
            gbm_sweep._swept_forest = real_swept
        emit({"phase": "tuning", "estimator": "CrossValidator[GBMClassifier]", "tier": hist,
              "megabatch": megabatch, "candidates": len(grid) * 3, "rounds": rounds,
              "fit_s": secs, "launches": launches, "swept_rounds": len(swept_rounds),
              "lanes_per_swept_round": max(swept_rounds) if swept_rounds else 0,
              "avg_metrics": model.avg_metrics, "best_index": model.best_index, **card})
        return model, launches

    tuned = {mb: tune("fused", PARITY_ROUNDS, mb) for mb in ("on", "off")}
    (on, on_l), (off, off_l) = tuned["on"], tuned["off"]
    if on.avg_metrics != off.avg_metrics or on.best_index != off.best_index:
        raise AssertionError(f"tuning fused: megabatch on {on.avg_metrics} / {on.best_index} != "
                             f"off {off.avg_metrics} / {off.best_index}")
    # the sweep: 5/4/1 launches a round for all 12 candidates, then the
    # best map's refit; sequentially: 12 fits and the refit
    if on_l != per_fit(2 * PARITY_ROUNDS) or off_l != per_fit(13 * PARITY_ROUNDS):
        raise AssertionError(f"tuning fused launches: on {on_l}, off {off_l}")
    auto = {mb: tune("auto", 5, mb)[0] for mb in ("on", "off")}
    gap = max(abs(a - b) for a, b in zip(auto["on"].avg_metrics, auto["off"].avg_metrics))
    emit({"phase": "tuning", "tier": "auto", "resolved_tier": "matmul",
          "avg_metrics_max_gap": gap, "best_index_equal": auto["on"].best_index == auto["off"].best_index,
          **card})
    if auto["on"].best_index != auto["off"].best_index:
        raise AssertionError(f"tuning matmul: best_index {auto['on'].best_index} != {auto['off'].best_index}")
    example = st.CrossValidator(
        estimator=st.BaggingClassifier(base_learner=st.DecisionTreeClassifier()),
        estimator_param_maps=st.ParamGridBuilder().add_grid("subspace_ratio", [0.5, 1.0]).build(),
        evaluator=st.MulticlassClassificationEvaluator(), num_folds=3)
    model, secs, launches = fit_counted(example, X_np, y_np)
    acc = accuracy(model, X_np, y_np)
    emit({"phase": "tuning", "estimator": "CrossValidator[BaggingClassifier(DecisionTreeClassifier)]",
          "fit_s": secs, "avg_metrics": model.avg_metrics, "best_index": model.best_index,
          "train_accuracy": acc, **card})
    if acc < 2.0 / N_CLASSES or not all(math.isfinite(v) for v in model.avg_metrics):
        raise AssertionError(f"reference example: accuracy {acc}, avg_metrics {model.avg_metrics}")

    # phase 17 (mlp_members): the MLP alone and as an ensemble member: 200
    # Adam steps of MLPClassifier((64,)) on letter, Bagging over it (10
    # members trained at once), docs/stacking.md's stack, GBMRegressor over
    # MLPRegressor and over LinearRegression on the 8192x12 data, and SAMME
    # over GaussianNaiveBayes
    def member_run(family, est, X_, y_, metric, floor=None):
        model, secs, launches = fit_counted(est, X_, y_)
        value = metric(model, X_, y_)
        emit({"phase": "mlp_members", "family": family, "fit_s": secs, metric.__name__: value,
              "launches": launches, **card})
        if floor is not None and value < floor:
            raise AssertionError(f"{family}: {metric.__name__} {value} < {floor}")
        return model

    mlp = lambda: st.MLPClassifier(hidden_layer_sizes=(64,), max_iter=200)
    member_run("MLPClassifier", mlp(), X_np, y_np, accuracy, floor=0.5)
    member_run("BaggingClassifier[MLPClassifier]",
               st.BaggingClassifier(num_base_learners=10, base_learner=mlp()), X_np, y_np, accuracy,
               floor=0.5)
    member_run("StackingClassifier[docs/stacking.md]", st.StackingClassifier(
        base_learners=[st.DecisionTreeClassifier(max_depth=5), st.BoostingClassifier(num_base_learners=5),
                       mlp(), st.LogisticRegression()],
        stacker=st.LogisticRegression(), stack_method="raw"), X_np, y_np, accuracy, floor=0.5)
    member_run("GBMRegressor[MLPRegressor]", st.GBMRegressor(
        num_base_learners=10, learning_rate=0.3,
        base_learner=st.MLPRegressor(hidden_layer_sizes=(64,), max_iter=200)), Xr, yr, rmse)
    member_run("GBMRegressor[LinearRegression]", st.GBMRegressor(
        num_base_learners=10, learning_rate=0.3, base_learner=st.LinearRegression()), Xr, yr, rmse)
    member_run("BoostingClassifier[discrete, GaussianNaiveBayes]", st.BoostingClassifier(
        num_base_learners=10, base_learner=st.GaussianNaiveBayes()), X_np, y_np, accuracy,
        floor=1.0 / N_CLASSES)

    # phase 18 (pipeline): a TrainValidationSplit over
    # Pipeline([StandardScaler(), GBMClassifier(main path)]) at two learning
    # rates, 20 rounds (pipelines fit sequentially), and
    # Pipeline([MinMaxScaler(), MLPClassifier()])
    def scaled_gbm(lr):
        return st.Pipeline(stages=[st.StandardScaler(), gbm("fused", "highest", PARITY_ROUNDS)
                                   .set_params(learning_rate=lr)])

    tvs = st.TrainValidationSplit(estimator=scaled_gbm(0.3),
                                  estimator_param_maps=[{"stages": scaled_gbm(lr).stages}
                                                        for lr in (0.1, 0.3)],
                                  evaluator=st.MulticlassClassificationEvaluator(), seed=0)
    model, secs, launches = fit_counted(tvs, X_np, y_np)
    acc = accuracy(model, X_np, y_np)
    emit({"phase": "pipeline", "estimator": "TrainValidationSplit[Pipeline(StandardScaler, GBMClassifier)]",
          "fit_s": secs, "validation_metrics": model.validation_metrics,
          "best_index": model.best_index, "train_accuracy": acc, "launches": launches, **card})
    if launches != per_fit(3 * PARITY_ROUNDS) or acc < 0.5:
        raise AssertionError(f"tuned pipeline: launches {launches}, accuracy {acc}")
    model, secs, _ = fit_counted(st.Pipeline(stages=[st.MinMaxScaler(), mlp()]), X_np, y_np)
    acc = accuracy(model, X_np, y_np)
    emit({"phase": "pipeline", "estimator": "Pipeline(MinMaxScaler, MLPClassifier)", "fit_s": secs,
          "train_accuracy": acc, **card})
    if acc < 0.5:
        raise AssertionError(f"Pipeline(MinMaxScaler, MLPClassifier): accuracy {acc}")

    # phases 19-22 (persist, checkpoint, fit_resume, robustness): the
    # persistence and round-runtime slice at the main path's full width.
    # Every fit here must equal its uninterrupted twin bit for bit
    # (torch.equal): a resume replays the same kernels from a restored
    # carry, and every kernel and reduction on the round path repeats bit
    # for bit.  No retry happens unless a phase injects one.
    from spark_ensemble_tpu_torch.models.base import tree_leaves
    from spark_ensemble_tpu_torch.robustness import chaos as chaos_mod

    os.makedirs("build", exist_ok=True)
    scratch = tempfile.mkdtemp(dir="build", prefix="chip_smoke-")

    class FaultAt(chaos_mod.ChaosController):
        """Fires each of its faults at one named site only (the harness's
        at-most-once and budget rules still apply)."""

        def __init__(self, sites):
            super().__init__(seed=0, rate=0.5, faults=tuple(sites))
            self.sites = sites

        def _draw(self, fault, site):
            return 0.0 if site == self.sites[fault] else 1.0

    def no_stray_retries(phase):
        if retry_mod.retry_count():
            raise AssertionError(f"{phase}: retries no fault injected: {retry_mod.retry_log()}")

    def outputs(model, X_):
        return model.predict_proba(X_) if hasattr(model, "num_classes") else model.predict(X_)

    def preempt_and_resume(phase, family, est, X_, y_, ref, at, interval):
        """Fit ``est`` with checkpoints every ``interval`` rounds and a chaos
        preemption after round ``at``, refit it to resume, and hold the
        result to the uninterrupted model ``ref`` bit for bit."""
        label = type(est).__name__
        ckdir = os.path.join(scratch, f"{phase}-{family}")
        est = est.copy(checkpoint_dir=ckdir, checkpoint_interval=interval)
        chaos_mod.install(FaultAt({"preempt": f"{label}:after_round:{at}"}))
        try:
            est.fit(X_, y_, device="cuda")
            raise AssertionError(f"{family}: the preemption after round {at} did not fire")
        except chaos_mod.ChaosPreemption:
            pass
        finally:
            chaos_mod.install(None)
        resumed, secs, launches = fit_counted(est, X_, y_)
        equal = torch.equal(outputs(resumed, X_), outputs(ref, X_))
        emit({"phase": phase, "family": family, "preempted_after_round": at,
              "checkpoint_interval": interval, "resume_fit_s": secs, "resume_launches": launches,
              "members": resumed.num_members, "bit_identical": equal, **card})
        if not equal or resumed.num_members != ref.num_members:
            raise AssertionError(f"{family}: the resumed fit differs from the uninterrupted one")
        no_stray_retries(phase)
        return launches

    timed_model = timed[-1][0]
    Xd = torch.as_tensor(X_np, device=dev)

    # phase 19 (persist): the timed 100-round fused model saved, loaded on
    # the card (equal bit for bit) and on the CPU (within 1e-5, same argmax)
    path = os.path.join(scratch, "letter_gbm")
    t0 = time.perf_counter()
    timed_model.save(path)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    on_card = st.load(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = st.load(path, device="cpu")
    load_cpu_s = time.perf_counter() - t0
    p_ref = timed_model.predict_proba(Xd)
    card_equal = torch.equal(on_card.predict_proba(Xd), p_ref)
    p_cpu = on_cpu.predict_proba(X_np)
    cpu_err = float((p_cpu - p_ref.cpu()).abs().max())
    argmax_equal = torch.equal(p_cpu.argmax(dim=1), p_ref.argmax(dim=1).cpu())
    emit({"phase": "persist", "family": "GBMClassifier", "rounds": TIMED_ROUNDS,
          "bytes_on_disk": nbytes, "save_s": save_s, "load_s": load_s, "load_cpu_s": load_cpu_s,
          "card_bit_identical": card_equal, "cpu_proba_max_abs_diff": cpu_err,
          "cpu_argmax_equal": argmax_equal, **card})
    if not card_equal or cpu_err > 1e-5 or not argmax_equal:
        raise AssertionError(f"persist: card {card_equal}, cpu {cpu_err}, argmax {argmax_equal}")

    # phase 20 (checkpoint): preempted after a save boundary, then resumed
    launches = preempt_and_resume("checkpoint", "GBMClassifier[fused]",
                                  gbm("fused", "highest", TIMED_ROUNDS), X_np, y_np,
                                  timed_model, at=50, interval=10)
    if launches != per_fit(TIMED_ROUNDS - 50):
        raise AssertionError(f"checkpoint: resumed fused launches {launches}")
    pallas_ref = fit_counted(gbm("matmul", "pallas", PARITY_ROUNDS), X_np, y_np)[0]
    launches = preempt_and_resume("checkpoint", "GBMClassifier[pallas]",
                                  gbm("matmul", "pallas", PARITY_ROUNDS), X_np, y_np,
                                  pallas_ref, at=10, interval=10)
    if launches["hist_i32"] != DEPTH * (PARITY_ROUNDS - 10):
        raise AssertionError(f"checkpoint: resumed pallas launches {launches}")
    samme = st.BoostingClassifier(num_base_learners=PARITY_ROUNDS, algorithm="discrete",
                                  base_learner=cls_tree("fused"))
    samme_ref, _, samme_launches = fit_counted(samme, X_np, y_np)
    if samme_ref.num_members != PARITY_ROUNDS or samme_launches != per_fit(PARITY_ROUNDS):
        raise AssertionError(f"SAMME: {samme_ref.num_members} members, launches {samme_launches}")
    preempt_and_resume("checkpoint", "BoostingClassifier[SAMME, fused]", samme, X_np, y_np,
                       samme_ref, at=10, interval=10)
    huber = lambda rounds: st.GBMRegressor(num_base_learners=rounds, learning_rate=0.3,
                                           loss="huber", base_learner=reg_tree("fused"))
    huber_ref = fit_counted(huber(PARITY_ROUNDS), Xr, yr)[0]
    preempt_and_resume("checkpoint", "GBMRegressor[huber, fused]", huber(PARITY_ROUNDS), Xr, yr,
                       huber_ref, at=10, interval=10)

    # phase 21 (fit_resume): a shorter model continued to the longer fit
    shorts = {}  # the short models, continued again from a packed artifact in phase 24
    for family, short, ref, X_, y_ in (
            ("GBMClassifier[fused]", gbm("fused", "highest", 60), timed_model, X_np, y_np),
            ("GBMRegressor[huber, fused]", huber(10), huber_ref, Xr, yr)):
        base_model = shorts[family] = short.fit(X_, y_, device="cuda")
        n_new = ref.num_members - base_model.num_members
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = base_model.fit_resume(X_, y_, n_new)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, dict(hk.LAUNCHES)
        equal = torch.equal(outputs(resumed, X_), outputs(ref, X_)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params), tree_leaves(ref.params)))
        emit({"phase": "fit_resume", "family": family, "from_rounds": base_model.num_members,
              "new_rounds": n_new, "fit_s": secs, "launches": launches,
              "bit_identical": equal, **card})
        if not equal or launches != per_fit(n_new):
            raise AssertionError(f"fit_resume {family}: equal {equal}, launches {launches}")
    no_stray_retries("fit_resume")

    # phase 22 (robustness): a chaos NaN at one round under each recovery
    # policy; pipeline depths 0, 1 and 2 equal, with and without a
    # validation stop mid-fit; a torn checkpoint falling back to .ckpt-old
    for policy in ("skip_round", "halve_step", "stop_early"):
        ctl = FaultAt({"nan_grad": "GBMClassifier:round:16"})
        chaos_mod.install(ctl)
        try:
            model, secs, launches = fit_counted(
                gbm("fused", "highest", PARITY_ROUNDS).set_params(on_nonfinite=policy), X_np, y_np)
        finally:
            chaos_mod.install(None)
        events = model.guard_events_
        finite = bool(torch.isfinite(model.predict_proba(Xd)).all())
        emit({"phase": "robustness", "check": "nan_grad", "policy": policy,
              "fired": [list(f) for f in ctl.fired], "guard_events": events,
              "members": model.num_members, "finite": finite, "fit_s": secs,
              "launches": launches, **card})
        if not ctl.fired or not finite or [e["action"] for e in events] != [policy] \
                or not 16 <= events[0]["round"] < PARITY_ROUNDS:
            raise AssertionError(f"robustness {policy}: fired {ctl.fired}, events {events}")
    vi = np.zeros(N_ROWS, bool)
    vi[::4] = True
    depth_runs = {}
    for stop in (False, True):
        for depth in ("0", "1", "2"):
            os.environ["SE_TPU_PIPELINE"] = depth
            est = gbm("fused", "highest", PARITY_ROUNDS)
            if stop:
                # letter's validation loss improves by under 4.5% a round
                # from about round 7 on: the stop lands mid-fit, with
                # chunks of 4 in flight past it
                est.set_params(scan_chunk=4, num_rounds=2, validation_tol=0.045)
            hk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est.fit(X_np, y_np, validation_indicator=vi if stop else None, device="cuda")
            torch.cuda.synchronize()
            depth_runs[stop, depth] = (model, time.perf_counter() - t0, dict(hk.LAUNCHES))
        os.environ.pop("SE_TPU_PIPELINE")
        ref0 = depth_runs[stop, "0"][0]
        for depth in ("1", "2"):
            model, secs, launches = depth_runs[stop, depth]
            equal = (model.num_members == ref0.num_members
                     and torch.equal(model.predict_proba(Xd), ref0.predict_proba(Xd)))
            emit({"phase": "robustness", "check": "pipeline_depth", "depth": int(depth), "vs_depth": 0,
                  "validation_stop": stop, "members": model.num_members, "fit_s": secs,
                  "launches": launches, "bit_identical": equal, **card})
            if not equal:
                raise AssertionError(f"pipeline depth {depth} (stop {stop}) differs from depth 0")
        if stop and not 0 < ref0.num_members < PARITY_ROUNDS:
            raise AssertionError(f"the validation stop kept {ref0.num_members} rounds, not mid-fit")
    ckdir = os.path.join(scratch, "torn")
    est = gbm("fused", "highest", PARITY_ROUNDS).set_params(checkpoint_dir=ckdir, checkpoint_interval=5)
    chaos_mod.install(FaultAt({"ckpt_corrupt": f"ckpt:{ckdir}:14",
                               "preempt": "GBMClassifier:after_round:15"}))
    try:
        est.fit(X_np, y_np, device="cuda")
        raise AssertionError("robustness: the preemption after round 15 did not fire")
    except chaos_mod.ChaosPreemption:
        pass
    finally:
        chaos_mod.install(None)
    probe = st.TrainingCheckpointer(ckdir, 5, fingerprint=est._checkpointer(
        dev, N_ROWS, N_FEATURES, N_CLASSES, 0, N_ROWS, 0).fingerprint)  # nv, n_pad, nv_pad
    loaded = probe.load_latest()
    resumed = est.fit(X_np, y_np, device="cuda")
    equal = torch.equal(resumed.predict_proba(Xd), runs["fused"][0])
    emit({"phase": "robustness", "check": "ckpt_corrupt", "load_detail": probe.last_load_detail,
          "bit_identical": equal, **card})
    if loaded is None or probe.last_load_detail != {"round": 9, "source": ".ckpt-old",
                                                    "fallback": True} or not equal:
        raise AssertionError(f"ckpt_corrupt: {probe.last_load_detail}, equal {equal}")
    no_stray_retries("robustness")

    # checkpoint and pipeline timings: the 100-round main path fit with and
    # without checkpoints (every 10 rounds), at depths 0 and 1, three fits
    # each.  The host's rate moves by tens of percent between fits, so the
    # four configurations take turns (the order reversed every other
    # turn), and each checkpointed fit reports the save's time on the fit's
    # thread and the writer thread's time
    from spark_ensemble_tpu_torch.utils import checkpoint as ckpt_mod

    spent = {"save_s": 0.0, "write_s": 0.0}
    real_save, real_write = ckpt_mod.TrainingCheckpointer.save, ckpt_mod.TrainingCheckpointer._write

    def timed_save(self, round_idx, state):
        t0 = time.perf_counter()
        real_save(self, round_idx, state)
        spent["save_s"] += time.perf_counter() - t0

    def timed_write(self, round_idx, state):
        t0 = time.perf_counter()
        real_write(self, round_idx, state)
        spent["write_s"] += time.perf_counter() - t0

    ckpt_mod.TrainingCheckpointer.save, ckpt_mod.TrainingCheckpointer._write = timed_save, timed_write
    configs = (("0", False), ("1", False), ("1", True), ("0", True))
    timing = {c: [] for c in configs}
    try:
        for turn in range(3):
            for depth, ck in (configs if turn % 2 == 0 else configs[::-1]):
                os.environ["SE_TPU_PIPELINE"] = depth
                est = gbm("fused", "highest", TIMED_ROUNDS)
                if ck:
                    est.set_params(checkpoint_dir=os.path.join(scratch, f"timing-{depth}-{turn}"),
                                   checkpoint_interval=10)
                spent.update(save_s=0.0, write_s=0.0)
                rate = TIMED_ROUNDS / fit_counted(est, X_np, y_np)[1]
                timing[depth, ck].append((rate, spent["save_s"], spent["write_s"]))
    finally:
        ckpt_mod.TrainingCheckpointer.save, ckpt_mod.TrainingCheckpointer._write = real_save, real_write
        os.environ.pop("SE_TPU_PIPELINE", None)
    median = {}
    for (depth, ck), rows in timing.items():
        median[depth, ck] = statistics.median(r[0] for r in rows)
        emit({"phase": "checkpoint_timing", "pipeline_depth": int(depth), "checkpoints": ck,
              "checkpoint_interval": 10 if ck else None, "rounds": TIMED_ROUNDS,
              "iters_per_s": median[depth, ck], "iters_per_s_runs": [r[0] for r in rows],
              "save_ms_per_fit": [r[1] * 1e3 for r in rows] if ck else None,
              "writer_ms_per_fit": [r[2] * 1e3 for r in rows] if ck else None, **card})
    emit({"phase": "checkpoint_timing",
          "checkpoint_cost_share_depth0": 1 - median["0", True] / median["0", False],
          "checkpoint_cost_share_depth1": 1 - median["1", True] / median["1", False],
          "depth1_gain_share": median["1", False] / median["0", False] - 1, **card})
    no_stray_retries("checkpoint_timing")

    # phase 23 (streaming): the out-of-core data plane.  bench.py's XL data
    # sealed into a shard store at the default 32768 rows a shard (64
    # shards), then a 3-round GBMClassifier fit_streaming beside the same
    # resident hist="stream" fit: every tree table and the probabilities
    # equal (torch.equal), each fit's rate and peak device memory, and the
    # prefetcher's stats.  Then squared and huber GBMRegressor streaming
    # fits on 8192x12 at 1024-row chunks and shards equal to their resident
    # twins, and a chaos preemption mid-shard resumed from its checkpoint,
    # equal to the uninterrupted fit.  The stream tier and the shard sweep
    # run torch matmuls: no kernel of csrc/hist.cu launches
    from spark_ensemble_tpu_torch.autotune.resolve import override
    from spark_ensemble_tpu_torch.data import streaming as streaming_mod
    from spark_ensemble_tpu_torch.data import write_shards
    from spark_ensemble_tpu_torch.serving import fit_resume as packed_fit_resume
    from spark_ensemble_tpu_torch.serving import load_packed, pack

    pf_stats = []
    real_prefetcher = streaming_mod.ShardPrefetcher

    class StatPrefetcher(real_prefetcher):
        """Keeps each fit's prefetch ledger at close: the per-round ledgers
        the fit takes (its shard I/O telemetry), summed."""

        def take_stats(self):
            out = super().take_stats()
            total = getattr(self, "_fit_total", None)
            if total is None:
                self._fit_total = dict(out)
            else:
                for k, v in out.items():
                    if k == "last_error":
                        total[k] = v or total[k]
                    else:
                        total[k] += v
            return out

        def close(self):
            if not self._closed:
                self.take_stats()
                pf_stats.append(self._fit_total)
            super().close()

    def same_params(a, b):
        la, lb = tree_leaves(a.params), tree_leaves(b.params)
        return len(la) == len(lb) and all(
            torch.equal(torch.as_tensor(x), torch.as_tensor(y_)) for x, y_ in zip(la, lb))

    def peak_fit(fit):
        """(model, seconds, peak device bytes, launches) of one fit; the peak
        counts what the fit allocated above what was held before it."""
        torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card before the peak-memory window opens
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        model = fit()
        torch.cuda.synchronize()
        return (model, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - held,
                dict(hk.LAUNCHES))

    no_launches = {k: 0 for k in hk.LAUNCHES}
    streaming_mod.ShardPrefetcher = StatPrefetcher
    try:
        X_xl_np, y_xl = xl_data()
        store_dir = os.path.join(scratch, "xl_store")
        t0 = time.perf_counter()
        store = write_shards(X_xl_np, store_dir, max_bins=MAX_BINS, device="cuda")
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(store_dir, f)) for f in os.listdir(store_dir))
        emit({"phase": "streaming", "check": "write_shards", "n": XL_ROWS, "d": XL_FEATURES,
              "shards": store.num_shards, "shard_rows": store.shard_rows, "bits": store.bits,
              "words_per_row": store.words_per_row, "write_s": write_s, "bytes_on_disk": disk,
              "packed_bytes": store.packed_nbytes, **card})
        if store.num_shards != XL_ROWS // 32768 or store.bits != 8:
            raise AssertionError(f"write_shards: {store.num_shards} shards at {store.bits} bits")
        xl_cls = _xl_stream_gbm(st, STREAM_FIT_ROUNDS)
        xl_fits = {}
        for way in ("resident", "streaming", "streaming", "resident"):
            pf_stats.clear()
            if way == "resident":
                fit = lambda: xl_cls.fit(X_xl_np, y_xl, device="cuda")
            else:
                fit = lambda: xl_cls.fit_streaming(store, y_xl, device="cuda")
            model, secs, peak, launches = peak_fit(fit)
            if launches != no_launches:
                raise AssertionError(f"streaming XL {way}: kernels launched {launches}")
            prev = xl_fits.get(way)
            xl_fits[way] = (model, min(secs, prev[1]) if prev else secs, peak,
                            pf_stats[0] if pf_stats else None)
        (res, res_s, res_peak, _), (stm, stm_s, stm_peak, stats) = xl_fits["resident"], xl_fits["streaming"]
        Xq = torch.as_tensor(X_xl_np[:262144], device=dev)
        equal = same_params(res, stm) and torch.equal(res.predict_proba(Xq), stm.predict_proba(Xq))
        emit({"phase": "streaming", "family": "GBMClassifier", "n": XL_ROWS, "rounds": STREAM_FIT_ROUNDS,
              "resident_fit_s": res_s, "streaming_fit_s": stm_s,
              "resident_iters_per_s": STREAM_FIT_ROUNDS / res_s,
              "streaming_iters_per_s": STREAM_FIT_ROUNDS / stm_s,
              "resident_peak_memory_bytes": res_peak, "streaming_peak_memory_bytes": stm_peak,
              "prefetch": stats, "prefetch_wait_share": stats["wait_s"] / stm_s,
              "prefetch_reuse_wait_share": stats["reuse_wait_s"] / stm_s,
              "bit_identical": equal, **card})
        if not equal:
            raise AssertionError("streaming XL classifier differs from its resident twin")
        if stats["loads"] != STREAM_FIT_ROUNDS * (DEPTH + 1) * store.num_shards or stats["errors"]:
            raise AssertionError(f"streaming XL prefetch stats {stats}")
        # kept for the elastic phase: the store, the labels, the streaming
        # fit's digest, and a store of the first STREAM_CHECK_ROWS rows with
        # its own single-process fit's digest
        from spark_ensemble_tpu_torch.parallel.mesh import params_digest

        xl = {"store": store_dir, "labels": os.path.join(scratch, "xl_labels.npy"),
              "digest": params_digest(stm.params),
              "rewind_store": os.path.join(scratch, "xl_rewind_store")}
        np.save(xl["labels"], y_xl)
        rewind_store = write_shards(X_xl_np[:STREAM_CHECK_ROWS], xl["rewind_store"],
                                    max_bins=MAX_BINS, device="cuda")
        xl["rewind_digest"] = params_digest(xl_cls.fit_streaming(
            rewind_store, y_xl[:STREAM_CHECK_ROWS], device="cuda").params)
        # where a streaming round goes, beside a resident one: one traced round each
        xl_one = xl_cls.copy(num_base_learners=1)
        profile_fit(xl_one, None, y_xl, store=store, tier="stream", way="streaming",
                    n=XL_ROWS, rounds=1, **card)
        profile_fit(xl_one, X_xl_np, y_xl, tier="stream", way="resident", n=XL_ROWS,
                    rounds=1, **card)
        del X_xl_np, Xq, res, stm, xl_fits
        torch.cuda.empty_cache()

        reg_stream = lambda loss, ck=None: st.GBMRegressor(
            num_base_learners=PARITY_ROUNDS, learning_rate=0.3, loss=loss, checkpoint_dir=ck,
            checkpoint_interval=5, base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, hist="stream"))
        with override(stream_chunk_rows=1024, shard_rows=1024):
            rstore = write_shards(Xr, os.path.join(scratch, "reg_store"), max_bins=MAX_BINS,
                                  device="cuda")
            for loss in ("squared", "huber"):
                res, res_s, _, _ = peak_fit(lambda: reg_stream(loss).fit(Xr, yr, device="cuda"))
                stm, stm_s, _, launches = peak_fit(
                    lambda: reg_stream(loss).fit_streaming(rstore, yr, device="cuda"))
                equal = same_params(res, stm) and torch.equal(res.predict(Xr), stm.predict(Xr))
                emit({"phase": "streaming", "family": f"GBMRegressor[{loss}]", "n": len(yr),
                      "shards": rstore.num_shards, "rounds": PARITY_ROUNDS,
                      "resident_iters_per_s": PARITY_ROUNDS / res_s,
                      "streaming_iters_per_s": PARITY_ROUNDS / stm_s, "launches": launches,
                      "bit_identical": equal, **card})
                if not equal or launches != no_launches:
                    raise AssertionError(f"streaming {loss}: equal {equal}, launches {launches}")
            site = "GBMRegressor:stream_round:12:level:2:shard:3"
            ckdir = os.path.join(scratch, "streaming-huber")
            ctl = FaultAt({"preempt": site})
            chaos_mod.install(ctl)
            try:
                reg_stream("huber", ckdir).fit_streaming(rstore, yr, device="cuda")
                raise AssertionError(f"streaming: the preemption at {site} did not fire")
            except chaos_mod.ChaosPreemption:
                pass
            finally:
                chaos_mod.install(None)
            resumed, secs, _, _ = peak_fit(
                lambda: reg_stream("huber", ckdir).fit_streaming(rstore, yr, device="cuda"))
            equal = same_params(resumed, stm) and torch.equal(resumed.predict(Xr), stm.predict(Xr))
            emit({"phase": "streaming", "family": "GBMRegressor[huber]", "check": "preempt_mid_shard",
                  "site": site, "fired": [list(f) for f in ctl.fired], "resume_fit_s": secs,
                  "bit_identical": equal, **card})
            if not ctl.fired or not equal:
                raise AssertionError(f"streaming resume: fired {ctl.fired}, equal {equal}")
    finally:
        streaming_mod.ShardPrefetcher = real_prefetcher
    no_stray_retries("streaming")

    # phase 24 (export): the timed 100-round fused model packed (equal to
    # the model bit for bit), saved and loaded back on the card (equal),
    # its 50-round prefix (equal to model.take(50)), and the 60-round model
    # of phase 21, packed and continued by 40 rounds (equal to the timed
    # 100-round fit; the new rounds launch 5/4/1 each)
    p_ref = timed_model.predict_proba(Xd)
    t0 = time.perf_counter()
    packed = pack(timed_model)
    pack_s = time.perf_counter() - t0
    packed_equal = torch.equal(packed.predict_proba(Xd), p_ref)
    path = os.path.join(scratch, "letter_gbm_packed")
    t0 = time.perf_counter()
    packed.save(path)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t0 = time.perf_counter()
    loaded = load_packed(path, device="cuda")
    loaded_p = loaded.predict_proba(Xd)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded_equal = torch.equal(loaded_p, p_ref)
    take_equal = torch.equal(packed.take(50).predict_proba(Xd), timed_model.take(50).predict_proba(Xd))
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    resumed = packed_fit_resume(pack(shorts["GBMClassifier[fused]"]), X_np, y_np, 40)
    resumed_p = resumed.predict_proba(Xd)
    torch.cuda.synchronize()
    resume_s, launches = time.perf_counter() - t0, dict(hk.LAUNCHES)
    resume_equal = torch.equal(resumed_p, p_ref)
    emit({"phase": "export", "family": "GBMClassifier", "rounds": TIMED_ROUNDS,
          "arrays": len(packed.array_names), "nbytes": packed.nbytes, "bytes_on_disk": nbytes,
          "pack_s": pack_s, "save_s": save_s, "load_and_predict_s": load_s,
          "packed_bit_identical": packed_equal, "loaded_bit_identical": loaded_equal,
          "take50_bit_identical": take_equal, "fit_resume_s": resume_s,
          "fit_resume_launches": launches, "fit_resume_bit_identical": resume_equal, **card})
    if not (packed_equal and loaded_equal and take_equal and resume_equal) \
            or launches != per_fit(TIMED_ROUNDS - 60):
        raise AssertionError(f"export: packed {packed_equal}, loaded {loaded_equal}, take "
                             f"{take_equal}, fit_resume {resume_equal}, launches {launches}")
    no_stray_retries("export")

    # phase 25 (telemetry): the timed main path (100 fused rounds) with the
    # JSONL sink and record_fits on, beside adjacent telemetry-off fits in
    # turns (off, on, on, off; bench.py's telemetry_overhead_pct, against
    # adjacent fits).  Telemetry only reads: the model must equal the
    # telemetry-off one bit for bit and launch the same 5/4/1 a round.  The
    # stream must hold 100 round_end events, phases summing to wall, the
    # card's memory, no builds (compile_count 0) and a span graph whose
    # parents and flows all resolve.  Then one fit at hist_precision
    # "pallas" (hist_i32) and a streaming fit's shard I/O tail.
    from spark_ensemble_tpu_torch import telemetry as tel

    def read_jsonl(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    def span_problems(events):
        """tools/trace_viewer.py's validate: orphan spans, dangling flows."""
        spans = [e for e in events if e.get("event") == "span"]
        ids = {s["span_id"] for s in spans}
        sources = {f for s in spans for f in (s.get("flow_out") or [])}
        return ([f"orphan {s['name']}" for s in spans
                 if s.get("parent_id") and s["parent_id"] not in ids]
                + [f"dangling flow {s['name']}" for s in spans
                   if s.get("flow_in") is not None and s["flow_in"] not in sources])

    def telemetry_fit(est, X_, y_, path):
        if os.path.exists(path):
            os.remove(path)
        with tel.record_fits() as rec:
            model, secs, launches = fit_counted(est.copy(telemetry_path=path), X_, y_)
        return model, secs, launches, read_jsonl(path), rec.events

    t_phase = time.perf_counter()  # each new phase reports its own seconds
    tel_path = os.path.join(scratch, "telemetry.jsonl")
    tel_runs = {"off": [], "on": []}
    for way in ("off", "on", "on", "off"):
        est = gbm("fused", "highest", TIMED_ROUNDS)
        tel_runs[way].append(telemetry_fit(est, X_np, y_np, tel_path) if way == "on"
                             else fit_counted(est, X_np, y_np))
    off_s = [r[1] for r in tel_runs["off"]]
    on_s = [r[1] for r in tel_runs["on"]]
    model_on, _, launches_on, events, recorded = tel_runs["on"][-1]
    model_off = tel_runs["off"][-1][0]
    ends = [e for e in events if e["event"] == "round_end"]
    fit_end = events[-1]
    phase_gap = abs(sum(fit_end["phases"].values()) - fit_end["wall_s"])
    mem = fit_end.get("memory", {}).get("gpu:0")
    same_model = same_params(model_on, model_off) and torch.equal(
        model_on.predict_proba(Xd), model_off.predict_proba(Xd))
    problems = span_problems(events)
    mfu = [e["mfu_est"] for e in ends if "mfu_est" in e]
    # the drift_ref_ capture every GBM fit now pays: the occupancy counted
    # on the card from the fit context's bins, [d, B] counts copied back
    from spark_ensemble_tpu_torch.telemetry.quality import drift_reference_from_ctx

    ctx = gbm("fused", "highest", 1)._base().make_fit_ctx(Xd)
    drift_ref_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drift_reference_from_ctx(ctx)
        drift_ref_s.append(time.perf_counter() - t0)
    emit({"phase": "telemetry", "rounds": TIMED_ROUNDS,
          "telemetry_overhead_pct": 100.0 * (sum(on_s) - sum(off_s)) / sum(off_s),
          "off_iters_per_s": [TIMED_ROUNDS / s for s in off_s],
          "on_iters_per_s": [TIMED_ROUNDS / s for s in on_s],
          "events": len(events), "recorded": len(recorded), "round_end": len(ends),
          "spans": sum(e["event"] == "span" for e in events),
          "phases": fit_end["phases"], "wall_s": fit_end["wall_s"],
          "phase_sum_gap_s": phase_gap, "compile_count": fit_end["compile_count"],
          "host_blocked_us": fit_end["host_blocked_us"], "memory_gpu0": mem,
          "round_duration_s_median": statistics.median(e["duration_s"] for e in ends),
          "mfu_est_median": statistics.median(mfu) if mfu else None,
          "hist_tier": ends[0].get("hist_tier"), "hbm_bytes_est": ends[0].get("hbm_bytes_est"),
          "history_rounds": len(model_on.fit_history_["round"]),
          "drift_ref_ms": 1e3 * statistics.median(drift_ref_s),
          "launches": launches_on, "bit_identical": same_model,
          "span_problems": problems[:5], "phase_s": time.perf_counter() - t_phase, **card})
    if (len(ends) != TIMED_ROUNDS or phase_gap > 1e-9 or not mem
            or fit_end["compile_count"] != 0 or not same_model or problems
            or len(recorded) != len(events)
            or len(model_on.fit_history_["round"]) != TIMED_ROUNDS
            or any(r[2] != per_fit(TIMED_ROUNDS) for r in tel_runs["on"] + tel_runs["off"])):
        raise AssertionError("telemetry: the stream or the model is off (see the line above)")

    t_phase = time.perf_counter()
    model_p, secs, launches, events, _ = telemetry_fit(
        gbm("matmul", "pallas", PARITY_ROUNDS), X_np, y_np, tel_path)
    ends = [e for e in events if e["event"] == "round_end"]
    emit({"phase": "telemetry", "check": "pallas", "rounds": PARITY_ROUNDS,
          "iters_per_s": PARITY_ROUNDS / secs, "launches": launches,
          "round_end": len(ends), "hist_tier": ends[0].get("hist_tier"),
          "loss_last": ends[-1].get("loss"), "step_size_last": ends[-1].get("step_size"),
          "compile_count": events[-1]["compile_count"],
          "phase_s": time.perf_counter() - t_phase, **card})
    if launches != want_launches["pallas"](PARITY_ROUNDS) or len(ends) != PARITY_ROUNDS \
            or ends[0].get("hist_tier") != "pallas":
        raise AssertionError(f"telemetry pallas: launches {launches}, {len(ends)} rounds")

    t_phase = time.perf_counter()
    g = tel.global_metrics()
    shard_names = ("data/shard_loads", "data/shard_bytes", "data/shard_prefetch_hits",
                   "data/shard_prefetch_misses")
    before = {k: g.counter(k).value for k in shard_names}
    stream_rounds = 5
    telemetry_fit_streaming = st.GBMRegressor(
        num_base_learners=stream_rounds, learning_rate=0.3, telemetry_path=tel_path,
        base_learner=st.DecisionTreeRegressor(max_depth=DEPTH, hist="stream"))
    os.remove(tel_path)
    t0 = time.perf_counter()
    telemetry_fit_streaming.fit_streaming(rstore, yr, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    events = read_jsonl(tel_path)
    counters = {k: g.counter(k).value - before[k] for k in shard_names}
    loads = [e for e in events if e.get("name") == "shard_load"]
    waits = [e for e in events if e.get("name") == "shard_wait"]
    io = [e for e in events if e["event"] in ("shard_load", "shard_prefetch_hit", "shard_wait_us")]
    problems = span_problems(events)
    emit({"phase": "telemetry", "check": "streaming", "rounds": stream_rounds,
          "shards": rstore.num_shards, "fit_s": secs, "counters": counters,
          "shard_load_spans": len(loads), "shard_wait_spans": len(waits),
          "misses_with_flow": sum(1 for w in waits if w.get("flow_in") is not None),
          "io_events_tail": io[-3:], "span_problems": problems[:5],
          "load_ms_median": 1e3 * statistics.median(s["dur_s"] for s in loads),
          "wait_ms_median": 1e3 * statistics.median(s["dur_s"] for s in waits),
          "phase_s": time.perf_counter() - t_phase, **card})
    visits = stream_rounds * (DEPTH + 1) * rstore.num_shards
    if (counters["data/shard_loads"] != visits or len(loads) != visits
            or len(waits) != visits or problems or len(io) != 3 * stream_rounds):
        raise AssertionError(f"telemetry streaming: {counters}, {len(loads)} load spans")

    # phase 25b (operator): the operator plane live around the main path.
    # Quiet and scraped 20-round fused fits take turns (quiet, scraped,
    # scraped, quiet, quiet, scraped; all under record_fits), each scraped
    # one under start_operator_plane(port=0) with a thread sweeping
    # /metrics, /programz?n=5, /healthz and /statusz four times a second
    # and an engine over a warmed model answering requests beside it.
    # Every exposition must pass the checker; each scraped fit must equal
    # the quiet one bit for bit; each kernel row's calls must equal the
    # launches counted and its bytes kernel_work at its shapes (at the
    # kernel table's shapes: bound_ms times the memory rate); every
    # round_end must carry the launch leg of the cost line; the hbm gauges
    # must read above 0; no build and no capture while the scrapes run.
    # Then a 5-round pallas-tier fit under the plane (hist_i32's row) and
    # a snapshot whose files validate.
    import threading
    import urllib.error
    import urllib.request

    from spark_ensemble_tpu_torch.telemetry import exporter as op_exporter, programz

    def fetch(url):
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def kernel_calls(inv):
        return {k: sum(r["calls"] for r in inv.kernel_rows(k)) for k in hk.LAUNCHES}

    t_phase = time.perf_counter()
    op_model = fit_counted(gbm("fused", "highest", PARITY_ROUNDS), X_np, y_np)[0]
    op_engine = st.InferenceEngine(op_model, methods=("predict_proba",), min_bucket=256,
                                   max_batch_size=1024)
    op_requests = [X_np[:200], X_np[:900]]
    op_problems, op_runs = [], {"quiet": [], "scraped": []}
    sampler_ticks, scrape_loops, health_codes = [], [], set()
    kernel_rows = {}
    for way in ("quiet", "scraped", "scraped", "quiet", "quiet", "scraped"):
        est = gbm("fused", "highest", PARITY_ROUNDS)
        if way == "quiet":
            with tel.record_fits() as rec:
                model, secs, launches = fit_counted(est, X_np, y_np)
            op_runs[way].append((model, secs, launches, rec.events))
            continue
        inv = programz.global_inventory()
        inv.clear()
        plane = op_exporter.start_operator_plane(port=0, sampler_interval_s=0.25,
                                                 watchdog_interval_s=0.5)
        stop, loops, codes = threading.Event(), [0], []

        def scraper():
            # any failure (a dropped connection, a body that is not JSON, a
            # missing key) ends the sweep and is a problem of the phase
            try:
                while not stop.is_set():
                    t_sweep = time.perf_counter()
                    code, body = fetch(plane.url + "/metrics")
                    codes.append(("/metrics", code))
                    op_problems.extend(op_exporter.validate_openmetrics(body))
                    code, body = fetch(plane.url + "/programz?n=5")
                    codes.append(("/programz", code))
                    if len(json.loads(body)["programs"]) > 5:
                        op_problems.append("/programz?n=5 gave more than 5 rows")
                    code, body = fetch(plane.url + "/healthz")
                    health_codes.add(code)
                    codes.append(("/healthz", 200 if "status" in json.loads(body) else code))
                    code, body = fetch(plane.url + "/statusz")
                    codes.append(("/statusz", code))
                    if json.loads(body)["backend"] != "cuda":
                        op_problems.append("/statusz backend is not cuda")
                    loops[0] += 1
                    stop.wait(max(0.0, 0.25 - (time.perf_counter() - t_sweep)))
            except Exception as e:  # noqa: BLE001 - reported below
                op_problems.append(f"scraper: {type(e).__name__}: {e}")

        builds = tel.compile_snapshot()
        served = op_engine.stats()["compiles_since_warmup"]
        thread = threading.Thread(target=scraper, daemon=True)
        thread.start()
        try:
            for Xq in op_requests:
                op_engine.predict_proba(Xq)
            with tel.record_fits() as rec:
                model, secs, launches = fit_counted(est, X_np, y_np)
            for Xq in op_requests:
                op_engine.predict_proba(Xq)
            deadline = time.perf_counter() + 5.0
            while (plane.sampler.ticks < 1 or loops[0] < 2) and time.perf_counter() < deadline:
                time.sleep(0.05)
        finally:
            stop.set()
            thread.join(timeout=60)
        built = tel.compile_snapshot()[0] - builds[0]
        captured = op_engine.stats()["compiles_since_warmup"] - served
        hbm = {k: v.get("value") for k, v in tel.global_metrics().snapshot().items()
               if k.startswith("hbm/gpu:0/")}
        calls = kernel_calls(inv)
        rows = {k: inv.kernel_rows(k) for k in hk.LAUNCHES}
        progs = [r for r in inv.rows() if r["tag"] == "gbm_cls_round"]
        sampler_ticks.append(plane.sampler.ticks)
        scrape_loops.append(loops[0])
        plane.stop()  # raises if the sampler failed
        bad_codes = [c for c in codes if c[1] != 200]
        if (thread.is_alive() or bad_codes or built or captured or loops[0] < 2
                or plane.sampler.ticks < 1 or not any(c[0] == "/metrics" for c in codes)):
            op_problems.append(f"scraper alive {thread.is_alive()}, loops {loops[0]}, "
                               f"sampler ticks {plane.sampler.ticks}, {len(codes)} codes, "
                               f"bad {bad_codes[:3]}, builds {built}, captures {captured}")
        if calls != launches or launches != per_fit(PARITY_ROUNDS):
            op_problems.append(f"kernel calls {calls} against launches {launches}")
        if not hbm or min(hbm.values()) <= 0:
            op_problems.append(f"hbm gauges {hbm}")
        if not progs or sum(r["calls"] for r in progs) < 1:
            op_problems.append("no gbm_cls_round program row")
        op_runs[way].append((model, secs, launches, rec.events))
        kernel_rows, op_hbm = rows, hbm
    quiet_model = op_runs["quiet"][0][0]
    bit_identical = [same_params(r[0], quiet_model) for r in op_runs["scraped"] + op_runs["quiet"]]
    # each kernel row at the kernel table's shapes: bytes a call equal to
    # kernel_work there (the table's bound_ms is kernel_work over the
    # memory rate, so the two agree by construction)
    W8 = -(-N_FEATURES // (32 // binning.pack_width(MAX_BINS)))
    table_shapes = {
        "hist_packed": dict(n=N_ROWS, d=N_FEATURES, W=W8, M=N_CLASSES, C=2, B=MAX_BINS,
                            n_nodes=2 ** (DEPTH - 1)),
        "route_packed": dict(n=N_ROWS, W=W8, M=N_CLASSES, half=2 ** (DEPTH - 2)),
        "leaf_sums": dict(n=N_ROWS, M=N_CLASSES, C=2, leaves=2 ** DEPTH, W=W8,
                          half=2 ** (DEPTH - 1)),
    }
    bytes_rows = {}
    for k, shapes in table_shapes.items():
        # a level histogram's signature on the card also holds its plan's clusters
        row = next((r for r in kernel_rows[k]
                    if {a: v for a, v in map(tuple, r["signature"]) if a != "clusters"} == shapes),
                   None)
        want = hk.kernel_work(k, **shapes)[0]
        bytes_rows[k] = {"row_bytes_per_call": None if row is None else row["bytes"] / row["calls"],
                         "kernel_work": want, "calls": None if row is None else row["calls"]}
        if row is None or row["bytes"] != want * row["calls"] or row["calls"] != PARITY_ROUNDS:
            op_problems.append(f"{k}: row {bytes_rows[k]}")
    scraped_events = op_runs["scraped"][-1][3]
    ends = [e for e in scraped_events if e["event"] == "round_end"]
    three_way = [e for e in ends if e.get("program_tag") == "gbm_cls_round"
                 and e.get("xla_bytes_accessed") and e.get("xla_modeled_s")]
    per_round_bytes = sum(hk.kernel_work(k, **dict(map(tuple, r["signature"])))[0] * r["calls"]
                          for k in ("hist_packed", "route_packed", "leaf_sums")
                          for r in kernel_rows[k]) / PARITY_ROUNDS
    if len(three_way) != PARITY_ROUNDS or any(
            abs(e["xla_bytes_accessed"] - per_round_bytes) > 1e-6 * per_round_bytes for e in ends):
        op_problems.append(f"round_end: {len(three_way)} of {len(ends)} carry the launch leg")
    # deep analysis: the next call's allocator peak, never resetting it
    inv = programz.enable()
    inv.clear()
    fit_counted(gbm("fused", "highest", PARITY_ROUNDS), X_np, y_np)
    inv.analyze_pending(deep=True)
    deep_model = fit_counted(gbm("fused", "highest", PARITY_ROUNDS), X_np, y_np)[0]
    deep_row = next(r for r in inv.rows() if r["tag"] == "gbm_cls_round")
    # the pallas tier under the plane: hist_i32's row
    inv.clear()
    plane = op_exporter.start_operator_plane(port=0, watchdog_interval_s=3600.0)
    try:
        _, pallas_s, pallas_launches = fit_counted(gbm("matmul", "pallas", 5), X_np, y_np)
        pallas_calls = kernel_calls(inv)
        snap = op_exporter.write_snapshot(os.path.join(scratch, "operator_snapshot"),
                                          inventory=inv)
    finally:
        plane.stop()
    with open(snap["metrics"]) as f:
        snapshot_problems = op_exporter.validate_openmetrics(f.read())
    op_engine.release()
    if pallas_calls != pallas_launches or pallas_launches["hist_i32"] != DEPTH * 5:
        op_problems.append(f"pallas: kernel calls {pallas_calls} against {pallas_launches}")
    if snapshot_problems or not all(bit_identical) or not same_params(deep_model, quiet_model):
        op_problems.append(f"snapshot {snapshot_problems[:3]}, bit identical {bit_identical}")
    quiet_s = [r[1] for r in op_runs["quiet"]]
    scraped_s = [r[1] for r in op_runs["scraped"]]
    emit({"phase": "operator", "rounds": PARITY_ROUNDS,
          "exporter_overhead_pct": 100.0 * (sum(scraped_s) - sum(quiet_s)) / sum(quiet_s),
          "quiet_iters_per_s": [PARITY_ROUNDS / x for x in quiet_s],
          "scraped_iters_per_s": [PARITY_ROUNDS / x for x in scraped_s],
          "scrape_loops": scrape_loops, "sampler_ticks": sampler_ticks,
          "healthz_codes": sorted(health_codes), "bit_identical": bit_identical,
          "kernel_calls": {k: sum(r["calls"] for r in v) for k, v in kernel_rows.items()},
          "kernel_bytes_at_table_shapes": bytes_rows,
          "per_round_launch_bytes": per_round_bytes,
          "round_end_three_way": len(three_way),
          "three_way_median": {k: statistics.median(e[k] for e in ends) for k in (
              "duration_s", "modeled_s", "xla_modeled_s", "mfu_est", "mfu_xla")},
          "three_way_last": {k: ends[-1].get(k) for k in (
              "duration_s", "modeled_s", "xla_modeled_s", "xla_bytes_accessed", "xla_flops",
              "mfu_est", "mfu_xla", "xla_vs_analytic_flops_ratio", "hbm_bytes_est")},
          "hbm_gauges": op_hbm,
          "deep": {k: deep_row.get(k) for k in ("peak_hbm_bytes", "peak_hbm_bytes_at_most",
                                                 "flops", "bytes_accessed", "calls")},
          "pallas_kernel_calls": pallas_calls, "pallas_fit_s": pallas_s,
          "snapshot_files": sorted(os.path.basename(v) for v in snap.values()),
          "problems": op_problems[:8], "phase_s": time.perf_counter() - t_phase, **card})
    if op_problems:
        raise AssertionError(f"operator: {op_problems[:5]}")

    # phase 25c (autotune): the smoke search, the kernel knobs at the main
    # path's shapes, the main path off / empty cache / winners / each R,
    # mode "search" and the build cache (autotune_phase)
    autotune_phase(st, hk, binning, X_np, y_np, scratch, device_ms, card)
    no_stray_retries("autotune")

    # phase 26 (profile_dir): a 3-round fused fit with profile_dir; the
    # capture's device rows (utils/profiling.py) must name the three kernels
    from spark_ensemble_tpu_torch.utils import profiling as prof_mod

    t_phase = time.perf_counter()
    prof_dir = os.path.join(scratch, "profile")
    _, secs, launches = fit_counted(gbm("fused", "highest", 3).copy(profile_dir=prof_dir),
                                    X_np, y_np)
    rows, total_us = prof_mod.summarize_trace(prof_dir, top=10_000)
    named = {k: sum(c for n, _, c in rows if k in n) for k in ("level_hist", "route_packed",
                                                               "leaf_sums")}
    emit({"phase": "profile_dir", "rounds": 3, "fit_s": secs, "launches": launches,
          "trace_files": len(prof_mod.find_trace_files(prof_dir)), "device_rows": len(rows),
          "device_total_ms": total_us / 1e3, "kernel_slices": named,
          "top": [dict(r, op=r["op"][:90]) for r in prof_mod.rows_to_records(rows[:6], total_us)],
          "phase_s": time.perf_counter() - t_phase, **card})
    if not all(named.values()) or launches != per_fit(3):
        raise AssertionError(f"profile_dir: kernel slices {named}, launches {launches}")

    # phase 27 (serving): an InferenceEngine over the timed 100-round,
    # 26-class model: buckets 8..4096, predict and predict_proba, prefix
    # tiers 25 and 50, one CUDA graph each (60), captured at warmup; then a
    # mixed load that must capture nothing, outputs against the model,
    # four threads of queued requests, latency per bucket, rows/s, and the
    # drift sketch (training rows raise no alert, shifted rows do; the
    # graph's sketch equals an eager bin_occupancy of the same padded rows)
    import threading

    from spark_ensemble_tpu_torch.ops.binning import Bins, bin_occupancy
    from spark_ensemble_tpu_torch.serving import InferenceEngine
    from spark_ensemble_tpu_torch.telemetry.quality import DriftMonitor

    class RecordingMonitor(DriftMonitor):
        """Keeps the histograms it is handed while ``record`` is set."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.record, self.seen = False, []

        def observe(self, counts, pad_rows=0):
            if self.record:
                self.seen.append((np.array(counts), pad_rows))
            super().observe(counts, pad_rows)

    t_phase = time.perf_counter()
    quality = pack(timed_model).quality
    monitor = RecordingMonitor(quality["thresholds"], quality["occupancy"],
                               window_rows=2048, stream="chip_smoke")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(timed_model, methods=("predict", "predict_proba"), min_bucket=8,
                          max_batch_size=4096, prefix_tiers=(25, 50), drift_monitor=monitor)
    warm_s = time.perf_counter() - t0
    stats0 = eng.stats()
    alerts0 = g.counter("quality/alerts_total").value
    warm_per_bucket = {b: 0.0 for b in eng.buckets}
    for key, s in stats0["compiled"].items():
        warm_per_bucket[int(key.split("@")[1].split("~")[0])] += s
    try:
        p_all = timed_model.predict_proba(Xd).cpu().numpy()
        gaps = []
        for n in (1, 7, 100, 3000, 5000):
            out = eng.predict(X_np[:n], method="predict_proba")
            ref = timed_model.predict_proba(Xd[:n]).cpu().numpy()
            labels_equal = np.array_equal(eng.predict(X_np[:n]),
                                          timed_model.predict(Xd[:n]).cpu().numpy())
            gaps.append({"n": n, "bit_identical": bool(np.array_equal(out, ref)),
                         "max_abs_diff": float(np.abs(out - ref).max()),
                         "within_rtol_1e-5": bool(np.allclose(out, ref, rtol=1e-5, atol=1e-6)),
                         "labels_equal": bool(labels_equal)})
        tier_ok = {k: bool(np.allclose(eng.predict(X_np[:100], method="predict_proba", tier=k),
                                       timed_model.take(k).predict_proba(Xd[:100]).cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)) for k in (25, 50)}
        # four client threads, 40 queued requests each of 1-64 rows
        futures = [[] for _ in range(4)]

        def client(t):
            rng_c = np.random.RandomState(t)
            for _ in range(40):
                lo, n = int(rng_c.randint(0, N_ROWS - 64)), int(rng_c.randint(1, 65))
                futures[t].append((lo, n, eng.submit(X_np[lo:lo + n], method="predict_proba")))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        queued = [(lo, n, f.result(timeout=120)) for fs in futures for lo, n, f in fs]
        queue_ok = all(np.allclose(out, p_all[lo:lo + n], rtol=1e-5, atol=1e-6)
                       for lo, n, out in queued)
        queue_gap = max(float(np.abs(out - p_all[lo:lo + n]).max()) for lo, n, out in queued)
        # latency per bucket: 20 synchronous requests of each bucket's rows
        latency = {}
        for b in eng.buckets:
            lat = []
            for i in range(20):
                lo = (i * 997) % (N_ROWS - b + 1)  # other rows each time
                t0 = time.perf_counter()
                eng.predict(X_np[lo:lo + b], method="predict_proba")
                lat.append(1e3 * (time.perf_counter() - t0))
            latency[b] = {"p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99))}
        # rows/s: all 15000 rows in one call (4096-row chunks), the same
        # rows as 235 queued requests of 64, and the model's own predict
        def best_of(fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- drains the card so the timed window opens idle
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return min(times)

        sync_s = best_of(lambda: eng.predict(X_np, method="predict_proba"))
        queue_s = best_of(lambda: [f.result(timeout=120) for f in [
            eng.submit(X_np[i:i + 64], method="predict_proba") for i in range(0, N_ROWS, 64)]])
        model_s = best_of(lambda: timed_model.predict_proba(Xd).cpu())
        compiles = eng.stats()["compiles_since_warmup"]
        # drift: everything served so far is training rows (no alert); then
        # 4096 shifted rows close a window that raises the alert, and 4096
        # training rows one that clears it
        alerts_trained = g.counter("quality/alerts_total").value - alerts0
        trained = monitor.snapshot()
        eng.predict(X_np[:4096] + 1.5, method="predict_proba")
        shifted = monitor.snapshot()
        eng.predict(X_np[4096:8192], method="predict_proba")
        cleared = monitor.snapshot()
        # the graph's sketch against an eager bin_occupancy of the same rows
        monitor.record = True
        sketch_ok = True
        bins = Bins(thresholds=torch.as_tensor(quality["thresholds"], device=dev))
        for n in (5, 100, 4096):
            monitor.seen.clear()
            eng.predict(X_np[:n])
            (counts, pad), = monitor.seen
            b = eng.bucket_for(n)
            padded = torch.zeros((b, N_FEATURES), device=dev)
            padded[:n] = Xd[:n]
            sketch_ok &= pad == b - n and np.array_equal(
                counts, bin_occupancy(padded, bins).cpu().numpy())
        monitor.record = False
        compiles = max(compiles, eng.stats()["compiles_since_warmup"])
    finally:
        eng.stop()
        monitor.close()
    emit({"phase": "serving", "rounds": TIMED_ROUNDS, "classes": N_CLASSES,
          "buckets": list(eng.buckets), "graphs": len(stats0["compiled"]),
          "warmup_s": warm_s, "warmup_s_per_bucket": warm_per_bucket,
          "compiles_at_warmup": len(stats0["compiled"]), "compiles_since_warmup": compiles,
          "outputs": gaps, "tiers_within_rtol": tier_ok,
          "queued_requests": len(queued), "queued_within_rtol": queue_ok,
          "queued_max_abs_diff": queue_gap, "latency_ms": latency,
          "sync_rows_per_s": N_ROWS / sync_s, "queue_rows_per_s": N_ROWS / queue_s,
          "model_predict_proba_rows_per_s": N_ROWS / model_s,
          "drift_training": {k: trained.get(k) for k in ("windows", "psi_max", "alert_active")},
          "drift_shifted": {k: shifted.get(k) for k in ("windows", "psi_max", "alert_active")},
          "drift_cleared": {k: cleared.get(k) for k in ("windows", "psi_max", "alert_active")},
          "alerts_on_training_rows": alerts_trained,
          "alerts": g.counter("quality/alerts_total").value - alerts0,
          "sketch_equals_eager": bool(sketch_ok), "phase_s": time.perf_counter() - t_phase,
          **card})
    if (compiles != 0 or len(stats0["compiled"]) != 60
            or not all(x["bit_identical"] for x in gaps) or not all(tier_ok.values())
            or not queue_ok or len(queued) != 160 or trained["alert_active"]
            or alerts_trained != 0
            or not shifted["alert_active"] or cleared["alert_active"] or not sketch_ok):
        raise AssertionError("serving: see the line above")
    no_stray_retries("telemetry and serving")

    # phase 28 (fleet): the closed serving loop over the timed model
    # (fleet_phase): registry, fleet, faults, swaps, the autopilot's
    # background refresh, shadow rollback, refresh_crash and eviction
    fleet_phase(st, hk, chaos_mod, timed_model, X_np, y_np,
                lambda r: gbm("fused", "highest", r), scratch,
                {"latency_ms": latency, "sync_rows_per_s": N_ROWS / sync_s}, per_fit, card)
    no_stray_retries("fleet")

    # phase 29 (distributed): the SPMD fits over torch.distributed
    distributed_phase(st, hk, X_np, y_np, scratch, per_fit, card)
    no_stray_retries("distributed")

    # phase 30 (elastic): the distributed shard sweep, the elastic rewind
    # and the rest of the mesh planes (elastic_phase)
    elastic_phase(scratch, xl, card)
    no_stray_retries("elastic")

    # phase 31 (analysis): the port's lint, the native libsvm parser and
    # the program contracts held on the card (analysis_phase)
    analysis_phase(scratch, card)
    no_stray_retries("analysis")
    shutil.rmtree(scratch, ignore_errors=True)

    no_stray_retries("all phases")
    emit({"phase": "profiler", "empty_traces_retried": empty_traces[0]})
    emit({"kernels": [r.json() for r in recs.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


ROW_PHASES = {"--tall-rows": tall_rows_phase, "--wide-rows": wide_rows_phase,
              "--row-lists": row_lists_phase}


def rows_main(phase):
    """``python3 chip_smoke.py --tall-rows``, ``--wide-rows`` or
    ``--row-lists``: the build and the tall-row level histograms
    (tall_rows_phase), the wide-row kernels (wide_rows_phase) or the
    compact level histograms (row_lists_phase) alone, then the card's name
    and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from spark_ensemble_tpu_torch.ops import binning, hist_kernels as hk

    t0 = time.perf_counter()
    emit({"phase": "build", "library": hk.build_kernels().name,
          "seconds": time.perf_counter() - t0})
    phase(torch, hk, binning, torch.device("cuda"))
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] in ROW_PHASES:
        sys.exit(rows_main(ROW_PHASES[sys.argv[1]]))
    if len(sys.argv) == 3 and sys.argv[1] == "--distributed-rank":
        sys.exit(distributed_rank(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--elastic-rank":
        sys.exit(elastic_rank(json.loads(sys.argv[2])))
    sys.exit(main())
