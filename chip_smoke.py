#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It builds
the port's CUDA kernels from ``spark_ensemble_tpu_torch/csrc`` with nvcc,
holds every kernel against its plain PyTorch version at the main path's
shapes and beside them (the GBM path's C=2 statistics, and the forests'
at M=10 and M=1 with Poisson weights: the classifiers' C=27 on letter, the
regressors' C=2 on 8192x12 data), times each kernel
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
``refresh_crash``, and an eviction that frees device memory (``fleet``).  It checks the results; each phase prints one JSON line; any failed check raises,
and so does a retry that no chaos fault injected, and the script exits
non-zero.  Checkpoints and saves go to a scratch directory under
``build/``, removed at the end.
The last two lines are the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when CUDA is unavailable or when the
port's package is not beside it.
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
            torch.cuda.synchronize()

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
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        traces = []
        for _ in range(runs):
            for _ in range(4):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
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
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        pair = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(torch.equal(x, y) for x, y in pair):
            raise AssertionError(f"{rec.name}: two launches differ ({what})")

    def bound(nbytes, nops):
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
        nbytes = 4 * (words.numel() + node.numel() + vals.numel() + acc.numel())
        b_ms, b_by = bound(nbytes, n * M * C * d)
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
                    r_bytes = 4 * (packed.numel() + 2 * parent.numel() + 2 * bf.numel())
                    r_ms, r_by = bound(r_bytes, n * M)
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
                    lb = 4 * (packed.numel() + parent.numel() + node_out.numel() + vals.numel()
                              + bf.numel() + bt.numel() + H.numel())
                    l_ms, l_by = bound(lb, n * M * C)
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
        plan = hk.leaf_plan(n, Mc, Cc, n_nodes, half, packed.shape[1] if half else 0)
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

        def shape_row(rec, run, nbytes, nops, plan, library, **row):
            b_ms, b_by = bound(nbytes, nops)
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
                    shape_row(rec, run, 4 * (words.numel() + node.numel() + vals.numel() + out_floats),
                              n * Mc * Cc * d, plan, lib, **common, level=level, n_nodes=n_nodes)
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
            shape_row(rrec, run_r, 4 * (packed.numel() + 2 * parent.numel() + 2 * bf.numel()), n * Mc,
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
                nbytes = 4 * (packed.numel() + 2 * parent.numel() + vals.numel() + 2 * bf.numel() + L.numel())
                shape_row(lrec, run_l, nbytes, n * Mc * Cc,
                          hk.leaf_plan(n, Mc, Cc, 2 * half, half, packed.shape[1]),
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
        torch.cuda.synchronize()
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

    # where a fused fit's time goes: device time by kernel over a fit
    # (setup included), counting device-side events only (the CPU ops
    # that launched them carry the same time again)
    def profile_fit(est, X_, y_, store=None, **row):
        """``store``: trace ``est.fit_streaming(store, y_)`` instead."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if store is None:
                _, wall, _ = fit_counted(est, X_, y_)
            else:
                torch.cuda.synchronize()
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
    bag_acc = {}
    for tier, hist, hp in tiers:
        est = st.BaggingClassifier(num_base_learners=10, subspace_ratio=0.5, base_learner=cls_tree(hist, hp))
        _, bag_acc[tier] = family_run("bagging", "BaggingClassifier", tier, est, X_np, y_np,
                                      lambda m, launches: 1, accuracy)
    near("BaggingClassifier", bag_acc, "accuracy", 0.02)
    bag_rmse = {}
    for tier in ("matmul", "fused"):
        est = st.BaggingRegressor(num_base_learners=10, subspace_ratio=0.5, base_learner=reg_tree(tier))
        _, bag_rmse[tier] = family_run("bagging", "BaggingRegressor", tier, est, Xr, yr,
                                       lambda m, launches: 1, rmse)
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
    models, rmses_b = {}, {}
    for tier in ("matmul", "fused"):
        est = st.BoostingRegressor(num_base_learners=PARITY_ROUNDS, voting_strategy="median",
                                   base_learner=reg_tree(tier))
        models[tier], rmses_b[tier] = family_run("boosting", "BoostingRegressor[median]", tier, est,
                                                 Xr, yr, boost_rounds, rmse)
    first_round_moved("BoostingRegressor[median]", models, Xr,
                      lambda a, b: (a - b).abs() > 1e-3 * float(np.std(yr)))
    near("BoostingRegressor[median]", rmses_b, "rmse", 0.02)

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
        torch.cuda.synchronize()
        for s in range(lanes):
            got = wide(s)
            if not torch.equal(got, narrow(s)):
                raise AssertionError(f"{rec.name}: lane {s} of the M={Ml} launch differs from its "
                                     f"own M={N_CLASSES} launch ({what})")

    def sweep_row(rec, run, nbytes, nops, plan, library_device_ms, **row):
        b_ms, b_by = bound(nbytes, nops)
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
            sweep_row(rec, run, 4 * (words.numel() + node.numel() + vals_w.numel() + out_floats),
                      N_ROWS * Ml * C * N_FEATURES, plan, lib_dev, level=level, n_nodes=n_nodes)
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
    sweep_row(rrec, run_r, 4 * (packed64.numel() + 2 * parent.numel() + 2 * bf.numel()), N_ROWS * Ml,
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
    sweep_row(lrec, run_l, 4 * (packed64.numel() + 2 * parent.numel() + vals_w.numel() + 2 * bf.numel()
                                + L.numel()), N_ROWS * Ml * C,
              hk.lane_leaf_plan(N_ROWS, Ml, C, 2 * half, half, packed64.shape[1], lanes),
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
        dev, N_ROWS, N_FEATURES, N_CLASSES, 0).fingerprint)
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
        torch.cuda.synchronize()
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
        xl_cls = st.GBMClassifier(num_base_learners=STREAM_FIT_ROUNDS, loss="logloss",
                                  updates="newton", learning_rate=0.3,
                                  base_learner=st.DecisionTreeRegressor(hist="stream"))
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
              "bit_identical": equal, **card})
        if not equal:
            raise AssertionError("streaming XL classifier differs from its resident twin")
        if stats["loads"] != STREAM_FIT_ROUNDS * (DEPTH + 1) * store.num_shards or stats["errors"]:
            raise AssertionError(f"streaming XL prefetch stats {stats}")
        # where a streaming round goes, beside a resident one: one traced round each
        xl_one = xl_cls.copy(num_base_learners=1)
        profile_fit(xl_one, None, y_xl, store=store, tier="stream", way="streaming",
                    n=XL_ROWS, rounds=1, **card)
        profile_fit(xl_one, X_xl_np, y_xl, tier="stream", way="resident", n=XL_ROWS,
                    rounds=1, **card)
        del X_xl_np, Xq, res, stm, xl_fits
        shutil.rmtree(store_dir, ignore_errors=True)
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
                torch.cuda.synchronize()
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
    shutil.rmtree(scratch, ignore_errors=True)

    no_stray_retries("all phases")
    emit({"phase": "profiler", "empty_traces_retried": empty_traces[0]})
    emit({"kernels": [r.json() for r in recs.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
