"""The port's shard stores, prefetcher, manifest partitioning and autotune
resolution (``spark_ensemble_tpu_torch/data/shards.py``, ``prefetch.py``,
``partition.py``, ``autotune/resolve.py``), case for case with
tests/test_streaming.py where the case exists in the port, plus the
cross-package contract: a store written by either package opens in the
other with equal thresholds and array-equal packed words.

Tolerances: none.  Thresholds are the JAX package's bit for bit (the
port's ``compute_bins`` restates ``jnp.quantile``), bin ids and packed
words are integers, and the partition helpers are pure integer functions.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.data import ShardStore as JaxShardStore
from spark_ensemble_tpu.data import partition as jpart
from spark_ensemble_tpu.data import write_shards as jax_write_shards
from spark_ensemble_tpu.ops.binning import bin_features as jax_bin_features
from spark_ensemble_tpu.ops.binning import compute_bins as jax_compute_bins
from spark_ensemble_tpu.ops.binning import pack_bins as jax_pack_bins
from spark_ensemble_tpu.autotune.space import TUNABLES as JAX_TUNABLES
from spark_ensemble_tpu_torch.autotune.resolve import (
    MODE_ENV,
    TUNABLES,
    autotune_mode,
    override,
    resolve,
    search,
)
from spark_ensemble_tpu_torch.data import (
    DEFAULT_SHARD_ROWS,
    PartitionedShardReader,
    ShardLoadError,
    ShardPartition,
    ShardPrefetcher,
    ShardStore,
    manifest_digest,
    partition_shards,
    write_shards,
)
from spark_ensemble_tpu_torch.data import partition as tpart
from spark_ensemble_tpu_torch.ops import tree as tt
from spark_ensemble_tpu_torch.ops.binning import (
    bin_features,
    compute_bins,
    pack_bins,
)


def _data(n=157, d=5, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32)


def _store(tmp_path, X, shard_rows=64, max_bins=16, name="store"):
    return write_shards(X, str(tmp_path / name), max_bins=max_bins,
                        shard_rows=shard_rows, device="cpu")


# ---------------------------------------------------------------------------
# shard store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_bins,bits", [(16, 4), (64, 8), (300, 32)])
def test_write_shards_roundtrip(tmp_path, max_bins, bits):
    X = _data()
    store = _store(tmp_path, X, max_bins=max_bins)
    assert (store.n, store.d) == X.shape
    assert store.num_shards == 3 and store.shard_rows == 64
    assert store.max_bins == max_bins and store.bits == bits

    bins = compute_bins(torch.as_tensor(X), max_bins)
    np.testing.assert_array_equal(store.thresholds, bins.thresholds.numpy())
    # each shard's words equal slicing a whole-matrix packing, zero-padded
    full = pack_bins(bin_features(torch.as_tensor(X), bins), max_bins).packed.numpy()
    for s in range(store.num_shards):
        want = full[s * 64:(s + 1) * 64].view(np.uint32)
        got = store.load_shard(s)
        assert got.dtype == np.uint32 and got.shape == (64, store.words_per_row)
        np.testing.assert_array_equal(got[: len(want)], want)
        assert not got[len(want):].any()
        assert store.shard_meta(s)["rows"] == len(want)
    assert store.packed_nbytes == sum(
        store.shard_meta(s)["bytes"] for s in range(store.num_shards)
    )


def test_write_shards_overwrite_flag(tmp_path):
    X = _data()
    _store(tmp_path, X)
    with pytest.raises(FileExistsError):
        _store(tmp_path, X)
    store = write_shards(X, str(tmp_path / "store"), max_bins=16, shard_rows=50,
                         overwrite=True, device="cpu")
    assert store.shard_rows == 50 and store.num_shards == 4
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".shards-")]


def test_write_shards_default_rows_resolve(tmp_path):
    """``shard_rows`` resolves through the autotune layer: the default,
    clamped to n, unless an override sets it."""
    X = _data()
    assert _store(tmp_path, X, shard_rows=None, name="a").shard_rows == min(
        DEFAULT_SHARD_ROWS, len(X))
    with override(shard_rows=40):
        assert _store(tmp_path, X, shard_rows=None, name="b").num_shards == 4


def test_open_rejects_format_mismatch(tmp_path):
    store = _store(tmp_path, _data())
    mpath = os.path.join(store.directory, "manifest.json")
    raw = open(mpath).read().replace('"format": 1', '"format": 999')
    open(mpath, "w").write(raw)
    with pytest.raises(ValueError, match="format"):
        ShardStore.open(store.directory)


def test_open_rejects_truncation(tmp_path):
    store = _store(tmp_path, _data())
    fpath = os.path.join(store.directory, store.shard_meta(1)["file"])
    with open(fpath, "r+b") as f:
        f.truncate(os.path.getsize(fpath) - 8)
    # the size check runs even with verify=False
    with pytest.raises(ValueError, match="truncated"):
        ShardStore.open(store.directory, verify=False)


def test_open_rejects_corruption(tmp_path):
    store = _store(tmp_path, _data())
    fpath = os.path.join(store.directory, store.shard_meta(0)["file"])
    size = os.path.getsize(fpath)
    with open(fpath, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(ValueError, match="sha256"):
        ShardStore.open(store.directory)
    ShardStore.open(store.directory, verify=False)  # explicit opt-out


def test_open_subset_verifies_and_refuses_outside(tmp_path):
    store = _store(tmp_path, _data())
    sub = ShardStore.open(store.directory, shards=[0, 2])
    assert sub.verified_shards == frozenset({0, 2})
    np.testing.assert_array_equal(sub.load_shard(2), store.load_shard(2))
    with pytest.raises(ValueError, match="verified subset"):
        sub.load_shard(1)
    with pytest.raises(ValueError, match="out of range"):
        ShardStore.open(store.directory, shards=[3])


def test_load_checks_the_zip_crc_after_open(tmp_path):
    """A shard changed after ``open`` fails its zip CRC at read, as
    ``np.load`` would; a member the fast reader does not know (a
    compressed npz) reads through ``np.load``."""
    X = _data()
    store = _store(tmp_path, X)
    want = [store.load_shard(s) for s in range(store.num_shards)]
    fpath = os.path.join(store.directory, store.shard_meta(1)["file"])
    size = os.path.getsize(fpath)
    with open(fpath, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC"):
        store.load_shard(1)
    np.testing.assert_array_equal(store.load_shard(0), want[0])
    other = _store(tmp_path, X, name="compressed")
    words = other.load_shard(2)[: other.shard_meta(2)["rows"]]
    fpath = os.path.join(other.directory, other.shard_meta(2)["file"])
    np.savez_compressed(fpath, packed=words)
    # a handle on the rewritten file (open would refuse its new size)
    fresh = ShardStore(other.directory, other._manifest, other.thresholds)
    np.testing.assert_array_equal(fresh.load_shard(2), want[2])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("max_bins", [16, 64])
def test_store_crosses_packages(tmp_path, writer, max_bins):
    """A store written by either package opens in the other: the same
    manifest geometry, equal thresholds, array-equal packed words, and
    the same manifest digest."""
    X = _data(n=200, d=7, seed=3)
    path = str(tmp_path / "store")
    if writer == "jax":
        jax_write_shards(X, path, max_bins=max_bins, shard_rows=48)
    else:
        write_shards(X, path, max_bins=max_bins, shard_rows=48, device="cpu")
    js, ts = JaxShardStore.open(path), ShardStore.open(path)
    for attr in ("n", "d", "max_bins", "bits", "words_per_row", "shard_rows",
                 "num_shards", "packed_nbytes"):
        assert getattr(js, attr) == getattr(ts, attr), attr
    np.testing.assert_array_equal(ts.thresholds, js.thresholds)
    for s in range(ts.num_shards):
        np.testing.assert_array_equal(ts.load_shard(s), js.load_shard(s))
    assert manifest_digest(ts) == jpart.manifest_digest(js)
    # and both equal the JAX package's own binning of X
    bins = jax_compute_bins(jnp.asarray(X), max_bins)
    np.testing.assert_array_equal(ts.thresholds, np.asarray(bins.thresholds))
    words = np.asarray(jax_pack_bins(jax_bin_features(jnp.asarray(X), bins),
                                     max_bins).packed)
    np.testing.assert_array_equal(ts.load_shard(4)[:8], words[192:])


# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------


def test_prefetcher_sweep_and_stats(tmp_path):
    store = _store(tmp_path, _data())
    with ShardPrefetcher(store, depth=2, to_device=False) as pf:
        seen = [(s, arr.copy()) for s, arr in pf.sweep()]
        assert [s for s, _ in seen] == [0, 1, 2]
        for s, arr in seen:
            np.testing.assert_array_equal(arr, store.load_shard(s))
        st_ = pf.take_stats()
        assert st_["loads"] == 3 and st_["hits"] + st_["misses"] == 3
        assert st_["bytes"] == sum(a.nbytes for _, a in seen)
        assert st_["errors"] == 0 and st_["last_error"] is None
        assert st_["load_s"] >= 0.0 and st_["wait_s"] >= 0.0
        assert pf.take_stats()["loads"] == 0  # reset on take
        assert [s for s, _ in pf.sweep()] == [0, 1, 2]  # cyclic schedule


def test_prefetcher_yields_tensors_on_the_device(tmp_path):
    """``to_device``: the words as the port's int32 bit patterns on the
    device (the CPU here), equal to the stored uint32 words."""
    store = _store(tmp_path, _data(), max_bins=64)
    with ShardPrefetcher(store, device="cpu") as pf:
        for s, words in pf.sweep():
            assert isinstance(words, torch.Tensor) and words.dtype == torch.int32
            np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                          store.load_shard(s))


def test_prefetcher_depth_resolves(tmp_path):
    store = _store(tmp_path, _data())
    with ShardPrefetcher(store, to_device=False) as pf:
        assert pf.depth == 2
    with override(prefetch_depth=3), \
            ShardPrefetcher(store, to_device=False) as pf:
        assert pf.depth == 3


def test_prefetcher_abandoned_sweep_recovers(tmp_path):
    store = _store(tmp_path, _data())
    with ShardPrefetcher(store, depth=2, to_device=False) as pf:
        gen = pf.sweep()
        next(gen)
        gen.close()  # a mid-round death (a chaos preemption unwinding)
        assert [s for s, _ in pf.sweep()] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="closed"):
        next(pf.sweep())


def test_prefetcher_attributes_worker_errors(tmp_path):
    """A worker-thread read failure surfaces as a ShardLoadError naming the
    shard that broke, and lands in take_stats()."""
    store = _store(tmp_path, _data())

    class _FlakyStore:
        num_shards = store.num_shards
        n = store.n

        @staticmethod
        def load_shard(s):
            if s == 1:
                raise IOError("disk went away")
            return store.load_shard(s)

    with ShardPrefetcher(_FlakyStore(), depth=2, to_device=False) as pf:
        gen = pf.sweep()
        assert next(gen)[0] == 0
        with pytest.raises(ShardLoadError, match="shard 1") as ei:
            for _ in gen:
                pass
        assert ei.value.shard == 1
        assert isinstance(ei.value.__cause__, IOError)
        st_ = pf.take_stats()
        assert st_["errors"] == 1 and "shard 1" in st_["last_error"]
        assert st_["loads"] == 1


# ---------------------------------------------------------------------------
# manifest partitioning (the numpy-only copy equals the JAX package's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards,num_parts", [(1, 1), (3, 2), (5, 3), (2, 4), (8, 4)])
def test_partition_matches_the_reference(tmp_path, num_shards, num_parts):
    for part in range(num_parts):
        assert partition_shards(num_shards, num_parts, part) == \
            jpart.partition_shards(num_shards, num_parts, part)
    assert tpart.partition_steps(num_shards, num_parts) == \
        jpart.partition_steps(num_shards, num_parts)
    X = _data(n=num_shards * 16 - 3)
    store = _store(tmp_path, X, shard_rows=16)
    jstore = JaxShardStore.open(store.directory)
    assert store.num_shards == num_shards
    digest = manifest_digest(store)
    assert digest == jpart.manifest_digest(jstore)
    np.testing.assert_array_equal(tpart.digest_words(digest), jpart.digest_words(digest))
    positions = list(range(0, num_parts, 2))
    tr = PartitionedShardReader(store, positions, num_parts)
    jr = jpart.PartitionedShardReader(jstore, positions, num_parts)
    assert (tr.num_shards, tr.steps) == (jr.num_shards, jr.steps)
    for j in range(tr.num_shards):
        assert tr.global_index(j) == jr.global_index(j)
        np.testing.assert_array_equal(tr.load_shard(j), jr.load_shard(j))
    assert [p.shards for p in tr.local_partitions()] == \
        [p.shards for p in jr.local_partitions()]
    assert ShardPartition.from_store(store, num_parts, 0).digest == digest


def test_partition_rejects_bad_arguments(tmp_path):
    with pytest.raises(ValueError):
        partition_shards(4, 0, 0)
    with pytest.raises(ValueError):
        partition_shards(4, 2, 2)
    store = _store(tmp_path, _data())
    with pytest.raises(ValueError, match="duplicate"):
        PartitionedShardReader(store, [0, 0], 2)
    with pytest.raises(ValueError, match="out of range"):
        PartitionedShardReader(store, [2], 2)


# ---------------------------------------------------------------------------
# autotune resolution
# ---------------------------------------------------------------------------


def test_resolve_order_and_modes(monkeypatch, tmp_path):
    monkeypatch.setenv("SE_TPU_AUTOTUNE_CACHE", str(tmp_path / "atc"))
    assert TUNABLES.names() == tuple(t.name for t in JAX_TUNABLES)
    monkeypatch.delenv(MODE_ENV, raising=False)
    assert autotune_mode() == "cache"
    assert resolve("stream_chunk_rows", 123, n=10) == 123
    with override(stream_chunk_rows=64):
        with override(stream_chunk_rows=32, mode="off"):
            assert resolve("stream_chunk_rows", 123) == 32
            assert autotune_mode() == "off"
        assert resolve("stream_chunk_rows", 123) == 64
    assert resolve("stream_chunk_rows", 123) == 123
    with pytest.raises(ValueError, match="unknown tunables"):
        with override(no_such_knob=1):
            pass
    with pytest.raises(ValueError, match="mode"):
        with override(mode="fast"):
            pass
    monkeypatch.setenv(MODE_ENV, "bogus")
    assert autotune_mode() == "off"
    # mode "search" with nothing cached runs the smoke search once (stubbed
    # here: tests/test_torch_autotune.py runs it), and search() runs it too
    from spark_ensemble_tpu_torch.autotune import search as search_mod

    calls = []
    monkeypatch.setattr(search_mod, "run_search",
                        lambda budget="smoke", **kw: calls.append(budget) or {})
    monkeypatch.setenv(MODE_ENV, "search")
    assert resolve("prefetch_depth", 2) == 2
    assert calls == ["smoke"]
    assert search() == {} and calls == ["smoke", "smoke"]


def test_stream_chunk_rows_resolve_at_the_stream_tier(monkeypatch):
    """The stream tier's chunk resolves through the autotune layer: an
    override equals the monkeypatched module constant, chunk for chunk."""
    rng = np.random.RandomState(4)
    X = torch.as_tensor(rng.randn(150, 4).astype(np.float32))
    bins = compute_bins(X, 16)
    Xb = bin_features(X, bins)
    Y = torch.as_tensor(rng.randn(150, 2, 1).astype(np.float32))
    w = torch.ones((150, 2))
    kw = dict(max_depth=3, max_bins=16, hist="stream")
    with override(stream_chunk_rows=40):
        over = tt.fit_forest(Xb, Y, w, bins.thresholds, **kw)
    monkeypatch.setattr(tt, "_STREAM_CHUNK_ROWS", 40)
    patched = tt.fit_forest(Xb, Y, w, bins.thresholds, **kw)
    for a, b in zip(over, patched):
        assert torch.equal(a, b)


def test_store_manifest_keys_are_the_reference_keys(tmp_path):
    X = _data()
    ours = _store(tmp_path, X, name="port")
    jax_write_shards(X, str(tmp_path / "jax"), max_bins=16, shard_rows=64)
    with open(os.path.join(ours.directory, "manifest.json")) as f:
        mine = json.load(f)
    with open(str(tmp_path / "jax" / "manifest.json")) as f:
        ref = json.load(f)
    assert sorted(mine) == sorted(ref)
    assert sorted(mine["shards"][0]) == sorted(ref["shards"][0])
    for key in ("format", "n", "d", "max_bins", "bits", "words_per_row", "shard_rows"):
        assert mine[key] == ref[key], key
    assert st.SHARD_FORMAT == 1
