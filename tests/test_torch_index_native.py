"""The port's native index backend against the JAX package's:
``NativePartKeyIndex`` (``filodb_tpu_torch/memstore/index_native.py`` over
the port's own ``native/index.cpp``, built by g++ into ``_build/``) holds
the JAX ``NativePartKeyIndex``'s id sets exactly for every matcher class,
with time windows and limits, through adds, end times and removals; the
route of more than 64 equality terms, which the C++ core refuses, goes to
the bitmap AND with the same ids; and a core that does not build raises
(in the port, unlike the JAX package, the backend never turns into the
bitmap index by itself)."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from filodb_tpu.memstore.index import PartKeyIndex as JaxIndex
from filodb_tpu.memstore.index_native import NativePartKeyIndex as JaxNative
from filodb_tpu.memstore.index_native import native_index_available
from filodb_tpu_torch import native
from filodb_tpu_torch.core.filters import ColumnFilter, equals, regex
from filodb_tpu_torch.memstore import index_native as N
from filodb_tpu_torch.memstore.index import PartKeyIndex
from filodb_tpu_torch.memstore.index_native import NativePartKeyIndex
from filodb_tpu_torch.memstore.shard import StoreConfig, TimeSeriesShard
from test_torch_index import (
    BIG, MATCHER_CLASSES, both, brute_force, build, lookups, make_universe, matcher,
)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native class where its library loads, else its
    bitmap index (the same ids: the JAX shared-behavior suites hold them
    equal)."""
    return JaxNative if native_index_available() else JaxIndex


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", MATCHER_CLASSES)
def test_matcher_class_ids_equal_jax(kind, seed, jax_native):
    parts = make_universe(seed, sparse_ids=seed == 1)
    port, jax = build(NativePartKeyIndex, parts), build(jax_native, parts)
    rng = np.random.default_rng(200 + seed)
    for _ in range(12):
        f = both(*matcher(kind, rng))
        lookups(port, jax, [f], 0, BIG)
        start = int(rng.integers(0, 15_000))
        end = start + int(rng.integers(0, 15_000))
        lookups(port, jax, [f], start, end)
        extra = both(*matcher(["eq", "alt", "prefix", "regex"][rng.integers(4)], rng))
        lookups(port, jax, [f, extra], start, end, limit=int(rng.integers(1, 40)))
        lookups(port, jax, [both("dc", "=", "eu"), f, extra], 0, BIG)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_against_brute_force(seed):
    rng = np.random.default_rng(3000 + seed)
    parts = make_universe(seed + 70, n=500)
    idx = build(NativePartKeyIndex, parts)
    for _ in range(40):
        filters = [ColumnFilter(*matcher(MATCHER_CLASSES[rng.integers(len(MATCHER_CLASSES))],
                                         rng)) for _ in range(int(rng.integers(1, 4)))]
        start = int(rng.integers(0, 15_000))
        end = start + int(rng.integers(0, 15_000))
        got = sorted(idx.part_ids_from_filters(filters, start, end).tolist())
        assert got == brute_force(parts, filters, start, end), (filters, start, end)


def test_writes_reach_both_stores(jax_native):
    """Adds, end times and removals: the C++ core and the bitmap postings
    answer the same, equal to the JAX backend's."""
    rng = np.random.default_rng(11)
    port, jax = NativePartKeyIndex(), jax_native()
    pool = [both(*matcher(k, rng)) for k in ("eq", "alt", "prefix", "regex") for _ in range(4)]
    live = []
    for pid in range(2500):
        tags = {"_metric_": f"metric_{rng.integers(6)}", "host": f"h{rng.integers(80)}",
                "dc": ["us-east", "eu"][rng.integers(2)]}
        port.add_partkey(pid, tags, int(rng.integers(0, 5_000)))
        jax.add_partkey(pid, tags, port.start_time(pid))
        live.append(pid)
        if pid % 500 == 499:
            for p in rng.choice(live, 30, replace=False).tolist():
                port.update_end_time(p, 6_000)
                jax.update_end_time(p, 6_000)
            drop = rng.choice(live, 50, replace=False).tolist()
            port.remove(drop)
            jax.remove(drop)
            live = sorted(set(live) - set(drop))
            for f in pool:
                lookups(port, jax, [f], 0, BIG)
                lookups(port, jax, [f], 7_000, 9_000)
    assert port._L.fdb_idx_size(port._h) == len(port) == len(live)


def test_more_than_64_terms_take_the_bitmap_and():
    """The core refuses a selector of more than 64 equality terms
    (fdb_idx_query returns -2): those go to the bitmap AND, the same ids."""
    idx, ref = NativePartKeyIndex(), PartKeyIndex()
    for pid in range(300):
        tags = {f"k{j}": f"v{(pid >> (j % 6)) & 1}" for j in range(70)}
        idx.add_partkey(pid, tags, 0)
        ref.add_partkey(pid, tags, 0)
    filters = [equals(f"k{j}", "v1") for j in range(N.MAX_NATIVE_TERMS + 1)]
    lookups_before = idx.lookups
    got = idx.part_ids_from_filters(filters, 0, BIG)
    assert idx.lookups == lookups_before + 1  # it went through the bitmap path
    assert got.tolist() == ref.part_ids_from_filters(filters, 0, BIG).tolist()
    assert len(got) and (got & 63 == 63).all()
    # at 64 terms the core answers itself
    at_cap = filters[: N.MAX_NATIVE_TERMS]
    assert idx.part_ids_from_filters(at_cap, 0, BIG).tolist() == \
        ref.part_ids_from_filters(at_cap, 0, BIG).tolist()
    assert idx.lookups == lookups_before + 1


def test_regex_over_a_large_dictionary_grows_the_value_buffer():
    """More prefixed values than the first 64 KiB buffer holds: the core
    reports the bytes it needs and the wrapper asks again."""
    idx = NativePartKeyIndex()
    for pid in range(6000):
        idx.add_partkey(pid, {"host": f"host-{pid:05d}-" + "x" * 8}, 0)
    got = idx.part_ids_from_filters([regex("host", "host-0[0-4].*x{8}")], 0, BIG)
    assert got.tolist() == list(range(5000))


def test_library_built_by_hash_into_the_build_dir():
    path = native.build_library(native.INDEX_SRC, "libfilodbindex")
    assert path == native.library_path(native.INDEX_SRC, "libfilodbindex") and path.exists()
    assert path.parent.name == "_build" and path.name.startswith("libfilodbindex-")
    assert N.lib() is N.lib()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """g++ fails on a copy of index.cpp with a line it cannot compile: the
    backend raises, through the shard too, and leaves no library."""
    bad = tmp_path / "index.cpp"
    shutil.copy(native.INDEX_SRC, bad)
    with open(bad, "a") as f:
        f.write("\nthis line is not C++\n")
    monkeypatch.setattr(native, "INDEX_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on index.cpp"):
        NativePartKeyIndex()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TimeSeriesShard("d", 0, StoreConfig(index_backend="native"))
    assert not list((tmp_path / "_build").glob("*.so"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NativePartKeyIndex()


def test_shard_native_backend_answers_as_jax(jax_native):
    sh = TimeSeriesShard("d", 0, StoreConfig(index_backend="native"))
    assert type(sh.index) is NativePartKeyIndex
    jax = jax_native()
    for pid, tags, s, e in make_universe(8, n=200):
        sh.index.add_partkey(pid, tags, s, e)
        jax.add_partkey(pid, tags, s, e)
    for f in ([both("host", "=~", "h1.*")], [both("dc", "=", "eu"), both("host", "=~", "h[0-3]")]):
        assert sh.lookup_partitions([p for p, _ in f], 0, BIG).tolist() == \
            jax.part_ids_from_filters([j for _, j in f], 0, BIG).tolist()
    assert sh.index_stats()["num_part_keys"] == 200
    assert sh.label_values([], "dc", 0, BIG) == jax.label_values([], "dc", 0, BIG)

