"""The port's part-key index against the JAX package's: ``PartKeyIndex`` and
``SetBasedPartKeyIndex`` of ``filodb_tpu_torch/memstore/index.py`` hold the
JAX ``PartKeyIndex``'s id sets exactly on seeded tag universes, for every
matcher class (eq, in, literal alternation, prefix, general regex, !=, !~,
{k=""}, {k=~".*"}) alone and ANDed with an equality, with time windows and
limits; the lifecycle through the shard (start and end times, removal),
the label APIs, ``value_counts``, ``postings_stats``, the regex cache's
invalidation, a fuzz against brute force, the postings algebra of
``postings.py``, and one slice-level case: the port's engine on the CPU
over a small ``query_hicard`` store answers as the JAX engine does on
every backend (rtol 2e-4, atol 1e-4, NaN masks equal: f32 sums are taken
in another order)."""

from __future__ import annotations

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.filters import ColumnFilter as JaxFilter
from filodb_tpu.memstore import postings as JP
from filodb_tpu.memstore.index import PartKeyIndex as JaxIndex
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.memstore.shard import StoreConfig as JaxStoreConfig
from filodb_tpu.testkit import counter_batch
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.filters import ColumnFilter, equals, regex
from filodb_tpu_torch.core.records import RecordBatch
from filodb_tpu_torch.memstore import postings as P
from filodb_tpu_torch.memstore.cardinality import label_top_values
from filodb_tpu_torch.memstore.index import (
    PartKeyIndex, SetBasedPartKeyIndex, filter_op_class, regex_literal_prefix,
)
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.memstore.shard import StoreConfig, TimeSeriesShard

BIG = 2**62
BACKENDS = {"python": PartKeyIndex, "set": SetBasedPartKeyIndex}
COLUMNS = ("_metric_", "host", "dc", "extra", "rare", "absent")


def make_universe(seed: int, n: int = 600, sparse_ids: bool = False):
    """Seeded tag universe: a high-cardinality label, medium labels, an
    optional label (the missing-tag rule), a rare one, an explicitly empty
    value now and then, and random [start, end] intervals."""
    rng = np.random.default_rng(seed)
    parts, used = [], set()
    for i in range(n):
        pid = i
        if sparse_ids:
            pid = int(rng.integers(0, n * 37))
            while pid in used:
                pid = int(rng.integers(0, n * 37))
        used.add(pid)
        tags = {"_metric_": f"metric_{rng.integers(6)}", "host": f"h{rng.integers(80)}",
                "dc": ["us-east", "us-west", "eu", "ap"][rng.integers(4)]}
        if rng.random() < 0.4:
            tags["extra"] = f"e{rng.integers(4)}"
        if rng.random() < 0.1:
            tags["rare"] = ["r0", "r1", ""][rng.integers(3)]
        start = int(rng.integers(0, 10_000))
        parts.append((pid, tags, start, int(start + rng.integers(50, 15_000))))
    return parts


def build(cls, parts):
    idx = cls()
    for pid, tags, s, e in parts:
        idx.add_partkey(pid, tags, s, e)
    return idx


def matcher(kind: str, rng) -> tuple[str, str, object]:
    """One (column, op, value) of a matcher class."""
    col = COLUMNS[rng.integers(len(COLUMNS))]
    host = lambda: f"h{rng.integers(80)}"  # noqa: E731
    if kind == "eq":
        return col, "=", [f"metric_{rng.integers(7)}", host(), "eu", f"e{rng.integers(5)}",
                          "r1"][rng.integers(5)]
    if kind == "in":
        return col, "in", (host(), host(), "us-east", f"metric_{rng.integers(6)}")
    if kind == "alt":
        return col, "=~", "|".join(host() for _ in range(int(rng.integers(1, 4))))
    if kind == "prefix":
        return col, "=~", ["h1.*", "us.*", "metric_.*", "e.*", "h", "r"][rng.integers(6)]
    if kind == "regex":
        return col, "=~", ["h[0-7].*", "h1[0-9]", "metric_[0-3]", "us-(east|west)", ".*st",
                           ".+", "e[12]?", "h7[0-9]?"][rng.integers(8)]
    if kind == "ne":
        return col, "!=", ["h3", "us-east", "e1", "", "r0"][rng.integers(5)]
    if kind == "nregex":
        return col, "!~", ["h1.*", "us.*", ".+", "", "h[0-4].*", "e1|e2"][rng.integers(6)]
    if kind == "empty":
        return col, "=", ""
    if kind == "all":
        return col, "=~", ".*"
    raise ValueError(kind)


MATCHER_CLASSES = ("eq", "in", "alt", "prefix", "regex", "ne", "nregex", "empty", "all")


def both(col, op, value):
    return ColumnFilter(col, op, value), JaxFilter(col, op, value)


def lookups(port, jax, filters, start, end, limit=None):
    got = port.part_ids_from_filters([f for f, _ in filters], start, end, limit)
    want = jax.part_ids_from_filters([g for _, g in filters], start, end, limit)
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist(), (filters, start, end, limit)
    return got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", MATCHER_CLASSES)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_matcher_class_ids_equal_jax(backend, kind, seed):
    parts = make_universe(seed, sparse_ids=seed == 2)
    port, jax = build(BACKENDS[backend], parts), build(JaxIndex, parts)
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        f = both(*matcher(kind, rng))
        lookups(port, jax, [f], 0, BIG)
        start = int(rng.integers(0, 15_000))
        end = start + int(rng.integers(0, 15_000))
        lookups(port, jax, [f], start, end)
        # ANDed with an equality and another class, with a limit
        extra = both(*matcher(["eq", "in", "prefix", "ne"][rng.integers(4)], rng))
        lookups(port, jax, [f, extra], start, end, limit=int(rng.integers(1, 40)))
        lookups(port, jax, [extra, f, both("dc", "=", "eu")], 0, BIG)


@pytest.mark.parametrize("window", [(0, BIG, None), (5_000, 6_000, None), (0, 100, None),
                                    (20_000, 30_000, None), (0, BIG, 7), (4_000, 9_000, 1)])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_time_overlap_and_limit(backend, window):
    start, end, limit = window
    parts = make_universe(3)
    port, jax = build(BACKENDS[backend], parts), build(JaxIndex, parts)
    for filters in ([], [both("dc", "=", "eu")], [both("host", "=~", "h1.*")],
                    [both("extra", "!=", "e1")]):
        lookups(port, jax, filters, start, end, limit)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_add_update_remove_script_equal_jax(backend):
    """Incremental adds, end times and removals, the ids equal after every
    step (the universe grows past its capacity on the way)."""
    rng = np.random.default_rng(9)
    port, jax = BACKENDS[backend](), JaxIndex()
    pool = [both(*matcher(k, rng)) for k in MATCHER_CLASSES for _ in range(2)]
    live: list[int] = []
    pid = 0
    for step in range(8):
        for _ in range(300):
            tags = {"_metric_": f"metric_{rng.integers(6)}", "host": f"h{rng.integers(80)}",
                    "dc": ["us-east", "eu"][rng.integers(2)]}
            if rng.random() < 0.3:
                tags["extra"] = f"e{rng.integers(4)}"
            s = int(rng.integers(0, 5_000))
            port.add_partkey(pid, tags, s)
            jax.add_partkey(pid, tags, s)
            live.append(pid)
            pid += 1 + int(rng.integers(0, 3))
        for p in rng.choice(live, 40, replace=False).tolist():
            e = int(rng.integers(5_000, 9_000))
            port.update_end_time(p, e)
            jax.update_end_time(p, e)
        drop = rng.choice(live, 60, replace=False).tolist()
        port.remove(drop)
        jax.remove(drop)
        live = [p for p in live if p not in set(drop)]
        for f in pool:
            lookups(port, jax, [f], 0, BIG)
            lookups(port, jax, [f], 6_000, 20_000)
        assert len(port) == len(jax) == len(live), step
        assert port.label_names([], 0, BIG) == jax.label_names([], 0, BIG)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_remove_then_readd_same_id(backend):
    port, jax = BACKENDS[backend](), JaxIndex()
    for idx in (port, jax):
        idx.add_partkey(5, {"a": "x", "b": "y"}, 0)
        idx.remove([5])
        idx.remove([5])  # twice: nothing left to drop
        idx.add_partkey(5, {"a": "z"}, 10, 20)
    for f in ([both("a", "=", "x")], [both("a", "=", "z")], [both("b", "=", "")],
              [both("b", "=~", ".+")]):
        lookups(port, jax, f, 0, BIG)
    assert port.label_names([], 0, BIG) == jax.label_names([], 0, BIG) == ["a"]
    assert port.start_time(5) == jax.start_time(5) == 10
    assert port.end_time(5) == jax.end_time(5) == 20
    assert port.tags_of(5) == {"a": "z"}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_label_apis_equal_jax(backend, seed):
    parts = make_universe(seed)
    port, jax = build(BACKENDS[backend], parts), build(JaxIndex, parts)
    rng = np.random.default_rng(seed)
    for filters in ([], [both("dc", "=", "eu")], [both("host", "=~", "h1.*")],
                    [both("extra", "=", "")], [both("absent", "=", "x")]):
        p, j = [f for f, _ in filters], [g for _, g in filters]
        assert port.label_names(p, 0, BIG) == jax.label_names(j, 0, BIG)
        assert port.label_names(p, 2_000, 4_000) == jax.label_names(j, 2_000, 4_000)
        for label in COLUMNS:
            assert port.label_values(p, label, 0, BIG) == jax.label_values(j, label, 0, BIG)
            assert (port.label_values(p, label, 1_000, 3_000, limit=5)
                    == jax.label_values(j, label, 1_000, 3_000, limit=5))
        limit = int(rng.integers(1, 50))
        assert (port.partkeys_from_filters(p, 0, BIG, limit)
                == jax.partkeys_from_filters(j, 0, BIG, limit))
    for label in COLUMNS:
        assert port.value_counts(label) == jax.value_counts(label)
        assert port.cardinality(label) == jax.cardinality(label)
    assert label_top_values(port, "host", 5) == [
        {"value": v, "series": n}
        for v, n in sorted(jax.value_counts("host").items(), key=lambda kv: (-kv[1], kv[0]))[:5]]


def test_postings_stats_equal_jax():
    parts = make_universe(4, n=3000)
    port, jax = build(PartKeyIndex, parts), build(JaxIndex, parts)
    port.part_ids_from_filters([equals("dc", "eu")], 0, BIG)
    jax.part_ids_from_filters([JaxFilter("dc", "=", "eu")], 0, BIG)
    got, want = port.postings_stats(0), jax.postings_stats(0)
    assert got == want
    # each dc value covers > 1/32 of the ids, but a container is promoted
    # when it is read: only "eu"'s was
    assert got["labels"]["dc"]["dense_containers"] == 1
    assert got["device"] is None
    # the snapshot is served for max_age_s; lookups stay fresh
    port.part_ids_from_filters([equals("dc", "ap")], 0, BIG)
    port.add_partkey(10_000, {"new": "v"}, 0)
    cached = port.postings_stats(60)
    assert cached["lookups"] == got["lookups"] + 1 and "new" not in cached["labels"]
    assert "new" in port.postings_stats(0)["labels"]


def test_lookup_histogram_counts_op_classes():
    from filodb_tpu_torch.metrics import REGISTRY, MicroHistogram

    idx = build(PartKeyIndex, make_universe(5))
    h = REGISTRY.micro_histogram("filodb_index_lookup_seconds", op_class="regex")
    assert isinstance(h, MicroHistogram)
    before = h.total
    idx.part_ids_from_filters([equals("dc", "eu"), regex("host", "h[0-3]")], 0, BIG)
    assert h.total == before + 1
    text = REGISTRY.expose()
    assert 'filodb_index_lookup_seconds_bucket{op_class="regex",le="5e-06"}' in text


@pytest.mark.parametrize("pattern,prefix,rest,klass", [
    ("http_5.*", "http_5", ".*", "prefix"), ("ab*", "a", "*", "regex"),
    ("abc", "abc", "", "in"), ("a|b", "", "a|b", "in"), ("ab?c", "a", "?c", "regex"),
    ("h1[0-9]", "h1", "[0-9]", "regex"), ("x{2}", "", "{2}", "regex"),
    ("a.b|c", "", "a.b|c", "regex"), (r"a\.b", "a", r"\.b", "regex"),
])
def test_literal_prefix_and_op_class(pattern, prefix, rest, klass):
    from filodb_tpu.memstore.index import filter_op_class as jax_class
    from filodb_tpu.memstore.index import regex_literal_prefix as jax_prefix

    assert regex_literal_prefix(pattern) == jax_prefix(pattern) == (prefix, rest)
    assert filter_op_class(regex("k", pattern)) == jax_class(JaxFilter("k", "=~", pattern)) \
        == klass


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_regex_cache_invalidation(backend):
    """A cached regex answer follows new values (the dictionary version) and
    new ids of old values (the postings version), and removals."""
    port, jax = BACKENDS[backend](), JaxIndex()
    f = [both("host", "=~", "h1[0-9]")]
    for pid in range(50):
        for idx in (port, jax):
            idx.add_partkey(pid, {"host": f"h{pid % 25}"}, 0)
    for _ in range(2):
        lookups(port, jax, f, 0, BIG)
    for idx in (port, jax):
        idx.add_partkey(100, {"host": "h19"}, 0)  # old value, new id
    lookups(port, jax, f, 0, BIG)
    for idx in (port, jax):
        idx.add_partkey(101, {"host": "h1x"}, 0)  # new value, no match
        idx.add_partkey(102, {"host": "h17"}, 0)
    lookups(port, jax, f, 0, BIG)
    for idx in (port, jax):
        idx.remove(list(range(10, 20)))
    got = lookups(port, jax, f, 0, BIG)
    assert got.tolist() == list(range(35, 45)) + [100, 102]
    if backend == "python":
        assert ("host", "h1[0-9]") in port._regex_cache


def test_regex_cache_is_bounded():
    idx = PartKeyIndex()
    for pid in range(300):
        idx.add_partkey(pid, {"host": f"h{pid}"}, 0)
    for i in range(PartKeyIndex.REGEX_CACHE_MAX + 40):
        idx.part_ids_from_filters([regex("host", f"h{i}[0-9]?")], 0, BIG)
    assert len(idx._regex_cache) == PartKeyIndex.REGEX_CACHE_MAX


def brute_force(parts, filters, start, end):
    return sorted(pid for pid, tags, s, e in parts
                  if s <= end and e >= start and all(f.matches(tags.get(f.column))
                                                     for f in filters))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_fuzz_against_brute_force(backend, seed):
    rng = np.random.default_rng(1000 + seed)
    parts = make_universe(seed + 50, n=500)
    idx = build(BACKENDS[backend], parts)
    for _ in range(40):
        filters = [ColumnFilter(*matcher(MATCHER_CLASSES[rng.integers(len(MATCHER_CLASSES))],
                                         rng)) for _ in range(int(rng.integers(1, 4)))]
        start = int(rng.integers(0, 15_000))
        end = start + int(rng.integers(0, 15_000))
        assert idx.part_ids_from_filters(filters, start, end).tolist() == brute_force(
            parts, filters, start, end), (filters, start, end)


def test_ids_come_back_sorted_as_the_set_index_returns_them():
    parts = make_universe(7, sparse_ids=True)
    idx, ref = build(PartKeyIndex, parts), build(SetBasedPartKeyIndex, parts)
    for f in ([equals("dc", "eu")], [regex("host", "h[0-3].*")], [],
              [ColumnFilter("extra", "!=", "e1")]):
        got = idx.part_ids_from_filters(f, 0, BIG)
        assert (np.diff(got) > 0).all()
        assert got.tolist() == ref.part_ids_from_filters(f, 0, BIG).tolist()


def test_negative_part_id_refused():
    with pytest.raises(ValueError, match="non-negative"):
        PartKeyIndex().add_partkey(-1, {"a": "b"}, 0)


# -- postings.py against the JAX module -------------------------------------------

@pytest.mark.parametrize("nbits", [64, 1000, 4096, 70_000])
def test_dense_round_trip_and_bit_order(nbits):
    rng = np.random.default_rng(nbits)
    ids = np.unique(rng.integers(0, nbits, nbits // 7 + 1))
    nw = P.nwords(nbits)
    assert nw == JP.nwords(nbits)
    words = P.ids_to_dense(ids, nw)
    np.testing.assert_array_equal(words, JP.ids_to_dense(ids, nw))
    np.testing.assert_array_equal(P.dense_to_ids(words), ids)
    assert P.popcount(words) == len(ids)
    # part id i at word i >> 6, bit i & 63
    for i in ids[:20].tolist():
        assert (int(words[i >> 6]) >> (i & 63)) & 1
    probe = rng.integers(0, nw * 64, 200)
    np.testing.assert_array_equal(P.test_bits(words, probe), JP.test_bits(words, probe))


@pytest.mark.parametrize("seed", range(6))
def test_view_algebra_equal_jax(seed):
    rng = np.random.default_rng(seed)
    nbits = int(rng.choice([256, 2048, 10_000]))
    nw = P.nwords(nbits)

    def view(module, k: int):
        """The k-th seeded view, sparse or dense (a dense one at times a
        word narrower than the universe, as a bitmap promoted earlier)."""
        r = np.random.default_rng(seed * 100 + k)
        width = nw - int(r.integers(0, 2))
        ids = np.unique(r.integers(0, min(nbits, width * 64), int(r.integers(0, nbits // 2))))
        if r.random() < 0.5:
            return ("s", ids.astype(np.int32))
        return ("d", module.ids_to_dense(ids, width))

    for k in range(0, 16, 2):
        a, b = view(P, k), view(P, k + 1)
        ja, jb = view(JP, k), view(JP, k + 1)
        for op in ("p_and", "p_andnot"):
            got, want = getattr(P, op)(a, b, nw), getattr(JP, op)(ja, jb, nw)
            np.testing.assert_array_equal(P.p_to_ids(got), JP.p_to_ids(want))
            assert P.p_count(got) == JP.p_count(want)
            assert P.p_is_empty(got) == JP.p_is_empty(want)
        got, want = P.p_or_views([a, b], nw), JP.p_or_views([ja, jb], nw)
        np.testing.assert_array_equal(P.p_to_ids(got), JP.p_to_ids(want))


@pytest.mark.parametrize("nbits", [1024, 32_768])
def test_value_container_promotes_and_discards_as_jax(nbits):
    rng = np.random.default_rng(nbits)
    c, j = P.ValueContainer(), JP.ValueContainer()
    ids = np.sort(rng.choice(nbits, nbits // 16, replace=False))
    for i, pid in enumerate(ids.tolist()):
        c.add(pid, nbits)
        j.add(pid, nbits)
        if i % 97 == 0:
            assert c.view(nbits)[0] == j.view(nbits)[0]
    assert c.view(nbits)[0] == j.view(nbits)[0] == "d"  # > 1/32 of the universe
    drop = ids[::3].tolist() + [nbits - 1]
    assert c.discard_many(drop, nbits) == j.discard_many(drop, nbits)
    np.testing.assert_array_equal(P.p_to_ids(c.view(nbits)), JP.p_to_ids(j.view(nbits)))
    assert len(c) == len(j) and c.nbytes() == j.nbytes()


# -- the shard and the slice ------------------------------------------------------

def test_shard_builds_the_bitmap_index_by_default():
    assert type(TimeSeriesShard("d", 0).index) is PartKeyIndex
    assert type(TimeSeriesShard("d", 0, StoreConfig(index_backend="set")).index) \
        is SetBasedPartKeyIndex
    with pytest.raises(ValueError, match="unknown index_backend"):
        TimeSeriesShard("d", 0, StoreConfig(index_backend="lucene"))
    st = TimeSeriesShard("d", 0, StoreConfig(index_backend="set")).index_stats()
    assert st == {"num_part_keys": 0, "labels": {}, "postings_bytes": 0, "dictionary_size": 0,
                  "device": None}


HICARD_NS, HICARD_SERIES, HICARD_SAMPLES = 4, 300, 120
HICARD_BASE = 1_600_000_000_000
HICARD_QUERY = 'sum(rate(http_requests_total{_ns_="App-1"}[5m]))'


def hicard_batches():
    """bench.py's query_hicard store, cut to 300 series a tenant: the JAX
    testkit's counter batches and the same records for the port."""
    out = []
    for ns in range(HICARD_NS):
        jb = counter_batch(n_series=HICARD_SERIES, n_samples=HICARD_SAMPLES,
                           start_ms=HICARD_BASE, ns=f"App-{ns}")
        pb = RecordBatch(S.PROM_COUNTER, jb.timestamps, {"count": jb.values["count"]},
                         jb.tags)
        out.append((jb, pb))
    return out


@pytest.fixture(scope="module")
def hicard_jax_answer():
    jms = JaxMemStore(JaxStoreConfig(index_backend="set"))
    jms.setup(JS.Dataset("prometheus"), range(8))
    for jb, _ in hicard_batches():
        jms.ingest_routed("prometheus", jb, spread=3)
    res = JaxEngine(jms, "prometheus").query_range(
        HICARD_QUERY, (HICARD_BASE + 400_000) / 1000, (HICARD_BASE + 1_100_000) / 1000, 60)
    return np.asarray(res.grids[0].values_np(), np.float64)


@pytest.mark.parametrize("backend", ["python", "native", "set"])
def test_hicard_query_equals_jax_on_every_backend(backend, hicard_jax_answer):
    ms = TimeSeriesMemStore(StoreConfig(index_backend=backend))
    ms.setup(S.Dataset("prometheus"), range(8))
    for _, pb in hicard_batches():
        ms.ingest_routed("prometheus", pb, spread=3)
    engine = QueryEngine(ms, "prometheus", device="cpu")
    got = np.asarray(engine.query_range(
        HICARD_QUERY, (HICARD_BASE + 400_000) / 1000, (HICARD_BASE + 1_100_000) / 1000,
        60).grids[0].values_np(), np.float64)
    want = hicard_jax_answer
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)], rtol=2e-4,
                               atol=1e-4)
    sel = [equals("_ns_", "App-1"), equals(S.METRIC_TAG, "http_requests_total")]
    assert sum(len(sh.lookup_partitions(sel, 0, BIG)) for sh in ms.shards("prometheus")) \
        == HICARD_SERIES
