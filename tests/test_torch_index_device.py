"""The index's device tier on the CPU against the JAX package's: the
postings intersection (``ops/postings_kernels.intersect_words``, its plain
version on CPU tensors) equals the JAX ``intersect_on_device`` run on the
CPU for the same stacked words, bit for bit; ``DevicePostingsTier`` stages
after ``min_hits`` as the JAX tier does, drops a version-stale copy, never
stages ``{k=""}``, keeps its byte budget and the ledger's drift at 0 (under
a lookup storm with its sweep thread too); and the tier with another
backend than "python", or on a card that is not there, raises."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from filodb_tpu.core.filters import ColumnFilter as JaxFilter
from filodb_tpu.memstore.index import PartKeyIndex as JaxIndex
from filodb_tpu.memstore.index_device import DevicePostingsTier as JaxTier
from filodb_tpu.ops.postings_kernels import host_words_to_device as jax_to_device
from filodb_tpu.ops.postings_kernels import intersect_on_device
from filodb_tpu_torch.core.filters import equals, regex
from filodb_tpu_torch.ledger import LEDGER
from filodb_tpu_torch.memstore import postings as P
from filodb_tpu_torch.memstore.index import PartKeyIndex
from filodb_tpu_torch.memstore.index_device import DevicePostingsTier
from filodb_tpu_torch.memstore.shard import StoreConfig, TimeSeriesShard
from filodb_tpu_torch.ops import postings_kernels as PK

BIG = 2**62
CPU = torch.device("cpu")


def random_words(M: int, W: int, seed: int) -> np.ndarray:
    """[M, W] uint64 words, dense enough that an AND of six keeps bits."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, (M, W), dtype=np.uint64, endpoint=False) | \
        rng.integers(0, 2**64, (M, W), dtype=np.uint64, endpoint=False)


@pytest.mark.parametrize("W", [1, 17, 1024, 16_384])
@pytest.mark.parametrize("M", [1, 2, 3, 6])
def test_intersection_bit_equal_to_jax(M, W):
    words = random_words(M, W, M * 1000 + W)
    want = intersect_on_device([jax_to_device(w) for w in words])
    rows = [PK.host_words_to_device(w, CPU) for w in words]
    assert all(r.dtype == torch.int64 for r in rows)
    got = PK.device_words_to_host(PK.intersect_words(rows))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bitwise_and.reduce(words, axis=0))
    # an [M, W] tensor takes the same path
    stacked = PK.host_words_to_device(words, CPU)
    np.testing.assert_array_equal(PK.device_words_to_host(PK.intersect_words(stacked)), want)


def test_intersection_on_the_cpu_launches_nothing():
    before = PK.LAUNCHES
    words = random_words(3, 64, 5)
    PK.intersect_words([PK.host_words_to_device(w, CPU) for w in words])
    assert PK.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    ([], "at least one bitmap"),
    ([torch.zeros(8, dtype=torch.int32)], "int64"),
    ([torch.zeros(8, dtype=torch.int64), torch.zeros(9, dtype=torch.int64)], "int64"),
    ([torch.zeros((8, 2), dtype=torch.int64)[:, 0]], "contiguous"),
])
def test_intersection_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        PK.intersect_words(bad)


def hot_pair(min_hits=2, max_bytes=64 << 20, n=3000):
    """A port index with a CPU tier and a JAX index with its tier, over the
    same series."""
    port, jax = PartKeyIndex(), JaxIndex()
    for pid in range(n):
        tags = {"_ws_": "demo", "_ns_": f"ns{pid % 4}", "host": f"h{pid % 100}",
                "dc": f"dc{pid % 3}"}
        port.add_partkey(pid, tags, 0)
        jax.add_partkey(pid, tags, 0)
    port.device_tier = DevicePostingsTier(port, "cpu", min_hits=min_hits,
                                          max_bytes=max_bytes, name="test-tier")
    jax.device_tier = JaxTier(jax, min_hits=min_hits, max_bytes=max_bytes, name="jax-tier")
    return port, jax


def drift() -> int:
    slot = LEDGER.verify()["kinds"].get("index_postings")
    return slot["drift"] if slot else 0


def lookup(port, jax, filters, limit=None):
    got = port.part_ids_from_filters([equals(*f) for f in filters], 0, BIG, limit)
    want = jax.part_ids_from_filters([JaxFilter(k, "=", v) for k, v in filters], 0, BIG, limit)
    assert got.tolist() == want.tolist(), filters
    return got


SELECTORS = [
    [("_ws_", "demo"), ("_ns_", "ns1")],
    [("_ws_", "demo"), ("_ns_", "ns2"), ("dc", "dc1")],
    [("_ns_", "ns3"), ("host", "h7"), ("dc", "dc1"), ("_ws_", "demo")],
    [("host", "h42")],
    [("_ns_", "ns0"), ("host", "h1")],
]


@pytest.mark.parametrize("sel", range(len(SELECTORS)))
def test_tier_resolves_as_jax_after_min_hits(sel):
    port, jax = hot_pair(min_hits=3)
    f = SELECTORS[sel]
    for _ in range(2):
        lookup(port, jax, f)
    # below min_hits: nothing to stage
    assert port.device_tier.maintain() == jax.device_tier.maintain() == 0
    lookup(port, jax, f)
    assert port.traffic == jax.traffic
    assert port.device_tier.maintain() == jax.device_tier.maintain() == len(f)
    staged = port.device_tier.snapshot()
    assert [(e["label"], e["value"], e["bytes"]) for e in staged["staged"]] == [
        (e["label"], e["value"], e["bytes"]) for e in jax.device_tier.snapshot()["staged"]]
    assert staged["staged_bytes"] == staged["ledger_bytes"] == len(f) * P.nwords(
        port._nbits) * 8
    before = PK.LAUNCHES
    lookup(port, jax, f)
    lookup(port, jax, f, limit=3)
    assert PK.LAUNCHES == before  # the CPU tier runs the plain version
    assert port.device_tier.stats == jax.device_tier.stats
    assert port.device_tier.stats["intersections"] == 2
    assert drift() == 0


def test_stale_copy_is_dropped_and_restaged():
    port, jax = hot_pair()
    f = [("_ns_", "ns2"), ("_ws_", "demo")]
    for _ in range(3):
        lookup(port, jax, f)
    assert port.device_tier.maintain() == jax.device_tier.maintain() == 2
    for idx in (port, jax):
        idx.add_partkey(9000, {"_ws_": "demo", "_ns_": "ns2", "host": "hX"}, 0)
    got = lookup(port, jax, f)
    assert 9000 in got.tolist()
    assert port.device_tier.stats == jax.device_tier.stats
    assert port.device_tier.stats["dropped"] == 1
    # three lookups before staging, then the stale one
    assert port.device_tier.stats["host_fallbacks"] == 4
    assert drift() == 0
    assert port.device_tier.maintain() == jax.device_tier.maintain() == 2
    lookup(port, jax, f)
    assert port.device_tier.stats == jax.device_tier.stats
    assert drift() == 0
    port.device_tier.clear()
    assert drift() == 0 and port.device_tier.ledger.bytes == 0


def test_removal_makes_the_copy_stale():
    port, jax = hot_pair()
    f = [("_ns_", "ns1"), ("dc", "dc2")]
    for _ in range(3):
        lookup(port, jax, f)
    port.device_tier.maintain()
    jax.device_tier.maintain()
    for idx in (port, jax):
        idx.remove([5, 17, 29])
    lookup(port, jax, f)
    assert port.device_tier.stats == jax.device_tier.stats
    assert port.device_tier.stats["host_fallbacks"] >= 1


def test_empty_value_equality_is_never_staged():
    port, jax = PartKeyIndex(), JaxIndex()
    for pid in range(200):
        tags = {"m": "x"}
        if pid % 2:
            tags["a"] = ""
        port.add_partkey(pid, tags, 0)
        jax.add_partkey(pid, tags, 0)
    port.device_tier = DevicePostingsTier(port, "cpu", min_hits=1)
    f = [("a", "")]
    for _ in range(5):
        assert len(lookup(port, jax, f)) == 200
    assert ("a", "") not in port.traffic
    assert port.device_tier.maintain() == 0
    # stage the empty value's bitmap by force: the lookup still refuses it
    port.traffic[("a", "")] = 100
    port.device_tier.maintain()
    before = port.device_tier.stats["intersections"]
    assert len(lookup(port, jax, f)) == 200
    assert port.device_tier.stats["intersections"] == before


def test_non_equality_matchers_take_the_host_path():
    port, jax = hot_pair(min_hits=1)
    for _ in range(3):
        lookup(port, jax, [("_ws_", "demo"), ("_ns_", "ns1")])
    port.device_tier.maintain()
    before = dict(port.device_tier.stats)
    got = port.part_ids_from_filters([equals("_ws_", "demo"), regex("host", "h1.*")], 0, BIG)
    assert got.tolist() == jax.part_ids_from_filters(
        [JaxFilter("_ws_", "=", "demo"), JaxFilter("host", "=~", "h1.*")], 0, BIG).tolist()
    assert port.device_tier.stats == before


def test_byte_budget_holds():
    W = P.nwords(4096)
    port, jax = hot_pair(min_hits=1, max_bytes=2 * W * 8 + 8)
    for sel in SELECTORS:
        lookup(port, jax, sel)
    assert port._nbits == 4096
    assert port.device_tier.maintain() == jax.device_tier.maintain() == 2
    assert port.device_tier.snapshot()["staged_bytes"] == 2 * W * 8
    assert port.device_tier.maintain() == 0  # full
    assert drift() == 0


def test_universe_growth_across_stagings_takes_the_host_path():
    """A bitmap staged before the id universe grew is narrower than one
    staged after; a label the growth left untouched keeps its version, so
    the mix goes to the host (counted) and answers right."""
    port, jax = PartKeyIndex(), JaxIndex()
    for pid in range(1000):
        for idx in (port, jax):
            idx.add_partkey(pid, {"a": "x", "b": f"y{pid % 2}"}, 0)
    port.device_tier = DevicePostingsTier(port, "cpu", min_hits=1)
    for _ in range(2):
        lookup(port, jax, [("a", "x")])
    port.device_tier.maintain()
    for idx in (port, jax):
        idx.add_partkey(5000, {"b": "y0"}, 0)  # grows the universe; "a" untouched
    for _ in range(2):
        lookup(port, jax, [("b", "y0")])
    port.device_tier.maintain()
    before = port.device_tier.stats["host_fallbacks"]
    got = lookup(port, jax, [("a", "x"), ("b", "y0")])
    assert len(got) == 500
    assert port.device_tier.stats["host_fallbacks"] == before + 1


def test_lookup_storm_with_sweeps_keeps_drift_zero():
    """Three threads look up 1,200 times each (every 256th lookup starts a
    sweep on its own thread) while the main thread ingests new series
    under the staged labels: the ledger's drift stays 0 and the answers
    equal the JAX index's."""
    port, jax = hot_pair(min_hits=1)
    port.device_tier.sweep_min_interval_s = 0.0
    errors = []

    def storm():
        try:
            for k in range(1200):
                sel = SELECTORS[k % len(SELECTORS)]
                port.part_ids_from_filters([equals(*f) for f in sel], 0, BIG)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=storm) for _ in range(3)]
    for t in threads:
        t.start()
    for pid in range(3000, 3300):
        port.add_partkey(pid, {"_ws_": "demo", "_ns_": f"ns{pid % 4}", "host": "hZ"}, 0)
        jax.add_partkey(pid, {"_ws_": "demo", "_ns_": f"ns{pid % 4}", "host": "hZ"}, 0)
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for _ in range(1000):  # the last sweep's thread
        if not port.device_tier._maintaining:
            break
        threading.Event().wait(0.01)
    assert not port.device_tier._maintaining
    assert not errors, errors[:1]
    assert port.lookups >= 3600 and port.device_tier.stats["staged"] > 0
    assert drift() == 0
    for sel in SELECTORS:
        lookup(port, jax, sel)


def test_shard_wiring_and_stats():
    sh = TimeSeriesShard("d", 0, StoreConfig(index_device_postings=True, index_device="cpu",
                                             index_device_min_hits=1))
    tier = sh.index.device_tier
    assert isinstance(tier, DevicePostingsTier) and tier.device == CPU
    assert tier.min_hits == 1 and tier.max_bytes == 64 << 20
    assert sh.index_stats()["device"]["staged"] == []
    assert TimeSeriesShard("d", 1, StoreConfig(index_device="cpu")).index.device_tier is None


@pytest.mark.parametrize("backend", ["native", "set"])
def test_tier_with_another_backend_raises(backend):
    with pytest.raises(ValueError, match="index_device_postings needs index_backend"):
        TimeSeriesShard("d", 0, StoreConfig(index_backend=backend, index_device_postings=True,
                                            index_device="cpu"))


def test_tier_on_an_absent_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TimeSeriesShard("d", 0, StoreConfig(index_device_postings=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePostingsTier(PartKeyIndex(), "cuda")

