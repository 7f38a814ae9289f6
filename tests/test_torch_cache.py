"""The port's ``SuperblockCache`` and ``singleflight`` module against the
JAX package's: the same operation sequences return the same answers and
leave the same cache state (entries, versions, hits, last outcomes,
pins)."""

import threading

import pytest

from filodb_tpu import singleflight as JSF
from filodb_tpu.ops.staging import SuperblockCache as JaxCache
from filodb_tpu_torch import singleflight as SF
from filodb_tpu_torch.ops.staging import SuperblockCache

# name -> (constructor keyword arguments, [(method, *args), ...])
SEQUENCES = {
    "version_keying": ({}, [
        ("put", "k", (1, 1), "v", 10), ("get", "k", (1, 1)), ("get", "k", (1, 2)),
        ("peek", "k"), ("revalidate", "k", (9, 9), (1, 2)), ("revalidate", "k", (1, 1), (1, 2)),
        ("get", "k", (1, 2)), ("drop", "k"), ("peek", "k"), ("get", "k", (1, 2)),
    ]),
    "lru_on_hit": ({"max_entries": 2}, [
        ("put", "a", (1,), "va", 1), ("put", "b", (1,), "vb", 1), ("get", "a", (1,)),
        ("put", "c", (1,), "vc", 1), ("get", "a", (1,)), ("get", "b", (1,)), ("peek", "b"),
        ("get", "c", (1,)),
    ]),
    "lru_without_hit": ({"max_entries": 2}, [
        ("put", "a", (1,), "va", 1), ("put", "b", (1,), "vb", 1), ("put", "c", (1,), "vc", 1),
        ("peek", "a"), ("get", "b", (1,)), ("get", "c", (1,)),
    ]),
    "byte_budget": ({"max_entries": 8, "max_bytes": 100}, [
        ("put", "a", (1,), "va", 40), ("put", "b", (1,), "vb", 40), ("put", "c", (1,), "vc", 40),
        ("peek", "a"), ("peek", "b"), ("get", "b", (1,)), ("put", "d", (1,), "vd", 60),
        ("peek", "c"), ("peek", "b"), ("peek", "d"),
    ]),
    "too_big_is_not_stored": ({"max_bytes": 100}, [
        ("put", "a", (1,), "va", 50), ("put", "b", (1,), "vb", 101), ("peek", "b"),
        ("get", "a", (1,)),
    ]),
    "replace_in_place": ({"max_entries": 2}, [
        ("put", "a", (1,), "va", 5), ("put", "b", (1,), "vb", 5), ("put", "a", (2,), "va2", 7),
        ("get", "a", (1,)), ("get", "a", (2,)), ("peek", "b"),
    ]),
    "eviction_skips_pinned": ({"max_entries": 2}, [
        ("pin", "a", "q1"), ("put", "a", (1,), "va", 1), ("put", "b", (1,), "vb", 1),
        ("put", "c", (1,), "vc", 1), ("peek", "a"), ("peek", "b"), ("peek", "c"),
    ]),
    "all_pinned_runs_over_budget": ({"max_entries": 2}, [
        ("pin", "a", "q1"), ("pin", "b", "q2"), ("put", "a", (1,), "va", 1),
        ("put", "b", (1,), "vb", 1), ("put", "c", (1,), "vc", 1), ("peek", "a"), ("peek", "b"),
        ("peek", "c"),
    ]),
    "unpin_releases": ({"max_entries": 2}, [
        ("pin", "a", "q1"), ("pin", "a", "q2"), ("put", "a", (1,), "va", 1),
        ("unpin", "a", "q1"), ("put", "b", (1,), "vb", 1), ("put", "c", (1,), "vc", 1),
        ("peek", "a"), ("unpin", "a", "q2"), ("put", "d", (1,), "vd", 1), ("peek", "a"),
    ]),
    "notes_and_hits_survive_replace": ({}, [
        ("put", "a", (1,), "va", 1), ("get", "a", (1,)), ("get", "a", (1,)),
        ("note", "a", "extend"), ("put", "a", (2,), "va2", 1), ("note", "zz", "restage"),
        ("get", "a", (2,)),
    ]),
    "revalidate_after_drop_fails": ({}, [
        ("put", "a", (1, 2), "va", 3), ("drop", "a"), ("revalidate", "a", (1, 2), (1, 3)),
        ("put", "a", (1, 3), "vb", 3), ("revalidate", "a", (1, 2), (1, 4)),
        ("revalidate", "a", (1, 3), (1, 4)), ("get", "a", (1, 4)),
    ]),
}


def run(cache, steps):
    return [getattr(cache, op)(*args) for op, *args in steps]


def state(cache):
    return [{k: e[k] for k in ("key", "bytes", "hits", "last_outcome", "versions", "pinned")}
            for e in cache.snapshot()]


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_superblock_cache_matches_jax(name):
    kwargs, steps = SEQUENCES[name]
    want_cache, got_cache = JaxCache(**kwargs), SuperblockCache(**kwargs)
    assert run(got_cache, steps) == run(want_cache, steps)
    assert state(got_cache) == state(want_cache)
    assert len(got_cache) == len(want_cache)


def test_build_lock_is_per_key():
    c = SuperblockCache()
    assert c.build_lock("a") is c.build_lock("a")
    assert c.build_lock("a") is not c.build_lock("b")


@pytest.mark.parametrize("max_keys, alive_keys",
                         [(2, None), (3, None), (2, {"k0"}), (4, {"k1", "k3"})])
def test_keyed_single_flight_matches_jax(max_keys, alive_keys):
    alive = None if alive_keys is None else (lambda k: k in alive_keys)
    want, got = JSF.KeyedSingleFlight(max_keys, alive), SF.KeyedSingleFlight(max_keys, alive)
    for i in (0, 1, 2, 3, 1, 4, 0):
        key = f"k{i}"
        w1, g1 = want.lock(key), got.lock(key)
        assert (want.lock(key) is w1) == (got.lock(key) is g1)
        assert len(got) == len(want)


def test_single_flight_builds_once_under_race():
    flight = SF.KeyedSingleFlight()
    cache, built = {}, []
    gate = threading.Barrier(6)

    def worker():
        gate.wait()
        with flight.lock("key"):
            if "key" not in cache:
                built.append(1)
                cache["key"] = object()

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert built == [1]


def test_memo_on_builds_once_and_caches_no_failure():
    class Obj:
        pass

    o, calls = Obj(), []
    gate = threading.Barrier(4)

    def build():
        calls.append(1)
        return "v"

    def worker():
        gate.wait()
        assert SF.memo_on(o, "memo", "k", build) == "v"

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls == [1] and o.memo == {"k": "v"}

    def boom():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        SF.memo_on(o, "memo", "other", boom)
    assert "other" not in o.memo


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_single_flight_lru_matches_jax(capacity):
    want, got = JSF.SingleFlightLRU(capacity), SF.SingleFlightLRU(capacity)
    for key in ("a", "b", "a", "c", "d", "b", "a"):
        assert got.get_or_build(key, lambda: key.upper()) == want.get_or_build(
            key, lambda: key.upper())
        assert got.keys() == want.keys() and len(got) == len(want)
    assert got.pop("a") == want.pop("a")
    assert ("b" in got) == ("b" in want)
    got.clear()
    want.clear()
    assert len(got) == len(want) == 0
