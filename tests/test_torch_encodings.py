"""The port's chunk codecs (``filodb_tpu_torch/core/encodings.py``) against
the JAX package's (``filodb_tpu/core/encodings.py``) on seeded arrays: every
codec in both of the port's NibblePack tiers (the g++-built library and the
Python group loop) gives the JAX package's bytes, each package decodes the
other's bytes to the same array (NaN payloads bit for bit), and a damaged
payload raises ``CorruptVectorError`` in both."""

import struct

import numpy as np
import pytest

from filodb_tpu.core import encodings as J
from filodb_tpu_torch import native
from filodb_tpu_torch.core import encodings as P

TIERS = ("library", "python")


def int_cases():
    rng = np.random.default_rng(1)
    base = 1_600_000_000_000
    return {
        "empty": np.empty(0, np.int64),
        "one": np.array([base], np.int64),
        "constant_slope": base + 10_000 * np.arange(720, dtype=np.int64),
        "jittered": base + 10_000 * np.arange(720) + rng.integers(-500, 501, 720),
        "irregular": base + np.cumsum(rng.integers(5_000, 15_001, 400)),
        "negative": -np.cumsum(rng.integers(0, 1000, 97)),
        "wide": rng.integers(-2**62, 2**62, 64),  # incompressible: raw
        "odd_tail": base + 1000 * np.arange(13) ** 2,
    }


def double_cases():
    rng = np.random.default_rng(2)
    nan_payload = np.array([0x7FF8000000000001, 0xFFF0000000000123], np.uint64).view(np.float64)
    counter = np.cumsum(rng.uniform(0, 10, 720)) + 1e9
    gauge = 50 + 20 * rng.standard_normal(400)
    gauge[::17] = np.nan
    special = np.array([np.inf, -np.inf, 0.0, -0.0, np.nan, 1e-300, -1e300, 5e-324])
    return {
        "empty": np.empty(0),
        "counter": counter,
        "gauge_nan": gauge,
        "nan_payloads": np.concatenate([nan_payload, counter[:30], nan_payload]),
        "special": special,
        "integral": np.floor(counter),  # promoted to delta-delta int64
        "integral_big": np.array([2.0**53, 2.0**53 + 2, 1.0]),  # not promoted
        "constant": np.full(100, 3.25),
        "random_bits": rng.integers(0, 2**63, 40, dtype=np.int64).view(np.float64),
    }


def hist_cases():
    rng = np.random.default_rng(3)
    inc = rng.integers(0, 50, (300, 12))
    cum = np.cumsum(np.cumsum(inc, axis=1), axis=0)
    return {
        "cumulative": cum,
        "one_row": cum[:1],
        "one_bucket": cum[:, :1],
        "floats": cum.astype(np.float64),
        "reset": np.concatenate([cum[:100], cum[:50]]),
    }


def small_int_cases():
    rng = np.random.default_rng(4)
    return {f"bits{b}": rng.integers(-5, (1 << b) - 5, 77) for b in (1, 2, 4, 8, 16, 32)} | {
        "empty": np.empty(0, np.int64), "wide": rng.integers(0, 2**40, 9)}


def same(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal arrays, dtypes and float bit patterns (NaN payloads included)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == np.float64:
        return np.array_equal(got.view(np.uint64), want.view(np.uint64))
    return np.array_equal(got, want)


CODECS = {
    "int64": (int_cases, J.encode_int64, P.encode_int64),
    "double": (double_cases, J.encode_double, P.encode_double),
    "hist": (hist_cases, J.encode_hist, P.encode_hist),
    "int_packed": (small_int_cases, J.encode_int_packed, P.encode_int_packed),
}
CASES = [(codec, name) for codec, (cases, _, _) in CODECS.items() for name in cases()]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("codec,name", CASES, ids=[f"{c}-{n}" for c, n in CASES])
def test_codec_bytes_equal_jax_and_decode_both_ways(codec, name, tier):
    cases, jenc, penc = CODECS[codec]
    arr = cases()[name]
    want = jenc(arr)
    got = penc(arr, tier)
    assert got.to_bytes() == want.to_bytes()
    assert (got.fmt, got.n, got.nbytes) == (want.fmt, want.n, want.nbytes)
    # each package decodes the other's bytes to the same array
    from_jax = P.decode(P.Encoded.from_bytes(want.to_bytes()), tier)
    from_port = J.decode(J.Encoded.from_bytes(got.to_bytes()))
    assert same(from_jax, J.decode(want))
    assert same(from_port, J.decode(want))
    if codec in ("int64", "int_packed") or name in ("floats",):
        np.testing.assert_array_equal(from_jax, np.asarray(arr).astype(from_jax.dtype))
    elif codec == "double":
        assert same(from_jax.astype(np.float64), np.asarray(arr, np.float64))
    else:
        np.testing.assert_array_equal(from_jax, np.asarray(arr, np.int64))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("strings", [[], ["a"], ["x", "y", "x", "", "zz", "y"] * 7,
                                     [f"host-{i % 300}" for i in range(1000)]])
def test_utf8_dict_equals_jax(strings, tier):
    want = J.encode_utf8_dict(strings)
    got = P.encode_utf8_dict(strings, tier)
    assert got.to_bytes() == want.to_bytes()
    assert P.decode_utf8_dict(P.Encoded.from_bytes(want.to_bytes()), tier) == strings
    assert J.decode_utf8_dict(J.Encoded.from_bytes(got.to_bytes())) == strings


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1001])
def test_nibble_pack_tiers_agree_with_jax(n):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
    v[rng.random(n) < 0.4] = 0
    v[rng.random(n) < 0.2] <<= np.uint64(12)
    want = J._nibble_pack_py(v)
    for tier in TIERS:
        assert P.nibble_pack(v, tier) == want
        np.testing.assert_array_equal(P.nibble_unpack(want, n, tier), v)


def test_tier_is_explicit_and_counted():
    before = dict(P.TIER_CALLS)
    P.encode_double(np.linspace(0.5, 9.5, 30))
    P.encode_double(np.linspace(0.5, 9.5, 30), "python")
    assert P.TIER == "library"
    assert P.TIER_CALLS["library"] == before["library"] + 1
    assert P.TIER_CALLS["python"] == before["python"] + 1
    with pytest.raises(ValueError, match="unknown codec tier"):
        P.nibble_pack(np.zeros(3, np.uint64), "jax")


def test_library_is_built_by_hash_into_the_build_dir():
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent.name == "_build" and path.name.startswith("libfilodbcodecs-")
    assert native.lib() is native.lib()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "codecs.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))  # no half-built library left


def corrupt_payloads():
    v = np.cumsum(np.random.default_rng(5).uniform(0, 10, 200)) + 1e9
    xor = J.encode_double(v).to_bytes()
    dd = J.encode_int64(1_600_000_000_000 + np.cumsum(
        np.random.default_rng(6).integers(5_000, 15_001, 200))).to_bytes()
    hist = J.encode_hist(np.cumsum(np.ones((20, 4), np.int64), axis=0)).to_bytes()
    return {
        "xor_cut_in_headers": xor[:12],
        "xor_empty_stream": xor[:8],
        "dd_no_base": dd[:15],
        "dd_cut_in_headers": dd[:26],
        "hist_no_shape": hist[:11],
        "unknown_format": struct.pack("<BxHI", 99, 0, 4) + b"\x00" * 8,
        "int_pack_short": struct.pack("<BxHI", J.FMT_INT_PACK, 0, 50) + struct.pack("<qB", 0, 16),
    }


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", sorted(corrupt_payloads()))
def test_corrupt_payloads_raise_in_both(name, tier):
    raw = corrupt_payloads()[name]
    with pytest.raises(J.CorruptVectorError):
        J.decode(J.Encoded.from_bytes(raw))
    with pytest.raises(P.CorruptVectorError):
        P.decode(P.Encoded.from_bytes(raw), tier)


@pytest.mark.parametrize("tier", TIERS)
def test_truncated_nibbles_raise_in_the_port(tier):
    """A stream cut inside a group's nibbles: both port tiers refuse it
    (the JAX package's Python loop reads the short group as zeros)."""
    v = np.cumsum(np.random.default_rng(7).uniform(0, 10, 64)) + 1e9
    raw = J.encode_double(v).to_bytes()
    with pytest.raises(P.CorruptVectorError):
        P.decode(P.Encoded.from_bytes(raw[:-3]), tier)


def row_cases(n: int, rows: int, seed: int):
    """Rows of one length mixing every branch: constant slopes, jittered
    and irregular timestamps, incompressible and extreme ints; counters,
    integral doubles (promoted), NaN and +-Inf rows, random bits."""
    rng = np.random.default_rng(seed)
    base = 1_600_000_000_000
    ints = [base + 10_000 * np.arange(n), base + 10_000 * np.arange(n) + rng.integers(-9, 9, n),
            base + np.cumsum(rng.integers(5_000, 15_001, n)), rng.integers(-2**62, 2**62, n),
            np.full(n, -7), np.arange(n) * 3 - 2**62, np.linspace(0, 2**61, n).astype(np.int64)]
    dbls = [np.cumsum(rng.uniform(0, 10, n)) + 1e9, np.floor(rng.uniform(0, 1e6, n)),
            np.where(rng.random(n) < 0.2, np.nan, rng.standard_normal(n)),
            np.full(n, np.inf), rng.integers(0, 2**63, n, dtype=np.int64).view(np.float64),
            np.arange(n) * 2.0**50, np.full(n, 0.5), -np.arange(n, dtype=np.float64)]
    pick = rng.integers(0, len(ints), rows), rng.integers(0, len(dbls), rows)
    return (np.stack([ints[i] for i in pick[0]]).astype(np.int64),
            np.stack([dbls[i] for i in pick[1]]).astype(np.float64))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", [1, 2, 7, 8, 64, 400])
def test_row_codecs_equal_the_column_codecs(n, tier):
    ints, dbls = row_cases(n, 40, n)
    got = P.encode_int64_rows(ints, tier) + P.encode_double_rows(dbls, tier)
    with np.errstate(invalid="ignore"):
        want = [J.encode_int64(r) for r in ints] + [J.encode_double(r) for r in dbls]
    assert [g.to_bytes() for g in got] == [w.to_bytes() for w in want]
    back = P.decode_many(got, tier)
    assert all(same(b, J.decode(w)) for b, w in zip(back, want))
    assert all(b.base is None or b.base.shape == b.shape for b in back)  # own arrays


def test_decode_many_raises_on_the_bad_column():
    v = np.cumsum(np.random.default_rng(8).uniform(0, 10, (5, 64)), axis=1)
    encs = P.encode_double_rows(v)
    bad = P.Encoded(encs[3].fmt, encs[3].n, encs[3].payload[:-5])
    with pytest.raises(P.CorruptVectorError):
        P.decode_many(encs[:3] + [bad] + encs[4:])
    assert all(same(a, b) for a, b in zip(P.decode_many(encs), v))
