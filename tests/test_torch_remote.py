"""The port's remote-storage wire path against the JAX package's: the snappy
codec byte for byte, the hand-written prompb codec (``api/prompb.py``)
against the protobuf messages of ``filodb_tpu/api/remote_pb2.py`` in both
directions -- negative timestamps, NaN and the infinities, -0.0, UTF-8
labels, and fields the JAX schema lacks (Prometheus' metadata, exemplars,
native histograms, read hints), which both decoders skip -- and a remote
write then read round trip through both packages' handlers on mirrored
stores."""

import math
import struct

import numpy as np
import pytest

from filodb_tpu.api import remote_pb2 as pb
from filodb_tpu.api import remote_storage as JRS
from filodb_tpu.api import snappy as JSN
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu_torch.api import prompb as P
from filodb_tpu_torch.api import remote_storage as RS
from filodb_tpu_torch.api import snappy as SN
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

BASE = 1_600_000_000_000
ODD_VALUES = [1.5, float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 5e-324, -1.7e308]
ODD_TIMES = [-5, -(2**63), 2**63 - 1, 0, 1, BASE]


def series(seed=0, n=6, m=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        labels = [("__name__", "m_total"), ("instance", f"host-{i}"), ("zone", "zé ü 区")]
        samples = [(float(v), int(t)) for v, t in zip(rng.normal(0, 1e6, m),
                                                     BASE + np.arange(m) * 15_000)]
        out.append(P.TimeSeries(labels, samples))
    out.append(P.TimeSeries([("__name__", "odd")], list(zip(ODD_VALUES, ODD_TIMES * 2))))
    return out


def to_pb_write(ts_list) -> "pb.WriteRequest":
    req = pb.WriteRequest()
    for ts in ts_list:
        s = req.timeseries.add()
        for name, value in ts.labels:
            s.labels.add(name=name, value=value)
        for v, t in ts.samples:
            s.samples.add(value=v, timestamp=t)
    return req


def same_samples(a, b) -> bool:
    """Sample lists equal bit for bit (NaN and the sign of zero included)."""
    return len(a) == len(b) and all(
        struct.pack("<d", va) == struct.pack("<d", vb) and ta == tb
        for (va, ta), (vb, tb) in zip(a, b))


@pytest.mark.parametrize("size", [0, 1, 59, 60, 61, 255, 256, 65_536, 70_001])
def test_snappy_equals_jax(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert SN.compress(data) == JSN.compress(data)
    assert SN.decompress(JSN.compress(data)) == data
    # streams with copies, as a real snappy encoder writes them: "abc" then an
    # overlapping 9-byte copy at offset 3 (2-byte offset, then 1-byte offset)
    for stream in (b"\x0c\x08abc\x22\x03\x00", b"\x0c\x08abc" + bytes([(5 << 2) | 1, 3])):
        assert SN.decompress(stream) == JSN.decompress(stream) == b"abc" * 4


def test_port_write_request_parses_with_protobuf():
    written = series()
    raw = P.encode_write_request(written)
    req = pb.WriteRequest()
    req.ParseFromString(raw)
    assert req.SerializeToString() == raw == to_pb_write(written).SerializeToString()
    back = [(list((l.name, l.value) for l in s.labels),
             [(x.value, x.timestamp) for x in s.samples]) for s in req.timeseries]
    for (labels, samples), ts in zip(back, written):
        assert labels == ts.labels and same_samples(samples, ts.samples)


def test_protobuf_write_request_decodes_in_the_port():
    written = series(seed=1)
    got = P.decode_write_request(to_pb_write(written).SerializeToString())
    assert [t.labels for t in got] == [t.labels for t in written]
    assert all(same_samples(a.samples, b.samples) for a, b in zip(got, written))


def _field(num: int, wire: int, payload: bytes) -> bytes:
    key = P._put_uvarint((num << 3) | wire)
    if wire == P.LEN:
        return key + P._put_uvarint(len(payload)) + payload
    return key + payload


def test_unknown_fields_are_skipped_by_both():
    """Prometheus' WriteRequest metadata (field 3), a series' exemplars (3)
    and native histograms (4), a fixed32 and a varint field of no one's
    schema: both decoders keep the series and its samples and skip the
    rest."""
    written = series(seed=2, n=2)
    extra_series = (_field(3, P.LEN, b"\x0a\x02ab\x11" + b"\0" * 8)  # an exemplar
                    + _field(4, P.LEN, b"\x08\x05")  # a native histogram
                    + _field(9, P.FIXED32, b"\x01\x02\x03\x04")
                    + _field(10, P.VARINT, P._put_uvarint(2**64 - 1)))
    raw = b"".join(_field(1, P.LEN, P._encode_series(ts) + extra_series) for ts in written)
    raw += _field(3, P.LEN, b"\x08\x01\x12\x03m_t")  # metadata
    got = P.decode_write_request(raw)
    req = pb.WriteRequest()
    req.ParseFromString(raw)
    assert [t.labels for t in got] == [t.labels for t in written]
    assert [[(l.name, l.value) for l in s.labels] for s in req.timeseries] == [t.labels
                                                                               for t in got]
    assert all(same_samples(a.samples, b.samples) for a, b in zip(got, written))


def test_malformed_bodies_raise():
    with pytest.raises(ValueError):
        P.decode_write_request(b"\x0a\x05ab")  # a length past the end
    with pytest.raises(ValueError):
        P.decode_write_request(b"\x0b")  # wire type 3 (a group)
    with pytest.raises(ValueError):
        P.decode_write_request(b"\x08" + b"\xff" * 11)  # a varint past 64 bits


def test_read_request_and_response_both_ways():
    queries = [P.Query(BASE - 1, BASE + 10**6, [P.LabelMatcher(0, "__name__", "m_total"),
                                                P.LabelMatcher(2, "zone", "z.*"),
                                                P.LabelMatcher(3, "instance", "x"),
                                                P.LabelMatcher(1, "a", "")]),
               P.Query(-7, 0, [])]
    raw = P.encode_read_request(queries)
    req = pb.ReadRequest()
    req.ParseFromString(raw)
    assert req.SerializeToString() == raw
    assert [(q.start_timestamp_ms, q.end_timestamp_ms,
             [(int(m.type), m.name, m.value) for m in q.matchers]) for q in req.queries] == [
        (q.start_timestamp_ms, q.end_timestamp_ms, [(m.type, m.name, m.value)
                                                   for m in q.matchers]) for q in queries]
    assert P.decode_read_request(req.SerializeToString()) == queries
    results = [series(seed=3, n=3), [], series(seed=4, n=1)]
    raw = P.encode_read_response(results)
    resp = pb.ReadResponse()
    resp.ParseFromString(raw)
    assert resp.SerializeToString() == raw
    back = P.decode_read_response(resp.SerializeToString())
    assert [[t.labels for t in r] for r in back] == [[t.labels for t in r] for r in results]
    assert all(same_samples(a.samples, b.samples) for r, s in zip(back, results)
               for a, b in zip(r, s))


def mirrored():
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(4))
    pms.setup(S.Dataset("prometheus"), range(4))
    return jms, pms


def test_remote_write_then_read_equal_in_both_packages():
    """One snappy+protobuf write body into both packages' handlers, then one
    read body: the responses decode to the same series and samples (NaN
    samples left out by both), and the port's response bytes parse with
    protobuf."""
    written = series(seed=5)
    body = JSN.compress(to_pb_write(written).SerializeToString())
    jms, pms = mirrored()
    for batch in JRS.parse_write_request(body):
        jms.ingest_routed("prometheus", batch, spread=1)
    for batch in RS.parse_write_request(body):
        pms.ingest_routed("prometheus", batch, spread=1)
    req = P.encode_read_request([P.Query(-(2**62), 2**62, [P.LabelMatcher(2, "__name__", ".+")]),
                                 P.Query(BASE, BASE + 60_000,
                                         [P.LabelMatcher(0, "instance", "host-2")])])
    want_raw = SN.decompress(JRS.handle_read_request(SN.compress(req), jms, "prometheus"))
    got_raw = SN.decompress(RS.handle_read_request(SN.compress(req), pms, "prometheus"))
    resp = pb.ReadResponse()
    resp.ParseFromString(got_raw)
    assert resp.SerializeToString() == got_raw

    def canon(raw):
        return [sorted((tuple(t.labels), tuple((struct.pack("<d", v), ts) for v, ts in t.samples))
                       for t in r) for r in P.decode_read_response(raw)]

    assert canon(got_raw) == canon(want_raw)
    (everything, one) = P.decode_read_response(got_raw)
    assert len(everything) == len(written) and len(one) == 1
    odd = next(t for t in everything if t.labels == [("__name__", "odd")])
    assert not any(math.isnan(v) for v, _ in odd.samples) and len(odd.samples) < len(ODD_VALUES)
