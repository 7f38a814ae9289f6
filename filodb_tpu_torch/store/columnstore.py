"""The column store (counterpart of ``filodb_tpu/store/columnstore.py``;
reference L3: store/ChunkSink.scala, ChunkSource.scala,
cassandra/CassandraColumnStore.scala:55 — chunk, partkey and checkpoint
tables).

A local filesystem layout stands in for Cassandra: one append-only segment
per (shard, flush group), a partkey journal, a manifest of frame offsets
for selective reads, and the checkpoints. The layout, the frames and the
journals' lines are the JAX package's, byte for byte, so a store written
by either package is read by the other:

  <root>/FORMAT                          — format version
  <dataset>/shard-<n>/chunks-g<g>.seg    — framed encoded chunk sets
  <dataset>/shard-<n>/manifest.jsonl     — (pk hash, segment, offset, length, range)
  <dataset>/shard-<n>/partkeys.jsonl     — partkey journal (tags, start, end)
  <dataset>/checkpoints.json             — "shard/group" -> offset

``write_chunk_sets`` and ``write_partkeys`` write a flush group's frames
and partkeys with each file opened once; the bytes are those of one
``write_chunks`` / ``write_partkey`` call per series.
"""

from __future__ import annotations

import gc
import json
import os
import struct
import threading
from contextlib import contextmanager
from typing import Iterable, Sequence

from ..core.encodings import Encoded
from ..core.schemas import Schema, canonical_partkey, hash64
from ..memstore.partition import Chunk, encode_chunks

_FRAME = struct.Struct("<IHH")  # payload len, schema_id, n_columns


@contextmanager
def gc_paused():
    """Hold the cyclic garbage collector off for a bulk pass (a flush, a
    recovery, a page-in): they make hundreds of thousands of objects, and
    each collection walks every live object of the process, so a large
    store pays for them many times over. Reference counting still frees."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class PartkeyMemo(dict):
    """``canonical_partkey`` of tags dicts, memoized by their items (a
    series' frames repeat its tags in one order)."""

    def __call__(self, tags) -> bytes:
        key = tuple(tags.items())
        pk = self.get(key)
        if pk is None:
            pk = self[key] = canonical_partkey(tags)
        return pk


def torn_final_line(path: str) -> bool:
    """A crashed writer can leave a jsonl journal without a trailing
    newline; the next append must write ``\\n`` first or its first record
    merges into the half-written line and corrupts ONE entry. True when
    that guard byte is needed."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    with open(path, "rb") as chk:
        chk.seek(-1, os.SEEK_END)
        return chk.read(1) != b"\n"


class ColumnStore:
    """Write/read API (reference ChunkSink + ChunkSource raw reads)."""

    def write_chunks(self, dataset, shard, group, part_id, partkey_tags, schema, chunks):
        raise NotImplementedError

    def write_partkey(self, dataset, shard, tags, start_ts, end_ts):
        raise NotImplementedError

    def write_checkpoint(self, dataset, shard, group, offset):
        raise NotImplementedError

    def write_chunk_sets(self, dataset, shard, group, items):
        """Persist a flush group: ``items`` of ``(partkey_tags, schema,
        chunks)`` or ``(..., canonical partkey)``, in order."""
        for tags, schema, chunks, *_ in items:
            self.write_chunks(dataset, shard, group, -1, tags, schema, chunks)

    def write_partkeys(self, dataset, shard, records):
        """Journal ``(tags, start_ts, end_ts)`` records, in order."""
        for tags, start_ts, end_ts in records:
            self.write_partkey(dataset, shard, tags, start_ts, end_ts)

    def read_checkpoints(self, dataset, shard) -> dict[int, int]:
        raise NotImplementedError

    def read_partkeys(self, dataset, shard) -> list[dict]:
        raise NotImplementedError

    def read_chunks(self, dataset, shard) -> Iterable[tuple[dict, str, list[dict]]]:
        raise NotImplementedError

    def read_chunks_selective(
        self, dataset, shard, partkeys, start_ms: int, end_ms: int
    ) -> Iterable[tuple[dict, str, list]]:
        """Read only chunk sets belonging to ``partkeys`` (canonical partkey
        bytes) overlapping [start_ms, end_ms] (reference readRawPartitions:774
        reads per-partition row ranges, not the whole table). Default: filter
        over the full scan; backends with a manifest seek directly."""
        want = set(partkeys)
        for header, schema_name, encs in self.read_chunks(dataset, shard):
            if header["end"] < start_ms or header["start"] > end_ms:
                continue
            if canonical_partkey(header["tags"]) in want:
                yield header, schema_name, encs


class NullColumnStore(ColumnStore):
    """In-memory no-op sink so shards and queries run without persistence
    (reference NullColumnStore, ChunkSink.scala:159)."""

    def __init__(self):
        self.chunks_written = 0
        self.partkeys_written = 0
        self.checkpoints: dict = {}

    def write_chunks(self, dataset, shard, group, part_id, partkey_tags, schema, chunks):
        self.chunks_written += len(chunks)

    def write_partkey(self, dataset, shard, tags, start_ts, end_ts):
        self.partkeys_written += 1

    def write_checkpoint(self, dataset, shard, group, offset):
        self.checkpoints[(dataset, shard, group)] = offset

    def read_checkpoints(self, dataset, shard):
        return {
            g: off
            for (d, s, g), off in self.checkpoints.items()
            if d == dataset and s == shard
        }

    def read_partkeys(self, dataset, shard):
        return []

    def read_chunks(self, dataset, shard):
        return []


FORMAT_VERSION = 1


_U32 = struct.Struct("<I")


def _frame_parts(buf, off: int):
    """THE segment-frame layout, read: ``(end, header bytes, [payload
    bytes])`` of the frame at ``off`` of ``buf`` (bytes or a memoryview),
    its lengths checked against ``buf``; None when it is torn."""
    size = len(buf)
    if off + _FRAME.size + 4 > size:
        return None
    _, _schema_id, n_cols = _FRAME.unpack_from(buf, off)
    (hlen,) = _U32.unpack_from(buf, off + _FRAME.size)
    p = off + _FRAME.size + 4
    if p + hlen > size:
        return None
    hdr = buf[p:p + hlen]
    p += hlen
    payloads = []
    for _ in range(n_cols):
        if p + 4 > size:
            return None
        (plen,) = _U32.unpack_from(buf, p)
        p += 4
        if p + plen > size:
            return None
        payloads.append(buf[p:p + plen])
        p += plen
    return p, hdr, payloads


def _parse_frames(parts: list, decode_payloads: bool = True) -> list:
    """``(header, encs)`` of the leading frames of ``_frame_parts`` that
    parse (a frame whose header is not JSON, or a payload too short for
    its column header, ends them); the headers read in one ``json.loads``,
    one call each where that fails."""
    try:
        headers = json.loads(b"[" + b",".join(h for _, h, _ in parts) + b"]")
        if len(headers) != len(parts) or not all(isinstance(h, dict) for h in headers):
            raise ValueError("headers do not split as framed")
    except ValueError:
        headers = []
        for _, h, _ in parts:
            try:
                headers.append(json.loads(bytes(h)))
            except ValueError:
                break
    out = []
    for header, (_, _, payloads) in zip(headers, parts):
        try:
            encs = [Encoded.from_bytes(p) for p in payloads] if decode_payloads else None
        except (struct.error, ValueError):
            break
        out.append((header, encs))
    return out


def _parse_frames_each(parts: list) -> list:
    """``(header, encs)`` of every independent frame of ``parts`` that
    parses (a bad one is skipped, not an end); the headers in one
    ``json.loads`` where they all parse."""
    good = _parse_frames(parts)
    if len(good) == len(parts):
        return good
    out = []
    for end, hdr, payloads in parts:
        got = _parse_frames([(end, hdr, payloads)])
        out.extend(got)
    return out


def _iter_frames(f, decode_payloads: bool = True):
    """Yields ``(offset, length, header, encs)`` for each complete frame
    from the file's current position (read whole, parsed in memory); stops
    cleanly at the first torn or corrupt frame (reference torn-write
    tolerance)."""
    base = f.tell()
    buf = memoryview(f.read())
    parts, off = [], 0
    while True:
        got = _frame_parts(buf, off)
        if got is None:
            break
        parts.append((off,) + got)
        off = got[0]
    for (start, end, _, _), (header, encs) in zip(
            parts, _parse_frames([p[1:] for p in parts], decode_payloads)):
        yield base + start, end - start, header, encs


class LocalColumnStore(ColumnStore):
    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        # selective-read instrumentation + cached parsed manifests
        self.stats_selective_bytes = 0
        self._manifest_cache: dict[tuple[str, int], tuple[float, int, list]] = {}
        os.makedirs(root, exist_ok=True)
        # store format versioning (refuse to misread future layouts)
        vpath = os.path.join(root, "FORMAT")
        if os.path.exists(vpath):
            with open(vpath) as f:
                ver = int(f.read().strip() or 1)
            if ver > FORMAT_VERSION:
                raise ValueError(
                    f"store at {root} has format v{ver}; this build reads <= v{FORMAT_VERSION}"
                )
        else:
            with open(vpath, "w") as f:
                f.write(str(FORMAT_VERSION))

    def _shard_dir(self, dataset, shard) -> str:
        d = os.path.join(self.root, dataset, f"shard-{shard}")
        os.makedirs(d, exist_ok=True)
        return d

    # -- writes ----------------------------------------------------------

    def write_chunks(self, dataset, shard, group, part_id, partkey_tags, schema: Schema,
                     chunks: Sequence[Chunk]):
        """Append framed encoded chunk sets (reference
        CassandraColumnStore.write:207), each journaled to the shard's
        manifest (partkey hash, segment, offset, length, time range) so a
        selective read seeks straight to it. Manifest lines follow their
        frames in program order, but the OS may flush the two files in any
        order: the selective reader trusts no entry and skips a frame that
        fails to parse."""
        self.write_chunk_sets(dataset, shard, group, [(partkey_tags, schema, chunks)])

    def write_chunk_sets(self, dataset, shard, group, items):
        seg = f"chunks-g{group}.seg"
        d = self._shard_dir(dataset, shard)
        path = os.path.join(d, seg)
        mpath = os.path.join(d, "manifest.jsonl")
        by_schema: dict = {}
        for item in items:
            by_schema.setdefault(item[1].name, (item[1], []))[1].extend(item[2])
        for schema, chunks in by_schema.values():
            encode_chunks(schema, chunks)
        with self._lock:
            # a shard written before manifests existed: backfill its manifest
            # once, or selective reads would hide every older chunk
            if not os.path.exists(mpath) and any(fn.startswith("chunks-") for fn in os.listdir(d)):
                self._backfill_manifest(dataset, shard, mpath)
        seg_json = json.dumps(seg)
        cols_json: dict = {}
        with self._lock, open(path, "ab") as f, open(mpath, "ab") as mf:
            if torn_final_line(mpath):
                mf.write(b"\n")
            off = f.tell()
            frames, lines = [], []
            for partkey_tags, schema, chunks, *pk in items:
                key = pk[0] if pk else canonical_partkey(partkey_tags)
                pk_json = f'"{hash64(key):016x}"'
                # json.dumps of the JAX package's header dict, built by parts
                head = f'{{"tags": {json.dumps(dict(partkey_tags))}, "schema": ' \
                       f'{json.dumps(schema.name)}, "start": '
                schema_id = schema.schema_id
                for c in chunks:
                    enc = c.encoded
                    names = tuple(enc)
                    cols = cols_json.get(names)
                    if cols is None:
                        cols = cols_json[names] = json.dumps(list(names))
                    hdr = f'{head}{c.start_ts}, "end": {c.end_ts}, "n": {c.n}, "cols": {cols}}}' \
                        .encode()
                    parts = [_FRAME.pack(len(hdr), schema_id, len(enc)),
                             struct.pack("<I", len(hdr)), hdr]
                    for e in enc.values():
                        p = e.to_bytes()
                        parts.append(struct.pack("<I", len(p)))
                        parts.append(p)
                    frame = b"".join(parts)
                    frames.append(frame)
                    lines.append(f'{{"pk": {pk_json}, "seg": {seg_json}, "off": {off}, "len": '
                                 f'{len(frame)}, "start": {c.start_ts}, "end": {c.end_ts}}}\n')
                    off += len(frame)
            f.write(b"".join(frames))
            mf.write("".join(lines).encode())
            self._manifest_cache.pop((dataset, shard), None)

    def _backfill_manifest(self, dataset, shard, mpath):
        """One-time manifest build for a shard written before manifests
        existed: scan every segment frame, recording offsets. Written to a
        temp file then renamed so a crash mid-backfill retries cleanly."""
        d = os.path.dirname(mpath)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as mf:
            for fn in sorted(os.listdir(d)):
                if not fn.startswith("chunks-"):
                    continue
                with open(os.path.join(d, fn), "rb") as f:
                    for off, length, header, _ in _iter_frames(f, decode_payloads=False):
                        pk_hex = f"{hash64(canonical_partkey(header['tags'])):016x}"
                        mf.write(json.dumps({
                            "pk": pk_hex, "seg": fn, "off": off, "len": length,
                            "start": header["start"], "end": header["end"],
                        }) + "\n")
        os.replace(tmp, mpath)
        self._manifest_cache.pop((dataset, shard), None)

    def write_partkey(self, dataset, shard, tags, start_ts, end_ts):
        self.write_partkeys(dataset, shard, [(tags, start_ts, end_ts)])

    def write_partkeys(self, dataset, shard, records):
        path = os.path.join(self._shard_dir(dataset, shard), "partkeys.jsonl")
        # json.dumps of {"tags", "start", "end"}, built by parts
        body = "".join(f'{{"tags": {json.dumps(dict(tags))}, "start": {int(start_ts)}, '
                       f'"end": {int(end_ts)}}}\n' for tags, start_ts, end_ts in records)
        with self._lock, open(path, "a") as f:
            f.write(body)

    def write_checkpoint(self, dataset, shard, group, offset):
        """reference CheckpointTable: per (dataset, shard, group) offsets. The
        dataset's directory is made here too: a flush whose first shards hold
        no series writes a checkpoint before any chunk (the JAX package's
        store raises there, ROADMAP C)."""
        path = os.path.join(self.root, dataset, "checkpoints.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            data = {}
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
            data[f"{shard}/{group}"] = int(offset)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)

    # -- reads -----------------------------------------------------------

    def read_checkpoints(self, dataset, shard) -> dict[int, int]:
        path = os.path.join(self.root, dataset, "checkpoints.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            data = json.load(f)
        out = {}
        for k, v in data.items():
            s, g = k.split("/")
            if int(s) == shard:
                out[int(g)] = v
        return out

    def read_partkeys(self, dataset, shard) -> list[dict]:
        path = os.path.join(self.root, dataset, f"shard-{shard}", "partkeys.jsonl")
        if not os.path.exists(path):
            return []
        out: dict[str, dict] = {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                key = json.dumps(rec["tags"], sort_keys=True)
                out[key] = rec  # last write wins (end-time updates)
        return list(out.values())

    def read_chunks(self, dataset, shard):
        """Yield (header, schema_name, [Encoded per column]) for every chunk
        set in the shard (reference readRawPartitions:774).

        A truncated tail (crash mid-append) ends that segment's iteration
        cleanly — everything before the torn frame is served; the next flush
        appends after it (the torn frame is bounded garbage the reader skips
        forever, matching the reference's torn-write tolerance)."""
        d = os.path.join(self.root, dataset, f"shard-{shard}")
        if not os.path.isdir(d):
            return
        for fn in sorted(os.listdir(d)):
            if not fn.startswith("chunks-"):
                continue
            with open(os.path.join(d, fn), "rb") as f:
                frames = list(_iter_frames(f))
            for _off, _len, header, encs in frames:
                yield header, header["schema"], encs

    def _manifest(self, dataset, shard) -> list[dict] | None:
        """Parsed manifest entries for a shard, cached by (mtime, size).
        None when the shard predates manifests (callers full-scan)."""
        mpath = os.path.join(self.root, dataset, f"shard-{shard}", "manifest.jsonl")
        if not os.path.exists(mpath):
            return None
        key = (dataset, shard)
        st = os.stat(mpath)
        cached = self._manifest_cache.get(key)
        if cached is not None and cached[0] == st.st_mtime and cached[1] == st.st_size:
            return cached[2]
        # hold the store lock for the read+repair: write_chunks appends the
        # segment frame and its manifest line under the same lock, so a
        # repair scan can never mistake a mid-flush frame for an orphan (and
        # append a duplicate entry), and the stat taken under the lock is
        # consistent with what was read
        with self._lock:
            st = os.stat(mpath)
            entries = []
            with open(mpath) as f:
                for line in f:
                    try:
                        entries.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn/merged line: later appends stay visible
            repaired = self._repair_manifest(dataset, shard, mpath, entries)
            if repaired:
                entries.extend(repaired)
                st = os.stat(mpath)  # repair appended under this same lock
            self._manifest_cache[key] = (st.st_mtime, st.st_size, entries)
        return entries

    def _repair_manifest(self, dataset, shard, mpath, entries) -> list[dict]:
        """Re-index segment bytes beyond what the manifest covers (a crash
        between the segment append and the manifest append orphans the frame;
        OS flush ordering between the two files is not guaranteed either).
        Parses frames from the first uncovered offset; appends recovered
        entries to the manifest. Torn garbage at the boundary ends the scan,
        exactly like the full-scan reader. Caller MUST hold self._lock."""
        d = os.path.dirname(mpath)
        by_seg: dict[str, list[tuple[int, int]]] = {}
        for e in entries:
            by_seg.setdefault(e["seg"], []).append((e["off"], e["off"] + e["len"]))
        recovered = []
        for fn in sorted(os.listdir(d)):
            if not fn.startswith("chunks-"):
                continue
            path = os.path.join(d, fn)
            size = os.path.getsize(path)
            # uncovered byte ranges of this segment (an orphan can sit BETWEEN
            # covered frames when later appends succeeded after the crash)
            holes: list[tuple[int, int]] = []
            pos = 0
            for o, end in sorted(by_seg.get(fn, ())):
                if o > pos:
                    holes.append((pos, o))
                pos = max(pos, end)
            if size > pos:
                holes.append((pos, size))
            if not holes:
                continue
            with open(path, "rb") as f:
                for hs, he in holes:
                    f.seek(hs)
                    for off, length, header, _ in _iter_frames(f, decode_payloads=False):
                        if off + length > he:
                            break
                        pk_hex = f"{hash64(canonical_partkey(header['tags'])):016x}"
                        recovered.append({
                            "pk": pk_hex, "seg": fn, "off": off, "len": length,
                            "start": header["start"], "end": header["end"],
                        })
        if recovered:
            with open(mpath, "a") as mf:
                for e in recovered:
                    mf.write(json.dumps(e) + "\n")
        return recovered

    def read_chunks_selective(self, dataset, shard, partkeys, start_ms, end_ms):
        """Manifest-seek read: only frames of the requested partkeys
        overlapping the time range are read and decoded (reference
        OnDemandPagingShard.scala:147 + readRawPartitions:774 read only the
        needed partitions/rows). Falls back to the filtering full scan for
        pre-manifest stores."""
        entries = self._manifest(dataset, shard)
        if entries is None:
            yield from super().read_chunks_selective(dataset, shard, partkeys, start_ms, end_ms)
            return
        want = {f"{hash64(pk):016x}" for pk in partkeys}
        pk_bytes = set(partkeys)
        partkey_of = PartkeyMemo()
        by_seg: dict[str, list[dict]] = {}
        for e in entries:
            if e["pk"] in want and e["end"] >= start_ms and e["start"] <= end_ms:
                by_seg.setdefault(e["seg"], []).append(e)
        d = os.path.join(self.root, dataset, f"shard-{shard}")
        for seg, hits in sorted(by_seg.items()):
            hits.sort(key=lambda e: e["off"])
            try:
                f = open(os.path.join(d, seg), "rb")
            except OSError:
                continue  # entry outlived its segment (manifest is a journal)
            with f:
                # many frames of the segment: one read of it; a few: a seek each
                whole = 4 * sum(e["len"] for e in hits) >= os.fstat(f.fileno()).st_size
                data = memoryview(f.read()) if whole else None
                parts = []
                for e in hits:
                    if whole:
                        raw = data[e["off"]:e["off"] + e["len"]]
                    else:
                        f.seek(e["off"])
                        raw = f.read(e["len"])
                    if len(raw) < e["len"]:
                        continue  # torn frame
                    self.stats_selective_bytes += len(raw)
                    # a stale manifest entry (manifest durable, frame torn,
                    # then overwritten by a later append) parses as garbage
                    # here and is skipped, as the full-scan reader skips it
                    got = _frame_parts(raw, 0)
                    if got is not None:
                        parts.append(got)
                for header, encs in _parse_frames_each(parts):
                    # 64-bit hash collisions are all but impossible at TSDB
                    # scale but cheap to exclude exactly
                    if partkey_of(header["tags"]) not in pk_bytes:
                        continue
                    yield header, header["schema"], encs
