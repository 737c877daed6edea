"""The port's durable ``FileQueue`` against the JAX package's, on the CPU.

The cases of ``tests/test_file_queue.py`` on the port's queue, plus
side-by-side runs of both packages' queues on the same records: offsets,
``latest_offsets``, consumer polls and record contents must be equal.
Frames are not byte-equal across the packages (each pickles its own
``Record`` class), so the comparison is on offsets and contents. The
torn-tail and CRC behaviour is exercised on both."""

import os
import pickle
import struct
import zlib

import numpy as np
import pytest

from repro.core.queue import Consumer as RefConsumer
from repro.core.queue import FileQueue as RefFileQueue
from repro.core.queue import Record as RefRecord
from repro_torch.core.queue import (Consumer, FileQueue, PartitionedQueue,
                                    Record)


def rec(i, group="emb", seq=0, producer=0, cls=Record):
    return cls(group=group, op="upsert", ids=np.array([i], np.int64),
               payload={"values": np.full((1, 1), float(i), np.float32)},
               seq=seq, producer=producer,
               meta={"partition": 0, "t": float(i)})


def _ids(recs):
    return [int(r.ids[0]) for r in recs]


def test_roundtrip_and_cross_handle_visibility(tmp_path):
    q1 = FileQueue(tmp_path / "q", num_partitions=2)
    for i in range(5):
        q1.produce(i % 2, rec(i, seq=i))
    q2 = FileQueue(tmp_path / "q")          # partition count from meta
    assert q2.num_partitions == 2
    recs, nxt = q2.consume(0, 0)
    assert nxt == 3 and _ids(recs) == [0, 2, 4]
    np.testing.assert_array_equal(recs[1].payload["values"],
                                  np.full((1, 1), 2.0, np.float32))
    q1.produce(0, rec(6, seq=6))
    recs, nxt = q2.consume(0, nxt)
    assert _ids(recs) == [6] and nxt == 4
    q1.close()
    q2.close()


def test_offsets_match_in_memory_queue(tmp_path):
    fq = FileQueue(tmp_path / "q", num_partitions=4)
    mq = PartitionedQueue(4)
    for i in range(10):
        fq.produce(i % 4, rec(i, seq=i))
        mq.produce(i % 4, rec(i, seq=i))
    assert fq.latest_offsets() == mq.latest_offsets()
    cf, cm = Consumer(fq, [1, 3]), Consumer(mq, [1, 3])
    assert _ids(cf.poll()) == _ids(cm.poll())
    assert cf.offsets == cm.offsets
    assert cf.lag() == cm.lag() == 0
    fq.close()


def _tear(path, body):
    with open(path, "ab") as f:                       # torn: half a frame
        f.write(struct.Struct("<II").pack(len(body), zlib.crc32(body)))
        f.write(body[: len(body) // 2])


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_torn_tail_is_invisible_until_repaired(tmp_path, pkg):
    """A half-written frame reads as 'not yet produced'; the next
    write-open truncates it, in both packages alike."""
    fq, cls = (FileQueue, Record) if pkg == "port" else \
        (RefFileQueue, RefRecord)
    q = fq(tmp_path / "q", num_partitions=1)
    q.produce(0, rec(1, seq=1, cls=cls))
    q.close()
    path = tmp_path / "q" / "part-00000.log"
    clean_size = os.path.getsize(path)
    _tear(path, pickle.dumps(rec(2, seq=2, cls=cls), protocol=4))
    reader = fq(tmp_path / "q")
    recs, nxt = reader.consume(0, 0)
    assert _ids(recs) == [1] and nxt == 1
    reader.close()
    writer = fq(tmp_path / "q")                       # repair on write-open
    body3 = pickle.dumps(rec(3, seq=3, cls=cls), protocol=4)
    writer.produce(0, rec(3, seq=3, cls=cls))
    assert os.path.getsize(path) == clean_size + 8 + len(body3)
    recs, _ = writer.consume(0, 0)
    assert _ids(recs) == [1, 3]
    writer.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_corrupt_crc_stops_scan(tmp_path, pkg):
    fq, cls = (FileQueue, Record) if pkg == "port" else \
        (RefFileQueue, RefRecord)
    q = fq(tmp_path / "q", num_partitions=1)
    q.produce(0, rec(1, cls=cls))
    q.produce(0, rec(2, cls=cls))
    q.close()
    path = tmp_path / "q" / "part-00000.log"
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF                                  # flip a byte of rec 2
    open(path, "wb").write(bytes(data))
    reader = fq(tmp_path / "q")
    recs, nxt = reader.consume(0, 0)
    assert _ids(recs) == [1] and nxt == 1
    assert reader.latest_offsets() == {0: 1}
    reader.close()


def test_seek_past_unseen_tail_never_rewinds(tmp_path):
    prod = FileQueue(tmp_path / "q", num_partitions=1)
    cons = FileQueue(tmp_path / "q")
    recs, nxt = cons.consume(0, 5)                    # nothing there yet
    assert recs == [] and nxt == 5
    for i in range(7):
        prod.produce(0, rec(i, seq=i))
    recs, nxt = cons.consume(0, 5)                    # tail now visible
    assert _ids(recs) == [5, 6] and nxt == 7
    prod.close()
    cons.close()


def test_meta_partition_mismatch_rejected(tmp_path):
    """The port raises ``ValueError`` where the reference asserts."""
    FileQueue(tmp_path / "q", num_partitions=2).close()
    with pytest.raises(ValueError, match="has 2 partitions"):
        FileQueue(tmp_path / "q", num_partitions=4)
    with pytest.raises(ValueError):
        FileQueue(tmp_path / "fresh")                 # no count, no meta


def _stream(seed: int, n: int):
    """Seeded records of sync-stream shape: int8 payloads, several
    groups, producers and partitions."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 40))
        ids = rng.choice(1 << 40, size=k, replace=False).astype(np.int64)
        q = rng.integers(-127, 128, size=(k, 8)).astype(np.int8)
        scale = rng.uniform(size=(k, 1)).astype(np.float32)
        part = int(rng.integers(0, 4))
        out.append((part, dict(
            group=("w", "v")[i % 2], op=("upsert", "delete")[i % 7 == 6],
            ids=ids, payload={"q": q, "scale": scale}, seq=i // 3,
            producer=int(rng.integers(0, 3)),
            meta={"partition": part, "codec": "int8", "t": float(i)})))
    return out


def test_offsets_and_records_match_reference(tmp_path):
    """The same seeded stream through both packages' queues, produced in
    single appends and in batches from two handles each: equal offsets
    at every step, equal polls and equal record contents."""
    port = FileQueue(tmp_path / "port", num_partitions=4)
    ref = RefFileQueue(tmp_path / "ref", num_partitions=4)
    stream = _stream(1, 60)
    for j, (part, kw) in enumerate(stream[:30]):
        assert port.produce(part, Record(**kw)) == \
            ref.produce(part, RefRecord(**kw))
    port2, ref2 = FileQueue(tmp_path / "port"), RefFileQueue(tmp_path / "ref")
    by_part: dict = {}
    for part, kw in stream[30:]:
        by_part.setdefault(part, []).append(kw)
    for part, kws in sorted(by_part.items()):
        assert port2.produce_many(part, [Record(**k) for k in kws]) == \
            ref2.produce_many(part, [RefRecord(**k) for k in kws])
    assert port.latest_offsets() == ref.latest_offsets() == \
        port2.latest_offsets()
    assert port.produced_records + port2.produced_records == 60
    assert port.produced_bytes + port2.produced_bytes == \
        ref.produced_bytes + ref2.produced_bytes
    cons = (Consumer(port, [0, 2, 3], {2: 1}),
            RefConsumer(ref, [0, 2, 3], {2: 1}))
    for max_records in (3, None):
        got, want = (c.poll(max_records) for c in cons)
        assert cons[0].offsets == cons[1].offsets
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert (a.group, a.op, a.seq, a.producer, a.meta) == \
                (b.group, b.op, b.seq, b.producer, b.meta)
            np.testing.assert_array_equal(a.ids, b.ids)
            assert sorted(a.payload) == sorted(b.payload)
            for k in a.payload:
                assert a.payload[k].dtype == b.payload[k].dtype
                np.testing.assert_array_equal(a.payload[k], b.payload[k])
            assert a.nbytes() == b.nbytes()
    assert cons[0].lag() == cons[1].lag() == 0
    for c in cons:
        c.seek({0: 2, 3: 0})
    assert cons[0].offsets == cons[1].offsets
    assert cons[0].lag() == cons[1].lag()
    for q in (port, ref, port2, ref2):
        q.close()
