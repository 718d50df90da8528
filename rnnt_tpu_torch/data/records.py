"""Record shard IO: the port's own copy of `rnnt_tpu.data.records`, the
same dependency-free `.rnr` format, so shards written by either package
read in the other:

  file  := magic "RNTR" | u32 version | records...
  record:= u64 payload_len | u32 crc32(payload) | payload
  payload := n_arrays u8 | n * (name_len u8 | name | dtype_len u8 | dtype |
             ndim u8 | ndim * u64 dims | data_len u64 | raw bytes)

Length-prefixed with a CRC, so corrupt tails are detected and shards stream;
`write_shards` round-robins examples into N shards so that each process can
own a disjoint subset.
"""

from __future__ import annotations

import glob as globlib
import os
import struct
import zlib
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

MAGIC = b"RNTR"
VERSION = 1

Example = Dict[str, np.ndarray]


def _serialize(example: Example) -> bytes:
    parts = [struct.pack("<B", len(example))]
    for name, arr in example.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        dt = arr.dtype.str.encode()  # e.g. b'<f4'
        parts.append(struct.pack("<B", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b"")
        raw = arr.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _deserialize(payload: bytes) -> Example:
    off = 0
    (n,) = struct.unpack_from("<B", payload, off); off += 1
    out: Example = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<B", payload, off); off += 1
        name = payload[off:off + ln].decode(); off += ln
        (ld,) = struct.unpack_from("<B", payload, off); off += 1
        dtype = np.dtype(payload[off:off + ld].decode()); off += ld
        (nd,) = struct.unpack_from("<B", payload, off); off += 1
        shape = struct.unpack_from(f"<{nd}Q", payload, off) if nd else ()
        off += 8 * nd
        (nb,) = struct.unpack_from("<Q", payload, off); off += 8
        arr = np.frombuffer(payload, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)) if nd else 1, offset=off)
        off += nb
        out[name] = arr.reshape(shape) if nd else arr[0]
    return out


class RecordShardWriter:
    """Write examples into one shard file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC + struct.pack("<I", VERSION))
        self.count = 0

    def write(self, example: Example) -> None:
        payload = _serialize(example)
        self._f.write(struct.pack("<Q", len(payload)))
        self._f.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_shards(examples: Iterable[Example], path_pattern: str,
                 num_shards: int = 1) -> List[str]:
    """Round-robin examples into `num_shards` files.

    path_pattern like 'out/train-{shard:05d}-of-{total:05d}.rnr'.
    """
    paths = [path_pattern.format(shard=i, total=num_shards)
             for i in range(num_shards)]
    if len(set(paths)) != num_shards:
        raise ValueError(
            f"path_pattern {path_pattern!r} must contain a {{shard}} field "
            f"(e.g. 'train-{{shard:05d}}.rnr'); got {num_shards} writers "
            "colliding on the same path")
    writers = [RecordShardWriter(p) for p in paths]
    try:
        for i, ex in enumerate(examples):
            writers[i % num_shards].write(ex)
    finally:
        for w in writers:
            w.close()
    return paths


def read_shard(path: str, *, verify_crc: bool = True) -> Iterator[Example]:
    """Stream examples from one shard file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a RNTR shard")
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (ln,), (crc,) = struct.unpack("<Q", hdr[:8]), struct.unpack("<I", hdr[8:])
            payload = f.read(ln)
            if len(payload) < ln:
                raise EOFError(f"{path}: truncated record")
            if verify_crc and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise ValueError(f"{path}: CRC mismatch")
            yield _deserialize(payload)


def _shard_paths(pattern_or_paths) -> List[str]:
    if isinstance(pattern_or_paths, str):
        paths = sorted(globlib.glob(pattern_or_paths))
    else:
        paths = list(pattern_or_paths)
    if not paths:
        raise FileNotFoundError(f"no shards match {pattern_or_paths}")
    return paths


def scan_lengths(pattern_or_paths, *, process_index: int = 0,
                 process_count: int = 1,
                 fields: Sequence[str] = ("spec_lengths", "label_lengths")
                 ) -> Iterator[Dict[str, int]]:
    """Metadata-only scan: yields the scalar `fields` of every record of
    this process's shards (as `read_shards` splits them) without reading
    the payloads: large arrays are skipped with seeks, no CRC, no numpy
    arrays.  Counting the examples that survive the --pad_frames /
    --pad_tokens bounds for the multi-process steps-per-epoch agreement
    reads a few bytes a record."""
    want = set(fields)
    for p in _shard_paths(pattern_or_paths)[process_index::process_count]:
        with open(p, "rb") as f:
            if f.read(8)[:4] != MAGIC:
                raise ValueError(f"{p}: not a RNTR shard")
            while True:
                hdr = f.read(12)
                if len(hdr) < 12:
                    break
                (ln,) = struct.unpack("<Q", hdr[:8])
                end = f.tell() + ln
                (n,) = struct.unpack("<B", f.read(1))
                out: Dict[str, int] = {}
                for _ in range(n):
                    (lnm,) = struct.unpack("<B", f.read(1))
                    name = f.read(lnm).decode()
                    (ld,) = struct.unpack("<B", f.read(1))
                    dtype = np.dtype(f.read(ld).decode())
                    (nd,) = struct.unpack("<B", f.read(1))
                    if nd:
                        f.seek(8 * nd, 1)
                    (nb,) = struct.unpack("<Q", f.read(8))
                    if name in want and nb <= 16:
                        out[name] = int(np.frombuffer(
                            f.read(nb), dtype=dtype).reshape(-1)[0])
                    else:
                        f.seek(nb, 1)
                f.seek(end)  # realign past any trailing fields
                yield out


def read_shards(pattern_or_paths, *, process_index: int = 0,
                process_count: int = 1) -> Iterator[Example]:
    """Stream examples from shards, interleaved round-robin per process.

    With process_count > 1 each host reads a disjoint shard subset — the
    host-sharded input pipeline for multi-host training (SURVEY.md §2.3).
    """
    for p in _shard_paths(pattern_or_paths)[process_index::process_count]:
        yield from read_shard(p)
