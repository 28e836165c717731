"""All-encoding chunk layout (paper §3.2, Figure 1).

Storage is divided into fixed-size chunks (default 4 KB) prefixed by an
8-byte chunk ID.  A data chunk packs objects back-to-back:

    object := [ metadata | key | value ]
    metadata := key_size (1 byte) | value_size (3 bytes, little-endian)

so M = 4 bytes, matching the paper's analysis (§3.3).  Objects are appended
until the chunk is full, then the chunk is *sealed* and erasure-coded.

Chunk ID := stripe_list_id (2B) | stripe_id (5B) | chunk_position (1B)
(8 bytes total, I = 8 in the analysis).

Large objects (value larger than a chunk) are split into fragments, each
stored as its own object with a fragment-offset tag embedded in the key
suffix (paper §3.2 "Handling large objects").
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

CHUNK_SIZE = 4096
CHUNK_ID_SIZE = 8
METADATA_SIZE = 4  # 1B key size + 3B value size
MAX_KEY = 255
MAX_VALUE = (1 << 24) - 1

# tombstone: value_size field's top bit (we cap real values below 2^23)
_DELETED_BIT = 1 << 23


def object_size(key_size: int, value_size: int) -> int:
    return METADATA_SIZE + key_size + value_size


@dataclasses.dataclass(frozen=True)
class ChunkId:
    stripe_list_id: int
    stripe_id: int
    position: int  # 0..n-1 within stripe

    def pack(self) -> bytes:
        if not (0 <= self.stripe_list_id < 1 << 16):
            raise ValueError("stripe_list_id out of range")
        if not (0 <= self.stripe_id < 1 << 40):
            raise ValueError("stripe_id out of range")
        if not (0 <= self.position < 256):
            raise ValueError("position out of range")
        return struct.pack("<HIH", self.stripe_list_id,
                           self.stripe_id & 0xFFFFFFFF,
                           ((self.stripe_id >> 32) & 0xFF) | (self.position << 8))

    @staticmethod
    def unpack(raw: bytes) -> "ChunkId":
        sl, lo, hi = struct.unpack("<HIH", raw[:CHUNK_ID_SIZE])
        stripe_id = lo | ((hi & 0xFF) << 32)
        position = (hi >> 8) & 0xFF
        return ChunkId(sl, stripe_id, position)

    def key(self) -> tuple:
        return (self.stripe_list_id, self.stripe_id, self.position)

    def stripe_key(self) -> tuple:
        return (self.stripe_list_id, self.stripe_id)


@dataclasses.dataclass
class ObjectRef:
    """Reference stored in the object index: where an object lives."""
    chunk_local_idx: int   # index of the chunk in the server's memory region
    offset: int            # byte offset of the object inside the chunk
    key_size: int
    value_size: int

    @property
    def value_offset(self) -> int:
        return self.offset + METADATA_SIZE + self.key_size


def pack_object(key: bytes, value: bytes, deleted: bool = False) -> bytes:
    if len(key) > MAX_KEY:
        raise ValueError(f"key too long ({len(key)} > {MAX_KEY})")
    if len(value) >= _DELETED_BIT:
        raise ValueError("value too long for a single object")
    vfield = len(value) | (_DELETED_BIT if deleted else 0)
    md = struct.pack("<B", len(key)) + struct.pack("<I", vfield)[:3]
    return md + key + value


def parse_objects(content: np.ndarray | bytes):
    """Parse a data chunk's content into [(offset, key, value, deleted)].

    Stops at the first zero key_size byte (chunks are zero-initialized).
    """
    if isinstance(content, np.ndarray):
        content = content.tobytes()
    out = []
    off = 0
    n = len(content)
    while off + METADATA_SIZE <= n:
        ksz = content[off]
        if ksz == 0:
            break
        vfield = int.from_bytes(content[off + 1: off + 4], "little")
        deleted = bool(vfield & _DELETED_BIT)
        vsz = vfield & (_DELETED_BIT - 1)
        start_k = off + METADATA_SIZE
        key = content[start_k: start_k + ksz]
        value = content[start_k + ksz: start_k + ksz + vsz]
        if len(key) < ksz or len(value) < vsz:
            break  # truncated tail
        out.append((off, key, value, deleted))
        off = start_k + ksz + vsz
    return out


class ChunkBuilder:
    """Mutable data chunk being filled by SET requests (an *unsealed* chunk).

    Backed by a zero-initialized numpy byte array of CHUNK_SIZE.
    """

    __slots__ = ("chunk_size", "buf", "used", "objects", "sealed")

    def __init__(self, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = chunk_size
        self.buf = np.zeros(chunk_size, dtype=np.uint8)
        self.used = 0
        self.objects: list[tuple[bytes, int]] = []  # (key, offset)
        self.sealed = False

    @property
    def free(self) -> int:
        return self.chunk_size - self.used

    def fits(self, key: bytes, value_size: int) -> bool:
        return object_size(len(key), value_size) <= self.free

    def append(self, key: bytes, value: bytes) -> int:
        """Append an object; returns its byte offset inside the chunk."""
        if self.sealed:
            raise RuntimeError("chunk already sealed")
        blob = pack_object(key, value)
        if len(blob) > self.free:
            raise ValueError("object does not fit in chunk")
        off = self.used
        self.buf[off: off + len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        self.used += len(blob)
        self.objects.append((key, off))
        return off

    def write_value(self, offset: int, key_size: int, value: bytes):
        """In-place value overwrite (UPDATE; size must be unchanged)."""
        vo = offset + METADATA_SIZE + key_size
        self.buf[vo: vo + len(value)] = np.frombuffer(value, dtype=np.uint8)

    def read_value(self, offset: int, key_size: int, value_size: int) -> bytes:
        vo = offset + METADATA_SIZE + key_size
        return self.buf[vo: vo + value_size].tobytes()

    def mark_deleted(self, offset: int, key_size: int, value_size: int):
        """Tombstone + zero the value (paper: delta treats new value as 0)."""
        vfield = value_size | _DELETED_BIT
        self.buf[offset + 1: offset + 4] = np.frombuffer(
            struct.pack("<I", vfield)[:3], dtype=np.uint8)
        vo = offset + METADATA_SIZE + key_size
        self.buf[vo: vo + value_size] = 0

    def seal(self) -> np.ndarray:
        self.sealed = True
        return self.buf


def split_fragments(key: bytes, value: bytes, chunk_size: int = CHUNK_SIZE):
    """Split a large object into (fragment_key, fragment_value) pairs.

    Every fragment replicates the key plus a 4-byte fragment-offset suffix
    (paper §3.2: "all fragments keep both key and metadata").  Fragment
    payloads are sized so each fragment object fits in one chunk.
    """
    frag_key_size = len(key) + 4
    payload = chunk_size - METADATA_SIZE - frag_key_size
    if payload <= 0:
        raise ValueError("key too large for fragmentation")
    frags = []
    off = 0
    idx = 0
    while off < len(value) or (off == 0 and len(value) == 0):
        part = value[off: off + payload]
        frags.append((key + struct.pack("<I", idx), part))
        off += payload
        idx += 1
        if len(value) == 0:
            break
    return frags


def fragment_count(value_size: int, key_size: int, chunk_size: int = CHUNK_SIZE) -> int:
    payload = chunk_size - METADATA_SIZE - (key_size + 4)
    return max(1, -(-value_size // payload))
