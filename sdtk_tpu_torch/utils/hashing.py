"""First-party BLAKE3 content addressing (a copy of the JAX package's
``sdtk_tpu/utils/hashing.py`` without its native library, which is built
into that package).

Two implementations with identical digests: :func:`blake3_scalar`, plain
Python, and :func:`blake3_numpy`, which compresses BLAKE3's independent
1 KiB leaf chunks together as uint32 array operations.
:func:`compute_b3sum` is the store's content key: the first 32 hex digits.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
_CHUNK_START, _CHUNK_END, _PARENT, _ROOT = 1, 2, 4, 8
_MASK = 0xFFFFFFFF
_CHUNK_LEN = 1024
_BLOCK_LEN = 64

# (a, b, c, d, mx, my) per G application: 4 column mixes then 4 diagonal mixes.
_SCHEDULE = (
    (0, 4, 8, 12, 0, 1), (1, 5, 9, 13, 2, 3),
    (2, 6, 10, 14, 4, 5), (3, 7, 11, 15, 6, 7),
    (0, 5, 10, 15, 8, 9), (1, 6, 11, 12, 10, 11),
    (2, 7, 8, 13, 12, 13), (3, 4, 9, 14, 14, 15),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress(cv, m, counter, block_len, flags):
    """BLAKE3 compression; returns the 8-word chaining value."""
    v = list(cv) + list(_IV[:4]) + [counter & _MASK, (counter >> 32) & _MASK, block_len, flags]
    m = list(m)
    for rnd in range(7):
        for a, b, c, d, x, y in _SCHEDULE:
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va = (va + vb + m[x]) & _MASK
            vd = _rotr(vd ^ va, 16)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 12)
            va = (va + vb + m[y]) & _MASK
            vd = _rotr(vd ^ va, 8)
            vc = (vc + vd) & _MASK
            vb = _rotr(vb ^ vc, 7)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
        if rnd < 6:
            m = [m[p] for p in _MSG_PERM]
    return [v[i] ^ v[i + 8] for i in range(8)]


def _chunk_cv(chunk: bytes, counter: int, is_only_chunk: bool):
    """Compress one ≤1024-byte leaf chunk to its chaining value."""
    blocks = [chunk[i : i + _BLOCK_LEN] for i in range(0, len(chunk), _BLOCK_LEN)] or [b""]
    cv = list(_IV)
    for i, blk in enumerate(blocks):
        flags = _CHUNK_START if i == 0 else 0
        if i == len(blocks) - 1:
            flags |= _CHUNK_END | (_ROOT if is_only_chunk else 0)
        words = struct.unpack("<16I", blk.ljust(_BLOCK_LEN, b"\0"))
        cv = _compress(cv, words, counter, len(blk), flags)
    return cv


def _merge_tree(cvs):
    """Left-pairing merge with odd carry — BLAKE3's binary tree (left
    subtree = largest power-of-two chunk count)."""
    while len(cvs) > 1:
        nxt = []
        for i in range(0, len(cvs) - 1, 2):
            flags = _PARENT | (_ROOT if len(cvs) == 2 else 0)
            nxt.append(_compress(list(_IV), cvs[i] + cvs[i + 1], 0, _BLOCK_LEN, flags))
        if len(cvs) % 2:
            nxt.append(cvs[-1])
        cvs = nxt
    return cvs[0]


def blake3_scalar(data: bytes) -> bytes:
    """Plain-Python one-shot BLAKE3 (32-byte digest)."""
    chunks = [data[i : i + _CHUNK_LEN] for i in range(0, len(data), _CHUNK_LEN)] or [b""]
    if len(chunks) == 1:
        return struct.pack("<8I", *_chunk_cv(chunks[0], 0, True))
    cvs = [_chunk_cv(c, t, False) for t, c in enumerate(chunks)]
    return struct.pack("<8I", *_merge_tree(cvs))


def _compress_np(cv, m, counter_lo, counter_hi, block_len, flags):
    """Compression over N independent nodes: cv (8, N) and m (16, N)
    uint32; counters, block length and flags (N,) or scalars."""
    u32 = np.uint32
    v = np.empty((16, cv.shape[1]), dtype=u32)
    v[:8] = cv
    for i in range(4):
        v[8 + i] = u32(_IV[i])
    v[12], v[13], v[14], v[15] = counter_lo, counter_hi, block_len, flags
    m = [m[i] for i in range(16)]

    def rotr(x, r):
        return (x >> u32(r)) | (x << u32(32 - r))

    for rnd in range(7):
        for a, b, c, d, x, y in _SCHEDULE:
            v[a] += v[b] + m[x]
            v[d] = rotr(v[d] ^ v[a], 16)
            v[c] += v[d]
            v[b] = rotr(v[b] ^ v[c], 12)
            v[a] += v[b] + m[y]
            v[d] = rotr(v[d] ^ v[a], 8)
            v[c] += v[d]
            v[b] = rotr(v[b] ^ v[c], 7)
        if rnd < 6:
            m = [m[p] for p in _MSG_PERM]
    return v[:8] ^ v[8:]


def blake3_numpy(data: bytes) -> bytes:
    """Chunk-parallel BLAKE3: all full leaf chunks compressed together."""
    if len(data) <= _CHUNK_LEN:
        return blake3_scalar(data)
    n_full = len(data) // _CHUNK_LEN
    tail = data[n_full * _CHUNK_LEN :]
    if not tail:  # the last chunk is compressed on its own
        n_full -= 1
        tail = data[n_full * _CHUNK_LEN :]

    # (n_full, 16 blocks, 16 words) little-endian → (block, word, chunk)
    words = np.frombuffer(data, dtype="<u4", count=n_full * 256).reshape(n_full, 16, 16)
    words = np.ascontiguousarray(words.transpose(1, 2, 0)).astype(np.uint32)
    counters = np.arange(n_full, dtype=np.uint64)
    c_lo = counters.astype(np.uint32)
    c_hi = (counters >> np.uint64(32)).astype(np.uint32)
    cv = np.tile(np.array(_IV, dtype=np.uint32)[:, None], (1, n_full))
    for blk in range(16):
        flags = (_CHUNK_START if blk == 0 else 0) | (_CHUNK_END if blk == 15 else 0)
        cv = _compress_np(cv, words[blk], c_lo, c_hi, np.uint32(_BLOCK_LEN), np.uint32(flags))

    cvs = [[int(x) for x in cv[:, i]] for i in range(n_full)]
    cvs.append(_chunk_cv(tail, n_full, False))
    while len(cvs) > 2:  # parent levels, vectorized while wide
        n_pairs = len(cvs) // 2
        left = np.array([cvs[2 * i] for i in range(n_pairs)], dtype=np.uint32).T
        right = np.array([cvs[2 * i + 1] for i in range(n_pairs)], dtype=np.uint32).T
        out = _compress_np(np.tile(np.array(_IV, dtype=np.uint32)[:, None], (1, n_pairs)),
                           np.concatenate([left, right], axis=0), np.uint32(0), np.uint32(0),
                           np.uint32(_BLOCK_LEN), np.uint32(_PARENT))
        nxt = [[int(x) for x in out[:, i]] for i in range(n_pairs)]
        if len(cvs) % 2:
            nxt.append(cvs[-1])
        cvs = nxt
    return struct.pack("<8I", *_merge_tree(cvs))


blake3 = blake3_numpy  # one-shot digest (32 bytes); one chunk or less runs the scalar code


def blake3_hex(data: bytes) -> str:
    return blake3(data).hex()


def compute_b3sum(file_path: str | Path) -> str:
    """32-hex-char (128-bit) BLAKE3 of a file — the store's content key."""
    with open(file_path, "rb") as f:
        return blake3_hex(f.read())[:32]
