"""Pure-python Blosc1 chunk codec (decoder + a real LZ4 encoder); a copy of
volren_tpu.voldata.blosc whose output bytes equal it.

Real-world OpenVDB files (JangaFX exports, the WDAS cloud, anything saved
with stock ``openvdb::io`` defaults) compress leaf buffers with Blosc over
LZ4 with byte-shuffle — the reference reads them via libopenvdb's blosc
dependency (voldata submodule, SURVEY 2b). No blosc/lz4 library exists in
this environment, so this implements the public c-blosc1 chunk container
(README_CHUNK_FORMAT.rst) and the LZ4 block format from scratch:

  16-byte header:
    byte 0  version, byte 1 versionlz
    byte 2  flags: bit0 byte-shuffle, bit1 pure-memcpy, bit2 bit-shuffle,
            bit4 blocks-not-split, bits5-7 compressor enum
    byte 3  typesize
    u32 @4  nbytes (uncompressed), u32 @8 blocksize, u32 @12 cbytes
  then (unless memcpy): u32 per-block start offsets, and per block either
  one stream or ``typesize`` split streams, each ``i32 csize`` + payload
  (csize == stream size means the stream is stored raw).

Blocks produced by pre-1.14 encoders do not set the bit-4 split flag; for
those the FORWARD_COMPAT rule applies (split iff compressor is blosclz or
lz4, typesize <= 16 and blocksize/typesize >= 128) — the same rule stock
decoders use. Byte-shuffle is applied per block with the non-multiple tail
kept raw, matching c-blosc's shuffle().

Supported compressors: lz4/lz4hc (from-scratch decoder+encoder below) and
zlib (stdlib). blosclz/snappy/zstd chunks raise with the compressor named.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

FLAG_SHUFFLE = 0x1
FLAG_MEMCPY = 0x2
FLAG_BITSHUFFLE = 0x4
FLAG_NOSPLIT = 0x10

COMP_BLOSCLZ = 0
COMP_LZ4 = 1
COMP_SNAPPY = 2
COMP_ZLIB = 3
COMP_ZSTD = 4

_COMP_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}

# split_block() constants (c-blosc blosc.c)
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128

_VERSION = 2  # BLOSC_VERSION_FORMAT
_VERSION_LZ4 = 1


# ---------------------------------------------------------------- LZ4 block


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block (lz4_Block_format.md) of known output size."""
    n = len(src)
    dst = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        llen = token >> 4
        if llen == 15:
            while True:
                b = src[i]
                i += 1
                llen += b
                if b != 255:
                    break
        if llen:
            dst += src[i : i + llen]
            i += llen
        if i >= n:
            break  # last sequence carries literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 stream: zero match offset")
        mlen = (token & 0xF) + 4
        if mlen == 19:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 stream: offset past start")
        if offset >= mlen:
            dst += dst[start : start + mlen]
        else:  # overlapping match: the copied region repeats the pattern
            pattern = dst[start:]
            reps = -(-mlen // offset)
            dst += (pattern * reps)[:mlen]
    if len(dst) != dst_size:
        raise ValueError(f"LZ4 stream decoded {len(dst)} B, expected {dst_size}")
    return bytes(dst)


def lz4_compress(src: bytes) -> bytes:
    """Greedy hash-chain LZ4 block encoder (valid per the block-format
    end-condition rules: last 5 bytes literal, no match into the last 5)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"  # one token: zero literals, no match
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0

    def emit(lit_end: int, mlen: int, offset: int) -> None:
        litlen = lit_end - anchor
        l_nib = 15 if litlen >= 15 else litlen
        m_ext = mlen - 4 if mlen else 0
        m_nib = 15 if m_ext >= 15 else m_ext
        out.append((l_nib << 4) | (m_nib if mlen else 0))
        if litlen >= 15:
            rem = litlen - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[anchor:lit_end])
        if mlen:
            out.extend(struct.pack("<H", offset))
            if m_ext >= 15:
                rem = m_ext - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i < n - 12:  # spec: last match must start >= 12 B before end
        key = src[i : i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 65535:
            mlen = 4
            max_m = n - 5 - i  # match may not cover the last 5 bytes
            while mlen < max_m and src[j + mlen] == src[i + mlen]:
                mlen += 1
            emit(i, mlen, i - j)
            anchor = i + mlen
            i = anchor
        else:
            i += 1
    emit(n, 0, 0)
    return bytes(out)


# ------------------------------------------------------------ shuffle filter


def _shuffle(typesize: int, block: bytes) -> bytes:
    n = len(block)
    main = n - n % typesize
    arr = np.frombuffer(block[:main], np.uint8).reshape(-1, typesize)
    return arr.T.reshape(-1).tobytes() + block[main:]


def _unshuffle(typesize: int, block: bytes) -> bytes:
    n = len(block)
    main = n - n % typesize
    arr = np.frombuffer(block[:main], np.uint8).reshape(typesize, -1)
    return arr.T.reshape(-1).tobytes() + block[main:]


def _split_block(compcode: int, typesize: int, blocksize: int) -> bool:
    return (
        compcode in (COMP_BLOSCLZ, COMP_LZ4)
        and 1 < typesize <= _MAX_SPLITS
        and blocksize % typesize == 0
        and blocksize // typesize >= _MIN_BUFFERSIZE
    )


# ------------------------------------------------------------------- codec


def decompress(buf: bytes) -> bytes:
    """Decode one Blosc1 chunk to its uncompressed bytes."""
    buf = bytes(buf)
    if len(buf) < 16:
        raise ValueError("blosc chunk shorter than its 16-byte header")
    flags, typesize = buf[2], buf[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", buf, 4)
    if cbytes > len(buf):
        raise ValueError(f"blosc chunk truncated: cbytes {cbytes} > {len(buf)}")
    if flags & FLAG_MEMCPY:
        return buf[16 : 16 + nbytes]
    if flags & FLAG_BITSHUFFLE:
        raise ValueError("blosc bit-shuffle filter not supported")
    compcode = (flags >> 5) & 0x7
    if compcode not in (COMP_LZ4, COMP_ZLIB):
        name = _COMP_NAMES.get(compcode, str(compcode))
        raise ValueError(f"blosc compressor {name!r} not supported (lz4/zlib only)")
    if nbytes == 0:
        return b""
    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}I", buf, 16)
    if flags & FLAG_NOSPLIT:
        do_split = False
    else:  # pre-1.14 chunk: apply the FORWARD_COMPAT implicit rule
        do_split = _split_block(compcode, typesize, blocksize)
    out = bytearray()
    for j in range(nblocks):
        bsize = min(blocksize, nbytes - j * blocksize)
        leftover = bsize != blocksize
        nstreams = typesize if (do_split and not leftover) else 1
        neblock = bsize // nstreams
        pos = bstarts[j]
        tmp = bytearray()
        for _ in range(nstreams):
            (csize,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            if csize < 0:
                raise ValueError("corrupt blosc chunk: negative stream size")
            if csize == neblock:  # stored raw
                tmp += buf[pos : pos + neblock]
            elif compcode == COMP_LZ4:
                tmp += lz4_decompress(buf[pos : pos + csize], neblock)
            else:
                tmp += zlib.decompress(buf[pos : pos + csize])
            pos += csize
        if flags & FLAG_SHUFFLE and typesize > 1:
            tmp = bytearray(_unshuffle(typesize, bytes(tmp)))
        out += tmp
    if len(out) != nbytes:
        raise ValueError(f"blosc chunk decoded {len(out)} B, expected {nbytes}")
    return bytes(out)


def compress(
    data: bytes,
    typesize: int = 4,
    shuffle: bool = True,
    split: bool | None = None,
    blocksize: int = 65536,
) -> bytes:
    """Encode bytes as one Blosc1/LZ4 chunk (decodable by stock c-blosc).

    Falls back to a memcpy chunk when compression does not pay. ``split``
    None follows the same rule as stock encoders; the bit-4 header flag
    records the decision either way so any 1.14+ decoder agrees.
    """
    data = bytes(data)
    nbytes = len(data)
    if not 1 <= typesize <= 255:
        typesize = 1
    blocksize = max(typesize, min(nbytes or 1, blocksize))
    blocksize -= blocksize % typesize or 0
    do_shuffle = shuffle and typesize > 1
    do_split = _split_block(COMP_LZ4, typesize, blocksize) if split is None else (
        split and _split_block(COMP_LZ4, typesize, blocksize)
    )
    flags = COMP_LZ4 << 5
    if do_shuffle:
        flags |= FLAG_SHUFFLE
    if not do_split:
        flags |= FLAG_NOSPLIT

    nblocks = -(-nbytes // blocksize) if nbytes else 0
    header = bytearray(16)
    body = bytearray()
    bstarts = []
    base = 16 + 4 * nblocks
    for j in range(nblocks):
        bsize = min(blocksize, nbytes - j * blocksize)
        block = data[j * blocksize : j * blocksize + bsize]
        if do_shuffle:
            block = _shuffle(typesize, block)
        leftover = bsize != blocksize
        nstreams = typesize if (do_split and not leftover) else 1
        neblock = bsize // nstreams
        bstarts.append(base + len(body))
        for k in range(nstreams):
            part = block[k * neblock : (k + 1) * neblock]
            comp = lz4_compress(part)
            if len(comp) >= neblock:  # incompressible stream: store raw
                body += struct.pack("<i", neblock)
                body += part
            else:
                body += struct.pack("<i", len(comp))
                body += comp
    cbytes = base + len(body)
    if cbytes >= nbytes + 16:  # compression lost: emit a memcpy chunk
        header[0], header[1] = _VERSION, _VERSION_LZ4
        header[2], header[3] = FLAG_MEMCPY | (COMP_LZ4 << 5), typesize
        struct.pack_into("<III", header, 4, nbytes, blocksize, nbytes + 16)
        return bytes(header) + data
    header[0], header[1] = _VERSION, _VERSION_LZ4
    header[2], header[3] = flags, typesize
    struct.pack_into("<III", header, 4, nbytes, blocksize, cbytes)
    return bytes(header) + struct.pack(f"<{nblocks}I", *bstarts) + bytes(body)
