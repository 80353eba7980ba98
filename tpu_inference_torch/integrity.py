"""Payload integrity primitives shared by the engine and the fleet.

Twin of ``tpu_inference/integrity.py``: CRC-32C (Castagnoli), the
checksum of the RPC frame codec (``server/transport.py``) and of the KV
wire format (``engine/kv_cache.py``), and ``KVIntegrityError``.

The reference uses the ``google_crc32c`` C extension when it can import
it and otherwise walks a table one byte at a time in Python (~5.7 MB/s).
A drain export of a Llama-3-8B sequence is ~131 KB per token, so a
1000-token export (131 MB) would take ~23 s per checksum pass at that
rate, and a migrated blob is checksummed seven times on its way from
one worker to another (serialize, frame encode and decode twice, the
router's gate, import). The port keeps the extension when present and
otherwise runs ``_crc32c_fast``: on a machine with a card, buffers of
1 MiB and more go to ``_crc32c_blocks`` (torch on the card: one table
gather per byte gives each 64-byte block's register), the rest to
``_crc32c_np`` (numpy: up to 32768 chunks advance in lockstep, 8 bytes
per step, two bytes per table lookup). Both fold their partial CRCs
pairwise with the CRC-32C combine (GF(2) shift operators applied
through byte tables), and every path gives the reference's bits
(tests/test_torch_transport.py; chip_smoke.py on the card).
"""

from __future__ import annotations

import functools
import threading

import numpy as np

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected


def _build_table() -> tuple:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_TABLE = _build_table()
_TABLE_NP = np.asarray(_TABLE, dtype=np.uint32)


def _walk(data, reg: int) -> int:
    """The raw register after ``data`` (no pre/post conditioning)."""
    table = _TABLE
    for b in data:
        reg = (reg >> 8) ^ table[(reg ^ b) & 0xFF]
    return reg


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``; pass a previous result as ``crc`` to chain
    incremental updates over multiple buffers."""
    return _walk(data, crc ^ 0xFFFFFFFF) ^ 0xFFFFFFFF


# --- GF(2) shift operators: a 32x32 bit matrix as 32 column ints (the
# image of each register bit), zlib's crc32_combine representation.


def _gf2_times(mat, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat) -> list:
    return [_gf2_times(mat, mat[i]) for i in range(32)]


@functools.lru_cache(maxsize=256)
def _zeros_operator(n_bytes: int) -> tuple:
    """The operator advancing the raw register over ``n_bytes`` zero
    bytes."""
    odd = [_POLY] + [1 << i for i in range(31)]      # one zero bit
    even = _gf2_square(odd)                          # two
    odd = _gf2_square(even)                          # four
    op = _gf2_square(odd)                            # one byte
    result = None
    while n_bytes:
        if n_bytes & 1:
            result = (op if result is None
                      else [_gf2_times(op, c) for c in result])
        n_bytes >>= 1
        if n_bytes:
            op = _gf2_square(op)
    return tuple(result if result is not None
                 else [1 << i for i in range(32)])


def _byte_tables(mat) -> np.ndarray:
    """[4, 256] tables: the operator applied to each byte of a register,
    so applying it to a vector of registers is four lookups and three
    xors."""
    b = np.arange(256, dtype=np.uint32)
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for i in range(8):
            out[k] ^= np.where((b >> i) & 1, np.uint32(mat[8 * k + i]),
                               np.uint32(0)).astype(np.uint32)
    return out


def _slice16_tables() -> np.ndarray:
    """[4, 65536] tables for 8 bytes per step: entry v of row k advances
    the register over the two bytes of v (bytes 2k and 2k+1 of the
    step) and the 6 - 2k bytes after them (slicing-by-8, two bytes per
    lookup)."""
    t = np.zeros((8, 256), np.uint32)
    t[0] = _TABLE_NP
    for k in range(1, 8):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    v = np.arange(1 << 16, dtype=np.uint32)
    return np.stack([t[7 - 2 * k][v & 0xFF] ^ t[6 - 2 * k][v >> 8]
                     for k in range(4)])


_T16 = _slice16_tables()
# Below this many bytes the table walk is as fast as the setup; from
# _CARD_MIN_BYTES on, a machine with a card checksums on it.
_NP_MIN_BYTES = 4096
_CARD_MIN_BYTES = 1 << 20
_MAX_CHUNKS = 1 << 15
_COLS = 128                     # u32 words transposed per copy


def _crc32c_np(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (any bytes-like object), bit-identical to
    :func:`_crc32c_py`, at numpy speed: up to 32768 chunks advance in
    lockstep, 8 bytes per step, then fold."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < _NP_MIN_BYTES:
        return _crc32c_py(buf.tobytes(), crc)
    n_chunks = 1 << min(_MAX_CHUNKS.bit_length() - 1,
                        (n // 512).bit_length() - 1)
    length = (n // n_chunks) & ~7
    main = n_chunks * length
    words = buf[:main].view("<u4").reshape(n_chunks, length // 4)
    regs = np.zeros(n_chunks, np.uint32)
    # The caller's register enters with chunk 0; the others start at 0.
    regs[0] = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    ta, tb, tc, td = _T16
    for at in range(0, length // 4, _COLS):
        cols = np.ascontiguousarray(words[:, at:at + _COLS].T)
        for lo, hi in zip(cols[0::2], cols[1::2]):
            x = (regs ^ lo).view("<u2")
            h = hi.view("<u2")
            regs = ta[x[0::2]] ^ tb[x[1::2]] ^ tc[h[0::2]] ^ td[h[1::2]]
    # Fold neighbours: reg(A || B) = shift_|B|(reg(A)) ^ reg(B), with
    # |B| doubling each level.
    op = _zeros_operator(length)
    while regs.size > 1:
        t = _byte_tables(op)
        r = regs[0::2]
        regs = (t[0][r & 0xFF] ^ t[1][(r >> 8) & 0xFF]
                ^ t[2][(r >> 16) & 0xFF] ^ t[3][r >> 24]) ^ regs[1::2]
        op = _gf2_square(op)
    out = int(regs[0]) ^ 0xFFFFFFFF
    return _crc32c_np(buf[main:], out) if main < n else out


# On the card: a 64-byte block's register is the xor of one table entry
# per byte (row p of _T64: each byte value's contribution at position p,
# the byte followed by 63 - p zero bytes).
_BLOCK = 64


def _block_table() -> np.ndarray:
    rows = np.zeros((_BLOCK, 256), np.uint32)
    rows[-1] = _TABLE_NP
    for p in range(_BLOCK - 2, -1, -1):
        x = rows[p + 1]
        rows[p] = (x >> 8) ^ _TABLE_NP[x & 0xFF]
    return rows.reshape(-1).view(np.int32)


_T64 = _block_table()
_SLAB_BLOCKS = 1 << 18          # 16 MiB per gather
# Per device: the block table, the position offsets, and the fold's
# byte tables level by level (level k shifts over 64 * 2**k bytes); they
# depend on nothing but the polynomial, so each is built once.
_CONSTS: dict = {}
_CONSTS_LOCK = threading.Lock()


def _device_consts(dev) -> dict:
    import torch

    with _CONSTS_LOCK:
        c = _CONSTS.get(str(dev))
        if c is None:
            c = _CONSTS[str(dev)] = {
                "table": torch.from_numpy(_T64).to(dev),
                "offsets": torch.arange(_BLOCK, dtype=torch.int32,
                                        device=dev) * 256,
                "ops": [], "levels": []}
        return c


def _level_tables(c: dict, k: int, dev):
    import torch

    with _CONSTS_LOCK:
        ops, levels = c["ops"], c["levels"]
        while len(levels) <= k:
            op = (_zeros_operator(_BLOCK) if not ops
                  else _gf2_square(ops[-1]))
            ops.append(op)
            levels.append(torch.from_numpy(
                _byte_tables(op).astype(np.int64)).to(dev))
        return levels[k]


def _crc32c_blocks(data, crc: int = 0, device="cuda") -> int:
    """CRC-32C of ``data`` (any bytes-like object) on ``device`` with
    torch, bit-identical to :func:`_crc32c_py`: every 64-byte block's
    register from one table gather per byte, then the block registers
    folded pairwise with the shift operators. Zero bytes in front leave
    a zero register zero, so the first block is padded in front, and the
    caller's register is shifted over the whole buffer at the end."""
    import warnings

    import torch

    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < _BLOCK:
        return _crc32c_py(buf.tobytes(), crc)
    dev = torch.device(device)
    c = _device_consts(dev)
    pad = (-n) % _BLOCK
    first = np.concatenate([np.zeros(pad, np.uint8), buf[:_BLOCK - pad]])
    rest = buf[_BLOCK - pad:].reshape(-1, _BLOCK)
    regs = torch.empty(1 + rest.shape[0], dtype=torch.int32, device=dev)
    with warnings.catch_warnings():
        # Read-only views of the caller's bytes; nothing writes them.
        warnings.simplefilter("ignore", UserWarning)
        parts = [(0, first[None])] + [
            (1 + at, rest[at:at + _SLAB_BLOCKS])
            for at in range(0, len(rest), _SLAB_BLOCKS)]
        for at, blocks in parts:
            g = c["table"][torch.from_numpy(blocks).to(dev).int()
                           + c["offsets"]]
            while g.shape[1] > 1:
                half = g.shape[1] // 2
                g = g[:, :half] ^ g[:, half:]
            regs[at:at + len(blocks)] = g[:, 0]
    regs = regs.long() & 0xFFFFFFFF
    level = 0
    while regs.numel() > 1:
        if regs.numel() & 1:            # a zero block in front
            regs = torch.cat([regs.new_zeros(1), regs])
        t = _level_tables(c, level, dev)
        r = regs[0::2]
        regs = (t[0][r & 0xFF] ^ t[1][(r >> 8) & 0xFF]
                ^ t[2][(r >> 16) & 0xFF] ^ t[3][r >> 24]) ^ regs[1::2]
        level += 1
    reg = int(regs[0]) ^ _gf2_times(_zeros_operator(n),
                                    (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF)
    return reg ^ 0xFFFFFFFF


def _crc32c_fast(data, crc: int = 0) -> int:
    """CRC-32C without the C extension: on the card for a buffer of
    1 MiB or more when this process has one, else numpy."""
    n = memoryview(data).nbytes
    if n >= _CARD_MIN_BYTES:
        import torch
        if torch.cuda.is_available():
            return _crc32c_blocks(data, crc, "cuda")
    return _crc32c_np(data, crc)


try:
    from google_crc32c import extend as _crc32c_ext

    def crc32c(data: bytes, crc: int = 0) -> int:
        """CRC-32C of ``data``; pass a previous result as ``crc`` to
        chain incremental updates (the C extension; bit-identical to
        the table walk)."""
        return _crc32c_ext(crc, data)
except ImportError:
    crc32c = _crc32c_fast


class KVIntegrityError(ValueError):
    """A serialized KV blob failed its embedded digest (or is otherwise
    structurally unsound in a way only corruption explains). Raised by
    ``kv_cache.deserialize_host_pages``; every import path catches it,
    rejects the blob, counts the rejection and falls back to recompute:
    a corrupt page is never adopted."""
