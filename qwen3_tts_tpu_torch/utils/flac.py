"""Pure-Python/numpy FLAC decode and a minimal encoder (the port's copy of
`qwen3_tts_tpu/utils/flac.py`, native fast path included).

The reference accepts any ref-audio format librosa/soundfile reads
(qwen_tts/inference/qwen3_tts_model.py:188-264). Neither librosa nor
soundfile (nor any libsndfile) is a dependency, so lossless inputs are
handled natively: this module implements the FLAC bitstream per the format
spec (RFC 9639) — constant / verbatim / fixed / LPC subframes, Rice/Rice2
residual partitions, left-side / right-side / mid-side stereo decorrelation,
and wasted bits.

Decoding is numpy-vectorized where the format allows (batched remainder-bit
gathers per Rice partition; `np.searchsorted` over one-bit positions for the
unary quotients), so a few seconds of reference audio decodes in well under a
second without native code. The strictly sequential loops (Rice symbols,
predictor reconstruction, fixed-width reads) additionally have a native C
fast path (native/flac_fast.c, built on first use by utils/native.py into
build/native/); the Python implementations remain the always-available
fallback and the parity oracle (`QWEN3_TTS_NO_NATIVE=1` forces them). Both
give the same samples. This is host code: no device runs it.

The encoder (`write_flac`) emits verbatim or fixed-order-1 Rice frames; it
exists so tests and smoke runs can round-trip the decoder without shipping
binary fixtures.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_CRC8_TABLE = None
_CRC16_TABLE = None


def _crc8(data: bytes) -> int:
    global _CRC8_TABLE
    if _CRC8_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if (c & 0x80) else (c << 1) & 0xFF
            tbl.append(c)
        _CRC8_TABLE = tbl
    c = 0
    for b in data:
        c = _CRC8_TABLE[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        tbl = []
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if (c & 0x8000) else (c << 1) & 0xFFFF
            tbl.append(c)
        _CRC16_TABLE = tbl
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16_TABLE[((c >> 8) ^ b) & 0xFF]
    return c


def _native_lib():
    """The C hot-loop library, or None (env QWEN3_TTS_NO_NATIVE=1 forces
    the pure-Python path)."""
    import os

    if os.environ.get("QWEN3_TTS_NO_NATIVE") == "1":
        return None
    from .native import flac_fast

    return flac_fast()


class _BitReader:
    """Bit reader over a numpy uint8 bit array (MSB-first)."""

    def __init__(self, data: bytes):
        self.raw = np.frombuffer(data, np.uint8)
        self.bits = np.unpackbits(self.raw)
        self.ones = np.flatnonzero(self.bits)  # for O(log n) unary scans
        self.pos = 0
        self.lib = _native_lib()

    def _c_call(self, fn, n: int, arg: int) -> Optional[np.ndarray]:
        """Run a native (buf, nbits, &bitpos, n, arg, out) -> rc loop."""
        import ctypes

        out = np.empty(n, np.int64)
        bitpos = ctypes.c_size_t(self.pos)
        rc = fn(self.raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(self.bits), ctypes.byref(bitpos), n, arg,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise ValueError("FLAC: ran off bitstream (native)")
        self.pos = bitpos.value
        return out

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        b = self.bits[self.pos:self.pos + n]
        if b.shape[0] < n:
            # truncated file: fail loudly instead of decoding short reads
            # as zero bits (corrupt audio with no error)
            raise ValueError("FLAC: ran off bitstream (truncated file?)")
        self.pos += n
        out = 0
        for bit in b.tolist():
            out = (out << 1) | int(bit)
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        idx = np.searchsorted(self.ones, self.pos)
        if idx >= len(self.ones):
            raise ValueError("FLAC: ran off bitstream in unary code")
        stop = int(self.ones[idx])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's extended UTF-8 coded frame/sample number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    if n < 2 or n > 7:
        raise ValueError("FLAC: invalid UTF-8 coded number")
    val = b0 & (0xFF >> (n + 1))
    for _ in range(n - 1):
        c = br.read(8)
        if (c & 0xC0) != 0x80:
            raise ValueError("FLAC: invalid UTF-8 continuation")
        val = (val << 6) | (c & 0x3F)
    return val


def _decode_rice_partition(br: _BitReader, n: int, k: int) -> np.ndarray:
    """Decode n Rice(k)-coded residuals.

    Quotients are inherently sequential (each start depends on the previous
    stop), but the scan over one-bit positions makes each step O(log m); the
    k remainder bits of all n samples are then gathered in one strided numpy
    take and combined vectorized.
    """
    if n <= 0:
        return np.zeros(0, np.int64)
    if br.lib is not None:
        return br._c_call(br.lib.flac_rice_decode, n, k)
    ones, bits = br.ones, br.bits
    start0 = br.pos
    stops = np.empty(n, np.int64)
    pos = start0
    idx = int(np.searchsorted(ones, pos))
    for i in range(n):
        while idx < len(ones) and ones[idx] < pos:
            idx += 1
        if idx >= len(ones):
            raise ValueError("FLAC: ran off bitstream in residual")
        stop = int(ones[idx])
        stops[i] = stop
        pos = stop + 1 + k
        idx += 1
        if k:
            idx = int(np.searchsorted(ones, pos))
    br.pos = pos

    starts = np.empty(n, np.int64)
    starts[0] = start0
    starts[1:] = stops[:-1] + 1 + k
    q = stops - starts
    if k:
        offs = (stops[:, None] + 1 + np.arange(k)[None, :]).reshape(-1)
        rem = bits[offs].reshape(n, k).astype(np.int64) @ \
            (1 << np.arange(k - 1, -1, -1)).astype(np.int64)
    else:
        rem = np.zeros(n, np.int64)
    u = (q << k) | rem
    return (u >> 1) ^ -(u & 1)  # zigzag -> signed


def _read_signed_array(br: _BitReader, n: int, bits: int) -> np.ndarray:
    """n fixed-width signed values (verbatim / escaped partitions)."""
    if n <= 0 or bits == 0:
        return np.zeros(n, np.int64)
    if br.lib is not None:
        return br._c_call(br.lib.flac_read_signed, n, bits)
    out = np.empty(n, np.int64)
    for i in range(n):
        out[i] = br.read_signed(bits)
    return out


def _predictor_restore(br: _BitReader, warm: np.ndarray, resid: np.ndarray,
                       coeffs, shift: int, block_size: int) -> np.ndarray:
    """Reconstruct samples from warm-up + residual under an order-N
    predictor (shared by FIXED and LPC subframes)."""
    order = len(warm)
    out = np.empty(block_size, np.int64)
    out[:order] = warm
    if order == 0:
        out[:] = resid
        return out
    if br.lib is not None:
        import ctypes

        out[order:] = resid
        c = np.asarray(coeffs, np.int32)
        br.lib.flac_lpc_restore(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), block_size,
            order, c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), shift)
        return out
    c = np.asarray(coeffs, np.int64)
    for i in range(order, block_size):
        pred = int(np.dot(c, out[i - order:i][::-1]))
        out[i] = (pred >> shift) + resid[i - order]
    return out


def _read_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"FLAC: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    nparts = 1 << part_order
    if block_size % nparts:
        raise ValueError("FLAC: bad partition order")
    out: List[np.ndarray] = []
    for p in range(nparts):
        n = (block_size >> part_order) - (order if p == 0 else 0)
        k = br.read(plen)
        if k == escape:
            nbits = br.read(5)
            out.append(_read_signed_array(br, n, nbits))
        else:
            out.append(_decode_rice_partition(br, n, k))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("FLAC: subframe sync error (padding bit set)")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if stype == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif stype == 1:  # VERBATIM
        out = _read_signed_array(br, block_size, bps)
    elif 8 <= stype <= 12:  # FIXED, order 0..4
        order = stype - 8
        warm = _read_signed_array(br, order, bps)
        resid = _read_residual(br, block_size, order)
        out = _predictor_restore(br, warm, resid, FIXED_COEFFS[order],
                                 0, block_size)
    elif stype >= 32:  # LPC, order 1..32
        order = stype - 31
        warm = _read_signed_array(br, order, bps)
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("FLAC: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("FLAC: negative LPC shift")
        coeffs = [br.read_signed(precision) for _ in range(order)]
        resid = _read_residual(br, block_size, order)
        out = _predictor_restore(br, warm, resid, coeffs, shift, block_size)
    else:
        raise ValueError(f"FLAC: reserved subframe type {stype}")

    if wasted:
        out = out << wasted
    return out


_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def read_flac(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 array (T,) or (T, C) in [-1, 1], sr)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")

    # ---- metadata blocks ----
    pos = 4
    streaminfo = None
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        blen = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:
            streaminfo = body
        pos += 4 + blen
        if last:
            break
    if streaminfo is None:
        raise ValueError("FLAC: missing STREAMINFO")
    si = int.from_bytes(streaminfo[10:18], "big")
    sr = (si >> 44) & 0xFFFFF
    channels = ((si >> 41) & 0x7) + 1
    bps_def = ((si >> 36) & 0x1F) + 1
    total = si & ((1 << 36) - 1)

    br = _BitReader(data[pos:])
    chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
    got = 0
    while (total == 0 or got < total) and br.byte_pos() + 2 <= len(data) - pos:
        # ---- frame header ----
        sync = br.read(14)
        if sync != 0x3FFE:
            if total == 0:
                break
            raise ValueError(f"FLAC: lost frame sync (got {sync:#x})")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_code == 0:
            raise ValueError("FLAC: reserved block size code")
        elif bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        br.read(8)  # header CRC-8 (not verified — decode-side tolerance)

        if ss_code != 0 and ss_code not in _SAMPLE_SIZES:
            raise ValueError(f"FLAC: reserved sample-size code {ss_code}")
        bps = bps_def if ss_code == 0 else _SAMPLE_SIZES[ss_code]

        # ---- subframes ----
        if ch_code < 8:
            nch = ch_code + 1
            sub = [_decode_subframe(br, block_size, bps) for _ in range(nch)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            sub = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, bps + 1)
            right = _decode_subframe(br, block_size, bps)
            sub = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            m2 = (mid << 1) | (side & 1)
            sub = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"FLAC: reserved channel assignment {ch_code}")

        br.align()
        br.read(16)  # frame CRC-16 (not verified)

        for c in range(channels):
            chans[c].append(sub[c])
        got += block_size

    arrs = [np.concatenate(c) if c else np.zeros(0, np.int64) for c in chans]
    n = min(a.shape[0] for a in arrs)
    if total:
        n = min(n, int(total))
    x = np.stack([a[:n] for a in arrs], axis=-1).astype(np.float32)
    x /= float(1 << (bps_def - 1))
    if channels == 1:
        x = x[:, 0]
    return x, int(sr)


# ---------------------------------------------------------------------------
# Minimal encoder (verbatim / fixed-1+Rice) — for decoder round-trip tests
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        self.bits.extend([0] * q)
        self.bits.append(1)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self) -> bytes:
        self.align()
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    first = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(first | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def write_flac(path: str, audio: np.ndarray, sr: int, bps: int = 16,
               block_size: int = 4096, mode: str = "fixed1") -> None:
    """Encode float [-1, 1] audio (T,) or (T, C) as FLAC.

    mode='verbatim' stores raw samples; mode='fixed1' uses a first-order
    fixed predictor with a single Rice partition (still lossless, ~40-60%
    smaller on speech).  Exists mainly to test `read_flac`.
    """
    x = np.asarray(audio, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    T, C = x.shape
    q = np.clip(np.round(x * (1 << (bps - 1))), -(1 << (bps - 1)),
                (1 << (bps - 1)) - 1).astype(np.int64)

    out = [b"fLaC"]
    si = bytearray(34)
    struct.pack_into(">HH", si, 0, block_size, block_size)
    # min/max frame size left 0 (unknown)
    packed = (sr << 44) | ((C - 1) << 41) | ((bps - 1) << 36) | T
    si[10:18] = packed.to_bytes(8, "big")
    out.append(bytes([0x80]) + len(si).to_bytes(3, "big") + bytes(si))

    frames = []
    for f0 in range(0, T, block_size):
        blk = q[f0:f0 + block_size]
        n = blk.shape[0]
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)      # fixed blocksize strategy
        hdr.write(7, 4)      # block size: 16-bit at end
        hdr.write(0, 4)      # sample rate: from STREAMINFO
        hdr.write(C - 1, 4)  # independent channels
        ss = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        hdr.write(ss, 3)
        hdr.write(0, 1)
        hdr_bytes = hdr.tobytes() + _utf8_number(f0 // block_size)
        hdr_bytes += struct.pack(">H", n - 1)
        hdr_bytes += bytes([_crc8(hdr_bytes)])

        body = _BitWriter()
        for c in range(C):
            ch = blk[:, c]
            body.write(0, 1)
            if mode == "verbatim" or n < 2:
                body.write(1, 6)   # VERBATIM
                body.write(0, 1)   # no wasted bits
                for v in ch.tolist():
                    body.write_signed(int(v), bps)
            else:
                body.write(9, 6)   # FIXED order 1
                body.write(0, 1)
                body.write_signed(int(ch[0]), bps)  # warmup
                resid = ch[1:] - ch[:-1]
                u = (np.abs(resid) << 1) - (resid < 0)
                mean = max(1, int(u.mean()) if len(u) else 1)
                k = min(14, max(0, int(mean).bit_length() - 1))
                body.write(0, 2)   # rice method 0
                body.write(0, 4)   # partition order 0
                body.write(k, 4)
                for r in resid.tolist():
                    uu = (int(r) << 1) ^ (int(r) >> 63)
                    body.write_unary(uu >> k)
                    if k:
                        body.write(uu & ((1 << k) - 1), k)
        frame = hdr_bytes + body.tobytes()
        frame += struct.pack(">H", _crc16(frame))
        frames.append(frame)

    with open(path, "wb") as f:
        f.write(b"".join(out) + b"".join(frames))
