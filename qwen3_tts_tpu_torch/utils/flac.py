"""Pure-Python/numpy FLAC decode (the port's copy of
`qwen3_tts_tpu/utils/flac.py`, decoder only).

The reference accepts any ref-audio format librosa/soundfile reads
(qwen_tts/inference/qwen3_tts_model.py:188-264).  Neither librosa nor
soundfile (nor any libsndfile) is a dependency, so lossless inputs are
handled natively: this module implements the FLAC bitstream per the format
spec (RFC 9639) — constant / verbatim / fixed / LPC subframes, Rice/Rice2
residual partitions, left-side / right-side / mid-side stereo decorrelation,
and wasted bits.

Decoding is numpy-vectorized where the format allows (batched remainder-bit
gathers per Rice partition; `np.searchsorted` over one-bit positions for the
unary quotients), so a few seconds of reference audio decodes in well under a
second. The JAX package's optional C fast path for the sequential loops is
not carried over: this is the pure-Python path, which the JAX package keeps
as its parity oracle.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class _BitReader:
    """Bit reader over a numpy uint8 bit array (MSB-first)."""

    def __init__(self, data: bytes):
        self.raw = np.frombuffer(data, np.uint8)
        self.bits = np.unpackbits(self.raw)
        self.ones = np.flatnonzero(self.bits)  # for O(log n) unary scans
        self.pos = 0

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
    out = np.empty(n, np.int64)
    for i in range(n):
        out[i] = br.read_signed(bits)
    return out


def _predictor_restore(warm: np.ndarray, resid: np.ndarray,
                       coeffs, shift: int, block_size: int) -> np.ndarray:
    """Reconstruct samples from warm-up + residual under an order-N
    predictor (shared by FIXED and LPC subframes)."""
    order = len(warm)
    out = np.empty(block_size, np.int64)
    out[:order] = warm
    if order == 0:
        out[:] = resid
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
        out = _predictor_restore(warm, resid, FIXED_COEFFS[order],
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
        out = _predictor_restore(warm, resid, coeffs, shift, block_size)
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

