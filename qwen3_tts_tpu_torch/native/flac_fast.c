/* Native hot loops for the FLAC decoder (utils/flac.py).
 *
 * The bitstream layers of FLAC (Rice residual decoding and the
 * fixed/LPC predictor reconstruction) are inherently sequential per
 * sample, which makes them the only parts of this framework's audio
 * front end that cannot be vectorized with numpy.  This translation
 * unit implements exactly those two loops; framing, metadata, stereo
 * decorrelation and everything else stays in Python/numpy.
 *
 * Compiled on first use by utils/native.py (cc -O2 -shared -fPIC, into
 * build/native/) and
 * called through ctypes; the Python implementation remains as the
 * always-available fallback and as the parity oracle in tests.
 */

#include <stdint.h>
#include <stddef.h>

/* Read `n` Rice(k)-coded residuals starting at *bitpos (MSB-first bit
 * offset into buf).  Writes zigzag-decoded signed values to out and
 * advances *bitpos.  Returns 0 on success, -1 on buffer overrun. */
int flac_rice_decode(const uint8_t *buf, size_t nbits, size_t *bitpos,
                     int64_t n, int32_t k, int64_t *out) {
    size_t pos = *bitpos;
    for (int64_t i = 0; i < n; i++) {
        /* unary quotient: count zeros to the next set bit */
        uint64_t q = 0;
        for (;;) {
            if (pos >= nbits) return -1;
            /* fast-skip whole zero bytes when aligned */
            if ((pos & 7) == 0) {
                while (pos + 8 <= nbits && buf[pos >> 3] == 0) {
                    pos += 8;
                    q += 8;
                }
                /* the skip can land exactly on nbits: re-check before the
                 * byte read below (one past the buffer otherwise) */
                if (pos >= nbits) return -1;
            }
            uint8_t byte = buf[pos >> 3];
            if (byte & (0x80u >> (pos & 7))) {
                pos++;
                break;
            }
            pos++;
            q++;
        }
        /* k remainder bits */
        uint64_t rem = 0;
        if (k > 0) {
            if (pos + (size_t)k > nbits) return -1;
            for (int32_t b = 0; b < k; b++) {
                rem = (rem << 1) |
                      ((buf[pos >> 3] >> (7 - (pos & 7))) & 1u);
                pos++;
            }
        }
        uint64_t u = (q << k) | rem;
        out[i] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1); /* zigzag */
    }
    *bitpos = pos;
    return 0;
}

/* In-place predictor reconstruction: out[0:order] are warm-up samples,
 * out[order:n] hold residuals on entry and samples on exit.
 *   sample[i] = residual[i] + (sum_j coeffs[j] * sample[i-1-j]) >> shift
 * Covers both FIXED (shift 0, small integer coeffs) and LPC subframes. */
void flac_lpc_restore(int64_t *out, int64_t n, int32_t order,
                      const int32_t *coeffs, int32_t shift) {
    for (int64_t i = order; i < n; i++) {
        int64_t pred = 0;
        for (int32_t j = 0; j < order; j++) {
            pred += (int64_t)coeffs[j] * out[i - 1 - j];
        }
        out[i] += pred >> shift;
    }
}

/* Read n fixed-width signed values of `bits` bits each (verbatim
 * subframes and escaped residual partitions). */
int flac_read_signed(const uint8_t *buf, size_t nbits, size_t *bitpos,
                     int64_t n, int32_t bits, int64_t *out) {
    size_t pos = *bitpos;
    if (bits <= 0) {
        for (int64_t i = 0; i < n; i++) out[i] = 0;
        return 0;
    }
    if (pos + (size_t)n * (size_t)bits > nbits) return -1;
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = 0;
        for (int32_t b = 0; b < bits; b++) {
            v = (v << 1) | ((buf[pos >> 3] >> (7 - (pos & 7))) & 1u);
            pos++;
        }
        if (v >= (1ull << (bits - 1)))
            out[i] = (int64_t)v - (1ll << bits);
        else
            out[i] = (int64_t)v;
    }
    *bitpos = pos;
    return 0;
}
