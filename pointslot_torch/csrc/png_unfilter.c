/* PNG row unfiltering (PNG specification, section 9) on the host.
 *
 * png_unfilter reverses the five per-row filter types (None, Sub, Up,
 * Average, Paeth) of a non-interlaced image whose samples are 8 or 16
 * bits, after zlib has inflated the IDAT stream. Built by
 * pointslot_torch/kernels.py with the host C compiler into a shared
 * library and called through ctypes from datasets/png16.py; the numpy
 * version there (unfilter_plain) is its oracle.
 *
 *   raw     height rows of (1 + stride) bytes: the filter type, then the
 *           filtered bytes
 *   out     height x stride bytes, the unfiltered image
 *   bpp     bytes per complete pixel (1-8)
 *
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * 0-4 (its rows from there on are left unwritten).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* p = a + b - c; the nearest of a, b, c to p, ties in that order; written
 * with the differences p - a = b - c and p - b = a - c so that the compiler
 * can select without branches */
static inline uint8_t paeth(int a, int b, int c) {
    const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    const int ab = pb < pa ? b : a;
    const int pab = pb < pa ? pb : pa;
    return (uint8_t)(pc < pab ? c : ab);
}

int png_unfilter(const uint8_t *raw, uint8_t *out, int64_t height, int64_t stride, int bpp) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t *in = raw + r * (stride + 1);
        uint8_t *cur = out + r * stride;
        const uint8_t *prev = r > 0 ? out + (r - 1) * stride : NULL;
        const uint8_t ft = in[0];
        ++in;
        int64_t i;
        switch (ft) {
        case 0:
            memcpy(cur, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
            for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            break;
        case 2:
            if (prev == NULL) {
                memcpy(cur, in, (size_t)stride);
            } else {
                for (i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
            }
            break;
        case 3:
            if (prev == NULL) {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
                for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + (cur[i - bpp] >> 1));
            } else {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = (uint8_t)(in[i] + (prev[i] >> 1));
                for (; i < stride; ++i)
                    cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
            }
            break;
        case 4:
            if (prev == NULL) {
                /* up and up-left are 0: the predictor is the left byte */
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = in[i];
                for (; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            } else {
                for (i = 0; i < bpp && i < stride; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
                for (; i < stride; ++i)
                    cur[i] = (uint8_t)(in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
            }
            break;
        default:
            return (int)(r + 1);
        }
    }
    return 0;
}
