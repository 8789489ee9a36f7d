/* COCO mask-RLE decoder with a plain C interface (counterpart of
 * maskrcnn_tf2_tpu/native/rle_ext.c), loaded by native/rle.py with ctypes.
 *
 * The public COCO RLE spec: column-major runs that alternate 0-runs and
 * 1-runs, starting with a 0-run. A compressed counts string is a sequence of
 * base-48 6-bit varints, bit 5 the continuation bit and bit 4 of a count's
 * last group its sign; a count whose index is above 2 is a delta against
 * counts[i - 2].
 *
 * No Python.h: the library needs only a C compiler, and ctypes releases the
 * interpreter lock while a call runs, so the loader's threads decode in
 * parallel.
 */
#include <stdint.h>
#include <string.h>

/* Decode the n characters of s into out, which has room for n counts (each
 * count takes at least one character). Returns the number of counts, or -1
 * when s ends inside a count. */
int64_t decode_counts(const char *s, int64_t n, int64_t *out)
{
    int64_t cnt = 0, i = 0;
    while (i < n) {
        int64_t x = 0;
        int k = 0, more = 1;
        while (more) {
            if (i >= n)
                return -1;
            int64_t c = (int64_t)(unsigned char)s[i++] - 48;
            if (5 * k < 64)
                x |= (int64_t)((uint64_t)(c & 0x1F) << (5 * k));
            more = (int)(c & 0x20);
            k++;
            if (!more && (c & 0x10) && 5 * k < 64)
                x |= (int64_t)(UINT64_MAX << (5 * k));
        }
        if (cnt > 2)
            x += out[cnt - 2];
        out[cnt++] = x;
    }
    return cnt;
}

/* Fill the h*w column-major bytes of out from m run lengths: 1 inside the
 * 1-runs, else 0. A negative run counts as 0; runs past h*w are cut there,
 * and runs that end short of it leave zeros after them. */
void decode_mask(const int64_t *counts, int64_t m, int64_t h, int64_t w, uint8_t *out)
{
    int64_t total = h * w, pos = 0;
    memset(out, 0, (size_t)total);
    for (int64_t j = 0; j < m && pos < total; j++) {
        int64_t run = counts[j] < 0 ? 0 : counts[j];
        int64_t end = run > total - pos ? total : pos + run;
        if (j & 1)
            memset(out + pos, 1, (size_t)(end - pos));
        pos = end;
    }
}
