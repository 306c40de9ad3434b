/* Native data-generation kernels for the sort-merge-join engine.
 *
 * The reference generates workloads with glibc rand() driven Knuth shuffles
 * (reference: src/datagen/generator.c) — inherently sequential, and far too
 * slow in Python for the 1.6B-tuple scale configs.  This module implements
 * the identical bit-exact algorithms in C; Python owns the RNG state (the
 * 31-word lagged-Fibonacci history) and passes it in, so the NumPy and
 * native paths are interchangeable mid-stream.
 *
 * Build: cc -O3 -shared -fPIC datagen.c -o libsmjdatagen.so
 */

#include <stdint.h>
#include <stddef.h>

#define LAG_SHORT 3
#define LAG_LONG 31
#define GLIBC_RAND_MAX 2147483647

/* Advance the lagged-Fibonacci state one step; hist is a ring of 31 words,
 * *pos is the index of the oldest word (r[i-31]). */
static inline uint32_t next_word(uint32_t *hist, int *pos) {
    int p = *pos;
    int p3 = p + (LAG_LONG - LAG_SHORT);
    if (p3 >= LAG_LONG) p3 -= LAG_LONG;
    uint32_t v = hist[p] + hist[p3];
    hist[p] = v;
    *pos = (p + 1 == LAG_LONG) ? 0 : p + 1;
    return v;
}

/* Fill out[0..n) with raw recurrence words (callers shift >>1 for rand()).
 * hist[0..30] holds the last 31 words, hist[30] newest; updated on return. */
void glibc_fill(uint32_t *hist, uint32_t *out, int64_t n) {
    /* convert "hist[30] newest" layout into ring form */
    uint32_t ring[LAG_LONG];
    for (int i = 0; i < LAG_LONG; i++) ring[i] = hist[i];
    int pos = 0;
    for (int64_t i = 0; i < n; i++) out[i] = next_word(ring, &pos);
    /* write back: oldest-first order starting at pos */
    for (int i = 0; i < LAG_LONG; i++)
        hist[i] = ring[(pos + i) % LAG_LONG];
}

/* Knuth shuffle of int32 keys with j = RAND_RANGE(i)
 * (reference: generator.c:22,51-66). */
void knuth_shuffle_i32(int32_t *keys, int64_t n, uint32_t *hist) {
    uint32_t ring[LAG_LONG];
    for (int i = 0; i < LAG_LONG; i++) ring[i] = hist[i];
    int pos = 0;
    for (int64_t i = n - 1; i > 0; i--) {
        uint32_t r = next_word(ring, &pos) >> 1;
        int64_t j = (int64_t)((double)r / ((double)GLIBC_RAND_MAX + 1.0) * (double)i);
        int32_t tmp = keys[i];
        keys[i] = keys[j];
        keys[j] = tmp;
    }
    for (int i = 0; i < LAG_LONG; i++)
        hist[i] = ring[(pos + i) % LAG_LONG];
}

/* Alphabet shuffle for genzipf: k = (unsigned long)i * rand() / RAND_MAX with
 * integer division (reference: genzipf.c:43-51); element type int64. */
void alphabet_shuffle_i64(int64_t *alpha, int64_t n, uint32_t *hist) {
    uint32_t ring[LAG_LONG];
    for (int i = 0; i < LAG_LONG; i++) ring[i] = hist[i];
    int pos = 0;
    for (int64_t i = n - 1; i > 0; i--) {
        uint32_t r = next_word(ring, &pos) >> 1;
        int64_t k = ((int64_t)i * (int64_t)r) / GLIBC_RAND_MAX;
        int64_t tmp = alpha[i];
        alpha[i] = alpha[k];
        alpha[k] = tmp;
    }
    for (int i = 0; i < LAG_LONG; i++)
        hist[i] = ring[(pos + i) % LAG_LONG];
}

/* Zipf draws: r = rand()/RAND_MAX, binary search of the cumulative LUT
 * (smallest pos with lut[pos] >= r), emit alphabet[pos]
 * (reference: genzipf.c:97-159). */
void zipf_fill_i32(const double *lut, const int64_t *alphabet, int64_t asize,
                   int32_t *out, int64_t n, uint32_t *hist) {
    uint32_t ring[LAG_LONG];
    for (int i = 0; i < LAG_LONG; i++) ring[i] = hist[i];
    int pos = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t rr = next_word(ring, &pos) >> 1;
        double r = (double)rr / (double)GLIBC_RAND_MAX;
        int64_t lo = 0, hi = asize - 1, p;
        if (lut[0] >= r) {
            p = 0;
        } else {
            while (hi - lo > 1) {
                int64_t m = (lo + hi) / 2;
                if (lut[m] < r) lo = m; else hi = m;
            }
            p = hi;
        }
        out[i] = (int32_t)alphabet[p];
    }
    for (int i = 0; i < LAG_LONG; i++)
        hist[i] = ring[(pos + i) % LAG_LONG];
}

/* Uniform non-unique keys: RAND_RANGE(maxid) (reference: generator.c:215-231). */
void random_gen_i32(int32_t *out, int64_t n, int64_t maxid, uint32_t *hist) {
    uint32_t ring[LAG_LONG];
    for (int i = 0; i < LAG_LONG; i++) ring[i] = hist[i];
    int pos = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t r = next_word(ring, &pos) >> 1;
        out[i] = (int32_t)((double)r / ((double)GLIBC_RAND_MAX + 1.0) * (double)maxid);
    }
    for (int i = 0; i < LAG_LONG; i++)
        hist[i] = ring[(pos + i) % LAG_LONG];
}
