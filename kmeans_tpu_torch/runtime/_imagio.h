/* _imagio.h: what both units of the port's native runtime share.
 *
 * `_imagio.c` (the decode budget, the GIF codec, the readback unpacks and
 * the alpha strip; a C compiler alone builds it) and `_imagio_codec.c` (PNG
 * and JPEG through libpng and libjpeg) each include this file, so each
 * library holds its own copy of the decode budget: the Python side sets
 * both (kmeans_tpu_torch/runtime/__init__.py).
 *
 * Every entry point returns 0 or an error code, with its message written
 * into the caller's buffer `err` of `errlen` bytes:
 *   IMAGIO_EVALUE  -> the caller raises ValueError(err);
 *   IMAGIO_ENOMEM  -> the caller raises MemoryError(err).
 */

#ifndef KMEANS_TPU_TORCH_IMAGIO_H
#define KMEANS_TPU_TORCH_IMAGIO_H

#include <stdarg.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define IMAGIO_OK 0
#define IMAGIO_EVALUE 1
#define IMAGIO_ENOMEM 2

static int
fail(char *err, size_t errlen, int code, const char *fmt, ...)
{
    if (err && errlen) {
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(err, errlen, fmt, ap);
        va_end(ap);
    }
    return code;
}

/* Decode budget (original :36-56). */

/* Max total decoded pixels one decode call may produce (summed over GIF
 * frames). Untrusted bytes can declare enormous dimensions in a tiny
 * payload — a 100-byte GIF claiming 65535x65535 would otherwise allocate
 * 17 GB before any data validation. Default 512 Mpix (2 GB RGBA). */
static _Atomic size_t imagio_max_pixels = (size_t)512 * 1024 * 1024;

static int
imagio_check_pixels(size_t w, size_t h, char *err, size_t errlen)
{
    size_t limit = atomic_load(&imagio_max_pixels);
    if (w == 0 || h == 0 || w > limit / h)
        return fail(err, errlen, IMAGIO_EVALUE,
                    "image dimensions %zux%zu exceed the decode limit of "
                    "%zu pixels (raise it with "
                    "kmeans_tpu_torch.utils.imageio.set_max_decode_pixels)",
                    w, h, limit);
    return IMAGIO_OK;
}

/* set_max_decode_pixels, original :1345 */
static int
imagio_budget_set(uint64_t n, uint64_t *old, char *err, size_t errlen)
{
    if (n == 0)
        return fail(err, errlen, IMAGIO_EVALUE, "limit must be positive");
    *old = (uint64_t)atomic_exchange(&imagio_max_pixels, (size_t)n);
    return IMAGIO_OK;
}

typedef struct {
    unsigned char *data;
    size_t size;
    size_t cap;
} byte_vec;

static int
byte_vec_push(byte_vec *v, const unsigned char *data, size_t count)
{
    if (v->size + count > v->cap) {
        size_t cap = v->cap ? v->cap : 65536;
        while (cap < v->size + count)
            cap *= 2;
        unsigned char *p = (unsigned char *)realloc(v->data, cap);
        if (!p)
            return -1;
        v->data = p;
        v->cap = cap;
    }
    memcpy(v->data + v->size, data, count);
    v->size += count;
    return 0;
}

#endif
