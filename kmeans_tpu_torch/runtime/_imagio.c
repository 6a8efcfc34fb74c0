/* _imagio: the port's native host runtime, its core unit.
 *
 * A copy of kmeans_tpu/runtime/_imagio.c with a plain C interface in place
 * of the CPython one, loaded with ctypes (kmeans_tpu_torch/runtime/__init__.py):
 * the decode budget, the GIF89a codec (LZW encoder and decoder, disposal
 * and transparency compositing), the readback unpacks and the alpha strip.
 * It needs nothing but a C compiler. PNG and JPEG, which need libpng and
 * libjpeg, are the second unit, `_imagio_codec.c`. Each entry point cites
 * the function it copies; the arithmetic and the byte layouts are the
 * original's, so the bytes each one writes are the original's.
 *
 * No function touches a Python object: ctypes releases the interpreter lock
 * around each call, so handler threads and unpack threads run here side by
 * side. State shared across calls is the decode budget alone (atomic).
 * Buffers that a call allocates (`*out`) are freed with imagio_free; the
 * unpacks and the strip write into the caller's buffer, whose length the
 * call checks. Errors: `_imagio.h`.
 */

#include "_imagio.h"

void
imagio_free(void *p)
{
    free(p);
}

/* set_max_decode_pixels, original :1345 */
int
imagio_set_max_decode_pixels(uint64_t n, uint64_t *old, char *err, size_t errlen)
{
    return imagio_budget_set(n, old, err, errlen);
}

/* ------------------------------------------------------------------ */
/* GIF (GIF89a encoder with LZW compression)                           */
/* ------------------------------------------------------------------ */

typedef struct {
    byte_vec *out;
    unsigned char block[255];
    int block_len;
    unsigned int bit_buf;
    int bit_count;
} lzw_writer;

static int
lzw_flush_block(lzw_writer *w)
{
    if (w->block_len > 0) {
        unsigned char len = (unsigned char)w->block_len;
        if (byte_vec_push(w->out, &len, 1) != 0)
            return -1;
        if (byte_vec_push(w->out, w->block, w->block_len) != 0)
            return -1;
        w->block_len = 0;
    }
    return 0;
}

static int
lzw_put_code(lzw_writer *w, unsigned int code, int width)
{
    w->bit_buf |= code << w->bit_count;
    w->bit_count += width;
    while (w->bit_count >= 8) {
        w->block[w->block_len++] = (unsigned char)(w->bit_buf & 0xFF);
        w->bit_buf >>= 8;
        w->bit_count -= 8;
        if (w->block_len == 255 && lzw_flush_block(w) != 0)
            return -1;
    }
    return 0;
}

/* Hash-table LZW: 12-bit max code, (prefix, char) -> code. */
#define LZW_MAX_CODE 4096
#define LZW_HASH_SIZE 8192

/* lzw_compress, original :539 */
static int
lzw_compress(byte_vec *out, const unsigned char *pixels, size_t n, int min_code_size)
{
    if (n == 0)
        return -1;
    int clear_code = 1 << min_code_size;
    int end_code = clear_code + 1;

    int *hash_key = (int *)malloc(sizeof(int) * LZW_HASH_SIZE);
    int *hash_val = (int *)malloc(sizeof(int) * LZW_HASH_SIZE);
    if (!hash_key || !hash_val) {
        free(hash_key);
        free(hash_val);
        return -1;
    }

    lzw_writer w = {out, {0}, 0, 0, 0};
    int code_size = min_code_size + 1;
    int next_code = end_code + 1;
    memset(hash_key, 0xFF, sizeof(int) * LZW_HASH_SIZE);

    int rc = -1;
    if (lzw_put_code(&w, (unsigned)clear_code, code_size) != 0)
        goto fail;

    int prefix = pixels[0];
    for (size_t i = 1; i < n; i++) {
        int c = pixels[i];
        int key = (prefix << 8) | c;
        int slot = ((prefix * 31) ^ c) & (LZW_HASH_SIZE - 1);
        int found = -1;
        while (hash_key[slot] != -1) {
            if (hash_key[slot] == key) {
                found = hash_val[slot];
                break;
            }
            slot = (slot + 1) & (LZW_HASH_SIZE - 1);
        }
        if (found >= 0) {
            prefix = found;
            continue;
        }
        if (lzw_put_code(&w, (unsigned)prefix, code_size) != 0)
            goto fail;
        if (next_code < LZW_MAX_CODE) {
            hash_key[slot] = key;
            hash_val[slot] = next_code;
            if (next_code == (1 << code_size))
                code_size++;
            next_code++;
        } else {
            if (lzw_put_code(&w, (unsigned)clear_code, code_size) != 0)
                goto fail;
            memset(hash_key, 0xFF, sizeof(int) * LZW_HASH_SIZE);
            code_size = min_code_size + 1;
            next_code = end_code + 1;
        }
        prefix = c;
    }
    if (lzw_put_code(&w, (unsigned)prefix, code_size) != 0)
        goto fail;
    if (lzw_put_code(&w, (unsigned)end_code, code_size) != 0)
        goto fail;
    if (w.bit_count > 0) {
        w.block[w.block_len++] = (unsigned char)(w.bit_buf & 0xFF);
        if (w.block_len == 255 && lzw_flush_block(&w) != 0)
            goto fail;
    }
    if (lzw_flush_block(&w) != 0)
        goto fail;
    rc = 0;
fail:
    free(hash_key);
    free(hash_val);
    return rc;
}

static int
push_u16le(byte_vec *v, unsigned int value)
{
    unsigned char b[2] = {(unsigned char)(value & 0xFF), (unsigned char)(value >> 8)};
    return byte_vec_push(v, b, 2);
}

/* encode_gif, original :623. Frame f is the RGB palette pals[f]
 * (pal_lens[f] bytes) and the w*h indices idxs[f] (idx_lens[f] bytes),
 * shown for delays[f] centiseconds. */
int
imagio_encode_gif(uint32_t w, uint32_t h, int n_frames, const unsigned char *const *pals,
                  const size_t *pal_lens, const unsigned char *const *idxs,
                  const size_t *idx_lens, const int32_t *delays, int loop,
                  unsigned char **out_gif, size_t *out_len, char *err, size_t errlen)
{
    if (n_frames <= 0)
        return fail(err, errlen, IMAGIO_EVALUE, "frames must be a non-empty list");

    byte_vec out = {NULL, 0, 0};
    int rc = IMAGIO_OK;

#define CHECK(expr)                                                            \
    do {                                                                       \
        if ((expr) != 0) {                                                     \
            rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");            \
            goto done;                                                         \
        }                                                                      \
    } while (0)

    CHECK(byte_vec_push(&out, (const unsigned char *)"GIF89a", 6));
    CHECK(push_u16le(&out, w));
    CHECK(push_u16le(&out, h));
    {
        /* No global color table; 8-bit color resolution. */
        unsigned char screen[3] = {0x70, 0x00, 0x00};
        CHECK(byte_vec_push(&out, screen, 3));
    }
    if (loop) {
        /* Netscape application extension for infinite looping. */
        static const unsigned char loop_ext[] = {
            0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P', 'E',
            '2', '.', '0', 0x03, 0x01, 0x00, 0x00, 0x00};
        CHECK(byte_vec_push(&out, loop_ext, sizeof(loop_ext)));
    }

    for (int i = 0; i < n_frames; i++) {
        const unsigned char *pal = pals[i], *idx = idxs[i];
        int frame_delay = delays[i];
        size_t ncolors = pal_lens[i] / 3;
        if (pal_lens[i] % 3 != 0 || ncolors == 0 || ncolors > 256 || w == 0 || h == 0 ||
            idx_lens[i] != (size_t)w * h) {
            rc = fail(err, errlen, IMAGIO_EVALUE,
                      "frame must be (palette rgb bytes <=256*3, w*h index bytes)"
                      " with nonzero dimensions");
            goto done;
        }
        for (size_t q = 0; q < idx_lens[i]; q++) {
            if (idx[q] >= ncolors) {
                rc = fail(err, errlen, IMAGIO_EVALUE, "frame index out of palette range");
                goto done;
            }
        }
        /* Color table size: power of two >= ncolors, >= 2. */
        int bits = 1;
        while ((size_t)(1 << bits) < ncolors)
            bits++;
        size_t table = (size_t)1 << bits;

        /* Graphic control extension (delay). */
        unsigned char gce[8] = {0x21, 0xF9, 0x04, 0x00,
                                (unsigned char)(frame_delay & 0xFF),
                                (unsigned char)((frame_delay >> 8) & 0xFF), 0x00, 0x00};
        CHECK(byte_vec_push(&out, gce, sizeof(gce)));

        /* Image descriptor with local color table. */
        unsigned char desc[1] = {0x2C};
        CHECK(byte_vec_push(&out, desc, 1));
        CHECK(push_u16le(&out, 0));
        CHECK(push_u16le(&out, 0));
        CHECK(push_u16le(&out, w));
        CHECK(push_u16le(&out, h));
        {
            unsigned char flags = (unsigned char)(0x80 | (bits - 1));
            CHECK(byte_vec_push(&out, &flags, 1));
        }
        CHECK(byte_vec_push(&out, pal, pal_lens[i]));
        for (size_t p = ncolors; p < table; p++) {
            static const unsigned char zero[3] = {0, 0, 0};
            CHECK(byte_vec_push(&out, zero, 3));
        }

        int min_code_size = bits < 2 ? 2 : bits;
        unsigned char mcs = (unsigned char)min_code_size;
        CHECK(byte_vec_push(&out, &mcs, 1));
        CHECK(lzw_compress(&out, idx, idx_lens[i], min_code_size));
        {
            unsigned char term = 0x00;
            CHECK(byte_vec_push(&out, &term, 1));
        }
    }
    {
        unsigned char trailer = 0x3B;
        CHECK(byte_vec_push(&out, &trailer, 1));
    }
#undef CHECK

    *out_gif = out.data;
    *out_len = out.size;
    out.data = NULL;

done:
    free(out.data);
    return rc;
}

/* ------------------------------------------------------------------ */
/* GIF decoder (GIF87a/89a): full-canvas compositing with disposal and
 * transparency, LZW decompression per the spec.                       */
/* ------------------------------------------------------------------ */

typedef struct {
    const unsigned char *p;
    size_t len;
    size_t pos;
} gif_reader;

static int
gif_need(gif_reader *r, size_t n)
{
    return r->pos + n <= r->len;
}

static unsigned int
gif_u16(gif_reader *r)
{
    unsigned int v = r->p[r->pos] | (r->p[r->pos + 1] << 8);
    r->pos += 2;
    return v;
}

/* gif_lzw_decode, original :780: one image's LZW data (sub-blocks at
 * r->pos) into indices[npx]. The code tables live on this call's stack
 * (the original's are static, safe only under the interpreter lock). */
static int
gif_lzw_decode(gif_reader *r, int min_code_size, unsigned char *out, size_t npx)
{
    int clear = 1 << min_code_size;
    int end = clear + 1;
    /* code -> (prefix code, appended byte, length) */
    int prefix[LZW_MAX_CODE];
    unsigned char append[LZW_MAX_CODE];
    unsigned char stack[LZW_MAX_CODE];

    int code_size = min_code_size + 1;
    int next_code = end + 1;
    int prev = -1;
    size_t out_pos = 0;

    unsigned int bit_buf = 0;
    int bit_count = 0;
    int block_rem = 0;

    for (int i = 0; i < clear; i++) {
        prefix[i] = -1;
        append[i] = (unsigned char)i;
    }

    while (out_pos < npx) {
        while (bit_count < code_size) {
            if (block_rem == 0) {
                if (!gif_need(r, 1))
                    return -1;
                block_rem = r->p[r->pos++];
                if (block_rem == 0)
                    return out_pos == npx ? 0 : -1;
            }
            if (!gif_need(r, 1))
                return -1;
            bit_buf |= (unsigned int)r->p[r->pos++] << bit_count;
            bit_count += 8;
            block_rem--;
        }
        int code = (int)(bit_buf & ((1u << code_size) - 1));
        bit_buf >>= code_size;
        bit_count -= code_size;

        if (code == clear) {
            code_size = min_code_size + 1;
            next_code = end + 1;
            prev = -1;
            continue;
        }
        if (code == end)
            break;

        int emit_code = code;
        int stack_len = 0;
        if (code >= next_code) {
            if (prev < 0 || code > next_code)
                return -1;
            /* KwKwK case: emit prev + first(prev). */
            stack[stack_len++] = 0; /* placeholder for first char */
            emit_code = prev;
        }
        while (emit_code >= 0) {
            if (stack_len >= LZW_MAX_CODE)
                return -1;
            stack[stack_len++] = append[emit_code];
            emit_code = prefix[emit_code];
        }
        unsigned char first = stack[stack_len - 1];
        if (code >= next_code)
            stack[0] = first; /* fill placeholder */
        for (int i = stack_len - 1; i >= 0 && out_pos < npx; i--)
            out[out_pos++] = stack[i];

        if (prev >= 0 && next_code < LZW_MAX_CODE) {
            prefix[next_code] = prev;
            append[next_code] = first;
            next_code++;
            if (next_code == (1 << code_size) && code_size < 12)
                code_size++;
        }
        prev = code;
    }
    /* Skip the rest of the current sub-block, then remaining sub-blocks
     * up to the terminator. */
    if (block_rem > 0) {
        if (!gif_need(r, (size_t)block_rem))
            return -1;
        r->pos += block_rem;
    }
    while (gif_need(r, 1)) {
        int n = r->p[r->pos++];
        if (n == 0)
            break;
        if (!gif_need(r, n))
            return -1;
        r->pos += n;
    }
    return 0;
}

/* decode_gif, original :880. `*frames_out` holds the n_frames composited
 * w*h*4 RGBA canvases one after another, `*delays_out` their delays in
 * centiseconds. */
int
imagio_decode_gif(const unsigned char *data, size_t len, uint32_t *w_out, uint32_t *h_out,
                  int *n_frames_out, unsigned char **frames_out, int32_t **delays_out,
                  char *err, size_t errlen)
{
    gif_reader r = {data, len, 0};
    byte_vec frames = {NULL, 0, 0};
    byte_vec delays = {NULL, 0, 0};
    unsigned char *canvas = NULL, *prev_canvas = NULL, *indices = NULL;
    unsigned char gct[256 * 3];
    int gct_size = 0;
    int n_frames = 0;
    int rc = IMAGIO_OK;

#define FAIL(msg)                                                              \
    do {                                                                       \
        rc = fail(err, errlen, IMAGIO_EVALUE, "%s", msg);                      \
        goto fail;                                                             \
    } while (0)
#define NOMEM()                                                                \
    do {                                                                       \
        rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");                \
        goto fail;                                                             \
    } while (0)

    if (!gif_need(&r, 13) || memcmp(r.p, "GIF8", 4) != 0)
        FAIL("not a GIF file");
    r.pos = 6;
    unsigned int width = gif_u16(&r);
    unsigned int height = gif_u16(&r);
    unsigned char flags = r.p[r.pos++];
    r.pos += 2; /* bg color index + aspect */
    if (flags & 0x80) {
        gct_size = 2 << (flags & 0x07);
        if (!gif_need(&r, (size_t)gct_size * 3))
            FAIL("truncated GIF global color table");
        memcpy(gct, r.p + r.pos, (size_t)gct_size * 3);
        r.pos += (size_t)gct_size * 3;
    }

    if ((rc = imagio_check_pixels(width, height, err, errlen)) != IMAGIO_OK)
        goto fail;
    size_t npx = (size_t)width * height;
    size_t total_px = 0; /* summed over emitted frames, same budget */
    canvas = (unsigned char *)calloc(npx * 4, 1);
    prev_canvas = (unsigned char *)malloc(npx * 4);
    indices = (unsigned char *)malloc(npx);
    if (!canvas || !prev_canvas || !indices)
        NOMEM();

    int transparent = -1;
    int disposal = 0;
    int delay_cs = 0;

    while (gif_need(&r, 1)) {
        unsigned char block = r.p[r.pos++];
        if (block == 0x3B)
            break; /* trailer */
        if (block == 0x21) {
            /* extension */
            if (!gif_need(&r, 1))
                FAIL("truncated GIF extension");
            unsigned char label = r.p[r.pos++];
            if (label == 0xF9) {
                if (!gif_need(&r, 6))
                    FAIL("truncated GCE");
                unsigned char len8 = r.p[r.pos++];
                unsigned char gflags = r.p[r.pos];
                disposal = (gflags >> 2) & 0x07;
                delay_cs = r.p[r.pos + 1] | (r.p[r.pos + 2] << 8);
                transparent = (gflags & 1) ? r.p[r.pos + 3] : -1;
                r.pos += len8;
                if (!gif_need(&r, 1) || r.p[r.pos++] != 0)
                    FAIL("bad GCE terminator");
            } else {
                /* skip sub-blocks */
                while (gif_need(&r, 1)) {
                    unsigned char n = r.p[r.pos++];
                    if (n == 0)
                        break;
                    if (!gif_need(&r, n))
                        FAIL("truncated extension");
                    r.pos += n;
                }
            }
            continue;
        }
        if (block != 0x2C)
            FAIL("unexpected GIF block");

        if (!gif_need(&r, 9))
            FAIL("truncated image descriptor");
        unsigned int ix = gif_u16(&r);
        unsigned int iy = gif_u16(&r);
        unsigned int iw = gif_u16(&r);
        unsigned int ih = gif_u16(&r);
        unsigned char iflags = r.p[r.pos++];
        int interlaced = iflags & 0x40;
        const unsigned char *table = gct;
        int table_size = gct_size;
        unsigned char lct[256 * 3];
        if (iflags & 0x80) {
            table_size = 2 << (iflags & 0x07);
            if (!gif_need(&r, (size_t)table_size * 3))
                FAIL("truncated local color table");
            memcpy(lct, r.p + r.pos, (size_t)table_size * 3);
            r.pos += (size_t)table_size * 3;
            table = lct;
        }
        if (table_size == 0)
            FAIL("GIF image with no color table");
        if (ix + iw > width || iy + ih > height)
            FAIL("GIF frame outside canvas");

        if (!gif_need(&r, 1))
            FAIL("truncated LZW header");
        int mcs = r.p[r.pos++];
        if (mcs < 2 || mcs > 11)
            FAIL("bad LZW min code size");
        size_t fpx = (size_t)iw * ih;
        if (gif_lzw_decode(&r, mcs, indices, fpx) != 0)
            FAIL("corrupt GIF LZW data");

        memcpy(prev_canvas, canvas, npx * 4);

        for (size_t i = 0; i < fpx; i++) {
            size_t row = i / iw, col = i % iw;
            if (interlaced) {
                /* interlace pass reordering */
                static const size_t start[4] = {0, 4, 2, 1};
                static const size_t step[4] = {8, 8, 4, 2};
                size_t y = 0, rem = row;
                for (int pass = 0; pass < 4; pass++) {
                    size_t rows_in_pass = (ih + step[pass] - 1 - start[pass]) / step[pass];
                    if (rem < rows_in_pass) {
                        y = start[pass] + rem * step[pass];
                        break;
                    }
                    rem -= rows_in_pass;
                }
                row = y;
            }
            int idx = indices[i];
            if (idx == transparent)
                continue;
            if (idx >= table_size)
                idx = 0;
            unsigned char *dst = canvas + (((size_t)(iy + row)) * width + ix + col) * 4;
            dst[0] = table[idx * 3 + 0];
            dst[1] = table[idx * 3 + 1];
            dst[2] = table[idx * 3 + 2];
            dst[3] = 0xFF;
        }

        total_px += npx;
        size_t limit = atomic_load(&imagio_max_pixels);
        if (total_px > limit) {
            rc = fail(err, errlen, IMAGIO_EVALUE,
                      "GIF decodes to more than the limit of %zu total "
                      "pixels across frames (raise it with "
                      "kmeans_tpu_torch.utils.imageio.set_max_decode_pixels)",
                      limit);
            goto fail;
        }
        if (byte_vec_push(&frames, canvas, npx * 4) != 0)
            NOMEM();
        {
            int32_t d = delay_cs;
            if (byte_vec_push(&delays, (const unsigned char *)&d, sizeof d) != 0)
                NOMEM();
        }
        n_frames++;

        /* Disposal for next frame. */
        if (disposal == 2) {
            for (unsigned int y = iy; y < iy + ih; y++)
                memset(canvas + ((size_t)y * width + ix) * 4, 0, (size_t)iw * 4);
        } else if (disposal == 3) {
            memcpy(canvas, prev_canvas, npx * 4);
        }
        transparent = -1;
        disposal = 0;
    }
#undef FAIL
#undef NOMEM

    *w_out = width;
    *h_out = height;
    *n_frames_out = n_frames;
    *frames_out = frames.data;
    *delays_out = (int32_t *)delays.data;
    frames.data = NULL;
    delays.data = NULL;

fail:
    free(frames.data);
    free(delays.data);
    free(canvas);
    free(prev_canvas);
    free(indices);
    return rc;
}

/* ------------------------------------------------------------------ *
 * Readback unpack fast paths (original :1095-1342).
 *
 * The port's assign and meld kernels emit the reference's bit-packed tile
 * layouts (kmeans_tpu_torch/utils/packing.py describes them); these walk
 * a layout in one pass, writing h*w RGBA8 pixels into `out` (`out_len`
 * bytes, at least h*w*4), the indexed tiers with the palette gather fused.
 * Layout constants (tile_rows, lanes, bits) MUST come from
 * kmeans_tpu_torch/ops/kernels.py: they are a function of the palette
 * size.
 * ------------------------------------------------------------------ */

/* unpack_rgb24, original :1109 */
int
imagio_unpack_rgb24(const unsigned char *wb, size_t words_len, uint32_t h, uint32_t w,
                    uint32_t tile_rows, uint32_t lanes, unsigned char *out, size_t out_len,
                    char *err, size_t errlen)
{
    const size_t hw = (size_t)h * w;
    const unsigned int blk = tile_rows / 4;
    if (tile_rows == 0 || lanes == 0 || blk * 4 != tile_rows ||
        words_len % ((size_t)3 * blk * lanes * 4) != 0)
        return fail(err, errlen, IMAGIO_EVALUE,
                    "words length does not tile (3 * tile_rows/4 * lanes"
                    " i32 words per tile; tile_rows %% 4 == 0)");
    const size_t n_tiles = words_len / ((size_t)3 * blk * lanes * 4);
    if (n_tiles * tile_rows * lanes < hw)
        return fail(err, errlen, IMAGIO_EVALUE, "words too short for h * w");
    if (out_len < hw * 4)
        return fail(err, errlen, IMAGIO_EVALUE, "output shorter than h * w * 4 bytes");
    for (size_t t = 0; t < n_tiles; t++) {
        const size_t tile_px0 = t * tile_rows * lanes;
        if (tile_px0 >= hw)
            break;
        /* Interior tiles fit entirely inside h*w: skip the per-pixel
         * bounds check (only the last tile can be ragged). */
        const int fits = tile_px0 + (size_t)tile_rows * lanes <= hw;
        /* Word rows of this tile: w0 = bytes of rows [0, blk),
         * w1 = [blk, 2blk), w2 = [2blk, 3blk); little-endian i32, so
         * byte b of word row r, lane l sits at
         * ((t*3blk + r) * lanes + l) * 4 + b. */
        for (unsigned int j = 0; j < blk; j++) {
            const unsigned char *w0 = wb + (((t * 3) * blk + j) * lanes) * 4;
            const unsigned char *w1 = w0 + (size_t)blk * lanes * 4;
            const unsigned char *w2 = w1 + (size_t)blk * lanes * 4;
            unsigned char *o0 = out + (tile_px0 + (size_t)j * lanes) * 4;
            unsigned char *o1 = o0 + (size_t)blk * lanes * 4;
            unsigned char *o2 = o1 + (size_t)blk * lanes * 4;
            unsigned char *o3 = o2 + (size_t)blk * lanes * 4;
            if (fits) {
                for (unsigned int l = 0; l < lanes; l++) {
                    const unsigned char *a = w0 + (size_t)l * 4;
                    const unsigned char *b = w1 + (size_t)l * 4;
                    const unsigned char *c = w2 + (size_t)l * 4;
                    unsigned char *o = o0 + (size_t)l * 4;
                    o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; o[3] = 255;
                    o = o1 + (size_t)l * 4;
                    o[0] = a[3]; o[1] = b[0]; o[2] = b[1]; o[3] = 255;
                    o = o2 + (size_t)l * 4;
                    o[0] = b[2]; o[1] = b[3]; o[2] = c[0]; o[3] = 255;
                    o = o3 + (size_t)l * 4;
                    o[0] = c[1]; o[1] = c[2]; o[2] = c[3]; o[3] = 255;
                }
                continue;
            }
            for (unsigned int l = 0; l < lanes; l++) {
                const unsigned char *a = w0 + (size_t)l * 4;
                const unsigned char *b = w1 + (size_t)l * 4;
                const unsigned char *c = w2 + (size_t)l * 4;
                /* Block g holds pixel (row g*blk + j, lane l). */
                const unsigned char rgb[4][3] = {
                    {a[0], a[1], a[2]},
                    {a[3], b[0], b[1]},
                    {b[2], b[3], c[0]},
                    {c[1], c[2], c[3]},
                };
                for (unsigned int g = 0; g < 4; g++) {
                    const size_t px = tile_px0 + ((size_t)g * blk + j) * lanes + l;
                    if (px >= hw)
                        continue;
                    unsigned char *o = out + px * 4;
                    o[0] = rgb[g][0];
                    o[1] = rgb[g][1];
                    o[2] = rgb[g][2];
                    o[3] = 255;
                }
            }
        }
    }
    return IMAGIO_OK;
}

/* unpack_indices_gather, original :1211. `words` is 4-byte aligned (the
 * caller's int32 array). */
int
imagio_unpack_indices_gather(const uint32_t *wk, size_t words_len, uint32_t h, uint32_t w,
                             uint32_t bits, uint32_t tile_rows, uint32_t lanes,
                             const unsigned char *pal, size_t pal_len, unsigned char *out,
                             size_t out_len, char *err, size_t errlen)
{
    const size_t hw = (size_t)h * w;
    if (bits != 2 && bits != 4 && bits != 8 && bits != 16)
        return fail(err, errlen, IMAGIO_EVALUE, "bits must be 2/4/8/16");
    const unsigned int ppw = 32 / bits;
    const unsigned int blk = tile_rows / ppw;
    const unsigned int k = (unsigned int)(pal_len / 4);
    const uint32_t mask = (1u << bits) - 1u;
    if (tile_rows == 0 || lanes == 0 || blk * ppw != tile_rows || pal_len % 4 != 0 ||
        k == 0 || words_len % ((size_t)blk * lanes * 4) != 0)
        return fail(err, errlen, IMAGIO_EVALUE,
                    "bad layout (tile_rows %% (32/bits) == 0; RGBA8"
                    " palette; words a whole number of tiles)");
    const size_t n_tiles = words_len / ((size_t)blk * lanes * 4);
    if (n_tiles * tile_rows * lanes < hw)
        return fail(err, errlen, IMAGIO_EVALUE, "words too short for h * w");
    if (out_len < hw * 4)
        return fail(err, errlen, IMAGIO_EVALUE, "output shorter than h * w * 4 bytes");
    /* A palette of 2^bits entries or more takes every index the words can
     * hold: only a smaller one needs each index checked. */
    const int need_check = k < (1u << bits);
    for (size_t t = 0; t < n_tiles; t++) {
        const size_t tile_px0 = t * tile_rows * lanes;
        if (tile_px0 >= hw)
            break;
        const int fits = tile_px0 + (size_t)tile_rows * lanes <= hw;
        for (unsigned int j = 0; j < blk; j++) {
            const uint32_t *row = wk + (t * blk + j) * lanes;
            if (fits && !need_check) {
                for (unsigned int s = 0; s < ppw; s++) {
                    unsigned char *orow = out + (tile_px0 + ((size_t)s * blk + j) * lanes) * 4;
                    const unsigned int sh = bits * s;
                    for (unsigned int l = 0; l < lanes; l++) {
                        const uint32_t idx = (row[l] >> sh) & mask;
                        memcpy(orow + (size_t)l * 4, pal + (size_t)idx * 4, 4);
                    }
                }
                continue;
            }
            for (unsigned int l = 0; l < lanes; l++) {
                uint32_t word = row[l];
                for (unsigned int s = 0; s < ppw; s++) {
                    const size_t px = tile_px0 + ((size_t)s * blk + j) * lanes + l;
                    const uint32_t idx = (word >> (bits * s)) & mask;
                    if (px >= hw)
                        continue;
                    if (idx >= k)
                        return fail(err, errlen, IMAGIO_EVALUE,
                                    "index %u out of range for %u-color palette", idx, k);
                    memcpy(out + px * 4, pal + (size_t)idx * 4, 4);
                }
            }
        }
    }
    return IMAGIO_OK;
}

/* strip_alpha, original :1310: RGBA8 -> RGB8, the upload-side alpha strip
 * (`api._host_rgb`), one pass over the bytes. */
int
imagio_strip_alpha(const unsigned char *in, size_t len, unsigned char *out, size_t out_len,
                   char *err, size_t errlen)
{
    if (len % 4 != 0)
        return fail(err, errlen, IMAGIO_EVALUE, "buffer length must be 4 * n");
    const size_t n = len / 4;
    if (out_len < n * 3)
        return fail(err, errlen, IMAGIO_EVALUE, "output shorter than 3 * n bytes");
    for (size_t i = 0; i < n; i++) {
        out[i * 3 + 0] = in[i * 4 + 0];
        out[i * 3 + 1] = in[i * 4 + 1];
        out[i * 3 + 2] = in[i * 4 + 2];
    }
    return IMAGIO_OK;
}
