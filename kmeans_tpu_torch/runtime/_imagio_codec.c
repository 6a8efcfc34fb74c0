/* _imagio_codec: the port's native host runtime, its PNG and JPEG unit.
 *
 * The PNG (libpng) and JPEG (libjpeg) functions of
 * kmeans_tpu/runtime/_imagio.c with a plain C interface, loaded with ctypes
 * (kmeans_tpu_torch/runtime/__init__.py) and linked as the reference's
 * setup.py links its extension (-lpng -ljpeg -lz). It is a unit of its own
 * so that the rest of the runtime (`_imagio.c`) builds on a host without
 * these libraries' headers. The libpng and libjpeg settings are the
 * original's, so the bytes each function writes are the original's. No
 * function touches a Python object. Errors: `_imagio.h`.
 */

#include <png.h>
#include <jpeglib.h>
#include <setjmp.h>

#include "_imagio.h"

void
imagio_free(void *p)
{
    free(p);
}

/* set_max_decode_pixels, original :1345: this unit's copy of the budget. */
int
imagio_set_max_decode_pixels(uint64_t n, uint64_t *old, char *err, size_t errlen)
{
    return imagio_budget_set(n, old, err, errlen);
}

/* ------------------------------------------------------------------ */
/* PNG                                                                 */
/* ------------------------------------------------------------------ */

typedef struct {
    const unsigned char *data;
    size_t size;
    size_t pos;
} png_read_state;

static void
png_mem_read(png_structp png, png_bytep out, png_size_t count)
{
    png_read_state *st = (png_read_state *)png_get_io_ptr(png);
    if (st->pos + count > st->size) {
        png_error(png, "read past end of PNG buffer");
        return;
    }
    memcpy(out, st->data + st->pos, count);
    st->pos += count;
}

static void
png_mem_write(png_structp png, png_bytep data, png_size_t count)
{
    byte_vec *v = (byte_vec *)png_get_io_ptr(png);
    if (byte_vec_push(v, data, count) != 0)
        png_error(png, "out of memory");
}

static void
png_mem_flush(png_structp png)
{
    (void)png;
}

/* decode_png, original :119. `*out` is w*h*4 RGBA bytes. */
int
imagio_decode_png(const unsigned char *data, size_t len, uint32_t *w_out,
                  uint32_t *h_out, unsigned char **out_rgba, char *err, size_t errlen)
{
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, NULL, NULL, NULL);
    png_infop info = png ? png_create_info_struct(png) : NULL;
    /* volatile: read after longjmp (C11 7.13.2.1) */
    png_bytep *volatile rows = NULL;
    unsigned char *volatile out = NULL;
    volatile int rc = IMAGIO_OK;

    if (!png || !info) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "libpng init failed");
        goto done;
    }
    if (setjmp(png_jmpbuf(png))) {
        rc = fail(err, errlen, IMAGIO_EVALUE, "invalid PNG data");
        goto done;
    }

    png_read_state st = {data, len, 0};
    png_set_read_fn(png, &st, png_mem_read);
    png_read_info(png, info);

    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    if ((rc = imagio_check_pixels(w, h, err, errlen)) != IMAGIO_OK)
        goto done;
    int bit_depth = png_get_bit_depth(png, info);
    int color_type = png_get_color_type(png, info);

    /* Normalize everything to 8-bit RGBA. */
    if (bit_depth == 16)
        png_set_strip_16(png);
    if (color_type == PNG_COLOR_TYPE_PALETTE)
        png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS))
        png_set_tRNS_to_alpha(png);
    if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_PALETTE)
        png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
    if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_read_update_info(png, info);

    size_t stride = (size_t)w * 4;
    out = (unsigned char *)malloc(stride * h);
    rows = (png_bytep *)malloc(sizeof(png_bytep) * h);
    if (!out || !rows) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");
        goto done;
    }
    for (png_uint_32 y = 0; y < h; y++)
        rows[y] = out + y * stride;
    png_read_image(png, rows);
    png_read_end(png, NULL);

    *w_out = w;
    *h_out = h;
    *out_rgba = out;
    out = NULL;

done:
    if (png)
        png_destroy_read_struct(&png, info ? &info : NULL, NULL);
    free(rows);
    free(out);
    return rc;
}

/* encode_png, original :193 (colour type 6), and encode_png_indexed,
 * original :251 (colour type 3 with PLTE and, where an entry's alpha is
 * not 255, tRNS). `pixels` is w*h*4 RGBA bytes, or w*h palette indices. */
static int
encode_png_common(uint32_t w, uint32_t h, int color_type, const unsigned char *pixels,
                  size_t row_bytes, const unsigned char *pal, size_t ncolors,
                  unsigned char **out, size_t *out_len, char *err, size_t errlen)
{
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, NULL, NULL, NULL);
    png_infop info = png ? png_create_info_struct(png) : NULL;
    /* volatile: read after longjmp */
    png_bytep *volatile rows = NULL;
    volatile int rc = IMAGIO_OK;
    static _Thread_local byte_vec vec; /* stable storage across longjmp */
    vec.data = NULL;
    vec.size = 0;
    vec.cap = 0;

    if (!png || !info) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "libpng init failed");
        goto done;
    }
    if (setjmp(png_jmpbuf(png))) {
        rc = fail(err, errlen, IMAGIO_EVALUE, "PNG encode failed");
        goto done;
    }

    png_set_write_fn(png, &vec, png_mem_write, png_mem_flush);
    png_set_IHDR(png, info, w, h, 8, color_type, PNG_INTERLACE_NONE,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    if (color_type == PNG_COLOR_TYPE_PALETTE) {
        png_color plte[256];
        png_byte trns[256];
        int has_alpha = 0;
        for (size_t i = 0; i < ncolors; i++) {
            plte[i].red = pal[i * 4 + 0];
            plte[i].green = pal[i * 4 + 1];
            plte[i].blue = pal[i * 4 + 2];
            trns[i] = pal[i * 4 + 3];
            if (trns[i] != 0xFF)
                has_alpha = 1;
        }
        png_set_PLTE(png, info, plte, (int)ncolors);
        if (has_alpha)
            png_set_tRNS(png, info, trns, (int)ncolors, NULL);
    }
    png_write_info(png, info);

    rows = (png_bytep *)malloc(sizeof(png_bytep) * h);
    if (!rows) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");
        goto done;
    }
    for (uint32_t y = 0; y < h; y++)
        rows[y] = (png_bytep)(pixels + (size_t)y * row_bytes);
    png_write_image(png, rows);
    png_write_end(png, NULL);

    *out = vec.data;
    *out_len = vec.size;
    vec.data = NULL;

done:
    if (png)
        png_destroy_write_struct(&png, info ? &info : NULL);
    free(rows);
    free(vec.data);
    vec.data = NULL;
    return rc;
}

/* encode_png, original :193 */
int
imagio_encode_png(uint32_t w, uint32_t h, const unsigned char *rgba, size_t len,
                  unsigned char **out, size_t *out_len, char *err, size_t errlen)
{
    if (len != (size_t)w * h * 4)
        return fail(err, errlen, IMAGIO_EVALUE, "rgba buffer must be w*h*4 bytes");
    return encode_png_common(w, h, PNG_COLOR_TYPE_RGBA, rgba, (size_t)w * 4, NULL, 0,
                             out, out_len, err, errlen);
}

/* encode_png_indexed, original :251: palette (colour type 3) PNG, 1 byte a
 * pixel, for quantized images of <= 256 colours. */
int
imagio_encode_png_indexed(uint32_t w, uint32_t h, const unsigned char *pal, size_t pal_len,
                          const unsigned char *idx, size_t idx_len, unsigned char **out,
                          size_t *out_len, char *err, size_t errlen)
{
    size_t ncolors = pal_len / 4;
    if (pal_len % 4 != 0 || ncolors == 0 || ncolors > 256 || idx_len != (size_t)w * h ||
        w == 0 || h == 0)
        return fail(err, errlen, IMAGIO_EVALUE,
                    "expected (w, h, rgba palette <=256*4, w*h index bytes)");
    for (size_t q = 0; q < idx_len; q++)
        if (idx[q] >= ncolors)
            return fail(err, errlen, IMAGIO_EVALUE, "index out of palette range");
    return encode_png_common(w, h, PNG_COLOR_TYPE_PALETTE, idx, (size_t)w, pal, ncolors,
                             out, out_len, err, errlen);
}

/* ------------------------------------------------------------------ */
/* JPEG                                                                */
/* ------------------------------------------------------------------ */

struct imagio_jpeg_error {
    struct jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void
imagio_jpeg_error_exit(j_common_ptr cinfo)
{
    struct imagio_jpeg_error *err = (struct imagio_jpeg_error *)cinfo->err;
    longjmp(err->jump, 1);
}

/* decode_jpeg, original :359. `*out` is w*h*4 RGBA bytes, alpha 255. */
int
imagio_decode_jpeg(const unsigned char *data, size_t len, uint32_t *w_out, uint32_t *h_out,
                   unsigned char **out_rgba, char *err, size_t errlen)
{
    struct jpeg_decompress_struct cinfo;
    struct imagio_jpeg_error jerr;
    /* volatile: read after longjmp (C11 7.13.2.1) */
    unsigned char *volatile out = NULL;
    unsigned char *volatile row = NULL;
    volatile int created = 0;
    volatile int rc = IMAGIO_OK;

    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = imagio_jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        rc = fail(err, errlen, IMAGIO_EVALUE, "invalid JPEG data");
        goto done;
    }

    jpeg_create_decompress(&cinfo);
    created = 1;
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);

    size_t w = cinfo.output_width, h = cinfo.output_height;
    if ((rc = imagio_check_pixels(w, h, err, errlen)) != IMAGIO_OK)
        goto done;
    size_t row_rgb = w * 3;
    out = (unsigned char *)malloc(w * h * 4);
    row = (unsigned char *)malloc(row_rgb);
    if (!out || !row) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");
        goto done;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        size_t y = cinfo.output_scanline;
        JSAMPROW rp = (JSAMPROW)row;
        jpeg_read_scanlines(&cinfo, &rp, 1);
        unsigned char *dst = out + y * w * 4;
        for (size_t x = 0; x < w; x++) {
            dst[x * 4 + 0] = row[x * 3 + 0];
            dst[x * 4 + 1] = row[x * 3 + 1];
            dst[x * 4 + 2] = row[x * 3 + 2];
            dst[x * 4 + 3] = 0xFF;
        }
    }
    jpeg_finish_decompress(&cinfo);

    *w_out = (uint32_t)w;
    *h_out = (uint32_t)h;
    *out_rgba = out;
    out = NULL;

done:
    if (created)
        jpeg_destroy_decompress(&cinfo);
    free(row);
    free(out);
    return rc;
}

/* encode_jpeg, original :424 (RGB, libjpeg's defaults at `quality`). */
int
imagio_encode_jpeg(uint32_t w, uint32_t h, const unsigned char *rgba, size_t len, int quality,
                   unsigned char **out, size_t *out_len, char *err, size_t errlen)
{
    if (len != (size_t)w * h * 4)
        return fail(err, errlen, IMAGIO_EVALUE, "rgba buffer must be w*h*4 bytes");

    struct jpeg_compress_struct cinfo;
    struct imagio_jpeg_error jerr;
    /* volatile: read after longjmp */
    unsigned char *volatile mem = NULL;
    unsigned long mem_size = 0;
    unsigned char *volatile row = NULL;
    volatile int created = 0;
    volatile int rc = IMAGIO_OK;

    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = imagio_jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        rc = fail(err, errlen, IMAGIO_EVALUE, "JPEG encode failed");
        goto done;
    }

    jpeg_create_compress(&cinfo);
    created = 1;
    jpeg_mem_dest(&cinfo, (unsigned char **)&mem, &mem_size);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);

    row = (unsigned char *)malloc((size_t)w * 3);
    if (!row) {
        rc = fail(err, errlen, IMAGIO_ENOMEM, "out of memory");
        goto done;
    }
    while (cinfo.next_scanline < cinfo.image_height) {
        const unsigned char *src = rgba + (size_t)cinfo.next_scanline * w * 4;
        for (unsigned int x = 0; x < w; x++) {
            row[x * 3 + 0] = src[x * 4 + 0];
            row[x * 3 + 1] = src[x * 4 + 1];
            row[x * 3 + 2] = src[x * 4 + 2];
        }
        JSAMPROW rp = (JSAMPROW)row;
        jpeg_write_scanlines(&cinfo, &rp, 1);
    }
    jpeg_finish_compress(&cinfo);

    *out = mem;
    *out_len = mem_size;
    mem = NULL;

done:
    if (created)
        jpeg_destroy_compress(&cinfo);
    free(row);
    free(mem);
    return rc;
}

