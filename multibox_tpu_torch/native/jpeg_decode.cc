// Native JPEG decode (libjpeg) + optional bilinear resize to a square
// canvas — the host-side decode stage of the input pipeline
// (multibox_tpu_torch/data/jpeg.py routes here with backend="native"; the
// library is built with g++ at first use, apart from the tfrecord reader,
// since it needs libjpeg's headers).
//
// Mirrors the reference's reliance on TF's DecodeJpeg/ResizeBilinear C++
// kernels (SURVEY.md §2.2) without the TensorFlow runtime. Decode is
// RGB8; resize uses half-pixel-center bilinear (TF2/PIL convention) to
// match the on-device resize in data/augment.py.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

// Half-pixel-center bilinear resize, RGB8 → RGB8 square canvas.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int size) {
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) / size * sh - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = static_cast<float>(sh - 1);
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) / size * sw - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = static_cast<float>(sw - 1);
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float tl = src[(y0 * sw + x0) * 3 + c];
        float tr = src[(y0 * sw + x1) * 3 + c];
        float bl = src[(y1 * sw + x0) * 3 + c];
        float br = src[(y1 * sw + x1) * 3 + c];
        float v = tl * (1 - wy) * (1 - wx) + tr * (1 - wy) * wx +
                  bl * wy * (1 - wx) + br * wy * wx;
        dst[(oy * size + ox) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode JPEG to RGB8. If canvas > 0, bilinear-resize into canvas².
// Returns malloc'd buffer (caller frees via mbx_free_image) or nullptr on
// error; outputs dimensions via height/width.
uint8_t* mbx_decode_jpeg(const uint8_t* data, uint64_t size, int canvas,
                         int* height, int* width, char* errbuf,
                         int errbuf_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  // volatile: modified between setjmp and longjmp — a plain local would
  // have indeterminate value after longjmp (UB: stale free or leak).
  uint8_t* volatile pixels = nullptr;

  if (setjmp(jerr.jump)) {
    if (errbuf && errbuf_len > 0) {
      strncpy(errbuf, jerr.message, errbuf_len - 1);
      errbuf[errbuf_len - 1] = 0;
    }
    free(pixels);
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (canvas > 0) {
    // DCT-domain downscale: decode at the smallest scale_num/8 that still
    // covers the canvas — decoding a 4x-too-big COCO image at 1/2 or 1/4
    // scale costs a fraction of a full decode.
    const int src_min = cinfo.image_height < cinfo.image_width
                            ? cinfo.image_height
                            : cinfo.image_width;
    int num = 8;
    while (num > 1 && (src_min * (num - 1)) / 8 >= canvas) --num;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);

  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  pixels = static_cast<uint8_t*>(malloc(static_cast<size_t>(h) * w * 3));
  uint8_t* const buf = pixels;  // non-volatile alias for the hot loop
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (canvas > 0 && (h != canvas || w != canvas)) {
    uint8_t* out =
        static_cast<uint8_t*>(malloc(static_cast<size_t>(canvas) * canvas * 3));
    resize_bilinear(buf, h, w, out, canvas);
    free(buf);
    *height = canvas;
    *width = canvas;
    return out;
  }
  *height = h;
  *width = w;
  return buf;
}

void mbx_free_image(uint8_t* data) { free(data); }

}  // extern "C"
