// Host image codecs of the data pipeline: JPEG backgrounds (full size or
// at a DCT scale n/8) and PNG masks, as float32 arrays, behind a plain C
// interface loaded with ctypes (runtime/native.py). No call touches Python
// state, so loader threads decode in parallel.
//
// Built at first use by the host compiler with -ljpeg -lpng
// (runtime/native.py); on a host without those headers the build fails,
// and the pipeline decodes with OpenCV or, for PNG, runtime/png.py.
// The warps live in host_warp.cpp, which needs no library, so they build
// there all the same.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct mtt_jpeg_error_mgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void mtt_jpeg_error_exit(j_common_ptr cinfo) {
  mtt_jpeg_error_mgr* err = reinterpret_cast<mtt_jpeg_error_mgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Returns 0 on success. Probes (height, width) without decoding.
int mtt_jpeg_probe(const char* path, int32_t* height, int32_t* width) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  mtt_jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mtt_jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *height = cinfo.image_height;
  *width = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Decodes an RGB JPEG into a float32 [0,1] HWC buffer of size h*w*3
// (caller allocates after mtt_jpeg_probe). Returns 0 on success.
int mtt_jpeg_decode_f32(const char* path, float* out, int32_t h, int32_t w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  mtt_jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mtt_jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int32_t)cinfo.output_height != h || (int32_t)cinfo.output_width != w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  std::vector<uint8_t> row(static_cast<size_t>(w) * 3);
  uint8_t* rowp = row.data();
  const float inv = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) dst[i] = rowp[i] * inv;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Decodes an RGB JPEG at DCT-domain scale scale_num/8 (libjpeg-turbo
// supports every N/8, N=1..16; N=8 is full size). The IDCT itself produces
// the reduced-resolution image, so decoding at 5/8 skips ~60% of the IDCT
// and color-conversion work — the reference's hot loop decodes full frames
// only to immediately downscale them (dataset.py:300-301), which is wasted
// host time when the training patch target is far below the stored frame.
// out must hold buf_h*buf_w*3 floats; the actual scaled dimensions (the
// library's own jdiv_round_up(dim*num/8)) are written to out_h/out_w.
// Returns 0 on success; 4 if the scaled output exceeds the buffer (caller
// falls back to the full-size decode).
int mtt_jpeg_decode_scaled_f32(const char* path, float* out, int32_t buf_h,
                               int32_t buf_w, int32_t scale_num,
                               int32_t* out_h, int32_t* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  mtt_jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mtt_jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = (unsigned int)scale_num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  const int32_t h = (int32_t)cinfo.output_height;
  const int32_t w = (int32_t)cinfo.output_width;
  *out_h = h;
  *out_w = w;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  if (h > buf_h || w > buf_w) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 4;
  }
  std::vector<uint8_t> row(static_cast<size_t>(w) * 3);
  uint8_t* rowp = row.data();
  const float inv = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) dst[i] = rowp[i] * inv;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG (grayscale binary masks: value > 0 -> 1.0)
// ---------------------------------------------------------------------------

int mtt_png_probe(const char* path, int32_t* height, int32_t* width) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *height = png_get_image_height(png, info);
  *width = png_get_image_width(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

// Decodes any PNG to a float32 binary mask (h*w): any nonzero luminance or
// palette index -> 1.0 (matches cv2.imread(..., GRAYSCALE) > 0 for the
// VOS/DAVIS annotation files). Returns 0 on success.
int mtt_png_decode_mask_f32(const char* path, float* out, int32_t h, int32_t w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  if ((int32_t)png_get_image_height(png, info) != h ||
      (int32_t)png_get_image_width(png, info) != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 3;
  }
  // Normalize every color type to 8-bit gray.
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  color_type = png_get_color_type(png, info);
  int channels = png_get_channels(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      uint32_t v = 0;
      // luminance-ish: any nonzero channel marks the mask
      for (int c = 0; c < channels && c < 3; ++c) v |= row[x * channels + c];
      dst[x] = v ? 1.0f : 0.0f;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

}  // extern "C"
