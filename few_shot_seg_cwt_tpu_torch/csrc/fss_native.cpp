// fss_native: fused CPU kernels for the episode input pipeline of the
// PyTorch port (the port's own copy of the JAX package's transform core).
//
// The host-side path decodes an image and then runs four passes (bilinear
// resize, canvas pad, /255 scale, mean/std normalize) plus a nearest resize
// + pad for the label; this library fuses each chain into one
// cache-friendly pass. It also undoes PNG's per-row filters, so the port
// decodes PNG images and masks without OpenCV or Pillow (the inflate is
// Python's zlib; the row filters are a sequential byte loop, too slow in
// Python, and running here lets decode threads drop the interpreter lock).
//
// Semantics mirror the numpy/cv2 reference implementation: bilinear
// sampling on the half-pixel grid (cv2 INTER_LINEAR in float mode), nearest
// sampling with cv2's truncation convention, bottom/right zero-or-mean
// padding, label padding 255. The resize and label functions are the JAX
// package's, byte for byte, and are built with the same g++ flags, so both
// packages give the same bits.
//
// Built at first use by few_shot_seg_cwt_tpu_torch/data/native.py
// (g++ -O3 -shared -fPIC -std=c++17). ABI: plain C, ctypes-friendly.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Bilinear-resize an HxWx3 float32 image to (nh, nw), write into a
// (size, size, 3) float32 canvas pre-filled by the caller contract:
// out[y][x][c] = ((sample / 255) - mean[c]) / std[c] for y<nh, x<nw;
// remaining pixels get ((pad[c]/255) - mean[c]) / std[c].
void resize_pad_normalize_f32(
    const float* img, int64_t in_h, int64_t in_w,
    float* out, int64_t size, int64_t nh, int64_t nw,
    const float* mean, const float* stdv, const float* pad_value) {
  const double sy = static_cast<double>(in_h) / static_cast<double>(nh);
  const double sx = static_cast<double>(in_w) / static_cast<double>(nw);

  float pad_norm[3];
  for (int c = 0; c < 3; ++c) {
    const float pv = pad_value ? pad_value[c] : 0.0f;
    pad_norm[c] = (pv / 255.0f - mean[c]) / stdv[c];
  }

  // padded region (rows below nh, columns right of nw)
  for (int64_t y = 0; y < size; ++y) {
    float* row = out + y * size * 3;
    const int64_t x_start = (y < nh) ? nw : 0;
    for (int64_t x = x_start; x < size; ++x) {
      row[x * 3 + 0] = pad_norm[0];
      row[x * 3 + 1] = pad_norm[1];
      row[x * 3 + 2] = pad_norm[2];
    }
  }

  for (int64_t y = 0; y < nh; ++y) {
    // half-pixel source coordinate, clamped like cv2's border replication
    double fy = (y + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    int64_t y0 = static_cast<int64_t>(fy);
    if (y0 > in_h - 1) y0 = in_h - 1;
    int64_t y1 = std::min<int64_t>(y0 + 1, in_h - 1);
    const float wy = static_cast<float>(fy - y0);
    const float* r0 = img + y0 * in_w * 3;
    const float* r1 = img + y1 * in_w * 3;
    float* row = out + y * size * 3;

    for (int64_t x = 0; x < nw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      if (fx < 0) fx = 0;
      int64_t x0 = static_cast<int64_t>(fx);
      if (x0 > in_w - 1) x0 = in_w - 1;
      int64_t x1 = std::min<int64_t>(x0 + 1, in_w - 1);
      const float wx = static_cast<float>(fx - x0);
      const float w00 = (1.0f - wy) * (1.0f - wx);
      const float w01 = (1.0f - wy) * wx;
      const float w10 = wy * (1.0f - wx);
      const float w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * r0[x0 * 3 + c] + w01 * r0[x1 * 3 + c] +
                        w10 * r1[x0 * 3 + c] + w11 * r1[x1 * 3 + c];
        row[x * 3 + c] = (v / 255.0f - mean[c]) / stdv[c];
      }
    }
  }
}

// Nearest-resize a uint8 label to (nh, nw) inside a (size, size) int32
// canvas padded with 255, binarizing on the fly: target_class -> 1,
// 255 -> 255, everything else -> 0. target_class < 0 skips binarization.
void resize_pad_label_i32(
    const uint8_t* label, int64_t in_h, int64_t in_w,
    int32_t* out, int64_t size, int64_t nh, int64_t nw,
    int32_t target_class) {
  const double sy = static_cast<double>(in_h) / static_cast<double>(nh);
  const double sx = static_cast<double>(in_w) / static_cast<double>(nw);

  for (int64_t y = 0; y < size; ++y) {
    int32_t* row = out + y * size;
    if (y >= nh) {
      std::fill(row, row + size, 255);
      continue;
    }
    // cv2 INTER_NEAREST: src = floor(dst * scale) (truncation of dst*sy)
    int64_t yy = static_cast<int64_t>(y * sy);
    if (yy > in_h - 1) yy = in_h - 1;
    const uint8_t* src_row = label + yy * in_w;
    for (int64_t x = 0; x < nw; ++x) {
      int64_t xx = static_cast<int64_t>(x * sx);
      if (xx > in_w - 1) xx = in_w - 1;
      int32_t v = src_row[xx];
      if (target_class >= 0) {
        v = (v == target_class) ? 1 : (v == 255 ? 255 : 0);
      }
      row[x] = v;
    }
    for (int64_t x = nw; x < size; ++x) row[x] = 255;
  }
}

// Undo PNG's row filters (PNG spec, section 9): ``in`` holds ``height``
// rows of one filter-type byte and ``row_bytes`` filtered bytes; ``out``
// receives the ``height * row_bytes`` raw bytes. ``bpp`` is the bytes per
// complete pixel, at least 1 (the left neighbour's distance). Returns 0, or
// -(row + 1) for the first row with an unknown filter type.
int64_t png_unfilter(const uint8_t* in, int64_t height, int64_t row_bytes,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t filter = in[y * (row_bytes + 1)];
    const uint8_t* src = in + y * (row_bytes + 1) + 1;
    uint8_t* row = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? out + (y - 1) * row_bytes : nullptr;
    switch (filter) {
      case 0:  // None
        std::memcpy(row, src, row_bytes);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < row_bytes; ++i)
          row[i] = src[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int64_t i = 0; i < row_bytes; ++i)
          row[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average: floor((left + up) / 2) without overflow
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
