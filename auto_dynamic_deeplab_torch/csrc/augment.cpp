// Native data-augmentation engine.
//
// Replaces the reference's host-side pipeline (PIL resize -> torchvision
// ToTensor -> Normalize -> ZeroPad2d -> crop, dataloaders/custom_transforms.py
// :238-286), which materializes 4+ intermediate buffers per sample, with ONE
// fused pass per output pixel: inverse-map crop coordinates through
// (pad -> scale -> hflip), sample the source (antialiased separable triangle
// filter for images, nearest for masks), normalize, and write float32 NHWC.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float triangle_weight(float x, float support) {
  float ax = std::fabs(x) / support;
  return ax < 1.0f ? 1.0f - ax : 0.0f;
}

// Sample channel c of src (h, w, 3 uint8) at continuous coords (sy, sx) with
// a separable triangle filter of the given support (>=1 downscale antialias).
inline float sample_triangle(const uint8_t* src, int h, int w, int c,
                             float sy, float sx, float support_y,
                             float support_x) {
  int y0 = (int)std::ceil(sy - support_y);
  int y1 = (int)std::floor(sy + support_y);
  int x0 = (int)std::ceil(sx - support_x);
  int x1 = (int)std::floor(sx + support_x);
  y0 = std::max(y0, 0);
  x0 = std::max(x0, 0);
  y1 = std::min(y1, h - 1);
  x1 = std::min(x1, w - 1);
  float acc = 0.0f, wsum = 0.0f;
  for (int y = y0; y <= y1; ++y) {
    float wy = triangle_weight((float)y - sy, support_y);
    if (wy == 0.0f) continue;
    const uint8_t* row = src + ((size_t)y * w) * 3;
    for (int x = x0; x <= x1; ++x) {
      float wx = triangle_weight((float)x - sx, support_x);
      if (wx == 0.0f) continue;
      float wgt = wy * wx;
      acc += wgt * (float)row[(size_t)x * 3 + c];
      wsum += wgt;
    }
  }
  return wsum > 0.0f ? acc / wsum : 0.0f;
}

}  // namespace

extern "C" {

// Fused train-time augmentation for one sample.
//   img:   (h, w, 3) uint8 RGB
//   mask:  (h, w) uint8 label ids (255 = ignore)
//   scale: resize factor (new = round(dim * scale))
//   flip:  1 = horizontal flip
//   crop_i/crop_j: top-left of the crop INSIDE the padded scaled image
//   out_img:  (crop_h, crop_w, 3) float32, normalized
//   out_mask: (crop_h, crop_w) int32, pad = 255
void augment_train(const uint8_t* img, const uint8_t* mask, int h, int w,
                   float scale, int flip, int crop_i, int crop_j, int crop_h,
                   int crop_w, const float* mean, const float* std,
                   float* out_img, int32_t* out_mask) {
  int nh = (int)std::lround((double)h * scale);
  int nw = (int)std::lround((double)w * scale);
  float sy_ratio = (float)h / (float)nh;
  float sx_ratio = (float)w / (float)nw;
  // antialias support: triangle widened by the downscale ratio (>=1)
  float support_y = std::max(1.0f, sy_ratio);
  float support_x = std::max(1.0f, sx_ratio);
  float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};

  for (int oy = 0; oy < crop_h; ++oy) {
    int py = oy + crop_i;  // coordinate in padded scaled image
    bool row_pad = py >= nh;
    float sy = ((float)py + 0.5f) * sy_ratio - 0.5f;
    float* img_row = out_img + ((size_t)oy * crop_w) * 3;
    int32_t* mask_row = out_mask + (size_t)oy * crop_w;
    for (int ox = 0; ox < crop_w; ++ox) {
      int px = ox + crop_j;
      if (row_pad || px >= nw) {
        img_row[(size_t)ox * 3 + 0] = 0.0f;
        img_row[(size_t)ox * 3 + 1] = 0.0f;
        img_row[(size_t)ox * 3 + 2] = 0.0f;
        mask_row[ox] = 255;
        continue;
      }
      int qx = flip ? (nw - 1 - px) : px;
      float sx = ((float)qx + 0.5f) * sx_ratio - 0.5f;
      for (int c = 0; c < 3; ++c) {
        float v =
            sample_triangle(img, h, w, c, sy, sx, support_y, support_x) /
            255.0f;
        img_row[(size_t)ox * 3 + c] = (v - mean[c]) * inv_std[c];
      }
      // nearest-neighbour for labels (PIL NEAREST: floor of center map)
      int my = std::min(h - 1, std::max(0, (int)(((float)py + 0.5f) * sy_ratio)));
      int mx = std::min(w - 1, std::max(0, (int)(((float)qx + 0.5f) * sx_ratio)));
      mask_row[ox] = (int32_t)mask[(size_t)my * w + mx];
    }
  }
}

// Fused full-image eval preprocessing: normalize + pad (image 0 / mask 255).
void eval_preprocess_full(const uint8_t* img, const uint8_t* mask, int h,
                          int w, int out_h, int out_w, const float* mean,
                          const float* std, float* out_img,
                          int32_t* out_mask) {
  float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
  for (int y = 0; y < out_h; ++y) {
    float* img_row = out_img + ((size_t)y * out_w) * 3;
    int32_t* mask_row = out_mask + (size_t)y * out_w;
    if (y >= h) {
      std::memset(img_row, 0, sizeof(float) * (size_t)out_w * 3);
      for (int x = 0; x < out_w; ++x) mask_row[x] = 255;
      continue;
    }
    const uint8_t* src_row = img + ((size_t)y * w) * 3;
    const uint8_t* msk_row = mask + (size_t)y * w;
    for (int x = 0; x < out_w; ++x) {
      if (x >= w) {
        img_row[(size_t)x * 3 + 0] = 0.0f;
        img_row[(size_t)x * 3 + 1] = 0.0f;
        img_row[(size_t)x * 3 + 2] = 0.0f;
        mask_row[x] = 255;
        continue;
      }
      for (int c = 0; c < 3; ++c) {
        float v = (float)src_row[(size_t)x * 3 + c] / 255.0f;
        img_row[(size_t)x * 3 + c] = (v - mean[c]) * inv_std[c];
      }
      mask_row[x] = (int32_t)msk_row[x];
    }
  }
}

// Raw-label -> train-id lookup (Cityscapes encode_segmap) fused in C.
void encode_labels(const uint8_t* raw, int n, const uint8_t* lut,
                   uint8_t* out) {
  for (int i = 0; i < n; ++i) out[i] = lut[raw[i]];
}

}  // extern "C"
