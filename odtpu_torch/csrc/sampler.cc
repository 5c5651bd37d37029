// Native fused sampler for the host input pipeline.
//
// One O(out_h*out_w) pass computing: paste `src` at (top, left) on an
// infinite fill-colored canvas, take the window rect=(x1,y1,x2,y2)
// (canvas coords), optionally x-flip it, and resize to (out_h, out_w)
// with OpenCV-compatible uint8 INTER_LINEAR fixed-point bilinear.
// Neither the canvas nor the window is ever materialized: every output
// pixel reads at most 4 source taps (or the fill color).
//
// This fuses the whole geometry half of the SSD augmentation
// (Expand -> RandomSampleCrop -> RandomMirror -> Resize; the reference's
// lib/utils/augmentations.py:160-294,325-335 plus the cv2.resize at :94)
// behind the RNG-only trial loop in odtpu_torch/data/augment.py. Eval's
// plain resize is the rect=whole-image special case.
//
// A copy of odtpu/data/_native/sampler.cc; odtpu_torch/data/native.py
// builds it with g++ and holds fused_sample_u8_plain, the same
// arithmetic in numpy.
//
// Fixed-point scheme is OpenCV resize.cpp's 8U INTER_LINEAR path:
//   - per-axis coords: f = (float)((d + 0.5) * src/dst - 0.5),
//     s = floor(f), f -= s; edge clamp (s<0 -> s=0,f=0;
//     s>=src-1 -> s=src-1,f=0);
//   - short coefficients a = cvRound(c * 2048) (INTER_RESIZE_COEF_BITS=11);
//   - horizontal pass accumulates int32 rows r = a0*p0 + a1*p1;
//   - vertical combine (the 8U specialization, resize.cpp
//     VResizeLinear<uchar,int,short,...>):
//       dst = (((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tap {
  int32_t t0, t1;  // source indices (window coords), clamped
  int32_t a0, a1;  // 11-bit fixed-point weights
};

// Per-axis OpenCV INTER_LINEAR coordinate + coefficient rule (u8 path).
void make_taps(int src, int dst, std::vector<Tap>* taps) {
  taps->resize(dst);
  // OpenCV computes scale as 1/inv_scale (resize() takes inv_scale =
  // dst/src); replicating the double-rounding keeps coordinates
  // bit-identical.
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    // cv2 5.x keeps the fractional weight at the borders and replicates
    // the edge row/column (clamped tap indices, unclamped f) — the
    // weight split matters because the two fixed-point products round
    // independently in the vertical combine.
    Tap t;
    t.t0 = s < 0 ? 0 : (s > src - 1 ? src - 1 : s);
    t.t1 = s + 1 < 0 ? 0 : (s + 1 > src - 1 ? src - 1 : s + 1);
    // cvRound == lrintf under the default FE_TONEAREST mode
    t.a0 = static_cast<int32_t>(std::lrintf((1.f - f) * 2048.f));
    t.a1 = static_cast<int32_t>(std::lrintf(f * 2048.f));
    (*taps)[d] = t;
  }
}

}  // namespace

extern "C" int odtpu_fused_sample_u8(
    const uint8_t* src, int h, int w,       // pasted image, HxWx3 contiguous
    int top, int left,                      // paste offset on the canvas
    int x1, int y1, int x2, int y2,         // window rect, canvas coords
    int flip,                               // x-flip the window before resize
    const uint8_t* fill,                    // canvas color, 3 bytes
    uint8_t* out, int out_h, int out_w) {   // output, out_h x out_w x 3
  const int win_w = x2 - x1, win_h = y2 - y1;
  if (win_w <= 0 || win_h <= 0 || out_w <= 0 || out_h <= 0 ||
      h <= 0 || w <= 0) {
    return -1;
  }

  std::vector<Tap> xt, yt;
  make_taps(win_w, out_w, &xt);
  make_taps(win_h, out_h, &yt);

  const size_t rw = static_cast<size_t>(out_w) * 3;

  // Horizontal accumulator for an all-fill window row is row-invariant.
  std::vector<int32_t> fillrow(rw);
  for (int d = 0; d < out_w; ++d) {
    const Tap& t = xt[d];
    for (int c = 0; c < 3; ++c) {
      fillrow[static_cast<size_t>(d) * 3 + c] =
          (t.a0 + t.a1) * static_cast<int32_t>(fill[c]);
    }
  }

  // Horizontal pass for one window row (handles flip + paste mapping).
  auto hresize = [&](int wy, int32_t* dst) {
    const int iy = y1 + wy - top;  // window row -> image row
    if (iy < 0 || iy >= h) {
      std::memcpy(dst, fillrow.data(), sizeof(int32_t) * rw);
      return;
    }
    const uint8_t* srow = src + static_cast<size_t>(iy) * w * 3;
    for (int d = 0; d < out_w; ++d) {
      const Tap& t = xt[d];
      const int wx0 = flip ? win_w - 1 - t.t0 : t.t0;
      const int wx1 = flip ? win_w - 1 - t.t1 : t.t1;
      const int ix0 = x1 + wx0 - left;
      const int ix1 = x1 + wx1 - left;
      const uint8_t* p0 = (static_cast<unsigned>(ix0) <
                           static_cast<unsigned>(w))
                              ? srow + static_cast<size_t>(ix0) * 3
                              : fill;
      const uint8_t* p1 = (static_cast<unsigned>(ix1) <
                           static_cast<unsigned>(w))
                              ? srow + static_cast<size_t>(ix1) * 3
                              : fill;
      int32_t* o = dst + static_cast<size_t>(d) * 3;
      o[0] = t.a0 * p0[0] + t.a1 * p1[0];
      o[1] = t.a0 * p0[1] + t.a1 * p1[1];
      o[2] = t.a0 * p0[2] + t.a1 * p1[2];
    }
  };

  // Two-row cache; output rows visit source rows monotonically.
  std::vector<int32_t> bufA(rw), bufB(rw);
  int rowA = -1, rowB = -1;

  for (int dy = 0; dy < out_h; ++dy) {
    const Tap& t = yt[dy];
    const int32_t* r0 = rowA == t.t0 ? bufA.data()
                        : rowB == t.t0 ? bufB.data()
                                       : nullptr;
    if (r0 == nullptr) {
      if (rowB == t.t1) {  // keep the row the second tap needs
        hresize(t.t0, bufA.data());
        rowA = t.t0;
        r0 = bufA.data();
      } else {
        hresize(t.t0, bufB.data());
        rowB = t.t0;
        r0 = bufB.data();
      }
    }
    const int32_t* r1;
    if (t.t1 == t.t0) {
      r1 = r0;
    } else {
      r1 = rowA == t.t1 ? bufA.data() : rowB == t.t1 ? bufB.data() : nullptr;
      if (r1 == nullptr) {
        if (r0 == bufA.data()) {
          hresize(t.t1, bufB.data());
          rowB = t.t1;
          r1 = bufB.data();
        } else {
          hresize(t.t1, bufA.data());
          rowA = t.t1;
          r1 = bufA.data();
        }
      }
    }
    uint8_t* orow = out + static_cast<size_t>(dy) * rw;
    const int32_t b0 = t.a0, b1 = t.a1;
    for (size_t i = 0; i < rw; ++i) {
      orow[i] = static_cast<uint8_t>(
          (((b0 * (r0[i] >> 4)) >> 16) + ((b1 * (r1[i] >> 4)) >> 16) + 2) >>
          2);
    }
  }
  return 0;
}
