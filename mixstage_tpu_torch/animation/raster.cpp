// Skeleton rasteriser and GIF encoder of the render path (host C++).
//
// The port's copy of mixstage_tpu/native/raster.cpp, the same code: the
// reference (chahuja/mix-stage, src/animation/animation.py:101-249) renders
// pose videos through matplotlib FuncAnimation + ffmpeg, rebuilding per
// frame ~J LineCollections of 100 tapered segments; this library rasterises
// the same visual primitive directly: each bone is an anti-aliased
// "tapered capsule" (distance to the segment, with a linewidth that ramps
// min->peak->min along the bone, the width profile of the reference's
// lwidths arrays, animation.py:44-76) alpha-blended into an RGB frame.
//
// Built at first use by mixstage_tpu_torch/animation/raster.py with g++
// (-O3 -march=native -fPIC -shared -std=c++17 -pthread) and loaded through
// ctypes; raster.py's numpy version of the same math is its plain version.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void blend(uint8_t* px, const uint8_t* rgb, float a) {
  for (int c = 0; c < 3; ++c) {
    float v = px[c] * (1.0f - a) + rgb[c] * a;
    px[c] = (uint8_t)(v + 0.5f);
  }
}

// Rasterize one panel's skeleton into img (img_w px wide rows, RGB),
// starting at column col_off.  pose is (2, J): pose[j] = x, pose[J + j] = y
// in world coords (y screen-down, i.e. the raw PATS pose convention — the
// matplotlib path negates y and flips the axis, which composes to the same
// orientation).
void raster_frame(const float* pose, int64_t J, const int32_t* parents,
                  const uint8_t* colors, const float* peak_w, float min_w,
                  int64_t panel, float world_half, float scale,
                  uint8_t* img, int64_t img_w, int64_t col_off) {
  for (int64_t j = 1; j < J; ++j) {
    const int32_t p = parents[j];
    if (p < 0) continue;
    const float x0 = (pose[p] + world_half) * scale;
    const float y0 = (pose[J + p] + world_half) * scale;
    const float x1 = (pose[j] + world_half) * scale;
    const float y1 = (pose[J + j] + world_half) * scale;
    const float half_min = 0.5f * min_w;
    const float half_peak = 0.5f * std::max(peak_w[j - 1], min_w);
    const float rmax = half_peak + 1.0f;
    const float dx = x1 - x0, dy = y1 - y0;
    const float len2 = dx * dx + dy * dy;
    const uint8_t* rgb = colors + (j - 1) * 3;
    // Walk the capsule in short chunks so the scanned area is
    // O(length × width), not O(bbox area) — a near-diagonal bone across the
    // panel would otherwise touch panel² pixels.  Each pixel is claimed by
    // exactly one chunk via its clamped-t range, so the per-pixel math (and
    // hence the output) is identical to a single full-bbox pass.
    if (!std::isfinite(x0 + y0 + x1 + y1)) continue;
    const float seg_len = std::sqrt(len2);
    const int64_t n_chunks =
        std::max<int64_t>(1, (int64_t)std::ceil(seg_len / 32.0f));
    // clip the walk to the t-window where the capsule can touch the panel
    // (skipped pixels clamp to a nearest point > rmax off-panel → alpha 0)
    float t_lo = 0.0f, t_hi = 1.0f;
    const auto clip_axis = [&](float p0, float d, float lo, float hi) {
      if (std::fabs(d) < 1e-12f) {
        if (p0 < lo || p0 > hi) { t_lo = 1.0f; t_hi = -1.0f; }
        return;
      }
      float a = (lo - p0) / d, b = (hi - p0) / d;
      if (a > b) std::swap(a, b);
      t_lo = std::max(t_lo, a);
      t_hi = std::min(t_hi, b);
    };
    clip_axis(x0, dx, -rmax, (float)panel + rmax);
    clip_axis(y0, dy, -rmax, (float)panel + rmax);
    if (t_lo > t_hi) continue;  // capsule fully off-panel
    const int64_t k_begin =
        std::max<int64_t>(0, (int64_t)std::floor(t_lo * n_chunks));
    const int64_t k_end =
        std::min<int64_t>(n_chunks, (int64_t)std::ceil(t_hi * n_chunks));
    for (int64_t k = k_begin; k < k_end; ++k) {
      const float ta = (float)k / n_chunks;
      const float tb = (float)(k + 1) / n_chunks;
      const bool last = (k == n_chunks - 1);
      const float ax = x0 + ta * dx, ay = y0 + ta * dy;
      const float bx = x0 + tb * dx, by = y0 + tb * dy;
      int64_t c0 = (int64_t)std::floor(std::min(ax, bx) - rmax);
      int64_t c1 = (int64_t)std::ceil(std::max(ax, bx) + rmax);
      int64_t r0 = (int64_t)std::floor(std::min(ay, by) - rmax);
      int64_t r1 = (int64_t)std::ceil(std::max(ay, by) + rmax);
      c0 = std::max<int64_t>(c0, 0);
      r0 = std::max<int64_t>(r0, 0);
      c1 = std::min<int64_t>(c1, panel - 1);
      r1 = std::min<int64_t>(r1, panel - 1);
      for (int64_t r = r0; r <= r1; ++r) {
        uint8_t* rowpx = img + (r * img_w + col_off) * 3;
        const float py = r + 0.5f;
        for (int64_t c = c0; c <= c1; ++c) {
          const float px = c + 0.5f;
          float t = len2 > 0.0f ? ((px - x0) * dx + (py - y0) * dy) / len2
                                : 0.0f;
          t = std::min(1.0f, std::max(0.0f, t));
          if (t < ta || (!last && t >= tb)) continue;  // another chunk's pixel
          const float qx = x0 + t * dx - px;
          const float qy = y0 + t * dy - py;
          const float d = std::sqrt(qx * qx + qy * qy);
          const float radius =
              half_min + (half_peak - half_min) *
                             (1.0f - std::fabs(2.0f * t - 1.0f));
          float a = radius - d + 0.5f;  // 1px anti-aliasing ramp
          if (a <= 0.0f) continue;
          if (a > 1.0f) a = 1.0f;
          blend(rowpx + c * 3, rgb, a);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// ys:      (P, T, 2, J) float32 — P side-by-side panels (e.g. pred + GT)
// parents: (J,) int32, parents[0] (root) < 0
// colors:  (J-1, 3) uint8 per-bone RGB
// peak_w:  (J-1,) float32 peak linewidth in px (taper min_w -> peak -> min_w)
// out:     (T, panel, P*panel, 3) uint8, caller-allocated; filled here
//          (white background) — threads split the frame range.
void rasterize_poses(const float* ys, int64_t P, int64_t T, int64_t J,
                     const int32_t* parents, const uint8_t* colors,
                     const float* peak_w, float min_w, int64_t panel,
                     float world_half, int64_t n_threads, uint8_t* out) {
  const int64_t img_w = P * panel;
  const float scale = panel / (2.0f * world_half);
  auto work = [&](int64_t t_begin, int64_t t_end) {
    for (int64_t t = t_begin; t < t_end; ++t) {
      uint8_t* img = out + t * panel * img_w * 3;
      std::memset(img, 0xFF, (size_t)(panel * img_w * 3));
      for (int64_t p = 0; p < P; ++p) {
        const float* pose = ys + ((p * T + t) * 2) * J;
        raster_frame(pose, J, parents, colors, peak_w, min_w, panel,
                     world_half, scale, img, img_w, p * panel);
      }
    }
  };
  const int64_t nt = std::max<int64_t>(
      1, std::min<int64_t>(n_threads, T));
  if (nt == 1) {
    work(0, T);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (T + nt - 1) / nt;
  for (int64_t i = 0; i < nt; ++i) {
    const int64_t a = i * chunk;
    const int64_t b = std::min<int64_t>(T, a + chunk);
    if (a >= b) break;
    threads.emplace_back(work, a, b);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

// ------------------------------------------------------------- GIF encoder
//
// Minimal GIF89a writer (global 256-color table, LZW, NETSCAPE loop) so the
// video path without ffmpeg needs no PIL and pays no per-frame median-cut
// quantization: the caller passes the palette the
// rasterizer drew from, and RGB→index mapping is a nearest-palette lookup
// memoized per distinct RGB triple.

namespace {

struct ByteSink {
  uint8_t* buf;
  int64_t cap;
  int64_t n = 0;
  bool overflow = false;
  inline void put(uint8_t b) {
    if (n < cap) buf[n++] = b;
    else overflow = true;
  }
  inline void put16(uint16_t v) {
    put((uint8_t)(v & 0xFF));
    put((uint8_t)(v >> 8));
  }
  inline void write(const uint8_t* p, int64_t len) {
    for (int64_t i = 0; i < len; ++i) put(p[i]);
  }
};

// LZW with sub-block framing.  Dictionary: (prefix_code << 8 | byte) →
// code via a direct-mapped table with generation counters (no per-clear
// memset).
class LzwGifEncoder {
 public:
  explicit LzwGifEncoder(ByteSink* sink) : sink_(sink) {
    table_.resize(1 << 20, 0);
    gen_tbl_.resize(1 << 20, 0);
  }

  void encode(const uint8_t* indices, int64_t n) {
    sink_->put(8);  // LZW minimum code size (256-color palette)
    bits_ = 0;
    nbits_ = 0;
    block_len_ = 0;
    clear();
    emit(kClear);
    if (n == 0) {
      emit(kEnd);
      finish();
      return;
    }
    int32_t prefix = indices[0];
    for (int64_t i = 1; i < n; ++i) {
      const uint8_t c = indices[i];
      const uint32_t key = ((uint32_t)prefix << 8) | c;
      if (gen_tbl_[key] == gen_) {
        prefix = table_[key];
        continue;
      }
      emit(prefix);
      if (next_code_ < 4096) {
        table_[key] = next_code_;
        gen_tbl_[key] = gen_;
        ++next_code_;
        // the decoder defines entries one code behind the encoder, so the
        // code-size bump lands one code later than the table-fill point
        if (next_code_ > (1 << code_size_) && code_size_ < 12)
          ++code_size_;
      } else {
        emit(kClear);
        clear();
      }
      prefix = c;
    }
    emit(prefix);
    emit(kEnd);
    finish();
  }

 private:
  static constexpr int32_t kClear = 256;
  static constexpr int32_t kEnd = 257;

  void clear() {
    ++gen_;
    next_code_ = 258;
    code_size_ = 9;
  }

  void emit(int32_t code) {
    bits_ |= (uint32_t)code << nbits_;
    nbits_ += code_size_;
    while (nbits_ >= 8) {
      block_[block_len_++] = (uint8_t)(bits_ & 0xFF);
      bits_ >>= 8;
      nbits_ -= 8;
      if (block_len_ == 255) flush_block();
    }
  }

  void finish() {
    if (nbits_ > 0) {
      block_[block_len_++] = (uint8_t)(bits_ & 0xFF);
      if (block_len_ == 255) flush_block();
    }
    if (block_len_ > 0) flush_block();
    sink_->put(0);  // block terminator
  }

  void flush_block() {
    sink_->put((uint8_t)block_len_);
    sink_->write(block_, block_len_);
    block_len_ = 0;
  }

  ByteSink* sink_;
  std::vector<int32_t> table_;
  std::vector<int32_t> gen_tbl_;
  int32_t gen_ = 0;
  int32_t next_code_ = 258;
  int code_size_ = 9;
  uint32_t bits_ = 0;
  int nbits_ = 0;
  uint8_t block_[256];
  int block_len_ = 0;
};

// Memoized nearest-palette mapper (open-addressed hash over 24-bit RGB).
class PaletteMapper {
 public:
  PaletteMapper(const uint8_t* palette, int n_colors)
      : pal_(palette), n_(n_colors) {
    keys_.resize(kSlots, -1);
    vals_.resize(kSlots, 0);
  }

  inline uint8_t map(uint8_t r, uint8_t g, uint8_t b) {
    const int32_t key = ((int32_t)r << 16) | ((int32_t)g << 8) | b;
    uint32_t slot = ((uint32_t)key * 2654435761u) & (kSlots - 1);
    while (keys_[slot] != -1) {
      if (keys_[slot] == key) return vals_[slot];
      slot = (slot + 1) & (kSlots - 1);
    }
    int best = 0;
    int64_t best_d = INT64_MAX;
    for (int i = 0; i < n_; ++i) {
      const int64_t dr = (int64_t)r - pal_[i * 3];
      const int64_t dg = (int64_t)g - pal_[i * 3 + 1];
      const int64_t db = (int64_t)b - pal_[i * 3 + 2];
      const int64_t d = dr * dr + dg * dg + db * db;
      if (d < best_d) {
        best_d = d;
        best = i;
      }
    }
    // stop memoizing near full occupancy: an always-full open-addressed
    // table would probe forever on the next unseen color
    if (occupied_ < kSlots - (kSlots >> 2)) {
      keys_[slot] = key;
      vals_[slot] = (uint8_t)best;
      ++occupied_;
    }
    return (uint8_t)best;
  }

 private:
  static constexpr uint32_t kSlots = 1 << 20;
  const uint8_t* pal_;
  int n_;
  uint32_t occupied_ = 0;
  std::vector<int32_t> keys_;
  std::vector<uint8_t> vals_;
};

}  // namespace

extern "C" {

// frames:  (T, H, W, 3) uint8
// palette: (n_colors, 3) uint8, n_colors <= 256 (padded to 256 in the file)
// delay_cs: per-frame delay in 1/100 s
// write_header: nonzero → emit the GIF89a header + global palette +
//   NETSCAPE loop extension first.  The 1-byte trailer (0x3B) is NOT
//   written here — the caller appends it after the last chunk, which lets
//   long clips stream through this function in bounded-memory chunks.
// has_prev/prev_frame: when nonzero, ``prev_frame`` (H*W*3) is the frame
//   that precedes frames[0] in the SAME gif (the last frame of the previous
//   chunk) — every frame is then delta-encoded as the bounding rectangle of
//   pixels that changed vs its predecessor (GIF image descriptors place
//   sub-rects; disposal "do not dispose" keeps the rest).  When zero,
//   frames[0] is the first frame of the file and is encoded full-size.
// out:     caller-allocated output buffer (cap bytes)
// Returns bytes written, or -1 if out was too small.
int64_t encode_gif(const uint8_t* frames, int64_t T, int64_t H, int64_t W,
                   const uint8_t* palette, int64_t n_colors,
                   int64_t delay_cs, int64_t write_header, int64_t has_prev,
                   const uint8_t* prev_frame, uint8_t* out, int64_t cap) {
  ByteSink sink{out, cap};
  if (write_header) {
    const uint8_t hdr[6] = {'G', 'I', 'F', '8', '9', 'a'};
    sink.write(hdr, 6);
    sink.put16((uint16_t)W);
    sink.put16((uint16_t)H);
    sink.put(0xF7);  // global color table, 8 bits/pixel, 256 entries
    sink.put(0);     // background color index
    sink.put(0);     // aspect
    for (int i = 0; i < 256; ++i) {
      if (i < n_colors) {
        sink.write(palette + i * 3, 3);
      } else {
        sink.put(0);
        sink.put(0);
        sink.put(0);
      }
    }
    // NETSCAPE2.0 looping extension (loop forever)
    const uint8_t netscape[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C',
                                'A',  'P',  'E',  '2', '.', '0', 0x03, 0x01,
                                0x00, 0x00, 0x00};
    sink.write(netscape, sizeof(netscape));
  }

  PaletteMapper mapper(palette, (int)n_colors);
  std::vector<uint8_t> indices((size_t)(H * W));
  LzwGifEncoder lzw(&sink);
  for (int64_t t = 0; t < T; ++t) {
    const uint8_t* fr = frames + t * H * W * 3;
    const uint8_t* ref =
        t > 0 ? frames + (t - 1) * H * W * 3 : (has_prev ? prev_frame : nullptr);
    // dirty rectangle vs the previous frame (full frame when no reference)
    int64_t r0 = 0, r1 = H - 1, c0 = 0, c1 = W - 1;
    if (ref != nullptr) {
      r0 = H;
      r1 = -1;
      c0 = W;
      c1 = -1;
      for (int64_t r = 0; r < H; ++r) {
        const uint8_t* a = fr + r * W * 3;
        const uint8_t* b = ref + r * W * 3;
        if (std::memcmp(a, b, (size_t)(W * 3)) == 0) continue;
        if (r < r0) r0 = r;
        r1 = r;
        int64_t c = 0;
        while (c < c0 && std::memcmp(a + c * 3, b + c * 3, 3) == 0) ++c;
        if (c < c0) c0 = c;
        int64_t ce = W - 1;
        while (ce > c1 && std::memcmp(a + ce * 3, b + ce * 3, 3) == 0) --ce;
        if (ce > c1) c1 = ce;
      }
      if (r1 < r0) {  // identical frame: emit a 1×1 rect to carry the delay
        r0 = r1 = 0;
        c0 = c1 = 0;
      }
    }
    const int64_t rw = c1 - c0 + 1, rh = r1 - r0 + 1;
    // graphic control extension: disposal "do not dispose"; delta frames
    // additionally declare palette slot 255 transparent so unchanged pixels
    // inside the rect compress to one long LZW run
    const uint8_t kTransparent = 255;  // palette is padded past n_colors
    sink.put(0x21);
    sink.put(0xF9);
    sink.put(0x04);
    sink.put(ref != nullptr ? 0x05 : 0x04);
    sink.put16((uint16_t)delay_cs);
    sink.put(ref != nullptr ? kTransparent : 0);
    sink.put(0);  // terminator
    // image descriptor: the dirty sub-rectangle
    sink.put(0x2C);
    sink.put16((uint16_t)c0);
    sink.put16((uint16_t)r0);
    sink.put16((uint16_t)rw);
    sink.put16((uint16_t)rh);
    sink.put(0);  // no local color table
    for (int64_t r = 0; r < rh; ++r) {
      const uint8_t* row = fr + ((r0 + r) * W + c0) * 3;
      const uint8_t* refrow =
          ref != nullptr ? ref + ((r0 + r) * W + c0) * 3 : nullptr;
      uint8_t* dst = indices.data() + r * rw;
      for (int64_t c = 0; c < rw; ++c) {
        if (refrow != nullptr && std::memcmp(row + c * 3, refrow + c * 3, 3) == 0) {
          dst[c] = kTransparent;  // unchanged: keep the composited pixel
        } else {
          dst[c] = mapper.map(row[c * 3], row[c * 3 + 1], row[c * 3 + 2]);
        }
      }
    }
    lzw.encode(indices.data(), rw * rh);
    if (sink.overflow) return -1;
  }
  return sink.overflow ? -1 : sink.n;
}

}  // extern "C"
