// Native animated-GIF encoder for cpp_fluid_particles_tpu.
//
// The host-side native component of the framework: where the reference's
// native runtime is OpenGL presentation glue (src/ShaderUtility.cpp +
// GL/GLUT setup in src/main.cpp), a headless TPU framework's equivalent is
// fast frame encoding. The pure-Python LZW in utils/images.py is the
// fallback; this encoder is ~100x faster and is loaded via ctypes
// (runtime/native.py).
//
// Format: GIF89a, global 256-color palette (6x7x6 RGB cube + 4 grays),
// NETSCAPE loop extension, per-frame LZW with the standard 12-bit code
// table and clear-code reset.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinCodeSize = 8;
constexpr int kClear = 1 << kMinCodeSize;      // 256
constexpr int kEnd = kClear + 1;               // 257
constexpr int kMaxCode = 4096;

struct BitWriter {
  std::vector<uint8_t> out;
  uint32_t cur = 0;
  int nbits = 0;

  void emit(int code, int code_size) {
    cur |= static_cast<uint32_t>(code) << nbits;
    nbits += code_size;
    while (nbits >= 8) {
      out.push_back(static_cast<uint8_t>(cur & 0xFF));
      cur >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) out.push_back(static_cast<uint8_t>(cur & 0xFF));
    cur = 0;
    nbits = 0;
  }
};

// LZW string table as a prefix-tree: node = (prefix code, next byte).
struct Lzw {
  // children[code * 256 + byte] -> next code (0 = none)
  std::vector<int32_t> children;
  int next_code = kEnd + 1;
  int code_size = kMinCodeSize + 1;

  Lzw() : children(kMaxCode * 256, 0) {}

  void reset() {
    std::fill(children.begin(), children.end(), 0);
    next_code = kEnd + 1;
    code_size = kMinCodeSize + 1;
  }
};

void lzw_encode(const uint8_t* data, size_t n, BitWriter& bw) {
  Lzw t;
  bw.emit(kClear, t.code_size);
  if (n == 0) {
    bw.emit(kEnd, t.code_size);
    bw.flush();
    return;
  }
  int cur = data[0];
  for (size_t i = 1; i < n; ++i) {
    const uint8_t ch = data[i];
    const int32_t nxt = t.children[cur * 256 + ch];
    if (nxt != 0) {
      cur = nxt;
      continue;
    }
    bw.emit(cur, t.code_size);
    t.children[cur * 256 + ch] = t.next_code;
    t.next_code++;
    if (t.next_code > (1 << t.code_size) && t.code_size < 12) {
      t.code_size++;
    } else if (t.next_code >= kMaxCode) {
      bw.emit(kClear, t.code_size);
      t.reset();
    }
    cur = ch;
  }
  bw.emit(cur, t.code_size);
  bw.emit(kEnd, t.code_size);
  bw.flush();
}

void put16(std::vector<uint8_t>& v, int x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
}

// 6x7x6 cube + 4 grays == the palette in utils/images.py
void palette(std::vector<uint8_t>& v) {
  const double rs[6] = {0, 51, 102, 153, 204, 255};
  const double gs[7] = {0, 42.5, 85, 127.5, 170, 212.5, 255};
  for (int r = 0; r < 6; ++r)
    for (int g = 0; g < 7; ++g)
      for (int b = 0; b < 6; ++b) {
        v.push_back(static_cast<uint8_t>(rs[r] + 0.5));
        v.push_back(static_cast<uint8_t>(gs[g] + 0.5));
        v.push_back(static_cast<uint8_t>(rs[b] + 0.5));
      }
  const int grays[4][3] = {{40, 40, 40}, {120, 120, 120},
                           {200, 200, 200}, {255, 255, 255}};
  for (auto& g : grays) {
    v.push_back(g[0]);
    v.push_back(g[1]);
    v.push_back(g[2]);
  }
}

inline uint8_t quantize(uint8_t r, uint8_t g, uint8_t b) {
  const int ri = (r * 5 + 127) / 255;
  const int gi = (g * 6 + 127) / 255;
  const int bi = (b * 5 + 127) / 255;
  return static_cast<uint8_t>((ri * 7 + gi) * 6 + bi);
}

// Nearest-palette LUT over a 32^3 RGB lattice (same scheme as the Python
// fallback's _quantize_lut: lattice value i*255/31, pixel bucket v>>3,
// first-min tie-breaking), so custom palettes (e.g. the renderer's density
// ramp) ride the native path too.
void build_lut(const uint8_t* pal, std::vector<uint8_t>& lut) {
  lut.resize(32 * 32 * 32);
  double lat[32];
  for (int i = 0; i < 32; ++i) lat[i] = i * 255.0 / 31.0;
  for (int r = 0; r < 32; ++r)
    for (int g = 0; g < 32; ++g)
      for (int b = 0; b < 32; ++b) {
        double best = 1e30;
        int best_i = 0;
        for (int p = 0; p < 256; ++p) {
          const double dr = lat[r] - pal[p * 3];
          const double dg = lat[g] - pal[p * 3 + 1];
          const double db = lat[b] - pal[p * 3 + 2];
          const double d = dr * dr + dg * dg + db * db;
          if (d < best) {
            best = d;
            best_i = p;
          }
        }
        lut[(r * 32 + g) * 32 + b] = static_cast<uint8_t>(best_i);
      }
}

}  // namespace

extern "C" {

// frames: n_frames * h * w * 3 uint8 RGB. delay_cs: per-frame delay in
// centiseconds. pal: optional 256*3 uint8 RGB palette (nullptr -> builtin
// 6x7x6 cube). Returns 0 on success, negative errno-style on failure.
int cfp_write_gif_pal(const char* path, const uint8_t* frames, int n_frames,
                      int h, int w, int delay_cs, const uint8_t* pal) {
  if (n_frames <= 0 || h <= 0 || w <= 0) return -22;
  std::vector<uint8_t> lut;
  if (pal != nullptr) build_lut(pal, lut);
  std::vector<uint8_t> buf;
  buf.reserve(1 << 20);
  const char hdr[] = "GIF89a";
  buf.insert(buf.end(), hdr, hdr + 6);
  put16(buf, w);
  put16(buf, h);
  buf.push_back(0xF7);  // global color table, 256 entries
  buf.push_back(0);
  buf.push_back(0);
  if (pal != nullptr) {
    buf.insert(buf.end(), pal, pal + 256 * 3);
  } else {
    palette(buf);
  }
  // NETSCAPE loop-forever
  const uint8_t loop[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A',
                          'P', 'E', '2', '.', '0', 0x03, 0x01, 0x00, 0x00,
                          0x00};
  buf.insert(buf.end(), loop, loop + sizeof(loop));

  std::vector<uint8_t> idx(static_cast<size_t>(h) * w);
  for (int f = 0; f < n_frames; ++f) {
    const uint8_t* fr = frames + static_cast<size_t>(f) * h * w * 3;
    if (pal != nullptr) {
      for (size_t p = 0; p < idx.size(); ++p) {
        const int r = fr[p * 3] >> 3, g = fr[p * 3 + 1] >> 3,
                  b = fr[p * 3 + 2] >> 3;
        idx[p] = lut[(r * 32 + g) * 32 + b];
      }
    } else {
      for (size_t p = 0; p < idx.size(); ++p) {
        idx[p] = quantize(fr[p * 3], fr[p * 3 + 1], fr[p * 3 + 2]);
      }
    }
    // graphics control
    buf.push_back(0x21);
    buf.push_back(0xF9);
    buf.push_back(0x04);
    buf.push_back(0x04);
    put16(buf, delay_cs);
    buf.push_back(0x00);
    buf.push_back(0x00);
    // image descriptor
    buf.push_back(0x2C);
    put16(buf, 0);
    put16(buf, 0);
    put16(buf, w);
    put16(buf, h);
    buf.push_back(0x00);
    buf.push_back(kMinCodeSize);
    BitWriter bw;
    lzw_encode(idx.data(), idx.size(), bw);
    for (size_t off = 0; off < bw.out.size(); off += 255) {
      const size_t len = std::min<size_t>(255, bw.out.size() - off);
      buf.push_back(static_cast<uint8_t>(len));
      buf.insert(buf.end(), bw.out.begin() + off, bw.out.begin() + off + len);
    }
    buf.push_back(0x00);
  }
  buf.push_back(0x3B);

  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -2;
  const size_t written = std::fwrite(buf.data(), 1, buf.size(), fp);
  std::fclose(fp);
  return written == buf.size() ? 0 : -5;
}

int cfp_write_gif(const char* path, const uint8_t* frames, int n_frames,
                  int h, int w, int delay_cs) {
  return cfp_write_gif_pal(path, frames, n_frames, h, w, delay_cs, nullptr);
}

}  // extern "C"
