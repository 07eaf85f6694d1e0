// Native feature-store runtime: binary per-image records + threaded loader.
//
// Counterpart of the reference's binary feature/match file IO
// (SfM/src/database.cc:490-541 WriteoutImageFeature / :352-423
// ReadinImageFeatures) and its OpenMP-parallel readers: fixed-layout
// records written/read with raw I/O and a std::thread pool batch loader,
// exposed through a plain C ABI for ctypes (no pybind11 dependency).
//
// Record layout (little-endian):
//   magic  u32 = 0x4D534654 ("MSFT")
//   version u32 = 1
//   n_kps  u32, desc_dim u32
//   width  u32, height u32
//   focal  f32, reserved f32
//   xy     f32[n_kps*2]
//   sigma  f32[n_kps]
//   angle  f32[n_kps]
//   mask   u8[n_kps]
//   desc   f32[n_kps*desc_dim]

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4D534654u;
constexpr uint32_t kVersion = 1;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t n_kps;
  uint32_t desc_dim;
  uint32_t width;
  uint32_t height;
  float focal;
  float reserved;
};

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool read_all(FILE* f, void* p, size_t n) {
  return fread(p, 1, n, f) == n;
}

}  // namespace

extern "C" {

// Returns 0 on success.
int msf_write_features(const char* path, uint32_t n_kps, uint32_t desc_dim,
                       uint32_t width, uint32_t height, float focal,
                       const float* xy, const float* sigma, const float* angle,
                       const uint8_t* mask, const float* desc) {
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return 1;
  Header h{kMagic, kVersion, n_kps, desc_dim, width, height, focal, 0.0f};
  bool ok = write_all(f, &h, sizeof(h)) &&
            write_all(f, xy, sizeof(float) * n_kps * 2) &&
            write_all(f, sigma, sizeof(float) * n_kps) &&
            write_all(f, angle, sizeof(float) * n_kps) &&
            write_all(f, mask, sizeof(uint8_t) * n_kps) &&
            write_all(f, desc, sizeof(float) * n_kps * desc_dim);
  fclose(f);
  if (!ok) {
    remove(tmp.c_str());
    return 2;
  }
  if (rename(tmp.c_str(), path) != 0) {
    remove(tmp.c_str());
    return 3;
  }
  return 0;
}

// Reads the header only; returns 0 on success.
int msf_read_header(const char* path, uint32_t* n_kps, uint32_t* desc_dim,
                    uint32_t* width, uint32_t* height, float* focal) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Header h;
  bool ok = read_all(f, &h, sizeof(h)) && h.magic == kMagic &&
            h.version == kVersion;
  fclose(f);
  if (!ok) return 2;
  *n_kps = h.n_kps;
  *desc_dim = h.desc_dim;
  *width = h.width;
  *height = h.height;
  *focal = h.focal;
  return 0;
}

// Caller allocates buffers sized from msf_read_header. Returns 0 on success.
int msf_read_features(const char* path, float* xy, float* sigma, float* angle,
                      uint8_t* mask, float* desc) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Header h;
  if (!read_all(f, &h, sizeof(h)) || h.magic != kMagic) {
    fclose(f);
    return 2;
  }
  const uint32_t n = h.n_kps, d = h.desc_dim;
  bool ok = read_all(f, xy, sizeof(float) * n * 2) &&
            read_all(f, sigma, sizeof(float) * n) &&
            read_all(f, angle, sizeof(float) * n) &&
            read_all(f, mask, sizeof(uint8_t) * n) &&
            read_all(f, desc, sizeof(float) * n * d);
  fclose(f);
  return ok ? 0 : 3;
}

// Threaded batch descriptor loader: reads `count` records concurrently into
// one packed (count, n_kps, desc_dim) buffer (rows padded/truncated to
// n_kps). Returns number of files successfully read.
int msf_load_desc_batch(const char** paths, int count, uint32_t n_kps,
                        uint32_t desc_dim, float* out_desc, uint8_t* out_mask,
                        int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), done(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      FILE* f = fopen(paths[i], "rb");
      if (!f) continue;
      Header h;
      if (!read_all(f, &h, sizeof(h)) || h.magic != kMagic ||
          h.desc_dim != desc_dim) {
        fclose(f);
        continue;
      }
      const uint32_t n = h.n_kps < n_kps ? h.n_kps : n_kps;
      // skip xy/sigma/angle
      long skip = (long)sizeof(float) * h.n_kps * 4;
      fseek(f, skip, SEEK_CUR);
      std::vector<uint8_t> mask_buf(h.n_kps);
      if (!read_all(f, mask_buf.data(), h.n_kps)) {
        fclose(f);
        continue;
      }
      float* dst = out_desc + (size_t)i * n_kps * desc_dim;
      memset(dst, 0, sizeof(float) * n_kps * desc_dim);
      if (!read_all(f, dst, sizeof(float) * n * desc_dim)) {
        fclose(f);
        continue;
      }
      uint8_t* mdst = out_mask + (size_t)i * n_kps;
      memset(mdst, 0, n_kps);
      memcpy(mdst, mask_buf.data(), n);
      fclose(f);
      done.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return done.load();
}

}  // extern "C"
