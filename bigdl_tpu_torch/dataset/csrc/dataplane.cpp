// Native host-side data plane of bigdl_tpu_torch: the port's copy of
// native/dataplane.cpp, built by bigdl_tpu_torch/dataset/native.py with
// g++ into bigdl_tpu_torch/ops/build/ and bound through ctypes.
//
// Reference parity: the reference's native layer is C/C++ behind JNI
// (BigDL-core: libjmkl / mkldnn / bigquant .so, SURVEY.md §2.1); its data
// plane rides Spark executors (JVM). Here the native layer is the HOST
// input pipeline that has to keep the card fed (SURVEY.md §7 "Input
// pipeline throughput" hard part). This library provides:
//
//   * batched image preprocessing kernels (u8→f32 normalize, random crop
//     with zero padding, horizontal flip) parallelized with std::thread
//   * IDX (MNIST) and CIFAR-10 binary decoding
//   * a multithreaded prefetcher: worker threads produce shuffled,
//     augmented, normalized f32 batches into a bounded ring buffer while
//     the training loop (and the card) consume previous ones.
//
// One change from native/dataplane.cpp: the normalize divides by std
// where the original multiplies by its reciprocal, so every value equals
// the Python plane's numpy (x - mean) / std bit for bit.
//
// C ABI throughout — consumed from Python via ctypes, no pybind11.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- kernels

// u8 (N,H,W,C) -> f32 (N,H,W,C), per-channel (x - mean[c]) / std[c]
void bdl_normalize_u8(const uint8_t* src, float* dst, int64_t n_pix,
                      int c, const float* mean, const float* stdd,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  // divides (no reciprocal): each value is numpy's fp32
  // (x - mean) / std bit for bit, so this plane's batches equal the
  // Python plane's
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int ch = static_cast<int>(i % c);
      dst[i] = (static_cast<float>(src[i]) - mean[ch]) / stdd[ch];
    }
  };
  int64_t total = n_pix * c;
  if (n_threads == 1 || total < (1 << 16)) {
    work(0, total);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (total + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(total, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// f32 NHWC batch horizontal flip in place for rows where flags[i] != 0
void bdl_hflip(float* img, const uint8_t* flags, int n, int h, int w,
               int c) {
  for (int i = 0; i < n; ++i) {
    if (!flags[i]) continue;
    float* base = img + static_cast<int64_t>(i) * h * w * c;
    for (int y = 0; y < h; ++y) {
      float* row = base + static_cast<int64_t>(y) * w * c;
      for (int x = 0; x < w / 2; ++x)
        for (int ch = 0; ch < c; ++ch)
          std::swap(row[x * c + ch], row[(w - 1 - x) * c + ch]);
    }
  }
}

// f32 NHWC random crop with zero padding: src (n,h,w,c) -> dst (n,h,w,c)
// shifted by per-image offsets in [-pad, pad] (offy/offx arrays).
void bdl_shift_crop(const float* src, float* dst, const int* offy,
                    const int* offx, int n, int h, int w, int c) {
  const int64_t img_sz = static_cast<int64_t>(h) * w * c;
  for (int i = 0; i < n; ++i) {
    const float* s = src + i * img_sz;
    float* d = dst + i * img_sz;
    std::memset(d, 0, img_sz * sizeof(float));
    int dy = offy[i], dx = offx[i];
    int y0 = std::max(0, dy), y1 = std::min(h, h + dy);
    int x0 = std::max(0, dx), x1 = std::min(w, w + dx);
    for (int y = y0; y < y1; ++y) {
      const float* srow = s + (static_cast<int64_t>(y - dy) * w + (x0 - dx)) * c;
      float* drow = d + (static_cast<int64_t>(y) * w + x0) * c;
      std::memcpy(drow, srow, static_cast<int64_t>(x1 - x0) * c * sizeof(float));
    }
  }
}

// f32 HWC bilinear resize (align_corners=False, the TF/torch default):
// src (h, w, c) -> dst (oh, ow, c). Multithreaded over output rows.
// Matches dataset/vision.py's pure-numpy implementation.
void bdl_resize_bilinear(const float* src, float* dst, int h, int w,
                         int c, int oh, int ow, int n_threads) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  auto work = [&](int lo, int hi) {
    std::vector<int> x0s(ow), x1s(ow);
    std::vector<float> fxs(ow);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      x0s[x] = x0;
      x1s[x] = std::min(x0 + 1, w - 1);
      fxs[x] = fx - x0;
    }
    for (int y = lo; y < hi; ++y) {
      float fy = (y + 0.5f) * sy - 0.5f;
      if (fy < 0) fy = 0;
      int y0 = static_cast<int>(fy);
      int y1 = std::min(y0 + 1, h - 1);
      float wy = fy - y0;
      const float* r0 = src + static_cast<int64_t>(y0) * w * c;
      const float* r1 = src + static_cast<int64_t>(y1) * w * c;
      float* out = dst + static_cast<int64_t>(y) * ow * c;
      for (int x = 0; x < ow; ++x) {
        const float* a = r0 + x0s[x] * c;
        const float* b = r0 + x1s[x] * c;
        const float* d = r1 + x0s[x] * c;
        const float* e = r1 + x1s[x] * c;
        float wx = fxs[x];
        for (int ch = 0; ch < c; ++ch) {
          float top = a[ch] + (b[ch] - a[ch]) * wx;
          float bot = d[ch] + (e[ch] - d[ch]) * wx;
          out[x * c + ch] = top + (bot - top) * wy;
        }
      }
    }
  };
  if (n_threads < 2 || oh < 2 * n_threads) {
    work(0, oh);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (oh + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(oh, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------- decoders

// IDX3 images: returns 0 on success; out must hold n*rows*cols bytes.
int bdl_decode_idx_images(const uint8_t* buf, int64_t len, uint8_t* out,
                          int64_t* out_n, int64_t* out_rows,
                          int64_t* out_cols) {
  if (len < 16) return -1;
  auto be32 = [&](int64_t off) {
    return (static_cast<uint32_t>(buf[off]) << 24) |
           (static_cast<uint32_t>(buf[off + 1]) << 16) |
           (static_cast<uint32_t>(buf[off + 2]) << 8) |
           static_cast<uint32_t>(buf[off + 3]);
  };
  if (be32(0) != 2051) return -2;
  int64_t n = be32(4), rows = be32(8), cols = be32(12);
  if (len < 16 + n * rows * cols) return -3;
  *out_n = n; *out_rows = rows; *out_cols = cols;
  if (out) std::memcpy(out, buf + 16, n * rows * cols);
  return 0;
}

int bdl_decode_idx_labels(const uint8_t* buf, int64_t len, uint8_t* out,
                          int64_t* out_n) {
  if (len < 8) return -1;
  uint32_t magic = (static_cast<uint32_t>(buf[0]) << 24) |
                   (static_cast<uint32_t>(buf[1]) << 16) |
                   (static_cast<uint32_t>(buf[2]) << 8) |
                   static_cast<uint32_t>(buf[3]);
  if (magic != 2049) return -2;
  int64_t n = (static_cast<uint32_t>(buf[4]) << 24) |
              (static_cast<uint32_t>(buf[5]) << 16) |
              (static_cast<uint32_t>(buf[6]) << 8) |
              static_cast<uint32_t>(buf[7]);
  if (len < 8 + n) return -3;
  *out_n = n;
  if (out) std::memcpy(out, buf + 8, n);
  return 0;
}

// CIFAR-10 binary: records of [label u8][3072 u8 CHW] -> NHWC u8 + labels
int bdl_decode_cifar10(const uint8_t* buf, int64_t len, uint8_t* images,
                       uint8_t* labels, int64_t* out_n) {
  const int64_t rec = 1 + 3 * 32 * 32;
  int64_t n = len / rec;
  if (n * rec != len) return -1;
  *out_n = n;
  if (!images) return 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* r = buf + i * rec;
    labels[i] = r[0];
    const uint8_t* chw = r + 1;
    uint8_t* img = images + i * 3072;
    for (int y = 0; y < 32; ++y)
      for (int x = 0; x < 32; ++x)
        for (int ch = 0; ch < 3; ++ch)
          img[(y * 32 + x) * 3 + ch] = chw[ch * 1024 + y * 32 + x];
  }
  return 0;
}

// ------------------------------------------------------- BDLS shard files
//
// Disk-resident fixed-record image shards (the TPU-era counterpart of
// the reference's ImageNet sequence files, dataset/image/ + SURVEY.md
// §2.4): 32-byte header then n records of [label i32 LE][h*w*c u8].
// Shards are mmap()ed, so datasets far larger than RAM stream through
// the OS page cache with zero-copy reads in the workers.

struct BdlsHeader {
  char magic[4];      // "BDLS"
  uint32_t version;   // 1
  uint64_t n;
  uint32_t h, w, c;
  uint32_t reserved;
};
static_assert(sizeof(BdlsHeader) == 32, "BDLS header must be 32 bytes");

struct MappedShard {
  int fd = -1;
  void* map = nullptr;
  size_t len = 0;
  const uint8_t* base = nullptr;  // first record
  int64_t n = 0;
};

// Returns 0 on success. Fills header fields; on success the shard is
// mapped read-only with MADV_WILLNEED left to the kernel's readahead.
static int map_shard(const char* path, MappedShard* out, BdlsHeader* hdr) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(BdlsHeader)) {
    ::close(fd);
    return -2;
  }
  void* m = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    ::close(fd);
    return -3;
  }
  std::memcpy(hdr, m, sizeof(BdlsHeader));
  if (std::memcmp(hdr->magic, "BDLS", 4) != 0 || hdr->version != 1) {
    ::munmap(m, st.st_size);
    ::close(fd);
    return -4;
  }
  // bound each dim before multiplying: h*w*c of hostile u32 headers can
  // overflow int64 and wrap to a small positive rec, defeating the
  // division-form check below (65535^3 alone is within int64, but the
  // bound also keeps rec sane for the prefetch arithmetic downstream)
  if (hdr->h == 0 || hdr->w == 0 || hdr->c == 0 ||
      hdr->h > (1u << 16) || hdr->w > (1u << 16) || hdr->c > (1u << 10)) {
    ::munmap(m, st.st_size);
    ::close(fd);
    return -4;
  }
  const int64_t rec = 4 + static_cast<int64_t>(hdr->h) * hdr->w * hdr->c;
  // division form: the multiplication `rec * n` could wrap for a
  // corrupt/hostile header and bypass validation
  const uint64_t payload = st.st_size - sizeof(BdlsHeader);
  if (hdr->n > payload / static_cast<uint64_t>(rec)) {
    ::munmap(m, st.st_size);
    ::close(fd);
    return -5;
  }
  out->fd = fd;
  out->map = m;
  out->len = st.st_size;
  out->base = static_cast<const uint8_t*>(m) + sizeof(BdlsHeader);
  out->n = static_cast<int64_t>(hdr->n);
  return 0;
}

// -------------------------------------------------------------- prefetcher

struct Batch {
  std::vector<float> images;      // f32 mode (normalized on host)
  std::vector<uint8_t> images_u8; // u8 mode (normalize on device —
                                  // 4x less host->device wire)
  std::vector<int32_t> labels;
};

// u8 in-place horizontal flip of one (h, w, c) image
static void flip_u8(uint8_t* img, int h, int w, int c) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = img + static_cast<int64_t>(y) * w * c;
    for (int x = 0; x < w / 2; ++x)
      for (int ch = 0; ch < c; ++ch)
        std::swap(row[x * c + ch], row[(w - 1 - x) * c + ch]);
  }
}

// u8 shift-crop, src -> dst, one image. Padding fills with the
// per-channel MEAN byte so device-side normalization maps borders to
// 0.0 — identical augmentation distribution to the f32 plane, whose
// zero-fill happens post-normalize.
static void shift_crop_u8(const uint8_t* src, uint8_t* dst, int dy, int dx,
                          int h, int w, int c, const uint8_t* fill) {
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      std::memcpy(dst + (static_cast<int64_t>(y) * w + x) * c, fill, c);
  int y0 = std::max(0, dy), y1 = std::min(h, h + dy);
  int x0 = std::max(0, dx), x1 = std::min(w, w + dx);
  for (int y = y0; y < y1; ++y)
    std::memcpy(dst + (static_cast<int64_t>(y) * w + x0) * c,
                src + (static_cast<int64_t>(y - dy) * w + (x0 - dx)) * c,
                static_cast<int64_t>(x1 - x0) * c);
}

struct Prefetcher {
  const uint8_t* images;   // (n, h, w, c) u8, borrowed (nullptr: files)
  const int32_t* labels;   // (n,), borrowed (nullptr: files)
  std::vector<MappedShard> shards;       // disk-resident mode
  std::vector<int64_t> shard_starts;     // cumulative record offsets
  int64_t rec_bytes = 0;                 // 4 + h*w*c (file mode)
  int64_t n;
  int h, w, c, batch;
  int pad;                 // random-shift augmentation range (0 = off)
  bool hflip;
  bool u8_out = false;     // emit raw u8 batches (device-side normalize)
  std::vector<float> mean, stdd;

  std::deque<Batch> ring;
  size_t capacity;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::mt19937 index_rng;
  std::vector<int64_t> order;
  int64_t cursor = 0;
  std::mutex order_mu;

  void refill_order() {  // order_mu held
    if (order.empty()) {
      order.resize(n);
      for (int64_t i = 0; i < n; ++i) order[i] = i;
    }
    std::shuffle(order.begin(), order.end(), index_rng);
    cursor = 0;
  }

  void take_indices(std::vector<int64_t>* idx) {
    std::lock_guard<std::mutex> lk(order_mu);
    idx->clear();
    for (int i = 0; i < batch; ++i) {
      if (cursor >= n) refill_order();
      idx->push_back(order[cursor++]);
    }
  }

  // record accessor spanning both sources (in-memory / mmap'd shards)
  const uint8_t* record_image(int64_t i, int32_t* label) const {
    if (images) {
      *label = labels[i];
      return images + i * static_cast<int64_t>(h) * w * c;
    }
    auto it = std::upper_bound(shard_starts.begin(), shard_starts.end(), i);
    const size_t s = (it - shard_starts.begin()) - 1;
    const uint8_t* rec = shards[s].base + (i - shard_starts[s]) * rec_bytes;
    std::memcpy(label, rec, sizeof(int32_t));
    return rec + sizeof(int32_t);
  }

  void worker(unsigned seed) {
    std::mt19937 rng(seed);
    std::vector<int64_t> idx;
    const int64_t img_px = static_cast<int64_t>(h) * w;
    while (!stop.load()) {
      take_indices(&idx);
      Batch b;
      b.labels.resize(batch);
      const int64_t img_sz = img_px * c;
      if (u8_out) {
        b.images_u8.resize(static_cast<int64_t>(batch) * img_sz);
        std::vector<uint8_t> fill(c);
        for (int ch = 0; ch < c; ++ch)
          fill[ch] = static_cast<uint8_t>(
              std::min(255.0f, std::max(0.0f, mean[ch] + 0.5f)));
        for (int i = 0; i < batch; ++i) {
          const uint8_t* src = record_image(idx[i], &b.labels[i]);
          uint8_t* dst = b.images_u8.data() +
                         static_cast<int64_t>(i) * img_sz;
          if (pad > 0) {
            std::uniform_int_distribution<int> d(-pad, pad);
            shift_crop_u8(src, dst, d(rng), d(rng), h, w, c, fill.data());
          } else {
            std::memcpy(dst, src, img_sz);
          }
          if (hflip && (rng() & 1)) flip_u8(dst, h, w, c);
        }
      } else {
        b.images.resize(static_cast<int64_t>(batch) * img_sz);
        for (int i = 0; i < batch; ++i) {
          const uint8_t* src = record_image(idx[i], &b.labels[i]);
          float* dst = b.images.data() + static_cast<int64_t>(i) * img_sz;
          bdl_normalize_u8(src, dst, img_px, c, mean.data(), stdd.data(),
                           1);
          if (pad > 0) {
            std::uniform_int_distribution<int> d(-pad, pad);
            int offy = d(rng), offx = d(rng);
            std::vector<float> tmp(dst, dst + img_sz);
            bdl_shift_crop(tmp.data(), dst, &offy, &offx, 1, h, w, c);
          }
          if (hflip && (rng() & 1)) {
            uint8_t f = 1;
            bdl_hflip(dst, &f, 1, h, w, c);
          }
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return ring.size() < capacity || stop.load(); });
      if (stop.load()) return;
      ring.push_back(std::move(b));
      cv_empty.notify_one();
    }
  }
};

// Disk-resident prefetcher over BDLS shard files. Returns nullptr on
// any open/map/header failure (caller falls back). All shards must
// share (h, w, c); out_* report the dataset geometry.
void* bdl_file_prefetcher_create(const char* const* paths, int n_paths,
                                 int batch, int capacity, int n_threads,
                                 uint64_t seed, int pad, int hflip,
                                 int u8_out, const float* mean,
                                 const float* stdd, int64_t* out_n,
                                 int* out_h, int* out_w, int* out_c) {
  auto* p = new Prefetcher();
  BdlsHeader first{};
  int64_t total = 0;
  auto fail = [&](MappedShard* extra) {
    if (extra && extra->map) {
      ::munmap(extra->map, extra->len);
      ::close(extra->fd);
    }
    for (auto& s : p->shards) {
      ::munmap(s.map, s.len);
      ::close(s.fd);
    }
    delete p;
    return static_cast<void*>(nullptr);
  };
  for (int i = 0; i < n_paths; ++i) {
    MappedShard ms;
    BdlsHeader hdr{};
    if (map_shard(paths[i], &ms, &hdr) != 0) return fail(nullptr);
    if (i > 0 && (hdr.h != first.h || hdr.w != first.w ||
                  hdr.c != first.c))
      return fail(&ms);  // the just-mapped shard is not in p->shards yet
    if (i == 0) first = hdr;
    p->shard_starts.push_back(total);
    total += ms.n;
    p->shards.push_back(ms);
  }
  if (total == 0) return fail(nullptr);
  p->images = nullptr;
  p->labels = nullptr;
  p->n = total;
  p->h = first.h; p->w = first.w; p->c = first.c;
  p->rec_bytes = 4 + static_cast<int64_t>(first.h) * first.w * first.c;
  p->batch = batch;
  p->capacity = capacity > 0 ? capacity : 4;
  p->pad = pad; p->hflip = hflip != 0;
  p->u8_out = u8_out != 0;
  p->mean.assign(mean, mean + first.c);
  p->stdd.assign(stdd, stdd + first.c);
  p->index_rng.seed(seed);
  {
    std::lock_guard<std::mutex> lk(p->order_mu);
    p->refill_order();
  }
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back(&Prefetcher::worker, p,
                            static_cast<unsigned>(seed + 1000003ULL * (t + 1)));
  *out_n = total;
  *out_h = first.h; *out_w = first.w; *out_c = first.c;
  return p;
}

// u8-mode consumer (pair with u8_out=1 at create time)
void bdl_prefetcher_next_u8(void* handle, uint8_t* out_images,
                            int32_t* out_labels) {
  auto* p = static_cast<Prefetcher*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_empty.wait(lk, [&] { return !p->ring.empty(); });
    b = std::move(p->ring.front());
    p->ring.pop_front();
    p->cv_full.notify_one();
  }
  std::memcpy(out_images, b.images_u8.data(), b.images_u8.size());
  std::memcpy(out_labels, b.labels.data(),
              b.labels.size() * sizeof(int32_t));
}

void* bdl_prefetcher_create(const uint8_t* images, const int32_t* labels,
                            int64_t n, int h, int w, int c, int batch,
                            int capacity, int n_threads, uint64_t seed,
                            int pad, int hflip, const float* mean,
                            const float* stdd) {
  auto* p = new Prefetcher();
  p->images = images; p->labels = labels;
  p->n = n; p->h = h; p->w = w; p->c = c; p->batch = batch;
  p->capacity = capacity > 0 ? capacity : 4;
  p->pad = pad; p->hflip = hflip != 0;
  p->mean.assign(mean, mean + c);
  p->stdd.assign(stdd, stdd + c);
  p->index_rng.seed(seed);
  {
    std::lock_guard<std::mutex> lk(p->order_mu);
    p->refill_order();
  }
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back(&Prefetcher::worker, p,
                            static_cast<unsigned>(seed + 1000003ULL * (t + 1)));
  return p;
}

// Blocks until a batch is ready; copies into caller buffers.
void bdl_prefetcher_next(void* handle, float* out_images,
                         int32_t* out_labels) {
  auto* p = static_cast<Prefetcher*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_empty.wait(lk, [&] { return !p->ring.empty(); });
    b = std::move(p->ring.front());
    p->ring.pop_front();
    p->cv_full.notify_one();
  }
  std::memcpy(out_images, b.images.data(), b.images.size() * sizeof(float));
  std::memcpy(out_labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
}

void bdl_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_full.notify_all();
  p->cv_empty.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& s : p->shards) {
    ::munmap(s.map, s.len);
    ::close(s.fd);
  }
  delete p;
}

}  // extern "C"
