// Native ingest: streaming multi-shard RecordIO reader + JPEG decode pool.
//
// The port's copy of resnet_tpu/data/_native/recordio_loader.cc, built by
// resnet_tpu_torch/data/native.py.
//
// Replacement for the reference's C++ ingest stack
// (mxnet src/io/iter_image_recordio_2.cc ImageRecordIOParser2 +
//  dmlc-core src/recordio.cc chunk reader + include/dmlc/threadediter.h —
// SURVEY.md §3.3): reads dmlc-framed .rec shard SETS of arbitrary size,
// decodes JPEG via libjpeg(-turbo), and produces fixed-size uint8 RGB
// canvas batches (NHWC). Deliberately does NOT augment: crop/mirror/jitter/
// normalize run on the device (ops/augment_fused.py), so this code only
// does what the host must do — IO and entropy decode.
//
// Streaming IO (round-2 rework): records are fetched with positional
// pread(2) into small per-thread buffers — nothing is buffered beyond the
// records currently being decoded, so RSS stays flat no matter how large
// the shard set is (the dmlc chunk-reader property). Shards are kept as a
// list of O_RDONLY fds; pread is thread-safe without locking. When no .idx
// exists, record offsets are discovered by one buffered sequential scan.
//
// Canvas modes:
//   mode 0 (val): shorter-side resize + center crop (the reference's val
//     transform, resize-256/crop-224 for the default shapes).
//   mode 1 (train): LETTERBOX — the whole image is scaled to fit inside
//     the canvas (top-left anchored, zero pad). Per-image original and
//     effective dims are returned so the on-device random-resized-crop
//     samples the FULL image domain with MXNet's semantics, not a
//     pre-cropped square (mxnet src/io/image_aug_default.cc parity).
//
// Threading: a pool of worker threads pulls example slots from an atomic
// cursor until the batch is full (the dmlc ThreadedIter role); the Python
// side runs this under a prefetch thread, so decode of batch N+1 overlaps
// the device step of batch N.
//
// C API (ctypes-friendly); all functions return 0 on success:
//   rtpu_open(rec_paths, idx_paths, canvas_h, canvas_w, threads,
//             nparts, part, mode, &handle)   // paths are '\n'-separated
//   rtpu_num_records(handle)
//   rtpu_begin_epoch(handle, epoch, shuffle, seed)
//   rtpu_skip(handle, n)                     // mid-epoch resume seek
//   rtpu_next_batch(handle, batch, images_out, labels_out, dims_out, &count)
//   rtpu_close(handle)

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};
static_assert(sizeof(IRHeader) == 24, "IRHeader must be packed to 24B");

// ---------------------------------------------------------------------------
// Streaming RecordIO shard access (pread-based; bounded memory).
// ---------------------------------------------------------------------------

struct RecordRef {
  uint32_t shard;   // index into Loader::shards_
  uint64_t offset;  // byte offset of the record's first magic word
};

class Shard {
 public:
  ~Shard() { Close(); }

  bool Open(const std::string& path) {
    fd_ = ::open(path.c_str(), O_RDONLY);
    if (fd_ < 0) return false;
    struct stat st;
    if (::fstat(fd_, &st) != 0) return false;
    size_ = static_cast<uint64_t>(st.st_size);
    return true;
  }

  void Close() {
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
  }

  uint64_t size() const { return size_; }

  bool ReadAt(uint64_t off, void* dst, size_t len) const {
    uint8_t* p = static_cast<uint8_t*>(dst);
    while (len > 0) {
      ssize_t n = ::pread(fd_, p, len, static_cast<off_t>(off));
      if (n <= 0) return false;
      p += n;
      off += static_cast<uint64_t>(n);
      len -= static_cast<size_t>(n);
    }
    return true;
  }

  // Sequential buffered scan for record start offsets (no .idx case).
  // Streams the shard through a fixed-size buffer — O(1) memory.
  void ScanOffsets(uint32_t shard_id, std::vector<RecordRef>* out) const {
    uint64_t pos = 0;
    while (pos + 8 <= size_) {
      uint64_t start = pos;
      bool complete = false;
      while (pos + 8 <= size_) {
        uint32_t hdr[2];
        if (!ReadAt(pos, hdr, 8) || hdr[0] != kMagic) return;
        uint32_t cflag = hdr[1] >> 29, len = hdr[1] & ((1u << 29) - 1);
        pos += 8 + ((len + 3u) & ~3u);
        if (cflag == 0 || cflag == 3) { complete = true; break; }
      }
      if (!complete) return;
      out->push_back({shard_id, start});
    }
  }

  // Reassemble the (possibly magic-split) record at `offset` into `out`.
  bool ReadRecord(uint64_t offset, std::vector<uint8_t>* out) const {
    out->clear();
    uint64_t pos = offset;
    bool first = true;
    while (pos + 8 <= size_) {
      uint32_t hdr[2];
      if (!ReadAt(pos, hdr, 8)) return false;
      if (hdr[0] != kMagic) return false;
      uint32_t cflag = hdr[1] >> 29, len = hdr[1] & ((1u << 29) - 1);
      pos += 8;
      if (pos + len > size_) return false;
      if (!first) {  // dmlc re-inserts the magic between joined pieces
        const uint32_t m = kMagic;
        const uint8_t* mb = reinterpret_cast<const uint8_t*>(&m);
        out->insert(out->end(), mb, mb + 4);
      }
      size_t base = out->size();
      out->resize(base + len);
      if (!ReadAt(pos, out->data() + base, len)) return false;
      pos += (len + 3u) & ~3u;
      if (cflag == 0 || cflag == 3) return true;
      first = false;
    }
    return false;
  }

 private:
  int fd_ = -1;
  uint64_t size_ = 0;
};

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) with error-trap, + bilinear resize to canvas.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void JpegErrExit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode JPEG bytes to RGB8. Returns false on corrupt input.
bool DecodeJpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrExit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize RGB8 (sh,sw) -> (dh,dw).
void ResizeBilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                    int dh, int dw, int dst_stride_px) {
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(fy)));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(fx)));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float v0 = v00 + (v01 - v00) * wx;
        float v1 = v10 + (v11 - v10) * wx;
        dst[(y * dst_stride_px + x) * 3 + c] =
            static_cast<uint8_t>(v0 + (v1 - v0) * wy + 0.5f);
      }
    }
  }
}

// mode 0: shorter-side resize + center crop to (ch, cw).
void DecodeToCanvas(const uint8_t* rgb, int h, int w, uint8_t* out,
                    int ch, int cw) {
  // scale so min(h', w') == corresponding canvas dim, preserving aspect
  float scale = std::max(static_cast<float>(ch) / h,
                         static_cast<float>(cw) / w);
  int rh = std::max(ch, static_cast<int>(h * scale + 0.5f));
  int rw = std::max(cw, static_cast<int>(w * scale + 0.5f));
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
  ResizeBilinear(rgb, h, w, resized.data(), rh, rw, rw);
  int y0 = (rh - ch) / 2, x0 = (rw - cw) / 2;
  for (int y = 0; y < ch; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * cw * 3,
                resized.data() + (static_cast<size_t>(y0 + y) * rw + x0) * 3,
                static_cast<size_t>(cw) * 3);
  }
}

// mode 1: letterbox — fit the WHOLE image inside the canvas (top-left
// anchored, zero pad). Writes effective dims to (eh, ew).
void DecodeToLetterbox(const uint8_t* rgb, int h, int w, uint8_t* out,
                       int ch, int cw, int* eh, int* ew) {
  std::memset(out, 0, static_cast<size_t>(ch) * cw * 3);
  float scale = std::min(static_cast<float>(ch) / h,
                         static_cast<float>(cw) / w);
  int rh = std::min(ch, std::max(1, static_cast<int>(h * scale + 0.5f)));
  int rw = std::min(cw, std::max(1, static_cast<int>(w * scale + 0.5f)));
  ResizeBilinear(rgb, h, w, out, rh, rw, cw);
  *eh = rh;
  *ew = rw;
}

// ---------------------------------------------------------------------------
// Loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<Shard> shards;
  std::vector<RecordRef> records;   // this worker's partition
  std::vector<uint32_t> order;      // epoch permutation into `records`
  uint64_t cursor = 0;              // next example within the epoch
  int canvas_h = 256, canvas_w = 256;
  int threads = 4;
  int mode = 0;                     // 0 center-crop canvas, 1 letterbox+dims
};

bool LoadIndex(const std::string& idx_path, uint32_t shard_id,
               std::vector<RecordRef>* out) {
  FILE* f = std::fopen(idx_path.c_str(), "r");
  if (!f) return false;
  char line[256];
  size_t before = out->size();
  while (std::fgets(line, sizeof(line), f)) {
    char* tab = std::strchr(line, '\t');
    if (!tab) continue;
    out->push_back({shard_id, std::strtoull(tab + 1, nullptr, 10)});
  }
  std::fclose(f);
  return out->size() > before;
}

// Split on '\n', PRESERVING empty segments — the idx list is aligned with
// the rec list and an empty line means "this shard has no index".
std::vector<std::string> SplitLines(const char* s) {
  std::vector<std::string> out;
  if (!s || !*s) return out;
  const char* p = s;
  for (;;) {
    const char* nl = std::strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    out.emplace_back(p, len);
    if (!nl) break;
    p = nl + 1;
  }
  return out;
}

}  // namespace

extern "C" {

int rtpu_open(const char* rec_paths, const char* idx_paths, int canvas_h,
              int canvas_w, int threads, int num_parts, int part_index,
              int mode, void** out_handle) {
  auto* ld = new Loader();
  ld->canvas_h = canvas_h;
  ld->canvas_w = canvas_w;
  ld->threads = std::max(1, threads);
  ld->mode = mode;
  std::vector<std::string> recs = SplitLines(rec_paths);
  std::vector<std::string> idxs = SplitLines(idx_paths);
  if (recs.empty()) { delete ld; return 1; }
  ld->shards.resize(recs.size());
  std::vector<RecordRef> all;
  for (size_t s = 0; s < recs.size(); ++s) {
    if (!ld->shards[s].Open(recs[s])) { delete ld; return 1; }
    bool have_idx = s < idxs.size() && !idxs[s].empty() &&
        LoadIndex(idxs[s], static_cast<uint32_t>(s), &all);
    if (!have_idx) {
      ld->shards[s].ScanOffsets(static_cast<uint32_t>(s), &all);
    }
  }
  if (all.empty()) { delete ld; return 2; }
  // strided partition over the GLOBAL shard-concatenated sequence: worker k
  // takes records k, k+P, k+2P, ... (the reference's num_parts/part_index
  // contract: disjoint + balanced, across the whole shard set)
  for (size_t i = part_index; i < all.size();
       i += static_cast<size_t>(num_parts)) {
    ld->records.push_back(all[i]);
  }
  ld->order.resize(ld->records.size());
  for (uint32_t i = 0; i < ld->order.size(); ++i) ld->order[i] = i;
  *out_handle = ld;
  return 0;
}

long rtpu_num_records(void* handle) {
  return static_cast<long>(static_cast<Loader*>(handle)->records.size());
}

int rtpu_begin_epoch(void* handle, int epoch, int shuffle, unsigned seed) {
  auto* ld = static_cast<Loader*>(handle);
  ld->cursor = 0;
  for (uint32_t i = 0; i < ld->order.size(); ++i) ld->order[i] = i;
  if (shuffle) {
    std::mt19937 rng(seed ^ (0x9e3779b9u * static_cast<unsigned>(epoch + 1)));
    std::shuffle(ld->order.begin(), ld->order.end(), rng);
  }
  return 0;
}

// Advance the epoch cursor without decoding — mid-epoch checkpoint resume
// seeks back to the exact position in the (deterministic) epoch stream.
int rtpu_skip(void* handle, long n) {
  auto* ld = static_cast<Loader*>(handle);
  uint64_t remaining = ld->records.size() - ld->cursor;
  ld->cursor += std::min<uint64_t>(remaining, static_cast<uint64_t>(n));
  return 0;
}

// Fill up to `batch` examples. `images` is batch*ch*cw*3 uint8, `labels`
// is batch floats, `dims` is batch*4 int32 (orig_h, orig_w, eff_h, eff_w;
// may be null in mode 0). *out_count < batch signals epoch end.
int rtpu_next_batch(void* handle, int batch, uint8_t* images, float* labels,
                    int* dims, int* out_count) {
  auto* ld = static_cast<Loader*>(handle);
  const uint64_t remaining = ld->records.size() - ld->cursor;
  const int todo = static_cast<int>(
      std::min<uint64_t>(batch, remaining));
  *out_count = todo;
  if (todo == 0) return 0;
  const uint64_t base = ld->cursor;
  ld->cursor += todo;
  const int ch = ld->canvas_h, cw = ld->canvas_w;
  const size_t canvas_bytes = static_cast<size_t>(ch) * cw * 3;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto work = [&]() {
    std::vector<uint8_t> rec, rgb;
    int w = 0, h = 0;
    for (int i = next.fetch_add(1); i < todo; i = next.fetch_add(1)) {
      const RecordRef& rr = ld->records[ld->order[base + i]];
      const Shard& shard = ld->shards[rr.shard];
      bool ok = shard.ReadRecord(rr.offset, &rec) &&
          rec.size() > sizeof(IRHeader);
      float label = -1.f;
      if (ok) {
        IRHeader hdr;
        std::memcpy(&hdr, rec.data(), sizeof(hdr));
        size_t off = sizeof(hdr) + 4ull * hdr.flag;
        // bounds BEFORE the extra-label read: a truncated record with
        // flag>0 must not read past the buffer (off<=size guarantees the
        // flag floats fit; off<size additionally leaves image bytes)
        ok = off < rec.size();
        if (ok) {
          label = hdr.flag
              ? *reinterpret_cast<const float*>(rec.data() + sizeof(hdr))
              : hdr.label;
          ok = DecodeJpeg(rec.data() + off, rec.size() - off, &rgb, &w, &h);
        }
      }
      if (!ok) {
        failures.fetch_add(1);
        std::memset(images + i * canvas_bytes, 0, canvas_bytes);
        labels[i] = -1.f;
        if (dims) { dims[i * 4 + 0] = dims[i * 4 + 1] = 0;
                    dims[i * 4 + 2] = dims[i * 4 + 3] = 0; }
        continue;
      }
      if (ld->mode == 1) {
        int eh = 0, ew = 0;
        DecodeToLetterbox(rgb.data(), h, w, images + i * canvas_bytes,
                          ch, cw, &eh, &ew);
        if (dims) {
          dims[i * 4 + 0] = h;
          dims[i * 4 + 1] = w;
          dims[i * 4 + 2] = eh;
          dims[i * 4 + 3] = ew;
        }
      } else {
        DecodeToCanvas(rgb.data(), h, w, images + i * canvas_bytes, ch, cw);
        if (dims) {
          dims[i * 4 + 0] = h;
          dims[i * 4 + 1] = w;
          dims[i * 4 + 2] = ch;
          dims[i * 4 + 3] = cw;
        }
      }
      labels[i] = label;
    }
  };

  int nthreads = std::min(ld->threads, todo);
  if (nthreads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return failures.load() ? -failures.load() : 0;
}

void rtpu_close(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
