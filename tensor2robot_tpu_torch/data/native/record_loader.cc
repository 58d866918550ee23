// Native TFRecord -> batched-tensor loader of the PyTorch port (a copy of
// the JAX package's data/native/record_loader.cc: full image decode, and
// the split decode's coefficient modes, whose entropy stage is this file's
// own baseline Huffman decoder where JAX calls libjpeg).
//
// A dependency-light C++ loader that reads TFRecord shards, parses
// tf.Example and tf.SequenceExample protos straight off the wire format,
// decodes JPEG frames and assembles batches into a ring of preallocated
// buffers, on a worker thread pool outside the Python GIL.
//
// Architecture:
//   reader thread:  epoch loop -> framed record read -> bounded shuffle
//                   buffer -> (slot, row) work items
//   N worker threads: proto wire walk -> field extract / JPEG decode ->
//                   write into slot row (no locks on the hot path; each row
//                   is owned by exactly one worker)
//   consumer (Python via ctypes): t2r_loader_next() blocks for a READY slot,
//                   wraps the slot buffers as numpy arrays (zero copy),
//                   t2r_loader_release() returns the slot to the pool.
//
// JPEG decoder, chosen when the library is built (native_loader.py):
//   T2R_JPEG_LIBJPEG: libjpeg(-turbo), the JAX loader's decoder;
//   T2R_JPEG_NVJPEG:  NVIDIA's nvJPEG, where the host has no libjpeg but
//     the CUDA toolkit has nvJPEG: each worker thread decodes on the CUDA
//     device the configuration's 'device' line names (an index the host
//     lacks fails the first batch), with a state and a stream of its own,
//     and copies the planes back into its row. Its IDCT is not libjpeg's,
//     so its pixels may differ from libjpeg's by a few levels.
// t2r_loader_decoder() names the one built in; the libjpeg build takes the
// 'device' line and uses no card. The coefficient modes (image_coef,
// image_coef_sparse, image_coef_packed) use neither: a plan without pixel
// images binds no card in either build.
//
// A field may keep only items [lo, hi) of its list (a frame range of a
// [T, ...] field: frames of an encoded image list, or the elements of those
// frames' rows of a fixed float or int list). The record's whole list is
// still checked for its count, but the items outside the range are
// neither decoded nor copied, and the field's buffer holds hi - lo items a
// row: a rank of a sequence-parallel group decodes only its own frames.
//
// Wire-format notes (proto2/proto3 compatible, no protobuf dependency):
//   Example        = { 1: Features }
//   Features       = { 1: repeated map entry { 1: key-bytes, 2: Feature } }
//   Feature        = oneof { 1: BytesList, 2: FloatList, 3: Int64List }
//   BytesList      = { 1: repeated bytes }
//   FloatList      = { 1: repeated float (packed or unpacked) }
//   Int64List      = { 1: repeated varint (packed or unpacked) }
//
// TFRecord framing: [u64 len][u32 masked-crc32c(len)][data][u32 masked-crc32c
// (data)] - see data/tfrecord.py for the Python twin of this reader.

#include <pthread.h>
#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#if defined(T2R_JPEG_NVJPEG)
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#elif defined(T2R_JPEG_LIBJPEG)
#include <jpeglib.h>  // requires <stddef.h>/<stdio.h> first
#else
#error "define T2R_JPEG_LIBJPEG or T2R_JPEG_NVJPEG"
#endif

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli) for TFRecord frame verification.
// ---------------------------------------------------------------------------

uint32_t crc32c_table[256];
std::once_flag crc_table_once;

void init_crc_table() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++)
      crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
    crc32c_table[i] = crc;
  }
}

uint32_t crc32c(const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  uint64_t crc = 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    memcpy(&v, data + i, 8);
    crc = _mm_crc32_u64(crc, v);
  }
  for (; i < n; i++) crc = _mm_crc32_u8((uint32_t)crc, data[i]);
  return (uint32_t)crc ^ 0xFFFFFFFFu;
#else
  std::call_once(crc_table_once, init_crc_table);
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = crc32c_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
#endif
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// Protobuf wire walking.
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Returns field number, sets wire type; 0 on end/error.
  uint32_t tag(uint32_t* wire_type) {
    if (p >= end) return 0;
    uint64_t t = varint();
    if (!ok) return 0;
    *wire_type = (uint32_t)(t & 7);
    return (uint32_t)(t >> 3);
  }

  // Length-delimited payload; returns view.
  Cursor bytes() {
    uint64_t n = varint();
    if (!ok || p + n > end) {
      ok = false;
      return {end, end};
    }
    Cursor c{p, p + n};
    p += n;
    return c;
  }

  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: bytes(); break;
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }

  size_t size() const { return end - p; }
};

// ---------------------------------------------------------------------------
// Config.
// ---------------------------------------------------------------------------

enum FieldKind {
  kFloat = 0,
  kInt = 1,
  kImageFull = 2,
  // The split decode: the entropy (Huffman) stage only, by the baseline
  // decoder below, shipped as the quantized DCT coefficients and their
  // quantization tables: dense planes, the sparse (delta, value) stream, or
  // the packed wire (the JAX loader's three coefficient modes, bit for bit).
  kImageCoef = 3,
  kImageCoefSparse = 4,
  kImageCoefPacked = 5,
};

inline bool is_coef(int kind) {
  return kind == kImageCoef || kind == kImageCoefSparse ||
         kind == kImageCoefPacked;
}

struct FieldSpec {
  std::string name;
  FieldKind kind;
  int dtype_size;  // int fields: output width in bytes (1, 4, 8)
  int h = 0, w = 0, c = 0;  // image fields
  // float/int fields: elements per row (per STEP for sequence fields).
  // image_full fields: number of frames (a rank-4 [T, H, W, C] spec
  // stores T JPEGs as a bytes list; 0/1 means a single [H, W, C] image).
  // image_coef_sparse fields: the per-row entry capacity of the sparse
  // (delta, value) streams; image_coef_packed: the per-row byte capacity
  // of the packed nibble stream.
  long long count = 0;
  // > 0: a SequenceExample feature_lists field (float/int only) with this
  // step CAPACITY; rows are [seq_cap, count] with zero padding past the
  // record's actual step count, which lands in buf_n.
  long long seq_cap = 0;
  // Varlen (VarLenFeature semantics): the on-disk value list may hold
  // any number of elements; the row is CLIPPED to ``count`` (extras
  // dropped) or PADDED with ``pad_value`` (parser.py pad_or_clip
  // parity). Float/int rank-1 fields and image_full frame lists only.
  int varlen = 0;
  double pad_value = 0.0;
  // Optional (is_optional specs): a record may omit the feature. The
  // per-row presence flag lands in buf_p; the Python side drops the key
  // from any batch where presence is not all-ones (the Python parser's
  // dense-batch drop semantics).
  int optional_field = 0;
  // Dataset index for multi-dataset zip: this field parses from the
  // row's dsi-th record (one record per file group per row).
  int dsi = 0;
  // The items of the list kept, [lo, hi): frames of an image field (its
  // one image where count is 0), elements of a float or int field. The
  // configuration's -1 for hi keeps them all (set to items() then).
  long long lo = 0, hi = -1;
  long long items() const {
    if (kind == kFloat || kind == kInt) return count;
    return kind == kImageFull && count > 0 ? count : 1;
  }
  long long kept() const { return hi - lo; }
  // Buffer indices into Slot::buffers (filled at config time).
  int buf0 = -1;            // float/int values, uint8 pixels, coef Y,
                            // sparse deltas or the packed nibble stream
  int buf_cb = -1, buf_cr = -1, buf_qt = -1;  // coef extras; the sparse
                            // stream keeps its values in buf_cb, the
                            // packed wire its int16 escapes in buf_cb and
                            // its DC-delta nibbles in buf_cr
  int buf_n = -1;           // per-row counts: sequence steps, sparse
                            // entries or packed stream bytes
  int buf_n2 = -1;          // packed wire: per-row escape counts
  int buf_p = -1;           // per-row presence flags (optional fields)

  // The packed wire's derived sizes.
  long long packed_escape_cap() const { return count / 4; }
  long long packed_dc_count() const {
    return (long long)(h / 8) * (w / 8) + 2LL * (h / 16) * (w / 16);
  }
};

struct Config {
  int batch_size = 0;
  int ring = 3;
  int threads = 2;
  int device = 0;         // the CUDA device the nvJPEG build decodes on
  bool shuffle = false;
  int shuffle_buffer = 500;
  long long seed = -1;
  long long epochs = -1;  // -1: infinite
  bool verify_crc = false;
  bool any_seq = false;   // any sequence field: records parse as
                          // SequenceExample (context + feature_lists)
  bool any_full_image = false;  // any field decoded to pixels: only then
                                // do the workers bind a decode device
  // One file list per dataset; row r of a batch is built from one record
  // of EACH group (multi-dataset zip, ending with the shortest group).
  // The single-dataset case is one group.
  std::vector<std::vector<std::string>> groups;
  std::vector<FieldSpec> fields;
  std::vector<long long> buffer_sizes;  // per-slot bytes for each buffer
};

bool parse_config(const std::string& text, Config* cfg, std::string* err) {
  std::istringstream in(text);
  std::string key;
  while (in >> key) {
    if (key == "batch_size") in >> cfg->batch_size;
    else if (key == "ring") in >> cfg->ring;
    else if (key == "threads") in >> cfg->threads;
    else if (key == "device") in >> cfg->device;
    else if (key == "shuffle") { int v; in >> v; cfg->shuffle = v != 0; }
    else if (key == "shuffle_buffer") in >> cfg->shuffle_buffer;
    else if (key == "seed") in >> cfg->seed;
    else if (key == "epochs") in >> cfg->epochs;
    else if (key == "verify_crc") { int v; in >> v; cfg->verify_crc = v != 0; }
    else if (key == "files" || key == "group") {
      // 'files N' (legacy single dataset) and 'group N' (one zip group
      // per occurrence) both append one file group.
      int n; in >> n;
      in.ignore(1);
      std::vector<std::string> group;
      for (int i = 0; i < n; i++) {
        std::string path;
        std::getline(in, path);
        if (path.empty()) { *err = "empty file path"; return false; }
        group.push_back(path);
      }
      cfg->groups.push_back(std::move(group));
    } else if (key == "fields") {
      int m; in >> m;
      for (int i = 0; i < m; i++) {
        FieldSpec f;
        int kind, name_len;
        in >> name_len >> kind >> f.dtype_size >> f.h >> f.w >> f.c
            >> f.count >> f.seq_cap >> f.varlen >> f.optional_field
            >> f.dsi >> f.pad_value >> f.lo >> f.hi;
        f.kind = (FieldKind)kind;
        in.ignore(1);  // single separating space
        f.name.resize(name_len);
        in.read(&f.name[0], name_len);
        cfg->fields.push_back(f);
      }
    } else {
      *err = "unknown config key: " + key;
      return false;
    }
  }
  if (cfg->batch_size <= 0 || cfg->groups.empty() || cfg->fields.empty()) {
    *err = "config requires batch_size, files/groups, fields";
    return false;
  }
  for (const auto& g : cfg->groups) {
    if (g.empty()) {  // an empty group would spin the zip reader on an
                      // empty file list; reject at create like 'files 0'
      *err = "empty file group";
      return false;
    }
  }
  for (const auto& f : cfg->fields) {
    if (f.dsi < 0 || f.dsi >= (int)cfg->groups.size()) {
      *err = "field dataset index out of range: " + f.name;
      return false;
    }
    if (f.kind != kFloat && f.kind != kInt && f.kind != kImageFull &&
        !is_coef(f.kind)) {
      *err = "unknown field kind for " + f.name;
      return false;
    }
    if (f.varlen && (f.seq_cap > 0 || is_coef(f.kind))) {
      *err = "varlen unsupported for sequence/coef fields: " + f.name;
      return false;
    }
    if (f.optional_field && is_coef(f.kind)) {
      *err = "optional unsupported for coef fields: " + f.name;
      return false;
    }
  }
  for (auto& f : cfg->fields) {
    if (f.hi < 0) {
      f.lo = 0;
      f.hi = f.items();
      continue;
    }
    if (f.lo < 0 || f.lo >= f.hi || f.hi > f.items()) {
      *err = "item range out of the list for " + f.name;
      return false;
    }
    if (f.kept() != f.items() && (f.varlen || f.seq_cap > 0)) {
      *err = "an item range needs a fixed, non-sequence list: " + f.name;
      return false;
    }
  }
  if (cfg->ring < 2) cfg->ring = 2;
  if (cfg->threads < 1) cfg->threads = 1;
  // shuffle_buffer <= 0 with shuffle on would never admit a record into
  // the reservoir and end the stream empty; 1 degrades to pass-through.
  if (cfg->shuffle_buffer < 1) cfg->shuffle_buffer = 1;
  // Assign buffers. Layout mirrored in native_loader.py (_buffer_layout).
  long long B = cfg->batch_size;
  for (auto& f : cfg->fields) {
    if (f.seq_cap > 0) {
      if (f.kind != kFloat && f.kind != kInt) {
        *err = "sequence fields must be float/int: " + f.name;
        return false;
      }
      cfg->any_seq = true;
      int width = f.kind == kFloat ? 4 : f.dtype_size;
      f.buf0 = (int)cfg->buffer_sizes.size();
      cfg->buffer_sizes.push_back(B * f.seq_cap * f.count * width);
      f.buf_n = (int)cfg->buffer_sizes.size();  // step counts, int32
      cfg->buffer_sizes.push_back(B * 4);
      if (f.optional_field) {
        f.buf_p = (int)cfg->buffer_sizes.size();  // presence, uint8
        cfg->buffer_sizes.push_back(B);
      }
      continue;
    }
    // hi - lo items a row (all of them but under a frame range).
    switch (f.kind) {
      case kFloat:
        f.buf0 = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * f.kept() * 4);
        break;
      case kInt:
        f.buf0 = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * f.kept() * f.dtype_size);
        break;
      case kImageFull:
        // count > 0: a rank-4 [T, H, W, C] spec — strict frame count
        // (even T=1). count == 0: rank-3 single image, first bytes
        // element wins (Python parser parity).
        cfg->any_full_image = true;
        f.buf0 = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * f.kept() * (long long)f.h * f.w *
                                    f.c);
        break;
      case kImageCoef: {
        if (f.h % 16 || f.w % 16 || f.c != 3) {
          *err = "image_coef requires HxW multiple of 16 and c=3: " + f.name;
          return false;
        }
        long long yblocks = (long long)(f.h / 8) * (f.w / 8);
        long long cblocks = (long long)(f.h / 16) * (f.w / 16);
        f.buf0 = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * yblocks * 64 * 2);
        f.buf_cb = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * cblocks * 64 * 2);
        f.buf_cr = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * cblocks * 64 * 2);
        f.buf_qt = (int)cfg->buffer_sizes.size();
        cfg->buffer_sizes.push_back(B * 3 * 64 * 2);
        break;
      }
      case kImageCoefSparse: {
        if (f.h % 16 || f.w % 16 || f.c != 3) {
          *err = "image_coef_sparse requires HxW multiple of 16 and c=3: " +
                 f.name;
          return false;
        }
        if (f.count <= 0) {
          *err = "image_coef_sparse requires a positive entry capacity: " +
                 f.name;
          return false;
        }
        f.buf0 = (int)cfg->buffer_sizes.size();        // deltas, uint8
        cfg->buffer_sizes.push_back(B * f.count);
        f.buf_cb = (int)cfg->buffer_sizes.size();      // values, int8
        cfg->buffer_sizes.push_back(B * f.count);
        f.buf_qt = (int)cfg->buffer_sizes.size();      // quant tables
        cfg->buffer_sizes.push_back(B * 3 * 64 * 2);
        f.buf_n = (int)cfg->buffer_sizes.size();       // entry counts, int32
        cfg->buffer_sizes.push_back(B * 4);
        break;
      }
      case kImageCoefPacked: {
        if (f.h % 16 || f.w % 16 || f.c != 3) {
          *err = "image_coef_packed requires HxW multiple of 16 and c=3: " +
                 f.name;
          return false;
        }
        // count is the per-row BYTE capacity of the packed nibble stream;
        // the escape stream rides at count/4 int16 entries and the DC
        // plane is one nibble per block. Multiple-of-8 keeps the derived
        // escape capacity exact.
        if (f.count <= 0 || f.count % 8) {
          *err = "image_coef_packed requires a positive byte capacity "
                 "divisible by 8: " + f.name;
          return false;
        }
        f.buf0 = (int)cfg->buffer_sizes.size();        // nibble stream, u8
        cfg->buffer_sizes.push_back(B * f.count);
        f.buf_cb = (int)cfg->buffer_sizes.size();      // escapes, int16
        cfg->buffer_sizes.push_back(B * f.packed_escape_cap() * 2);
        f.buf_cr = (int)cfg->buffer_sizes.size();      // DC nibbles, u8
        cfg->buffer_sizes.push_back(B * (f.packed_dc_count() / 2));
        f.buf_qt = (int)cfg->buffer_sizes.size();      // quant tables
        cfg->buffer_sizes.push_back(B * 3 * 64 * 2);
        f.buf_n = (int)cfg->buffer_sizes.size();       // stream bytes, i32
        cfg->buffer_sizes.push_back(B * 4);
        f.buf_n2 = (int)cfg->buffer_sizes.size();      // escape counts, i32
        cfg->buffer_sizes.push_back(B * 4);
        break;
      }
    }
    if (f.optional_field) {
      f.buf_p = (int)cfg->buffer_sizes.size();  // presence, uint8
      cfg->buffer_sizes.push_back(B);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG decode.
// ---------------------------------------------------------------------------

// libjpeg's upsampling and colour conversion, for decoders that return the
// image's Y, Cb and Cr planes (the nvJPEG build, and the planes path of
// the libjpeg build that tests it): the triangle filter of jdsample.c's
// h2v1/h1v2/h2v2_fancy_upsample, edge rows and columns replicated as
// jdmainct.c provides them, and jdcolor.c's fixed-point YCbCr -> RGB
// tables. Given libjpeg's planes, the result is libjpeg's RGB bit for bit.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t one_half = 1 << 15;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;  // initialized once, thread-safe
  return tables;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// Output row y of a chroma plane (cw x ch, ``pitch`` bytes a row) upsampled
// by (hr, vr) in {1, 2}: 2 * cw (or cw) samples into ``row``.
void upsample_row(const uint8_t* plane, size_t pitch, int cw, int ch, int hr,
                  int vr, int y, uint8_t* row) {
  int src = vr == 2 ? y / 2 : y;
  const uint8_t* in0 = plane + (size_t)src * pitch;
  if (vr == 1 && hr == 1) {
    memcpy(row, in0, (size_t)cw);
    return;
  }
  if (hr == 2 && cw <= 2) {
    // libjpeg filters only planes more than 2 samples wide
    // (jinit_upsampler); narrower ones repeat each sample (h2v1_upsample,
    // h2v2_upsample).
    for (int k = 0; k < cw; k++) row[2 * k] = row[2 * k + 1] = in0[k];
    return;
  }
  if (vr == 1) {  // h2v1
    row[0] = in0[0];
    row[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
    for (int k = 1; k < cw - 1; k++) {
      int v = in0[k] * 3;
      row[2 * k] = (uint8_t)((v + in0[k - 1] + 1) >> 2);
      row[2 * k + 1] = (uint8_t)((v + in0[k + 1] + 2) >> 2);
    }
    int k = cw - 1;
    row[2 * k] = (uint8_t)((in0[k] * 3 + in0[k - 1] + 1) >> 2);
    row[2 * k + 1] = in0[k];
    return;
  }
  // v2: an even output row leans on the chroma row above, an odd one on the
  // row below; past the plane's edges the edge row repeats.
  bool upper = y % 2 == 0;
  int other = upper ? src - 1 : src + 1;
  other = other < 0 ? 0 : other >= ch ? ch - 1 : other;
  const uint8_t* in1 = plane + (size_t)other * pitch;
  if (hr == 1) {  // h1v2
    int bias = upper ? 1 : 2;
    for (int k = 0; k < cw; k++)
      row[k] = (uint8_t)((in0[k] * 3 + in1[k] + bias) >> 2);
    return;
  }
  // h2v2
  int last = 0, cur = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1];
  row[0] = (uint8_t)((cur * 4 + 8) >> 4);
  row[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
  for (int k = 1; k < cw - 1; k++) {
    last = cur;
    cur = next;
    next = in0[k + 1] * 3 + in1[k + 1];
    row[2 * k] = (uint8_t)((cur * 3 + last + 8) >> 4);
    row[2 * k + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
  }
  last = cur;
  cur = next;
  int k = cw - 1;
  row[2 * k] = (uint8_t)((cur * 3 + last + 8) >> 4);
  row[2 * k + 1] = (uint8_t)((cur * 4 + 7) >> 4);
}

// Y (and Cb, Cr: ncomp 3, subsampled by hr x vr) planes -> the H x W x c
// uint8 image in ``out``: c 1 takes Y, as libjpeg's grayscale output does;
// a one-plane image repeats Y in R, G and B.
void planes_to_image(const uint8_t* const planes[3], const size_t pitch[3],
                     int ncomp, int hr, int vr, int h, int w, int c,
                     uint8_t* out) {
  if (c == 1 || ncomp == 1) {
    for (int y = 0; y < h; y++) {
      const uint8_t* luma = planes[0] + (size_t)y * pitch[0];
      uint8_t* o = out + (size_t)y * w * c;
      if (c == 1) {
        memcpy(o, luma, (size_t)w);
      } else {
        for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = luma[x];
      }
    }
    return;
  }
  const YccTables& t = ycc_tables();
  int cw = (w + hr - 1) / hr, ch = (h + vr - 1) / vr;
  std::vector<uint8_t> cb_row((size_t)cw * hr), cr_row((size_t)cw * hr);
  for (int y = 0; y < h; y++) {
    upsample_row(planes[1], pitch[1], cw, ch, hr, vr, y, cb_row.data());
    upsample_row(planes[2], pitch[2], cw, ch, hr, vr, y, cr_row.data());
    const uint8_t* luma = planes[0] + (size_t)y * pitch[0];
    uint8_t* o = out + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      int yv = luma[x], cb = cb_row[x], cr = cr_row[x];
      o[3 * x] = clamp255(yv + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yv + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yv + t.cb_b[cb]);
    }
  }
}

std::string dims_error(int h, int w, const FieldSpec& f) {
  char buf[160];
  snprintf(buf, sizeof buf, "jpeg dims %dx%dx%d != spec %dx%dx%d for %s", h,
           w, f.c, f.h, f.w, f.c, f.name.c_str());
  return buf;
}

#if defined(T2R_JPEG_LIBJPEG)

const char* const kDecoder = "libjpeg";

// The libjpeg build decodes on the host: it takes the device and uses no
// card. Returns -1, the device bound.
int bind_decode_device(int device, std::string* err) {
  (void)device;
  (void)err;
  return -1;
}

// The calling thread's current CUDA device, kept and put back: nothing to
// keep where no card is used.
struct CallerDevice {};

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* e = (JerrMgr*)cinfo->err;
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

// Full decode into row (H*W*C uint8). Returns error string or empty.
std::string decode_jpeg_full(const uint8_t* data, size_t n,
                             const FieldSpec& f, uint8_t* out) {
  if (n == 0) {  // empty payload -> zeros (the Python parser's too)
    memset(out, 0, (size_t)f.h * f.w * f.c);
    return "";
  }
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return std::string("jpeg: ") + jerr.msg;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = f.c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != f.w || (int)cinfo.output_height != f.h ||
      (int)cinfo.output_components != f.c) {
    jpeg_destroy_decompress(&cinfo);
    char buf[160];
    snprintf(buf, sizeof buf, "jpeg dims %dx%dx%d != spec %dx%dx%d for %s",
             cinfo.output_height, cinfo.output_width, cinfo.output_components,
             f.h, f.w, f.c, f.name.c_str());
    return buf;
  }
  size_t stride = (size_t)f.w * f.c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rows[8];
    int base = cinfo.output_scanline;
    int navail = (int)(cinfo.output_height - base);
    int nrows = navail < 8 ? navail : 8;
    for (int k = 0; k < nrows; k++) rows[k] = out + (base + k) * stride;
    jpeg_read_scanlines(&cinfo, rows, nrows);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return "";
}

// libjpeg's raw planes (raw_data_out: no upsampling, no colour conversion)
// through planes_to_image: the nvJPEG build's path, on libjpeg's planes.
std::string decode_jpeg_planes(const uint8_t* data, size_t n,
                               const FieldSpec& f, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  std::vector<std::vector<uint8_t>> planes;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return std::string("jpeg: ") + jerr.msg;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  int ncomp = cinfo.num_components;
  if ((int)cinfo.output_width != f.w || (int)cinfo.output_height != f.h ||
      (ncomp != 1 && ncomp != 3)) {
    jpeg_destroy_decompress(&cinfo);
    return dims_error(cinfo.output_height, cinfo.output_width, f);
  }
  int hr = 1, vr = 1;
  if (ncomp == 3) {
    hr = cinfo.max_h_samp_factor / cinfo.comp_info[1].h_samp_factor;
    vr = cinfo.max_v_samp_factor / cinfo.comp_info[1].v_samp_factor;
  }
  int group = cinfo.max_v_samp_factor * DCTSIZE;  // rows an iMCU row
  int imcu_rows = (f.h + group - 1) / group;
  const uint8_t* plane_ptrs[3] = {nullptr, nullptr, nullptr};
  size_t pitch[3] = {0, 0, 0};
  planes.resize(ncomp);
  for (int ci = 0; ci < ncomp; ci++) {
    const jpeg_component_info& comp = cinfo.comp_info[ci];
    pitch[ci] = (size_t)comp.width_in_blocks * DCTSIZE;
    planes[ci].resize(pitch[ci] * imcu_rows * comp.v_samp_factor * DCTSIZE);
    plane_ptrs[ci] = planes[ci].data();
  }
  std::vector<JSAMPROW> rows[3];
  for (int imcu = 0; imcu < imcu_rows; imcu++) {
    JSAMPARRAY arrays[3];
    for (int ci = 0; ci < ncomp; ci++) {
      int lines = cinfo.comp_info[ci].v_samp_factor * DCTSIZE;
      rows[ci].resize(lines);
      for (int k = 0; k < lines; k++)
        rows[ci][k] = planes[ci].data() +
                      ((size_t)imcu * lines + k) * pitch[ci];
      arrays[ci] = rows[ci].data();
    }
    jpeg_read_raw_data(&cinfo, arrays, group);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  planes_to_image(plane_ptrs, pitch, ncomp, hr, vr, f.h, f.w, f.c, out);
  return "";
}

#else  // T2R_JPEG_NVJPEG

const char* const kDecoder = "nvjpeg";

// One nvJPEG handle a CUDA device (thread-safe by nvJPEG's contract), made
// at the first decode on it, with that device current.
struct NvjpegHandle {
  nvjpegHandle_t handle = nullptr;
  std::string error;
  NvjpegHandle() {
    nvjpegStatus_t status = nvjpegCreateSimple(&handle);
    if (status != NVJPEG_STATUS_SUCCESS) {
      handle = nullptr;
      error = "nvjpeg: nvjpegCreateSimple failed with status " +
              std::to_string((int)status);
    }
  }
};

NvjpegHandle& nvjpeg_handle(int device) {
  static std::mutex mu;
  static std::vector<std::unique_ptr<NvjpegHandle>> handles;
  std::lock_guard<std::mutex> lk(mu);
  if ((int)handles.size() <= device) handles.resize(device + 1);
  if (!handles[device]) handles[device].reset(new NvjpegHandle());
  return *handles[device];
}

// A worker thread's own decode device, state, stream, device planes and
// their host copy.
struct NvjpegThread {
  int device = -1;  // bound by bind_decode_device; -1 before
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* planes = nullptr;
  size_t planes_bytes = 0;
  std::vector<uint8_t> host;
  ~NvjpegThread() { release(); }
  void release() {
    if (planes) cudaFree(planes);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
    planes = nullptr;
    planes_bytes = 0;
    stream = nullptr;
    state = nullptr;
  }
};

thread_local NvjpegThread nvjpeg_thread;

std::string cuda_error(const char* what, cudaError_t status) {
  return std::string("nvjpeg: ") + what + " failed: " +
         cudaGetErrorString(status);
}

std::string nvjpeg_error(const char* what, nvjpegStatus_t status,
                         const FieldSpec& f) {
  return std::string("jpeg: ") + what + " failed with nvjpeg status " +
         std::to_string((int)status) + " for " + f.name;
}

// Makes CUDA ``device`` this thread's decode device and its current one
// (set on every call: a caller may have made another current since): a
// thread bound to another device first frees what it made there. Returns
// the device bound, or -1 with *err set where the host has no such device
// (never another device in its place).
int bind_decode_device(int device, std::string* err) {
  NvjpegThread& t = nvjpeg_thread;
  cudaError_t status;
  if (t.device == device) {
    status = cudaSetDevice(device);
    if (status != cudaSuccess) {
      *err = cuda_error("cudaSetDevice", status);
      return -1;
    }
    return device;
  }
  int count = 0;
  status = cudaGetDeviceCount(&count);
  if (status != cudaSuccess) {
    *err = cuda_error("cudaGetDeviceCount", status);
    return -1;
  }
  if (device < 0 || device >= count) {
    *err = "nvjpeg: CUDA device " + std::to_string(device) +
           " is not on this host, which has " + std::to_string(count) +
           " CUDA device(s)";
    return -1;
  }
  t.release();
  status = cudaSetDevice(device);
  if (status != cudaSuccess) {
    *err = cuda_error("cudaSetDevice", status);
    return -1;
  }
  t.device = device;
  return device;
}

// The calling thread's current CUDA device, kept and put back: a caller's
// thread that decodes on another card goes on with its own current.
struct CallerDevice {
  int device = -1;
  CallerDevice() {
    if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  }
  ~CallerDevice() {
    if (device >= 0) cudaSetDevice(device);
  }
};

// nvJPEG decodes the Y, Cb and Cr planes on the thread's decode device
// (bind_decode_device; its IDCT, not libjpeg's); they are copied back and
// planes_to_image upsamples and converts them as libjpeg does. Returns
// error string or empty.
std::string decode_jpeg_full(const uint8_t* data, size_t n,
                             const FieldSpec& f, uint8_t* out) {
  if (n == 0) {  // empty payload -> zeros (the Python parser's too)
    memset(out, 0, (size_t)f.h * f.w * f.c);
    return "";
  }
  NvjpegThread& t = nvjpeg_thread;
  if (t.device < 0) return "nvjpeg: no decode device bound to this thread";
  NvjpegHandle& nv = nvjpeg_handle(t.device);
  if (!nv.handle) return nv.error;
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t status = nvjpegGetImageInfo(
      nv.handle, data, n, &ncomp, &subsampling, widths, heights);
  if (status != NVJPEG_STATUS_SUCCESS)
    return nvjpeg_error("nvjpegGetImageInfo", status, f);
  if (widths[0] != f.w || heights[0] != f.h || (ncomp != 1 && ncomp != 3))
    return dims_error(heights[0], widths[0], f);
  int hr = 1, vr = 1;
  if (ncomp == 3) {
    switch (subsampling) {
      case NVJPEG_CSS_444: break;
      case NVJPEG_CSS_422: hr = 2; break;
      case NVJPEG_CSS_420: hr = 2; vr = 2; break;
      case NVJPEG_CSS_440: vr = 2; break;
      default:
        return "jpeg: chroma subsampling " + std::to_string((int)subsampling) +
               " is not decoded by the nvJPEG build (4:4:4, 4:2:2, 4:2:0 "
               "and 4:4:0 are) for " + f.name;
    }
  }
  // Y alone where the image or the spec has one channel.
  int planes = (ncomp == 1 || f.c == 1) ? 1 : 3;
  size_t pitch[3] = {(size_t)f.w, 0, 0};
  size_t offset[3] = {0, 0, 0};
  size_t bytes = (size_t)f.w * f.h;
  for (int ci = 1; ci < planes; ci++) {
    pitch[ci] = (size_t)widths[ci];
    offset[ci] = bytes;
    bytes += (size_t)widths[ci] * heights[ci];
  }
  cudaError_t cuda_status;
  if (!t.state) {
    status = nvjpegJpegStateCreate(nv.handle, &t.state);
    if (status != NVJPEG_STATUS_SUCCESS)
      return nvjpeg_error("nvjpegJpegStateCreate", status, f);
    cuda_status = cudaStreamCreateWithFlags(&t.stream, cudaStreamNonBlocking);
    if (cuda_status != cudaSuccess)
      return cuda_error("cudaStreamCreate", cuda_status);
  }
  if (t.planes_bytes < bytes) {
    if (t.planes) cudaFree(t.planes);
    t.planes = nullptr;
    t.planes_bytes = 0;
    cuda_status = cudaMalloc((void**)&t.planes, bytes);
    if (cuda_status != cudaSuccess) return cuda_error("cudaMalloc", cuda_status);
    t.planes_bytes = bytes;
  }
  nvjpegImage_t image;
  memset(&image, 0, sizeof image);
  for (int ci = 0; ci < planes; ci++) {
    image.channel[ci] = t.planes + offset[ci];
    image.pitch[ci] = pitch[ci];
  }
  status = nvjpegDecode(nv.handle, t.state, data, n,
                        planes == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV,
                        &image, t.stream);
  if (status != NVJPEG_STATUS_SUCCESS)
    return nvjpeg_error("nvjpegDecode", status, f);
  t.host.resize(bytes);
  cuda_status = cudaMemcpyAsync(t.host.data(), t.planes, bytes,
                                cudaMemcpyDeviceToHost, t.stream);
  if (cuda_status == cudaSuccess)
    cuda_status = cudaStreamSynchronize(t.stream);
  if (cuda_status != cudaSuccess)
    return cuda_error("copying the planes back", cuda_status);
  const uint8_t* plane_ptrs[3] = {t.host.data(), t.host.data() + offset[1],
                                  t.host.data() + offset[2]};
  planes_to_image(plane_ptrs, pitch, planes, hr, vr, f.h, f.w, f.c, out);
  return "";
}

// The nvJPEG build decodes through planes only.
std::string decode_jpeg_planes(const uint8_t* data, size_t n,
                               const FieldSpec& f, uint8_t* out) {
  return decode_jpeg_full(data, n, f, out);
}

#endif

// ---------------------------------------------------------------------------
// The split decode's entropy stage: a baseline JPEG Huffman decoder.
// ---------------------------------------------------------------------------

// The port's own baseline sequential decoder, compiled into both builds: it
// stops after the entropy stage and gives what libjpeg's
// jpeg_read_coefficients gives for a baseline 4:2:0 JPEG: the quantized DCT
// coefficients (int16, natural order, DC absolute, blocks in raster order a
// component) and the quantization tables (natural order). The card's host
// has no libjpeg, and nvJPEG gives no coefficients.
//
// It reads SOI; APPn and COM (skipped); DQT (8- and 16-bit entries, several
// tables a segment); SOF0 and SOF1 (8-bit); DHT (several tables a segment);
// DRI; one SOS that interleaves the frame's three components (Ss 0, Se 63,
// Ah = Al = 0); RSTn. It refuses progressive (SOF2), lossless,
// hierarchical and arithmetic-coded JPEGs, non-interleaved scans, other
// component counts, dims and subsamplings, naming the field.
//
// Where the scan ends early (a truncated file, or a marker inside the
// data), it does what libjpeg does: the MCU that runs out reads zeros past
// the data, and every later MCU of the restart interval stays zero (a
// restart marker found in its place resumes the decode). Corrupt data that
// libjpeg only warns about otherwise (a code no table has, restart markers
// out of order) raises here.

// The natural (row-major) index of the k-th zigzag coefficient, and 16
// entries of 63 past the end, as libjpeg's jpeg_natural_order: a run that
// overshoots the block lands in its last coefficient.
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;  // codes this short decode with one table look

// A canonical Huffman table (jdhuff.c's derived table).
struct HuffTable {
  bool defined = false;
  int maxcode[18];      // the largest code of each length; -1 for none
  int valoffset[17];    // a code's symbol index less the code, by length
  uint8_t symbols[256];
  // The next kLookBits bits -> (length << 8) | symbol; 0 for longer codes.
  uint16_t look[1 << kLookBits];

  // From DHT's 16 counts and their symbols; false on a table libjpeg
  // refuses (over 256 symbols, a code that overflows its length, a DC
  // symbol above 15).
  bool build(const uint8_t counts[16], const uint8_t* values, int n,
             bool dc) {
    int sizes[257], codes[256], p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) {
        if (p >= 256) return false;
        sizes[p++] = l;
      }
    if (p != n) return false;
    sizes[p] = 0;
    int code = 0, si = sizes[0];
    p = 0;
    while (sizes[p]) {
      while (sizes[p] == si) codes[p++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - codes[p];
        p += counts[l - 1];
        maxcode[l] = codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < n; i++) {
      if (dc && values[i] > 15) return false;
      symbols[i] = values[i];
    }
    memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLookBits; l++)
      for (int i = 0; i < counts[l - 1]; i++, p++) {
        int first = codes[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); j++)
          look[first + j] = (uint16_t)((l << 8) | symbols[p]);
      }
    defined = true;
    return true;
  }
};

// The scan's bits, MSB first, with the stuffed zero of each 0xFF data byte
// taken out. The first marker ends the data (the end of the buffer reads as
// EOI, as libjpeg's memory source makes it); past the data every bit is 0,
// and a read past it marks the decoder out of data (libjpeg's
// insufficient_data).
struct ScanBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // the next ``bits`` bits at the top, zeros below
  int bits = 0;
  int marker = 0;    // the marker that ended the data; 0 before it
  bool out_of_data = false;

  void fill() {
    if (bits <= 56 && !marker && end - p >= 8) {
      // Eight bytes at once where none is 0xFF (no stuffing, no marker).
      uint64_t w;
      memcpy(&w, p, 8);
      w = __builtin_bswap64(w);
      uint64_t x = ~w;  // a 0xFF byte becomes 0x00
      if (!((x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL)) {
        int nbytes = (64 - bits) >> 3;
        buf |= (w & (~0ULL << (64 - 8 * nbytes))) >> bits;
        bits += 8 * nbytes;
        p += nbytes;
        return;
      }
    }
    while (bits <= 56 && !marker) {
      if (p >= end) {
        marker = 0xD9;
        return;
      }
      int c = *p++;
      if (c == 0xFF) {
        int d;
        do {  // fill bytes: 0xFF 0xFF ... 0x00 is one 0xFF data byte
          if (p >= end) {
            marker = 0xD9;
            return;
          }
          d = *p++;
        } while (d == 0xFF);
        if (d != 0) {
          marker = d;
          return;
        }
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }

  inline void consume(int n) {
    if (bits < n) {
      fill();
      if (bits < n) {
        out_of_data = true;
        bits = 64;  // the zeros past the data
      }
    }
    buf <<= n;
    bits -= n;
  }

  // n in 1..16 bits as an unsigned number.
  inline int get(int n) {
    if (bits < n) fill();
    int v = (int)(buf >> (64 - n));
    consume(n);
    return v;
  }

  // One Huffman symbol; -1 for a code the table does not have.
  inline int decode(const HuffTable& t) {
    if (bits < 16) fill();
    int entry = t.look[buf >> (64 - kLookBits)];
    if (entry) {
      consume(entry >> 8);
      return entry & 0xFF;
    }
    int code = (int)(buf >> 48);  // the next 16 bits
    int l = kLookBits + 1;
    while (l <= 16 && (code >> (16 - l)) > t.maxcode[l]) l++;
    if (l > 16) return -1;
    consume(l);
    return t.symbols[t.valoffset[l] + (code >> (16 - l))];
  }

  // libjpeg's process_restart: the bits left are dropped and the marker
  // next in the data is read. The expected RSTn resumes the data; another
  // marker (EOI where the file ends) stays unread, so the interval reads
  // as empty. Returns false for restart markers out of order.
  bool restart(int expected) {
    buf = 0;
    bits = 0;
    int m = marker;
    while (!m) {  // libjpeg's next_marker: bytes before the marker skipped
      if (p >= end) {
        m = 0xD9;
        break;
      }
      if (*p++ != 0xFF) continue;
      while (p < end && *p == 0xFF) p++;
      if (p >= end) {
        m = 0xD9;
        break;
      }
      int d = *p++;
      if (d != 0) m = d;
    }
    if (m == 0xD0 + expected) {
      marker = 0;
      out_of_data = false;
      return true;
    }
    marker = m;
    return m >= 0xC0 && !(m >= 0xD0 && m <= 0xD7);
  }
};

inline int huff_extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v;
}

// One symbol and its value bits (at most 16 + 15): a table look where the
// buffer holds 31 bits, else the careful path that reads zeros past the
// data. Returns the symbol, its value in *value; -1 for a bad code.
inline int decode_symbol(ScanBits& in, const HuffTable& t, int* value) {
  if (in.bits < 31) in.fill();
  if (in.bits >= 31) {
    int entry = t.look[in.buf >> (64 - kLookBits)];
    int sym;
    if (entry) {
      int len = entry >> 8;
      in.buf <<= len;
      in.bits -= len;
      sym = entry & 0xFF;
    } else {
      sym = in.decode(t);
      if (sym < 0) return -1;
    }
    int s = sym & 15;
    if (s) {
      int v = (int)(in.buf >> (64 - s));
      in.buf <<= s;
      in.bits -= s;
      *value = huff_extend(v, s);
    }
    return sym;
  }
  int sym = in.decode(t);
  if (sym > 0 && (sym & 15)) *value = huff_extend(in.get(sym & 15), sym & 15);
  return sym;
}

// One 8x8 block: the DC difference onto ``*pred``, then the AC run-lengths
// in zigzag order (libjpeg's decode_mcu). False on a bad code.
inline bool decode_block(ScanBits& in, const HuffTable& dc,
                         const HuffTable& ac, int* pred, int16_t* block) {
  int value = 0;
  int s = decode_symbol(in, dc, &value);
  if (s < 0) return false;
  *pred = (int)((unsigned)*pred + (unsigned)(s ? value : 0));
  block[0] = (int16_t)*pred;
  for (int k = 1; k < 64; k++) {
    s = decode_symbol(in, ac, &value);
    if (s < 0) return false;
    int r = s >> 4;
    if (s & 15) {
      k += r;
      block[kNaturalOrder[k]] = (int16_t)value;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

std::string coef_error(const char* mode, const char* what,
                       const FieldSpec& f) {
  return std::string(mode) + ": " + what + ": " + f.name;
}

// Decodes one JPEG's scan into ``y`` ([H/8, W/8, 64]), ``cb`` and ``cr``
// ([H/16, W/16, 64]) and its tables into ``qt`` ([3, 64], luma, cb, cr:
// the frame's component order); ``mode`` prefixes the errors as the JAX
// loader's ('image_coef', 'image_coef_sparse', 'image_coef_packed').
std::string decode_jpeg_coefficients(const uint8_t* data, size_t n,
                                     const FieldSpec& f, const char* mode,
                                     int16_t* y, int16_t* cb, int16_t* cr,
                                     uint16_t* qt) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  if (n < 2 || p[0] != 0xFF || p[1] != 0xD8)
    return coef_error(mode, "jpeg: not a JPEG file (no SOI marker)", f);
  p += 2;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  HuffTable dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool have_frame = false;
  int comp_id[3], comp_quant[3];
  for (;;) {
    // The next marker; fill bytes (0xFF) may precede it.
    if (p >= end || *p != 0xFF)
      return coef_error(mode, "jpeg: no marker where one must be", f);
    while (p < end && *p == 0xFF) p++;
    if (p >= end) return coef_error(mode, "jpeg: the file ends early", f);
    int marker = *p++;
    if (marker == 0xD9)
      return coef_error(mode, "jpeg: no scan before EOI", f);
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (end - p < 2) return coef_error(mode, "jpeg: the file ends early", f);
    int length = (p[0] << 8) | p[1];
    if (length < 2 || end - p < length)
      return coef_error(mode, "jpeg: a marker segment overruns the file", f);
    const uint8_t* seg = p + 2;
    const uint8_t* seg_end = p + length;
    p = seg_end;
    if (marker == 0xC2)
      return coef_error(mode, "progressive JPEG (SOF2) is not decoded by "
                        "the port's baseline decoder", f);
    if ((marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 &&
         marker != 0xC8) || marker == 0xCC)
      return coef_error(mode, "not a baseline JPEG (lossless, hierarchical "
                        "or arithmetic-coded frames are not decoded by the "
                        "port's baseline decoder)", f);
    if (marker == 0xC0 || marker == 0xC1) {
      if (seg_end - seg < 6) return coef_error(mode, "jpeg: bad SOF", f);
      if (seg[0] != 8)
        return coef_error(mode, "jpeg: not an 8-bit JPEG", f);
      int height = (seg[1] << 8) | seg[2], width = (seg[3] << 8) | seg[4];
      int ncomp = seg[5];
      if (seg_end - seg < 6 + 3 * ncomp)
        return coef_error(mode, "jpeg: bad SOF", f);
      if (ncomp != 3) return coef_error(mode, "not a 3-component JPEG", f);
      if (width != f.w || height != f.h)
        return std::string(mode) + ": dims mismatch for " + f.name;
      const uint8_t* c = seg + 6;
      static const int kSampling[3] = {0x22, 0x11, 0x11};
      for (int i = 0; i < 3; i++) {
        comp_id[i] = c[3 * i];
        if (c[3 * i + 1] != kSampling[i])
          return coef_error(mode, "requires 4:2:0 chroma subsampling", f);
        comp_quant[i] = c[3 * i + 2];
      }
      if (comp_id[0] == comp_id[1] || comp_id[0] == comp_id[2] ||
          comp_id[1] == comp_id[2])
        return coef_error(mode, "jpeg: duplicate component ids", f);
      have_frame = true;
    } else if (marker == 0xDB) {
      while (seg < seg_end) {
        int precision = seg[0] >> 4, index = seg[0] & 15;
        int entry = precision ? 2 : 1;
        if (index > 3 || precision > 1 || seg_end - seg < 1 + 64 * entry)
          return coef_error(mode, "jpeg: bad DQT", f);
        seg++;
        for (int i = 0; i < 64; i++, seg += entry)
          quant[index][kNaturalOrder[i]] =
              precision ? (uint16_t)((seg[0] << 8) | seg[1]) : seg[0];
        quant_defined[index] = true;
      }
    } else if (marker == 0xC4) {
      while (seg < seg_end) {
        if (seg_end - seg < 17) return coef_error(mode, "jpeg: bad DHT", f);
        int cls = seg[0] >> 4, index = seg[0] & 15;
        int total = 0;
        for (int i = 0; i < 16; i++) total += seg[1 + i];
        if (cls > 1 || index > 3 || seg_end - seg < 17 + total)
          return coef_error(mode, "jpeg: bad DHT", f);
        HuffTable& t = cls ? ac_tables[index] : dc_tables[index];
        if (!t.build(seg + 1, seg + 17, total, cls == 0))
          return coef_error(mode, "jpeg: bogus Huffman table definition", f);
        seg += 17 + total;
      }
    } else if (marker == 0xDD) {
      if (seg_end - seg < 2) return coef_error(mode, "jpeg: bad DRI", f);
      restart_interval = (seg[0] << 8) | seg[1];
    } else if (marker == 0xDA) {
      if (!have_frame) return coef_error(mode, "jpeg: SOS before SOF", f);
      int ns = seg < seg_end ? seg[0] : 0;
      if (ns != 3 || seg_end - seg < 1 + 2 * ns + 3)
        return coef_error(mode, "the scan does not interleave the three "
                          "components (a non-interleaved scan is not "
                          "decoded by the port's baseline decoder)", f);
      const uint8_t* sp = seg + 1 + 2 * ns;
      if (sp[0] != 0 || sp[1] != 63 || sp[2] != 0)
        return coef_error(mode, "jpeg: not a sequential scan", f);
      for (int i = 0; i < 3; i++)
        if (comp_quant[i] > 3 || !quant_defined[comp_quant[i]])
          return coef_error(mode, "missing quant table", f);
      // Each scan component: its frame index and tables, in scan order,
      // which need not be the frame's.
      struct ScanComp {
        int16_t* plane;
        int blocks_wide, h, v;
        const HuffTable* dc;
        const HuffTable* ac;
        int pred;
      } comps[3];
      int16_t* planes[3] = {y, cb, cr};
      bool used[3] = {false, false, false};
      for (int s = 0; s < 3; s++) {
        int id = seg[1 + 2 * s], tables = seg[2 + 2 * s];
        int c = 0;
        while (c < 3 && comp_id[c] != id) c++;
        if (c == 3 || used[c])
          return coef_error(mode, "jpeg: a scan component the frame does "
                            "not have", f);
        used[c] = true;
        int td = tables >> 4, ta = tables & 15;
        if (td > 3 || ta > 3 || !dc_tables[td].defined ||
            !ac_tables[ta].defined)
          return coef_error(mode, "jpeg: a Huffman table was not defined",
                            f);
        comps[s] = {planes[c], c == 0 ? f.w / 8 : f.w / 16, c == 0 ? 2 : 1,
                    c == 0 ? 2 : 1, &dc_tables[td], &ac_tables[ta], 0};
      }
      for (int c = 0; c < 3; c++)
        for (int i = 0; i < 64; i++) qt[c * 64 + i] = quant[comp_quant[c]][i];
      memset(y, 0, (size_t)(f.h / 8) * (f.w / 8) * 64 * 2);
      memset(cb, 0, (size_t)(f.h / 16) * (f.w / 16) * 64 * 2);
      memset(cr, 0, (size_t)(f.h / 16) * (f.w / 16) * 64 * 2);
      ScanBits bits{seg_end, end};
      int mcus_wide = f.w / 16, mcus_high = f.h / 16;
      long long mcu = 0;
      int next_restart = 0;
      for (int my = 0; my < mcus_high; my++) {
        for (int mx = 0; mx < mcus_wide; mx++, mcu++) {
          if (restart_interval && mcu && mcu % restart_interval == 0) {
            if (!bits.restart(next_restart))
              return coef_error(mode, "jpeg: restart markers out of order",
                                f);
            next_restart = (next_restart + 1) & 7;
            for (auto& sc : comps) sc.pred = 0;
          }
          if (bits.out_of_data) continue;  // the interval's rest stays 0
          for (auto& sc : comps) {
            for (int v = 0; v < sc.v; v++) {
              for (int h = 0; h < sc.h; h++) {
                int16_t* block =
                    sc.plane + ((long long)(my * sc.v + v) * sc.blocks_wide +
                                mx * sc.h + h) * 64;
                if (!decode_block(bits, *sc.dc, *sc.ac, &sc.pred, block))
                  return coef_error(mode, "jpeg: corrupt Huffman code", f);
              }
            }
          }
        }
      }
      return "";
    } else if ((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE) {
      // APPn, COM: skipped.
    } else {
      char buf[96];
      snprintf(buf, sizeof buf, "jpeg: unsupported marker 0x%02X", marker);
      return coef_error(mode, buf, f);
    }
  }
}

// A worker's planes [y | cb | cr] of one frame, for the sparse and packed
// wires (the dense mode decodes into its row).
thread_local std::vector<int16_t> coef_scratch;

// image_coef: the planes and tables straight into the row; an empty
// payload is an all-zero image with all-ones tables (a well-defined
// dequantize), as in the JAX loader.
std::string decode_jpeg_coef(const uint8_t* data, size_t n,
                             const FieldSpec& f, int16_t* y, int16_t* cb,
                             int16_t* cr, uint16_t* qt) {
  if (n == 0) {
    memset(y, 0, (size_t)(f.h / 8) * (f.w / 8) * 64 * 2);
    memset(cb, 0, (size_t)(f.h / 16) * (f.w / 16) * 64 * 2);
    memset(cr, 0, (size_t)(f.h / 16) * (f.w / 16) * 64 * 2);
    for (int i = 0; i < 3 * 64; i++) qt[i] = 1;
    return "";
  }
  return decode_jpeg_coefficients(data, n, f, "image_coef", y, cb, cr, qt);
}

// image_coef_sparse: the quantized coefficients of a camera JPEG are mostly
// zero, so this mode emits a (delta, value) entry stream a frame over the
// flat coefficient space [y blocks | cb blocks | cr blocks] in block-row-
// major natural order:
//
//   entry (d, v): advance the cursor by d positions, then ADD v at the
//   cursor. d is uint8, v is int8. Long zero gaps become (255, 0) skip
//   entries; values outside int8 become (0, piece) continuation entries
//   that add onto the same position; buffer tail padding is (0, 0), a
//   no-op. The device undoes it with one cumsum and one scatter-add
//   (data/jpeg_device.py unpack_sparse_coefficients).
std::string decode_jpeg_coef_sparse(const uint8_t* data, size_t n,
                                    const FieldSpec& f, uint8_t* sd,
                                    int8_t* sv, uint16_t* qt,
                                    int32_t* count_out) {
  const long long cap = f.count;
  const long long yn = (long long)(f.h / 8) * (f.w / 8) * 64;
  const long long cn = (long long)(f.h / 16) * (f.w / 16) * 64;
  const long long total = yn + 2 * cn;
  if (n == 0) {  // empty payload -> all-zero image
    memset(sd, 0, cap);
    memset(sv, 0, cap);
    for (int i = 0; i < 3 * 64; i++) qt[i] = 1;
    *count_out = 0;
    return "";
  }
  std::vector<int16_t>& coef = coef_scratch;
  coef.resize(total);
  std::string err = decode_jpeg_coefficients(
      data, n, f, "image_coef_sparse", coef.data(), coef.data() + yn,
      coef.data() + yn + cn, qt);
  if (!err.empty()) return err;
  long long cur = -1, cnt = 0;
  bool overflow = false;
  // Slow path: long gaps (>255) and wide values (|v|>127) via skip /
  // continuation entries.
  auto emit_slow = [&](long long pos, int v) {
    long long diff = pos - cur;
    while (diff > 255) {
      if (cnt >= cap) { overflow = true; return; }
      sd[cnt] = 255;
      sv[cnt] = 0;
      cnt++;
      diff -= 255;
    }
    int piece = v < -128 ? -128 : (v > 127 ? 127 : v);
    if (cnt >= cap) { overflow = true; return; }
    sd[cnt] = (uint8_t)diff;
    sv[cnt] = (int8_t)piece;
    cnt++;
    v -= piece;
    while (v != 0) {  // |coef| > 127: add onto the same position
      piece = v < -128 ? -128 : (v > 127 ? 127 : v);
      if (cnt >= cap) { overflow = true; return; }
      sd[cnt] = 0;
      sv[cnt] = (int8_t)piece;
      cnt++;
      v -= piece;
    }
    cur = pos;
  };
  auto emit = [&](long long pos, int v) {
    long long diff = pos - cur;
    if (diff <= 255 && v >= -128 && v <= 127 && cnt < cap) {
      sd[cnt] = (uint8_t)diff;
      sv[cnt] = (int8_t)v;
      cnt++;
      cur = pos;
      return;
    }
    emit_slow(pos, v);
  };
  const int16_t* c = coef.data();
  for (long long g = 0; g < total && !overflow; g += 16) {
    // Zero coefficients dominate: find the nonzeros of 16 at a time.
#if defined(__SSE2__)
    __m128i a = _mm_loadu_si128((const __m128i*)(c + g));
    __m128i b = _mm_loadu_si128((const __m128i*)(c + g + 8));
    __m128i zero = _mm_setzero_si128();
    uint32_t z = (uint32_t)_mm_movemask_epi8(_mm_packs_epi16(
        _mm_cmpeq_epi16(a, zero), _mm_cmpeq_epi16(b, zero)));
    uint32_t nz = ~z & 0xFFFFu;  // bit i set <=> c[g + i] != 0
    while (nz && !overflow) {
      int k = __builtin_ctz(nz);
      nz &= nz - 1;
      emit(g + k, c[g + k]);
    }
#else
    for (int k = 0; k < 16 && !overflow; k++)
      if (c[g + k]) emit(g + k, c[g + k]);
#endif
  }
  if (overflow) {
    char buf[192];
    snprintf(buf, sizeof buf,
             "image_coef_sparse: entry capacity %lld exceeded for '%s' "
             "(unusually dense JPEG); raise sparse_density or use "
             "image_mode='coef'",
             cap, f.name.c_str());
    return buf;
  }
  // Tail padding MUST be zeroed: buffers are recycled across batches and a
  // stale nonzero delta would silently corrupt positions on the device.
  memset(sd + cnt, 0, cap - cnt);
  memset(sv + cnt, 0, cap - cnt);
  *count_out = (int32_t)cnt;
  return "";
}

// image_coef_packed: the coef_sparse stream tightened.
//
//   * AC nibble stream (buf0, uint8): one byte per AC nonzero in the flat
//     space [y | cb | cr] (natural order, DC slots skipped). High nibble d
//     = position gap (0..15), low nibble v = value code:
//       v in 1..7            -> value +v
//       v in 9..15           -> value v-16 (i.e. -7..-1)
//       v == 8               -> ESCAPE: value is the next int16 of the
//                               escape stream (AC region)
//       v == 0, d > 0        -> skip byte: advance d*16, no value
//       0x00                 -> no-op (tail padding)
//   * DC nibble plane (buf_cr, uint8): one 4-bit code a block, two a byte
//     low nibble first, carrying the cross-block DC delta chain (the
//     previous DC starts at 0 and runs across component boundaries):
//       code in 0..7   -> delta +code     code in 9..15 -> delta code-16
//       code == 8      -> ESCAPE: delta is the next int16 of the escape
//                         stream (DC region)
//   * Escape stream (buf_cb, int16): the DC escapes first (frame order),
//     then the AC escapes (stream order).
//   * Quant tables (buf_qt): a row's here; the Python side ships one a
//     batch. An empty payload writes zero tables, the "no table" sentinel
//     that the batch's uniformity check skips.
std::string decode_jpeg_coef_packed(const uint8_t* data, size_t n,
                                    const FieldSpec& f, uint8_t* pw,
                                    int16_t* se, uint8_t* dcn, uint16_t* qt,
                                    int32_t* n_out, int32_t* ne_out) {
  const long long cap = f.count;
  const long long esc_cap = f.packed_escape_cap();
  const long long n_dc = f.packed_dc_count();
  if (n == 0) {  // empty payload -> all-zero image
    memset(pw, 0, cap);
    memset(se, 0, esc_cap * 2);
    memset(dcn, 0, n_dc / 2);
    memset(qt, 0, 3 * 64 * 2);
    *n_out = 0;
    *ne_out = 0;
    return "";
  }
  const long long yn = (long long)(f.h / 8) * (f.w / 8) * 64;
  const long long cn = (long long)(f.h / 16) * (f.w / 16) * 64;
  std::vector<int16_t>& coef = coef_scratch;
  coef.resize(yn + 2 * cn);
  std::string err = decode_jpeg_coefficients(
      data, n, f, "image_coef_packed", coef.data(), coef.data() + yn,
      coef.data() + yn + cn, qt);
  if (!err.empty()) return err;
  long long cur = -1, na = 0;
  bool overflow = false;
  // Escape regions buffered apart: the wire holds [DC escapes | AC
  // escapes], but the scan meets them interleaved.
  std::vector<int16_t> dc_esc, ac_esc;
  auto emit_ac = [&](long long pos, int v) {
    long long gap = pos - cur;
    cur = pos;
    while (gap > 15) {
      long long s = gap >> 4;
      if (s > 15) s = 15;
      if (na >= cap) { overflow = true; return; }
      pw[na++] = (uint8_t)(s << 4);
      gap -= s * 16;
    }
    if (na >= cap) { overflow = true; return; }
    if (v >= -7 && v <= 7)
      pw[na++] = (uint8_t)((gap << 4) | (v & 0xF));
    else {
      pw[na++] = (uint8_t)((gap << 4) | 8);
      ac_esc.push_back((int16_t)v);
    }
  };
  int prev_dc = 0;
  memset(dcn, 0, n_dc / 2);
  const int16_t* c = coef.data();
  for (long long block = 0; block < n_dc && !overflow; block++) {
    const int16_t* b = c + block * 64;
    long long block_base = block * 64;
    // DC: the cross-block delta chain into the nibble plane.
    int dc_delta = b[0] - prev_dc;
    prev_dc = b[0];
    uint8_t code;
    if (dc_delta >= -7 && dc_delta <= 7) {
      code = (uint8_t)(dc_delta & 0xF);
    } else {
      code = 8;
      dc_esc.push_back((int16_t)dc_delta);
    }
    dcn[block >> 1] |= (block & 1) ? (uint8_t)(code << 4) : code;
    // AC: the nonzeros of k = 1..63, 16 at a time.
    for (int g = 0; g < 4 && !overflow; g++) {
#if defined(__SSE2__)
      __m128i x0 = _mm_loadu_si128((const __m128i*)(b + g * 16));
      __m128i x1 = _mm_loadu_si128((const __m128i*)(b + g * 16 + 8));
      __m128i zero = _mm_setzero_si128();
      uint32_t z = (uint32_t)_mm_movemask_epi8(_mm_packs_epi16(
          _mm_cmpeq_epi16(x0, zero), _mm_cmpeq_epi16(x1, zero)));
      uint32_t nz = ~z & 0xFFFFu;
      if (g == 0) nz &= ~1u;  // k == 0 is the DC slot
      while (nz && !overflow) {
        int k = g * 16 + __builtin_ctz(nz);
        nz &= nz - 1;
        emit_ac(block_base + k, b[k]);
      }
#else
      for (int k = g == 0 ? 1 : g * 16; k < g * 16 + 16 && !overflow; k++)
        if (b[k]) emit_ac(block_base + k, b[k]);
#endif
    }
  }
  long long ne = (long long)(dc_esc.size() + ac_esc.size());
  if (overflow || ne > esc_cap) {
    char buf[192];
    snprintf(buf, sizeof buf,
             "image_coef_packed: %s capacity %lld exceeded for '%s' "
             "(unusually dense JPEG); raise sparse_density or use "
             "image_mode='coef'",
             overflow ? "stream byte" : "escape", overflow ? cap : esc_cap,
             f.name.c_str());
    return buf;
  }
  if (!dc_esc.empty()) memcpy(se, dc_esc.data(), dc_esc.size() * 2);
  if (!ac_esc.empty())
    memcpy(se + dc_esc.size(), ac_esc.data(), ac_esc.size() * 2);
  // Tails MUST be zeroed: buffers recycle across batches, and a stale
  // nonzero nibble would silently corrupt positions on the device.
  memset(pw + na, 0, cap - na);
  memset(se + ne, 0, (esc_cap - ne) * 2);
  *n_out = (int32_t)na;
  *ne_out = (int32_t)ne;
  return "";
}

// ---------------------------------------------------------------------------
// Loader.
// ---------------------------------------------------------------------------

// Monotonic microseconds for the pipeline-stats busy/idle accounting:
// steady_clock, never wall time.
inline long long now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

enum SlotState { kFree, kFilling, kReady, kInUse };

struct Slot {
  std::vector<uint8_t*> buffers;
  std::atomic<int> remaining{0};
  SlotState state = kFree;
  long long seq = -1;  // batch sequence number, for ordered hand-off
  // First row error in this batch, if any (guarded by Loader::mu). The
  // fail/discard decision is deferred to batch COMPLETION so that an
  // error in the EOF-discarded partial batch (drop_remainder semantics)
  // is swallowed deterministically — at completion time the reader has
  // either marked the slot seq = -2 or never will.
  std::string row_error;
};

struct WorkItem {
  std::vector<std::string> records;  // one record per dataset group
  int slot;
  int row;
};

struct Loader {
  Config cfg;
  std::deque<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;    // consumer waits
  std::condition_variable cv_free;     // reader waits for a free slot
  std::condition_variable cv_work;     // workers wait
  std::condition_variable cv_space;    // reader waits for queue space
  std::deque<WorkItem> work;
  std::deque<int> ready;               // READY slot indices in seq order
  bool eof = false;                    // reader finished dispatching
  std::atomic<bool> stop{false};
  std::string error;
  long long dispatched_batches = 0;
  long long completed_batches = 0;
  long long next_seq_out = 0;          // strict batch delivery order
  std::vector<std::thread> threads;
  std::thread reader;
  // Worker/reader threads launch lazily on the FIRST next_slot() call,
  // not at create time: create-time work is config parsing + buffer
  // allocation only (errors surface synchronously), and every data/parse
  // error has exactly ONE surfacing point — iteration. This is what
  // makes error delivery deterministic instead of a race between the
  // eagerly-parsing workers and the constructor's last_error poll.
  std::once_flag launch_once;

  // ---- pipeline stats (t2r_loader_stats export) ---------------------------
  // Cumulative, relaxed atomics written from the reader/worker threads
  // and read racily by the consumer — the Python X-ray layer windows the
  // deltas, so torn cross-field reads only cost sub-window skew. Safe to
  // read BEFORE the lazy thread launch (all zeros) and after EOF.
  std::atomic<long long> st_records_read{0};   // records framed off disk
  std::atomic<long long> st_bytes_read{0};     // incl. TFRecord framing
  std::atomic<long long> st_reader_busy_us{0}; // read + shuffle time
  std::atomic<long long> st_reader_wait_us{0}; // blocked on slots/space
  std::atomic<long long> st_rows_parsed{0};    // batch rows completed
  std::atomic<long long> st_parse_bytes{0};    // record bytes parsed
  std::atomic<long long> st_worker_busy_us{0}; // parse/decode, pool total
  std::atomic<long long> st_worker_idle_us{0}; // waiting for work, total
  // The CUDA device the workers bound for nvJPEG (-1: none yet, or the
  // libjpeg build, which uses no card).
  std::atomic<long long> st_decode_device{-1};
  std::unique_ptr<std::atomic<long long>[]> st_per_worker_busy_us;

  long long stats_snapshot(long long* out, int n) {
    long long min_busy = 0, max_busy = 0;
    if (st_per_worker_busy_us && cfg.threads > 0) {
      min_busy = max_busy =
          st_per_worker_busy_us[0].load(std::memory_order_relaxed);
      for (int i = 1; i < cfg.threads; i++) {
        long long v =
            st_per_worker_busy_us[i].load(std::memory_order_relaxed);
        if (v < min_busy) min_busy = v;
        if (v > max_busy) max_busy = v;
      }
    }
    long long completed;
    {
      std::lock_guard<std::mutex> lk(mu);
      completed = completed_batches;
    }
    const long long vals[13] = {
        st_records_read.load(std::memory_order_relaxed),
        st_bytes_read.load(std::memory_order_relaxed),
        st_reader_busy_us.load(std::memory_order_relaxed),
        st_reader_wait_us.load(std::memory_order_relaxed),
        st_rows_parsed.load(std::memory_order_relaxed),
        st_parse_bytes.load(std::memory_order_relaxed),
        st_worker_busy_us.load(std::memory_order_relaxed),
        st_worker_idle_us.load(std::memory_order_relaxed),
        (long long)cfg.threads,
        completed,
        min_busy,
        max_busy,
        st_decode_device.load(std::memory_order_relaxed),
    };
    int m = n < 13 ? n : 13;
    for (int i = 0; i < m; i++) out[i] = vals[i];
    return m;
  }

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    cv_free.notify_all();
    cv_space.notify_all();
    cv_ready.notify_all();
    if (reader.joinable()) reader.join();
    for (auto& t : threads)
      if (t.joinable()) t.join();
    for (auto& s : slots)
      for (auto* b : s.buffers) free(b);
    slots.clear();
  }

  void fail(const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu);
    if (error.empty()) error = msg;
    stop = true;
    cv_ready.notify_all();
    cv_work.notify_all();
    cv_free.notify_all();
    cv_space.notify_all();
  }

  // ---- reader ------------------------------------------------------------

  bool dispatch_row(std::vector<std::string>&& recs, int* cur_slot,
                    int* cur_row, long long* seq) {
    if (*cur_slot < 0) {  // acquire a free slot
      long long t0 = now_us();
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] {
        if (stop) return true;
        for (auto& s : slots)
          if (s.state == kFree) return true;
        return false;
      });
      st_reader_wait_us.fetch_add(now_us() - t0, std::memory_order_relaxed);
      if (stop) return false;
      for (size_t i = 0; i < slots.size(); i++) {
        if (slots[i].state == kFree) {
          slots[i].state = kFilling;
          slots[i].remaining.store(cfg.batch_size);
          slots[i].seq = (*seq)++;
          slots[i].row_error.clear();
          *cur_slot = (int)i;
          *cur_row = 0;
          break;
        }
      }
    }
    {
      long long t0 = now_us();
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop || work.size() < (size_t)(4 * cfg.threads + 64);
      });
      st_reader_wait_us.fetch_add(now_us() - t0, std::memory_order_relaxed);
      if (stop) return false;
      work.push_back(WorkItem{std::move(recs), *cur_slot, *cur_row});
    }
    cv_work.notify_one();
    if (++*cur_row == cfg.batch_size) {
      *cur_slot = -1;
      std::lock_guard<std::mutex> lk(mu);
      dispatched_batches++;
    }
    return true;
  }

  // One dataset group's record source: its file list looped over the
  // configured epochs, with the group's OWN bounded reservoir shuffle —
  // the Python pipeline shuffles each zipped dataset independently
  // before pairing (pipeline.py _record_tuples), so the native zip does
  // too. reader_main pulls the groups in lockstep to form zip tuples
  // (one record per group per row); the single-dataset case is one
  // stream, where the per-stream reservoir is exactly the old
  // emit-level one.
  struct RecordStream {
    Loader* loader = nullptr;
    const std::vector<std::string>* files = nullptr;
    std::mt19937_64* rng = nullptr;
    long long epoch = 0;
    size_t file_idx = 0;
    std::vector<std::string> order;
    FILE* f = nullptr;
    long file_size = 0;
    std::vector<std::string> shuffle_buf;
    bool exhausted = false;

    ~RecordStream() {
      if (f) fclose(f);
    }

    // 1 = record read, 0 = clean end of data (or stop), -1 = error.
    int next(std::string* rec, std::string* err) {
      const Config& cfg = loader->cfg;
      if (!cfg.shuffle) return read_raw(rec, err);
      while (!exhausted &&
             (int)shuffle_buf.size() < cfg.shuffle_buffer) {
        std::string r;
        int status = read_raw(&r, err);
        if (status < 0) return -1;
        if (status == 0) {
          exhausted = true;
          break;
        }
        shuffle_buf.push_back(std::move(r));
      }
      if (shuffle_buf.empty()) return 0;
      size_t idx = (*rng)() % shuffle_buf.size();
      std::swap(shuffle_buf[idx], shuffle_buf.back());
      *rec = std::move(shuffle_buf.back());
      shuffle_buf.pop_back();
      return 1;
    }

    int read_raw(std::string* rec, std::string* err) {
      const Config& cfg = loader->cfg;
      for (;;) {
        if (loader->stop.load()) return 0;
        if (f == nullptr) {
          if (order.empty() || file_idx >= order.size()) {
            if (!order.empty()) epoch++;
            if (cfg.epochs >= 0 && epoch >= cfg.epochs) return 0;
            if (order.empty()) order = *files;
            if (cfg.shuffle) std::shuffle(order.begin(), order.end(), *rng);
            file_idx = 0;
          }
          const std::string& path = order[file_idx];
          f = fopen(path.c_str(), "rb");
          if (!f) {
            *err = "cannot open " + path;
            return -1;
          }
          fseek(f, 0, SEEK_END);
          file_size = ftell(f);
          fseek(f, 0, SEEK_SET);
        }
        const std::string& path = order[file_idx];
        uint8_t header[12];
        if (fread(header, 1, 12, f) != 12) {  // end of this file
          fclose(f);
          f = nullptr;
          file_idx++;
          continue;
        }
        uint64_t len;
        memcpy(&len, header, 8);
        // Sanity-cap the untrusted length BEFORE resize: a corrupt frame
        // (or a non-TFRecord file matched by the glob) must surface as a
        // loader error, not a std::bad_alloc escaping the thread.
        long pos = ftell(f);
        if (pos < 0 || len > (uint64_t)(file_size - pos)) {
          *err = "corrupt or non-TFRecord frame in " + path +
                 " (record length exceeds file size)";
          return -1;
        }
        if (cfg.verify_crc) {
          uint32_t expect;
          memcpy(&expect, header + 8, 4);
          if (masked_crc(header, 8) != expect) {
            *err = "corrupt TFRecord length CRC in " + path;
            return -1;
          }
        }
        rec->resize(len);
        if (len > 0 && fread(&(*rec)[0], 1, len, f) != len) {
          *err = "truncated TFRecord in " + path;
          return -1;
        }
        uint8_t footer[4];
        if (fread(footer, 1, 4, f) != 4) {
          *err = "truncated TFRecord in " + path;
          return -1;
        }
        if (cfg.verify_crc) {
          uint32_t expect;
          memcpy(&expect, footer, 4);
          if (masked_crc((const uint8_t*)rec->data(), rec->size()) !=
              expect) {
            *err = "corrupt TFRecord data CRC in " + path;
            return -1;
          }
        }
        loader->st_records_read.fetch_add(1, std::memory_order_relaxed);
        loader->st_bytes_read.fetch_add(16 + (long long)len,
                                        std::memory_order_relaxed);
        return 1;
      }
    }
  };

  void reader_main() {
    std::mt19937_64 rng(cfg.seed >= 0 ? (uint64_t)cfg.seed
                                      : std::random_device{}());
    int cur_slot = -1, cur_row = 0;
    long long seq = 0;

    const size_t n_groups = cfg.groups.size();
    std::vector<RecordStream> streams(n_groups);
    for (size_t g = 0; g < n_groups; g++) {
      streams[g].loader = this;
      streams[g].files = &cfg.groups[g];
      streams[g].rng = &rng;
    }
    for (;;) {
      std::vector<std::string> tuple(n_groups);
      bool end_of_data = false;
      long long t0 = now_us();
      for (size_t g = 0; g < n_groups; g++) {
        std::string err;
        int status = streams[g].next(&tuple[g], &err);
        if (status < 0) {
          fail(err);
          return;
        }
        if (status == 0) {  // zip ends with the shortest dataset
          end_of_data = true;
          break;
        }
      }
      st_reader_busy_us.fetch_add(now_us() - t0, std::memory_order_relaxed);
      if (end_of_data) break;
      if (!dispatch_row(std::move(tuple), &cur_slot, &cur_row, &seq))
        return;
    }
    if (stop) return;
    // Partial batch at end of data is dropped (drop_remainder=True, as the
    // Python pipeline does): mark the half-filled slot free again.
    {
      std::lock_guard<std::mutex> lk(mu);
      if (cur_slot >= 0 && cur_row > 0) {
        // 'remaining' was initialized to batch_size; subtract the rows that
        // were never dispatched. Whoever's subtraction transitions the count
        // to exactly 0 owns recycling the slot: if our fetch_sub consumed the
        // whole residue (prev == subtracted), every dispatched row already
        // finished and no worker will touch the slot again; otherwise the
        // last in-flight worker sees prev==1 and checks seq == -2 (set here,
        // under the same mutex its check takes).
        int sub = cfg.batch_size - cur_row;
        int prev = slots[cur_slot].remaining.fetch_sub(sub);
        if (prev == sub)
          slots[cur_slot].state = kFree;
        else
          slots[cur_slot].seq = -2;  // sentinel: discard on completion
      }
      eof = true;
    }
    cv_ready.notify_all();
  }

  // ---- workers -----------------------------------------------------------

  // Walks one map entry ({1: key-bytes, 2: value-message}) shared by the
  // Features and FeatureLists sides. Returns the matched field index among
  // fields of dataset ``dsi`` whose (seq_cap > 0) equals ``sequence``, or
  // -1; *value_out gets the value message cursor.
  int match_entry(Cursor entry, bool sequence, int dsi, Cursor* value_out) {
    const uint8_t* key_p = nullptr;
    size_t key_n = 0;
    Cursor value{nullptr, nullptr};
    uint32_t wt;
    while (uint32_t f3 = entry.tag(&wt)) {
      if (f3 == 1 && wt == 2) {
        Cursor k = entry.bytes();
        key_p = k.p;
        key_n = k.size();
      } else if (f3 == 2 && wt == 2) {
        value = entry.bytes();
      } else {
        entry.skip(wt);
      }
    }
    if (!key_p || !value.p) return -1;
    // Linear scan: few fields, avoids hashing every record key.
    for (size_t i = 0; i < cfg.fields.size(); i++) {
      const FieldSpec& f = cfg.fields[i];
      if ((f.seq_cap > 0) != sequence || f.dsi != dsi) continue;
      if (f.name.size() == key_n &&
          memcmp(f.name.data(), key_p, key_n) == 0) {
        *value_out = value;
        return (int)i;
      }
    }
    return -1;
  }

  // Zeroes one row of an optional field that the record omitted. The
  // Python side drops the whole key from any batch whose presence flags
  // are not all-ones (the Python parser's dense-batch semantics), so the
  // zeros are recycling hygiene, never observable data.
  void zero_field_row(const FieldSpec& f, Slot& slot, int row) {
    if (f.seq_cap > 0) {
      int width = f.kind == kFloat ? 4 : f.dtype_size;
      long long bytes = f.seq_cap * f.count * width;
      memset(slot.buffers[f.buf0] + (long long)row * bytes, 0,
             (size_t)bytes);
      ((int32_t*)slot.buffers[f.buf_n])[row] = 0;
      return;
    }
    long long width = f.kind == kFloat ? 4
                      : f.kind == kInt ? f.dtype_size
                                       : (long long)f.h * f.w * f.c;
    long long bytes = f.kept() * width;
    memset(slot.buffers[f.buf0] + (long long)row * bytes, 0, (size_t)bytes);
  }

  std::string parse_record(const std::string& rec, int dsi, Slot& slot,
                           int row, std::vector<bool>* found) {
    Cursor ex{(const uint8_t*)rec.data(),
              (const uint8_t*)rec.data() + rec.size()};
    uint32_t wt;
    while (uint32_t fnum = ex.tag(&wt)) {
      if (fnum == 1 && wt == 2) {
        // Example.features / SequenceExample.context (wire-identical).
        Cursor features = ex.bytes();
        while (uint32_t f2 = features.tag(&wt)) {
          if (f2 != 1 || wt != 2) {
            features.skip(wt);
            continue;
          }
          Cursor value{nullptr, nullptr};
          int fi = match_entry(features.bytes(), /*sequence=*/false, dsi,
                               &value);
          if (fi < 0) continue;
          (*found)[fi] = true;
          std::string err = extract_field(cfg.fields[fi], value, slot, row);
          if (!err.empty()) return err;
        }
      } else if (fnum == 2 && wt == 2 && cfg.any_seq) {
        // SequenceExample.feature_lists = {1: entry {1: key, 2: FeatureList}}.
        Cursor lists = ex.bytes();
        while (uint32_t f2 = lists.tag(&wt)) {
          if (f2 != 1 || wt != 2) {
            lists.skip(wt);
            continue;
          }
          Cursor value{nullptr, nullptr};
          int fi = match_entry(lists.bytes(), /*sequence=*/true, dsi,
                               &value);
          if (fi < 0) continue;
          (*found)[fi] = true;
          std::string err =
              extract_sequence_field(cfg.fields[fi], value, slot, row);
          if (!err.empty()) return err;
        }
      } else {
        ex.skip(wt);
      }
    }
    if (!ex.ok) return "malformed Example record";
    return "";
  }

  std::string parse_into(const std::vector<std::string>& recs, int slot_idx,
                         int row) {
    Slot& slot = slots[slot_idx];
    // Track which fields were found across all zipped records.
    std::vector<bool> found(cfg.fields.size(), false);
    for (size_t d = 0; d < recs.size(); d++) {
      std::string err = parse_record(recs[d], (int)d, slot, row, &found);
      if (!err.empty()) return err;
    }
    for (size_t i = 0; i < cfg.fields.size(); i++) {
      const FieldSpec& f = cfg.fields[i];
      if (found[i]) {
        if (f.buf_p >= 0) slot.buffers[f.buf_p][row] = 1;
        continue;
      }
      if (!f.optional_field)
        return "feature '" + f.name + "' missing from record";
      if (f.buf_p >= 0) slot.buffers[f.buf_p][row] = 0;
      zero_field_row(f, slot, row);
    }
    return "";
  }

  std::string extract_field(const FieldSpec& f, Cursor value, Slot& slot,
                            int row) {
    // value is a Feature message: 1=BytesList, 2=FloatList, 3=Int64List.
    uint32_t wt;
    while (uint32_t fnum = value.tag(&wt)) {
      if (wt != 2) {
        value.skip(wt);
        continue;
      }
      Cursor list = value.bytes();
      switch (fnum) {
        case 1: {  // BytesList
          if (f.kind != kImageFull && !is_coef(f.kind))
            return "feature '" + f.name + "' is bytes but spec is numeric";
          if (is_coef(f.kind)) {
            // The first element is the frame (as for a rank-3 pixel spec).
            uint32_t wt2;
            while (uint32_t f2 = list.tag(&wt2)) {
              if (f2 == 1 && wt2 == 2) {
                Cursor payload = list.bytes();
                return extract_coef(f, payload.p, payload.size(), slot, row);
              }
              list.skip(wt2);
            }
            return "empty bytes list for '" + f.name + "'";
          }
          bool frame_list = f.kind == kImageFull && f.count > 0;
          bool strict_list = frame_list && !f.varlen;
          long long frames = f.items();
          long long frame_bytes = (long long)f.h * f.w * f.c;
          // Frames [lo, hi) are decoded; the others only counted.
          uint8_t* base = slot.buffers[f.buf0] +
                          (size_t)row * f.kept() * frame_bytes;
          long long got = 0;
          uint32_t wt2;
          while (uint32_t f2 = list.tag(&wt2)) {
            if (f2 == 1 && wt2 == 2) {
              Cursor payload = list.bytes();
              if (got >= frames) {
                if (!strict_list) continue;  // rank-3 spec: first element
                                             // wins; varlen list: clip —
                                             // extras ignored either way
                                             // (Python parser parity)
                char buf[128];
                snprintf(buf, sizeof buf, "feature '%s': more than %lld "
                         "encoded frames", f.name.c_str(), frames);
                return buf;
              }
              if (got >= f.lo && got < f.hi) {
                std::string err = decode_jpeg_full(
                    payload.p, payload.size(), f,
                    base + (got - f.lo) * frame_bytes);
                if (!err.empty()) return err;
              }
              got++;
              continue;
            }
            list.skip(wt2);
          }
          if (strict_list && got != frames) {
            char buf[128];
            snprintf(buf, sizeof buf, "feature '%s': got %lld encoded "
                     "frames, want %lld", f.name.c_str(), got, frames);
            return buf;
          }
          if (f.varlen && frame_list && got < frames) {
            // parser.py varlen-image parity: an EMPTY list decodes one
            // all-zeros frame first, then pad_or_clip fills the rest
            // with the varlen default value (a varlen field keeps every
            // frame: lo is 0 and hi is frames).
            if (got == 0) {
              memset(base, 0, (size_t)frame_bytes);
              got = 1;
            }
            memset(base + got * frame_bytes,
                   (uint8_t)(long long)f.pad_value,
                   (size_t)((frames - got) * frame_bytes));
            return "";
          }
          if (got == 0) return "empty bytes list for '" + f.name + "'";
          return "";
        }
        case 2: {  // FloatList
          if (f.kind != kFloat)
            return "feature '" + f.name + "' is float but spec is not";
          return parse_float_list(
              f, list,
              (float*)slot.buffers[f.buf0] + (long long)row * f.kept());
        }
        case 3: {  // Int64List
          if (f.kind != kInt)
            return "feature '" + f.name + "' is int64 but spec is not";
          return parse_int_list(
              f, list,
              slot.buffers[f.buf0] + (long long)row * f.kept() * f.dtype_size);
        }
        default:
          value.skip(wt);
      }
    }
    return "feature '" + f.name + "' has no value list";
  }

  // One coefficient frame into row ``row`` of its field's buffers.
  std::string extract_coef(const FieldSpec& f, const uint8_t* data, size_t n,
                           Slot& slot, int row) {
    uint16_t* qt = (uint16_t*)slot.buffers[f.buf_qt] + (long long)row * 3 * 64;
    if (f.kind == kImageCoefSparse)
      return decode_jpeg_coef_sparse(
          data, n, f, slot.buffers[f.buf0] + (long long)row * f.count,
          (int8_t*)slot.buffers[f.buf_cb] + (long long)row * f.count, qt,
          (int32_t*)slot.buffers[f.buf_n] + row);
    if (f.kind == kImageCoefPacked)
      return decode_jpeg_coef_packed(
          data, n, f, slot.buffers[f.buf0] + (long long)row * f.count,
          (int16_t*)slot.buffers[f.buf_cb] + (long long)row *
              f.packed_escape_cap(),
          slot.buffers[f.buf_cr] + (long long)row * (f.packed_dc_count() / 2),
          qt, (int32_t*)slot.buffers[f.buf_n] + row,
          (int32_t*)slot.buffers[f.buf_n2] + row);
    long long yn = (long long)(f.h / 8) * (f.w / 8) * 64;
    long long cn = (long long)(f.h / 16) * (f.w / 16) * 64;
    return decode_jpeg_coef(
        data, n, f, (int16_t*)slot.buffers[f.buf0] + (long long)row * yn,
        (int16_t*)slot.buffers[f.buf_cb] + (long long)row * cn,
        (int16_t*)slot.buffers[f.buf_cr] + (long long)row * cn, qt);
  }

  // FloatList message -> exactly f.count floats, of which elements
  // [f.lo, f.hi) land at ``out``. Varlen fields (which keep all) instead
  // CLIP extras and PAD a short list with f.pad_value (parser.py
  // pad_or_clip_tensor_to_spec_shape parity).
  std::string parse_float_list(const FieldSpec& f, Cursor list, float* out) {
    long long got = 0;
    uint32_t wt2;
    // Copies the kept elements of ``n`` floats that are elements got.. of
    // the list.
    auto keep = [&](const uint8_t* p, long long n) {
      long long a = std::max(got, f.lo), b = std::min(got + n, f.hi);
      if (a < b) memcpy(out + (a - f.lo), p + (a - got) * 4, (b - a) * 4);
    };
    // Packed encoding: field 1 wiretype 2 (bulk) or repeated wiretype 5.
    while (uint32_t f2 = list.tag(&wt2)) {
      if (f2 == 1 && wt2 == 2) {
        Cursor packed = list.bytes();
        long long n = packed.size() / 4;
        if (got + n > f.count) {
          if (!f.varlen)
            return "too many floats for '" + f.name + "'";
          n = f.count - got;  // clip
        }
        keep(packed.p, n);
        got += n;
        if (f.varlen && got >= f.count) break;
      } else if (f2 == 1 && wt2 == 5) {
        if (got >= f.count) {
          if (!f.varlen)
            return "too many floats for '" + f.name + "'";
          list.p += 4;  // clip
          if (list.p > list.end) list.p = list.end;
          continue;
        }
        if (list.end - list.p < 4)
          return "truncated float in '" + f.name + "'";
        keep(list.p, 1);
        list.p += 4;
        got++;
      } else {
        list.skip(wt2);
      }
    }
    if (f.varlen) {
      for (long long i = got; i < f.count; i++)
        out[i - f.lo] = (float)f.pad_value;
      return "";
    }
    if (got != f.count) {
      char buf[128];
      snprintf(buf, sizeof buf, "feature '%s': got %lld floats, want %lld",
               f.name.c_str(), got, f.count);
      return buf;
    }
    return "";
  }

  // Int64List message -> exactly f.count ints, of which elements
  // [f.lo, f.hi) land at ``base``; varlen fields clip/pad like
  // parse_float_list.
  std::string parse_int_list(const FieldSpec& f, Cursor list, uint8_t* base) {
    long long got = 0;
    uint32_t wt2;
    auto store = [&](uint64_t v) {
      if (got >= f.lo && got < f.hi) {
        long long i = got - f.lo;
        switch (f.dtype_size) {
          case 1: base[i] = (uint8_t)v; break;
          case 4: ((int32_t*)base)[i] = (int32_t)v; break;
          default: ((int64_t*)base)[i] = (int64_t)v; break;
        }
      }
      got++;
    };
    while (uint32_t f2 = list.tag(&wt2)) {
      if (f2 == 1 && wt2 == 2) {
        Cursor packed = list.bytes();
        while (packed.p < packed.end && got < f.count)
          store(packed.varint());
        if (packed.p < packed.end) {
          if (!f.varlen)
            return "too many ints for '" + f.name + "'";
          while (packed.p < packed.end) packed.varint();  // clip
        }
      } else if (f2 == 1 && wt2 == 0) {
        if (got >= f.count) {
          if (!f.varlen)
            return "too many ints for '" + f.name + "'";
          list.varint();  // clip
          continue;
        }
        store(list.varint());
      } else {
        list.skip(wt2);
      }
    }
    if (f.varlen) {
      // np.full-style C cast of the (float) default into the int dtype.
      while (got < f.count) store((uint64_t)(int64_t)f.pad_value);
      return "";
    }
    if (got != f.count) {
      char buf[128];
      snprintf(buf, sizeof buf, "feature '%s': got %lld ints, want %lld",
               f.name.c_str(), got, f.count);
      return buf;
    }
    return "";
  }

  // One step Feature inside a FeatureList -> f.count elements at ``out``.
  std::string extract_step(const FieldSpec& f, Cursor feature, uint8_t* out) {
    uint32_t wt;
    while (uint32_t fnum = feature.tag(&wt)) {
      if (wt != 2) {
        feature.skip(wt);
        continue;
      }
      Cursor list = feature.bytes();
      if (fnum == 2 && f.kind == kFloat)
        return parse_float_list(f, list, (float*)out);
      if (fnum == 3 && f.kind == kInt)
        return parse_int_list(f, list, out);
      if (fnum == 1)
        return "sequence feature '" + f.name + "' has bytes steps (not "
               "supported natively)";
      return "sequence feature '" + f.name + "' step kind mismatch";
    }
    return "sequence feature '" + f.name + "' has an empty step";
  }

  // FeatureList message ({1: repeated Feature}) -> [seq_cap, count] row
  // with zero padding past the record's step count (the Python parser's
  // batch-pad semantics; pad value 0 — varlen defaults fall back).
  std::string extract_sequence_field(const FieldSpec& f, Cursor fl,
                                     Slot& slot, int row) {
    int width = f.kind == kFloat ? 4 : f.dtype_size;
    long long step_bytes = f.count * width;
    uint8_t* base = slot.buffers[f.buf0] +
                    (long long)row * f.seq_cap * step_bytes;
    long long step = 0;
    uint32_t wt;
    while (uint32_t fnum = fl.tag(&wt)) {
      if (fnum == 1 && wt == 2) {
        if (step >= f.seq_cap) {
          char buf[160];
          snprintf(buf, sizeof buf, "sequence feature '%s': more than %lld "
                   "steps (raise sequence_max_len)", f.name.c_str(),
                   f.seq_cap);
          return buf;
        }
        std::string err = extract_step(f, fl.bytes(),
                                       base + step * step_bytes);
        if (!err.empty()) return err;
        step++;
      } else {
        fl.skip(wt);
      }
    }
    ((int32_t*)slot.buffers[f.buf_n])[row] = (int32_t)step;
    if (step < f.seq_cap)
      memset(base + step * step_bytes, 0, (f.seq_cap - step) * step_bytes);
    return "";
  }

  void worker_main(int worker_index) {
    // Only a plan that decodes pixels binds a decode device: the split
    // decode's entropy stage runs on the host and touches no card.
    if (cfg.any_full_image) {
      std::string bind_error;
      long long bound = bind_decode_device(cfg.device, &bind_error);
      if (!bind_error.empty()) {
        fail(bind_error);
        return;
      }
      st_decode_device.store(bound, std::memory_order_relaxed);
    }
    for (;;) {
      WorkItem item;
      {
        long long t_idle = now_us();
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop.load() || !work.empty(); });
        st_worker_idle_us.fetch_add(now_us() - t_idle,
                                    std::memory_order_relaxed);
        if (stop.load()) return;
        if (work.empty()) continue;
        item = std::move(work.front());
        work.pop_front();
      }
      cv_space.notify_one();
      long long t_busy = now_us();
      std::string err = parse_into(item.records, item.slot, item.row);
      long long busy = now_us() - t_busy;
      st_worker_busy_us.fetch_add(busy, std::memory_order_relaxed);
      st_per_worker_busy_us[worker_index].fetch_add(
          busy, std::memory_order_relaxed);
      st_rows_parsed.fetch_add(1, std::memory_order_relaxed);
      long long record_bytes = 0;
      for (const auto& rec : item.records)
        record_bytes += (long long)rec.size();
      st_parse_bytes.fetch_add(record_bytes, std::memory_order_relaxed);
      Slot& slot = slots[item.slot];
      if (!err.empty()) {
        // Record the error but DEFER the fail/swallow decision to batch
        // completion: whether this batch is the EOF-discarded partial
        // batch (drop_remainder semantics — error irrelevant) is only
        // known for sure once all its rows are in, making the swallow
        // deterministic rather than a race against the reader reaching
        // EOF and marking seq = -2.
        std::lock_guard<std::mutex> lk(mu);
        if (slot.row_error.empty()) slot.row_error = err;
      }
      if (slot.remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(mu);
        if (slot.seq == -2) {  // discarded partial batch at EOF
          slot.state = kFree;
          cv_free.notify_one();
          cv_ready.notify_all();  // consumer may be waiting on the EOF check
        } else if (!slot.row_error.empty()) {
          // fail() under mu would deadlock; set the error state inline.
          if (error.empty()) error = slot.row_error;
          stop = true;
          cv_ready.notify_all();
          cv_work.notify_all();
          cv_free.notify_all();
          cv_space.notify_all();
          return;
        } else {
          slot.state = kReady;
          // Insert in seq order so batches come out deterministically.
          auto it = ready.begin();
          while (it != ready.end() && slots[*it].seq < slot.seq) ++it;
          ready.insert(it, item.slot);
          completed_batches++;
          cv_ready.notify_all();
        }
      }
    }
  }

  // ---- consumer API ------------------------------------------------------

  void ensure_launched() {
    // Thread launch deferred from create to the first next_slot() call:
    // all data/parse/decode errors then have ONE surfacing point
    // (iteration), deterministically — see the launch_once field note.
    std::call_once(launch_once, [this] {
      if (stop.load()) return;  // config already failed at create
      reader = std::thread([this] { reader_main(); });
      for (int i = 0; i < cfg.threads; i++)
        threads.emplace_back([this, i] { worker_main(i); });
    });
  }

  int next_slot() {
    ensure_launched();
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] {
      if (!error.empty()) return true;
      // Deliver strictly in dispatch order: batch assembly is deterministic
      // (single reader assigns rows in stream order), so ordered delivery
      // makes the whole pipeline reproducible under a fixed seed even
      // though decode is parallel.
      if (!ready.empty() && slots[ready.front()].seq == next_seq_out)
        return true;
      if (eof && next_seq_out >= dispatched_batches) return true;
      return false;
    });
    if (!error.empty()) return -2;
    if (ready.empty() || slots[ready.front()].seq != next_seq_out)
      return -1;  // end of data
    int slot = ready.front();
    ready.pop_front();
    slots[slot].state = kInUse;
    next_seq_out++;
    return slot;
  }

  void release(int slot) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (slot < 0 || slot >= (int)slots.size()) return;
      slots[slot].state = kFree;
    }
    cv_free.notify_one();
  }

  bool start(std::string* err) {
    // Buffers only — threads launch on the first next_slot() call
    // (ensure_launched), so create-time errors are config errors ONLY.
    st_per_worker_busy_us.reset(
        new std::atomic<long long>[cfg.threads > 0 ? cfg.threads : 1]);
    for (int i = 0; i < cfg.threads; i++) st_per_worker_busy_us[i] = 0;
    slots.resize(cfg.ring);
    for (auto& s : slots) {
      for (long long sz : cfg.buffer_sizes) {
        void* p = nullptr;
        if (posix_memalign(&p, 64, (size_t)sz) != 0) {
          *err = "allocation failed";
          return false;
        }
        s.buffers.push_back((uint8_t*)p);
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* t2r_loader_create(const char* config, int config_len) {
  auto* loader = new Loader();
  std::string err;
  if (!parse_config(std::string(config, config_len), &loader->cfg, &err) ||
      !loader->start(&err)) {
    loader->error = err.empty() ? "config error" : err;
    loader->stop = true;
    return loader;  // caller must check last_error
  }
  return loader;
}

const char* t2r_loader_last_error(void* h) {
  auto* loader = (Loader*)h;
  std::lock_guard<std::mutex> lk(loader->mu);
  return loader->error.c_str();
}

int t2r_loader_num_buffers(void* h) {
  return (int)((Loader*)h)->cfg.buffer_sizes.size();
}

long long t2r_loader_buffer_size(void* h, int buf) {
  auto* loader = (Loader*)h;
  if (buf < 0 || buf >= (int)loader->cfg.buffer_sizes.size()) return -1;
  return loader->cfg.buffer_sizes[buf];
}

void* t2r_loader_buffer_ptr(void* h, int slot, int buf) {
  auto* loader = (Loader*)h;
  if (slot < 0 || slot >= (int)loader->slots.size()) return nullptr;
  if (buf < 0 || buf >= (int)loader->slots[slot].buffers.size())
    return nullptr;
  return loader->slots[slot].buffers[buf];
}

int t2r_loader_ring_size(void* h) { return (int)((Loader*)h)->slots.size(); }

int t2r_loader_next(void* h) { return ((Loader*)h)->next_slot(); }

// Loader stats: fills up to n slots of `out` with the cumulative
// counters [records_read, bytes_read, reader_busy_us, reader_wait_us,
// rows_parsed, parse_bytes, worker_busy_us, worker_idle_us, n_workers,
// completed_batches, min_worker_busy_us, max_worker_busy_us] and the
// decode device the workers bound (-1: none); returns the count written.
// Never launches the worker threads (lazy-launch boundary
// preserved): before the first next() every count is 0, the device -1.
long long t2r_loader_stats(void* h, long long* out, int n) {
  return ((Loader*)h)->stats_snapshot(out, n);
}

void t2r_loader_release(void* h, int slot) { ((Loader*)h)->release(slot); }

void t2r_loader_destroy(void* h) { delete (Loader*)h; }

// The JPEG decoder this library was built with: "libjpeg" or "nvjpeg".
const char* t2r_loader_decoder() { return kDecoder; }

// Decodes one JPEG of h x w x c through the planes path (decode_jpeg_planes)
// into ``out``, on CUDA ``device`` in the nvJPEG build (the calling
// thread's current device is put back after); returns "" or the error,
// valid until the thread's next call.
const char* t2r_decode_jpeg_planes(const uint8_t* data, long long n, int h,
                                   int w, int c, int device, uint8_t* out) {
  static thread_local std::string error;
  error.clear();
  CallerDevice caller;
  (void)caller;
  bind_decode_device(device, &error);
  if (!error.empty()) return error.c_str();
  FieldSpec f;
  f.name = "image";
  f.h = h;
  f.w = w;
  f.c = c;
  error = decode_jpeg_planes(data, (size_t)n, f, out);
  return error.c_str();
}

}  // extern "C"
