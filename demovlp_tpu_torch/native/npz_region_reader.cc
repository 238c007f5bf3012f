// Native region-feature decoder of demovlp_tpu_torch (the port's own copy of
// the JAX package's native/npz_region_reader.cc, with the same C API:
// demovlp_read_frame, demovlp_read_frames, demovlp_region_dim).
//
// One C call decodes a batch of per-frame npz files (ZIP -> NPY arrays + a
// pickled info dict), runs the confidence-sort / top-K / geometry / edge-pad
// pipeline of demovlp_tpu_torch/data/regions.py, and writes straight into
// the caller's numpy buffers, fanned out over a thread pool.
//
// Scope matches what np.savez / np.savez_compressed produce:
//   * ZIP: stored (method 0) and deflate (method 8, via zlib)
//   * NPY: v1.0/v2.0 headers, little-endian f4/f8/i4/i8/u4/u8 arrays
//   * pickle: the protocol 2-5 opcode subset numpy uses for object arrays
//     (ndarray _reconstruct / dtype REDUCE+BUILD, dict/int/float/str/bytes)
// Anything outside this scope returns a nonzero status for that file; the
// Python caller redoes that sample on the per-sample path.
//
// Ties: regions of equal confidence keep their file order (a stable sort);
// numpy's argsort orders ties as its sort implementation does, so the two
// readers agree on frames whose confidences are distinct.
//
// Build (data/native.py does it at first use, into build/native/):
//   g++ -O3 -shared -fPIC -std=c++17 npz_region_reader.cc -o <lib> -lz -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ------------------------------------------------------------------ errors
enum Err {
  OK = 0,
  E_IO = 1,
  E_ZIP = 2,
  E_NPY = 3,
  E_PICKLE = 4,
  E_SCHEMA = 5,
  E_ARG = 6,
};

// ------------------------------------------------------------------- bytes
struct Bytes {
  std::vector<uint8_t> data;
  const uint8_t* p() const { return data.data(); }
  size_t n() const { return data.size(); }
};

static bool read_file(const char* path, Bytes* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return false; }
  out->data.resize((size_t)n);
  size_t got = fread(out->data.data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

static uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
static uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }

// --------------------------------------------------------------------- zip
struct ZipEntry {
  std::string name;
  uint16_t method;
  uint32_t crc32, comp_size, uncomp_size, local_off;
};

static int zip_entries(const Bytes& b, std::vector<ZipEntry>* out) {
  if (b.n() < 22) return E_ZIP;
  // find EOCD
  size_t i = b.n() - 22;
  while (true) {
    if (rd32(b.p() + i) == 0x06054b50) break;
    if (i == 0 || b.n() - i > 22 + 65535) return E_ZIP;
    --i;
  }
  uint16_t n_entries = rd16(b.p() + i + 10);
  uint32_t cd_off = rd32(b.p() + i + 16);
  size_t p = cd_off;
  for (uint16_t k = 0; k < n_entries; ++k) {
    if (p + 46 > b.n() || rd32(b.p() + p) != 0x02014b50) return E_ZIP;
    ZipEntry e;
    e.method = rd16(b.p() + p + 10);
    e.crc32 = rd32(b.p() + p + 16);
    e.comp_size = rd32(b.p() + p + 20);
    e.uncomp_size = rd32(b.p() + p + 24);
    uint16_t name_len = rd16(b.p() + p + 28);
    uint16_t extra_len = rd16(b.p() + p + 30);
    uint16_t comment_len = rd16(b.p() + p + 32);
    e.local_off = rd32(b.p() + p + 42);
    // the variable-length fields must fit in the buffer BEFORE the name is
    // copied — a corrupt name_len would otherwise read past the allocation
    if (p + 46 + (size_t)name_len + extra_len + comment_len > b.n())
      return E_ZIP;
    e.name.assign((const char*)b.p() + p + 46, name_len);
    out->push_back(e);
    p += 46 + (size_t)name_len + extra_len + comment_len;
  }
  return OK;
}

static int zip_extract(const Bytes& b, const ZipEntry& e, Bytes* out) {
  size_t p = e.local_off;
  if (p + 30 > b.n() || rd32(b.p() + p) != 0x04034b50) return E_ZIP;
  uint16_t name_len = rd16(b.p() + p + 26);
  uint16_t extra_len = rd16(b.p() + p + 28);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + e.comp_size > b.n()) return E_ZIP;
  if (e.method == 0) {
    out->data.assign(b.p() + data_off, b.p() + data_off + e.comp_size);
    // integrity parity with the np.load fallback: python's zipfile
    // validates member CRCs, so silent bit-rot must fail here too
    if (::crc32(0, out->p(), (uInt)out->n()) != e.crc32) return E_ZIP;
    return OK;
  }
  if (e.method == 8) {
    // uncomp_size is attacker-controlled; real frame npz members are a few
    // MB, so a multi-GiB claim is corruption, not data — reject instead of
    // attempting the allocation (bad_alloc in a worker thread would
    // std::terminate the process)
    if (e.uncomp_size > (256u << 20)) return E_ZIP;
    out->data.resize(e.uncomp_size);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return E_ZIP;
    zs.next_in = const_cast<uint8_t*>(b.p() + data_off);
    zs.avail_in = e.comp_size;
    zs.next_out = out->data.data();
    zs.avail_out = e.uncomp_size;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) return E_ZIP;
    if (::crc32(0, out->p(), (uInt)out->n()) != e.crc32) return E_ZIP;
    return OK;
  }
  return E_ZIP;
}

// --------------------------------------------------------------------- npy
struct NpyArray {
  std::string descr;          // e.g. "<f4"
  std::vector<int64_t> shape;
  const uint8_t* data = nullptr;  // borrowed from the Bytes buffer
  size_t nbytes = 0;

  int64_t numel() const {
    int64_t n = 1;
    for (auto s : shape) n *= s;
    return n;
  }
};

static int npy_parse(const Bytes& b, NpyArray* out) {
  if (b.n() < 10 || memcmp(b.p(), "\x93NUMPY", 6) != 0) return E_NPY;
  uint8_t major = b.p()[6];
  if (major < 1 || major > 3) return E_NPY;
  size_t hlen, hoff;
  if (major == 1) { hlen = rd16(b.p() + 8); hoff = 10; }
  else {
    // v2/v3 headers carry a 4-byte length at offset 8: need 12 bytes
    if (b.n() < 12) return E_NPY;
    hlen = rd32(b.p() + 8); hoff = 12;
  }
  if (hoff + hlen > b.n()) return E_NPY;
  std::string h((const char*)b.p() + hoff, hlen);
  // descr: the quoted value after 'descr':
  size_t dp = h.find("'descr'");
  if (dp == std::string::npos) return E_NPY;
  size_t colon = h.find(':', dp);
  if (colon == std::string::npos) return E_NPY;
  size_t v1 = h.find('\'', colon);
  if (v1 == std::string::npos) return E_NPY;
  size_t v2 = h.find('\'', v1 + 1);
  if (v2 == std::string::npos) return E_NPY;
  out->descr = h.substr(v1 + 1, v2 - v1 - 1);
  if (h.find("'fortran_order': True") != std::string::npos) return E_NPY;
  // shape
  size_t sp = h.find("'shape':");
  if (sp == std::string::npos) return E_NPY;
  size_t o = h.find('(', sp), c = h.find(')', sp);
  if (o == std::string::npos || c == std::string::npos) return E_NPY;
  std::string tup = h.substr(o + 1, c - o - 1);
  out->shape.clear();
  const char* s = tup.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    int64_t dim = strtoll(s, (char**)&s, 10);
    // corrupt headers can claim negative or absurd dims; the element count
    // can never exceed the payload byte count (>=1 byte/elem), so bound
    // each dim by the buffer size before any product/alloc sees it
    if (dim < 0 || (uint64_t)dim > b.n()) return E_NPY;
    out->shape.push_back(dim);
  }
  out->data = b.p() + hoff + hlen;
  out->nbytes = b.n() - hoff - hlen;
  // reject overflowing / over-claiming element counts here so every
  // downstream numel()-sized allocation is bounded by the actual payload
  int64_t numel = 1;
  for (auto d : out->shape) {
    if (d != 0 && numel > (int64_t)(b.n() / (size_t)d) + 1) return E_NPY;
    numel *= d;
  }
  // object arrays ('|O') carry a pickle stream, not numel*itemsize bytes
  if (numel < 0 || (out->descr.find('O') == std::string::npos &&
                    (uint64_t)numel > out->nbytes))
    return E_NPY;
  return OK;
}

static bool npy_to_f32(const NpyArray& a, std::vector<float>* out) {
  int64_t n = a.numel();
  out->resize((size_t)n);
  if (a.descr == "<f4") {
    if (a.nbytes < (size_t)n * 4) return false;
    memcpy(out->data(), a.data, (size_t)n * 4);
    return true;
  }
  if (a.descr == "<f8") {
    if (a.nbytes < (size_t)n * 8) return false;
    const double* src = (const double*)a.data;
    for (int64_t i = 0; i < n; ++i) (*out)[(size_t)i] = (float)src[i];
    return true;
  }
  if (a.descr == "<i8" || a.descr == "<u8") {
    if (a.nbytes < (size_t)n * 8) return false;
    const int64_t* src = (const int64_t*)a.data;
    for (int64_t i = 0; i < n; ++i) (*out)[(size_t)i] = (float)src[i];
    return true;
  }
  if (a.descr == "<i4" || a.descr == "<u4") {
    if (a.nbytes < (size_t)n * 4) return false;
    const int32_t* src = (const int32_t*)a.data;
    for (int64_t i = 0; i < n; ++i) (*out)[(size_t)i] = (float)src[i];
    return true;
  }
  return false;
}

// ------------------------------------------------------------ mini pickler
// Just enough of the pickle VM to decode numpy's object-array payloads:
// values are dict / list / tuple / str / bytes / int / float / ndarray /
// dtype-token / global-token / None / bool.
struct PValue;
using PPtr = std::shared_ptr<PValue>;

struct PValue {
  enum Kind { NONE, BOOL, INT, FLOAT, STR, BYTES, TUPLE, LIST, DICT,
              GLOBAL, DTYPE, NDARRAY, MARKER } kind = NONE;
  bool b = false;
  int64_t i = 0;
  double f = 0;
  std::string s;                       // STR / GLOBAL("mod name") / DTYPE descr
  std::vector<uint8_t> bytes;
  std::vector<PPtr> items;             // TUPLE / LIST
  std::map<std::string, PPtr> dict;
  // NDARRAY payload
  std::vector<int64_t> shape;
  std::string descr;
};

static PPtr mk(PValue::Kind k) { auto v = std::make_shared<PValue>(); v->kind = k; return v; }

struct Unpickler {
  const uint8_t* p;
  size_t n, pos = 0;
  std::vector<PPtr> stack;
  std::vector<size_t> marks;
  std::vector<PPtr> memo;
  // set by pop()/top() on stack underflow (adversarial streams pop more
  // than they pushed); run() checks it after every opcode
  bool bad = false;

  bool have(size_t k) const { return pos + k <= n; }
  uint8_t u8() { return p[pos++]; }
  uint16_t u16() { uint16_t v; memcpy(&v, p + pos, 2); pos += 2; return v; }
  uint32_t u32() { uint32_t v; memcpy(&v, p + pos, 4); pos += 4; return v; }
  int32_t i32() { int32_t v; memcpy(&v, p + pos, 4); pos += 4; return v; }
  uint64_t u64() { uint64_t v; memcpy(&v, p + pos, 8); pos += 8; return v; }

  size_t memo_puts = 0;

  void memo_put(PPtr v, size_t idx) {
    // LONG_BINPUT indices are attacker-controlled u32s: a sparse 4-billion
    // slot would allocate GBs. A cap relative to the CURRENT table size is
    // not enough — a stream of puts each just under the cap ratchets the
    // table up by the slack amount per opcode (multi-GB from a 1 MB
    // member). CPython assigns memo indices densely, so bound idx by the
    // total number of puts so far, plus an absolute ceiling (a legitimate
    // npy-header pickle memoizes a handful of objects).
    if (idx > memo_puts + 64 || idx >= (1u << 20)) { bad = true; return; }
    if (memo.size() <= idx) memo.resize(idx + 1);
    memo[idx] = v;
    ++memo_puts;
  }

  PPtr pop() {
    if (stack.empty()) { bad = true; return mk(PValue::NONE); }
    PPtr v = stack.back(); stack.pop_back(); return v;
  }
  PPtr top() {
    if (stack.empty()) { bad = true; return mk(PValue::NONE); }
    return stack.back();
  }

  // REDUCE: callable(args) — we only model numpy's constructors
  PPtr reduce(PPtr callable, PPtr args) {
    if (callable->kind == PValue::GLOBAL) {
      const std::string& g = callable->s;
      if (g.find("_reconstruct") != std::string::npos) {
        return mk(PValue::NDARRAY);  // filled by BUILD
      }
      if (g.find("dtype") != std::string::npos) {
        auto d = mk(PValue::DTYPE);
        if (!args->items.empty() && args->items[0]->kind == PValue::STR)
          d->s = args->items[0]->s;
        return d;
      }
      if (g.find("scalar") != std::string::npos && args->items.size() == 2) {
        // numpy scalar: (dtype, bytes) -> float/int
        auto& dt = args->items[0];
        auto& by = args->items[1];
        auto out = mk(PValue::FLOAT);
        const std::string& ds = dt->s;
        if (by->bytes.size() == 8 && ds.find('f') != std::string::npos) {
          double d; memcpy(&d, by->bytes.data(), 8); out->f = d;
        } else if (by->bytes.size() == 4 && ds.find('f') != std::string::npos) {
          float d; memcpy(&d, by->bytes.data(), 4); out->f = d;
        } else if (by->bytes.size() == 8) {
          int64_t d; memcpy(&d, by->bytes.data(), 8);
          out->kind = PValue::INT; out->i = d;
        } else if (by->bytes.size() == 4) {
          int32_t d; memcpy(&d, by->bytes.data(), 4);
          out->kind = PValue::INT; out->i = d;
        }
        return out;
      }
    }
    return mk(PValue::NONE);
  }

  // BUILD: obj.__setstate__(state)
  void build() {
    PPtr state = pop();
    PPtr obj = top();
    if (bad) return;
    if (obj->kind == PValue::NDARRAY && state->kind == PValue::TUPLE &&
        state->items.size() >= 5) {
      // (version, shape, dtype, fortran, data)
      auto& shp = state->items[1];
      auto& dt = state->items[2];
      auto& data = state->items[4];
      for (auto& e : shp->items) if (e) obj->shape.push_back(e->i);
      if (dt->kind == PValue::DTYPE) obj->descr = dt->s;
      if (data->kind == PValue::BYTES) obj->bytes = data->bytes;
      else if (data->kind == PValue::LIST) {
        // object array: keep items (e.g. the [dict] payload)
        obj->items = data->items;
      }
    }
    // dtype BUILD: state carries byteorder etc. — descr already captured
  }

  int run(PPtr* result) {
    while (pos < n) {
      uint8_t op = u8();
      switch (op) {
        case 0x80: if (!have(1)) return E_PICKLE; u8(); break;       // PROTO
        case 0x95: if (!have(8)) return E_PICKLE; u64(); break;       // FRAME
        case '(': marks.push_back(stack.size()); break;               // MARK
        case ')': stack.push_back(mk(PValue::TUPLE)); break;          // EMPTY_TUPLE
        case ']': stack.push_back(mk(PValue::LIST)); break;           // EMPTY_LIST
        case '}': stack.push_back(mk(PValue::DICT)); break;           // EMPTY_DICT
        case 'N': stack.push_back(mk(PValue::NONE)); break;           // NONE
        case 0x88: { auto v = mk(PValue::BOOL); v->b = true; stack.push_back(v); break; }
        case 0x89: { auto v = mk(PValue::BOOL); v->b = false; stack.push_back(v); break; }
        case 'K': { if (!have(1)) return E_PICKLE; auto v = mk(PValue::INT); v->i = u8(); stack.push_back(v); break; }   // BININT1
        case 'M': { if (!have(2)) return E_PICKLE; auto v = mk(PValue::INT); v->i = u16(); stack.push_back(v); break; }  // BININT2
        case 'J': { if (!have(4)) return E_PICKLE; auto v = mk(PValue::INT); v->i = i32(); stack.push_back(v); break; }  // BININT
        case 0x8a: { // LONG1
          if (!have(1)) return E_PICKLE;
          uint8_t nb = u8();
          if (!have(nb) || nb > 8) return E_PICKLE;
          int64_t val = 0;
          for (int k = 0; k < nb; ++k) val |= ((int64_t)p[pos + k]) << (8 * k);
          if (nb && (p[pos + nb - 1] & 0x80)) val -= ((int64_t)1) << (8 * nb);
          pos += nb;
          auto v = mk(PValue::INT); v->i = val; stack.push_back(v); break;
        }
        case 'G': { // BINFLOAT (big endian)
          if (!have(8)) return E_PICKLE;
          uint8_t buf[8];
          for (int k = 0; k < 8; ++k) buf[k] = p[pos + 7 - k];
          pos += 8;
          double d; memcpy(&d, buf, 8);
          auto v = mk(PValue::FLOAT); v->f = d; stack.push_back(v); break;
        }
        case 0x8c: { // SHORT_BINUNICODE
          if (!have(1)) return E_PICKLE;
          uint8_t len = u8();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::STR);
          v->s.assign((const char*)p + pos, len); pos += len;
          stack.push_back(v); break;
        }
        case 'X': { // BINUNICODE
          if (!have(4)) return E_PICKLE;
          uint32_t len = u32();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::STR);
          v->s.assign((const char*)p + pos, len); pos += len;
          stack.push_back(v); break;
        }
        case 'U': { // SHORT_BINSTRING (protocol 2 str)
          if (!have(1)) return E_PICKLE;
          uint8_t len = u8();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::STR);
          v->s.assign((const char*)p + pos, len); pos += len;
          stack.push_back(v); break;
        }
        case 'C': { // SHORT_BINBYTES
          if (!have(1)) return E_PICKLE;
          uint8_t len = u8();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::BYTES);
          v->bytes.assign(p + pos, p + pos + len); pos += len;
          stack.push_back(v); break;
        }
        case 'B': { // BINBYTES
          if (!have(4)) return E_PICKLE;
          uint32_t len = u32();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::BYTES);
          v->bytes.assign(p + pos, p + pos + len); pos += len;
          stack.push_back(v); break;
        }
        case 0x8e: { // BINBYTES8
          if (!have(8)) return E_PICKLE;
          uint64_t len = u64();
          if (!have(len)) return E_PICKLE;
          auto v = mk(PValue::BYTES);
          v->bytes.assign(p + pos, p + pos + len); pos += (size_t)len;
          stack.push_back(v); break;
        }
        case 0x85: { auto t = mk(PValue::TUPLE); t->items.push_back(pop()); stack.push_back(t); break; }  // TUPLE1
        case 0x86: { auto t = mk(PValue::TUPLE); auto b2 = pop(), a = pop(); t->items = {a, b2}; stack.push_back(t); break; }
        case 0x87: { auto t = mk(PValue::TUPLE); auto c = pop(), b2 = pop(), a = pop(); t->items = {a, b2, c}; stack.push_back(t); break; }
        case 't': { // TUPLE (from MARK)
          if (marks.empty()) return E_PICKLE;
          size_t m = marks.back(); marks.pop_back();
          if (m > stack.size()) return E_PICKLE;
          auto t = mk(PValue::TUPLE);
          t->items.assign(stack.begin() + m, stack.end());
          stack.resize(m);
          stack.push_back(t); break;
        }
        case 'c': { // GLOBAL "module\nname\n"
          std::string mod, name;
          while (pos < n && p[pos] != '\n') mod.push_back((char)p[pos++]);
          ++pos;
          while (pos < n && p[pos] != '\n') name.push_back((char)p[pos++]);
          ++pos;
          auto v = mk(PValue::GLOBAL); v->s = mod + " " + name;
          stack.push_back(v); break;
        }
        case 0x93: { // STACK_GLOBAL
          auto name = pop(), mod = pop();
          auto v = mk(PValue::GLOBAL); v->s = mod->s + " " + name->s;
          stack.push_back(v); break;
        }
        case 0x94: memo_put(top(), memo.size()); break;               // MEMOIZE
        case 'q': { if (!have(1)) return E_PICKLE; memo_put(top(), u8()); break; }   // BINPUT
        case 'r': { if (!have(4)) return E_PICKLE; memo_put(top(), u32()); break; }  // LONG_BINPUT
        case 'h': { if (!have(1)) return E_PICKLE; uint8_t k = u8(); if (k >= memo.size() || !memo[k]) return E_PICKLE; stack.push_back(memo[k]); break; }  // BINGET
        case 'j': { if (!have(4)) return E_PICKLE; uint32_t k = u32(); if (k >= memo.size() || !memo[k]) return E_PICKLE; stack.push_back(memo[k]); break; } // LONG_BINGET
        case 'R': { auto args = pop(); auto fn = pop(); stack.push_back(reduce(fn, args)); break; }  // REDUCE
        case 'b': build(); break;                                     // BUILD
        case 'a': { auto v = pop(); auto lst = top(); if (lst->kind == PValue::LIST) lst->items.push_back(v); break; }  // APPEND
        case 'e': { // APPENDS
          if (marks.empty()) return E_PICKLE;
          size_t m = marks.back(); marks.pop_back();
          if (m < 1 || m > stack.size()) return E_PICKLE;
          auto& lst = stack[m - 1];
          for (size_t k = m; k < stack.size(); ++k) lst->items.push_back(stack[k]);
          stack.resize(m); break;
        }
        case 's': { // SETITEM
          auto v = pop(); auto key = pop(); auto d = top();
          if (d->kind == PValue::DICT && key->kind == PValue::STR)
            d->dict[key->s] = v;
          break;
        }
        case 'u': { // SETITEMS: pairwise (key, value) above the mark
          if (marks.empty() || marks.back() == 0) return E_PICKLE;
          size_t m = marks.back(); marks.pop_back();
          if (m > stack.size()) return E_PICKLE;
          auto& d = stack[m - 1];
          for (size_t k = m; k + 1 < stack.size(); k += 2) {
            auto key = stack[k];
            auto val = stack[k + 1];
            if (d->kind == PValue::DICT && key->kind == PValue::STR)
              d->dict[key->s] = val;
          }
          stack.resize(m); break;
        }
        case '.': {
          if (bad) return E_PICKLE;
          *result = stack.empty() ? mk(PValue::NONE) : stack.back();
          return OK;
        }  // STOP
        default:
          return E_PICKLE;
      }
      if (bad) return E_PICKLE;  // stack underflow inside the last opcode
    }
    return E_PICKLE;
  }
};

// ndarray PValue -> float vector
static bool pnd_to_f32(const PPtr& v, std::vector<float>* out, int64_t* len) {
  if (!v || v->kind != PValue::NDARRAY) return false;
  // shape dims come from the (untrusted) pickle stream: bound the element
  // count by the payload bytes BEFORE sizing any allocation off it
  int64_t numel = 1;
  for (auto s : v->shape) {
    if (s < 0 || (uint64_t)s > v->bytes.size()) return false;
    if (s != 0 && numel > (int64_t)(v->bytes.size() / (size_t)s) + 1)
      return false;
    numel *= s;
  }
  if (numel < 0 || (uint64_t)numel > v->bytes.size()) return false;
  *len = numel;
  out->resize((size_t)numel);
  const std::string& d = v->descr;
  const auto& raw = v->bytes;
  if (d == "f4" || d == "<f4") {
    if (raw.size() < (size_t)numel * 4) return false;
    memcpy(out->data(), raw.data(), (size_t)numel * 4);
  } else if (d == "f8" || d == "<f8") {
    if (raw.size() < (size_t)numel * 8) return false;
    const double* s = (const double*)raw.data();
    for (int64_t i = 0; i < numel; ++i) (*out)[(size_t)i] = (float)s[i];
  } else if (d == "i8" || d == "<i8" || d == "u8" || d == "<u8") {
    if (raw.size() < (size_t)numel * 8) return false;
    const int64_t* s = (const int64_t*)raw.data();
    for (int64_t i = 0; i < numel; ++i) (*out)[(size_t)i] = (float)s[i];
  } else if (d == "i4" || d == "<i4" || d == "u4" || d == "<u4") {
    if (raw.size() < (size_t)numel * 4) return false;
    const int32_t* s = (const int32_t*)raw.data();
    for (int64_t i = 0; i < numel; ++i) (*out)[(size_t)i] = (float)s[i];
  } else {
    return false;
  }
  return true;
}

static double pnum(const PPtr& v, bool* ok) {
  *ok = true;
  if (!v) { *ok = false; return 0; }
  if (v->kind == PValue::INT) return (double)v->i;
  if (v->kind == PValue::FLOAT) return v->f;
  *ok = false;
  return 0;
}

// ------------------------------------------------------------- frame logic
constexpr int kFeatDim = 2048;
constexpr int kGeomDim = 6;
constexpr int kRegionDim = kFeatDim + kGeomDim;

struct FrameDecoded {
  std::vector<float> feat;   // (N, 2048)
  std::vector<float> bbox;   // (N, 4)
  std::vector<float> conf;   // (N,)
  double image_w = 0, image_h = 0;
  int64_t n = 0;
};

static int decode_frame(const char* path, FrameDecoded* out) {
  Bytes file;
  if (!read_file(path, &file)) return E_IO;
  std::vector<ZipEntry> entries;
  int rc = zip_entries(file, &entries);
  if (rc != OK) return rc;

  Bytes xbuf, bbuf, ibuf;
  bool have_x = false, have_b = false, have_i = false;
  for (auto& e : entries) {
    if (e.name == "x.npy") { rc = zip_extract(file, e, &xbuf); have_x = rc == OK; }
    else if (e.name == "bbox.npy") { rc = zip_extract(file, e, &bbuf); have_b = rc == OK; }
    else if (e.name == "info.npy") { rc = zip_extract(file, e, &ibuf); have_i = rc == OK; }
    if (rc != OK) return rc;
  }
  if (!have_x || !have_b || !have_i) return E_SCHEMA;

  NpyArray xa, ba, ia;
  if (npy_parse(xbuf, &xa) != OK || xa.shape.size() != 2) return E_NPY;
  if (npy_parse(bbuf, &ba) != OK || ba.shape.size() != 2 || ba.shape[1] != 4) return E_NPY;
  if (npy_parse(ibuf, &ia) != OK) return E_NPY;
  if (xa.shape[1] != kFeatDim) return E_SCHEMA;
  if (!npy_to_f32(xa, &out->feat)) return E_NPY;
  if (!npy_to_f32(ba, &out->bbox)) return E_NPY;
  out->n = xa.shape[0];
  if (ba.shape[0] != out->n) return E_SCHEMA;

  // info: object npy -> pickle payload
  if (ia.descr.find('O') == std::string::npos) return E_SCHEMA;
  Unpickler u;
  u.p = ia.data;
  u.n = ia.nbytes;
  PPtr root;
  int prc = u.run(&root);
  if (prc != OK) return prc;
  // the payload is a 0-d object ndarray whose BUILD state list holds the dict
  PPtr dict;
  if (root->kind == PValue::NDARRAY && !root->items.empty() &&
      root->items[0]->kind == PValue::DICT) {
    dict = root->items[0];
  } else if (root->kind == PValue::DICT) {
    dict = root;
  } else {
    return E_SCHEMA;
  }
  auto it = dict->dict.find("objects_conf");
  if (it == dict->dict.end()) return E_SCHEMA;
  int64_t clen = 0;
  if (!pnd_to_f32(it->second, &out->conf, &clen) || clen != out->n) return E_SCHEMA;
  bool ok1 = false, ok2 = false;
  auto wi = dict->dict.find("image_w");
  auto hi = dict->dict.find("image_h");
  if (wi == dict->dict.end() || hi == dict->dict.end()) return E_SCHEMA;
  out->image_w = pnum(wi->second, &ok1);
  out->image_h = pnum(hi->second, &ok2);
  if (!ok1 || !ok2 || out->image_w <= 0 || out->image_h <= 0) return E_SCHEMA;
  return OK;
}

// conf-sort (desc) + top-K + geometry + edge-pad into caller buffers
static int select_frame(const FrameDecoded& fr, int object_num,
                        float* out_feat, float* out_mask, int32_t* out_len) {
  int64_t n = fr.n;
  if (n <= 0) return E_SCHEMA;
  std::vector<int32_t> order((size_t)n);
  for (int64_t i = 0; i < n; ++i) order[(size_t)i] = (int32_t)i;
  // descending by confidence; stable so equal confidences keep file order
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return fr.conf[(size_t)a] > fr.conf[(size_t)b];
  });
  int keep = (int)std::min<int64_t>(n, object_num);
  for (int k = 0; k < object_num; ++k) {
    int src = order[(size_t)std::min(k, keep - 1)];
    float* dst = out_feat + (size_t)k * kRegionDim;
    memcpy(dst, fr.feat.data() + (size_t)src * kFeatDim, kFeatDim * sizeof(float));
    const float* bb = fr.bbox.data() + (size_t)src * 4;
    float sw = (float)((bb[2] - bb[0]) / fr.image_w);
    float sh = (float)((bb[3] - bb[1]) / fr.image_h);
    float sx = (float)(bb[0] / fr.image_w);
    float sy = (float)(bb[1] / fr.image_h);
    dst[kFeatDim + 0] = sx;
    dst[kFeatDim + 1] = sy;
    dst[kFeatDim + 2] = sx + sw;
    dst[kFeatDim + 3] = sy + sh;
    dst[kFeatDim + 4] = sw;
    dst[kFeatDim + 5] = sh;
    out_mask[k] = (k < keep) ? 1.0f : 0.0f;
  }
  *out_len = keep;
  return OK;
}

}  // namespace

extern "C" {

// Decode one frame npz into out_feat[object_num*2054], out_mask[object_num].
int demovlp_read_frame(const char* path, int object_num,
                       float* out_feat, float* out_mask, int32_t* out_len) {
  if (!path || object_num <= 0 || !out_feat || !out_mask || !out_len)
    return E_ARG;
  // catch-all: untrusted bytes must never take down the process — an
  // uncaught exception (e.g. bad_alloc on a corrupt size field) escaping
  // into the caller's worker thread would std::terminate
  try {
    FrameDecoded fr;
    int rc = decode_frame(path, &fr);
    if (rc != OK) return rc;
    return select_frame(fr, object_num, out_feat, out_mask, out_len);
  } catch (...) {
    return E_IO;
  }
}

// Batched, threaded variant. paths: n_frames C strings. Outputs are
// contiguous [n_frames, object_num, 2054] / [n_frames, object_num] /
// [n_frames]. Per-frame status codes land in out_status[n_frames].
int demovlp_read_frames(const char** paths, int n_frames, int object_num,
                        int n_threads, float* out_feat, float* out_mask,
                        int32_t* out_lens, int32_t* out_status) {
  if (!paths || n_frames <= 0 || object_num <= 0) return E_ARG;
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> any_err(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_frames) break;
      int rc = demovlp_read_frame(
          paths[i], object_num,
          out_feat + (size_t)i * object_num * kRegionDim,
          out_mask + (size_t)i * object_num,
          out_lens + i);
      out_status[i] = rc;
      if (rc != OK) any_err.store(rc);
    }
  };
  int nt = std::min(n_threads, n_frames);
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return any_err.load();
}

int demovlp_region_dim() { return kRegionDim; }

}  // extern "C"
