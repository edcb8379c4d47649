// Native host decode + pack layer.
//
// The port's only decode path: a single incremental C++ state machine, raw
// (already-decompressed) bytes in, dense [batch_rows, chunk_len] base-code
// batches or wire batches out. Its batches are byte-identical to the JAX
// package's (tests/test_torch_host.py), and its parsers replicate the
// reference's (ntcard.cpp:105-235):
//   * lines split on '\n' only; '\r' is kept (hashes as N)
//   * sniffer rules of getftype (ntcard.cpp:105-130); lenient mode = nthll's
//     no-error variant (nthll.cpp:70-90)
//   * FASTQ: 4-line records, record counted only once its quality line
//     completed (ntcard.cpp:173-189)
//   * FASTA: wrapped lines concatenated until the next '>' or EOF; every '>'
//     yields exactly one (possibly empty) record (ntcard.cpp:191-208)
//   * SAM: skip '@' header lines, take whitespace field 10; short lines
//     inherit the previous line's remaining fields (istringstream semantics,
//     ntcard.cpp:210-235)
//   * packing: records joined by single N separators into one code stream,
//     cut into chunk_len-long rows at the tile-aligned stride (halo overlap)
//     — StreamPacker semantics (io/packing.py)
//
// Built as a plain shared library with a C interface, driven through
// ctypes. All heavy loops run with the GIL released.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

uint8_t CODE[256];
struct CodeInit {
  CodeInit() {
    memset(CODE, 4, sizeof(CODE));
    CODE['A'] = CODE['a'] = 0;
    CODE['C'] = CODE['c'] = 1;
    CODE['G'] = CODE['g'] = 2;
    CODE['T'] = CODE['t'] = 3;
    CODE['U'] = CODE['u'] = 3;
  }
} code_init;

// ASCII -> code translation, vectorized where the CPU allows: vpermi2b does
// a 128-entry byte LUT per instruction (ASCII 0..127; the high-bit bytes —
// never valid bases — blend to N). Exactly CODE[] semantics.
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>

__attribute__((target("avx512f,avx512bw,avx512vbmi"))) static void
translate_codes_vbmi(uint8_t* dst, const uint8_t* src, size_t m) {
  const __m512i lo = _mm512_loadu_si512((const void*)CODE);
  const __m512i hi = _mm512_loadu_si512((const void*)(CODE + 64));
  const __m512i vn = _mm512_set1_epi8(4);
  size_t i = 0;
  for (; i + 64 <= m; i += 64) {
    const __m512i v = _mm512_loadu_si512((const void*)(src + i));
    const __mmask64 high = _mm512_movepi8_mask(v);  // bytes >= 0x80 -> N
    const __m512i t = _mm512_permutex2var_epi8(lo, v, hi);
    _mm512_storeu_si512((void*)(dst + i),
                        _mm512_mask_blend_epi8(high, t, vn));
  }
  for (; i < m; i++) dst[i] = CODE[src[i]];
}

static bool translate_vbmi_ok() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512bw") &&
                         __builtin_cpu_supports("avx512vbmi");
  return ok;
}

static inline void translate_codes(uint8_t* dst, const uint8_t* src,
                                   size_t m) {
  if (m >= 64 && translate_vbmi_ok()) {
    translate_codes_vbmi(dst, src, m);
    return;
  }
  for (size_t i = 0; i < m; i++) dst[i] = CODE[src[i]];
}
#else
static inline void translate_codes(uint8_t* dst, const uint8_t* src,
                                   size_t m) {
  for (size_t i = 0; i < m; i++) dst[i] = CODE[src[i]];
}
#endif

constexpr int FMT_UNKNOWN = -1, FMT_FASTQ = 0, FMT_FASTA = 1, FMT_SAM = 2,
              FMT_ERR = 3;

struct Packer {
  // geometry
  int chunk_len, batch_rows, kmax, stride;
  size_t batch_span, need;
  // code stream. Layout: [head, head+n) committed record bytes (incl.
  // separators) not yet consumed by pops; [head+n, head+n+pend) the
  // in-progress record,
  // translated eagerly but uncommitted (FASTQ truncation semantics: a
  // sequence line whose quality line never arrives is dropped by resetting
  // pend — reference getEfq counts a record only when its 4th line
  // completes, ntcard.cpp:173-189). Batches are composed directly from this
  // buffer at pop time (no intermediate batch materialization): the fewest
  // possible passes over every base — translate-in, compose-out.
  std::vector<uint8_t> buf;
  size_t head = 0;  // start of live bytes (pops advance it; grow compacts)
  size_t n = 0;     // committed bytes at [head, head+n)
  size_t pend = 0;  // uncommitted in-progress record bytes past head+n
  bool flushed = false;
  long long records = 0, bases = 0;
  // parser state
  bool lenient;
  int fmt = FMT_UNKNOWN;
  bool sniffed = false;
  std::string line;  // partial line carried across feed chunks
  int fq_phase = 0;  // 0=seq 1='+' 2=qual 3=header
  std::string sam_fields[11];
  bool sam_header_done = false;
  bool fa_open = false;

  Packer(int cl, int br, int km, bool len)
      : chunk_len(cl), batch_rows(br), kmax(km), lenient(len) {
    stride = ((cl - km + 1) / 8) * 8;
    batch_span = (size_t)batch_rows * stride;
    need = (size_t)(batch_rows - 1) * stride + chunk_len;
    buf.resize(need + 2 * (size_t)chunk_len);
  }

  void grow(size_t extra) {
    if (head + n + pend + extra <= buf.size()) return;
    if (head) {  // amortized O(1): right after a pop n+pend is ~halo bytes
      memmove(buf.data(), buf.data() + head, n + pend);
      head = 0;
    }
    if (n + pend + extra > buf.size())
      buf.resize(std::max(n + pend + extra, buf.size() * 2));
  }

  size_t ready_count() const {
    return n >= need ? 1 + (n - need) / batch_span : 0;
  }

  // append bases of the in-progress record (ASCII -> 2-bit-ish codes)
  void pend_append(const char* s, size_t m) {
    grow(m);
    translate_codes(buf.data() + head + n + pend, (const uint8_t*)s, m);
    pend += m;
  }

  // the in-progress record is complete: separator + stats
  void commit_record() {
    records++;
    bases += (long long)pend;
    grow(1);
    buf[head + n + pend] = 4;  // N separator
    n += pend + 1;
    pend = 0;
  }

  void add_record(const char* s, size_t m) {
    pend_append(s, m);
    commit_record();
  }
  void add_record(const std::string& s) { add_record(s.data(), s.size()); }

  // compose one ready batch straight from the stream buffer; packed=true
  // nibble-packs to the wire format (io/packing.py's nibble wire: chunk row r in
  // the high nibble, row r + B/2 in the low nibble)
  bool pop_batch(uint8_t* out, bool packed) {
    if (ready_count() == 0) return false;
    const uint8_t* b = buf.data() + head;
    if (packed) {
      int half = batch_rows / 2;
      size_t lo_off = (size_t)half * stride;
      for (int r = 0; r < half; r++) {
        const uint8_t* hi = b + (size_t)r * stride;
        const uint8_t* lo = hi + lo_off;
        uint8_t* dst = out + (size_t)r * chunk_len;
        for (int j = 0; j < chunk_len; j++)
          dst[j] = (uint8_t)((hi[j] << 4) | lo[j]);
      }
    } else {
      for (int r = 0; r < batch_rows; r++)
        memcpy(out + (size_t)r * chunk_len, b + (size_t)r * stride, chunk_len);
    }
    head += batch_span;
    n -= batch_span;
    if (n == 0 && pend == 0) head = 0;
    if (flushed && ready_count() == 0) {  // stream fully drained: reset
      head = 0;
      n = 0;
      flushed = false;
    }
    return true;
  }

  // compose one ready batch in the quad wire format (io/packing.py's quad wire):
  // rows [0, B/4) hold chunk rows b, b+B/4, b+2B/4, b+3B/4 at 2 bits each
  // (N sent as 0), followed by B/64 rows of a little-endian uint16 delta
  // stream of the flat N positions in [B, L] row-major space (values
  // 0..65533 advance+mark, 0xFFFF advance 65533 no-mark, 0xFFFE pad),
  // arranged column-major over the device's [nslots/128, 128] view.
  // Returns 1 on success, 0 if no batch is ready, -1 if the N count
  // overflows the delta slots (the stream buffer is left untouched so the
  // caller can pop the same batch nibble-packed instead).
  int pop_batch_quad(uint8_t* out) {
    if (ready_count() == 0) return 0;
    if (batch_rows % 64 || chunk_len % 2) return -1;
    const int g = batch_rows / 4;
    const int drows = batch_rows / 64;
    const size_t nslots = (size_t)drows * chunk_len / 2;
    if (nslots % 128) return -1;
    const size_t nr = nslots / 128;
    const uint8_t* b = buf.data() + head;

    // pass 1: delta stream (positions strictly increasing in flat order)
    uint16_t* tail = (uint16_t*)(out + (size_t)g * chunk_len);
    size_t si = 0;
    long long prev = 0;
    // write entry i at column-major slot (i % nr, i / nr)
    auto emit = [&](uint16_t v) {
      size_t slot = (si % nr) * 128 + (si / nr);
      tail[slot] = v;
      si++;
    };
    for (int r = 0; r < batch_rows; r++) {
      const uint8_t* row = b + (size_t)r * stride;
      for (int j = 0; j < chunk_len; j++) {
        if (row[j] != 4) continue;
        long long flat = (long long)r * chunk_len + j;
        long long d = flat - prev;
        while (d > 65533) {
          if (si >= nslots) return -1;
          emit(0xFFFF);
          d -= 65533;
        }
        if (si >= nslots) return -1;
        emit((uint16_t)d);
        prev = flat;
      }
    }
    // pad the unused slots
    size_t used = si;
    for (size_t i = used; i < nslots; i++) {
      size_t slot = (i % nr) * 128 + (i / nr);
      tail[slot] = 0xFFFE;
    }

    // pass 2: 2-bit code rows (N -> 0)
    const size_t qoff = (size_t)g * stride;
    for (int r = 0; r < g; r++) {
      const uint8_t* c0 = b + (size_t)r * stride;
      const uint8_t* c1 = c0 + qoff;
      const uint8_t* c2 = c1 + qoff;
      const uint8_t* c3 = c2 + qoff;
      uint8_t* dst = out + (size_t)r * chunk_len;
      for (int j = 0; j < chunk_len; j++) {
        uint8_t v0 = c0[j] == 4 ? 0 : c0[j];
        uint8_t v1 = c1[j] == 4 ? 0 : c1[j];
        uint8_t v2 = c2[j] == 4 ? 0 : c2[j];
        uint8_t v3 = c3[j] == 4 ? 0 : c3[j];
        dst[j] = (uint8_t)(v0 | (v1 << 2) | (v2 << 4) | (v3 << 6));
      }
    }

    // success: consume the batch from the stream buffer
    head += batch_span;
    n -= batch_span;
    if (n == 0 && pend == 0) head = 0;
    if (flushed && ready_count() == 0) {
      head = 0;
      n = 0;
      flushed = false;
    }
    return 1;
  }

  // compose one ready batch in the quad2 wire format (io/packing.py's
  // quad2 wire): [B/4 + B/128 + 1, stride] — owned spans only at
  // 2 bits/base (the halo is rebuilt on device from the next lane; one
  // raw-code tail row carries the last lane's halo), with a uint8 delta
  // sidecar of the N stream offsets (0..239 advance+mark, 240..253 advance
  // (v-239)*240 no-mark, 254 everything-after-is-N, 255 pad; column-major
  // over the device's [nslots/128, 128] view). Returns 1 on success, 0 if
  // no batch is ready, -1 on sidecar overflow/inadmissible geometry (the
  // stream buffer is left untouched for a nibble re-pop).
  int pop_batch_quad2(uint8_t* out) {
    if (ready_count() == 0) return 0;
    if (batch_rows % 128 || batch_rows < 256) return -1;
    const int g = batch_rows / 4;
    const int drows = batch_rows / 128;
    const int halo = chunk_len - stride;
    if (halo < 1 || halo > stride) return -1;
    const size_t nslots = (size_t)drows * stride;
    if (nslots % 128) return -1;
    const size_t nr = nslots / 128;
    const uint8_t* b = buf.data() + head;
    const size_t span = (size_t)batch_rows * stride;

    // pass 1: sidecar (N stream offsets, strictly increasing). The owned
    // spans tile the stream exactly, so offsets are plain buffer offsets.
    uint8_t* tail = out + (size_t)g * stride;
    size_t si = 0;
    auto emit = [&](uint8_t v) {
      size_t slot = (si % nr) * 128 + (si / nr);
      tail[slot] = v;
      si++;
    };
    // all-N suffix (flush padding): one fill entry instead of per-N marks
    size_t data_end = span;  // first index of the trailing all-N run
    while (data_end > 0 && b[data_end - 1] == 4) data_end--;
    long long prev = 0;
    for (size_t j = 0; j < (data_end < span ? data_end + 1 : span); j++) {
      if (b[j] != 4) continue;
      long long d = (long long)j - prev;
      while (d > 239) {
        long long u = d / 240;
        if (u > 14) u = 14;
        if (si >= nslots) return -1;
        emit((uint8_t)(239 + u));
        d -= u * 240;
      }
      if (si >= nslots) return -1;
      emit((uint8_t)d);
      prev = (long long)j;
    }
    if (data_end < span) {  // emit the fill marker after the suffix's first N
      if (si >= nslots) return -1;
      emit(254);
    }
    for (size_t i = si; i < nslots; i++) {
      size_t slot = (i % nr) * 128 + (i / nr);
      tail[slot] = 255;
    }

    // pass 2: 2-bit owned spans (N -> 0)
    const size_t qoff = (size_t)g * stride;
    for (int r = 0; r < g; r++) {
      const uint8_t* c0 = b + (size_t)r * stride;
      const uint8_t* c1 = c0 + qoff;
      const uint8_t* c2 = c1 + qoff;
      const uint8_t* c3 = c2 + qoff;
      uint8_t* dst = out + (size_t)r * stride;
      for (int j = 0; j < stride; j++) {
        uint8_t v0 = c0[j] == 4 ? 0 : c0[j];
        uint8_t v1 = c1[j] == 4 ? 0 : c1[j];
        uint8_t v2 = c2[j] == 4 ? 0 : c2[j];
        uint8_t v3 = c3[j] == 4 ? 0 : c3[j];
        dst[j] = (uint8_t)(v0 | (v1 << 2) | (v2 << 4) | (v3 << 6));
      }
    }

    // pass 3: tail row — the last lane's halo as raw codes, N-padded
    uint8_t* trow = out + ((size_t)g + drows) * stride;
    memcpy(trow, b + span, halo);
    memset(trow + halo, 4, stride - halo);

    // success: consume the batch from the stream buffer
    head += batch_span;
    n -= batch_span;
    if (n == 0 && pend == 0) head = 0;
    if (flushed && ready_count() == 0) {
      head = 0;
      n = 0;
      flushed = false;
    }
    return 1;
  }

  static bool is_number(const std::string& t) {
    if (t.empty()) return false;
    for (char c : t)
      if (c < '0' || c > '9') return false;
    return true;
  }

  void split_ws(const std::string& l, std::vector<std::string>& out) {
    out.clear();
    size_t i = 0, m = l.size();
    while (i < m) {
      while (i < m && isspace((unsigned char)l[i])) i++;
      size_t s = i;
      while (i < m && !isspace((unsigned char)l[i])) i++;
      if (i > s) out.push_back(l.substr(s, i - s));
    }
  }

  void sniff(const std::string& l) {
    sniffed = true;
    if (!l.empty() && l[0] == '>') {
      fmt = FMT_FASTA;
      fa_open = true;  // first record started by the consumed header
      return;
    }
    if (!l.empty() && l[0] == '@') {
      if (l.size() >= 3) {
        const char a = l[1], b = l[2];
        if ((a == 'H' && b == 'D') || (a == 'S' && b == 'Q') ||
            (a == 'R' && b == 'G') || (a == 'P' && b == 'G') ||
            (a == 'C' && b == 'O')) {
          fmt = FMT_SAM;
          sam_header_done = false;  // skip only the LEADING '@' header block
          return;
        }
      }
      fmt = FMT_FASTQ;
      fq_phase = 0;  // header consumed; next line is the sequence
      return;
    }
    if (lenient) {
      fmt = FMT_SAM;
      sam_header_done = true;  // headerless: the line IS alignment #1
      sam_line(l);
      return;
    }
    std::vector<std::string> f;
    split_ws(l, f);
    // getftype (ntcard.cpp:124-128): istringstream >> leaves missing fields
    // empty, so only fields 2 and 5 need to exist and be numeric — there is
    // no minimum-field-count requirement.
    if (f.size() > 4 && is_number(f[1]) && is_number(f[4])) {
      fmt = FMT_SAM;
      sam_header_done = true;
      sam_line(l);
      return;
    }
    fmt = FMT_ERR;
  }

  void sam_line(const std::string& l) {
    // getEsm (ntcard.cpp:220-224) skips '@' lines only until the first
    // non-'@' line; a mid-file '@' line is parsed as an alignment (whose
    // missing fields inherit the previous line's values).
    if (!sam_header_done) {
      if (!l.empty() && l[0] == '@') return;
      sam_header_done = true;
    }
    std::vector<std::string> toks;
    split_ws(l, toks);
    size_t m = toks.size() < 11 ? toks.size() : 11;
    for (size_t i = 0; i < m; i++) sam_fields[i] = std::move(toks[i]);
    add_record(sam_fields[9]);
  }

  // FASTA bases are never rolled back (a record terminates at '>' or EOF,
  // both of which commit — ntcard.cpp:191-208), so wrapped lines append as
  // already-committed stream bytes: batches can pop while a chromosome-scale
  // contig is still being read, bounding memory (the reference concatenates
  // the whole contig in RAM first).
  long long fa_len = 0;

  void fasta_append(const char* s, size_t m) {
    grow(m);  // pend == 0 in FASTA mode
    translate_codes(buf.data() + head + n, (const uint8_t*)s, m);
    n += m;
    fa_len += (long long)m;
  }

  void fasta_end_record() {
    records++;
    bases += fa_len;
    fa_len = 0;
    grow(1);
    buf[head + n] = 4;  // N separator
    n += 1;
  }

  void handle_line(const char* s, size_t m) {
    if (!sniffed) {
      sniff(std::string(s, m));
      return;
    }
    switch (fmt) {
      case FMT_FASTQ:
        switch (fq_phase) {
          case 0: pend_append(s, m); fq_phase = 1; break;  // sequence line
          case 1: fq_phase = 2; break;        // '+'
          case 2: commit_record(); fq_phase = 3; break;  // qual completed
          default: fq_phase = 0; break;       // next record's header
        }
        break;
      case FMT_FASTA:
        if (m && s[0] == '>') {
          fasta_end_record();
        } else {
          fasta_append(s, m);
        }
        break;
      case FMT_SAM:
        sam_line(std::string(s, m));
        break;
      default:
        break;  // FMT_ERR: ignore the rest
    }
  }

  void feed(const uint8_t* data, size_t m) {
    size_t i = 0;
    // carry-over from the previous chunk
    if (!line.empty()) {
      const void* p = memchr(data, '\n', m);
      if (!p) {
        line.append((const char*)data, m);
        return;
      }
      size_t j = (const uint8_t*)p - data;
      line.append((const char*)data, j);
      handle_line(line.data(), line.size());
      line.clear();
      i = j + 1;
    }
    while (i < m) {
      const void* p = memchr(data + i, '\n', m - i);
      if (!p) {
        line.append((const char*)data + i, m - i);
        break;
      }
      size_t j = (const uint8_t*)p - data;
      handle_line((const char*)data + i, j - i);
      i = j + 1;
    }
  }

  bool sniffed_any_ = false;
  int fmt_after_finish_ = FMT_UNKNOWN;

  void finish_stream() {
    // a trailing line without '\n' still counts as a line (C++ getline)
    if (!line.empty()) {
      handle_line(line.data(), line.size());
      line.clear();
    }
    // lenient (nthll) mode: an empty file is processed silently as one empty
    // headerless-SAM record (a lenient sniff of EOF yields SAM with an empty
    // first alignment), matching nthll's no-error reader loop
    // (nthll.cpp:224-235).
    if (lenient && !sniffed) sniff(std::string());
    // FASTA's in-progress last record terminates at EOF
    if (fmt == FMT_FASTA && fa_open) {
      fasta_end_record();
      fa_open = false;
    }
    pend = 0;  // truncated FASTQ record (no completed quality line): dropped
    sniffed_any_ = sniffed;
    fmt_after_finish_ = fmt;
  }

  void reset_file_state() {
    // per-file parser state resets; stream-level packing state persists so
    // multiple files share one packed stream
    sniffed = false;
    fmt = FMT_UNKNOWN;
    fq_phase = 0;
    pend = 0;
    fa_len = 0;
    fa_open = false;
    for (auto& f : sam_fields) f.clear();
    sam_header_done = false;
  }

  long flush_pad() {
    // pad with N so that every committed base's owned window lands in some
    // chunk: ceil(n / batch_span) more batches, the last one padded out to
    // `need` (the old emit-loop semantics, deferred to pop time)
    pend = 0;
    if (n > 0) {
      size_t b = (n + batch_span - 1) / batch_span;
      size_t target = (b - 1) * batch_span + need;
      grow(target - n);
      memset(buf.data() + head + n, 4, target - n);
      n = target;
      flushed = true;
    }
    return (long)ready_count();
  }
};

}  // namespace

extern "C" {

void* packer_create(int chunk_len, int batch_rows, int kmax, int lenient) {
  return new Packer(chunk_len, batch_rows, kmax, lenient != 0);
}

void packer_destroy(void* h) { delete (Packer*)h; }

int packer_stride(void* h) { return ((Packer*)h)->stride; }

// feed raw decompressed bytes; returns number of ready batches (or -1 if the
// stream's format could not be recognized)
long packer_feed(void* h, const uint8_t* data, long m) {
  Packer* p = (Packer*)h;
  p->feed(data, (size_t)m);
  if (p->fmt == FMT_ERR) return -1;
  return (long)p->ready_count();
}

// end of current file: flush parser state; returns ready batches (-1 on
// unrecognized format; an empty file is an error — reference getftype runs
// its sniff on the failed getline's empty string and lands on error,
// ntcard.cpp:105-130)
long packer_end_file(void* h) {
  Packer* p = (Packer*)h;
  p->finish_stream();  // may sniff a trailing unterminated line
  bool err = (p->sniffed_any_ ? p->fmt_after_finish_ == FMT_ERR : true);
  p->reset_file_state();
  return err ? -1 : (long)p->ready_count();
}

// end of all input: pad and emit the final partial batch(es)
long packer_flush(void* h) { return ((Packer*)h)->flush_pad(); }

// pop one ready batch into out (batch_rows*chunk_len bytes); 1 on success
int packer_pop(void* h, uint8_t* out) {
  return ((Packer*)h)->pop_batch(out, false) ? 1 : 0;
}

// pop one ready batch nibble-packed to the H2D wire format
// ((batch_rows/2)*chunk_len bytes, io/packing.py's nibble wire); 1 on success
int packer_pop_packed(void* h, uint8_t* out) {
  return ((Packer*)h)->pop_batch(out, true) ? 1 : 0;
}

// pop one ready batch in the quad wire format
// ((batch_rows/4 + batch_rows/64)*chunk_len bytes, io/packing.py's
// quad wire); 1 on success, 0 if not ready, -1 on delta-slot overflow (pop the
// same batch with packer_pop_packed instead)
int packer_pop_quad(void* h, uint8_t* out) {
  return ((Packer*)h)->pop_batch_quad(out);
}

// pop one ready batch in the quad2 wire format
// ((batch_rows/4 + batch_rows/128 + 1)*stride bytes, io/packing.py's
// quad2 wire); 1 on success, 0 if not ready, -1 on sidecar
// overflow (pop the same batch with packer_pop_packed instead)
int packer_pop_quad2(void* h, uint8_t* out) {
  return ((Packer*)h)->pop_batch_quad2(out);
}

void packer_stats(void* h, long long* records, long long* bases) {
  Packer* p = (Packer*)h;
  *records = p->records;
  *bases = p->bases;
}

// compEst's O(covMax^2) f_i recursion (reference ntcard.cpp:265-272),
// bit-identical float64 evaluation order; the Python loop is too slow for
// covMax up to 65535.
void ntcard_f_recursion(const double* p_mean, long cov_max, double denom,
                        double p0, double* fm) {
  for (long i = 0; i <= cov_max; i++) fm[i] = 0.0;
  if (cov_max >= 1) fm[1] = -1.0 * p_mean[1] / denom;
  for (long i = 2; i <= cov_max; i++) {
    double sum = 0.0;
    for (long j = 1; j < i; j++) sum += j * p_mean[i - j] * fm[j];
    fm[i] = -1.0 * p_mean[i] / denom - sum / (i * p0);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host sketch engine: the full hash -> sample -> count pipeline on the host
// CPU, consuming the SAME [batch_rows, chunk_len] packed code batches as the
// device kernels (identical separator/halo/stride window-ownership
// semantics), so parity with the device path is structural. Used for
// latency-bound small inputs where accelerator startup/transfer dominates
// (models/host_engine.py); unlike the reference's file-level OpenMP fan-out
// (ntcard.cpp:445-467, serial on a single big file) this threads WITHIN the
// batch, over rows.
//
// The rolling-hash algebra mirrors ntcard_tpu/ops/nthash_ref.py (our own
// two-ring derivation of ntHash; see constants.py for the frozen published
// seed constants, reference vendor/ntHash/nthash.hpp:25-29):
//   forward window hash  F = XOR_j P^(k-1-j)(seed(w[j]))
//   reverse window hash  R = XOR_j P^j(seed(comp w[j]))
//   roll:  F' = P(F) ^ seed(in) ^ P^k(seed(out))
//          R' = P^-1(R ^ P^k(seed(comp in)) ^ seed(comp out))
// where P = srol (independent 33-bit low / 31-bit high ring rotation).
// Rolling starts from 0 at the row edge and is exact once the window is
// fully inside (every departed base's contribution is removed bit-exactly;
// seed(N) = 0), the property tests/test_nthash_oracle.py pins.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t HSEED[5] = {
    0x3C8BFBB395C60474ULL,  // A
    0x3193C18562A02B4CULL,  // C
    0x20323ED082572324ULL,  // G
    0x295549F54BE24456ULL,  // T (and U)
    0ULL,                   // N/other
};
constexpr int HCOMP[5] = {3, 2, 1, 0, 4};

inline uint64_t hsrol1(uint64_t v) {
  uint64_t lo = v & 0x1FFFFFFFFULL;  // 33-bit ring, bits [0..32]
  uint64_t hi = v >> 33;             // 31-bit ring, bits [33..63]
  lo = ((lo << 1) | (lo >> 32)) & 0x1FFFFFFFFULL;
  hi = ((hi << 1) | (hi >> 30)) & 0x7FFFFFFFULL;
  return (hi << 33) | lo;
}

inline uint64_t hsror1(uint64_t v) {
  uint64_t lo = v & 0x1FFFFFFFFULL;
  uint64_t hi = v >> 33;
  lo = ((lo >> 1) | (lo << 32)) & 0x1FFFFFFFFULL;
  hi = ((hi >> 1) | (hi << 30)) & 0x7FFFFFFFULL;
  return (hi << 33) | lo;
}

inline uint64_t hsrol_n(uint64_t v, long n) {
  uint64_t lo = v & 0x1FFFFFFFFULL;
  uint64_t hi = v >> 33;
  int s33 = (int)(n % 33), s31 = (int)(n % 31);
  if (s33) lo = ((lo << s33) | (lo >> (33 - s33))) & 0x1FFFFFFFFULL;
  if (s31) hi = ((hi << s31) | (hi >> (31 - s31))) & 0x7FFFFFFFULL;
  return (hi << 33) | lo;
}

// Per-k constant tables for the rolling recurrences and (optionally) the
// spaced-seed strip pass (NTMS64 semantics, masked positions' contributions
// XORed back out — ops/nthash_ref.py:142-151).
struct HostK {
  int k;
  uint64_t rotk[5];        // P^k(seed(c))
  uint64_t rotk_comp[5];   // P^k(seed(comp c))
};

void host_fill_k(HostK& hk, int k) {
  hk.k = k;
  for (int c = 0; c < 5; c++) {
    hk.rotk[c] = hsrol_n(HSEED[c], k);
    hk.rotk_comp[c] = hsrol_n(HSEED[HCOMP[c]], k);
  }
}

// G rows of one k in lockstep. A single row's rolling recurrence is a serial
// rotate-XOR chain (~4-5 cycle latency per base with nothing else to issue);
// G independent chains interleaved in registers fill those latency slots —
// measured ~2x per core at G=4 vs one row at a time. Semantics are identical
// to the row-at-a-time loop (table updates are commutative atomics, F1 is
// additive). tbl_j points at this k's [2][2^r_bits] slice.
template <int G>
inline void host_rows_k(const uint8_t* codes, long long row_len, long long rb,
                        long long stride, const HostK& hk,
                        int s_bits, int r_bits,
                        const int32_t* mask_pos, int n_mask,
                        const uint64_t* strip_f, const uint64_t* strip_r,
                        uint16_t* tbl_j, long long& f1_out) {
  const uint64_t r_buck = 1ULL << r_bits;
  const uint64_t r_mask = r_buck - 1;
  const uint64_t s_mask = (1ULL << (s_bits - 1)) - 1;
  const int k = hk.k;
  const long long e_end = std::min(row_len, stride + k - 1);
  const uint8_t* row[G];
  uint64_t fh[G], rh[G];
  long long runlen[G];
  long long f1j = 0;
  for (int g = 0; g < G; g++) {
    row[g] = codes + (rb + g) * row_len;
    fh[g] = rh[g] = 0;
    runlen[g] = 0;
  }
  // ntcard's asymmetric two-sample test (ntcard.cpp:135-139; mirrored from
  // ops/nthash.make_sketch_emit): when both tests pass (possible at
  // s_bits=1) the update goes to sample 1
  auto emit = [&](int g, long long e) {
    f1j++;
    uint64_t fs = fh[g], rs = rh[g];
    if (n_mask) {
      const long long i = e - k + 1;
      for (int m = 0; m < n_mask; m++) {
        const int cp = row[g][i + mask_pos[m]];
        fs ^= strip_f[m * 5 + cp];
        rs ^= strip_r[m * 5 + cp];
      }
    }
    const uint64_t h = fs < rs ? fs : rs;
    const bool s1 = (h >> (64 - s_bits)) == s_mask;
    const bool s0 = (h >> (63 - s_bits)) == 1ULL;
    if (s0 || s1) {
      const size_t idx = (s1 ? r_buck : 0) + (h & r_mask);
      __atomic_fetch_add(&tbl_j[idx], (uint16_t)1, __ATOMIC_RELAXED);
    }
  };
  // warmup: no base leaves the window yet (rot/seed of N are 0)
  const long long warm = std::min((long long)k, e_end);
  for (long long e = 0; e < warm; e++) {
    for (int g = 0; g < G; g++) {
      const int c = row[g][e];
      fh[g] = hsrol1(fh[g]) ^ HSEED[c];
      rh[g] = hsror1(rh[g] ^ hk.rotk_comp[c]);
      runlen[g] = (c == 4) ? 0 : runlen[g] + 1;
      if (e == k - 1 && runlen[g] >= k) emit(g, e);
    }
  }
  // steady state: every e has an outgoing base and e >= k - 1
  for (long long e = warm; e < e_end; e++) {
    for (int g = 0; g < G; g++) {
      const int c = row[g][e];
      const int out_c = row[g][e - k];
      fh[g] = hsrol1(fh[g]) ^ HSEED[c] ^ hk.rotk[out_c];
      rh[g] = hsror1(rh[g] ^ hk.rotk_comp[c] ^ HSEED[HCOMP[out_c]]);
      runlen[g] = (c == 4) ? 0 : runlen[g] + 1;
      if (runlen[g] >= k) emit(g, e);
    }
  }
  f1_out += f1j;
}

// ---------------------------------------------------------------------------
// AVX-512 lane-parallel engine: 8 rows of one k per zmm register. The split
// 33/31 dual-ring rotation decomposes into 3 shifts + 3 masks + 2 ors per
// strand, and the 5-entry per-code seed tables (HSEED / P^k tables) each fit
// one register, looked up with a single vpermq (permutexvar_epi64). Guarded
// by __builtin_cpu_supports at runtime so the .so stays portable
// (-mtune=generic baseline; only this function carries the target attr).
// Gap seeds (n_mask > 0) stay on the scalar path.
// ---------------------------------------------------------------------------
#if defined(__x86_64__) && defined(__GNUC__)
#define NTCARD_HAVE_AVX512_PATH 1
#include <immintrin.h>

__attribute__((target("avx512f"))) static inline __m512i vsrol1(__m512i v) {
  // lo ring bits [0..32] rotl1, hi ring bits [33..63] rotl1:
  //   bit32 -> bit0, bit63 -> bit33, everything else shifts left one
  const __m512i keep = _mm512_set1_epi64((long long)~((1ULL << 33) | 1ULL));
  __m512i s = _mm512_and_si512(_mm512_slli_epi64(v, 1), keep);
  __m512i b0 = _mm512_and_si512(_mm512_srli_epi64(v, 32), _mm512_set1_epi64(1));
  __m512i b33 = _mm512_and_si512(_mm512_srli_epi64(v, 30),
                                 _mm512_set1_epi64(1LL << 33));
  return _mm512_or_si512(s, _mm512_or_si512(b0, b33));
}

__attribute__((target("avx512f"))) static inline __m512i vsror1(__m512i v) {
  // bit0 -> bit32, bit33 -> bit63, everything else shifts right one
  const __m512i keep =
      _mm512_set1_epi64((long long)~((1ULL << 32) | (1ULL << 63)));
  __m512i s = _mm512_and_si512(_mm512_srli_epi64(v, 1), keep);
  __m512i b32 = _mm512_and_si512(_mm512_slli_epi64(v, 32),
                                 _mm512_set1_epi64(1LL << 32));
  __m512i b63 = _mm512_and_si512(_mm512_slli_epi64(v, 30),
                                 _mm512_set1_epi64((long long)(1ULL << 63)));
  return _mm512_or_si512(s, _mm512_or_si512(b32, b63));
}

__attribute__((target("avx512f"))) static inline __m512i vload_tab5(
    const uint64_t* t5) {
  alignas(64) uint64_t tb[8];
  for (int c = 0; c < 5; c++) tb[c] = t5[c];
  tb[5] = tb[6] = tb[7] = 0;  // code indices are only ever 0..4
  return _mm512_load_si512((const void*)tb);
}

// sample test for 8 valid lanes (ntcard.cpp:135-139): s1 wins when both pass
__attribute__((target("avx512f"))) static inline void vemit(
    __m512i fh, __m512i rh, __mmask8 valid, __m128i sh_s1, __m128i sh_s0,
    __m512i vsmask, __m512i vone, uint64_t r_buck, uint64_t r_mask,
    uint16_t* tbl_j, long long& f1j) {
  f1j += __builtin_popcount((unsigned)valid);
  const __m512i h = _mm512_min_epu64(fh, rh);
  const __mmask8 s1 =
      _mm512_mask_cmpeq_epi64_mask(valid, _mm512_srl_epi64(h, sh_s1), vsmask);
  const __mmask8 s0 =
      _mm512_mask_cmpeq_epi64_mask(valid, _mm512_srl_epi64(h, sh_s0), vone);
  const __mmask8 upd = (__mmask8)(s0 | s1);
  if (upd) {
    alignas(64) uint64_t hv[8];
    _mm512_store_si512((void*)hv, h);
    for (int g = 0; g < 8; g++)
      if ((upd >> g) & 1) {
        const size_t idx = (((s1 >> g) & 1) ? r_buck : 0) + (hv[g] & r_mask);
        __atomic_fetch_add(&tbl_j[idx], (uint16_t)1, __ATOMIC_RELAXED);
      }
  }
}

// 8 rows of one k in zmm lanes, reading the column-transposed code buffer
// (colbuf[e*8 + g] = codes[(rb+g)*row_len + e], filled once per 8-row block
// and shared by every k). Bit-identical to host_rows_k<8> with n_mask == 0.
__attribute__((target("avx512f"))) static void host_rows8_k_avx512(
    const uint8_t* colbuf, long long row_len, long long stride,
    const HostK& hk, int s_bits, int r_bits, uint16_t* tbl_j,
    long long& f1_out) {
  const uint64_t r_buck = 1ULL << r_bits;
  const uint64_t r_mask = r_buck - 1;
  const uint64_t s_mask = (1ULL << (s_bits - 1)) - 1;
  const int k = hk.k;
  const long long e_end = std::min(row_len, stride + k - 1);

  const __m512i vseed = vload_tab5(HSEED);
  const __m512i vrotk = vload_tab5(hk.rotk);
  const __m512i vrotk_comp = vload_tab5(hk.rotk_comp);
  uint64_t seed_comp_tab[5];
  for (int c = 0; c < 5; c++) seed_comp_tab[c] = HSEED[HCOMP[c]];
  const __m512i vseed_comp = vload_tab5(seed_comp_tab);

  const __m512i vfour = _mm512_set1_epi64(4);
  const __m512i vone = _mm512_set1_epi64(1);
  const __m512i vk = _mm512_set1_epi64(k);
  const __m512i vsmask = _mm512_set1_epi64((long long)s_mask);
  const __m128i sh_s1 = _mm_cvtsi32_si128(64 - s_bits);
  const __m128i sh_s0 = _mm_cvtsi32_si128(63 - s_bits);

  __m512i fh = _mm512_setzero_si512();
  __m512i rh = _mm512_setzero_si512();
  __m512i runlen = _mm512_setzero_si512();
  long long f1j = 0;

  // warmup: no base leaves the window yet
  const long long warm = std::min((long long)k, e_end);
  for (long long e = 0; e < warm; e++) {
    const __m512i c = _mm512_cvtepu8_epi64(
        _mm_loadl_epi64((const __m128i*)(colbuf + e * 8)));
    fh = _mm512_xor_si512(vsrol1(fh), _mm512_permutexvar_epi64(c, vseed));
    rh = vsror1(_mm512_xor_si512(rh, _mm512_permutexvar_epi64(c, vrotk_comp)));
    const __mmask8 not_n = _mm512_cmpneq_epi64_mask(c, vfour);
    runlen = _mm512_maskz_add_epi64(not_n, runlen, vone);
    if (e == k - 1) {
      const __mmask8 valid = _mm512_cmpge_epi64_mask(runlen, vk);
      if (valid)
        vemit(fh, rh, valid, sh_s1, sh_s0, vsmask, vone, r_buck, r_mask,
              tbl_j, f1j);
    }
  }
  // steady state: every e has an outgoing base and e >= k - 1
  for (long long e = warm; e < e_end; e++) {
    const __m512i c = _mm512_cvtepu8_epi64(
        _mm_loadl_epi64((const __m128i*)(colbuf + e * 8)));
    const __m512i oc = _mm512_cvtepu8_epi64(
        _mm_loadl_epi64((const __m128i*)(colbuf + (e - k) * 8)));
    fh = _mm512_xor_si512(
        vsrol1(fh),
        _mm512_xor_si512(_mm512_permutexvar_epi64(c, vseed),
                         _mm512_permutexvar_epi64(oc, vrotk)));
    rh = vsror1(_mm512_xor_si512(
        rh, _mm512_xor_si512(_mm512_permutexvar_epi64(c, vrotk_comp),
                             _mm512_permutexvar_epi64(oc, vseed_comp))));
    const __mmask8 not_n = _mm512_cmpneq_epi64_mask(c, vfour);
    runlen = _mm512_maskz_add_epi64(not_n, runlen, vone);
    const __mmask8 valid = _mm512_cmpge_epi64_mask(runlen, vk);
    if (valid)
      vemit(fh, rh, valid, sh_s1, sh_s0, vsmask, vone, r_buck, r_mask,
            tbl_j, f1j);
  }
  f1_out += f1j;
}

// 8 rows of the nthll HyperLogLog update in zmm lanes (register value =
// max(old, clz of the hash above the bucket bits), nthll.cpp:92-97; clz of
// an all-zero top counts as 0). Registers are thread-private, so the
// per-lane max fold is a plain scalar tail. Needs avx512cd for vplzcntq.
__attribute__((target("avx512f,avx512cd"))) static void host_hll_rows8_avx512(
    const uint8_t* colbuf, long long row_len, long long stride,
    const HostK& hk, int n_bits, uint8_t* priv) {
  const uint64_t n_buck = 1ULL << n_bits;
  const uint64_t b_mask = n_buck - 1;
  const int k = hk.k;
  const long long e_end = std::min(row_len, stride + k - 1);

  const __m512i vseed = vload_tab5(HSEED);
  const __m512i vrotk = vload_tab5(hk.rotk);
  const __m512i vrotk_comp = vload_tab5(hk.rotk_comp);
  uint64_t seed_comp_tab[5];
  for (int c = 0; c < 5; c++) seed_comp_tab[c] = HSEED[HCOMP[c]];
  const __m512i vseed_comp = vload_tab5(seed_comp_tab);

  const __m512i vfour = _mm512_set1_epi64(4);
  const __m512i vone = _mm512_set1_epi64(1);
  const __m512i vk = _mm512_set1_epi64(k);
  const __m512i vbmask = _mm512_set1_epi64((long long)b_mask);
  const __m512i vtopmask = _mm512_set1_epi64((long long)~b_mask);

  __m512i fh = _mm512_setzero_si512();
  __m512i rh = _mm512_setzero_si512();
  __m512i runlen = _mm512_setzero_si512();

  alignas(64) uint64_t iv[8];
  alignas(64) uint64_t rv[8];
  const long long warm = std::min((long long)k, e_end);
  for (long long e = 0; e < e_end; e++) {
    const __m512i c = _mm512_cvtepu8_epi64(
        _mm_loadl_epi64((const __m128i*)(colbuf + e * 8)));
    if (e < warm) {
      fh = _mm512_xor_si512(vsrol1(fh), _mm512_permutexvar_epi64(c, vseed));
      rh = vsror1(
          _mm512_xor_si512(rh, _mm512_permutexvar_epi64(c, vrotk_comp)));
    } else {
      const __m512i oc = _mm512_cvtepu8_epi64(
          _mm_loadl_epi64((const __m128i*)(colbuf + (e - k) * 8)));
      fh = _mm512_xor_si512(
          vsrol1(fh),
          _mm512_xor_si512(_mm512_permutexvar_epi64(c, vseed),
                           _mm512_permutexvar_epi64(oc, vrotk)));
      rh = vsror1(_mm512_xor_si512(
          rh, _mm512_xor_si512(_mm512_permutexvar_epi64(c, vrotk_comp),
                               _mm512_permutexvar_epi64(oc, vseed_comp))));
    }
    const __mmask8 not_n = _mm512_cmpneq_epi64_mask(c, vfour);
    runlen = _mm512_maskz_add_epi64(not_n, runlen, vone);
    if (e < k - 1) continue;
    const __mmask8 valid = _mm512_cmpge_epi64_mask(runlen, vk);
    if (!valid) continue;
    const __m512i h = _mm512_min_epu64(fh, rh);
    const __m512i masked = _mm512_and_si512(h, vtopmask);
    const __mmask8 nz = _mm512_test_epi64_mask(masked, masked);
    const __m512i run0 =
        _mm512_maskz_mov_epi64(nz, _mm512_lzcnt_epi64(masked));
    _mm512_store_si512((void*)iv, _mm512_and_si512(h, vbmask));
    _mm512_store_si512((void*)rv, run0);
    for (int g = 0; g < 8; g++)
      if ((valid >> g) & 1) {
        uint8_t& slot = priv[iv[g]];
        if ((uint8_t)rv[g] > slot) slot = (uint8_t)rv[g];
      }
  }
}

static bool host_avx512_ok() {
  static const bool ok = __builtin_cpu_supports("avx512f");
  return ok;
}

static bool host_avx512cd_ok() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512cd");
  return ok;
}
#else
#define NTCARD_HAVE_AVX512_PATH 0
#endif  // x86_64 && GNUC

}  // namespace

extern "C" {

// One batch step of the ntcard count-table sketch on the host.
//   codes:  [rows, row_len] uint8 base codes (0..3 = ACGT, 4 = N), the raw
//           (unpacked) StreamPacker/NativePacker batch layout
//   stride: owned window starts per row (io/packing.aligned_stride)
//   table:  uint16[nk][2][2^r_bits], reference layout (ntcard.cpp:437-439),
//           updated with relaxed atomic increments (wraps mod 2^16 like the
//           reference's uint16)
//   f1:     int64[nk], += exact valid-window counts
//   mask_pos/n_mask: spaced-seed masked positions (empty for plain k-mers)
void ntcard_host_update(const uint8_t* codes, long long rows, long long row_len,
                        long long stride, const int32_t* ks, int nk,
                        int s_bits, int r_bits,
                        const int32_t* mask_pos, int n_mask,
                        uint16_t* table, long long* f1, int nthreads) {
  const uint64_t r_buck = 1ULL << r_bits;
  const uint64_t r_mask = r_buck - 1;
  const uint64_t s_mask = (1ULL << (s_bits - 1)) - 1;
  std::vector<HostK> hks(nk);
  for (int j = 0; j < nk; j++) host_fill_k(hks[j], ks[j]);
  // spaced-seed strip tables: per masked position p, P^(k-1-p)(seed(c)) for
  // the forward strand and P^p(seed(comp c)) for the reverse strand
  std::vector<uint64_t> strip_f(n_mask * 5), strip_r(n_mask * 5);
  for (int m = 0; m < n_mask; m++) {
    for (int c = 0; c < 5; c++) {
      strip_f[m * 5 + c] = hsrol_n(HSEED[c], ks[0] - 1 - mask_pos[m]);
      strip_r[m * 5 + c] = hsrol_n(HSEED[HCOMP[c]], mask_pos[m]);
    }
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = nthreads > 0 ? nthreads : (int)(hw ? hw : 1);
  nt = (int)std::min<long long>(nt, rows);
  if (nt < 1) nt = 1;
  std::vector<std::vector<long long>> f1_local(nt, std::vector<long long>(nk, 0));
  std::vector<std::thread> threads;
  long long rows_per = (rows + nt - 1) / nt;
  (void)r_mask;
  (void)s_mask;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      long long r0 = t * rows_per, r1 = std::min(rows, r0 + rows_per);
      long long r = r0;
#if NTCARD_HAVE_AVX512_PATH
      if (n_mask == 0 && host_avx512_ok()) {
        // column-transpose each 8-row block once (colbuf[e*8+g] = block
        // row g at column e) so the lane loops load one u64 per step;
        // the transpose is shared by every k
        long long e_max = 0;
        for (int j = 0; j < nk; j++)
          e_max = std::max(e_max,
                           std::min(row_len, stride + (long long)hks[j].k - 1));
        std::vector<uint8_t> colbuf((size_t)e_max * 8);
        for (; r + 8 <= r1; r += 8) {
          for (int g = 0; g < 8; g++) {
            const uint8_t* row = codes + (size_t)(r + g) * row_len;
            for (long long e = 0; e < e_max; e++) colbuf[e * 8 + g] = row[e];
          }
          for (int j = 0; j < nk; j++)
            host_rows8_k_avx512(colbuf.data(), row_len, stride, hks[j],
                                s_bits, r_bits,
                                table + (size_t)j * 2 * r_buck,
                                f1_local[t][j]);
        }
      }
#endif
      for (int j = 0; j < nk; j++) {
        const HostK& hk = hks[j];
        uint16_t* tbl_j = table + (size_t)j * 2 * r_buck;
        long long f1j = 0;
        long long rr = r;
        for (; rr + 4 <= r1; rr += 4)
          host_rows_k<4>(codes, row_len, rr, stride, hk, s_bits, r_bits,
                         mask_pos, n_mask, strip_f.data(), strip_r.data(),
                         tbl_j, f1j);
        for (; rr < r1; rr++)
          host_rows_k<1>(codes, row_len, rr, stride, hk, s_bits, r_bits,
                         mask_pos, n_mask, strip_f.data(), strip_r.data(),
                         tbl_j, f1j);
        f1_local[t][j] += f1j;
      }
    });
  }
  for (auto& th : threads) th.join();
  // atomic: the table updates above are relaxed-atomic, so concurrent
  // update() calls on one sketch are legal — the F1 fold must not be the
  // one plain RMW that loses counts under that (latent) concurrency
  for (int j = 0; j < nk; j++)
    for (int t = 0; t < nt; t++)
      __atomic_fetch_add(&f1[j], f1_local[t][j], __ATOMIC_RELAXED);
}

// One batch step of the nthll HyperLogLog sketch on the host.
//   regs: uint8[2^n_bits]; register index = h & (2^n_bits - 1), value =
//         max(old, clz64(h & ~(2^n_bits - 1))) with clz of 0 counting as 0
//         (nthll.cpp:92-97 semantics, mirrored from ops/nthash.make_hll_emit)
void ntcard_host_hll_update(const uint8_t* codes, long long rows,
                            long long row_len, long long stride, int k,
                            int n_bits, uint8_t* regs, int nthreads) {
  const uint64_t n_buck = 1ULL << n_bits;
  const uint64_t b_mask = n_buck - 1;
  HostK hk;
  host_fill_k(hk, k);
  unsigned hw = std::thread::hardware_concurrency();
  int nt = nthreads > 0 ? nthreads : (int)(hw ? hw : 1);
  nt = (int)std::min<long long>(nt, rows);
  if (nt < 1) nt = 1;
  std::vector<std::vector<uint8_t>> local(nt);
  std::vector<std::thread> threads;
  long long rows_per = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      std::vector<uint8_t>& priv = local[t];
      priv.assign(n_buck, 0);
      long long r0 = t * rows_per, r1 = std::min(rows, r0 + rows_per);
      long long r = r0;
#if NTCARD_HAVE_AVX512_PATH
      if (host_avx512cd_ok()) {
        const long long e_max = std::min(row_len, stride + (long long)k - 1);
        std::vector<uint8_t> colbuf((size_t)e_max * 8);
        for (; r + 8 <= r1; r += 8) {
          for (int g = 0; g < 8; g++) {
            const uint8_t* row = codes + (size_t)(r + g) * row_len;
            for (long long e = 0; e < e_max; e++) colbuf[e * 8 + g] = row[e];
          }
          host_hll_rows8_avx512(colbuf.data(), row_len, stride, hk, n_bits,
                                priv.data());
        }
      }
#endif
      for (; r < r1; r++) {
        const uint8_t* row = codes + r * row_len;
        const long long e_end = std::min(row_len, stride + k - 1);
        uint64_t fh = 0, rh = 0;
        long long runlen = 0;
        for (long long e = 0; e < e_end; e++) {
          const int c = row[e];
          const int out_c = (e >= k) ? row[e - k] : 4;
          fh = hsrol1(fh) ^ HSEED[c] ^ hk.rotk[out_c];
          rh = hsror1(rh ^ hk.rotk_comp[c] ^ HSEED[HCOMP[out_c]]);
          runlen = (c == 4) ? 0 : runlen + 1;
          if (e >= k - 1 && runlen >= k) {
            const uint64_t h = fh < rh ? fh : rh;
            const uint64_t masked = h & ~b_mask;
            const uint8_t run0 =
                masked ? (uint8_t)__builtin_clzll(masked) : (uint8_t)0;
            uint8_t& slot = priv[h & b_mask];
            if (run0 > slot) slot = run0;
          }
        }
      }
      // thread-private sketch + max-merge: the reference's OpenMP pattern
      // (nthll.cpp:218-245) — merge under no lock by letting only the
      // spawning thread fold results after join (below)
    });
  }
  for (auto& th : threads) th.join();
  for (uint64_t i = 0; i < n_buck; i++) {
    uint8_t m = regs[i];
    for (int t = 0; t < nt; t++)
      if (local[t][i] > m) m = local[t][i];
    regs[i] = m;
  }
}

// uint16-table variant of ntcard_hist_u16 (host-engine tables are uint16
// directly; avoids a 2x int32 blow-up of a GiB-scale table just to scan it).
void ntcard_hist_u16_direct(const uint16_t* table, long long n,
                            long long* out) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)std::min(16u, hw ? hw : 1u);
  long long chunk = (n + nt - 1) / nt;
  std::vector<std::vector<long long>> local(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      std::vector<long long>& h = local[t];
      h.assign(65536, 0);
      long long lo = t * chunk, hi = std::min(n, lo + chunk);
      for (long long i = lo; i < hi; i++) h[table[i]]++;
    });
  }
  for (auto& th : threads) th.join();
  for (int v = 0; v < 65536; v++) {
    long long s = 0;
    for (int t = 0; t < nt; t++) s += local[t][v];
    out[v] = s;
  }
}

}  // extern "C"
