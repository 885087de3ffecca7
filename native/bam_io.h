// Shared BGZF/BAM decode core + per-alignment CIGAR walk.
//
// Used by both the generic batch decoder (bamdec.cpp) and the native
// split-stage driver (split_core.cpp). The reference delegates this layer
// to pysam/htslib (py/freddie_split.py:12,210-242); here it is a small
// self-contained zlib-based reader.
//
// Header-only so both translation units compile into one libbamdec.so.

#pragma once

#include <time.h>
#include <zlib.h>

#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace bamio {

inline const char SEQ_NIBBLE[17] = "=ACMGRSVTWYHKDBN";

struct Ref {
  std::string name;
  int64_t len;
};

// Single-producer prefetch pipeline: a background thread reads + inflates
// BGZF members ahead of the consumer, bounded by MAX_AHEAD bytes. Blocks
// are strictly ordered (one producer), so the decompressed stream is
// byte-identical to the sequential path.
struct Prefetcher {
  static constexpr size_t MAX_AHEAD = 64u << 20;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv_data, cv_space;
  std::deque<std::vector<uint8_t>> q;
  size_t q_bytes = 0;
  bool done = false;      // producer finished (EOF or error)
  bool stop = false;      // consumer asked the producer to quit
  std::string err;        // producer error ('' = clean EOF)
  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_space.notify_all();
    if (th.joinable()) th.join();
  }
};

struct Handle {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;  // decompressed bytes not yet consumed
  size_t pos = 0;            // read cursor in buf
  std::vector<Ref> refs;
  bool eof = false;
  std::string err;
  double t_inflate = 0.0;  // cumulative seconds in read_block (profiling)
  bool prof = false;
  std::unique_ptr<Prefetcher> pf;
};

// Read + inflate one BGZF member from f into payload (resized).
// Returns 1 on success, 0 at EOF, -1 on error (err set).
inline int read_block_payload(FILE* f, std::vector<uint8_t>& payload,
                              std::string& err) {
  uint8_t hdr[12];
  size_t got = fread(hdr, 1, 12, f);
  if (got == 0) return 0;
  if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8) {
    err = "bad BGZF header"; return -1;
  }
  uint16_t xlen; memcpy(&xlen, hdr + 10, 2);
  std::vector<uint8_t> extra(xlen);
  if (fread(extra.data(), 1, xlen, f) != xlen) { err = "truncated extra"; return -1; }
  int bsize = -1;
  for (size_t off = 0; off + 4 <= extra.size();) {
    uint8_t si1 = extra[off], si2 = extra[off + 1];
    uint16_t slen; memcpy(&slen, extra.data() + off + 2, 2);
    if (si1 == 66 && si2 == 67 && slen == 2) {
      uint16_t v; memcpy(&v, extra.data() + off + 4, 2); bsize = v;
    }
    off += 4 + slen;
  }
  if (bsize < 0) { err = "missing BC subfield"; return -1; }
  int cdata_len = bsize + 1 - 12 - xlen - 8;
  std::vector<uint8_t> cdata(cdata_len);
  if ((int)fread(cdata.data(), 1, cdata_len, f) != cdata_len) {
    err = "truncated block"; return -1;
  }
  uint8_t tail[8];
  if (fread(tail, 1, 8, f) != 8) { err = "truncated footer"; return -1; }
  uint32_t isize; memcpy(&isize, tail + 4, 4);
  payload.resize(isize);
  if (isize) {
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = cdata.data();
    zs.avail_in = cdata_len;
    zs.next_out = payload.data();
    zs.avail_out = isize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) { err = "inflate failed"; return -1; }
  }
  return 1;
}

// Start background block prefetch on h (call after parse_header; any bytes
// already in h.buf stay valid -- the producer simply continues from the
// current file offset). Disabled by FREDDIE_BGZF_PREFETCH=0.
inline void start_prefetch(Handle& h) {
  const char* env = getenv("FREDDIE_BGZF_PREFETCH");
  if (env && env[0] == '0') return;
  if (h.pf || !h.f) return;
  h.pf.reset(new Prefetcher());
  Prefetcher* pf = h.pf.get();
  FILE* f = h.f;
  pf->th = std::thread([pf, f]() {
    std::string err;
    for (;;) {
      std::vector<uint8_t> payload;
      int rc = read_block_payload(f, payload, err);
      std::unique_lock<std::mutex> lk(pf->mu);
      if (rc <= 0) {
        pf->err = (rc < 0) ? err : "";
        pf->done = true;
        lk.unlock();
        pf->cv_data.notify_all();
        return;
      }
      pf->cv_space.wait(lk, [pf] {
        return pf->stop || pf->q_bytes < Prefetcher::MAX_AHEAD;
      });
      if (pf->stop) return;
      pf->q_bytes += payload.size();
      pf->q.push_back(std::move(payload));
      lk.unlock();
      pf->cv_data.notify_all();
    }
  });
}

// Read one BGZF member; append payload to h.buf. False at EOF or error.
inline bool read_block(Handle& h) {
  timespec a{};
  if (h.prof) clock_gettime(CLOCK_MONOTONIC, &a);
  if (h.pf) {
    Prefetcher* pf = h.pf.get();
    std::vector<uint8_t> payload;
    {
      std::unique_lock<std::mutex> lk(pf->mu);
      pf->cv_data.wait(lk, [pf] { return pf->done || !pf->q.empty(); });
      if (pf->q.empty()) {
        if (pf->err.empty()) h.eof = true;
        else h.err = pf->err;
        return false;
      }
      payload = std::move(pf->q.front());
      pf->q.pop_front();
      pf->q_bytes -= payload.size();
    }
    pf->cv_space.notify_all();
    h.buf.insert(h.buf.end(), payload.begin(), payload.end());
  } else {
    std::vector<uint8_t> payload;
    int rc = read_block_payload(h.f, payload, h.err);
    if (rc == 0) { h.eof = true; return false; }
    if (rc < 0) return false;
    h.buf.insert(h.buf.end(), payload.begin(), payload.end());
  }
  if (h.prof) {
    timespec b{};
    clock_gettime(CLOCK_MONOTONIC, &b);
    h.t_inflate += (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
  }
  return true;
}

// Ensure at least n bytes are available at h.pos; compact as needed.
inline bool ensure(Handle& h, size_t n) {
  while (h.buf.size() - h.pos < n) {
    if (h.pos > (1u << 20)) {  // compact
      h.buf.erase(h.buf.begin(), h.buf.begin() + h.pos);
      h.pos = 0;
    }
    if (!read_block(h)) return false;
  }
  return true;
}

template <typename T>
inline T rd(Handle& h) {
  T v;
  memcpy(&v, h.buf.data() + h.pos, sizeof(T));
  h.pos += sizeof(T);
  return v;
}

// Parse "BAM\1" magic + text header + reference list into h.refs.
// False with h.err set on malformed input.
inline bool parse_header(Handle& h) {
  if (!ensure(h, 8)) { h.err = "truncated BAM: " + h.err; return false; }
  if (memcmp(h.buf.data(), "BAM\x01", 4) != 0) { h.err = "not a BAM file"; return false; }
  h.pos = 4;
  int32_t l_text = rd<int32_t>(h);
  if (!ensure(h, l_text + 4)) { h.err = "truncated header"; return false; }
  h.pos += l_text;
  int32_t n_ref = rd<int32_t>(h);
  for (int i = 0; i < n_ref; ++i) {
    if (!ensure(h, 4)) { h.err = "truncated refs"; return false; }
    int32_t l_name = rd<int32_t>(h);
    if (!ensure(h, l_name + 4)) { h.err = "truncated refs"; return false; }
    std::string name((const char*)h.buf.data() + h.pos, l_name - 1);
    h.pos += l_name;
    int32_t l_ref = rd<int32_t>(h);
    h.refs.push_back(Ref{name, l_ref});
  }
  return true;
}

// One exonic alignment interval produced by the CIGAR walk; cig_off/len
// index into the caller's cigar-text scratch string.
struct Iv {
  int64_t ts, te, qs, qe;
  int64_t cig_off;
  int32_t cig_len;
};

// The per-alignment CIGAR walk (the reference's get_intervals,
// py/freddie_split.py:133-207; mirrored by freddie_jax/core/cigar.py):
// deletions longer than max_del_size become introns (D -> N), each maximal
// run between introns yields one exonic interval with its exon-consuming
// ops rendered as text, and empty (target- or query-empty) intervals are
// dropped. Appends to `out` and `cigtext` (offsets are absolute into
// cigtext). Returns 0 on success, -3 on a CIGAR/query-length mismatch or
// an empty query span (the reference asserts both).
inline int walk_intervals(const uint8_t* cig, uint16_t n_cigar, int64_t rpos,
                          int64_t l_seq, int max_del_size,
                          std::vector<Iv>& out, std::string& cigtext) {
  static const char OPS[] = "MIDNSHP=XB";
  int64_t qlen = 0;
  for (uint16_t i = 0; i < n_cigar; ++i) {
    uint32_t v; memcpy(&v, cig + 4ull * i, 4);
    uint32_t op = v & 0xF, c = v >> 4;
    if (op == 1 || op == 4 || op == 0 || op == 7 || op == 8) qlen += c;
  }
  if (qlen != l_seq) return -3;
  uint32_t v0, vlast;
  memcpy(&v0, cig, 4);
  memcpy(&vlast, cig + 4ull * (n_cigar - 1), 4);
  int64_t qstart = ((v0 & 0xF) == 4) ? (v0 >> 4) : 0;
  int64_t qend = qlen - (((vlast & 0xF) == 4) ? (int64_t)(vlast >> 4) : 0);
  if (qend <= qstart) return -3;  // the reference asserts this too
  int64_t q_lo = qstart, q_hi = qstart;
  int64_t t_lo = rpos, t_hi = rpos;
  int64_t cig_start = (int64_t)cigtext.size();
  auto close_interval = [&]() {
    if (t_lo != t_hi && q_lo != q_hi) {
      out.push_back(Iv{t_lo, t_hi, q_lo, q_hi, cig_start,
                       (int32_t)((int64_t)cigtext.size() - cig_start)});
    } else {
      cigtext.resize(cig_start);  // drop the rendered ops of an empty interval
    }
    cig_start = (int64_t)cigtext.size();
  };
  char tmp[16];
  for (uint16_t i = 0; i < n_cigar; ++i) {
    uint32_t v; memcpy(&v, cig + 4ull * i, 4);
    uint32_t op = v & 0xF;
    uint32_t c = v >> 4;
    if (op == 2 && (int)c > max_del_size) op = 3;  // D -> N rewrite
    if (op == 1 || op == 2 || op == 0 || op == 7 || op == 8) {
      // to_chars instead of snprintf: one call per exon-consuming cigar
      // op of every read -- tens of millions at 10M reads.
      auto res = std::to_chars(tmp, tmp + sizeof tmp - 1, c);
      *res.ptr = OPS[op];
      cigtext.append(tmp, res.ptr + 1 - tmp);
    }
    if (op == 2) {
      t_hi += c;
    } else if (op == 1) {
      q_hi += c;
    } else if (op == 0 || op == 7 || op == 8) {
      t_hi += c;
      q_hi += c;
    }
    if (op == 3) {
      close_interval();
      t_hi += c;
      t_lo = t_hi;
      q_lo = q_hi;
    }
  }
  if (t_lo < t_hi) close_interval();
  return 0;
}

}  // namespace bamio
