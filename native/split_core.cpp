// Native split-stage driver: the whole of stage 1 in C++.
//
// Replicates freddie_jax/stages/split.py (itself a reimplementation of the
// reference's /root/reference/py/freddie_split.py) byte-for-byte:
//   - stream the coordinate-sorted BAM, decode records + CIGAR-walk each
//     alignment into exonic intervals (bam_io.h, py/freddie_split.py:133-207);
//   - batch reads into coarse loci by genomic overlap (:210-242);
//   - merge intervals into simple tints, group tints sharing reads,
//     apply the >=3-read filter and the oversize caps (:295-364);
//   - break oversized tints over the weight>=2 junction-support graph
//     (:244-293);
//   - write one split TSV per tint (:445-481) and route FASTQ/FASTA read
//     sequences into per-tint reads TSVs (:367-424).
//
// The Python stage remains the oracle twin: tests/test_native_split.py
// byte-compares whole output trees across configs. Everything here must
// stay bit-identical to stages/split.py -- any tie-break or ordering
// change is a parity break.
//
// Built into libbamdec.so together with bamdec.cpp (see
// freddie_jax/io/bam_native.py).

#include <errno.h>
#include <stdlib.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <time.h>

#include <algorithm>
#include <cctype>
#include <charconv>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "bam_io.h"

namespace {

using bamio::Iv;

struct Config {
  int max_del_size;
  bool consider_nonspliced;
  int min_reads_per_tint;
  int max_tint_intervals;
  int max_tint_reads;
  int64_t contig_min_size;
  int max_open_handles;
};

struct LocusRead {
  std::string name;
  char strand;
  int iv_start, iv_n;              // into Ctx.ivs / Ctx.cigtext
  std::vector<int> simple_tints;   // filled by build_tints
};

// rname -> tint routing entry (stages/split.py rname_to_tint).
struct Entry {
  int32_t contig_idx;
  int32_t rid;
  std::vector<int32_t> tint_ids;
};

struct TintT {
  std::vector<std::pair<int64_t, int64_t>> intervals;
  std::vector<int> rids;
};

struct Ctx {
  Config cfg;
  std::string outdir;
  std::vector<std::string> refs;
  // Current contig state.
  int32_t cur_ref = -1;
  int tint_id = 0;
  bool contig_dir_made = false;
  // Current locus state.
  std::vector<Iv> ivs;
  std::string cigtext;
  std::vector<LocusRead> reads;
  int64_t locus_end = 0;
  bool have_end = false;
  // Global state.
  std::unordered_map<std::string, Entry> rname;
  std::vector<std::pair<std::string, int>> counts;
  std::string err;
  double t_flush = 0.0;  // cumulative seconds in flush_locus (profiling)
  double t_emit = 0.0;   // cumulative seconds in emit_tint (profiling)
  bool prof = false;
};

void append_i64(std::string& s, int64_t v) {
  // std::to_chars: ~5x snprintf. This renders every integer field of
  // every TSV row (tens of millions of calls at 10M reads).
  char tmp[24];
  auto res = std::to_chars(tmp, tmp + sizeof tmp, v);
  s.append(tmp, res.ptr - tmp);
}

struct ProfTimer {
  double* acc;
  timespec a{};
  explicit ProfTimer(double* acc_) : acc(acc_) {
    if (acc) clock_gettime(CLOCK_MONOTONIC, &a);
  }
  ~ProfTimer() {
    if (!acc) return;
    timespec b{};
    clock_gettime(CLOCK_MONOTONIC, &b);
    *acc += (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
  }
};

// Emit one tint: write its TSV and record the rname routing.
// (stages/split.py split_contig + format_split_tsv.)
bool emit_tint(Ctx& c, const TintT& t) {
  ProfTimer pt(c.prof ? &c.t_emit : nullptr);
  const std::string& contig = c.refs[c.cur_ref];
  std::string cdir = c.outdir + "/" + contig;
  if (c.tint_id == 0) {
    // Python: os.makedirs(contig_outdir, exist_ok=False).
    if (mkdir(cdir.c_str(), 0777) != 0) {
      c.err = "cannot create " + cdir + ": " + strerror(errno);
      return false;
    }
    c.contig_dir_made = true;
  }
  std::string out;
  out.reserve(256 + 128 * t.rids.size());
  out += "#";
  out += contig;
  out += "\t";
  append_i64(out, c.tint_id);
  out += "\t";
  for (size_t i = 0; i < t.intervals.size(); ++i) {
    if (i) out += ",";
    append_i64(out, t.intervals[i].first);
    out += "-";
    append_i64(out, t.intervals[i].second);
  }
  out += "\t";
  append_i64(out, (int64_t)t.rids.size());
  for (int rid : t.rids) {
    const LocusRead& r = c.reads[rid];
    out += "\n";
    append_i64(out, rid);
    out += "\t";
    out += r.name;
    out += "\t";
    out += contig;
    out += "\t";
    out += r.strand;
    out += "\t";
    append_i64(out, c.tint_id);
    for (int j = r.iv_start; j < r.iv_start + r.iv_n; ++j) {
      const Iv& iv = c.ivs[j];
      out += "\t";
      append_i64(out, iv.ts);
      out += "-";
      append_i64(out, iv.te);
      out += ":";
      append_i64(out, iv.qs);
      out += "-";
      append_i64(out, iv.qe);
      out += ":";
      out.append(c.cigtext.data() + iv.cig_off, iv.cig_len);
    }
  }
  out += "\n";
  std::string path = cdir + "/split_" + contig + "_" + std::to_string(c.tint_id) + ".tsv";
  FILE* f = fopen(path.c_str(), "w");
  if (!f) {
    c.err = "cannot write " + path;
    return false;
  }
  fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  for (int rid : t.rids) {
    const LocusRead& r = c.reads[rid];
    auto it = c.rname.find(r.name);
    if (it == c.rname.end()) {
      it = c.rname.emplace(r.name, Entry{c.cur_ref, rid, {}}).first;
    } else if (it->second.contig_idx != c.cur_ref || it->second.rid != rid) {
      // Python asserts entry["contig"] == contig and entry["rid"] == rid.
      c.err = "read name " + r.name + " maps to multiple contigs/rids";
      return false;
    }
    it->second.tint_ids.push_back(c.tint_id);
  }
  ++c.tint_id;
  return true;
}

// stages/split.py break_oversized_tint: connected components of the
// weight>=2 junction-support graph over the tint's intervals.
bool break_oversized(Ctx& c, const TintT& tint, std::vector<TintT>& out) {
  const auto& intervals = tint.intervals;
  int n = (int)intervals.size();
  int64_t start = intervals[0].first;
  int64_t end = intervals.back().second;
  std::vector<int32_t> pos2iv(end - start, n);
  for (int i = 0; i < n; ++i)
    std::fill(pos2iv.begin() + (intervals[i].first - start),
              pos2iv.begin() + (intervals[i].second - start), i);
  std::vector<std::vector<int>> iv2rids(n);
  std::unordered_map<int, std::vector<int>> rid2ivs;
  std::map<std::pair<int, int>, int> ew;
  for (int rid : tint.rids) {
    const LocusRead& r = c.reads[rid];
    auto& rivs = rid2ivs[rid];
    for (int j = r.iv_start; j < r.iv_start + r.iv_n; ++j) {
      int v = pos2iv[c.ivs[j].ts - start];
      iv2rids[v].push_back(rid);
      rivs.push_back(v);
    }
    for (int j = r.iv_start; j + 1 < r.iv_start + r.iv_n; ++j) {
      int v1 = pos2iv[c.ivs[j].te - start - 1];
      int v2 = pos2iv[c.ivs[j + 1].ts - start];
      if (!(v1 <= v2 && v2 < n)) {
        c.err = "junction outside tint intervals";
        return false;
      }
      ++ew[{v1, v2}];
    }
  }
  std::vector<int> parent(n);
  for (int i = 0; i < n; ++i) parent[i] = i;
  auto find = [&parent](int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (const auto& kv : ew) {
    if (kv.second >= 2) {
      int ru = find(kv.first.first), rv = find(kv.first.second);
      if (ru != rv) parent[std::max(ru, rv)] = std::min(ru, rv);
    }
  }
  // Components in order of smallest member == first-seen root order when
  // scanning i ascending (matches the Python sort by min(comp)).
  std::unordered_map<int, int> root2comp;
  std::vector<std::vector<int>> comps;
  for (int i = 0; i < n; ++i) {
    int r = find(i);
    auto it = root2comp.find(r);
    if (it == root2comp.end()) {
      it = root2comp.emplace(r, (int)comps.size()).first;
      comps.emplace_back();
    }
    comps[it->second].push_back(i);
  }
  for (const auto& comp : comps) {
    std::set<int> c_rids;
    for (int i : comp) c_rids.insert(iv2rids[i].begin(), iv2rids[i].end());
    if ((int)c_rids.size() > 2) {
      std::set<int> used;
      for (int rid : c_rids) {
        const auto& rivs = rid2ivs[rid];
        used.insert(rivs.begin(), rivs.end());
      }
      TintT sub;
      sub.intervals.reserve(used.size());
      for (int i : used) sub.intervals.push_back(intervals[i]);
      sub.rids.assign(c_rids.begin(), c_rids.end());
      out.push_back(std::move(sub));
    }
  }
  return true;
}

// stages/split.py build_tints + emission for one locus batch.
bool flush_locus(Ctx& c) {
  ProfTimer pt(c.prof ? &c.t_flush : nullptr);
  if (c.reads.empty()) {
    c.have_end = false;
    return true;
  }
  // Triples (interval start, end, rid) in sorted order.
  struct Trip {
    int64_t s, e;
    int rid;
    bool operator<(const Trip& o) const {
      if (s != o.s) return s < o.s;
      if (e != o.e) return e < o.e;
      return rid < o.rid;
    }
  };
  std::vector<Trip> trips;
  for (int r = 0; r < (int)c.reads.size(); ++r)
    for (int j = c.reads[r].iv_start; j < c.reads[r].iv_start + c.reads[r].iv_n; ++j)
      trips.push_back(Trip{c.ivs[j].ts, c.ivs[j].te, r});
  std::sort(trips.begin(), trips.end());

  struct Simple {
    int64_t start, end;
    std::vector<int> rids;
  };
  std::vector<Simple> simple;
  int64_t start = 0, end = 0;
  bool first = true;
  std::vector<int> rids;
  for (const Trip& t : trips) {
    if (first) {
      start = t.s;
      end = t.e;
      first = false;
    }
    if (t.s > end) {
      simple.push_back(Simple{start, end, std::move(rids)});
      rids.clear();
      start = t.s;
      end = t.e;
    }
    end = std::max(end, t.e);
    rids.push_back(t.rid);
    c.reads[t.rid].simple_tints.push_back((int)simple.size());
  }
  if (first) {
    c.have_end = false;
    return true;
  }
  simple.push_back(Simple{start, end, std::move(rids)});

  // Group simple tints sharing reads (iterative DFS, same components as
  // the reference's BFS at py/freddie_split.py:325-353).
  std::vector<char> enq(simple.size(), 0);
  std::vector<TintT> tints;
  std::vector<int> stack, group;
  for (int idx = 0; idx < (int)simple.size(); ++idx) {
    if (enq[idx]) continue;
    group.clear();
    stack.assign(1, idx);
    enq[idx] = 1;
    while (!stack.empty()) {
      int t = stack.back();
      stack.pop_back();
      group.push_back(t);
      for (int rid : simple[t].rids)
        for (int i : c.reads[rid].simple_tints)
          if (!enq[i]) {
            enq[i] = 1;
            stack.push_back(i);
          }
    }
    std::set<int> grp_rids;
    std::vector<std::pair<int64_t, int64_t>> grp_ivs;
    for (int t : group) {
      grp_rids.insert(simple[t].rids.begin(), simple[t].rids.end());
      grp_ivs.emplace_back(simple[t].start, simple[t].end);
    }
    if ((int)grp_rids.size() < c.cfg.min_reads_per_tint) continue;
    std::sort(grp_ivs.begin(), grp_ivs.end());
    TintT t;
    t.intervals = std::move(grp_ivs);
    t.rids.assign(grp_rids.begin(), grp_rids.end());
    tints.push_back(std::move(t));
  }

  for (const TintT& t : tints) {
    if ((int)t.intervals.size() < c.cfg.max_tint_intervals &&
        (int)t.rids.size() < c.cfg.max_tint_reads) {
      if (!emit_tint(c, t)) return false;
    } else {
      std::vector<TintT> subs;
      if (!break_oversized(c, t, subs)) return false;
      for (const TintT& s : subs)
        if (!emit_tint(c, s)) return false;
    }
  }
  // Reset locus state.
  c.ivs.clear();
  c.cigtext.clear();
  c.reads.clear();
  c.have_end = false;
  return true;
}

bool end_contig(Ctx& c) {
  if (c.cur_ref < 0) return true;
  if (!flush_locus(c)) return false;
  if (c.tint_id > 0) c.counts.emplace_back(c.refs[c.cur_ref], c.tint_id);
  c.tint_id = 0;
  c.contig_dir_made = false;
  return true;
}

// ---- FASTQ/FASTA routing (stages/split.py distribute_read_sequences) ----

// Buffered line reader over gzFile (zlib reads plain files transparently).
// Lines are returned as VIEWS into the internal buffer (valid until the
// next call): the 17.6 GB FASTQ of a 10M-read corpus is never copied
// line-by-line into std::strings, and the '+'/quality lines the router
// ignores cost only the memchr scan.
struct LineReader {
  gzFile f = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;

  explicit LineReader(const char* path) : buf(1 << 20) { f = gzopen(path, "rb"); }
  ~LineReader() {
    if (f) gzclose(f);
  }
  bool fill() {
    if (eof) return false;
    int got = gzread(f, buf.data() + len, (unsigned)(buf.size() - len));
    if (got <= 0) {
      eof = true;
      return false;
    }
    len += got;
    return true;
  }
  // Next line without the trailing '\n', as a view valid until the next
  // call; false at EOF. A line spanning the buffer end is compacted to
  // the front first (the buffer doubles if a line exceeds it).
  bool next_view(const char*& p, size_t& n) {
    for (;;) {
      const char* nl = (const char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        p = buf.data() + pos;
        n = (size_t)(nl - p);
        pos = (size_t)(nl - buf.data()) + 1;
        return true;
      }
      // Partial line at the end: move it to the front and read more.
      if (pos > 0) {
        memmove(buf.data(), buf.data() + pos, len - pos);
        len -= pos;
        pos = 0;
      } else if (len == buf.size()) {
        buf.resize(buf.size() * 2);
      }
      if (!fill()) {
        if (len == 0) return false;
        p = buf.data();
        n = len;  // final line without trailing newline
        pos = len = 0;
        return true;
      }
    }
  }
};

// LRU-capped per-(contig,tint) output handles, mirroring the Python
// max_open_handles logic (evicted files reopen in append mode).
struct OutPool {
  const Ctx& c;
  size_t cap;
  std::list<std::pair<uint64_t, FILE*>> lru;  // back = most recent
  std::unordered_map<uint64_t, std::list<std::pair<uint64_t, FILE*>>::iterator> open;
  std::set<uint64_t> seen;

  OutPool(const Ctx& ctx, size_t cap_) : c(ctx), cap(cap_) {}
  ~OutPool() {
    for (auto& kv : lru) fclose(kv.second);
  }
  FILE* get(int32_t contig_idx, int32_t tint_id, std::string& err) {
    uint64_t key = ((uint64_t)(uint32_t)contig_idx << 32) | (uint32_t)tint_id;
    auto it = open.find(key);
    if (it != open.end()) {
      lru.splice(lru.end(), lru, it->second);
      return it->second->second;
    }
    if (lru.size() >= cap) {
      fclose(lru.front().second);
      open.erase(lru.front().first);
      lru.pop_front();
    }
    const std::string& contig = c.refs[contig_idx];
    std::string path = c.outdir + "/" + contig + "/reads_" + contig + "_" +
                       std::to_string(tint_id) + ".tsv";
    bool append = seen.count(key) > 0;
    FILE* f = fopen(path.c_str(), append ? "a" : "w");
    if (!f) {
      err = "cannot write " + path;
      return nullptr;
    }
    seen.insert(key);
    lru.emplace_back(key, f);
    open[key] = std::prev(lru.end());
    return f;
  }
};

bool distribute_sequences(Ctx& c, const std::vector<std::string>& files) {
  OutPool pool(c, (size_t)c.cfg.max_open_handles);
  std::string name, row;
  const char* lp = nullptr;
  size_t ln = 0;
  for (const std::string& path : files) {
    LineReader lr(path.c_str());
    if (!lr.f) {
      c.err = "cannot open " + path;
      return false;
    }
    int mod = 0;
    long long idx = 0;
    const Entry* ent = nullptr;  // current record's routing (null = skip)
    while (lr.next_view(lp, ln)) {
      if (idx == 0) {
        if (ln > 0 && lp[0] == '@')
          mod = 4;
        else if (ln > 0 && lp[0] == '>')
          mod = 2;
        else {
          c.err = "Invalid fasta/q file " + path;
          return false;
        }
      }
      long long m = idx % mod;
      if (m == 0) {
        // rstrip + first whitespace-token minus the leading '@'/'>'.
        size_t e = ln;
        while (e > 0 && isspace((unsigned char)lp[e - 1])) --e;
        size_t tok = 0;
        while (tok < e && !isspace((unsigned char)lp[tok])) ++tok;
        name.assign(lp + 1, tok >= 1 ? tok - 1 : 0);
        // One lookup per record; the sequence line uses the cached entry
        // (and '+'/quality lines cost nothing but the newline scan). The
        // pointer stays valid: c.rname is not mutated during this pass.
        auto it = c.rname.find(name);
        ent = (it == c.rname.end()) ? nullptr : &it->second;
      } else if (m == 1 && ent != nullptr) {
        size_t e = ln;
        while (e > 0 && isspace((unsigned char)lp[e - 1])) --e;
        for (int32_t tid : ent->tint_ids) {
          FILE* f = pool.get(ent->contig_idx, tid, c.err);
          if (!f) return false;
          row.clear();
          append_i64(row, ent->rid);
          row += "\t";
          row += c.refs[ent->contig_idx];
          row += "\t";
          append_i64(row, tid);
          row += "\t";
          row.append(lp, e);
          row += "\n";
          fwrite(row.data(), 1, row.size(), f);
        }
      }
      ++idx;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Full split stage. Returns the number of contigs with >=1 tint (also the
// number of lines written to counts_out as "contig\tn\n"), or a negative
// error code with err filled:
//   -1 I/O or format error; -3 CIGAR/query mismatch (the reference
//   asserts); -4 a read produced no alignment intervals (the reference
//   would fail the same way); -5 output buffer too small.
long long splitc_run(const char* bam_path, const char* fastq_paths,
                     const char* outdir, int max_del_size,
                     int consider_nonspliced, int min_reads_per_tint,
                     int max_tint_intervals, int max_tint_reads,
                     long long contig_min_size, int max_open_handles,
                     char* counts_out, long long counts_cap, char* err,
                     int errlen) {
  timespec t_start{};
  clock_gettime(CLOCK_MONOTONIC, &t_start);
  const bool prof = getenv("FREDDIE_SPLIT_PROF") != nullptr;
  Ctx c;
  c.prof = prof;
  c.cfg = Config{max_del_size,      consider_nonspliced != 0,
                 min_reads_per_tint, max_tint_intervals,
                 max_tint_reads,     contig_min_size,
                 max_open_handles};
  c.outdir = outdir;
  auto fail = [&](const std::string& msg, long long code) {
    snprintf(err, errlen, "%s", msg.c_str());
    return code;
  };

  bamio::Handle h;
  h.prof = prof;
  h.f = fopen(bam_path, "rb");
  if (!h.f) return fail(std::string("cannot open ") + bam_path, -1);
  if (!bamio::parse_header(h)) {
    fclose(h.f);
    return fail(h.err, -1);
  }
  // Background BGZF inflate from here on: the decode thread stays ahead
  // of the record loop, hiding inflate under tint building/writing.
  bamio::start_prefetch(h);
  std::vector<char> keep(h.refs.size(), 0);
  bool any = false;
  for (size_t i = 0; i < h.refs.size(); ++i) {
    c.refs.push_back(h.refs[i].name);
    if (h.refs[i].len > contig_min_size) {
      keep[i] = 1;
      any = true;
    }
  }
  if (!any) {
    fclose(h.f);
    return fail("No contigs left! Check BAM header or contig_min_size", -1);
  }

  std::vector<Iv> scratch;
  std::string sctext;
  std::string name;
  long long rc = 0;
  for (;;) {
    if (!bamio::ensure(h, 4)) {
      if (h.eof) break;
      rc = fail("truncated BAM: " + h.err, -1);
      break;
    }
    int32_t block_size = bamio::rd<int32_t>(h);
    if (!bamio::ensure(h, block_size)) {
      rc = fail("truncated BAM record", -1);
      break;
    }
    size_t rec_end = h.pos + block_size;
    int32_t rid = bamio::rd<int32_t>(h);
    int64_t rpos = bamio::rd<int32_t>(h);
    uint8_t l_read_name = bamio::rd<uint8_t>(h);
    h.pos += 3;  // mapq + bin
    uint16_t n_cigar = bamio::rd<uint16_t>(h);
    uint16_t fl = bamio::rd<uint16_t>(h);
    int32_t l_seq = bamio::rd<int32_t>(h);
    h.pos += 12;  // next_refID, next_pos, tlen
    // Unmapped records never end a contig run (stages/split.py
    // contig_runs skips them at both levels).
    if ((fl & 4) != 0 || rid < 0 || rid >= (int32_t)c.refs.size()) {
      h.pos = rec_end;
      continue;
    }
    if (rid != c.cur_ref) {
      if (!end_contig(c)) {
        rc = -1;
        break;
      }
      c.cur_ref = rid;
    }
    // Contig too small, or secondary/supplementary: skip the record.
    if (!keep[rid] || (fl & (256 | 2048)) != 0 || n_cigar == 0) {
      h.pos = rec_end;
      continue;
    }
    name.assign((const char*)h.buf.data() + h.pos, l_read_name - 1);
    h.pos += l_read_name;
    const uint8_t* cig = h.buf.data() + h.pos;
    scratch.clear();
    sctext.clear();
    if (bamio::walk_intervals(cig, n_cigar, rpos, l_seq, max_del_size, scratch,
                              sctext) != 0) {
      rc = fail("CIGAR/query length mismatch in BAM record " + name, -3);
      break;
    }
    h.pos = rec_end;  // skip seq + qual + tags
    if (!consider_nonspliced && scratch.size() == 1) continue;
    if (scratch.empty()) {
      rc = fail("read " + name + " has no alignment intervals", -4);
      break;
    }
    int64_t s = scratch.front().ts, e = scratch.back().te;
    if (c.have_end && s > c.locus_end) {
      if (!flush_locus(c)) {
        rc = -1;
        break;
      }
    }
    if (!c.have_end) {
      c.locus_end = e;
      c.have_end = true;
    }
    c.locus_end = std::max(c.locus_end, e);
    LocusRead r;
    r.name = std::move(name);
    r.strand = (fl & 16) ? '-' : '+';
    r.iv_start = (int)c.ivs.size();
    r.iv_n = (int)scratch.size();
    int64_t base = (int64_t)c.cigtext.size();
    for (Iv& iv : scratch) {
      iv.cig_off += base;
      c.ivs.push_back(iv);
    }
    c.cigtext += sctext;
    c.reads.push_back(std::move(r));
    name.clear();
  }
  h.pf.reset();  // join the prefetch thread BEFORE closing its FILE*
  fclose(h.f);
  if (rc < 0) {
    if (c.err.size()) snprintf(err, errlen, "%s", c.err.c_str());
    return rc;
  }
  if (!end_contig(c)) return fail(c.err, -1);

  // Optional phase attribution (FREDDIE_SPLIT_PROF=1 -> stderr).
  timespec t_bam{};
  if (prof) clock_gettime(CLOCK_MONOTONIC, &t_bam);

  // FASTQ/FASTA routing pass.
  std::vector<std::string> files;
  {
    const char* p = fastq_paths;
    while (*p) {
      const char* q = strchr(p, ';');
      if (!q) q = p + strlen(p);
      files.emplace_back(p, q - p);
      p = (*q) ? q + 1 : q;
    }
  }
  if (!distribute_sequences(c, files)) return fail(c.err, -1);
  if (prof) {
    timespec t_end{};
    clock_gettime(CLOCK_MONOTONIC, &t_end);
    auto secs = [](const timespec& a, const timespec& b) {
      return (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
    };
    fprintf(stderr,
            "[splitc] bam_pass=%.2fs (inflate=%.2fs flush=%.2fs "
            "emit=%.2fs) fastq_pass=%.2fs\n",
            secs(t_start, t_bam), h.t_inflate, c.t_flush, c.t_emit,
            secs(t_bam, t_end));
  }

  // Counts out.
  std::string counts;
  for (const auto& kv : c.counts) {
    counts += kv.first;
    counts += "\t";
    append_i64(counts, kv.second);
    counts += "\n";
  }
  if ((long long)counts.size() + 1 > counts_cap)
    return fail("counts buffer too small", -5);
  memcpy(counts_out, counts.data(), counts.size());
  counts_out[counts.size()] = 0;
  return (long long)c.counts.size();
}

}  // extern "C"
