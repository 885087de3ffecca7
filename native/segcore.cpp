/* CPython extension: consolidated native host engine for the segment stage.
 *
 * One loaded tint handle carries everything the stage's host phases need,
 * so the hot path makes three C calls per tint instead of ~5 Python-level
 * passes over per-read objects:
 *
 *   load(split_path, reads_path, consider_ends)
 *     -> (capsule, chrom, tint_id, intervals, n_reads, n_reps,
 *         weights_bytes(int64), [y_raw bytes(float64) per tint interval])
 *     Parses the split TSV + reads TSV (same grammar and assertions as
 *     freddie_jax/io/tsv.py:parse_split_tsv / load_read_sequences, wire
 *     format /root/reference/py/freddie_split.py:445-481), groups read
 *     representatives (py/freddie_segment.py:163-170), and accumulates the
 *     multiplicity-weighted splice signal per tint interval
 *     (py/freddie_segment.py:648-678). Signal values are integer counts,
 *     so the C int64 accumulation equals numpy's float64 bincount exactly.
 *
 *   coverage(capsule, iv_idx, cands_list) -> bytes(int64, (P+1)*n_reps)
 *     Cumulative coverage rows at candidate breakpoints -- the exact
 *     integer semantics of freddie_jax/ops/coverage.py:cumulative_coverage
 *     (reference: py/freddie_segment.py:188-246).
 *
 *   finalize(capsule, final_ys, lookup_bytes, scale) -> TSV bytes
 *     Genotypes every segment per read-rep with the scaled-integer
 *     threshold comparisons (ops/thresholds.py; py/freddie_segment.py:
 *     808-830 incl. the appended 0 column between tint intervals and the
 *     popped trailing column), annotates every read's polyA/gap tokens
 *     (the native/polyatok.c semantics: py/freddie_segment.py:289-472),
 *     and formats the whole segment TSV byte-identically to
 *     freddie_jax/io/tsv.py:format_segment_tsv.
 *
 * The Python implementations remain the semantic oracles and transparent
 * fallbacks; tests/test_segcore.py compares whole-stage outputs
 * byte-for-byte. Any C-side assertion failure raises AssertionError and
 * the driver falls back to the Python path for that tint, so acceptance
 * never depends on the toolchain.
 *
 * Build: g++ -O2 -shared -fPIC -I<python-include> -o segcore.so segcore.cpp
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

/* CIGAR op codes follow io.bam: M=0 I=1 D=2 N=3 S=4 H=5 P=6 ==7 X=8. */
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_EQ = 7, OP_X = 8;

struct CigarOp {
  int op;
  long long len;
};

struct RInterval {
  long long ts, te, qs, qe;
  std::vector<CigarOp> cigar;
};

struct Read {
  long long id;
  std::string name, chrom, strand;
  long long tint;
  std::vector<RInterval> ivs;
  std::string seq;
  int rep = -1;
};

struct IvRows {  // rep intervals mapped into one tint interval (y-space)
  std::vector<long long> ys, ye;
  std::vector<int> rep;
};

struct Tint {
  std::string chrom;
  long long id = -1;
  long long read_count = -1;
  std::vector<std::pair<long long, long long>> intervals;
  std::vector<Read> reads;
  std::vector<std::vector<int>> rep_members;  // rep -> read idxs (file order)
  std::vector<long long> weights;             // per-rep multiplicity
  std::vector<IvRows> per_iv;
  std::vector<std::vector<long long>> y_raw;  // integer counts per interval
};

struct ParseError {
  const char* type;  // "assert" | "value" | "os"
  std::string msg;
};

long long parse_ll(const char** p, const char* end) {
  const char* s = *p;
  if (s >= end || *s < '0' || *s > '9') return -1;
  long long v = 0;
  while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  *p = s;
  return v;
}

std::vector<char> read_file(const char* path, ParseError& err) {
  FILE* f = fopen(path, "rb");
  std::vector<char> buf;
  if (!f) {
    err = {"os", std::string("cannot open ") + path};
    return buf;
  }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize((size_t)fsize + 1);
  if (fsize > 0 && fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    err = {"os", "short read"};
    buf.clear();
    return buf;
  }
  fclose(f);
  buf[(size_t)fsize] = '\n'; /* sentinel */
  return buf;
}

/* --------------------------------------------------------------- parsing */

bool parse_split(const char* path, Tint& t, ParseError& err) {
  std::vector<char> buf = read_file(path, err);
  if (buf.empty() && !err.msg.empty()) return false;
  const char* p = buf.data();
  const char* bend = buf.data() + buf.size() - 1;

  bool have_header = false;
  // rep grouping: key = raw bytes of the (ts, te) pairs
  std::unordered_map<std::string, int> rep_of;

  while (p < bend) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(bend - p + 1));
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue;

    if (*line == '#') {
      if (have_header) {
        err = {"assert", "multiple tints in one split file"};
        return false;
      }
      have_header = true;
      const char* t1 = (const char*)memchr(line, '\t', (size_t)(lend - line));
      if (!t1) { err = {"value", "header: missing fields"}; return false; }
      t.chrom.assign(line + 1, (size_t)(t1 - line - 1));
      const char* q = t1 + 1;
      t.id = parse_ll(&q, lend);
      if (t.id < 0 || q >= lend || *q != '\t') {
        err = {"value", "header: bad tint id"};
        return false;
      }
      ++q;
      long long prev_e = -1;
      while (true) {
        long long s = parse_ll(&q, lend);
        if (s < 0 || q >= lend || *q != '-') {
          err = {"value", "header: bad interval"};
          return false;
        }
        ++q;
        long long e = parse_ll(&q, lend);
        if (e < 0) { err = {"value", "header: bad interval"}; return false; }
        if (!(s < e)) { err = {"assert", "header: interval start >= end"}; return false; }
        if (prev_e >= 0 && !(prev_e < s)) {
          err = {"assert", "header: intervals not sorted"};
          return false;
        }
        prev_e = e;
        t.intervals.emplace_back(s, e);
        if (q < lend && *q == ',') { ++q; continue; }
        break;
      }
      if (q >= lend || *q != '\t') { err = {"value", "header: missing read count"}; return false; }
      ++q;
      t.read_count = parse_ll(&q, lend);
      if (t.read_count < 0 || q != lend) {
        err = {"value", "header: bad read count"};
        return false;
      }
      continue;
    }

    /* read row: rid \t name \t chrom \t strand \t tint \t ivfield... */
    Read rd;
    const char* q = line;
    rd.id = parse_ll(&q, lend);
    if (rd.id < 0 || q >= lend || *q != '\t') { err = {"value", "row: bad rid"}; return false; }
    ++q;
    const char* tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err = {"value", "row: missing name end"}; return false; }
    rd.name.assign(q, (size_t)(tb - q));
    q = tb + 1;
    tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err = {"value", "row: missing chrom end"}; return false; }
    rd.chrom.assign(q, (size_t)(tb - q));
    q = tb + 1;
    tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err = {"value", "row: missing strand end"}; return false; }
    rd.strand.assign(q, (size_t)(tb - q));
    q = tb + 1;
    rd.tint = parse_ll(&q, lend);
    if (rd.tint < 0 || q >= lend || *q != '\t') { err = {"value", "row: bad tint"}; return false; }
    ++q;
    std::string key;
    long long prev_te = -1, prev_qe = -1;
    while (q <= lend) {
      const char* fend = (const char*)memchr(q, '\t', (size_t)(lend - q));
      if (!fend) fend = lend;
      RInterval iv;
      iv.ts = parse_ll(&q, fend);
      if (iv.ts < 0 || q >= fend || *q != '-') { err = {"value", "row: bad interval field"}; return false; }
      ++q;
      iv.te = parse_ll(&q, fend);
      if (iv.te < 0 || q >= fend || *q != ':') { err = {"value", "row: bad interval field"}; return false; }
      ++q;
      iv.qs = parse_ll(&q, fend);
      if (iv.qs < 0 || q >= fend || *q != '-') { err = {"value", "row: bad interval field"}; return false; }
      ++q;
      iv.qe = parse_ll(&q, fend);
      if (iv.qe < 0 || q >= fend || *q != ':') { err = {"value", "row: bad interval field"}; return false; }
      ++q;
      while (q < fend) {
        long long n = parse_ll(&q, fend);
        if (n < 0 || q >= fend) { err = {"value", "row: bad cigar"}; return false; }
        int op;
        switch (*q) { /* io.bam CIGAR_OPS = "MIDNSHP=X" */
          case 'M': op = 0; break;
          case 'I': op = 1; break;
          case 'D': op = 2; break;
          case 'N': op = 3; break;
          case 'S': op = 4; break;
          case 'H': op = 5; break;
          case 'P': op = 6; break;
          case '=': op = 7; break;
          case 'X': op = 8; break;
          default: err = {"value", "row: bad cigar op"}; return false;
        }
        ++q;
        iv.cigar.push_back({op, n});
      }
      if (!(iv.ts < iv.te && iv.qs < iv.qe)) { err = {"assert", "row: empty interval"}; return false; }
      if (prev_te >= 0 && !(prev_te <= iv.ts && prev_qe <= iv.qs)) {
        err = {"assert", "row: intervals not sorted"};
        return false;
      }
      prev_te = iv.te;
      prev_qe = iv.qe;
      long long pair[2] = {iv.ts, iv.te};
      key.append((const char*)pair, sizeof(pair));
      rd.ivs.push_back(std::move(iv));
      if (fend == lend) break;
      q = fend + 1;
    }
    int ridx = (int)t.reads.size();
    auto it = rep_of.find(key);
    if (it == rep_of.end()) {
      int rep = (int)t.rep_members.size();
      rep_of.emplace(std::move(key), rep);
      t.rep_members.emplace_back();
      t.rep_members.back().push_back(ridx);
      rd.rep = rep;
    } else {
      t.rep_members[(size_t)it->second].push_back(ridx);
      rd.rep = it->second;
    }
    t.reads.push_back(std::move(rd));
  }
  if (!have_header) { err = {"assert", "no tint header"}; return false; }
  if ((long long)t.reads.size() != t.read_count) {
    err = {"assert", "read count mismatch"};
    return false;
  }
  t.weights.resize(t.rep_members.size());
  for (size_t r = 0; r < t.rep_members.size(); ++r)
    t.weights[r] = (long long)t.rep_members[r].size();
  return true;
}

bool load_seqs(const char* path, Tint& t, ParseError& err) {
  std::vector<char> buf = read_file(path, err);
  if (buf.empty() && !err.msg.empty()) return false;
  const char* p = buf.data();
  const char* bend = buf.data() + buf.size() - 1;
  std::unordered_map<long long, std::pair<const char*, size_t>> seqs;
  while (p < bend) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(bend - p + 1));
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue;
    const char* q = line;
    long long rid = parse_ll(&q, lend);
    if (rid < 0 || q >= lend || *q != '\t') { err = {"value", "reads tsv: malformed row"}; return false; }
    const char* tb = q;
    for (int k = 0; k < 2; ++k) {
      tb = (const char*)memchr(tb + 1, '\t', (size_t)(lend - tb - 1));
      if (!tb) { err = {"value", "reads tsv: malformed row"}; return false; }
    }
    const char* seq_s = tb + 1;
    const char* t4 = (const char*)memchr(seq_s, '\t', (size_t)(lend - seq_s));
    const char* seq_e = t4 ? t4 : lend;
    seqs[rid] = {seq_s, (size_t)(seq_e - seq_s)};  // last occurrence wins
  }
  if (seqs.size() != t.reads.size()) {
    err = {"assert", "reads tsv: sequence count mismatch"};
    return false;
  }
  for (auto& rd : t.reads) {
    auto it = seqs.find(rd.id);
    if (it == seqs.end()) { err = {"value", "reads tsv: missing read id"}; return false; }
    /* seqs are ASCII bases; reject high bytes so byte offsets == Python
     * string (code point) offsets in every polyA window computation. */
    for (size_t i = 0; i < it->second.second; ++i)
      if ((unsigned char)it->second.first[i] >= 0x80) {
        err = {"value", "reads tsv: non-ASCII sequence"};
        return false;
      }
    rd.seq.assign(it->second.first, it->second.second);
  }
  return true;
}

/* ----------------------------------------------------- splice signal */

bool build_signal(Tint& t, bool consider_ends, ParseError& err) {
  size_t n_iv = t.intervals.size();
  t.per_iv.resize(n_iv);
  t.y_raw.resize(n_iv);
  for (size_t i = 0; i < n_iv; ++i)
    t.y_raw[i].assign((size_t)(t.intervals[i].second - t.intervals[i].first + 1), 0);

  for (size_t rep = 0; rep < t.rep_members.size(); ++rep) {
    const Read& rd = t.reads[(size_t)t.rep_members[rep][0]];
    long long mult = t.weights[rep];
    size_t n_k = rd.ivs.size();
    for (size_t k = 0; k < n_k; ++k) {
      long long ts = rd.ivs[k].ts, te = rd.ivs[k].te;
      /* searchsorted(iv_starts, ts, right) - 1 */
      size_t lo = 0, hi = n_iv;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (t.intervals[mid].first <= ts) lo = mid + 1; else hi = mid;
      }
      if (lo == 0) { err = {"assert", "signal: interval before first"}; return false; }
      size_t iv = lo - 1;
      long long s = t.intervals[iv].first, e = t.intervals[iv].second;
      if (!(s <= ts && ts <= te && te <= e)) {
        err = {"assert", "signal: rep interval outside tint interval"};
        return false;
      }
      long long ys = ts - s, ye = te - s;
      bool start_on = consider_ends || k != 0;
      bool end_on = consider_ends || k != n_k - 1;
      if (start_on) t.y_raw[iv][(size_t)ys] += mult;
      if (end_on) t.y_raw[iv][(size_t)ye] += mult;
      t.per_iv[iv].ys.push_back(ys);
      t.per_iv[iv].ye.push_back(ye);
      t.per_iv[iv].rep.push_back((int)rep);
    }
  }
  return true;
}

/* ------------------------------------------------------------- coverage */

/* C[c][r] = bases of rep r before candidate c (inclusive span counting),
 * rows cumulative. cands sorted ascending, y-space of interval iv. */
void coverage_matrix(const Tint& t, size_t iv, const std::vector<long long>& cands,
                     std::vector<long long>& C /* (P+1)*R flat */) {
  size_t P = cands.size();
  size_t R = t.weights.size();
  C.assign((P + 1) * R, 0);
  const IvRows& rows = t.per_iv[iv];
  for (size_t i = 0; i < rows.ys.size(); ++i) {
    long long s = rows.ys[i], e = rows.ye[i];
    size_t rep = (size_t)rows.rep[i];
    /* upper_bound = searchsorted side='right' */
    size_t s_idx = (size_t)(std::upper_bound(cands.begin(), cands.end(), s) - cands.begin());
    size_t e_idx = (size_t)(std::upper_bound(cands.begin(), cands.end(), e) - cands.begin());
    if (s_idx == e_idx) {
      C[s_idx * R + rep] += e - s + 1;
    } else {
      C[s_idx * R + rep] += cands[s_idx] - s;
      C[e_idx * R + rep] += e - cands[e_idx - 1] + 1;
      for (size_t row = s_idx + 1; row < e_idx; ++row)
        C[row * R + rep] += cands[row] - cands[row - 1];
    }
  }
  for (size_t row = 1; row <= P; ++row)
    for (size_t r = 0; r < R; ++r) C[row * R + r] += C[(row - 1) * R + r];
}

/* ------------------------------------------------- polyA / gap tokens */

struct TokError {
  std::string msg;
  bool set = false;
  void fail(const char* m) { if (!set) { msg = m; set = true; } }
};

bool walk_cigar_to(const std::vector<CigarOp>& cigar, long long t_goal,
                   long long t_pos, long long q_pos, long long* out,
                   TokError& te) {
  if (t_pos > t_goal) { te.fail("walk: t_pos > t_goal"); return false; }
  size_t i = 0;
  while (t_pos < t_goal) {
    if (i >= cigar.size()) { te.fail("walk: cigar exhausted"); return false; }
    long long op = cigar[i].op, c = cigar[i].len;
    /* The Python twin clamps EVERY op by remaining target distance,
     * including insertions -- replicate exactly (ops/polya.py:71-78). */
    if (c > t_goal - t_pos) c = t_goal - t_pos;
    if (op == OP_M || op == OP_EQ || op == OP_X) { t_pos += c; q_pos += c; }
    else if (op == OP_D) t_pos += c;
    else if (op == OP_I) q_pos += c;
    ++i;
  }
  if (t_pos != t_goal) { te.fail("walk: t_pos != t_goal"); return false; }
  *out = q_pos;
  return true;
}

bool query_pos_at_start(long long start, const std::vector<RInterval>& ivs,
                        long long* q_out, long long* slack_out, TokError& te) {
  for (const auto& iv : ivs) {
    if (iv.te < start) continue;
    long long q_pos, slack;
    if (start < iv.ts) { q_pos = iv.qs; slack = start - iv.ts; }
    else {
      if (!walk_cigar_to(iv.cigar, start, iv.ts, iv.qs, &q_pos, te)) return false;
      slack = 0;
    }
    if (slack > 0) { te.fail("start: slack > 0"); return false; }
    if (!(iv.qs <= q_pos && q_pos <= iv.qe)) { te.fail("start: q_pos outside"); return false; }
    *q_out = q_pos;
    *slack_out = slack;
    return true;
  }
  te.fail("no interval reaches start");
  return false;
}

bool query_pos_at_end(long long end, const std::vector<RInterval>& ivs,
                      long long* q_out, long long* slack_out, TokError& te) {
  for (size_t i = ivs.size(); i-- > 0;) {
    const auto& iv = ivs[i];
    if (iv.ts > end) continue;
    long long q_pos, slack;
    if (iv.te < end) { q_pos = iv.qe; slack = iv.te - end; }
    else {
      if (!walk_cigar_to(iv.cigar, end, iv.ts, iv.qs, &q_pos, te)) return false;
      slack = 0;
    }
    if (slack > 0) { te.fail("end: slack > 0"); return false; }
    if (!(0 <= q_pos && q_pos <= iv.qe)) { te.fail("end: q_pos outside"); return false; }
    *q_out = q_pos;
    *slack_out = slack;
    return true;
  }
  te.fail("no interval reaches end");
  return false;
}

/* Kadane best run of `target0` in window [lo, hi) of seq (alignment
 * orientation; '-' strand scans the mirrored slice reversed with the char
 * complemented). Same contract as native/polyatok.c best_run. Returns
 * found flag; (first, len, cnt) of the best qualifying run. */
bool best_run(const std::string& seq, long long lo, long long hi, bool minus,
              char target0, long long* r_first, long long* r_len,
              long long* r_cnt) {
  char target = target0;
  if (minus) {
    switch (target) {
      case 'A': target = 'T'; break;
      case 'T': target = 'A'; break;
      case 'C': target = 'G'; break;
      case 'G': target = 'C'; break;
    }
  }
  const long long L = (long long)seq.size();
  const long long W = hi - lo;
  long long best_first = -1, best_len = 0, best_cnt = 0;
  double best_purity = -1.0;
  long long score = 0, run_first = -1, run_cnt = 0;
  long long best_score = -1, best_t = -1, cnt_at_best = 0;
  auto finish = [&]() {
    if (run_first >= 0) {
      long long length = best_t + 1 - run_first;
      /* length >= 20 and purity >= 0.85 as the exact rational test */
      if (length >= 20 && 20 * cnt_at_best >= 17 * length) {
        double p = (double)cnt_at_best / (double)length;
        if (p > best_purity) {
          best_purity = p;
          best_first = run_first;
          best_len = length;
          best_cnt = cnt_at_best;
        }
      }
      run_first = -1;
    }
  };
  for (long long tt = 0; tt < W; ++tt) {
    long long idx = minus ? (L - 1 - lo - tt) : (lo + tt);
    bool m = (idx >= 0 && idx < L && seq[(size_t)idx] == target);
    score += m ? 1 : -2;
    if (score < 0) score = 0;
    if (score > 0) {
      if (run_first < 0) {
        run_first = tt;
        run_cnt = 0;
        best_score = -1;
        best_t = -1;
        cnt_at_best = 0;
      }
      if (m) ++run_cnt;
      if (score >= best_score) { /* ties -> latest position */
        best_score = score;
        best_t = tt;
        cnt_at_best = run_cnt;
      }
    } else {
      finish();
    }
  }
  finish();
  if (best_first < 0) return false;
  *r_first = best_first;
  *r_len = best_len;
  *r_cnt = best_cnt;
  return true;
}

/* Best of polyA vs polyT in one window: strict purity >, A wins ties
 * (ops/polya.py:_best_poly). found -> (first, len, char). */
bool best_poly(const std::string& seq, long long lo, long long hi, bool minus,
               long long* b_first, long long* b_len, char* b_char) {
  bool found = false;
  double best_p = -1.0;
  for (char ch : {'A', 'T'}) {
    long long f, l, c;
    if (!best_run(seq, lo, hi, minus, ch, &f, &l, &c)) continue;
    double p = (double)c / (double)l;
    if (p > best_p) {
      best_p = p;
      *b_first = f;
      *b_len = l;
      *b_char = ch;
      found = true;
    }
  }
  return found;
}

/* Token set for one read; appends sorted tokens joined by ','+trailing ','
 * to out (empty field when no tokens). data = the rep's final 0/1/2 row.
 * segs are the tint-wide genomic (start, end) pairs. */
bool annotate_read(const Read& rd, const std::vector<int8_t>& data,
                   const std::vector<std::pair<long long, long long>>& segs,
                   std::string& out, TokError& te) {
  /* runs of 1s */
  std::vector<std::pair<long long, long long>> runs;
  long long run_start = -1;
  for (size_t i = 0; i < data.size(); ++i) {
    if (data[i] == 1) {
      if (run_start < 0) run_start = (long long)i;
    } else if (run_start >= 0) {
      runs.emplace_back(run_start, (long long)i - 1);
      run_start = -1;
    }
  }
  if (run_start >= 0) runs.emplace_back(run_start, (long long)data.size() - 1);
  if (runs.empty()) return true; /* no tokens */

  long long read_len = (long long)rd.seq.size();
  long long start = segs[(size_t)runs.front().first].first;
  long long end = segs[(size_t)runs.back().second].second;
  long long q_ssc, q_esc, slack;
  if (!query_pos_at_start(start, rd.ivs, &q_ssc, &slack, te)) return false;
  if (!query_pos_at_end(end, rd.ivs, &q_esc, &slack, te)) return false;
  if (!(0 <= q_ssc && q_ssc <= q_esc && q_esc <= read_len)) {
    te.fail("clip: q_ssc/q_esc out of order");
    return false;
  }

  bool minus = rd.strand == "-";
  std::vector<std::string> toks;
  char buf[96];
  long long bf, bl;
  char bc;
  if (best_poly(rd.seq, 0, q_ssc, minus, &bf, &bl, &bc)) {
    long long gap = q_ssc - bf - bl;
    if (!(0 <= gap && gap < q_ssc)) { te.fail("emit: start gap out of range"); return false; }
    snprintf(buf, sizeof(buf), "S%c_%lld:%lld", bc, bl, gap);
    toks.emplace_back(buf);
    snprintf(buf, sizeof(buf), "SSC:%lld", bf);
    toks.emplace_back(buf);
  } else {
    snprintf(buf, sizeof(buf), "SSC:%lld", q_ssc);
    toks.emplace_back(buf);
  }
  if (best_poly(rd.seq, q_esc, read_len, minus, &bf, &bl, &bc)) {
    long long gap = bf;
    if (!(0 <= gap && gap < read_len - q_esc)) { te.fail("emit: end gap out of range"); return false; }
    if (!(read_len - q_esc - gap > 0)) { te.fail("emit: nonpositive ESC"); return false; }
    snprintf(buf, sizeof(buf), "E%c_%lld:%lld", bc, bl, gap);
    toks.emplace_back(buf);
    snprintf(buf, sizeof(buf), "ESC:%lld", read_len - q_esc - gap);
    toks.emplace_back(buf);
  } else {
    snprintf(buf, sizeof(buf), "ESC:%lld", read_len - q_esc);
    toks.emplace_back(buf);
  }
  for (size_t r = 0; r + 1 < runs.size(); ++r) {
    long long r1_l = runs[r].second, r2_f = runs[r + 1].first;
    long long g_start, g_end, s_slack, e_slack;
    if (!query_pos_at_end(segs[(size_t)r1_l].second, rd.ivs, &g_start, &s_slack, te))
      return false;
    if (!query_pos_at_start(segs[(size_t)r2_f].first, rd.ivs, &g_end, &e_slack, te))
      return false;
    if (!(0 < g_start && g_start <= g_end && g_end < read_len)) {
      te.fail("emit: gap bounds out of order");
      return false;
    }
    long long size = g_end - g_start + s_slack + e_slack;
    if (size < 0) size = 0;
    if (!(size < read_len)) { te.fail("emit: gap size out of range"); return false; }
    if (!(r1_l < r2_f)) { te.fail("emit: runs out of order"); return false; }
    snprintf(buf, sizeof(buf), "%lld-%lld:%lld", r1_l, r2_f, size);
    toks.emplace_back(buf);
  }
  std::sort(toks.begin(), toks.end()); /* byte-lex == Python sorted (ASCII) */
  for (const auto& s : toks) {
    out += s;
    out += ',';
  }
  return true;
}

/* ------------------------------------------------------------ finalize */

void append_ll(std::string& out, long long v) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%lld", v);
  out.append(buf, (size_t)n);
}

/* Genotype + annotate + format the whole segment TSV. final_ys is per
 * tint interval (sorted y-space positions). lookup/scale as
 * ops/thresholds.py (lookup[i] = h_scaled*2 + eq_nay, index
 * min(seg_len, len(lookup)-1)). Returns false with te set on any
 * invariant violation. */
bool finalize_tsv(const Tint& t, const std::vector<std::vector<long long>>& final_ys,
                  const int32_t* lookup, size_t lookup_len, long long scale,
                  std::string& out, TokError& te) {
  size_t R = t.weights.size();
  size_t n_iv = t.intervals.size();
  /* total data columns across intervals (incl. the 0 separators) */
  size_t T = 0;
  for (const auto& fy : final_ys) T += fy.size();
  if (T == 0) { te.fail("finalize: no positions"); return false; }

  /* per-rep data rows, column-major build then trailing column popped */
  std::vector<int8_t> data((size_t)R * T, 0);  /* data[rep*T + col] */
  std::vector<long long> positions;
  positions.reserve(T);
  size_t col = 0;
  std::vector<long long> C2;
  for (size_t iv = 0; iv < n_iv; ++iv) {
    const std::vector<long long>& fy = final_ys[iv];
    if (fy.empty()) { te.fail("finalize: empty interval positions"); return false; }
    long long iv_s = t.intervals[iv].first;
    for (long long y : fy) positions.push_back(iv_s + y);
    coverage_matrix(t, iv, fy, C2);
    size_t S = fy.size() - 1;
    for (size_t k = 0; k < S; ++k) {
      long long seg_len = fy[k + 1] - fy[k] + 1;
      size_t li = (size_t)seg_len < lookup_len - 1 ? (size_t)seg_len : lookup_len - 1;
      long long h = lookup[li] >> 1;
      long long eq = lookup[li] & 1;
      long long hi_thr = h * seg_len;
      long long lo_thr = (scale - h) * seg_len + eq;
      const long long* rowk = &C2[k * R];
      const long long* rowk1 = &C2[(k + 1) * R];
      for (size_t r = 0; r < R; ++r) {
        long long cov = rowk1[r] - rowk[r];
        if (!(0 <= cov && cov <= seg_len)) { te.fail("finalize: coverage out of bounds"); return false; }
        long long sc = scale * cov;
        data[r * T + col + k] = sc > hi_thr ? 1 : (sc < lo_thr ? 0 : 2);
      }
    }
    /* 0 separator column already zero-initialized */
    col += S + 1;
  }
  /* trailing column popped: per-read rows use cols [0, T-1) */
  size_t T_out = T - 1;
  if (T_out != positions.size() - 1) { te.fail("finalize: column count mismatch"); return false; }

  std::vector<std::pair<long long, long long>> segs;
  segs.reserve(T_out);
  for (size_t i = 0; i + 1 < positions.size(); ++i)
    segs.emplace_back(positions[i], positions[i + 1]);

  /* header */
  out.clear();
  size_t est = 64;
  for (const auto& rd : t.reads) est += rd.name.size() + T_out + 64;
  out.reserve(est);
  out += '#';
  out += t.chrom;
  out += '\t';
  append_ll(out, t.id);
  out += '\t';
  for (size_t i = 0; i < positions.size(); ++i) {
    if (i) out += ',';
    append_ll(out, positions[i]);
  }
  out += '\n';

  std::vector<int8_t> rep_row(T_out);
  for (const auto& rd : t.reads) {
    const int8_t* row = &data[(size_t)rd.rep * T];
    append_ll(out, rd.id);
    out += '\t';
    out += rd.name;
    out += '\t';
    out += rd.chrom;
    out += '\t';
    out += rd.strand;
    out += '\t';
    append_ll(out, rd.tint);
    out += '\t';
    size_t base = out.size();
    out.resize(base + T_out);
    for (size_t k = 0; k < T_out; ++k) out[base + k] = (char)('0' + row[k]);
    out += '\t';
    std::copy(row, row + T_out, rep_row.begin());
    if (!annotate_read(rd, rep_row, segs, out, te)) return false;
    out += '\n';
  }
  return true;
}

/* ------------------------------------------------------------ bindings */

void tint_capsule_destructor(PyObject* caps) {
  Tint* t = (Tint*)PyCapsule_GetPointer(caps, "freddie.segcore.Tint");
  delete t;
}

Tint* tint_from_capsule(PyObject* caps) {
  return (Tint*)PyCapsule_GetPointer(caps, "freddie.segcore.Tint");
}

void raise_parse_error(const ParseError& err) {
  PyObject* type = PyExc_AssertionError;
  if (strcmp(err.type, "value") == 0) type = PyExc_ValueError;
  else if (strcmp(err.type, "os") == 0) type = PyExc_OSError;
  PyErr_SetString(type, err.msg.c_str());
}

PyObject* segcore_load(PyObject* self, PyObject* args) {
  const char* split_path;
  const char* reads_path;
  int consider_ends;
  if (!PyArg_ParseTuple(args, "ssi", &split_path, &reads_path, &consider_ends))
    return NULL;
  std::unique_ptr<Tint> t(new Tint());
  ParseError err{"assert", ""};
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = parse_split(split_path, *t, err) && load_seqs(reads_path, *t, err) &&
       build_signal(*t, consider_ends != 0, err);
  Py_END_ALLOW_THREADS
  if (!ok) {
    raise_parse_error(err);
    return NULL;
  }

  PyObject* intervals = PyList_New((Py_ssize_t)t->intervals.size());
  if (!intervals) return NULL;
  for (size_t i = 0; i < t->intervals.size(); ++i) {
    PyObject* iv = Py_BuildValue("(LL)", t->intervals[i].first, t->intervals[i].second);
    if (!iv) { Py_DECREF(intervals); return NULL; }
    PyList_SET_ITEM(intervals, (Py_ssize_t)i, iv);
  }
  PyObject* weights = PyBytes_FromStringAndSize(
      (const char*)t->weights.data(),
      (Py_ssize_t)(t->weights.size() * sizeof(long long)));
  PyObject* y_raws = PyList_New((Py_ssize_t)t->y_raw.size());
  if (!weights || !y_raws) {
    Py_DECREF(intervals);
    Py_XDECREF(weights);
    Py_XDECREF(y_raws);
    return NULL;
  }
  for (size_t i = 0; i < t->y_raw.size(); ++i) {
    /* float64 copy of the integer counts (exact) */
    std::vector<double> yd(t->y_raw[i].begin(), t->y_raw[i].end());
    PyObject* b = PyBytes_FromStringAndSize((const char*)yd.data(),
                                            (Py_ssize_t)(yd.size() * sizeof(double)));
    if (!b) { Py_DECREF(intervals); Py_DECREF(weights); Py_DECREF(y_raws); return NULL; }
    PyList_SET_ITEM(y_raws, (Py_ssize_t)i, b);
  }
  PyObject* chrom = PyUnicode_FromStringAndSize(t->chrom.data(), (Py_ssize_t)t->chrom.size());
  if (!chrom) { Py_DECREF(intervals); Py_DECREF(weights); Py_DECREF(y_raws); return NULL; }
  long long tid = t->id;
  long long n_reads = (long long)t->reads.size();
  long long n_reps = (long long)t->weights.size();
  PyObject* caps = PyCapsule_New(t.release(), "freddie.segcore.Tint",
                                 tint_capsule_destructor);
  if (!caps) { Py_DECREF(intervals); Py_DECREF(weights); Py_DECREF(y_raws); Py_DECREF(chrom); return NULL; }
  return Py_BuildValue("(NNLNLLNN)", caps, chrom, tid, intervals, n_reads,
                       n_reps, weights, y_raws);
}

PyObject* segcore_coverage(PyObject* self, PyObject* args) {
  PyObject* caps;
  long long iv_idx;
  PyObject* cands_obj;
  if (!PyArg_ParseTuple(args, "OLO!", &caps, &iv_idx, &PyList_Type, &cands_obj))
    return NULL;
  Tint* t = tint_from_capsule(caps);
  if (!t) return NULL;
  if (iv_idx < 0 || (size_t)iv_idx >= t->intervals.size()) {
    PyErr_SetString(PyExc_IndexError, "coverage: interval index out of range");
    return NULL;
  }
  Py_ssize_t P = PyList_GET_SIZE(cands_obj);
  std::vector<long long> cands((size_t)P);
  for (Py_ssize_t i = 0; i < P; ++i) {
    cands[(size_t)i] = PyLong_AsLongLong(PyList_GET_ITEM(cands_obj, i));
    if (PyErr_Occurred()) return NULL;
    if (i && cands[(size_t)i] < cands[(size_t)i - 1]) {
      PyErr_SetString(PyExc_AssertionError, "coverage: candidates not sorted");
      return NULL;
    }
  }
  std::vector<long long> C;
  Py_BEGIN_ALLOW_THREADS
  coverage_matrix(*t, (size_t)iv_idx, cands, C);
  Py_END_ALLOW_THREADS
  return PyBytes_FromStringAndSize((const char*)C.data(),
                                   (Py_ssize_t)(C.size() * sizeof(long long)));
}

/* rows(capsule, iv_idx) -> (ys bytes, ye bytes, rep bytes): the tint
 * interval's read-rep intervals in y-space (int64 each), the same rows
 * build_splice_signal's per_iv carries on the Python path. Used by the
 * device-side coverage builder (ops/coverage.py) to ship interval lists
 * instead of dense C matrices. */
PyObject* segcore_rows(PyObject* self, PyObject* args) {
  PyObject* caps;
  long long iv_idx;
  if (!PyArg_ParseTuple(args, "OL", &caps, &iv_idx)) return NULL;
  Tint* t = tint_from_capsule(caps);
  if (!t) return NULL;
  if (iv_idx < 0 || (size_t)iv_idx >= t->per_iv.size()) {
    PyErr_SetString(PyExc_IndexError, "rows: interval index out of range");
    return NULL;
  }
  const IvRows& r = t->per_iv[(size_t)iv_idx];
  std::vector<long long> rep64(r.rep.begin(), r.rep.end());
  PyObject* ys = PyBytes_FromStringAndSize(
      (const char*)r.ys.data(), (Py_ssize_t)(r.ys.size() * sizeof(long long)));
  PyObject* ye = PyBytes_FromStringAndSize(
      (const char*)r.ye.data(), (Py_ssize_t)(r.ye.size() * sizeof(long long)));
  PyObject* rp = PyBytes_FromStringAndSize(
      (const char*)rep64.data(), (Py_ssize_t)(rep64.size() * sizeof(long long)));
  if (!ys || !ye || !rp) {
    Py_XDECREF(ys);
    Py_XDECREF(ye);
    Py_XDECREF(rp);
    return NULL;
  }
  return Py_BuildValue("(NNN)", ys, ye, rp);
}

PyObject* segcore_finalize(PyObject* self, PyObject* args) {
  PyObject* caps;
  PyObject* final_ys_obj;
  Py_buffer lookup_buf;
  long long scale;
  if (!PyArg_ParseTuple(args, "OO!y*L", &caps, &PyList_Type, &final_ys_obj,
                        &lookup_buf, &scale))
    return NULL;
  Tint* t = tint_from_capsule(caps);
  if (!t) { PyBuffer_Release(&lookup_buf); return NULL; }
  if ((size_t)PyList_GET_SIZE(final_ys_obj) != t->intervals.size()) {
    PyBuffer_Release(&lookup_buf);
    PyErr_SetString(PyExc_AssertionError, "finalize: interval count mismatch");
    return NULL;
  }
  std::vector<std::vector<long long>> final_ys(t->intervals.size());
  for (size_t iv = 0; iv < t->intervals.size(); ++iv) {
    PyObject* lst = PyList_GET_ITEM(final_ys_obj, (Py_ssize_t)iv);
    if (!PyList_Check(lst)) {
      PyBuffer_Release(&lookup_buf);
      PyErr_SetString(PyExc_TypeError, "finalize: final_ys must be lists");
      return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(lst);
    final_ys[iv].resize((size_t)n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      final_ys[iv][(size_t)i] = PyLong_AsLongLong(PyList_GET_ITEM(lst, i));
      if (PyErr_Occurred()) { PyBuffer_Release(&lookup_buf); return NULL; }
      if (i && final_ys[iv][(size_t)i] <= final_ys[iv][(size_t)i - 1]) {
        PyBuffer_Release(&lookup_buf);
        PyErr_SetString(PyExc_AssertionError, "finalize: positions not ascending");
        return NULL;
      }
    }
  }
  size_t lookup_len = (size_t)lookup_buf.len / sizeof(int32_t);
  const int32_t* lookup = (const int32_t*)lookup_buf.buf;
  std::string out;
  TokError te;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = finalize_tsv(*t, final_ys, lookup, lookup_len, scale, out, te);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&lookup_buf);
  if (!ok) {
    PyErr_SetString(PyExc_AssertionError,
                    te.set ? te.msg.c_str() : "finalize failed");
    return NULL;
  }
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

PyMethodDef Methods[] = {
    {"load", segcore_load, METH_VARARGS,
     "Parse split+reads TSVs and build the splice signal for one tint."},
    {"coverage", segcore_coverage, METH_VARARGS,
     "Cumulative coverage matrix at candidate breakpoints."},
    {"rows", segcore_rows, METH_VARARGS,
     "One tint interval's (ys, ye, rep) read-rep interval arrays."},
    {"finalize", segcore_finalize, METH_VARARGS,
     "Genotype, annotate polyA/gaps, and format the segment TSV."},
    {NULL, NULL, 0, NULL}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "segcore", NULL, -1,
                                Methods};

}  // namespace

PyMODINIT_FUNC PyInit_segcore(void) { return PyModule_Create(&moduledef); }
