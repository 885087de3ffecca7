/* CPython extension: consolidated native engine for the cluster stage.
 *
 * One call runs a whole tint end to end on the host:
 *
 *   cluster_tint(path, recycle_model, eps_scale, eps_scaled, offset,
 *                max_rounds, min_isoform_size, max_ilp, deadline_s,
 *                node_budget, closure_max_segs, closure_cap,
 *                bounds_device_min) -> bytes | None
 *
 *     parse the segment TSV (grammar of freddie_jax/io/tsv.py
 *     parse_segment_tsv / native/tsvparse.c, wire format
 *     /root/reference/py/freddie_segment.py:795-835), group read reps,
 *     preprocess (I/C/FL/garbage/polyA virtual gaps,
 *     py/freddie_cluster.py:277-328), partition
 *     (py/freddie_cluster.py:196-274), then run the per-partition round
 *     loop (py/freddie_cluster.py:694-773) against the in-process
 *     solve_round core (round_solver.cpp, the bit-equal twin of the
 *     solver/two_phase.py chain) and format the cluster TSV byte-
 *     identically to freddie_jax/io/tsv.py:format_cluster_tsv.
 *
 *     Returns None when ANY round needs a Python-side escalation rung
 *     (solve_round status 2/4/5: segenum/wide/LP/full-search or the
 *     device-bounds closure) -- the caller then re-runs the tint on the
 *     Python path, which recomputes every earlier round identically
 *     (deterministic, content-only dispatch), so outputs never depend
 *     on which engine ran. Any parse/invariant failure raises and the
 *     caller falls back the same way (tests/test_clucore.py pins
 *     whole-stage byte-parity against the Python path).
 *
 * Build: g++ -O2 -shared -fPIC -I<python-include> -o clucore.so
 *        clucore.cpp bnb_solver.cpp segenum.cpp round_solver.cpp
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" int solve_round_cached(
    int n_reads, int n_segs, const uint8_t* I_bytes, const uint8_t* C_bytes,
    const double* garbage, const int64_t* seg_len, const int32_t* gap_counts,
    const int32_t* gap_lo, const int32_t* gap_hi, const int64_t* gap_lens,
    int n_incomp, const int32_t* incomp_pairs, int64_t sc, int64_t eps,
    int64_t off, double deadline_s, int64_t node_budget,
    int64_t closure_max_segs, int64_t closure_cap, int64_t bounds_device_min,
    void* cache, const int32_t* read_ids, const int32_t* col_ids,
    int32_t* out_assigned, int32_t* out_n, double* out_obj, uint64_t* out_E,
    int64_t* out_nodes);
extern "C" void* closure_cache_new();
extern "C" void closure_cache_free(void*);

namespace {

struct CluError {
  const char* type = "assert";  // "assert" | "value" | "os"
  std::string msg;
  bool set = false;
  void fail(const char* t, const std::string& m) {
    if (!set) { type = t; msg = m; set = true; }
  }
};

struct PolyTok {
  char k0, k1;
  long long len, gap;
};

struct ReadC {
  long long id, tint;
  std::string name, strand;
  std::string data;  // digit chars, length M
  std::vector<std::array<long long, 3>> gaps;  // (j1, j2, size) file order
  std::vector<PolyTok> poly;                   // dict-order w/ overwrite
  int rep = -1;
  char category = 'N';
  int partition = -1;
};

struct TintC {
  std::string chrom;
  long long id = -1;
  std::vector<long long> positions;
  long long M = -1;
  std::vector<ReadC> reads;
  std::vector<std::vector<int>> reps;  // first-seen rep-key order
};

long long parse_ll(const char** p, const char* end) {
  const char* s = *p;
  if (s >= end || *s < '0' || *s > '9') return -1;
  long long v = 0;
  while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  *p = s;
  return v;
}

bool all_digits(const char* s, const char* e) {
  if (s >= e) return false;
  for (; s < e; ++s)
    if (*s < '0' || *s > '9') return false;
  return true;
}

void append_ll(std::string& out, long long v) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%lld", v);
  out.append(buf, (size_t)n);
}

/* ------------------------------------------------------------- parse
 * Same grammar and strictness as native/tsvparse.c:parse_segment_file
 * (itself pinned object-identical to the Python regex parser by
 * tests/test_native_tsvparse.py); the rep key is the reference's
 * py/freddie_cluster.py:154-164 signature. */
bool parse_segment(const char* path, TintC& t, CluError& err) {
  FILE* f = fopen(path, "rb");
  if (!f) { err.fail("os", std::string("cannot open ") + path); return false; }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)fsize + 1);
  if (fsize > 0 && fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    err.fail("os", "short read");
    return false;
  }
  fclose(f);
  buf[(size_t)fsize] = '\n';

  std::unordered_map<std::string, int> rep_of;
  std::string key;

  const char* p = buf.data();
  const char* bend = buf.data() + fsize;
  bool have_header = false;
  while (p < bend) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue;

    if (*line == '#') {
      if (have_header) { err.fail("assert", "multiple tints in one segment file"); return false; }
      const char* t1 = (const char*)memchr(line, '\t', (size_t)(lend - line));
      if (!t1) { err.fail("value", "header: missing fields"); return false; }
      t.chrom.assign(line + 1, (size_t)(t1 - line - 1));
      const char* q = t1 + 1;
      t.id = parse_ll(&q, lend);
      if (t.id < 0 || q >= lend || *q != '\t') { err.fail("value", "header: bad tint"); return false; }
      ++q;
      long long prev = -1;
      while (true) {
        long long v = parse_ll(&q, lend);
        if (v < 0) { err.fail("value", "header: bad position"); return false; }
        if (prev >= 0 && !(prev < v)) { err.fail("assert", "header: positions not ascending"); return false; }
        prev = v;
        t.positions.push_back(v);
        if (q < lend && *q == ',') { ++q; continue; }
        break;
      }
      if (q != lend) { err.fail("value", "header: trailing junk"); return false; }
      t.M = (long long)t.positions.size() - 1;
      have_header = true;
      continue;
    }
    if (!have_header) { err.fail("assert", "read row before tint header"); return false; }

    /* rid \t name \t chrom \t strand \t tint \t data \t gaps */
    ReadC rd;
    const char* q = line;
    rd.id = parse_ll(&q, lend);
    if (rd.id < 0 || q >= lend || *q != '\t') { err.fail("value", "row: bad rid"); return false; }
    ++q;
    const char* tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err.fail("value", "row: missing name end"); return false; }
    rd.name.assign(q, (size_t)(tb - q));
    q = tb + 1;
    tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err.fail("value", "row: missing chrom end"); return false; }
    if (!((size_t)(tb - q) == t.chrom.size() &&
          memcmp(q, t.chrom.data(), t.chrom.size()) == 0)) {
      err.fail("assert", "row: chrom mismatch");
      return false;
    }
    q = tb + 1;
    tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    if (!tb) { err.fail("value", "row: missing strand end"); return false; }
    rd.strand.assign(q, (size_t)(tb - q));
    q = tb + 1;
    rd.tint = parse_ll(&q, lend);
    if (rd.tint < 0 || q >= lend || *q != '\t') { err.fail("value", "row: bad tint"); return false; }
    ++q;
    const char* data_s = q;
    tb = (const char*)memchr(q, '\t', (size_t)(lend - q));
    const char* data_e = tb ? tb : lend;
    const char* gaps_s = tb ? tb + 1 : lend;
    const char* gaps_e = lend;
    if (tb && memchr(gaps_s, '\t', (size_t)(lend - gaps_s))) {
      err.fail("value", "row: unexpected extra fields");
      return false;
    }
    long long dlen = data_e - data_s;
    if (dlen != t.M) { err.fail("assert", "row: data length != segment count"); return false; }
    rd.data.assign(data_s, (size_t)dlen);
    key.clear();
    key.reserve((size_t)dlen + 32);
    for (long long i = 0; i < dlen; ++i) {
      char c = data_s[i];
      if (c < '0' || c > '9') { err.fail("value", "row: bad data digit"); return false; }
      key.push_back(c == '2' ? '0' : c);
    }

    const char* g = gaps_s;
    char tmp[48];
    while (g < gaps_e) {
      const char* ge = (const char*)memchr(g, ',', (size_t)(gaps_e - g));
      if (!ge) { err.fail("value", "row: gap token without trailing comma"); return false; }
      const char* colon = (const char*)memchr(g, ':', (size_t)(ge - g));
      if (!colon) { err.fail("value", "row: gap token without colon"); return false; }
      if (!all_digits(colon + 1, ge)) { err.fail("value", "row: gap value not digits"); return false; }
      const char* vq = colon + 1;
      long long val = parse_ll(&vq, ge);
      if (val < 0 || vq != ge) { err.fail("value", "row: bad gap value"); return false; }
      Py_ssize_t head = colon - g;
      const char* dash = (const char*)memchr(g, '-', (size_t)head);
      const char* under = (const char*)memchr(g, '_', (size_t)head);
      if (dash && all_digits(g, dash) && all_digits(dash + 1, colon)) {
        /* internal gap j1-j2:size */
        const char* aq = g;
        long long a = parse_ll(&aq, dash);
        const char* bq = dash + 1;
        long long b = parse_ll(&bq, colon);
        if (a < 0 || b < 0) { err.fail("value", "row: bad gap bounds"); return false; }
        if (!(0 <= a && a < b && b < dlen)) { err.fail("assert", "row: gap bounds out of range"); return false; }
        bool replaced = false;  /* dict overwrite keeps insertion slot */
        for (auto& gp : rd.gaps)
          if (gp[0] == a && gp[1] == b) { gp[2] = val; replaced = true; break; }
        if (!replaced) rd.gaps.push_back({a, b, val});
        if (val > 10) {
          int nn = snprintf(tmp, sizeof(tmp), ".%lld", val);
          key.append(tmp, (size_t)nn);
        } else {
          key += ".0";
        }
      } else if (head == 3 && (g[0] == 'E' || g[0] == 'S') && g[1] == 'S' &&
                 g[2] == 'C') {
        /* softclip SSC/ESC: parsed for validity; unused by clustering */
      } else if (under && under - g == 2 && (g[0] == 'E' || g[0] == 'S') &&
                 (g[1] == 'A' || g[1] == 'T') && all_digits(under + 1, colon)) {
        const char* lq = under + 1;
        long long plen = parse_ll(&lq, colon);
        if (plen < 0) { err.fail("value", "row: bad poly length"); return false; }
        bool replaced = false;
        for (auto& pt : rd.poly)
          if (pt.k0 == g[0] && pt.k1 == g[1]) { pt.len = plen; pt.gap = val; replaced = true; break; }
        if (!replaced) rd.poly.push_back({g[0], g[1], plen, val});
        if (val > 10) {
          int nn = snprintf(tmp, sizeof(tmp), ".%c%lld", g[0], val);
          key.append(tmp, (size_t)nn);
        } else {
          tmp[0] = '.'; tmp[1] = g[0]; tmp[2] = '0';
          key.append(tmp, 3);
        }
      } else {
        err.fail("value", "row: unknown gap token");
        return false;
      }
      g = ge + 1;
    }

    auto it = rep_of.find(key);
    int rep;
    if (it == rep_of.end()) {
      rep = (int)t.reps.size();
      rep_of.emplace(key, rep);
      t.reps.emplace_back();
    } else {
      rep = it->second;
    }
    rd.rep = rep;
    t.reps[(size_t)rep].push_back((int)t.reads.size());
    t.reads.push_back(std::move(rd));
  }
  if (!have_header) { err.fail("assert", "no tint header"); return false; }
  return true;
}

/* -------------------------------------------------------- preprocess
 * py/freddie_cluster.py:277-328 exactly (stages/cluster.py:preprocess):
 * per-rep I/C rows, first/last covered, polyA category + virtual tail
 * gap, garbage cost by recycle model. */
struct Prep {
  std::vector<uint8_t> I, C;  // R*M row-major 0/1
  std::vector<int> Fl, Ll;
  std::vector<double> garbage;
  /* per-rep gaps: file-order copy + (possibly) the virtual tail gap
   * appended; shared by every member read for the output formatter */
  std::vector<std::vector<std::array<long long, 3>>> rep_gaps;
};

bool preprocess(TintC& t, int recycle_model, Prep& pp, CluError& err) {
  const long long M = t.M;
  const size_t R = t.reps.size();
  pp.I.assign(R * (size_t)M, 0);
  pp.C.assign(R * (size_t)M, 0);
  pp.Fl.resize(R);
  pp.Ll.resize(R);
  pp.garbage.resize(R);
  pp.rep_gaps.resize(R);
  for (size_t r = 0; r < R; ++r) {
    const ReadC& read = t.reads[(size_t)t.reps[r][0]];
    uint8_t* I_row = &pp.I[r * (size_t)M];
    int min_i = -1, max_i = (int)M - 1;
    long long sum_I = 0;
    for (long long j = 0; j < M; ++j) {
      int d = read.data[(size_t)j] - '0';
      int v = d % 2;
      I_row[(size_t)j] = (uint8_t)v;
      if (v == 1) {
        if (min_i == -1) min_i = (int)j;
        max_i = (int)j;
      }
      sum_I += v;
    }
    char category = 'N';
    auto& rg = pp.rep_gaps[r];
    rg = read.gaps;
    if (read.poly.size() == 1) {
      const PolyTok& pt = read.poly[0];
      if (pt.k0 == 'S' && (pt.k1 == 'A' || pt.k1 == 'T') && pt.len > 10) {
        category = 'S';
        rg.push_back({-1, (long long)min_i, pt.gap});
        min_i = 0;
      } else if (pt.k0 == 'E' && (pt.k1 == 'A' || pt.k1 == 'T') && pt.len > 10) {
        category = 'E';
        rg.push_back({(long long)max_i, M, pt.gap});
        max_i = (int)M - 1;
      }
    }
    uint8_t* C_row = &pp.C[r * (size_t)M];
    long long sum_C = 0;
    for (long long j = 0; j < M; ++j) {
      int v = (min_i <= (int)j && (int)j <= max_i &&
               read.data[(size_t)j] == '0')
                  ? 1
                  : 0;
      C_row[(size_t)j] = (uint8_t)v;
      sum_C += v;
    }
    double n_mem = (double)t.reps[r].size();
    if (recycle_model == 0) {
      pp.garbage[r] = n_mem * 3.0;
    } else if (recycle_model == 1) {
      double v = (double)sum_I - 0.5;
      pp.garbage[r] = n_mem * (v > 1.0 ? v : 1.0);
    } else if (recycle_model == 2) {
      double v = (double)sum_C - 0.5;
      pp.garbage[r] = n_mem * (v > 1.0 ? v : 1.0);
    } else {
      err.fail("value", "recycle_model not supported natively");
      return false;
    }
    pp.Fl[r] = min_i;
    pp.Ll[r] = max_i;
    for (int ridx : t.reps[r]) t.reads[(size_t)ridx].category = category;
  }
  return true;
}

/* --------------------------------------------------------- partition
 * py/freddie_cluster.py:196-274 (stages/cluster.py:partition_reads):
 * dedup identical structures, pairwise-compatibility over the overlap
 * window, iterative synchronous edge pruning, connected components by
 * smallest member, even splitting at max_ilp, and the read-level
 * incompatible cross products for the surviving non-edges. */
struct Partition {
  std::vector<int> rids;                         // rep ids, group order
  std::vector<std::pair<int, int>> incomp;       // rep-id pairs
};

void partition_reads(const TintC& t, const Prep& pp, long long max_ilp,
                     std::vector<Partition>& parts) {
  const long long M = t.M;
  const int R = (int)t.reps.size();
  /* unique structures: key = I row bytes + (f, l, category), first-seen */
  std::unordered_map<std::string, int> ukey;
  std::vector<std::vector<int>> members;  // unique idx -> rep ids
  std::vector<int> f_arr, l_arr;
  std::vector<int8_t> cat;  // 0=N 1=S 2=E
  std::string kb;
  for (int r = 0; r < R; ++r) {
    char c = t.reads[(size_t)t.reps[(size_t)r][0]].category;
    kb.assign((const char*)&pp.I[(size_t)r * (size_t)M], (size_t)M);
    kb.push_back('\x01');
    kb.append((const char*)&pp.Fl[(size_t)r], sizeof(int));
    kb.append((const char*)&pp.Ll[(size_t)r], sizeof(int));
    kb.push_back(c);
    auto it = ukey.find(kb);
    if (it == ukey.end()) {
      int u = (int)members.size();
      ukey.emplace(kb, u);
      members.emplace_back();
      members.back().push_back(r);
      f_arr.push_back(pp.Fl[(size_t)r]);
      l_arr.push_back(pp.Ll[(size_t)r]);
      cat.push_back(c == 'N' ? 0 : (c == 'S' ? 1 : 2));
    } else {
      members[(size_t)it->second].push_back(r);
    }
  }
  const int N = (int)members.size();
  const int W = (int)((M + 63) / 64) > 0 ? (int)((M + 63) / 64) : 1;
  std::vector<uint64_t> Ew((size_t)N * W, 0), Vw((size_t)N * W, 0);
  for (int u = 0; u < N; ++u) {
    const uint8_t* I_row = &pp.I[(size_t)members[(size_t)u][0] * (size_t)M];
    int f = f_arr[(size_t)u] > 0 ? f_arr[(size_t)u] : 0;
    int l = l_arr[(size_t)u];
    for (long long j = 0; j < M; ++j) {
      if (I_row[(size_t)j])
        Ew[(size_t)u * W + (size_t)(j >> 6)] |= 1ull << (j & 63);
      if ((int)j >= f && (int)j <= l)
        Vw[(size_t)u * W + (size_t)(j >> 6)] |= 1ull << (j & 63);
    }
  }
  /* pairwise edges (strict upper triangle) */
  std::vector<std::pair<int, int>> edges;
  for (int i = 0; i + 1 < N; ++i) {
    const uint64_t* Ei = &Ew[(size_t)i * W];
    const uint64_t* Vi = &Vw[(size_t)i * W];
    for (int j = i + 1; j < N; ++j) {
      const uint64_t* Ej = &Ew[(size_t)j * W];
      const uint64_t* Vj = &Vw[(size_t)j * W];
      long long o = 0, w = 0, diff = 0;
      for (int k = 0; k < W; ++k) {
        uint64_t vi = Vi[k] & Vj[k];
        o += __builtin_popcountll(vi);
        w += __builtin_popcountll(Ei[k] & Ej[k] & vi);
        diff += __builtin_popcountll((Ei[k] ^ Ej[k]) & vi);
      }
      bool ok = (w >= 1) &&
                (((o > 3) && (diff < 3)) || ((o >= 1) && (o <= 3) && (diff == 0)));
      if (ok && cat[(size_t)i] != 0 && cat[(size_t)j] != 0 &&
          cat[(size_t)j] != cat[(size_t)i])
        ok = false;
      if (ok) edges.emplace_back(i, j);
    }
  }
  /* iterative synchronous pruning over a bit-packed adjacency */
  const int Wp = (N + 63) / 64 > 0 ? (N + 63) / 64 : 1;
  std::vector<uint64_t> adjw((size_t)N * Wp, 0);
  std::vector<long long> deg((size_t)N, 0);
  for (auto& e : edges) {
    adjw[(size_t)e.first * Wp + (size_t)(e.second >> 6)] |= 1ull << (e.second & 63);
    adjw[(size_t)e.second * Wp + (size_t)(e.first >> 6)] |= 1ull << (e.first & 63);
    ++deg[(size_t)e.first];
    ++deg[(size_t)e.second];
  }
  std::vector<char> alive(edges.size(), 1);
  std::vector<size_t> drop;
  while (true) {
    drop.clear();
    for (size_t e = 0; e < edges.size(); ++e) {
      if (!alive[e]) continue;
      int i = edges[e].first, j = edges[e].second;
      if (deg[(size_t)i] == 1 || deg[(size_t)j] == 1) continue;
      bool shared = false;
      const uint64_t* ai = &adjw[(size_t)i * Wp];
      const uint64_t* aj = &adjw[(size_t)j * Wp];
      for (int k = 0; k < Wp; ++k)
        if (ai[k] & aj[k]) { shared = true; break; }
      if (!shared) drop.push_back(e);
    }
    if (drop.empty()) break;
    for (size_t e : drop) {  /* apply AFTER the sweep: synchronous */
      alive[e] = 0;
      int i = edges[e].first, j = edges[e].second;
      adjw[(size_t)i * Wp + (size_t)(j >> 6)] &= ~(1ull << (j & 63));
      adjw[(size_t)j * Wp + (size_t)(i >> 6)] &= ~(1ull << (i & 63));
      --deg[(size_t)i];
      --deg[(size_t)j];
    }
  }
  /* connected components over surviving edges, by smallest member */
  std::vector<int> parent(N);
  for (int i = 0; i < N; ++i) parent[(size_t)i] = i;
  auto find = [&parent](int x) {
    while (parent[(size_t)x] != x) {
      parent[(size_t)x] = parent[(size_t)parent[(size_t)x]];
      x = parent[(size_t)x];
    }
    return x;
  };
  for (size_t e = 0; e < edges.size(); ++e) {
    if (!alive[e]) continue;
    int ri = find(edges[e].first), rj = find(edges[e].second);
    if (ri != rj) parent[(size_t)(ri > rj ? ri : rj)] = ri < rj ? ri : rj;
  }
  std::vector<std::vector<int>> comps_by_root((size_t)N);
  std::vector<int> roots;
  for (int i = 0; i < N; ++i) {
    int r = find(i);
    if (comps_by_root[(size_t)r].empty()) roots.push_back(r);
    comps_by_root[(size_t)r].push_back(i);
  }
  std::sort(roots.begin(), roots.end());  /* root == smallest member */

  for (int root : roots) {
    std::vector<int>& comp = comps_by_root[(size_t)root];  /* ascending */
    /* split_list_evenly(comp, max_ilp) -- chunks exactly as the Python
     * generator yields them (an empty tail chunk, were one possible,
     * would still consume a partition index) */
    long long L = (long long)comp.size();
    long long pch = (L + max_ilp - 1) / max_ilp;
    long long s = (L + pch - 1) / pch;
    for (long long lo = 0; lo < pch * s; lo += s) {
      long long hi = lo + s < L ? lo + s : L;
      if (hi < lo) hi = lo;
      Partition part;
      for (long long k = lo; k < hi; ++k)
        for (int r : members[(size_t)comp[(size_t)k]])
          part.rids.push_back(r);
      /* expand_nonedges: unordered unique pairs without a surviving
       * edge, pair-major / r1-major cross products */
      for (long long a = lo; a < hi; ++a) {
        int ci = comp[(size_t)a];
        const uint64_t* arow = &adjw[(size_t)ci * Wp];
        for (long long b = a + 1; b < hi; ++b) {
          int cj = comp[(size_t)b];
          if (arow[(size_t)(cj >> 6)] & (1ull << (cj & 63))) continue;
          for (int r1 : members[(size_t)ci])
            for (int r2 : members[(size_t)cj])
              part.incomp.emplace_back(r1, r2);
        }
      }
      parts.push_back(std::move(part));
    }
  }
}

/* -------------------------------------------------------- round loop */

struct Isoform {
  std::string exons;  // M chars '0'/'1'
  std::vector<std::pair<int, std::string>> corrections;  // (rep, M chars)
};

/* Runs cluster_tint's per-partition rounds (py/freddie_cluster.py:
 * 694-773; stages/cluster.py:cluster_tint) against the in-process
 * solve_round. Returns 0 ok, 1 needs-Python (escalation rung), 2 error. */
int run_rounds(TintC& t, const Prep& pp, std::vector<Partition>& parts,
               long long eps_scale, long long eps_scaled, long long offset,
               long long max_rounds, long long min_isoform_size,
               double deadline_s, long long node_budget,
               long long closure_max_segs, long long closure_cap,
               long long bounds_device_min, std::vector<Isoform>& isoforms,
               std::vector<int>& garbage_rids, CluError& err) {
  const long long M = t.M;
  std::vector<int64_t> seg_len_all((size_t)M);
  for (long long j = 0; j < M; ++j)
    seg_len_all[(size_t)j] = t.positions[(size_t)j + 1] - t.positions[(size_t)j];

  for (size_t p_idx = 0; p_idx < parts.size(); ++p_idx) {
    Partition& part = parts[p_idx];
    for (int rep : part.rids)
      for (int ridx : t.reps[(size_t)rep])
        t.reads[(size_t)ridx].partition = (int)p_idx;
    std::vector<int> remaining = part.rids;

    // Per-partition closure cache: rounds shrink monotonically, so the
    // first escalated round's closure is filtered (never rebuilt) by
    // later escalations in this partition (see round_solver.cpp).
    struct CacheGuard {
      void* p;
      CacheGuard() : p(closure_cache_new()) {}
      ~CacheGuard() { closure_cache_free(p); }
    } ccache;

    for (long long round = 0; round < max_rounds; ++round) {
      long long mult_left = 0;
      for (int r : remaining) mult_left += (long long)t.reps[(size_t)r].size();
      if (mult_left < min_isoform_size) break;
      if (remaining.empty()) { err.fail("assert", "empty remaining"); return 2; }
      const int n = (int)remaining.size();

      /* informative segments (py/freddie_cluster.py:331-344) */
      std::vector<char> informative((size_t)M, 1);
      if (M > 2) {
        std::vector<char> constant((size_t)M, 1);
        const uint8_t* ref = &pp.I[(size_t)remaining[0] * (size_t)M];
        for (int k = 1; k < n; ++k) {
          const uint8_t* row = &pp.I[(size_t)remaining[(size_t)k] * (size_t)M];
          for (long long j = 0; j < M; ++j)
            if (row[(size_t)j] != ref[(size_t)j]) constant[(size_t)j] = 0;
        }
        for (long long j = 1; j + 1 < M; ++j)
          if (constant[(size_t)j - 1] && constant[(size_t)j] &&
              constant[(size_t)j + 1] && ref[(size_t)j - 1] == ref[(size_t)j] &&
              ref[(size_t)j] == ref[(size_t)j + 1])
            informative[(size_t)j] = 0;
      }
      std::vector<int> inf_idx;
      inf_idx.reserve((size_t)M);
      for (long long j = 0; j < M; ++j)
        if (informative[(size_t)j]) inf_idx.push_back((int)j);
      const int Mi = (int)inf_idx.size();

      /* build the round instance (stages/cluster.py:build_instance) */
      std::vector<uint8_t> sub_I((size_t)n * (size_t)Mi),
          sub_C((size_t)n * (size_t)Mi);
      std::vector<double> garbage((size_t)n);
      std::vector<int64_t> seg_len((size_t)Mi);
      for (int c = 0; c < Mi; ++c)
        seg_len[(size_t)c] = seg_len_all[(size_t)inf_idx[(size_t)c]];
      std::vector<int32_t> gap_counts((size_t)n, 0);
      std::vector<int32_t> gap_lo, gap_hi;
      std::vector<int64_t> gap_len;
      for (int k = 0; k < n; ++k) {
        int r = remaining[(size_t)k];
        const uint8_t* I_row = &pp.I[(size_t)r * (size_t)M];
        const uint8_t* C_row = &pp.C[(size_t)r * (size_t)M];
        for (int c = 0; c < Mi; ++c) {
          sub_I[(size_t)k * Mi + (size_t)c] = I_row[(size_t)inf_idx[(size_t)c]];
          sub_C[(size_t)k * Mi + (size_t)c] = C_row[(size_t)inf_idx[(size_t)c]];
        }
        garbage[(size_t)k] = pp.garbage[(size_t)r];
        const auto& rg = pp.rep_gaps[(size_t)r];
        gap_counts[(size_t)k] = (int32_t)rg.size();
        for (const auto& gp : rg) {
          /* searchsorted(inf_idx, j1+1) / searchsorted(inf_idx, j2) */
          int lo = (int)(std::lower_bound(inf_idx.begin(), inf_idx.end(),
                                          (int)(gp[0] + 1)) -
                         inf_idx.begin());
          int hi = (int)(std::lower_bound(inf_idx.begin(), inf_idx.end(),
                                          (int)gp[1]) -
                         inf_idx.begin());
          gap_lo.push_back(lo);
          gap_hi.push_back(hi);
          gap_len.push_back(gp[2]);
        }
      }
      /* surviving incompatible pairs -> round positions, input order */
      std::vector<int> pos_of(t.reps.size(), -1);
      for (int k = 0; k < n; ++k) pos_of[(size_t)remaining[(size_t)k]] = k;
      std::vector<int32_t> incomp;
      for (const auto& pr : part.incomp) {
        int pa = pos_of[(size_t)pr.first], pb = pos_of[(size_t)pr.second];
        if (pa >= 0 && pb >= 0) {
          incomp.push_back(pa);
          incomp.push_back(pb);
        }
      }

      /* solve (bit-equal twin of solver/two_phase.solve_two_phase's
       * consolidated native path) */
      std::vector<int32_t> out_assigned((size_t)(n > 0 ? n : 1));
      int32_t out_n = 0;
      double out_obj = 0.0;
      int words = (Mi + 63) / 64 > 0 ? (Mi + 63) / 64 : 1;
      std::vector<uint64_t> out_E((size_t)words, 0);
      int64_t out_nodes = 0;
      int status;
      if (n == 0) {
        status = 0;  /* mirrors solve_round_native's N==0 OPTIMAL-empty */
      } else {
        if (gap_lo.empty()) { gap_lo.push_back(0); gap_hi.push_back(0); gap_len.push_back(0); }
        status = solve_round_cached(
            n, Mi, sub_I.data(), sub_C.data(), garbage.data(), seg_len.data(),
            gap_counts.data(), gap_lo.data(), gap_hi.data(), gap_len.data(),
            (int)(incomp.size() / 2),
            incomp.empty() ? (const int32_t*)gap_counts.data() : incomp.data(),
            eps_scale, eps_scaled, offset, deadline_s, node_budget,
            closure_max_segs, closure_cap, bounds_device_min,
            ccache.p, (const int32_t*)remaining.data(),
            (const int32_t*)inf_idx.data(),
            out_assigned.data(), &out_n, &out_obj, out_E.data(), &out_nodes);
      }
      if (status == 2 || status == 4 || status == 5) return 1;  /* Python */
      if (status == 1) break;  /* TIMEOUT: partition leftovers -> garbage */

      /* assigned round positions are ascending; map to rep ids in
       * `remaining` order (identical to the enumerate() filter) */
      std::vector<int> assigned;
      assigned.reserve((size_t)out_n);
      long long assigned_mult = 0;
      for (int32_t i = 0; i < out_n; ++i) {
        int r = remaining[(size_t)out_assigned[(size_t)i]];
        assigned.push_back(r);
        assigned_mult += (long long)t.reps[(size_t)r].size();
      }
      if (assigned_mult < min_isoform_size) break;

      /* isoform exons: solver E on informative cols, the (constant)
       * min-rep row elsewhere (py/freddie_cluster.py:602-610) */
      int min_rep = remaining[0];
      for (int r : remaining)
        if (r < min_rep) min_rep = r;
      const uint8_t* ref_row = &pp.I[(size_t)min_rep * (size_t)M];
      Isoform iso;
      iso.exons.assign((size_t)M, '0');
      std::vector<char> exon_bit((size_t)M, 0);
      {
        int c = 0;
        for (long long j = 0; j < M; ++j) {
          if (informative[(size_t)j]) {
            int bit = (int)((out_E[(size_t)(c >> 6)] >> (c & 63)) & 1);
            exon_bit[(size_t)j] = (char)bit;
            ++c;
          } else {
            exon_bit[(size_t)j] = (char)ref_row[(size_t)j];
          }
          iso.exons[(size_t)j] = (char)('0' + exon_bit[(size_t)j]);
        }
      }
      for (int r : assigned) {
        const ReadC& rd = t.reads[(size_t)t.reps[(size_t)r][0]];
        const uint8_t* C_row = &pp.C[(size_t)r * (size_t)M];
        std::string corr((size_t)M, '-');
        for (long long j = 0; j < M; ++j) {
          if (!informative[(size_t)j]) continue;
          if (C_row[(size_t)j] == 1 && exon_bit[(size_t)j] == 1)
            corr[(size_t)j] = 'X';
          else
            corr[(size_t)j] = rd.data[(size_t)j];
        }
        iso.corrections.emplace_back(r, std::move(corr));
      }
      isoforms.push_back(std::move(iso));

      std::vector<char> is_assigned(t.reps.size(), 0);
      for (int r : assigned) is_assigned[(size_t)r] = 1;
      std::vector<int> next;
      next.reserve(remaining.size());
      for (int r : remaining)
        if (!is_assigned[(size_t)r]) next.push_back(r);
      remaining.swap(next);
    }
    std::sort(remaining.begin(), remaining.end());
    for (int r : remaining) garbage_rids.push_back(r);
  }
  return 0;
}

/* ------------------------------------------------------------ format
 * Byte-identical to freddie_jax/io/tsv.py:format_cluster_tsv (itself
 * the reference's writer, py/freddie_cluster.py:639-691). */
void emit_read_row(std::string& out, const TintC& t, const Prep& pp,
                   int ridx, const char* iid, size_t iid_len,
                   const std::string& corrections) {
  const ReadC& rd = t.reads[(size_t)ridx];
  const long long M = t.M;
  append_ll(out, rd.id);
  out += '\t';
  out += rd.name;
  out += '\t';
  out += t.chrom;
  out += '\t';
  out += rd.strand;
  out += '\t';
  append_ll(out, rd.tint);
  out += '\t';
  append_ll(out, rd.partition);
  out += '\t';
  out += rd.category;
  out += '\t';
  out.append(iid, iid_len);
  out += '\t';
  out += corrections;
  /* per-column strings with the rep's gaps appended at j1 (the virtual
   * start gap's j1 = -1 lands on the LAST column -- Python negative
   * indexing, preserved deliberately) */
  const auto& rg = pp.rep_gaps[(size_t)rd.rep];
  std::vector<std::string> extra;  /* lazy: most columns have none */
  for (const auto& gp : rg) {
    long long j1 = gp[0];
    if (j1 < 0) j1 += M;
    if (extra.empty()) extra.resize((size_t)M);
    char buf[32];
    int nn = snprintf(buf, sizeof(buf), "(%lld)", gp[2]);
    extra[(size_t)j1].append(buf, (size_t)nn);
  }
  for (long long j = 0; j < M; ++j) {
    out += '\t';
    out += corrections[(size_t)j];
    if (!extra.empty() && !extra[(size_t)j].empty()) out += extra[(size_t)j];
  }
  /* sorted(poly_tail.items()): "K:(len, gap)" -- Python tuple repr */
  std::vector<std::pair<std::string, const PolyTok*>> toks;
  for (const auto& pt : rd.poly) {
    std::string k;
    k += pt.k0;
    k += pt.k1;
    toks.emplace_back(std::move(k), &pt);
  }
  std::sort(toks.begin(), toks.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  for (const auto& kv : toks) {
    out += '\t';
    out += kv.first;
    out += ":(";
    append_ll(out, kv.second->len);
    out += ", ";
    append_ll(out, kv.second->gap);
    out += ')';
  }
  out += '\n';
}

void format_tsv(const TintC& t, const Prep& pp,
                const std::vector<Isoform>& isoforms,
                const std::vector<int>& garbage_rids, std::string& out) {
  out.reserve(1 << 16);
  out += '#';
  out += t.chrom;
  out += '\t';
  append_ll(out, t.id);
  out += '\t';
  for (size_t i = 0; i < t.positions.size(); ++i) {
    if (i) out += ',';
    append_ll(out, t.positions[i]);
  }
  out += '\n';
  char iid_buf[24];
  for (size_t iid = 0; iid < isoforms.size(); ++iid) {
    const Isoform& iso = isoforms[iid];
    out += "isoform_";
    append_ll(out, (long long)iid);
    out += '\t';
    append_ll(out, t.id);
    out += '\t';
    out += iso.exons;
    out += '\n';
    int nn = snprintf(iid_buf, sizeof(iid_buf), "%lld", (long long)iid);
    for (const auto& rc : iso.corrections)
      for (int ridx : t.reps[(size_t)rc.first])
        emit_read_row(out, t, pp, ridx, iid_buf, (size_t)nn, rc.second);
  }
  for (int rep : garbage_rids)
    for (int ridx : t.reps[(size_t)rep]) {
      const std::string& corr = t.reads[(size_t)ridx].data;
      emit_read_row(out, t, pp, ridx, "*", 1, corr);
    }
}

/* ---------------------------------------------------------- binding */

PyObject* clucore_cluster_tint(PyObject* self, PyObject* args) {
  const char* path;
  int recycle_model;
  long long eps_scale, eps_scaled, offset, max_rounds, min_isoform_size,
      max_ilp, node_budget, closure_max_segs, closure_cap, bounds_device_min;
  double deadline_s;
  if (!PyArg_ParseTuple(args, "siLLLLLLdLLLL", &path, &recycle_model,
                        &eps_scale, &eps_scaled, &offset, &max_rounds,
                        &min_isoform_size, &max_ilp, &deadline_s,
                        &node_budget, &closure_max_segs, &closure_cap,
                        &bounds_device_min))
    return NULL;
  TintC t;
  Prep pp;
  std::vector<Partition> parts;
  std::vector<Isoform> isoforms;
  std::vector<int> garbage_rids;
  std::string out;
  CluError err;
  int rc = 0;
  Py_BEGIN_ALLOW_THREADS
  if (!parse_segment(path, t, err) ||
      !preprocess(t, recycle_model, pp, err)) {
    rc = 2;
  } else {
    partition_reads(t, pp, max_ilp, parts);
    rc = run_rounds(t, pp, parts, eps_scale, eps_scaled, offset, max_rounds,
                    min_isoform_size, deadline_s, node_budget,
                    closure_max_segs, closure_cap, bounds_device_min,
                    isoforms, garbage_rids, err);
    if (rc == 0) format_tsv(t, pp, isoforms, garbage_rids, out);
  }
  Py_END_ALLOW_THREADS
  if (rc == 2) {
    PyObject* type = PyExc_AssertionError;
    if (err.set && strcmp(err.type, "value") == 0) type = PyExc_ValueError;
    else if (err.set && strcmp(err.type, "os") == 0) type = PyExc_OSError;
    PyErr_SetString(type, err.set ? err.msg.c_str() : "clucore failed");
    return NULL;
  }
  if (rc == 1) Py_RETURN_NONE;  /* needs a Python escalation rung */
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

PyMethodDef Methods[] = {
    {"cluster_tint", clucore_cluster_tint, METH_VARARGS,
     "Cluster one tint end to end; bytes, or None when a Python "
     "escalation rung is required."},
    {NULL, NULL, 0, NULL}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "clucore", NULL, -1,
                                Methods};

}  // namespace

PyMODINIT_FUNC PyInit_clucore(void) { return PyModule_Create(&moduledef); }
