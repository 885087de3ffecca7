/* CPython extension: native engine for the isoforms stage.
 *
 *   tint_gtf(cluster_tsv, split_tsv, majority, window)
 *     -> [(chrom, start0, text), ...]
 *
 * One call runs a whole tint: parse the cluster TSV
 * (freddie_jax/io/tsv.py:parse_cluster_tsv; reference
 * py/freddie_isoforms.py:159-200), per-isoform consensus voting
 * (:203-250 incl. the S-tail both-ends quirk), alignment-boundary
 * parsing from the split TSV (:143-156), boundary correction with the
 * reference's last-qualifying-offset rule (:122-140), and GTF record
 * assembly (:84-118, 1-based transcript start vs raw 0-based exon
 * start). Returns the records exactly as stages/isoforms.tint_isoforms
 * does; the Python implementation stays the semantic oracle and
 * transparent per-tint fallback (tests/test_isocore.py pins byte
 * parity). Ratio thresholds: the exonic vote (x/c > 0.5) is the exact
 * integer compare 2x > c (0.5 cases are representable; non-equal cases
 * clear any float rounding); the boundary majority uses the SAME IEEE
 * double division as Python for arbitrary thresholds.
 *
 * Build: g++ -O2 -shared -fPIC -I<python-include> -o isocore.so isocore.cpp
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct IsoError {
  const char* type = "assert";
  std::string msg;
  bool set = false;
  void fail(const char* t, const std::string& m) {
    if (!set) { type = t; msg = m; set = true; }
  }
};

struct IRead {
  long long rid;
  char tail;          // 'N' | 'S' | 'E'
  std::string data;   // 01X- correction chars
  std::vector<long long> starts, ends;  // alignment boundaries (split TSV)
};

struct IIsoform {
  long long pid, iid;
  std::vector<int> rids;  // indices into reads
  // filled by consensus:
  bool has_spans = false;
  char strand = '+';
  std::vector<long long> starts, ends;  // exon spans (genomic)
};

long long parse_ll(const char** p, const char* end) {
  const char* s = *p;
  if (s >= end || *s < '0' || *s > '9') return -1;
  long long v = 0;
  while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  *p = s;
  return v;
}

bool read_file(const char* path, std::vector<char>& buf, IsoError& err) {
  FILE* f = fopen(path, "rb");
  if (!f) { err.fail("os", std::string("cannot open ") + path); return false; }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize((size_t)fsize + 1);
  if (fsize > 0 && fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    err.fail("os", "short read");
    return false;
  }
  fclose(f);
  buf[(size_t)fsize] = '\n';
  return true;
}

/* next tab-separated field in [q, lend); returns false when none left */
bool next_field(const char*& q, const char* lend, const char*& fs,
                const char*& fe) {
  if (q > lend) return false;
  fs = q;
  const char* t = (const char*)memchr(q, '\t', (size_t)(lend - q));
  fe = t ? t : lend;
  q = t ? t + 1 : lend + 1;
  return true;
}

struct TintData {
  std::string chrom;
  long long tint = -1;
  std::vector<std::pair<long long, long long>> segs;
  std::vector<IRead> reads;
  std::unordered_map<long long, int> read_of;  // rid -> index
  std::vector<IIsoform> isoforms;  // first-seen (pid, iid) order
  std::unordered_map<long long, int> iso_of;   // pid*2^32+iid -> index
};

/* ------------------------------------------------- cluster TSV parse */
bool parse_cluster(const char* path, TintData& t, IsoError& err) {
  std::vector<char> buf;
  if (!read_file(path, buf, err)) return false;
  const char* p = buf.data();
  const char* bend = buf.data() + (buf.size() - 1);
  while (p < bend) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend) continue;
    if (*line == '#') {
      const char* q = line;
      const char *fs, *fe;
      if (!next_field(q, lend, fs, fe)) { err.fail("value", "bad header"); return false; }
      t.chrom.assign(fs + 1, (size_t)(fe - fs - 1));
      if (!next_field(q, lend, fs, fe)) { err.fail("value", "bad header"); return false; }
      const char* v = fs;
      t.tint = parse_ll(&v, fe);
      if (t.tint < 0 || v != fe) { err.fail("value", "bad header tint"); return false; }
      if (!next_field(q, lend, fs, fe)) { err.fail("value", "bad header"); return false; }
      std::vector<long long> pos;
      const char* s = fs;
      while (s < fe) {
        long long x = parse_ll(&s, fe);
        if (x < 0) { err.fail("value", "bad header position"); return false; }
        pos.push_back(x);
        if (s < fe && *s == ',') { ++s; continue; }
        break;
      }
      if (s != fe || pos.size() < 2) { err.fail("value", "bad header positions"); return false; }
      for (size_t i = 0; i + 1 < pos.size(); ++i)
        t.segs.emplace_back(pos[i], pos[i + 1]);
      continue;
    }
    if (lend - line >= 8 && memcmp(line, "isoform_", 8) == 0) continue;
    /* rid name chrom strand tint pid tail iid data ... */
    const char* q = line;
    const char *fs, *fe;
    const char *f[9][2];
    for (int i = 0; i < 9; ++i) {
      if (!next_field(q, lend, fs, fe)) { err.fail("value", "row: too few fields"); return false; }
      f[i][0] = fs;
      f[i][1] = fe;
    }
    if (f[7][1] - f[7][0] == 1 && *f[7][0] == '*') continue;  /* garbage */
    const char* v = f[0][0];
    long long rid = parse_ll(&v, f[0][1]);
    if (rid < 0 || v != f[0][1]) { err.fail("value", "row: bad rid"); return false; }
    v = f[5][0];
    long long pid = parse_ll(&v, f[5][1]);
    if (pid < 0 || v != f[5][1]) { err.fail("value", "row: bad pid"); return false; }
    if (f[6][1] - f[6][0] != 1) { err.fail("value", "row: bad tail"); return false; }
    char tail = *f[6][0];
    v = f[7][0];
    long long iid = parse_ll(&v, f[7][1]);
    if (iid < 0 || v != f[7][1]) { err.fail("value", "row: bad iid"); return false; }
    if ((size_t)(f[8][1] - f[8][0]) != t.segs.size()) {
      err.fail("assert", "row: data length != segment count");
      return false;
    }
    IRead rd;
    rd.rid = rid;
    rd.tail = tail;
    rd.data.assign(f[8][0], (size_t)(f[8][1] - f[8][0]));
    int ridx = (int)t.reads.size();
    if (!t.read_of.emplace(rid, ridx).second) {
      err.fail("assert", "row: duplicate rid");
      return false;
    }
    t.reads.push_back(std::move(rd));
    long long key = (pid << 32) | (iid & 0xffffffffLL);
    auto it = t.iso_of.find(key);
    int ii;
    if (it == t.iso_of.end()) {
      ii = (int)t.isoforms.size();
      t.iso_of.emplace(key, ii);
      t.isoforms.emplace_back();
      t.isoforms.back().pid = pid;
      t.isoforms.back().iid = iid;
    } else {
      ii = it->second;
    }
    t.isoforms[(size_t)ii].rids.push_back(ridx);
  }
  if (t.tint < 0) { err.fail("assert", "no tint header"); return false; }
  return true;
}

/* ------------------------------------- split TSV alignment boundaries */
bool parse_boundaries(const char* path, TintData& t, IsoError& err) {
  std::vector<char> buf;
  if (!read_file(path, buf, err)) return false;
  const char* p = buf.data();
  const char* bend = buf.data() + (buf.size() - 1);
  while (p < bend) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(bend - p + 1));
    if (!eol) eol = bend;
    const char* line = p;
    const char* lend = eol;
    p = eol + 1;
    if (line == lend || *line == '#') continue;
    const char* q = line;
    long long rid = parse_ll(&q, lend);
    if (rid < 0 || q >= lend || *q != '\t') { err.fail("value", "split row: bad rid"); return false; }
    auto it = t.read_of.find(rid);
    if (it == t.read_of.end()) continue;
    IRead& rd = t.reads[(size_t)it->second];
    /* skip name, chrom, strand, tint */
    const char *fs, *fe;
    ++q;
    for (int i = 0; i < 4; ++i)
      if (!next_field(q, lend, fs, fe)) { err.fail("value", "split row: too few fields"); return false; }
    /* interval tokens: "ts-te:..." */
    while (next_field(q, lend, fs, fe)) {
      const char* v = fs;
      long long a = parse_ll(&v, fe);
      if (a < 0 || v >= fe || *v != '-') { err.fail("value", "split row: bad interval"); return false; }
      ++v;
      long long b = parse_ll(&v, fe);
      if (b < 0) { err.fail("value", "split row: bad interval end"); return false; }
      if (!(a < b)) { err.fail("assert", "split row: empty interval"); return false; }
      rd.starts.push_back(a);
      rd.ends.push_back(b);
    }
  }
  return true;
}

/* --------------------------------------------------------- consensus */
void consensus(TintData& t) {
  const size_t M = t.segs.size();
  std::vector<long long> cons(M), cov(M);
  for (IIsoform& iso : t.isoforms) {
    std::fill(cons.begin(), cons.end(), 0);
    std::fill(cov.begin(), cov.end(), 0);
    long long tails_S = 0, tails_E = 0;
    for (int ridx : iso.rids) {
      const IRead& rd = t.reads[(size_t)ridx];
      size_t first = rd.data.find('1');
      if (first == std::string::npos) continue;
      size_t last = rd.data.rfind('1');
      if (rd.tail == 'S') { first = 0; last = M - 1; }
      for (size_t j = first; j <= last; ++j) {
        cons[j] += rd.data[j] == '1';
        cov[j] += 1;
      }
      if (rd.tail == 'S') ++tails_S;
      else if (rd.tail == 'E') ++tails_E;
    }
    /* exonic: x >= 3 and x/c > 0.5 (== 2x > c exactly) */
    bool any = false;
    std::vector<char> flags(M, 0);
    for (size_t j = 0; j < M; ++j)
      if (cons[j] >= 3 && 2 * cons[j] > cov[j]) { flags[j] = 1; any = true; }
    if (!any) continue;
    iso.has_spans = true;
    iso.strand = tails_S > tails_E ? '-' : '+';
    size_t j = 0;
    while (j < M) {
      if (!flags[j]) { ++j; continue; }
      size_t k = j;
      while (k + 1 < M && flags[k + 1]) ++k;
      iso.starts.push_back(t.segs[j].first);
      iso.ends.push_back(t.segs[k].second);
      j = k + 1;
    }
  }
}

/* ------------------------------------------------ boundary correction
 * py/freddie_isoforms.py:122-140: votes over offsets -window..window,
 * scanned ascending, the LAST offset with v/n >= majority wins. */
void correct(TintData& t, bool side_starts, double majority, long long window) {
  if (window == 0) return;
  std::vector<long long> votes((size_t)(2 * window + 1));
  for (IIsoform& iso : t.isoforms) {
    if (!iso.has_spans) continue;
    const long long n = (long long)iso.rids.size();
    std::vector<long long>& pos = side_starts ? iso.starts : iso.ends;
    for (size_t idx = 0; idx < pos.size(); ++idx) {
      const long long iso_pos = pos[idx];
      std::fill(votes.begin(), votes.end(), 0);
      for (int ridx : iso.rids) {
        const IRead& rd = t.reads[(size_t)ridx];
        const std::vector<long long>& bps = side_starts ? rd.starts : rd.ends;
        for (long long bp : bps) {
          long long x = bp - iso_pos;
          if (-window <= x && x <= window) ++votes[(size_t)(x + window)];
        }
      }
      for (long long x = -window; x <= window; ++x)
        if ((double)votes[(size_t)(x + window)] / (double)n >= majority)
          pos[idx] = x + iso_pos;
    }
  }
}

/* --------------------------------------------------------------- GTF */
void append_ll(std::string& out, long long v) {
  char b[24];
  int n = snprintf(b, sizeof(b), "%lld", v);
  out.append(b, (size_t)n);
}

PyObject* emit_records(const TintData& t) {
  PyObject* out = PyList_New(0);
  if (!out) return NULL;
  std::string text, name;
  for (const IIsoform& iso : t.isoforms) {
    if (!iso.has_spans) continue;
    name.clear();
    name += t.chrom;
    name += '_';
    append_ll(name, t.tint);
    name += '_';
    append_ll(name, iso.iid);
    text.clear();
    text += t.chrom;
    text += "\tfreddie\ttranscript\t";
    append_ll(text, iso.starts[0] + 1);
    text += '\t';
    append_ll(text, iso.ends.back());
    text += "\t.\t";
    text += iso.strand;
    text += "\t.\ttranscript_id \"";
    text += name;
    text += "\"; read_support \"";
    append_ll(text, (long long)iso.rids.size());
    text += "\";";
    for (size_t e = 0; e < iso.starts.size(); ++e) {
      text += '\n';
      text += t.chrom;
      text += "\tfreddie\texon\t";
      append_ll(text, iso.starts[e]);
      text += '\t';
      append_ll(text, iso.ends[e]);
      text += "\t.\t";
      text += iso.strand;
      text += "\t.\ttranscript_id \"";
      text += name;
      text += "\"; exon_number \"";
      append_ll(text, (long long)(e + 1));
      text += "\"; exon_id \"";
      text += name;
      text += '_';
      append_ll(text, (long long)(e + 1));
      text += "\"; ";
    }
    PyObject* rec = Py_BuildValue(
        "(s#Ls#)", t.chrom.data(), (Py_ssize_t)t.chrom.size(),
        iso.starts[0], text.data(), (Py_ssize_t)text.size());
    if (!rec || PyList_Append(out, rec) < 0) {
      Py_XDECREF(rec);
      Py_DECREF(out);
      return NULL;
    }
    Py_DECREF(rec);
  }
  return out;
}

/* ----------------------------------------------------------- binding */
PyObject* isocore_tint_gtf(PyObject* self, PyObject* args) {
  const char* cluster_path;
  const char* split_path;
  double majority;
  long long window;
  if (!PyArg_ParseTuple(args, "ssdL", &cluster_path, &split_path, &majority,
                        &window))
    return NULL;
  TintData t;
  IsoError err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = parse_cluster(cluster_path, t, err);
  if (ok) {
    consensus(t);
    ok = parse_boundaries(split_path, t, err);
    if (ok && window != 0) {
      /* Python raises KeyError when a correction dereferences a read
       * absent from the split TSV; decline to the oracle path there. */
      for (const IIsoform& iso : t.isoforms) {
        if (!iso.has_spans) continue;
        for (int ridx : iso.rids)
          if (t.reads[(size_t)ridx].starts.empty()) {
            err.fail("assert", "read missing from split TSV");
            ok = false;
          }
      }
    }
    if (ok) {
      correct(t, true, majority, window);
      correct(t, false, majority, window);
    }
  }
  Py_END_ALLOW_THREADS
  if (!ok) {
    PyObject* type = PyExc_AssertionError;
    if (err.set && strcmp(err.type, "value") == 0) type = PyExc_ValueError;
    else if (err.set && strcmp(err.type, "os") == 0) type = PyExc_OSError;
    PyErr_SetString(type, err.set ? err.msg.c_str() : "isocore failed");
    return NULL;
  }
  return emit_records(t);
}

PyMethodDef Methods[] = {
    {"tint_gtf", isocore_tint_gtf, METH_VARARGS,
     "One tint's GTF records: [(chrom, start0, text), ...]."},
    {NULL, NULL, 0, NULL}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "isocore", NULL, -1,
                                Methods};

}  // namespace

PyMODINIT_FUNC PyInit_isocore(void) { return PyModule_Create(&moduledef); }
