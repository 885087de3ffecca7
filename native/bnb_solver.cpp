// Exact branch-and-bound core for the cluster-assignment problem.
//
// Native twin of freddie_jax/solver/exact.py (same algorithm, same
// deterministic order, bit-identical results): DFS over reads in
// heaviest-garbage-first order, assign-branch first, admissible lower
// bound from monotone correction costs, interval pruning of unaligned-gap
// windows with scaled-integer epsilon comparisons, strict-improvement
// incumbent updates, wall-clock deadline.
//
// The reference delegates this work to Gurobi (C++) behind gurobipy
// (/root/reference/py/freddie_cluster.py:13,347-636); this is the
// replacement's hot path. Bitsets are uint64 words; N<=1000 reads and
// M<=a few hundred informative segments per instance (SURVEY.md section 6
// problem caps).
//
// Build: g++ -O2 -shared -fPIC -o libbnb.so bnb_solver.cpp
// ABI: solve_bnb() below; Python binds via ctypes
// (freddie_jax/solver/native.py).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Gap {
  const uint64_t* mask;  // [words]
  int64_t l;
};

struct Ctx {
  int n_reads;
  int words;
  const uint64_t* exons;    // [n_reads][words]
  const uint64_t* corr;     // [n_reads][words]
  const double* garbage;    // [n_reads]
  const int64_t* seg_len;   // [n_segs] (n_segs <= 64*words)
  std::vector<std::vector<Gap>> gaps;       // per read (in DFS order)
  std::vector<std::vector<uint64_t>> conflict;  // per read: bitset over DFS positions
  std::vector<char> has_forward_conflict;       // any conflict with position > p
  int64_t sc, eps, off;
  double best_obj;
  std::vector<int> best_set;
  std::vector<uint64_t> best_E;
  std::vector<int> chosen;
  std::vector<uint64_t> suffix_or;  // [(n_reads+1)][words]
  std::chrono::steady_clock::time_point t_end;
  long nodes;
  long node_budget;  // 0 = unlimited; else deterministic stop
  bool timed_out;
  bool budget_out;
  std::vector<uint64_t> chosen_bits;  // bitset over DFS positions
  // excluded[q] = how many chosen positions conflict with q: such q MUST
  // be rejected in every completion, so the lower bound can charge their
  // full garbage instead of min(corr, garbage). Still admissible (it is
  // the exact future cost for those reads), so the canonical first-found
  // optimum is unchanged; dense-conflict instances prune far earlier.
  std::vector<int32_t> excluded;
  // Version-stamped cache of popcount(corr[q] & E_cur): E changes only
  // on exon-adding assignments, so long reject chains reuse every
  // entry. Pure mechanics -- identical values, identical bounds,
  // identical node counts (the Python twin recomputes the same values).
  std::vector<double> cc_val;
  std::vector<int64_t> cc_ver;
  int64_t e_ver_counter;
  // Greedy clique cover of the conflict graph (DFS order, first-fit):
  // clique members mutually conflict, so at most ONE read per clique can
  // be assigned in any completion -- the lower bound grants only the best
  // single saving per clique. Conflict-free reads sit in singleton
  // cliques (bound unchanged there). Twin of the identical construction
  // in freddie_jax/solver/exact.py; all bound terms are exact multiples
  // of 0.5 in double, so the twins' node paths stay bit-equal.
  std::vector<int32_t> clique_id;
  int n_cliques;
  std::vector<double> clique_max;    // per-clique best saving (epoch-gated)
  std::vector<long> clique_epoch;    // node stamp for clique_max validity
  std::vector<double> suffix_garbage;  // [n_reads+1]
};

inline void bump_conflicts(Ctx& c, int p, int delta) {
  const std::vector<uint64_t>& row = c.conflict[p];
  for (size_t w = 0; w < row.size(); ++w) {
    uint64_t bits = row[w];
    while (bits) {
      int b = __builtin_ctzll(bits);
      c.excluded[(w << 6) + b] += delta;
      bits &= bits - 1;
    }
  }
}

inline int popcount_and(const uint64_t* a, const uint64_t* b, int words) {
  int c = 0;
  for (int w = 0; w < words; ++w) c += __builtin_popcountll(a[w] & b[w]);
  return c;
}

inline int64_t masked_len_sum(const uint64_t* mask, const uint64_t* E,
                              const int64_t* seg_len, int words) {
  int64_t s = 0;
  for (int w = 0; w < words; ++w) {
    uint64_t bits = mask[w] & E[w];
    while (bits) {
      int b = __builtin_ctzll(bits);
      s += seg_len[w * 64 + b];
      bits &= bits - 1;
    }
  }
  return s;
}

inline bool gap_ok(int64_t lo, int64_t hi, int64_t l, const Ctx& c) {
  // feasible iff (1-e)*lo - off <= l and l <= (1+e)*hi + off, scaled.
  return (c.sc - c.eps) * lo <= c.sc * (l + c.off) &&
         c.sc * (l - c.off) <= (c.sc + c.eps) * hi;
}

bool gaps_feasible(const Ctx& c, int p, const uint64_t* E_lo,
                   const uint64_t* E_hi) {
  for (const Gap& g : c.gaps[p]) {
    int64_t lo = masked_len_sum(g.mask, E_lo, c.seg_len, c.words);
    int64_t hi = masked_len_sum(g.mask, E_hi, c.seg_len, c.words);
    if (!gap_ok(lo, hi, g.l, c)) return false;
  }
  return true;
}

// Gaps of p satisfied for EVERY final E in [E_lo, E_hi]: both constraint
// sides must hold at their worst extreme.
bool gaps_always_feasible(const Ctx& c, int p, const uint64_t* E_lo,
                          const uint64_t* E_hi) {
  for (const Gap& g : c.gaps[p]) {
    int64_t lo = masked_len_sum(g.mask, E_lo, c.seg_len, c.words);
    int64_t hi = masked_len_sum(g.mask, E_hi, c.seg_len, c.words);
    if (!((c.sc - c.eps) * hi <= c.sc * (g.l + c.off) &&
          c.sc * (g.l - c.off) <= (c.sc + c.eps) * lo))
      return false;
  }
  return true;
}

inline double cc_of(Ctx& c, int q, const uint64_t* E, int64_t ver) {
  if (c.cc_ver[q] == ver) return c.cc_val[q];
  double v = popcount_and(c.corr + (size_t)q * c.words, E, c.words);
  c.cc_val[q] = v;
  c.cc_ver[q] = ver;
  return v;
}

void recurse(Ctx& c, int p, std::vector<uint64_t>& E_cur,
             double rejected_cost, int64_t e_ver) {
  if (c.timed_out || c.budget_out) return;
  ++c.nodes;
  if (c.node_budget && c.nodes > c.node_budget) {
    c.budget_out = true;
    return;
  }
  if (c.nodes % 4096 == 0 &&
      std::chrono::steady_clock::now() > c.t_end) {
    c.timed_out = true;
    return;
  }
  const int W = c.words;
  if (p == c.n_reads) {
    double obj = rejected_cost;
    for (int q : c.chosen)
      obj += cc_of(c, q, E_cur.data(), e_ver);
    if (obj < c.best_obj) {
      for (int q : c.chosen)
        if (!gaps_feasible(c, q, E_cur.data(), E_cur.data())) return;
      c.best_obj = obj;
      c.best_set = c.chosen;
      c.best_E = E_cur;
    }
    return;
  }
  // Lower bound: every undecided read charged its garbage, minus at most
  // one saving per conflict clique (see clique_id above). Excluded reads
  // (conflicting with a chosen one) must be rejected: saving 0.
  double lb = rejected_cost;
  for (int q : c.chosen)
    lb += cc_of(c, q, E_cur.data(), e_ver);
  double total_max = 0.0;
  const long epoch = c.nodes;
  for (int q = p; q < c.n_reads; ++q) {
    if (c.excluded[q]) continue;
    double cc = cc_of(c, q, E_cur.data(), e_ver);
    double saving = c.garbage[q] - std::min(cc, c.garbage[q]);
    int k = c.clique_id[q];
    double prev = (c.clique_epoch[k] == epoch) ? c.clique_max[k] : 0.0;
    if (saving > prev) {
      total_max += saving - prev;
      c.clique_max[k] = saving;
      c.clique_epoch[k] = epoch;
    }
  }
  lb += c.suffix_garbage[p] - total_max;
  if (lb >= c.best_obj) return;
  // E_possible = E_cur | suffix_or[p]
  std::vector<uint64_t> E_poss(W);
  for (int w = 0; w < W; ++w)
    E_poss[w] = E_cur[w] | c.suffix_or[(size_t)p * W + w];
  for (int q : c.chosen)
    if (!gaps_feasible(c, q, E_cur.data(), E_poss.data())) return;

  bool conflicted = c.excluded[p] != 0;

  // Dominance (result-identical to the full search; see the Python twin):
  // if assigning p adds no exons, never costs more than its garbage,
  // constrains nobody ahead, and its gaps hold for every reachable E,
  // skip the reject branch.
  if (!conflicted && !c.has_forward_conflict[p]) {
    bool subset = true;
    for (int w = 0; w < W; ++w)
      if (c.exons[(size_t)p * W + w] & ~E_cur[w]) { subset = false; break; }
    if (subset &&
        popcount_and(c.corr + (size_t)p * W, E_poss.data(), W) <=
            c.garbage[p] &&
        gaps_always_feasible(c, p, E_cur.data(), E_poss.data())) {
      c.chosen.push_back(p);
      c.chosen_bits[p >> 6] |= 1ull << (p & 63);
      bump_conflicts(c, p, +1);
      recurse(c, p + 1, E_cur, rejected_cost, e_ver);
      bump_conflicts(c, p, -1);
      c.chosen_bits[p >> 6] &= ~(1ull << (p & 63));
      c.chosen.pop_back();
      return;
    }
  }

  // Branch 1: assign p if no conflict with chosen.
  if (!conflicted) {
    std::vector<uint64_t> E_new(W);
    bool e_changed = false;
    for (int w = 0; w < W; ++w) {
      E_new[w] = E_cur[w] | c.exons[(size_t)p * W + w];
      if (E_new[w] != E_cur[w]) e_changed = true;
    }
    if (gaps_feasible(c, p, E_new.data(), E_poss.data())) {
      int64_t nv = e_changed ? ++c.e_ver_counter : e_ver;
      c.chosen.push_back(p);
      c.chosen_bits[p >> 6] |= 1ull << (p & 63);
      bump_conflicts(c, p, +1);
      recurse(c, p + 1, E_new, rejected_cost, nv);
      bump_conflicts(c, p, -1);
      c.chosen_bits[p >> 6] &= ~(1ull << (p & 63));
      c.chosen.pop_back();
    }
  }
  // Branch 2: reject p.
  recurse(c, p + 1, E_cur, rejected_cost + c.garbage[p], e_ver);
}

}  // namespace

extern "C" {

// Returns 0 = OPTIMAL, 1 = TIMEOUT, 2 = BUDGET (node budget hit;
// incumbent outputs are filled). All read-major arrays are in DFS
// (pre-sorted) order; the caller sorts by (-garbage, index) and maps
// results back.
int solve_bnb(
    int n_reads, int n_segs,
    const uint64_t* exons,      // [n_reads][words]
    const uint64_t* corr,       // [n_reads][words]
    const double* garbage,      // [n_reads]
    const int64_t* seg_len,     // [n_segs]
    const int32_t* gap_counts,  // [n_reads]
    const uint64_t* gap_masks,  // [total_gaps][words]
    const int64_t* gap_lens,    // [total_gaps]
    int n_incomp,
    const int32_t* incomp_pairs,  // [n_incomp][2] (DFS positions)
    int64_t eps_scale, int64_t eps_scaled, int64_t offset,
    double deadline_s, int64_t node_budget,
    // outputs
    int32_t* out_assigned,  // [n_reads]; count in *out_n_assigned
    int32_t* out_n_assigned,
    double* out_objective,
    uint64_t* out_E,  // [words]
    int64_t* out_nodes) {
  Ctx c;
  c.n_reads = n_reads;
  c.words = (n_segs + 63) / 64;
  if (c.words == 0) c.words = 1;
  const int W = c.words;
  c.exons = exons;
  c.corr = corr;
  c.garbage = garbage;
  c.seg_len = seg_len;
  c.sc = eps_scale;
  c.eps = eps_scaled;
  c.off = offset;
  c.nodes = 0;
  c.node_budget = node_budget;
  c.timed_out = false;
  c.budget_out = false;
  c.t_end = std::chrono::steady_clock::now() +
            std::chrono::microseconds((int64_t)(deadline_s * 1e6));

  c.gaps.resize(n_reads);
  size_t g_off = 0;
  for (int i = 0; i < n_reads; ++i) {
    for (int g = 0; g < gap_counts[i]; ++g) {
      c.gaps[i].push_back(Gap{gap_masks + g_off * W, gap_lens[g_off]});
      ++g_off;
    }
  }
  int posw = (n_reads + 63) / 64;
  if (posw == 0) posw = 1;
  c.conflict.assign(n_reads, std::vector<uint64_t>(posw, 0));
  c.has_forward_conflict.assign(n_reads, 0);
  for (int e = 0; e < n_incomp; ++e) {
    int a = incomp_pairs[2 * e], b = incomp_pairs[2 * e + 1];
    c.conflict[a][b >> 6] |= 1ull << (b & 63);
    c.conflict[b][a >> 6] |= 1ull << (a & 63);
    if (b > a) c.has_forward_conflict[a] = 1; else c.has_forward_conflict[b] = 1;
  }
  c.chosen_bits.assign(posw, 0);
  c.excluded.assign((size_t)posw * 64, 0);

  // Greedy first-fit clique cover in DFS order (twin of exact.py).
  c.clique_id.assign(n_reads, 0);
  std::vector<std::vector<uint64_t>> clique_members;  // bitsets over positions
  for (int p2 = 0; p2 < n_reads; ++p2) {
    const std::vector<uint64_t>& cb = c.conflict[p2];
    int placed = -1;
    for (size_t k = 0; k < clique_members.size(); ++k) {
      bool subset = true;
      for (int w = 0; w < posw; ++w)
        if (clique_members[k][w] & ~cb[w]) { subset = false; break; }
      if (subset) { placed = (int)k; break; }
    }
    if (placed < 0) {
      placed = (int)clique_members.size();
      clique_members.emplace_back(posw, 0);
    }
    c.clique_id[p2] = placed;
    clique_members[placed][p2 >> 6] |= 1ull << (p2 & 63);
  }
  c.n_cliques = (int)clique_members.size();
  c.clique_max.assign(c.n_cliques, 0.0);
  c.clique_epoch.assign(c.n_cliques, -1);
  c.suffix_garbage.assign(n_reads + 1, 0.0);
  for (int p2 = n_reads - 1; p2 >= 0; --p2)
    c.suffix_garbage[p2] = c.suffix_garbage[p2 + 1] + garbage[p2];

  c.suffix_or.assign((size_t)(n_reads + 1) * W, 0);
  for (int p = n_reads - 1; p >= 0; --p)
    for (int w = 0; w < W; ++w)
      c.suffix_or[(size_t)p * W + w] =
          c.suffix_or[(size_t)(p + 1) * W + w] | exons[(size_t)p * W + w];

  c.best_obj = 0.0;
  for (int i = 0; i < n_reads; ++i) c.best_obj += garbage[i];
  c.best_E.assign(W, 0);

  std::vector<uint64_t> E0(W, 0);
  c.cc_val.assign(n_reads, 0.0);
  c.cc_ver.assign(n_reads, -1);
  c.e_ver_counter = 0;
  recurse(c, 0, E0, 0.0, 0);

  *out_nodes = c.nodes;
  if (c.timed_out) {
    *out_n_assigned = 0;
    *out_objective = c.best_obj;
    return 1;
  }
  *out_n_assigned = (int32_t)c.best_set.size();
  for (size_t i = 0; i < c.best_set.size(); ++i)
    out_assigned[i] = c.best_set[i];
  *out_objective = c.best_obj;
  for (int w = 0; w < W; ++w) out_E[w] = c.best_E[w];
  return c.budget_out ? 2 : 0;
}

}  // extern "C"
