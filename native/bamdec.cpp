// Native BAM/BGZF decoder (htslib-equivalent ingest shim).
//
// The reference delegates BAM decoding to pysam/htslib
// (py/freddie_split.py:12,210-242); this is the same role for this
// framework: BGZF block inflation (zlib) + BAM record parsing + 4-bit
// sequence expansion, exposed as a batch API over flat arrays so the
// Python side materializes no per-record intermediate objects it doesn't
// need. The decode core + CIGAR walk live in bam_io.h, shared with the
// native split-stage driver (split_core.cpp).
//
// Build: g++ -O2 -shared -fPIC -o libbamdec.so bamdec.cpp split_core.cpp -lz
// Bindings: freddie_jax/io/bam_native.py (ctypes).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "bam_io.h"

using bamio::Handle;
using bamio::ensure;
using bamio::rd;

extern "C" {

void* bamdec_open(const char* path, char* err, int errlen) {
  Handle* h = new Handle();
  h->f = fopen(path, "rb");
  auto fail = [&](const std::string& msg) -> void* {
    snprintf(err, errlen, "%s", msg.c_str());
    if (h->f) fclose(h->f);
    delete h;
    return nullptr;
  };
  if (!h->f) return fail("cannot open file");
  if (!bamio::parse_header(*h)) return fail(h->err);
  bamio::start_prefetch(*h);  // background BGZF inflate (bam_io.h)
  return h;
}

int bamdec_n_refs(void* hp) { return (int)((Handle*)hp)->refs.size(); }

int bamdec_ref(void* hp, int i, char* name_out, int cap, long long* len_out) {
  Handle* h = (Handle*)hp;
  if (i < 0 || i >= (int)h->refs.size()) return -1;
  snprintf(name_out, cap, "%s", h->refs[i].name.c_str());
  *len_out = h->refs[i].len;
  return 0;
}

// Returns number of records decoded (0 at EOF, -1 on error / buffer full).
long long bamdec_next_batch(
    void* hp, long long max_records,
    int32_t* ref_id, int64_t* pos, uint16_t* flag, uint8_t* mapq,
    int64_t* name_off, int32_t* name_len, char* name_buf, long long name_cap,
    int64_t* cigar_off, int32_t* cigar_len, uint32_t* cigar_buf, long long cigar_cap,
    int64_t* seq_off, int64_t* seq_len, char* seq_buf, long long seq_cap) {
  Handle* h = (Handle*)hp;
  long long n = 0;
  long long nb = 0, cb = 0, sb = 0;
  while (n < max_records) {
    if (!ensure(*h, 4)) {
      if (h->eof) break;
      return -1;
    }
    int32_t block_size = rd<int32_t>(*h);
    if (!ensure(*h, block_size)) return -1;
    size_t rec_end = h->pos + block_size;
    ref_id[n] = rd<int32_t>(*h);
    pos[n] = rd<int32_t>(*h);
    uint8_t l_read_name = rd<uint8_t>(*h);
    mapq[n] = rd<uint8_t>(*h);
    h->pos += 2;  // bin
    uint16_t n_cigar = rd<uint16_t>(*h);
    flag[n] = rd<uint16_t>(*h);
    int32_t l_seq = rd<int32_t>(*h);
    h->pos += 12;  // next_refID, next_pos, tlen
    if (nb + l_read_name > name_cap || cb + n_cigar > cigar_cap ||
        sb + l_seq > seq_cap)
      return -2;  // caller buffers too small
    memcpy(name_buf + nb, h->buf.data() + h->pos, l_read_name - 1);
    name_off[n] = nb;
    name_len[n] = l_read_name - 1;
    nb += l_read_name - 1;
    h->pos += l_read_name;
    memcpy(cigar_buf + cb, h->buf.data() + h->pos, 4ull * n_cigar);
    cigar_off[n] = cb;
    cigar_len[n] = n_cigar;
    cb += n_cigar;
    h->pos += 4ull * n_cigar;
    const uint8_t* packed = h->buf.data() + h->pos;
    for (int32_t i = 0; i < l_seq; ++i) {
      uint8_t b = packed[i >> 1];
      seq_buf[sb + i] = bamio::SEQ_NIBBLE[(i & 1) ? (b & 0xF) : (b >> 4)];
    }
    seq_off[n] = sb;
    seq_len[n] = l_seq;
    sb += l_seq;
    h->pos = rec_end;  // skip qual + tags
    ++n;
  }
  return n;
}

// Array-native ingest for the split stage: decode records AND perform the
// per-alignment CIGAR walk (the reference's get_intervals,
// py/freddie_split.py:133-207) in one pass, returning flat interval
// arrays. The walk (bamio::walk_intervals) mirrors
// freddie_jax/core/cigar.py exactly: deletions longer than max_del_size
// are reclassified as introns, each maximal run between introns becomes
// one exonic interval with its exon-consuming cigar ops rendered as text,
// and empty (target- or query-empty) intervals are dropped (the
// record_to_read filter). Sequences are NOT expanded: the split stage
// takes sequences from the FASTQ pass, so skipping the 4-bit expansion
// removes the largest per-record cost of the generic batch API.
//
// Records flagged unmapped/secondary/supplementary get iv_n = 0 and no
// walk (the caller filters them anyway, and their qlen may not match).
// Returns records decoded; 0 at EOF; stops early (returning the prefix)
// when an output buffer would overflow; -2 if even one record does not
// fit; -3 on a CIGAR/query length mismatch (the reference asserts).
long long bamdec_next_batch_iv(
    void* hp, long long max_records, int max_del_size,
    int32_t* ref_id, int64_t* pos, uint16_t* flag,
    int64_t* name_off, int32_t* name_len, char* name_buf, long long name_cap,
    int64_t* iv_off, int32_t* iv_n,
    int64_t* iv_ts, int64_t* iv_te, int64_t* iv_qs, int64_t* iv_qe,
    int64_t* cig_off, int32_t* cig_len, char* cig_buf, long long cig_cap,
    long long iv_cap) {
  Handle* h = (Handle*)hp;
  long long n = 0;
  long long nb = 0, ivb = 0, cb = 0;
  std::vector<bamio::Iv> scratch;
  std::string cigtext;
  while (n < max_records) {
    if (!ensure(*h, 4)) {
      if (h->eof) break;
      return -1;
    }
    size_t save_pos = h->pos;
    int32_t block_size = rd<int32_t>(*h);
    if (!ensure(*h, block_size)) return -1;
    size_t rec_end = h->pos + block_size;
    int32_t rid = rd<int32_t>(*h);
    int64_t rpos = rd<int32_t>(*h);
    uint8_t l_read_name = rd<uint8_t>(*h);
    h->pos += 1;  // mapq
    h->pos += 2;  // bin
    uint16_t n_cigar = rd<uint16_t>(*h);
    uint16_t fl = rd<uint16_t>(*h);
    int32_t l_seq = rd<int32_t>(*h);
    h->pos += 12;  // next_refID, next_pos, tlen
    // Worst case per record: every cigar op is its own interval with an
    // 11-char rendering ("4294967295M").
    if (nb + l_read_name - 1 > name_cap || ivb + n_cigar + 1 > iv_cap ||
        cb + 12ll * (n_cigar + 1) > cig_cap) {
      h->pos = save_pos;
      if (n == 0) return -2;
      break;
    }
    memcpy(name_buf + nb, h->buf.data() + h->pos, l_read_name - 1);
    name_off[n] = nb;
    name_len[n] = l_read_name - 1;
    nb += l_read_name - 1;
    h->pos += l_read_name;
    const uint8_t* cig = h->buf.data() + h->pos;
    ref_id[n] = rid;
    pos[n] = rpos;
    flag[n] = fl;
    iv_off[n] = ivb;
    iv_n[n] = 0;
    bool skip_walk = (fl & (4 | 256 | 2048)) != 0 || n_cigar == 0;
    if (!skip_walk) {
      scratch.clear();
      cigtext.clear();
      if (bamio::walk_intervals(cig, n_cigar, rpos, l_seq, max_del_size,
                                scratch, cigtext) != 0)
        return -3;
      memcpy(cig_buf + cb, cigtext.data(), cigtext.size());
      for (const auto& iv : scratch) {
        iv_ts[ivb] = iv.ts;
        iv_te[ivb] = iv.te;
        iv_qs[ivb] = iv.qs;
        iv_qe[ivb] = iv.qe;
        cig_off[ivb] = cb + iv.cig_off;
        cig_len[ivb] = iv.cig_len;
        ++ivb;
      }
      cb += (long long)cigtext.size();
      iv_n[n] = (int32_t)scratch.size();
    }
    h->pos = rec_end;  // skip seq + qual + tags
    ++n;
  }
  return n;
}

void bamdec_close(void* hp) {
  Handle* h = (Handle*)hp;
  h->pf.reset();  // join the prefetch thread BEFORE closing its FILE*
  if (h->f) fclose(h->f);
  delete h;
}

}  // extern "C"
