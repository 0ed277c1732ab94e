// The host reconstruction of Route A's reads (the meta-only program's
// batches): aligned, unaligned and chimeric reads rebuilt from the genome,
// the replayed walk events and the counter RNG, and formatted as FASTA or
// FASTQ records and ground-truth error-log rows in one call a batch.
//
// This file compiles the shared writer, native/fastwriter.cpp, as it stands:
// it is included below, so the library built from this file also carries
// every entry point of the shared writer, and the port loads no other copy
// of it.  It adds three entry points of its own, one for each read kind:
//
//   recon_emit_aligned    takes the arguments of emit_batch_recon,
//   recon_emit_unaligned  those of emit_batch_recon_unaligned,
//   recon_emit_chimeric   those of emit_chimeric_recon,
//
// in the same order, then two out-counters (the quality bytes written and
// the steps of the lookup's walk, below), and writes the same bytes.  Their
// range functions are the shared writer's but for one step: a FASTQ base's
// quality.  That quality is vals[c][count(breaks[c] <= u) - 1] + 33, for the
// base's class c (0 match, 1 mismatch, 2 insertion, 3 head/tail, 4
// unaligned) and its SITE_QUAL uniform u (ops/tables.QualDevice).  The
// shared writer counts by a binary search of the row for every base, whose
// branches follow the random u and are mostly mispredicted; QualLookup
// starts from an exact count per bucket of u and steps over the few breaks
// left in the bucket.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread recon_emit.cpp
// (io/native.py builds it at first use).  Interface: plain C, for ctypes.

#include "../../native/fastwriter.cpp"

#include <optional>

namespace recon_emit {

// count(breaks[c] <= u) for every u in [0, 1), over rows sorted ascending
// (QualDevice's: a 0.0 sentinel first, padded with 2.0).  start_[c][b] is
// count(breaks[c] <= b / kBuckets), built by one monotone pass of f32
// comparisons a row.  A draw u falls in bucket b = (int)(u * kBuckets):
// scaling by a power of two is exact, so b / kBuckets <= u, and the count
// from start_[c][b] on only grows by the breaks in (b / kBuckets, u].  The
// walk over those breaks uses the binary search's comparison,
// breaks[c][i] <= u, so the count, and every byte, is the search's.
class QualLookup {
 public:
  static constexpr int kBuckets = 4096;

  // rows: the classes the caller reads, 0 .. rows - 1
  QualLookup(const float* breaks, const int32_t* vals, int64_t qK, int rows)
      : breaks_(breaks), vals_(vals), qK_(qK),
        start_(static_cast<size_t>(rows) * kBuckets) {
    for (int c = 0; c < rows; ++c) {
      const float* br = breaks + c * qK;
      int32_t* st = start_.data() + static_cast<size_t>(c) * kBuckets;
      int64_t n = 0;
      for (int b = 0; b < kBuckets; ++b) {
        const float t = static_cast<float>(b) / static_cast<float>(kBuckets);
        while (n < qK && br[n] <= t) ++n;
        st[b] = static_cast<int32_t>(n);
      }
    }
  }

  // count(breaks[c] <= u); adds the breaks stepped over past the bucket's
  // start to `steps`
  int64_t count(int c, float u, int64_t& steps) const {
    int b = static_cast<int>(u * static_cast<float>(kBuckets));
    if (b > kBuckets - 1) b = kBuckets - 1;  // no draw reaches 1.0
    if (b < 0) b = 0;
    const float* br = breaks_ + c * qK_;
    const int64_t lo0 = start_[static_cast<size_t>(c) * kBuckets + b];
    int64_t lo = lo0;
    while (lo < qK_ && br[lo] <= u) ++lo;
    steps += lo - lo0;
    return lo;
  }

  char qual(int c, float u, int64_t& steps) const {
    return static_cast<char>(vals_[c * qK_ + count(c, u, steps) - 1] + 33);
  }

 private:
  const float* breaks_;
  const int32_t* vals_;
  int64_t qK_;
  std::vector<int32_t> start_;
};

// what one range of reads wrote: its FASTA/FASTQ and error-log bytes, the
// quality bytes and the lookup's walk steps
struct RangeOut {
  int64_t fw = 0, ew = 0, qual_bases = 0, walk_steps = 0;
};

// Splits reads [0, k) into n_threads ranges and runs range(r0, r1, out) on
// each, on its own thread.  A range writes from the upper bound of the bytes
// before it (ubf[r0], ube[r0]); the ranges are then compacted in read order,
// so the bytes do not depend on the thread count.  err_out is null where the
// reads have no error log.
template <class Range>
void run_ranges(int64_t k, int32_t n_threads, const int64_t* ubf, const int64_t* ube,
                char* fastx_out, int64_t* fastx_written, char* err_out,
                int64_t* err_written, int64_t* qual_bases, int64_t* walk_steps,
                Range range) {
  int T = n_threads < 1 ? 1 : static_cast<int>(n_threads);
  if (T > k) T = static_cast<int>(k < 1 ? 1 : k);
  std::vector<int64_t> r0s(T + 1);
  for (int t = 0; t <= T; ++t) r0s[t] = k * t / T;
  std::vector<RangeOut> outs(T);
  if (T == 1) {
    range(0, k, &outs[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(T);
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, t]() { range(r0s[t], r0s[t + 1], &outs[t]); });
    for (auto& th : threads) th.join();
  }
  int64_t fpos = outs[0].fw, epos = outs[0].ew;
  int64_t qb = outs[0].qual_bases, ws = outs[0].walk_steps;
  for (int t = 1; t < T; ++t) {
    std::memmove(fastx_out + fpos, fastx_out + ubf[r0s[t]], outs[t].fw);
    fpos += outs[t].fw;
    if (err_out) {
      std::memmove(err_out + epos, err_out + ube[r0s[t]], outs[t].ew);
      epos += outs[t].ew;
    }
    qb += outs[t].qual_bases;
    ws += outs[t].walk_steps;
  }
  *fastx_written = fpos;
  if (err_written) *err_written = epos;
  *qual_bases = qb;
  *walk_steps = ws;
}

// The three range functions below are the shared writer's recon_range,
// recon_unaligned_range and recon_chimeric_range, with the quality lookup
// in place of the binary search (q is null for FASTA).

void aligned_range(const ReconArgs& a, const QualLookup* q, int64_t r0,
                   int64_t r1, RangeOut* res) {
  using walkreplay::Key;
  Key seed_key{static_cast<uint32_t>(static_cast<uint64_t>(a.seed) >> 32),
               static_cast<uint32_t>(static_cast<uint64_t>(a.seed) & 0xFFFFFFFFu)};
  Key base = walkreplay::fold_in(seed_key, static_cast<uint32_t>(a.stream));

  std::vector<char> pre_buf;
  std::vector<uint8_t> cls_buf;  // per-position qclass (FASTQ only)
  std::vector<int64_t> rpos_buf;
  char* fp = a.fastx_out + a.ubf[r0];
  char* ep = a.err_out + a.ube[r0];
  char* const fp0 = fp;
  char* const ep0 = ep;
  int64_t steps = 0;

  for (int64_t r = r0; r < r1; ++r) {
    const int64_t total = a.total_len[r];
    const int64_t head = a.head[r];
    const int64_t lnew = a.l_new[r];
    const bool rev = a.rev[r] != 0;
    const char* name = a.names_buf + a.name_off[r];
    const int64_t name_len = a.name_off[r + 1] - a.name_off[r];
    const int64_t ne = a.n_events[r];
    const uint32_t* ev = a.ev_flat + a.ev_off[r];
    const int64_t goff = a.g_off[r];
    const int64_t spos = a.start_pos[r];
    const uint8_t* gseq = a.genome_flat + goff + spos;
    const int64_t buf_off = (goff + spos) % a.chunk;

    Key ks = walkreplay::fold_in(base, static_cast<uint32_t>(a.slots[r]));
    Key k_iupac = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_iupac));
    Key k_mis = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_mis));
    Key k_ht = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_ht));
    Key k_qual = a.fastq
        ? walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_qual))
        : ks;

    if ((int64_t)pre_buf.size() < total + 4) pre_buf.resize(total + 4);
    char* pre = pre_buf.data();
    uint8_t* cls = nullptr;
    if (a.fastq) {
      if ((int64_t)cls_buf.size() < total + 4) cls_buf.resize(total + 4);
      cls = cls_buf.data();
      std::memset(cls, 3, total);  // head/tail default; middle overwritten
      std::memset(cls + head, 0, lnew > 0 ? lnew : 0);  // match default
    }
    if ((int64_t)rpos_buf.size() < (ne ? ne : 1)) rpos_buf.resize(ne ? ne : 1);
    int64_t* rpos = rpos_buf.data();

    auto eff_len = [&](int64_t e) -> int64_t {
      const uint32_t w = ev[e];
      const int64_t len = (w >> 17) & 0x1FFF;
      if ((w >> 30) == 1 && e + 1 < ne) {
        const uint32_t w2 = ev[e + 1];
        if ((w2 >> 30) == 1 && (w2 & 0x1FFFF) == (w & 0x1FFFF)) return 0;
      }
      return len;
    };
    // output coordinate of pre-reverse position jj
    auto out_j = [&](int64_t jj) -> uint32_t {
      return static_cast<uint32_t>(rev ? total - 1 - jj : jj);
    };
    // resolved 2-bit code of ref index i
    auto ref_code = [&](int64_t i) -> int {
      return resolve_code(gseq[i], k_iupac, buf_off + i);
    };
    // match span [i, ref_start): bulk copy (genome bytes are already the
    // output ASCII for A/C/G/T), then patch the rare non-ACGT bytes
    auto copy_match = [&](int64_t i0, int64_t i1, int64_t m0) {
      const int64_t n = i1 - i0;
      if (n <= 0) return;
      std::memcpy(pre + head + m0, gseq + i0, static_cast<size_t>(n));
      for (int64_t x = 0; x < n; ++x) {
        const uint8_t c = gseq[i0 + x];
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T')
          pre[head + m0 + x] = kCode2Base[resolve_code(c, k_iupac, buf_off + i0 + x)];
      }
    };

    // --- middle (pre-reverse) -------------------------------------------
    int64_t i = 0, m = 0;
    for (int64_t e = 0; e < ne; ++e) {
      const uint32_t w = ev[e];
      const int64_t px = w & 0x1FFFF;
      const int32_t t = w >> 30;
      const int64_t len = eff_len(e);
      const int64_t key = (px + 1) / 2;
      const int64_t ref_start = (t == 1) ? key : px / 2;
      rpos[e] = m + (ref_start - i);
      copy_match(i, ref_start, m);
      m += ref_start > i ? ref_start - i : 0;
      i = ref_start > i ? ref_start : i;
      if (len == 0) continue;
      if (t == 0) {  // mis: ref code + 1..3, OUTPUT-indexed uniforms
        if (cls) std::memset(cls + head + m, 1, len);
        for (int64_t x = 0; x < len; ++x, ++i, ++m) {
          const uint32_t b = bits_at(k_mis, out_j(head + m));
          int off = 1 + static_cast<int>(u2_lo(b) * 3.0f);
          if (off > 3) off = 3;
          pre[head + m] = kCode2Base[(ref_code(i) + off) & 3];
        }
      } else if (t == 1) {  // ins: uniform base, OUTPUT-indexed uniforms
        if (cls) std::memset(cls + head + m, 2, len);
        for (int64_t x = 0; x < len; ++x, ++m) {
          const uint32_t b = bits_at(k_mis, out_j(head + m));
          int code = static_cast<int>(u2_hi(b) * 4.0f);
          if (code > 3) code = 3;
          pre[head + m] = kCode2Base[code];
        }
      } else {  // del
        i += len;
      }
    }
    copy_match(i, i + (lnew - m), m);  // trailing matches

    // --- head/tail random bases -----------------------------------------
    fill_ht_bases(k_ht, 0, head, a.ht_cap, pre);
    fill_ht_bases(k_ht, head, total - head - lnew, a.ht_cap, pre + head + lnew);

    // --- FASTA/FASTQ record ----------------------------------------------
    *fp++ = a.fastq ? '@' : '>';
    fp = put_bytes(fp, name, name_len);
    *fp++ = '\n';
    if (rev) {
      for (int64_t j = 0; j < total; ++j)
        *fp++ = g_comp[(uint8_t)pre[total - 1 - j]];
    } else {
      fp = put_bytes(fp, pre, total);
    }
    *fp++ = '\n';
    if (a.fastq) {
      *fp++ = '+';
      *fp++ = '\n';
      // the quality of OUTPUT position j from the SITE_QUAL draw there
      float u8[8];
      for (int64_t j0 = 0; j0 < total; j0 += 8) {
        walkreplay::uniform8_at(k_qual, static_cast<uint32_t>(j0), u8);
        const int64_t jn = total - j0 < 8 ? total - j0 : 8;
        for (int64_t x = 0; x < jn; ++x) {
          const int64_t j = j0 + x;
          *fp++ = q->qual(cls[rev ? total - 1 - j : j], u8[x], steps);
        }
      }
      *fp++ = '\n';
      res->qual_bases += total;
    }

    // --- ground-truth error log (reverse event order) --------------------
    if (!a.write_errors || a.n_events_log[r] == 0) continue;
    const char* mid = pre + head;
    for (int64_t e = ne - 1; e >= 0; --e) {
      const uint32_t w = ev[e];
      const int64_t len = eff_len(e);
      if (len == 0) continue;
      const int64_t px = w & 0x1FFFF;
      const int32_t t = w >> 30;
      const int64_t key = (px + 1) / 2;
      ep = put_bytes(ep, name, name_len);
      *ep++ = '\t';
      ep = put_i64(ep, key);
      *ep++ = '\t';
      ep = put_bytes(ep, kTypeNames[t], 3);
      *ep++ = '\t';
      ep = put_i64(ep, len);
      *ep++ = '\t';
      if (t == 1) {
        std::memset(ep, '-', len);
        ep += len;
      } else {
        ep = put_bytes(ep, gseq + key, len);
      }
      *ep++ = '\t';
      if (t == 2) {
        std::memset(ep, '-', len);
        ep += len;
      } else {
        ep = put_bytes(ep, mid + rpos[e], len);
      }
      *ep++ = '\n';
    }
  }
  res->fw = fp - fp0;
  res->ew = ep - ep0;
  res->walk_steps = steps;
}

void unaligned_range(const UnalReconArgs& a, const QualLookup* q, int64_t r0,
                     int64_t r1, RangeOut* res) {
  using walkreplay::Key;
  Key seed_key{static_cast<uint32_t>(static_cast<uint64_t>(a.seed) >> 32),
               static_cast<uint32_t>(static_cast<uint64_t>(a.seed) & 0xFFFFFFFFu)};
  Key base = walkreplay::fold_in(seed_key, static_cast<uint32_t>(a.stream));

  std::vector<uint8_t> flags_buf;  // per presentation position: 1 dead, 2 ins, 4 mis
  std::vector<char> out_buf;
  char* fp = a.fastx_out + a.ubf[r0];
  char* const fp0 = fp;
  int64_t steps = 0;
  constexpr uint8_t F_DEAD = 1, F_INS = 2, F_MIS = 4;

  for (int64_t r = r0; r < r1; ++r) {
    const int64_t lnew = a.l_new[r];
    const int64_t mid = a.middle_ref[r];
    const bool rev = a.rev[r] != 0;
    const char* name = a.names_buf + a.name_off[r];
    const int64_t name_len = a.name_off[r + 1] - a.name_off[r];
    const int64_t ns = a.n_steps[r];
    const uint32_t* ev = a.ev_flat + a.ev_off[r];
    const uint8_t* gseq = a.genome_flat + a.g_off[r] + a.start_pos[r];

    Key ks = walkreplay::fold_in(base, static_cast<uint32_t>(a.slots[r]));
    Key k_iupac = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_iupac));
    Key k_ins = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_ins));
    Key k_qual = a.fastq
        ? walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_qual))
        : ks;

    // presentation spans (apply_errors.build_unaligned_map semantics)
    int64_t tot_ins = 0;
    for (int64_t e = 0; e < ns; ++e) {
      const uint32_t w = ev[e];
      if ((w >> 30) == 1 && ((w >> 17) & 0x1FFF)) tot_ins += (w >> 17) & 0x1FFF;
    }
    const int64_t P = mid + tot_ins;
    if ((int64_t)flags_buf.size() < P + 1) flags_buf.resize(P + 1);
    uint8_t* flags = flags_buf.data();
    std::memset(flags, 0, P);

    int64_t prior_ins = 0, k_same = 0;
    for (int64_t e = 0; e < ns; ++e) {
      const uint32_t w = ev[e];
      const int64_t px = w & 0x1FFFF;
      const int32_t t = w >> 30;
      const int64_t len = (w >> 17) & 0x1FFF;
      const int64_t pos = px >> 1;  // ins px = 2p+1, others 2p
      if (len == 0) {  // match step resets the consecutive-ins run
        k_same = 0;
        continue;
      }
      if (t == 1) {
        const int64_t ps = pos + prior_ins + 1;
        for (int64_t x = 0; x < len && ps + x < P; ++x) flags[ps + x] |= F_INS;
        prior_ins += len;
        k_same += len;
      } else {
        const int64_t ps = pos + (prior_ins - k_same);
        const uint8_t f = (t == 0) ? F_MIS : F_DEAD;
        for (int64_t x = 0; x < len && ps + x < P; ++x) flags[ps + x] |= f;
        k_same = 0;
      }
    }

    if ((int64_t)out_buf.size() < lnew + 4) out_buf.resize(lnew + 4);
    char* out = out_buf.data();
    int64_t j = 0, ref_idx = 0;
    for (int64_t p = 0; p < P && j < lnew; ++p) {
      const uint8_t f = flags[p];
      const bool is_ins = f & F_INS;
      if (f & F_DEAD) {
        if (!is_ins) ++ref_idx;
        continue;
      }
      int code;
      if (is_ins) {
        const uint32_t b = bits_at(k_ins, static_cast<uint32_t>(j));
        code = static_cast<int>(u2_lo(b) * 4.0f);
        if (code > 3) code = 3;
      } else {
        code = resolve_code(gseq[ref_idx], k_iupac, ref_idx);
        ++ref_idx;
      }
      if (f & F_MIS) {
        const uint32_t b = bits_at(k_iupac, static_cast<uint32_t>(j));
        int off = 1 + static_cast<int>(u2_hi(b) * 3.0f);
        if (off > 3) off = 3;
        code = (code + off) & 3;
      }
      out[j++] = kCode2Base[code];
    }

    *fp++ = a.fastq ? '@' : '>';
    fp = put_bytes(fp, name, name_len);
    *fp++ = '\n';
    if (rev) {
      for (int64_t x = 0; x < lnew; ++x)
        *fp++ = g_comp[(uint8_t)out[lnew - 1 - x]];
    } else {
      fp = put_bytes(fp, out, lnew);
    }
    *fp++ = '\n';
    if (a.fastq) {
      *fp++ = '+';
      *fp++ = '\n';
      // all-unmapped class (row 4); qual index j is NOT strand-flipped
      // (unaligned_batch computes quals after the read flip)
      float u8[8];
      for (int64_t x0 = 0; x0 < lnew; x0 += 8) {
        walkreplay::uniform8_at(k_qual, static_cast<uint32_t>(x0), u8);
        const int64_t xn = lnew - x0 < 8 ? lnew - x0 : 8;
        for (int64_t x = 0; x < xn; ++x) *fp++ = q->qual(4, u8[x], steps);
      }
      *fp++ = '\n';
      res->qual_bases += lnew;
    }
  }
  res->fw = fp - fp0;
  res->walk_steps = steps;
}

void chimeric_range(const ChiReconArgs& a, const QualLookup* q, int64_t r0,
                    int64_t r1, RangeOut* res) {
  using walkreplay::Key;
  Key seed_key{static_cast<uint32_t>(static_cast<uint64_t>(a.seed) >> 32),
               static_cast<uint32_t>(static_cast<uint64_t>(a.seed) & 0xFFFFFFFFu)};
  Key base = walkreplay::fold_in(seed_key, static_cast<uint32_t>(a.stream));

  std::vector<char> pre_buf;
  std::vector<uint8_t> cls_buf, gap_flags;
  std::vector<int64_t> rpos_buf;
  std::vector<float> uq_buf;
  char* fp = a.fastx_out + a.ubf[r0];
  char* ep = a.err_out + a.ube[r0];
  char* const fp0 = fp;
  char* const ep0 = ep;
  int64_t steps = 0;

  for (int64_t r = r0; r < r1; ++r) {
    const int64_t total = a.total_len[r];
    const int64_t head = a.head[r];
    const int64_t tail = a.tail[r];
    const int64_t ns = a.n_seg[r];
    const bool rev = a.rev[r] != 0;
    const char* name = a.names_buf + a.name_off[r];
    const int64_t name_len = a.name_off[r + 1] - a.name_off[r];

    Key ks = walkreplay::fold_in(base, static_cast<uint32_t>(a.slots[r]));
    Key k_ht = walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_ht));
    Key k_qual = a.fastq
        ? walkreplay::fold_in(ks, static_cast<uint32_t>(a.site_qual))
        : ks;

    if ((int64_t)pre_buf.size() < total + 4) pre_buf.resize(total + 4);
    char* pre = pre_buf.data();
    uint8_t* cls = nullptr;
    if (a.fastq) {
      if ((int64_t)cls_buf.size() < total + 4) cls_buf.resize(total + 4);
      cls = cls_buf.data();
    }

    // head / tail random bases (pool index clipped to ht_cap - 1)
    fill_ht_bases(k_ht, 0, head, a.ht_cap, pre);
    fill_ht_bases(k_ht, head, tail, a.ht_cap, pre + total - tail);
    if (cls) {
      std::memset(cls, 3, head > 0 ? head : 0);
      if (tail > 0) std::memset(cls + total - tail, 3, tail);
    }

    // segments
    for (int64_t s = 0; s < ns; ++s) {
      const int64_t rs = r * a.S + s;
      const int64_t ne = a.seg_n_ev[rs];
      const int64_t lnew = a.seg_lnew[rs];
      const uint32_t* ev = a.seg_ev_flat + a.seg_ev_off[rs];
      const uint8_t* gseq = a.genome_flat + a.seg_goff[rs] + a.seg_spos[rs];
      char* out = pre + a.seg_part_off[rs];
      Key pk = walkreplay::fold_in(ks, static_cast<uint32_t>(a.part_seg_base + s));
      Key k_iu = walkreplay::fold_in(pk, static_cast<uint32_t>(a.site_iupac));
      Key k_in = walkreplay::fold_in(pk, static_cast<uint32_t>(a.site_ins));
      if (cls) std::memset(cls + a.seg_part_off[rs], 0, lnew > 0 ? lnew : 0);

      auto eff_len = [&](int64_t e) -> int64_t {
        const uint32_t w = ev[e];
        const int64_t len = (w >> 17) & 0x1FFF;
        if ((w >> 30) == 1 && e + 1 < ne) {
          const uint32_t w2 = ev[e + 1];
          if ((w2 >> 30) == 1 && (w2 & 0x1FFFF) == (w & 0x1FFFF)) return 0;
        }
        return len;
      };
      auto copy_match = [&](int64_t i0, int64_t i1, int64_t m0) {
        const int64_t n = i1 - i0;
        if (n <= 0) return;
        std::memcpy(out + m0, gseq + i0, static_cast<size_t>(n));
        for (int64_t x = 0; x < n; ++x) {
          const uint8_t c = gseq[i0 + x];
          if (c != 'A' && c != 'C' && c != 'G' && c != 'T')
            out[m0 + x] = kCode2Base[resolve_code(c, k_iu, i0 + x)];
        }
      };
      int64_t i = 0, m = 0;
      for (int64_t e = 0; e < ne; ++e) {
        const uint32_t w = ev[e];
        const int64_t px = w & 0x1FFFF;
        const int32_t t = w >> 30;
        const int64_t len = eff_len(e);
        const int64_t key = (px + 1) / 2;
        const int64_t ref_start = (t == 1) ? key : px / 2;
        copy_match(i, ref_start, m);
        m += ref_start > i ? ref_start - i : 0;
        i = ref_start > i ? ref_start : i;
        if (len == 0) continue;
        if (t == 0) {  // mis: MIDDLE-indexed hi half of SITE_IUPAC
          if (cls) std::memset(cls + a.seg_part_off[rs] + m, 1, len);
          for (int64_t x = 0; x < len; ++x, ++i, ++m) {
            int off = 1 + static_cast<int>(
                u2_hi(bits_at(k_iu, static_cast<uint32_t>(m))) * 3.0f);
            if (off > 3) off = 3;
            out[m] = kCode2Base[(resolve_code(gseq[i], k_iu, i) + off) & 3];
          }
        } else if (t == 1) {  // ins: MIDDLE-indexed lo half of SITE_INS_BASE
          if (cls) std::memset(cls + a.seg_part_off[rs] + m, 2, len);
          for (int64_t x = 0; x < len; ++x, ++m) {
            int code = static_cast<int>(
                u2_lo(bits_at(k_in, static_cast<uint32_t>(m))) * 4.0f);
            if (code > 3) code = 3;
            out[m] = kCode2Base[code];
          }
        } else {
          i += len;
        }
      }
      copy_match(i, i + (lnew - m), m);
    }

    // gaps
    for (int64_t g = 0; g < ns - 1; ++g) {
      const int64_t rg = r * (a.S - 1) + g;
      const int64_t glnew = a.gap_lnew[rg];
      Key pk = walkreplay::fold_in(ks, static_cast<uint32_t>(a.part_gap_base + g));
      Key k_iu = walkreplay::fold_in(pk, static_cast<uint32_t>(a.site_iupac));
      Key k_in = walkreplay::fold_in(pk, static_cast<uint32_t>(a.site_ins));
      recon_gap_part(a.gap_ev_flat + a.gap_ev_off[rg], a.gap_n_steps[rg],
                     a.gap_mid[rg], glnew,
                     a.genome_flat + a.gap_goff[rg] + a.gap_spos[rg],
                     k_iu, k_in, pre + a.gap_part_off[rg], gap_flags);
      if (cls) std::memset(cls + a.gap_part_off[rg], 4, glnew > 0 ? glnew : 0);
    }

    // record
    *fp++ = a.fastq ? '@' : '>';
    fp = put_bytes(fp, name, name_len);
    *fp++ = '\n';
    if (rev) {
      for (int64_t j = 0; j < total; ++j)
        *fp++ = g_comp[(uint8_t)pre[total - 1 - j]];
    } else {
      fp = put_bytes(fp, pre, total);
    }
    *fp++ = '\n';
    if (a.fastq) {
      *fp++ = '+';
      *fp++ = '\n';
      // uniforms live at counters 0..total-1; when rev they're consumed in
      // descending order, so batch them into a scratch buffer first
      if ((int64_t)uq_buf.size() < total + 8) uq_buf.resize(total + 8);
      for (int64_t j0 = 0; j0 < total; j0 += 8)
        walkreplay::uniform8_at(k_qual, static_cast<uint32_t>(j0), &uq_buf[j0]);
      for (int64_t j = 0; j < total; ++j) {
        const int64_t jj = rev ? total - 1 - j : j;
        *fp++ = q->qual(cls[jj], uq_buf[jj], steps);
      }
      *fp++ = '\n';
      res->qual_bases += total;
    }

    // per-segment error log (reverse event order; gaps are never logged)
    if (!a.write_errors) continue;
    for (int64_t s = 0; s < ns; ++s) {
      const int64_t rs = r * a.S + s;
      const int64_t ne = a.seg_n_ev[rs];
      if (ne == 0) continue;
      const char* mid = pre + a.seg_part_off[rs];
      const uint32_t* ev = a.seg_ev_flat + a.seg_ev_off[rs];
      const uint8_t* gseq = a.genome_flat + a.seg_goff[rs] + a.seg_spos[rs];
      if ((int64_t)rpos_buf.size() < ne) rpos_buf.resize(ne);
      int64_t* rpos = rpos_buf.data();
      auto eff_len = [&](int64_t e) -> int64_t {
        const uint32_t w = ev[e];
        const int64_t len = (w >> 17) & 0x1FFF;
        if ((w >> 30) == 1 && e + 1 < ne) {
          const uint32_t w2 = ev[e + 1];
          if ((w2 >> 30) == 1 && (w2 & 0x1FFFF) == (w & 0x1FFFF)) return 0;
        }
        return len;
      };
      {
        int64_t cum_del = 0, cum_ins = 0;
        for (int64_t e = 0; e < ne; ++e) {
          const uint32_t w = ev[e];
          const int32_t t = w >> 30;
          const int64_t key = ((w & 0x1FFFF) + 1) / 2;
          const int64_t ref_start = (t == 1) ? key : (w & 0x1FFFF) / 2;
          rpos[e] = ref_start - cum_del + cum_ins;
          if (t == 1) cum_ins += eff_len(e);
          if (t == 2) cum_del += (w >> 17) & 0x1FFF;
        }
      }
      for (int64_t e = ne - 1; e >= 0; --e) {
        const uint32_t w = ev[e];
        const int32_t t = w >> 30;
        const int64_t len = eff_len(e);
        if (len == 0) continue;
        const int64_t key = ((w & 0x1FFFF) + 1) / 2;
        ep = put_bytes(ep, name, name_len);
        *ep++ = '\t';
        ep = put_i64(ep, key);
        *ep++ = '\t';
        ep = put_bytes(ep, kTypeNames[t], 3);
        *ep++ = '\t';
        ep = put_i64(ep, len);
        *ep++ = '\t';
        if (t == 1) {
          std::memset(ep, '-', len);
          ep += len;
        } else {
          ep = put_bytes(ep, gseq + key, len);
        }
        *ep++ = '\t';
        if (t == 2) {
          std::memset(ep, '-', len);
          ep += len;
        } else {
          ep = put_bytes(ep, mid + rpos[e], len);
        }
        *ep++ = '\n';
      }
    }
  }
  res->fw = fp - fp0;
  res->ew = ep - ep0;
  res->walk_steps = steps;
}

}  // namespace recon_emit

extern "C" {

int64_t recon_emit_aligned(
    int64_t seed, int64_t stream, int64_t site_iupac, int64_t site_mis,
    int64_t site_ht, int64_t ht_cap, int64_t chunk,
    int64_t k, const int64_t* slots,
    const char* names_buf, const int64_t* name_off,
    const int64_t* total_len, const int64_t* head, const int64_t* l_new,
    const uint8_t* rev,
    const uint32_t* ev_flat, const int64_t* ev_off, const int64_t* n_events,
    const int64_t* n_events_log,
    const uint8_t* genome_flat, const int64_t* g_off, const int64_t* g_len,
    const int64_t* start_pos,
    const int64_t* ubf, const int64_t* ube,
    char* fastx_out, int64_t* fastx_written,
    char* err_out, int64_t* err_written,
    int32_t write_errors, int32_t n_threads,
    int32_t fastq, int64_t site_qual,
    const float* q_breaks, const int32_t* q_vals, int64_t qK,
    int64_t* qual_bases, int64_t* walk_steps) {
  using namespace recon_emit;
  init_comp();
  init_dec();
  ReconArgs a{seed,     stream,   site_iupac, site_mis, site_ht, ht_cap,
              chunk,    slots,    names_buf,  name_off, total_len, head,
              l_new,    rev,      ev_flat,    ev_off,   n_events,
              n_events_log, genome_flat, g_off, g_len, start_pos,
              ubf,      ube,      fastx_out,  err_out,
              static_cast<int>(write_errors),
              static_cast<int>(fastq), site_qual, q_breaks, q_vals, qK};
  std::optional<QualLookup> q;
  if (fastq) q.emplace(q_breaks, q_vals, qK, 4);  // classes 0-3
  const QualLookup* qp = q ? &*q : nullptr;
  run_ranges(k, n_threads, ubf, ube, fastx_out, fastx_written, err_out, err_written,
             qual_bases, walk_steps,
             [&](int64_t r0, int64_t r1, RangeOut* o) { aligned_range(a, qp, r0, r1, o); });
  return 0;
}

int64_t recon_emit_unaligned(
    int64_t seed, int64_t stream, int64_t site_iupac, int64_t site_ins,
    int64_t site_qual, int64_t k,
    const int64_t* slots, const char* names_buf, const int64_t* name_off,
    const int64_t* l_new, const int64_t* middle_ref, const uint8_t* rev,
    const uint32_t* ev_flat, const int64_t* ev_off, const int64_t* n_steps,
    const uint8_t* genome_flat, const int64_t* g_off, const int64_t* start_pos,
    const int64_t* ubf,
    char* fastx_out, int64_t* fastx_written,
    int32_t fastq, const float* q_breaks, const int32_t* q_vals, int64_t qK,
    int32_t n_threads,
    int64_t* qual_bases, int64_t* walk_steps) {
  using namespace recon_emit;
  init_comp();
  UnalReconArgs a{seed, stream, site_iupac, site_ins, site_qual,
                  slots, names_buf, name_off, l_new, middle_ref, rev,
                  ev_flat, ev_off, n_steps, genome_flat, g_off, start_pos,
                  ubf, fastx_out, static_cast<int>(fastq),
                  q_breaks, q_vals, qK};
  std::optional<QualLookup> q;
  if (fastq) q.emplace(q_breaks, q_vals, qK, 5);  // class 4 (rows 0-4 exist)
  const QualLookup* qp = q ? &*q : nullptr;
  run_ranges(k, n_threads, ubf, nullptr, fastx_out, fastx_written, nullptr, nullptr,
             qual_bases, walk_steps,
             [&](int64_t r0, int64_t r1, RangeOut* o) { unaligned_range(a, qp, r0, r1, o); });
  return 0;
}

int64_t recon_emit_chimeric(
    int64_t seed, int64_t stream,
    int64_t site_iupac, int64_t site_ins, int64_t site_ht, int64_t site_qual,
    int64_t part_seg_base, int64_t part_gap_base, int64_t ht_cap,
    int64_t k, int64_t S,
    const int64_t* slots, const char* names_buf, const int64_t* name_off,
    const int64_t* total_len, const int64_t* head, const int64_t* tail,
    const int64_t* n_seg, const uint8_t* rev,
    const int64_t* seg_part_off, const int64_t* seg_lnew, const int64_t* seg_mid,
    const int64_t* seg_goff, const int64_t* seg_spos,
    const uint32_t* seg_ev_flat, const int64_t* seg_ev_off, const int64_t* seg_n_ev,
    const int64_t* gap_part_off, const int64_t* gap_lnew, const int64_t* gap_mid,
    const int64_t* gap_goff, const int64_t* gap_spos,
    const uint32_t* gap_ev_flat, const int64_t* gap_ev_off, const int64_t* gap_n_steps,
    const uint8_t* genome_flat,
    const int64_t* ubf, const int64_t* ube,
    char* fastx_out, int64_t* fastx_written,
    char* err_out, int64_t* err_written,
    int32_t fastq, int32_t write_errors,
    const float* q_breaks, const int32_t* q_vals, int64_t qK,
    int32_t n_threads,
    int64_t* qual_bases, int64_t* walk_steps) {
  using namespace recon_emit;
  init_comp();
  ChiReconArgs a{seed, stream, site_iupac, site_ins, site_ht, site_qual,
                 part_seg_base, part_gap_base, ht_cap, S,
                 slots, names_buf, name_off, total_len, head, tail, n_seg, rev,
                 seg_part_off, seg_lnew, seg_mid, seg_goff, seg_spos,
                 seg_ev_flat, seg_ev_off, seg_n_ev,
                 gap_part_off, gap_lnew, gap_mid, gap_goff, gap_spos,
                 gap_ev_flat, gap_ev_off, gap_n_steps,
                 genome_flat, ubf, ube, fastx_out, err_out,
                 static_cast<int>(fastq), static_cast<int>(write_errors),
                 q_breaks, q_vals, qK};
  std::optional<QualLookup> q;
  if (fastq) q.emplace(q_breaks, q_vals, qK, 5);  // classes 0-4
  const QualLookup* qp = q ? &*q : nullptr;
  run_ranges(k, n_threads, ubf, ube, fastx_out, fastx_written, err_out, err_written,
             qual_bases, walk_steps,
             [&](int64_t r0, int64_t r1, RangeOut* o) { chimeric_range(a, qp, r0, r1, o); });
  return 0;
}

// The lookup on given draws, for tests: counts[i] = count(breaks[cls[i]] <=
// u[i]) over a [rows, qK] table; returns the walk's steps.
int64_t recon_emit_qual_counts(const float* breaks, int64_t qK, int64_t rows,
                               const int32_t* cls, const float* u, int64_t n,
                               int64_t* counts) {
  const recon_emit::QualLookup q(breaks, nullptr, qK, static_cast<int>(rows));
  int64_t steps = 0;
  for (int64_t i = 0; i < n; ++i) counts[i] = q.count(cls[i], u[i], steps);
  return steps;
}

}  // extern "C"
