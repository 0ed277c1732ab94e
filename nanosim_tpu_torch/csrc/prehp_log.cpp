// The ground-truth error log of a device-materialized homopolymer (-hp)
// genome batch, composed on the host in one call.
//
// In -hp mode the device runs the pass-1 mutation, then resizes the
// homopolymer runs of the mutated middle; the log describes the pass-1
// mutation, so its rows are cut from the middle BEFORE the resize.  The
// compact buffer (sim/compact.py) carries, for each accepted lane, the
// device's own events (one u32 word each: position2x & 0x1FFFF, length
// >> 17 & 0x1FFF, type >> 30; the suppression already zeroed the length of
// a suppressed event) and the 2-bit pre-resize middle.  Per lane this file
// does what sim/output.event_read_positions and _prehp_log_rows do, which
// stay in Python as its spec (tests/test_torch_hp_runs.py holds the two to
// the same bytes):
//
//   * an insertion followed by an insertion with the same position key is
//     overwritten and counts as length 0, like a suppressed event; events
//     of length 0 write no row;
//   * an event's read position is its reference start less the deleted and
//     plus the inserted bases of the events before it;
//   * insertions carry '-' on the reference side, deletions on the read
//     side; read bases are cut from the decoded middle, reference bases
//     from the genome at the read's start plus the event's key, wrapping
//     past the origin of a circular chromosome;
//   * each lane's rows come out in reverse event order (mutate_read's).
//
// Cuts follow the spec's slicing where it runs past an end: a read-side cut
// is a Python str slice of the middle, a reference-side cut a numpy slice of
// the flat genome.
//
// Lanes are split into ranges across threads.  Each range writes into its
// own region of the output, which starts at the upper bound of the rows
// before it; the regions are then compacted in lane order, so the bytes do
// not depend on the thread count.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread prehp_log.cpp
// (io/native.py builds it at first use).  Interface: plain C, for ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const char kCode2Base[4] = {'A', 'C', 'G', 'T'};
const char kTypeNames[3][4] = {"mis", "ins", "del"};

// per-row bound: name, key and length (20 digits each), type, the two
// bases fields, five tabs and the newline
constexpr int64_t kRowFixed = 52;

struct Dec4 {
  uint32_t v[256];  // packed byte -> its four ASCII bases (code 4w+k at bits 2k)
  Dec4() {
    for (int b = 0; b < 256; ++b) {
      char four[4];
      for (int j = 0; j < 4; ++j) four[j] = kCode2Base[(b >> (2 * j)) & 3];
      std::memcpy(&v[b], four, 4);
    }
  }
};
const Dec4 kDec4;

inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  for (int i = n - 1; i >= 0; --i) *p++ = tmp[i];
  return p;
}

inline char* put_i64(char* p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    return put_u64(p, static_cast<uint64_t>(0) - static_cast<uint64_t>(v));
  }
  return put_u64(p, static_cast<uint64_t>(v));
}

inline int64_t floor_mod(int64_t a, int64_t m) {
  const int64_t r = a % m;
  return r < 0 ? r + m : r;
}

// [lo, hi) of the slice [start:stop] of a sequence of n items (Python's
// rules for a step of 1: negative indices count from the end, both ends
// are clamped to [0, n]).
inline void py_slice(int64_t start, int64_t stop, int64_t n, int64_t* lo, int64_t* hi) {
  auto norm = [n](int64_t i) {
    if (i < 0) {
      i += n;
      return i < 0 ? int64_t{0} : i;
    }
    return i > n ? n : i;
  };
  *lo = norm(start);
  *hi = norm(stop);
  if (*hi < *lo) *hi = *lo;
}

struct Args {
  const int64_t* lanes;
  const char* names;
  const int64_t* name_off;
  const uint32_t* ev_flat;
  const int64_t* ev_off;
  const int64_t* n_events;
  const uint8_t* prehp_flat;
  int64_t prehp_bytes;
  const int64_t* prehp_off;
  const int64_t* prehp_len;
  const int64_t* chrom;
  const int64_t* pos;
  const uint8_t* genome;
  int64_t genome_len;
  const int64_t* g_offsets;
  const int64_t* g_lengths;
  const uint8_t* g_circular;
  char* out;
  const int64_t* row_start;  // [k + 1] upper-bound byte offsets of the rows
};

// One lane's pre-resize middle, decoded into mid (the spec's
// _decode_2bit: a lane whose bytes run past the buffer is cut short).
int64_t decode_middle(const Args& a, int64_t b, std::vector<char>& mid) {
  const int64_t n = a.prehp_len[b] > 0 ? a.prehp_len[b] : 0;
  const int64_t off = a.prehp_off[b];
  int64_t nb = (n + 3) / 4;
  if (off >= a.prehp_bytes) nb = 0;
  else if (off + nb > a.prehp_bytes) nb = a.prehp_bytes - off;
  if (static_cast<int64_t>(mid.size()) < 4 * nb) mid.resize(4 * nb);
  const uint8_t* src = a.prehp_flat + off;
  for (int64_t j = 0; j < nb; ++j) std::memcpy(mid.data() + 4 * j, &kDec4.v[src[j]], 4);
  return n < 4 * nb ? n : 4 * nb;
}

// Rows of lanes [r0, r1) from a.out + a.row_start[r0]; returns 0, or 2 for
// an event of a type the log has no name for.
int compose_range(const Args& a, int64_t r0, int64_t r1, int64_t* written, int64_t* logged) {
  std::vector<char> mid;
  std::vector<int64_t> eff, rpos;
  char* const p0 = a.out + a.row_start[r0];
  char* p = p0;
  int64_t n_logged = 0;
  for (int64_t i = r0; i < r1; ++i) {
    const int64_t b = a.lanes[i];
    const int64_t ne = a.n_events[b];
    if (ne <= 0) continue;
    const uint32_t* ev = a.ev_flat + a.ev_off[b];

    // read positions over the effective lengths, in event order
    if (static_cast<int64_t>(eff.size()) < ne) {
      eff.resize(ne);
      rpos.resize(ne);
    }
    int64_t del_before = 0, ins_before = 0;
    for (int64_t e = 0; e < ne; ++e) {
      const uint32_t w = ev[e];
      const int64_t px = w & 0x1FFFF;
      const int t = static_cast<int>(w >> 30);
      int64_t len = (w >> 17) & 0x1FFF;
      if (t == 1 && e + 1 < ne && (ev[e + 1] >> 30) == 1 && (ev[e + 1] & 0x1FFFF) == px)
        len = 0;  // overwritten by the next insertion at the same key
      const int64_t key = (px + 1) / 2;
      rpos[e] = (t == 1 ? key : px / 2) - del_before + ins_before;
      eff[e] = len;
      if (t == 2) del_before += len;
      else if (t == 1) ins_before += len;
    }

    const int64_t m = decode_middle(a, b, mid);
    const int64_t c = a.chrom[b];
    const int64_t goff = a.g_offsets[c];
    const int64_t glen = a.g_lengths[c];
    const bool circ = a.g_circular[c] != 0;
    const int64_t spos = a.pos[b];
    const char* name = a.names + a.name_off[i];
    const int64_t name_len = a.name_off[i + 1] - a.name_off[i];
    bool any = false;

    for (int64_t e = ne - 1; e >= 0; --e) {
      const int64_t len = eff[e];
      if (len == 0) continue;
      const uint32_t w = ev[e];
      const int t = static_cast<int>(w >> 30);
      if (t > 2) return 2;
      const int64_t key = ((w & 0x1FFFF) + 1) / 2;
      any = true;
      std::memcpy(p, name, name_len);
      p += name_len;
      *p++ = '\t';
      p = put_i64(p, key);
      *p++ = '\t';
      std::memcpy(p, kTypeNames[t], 3);
      p += 3;
      *p++ = '\t';
      p = put_i64(p, len);
      *p++ = '\t';
      if (t == 1) {
        std::memset(p, '-', len);
        p += len;
      } else {
        int64_t st = spos + key;
        if (circ && floor_mod(st, glen) + len > glen) {
          for (int64_t j = 0; j < len; ++j)
            *p++ = static_cast<char>(a.genome[goff + floor_mod(st + j, glen)]);
        } else {
          if (circ) st = floor_mod(st, glen);
          int64_t lo, hi;
          py_slice(goff + st, goff + st + len, a.genome_len, &lo, &hi);
          std::memcpy(p, a.genome + lo, hi - lo);
          p += hi - lo;
        }
      }
      *p++ = '\t';
      if (t == 2) {
        std::memset(p, '-', len);
        p += len;
      } else {
        int64_t lo, hi;
        py_slice(rpos[e], rpos[e] + len, m, &lo, &hi);
        std::memcpy(p, mid.data() + lo, hi - lo);
        p += hi - lo;
      }
      *p++ = '\n';
    }
    n_logged += any;
  }
  *written = p - p0;
  *logged = n_logged;
  return 0;
}

}  // namespace

extern "C" {

// Compose the log rows of the k lanes `lanes` (indices into the batch's
// per-lane arrays, in emission order; names[name_off[i]:name_off[i+1]] is
// row i's read name) into out.  Returns 0 with *written bytes and
// *lanes_logged (lanes that wrote a row); 1 when out_cap is below the
// rows' upper bound, which is then in *written and nothing is written;
// 2 for an event of an unknown type; 3 for a lane, chromosome or event
// range outside its array.
int64_t compose_prehp_log(
    int64_t k, const int64_t* lanes, int64_t n_lanes_batch,
    const char* names, const int64_t* name_off,
    const uint32_t* ev_flat, int64_t ev_words, const int64_t* ev_off, const int64_t* n_events,
    const uint8_t* prehp_flat, int64_t prehp_bytes, const int64_t* prehp_off,
    const int64_t* prehp_len,
    const int64_t* chrom, const int64_t* pos,
    const uint8_t* genome, int64_t genome_len, const int64_t* g_offsets,
    const int64_t* g_lengths, const uint8_t* g_circular, int64_t n_chrom,
    char* out, int64_t out_cap, int64_t* written, int64_t* lanes_logged,
    int32_t n_threads) {
  std::vector<int64_t> row_start(k + 1, 0);
  for (int64_t i = 0; i < k; ++i) {
    const int64_t b = lanes[i];
    if (b < 0 || b >= n_lanes_batch) return 3;
    int64_t bound = 0;
    const int64_t ne = n_events[b];
    if (ne > 0) {
      if (ev_off[b] < 0 || ev_off[b] + ne > ev_words) return 3;
      if (chrom[b] < 0 || chrom[b] >= n_chrom) return 3;
      if (g_circular[chrom[b]] && g_lengths[chrom[b]] <= 0) return 3;
      if (prehp_off[b] < 0) return 3;
      const uint32_t* ev = ev_flat + ev_off[b];
      int64_t lens = 0;
      for (int64_t e = 0; e < ne; ++e) lens += (ev[e] >> 17) & 0x1FFF;
      bound = ne * (name_off[i + 1] - name_off[i] + kRowFixed) + 2 * lens;
    }
    row_start[i + 1] = row_start[i] + bound;
  }
  *lanes_logged = 0;
  if (row_start[k] > out_cap) {
    *written = row_start[k];
    return 1;
  }

  const Args a{lanes, names, name_off, ev_flat, ev_off, n_events, prehp_flat, prehp_bytes,
               prehp_off, prehp_len, chrom, pos, genome, genome_len, g_offsets, g_lengths,
               g_circular, out, row_start.data()};
  int T = n_threads < 1 ? 1 : static_cast<int>(n_threads);
  if (T > k) T = static_cast<int>(k < 1 ? 1 : k);
  std::vector<int64_t> r0s(T + 1), ws(T, 0), ls(T, 0);
  std::vector<int> rcs(T, 0);
  for (int t = 0; t <= T; ++t) r0s[t] = k * t / T;
  if (T == 1) {
    rcs[0] = compose_range(a, 0, k, &ws[0], &ls[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(T);
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, t]() { rcs[t] = compose_range(a, r0s[t], r0s[t + 1], &ws[t], &ls[t]); });
    for (auto& th : threads) th.join();
  }
  for (int t = 0; t < T; ++t)
    if (rcs[t] != 0) return rcs[t];

  int64_t end = ws[0], logged = ls[0];
  for (int t = 1; t < T; ++t) {
    std::memmove(out + end, out + row_start[r0s[t]], ws[t]);
    end += ws[t];
    logged += ls[t];
  }
  *written = end;
  *lanes_logged = logged;
  return 0;
}

}  // extern "C"
